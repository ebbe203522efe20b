"""Headless scene viewer (matplotlib): BEV and projected-3D renders of
info and detection pickles, the camera panel, and a keyboard-driven
window. The renderers need matplotlib (the `viewer` extra); it loads with
them, not with this package or `viewer.app`, so that `SceneViewer`'s
device pieces (`voxel_coors`) run where matplotlib is absent. Nothing
else of the port imports this package."""

__all__ = ["BEVRenderer", "render_scene", "SceneViewer"]


def __getattr__(name: str):
    if name in ("BEVRenderer", "render_scene"):
        from det3d_tpu_torch.viewer import render

        return getattr(render, name)
    if name == "SceneViewer":
        from det3d_tpu_torch.viewer.app import SceneViewer

        return SceneViewer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""ctypes binding of the native async point-cloud loader.

The port's own copy of the JAX package's data/native_loader.py over the
shared `runtime/pointcloud_loader.cc`: disk reads, pad-to-max and an
optional shuffle run in C++ threads that overlap the consumer's device
work, and Python receives filled (max_points, C) numpy buffers in submit
order. The library is built on first use with the host's C++ compiler into
`det3d_tpu_torch/kernels/_build/` (git-ignored) by `kernels.build`, never
into `runtime/`. `available()` is False where it cannot be built; callers
then read with `numpy.fromfile` (a host reader, not a device path).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from det3d_tpu_torch.kernels import build


@functools.cache
def _load() -> ctypes.CDLL | None:
    try:
        lib = build.load("pointcloud_loader")
    except (RuntimeError, OSError):
        return None
    lib.pcl_create.restype = ctypes.c_void_p
    lib.pcl_create.argtypes = [ctypes.c_int] * 5 + [ctypes.c_uint64]
    lib.pcl_submit.restype = ctypes.c_int
    lib.pcl_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.pcl_next.restype = ctypes.c_int
    lib.pcl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)]
    lib.pcl_finish.argtypes = [ctypes.c_void_p]
    lib.pcl_destroy.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    return _load() is not None


class AsyncPointCloudLoader:
    """Submit .bin paths; receive padded (max_points, C) arrays in order.

        with AsyncPointCloudLoader(120_000, 4, num_threads=4) as ld:
            for p in paths: ld.submit(p)
            ld.finish()
            for _ in paths: pts, n = ld.next()
    """

    def __init__(self, max_points: int, num_features: int = 4, *, queue_depth: int = 8, num_threads: int = 4,
                 shuffle: bool = False, seed: int = 0):
        self._h = None
        lib = _load()
        if lib is None:
            raise RuntimeError("native loader unavailable (its library did not build)")
        self._lib = lib
        self.max_points = max_points
        self.num_features = num_features
        self._h = lib.pcl_create(max_points, num_features, queue_depth, num_threads, int(shuffle), seed)
        self._out = np.empty((max_points, num_features), np.float32)
        self._paths: list[str] = []
        self._consumed = 0

    def submit(self, path: str | Path) -> None:
        rc = self._lib.pcl_submit(self._h, str(path).encode())
        if rc != 0:
            raise RuntimeError(f"submit failed ({rc})")
        self._paths.append(str(path))

    def finish(self) -> None:
        self._lib.pcl_finish(self._h)

    def next(self, *, missing_ok: bool = False) -> tuple[np.ndarray, int] | None:
        """Blocking next frame; None when drained after finish().

        Raises FileNotFoundError for an unreadable file (as the numpy reader
        does) unless `missing_ok`, which returns an all-zero frame, n=0."""
        n = ctypes.c_int(0)
        rc = self._lib.pcl_next(self._h, self._out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctypes.byref(n))
        if rc == -1:
            return None
        path = self._paths[self._consumed] if self._consumed < len(self._paths) else "?"
        self._consumed += 1
        if rc == 1 and not missing_ok:
            raise FileNotFoundError(f"native loader could not read {path}")
        if rc not in (0, 1):
            raise RuntimeError(f"next failed ({rc})")
        return self._out.copy(), int(n.value)

    def close(self) -> None:
        if self._h:
            self._lib.pcl_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()

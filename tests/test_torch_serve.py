"""The port's serving loop on the CPU (the JAX package's pattern:
tests/test_apps.py:183-270): the bounded queue's drop-stale policy, the
consumer serving N frames with the live detector's annos, the replay of a
`.bin` directory (once and in loop mode), a missing directory, a producer
failure re-raised after the drain, and the submitted/dropped counts.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import test_torch_parity_utils as pu
from det3d_tpu_torch.apps import serve_app
from det3d_tpu_torch.apps.serve_app import PointCloudServer, ServeStats
from det3d_tpu_torch.data import native_loader
from det3d_tpu_torch.pipeline import Detector
from test_torch_tmpdirs import tmp_path  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cfg():
    return pu.to_torch_cfg(pu.small_cfg())


@pytest.fixture(scope="module")
def det(cfg):
    return Detector(cfg, device="cpu").init_weights(0)


def cloud(rng, k: int) -> np.ndarray:
    return np.concatenate([rng.uniform(-7, 7, (k, 2)), rng.uniform(-2, 6, (k, 1)),
                           rng.uniform(0, 1, (k, 1))], 1).astype(np.float32)


def test_server_needs_a_detector(cfg):
    with pytest.raises(ValueError, match="needs a detector"):
        PointCloudServer(cfg)


def test_queue_drops_stale_frames(cfg, det):
    server = PointCloudServer(cfg, detector=det, queue_size=2)
    p = np.zeros((10, 4), np.float32)
    assert server.submit(p, stamp=1.0)
    assert server.submit(p, stamp=2.0)
    assert server.submit(p, stamp=3.0)  # displaces stamp 1.0
    stamps = []
    while not server.queue.empty():
        stamps.append(server.queue.get_nowait()[1])
    assert stamps == [2.0, 3.0]
    assert (server.submitted, server.dropped) == (3, 1)


def test_spin_serves_frames_with_the_detectors_annos(cfg, det):
    server = PointCloudServer(cfg, detector=det, queue_size=4)
    rng = np.random.RandomState(0)
    clouds = [cloud(rng, k) for k in (500, 300, 0)]
    for c in clouds:
        server.submit(c)
    results = []
    server.spin(max_frames=3, on_result=lambda a, lat: results.append(a))
    assert len(results) == len(server.latencies) == 3
    assert all(lat > 0 for lat in server.latencies)
    for c, got in zip(clouds, results):
        want = det.detect(c)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_spin_drains_the_queue_after_stop(cfg, det):
    server = PointCloudServer(cfg, detector=det, queue_size=2)
    server.submit(np.zeros((5, 4), np.float32))
    server.stop()
    server.spin()
    assert len(server.latencies) == 1


def test_infer_fn_takes_the_place_of_the_detector(cfg, det):
    calls = []

    def infer_fn(points, n):
        calls.append((points.shape, int(n)))
        return det.infer(torch.from_numpy(points), int(n))

    server = PointCloudServer(cfg, infer_fn=infer_fn)
    server.warmup()
    server.submit(np.ones((7, 4), np.float32))
    server.spin(max_frames=1)
    assert calls == [((cfg.max_points, 4), 0), ((cfg.max_points, 4), 7)]


def _write_bins(path, n: int) -> None:
    rng = np.random.RandomState(0)
    for i in range(n):
        cloud(rng, 400).tofile(path / f"{i:06d}.bin")


def test_replay_serves_a_bin_directory_once_and_in_loop(cfg, det, tmp_path):
    _write_bins(tmp_path, 3)
    # paced slower than the consumer, so the queue never displaces a frame
    stats = serve_app.serve_replay(cfg, str(tmp_path), hz=10.0, server=PointCloudServer(cfg, detector=det))
    assert isinstance(stats, ServeStats) and len(stats) == 3 and all(lat > 0 for lat in stats)
    assert (stats.submitted, stats.dropped) == (3, 0)
    stats = serve_app.serve_replay(cfg, str(tmp_path), hz=10.0, frames=5, loop=True,
                                   server=PointCloudServer(cfg, detector=det))
    assert len(stats) == 5 and stats.submitted == 5


def test_replay_numpy_reader(cfg, det, tmp_path, monkeypatch):
    monkeypatch.setattr(native_loader, "available", lambda: False)
    _write_bins(tmp_path, 2)
    stats = serve_app.serve_replay(cfg, str(tmp_path), hz=10.0, server=PointCloudServer(cfg, detector=det))
    assert len(stats) == 2


def test_replay_missing_dir_raises(cfg, tmp_path):
    with pytest.raises(FileNotFoundError):
        serve_app.serve_replay(cfg, str(tmp_path / "nope"), hz=100.0, device="cpu")


def test_producer_failure_reraises_after_the_drain(cfg, det, tmp_path, monkeypatch):
    """A .bin whose size is not a multiple of the point stride fails in the
    producer thread; the caller sees the error once the frames already
    queued are served, and spin() does not wait forever."""
    monkeypatch.setattr(native_loader, "available", lambda: False)
    _write_bins(tmp_path, 1)
    (tmp_path / "000001.bin").write_bytes(b"\x00" * 13)
    server = PointCloudServer(cfg, detector=det)
    with pytest.raises(ValueError):
        serve_app.serve_replay(cfg, str(tmp_path), hz=100.0, server=server)
    assert len(server.latencies) == 1


def test_serve_synthetic_counts_frames(cfg, det):
    stats = serve_app.serve_synthetic(cfg, frames=4, hz=20.0, server=PointCloudServer(cfg, detector=det))
    assert stats.submitted == 4 and len(stats) + stats.dropped == 4


def test_make_server_of_an_artifact(cfg, tmp_path):
    from det3d_tpu_torch.deploy.export import export_detector

    export_detector(cfg, out_dir=tmp_path / "art", device="cpu")
    server = serve_app.make_server(cfg, exported=str(tmp_path / "art"), device="cpu")
    assert server.detector is None
    stats = serve_app.serve_synthetic(cfg, frames=2, hz=20.0, server=server)
    assert stats.submitted == 2 and len(stats) + stats.dropped == 2

"""Streaming serving loop: the reference's ROS node, on one device.

Counterpart of the JAX package's apps/serve_app.py (reference
ros_node.py:30-89): a producer thread feeds point clouds into a bounded
queue (2 deep, as the reference's `queue.Queue(maxsize=2)`), displacing
the stale frame when it is full; a consumer loop runs the detector and
records each frame's latency from its arrival to its annos on the host.
`PointCloudServer` is transport-agnostic: `serve_synthetic` drives it from
synthetic scenes at a fixed rate, `serve_replay` from a directory of `.bin`
frames, and a ROS subscriber would call `server.submit(points)`
(`make_ros_node`, where `rospy` is installed).

The detector is the live `Detector` (its `infer_jit`, by default, one
CUDA-graph replay a frame on the card, as the JAX app's `infer_jit`) or an
exported artifact (`infer_fn=ExportedDetector(...).infer`, likewise).

`spatial` (a spatial group, `serve --spatial`): each frame's network is
split along x over the group's ranks (`parallel/mesh.make_spatial_infer`).
Rank 0 runs the producer, the queue and the latency record; for each frame
it serves it broadcasts a header (go, point count) and the padded points,
and the other ranks (`follow`) run the same frame with it until a header
says stop, which rank 0 sends however its serving ends. Every rank runs
the frame through the detector's `infer_fn`, its captured graph with the
frame's collectives inside, so every rank replays the same collectives;
the header and the points are eager broadcasts outside the graph.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from det3d_tpu_torch.config import Config
from det3d_tpu_torch.postprocess import to_annos
from det3d_tpu_torch.utils.npmath import pad_cloud


class ServeStats(list):
    """Latency list (seconds) with the queue's submitted/dropped counts:
    the drop-free rate needs the drops, not only the latencies."""

    submitted: int = 0
    dropped: int = 0


class PointCloudServer:
    """Bounded-queue streaming inference (reference ros_node.py:52-83).
    `infer_fn(padded points (max_points, C) numpy, n)` → Detections; by
    default the live `detector`'s `infer_fn` (its `infer_jit`) on its device."""

    def __init__(self, cfg: Config, *, detector=None, queue_size: int = 2, infer_fn=None):
        if detector is None and infer_fn is None:
            raise ValueError("PointCloudServer needs a detector or an infer_fn")
        self.cfg = cfg
        self.detector = detector
        self._infer_fn = infer_fn
        self.queue: queue.Queue = queue.Queue(maxsize=queue_size)
        self.latencies: list[float] = []
        self.submitted = 0   # frames the sensor produced
        self.dropped = 0     # frames displaced from the full queue (stale)
        self._stop = threading.Event()

    def submit(self, points: np.ndarray, stamp: float | None = None) -> bool:
        """Producer side: enqueue a frame, dropping the oldest when full
        (the reference drops the new frame, ros_node.py:44-50; dropping the
        stale one is better for a real-time consumer)."""
        item = (points, stamp if stamp is not None else time.perf_counter())
        self.submitted += 1
        try:
            self.queue.put_nowait(item)
            return True
        except queue.Full:
            try:
                self.queue.get_nowait()
                self.dropped += 1
            except queue.Empty:
                pass
            try:
                self.queue.put_nowait(item)
                return True
            except queue.Full:
                self.dropped += 1
                return False

    def stop(self) -> None:
        self._stop.set()

    @property
    def infer_fn(self):
        return self._infer_fn if self._infer_fn is not None else self._live_infer

    def _live_infer(self, points: np.ndarray, num_points):
        return self.detector.infer_fn(points, num_points)

    def warmup(self) -> None:
        """One empty frame through the detector (the kernels' build; the
        live detector's capture of its graph)."""
        pts = np.zeros((self.cfg.max_points, self.cfg.num_point_features), np.float32)
        to_annos(self.cfg, self.infer_fn(pts, np.int32(0)))

    def spin(self, max_frames: int | None = None, on_result=None) -> None:
        """Consumer loop (reference ros_node.py:61-83). After stop() the
        loop drains the frames already queued (at most queue_size) before
        it exits: the sensor stopping must not discard what it produced."""
        served = 0
        while True:
            if max_frames is not None and served >= max_frames:
                break
            try:
                points, stamp = self.queue.get(timeout=0.5)
            except queue.Empty:
                if self._stop.is_set():
                    break
                continue
            padded, n = pad_cloud(points, self.cfg.max_points)
            annos = to_annos(self.cfg, self.infer_fn(padded, n))
            latency = time.perf_counter() - stamp
            self.latencies.append(latency)
            served += 1
            if on_result is not None:
                on_result(annos, latency)
            if served % 20 == 0:
                avg = float(np.mean(self.latencies[-100:])) * 1e3
                print(f"served {served} frames, avg latency {avg:.1f} ms ({len(annos['name'])} dets)")


class SpatialLead:
    """Rank 0's `infer_fn` under a spatial group: the frame's header and
    points broadcast to the group, then the split network on it."""

    def __init__(self, detector, mesh):
        self.detector, self.mesh = detector, mesh

    def __call__(self, points: np.ndarray, num_points):
        dev = self.detector.device
        self.mesh.broadcast_(torch.tensor([1, int(num_points)], dtype=torch.int64, device=dev))
        pts = self.mesh.broadcast_(torch.from_numpy(points).to(dev))
        return self.detector.infer_fn(pts, int(num_points))

    def stop(self) -> None:
        self.mesh.broadcast_(torch.zeros(2, dtype=torch.int64, device=self.detector.device))


def follow(detector, mesh) -> int:
    """A rank > 0 of a spatial server: run every frame rank 0 broadcasts
    until its stop header → the frames run."""
    cfg, dev = detector.cfg, detector.device
    served = 0
    while True:
        header = mesh.broadcast_(torch.zeros(2, dtype=torch.int64, device=dev)).tolist()
        if not header[0]:
            return served
        pts = mesh.broadcast_(torch.empty((cfg.max_points, cfg.num_point_features), dtype=torch.float32, device=dev))
        detector.infer_fn(pts, header[1])
        served += 1


def make_server(cfg: Config, *, checkpoint: str | None = None, exported: str | None = None,
                device=None, spatial=None) -> PointCloudServer:
    """The server of the live detector (weights from `checkpoint`, or
    `init_weights(0)`) or, with `exported`, of an artifact's runtime; with a
    `spatial` group, of the split detector, whose `infer_fn` on rank 0 is a
    `SpatialLead` (every rank makes its server; ranks > 0 `follow`)."""
    if exported:
        if spatial is not None:
            raise ValueError("--spatial serves the live detector: no exported artifact with it")
        from det3d_tpu_torch.deploy.runtime import ExportedDetector

        runner = ExportedDetector(exported, device)
        return PointCloudServer(runner.cfg, infer_fn=runner.infer)
    from det3d_tpu_torch.pipeline import Detector

    if spatial is not None:
        device = spatial.device
    det = Detector(cfg, device, spatial=spatial)
    if checkpoint:
        from det3d_tpu_torch.train.checkpoint import load_latest_state

        load_latest_state(cfg, checkpoint, det)
    else:
        det.init_weights(0)
    lead = None if spatial is None or spatial.rank else SpatialLead(det, spatial)
    return PointCloudServer(cfg, detector=det, infer_fn=lead)


def _serve(server: PointCloudServer, run) -> ServeStats:
    """`run()` (the producer, the queue and the consumer) on a plain server
    or on rank 0 of a spatial one, its followers stopped however `run`
    ends; on a follower, `follow` until rank 0 stops it → an empty record."""
    det = server.detector
    spatial = None if det is None or det.spatial is None else det.spatial.mesh
    if spatial is None:
        return run()
    if spatial.rank:
        follow(det, spatial)
        return ServeStats()
    try:
        return run()
    finally:
        server.infer_fn.stop()


def _run_server(server: PointCloudServer, producer_body) -> ServeStats:
    """Warm up, run `producer_body(server)` in a daemon thread (server.stop()
    on any exit, or spin() would wait forever; a producer exception
    re-raises here after the drained frames are served), consume, print the
    latency percentiles."""
    server.warmup()
    failure: list[BaseException] = []

    def producer():
        try:
            producer_body(server)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            failure.append(e)
        finally:
            server.stop()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    server.spin()
    t.join()
    if failure:
        raise failure[0]
    lat = np.asarray(server.latencies) * 1e3
    if len(lat):
        print(f"latency over {len(lat)} frames: p50 {np.percentile(lat, 50):.1f} ms  "
              f"p95 {np.percentile(lat, 95):.1f} ms  max {lat.max():.1f} ms")
    print(f"frames: submitted {server.submitted}, served {len(server.latencies)}, "
          f"dropped {server.dropped} (queue displaces stale frames when full)")
    out = ServeStats(server.latencies)
    out.submitted, out.dropped = server.submitted, server.dropped
    return out


def serve_synthetic(cfg: Config, *, checkpoint: str | None = None, exported: str | None = None,
                    frames: int = 100, hz: float = 10.0, device=None,
                    server: PointCloudServer | None = None, spatial=None) -> ServeStats:
    """Drive the server from a synthetic sensor at `hz` frames/sec; a
    caller's `server` in place of one `make_server` builds; `spatial`: a
    spatial group (see the module docstring)."""
    from det3d_tpu_torch.data.synthetic import sample_scene

    server = server or make_server(cfg, checkpoint=checkpoint, exported=exported, device=device, spatial=spatial)
    rng = np.random.RandomState(0)

    def producer_body(server):
        period = 1.0 / hz
        for _ in range(frames):
            if server._stop.is_set():
                return
            server.submit(sample_scene(cfg, rng)["points"])
            time.sleep(period)

    return _serve(server, lambda: _run_server(server, producer_body))


def serve_replay(cfg: Config, replay_dir: str, *, checkpoint: str | None = None, exported: str | None = None,
                 hz: float = 10.0, frames: int | None = None, loop: bool = False, device=None,
                 server: PointCloudServer | None = None, spatial=None) -> ServeStats:
    """Replay a directory of raw `.bin` point-cloud files through the server
    at a fixed rate: the recorded drive as the sensor (reference
    ros_node.py:61-83). The disk reads run in the native loader's threads
    ahead of the producer's clock, so `hz` paces serving, not the disk;
    `numpy.fromfile` reads where the loader is unavailable. `loop=True`
    cycles the directory until `frames` have been submitted. `spatial`: a
    spatial group; rank 0 alone reads the directory."""
    server = server or make_server(cfg, checkpoint=checkpoint, exported=exported, device=device, spatial=spatial)
    return _serve(server, lambda: _replay(cfg, server, replay_dir, hz, frames, loop))


def _replay(cfg: Config, server: PointCloudServer, replay_dir: str, hz: float, frames: int | None,
            loop: bool) -> ServeStats:
    """`serve_replay`'s producer over the directory's frames, and the server."""
    from pathlib import Path

    from det3d_tpu_torch.data import native_loader

    paths = sorted(Path(replay_dir).glob("*.bin"))
    if not paths:
        raise FileNotFoundError(f"no .bin files under {replay_dir}")
    if frames is not None and not loop:
        paths = paths[:frames]
    total = frames if (frames is not None and loop) else len(paths)
    use_native = native_loader.available()
    print(f"replaying {total} frames from {replay_dir} at {hz} Hz "
          f"({'native loader' if use_native else 'numpy reader'})")

    def frame_paths():
        for i in range(total):
            yield paths[i % len(paths)]

    def producer_body(server):
        period = 1.0 / hz
        if not use_native:
            for p in frame_paths():
                if server._stop.is_set():
                    return
                server.submit(np.fromfile(p, np.float32).reshape(-1, cfg.num_point_features))
                time.sleep(period)
            return
        with native_loader.AsyncPointCloudLoader(cfg.max_points, cfg.num_point_features, num_threads=4) as ld:
            it = frame_paths()
            pending = 0
            for _ in range(min(4, total)):  # keep the loader a few frames ahead of the clock
                ld.submit(next(it))
                pending += 1
            submitted = pending
            while pending and not server._stop.is_set():
                got = ld.next(missing_ok=True)
                if got is None:
                    break
                pts, n = got
                pending -= 1
                if submitted < total:
                    ld.submit(next(it))
                    pending += 1
                    submitted += 1
                # the loader pads to max_points; the server pads again, so it
                # gets only the valid rows, as from a ROS message
                server.submit(pts[:n])
                time.sleep(period)

    return _run_server(server, producer_body)


def make_ros_node(server: PointCloudServer, topic: str = "/combined_lidar") -> PointCloudServer:
    """ROS binding (where `rospy` is installed; reference ros_node.py:30-59):
    each PointCloud2 message on `topic` is submitted to `server`."""
    import rospy  # noqa: F401  (not installed here)
    import sensor_msgs.point_cloud2 as pc2
    from sensor_msgs.msg import PointCloud2

    def callback(msg):
        pts = np.array(list(pc2.read_points(msg, field_names=("x", "y", "z", "intensity"))), np.float32)
        server.submit(pts)

    rospy.init_node("det3d_tpu_torch")
    rospy.Subscriber(topic, PointCloud2, callback, queue_size=1)
    return server

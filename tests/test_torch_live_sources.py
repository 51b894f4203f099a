"""The port's live driver (orb_slam2_commit_tpu_torch/examples/run_live.py)
against the JAX package's (examples/run_live.py, loaded with importlib as
tests/test_live_sources.py loads it).

The wire: uint8, float32 and two-plane records round-trip exactly; a bad
magic raises; each package's publisher writes the same bytes for the same
frames, and each package's subscriber reads the other's stream to the
same arrays. The directory watch reads PNG files written by the port's
own writer (no OpenCV needed). The capture source raises an error naming
cv2 when OpenCV is missing; with OpenCV, on tests/test_live_sources.py's
TestOpenCVCaptureSource clip (MJPG, cut to 5 frames), it reads the same
frames and timestamps as the JAX package's source, and a capture that
does not open raises RuntimeError. The drop policy against a fake System: a slow
tracker drops stale frames and never reorders, a fast one drops nothing,
two-plane frames go to track_stereo / track_rgbd by sensor, and under one
simulated clock both packages drop exactly the same frames. A real
synchronous System on the CPU fed over TCP equals the direct feed bit for
bit (trajectory, keyframes, map, and the depth arrays the fused RGB-D
stage sees). Nothing launches a kernel on the CPU.
"""

import importlib.util
import os
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu_torch.examples import run_live as prl
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.utils import png

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jrl():
    spec = importlib.util.spec_from_file_location(
        "jax_run_live", os.path.join(REPO, "examples", "run_live.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _frames(kind, n=5, h=48, w=64):
    rng = np.random.default_rng(7)
    out = []
    for i in range(n):
        u8 = rng.integers(0, 256, (h, w), dtype=np.uint8)
        f32 = rng.random((h, w), dtype=np.float32)
        out.append({"uint8": (0.1 * i, u8), "float32": (0.1 * i, f32),
                    "pair": (0.1 * i, u8, f32)}[kind])
    return out


def _stream(publish, sent):
    """Everything a publisher writes for `sent`, as bytes."""
    a, b = socket.socketpair()
    out = bytearray()

    def drain():
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return
            out.extend(chunk)

    t = threading.Thread(target=drain)
    t.start()
    publish(a, sent)
    a.close()
    t.join(timeout=10)
    b.close()
    return bytes(out)


def _through(publish, source_cls, sent):
    a, b = socket.socketpair()
    pub = threading.Thread(target=lambda: (publish(a, sent), a.close()))
    pub.start()
    got = list(source_cls(sock=b).frames())
    pub.join(timeout=10)
    return got


def _same(sent, got):
    assert len(got) == len(sent)
    for s, g in zip(sent, got):
        assert len(s) == len(g) and g[0] == s[0]
        for a, b in zip(s[1:], g[1:]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["uint8", "float32", "pair"])
def test_wire_round_trip(kind):
    sent = _frames(kind)
    _same(sent, _through(prl.publish_frames, prl.SocketSource, sent))


@pytest.mark.parametrize("kind", ["uint8", "float32", "pair"])
def test_wire_bytes_equal_across_packages(jrl, kind):
    sent = _frames(kind)
    ours = _stream(prl.publish_frames, sent)
    assert ours == _stream(jrl.publish_frames, sent)
    assert ours[:4] == b"OSF1"
    # The JAX publisher feeds the port's subscriber, and the reverse.
    _same(sent, _through(jrl.publish_frames, prl.SocketSource, sent))
    _same(sent, _through(prl.publish_frames, jrl.SocketSource, sent))


def test_tcp_listen_and_connect():
    sent = _frames("pair", 4)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    got = []
    sub = threading.Thread(target=lambda: got.extend(
        prl.SocketSource(port=port, listen=True, timeout_s=10).frames()))
    sub.start()
    deadline = time.time() + 10
    while True:
        try:
            out = socket.create_connection(("127.0.0.1", port), timeout=10)
            break
        except ConnectionRefusedError:
            assert time.time() < deadline
            time.sleep(0.01)
    prl.publish_frames(out, sent)
    out.close()
    sub.join(timeout=10)
    _same(sent, got)
    # And connecting out to a listening publisher.
    server = socket.create_server(("127.0.0.1", 0))
    port = server.getsockname()[1]

    def serve():
        conn, _ = server.accept()
        prl.publish_frames(conn, sent)
        conn.close()

    pub = threading.Thread(target=serve)
    pub.start()
    got = list(prl.SocketSource(port=port, listen=False, timeout_s=10).frames())
    pub.join(timeout=10)
    server.close()
    _same(sent, got)


@pytest.mark.parametrize("source", ["port", "jax"])
def test_bad_magic_raises(jrl, source):
    cls = prl.SocketSource if source == "port" else jrl.SocketSource
    a, b = socket.socketpair()
    a.sendall(b"XXXX" + b"\x00" * (prl._FRAME_HDR.size - 4))
    a.close()
    with pytest.raises(ValueError, match="bad frame header"):
        list(cls(sock=b).frames())


def test_directory_watch_reads_written_pngs(tmp_path):
    rng = np.random.default_rng(5)
    ims = [rng.integers(0, 256, (32, 40), dtype=np.uint8) for _ in range(3)]
    for i, im in enumerate(ims):
        png.write_png(str(tmp_path / f"f{i:03d}.png"), im)
    rgb = rng.integers(0, 256, (32, 40, 3), dtype=np.uint8)
    png.write_png(str(tmp_path / "f003.png"), rgb)
    (tmp_path / "notes.txt").write_text("not an image")
    got = list(prl.DirectoryWatchSource(str(tmp_path), idle_timeout_s=0.2).frames())
    assert len(got) == 4
    for (_, im), ref in zip(got, ims):
        assert im.dtype == np.uint8
        np.testing.assert_array_equal(im, ref)
    gray = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    np.testing.assert_array_equal(got[3][1], np.clip(np.round(gray), 0, 255).astype(np.uint8))


class TestOpenCVCaptureSource:
    def test_video_file_equals_jax(self, jrl, tmp_path):
        cv2 = pytest.importorskip("cv2")
        path = str(tmp_path / "clip.avi")
        h, w, n = 64, 80, 5
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 20.0, (w, h))
        assert writer.isOpened()
        rng = np.random.default_rng(11)
        # Smooth gradient frames: MJPG is lossy, so the written frames are
        # held by their means.
        frames = []
        for i in range(n):
            gray = np.clip(np.linspace(0, 200, w)[None, :] + 5 * i + rng.normal(0, 2, (h, w)),
                           0, 255).astype(np.uint8)
            frames.append(gray)
            writer.write(cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR))
        writer.release()

        got = list(prl.OpenCVCaptureSource(path, realtime=False).frames())
        want = list(jrl.OpenCVCaptureSource(path, realtime=False).frames())
        assert len(got) == len(want) == n
        for (ts, im), (jts, jim), ref in zip(got, want, frames):
            assert im.shape == (h, w) and im.dtype == np.uint8
            assert ts == jts
            np.testing.assert_array_equal(im, jim)
            assert abs(float(im.mean()) - float(ref.mean())) < 3.0
        assert got[1][0] == pytest.approx(1 / 20.0, abs=1e-6)

    def test_missing_capture_raises(self, jrl, tmp_path):
        pytest.importorskip("cv2")
        for source in (prl, jrl):
            with pytest.raises(RuntimeError):
                list(source.OpenCVCaptureSource(str(tmp_path / "none.avi")).frames())


def test_capture_without_opencv_names_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ModuleNotFoundError, match="cv2") as e:
        next(prl.OpenCVCaptureSource("clip.avi").frames())
    assert e.value.name == "cv2"


class _Clock:
    """A simulated clock: time() advances only when the fake tracker
    works, so the drop decisions are the same on every run."""

    def __init__(self):
        self.now = 1000.0

    def time(self):
        return self.now

    perf_counter = time

    def sleep(self, s):
        self.now += s


class _FakeSystem:
    """Records the calls; each one costs track_delay seconds."""

    track_delay = 0.0
    clock = None
    instance = None

    def __init__(self, config, vocabulary=None, device="cuda"):
        self.tracked, self.calls = [], []
        self.tracker = type("T", (), {"last_frame": None})()
        type(self).instance = self

    def _rec(self, kind, ts):
        self.calls.append(kind)
        self.tracked.append(ts)
        if self.track_delay:
            (self.clock or time).sleep(self.track_delay)
        return np.eye(3), np.zeros(3)

    def track_monocular(self, image, ts):
        return self._rec("mono", ts)

    def track_stereo(self, left, right, ts):
        assert right is not None
        return self._rec("stereo", ts)

    def track_rgbd(self, image, depth, ts):
        assert depth is not None
        return self._rec("rgbd", ts)

    def tracking_state(self):
        return type("S", (), {"name": "OK"})()

    def shutdown(self):
        pass


class _Sensor:
    def __init__(self, sensor):
        self.sensor = sensor


class _ListSource:
    def __init__(self, items):
        self.items = items

    def frames(self):
        yield from self.items


def _fake(monkeypatch, delay=0.0, clock=None):
    cls = type("Fake", (_FakeSystem,), {"track_delay": delay, "clock": clock})
    monkeypatch.setattr("orb_slam2_commit_tpu_torch.slam.system.System", cls)
    monkeypatch.setattr("orb_slam2_commit_tpu.slam.system.System", cls)
    return cls


def test_slow_tracker_drops_stale_frames(monkeypatch):
    cls = _fake(monkeypatch, delay=0.06)
    fps = 50.0
    items = [(i / fps, np.zeros((16, 16), np.uint8)) for i in range(20)]
    run = prl.run_live(_ListSource(items), config=None, vocab=None, fps=fps, device="cpu")
    assert 0 < len(cls.instance.tracked) < 20
    assert run.n_dropped == 20 - len(cls.instance.tracked) and run.n_in == 20
    assert run.fed_ts == cls.instance.tracked
    assert all(b > a for a, b in zip(run.fed_ts, run.fed_ts[1:]))
    assert cls.instance.tracked[:2] == [0.0, 1 / fps]   # the first two never drop


def test_fast_tracker_drops_nothing(monkeypatch):
    cls = _fake(monkeypatch)
    items = [(i / 30.0, np.zeros((16, 16), np.uint8)) for i in range(8)]
    run = prl.run_live(_ListSource(items), config=None, vocab=None, fps=30.0, device="cpu")
    assert cls.instance.calls == ["mono"] * 8
    assert (run.n_in, run.n_tracked, run.n_dropped) == (8, 8, 0)


@pytest.mark.parametrize("sensor", ["stereo", "rgbd"])
def test_sensor_dispatch(monkeypatch, sensor):
    cls = _fake(monkeypatch)
    items = [(i / 30.0, np.zeros((16, 16), np.uint8), np.ones((16, 16), np.float32))
             for i in range(4)]
    prl.run_live(_ListSource(items), config=_Sensor(sensor), vocab=None, device="cpu")
    assert cls.instance.calls == [sensor] * 4


@pytest.mark.parametrize("delay, fps", [(0.06, 50.0), (0.05, 30.0), (0.15, 10.0)])
def test_drop_decisions_equal_jax(jrl, monkeypatch, delay, fps):
    """Both packages' run_live under one simulated clock feed the same
    frames to the System."""
    items = [(i / fps, np.zeros((16, 16), np.uint8)) for i in range(30)]
    fed = {}
    for name, mod in (("port", prl), ("jax", jrl)):
        clock = _Clock()
        monkeypatch.setattr(mod, "time", clock)
        cls = _fake(monkeypatch, delay=delay, clock=clock)
        kw = {"device": "cpu"} if name == "port" else {}
        mod.run_live(_ListSource(items), config=None, vocab=None, fps=fps, **kw)
        fed[name] = cls.instance.tracked
    assert fed["port"] == fed["jax"]
    assert 2 < len(fed["port"]) < 30


def test_system_over_the_wire_equals_direct(monkeypatch):
    """A synchronous RGB-D System on the CPU (the card's fused route)
    fed over loopback TCP by run_live, against the same frames fed
    directly: the same trajectory, keyframes and map bit for bit, and the
    fused RGB-D stage sees the same image and depth arrays."""
    from orb_slam2_commit_tpu_torch.slam.system import System
    from orb_slam2_commit_tpu_torch.slam.tracking import Tracker
    from orb_slam2_commit_tpu_torch.utils import synthetic
    from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

    monkeypatch.setenv("ORB_TPU_FUSED_TRACK", "1")
    cfg = synthetic_config(320, 240, 600, sensor="rgbd")
    images, poses, _, depths = synthetic.render_sequence(
        cfg.camera, n_frames=6, n_points=500, seed=5, step=0.05, with_depth=True)
    items = [(i / cfg.camera.fps, images[i], depths[i]) for i in range(6)]

    seen = {}
    fused = Tracker.fused_motion_frame

    def spy(self, image, frame_id, timestamp, **kw):
        seen[key].append((np.array(image), np.array(kw["depth_image"]), timestamp))
        return fused(self, image, frame_id, timestamp, **kw)

    monkeypatch.setattr(Tracker, "fused_motion_frame", spy)
    before = dict(_build.launches)
    key = "direct"
    seen[key] = []
    direct = System(cfg, vocabulary=None, device="cpu")
    for ts, im, d in items:
        direct.track_rgbd(im, d, ts)
    key = "wire"
    seen[key] = []
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    def publish():
        deadline = time.time() + 30
        while True:
            try:
                sock = socket.create_connection(("127.0.0.1", port), timeout=10)
                break
            except ConnectionRefusedError:
                assert time.time() < deadline
                time.sleep(0.01)
        with sock:
            prl.publish_frames(sock, items)

    pub = threading.Thread(target=publish)
    pub.start()
    run = prl.run_live(prl.SocketSource(port=port, listen=True, timeout_s=30), cfg,
                       vocab=None, drop_when_behind=False, device="cpu")
    pub.join(timeout=30)
    assert _build.launches == before
    assert (run.n_in, run.n_tracked, run.n_dropped) == (6, 6, 0)
    assert len(seen["wire"]) == len(seen["direct"]) >= 3
    for (a, da, ta), (b, db, tb) in zip(seen["wire"], seen["direct"]):
        assert ta == tb and a.dtype == b.dtype and da.dtype == db.dtype
        assert a.tobytes() == b.tobytes() and da.tobytes() == db.tobytes()
    w, d = run.system, direct
    assert w.map.next_kf == d.map.next_kf >= 2
    for e, f in zip(w.tracker.trajectory, d.tracker.trajectory):
        assert e.ref_kf == f.ref_kf and e.lost == f.lost
        assert e.R_rel.tobytes() == f.R_rel.tobytes() and e.t_rel.tobytes() == f.t_rel.tobytes()
    for name in ("kf_pose_R", "kf_pose_t", "kf_frame_id", "pt_pos", "pt_valid", "kf_point_idx"):
        assert getattr(w.map, name).tobytes() == getattr(d.map, name).tobytes(), name

"""Live-stream driver: the port's counterpart of examples/run_live.py, the
reference's ROS-node layer without ROS.

The reference shipped ROS nodes (Mono / Stereo / RGBD) that subscribe to
image topics and feed System::Track* per message (reference:
README.md:190-248). This driver gives the same capability: a FrameSource
that any transport (a camera, a socket, a directory) implements, pumped
into the System online with a queue-depth-1 drop policy. The wire format
is byte for byte the JAX driver's, so a publisher of either package feeds
a subscriber of the other.

Usage (on the CUDA card; add --device=cpu for the CPU):
  # Simulated live source (the synthetic renderer, paced at 30 fps):
  python -m orb_slam2_commit_tpu_torch.examples.run_live --sim --frames 30

  # Directory watch: consume image files as they appear:
  python -m orb_slam2_commit_tpu_torch.examples.run_live --watch <dir> --settings <yaml>

  # Network stream: subscribe to a frame socket (publish_frames is the
  # publisher):
  python -m orb_slam2_commit_tpu_torch.examples.run_live --listen 7007 --settings <yaml>
  python -m orb_slam2_commit_tpu_torch.examples.run_live --connect host:7007 --settings <yaml>

  # Camera or video file (needs OpenCV, the cv2 module):
  python -m orb_slam2_commit_tpu_torch.examples.run_live --camera 0 --settings <yaml>
  python -m orb_slam2_commit_tpu_torch.examples.run_live --video clip.avi --settings <yaml>

Flags: --sensor monocular|stereo|rgbd (with --settings), --viewer (the
render thread), --viewer-dir <dir> (stream its frames there as PNGs),
--device=cpu.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import socket
import struct
import sys
import time
from typing import List, Optional

import numpy as np


class FrameSource:
    """Interface: iterate (timestamp, image [H, W][, aux [H, W]]) tuples.

    Images may be uint8 or float32: the extraction casts on the device, and
    uint8 keeps the upload (and the wire) 4x smaller."""

    def frames(self):
        raise NotImplementedError


class SyntheticSource(FrameSource):
    """The synthetic ground-truth sequence, paced at a fixed fps."""

    def __init__(self, config, n_frames=30, fps=30.0):
        from orb_slam2_commit_tpu_torch.utils import synthetic

        self.images, self.poses, self.scene = synthetic.render_sequence(
            config.camera, n_frames=n_frames, n_points=400, seed=3, step=0.05)
        self.fps = fps

    def frames(self):
        t0 = time.time()
        for i, im in enumerate(self.images):
            target = t0 + i / self.fps
            now = time.time()
            if target > now:
                time.sleep(target - now)
            yield time.time() - t0, np.asarray(im, np.float32)


class DirectoryWatchSource(FrameSource):
    """Image files appearing in a directory, in name order: the file-drop
    equivalent of an image topic. Read with the port's own PNG reader, so
    PNG files need no OpenCV."""

    def __init__(self, path, poll_s=0.05, idle_timeout_s=5.0):
        self.path = path
        self.poll_s = poll_s
        self.idle_timeout_s = idle_timeout_s

    def frames(self):
        from orb_slam2_commit_tpu_torch.utils.datasets import _load_gray

        seen = set()
        idle = 0.0
        while idle < self.idle_timeout_s:
            names = sorted(
                f for f in os.listdir(self.path)
                if f.lower().endswith((".png", ".jpg", ".pgm")) and f not in seen)
            if not names:
                time.sleep(self.poll_s)
                idle += self.poll_s
                continue
            idle = 0.0
            for f in names:
                seen.add(f)
                yield time.time(), _load_gray(os.path.join(self.path, f))


# ----------------------------------------------------------------------
# The wire: the image topic without ROS.
#
# Per frame: header '!4sdB' = magic b'OSF1' | f64 timestamp | u8 plane
# count, then per plane '!IIB' = u32 H | u32 W | u8 dtype code
# (0 = uint8, 1 = float32) and the row-major payload. One plane is a
# monocular frame; two carry left + right (stereo) or gray + depth in
# metres (RGB-D): the synchronized pair of the reference's Stereo / RGBD
# ROS nodes (reference README.md:224-248).
# ----------------------------------------------------------------------

_FRAME_MAGIC = b"OSF1"
_FRAME_HDR = struct.Struct("!4sdB")
_PLANE_HDR = struct.Struct("!IIB")
_DTYPES = {0: np.uint8, 1: np.float32}
_DTYPE_CODES = {np.dtype(np.uint8): 0, np.dtype(np.float32): 1}


def publish_frames(sock, frames):
    """Publisher side: stream (timestamp, image[, aux]) tuples over a
    connected socket; aux is the right image (stereo) or the depth map
    (RGB-D, float32 metres)."""
    for item in frames:
        ts, planes = item[0], item[1:]
        sock.sendall(_FRAME_HDR.pack(_FRAME_MAGIC, float(ts), len(planes)))
        for image in planes:
            image = np.ascontiguousarray(image)
            code = _DTYPE_CODES[image.dtype]
            h, w = image.shape
            sock.sendall(_PLANE_HDR.pack(h, w, code))
            sock.sendall(image.tobytes())


def _recv_exact(sock, n):
    """n bytes from the socket (a bytearray), or None at end of stream."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class SocketSource(FrameSource):
    """Subscribes to a frame stream on a TCP socket.

    listen=True binds and accepts one publisher; listen=False connects out
    to a publisher; sock: an already connected socket. Iteration ends when
    the publisher disconnects."""

    def __init__(self, host="127.0.0.1", port=7007, listen=True, sock=None,
                 timeout_s=30.0):
        self.host, self.port, self.listen = host, port, listen
        self.timeout_s = timeout_s
        self._sock = sock

    def frames(self):
        sock = self._sock
        server = None
        if sock is None:
            if self.listen:
                server = socket.create_server((self.host, self.port))
                server.settimeout(self.timeout_s)
                sock, _ = server.accept()
            else:
                sock = socket.create_connection((self.host, self.port),
                                                timeout=self.timeout_s)
        sock.settimeout(self.timeout_s)
        try:
            while True:
                hdr = _recv_exact(sock, _FRAME_HDR.size)
                if hdr is None:
                    return
                magic, ts, n_planes = _FRAME_HDR.unpack(hdr)
                if magic != _FRAME_MAGIC or not 1 <= n_planes <= 2:
                    raise ValueError("bad frame header on socket stream")
                planes = []
                for _ in range(n_planes):
                    ph = _recv_exact(sock, _PLANE_HDR.size)
                    if ph is None:
                        return
                    h, w, code = _PLANE_HDR.unpack(ph)
                    if code not in _DTYPES:
                        raise ValueError("bad plane dtype on socket stream")
                    dtype = _DTYPES[code]
                    payload = _recv_exact(sock, h * w * np.dtype(dtype).itemsize)
                    if payload is None:
                        return
                    planes.append(np.frombuffer(payload, dtype).reshape(h, w))
                yield (ts, *planes)
        finally:
            sock.close()
            if server is not None:
                server.close()


class OpenCVCaptureSource(FrameSource):
    """A camera (int index) or a video file (str path) through
    cv2.VideoCapture: the reference's ROS Mono node fed by a usb_cam driver
    (reference README.md:190-211) in one process. Video files are paced to
    their container's fps unless realtime=False. OpenCV is imported when
    the frames are asked for; without it that raises ModuleNotFoundError
    naming cv2."""

    def __init__(self, target, realtime=None):
        self.target = target
        self.is_camera = isinstance(target, int)
        self.realtime = self.is_camera if realtime is None else realtime

    def frames(self):
        try:
            cv2 = importlib.import_module("cv2")
        except ModuleNotFoundError as e:
            raise ModuleNotFoundError(
                "OpenCVCaptureSource needs OpenCV (the cv2 module), which is not "
                "installed", name="cv2") from e
        cap = cv2.VideoCapture(self.target)
        if not cap.isOpened():
            raise RuntimeError(f"cannot open capture {self.target!r}")
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        t0 = time.time()
        i = 0
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    return
                if frame.ndim == 3:
                    frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
                ts = time.time() - t0 if self.is_camera else i / fps
                if self.realtime and not self.is_camera:
                    target = t0 + ts
                    now = time.time()
                    if target > now:
                        time.sleep(target - now)
                yield ts, np.ascontiguousarray(frame, np.uint8)
                i += 1
        finally:
            cap.release()


@dataclasses.dataclass
class LiveRun:
    """What one run_live call saw. fed_ts: the timestamps of the frames
    given to the System, in order; poses: each one's pose (None when not
    tracked); track_s: each entry call's seconds; states: the tracking
    state after each; seconds: from the first frame's wait to the end of
    shutdown."""

    system: object
    viewer: Optional[object]
    n_in: int
    n_tracked: int
    n_dropped: int
    fed_ts: List[float]
    poses: list
    track_s: List[float]
    states: List[str]
    seconds: float


def run_live(source, config, vocab="default", drop_when_behind=True,
             fps=30.0, viewer_dir=None, use_viewer=False, device="cuda") -> LiveRun:
    """Pump a FrameSource through the System online, on `device`.

    drop_when_behind mirrors a ROS subscriber queue of depth 1: when
    tracking falls behind the stream, stale frames (older than 1.5 frame
    periods by arrival, the age being the wall time since the first frame
    was asked for less the frame's timestamp) are skipped so the tracker
    always sees a fresh image; the first two frames are never dropped.
    Frames newer than that are tracked, since skipping them would break the
    constant-velocity motion model.

    use_viewer starts the render thread (slam/viewer.ViewerLoop, the
    reference's Viewer thread, src/Viewer.cc:55-243); viewer_dir also
    streams its frames as PNGs into that directory."""
    from orb_slam2_commit_tpu_torch.slam.system import System

    system = System(config, vocabulary=vocab, device=device)
    viewer = None
    if use_viewer or viewer_dir is not None:
        from orb_slam2_commit_tpu_torch.slam.viewer import ViewerLoop

        viewer = ViewerLoop(system, fps=fps, stream_dir=viewer_dir).start()
    n_in = n_tracked = n_dropped = 0
    fed_ts, poses, track_s, states = [], [], [], []
    stale_s = 1.5 / fps
    t_start = time.time()
    sensor = config.sensor if config is not None else "monocular"

    for item in source.frames():
        ts, image, aux = item[0], item[1], item[2] if len(item) > 2 else None
        n_in += 1
        age = (time.time() - t_start) - ts
        if drop_when_behind and age > stale_s and n_in > 2:
            n_dropped += 1
            continue
        t0 = time.perf_counter()
        if sensor == "stereo":
            pose = system.track_stereo(image, aux, ts)
        elif sensor == "rgbd":
            pose = system.track_rgbd(image, aux, ts)
        else:
            pose = system.track_monocular(image, ts)
        track_s.append(time.perf_counter() - t0)
        fed_ts.append(ts)
        poses.append(pose)
        states.append(system.tracking_state().name)
        if viewer is not None:
            viewer.update(system.tracker.last_frame, image)
        if pose is not None:
            n_tracked += 1
    if viewer is not None:
        viewer.join(timeout=5.0)
        print(f"viewer: {viewer.n_rendered} renders, {viewer.n_errors} render errors")
    system.shutdown()
    seconds = time.time() - t_start
    print(f"stream done: {n_in} frames in, {n_tracked} tracked, {n_dropped} dropped")
    return LiveRun(system, viewer, n_in, n_tracked, n_dropped, fed_ts, poses, track_s,
                   states, seconds)


def parse_flags(argv):
    """Parse `--flag=value`, `--flag value` and bare `--flag` forms.

    A bare value-taking flag (`--listen` followed by another flag or
    nothing) parses to True; value_of() then raises a clear error instead
    of coercing True to 1."""
    flags = {}
    i = 0
    while i < len(argv):
        a = argv[i]
        if not a.startswith("--"):
            raise SystemExit(f"unexpected positional argument: {a!r}")
        if "=" in a:
            k, v = a.split("=", 1)
            flags[k] = v
        elif i + 1 < len(argv) and not argv[i + 1].startswith("--"):
            flags[a] = argv[i + 1]
            i += 1
        else:
            flags[a] = True
        i += 1
    return flags


def value_of(flags, key):
    v = flags[key]
    if v is True:
        raise SystemExit(f"{key} requires a value: {key}=<value> or {key} <value>")
    return v


def main(argv):
    flags = parse_flags(argv)
    use_viewer = "--viewer" in flags
    viewer_dir = flags.get("--viewer-dir")
    device = value_of(flags, "--device") if "--device" in flags else "cuda"
    if "--sim" in flags:
        from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

        n = int(value_of(flags, "--frames")) if "--frames" in flags else 30
        config = synthetic_config(width=400, height=300, n_features=1000)
        src = SyntheticSource(config, n_frames=n)
        run_live(src, config, use_viewer=use_viewer, viewer_dir=viewer_dir, device=device)
    elif any(k in flags for k in ("--watch", "--listen", "--connect", "--camera", "--video")):
        from orb_slam2_commit_tpu_torch.utils import settings

        config = settings.config_from_settings(
            value_of(flags, "--settings"), sensor=flags.get("--sensor", "monocular"))
        if "--watch" in flags:
            src = DirectoryWatchSource(value_of(flags, "--watch"))
        elif "--listen" in flags:
            src = SocketSource(port=int(value_of(flags, "--listen")), listen=True)
        elif "--connect" in flags:
            host, port = value_of(flags, "--connect").rsplit(":", 1)
            src = SocketSource(host=host, port=int(port), listen=False)
        elif "--camera" in flags:
            src = OpenCVCaptureSource(int(value_of(flags, "--camera")))
        else:
            src = OpenCVCaptureSource(value_of(flags, "--video"))
        run_live(src, config, use_viewer=use_viewer, viewer_dir=viewer_dir, device=device)
    else:
        print(__doc__)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

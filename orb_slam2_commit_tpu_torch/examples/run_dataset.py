"""Dataset driver: the port's counterpart of the reference's Examples/
drivers (Examples/{Monocular,Stereo,RGB-D}/*.cc). It loads a sequence from
disk, feeds its frames through the System, prints the per-frame timing and
exports the trajectories.

Usage:
  python -m orb_slam2_commit_tpu_torch.examples.run_dataset tum-mono <seq_dir> <settings.yaml> [out_prefix]
  python -m orb_slam2_commit_tpu_torch.examples.run_dataset tum-rgbd <seq_dir> <assoc.txt> <settings.yaml> [out_prefix]
  python -m orb_slam2_commit_tpu_torch.examples.run_dataset kitti-mono <seq_dir> <settings.yaml> [out_prefix]
  python -m orb_slam2_commit_tpu_torch.examples.run_dataset kitti-stereo <seq_dir> <settings.yaml> [out_prefix]
  python -m orb_slam2_commit_tpu_torch.examples.run_dataset euroc-mono <seq_dir> <settings.yaml> [out_prefix]
  python -m orb_slam2_commit_tpu_torch.examples.run_dataset euroc-stereo <seq_dir> <settings.yaml> [out_prefix]

euroc-stereo rectifies every pair from the settings' LEFT.* / RIGHT.*
blocks (stereo_euroc.cc:55-98). By default this runs the reference's
architecture (src/System.cc:95-107) on the CUDA card: asynchronous local
mapping and loop closing with the bundled vocabulary. Flags:
  --sync             synchronous mapping, on the tracking thread
  --no-vocab         no place recognition and no loop closing
  --vocab=<path>     a vocabulary file (.npz or the ORBvoc.txt layout)
  --map=<map.npz>    load a saved map before the first frame
  --localization     localization only, against the loaded map
  --device=cpu       run on the CPU (the kernels' plain versions)
Writes <out_prefix>_tum.txt, <out_prefix>_kf_tum.txt and
<out_prefix>_kitti.txt (out_prefix "trajectory" by default).
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import List, Optional

import numpy as np

# Each mode's sensor, and the dataset's own image size (width, height),
# which its settings files leave out.
MODES = {
    "tum-mono": ("monocular", None),
    "tum-rgbd": ("rgbd", None),
    "kitti-mono": ("monocular", (1241, 376)),
    "kitti-stereo": ("stereo", (1241, 376)),
    "euroc-mono": ("monocular", (752, 480)),
    "euroc-stereo": ("stereo", (752, 480)),
}


@dataclasses.dataclass
class DatasetRun:
    """What one run measured. track_s: per frame, from the image in memory
    to the tracker's return (the rectification included, as the
    reference's drivers time it); read_s: per frame, reading its PNG files;
    remap_s: per rectified pair; states: the tracking state after each
    frame; shutdown_s: the System's shutdown."""

    system: object
    out: str
    track_s: List[float]
    read_s: List[float]
    remap_s: List[float]
    states: list
    shutdown_s: float


def _parse(argv):
    args = [a for a in argv if not a.startswith("--")]
    flags = {a.split("=", 1)[0]: (a.split("=", 1) + [True])[1]
             for a in argv if a.startswith("--")}
    return args, flags


def _load(mode, args):
    """(sequence, config, out prefix, rectification maps or None)."""
    from orb_slam2_commit_tpu_torch.utils import datasets, settings

    sensor, size = MODES[mode]
    width, height = size if size else (None, None)
    n_in = 3 if mode == "tum-rgbd" else 2
    if len(args) < n_in + 1:
        return None
    yaml = args[n_in]
    out = args[n_in + 1] if len(args) > n_in + 1 else "trajectory"
    cfg = settings.config_from_settings(yaml, sensor=sensor, width=width, height=height)
    seq_dir = args[1]
    maps = None
    if mode == "tum-rgbd":
        seq = datasets.load_tum_rgbd(seq_dir, args[2])
    elif mode == "tum-mono":
        seq = datasets.load_tum_mono(seq_dir)
    elif mode.startswith("kitti"):
        seq = datasets.load_kitti(seq_dir, stereo=sensor == "stereo")
    else:
        seq = datasets.load_euroc(seq_dir, stereo=sensor == "stereo")
    if mode == "euroc-stereo":
        s = settings.parse_opencv_yaml(yaml)
        w, h = cfg.camera.width, cfg.camera.height
        maps = tuple(
            datasets.rectify_maps(s[f"{side}.K"], s[f"{side}.D"].reshape(-1), s[f"{side}.R"],
                                  s[f"{side}.P"][:3, :3], w, h)
            for side in ("LEFT", "RIGHT"))
    return seq, cfg, out, maps


def run(argv) -> Optional[DatasetRun]:
    """Run the driver on argv (the command line without the program's
    name); None, with the usage printed, when argv does not name a mode
    and its arguments."""
    args, flags = _parse(argv)
    loaded = _load(args[0], args) if args and args[0] in MODES else None
    if loaded is None:
        print(__doc__)
        return None
    # Imported here, so that a call without arguments prints the usage
    # without loading the System.
    from orb_slam2_commit_tpu_torch.slam.system import System
    from orb_slam2_commit_tpu_torch.utils import datasets

    seq, cfg, out, maps = loaded
    vocab = flags.get("--vocab", "default")
    if flags.get("--no-vocab"):
        vocab = None
    sys_ = System(cfg, vocabulary=vocab, async_mapping=not flags.get("--sync"),
                  device=flags.get("--device", "cuda"))
    if flags.get("--map"):
        sys_.load_map(flags["--map"])
    if flags.get("--localization"):
        sys_.activate_localization_mode()

    track_s, read_s, remap_s, states = [], [], [], []
    frames = seq.frames()
    for i in range(len(seq)):
        t_read = time.perf_counter()
        ts, img, aux = next(frames)
        t0 = time.perf_counter()
        read_s.append(t0 - t_read)
        if maps is not None:
            img = datasets.remap_bilinear(img, *maps[0])
            aux = datasets.remap_bilinear(aux, *maps[1])
            remap_s.append(time.perf_counter() - t0)
        if cfg.sensor == "rgbd":
            sys_.track_rgbd(img, aux, ts)
        elif cfg.sensor == "stereo":
            sys_.track_stereo(img, aux, ts)
        else:
            sys_.track_monocular(img, ts)
        track_s.append(time.perf_counter() - t0)
        states.append(sys_.tracking_state())
        if i % 50 == 0:
            print(f"frame {i}/{len(seq)} state={states[-1].name} "
                  f"kf={sys_.map.n_keyframes()} pts={sys_.map.n_points()} "
                  f"dt={track_s[-1] * 1e3:.1f}ms")

    t_end = time.perf_counter()
    sys_.shutdown()
    shutdown_s = time.perf_counter() - t_end
    # Timing as the reference's drivers print it (mono_tum.cc:119-127).
    ordered = np.sort(track_s)
    print(f"median tracking time: {ordered[len(ordered) // 2] * 1e3:.2f} ms")
    print(f"mean tracking time:   {np.mean(track_s) * 1e3:.2f} ms")
    print(f"mean image read time: {np.mean(read_s) * 1e3:.2f} ms a frame")
    if remap_s:
        print(f"mean rectification time: {np.mean(remap_s) * 1e3:.2f} ms a pair")
    sys_.save_trajectory_tum(out + "_tum.txt")
    sys_.save_keyframe_trajectory_tum(out + "_kf_tum.txt")
    sys_.save_trajectory_kitti(out + "_kitti.txt")
    print(f"trajectories saved with prefix {out}")
    return DatasetRun(sys_, out, track_s, read_s, remap_s, states, shutdown_s)


def main(argv) -> int:
    return 1 if run(argv) is None else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

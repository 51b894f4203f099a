"""orb_slam2_commit_tpu_torch — the PyTorch + CUDA port of the SLAM engine.

A second package beside the JAX reference (`orb_slam2_commit_tpu`): the
same subpackages and function names, written on torch tensors, with the
reference's TPU kernels rewritten by hand as CUDA kernels for the NVIDIA
H100 (sm_90a) under `csrc/`, each with a plain PyTorch version beside it
in `kernels/`. The port imports neither JAX nor the JAX package.

Ported so far, in `slam.jit_frontend`: the per-frame tracking step
(`tracking_forward_step`: packed-canvas ORB extraction with subpixel
refinement, projection matching, pose-only Levenberg-Marquardt) and the
tracker's per-frame pair (`fused_motion_track_packed`, then
`fused_local_map_track`).
"""

__version__ = "0.1.0"

"""orb_slam2_commit_tpu_torch — the PyTorch + CUDA port of the SLAM engine.

A second package beside the JAX reference (`orb_slam2_commit_tpu`): the
same subpackages and function names, written on torch tensors, with the
reference's TPU kernels rewritten by hand as CUDA kernels for the NVIDIA
H100 (sm_90a) under `csrc/`, each with a plain PyTorch version beside it
in `kernels/`. The port imports neither JAX nor the JAX package.

Ported so far: the per-frame tracking step
(`slam.jit_frontend.tracking_forward_step`): packed-canvas ORB extraction
without subpixel refinement, projection matching against the last frame's
points, and pose-only Levenberg-Marquardt.
"""

__version__ = "0.1.0"

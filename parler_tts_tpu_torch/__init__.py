"""PyTorch/CUDA port of ``parler_tts_tpu`` for NVIDIA Hopper (H100).

Module names mirror the JAX package.  The port imports torch and numpy only;
its hand-written CUDA kernels live in ``csrc/`` and are built with ``nvcc`` at
first use (``ops/cuda_build.py``).  Entry points run on CUDA unless the
caller passes ``device="cpu"``.
"""

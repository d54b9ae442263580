"""PyTorch/CUDA port of ``u2mkd_tpu`` for the NVIDIA H100.

Mirrors the JAX package's layout (``core/``, ``data/``, ``models/``,
``ops/``, ``train/``) and imports nothing of it: the JAX package is the
reference the port is tested against. The kernels that the JAX package wrote
in Pallas for the TPU are hand-written CUDA C++ for ``sm_90a`` under
``csrc/``, built with ``nvcc`` at first use (``ops/kernels/build.py``).
"""

"""PyTorch/CUDA port of the ``repro`` package (stochastic-rounding GEMMs).

The JAX package ``repro`` is the reference; this package mirrors its module
layout and draws the identical counter-based random bits, so every part can
be held against it.  It imports ``torch`` and ``numpy`` only.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper takes its plain PyTorch
twin.  Hand-written CUDA C++ kernels live in ``csrc/`` and are built with
``nvcc`` at first use (``kernels/build.py``).
"""

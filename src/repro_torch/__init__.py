"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

The JAX package (``src/repro``) is the reference; this package mirrors it
file for file and imports only torch, numpy and the standard library.
Every Pallas kernel of a ported slice has a hand-written CUDA counterpart
under ``csrc/``, built at first use by :mod:`repro_torch.kernels._build`.
"""

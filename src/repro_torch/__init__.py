"""Spec-QP on PyTorch and CUDA: the port of the ``repro`` (JAX) package.

The module layout mirrors ``repro`` (``core/``, ``data/``, ``kernels/``,
``launch/``, ``configs/``) so every module's counterpart is easy to find.
Nothing here imports JAX or ``repro``. Entry points run on CUDA unless the
caller passes ``device="cpu"``; there is no silent CPU fallback.
"""

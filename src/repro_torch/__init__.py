"""PyTorch/CUDA port of the Atlas hybrid far-memory data plane.

The module tree mirrors the JAX package ``repro`` (the reference): ``core``
(layout, state, faults, paths, batch, plane), ``kernels`` (hand-written
CUDA kernels for Hopper with their plain PyTorch versions), ``serving``,
``data`` and ``launch``.  Entry points run on the card (``device="cuda"``)
unless the caller asks for ``device="cpu"``.  This package never imports
JAX or ``repro``.
"""

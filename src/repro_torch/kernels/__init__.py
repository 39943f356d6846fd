"""Hand-written CUDA kernels of the hybrid plane, with their plain
PyTorch versions.

``csrc/`` holds the CUDA C++ sources (built for ``sm_90a`` at first use by
``_build``); ``gather_objects``, ``compact``, ``cat_decay``,
``topk_pages``, ``paged_attention`` and ``cat_update`` are the wrappers
that launch them; ``ref`` holds the plain versions; ``ops`` is the
dispatch the plane calls.
"""
from . import ops, ref

__all__ = ["ops", "ref"]

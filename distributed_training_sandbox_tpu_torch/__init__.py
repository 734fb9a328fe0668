"""PyTorch/CUDA port of ``distributed_training_sandbox_tpu``.

The JAX package is the reference; this package re-implements its paged
serving path on PyTorch, with the two TPU attention kernels (paged
decode, paged flash prefill) rewritten as CUDA C++ for Hopper
(``csrc/``, built at first use by ``kernels/loader.py``).

Importing this package imports ``torch`` and ``numpy`` only — never
``jax`` and never the JAX package.  Entry points run on the CUDA device
unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]

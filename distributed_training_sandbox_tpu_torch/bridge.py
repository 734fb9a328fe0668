"""Parameter bridge between the JAX reference and the port.

The port keeps the reference's parameter tree (same leaf paths, stacked
``(L, …)`` layer tensors, ``(in, out)`` projection layout), so crossing
over is one array copy per leaf.  The JAX side is handed over as numpy
arrays (``jax.tree.map(np.asarray, params)``): this module never
imports JAX.  bf16 leaves arrive as numpy arrays of ``ml_dtypes``'
bfloat16, which numpy cannot hand to torch directly; they cross as
their raw 16-bit patterns, so the copy is exact either way.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_torch(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.array(a)   # a writable copy: JAX hands out read-only views
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # only callers that hold JAX arrays need this
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(np_tree: dict, cfg, device=None) -> dict:
    """Reference params (a dict tree of numpy arrays) → the port's
    params in ``cfg.dtype`` on ``device`` (default: CPU), leaf for
    leaf."""
    return _map(np_tree, lambda a: _to_torch(a, cfg.dtype, device))


def params_to_numpy(params: dict) -> dict:
    """The inverse: the port's params → a dict tree of numpy arrays in
    the reference's layout (``jax.numpy.asarray`` takes each leaf)."""
    return _map(params, _to_numpy)

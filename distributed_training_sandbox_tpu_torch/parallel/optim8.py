"""Adam with int8 moments at rest.

Port of the JAX package's ``parallel/optim8.py``: both moments stored
as int8 codes with f32 per-row scales (rows along the last axis), so the
at-rest state is about half of bf16 moments'.

  * ``mu`` (signed): linear, ``q = round(m / scale)`` with ``scale =
    max(absmax, 1e-12) / 127`` per row;
  * ``nu`` (non-negative, a wide range): quantised in the square-root
    domain, ``q = round(sqrt(v) / scale)``, dequantised as
    ``(q · scale)²``;
  * the update dequantises to f32, runs ``optim.adam_update``'s
    arithmetic, and requantises.  No error-feedback buffer.

1-D leaves (norm scales) keep full-precision moments.

The reference divides by 127 inside its jitted step, which XLA turns
into a multiplication by ``f32(1/127)``; the quantisers here take that
form, as ``ops.quant.quantize_int8`` does.  The reference's
``adam8_step_donated`` donates the state to XLA; :func:`adam8_update`
instead requantises into the same int8 and scale tensors (``copy_``)
and writes the parameters in place, one leaf at a time, so only one
leaf's f32 copies are alive at once and the at-rest state is never held
twice.

Under FSDP each rank quantises its own shard.  For a leaf sharded along
its last axis (the stacked norm scales ``(L, H)``) the reference
declares the scale replicated, yet each device computes it from its
own shard (ROADMAP.md C6); here each rank keeps its own scale, as each
reference device does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.quant import INV_127
from .optim import AdamState, tree_get, tree_leaves, tree_map

__all__ = ["Q8", "adam8_init", "adam8_update", "adam8_step",
           "state_bytes"]


class Q8(NamedTuple):
    """One int8-stored moment leaf: codes (the param's shape) and f32
    per-row scales (``shape[:-1] + (1,)``)."""
    q: torch.Tensor
    scale: torch.Tensor


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root on every device.  CUDA's
    ``torch.sqrt`` is; the CPU's vectorised one is not (one ulp off on
    26 124 of 4 000 000 f32 draws on an H100 machine's host,
    ``chip_smoke.py``, PERF.md), so there it goes through f64, whose
    root rounds to the correct f32."""
    if x.device.type == "cuda":
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def _linear_scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(amax, 1e-12) * INV_127


def _quant_linear(x: torch.Tensor) -> Q8:
    scale = _linear_scale(x.abs().amax(dim=-1, keepdim=True))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return Q8(q=q, scale=scale)


def _dequant_linear(m: Q8) -> torch.Tensor:
    return m.q.float() * m.scale


def _quant_sqrt(v: torch.Tensor) -> Q8:
    s = _sqrt(v)
    scale = _linear_scale(s.amax(dim=-1, keepdim=True))
    q = torch.clamp(torch.round(s / scale), 0, 127).to(torch.int8)
    return Q8(q=q, scale=scale)


def _dequant_sqrt(m: Q8) -> torch.Tensor:
    s = m.q.float() * m.scale
    return s * s


def _store(dst: Q8, src: Q8) -> None:
    """Requantised moments into the leaf's own buffers."""
    dst.q.copy_(src.q)
    dst.scale.copy_(src.scale)


def adam8_init(params) -> AdamState:
    """Zero moments: a :class:`Q8` for every leaf of two or more dims, a
    full-precision zero tensor (the leaf's dtype) for 1-D leaves."""
    def zq(p):
        if p.ndim < 2:
            return torch.zeros_like(p)
        return Q8(q=torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                  scale=torch.zeros(p.shape[:-1] + (1,), dtype=torch.float32,
                                    device=p.device))
    return AdamState(mu=tree_map(zq, params), nu=tree_map(zq, params),
                     count=0)


@torch.no_grad()
def adam8_update(grads, state: AdamState, params, *, lr=1e-3, b1=0.9,
                 b2=0.999, eps=1e-8, lr_mults=None):
    """``optim.adam_update`` on int8 moments: per leaf, dequantise to
    f32, ``m = b1·m + (1 - b1)·g`` and ``v = b2·v + (1 - b2)·g²`` in
    f32, the step ``(lr · mult) · (m / bc1) / (sqrt(v / bc2) + eps)``
    (square roots correctly rounded, ``_sqrt``: the card and the CPU
    agree bit for bit),
    the parameter rounded to its dtype, and the moments requantised into
    their own buffers (1-D leaves: stored in their dtype).  In place;
    returns ``(params, new_state)``.  ``lr_mults``: a tree of per-leaf
    multipliers of ``lr``, as ``optim.adam_update``'s."""
    count = state.count + 1
    c = torch.tensor(float(count))   # the bias corrections in f32
    bc1 = 1 - torch.tensor(b1) ** c
    bc2 = 1 - torch.tensor(b2) ** c
    for path, p in tree_leaves(params):
        g32 = tree_get(grads, path).float()
        mq, vq = tree_get(state.mu, path), tree_get(state.nu, path)
        mult = 1.0 if lr_mults is None else tree_get(lr_mults, path)
        quantized = isinstance(mq, Q8)
        m_prev = _dequant_linear(mq) if quantized else mq.float()
        v_prev = _dequant_sqrt(vq) if quantized else vq.float()
        b1d, b2d = bc1.to(p.device), bc2.to(p.device)
        m = b1 * m_prev + (1 - b1) * g32
        v = b2 * v_prev + (1 - b2) * g32 * g32
        step = (lr * mult) * (m / b1d) / (_sqrt(v / b2d) + eps)
        p.copy_(p.float() - step)
        if quantized:
            _store(mq, _quant_linear(m))
            _store(vq, _quant_sqrt(v))
        else:
            mq.copy_(m)
            vq.copy_(v)
    return params, AdamState(mu=state.mu, nu=state.nu, count=count)


def adam8_step(grads, state: AdamState, params, lr):
    """The twin of the reference's ``adam8_step_donated``: one
    :func:`adam8_update` at the default betas, in place."""
    return adam8_update(grads, state, params, lr=lr)


def state_bytes(state: AdamState) -> int:
    """Bytes of the moments at rest: codes, scales and the 1-D leaves'
    full-precision moments."""
    return sum(t.numel() * t.element_size()
               for tree in (state.mu, state.nu)
               for _, leaf in tree_leaves(tree)
               for t in (leaf if isinstance(leaf, Q8) else (leaf,)))

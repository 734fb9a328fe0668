"""The FSDP train step, on one process for now.

Port of the JAX package's ``parallel/fsdp.py`` explicit step
(``make_fsdp_train_step``) at world size 1, the path of the one-card
flagship (``scripts/train_flagship.py``).  With one rank FSDP's
per-layer gathers are identities, so the step is value-and-grad of
``lm_loss`` (with optional microbatch accumulation), then Adam with the
reference's b1 0.9, b2 0.95 and moments in the params' dtype.  The name
stays so that a reader finds the counterpart, and so that the
multi-rank step grows here over NCCL (ROADMAP.md queue A item 6).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..models import transformer as T
from . import optim

_ROADMAP_A6 = "not ported yet — see ROADMAP.md, queue A item 6 (FSDP)"


def init_fsdp_opt_state(params: dict, state_dtype=None) -> optim.AdamState:
    """Adam state for ``params``: moments in the params' dtype unless
    ``state_dtype`` says otherwise (the reference's bf16 AdamW state)."""
    return optim.adam_init(params, state_dtype)


def _unflatten(params: dict, flat) -> dict:
    """``flat`` (in ``tree_leaves`` order) as a tree shaped like params."""
    it = iter(flat)
    return optim.tree_map(lambda _: next(it), params)


def microbatch_value_and_grad(loss_fn, params: dict, batch,
                              accum_steps: int):
    """``(mean loss, mean grads)`` of ``loss_fn(params, batch)`` over
    ``accum_steps`` leading-dim splits of the batch, grads summed and
    divided once at the end, as the reference's scan does."""
    leaves = [p for _, p in optim.tree_leaves(params)]
    for p in leaves:
        p.requires_grad_(True)
    try:
        if accum_steps == 1:
            loss = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves)
            return loss.detach(), _unflatten(params, grads)
        B = batch[0].shape[0]
        if B % accum_steps:
            raise ValueError(
                f"accum_steps={accum_steps} must divide the per-device "
                f"batch {B}")
        m = B // accum_steps
        g_sum = [torch.zeros_like(p) for p in leaves]
        l_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(accum_steps):
            micro = tuple(t[i * m:(i + 1) * m] for t in batch)
            loss = loss_fn(params, micro)
            for acc, g in zip(g_sum, torch.autograd.grad(loss, leaves)):
                acc.add_(g)
            l_sum += loss.detach().float()
        return (l_sum / accum_steps,
                _unflatten(params, [g / accum_steps for g in g_sum]))
    finally:
        for p in leaves:
            p.requires_grad_(False)


def make_fsdp_train_step(params: dict, cfg: T.TransformerConfig, *,
                         lr: float = 3e-4,
                         lr_schedule: Callable | None = None,
                         b1: float = 0.9, b2: float = 0.95,
                         eps: float = 1e-8, accum_steps: int = 1,
                         overlap: str = "none",
                         quantized_gather: bool = False,
                         offload: str = "none",
                         state_precision: str = "full"):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``
    with ``batch`` = (input_ids, labels) tensors on the params' device.

    ``lr_schedule(count)`` is evaluated on the optimiser's step counter
    before the update increments it, as in the reference.  The update
    runs in place (``optim.adam_update``).  Multi-rank process groups,
    overlap modes, quantized gathers, offload and int8 state are not
    ported yet and raise."""
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(f"a process group of "
                                  f"{dist.get_world_size()} ranks: "
                                  f"{_ROADMAP_A6}")
    for name, value, default in (("overlap", overlap, "none"),
                                 ("quantized_gather", quantized_gather, False),
                                 ("offload", offload, "none"),
                                 ("state_precision", state_precision,
                                  "full")):
        if value != default:
            raise NotImplementedError(f"{name}={value!r}: {_ROADMAP_A6}")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    T.check_supported(cfg)

    def step(params, opt_state, batch):
        loss, grads = microbatch_value_and_grad(
            lambda p, b: T.lm_loss(p, b, cfg), params, batch, accum_steps)
        lr_t = lr_schedule(opt_state.count) if lr_schedule else lr
        params, opt_state = optim.adam_update(
            grads, opt_state, params, lr=lr_t, b1=b1, b2=b2, eps=eps)
        return params, opt_state, loss

    return step

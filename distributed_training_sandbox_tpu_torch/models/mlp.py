"""Toy MLPs of the strategy exercises.

Port of the JAX package's ``models/mlp.py``.  Two configurations recur:
  * the ZeRO toy: 6 × Linear(10_000, 10_000) with ReLU between — 12
    leaves, 600 060 000 f32 parameters (2.400 GB), big enough that
    sharding the optimizer state visibly moves peak memory;
  * the PP toy: Linear(50, 500) → 4 × Linear(500, 500) → Linear(500, 50)
    with ReLU between.

Params are a list of ``{"w": (in, out), "b": (out,)}`` dicts, one per
linear layer, applied as ``x @ w + b``: 2 leaves a layer, so per-leaf
collective counts map 1:1 to the reference's.
"""

from __future__ import annotations

import math

import torch

ZERO_TOY_SIZES = (10_000,) * 7
PP_TOY_SIZES = (50, 500, 500, 500, 500, 500, 50)


def init_mlp(generator: torch.Generator, sizes, dtype=torch.float32,
             device=None) -> list[dict]:
    """Uniform init with the reference's ranges: ``w ~ U(±sqrt(6 / fan_in)
    / sqrt(2))`` (sqrt(3) times nn.Linear's default bound) and ``b ~
    U(±1 / sqrt(fan_in))``, drawn in f32 on ``generator``'s device, layer
    by layer, ``w`` before ``b``, then cast to ``dtype`` on ``device``
    (default: the generator's).  The stream differs from
    ``jax.random``'s; parity tests bridge the reference's weights."""
    gdev = generator.device
    device = torch.device(device) if device is not None else gdev
    params = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        wb = math.sqrt(6.0 / fan_in) / math.sqrt(2)
        bb = 1.0 / math.sqrt(fan_in)
        w = torch.empty((fan_in, fan_out), dtype=torch.float32, device=gdev)
        w.uniform_(-wb, wb, generator=generator)
        b = torch.empty((fan_out,), dtype=torch.float32, device=gdev)
        b.uniform_(-bb, bb, generator=generator)
        params.append({"w": w.to(device=device, dtype=dtype),
                       "b": b.to(device=device, dtype=dtype)})
    return params


def mlp_apply_stage(params: list[dict], x: torch.Tensor, *,
                    last_stage: bool = False) -> torch.Tensor:
    """Apply a (slice of a) layered MLP: ReLU after every layer except the
    final layer of the last stage (a non-final pipeline stage keeps the
    ReLU after its last layer, as splitting ``nn.Sequential`` does)."""
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if not (last_stage and i == len(params) - 1):
            x = torch.relu(x)
    return x


def mlp_apply(params: list[dict], x: torch.Tensor) -> torch.Tensor:
    """ReLU between layers, none after the last."""
    return mlp_apply_stage(params, x, last_stage=True)


def zero_toy_mlp(generator: torch.Generator, dtype=torch.float32,
                 scale: int = 1, device=None) -> list[dict]:
    """The ZeRO exercise model; ``scale`` divides the width."""
    sizes = tuple(s // scale for s in ZERO_TOY_SIZES)
    return init_mlp(generator, sizes, dtype, device)


def pp_toy_mlp(generator: torch.Generator, dtype=torch.float32,
               device=None) -> list[dict]:
    return init_mlp(generator, PP_TOY_SIZES, dtype, device)


def mse_loss(params, batch, apply_fn=mlp_apply) -> torch.Tensor:
    x, y = batch
    pred = apply_fn(params, x)
    return torch.mean((pred - y) ** 2)

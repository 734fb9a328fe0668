"""Expert-parallel training of the toy MoE regression: the twin of the
JAX package's ``scripts/moe.py``.

    torchrun --nproc-per-node 4 -m \\
        distributed_training_sandbox_tpu_torch.train.moe_toy \\
        --device cpu --num-steps 30 [--experts 16]

One switch-MoE layer (``parallel.expert``, ``--hidden``, ``--ffn``,
``--experts``: default 2 a rank) with its experts sharded over every
rank (the ``ep`` axis), trained by ``make_ep_train_step`` with Adam to
map a seeded normal batch ``x`` (``--batch-size`` rows of 16 tokens, at
least one row a rank) to ``tanh(x) / 2``.  It prints the collectives of
one step (the shim) beside ``parallel.contracts.ep_step_collectives``
and the losses.  NCCL and the card by default, gloo with ``--device
cpu``; run alone, it is one rank.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops import collectives as C
from ..parallel import expert, optim
from ..parallel.contracts import ep_step_collectives
from ..utils import mesh
from ..utils.config import TrainConfig


def run(*, experts: int = 0, hidden: int = 64, ffn: int = 128,
        capacity_factor: float = 2.0, batch_size: int = 32,
        num_steps: int = 30, seed: int = 42, device=None,
        log=print) -> dict:
    """Train the toy layer ``num_steps`` steps on this rank (joins or
    makes the process group and leaves it up).  Returns the first and
    final losses, all losses, one step's collectives and the
    contract's."""
    dev = mesh.init_process_group(device)
    n, rank = mesh.axis_size(), mesh.axis_rank()
    n_exp = experts or 2 * n
    if n_exp % n:
        raise ValueError(f"--experts {n_exp} must be divisible by the {n} "
                         f"ranks")
    B = max(batch_size, n)
    if B % n:
        raise ValueError(f"--batch-size {B} must be divisible by the {n} "
                         f"ranks")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = expert.shard_moe_params(expert.init_moe_params(
        gen, hidden=hidden, ffn=ffn, n_experts=n_exp, device=dev))
    opt = optim.adam_init(params._asdict())
    step = expert.make_ep_train_step(params, capacity_factor=capacity_factor)
    gen.manual_seed(seed + 1)
    x = torch.randn((B, 16, hidden), generator=gen, device=dev)
    y = torch.tanh(x) * 0.5
    if rank == 0:
        log(f"[moe] {n_exp} experts over ep={n} hidden={hidden} ffn={ffn} "
            f"capacity_factor={capacity_factor} device={dev}")
    losses, counts = [], None
    for i in range(num_steps):
        C.COLLECTIVES.reset()
        params, opt, loss = step(params, opt, (x, y))
        counts = counts or C.COLLECTIVES.read()
        losses.append(float(loss))
        if rank == 0 and (i % 10 == 0 or i == num_steps - 1):
            log(f"[moe] step {i:3d} loss {losses[-1]:.5f}")
    contract = ep_step_collectives()
    if rank == 0:
        log(f"[moe] collectives a step {json.dumps(C.COLLECTIVES.nonzero(counts or {}))}"
            f", the contract's {json.dumps(C.COLLECTIVES.nonzero(contract))}")
        if losses:
            log(f"[moe] loss {losses[0]:.5f} -> {losses[-1]:.5f} "
                f"({'learning' if losses[-1] < losses[0] else 'NOT learning'})")
    return {"first_loss": losses[0] if losses else None,
            "final_loss": losses[-1] if losses else None, "losses": losses,
            "collectives": counts, "contract": contract}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                allow_abbrev=False)
    p.add_argument("--experts", type=int, default=0,
                   help="total experts (default 2 a rank)")
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--ffn", type=int, default=128)
    p.add_argument("--capacity-factor", type=float, default=2.0)
    p.add_argument("--device", default=None,
                   help="default: the CUDA card (NCCL); 'cpu' for gloo")
    args, rest = p.parse_known_args(argv)
    cfg = TrainConfig.from_args(rest, num_steps=30)
    try:
        run(experts=args.experts, hidden=args.hidden, ffn=args.ffn,
            capacity_factor=args.capacity_factor,
            batch_size=cfg.batch_size, num_steps=cfg.num_steps,
            seed=cfg.seed, device=args.device)
    finally:
        mesh.destroy_process_group()


if __name__ == "__main__":
    main()

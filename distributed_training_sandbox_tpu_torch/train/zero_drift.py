"""Where ZeRO-2 and ZeRO-3 part from baseline Adam on several ranks.

    torchrun --nproc-per-node 4 -m \\
        distributed_training_sandbox_tpu_torch.train.zero_drift --scale 1

At one rank every ZeRO leg of ``train.zero`` equals its baseline Adam
leg bit for bit.  On several ranks ZeRO-2's grads (and ZeRO-3's, through
the gather's backward) come from a reduce_scatter of each padded flat
grad, the baseline's from a per-leaf all_reduce: the same sums, added in
another order.  This runs the baseline Adam, ZeRO-2 and ZeRO-3 legs of
``train.zero`` in lockstep, on the same params and batch, and before
each step takes the baseline's own local grads and, on this rank's
chunk of every leaf:

  * holds the reduce_scatter's mean against the all_reduce's: every
    element within what two orders of the same sum can differ by,
    ``2 γ_ws Σ_r |g_r| / ws`` (γ_k = k·u / (1 - k·u), u = 2^-24); one
    element beyond it fails the run;
  * counts the elements where the two differ, by their cancellation
    ratio ``|ḡ| / (Σ_r |g_r| / ws)`` (1 where the ranks' grads agree in
    sign, near 0 where the sum is mostly cancelled, so that a last-bit
    difference of its terms is a large relative difference of the sum);
  * applies Adam to the same moments and param with either grad: the
    largest difference of the two updated params, over all elements and
    over those whose ratio is at least ``CANCELLED``.

After each step it compares the ZeRO-2 and ZeRO-3 params (ZeRO-3's
gathered from its chunks) with the baseline's: how many differ and by
how much; ZeRO-3 must equal ZeRO-2 bit for bit (the same reduce_scatter
sums, through the gather's backward), or the run fails.  At the end it
counts where the param differences sit by Adam's denominator
(:func:`final_drift`).  Rank 0 prints a line a step and, with
``--out``, writes every reading as JSON.  NCCL and the card by default,
gloo with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..models import mlp
from ..ops import collectives as C
from ..parallel import ddp, optim, zero
from ..parallel.fsdp import local_batch, microbatch_value_and_grad
from ..utils import mesh
from .zero import toy_problem

U = 2.0 ** -24          # f32's unit roundoff
CANCELLED = 1e-2        # a sum below 1 % of its terms' magnitudes
RATIO_DECADES = (1e-1, 1e-2, 1e-3, 1e-4, 1e-5, 1e-6)
BIG = 1e-5              # a param difference of 1 % of lr
RMS_EDGES = (1e-8, 1e-7, 1e-6, 1e-5)
B2 = 0.999              # optim.adam_update's default


def order_bound(absum: torch.Tensor, ws: int) -> torch.Tensor:
    """How far apart two summation orders can put the mean of ws f32
    terms whose magnitudes sum to ``absum``: each order within
    γ_(ws-1) · absum of the exact sum, the division by ws one more
    rounding."""
    gamma = ws * U / (1 - ws * U)
    return 2 * gamma * absum / ws


@torch.no_grad()
def grad_orders(params, opt: optim.AdamState, grads, ws: int) -> dict:
    """This rank's readings of one step's grads (see the module
    docstring) and ``differ``, the per-leaf masks of the chunk elements
    where the reduce_scatter's mean is not the all_reduce's."""
    sums = dict.fromkeys(("elements", "differ", "over_bound")
                         + tuple(f"differ_ratio_lt_{r:g}"
                                 for r in RATIO_DECADES), 0.0)
    maxes = dict.fromkeys(("err_over_bound", "update_diff",
                           "update_diff_uncancelled"), 0.0)
    differ = {}
    for path, g in optim.tree_leaves(grads):
        ar = zero.local_chunk(C.all_reduce(g, mean=True))
        rs = C.reduce_scatter(zero._pad_flat(g, ws)) / ws
        absum = zero.local_chunk(C.all_reduce(g.double().abs()))
        err = (rs.double() - ar.double()).abs()
        bound = order_bound(absum, ws)
        over = err > bound
        mask = rs != ar
        ratio = ar.double().abs() / torch.where(absum > 0, absum / ws, 1.0)
        sums["elements"] += ar.numel()
        sums["differ"] += float(mask.sum())
        sums["over_bound"] += float(over.sum())
        for r in RATIO_DECADES:
            sums[f"differ_ratio_lt_{r:g}"] += float((mask & (ratio < r))
                                                     .sum())
        nz = bound > 0
        if nz.any():
            maxes["err_over_bound"] = max(maxes["err_over_bound"], float(
                (err[nz] / bound[nz]).max()))
        # Adam from the same moments and param, with either grad
        new = []
        for gc in (ar, rs):
            state = optim.AdamState(
                mu={"x": zero.local_chunk(optim.tree_get(opt.mu, path))},
                nu={"x": zero.local_chunk(optim.tree_get(opt.nu, path))},
                count=opt.count)
            p = {"x": zero.local_chunk(optim.tree_get(params, path))}
            new.append(optim.adam_update({"x": gc}, state, p)[0]["x"])
        du = (new[0] - new[1]).abs()
        maxes["update_diff"] = max(maxes["update_diff"], float(du.max()))
        if (ratio >= CANCELLED).any():
            maxes["update_diff_uncancelled"] = max(
                maxes["update_diff_uncancelled"],
                float(du[ratio >= CANCELLED].max()))
        differ[path] = mask
    return {"sums": sums, "maxes": maxes, "differ": differ}


def _reduced(readings: dict, dev) -> dict:
    """Every rank's sums added and maxima taken."""
    out = {}
    for kind, op in (("sums", "sum"), ("maxes", "max")):
        keys = list(readings[kind])
        t = torch.tensor([readings[kind][k] for k in keys],
                         dtype=torch.float64, device=dev)
        out.update(zip(keys, C.all_reduce(t, op=op).tolist()))
    return out


@torch.no_grad()
def _param_diff(base, other) -> tuple[int, float]:
    """How many elements of two full param trees differ, and the largest
    difference."""
    n, worst = 0, 0.0
    for path, a in optim.tree_leaves(base):
        d = (a - optim.tree_get(other, path)).abs()
        n += int((d > 0).sum())
        worst = max(worst, float(d.max()))
    return n, worst


@torch.no_grad()
def final_drift(base, base_opt: optim.AdamState, other, touched) -> dict:
    """This rank's chunk of the final baseline-vs-``other`` param
    differences: how many differ, how many by more than ``BIG`` and
    where the baseline's grad RMS ``sqrt(v_hat)`` (Adam's denominator
    before eps) falls among ``RMS_EDGES``; the largest difference, the
    largest where ``sqrt(v_hat) >= RMS_EDGES[-1]`` and the largest where
    no step's grads differed (``touched``)."""
    big = f"params_differ_gt_{BIG:g}"
    sums = dict.fromkeys(("params_differ", big) + tuple(
        f"{big}_rms_lt_{e:g}" for e in RMS_EDGES), 0.0)
    maxes = dict.fromkeys(("max_diff", "max_diff_rms_ge",
                           "max_diff_untouched"), 0.0)
    bc2 = 1 - B2 ** base_opt.count
    for path, a in optim.tree_leaves(base):
        d = (zero.local_chunk(a)
             - zero.local_chunk(optim.tree_get(other, path))).abs()
        rms = torch.sqrt(zero.local_chunk(
            optim.tree_get(base_opt.nu, path)) / bc2)
        sums["params_differ"] += float((d > 0).sum())
        sums[big] += float((d > BIG).sum())
        for e in RMS_EDGES:
            sums[f"{big}_rms_lt_{e:g}"] += float(((d > BIG) & (rms < e))
                                                  .sum())
        for key, sel in (("max_diff", None),
                         ("max_diff_rms_ge", rms >= RMS_EDGES[-1]),
                         ("max_diff_untouched", ~touched[path])):
            x = d if sel is None else d[sel]
            if x.numel():
                maxes[key] = max(maxes[key], float(x.max()))
    return {"sums": sums, "maxes": maxes}


def run(*, scale: int = 20, num_steps: int = 6, batch_size: int = 16,
        seed: int = 42, device=None, log=print) -> dict:
    """The lockstep run on this rank.  Joins (or makes) the process group
    and leaves it up.  Returns each step's readings (``steps``), each
    leg's losses, and ``final``, :func:`final_drift` of ZeRO-2 against
    the baseline over every rank."""
    dev = mesh.init_process_group(device)
    ws, rank = mesh.axis_size(), mesh.axis_rank()
    init_params, batch = toy_problem(scale, batch_size, seed, dev)
    base = init_params()
    shapes = [{k: tuple(v.shape) for k, v in layer.items()}
              for layer in base]
    base_opt = optim.adam_init(base)
    base_step = ddp.make_ddp_train_step(
        mlp.mse_loss, lambda g, s, p: optim.adam_update(g, s, p))
    z2 = init_params()
    z2_opt = zero.init_zero_opt_state(z2)
    z2_step = zero.make_zero_train_step(mlp.mse_loss, stage=2)
    z3 = init_params()
    z3_opt = zero.init_zero_opt_state(z3)
    z3 = zero.shard_params_zero3(z3)
    z3_step = zero.make_zero3_train_step(zero.make_zero3_mlp_loss(shapes))
    if rank == 0:
        log(f"[zero_drift] world={ws} width={mlp.ZERO_TOY_SIZES[0] // scale}"
            f" batch={batch_size} steps={num_steps} device={dev}")
    touched = None
    steps = []
    for i in range(num_steps):
        _, grads = microbatch_value_and_grad(mlp.mse_loss, base,
                                             local_batch(batch), 1)
        rd = grad_orders(base, base_opt, grads, ws)
        del grads
        touched = rd["differ"] if touched is None else {
            k: touched[k] | m for k, m in rd["differ"].items()}
        base, base_opt, lb = base_step(base, base_opt, batch)
        z2, z2_opt, l2 = z2_step(z2, z2_opt, batch)
        z3, z3_opt, l3 = z3_step(z3, z3_opt, batch)
        z3_full = zero.unshard_params_zero3(z3, shapes)
        row = {"step": i, **_reduced(rd, dev),
               "loss": [float(lb), float(l2), float(l3)]}
        row["zero2_params_differ"], row["zero2_max_diff"] = _param_diff(
            base, z2)
        row["zero3_params_differ"], row["zero3_max_diff"] = _param_diff(
            base, z3_full)
        row["zero3_equals_zero2"] = _param_diff(z2, z3_full)[0] == 0
        del z3_full
        steps.append(row)
        if rank == 0:
            log(f"[zero_drift] step {i}: grads differ at "
                f"{row['differ']:.0f} of {row['elements']:.0f} elements "
                f"(ratio < 1e-2: {row['differ_ratio_lt_0.01']:.0f}, "
                f"< 1e-4: {row['differ_ratio_lt_0.0001']:.0f}, < 1e-6: "
                f"{row['differ_ratio_lt_1e-06']:.0f}); largest |rs - ar| "
                f"{row['err_over_bound']:.3g} of the order bound, "
                f"{row['over_bound']:.0f} beyond it; Adam update diff "
                f"{row['update_diff']:.3e} (ratio >= {CANCELLED:g}: "
                f"{row['update_diff_uncancelled']:.3e}); params differ "
                f"after the step: zero2 {row['zero2_params_differ']} "
                f"(max {row['zero2_max_diff']:.3e}), zero3 "
                f"{row['zero3_params_differ']} (max "
                f"{row['zero3_max_diff']:.3e}), zero3 == zero2 "
                f"{row['zero3_equals_zero2']}; losses {row['loss']}")
    fin = final_drift(base, base_opt, z2, touched)
    final = _reduced(fin, dev)
    if rank == 0:
        big = f"params_differ_gt_{BIG:g}"
        log(f"[zero_drift] final: {final['params_differ']:.0f} params "
            f"differ, largest {final['max_diff']:.3e}; "
            f"{final[big]:.0f} by more than {BIG:g}, of which the baseline's "
            f"grad RMS sqrt(v_hat) is below "
            + ", ".join(f"{e:g}: {final[f'{big}_rms_lt_{e:g}']:.0f}"
                        for e in RMS_EDGES)
            + f"; largest difference where sqrt(v_hat) >= {RMS_EDGES[-1]:g}:"
            f" {final['max_diff_rms_ge']:.3e}, where no step's grads "
            f"differed: {final['max_diff_untouched']:.3e}")
    return {"world_size": ws, "scale": scale, "batch_size": batch_size,
            "device": str(dev), "steps": steps, "final": final}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scale", type=int, default=20,
                   help="divide the 10k toy width by this")
    p.add_argument("--num-steps", type=int, default=6)
    p.add_argument("--batch-size", type=int, default=16,
                   help="the global batch")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="default: the CUDA card (NCCL); 'cpu' for gloo")
    p.add_argument("--out", default=None, help="rank 0 writes the result "
                                               "as JSON")
    args = p.parse_args(argv)
    try:
        res = run(scale=args.scale, num_steps=args.num_steps,
                  batch_size=args.batch_size, seed=args.seed,
                  device=args.device)
        if args.out and mesh.axis_rank() == 0:
            Path(args.out).write_text(json.dumps(res))
    finally:
        mesh.destroy_process_group()
    beyond = sum(s["over_bound"] for s in res["steps"])
    if beyond:
        raise SystemExit(f"{beyond:.0f} grad elements beyond the "
                         "summation-order bound")
    apart = [s["step"] for s in res["steps"] if not s["zero3_equals_zero2"]]
    if apart:
        raise SystemExit(f"ZeRO-3's params differ from ZeRO-2's after "
                         f"steps {apart}")


if __name__ == "__main__":
    main()

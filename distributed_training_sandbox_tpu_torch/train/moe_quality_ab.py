"""MoE quality A/B at matched wall-clock: the twin of the JAX package's
``scripts/moe_quality_ab.py``.

    python -m distributed_training_sandbox_tpu_torch.train.moe_quality_ab \\
        --seconds 420
    python -m distributed_training_sandbox_tpu_torch.train.moe_quality_ab \\
        --device cpu --tiny --seconds 3

Three legs, dense and MoE at each ``--capacity-factors`` (2.0, 1.0: 8
experts × ``moe_ffn`` 2752 over SmolLM3-3B-L8, the dense MLP's FLOPs
split 4 ways active, grouped dispatch), each trained for the same
``--seconds`` of train time on the same seeded batch stream (the native
engine's synthetic windows, or ``--data corpus``) under the same
warmup-cosine schedule, through the FSDP step at one rank.  Every step
logs its loss and the train clock; a fixed held-out batch (the stream's
last 8 windows) is scored every ``--eval-every`` steps, off the clock,
as is the MoE legs' drop-rate trajectory: ``parallel.expert.
grouped_drop_fraction`` on the live router's assignments, every layer's
(``_mlp_drop_tap`` puts each layer's drop fraction in ``_mlp_block``'s
aux slot for one forward, as the reference's tap does), averaged over
the layers.  Step 0 (kernel builds, allocator warm-up) is off the clock.

Writes ``moe_results/quality_ab_<platform>[_<tag>].json`` (``gpu`` or
``cpu``; the reference's ``*_tpu*.json`` stay as they are): the
verdict, each leg's eval loss at matched wall-clock against the dense
leg's, and the legs' series; and the plot (loss against the train
clock, the held-out loss and the drop rate against the step) to
``--plot``, where matplotlib is installed (the twin says so where it is
not).  ``--tiny``: TINY_LM, seq 128, batch 4, 4 experts of width 40.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
from pathlib import Path

import torch

from ..data import make_packed_dataset
from ..data.packing import CORPUS_DOCS, CORPUS_TOKENIZER
from ..device import resolve_device
from ..models import MODEL_REGISTRY
from ..models import transformer as T
from ..parallel import expert as E
from ..parallel import fsdp, optim
from .busbench import card_line

SEED = 42
EVAL_WINDOWS = 8


def _base_moe() -> dict:
    M = T.SMOLLM3_3B_L8_MOE
    return {"n_experts": M.n_experts, "moe_ffn": M.moe_ffn,
            "moe_dispatch": M.moe_dispatch}


@contextlib.contextmanager
def _mlp_drop_tap():
    """While open, ``transformer._mlp_block`` returns, in its aux slot,
    the grouped dispatch's drop fraction of the layer's live routing
    (``expert._route_topk`` and ``expert.grouped_drop_fraction``, the
    rule the train step enforces)."""
    orig = T._mlp_block

    def with_drop(r, layer, *, cfg):
        mlp, _lb = orig(r, layer, cfg=cfg)
        B, S, H = r.shape
        _, experts, _ = E._route_topk(r.reshape(B * S, H), layer["w_router"],
                                      cfg.moe_top_k)
        drop = E.grouped_drop_fraction(experts, cfg.n_experts,
                                       cfg.moe_group_size,
                                       cfg.moe_capacity_factor)
        return mlp, drop

    T._mlp_block = with_drop
    try:
        yield
    finally:
        T._mlp_block = orig


@torch.no_grad()
def drop_rate(params, ids, cfg) -> float:
    """The layers' mean drop fraction on ``ids``."""
    with _mlp_drop_tap():
        _, drop = T.hidden_states(params, ids, cfg, return_aux=True)
    return float(drop) / cfg.num_hidden_layers


@torch.no_grad()
def eval_loss(params, batch, cfg) -> float:
    return float(T.lm_loss(params, batch, cfg))


def run_leg(name: str, cfg_overrides: dict, seconds: float, seq: int,
            bs: int, peak_lr: float, warmup: int, eval_every: int, data,
            eval_batch, *, base: str = "SMOLLM3_3B_L8", device=None,
            log=print) -> dict:
    """Train one leg for ``seconds`` of train time; the reference's leg
    record."""
    dev = resolve_device(device)
    over = dict(cfg_overrides)
    over.setdefault("attention_impl",
                    "flash" if dev.type == "cuda" else "xla")
    mcfg = dataclasses.replace(getattr(T, base), **over)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shards = fsdp.shard_params_fsdp(T.init_params(mcfg, gen, dev))
    opt = fsdp.init_fsdp_opt_state(shards)
    # a long horizon: the decay is flat across legs; the warmup matters
    sched = optim.warmup_cosine_schedule(peak_lr, warmup, 100_000)
    step = fsdp.make_fsdp_train_step(shards, mcfg, lr=peak_lr,
                                     lr_schedule=sched)
    ev = tuple(torch.as_tensor(a, device=dev) for a in eval_batch)
    ii, ll = data
    n = len(ii) // bs
    losses, times, evals, drops = [], [], [], []
    i, train_s = 0, 0.0
    while True:
        j = i % n
        batch = (torch.as_tensor(ii[j * bs:(j + 1) * bs], device=dev),
                 torch.as_tensor(ll[j * bs:(j + 1) * bs], device=dev))
        if mcfg.n_experts and i % eval_every == 0:
            drops.append((i, drop_rate(shards, batch[0], mcfg)))
        if i % eval_every == 0:
            evals.append((i, eval_loss(shards, ev, mcfg), train_s))
        t0 = time.perf_counter()
        shards, opt, loss = step(shards, opt, batch)
        losses.append(float(loss))        # the host sync closes the step
        if i > 0:                         # step 0 off the clock
            train_s += time.perf_counter() - t0
        times.append(train_s)
        i += 1
        if train_s > seconds:
            break
        if i % 25 == 0:
            log(f"[moe-ab:{name}] step {i:4d} loss {losses[-1]:7.4f} "
                f"t {train_s:5.0f}s"
                + (f" drop {drops[-1][1]:.3f}" if drops else ""))
    final_eval = eval_loss(shards, ev, mcfg)
    tok_s = (len(losses) - 1) * bs * seq / train_s if train_s else 0.0
    log(f"[moe-ab:{name}] done: {len(losses)} steps, {tok_s:.0f} tok/s, "
        f"final eval {final_eval:.4f}")
    del shards, opt, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {
        "name": name,
        "config": {k: (v if isinstance(v, (int, float, str, bool,
                                           type(None))) else str(v))
                   for k, v in cfg_overrides.items()},
        "seq": seq, "batch": bs,
        "seconds": times[-1], "steps": len(losses),
        "tokens_per_second": round(tok_s, 1),
        "final_eval_loss": final_eval,
        "losses": losses, "times": times,
        "evals": evals, "drop_trajectory": drops,
    }


def plot(out: dict, path) -> Path | None:
    """The reference's three panels; None (and a line saying so) where
    matplotlib is missing."""
    try:
        import matplotlib
    except ImportError:
        print("[moe-ab] matplotlib is not installed: wrote no plot (the "
              "JSON stays)", flush=True)
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (a1, a2, a3) = plt.subplots(1, 3, figsize=(15, 4))
    for leg in out["legs"]:
        a1.plot(leg["times"], leg["losses"], lw=0.7, label=leg["name"])
        a2.plot([e[0] for e in leg["evals"]], [e[1] for e in leg["evals"]],
                marker="o", ms=2, label=leg["name"])
        if leg["drop_trajectory"]:
            a3.plot([d[0] for d in leg["drop_trajectory"]],
                    [d[1] for d in leg["drop_trajectory"]], marker="o",
                    ms=2, label=leg["name"])
    a1.set_xlabel("train clock s (step 0 off it)")
    a1.set_ylabel("train loss")
    a1.set_title("loss vs wall-clock (matched budget)")
    a2.set_xlabel("step")
    a2.set_title("held-out eval loss")
    a3.set_xlabel("step")
    a3.set_ylabel("drop fraction")
    a3.set_title("dispatch drop rate as router trains")
    for a in (a1, a2, a3):
        a.legend(fontsize=7)
    fig.tight_layout()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    print(f"[moe-ab] plot -> {path}", flush=True)
    return path


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seconds", type=float, default=420.0)
    p.add_argument("--sequence-length", type=int, default=8192)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--peak-lr", type=float, default=3e-4)
    p.add_argument("--warmup-steps", type=int, default=30)
    p.add_argument("--eval-every", type=int, default=20)
    p.add_argument("--aux-weight", type=float, default=0.01,
                   help="the MoE legs' load-balance weight")
    p.add_argument("--z-weight", type=float, default=0.0,
                   help="router z-loss weight (ST-MoE)")
    p.add_argument("--router-lr-mult", type=float, default=1.0,
                   help="learning-rate multiplier on the w_router leaves")
    p.add_argument("--capacity-factors", type=float, nargs="+",
                   default=[2.0, 1.0], help="one MoE leg a capacity factor")
    p.add_argument("--top-k", type=int, default=1,
                   help="experts a token (2: GShard top-2)")
    p.add_argument("--dense-from", default=None,
                   help="with --skip-dense: the JSON to read the dense "
                        "baseline's eval from (default: the untagged "
                        "quality_ab_<platform>.json)")
    p.add_argument("--data", choices=["synthetic", "corpus"],
                   default="synthetic",
                   help="'corpus': the committed corpus (vocab 8192; pair "
                        "with --geometry corpus-70m)")
    p.add_argument("--geometry", default=None,
                   help="the base geometry's registry name (default the "
                        "SmolLM3-3B-L8 flagship)")
    p.add_argument("--tag", default="",
                   help="suffix for the output JSON and plot")
    p.add_argument("--skip-dense", action="store_true",
                   help="reuse an earlier run's dense leg")
    p.add_argument("--tiny", action="store_true",
                   help="TINY_LM geometry, seq 128, batch 4")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (the plain path)")
    p.add_argument("--out-dir", default="moe_results")
    p.add_argument("--plot", default="plots/moe_quality_ab.png")
    args = p.parse_args(argv)
    if args.skip_dense and not args.tag:
        raise SystemExit("--skip-dense needs --tag: without one the output "
                         "would overwrite the file the dense baseline is "
                         "read from")
    dev = resolve_device(args.device)
    platform = "gpu" if dev.type == "cuda" else dev.type

    seq, bs = args.sequence_length, args.batch_size
    base = MODEL_REGISTRY[args.geometry] if args.geometry else "SMOLLM3_3B_L8"
    moe = _base_moe()
    if base == "CORPUS_LM":
        # the expert width scales with the geometry: the dense ffn / 4
        moe = {**moe, "moe_ffn": T.CORPUS_LM.intermediate_size // 4}
    tiny_over = {}
    if args.tiny:
        seq, bs = 128, 4
        tiny_over = {f.name: getattr(T.TINY_LM, f.name)
                     for f in dataclasses.fields(T.TINY_LM)}
        moe = {**_base_moe(), "n_experts": 4, "moe_ffn": 40}
    vocab = (tiny_over or {"vocab_size": getattr(T, base).vocab_size}
             )["vocab_size"]
    if args.data == "corpus":
        ii, ll = make_packed_dataset(seq, vocab, source="corpus",
                                     corpus_path=CORPUS_DOCS,
                                     tokenizer_file=CORPUS_TOKENIZER)
        print(f"[moe-ab] corpus: {len(ii)} windows of seq {seq}", flush=True)
    else:
        # ~400 steps of fresh windows, looped if a leg outruns them
        n_tok = (400 * bs + EVAL_WINDOWS) * (seq + 1)
        ii, ll = make_packed_dataset(seq, vocab, num_tokens=n_tok,
                                     source="synthetic", engine="native")
    eval_batch = (ii[-EVAL_WINDOWS:], ll[-EVAL_WINDOWS:])
    data = (ii[:-EVAL_WINDOWS], ll[:-EVAL_WINDOWS])

    def with_tiny(over):
        return {**tiny_over, **over} if args.tiny else over

    aw, zw, rlm = args.aux_weight, args.z_weight, args.router_lr_mult
    health_tag = (("" if aw == 0.01 else f"_aux{aw:g}")
                  + (f"_z{zw:g}" if zw else "")
                  + (f"_rlm{rlm:g}" if rlm != 1.0 else "")
                  + (f"_top{args.top_k}" if args.top_k != 1 else ""))
    health = {"moe_aux_weight": aw, "moe_router_z_weight": zw,
              "moe_router_lr_mult": rlm, "moe_top_k": args.top_k}
    leg_list = [] if args.skip_dense else [("dense", {})]
    leg_list += [(f"moe_cf{cf:g}{health_tag}",
                  {**moe, "moe_capacity_factor": cf, **health})
                 for cf in args.capacity_factors]
    legs = [run_leg(name, with_tiny(over), args.seconds, seq, bs,
                    args.peak_lr, args.warmup_steps, args.eval_every, data,
                    eval_batch, base=base, device=dev,
                    log=lambda m: print(m, flush=True))
            for name, over in leg_list]

    if args.skip_dense:
        prior = (Path(args.dense_from) if args.dense_from else
                 Path(args.out_dir) / f"quality_ab_{platform}.json")
        dense_eval = (json.loads(prior.read_text())["verdict"]["dense"][
            "final_eval_loss"] if prior.exists() else float("nan"))
    else:
        dense_eval = legs[0]["final_eval_loss"]
    out = {
        "platform": platform,
        "card": card_line() if dev.type == "cuda" else None,
        "seconds_budget": args.seconds,
        "verdict": {
            leg["name"]: {
                "final_eval_loss": leg["final_eval_loss"],
                "delta_vs_dense": round(leg["final_eval_loss"]
                                        - dense_eval, 4),
                "tokens_per_second": leg["tokens_per_second"],
                "final_drop_rate": (leg["drop_trajectory"][-1][1]
                                    if leg["drop_trajectory"] else None),
            } for leg in legs},
        "legs": legs,
    }
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"_{args.tag}" if args.tag else ""
    path = out_dir / f"quality_ab_{platform}{tag}.json"
    path.write_text(json.dumps(out))
    print(f"[moe-ab] verdict: {json.dumps(out['verdict'], indent=1)}")
    print(f"[moe-ab] -> {path}", flush=True)
    plot_path = Path(args.plot)
    if tag:
        plot_path = plot_path.with_name(plot_path.stem + tag
                                        + plot_path.suffix)
    plot(out, plot_path)
    return out


if __name__ == "__main__":
    main()

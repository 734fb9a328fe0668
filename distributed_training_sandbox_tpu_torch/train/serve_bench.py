"""Serving benchmark: Poisson traffic through the continuous-batching
engine or a fleet of engine replicas, with the latency-SLO report — the
twin of the JAX package's ``scripts/serve_bench.py``.

    python -m distributed_training_sandbox_tpu_torch.train.serve_bench \\
        --model SMOLLM3_3B --requests 16 --tenants 2 --prefix-cache \\
        --spec-k 3 --draft-layers 4
    python -m distributed_training_sandbox_tpu_torch.train.serve_bench \\
        --device cpu --tenants 3 --overlap-frac 0.7 --prefix-cache
    python -m distributed_training_sandbox_tpu_torch.train.serve_bench \\
        --device cpu --replicas 2 --inject-fault kill_replica@2:1
    python -m distributed_training_sandbox_tpu_torch.train.serve_bench \\
        --device cpu --requests 8 --disaggregate
    torchrun --nproc-per-node 2 -m \\
        distributed_training_sandbox_tpu_torch.train.serve_bench \\
        --device cpu --tp 2

Drives ``serving.ServingEngine`` with the seeded open-loop trace of
``serving.traces.build_trace`` (exponential inter-arrivals at
``--rate``, bimodal prompt lengths; with ``--tenants N`` an
``--overlap-frac`` share of the requests opens with one of N shared
``--sys-len`` system prompts) and files the engine's SLO report under
the run directory's ``summary.json`` ``serving`` key; per-request TTFT
and per-burst latency stream into ``steps.jsonl``.  The weights are the
port's seeded ``init_params`` scaled by ``--param-scale`` (×3 makes the
greedy trajectories chaotic, so the parity check discriminates).

``--replicas N`` (N >= 2) drives a ``serving.Fleet`` instead: N
replicas behind SLO-driven admission control (``--max-queue``,
``--burst-ms``, ``--deadline-ms``: structured rejections; a
``queue_full`` shed pushes the driver's later arrivals back by one
modeled burst), failover (``--inject-fault kill_replica@N:k`` /
``hang_decode@N:k`` / ``slow_replica@N:ms`` under
``--watchdog-timeout``) and zero-drop weight hot-swap (``--swap-at K``
[+ ``--swap-ckpt DIR``; by default a seed+1 init saved to a temporary
directory]; ``corrupt_swap`` tears it).  Its report goes under
``summary.json``'s ``fleet`` key.  By default replica ``i`` serves on
``cuda:i·stride``; ``--device cuda:0`` puts every replica on one card.
``--tp N`` serves tensor-parallel over a dp × tp grid of the process
group (run under ``torchrun``; one process a rank).  ``--disaggregate``
prefills on one device and decodes on another (``--device P,D``; by
default ``cuda:0,cuda:1``, the CPU's pair under ``--device cpu``).

Routes.  On the card the engine serves with ``paged_kernel=True`` (K1,
or K2 on an int8 pool) and, unless ``--kv-quant``, with
``flash_prefill`` (K3: batched prefill, the draft's and the verify's
block): the plain routes are the kernels' plain versions, which the
card's main path never takes.  On the CPU every route is the plain one
and ``--flash-prefill`` picks the batched prefill, as in the reference.

Gates (exit 1): every request completed (the fleet: none dropped, and
completed + shed = offered), and ``--check-parity N``, the first N
requests against the port's one-shot ``generate`` at the engine's
``view_capacity`` (the fleet's only when no swap changed the weights):
on the CPU their tokens bit for bit (the reference's law); on the card,
and over tp > 1 ranks, where the kernels or the rejoins sum in other
orders than ``generate``'s plain path, every emitted token, the first
included, within ``FRONTIER_ARGMAX_ATOL`` of its row's maximum logit
when prompt and emitted tokens are teacher-forced through
``generate``'s cached forward (:func:`argmax_gaps`); the first tokens
equal to ``generate``'s are counted, not gated (K3's prefill flips a
near-tie of ``generate``'s now and then).  The reference's other gate,
no jit-cache growth after warm-up, has no counterpart: PyTorch runs
eagerly and nothing retraces, so the twin omits it.

Refused (exit 2): ``--export-timeline`` (the report tooling,
``scripts/export_timeline.py``: ROADMAP.md queue A item A8), ``--plan``
(the tuner, item A12), the fleet's flags without ``--replicas`` >= 2,
and ``--tp`` / ``--disaggregate`` inside a fleet's replicas, as in the
reference.  The reference's ``--cpu-devices`` (a simulated JAX mesh)
has no counterpart; ``--device cpu`` runs the plain path.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile

import numpy as np
import torch

from ..device import resolve_device
from ..models import MODEL_REGISTRY
from ..models import transformer as T
from ..models.generate import _hidden_cached, _unembed, generate, init_cache
from ..serving import Fleet, Rejection, ServingEngine
from ..serving.traces import build_trace
from ..telemetry.run import A12, TelemetryRun
from ..utils import mesh
from ..utils.profiling import ProfileSchedule, Profiler

# Every emitted token's teacher-forced logit lies within this of its
# row's maximum (the card's parity law, :func:`argmax_gaps`): the largest
# difference between K3's prefill logits and the plain path's that the
# chip smoke admits (its PREFILL_LOGIT_ATOL).  On an H100 the sound
# frontier reads 0.0-1.75 and its mutants 20.19-53.0 (chip_smoke.py phase
# 18, chip_gate_mutation.py; PERF.md §6).
FRONTIER_ARGMAX_ATOL = 3.5

SERVE_SCHEDULE = ProfileSchedule(skip_first=2, wait=1, warmup=2, active=8)


def model_config(name: str) -> T.TransformerConfig:
    """A config by the reference's attribute name (``TINY_LM``,
    ``SMOLLM3_3B``) or the port's CLI name (``tiny``, ``smollm3-3b``)."""
    cfg = getattr(T, MODEL_REGISTRY.get(name, name), None)
    if not isinstance(cfg, T.TransformerConfig):
        raise ValueError(f"unknown model {name!r}")
    return cfg


def build_params(cfg, seed: int, scale: float, device) -> dict:
    """The port's seeded ``init_params`` on ``device``, every leaf
    multiplied by ``scale`` in place."""
    dev = torch.device(device)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           dev)
    if scale != 1.0:
        for leaf in [params["embed"], params["final_norm"],
                     *params["layers"].values(),
                     *([params["lm_head"]] if "lm_head" in params else [])]:
            leaf.mul_(scale)
    return params


@torch.no_grad()
def argmax_gaps(params, cfg, prompt, tokens, *, capacity: int,
                kv_quant: bool = False) -> torch.Tensor:
    """Teacher-force ``prompt`` and the emitted ``tokens`` through the
    one-shot ``generate``'s cached forward in one pass; for each emitted
    token, its row's maximum logit minus the token's logit (0 where the
    token is the argmax).  The row predicting ``tokens[j]`` is the one
    at position ``len(prompt) - 1 + j``.  Returns f32 (len(tokens),) on
    the params' device."""
    dev = params["embed"].device
    ids = np.concatenate([np.asarray(prompt, np.int64),
                          np.asarray(tokens[:-1], np.int64)])
    cache = init_cache(cfg, 1, capacity, device=dev, quantized=kv_quant)
    x = _hidden_cached(params, torch.as_tensor(ids[None], device=dev), cfg,
                       cache, 0)
    n = len(tokens)
    logits = _unembed(params, x[:, -n:], cfg)[0]
    tok = torch.as_tensor(np.asarray(tokens, np.int64), device=dev)
    return logits.max(dim=-1).values - logits.gather(1, tok[:, None])[:, 0]


def check_parity(params, cfg, reqs, *, capacity: int, kv_quant: bool,
                 exact: bool) -> tuple[list[str], dict]:
    """The parity gate on ``reqs`` (see the module docstring): bitwise
    against ``generate`` when ``exact``, else first tokens equal and the
    near-argmax law.  Returns (failures, readings)."""
    failures, firsts, gaps = [], [], []
    for req in reqs:
        got = np.asarray(req.tokens, np.int64)
        if exact:
            ref = generate(params, req.prompt[None], cfg,
                           max_new_tokens=req.max_new_tokens,
                           kv_quant=kv_quant, cache_capacity=capacity,
                           device=params["embed"].device)[0].cpu().numpy()
            if got.shape != ref.shape or not (got == ref).all():
                failures.append(
                    f"rid {req.rid}: tokens diverge from one-shot generate "
                    f"(got {got.tolist()[:8]}..., ref {ref.tolist()[:8]}...)")
            continue
        # the first token is gated by the near-argmax law with the rest:
        # K3's prefill and generate's plain one differ in their last bits,
        # which flips a near-tie (a 0.625-logit gap on an H100; PERF.md)
        ref0 = int(generate(params, req.prompt[None], cfg, max_new_tokens=1,
                            kv_quant=kv_quant, cache_capacity=capacity,
                            device=params["embed"].device)[0, 0])
        firsts.append((int(got[0]), ref0))
        gaps.append(argmax_gaps(params, cfg, req.prompt, got,
                                capacity=capacity, kv_quant=kv_quant).cpu())
    if exact:
        return failures, {"checked": len(reqs), "exact": True}
    g = torch.cat(gaps) if gaps else torch.zeros(0)
    worst = float(g.max()) if g.numel() else 0.0
    read = {"checked": len(reqs), "exact": False, "first_tokens": firsts,
            "first_tokens_equal": sum(a == b for a, b in firsts),
            "tokens": int(g.numel()), "argmax_tokens": int((g == 0).sum()),
            "max_gap": worst, "atol": FRONTIER_ARGMAX_ATOL}
    if not worst <= FRONTIER_ARGMAX_ATOL:
        failures.append(f"near-argmax law: an emitted token's logit lies "
                        f"{worst} under its row's maximum, over "
                        f"{FRONTIER_ARGMAX_ATOL}")
    return failures, read


def _refusal(args) -> str | None:
    if args.export_timeline:
        return ("--export-timeline is not ported yet: the timeline export "
                "(scripts/export_timeline.py) is the report tooling of "
                "ROADMAP.md queue A item A8")
    if args.plan is not None:
        return f"--plan is not ported yet: the tuner is {A12}"
    if args.replicas > 1:
        if args.tp > 1 or args.disaggregate:
            return ("--replicas composes whole-engine device slices; "
                    "--tp/--disaggregate inside a replica is not wired "
                    "yet")
        return None
    for flag, name in ((args.inject_fault, "--inject-fault"),
                       (args.deadline_ms, "--deadline-ms"),
                       (args.swap_at, "--swap-at")):
        if flag is not None:
            return f"{name} needs --replicas >= 2"
    if args.tp > 1 and args.disaggregate:
        return ("disaggregate splits devices into single-program slices; "
                "drop --tp")
    return None


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Poisson traffic through the serving runtime + SLO "
                    "report")
    p.add_argument("--model", default="TINY_LM")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (the plain path); with "
                        "--disaggregate a PREFILL,DECODE pair")
    p.add_argument("--requests", type=int, default=64)
    p.add_argument("--rate", type=float, default=16.0,
                   help="mean arrival rate, requests/s (default 16)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--page-size", type=int, default=8)
    p.add_argument("--max-seq-len", type=int, default=80)
    p.add_argument("--prefill-chunk", type=int, default=16)
    p.add_argument("--sync-every", type=int, default=4)
    p.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel degree (0 = one program; N "
                        "shards heads over a dp × tp grid of the process "
                        "group, under torchrun)")
    p.add_argument("--kv-quant", action="store_true",
                   help="int8 paged KV pool (+f32 row scales)")
    p.add_argument("--disaggregate", action="store_true",
                   help="prefill and decode on separate devices with the "
                        "page-row KV handoff")
    p.add_argument("--prefix-cache", action="store_true",
                   help="radix prefix cache over KV pages")
    p.add_argument("--spec-k", type=int, default=0,
                   help="speculative decoding: K draft proposals a "
                        "macro-step, one (B, K+1) verify (0 = off)")
    p.add_argument("--draft-layers", type=int, default=1,
                   help="draft depth for --spec-k: the target's first N "
                        "layers")
    p.add_argument("--flash-prefill", action="store_true",
                   help="batched multi-request prefill (on the card it is "
                        "on unless --kv-quant)")
    p.add_argument("--tenants", type=int, default=0,
                   help="tenant-skewed trace: N tenants with shared "
                        "system prompts (0 = plain bimodal trace)")
    p.add_argument("--overlap-frac", type=float, default=0.6,
                   help="share of requests opening with a tenant's system "
                        "prompt (needs --tenants)")
    p.add_argument("--sys-len", type=int, default=16,
                   help="shared system-prompt length for --tenants")
    p.add_argument("--hbm-budget-gb", type=float, default=None,
                   help="cap the pool through the capacity planner "
                        "(serving.accounting.pool_capacity_pages)")
    p.add_argument("--param-scale", type=float, default=3.0)
    p.add_argument("--check-parity", type=int, default=4, metavar="N",
                   help="hold the first N requests against one-shot "
                        "generate (0 disables)")
    p.add_argument("--profile", action="store_true",
                   help="torch.profiler window over the run's early "
                        "rounds (utils.profiling.Profiler)")
    p.add_argument("--trace-dir", default="profiler_traces")
    p.add_argument("--results-dir", default=None,
                   help="where the run directory goes (default RESULTS_DIR "
                        "or ./runs)")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve live Prometheus metrics on this port for "
                        "the run (0 = an ephemeral port)")
    p.add_argument("--replicas", type=int, default=1,
                   help="serve through a Fleet of N engine replicas "
                        "(failover, admission control, hot-swap; 1 = one "
                        "engine)")
    p.add_argument("--inject-fault", default=None, metavar="SPEC",
                   help="serving fault: kill_replica@N:k / "
                        "hang_decode@N:k / slow_replica@N:ms / "
                        "corrupt_swap (needs --replicas >= 2)")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="per-request TTFT deadline; arrivals whose modeled "
                        "TTFT exceeds it are shed at submit")
    p.add_argument("--swap-at", type=int, default=None, metavar="K",
                   help="hot-swap weights after K completed requests "
                        "(zero-drop drain, one replica at a time)")
    p.add_argument("--swap-ckpt", default=None, metavar="DIR",
                   help="checkpoint directory for --swap-at (default: a "
                        "seed+1 init saved to a temporary directory)")
    p.add_argument("--watchdog-timeout", type=float, default=5.0,
                   help="per-replica decode watchdog budget, seconds (a "
                        "wedged burst becomes a failover)")
    p.add_argument("--max-queue", type=int, default=8,
                   help="admission bound on the modeled waiting line; "
                        "deeper arrivals are shed queue_full")
    p.add_argument("--burst-ms", type=float, default=50.0,
                   help="the admission controller's per-burst latency "
                        "prior (EWMA-calibrated as bursts complete)")
    # refused: the timeline export (A8) and the tuner (A12)
    p.add_argument("--export-timeline", action="store_true")
    p.add_argument("--plan", default=None)
    return p.parse_args(argv)


def _routes(args, card: bool) -> dict:
    """The engine's kernel flags (module docstring, Routes)."""
    return {"paged_kernel": card,
            "flash_prefill": (not args.kv_quant) if card
            else args.flash_prefill}


def _engine_kwargs(args, card: bool) -> dict:
    return dict(max_batch=args.max_batch, page_size=args.page_size,
                max_seq_len=args.max_seq_len,
                prefill_chunk=args.prefill_chunk,
                sync_every=args.sync_every, kv_quant=args.kv_quant,
                hbm_budget_gb=args.hbm_budget_gb,
                prefix_cache=args.prefix_cache, spec_k=args.spec_k,
                draft_layers=args.draft_layers if args.spec_k else None,
                **_routes(args, card))


def _trace(args, cfg):
    rng = np.random.default_rng(args.seed)
    return build_trace(rng, args.requests, args.rate, cfg.vocab_size,
                       args.max_seq_len, tenants=args.tenants,
                       overlap_frac=args.overlap_frac, sys_len=args.sys_len)


def _profiler(args):
    # serving has no fixed step count: trace a window early enough to
    # catch steady decode bursts
    if not args.profile:
        return None
    return Profiler(trace_dir=args.trace_dir, schedule=SERVE_SCHEDULE)


def _parity(params, cfg, reqs, args, capacity, exact) -> tuple[list, dict]:
    checked = reqs[:args.check_parity]
    fails, parity = check_parity(params, cfg, checked, capacity=capacity,
                                 kv_quant=args.kv_quant, exact=exact)
    if checked:
        law = "bitwise" if exact else "first tokens, near-argmax"
        print(f"[serve] parity vs generate ({law}): {json.dumps(parity)}",
              flush=True)
    return fails, parity


def _placement(args):
    """``(engine device, params device, grid)``: the rank's device and a
    dp × tp grid under ``--tp``, the (prefill, decode) pair under
    ``--disaggregate``, else ``--device``."""
    if args.tp > 1:
        dev = mesh.init_process_group(args.device)
        world = torch.distributed.get_world_size()
        if world % args.tp:
            raise ValueError(f"{world} ranks not divisible by tp={args.tp} "
                             f"(run under torchrun --nproc-per-node N)")
        return None, dev, mesh.grid_axes(("dp", "tp"),
                                         (world // args.tp, args.tp))
    names = (args.device or "").split(",")
    if args.disaggregate:
        if len(names) == 2:
            pair = tuple(resolve_device(n) for n in names)
        elif args.device is not None:
            pair = (resolve_device(args.device),) * 2
        else:
            pair = None            # the engine's cuda:0, cuda:1
        return pair, pair[1] if pair else resolve_device("cuda:1"), None
    if len(names) > 1:
        raise ValueError(f"--device {args.device}: a device pair needs "
                         f"--disaggregate")
    dev = resolve_device(args.device)
    return dev, dev, None


def main(argv=None) -> int:
    args = parse_args(argv)
    refused = _refusal(args)
    if refused is not None:
        print(f"[serve] {refused}", file=sys.stderr)
        return 2
    if args.replicas > 1:
        return _fleet_main(args)
    try:
        device, dev, grid = _placement(args)
    except ValueError as e:
        print(f"[serve] {e}", file=sys.stderr)
        mesh.destroy_process_group()
        return 2
    try:
        return _engine_main(args, device, dev, grid)
    finally:
        if grid is not None:
            mesh.destroy_process_group()


def _engine_main(args, device, dev, grid) -> int:
    card = dev.type == "cuda"
    cfg = model_config(args.model)
    params = build_params(cfg, args.seed, args.param_scale, dev)
    trace = _trace(args, cfg)
    routes = _routes(args, card)
    run_cfg = {"num_steps": 0, "batch_size": args.max_batch,
               "sequence_length": args.max_seq_len, "seed": args.seed,
               "requests": args.requests, "rate": args.rate,
               "page_size": args.page_size, "tp": args.tp,
               "kv_quant": args.kv_quant, "disaggregate": args.disaggregate,
               "prefix_cache": args.prefix_cache, "spec_k": args.spec_k,
               "draft_layers": args.draft_layers if args.spec_k else None,
               "tenants": args.tenants,
               "overlap_frac": args.overlap_frac if args.tenants else None,
               **routes}
    failures = []
    with TelemetryRun("serving", model=args.model, config=run_cfg,
                      device=dev, profiler=_profiler(args),
                      results_dir=args.results_dir,
                      metrics_port=args.metrics_port) as telem:
        if telem.metrics_server is not None:
            print(f"[serve] metrics: {telem.metrics_server.url}", flush=True)
        eng = ServingEngine(params, cfg, mesh=grid, device=device,
                            disaggregate=args.disaggregate, telem=telem,
                            **_engine_kwargs(args, card))
        reqs = [eng.submit(prompt, max_new_tokens=new, arrival_s=t)
                for t, prompt, new in trace]
        eng.run()
        slo = eng.slo_report()
        print(f"[serve] {slo['completed']}/{slo['requests']} requests on "
              f"{slo['device']}, TTFT p50 {slo['ttft_ms']['p50']} ms p99 "
              f"{slo['ttft_ms']['p99']} ms, per-token p50 "
              f"{slo['per_token_ms']['p50']} ms, {slo['tokens_per_s']} "
              f"tok/s ({slo['tokens_per_s_per_device']}/device)",
              flush=True)
        if "prefix_cache" in slo:
            pc = slo["prefix_cache"]
            print(f"[serve] prefix cache: hit rate {pc['hit_rate']} "
                  f"({pc['hit_pages']}/{pc['lookup_pages']} pages), "
                  f"{pc['evictions']} evictions", flush=True)
        if "speculative" in slo:
            sp = slo["speculative"]
            print(f"[serve] speculative k={sp['k']}: acceptance "
                  f"{sp['acceptance_rate']} ({sp['accepted']}/"
                  f"{sp['proposed']}), "
                  f"{slo['scheduler']['decode_steps_per_token']} decode "
                  f"steps/token", flush=True)
        if "handoff" in slo:
            print(f"[serve] handoff: {json.dumps(slo['handoff'])}",
                  flush=True)
        if slo["completed"] != args.requests:
            failures.append(f"only {slo['completed']}/{args.requests} "
                            f"requests completed")
        fails, parity = _parity(params, cfg, reqs, args, eng.view_capacity,
                                exact=not card and args.tp <= 1)
        failures += fails
        slo["parity_checked"] = parity["checked"]
        slo["parity"] = parity
        if card:
            slo["peak_memory_gib"] = _peaks({eng._prefill_dev,
                                             eng.device})
        slo["failures"] = failures
        telem.finalize(serving=slo)

    print(json.dumps(slo, indent=1))
    for f in failures:
        print(f"[serve] FAIL: {f}", file=sys.stderr, flush=True)
    return 1 if failures else 0


def _peaks(devices) -> dict:
    """Each card's peak allocated memory in the run, GiB."""
    return {str(d): torch.cuda.max_memory_allocated(d) / 2 ** 30
            for d in sorted(devices, key=str)}


def _save_swap_weights(args, cfg, dev) -> str:
    """A seed+1 init, scaled as the served weights, saved as step 0 of a
    new temporary checkpoint directory: the new weights a train loop
    would have produced."""
    from ..resilience.state import Checkpointer, RunState
    swap_dir = tempfile.mkdtemp(prefix="serve_swap_")
    new = build_params(cfg, args.seed + 1, args.param_scale, dev)
    ck = Checkpointer(swap_dir)
    ck.save(RunState(params=new, step=0), wait=True)
    ck.close()
    return swap_dir


def _fleet_main(args) -> int:
    """The ``--replicas N`` path: the trace through a Fleet with
    admission control, optional fault injection and hot-swap, gated on
    drops and bookkeeping (and parity when the weights never change)."""
    dev = resolve_device(args.device)
    card = dev.type == "cuda"
    cfg = model_config(args.model)
    params = build_params(cfg, args.seed, args.param_scale, dev)
    swap_dir = own_swap = None
    if args.swap_at is not None:
        swap_dir = args.swap_ckpt
        if swap_dir is None:
            swap_dir = own_swap = _save_swap_weights(args, cfg, dev)
    trace = _trace(args, cfg)
    deadline_s = (None if args.deadline_ms is None
                  else args.deadline_ms / 1e3)
    backoff_s = args.burst_ms / 1e3
    run_cfg = {"num_steps": 0, "batch_size": args.max_batch,
               "sequence_length": args.max_seq_len, "seed": args.seed,
               "requests": args.requests, "rate": args.rate,
               "page_size": args.page_size, "replicas": args.replicas,
               "inject_fault": args.inject_fault,
               "deadline_ms": args.deadline_ms, "swap_at": args.swap_at,
               "max_queue": args.max_queue,
               # what a simulator needs to rebuild this run's trace and
               # knobs
               "tenants": args.tenants, "overlap_frac": args.overlap_frac,
               "sys_len": args.sys_len, "prefill_chunk": args.prefill_chunk,
               "sync_every": args.sync_every, "burst_ms": args.burst_ms,
               "prefix_cache": args.prefix_cache, "spec_k": args.spec_k,
               **_routes(args, card)}
    failures = []
    try:
        with TelemetryRun("fleet", model=args.model, config=run_cfg,
                          device=dev, profiler=_profiler(args),
                          results_dir=args.results_dir,
                          metrics_port=args.metrics_port) as telem:
            if telem.metrics_server is not None:
                print(f"[serve] metrics: {telem.metrics_server.url}",
                      flush=True)
            fleet = Fleet(
                params, cfg, replicas=args.replicas,
                watchdog_timeout_s=args.watchdog_timeout,
                fault=args.inject_fault, telem=telem,
                max_queue=args.max_queue, burst_s_prior=backoff_s,
                device=args.device, **_engine_kwargs(args, card))
            admitted = []
            offset = 0.0
            for t, prompt, new in trace:
                # queue_full backpressure into the driver: the open loop
                # slows by one modeled burst an overflow, as a load
                # balancer's 429s pace real clients
                r = fleet.submit(prompt, max_new_tokens=new,
                                 arrival_s=t + offset, deadline_s=deadline_s)
                if isinstance(r, Rejection):
                    if r.reason == "queue_full":
                        offset += backoff_s
                else:
                    admitted.append(r)
            if swap_dir is not None:
                fleet.schedule_swap(swap_dir, after_completed=args.swap_at)
            fleet.run()
            slo = fleet.slo_report()
            print(f"[serve] fleet x{args.replicas}: {slo['completed']} "
                  f"completed / {slo['shed']} shed / {slo['dropped']} "
                  f"dropped of {args.requests}; live "
                  f"{slo['live']}/{slo['replicas']}, TTFT p50 "
                  f"{slo['ttft_ms']['p50']} ms p99 {slo['ttft_ms']['p99']} "
                  f"ms; events: "
                  f"{[e['event'] for e in slo['events']] or 'none'}",
                  flush=True)
            if slo["dropped"] > 0:
                failures.append(
                    f"{slo['dropped']} admitted request(s) dropped (rids "
                    f"{fleet.dropped()[:8]}) — the zero-drop invariant is "
                    f"broken")
            if slo["completed"] + slo["shed"] != args.requests:
                failures.append(
                    f"bookkeeping leak: {slo['completed']} completed + "
                    f"{slo['shed']} shed != {args.requests} offered")
            if swap_dir is None:
                fails, parity = _parity(params, cfg, admitted, args,
                                        fleet.view_capacity, exact=not card)
                failures += fails
                slo["parity_checked"] = parity["checked"]
                slo["parity"] = parity
            if card:
                slo["peak_memory_gib"] = _peaks(
                    {r.engine.device for r in fleet.replicas})
            slo["failures"] = failures
            telem.finalize(fleet=slo)
    finally:
        if own_swap is not None:
            shutil.rmtree(own_swap, ignore_errors=True)

    print(json.dumps({k: v for k, v in slo.items()
                      if k not in ("rejections", "events")}, indent=1))
    for f in failures:
        print(f"[serve] FAIL: {f}", file=sys.stderr, flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Every strategy's step at CPU size, built as its twin builds it.

Port of the JAX package's ``analysis/fixtures.py``: one place that knows
how to construct a small instance of each strategy's step, for the
contract suite and the card's smoke.  Factories register under the
strategies they build (:func:`register_strategy`); :func:`build_strategy`
dispatches, :func:`contract_coverage` cross-checks the registry against
``contracts.CONTRACTS``.

Sizes are the reference's: the toy MLP at width 10 000 / ``scale``, the
TINY_LM transformer at sequence length 32, a global batch of 8.  A
factory runs on the card unless asked for the CPU (``device``), and one
that needs ranks joins the process group its caller made
(``utils.mesh.init_process_group``: gloo for the CPU, NCCL for the
card); it never makes one.  The axes take the group's ranks as the
reference's fixtures take the devices: the toy-MLP and FSDP strategies
one dp axis over every rank, the two-axis ones ``{dp: ws / 2, x: 2}``
(``{dp: ws, x: 1}`` on an odd world, one card included), the 3-axis
step ``{dp, fsdp, tp}`` with tp 2 and fsdp 2 where the ranks allow.

On the card the transformer strategies take TINY_LM at head dim 64 in
bf16 with the flash kernels (:func:`lm_config`; the kernels take hd 64
and 128, TINY_LM's is 16), so that each step runs its kernels: the flash
attention forward and backward on every transformer step but ``sp``
(ring attention), K6 under ``fsdp_fp8``, K7 under
``fsdp_ring_fused_pallas``, K1 under ``serve_decode_paged_kernel`` and
the draft of ``serve_decode_spec``, K3 under ``serve_prefill_flash`` and
``serve_decode_spec``'s verify.  ``fsdp_offload`` needs the memory
planner (ROADMAP.md A12b) and is refused by name.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from ..device import resolve_device
from ..ops.collectives import COLLECTIVES
from ..utils import mesh
from .contracts import (A12B, CONTRACTS, CollectiveContract,
                        ContractContext, ContractVerdict, check_counts)

# the ddp_bucketed / ddp_q8 fixtures' bucket: small enough that the toy
# MLP needs several buckets
FIXTURE_BUCKET_MB = 0.05
SEED = 0

# name -> factory; insertion order is the canonical strategy order
_FACTORIES: dict[str, Callable[..., "StrategyBuild"]] = {}


def register_strategy(*names: str):
    """Register a fixture factory under one or more strategy names.  The
    factory is called as ``fn(name, device=, scale=, seq=,
    batch_size=)`` and returns a :class:`StrategyBuild`; two factories
    claiming one name is an error."""
    if not names:
        raise ValueError("register_strategy needs at least one name")

    def deco(fn):
        for n in names:
            if n in _FACTORIES:
                raise ValueError(
                    f"strategy {n!r} already registered by "
                    f"{_FACTORIES[n].__name__}")
            _FACTORIES[n] = fn
        return fn
    return deco


def registered_strategies() -> tuple[str, ...]:
    """Every registered strategy name, in registration order."""
    return tuple(_FACTORIES)


def contract_coverage() -> tuple[list[str], list[str]]:
    """``(missing_contract, orphans)``: registered strategies without a
    ``CONTRACTS`` entry, and contracts no factory builds."""
    regs = registered_strategies()
    missing = [s for s in regs if s not in CONTRACTS]
    orphans = [s for s in CONTRACTS if s not in regs]
    return missing, orphans


@dataclass
class StrategyBuild:
    """A runnable strategy instance and what its verdict needs.
    ``step(*args)`` is one step; ``advance(args, out)`` the next step's
    args (None: the same); ``axes`` the port's axes it runs over."""
    strategy: str
    step: Callable
    args: tuple
    advance: Callable | None
    axes: dict
    ctx: ContractContext
    device: torch.device
    sites: list = field(default_factory=list)

    @property
    def contract(self) -> CollectiveContract:
        return CONTRACTS[self.strategy]

    def run(self) -> Any:
        """One step; the args advance."""
        out = self.step(*self.args)
        if self.advance is not None:
            self.args = self.advance(self.args, out)
        return out

    def observe(self) -> dict:
        """One step under ``COLLECTIVES.capture()``: its calls by kind
        (its sites kept in ``sites``)."""
        COLLECTIVES.reset()
        COLLECTIVES.capture()
        self.run()
        counts = COLLECTIVES.read()
        self.sites = COLLECTIVES.sites()
        return counts

    def verdict(self, observed: dict | None = None) -> ContractVerdict:
        """The contract's verdict on ``observed`` (default: one observed
        step)."""
        return check_counts(self.contract,
                            self.observe() if observed is None
                            else observed, self.ctx)


def _device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _ranks(strategy: str) -> int:
    if not mesh.initialized():
        raise RuntimeError(
            f"the {strategy} fixture needs a process group: make one "
            f"(utils.mesh.init_process_group) before building it")
    return mesh.axis_size()


def _state_advance(args, out):
    """``(params, opt, batch)``: the new state, the same batch."""
    return (out[0], out[1], args[2])


def lm_config(device: torch.device):
    """The transformer fixtures' config: TINY_LM on the CPU; on the card
    TINY_LM at head dim 64 in bf16 with the flash kernels."""
    from ..models import transformer as T
    if device.type != "cuda":
        return T.TINY_LM
    return dataclasses.replace(T.TINY_LM, head_dim=64, dtype=torch.bfloat16,
                               attention_impl="flash")


def _lm_batch(cfg, seq: int, batch_size: int, dev):
    from ..train.train_fsdp import fsdp_batches
    ids, labels = next(fsdp_batches(cfg.vocab_size, seq, batch_size, 1,
                                    SEED))
    return (torch.as_tensor(ids, device=dev),
            torch.as_tensor(labels, device=dev))


def _split(ws: int, second: int = 2) -> tuple[int, int]:
    """(dp, second) over ``ws`` ranks: the second axis 2 where it
    divides, else 1."""
    s = second if ws % second == 0 else 1
    return ws // s, s


@register_strategy("ddp", "ddp_bucketed", "ddp_q8", "zero1", "zero2",
                   "zero3")
def _build_mlp_dp(strategy: str, *, device=None, scale: int = 100,
                  seq: int = 32, batch_size: int = 8) -> StrategyBuild:
    """The toy MLP over one dp axis, as ``train.ddp`` (SGD) and
    ``train.zero``'s sharded leg (Adam) build it."""
    from ..models import mlp
    from ..parallel import ddp, optim, zero

    _ranks(strategy)
    dev = _device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = mlp.zero_toy_mlp(gen, scale=scale, device=dev)
    width = mlp.ZERO_TOY_SIZES[0] // scale
    batch = (torch.randn(batch_size, width, generator=gen, device=dev),
             torch.randn(batch_size, width, generator=gen, device=dev))
    bucketed = strategy in ("ddp_bucketed", "ddp_q8")
    ctx = ContractContext.capture(
        params=params, axes={"dp": "dp"}, n_layers=len(params),
        **({"bucket_mb": FIXTURE_BUCKET_MB} if bucketed else {}))
    if strategy.startswith("ddp"):
        step = ddp.make_ddp_train_step(
            mlp.mse_loss, lambda g, s, p: optim.sgd_update(g, s, p, lr=1e-3),
            bucket_mb=FIXTURE_BUCKET_MB if bucketed else None,
            quantize_grads=strategy == "ddp_q8")
        args = (params, optim.sgd_init(params), batch)
    elif strategy in ("zero1", "zero2"):
        step = zero.make_zero_train_step(mlp.mse_loss,
                                         stage=int(strategy[-1]))
        args = (params, zero.init_zero_opt_state(params), batch)
    else:
        shapes = [{k: tuple(v.shape) for k, v in layer.items()}
                  for layer in params]
        step = zero.make_zero3_train_step(zero.make_zero3_mlp_loss(shapes))
        args = (zero.shard_params_zero3(params),
                zero.init_zero_opt_state(params), batch)
    return StrategyBuild(strategy, step, args, _state_advance,
                         {"dp": "dp"}, ctx, dev)


_FSDP_OVERLAP = {"fsdp": "none", "fsdp_fp8": "none", "fsdp_q8": "none",
                 "fsdp_ring": "ring",
                 "fsdp_ring_fused_pallas": "ring_fused_pallas"}
_TP_OVERLAP = {"tp": "none", "tp_ring": "ring", "tp_q8": "q8"}


@register_strategy(*_FSDP_OVERLAP, *_TP_OVERLAP, "sp", "moe")
def _build_transformer(strategy: str, *, device=None, scale: int = 100,
                       seq: int = 32, batch_size: int = 8) -> StrategyBuild:
    """The transformer strategies, as ``train.train_fsdp``,
    ``train.train_tp``, ``train.train_sp`` and ``train.moe`` build them:
    FSDP over dp; dp × tp; FSDP over dp × ring attention over sp; dp ×
    ep with 4 experts of width intermediate / 4."""
    from ..models import transformer as T
    from ..parallel import expert, fsdp, optim, sequence, tensor

    ws = _ranks(strategy)
    dev = _device(device)
    cfg = lm_config(dev)
    if strategy == "moe":
        cfg = dataclasses.replace(
            cfg, n_experts=4, moe_ffn=max(cfg.intermediate_size // 4, 8))
    elif strategy == "fsdp_fp8":
        # the fp8 precision leg: K6 in the projections, fsdp's calls
        cfg = dataclasses.replace(cfg, matmul_precision="fp8_pallas")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = T.init_params(cfg, gen, dev)
    knobs: dict = {"remat": cfg.remat}
    if strategy in _FSDP_OVERLAP:
        axes = {"dp": "dp"}
        overlap = _FSDP_OVERLAP[strategy]
        shards = fsdp.shard_params_fsdp(params)
        step = fsdp.make_fsdp_train_step(
            shards, cfg, overlap=overlap,
            quantized_gather=strategy == "fsdp_q8")
        knobs["overlap"] = overlap
        opt = fsdp.init_fsdp_opt_state(shards)
    elif strategy in _TP_OVERLAP:
        dp, tp = _split(ws)
        axes = mesh.grid_axes(("dp", "tp"), (dp, tp))
        shards = tensor.shard_params_tp(params, axes["tp"])
        step = tensor.make_tp_train_step(
            shards, cfg, dp_axis=axes["dp"], tp_axis=axes["tp"],
            overlap=_TP_OVERLAP[strategy])
        knobs["overlap"] = _TP_OVERLAP[strategy]
        opt = fsdp.init_fsdp_opt_state(shards)
    elif strategy == "sp":
        dp, sp = _split(ws)
        axes = mesh.grid_axes(("dp", "sp"), (dp, sp))
        shards = fsdp.shard_params_fsdp(params, axes["dp"])
        step = sequence.make_sp_train_step(shards, cfg, dp_axis=axes["dp"],
                                           sp_axis=axes["sp"])
        opt = fsdp.init_fsdp_opt_state(shards)
    else:
        dp, ep = _split(ws)
        dp_ax, ep_ax = mesh.dp_ep_axes(dp, ep)
        axes = {"dp": dp_ax, "ep": ep_ax}
        shards = expert.shard_moe_lm_params(params, ep_ax)
        step = expert.make_moe_lm_train_step(shards, cfg, dp_axis=dp_ax,
                                             ep_axis=ep_ax)
        opt = optim.adam_init(shards)
    del params
    axes = {a: x for a, x in axes.items() if "_" not in a}
    ctx = ContractContext.capture(params=shards, axes=axes,
                                  n_layers=cfg.num_hidden_layers, **knobs)
    return StrategyBuild(strategy, step,
                         (shards, opt, _lm_batch(cfg, seq, batch_size, dev)),
                         _state_advance, axes, ctx, dev)


@register_strategy("composable_zero1", "composable_dp_fsdp_tp")
def _build_composable(strategy: str, *, device=None, scale: int = 100,
                      seq: int = 32, batch_size: int = 8) -> StrategyBuild:
    """The generated-contract strategies, as ``train.train_composable``
    builds them: ``composable_zero1`` the toy MLP at W1 over dp
    (``MeshPlan(dp=ws, w=1)``); ``composable_dp_fsdp_tp`` TINY_LM on the
    3-axis step, placed by its RuleSet."""
    from ..models import mlp
    from ..models import transformer as T
    from ..parallel import composable as CP
    from ..parallel import fsdp

    ws = _ranks(strategy)
    dev = _device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    if strategy == "composable_zero1":
        params = mlp.zero_toy_mlp(gen, scale=scale, device=dev)
        width = mlp.ZERO_TOY_SIZES[0] // scale
        batch = (torch.randn(batch_size, width, generator=gen, device=dev),
                 torch.randn(batch_size, width, generator=gen, device=dev))
        plan = CP.MeshPlan(dp=ws, w=1)
        build = CP.make_composable_train_step(
            params, plan, axes=CP.plan_grid(plan), loss_fn=mlp.mse_loss)
        axes = {"dp": build.axes["dp"]}
        step, state, opt = build.step, build.params, build.opt_state
        ctx = ContractContext.capture(params=state, axes=axes,
                                      n_layers=len(params),
                                      **build.contract_kwargs)
    else:
        cfg = lm_config(dev)
        dp, tp = _split(ws)
        dp, f = _split(dp)
        grid = mesh.grid_axes(("dp", "fsdp", "tp"), (dp, f, tp))
        axes = {a: grid[a] for a in ("dp", "fsdp", "tp")}
        state = CP.shard_params_by_rules(T.init_params(cfg, gen, dev),
                                         strategy, grid)
        step = CP.make_dp_fsdp_tp_step(state, cfg, dp_axis=grid["dp"],
                                       fsdp_axis=grid["fsdp"],
                                       tp_axis=grid["tp"])
        opt = fsdp.init_fsdp_opt_state(state)
        batch = _lm_batch(cfg, seq, batch_size, dev)
        ctx = ContractContext.capture(params=state, axes=axes,
                                      n_layers=cfg.num_hidden_layers,
                                      remat=cfg.remat)
    return StrategyBuild(strategy, step, (state, opt, batch),
                         _state_advance, axes, ctx, dev)


def _engine(strategy: str, device, batch_size: int, **kw):
    """A serving engine over the group's ranks as tp, its pool of
    ``batch_size`` requests of 4 pages of 8, and the page table."""
    from ..models import transformer as T
    from ..serving.engine import ServingEngine

    ws = _ranks(strategy)
    dev = _device(device)
    cfg = lm_config(dev)
    grid = mesh.grid_axes(("tp",), (ws,))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = T.init_params(cfg, gen, dev)
    page, per = 8, 4
    eng = ServingEngine(params, cfg, mesh=grid, tp_axis="tp",
                        max_batch=batch_size, page_size=page,
                        max_seq_len=page * per, **kw)
    pages = torch.arange(1, batch_size * per + 1, dtype=torch.int32,
                         device=eng.device).reshape(batch_size, per)
    ctx = ContractContext.capture(params=eng._params,
                                  axes={"tp": grid["tp"]},
                                  n_layers=cfg.num_hidden_layers)
    return eng, pages, page * per, {"tp": grid["tp"]}, ctx


def _slots(eng, batch_size: int, stop: int):
    """(tokens, lengths, stop_at, active) of ``batch_size`` fresh slots."""
    z = torch.zeros(batch_size, dtype=torch.int32, device=eng.device)
    return (z, z.clone(), torch.full_like(z, stop - 1),
            torch.ones(batch_size, dtype=torch.bool, device=eng.device))


@register_strategy("serve_decode", "serve_decode_paged_kernel")
def _build_serve_decode(strategy: str, *, device=None, scale: int = 100,
                        seq: int = 32, batch_size: int = 8) -> StrategyBuild:
    """The tensor-parallel serving decode step over the paged pool
    (``_paged_kernel``: attention through K1)."""
    from ..serving import engine as E

    paged = strategy == "serve_decode_paged_kernel"
    eng, pages, stop, axes, ctx = _engine(strategy, device, batch_size,
                                          paged_kernel=paged)
    step = functools.partial(E._decode_core, cfg=eng.cfg,
                             paged_kernel=paged, tp_axis=eng.tp_axis)
    toks, lengths, stop_at, active = _slots(eng, batch_size, stop)
    args = (eng.pool.bufs, eng._params, pages, toks, lengths, stop_at,
            active)

    def advance(args, out):
        # the next token, length and activity chain into the next step
        nxt, new_len, new_active, _ = out
        return args[:3] + (nxt, new_len, args[5], new_active)
    return StrategyBuild(strategy, step, args, advance, axes, ctx,
                         eng.device)


@register_strategy("serve_decode_spec", "serve_prefill_flash")
def _build_serve_frontier(strategy: str, *, device=None, scale: int = 100,
                          seq: int = 32, batch_size: int = 8
                          ) -> StrategyBuild:
    """The speculative verify over a (B, k + 1) block and the batched
    prefill chunk, both through K3.  The verify's block is the last
    token and k = 3 proposals of the engine's draft (the target
    truncated to one layer), drafted through K1 before the step."""
    from ..serving import engine as E

    if strategy == "serve_decode_spec":
        k = 3
        eng, pages, stop, axes, ctx = _engine(
            strategy, device, batch_size, paged_kernel=True,
            flash_prefill=True, spec_k=k, draft_layers=1)
        toks, lengths, stop_at, active = _slots(eng, batch_size, stop)
        block = [toks]
        for _ in range(k):   # the draft's steps, as the spec burst runs
            toks, lengths, active, _ = E._decode_core(
                eng.draft_pool.bufs, eng._draft_params, pages, toks,
                lengths, stop_at, active, cfg=eng.draft_cfg,
                paged_kernel=True, tp_axis=eng.tp_axis)
            block.append(toks)
        z = torch.zeros_like(lengths)
        step = functools.partial(E._spec_verify_core, cfg=eng.cfg,
                                 flash_prefill=True, tp_axis=eng.tp_axis)
        args = (eng.pool.bufs, eng._params, pages,
                torch.stack(block, dim=1), z, stop_at,
                torch.ones_like(active))
    else:
        eng, pages, stop, axes, ctx = _engine(strategy, device, batch_size,
                                              flash_prefill=True)
        chunk = 16
        gen = torch.Generator(device=eng.device).manual_seed(SEED)
        ids = torch.randint(1, eng.cfg.vocab_size, (batch_size, chunk),
                            generator=gen, device=eng.device,
                            dtype=torch.int32)
        z = torch.zeros(batch_size, dtype=torch.int32, device=eng.device)
        step = functools.partial(E._prefill_batch_core, cfg=eng.cfg,
                                 flash_prefill=True, tp_axis=eng.tp_axis)
        args = (eng.pool.bufs, eng._params, pages, ids, z,
                torch.full_like(z, chunk))
    # the pool is written in place: every step takes the same args
    return StrategyBuild(strategy, step, args, None, axes, ctx, eng.device)


@register_strategy("gpipe", "1f1b")
def _build_pipeline(strategy: str, *, device=None, scale: int = 100,
                    seq: int = 32, batch_size: int = 8) -> StrategyBuild:
    """The PP toy in 2 stages, as ``train.pipeline`` builds it; a step is
    one epoch of the schedule over 4 microbatches."""
    from ..parallel import pipeline as PP
    from ..train.pipeline import build_stages, epoch_batches

    stages, _ = build_stages("mlp", strategy, 2, 2, SEED, device)
    dev = stages[0].device
    batch = next(epoch_batches(None, batch_size, seq, SEED, dev))

    def step(stages, batch):
        return PP.train_pipeline(stages, strategy, lambda e: batch,
                                 num_epochs=1, n_micro=4)
    ctx = ContractContext.capture(params=[s.params for s in stages],
                                  n_layers=len(stages))
    return StrategyBuild(strategy, step, (stages, batch), None, {}, ctx,
                         dev)


# the public, ordered tuple every caller keys on
STRATEGIES = registered_strategies()


def build_strategy(strategy: str, *, device=None, scale: int = 100,
                   seq: int = 32, batch_size: int = 8) -> StrategyBuild:
    """Build the named strategy's step as its twin does (the registered
    factory), on the card unless ``device`` says otherwise."""
    if strategy == "fsdp_offload":
        raise NotImplementedError(
            "the fsdp_offload fixture parks the Adam moments on the host "
            f"through the memory planner, not ported yet — see {A12B}")
    try:
        factory = _FACTORIES[strategy]
    except KeyError:
        raise KeyError(
            f"unknown strategy {strategy!r}; have {STRATEGIES}") from None
    return factory(strategy, device=device, scale=scale, seq=seq,
                   batch_size=batch_size)

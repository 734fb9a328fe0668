"""Pipeline parallelism: GPipe, 1F1B and interleaved 1F1B, host-driven.

Port of the JAX package's ``parallel/pipeline.py``, itself the twin of
upstream's ``pp/gpipe.py`` and ``pp/1f1b.py``: a layered model split
into contiguous stages placed on devices *in one process*, a host-side
scheduler moving microbatch activations from stage to stage, and one
Adam optimiser a stage.  The cross-stage hop is a device copy
(``.to(device, non_blocking=True)``, upstream's ``gpipe.py:108``): an
identity on one card, a peer copy across cards; no collective.

Mechanics, and where they differ from the reference:
  * a stage's forward keeps its graph: it stores ``(input, output)`` a
    microbatch, the input detached and made to require grad (upstream's
    ``x.detach().requires_grad_(True)``, ``1f1b.py:112-123``), and its
    backward is ``torch.autograd.grad`` of the stored output against
    the incoming cotangent (upstream's ``out.backward(gradient=...)``,
    ``1f1b.py:137-156``).  The reference re-runs the stage under
    ``jax.vjp`` on the stored input instead; the values are the same,
    but the port holds each stored microbatch's saved tensors, not only
    its input (PERF.md's layer table).  ``max_stored`` counts stored
    microbatches a stage, as the reference does;
  * the last stage stores only its input and runs its forward, loss and
    backward together in its backward slot, as the reference does;
  * grads accumulate in place (``add_``) into one buffer a stage, the
    counterpart of the reference's donated ``_tree_add_donated``; the
    buffer outlives the step (the next step's first microbatch
    overwrites it), so a step allocates no new grad buffers and the last
    step's grads stay readable (``grad_acc``);
  * each stage steps with ``optim.adam_update`` (in place), the
    arithmetic of the reference's ``adam_step_donated``, or with
    ``opt8`` on int8 moments with ``optim8.adam8_step`` (in place, its
    ``adam8_step_donated``);
  * per-microbatch losses stay on the device until the step ends.

GPipe (:func:`run_gpipe`): all forwards stage by stage, then all
backwards in reverse microbatch order.  1F1B (:func:`run_1f1b`): the
reference's clock, ``n_micro + n_stages - 1`` ticks, no queue snapshot,
so a forward crosses the whole pipeline in one tick and the last stage
runs its backward in the same tick.  Interleaved 1F1B
(:func:`run_interleaved_1f1b`): ``D·V`` virtual stages round-robin over
``D`` devices, one forward and one backward a device a tick, work
enqueued in a tick visible the next.

A stage's device is a ``torch.device``; its *logical* device is the
index of its device in ``build_pipeline``'s list (stage ``s`` on
``s % len(devices)``).  The interleaved clock counts devices by logical
index, so on the CPU, where every stage lives on ``cpu``, a list of D
CPU devices still gives D logical devices.

MoE stages: a stage built with ``aux_weight`` yields ``(out, aux)``,
``aux`` its layers' summed load-balance losses.  The aux cotangent
``aux_weight / n_micro`` enters each stage's backward locally beside
the output's; only the values travel, to the reported loss (reference
``:84-95``).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import asdict, dataclass, field
from functools import partial
from typing import Callable, Sequence

import torch

from ..device import resolve_device
from ..models.mlp import mlp_apply, mlp_apply_stage
from ..utils.memory import MB, device_memory_stats, tree_size_bytes
from . import optim, optim8


def split_stages(params: list, n_stages: int) -> list[list]:
    """Contiguous layer chunks, the remainder to the earlier stages (6
    layers over 2 stages: 3 + 3; over 8: six of one and two empty)."""
    n = len(params)
    base, rem = divmod(n, n_stages)
    out, start = [], 0
    for s in range(n_stages):
        size = base + (1 if s < rem else 0)
        out.append(params[start:start + size])
        start += size
    return out


def _mse(out, y, params):
    return torch.mean((out - y) ** 2)


def _hidden(out):
    """The activation a stage hands on: its output, without the aux of
    an MoE stage's ``(out, aux)``."""
    return out[0] if isinstance(out, tuple) else out


class PipelineStage:
    """One stage: a copy of its params on ``device`` (leaves that require
    grad), its forward ``apply_fn(params, x)``, its Adam state (int8
    moments with ``opt8``, ``optim8``) and grad buffer.  The last
    stage's ``loss_fn(out, y, params)`` (default: the mean squared
    error) may read the stage params, as the transformer's unembedding
    does.  With ``aux_weight`` (an MoE stage) ``apply_fn`` returns
    ``(out, aux)`` and ``aux_weight · aux`` joins the objective."""

    def __init__(self, stage_params, device, apply_fn: Callable = mlp_apply,
                 is_last: bool = False, loss_fn: Callable | None = None,
                 logical_device: int = 0, opt8: bool = False,
                 aux_weight: float | None = None):
        self.device = torch.device(device)
        self.logical_device = logical_device
        self.params = optim.tree_map(
            lambda p: p.detach().to(self.device, copy=True)
            .requires_grad_(p.is_floating_point()), stage_params)
        self._leaves = [p for _, p in optim.tree_leaves(self.params)]
        self.apply_fn = apply_fn
        self.aux_weight = aux_weight
        # each backward's weighted aux value · 1/n_micro (MoE stages),
        # summed into the reported loss at the step's end
        self.aux_values: list = []
        self.is_last = is_last
        self.loss_fn = loss_fn or _mse
        self.opt8 = opt8
        self.opt_state = (optim8.adam8_init(self.params) if opt8
                          else optim.adam_init(self.params))
        self.grad_acc = None
        self._fresh = True       # the next accumulate overwrites grad_acc
        # high-water mark of stored microbatches (1F1B's ~n_stages
        # against GPipe's n_micro) and the last stored input's shape
        self.max_stored = 0
        self.input_meta = None

    def _input(self, x):
        self.input_meta = (tuple(x.shape), x.dtype)
        return x.detach().requires_grad_(x.is_floating_point())

    def _grads(self, outputs, xin, grad_outputs=None):
        """``(input grad or None, param grads)`` of ``outputs``."""
        if not xin.requires_grad:   # integer inputs: token ids
            return None, torch.autograd.grad(outputs, self._leaves,
                                             grad_outputs)
        gx, *gp = torch.autograd.grad(outputs, [xin] + self._leaves,
                                      grad_outputs)
        return gx, gp

    def forward(self, x):
        """The stage on microbatch ``x``, its graph kept: ``(stored
        input, output)``."""
        xin = self._input(x)
        with torch.enable_grad():
            return xin, self.apply_fn(self.params, xin)

    def backward(self, xin, out, gout, inv_n_micro: float = 1.0):
        """Back through a stored microbatch: the param grads accumulate,
        the input grad (None for integer inputs) is returned.  An MoE
        stage's ``(out, aux)`` takes the aux cotangent ``aux_weight ·
        inv_n_micro`` beside ``gout``."""
        if isinstance(out, tuple):
            hidden, aux = out
            ct = self.aux_weight * inv_n_micro
            self.aux_values.append(aux.detach() * ct)
            gx, gp = self._grads([hidden, aux], xin,
                                 [gout, torch.full_like(aux, ct)])
        else:
            gx, gp = self._grads(out, xin, gout)
        self.accumulate(gp)
        return gx

    def objective(self, out, y):
        """The last stage's loss on its output: ``loss_fn`` plus
        ``aux_weight · aux`` for an MoE stage."""
        if isinstance(out, tuple):
            return (self.loss_fn(out[0], y, self.params)
                    + self.aux_weight * out[1])
        return self.loss_fn(out, y, self.params)

    def last_forward_backward(self, x, y, inv_n_micro: float):
        """The last stage's forward, ``loss · inv_n_micro`` and backward
        on one microbatch: ``(scaled loss, input grad or None)``."""
        xin = self._input(x)
        with torch.enable_grad():
            loss = self.objective(self.apply_fn(self.params, xin),
                                  y) * inv_n_micro
        gx, gp = self._grads(loss, xin)
        self.accumulate(gp)
        return loss.detach(), gx

    def accumulate(self, grads: list) -> None:
        """Add one microbatch's param grads (in ``tree_leaves`` order) into
        the stage's buffer, in place."""
        if self.grad_acc is None:
            self.grad_acc = optim.tree_unflatten(self.params, list(grads))
        else:
            with torch.no_grad():
                for (_, acc), g in zip(optim.tree_leaves(self.grad_acc),
                                       grads):
                    (acc.copy_ if self._fresh else acc.add_)(g)
        self._fresh = False

    def step(self, lr: float = 1e-3) -> None:
        """The stage's Adam step on the grads accumulated since the last
        step (in place); nothing when none were."""
        if self._fresh:
            return
        if self.opt8:
            self.params, self.opt_state = optim8.adam8_step(
                self.grad_acc, self.opt_state, self.params, lr)
        else:
            self.params, self.opt_state = optim.adam_update(
                self.grad_acc, self.opt_state, self.params, lr=lr)
        self._fresh = True

    def memory_plan_mb(self) -> float:
        """The stage's accounted bytes: params, Adam moments, the grad
        buffer and its stored inputs at the high-water mark.  The
        reference fills this column with XLA's compile-time plan, which
        has no torch counterpart; the port's stored graphs hold more than
        the inputs (PERF.md)."""
        state = (tree_size_bytes(self.params) * 2
                 + optim8.state_bytes(self.opt_state))
        return (state + self.max_stored * _input_bytes(self)) / MB


def _input_bytes(stage: PipelineStage) -> int:
    """Bytes of one stored microbatch input of ``stage`` (0 before its
    first)."""
    if stage.input_meta is None:
        return 0
    shape, dtype = stage.input_meta
    return (torch.Size(shape).numel()
            * torch.empty((), dtype=dtype).element_size())


def default_devices() -> list[torch.device]:
    """Every CUDA card, in index order; raises without one."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def build_pipeline(params: list, n_stages: int,
                   devices: Sequence | None = None,
                   apply_fn: Callable | None = None,
                   loss_fn: Callable | None = None,
                   opt8: bool = False) -> list[PipelineStage]:
    """Split a layered model over ``n_stages`` stages, stage ``s`` on
    ``devices[s % len(devices)]`` (default: every card).  The default
    apply keeps the inter-stage ReLUs with their chunk
    (``mlp_apply_stage``); ``apply_fn`` is used as it is for every
    stage.  ``loss_fn(out, y)``: the last stage's loss (default: the
    mean squared error).  ``opt8``: int8 Adam moments a stage (the
    reference builds such stages with ``PipelineStage(opt8=True)``)."""
    devs = [torch.device(d) for d in (devices if devices is not None
                                      else default_devices())]
    loss = (lambda out, y, p: loss_fn(out, y)) if loss_fn else None
    stages = []
    for s, chunk in enumerate(split_stages(params, n_stages)):
        is_last = s == n_stages - 1
        apply = apply_fn or partial(mlp_apply_stage, last_stage=is_last)
        stages.append(PipelineStage(chunk, devs[s % len(devs)], apply,
                                    is_last=is_last, loss_fn=loss,
                                    logical_device=s % len(devs), opt8=opt8))
    return stages


def build_transformer_pipeline(params: dict, cfg, n_stages: int,
                               devices: Sequence | None = None,
                               opt8: bool = False) -> list[PipelineStage]:
    """Stage the LM (``models.transformer``) over ``n_stages`` stages:
    stage 0 embeds and runs its layer slice, middle stages run layers,
    the last adds the final norm, the unembedding and
    ``xent_from_hidden`` (``cfg.loss_vocab_chunk`` honoured).

    Layer slices stay stacked ``(L_s, …)``; each layer runs through
    ``_layer_body`` under ``resolve_remat_policy`` when ``cfg.remat``,
    its NoPE flag taken by *global* layer index.  Tied embeddings are
    untied: with one optimiser a stage the embedding would need a
    cross-stage grad sum every step, so the last stage gets its own
    ``lm_head``, ``embed.T`` copied into the ``(H, vocab)`` layout (or
    the existing ``lm_head``).  ``opt8``: each stage steps on int8
    Adam moments (``optim8``)."""
    from ..models import transformer as T

    if cfg.n_experts and cfg.ep_axis is not None:
        raise ValueError(
            "MoE×PP stages run one process per stage — experts must be "
            "stage-local (cfg.ep_axis=None); shard experts with the "
            "dp×ep step instead (parallel.expert.make_moe_lm_train_step)")
    L = cfg.num_hidden_layers
    if n_stages > L:
        raise ValueError(f"n_stages={n_stages} exceeds "
                         f"num_hidden_layers={L}")
    flags = T.rope_flags(cfg)
    devs = [torch.device(d) for d in (devices if devices is not None
                                      else default_devices())]
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T.contiguous()   # untie (see above)

    def apply(p, x, *, first, last, flags):
        if first:
            x = p["embed"].to(cfg.dtype)[x.long()]
        cos, sin = T._rope_tables(x.shape[1], cfg.resolved_head_dim,
                                  cfg.rope_theta, device=x.device)
        remat = T.resolve_remat_policy(cfg) if cfg.remat else None
        aux = 0.0
        for i, use_rope in enumerate(flags):
            body = partial(T._layer_body, cfg=cfg, cos=cos, sin=sin,
                           use_rope=use_rope)
            layer = T.layer_params(p, i)
            x, a = remat(body, x, layer) if remat else body(x, layer)
            if a is not None:
                aux = aux + a
        if last:
            x = T.rms_norm(x, p["final_norm"], cfg.rms_norm_eps)
        # an MoE stage's aux: its layers' balance losses
        return (x, aux) if cfg.n_experts else x

    def lm_xent(hidden, labels, p):
        # lm_head is (H, vocab); xent takes (vocab, H) rows
        return T.xent_from_hidden(hidden, p["lm_head"].to(cfg.dtype).T,
                                  labels, chunk=cfg.loss_vocab_chunk)

    stages = []
    for s, idxs in enumerate(split_stages(list(range(L)), n_stages)):
        lo, hi = idxs[0], idxs[-1] + 1
        first, last = s == 0, s == n_stages - 1
        sp = {"layers": {k: v[lo:hi] for k, v in params["layers"].items()}}
        if first:
            sp["embed"] = params["embed"]
        if last:
            sp["final_norm"] = params["final_norm"]
            sp["lm_head"] = head
        stages.append(PipelineStage(
            sp, devs[s % len(devs)],
            partial(apply, first=first, last=last, flags=flags[lo:hi]),
            is_last=last, loss_fn=lm_xent if last else None,
            logical_device=s % len(devs), opt8=opt8,
            aux_weight=cfg.moe_aux_weight if cfg.n_experts else None))
    return stages


def _microbatch(x, y, n_micro: int):
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} not divisible by "
                         f"n_micro={n_micro}")
    size = x.shape[0] // n_micro
    return torch.split(x, size), torch.split(y, size)


def _to_stage(x, stage: PipelineStage):
    """The cross-stage hop: an identity on the stage's device, a peer
    copy from another card."""
    return x.to(stage.device, non_blocking=True)


def _note_stored(stage: PipelineStage, n: int) -> None:
    stage.max_stored = max(stage.max_stored, n)


def _step_all(stages, mb_losses, lr) -> float:
    """Each stage's Adam step; the batch loss: the microbatches' scaled
    losses, plus the earlier MoE stages' weighted aux values (the last
    stage's are inside its losses), summed on the host."""
    aux = []
    for stage in stages:
        stage.step(lr)
        aux.extend(stage.aux_values)
        stage.aux_values.clear()
    return (float(torch.stack(mb_losses).sum())
            + sum(float(a) for a in aux))


@torch.no_grad()
def pipeline_loss(stages: list[PipelineStage], x, y) -> float:
    """The loss of the whole batch ``(x, y)`` under the stages' params:
    every stage's forward in turn, then the last stage's loss; no grad,
    no microbatches, no step."""
    aux = 0.0
    for stage in stages[:-1]:
        out = stage.apply_fn(stage.params, _to_stage(x, stage))
        if isinstance(out, tuple):
            aux += stage.aux_weight * float(out[1])
        x = _hidden(out)
    last = stages[-1]
    out = last.apply_fn(last.params, _to_stage(x, last))
    return float(last.objective(out, _to_stage(y, last))) + aux


def run_gpipe(stages: list[PipelineStage], x, y, n_micro: int = 4,
              lr: float = 1e-3) -> float:
    """One GPipe step: all forwards, then all backwards in reverse
    microbatch order, then each stage's Adam step.  Returns the batch
    loss, the sum of the microbatches' ``loss / n_micro``."""
    n_stages = len(stages)
    xs, ys = _microbatch(x, y, n_micro)
    inv = 1.0 / n_micro
    fwd_q: list[deque] = [deque(xs)] + [deque() for _ in stages[1:]]
    stored: list[list] = [[] for _ in stages]
    for s, stage in enumerate(stages):
        while fwd_q[s]:
            xin = _to_stage(fwd_q[s].popleft(), stage)
            if stage.is_last:
                stored[s].append((xin, None))
            else:
                xin, out = stage.forward(xin)
                stored[s].append((xin, out))
                fwd_q[s + 1].append(_hidden(out).detach())
            _note_stored(stage, len(stored[s]))

    mb_losses = []
    for mb in reversed(range(n_micro)):
        last = stages[-1]
        xin, _ = stored[-1][mb]
        stored[-1][mb] = None
        loss, g = last.last_forward_backward(xin, _to_stage(ys[mb], last),
                                             inv)
        mb_losses.append(loss)
        for s in range(n_stages - 2, -1, -1):
            xin, out = stored[s][mb]
            stored[s][mb] = None
            g = stages[s].backward(xin, out, _to_stage(g, stages[s]), inv)
    return _step_all(stages, mb_losses, lr)


def run_1f1b(stages: list[PipelineStage], x, y, n_micro: int = 4,
             lr: float = 1e-3, schedule_trace: list | None = None) -> float:
    """One 1F1B step on the reference's clock: ``n_micro + n_stages - 1``
    ticks, each stage (in ascending order) doing at most one forward and
    one backward a tick.  The queues are not snapshotted at a tick's
    start, so a forward output enqueued for stage s + 1 is consumed in
    the same tick (a microbatch crosses the forward pipeline in one tick,
    the last stage backs it up at once), while a backward gradient,
    relayed to a stage already visited, moves one stage a tick.
    Activations are freed as backwards consume them, so a stage stores
    ~n_stages microbatches at most.

    ``schedule_trace``: a list that collects ``(tick, stage, op, mb)``
    events."""
    n_stages = len(stages)
    xs, ys = _microbatch(x, y, n_micro)
    inv = 1.0 / n_micro
    fwd_q: list[deque] = [deque(enumerate(xs))] + [
        deque() for _ in stages[1:]]
    bwd_q: list[deque] = [deque() for _ in stages]
    stored: list[dict] = [{} for _ in stages]
    mb_losses = []
    ticks = n_micro + n_stages - 1
    for tick in range(ticks):
        for s, stage in enumerate(stages):
            if fwd_q[s]:
                mb, xin = fwd_q[s].popleft()
                xin = _to_stage(xin, stage)
                if stage.is_last:   # backs up at once
                    stored[s][mb] = (xin, None)
                    bwd_q[s].append((mb, None))
                else:
                    xin, out = stage.forward(xin)
                    stored[s][mb] = (xin, out)
                    fwd_q[s + 1].append((mb, _hidden(out).detach()))
                _note_stored(stage, len(stored[s]))
                if schedule_trace is not None:
                    schedule_trace.append((tick, s, "fwd", mb))
            if bwd_q[s]:
                mb, gout = bwd_q[s].popleft()
                xin, out = stored[s].pop(mb)   # frees the activation
                if stage.is_last:
                    loss, gx = stage.last_forward_backward(
                        xin, _to_stage(ys[mb], stage), inv)
                    mb_losses.append(loss)
                else:
                    gx = stage.backward(xin, out, _to_stage(gout, stage), inv)
                if s > 0:
                    bwd_q[s - 1].append((mb, gx))
                if schedule_trace is not None:
                    schedule_trace.append((tick, s, "bwd", mb))
    leftover = sum(len(q) for q in fwd_q + bwd_q)
    if leftover:
        raise RuntimeError(f"1F1B clock did not drain in {ticks} ticks: "
                           f"{leftover} queued items")
    return _step_all(stages, mb_losses, lr)


def run_interleaved_1f1b(stages: list[PipelineStage], x, y,
                         n_micro: int = 4, lr: float = 1e-3,
                         n_devices: int | None = None,
                         schedule_trace: list | None = None,
                         stats: dict | None = None) -> float:
    """One interleaved (virtual-stage) 1F1B step.  ``stages`` holds
    ``D·V`` virtual stages round-robin over ``D`` devices (virtual stage
    q on logical device ``q % D``, as ``build_pipeline`` places them),
    each device owning V non-contiguous chunks (Megatron's layout).  The
    clock is physical: each tick each device does at most one forward
    and one backward among its chunks, and work enqueued in a tick is
    seen the next.  Backward: oldest microbatch first; forward: deepest
    chunk first.  V = 1 is a physical plain 1F1B, whose bubble is
    ``(S - 1) / (M + S - 1)``; V chunks cut it by about V.

    ``n_devices``: D (default: the stages' distinct logical devices).
    ``stats`` receives ticks, the bubble fraction, each device's busy
    ticks and its high-water mark of stored microbatches.
    ``schedule_trace`` collects ``(tick, device, virtual stage, op,
    mb)``.  Returns the batch loss, as :func:`run_gpipe`."""
    n_virtual = len(stages)
    D = n_devices or len(dict.fromkeys(s.logical_device for s in stages))
    if n_virtual % D:
        raise ValueError(f"{n_virtual} virtual stages not divisible by "
                         f"{D} devices")
    for q, s in enumerate(stages):
        home = stages[q % D]
        if (s.logical_device, s.device) != (home.logical_device,
                                            home.device):
            raise ValueError(
                f"virtual stage {q} on {s.device} (logical "
                f"{s.logical_device}) breaks the round-robin layout "
                f"(expected the device of stage {q % D})")
    V = n_virtual // D
    xs, ys = _microbatch(x, y, n_micro)
    inv = 1.0 / n_micro
    fwd_q: list[deque] = [deque(enumerate(xs))] + [
        deque() for _ in stages[1:]]
    bwd_q: list[deque] = [deque() for _ in stages]
    stored: list[dict] = [{} for _ in stages]
    mb_losses = []
    per_dev_busy, dev_max_stored = [0] * D, [0] * D
    tick = 0
    tick_limit = 4 * (n_micro + D) * V + 64   # a generous drain bound
    while any(fwd_q[q] or bwd_q[q] for q in range(n_virtual)):
        if tick >= tick_limit:
            raise RuntimeError(f"interleaved clock failed to drain within "
                               f"{tick_limit} ticks")
        pending = []   # (queue, q, item), applied at the tick's end
        for d in range(D):
            resident = range(d, n_virtual, D)
            busy = False
            cands = [(bwd_q[q][0][0], -q) for q in resident if bwd_q[q]]
            if cands:   # one backward: oldest microbatch first
                q = -min(cands)[1]
                stage = stages[q]
                mb, gout = bwd_q[q].popleft()
                xin, out = stored[q].pop(mb)
                if stage.is_last:
                    loss, gx = stage.last_forward_backward(
                        xin, _to_stage(ys[mb], stage), inv)
                    mb_losses.append(loss)
                else:
                    gx = stage.backward(xin, out, _to_stage(gout, stage), inv)
                if q > 0:
                    pending.append((bwd_q, q - 1, (mb, gx)))
                if schedule_trace is not None:
                    schedule_trace.append((tick, d, q, "bwd", mb))
                busy = True
            fcands = [q for q in resident if fwd_q[q]]
            if fcands:   # one forward: deepest resident chunk first
                q = max(fcands)
                stage = stages[q]
                mb, xin = fwd_q[q].popleft()
                xin = _to_stage(xin, stage)
                if stage.is_last:
                    stored[q][mb] = (xin, None)
                    pending.append((bwd_q, q, (mb, None)))
                else:
                    xin, out = stage.forward(xin)
                    stored[q][mb] = (xin, out)
                    pending.append((fwd_q, q + 1, (mb, _hidden(out).detach())))
                _note_stored(stage, len(stored[q]))
                if schedule_trace is not None:
                    schedule_trace.append((tick, d, q, "fwd", mb))
                busy = True
            per_dev_busy[d] += busy
            dev_max_stored[d] = max(dev_max_stored[d],
                                    sum(len(stored[q]) for q in resident))
        for queue, q, item in pending:
            queue[q].append(item)
        tick += 1
    if stats is not None:
        stats.update(
            ticks=tick, n_devices=D, n_virtual=V * D, v=V,
            bubble_fraction=round(1.0 - sum(per_dev_busy) / (D * tick), 4),
            per_device_busy=list(per_dev_busy),
            device_max_stored=list(dev_max_stored))
    return _step_all(stages, mb_losses, lr)


@dataclass
class PipeResult:
    """The reference's results schema (upstream's ``gpipe.py:205-218``
    extended), key for key.  One value differs: the reference's
    ``memory_plan_mb`` is XLA's compile-time plan of each stage's
    backward program, which has no torch counterpart; the port fills it
    with each stage's accounted bytes (``PipelineStage.memory_plan_mb``),
    and ``memory_source`` reads ``"accounted"`` where the allocator
    reports nothing (the CPU), where the reference reads
    ``"compiled_plan"``.  ``as_dict`` then drops the zero peaks, as the
    reference does.  ``peak_memory_mb`` is keyed by card, not by stage:
    stages that share a card share its allocator, so each card's peak
    counts once in ``total_peak_memory_mb``."""
    schedule: str
    final_loss: float
    avg_loss: float
    total_time_s: float
    avg_epoch_time_s: float
    epochs_per_s: float
    n_stages: int = 0       # the virtual-stage count of interleaved runs
    n_micro: int = 0
    losses: list = field(default_factory=list)
    peak_memory_mb: dict = field(default_factory=dict)
    total_peak_memory_mb: float = 0.0
    memory_source: str = "allocator"
    memory_plan_mb: dict = field(default_factory=dict)
    max_stored_activations: dict = field(default_factory=dict)
    activation_mb_per_microbatch: dict = field(default_factory=dict)
    schedule_stats: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        d = asdict(self)
        if self.memory_source == "accounted":
            del d["peak_memory_mb"], d["total_peak_memory_mb"]
        return d


def train_pipeline(stages: list[PipelineStage], schedule: str,
                   make_batch: Callable[[int], tuple],
                   num_epochs: int, n_micro: int = 4,
                   lr: float | Callable[[int], float] = 1e-3,
                   log: Callable | None = None,
                   start_epoch: int = 0,
                   should_stop: Callable[[int], bool] | None = None
                   ) -> PipeResult:
    """The epoch loop and its metrics: ``make_batch(epoch)`` gives each
    epoch's batch, ``lr`` a float or a schedule ``epoch -> lr``, ``log(epoch,
    loss)`` is called after each epoch.  ``start_epoch`` and
    ``should_stop(epoch)`` (polled before each epoch) are the resume and
    preemption seams of the reference's ``scripts/_pp_driver.py``;
    ``train/pipeline.py`` has neither yet (ROADMAP.md A8), so they stay
    plain parameters."""
    sched_stats: dict = {}
    if schedule == "interleaved":
        def run(stages, x, y, n_micro, lr):
            return run_interleaved_1f1b(stages, x, y, n_micro=n_micro,
                                        lr=lr, stats=sched_stats)
    else:
        run = {"gpipe": run_gpipe, "1f1b": run_1f1b}[schedule]
    lr_fn = lr if callable(lr) else (lambda _e: lr)
    losses = []
    t0 = time.perf_counter()
    for epoch in range(start_epoch, num_epochs):
        if should_stop is not None and should_stop(epoch):
            break
        x, y = make_batch(epoch)
        loss = run(stages, x, y, n_micro=n_micro, lr=lr_fn(epoch))
        losses.append(loss)
        if log:
            log(epoch, loss)
    total = time.perf_counter() - t0
    n_run = max(len(losses), 1)
    peaks = {str(d): device_memory_stats(d)["peak_bytes_in_use"] / MB
             for d in dict.fromkeys(s.device for s in stages)}
    return PipeResult(
        schedule=schedule,
        n_stages=len(stages),
        n_micro=n_micro,
        final_loss=losses[-1] if losses else float("nan"),
        avg_loss=sum(losses) / n_run if losses else float("nan"),
        losses=[round(float(l), 6) for l in losses],
        total_time_s=total,
        avg_epoch_time_s=total / n_run,
        epochs_per_s=n_run / total if total else 0.0,
        peak_memory_mb=peaks,
        total_peak_memory_mb=sum(peaks.values()),
        memory_source="allocator" if any(peaks.values()) else "accounted",
        memory_plan_mb={f"device_{i}": round(s.memory_plan_mb(), 1)
                        for i, s in enumerate(stages)},
        max_stored_activations={f"device_{i}": s.max_stored
                                for i, s in enumerate(stages)},
        activation_mb_per_microbatch={
            f"device_{i}": round(_input_bytes(s) / MB, 3)
            for i, s in enumerate(stages)},
        schedule_stats=sched_stats,
    )

"""The remat policies at every precision other than bf16
(``models/transformer.py`` ``_saved_ops``, ``resolve_remat_policy``;
``ops/quant.py``'s projection ops) against the JAX reference, on the
CPU, TINY_LM in f32 with remat on and bridged weights.

Tiers, each with its reason:
- loss and every grad leaf against the reference's jitted ``lm_loss``
  under the same config: at ``save_dots``, the tier of each precision's
  existing test (int8: ``test_torch_int8.py``'s, rtol 1e-5 and atol
  1e-5 of the leaf's max; fp8: ``test_torch_train.py``'s, atol
  ``FP8_LEAF_ATOL`` of the leaf's max, one flipped fp8 rounding); at
  ``save_dots_q8``, ``test_torch_remat.py``'s q8 tier (loss rtol 1e-5,
  each leaf's relative L2 distance at most ``Q8_GRAD_REL_L2``: a product
  an f32 rounding apart in XLA and torch may round to the neighbouring
  int8 code).
- the port under each policy against itself under ``full``: ``save_dots``
  keeps values and changes none, so bit-equal; ``save_dots_q8`` sends
  every projection output through the int8 round-trip, so its loss lies
  within ``Q8_LOSS_RTOL`` of ``full``'s (and not on it: the round-trip
  ran), the loss tier of the card's remat gate (``chip_smoke.py``
  ``REMAT_Q8_LOSS_RTOL``).
- the kept-set law: what the port's policy keeps in the forward
  (``transformer.record_kept``: a dispatch mode inside the selective
  checkpoint's forward context; the checkpoint's own saved-tensor hooks
  shadow any outer ``saved_tensors_hooks`` there) against the
  reference's ``jax.ad_checkpoint.print_saved_residuals`` of ``lm_loss``
  beyond its ``full`` residuals, entry for entry by element count and
  dtype, the reference's stacked ``(L, …)`` scan outputs as L port
  entries.  The one allowed difference: at ``int8`` and ``int8_bwd`` the
  reference keeps its XLA int8 dot's int32 accumulator, which K4 (its
  epilogue fused) never writes, so the port keeps K4's output in the
  activation dtype, the same element count.  And, counted through
  ``torch.autograd.graph.saved_tensors_hooks``, the tensors autograd
  saves outside the policy's cache are the same under every policy.
- the recompute law: the projection ops dispatched in a step (forward,
  recompute), counted by a dispatch mode.  ``full`` and ``save_dots`` at
  a ``*_pallas`` precision replay every projection; ``save_dots`` at the
  other precisions and ``save_dots_q8`` at every precision replay only
  the MLP's down projection, which no policy keeps; under
  ``save_dots_q8`` each projection is the fused ``dot_q8`` op, so no
  precision runs a kept projection's product again.
"""

import collections
import contextlib
import dataclasses
import io
import re

import jax
import jax.ad_checkpoint
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from distributed_training_sandbox_tpu.models import transformer as JT
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.models import transformer as PT
from distributed_training_sandbox_tpu_torch.ops import quant as PQ
torch.set_num_threads(1)  # the suite's workers share the cores

PRECISIONS = [p for p in PT.PRECISIONS if p != "bf16"]
POLICIES = ("save_dots", "save_dots_q8")
L = JT.TINY_LM.num_hidden_layers
TOL = dict(rtol=1e-5, atol=1e-5)
FP8_LEAF_ATOL = 5e-3
Q8_GRAD_REL_L2 = 5e-3
Q8_LOSS_RTOL = 2e-2
# the reference's XLA int8 dot keeps an int32 accumulator; K4 writes the
# activation dtype (TINY_LM: f32) — the one difference the law allows
K4_DTYPE_DIFFERENCE = {"int8": ("i32", "f32"), "int8_bwd": ("i32", "f32")}
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "i8",
           torch.int32: "i32"}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _batch(seed=6, B=2, S=16):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, PT.TINY_LM.vocab_size, size=(B, S + 1))
    return w[:, :-1].astype(np.int32), w[:, 1:].astype(np.int32)


def _jcfg(precision, policy):
    return dataclasses.replace(JT.TINY_LM, remat=True, remat_policy=policy,
                               matmul_precision=precision)


def _residuals(jp, batch, precision, policy) -> collections.Counter:
    """The reference's saved residuals of ``lm_loss``: (dtype, shape)."""
    cfg = _jcfg(precision, policy)
    ids, labels = map(jnp.asarray, batch)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax.ad_checkpoint.print_saved_residuals(
            lambda p: JT.lm_loss(p, (ids, labels), cfg), jp)
    out = collections.Counter()
    for line in buf.getvalue().splitlines():
        m = re.match(r"(\w+)\[([\d,]*)\]", line.strip())
        assert m, line
        shape = tuple(int(d) for d in m.group(2).split(",") if d)
        out[m.group(1), shape] += 1
    return out


@pytest.fixture(scope="module")
def reference():
    """The reference's weights, one batch, and for each precision its
    loss and grads under ``save_dots`` and ``save_dots_q8`` and its kept
    residuals beyond ``full``'s."""
    jp = JT.init_params(jax.random.PRNGKey(0), JT.TINY_LM)
    batch = _batch()
    values, kept = {}, {}
    for precision in PRECISIONS:
        full = _residuals(jp, batch, precision, "full")
        for policy in POLICIES:
            cfg = _jcfg(precision, policy)
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p, b, cfg=cfg: JT.lm_loss(p, b, cfg)))(
                jp, tuple(map(jnp.asarray, batch)))
            values[precision, policy] = (
                float(loss), dict(_flat(jax.tree.map(np.asarray, grads))))
            res = _residuals(jp, batch, precision, policy)
            assert not full - res, (precision, policy)   # full's are kept
            kept[precision, policy] = res - full
    return jax.tree.map(np.asarray, jp), batch, values, kept


class _OpCounts(TorchDispatchMode):
    """Calls of each dispatcher op while the mode is on."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] += 1
        return func(*args, **(kwargs or {}))


def _port_step(jp, batch, precision, policy):
    """(loss, grads by name, kept entries, saved-tensor-hook entries, op
    counts of the step)."""
    cfg = dataclasses.replace(PT.TINY_LM, remat=True, remat_policy=policy,
                              matmul_precision=precision)
    pp = bridge.params_from_jax(jp, cfg)
    names = [n for n, _ in _flat(pp)]
    leaves = [v.requires_grad_(True) for _, v in _flat(pp)]
    hooked = collections.Counter()

    def pack(t):
        hooked[_DTYPES.get(t.dtype, str(t.dtype)), t.numel()] += 1
        return t

    with _OpCounts() as ops:
        with PT.record_kept() as entries, \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = PT.lm_loss(pp, tuple(map(torch.from_numpy, batch)), cfg)
        grads = torch.autograd.grad(loss, leaves)
    return (loss.item(), {n: g.numpy() for n, g in zip(names, grads)},
            entries, hooked, ops.n)


@pytest.fixture(scope="module")
def port(reference):
    jp, batch, _, _ = reference
    return {(precision, policy): _port_step(jp, batch, precision, policy)
            for precision in PRECISIONS
            for policy in ("full",) + POLICIES}


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_loss_and_every_grad_leaf_match_the_reference(reference, port,
                                                      precision, policy):
    _, _, values, _ = reference
    jl, jg = values[precision, policy]
    loss, grads, *_ = port[precision, policy]
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    assert sorted(grads) == sorted(jg)
    for name, g in grads.items():
        ref = jg[name]
        if policy == "save_dots_q8":
            assert _rel_l2(g, ref) <= Q8_GRAD_REL_L2, (name, _rel_l2(g, ref))
        else:
            leaf_atol = (FP8_LEAF_ATOL if precision.startswith("fp8")
                         else TOL["atol"])
            np.testing.assert_allclose(
                g, ref, err_msg=name, rtol=1e-5,
                atol=leaf_atol * float(np.abs(ref).max()))


@pytest.mark.parametrize("precision", PRECISIONS)
def test_each_policy_against_full(port, precision):
    l0, g0, kept0, *_ = port[precision, "full"]
    assert kept0 == []
    loss, grads, *_ = port[precision, "save_dots"]
    assert loss == l0
    for name, g in grads.items():
        np.testing.assert_array_equal(g, g0[name], err_msg=name)
    # the q8 tier is the loss's (its grads are held against the
    # reference's own save_dots_q8 grads above): at fp8 the round-trip's
    # noise flips upstream fp8 roundings, which moves small leaves
    # (layers/ln1 0.086 rel. L2 from full's)
    loss, grads, *_ = port[precision, "save_dots_q8"]
    assert 0 < abs(loss - l0) <= Q8_LOSS_RTOL * abs(l0)
    assert sorted(grads) == sorted(g0)
    assert all(np.isfinite(g).all() for g in grads.values())


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_kept_set_law(reference, port, precision, policy):
    _, _, _, kept = reference
    want = collections.Counter()
    for (dtype, shape), count in kept[precision, policy].items():
        assert shape[0] == L, (dtype, shape)   # a stacked scan output
        if policy == "save_dots" and precision in K4_DTYPE_DIFFERENCE:
            ref_dt, port_dt = K4_DTYPE_DIFFERENCE[precision]
            assert dtype == ref_dt
            dtype = port_dt
        want[dtype, int(np.prod(shape[1:]))] += count * L
    _, _, entries, *_ = port[precision, policy]
    got = collections.Counter((_DTYPES[dt], int(np.prod(shape)))
                              for shape, dt, _ in entries)
    assert got == want
    if policy == "save_dots" and precision.endswith(("pallas", "pallas_bwd")):
        assert got == collections.Counter()   # a kernel is no dot
    ops = {op for _, _, op in entries}
    if policy == "save_dots_q8":
        assert ops == {str(PQ.DOT_Q8_OP)}
    elif got:
        assert ops == {str(PQ.INT8_DENSE_OP if precision.startswith("int8")
                           else PQ.FP8_DENSE_OP)}


@pytest.mark.parametrize("precision", PRECISIONS)
def test_the_policy_adds_only_its_cache(port, precision):
    """What autograd saves outside the policy's cache (the checkpoints'
    inputs, the loss's tensors) is the same under every policy."""
    hooked = [port[precision, p][3] for p in ("full",) + POLICIES]
    assert hooked[0] and hooked[1] == hooked[0] and hooked[2] == hooked[0]


@pytest.mark.parametrize("policy", ("full",) + POLICIES)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_the_recompute_replays_only_what_is_not_kept(port, precision,
                                                     policy):
    ops = port[precision, policy][4]
    proj = (PQ.INT8_DENSE_OP if precision.startswith("int8")
            else PQ.FP8_DENSE_OP)
    n = 7 * L   # the projections a forward runs
    if policy == "save_dots_q8":
        # the fused op everywhere; the recompute runs the down
        # projection's only
        assert (ops[PQ.DOT_Q8_OP], ops[proj]) == (n + L, 0)
        return
    replayed = n if policy == "full" or precision.endswith(
        ("pallas", "pallas_bwd")) else L
    assert (ops[PQ.DOT_Q8_OP], ops[proj]) == (0, n + replayed)

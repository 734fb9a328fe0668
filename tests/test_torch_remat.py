"""The port's remat policies (``models/transformer.py``
``resolve_remat_policy``) and ``quantized_residual`` (``ops/quant.py``)
against the JAX reference, on the CPU, and the precision benchmark's
twin (``train/precision_benchmark.py``).

Tiers, each with its reason:
- ``quantized_residual``: its int8 codes and scales, and so its output,
  are bit-equal to the jitted reference's; its grad is the identity.
- TINY_LM in f32 (remat on, bridged weights): under ``full``,
  ``save_attn`` and ``save_dots`` the loss and every grad leaf at
  ``test_torch_train.py``'s tier (rtol 1e-5, atol 1e-5): the policy
  changes what is kept, not what is computed, and the port's own three
  are bit-equal.  Under ``save_dots_q8`` every projection output makes
  an int8 round-trip, and a product that lands an f32 rounding apart
  in XLA and torch may round to the neighbouring code, which moves the
  grads it feeds: the loss rtol 1e-5, each grad leaf's relative L2
  distance at most ``Q8_GRAD_REL_L2``.  Read on batch seeds 6–11: 0.0019
  and 0.0023 where a code flipped, 5e-7 where none did; the reference's
  own ``full`` step reads 0.0099–0.0101 against its ``save_dots_q8``, so
  the limit fails a port that skipped the round-trip.
- The recompute counts: attention calls a step (``FWD_COUNTS`` of the
  attention op, on the CPU the plain path's): ``2·L`` under ``full``
  (forward and recompute), ``L`` under ``save_attn``, ``2·L`` under
  ``save_dots`` and ``save_dots_q8``, which keep only the projections,
  as the reference's policies do; the projection products run once a
  layer under ``save_dots`` and ``save_dots_q8`` and twice under
  ``full``.
"""

import dataclasses
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from distributed_training_sandbox_tpu.models import transformer as JT
from distributed_training_sandbox_tpu.ops import quant as JQ
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.models import transformer as PT
from distributed_training_sandbox_tpu_torch.ops import flash_attention as FA
from distributed_training_sandbox_tpu_torch.ops import quant as PQ
from distributed_training_sandbox_tpu_torch.parallel import fsdp as PF
torch.set_num_threads(1)  # the suite's workers share the cores

POLICIES = PT.REMAT_POLICIES
TOL = dict(rtol=1e-5, atol=1e-5)
Q8_GRAD_REL_L2 = 5e-3
L = JT.TINY_LM.num_hidden_layers


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_residual_is_the_references_round_trip(dtype):
    rng = np.random.default_rng(0)
    y = (rng.standard_normal((3, 8, 64)) * 3.0).astype(np.float32)
    y[1, 2] = 0
    jy = jnp.asarray(y, getattr(jnp, dtype))
    py = torch.from_numpy(np.asarray(jy, np.float32)).to(
        getattr(torch, dtype)).requires_grad_(True)
    want = jax.jit(JQ.quantized_residual)(jy)
    got = PQ.quantized_residual(py)
    jq, js = jax.jit(lambda t: JQ.quantize_int8(t, -1))(jy)
    pq, ps = PQ.quantize_int8(py.detach(), -1)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want, np.float32))
    c = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    (g,) = torch.autograd.grad((got.float() * c).sum(), py)
    assert torch.equal(g.float(), c.to(g.dtype).float())   # straight through
    jg = jax.grad(lambda t: jnp.sum(JQ.quantized_residual(t)
                                    .astype(jnp.float32)
                                    * jnp.asarray(c.numpy())))(jy)
    np.testing.assert_array_equal(g.float().numpy(),
                                  np.asarray(jg, np.float32))


def test_dot_q8_is_the_round_trip_of_the_product_with_its_grads():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((2, 8, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((32, 24)).astype(np.float32))
    a.requires_grad_(True)
    w.requires_grad_(True)
    got = PQ.dot_q8(a, w)
    want = PQ.quantized_residual(a @ w)
    assert torch.equal(got, want)
    c = torch.from_numpy(rng.standard_normal(got.shape).astype(np.float32))
    ga, gw = torch.autograd.grad((got * c).sum(), (a, w))
    ra, rw = torch.autograd.grad((want * c).sum(), (a, w))
    np.testing.assert_allclose(ga.numpy(), ra.numpy(), **TOL)
    np.testing.assert_allclose(gw.numpy(), rw.numpy(), **TOL)


def _batch(seed=6, B=2, S=16):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, PT.TINY_LM.vocab_size, size=(B, S + 1))
    return w[:, :-1].astype(np.int32), w[:, 1:].astype(np.int32)


@pytest.fixture(scope="module")
def reference():
    """The reference's TINY_LM loss and grads under each policy (remat
    on), and its weights."""
    jp = JT.init_params(jax.random.PRNGKey(0), JT.TINY_LM)
    ids, labels = _batch()
    out = {}
    for policy in POLICIES:
        cfg = dataclasses.replace(JT.TINY_LM, remat=True,
                                  remat_policy=policy)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b, cfg=cfg: JT.lm_loss(p, b, cfg)))(
            jp, (jnp.asarray(ids), jnp.asarray(labels)))
        out[policy] = (float(loss),
                       dict(_flat(jax.tree.map(np.asarray, grads))))
    return jax.tree.map(np.asarray, jp), (ids, labels), out


class _OpCounts(TorchDispatchMode):
    """Calls of each dispatcher op while the mode is on."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] = self.n.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _port_step(jp, batch, policy, attention="xla"):
    """(loss, grads by name, attention forward calls, op counts)."""
    cfg = dataclasses.replace(PT.TINY_LM, remat=True, remat_policy=policy,
                              attention_impl=attention)
    pp = bridge.params_from_jax(jp, cfg)
    names = [n for n, _ in _flat(pp)]
    leaves = [v.requires_grad_(True) for _, v in _flat(pp)]
    FA.FWD_COUNTS.reset()
    with _OpCounts() as ops:
        loss = PT.lm_loss(pp, tuple(map(torch.from_numpy, batch)), cfg)
        grads = torch.autograd.grad(loss, leaves)
    return (loss.item(), {n: g.numpy() for n, g in zip(names, grads)},
            FA.FWD_COUNTS.plain_calls, ops.n)


@pytest.mark.parametrize("policy", POLICIES)
def test_loss_and_every_grad_leaf_match_the_reference(reference, policy):
    jp, batch, ref = reference
    jl, jg = ref[policy]
    loss, grads, _, _ = _port_step(jp, batch, policy)
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    assert sorted(grads) == sorted(jg)
    for name, g in grads.items():
        if policy == "save_dots_q8":
            rel = np.linalg.norm(g - jg[name]) / np.linalg.norm(jg[name])
            assert rel <= Q8_GRAD_REL_L2, (name, rel)
        else:
            np.testing.assert_allclose(g, jg[name], err_msg=name, **TOL)


def test_saving_policies_compute_what_full_computes(reference):
    """``save_attn`` and ``save_dots`` keep values, they change none: the
    loss and every grad bit-equal to ``full``'s."""
    jp, batch, _ = reference
    l0, g0, _, _ = _port_step(jp, batch, "full")
    for policy in ("save_attn", "save_dots"):
        loss, grads, _, _ = _port_step(jp, batch, policy)
        assert loss == l0, policy
        for name, g in grads.items():
            np.testing.assert_array_equal(g, g0[name], err_msg=name)


@pytest.mark.parametrize("attention", ["xla", "flash"])
@pytest.mark.parametrize("policy", POLICIES)
def test_recompute_counts(reference, policy, attention):
    jp, batch, _ = reference
    _, _, attn_calls, ops = _port_step(jp, batch, policy, attention)
    assert attn_calls == (L if policy == "save_attn" else 2 * L)
    mm = ops.get(torch.ops.aten.mm.default, 0)
    dq8 = ops.get(torch.ops.dtsb_torch.dot_q8.default, 0)
    fa = ops.get(torch.ops.dtsb_torch.attention_fwd.default, 0)
    # the tied unembedding's loss products: 1 forward, 2 backward
    loss_mm = 3
    if policy == "save_dots_q8":
        # each projection once, as the fused op, none recomputed; the
        # backward's products are einsums (aten.bmm)
        assert (dq8, mm) == (7 * L, loss_mm)
    else:
        # forward 7 a layer, the recompute 7 more unless kept, backward 14
        fwd = 7 * L * (1 if policy == "save_dots" else 2)
        assert (dq8, mm) == (0, fwd + 14 * L + loss_mm)
    uses_op = attention == "flash" or policy == "save_attn"
    assert fa == (attn_calls if uses_op else 0)


def test_unported_options_raise():
    # the host offload of the kept activations: the reference's
    # offload="opt_act" (its offload_activations) waits for A12
    for policy in ("save_attn", "save_dots_q8"):
        with pytest.raises(NotImplementedError, match="A12"):
            PF.make_fsdp_train_step({}, dataclasses.replace(
                PT.TINY_LM, remat_policy=policy), offload="opt_act")
    for precision in ("int8_pallas", "int8_pallas_bwd", "fp8_pallas",
                      "int8", "fp8"):
        for policy in ("save_dots", "save_dots_q8"):
            cfg = dataclasses.replace(PT.TINY_LM, remat_policy=policy,
                                      matmul_precision=precision)
            with pytest.raises(NotImplementedError, match="A2"):
                PT.resolve_remat_policy(cfg)
    # save_attn needs no projection to be visible: it runs everywhere
    PT.resolve_remat_policy(dataclasses.replace(
        PT.TINY_LM, remat_policy="save_attn", matmul_precision="int8_pallas"))
    with pytest.raises(ValueError, match="remat_policy"):
        PT.check_supported(dataclasses.replace(PT.TINY_LM,
                                               remat_policy="save_all"))


def test_precision_benchmark_twin_writes_its_summary(tmp_path):
    subprocess.run(
        [sys.executable, "-m",
         "distributed_training_sandbox_tpu_torch.train.precision_benchmark",
         "--device", "cpu", "--model", "tiny", "--num-steps", "2",
         "--out-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, check=True)
    (summary,) = tmp_path.glob("summary_tiny_*.json")
    (row,) = json.loads(summary.read_text())
    assert set(row) == {"model", "precision", "sequence_length",
                        "num_devices", "batch_size", "steps_per_second",
                        "tokens_per_second", "tflops_per_device",
                        "avg_loss", "peak_memory"}
    assert set(row["peak_memory"]) == {"memory_plan_gb", "plan_formula",
                                       "model_mb", "optimizer_mb"}
    assert (row["model"], row["precision"], row["sequence_length"],
            row["num_devices"], row["batch_size"]) == ("tiny", "bf16", 256,
                                                       1, 1)
    assert np.isfinite(row["avg_loss"]) and row["tokens_per_second"] > 0
    assert (tmp_path / "tiny_bf16_seq256_b1_dev1.txt").read_text() \
        .startswith("step 0 loss ")

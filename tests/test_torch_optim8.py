"""The port's int8 Adam (``parallel/optim8.py``), ``lr_mults`` and the
pipeline's ``opt8`` stages against the JAX reference, on the CPU.

Tiers, each with its reason:
- The four quantisers are bit-equal to the jitted reference's (the
  division by 127 in the f32-reciprocal form XLA folds it into).
- One update from zero moments is bit-equal (params, codes, scales):
  ``b·0 + (1 - b)·g`` is the rounded product either way.  Later updates
  differ by XLA's contraction of ``b·m + (1 - b)·g`` into a fused
  multiply-add (ROADMAP.md C3): after five steps the params within
  1e-6, the scales within rtol 1e-5 and the dequantised moments within
  one code step of the reference's (``_assert_close_q8``).
- The pipeline's ``opt8`` stages: losses rtol 1e-5 and params at
  ``test_torch_pipeline.py``'s tiers (atol 1e-4 on the toy, 2e-4 on
  TINY_LM), the moments after step 0 as ``test_torch_pipeline.py``
  holds full moments: rtol 1e-5 with an atol of 1e-5 times the leaf's
  largest entry (the stages' grads sum microbatches in other orders),
  the codes within one step.
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
from test_torch_pipeline import (JCFG, LR, N_MICRO, PCFG, _lm_inputs,
                                 _toy_inputs)

from distributed_training_sandbox_tpu.models import mlp as JM
from distributed_training_sandbox_tpu.models import transformer as JT
from distributed_training_sandbox_tpu.parallel import optim as JO
from distributed_training_sandbox_tpu.parallel import optim8 as J8
from distributed_training_sandbox_tpu.parallel import pipeline as JP
from distributed_training_sandbox_tpu.utils.memory import tree_size_bytes
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.models import transformer as PT
from distributed_training_sandbox_tpu_torch.parallel import optim as PO
from distributed_training_sandbox_tpu_torch.parallel import optim8 as P8
from distributed_training_sandbox_tpu_torch.parallel import pipeline as PP
from distributed_training_sandbox_tpu_torch.utils import prng

QUANTISERS = ("_quant_linear", "_quant_sqrt")
DEQUANTISERS = ("_dequant_linear", "_dequant_sqrt")
SCALE_RTOL = 1e-5


def _draws(seed, n=8):
    """(16, 48) f32 draws over eight decades, one with an all-zero row."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x = (rng.standard_normal((16, 48))
             * 10.0 ** rng.uniform(-9, 2)).astype(np.float32)
        if i == 0:
            x[3] = 0
        out.append(x)
    return out


@pytest.mark.parametrize("name", QUANTISERS)
def test_quantisers_are_bitwise_jitted_jax(name):
    jf, pf = jax.jit(getattr(J8, name)), getattr(P8, name)
    for x in _draws(1):
        if name == "_quant_sqrt":
            x = x * x
        want, got = jf(jnp.asarray(x)), pf(torch.from_numpy(x))
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(want.scale))


def test_square_root_is_correctly_rounded():
    """``optim8._sqrt`` is the correctly rounded f32 root (numpy's, and
    the jitted reference's), which CUDA's ``torch.sqrt`` also gives: so
    the card's update and the CPU's agree bit for bit."""
    rng = np.random.default_rng(7)
    v = (rng.random(1_000_000) * 10.0 ** rng.uniform(-14, -2, 1_000_000)) \
        .astype(np.float32)
    got = P8._sqrt(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, np.sqrt(v))
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jnp.sqrt)(v)))


@pytest.mark.parametrize("name", DEQUANTISERS)
def test_dequantisers_are_bitwise_jitted_jax(name):
    rng = np.random.default_rng(2)
    lo = -127 if name == "_dequant_linear" else 0
    for _ in range(4):
        q = rng.integers(lo, 128, (16, 48)).astype(np.int8)
        s = np.abs(rng.standard_normal((16, 1))).astype(np.float32) * 1e-3
        want = jax.jit(getattr(J8, name))(J8.Q8(jnp.asarray(q),
                                                jnp.asarray(s)))
        got = getattr(P8, name)(P8.Q8(torch.from_numpy(q),
                                      torch.from_numpy(s)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_adam8_init_layout_is_the_references():
    params = {"w": np.ones((4, 8), np.float32),
              "stack": np.ones((2, 4, 8), np.float32),
              "norm": np.ones((8,), np.float32)}
    want = J8.adam8_init(jax.tree.map(jnp.asarray, params))
    got = P8.adam8_init({k: torch.from_numpy(v) for k, v in params.items()})
    assert got.count == int(want.count) == 0
    for k in params:
        w, g = want.mu[k], got.mu[k]
        assert isinstance(g, P8.Q8) == isinstance(w, J8.Q8)
        if isinstance(g, P8.Q8):
            assert g.q.dtype == torch.int8 and g.scale.dtype == torch.float32
            assert tuple(g.q.shape) == w.q.shape
            assert tuple(g.scale.shape) == w.scale.shape == \
                params[k].shape[:-1] + (1,)
        else:
            assert tuple(g.shape) == w.shape and g.dtype == torch.float32


def _problem(seed):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((16, 64)).astype(np.float32),
              "stack": rng.standard_normal((2, 8, 32)).astype(np.float32),
              "norm": rng.standard_normal((64,)).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * 10.0 ** rng.uniform(-4, 0))
              .astype(np.float32) for k, v in params.items()}
             for _ in range(5)]
    return params, grads


def _run_both(params, grads, steps, lr_mults=None, opt8=True):
    jmod, pmod = (J8, P8) if opt8 else (JO, PO)
    jinit = jmod.adam8_init if opt8 else jmod.adam_init
    pinit = pmod.adam8_init if opt8 else pmod.adam_init
    jupd = jmod.adam8_update if opt8 else jmod.adam_update
    pupd = pmod.adam8_update if opt8 else pmod.adam_update
    jp = jax.tree.map(jnp.asarray, params)
    js = jinit(jp)
    upd = jax.jit(lambda g, s, p: jupd(g, s, p, lr=1e-2, lr_mults=lr_mults))
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ps = pinit(pp)
    for g in grads[:steps]:
        jp, js = upd(jax.tree.map(jnp.asarray, g), js, jp)
        pp, ps = pupd({k: torch.from_numpy(v) for k, v in g.items()}, ps, pp,
                      lr=1e-2, lr_mults=lr_mults)
    return (jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)), \
        (bridge.params_to_numpy(pp), ps)


def test_one_adam8_step_is_bitwise():
    params, grads = _problem(3)
    (jp, js), (pp, ps) = _run_both(params, grads, 1)
    assert ps.count == int(js.count) == 1
    for k in params:
        np.testing.assert_array_equal(pp[k], jp[k], err_msg=k)
        for mom in ("mu", "nu"):
            w, g = getattr(js, mom)[k], getattr(ps, mom)[k]
            if isinstance(g, P8.Q8):
                np.testing.assert_array_equal(g.q.numpy(), w.q)
                np.testing.assert_array_equal(g.scale.numpy(), w.scale)
            else:
                np.testing.assert_array_equal(g.numpy(), w)


def _assert_close_q8(g, w, err_msg):
    """Scales at ``SCALE_RTOL`` (with an atol of ``SCALE_RTOL`` times the
    leaf's largest, for rows whose entries cancel to near zero), and the
    dequantised moments within one code step plus the scales' own
    difference over 127 codes."""
    s, ws = g.scale.numpy(), np.asarray(w.scale)
    atol = SCALE_RTOL * float(ws.max())
    np.testing.assert_allclose(s, ws, rtol=SCALE_RTOL, atol=atol,
                               err_msg=err_msg)
    deq = g.q.numpy().astype(np.float64) * s
    jdeq = np.asarray(w.q).astype(np.float64) * ws
    assert np.all(np.abs(deq - jdeq)
                  <= s + 127 * (SCALE_RTOL * ws + atol)), err_msg


def test_five_adam8_steps_track_the_reference():
    params, grads = _problem(4)
    (jp, js), (pp, ps) = _run_both(params, grads, 5)
    assert ps.count == int(js.count) == 5
    for k in params:
        np.testing.assert_allclose(pp[k], jp[k], rtol=0, atol=1e-6,
                                   err_msg=k)
        for mom in ("mu", "nu"):
            w, g = getattr(js, mom)[k], getattr(ps, mom)[k]
            if isinstance(g, P8.Q8):
                _assert_close_q8(g, w, f"{mom}/{k}")
            else:
                np.testing.assert_allclose(g.numpy(), w, rtol=SCALE_RTOL,
                                           atol=1e-12, err_msg=f"{mom}/{k}")


@pytest.mark.parametrize("opt8", [False, True], ids=["adam", "adam8"])
def test_lr_mults_scale_each_leafs_step(opt8):
    """A tree of per-leaf multipliers: 0 freezes a leaf, 0.1 slows it;
    one step from zero moments is bit-equal to the reference's."""
    params, grads = _problem(5)
    mults = {"w": 0.1, "stack": 1.0, "norm": 0.0}
    (jp, _), (pp, _) = _run_both(params, grads, 1, lr_mults=mults, opt8=opt8)
    for k in params:
        np.testing.assert_array_equal(pp[k], jp[k], err_msg=k)
    np.testing.assert_array_equal(pp["norm"], params["norm"])
    (_, _), (full, _) = _run_both(params, grads, 1, opt8=opt8)
    moved = np.abs(pp["w"] - params["w"]).max()
    assert moved == pytest.approx(0.1 * np.abs(full["w"] - params["w"]).max(),
                                  rel=1e-3)


def test_at_rest_bytes_are_about_half_of_bf16_adams():
    """As ``tests/test_optim8.py`` states for the reference: bf16 moments
    take twice the params' bytes, int8 moments about the params' own."""
    cfg = dataclasses.replace(PT.TINY_LM, dtype=torch.bfloat16)
    params = PT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    pb = sum(t.numel() * t.element_size()
             for _, t in PO.tree_leaves(params))
    assert P8.state_bytes(PO.adam_init(params)) == 2 * pb
    sb8 = P8.state_bytes(P8.adam8_init(params))
    assert sb8 < 1.2 * pb
    jcfg = dataclasses.replace(JT.TINY_LM, dtype=jnp.bfloat16)
    jst = J8.adam8_init(JT.init_params(jax.random.PRNGKey(0), jcfg))
    assert sb8 == tree_size_bytes((jst.mu, jst.nu))


def test_update_writes_the_states_own_buffers():
    """Requantised into the same int8 and scale tensors: no second copy
    of the state at rest."""
    params, grads = _problem(6)
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    st = P8.adam8_init(pp)
    ptrs = [(t.q.data_ptr(), t.scale.data_ptr()) if isinstance(t, P8.Q8)
            else t.data_ptr() for _, t in PO.tree_leaves(st.mu)]
    _, st2 = P8.adam8_update({k: torch.from_numpy(v) for k, v in
                              grads[0].items()}, st, pp, lr=1e-2)
    assert ptrs == [(t.q.data_ptr(), t.scale.data_ptr())
                    if isinstance(t, P8.Q8) else t.data_ptr()
                    for _, t in PO.tree_leaves(st2.mu)]


def test_prng_seeds_every_stream_and_ranks_differ():
    g1, g2 = prng.set_seed(7), prng.set_seed(7)
    assert torch.equal(torch.rand(4, generator=g1), torch.rand(4, generator=g2))
    prng.set_seed(7)
    a = (np.random.rand(), torch.rand(1))
    prng.set_seed(7)
    assert (np.random.rand(), torch.rand(1)) == a
    k0 = prng.key_for_axis(7)
    assert torch.equal(torch.rand(3, generator=k0),
                       torch.rand(3, generator=prng.key_for_axis(7)))


# -------------------------------------------------------- the pipeline

def _jax_toy_stages(params, n):
    """The reference's PP toy stages with ``opt8`` (its ``build_pipeline``
    has no such argument; its ``PipelineStage`` has)."""
    from functools import partial
    devs = jax.local_devices()
    stages = []
    for s, chunk in enumerate(JP.split_stages(params, n)):
        last = s == n - 1
        stages.append(JP.PipelineStage(
            chunk, devs[s % len(devs)],
            partial(JM.mlp_apply_stage, last_stage=last), is_last=last,
            opt8=True))
    return stages


def _state(pkg, stages):
    if pkg is PP:
        return bridge.pipeline_stages_to_numpy(stages)
    copy = lambda t: jax.tree.map(np.array, t)
    return [{"params": copy(s.params), "mu": copy(s.opt_state.mu),
             "nu": copy(s.opt_state.nu), "count": int(s.opt_state.count)}
            for s in stages]


def _train(pkg, stages, batches, tensor):
    losses, states = [], []
    for x, y in batches:
        losses.append(float(pkg.run_1f1b(stages, tensor(x), tensor(y),
                                         n_micro=N_MICRO, lr=LR)))
        states.append(_state(pkg, stages))
    return losses, states


def _walk(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _assert_stages(got, want, atol, moments):
    for s, (g, w) in enumerate(zip(got, want, strict=True)):
        assert g["count"] == w["count"]
        for path, a in PO.tree_leaves(g["params"]):
            np.testing.assert_allclose(a, np.asarray(_walk(w["params"], path)),
                                       rtol=atol, atol=atol,
                                       err_msg=f"stage {s} {path}")
        if not moments:
            continue
        for key in ("mu", "nu"):
            for path, a in PO.tree_leaves(g[key]):
                b = _walk(w[key], path)
                if isinstance(a, P8.Q8):
                    _assert_close_q8(P8.Q8(torch.from_numpy(a.q),
                                           torch.from_numpy(a.scale)), b,
                                     f"stage {s} {key} {path}")
                else:
                    np.testing.assert_allclose(
                        a, b, rtol=SCALE_RTOL,
                        atol=SCALE_RTOL * float(np.abs(b).max()),
                        err_msg=f"stage {s} {key} {path}")


@pytest.mark.parametrize("model", ["toy", "lm"])
def test_opt8_pipeline_matches_jax(model):
    if model == "toy":
        params, batches = _toy_inputs()
        want = _train(JP, _jax_toy_stages(params, 2), batches, jnp.asarray)
        got = _train(PP, PP.build_pipeline(bridge.mlp_params_from_jax(params),
                                           2, devices=["cpu"], opt8=True),
                     batches, torch.from_numpy)
        atol = 1e-4
    else:
        params, batches = _lm_inputs()
        want = _train(JP, JP.build_transformer_pipeline(params, JCFG, 2,
                                                        opt8=True),
                      batches, jnp.asarray)
        got = _train(PP, PP.build_transformer_pipeline(
            bridge.params_from_jax(params, PCFG), PCFG, 2, devices=["cpu"],
            opt8=True), batches, torch.from_numpy)
        atol = 2e-4
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert any(isinstance(t, P8.Q8)
               for _, t in PO.tree_leaves(got[1][0][0]["mu"]))
    _assert_stages(got[1][0], want[1][0], atol, moments=True)
    _assert_stages(got[1][-1], want[1][-1], atol, moments=False)


def test_bridged_opt8_state_continues_as_jax():
    """The reference's opt8 stages after step 0 (params, int8 moments)
    loaded into fresh port stages: the port's step 1 lands where the
    reference's did."""
    params, batches = _toy_inputs()
    want = _train(JP, _jax_toy_stages(params, 2), batches, jnp.asarray)
    stages = PP.build_pipeline(bridge.mlp_params_from_jax(params), 2,
                               devices=["cpu"], opt8=True)
    bridge.load_pipeline_stages(stages, want[1][0])
    x, y = batches[1]
    loss = PP.run_1f1b(stages, torch.from_numpy(x), torch.from_numpy(y),
                       n_micro=N_MICRO, lr=LR)
    assert loss == pytest.approx(want[0][1], rel=1e-5)
    _assert_stages(bridge.pipeline_stages_to_numpy(stages), want[1][1], 1e-5,
                   moments=True)


def test_pipeline_twin_runs_opt8_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m",
         "distributed_training_sandbox_tpu_torch.train.pipeline", "--device",
         "cpu", "--schedule", "1f1b", "--num-epochs", "2", "--opt8"],
        capture_output=True, text=True, timeout=300, check=True).stdout
    line = next(l for l in out.splitlines() if l.startswith("[1f1b] {"))
    res = json.loads(line[len("[1f1b] "):])
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    assert res["contract"]["holds"]
    # int8 moments: the accounted state is about params + grads + codes
    full = subprocess.run(
        [sys.executable, "-m",
         "distributed_training_sandbox_tpu_torch.train.pipeline", "--device",
         "cpu", "--schedule", "1f1b", "--num-epochs", "2"],
        capture_output=True, text=True, timeout=300, check=True).stdout
    line = next(l for l in full.splitlines() if l.startswith("[1f1b] {"))
    plan_full = json.loads(line[len("[1f1b] "):])["memory_plan_mb"]
    for dev, mb in res["memory_plan_mb"].items():
        assert mb < 0.8 * plan_full[dev]

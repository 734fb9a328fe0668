"""The port's pipeline (``parallel/pipeline.py``, ``train/pipeline.py``)
against the JAX reference's, on the CPU, on the PP toy MLP and on untied
TINY_LM, with the reference's weights and batches carried across.

Each reference configuration runs once, in a module-scoped fixture (the
reference jits three programs a stage), for ``STEPS`` steps; the port
runs the same schedule on the bridged params and batches.  The reference
places stages on distinct CPU devices of its 8-device mesh; the port
puts every stage on ``cpu`` and numbers its logical devices, so the
interleaved clock sees the same D.

Tolerances against JAX: losses rtol 1e-5; every stage param after
each step atol 1e-4 on the toy, the tier of ``test_torch_ddp_zero.py``
for Adam against JAX.  f32 products and means reduce in other orders in
XLA and torch, and Adam's first step is ``lr · g / (|g| + eps)``, so a
grad within a few eps of zero turns a last-bit difference into a share
of lr: one toy weight in 25 000 lands 1.5e-5 from the reference's,
every other within 1e-5.  On TINY_LM the reference's own tier for its
pipeline against its monolithic step (``tests/test_pipeline_transformer.py``:
rtol and atol 2e-4 on the params).  Traces, schedule statistics, high-water
marks and ``split_stages`` match exactly.  The port's own laws hold at
the reference's tiers (``tests/test_pipeline.py``): a schedule equals
one monolithic Adam step (loss rel 1e-5, params atol 1e-5 on the toy),
GPipe equals 1F1B (rel 1e-6), and V = 1 interleaving has the bubble
``(S - 1) / (M + S - 1)`` within 0.05.

Adam's first moment is ``(1 - b1) · g`` after one step, so the moments
hold each stage's summed microbatch grads, which the params cannot: an
early Adam step is ``lr · sign(g)`` whatever the grads' scale.  Both
moments are held to the reference's at rtol ``MOMENT_RTOL``, with an
atol of ``MOMENT_RTOL`` times the leaf's largest entry for the entries
that cancel to near zero (they read at most 1.01e-6 of it after step 0):
after every step on the toy, after step 0 on TINY_LM, whose params end
step 0 up to 2e-4 apart and so feed step 1 other grads.
"""

import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_sandbox_tpu.models import mlp as JM
from distributed_training_sandbox_tpu.models import transformer as JT
from distributed_training_sandbox_tpu.parallel import pipeline as JP
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.models import mlp as PM
from distributed_training_sandbox_tpu_torch.models import transformer as PT
from distributed_training_sandbox_tpu_torch.ops import collectives as C
from distributed_training_sandbox_tpu_torch.parallel import optim as PO
from distributed_training_sandbox_tpu_torch.parallel import pipeline as PP
from distributed_training_sandbox_tpu_torch.parallel.contracts import (
    step_collectives)

STEPS, N_MICRO, LR = 2, 4, 1e-3
JCFG = dataclasses.replace(JT.TINY_LM, tie_word_embeddings=False)
PCFG = dataclasses.replace(PT.TINY_LM, tie_word_embeddings=False)
# (schedule, stages): the interleaved runs place 2 or 4 virtual stages
# on 2 devices (V 1 and 2)
CONFIGS = [(s, n) for s in ("gpipe", "1f1b", "interleaved") for n in (2, 4)]
TRACE_1F1B = [(2, 4), (3, 5), (4, 8)]        # (stages, microbatches)
# Adam's moments against the reference's (module docstring)
MOMENT_RTOL = 1e-5
TRACE_INTERLEAVED = [(2, 1), (2, 2), (4, 2)]  # (devices, V)
# the reference's pinned 1F1B clock at 2 stages, 4 microbatches
# (tests/test_pipeline.py)
PINNED_1F1B = [
    (0, 0, "fwd", 0), (0, 1, "fwd", 0), (0, 1, "bwd", 0),
    (1, 0, "fwd", 1), (1, 0, "bwd", 0), (1, 1, "fwd", 1), (1, 1, "bwd", 1),
    (2, 0, "fwd", 2), (2, 0, "bwd", 1), (2, 1, "fwd", 2), (2, 1, "bwd", 2),
    (3, 0, "fwd", 3), (3, 0, "bwd", 2), (3, 1, "fwd", 3), (3, 1, "bwd", 3),
    (4, 0, "bwd", 3),
]


def _toy_inputs():
    # copies, as everywhere here: the reference's steps donate buffers
    params = jax.tree.map(np.array, JM.pp_toy_mlp(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    batches = [(rng.standard_normal((16, 50)).astype(np.float32),
                rng.standard_normal((16, 50)).astype(np.float32))
               for _ in range(STEPS)]
    return params, batches


def _lm_inputs():
    params = jax.tree.map(np.array,
                          JT.init_params(jax.random.PRNGKey(0), JCFG))
    rng = np.random.default_rng(2)
    batches = []
    for _ in range(STEPS):
        ids = rng.integers(0, JCFG.vocab_size, (8, 32)).astype(np.int32)
        batches.append((ids, np.roll(ids, -1, axis=1)))
    return params, batches


def _jax_stages(model, params, schedule, n):
    devs = jax.local_devices()[:2] if schedule == "interleaved" else None
    if model == "toy":
        return JP.build_pipeline(params, n, devices=devs)
    return JP.build_transformer_pipeline(params, JCFG, n, devices=devs)


def _port_stages(model, params, schedule, n, cfg=PCFG):
    devs = ["cpu"] * (2 if schedule == "interleaved" else 1)
    if model == "toy":
        return PP.build_pipeline(bridge.mlp_params_from_jax(params), n,
                                 devices=devs)
    return PP.build_transformer_pipeline(bridge.params_from_jax(params, cfg),
                                         cfg, n, devices=devs)


def _runner(pkg, schedule):
    return {"gpipe": pkg.run_gpipe, "1f1b": pkg.run_1f1b,
            "interleaved": pkg.run_interleaved_1f1b}[schedule]


def _train(pkg, stages, schedule, batches, tensor, n_micro=N_MICRO):
    """``STEPS`` steps; the step-0 trace and stats; the state after each
    step as numpy trees."""
    run = _runner(pkg, schedule)
    losses, trace, stats, states = [], [], {}, []
    for i, (x, y) in enumerate(batches):
        kw = {}
        if i == 0 and schedule != "gpipe":
            kw["schedule_trace"] = trace
        if i == 0 and schedule == "interleaved":
            kw["stats"] = stats
        losses.append(float(run(stages, tensor(x), tensor(y),
                                n_micro=n_micro, lr=LR, **kw)))
        states.append(_state(pkg, stages))
    return {"losses": losses, "trace": trace, "stats": stats,
            "states": states}


def _state(pkg, stages):
    if pkg is PP:
        return bridge.pipeline_stages_to_numpy(stages)
    copy = lambda t: jax.tree.map(np.array, t)
    return [{"params": copy(s.params), "mu": copy(s.opt_state.mu),
             "nu": copy(s.opt_state.nu), "count": int(s.opt_state.count)}
            for s in stages]


@pytest.fixture(scope="module")
def inputs():
    return {"toy": _toy_inputs(), "lm": _lm_inputs()}


@pytest.fixture(scope="module")
def reference(inputs):
    """Every configuration of ``CONFIGS`` on both models, through the JAX
    package."""
    out = {}
    for model, (params, batches) in inputs.items():
        for schedule, n in CONFIGS:
            stages = _jax_stages(model, params, schedule, n)
            out[model, schedule, n] = _train(JP, stages, schedule, batches,
                                             jnp.asarray)
    return out


def _port(inputs, model, schedule, n):
    params, batches = inputs[model]
    return _train(PP, _port_stages(model, params, schedule, n), schedule,
                  batches, torch.from_numpy)


def _walk(want, path):
    for k in path:
        want = want[k]
    return want


def _assert_stages(got, want, rtol, atol, moments=True):
    """Every stage's params within (rtol, atol) of the reference's, the
    Adam count equal, and (``moments``) Adam's mu and nu within
    ``MOMENT_RTOL`` of the reference's, each leaf with an atol of
    ``MOMENT_RTOL`` times its largest |reference| entry."""
    assert len(got) == len(want)
    for s, (g, w) in enumerate(zip(got, want)):
        for key in ("params", "mu", "nu") if moments else ("params",):
            leaves = list(PO.tree_leaves(g[key]))
            assert len(leaves) == len(jax.tree.leaves(w[key]))
            for path, a in leaves:
                b = np.asarray(_walk(w[key], path))
                tol = (rtol, atol) if key == "params" else (
                    MOMENT_RTOL, MOMENT_RTOL * float(np.abs(b).max()))
                np.testing.assert_allclose(a, b, rtol=tol[0], atol=tol[1],
                                           err_msg=f"stage {s} {key} {path}")
        assert g["count"] == w["count"]


@pytest.mark.parametrize("n", range(1, 9))
def test_split_stages_matches_the_reference(n):
    for n_stages in range(1, n + 1):
        assert PP.split_stages(list(range(n)), n_stages) == \
            JP.split_stages(list(range(n)), n_stages)


@pytest.mark.parametrize("schedule,n", CONFIGS)
def test_toy_schedules_match_jax(inputs, reference, schedule, n):
    got, want = _port(inputs, "toy", schedule, n), \
        reference["toy", schedule, n]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for i in range(STEPS):
        _assert_stages(got["states"][i], want["states"][i], 0, 1e-4)
    assert got["trace"] == want["trace"] and got["stats"] == want["stats"]


@pytest.mark.parametrize("schedule,n", CONFIGS)
def test_lm_schedules_match_jax(inputs, reference, schedule, n):
    got, want = _port(inputs, "lm", schedule, n), reference["lm", schedule, n]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    _assert_stages(got["states"][0], want["states"][0], 2e-4, 2e-4)
    _assert_stages(got["states"][-1], want["states"][-1], 2e-4, 2e-4,
                   moments=False)
    assert got["trace"] == want["trace"] and got["stats"] == want["stats"]


def test_bridged_stage_state_continues_as_jax(inputs, reference):
    """The reference's 1F1B stages after step 0 (params and Adam state)
    loaded into fresh port stages: the port's step 1 lands where the
    reference's did."""
    params, batches = inputs["toy"]
    want = reference["toy", "1f1b", 2]
    stages = _port_stages("toy", params, "1f1b", 2)
    bridge.load_pipeline_stages(stages, want["states"][0])
    assert [s.opt_state.count for s in stages] == [1, 1]
    x, y = batches[1]
    loss = PP.run_1f1b(stages, torch.from_numpy(x), torch.from_numpy(y),
                       n_micro=N_MICRO, lr=LR)
    assert loss == pytest.approx(want["losses"][1], rel=1e-5)
    _assert_stages(bridge.pipeline_stages_to_numpy(stages),
                   want["states"][1], 0, 1e-5)


@pytest.mark.parametrize("n_stages,n_micro", TRACE_1F1B)
def test_1f1b_trace_matches_jax(n_stages, n_micro):
    params, _ = _toy_inputs()
    x = np.random.default_rng(3).standard_normal((40, 50)).astype(np.float32)
    y = x[:, ::-1].copy()
    want, got = [], []
    JP.run_1f1b(JP.build_pipeline(params, n_stages), jnp.asarray(x),
                jnp.asarray(y), n_micro=n_micro, schedule_trace=want)
    PP.run_1f1b(PP.build_pipeline(bridge.mlp_params_from_jax(params),
                                  n_stages, devices=["cpu"]),
                torch.from_numpy(x), torch.from_numpy(y), n_micro=n_micro,
                schedule_trace=got)
    assert got == want
    assert max(t for t, *_ in got) == n_micro + n_stages - 2
    if (n_stages, n_micro) == (2, 4):
        assert got == PINNED_1F1B


def test_chip_smoke_pins_the_same_1f1b_clock():
    """``chip_smoke.py`` holds the card's 1F1B trace to its own copy of
    the pinned clock; it must be this one."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.PIPE_1F1B_TRACE == PINNED_1F1B


@pytest.mark.parametrize("D,V", TRACE_INTERLEAVED)
def test_interleaved_trace_and_stats_match_jax(D, V):
    """D·V virtual stages over D devices; at (4, 2) the toy's 6 layers
    leave the last two virtual stages empty (identities with no params),
    as in the reference's own example."""
    params, _ = _toy_inputs()
    x = np.random.default_rng(4).standard_normal((16, 50)).astype(np.float32)
    y = np.tanh(x)
    want, got, wstats, gstats = [], [], {}, {}
    wl = JP.run_interleaved_1f1b(
        JP.build_pipeline(params, D * V, devices=jax.local_devices()[:D]),
        jnp.asarray(x), jnp.asarray(y), n_micro=4, schedule_trace=want,
        stats=wstats)
    stages = PP.build_pipeline(bridge.mlp_params_from_jax(params), D * V,
                               devices=["cpu"] * D)
    gl = PP.run_interleaved_1f1b(stages, torch.from_numpy(x),
                                 torch.from_numpy(y), n_micro=4,
                                 schedule_trace=got, stats=gstats)
    assert got == want and gstats == wstats
    assert gl == pytest.approx(float(wl), rel=1e-5)
    if (D, V) == (4, 2):
        assert [len(s.params) for s in stages] == [1, 1, 1, 1, 1, 1, 0, 0]


# ------------------------------------------------------ the port's laws

def _toy_port(n_stages, devices=("cpu",)):
    params, batches = _toy_inputs()
    return (PP.build_pipeline(bridge.mlp_params_from_jax(params), n_stages,
                              devices=list(devices)),
            [tuple(map(torch.from_numpy, b)) for b in batches], params)


def _monolithic_toy(params, batch):
    """One full-batch Adam step of the port's MLP (autograd)."""
    p = bridge.mlp_params_from_jax(params)
    leaves = [t.requires_grad_() for _, t in PO.tree_leaves(p)]
    loss = PM.mse_loss(p, batch)
    grads = PO.tree_unflatten(p, list(torch.autograd.grad(loss, leaves)))
    p, _ = PO.adam_update(grads, PO.adam_init(p), p, lr=LR)
    return float(loss), [l for l in p]


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "interleaved"])
def test_each_schedule_equals_one_monolithic_adam_step(schedule):
    devices = ["cpu"] * (2 if schedule == "interleaved" else 1)
    stages, batches, params = _toy_port(4 if schedule == "interleaved"
                                        else 2, devices)
    loss = _runner(PP, schedule)(stages, *batches[0], n_micro=N_MICRO, lr=LR)
    want_loss, want = _monolithic_toy(params, batches[0])
    assert loss == pytest.approx(want_loss, rel=1e-5)
    got = [layer for s in stages for layer in s.params]
    for g, w in zip(got, want, strict=True):
        for k in ("w", "b"):
            torch.testing.assert_close(g[k].detach(), w[k].detach(),
                                       rtol=0, atol=1e-5)


def test_lm_schedule_equals_one_monolithic_adam_step(inputs):
    """TINY_LM: one 1F1B step over 2 stages against one full-batch Adam
    step of ``lm_loss`` on the same untied params (the reference's tier,
    abs 2e-4 on the loss and the params)."""
    params, batches = inputs["lm"]
    ids, labels = map(torch.from_numpy, batches[0])
    stages = _port_stages("lm", params, "1f1b", 2)
    loss = PP.run_1f1b(stages, ids, labels, n_micro=N_MICRO, lr=LR)
    p = bridge.params_from_jax(params, PCFG)
    leaves = [t.requires_grad_() for _, t in PO.tree_leaves(p)]
    want_loss = PT.lm_loss(p, (ids, labels), PCFG)
    grads = PO.tree_unflatten(p, list(torch.autograd.grad(want_loss, leaves)))
    p, _ = PO.adam_update(grads, PO.adam_init(p), p, lr=LR)
    assert loss == pytest.approx(float(want_loss), rel=1e-5)
    lo = 0
    for s in stages:
        n = s.params["layers"]["wq"].shape[0]
        for k, v in s.params["layers"].items():
            torch.testing.assert_close(v.detach(),
                                       p["layers"][k][lo:lo + n].detach(),
                                       rtol=2e-4, atol=2e-4)
        lo += n
    torch.testing.assert_close(stages[0].params["embed"].detach(),
                               p["embed"].detach(), rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(stages[-1].params["lm_head"].detach(),
                               p["lm_head"].detach(), rtol=2e-4, atol=2e-4)


def test_gpipe_equals_1f1b_over_steps():
    g, batches, _ = _toy_port(2)
    f, _, _ = _toy_port(2)
    for _ in range(3):
        lg = PP.run_gpipe(g, *batches[0], n_micro=N_MICRO)
        lf = PP.run_1f1b(f, *batches[0], n_micro=N_MICRO)
        assert lg == pytest.approx(lf, rel=1e-6)


def test_activation_high_water_marks():
    g, batches, _ = _toy_port(2)
    PP.run_gpipe(g, *batches[0], n_micro=N_MICRO)
    assert [s.max_stored for s in g] == [N_MICRO, N_MICRO]
    f, _, _ = _toy_port(2)
    PP.run_1f1b(f, *batches[0], n_micro=N_MICRO)
    assert max(s.max_stored for s in f) <= 2


def test_interleaving_cuts_the_bubble():
    params, _ = _toy_inputs()
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (16, 50)).astype(np.float32))
    plain, inter = {}, {}
    M = 8
    PP.run_interleaved_1f1b(PP.build_pipeline(
        bridge.mlp_params_from_jax(params), 2, devices=["cpu"] * 2), x, x,
        n_micro=M, stats=plain)
    PP.run_interleaved_1f1b(PP.build_pipeline(
        bridge.mlp_params_from_jax(params), 4, devices=["cpu"] * 2), x, x,
        n_micro=M, stats=inter)
    assert (plain["v"], inter["v"]) == (1, 2)
    assert inter["bubble_fraction"] < plain["bubble_fraction"]
    assert plain["bubble_fraction"] == pytest.approx((2 - 1) / (M + 2 - 1),
                                                     abs=0.05)


def test_streamed_vocab_loss_equals_dense(inputs):
    params, batches = inputs["lm"]
    ids, labels = map(torch.from_numpy, batches[0])
    chunked = dataclasses.replace(PCFG, loss_vocab_chunk=37)
    a = PP.run_gpipe(_port_stages("lm", params, "gpipe", 2), ids, labels,
                     n_micro=2, lr=0.0)
    b = PP.run_gpipe(_port_stages("lm", params, "gpipe", 2, chunked), ids,
                     labels, n_micro=2, lr=0.0)
    assert a == pytest.approx(b, abs=1e-4)


def test_broken_layouts_and_configs_raise(inputs):
    stages, batches, _ = _toy_port(4, ["cpu"] * 3)
    with pytest.raises(ValueError, match="divisible"):
        PP.run_interleaved_1f1b(stages, *batches[0], n_micro=2, n_devices=3)
    stages, _, _ = _toy_port(4, ["cpu"] * 4)
    with pytest.raises(ValueError, match="round-robin"):
        PP.run_interleaved_1f1b(stages, *batches[0], n_micro=2, n_devices=2)
    with pytest.raises(ValueError, match="not divisible"):
        PP.run_gpipe(stages, *batches[0], n_micro=5)
    params, _ = inputs["lm"]
    p = bridge.params_from_jax(params, PCFG)
    with pytest.raises(ValueError, match="n_stages"):
        PP.build_transformer_pipeline(p, PCFG, 99, devices=["cpu"])
    with pytest.raises(NotImplementedError, match="A2"):
        PP.build_transformer_pipeline(
            p, dataclasses.replace(PCFG, n_experts=4), 2, devices=["cpu"])


def test_pipe_result_keys_are_the_references():
    """The same keys; on the CPU ``memory_source`` reads "accounted"
    (the reference's "compiled_plan") and the zero peaks, one a card,
    are dropped."""
    names = lambda cls: [f.name for f in dataclasses.fields(cls)]
    assert names(PP.PipeResult) == names(JP.PipeResult)
    stages, batches, _ = _toy_port(2)
    res = PP.train_pipeline(stages, "1f1b", lambda e: batches[0],
                            num_epochs=2, n_micro=N_MICRO)
    # peaks a card: both stages share the CPU, which counts once
    assert res.peak_memory_mb == {"cpu": 0.0}
    assert res.total_peak_memory_mb == 0.0
    d = res.as_dict()
    assert set(d) == set(names(JP.PipeResult)) - {"peak_memory_mb",
                                                  "total_peak_memory_mb"}
    assert d["memory_source"] == "accounted" and len(d["losses"]) == 2
    assert d["max_stored_activations"] == {"device_0": 2, "device_1": 1}
    # params + grads (the same size), two moments, the stored inputs
    n0 = sum(t.numel() for _, t in PO.tree_leaves(stages[0].params))
    assert d["memory_plan_mb"]["device_0"] == round(
        (4 * 4 * n0 + 2 * 4 * 4 * 50) / 2 ** 20, 1)


def test_schedules_issue_no_collectives():
    stages, batches, _ = _toy_port(2)
    C.COLLECTIVES.reset()
    PP.run_gpipe(stages, *batches[0], n_micro=N_MICRO)
    PP.run_1f1b(stages, *batches[0], n_micro=N_MICRO)
    n = sum(len(list(PO.tree_leaves(s.params))) for s in stages)
    assert C.COLLECTIVES.read() == step_collectives("gpipe", n) == \
        step_collectives("1f1b", n) == dict.fromkeys(C.COLLECTIVES.KINDS, 0)


def test_twin_prints_the_result_json():
    out = subprocess.run(
        [sys.executable, "-m",
         "distributed_training_sandbox_tpu_torch.train.pipeline", "--device",
         "cpu", "--schedule", "1f1b", "--num-epochs", "2"],
        capture_output=True, text=True, timeout=300, check=True).stdout
    line = next(l for l in out.splitlines() if l.startswith("[1f1b] {"))
    res = json.loads(line[len("[1f1b] "):])
    assert res["schedule"] == "1f1b" and len(res["losses"]) == 2
    assert res["contract"]["holds"] and len(res["step_ms"]) == 2
    assert all(np.isfinite(res["losses"]))


def test_twin_refuses_what_is_not_ported():
    from distributed_training_sandbox_tpu_torch.train import pipeline as TP
    with pytest.raises(NotImplementedError, match="A8"):
        TP.main(["--device", "cpu", "--resume"])

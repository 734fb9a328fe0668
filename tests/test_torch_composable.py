"""The port's ``MeshPlan`` grammar and ``plan_feasible``
(``parallel/composable.py``) against the JAX reference's, on the CPU.
Both are pure Python, so everything is equal: the parsed plan, its
``describe``, ``normalized`` and ``strategy_name``, the shard-way
factors, each rejection's exception type and message, and
``plan_feasible`` over a grid.  ``validate`` against a model config and
``make_composable_train_step``'s refusals too."""

import dataclasses
import itertools

import pytest
import torch

from distributed_training_sandbox_tpu.models import transformer as JT
from distributed_training_sandbox_tpu.parallel import composable as JCP
from distributed_training_sandbox_tpu_torch.models import transformer as PT
from distributed_training_sandbox_tpu_torch.parallel import composable as CP

PLANS = ["dp8", "dp1", "dp8xw1", "dp8,w2", "dp8xw3", "dp8xw3flat",
         "dp8xw3named", "fsdp8", "fsdp2xtp2", "dp2xfsdp2xtp2",
         "dp4xtp2", "dp4xsp2", "dp2xsp2xw3named", "tp4", "sp4",
         "dp2×fsdp2×tp2", " DP2XTP2 ", "w1xdp4", "dp2xfsdp1xtp1",
         "dp1xfsdp1xtp1", "dp2xfsdp4xtp2", "w3named"]
BAD = ["dp0", "dp2xdp2", "xp2", "w4", "w2named", "dp2xfsdp2xw1",
       "dp2xfsdp2", "fsdp2xsp2", "dp2xtp2xsp2", "dp2xtp2xw1", "dp2xsp2xw1",
       "dp-1", "fsdp2xtp2xsp2"]


def _fields(p):
    return dataclasses.astuple(p)


@pytest.mark.parametrize("text", PLANS)
def test_plans_equal_the_references(text):
    jp, pp = JCP.MeshPlan.parse(text), CP.MeshPlan.parse(text)
    assert _fields(pp) == _fields(jp)
    assert pp.describe() == jp.describe()
    assert _fields(pp.normalized()) == _fields(jp.normalized())
    assert pp.ways == jp.ways
    assert pp.mesh_axes() == jp.mesh_axes()
    assert pp.axis_sizes() == jp.axis_sizes()
    for f in ("param_shard_ways", "opt_shard_ways", "data_ways"):
        assert getattr(pp, f) == getattr(jp, f), f
    try:
        want = jp.strategy_name()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pp.strategy_name()
        assert str(got.value) == str(e)
    else:
        assert pp.strategy_name() == want
        assert CP.MeshPlan.parse(pp.describe()).normalized().strategy_name() \
            == want


@pytest.mark.parametrize("text", BAD)
def test_rejections_equal_the_references(text):
    """A plan the reference refuses (at parse or at resolution) the port
    refuses with the same message."""
    def outcome(mod):
        try:
            return "ok", mod.MeshPlan.parse(text).strategy_name()
        except ValueError as e:
            return "error", str(e)
    j, p = outcome(JCP), outcome(CP)
    assert p == j
    assert j[0] == "error", text


def test_constructor_rejections_equal_the_references():
    for kw in (dict(dp=0), dict(tp=1.5), dict(w=5), dict(w_layout="x"),
               dict(fsdp=2, w=1), dict(w=1, w_layout="named")):
        with pytest.raises(ValueError) as j:
            JCP.MeshPlan(**kw)
        with pytest.raises(ValueError) as p:
            CP.MeshPlan(**kw)
        assert str(p.value) == str(j.value), kw


def test_plan_feasible_equals_the_references():
    n = 0
    for dp, f, tp, sp in itertools.product((1, 2, 3, 4), repeat=4):
        for devs in (4, 8, 16):
            for heads, kv, seq in ((4, 2, 256), (8, 4, 250), (None, None,
                                                               None)):
                kw = dict(n_devices=devs, n_heads=heads, n_kv_heads=kv,
                          seq_len=seq)
                assert CP.plan_feasible(dp, f, tp, sp, **kw) == \
                    JCP.plan_feasible(dp, f, tp, sp, **kw)
                n += 1
    assert n == 4 ** 4 * 9


def test_validate_equals_the_references():
    """Device count, tp dividing the heads, sp dividing the sequence."""
    cases = [("dp2xtp2", 4, 256), ("dp2xtp2", 8, 256), ("tp3", 3, 256),
             ("dp2xsp4", 8, 250), ("dp2xsp4", 8, 256)]
    for text, n, seq in cases:
        def outcome(mod, cfg):
            try:
                mod.MeshPlan.parse(text).validate(n, cfg, seq)
                return "ok"
            except ValueError as e:
                return str(e).split(" must ")[0].split(" spans ")[0]
        assert outcome(CP, PT.TINY_LM) == outcome(JCP, JT.TINY_LM), text


def test_build_refusals():
    """Transformer plans need a config, replicated-param data plans a
    loss, flat ZeRO-3 a toy-MLP tree; the 3-axis step composes 'none' or
    'ring' rejoins; the axes must realize the plan."""
    cfg = dataclasses.replace(PT.TINY_LM, num_hidden_layers=1)
    params = PT.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="pass model_cfg"):
        CP.make_composable_train_step(params, CP.MeshPlan.parse("dp1xw3named"))
    with pytest.raises(ValueError, match="needs loss_fn"):
        CP.make_composable_train_step(params, CP.MeshPlan.parse("dp1"))
    with pytest.raises(ValueError, match="toy-MLP tree only"):
        CP.make_composable_train_step(params, CP.MeshPlan.parse("dp1xw3"))
    with pytest.raises(ValueError, match="'none' or 'ring'"):
        CP.make_dp_fsdp_tp_step(params, cfg, overlap="q8")
    with pytest.raises(ValueError, match="do not realize"):
        CP.make_composable_train_step(params, CP.MeshPlan.parse("dp1"),
                                      axes={"tp": "tp"})

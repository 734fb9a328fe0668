"""The port's partition rules (``analysis/rules.py``) against the JAX
reference's, on the CPU.

* For every strategy of both registries and every role (params, Adam
  state, batch), the port's spec of every leaf equals the reference's
  ``match_partition_rules`` spec on the same named paths, bit for bit
  (rule matching is pure Python on both sides), over the toy MLP, a
  tied and an untied TINY_LM and its MoE variant, with the hygiene
  verdicts and the rule-attribution dump equal too.
* Each port ruleset's spec tree equals the port's hand specs:
  ``fsdp_specs`` (fsdp, sp), ``tp_specs`` (tp), ``moe_lm_specs`` (moe).
* The reference's rule-hygiene cases (``tests/test_rules.py``)
  restated: shadowed, dead and unmatched rules, first match wins, the
  scalar default, the mirrored optimizer rules, ``tile_dims``.
* ``rules_manifest_verdict`` on live shards: the FSDP and the 3-axis
  placements pass, a shard cut on the wrong dim fails.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from distributed_training_sandbox_tpu.analysis import rules as JR
from distributed_training_sandbox_tpu.models import transformer as JT
from distributed_training_sandbox_tpu.parallel import optim as JO
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.analysis import rules as R
from distributed_training_sandbox_tpu_torch.analysis.rules import (
    Rule, match_partition_rules, mirror_opt_rules, named_leaf_paths,
    tile_dims)
from distributed_training_sandbox_tpu_torch.models import transformer as PT
from distributed_training_sandbox_tpu_torch.models.mlp import init_mlp
from distributed_training_sandbox_tpu_torch.parallel import (
    expert, fsdp, optim, tensor)

SHARED = sorted(set(R.RULESETS) & set(JR.RULESETS))
MOE = dict(num_hidden_layers=2, n_experts=4, moe_ffn=32)


def _lm(tied=True, **kw):
    jcfg = dataclasses.replace(JT.TINY_LM, tie_word_embeddings=tied, **kw)
    pcfg = dataclasses.replace(PT.TINY_LM, tie_word_embeddings=tied, **kw)
    jp = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0),
                                                 jcfg))
    return jp, bridge.params_from_jax(jp, pcfg)


def _mlp():
    p = init_mlp(torch.Generator().manual_seed(0), (24, 16, 8))
    return [{k: v.numpy() for k, v in layer.items()} for layer in p], p


def _trees(strategy):
    """(reference tree, port tree) pairs a role, for one strategy."""
    family = JR.RULESETS[strategy].family
    if family == "data":
        pairs = [_mlp()]
    elif family == "moe":
        pairs = [_lm(**MOE)]
    else:
        pairs = [_lm(True), _lm(False)]
    out = []
    for jp, pp in pairs:
        jopt = JO.AdamState(mu=jp, nu=jp, count=np.zeros((), np.int32))
        popt = optim.AdamState(mu=pp, nu=pp, count=0)
        ids = np.zeros((4, 16), np.int32)
        out += [("params", jp, pp), ("opt", jopt, popt),
                ("batch", (ids, ids), (torch.from_numpy(ids),) * 2)]
    return out


@pytest.mark.parametrize("strategy", SHARED)
def test_specs_equal_the_references(strategy):
    """Every leaf's spec, the hygiene verdicts and the dump, role by
    role, equal the reference's."""
    assert set(R.RULESETS) - set(JR.RULESETS) == {"fsdp_q8"}
    jrs, prs = JR.RULESETS[strategy], R.RULESETS[strategy]
    assert (prs.family, prs.axes, prs.weight_update_sharding) == (
        jrs.family, jrs.axes, jrs.weight_update_sharding)
    for role, jtree, ptree in _trees(strategy):
        jrep = JR.match_partition_rules(
            jrs.rules_for(role), JR.named_leaf_paths(jtree),
            strategy=strategy, role=role)
        prep = prs.match(role, ptree)
        assert prep.spec_by_path() == jrep.spec_by_path(), (strategy, role)
        assert [m.rule_index for m in prep.matches] == [
            m.rule_index for m in jrep.matches]
        assert (prep.errors, prep.warnings) == (jrep.errors, jrep.warnings)
        assert prep.describe() == jrep.describe()
        assert prep.to_dict() == jrep.to_dict()


def test_serve_rulesets_wait_for_tp_serving():
    """The reference's four serving rulesets are the port's too (with
    tensor-parallel serving), their family, axes and config equal; the
    port lacks only the offload and fp8 FSDP rulesets (A12), and its
    ``fsdp_q8`` (int8 gathers) has no reference twin."""
    assert set(JR.RULESETS) - set(R.RULESETS) == {"fsdp_offload",
                                                  "fsdp_fp8"}
    serve = [s for s in JR.RULESETS if s.startswith("serve_")]
    assert sorted(serve) == ["serve_decode", "serve_decode_paged_kernel",
                             "serve_decode_spec", "serve_prefill_flash"]
    for s in serve:
        j, p = JR.RULESETS[s], R.RULESETS[s]
        assert (p.family, p.axes, dict(p.config), p.description) == (
            j.family, j.axes, dict(j.config), j.description)
        _, pp = _lm(True)
        assert p.partition_specs(pp) == tensor.tp_specs(pp, "tp")


@pytest.mark.parametrize("tied", [True, False])
def test_rulesets_equal_the_hand_specs(tied):
    """fsdp and sp rules give ``fsdp_specs``, tp rules ``tp_specs``, the
    moe rules ``moe_lm_specs``, leaf for leaf."""
    _, p = _lm(tied)
    assert R.RULESETS["fsdp"].partition_specs(p) == fsdp.fsdp_specs(p, "dp")
    assert R.RULESETS["sp"].partition_specs(p) == fsdp.fsdp_specs(p, "dp")
    assert R.RULESETS["tp"].partition_specs(p) == tensor.tp_specs(p, "tp")
    _, m = _lm(tied, **MOE)
    assert R.RULESETS["moe"].partition_specs(m) == expert.moe_lm_specs(m,
                                                                        "ep")
    opt = R.RULESETS["fsdp"].partition_specs(
        optim.AdamState(mu=p, nu=p, count=0), "opt")
    assert opt == optim.AdamState(mu=fsdp.fsdp_specs(p), nu=fsdp.fsdp_specs(p),
                                  count=())


def test_composable_rules_place_megatron_roles_against_fsdp():
    """Column-parallel (L, in⊘fsdp, out⊘tp), row-parallel (L, in⊘tp,
    out⊘fsdp), norms (L, H⊘fsdp), plain leaves dim 0 over fsdp."""
    _, p = _lm(False)
    s = R.RULESETS["composable_dp_fsdp_tp"].partition_specs(p)
    for k in ("wq", "wk", "wv", "w_gate", "w_up"):
        assert s["layers"][k] == (None, "fsdp", "tp")
    for k in ("wo", "w_down"):
        assert s["layers"][k] == (None, "tp", "fsdp")
    assert s["layers"]["ln1"] == s["layers"]["ln2"] == (None, "fsdp")
    assert s["embed"] == s["final_norm"] == s["lm_head"] == ("fsdp",)
    assert R.RULESETS["composable_dp_fsdp_tp"].batch_rules[0].spec == (
        ("dp", "fsdp"),)


# -------------------------------------------------------------- hygiene

def _tree():
    return {"layers": {"w": torch.ones((8, 4))}, "head": torch.ones((4,))}


def test_seeded_shadowed_rule_errors_with_readable_report():
    rules = (Rule(r".*", ()), Rule(r"^layers/", ("dp",)))
    report = match_partition_rules(rules, named_leaf_paths(_tree()),
                                   strategy="seeded")
    assert not report.ok
    (err,) = report.errors
    assert "shadowed rule #1" in err
    assert "/^layers//" in err and "#0" in err
    assert "layers/w" in err and "reorder or delete" in err


def test_dead_rule_warns():
    rules = (Rule(r"^nonesuch/", ("dp",)), Rule(r".*", ()))
    report = match_partition_rules(rules, named_leaf_paths(_tree()))
    assert report.ok
    (warn,) = report.warnings
    assert "dead rule #0" in warn and "matches no leaf" in warn


def test_unmatched_leaf_errors():
    report = match_partition_rules((Rule(r"^layers/", ("dp",)),),
                                   named_leaf_paths(_tree()))
    assert not report.ok
    (err,) = report.errors
    assert "unmatched leaf 'head'" in err
    with pytest.raises(ValueError, match="rule hygiene failed"):
        R.RuleSet("x", "fsdp", ("dp",), (Rule(r"^layers/", ("dp",)),)
                  ).partition_specs(_tree())


def test_first_match_wins_and_describe_names_the_claimer():
    rules = (Rule(r"^layers/", (None, "dp")), Rule(r".*", ()))
    report = match_partition_rules(rules, named_leaf_paths(_tree()),
                                   strategy="demo", role="params")
    assert report.ok
    assert report.spec_by_path() == {"layers/w": (None, "dp"), "head": ()}
    dump = report.describe()
    assert "layers/w" in dump and "rule #0" in dump
    assert "head" in dump and "rule #1" in dump


def test_scalar_leaves_fall_to_replicated_default():
    tree = {"w": torch.ones((4, 4)), "count": torch.zeros(())}
    report = match_partition_rules((Rule(r"^w$", ("dp",)),),
                                   named_leaf_paths(tree))
    assert report.ok
    by_path = {m.path: m for m in report.matches}
    assert by_path["count"].spec == () and by_path["count"].rule_index == -1
    assert by_path["w"].rule_index == 0


def test_mirror_opt_rules_prefixes_moment_paths():
    (cat, spec) = mirror_opt_rules(
        (Rule(r".*", ("dp",)), Rule(r"^layers/", (None, "dp"))))
    assert cat.pattern == r"^(mu|nu|momentum)(/|$)"
    assert spec.pattern == r"^(mu|nu|momentum)/layers/"
    assert cat.spec == ("dp",) and spec.spec == (None, "dp")


def test_tile_dims_resolves_axis_products():
    sizes = {"dp": 4, "ep": 2}
    assert tile_dims(("dp",), 2, sizes) == (4, 1)
    assert tile_dims((None, "dp"), 2, sizes) == (1, 4)
    assert tile_dims((("dp", "ep"),), 1, sizes) == (8,)
    assert tile_dims((), 3, sizes) == (1, 1, 1)
    for spec in [("dp",), (None, "dp"), (("dp", "ep"),), ()]:
        assert tile_dims(spec, 2, sizes) == JR.tile_dims(spec, 2, sizes)
        assert R.spec_str(spec) == JR.spec_str(spec)


# -------------------------------------------------------------- verdict

def test_manifest_verdict_reads_live_shards():
    """Shards cut as the rules say pass; a shard cut on another dim
    fails with the leaf named; hygiene over an unknown strategy fails."""
    _, p = _lm(False)
    shards = fsdp.shard_tree(p, 1, 2)
    v = R.rules_manifest_verdict("fsdp", params=shards, full=p,
                                 axis_sizes={"dp": 2})
    assert v["ok"] and v["checked"] == len(named_leaf_paths(p))
    bad = {**shards, "embed": p["embed"][:, :32].clone()}
    v = R.rules_manifest_verdict("fsdp", params=bad, full=p,
                                 axis_sizes={"dp": 2})
    assert not v["ok"] and "embed" in v["mismatches"][0]
    v = R.rules_manifest_verdict("tp", params=tensor.shard_tree_tp(p, 0, 2),
                                 full=p, axis_sizes={"tp": 2})
    assert v["ok"]
    assert not R.rules_manifest_verdict("nonesuch")["ok"]

"""The generated collective calls a step (``analysis/contract_gen.py``)
against the hand-written counts of ``parallel/contracts.py``, on the
CPU: over each strategy's grid of world sizes, depths, overlaps, remat
and microbatches (rebuilds and buckets for the data family, the z-loss
and sp for MoE), every kind equal, and no strategy on one side only —
the port's twin of the reference's ``diff_all_contracts``, pinned
empty.  ``composable_dp_fsdp_tp`` has no hand formula; its generated
counts are held against the step itself in
``test_torch_composable_ranks.py``, and here against the sum of the
mechanisms it composes."""

import pytest

from distributed_training_sandbox_tpu_torch.analysis import contract_gen as G
from distributed_training_sandbox_tpu_torch.analysis.rules import RULESETS
from distributed_training_sandbox_tpu_torch.parallel import contracts as HC

DIFFS = G.diff_all_contracts()


@pytest.mark.parametrize("strategy", sorted(DIFFS))
def test_generated_counts_equal_the_hand_written(strategy):
    d = DIFFS[strategy]
    assert d.ok, d.describe()
    assert d.checked > 0


def test_no_strategy_is_one_sided():
    """Every ruleset has a hand count but the generated-only 3-axis
    step; every hand count has a ruleset."""
    assert set(G.HAND) == set(RULESETS) - {"composable_dp_fsdp_tp"}
    assert set(DIFFS) == set(G.HAND)
    assert "composable_dp_fsdp_tp" in G.GENERATED_STRATEGIES


@pytest.mark.parametrize("overlap", ["none", "ring"])
@pytest.mark.parametrize("remat", [True, False])
def test_three_axis_counts_compose_fsdp_and_tp(overlap, remat):
    """The 3-axis step's generated calls are FSDP's gathers over fsdp
    plus TP's rejoins over tp, the loss mean once and one grad
    all_reduce a leaf: the hand FSDP count at fsdp ranks plus the hand
    TP count, less TP's own loss mean."""
    tree = G._tiny_tree(2, tied=False)
    for f, tp in ((1, 1), (2, 2), (4, 2), (2, 4)):
        c = G.Ctx({"dp": 2, "fsdp": f, "tp": tp}, remat=remat,
                  overlap=overlap)
        got = G.generate_counts("composable_dp_fsdp_tp", tree, c)
        fs = HC.fsdp_step_collectives(tree, f, remat=remat)
        tps = HC.tp_step_collectives(tree, tp, overlap=overlap, remat=remat)
        want = {k: fs[k] + tps[k] for k in fs}
        want["all_reduce"] -= 1
        assert got == want, (f, tp)


def test_refusals():
    with pytest.raises(KeyError, match="no RuleSet"):
        G.generate_counts("nonesuch", G._tiny_tree(1), G.Ctx({}))
    with pytest.raises(ValueError, match="overlap"):
        G.generate_counts("tp", G._tiny_tree(1), G.Ctx({"tp": 2},
                                                       overlap="bogus"))

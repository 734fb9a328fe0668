"""The port's sequence classifier (``models/classifier.py``) and the DDP
twin's classification leg (``train/ddp.py --model tiny``) against the JAX
package, on the CPU.

* ``classifier_logits``, ``classification_loss``,
  ``classification_accuracy`` and every grad leaf on bridged TINY_LM
  weights (dense, and with 4 experts: the loss then adds
  ``moe_aux_weight`` × the trunk's aux) against the reference's, f32, at
  rtol = atol = 1e-5 (the two sum in other orders);
* the pad-content law, bitwise inside the port: what the pads hold
  changes no logit;
* the bridge's classifier tree both ways;
* the leg on one and two gloo ranks against one process's SGD on the
  same global batches (each rank draws its rows from its own shard):
  losses within ws f32 roundings (each rank's loss and grads over its
  rows, then averaged, where one process averages over all rows); an
  all_reduce a leaf, the loss mean and the barrier every step; the same
  padded widths, each a multiple of 8;
* a preempt at step 3 with a restart, resumed from the checkpoint at
  step 2, bit-equal to the uninterrupted run (the data cursor skips the
  batches already consumed).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fsdp import spawn_ranks

from distributed_training_sandbox_tpu.data import classification as RC
from distributed_training_sandbox_tpu.models import classifier as RCL
from distributed_training_sandbox_tpu.models import transformer as RT
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.models import classifier as PCL
from distributed_training_sandbox_tpu_torch.models import transformer as PT
from distributed_training_sandbox_tpu_torch.parallel import optim
from distributed_training_sandbox_tpu_torch.train import ddp as TD
from distributed_training_sandbox_tpu_torch.train.harness import quiet_config

TOL = dict(rtol=1e-5, atol=1e-5)
MOE = dict(n_experts=4, moe_capacity_factor=4.0)
STEPS, BATCH = 5, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """TINY_LM's ops are too small to gain from intra-op threads; the
    suite's workers share the cores, so the module runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(moe: bool, seed: int = 0):
    """(reference cfg, port cfg, reference params, port params, batch):
    TINY_LM (with 4 experts if ``moe``), its head drawn non-zero."""
    jc = dataclasses.replace(RT.TINY_LM, **MOE) if moe else RT.TINY_LM
    pc = dataclasses.replace(PT.TINY_LM, **MOE) if moe else PT.TINY_LM
    jp = RCL.init_classifier_params(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed)
    jp["cls_head"] = jnp.asarray(rng.standard_normal(
        jp["cls_head"].shape).astype(np.float32) * 0.5)
    np_tree = jax.tree.map(np.asarray, jp)
    pp = bridge.classifier_params_from_jax(np_tree, pc)
    ex = RC.synthetic_pair_examples(6, jc.vocab_size, seed=seed + 1)
    batch = RC.pad_collate(ex)
    return jc, pc, jp, pp, batch


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_logits_loss_accuracy_and_grads_match_the_reference(moe):
    jc, pc, jp, pp, batch = _case(moe)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = _torch_batch(batch)
    want_logits = RCL.classifier_logits(jp, jb["input_ids"],
                                        jb["attention_mask"], jc)
    got_logits = PCL.classifier_logits(pp, tb["input_ids"],
                                       tb["attention_mask"], pc)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               **TOL)
    want_loss, want_grads = jax.value_and_grad(RCL.classification_loss)(
        jp, jb, jc)
    leaves = [p for _, p in optim.tree_leaves(pp)]
    for p in leaves:
        p.requires_grad_(True)
    loss = PCL.classification_loss(pp, tb, pc)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               **TOL)
    got = optim.tree_unflatten(pp, grads)
    want = bridge.classifier_params_to_numpy(
        bridge.classifier_params_from_jax(jax.tree.map(np.asarray,
                                                       want_grads), pc))
    for path, g in optim.tree_leaves(got):
        np.testing.assert_allclose(
            g.numpy(), optim.tree_get(want, path), **TOL,
            err_msg="/".join(path))
    for p in leaves:
        p.requires_grad_(False)
    acc = float(PCL.classification_accuracy(pp, tb, pc))
    assert acc == float(RCL.classification_accuracy(jp, jb, jc))


def test_pad_content_changes_no_logit():
    """Right padding under causal attention: the pooled state never sees
    a pad, so any pad id gives the same logits bit for bit."""
    _, pc, _, pp, _ = _case(False, seed=3)
    ex = RC.synthetic_pair_examples(5, pc.vocab_size, seed=9)
    a, b = (_torch_batch(RC.pad_collate(ex, pad_id=pid)) for pid in (0, 17))
    assert not torch.equal(a["input_ids"], b["input_ids"])
    la = PCL.classifier_logits(pp, a["input_ids"], a["attention_mask"], pc)
    lb = PCL.classifier_logits(pp, b["input_ids"], b["attention_mask"], pc)
    assert torch.equal(la, lb)


def test_init_and_bridge_round_trip():
    pp = PCL.init_classifier_params(PT.TINY_LM, torch.Generator()
                                    .manual_seed(0), "cpu", num_labels=3)
    assert set(pp) == {"trunk", "cls_head"}
    assert pp["cls_head"].shape == (PT.TINY_LM.hidden_size, 3)
    assert not pp["cls_head"].any()
    jp = RCL.init_classifier_params(jax.random.PRNGKey(0), RT.TINY_LM, 3)
    assert {k: v.shape for k, v in optim.tree_leaves(pp)} == {
        k: tuple(v.shape) for k, v in optim.tree_leaves(
            bridge.classifier_params_from_jax(jax.tree.map(np.asarray, jp),
                                              PT.TINY_LM))}
    back = bridge.classifier_params_to_numpy(pp)
    again = bridge.classifier_params_from_jax(back, PT.TINY_LM)
    for path, t in optim.tree_leaves(pp):
        assert torch.equal(t, optim.tree_get(again, path))


LEG_WORKER = r"""
import json, sys
from pathlib import Path
import torch
torch.set_num_threads(1)
from distributed_training_sandbox_tpu_torch.train import ddp
from distributed_training_sandbox_tpu_torch.train.harness import quiet_config
from distributed_training_sandbox_tpu_torch.utils import mesh
work, steps, batch = Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
r = ddp.run(model="tiny", source="synthetic", num_steps=steps,
            batch_size=batch, device="cpu", config=quiet_config(
                dispatch="sync"), log=lambda *a, **k: None)
if mesh.axis_rank() == 0:
    (work / "out.json").write_text(json.dumps({
        "losses": r["losses"], "widths": r["widths"],
        "collectives": r["collectives"], "n_leaves": r["n_leaves"],
        "sync_error": r["sync_error"], "world": r["world_size"]}))
mesh.destroy_process_group()
"""


def _leg(tmp_path, n, procs2):
    work = tmp_path / f"w{n}"
    work.mkdir()
    spawn_ranks(["-c", LEG_WORKER, str(work), str(STEPS), str(BATCH)], n,
                procs2.free_port())
    return json.loads((work / "out.json").read_text())


def _one_process(ws: int):
    """The leg's SGD in one process on the global batches that ``ws``
    ranks draw (each rank from its own shard): the losses and widths."""
    cfg = PT.TINY_LM
    params = PCL.init_classifier_params(
        cfg, torch.Generator().manual_seed(42), "cpu")
    ex = RC.synthetic_pair_examples(TD.N_EXAMPLES, cfg.vocab_size, 42)
    opt = optim.sgd_init(params)
    losses, widths = [], []
    leaves = [p for _, p in optim.tree_leaves(params)]
    for i, (ids, mask, labels) in zip(range(STEPS), TD.cls_batches(
            ex, BATCH, ws, 42, 1)):
        for p in leaves:
            p.requires_grad_(True)
        loss = PCL.classification_loss(params, {
            "input_ids": ids, "attention_mask": mask, "labels": labels}, cfg)
        grads = optim.tree_unflatten(params, torch.autograd.grad(loss,
                                                                 leaves))
        for p in leaves:
            p.requires_grad_(False)
        params, opt = optim.sgd_update(grads, opt, params, lr=TD.LR)
        leaves = [p for _, p in optim.tree_leaves(params)]
        losses.append(float(loss.detach()))
        widths.append(ids.shape[1])
    return losses, widths


@pytest.mark.parametrize("n", [1, 2])
def test_ranks_match_one_process_within_f32_roundings(tmp_path, procs2, n):
    """The leg on n gloo ranks against one process's SGD on the same
    global batches: the losses within n f32 roundings of the mean (each
    rank's loss and grads over its own rows, then averaged over the
    ranks), carried through the SGD steps; the collectives a step an
    all_reduce a leaf, the loss mean and the barrier."""
    got = _leg(tmp_path, n, procs2)
    losses, widths = _one_process(n)
    assert got["world"] == n and got["sync_error"] == 0.0
    assert got["widths"] == widths and all(w % 8 == 0 for w in widths)
    assert len(set(widths)) >= 2
    want = {"all_reduce": got["n_leaves"] + 2}
    assert len(got["collectives"]) == STEPS
    assert all({k: v for k, v in c.items() if v} == want
               for c in got["collectives"])
    np.testing.assert_allclose(got["losses"], losses, rtol=4 * n * 2 ** -24,
                               atol=0)


def test_preempt_resume_is_bit_equal(tmp_path):
    kw = dict(model="tiny", source="synthetic", num_steps=STEPS,
              batch_size=BATCH, device="cpu", log=lambda *a, **k: None)
    try:
        whole = TD.run(config=quiet_config(dispatch="sync"), **kw)
        resumed = TD.run(config=quiet_config(
            dispatch="sync", checkpoint_dir=str(tmp_path / "ck"),
            checkpoint_every=2, inject_fault="preempt@3", max_restarts=1),
            **kw)
    finally:
        from distributed_training_sandbox_tpu_torch.utils import mesh
        mesh.destroy_process_group()
    assert resumed["start_step"] > 0
    assert resumed["losses"] == whole["losses"]
    for path, t in optim.tree_leaves(whole["params"]):
        assert torch.equal(t, optim.tree_get(resumed["params"], path)), path


def test_refusals():
    with pytest.raises(ValueError, match="choose from"):
        TD.run(model="nope", device="cpu")
    with pytest.raises(ValueError, match="source"):
        TD.run(model="tiny", source="glue", device="cpu")

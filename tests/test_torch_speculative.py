"""The port's speculative decoding against the JAX reference, on the CPU.

``_spec_accept_core`` on the reference suite's table and on random
blocks against the JAX function; ``make_draft_params`` on float and int8
params (views of the target's storage, a ``QuantizedWeight`` sliced
field by field); the parity matrix's speculative legs — ``spec``,
``cache+spec``, ``cache+spec-kvq`` and int8 weights — against the JAX
engine on the same legs (the reference's gather path: its Pallas routes
fail in this environment, ROADMAP C3), tokens and stats equal, on the
reference's weights bridged (TINY_LM in f32, scaled ×3); the port's
kernel flags against its own no-flag engine and ``generate``, bit for
bit (on the CPU the kernel entry points take their plain versions); the
verify's attention through K3's entry point; the refusals, the host API
and the telemetry hooks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_sandbox_tpu.models import transformer as JT
from distributed_training_sandbox_tpu.models.generate import (
    quantize_decode_params as jax_quantize_decode_params)
from distributed_training_sandbox_tpu.serving import engine as JE
from distributed_training_sandbox_tpu_torch.models import transformer as PT
from distributed_training_sandbox_tpu_torch.models.generate import (
    generate as port_generate, quantize_decode_params)
from distributed_training_sandbox_tpu_torch.ops import flash_prefill as PFP
from distributed_training_sandbox_tpu_torch.ops import paged_attention as PPA
from distributed_training_sandbox_tpu_torch.ops.quant import QuantizedWeight
from distributed_training_sandbox_tpu_torch.serving import engine as PE
from distributed_training_sandbox_tpu_torch.telemetry.run import TelemetryRun

from test_torch_prefix_cache import (ENGINE, _bridged,
                                     _prompts_with_shared_prefix)


@pytest.fixture(scope="module")
def weights():
    return _bridged()


def _same_spec(port, ref):
    """Speculative stats equal; the reference rounds the rate to 4
    places, the port reports it unrounded."""
    rate = port.pop("acceptance_rate")
    ref = dict(ref)
    ref_rate = ref.pop("acceptance_rate")
    assert port == ref
    assert (rate is None) == (ref_rate is None)
    if rate is not None:
        assert round(rate, 4) == ref_rate


# ---- the accept rule --------------------------------------------------------

def test_accept_core_on_the_reference_table():
    """The reference suite's table: the longest matching prefix + the
    bonus token, clamped at stop, frozen for inactive slots."""
    i32 = lambda a: torch.tensor(a, dtype=torch.int32)
    toks_blk = i32([[5, 7, 8, 9], [5, 7, 8, 9], [1, 2, 3, 4], [1, 2, 3, 4]])
    greedy = i32([[7, 8, 6, 6], [7, 8, 9, 2], [9, 9, 9, 9], [9, 9, 9, 9]])
    nxt, new_len, new_active, e = PE._spec_accept_core(
        toks_blk, greedy, i32([5, 5, 1, 1]), i32([10, 10, 10, 10]),
        i32([20, 12, 20, 20]), torch.tensor([True, True, True, False]))
    assert e.tolist() == [3, 2, 1, 0]
    assert new_len.tolist() == [13, 12, 11, 10]
    assert nxt.tolist() == [6, 8, 9, 1]
    assert new_active.tolist() == [True, False, True, False]
    assert {t.dtype for t in (nxt, new_len, e)} == {torch.int32}


@pytest.mark.parametrize("seed", range(4))
def test_accept_core_equals_jax_on_random_blocks(seed):
    rng = np.random.default_rng(seed)
    B, k = 16, 1 + seed
    # small vocab so that proposals match often, at any depth
    blk = rng.integers(0, 3, size=(B, k + 1)).astype(np.int32)
    greedy = rng.integers(0, 3, size=(B, k + 1)).astype(np.int32)
    toks = rng.integers(0, 3, size=B).astype(np.int32)
    lengths = rng.integers(0, 30, size=B).astype(np.int32)
    stop = lengths + rng.integers(1, 6, size=B).astype(np.int32)
    active = rng.random(B) < 0.8
    ref = JE._spec_accept_core(*(jnp.asarray(a) for a in (
        blk, greedy, toks, lengths, stop, active)))
    got = PE._spec_accept_core(*(torch.as_tensor(a) for a in (
        blk, greedy, toks, lengths, stop, active)))
    for r, g in zip(ref, got):
        assert (np.asarray(r) == g.numpy()).all()


# ---- the draft params -------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_make_draft_params_slices_views_of_the_target(weights, int8):
    jp, pp = weights
    cfg = PT.TINY_LM
    if int8:
        pp = quantize_decode_params(pp, cfg)
        jp = jax_quantize_decode_params(jp, JT.TINY_LM)
    draft, dcfg = PE.make_draft_params(pp, cfg, 2)
    jdraft, jdcfg = JE.make_draft_params(jp, JT.TINY_LM, 2)
    assert dcfg.num_hidden_layers == jdcfg.num_hidden_layers == 2
    assert set(draft) == set(pp) and draft["embed"] is pp["embed"]
    for name, leaf in draft["layers"].items():
        full = pp["layers"][name]
        ref = jdraft["layers"][name]
        if isinstance(full, QuantizedWeight):
            assert isinstance(leaf, QuantizedWeight)
            pairs = [(leaf.q, full.q, ref.q), (leaf.s, full.s, ref.s)]
        else:
            pairs = [(leaf, full, ref)]
        for d, f, r in pairs:
            assert d.shape[0] == 2 and d.data_ptr() == f.data_ptr()
            assert (d.numpy() == np.asarray(r)).all(), name
    with pytest.raises(ValueError, match="draft of 5 layers"):
        PE.make_draft_params(pp, cfg, 5)
    with pytest.raises(ValueError, match="draft of 0 layers"):
        PE.make_draft_params(pp, cfg, 0)


# ---- the parity matrix against the JAX engine ------------------------------

LEGS = {
    "spec": dict(spec_k=2, draft_layers=1),
    "spec-k3-draft2": dict(spec_k=3, draft_layers=2),
    "cache+spec": dict(prefix_cache=True, spec_k=2, draft_layers=1),
    "cache+spec-kvq": dict(prefix_cache=True, spec_k=2, draft_layers=1,
                           kv_quant=True),
    "int8-weights": dict(prefix_cache=True, spec_k=2, draft_layers=1,
                         int8=True),
}


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_spec_legs_equal_the_jax_engine(weights, leg):
    jp, pp = weights
    kw = dict(LEGS[leg])
    if kw.pop("int8", False):
        jp = jax_quantize_decode_params(jp, JT.TINY_LM)
        pp = quantize_decode_params(pp, PT.TINY_LM)
    prompts = _prompts_with_shared_prefix(4)
    jeng = JE.ServingEngine(jp, JT.TINY_LM, **ENGINE, **kw)
    jreqs = [jeng.submit(p, max_new_tokens=6) for p in prompts]
    jeng.run()
    eng = PE.ServingEngine(pp, PT.TINY_LM, device="cpu", **ENGINE, **kw)
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.run()
    for j, p in zip(jreqs, reqs):
        assert p.tokens == j.tokens, (p.rid, p.tokens, j.tokens)
    jrep, rep = jeng.slo_report(), eng.slo_report()
    _same_spec(rep["speculative"], jrep["speculative"])
    assert rep.get("prefix_cache") == jrep.get("prefix_cache")
    assert rep["scheduler"]["decode_steps"] == \
        jrep["scheduler"]["decode_steps"]
    if kw.get("prefix_cache"):
        assert eng.prefix_cache.hit_pages > 0
    for r in reqs:
        assert r.tokens == port_generate(
            pp, r.prompt[None], PT.TINY_LM, max_new_tokens=6,
            cache_capacity=eng.view_capacity,
            kv_quant=kw.get("kv_quant", False), device="cpu")[0].tolist()


@pytest.mark.parametrize("case", ["draft-is-target", "shallow-draft"])
def test_draft_equal_to_target_accepts_and_rollbacks_stay_exact(case):
    """The reference suite's two laws on the port: a draft that IS the
    target accepts (nearly) everything and decodes under one step a
    token (weights ×1.5, not so chaotic that the draft's S = 1 step and
    the verify's S = k+1 step disagree at the ulp); a one-layer draft on
    ×3 weights rolls back often.  Both streams stay the JAX engine's and
    ``generate``'s, with equal stats."""
    full = PT.TINY_LM.num_hidden_layers
    seed, scale, rseed, sizes, new, dl, sync = {
        "draft-is-target": (4, 1.5, 9, (5, 11), 9, full, 4),
        "shallow-draft": (6, 3.0, 13, (4, 13), 7, 1, 2)}[case]
    jp, pp = _bridged(seed=seed, scale=scale)
    rng = np.random.default_rng(rseed)
    prompts = [rng.integers(1, PT.TINY_LM.vocab_size, size=n).astype(
        np.int32) for n in sizes]
    kw = dict(max_batch=2, page_size=8, max_seq_len=48, spec_k=3,
              draft_layers=dl, sync_every=sync)
    eng = PE.ServingEngine(pp, PT.TINY_LM, device="cpu", **kw)
    reqs = [eng.submit(p, max_new_tokens=new) for p in prompts]
    eng.run()
    jeng = JE.ServingEngine(jp, JT.TINY_LM, **kw)
    jreqs = [jeng.submit(p, max_new_tokens=new) for p in prompts]
    jeng.run()
    slo = eng.slo_report()
    sp = slo["speculative"]
    _same_spec(dict(sp), jeng.slo_report()["speculative"])
    if dl == full:
        assert sp["acceptance_rate"] > 0.6
        assert slo["scheduler"]["decode_steps_per_token"] < 1.0
    else:
        assert sp["proposed"] > sp["accepted"]
    for r, j in zip(reqs, jreqs):
        assert r.tokens == j.tokens
        assert r.tokens == port_generate(
            pp, r.prompt[None], PT.TINY_LM, max_new_tokens=new,
            cache_capacity=eng.view_capacity, device="cpu")[0].tolist()


@pytest.mark.parametrize("legs", [
    dict(spec_k=2, draft_layers=1),
    dict(prefix_cache=True, spec_k=3, draft_layers=2),
    dict(prefix_cache=True, spec_k=2, draft_layers=1, kv_quant=True)],
    ids=["spec", "cache+spec", "cache+spec-kvq"])
def test_kernel_flags_equal_the_plain_engine_and_generate(weights, legs):
    _, pp = weights
    prompts = _prompts_with_shared_prefix(5, seed=13)
    flash = not legs.get("kv_quant", False)
    runs = []
    for flags in (dict(), dict(paged_kernel=True, flash_prefill=flash)):
        eng = PE.ServingEngine(pp, PT.TINY_LM, device="cpu", **ENGINE,
                               **legs, **flags)
        reqs = [eng.submit(p, max_new_tokens=7) for p in prompts]
        eng.run()
        runs.append((eng, reqs))
    (e0, r0), (e1, r1) = runs
    # the batched prefill schedules rounds otherwise, so the macro-step
    # counts may differ; the tokens may not
    assert [r.tokens for r in r0] == [r.tokens for r in r1]
    for r in r1:
        assert r.tokens == port_generate(
            pp, r.prompt[None], PT.TINY_LM, max_new_tokens=7,
            cache_capacity=e1.view_capacity,
            kv_quant=legs.get("kv_quant", False), device="cpu")[0].tolist()


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "gather"])
def test_verify_attention_goes_through_k3_under_flash_prefill(
        weights, monkeypatch, flash):
    """The verify's (B, k+1) block calls K3's entry point exactly when
    ``flash_prefill`` is set (every target and draft prefill chunk too);
    every draft decode step calls K1's (on the CPU both take their
    plain versions, counted as plain calls)."""
    _, pp = weights
    calls = {"k3": 0}
    k3 = PE.paged_flash_prefill

    def counting(*a):
        calls["k3"] += 1
        return k3(*a)

    monkeypatch.setattr(PE, "paged_flash_prefill", counting)
    PFP.COUNTS.reset()
    PPA.COUNTS.reset()
    eng = PE.ServingEngine(pp, PT.TINY_LM, device="cpu", spec_k=3,
                           draft_layers=2, paged_kernel=True,
                           flash_prefill=flash, **ENGINE)
    for p in _prompts_with_shared_prefix(3, seed=5):
        eng.submit(p, max_new_tokens=8)
    eng.run()
    L, Ld = PT.TINY_LM.num_hidden_layers, 2
    chunks, verifies = eng.stats["prefill_chunks"], eng.stats["decode_steps"]
    want = chunks * (L + Ld) + verifies * L if flash else 0
    assert calls["k3"] == want
    assert PFP.COUNTS.plain_calls == chunks * (L + Ld) + verifies * L
    assert (PPA.COUNTS.launches, PPA.COUNTS.plain_calls) == (
        0, eng.stats["draft_steps"] * Ld)
    assert eng.stats["draft_steps"] == verifies * 3


# ---- refusals, host API, telemetry ----------------------------------------

@pytest.mark.parametrize("kw,err,match", [
    (dict(mesh=object()), ValueError, "pass mesh or device, not both"),
    (dict(disaggregate=True), ValueError, "disaggregate splits it"),
    (dict(disaggregate=True, prefix_cache=True), ValueError,
     "prefix_cache aliases"),
    (dict(disaggregate=True, spec_k=2, draft_layers=1), ValueError,
     "resident draft pool"),
    (dict(spec_k=2), ValueError, "draft_layers"),
    (dict(spec_k=2, draft_params={}), ValueError, "draft_cfg"),
    (dict(spec_k=2, draft_layers=9), ValueError, "draft of 9 layers"),
    (dict(flash_prefill=True, kv_quant=True), ValueError, "float-only"),
    (dict(hbm_budget_gb=1e-6), ValueError, "HBM budget"),
])
def test_engine_refusals(weights, kw, err, match):
    _, pp = weights
    with pytest.raises(err, match=match):
        PE.ServingEngine(pp, PT.TINY_LM, device="cpu", **ENGINE, **kw)


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_hbm_budget_sizes_the_pool_as_the_reference(weights, spec):
    """A budget that fits about 12 pages after the weights (and the
    draft's weights and pool twin, priced as resident): both engines
    size the same pool, and its predicted waterline stays within the
    usable budget (the planner's inverse law)."""
    from distributed_training_sandbox_tpu_torch.serving import accounting
    jp, pp = weights
    cfg = PT.TINY_LM
    kw = dict(ENGINE, max_batch=4)
    per = accounting.page_bytes(cfg, 8)
    wb, dwb = accounting.tree_bytes(pp), 0
    if spec:
        kw.update(spec_k=2, draft_layers=2)
        draft, dcfg = PE.make_draft_params(pp, cfg, 2)
        dwb = accounting.tree_bytes(draft)
        per += accounting.page_bytes(dcfg, 8)
    budget = (wb + dwb + 12.5 * per) / 0.9 / accounting.GB
    kw["hbm_budget_gb"] = budget
    jeng = JE.ServingEngine(jp, JT.TINY_LM, **kw)
    eng = PE.ServingEngine(pp, cfg, device="cpu", **kw)
    assert eng.n_pages == jeng.n_pages == 13
    pred = eng.slo_report()["pool"]["predicted_gb"]
    assert pred == pytest.approx(jeng._mem_prediction["predicted_gb"],
                                 abs=1e-3)
    # the planner's pages (the null page aside) stay within the budget
    assert accounting.serve_waterline_gb(
        cfg, eng.n_pages - 1, 8, weight_bytes=wb, draft_weight_bytes=dwb,
        draft_cfg=eng.draft_cfg) <= 0.9 * budget < pred


def test_host_api_and_hot_swap(weights):
    _, pp = weights
    eng = PE.ServingEngine(pp, PT.TINY_LM, device="cpu", spec_k=2,
                           draft_layers=1, **ENGINE)
    prompts = _prompts_with_shared_prefix(3)
    reqs = [eng.submit(p, max_new_tokens=4) for p in prompts]
    assert [r.trace_id for r in reqs] == ["tr-000000", "tr-000001",
                                          "tr-000002"]
    eng.start(t0=0.0)
    assert eng._t0 == 0.0
    for r in reqs:
        eng.enqueue(r, now=0.0)
    eng._pending = []
    assert eng.in_flight() == 3 and not eng.can_accept(reqs[0])
    eng.step_round(now=0.0)
    with pytest.raises(RuntimeError, match="in flight"):
        eng.swap_params(pp)
    orphans = eng.release_all()
    assert sorted(r.rid for r in orphans) == [0, 1, 2]
    assert eng.in_flight() == 0 and not eng._h_active.any()
    assert eng.pool.allocator.free_pages == eng.n_pages - 1
    eng.abandon_pump()
    assert eng._pump is None
    eng.swap_params(pp)
    for r in orphans:
        eng.enqueue(r, now=0.0)
    while eng.batcher.has_work():
        eng.step_round(now=0.0)
    eng.close_pump()
    for r in orphans:
        assert r.tokens == port_generate(
            pp, r.prompt[None], PT.TINY_LM, max_new_tokens=4,
            cache_capacity=eng.view_capacity, device="cpu")[0].tolist()


def test_telemetry_records_serve_spans_and_steps(weights, tmp_path):
    import json
    _, pp = weights
    with TelemetryRun("serving", config={"num_steps": 0},
                      results_dir=str(tmp_path)) as telem:
        eng = PE.ServingEngine(pp, PT.TINY_LM, device="cpu", spec_k=2,
                               draft_layers=1, prefix_cache=True,
                               telem=telem, **ENGINE)
        for p in _prompts_with_shared_prefix(3):
            eng.submit(p, max_new_tokens=5)
        eng.run()
        telem.finalize(serving=eng.slo_report())
    run = tmp_path / telem.run_id
    spans = [json.loads(x) for x in (run / "spans.jsonl").read_text()
             .splitlines()]
    names = {s["name"] for s in spans}
    assert {"serve/prefill_chunk", "serve/spec_burst"} <= names
    steps = [json.loads(x) for x in (run / "steps.jsonl").read_text()
             .splitlines()]
    phases = [s.get("phase") for s in steps]
    assert phases.count("prefill") == 3 and "decode" in phases
    assert any(s.get("spec_accept_rate") is not None for s in steps)
    sp = eng.slo_report()["speculative"]
    m = telem.metrics
    assert m.counter_total("spec_proposed_total") == sp["proposed"] > 0
    assert m.counter_total("spec_accepted_total") == sp["accepted"]
    assert m.counter_total("prefix_cache_hit_pages_total") \
        == eng.prefix_cache.hit_pages > 0
    assert m.counter_total("batcher_completed_total") == 3
    summary = json.loads((run / "summary.json").read_text())
    assert summary["serving"]["speculative"] == sp

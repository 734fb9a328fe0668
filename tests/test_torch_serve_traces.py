"""The port's traffic traces, serving accounting and the two serving
twins against the JAX reference, on the CPU.

``serving/traces.py`` is the reference's generator copied, so a seed
draws byte-identical traces in both packages: digests equal for several
seeds and each generator, and the reference suite's golden digest
(``tests/test_sim.py``).  The accounting's draft-model and ``tp`` terms
equal the reference's, with the planner's inverse law.  The twins run
in-process: ``train.serve_bench`` exits 0 with the prefix cache and with
speculation, its ``summary.json`` ``serving`` block has the reference's
keys (but the recompile watch, which has no eager counterpart), and
the fleet's, TP's and disaggregation's flags pinned, a profiled serve
exported as one timeline (``--export-timeline``), ``--plan`` (A12)
exits 2;
``train.decode_bench`` writes rows with the reference's keys.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_sandbox_tpu.models import transformer as JT
from distributed_training_sandbox_tpu.serving import accounting as JA
from distributed_training_sandbox_tpu.serving import engine as JE
from distributed_training_sandbox_tpu.serving import traces as JTR
from distributed_training_sandbox_tpu_torch.models import transformer as PT
from distributed_training_sandbox_tpu_torch.serving import accounting as PA
from distributed_training_sandbox_tpu_torch.serving import traces as PTR
from distributed_training_sandbox_tpu_torch.train import decode_bench
from distributed_training_sandbox_tpu_torch.train import serve_bench
torch.set_num_threads(1)  # the suite's workers share the cores


# ---- traces -----------------------------------------------------------------

TRACES = {
    "tenant": lambda K, s: K.build_tenant_trace(
        np.random.default_rng(s), 64, 16.0, 256, 80, tenants=4,
        overlap_frac=0.6, sys_len=16),
    "plain": lambda K, s: K.build_trace(
        np.random.default_rng(s), 48, 8.0, 512, 96),
    "triples": lambda K, s: K.build_trace(
        np.random.default_rng(s), 24, 8.0, 512, 96, tenants=3,
        overlap_frac=0.7, sys_len=24),
    "fleet": lambda K, s: K.build_fleet_trace(
        np.random.default_rng(s), 500, base_rate=50.0, vocab=1000,
        max_seq_len=128, tenants=6, flash_crowds=((2.0, 1.0, 4.0),)),
}


@pytest.mark.parametrize("seed", [0, 3, 42])
@pytest.mark.parametrize("kind", sorted(TRACES))
def test_traces_are_byte_identical_to_the_reference(kind, seed):
    ref, got = TRACES[kind](JTR, seed), TRACES[kind](PTR, seed)
    assert len(got) == len(ref)
    assert PTR.trace_digest(got) == JTR.trace_digest(ref)
    if kind in ("tenant", "fleet"):
        assert [r.tenant for r in got] == [r.tenant for r in ref]


def test_trace_golden_digest():
    t = PTR.build_tenant_trace(np.random.default_rng(0), 64, 16.0, 256, 80,
                               tenants=4, overlap_frac=0.6, sys_len=16)
    assert PTR.trace_digest(t) == ("6e3e21f95554d0b602259452f2e1b761"
                                   "e6a008366f1fd5702f69a741aae4aacf")


def test_zipf_cdf_and_fleet_guards_equal_the_reference():
    for n, skew in ((1, 1.1), (8, 1.1), (5, 0.0)):
        assert (PTR._zipf_cdf(n, skew) == JTR._zipf_cdf(n, skew)).all()
    with pytest.raises(ValueError, match="tenants >= 1"):
        PTR.build_fleet_trace(np.random.default_rng(0), 4, base_rate=1.0,
                              vocab=10, max_seq_len=32, tenants=0)


# ---- accounting -------------------------------------------------------------

def _cfgs(dtype):
    return (dataclasses.replace(JT.SMOLLM3_3B, dtype=jnp.dtype(dtype)),
            dataclasses.replace(PT.SMOLLM3_3B, dtype=getattr(torch, dtype)))


@pytest.mark.parametrize("kv_quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_accounting_draft_terms_equal_the_reference(dtype, kv_quant):
    jcfg, pcfg = _cfgs(dtype)
    jd = dataclasses.replace(jcfg, num_hidden_layers=4)
    pd = dataclasses.replace(pcfg, num_hidden_layers=4)
    for tp in (1, 2, 4):
        assert PA.page_bytes(pcfg, 16, kv_quant=kv_quant, tp=tp) \
            == JA.page_bytes(jcfg, 16, kv_quant=kv_quant, tp=tp)
    kw = dict(weight_bytes=6 * 10 ** 9, kv_quant=kv_quant)
    assert PA.serve_waterline_gb(pcfg, 1025, 16, **kw) \
        == JA.serve_waterline_gb(jcfg, 1025, 16, **kw)
    got = PA.serve_waterline_gb(pcfg, 1025, 16, draft_weight_bytes=10 ** 9,
                                draft_cfg=pd, **kw)
    assert got == JA.serve_waterline_gb(jcfg, 1025, 16,
                                        draft_weight_bytes=10 ** 9,
                                        draft_cfg=jd, **kw)
    for budget in (8.0, 20.0, 80.0):
        for draft in ((0, None, None), (10 ** 9, pd, jd)):
            n = PA.pool_capacity_pages(
                pcfg, 16, budget_gb=budget, draft_weight_bytes=draft[0],
                draft_cfg=draft[1], **kw)
            assert n == JA.pool_capacity_pages(
                jcfg, 16, budget_gb=budget, draft_weight_bytes=draft[0],
                draft_cfg=draft[2], **kw)
            # the inverse law: N pages fit the usable budget, N + 1 not
            if n:
                w = lambda m: PA.serve_waterline_gb(
                    pcfg, m, 16, draft_weight_bytes=draft[0],
                    draft_cfg=draft[1], **kw)
                assert w(n) <= budget * 0.9 < w(n + 1)
    assert PA.pool_capacity_pages(pcfg, 16, budget_gb=1.0, **kw) == 0


# ---- the serve_bench twin ---------------------------------------------------

def _reference_serving_keys():
    """The keys of the reference's ``serving`` block: the engine's SLO
    report with the cache and speculation on, and the twin's own two."""
    jp = JT.init_params(jax.random.PRNGKey(0), JT.TINY_LM)
    eng = JE.ServingEngine(jp, JT.TINY_LM, max_batch=2, page_size=8,
                           max_seq_len=48, prefix_cache=True, spec_k=2,
                           draft_layers=1)
    eng.submit(np.arange(1, 12, dtype=np.int32), max_new_tokens=3)
    eng.run()
    rep = eng.slo_report()
    keys = {k: (sorted(v) if isinstance(v, dict) else None)
            for k, v in rep.items()}
    keys.update(parity_checked=None, failures=None)
    return keys


@pytest.fixture(scope="module")
def reference_keys():
    return _reference_serving_keys()


def _summary(tmp_path):
    (run,) = [p for p in tmp_path.iterdir() if p.is_dir()]
    return json.loads((run / "summary.json").read_text())


@pytest.mark.parametrize("flags", [
    ["--prefix-cache", "--tenants", "3"],
    ["--spec-k", "3", "--draft-layers", "1"],
    ["--prefix-cache", "--tenants", "2", "--spec-k", "2", "--draft-layers",
     "2", "--kv-quant"],
], ids=["cache", "spec", "cache+spec-kvq"])
def test_serve_bench_twin_runs_on_the_cpu(tmp_path, reference_keys, flags):
    rc = serve_bench.main(["--device", "cpu", "--requests", "12",
                           "--results-dir", str(tmp_path), *flags])
    assert rc == 0
    summary = _summary(tmp_path)
    assert summary["status"] == "completed"
    serving = summary["serving"]
    assert serving["completed"] == serving["requests"] == 12
    assert serving["failures"] == [] and serving["parity_checked"] == 4
    assert serving["parity"] == {"checked": 4, "exact": True}
    for k, sub in reference_keys.items():
        if k == "recompiles_after_warmup":
            assert k not in serving      # nothing retraces in eager mode
            continue
        on = {"prefix_cache": "--prefix-cache", "speculative": "--spec-k"}
        if k in on and on[k] not in flags:
            assert k not in serving
            continue
        assert k in serving, k
        if sub is not None:
            assert set(sub) <= set(serving[k]), (k, sub)
    if "--prefix-cache" in flags:
        assert serving["prefix_cache"]["hit_pages"] > 0
    if "--spec-k" in flags:
        assert serving["speculative"]["proposed"] > 0
    steps = (next(tmp_path.iterdir()) / "steps.jsonl").read_text()
    assert '"phase": "prefill"' in steps and '"phase": "decode"' in steps


def test_serve_bench_serving_keys_are_the_reference_engines(reference_keys):
    """``chip_smoke.SERVING_KEYS`` (what phase 18d checks on the card,
    where there is no JAX) is the reference's list but the recompile
    watch."""
    import chip_smoke
    want = {k: v for k, v in reference_keys.items()
            if k != "recompiles_after_warmup"}
    assert chip_smoke.SERVING_KEYS == want


@pytest.mark.parametrize("flags,rc,match", [
    (["--replicas", "2"], 0, "fleet x2: 6 completed / 0 shed / 0 dropped"),
    (["--tp", "2"], 2, "1 ranks not divisible by tp=2"),
    (["--disaggregate"], 0, "handoff"),
    (["--inject-fault", "kill_replica@2:1"], 2, "needs --replicas >= 2"),
    (["--deadline-ms", "400"], 2, "needs --replicas >= 2"),
    (["--swap-at", "4"], 2, "needs --replicas >= 2"),
    (["--replicas", "2", "--swap-at", "2", "--swap-ckpt", "{tmp}/none"], 0,
     "no checkpoint steps found"),
    (["--replicas", "2", "--watchdog-timeout", "1", "--inject-fault",
      "hang_decode@1:0"], 0, "'replica_dead'"),
    (["--replicas", "2", "--max-queue", "0"], 0, "0 completed / 6 shed"),
    (["--replicas", "2", "--burst-ms", "1000", "--deadline-ms", "500"], 0,
     "0 completed / 6 shed"),
    (["--profile", "--trace-dir", "{tmp}/tr", "--export-timeline"], 0,
     "host spans + "), (["--plan", "p.json"], 2, "A12"),
])
def test_serve_bench_refuses_the_second_half(tmp_path, capsys, flags, rc,
                                             match):
    """What the twin refuses (exit 2, no run directory): the tuner's
    plan (A12), the fleet's flags without a fleet, more tp ranks than the
    group has; and what it runs now that the fleet, TP serving,
    disaggregation and the timeline export are ported: the fleet, a
    missing swap checkpoint (the fleet keeps its weights), a wedged
    decode burst failed over, every arrival shed by a zero queue or a
    deadline under the modeled TTFT, a profiled serve exported as one
    timeline."""
    flags = [f.replace("{tmp}", str(tmp_path)) for f in flags]
    got = serve_bench.main(["--device", "cpu", "--requests", "6",
                            "--max-batch", "2", "--sync-every", "2",
                            "--check-parity", "2", "--results-dir",
                            str(tmp_path / "runs"), *flags])
    out = capsys.readouterr()
    assert got == rc, out.err[-2000:]
    assert match in out.out + out.err
    assert (tmp_path / "runs").exists() == (rc == 0)


def test_serve_bench_model_names_and_params():
    assert serve_bench.model_config("TINY_LM") is PT.TINY_LM
    assert serve_bench.model_config("smollm3-3b") is PT.SMOLLM3_3B
    with pytest.raises(ValueError, match="unknown model"):
        serve_bench.model_config("gpt5")
    a = serve_bench.build_params(PT.TINY_LM, 3, 3.0, "cpu")
    b = serve_bench.build_params(PT.TINY_LM, 3, 1.0, "cpu")
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"] * 3.0)


def test_argmax_gaps_are_zero_on_generates_own_stream():
    """The card's near-argmax law, on the CPU: ``generate``'s own greedy
    stream, teacher-forced, is the argmax at every row; another token
    is not."""
    cfg = PT.TINY_LM
    params = serve_bench.build_params(cfg, 0, 3.0, "cpu")
    from distributed_training_sandbox_tpu_torch.models.generate import (
        generate)
    prompt = np.arange(3, 14, dtype=np.int32)
    toks = generate(params, prompt[None], cfg, max_new_tokens=9,
                    cache_capacity=32, device="cpu")[0].numpy()
    gaps = serve_bench.argmax_gaps(params, cfg, prompt, toks, capacity=32)
    assert gaps.shape == (9,) and float(gaps.abs().max()) == 0.0
    bad = toks.copy()
    bad[4] = (bad[4] + 1) % cfg.vocab_size
    assert float(serve_bench.argmax_gaps(params, cfg, prompt, bad,
                                         capacity=32)[4]) > 0.0


# ---- the decode_bench twin --------------------------------------------------

def test_decode_bench_rows_have_the_reference_keys(tmp_path):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "scripts" / \
        "decode_bench.py"
    spec = importlib.util.spec_from_file_location("ref_decode_bench", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    jp = JT.init_params(jax.random.PRNGKey(0), JT.TINY_LM)
    want = set(ref.run_one(JT.TINY_LM, jp, "bf16", 2, 8, 4, "cpu"))
    rows = decode_bench.main(["--device", "cpu", "--model", "tiny",
                              "--batch", "2", "--prompt", "8", "--new", "4",
                              "--out-dir", str(tmp_path)])
    rows_q8 = decode_bench.main(["--device", "cpu", "--model", "tiny",
                                 "--precision", "int8", "--kv-quant",
                                 "--batch", "2", "--prompt", "8", "--new",
                                 "4", "--out-dir", str(tmp_path),
                                 "--out-file", "q8.json"])
    for row in rows + rows_q8:
        assert want | {"model", "platform"} <= set(row)
        # a reading is a positive slope; a non-positive one is marked
        # failed, never reported as a reading
        if row["failed_reading"] is None:
            assert row["steady_ms_per_step"] > 0
            assert row["steady_decode_tokens_per_sec"] > 0
        else:
            assert row["steady_ms_per_step"] is None
            assert row["steady_decode_tokens_per_sec"] is None
            assert row["failed_reading"].startswith("non-positive slope")
        assert row["read_roofline_ms_per_step"] is None   # no card
    assert rows_q8[0]["precision"] == "int8+kvq"
    assert rows_q8[0]["weight_gib"] < rows[0]["weight_gib"]
    assert json.loads((tmp_path / "decode_cpu.json").read_text()) == rows

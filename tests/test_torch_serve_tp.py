"""Tensor-parallel serving, the serving contracts and the disaggregated
engine of the port against the JAX reference's, on the CPU.

* TP serving on 2 gloo ranks (child processes importing torch, numpy
  and the port only): the engine under ``mesh`` (``grid_axes``) at tp 2
  on TINY_LM f32, weights ×3 bridged from the reference, emits the JAX
  engine's tokens under its dp × tp mesh at tp 2
  (``tests/test_serving.py:163``) bit for bit, on every rank — on the
  gather path, with the batched prefill, with speculation, on an int8
  pool — and the recording shim counts 2 · L all_reduces a layer-stack
  pass (``serve_decode``'s generated contract) and nothing else;
* the four ``serve`` contracts: the port's generated and hand counts
  against the reference's ``_serve_counts`` and ``CONTRACTS``;
* the disaggregated engine on a ``("cpu", "cpu")`` pair, float and int8
  pools, against the JAX engine with ``disaggregate=True`` (``:185``)
  and against the port's engine without the flag, bit for bit; the
  handoff moves exactly the prompt pages' bytes;
* the reference's refusals, with its messages.
"""

import json

import jax
import numpy as np
import pytest
import torch
from test_torch_fsdp import _flat, spawn_ranks

from distributed_training_sandbox_tpu.analysis import contract_gen as JG
from distributed_training_sandbox_tpu.analysis.contracts import (
    CONTRACTS as JCONTRACTS, ContractContext)
from distributed_training_sandbox_tpu.analysis.rules import (
    RULESETS as JRULES)
from distributed_training_sandbox_tpu.models import transformer as JT
from distributed_training_sandbox_tpu.models.generate import (
    quantize_decode_params as jax_quantize_decode_params)
from distributed_training_sandbox_tpu.serving import (
    ServingEngine as JEngine)
from distributed_training_sandbox_tpu.utils import make_mesh
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.analysis import contract_gen as G
from distributed_training_sandbox_tpu_torch.models import transformer as PT
from distributed_training_sandbox_tpu_torch.models.generate import (
    quantize_decode_params)
from distributed_training_sandbox_tpu_torch.parallel import contracts as HC
from distributed_training_sandbox_tpu_torch.parallel.tensor import (
    check_tp_divisibility)
from distributed_training_sandbox_tpu_torch.serving import accounting
from distributed_training_sandbox_tpu_torch.serving import engine as PE
from distributed_training_sandbox_tpu_torch.serving.kv_pool import PagedKVPool
from distributed_training_sandbox_tpu_torch.utils import mesh
torch.set_num_threads(1)  # the suite's workers share the cores

ENG = dict(max_batch=2, page_size=8, max_seq_len=32, prefill_chunk=8)
NEW = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """TINY_LM's ops are too small to gain from intra-op threads; the
    suite's workers share the cores, so the module runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(seed):
    jp = JT.init_params(jax.random.PRNGKey(seed), JT.TINY_LM)
    jp = jax.tree.map(lambda x: (x * 3.0).astype(x.dtype), jp)
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                      PT.TINY_LM)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, PT.TINY_LM.vocab_size, size=n).astype(np.int32)
            for n in lens]


def _serve(eng, prompts):
    reqs = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
    eng.run()
    return [list(map(int, r.tokens)) for r in reqs]


# ---- TP serving on two gloo ranks ---------------------------------------

TP_CASES = {"gather": {}, "flash": {"flash_prefill": True},
            "spec": {"spec_k": 2, "draft_layers": 1},
            "kvq": {"kv_quant": True}}

WORKER = r"""
import json, sys
from pathlib import Path
import numpy as np
import torch
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.models import transformer as T
from distributed_training_sandbox_tpu_torch.ops import collectives as C
from distributed_training_sandbox_tpu_torch.serving import engine as E
from distributed_training_sandbox_tpu_torch.utils import mesh

work = Path(sys.argv[1])
dev = mesh.init_process_group("cpu")
r = mesh.axis_rank()
grid = mesh.grid_axes(("tp",), (mesh.axis_size(),))
tree = {}
for key, v in dict(np.load(work / "params.npz")).items():
    *parents, leaf = key.split("/")
    node = tree
    for p in parents:
        node = node.setdefault(p, {})
    node[leaf] = v
params = bridge.params_from_jax(tree, T.TINY_LM)
prompts = [np.asarray(p, np.int32) for p in json.loads(
    (work / "prompts.json").read_text())]
cases = json.loads((work / "cases.json").read_text())
eng_kw = json.loads((work / "engine.json").read_text())
res = {}
for name, kw in cases.items():
    eng = E.ServingEngine(params, T.TINY_LM, mesh=grid, tp_axis="tp",
                          **eng_kw, **kw)
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    C.COLLECTIVES.reset()
    eng.run()
    res[name] = {"tokens": [list(map(int, q.tokens)) for q in reqs],
                 "counts": C.COLLECTIVES.read(),
                 "sites": C.COLLECTIVES.sites(),
                 "stats": {k: eng.stats[k] for k in (
                     "decode_steps", "prefill_chunks", "draft_steps")},
                 "pool_heads": int(eng.pool.bufs.k[0].shape[2]),
                 "wq": list(eng._params["layers"]["wq"].shape),
                 "devices": eng.slo_report()["devices"]}
(work / f"rank{r}.json").write_text(json.dumps(res))
mesh.destroy_process_group()
"""


@pytest.fixture(scope="module")
def tp_world(procs2, tmp_path_factory):
    jp, pp = _weights(1)
    prompts = _prompts(11, (5, 13, 9))
    work = tmp_path_factory.mktemp("serve_tp")
    np.savez(work / "params.npz",
             **dict(_flat(jax.tree.map(np.asarray, jp))))
    (work / "prompts.json").write_text(json.dumps(
        [p.tolist() for p in prompts]))
    (work / "cases.json").write_text(json.dumps(TP_CASES))
    (work / "engine.json").write_text(json.dumps(ENG))
    spawn_ranks(["-c", WORKER, str(work)], 2, procs2.free_port())
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(2)]
    m = make_mesh({"dp": len(jax.devices()) // 2, "tp": 2}, register=False)
    ref = {"gather": _serve(JEngine(jp, JT.TINY_LM, mesh=m, **ENG),
                            prompts),
           "kvq": _serve(JEngine(jp, JT.TINY_LM, mesh=m, kv_quant=True,
                                 **ENG), prompts)}
    return ranks, ref


@pytest.mark.parametrize("case", list(TP_CASES))
def test_tp2_engine_emits_the_jax_engines_tokens(tp_world, case):
    ranks, ref = tp_world
    want = ref["kvq" if case == "kvq" else "gather"]
    for rk in ranks:
        assert rk[case]["tokens"] == want
        assert rk[case]["pool_heads"] == PT.TINY_LM.num_key_value_heads // 2
        assert rk[case]["wq"] == [4, 64, 32]      # this rank's columns
        assert rk[case]["devices"] == 2


@pytest.mark.parametrize("case", list(TP_CASES))
def test_tp2_shim_counts_the_serve_contract(tp_world, case):
    """Every layer-stack pass (a decode step, a prefill chunk, a verify,
    a draft step) makes the generated ``serve_*`` contract's calls: 2 ·
    its layers all_reduces and no other collective."""
    L, Ld = PT.TINY_LM.num_hidden_layers, 1
    ranks, _ = tp_world
    per = G.generate_counts("serve_decode", _weights(1)[1], G.Ctx({"tp": 2}))
    assert per["all_reduce"] == 2 * L
    for rk in ranks:
        st, counts = rk[case]["stats"], rk[case]["counts"]
        passes = st["decode_steps"] + st["prefill_chunks"]
        want = passes * per["all_reduce"]
        if case == "spec":
            want += (st["prefill_chunks"] + st["draft_steps"]) * 2 * Ld
        assert counts["all_reduce"] == want
        assert {k: v for k, v in counts.items() if k != "all_reduce"} \
            == dict.fromkeys(G.KINDS[1:], 0)


@pytest.mark.parametrize("case", list(TP_CASES))
def test_tp2_serve_keeps_no_collective_sites(tp_world, case):
    """A server never resets the shim, so it must not grow its site list:
    sites are kept only inside a ``capture``, which serving never opens
    (its all_reduces still count)."""
    ranks, _ = tp_world
    for rk in ranks:
        assert rk[case]["counts"]["all_reduce"] > 0
        assert rk[case]["sites"] == []


@pytest.mark.parametrize("strategy", HC.SERVE_STRATEGIES)
def test_serve_counts_equal_the_references(strategy):
    rs = JRULES[strategy]
    for L in (1, 2, 4):
        tree = G._tiny_tree(L)
        for tp in (1, 2, 4):
            ctx = ContractContext(n_layers=L, axis_sizes={"tp": tp})
            want = JG._serve_counts(rs)(ctx)
            assert want == JCONTRACTS[strategy].counts(ctx)
            got = G.generate_counts(strategy, tree, G.Ctx({"tp": tp}))
            assert got == {**dict.fromkeys(G.KINDS, 0), **want}
            assert HC.serve_step_collectives(tree) == got
    assert G.diff_contract(strategy).ok


# ---- the disaggregated engine -------------------------------------------

@pytest.mark.parametrize("kv_quant", [False, True], ids=["float", "int8"])
def test_disaggregated_engine_equals_jax_and_the_plain_engine(kv_quant):
    jp, pp = _weights(2)
    prompts = _prompts(13, (6, 17, 3))
    want = _serve(JEngine(jp, JT.TINY_LM, disaggregate=True,
                          kv_quant=kv_quant, **ENG), prompts)
    eng = PE.ServingEngine(pp, PT.TINY_LM, disaggregate=True,
                           device=("cpu", "cpu"), kv_quant=kv_quant, **ENG)
    got = _serve(eng, prompts)
    plain = _serve(PE.ServingEngine(pp, PT.TINY_LM, device="cpu",
                                    kv_quant=kv_quant, **ENG), prompts)
    assert got == want == plain
    slo = eng.slo_report()
    assert slo["disaggregated"] is True and slo["devices"] == 1
    pages = sum(-(-len(p) // ENG["page_size"]) for p in prompts)
    per_page = accounting.page_bytes(PT.TINY_LM, ENG["page_size"],
                                     kv_quant=kv_quant)
    assert slo["handoff"]["requests"] == 3
    assert slo["handoff"]["bytes"] == pages * per_page
    # every prefill page went back; the decode pool holds nothing
    assert eng.pool_pre.allocator.free_pages == eng.n_pages - 1
    assert eng.pool.allocator.free_pages == eng.n_pages - 1
    assert not eng._pre_pages


def test_disaggregated_batched_prefill_and_failover_release():
    """The batched prefill hands off every finishing row; ``release_all``
    frees the prefill pages of requests caught mid-prefill."""
    _, pp = _weights(2)
    prompts = _prompts(14, (20, 11))
    plain = _serve(PE.ServingEngine(pp, PT.TINY_LM, device="cpu", **ENG),
                   prompts)
    eng = PE.ServingEngine(pp, PT.TINY_LM, disaggregate=True,
                           device=("cpu", "cpu"), flash_prefill=True, **ENG)
    assert _serve(eng, prompts) == plain
    eng = PE.ServingEngine(pp, PT.TINY_LM, disaggregate=True,
                           device=("cpu", "cpu"), **ENG)
    for p in prompts:
        eng.submit(p, max_new_tokens=NEW)
    eng.batcher.submit(eng._pending.pop(0), 0.0)
    eng.batcher.submit(eng._pending.pop(0), 0.0)
    eng.start()
    eng.step_round(0.0)                  # 2 chunks: the first is mid-way
    assert eng._pre_pages
    orphans = eng.release_all()
    assert len(orphans) == 2 and not eng._pre_pages
    assert eng.pool_pre.allocator.free_pages == eng.n_pages - 1


# ---- refusals ------------------------------------------------------------

def _message(fn):
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return str(e)
    raise AssertionError("no refusal")


@pytest.mark.parametrize("case", [
    "mesh+device", "mesh+disaggregate", "tp+unembed_q",
    "disaggregate+prefix_cache", "disaggregate+spec", "device+disaggregate",
])
def test_refusals_carry_the_references_messages(case):
    jp, pp = _weights(0)
    jm = make_mesh({"dp": len(jax.devices()) // 2, "tp": 2}, register=False)
    pm = mesh.grid_axes(("tp",), (1,))
    jkw, pkw = {"mesh+device": (dict(mesh=jm, device=jax.devices()[0]),
                                dict(mesh=pm, device="cpu")),
                "mesh+disaggregate": (dict(mesh=jm, disaggregate=True),
                                      dict(mesh=pm, disaggregate=True)),
                "tp+unembed_q": (dict(mesh=jm), dict(mesh=pm)),
                "disaggregate+prefix_cache": (
                    dict(disaggregate=True, prefix_cache=True),
                    dict(disaggregate=True, prefix_cache=True)),
                "disaggregate+spec": (
                    dict(disaggregate=True, spec_k=2, draft_layers=1),
                    dict(disaggregate=True, spec_k=2, draft_layers=1)),
                "device+disaggregate": (
                    dict(disaggregate=True, device=jax.devices()[0]),
                    dict(disaggregate=True, device="cpu"))}[case]
    if case == "tp+unembed_q":
        jp = jax_quantize_decode_params(jp, JT.TINY_LM)
        pp = quantize_decode_params(pp, PT.TINY_LM)
    want = _message(lambda: JEngine(jp, JT.TINY_LM, **jkw, **ENG))
    got = _message(lambda: PE.ServingEngine(pp, PT.TINY_LM, **pkw, **ENG))
    assert got.startswith(want.rstrip(".")), (got, want)


def test_tp_divisibility_and_pool_accounting():
    with pytest.raises(ValueError, match="tp=3 must divide"):
        check_tp_divisibility(PT.TINY_LM, 3)
    pool = PagedKVPool(PT.TINY_LM, 5, 8, device="cpu", tp=2)
    assert pool.bufs.k[0].shape == (5, 8, 1, 16)
    assert accounting.page_bytes(PT.TINY_LM, 8, tp=2) * 2 == \
        accounting.page_bytes(PT.TINY_LM, 8)

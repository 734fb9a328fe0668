"""The MoE twins of A2 (``train/moe_bench.py``, ``train/moe_profile.py``,
``train/moe_quality_ab.py``) on the CPU, at TINY_LM scale.

- ``moe_bench``: two tiny rows through the FSDP twin carry the
  reference's row keys (``bench.py`` ``_timed_rows``, ``:295-300``, with
  ``config``), a failing row the reference's error-row keys; the drop
  rates come from ``grouped_drop_fraction``, and the port's and the
  reference's give one shared assignment bit-equal fractions (the same
  integer counts over the same f32 mean).
- ``moe_profile``: one profiled step on the CPU (a trace without device
  activity, read on the host) holds every reference phase, each with
  time; ``phase_split`` on a synthetic CUDA trace gives a kernel to the
  range around its launch and a backward kernel to its forward op's
  range (the ``Sequence number`` link), and a recompute's op inside the
  backward, its number colliding, takes none.
- ``moe_quality_ab --tiny`` at two seconds a leg: the reference's keys,
  finite eval losses, a drop trajectory for each MoE leg.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_sandbox_tpu.parallel import expert as JE
from distributed_training_sandbox_tpu_torch.parallel import expert as PE
from distributed_training_sandbox_tpu_torch.train import (moe_bench,
                                                          moe_profile,
                                                          moe_quality_ab)
from distributed_training_sandbox_tpu_torch.train.bench_row import \
    measure_row
from distributed_training_sandbox_tpu_torch.utils import trace_analysis
torch.set_num_threads(1)  # the suite's workers share the cores

ROW_KEYS = {"model", "seq_len", "batch", "devices", "platform",
            "tokens_per_sec", "step_ms", "tflops_per_device", "config"}
ERROR_KEYS = {"model", "seq_len", "batch", "config", "error"}
PROFILE_KEYS = {"model", "seq_len", "batch", "platform", "capacity_factor",
                "dispatch", "step_ms", "tokens_per_sec", "phase_ms_per_step"}
LEG_KEYS = {"name", "config", "seq", "batch", "seconds", "steps",
            "tokens_per_second", "final_eval_loss", "losses", "times",
            "evals", "drop_trajectory"}
VERDICT_KEYS = {"final_eval_loss", "delta_vs_dense", "tokens_per_second",
                "final_drop_rate"}


def test_moe_bench_two_tiny_rows(tmp_path):
    doc = moe_bench.main(["--device", "cpu", "--model", "tiny", "--seq",
                          "32", "--rows", "0,3", "--steps", "1",
                          "--out-dir", str(tmp_path)])
    assert json.loads((tmp_path / "moe_cpu.json").read_text()) == doc
    assert set(doc) == {"rows", "drop_rates_at_init"}
    for row, (over, b) in zip(doc["rows"], [moe_bench.GRID[0],
                                            moe_bench.GRID[3]]):
        assert ROW_KEYS <= set(row), row
        assert row["config"] == {**moe_bench.TINY_BASE, **over}
        assert (row["seq_len"], row["batch"], row["platform"]) == \
            (32, b, "cpu")
        assert row["tokens_per_sec"] > 0 and row["step_ms"] > 0
        assert all(np.isfinite(row["losses"]))
    assert [(r["top_k"], r["capacity_factor"])
            for r in doc["drop_rates_at_init"]] == \
        [(k, cf) for k in (1, 2) for cf in (2.0, 1.25, 1.0)]


def test_a_failing_row_is_the_references_error_row():
    # top-2 needs the grouped dispatch: the config itself refuses
    row = measure_row("tiny", 16, 2, num_steps=1, device="cpu",
                      cfg_overrides={"n_experts": 4, "moe_ffn": 8,
                                     "moe_dispatch": "sort",
                                     "moe_top_k": 2})
    assert ERROR_KEYS <= set(row) and "tokens_per_sec" not in row
    assert row["failure"] == "error" and "grouped" in row["error"]


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cf", [2.0, 1.25, 1.0])
def test_drop_fractions_are_bit_equal_to_the_references(k, cf):
    rng = np.random.default_rng(3)
    E, N = 8, 512
    logits = rng.standard_normal((N, E)).astype(np.float32)
    assignment = np.argsort(-logits, axis=-1, kind="stable")[:, :k]
    got = PE.grouped_drop_fraction(torch.from_numpy(assignment), E, 128, cf)
    want = JE.grouped_drop_fraction(jnp.asarray(assignment, jnp.int32), E,
                                    128, cf)
    assert got.dtype == torch.float32
    assert np.float32(got.item()).tobytes() == \
        np.asarray(want, np.float32).tobytes()
    # the twin's own top-k is the dispatch's: the same assignment
    _, top = PE._topk_lowest_index(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(top.numpy(), assignment)


def test_moe_profile_cpu_trace_holds_every_phase(tmp_path):
    row = moe_profile.main(["--device", "cpu", "--model", "tiny", "--seq",
                            "64", "--batch", "2", "--steps", "1",
                            "--out-dir", str(tmp_path), "--trace-dir",
                            str(tmp_path / "traces")])
    (saved,) = json.loads(
        (tmp_path / "moe_phase_breakdown_cpu.json").read_text())
    assert PROFILE_KEYS <= set(saved)
    assert saved["dispatch"] == "grouped"
    for ph in moe_profile.PHASES + ["other"]:
        assert row["phase_us"][ph] > 0, ph


def test_phase_split_reads_launches_and_backward_links():
    def op(name, tid, ts, dur, **args):
        return {"ph": "X", "cat": "cpu_op", "name": name, "pid": 1,
                "tid": tid, "ts": ts, "dur": dur, "args": args}

    def launch(tid, ts, corr):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "pid": 1, "tid": tid, "ts": ts, "dur": 1,
                "args": {"correlation": corr}}

    def kernel(ts, dur, corr):
        return {"ph": "X", "cat": "kernel", "name": "k", "pid": 0,
                "tid": 7, "ts": ts, "dur": dur,
                "args": {"correlation": corr}}

    events = [
        {"ph": "X", "cat": "user_annotation", "name": "moe_route",
         "pid": 1, "tid": 1, "ts": 0, "dur": 100},
        op("aten::mm", 1, 10, 20, **{"Sequence number": 5}),
        launch(1, 12, 1), kernel(200, 30, 1),
        op("aten::add", 1, 150, 10, **{"Sequence number": 6}),
        launch(1, 152, 2), kernel(240, 5, 2),
        # the backward, on the engine's thread
        op("autograd::engine::evaluate_function: MmBackward0", 2, 400, 50,
           **{"Sequence number": 5}),
        # a checkpoint's recompute inside it, its number colliding
        op("aten::mm", 2, 402, 3, **{"Sequence number": 5}),
        launch(2, 403, 5), kernel(480, 11, 5),
        launch(2, 410, 3), kernel(500, 40, 3),
        op("autograd::engine::evaluate_function: AddBackward0", 2, 460, 10,
           **{"Sequence number": 6}),
        launch(2, 462, 4), kernel(560, 2, 4),
    ]
    out = trace_analysis.phase_split(events, ["moe_route", "moe_combine"])
    assert out == {"moe_route": 70.0, "moe_combine": 0.0, "other": 18.0}


def test_moe_quality_ab_tiny(tmp_path):
    out = moe_quality_ab.main(["--device", "cpu", "--tiny", "--seconds",
                               "2", "--eval-every", "5", "--out-dir",
                               str(tmp_path), "--plot",
                               str(tmp_path / "ab.png")])
    saved = json.loads((tmp_path / "quality_ab_cpu.json").read_text())
    assert saved["verdict"] == out["verdict"]
    assert {"platform", "seconds_budget", "verdict", "legs"} <= set(out)
    assert [leg["name"] for leg in out["legs"]] == ["dense", "moe_cf2",
                                                    "moe_cf1"]
    for leg in out["legs"]:
        assert set(leg) == LEG_KEYS
        assert leg["seconds"] > 2 and leg["steps"] == len(leg["losses"])
        assert np.isfinite(leg["final_eval_loss"])
        assert all(np.isfinite(e[1]) for e in leg["evals"])
        assert set(out["verdict"][leg["name"]]) == VERDICT_KEYS
        if leg["name"] == "dense":
            assert leg["drop_trajectory"] == []
        else:
            traj = leg["drop_trajectory"]
            assert traj and all(0.0 <= d <= 1.0 for _, d in traj)
            assert [i for i, _ in traj] == list(
                range(0, leg["steps"], 5))[:len(traj)]
    assert out["verdict"]["dense"]["delta_vs_dense"] == 0.0
    assert (tmp_path / "ab.png").stat().st_size > 0

"""C16: a row of the one-card sweeps leaves the process group as it
found it.  ``train.bench_row.measure_row`` runs ``train_fsdp.run``,
which makes a one-rank group when none is up; a row whose run raised
left that group up, and the later tests of the same pytest process that
assume no group (``test_torch_busbench_inplace``'s small payloads,
``test_torch_fsdp_auto``'s refusals) failed whenever the scheduler put
them after it.  Here: the error row destroys the group its run made,
a row leaves a group its caller made up, and the three tests in that
order in one process pass."""

import os
import subprocess
import sys
from pathlib import Path

import torch

from distributed_training_sandbox_tpu_torch.train.bench_row import \
    measure_row
from distributed_training_sandbox_tpu_torch.utils import mesh
torch.set_num_threads(1)  # the suite's workers share the cores

REPO = Path(__file__).resolve().parent.parent
# top-2 needs the grouped dispatch: the config itself refuses
REFUSED = {"n_experts": 4, "moe_ffn": 8, "moe_dispatch": "sort",
           "moe_top_k": 2}
IN_ORDER = (
    "tests/test_torch_moe_twins.py::"
    "test_a_failing_row_is_the_references_error_row",
    "tests/test_torch_busbench_inplace.py::test_small_payloads_get_more_calls",
    "tests/test_torch_fsdp_auto.py::test_auto_variant_refusals")


def _row():
    return measure_row("tiny", 16, 2, num_steps=1, device="cpu",
                       cfg_overrides=REFUSED, log=lambda *a: None)


def test_the_error_row_leaves_no_group():
    assert not mesh.initialized()
    row = _row()
    assert row["failure"] == "error" and "grouped" in row["error"]
    assert not mesh.initialized()


def test_a_row_leaves_its_callers_group_up():
    mesh.init_process_group("cpu")
    try:
        row = _row()
        assert row["failure"] == "error"
        assert mesh.initialized() and mesh.axis_size() == 1
    finally:
        mesh.destroy_process_group()
    assert not mesh.initialized()


def test_the_leak_and_its_victims_in_one_process():
    """The driver's failure without the scheduler: the leaking test and
    its two victims, in that order, in one pytest process."""
    env = {k: v for k, v in os.environ.items() if k != "PYTEST_ADDOPTS"}
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:xdist", "-p", "no:randomly", *IN_ORDER],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-2000:]
    assert "3 passed" in out.stdout, out.stdout[-2000:]

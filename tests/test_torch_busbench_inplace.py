"""The bus-bandwidth sweep's timed calls (``ops/busbench.inplace_call``):
each collective, issued asynchronously on buffers allocated before the
window and waited on, gives the values of the step's own collective
(``collective_fn``), on two gloo ranks, bit for bit; all_reduce sums in place, so its second call's buffer is
the sum of the first's; the window's call count for small payloads
(``window_iters``).  The sweep's JSON schema is
``tests/test_torch_busbench.py``'s, unchanged."""

import textwrap

import numpy as np
import pytest
import torch
from test_torch_fsdp import spawn_ranks

from distributed_training_sandbox_tpu_torch.ops import busbench as PB
torch.set_num_threads(1)  # the suite's workers share the cores

WORKER = textwrap.dedent(r"""
    import json, sys
    from pathlib import Path
    import numpy as np
    import torch
    from distributed_training_sandbox_tpu_torch.ops import busbench as B
    from distributed_training_sandbox_tpu_torch.utils import mesh

    work = Path(sys.argv[1])
    mesh.init_process_group("cpu")
    n, r = mesh.axis_size(), mesh.axis_rank()
    outs = {}
    for name in B.COLLECTIVE_NAMES:
        x = B.make_input(name, B.payload_elems(4000, n, 2), r, n,
                         torch.bfloat16, "cpu")
        outs[name + "_step"] = B.collective_fn(name)(x).float().numpy()
        call, out = B.inplace_call(name, x)
        for w in call():
            w.wait()
        outs[name] = out.float().numpy()
        if name == "all_reduce":
            for w in call():
                w.wait()
            outs["all_reduce_twice"] = out.float().numpy()
    np.savez(work / f"out{r}.npz", **outs)
    mesh.destroy_process_group()
""")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    from conftest import TwoProcessHarness
    work = tmp_path_factory.mktemp("inplace")
    spawn_ranks(["-c", WORKER, str(work)], 2, TwoProcessHarness.free_port())
    return [dict(np.load(work / f"out{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("name", PB.COLLECTIVE_NAMES)
def test_inplace_call_gives_the_step_collectives_values(two_ranks, name):
    for outs in two_ranks:
        np.testing.assert_array_equal(outs[name], outs[name + "_step"])


def test_all_reduce_sums_in_place(two_ranks):
    for outs in two_ranks:
        np.testing.assert_array_equal(outs["all_reduce_twice"],
                                      2 * outs["all_reduce"])


def test_small_payloads_get_more_calls():
    assert PB.window_iters(128 << 20, 10) == 10
    assert PB.window_iters(1 << 20, 10) == PB.MAX_ITERS
    assert PB.window_iters(PB.BYTES_A_WINDOW // 32, 10) == 32
    assert PB.window_iters(4096, 10) == PB.MAX_ITERS
    # one process: no group, every call a no-op on its input
    x = torch.arange(8.0)
    call, out = PB.inplace_call("all_gather", x)
    assert call() == [] and out is x

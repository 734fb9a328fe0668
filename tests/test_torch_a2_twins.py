"""The other twins of A2 on the CPU: ``train/long_context.py``, the
flagship twin's ``--spike-demo`` and loss plot (``train/flagship.py``)
and ``train/generate_demo.py``.

- ``long_context`` at two tiny seqs with the chunk threshold under the
  longer one: the rows carry the reference's keys and configs, and the
  longer row's loss streams the vocab in the override's chunks (the
  port's ``lm_loss`` honours ``loss_vocab_chunk``: its chunked xent runs
  in that row, with the chunk's width); the markdown table is the
  reference's.
- the flagship twin with ``--spike-demo``: two result files under the
  out dir (the no-warmup leg and the main leg, the reference's tags) and
  the PNG with both series.
- ``generate_demo`` on a TINY_LM checkpoint the flagship twin wrote: the
  greedy tokens equal the reference's ``generate`` on the restored params
  bridged to JAX (TINY_LM is f32), the ``--serve`` tokens equal
  ``generate``'s, and the output has the reference's keys.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_sandbox_tpu.models import transformer as JT
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.models import transformer as PT
from distributed_training_sandbox_tpu_torch.train import (flagship,
                                                          generate_demo,
                                                          long_context)
from distributed_training_sandbox_tpu_torch.utils.checkpoint import \
    restore_params
torch.set_num_threads(1)  # the suite's workers share the cores

# the module (the reference's models package exports its generate function
# under the same name)
JG = importlib.import_module("distributed_training_sandbox_tpu.models.generate")

ROW_KEYS = {"model", "seq_len", "batch", "devices", "platform",
            "tokens_per_sec", "step_ms", "tflops_per_device"}
DEMO_KEYS = {"model", "restored_step", "prompt", "prompt_ids", "int8",
             "max_new_tokens", "samples", "sample_ids"}


def test_long_context_two_tiny_seqs(tmp_path, monkeypatch, capsys):
    widths = []
    orig = PT.chunked_softmax_xent

    def counted(x, w_vocab, labels, chunk):
        widths.append((x.shape[1], chunk))
        return orig(x, w_vocab, labels, chunk)

    monkeypatch.setattr(PT, "chunked_softmax_xent", counted)
    rows = long_context.main(["--device", "cpu", "--model", "tiny",
                              "--seqs", "32", "64", "--precisions", "bf16",
                              "--chunk-above", "32", "--chunk", "96",
                              "--steps", "1", "--out-dir", str(tmp_path)])
    assert json.loads((tmp_path / "longcontext_cpu.json").read_text()) \
        == rows
    assert [r["seq_len"] for r in rows] == [32, 64]
    for r in rows:
        assert ROW_KEYS <= set(r) and r["batch"] == 1
        assert all(np.isfinite(r["losses"]))
    assert rows[0]["config"] == {}
    assert rows[1]["config"] == {"loss_vocab_chunk": 96}
    # only the row above the threshold streams its vocab, in 96s
    assert widths and set(widths) == {(64, 96)}
    assert long_context.overrides(65536, "int8_bwd") == {
        "loss_vocab_chunk": 4008, "matmul_precision": "int8_bwd"}
    assert long_context.overrides(32768, "bf16") == {}
    table = capsys.readouterr().out
    assert "| seq | precision | tok/s | step ms | TFLOPS/device |" in table
    assert "| 64 | bf16 |" in table


@pytest.fixture(scope="module")
def flagship_run(tmp_path_factory):
    """The flagship twin with --spike-demo on TINY_LM, its params saved."""
    root = tmp_path_factory.mktemp("flagship")
    flagship.main(["--device", "cpu", "--model", "tiny", "--precision",
                   "bf16", "--sequence-length", "32", "--batch-size", "2",
                   "--num-steps", "4", "--warmup-steps", "2",
                   "--spike-demo", "--spike-steps", "3", "--out-dir",
                   str(root / "res"), "--plot", str(root / "loss.png"),
                   "--ckpt-dir", str(root / "ck")])
    return root


def test_flagship_spike_demo_writes_both_legs_and_the_plot(flagship_run):
    files = sorted(p.name for p in (flagship_run / "res").glob("*.json"))
    assert files == ["tiny_bf16_seq32_b2_nowarm.json",
                     "tiny_bf16_seq32_b2_warm2.json"]
    spike = json.loads((flagship_run / "res" / files[0]).read_text())
    main = json.loads((flagship_run / "res" / files[1]).read_text())
    assert (spike["warmup_steps"], len(spike["losses"])) == (0, 3)
    assert (main["warmup_steps"], len(main["losses"])) == (2, 4)
    assert spike["lrs"] == [spike["peak_lr"]] * 3
    png = (flagship_run / "loss.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"


def test_generate_demo_matches_the_reference(flagship_run, tmp_path):
    out = generate_demo.main(["--device", "cpu", "--model", "tiny",
                              "--ckpt-dir", str(flagship_run / "ck"),
                              "--max-new-tokens", "8", "--serve",
                              "--out-file", str(tmp_path / "demo.json")])
    assert json.loads((tmp_path / "demo.json").read_text()) == out
    assert DEMO_KEYS | {"serve_matches_greedy", "serve_slo"} <= set(out)
    assert out["restored_step"] == 4
    assert sorted(out["samples"]) == ["greedy", "serve_greedy",
                                      "t0.7_seed100", "t0.7_seed101"]
    # the reference's generate on the restored params, bridged (f32)
    params = PT.init_params(PT.TINY_LM, torch.Generator().manual_seed(42))
    params, _ = restore_params(flagship_run / "ck", params)
    jparams = jax.tree.map(jnp.asarray, bridge.params_to_numpy(params))
    want = JG.generate(jparams, jnp.asarray([out["prompt_ids"]], jnp.int32),
                       JT.TINY_LM, max_new_tokens=8)
    assert out["sample_ids"]["greedy"] == np.asarray(want)[0].tolist()
    assert out["serve_matches_greedy"] is True
    assert out["sample_ids"]["serve_greedy"] == out["sample_ids"]["greedy"]
    # each sample is its own generator's draw, reproducible
    again = generate_demo.main(["--device", "cpu", "--model", "tiny",
                                "--ckpt-dir", str(flagship_run / "ck"),
                                "--max-new-tokens", "8"])
    assert again["sample_ids"] == {k: v for k, v in
                                   out["sample_ids"].items()
                                   if k != "serve_greedy"}
    with pytest.raises(SystemExit, match="temperature"):
        generate_demo.main(["--device", "cpu", "--model", "tiny",
                            "--ckpt-dir", str(flagship_run / "ck"),
                            "--temperature", "0"])

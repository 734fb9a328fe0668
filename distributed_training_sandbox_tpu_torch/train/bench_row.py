"""One timed row of the one-card sweeps (``train.moe_bench``,
``train.long_context``): the port's counterpart of the reference's
``bench.measure``, measured through the FSDP twin
(``train.train_fsdp.run``) at one rank.

A row trains ``2 + num_steps`` steps of ``model`` with the config fields
of ``cfg_overrides`` set over its own, on the twin's seeded synthetic
batches, with a host sync each step (``harness.quiet_config``).  Its
keys are the reference row's (``model``, ``seq_len``, ``batch``,
``devices``, ``platform``, ``tokens_per_sec``, ``step_ms``,
``tflops_per_device``): tokens/s over the steps after the first two
(kernel builds and the allocator's warm-up there, as the reference's
two warm-up calls compile), the step time its inverse, and TFLOP/s from
the model FLOPs a token.  The port adds the peak memory, the losses and
the card's ``nvidia-smi`` name and power limit.  A row that raises
becomes the reference's ``error`` row, with ``failure`` ``"oom"`` only on
PyTorch's own out-of-memory verdict (``utils.memory.classify_failure``),
and the card's cache is emptied for the next row.

A row leaves the process group as it found it: a group that was up
before the call stays up (a sweep makes one for all its rows), and one
that the row's run made is destroyed, whether the run returned or
raised.
"""

from __future__ import annotations

import gc

import torch

from ..models import MODEL_REGISTRY
from ..utils import mesh
from ..utils.memory import classify_failure
from . import train_fsdp
from .busbench import card_line

# the reference's config names (``--model SMOLLM3_3B_L8``) → the CLI's
REGISTRY_BY_ATTR = {attr: name for name, attr in MODEL_REGISTRY.items()}


def registry_name(model: str) -> str:
    """A reference config name (``SMOLLM3_3B_L8``) or a registry name
    (``smollm3-3b-l8``) → the registry name."""
    if model in MODEL_REGISTRY:
        return model
    if model in REGISTRY_BY_ATTR:
        return REGISTRY_BY_ATTR[model]
    raise ValueError(f"unknown model {model!r}; choose from "
                     f"{sorted(REGISTRY_BY_ATTR)} or {sorted(MODEL_REGISTRY)}")


def measure_row(model: str, seq: int, batch: int, *, num_steps: int = 6,
                cfg_overrides: dict | None = None, device=None,
                log=print) -> dict:
    """The reference's row for one configuration, or its error row."""
    over = dict(cfg_overrides or {})
    head = {"model": model, "seq_len": seq, "batch": batch}
    joined = mesh.initialized()
    try:
        res = train_fsdp.run(registry_name(model), batch_size=batch,
                             seq=seq, num_steps=num_steps + 2,
                             cfg_overrides=over, device=device,
                             log=lambda *a, **k: None)
    except (RuntimeError, ValueError, torch.OutOfMemoryError) as e:
        kind, msg = classify_failure(e)
        row = {**head, "config": over, "failure": kind, "error": msg}
    else:
        dev = torch.device(res["device"])
        tok_s = res["tokens_per_second"]
        ws = res["world_size"]
        row = {**head, "devices": ws,
               "platform": "gpu" if dev.type == "cuda" else dev.type,
               "tokens_per_sec": round(tok_s, 1),
               "step_ms": round(batch * seq / tok_s * 1e3, 1)
               if tok_s else None,
               "tflops_per_device": round(
                   tok_s * res["model_flops_per_token"] / ws / 1e12, 2),
               "peak_memory_bytes": res["peak_memory_bytes"],
               "losses": res["losses"],
               "card": card_line() if dev.type == "cuda" else None,
               "config": over}
        del res
    finally:
        if not joined:   # the run's own group, up when it raised too
            mesh.destroy_process_group()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    log(f"[row] {({k: v for k, v in row.items() if k != 'losses'})}")
    return row

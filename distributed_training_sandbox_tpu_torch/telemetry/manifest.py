"""Run manifest: the startup facts of one training run.  Port of the JAX
package's ``telemetry/manifest.py``.

Captured once before the step loop: strategy, the full ``TrainConfig``,
the data-parallel geometry, device kind and count, process topology, the
torch, CUDA and NCCL versions (where the reference records jax and
jaxlib), the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them, the git
sha, and the restart lineage.  ``profile_sessions`` is appended at
finalize when the run owned a profiler, and ``ledger`` (the collective
ledger's verdict) when it also handed over its collective sites;
``memory`` (the memory ledger) stays null: ROADMAP.md queue A item
A12.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import subprocess
from dataclasses import dataclass, field
from typing import Any

import torch

MANIFEST_SCHEMA_VERSION = 1


def _git_sha() -> str | None:
    """Best-effort checkout sha; None outside a git work tree."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5)
        return out.stdout.strip() or None if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError):
        return None


def card_line() -> str | None:
    """``name, power limit`` of the cards (``nvidia-smi``), one line per
    card joined by ``; ``; None without a card or the tool."""
    if not torch.cuda.is_available():
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = [s.strip() for s in out.stdout.splitlines() if s.strip()]
    return "; ".join(lines) if out.returncode == 0 and lines else None


def _nccl_version() -> str | None:
    if not torch.cuda.is_available():
        return None
    try:
        v = torch.cuda.nccl.version()
    except Exception:   # noqa: BLE001 - a build without NCCL
        return None
    return ".".join(str(x) for x in v) if isinstance(v, tuple) else str(v)


def _config_dict(config: Any) -> dict:
    if config is None:
        return {}
    if dataclasses.is_dataclass(config) and not isinstance(config, type):
        return dataclasses.asdict(config)
    if isinstance(config, dict):
        return dict(config)
    return {"repr": repr(config)}


@dataclass
class RunManifest:
    schema: int = MANIFEST_SCHEMA_VERSION
    run_id: str = ""
    strategy: str = ""
    model: str | None = None
    config: dict = field(default_factory=dict)
    mesh_shape: dict = field(default_factory=dict)
    mesh_axes: list = field(default_factory=list)
    device_kind: str = ""
    device_count: int = 0
    local_device_count: int = 0
    process_index: int = 0
    process_count: int = 1
    pid: int | None = None
    platform: str = ""
    torch_version: str = ""
    cuda_version: str | None = None
    nccl_version: str | None = None
    card: str | None = None
    git_sha: str | None = None
    started_utc: str = ""
    collective_counts: dict | None = None
    contract: dict | None = None
    rules: dict | None = None
    lineage: dict | None = None
    profile_sessions: list | None = None
    ledger: dict | None = None
    memory: dict | None = None
    extra: dict = field(default_factory=dict)

    @classmethod
    def capture(cls, strategy: str, *, run_id: str = "",
                config: Any = None, device=None, model: str | None = None,
                collective_counts: dict | None = None,
                contract: dict | None = None,
                rules: dict | None = None,
                lineage: dict | None = None,
                extra: dict | None = None) -> "RunManifest":
        """Snapshot the environment at step 0.  ``device`` is this rank's
        device (default: the current card, else the CPU); the world is
        the default process group's (one rank without one)."""
        from ..utils.mesh import axis_rank, axis_size
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        dev = torch.device(device)
        on_card = dev.type == "cuda"
        ws = axis_size()
        return cls(
            run_id=run_id,
            strategy=strategy,
            model=model,
            config=_config_dict(config),
            mesh_shape={"dp": ws},
            mesh_axes=["dp"],
            device_kind=(torch.cuda.get_device_name(dev) if on_card
                         else "cpu"),
            device_count=ws,
            local_device_count=(torch.cuda.device_count() if on_card
                                else 1),
            process_index=axis_rank(),
            process_count=ws,
            pid=os.getpid(),
            platform="gpu" if on_card else "cpu",
            torch_version=torch.__version__,
            cuda_version=torch.version.cuda,
            nccl_version=_nccl_version() if on_card else None,
            card=card_line() if on_card else None,
            git_sha=_git_sha(),
            started_utc=datetime.datetime.now(
                datetime.timezone.utc).isoformat(timespec="seconds"),
            collective_counts=collective_counts,
            contract=contract,
            rules=rules,
            lineage=dict(lineage) if lineage else None,
            extra=dict(extra or {}),
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

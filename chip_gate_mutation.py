#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.py``'s accuracy gates.

    python3 chip_gate_mutation.py

Needs the card, as ``chip_smoke.py`` does.  It copies the port and
``chip_smoke.py`` into ``build/gate_mutation/``, makes the kernels'
bf16 rounding of the normalised probabilities the identity there (the
one step of the reference that, left out, still gives attention close
to the plain version), and runs the smoke's kernel, serve and parity
phases on that copy with every gate logged instead of raised.  Exits 0
only if each accuracy gate fails on the mutant: K1's and K3's tolerance
against their plain versions and the decode-logit tolerance.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "gate_mutation"
HEADER = "distributed_training_sandbox_tpu_torch/csrc/paged_common.cuh"
ROUNDING = "return __bfloat162float(__float2bfloat16_rn(x));"
EXPECTED = ("paged_decode:", "flash_prefill:", "decode logits")

CHILD = """
import numpy as np, torch
import chip_smoke as c
failed = []
def check(cond, msg):
    if not cond:
        failed.append(msg)
        print("[mutant] gate fails:", msg, flush=True)
c.check = check
c.loader.build_all()
rng = np.random.default_rng(c.SEED)
gen = torch.Generator(device="cuda").manual_seed(c.SEED)
c.kernel_phase(rng, gen)
params = c.build_params()
eng, reqs, _ = c.serve_phase(params, rng, c.card_line())
c.parity_phase(params, reqs, eng)
"""


def main() -> int:
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    shutil.copy(ROOT / "chip_smoke.py", WORK)
    shutil.copytree(ROOT / "distributed_training_sandbox_tpu_torch",
                    WORK / "distributed_training_sandbox_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    header = WORK / HEADER
    text = header.read_text()
    if text.count(ROUNDING) != 1:
        print(f"[mutant] the rounding line is not in {HEADER} once",
              file=sys.stderr)
        return 1
    header.write_text(text.replace(ROUNDING, "return x;"))
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=WORK,
                         capture_output=True, text=True, timeout=900)
    print(out.stdout, end="", flush=True)
    if out.returncode != 0:
        print(out.stderr[-4000:], file=sys.stderr)
        return 1
    fails = [ln for ln in out.stdout.splitlines()
             if ln.startswith("[mutant] gate fails:")]
    missed = [g for g in EXPECTED if not any(g in ln for ln in fails)]
    if missed:
        print(f"[mutant] gates that let the mutant through: {missed}",
              file=sys.stderr)
        return 1
    print(f"[mutant] every accuracy gate failed on the mutant: "
          f"{list(EXPECTED)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The native data engine against the numpy one, on the host: the twin
of the JAX package's ``scripts/native_data_bench.py``.

    python -m distributed_training_sandbox_tpu_torch.train.native_data_bench \
        [--tokens 20000000] [--vocab 128256] [--seq 8192] [--out-dir DIR]

Times, best of 3 on the host clock, the three host steps of the packed
pipeline: the Zipf sampler, the window packer and an epoch shuffle, the
numpy versions (``data/packing.py``, ``numpy.random.Generator
.permutation``) against the C++ engine (``data/native.py``).  Prints
the table; with ``--out-dir`` also writes ``native_data_bench.json``
there.  Exits if the engine cannot build or load.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from ..data import native, packing


def timeit(f, *args, reps: int = 3):
    """(best seconds of ``reps`` calls, the last call's result)."""
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = f(*args)
        best = min(best, time.perf_counter() - t0)
    return best, out


def run(tokens: int = 20_000_000, vocab: int = 128_256,
        seq: int = 8192) -> list[dict]:
    """The three rows: op, numpy_s, native_s, speedup."""
    if not native.available():
        raise SystemExit(f"native engine unavailable: {native.build_error()}")
    rows = []
    t_np, stream = timeit(packing.synthetic_token_stream, tokens, vocab, 42)
    t_cc, _ = timeit(native.synthetic_token_stream, tokens, vocab, 42)
    rows.append({"op": f"zipf sample ({tokens / 1e6:.0f}M tokens, vocab "
                       f"{vocab})", "numpy_s": round(t_np, 3),
                 "native_s": round(t_cc, 3), "speedup": round(t_np / t_cc, 1)})
    t_np, _ = timeit(packing.pack_tokens, stream, seq)
    t_cc, _ = timeit(native.pack_tokens, stream, seq)
    rows.append({"op": f"pack windows (seq {seq})",
                 "numpy_s": round(t_np, 4), "native_s": round(t_cc, 4),
                 "speedup": round(t_np / t_cc, 1)})
    n = tokens // (seq + 1)
    rng = np.random.default_rng(0)
    t_np, _ = timeit(lambda: rng.permutation(n))
    t_cc, _ = timeit(native.shuffle_indices, n, 0)
    rows.append({"op": f"epoch shuffle ({n} windows)",
                 "numpy_s": round(t_np, 5), "native_s": round(t_cc, 5),
                 "speedup": round(t_np / t_cc, 1)})
    return rows


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tokens", type=int, default=20_000_000)
    p.add_argument("--vocab", type=int, default=128_256)
    p.add_argument("--seq", type=int, default=8192)
    p.add_argument("--out-dir", default=None,
                   help="write native_data_bench.json there")
    args = p.parse_args(argv)
    rows = run(args.tokens, args.vocab, args.seq)
    print("| op | numpy s | native s | speedup |\n|---|---|---|---|")
    for r in rows:
        print(f"| {r['op']} | {r['numpy_s']} | {r['native_s']} | "
              f"{r['speedup']}× |")
    if args.out_dir:
        out = Path(args.out_dir)
        out.mkdir(parents=True, exist_ok=True)
        (out / "native_data_bench.json").write_text(json.dumps(rows,
                                                               indent=1))
        print(f"[native-data] wrote {out / 'native_data_bench.json'}")
    return rows


if __name__ == "__main__":
    main()

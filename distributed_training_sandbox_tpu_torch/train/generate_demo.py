"""Decode demo: restore a trained checkpoint and generate text through
the committed tokenizer (train → checkpoint → decode → detokenize), the
twin of the JAX package's ``scripts/generate_demo.py``.

    python -m distributed_training_sandbox_tpu_torch.train.flagship \\
        --model corpus-70m --data corpus --sequence-length 1024 \\
        --batch-size 16 --num-steps 300 --warmup-steps 30 \\
        --ckpt-dir /tmp/ck70
    python -m distributed_training_sandbox_tpu_torch.train.generate_demo \\
        --ckpt-dir /tmp/ck70 --prompt "Returns the" --serve \\
        --out-file data_results/generate_demo_gpu.json

The params are initialised from seed 42 and restored from the newest
params-only step under ``--ckpt-dir`` (``utils.checkpoint.
restore_params``, what the flagship twin saves); the prompt goes through
the corpus tokenizer (``data/corpus/tokenizer.json``).  ``generate``
emits a greedy continuation and two samples at ``--temperature``, each
drawn with an explicit ``torch.Generator`` seeded ``--seed`` + i.
``--int8`` decodes with the engine's int8 weights
(``quantize_decode_params``: K4 on the card).  ``--serve`` also serves
the prompt through ``ServingEngine`` (on the card through K1, the paged
decode, and K3, the flash prefill) and records whether its tokens equal
``generate``'s at the engine's view capacity, as the reference records
its serving smoke.  Prints and writes (``--out-file``) the
reference's keys: the prompt, each sample's ids and text, and the
``--serve`` block.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from ..data.packing import CORPUS_TOKENIZER, load_corpus_tokenizer
from ..device import resolve_device
from ..models import MODEL_REGISTRY
from ..models import transformer as T
from ..models.generate import generate, quantize_decode_params
from ..serving import ServingEngine
from ..utils.checkpoint import restore_params

SEED = 42


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=sorted(MODEL_REGISTRY),
                   default="corpus-70m")
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--prompt", default="Returns the")
    p.add_argument("--max-new-tokens", type=int, default=48)
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--seed", type=int, default=100,
                   help="the temperature samples' generators: seed, seed+1")
    p.add_argument("--int8", action="store_true",
                   help="decode with int8-stored weights")
    p.add_argument("--serve", action="store_true",
                   help="also serve the prompt through the engine and "
                        "record whether its tokens equal generate's")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (the plain path)")
    p.add_argument("--out-file", default=None)
    args = p.parse_args(argv)
    if args.temperature <= 0.0:
        raise SystemExit("--temperature must be > 0: the sampled entries "
                         "would duplicate the greedy chain (greedy is "
                         "always emitted)")
    dev = resolve_device(args.device)
    tok = load_corpus_tokenizer(CORPUS_TOKENIZER)
    cfg = dataclasses.replace(
        getattr(T, MODEL_REGISTRY[args.model]),
        attention_impl="flash" if dev.type == "cuda" else "xla")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                           dev)
    params, step = restore_params(args.ckpt_dir, params, tag="demo")
    if args.int8:
        params = quantize_decode_params(params, cfg)

    ids = tok(args.prompt)["input_ids"]
    prompt_ids = torch.as_tensor([ids], dtype=torch.long, device=dev)
    samples, sample_ids = {}, {}

    def record(name, toks):
        sample_ids[name] = [int(t) for t in np.asarray(toks).reshape(-1)]
        samples[name] = tok.decode(sample_ids[name])

    record("greedy", generate(params, prompt_ids, cfg,
                              max_new_tokens=args.max_new_tokens,
                              device=dev)[0].cpu())
    for i in range(2):
        gen = torch.Generator(device=dev).manual_seed(args.seed + i)
        record(f"t{args.temperature:g}_seed{args.seed + i}",
               generate(params, prompt_ids, cfg,
                        max_new_tokens=args.max_new_tokens,
                        temperature=args.temperature, generator=gen,
                        device=dev)[0].cpu())
    out = {"model": args.model, "restored_step": step,
           "prompt": args.prompt, "prompt_ids": list(ids),
           "int8": args.int8, "max_new_tokens": args.max_new_tokens,
           "samples": samples, "sample_ids": sample_ids}

    if args.serve:
        on_card = dev.type == "cuda"
        eng = ServingEngine(params, cfg, max_batch=2, page_size=16,
                            max_seq_len=len(ids) + args.max_new_tokens,
                            paged_kernel=on_card, flash_prefill=on_card,
                            device=dev)
        req = eng.submit(np.asarray(ids, np.int32),
                         max_new_tokens=args.max_new_tokens)
        eng.run()
        record("serve_greedy", np.asarray(req.tokens, np.int64))
        ref = generate(params, prompt_ids, cfg,
                       max_new_tokens=args.max_new_tokens,
                       cache_capacity=eng.view_capacity,
                       device=dev)[0].cpu().numpy()
        got = np.asarray(req.tokens, np.int64)
        out["serve_matches_greedy"] = bool(
            got.shape == ref.shape and (got == ref).all())
        out["serve_slo"] = eng.slo_report()
        out["serve_kernels"] = {"paged_kernel": on_card,
                                "flash_prefill": on_card}
    print(json.dumps(out, indent=1), flush=True)
    if args.out_file:
        Path(args.out_file).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out_file).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()

"""Sequence-parallel training: FSDP over ``dp`` × ring attention over
``sp`` (``parallel/sequence.py``); the twin of the JAX package's
``scripts/train_sp.py``.

    torchrun --nproc-per-node 2 -m \\
        distributed_training_sandbox_tpu_torch.train.train_sp \\
        --device cpu --sp 2 --num-steps 10
    torchrun --nproc-per-node 4 -m \\
        distributed_training_sandbox_tpu_torch.train.train_sp \\
        --model smollm3-3b-l8 --sp 4 --sequence-length 16384

The flags and the run are ``train/_2d.py``'s.
"""

from __future__ import annotations

from . import _2d


def run(model: str = "tiny", **kw) -> dict:
    """``_2d.run("sp", model, **kw)``; ``second`` is the sp axis's size."""
    return _2d.run("sp", model, **kw)


def main(argv=None) -> None:
    _2d.main("sp", argv)


if __name__ == "__main__":
    main()

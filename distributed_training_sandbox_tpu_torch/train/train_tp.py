"""Tensor-parallel training: data parallel over ``dp`` × Megatron tensor
parallelism over ``tp`` (``parallel/tensor.py``); the twin of the JAX
package's ``scripts/train_tp.py``.

    torchrun --nproc-per-node 2 -m \\
        distributed_training_sandbox_tpu_torch.train.train_tp \\
        --device cpu --tp 2 --num-steps 10
    torchrun --nproc-per-node 4 -m \\
        distributed_training_sandbox_tpu_torch.train.train_tp \\
        --model smollm3-3b-l8 --tp 4 --attention flash --overlap ring

The flags and the run are ``train/_2d.py``'s.
"""

from __future__ import annotations

from . import _2d


def run(model: str = "tiny", **kw) -> dict:
    """``_2d.run("tp", model, **kw)``; ``second`` is the tp axis's size."""
    return _2d.run("tp", model, **kw)


def main(argv=None) -> None:
    _2d.main("tp", argv)


if __name__ == "__main__":
    main()

"""The collectives one DDP, ZeRO or pipeline step issues, as the shim
``ops.collectives.COLLECTIVES`` counts them.

The port's copy of the JAX package's ``analysis/contracts.py`` formulas
for these steps (``ddp``, ``ddp_bucketed``, ``ddp_q8``, ``zero1``,
``zero2``, ``zero3``), for the pipeline's stage programs (``gpipe``,
``1f1b``) and for the FSDP step with quantised gathers
(:func:`fsdp_quantized_step_collectives`), read as calls.  The CPU
tests and ``chip_smoke.py`` hold the steps of ``parallel/ddp.py``,
``parallel/zero.py``, ``parallel/pipeline.py`` and ``parallel/fsdp.py``
to them.
"""

from __future__ import annotations

from ..ops.collectives import CollectiveCounts
from .ddp import DEFAULT_Q8_BUCKET_MB

STEP_KINDS = ("ddp", "zero1", "zero2", "zero3", "gpipe", "1f1b")


def ddp_bucket_count(param_bytes: int, bucket_mb: float,
                     itemsize: int = 4) -> int:
    """The reference's ``ddp_bucket_count``: flat buckets of exact
    capacity (whole elements) over the concatenated grads."""
    cap_elems = max(int(bucket_mb * 2 ** 20) // itemsize, 1)
    n_elems = -(-int(param_bytes) // itemsize)
    return max(-(-n_elems // cap_elems), 1)


def step_collectives(kind: str, n_leaves: int, param_bytes: int = 0, *,
                     bucket_mb: float | None = None, q8: bool = False,
                     rebuild: str = "broadcast") -> dict:
    """Every kind of ``CollectiveCounts.KINDS`` one step of ``kind``
    issues with ``n_leaves`` param leaves of ``param_bytes`` bytes in all.

    ``ddp`` n + 2 all_reduces (a leaf's grads, the loss mean, the
    barrier); bucketed (``bucket_mb``) one all_reduce a bucket + 2; ``q8``
    two all_gathers a bucket (codes, scale; ``bucket_mb`` or
    ``DEFAULT_Q8_BUCKET_MB``) + 2 all_reduces.  ``zero1`` 2n + 2
    all_reduces with the masked all_reduce rebuild, else n + 2 and n
    all_gathers; ``zero2`` n reduce_scatters and n + 2 all_reduces, or 2
    and n all_gathers; ``zero3`` 2 all_reduces, n reduce_scatters (each
    gather's backward) and 2n - 1 all_gathers: every leaf gathered in
    the forward, and again in the backward's recompute of its layer but
    for the last layer's bias, which ``parallel.zero`` gathers outside
    that layer's checkpoint (nothing in the backward needs it again, as
    XLA finds for the reference).  ``gpipe`` and ``1f1b`` (the
    interleaved schedule too) issue none: the stages hand activations
    over by device copies, not collectives."""
    if kind not in STEP_KINDS:
        raise ValueError(f"kind={kind!r}; choose from {STEP_KINDS}")
    n, out = n_leaves, dict.fromkeys(CollectiveCounts.KINDS, 0)
    gather = rebuild == "all_gather"
    if kind == "ddp":
        if q8:
            buckets = ddp_bucket_count(param_bytes,
                                       bucket_mb or DEFAULT_Q8_BUCKET_MB)
            out.update(all_reduce=2, all_gather=2 * buckets)
        elif bucket_mb:
            out.update(all_reduce=ddp_bucket_count(param_bytes, bucket_mb)
                       + 2)
        else:
            out.update(all_reduce=n + 2)
    elif kind == "zero1":
        out.update(all_reduce=n + 2 if gather else 2 * n + 2,
                   all_gather=n if gather else 0)
    elif kind == "zero2":
        out.update(all_reduce=2 if gather else n + 2,
                   all_gather=n if gather else 0, reduce_scatter=n)
    elif kind == "zero3":
        out.update(all_reduce=2, all_gather=2 * n - 1, reduce_scatter=n)
    return out


def fsdp_quantized_step_collectives(params: dict, *,
                                    reshard_after_forward: bool = True,
                                    remat: bool = True, accum_steps: int = 1,
                                    quantized_grads: bool = False) -> dict:
    """Every kind of ``CollectiveCounts.KINDS`` one FSDP step
    (``parallel.fsdp.make_fsdp_train_step``) with ``quantized_gather``
    at ``overlap="none"`` issues on the parameter tree ``params`` (full
    or sharded: only the leaves' ranks count).

    The root leaves are gathered once; with ``reshard_after_forward``
    each stacked layer leaf is gathered inside each of the L layers,
    with its layer dim gone, and once more in the backward's recompute
    under ``remat``; without it each stacked leaf is gathered once,
    whole.  A gathered leaf of two or more dims takes two
    ``all_gather``s (codes, scales) and its backward one
    ``reduce_scatter``, or with ``quantized_grads`` two ``all_to_all``s
    (codes, scales); a 1-D leaf takes the plain gather and
    reduce_scatter.  Each microbatch repeats the gathers and their
    backwards; one ``all_reduce`` means the loss."""
    layers = params["layers"]
    L = next(iter(layers.values())).shape[0]
    roots = [v.ndim for k, v in params.items() if k != "layers"]
    if reshard_after_forward:
        # (rank of the gathered leaf, forward gathers of the site)
        sites = [(d, 1) for d in roots] + [
            (v.ndim - 1, 2 if remat else 1) for v in layers.values()] * L
    else:
        sites = [(d, 1) for d in roots + [v.ndim for v in layers.values()]]
    out = dict.fromkeys(CollectiveCounts.KINDS, 0)
    out["all_reduce"] = 1
    for ndim, fwd in sites:
        q = ndim > 1
        out["all_gather"] += (2 if q else 1) * fwd * accum_steps
        if q and quantized_grads:
            out["all_to_all"] += 2 * accum_steps
        else:
            out["reduce_scatter"] += accum_steps
    return out

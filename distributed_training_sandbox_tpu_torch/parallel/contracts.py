"""The collectives one DDP, ZeRO or pipeline step issues, as the shim
``ops.collectives.COLLECTIVES`` counts them.

The port's copy of the JAX package's ``analysis/contracts.py`` formulas
for these steps (``ddp``, ``ddp_bucketed``, ``ddp_q8``, ``zero1``,
``zero2``, ``zero3``), for the pipeline's stage programs (``gpipe``,
``1f1b``) and for the FSDP step with quantised gathers
(:func:`fsdp_quantized_step_collectives`), read as calls, and the
port's own count for the MoE step (:func:`moe_step_collectives`, also
over dp × sp × ep), the FSDP step (:func:`fsdp_step_collectives`),
the reference's ``sp`` contract (:func:`sp_step_collectives`, FSDP ×
SP) and its ``tp``, ``tp_ring`` and ``tp_q8`` contracts
(:func:`tp_step_collectives`, also over dp × sp × tp), and its four
serving contracts (:func:`serve_step_collectives`, ``SERVE_STRATEGIES``).
The CPU tests and ``chip_smoke.py`` hold the steps of
``parallel/ddp.py``, ``parallel/zero.py``, ``parallel/pipeline.py``,
``parallel/fsdp.py``, ``parallel/expert.py``, ``parallel/tensor.py`` and
the tensor-parallel ``serving/engine.py`` to them.

The reference counts the sites of one compiled step, where the scanned
layer body stands once and a transpose is one more site; the shim
counts the calls a step makes, so each layer's calls count L times,
its forward's once more under remat ``"full"`` (the recompute), each
microbatch's once more, and a ring of n ranks n - 1 hops a site.  An
axis of one rank still makes its calls, as ``ops.collectives`` makes
them on an initialised group; a ring of one rank makes none.
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


def _layers_and_leaves(params: dict) -> tuple[int, int]:
    layers = params["layers"]
    L = next(iter(layers.values())).shape[0]
    return L, sum(1 for k in params if k != "layers") + len(layers)


def ring_hops(L: int, sp: int, remat: bool = True) -> int:
    """The ``collective_permute`` calls of a step's ring attention over
    ``sp`` ranks: a layer's K and V each make sp - 1 hops forward, as
    many reverse hops backward, and under remat the forward's again."""
    return L * 2 * (sp - 1) * (2 + int(remat))


def fsdp_step_collectives(params: dict, n: int, *, overlap: str = "none",
                          reshard_after_forward: bool = True,
                          remat: bool = True,
                          accum_steps: int = 1) -> dict:
    """Every kind of ``CollectiveCounts.KINDS`` one FSDP step
    (``parallel.fsdp.make_fsdp_train_step``, full-precision gathers) over
    ``n`` dp ranks issues on ``params``: the reference's ``fsdp``,
    ``fsdp_ring`` and ``fsdp_ring_fused_pallas`` contracts (one gather and
    one reduce_scatter site a leaf; a ring gather n - 1 hops and a
    reduce_scatter; a fused projection n - 1 hops forward and n - 1
    backward) as calls: the root leaves gathered once, each layer leaf in
    each of the L layers and again in its recompute under remat, every
    microbatch again, and one all_reduce for the loss.  The fused
    projections are the layer leaves of two dims; at one rank a ring
    makes no call."""
    layers = params["layers"]
    L, _ = _layers_and_leaves(params)
    root = sum(1 for k in params if k != "layers")
    layer, proj = len(layers), sum(1 for v in layers.values() if v.ndim == 3)
    fwd = 2 if remat else 1
    if not reshard_after_forward:    # every stacked leaf gathered once
        sites_fwd = sites_bwd = root + layer
    else:
        sites_fwd, sites_bwd = root + layer * L * fwd, root + layer * L
    out = dict.fromkeys(CollectiveCounts.KINDS, 0)
    out["all_reduce"] = 1
    if overlap == "none":
        out["all_gather"] = accum_steps * sites_fwd
        out["reduce_scatter"] = accum_steps * sites_bwd
    elif n == 1:
        pass
    elif overlap == "ring":
        out["collective_permute"] = accum_steps * sites_fwd * (n - 1)
        out["reduce_scatter"] = accum_steps * sites_bwd
    else:                  # ring_fused, ring_fused_pallas
        unfused_fwd = root + (layer - proj) * L * fwd
        out["reduce_scatter"] = accum_steps * (root + (layer - proj) * L)
        out["collective_permute"] = accum_steps * (n - 1) * (
            unfused_fwd + proj * L * fwd + proj * L)
    return out


def sp_step_collectives(params: dict, dp: int, sp: int, *,
                        overlap: str = "none", remat: bool = True,
                        accum_steps: int = 1) -> dict:
    """One FSDP × SP step (``parallel.sequence.make_sp_train_step``):
    the reference's ``sp`` contract (the fsdp sites, 4 K/V ring
    ``ppermute`` sites, a psum over sp a leaf) as calls:
    :func:`fsdp_step_collectives` over dp, :func:`ring_hops` for each
    microbatch, and all_reduces over sp for the loss and for each leaf's
    grads."""
    L, n_leaves = _layers_and_leaves(params)
    out = fsdp_step_collectives(params, dp, overlap=overlap, remat=remat,
                                accum_steps=accum_steps)
    out["all_reduce"] += 1 + n_leaves
    out["collective_permute"] += accum_steps * ring_hops(L, sp, remat)
    return out


def tp_step_collectives(params: dict, tp: int, *, sp: int = 1,
                        overlap: str = "none", remat: bool = True,
                        accum_steps: int = 1) -> dict:
    """One dp × tp (or dp × sp × tp) step
    (``parallel.tensor.make_tp_train_step``): the reference's ``tp``,
    ``tp_ring`` and ``tp_q8`` contracts (two rejoin sites a layer, their
    backward psums, a grad psum a leaf and the loss mean) as calls.  A
    layer's two rejoins, forward and again in the recompute under remat:
    two all_reduces (``"none"``), or two reduce_scatters and 2 (tp - 1)
    hops (``"ring"``; none at one rank), or four all_gathers, codes and
    scales (``"q8"``); their backward two all_reduces (none for the ring
    at one rank); with ``sp`` the ring attention's :func:`ring_hops`;
    each microbatch again; then one all_reduce for the loss and one a
    leaf for the grads."""
    L, n_leaves = _layers_and_leaves(params)
    fwd = 1 + int(remat)
    out = dict.fromkeys(CollectiveCounts.KINDS, 0)
    if overlap == "none":
        out["all_reduce"] = L * 2 * (fwd + 1)
    elif overlap == "ring":
        if tp > 1:
            out["reduce_scatter"] = L * 2 * fwd
            out["collective_permute"] = L * 2 * (tp - 1) * fwd
            out["all_reduce"] = L * 2
    elif overlap == "q8":
        out["all_gather"] = L * 4 * fwd
        out["all_reduce"] = L * 2
    else:
        raise ValueError(f"overlap={overlap!r}")
    out["collective_permute"] += ring_hops(L, sp, remat)
    out = {k: v * accum_steps for k, v in out.items()}
    out["all_reduce"] += 1 + n_leaves
    return out


def moe_step_collectives(params: dict, *, remat: bool = True,
                         z_loss: bool = False, sp: int = 1) -> dict:
    """Every kind of ``CollectiveCounts.KINDS`` one dp × ep MoE step
    (``parallel.expert.make_moe_lm_train_step``) issues on the
    parameter tree ``params`` (full or sharded: only the leaf count and
    the layer count L matter), at any dp and ep (an axis of one rank
    still makes its calls).

    The reference counts 4 all_to_all sites in its scanned layer body
    (``analysis/contracts.py:387-395``); the shim counts calls, derived
    from the port's structure:

    * a layer's forward issues 2 all_to_alls (the buckets out, the
      outputs back) and 2 all_reduces (the aux loss's ``frac`` and
      ``mean_p`` means over ep; a third, ``z``, with the z-loss);
    * its backward issues 2 all_to_alls (each one's inverse) and one
      all_reduce for ``mean_p`` (``frac`` is a count and carries no
      grad; ``z`` adds one);
    * under remat ``"full"`` the checkpoint's recompute runs the layer's
      forward again before its backward: its 2 all_to_alls and 2 (3)
      all_reduces once more;
    * the step then means the loss (one all_reduce over dp · ep) and
      syncs every grad leaf with one all_reduce (over dp for the expert
      banks, over dp · ep for the rest).

    So L · (4 + 2·remat) all_to_alls and L · ((2 + z)(1 + remat) + 1 +
    z) + 1 + n_leaves all_reduces.  Over dp × sp × ep (``sp`` ranks of
    ring attention) the step adds :func:`ring_hops`; the loss and the
    grads take the same calls over the larger groups."""
    L, n_leaves = _layers_and_leaves(params)
    z, r = int(z_loss), int(remat)
    out = dict.fromkeys(CollectiveCounts.KINDS, 0)
    out["all_to_all"] = L * (4 + 2 * r)
    out["all_reduce"] = L * ((2 + z) * (1 + r) + 1 + z) + 1 + n_leaves
    out["collective_permute"] = ring_hops(L, sp, remat)
    return out


def ep_step_collectives() -> dict:
    """One toy EP step (``parallel.expert.make_ep_train_step``): the
    layer's 2 all_to_alls and the inverse of the second only (the first
    carries the buckets of the input data, which needs no grad, as XLA
    drops that transpose for the reference); 2 aux all_reduces in the
    forward and ``mean_p``'s in the backward, the loss mean and the
    router's grad mean (the expert grads stay local)."""
    out = dict.fromkeys(CollectiveCounts.KINDS, 0)
    out.update(all_to_all=3, all_reduce=5)
    return out


# the reference's serving contracts (``analysis/contracts.py:396-440``):
# the decode step, with the paged-attention kernel, the speculative verify
# and the batched flash prefill chunk share one wire choreography
SERVE_STRATEGIES = ("serve_decode", "serve_decode_paged_kernel",
                    "serve_decode_spec", "serve_prefill_flash")


def serve_step_collectives(params: dict) -> dict:
    """One step of the tensor-parallel serving engine (``serving.engine``
    with ``mesh``): a decode step, a speculative verify or a prefill
    chunk.  Inference only, and the layer stack unrolled over its
    per-layer pools, so the layer body's two rejoins (after attention,
    after the MLP) are 2 all_reduces a layer, 2 · L a step, and nothing
    else: a gather would mean a weight went replicated, a dp collective
    that requests leaked across slots.  The kernels (paged decode, flash
    prefill) read pages in place and add no call."""
    L, _ = _layers_and_leaves(params)
    out = dict.fromkeys(CollectiveCounts.KINDS, 0)
    out["all_reduce"] = 2 * L
    return out

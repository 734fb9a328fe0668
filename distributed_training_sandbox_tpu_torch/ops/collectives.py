"""Explicit collectives over a process group, and the FSDP ring family
with its chunk-matmul kernel K7.

Port of the JAX package's ``ops/collectives.py``.  The reference calls
``jax.lax`` collectives inside ``shard_map`` along a named mesh axis;
here each call names an axis (``"dp"``, or a ``utils.mesh.Axis`` bound
to a process group) and issues one ``torch.distributed`` call:

    lax.psum / pmax / pmin  -> dist.all_reduce            (all_reduce)
    lax.all_gather          -> dist.all_gather_into_tensor (all_gather)
    lax.psum_scatter        -> dist.reduce_scatter_tensor  (reduce_scatter)
    masked psum             -> dist.broadcast              (broadcast)
    lax.ppermute            -> dist.batch_isend_irecv      (ppermute_ring)
    lax.all_to_all          -> dist.all_to_all_single      (all_to_all)

Without an initialised process group an axis has one rank and every
collective is the identity.  ``all_gather``, ``reduce_scatter``,
``ppermute_ring``, ``all_to_all`` and the ``"sum"`` all_reduce are
autograd Functions whose backward is the JAX transpose (reduce_scatter,
all_gather, the reverse permutation, the inverse all_to_all,
all_reduce); the other reductions carry no grad.

The ring family of the FSDP slice: ``RingShard``, ``ring_all_gather``
(bitwise ``all_gather``, backward pinned to one monolithic
reduce_scatter), ``all_gather_matmul`` (plain code whose autograd is the
reversed-ring dW) and ``all_gather_matmul_pallas``, whose chunk product
is K7: ``ag_matmul_kernel``, a persistent bf16 wgmma GEMM fed by TMA
in ``csrc/ag_matmul.cu`` (replacing ``_agmm_tile_call``'s
``pl.pallas_call``), beside its plain version ``ag_matmul_plain``.
The tensor-parallel ring: ``decomposed_all_reduce`` (a reduce_scatter,
then ``ring_all_gather``'s hops: the all_reduce's value from n - 1
schedulable hops, its backward pinned to the all_reduce of the
cotangent) and ``matmul_reduce_scatter`` (the scatter side of the
collective matmul, exported as the reference exports it; no step uses
it).

The recording shim :data:`COLLECTIVES` counts each wire call by kind,
named as the reference's ``count_collectives`` names HLO ops (a ring
hop is one ``collective_permute``; a barrier is an ``all_reduce``).
The reference counts the sites of one compiled step; the shim counts
the calls one step makes, so a site inside the layer loop counts once a
layer, and once more where remat recomputes it.

K7's tolerance against its plain version (``TOLERANCE``): both sum the
same exact bf16 products in f32 and round once to bf16; they differ
only in the order of the f32 sum.  Where the sum straddles a rounding
boundary an output lands one bf16 ulp (at most 2^-7 of its size) apart:
rtol 2^-7.  Near zero, where bf16 resolves finer than the two f32 sums
agree, outputs differ by the sums' difference, which grows with Kc (up
to 6.1e-5 at Kc = 11 008 with operands ~ N(0, 1) and N(0, 0.02²) on an
H100, PERF.md): atol 1e-4.  The limits lie between the sound kernel's
reading and a mutant's (``chip_smoke.py``, ``chip_gate_mutation.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..kernels import LaunchCount, check_cuda_operands, launch, loader, ptr
from ..parallel.optim import tree_map
from ..utils.mesh import (axis_rank, axis_size, global_rank, initialized,
                          resolve_axis)

__all__ = ["all_reduce", "all_gather", "reduce_scatter", "broadcast",
           "scatter", "ppermute_ring", "all_to_all", "barrier",
           "tree_all_reduce", "tree_all_gather", "RingShard",
           "ring_all_gather", "decomposed_all_reduce", "all_gather_matmul",
           "matmul_reduce_scatter", "all_gather_matmul_pallas",
           "ag_matmul_kernel", "ag_matmul_layout", "ag_matmul_plain",
           "COLLECTIVES", "COUNTS",
           "TOLERANCE"]


class CollectiveCounts:
    """The recording shim: calls by kind since the last ``reset``, and,
    inside a ``capture`` window, each call's site (kind, the caller's
    tensor's element count, bytes and dtype, the group's size) in call
    order: what the collective ledger joins a trace's calls to
    (``telemetry.ledger``).  Outside a window only the counts move, so a
    caller that never resets (a TP server) holds no growing list."""

    KINDS = ("all_reduce", "all_gather", "reduce_scatter", "broadcast",
             "all_to_all", "collective_permute")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        """Zero the counts; end any capture and drop its sites."""
        self.counts = dict.fromkeys(self.KINDS, 0)
        self._sites: list[tuple] | None = None

    def capture(self) -> None:
        """Record each call's site from here until ``sites()`` or
        ``reset()``: the one step whose calls the ledger joins."""
        self._sites = []

    def record(self, kind: str, x: torch.Tensor, group: int) -> None:
        self.counts[kind] += 1
        if self._sites is not None:
            # the tensor's facts, not the tensor: a reference would
            # keep it
            self._sites.append((kind, x.numel(), x.element_size(),
                                x.dtype, group))

    def read(self) -> dict:
        return dict(self.counts)

    def sites(self) -> list[dict]:
        """The captured calls, in order (none outside a capture); ends
        the capture."""
        got, self._sites = self._sites or [], None
        return [{"kind": k, "numel": n, "bytes": n * size,
                 "dtype": str(dtype).removeprefix("torch."), "group": g}
                for k, n, size, dtype, g in got]

    @staticmethod
    def nonzero(counts: dict) -> dict:
        """A reading without its zero kinds, for printing."""
        return {k: v for k, v in counts.items() if v}


COLLECTIVES = CollectiveCounts()
# K7's launches and its plain version's calls
COUNTS = LaunchCount()
TOLERANCE = {torch.bfloat16: (1e-4, 2 ** -7)}   # (atol, rtol)


def _group(axis):
    return resolve_axis(axis).group


# ----------------------------------------------------- wire calls (no grad)

def _all_reduce_raw(x, axis, op):
    out = x.detach().clone()
    if initialized():
        dist.all_reduce(out, op=op, group=_group(axis))
        COLLECTIVES.record("all_reduce", out, axis_size(axis))
    return out


def _gather_raw(x, axis, dim):
    """Rank-order concatenation of every rank's ``x`` along ``dim``."""
    n = axis_size(axis)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0], *xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=_group(axis))
    COLLECTIVES.record("all_gather", xt, n)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter_raw(x, axis, dim):
    """Sum over ranks; each rank keeps its ``dim``-chunk."""
    n = axis_size(axis)
    xt = x.movedim(dim, 0).contiguous()
    _check_chunk("reduce_scatter", f"scatter dim {dim}", xt.shape[0], n,
                 axis)
    out = xt.new_empty((xt.shape[0] // n, *xt.shape[1:]))
    dist.reduce_scatter_tensor(out, xt, op=dist.ReduceOp.SUM,
                               group=_group(axis))
    COLLECTIVES.record("reduce_scatter", xt, n)
    return out.movedim(0, dim).contiguous()


def _hop(x, axis, shift):
    """One ring hop: rank i sends ``x`` to (i + shift) mod n and
    returns what (i - shift) mod n sent."""
    n, i = axis_size(axis), axis_rank(axis)
    perm = _ring_perm(n, shift)
    dst = perm[i][1]
    src = next(s for s, d in perm if d == i)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, global_rank(axis, dst), _group(axis)),
           dist.P2POp(dist.irecv, out, global_rank(axis, src), _group(axis))]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    COLLECTIVES.record("collective_permute", x, n)
    return out


# ------------------------------------------------------ plain collectives

class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_reduce_raw(x, axis, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):   # psum transposes to psum
        return _all_reduce_raw(g, ctx.axis, dist.ReduceOp.SUM), None


_REDUCE_OPS = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def all_reduce(x, axis_name="dp", op: str = "sum", *, mean: bool = False):
    """Twin of ``dist.all_reduce`` with SUM / MAX / MIN / PRODUCT;
    ``mean=True`` divides the sum by the axis size.  PRODUCT is the
    reference's sign-corrected ``exp(sum(log|x|))`` (three reductions),
    not an exact product."""
    if op == "sum":
        out = _AllReduceSum.apply(x, axis_name)
    elif op in _REDUCE_OPS:
        out = _all_reduce_raw(x, axis_name, _REDUCE_OPS[op])
    elif op in ("prod", "product"):
        neg = all_reduce((x < 0).float(), axis_name)
        has_zero = all_reduce((x == 0).float(), axis_name, "max")
        ones = torch.ones((), dtype=x.dtype, device=x.device)
        mag = torch.exp(all_reduce(torch.log(torch.abs(
            torch.where(x == 0, ones, x))), axis_name))
        sign = torch.where(neg % 2 == 1, -1.0, 1.0)
        out = torch.where(has_zero > 0, 0.0, sign * mag).to(x.dtype)
    else:
        raise ValueError(f"unknown reduce op {op!r}")
    if mean:
        if op != "sum":
            raise ValueError("mean only makes sense with sum")
        out = out / axis_size(axis_name)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _gather_raw(x, axis, dim)

    @staticmethod
    def backward(ctx, g):   # all_gather transposes to psum_scatter
        return _reduce_scatter_raw(g, ctx.axis, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _reduce_scatter_raw(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_raw(g, ctx.axis, ctx.dim), None, None


def all_gather(x, axis_name="dp", *, axis: int = 0, tiled: bool = True):
    """Twin of ``dist.all_gather_into_tensor``: every rank's ``x``
    concatenated along ``axis`` in rank order (``tiled=False``: stacked
    along a new ``axis``)."""
    if not initialized():
        return x if tiled else x.unsqueeze(axis % (x.ndim + 1))
    if not tiled:
        axis = axis % (x.ndim + 1)
        return _AllGather.apply(x.unsqueeze(axis), axis_name, axis)
    return _AllGather.apply(x, axis_name, axis % x.ndim)


def reduce_scatter(x, axis_name="dp", *, axis: int = 0, tiled: bool = True):
    """Twin of ``dist.reduce_scatter_tensor``: the sum over ranks, each
    rank keeping its ``axis``-chunk (``tiled=False``: ``axis`` has the
    axis size and each rank keeps its entry, without the dim)."""
    axis = axis % x.ndim
    if not initialized():
        return x if tiled else x.squeeze(axis)
    out = _ReduceScatter.apply(x, axis_name, axis)
    return out if tiled else out.squeeze(axis)


def broadcast(x, axis_name="dp", root: int = 0):
    """Twin of ``dist.broadcast``: every rank receives rank ``root``'s
    value (a tensor or a dict / list / tuple tree of them)."""
    def leaf(a):
        out = a.detach().clone()
        if initialized():
            dist.broadcast(out, src=global_rank(axis_name, root),
                           group=_group(axis_name))
            COLLECTIVES.record("broadcast", out, axis_size(axis_name))
        return out
    return tree_map(leaf, x)


def scatter(x, axis_name="dp", *, axis: int = 0):
    """Twin of ``dist.scatter`` as the reference forms it: every rank
    slices its own equal chunk of the (already broadcast) ``x``; no
    wire call."""
    n, idx = axis_size(axis_name), axis_rank(axis_name)
    if x.shape[axis] % n:
        raise ValueError(f"scatter: dim {axis} of size {x.shape[axis]} not "
                         f"divisible by axis "
                         f"{resolve_axis(axis_name).name!r} size {n}")
    chunk = x.shape[axis] // n
    return x.narrow(axis, idx * chunk, chunk)


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, shift):
        ctx.axis, ctx.shift = axis, shift
        return _hop(x, axis, shift)

    @staticmethod
    def backward(ctx, g):   # the reverse permutation
        return _hop(g, ctx.axis, -ctx.shift), None, None


def ppermute_ring(x, axis_name="dp", *, shift: int = 1):
    """Ring send/recv: rank i sends to (i + shift) mod n."""
    if axis_size(axis_name) == 1:
        return x
    return _Permute.apply(x, axis_name, shift)


def _all_to_all_raw(x, axis, split_axis, concat_axis, tiled):
    n = axis_size(axis)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of size "
                         f"{x.shape[split_axis]} not divisible by axis "
                         f"{resolve_axis(axis).name!r} size {n}")
    chunks = x.detach().chunk(n, split_axis)
    if not tiled:
        chunks = [c.squeeze(split_axis) for c in chunks]
    inp = torch.stack([c.contiguous() for c in chunks])
    out = torch.empty_like(inp)
    if initialized():
        dist.all_to_all_single(out, inp, group=_group(axis))
        COLLECTIVES.record("all_to_all", inp, n)
    else:
        out.copy_(inp)
    if tiled:
        return torch.cat(list(out), dim=concat_axis)
    return torch.stack(list(out), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_axis, concat_axis, tiled):
        ctx.args = axis, split_axis, concat_axis, tiled
        return _all_to_all_raw(x, axis, split_axis, concat_axis, tiled)

    @staticmethod
    def backward(ctx, g):   # the inverse all_to_all: split and concat swap
        axis, split_axis, concat_axis, tiled = ctx.args
        return (_all_to_all_raw(g, axis, concat_axis, split_axis, tiled),
                None, None, None, None)


def all_to_all(x, axis_name="dp", *, split_axis: int = 0,
               concat_axis: int = 0, tiled: bool = True):
    """Twin of ``lax.all_to_all``: ``x`` split along ``split_axis`` into
    one chunk per rank, chunk j sent to rank j, the received chunks
    concatenated along ``concat_axis`` in rank order (``tiled=False``:
    ``split_axis`` has the axis size and is removed; the received
    chunks stack along a new ``concat_axis``).  Its backward is the
    transpose ``lax.all_to_all`` gets under ``shard_map``: the inverse
    all_to_all of the cotangent, ``split_axis`` and ``concat_axis``
    swapped (one more ``all_to_all`` record)."""
    return _AllToAll.apply(x, axis_name, split_axis, concat_axis, tiled)


def barrier(axis_name="dp"):
    """A one-element all_reduce, which is what ``dist.barrier`` is under
    NCCL; returns the summed token (the axis size)."""
    return _all_reduce_raw(torch.ones((), dtype=torch.float32,
                                      device=_barrier_device()),
                           axis_name, dist.ReduceOp.SUM)


def _barrier_device():
    if initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def tree_all_reduce(tree, axis_name="dp", *, mean: bool = True):
    """Per-leaf ``all_reduce`` of a tree (one call per leaf)."""
    return tree_map(lambda g: all_reduce(g, axis_name, mean=mean), tree)


def tree_all_gather(tree, axis_name="dp", *, axis: int = 0,
                    tiled: bool = True):
    """Per-leaf ``all_gather`` of a nested tree: non-tensor leaves pass
    through, 0-d leaves gather into a (world,) vector."""
    def leaf(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.ndim == 0:
            return all_gather(x[None], axis_name, axis=0, tiled=True)
        return all_gather(x, axis_name, axis=axis, tiled=tiled)
    return tree_map(leaf, tree)


# ------------------------------------------------------------ ring family

class RingShard:
    """A weight left SHARDED along its contraction dim: the marker the
    FSDP layer hook of the ring_fused modes hands the model, so that the
    projection runs as ``all_gather_matmul`` (``impl="xla"``) or its
    kernel twin ``all_gather_matmul_pallas`` (``impl="pallas"``, K7)
    instead of gather-then-matmul."""

    def __init__(self, shard, axis_name="dp", impl: str = "xla"):
        self.shard = shard
        self.axis_name = axis_name
        self.impl = impl

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"RingShard({tuple(self.shard.shape)}, "
                f"axis={resolve_axis(self.axis_name).name!r}, "
                f"impl={self.impl!r})")


def _ring_perm(n: int, shift: int = 1):
    return [(i, (i + shift) % n) for i in range(n)]


def _check_chunk(name: str, what: str, size: int, n: int, axis_name):
    """The ring splits ``what`` into one chunk per rank; an indivisible
    dim raises here, by name."""
    if size % n:
        raise ValueError(
            f"{name}: {what} of size {size} is not divisible by mesh "
            f"axis {resolve_axis(axis_name).name!r} size {n} — the ring "
            f"needs one equal chunk per device (pad the dim or use the "
            f"monolithic collective)")


def _ring_gather_impl(x, axis_name, dim: int):
    """n - 1 hops assembling the shards in rank order: value for value
    ``all_gather`` (pure data movement)."""
    n, idx = axis_size(axis_name), axis_rank(axis_name)
    chunk = x.shape[dim]
    out = x.new_zeros(x.shape[:dim] + (n * chunk,) + x.shape[dim + 1:])
    cur = x
    for t in range(n):
        src = (idx - t) % n          # whose shard arrived after t hops
        out.narrow(dim, src * chunk, chunk).copy_(cur)
        if t < n - 1:
            cur = _hop(cur, axis_name, 1)
    return out


class _RingAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, dim):
        ctx.axis, ctx.dim = axis_name, dim
        return _ring_gather_impl(x, axis_name, dim)

    @staticmethod
    def backward(ctx, g):   # pinned to the monolithic gather's transpose
        return _reduce_scatter_raw(g, ctx.axis, ctx.dim), None, None


def ring_all_gather(x, axis_name="dp", axis: int = 0):
    """Ring-decomposed :func:`all_gather`: the same values (rank-order
    placement, no arithmetic) from n - 1 ``collective_permute`` hops,
    and the backward pinned to one monolithic reduce_scatter, so the
    grads are the same too."""
    if axis_size(axis_name) == 1:   # degenerate ring: nothing to gather
        return x
    return _RingAllGather.apply(x, axis_name, axis % x.ndim)


class _DecomposedAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, dim):
        ctx.axis = axis_name
        return _ring_gather_impl(_reduce_scatter_raw(x, axis_name, dim),
                                 axis_name, dim)

    @staticmethod
    def backward(ctx, g):   # pinned to the all_reduce's transpose
        return _all_reduce_raw(g, ctx.axis, dist.ReduceOp.SUM), None, None


def decomposed_all_reduce(x, axis_name="dp", axis: int = -1):
    """The sum over ranks as a reduce_scatter along ``axis`` then the
    ring all-gather of the summed chunks (n - 1 ``collective_permute``
    hops): the reduction stays in one monolithic reduce_scatter and the
    re-assembly moves data only, so the value is the all_reduce's where
    the two collectives add in one order.  The backward is the
    all_reduce of the cotangent, as the reference pins it.  ``axis``
    must divide by the ring size; at one rank this is the identity."""
    n = axis_size(axis_name)
    if n == 1:
        return x
    dim = axis % x.ndim
    _check_chunk("decomposed_all_reduce", f"scatter dim {dim}",
                 x.shape[dim], n, axis_name)
    return _DecomposedAllReduce.apply(x, axis_name, dim)


def all_gather_matmul(a, w_shard, axis_name="dp"):
    """``a @ W`` where ``W`` is the rank-order concatenation of every
    rank's ``w_shard`` rows: at ring step t the chunk on hand multiplies
    ``a``'s matching K-chunk while the next shard travels.  Plain
    differentiable code: its autograd is the reversed ring (each hop's
    backward is the reverse hop), which sums dW into the shards with no
    separate reduce_scatter.  The chunked contraction reassociates the
    K-sum: numerically equivalent to gather-then-matmul, not bitwise."""
    n = axis_size(axis_name)
    if n == 1:   # degenerate ring: the shard IS the whole weight
        return a @ w_shard
    k_chunk = w_shard.shape[0]
    K = a.shape[-1]
    if K != n * k_chunk:
        raise ValueError(
            f"all_gather_matmul: activation contraction dim {K} != "
            f"mesh axis {resolve_axis(axis_name).name!r} size {n} x weight "
            f"shard rows {k_chunk} — the shard must be a 1/{n} row-slice of "
            f"the full weight (got shard shape {tuple(w_shard.shape)})")
    idx = axis_rank(axis_name)
    acc = torch.zeros(a.shape[:-1] + (w_shard.shape[1],),
                      dtype=torch.promote_types(a.dtype, w_shard.dtype),
                      device=a.device)
    cur = w_shard
    for t in range(n):
        src = (idx - t) % n
        acc = acc + a.narrow(-1, src * k_chunk, k_chunk) @ cur
        if t < n - 1:
            cur = ppermute_ring(cur, axis_name)
    return acc.to(a.dtype)


def matmul_reduce_scatter(a, b, axis_name="dp", *, axis: int = 0):
    """The scatter side of the collective matmul: the reduce_scatter of
    ``a @ b`` over row chunks, each chunk's partial product computed
    just before the travelling accumulator needs it.  The ring adds the
    ranks' partials in its own order: equal to ``reduce_scatter(a @ b)``
    up to f32 reassociation, not bit for bit.  ``axis`` must be 0."""
    n = axis_size(axis_name)
    if n == 1:
        return a @ b
    if axis % a.ndim != 0:
        raise ValueError("matmul_reduce_scatter: only axis=0 (row chunks "
                         "of the result) is supported")
    _check_chunk("matmul_reduce_scatter", "result row dim", a.shape[0], n,
                 axis_name)
    idx = axis_rank(axis_name)
    chunk = a.shape[0] // n

    def partial_product(c):
        return a.narrow(0, c * chunk, chunk) @ b

    # the accumulator for chunk (idx - s - 1) at step s lands fully summed
    # on its owner after n - 1 hops
    acc = partial_product((idx - 1) % n)
    for s in range(1, n):
        acc = ppermute_ring(acc, axis_name)
        acc = acc + partial_product((idx - s - 1) % n)
    return acc


# ---------------------------------------------------------------- K7

def ag_matmul_plain(a2, w, out_dtype=None):
    """K7's plain version: ``a2 (M, Kc) @ w (Kc, N)`` with f32 sums,
    rounded once to ``out_dtype`` (default ``promote(a2, w)``)."""
    out_dtype = out_dtype or torch.promote_types(a2.dtype, w.dtype)
    return torch.matmul(a2.float(), w.float()).to(out_dtype)


def ag_matmul_layout(a2, w) -> int:
    """K7's operand rules, on any device: bf16 operands, ``w`` (Kc, N)
    contiguous, ``a2`` (M, Kc) a row-strided view (its last dim
    contiguous) as the ring's K-chunk ``a[..., s:s+Kc]`` is; Kc, N and
    the row stride multiples of 8 and both operands 16-byte aligned (the
    strides and bases TMA takes).  Returns the row stride ``lda``."""
    M, K = a2.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError(f"ag_matmul_kernel: inner dims {K} != {K2}")
    if a2.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"ag_matmul_kernel takes bf16 operands, got "
                         f"{a2.dtype} and {w.dtype}")
    lda = a2.stride(0) if M > 1 else K
    if a2.stride(1) != 1 or lda < K:
        raise ValueError("ag_matmul_kernel: a must be a row-strided view "
                         "with a contiguous last dim")
    if not w.is_contiguous():
        raise ValueError("ag_matmul_kernel: w is not contiguous")
    if K % 8 or N % 8 or lda % 8:
        raise ValueError(f"ag_matmul_kernel: Kc={K}, N={N} and the row "
                         f"stride {lda} must be multiples of 8 (16-byte "
                         f"row strides)")
    if a2.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("ag_matmul_kernel: operands must be 16-byte "
                         "aligned")
    return lda


def ag_matmul_kernel(a2, w):
    """K7: ``a2 (M, Kc) @ w (Kc, N)`` in ``promote(a2, w)``.  CPU
    tensors take the plain version (counted in ``COUNTS.plain_calls``);
    on the card the operands follow :func:`ag_matmul_layout`."""
    if a2.device.type == "cpu" and w.device.type == "cpu":
        COUNTS.plain_calls += 1
        return ag_matmul_plain(a2, w)
    M, K = a2.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError(f"ag_matmul_kernel: inner dims {K} != {K2}")
    check_cuda_operands("ag_matmul_kernel", {"w": w}, {},
                        {"a": a2} if a2.is_contiguous() else None)
    if a2.device != w.device:
        raise ValueError(f"ag_matmul_kernel: a is on {a2.device}, w on "
                         f"{w.device}")
    lda = ag_matmul_layout(a2, w)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=w.device)
    launch("ag_matmul_kernel", loader.load("ag_matmul").ag_matmul_launch,
           ptr(a2), ptr(w), ptr(out), M, N, K, lda, device=w.device)
    COUNTS.launches += 1
    return out


class _ChunkMatmul(torch.autograd.Function):
    """``a @ w`` with the forward through K7 and the backward the two
    plain products the reference pins to XLA dots outside its kernel
    (``_pcm_bwd``): ``g @ wᵀ`` and ``aᵀ @ g``."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        out = ag_matmul_kernel(a.reshape(-1, a.shape[-1]), w)
        return out.reshape(*a.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        a2 = a.reshape(-1, a.shape[-1])
        da = (g2 @ w.t()).reshape(a.shape).to(a.dtype)
        dw = (a2.t() @ g2).to(w.dtype)
        return da, dw


def _pallas_chunk_matmul(a, w):
    return _ChunkMatmul.apply(a, w)


def all_gather_matmul_pallas(a, w_shard, axis_name="dp"):
    """Kernel-tier :func:`all_gather_matmul`: the same ring (hops stay
    ``ppermute_ring``, the calls the shim counts), with each chunk
    product through K7.  At one rank: one whole-weight K7 call.  The
    reference's ``block_m`` / ``block_n`` choose Pallas blocks; K7's
    tiles are its own, and every output's K-sum stays in one
    accumulator whatever they are."""
    n = axis_size(axis_name)
    if n == 1:   # degenerate ring: one whole-weight kernel call
        return _pallas_chunk_matmul(a, w_shard).to(a.dtype)
    k_chunk = w_shard.shape[0]
    K = a.shape[-1]
    if K != n * k_chunk:
        raise ValueError(
            f"all_gather_matmul_pallas: activation contraction dim {K} "
            f"!= mesh axis {resolve_axis(axis_name).name!r} size {n} x "
            f"weight shard rows {k_chunk} — the shard must be a 1/{n} "
            f"row-slice of the full weight (got shard shape "
            f"{tuple(w_shard.shape)})")
    idx = axis_rank(axis_name)
    acc = torch.zeros(a.shape[:-1] + (w_shard.shape[1],),
                      dtype=torch.promote_types(a.dtype, w_shard.dtype),
                      device=a.device)
    cur = w_shard
    for t in range(n):
        src = (idx - t) % n
        acc = acc + _pallas_chunk_matmul(
            a.narrow(-1, src * k_chunk, k_chunk), cur)
        if t < n - 1:
            cur = ppermute_ring(cur, axis_name)
    return acc.to(a.dtype)

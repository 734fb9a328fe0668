"""Ring attention: exact attention over a sequence sharded on an axis.

Port of the JAX package's ``ops/ring_attention.py``.  Each rank keeps
its query chunk and folds every rank's K/V block into an online-softmax
accumulator ``(m, l, o)`` while the blocks travel the ring: n - 1 hops
of ``ppermute_ring`` for K and for V, the first at the fold's start and
none after the last block (the local block is folded first).  The hops'
backward is the reverse hop, so autograd carries dK and dV back round
the ring.

The arithmetic is the reference's: f32 scores (``_block_scores``), K/V
upcast to f32 and repeated per block for GQA (the ring carries only the
KV heads), the -1e30 mask, and the guards that keep a fully masked
block's probabilities and a first block's correction at zero.  The
reference computes it with plain einsums, not in Pallas, so the port's
is plain ``torch.einsum`` as well; it does not call the flash kernel.

Two layouts:

* ``"contiguous"``: rank r holds global rows ``[r·S, (r+1)·S)``.  Under
  the causal mask an earlier rank's block is fully visible, the own
  block lower-triangular and a later rank's fully masked, yet computed
  (and discarded), as the reference computes it;
* ``"zigzag"``: the global sequence cut into 2D stripes of width
  W = S/2, rank r holding stripes r and 2D − 1 − r.  Each remote hop
  runs two fully visible W × W products (q_late × k_early, and
  q_early × k_early when src < my, else q_late × k_late); only the
  local block is masked, by global positions (:func:`zigzag_positions`).
  Batches go in through ``parallel.sequence.zigzag_shuffle``.

Each hop's fold is a module-level function of the query chunk, the
visiting K/V block, the source and own ranks and ``(m, l, o)``
(:func:`contiguous_hop`, :func:`zigzag_hop`, over :func:`merge_chunk`
and :func:`merge`), so one process can fold every rank's blocks in hop
order without a process group (``chip_smoke.py`` phase 16c).
:data:`MERGES` counts the merges, the fully masked ones and the score
elements computed.

``block_q`` chunks the query rows of each merge, bounding one merge's
f32 score buffer to ``(B, n, block_q, S)``; autograd still keeps every
merge's scores and probabilities for the backward.
"""

from __future__ import annotations

import torch

from ..utils.mesh import axis_rank, axis_size
from . import collectives as C

_NEG_INF = -1e30
LAYOUTS = ("contiguous", "zigzag")


class MergeCount:
    """Merges since the last ``reset``: ``calls``, ``masked`` (merges
    whose block no query row may see) and ``scores`` (score elements
    computed)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = self.masked = self.scores = 0

    def read(self) -> dict:
        return {"calls": self.calls, "masked": self.masked,
                "scores": self.scores}


MERGES = MergeCount()


def _block_scores(q, k, scale):
    """(B, Sq, n, hd) × (B, Skv, n, hd) f32 → f32 (B, n, Sq, Skv)."""
    return torch.einsum("bqnh,bknh->bnqk", q, k) * scale


def _fold_scores(s, v_blk, m, l, o):
    """The online-softmax merge of masked scores ``s`` (B, n, Cq, Skv)
    and their values into one query chunk's ``(m, l, o)``: m, l (B, n,
    Cq, 1), o (B, Cq, n, hd), all f32."""
    MERGES.calls += 1
    MERGES.scores += s.numel()
    m_blk = s.amax(dim=-1, keepdim=True)
    m_new = torch.maximum(m, m_blk)
    p = torch.exp(s - m_new)
    # a fully masked block must add nothing, though exp(-1e30 - -1e30)
    # is 1 while m_new is still -1e30
    p = torch.where(m_new <= _NEG_INF, 0.0, p)
    corr = torch.where(m <= _NEG_INF, 0.0, torch.exp(m - m_new))
    l = l * corr + p.sum(dim=-1, keepdim=True)
    o = o * corr.transpose(1, 2) + torch.einsum("bnqk,bknh->bqnh", p, v_blk)
    return m_new, l, o


def _causal_block(src: int, my: int, off: int, cq: int, skv: int, device):
    """The contiguous layout's visibility of rank ``src``'s block to the
    query rows ``off .. off + cq`` of rank ``my``'s chunk: None when
    every key is visible."""
    if src < my:      # an earlier block: every key visible
        return None
    if src == my:     # the own block: the lower triangle
        rows = off + torch.arange(cq, device=device)
        return torch.arange(skv, device=device)[None, :] <= rows[:, None]
    return torch.zeros((cq, skv), dtype=torch.bool, device=device)


def merge_chunk(qc, k_blk, v_blk, src: int, my: int, m, l, o, *,
                scale: float, causal: bool = True, off: int = 0):
    """Merge rank ``src``'s K/V block (f32, GQA heads repeated) into the
    ``(m, l, o)`` of rank ``my``'s query chunk ``qc`` (f32, its first
    row ``off`` rows into the local sequence): the contiguous layout's
    fold of one hop."""
    s = _block_scores(qc, k_blk, scale)
    if causal:
        vis = _causal_block(src, my, off, qc.shape[1], k_blk.shape[1],
                            qc.device)
        if vis is not None:
            MERGES.masked += src > my
            s = torch.where(vis, s, _NEG_INF)
    return _fold_scores(s, v_blk, m, l, o)


def merge(qc, k_blk, v_blk, m, l, o, *, scale: float, qpos=None,
          kpos=None):
    """The zigzag layout's merge of one K/V block into one query chunk:
    causal by global positions when ``qpos`` / ``kpos`` are given, fully
    visible otherwise."""
    s = _block_scores(qc, k_blk, scale)
    if qpos is not None:
        s = torch.where(kpos[None, :] <= qpos[:, None], s, _NEG_INF)
    return _fold_scores(s, v_blk, m, l, o)


def _rep_kv(k_blk, v_blk, rep: int):
    k_blk, v_blk = k_blk.float(), v_blk.float()
    if rep != 1:
        k_blk = k_blk.repeat_interleave(rep, dim=2)
        v_blk = v_blk.repeat_interleave(rep, dim=2)
    return k_blk, v_blk


def init_acc(q, cq: int) -> list:
    """The empty accumulator of a local chunk ``q`` (B, S, nq, hd): one
    ``(m, l, o)`` for each ``cq`` query rows."""
    B, S, nq, hd = q.shape
    dev = q.device
    return [(torch.full((B, nq, cq, 1), _NEG_INF, device=dev),
             torch.zeros((B, nq, cq, 1), device=dev),
             torch.zeros((B, cq, nq, hd), device=dev))
            for _ in range(S // cq)]


def finish(acc: list, dtype) -> torch.Tensor:
    """``o / l`` of the accumulator, rows with no visible key at 0, in
    ``dtype``: (B, S, nq, hd)."""
    l = torch.cat([a[1] for a in acc], dim=2)
    o = torch.cat([a[2] for a in acc], dim=1)
    l = torch.where(l == 0.0, 1.0, l)
    return (o / l.transpose(1, 2)).to(dtype)


def contiguous_hop(qf, k_blk, v_blk, src: int, my: int, acc: list, *,
                   scale: float, causal: bool = True) -> list:
    """Fold rank ``src``'s K/V block (as it travels: the input dtype,
    the KV heads) into rank ``my``'s accumulator, chunk by chunk:
    ``qf`` is the local query chunk in f32."""
    rep = qf.shape[2] // k_blk.shape[2]
    kf, vf = _rep_kv(k_blk, v_blk, rep)
    cq = acc[0][2].shape[1]
    return [merge_chunk(qf[:, c * cq:(c + 1) * cq], kf, vf, src, my,
                        *acc[c], scale=scale, causal=causal, off=c * cq)
            for c in range(len(acc))]


def _product(qp, kf, vf, acc: list, *, scale, qpos=None, kpos=None):
    """``merge`` over the chunks ``acc`` of the query rows ``qp``."""
    cq = acc[0][2].shape[1]
    return [merge(qp[:, c * cq:(c + 1) * cq], kf, vf, *acc[c], scale=scale,
                  qpos=None if qpos is None else qpos[c * cq:(c + 1) * cq],
                  kpos=kpos)
            for c in range(len(acc))]


def zigzag_hop(qf, k_blk, v_blk, src: int, my: int, n_dev: int,
               acc: list, *, scale: float) -> list:
    """The zigzag layout's fold of rank ``src``'s K/V block into rank
    ``my``'s accumulator (chunks of the local S; the first half the
    early stripe).  The local block (``src == my``) is one
    position-masked product over the chunk; a remote one two fully
    visible W × W products."""
    rep = qf.shape[2] // k_blk.shape[2]
    kf, vf = _rep_kv(k_blk, v_blk, rep)
    S = qf.shape[1]
    W = S // 2
    half = len(acc) // 2
    if src == my:
        pos = zigzag_positions(None, S, rank=my, n_dev=n_dev,
                               device=qf.device)
        return _product(qf, kf, vf, acc, scale=scale, qpos=pos, kpos=pos)
    early, late = acc[:half], acc[half:]
    # q_late × k_early: visible for every src != my
    late = _product(qf[:, W:], kf[:, :W], vf[:, :W], late, scale=scale)
    if src < my:      # q_early × k_early
        early = _product(qf[:, :W], kf[:, :W], vf[:, :W], early,
                         scale=scale)
    else:             # q_late × k_late
        late = _product(qf[:, W:], kf[:, W:], vf[:, W:], late, scale=scale)
    return early + late


def zigzag_positions(axis_name, s_local: int, *, rank: int | None = None,
                     n_dev: int | None = None, device=None) -> torch.Tensor:
    """Global positions of a rank's zigzag chunk (stripe ``my`` then
    stripe ``2D − 1 − my``): what RoPE and the local causal mask see.
    ``rank`` / ``n_dev`` name the rank without a process group."""
    my = axis_rank(axis_name) if rank is None else rank
    n = axis_size(axis_name) if n_dev is None else n_dev
    w = s_local // 2
    ar = torch.arange(w, device=device)
    return torch.cat([my * w + ar, (2 * n - 1 - my) * w + ar])


def chunk_rows(block_q, s: int, what: str) -> int:
    """The query rows of one merge: ``block_q`` checked against ``s``
    (the local chunk, or the zigzag stripe), as the reference checks it;
    ``s`` when None or 0."""
    if block_q is not None and block_q <= 0:
        raise ValueError(f"block_q={block_q} must be a positive divisor "
                         f"of {what}={s} (or None)")
    if block_q and block_q > s:
        raise ValueError(f"block_q={block_q} exceeds {what}={s}; pass "
                         f"block_q=None (or <= {what}) — silently running "
                         f"unchunked would hide a misconfigured sp setup")
    cq = block_q if block_q and block_q < s else s
    if s % cq:
        raise ValueError(f"block_q={block_q} must divide {what}={s}")
    return cq


def ring_attention(q, k, v, axis_name, *, scale: float,
                   causal: bool = True, block_q: int | None = None,
                   layout: str = "contiguous") -> torch.Tensor:
    """Attention over a sequence sharded on ``axis_name``.  q (B, S,
    nq, hd), k and v (B, S, nkv, hd): this rank's chunk (rank-order
    contiguous, or the zigzag stripe pair).  Returns (B, S, nq, hd) in
    q's dtype.  ``block_q`` must divide S (S/2 under zigzag)."""
    if layout == "zigzag":
        if not causal:
            raise ValueError("zigzag layout only pays off for causal "
                             "attention — use layout='contiguous'")
    elif layout != "contiguous":
        raise ValueError(f"unknown ring layout {layout!r}")
    n_dev, my = axis_size(axis_name), axis_rank(axis_name)
    S = q.shape[1]
    if layout == "zigzag":
        if S % 2:
            raise ValueError(f"zigzag needs an even local chunk, got {S}")
        cq = chunk_rows(block_q, S // 2, "S_local/2")

        def hop(k_blk, v_blk, src, acc):
            return zigzag_hop(qf, k_blk, v_blk, src, my, n_dev, acc,
                              scale=scale)
    else:
        cq = chunk_rows(block_q, S, "S_local")

        def hop(k_blk, v_blk, src, acc):
            return contiguous_hop(qf, k_blk, v_blk, src, my, acc,
                                  scale=scale, causal=causal)
    qf = q.float()
    acc = hop(k, v, my, init_acc(q, cq))        # t = 0: the own block
    for t in range(1, n_dev):
        # the hop at the fold's start: n - 1 hops, none after the last
        k = C.ppermute_ring(k, axis_name)
        v = C.ppermute_ring(v, axis_name)
        acc = hop(k, v, (my - t) % n_dev, acc)
    return finish(acc, q.dtype)


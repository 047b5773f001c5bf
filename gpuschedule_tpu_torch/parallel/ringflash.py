"""Ring flash attention: the flash kernels as the ring's per-chunk op.

Counterpart of ``gpuschedule_tpu/parallel/ringflash.py``.  The sequence is
split over the mesh's ``sp`` axis and K/V chunks rotate as in
:mod:`gpuschedule_tpu_torch.parallel.ringattn`, but each chunk pair is the
blockwise flash forward in its f32-output form
(:func:`~gpuschedule_tpu_torch.ops.flash_attention.flash_chunk_fwd`), so no
(L, L) score matrix exists anywhere.

**Forward.**  Each pair returns (out, lse) in f32; partial results merge
with the associative flash merge (:func:`_merge`).  Causality is decided
per pair by ring position: the diagonal pair runs the causal kernel, past
pairs run unmasked, and future pairs launch nothing.

**Backward** is a second ring pass (a ``torch.autograd.Function``, not
autograd through the forward loop, which would save every visiting K/V
chunk).  The residuals are only the local (q, k, v, out, lse).  Given the
*global* lse, p = exp(s − lse) makes each pair's contribution exact
(:func:`~gpuschedule_tpu_torch.ops.flash_attention.flash_chunk_bwd`): dq
accumulates where it is, and the dk/dv accumulators ride the ring with
their chunk.  K/V take P − 1 hops, their accumulators P, after which each
is home with its whole gradient.  A future pair launches nothing, but
every rank still makes every exchange, so all ranks exchange in one order.

One rank's step is written once (:func:`_fwd_pair`, :func:`_bwd_pair`) and
driven over either exchange of :mod:`.ringattn`:
:func:`ring_flash_attention` over the mesh's process group, and
:func:`ring_flash_attention_in_process` with the P ranks in one process on
one device, over the whole (B, S, H, D) sequence (how one card runs the
ring).  The in-process ring runs the ranks' steps in turn on one thread:
a backward that blocked for peers on other threads would deadlock, since
autograd runs a device's backward on one worker thread.
"""

from __future__ import annotations

from typing import Optional

import torch

from gpuschedule_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_chunk_bwd,
    flash_chunk_fwd,
)
from gpuschedule_tpu_torch.ops.reference import NEG_INF
from gpuschedule_tpu_torch.parallel.mesh import Mesh
from gpuschedule_tpu_torch.parallel.ringattn import ProcessRing, local_ring, resolve_ring_mesh


def _merge(out_run, lse_run, out_i, lse_i):
    """Fold one chunk pair's (out, lse) into the running f32 pair.

    NEG_INF is a finite sentinel (-1e30, ops/reference.py), so logaddexp and
    the weights stay finite with no NaN guard: a row no pair has touched yet
    merges at vanishing weight."""
    lse_new = torch.logaddexp(lse_run, lse_i)
    # (B, H, L) row weights onto (B, L, H, D) outputs
    wr = torch.exp(lse_run - lse_new).permute(0, 2, 1)[..., None]
    wi = torch.exp(lse_i - lse_new).permute(0, 2, 1)[..., None]
    return out_run * wr + out_i * wi, lse_new


def _pair_causal(my: int, src: int, causal: bool) -> Optional[bool]:
    """The kernel's ``causal`` for (q chunk ``my``) x (K/V chunk ``src``):
    True on the diagonal, False for a past pair (or any pair of a full
    ring), None for a future pair, which contributes nothing."""
    if not causal:
        return False
    if src == my:
        return True
    return False if src < my else None


def _fwd_pair(q, k_blk, v_blk, run, my, src, causal):
    """One rank's forward step: the pair's chunk op, merged into ``run``."""
    pair = _pair_causal(my, src, causal)
    if pair is None:
        return run
    out_i, lse_i = flash_chunk_fwd(q, k_blk, v_blk, causal=pair)
    return _merge(*run, out_i, lse_i)


def _bwd_pair(q, k_blk, v_blk, out, lse, g, acc, my, src, causal):
    """One rank's backward step: the pair's (dq, dk, dv), added to ``acc``."""
    pair = _pair_causal(my, src, causal)
    if pair is None:
        return acc
    grads = flash_chunk_bwd(q, k_blk, v_blk, out, lse, g, causal=pair)
    return tuple(a + c for a, c in zip(acc, grads))


def _ring_forward(ring, qs, ks, vs, causal):
    """[(out in q's dtype, lse rows)] for each rank held here."""
    runs = []
    for q in qs:
        b, l, h, _ = q.shape
        runs.append((torch.zeros(q.shape, dtype=torch.float32, device=q.device),
                     torch.full((b, h, l), NEG_INF, dtype=torch.float32, device=q.device)))
    kv = list(zip(ks, vs))
    for step in range(ring.size):
        for i, my in enumerate(ring.ranks):
            runs[i] = _fwd_pair(qs[i], *kv[i], runs[i], my, (my - step) % ring.size,
                                causal)
        if step + 1 < ring.size:
            kv = ring.rotate(kv)
    return [(out.to(q.dtype), lse) for (out, lse), q in zip(runs, qs)]


def _ring_backward(ring, qs, ks, vs, outs, lses, gs, causal):
    """[(dq, dk, dv) in f32] for each rank held here: the second ring pass."""
    f32 = lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device)  # noqa: E731
    dqs = [f32(q) for q in qs]
    riding = [(k, v, f32(k), f32(v)) for k, v in zip(ks, vs)]
    for step in range(ring.size):
        for i, my in enumerate(ring.ranks):
            k_blk, v_blk, dk, dv = riding[i]
            dqs[i], dk, dv = _bwd_pair(qs[i], k_blk, v_blk, outs[i], lses[i], gs[i],
                                       (dqs[i], dk, dv), my, (my - step) % ring.size,
                                       causal)
            riding[i] = (k_blk, v_blk, dk, dv)
        if step + 1 < ring.size:
            riding = ring.rotate(riding)
    homes = ring.rotate([r[2:] for r in riding])  # the accumulators' last hop
    return [(dq, dk, dv) for dq, (dk, dv) in zip(dqs, homes)]


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ring, causal):
        qs, ks, vs = ring.split(q), ring.split(k), ring.split(v)
        results = _ring_forward(ring, qs, ks, vs, causal)
        outs = [o for o, _ in results]
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *(lse for _, lse in results))
        ctx.ring, ctx.causal = ring, causal
        return ring.join(outs)

    @staticmethod
    def backward(ctx, g):
        n = len(ctx.ring.ranks)
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (list(saved[i * n:(i + 1) * n]) for i in range(5))
        gs = ctx.ring.split(g.contiguous().to(qs[0].dtype))
        grads = _ring_backward(ctx.ring, qs, ks, vs, outs, lses, gs, ctx.causal)
        dq, dk, dv = (ctx.ring.join([gr[j] for gr in grads]) for j in range(3))
        return dq.to(qs[0].dtype), dk.to(ks[0].dtype), dv.to(vs[0].dtype), None, None


def ring_flash_attention(q, k, v, *, mesh: Optional[Mesh] = None, axis: str = "sp",
                         causal: bool = True) -> torch.Tensor:
    """Attention over (B, L, H, D) chunks of a sequence split over the mesh
    axis ``axis``, the flash kernels as the per-chunk op; the calling
    contract of :func:`~gpuschedule_tpu_torch.parallel.ringattn.ring_attention`.
    ``sp == 1`` is :func:`~gpuschedule_tpu_torch.ops.flash_attention` itself."""
    shape = resolve_ring_mesh(mesh, axis)
    if shape[axis] == 1:
        return flash_attention(q, k, v, causal=causal)
    return _RingFlash.apply(q, k, v, ProcessRing(mesh, axis), causal)


def ring_flash_attention_in_process(q, k, v, *, sp: int,
                                    causal: bool = True) -> torch.Tensor:
    """:func:`ring_flash_attention` with the ``sp`` ranks of the ring held in
    this process, over the whole (B, S, H, D) sequence on one device."""
    if sp == 1:
        return flash_attention(q, k, v, causal=causal)
    return _RingFlash.apply(q, k, v, local_ring(q, sp), causal)

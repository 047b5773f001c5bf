"""Ring attention: causal self-attention over a sequence-sharded axis.

Counterpart of ``gpuschedule_tpu/parallel/ringattn.py``.  The sequence is
split over the mesh's ``sp`` axis into P chunks of L = S / P; rank r holds
chunk r of q, k and v and runs P rounds: attend its q chunk to the K/V
chunk it holds, folding the result into an online-softmax accumulator
(running max, denominator, weighted-value numerator, in f32), then pass
that K/V chunk to rank (r + 1) mod P.  Causality comes from global
positions, so a pair wholly in the future is masked to nothing.  Each
chunk pair is a dense (L, L) product: the JAX package computes it outside
any Pallas kernel, so here it is ``torch.einsum``.

Where the JAX ring exchanges with ``lax.ppermute`` inside ``shard_map``, a
ring here is one of two exchanges (:class:`ProcessRing`,
:class:`LocalRing`), and one rank's step is written once
(:func:`_dense_pair`):

- :func:`ring_attention` — the ranks of the mesh's sp group, one a process
  (``torchrun``): ``dist.batch_isend_irecv`` to (r + 1) mod P and from
  (r − 1) mod P; q, k and v are this rank's chunks.  Autograd runs through
  the loop, as JAX differentiates it: a rotation's backward sends the
  gradient the other way round the ring.
- :func:`ring_attention_in_process` — all P ranks of an sp group held in one
  process on one device, over the whole (B, S, H, D) sequence: a rotation
  hands rank r's chunks to rank r + 1 in a list.  It is the counterpart of
  a JAX sp mesh whose devices all live in one program, and how one card
  runs the ring.

Over tp a rank's q, k and v hold its H/tp heads, and the ring runs on them
alone: all the math is per head, as in the JAX rings' ``head_axis``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from gpuschedule_tpu_torch.ops.reference import NEG_INF, dense_attention
from gpuschedule_tpu_torch.parallel.mesh import Mesh

Blocks = List[Tuple[torch.Tensor, ...]]  # per rank held here: the blocks that ride the ring


class ProcessRing:
    """The sp group of a mesh with one of its ranks in this process: a
    rotation sends this rank's blocks to rank (r + 1) mod P and receives
    rank (r − 1) mod P's, peers named by their global ranks."""

    def __init__(self, mesh: Mesh, axis: str):
        self.group = mesh.group(axis)
        self.size = dist.get_world_size(self.group)
        me = dist.get_rank(self.group)
        self.ranks = [me]
        self._next = dist.get_global_rank(self.group, (me + 1) % self.size)
        self._prev = dist.get_global_rank(self.group, (me - 1) % self.size)

    def split(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [x.contiguous()]

    def join(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return xs[0]

    def exchange(self, tensors: Sequence[torch.Tensor], reverse: bool = False):
        """Send ``tensors`` one hop round the ring and receive the
        neighbour's: forward to the next rank, or back when ``reverse``."""
        to, frm = (self._prev, self._next) if reverse else (self._next, self._prev)
        sends = [t.contiguous() for t in tensors]
        recvs = [torch.empty_like(t) for t in sends]
        ops = [dist.P2POp(dist.isend, t, to, self.group) for t in sends]
        ops += [dist.P2POp(dist.irecv, t, frm, self.group) for t in recvs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return tuple(recvs)

    def rotate(self, blocks: Blocks) -> Blocks:
        return [_Rotate.apply(self, *blocks[0])]


class LocalRing:
    """All ``size`` ranks of an sp group in this process: rank r holds
    chunk r of the sequence (dim 1), and a rotation hands rank r's blocks
    to rank (r + 1) mod P."""

    def __init__(self, size: int):
        self.size = size
        self.ranks = list(range(size))

    def split(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [c.contiguous() for c in x.chunk(self.size, dim=1)]

    def join(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat(list(xs), dim=1)

    def rotate(self, blocks: Blocks) -> Blocks:
        return blocks[-1:] + blocks[:-1]


class _Rotate(torch.autograd.Function):
    """One hop of a process ring; its backward is the hop back."""

    @staticmethod
    def forward(ctx, ring: ProcessRing, *tensors):
        ctx.ring = ring
        return ring.exchange(tensors)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.ring.exchange(grads, reverse=True))


def local_ring(q: torch.Tensor, sp: int) -> LocalRing:
    """The in-process ring of ``sp`` ranks over ``q``'s sequence axis."""
    if sp < 1 or q.shape[1] % sp:
        raise ValueError(f"seq {q.shape[1]} not divisible by sp={sp}")
    return LocalRing(sp)


def resolve_ring_mesh(mesh: Optional[Mesh], axis: str):
    """The mesh's axis sizes, checked to hold ``axis``: the mesh contract
    shared by the dense ring and the flash composition
    (:mod:`gpuschedule_tpu_torch.parallel.ringflash`).  The port has no
    ambient mesh, so ``mesh`` is required."""
    if mesh is None:
        raise ValueError(f"no ambient mesh with axis {axis!r} in this port; pass mesh= explicitly")
    if axis not in mesh.shape:
        raise ValueError(f"mesh axes {tuple(mesh.shape)} have no {axis!r}")
    return mesh.shape


def _dense_pair(qf, k_blk, v_blk, state, my: int, src: int, causal: bool):
    """One rank's step: fold (q chunk ``my``) x (K/V chunk ``src``) into the
    online-softmax state (m, denom, num); ``qf`` is q in f32, pre-scaled."""
    m, denom, num = state
    logits = torch.einsum("blhd,bmhd->bhlm", qf, k_blk.float())
    if causal:
        l_q, l_k = qf.shape[1], k_blk.shape[1]
        pos_q = my * l_q + torch.arange(l_q, device=qf.device)
        pos_k = src * l_k + torch.arange(l_k, device=qf.device)
        logits = torch.where(pos_q[:, None] >= pos_k[None, :], logits, NEG_INF)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None])
    denom = denom * corr + p.sum(dim=-1)
    num = num * corr[..., None] + torch.einsum("bhlm,bmhd->bhld", p, v_blk.float())
    return m_new, denom, num


def dense_ring(ring, q, k, v, *, causal: bool) -> torch.Tensor:
    """The dense ring over ``ring`` (either exchange); q, k, v are what the
    ring splits: this rank's chunks, or the whole sequence in process."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qs, ks, vs = ring.split(q), ring.split(k), ring.split(v)
    states = []
    for qc in qs:
        b, l_q, h, d = qc.shape
        states.append((
            torch.full((b, h, l_q), NEG_INF, dtype=torch.float32, device=qc.device),
            torch.zeros((b, h, l_q), dtype=torch.float32, device=qc.device),
            torch.zeros((b, h, l_q, d), dtype=torch.float32, device=qc.device),
        ))
    qfs = [qc.float() * scale for qc in qs]
    blocks: Blocks = list(zip(ks, vs))
    for step in range(ring.size):
        for i, my in enumerate(ring.ranks):
            # after `step` rotations rank `my` holds the block of rank my - step
            src = (my - step) % ring.size
            states[i] = _dense_pair(qfs[i], *blocks[i], states[i], my, src, causal)
        if step + 1 < ring.size:
            blocks = ring.rotate(blocks)
    outs = [(num / torch.clamp(denom[..., None], min=1e-30)).permute(0, 2, 1, 3).to(q.dtype)
            for _, denom, num in states]
    return ring.join(outs)


def ring_attention(q, k, v, *, mesh: Optional[Mesh] = None, axis: str = "sp",
                   causal: bool = True) -> torch.Tensor:
    """Attention over (B, L, H, D) chunks of a sequence split over the mesh
    axis ``axis``, rank r of its group holding chunk r.  ``sp == 1`` is the
    dense oracle on the tensors as given; a ring needs the mesh's process
    group (a mesh of one rank has none, and raises)."""
    shape = resolve_ring_mesh(mesh, axis)
    if shape[axis] == 1:
        return dense_attention(q, k, v, causal=causal)
    return dense_ring(ProcessRing(mesh, axis), q, k, v, causal=causal)


def ring_attention_in_process(q, k, v, *, sp: int, causal: bool = True) -> torch.Tensor:
    """:func:`ring_attention` with the ``sp`` ranks of the ring held in this
    process, over the whole (B, S, H, D) sequence."""
    if sp == 1:
        return dense_attention(q, k, v, causal=causal)
    return dense_ring(local_ring(q, sp), q, k, v, causal=causal)

"""The gathered-sequence sp path: dense attention over a sequence gathered over sp.

Counterpart of the JAX ``ShardedTrainer(seq_shard=True)`` without
``ring_attn``: the token batch is sharded ``P("dp", "sp")``
(``gpuschedule_tpu/parallel/train.py:207-210``), the dense
``nn.SelfAttention`` core runs on it, and GSPMD gathers across sp what the
core needs.  The JAX profiler measures every sp > 1 point this way.  Here
each sp rank holds its chunk of the sequence; the core gathers k and v
over the mesh's sp group, and the rank's q rows attend to the whole key
range, masked at the chunk's causal offset.

The gather is a zero-padded all-reduce (each rank's chunk placed in
zeros, summed over sp), as :meth:`~.tp.Tp.gather` is: gloo takes an
all-reduce of CUDA tensors and no all-gather, so one code runs under gloo
and NCCL.  Its backward sums the gathered gradient over sp and hands each
rank its chunk's slice.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gpuschedule_tpu_torch.models.transformer import dense_self_attention


class _GatherSequence(torch.autograd.Function):
    """(B, L, ...) chunks of sp ranks -> the (B, sp·L, ...) sequence, on
    every rank; backward: the gradient summed over sp, this rank's chunk."""

    @staticmethod
    def forward(ctx, local, group, size, rank):
        n = local.shape[1]
        ctx.group, ctx.start, ctx.n = group, rank * n, n
        shape = list(local.shape)
        shape[1] = size * n
        full = local.new_zeros(shape)
        full.narrow(1, rank * n, n).copy_(local)
        dist.all_reduce(full, group=group)
        return full

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(1, ctx.start, ctx.n).contiguous(), None, None, None


def gather_sequence(local: torch.Tensor, mesh) -> torch.Tensor:
    """The whole sequence of which ``local`` (B, L, ...) is this rank's sp
    chunk, differentiable (every sp rank calls it)."""
    sp = mesh.shape["sp"]
    if sp == 1:
        return local
    return _GatherSequence.apply(local, mesh.group("sp"), sp, mesh.coordinate("sp"))


def gathered_attention(q, k, v, *, mesh, causal: bool = True) -> torch.Tensor:
    """Dense attention of this rank's q chunk (B, L, H, D) over the keys
    and values of the whole sequence, gathered over sp: the output rows of
    the chunk, (B, L, H, D)."""
    offset = mesh.coordinate("sp") * q.shape[1]
    return dense_self_attention(q, gather_sequence(k, mesh), gather_sequence(v, mesh),
                                causal=causal, q_offset=offset)

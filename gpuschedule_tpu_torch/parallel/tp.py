"""Tensor parallelism: the partition table, the tp collectives and the
vocab-parallel loss, and the global token layout the MoE routes over.

The JAX package writes none of this: it annotates parameters with
``param_partition_spec`` (``gpuschedule_tpu/parallel/train.py:68-108``) and
GSPMD inserts the collectives.  Here each rank holds its shard and the
model calls the collectives itself, Megatron's way:

- *f* (:meth:`Tp.copy`): identity forward, all-reduce over tp backward.
  Every replicated tensor that feeds a tp-sharded op passes through it, so
  the gradient that flows back into replicated computation is the sum of
  every rank's part, and the replicated parameters' gradients agree
  across the tp ranks.
- *g* (:meth:`Tp.reduce`): all-reduce over tp forward, identity backward.
  It sums the partial outputs of a row-parallel product (attention's
  ``out``, the MLP's ``down``, the vocab-split embedding, the MoE's local
  experts).

Only all-reduces are used, so gloo runs the same code as NCCL, on CUDA
tensors too (staged through host memory).  A mesh of one rank, or
tp = 1, makes both identities (:data:`NO_TP`).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def flax_path(name: str) -> list:
    """The flax parameter path of a port ``state_dict`` name: the LM's
    ``blocks.{i}`` are flax's ``block{i}`` (``blocks.0.attn.query.kernel``
    is ``block0/attn/query/kernel``)."""
    return re.sub(r"^blocks\.(\d+)\.", r"block\1.", name).split(".")


def param_partition_spec(name: str, ndim: int) -> Optional[int]:
    """The dim of parameter ``name`` (a ``state_dict`` name, ``ndim`` dims)
    that splits over tp, or None where it is replicated: the JAX rule
    (``gpuschedule_tpu/parallel/train.py:68-108``) on the flax path.

    Column splits: q/k/v kernels over heads, ``up`` over d_ff (with its
    bias), ``lm_head`` over vocab; row splits: attention ``out`` and
    ``down`` over their input; ``embed`` over vocab; the MoE's expert
    weights and biases over the expert dim.  Everything else, the q/k/v,
    ``out``, ``down`` and ``lm_head`` biases among it, is replicated."""
    names = flax_path(name)
    if "moe" in names:
        # ep-over-tp: the expert dim; the router stays replicated
        return 0 if any(n in names for n in ("w_up", "w_down", "b_up", "b_down")) else None
    if "embed" in names and "embedding" in names:
        return 0
    if "kernel" in names:
        if any(n in names for n in ("query", "key", "value")):
            return 1
        if "out" in names and "attn" in names:
            return 0
        if "up" in names:
            return ndim - 1
        if "down" in names:
            return 0
        if "lm_head" in names:
            return ndim - 1
    if "bias" in names and "up" in names:
        return 0
    return None


class _Copy(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


@dataclass(frozen=True)
class Tp:
    """This rank's place on the mesh's tp axis: ``size`` ranks, this one
    ``rank``, their process ``group`` (None for one rank)."""

    size: int = 1
    rank: int = 0
    group: Optional[object] = None

    def part(self, n: int) -> Tuple[int, int]:
        """(start, length) of this rank's share of ``n`` entries."""
        if n % self.size:
            raise ValueError(f"{n} not divisible by tp={self.size}")
        m = n // self.size
        return self.rank * m, m

    def shard(self, full: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """This rank's slice of ``full`` along ``dim`` (all of it for None)."""
        if dim is None or self.size == 1:
            return full
        return full.narrow(dim, *self.part(full.shape[dim]))

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """f: ``x`` forward, the gradient summed over tp backward."""
        return x if self.size == 1 else _Copy.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """g: ``x`` summed over tp forward, the gradient as it is backward."""
        return x if self.size == 1 else _Reduce.apply(x, self.group)

    def gather(self, local: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """The whole tensor of which ``local`` is this rank's slice along
        ``dim``: each rank's slice placed in zeros, summed over tp (an
        all-reduce, which gloo takes on CUDA tensors; an all-gather it
        does not).  No autograd."""
        if dim is None or self.size == 1:
            return local
        shape = list(local.shape)
        shape[dim] *= self.size
        full = torch.zeros(shape, dtype=local.dtype, device=local.device)
        full.narrow(dim, *self.part(shape[dim])).copy_(local)
        dist.all_reduce(full, group=self.group)
        return full


NO_TP = Tp()


def vocab_parallel_loss(logits: torch.Tensor, labels: torch.Tensor, tp: Tp) -> torch.Tensor:
    """The summed next-token cross-entropy of ``labels`` (N,) over logits
    (N, V/tp) that hold this rank's vocab slice, with no gather of the
    (N, V) logits: three all-reduces over tp, of the row max (detached,
    its gradient cancels), of the sum of exps (g) and of the label's
    logit, which the rank holding it contributes (g).  Every tp rank gets
    the whole loss."""
    v_local = logits.shape[-1]
    v0, _ = tp.part(v_local * tp.size)
    m = logits.detach().amax(dim=-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=tp.group)
    z = logits - m[:, None]
    sum_exp = tp.reduce(z.exp().sum(dim=-1))
    local = labels - v0
    inside = (local >= 0) & (local < v_local)
    z_label = z.gather(1, local.clamp(0, v_local - 1)[:, None]).squeeze(1) * inside
    return (sum_exp.log() - tp.reduce(z_label)).sum()


@dataclass(frozen=True)
class TokenLayout:
    """Where this rank's tokens sit in the global batch, for an MoE that
    routes the global batch as the JAX module does under GSPMD: capacity
    from the global token count, the choice-major slot scan over the
    global order (rows, then positions), the aux's means global.

    The rank holds rows ``[row0, row0 + rows)`` and sequence chunk
    ``chunk`` of ``chunks`` (one when the sequence is not split).
    ``writes`` is False on the sp ranks that hold a replica of another's
    tokens (sp without a split sequence); ``replicas`` counts those
    copies.  ``group`` holds every rank with this rank's tp coordinate
    (its dp x sp ranks)."""

    batch: int
    row0: int
    chunk: int
    chunks: int
    writes: bool
    replicas: int
    group: Optional[object]

    def tokens(self, seq: int) -> int:
        """The global token count T of a batch whose rank-local sequence
        length is ``seq``."""
        return self.batch * self.chunks * seq

    def offsets(self, counts: torch.Tensor):
        """(before, total) of this rank's per-row counts ``counts``
        (rows, k, E) of each choice rank's picks of each expert: the picks
        of every row chunk ahead of each of this rank's in the global
        order, (rows, k, E), and the global total, (k, E).  One all-reduce
        of a zero-padded (batch, chunks, k, E) buffer; the f32 counts are
        integers, so the sums are exact."""
        rows = counts.shape[0]
        buf = counts.new_zeros((self.batch, self.chunks) + tuple(counts.shape[1:]))
        if self.writes:
            buf[self.row0:self.row0 + rows, self.chunk] = counts
        if self.group is not None:
            dist.all_reduce(buf, group=self.group)
        flat = buf.flatten(0, 1)
        before = (flat.cumsum(dim=0) - flat).view_as(buf)
        return before[self.row0:self.row0 + rows, self.chunk], flat.sum(dim=0)

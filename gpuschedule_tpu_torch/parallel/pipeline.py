"""GPipe pipeline parallelism over the mesh's pp axis: :class:`PipelinedLM`.

Counterpart of ``gpuschedule_tpu/parallel/pipeline.py``
(``stack_stage_params``, ``pipeline_apply``, ``PipelinedLM``).  There the
pipeline is one ``shard_map`` program: microbatches flow stage to stage by
``ppermute`` inside a ``lax.scan`` of ``M + S - 1`` ticks (M microbatches,
S stages), and ``jax.grad`` differentiates through it, the reverse permute
being ``ppermute``'s transpose.  Here one rank of a (pp, dp) mesh is one
process, and the schedule is written out:

1. forward: at tick t stage s runs microbatch ``t - s`` (when
   ``0 <= t - s < M``) through its ``n_layers / pp`` blocks, stage 0 on
   the embedding's rows, the others on what the previous stage sent at
   the end of tick t - 1; then every stage sends its output to the next;
2. the last stage runs the head and the loss on all M outputs, and the
   loss's backward gives each output's gradient;
3. backward, the ticks in reverse: at reverse tick r stage s runs the
   backward of microbatch ``r - s`` on the gradient that stage s + 1 sent
   at the end of reverse tick r + 1 (the last stage: the head's), and
   sends its input's gradient back to stage s - 1; stage 0's input
   gradients flow into the embedding last.

A bubble tick (no microbatch at that stage) runs no stage, so it adds
nothing to the MoE aux: the reference's mask of the bubble ticks.
``schedule="gpipe"`` keeps every microbatch's stage graph from the
forward to its backward; ``"remat"`` runs the forward without a graph,
keeps only each microbatch's boundary input, and recomputes the stage
from it in the backward (the reference's ``jax.checkpoint`` of a tick).
The two give the same numbers to the bit.

*Layout.*  Rank (s, c) holds stage s's blocks and, replicated over pp as
in the reference, the embedding (token and position) and the head
(``ln_f`` and ``lm_head``).  Stage 0 runs the embedding and the last stage
the head; their gradients are summed over pp once the backward is done
(zeros elsewhere), so every rank makes the sequential model's update, and
each block's gradient is summed over the stage's dp ranks (the mesh's
data group).  The global-norm clip sums the blocks' squares over pp and
counts the embedding and head once.  The dp column c of microbatch i is
its rows ``[c·mb/dp, (c+1)·mb/dp)``, as the reference's ``P(None, "dp")``
shards the microbatch dim: a rank's batch is those rows of every
microbatch (:attr:`PipelinedLM.batch_sharding`).

*MoE.*  A stage's MoE block routes the tokens it sees, one microbatch's
dp share, with their own capacity, as the reference's blocks do inside
``shard_map``; the aux is the mean over microbatches and dp columns of
each one's sum over the stages' blocks.  So a pipelined MoE loss equals
:meth:`PipelinedLM.reference_loss` with ``per_microbatch=True``; the plain
sequential loss only at M = 1 and dp = 1, as the reference says of its own.

*Exchange.*  A boundary send is an all-reduce over the stage line (the
mesh's pp group: the ranks of one dp column along pp) of a zero-padded
buffer with a slot for each boundary: a sender writes its slot, every
other slot is zeros, and the receiver reads its own.  gloo's send and
recv take CPU tensors only, and it takes an all-reduce of CUDA tensors
(staged through host memory), so the same exchange runs under gloo on the
CPU, under gloo across ranks time-sliced on one card, and under NCCL.
For pp = 2 the buffer is one activation.

On the card the pipeline's step runs eagerly (no CUDA graph), over gloo
and NCCL alike.
"""

from __future__ import annotations

import re
from functools import partial
from typing import Dict, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from gpuschedule_tpu_torch.data.loader import BatchSharding, synthetic_lm_batches
from gpuschedule_tpu_torch.models.config import CnnConfig
from gpuschedule_tpu_torch.models.transformer import BF16, build_model, model_config
from gpuschedule_tpu_torch.parallel.mesh import Mesh
from gpuschedule_tpu_torch.parallel.tp import Tp
from gpuschedule_tpu_torch.parallel.train import (
    ShardedTrainer,
    TrainState,
    _all_reduce_grads,
    make_optimizer,
    traced_step,
)

__all__ = ["PipelinedLM", "SCHEDULES", "stack_stage_params", "whole_names"]

SCHEDULES = ("gpipe", "remat")
BOUNDARY = ("embed.", "pos_embed", "ln_f.", "lm_head.")  # replicated over pp


def stack_stage_params(stages: Sequence[Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Per-stage ``state_dict``s of the blocks stacked on a new leading
    (stage) dim: the reference's layout of ``stages``, which it shards
    over pp."""
    return {name: torch.stack([st[name] for st in stages]) for name in stages[0]}


def whole_names(sd: Mapping[str, torch.Tensor], first_layer: int) -> Dict[str, torch.Tensor]:
    """``sd`` with each ``blocks.{i}.`` (after any prefix, such as
    ``model.`` or ``optimizer.``) renamed ``blocks.{first_layer + i}.``:
    a stage's names in the whole model's."""
    if not first_layer:
        return dict(sd)
    shift = partial(re.sub, r"(^|\.)blocks\.(\d+)\.",
                    lambda m: f"{m[1]}blocks.{int(m[2]) + first_layer}.")
    return {shift(name): t for name, t in sd.items()}


class _StageLine:
    """This rank's column along pp: the boundary sends to the next stage
    and back, as all-reduces of zero-padded buffers over the pp group."""

    def __init__(self, mesh: Mesh):
        self.size, self.stage = mesh.shape["pp"], mesh.coordinate("pp")
        self.group = mesh.group("pp")

    def send(self, x: Optional[torch.Tensor], like: torch.Tensor,
             forward: bool) -> Optional[torch.Tensor]:
        """Every stage's ``x`` (None: nothing to send) to the next stage
        (``forward``) or to the previous one; returns what reaches this
        rank (None at the line's end).  Slot j carries the boundary
        between stages j and j + 1; every stage of the line calls it."""
        buf = like.new_zeros((self.size - 1,) + tuple(like.shape))
        if x is not None:
            buf[self.stage if forward else self.stage - 1] = x
        dist.all_reduce(buf, group=self.group)
        slot = self.stage - 1 if forward else self.stage
        return buf[slot] if 0 <= slot < self.size - 1 else None


class PipelinedLM:
    """A trainable LM with its blocks pipelined over the mesh's pp axis.

    The same surface as :class:`ShardedTrainer` (``init``, ``make_batch``,
    ``step``, ``batch_sharding``, ``is_image``), so the train CLI and the
    profiler drive either.  ``mesh`` is a (pp, dp) mesh with pp >= 2;
    ``batch_size`` and ``seq_len`` are global, ``num_microbatches`` is M.
    ``flash_attn`` puts the CUDA flash kernels in every block of every
    stage; ``cfg.remat`` recomputes each block in the backward, as in the
    one-rank model.  The loss is the mean cross-entropy plus
    ``moe_aux_weight`` times the MoE aux (module docstring)."""

    is_image = False

    def __init__(
        self,
        model_name: str,
        mesh: Mesh,
        *,
        batch_size: int,
        seq_len: int,
        num_microbatches: int = 4,
        learning_rate: float = 1e-3,
        flash_attn: bool = False,
        moe_aux_weight: float = 1e-2,
        warmup_steps: int = 0,
        decay_steps: Optional[int] = None,
        grad_clip: Optional[float] = None,
        schedule: str = "gpipe",
    ):
        attn_fn = None
        if flash_attn:
            from gpuschedule_tpu_torch.ops import flash_attention

            attn_fn = partial(flash_attention, causal=True)
        cfg = model_config(model_name)
        if isinstance(cfg, CnnConfig):
            raise ValueError(f"{model_name!r} is a CNN config; the pipeline stages an LM's blocks")
        pp, dp = mesh.shape["pp"], mesh.shape["dp"]
        # the reference's checks, in its order (the constructor's, then
        # pipeline_apply's, which it makes on the first step)
        if pp < 2:
            raise ValueError(f"PipelinedLM needs a pp>=2 mesh, got pp={pp}")
        if cfg.n_layers % pp:
            raise ValueError(f"{model_name} has {cfg.n_layers} layers, not divisible by pp={pp}")
        if batch_size % num_microbatches:
            raise ValueError(
                f"batch {batch_size} not divisible by {num_microbatches} microbatches")
        if schedule not in SCHEDULES:
            raise ValueError(f"schedule must be 'gpipe' or 'remat', got {schedule!r}")
        extra = {name: size for name, size in mesh.shape.items()
                 if name not in ("pp", "dp") and size > 1}
        if extra:
            raise ValueError(f"pipeline_apply supports (pp, dp) meshes only; got extra axes {extra}")
        mb = batch_size // num_microbatches
        if mb % dp:
            raise ValueError(f"microbatch size {mb} not divisible by dp={dp}")
        if seq_len > cfg.max_seq:
            raise ValueError(f"seq_len {seq_len} > model max_seq {cfg.max_seq}")
        self.model_name = model_name
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device
        self.attn_fn = attn_fn
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.num_microbatches = num_microbatches
        self.schedule = schedule
        self.learning_rate = learning_rate
        self.moe_aux_weight = moe_aux_weight
        self.opt_kwargs = dict(warmup_steps=warmup_steps, decay_steps=decay_steps,
                               grad_clip=grad_clip)
        self.pp, self.dp = pp, dp
        self.stage = mesh.coordinate("pp")
        self.layers_per_stage = cfg.n_layers // pp
        self.first_layer = self.stage * self.layers_per_stage
        self.rows = mb // dp  # a rank's rows of each microbatch
        self.line = _StageLine(mesh)
        self.batch_sharding = BatchSharding(self.device, mesh.coordinate("dp") * self.rows,
                                            self.rows, 0, seq_len, blocks=num_microbatches)

    # ------------------------------------------------------------------ #

    def init(self, seed: int = 0) -> TrainState:
        """This rank's part of the model a one-rank trainer draws from a
        generator seeded with ``seed``: the embedding, the head and the
        stage's blocks; the adamw whose clip sums the blocks over pp."""
        with self.device:
            model, _ = build_model(self.model_name, attn_fn=self.attn_fn)
        model.reset_parameters(torch.Generator(device=self.device).manual_seed(seed))
        lo = self.first_layer
        model.blocks = nn.ModuleList(list(model.blocks)[lo:lo + self.layers_per_stage])
        blocks = [p for name, p in model.named_parameters() if name.startswith("blocks.")]
        stages = Tp(self.pp, self.stage, self.line.group)
        opt = make_optimizer(model.parameters(), self.learning_rate, tp=stages, sharded=blocks,
                             **self.opt_kwargs)
        return TrainState(model, opt, self.mesh, first_layer=lo)

    def make_batch(self, seed: int = 0) -> torch.Tensor:
        """This rank's rows of a random global (batch, seq) token batch
        (:func:`synthetic_lm_batches`), on the device."""
        tokens = next(synthetic_lm_batches(batch_size=self.batch_size, seq_len=self.seq_len,
                                           vocab=self.cfg.vocab, num_batches=1, seed=seed))
        return self.to_device(tokens)

    def to_device(self, batch) -> torch.Tensor:
        """This rank's rows of a global token batch (:attr:`batch_sharding`):
        its dp share of each microbatch, microbatch after microbatch."""
        return self.batch_sharding.to_device(batch)

    def step(self, state: TrainState, batch: torch.Tensor):
        """One pipelined optimizer step on this rank's rows; returns
        ``(state, loss)``, the global loss on every rank."""
        return traced_step(self._step, state, batch, self.batch_size * self.seq_len)

    def _step(self, state: TrainState, tokens: torch.Tensor):
        state.optimizer.zero_grad()
        loss = self.loss_and_grads(state, tokens)
        state.optimizer.step()
        return state, loss

    def loss_and_grads(self, state: TrainState, tokens: torch.Tensor) -> torch.Tensor:
        """The step's loss on this rank's rows, and its gradients added to
        each parameter's ``.grad``: the blocks' summed over the stage's dp
        ranks, the embedding's and the head's over every rank, so each
        rank holds the sequential model's gradients of what it holds.  The
        global loss, on every rank."""
        model = state.model
        loss = self._forward_backward(model, tokens)
        if self.dp > 1:
            _all_reduce_grads(model.parameters(), self.mesh.data_group)
        _all_reduce_grads([p for name, p in model.named_parameters()
                           if name.startswith(BOUNDARY)], self.line.group)
        # the rank's share: the head's cross-entropy on the last stage, the
        # stage's aux everywhere; summed over the stage's dp ranks, then pp
        if self.dp > 1:
            dist.all_reduce(loss, group=self.mesh.data_group)
        dist.all_reduce(loss, group=self.line.group)
        return loss

    def _run_stage(self, model, x):
        """(y, the stage's aux or None): ``x`` through the stage's blocks."""
        y, aux = model.run_blocks(x)
        return y, (sum(aux) if aux else None)

    def _forward_backward(self, model, tokens: torch.Tensor) -> torch.Tensor:
        """The schedule of the module docstring on this rank's rows; the
        parameters' gradients accumulate, and this rank's share of the
        loss is returned (detached)."""
        m, s, last = self.num_microbatches, self.stage, self.stage == self.pp - 1
        ticks = m + self.pp - 1
        rows, n = self.rows, tokens.shape[1]
        like = torch.zeros((rows, n, self.cfg.d_model), dtype=BF16, device=tokens.device)
        aux_weight = self.moe_aux_weight / (m * self.dp)
        gpipe = self.schedule == "gpipe"
        if s == 0:
            embedded = model.embed_tokens(tokens)
            inputs_of = embedded.detach().requires_grad_(True)
        inputs: List[Optional[torch.Tensor]] = [None] * m
        outputs: List[Optional[torch.Tensor]] = [None] * m
        auxes: List[Optional[torch.Tensor]] = [None] * m
        received = None
        for t in range(ticks):
            i, out = t - s, None
            if 0 <= i < m:
                x = (inputs_of[i * rows:(i + 1) * rows] if s == 0
                     else received.detach().requires_grad_(True))
                with torch.set_grad_enabled(gpipe):
                    y, aux = self._run_stage(model, x)
                inputs[i], outputs[i], auxes[i] = x, y, aux
                out = None if last else y.detach()
            if t < ticks - 1:
                received = self.line.send(out, like, forward=True)
        share = sum(a.detach().float() for a in auxes if a is not None) * aux_weight
        if not isinstance(share, torch.Tensor):
            share = torch.zeros((), device=tokens.device)
        if last:
            ys = [y.detach().requires_grad_(True) for y in outputs]
            logits = model.head(torch.cat(ys))
            count = self.batch_size * (n - 1)
            ce = ShardedTrainer.loss(logits, tokens, count)
            ce.backward()
            out_grads = [y.grad for y in ys]
            share = share + ce.detach()
        received = None
        for r in reversed(range(ticks)):
            i, back = r - s, None
            if 0 <= i < m:
                if gpipe:
                    y, aux = outputs[i], auxes[i]
                else:
                    y, aux = self._run_stage(model, inputs[i])
                g = out_grads[i] if last else received
                heads, grads = [y], [g]
                if aux is not None:
                    heads.append(aux)
                    grads.append(torch.full_like(aux, aux_weight))
                torch.autograd.backward(heads, grads)
                outputs[i] = auxes[i] = None  # free the microbatch's graph
                back = inputs[i].grad if s > 0 else None
            if r > 0:
                received = self.line.send(back, like, forward=False)
        if s == 0:
            embedded.backward(inputs_of.grad)
        return share

    # ------------------------------------------------------------------ #

    def reference_loss(self, model: nn.Module, tokens: torch.Tensor, *,
                       per_microbatch: bool = False) -> torch.Tensor:
        """The loss with the blocks applied in sequence, no pipeline, by the
        whole one-rank ``model`` (a ``TransformerLM`` holding every stage's
        blocks) on the global ``tokens``: the parity oracle.  Exact for
        dense blocks; for MoE blocks, which route the tokens they see, the
        pipelined loss is this with ``per_microbatch``: the blocks run on
        each (microbatch, dp column) share apart and the aux is the mean of
        the shares'."""
        b, n = tokens.shape
        x = model.embed_tokens(tokens)
        if not per_microbatch:
            x, aux = model.run_blocks(x)
            aux = sum(aux) if aux else 0.0
        else:
            shares = x.split(self.rows)  # microbatch-major, then dp column
            outs, auxes = zip(*(model.run_blocks(share) for share in shares))
            x = torch.cat(outs)
            aux = sum(sum(a) for a in auxes if a) / len(shares) if auxes[0] else 0.0
        loss = ShardedTrainer.loss(model.head(x), tokens, b * (n - 1))
        return loss + self.moe_aux_weight * aux

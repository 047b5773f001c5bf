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

*On the card* each rank's stage compute is captured in CUDA graphs, as the
JAX pipelined step is one ``jit`` program, while the tick loop and the
stage-line exchanges stay eager between the graphs, so the same capture
holds over gloo and over NCCL (:class:`_CapturedStage`).  A step's first
call for a state and a batch shape runs eagerly on a side stream (it builds
the kernels), the second captures a graph for each microbatch's stage
forward and one for its backward (under ``remat``: the recompute and the
backward in one graph), replaying each as it is captured, and every later
call replays them.  The graphs share one memory pool and are captured in
the schedule's order, the forwards in order and the backwards in reverse;
replays keep that order, so a backward's graph may reuse what an earlier
backward freed, and gpipe's M microbatches keep M graphs' activations
alive at once, as the eager step does.  ``torch.cuda.make_graphed_callables``
does not serve here: given the stage module M times it rebinds the module's
``forward`` M times, so only the last graph is called; given a function
with the parameters among its arguments it runs three untimed forward and
backward passes of every microbatch as its warm-up, records no launches
apart for each graph, and has no form for remat's recompute-and-backward
graph.  On the CPU the step runs eagerly.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from gpuschedule_tpu_torch.data.loader import BatchSharding, synthetic_lm_batches
from gpuschedule_tpu_torch.models.config import CnnConfig
from gpuschedule_tpu_torch.models.transformer import BF16, build_model, model_config
from gpuschedule_tpu_torch.ops import launches
from gpuschedule_tpu_torch.parallel.mesh import Mesh
from gpuschedule_tpu_torch.parallel.tp import Tp
from gpuschedule_tpu_torch.parallel.train import (
    ShardedTrainer,
    TrainState,
    _all_reduce_grads,
    make_optimizer,
    on_side_stream,
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


class _EagerStage:
    """A rank's stage compute as plain PyTorch calls, one launch at a time:
    on the CPU, in the card's warm-up step and in
    :meth:`PipelinedLM.loss_and_grads`.  ``run(x) -> (y, aux)`` is the
    stage; ``gpipe`` keeps each microbatch's graph from its forward to its
    backward, else (remat) the backward recomputes it from the input."""

    def __init__(self, run: Callable, gpipe: bool, aux_weight: float):
        self.run, self.gpipe, self.aux_weight = run, gpipe, aux_weight
        self.kept: Dict[int, tuple] = {}

    def begin(self) -> None:
        """Before a step's first tick."""

    def forward(self, i: int, x: torch.Tensor):
        """(y, aux) of the stage on microbatch ``i``'s input ``x``."""
        x = x.detach().requires_grad_(True)
        with torch.set_grad_enabled(self.gpipe):
            y, aux = self.run(x)
        self.kept[i] = (x, y, aux)
        return y, aux

    def backward(self, i: int, g: torch.Tensor) -> torch.Tensor:
        """The gradient of microbatch ``i``'s stage input from ``g``, its
        output's, and the aux's weight; the parameters' gradients add to
        their ``.grad``."""
        x, y, aux = self.kept.pop(i)
        if not self.gpipe:
            y, aux = self.run(x)
        heads, grads = [y], [g]
        if aux is not None:
            heads.append(aux)
            grads.append(torch.full_like(aux, self.aux_weight))
        torch.autograd.backward(heads, grads)
        return x.grad

    def end(self) -> None:
        """After a step's last tick."""


@dataclass
class _Graph:
    """A captured graph, the launches of our kernels its capture recorded,
    and its static outputs."""

    graph: "torch.cuda.CUDAGraph"
    recorded: launches.Recorded
    out: object

    def replay(self):
        self.graph.replay()
        launches.replayed(self.recorded)
        return self.out


class _CapturedStage:
    """A rank's stage compute on the card as CUDA graphs (module docstring):
    for each microbatch i a graph of the stage forward on a static input,
    and one of the backward from a static output gradient: the input's
    gradient, and the parameters' added into one static gradient each
    (``grads``, zeroed in :meth:`begin`, handed to the parameters in
    :meth:`end`).  A graph is captured at its first call and replayed at
    once; a capture that fails raises.  ``params`` are the stage's block
    parameters, ``m`` the microbatches."""

    def __init__(self, run: Callable, gpipe: bool, aux_weight: float,
                 params: Sequence[torch.nn.Parameter], m: int):
        self.run, self.gpipe, self.aux_weight = run, gpipe, aux_weight
        self.params = list(params)
        self.grads = [torch.zeros_like(p) for p in self.params]
        self.used = [False] * len(self.params)  # a parameter the stage's gradient reaches
        self.pool = torch.cuda.graph_pool_handle()
        self.inputs: List[Optional[torch.Tensor]] = [None] * m
        self.out_grads: List[Optional[torch.Tensor]] = [None] * m
        self.fwd: List[Optional[_Graph]] = [None] * m
        self.bwd: List[Optional[_Graph]] = [None] * m

    def _capture(self, body: Callable) -> _Graph:
        """Capture ``body()`` into a graph of the pool.  Nothing runs while
        a graph is captured, so the launches the wrappers count meanwhile
        become the graph's own, counted on its replays."""
        graph = torch.cuda.CUDAGraph()
        with launches.recording() as recorded, torch.cuda.graph(graph, pool=self.pool):
            out = body()
        return _Graph(graph, recorded, out)

    def begin(self) -> None:
        torch._foreach_zero_(self.grads)

    def forward(self, i: int, x: torch.Tensor):
        first = self.fwd[i] is None
        if first:
            self.inputs[i] = torch.empty_like(x).requires_grad_(True)
        # before the capture: the backward's capture checks that nothing
        # wrote to a tensor the forward saved since it was captured
        with torch.no_grad():
            self.inputs[i].copy_(x)
        if first:
            def body():
                with torch.set_grad_enabled(self.gpipe):
                    return self.run(self.inputs[i])

            self.fwd[i] = self._capture(body)
        return self.fwd[i].replay()

    def backward(self, i: int, g: torch.Tensor) -> torch.Tensor:
        first = self.bwd[i] is None
        if first:
            self.out_grads[i] = torch.empty_like(g)
        self.out_grads[i].copy_(g)
        if first:
            self.bwd[i] = self._capture_backward(i)
        return self.bwd[i].replay()

    def _capture_backward(self, i: int) -> _Graph:
        x, (y, aux) = self.inputs[i], self.fwd[i].out
        seed = None if aux is None else torch.full_like(aux, self.aux_weight)

        def body():
            if self.gpipe:
                out, a = y, aux
            else:  # remat: the recompute in the backward's graph
                with torch.enable_grad():
                    out, a = self.run(x)
            ys, seeds = [out], [self.out_grads[i]]
            if a is not None:
                ys.append(a)
                seeds.append(seed)
            grads = torch.autograd.grad(ys, [x] + self.params, seeds, allow_unused=True)
            pairs = [(acc, gr) for acc, gr in zip(self.grads, grads[1:]) if gr is not None]
            torch._foreach_add_([acc for acc, _ in pairs], [gr for _, gr in pairs])
            self.used = [u or gr is not None for u, gr in zip(self.used, grads[1:])]
            return grads[0]

        return self._capture(body)

    def end(self) -> None:
        for p, acc, used in zip(self.params, self.grads, self.used):
            p.grad = acc if used else None


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
        self.aux_weight = moe_aux_weight / (num_microbatches * dp)  # a microbatch's aux seed
        # the card captures the stage compute (module docstring); the state
        # its graphs belong to, and its stage graphs by batch key (None:
        # warmed up, not captured yet)
        self.capturable = self.device.type == "cuda"
        self._graph_state: Optional[TrainState] = None
        self._graphs: Dict[tuple, Optional[_CapturedStage]] = {}

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
        ``(state, loss)``, the global loss on every rank.  On the card the
        stage compute is captured (module docstring): the first call for a
        state and a batch shape runs eagerly on a side stream, the second
        captures the stage graphs, later calls replay them; a new state or
        batch shape captures anew.  Time a step only after 2 calls."""
        return traced_step(self._step, state, batch, self.batch_size * self.seq_len)

    def _step(self, state: TrainState, tokens: torch.Tensor):
        """:meth:`step` untraced."""
        if not self.capturable:
            return self._eager_step(state, tokens)
        if state is not self._graph_state:
            self._graphs.clear()
            self._graph_state = state
        key = (tuple(tokens.shape), tokens.dtype)
        if key not in self._graphs:
            self._graphs[key] = None
            return on_side_stream(self.device, self._eager_step, state, tokens)
        if self._graphs[key] is None:
            blocks = [p for name, p in state.model.named_parameters()
                      if name.startswith("blocks.")]
            self._graphs[key] = _CapturedStage(partial(self._run_stage, state.model),
                                               self.schedule == "gpipe", self.aux_weight,
                                               blocks, self.num_microbatches)
        return self._update(state, tokens, self._graphs[key])

    def _eager_step(self, state: TrainState, tokens: torch.Tensor):
        """The step with the stage compute run eagerly, one launch at a time."""
        return self._update(state, tokens, self._eager_stage(state.model))

    def _eager_stage(self, model: nn.Module) -> _EagerStage:
        return _EagerStage(partial(self._run_stage, model), self.schedule == "gpipe",
                           self.aux_weight)

    def _update(self, state: TrainState, tokens: torch.Tensor, stage):
        state.optimizer.zero_grad()
        loss = self._loss_and_grads(state, tokens, stage)
        state.optimizer.step()
        return state, loss

    def loss_and_grads(self, state: TrainState, tokens: torch.Tensor) -> torch.Tensor:
        """The step's loss on this rank's rows, and its gradients added to
        each parameter's ``.grad``: the blocks' summed over the stage's dp
        ranks, the embedding's and the head's over every rank, so each
        rank holds the sequential model's gradients of what it holds.  The
        global loss, on every rank.  The stage compute runs eagerly."""
        return self._loss_and_grads(state, tokens, self._eager_stage(state.model))

    def _loss_and_grads(self, state: TrainState, tokens: torch.Tensor, stage) -> torch.Tensor:
        model = state.model
        loss = self._forward_backward(model, tokens, stage)
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

    def _forward_backward(self, model, tokens: torch.Tensor, stage) -> torch.Tensor:
        """The schedule of the module docstring on this rank's rows, the
        stage compute by ``stage`` (:class:`_EagerStage` or
        :class:`_CapturedStage`); the parameters' gradients accumulate, and
        this rank's share of the loss is returned (detached)."""
        m, s, last = self.num_microbatches, self.stage, self.stage == self.pp - 1
        ticks = m + self.pp - 1
        rows, n = self.rows, tokens.shape[1]
        like = torch.zeros((rows, n, self.cfg.d_model), dtype=BF16, device=tokens.device)
        stage.begin()
        if s == 0:
            embedded = model.embed_tokens(tokens)
        outputs: List[Optional[torch.Tensor]] = [None] * m
        auxes: List[Optional[torch.Tensor]] = [None] * m
        received = None
        for t in range(ticks):
            i, out = t - s, None
            if 0 <= i < m:
                x = embedded[i * rows:(i + 1) * rows] if s == 0 else received
                outputs[i], auxes[i] = stage.forward(i, x)
                out = None if last else outputs[i].detach()
            if t < ticks - 1:
                received = self.line.send(out, like, forward=True)
        share = sum(a.detach().float() for a in auxes if a is not None) * self.aux_weight
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
        input_grads: List[Optional[torch.Tensor]] = [None] * m  # stage 0's
        for r in reversed(range(ticks)):
            i, back = r - s, None
            if 0 <= i < m:
                dx = stage.backward(i, out_grads[i] if last else received)
                outputs[i] = auxes[i] = None
                if s == 0:
                    input_grads[i] = dx
                else:
                    back = dx
            if r > 0:
                received = self.line.send(back, like, forward=False)
        stage.end()
        if s == 0:
            embedded.backward(torch.cat(input_grads))
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

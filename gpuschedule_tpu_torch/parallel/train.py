"""The train step: the framework's unit of measured work, over a dp x sp x tp mesh.

Counterpart of ``gpuschedule_tpu/parallel/train.py`` (``make_optimizer`` and
``ShardedTrainer``).  The JAX trainer shards one jitted step over a mesh
with named shardings; this one runs one rank of a :class:`Mesh` a process.

- **dp**: each rank takes its rows of the global batch.
- **sp**: with ``seq_shard`` (which ``ring_attn`` needs) each rank takes its
  chunk of the sequence.  The ring (``ring_attention``, or
  ``ring_flash_attention`` with ``flash_attn``) attends across the chunks;
  without ``ring_attn`` the dense core attends over the sequence gathered
  over sp (:func:`~gpuschedule_tpu_torch.parallel.gathered.gathered_attention`),
  as the JAX trainer's GSPMD does.
- **tp**: the model splits over the tp ranks by the JAX partition table
  (:func:`~gpuschedule_tpu_torch.parallel.tp.param_partition_spec`):
  megatron's column and row splits with the collectives of
  :mod:`.tp`, the attention core (the flash kernels, or a ring) on the
  rank's H/tp heads, the logits the rank's slice of the vocab and the
  loss vocab-parallel, the MoE's experts split over tp (ep-over-tp).
- The loss is the rank's sum over the global count B·(S − 1) and the
  gradients are summed over the mesh's data group, the dp x sp ranks of
  this rank's tp coordinate (``all_reduce``): together the JAX step's mean
  and psum.  The global-norm clip sums the split parameters' squares over
  tp and counts each replicated parameter once.
- **pp** is the pipeline's own trainer,
  :class:`~gpuschedule_tpu_torch.parallel.pipeline.PipelinedLM`, as in the
  JAX package; this one takes meshes with pp = 1.

The three model families of the zoo train here: the dense LM; the MoE LM,
whose blocks' aux losses are charged at ``moe_aux_weight`` and which over
several ranks routes the global batch, as the JAX module does under GSPMD
(:class:`~gpuschedule_tpu_torch.parallel.tp.TokenLayout`); and the CNN,
whose batch is an ``(images, labels)`` pair and whose loss is the softmax
cross-entropy over integer labels (its tp ranks hold replicas: the table
splits none of its parameters).

On the card the step is one captured program, as the JAX step is one
``jit`` program: forward, backward, the data group's gradient and loss
all-reduces, clip and adamw replay as one CUDA graph
(:meth:`ShardedTrainer.step`), on one rank and over a mesh whose groups
are NCCL's.  On the CPU, and over gloo groups (which a graph cannot hold),
it runs eagerly.

Optimizer parity with optax (read from the installed optax 0.2.6):
``optax.adamw`` decays every parameter with ``weight_decay=1e-4`` (torch's
default is 1e-2); ``decay_steps`` counts after the warmup; the global-norm
clip comes before adam, as ``optax.clip_by_global_norm`` computes it.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, Iterable, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F

from gpuschedule_tpu_torch.data.loader import BatchSharding, synthetic_lm_batches
from gpuschedule_tpu_torch.models.config import CnnConfig
from gpuschedule_tpu_torch.models.transformer import build_model, model_config
from gpuschedule_tpu_torch.obs.tracer import get_tracer
from gpuschedule_tpu_torch.ops import launches
from gpuschedule_tpu_torch.parallel.mesh import Mesh, make_mesh
from gpuschedule_tpu_torch.parallel.tp import (
    NO_TP,
    TokenLayout,
    Tp,
    param_partition_spec,
    vocab_parallel_loss,
)

ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default


def lr_factor(count: int, *, warmup_steps: int = 0, decay_steps: Optional[int] = None) -> float:
    """The learning-rate multiplier for update number ``count`` (0-based):
    optax's ``warmup_cosine_decay_schedule`` (linear warmup from 0, then a
    cosine to 0 over ``decay_steps``) when ``decay_steps`` is set,
    ``warmup_constant_schedule`` when only ``warmup_steps`` is, else 1."""
    if decay_steps:
        if count < warmup_steps:
            return count / warmup_steps
        t = min(count - warmup_steps, decay_steps)
        return 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
    if warmup_steps:
        return min(count, warmup_steps) / warmup_steps
    return 1.0


def clip_by_global_norm(params: Iterable[torch.nn.Parameter], max_norm: float,
                        tp: Tp = NO_TP, sharded: frozenset = frozenset()) -> torch.Tensor:
    """Scale all gradients by ``max_norm / norm`` when their global norm
    reaches ``max_norm`` (``optax.clip_by_global_norm``).  Returns the norm.
    Over tp the norm is the whole model's: the squares of the split
    parameters (``sharded``, their ids) summed over ``tp``, each
    replicated parameter counted once."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    norms = [torch.linalg.vector_norm(p.grad.float()) for p in params if id(p) not in sharded]
    split = [torch.linalg.vector_norm(p.grad.float()) for p in params if id(p) in sharded]
    if split:
        sq = torch.stack(split).square().sum()
        dist.all_reduce(sq, group=tp.group)
        norms.append(sq.sqrt())
    norm = torch.linalg.vector_norm(torch.stack(norms))
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, factor)
    return norm


@dataclass
class Optimizer:
    """adamw with the optional schedule and clip of ``make_optimizer``."""

    adamw: torch.optim.AdamW
    schedule: torch.optim.lr_scheduler.LambdaLR
    grad_clip: Optional[float]
    scheduled: bool = False  # a warmup or a decay: optax's scale_by_schedule (it has a count)
    tp: Tp = NO_TP
    sharded: frozenset = frozenset()  # ids of the parameters split over tp

    def update(self) -> None:
        """Clip and adamw: the part of :meth:`step` that runs on the device
        alone, so a CUDA graph can hold it."""
        if self.grad_clip is not None:
            params = [p for g in self.adamw.param_groups for p in g["params"]]
            clip_by_global_norm(params, self.grad_clip, self.tp, self.sharded)
        self.adamw.step()

    def step(self) -> None:
        self.update()
        self.schedule.step()

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def count(self) -> int:
        """The updates made so far: adamw's step count (0 before the
        first), what optax keeps as the ``count`` leaves of ``opt_state``.
        One read of the device (a sync on a card): read it at restore,
        never in the step."""
        steps = [s["step"] for s in self.adamw.state.values() if "step" in s]
        return int(torch.stack(steps).max().item()) if steps else 0

    def seek(self, count: int) -> None:
        """Put the schedule at update ``count``: its position
        (``last_epoch``) and the rate it gives there, written into the rate
        the optimizer reads (``fill_`` of the device tensor a capturable
        adamw and its captured graph read)."""
        sched = self.schedule
        sched.last_epoch = count
        rates = [base * fn(count) for base, fn in zip(sched.base_lrs, sched.lr_lambdas)]
        for group, rate in zip(self.adamw.param_groups, rates):
            if isinstance(group["lr"], torch.Tensor):
                group["lr"].fill_(rate)
            else:
                group["lr"] = rate
        sched._last_lr = rates


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    learning_rate: float,
    *,
    warmup_steps: int = 0,
    decay_steps: Optional[int] = None,
    grad_clip: Optional[float] = None,
    capturable: Optional[bool] = None,
    tp: Tp = NO_TP,
    sharded: Iterable[torch.nn.Parameter] = (),
) -> Optimizer:
    """adamw with linear warmup over ``warmup_steps``, cosine decay to zero
    over ``decay_steps`` (counted after warmup) and global-norm clipping at
    ``grad_clip``, all opt-in; the defaults are plain ``optax.adamw``.

    ``capturable`` defaults to whether the parameters are on a CUDA device.
    A capturable optimizer keeps its step count and learning rate on the
    device, so a CUDA graph can replay the update, and is PyTorch's fused
    adamw: one kernel a parameter group and pass over its tensors (the
    capturable multi-tensor form makes extra passes for the bias
    corrections it keeps on the device).  The schedule writes each
    scheduled rate into the rate tensor with ``fill_`` between replays; its
    base rate stays a Python float (``initial_lr``), so computing the next
    rate reads nothing back from the device.  Otherwise the optimizer is
    the multi-tensor adamw with a Python rate, the form the CPU parity
    tests hold against optax.  ``sharded`` are the parameters split over
    ``tp``, which the clip's norm sums over tp."""
    params = list(params)
    if capturable is None:
        capturable = params[0].is_cuda
    adamw = torch.optim.AdamW(
        params,
        lr=torch.tensor(learning_rate, device=params[0].device) if capturable else learning_rate,
        betas=(0.9, 0.999), eps=1e-8, weight_decay=ADAMW_WEIGHT_DECAY,
        capturable=capturable, fused=capturable,
    )
    for group in adamw.param_groups:
        group["initial_lr"] = learning_rate
    sched = torch.optim.lr_scheduler.LambdaLR(
        adamw, partial(lr_factor, warmup_steps=warmup_steps, decay_steps=decay_steps)
    )
    return Optimizer(adamw, sched, grad_clip, scheduled=bool(warmup_steps or decay_steps),
                     tp=tp, sharded=frozenset(id(p) for p in sharded))


def _all_reduce_grads(params: Iterable[torch.nn.Parameter], group) -> None:
    """Sum each of ``params``' gradients over ``group`` in one flat
    all-reduce (a parameter without one counts as zeros)."""
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    offset = 0
    for p, g in zip(params, grads):
        p.grad = flat[offset:offset + g.numel()].view_as(g)
        offset += g.numel()


@dataclass
class TrainState:
    """What the JAX trainer carries as ``(params, opt_state)``, and the mesh
    its shards lie on (None: the whole state on one rank).  A pipeline
    stage's model holds blocks ``first_layer`` on of the whole model's."""

    model: torch.nn.Module
    optimizer: Optimizer
    mesh: Optional[Mesh] = None
    first_layer: int = 0


def traced_step(step_fn, state, batch, n_tokens: int):
    """``step_fn(state, batch)``, recorded as a ``train.step`` span with the
    JAX trainer's attributes when the tracer is on (``GSTPU_TRACE=1``),
    fenced by a readback of the loss; with it off, the step alone."""
    tracer = get_tracer()
    if not tracer.enabled:
        return step_fn(state, batch)
    t0 = time.perf_counter()
    state, loss = step_fn(state, batch)
    loss_val = float(loss)  # fence: the readback makes the wall time real
    dt = time.perf_counter() - t0
    tracer.record(
        "train.step",
        wall_start=t0,
        wall_dur=dt,
        cat="train",
        step_time_s=round(dt, 6),
        tokens=n_tokens,
        tokens_per_s=round(n_tokens / dt, 1) if dt > 0 else None,
        loss=loss_val,
    )
    return state, loss


Batch = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def _tensors(batch: Batch) -> Tuple[torch.Tensor, ...]:
    """A token batch, or an (images, labels) pair, as a tuple of tensors."""
    return tuple(batch) if isinstance(batch, (tuple, list)) else (batch,)


def _clone(batch: Batch) -> Batch:
    """A copy of ``batch`` in its own form: a tensor, or a tuple of them."""
    return tuple(t.clone() for t in batch) if isinstance(batch, (tuple, list)) else batch.clone()


def on_side_stream(device: torch.device, fn, *args):
    """``fn(*args)`` on a new stream of ``device`` that starts after the
    current stream's work and that the current stream then waits for: the
    warm-up PyTorch asks for before code is captured in a CUDA graph."""
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = fn(*args)
    main.wait_stream(side)
    return out


@dataclass
class _Captured:
    """One captured step: the graph, its static batch buffers and loss, and
    the launches of our kernels that its capture recorded."""

    graph: "torch.cuda.CUDAGraph"
    batch: Batch
    loss: torch.Tensor
    recorded: launches.Recorded


class ShardedTrainer:
    """Owns a model and optimizer on this rank's device and exposes one step.

    The same surface as the JAX trainer: construct over a mesh,
    :meth:`init` once, then :meth:`step` per iteration.  ``mesh`` defaults
    to :func:`make_mesh` over the world (one rank: the mesh of size 1 on
    ``device``, the card unless ``device="cpu"``).  ``flash_attn`` puts the
    CUDA flash kernels (:func:`~gpuschedule_tpu_torch.ops.flash_attention`)
    in every block, on the rank's H/tp heads; ``ring_attn`` the sp ring,
    the two together the ring-flash composition.  ``batch_size`` and ``seq_len`` are global
    (``seq_len`` means nothing to a CNN).  ``moe_aux_weight`` weighs the
    MoE blocks' aux losses in the loss, as in the JAX trainer."""

    def __init__(
        self,
        model_name: str,
        mesh: Optional[Mesh] = None,
        *,
        batch_size: int = 8,
        seq_len: int = 128,
        learning_rate: float = 1e-3,
        seq_shard: bool = False,
        ring_attn: bool = False,
        flash_attn: bool = False,
        moe_aux_weight: float = 1e-2,
        warmup_steps: int = 0,
        decay_steps: Optional[int] = None,
        grad_clip: Optional[float] = None,
        device=None,
    ):
        if mesh is None:
            mesh = make_mesh(device=device)
        elif device is not None and torch.device(device).type != mesh.device.type:
            raise ValueError(f"device {device!r} is not the mesh's {mesh.device}")
        if mesh.shape["pp"] > 1:
            raise ValueError(f"pp={mesh.shape['pp']}: a pp mesh trains the staged "
                             "PipelinedLM (parallel/pipeline.py)")
        attn_fn: Optional[Callable] = None
        if ring_attn and flash_attn:
            # the composition: the sp ring across ranks, the flash kernels within
            if not seq_shard:
                raise ValueError("ring_attn requires seq_shard=True")
            from gpuschedule_tpu_torch.parallel.ringflash import ring_flash_attention

            attn_fn = partial(ring_flash_attention, mesh=mesh, causal=True)
        elif ring_attn:
            if not seq_shard:
                raise ValueError("ring_attn requires seq_shard=True")
            from gpuschedule_tpu_torch.parallel.ringattn import ring_attention

            attn_fn = partial(ring_attention, mesh=mesh, causal=True)
        elif flash_attn:
            if seq_shard:
                raise ValueError("flash_attn keeps S per-device; use ring_attn "
                                 "for sequence sharding")
            from gpuschedule_tpu_torch.ops import flash_attention

            attn_fn = partial(flash_attention, causal=True)
        self.mesh = mesh
        self.device = mesh.device
        self.model_name = model_name
        self.attn_fn = attn_fn
        self.moe_aux_weight = moe_aux_weight
        self.cfg = model_config(model_name, attn_fn)
        self.is_image = isinstance(self.cfg, CnnConfig)
        if not self.is_image and seq_len > self.cfg.max_seq:
            raise ValueError(f"seq_len {seq_len} > model max_seq {self.cfg.max_seq}")
        dp, sp = mesh.shape["dp"], mesh.shape["sp"]
        if batch_size % dp != 0:
            raise ValueError(f"batch {batch_size} not divisible by dp={dp}")
        if seq_shard and self.is_image:
            raise ValueError("seq_shard applies to LM sequences, not images")
        if seq_shard and seq_len % sp != 0:
            raise ValueError(f"seq {seq_len} not divisible by sp={sp}")
        if seq_shard and sp > 1 and attn_fn is None:
            # no ring: the dense core over the sequence gathered over sp
            from gpuschedule_tpu_torch.parallel.gathered import gathered_attention

            attn_fn = self.attn_fn = partial(gathered_attention, mesh=mesh)
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.learning_rate = learning_rate
        self.opt_kwargs = dict(
            warmup_steps=warmup_steps, decay_steps=decay_steps, grad_clip=grad_clip
        )
        tp = mesh.shape["tp"]
        self.tp = NO_TP if tp == 1 else Tp(tp, mesh.coordinate("tp"), mesh.group("tp"))
        if self.tp.size > 1 and not self.is_image:
            with torch.device("meta"):  # the split's checks, before any state exists
                build_model(model_name, attn_fn=attn_fn, tp=self.tp)
        # this rank's share: rows [row0, row0 + rows) and, with seq_shard,
        # positions [seq_offset, seq_offset + local_seq) of the global batch
        self.ranks = mesh.size
        self.rows = batch_size // dp
        self.row0 = mesh.coordinate("dp") * self.rows
        self.dp = dp
        self.split = sp if seq_shard else 1
        self.local_seq = seq_len // self.split
        self.seq_offset = mesh.coordinate("sp") * self.local_seq if seq_shard else 0
        # the last chunk has no label past it; sp ranks hold the same rows
        # (replicas of each loss sum) when the sequence is not split
        self.last_chunk = not seq_shard or mesh.coordinate("sp") == sp - 1
        self.replicas = sp // self.split
        # the same cut, for to_device and prefetch_to_device
        self.batch_sharding = BatchSharding(self.device, self.row0, self.rows,
                                            self.seq_offset, self.local_seq)
        # a mesh with process groups sums over its data group (a launcher's
        # mesh, of one rank too); the card captures the step unless the
        # groups are gloo's, whose host-staged collectives a graph cannot hold
        self.grouped = mesh.device_mesh is not None
        self.capturable = self.device.type == "cuda" and (
            not self.grouped or dist.get_backend(mesh.data_group) == "nccl")
        # the state the graphs below belong to, and its graphs by batch key
        # (None: warmed up, not captured yet)
        self._graph_state: Optional[TrainState] = None
        self._graphs: Dict[tuple, Optional[_Captured]] = {}

    def init(self, seed: int = 0) -> TrainState:
        """A fresh model and optimizer, parameters drawn from a generator
        seeded with ``seed`` on the trainer's device: over tp each rank
        keeps its slice of what one rank draws.  Over several ranks each
        MoE block routes the global batch (:class:`TokenLayout`)."""
        with self.device:  # parameters are allocated on the device
            model, _ = build_model(self.model_name, attn_fn=self.attn_fn,
                                   tp=None if self.is_image else self.tp)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        model.reset_parameters(gen)
        if self.ranks > 1 and not self.is_image:
            sp_rank = self.mesh.coordinate("sp")
            layout = TokenLayout(
                batch=self.batch_size, row0=self.row0, chunk=sp_rank if self.split > 1 else 0,
                chunks=self.split, writes=self.split > 1 or sp_rank == 0,
                replicas=self.replicas, group=self.mesh.data_group)
            for block in model.blocks:
                if block.is_moe:
                    block.moe.tokens = layout
        sharded = [p for name, p in model.named_parameters()
                   if self.tp.size > 1 and param_partition_spec(name, p.dim()) is not None]
        opt = make_optimizer(model.parameters(), self.learning_rate, tp=self.tp,
                             sharded=sharded, **self.opt_kwargs)
        return TrainState(model, opt, self.mesh if self.ranks > 1 else None)

    def make_batch(self, seed: int = 0) -> Batch:
        """This rank's share of a random global batch, on the device (the
        same global batch on every rank, then sliced by :meth:`to_device`):
        a (batch, seq) int64 token batch drawn by
        :func:`synthetic_lm_batches`, or for a CNN an ``(images, labels)``
        pair, ``(batch, size, size, 3)`` f32 normals and int64 labels drawn
        from a ``torch.Generator`` seeded with ``seed`` on the CPU."""
        if self.is_image:
            gen = torch.Generator().manual_seed(seed)
            s = self.cfg.image_size
            images = torch.randn((self.batch_size, s, s, 3), generator=gen)
            labels = torch.randint(0, self.cfg.num_classes, (self.batch_size,), generator=gen)
            return self.to_device((images, labels))
        tokens = next(synthetic_lm_batches(
            batch_size=self.batch_size, seq_len=self.seq_len,
            vocab=self.cfg.vocab, num_batches=1, seed=seed,
        ))
        return self.to_device(tokens)

    def to_device(self, batch) -> Batch:
        """This rank's share of a global batch, on the device
        (:attr:`batch_sharding`).  Tokens (batch, seq): its dp rows and,
        with the sequence split, its sp chunk and one token past it, the
        label of the chunk's last position (the last chunk has none past
        it), as int64.  An ``(images, labels)`` pair: its dp rows of each,
        as f32 and int64.  On one rank, the whole batch."""
        return self.batch_sharding.to_device(batch)

    @staticmethod
    def loss(logits: torch.Tensor, tokens: torch.Tensor,
             count: Optional[int] = None, tp: Tp = NO_TP) -> torch.Tensor:
        """Next-token cross-entropy on f32 logits: the sum over the labels
        ``tokens[:, 1:]`` (one past the logits' positions at most) divided
        by ``count``, by default the number of labels (the mean).  Over tp
        the logits are this rank's vocab slice and the loss is
        vocab-parallel (:func:`vocab_parallel_loss`), no (B, S, V) gather."""
        labels = tokens[:, 1:]
        v = logits.shape[-1]
        logits = logits[:, :labels.shape[1]].reshape(-1, v)
        if tp.size > 1:
            total = vocab_parallel_loss(logits, labels.reshape(-1), tp)
        else:
            total = F.cross_entropy(logits, labels.reshape(-1), reduction="sum")
        return total / (labels.numel() if count is None else count)

    def _loss(self, model: torch.nn.Module, batch: Batch) -> torch.Tensor:
        """This rank's share of the global mean loss on its share of the
        batch (:meth:`to_device`): its sum divided by the global count of
        labels, times the replicas of each sum.  On one rank, the mean; an
        MoE model adds ``moe_aux_weight`` times the sum of its blocks' aux
        losses (each this rank's share of the global aux)."""
        if self.is_image:
            images, labels = batch
            count = labels.shape[0] * self.dp * self.replicas
            return F.cross_entropy(model(images), labels, reduction="sum") / count
        chunk = batch if self.last_chunk else batch[:, :-1]
        rows, n = chunk.shape
        count = rows * self.dp * (n * self.split - 1) * self.replicas
        logits, aux = model.forward_with_aux(chunk, pos_offset=self.seq_offset)
        loss = self.loss(logits, batch, count, self.tp)
        if aux:
            loss = loss + self.moe_aux_weight * sum(aux)
        return loss

    def step(self, state: TrainState, batch: Batch) -> Tuple[TrainState, torch.Tensor]:
        """One optimizer step on ``batch`` (:meth:`make_batch`'s form);
        returns ``(state, loss)``.  The loss stays on
        the device (no host sync): callers fence when they need a value.

        On the CPU the step runs eagerly.  On the card it is one CUDA graph,
        as the JAX step is one ``jit`` program: the first call for a state
        and a batch's shapes and dtypes runs eagerly on a side stream (it
        builds the kernels and adamw's state), the second captures forward,
        backward, clip and adamw into a graph and replays it once, and every
        later call copies the batch into the graph's static buffers and
        replays.  Each call is one real optimizer step.  A new batch shape
        or dtype captures a new graph, as ``jit`` retraces; a new state
        drops the graphs of the old one.  A capture that fails raises.

        Over a mesh with process groups the graph holds the data group's
        gradient and loss all-reduces too, and every collective of the
        forward and backward (tp's f and g, the sp gather, the MoE's
        counts): PyTorch lets a graph hold an NCCL collective once its
        communicator exists, which the warm-up step's collectives make.
        Over gloo groups the step runs eagerly (:meth:`_eager_step`).

        With the tracer on (``GSTPU_TRACE=1``) every step is recorded as a
        ``train.step`` span with the JAX trainer's attributes, fenced by a
        readback of the loss, so tracing serialises the host with the
        device.  Tracing off (the default), the step reads one attribute
        more: no sync, no allocation."""
        return traced_step(self._step, state, batch,
                           self.batch_size * (1 if self.is_image else self.seq_len))

    def _step(self, state: TrainState, batch: Batch) -> Tuple[TrainState, torch.Tensor]:
        """:meth:`step` untraced."""
        if not self.capturable:
            return self._eager_step(state, batch)
        if state is not self._graph_state:
            self._graphs.clear()
            self._graph_state = state
        key = tuple((tuple(t.shape), t.dtype) for t in _tensors(batch))
        if key not in self._graphs:
            self._graphs[key] = None
            return self._warm_up(state, batch)
        captured = self._graphs[key]
        if captured is None:
            captured = self._graphs[key] = self._capture(state, batch)
        for static, t in zip(_tensors(captured.batch), _tensors(batch)):
            static.copy_(t)
        captured.graph.replay()
        launches.replayed(captured.recorded)
        state.optimizer.schedule.step()
        return state, captured.loss.clone()

    def _eager_step(self, state: TrainState, batch: Batch) -> Tuple[TrainState, torch.Tensor]:
        """The step as plain PyTorch calls, one launch at a time."""
        state.optimizer.zero_grad()
        loss = self._update(state, batch)
        state.optimizer.schedule.step()
        return state, loss

    def _update(self, state: TrainState, batch: Batch) -> torch.Tensor:
        """:meth:`loss_and_grads`, then clip and adamw; the loss.  What a
        captured step's graph holds."""
        loss = self.loss_and_grads(state, batch)
        state.optimizer.update()
        return loss

    def loss_and_grads(self, state: TrainState, batch: Batch) -> torch.Tensor:
        """The step's loss on ``batch``, its gradients added to each
        parameter's ``.grad``.  Over a mesh with process groups the
        gradients and the loss are summed over its data group (the JAX
        step's psum): every replica holds the same gradients, every rank
        the global mean loss."""
        loss = self._loss(state.model, batch)
        loss.backward()
        if self.grouped:
            _all_reduce_grads(state.model.parameters(), self.mesh.data_group)
        loss = loss.detach()
        if self.grouped:
            dist.all_reduce(loss, group=self.mesh.data_group)
        return loss

    def _warm_up(self, state: TrainState, batch: Batch) -> Tuple[TrainState, torch.Tensor]:
        """One eager step on a side stream, as PyTorch asks before a capture."""
        return on_side_stream(self.device, self._eager_step, state, batch)

    def _capture(self, state: TrainState, batch: Batch) -> _Captured:
        """Capture :meth:`_update` on ``batch``'s shapes.  Nothing runs while
        a graph is captured, so the launches the wrappers count meanwhile
        become the graph's own, counted on its replays."""
        static = _clone(batch)
        state.optimizer.zero_grad()  # the grads are allocated in the graph's pool
        graph = torch.cuda.CUDAGraph()
        with launches.recording() as recorded, torch.cuda.graph(graph):
            loss = self._update(state, static)
        return _Captured(graph, static, loss, recorded)

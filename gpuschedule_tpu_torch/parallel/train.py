"""The train step: the framework's unit of measured work, on one device.

Counterpart of ``gpuschedule_tpu/parallel/train.py`` (``make_optimizer`` and
``ShardedTrainer``) at dp = sp = tp = 1.  The JAX trainer shards one jitted
step over a mesh; this one runs on one device, and any other mesh raises
``NotImplementedError`` (multi-GPU dp/tp/sp is queued in ROADMAP.md).  On
the card the step is one captured program, as the JAX step is one ``jit``
program: forward, backward, clip and adamw replay as one CUDA graph
(:meth:`ShardedTrainer.step`).  On the CPU it runs eagerly.

Optimizer parity with optax (read from the installed optax 0.2.6):
``optax.adamw`` decays every parameter with ``weight_decay=1e-4`` (torch's
default is 1e-2); ``decay_steps`` counts after the warmup; the global-norm
clip comes before adam, as ``optax.clip_by_global_norm`` computes it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gpuschedule_tpu_torch import resolve_device
from gpuschedule_tpu_torch.data.loader import synthetic_lm_batches
from gpuschedule_tpu_torch.models.transformer import build_model, lm_config
from gpuschedule_tpu_torch.ops import launches

ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default
# The JAX package's mesh axes (``make_mesh``), outermost first; this trainer
# is the mesh of size 1 on each.
MESH_AXES = ("pp", "dp", "sp", "tp")


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


def clip_by_global_norm(params: Iterable[torch.nn.Parameter], max_norm: float) -> torch.Tensor:
    """Scale all gradients by ``max_norm / norm`` when their global norm
    reaches ``max_norm`` (``optax.clip_by_global_norm``).  Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
    )
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, factor)
    return norm


@dataclass
class Optimizer:
    """adamw with the optional schedule and clip of ``make_optimizer``."""

    adamw: torch.optim.AdamW
    schedule: torch.optim.lr_scheduler.LambdaLR
    grad_clip: Optional[float]

    def update(self) -> None:
        """Clip and adamw: the part of :meth:`step` that runs on the device
        alone, so a CUDA graph can hold it."""
        if self.grad_clip is not None:
            params = [p for g in self.adamw.param_groups for p in g["params"]]
            clip_by_global_norm(params, self.grad_clip)
        self.adamw.step()

    def step(self) -> None:
        self.update()
        self.schedule.step()

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    learning_rate: float,
    *,
    warmup_steps: int = 0,
    decay_steps: Optional[int] = None,
    grad_clip: Optional[float] = None,
    capturable: Optional[bool] = None,
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
    tests hold against optax."""
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
    return Optimizer(adamw, sched, grad_clip)


@dataclass
class TrainState:
    """What the JAX trainer carries as ``(params, opt_state)``."""

    model: torch.nn.Module
    optimizer: Optimizer


@dataclass
class _Captured:
    """One captured step: the graph, its static token buffer and loss, and
    the launches of our kernels that its capture recorded."""

    graph: "torch.cuda.CUDAGraph"
    tokens: torch.Tensor
    loss: torch.Tensor
    recorded: launches.Recorded


class ShardedTrainer:
    """Owns a model and optimizer on one device and exposes one step.

    The same surface as the JAX trainer: construct, :meth:`init` once, then
    :meth:`step` per iteration.  ``flash_attn=True`` puts the CUDA flash
    kernels (:func:`~gpuschedule_tpu_torch.ops.flash_attention`) in every
    block.  The device is ``cuda`` unless ``device="cpu"`` is passed."""

    def __init__(
        self,
        model_name: str,
        *,
        batch_size: int = 8,
        seq_len: int = 128,
        learning_rate: float = 1e-3,
        flash_attn: bool = False,
        warmup_steps: int = 0,
        decay_steps: Optional[int] = None,
        grad_clip: Optional[float] = None,
        dp: int = 1,
        sp: int = 1,
        tp: int = 1,
        device=None,
    ):
        if (dp, sp, tp) != (1, 1, 1):
            raise NotImplementedError(
                f"only dp=sp=tp=1 is ported (got dp={dp} sp={sp} tp={tp}); "
                "multi-GPU dp/tp/sp and ring attention are queued in ROADMAP.md"
            )
        self.device = resolve_device(device)
        attn_fn: Optional[Callable] = None
        if flash_attn:
            from gpuschedule_tpu_torch.ops import flash_attention

            attn_fn = partial(flash_attention, causal=True)
        self.model_name = model_name
        self.attn_fn = attn_fn
        self.cfg = lm_config(model_name)
        if seq_len > self.cfg.max_seq:
            raise ValueError(f"seq_len {seq_len} > model max_seq {self.cfg.max_seq}")
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.learning_rate = learning_rate
        self.opt_kwargs = dict(
            warmup_steps=warmup_steps, decay_steps=decay_steps, grad_clip=grad_clip
        )
        # the state the graphs below belong to, and its graphs by batch key
        # (None: warmed up, not captured yet)
        self._graph_state: Optional[TrainState] = None
        self._graphs: Dict[tuple, Optional[_Captured]] = {}

    def init(self, seed: int = 0) -> TrainState:
        """A fresh model and optimizer, parameters drawn from a generator
        seeded with ``seed`` on the trainer's device."""
        with self.device:  # parameters are allocated on the device
            model, _ = build_model(self.model_name, attn_fn=self.attn_fn)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        model.reset_parameters(gen)
        opt = make_optimizer(model.parameters(), self.learning_rate, **self.opt_kwargs)
        return TrainState(model, opt)

    def make_batch(self, seed: int = 0) -> torch.Tensor:
        """A (batch, seq) int64 token batch on the device, drawn by
        :func:`synthetic_lm_batches` so it is the same on every device."""
        tokens = next(synthetic_lm_batches(
            batch_size=self.batch_size, seq_len=self.seq_len,
            vocab=self.cfg.vocab, num_batches=1, seed=seed,
        ))
        return self.to_device(tokens)

    def to_device(self, tokens: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(tokens)).long().to(self.device)

    @staticmethod
    def loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Mean next-token cross-entropy on f32 logits."""
        v = logits.shape[-1]
        return F.cross_entropy(
            logits[:, :-1].reshape(-1, v), tokens[:, 1:].reshape(-1)
        )

    def step(self, state: TrainState, tokens: torch.Tensor) -> Tuple[TrainState, torch.Tensor]:
        """One optimizer step; returns ``(state, loss)``.  The loss stays on
        the device (no host sync): callers fence when they need a value.

        On the CPU the step runs eagerly.  On the card it is one CUDA graph,
        as the JAX step is one ``jit`` program: the first call for a state
        and a batch shape and dtype runs eagerly on a side stream (it builds
        the kernels and adamw's state), the second captures forward,
        backward, clip and adamw into a graph and replays it once, and every
        later call copies the batch into the graph's static buffer and
        replays.  Each call is one real optimizer step.  A new batch shape
        or dtype captures a new graph, as ``jit`` retraces; a new state
        drops the graphs of the old one.  A capture that fails raises."""
        if self.device.type != "cuda":
            return self._eager_step(state, tokens)
        if state is not self._graph_state:
            self._graphs.clear()
            self._graph_state = state
        key = (tuple(tokens.shape), tokens.dtype)
        if key not in self._graphs:
            self._graphs[key] = None
            return self._warm_up(state, tokens)
        captured = self._graphs[key]
        if captured is None:
            captured = self._graphs[key] = self._capture(state, tokens)
        captured.tokens.copy_(tokens)
        captured.graph.replay()
        launches.replayed(captured.recorded)
        state.optimizer.schedule.step()
        return state, captured.loss.clone()

    def _eager_step(self, state: TrainState, tokens: torch.Tensor) -> Tuple[TrainState, torch.Tensor]:
        """The step as plain PyTorch calls, one launch at a time."""
        state.optimizer.zero_grad()
        loss = self.loss(state.model(tokens), tokens)
        loss.backward()
        state.optimizer.step()
        return state, loss.detach()

    def _warm_up(self, state: TrainState, tokens: torch.Tensor) -> Tuple[TrainState, torch.Tensor]:
        """One eager step on a side stream, as PyTorch asks before a capture."""
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            state, loss = self._eager_step(state, tokens)
        main.wait_stream(side)
        return state, loss

    def _capture(self, state: TrainState, tokens: torch.Tensor) -> _Captured:
        """Capture forward, backward, clip and adamw on ``tokens``' shape.
        Nothing runs while a graph is captured, so the launches the wrappers
        count meanwhile become the graph's own, counted on its replays."""
        static = tokens.clone()
        state.optimizer.zero_grad()  # the grads are allocated in the graph's pool
        graph = torch.cuda.CUDAGraph()
        with launches.recording() as recorded, torch.cuda.graph(graph):
            loss = self.loss(state.model(static), static)
            loss.backward()
            state.optimizer.update()
        return _Captured(graph, static, loss.detach(), recorded)

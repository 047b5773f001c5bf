"""The train step: the framework's unit of measured work, on one device.

Counterpart of ``gpuschedule_tpu/parallel/train.py`` (``make_optimizer`` and
``ShardedTrainer``) at dp = sp = tp = 1.  The JAX trainer shards one jitted
step over a mesh; this one runs eagerly on one device, and any other mesh
raises ``NotImplementedError`` (multi-GPU dp/tp/sp is queued in ROADMAP.md).

Optimizer parity with optax (read from the installed optax 0.2.6):
``optax.adamw`` decays every parameter with ``weight_decay=1e-4`` (torch's
default is 1e-2); ``decay_steps`` counts after the warmup; the global-norm
clip comes before adam, as ``optax.clip_by_global_norm`` computes it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gpuschedule_tpu_torch import resolve_device
from gpuschedule_tpu_torch.data.loader import synthetic_lm_batches
from gpuschedule_tpu_torch.models.transformer import build_model, lm_config

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

    def step(self) -> None:
        if self.grad_clip is not None:
            params = [p for g in self.adamw.param_groups for p in g["params"]]
            clip_by_global_norm(params, self.grad_clip)
        self.adamw.step()
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
) -> Optimizer:
    """adamw with linear warmup over ``warmup_steps``, cosine decay to zero
    over ``decay_steps`` (counted after warmup) and global-norm clipping at
    ``grad_clip``, all opt-in; the defaults are plain ``optax.adamw``."""
    adamw = torch.optim.AdamW(
        params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=ADAMW_WEIGHT_DECAY,
    )
    sched = torch.optim.lr_scheduler.LambdaLR(
        adamw, partial(lr_factor, warmup_steps=warmup_steps, decay_steps=decay_steps)
    )
    return Optimizer(adamw, sched, grad_clip)


@dataclass
class TrainState:
    """What the JAX trainer carries as ``(params, opt_state)``."""

    model: torch.nn.Module
    optimizer: Optimizer


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
        the device (no host sync): callers fence when they need a value."""
        state.optimizer.zero_grad()
        loss = self.loss(state.model(tokens), tokens)
        loss.backward()
        state.optimizer.step()
        return state, loss.detach()

"""Step and callable timing on the card.

Counterpart of ``gpuschedule_tpu/profiler/harness.py`` (``time_steps``,
``time_callable``, ``measure_step_time`` on one device).  PyTorch returns
before the device finishes, so every timed window ends in
``torch.cuda.synchronize()`` (steps) or is read from CUDA events
(callables).  The JAX package's host-readback fence works around its TPU
transport and has no counterpart here.  The curve fit, ``profile_model``
and ``CurveCache`` are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import statistics
import time
from typing import List

import torch

from gpuschedule_tpu_torch.parallel.train import ShardedTrainer


def _fence(x) -> None:
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


def time_steps(step_fn, state, tokens, *, iters: int, repeats: int = 3):
    """Median seconds/step over ``repeats`` blocks of ``iters`` chained steps.

    ``step_fn(state, tokens) -> (state, loss)``.  Each block ends with a
    device synchronize.  Returns ``(seconds_per_step, final_state)``."""
    if iters < 1 or repeats < 1:
        raise ValueError(f"iters/repeats must be >= 1, got {iters}/{repeats}")
    _fence(tokens)
    block_times: List[float] = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            state, loss = step_fn(state, tokens)
        _fence(loss)
        block_times.append((time.perf_counter() - t0) / iters)
    return statistics.median(block_times), state


def time_callable(fn, *args, iters: int = 8, warmup: int = 2, device=None) -> float:
    """Mean seconds per call of ``fn(*args)``: CUDA events around ``iters``
    calls on a CUDA device, else the host clock.  The device is ``device``,
    or that of the first tensor argument; with neither it raises, since an
    unfenced host clock around CUDA work times only the enqueue."""
    dev = torch.device(device) if device is not None else next(
        (a.device for a in args if isinstance(a, torch.Tensor)), None
    )
    if dev is None:
        raise ValueError("pass device= when no argument is a tensor")
    for _ in range(warmup):
        fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters


def measure_step_time(
    model_name: str,
    *,
    batch_size: int = 8,
    seq_len: int = 128,
    warmup: int = 2,
    iters: int = 10,
    repeats: int = 1,
    flash_attn: bool = False,
    device=None,
) -> float:
    """Median seconds per optimizer step of ``model_name`` on one device
    (``cuda`` unless ``device="cpu"``), after ``warmup`` steps."""
    trainer = ShardedTrainer(
        model_name, batch_size=batch_size, seq_len=seq_len,
        flash_attn=flash_attn, device=device,
    )
    state = trainer.init(seed=0)
    batch = trainer.make_batch(seed=0)
    loss = None
    for _ in range(max(1, warmup)):
        state, loss = trainer.step(state, batch)
    _fence(loss)
    step_s, _ = time_steps(trainer.step, state, batch, iters=iters, repeats=repeats)
    return step_s

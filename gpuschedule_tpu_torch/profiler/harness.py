"""Step and callable timing on the card, and the goodput-curve profile.

Counterpart of ``gpuschedule_tpu/profiler/harness.py`` on one device:
``time_steps``, ``time_callable``, ``measure_step_time``, ``capture_trace``
and ``profile_model``; and, for single kernels, ``device_ms_per_launch`` (a
``torch.profiler`` window) and ``host_us_per_call`` (the launch path).  PyTorch returns before the device finishes, so
every timed window ends in ``torch.cuda.synchronize()`` (steps) or is read
from CUDA events (callables).  The JAX package's host-readback fence works
around its TPU transport and has no counterpart here.  With the tracer on
(``GSTPU_TRACE=1``, ``obs/tracer.py``) the JAX harness's spans are
recorded with its names and attributes: ``profiler.block`` (one a timed
block), ``profiler.measure_step_time``, ``profiler.capture_trace`` and
``profiler.profile_model``.
"""

from __future__ import annotations

import math
import statistics
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

from gpuschedule_tpu_torch.cluster.tpu import GENERATIONS
from gpuschedule_tpu_torch.models import MODEL_CONFIGS
from gpuschedule_tpu_torch.obs.tracer import get_tracer
from gpuschedule_tpu_torch.parallel.train import ShardedTrainer
from gpuschedule_tpu_torch.profiler.goodput import (
    CurveCache,
    GoodputCurve,
    fit_step_time_curve,
    synthesize_step_times,
)
from gpuschedule_tpu_torch.profiler.ici import dp_gradient_bytes


def _fence(x) -> None:
    """Wait for the device of ``x``: a tensor, or a batch's tuple of them."""
    if isinstance(x, (tuple, list)) and x:
        x = x[0]
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


def time_steps(step_fn, state, tokens, *, iters: int, repeats: int = 3):
    """Median seconds/step over ``repeats`` blocks of ``iters`` chained steps.

    ``step_fn(state, tokens) -> (state, loss)``; ``tokens`` is any batch
    the step takes (an ``(images, labels)`` pair for a CNN).  Each block ends with a
    device synchronize.  Returns ``(seconds_per_step, final_state)``."""
    if iters < 1 or repeats < 1:
        raise ValueError(f"iters/repeats must be >= 1, got {iters}/{repeats}")
    _fence(tokens)
    tracer = get_tracer()
    block_times: List[float] = []
    for block in range(repeats):
        with tracer.span("profiler.block", cat="profiler", block=block, iters=iters) as sp:
            t0 = time.perf_counter()
            for _ in range(iters):
                state, loss = step_fn(state, tokens)
            _fence(loss)
            block_s = (time.perf_counter() - t0) / iters
            sp.set(s_per_step=block_s)
        block_times.append(block_s)
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


def device_ms_per_launch(fn, kernel: str, launches: int = 5):
    """(ms per launch, kernel names seen) of the device kernels whose name
    holds ``kernel`` over ``launches`` calls of ``fn`` in a
    ``torch.profiler`` window; ms is None if the profiler saw no such kernel.
    ``fn`` launches at least one kernel, so a window that delivered no
    device activity at all lost its records: it is taken once more."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
        names, total = set(), 0.0
        for evt in prof.events():
            if evt.device_type == DeviceType.CUDA and not getattr(evt, "is_user_annotation", False):
                names.add(evt.name)
                if kernel in evt.name:
                    total += evt.time_range.elapsed_us() / 1e3
        if names:
            break
    hits = [n for n in names if kernel in n]
    return (total / launches if hits else None), sorted(names)


def host_us_per_call(fn, calls: int = 1000) -> float:
    """The host's µs per call of ``fn`` when nothing waits for the device:
    ``time.perf_counter_ns`` over ``calls`` calls with no synchronisation,
    then one.  It prices the launch path alone, as long as the device's
    queue does not fill."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / calls / 1e3


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
    """Median seconds per optimizer step of ``model_name`` (any zoo family;
    ``seq_len`` means nothing to a CNN) on one device (``cuda`` unless
    ``device="cpu"``), after ``warmup`` steps: at least the two that warm
    up and capture the step on the card."""
    with get_tracer().span("profiler.measure_step_time", cat="profiler", model=model_name,
                           k=1, sp=1, tp=1, pp=1) as sp_:
        trainer = ShardedTrainer(
            model_name, batch_size=batch_size, seq_len=seq_len,
            flash_attn=flash_attn, device=device,
        )
        state = trainer.init(seed=0)
        batch = trainer.make_batch(seed=0)
        loss = None
        for _ in range(max(2, warmup)):
            state, loss = trainer.step(state, batch)
        _fence(loss)
        step_s, _ = time_steps(trainer.step, state, batch, iters=iters, repeats=repeats)
        sp_.set(step_s=step_s)
    return step_s


def capture_trace(
    model_name: str,
    out_dir,
    *,
    batch_size: int = 8,
    seq_len: int = 128,
    steps: int = 3,
    device=None,
) -> str:
    """Write a Chrome trace (``torch.profiler``) of ``steps`` train steps
    to ``out_dir/trace.json`` and return its path.

    The deep-inspection path beside :func:`measure_step_time`: the median
    comes from there, the per-kernel timeline from here.  The traced step is
    the measured one (same trainer, batch and sequence length), after the
    two warm-up steps that build and capture it, so the window holds replays
    of the captured step; on the card the window records device activity
    and ends in a synchronize, so every step's kernels lie inside it.  View
    the file in ui.perfetto.dev or chrome://tracing."""
    from torch.profiler import ProfilerActivity, profile

    with get_tracer().span("profiler.capture_trace", cat="profiler", model=model_name,
                           steps=steps):
        trainer = ShardedTrainer(model_name, batch_size=batch_size, seq_len=seq_len,
                                 device=device)
        state = trainer.init(seed=0)
        batch = trainer.make_batch(seed=0)
        for _ in range(2):
            state, loss = trainer.step(state, batch)
        _fence(loss)
        cuda = trainer.device.type == "cuda"
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities) as prof:
            for _ in range(steps):
                state, loss = trainer.step(state, batch)
            if cuda:
                torch.cuda.synchronize(trainer.device)
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / "trace.json"
        prof.export_chrome_trace(str(path))
    return str(path)


def profile_model(
    model_name: str,
    *,
    ks: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
    generation: str = "v5e",
    batch_size: int = 8,
    seq_len: int = 128,
    cache: Optional[CurveCache] = None,
    sp: int = 1,
    tp: int = 1,
    pp: int = 1,
    device=None,
) -> GoodputCurve:
    """Fit a goodput curve for ``model_name``: measure k = 1 on the device,
    synthesize every other k, fit, and store the curve in ``cache``.

    What the JAX package's ``profile_model`` does on one device: the
    measured step anchors ``synthesize_step_times`` (the TPU ICI/DCN model of
    ``generation``, unchanged, so the simulator reads the curve it expects),
    the smooth family is fit on the intra-pod points and carries the
    multislice fields, and the cache entry has the same key, ``source`` and
    points.  The device is ``cuda`` unless ``device="cpu"``.  ``sp``, ``tp``
    and ``pp`` above 1 need a mesh, which is not ported yet."""
    if (sp, tp, pp) != (1, 1, 1):
        raise NotImplementedError(
            f"only sp=tp=pp=1 is ported (got sp={sp} tp={tp} pp={pp}); "
            "multi-GPU meshes and the pipeline trainer are queued in ROADMAP.md"
        )
    cfg = MODEL_CONFIGS[model_name]
    n_devices = 1

    def measure() -> float:
        return measure_step_time(model_name, batch_size=batch_size, seq_len=seq_len,
                                 device=device)

    with get_tracer().span("profiler.profile_model", cat="profiler", model=model_name,
                           ks=list(ks), generation=generation) as prof_sp:
        measured: Dict[int, float] = {k: measure() for k in ks if k <= n_devices}
        prof_sp.set(measured_ks=sorted(measured))
    synth_ks = [k for k in ks if k not in measured]
    if synth_ks and 1 not in measured:
        # the analytic extension anchors on the one-device point
        measured[1] = measure()
    points = dict(measured)
    if synth_ks:
        synth = synthesize_step_times(
            single_chip_step_s=measured[1],
            param_count=cfg.param_count,
            generation=generation,
            ks=synth_ks,
        )
        points.update(dict(zip(synth_ks, synth)))

    # Fit the smooth family on intra-pod points only (it cannot represent
    # the ICI->DCN step at the pod boundary); the curve carries the
    # multislice fields and adds the DCN phase in step_time_dcn.  The
    # measured k = 1 point is always intra-pod, so the JAX package's branch
    # for a request wholly beyond one pod does not arise on one device.
    pod = math.prod(GENERATIONS[generation]["pod_dims"])
    intra = {k: v for k, v in points.items() if k <= pod}
    curve = fit_step_time_curve(sorted(intra), [intra[k] for k in sorted(intra)])
    curve = GoodputCurve(curve.theta, pod_chips=pod,
                         dcn_grad_bytes=dp_gradient_bytes(cfg.param_count))
    if cache is not None:
        cache.put(
            model_name,
            curve,
            source=(
                f"measured<= {n_devices} chips (sp={sp}, tp={tp}, pp={pp}), "
                f"analytic beyond ({generation})"
            ),
            points=points,
        )
        cache.save()
    return curve

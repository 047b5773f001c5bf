"""Step and callable timing on the card, and the goodput-curve profile.

Counterpart of ``gpuschedule_tpu/profiler/harness.py``: ``time_steps``,
``time_callable``, ``measure_step_time``, ``capture_trace`` and
``profile_model``; ``device_window``, the one ``torch.profiler`` window
of the port's tools and checks (a marker kernel in each, a lost window
taken again); and, for single kernels, ``device_ms_per_launch`` (on such a
window) and ``host_us_per_call`` (the launch path).
Under a launcher the step is measured on (dp, sp, tp) meshes of the first
k ranks, or (pp, dp) meshes with the pipeline's trainer, as the JAX
harness measures meshes of the first k devices (``_mesh_trainer``): every
rank calls, the ranks outside a mesh wait, and rank 0's time is every
rank's.  PyTorch returns before the device finishes, so
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
import sys
import time
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from gpuschedule_tpu_torch.cluster.tpu import GENERATIONS
from gpuschedule_tpu_torch.models import MODEL_CONFIGS
from gpuschedule_tpu_torch.obs.tracer import get_tracer
from gpuschedule_tpu_torch.parallel.mesh import sub_mesh, world_size
from gpuschedule_tpu_torch.parallel.pipeline import PipelinedLM
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


WINDOWS = 4  # profiler windows device_window takes before it gives up
MARKER = "spin"  # in the name of the kernel torch.cuda._sleep launches: the pads and the marker
MARKER_CYCLES = 40_000  # the marker's length, ~20 µs: told apart from the pads by it
MARKER_US = 10.0
# short spins before the marker: a process that has shared the card with
# another drops the first records of its windows (ROADMAP Queue 3)
PAD = 16
# the windows this process has taken and lost: the fault that loses them is
# the process's (ROADMAP Queue 3), so the tally is too
TALLY = {"taken": 0, "lost": 0}


class LostWindow(RuntimeError):
    """Every profiler window :func:`device_window` took lost its records."""


class Record(NamedTuple):
    """One record of a profiler window: a name and its µs."""

    name: str
    us: float


@dataclass
class Window:
    """What :func:`device_window` returns: the window's device records (the
    marker left out), its host records (with ``host=True``) and how many
    windows before it were lost."""

    device: List[Record]
    host: List[Record]
    lost: int
    wall_ms: float  # the host's time from the window's first launch to its last synchronize


def device_window(fn, calls: int = 1, *, want: Optional[str] = None, host: bool = False,
                  what: str = "device_window", windows: int = WINDOWS,
                  check: bool = True, warm: bool = True,
                  agree: Optional[Callable[[bool], bool]] = None) -> Window:
    """The records of one ``torch.profiler`` window of ``calls`` calls of
    ``fn`` on the card, after one call outside it (``warm=False``: none,
    for a caller that counts every call): the one window of the
    port's tools and checks.  Each window launches PAD short spins, then a
    marker kernel (``torch.cuda._sleep`` of MARKER_CYCLES), then the calls.
    A process that has shared the card with another process drops the
    first device records of its windows (ROADMAP Queue 3,
    ``tools/window_probe.py``): the pads take a short loss, and a window
    whose device records hold no marker lost more.  A window without the marker, or with ``want`` given
    and no device record whose name holds it, is taken again, up to
    ``windows`` windows; each lost one is printed to stderr on a line of
    its own (``what``, the window's number and the names it did see), and
    a run of ``windows`` lost windows raises :class:`LostWindow`.  Ranks that
    step together pass ``agree``, which takes this rank's verdict on each
    window and returns whether every rank kept its window (an all-reduce):
    they take a window again together, since one taken again on one rank
    alone would call ``fn`` more often there than on the others.
    ``check=False`` returns the first window as it is (for its host
    records).  ``host`` records the host's activity too (the runtime calls
    that launch the kernels, ``Window.host``).  :data:`TALLY` counts the
    process's windows.  The pads and the marker are left out of the
    records returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    if warm:
        fn()
    torch.cuda.synchronize()
    for window in range(windows):
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(PAD):
                torch.cuda._sleep(100)
            torch.cuda._sleep(MARKER_CYCLES)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        TALLY["taken"] += 1
        device, cpu = [], []
        for evt in prof.events():
            # GPU-side user annotations (the optimizer's range) overlap the
            # kernels they contain: device activity only
            if getattr(evt, "is_user_annotation", False):
                continue
            rec = Record(evt.name, evt.time_range.elapsed_us())
            (device if evt.device_type == DeviceType.CUDA else cpu).append(rec)
        marked = any(MARKER in r.name and r.us >= MARKER_US for r in device)
        device = [r for r in device if MARKER not in r.name]
        if not check:
            return Window(device, cpu, window, wall_ms)
        kept = marked and (want is None or any(want in r.name for r in device))
        if (kept if agree is None else agree(kept)):
            return Window(device, cpu, window, wall_ms)
        TALLY["lost"] += 1
        lost = "its marker" if not marked else repr(want) if not kept else "another rank's"
        print(f"{what}: window {window + 1} of {windows} lost "
              f"{lost}: {calls} calls, device records "
              f"{sorted({r.name[:90] for r in device})}", file=sys.stderr, flush=True)
    raise LostWindow(f"{what}: {windows} profiler windows in a row lost their device records")


def device_ms_per_launch(fn, kernel: str, launches: int = 5):
    """(ms per launch, kernel names seen) of the device kernels whose name
    holds ``kernel`` over ``launches`` calls of ``fn`` in a profiler
    window (:func:`device_window`, which takes a window again while the
    kernel is missing from it); ms is None if WINDOWS windows lost it."""
    try:
        win = device_window(fn, launches, want=kernel, what=f"device_ms_per_launch {kernel!r}")
    except LostWindow:
        return None, []
    total = sum(r.us for r in win.device if kernel in r.name) / 1e3
    return total / launches, sorted({r.name for r in win.device})


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


def _rank() -> int:
    return dist.get_rank() if world_size() > 1 else 0


def _from_rank0(value):
    """Rank 0's ``value`` on every rank (a collective over the world)."""
    if world_size() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _mesh_trainer(model_name, k, batch_size, seq_len, *, sp=1, tp=1, pp=1,
                  seq_shard=False, flash_attn=False, warmup=2, num_microbatches=4,
                  device=None):
    """(trainer, state, batch) on a (dp, sp, tp) mesh of the first ``k``
    ranks, dp taking what sp and tp leave, the batch rounded down to a dp
    multiple (with the JAX harness's warning), after ``warmup`` steps (at
    least the two that warm up and capture a step on one card), fenced;
    None on a rank outside the mesh.  Every rank calls it.  An sp mesh
    splits the sequence, and its attention is the dense core over the
    sequence gathered over sp, as the JAX trainer's.  ``pp`` >= 2 builds
    the :class:`PipelinedLM` on a (pp, dp) mesh instead, with
    ``num_microbatches`` microbatches and the batch rounded down to a
    multiple of ``num_microbatches · dp`` (with the JAX harness's warning);
    the pipeline composes with dp only."""
    if sp < 1 or tp < 1 or pp < 1 or k % (sp * tp * pp) != 0:
        raise ValueError(f"{k} devices do not factor as dp x sp={sp} x tp={tp} x pp={pp}")
    if pp > 1 and (sp > 1 or tp > 1):
        raise ValueError(f"pp={pp} composes with dp only; got sp={sp}, tp={tp}")
    dp = k // (sp * tp * pp)
    mesh = sub_mesh(k, dp=dp, sp=sp, tp=tp, pp=pp, device=device)
    if mesh is None:
        return None
    bs = batch_size
    if pp > 1:
        # batch must split into M microbatches whose size divides dp
        bs = max(batch_size - batch_size % (num_microbatches * dp), num_microbatches * dp)
        if bs != batch_size:
            warnings.warn(
                f"batch {batch_size} not divisible by microbatches*dp="
                f"{num_microbatches * dp}: measuring batch {bs} instead — "
                f"step times at this k are NOT comparable to ks that kept "
                f"the requested batch; use a batch size divisible by "
                f"num_microbatches * every profiled dp",
                stacklevel=3,
            )
    elif bs % dp != 0:
        bs = max(dp, bs - bs % dp)
        # a silent round-down would mix workloads across the fitted ks
        warnings.warn(
            f"batch {batch_size} not divisible by dp={dp}: measuring "
            f"batch {bs} instead — step times at this k are NOT "
            f"comparable to ks that kept the full batch; use a batch "
            f"size divisible by every profiled k",
            stacklevel=3,
        )
    if pp > 1:
        trainer = PipelinedLM(model_name, mesh, batch_size=bs, seq_len=seq_len,
                              num_microbatches=num_microbatches, flash_attn=flash_attn)
    else:
        trainer = ShardedTrainer(model_name, mesh, batch_size=bs, seq_len=seq_len,
                                 seq_shard=seq_shard, flash_attn=flash_attn)
    state = trainer.init(seed=0)
    batch = trainer.make_batch(seed=0)
    loss = None
    for _ in range(max(2, warmup)):
        state, loss = trainer.step(state, batch)
    _fence(loss)
    return trainer, state, batch


# Whether this process has measured a step: torch's thread pools (and on
# the card a CUDA context) then live in it, which a forked child cannot
# use, so a worker pool started here spawns (sim/pool.py:default_context).
STEPS_MEASURED = False


def measure_step_time(
    model_name: str,
    *,
    devices: Optional[int] = None,
    batch_size: int = 8,
    seq_len: int = 128,
    warmup: int = 2,
    iters: int = 10,
    repeats: int = 1,
    sp: int = 1,
    tp: int = 1,
    pp: int = 1,
    seq_shard: bool = False,
    flash_attn: bool = False,
    num_microbatches: int = 4,
    device=None,
) -> Optional[float]:
    """Median seconds per optimizer step of ``model_name`` (any zoo family;
    ``seq_len`` means nothing to a CNN) on a (dp, sp, tp) mesh of the first
    ``devices`` ranks (default: the world; one device without a launcher),
    each on ``cuda`` unless ``device="cpu"``, after ``warmup`` steps; with
    ``pp`` >= 2 the pipeline's step on a (pp, dp) mesh.  Every rank calls
    it; a rank outside the mesh gets None."""
    global STEPS_MEASURED
    STEPS_MEASURED = True
    k = world_size() if devices is None else devices
    with get_tracer().span("profiler.measure_step_time", cat="profiler", model=model_name,
                           k=k, sp=sp, tp=tp, pp=pp) as sp_:
        built = _mesh_trainer(model_name, k, batch_size, seq_len, sp=sp, tp=tp, pp=pp,
                              seq_shard=seq_shard, flash_attn=flash_attn, warmup=warmup,
                              num_microbatches=num_microbatches, device=device)
        if built is None:
            return None
        trainer, state, batch = built
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
    sp: int = 1,
    tp: int = 1,
    pp: int = 1,
    device=None,
) -> str:
    """Write a Chrome trace (``torch.profiler``) of ``steps`` train steps
    to ``out_dir/trace.json`` and return its path.

    The deep-inspection path beside :func:`measure_step_time`: the median
    comes from there, the per-kernel timeline from here.  The traced step is
    the measured one (the same ``_mesh_trainer``: trainer, batch, sequence
    length, and the (dp, sp, tp) or (pp, dp) mesh over the world that
    ``sp``, ``tp`` and ``pp`` give), after the two warm-up steps that build and capture it, so on one
    card the window holds replays of the captured step; on the card the
    window records device activity and ends in a synchronize, so every
    step's kernels lie inside it.  Over several ranks every rank steps and
    rank 0 writes its trace.  View the file in ui.perfetto.dev or
    chrome://tracing."""
    from torch.profiler import ProfilerActivity, profile

    with get_tracer().span("profiler.capture_trace", cat="profiler", model=model_name,
                           steps=steps):
        trainer, state, batch = _mesh_trainer(model_name, world_size(), batch_size, seq_len,
                                              sp=sp, tp=tp, pp=pp, seq_shard=sp > 1,
                                              device=device)
        cuda = trainer.device.type == "cuda"
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities) as prof:
            for _ in range(steps):
                state, loss = trainer.step(state, batch)
            if cuda:
                torch.cuda.synchronize(trainer.device)
        out = Path(out_dir)
        path = out / "trace.json"
        if _rank() == 0:
            out.mkdir(parents=True, exist_ok=True)
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
    """Fit a goodput curve for ``model_name``: measure what the ranks
    allow, synthesize every other k, fit, and store the curve in ``cache``.

    What the JAX package's ``profile_model`` does: every k up to the
    world's ranks (one device without a launcher) is measured on a
    (dp, sp, tp) mesh of the first k ranks with dp = k / (sp * tp)
    (:func:`measure_step_time`; every rank calls, rank 0's times count);
    the smallest replica's point (k = sp * tp) anchors
    ``synthesize_step_times`` for the rest (the TPU ICI/DCN model of
    ``generation``, unchanged, so the simulator reads the curve it
    expects), the dp-sync payload per device shrunk by tp; the smooth
    family is fit on the intra-pod points and carries the multislice
    fields; the cache entry (rank 0 writes it) has the same key
    (``model@sp{sp}tp{tp}`` off the plain dp curve, ``model@sp{sp}tp{tp}pp{pp}``
    for a pipeline), ``source`` and points.  ``pp`` >= 2 measures the
    pipeline's trainer on (pp, dp) meshes, dp = k / pp; sp and tp stay 1,
    and the dp-sync payload per device shrinks by pp too (a stage holds
    1/pp of the layers).  The device is ``cuda`` unless ``device="cpu"``."""
    if pp > 1 and (sp > 1 or tp > 1):
        raise ValueError(f"pp={pp} composes with dp only; got sp={sp}, tp={tp}")
    cfg = MODEL_CONFIGS[model_name]
    n_devices = world_size()
    unit = sp * tp * pp  # the smallest k that forms one model replica
    bad = [k for k in ks if k % unit]
    if bad:
        raise ValueError(f"ks {bad} not divisible by sp*tp*pp={unit}")

    def measure(k: int) -> float:
        return _from_rank0(measure_step_time(
            model_name, devices=k, batch_size=batch_size, seq_len=seq_len, sp=sp, tp=tp,
            pp=pp, seq_shard=sp > 1, device=device))

    with get_tracer().span("profiler.profile_model", cat="profiler", model=model_name,
                           ks=list(ks), generation=generation) as prof_sp:
        measured: Dict[int, float] = {k: measure(k) for k in ks if k <= n_devices}
        prof_sp.set(measured_ks=sorted(measured))
    synth_ks = [k for k in ks if k not in measured]
    if synth_ks and unit not in measured:
        # the analytic extension anchors on the smallest replica's point,
        # measured only when the synthesis needs it
        if unit > n_devices:
            raise ValueError(f"sp*tp*pp={unit} exceeds the {n_devices} available devices; "
                             "nothing is measurable")
        measured[unit] = measure(unit)
    points = dict(measured)
    # per-device dp-grad payload: tp splits the parameters, pp the layers
    per_chip_params = cfg.param_count // (tp * pp)
    if synth_ks:
        synth = synthesize_step_times(
            single_chip_step_s=measured[unit],
            param_count=per_chip_params,
            generation=generation,
            ks=synth_ks,
            unit=unit,
        )
        points.update(dict(zip(synth_ks, synth)))

    # Fit the smooth family on intra-pod points only (it cannot represent
    # the ICI->DCN step at the pod boundary); the curve carries the
    # multislice fields and adds the DCN phase in step_time_dcn.  The
    # measured points are intra-pod (a launcher's ranks are far fewer than
    # a pod's chips), so the JAX package's branch for a request wholly
    # beyond one pod does not arise.
    pod = math.prod(GENERATIONS[generation]["pod_dims"])
    intra = {k: v for k, v in points.items() if k <= pod}
    curve = fit_step_time_curve(sorted(intra), [intra[k] for k in sorted(intra)])
    curve = GoodputCurve(curve.theta, pod_chips=pod,
                         dcn_grad_bytes=dp_gradient_bytes(per_chip_params))
    if cache is not None and _rank() == 0:
        # sp/tp/pp variants get their own key: the scheduler's replay looks
        # curves up by bare model name
        if (sp, tp, pp) == (1, 1, 1):
            key = model_name
        elif pp == 1:
            key = f"{model_name}@sp{sp}tp{tp}"
        else:
            key = f"{model_name}@sp{sp}tp{tp}pp{pp}"
        cache.put(
            key,
            curve,
            source=(
                f"measured<= {n_devices} chips (sp={sp}, tp={tp}, pp={pp}), "
                f"analytic beyond ({generation})"
            ),
            points=points,
        )
        cache.save()
    return curve

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``gpuschedule_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. device — the card's name, and its name and power limit from nvidia-smi;
2. build — nvcc builds ``ops/csrc/*.cu`` from this checkout; each kernel's
   registers and spills from ``-Xptxas -v`` (the bf16 tensor-core kernels
   must not spill at D = 32 and 64), and the count of ``HMMA`` instructions
   in each kernel's SASS from ``cuobjdump`` (the bf16 forward, dq and dk/dv
   kernels must have some); the same for the probe kernels, with their
   static and dynamic shared memory (neither may spill, and the xᵀx kernel
   must have ``HMMA``);
3. parity — each CUDA kernel (forward, dq, dk/dv) against its plain PyTorch
   version on the same inputs: transformer-long's attention shape
   (B=2, S=4096, H=8, D=32, bf16, causal) and ragged shapes in bf16 (the
   tensor-core kernels) and f32 (the FMA kernels) at D = 32, 64, 96 and 128,
   causal and not; the flash op against the dense oracle in f32 and bf16;
   flash and dense transformer-long losses at init on a short sequence;
4. kernel times — CUDA events at the transformer-long shape, beside the plain
   versions, ``F.scaled_dot_product_attention`` (a yardstick the port never
   calls) and the least time the card could take (``bound_ms``); for the
   bf16 forward, dq and dk/dv kernels also the device time per launch from
   a ``torch.profiler`` window, beside the event time;
5. flash train step — ``ShardedTrainer("transformer-long", batch_size=2,
   seq_len=4096, flash_attn=True)``: 3 warm-up steps, ``time_steps(iters=5,
   repeats=3)``, one last step; the loss must be finite and fall, and the
   launch counters must show every kernel on the path (K1 >= 8, K2 >= 4,
   K3 >= 4 per step: 4 layers, remat recomputes each forward);
6. dense train step — transformer-large at b16 x S512, no kernel of ours;
7. probe parity — K5a (copy) and K5b (rows 0-7 of each tile's xᵀx) in both
   launch forms against their plain versions at n = 64, 4096, 37 and
   STAGES + 1 tiles of (8, 128) bf16 (STAGES: the kernels' ring depth, as
   the built library reports it): K5a exactly, K5b within one bf16 ulp;
8. probe sweeps — the four sweeps of the overhead probe
   (``gpuschedule_tpu_torch.tools.overhead_probe``), one JSON line per
   point and per slope; the launch counters must show both kernels; then
   the kernels at n = 4096 in both forms (CUDA events, the device time per
   launch from a profiler window, and the wrapper's host µs per call over
   1,000 unsynchronised calls: ``gpuschedule_tpu_torch/tools/probe_costs.py``)
   beside their plain versions, ``Tensor.copy_`` and ``torch.bmm``
   (yardsticks the port never calls) and the bound;
9. profile — ``profile_model("transformer-large", batch_size=16,
   seq_len=512)`` over ks 1-64 into a ``CurveCache``, which must reload
   with all seven ks, finite non-negative theta and a measured k = 1 point
   within 15% of phase 6's step; then ``capture_trace`` of 2 steps, whose
   file must exist; a ``{"profile": ...}`` line;
10. a ``{"train": ...}`` line, a ``{"kernels": [...]}`` line (all five
   kernels), and last the ``{"ok": true, "device": {...}}`` line.

Exits non-zero when CUDA is unavailable or the port cannot be imported.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# Published dense peaks of one H100 SXM (NVIDIA data sheet, 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

FWD_TOL = 2e-2      # max abs error of the forward output (bench.py's bound)
GRAD_TOL = 2e-2     # max abs error of a gradient over the plain version's max
LSE_TOL = 1e-3      # max abs error of the f32 logsumexp rows
LOSS_RTOL = 2e-3    # flash vs dense loss at init (the JAX suite's bound)

SOURCE = "gpuschedule_tpu_torch/ops/csrc/flash_attention.cu"
# wrapper -> (the kernel bf16 inputs launch, the kernel f32 inputs launch, replaces)
KERNELS = {
    "flash_fwd": ("fwd_mma_kernel", "fwd_kernel",
                  "gpuschedule_tpu/ops/flash_attention.py:98"),
    "flash_bwd_dq": ("dq_mma_kernel", "bwd_dq_kernel",
                     "gpuschedule_tpu/ops/flash_attention.py:155"),
    "flash_bwd_dkdv": ("dkdv_mma_kernel", "bwd_dkdv_kernel",
                       "gpuschedule_tpu/ops/flash_attention.py:202"),
}
TENSOR_CORE_KERNELS = ("fwd_mma_kernel", "dq_mma_kernel", "dkdv_mma_kernel")
NO_SPILL_HEAD_DIMS = (32, 64)  # transformer-long, transformer-xlong
MAIN_SHAPE = (2, 4096, 8, 32)  # transformer-long: d_model 256 / 8 heads, S = max_seq

PROBE_SOURCE = "gpuschedule_tpu_torch/ops/csrc/overhead_probe.cu"
PROBE_KERNELS = {
    "probe_copy": ("probe_copy_kernel", "tools/overhead_probe.py:54"),
    "probe_matmul": ("probe_xtx_kernel", "tools/overhead_probe.py:58"),
}
PROBE_N, PROBE_BLOCK = 4096, 128  # the probe's largest grid, its tile width
PROFILE_KS = (1, 2, 4, 8, 16, 32, 64)
PROFILE_RTOL = 0.15  # profiled k = 1 step vs phase 6's step: same model, batch, S


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def attention_cost(b, s, h, d, causal, esize, kernel):
    """(flops, bytes) the kernel's function needs on these inputs: each
    input read once, each output written once; causal counts the S(S+1)/2
    (row, key) pairs that are not masked."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    n = b * s * h * d * esize
    rows = b * h * s * 4
    if kernel == "flash_fwd":      # QK^T, PV; reads q k v, writes o and lse
        return 4 * d * pairs, 3 * n + n + rows
    if kernel == "flash_bwd_dq":   # QK^T, dO V^T, ds K; reads q k v dO lse delta, writes dq
        return 6 * d * pairs, 4 * n + 2 * rows + n
    # QK^T, dO V^T, p^T dO, ds^T q; reads q k v dO lse delta, writes dk dv
    return 8 * d * pairs, 4 * n + 2 * rows + 2 * n


def bound(flops, nbytes, peak_flops):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def probe_cost(n, block, kernel):
    """(flops, bytes) of a probe kernel's function over n (8, block) bf16
    tiles: x read once, out written once; K5b forms 8 x block outputs of 8
    products each per tile."""
    nbytes = 2 * (n * 8 * block * 2)
    return (0 if kernel == "probe_copy" else 2 * 8 * 8 * block * n), nbytes


def ptxas_report(log_text: str) -> dict:
    """{mangled kernel name: {"registers", "spill_stores", "spill_loads", "static_smem"}}
    from nvcc's ``-Xptxas -v`` output."""
    out: dict = {}
    name = None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name]["spill_stores"], out[name]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            out[name]["static_smem"] = int(m.group(1))
    return out


def mangled_name(names, kernel: str, d: int):
    """The mangled name among ``names`` of ``kernel`` at head dim ``d``
    (either dtype), or None."""
    for name in names:
        if f"{len(kernel)}{kernel}I" in name and f"Li{d}E" in name:
            return name
    return None


def cuobjdump_path():
    """cuobjdump beside nvcc, on PATH, or the copy Triton bundles; else None."""
    from gpuschedule_tpu_torch.ops import _build

    cands = [Path(_build.nvcc_path()).parent / "cuobjdump", shutil.which("cuobjdump")]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        cands.append(Path(spec.origin).parent / "backends" / "nvidia" / "bin" / "cuobjdump")
    for c in cands:
        if c and Path(c).is_file():
            return str(c)
    return None


def hmma_counts(lib_path: str, tool: str) -> dict:
    """{mangled kernel name: number of HMMA instructions} in the library's SASS."""
    res = subprocess.run([tool, "--dump-sass", lib_path], capture_output=True, text=True,
                         timeout=300)
    check(res.returncode == 0, f"cuobjdump failed: {res.stderr.strip()[:500]}")
    counts: dict = {}
    name = None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts.setdefault(name, 0)
        elif name is not None and "HMMA" in line:
            counts[name] += 1
    return counts


def profile_steps(torch, trainer, state, tokens, steps: int = 2) -> dict:
    """Device time by kernel over ``steps`` train steps (``torch.profiler``):
    per-step ms of the top kernels, their sum, and the busy share of the
    profiled window's wall time (the profiler's own overhead lands in the
    idle share; the caller adds the share of an unprofiled step).
    A failing step fails the run; only a profiler that saw no device
    activity is recorded as a diagnostic instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = trainer.step(state, tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for evt in prof.events():
        # device activity only: GPU-side user annotations (the optimizer's
        # range) overlap the kernels they contain
        if evt.device_type == DeviceType.CUDA and not getattr(evt, "is_user_annotation", False):
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e3
    if not by_name:
        return {"error": "the profiler recorded no device activity"}
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "steps": steps, "wall_ms_per_step": wall_ms / steps,
        "device_ms_per_step": busy / steps, "busy_share": busy / wall_ms,
        "top": [{"kernel": n[:90], "ms_per_step": t / steps, "share": t / busy} for n, t in top],
    }


def probe_parity(torch, dev, sizes) -> dict:
    """Phase 7: both probe kernels in both launch forms against their plain
    versions on seeded (n * 8, 128) bf16 inputs; returns the largest abs
    error of each."""
    from gpuschedule_tpu_torch.ops import overhead_probe as op

    errs = {name: 0.0 for name in PROBE_KERNELS}
    for i, n in enumerate(sizes):
        gen = torch.Generator(device=dev).manual_seed(200 + i)
        x = torch.randn((n * 8, PROBE_BLOCK), generator=gen, device=dev).to(torch.bfloat16)
        ref_c, ref_m = op.probe_copy_plain(x), op.probe_matmul_plain(x)
        for parallel in (False, True):
            c, m = op.probe_copy(x, parallel=parallel), op.probe_matmul(x, parallel=parallel)
            torch.cuda.synchronize()
            e_c = (c.float() - ref_c.float()).abs().max().item()
            e_m = (m.float() - ref_m.float()).abs().max().item()
            ulps = op.bf16_ulps(m, ref_m)
            log(f"probe parity n={n} parallel={parallel}: copy {e_c:.3e} "
                f"(equal {torch.equal(c, ref_c)}) xtx {e_m:.3e} ({ulps:.2f} bf16 ulp)")
            check(torch.equal(c, ref_c), f"the copy kernel disagrees at n={n} parallel={parallel}")
            check(ulps <= 1.0, f"the xtx kernel is {ulps} bf16 ulp off at n={n} parallel={parallel}")
            errs["probe_copy"] = max(errs["probe_copy"], e_c)
            errs["probe_matmul"] = max(errs["probe_matmul"], e_m)
    return errs


def probe_sweeps(torch, dev, n, ms):
    """Phase 8: the overhead probe's four sweeps (its main path, counted),
    then each kernel at n tiles in both forms: CUDA-event ms, device ms per
    launch and the wrapper's host µs per call (``tools/probe_costs.py``),
    beside its plain version, the library call of the same function and the
    bound.  Returns (launches, times, bounds) by kernel."""
    from gpuschedule_tpu_torch.ops import overhead_probe as op
    from gpuschedule_tpu_torch.tools import overhead_probe as probe_tool
    from gpuschedule_tpu_torch.tools.probe_costs import probe_input, wrapper_costs

    op.reset_launches()                           # the probe's main path starts here
    for kernel, name, parallel in probe_tool.SWEEPS:
        probe_tool.sweep(kernel, name, parallel, device=dev)
    launches = dict(op.LAUNCHES)                  # ... and ends here
    log(f"probe sweep launches: {launches}")
    check(all(launches[name] > 0 for name in PROBE_KERNELS),
          f"the probe sweeps did not run every kernel: {launches}")
    costs = wrapper_costs(n)
    x = probe_input(n)
    xt, out = x.view(n, 8, PROBE_BLOCK), torch.empty_like(x)
    yardsticks = {"probe_copy": (op.probe_copy_plain, lambda: out.copy_(x)),
                  "probe_matmul": (op.probe_matmul_plain,
                                   lambda: torch.bmm(xt[:, :, :8].transpose(1, 2), xt))}
    times, bounds = {}, {}
    for name, (plain, library) in yardsticks.items():
        par, seq = costs[name, True], costs[name, False]
        times[name] = {
            "ms": par["ms"], "ms_sequential": seq["ms"],
            "device_ms": par["device_ms"], "device_ms_sequential": seq["device_ms"],
            "host_us": par["host_us"], "host_us_sequential": seq["host_us"],
            "plain_ms": ms(lambda: plain(x)), "library_ms": ms(library),
        }
        check(par["device_ms"] is not None and seq["device_ms"] is not None,
              f"the profiler recorded no device time for {name}")
        flops, nbytes = probe_cost(n, PROBE_BLOCK, name)
        bounds[name] = bound(flops, nbytes, PEAK_BF16_FLOPS)
        t = times[name]
        log(f"time {name} n={n} block={PROBE_BLOCK} bf16: {t['ms']:.5f} ms parallel "
            f"(device {t['device_ms']:.5f} ms a launch, host {t['host_us']:.2f} us a call), "
            f"{t['ms_sequential']:.5f} ms sequential (device {t['device_ms_sequential']:.5f} "
            f"ms, host {t['host_us_sequential']:.2f} us); plain {t['plain_ms']:.5f} ms, "
            f"library {t['library_ms']:.5f} ms, bound {bounds[name][0]:.5f} ms by "
            f"{bounds[name][1]}, {flops / 1e6:.1f} MFLOP, {nbytes / 1e6:.2f} MB")
    return launches, times, bounds


def profile_phase(torch, smi, dense_s, model="transformer-large", batch=16, seq=512,
                  device=None) -> dict:
    """Phase 9: the profile path.  ``profile_model`` fits ``model``'s curve
    into a fresh ``CurveCache``, which must reload with every k, finite
    non-negative theta and a measured k = 1 step within PROFILE_RTOL of
    ``dense_s`` (the same model, batch and sequence length timed by phase
    6); then ``capture_trace`` of 2 steps must write its file."""
    from gpuschedule_tpu_torch.profiler import CurveCache, capture_trace, profile_model

    with tempfile.TemporaryDirectory() as tmp:
        cache_path = os.path.join(tmp, "curves.json")
        t0 = time.perf_counter()
        curve = profile_model(model, batch_size=batch, seq_len=seq, ks=PROFILE_KS,
                              cache=CurveCache(cache_path), device=device)
        profile_s = time.perf_counter() - t0
        reloaded = CurveCache(cache_path).get(model)
        with open(cache_path) as f:
            entry = json.load(f)[model]
        check(reloaded is not None and reloaded.theta == curve.theta,
              "the curve cache does not reload the fitted curve")
        check(all(math.isfinite(t) and t >= 0 for t in curve.theta),
              f"theta is not finite and non-negative: {curve.theta}")
        check(sorted(int(k) for k in entry["points"]) == list(PROFILE_KS),
              f"the cache lacks ks: {sorted(entry['points'])}")
        measured_s = entry["points"]["1"]
        rel = abs(measured_s - dense_s) / dense_s
        check(rel <= PROFILE_RTOL, f"profiled k=1 step {measured_s * 1e3:.3f} ms is {rel:.1%} "
                                   f"off phase 6's {dense_s * 1e3:.3f} ms")
        t0 = time.perf_counter()
        trace = capture_trace(model, os.path.join(tmp, "trace"), batch_size=batch,
                              seq_len=seq, steps=2, device=device)
        trace_s = time.perf_counter() - t0
        check(os.path.isfile(trace) and os.path.getsize(trace) > 0, f"no trace at {trace}")
        with open(trace) as f:
            events = json.load(f).get("traceEvents", [])
        return {
            "model": model, "batch": batch, "seq": seq, "card": smi,
            "theta": list(curve.theta), "source": entry["source"], "points": entry["points"],
            "multislice": entry.get("multislice"), "measured_ms": measured_s * 1e3,
            "dense_step_ms": dense_s * 1e3, "rel_to_dense": rel, "profile_s": profile_s,
            "trace_s": trace_s, "trace_bytes": os.path.getsize(trace),
            "trace_kernel_events": sum(e.get("cat") == "kernel" for e in events),
        }


def run() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: no card to drive")
    try:
        import torch.nn.functional as F

        from gpuschedule_tpu_torch.ops import _build, dense_attention
        from gpuschedule_tpu_torch.ops import overhead_probe as op
        from gpuschedule_tpu_torch.parallel import ShardedTrainer
        from gpuschedule_tpu_torch.profiler import device_ms_per_launch, time_callable, time_steps

        # the module, not the op of the same name that ops/__init__ exports
        fa = importlib.import_module("gpuschedule_tpu_torch.ops.flash_attention")
    except ImportError as e:
        raise SmokeFailure(f"cannot import the port: {e}") from None

    # the plain versions' f32 products are the reference: keep them f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------------- 1 --
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    log(smi)
    dev = torch.device("cuda")

    # ---------------------------------------------------------------- 2 --
    t0 = time.perf_counter()
    fa._kernels()  # builds every csrc/*.cu, one nvcc each, in parallel
    op._kernels()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f} s")
    for stem in ("flash_attention", "overhead_probe"):
        for line in _build.build_log(stem).splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"ptxas: {line.strip()}", file=sys.stderr)
    ptxas = ptxas_report(_build.build_log("flash_attention"))
    hmma = None
    tool = cuobjdump_path()
    if tool is None:
        log("cuobjdump: not found beside nvcc, on PATH or in Triton; no SASS check")
    else:
        hmma = hmma_counts(str(_build.build_all()["flash_attention"]), tool)
    build_report = {}
    for cname in sorted({c for bf, f32, _ in KERNELS.values() for c in (bf, f32)}):
        for d in fa.HEAD_DIMS:
            entry = ptxas.get(mangled_name(ptxas, cname, d), {})
            n_hmma = None if hmma is None else hmma.get(mangled_name(hmma, cname, d))
            build_report[f"{cname}<{d}>"] = {**entry, "hmma": n_hmma}
            log(f"kernel {cname} D={d}: {entry.get('registers')} registers, spill "
                f"{entry.get('spill_stores')}/{entry.get('spill_loads')} bytes "
                f"(stores/loads), {n_hmma} HMMA")
    for cname in TENSOR_CORE_KERNELS:
        for d in fa.HEAD_DIMS:
            rep = build_report[f"{cname}<{d}>"]
            check("registers" in rep, f"ptxas reported nothing for {cname} at D={d}")
            if d in NO_SPILL_HEAD_DIMS:
                check(rep.get("spill_stores", 0) == 0 and rep.get("spill_loads", 0) == 0,
                      f"{cname} spills at D={d}: {rep}")
            if hmma is not None:
                check((rep["hmma"] or 0) > 0, f"{cname} at D={d} has no HMMA in its SASS")
    probe_ptxas = ptxas_report(_build.build_log("overhead_probe"))
    probe_hmma = None if tool is None else hmma_counts(
        str(_build.build_all()["overhead_probe"]), tool)
    lib = op._kernels()
    stages = lib.gst_probe_stages()  # the depth of the kernels' ring
    for name, (cname, _) in PROBE_KERNELS.items():
        entry = probe_ptxas.get(mangled_name(probe_ptxas, cname, PROBE_BLOCK), {})
        n_hmma = None if probe_hmma is None else probe_hmma.get(
            mangled_name(probe_hmma, cname, PROBE_BLOCK))
        smem = {form: lib.gst_probe_smem(int(name == "probe_matmul"), PROBE_N, parallel)
                for form, parallel in (("parallel", 1), ("sequential", 0))}
        build_report[f"{cname}<{PROBE_BLOCK}>"] = {**entry, "hmma": n_hmma, "dynamic_smem": smem}
        log(f"kernel {cname} BLOCK={PROBE_BLOCK}: {entry.get('registers')} registers, spill "
            f"{entry.get('spill_stores')}/{entry.get('spill_loads')} bytes (stores/loads), "
            f"{entry.get('static_smem', 0)} bytes static smem, dynamic smem {smem['parallel']} B "
            f"a block in the parallel form and {smem['sequential']} B in the sequential one "
            f"(STAGES = {stages}), {n_hmma} HMMA")
        check("registers" in entry, f"ptxas reported nothing for {cname}")
        check(entry.get("spill_stores", 0) == 0 and entry.get("spill_loads", 0) == 0,
              f"{cname} spills: {entry}")
    if probe_hmma is not None:
        check((build_report[f"probe_xtx_kernel<{PROBE_BLOCK}>"]["hmma"] or 0) > 0,
              "probe_xtx_kernel has no HMMA in its SASS")

    # ---------------------------------------------------------------- 3 --
    errs = {name: 0.0 for name in KERNELS}
    parity = [  # bf16: the tensor-core kernels; f32: the FMA kernels
        (MAIN_SHAPE, torch.bfloat16, True),
        ((2, 1000, 4, 64), torch.bfloat16, True),
        ((2, 1000, 4, 64), torch.bfloat16, False),
        ((1, 333, 2, 96), torch.bfloat16, True),
        ((1, 200, 3, 128), torch.bfloat16, False),
        ((1, 200, 3, 128), torch.bfloat16, True),
        ((1, 77, 2, 32), torch.bfloat16, True),
        ((1, 77, 2, 32), torch.bfloat16, False),
        ((2, 1000, 4, 64), torch.float32, True),
        ((2, 1000, 4, 64), torch.float32, False),
        ((1, 200, 3, 128), torch.float32, False),
        ((1, 77, 2, 32), torch.float32, True),
    ]
    for i, (shape, dtype, causal) in enumerate(parity):
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(4))
        out, lse = fa.flash_fwd(q, k, v, causal=causal)
        out_p, lse_p = fa.flash_fwd_plain(q, k, v, causal)
        torch.cuda.synchronize()
        e_out = (out.float() - out_p.float()).abs().max().item()
        e_lse = (lse - lse_p).abs().max().item()
        delta = fa.attention_delta(out_p, g)
        dq = fa.flash_bwd_dq(q, k, v, g, lse_p, delta, causal=causal)
        dk, dv = fa.flash_bwd_dkdv(q, k, v, g, lse_p, delta, causal=causal)
        dq_p = fa.flash_bwd_dq_plain(q, k, v, g, lse_p, delta, causal)
        dk_p, dv_p = fa.flash_bwd_dkdv_plain(q, k, v, g, lse_p, delta, causal)
        torch.cuda.synchronize()

        def rel(a, b):
            diff = (a.float() - b.float()).abs().max().item()
            return diff, diff / max(b.float().abs().max().item(), 1e-6)

        (a_dq, r_dq), (a_dk, r_dk), (a_dv, r_dv) = rel(dq, dq_p), rel(dk, dk_p), rel(dv, dv_p)
        log(f"parity {shape} {dtype} causal={causal}: out {e_out:.3e} lse {e_lse:.3e} "
            f"dq {a_dq:.3e} ({r_dq:.2e} rel) dk {a_dk:.3e} ({r_dk:.2e}) dv {a_dv:.3e} ({r_dv:.2e})")
        check(e_out < FWD_TOL and e_lse < LSE_TOL, f"forward kernel disagrees at {shape}")
        check(max(r_dq, r_dk, r_dv) < GRAD_TOL, f"backward kernels disagree at {shape}")
        for name, e in (("flash_fwd", e_out), ("flash_bwd_dq", a_dq),
                        ("flash_bwd_dkdv", max(a_dk, a_dv))):
            errs[name] = max(errs[name], e)

    # the whole op (autograd through the three kernels) against the dense oracle
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=dev).manual_seed(7)
        q, k, v = (torch.randn((2, 1000, 4, 64), generator=gen, device=dev).to(dtype)
                   .requires_grad_(True) for _ in range(3))
        out = fa.flash_attention(q, k, v, causal=True)
        grads = torch.autograd.grad((out.float() ** 2).sum(), (q, k, v))
        ref = dense_attention(q, k, v, causal=True)
        grads_r = torch.autograd.grad((ref.float() ** 2).sum(), (q, k, v))
        e_op = (out.float() - ref.float()).abs().max().item()
        r_op = max((a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
                   for a, b in zip(grads, grads_r))
        log(f"op vs dense oracle (2, 1000, 4, 64) {dtype} causal: out {e_op:.3e} "
            f"grads {r_op:.3e} rel")
        check(e_op < FWD_TOL and r_op < GRAD_TOL,
              f"flash op disagrees with the dense oracle in {dtype}")

    # model level: flash and dense losses of the same init agree
    losses = {}
    for flash in (True, False):
        tr = ShardedTrainer("transformer-long", batch_size=2, seq_len=256, flash_attn=flash)
        st = tr.init(seed=0)
        tok = tr.make_batch(seed=0)
        with torch.no_grad():
            losses[flash] = tr.loss(st.model(tok), tok).item()
        del st
    rel_loss = abs(losses[True] - losses[False]) / abs(losses[False])
    log(f"transformer-long init loss at S=256: flash {losses[True]:.6f} dense "
        f"{losses[False]:.6f} (rel {rel_loss:.2e})")
    check(math.isfinite(losses[True]) and rel_loss < LOSS_RTOL,
          "flash and dense model losses disagree at init")

    # ---------------------------------------------------------------- 4 --
    b, s, h, d = MAIN_SHAPE
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v, g = (torch.randn(MAIN_SHAPE, generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(4))
    out, lse = fa.flash_fwd(q, k, v, causal=True)
    delta = fa.attention_delta(out, g)
    ms = lambda fn, iters=20: time_callable(fn, iters=iters, warmup=3, device=dev) * 1e3  # noqa: E731
    times = {
        "flash_fwd": (ms(lambda: fa.flash_fwd(q, k, v, causal=True)),
                      ms(lambda: fa.flash_fwd_plain(q, k, v, True), 3)),
        "flash_bwd_dq": (ms(lambda: fa.flash_bwd_dq(q, k, v, g, lse, delta, causal=True)),
                         ms(lambda: fa.flash_bwd_dq_plain(q, k, v, g, lse, delta, True), 3)),
        "flash_bwd_dkdv": (ms(lambda: fa.flash_bwd_dkdv(q, k, v, g, lse, delta, causal=True)),
                           ms(lambda: fa.flash_bwd_dkdv_plain(q, k, v, g, lse, delta, True), 3)),
    }
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    sdpa_fwd_ms = ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    gt = g.transpose(1, 2)
    sdpa_bwd_ms = ms(lambda: torch.autograd.grad(o_sdpa, (qt, kt, vt), gt, retain_graph=True))
    library = {"flash_fwd": sdpa_fwd_ms, "flash_bwd_dq": None, "flash_bwd_dkdv": None}
    bounds = {}
    for name in KERNELS:
        flops, nbytes = attention_cost(b, s, h, d, True, 2, name)
        bounds[name] = bound(flops, nbytes, PEAK_BF16_FLOPS)
        k_ms, p_ms = times[name]
        log(f"time {name} {MAIN_SHAPE} bf16 causal: {k_ms:.4f} ms (plain {p_ms:.4f} ms, "
            f"bound {bounds[name][0]:.4f} ms by {bounds[name][1]}, "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)")
    # device time per launch beside the event time: at ~0.1 ms a call the
    # wrapper's host path comes close to the kernel's own time
    device_ms = {}
    for name, fn in (("flash_fwd", lambda: fa.flash_fwd(q, k, v, causal=True)),
                     ("flash_bwd_dq",
                      lambda: fa.flash_bwd_dq(q, k, v, g, lse, delta, causal=True)),
                     ("flash_bwd_dkdv",
                      lambda: fa.flash_bwd_dkdv(q, k, v, g, lse, delta, causal=True))):
        cname = KERNELS[name][0]
        dev_ms, _ = device_ms_per_launch(fn, cname)
        device_ms[name] = dev_ms
        if dev_ms is None:
            log(f"device time {cname}: the profiler recorded no device time for it")
        else:
            ev_ms = times[name][0]
            what = "the host path" if ev_ms > 1.2 * dev_ms else "the kernel"
            log(f"device time {cname} {MAIN_SHAPE} bf16 causal: {dev_ms:.4f} ms per launch "
                f"(profiler) vs {ev_ms:.4f} ms per call (CUDA events): the event time "
                f"measured {what}")
    _, sdpa_kernels = device_ms_per_launch(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), "flash", 1)
    log(f"sdpa forward ran: {sdpa_kernels}")
    bwd_ms = times["flash_bwd_dq"][0] + times["flash_bwd_dkdv"][0]
    bwd_bound = bounds["flash_bwd_dq"][0] + bounds["flash_bwd_dkdv"][0]
    log(f"time sdpa forward {sdpa_fwd_ms:.4f} ms; K2+K3 {bwd_ms:.4f} ms "
        f"(plain {times['flash_bwd_dq'][1] + times['flash_bwd_dkdv'][1]:.4f} ms, "
        f"bound {bwd_bound:.4f} ms) vs sdpa backward {sdpa_bwd_ms:.4f} ms")
    del q, k, v, g, qt, kt, vt, o_sdpa, out, lse, delta

    # ---------------------------------------------------------------- 5 --
    trainer = ShardedTrainer("transformer-long", batch_size=2, seq_len=4096, flash_attn=True)
    state = trainer.init(seed=0)
    tokens = trainer.make_batch(seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()                           # the main path starts here
    losses = []
    for _ in range(3):
        state, loss = trainer.step(state, tokens)
        losses.append(loss.item())
    step_s, state = time_steps(trainer.step, state, tokens, iters=5, repeats=3)
    state, loss = trainer.step(state, tokens)
    losses.append(loss.item())
    launches = dict(fa.LAUNCHES)                  # ... and ends here
    flash_prof = profile_steps(torch, trainer, state, tokens)
    if "device_ms_per_step" in flash_prof:  # busy share of an unprofiled step
        flash_prof["busy_share_of_step"] = flash_prof["device_ms_per_step"] / (step_s * 1e3)
    log(f"flash step profile: {json.dumps(flash_prof)}")
    n_steps = 3 + 5 * 3 + 1
    flash_tps = 2 * 4096 / step_s
    cfg = trainer.cfg
    flash_tflops = cfg.flops_per_token_attn(4096) * 2 * 4096 / step_s / 1e12
    flash_mem = torch.cuda.max_memory_allocated() / 2**30
    log(f"flash train step transformer-long b2 S4096: {step_s * 1e3:.3f} ms/step, "
        f"{flash_tps:.1f} tokens/s, {flash_tflops:.2f} TFLOP/s attention-aware "
        f"(MFU {flash_tflops * 1e12 / PEAK_BF16_FLOPS:.4f} of 989 TF/s), peak "
        f"{flash_mem:.2f} GiB, losses {losses}, launches {launches} over {n_steps} steps")
    check(all(math.isfinite(x) for x in losses), f"non-finite flash train loss: {losses}")
    check(losses[-1] < losses[0], f"flash train loss did not fall: {losses}")
    per_step = {name: launches[name] / n_steps for name in KERNELS}
    check(per_step["flash_fwd"] >= 8 and per_step["flash_bwd_dq"] >= 4
          and per_step["flash_bwd_dkdv"] >= 4,
          f"the train step did not run every kernel: {per_step} per step")
    del state, trainer, tokens
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 6 --
    before = dict(fa.LAUNCHES)
    trainer = ShardedTrainer("transformer-large", batch_size=16, seq_len=512)
    state = trainer.init(seed=0)
    tokens = trainer.make_batch(seed=0)
    dense_losses = []
    for _ in range(3):
        state, loss = trainer.step(state, tokens)
        dense_losses.append(loss.item())
    dense_s, state = time_steps(trainer.step, state, tokens, iters=10, repeats=3)
    dense_tps = 16 * 512 / dense_s
    dense_prof = profile_steps(torch, trainer, state, tokens)
    if "device_ms_per_step" in dense_prof:
        dense_prof["busy_share_of_step"] = dense_prof["device_ms_per_step"] / (dense_s * 1e3)
    log(f"dense step profile: {json.dumps(dense_prof)}")
    dense_mfu = trainer.cfg.flops_per_token() * 16 * 512 / dense_s / PEAK_BF16_FLOPS
    log(f"dense train step transformer-large b16 S512: {dense_s * 1e3:.3f} ms/step, "
        f"{dense_tps:.1f} tokens/s, MFU {dense_mfu:.4f} of 989 TF/s (6N FLOPs) on "
        f"{smi}; losses {dense_losses}")
    check(all(math.isfinite(x) for x in dense_losses), "non-finite dense train loss")
    check(dict(fa.LAUNCHES) == before, "the dense path launched a flash kernel")
    del state, trainer, tokens
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ 7 - 9 --
    probe_errs = probe_parity(torch, dev, (64, PROBE_N, 37, stages + 1))
    probe_launches, probe_times, probe_bounds = probe_sweeps(torch, dev, PROBE_N, ms)
    profile = profile_phase(torch, smi, dense_s)
    print(json.dumps({"profile": profile}))

    # --------------------------------------------------------------- 10 --
    train = {
        "card": smi, "build_s": build_s,
        "flash": {"model": "transformer-long", "batch": 2, "seq": 4096,
                  "step_ms": step_s * 1e3, "tokens_per_s": flash_tps,
                  "tflops_attn_aware": flash_tflops, "peak_gib": flash_mem,
                  "losses": losses, "steps": n_steps, "launches": launches,
                  "profile": flash_prof},
        "dense": {"model": "transformer-large", "batch": 16, "seq": 512,
                  "step_ms": dense_s * 1e3, "tokens_per_s": dense_tps, "mfu": dense_mfu,
                  "profile": dense_prof},
        "build": build_report, "device_ms_per_launch": device_ms,
        "backward": {"ms": bwd_ms, "bound_ms": bwd_bound,
                     "plain_ms": times["flash_bwd_dq"][1] + times["flash_bwd_dkdv"][1],
                     "library_ms": sdpa_bwd_ms},
    }
    kernels = [
        {"name": cname, "f32_kernel": f32_name, "route": "cuda", "source": SOURCE,
         "replaces": replaces, "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": library[name]}
        for name, (cname, f32_name, replaces) in KERNELS.items()
    ] + [
        {"name": cname, "route": "cuda", "source": PROBE_SOURCE, "replaces": replaces,
         "launches": probe_launches[name], "max_abs_err": probe_errs[name],
         **probe_times[name], "bound_ms": probe_bounds[name][0],
         "bound_by": probe_bounds[name][1]}
        for name, (cname, replaces) in PROBE_KERNELS.items()
    ]
    print(json.dumps({"train": train}))
    print(json.dumps({"kernels": kernels}))
    return {"ok": True, "device": {"platform": "gpu", "kind": kind,
                                   "count": torch.cuda.device_count()}}


def main() -> int:
    try:
        result = run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

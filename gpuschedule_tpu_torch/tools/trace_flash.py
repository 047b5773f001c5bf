"""Device time of the flash kernels from a ``torch.profiler`` window.

Counterpart of ``tools/trace_flash.py``, which read the device plane of an
xprof trace because a TPU call's wall time measured its transport.  On the
card CUDA events time a call well (``tools/kernel_bench.py``), and this
tool says where the device time goes: one profiler window of ``ITERS``
calls a case, read from the profiler's events (no trace file), the device
time per call and the six longest device operations by name.  The window
is ``profiler.harness.device_window``'s: a marker kernel in each, a
window that lost its device records taken again and printed.

    python -m gpuschedule_tpu_torch.tools.trace_flash                # on the card
    python -m gpuschedule_tpu_torch.tools.trace_flash --device cpu   # plain versions, no device time

Prints the device line (with ``nvidia-smi``'s name and power limit), then
one JSON line a case: dense fwd+bwd and flash fwd+bwd at (2, 4096, 8, 128)
bf16.  The JAX tool traces three Pallas block pairs; the CUDA kernels have
one tile, 64 x 64 (``tools/kernel_bench.py`` says why).  Off the card the
cases run their plain versions and the device keys are empty ("not measured").
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Optional, Sequence

import torch

from gpuschedule_tpu_torch import resolve_device
from gpuschedule_tpu_torch.ops.flash_attention import TILE
from gpuschedule_tpu_torch.profiler.harness import Record, device_window
from gpuschedule_tpu_torch.tools.kernel_bench import cases, device_line, inputs

ITERS = 10
SHAPE = (2, 4096, 8, 128)
TRACED = ("dense fwd+bwd", f"flash fwd+bwd bq{TILE} bk{TILE}")


def device_times(events: Sequence[Record], iters: int = ITERS) -> dict:
    """The device ms per iteration of one window's device records over
    ``iters`` calls, and its six longest operations by name (names cut to
    48 characters, ms per iteration); an error for a window without one."""
    if not events:
        return {"error": "the window holds no device record"}
    agg = defaultdict(float)
    for e in events:
        agg[e.name] += e.us
    ops = sorted(agg.items(), key=lambda kv: -kv[1])[:6]
    return {
        "device_ms_per_iter": sum(agg.values()) / iters / 1e3,
        "top_device_ops_ms_per_iter": {k[:48]: v / iters / 1e3 for k, v in ops},
    }


def capture_device_record(fn, *args, iters: int = ITERS) -> dict:
    """Warm up outside the window, take one window of ``iters`` calls of
    ``fn(*args)`` and return its :func:`device_times`, with the windows
    lost before it."""
    win = device_window(lambda: fn(*args), iters, what="trace_flash")
    return {**device_times(win.device, iters), "lost_windows": win.lost}


def trace_one(name: str, fn, *args, device: torch.device) -> dict:
    """One case's line: the window on the card; off it the calls run and
    the device keys are empty ("not measured")."""
    if device.type == "cuda":
        rec = capture_device_record(fn, *args, iters=ITERS)
    else:
        for _ in range(ITERS):
            fn(*args)
        rec = {"device_ms_per_iter": None, "top_device_ops_ms_per_iter": {},
               "lost_windows": 0, "note": "not measured: no card"}
    rec = {"case": name, "iters": ITERS, **rec}
    print(json.dumps(rec), flush=True)
    return rec


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Print the device line and each traced case's line; the cases' records."""
    p = argparse.ArgumentParser(prog="python -m gpuschedule_tpu_torch.tools.trace_flash")
    p.add_argument("--device", default=None,
                   help="'cpu' for the plain PyTorch versions; default: the card")
    p.add_argument("--shape", default=",".join(map(str, SHAPE)), help="B,S,H,D")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    print(json.dumps(device_line(dev)), flush=True)
    q, k, v = inputs(*(int(x) for x in args.shape.split(",")), torch.bfloat16, dev)
    calls = cases(q, k, v)
    return [trace_one(name, calls[name][0], device=dev) for name in TRACED]


if __name__ == "__main__":
    main()
    sys.exit(0)

"""Measure the per-step overhead of a kernel launch on the card.

Counterpart of ``tools/overhead_probe.py``, with K5a and K5b as the CUDA
kernels of :mod:`gpuschedule_tpu_torch.ops.overhead_probe`.

Method, as in the original: a kernel whose per-tile work is negligible (a
copy of one (8, 128) bf16 tile; rows 0-7 of the tile's xᵀx) runs at growing
grid sizes, and the slope of time against tiles is the cost of one more
tile, the intercept the fixed cost of a call.  On this card the two launch
forms price different things.  ``parallel=False`` is one thread block that
walks the tiles through a ring of bulk copies, the next tiles in flight
while one is processed, as Mosaic pipelines a sequential grid: its slope is
the pipelined cost of one more tile in one block (what one SM's copy engine
moves per tile, plus the per-tile barrier work), the counterpart of the
original's per-grid-step cost.  ``parallel=True`` is one block per tile: its
slope is the cost of scheduling one more block, and its intercept is mostly
the wrapper's host path.  Times are CUDA events around back-to-back calls
(:func:`~gpuschedule_tpu_torch.profiler.time_callable`), so a call whose
kernel is shorter than the host's launch path is timed at the host's rate;
``tools/probe_costs.py`` splits a call into device and host time.

One JSON line for the device, one per point, then the slope line of each
sweep:

    python -m gpuschedule_tpu_torch.tools.overhead_probe               # on the card
    python -m gpuschedule_tpu_torch.tools.overhead_probe --device cpu  # plain versions
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from gpuschedule_tpu_torch import resolve_device
from gpuschedule_tpu_torch.ops.overhead_probe import probe_copy, probe_matmul
from gpuschedule_tpu_torch.profiler import time_callable

STEPS = (64, 256, 1024, 4096)
# (kernel, name, parallel) of each sweep, in the original's order
SWEEPS = (
    (probe_copy, "copy", False),
    (probe_copy, "copy", True),
    (probe_matmul, "matmul128", False),
    (probe_matmul, "matmul128", True),
)


def run_grid(n_steps: int, *, kernel, block: int = 128, parallel: bool = False,
             device=None) -> float:
    """Time ``kernel`` over an n_steps-tile input; returns seconds per call."""
    dev = resolve_device(device)
    x = torch.ones((n_steps * 8, block), dtype=torch.bfloat16, device=dev)
    return time_callable(lambda: kernel(x, parallel=parallel), iters=10, warmup=2, device=dev)


def sweep(kernel, name: str, parallel: bool, *, device=None) -> float:
    """Time the grid sizes of :data:`STEPS`, print one line per point and
    the fitted slope and intercept; returns the slope in seconds per step."""
    times = []
    for n in STEPS:
        t = run_grid(n, kernel=kernel, parallel=parallel, device=device)
        times.append(t)
        print(json.dumps({
            "probe": name, "parallel": parallel, "grid_steps": n,
            "ms": round(t * 1e3, 4),
        }), flush=True)
    slope, intercept = np.polyfit(STEPS, times, 1)
    print(json.dumps({
        "probe": name, "parallel": parallel,
        "us_per_step": round(slope * 1e6, 4),
        "intercept_ms": round(intercept * 1e3, 4),
    }), flush=True)
    return slope


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m gpuschedule_tpu_torch.tools.overhead_probe")
    p.add_argument("--device", default=None,
                   help="'cpu' for the plain PyTorch versions; default: the card")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({"backend": dev.type, "device": name}), flush=True)
    for kernel, probe, parallel in SWEEPS:
        sweep(kernel, probe, parallel, device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())

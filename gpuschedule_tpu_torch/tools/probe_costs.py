"""What one call of an overhead-probe kernel costs on the card, split into
device time and the wrapper's host path.

    python -m gpuschedule_tpu_torch.tools.probe_costs [--n 4096]

K5a (``probe_copy``) and K5b (``probe_matmul``) of
:mod:`gpuschedule_tpu_torch.ops.overhead_probe`, each in both launch forms
at ``--n`` tiles of (8, 128) bf16, one JSON line each:

- ``ms``: CUDA events around back-to-back calls (the probe tool's timing);
- ``device_ms``: the kernel's device time per launch, from a
  ``torch.profiler`` window of 5 launches;
- ``host_us``: the wrapper's host time per call, ``time.perf_counter_ns``
  over 1,000 calls with no synchronisation, then one;

then one line that splits K5a's parallel call into its host parts (checks,
allocation, the ctypes call that launches the kernel).

The script imports nothing of the port but that module, ``ops._build``,
the profiler's timing helpers and ``cluster.cards`` (the ``nvidia-smi``
line), so it prices another checkout of the port that has them the same way: ``PYTHONPATH=<checkout> python <this file>``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import torch

BLOCK = 128
KERNEL_NAMES = {"probe_copy": "probe_copy_kernel", "probe_matmul": "probe_xtx_kernel"}


def probe_input(n: int, seed: int = 3) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((n * 8, BLOCK), generator=gen, device="cuda").to(torch.bfloat16)


def wrapper_costs(n: int) -> dict:
    """{(wrapper name, parallel): {"ms", "device_ms", "host_us"}} at n tiles."""
    from gpuschedule_tpu_torch.ops import overhead_probe as op
    from gpuschedule_tpu_torch.profiler import device_ms_per_launch, host_us_per_call, time_callable

    x = probe_input(n)
    out = {}
    for name, wrapper in (("probe_copy", op.probe_copy), ("probe_matmul", op.probe_matmul)):
        for parallel in (False, True):
            call = lambda: wrapper(x, parallel=parallel)  # noqa: E731
            ms = time_callable(call, iters=20, warmup=3, device=x.device) * 1e3
            device_ms, _ = device_ms_per_launch(call, KERNEL_NAMES[name])
            out[name, parallel] = {"ms": ms, "device_ms": device_ms,
                                   "host_us": host_us_per_call(call)}
    return out


def host_breakdown(n: int) -> dict:
    """µs per call (as :func:`host_us_per_call`) of the parts of the wrapper's
    host path, beside the whole: the input checks, allocating the output,
    and the launch through ctypes (the C entry point of K5a, parallel form,
    on a stream handle read beforehand)."""
    from gpuschedule_tpu_torch.ops import overhead_probe as op
    from gpuschedule_tpu_torch.profiler import host_us_per_call

    x = probe_input(n)
    out = torch.empty_like(x)
    lib = op._kernels()
    stream = torch.cuda.current_stream().cuda_stream
    return {
        "checks": host_us_per_call(lambda: (op._check_input(x), op._check_cuda(x))),
        "empty_like": host_us_per_call(lambda: torch.empty_like(x)),
        "ctypes_launch": host_us_per_call(
            lambda: lib.gst_probe_copy(x.data_ptr(), out.data_ptr(), n, BLOCK, 1, stream)),
        "wrapper": host_us_per_call(lambda: op.probe_copy(x, parallel=True)),
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m gpuschedule_tpu_torch.tools.probe_costs")
    p.add_argument("--n", type=int, default=4096, help="tiles of (8, 128) bf16")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_costs: no CUDA device; the costs are the card's", file=sys.stderr)
        return 1
    from gpuschedule_tpu_torch.cluster.cards import nvidia_smi_line

    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": nvidia_smi_line()}),
          flush=True)
    for (name, parallel), rec in wrapper_costs(args.n).items():
        print(json.dumps({"kernel": name, "parallel": parallel, "n": args.n, **rec}), flush=True)
    print(json.dumps({"host_us": host_breakdown(args.n), "n": args.n}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

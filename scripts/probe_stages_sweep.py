"""The sweep that chose ``STAGES``, the ring depth of the overhead-probe
kernels (``gpuschedule_tpu_torch/ops/csrc/overhead_probe.cu``).

    PYTHONPATH=. python scripts/probe_stages_sweep.py --stages 8,16,32,64,96 [--n 4096]

``STAGES`` is a constant of the source, not a knob of the library.  This
script builds the source once per value (in a temporary copy of ``csrc/``,
one nvcc each, all started together), checks that each build reports that
depth (``gst_probe_stages``), holds each build against the plain versions
in both launch forms at 37 tiles, at STAGES + 3 and at ``--n`` (K5a
exactly, K5b within one bf16 ulp), and prints one JSON line per value with
each kernel's device ms per launch at ``--n`` tiles in both forms.  It needs
one CUDA card; nothing in the package imports it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, Sequence

import torch

STAGES_LINE = r"constexpr int STAGES = \d+;"


def build_variants(stages: Sequence[int], tmp: Path) -> Dict[int, Path]:
    """{stages: library path} of overhead_probe.cu with STAGES set to each."""
    from gpuschedule_tpu_torch.ops import _build

    src = (_build.CSRC / "overhead_probe.cu").read_text()
    if not re.search(STAGES_LINE, src):
        raise RuntimeError("overhead_probe.cu has no STAGES constant to sweep")
    procs = {}
    for st in stages:
        d = tmp / f"stages{st}"
        shutil.copytree(_build.CSRC, d)
        (d / "overhead_probe.cu").write_text(
            re.sub(STAGES_LINE, f"constexpr int STAGES = {st};", src))
        lib = d / "libprobe.so"
        procs[st] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(d / "overhead_probe.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for st, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed at STAGES={st}:\n{log}")
        libs[st] = lib
    return libs


def sweep(stages: Sequence[int], n: int) -> list:
    """One record per STAGES value: parity in both forms at 37, STAGES + 3
    and n tiles, then each kernel's device ms per launch at n in both forms."""
    from gpuschedule_tpu_torch.ops import overhead_probe as op
    from gpuschedule_tpu_torch.profiler import device_ms_per_launch
    from gpuschedule_tpu_torch.tools.probe_costs import BLOCK, KERNEL_NAMES, probe_input

    records = []
    with tempfile.TemporaryDirectory() as tmp:
        for st, path in build_variants(stages, Path(tmp)).items():
            lib = ctypes.CDLL(str(path))
            if lib.gst_probe_stages() != st:
                raise RuntimeError(f"the build for STAGES={st} reports {lib.gst_probe_stages()}")
            p, i = ctypes.c_void_p, ctypes.c_int
            fns = {"probe_copy": lib.gst_probe_copy, "probe_matmul": lib.gst_probe_xtx}
            for fn in fns.values():
                fn.argtypes = [p, p, i, i, i, p]
                fn.restype = ctypes.c_int

            def launch(name, x, out, parallel):
                rc = fns[name](x.data_ptr(), out.data_ptr(), x.shape[0] // 8, BLOCK,
                               int(parallel), torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name} at STAGES={st} returned {rc}")

            rec = {"stages": st, "n": n}
            for size in sorted({37, st + 3, n}):
                x = probe_input(size, seed=size)
                for parallel in (False, True):
                    c, m = torch.empty_like(x), torch.empty_like(x)
                    launch("probe_copy", x, c, parallel)
                    launch("probe_matmul", x, m, parallel)
                    torch.cuda.synchronize()
                    if not torch.equal(c, op.probe_copy_plain(x)):
                        raise RuntimeError(f"copy disagrees at STAGES={st} n={size}")
                    ulps = op.bf16_ulps(m, op.probe_matmul_plain(x))
                    if not ulps <= 1.0:
                        raise RuntimeError(f"xtx {ulps} ulp off at STAGES={st} n={size}")
            x = probe_input(n, seed=3)
            out = torch.empty_like(x)
            for name in fns:
                for parallel in (False, True):
                    ms, _ = device_ms_per_launch(lambda: launch(name, x, out, parallel),
                                                 KERNEL_NAMES[name])
                    rec[f"{name}_{'parallel' if parallel else 'sequential'}_device_ms"] = ms
            records.append(rec)
    return records


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python scripts/probe_stages_sweep.py")
    p.add_argument("--stages", required=True, help="comma-separated STAGES values")
    p.add_argument("--n", type=int, default=4096, help="tiles of (8, 128) bf16")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_stages_sweep: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": smi}), flush=True)
    for rec in sweep([int(s) for s in args.stages.split(",")], args.n):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

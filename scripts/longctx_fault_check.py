"""Whether chip_smoke.py's parity check at the long-context shape sees a
fault confined to late tiles.

    PYTHONPATH=. python scripts/longctx_fault_check.py

At (B, S, H, D) = (1, 32768, 8, 64), bf16, causal, the attention output of
late rows is ~sqrt(e / S) in size and the gradients of late keys sum over
few rows, both far below the largest entries of their tensors.  This
script plants one fault in each tensor-core kernel of
``gpuschedule_tpu_torch/ops/csrc/flash_attention.cu``, each confined to the
last 8 of 512 tiles, builds each faulty source (in a temporary copy of
``csrc/``, one nvcc each, all started together), and runs
``chip_smoke.parity_errors`` on the sound library and on each faulty one
with the same inputs as chip_smoke's phase 10.  One JSON line each: the
readings, and which bounds they break — chip_smoke's max-abs bounds
(``FWD_TOL``, ``LSE_TOL``, ``GRAD_TOL`` of the largest entry) and its
64-row tile bound (``TILE_RTOL``).  Exits 0 if the sound build passes every
bound and every fault breaks the tile bound.  It needs one CUDA card;
nothing in the package imports it.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

# name -> (the kernel's definition, a line of its body, what follows that line)
FAULTS = {
    # the last 8 row tiles take no P.V from their last 8 key tiles; l, so lse, keeps them
    "fwd_late_pv": ("\nfwd_mma_kernel(", "s[nb][e] = p;",
                    "if (qi >= nq - 8 && j >= ntiles - 8) s[nb][e] = 0.f;"),
    # the last 8 row tiles take no ds.K from their last 8 key tiles
    "dq_late_keys": ("\ndq_mma_kernel(", "a_from_c(da, dp[2 * kq], dp[2 * kq + 1]);",
                     "if (qi >= nq - 8 && j >= ntiles - 8) da[0] = da[1] = da[2] = da[3] = 0u;"),
    # the last 8 key tiles take no p^T.dO from their diagonal row tile
    "dv_late_keys": ("\ndkdv_mma_kernel(", "a_from_c(pa, p[2 * kq], p[2 * kq + 1]);",
                     "if (kb >= (S + BK - 1) / BK - 8 && j == 0) pa[0] = pa[1] = pa[2] = pa[3] = 0u;"),
}


def build_faults(tmp: Path) -> dict:
    """{fault: library path} of flash_attention.cu with each fault planted."""
    from gpuschedule_tpu_torch.ops import _build

    src = (_build.CSRC / "flash_attention.cu").read_text()
    procs = {}
    for name, (kernel, line, fault) in FAULTS.items():
        at = src.index(kernel)
        at = src.index(line, at) + len(line)
        d = tmp / name
        shutil.copytree(_build.CSRC, d)
        (d / "flash_attention.cu").write_text(f"{src[:at]} {fault}{src[at:]}")
        lib = d / "libflash.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(d / "flash_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = lib
    return libs


def verdict(errs: dict) -> dict:
    """The bounds of chip_smoke's parity check that ``errs`` breaks."""
    grads = ("dq", "dk", "dv")
    return {
        "max_abs_bounds_broken": (errs["out"]["abs"] >= chip_smoke.FWD_TOL
                                  or errs["lse"] >= chip_smoke.LSE_TOL
                                  or max(errs[g]["rel"] for g in grads) >= chip_smoke.GRAD_TOL),
        "tile_bound_broken": max(errs[t]["tile"] for t in ("out", *grads)) >= chip_smoke.TILE_RTOL,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("longctx_fault_check: no CUDA device", file=sys.stderr)
        return 1
    from gpuschedule_tpu_torch.ops import _build

    fa = importlib.import_module("gpuschedule_tpu_torch.ops.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": smi}), flush=True)
    dev = torch.device("cuda")
    args = (chip_smoke.LONGCTX_SHAPE, torch.bfloat16, True, 400)  # phase 10's inputs
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"sound": None, **build_faults(Path(tmp))}
        for name, path in libs.items():
            if path is not None:  # the wrappers load this build in place of the sound one
                _build._loaded["flash_attention"] = ctypes.CDLL(str(path))
                fa._lib = None
            errs = chip_smoke.parity_errors(torch, fa, dev, *args)
            v = verdict(errs)
            ok &= (not any(v.values())) if name == "sound" else v["tile_bound_broken"]
            print(json.dumps({"build": name, **v, "errors": errs}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

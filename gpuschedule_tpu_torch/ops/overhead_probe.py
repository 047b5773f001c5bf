"""Overhead-probe kernels: hand-written CUDA kernels and their plain PyTorch versions.

Counterpart of the kernel half of ``tools/overhead_probe.py``.  Two kernels,
each behind a wrapper that launches it for CUDA tensors and runs its plain
version for CPU tensors:

=====================  =====================  ===============================
wrapper                CUDA kernel            replaces (Pallas TPU kernel)
=====================  =====================  ===============================
:func:`probe_copy`     ``probe_copy_kernel``  ``_copy_kernel`` (:54-55)
:func:`probe_matmul`   ``probe_xtx_kernel``   ``_matmul_kernel`` (:58-61)
=====================  =====================  ===============================

``x`` is ``(n * 8, block)`` bf16: n tiles of (8, block), one per grid step
of the Pallas call.  ``parallel`` picks the kernel's launch form (see the
header of ``csrc/overhead_probe.cu``): False, one thread block walks the n
tiles in order through a ring of bulk copies that keeps the next tiles in
flight, as Mosaic pipelines the TPU's sequential grid; True, one block per
tile (the TPU's ``dimension_semantics=("parallel",)``).  The function
computed, and so the plain version, does not depend on it.

The kernels are built by ``nvcc`` at first use (:mod:`._build`) and called
through ctypes on PyTorch's current stream of the tensor's device.  The
launch path is kept short, since at n = 4096 tiles a launch costs the host
about as long as the kernel runs: the C entry points are resolved once,
the stream handle is read in one call, and a device context is entered
only when ``x`` lies off the current device.  For a CUDA tensor a wrapper
launches its kernel or raises: no fallback.  Each wrapper counts its
launches in :data:`LAUNCHES`.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Callable, Dict, Optional

import torch

from gpuschedule_tpu_torch.ops import _build, launches

ROWS = 8             # rows of one tile: the TPU's (8, 128) tiling
BLOCKS = (128,)      # block widths the CUDA kernels are built for

# Launches of each CUDA kernel, counted by its wrapper where it launches.
LAUNCHES: Dict[str, int] = launches.counter("probe_copy", "probe_matmul")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_lib: Optional[ctypes.CDLL] = None
_entries: Dict[str, Callable[..., int]] = {}  # wrapper name -> its C entry point
_SAME_DEVICE = contextlib.nullcontext()


def _kernels() -> ctypes.CDLL:
    """The built kernel library, with its C signatures declared."""
    global _lib
    if _lib is None:
        lib = _build.load("overhead_probe")
        p, i = ctypes.c_void_p, ctypes.c_int
        for name, fn in (("probe_copy", lib.gst_probe_copy), ("probe_matmul", lib.gst_probe_xtx)):
            fn.argtypes = [p, p, i, i, i, p]  # x, out, n, block, parallel, stream
            fn.restype = ctypes.c_int
            _entries[name] = fn
        lib.gst_probe_smem.argtypes = [i, i, i]  # kernel (0 copy, 1 xtx), n, parallel
        lib.gst_error_string.argtypes = [i]
        lib.gst_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_input(x: torch.Tensor) -> int:
    """The probe's input: bf16 of shape (n * 8, block).  Returns n."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the probe takes bf16, got {x.dtype}")
    shape = x.shape
    if len(shape) != 2 or shape[0] % ROWS or shape[1] < ROWS:
        raise ValueError(f"expected (n * {ROWS}, block >= {ROWS}), got {tuple(shape)}")
    return shape[0] // ROWS


def _check_cuda(x: torch.Tensor) -> int:
    """What the CUDA kernels take beyond :func:`_check_input`.  Returns
    ``x.data_ptr()``."""
    if not x.is_contiguous():
        raise ValueError("the CUDA kernels take contiguous tensors")
    if x.shape[1] not in BLOCKS:
        raise ValueError(f"the CUDA kernels are built for blocks {BLOCKS}; got {x.shape[1]}")
    ptr = x.data_ptr()
    if ptr % 16:
        raise ValueError("the CUDA kernels copy 16-byte aligned tiles: x must be 16-byte aligned")
    return ptr


def _run(name: str, x: torch.Tensor, parallel: bool) -> torch.Tensor:
    n = _check_input(x)
    ptr = _check_cuda(x)
    out = torch.empty_like(x)
    if n:
        lib = _lib or _kernels()
        index = x.device.index
        # one call each into PyTorch's C API: the public calls build a Stream object, or
        # check CUDA's initialisation first
        with _SAME_DEVICE if index == torch._C._cuda_getDevice() else torch.cuda.device(index):
            _build.launch(lib, _entries[name], ptr, out.data_ptr(), n, x.shape[1],
                          int(parallel), torch._C._cuda_getCurrentRawStream(index))
        LAUNCHES[name] += 1
    return out


# ----------------------------------------------------------------- K5a --

def probe_copy_plain(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def probe_copy(x: torch.Tensor, *, parallel: bool) -> torch.Tensor:
    """A copy of x, one (8, block) tile per grid step."""
    if x.device.type != "cuda":
        _check_input(x)
        return probe_copy_plain(x)
    return _run("probe_copy", x, parallel)


# ----------------------------------------------------------------- K5b --

def probe_matmul_plain(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[0] // ROWS
    t = x.float().view(n, ROWS, x.shape[1])
    out = torch.einsum("nri,nrj->nij", t[:, :, :ROWS], t)
    return out.to(torch.bfloat16).view(x.shape)


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| over the bf16 spacing at max(|a|, |b|), elementwise
    (NaN if either holds one): K5b's bound against its plain version is 1."""
    a, b = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    return ((a - b).abs() / torch.ldexp(torch.ones_like(a), e - 8)).max().item()


def probe_matmul(x: torch.Tensor, *, parallel: bool) -> torch.Tensor:
    """Per (8, block) tile, rows 0-7 of its xᵀx: ``out[i, j] = Σ_r x[r, i]·x[r, j]``
    for i < 8, in f32, rounded to bf16."""
    if x.device.type != "cuda":
        _check_input(x)
        return probe_matmul_plain(x)
    return _run("probe_matmul", x, parallel)

"""Build the CUDA sources in ``csrc/`` at first use and load them with ctypes.

Each ``csrc/*.cu`` becomes one shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` into ``ops/build/`` (listed in
``.gitignore``).  Libraries are keyed by a hash of the sources and flags,
so an edited source rebuilds and an unchanged one loads at once.  All
sources are compiled in parallel, one ``nvcc`` each.  A failed build raises
with the compiler's output: there is no fallback.

Nothing here runs at import time; the CPU tests import this module without
a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "cannot be built"
    )


def _digest(src: Path) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(src: Path) -> Path:
    return BUILD_DIR / f"{src.stem}-{_digest(src)}.so"


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` whose library is missing, all at once.

    Returns ``{stem: library path}``.  The compiler's report (registers,
    shared memory, spills from ``-Xptxas=-v``) is kept beside each library
    as ``<library>.log``."""
    sources = sorted(CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {s.stem: _lib_path(s) for s in sources}
    todo = [s for s in sources if not out[s.stem].exists()]
    if not todo:
        return out
    nvcc = nvcc_path()
    procs = []
    for src in todo:
        lib = out[src.stem]
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failures = []
    for src, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{src.name}: nvcc exited {proc.returncode}\n{log}")
            continue
        lib.with_suffix(".so.log").write_text(log)
        os.replace(tmp, lib)  # atomic: a concurrent builder sees all or nothing
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return out


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (building all
    sources first if any is missing)."""
    lib = _loaded.get(stem)
    if lib is None:
        paths = build_all()
        if stem not in paths:
            raise RuntimeError(f"no source csrc/{stem}.cu")
        lib = ctypes.CDLL(str(paths[stem]))
        _loaded[stem] = lib
    return lib


def launch(lib: ctypes.CDLL, fn, *args) -> None:
    """Call the C entry point ``fn`` of ``lib``; a non-zero return (a
    refused launch, an unsupported shape) raises with the library's
    ``gst_error_string`` for it."""
    rc = fn(*args)
    if rc != 0:
        msg = lib.gst_error_string(rc).decode()
        raise RuntimeError(f"{fn.__name__} failed: {msg} (code {rc})")


def build_log(stem: str) -> str:
    """The compiler's report for ``csrc/<stem>.cu``, once it was built here."""
    p = _lib_path(CSRC / f"{stem}.cu").with_suffix(".so.log")
    return p.read_text() if p.exists() else ""

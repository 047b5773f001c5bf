"""The overhead-probe kernels' CUDA source, compiled by g++ against a host
emulation of the device features it uses, held against the plain PyTorch
versions on the CPU.

There is no nvcc here, so the kernels themselves run only on the card
(``chip_smoke.py``).  These tests compile the very source that nvcc builds,
``gpuschedule_tpu_torch/ops/csrc/overhead_probe.cu`` cut before its
launchers, with ``tests/cuda_emu/`` standing in for the CUDA headers,
``mma_bf16.cuh`` and ``bulk_copy.cuh``: mbarriers with transaction counts,
bulk loads that fill their destination with NaN when issued and land only
when a thread waits for them, bulk stores that read shared memory only when
``wait_read`` retires them, ldmatrix, mma.sync, and a
block's threads as coroutines (a deadlock returns -2, a misused instruction
or a store in flight at exit -3).  So they check the ring's parity, its
transaction counts, the reuse of its stages and the fragment layouts, in
both launch forms; they say nothing of speed.

Tolerances are ``chip_smoke.py``'s: the copy exactly, the xᵀx rows within
one bf16 ulp (the tensor core sums the 8 exact products in another order
than the plain version).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from gpuschedule_tpu_torch.ops import overhead_probe as op

ROOT = Path(__file__).resolve().parents[1]
EMU = ROOT / "tests" / "cuda_emu"
SOURCE = ROOT / "gpuschedule_tpu_torch" / "ops" / "csrc" / "overhead_probe.cu"
LAUNCHERS = "// ------------------------------------------------------------- launchers --"
BLOCK = 128
# n tiles: a single tile, fewer than the ring depth STAGES, more than STAGES,
# and (None) 3 * STAGES + 5, which wraps the ring three times and ends
# part-way through it
SIZES = (1, 5, 37, None)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernels built for the host: a ctypes library with
    ``emu_probe_copy``, ``emu_probe_xtx`` and ``emu_bulk_selfcheck``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulated kernels")
    src = SOURCE.read_text()
    assert LAUNCHERS in src, "the kernel source lost its launchers marker"
    out = tmp_path_factory.mktemp("cuda_emu_probe")
    tu = out / "overhead_probe_emu.cpp"
    # the cut leaves the kernels' anonymous namespace open: close it
    tu.write_text(src[:src.index(LAUNCHERS)] + "}  // namespace\n"
                  + (EMU / "harness.inc").read_text())
    lib = out / "libprobe_emu.so"
    res = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-DEMU_PROBE", f"-I{EMU}",
         "-o", str(lib), str(tu)],
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    emu = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (emu.emu_probe_copy, emu.emu_probe_xtx):
        fn.argtypes = [p, p, i, i, i]
    emu.emu_bulk_selfcheck.argtypes = [i, p]
    emu.emu_fault_string.restype = ctypes.c_char_p
    assert 37 > emu.emu_probe_stages() > 5
    return emu


@pytest.mark.parametrize("parallel", [False, True], ids=["sequential", "parallel"])
@pytest.mark.parametrize("n", SIZES, ids=["1", "5", "37", "3xSTAGES+5"])
def test_emulated_probe_kernels_match_plain(emulated, n, parallel):
    """``probe_copy_kernel`` exactly and ``probe_xtx_kernel`` within one bf16
    ulp of ``probe_copy_plain`` and ``probe_matmul_plain``, on a seeded input;
    outputs start as NaN, so a tile never stored fails."""
    n = n or 3 * emulated.emu_probe_stages() + 5
    a = np.random.default_rng(n).standard_normal((n * 8, BLOCK)).astype(np.float32)
    x = torch.from_numpy(a).to(torch.bfloat16)
    for fn, plain in ((emulated.emu_probe_copy, op.probe_copy_plain),
                      (emulated.emu_probe_xtx, op.probe_matmul_plain)):
        out = torch.full_like(x, float("nan"))
        rc = fn(x.data_ptr(), out.data_ptr(), n, BLOCK, int(parallel))
        assert rc == 0, (rc, emulated.emu_fault_string().decode())
        ref = plain(x)
        if plain is op.probe_copy_plain:
            assert torch.equal(out, ref)
        else:
            assert op.bf16_ulps(out, ref) <= 1.0


@pytest.mark.parametrize("which, rc", [(0, -2), (1, -3), (2, 0)],
                         ids=["short-load-deadlocks", "store-in-flight-at-exit",
                              "load-lands-at-its-wait"])
def test_emulated_bulk_copies_are_held_back(emulated, which, rc):
    """The emulation's own rules: a wait whose barrier expects more bytes
    than are copied never completes (-2); a block that exits with a bulk
    store unread is a fault (-3); a load has left NaN bytes, not its data,
    before its wait and has landed after it (the check flips the first byte
    of the tile when it passes)."""
    g = torch.arange(2048, dtype=torch.int32).to(torch.uint8)
    first = g[0].item()
    assert emulated.emu_bulk_selfcheck(which, g.data_ptr()) == rc
    if which == 2:
        assert g[0].item() == first ^ 0xff


def test_bf16_ulps_counts_the_spacing_at_the_larger_value():
    """K5b's tolerance measure: one bf16 ulp at 1.0 is 2^-7, at 2.0 it is
    2^-6; a NaN in either tensor is never within the bound."""
    one = torch.tensor([1.0, 2.0])
    assert op.bf16_ulps(one, one) == 0.0
    assert op.bf16_ulps(one, one + torch.tensor([2.0 ** -7, 0.0])) == 1.0
    assert op.bf16_ulps(one, one + torch.tensor([0.0, 2.0 ** -5])) == 2.0
    assert not op.bf16_ulps(one, torch.tensor([1.0, float("nan")])) <= 1.0

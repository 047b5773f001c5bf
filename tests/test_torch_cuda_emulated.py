"""The tensor-core flash kernels' CUDA source, compiled by g++ against a host
emulation of the device features it uses, held against the plain PyTorch
versions on the CPU.

There is no nvcc here, so the kernels themselves run only on the card
(``chip_smoke.py``).  These tests compile the very source that nvcc builds,
``gpuschedule_tpu_torch/ops/csrc/flash_attention.cu`` cut before its
launchers, with ``tests/cuda_emu/`` standing in for the CUDA headers and for
``mma_bf16.cuh``: cp.async (held back until its group is waited on),
ldmatrix, mma.sync m16n8k16, shuffles and barriers, a block's threads run
as coroutines on one OS thread (a deadlock at a barrier returns -2).  So
they check the kernels' indexing, fragment layouts, masking and pipeline
order at small shapes; they say nothing of speed.

Tolerances are ``chip_smoke.py``'s for the card (the kernels' products run
in another order than the plain versions' matmuls): 2e-2 absolute on the
output, 1e-3 on lse, 2e-2 of the largest entry on dq, dk and dv.  The f32
output form of each kernel (the ring's chunk form) is held to the same
bounds against the plain versions' f32 outputs, and, rounded to bf16, to
the bf16 form bit for bit: the two differ only in the epilogue's store.
"""

import ctypes
import importlib
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

fa = importlib.import_module("gpuschedule_tpu_torch.ops.flash_attention")

ROOT = Path(__file__).resolve().parents[1]
EMU = ROOT / "tests" / "cuda_emu"
SOURCE = ROOT / "gpuschedule_tpu_torch" / "ops" / "csrc" / "flash_attention.cu"
LAUNCHERS = "// ------------------------------------------------------------- launchers --"

CASES = [
    pytest.param((1, 100, 2, 32), True, id="d32-ragged-causal"),
    pytest.param((1, 100, 2, 32), False, id="d32-ragged-noncausal"),
    pytest.param((2, 128, 1, 64), True, id="d64-aligned-causal"),
    pytest.param((1, 77, 1, 96), False, id="d96-ragged-noncausal"),
    pytest.param((1, 150, 1, 128), True, id="d128-ragged-causal"),
]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernels built for the host: a ctypes library with
    ``emu_flash_fwd``, ``emu_flash_bwd_dkdv`` and ``emu_flash_bwd_dq``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulated kernels")
    src = SOURCE.read_text()
    assert LAUNCHERS in src, "the kernel source lost its launchers marker"
    out = tmp_path_factory.mktemp("cuda_emu")
    tu = out / "flash_attention_emu.cpp"
    # the cut leaves the kernels' anonymous namespace open: close it
    tu.write_text(src[:src.index(LAUNCHERS)] + "}  // namespace\n"
                  + (EMU / "harness.inc").read_text())
    lib = out / "libflash_emu.so"
    res = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", f"-I{EMU}",
         "-o", str(lib), str(tu)],
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    emu = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # B, S, H, D, scale, causal, out_f32
    emu.emu_flash_fwd.argtypes = [p] * 5 + [i, i, i, i, f, i, i]
    emu.emu_flash_bwd_dkdv.argtypes = [p] * 8 + [i, i, i, i, f, i, i]
    emu.emu_flash_bwd_dq.argtypes = [p] * 7 + [i, i, i, i, f, i, i]
    return emu


def _run_emulated(emu, q, k, v, g, causal, out_dtype):
    """(out, lse, dq, dk, dv) of the three emulated kernels with outputs in
    ``out_dtype``; the backward takes the plain forward's lse and delta, as
    on the card."""
    b, s, h, d = q.shape
    scale, f32 = d ** -0.5, int(out_dtype == torch.float32)
    out, lse = torch.empty_like(q, dtype=out_dtype), torch.empty(b * h, s)
    assert emu.emu_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                             lse.data_ptr(), b, s, h, d, scale, int(causal), f32) == 0
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, causal)
    delta = fa.attention_delta(out_p, g)
    dq, dk, dv = (torch.empty_like(q, dtype=out_dtype) for _ in range(3))
    assert emu.emu_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse_p.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b, s, h, d, scale, int(causal), f32) == 0
    assert emu.emu_flash_bwd_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse_p.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, h, d, scale, int(causal),
        f32) == 0
    return out, lse, dq, dk, dv


@pytest.mark.parametrize("shape,causal", CASES)
def test_emulated_tensor_core_kernels_match_plain(emulated, shape, causal):
    """``fwd_mma_kernel`` and ``dkdv_mma_kernel`` (bf16) against
    ``flash_fwd_plain`` and ``flash_bwd_dkdv_plain`` on the same inputs; the
    backward takes the plain forward's lse, as on the card."""
    b, s, h, d = shape
    gen = torch.Generator().manual_seed(s + d)
    q, k, v, g = (torch.randn(shape, generator=gen).to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5

    out, lse = torch.empty_like(q), torch.empty(b * h, s)
    assert emulated.emu_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                  lse.data_ptr(), b, s, h, d, scale, int(causal), 0) == 0
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, causal)
    assert (out.float() - out_p.float()).abs().max().item() < 2e-2
    assert (lse - lse_p).abs().max().item() < 1e-3

    delta = fa.attention_delta(out_p, g)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    assert emulated.emu_flash_bwd_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse_p.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, h, d, scale, int(causal),
        0) == 0
    dk_p, dv_p = fa.flash_bwd_dkdv_plain(q, k, v, g, lse_p, delta, causal)
    for got, ref in ((dk, dk_p), (dv, dv_p)):
        rel = (got.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
        assert rel < 2e-2, rel


@pytest.mark.parametrize("shape,causal", CASES)
def test_emulated_dq_kernel_matches_plain(emulated, shape, causal):
    """``dq_mma_kernel`` (bf16) against ``flash_bwd_dq_plain`` on the same
    inputs and the plain forward's lse and delta, as on the card: within
    2e-2 of the plain version's largest entry (``chip_smoke.py``'s
    ``GRAD_TOL``; ds is rounded to bf16 at the same point in both, the
    products' sums run in another order)."""
    b, s, h, d = shape
    gen = torch.Generator().manual_seed(s + d)
    q, k, v, g = (torch.randn(shape, generator=gen).to(torch.bfloat16) for _ in range(4))
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, causal)
    delta = fa.attention_delta(out_p, g)
    dq = torch.empty_like(q)
    assert emulated.emu_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse_p.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b, s, h, d, d ** -0.5, int(causal), 0) == 0
    dq_p = fa.flash_bwd_dq_plain(q, k, v, g, lse_p, delta, causal)
    rel = (dq.float() - dq_p.float()).abs().max().item() / dq_p.float().abs().max().item()
    assert rel < 2e-2, rel


@pytest.mark.parametrize("shape,causal", CASES)
def test_emulated_f32_output_forms_match_plain(emulated, shape, causal):
    """The f32-output forms of ``fwd_mma_kernel``, ``dq_mma_kernel`` and
    ``dkdv_mma_kernel`` (bf16 inputs, the ring's chunk form) against the
    plain versions with ``out_dtype=torch.float32``, within the bounds
    above; and each output rounded to bf16 equals the bf16 form's bit for
    bit, since only the epilogue's store differs."""
    gen = torch.Generator().manual_seed(shape[1] + shape[3])
    q, k, v, g = (torch.randn(shape, generator=gen).to(torch.bfloat16) for _ in range(4))
    out, lse, dq, dk, dv = _run_emulated(emulated, q, k, v, g, causal, torch.float32)
    for t in (out, dq, dk, dv):
        assert t.dtype == torch.float32

    out_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, out_dtype=torch.float32)
    assert out_p.dtype == torch.float32
    assert (out - out_p).abs().max().item() < 2e-2
    assert (lse - lse_p).abs().max().item() < 1e-3
    delta = fa.attention_delta(fa.flash_fwd_plain(q, k, v, causal)[0], g)
    refs = (fa.flash_bwd_dq_plain(q, k, v, g, lse_p, delta, causal, out_dtype=torch.float32),
            *fa.flash_bwd_dkdv_plain(q, k, v, g, lse_p, delta, causal, out_dtype=torch.float32))
    for got, ref in zip((dq, dk, dv), refs):
        assert ref.dtype == torch.float32
        rel = (got - ref).abs().max().item() / ref.abs().max().item()
        assert rel < 2e-2, rel

    bf16 = _run_emulated(emulated, q, k, v, g, causal, torch.bfloat16)
    for wide, narrow in zip((out, lse, dq, dk, dv), bf16):
        assert torch.equal(wide.to(narrow.dtype), narrow)

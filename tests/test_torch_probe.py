"""Port parity for the overhead probe: the plain versions of K5a and K5b
(``gpuschedule_tpu_torch.ops.overhead_probe``) against the Pallas kernels of
``tools/overhead_probe.py`` on the CPU, the wrappers' CPU path and input
checks, and the port's probe tool.

The Pallas kernels run through ``pl.pallas_call(..., interpret=True)`` with
``run_grid``'s specs on the same seeded bf16 input as the port.  Both sides
compute in f32 from bf16 operands (each product exact) and round once to
bf16, so the copy and the xᵀx rows must match exactly.  The CUDA kernels are
held against these plain versions on the card by ``chip_smoke.py``.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from gpuschedule_tpu_torch.ops import overhead_probe as op  # noqa: E402
from gpuschedule_tpu_torch.tools import overhead_probe as tool  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("jax_overhead_probe", ROOT / "tools" / "overhead_probe.py")
jax_probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_probe)

BLOCK = 128


def _inputs(n, seed=0):
    """A seeded (n * 8, BLOCK) bf16 array, as (jax array, torch tensor) of
    the very same values."""
    a = np.random.default_rng(seed).standard_normal((n * 8, BLOCK)).astype(np.float32)
    j = jnp.asarray(a).astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)
    return j, t


def _pallas(kernel, x):
    """``run_grid``'s pallas_call (tools/overhead_probe.py:70-78), interpreted."""
    n = x.shape[0] // 8
    return pl.pallas_call(
        kernel,
        grid=(n,),
        in_specs=[pl.BlockSpec((8, BLOCK), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((8, BLOCK), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=True,
    )(x)


@pytest.mark.parametrize("n", [1, 16])
@pytest.mark.parametrize("kernel, plain", [
    ("_copy_kernel", op.probe_copy_plain),
    ("_matmul_kernel", op.probe_matmul_plain),
], ids=["copy", "matmul"])
def test_plain_versions_match_pallas_kernels(kernel, plain, n):
    jx, tx = _inputs(n, seed=n)
    ref = np.asarray(_pallas(getattr(jax_probe, kernel), jx).astype(jnp.float32))
    out = plain(tx)
    assert out.dtype == torch.bfloat16 and out.shape == tx.shape
    np.testing.assert_array_equal(out.float().numpy(), ref)


@pytest.mark.parametrize("parallel", [False, True])
def test_wrappers_take_the_plain_versions_on_cpu(parallel):
    """On CPU tensors the wrappers return the plain versions and launch
    nothing; the launch form does not change the function."""
    _, x = _inputs(5, seed=3)
    before = dict(op.LAUNCHES)
    assert torch.equal(op.probe_copy(x, parallel=parallel), x)
    assert torch.equal(op.probe_matmul(x, parallel=parallel), op.probe_matmul_plain(x))
    assert op.LAUNCHES == before


def test_input_checks():
    """What the wrappers refuse on any device, and what the CUDA kernels
    refuse beyond it (the checks read no device, so they run here)."""
    _, x = _inputs(2)
    with pytest.raises(TypeError, match="bf16"):
        op.probe_copy(x.float(), parallel=True)
    for bad in (x[:12], x.reshape(-1), x[:, :4]):
        with pytest.raises(ValueError, match="expected"):
            op.probe_matmul(bad, parallel=False)
    op._check_cuda(x)
    with pytest.raises(ValueError, match="contiguous"):
        op._check_cuda(x.t().contiguous().t())
    with pytest.raises(ValueError, match="built for blocks"):
        op._check_cuda(torch.zeros(16, 64, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="aligned"):
        op._check_cuda(torch.zeros(16 * BLOCK + 1, dtype=torch.bfloat16)[1:].view(16, BLOCK))


def test_probe_tool_on_cpu(capsys):
    """``run_grid`` times one call in seconds; the tool prints the device
    line, then each sweep's four points and its slope line in the original
    tool's format."""
    assert tool.run_grid(4, kernel=op.probe_copy, parallel=True, device="cpu") > 0
    assert tool.main(["--device", "cpu"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"backend": "cpu", "device": "cpu"}
    points = [ln for ln in lines[1:] if "grid_steps" in ln]
    slopes = [ln for ln in lines[1:] if "us_per_step" in ln]
    assert len(points) == 16 and len(slopes) == 4 and len(lines) == 21
    assert [(ln["probe"], ln["parallel"]) for ln in slopes] == [
        ("copy", False), ("copy", True), ("matmul128", False), ("matmul128", True)]
    assert [ln["grid_steps"] for ln in points[:4]] == [64, 256, 1024, 4096]
    assert set(points[0]) == {"probe", "parallel", "grid_steps", "ms"}
    assert set(slopes[0]) == {"probe", "parallel", "us_per_step", "intercept_ms"}

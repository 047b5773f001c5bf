"""Port parity: the dense oracle and the flash-attention plain versions of
``gpuschedule_tpu_torch.ops`` against the JAX package on the CPU.

The same numpy inputs (seeded) go to both sides.  The JAX flash op runs as
its own tests run it here: Pallas interpret mode (under ``jax.jit``, which
compiles the interpreted kernels once instead of dispatching them op by op).  The port's wrappers take
their plain PyTorch versions because the tensors lie on the CPU; the CUDA
kernels are held against those plain versions on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gpuschedule_tpu.ops import flash_attention as jax_flash  # noqa: E402
from gpuschedule_tpu.ops.reference import dense_attention as jax_dense  # noqa: E402
from gpuschedule_tpu_torch.ops import dense_attention, flash_attention  # noqa: E402
from gpuschedule_tpu_torch.ops.flash_attention import (  # noqa: E402
    LAUNCHES,
    attention_delta,
    flash_bwd_dkdv,
    flash_bwd_dq,
    flash_fwd,
)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, dtype, seed=0, n=3):
    """n seeded normal arrays, rounded to ``dtype`` once so both sides see
    the very same values; returned as (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]
    js = [jnp.asarray(a).astype(jdt) for a in arrs]
    ts = [torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt) for j in js]
    return js, ts


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ------------------------------------------------------------ dense oracle --

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_dense_oracle_matches_jax(causal, dtype):
    """f32 math on both sides: f32 agrees to rounding (3e-6); bf16 output
    is one rounding of nearly equal f32 values, so within one bf16 ulp
    (2^-8 relative, 1e-2 absolute on O(1) outputs)."""
    (jq, jk, jv), (q, k, v) = _inputs((2, 37, 3, 16), dtype)
    ref = _np(jax.jit(jax_dense, static_argnames="causal")(jq, jk, jv, causal=causal))
    out = dense_attention(q, k, v, causal=causal)
    assert out.dtype == q.dtype
    tol = 3e-6 if dtype == "f32" else 1e-2
    np.testing.assert_allclose(_np(out), ref, atol=tol, rtol=tol)


# ------------------------------------------------ flash op: forward + grads --

# (S, D, block_q, block_k, causal, dtype): the cases of
# tests/test_flash_attention.py for the JAX op, at the head dims the port's
# kernels are built for (the JAX tests' D=40 and D=16 become 32 or 64).
# Unaligned S with equal blocks is test_flash_kernel_pieces_match_jax_impl.
FLASH_CASES = [
    pytest.param(200, 64, 128, 96, True, "f32", id="mismatched-128x96-causal"),
    pytest.param(200, 32, 32, 128, False, "f32", id="mismatched-32x128-noncausal"),
    pytest.param(48, 32, 128, 128, True, "f32", id="blocks-larger-than-S"),
    pytest.param(96, 32, 32, 32, True, "f32", id="aligned-blocks-32"),
    pytest.param(192, 64, 64, 64, True, "bf16", id="bf16-causal"),
    pytest.param(192, 64, 64, 64, False, "bf16", id="bf16-noncausal"),
]


@pytest.mark.parametrize("s,d,bq,bk,causal,dtype", FLASH_CASES)
def test_flash_matches_jax_flash(s, d, bq, bk, causal, dtype):
    """Output and (q, k, v) gradients of ``(out**2).sum()`` against JAX's
    ``flash_attention`` and its ``jax.grad``.

    Tolerances: f32 — both sides do f32 math in another summation order,
    3e-5 on outputs (the JAX tests' bound against the oracle) and 2e-4 on
    gradients.  bf16 — operands and p/ds are rounded to bf16 at the same
    points on both sides, but a 1-ulp difference in an f32 value before a
    bf16 rounding moves it by 2^-8, so outputs are held to 1.6e-2 absolute
    and gradients to 2e-2 of the gradient's largest entry."""
    (jq, jk, jv), (q, k, v) = _inputs((1, s, 2, d), dtype, seed=s + d)

    def jloss(q, k, v):
        o = jax_flash(q, k, v, causal=causal, block_q=bq, block_k=bk)
        return (o.astype(jnp.float32) ** 2).sum(), o

    grad_fn = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))
    (_, jout), jgrads = grad_fn(jq, jk, jv)

    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    assert out.dtype == q.dtype and out.shape == q.shape
    (out.float() ** 2).sum().backward()

    if dtype == "f32":
        np.testing.assert_allclose(_np(out), _np(jout), atol=3e-5, rtol=3e-5)
        for t, jg in zip((q, k, v), jgrads):
            np.testing.assert_allclose(_np(t.grad), _np(jg), atol=2e-4, rtol=2e-4)
    else:
        np.testing.assert_allclose(_np(out), _np(jout), atol=1.6e-2, rtol=0)
        for t, jg in zip((q, k, v), jgrads):
            ref = _np(jg)
            rel = np.max(np.abs(_np(t.grad) - ref)) / max(np.max(np.abs(ref)), 1e-6)
            assert rel < 2e-2, f"bf16 grad diverges from JAX: {rel}"


# (dtype, D, causal) of the pieces test: f32 at D=32 (ids "True"/"False",
# the original cases) runs the FMA kernels' function, bf16 the tensor-core
# kernels' (forward and dk/dv); D=128 is the widest head dim they compile.
PIECES_CASES = [
    pytest.param("f32", 32, True, id="True"),
    pytest.param("f32", 32, False, id="False"),
    pytest.param("f32", 128, True, id="f32-d128-causal"),
    pytest.param("f32", 128, False, id="f32-d128-noncausal"),
    pytest.param("bf16", 32, True, id="bf16-d32-causal"),
    pytest.param("bf16", 32, False, id="bf16-d32-noncausal"),
    pytest.param("bf16", 128, True, id="bf16-d128-causal"),
    pytest.param("bf16", 128, False, id="bf16-d128-noncausal"),
]


@pytest.mark.parametrize("dtype,d,causal", PIECES_CASES)
def test_flash_kernel_pieces_match_jax_impl(dtype, d, causal):
    """Each wrapper's plain version (the function its CUDA kernel computes)
    against the JAX package's forward and backward impls on the same
    inputs: lse rows, dq, and (dk, dv) separately, S=100 (ragged against
    the 64 tile), blocks 64.

    Tolerances.  f32: 3e-5 on the output and lse, 2e-4 on gradients (f32
    math on both sides, another summation order).  bf16: the output and
    the gradients are held as in ``test_flash_matches_jax_flash`` — both
    sides round p and ds to bf16 at the same points, but a 1-ulp difference
    in an f32 value before a bf16 rounding moves it by 2^-8, so 1.6e-2
    absolute on the output and 2e-2 of the largest entry on each gradient.
    lse stays f32 from exact bf16 products, so it keeps the f32 bound."""
    from gpuschedule_tpu.ops.flash_attention import _flash_bwd_impl, _flash_fwd_impl

    s = 100
    (jq, jk, jv, jg), (q, k, v, g) = _inputs((1, s, 2, d), dtype, seed=5, n=4)
    kw = dict(causal=causal, block_q=64, block_k=64, interpret=True)

    @jax.jit
    def jax_pieces(q, k, v, g):
        out, lse = _flash_fwd_impl(q, k, v, **kw)
        return (out, lse), _flash_bwd_impl(q, k, v, out, lse, g, **kw)

    (jout, jlse), (jdq, jdk, jdv) = jax_pieces(jq, jk, jv, jg)

    out, lse = flash_fwd(q, k, v, causal=causal)
    assert lse.shape == (2, s) and lse.dtype == torch.float32
    assert out.dtype == q.dtype
    np.testing.assert_allclose(
        _np(lse), np.asarray(jlse)[:, :s, 0], atol=3e-5, rtol=3e-5
    )
    if dtype == "f32":
        np.testing.assert_allclose(_np(out), _np(jout), atol=3e-5, rtol=3e-5)
    else:
        np.testing.assert_allclose(_np(out), _np(jout), atol=1.6e-2, rtol=0)
    delta = attention_delta(out, g)
    dq = flash_bwd_dq(q, k, v, g, lse, delta, causal=causal)
    dk, dv = flash_bwd_dkdv(q, k, v, g, lse, delta, causal=causal)
    for got, ref in ((dq, jdq), (dk, jdk), (dv, jdv)):
        assert got.dtype == q.dtype
        if dtype == "f32":
            np.testing.assert_allclose(_np(got), _np(ref), atol=2e-4, rtol=2e-4)
        else:
            ref = _np(ref)
            rel = np.max(np.abs(_np(got) - ref)) / max(np.max(np.abs(ref)), 1e-6)
            assert rel < 2e-2, f"bf16 gradient diverges from JAX: {rel}"
    # CPU tensors take the plain versions: no kernel was launched
    assert all(n == 0 for n in LAUNCHES.values())


def test_flash_matches_dense_oracle_long_sequence():
    """S=512, eight key tiles, against the port's own dense oracle, forward
    and gradients (the JAX suite's long-context check, cut to CPU size):
    f32, 5e-4."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 512, 1, 32)).astype(np.float32))
               .requires_grad_(True) for _ in range(3))
    (flash_attention(q, k, v) ** 2).sum().backward()
    grads = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    (dense_attention(q, k, v, causal=True) ** 2).sum().backward()
    for got, t in zip(grads, (q, k, v)):
        np.testing.assert_allclose(got.numpy(), t.grad.numpy(), atol=5e-4, rtol=5e-4)


def test_flash_shape_validation():
    q = torch.zeros(1, 32, 2, 32)
    with pytest.raises(ValueError, match="shapes differ"):
        flash_attention(q, q[:, :16], q)
    with pytest.raises(ValueError, match="B, S, H, D"):
        flash_attention(q[0], q[0], q[0])


@pytest.mark.parametrize("d", [16, 40, 80, 256])
def test_flash_unsupported_head_dim_raises(d):
    q = torch.zeros(1, 8, 1, d)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)

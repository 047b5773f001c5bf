"""Port parity for the sequence-parallel path on the CPU: the chunk ops (the
f32-output forms of the flash kernels), the dense ring and the ring-flash
composition against the JAX package, and ``make_mesh``'s checks.

The same seeded numpy inputs go to both sides.  The JAX rings run on the
conftest's virtual CPU devices (an sp mesh in one program), their Pallas
kernels in interpret mode; the port's counterpart of such a mesh is the
in-process ring (``*_in_process``), its chunk ops on their plain versions
because the tensors lie on the CPU.  The process-group ring is held to the
in-process ring in ``tests/test_torch_ring_dist.py``.

Tolerances, as the JAX suite's ring tests (``tests/test_ringflash.py``):
2e-5 on f32 outputs and lse, 2e-4 on f32 gradients (sums in another
order), 3e-2 in bf16 (one bf16 rounding of O(1) values, 2^-8 relative).
"""

import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gpuschedule_tpu.ops.flash_attention import (  # noqa: E402
    flash_chunk_bwd as jax_chunk_bwd,
    flash_chunk_fwd as jax_chunk_fwd,
)
from gpuschedule_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from gpuschedule_tpu.parallel import ring_attention as jax_ring  # noqa: E402
from gpuschedule_tpu.parallel import ring_flash_attention as jax_ring_flash  # noqa: E402
from gpuschedule_tpu_torch.ops import dense_attention, flash_attention  # noqa: E402
from gpuschedule_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_chunk_bwd,
    flash_chunk_fwd,
)
from gpuschedule_tpu_torch.parallel import (  # noqa: E402
    Mesh,
    make_mesh,
    ring_attention,
    ring_flash_attention,
)
from gpuschedule_tpu_torch.parallel.ringattn import ring_attention_in_process  # noqa: E402
from gpuschedule_tpu_torch.parallel.ringflash import (  # noqa: E402
    ring_flash_attention_in_process,
)

ringflash = importlib.import_module("gpuschedule_tpu_torch.parallel.ringflash")
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": (2e-5, 2e-4), "bf16": (3e-2, 3e-2)}  # (outputs, gradients)


def _inputs(shape, dtype, n=4, seed=0):
    """n seeded normal arrays rounded to ``dtype`` once: (jax, torch)."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    js = [jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(jdt)
          for _ in range(n)]
    return js, [torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt) for j in js]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, ref, tol):
    np.testing.assert_allclose(_np(got), _np(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_chunk_ops_match_jax(causal, dtype):
    """``flash_chunk_fwd`` (f32 out, lse as (B, H, S) rows) and
    ``flash_chunk_bwd`` (f32 dq, dk, dv from the given lse rows, delta
    recomputed from out and its cotangent), bf16 and f32 inputs: the
    outputs are f32 on both sides."""
    (jq, jk, jv, jg), (q, k, v, g) = _inputs((2, 80, 2, 32), dtype)
    j_out, j_lse = jax.jit(lambda q, k, v: jax_chunk_fwd(q, k, v, causal=causal))(jq, jk, jv)
    out, lse = flash_chunk_fwd(q, k, v, causal=causal)
    assert out.dtype == lse.dtype == torch.float32 == getattr(torch, str(j_out.dtype))
    assert tuple(lse.shape) == tuple(j_lse.shape) == (2, 2, 80)
    tol_out, tol_grad = TOL[dtype]
    _close(out, j_out, tol_out)
    _close(lse, j_lse, 2e-5)

    # the merged output and its cotangent, in the inputs' dtype as the ring passes them
    o_in = jnp.asarray(j_out).astype(jq.dtype)
    j_grads = jax.jit(lambda q, k, v, o, l, g: jax_chunk_bwd(q, k, v, o, l, g, causal=causal))(
        jq, jk, jv, o_in, j_lse, jg)
    grads = flash_chunk_bwd(q, k, v, out.to(q.dtype), lse, g, causal=causal)
    for got, ref in zip(grads, j_grads):
        assert got.dtype == torch.float32 == getattr(torch, str(ref.dtype))
        _close(got, ref, tol_grad)


def _jax_ring(fn, sp, causal, jq, jk, jv, jg):
    """(out, (dq, dk, dv)) of the JAX ring ``fn`` over an sp mesh of the
    virtual CPU devices, the gradients as the vjp of cotangent ``jg``."""
    mesh = jax_make_mesh(dp=1, sp=sp, devices=jax.devices()[:sp])

    def run(q, k, v, g):
        out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, mesh=mesh, causal=causal), q, k, v)
        return out, vjp(g)

    return jax.jit(run)(jq, jk, jv, jg)


def _port_ring(fn, sp, causal, q, k, v, g):
    q, k, v = (x.clone().requires_grad_(True) for x in (q, k, v))
    out = fn(q, k, v, sp=sp, causal=causal)
    return out, torch.autograd.grad(out, (q, k, v), g)


RING_CASES = [pytest.param(2, True, id="sp2-causal"), pytest.param(4, True, id="sp4-causal"),
              pytest.param(2, False, id="sp2-full")]


@pytest.mark.parametrize("sp,causal", RING_CASES)
def test_ring_flash_matches_jax(sp, causal):
    """The in-process ring-flash (f32 chunk ops, the (out, lse) merge, the
    second-ring backward) against the JAX composition on an sp mesh:
    values and gradients, f32."""
    js, ts = _inputs((2, 128, 2, 32), "f32")
    j_out, j_grads = _jax_ring(jax_ring_flash, sp, causal, *js)
    out, grads = _port_ring(ring_flash_attention_in_process, sp, causal, *ts)
    _close(out, j_out, 2e-5)
    for got, ref in zip(grads, j_grads):
        _close(got, ref, 2e-4)


def test_ring_flash_bf16_matches_jax():
    """bf16 inputs: the chunk outputs and gradients stay f32 across the ring
    on both sides, and the result comes back in bf16 (sp = 2)."""
    js, ts = _inputs((2, 128, 2, 32), "bf16")
    j_out, j_grads = _jax_ring(jax_ring_flash, 2, True, *js)
    out, grads = _port_ring(ring_flash_attention_in_process, 2, True, *ts)
    assert out.dtype == torch.bfloat16 and all(x.dtype == torch.bfloat16 for x in grads)
    _close(out, j_out, 3e-2)
    for got, ref in zip(grads, j_grads):
        _close(got, ref, 3e-2)


@pytest.mark.parametrize("sp,causal", RING_CASES)
def test_dense_ring_matches_jax(sp, causal):
    """The in-process dense ring (online softmax over dense chunk pairs,
    autograd through the loop) against the JAX ring: values and
    gradients, f32."""
    js, ts = _inputs((2, 128, 2, 32), "f32")
    j_out, j_grads = _jax_ring(jax_ring, sp, causal, *js)
    out, grads = _port_ring(ring_attention_in_process, sp, causal, *ts)
    _close(out, j_out, 2e-5)
    for got, ref in zip(grads, j_grads):
        _close(got, ref, 2e-4)


def test_ring_flash_launches_only_the_pairs_that_count(monkeypatch):
    """A causal ring of P ranks runs the chunk ops on the P diagonal and
    P(P-1)/2 past pairs, P(P+1)/2 in all (10 at P = 4), in the forward and
    again in the backward; the P(P-1)/2 future pairs run nothing.  A full
    ring runs all P²."""
    calls = []
    for name in ("flash_chunk_fwd", "flash_chunk_bwd"):
        real = getattr(ringflash, name)
        monkeypatch.setattr(ringflash, name, lambda *a, _n=name, _f=real, **kw: (
            calls.append((_n, kw["causal"])), _f(*a, **kw))[1])
    _, (q, k, v, g) = _inputs((1, 64, 1, 32), "f32")
    for causal, pairs, diagonal in ((True, 10, 4), (False, 16, 0)):
        calls.clear()
        _port_ring(ring_flash_attention_in_process, 4, causal, q, k, v, g)
        for name in ("flash_chunk_fwd", "flash_chunk_bwd"):
            kinds = [c for n, c in calls if n == name]
            assert len(kinds) == pairs and sum(kinds) == diagonal, (name, kinds)


def test_sp1_rings_are_the_oracle_and_the_flash_op():
    """At sp = 1 the dense ring is the dense oracle and the ring-flash the
    flash op, as in the JAX package, on a mesh of one rank (no launcher,
    no process group)."""
    _, (q, k, v, _) = _inputs((2, 64, 2, 32), "f32")
    mesh = make_mesh(sp=1, device="cpu")
    assert mesh.device_mesh is None and mesh.coordinate("sp") == 0
    assert torch.equal(ring_attention(q, k, v, mesh=mesh), dense_attention(q, k, v, causal=True))
    assert torch.equal(ring_flash_attention(q, k, v, mesh=mesh, causal=False),
                       flash_attention(q, k, v, causal=False))
    assert torch.equal(ring_flash_attention_in_process(q, k, v, sp=1),
                       flash_attention(q, k, v, causal=True))


def test_ring_needs_a_process_group_and_a_mesh():
    """A ring with sp > 1 needs the mesh's process group: without one it
    raises, and never switches to the in-process ring.  No mesh raises (the
    port has no ambient mesh), and so does a sequence that sp does not
    divide."""
    _, (q, k, v, _) = _inputs((1, 64, 1, 32), "f32")
    no_group = Mesh({"pp": 1, "dp": 1, "sp": 2, "tp": 1}, torch.device("cpu"))
    for fn in (ring_attention, ring_flash_attention):
        with pytest.raises(RuntimeError, match="no process group"):
            fn(q, k, v, mesh=no_group)
        with pytest.raises(ValueError, match="pass mesh= explicitly"):
            fn(q, k, v)
    for fn in (ring_attention_in_process, ring_flash_attention_in_process):
        with pytest.raises(ValueError, match="not divisible by sp=3"):
            fn(q, k, v, sp=3)


@pytest.mark.parametrize("kw,n", [
    (dict(sp=0), 4), (dict(sp=3), 4), (dict(dp=3, sp=2), 4), (dict(tp=2, pp=2, dp=2), 4),
], ids=["sp0", "sp3-of-4", "dp3-sp2-of-4", "dp2-tp2-pp2-of-4"])
def test_make_mesh_errors_match_jax(kw, n):
    """The axis checks raise the JAX function's ValueError, word for word;
    past them, a mesh that does not span the world (one rank here) raises."""
    with pytest.raises(ValueError) as ref:
        jax_make_mesh(devices=jax.devices()[:n], **kw)
    with pytest.raises(ValueError) as ours:
        make_mesh(devices=n, device="cpu", **kw)
    assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="world of 1 ranks"):
        make_mesh(dp=2, devices=2, device="cpu")
    one = make_mesh(device="cpu")
    assert one.shape == dict(jax_make_mesh(devices=jax.devices()[:1]).shape)
    assert list(one.shape) == ["pp", "dp", "sp", "tp"]

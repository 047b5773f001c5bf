"""Flash attention: hand-written CUDA kernels and their plain PyTorch versions.

Counterpart of ``gpuschedule_tpu/ops/flash_attention.py``.  Three kernels,
each behind a wrapper that launches it for CUDA tensors and runs its plain
version for CPU tensors:

======================  ==========================================  ==============================
wrapper                 CUDA kernel (bf16 / f32)                    replaces (Pallas TPU kernel)
======================  ==========================================  ==============================
:func:`flash_fwd`       ``fwd_mma_kernel`` / ``fwd_kernel``         ``_fwd_kernel`` (:98-152)
:func:`flash_bwd_dq`    ``dq_mma_kernel`` / ``bwd_dq_kernel``       ``_bwd_dq_kernel`` (:155-199)
:func:`flash_bwd_dkdv`  ``dkdv_mma_kernel`` / ``bwd_dkdv_kernel``   ``_bwd_dkdv_kernel`` (:202-252)
======================  ==========================================  ==============================

bf16 inputs (the model's dtype) run all three on the tensor cores
(``mma.sync`` fed by ``cp.async``); f32 inputs run FMA kernels, which keep
full f32 products.  The dtype picks the kernel; neither is a fallback.

Each wrapper takes ``out_dtype``: None (or the inputs' dtype) for outputs
like the inputs, or ``torch.float32``.  From bf16 inputs the f32 form is the
tensor-core kernel with an f32 epilogue, the form the JAX package's chunk
ops launch (``out_dtype=jnp.float32``) and the ring's chunk ops here launch
(:func:`flash_chunk_fwd`, :func:`flash_chunk_bwd`); it is counted under a
name of its own (``flash_fwd_f32``, ...).  From f32 inputs it is the FMA
kernel as it is.

The kernels live in ``csrc/flash_attention.cu`` (its header comment gives
each kernel's bound and design), are built by ``nvcc`` at first use
(:mod:`._build`) and are called through ctypes on PyTorch's current stream.
For a CUDA tensor a wrapper launches its kernel or raises: no fallback.
Each wrapper counts its launches in :data:`LAUNCHES`.

The plain versions compute the same function the same way: blockwise over
key tiles with the online softmax (forward), and from the saved logsumexp
(backward), with the kernels' dtype policy — products take operands in the
input dtype and accumulate in f32, ``sm_scale`` multiplies the f32 product,
p is rounded to V's dtype before p·V, ds to K's and q's dtype before ds·K
and dsᵀ·q.  They are vectorised over the other tile axis: a tile the kernel
skips (wholly above the causal diagonal) contributes exactly 0 to every row
that has seen one valid key (``exp(NEG_INF - m) == 0`` and ``corr == 1``),
so the sums are the kernel's sums.

:func:`flash_attention` is the differentiable op, ``(B, S, H, D)`` in and
out like the JAX op, with the model zoo's ``attn_fn`` signature.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from gpuschedule_tpu_torch.ops import launches
from gpuschedule_tpu_torch.ops.reference import NEG_INF

# The kernels' compiled tile (BQ = BK in csrc/flash_attention.cu) and the
# plain versions' default block.
TILE = 64
HEAD_DIMS = (32, 64, 96, 128)
DTYPES = (torch.float32, torch.bfloat16)

# Launches of each CUDA kernel, counted by its wrapper where it launches.
LAUNCHES: Dict[str, int] = launches.counter(
    "flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv",
    "flash_fwd_f32", "flash_bwd_dq_f32", "flash_bwd_dkdv_f32",
)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_lib: Optional[ctypes.CDLL] = None


def _kernels() -> ctypes.CDLL:
    """The built kernel library, with its C signatures declared."""
    global _lib
    if _lib is None:
        from gpuschedule_tpu_torch.ops import _build

        lib = _build.load("flash_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        dims = [i, i, i, i, f, i, i, i, p]  # B, S, H, D, scale, causal, is_bf16, out_f32, stream
        lib.gst_flash_fwd.argtypes = [p] * 5 + dims
        lib.gst_flash_bwd_dq.argtypes = [p] * 7 + dims
        lib.gst_flash_bwd_dkdv.argtypes = [p] * 8 + dims
        for fn in (lib.gst_flash_fwd, lib.gst_flash_bwd_dq, lib.gst_flash_bwd_dkdv):
            fn.restype = ctypes.c_int
        lib.gst_error_string.argtypes = [i]
        lib.gst_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _sm_scale(d: int) -> float:
    return 1.0 / (d ** 0.5)


def _check_head_dim(d: int) -> None:
    if d not in HEAD_DIMS:
        raise ValueError(
            f"head dim {d} is not supported; the kernels are built for {HEAD_DIMS}"
        )


def _check_qkv(q, k, v) -> None:
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if q.dim() != 4:
        raise ValueError(f"expected (B, S, H, D), got {tuple(q.shape)}")
    _check_head_dim(q.shape[-1])


def _check_cuda(tensors, rows=()) -> None:
    """What the kernels take: contiguous tensors on one device, ``tensors``
    of one supported dtype and 16-byte aligned, ``rows`` (lse, delta) in
    f32."""
    dev = tensors[0].device
    for t in (*tensors, *rows):
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
    dtype = tensors[0].dtype
    if dtype not in DTYPES:
        raise TypeError(f"dtype {dtype} not supported; use one of {DTYPES}")
    if any(t.dtype != dtype for t in tensors):
        raise TypeError(f"q, k, v (and dO) must share one dtype, got {[t.dtype for t in tensors]}")
    _check_aligned(tensors)


def _check_aligned(tensors) -> None:
    """The tensor-core kernels copy rows in 16-byte vectors (``cp.async``):
    every tensor they read must start on a 16-byte boundary, which a view
    at an odd offset may not."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the CUDA kernels read 16-byte vectors: q, k, v (and dO) "
                         "must be 16-byte aligned")


def _check_rows(rows: torch.Tensor, bh: int, s: int, name: str) -> None:
    if rows.shape != (bh, s) or rows.dtype != torch.float32:
        raise ValueError(f"{name} must be f32 of shape {(bh, s)}, got {rows.dtype} {tuple(rows.shape)}")


def _out_dtype(x: torch.Tensor, out_dtype) -> torch.dtype:
    """The outputs' dtype: ``x``'s for None, else ``x``'s or f32."""
    if out_dtype is None or out_dtype == x.dtype:
        return x.dtype
    if out_dtype != torch.float32:
        raise TypeError(f"out_dtype must be None, the inputs' {x.dtype} or torch.float32; "
                        f"got {out_dtype}")
    return out_dtype


def _form(name: str, x: torch.Tensor, dtype: torch.dtype):
    """(launch counter name, out_f32 flag) of a launch from inputs like ``x``
    into outputs of ``dtype``: bf16 inputs with f32 outputs are the f32 form."""
    if x.dtype == torch.bfloat16 and dtype == torch.float32:
        return f"{name}_f32", 1
    return name, 0


def _launch(fn, *args) -> None:
    from gpuschedule_tpu_torch.ops import _build

    _build.launch(_kernels(), fn, *args)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _block(s: int, block: Optional[int]) -> int:
    """A plain version's tile size, clamped to S (the contract of the JAX
    package's ``_effective_blocks``: any S, padding never visible)."""
    b = TILE if block is None else block
    if b < 1:
        raise ValueError(f"blocks must be positive, got {block}")
    return min(b, s)


def _check_cuda_block(block: Optional[int]) -> None:
    if block not in (None, TILE):
        raise ValueError(f"the CUDA kernels tile at {TILE}x{TILE}; got block {block}")


def _heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B*H, S, D) f32: the plain versions' working layout."""
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d).float()


def _unheads(x: torch.Tensor, b: int, h: int, dtype) -> torch.Tensor:
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).permute(0, 2, 1, 3).contiguous().to(dtype)


def _as(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to ``dtype`` and widened back: the operand cast before a product."""
    return x.to(dtype).float()


def _mask(rows: torch.Tensor, cols: torch.Tensor, s: int, causal: bool) -> torch.Tensor:
    """Validity of the (rows, cols) score tile: the Pallas ``_mask`` rule."""
    valid = (cols[None, :] < s) & (rows[:, None] < s)
    if causal:
        valid = valid & (rows[:, None] >= cols[None, :])
    return valid


# ------------------------------------------------------------- forward (K1) --

def flash_fwd_plain(q, k, v, causal: bool = True, block_k: int = TILE, out_dtype=None):
    b, s, h, d = q.shape
    scale = _sm_scale(d)
    qf, kf, vf = _heads(q), _heads(k), _heads(v)
    bh = b * h
    m = torch.full((bh, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bh, s, d), dtype=torch.float32, device=q.device)
    rows = torch.arange(s, device=q.device)
    for k0 in range(0, s, block_k):
        cols = rows[k0:k0 + block_k]
        sc = torch.matmul(qf, kf[:, k0:k0 + block_k].transpose(1, 2)) * scale
        sc = torch.where(_mask(rows, cols, s, causal), sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(_as(p, v.dtype), vf[:, k0:k0 + block_k])
        m = m_new
    l_fin = torch.clamp(l, min=1e-30)
    out = _unheads(acc / l_fin[..., None], b, h, _out_dtype(q, out_dtype))
    return out, m + torch.log(l_fin)


def flash_fwd(q, k, v, *, causal: bool = True, block_k: Optional[int] = None, out_dtype=None):
    """(out, lse): out in q's (B, S, H, D) layout, in q's dtype or
    ``out_dtype``, lse the f32 per-row logsumexp as (B*H, S) — the only
    residual the backward needs."""
    _check_qkv(q, k, v)
    b, s, h, d = q.shape
    dtype = _out_dtype(q, out_dtype)
    if q.device.type != "cuda":
        return flash_fwd_plain(q, k, v, causal, _block(s, block_k), dtype)
    _check_cuda_block(block_k)
    _check_cuda((q, k, v))
    out = torch.empty_like(q, dtype=dtype)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    name, out_f32 = _form("flash_fwd", q, dtype)
    if out.numel():
        with torch.cuda.device(q.device):
            lib = _kernels()
            _launch(
                lib.gst_flash_fwd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), lse.data_ptr(), b, s, h, d, _sm_scale(d),
                int(causal), int(q.dtype == torch.bfloat16), out_f32, _stream(),
            )
            LAUNCHES[name] += 1
    return out, lse


# ------------------------------------------------------------------ dq (K2) --

def flash_bwd_dq_plain(q, k, v, g, lse, delta, causal: bool = True, block_k: int = TILE,
                       out_dtype=None):
    b, s, h, d = q.shape
    scale = _sm_scale(d)
    qf, kf, vf, gf = _heads(q), _heads(k), _heads(v), _heads(g)
    dq = torch.zeros_like(qf)
    rows = torch.arange(s, device=q.device)
    for k0 in range(0, s, block_k):
        cols = rows[k0:k0 + block_k]
        kb = kf[:, k0:k0 + block_k]
        sc = torch.matmul(qf, kb.transpose(1, 2)) * scale
        sc = torch.where(_mask(rows, cols, s, causal), sc, NEG_INF)
        p = torch.exp(sc - lse[..., None])
        dp = torch.matmul(gf, vf[:, k0:k0 + block_k].transpose(1, 2))
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.matmul(_as(ds, k.dtype), kb)
    return _unheads(dq, b, h, _out_dtype(q, out_dtype))


def flash_bwd_dq(q, k, v, g, lse, delta, *, causal: bool = True,
                 block_k: Optional[int] = None, out_dtype=None):
    """dq = Σ_k ds·K with p = exp(s − lse), ds = p·(dO·Vᵀ − delta)·scale,
    in q's dtype or ``out_dtype``.  ``lse`` and ``delta`` are f32 (B*H, S)
    rows."""
    _check_qkv(q, k, v)
    b, s, h, d = q.shape
    if g.shape != q.shape:
        raise ValueError(f"dO shape {tuple(g.shape)} != q shape {tuple(q.shape)}")
    _check_rows(lse, b * h, s, "lse")
    _check_rows(delta, b * h, s, "delta")
    dtype = _out_dtype(q, out_dtype)
    if q.device.type != "cuda":
        return flash_bwd_dq_plain(q, k, v, g, lse, delta, causal, _block(s, block_k), dtype)
    _check_cuda_block(block_k)
    _check_cuda((q, k, v, g), (lse, delta))
    dq = torch.empty_like(q, dtype=dtype)
    name, out_f32 = _form("flash_bwd_dq", q, dtype)
    if dq.numel():
        with torch.cuda.device(q.device):
            lib = _kernels()
            _launch(
                lib.gst_flash_bwd_dq, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                b, s, h, d, _sm_scale(d), int(causal),
                int(q.dtype == torch.bfloat16), out_f32, _stream(),
            )
            LAUNCHES[name] += 1
    return dq


# --------------------------------------------------------------- dk/dv (K3) --

def flash_bwd_dkdv_plain(q, k, v, g, lse, delta, causal: bool = True, block_q: int = TILE,
                         out_dtype=None):
    b, s, h, d = q.shape
    scale = _sm_scale(d)
    qf, kf, vf, gf = _heads(q), _heads(k), _heads(v), _heads(g)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    cols = torch.arange(s, device=q.device)
    for q0 in range(0, s, block_q):
        rows = cols[q0:q0 + block_q]
        qb, gb = qf[:, q0:q0 + block_q], gf[:, q0:q0 + block_q]
        sc = torch.matmul(qb, kf.transpose(1, 2)) * scale
        sc = torch.where(_mask(rows, cols, s, causal), sc, NEG_INF)
        p = torch.exp(sc - lse[:, q0:q0 + block_q, None])
        dv = dv + torch.matmul(_as(p, g.dtype).transpose(1, 2), gb)
        dp = torch.matmul(gb, vf.transpose(1, 2))
        ds = p * (dp - delta[:, q0:q0 + block_q, None]) * scale
        dk = dk + torch.matmul(_as(ds, q.dtype).transpose(1, 2), qb)
    return (_unheads(dk, b, h, _out_dtype(k, out_dtype)),
            _unheads(dv, b, h, _out_dtype(v, out_dtype)))


def flash_bwd_dkdv(q, k, v, g, lse, delta, *, causal: bool = True,
                   block_q: Optional[int] = None, out_dtype=None):
    """(dk, dv): dv = Σ_q pᵀ·dO and dk = Σ_q dsᵀ·q over the q rows that
    attend to each key, in k's dtype or ``out_dtype``."""
    _check_qkv(q, k, v)
    b, s, h, d = q.shape
    if g.shape != q.shape:
        raise ValueError(f"dO shape {tuple(g.shape)} != q shape {tuple(q.shape)}")
    _check_rows(lse, b * h, s, "lse")
    _check_rows(delta, b * h, s, "delta")
    dtype = _out_dtype(k, out_dtype)
    if q.device.type != "cuda":
        return flash_bwd_dkdv_plain(q, k, v, g, lse, delta, causal, _block(s, block_q), dtype)
    _check_cuda_block(block_q)
    _check_cuda((q, k, v, g), (lse, delta))
    dk = torch.empty_like(k, dtype=dtype)
    dv = torch.empty_like(v, dtype=dtype)
    name, out_f32 = _form("flash_bwd_dkdv", q, dtype)
    if dk.numel():
        with torch.cuda.device(q.device):
            lib = _kernels()
            _launch(
                lib.gst_flash_bwd_dkdv, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), b, s, h, d, _sm_scale(d), int(causal),
                int(q.dtype == torch.bfloat16), out_f32, _stream(),
            )
            LAUNCHES[name] += 1
    return dk, dv


# ----------------------------------------------------------- the op itself --

def attention_delta(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO ∘ O) in f32, as (B*H, S) rows (an XLA einsum in the
    JAX package, a PyTorch expression here)."""
    b, s, h, _ = out.shape
    return torch.einsum("bshd,bshd->bhs", g.float(), out.float()).reshape(b * h, s).contiguous()


def flash_chunk_fwd(q, k, v, *, causal: bool):
    """(out, lse_rows) of one (q-chunk, k-chunk) pair, the per-chunk op of
    the ring (:mod:`gpuschedule_tpu_torch.parallel.ringflash`), as the JAX
    package's ``flash_chunk_fwd``: out f32 in (B, S, H, D), so the ring's
    merge takes it unrounded, and lse as f32 (B, H, S) rows for the
    associative (out, lse) merge.  Not differentiable on its own: the ring
    has its own backward, a second ring pass over :func:`flash_chunk_bwd`."""
    b, s, h, _ = q.shape
    out, lse = flash_fwd(q, k, v, causal=causal, out_dtype=torch.float32)
    return out, lse.view(b, h, s)


def flash_chunk_bwd(q, k, v, out, lse_rows, g, *, causal: bool):
    """f32 (dq, dk, dv) of one (q-chunk, k-chunk) pair given the **global**
    logsumexp rows (B, H, S): p = exp(s − lse) is then the pair's share of
    the whole softmax, so the pairs' contributions sum to the gradient.
    ``out`` and ``g`` are the merged output and its cotangent; delta is
    recomputed from them on each call (:func:`attention_delta`)."""
    b, s, h, _ = q.shape
    lse = lse_rows.reshape(b * h, s).contiguous()
    delta = attention_delta(out, g)
    dq = flash_bwd_dq(q, k, v, g, lse, delta, causal=causal, out_dtype=torch.float32)
    dk, dv = flash_bwd_dkdv(q, k, v, g, lse, delta, causal=causal, out_dtype=torch.float32)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        out, lse = flash_fwd(q, k, v, causal=causal, block_k=block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.block_q, ctx.block_k = causal, block_q, block_k
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.contiguous().to(q.dtype)
        delta = attention_delta(out, g)
        dq = flash_bwd_dq(q, k, v, g, lse, delta, causal=ctx.causal, block_k=ctx.block_k)
        dk, dv = flash_bwd_dkdv(
            q, k, v, g, lse, delta, causal=ctx.causal, block_q=ctx.block_q
        )
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Blockwise attention over (B, S, H, D), differentiable: the backward
    recomputes probabilities per tile from the saved logsumexp, so no
    (S, S) tensor is kept between forward and backward.

    On CUDA tensors the kernels run at their compiled 64x64 tile (blocks
    other than None or 64 raise); on CPU tensors the plain versions run at
    ``block_q``/``block_k`` (default 64, clamped to S).  The call signature
    matches the model zoo's ``attn_fn`` hook."""
    _check_qkv(q, k, v)
    if q.device.type == "cuda":
        _check_cuda_block(block_q)
        _check_cuda_block(block_k)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _FlashAttention.apply(q, k, v, causal, block_q, block_k)

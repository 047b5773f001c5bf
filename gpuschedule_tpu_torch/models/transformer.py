"""Decoder-only transformer LM in PyTorch, numerically after the flax zoo.

Counterpart of ``gpuschedule_tpu/models/transformer.py`` (``TransformerLM``,
``Block``, ``ProjectedAttention``, ``MoeMlp``, ``build_model``; the CNN is
in :mod:`.cnn`).  f32 parameters, bf16 compute, logits cast to f32.

Parameters keep flax's names and shapes (``query.kernel`` is
``(d_model, heads, head_dim)``, a Dense kernel is ``(in, out)``), so a flax
tree maps onto the ``state_dict`` by path alone (:mod:`..convert`).

Flax numerics reproduced (read from the installed flax 0.12.3):

- ``LayerNorm``: eps 1e-6, mean and ``E[x²] - E[x]²`` variance in f32,
  scale and bias applied in f32, output bf16;
- ``Dense``/``DenseGeneral``: input, kernel and bias cast to bf16, the
  product rounded to bf16 before the bias is added (the MoE router: all
  f32);
- ``gelu``: the tanh approximation;
- ``Embed``: the table cast to bf16 before the lookup, ``pos_embed`` added
  in bf16;
- dense self-attention (``nn.SelfAttention``): q divided by
  ``sqrt(head_dim)`` in bf16 before QKᵀ, masked to ``finfo(bf16).min``,
  softmax in bf16.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from gpuschedule_tpu_torch.models.config import MODEL_CONFIGS, CnnConfig, ModelConfig

BF16 = torch.bfloat16
# flax's lecun_normal: a normal truncated at 2 sigma, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's ``lecun_normal`` in place: std 1/sqrt(fan_in) after truncation."""
    std = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=gen)


class Dense(nn.Module):
    """flax ``Dense``/``DenseGeneral``: contracts the trailing ``len(in_shape)``
    axes of x with a ``(*in_shape, *out_shape)`` kernel, in ``dtype``."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int],
                 dtype: torch.dtype = BF16):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(*self.in_shape, *self.out_shape))
        self.bias = nn.Parameter(torch.zeros(*self.out_shape))

    def reset_parameters(self, gen: torch.Generator) -> None:
        lecun_normal_(self.kernel, math.prod(self.in_shape), gen)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_in = len(self.in_shape)
        lead = x.shape[: x.dim() - n_in]
        w = self.kernel.to(self.dtype).reshape(math.prod(self.in_shape), -1)
        y = torch.matmul(x.to(self.dtype).reshape(*lead, -1), w)
        y = y + self.bias.to(self.dtype).reshape(-1)
        return y.reshape(*lead, *self.out_shape)


class LayerNorm(nn.Module):
    """flax ``LayerNorm(dtype=bf16)``: f32 statistics, bf16 output."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias
        return y.to(BF16)


class Embed(nn.Module):
    """flax ``Embed(dtype=bf16)``: the table is cast to bf16, then looked up."""

    def __init__(self, vocab: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(vocab, dim))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.embedding.normal_(0.0, 1.0 / math.sqrt(self.embedding.shape[1]), generator=gen)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.embedding.to(BF16))


def dense_self_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """The attention core of flax ``nn.SelfAttention`` with a causal mask,
    in bf16: (B, S, H, D) in and out.  Plain PyTorch, no kernel of ours —
    the JAX package's dense path runs none either."""
    depth = q.shape[-1]
    q = q / torch.tensor(math.sqrt(depth), dtype=torch.float32).to(q.dtype)
    w = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if causal:
        s = q.shape[1]
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        w = w.masked_fill(~mask, torch.finfo(w.dtype).min)
    e = torch.exp(w - w.amax(dim=-1, keepdim=True))
    w = e / e.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


class ProjectedAttention(nn.Module):
    """QKV/out projections around an attention core ``attn_fn(q, k, v)`` on
    (B, S, H, head) tensors.  Parameter names mirror ``nn.SelfAttention``
    (query/key/value/out), so both paths load the same flax tree."""

    def __init__(self, cfg: ModelConfig, attn_fn: Callable):
        super().__init__()
        if cfg.d_model % cfg.n_heads != 0:
            raise ValueError(f"d_model {cfg.d_model} not divisible by n_heads {cfg.n_heads}")
        head = cfg.d_model // cfg.n_heads
        self.attn_fn = attn_fn
        self.query = Dense((cfg.d_model,), (cfg.n_heads, head))
        self.key = Dense((cfg.d_model,), (cfg.n_heads, head))
        self.value = Dense((cfg.d_model,), (cfg.n_heads, head))
        self.out = Dense((cfg.n_heads, head), (cfg.d_model,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        o = self.attn_fn(self.query(x), self.key(x), self.value(x))
        return self.out(o)


class MoeMlp(nn.Module):
    """Top-k routed mixture-of-experts FFN (k = 1: Switch; k = 2: GShard),
    after the flax ``MoeMlp``: routing as dense one-hot dispatch and combine
    einsums over an (experts, capacity, d) buffer.

    - the router is an f32 Dense on ``x.float()``, then softmax and top-k;
      for k > 1 the kept gates renormalise to sum to one;
    - each expert takes at most ``cap = max(1, int(capacity_factor·T/E))``
      of the T tokens this module sees; later choices queue behind earlier
      ones (all first choices claim capacity before any second choice), and
      a choice past capacity contributes 0;
    - ``dispatch`` and ``combine`` are bf16 sums over the k choices, each
      choice's term rounded to bf16 before it is added; the three einsums
      run in bf16, gelu is the tanh approximation.

    Routing reads nothing back to the host (no ``.item()``, ``nonzero`` or
    boolean indexing: the one-hots compare with an ``arange``), so a CUDA
    graph can hold it.  :meth:`forward` returns the output and the aux loss
    ``E/k · Σ_e f_e·P_e`` (f_e the share of routed choices to e, P_e the
    mean router probability), plus ``router_z_weight · mean(lse(logits)²)``
    when that weight is above 0: flax sows it, here it is returned."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.n_experts, self.top_k = e, max(1, int(cfg.router_top_k))
        if self.top_k > e:
            raise ValueError(f"router_top_k={self.top_k} exceeds n_experts={e}")
        self.capacity_factor = cfg.capacity_factor
        self.z_weight = cfg.router_z_weight
        self.router = Dense((d,), (e,), dtype=torch.float32)
        self.w_up = nn.Parameter(torch.empty(e, d, f))
        self.b_up = nn.Parameter(torch.zeros(e, f))
        self.w_down = nn.Parameter(torch.empty(e, f, d))
        self.b_down = nn.Parameter(torch.zeros(e, d))

    def reset_parameters(self, gen: torch.Generator) -> None:
        """The expert weights; the router is a :class:`Dense`.  jax's
        ``lecun_normal`` folds the leading (expert) axis of a 3-D kernel
        into the receptive field, so the fan-in is E·d (E·d_ff), not d."""
        for w in (self.w_up, self.w_down):
            lecun_normal_(w, w.shape[0] * w.shape[1], gen)
        with torch.no_grad():
            self.b_up.zero_()
            self.b_down.zero_()

    def route(self, x: torch.Tensor):
        """(dispatch, combine, aux) for the tokens of ``x`` (B, S, d):
        dispatch and combine (T, E, cap) bf16, aux a scalar f32."""
        e, k = self.n_experts, self.top_k
        t = x.shape[0] * x.shape[1]
        cap = max(1, int(self.capacity_factor * t / e))
        logits = self.router(x.float()).reshape(t, e)
        probs = torch.softmax(logits, dim=-1)
        top_probs, top_idx = torch.topk(probs, k, dim=-1)  # (T, k)
        gates = top_probs / top_probs.sum(dim=-1, keepdim=True) if k > 1 else top_probs
        experts = torch.arange(e, device=x.device)
        onehots = (top_idx[..., None] == experts).float()  # (T, k, E)
        frac = onehots.sum(dim=1).mean(dim=0)
        aux = e / k * (frac * probs.mean(dim=0)).sum()
        if self.z_weight > 0.0:
            aux = aux + self.z_weight * (torch.logsumexp(logits, dim=-1) ** 2).mean()
        # slots, choice-major: within choice j the chosen column of the
        # cumsum holds the token's slot (>= 0) and the others -1, so the row
        # max extracts it (a row sum would add the -1s).  A slot outside
        # [0, cap) matches no column of the slot one-hot: the choice drops.
        # The running count is taken along the last axis of an (E, T) copy:
        # a scan down the T rows of (T, E) runs E lanes wide on the card.
        slots = torch.arange(cap, device=x.device, dtype=torch.float32)
        base = torch.zeros(e, device=x.device)
        dispatch = combine = None
        for j in range(k):
            oh = onehots[:, j, :]  # (T, E)
            count = torch.cumsum(oh.t().contiguous(), dim=1).t()  # exact: integers < 2^24
            pos = ((count + base) * oh - 1.0).amax(dim=-1)  # (T,)
            slot = (pos[:, None] == slots).to(BF16)[:, None, :]  # (T, 1, cap)
            # oh·slot·gate is one product that is not 0 a row, exact in f32,
            # so rounding the (T, E) factor first gives flax's bf16 term
            d_j = oh.to(BF16)[:, :, None] * slot
            c_j = (oh * gates[:, j, None]).to(BF16)[:, :, None] * slot
            dispatch = d_j if dispatch is None else dispatch + d_j
            combine = c_j if combine is None else combine + c_j
            base = base + oh.sum(dim=0)
        return dispatch, combine, aux

    def forward(self, x: torch.Tensor):
        """(y, aux): the (B, S, d) bf16 output and the aux loss."""
        b, s, d = x.shape
        dispatch, combine, aux = self.route(x)
        expert_in = torch.einsum("td,tec->ecd", x.reshape(b * s, d).to(BF16), dispatch)
        h = (torch.einsum("ecd,edf->ecf", expert_in, self.w_up.to(BF16))
             + self.b_up[:, None, :].to(BF16))
        h = F.gelu(h, approximate="tanh")
        out = (torch.einsum("ecf,efd->ecd", h, self.w_down.to(BF16))
               + self.b_down[:, None, :].to(BF16))
        y = torch.einsum("ecd,tec->td", out, combine)
        return y.reshape(b, s, d), aux


class Block(nn.Module):
    """Pre-LN causal self-attention + MLP block, bf16 compute.  The MLP is
    a dense FFN, or a :class:`MoeMlp` when the config sets ``n_experts``."""

    def __init__(self, cfg: ModelConfig, attn_fn: Optional[Callable] = None):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model)
        self.attn = ProjectedAttention(cfg, attn_fn or dense_self_attention)
        self.ln2 = LayerNorm(cfg.d_model)
        self.is_moe = bool(cfg.n_experts)
        if self.is_moe:
            self.moe = MoeMlp(cfg)
        else:
            self.up = Dense((cfg.d_model,), (cfg.d_ff,))
            self.down = Dense((cfg.d_ff,), (cfg.d_model,))

    def forward(self, x: torch.Tensor):
        """(output, the MoE aux loss or None).  The aux rides the return
        value, never a side list: a remat recompute would append to a list
        twice, and a list filled during a graph capture keeps the capture's
        tensors."""
        x = x + self.attn(self.ln1(x))
        h = self.ln2(x)
        if self.is_moe:
            y, aux = self.moe(h)
            return x + y, aux
        h = F.gelu(self.up(h), approximate="tanh")
        return x + self.down(h), None


class TransformerLM(nn.Module):
    """Causal LM: embed → blocks → final LN → f32 logits.  With
    ``cfg.remat`` each block is recomputed in the backward
    (``torch.utils.checkpoint``, the counterpart of ``nn.remat``)."""

    def __init__(self, cfg: ModelConfig, attn_fn: Optional[Callable] = None):
        super().__init__()
        self.cfg = cfg
        self.embed = Embed(cfg.vocab, cfg.d_model)
        self.pos_embed = nn.Parameter(torch.empty(cfg.max_seq, cfg.d_model))
        self.blocks = nn.ModuleList(Block(cfg, attn_fn) for _ in range(cfg.n_layers))
        self.ln_f = LayerNorm(cfg.d_model)
        self.lm_head = Dense((cfg.d_model,), (cfg.vocab,))

    def reset_parameters(self, gen: torch.Generator) -> None:
        """flax's default initialisers, drawn from ``gen`` in module order."""
        self.embed.reset_parameters(gen)
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=gen)
        for mod in self.modules():
            if isinstance(mod, (Dense, MoeMlp)):
                mod.reset_parameters(gen)

    def forward(self, tokens: torch.Tensor, pos_offset: int = 0) -> torch.Tensor:
        """Logits of ``tokens``, which sit at positions ``pos_offset`` on in
        the sequence: a rank holding chunk r of a sequence split over sp
        passes r * L, where the JAX model sees the whole sequence."""
        return self.forward_with_aux(tokens, pos_offset)[0]

    def forward_with_aux(self, tokens: torch.Tensor, pos_offset: int = 0):
        """(logits, aux): :meth:`forward`'s logits and the list of the MoE
        blocks' aux losses in block order (empty for a dense MLP), what
        the flax model sows into ``moe_losses``."""
        n = tokens.shape[1]
        if pos_offset < 0 or pos_offset + n > self.cfg.max_seq:
            raise ValueError(f"positions [{pos_offset}, {pos_offset + n}) outside max_seq "
                             f"{self.cfg.max_seq}")
        x = self.embed(tokens)
        x = x + self.pos_embed[pos_offset:pos_offset + n].to(BF16)
        aux = []
        for block in self.blocks:
            if self.cfg.remat and torch.is_grad_enabled():
                # no dropout or other draw in either model family (nor in
                # the flax zoo), so the recompute needs no RNG state, and
                # stashing the CUDA one would not survive a graph capture
                x, a = checkpoint(block, x, use_reentrant=False, preserve_rng_state=False)
            else:
                x, a = block(x)
            if a is not None:
                aux.append(a)
        return self.lm_head(self.ln_f(x)).float(), aux


def model_config(name: str, attn_fn: Optional[Callable] = None) -> "ModelConfig | CnnConfig":
    """The zoo config of ``name``.  Unknown names raise ``ValueError``, and
    so does an attention core for a CNN, as in the JAX ``build_model``."""
    try:
        cfg = MODEL_CONFIGS[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; known: {sorted(MODEL_CONFIGS)}") from None
    if isinstance(cfg, CnnConfig) and attn_fn is not None:
        raise ValueError("attn_fn applies to transformer LMs, not CNNs")
    return cfg


def build_model(name: str, *, attn_fn: Optional[Callable] = None):
    """(module, cfg) for a zoo name, parameters uninitialised (call
    ``reset_parameters`` or load a state_dict) on the default device: a
    :class:`TransformerLM` (dense or MoE MLP) or a CNN
    (:class:`~gpuschedule_tpu_torch.models.cnn.ResNet`).  ``attn_fn`` swaps
    the LM's attention core; None is the dense ``nn.SelfAttention`` core."""
    cfg = model_config(name, attn_fn)
    if isinstance(cfg, CnnConfig):
        from gpuschedule_tpu_torch.models.cnn import ResNet

        return ResNet(cfg), cfg
    return TransformerLM(cfg, attn_fn), cfg

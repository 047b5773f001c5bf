"""Decoder-only transformer LM in PyTorch, numerically after the flax zoo.

Counterpart of ``gpuschedule_tpu/models/transformer.py`` (``TransformerLM``,
``Block``, ``ProjectedAttention``; the MoE MLP and the CNN are not ported
yet, see ROADMAP.md).  f32 parameters, bf16 compute, logits cast to f32.

Parameters keep flax's names and shapes (``query.kernel`` is
``(d_model, heads, head_dim)``, a Dense kernel is ``(in, out)``), so a flax
tree maps onto the ``state_dict`` by path alone (:mod:`..convert`).

Flax numerics reproduced (read from the installed flax 0.12.3):

- ``LayerNorm``: eps 1e-6, mean and ``E[x²] - E[x]²`` variance in f32,
  scale and bias applied in f32, output bf16;
- ``Dense``/``DenseGeneral``: input, kernel and bias cast to bf16, the
  product rounded to bf16 before the bias is added;
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


class Dense(nn.Module):
    """flax ``Dense``/``DenseGeneral``: contracts the trailing ``len(in_shape)``
    axes of x with a ``(*in_shape, *out_shape)`` kernel, in bf16."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int]):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.kernel = nn.Parameter(torch.empty(*self.in_shape, *self.out_shape))
        self.bias = nn.Parameter(torch.zeros(*self.out_shape))

    def reset_parameters(self, gen: torch.Generator) -> None:
        fan_in = math.prod(self.in_shape)
        std = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.kernel, std=std, a=-2 * std, b=2 * std, generator=gen)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_in = len(self.in_shape)
        lead = x.shape[: x.dim() - n_in]
        w = self.kernel.to(BF16).reshape(math.prod(self.in_shape), -1)
        y = torch.matmul(x.to(BF16).reshape(*lead, -1), w)
        y = y + self.bias.to(BF16).reshape(-1)
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


class Block(nn.Module):
    """Pre-LN causal self-attention + MLP block, bf16 compute."""

    def __init__(self, cfg: ModelConfig, attn_fn: Optional[Callable] = None):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model)
        self.attn = ProjectedAttention(cfg, attn_fn or dense_self_attention)
        self.ln2 = LayerNorm(cfg.d_model)
        self.up = Dense((cfg.d_model,), (cfg.d_ff,))
        self.down = Dense((cfg.d_ff,), (cfg.d_model,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        h = F.gelu(self.up(self.ln2(x)), approximate="tanh")
        return x + self.down(h)


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
            if isinstance(mod, Dense):
                mod.reset_parameters(gen)

    def forward(self, tokens: torch.Tensor, pos_offset: int = 0) -> torch.Tensor:
        """Logits of ``tokens``, which sit at positions ``pos_offset`` on in
        the sequence: a rank holding chunk r of a sequence split over sp
        passes r * L, where the JAX model sees the whole sequence."""
        n = tokens.shape[1]
        if pos_offset < 0 or pos_offset + n > self.cfg.max_seq:
            raise ValueError(f"positions [{pos_offset}, {pos_offset + n}) outside max_seq "
                             f"{self.cfg.max_seq}")
        x = self.embed(tokens)
        x = x + self.pos_embed[pos_offset:pos_offset + n].to(BF16)
        for block in self.blocks:
            if self.cfg.remat and torch.is_grad_enabled():
                # no dropout or other draw in either model family (nor in
                # the flax zoo), so the recompute needs no RNG state, and
                # stashing the CUDA one would not survive a graph capture
                x = checkpoint(block, x, use_reentrant=False, preserve_rng_state=False)
            else:
                x = block(x)
        return self.lm_head(self.ln_f(x)).float()


def lm_config(name: str) -> ModelConfig:
    """The config of a zoo LM this port can build; unknown names raise
    ``ValueError``, the CNN and MoE families ``NotImplementedError``."""
    try:
        cfg = MODEL_CONFIGS[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; known: {sorted(MODEL_CONFIGS)}") from None
    if isinstance(cfg, CnnConfig):
        raise NotImplementedError(
            f"{name!r} is a CNN config; the CNN is not ported yet (ROADMAP.md, Queue 1)"
        )
    if cfg.n_experts:
        raise NotImplementedError(
            f"{name!r} is an MoE config; MoE is not ported yet (ROADMAP.md, Queue 1)"
        )
    return cfg


def build_model(name: str, *, attn_fn: Optional[Callable] = None):
    """(module, cfg) for a zoo name, parameters uninitialised (call
    ``reset_parameters`` or load a state_dict) on the default device.
    ``attn_fn`` swaps the attention core; None is the dense
    ``nn.SelfAttention`` core."""
    cfg = lm_config(name)
    return TransformerLM(cfg, attn_fn), cfg

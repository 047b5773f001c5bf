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


def _one_rank(tp):
    """``tp``, or the tp of one rank, whose splits and collectives are no-ops
    (imported here: the parallel package imports this module)."""
    if tp is not None:
        return tp
    from gpuschedule_tpu_torch.parallel.tp import NO_TP

    return NO_TP


def lecun_normal_(weight: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's ``lecun_normal`` in place: std 1/sqrt(fan_in) after truncation."""
    std = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=gen)


class Dense(nn.Module):
    """flax ``Dense``/``DenseGeneral``: contracts the trailing ``len(in_shape)``
    axes of x with a ``(*in_shape, *out_shape)`` kernel, in ``dtype``.

    With ``tp`` (:class:`~gpuschedule_tpu_torch.parallel.tp.Tp`) and
    ``split``, the kernel's dim ``split`` is split over tp and this rank
    holds its slice.  A split output dim is column-parallel: the output is
    the rank's slice, its bias the rank's slice of the bias when
    ``split_bias``, else the replicated bias's slice taken through f.  A
    split input dim is row-parallel: the partial products are summed over
    tp (g) and the replicated bias is added once, after the sum.  The
    caller passes a column layer's input through f."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int],
                 dtype: torch.dtype = BF16, *, tp=None, split: Optional[int] = None,
                 split_bias: bool = False):
        super().__init__()
        self.full_shape = (*in_shape, *out_shape)
        self.n_in = len(in_shape)
        self.tp = _one_rank(tp)
        self.split = split if self.tp.size > 1 else None
        shape = list(self.full_shape)
        if self.split is not None:
            shape[self.split] //= self.tp.size
        self.in_shape, self.out_shape = tuple(shape[:self.n_in]), tuple(shape[self.n_in:])
        self.bias_split = (self.split - self.n_in if self.split is not None
                           and self.split >= self.n_in else None)
        self.split_bias = split_bias and self.bias_split is not None
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(*self.in_shape, *self.out_shape))
        self.bias = nn.Parameter(torch.zeros(
            *(self.out_shape if self.split_bias else self.full_shape[self.n_in:])))

    def reset_parameters(self, gen: torch.Generator) -> None:
        """flax's init of the whole kernel, of which this rank keeps its slice."""
        full = torch.empty(self.full_shape, device=self.kernel.device)
        lecun_normal_(full, math.prod(self.full_shape[:self.n_in]), gen)
        with torch.no_grad():
            self.kernel.copy_(self.tp.shard(full, self.split))
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[: x.dim() - self.n_in]
        w = self.kernel.to(self.dtype).reshape(math.prod(self.in_shape), -1)
        y = torch.matmul(x.to(self.dtype).reshape(*lead, -1), w)
        if self.split is not None and self.split < self.n_in:
            y = self.tp.reduce(y)
        bias = self.bias
        if self.bias_split is not None and not self.split_bias:
            bias = self.tp.shard(self.tp.copy(bias), self.bias_split)
        y = y + bias.to(self.dtype).reshape(-1)
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
    """flax ``Embed(dtype=bf16)``: the table is cast to bf16, then looked up.
    Over tp the table splits over vocab: a rank looks up the tokens in its
    rows, zeroes the others, and the ranks' lookups are summed (g)."""

    def __init__(self, vocab: int, dim: int, tp=None):
        super().__init__()
        self.tp = _one_rank(tp)
        self.vocab = vocab
        self.embedding = nn.Parameter(torch.empty(self.tp.part(vocab)[1], dim))

    def reset_parameters(self, gen: torch.Generator) -> None:
        dim = self.embedding.shape[1]
        full = torch.empty(self.vocab, dim, device=self.embedding.device)
        with torch.no_grad():
            full.normal_(0.0, 1.0 / math.sqrt(dim), generator=gen)
            self.embedding.copy_(self.tp.shard(full, 0))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        if self.tp.size == 1:
            return F.embedding(tokens, self.embedding.to(BF16))
        v0, n = self.tp.part(self.vocab)
        local = tokens - v0
        inside = (local >= 0) & (local < n)
        rows = F.embedding(local.clamp(0, n - 1), self.embedding.to(BF16))
        return self.tp.reduce(rows * inside[..., None])


def dense_self_attention(q, k, v, *, causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """The attention core of flax ``nn.SelfAttention`` with a causal mask,
    in bf16: (B, S, H, D) in and out.  Plain PyTorch, no kernel of ours —
    the JAX package's dense path runs none either.  ``q_offset`` is the
    position of q's first row among k's (q a chunk of a longer sequence
    whose keys are all present): the causal mask lets row i see keys
    up to ``q_offset + i``."""
    depth = q.shape[-1]
    q = q / torch.tensor(math.sqrt(depth), dtype=torch.float32).to(q.dtype)
    w = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if causal:
        mask = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool,
                          device=q.device).tril(q_offset)
        w = w.masked_fill(~mask, torch.finfo(w.dtype).min)
    e = torch.exp(w - w.amax(dim=-1, keepdim=True))
    w = e / e.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


class ProjectedAttention(nn.Module):
    """QKV/out projections around an attention core ``attn_fn(q, k, v)`` on
    (B, S, H, head) tensors.  Parameter names mirror ``nn.SelfAttention``
    (query/key/value/out), so both paths load the same flax tree.  Over tp
    a rank holds H/tp heads: q/k/v column-parallel on its heads (their
    biases replicated, sliced through f), the core on them alone, ``out``
    row-parallel."""

    def __init__(self, cfg: ModelConfig, attn_fn: Callable, tp=None):
        super().__init__()
        if cfg.d_model % cfg.n_heads != 0:
            raise ValueError(f"d_model {cfg.d_model} not divisible by n_heads {cfg.n_heads}")
        head = cfg.d_model // cfg.n_heads
        self.tp = _one_rank(tp)
        self.attn_fn = attn_fn
        self.query = Dense((cfg.d_model,), (cfg.n_heads, head), tp=tp, split=1)
        self.key = Dense((cfg.d_model,), (cfg.n_heads, head), tp=tp, split=1)
        self.value = Dense((cfg.d_model,), (cfg.n_heads, head), tp=tp, split=1)
        self.out = Dense((cfg.n_heads, head), (cfg.d_model,), tp=tp, split=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.tp.copy(x)
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
    when that weight is above 0: flax sows it, here it is returned.

    Over ranks (:attr:`tokens`, a
    :class:`~gpuschedule_tpu_torch.parallel.tp.TokenLayout` the trainer
    sets) the module routes the global batch, as the JAX module does under
    GSPMD: capacity from the global token count, each slot the local
    running count plus the picks ahead of this rank's rows in the global
    order (one all-reduce), f_e global; the aux returned is this rank's
    share, which summed over the dp x sp ranks is the global aux.  With
    ep-over-tp (``tp``) a rank holds E/tp experts: the router stays
    replicated, each rank builds dispatch and combine for its own tokens
    and experts (an empty slot's output meets a zero combine weight, so no
    token leaves its rank), the dispatch input and the gates pass through
    f, and the local experts' outputs are summed over tp (g)."""

    def __init__(self, cfg: ModelConfig, tp=None):
        super().__init__()
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.n_experts, self.top_k = e, max(1, int(cfg.router_top_k))
        if self.top_k > e:
            raise ValueError(f"router_top_k={self.top_k} exceeds n_experts={e}")
        self.tp = _one_rank(tp)
        self.e0, self.local_experts = self.tp.part(e)
        self.capacity_factor = cfg.capacity_factor
        self.z_weight = cfg.router_z_weight
        self.tokens = None  # a TokenLayout over ranks; None: this module's tokens are all
        self.router = Dense((d,), (e,), dtype=torch.float32)
        el = self.local_experts
        self.w_up = nn.Parameter(torch.empty(el, d, f))
        self.b_up = nn.Parameter(torch.zeros(el, f))
        self.w_down = nn.Parameter(torch.empty(el, f, d))
        self.b_down = nn.Parameter(torch.zeros(el, d))

    def reset_parameters(self, gen: torch.Generator) -> None:
        """The expert weights; the router is a :class:`Dense`.  jax's
        ``lecun_normal`` folds the leading (expert) axis of a 3-D kernel
        into the receptive field, so the fan-in is E·d (E·d_ff), not d.
        Each is drawn whole, and this rank keeps its experts."""
        e = self.n_experts
        for w in (self.w_up, self.w_down):
            full = torch.empty((e,) + tuple(w.shape[1:]), device=w.device)
            lecun_normal_(full, e * w.shape[1], gen)
            with torch.no_grad():
                w.copy_(self.tp.shard(full, 0))
        with torch.no_grad():
            self.b_up.zero_()
            self.b_down.zero_()

    def route(self, x: torch.Tensor):
        """(dispatch, combine, aux) for the tokens of ``x`` (B, S, d):
        dispatch and combine (T, E/tp, cap) bf16 over this rank's experts,
        aux a scalar f32 (this rank's share over ranks)."""
        e, k = self.n_experts, self.top_k
        rows, n = x.shape[0], x.shape[1]
        t = rows * n
        layout = self.tokens
        t_all = t if layout is None else layout.tokens(n)
        cap = max(1, int(self.capacity_factor * t_all / e))
        logits = self.router(x.float()).reshape(t, e)
        probs = torch.softmax(logits, dim=-1)
        top_probs, top_idx = torch.topk(probs, k, dim=-1)  # (T, k)
        gates = top_probs / top_probs.sum(dim=-1, keepdim=True) if k > 1 else top_probs
        experts = torch.arange(e, device=x.device)
        onehots = (top_idx[..., None] == experts).float()  # (T, k, E)
        # running counts of each choice rank's picks of each expert along
        # each row, taken along the last axis of a (rows, k, E, S) copy (a
        # scan down T rows of (T, E) runs E lanes wide on the card); exact:
        # integers < 2^24.  ``before`` counts the picks of the rows (row
        # chunks) ahead in the global order, ``total`` all of them.
        count = torch.cumsum(onehots.view(rows, n, k, e).permute(0, 2, 3, 1).contiguous(), dim=-1)
        if layout is None:
            row_total = count[..., -1]
            before, total = row_total.cumsum(dim=0) - row_total, row_total.sum(dim=0)
        else:
            before, total = layout.offsets(count[..., -1])
        frac = total.sum(dim=0) / t_all
        aux = e / k * (frac * (probs.sum(dim=0) / t_all)).sum()
        if self.z_weight > 0.0:
            aux = aux + self.z_weight * (torch.logsumexp(logits, dim=-1) ** 2).sum() / t_all
        if layout is not None:
            aux = aux / layout.replicas
        # slots, choice-major, over this rank's experts: within choice j the
        # chosen column holds the token's slot (>= 0) and the others -1, so
        # the row max extracts it (a row sum would add the -1s); a token
        # that chose another rank's expert gets -1.  A slot outside
        # [0, cap) matches no column of the slot one-hot: the choice drops.
        lo, el = self.e0, self.local_experts
        slots = torch.arange(cap, device=x.device, dtype=torch.float32)
        gates = self.tp.copy(gates)
        base = torch.zeros(el, device=x.device)
        dispatch = combine = None
        for j in range(k):
            oh = onehots[:, j, lo:lo + el]  # (T, E/tp)
            run = count[:, j, lo:lo + el] + before[:, j, lo:lo + el, None]  # (rows, E/tp, S)
            pos = ((run.permute(0, 2, 1).reshape(t, el) + base) * oh - 1.0).amax(dim=-1)
            slot = (pos[:, None] == slots).to(BF16)[:, None, :]  # (T, 1, cap)
            # oh·slot·gate is one product that is not 0 a row, exact in f32,
            # so rounding the (T, E) factor first gives flax's bf16 term
            d_j = oh.to(BF16)[:, :, None] * slot
            c_j = (oh * gates[:, j, None]).to(BF16)[:, :, None] * slot
            dispatch = d_j if dispatch is None else dispatch + d_j
            combine = c_j if combine is None else combine + c_j
            base = base + total[j, lo:lo + el]
        return dispatch, combine, aux

    def forward(self, x: torch.Tensor):
        """(y, aux): the (B, S, d) bf16 output and the aux loss."""
        b, s, d = x.shape
        dispatch, combine, aux = self.route(x)
        xf = self.tp.copy(x.reshape(b * s, d).to(BF16))
        expert_in = torch.einsum("td,tec->ecd", xf, dispatch)
        h = (torch.einsum("ecd,edf->ecf", expert_in, self.w_up.to(BF16))
             + self.b_up[:, None, :].to(BF16))
        h = F.gelu(h, approximate="tanh")
        out = (torch.einsum("ecf,efd->ecd", h, self.w_down.to(BF16))
               + self.b_down[:, None, :].to(BF16))
        y = self.tp.reduce(torch.einsum("ecd,tec->td", out, combine))
        return y.reshape(b, s, d), aux


class Block(nn.Module):
    """Pre-LN causal self-attention + MLP block, bf16 compute.  The MLP is
    a dense FFN, or a :class:`MoeMlp` when the config sets ``n_experts``.
    Over tp the dense FFN's ``up`` is column-parallel (its input through
    f), ``down`` row-parallel."""

    def __init__(self, cfg: ModelConfig, attn_fn: Optional[Callable] = None, tp=None):
        super().__init__()
        self.tp = _one_rank(tp)
        self.ln1 = LayerNorm(cfg.d_model)
        self.attn = ProjectedAttention(cfg, attn_fn or dense_self_attention, tp)
        self.ln2 = LayerNorm(cfg.d_model)
        self.is_moe = bool(cfg.n_experts)
        if self.is_moe:
            self.moe = MoeMlp(cfg, tp)
        else:
            self.up = Dense((cfg.d_model,), (cfg.d_ff,), tp=tp, split=1, split_bias=True)
            self.down = Dense((cfg.d_ff,), (cfg.d_model,), tp=tp, split=0)

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
        h = F.gelu(self.up(self.tp.copy(h)), approximate="tanh")
        return x + self.down(h), None


class TransformerLM(nn.Module):
    """Causal LM: embed → blocks → final LN → f32 logits.  With
    ``cfg.remat`` each block is recomputed in the backward
    (``torch.utils.checkpoint``, the counterpart of ``nn.remat``).

    ``tp`` (:class:`~gpuschedule_tpu_torch.parallel.tp.Tp`) splits the
    model over the mesh's tp ranks by the JAX partition table
    (:func:`~gpuschedule_tpu_torch.parallel.tp.param_partition_spec`):
    each rank holds its slice of each split parameter, the slice of the
    parameter a one-rank model draws from the same generator, and the
    logits are its (B, S, V/tp) slice of the vocab."""

    def __init__(self, cfg: ModelConfig, attn_fn: Optional[Callable] = None, tp=None):
        super().__init__()
        self.cfg = cfg
        self.tp = _one_rank(tp)
        for what, n in (("n_heads", cfg.n_heads), ("d_ff", cfg.d_ff), ("vocab", cfg.vocab),
                        ("n_experts", cfg.n_experts or self.tp.size)):
            if n % self.tp.size:
                raise ValueError(f"{what} {n} of {cfg.name!r} not divisible by tp={self.tp.size}")
        self.embed = Embed(cfg.vocab, cfg.d_model, tp)
        self.pos_embed = nn.Parameter(torch.empty(cfg.max_seq, cfg.d_model))
        self.blocks = nn.ModuleList(Block(cfg, attn_fn, tp) for _ in range(cfg.n_layers))
        self.ln_f = LayerNorm(cfg.d_model)
        self.lm_head = Dense((cfg.d_model,), (cfg.vocab,), tp=tp, split=1)

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
        the flax model sows into ``moe_losses``.  It is the three stage
        pieces in a row: :meth:`embed_tokens`, :meth:`run_blocks` and
        :meth:`head`, which the pipeline runs on their own stages."""
        x, aux = self.run_blocks(self.embed_tokens(tokens, pos_offset))
        return self.head(x), aux

    def embed_tokens(self, tokens: torch.Tensor, pos_offset: int = 0) -> torch.Tensor:
        """The token and position embedding of ``tokens`` at positions
        ``pos_offset`` on (flax's ``Embedder``, the pipeline's first
        boundary): (B, S, d) bf16."""
        n = tokens.shape[1]
        if pos_offset < 0 or pos_offset + n > self.cfg.max_seq:
            raise ValueError(f"positions [{pos_offset}, {pos_offset + n}) outside max_seq "
                             f"{self.cfg.max_seq}")
        return self.embed(tokens) + self.pos_embed[pos_offset:pos_offset + n].to(BF16)

    def run_blocks(self, x: torch.Tensor):
        """(x, aux): ``x`` through this module's blocks, each recomputed in
        the backward when ``cfg.remat`` is set, and the MoE blocks' aux
        losses in block order."""
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
        return x, aux

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The final LayerNorm and the f32 logits (flax's ``LMHead``, the
        pipeline's last boundary)."""
        return self.lm_head(self.tp.copy(self.ln_f(x))).float()


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


def build_model(name: str, *, attn_fn: Optional[Callable] = None, tp=None):
    """(module, cfg) for a zoo name, parameters uninitialised (call
    ``reset_parameters`` or load a state_dict) on the default device: a
    :class:`TransformerLM` (dense or MoE MLP) or a CNN
    (:class:`~gpuschedule_tpu_torch.models.cnn.ResNet`).  ``attn_fn`` swaps
    the LM's attention core; None is the dense ``nn.SelfAttention`` core.
    ``tp`` splits an LM over tp ranks; a CNN has no parameter the
    partition table splits, so its tp ranks hold replicas."""
    cfg = model_config(name, attn_fn)
    if isinstance(cfg, CnnConfig):
        from gpuschedule_tpu_torch.models.cnn import ResNet

        return ResNet(cfg), cfg
    return TransformerLM(cfg, attn_fn, tp), cfg

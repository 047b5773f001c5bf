"""Dense-attention oracle (counterpart of ``gpuschedule_tpu.ops.reference``)."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30  # mask value: exp(NEG_INF - m) underflows to exactly 0 in f32


def dense_attention(q, k, v, *, causal: bool) -> torch.Tensor:
    """Plain (B, S, H, D) attention; f32 math, input dtype out."""
    d = q.shape[-1]
    logits = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) / math.sqrt(d)
    if causal:
        s_q, s_k = q.shape[1], k.shape[1]
        mask = (
            torch.arange(s_q, device=q.device)[:, None]
            >= torch.arange(s_k, device=q.device)[None, :]
        )
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhlm,bmhd->blhd", w, v.float())
    return out.to(q.dtype)

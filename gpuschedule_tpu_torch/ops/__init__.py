"""Attention ops: the dense oracle and flash attention (CUDA kernels)."""

from gpuschedule_tpu_torch.ops.flash_attention import flash_attention
from gpuschedule_tpu_torch.ops.reference import NEG_INF, dense_attention

__all__ = ["flash_attention", "dense_attention", "NEG_INF"]

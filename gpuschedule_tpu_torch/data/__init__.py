"""Token batches (own copy of the JAX package's numpy stream)."""

from gpuschedule_tpu_torch.data.loader import synthetic_lm_batches

__all__ = ["synthetic_lm_batches"]

"""Token datasets, the synthetic stream and device prefetch (own copy of
the JAX package's numpy loader)."""

from gpuschedule_tpu_torch.data.loader import (
    BatchSharding,
    TokenFileDataset,
    prefetch_to_device,
    synthetic_lm_batches,
)

__all__ = ["BatchSharding", "TokenFileDataset", "prefetch_to_device", "synthetic_lm_batches"]

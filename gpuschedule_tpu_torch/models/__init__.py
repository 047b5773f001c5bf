"""Model zoo: configs (own copy), the transformer LM (dense or MoE MLP) and
the ResNet classifier (:mod:`.cnn`)."""

from gpuschedule_tpu_torch.models.config import (
    FALLBACK_MODEL,
    MODEL_CONFIGS,
    CnnConfig,
    ModelConfig,
    resolve_model_config,
)
from gpuschedule_tpu_torch.models.transformer import TransformerLM, build_model

__all__ = [
    "FALLBACK_MODEL", "MODEL_CONFIGS", "CnnConfig", "ModelConfig",
    "resolve_model_config", "TransformerLM", "build_model",
]

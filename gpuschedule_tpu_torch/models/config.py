"""Model configs — the port's own copy of ``gpuschedule_tpu.models.config``.

The port imports nothing of the JAX package, so the zoo is duplicated here
field for field; ``tests/test_torch_model.py`` holds the two copies equal.
The dataclasses carry what the simulator needs (parameter count, FLOPs
estimate) and import no accelerator stack.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab: int = 8192
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    d_ff: int = 512
    max_seq: int = 512
    remat: bool = False
    # n_experts > 0 turns each block's MLP into a routed MoE (models/transformer.py:MoeMlp)
    n_experts: int = 0
    capacity_factor: float = 1.25
    # experts each token routes to (1 = Switch, 2 = GShard-style top-2)
    router_top_k: int = 1
    # router z-loss coefficient relative to the trainer's moe_aux_weight
    router_z_weight: float = 0.0

    def __post_init__(self):
        if self.n_experts and not (1 <= self.router_top_k <= self.n_experts):
            raise ValueError(
                f"router_top_k={self.router_top_k} must be in "
                f"[1, n_experts={self.n_experts}]"
            )

    @property
    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks).  MoE configs
        hold n_experts copies of each FFN plus a router."""
        ffn = 2 * self.d_model * self.d_ff
        per_block = 4 * self.d_model * self.d_model + max(1, self.n_experts) * ffn
        if self.n_experts:
            per_block += self.d_model * self.n_experts  # router
        return self.vocab * self.d_model + self.n_layers * per_block

    @property
    def active_param_count(self) -> int:
        """Params a single token exercises: k expert FFNs per block for a
        top-k MoE, all of them for a dense config."""
        if not self.n_experts:
            return self.param_count
        ffn = 2 * self.d_model * self.d_ff
        inactive = max(0, self.n_experts - self.router_top_k)
        return self.param_count - self.n_layers * inactive * ffn

    def flops_per_token(self) -> float:
        """~6N FLOPs/token for fwd+bwd, N = active params."""
        return 6.0 * self.active_param_count

    def flops_per_token_attn(self, seq_len: int) -> float:
        """6N plus the causal-attention matmul FLOPs, which 6N ignores and
        which dominate at long context: 6·L·S·d per token."""
        return self.flops_per_token() + 6.0 * self.n_layers * seq_len * self.d_model


@dataclass(frozen=True)
class CnnConfig:
    """Residual CNN classifier — the vision-model family (models/cnn.py)."""

    name: str
    channels: tuple = (64, 128, 256)
    blocks_per_stage: int = 2
    image_size: int = 32
    num_classes: int = 100

    @property
    def param_count(self) -> int:
        """Approximate parameter count (3x3 conv pairs per block + head)."""
        total = 3 * 3 * 3 * self.channels[0]          # stem
        prev = self.channels[0]
        for ch in self.channels:
            total += 3 * 3 * prev * ch
            total += (2 * self.blocks_per_stage - 1) * 3 * 3 * ch * ch
            prev = ch
        return total + prev * self.num_classes        # linear head

    def flops_per_token(self) -> float:
        """FLOPs per *sample* (fwd+bwd), named for interface parity with
        :class:`ModelConfig`."""
        hw = self.image_size * self.image_size
        fl = 2 * 3 * 3 * 3 * self.channels[0] * hw
        prev = self.channels[0]
        for ch in self.channels:
            fl += 2 * 3 * 3 * prev * ch * hw
            fl += (2 * self.blocks_per_stage - 1) * 2 * 3 * 3 * ch * ch * hw
            hw //= 4  # stage downsamples 2x in each spatial dim
            prev = ch
        return 3.0 * fl


# Unknown-model fallback: the zoo median, as in the JAX package.
FALLBACK_MODEL = "transformer-small"


def resolve_model_config(model_name) -> "ModelConfig | CnnConfig":
    """The config for ``model_name``, or the :data:`FALLBACK_MODEL` config
    when the name is unknown (or None)."""
    cfg = MODEL_CONFIGS.get(model_name)
    return cfg if cfg is not None else MODEL_CONFIGS[FALLBACK_MODEL]


MODEL_CONFIGS: Dict[str, "ModelConfig | CnnConfig"] = {
    cfg.name: cfg
    for cfg in (
        CnnConfig("resnet-tiny", channels=(32, 64), blocks_per_stage=1),
        CnnConfig("resnet-mid", channels=(64, 128, 256), blocks_per_stage=2),
        ModelConfig("transformer-tiny", d_model=128, n_layers=2, n_heads=4, d_ff=512),
        ModelConfig("transformer-small", d_model=256, n_layers=4, n_heads=8, d_ff=1024),
        ModelConfig("transformer-base", d_model=512, n_layers=8, n_heads=8, d_ff=2048),
        # the flagship dense bench config
        ModelConfig(
            "transformer-large", d_model=1536, n_layers=12, n_heads=16, d_ff=6144
        ),
        # the flash-attention config: S=4096, head dim 32, remat
        ModelConfig(
            "transformer-long",
            d_model=256,
            n_layers=4,
            n_heads=8,
            d_ff=1024,
            max_seq=4096,
            remat=True,
        ),
        ModelConfig(
            "transformer-xlong",
            d_model=512,
            n_layers=6,
            n_heads=8,
            d_ff=2048,
            max_seq=32768,
            remat=True,
        ),
        ModelConfig("mlp-wide", d_model=256, n_layers=2, n_heads=2, d_ff=4096),
        ModelConfig(
            "transformer-moe",
            d_model=256,
            n_layers=4,
            n_heads=8,
            d_ff=1024,
            n_experts=8,
        ),
        ModelConfig(
            "moe-tiny", d_model=128, n_layers=2, n_heads=4, d_ff=256,
            n_experts=4,
        ),
        ModelConfig(
            "transformer-moe-top2",
            d_model=256, n_layers=4, n_heads=8, d_ff=1024, n_experts=8,
            router_top_k=2, router_z_weight=0.1, capacity_factor=2.0,
        ),
        ModelConfig(
            "moe-top2-tiny", d_model=128, n_layers=2, n_heads=4, d_ff=256,
            n_experts=4, router_top_k=2, router_z_weight=0.1,
            capacity_factor=2.0,
        ),
    )
}

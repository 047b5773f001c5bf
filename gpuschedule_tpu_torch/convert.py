"""Flax parameter trees -> this package's ``state_dict``.

The port's modules keep flax's parameter names and shapes, so the mapping
is by path alone: ``block{i}/attn/query/kernel`` becomes
``blocks.{i}.attn.query.kernel``, ``embed/embedding`` becomes
``embed.embedding``, and ``pos_embed``, ``ln_f`` and ``lm_head`` keep their
names.  Arrays arrive as numpy (``jax.device_get`` of the tree); nothing
here imports JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from gpuschedule_tpu_torch.models.config import ModelConfig

_BLOCK_LEAVES = (
    ("attn", "query", "kernel"), ("attn", "query", "bias"),
    ("attn", "key", "kernel"), ("attn", "key", "bias"),
    ("attn", "value", "kernel"), ("attn", "value", "bias"),
    ("attn", "out", "kernel"), ("attn", "out", "bias"),
    ("up", "kernel"), ("up", "bias"),
    ("down", "kernel"), ("down", "bias"),
    ("ln1", "scale"), ("ln1", "bias"),
    ("ln2", "scale"), ("ln2", "bias"),
)
_TOP_LEAVES = (
    ("embed", "embedding"), ("pos_embed",),
    ("ln_f", "scale"), ("ln_f", "bias"),
    ("lm_head", "kernel"), ("lm_head", "bias"),
)


def _get(tree: Mapping, path) -> np.ndarray:
    node = tree
    for name in path:
        node = node[name]
    return np.asarray(node)


def params_from_jax(params: Mapping, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The ``TransformerLM`` state_dict holding the flax LM parameters
    ``params`` (the ``"params"`` collection, or the dict that wraps it).
    Raises ``KeyError`` naming the flax path of any missing leaf."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    paths = [((f"block{i}", *leaf), f"blocks.{i}." + ".".join(leaf))
             for i in range(cfg.n_layers) for leaf in _BLOCK_LEAVES]
    paths += [(leaf, ".".join(leaf)) for leaf in _TOP_LEAVES]
    for flax_path, name in paths:
        try:
            arr = _get(params, flax_path)
        except KeyError:
            raise KeyError(f"flax parameter {'/'.join(flax_path)} is missing") from None
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return out

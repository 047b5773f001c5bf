"""Flax parameter trees -> this package's ``state_dict``.

The port's modules keep flax's parameter names and shapes, so the mapping
is by path alone: a ``state_dict`` name is the flax path joined by dots,
but for the LM's blocks, which flax names ``block{i}`` and the port keeps
in ``blocks.{i}`` (``block0/attn/query/kernel`` is
``blocks.0.attn.query.kernel``).  The names to fill are the state_dict of
the config's own module, built on the meta device, so the mapping follows
the modules (dense or MoE MLP, CNN) with no list of its own.  Arrays
arrive as numpy (``jax.device_get`` of the tree); nothing here imports JAX.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from gpuschedule_tpu_torch.models.cnn import ResNet
from gpuschedule_tpu_torch.models.config import CnnConfig, ModelConfig
from gpuschedule_tpu_torch.models.transformer import TransformerLM


def _get(tree: Mapping, path) -> np.ndarray:
    node = tree
    for name in path:
        node = node[name]
    return np.asarray(node)


def params_from_jax(params: Mapping, cfg: "ModelConfig | CnnConfig") -> Dict[str, torch.Tensor]:
    """The state_dict of ``cfg``'s module (a ``TransformerLM``, dense or
    MoE, or a ``ResNet``) holding the flax parameters ``params`` (the
    ``"params"`` collection, or the dict that wraps it).  Raises
    ``KeyError`` naming the flax path of any missing leaf.  ``cfg`` may be
    the JAX package's config of the same model: a config with ``channels``
    is a CNN's."""
    if "params" in params:
        params = params["params"]
    with torch.device("meta"):
        module = ResNet(cfg) if hasattr(cfg, "channels") else TransformerLM(cfg)
    out: Dict[str, torch.Tensor] = {}
    for name in module.state_dict():
        flax_path = re.sub(r"^blocks\.(\d+)\.", r"block\1.", name).split(".")
        try:
            arr = _get(params, flax_path)
        except KeyError:
            raise KeyError(f"flax parameter {'/'.join(flax_path)} is missing") from None
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return out

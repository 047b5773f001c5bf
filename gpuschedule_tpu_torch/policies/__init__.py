"""Scheduling policies (own copies of the JAX package's).

Registry maps CLI names to policy factories; policies plug into the engine via
the :class:`gpuschedule_tpu_torch.policies.base.Policy` interface.
"""

from gpuschedule_tpu_torch.policies.base import Policy
from gpuschedule_tpu_torch.policies.dlas import DlasPolicy
from gpuschedule_tpu_torch.policies.fifo import FifoPolicy
from gpuschedule_tpu_torch.policies.gandiva import GandivaPolicy
from gpuschedule_tpu_torch.policies.optimus import OptimusPolicy
from gpuschedule_tpu_torch.policies.srtf import SrtfPolicy
from gpuschedule_tpu_torch.policies.themis import ThemisPolicy

_REGISTRY = {
    "fifo": FifoPolicy,
    "srtf": SrtfPolicy,
    "dlas": DlasPolicy,
    "gandiva": GandivaPolicy,
    "optimus": OptimusPolicy,
    "themis": ThemisPolicy,
}


def register(name: str, factory) -> None:
    _REGISTRY[name] = factory


def make_policy(name: str, **kwargs) -> Policy:
    """Instantiate a registered policy by CLI name (e.g. 'fifo', 'dlas')."""
    try:
        return _REGISTRY[name](**kwargs)
    except KeyError:
        raise ValueError(f"unknown policy {name!r}; known: {sorted(_REGISTRY)}") from None


def available() -> list[str]:
    return sorted(_REGISTRY)


__all__ = [
    "Policy",
    "FifoPolicy",
    "SrtfPolicy",
    "DlasPolicy",
    "GandivaPolicy",
    "OptimusPolicy",
    "ThemisPolicy",
    "make_policy",
    "available",
    "register",
]

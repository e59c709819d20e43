"""Config registry of the port: the OPT family and its ``-reduced`` variants."""
from __future__ import annotations

from repro_torch.configs import opt as _opt
from repro_torch.configs.base import ModelConfig, reduced

REGISTRY = dict(_opt.CONFIGS)


def get_config(name: str) -> ModelConfig:
    """Resolve ``<id>``; ``<id>-reduced`` gives the smoke variant."""
    if name in REGISTRY:
        return REGISTRY[name]
    if name.endswith("-reduced") and name[: -len("-reduced")] in REGISTRY:
        return reduced(REGISTRY[name[: -len("-reduced")]])
    raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")


__all__ = ["ModelConfig", "REGISTRY", "get_config", "reduced"]

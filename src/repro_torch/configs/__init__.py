"""Config registry of the port: OPT, yi-6b, minitron-4b, gemma3-1b,
gemma3-27b, mamba2-2.7b, jamba-1.5-large-398b, dbrx-132b, grok-1-314b,
whisper-base and qwen2-vl-2b (the reference's registry), and their
``-reduced`` variants; the input shapes of ``configs.shapes``."""
from __future__ import annotations

from repro_torch.configs import opt as _opt
from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.configs.dbrx_132b import CONFIG as DBRX_132B
from repro_torch.configs.gemma3_1b import CONFIG as GEMMA3_1B
from repro_torch.configs.gemma3_27b import CONFIG as GEMMA3_27B
from repro_torch.configs.grok_1_314b import CONFIG as GROK_1_314B
from repro_torch.configs.jamba_1_5_large import CONFIG as JAMBA_1_5_LARGE
from repro_torch.configs.mamba2_2_7b import CONFIG as MAMBA2_2_7B
from repro_torch.configs.minitron_4b import CONFIG as MINITRON_4B
from repro_torch.configs.qwen2_vl_2b import CONFIG as QWEN2_VL_2B
from repro_torch.configs.shapes import SHAPES, InputShape, applicable
from repro_torch.configs.whisper_base import CONFIG as WHISPER_BASE
from repro_torch.configs.yi_6b import CONFIG as YI_6B

# the assigned architectures, in the reference's order (its dry run and
# ``examples/arch_zoo.py`` walk them)
ASSIGNED = {c.name: c for c in (WHISPER_BASE, GEMMA3_27B, QWEN2_VL_2B,
                                GROK_1_314B, YI_6B, GEMMA3_1B, DBRX_132B,
                                JAMBA_1_5_LARGE, MINITRON_4B, MAMBA2_2_7B)}

REGISTRY = dict(ASSIGNED)
REGISTRY.update(_opt.CONFIGS)


def get_config(name: str) -> ModelConfig:
    """Resolve ``<id>``; ``<id>-reduced`` gives the smoke variant."""
    if name in REGISTRY:
        return REGISTRY[name]
    if name.endswith("-reduced") and name[: -len("-reduced")] in REGISTRY:
        return reduced(REGISTRY[name[: -len("-reduced")]])
    raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")


__all__ = ["ModelConfig", "InputShape", "SHAPES", "ASSIGNED", "REGISTRY",
           "get_config", "reduced", "applicable"]

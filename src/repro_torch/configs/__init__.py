"""Architecture registry: ``--arch <id>`` → (full config, smoke config).

Only the dense GQA decoder runs in the port so far; the registry holds the
architectures the port serves.
"""

from repro_torch.configs import qwen2_1_5b
from repro_torch.configs.base import ModelConfig, MoEConfig

_MODULES = {
    "qwen2-1.5b": qwen2_1_5b,
}

ARCH_IDS = tuple(_MODULES)

__all__ = ["ARCH_IDS", "ModelConfig", "MoEConfig", "get_config",
           "get_smoke_config"]


def get_config(arch: str) -> ModelConfig:
    return _MODULES[arch].CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _MODULES[arch].SMOKE

"""Architecture registry: ``--arch <id>`` → (full config, smoke config).

The registry holds every architecture of the reference's registry: the
language models (dense GQA, sliding-window ``local`` blocks,
mixture-of-experts FFNs, and the recurrent rglru and rwkv6 mixers), which
take token ids, and the two stub-frontend archs (musicgen-large,
phi-3-vision-4.2b: ``embed_inputs=False``), whose decoders take (B, S, D)
frame or patch embeddings from a frontend that is out of scope, as in the
reference. The serving launcher and engine take token ids only.
"""

from repro_torch.configs import (deepseek_moe_16b, gemma3_27b, grok1_314b,
                                 llama3_405b, musicgen_large,
                                 phi3_vision_4_2b, qwen2_1_5b, qwen15_32b,
                                 recurrentgemma_2b, rwkv6_3b)
from repro_torch.configs.base import ModelConfig, MoEConfig

_MODULES = {
    "qwen1.5-32b": qwen15_32b,
    "qwen2-1.5b": qwen2_1_5b,
    "llama3-405b": llama3_405b,
    "gemma3-27b": gemma3_27b,
    "grok-1-314b": grok1_314b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "rwkv6-3b": rwkv6_3b,
    "musicgen-large": musicgen_large,
    "phi-3-vision-4.2b": phi3_vision_4_2b,
}

ARCH_IDS = tuple(_MODULES)

__all__ = ["ARCH_IDS", "ModelConfig", "MoEConfig", "get_config",
           "get_smoke_config"]


def get_config(arch: str) -> ModelConfig:
    return _MODULES[arch].CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _MODULES[arch].SMOKE

from repro_torch.serving.api import (FINISH_REASONS, RequestHandle,
                                     RequestResult, SamplingParams)
from repro_torch.serving.engine import EngineConfig, ServingEngine

__all__ = ["EngineConfig", "FINISH_REASONS", "RequestHandle", "RequestResult",
           "SamplingParams", "ServingEngine"]

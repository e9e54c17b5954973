from repro_torch.serving.api import (FINISH_REASONS, RequestHandle,
                                     RequestResult, SamplingParams)
from repro_torch.serving.engine import (EngineConfig, EngineCrash, EngineFault,
                                        ServingEngine)
from repro_torch.serving.faults import FaultInjector, FaultPlan, VirtualClock

__all__ = ["EngineConfig", "EngineCrash", "EngineFault", "FINISH_REASONS",
           "FaultInjector", "FaultPlan", "RequestHandle", "RequestResult",
           "SamplingParams", "ServingEngine", "VirtualClock"]

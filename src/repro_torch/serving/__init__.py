from repro_torch.serving.api import (FINISH_REASONS, RequestHandle,
                                     RequestResult, SamplingParams)
from repro_torch.serving.engine import (EngineConfig, EngineCrash, EngineFault,
                                        SerialAdmitEngine, ServingEngine)
from repro_torch.serving.faults import FaultInjector, FaultPlan, VirtualClock
from repro_torch.serving.frontend import (DegradedError, DriverHandle,
                                          EngineDriver, EngineSupervisor,
                                          FairScheduler, HttpServer,
                                          ThreadedHttpServer)
from repro_torch.serving.observability import (PHASES, SERVING_METRICS,
                                               MetricsRegistry, Observability,
                                               TraceRecorder)

__all__ = ["DegradedError", "DriverHandle", "EngineConfig", "EngineCrash",
           "EngineDriver", "EngineFault", "EngineSupervisor",
           "FINISH_REASONS", "FairScheduler", "FaultInjector", "FaultPlan",
           "HttpServer", "MetricsRegistry", "Observability", "PHASES",
           "RequestHandle", "RequestResult", "SERVING_METRICS",
           "SamplingParams", "SerialAdmitEngine", "ServingEngine",
           "ThreadedHttpServer", "TraceRecorder", "VirtualClock"]

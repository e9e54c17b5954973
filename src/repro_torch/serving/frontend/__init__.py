"""``repro_torch.serving.frontend`` — the concurrent serving surface (v1.5),
the reference's ``repro.serving.frontend`` over the port's engine.

Four layers over the single-threaded engine:

* :mod:`~repro_torch.serving.frontend.driver` — :class:`EngineDriver`, the
  one thread that owns the device; thread-safe submit/cancel/stream/call.
* :mod:`~repro_torch.serving.frontend.fairness` — :class:`FairScheduler`,
  deficit-weighted round-robin admission across per-tenant queues.
* :mod:`~repro_torch.serving.frontend.server` — :class:`HttpServer` /
  :class:`ThreadedHttpServer`, the stdlib-asyncio HTTP + SSE endpoint.
* :mod:`~repro_torch.serving.frontend.supervisor` — :class:`EngineSupervisor`,
  crash-restart supervision: engine-death detection (driver fatal path +
  hung-step watchdog), rebuild from the engine factory with a new
  generation id, deterministic replay of in-flight requests, suspect
  blacklisting, and a crash-loop circuit breaker
  (:class:`DegradedError` → HTTP 503).

The frozen contract (threading rules, tenant field, HTTP status mapping,
recovery semantics) is the one the v1.4/v1.5 sections of the reference's
``repro.serving`` package docstring state; the modules are copies of the
reference's with the port's imports. What the card adds (a driver thread
that captures CUDA graphs while clients are live, an engine rebuilt on the
same device, an abandoned thread that may wake) is handled in the engine
and ``serving.graphs``, and in two lines of the driver: a reaped driver
drops its engine, and a retired handle drops the engine's handle, so a
dead generation's device memory is freed with its engine.
"""

from repro_torch.serving.frontend.driver import DriverHandle, EngineDriver
from repro_torch.serving.frontend.fairness import FairScheduler
from repro_torch.serving.frontend.server import (STATUS_BY_REASON, HttpServer,
                                           ThreadedHttpServer)
from repro_torch.serving.frontend.supervisor import (DegradedError,
                                               EngineSupervisor, StepTimeout)

__all__ = [
    "EngineDriver", "DriverHandle", "FairScheduler",
    "HttpServer", "ThreadedHttpServer", "STATUS_BY_REASON",
    "EngineSupervisor", "DegradedError", "StepTimeout",
]

"""Runtime services shared by the port's layers: the clock, and the
heartbeat monitor with the serving engine's health snapshot."""

from repro_torch.runtime import clock
from repro_torch.runtime.clock import MONOTONIC, WALL, Clock
from repro_torch.runtime.monitor import (HEARTBEAT_SCHEMA, HealthSnapshot,
                                         HeartbeatMonitor, StragglerDetector)

__all__ = ["Clock", "HEARTBEAT_SCHEMA", "HealthSnapshot", "HeartbeatMonitor",
           "MONOTONIC", "StragglerDetector", "WALL", "clock"]

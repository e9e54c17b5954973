"""Runtime services shared by the port's layers: the clock, the heartbeat
monitor with the serving engine's health snapshot, and training's
checkpoints and preemption guard."""

from repro_torch.runtime import clock
from repro_torch.runtime.checkpoint import (CheckpointManager, latest_step,
                                            load_checkpoint,
                                            restore_to_device,
                                            save_checkpoint)
from repro_torch.runtime.clock import MONOTONIC, WALL, Clock
from repro_torch.runtime.monitor import (HEARTBEAT_SCHEMA, HealthSnapshot,
                                         HeartbeatMonitor, StragglerDetector)
from repro_torch.runtime.preempt import PreemptionGuard

__all__ = ["CheckpointManager", "Clock", "HEARTBEAT_SCHEMA", "HealthSnapshot",
           "HeartbeatMonitor", "MONOTONIC", "PreemptionGuard",
           "StragglerDetector", "WALL", "clock", "latest_step",
           "load_checkpoint", "restore_to_device", "save_checkpoint"]

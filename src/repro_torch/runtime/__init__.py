"""Runtime services shared by the port's layers (so far the clock)."""

from repro_torch.runtime import clock
from repro_torch.runtime.clock import MONOTONIC, WALL, Clock

__all__ = ["Clock", "MONOTONIC", "WALL", "clock"]

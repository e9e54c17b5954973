"""The engine's compiled dispatches: CUDA graphs on the card, the eager body
on the CPU.

What a ``jax.jit`` program is to the reference engine on the TPU, a CUDA
graph is here: one launch of a fixed sequence of kernels over fixed
buffers. A dispatch body ``body(inp) -> out`` reads every per-dispatch
input from ``inp``, one flat int32 tensor (other dtypes ride in it
bit-cast), and returns one tensor; the state it updates in place (the KV
cache, positions) keeps its storage between calls (``models.transformer``).

``GraphDispatch`` captures such a body once and replays it:

  * before the capture the body (or a shorter ``warm`` body launching the
    same kernels: one decode step of a K-step loop) runs once eagerly on
    ``idle`` inputs, a no-op on the engine's state (rows inactive, lengths
    0): every kernel it launches is loaded and every first-use setting made
    (the kernels' shared-memory limits, the BLAS workspace), so the
    capture records stream work only;
  * the capture reads ``static_in`` and writes ``out`` in the engine's one
    graph memory pool; each call copies the host inputs into ``static_in``
    with one non-blocking copy from pinned memory, replays the graph on the
    current stream (the engine's) and returns ``out``, which the next
    replay overwrites;
  * ``launches``, the kernel launches the capture recorded, leave
    ``kernels._build.LAUNCHES`` at the capture and are added back at every
    replay, so the counts stay "launches executed".

``EagerDispatch`` runs the same body without a graph: on the CPU (where it
is the only path), and on the card when the engine's capture is switched
off (the eager-vs-graph comparison). Nothing falls back from one to the
other: a capture or a replay that fails raises.
"""

from __future__ import annotations

import gc
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.runtime import clock as rtclock

__all__ = ["EagerDispatch", "GraphDispatch", "fetch", "upload"]


def upload(host: np.ndarray, device) -> torch.Tensor:
    """``host`` on ``device``: on the card by one non-blocking copy from
    pinned memory on the current stream (no host sync; the caching host
    allocator keeps the pinned block until the copy has run), on the CPU
    the array itself."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if torch.device(device).type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def fetch(out: torch.Tensor) -> np.ndarray:
    """``out`` on the host: on the card one copy into pinned memory and one
    wait for the current stream, the dispatch's one host sync."""
    if out.device.type == "cpu":
        return out.numpy()
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    torch.cuda.current_stream(out.device).synchronize()
    return host.numpy()


class EagerDispatch:
    """The body run as it is, on every call."""

    capture_s = 0.0
    launches: Dict[str, int] = {}

    def __init__(self, body: Callable[[torch.Tensor], torch.Tensor], device):
        self.body = body
        self.device = torch.device(device)
        self.replays = 0

    def __call__(self, host: np.ndarray) -> torch.Tensor:
        self.replays += 1
        return self.body(upload(host, self.device))


class GraphDispatch:
    """The body captured once as a CUDA graph over a static input buffer
    (see the module docstring). ``stream`` is the engine's stream, the one
    the capture and every replay run on; ``pool`` its graph memory pool."""

    def __init__(self, body: Callable[[torch.Tensor], torch.Tensor],
                 idle: np.ndarray, *, device, stream: torch.cuda.Stream,
                 pool, warm: Optional[Callable] = None):
        dev = torch.device(device)
        with torch.cuda.stream(stream):
            self.static_in = torch.empty(idle.shape, dtype=torch.int32,
                                         device=dev)
            # eager and a no-op: loads every kernel of the body (``warm``,
            # when given, launches the same kernels in fewer steps)
            (warm or body)(upload(idle, dev))
            before = _build.launch_counts()
            t0 = rtclock.now()
            self.graph = torch.cuda.CUDAGraph()
            # no automatic garbage collection while capturing: a dead
            # engine (an engine and its metrics registry hold each other)
            # collected mid-capture would destroy its graphs and free their
            # pool, which a capturing stream forbids (the capture fails).
            # torch.cuda.graph collects once itself before it begins.
            gc_on = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                    self.out = body(self.static_in)
            finally:
                if gc_on:
                    gc.enable()
            self.capture_s = rtclock.now() - t0
        self.launches = _build.launches_since(before)
        _build.add_launches(self.launches, -1)  # the capture launched none
        self.replays = 0

    def __call__(self, host: np.ndarray) -> torch.Tensor:
        self.static_in.copy_(upload(host, "cpu").pin_memory(),
                             non_blocking=True)
        self.graph.replay()
        _build.add_launches(self.launches)
        self.replays += 1
        return self.out

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
  * ``launches``, the kernel launches the capture recorded (counted on
    the capturing thread alone: other threads' eager launches meanwhile
    are not the graph's), leave ``kernels._build.LAUNCHES`` at the capture
    and are added back at every replay, so the counts stay "launches
    executed".

``EagerDispatch`` runs the same body without a graph: on the CPU (where it
is the only path), and on the card when the engine's capture is switched
off (the eager-vs-graph comparison). Nothing falls back from one to the
other: a capture or a replay that fails raises.

Captures while other threads run. Behind the HTTP frontend an engine
captures at first use on its driver thread while client threads are live,
and a supervisor's factory may build the next engine (allocations,
copies) while a wedged thread of the dead one still sits in its step.
Under ``torch.cuda.graph``'s default ``capture_error_mode="global"`` any
thread's potentially unsafe CUDA call (``cudaMalloc``, a synchronous copy,
a stream sync) during a capture fails the capture. Captures here use
``"thread_local"``: only the capturing thread's own unsafe calls are
refused, which is what makes a capture recordable at all. That is safe
because nothing else can reach a capturing stream: each live engine
holds a stream no other live engine has (``ServingEngine`` claims one),
only its own thread launches there, and PyTorch's pool streams do not
synchronize with the legacy default stream that other threads use; the
caching allocator routes only the capturing stream's allocations to the
graph's pool and defers its event work while a capture is underway. One
process-wide lock, ``CAPTURE_LOCK``, serializes the captures themselves:
``torch.cuda.graph`` synchronizes the device, collects garbage and
empties the allocator's cache before it begins, none of which may overlap
another capture, and automatic garbage collection is switched off for the
capture's length process-wide (a dead engine collected mid-capture would
destroy its graphs and free their pool). ``collect_garbage()`` takes the
same lock. One thing no other thread may do during a capture: draw from
PyTorch's default CUDA generator, which every capture takes over (the
draw raises); the engine samples with its own threefry stream and builds
nothing random.
"""

from __future__ import annotations

import gc
import threading
import weakref
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.chunk_attention.ops import release_workspace
from repro_torch.runtime import clock as rtclock

__all__ = ["CAPTURE_LOCK", "EagerDispatch", "GraphDispatch", "GraphFailure",
           "claim_stream", "collect_garbage", "fetch", "upload"]

#: held by every capture and by ``collect_garbage`` (see the docstring)
CAPTURE_LOCK = threading.Lock()

_STREAMS_LOCK = threading.Lock()
# (device index, raw stream) of every stream a live owner has claimed
_CLAIMED: set = set()


def claim_stream(owner, device) -> torch.cuda.Stream:
    """A stream from PyTorch's pool that no live owner holds, held until
    ``owner`` (an engine) is freed; then its chunk-attention scratch is
    dropped with it. The pool hands out its streams round robin (32 per
    priority and device), so without the claim a new engine could get the
    stream of an older one that is still alive, say wedged in a step, and
    that engine's thread, should it wake, would launch into the new
    engine's captures."""
    for _ in range(2):
        with _STREAMS_LOCK:
            for priority in (0, -1):
                for _ in range(32):
                    s = torch.cuda.Stream(device, priority=priority)
                    key = (s.device_index, s.cuda_stream)
                    if key not in _CLAIMED:
                        _CLAIMED.add(key)
                        weakref.finalize(owner, _release_stream, key)
                        return s
        collect_garbage()  # dead engines awaiting collection hold streams
    raise RuntimeError("every stream of the pool is held by a live engine")


def _release_stream(key) -> None:
    # runs inside garbage collection, on any thread: no lock taken
    _CLAIMED.discard(key)
    release_workspace(*key)


class GraphFailure(RuntimeError):
    """A capture or a replay failed. The engine's dispatches are broken, not
    one request's rows, so the engine lets this escape its per-dispatch
    containment as it does an ``EngineCrash``: a driver under a supervisor
    reports it as the engine's death (``suspects``: the rows of the
    dispatch, filled in by the engine)."""

    uid = None
    suspects = ()


def collect_garbage() -> None:
    """Collect unreachable objects (dead engines, with their graphs, pools
    and KV) outside any capture."""
    with CAPTURE_LOCK:
        gc.collect()


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
        try:
            self._capture(body, idle, torch.device(device), stream, pool,
                          warm)
        except RuntimeError as e:
            raise GraphFailure(f"CUDA graph capture failed: {e}") from e
        self.replays = 0

    def _capture(self, body, idle, dev, stream, pool, warm):
        with torch.cuda.stream(stream):
            self.static_in = torch.empty(idle.shape, dtype=torch.int32,
                                         device=dev)
            # eager and a no-op: loads every kernel of the body (``warm``,
            # when given, launches the same kernels in fewer steps)
            (warm or body)(upload(idle, dev))
            self.graph = torch.cuda.CUDAGraph()
            with CAPTURE_LOCK:
                before = _build.thread_launch_counts()
                t0 = rtclock.now()
                # no automatic garbage collection while capturing: a dead
                # engine (an engine and its metrics registry hold each
                # other) collected mid-capture would destroy its graphs and
                # free their pool, which a capturing stream forbids (the
                # capture fails). torch.cuda.graph collects once itself
                # before it begins.
                gc_on = gc.isenabled()
                gc.disable()
                try:
                    with torch.cuda.graph(self.graph, pool=pool,
                                          stream=stream,
                                          capture_error_mode="thread_local"):
                        self.out = body(self.static_in)
                finally:
                    if gc_on:
                        gc.enable()
                self.capture_s = rtclock.now() - t0
                self.launches = _build.launches_since(before)
        _build.add_launches(self.launches, -1)  # the capture launched none

    def __call__(self, host: np.ndarray) -> torch.Tensor:
        try:
            self.static_in.copy_(upload(host, "cpu").pin_memory(),
                                 non_blocking=True)
            self.graph.replay()
        except RuntimeError as e:
            raise GraphFailure(f"CUDA graph replay failed: {e}") from e
        _build.add_launches(self.launches)
        self.replays += 1
        return self.out

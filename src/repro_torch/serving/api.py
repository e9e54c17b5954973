"""Serving API v1: the request/response surface of the engine (a copy of
the reference's ``repro.serving.api``).

``SamplingParams`` is the frozen per-request contract; ``RequestHandle`` is
what ``ServingEngine.submit`` returns: stream tokens, block for the final
``RequestResult``, or ``cancel()``.

Determinism contract: a request's output is a pure function of (model
params, prompt, SamplingParams). Every random draw of a request comes from
its ``seed`` and the index of the token being drawn; temperature 0 is pure
argmax. The output therefore cannot depend on co-batched traffic or on
prefill/decode chunk sizes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, FrozenSet, Iterable, Iterator, List, Optional

from repro_torch.runtime import clock as rtclock

FINISH_STOP = "stop"          # hit a stop-token id (incl. EngineConfig.eos_id)
FINISH_LENGTH = "length"      # produced max_new_tokens
FINISH_CANCELLED = "cancelled"
FINISH_TIMEOUT = "timeout"    # deadline_s / ttft_deadline_s expired
FINISH_REJECTED = "rejected"  # shed at submit by admission control
FINISH_ERROR = "error"        # fault contained to this request (see .error)

FINISH_REASONS = (FINISH_STOP, FINISH_LENGTH, FINISH_CANCELLED,
                  FINISH_TIMEOUT, FINISH_REJECTED, FINISH_ERROR)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Frozen per-request generation parameters (see the reference for the
    full field documentation). ``deadline_s`` is an end-to-end budget from
    submit and ``ttft_deadline_s`` a budget for the first token; the engine
    sweeps them at the start of every step and retires an expired request
    with reason ``"timeout"``, keeping the tokens it produced (``None``
    disables either)."""

    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    stop: FrozenSet[int] = frozenset()
    deadline_s: Optional[float] = None
    ttft_deadline_s: Optional[float] = None
    tenant: str = ""

    def __post_init__(self):
        object.__setattr__(self, "stop", frozenset(self.stop))
        if not isinstance(self.tenant, str):
            raise TypeError("tenant must be a string")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0 (0 disables)")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1] (1.0 disables)")
        for name in ("deadline_s", "ttft_deadline_s"):
            v = getattr(self, name)
            if v is not None and v <= 0.0:
                raise ValueError(f"{name} must be > 0 (None disables)")

    @property
    def needs_mask(self) -> bool:
        """True when sampling must run the top-k/top-p support mask."""
        return self.top_k > 0 or self.top_p < 1.0


@dataclasses.dataclass(frozen=True)
class RequestResult:
    """Immutable completion record returned by ``RequestHandle.result()``."""

    uid: int
    tokens: tuple
    finish_reason: str
    truncated: bool
    t_submit: float
    t_first: float
    t_done: float
    t_admit: float = 0.0
    error: Optional[str] = None

    @property
    def ttft(self) -> float:
        """Submit → first token, seconds (0.0 if no token was produced)."""
        return max(self.t_first - self.t_submit, 0.0) if self.t_first else 0.0

    @property
    def queue_wait(self) -> float:
        return max(self.t_admit - self.t_submit, 0.0) if self.t_admit else 0.0


class RequestHandle:
    """Live view of one in-flight request. Iterating ``tokens()`` or calling
    ``result()`` drives ``engine.step()`` until the request progresses."""

    def __init__(self, engine: Any, uid: int, prompt: List[int],
                 params: SamplingParams):
        self.uid = uid
        self.prompt = list(prompt)
        self.params = params
        self.output: List[int] = []
        self.finish_reason: Optional[str] = None
        self.error: Optional[str] = None
        self.truncated = False
        self.t_submit = 0.0
        self.t_admit = 0.0
        self.t_first = 0.0
        self.t_done = 0.0
        self._engine = engine
        self._slot: Optional[int] = None  # last slot occupied (trace label)
        self._stop_ids: FrozenSet[int] = params.stop

    @property
    def done(self) -> bool:
        return self.finish_reason is not None

    @property
    def cancelled(self) -> bool:
        return self.finish_reason == FINISH_CANCELLED

    def tokens(self) -> Iterator[int]:
        i = 0
        while True:
            while i < len(self.output):
                yield self.output[i]
                i += 1
            if self.done:
                return
            self._engine.step()

    def result(self) -> RequestResult:
        while not self.done:
            self._engine.step()
        return RequestResult(
            uid=self.uid, tokens=tuple(self.output),
            finish_reason=self.finish_reason, truncated=self.truncated,
            t_submit=self.t_submit, t_first=self.t_first, t_done=self.t_done,
            t_admit=self.t_admit, error=self.error)

    def cancel(self) -> bool:
        return self._engine.cancel(self)


def make_handle(engine: Any, prompt: Any, params: Optional[SamplingParams],
                uid: Optional[int]) -> RequestHandle:
    """Normalize ``submit``'s inputs into a ``RequestHandle``."""
    if isinstance(prompt, (str, bytes)):
        raise TypeError("prompt must be a sequence of token ids, not "
                        "text — tokenize first")
    if not isinstance(prompt, Iterable):
        raise TypeError("prompt must be a sequence of token ids")
    h = RequestHandle(engine, uid if uid is not None else -1, list(prompt),
                      params if params is not None else SamplingParams())
    if not h.prompt:
        raise ValueError("empty prompt")
    # provisional stamp; the engine's own clock overwrites it at submit()
    h.t_submit = rtclock.now()
    return h

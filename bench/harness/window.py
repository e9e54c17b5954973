"""What a loop records, and the arithmetic of the end-to-end metrics over
it. Every time here is the benchmark's own host clock
(``time.perf_counter``), read by the loop around the program's calls.

  * ``output_tok_s``: every token the program emitted in an engine step
    that ran inside the window, over the window's seconds;
  * ``ttft_s``: for every request submitted inside the window, first token
    minus submit; a request with no token at the window's close counts
    with its wait so far (close minus submit);
  * ``tpot_ms``: for every request that finished inside the window with at
    least two tokens, (done - first) / (tokens - 1);
  * a tail is the 95th percentile of all such requests (numpy's linear
    interpolation between order statistics).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

FAILED = ("error", "timeout", "rejected", "cancelled")


@dataclasses.dataclass
class Record:
    """One request as the loop saw it."""

    req: object               # traffic.Request
    client: int
    uid: int
    t_submit: float
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    n: int = 0                 # tokens seen so far
    tokens: tuple = ()         # the tokens, once finished
    reason: Optional[str] = None
    # the program's own stamps (its RequestHandle's, its clock)
    t_submit_prog: float = 0.0
    t_admit_prog: float = 0.0


@dataclasses.dataclass
class Step:
    """One engine step inside the window: its span and, for every request
    that got tokens in it, (prompt length, tokens before, tokens after,
    whether the first token came in this step)."""

    t0: float
    t1: float
    progress: List[tuple]


@dataclasses.dataclass
class Window:
    t_open: float
    t_close: float
    records: List[Record]
    steps: List[Step]
    tokens: int                # tokens emitted by steps inside the window
    counters_open: Dict[str, float]
    counters_close: Dict[str, float]

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open

    def submitted(self) -> List[Record]:
        return [r for r in self.records
                if self.t_open <= r.t_submit <= self.t_close]

    def finished(self) -> List[Record]:
        return [r for r in self.records if r.t_done is not None
                and self.t_open <= r.t_done <= self.t_close]

    def counter(self, name: str) -> float:
        """A program counter's increase over the window."""
        return self.counters_close[name] - self.counters_open[name]


def p95(values) -> Optional[float]:
    return float(np.percentile(np.asarray(values, np.float64), 95)) \
        if len(values) else None


def output_tok_s(w: Window) -> float:
    return w.tokens / w.seconds


def ttfts(w: Window) -> List[float]:
    return [(r.t_first if r.t_first is not None else w.t_close) - r.t_submit
            for r in w.submitted()]


def tpots(w: Window) -> List[float]:
    return [(r.t_done - r.t_first) / (len(r.tokens) - 1)
            for r in w.finished()
            if r.t_first is not None and len(r.tokens) > 1]


def failed(w: Window) -> int:
    return sum(r.reason in FAILED for r in w.finished())

"""The work of every engine dispatch of the window, from the program's own
trace (its ``prefill_dispatch`` and ``decode_dispatch`` phase spans and each
request's ``prefill_chunk`` spans) and the loop's record of the tokens each
engine step produced.

Only the rows the traffic needs count: a prefill dispatch's tokens are its
requests' prompt tokens (not its padded bucket), a decode dispatch's are the
tokens it produced, and the head's rows are the rows whose token was drawn
(a prefill's finishing rows, every decode row-step).
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List


@dataclasses.dataclass
class Dispatch:
    kind: str          # "prefill" | "decode"
    t: float           # its span's start (loop clock)
    length: int        # prefill bucket, or decode steps
    tokens: int        # token rows the traffic needs
    context: float     # sum over those tokens of the positions each sees
    head_rows: int     # rows whose logits are drawn from


def _decode_progress(progress) -> tuple:
    """(row-steps, context sum) that decode produced in one engine step:
    token j (j >= 1; token 0 comes from prefill) is produced by the step
    that reads token j - 1 at position P + j - 1, seeing P + j positions."""
    steps = ctx = 0
    for p, before, after, _ in progress:
        a, b = max(before, 1), after
        if b > a:
            steps += b - a
            ctx += (b - a) * p + (a + b - 1) * (b - a) / 2
    return steps, ctx


def dispatches(events, window, prompt_len: Dict[int, int]) -> List[Dispatch]:
    """Every dispatch of the window, in order. ``events`` are the program's
    trace events, ``prompt_len`` maps a request's uid to its prompt's
    length."""
    out: List[Dispatch] = []
    chunks: Dict[float, list] = {}
    prefill_spans = []
    starts = [s.t0 for s in window.steps]
    for ev in events:
        if ev.name == "prefill_chunk":
            chunks.setdefault(ev.ts, []).append(ev)
        elif ev.name == "prefill_dispatch":
            prefill_spans.append(ev)
        elif ev.name == "decode_dispatch":
            i = bisect.bisect_right(starts, ev.ts) - 1
            if i < 0 or ev.ts > window.steps[i].t1:
                continue
            steps, ctx = _decode_progress(window.steps[i].progress)
            out.append(Dispatch("decode", ev.ts, ev.args["n_steps"], steps,
                                ctx, steps))
    keys = sorted(chunks)
    for span in prefill_spans:
        i = bisect.bisect_right(keys, span.ts) - 1
        rows = chunks[keys[i]] if i >= 0 and \
            span.ts <= keys[i] + chunks[keys[i]][0].dur else []
        tokens = sum(c.args["tokens"] for c in rows)
        ctx = sum(c.args["tokens"] * (2 * c.args["cursor"]
                                      - c.args["tokens"] + 1) / 2
                  for c in rows)
        done = sum(c.args["cursor"] >= prompt_len[c.track[1]] for c in rows)
        out.append(Dispatch("prefill", span.ts, span.args["bucket"], tokens,
                            ctx, done))
    out.sort(key=lambda d: d.t)
    return [d for d in out if window.t_open <= d.t <= window.t_close]


def between(ds: List[Dispatch], t0: float, t1: float) -> List[Dispatch]:
    return [d for d in ds if t0 <= d.t <= t1]

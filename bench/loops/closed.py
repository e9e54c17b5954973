"""The closed loop: each client sends its next request as soon as its last
one has finished, from one thread, through the engine's ``submit`` and
``step``.

The loop runs until ``warm_finished`` requests have finished (the loop's
steady state), then opens the window and runs on until the first engine
step that ends ``seconds`` after the window opened; that step's end closes
it. Every time is read from ``clock`` around the engine's calls. The
requests still in flight at the close are left as they are.

``hooks`` (optional) is called with ``("open", t)`` when the window
opens, ``("step", t)`` after every engine step inside the window, and
``("close", t)`` when it closes (the traced run starts and stops its
profiler there).
"""

from __future__ import annotations

import time

from harness import traffic as traffic_mod
from harness.window import Record, Step, Window
from repro_torch.serving import SamplingParams


def _params(req) -> SamplingParams:
    return SamplingParams(max_new_tokens=req.max_new_tokens,
                          temperature=req.temperature, top_p=req.top_p,
                          seed=req.seed)


def drive(engine, requests, mix, seconds, *, counters, hooks=None,
          clock=time.perf_counter) -> Window:
    """Serve ``requests`` (the ordered pool) to ``mix['clients']`` clients
    on ``engine``; ``counters()`` reads the program's counters at the
    window's ends. Returns the Window."""
    clients = int(mix["clients"])
    warm = int(mix["warm_finished"])
    sources = [traffic_mod.client_requests(requests, clients, c)
               for c in range(clients)]
    live = {}            # uid -> (handle, Record)
    records = []
    steps = []
    hooks = hooks or (lambda event, t: None)

    def submit(c):
        req = next(sources[c])
        t = clock()
        h = engine.submit(list(req.prompt), _params(req))
        rec = Record(req, c, h.uid, t)
        live[h.uid] = (h, rec)
        records.append(rec)

    for c in range(clients):
        submit(c)
    n_finished = 0
    t_open = t_close = None
    tokens = 0
    opened = {}
    while True:
        t0 = clock()
        engine.step()
        t1 = clock()
        progress, done = [], []
        for uid, (h, rec) in list(live.items()):
            n = len(h.output)
            if n > rec.n:
                first = rec.t_first is None
                if first:
                    rec.t_first = t1
                progress.append((len(rec.req.prompt), rec.n, n, first))
                tokens += n - rec.n if t_open is not None else 0
                rec.n = n
            if h.done:
                rec.t_done, rec.reason = t1, h.finish_reason
                rec.tokens = tuple(h.output)
                rec.t_submit_prog, rec.t_admit_prog = h.t_submit, h.t_admit
                done.append(uid)
        if t_open is not None:
            steps.append(Step(t0, t1, progress))
            hooks("step", t1)
            if t1 >= t_open + seconds:
                t_close = t1
                break
        for uid in done:
            _, rec = live.pop(uid)
            n_finished += 1
            submit(rec.client)
        if t_open is None and n_finished >= warm:
            opened = counters()
            t_open = clock()
            hooks("open", t_open)
    closed = counters()
    hooks("close", t_close)
    for h, rec in live.values():   # in flight at the close
        rec.tokens = tuple(h.output)
        rec.t_submit_prog, rec.t_admit_prog = h.t_submit, h.t_admit
    live.clear()
    return Window(t_open, t_close, records, steps, tokens, opened, closed)

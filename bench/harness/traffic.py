"""The one traffic generator: a mix file's parameters and a seed -> the
requests of every client.

A mix names a pool of ``pool`` requests in blocks of ``block``. Every
block holds the same lengths: the distributions' quantiles at (i + 0.5) /
block, i = 0 .. block - 1. Their order inside each block (prompt lengths
and output lengths each by a permutation of their own) is drawn from the
mix's own ``order_seed``, not from the run's seed: in a closed loop the
order decides how prefills overlap, and with it the work a window holds,
so every seed serves the same sizes in the same order, and a window of a
few blocks always sees the same set of sizes. A block of 10 puts a tail's
95th percentile in the middle of its top group of sizes. The first of
every ``greedy_every`` requests of a block decodes greedily; the others
sample at the mix's temperature and top-p. The run's seed draws the
prompts' token ids (uniform over the vocabulary) and each request's
sampling seed. Client c sends the pool's requests c, c + clients,
c + 2 clients, ... and starts over at the pool's end.

Distributions: ``{"dist": "lognormal", "median", "sigma", "min", "max"}``
(clipped) and ``{"dist": "uniform", "min", "max"}`` (whole numbers, both
ends included).
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Any, Dict, List

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    index: int            # place in the ordered pool
    prompt: tuple         # token ids
    max_new_tokens: int
    temperature: float
    top_p: float
    seed: int

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def quantile(dist: Dict[str, Any], q: float) -> int:
    """The distribution's q-quantile, a whole number of tokens."""
    lo, hi = int(dist["min"]), int(dist["max"])
    if dist["dist"] == "lognormal":
        z = statistics.NormalDist().inv_cdf(q)
        v = int(round(dist["median"] * math.exp(dist["sigma"] * z)))
    elif dist["dist"] == "uniform":
        v = lo + int(math.floor(q * (hi - lo + 1)))
    else:
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    return min(max(v, lo), hi)


def sizes(dist: Dict[str, Any], n: int) -> np.ndarray:
    """The pool's lengths, in order of the quantiles."""
    return np.asarray([quantile(dist, (i + 0.5) / n) for i in range(n)],
                      np.int64)


def pool(mix: Dict[str, Any], vocab: int, seed: int) -> List[Request]:
    """The ordered pool of requests of ``mix`` for ``seed``."""
    n, block = int(mix["pool"]), int(mix["block"])
    if n % block:
        raise ValueError(f"pool {n} is not a whole number of blocks of "
                         f"{block}")
    order = np.random.default_rng(int(mix["order_seed"]))
    p_sizes = sizes(mix["prompt_tokens"], block)
    o_sizes = sizes(mix["output_tokens"], block)
    prompts = np.concatenate([order.permutation(p_sizes)
                              for _ in range(n // block)])
    outputs = np.concatenate([order.permutation(o_sizes)
                              for _ in range(n // block)])
    rng = np.random.default_rng(int(seed))
    ids = rng.integers(0, vocab, int(prompts.sum()), dtype=np.int64)
    seeds = rng.integers(0, 2 ** 31, n, dtype=np.int64)
    every = int(mix["greedy_every"])
    temp = float(mix["sampling"]["temperature"])
    top_p = float(mix["sampling"]["top_p"])
    out, off = [], 0
    for i in range(n):
        greedy = (i % block) % every == 0 or temp == 0.0
        p = int(prompts[i])
        out.append(Request(i, tuple(ids[off:off + p].tolist()),
                           int(outputs[i]), 0.0 if greedy else temp,
                           1.0 if greedy else top_p, int(seeds[i])))
        off += p
    return out


def client_requests(requests: List[Request], clients: int, client: int):
    """The requests client ``client`` sends, in order, without end."""
    i = client
    while True:
        yield requests[i % len(requests)]
        i += clients

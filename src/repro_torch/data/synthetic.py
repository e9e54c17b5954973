"""Deterministic synthetic corpus with learnable structure (a copy of the
reference's ``repro.data.synthetic``: the same bytes from the same seed).

WikiText/C4 are unavailable offline, so quality claims are validated
in-miniature (DESIGN.md §8.2): we synthesize text with real statistical
structure — a small vocabulary of templated sentences, arithmetic facts, and
key-value recall patterns — so a ~100M-parameter byte LM trained on it reaches
non-trivial perplexity, and quantization-induced degradation is measurable and
ordered (FP > PTQTP > 3-bit > 2-bit > binary, the paper's Table 1 ordering).
"""

from __future__ import annotations

import numpy as np

_SUBJECTS = ["the model", "a tensor", "the kernel", "one pod", "the mesh",
             "a shard", "the cache", "this layer", "the router", "an expert"]
_VERBS = ["computes", "reduces", "gathers", "stores", "emits", "scans",
          "quantizes", "packs", "shards", "streams"]
_OBJECTS = ["two trit planes", "a scaling pair", "the residual", "group scales",
            "eight experts", "the logits", "a block of weights",
            "the key cache", "an update", "ternary values"]
_ADVERBS = ["quickly", "exactly", "in parallel", "per group", "on chip",
            "without loss", "row by row", "every step", "at once", "in place"]


def _sentence(rng: np.random.Generator) -> str:
    kind = rng.integers(0, 4)
    if kind == 0:  # templated sentence (grammar structure)
        return (f"{_SUBJECTS[rng.integers(10)]} {_VERBS[rng.integers(10)]} "
                f"{_OBJECTS[rng.integers(10)]} {_ADVERBS[rng.integers(10)]}. ")
    if kind == 1:  # arithmetic fact (mathematical structure; paper's math-
        a, b = rng.integers(0, 50, size=2)  # reasoning retention claim)
        return f"{a} plus {b} equals {a + b}. "
    if kind == 2:  # key-value recall (in-context structure)
        k, v = rng.integers(0, 100, size=2)
        return f"slot {k} holds {v} ; recall slot {k} gives {v}. "
    # counting pattern (sequence structure)
    s = rng.integers(0, 30)
    return "count " + " ".join(str(s + i) for i in range(4)) + ". "


def synthetic_corpus(n_bytes: int, seed: int = 0) -> bytes:
    """Deterministic pseudo-text corpus of (at least) n_bytes bytes."""
    rng = np.random.default_rng(seed)
    parts, total = [], 0
    while total < n_bytes:
        s = _sentence(rng)
        parts.append(s)
        total += len(s)
    return "".join(parts).encode("utf-8")[:n_bytes]

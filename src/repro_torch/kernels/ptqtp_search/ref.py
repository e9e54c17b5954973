"""Plain PyTorch version of the PTQTP 9-candidate trit search (Eq. 5).

For each element of w (R, G) with per-row scales α (R, 2), pick the pair
(c¹, c²) ∈ {-1, 0, 1}² that minimizes (w − α¹c¹ − α²c²)². Candidates are
tried in ``CANDIDATES`` order, (0, 0) first, and one replaces the best so
far only if its error is strictly smaller, so the first wins ties — the
reference's ``_CANDIDATES`` order and rule. The candidate value
α¹·c¹ + α²·c² is two exact products and one rounding, as in the reference.
The walk is 9 compare-selects over the output planes, never an (R, G, 9)
error tensor.
"""

from __future__ import annotations

import torch

# The 9 ternary candidate pairs (c1, c2), in the reference order.
CANDIDATES = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0),
              (1, 1), (-1, -1), (1, -1), (-1, 1))


def ptqtp_search_plain(w: torch.Tensor, alpha: torch.Tensor,
                       t1: torch.Tensor, t2: torch.Tensor) -> None:
    """w (R, G) f32; alpha (R, 2) f32; writes the planes into ``t1``/``t2``
    (R, G) f32, values in {-1, 0, 1}."""
    a1 = alpha[:, 0:1]
    a2 = alpha[:, 1:2]
    best = w * w                                   # candidate (0, 0)
    t1.zero_()
    t2.zero_()
    for c1, c2 in CANDIDATES[1:]:
        diff = w - (a1 * c1 + a2 * c2)
        err = diff * diff
        better = err < best
        best = torch.where(better, err, best)
        t1.masked_fill_(better, float(c1))
        t2.masked_fill_(better, float(c2))

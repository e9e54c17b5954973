"""What decides ``correct``: the served tokens against the plain reference.

Once the window has closed and the program is gone, two samples of the
requests that finished inside the window are drawn from the seed, one of
the greedy requests and one of the sampled ones: in each, the request
with the most served tokens, then others in the seed's order until the
mix's ``check_tokens`` (greedy) or ``check_sampled_tokens`` (sampled)
served tokens are in it. The reference makes the weights again from the
seed and runs each sampled prompt with its served tokens in float32,
reading the logits at every served position:

  * a greedy token's gap: how far its logit lies below the reference's
    best there (0 where it is the best);
  * a sampled token's nucleus excess: the reference's probability mass, at
    the request's temperature, of the tokens more probable than it, less
    the request's top-p (the program keeps a token while the mass above it
    is under top-p). A token inside the nucleus reads 0; one outside reads
    how far outside it lies, in probability.

The widest and the mean of each, as the cell's limits file
(``bench/limits/<cell>.json``) names them under ``compare``, are compared
with their limits, and so are the requests the window failed (limit 0) and
the served tokens compared (at least ``MIN_CHECKED`` of each kind that a
named number needs).

Calibration only (``control=True``): the same numbers for the control, the
reference again in the precision below the configuration's
(``Rounding("fp8")``), whose tokens are the ones it puts first (greedy) or
draws from its own nucleus (sampled), at the same positions; and for two
faults of the draw planted in the reference put in the program's place,
top-p left out (``no_top_p``) and the temperature taken as 1
(``temperature_1``). ``passed(numbers, side)`` judges each of them as it
judges the program.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from harness import weights as weights_mod
from harness.window import failed

#: the fewest served tokens of a kind that a check may compare
MIN_CHECKED = 64
#: the readings beside the program's, in calibration
SIDES = ("control", "no_top_p", "temperature_1")
#: the numbers a cell's limits file may name: (kind of request, statistic)
NUMBERS = {"logit_gap": ("greedy", "widest_gap"),
           "mean_logit_gap": ("greedy", "mean_gap"),
           "nucleus_excess": ("sampled", "widest_excess"),
           "mean_nucleus_excess": ("sampled", "mean_excess")}
#: the count of compared tokens of each kind
CHECKED = {"greedy": "checked_tokens", "sampled": "checked_sampled_tokens"}


def sample(window, seed: int, target: int, greedy: bool = True):
    """The greedy (or sampled) requests of the check, drawn from ``seed``."""
    done = [r for r in window.finished()
            if r.req.greedy == greedy and r.reason in ("length", "stop")]
    if not done:
        return []
    done.sort(key=lambda r: (-len(r.tokens), r.uid))
    rng = np.random.default_rng([int(seed), 1 if greedy else 2])
    rest = [done[i + 1] for i in rng.permutation(len(done) - 1)]
    out, n = [], 0
    for r in [done[0]] + rest:
        if n >= target:
            break
        out.append(r)
        n += len(r.tokens)
    return out


def gaps(ref_logits, served) -> torch.Tensor:
    """Every served token's gap below the reference's best, in order."""
    out = []
    for lg, toks in zip(ref_logits, served):
        t = torch.as_tensor(toks, device=lg.device)
        out.append(lg.max(-1).values - lg.gather(1, t[:, None])[:, 0])
    return torch.cat(out)


def spread(ref_logits, served) -> dict:
    """How the gaps fall: the widest and the mean (the numbers a cell may
    compare), the share of positions whose token is not the reference's
    best and the median of their gaps, and the reference logits' mean
    standard deviation over the vocabulary."""
    g = gaps(ref_logits, served)
    off = g[g > 0]
    return {"positions": int(g.numel()), "widest_gap": float(g.max()),
            "mean_gap": float(g.mean()),
            "off_best": float((g > 0).float().mean()),
            "median_off_gap": float(off.median()) if off.numel() else 0.0,
            "logit_std": float(torch.stack([lg.std(-1).mean()
                                            for lg in ref_logits]).mean())}


def excess(lg, toks, temperature: float, top_p: float) -> torch.Tensor:
    """Each served token's nucleus excess (module docstring), unclamped:
    the reference's mass above it at ``temperature``, less ``top_p``."""
    p = torch.softmax(lg / temperature, dim=-1)
    t = torch.as_tensor(toks, device=lg.device)
    pt = p.gather(1, t[:, None])
    return torch.where(p > pt, p, 0.0).sum(-1) - top_p


def nucleus(ref_logits, served, requests) -> dict:
    """How the sampled tokens fall against the reference's nucleus: the
    widest and the mean excess, clamped at 0 (the numbers a cell may
    compare), the share of tokens outside it, and the largest unclamped
    excess (how near its edge the nearest token lies)."""
    e = torch.cat([excess(lg, toks, r.temperature, r.top_p)
                   for lg, toks, r in zip(ref_logits, served, requests)])
    c = e.clamp(min=0.0)
    return {"positions": int(e.numel()), "widest_excess": float(c.max()),
            "mean_excess": float(c.mean()),
            "outside": float((e > 0).float().mean()),
            "nearest_edge": float(e.max())}


def nucleus_mask(scaled: torch.Tensor, top_p: float) -> torch.Tensor:
    """True where a token is in the top-p nucleus of ``scaled`` (logits
    over the temperature): the most probable tokens while the mass above
    each is under ``top_p``; the top token always."""
    if top_p >= 1.0:
        return torch.ones_like(scaled, dtype=torch.bool)
    order = torch.argsort(-scaled, dim=-1, stable=True)
    p = torch.softmax(torch.gather(scaled, -1, order), dim=-1)
    keep = (torch.cumsum(p, dim=-1) - p) < top_p
    return torch.zeros_like(keep).scatter(-1, order, keep)


def draw(lg, temperature: float, top_p: float, gen) -> list:
    """A token at every position of ``lg``, drawn (Gumbel-max, ``gen``)
    from the nucleus at ``temperature`` and ``top_p``."""
    scaled = lg / temperature
    scaled = torch.where(nucleus_mask(scaled, top_p), scaled, float("-inf"))
    u = torch.rand(scaled.shape, generator=gen, device=lg.device,
                   dtype=torch.float32).clamp(min=torch.finfo(
                       torch.float32).tiny)
    return torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1).tolist()


def _draws(logits, requests, seed: int, side: str) -> list:
    """The tokens the control or a fault draws at the sampled positions."""
    out = []
    for i, (lg, r) in enumerate(zip(logits, requests)):
        gen = torch.Generator(device=lg.device)
        gen.manual_seed((int(seed) * 1_000_003 + i) % 2 ** 63)
        t, p = {"control": (r.temperature, r.top_p),
                "no_top_p": (r.temperature, 1.0),
                "temperature_1": (1.0, r.top_p)}[side]
        out.append(draw(lg, t, p, gen))
    return out


def _numbers(stats, limits, prefix: str = "") -> dict:
    out = {}
    for n, v in limits.items():
        kind, stat = NUMBERS[n]
        if kind in stats:
            out[prefix + n] = {"value": stats[kind][stat], "limit": v}
    return out


def compare(window, cell, seed: int, device, float_dtype, reference,
            control: bool = False, stats=None):
    """The numbers compared, each with its limit: {name: {value, limit}}:
    the requests the window failed, the served tokens compared of each
    kind the limits need, and each number that the cell's limits file
    names under ``compare``. With ``control`` also the control's and the
    two faults' (``SIDES``); a ``stats`` dict gets the ``spread`` and
    ``nucleus`` readings of each side."""
    config = cell.config["config"]
    group = config["quantization"]["group_size"]
    limits = cell.limits["compare"]
    kinds = [k for k in CHECKED if any(NUMBERS[n][0] == k for n in limits)]
    target = {"greedy": int(cell.traffic.get("check_tokens", 0)),
              "sampled": int(cell.traffic.get("check_sampled_tokens", 0))}
    picked = {k: sample(window, seed, target[k], k == "greedy")
              for k in kinds}
    out = {"failed": {"value": failed(window), "limit": 0}}
    for k in kinds:
        out[CHECKED[k]] = {"value": sum(len(r.tokens) for r in picked[k]),
                           "limit": MIN_CHECKED, "at_least": True}
    if not all(picked.values()):
        out.update({n: {"value": None, "limit": v} for n, v in limits.items()})
        return out
    rows = [r for k in kinds for r in picked[k]]
    seqs = [list(r.req.prompt) + list(r.tokens[:-1]) for r in rows]
    starts = [len(r.req.prompt) - 1 for r in rows]
    bounds, at = {}, 0
    for k in kinds:
        bounds[k] = (at, at + len(picked[k]))
        at += len(picked[k])

    def part(xs, k):
        return xs[bounds[k][0]:bounds[k][1]]

    def read(logits, served):
        got = {}
        if "greedy" in bounds:
            got["greedy"] = spread(part(logits, "greedy"),
                                   part(served, "greedy"))
        if "sampled" in bounds:
            got["sampled"] = nucleus(part(logits, "sampled"),
                                     part(served, "sampled"),
                                     [r.req for r in picked["sampled"]])
        return got

    served = [list(r.tokens) for r in rows]
    prev_tf32 = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        spec = reference.param_spec(config)
        w = weights_mod.make(spec, seed, device, float_dtype, group)
        ref = reference.logits(w, config, seqs, starts)
        got = read(ref, served)
        out.update(_numbers(got, limits))
        if stats is not None:
            stats["program"] = got
        if control:
            ctl = reference.logits(w, config, seqs, starts, rounding="fp8")
            sampled = [r.req for r in picked.get("sampled", [])]
            lo = bounds.get("sampled", (0, 0))[0]
            tokens = [c.argmax(-1).tolist() for c in ctl]
            tokens[lo:lo + len(sampled)] = _draws(ctl[lo:], sampled, seed,
                                                  "control")
            sides = {"control": read(ref, tokens)}
            if sampled:
                for side in SIDES[1:]:
                    tokens = served[:lo] + _draws(ref[lo:], sampled, seed,
                                                  side)
                    sides[side] = read(ref, tokens)
            for side, got in sides.items():
                out.update(_numbers(got, limits, f"{side}_"))
                if stats is not None:
                    stats[side] = got
        del w, ref
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev_tf32
        gc.collect()
    return out


def passed(numbers, side: str = "") -> bool:
    """Whether the program's numbers (or, with ``side``, the control's or a
    fault's, where it has its own; the rest are the program's) are each
    within their limits."""
    own = {n: v for n, v in numbers.items()
           if not n.startswith(tuple(f"{s}_" for s in SIDES))}
    if side:
        own.update({n: numbers[f"{side}_{n}"] for n in own
                    if f"{side}_{n}" in numbers})
    for v in own.values():
        if v["value"] is None:
            return False
        if v.get("at_least"):
            if v["value"] < v["limit"]:
                return False
        elif v["value"] > v["limit"]:
            return False
    return True


def lines(numbers):
    """The compared numbers as short plain lines: name, value, limit."""
    out = []
    for name, v in numbers.items():
        rel = ">=" if v.get("at_least") else "<="
        out.append(f"{name} {v['value']} limit {rel} {v['limit']}")
    return out

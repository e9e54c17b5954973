"""The yardstick: the chip's peaks, a model's FLOPs, and the operations and
bytes of the ternary linear layers, all worked out from the configuration's
shapes and the counted work, never from a kernel's launch grid.

Model FLOPs of a token (the same whatever computes it):
    2 * (weights of every linear layer but the head, and of the float
         matrices that multiply activations)
  + the reference's ``mixer_flops`` at the token's context (attention over
    the positions it sees; the WKV recurrence)
  + 2 * V * d for the head, once for every token that is drawn.

A ternary linear call y = x W^T, W (n, d) in two trit-planes with float32
scales by groups of G, on m useful rows of activations of ``act_bytes``:
    bytes = 2 * n * d / 4 (the planes) + 8 * n * d / G (the scales)
            + act_bytes * m * (d + n) (x read, y written), each once
    FLOPs = 2 * m * n * d (the equivalent dense product)
Its least time is the larger of bytes / HBM bandwidth and FLOPs / bf16 peak.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from harness.weights import matmul_weights
from harness.work import between

#: data-sheet peaks (dense, no sparsity) by the card's name as
#: ``torch.cuda.get_device_name()`` gives it
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12, "hbm_bytes_s": 3.35e12, "power_limit_w": 700.0,
        "source": "NVIDIA H100 SXM data sheet, at 700 W"},
}


@dataclasses.dataclass
class Shapes:
    linears: List[Tuple[int, int]]   # (n, d) of every quantized layer but the head
    head: Tuple[int, int]            # (V, d)
    float_matmul: int                # multiply-adds a token on float matrices
    group: int
    act_bytes: int

    @classmethod
    def of(cls, spec, group: int, act_bytes: int) -> "Shapes":
        lin = [tuple(s) for n, s, init in spec
               if init[0] == "planes" and n != "lm_head"]
        head = next(tuple(s) for n, s, _ in spec if n == "lm_head")
        return cls(lin, head, matmul_weights(spec), group, act_bytes)

    def token_flops(self) -> float:
        """FLOPs of one token through every linear layer but the head."""
        return 2.0 * (sum(n * d for n, d in self.linears) + self.float_matmul)

    def head_flops(self) -> float:
        return 2.0 * self.head[0] * self.head[1]


def model_flops(shapes: Shapes, mixer_flops, dispatches) -> Tuple[float, float]:
    """(all, prefill's) model FLOPs of ``dispatches``. ``mixer_flops(ctx)``
    is the reference's for one token at context ctx; it is linear in ctx
    (or constant), so a dispatch's sum over its tokens is taken from its
    token count and context sum."""
    total = pre = 0.0
    slope = mixer_flops(1) - mixer_flops(0)
    base = mixer_flops(0)
    for d in dispatches:
        f = (d.tokens * (shapes.token_flops() + base) + slope * d.context
             + d.head_rows * shapes.head_flops())
        total += f
        if d.kind == "prefill":
            pre += f
    return total, pre


def call_cost(n: int, d: int, m: int, shapes: Shapes) -> Tuple[float, float]:
    """(bytes, FLOPs) of one ternary call on m useful rows."""
    nbytes = 2 * n * d / 4 + 8 * n * d / shapes.group \
        + shapes.act_bytes * m * (d + n)
    return nbytes, 2.0 * m * n * d


def ternary_calls(shapes: Shapes, dispatches, slots: int):
    """Every ternary call of ``dispatches``: (padded rows, n, d, useful rows).
    A decode dispatch of k steps calls every layer and the head k times on
    ``slots`` rows; a prefill dispatch of bucket L calls every layer on
    slots * L rows and the head on ``slots`` rows (each row's last token)."""
    calls = []
    for dp in dispatches:
        if dp.kind == "decode":
            per = dp.tokens / dp.length
            for _ in range(dp.length):
                calls += [(slots, n, d, per) for n, d in shapes.linears]
                calls.append((slots, *shapes.head, per))
        else:
            calls += [(slots * dp.length, n, d, dp.tokens)
                      for n, d in shapes.linears]
            calls.append((slots, *shapes.head, dp.head_rows))
    return calls


def routed(calls, small_rows: int):
    """Split calls between the small-m kernel (B1) and the tiled one (B3) as
    the program does: B1 takes a call on fewer padded rows than
    ``small_rows`` (its ``SMALL_M_THRESHOLD``), B3 every other."""
    return ([c for c in calls if c[0] < small_rows],
            [c for c in calls if c[0] >= small_rows])


def bound_s(calls, shapes: Shapes, pk) -> Tuple[float, str]:
    """Least seconds of ``calls`` at the peaks, and which bound dominates."""
    t_bytes = t_ops = total = 0.0
    for _, n, d, m in calls:
        b, f = call_cost(n, d, m, shapes)
        tb, tf = b / pk["hbm_bytes_s"], f / pk["bf16_flops"]
        total += max(tb, tf)
        t_bytes += tb
        t_ops += tf
    return total, ("bytes" if t_bytes >= t_ops else "operations")


def roofline(ctx, fragment: str, small: bool) -> Optional[float]:
    """A ternary kernel's share of its roofline in the profiled interval,
    in %: the least time of the calls routed to it over its device time.
    Where the trace holds fewer of its kernels than calls were routed to it
    (a trace can miss events), its device time is scaled up by calls over
    kernels; the run's log says where the two differ. None where the
    interval holds none of its kernels or no call for them."""
    dev, pk = ctx.device, ctx.peaks
    if dev is None or pk is None or ctx.dispatches is None:
        return None
    seen = dev.kernel_count(fragment)
    if not seen:
        return None
    calls = ternary_calls(ctx.shapes, between(ctx.dispatches, dev.t0, dev.t1),
                          ctx.slots)
    mine = routed(calls, ctx.small_rows)[0 if small else 1]
    if not mine:
        ctx.note(f"{fragment}: {seen} kernels in the trace, no call routed "
                 "to them")
        return None
    if seen != len(mine):
        ctx.note(f"{fragment}: {len(mine)} calls counted, the trace holds "
                 f"{seen} of its kernels")
    least, _ = bound_s(mine, ctx.shapes, pk)
    return 100.0 * least / (dev.kernel_s(fragment) * max(len(mine), seen)
                            / seen)

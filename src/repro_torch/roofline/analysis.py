"""Roofline terms of a step, on the H100's data-sheet peaks.

Three terms per (arch × shape × mesh) cell of the dry run:

  compute    = FLOPs_per_chip / PEAK_FLOPS
  memory     = bytes_per_chip / HBM_BW
  collective = collective_bytes_per_chip / ICI_BW

``launch/dryrun.py`` fills them from counts: the FLOPs of a meta-device run
of the port's model under ``torch.utils.flop_counter``, each leaf's local
shard bytes, and closed-form collective bytes. ``shape_bytes`` and
``parse_collectives`` read an XLA HLO text (the reference's compiled
modules), kept so that either package's collectives are summed by one rule.
``model_flops`` is the analytic MODEL_FLOPS.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict

# -- hardware constants: NVIDIA H100 SXM data-sheet peaks (dense), for the
# card "NVIDIA H100 80GB HBM3, 700.00 W"; data-sheet figures, not measured
BF16_FLOPS = 989e12          # bf16 tensor-core FLOP/s
F32_FLOPS = 67e12            # f32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12    # HBM3 bytes/s
NVLINK_BYTES_PER_S = 450e9   # NVLink bytes/s each way (900 GB/s both ways)

PEAK_FLOPS = BF16_FLOPS      # FLOP/s per chip
HBM_BW = HBM_BYTES_PER_S     # bytes/s per chip
ICI_BW = NVLINK_BYTES_PER_S  # bytes/s per chip between chips

_DTYPE_BYTES = {
    "pred": 1, "s2": 1, "s4": 1, "s8": 1, "u2": 1, "u4": 1, "u8": 1,
    "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3b11fnuz": 1, "token": 0,
    "f4e2m1fn": 1, "u1": 1, "s1": 1,
}

COLLECTIVE_OPS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_DEF_RE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w\.\-]+)\s*=\s*(\([^=]*?\)|[a-z0-9]+\[[0-9,]*\][^\s]*)\s+([\w\-]+)")


def shape_bytes(type_str: str) -> int:
    """Bytes of an HLO type string, incl. tuples: '(bf16[2,3]{...}, u8[4])'."""
    total = 0
    for m in _SHAPE_RE.finditer(type_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclasses.dataclass
class CollectiveStats:
    total_bytes: int
    by_op: Dict[str, int]
    counts: Dict[str, int]

    def to_dict(self):
        return {"total_bytes": self.total_bytes, "by_op": self.by_op,
                "counts": self.counts}


def parse_collectives(hlo_text: str) -> CollectiveStats:
    """Sum operand sizes of every collective in the (post-SPMD) HLO text."""
    defs: Dict[str, str] = {}
    for line in hlo_text.splitlines():
        m = _DEF_RE.match(line)
        if m:
            defs[m.group(1)] = m.group(2)

    by_op: Dict[str, int] = {op: 0 for op in COLLECTIVE_OPS}
    counts: Dict[str, int] = {op: 0 for op in COLLECTIVE_OPS}
    for line in hlo_text.splitlines():
        m = _DEF_RE.match(line)
        if not m:
            continue
        opname = m.group(3)
        base = None
        for op in COLLECTIVE_OPS:
            if opname == op or opname.startswith(op + "-start") or \
               opname.startswith(op + "."):
                base = op
                break
        if base is None:
            continue
        # operand list between the first '(' after the op name and its ')'
        try:
            args = line.split(opname, 1)[1]
            args = args[args.index("(") + 1:]
            depth = 1
            out = []
            for ch in args:
                if ch == "(":
                    depth += 1
                elif ch == ")":
                    depth -= 1
                    if depth == 0:
                        break
                out.append(ch)
            arg_str = "".join(out)
        except (ValueError, IndexError):
            continue
        nbytes = 0
        # operands may appear as %name refs or inline-typed values
        names = re.findall(r"%([\w\.\-]+)", arg_str)
        if names:
            for nm in names:
                if nm in defs:
                    nbytes += shape_bytes(defs[nm])
        if nbytes == 0:
            nbytes = shape_bytes(arg_str)
        if nbytes == 0:
            # last resort: the result type (= operand size for all-reduce)
            nbytes = shape_bytes(m.group(2))
        by_op[base] += nbytes
        counts[base] += 1
    total = sum(by_op.values())
    return CollectiveStats(total, by_op, counts)


def roofline_terms(flops_per_chip: float, bytes_per_chip: float,
                   collective_bytes_per_chip: float) -> Dict[str, float]:
    terms = {
        "compute_s": flops_per_chip / PEAK_FLOPS,
        "memory_s": bytes_per_chip / HBM_BW,
        "collective_s": collective_bytes_per_chip / ICI_BW,
    }
    dominant = max(terms, key=terms.get)
    bound_s = terms[dominant]
    terms["dominant"] = dominant.replace("_s", "")
    terms["step_lower_bound_s"] = bound_s
    # fraction of the bound spent doing useful math (roofline fraction)
    terms["roofline_fraction"] = (
        terms["compute_s"] / bound_s if bound_s > 0 else float("nan"))
    return terms


def model_flops(cfg, shape_info, *, train: bool) -> float:
    """Analytic MODEL_FLOPS: 6·N·D (dense) / 6·N_active·D (MoE); decode D=B."""
    total, active = cfg.param_counts()
    n = active
    if shape_info["kind"] == "train":
        d = shape_info["global_batch"] * shape_info["seq_len"]
        return 6.0 * n * d
    if shape_info["kind"] == "prefill":
        d = shape_info["global_batch"] * shape_info["seq_len"]
        return 2.0 * n * d  # forward only
    # decode: one token per sequence
    return 2.0 * n * shape_info["global_batch"]

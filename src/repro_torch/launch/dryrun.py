"""Dry run of one (arch × shape × mesh) cell of the production plan.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape train_4k --mesh single [--quantized] [--policy auto]

Runs on the CPU, in its own process, on ``torch.distributed``'s fake
backend with the world size set to the mesh's size (256 or 512 ranks, this
process rank 0): nothing is allocated and no collective moves a byte. For
the cell it builds the production mesh (``launch/mesh.py``), places every
parameter by the port's rules (``sharding/partition.py``; each leaf's
``placements`` checked against ``torch.distributed.tensor``'s local shape)
and writes one JSON file with the reference's keys where they mean the
same thing: ``arch``, ``shape``, ``policy``, ``mesh``, ``axes``,
``n_chips``, ``quantized``, ``kind``, ``flops_per_chip``,
``traffic_bytes_per_chip``, ``collective_bytes_per_chip``, ``roofline``,
``model_flops_global``, ``model_flops_per_chip``, ``useful_flops_ratio``.
Keys only XLA could fill (``cost_analysis``, ``memory_analysis``,
``hlo_bytes``) are left out. Every figure is a count, never a measurement:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over a meta-device
  run of the port's model (the forward of ``prefill``: the layers over the
  whole prompt and the head at its last position; ``decode_step``; the
  forward and backward of ``loss_fn`` for train), at one and at two periods
  of the layer pattern, extrapolated to full depth as the reference's
  ``scan_corrected_costs`` does. Train and prefill count one row and scale
  by the batch, which is exact where rows do not interact (a MoE layer's
  capacity is per dispatch, so its count is approximate; prefill's head is
  counted on the whole batch); decode counts the whole batch. A
  floating-point layer's products run in 128-row blocks
  (``models/common.py``), so a count includes their padding rows, as the
  card runs them. The counter counts matrix products (mm, bmm, addmm,
  convolution, attention) and no elementwise work: the recurrences' scans
  count nothing, so the count replaces them by stand-ins of their output's
  shape (``_shape_only_scans``; the count is unchanged, and seconds instead
  of minutes at S = 32768). The per-chip figure is the count divided by
  the mesh size.
* Bytes: each leaf's local shard under its placements, read and written
  once (the reference's arguments + outputs): parameters, AdamW moments in
  ``optimizer_dtype`` for train, the batch, the decode state and the
  logits.
* Collective bytes, closed forms as ``choose_policy`` reckons them: FSDP's
  all-gather of every parameter sharded over the FSDP axes (the gathered
  size) once a step, and for train its gradient's reduce-scatter as well;
  TP's all-reduces of the (tokens a chip, d_model) activations, two a layer
  (the mixer's and the FFN's row-parallel outputs) a pass (train: forward,
  remat recompute and backward).

The roofline terms use the H100 data-sheet peaks of ``roofline/analysis``.
The default output directory is ``dryrun_out/`` at the repository's root
(git-ignored).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from repro_torch import configs
from repro_torch.configs.base import SHAPES
from repro_torch.device import dtype_of
from repro_torch.launch import specs as specs_mod
from repro_torch.roofline import analysis as roofline
from repro_torch.sharding import partition as part

RESULTS_DIR = Path(__file__).resolve().parents[3] / "dryrun_out"


def _effective_microbatches(cfg, batch: int, dp_size: int) -> int:
    m = max(1, cfg.microbatches)
    while m > 1 and not (batch % m == 0 and (batch // m) % dp_size == 0):
        m -= 1
    return m


def choose_policy(arch: str, shape_name: str, multi_pod: bool = False) -> str:
    """Arch-aware parallelism: pick fsdp_all for a train cell when FSDP's
    parameter all-gather traffic undercuts TP's per-layer activation
    all-reduces.

    Napkin model (per chip per step, bf16):
      TP    ≈ 6 collectives/layer × tokens_per_chip × d_model × 2 B
              (fwd + remat-recompute + bwd-dx, attn-out + mlp-out each)
      FSDP  ≈ 4 B × total_params (gather + gradient reduce-scatter)
    """
    cfg = configs.get_config(arch)
    info = SHAPES[shape_name]
    n_chips = 512 if multi_pod else 256
    if info["kind"] != "train" or info["global_batch"] % n_chips != 0:
        return "tp"
    total, _ = cfg.param_counts()
    dp_under_tp = n_chips // 16
    tokens_per_chip = info["global_batch"] * info["seq_len"] / dp_under_tp
    tp_bytes = 6 * cfg.n_layers * tokens_per_chip * cfg.d_model * 2
    fsdp_bytes = 4 * total
    return "fsdp_all" if fsdp_bytes < tp_bytes else "tp"


# ---------------------------------------------------------------- the mesh
def init_fake_group(world_size: int) -> None:
    """``torch.distributed``'s fake backend as rank 0 of ``world_size``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _local_bytes(tensors: Dict[str, torch.Tensor], spec_of, mesh,
                 dtype=None) -> int:
    return sum(_nbytes(part.local_shape(t.shape, spec_of[k], mesh),
                       dtype or t.dtype) for k, t in tensors.items())


def _flat_state(state, specs):
    """(tensors, specs) of a ring decode state, keyed alike."""
    leaves, spec_of = {"pos": state["pos"]}, {"pos": specs["pos"]}
    for i, (cache, cs) in enumerate(zip(state["layers"], specs["layers"])):
        for name, t in cache.items():
            leaves[f"layers.{i}.{name}"], spec_of[f"layers.{i}.{name}"] = \
                t, cs[name]
    return leaves, spec_of


def check_placements(leaves, spec_of, mesh) -> int:
    """Each leaf's ``placements`` on the mesh give ``local_shape``'s shard
    on rank 0 (``torch.distributed.tensor``'s own split). Returns the
    number of leaves checked."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    for name, t in leaves.items():
        got, _ = compute_local_shape_and_global_offset(
            tuple(t.shape), mesh, part.placements(spec_of[name], mesh))
        want = part.local_shape(t.shape, spec_of[name], mesh)
        if tuple(got) != want:
            raise AssertionError(f"{name}: placements give {tuple(got)}, "
                                 f"the spec {spec_of[name]} {want}")
    return len(leaves)


# ------------------------------------------------------------------ FLOPs
class _ShapeOnly(torch.autograd.Function):
    """A stand-in of ``like``'s shape and dtype for an elementwise op whose
    inputs are ``inputs``: no FLOP in either direction."""

    @staticmethod
    def forward(ctx, like, *inputs):
        ctx.shapes = [(t.shape, t.dtype, t.device) for t in inputs]
        return torch.empty_like(like)

    @staticmethod
    def backward(ctx, grad):
        return (None,) + tuple(torch.zeros(s, dtype=d, device=dev)
                               for s, d, dev in ctx.shapes)


@contextlib.contextmanager
def _shape_only_scans():
    """The RG-LRU's gate-and-scan and the WKV replaced, in the models, by
    stand-ins of their outputs' shapes while FLOPs are counted (both are
    elementwise: the counter counts none of their work)."""
    from repro_torch.models import rglru, rwkv6

    def gated_scan(ya, yx, ba, bx, c, g, lam, h, lengths):
        return _ShapeOnly.apply(c, ya, yx, ba, bx, c, g, lam)

    def wkv(r, k, v, w, u, state, lengths, scale, eps=None):
        b, s, nh, hd = r.shape
        return _ShapeOnly.apply(r.new_empty((b, s, nh * hd)), r, k, v, w, u,
                                scale)

    saved = rglru.rglru_gated_scan, rwkv6.wkv6
    rglru.rglru_gated_scan, rwkv6.wkv6 = gated_scan, wkv
    try:
        yield
    finally:
        rglru.rglru_gated_scan, rwkv6.wkv6 = saved


def _meta_model(cfg, quantized: bool):
    return (specs_mod.quantized_params_specs(cfg) if quantized
            else specs_mod.params_specs(cfg))


def _counted(counter) -> Dict[str, Any]:
    by_op = {str(k): int(v)
             for k, v in counter.get_flop_counts().get("Global", {}).items()}
    return {"flops": int(counter.get_total_flops()), "by_op": by_op}


def head_flops(cfg, rows: int, *, quantized: bool) -> Dict[str, Any]:
    """FLOPs of prefill's head: ``lm_head`` at the last position of
    ``rows`` prompts."""
    from torch.utils.flop_counter import FlopCounterMode

    model = _meta_model(cfg.scaled(n_layers=0), quantized)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model.lm_head(torch.empty((rows, cfg.d_model), device="meta",
                                  dtype=dtype_of(cfg.activation_dtype)))
    return _counted(counter)


def count_flops(cfg, shape_name: str, *, quantized: bool, rows: int,
                shape_only_scans: bool = True) -> Dict[str, Any]:
    """FLOPs of one step of ``cfg`` (any depth) on ``rows`` rows, counted
    by ``FlopCounterMode`` over a meta-device run: {"flops", "by_op"}. For
    prefill, the layers over the whole prompts up to the final norm (the
    head is ``head_flops``)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models.transformer import (decode_step, final_hidden,
                                                loss_fn)

    kind = SHAPES[shape_name]["kind"]
    model = _meta_model(cfg, quantized)
    scans = _shape_only_scans() if shape_only_scans \
        else contextlib.nullcontext()
    counter = FlopCounterMode(display=False)
    with scans, counter:
        if kind == "train":
            for p in model.parameters():
                p.requires_grad_(True)
            batch = specs_mod.batch_specs(cfg, shape_name, rows)
            loss_fn(model, cfg, batch).backward()
        elif kind == "prefill":
            batch = specs_mod.batch_specs(cfg, shape_name, rows)
            inputs = batch["tokens" if cfg.embed_inputs else "embeddings"]
            with torch.no_grad():
                final_hidden(model, cfg, inputs)
        else:
            state, tokens = specs_mod.decode_state_specs(cfg, shape_name,
                                                         rows)
            decode_step(model, cfg, state, tokens)
    return _counted(counter)


def depth_variant(cfg, k: int):
    """``cfg`` cut to its prefix, k periods and its remainder."""
    return cfg.scaled(n_layers=len(cfg.prefix_pattern) + k * cfg.period
                      + len(cfg.remainder_pattern))


def step_flops(cfg, shape_name: str, *, quantized: bool) -> Dict[str, Any]:
    """The whole step's FLOPs over every chip: counted at one and two
    periods, extrapolated to ``cfg.n_periods``, scaled from the counted
    rows to the batch."""
    info = SHAPES[shape_name]
    b = info["global_batch"]
    rows = b if info["kind"] == "decode" else 1
    n = cfg.n_periods
    if n <= 1:
        one = count_flops(cfg, shape_name, quantized=quantized, rows=rows)
        flops, variants = one["flops"], {"full": one}
    else:
        f1, f2 = (count_flops(depth_variant(cfg, k), shape_name,
                              quantized=quantized, rows=rows)
                  for k in (1, 2))
        flops = f1["flops"] + (n - 1) * (f2["flops"] - f1["flops"])
        variants = {"periods_1": f1, "periods_2": f2}
    out = {"flops": flops * (b // rows), "rows_counted": rows, "batch": b,
           "n_periods": n, "variants": variants}
    if info["kind"] == "prefill":
        out["head"] = head_flops(cfg, b, quantized=quantized)
        out["flops"] += out["head"]["flops"]
    return out


# ----------------------------------------------------------- collectives
def collective_bytes(cfg, info, params, spec_of, mesh, *, kind: str
                     ) -> Dict[str, float]:
    """Per-chip collective bytes of one step, by the closed forms of the
    module docstring."""
    sizes = part.mesh_axes(mesh)
    fsdp = part.fsdp_axes(mesh)
    fsdp = {fsdp} if isinstance(fsdp, str) else set(fsdp)
    gathered = 0
    for name, t in params.items():
        s = spec_of[name]
        over = [a for entry in s if entry is not None
                for a in ((entry,) if isinstance(entry, str) else entry)
                if a in fsdp]
        if over:
            local = _nbytes(part.local_shape(t.shape, s, mesh), t.dtype)
            gathered += local * math.prod(sizes[a] for a in over)
    out = {"all-gather": float(gathered), "reduce-scatter": 0.0,
           "all-reduce": 0.0}
    if kind == "train":
        out["reduce-scatter"] = float(gathered)
    tp = part.tp_axis(mesh)
    if tp is not None and sizes.get(tp, 1) > 1:
        b = info["global_batch"]
        dp = part._axis_size(mesh, part._maybe(mesh, part.dp_axes(mesh), b))
        tokens = b * (1 if kind == "decode" else info["seq_len"]) / dp
        passes = (3 if cfg.remat == "full" else 2) if kind == "train" else 1
        act = torch.empty((), dtype=dtype_of(cfg.activation_dtype)
                          ).element_size()
        out["all-reduce"] = (2.0 * passes * cfg.n_layers * tokens
                             * cfg.d_model * act)
    return out


# ------------------------------------------------------------------- cell
def run_cell(arch: str, shape_name: str, mesh_kind: str, quantized: bool,
             out_dir: Optional[Path], policy: str = "auto",
             kv8: bool = False) -> Dict[str, Any]:
    """Count one cell and write ``<arch>__<shape>__<mesh>[__q][__kv8].json``
    under ``out_dir`` (None: write nothing). Needs a process group of the
    mesh's size (``init_fake_group``)."""
    from repro_torch.launch.mesh import make_production_mesh

    t0 = time.perf_counter()
    multi = mesh_kind == "multi"
    if policy == "auto":
        policy = choose_policy(arch, shape_name, multi_pod=multi)
    cfg = configs.get_config(arch)
    if kv8:
        cfg = cfg.scaled(kv_cache_dtype="int8")
    info = SHAPES[shape_name]
    kind = info["kind"]
    if quantized and kind == "train":
        raise ValueError("quantized cells serve: train cells are floating "
                         "point")
    mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    n_chips = mesh.size()
    with part.parallelism_policy(policy):
        model = _meta_model(cfg, quantized)
        params = part.param_leaves(model)
        spec_of = part.param_specs(model, mesh)
        checked = check_placements(params, spec_of, mesh)
        dp = part._axis_size(mesh, part.dp_axes(mesh))
        b = info["global_batch"]
        nbytes = {"params": _local_bytes(params, spec_of, mesh)}
        extra: Dict[str, Any] = {}
        if kind == "train":
            m_eff = _effective_microbatches(cfg, b, dp)
            extra["microbatches"] = m_eff
            nbytes["moments"] = 2 * _local_bytes(
                params, spec_of, mesh, dtype_of(cfg.optimizer_dtype))
        if kind in ("train", "prefill"):
            batch = specs_mod.batch_specs(cfg, shape_name)
            nbytes["batch"] = _local_bytes(
                batch, part.batch_specs(batch, mesh), mesh)
        if kind == "prefill":
            from repro_torch.models.transformer import init_decode_state

            state = init_decode_state(cfg, b, info["seq_len"], device="meta")
            seq_sharded = False
        if kind == "decode":
            state, tokens = specs_mod.decode_state_specs(cfg, shape_name)
            seq_sharded = shape_name == "long_500k"
            nbytes["tokens"] = _local_bytes(
                {"t": tokens}, part.batch_specs({"t": tokens}, mesh), mesh)
        if kind != "train":
            flat, st_specs = _flat_state(state, part.state_specs(
                state, mesh, sequence_sharded=seq_sharded))
            checked += check_placements(flat, st_specs, mesh)
            nbytes["state"] = _local_bytes(flat, st_specs, mesh)
            logits = (part._maybe(mesh, part.dp_axes(mesh), b), "model")
            nbytes["logits"] = _nbytes(
                part.local_shape((b, cfg.vocab_size), logits, mesh),
                dtype_of(cfg.activation_dtype))
        # arguments + outputs: what the step reads and writes back
        rw = nbytes["params"] + nbytes.get("moments", 0)
        traffic = (2 * rw if kind == "train" else rw) \
            + nbytes.get("batch", 0) + nbytes.get("tokens", 0) \
            + nbytes.get("logits", 0) \
            + (2 * nbytes["state"] if kind == "decode"
               else nbytes.get("state", 0))
        coll = collective_bytes(cfg, info, params, spec_of, mesh, kind=kind)
        t_count = time.perf_counter()
        counted = step_flops(cfg, shape_name, quantized=quantized)
        count_s = time.perf_counter() - t_count
    flops_chip = counted["flops"] / n_chips
    coll_chip = float(sum(coll.values()))
    terms = roofline.roofline_terms(flops_chip, traffic, coll_chip)
    mf = roofline.model_flops(cfg, info, train=kind == "train")
    res = {
        "arch": arch,
        "shape": shape_name,
        "policy": policy,
        "mesh": list(mesh.shape),
        "axes": list(mesh.mesh_dim_names),
        "n_chips": n_chips,
        "quantized": quantized,
        "kv8": kv8,
        "kind": kind,
        "flops_per_chip": flops_chip,
        "traffic_bytes_per_chip": float(traffic),
        "collective_bytes_per_chip": coll_chip,
        "roofline": terms,
        "model_flops_global": mf,
        "model_flops_per_chip": mf / n_chips,
        "useful_flops_ratio": (mf / n_chips) / flops_chip
        if flops_chip else None,
        "collectives": {"total_bytes": coll_chip, "by_op": coll},
        "bytes_per_chip": nbytes,
        "counted": dict(counted, flops_per_chip=(
            "FlopCounterMode's count of the whole step over every chip "
            "divided by n_chips"), count_s=count_s),
        "placements_checked": checked,
        "constants": {"peak_flops": roofline.PEAK_FLOPS,
                      "hbm_bytes_per_s": roofline.HBM_BW,
                      "link_bytes_per_s": roofline.ICI_BW,
                      "source": "H100 SXM data sheet, not measured"},
        "seconds": time.perf_counter() - t0,
        **extra,
    }
    tag = (f"{arch}__{shape_name}__{mesh_kind}" + ("__q" if quantized else "")
           + ("__kv8" if kv8 else ""))
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{tag}.json").write_text(json.dumps(res, indent=1))
    print(f"[dryrun] {tag} OK in {res['seconds']:.1f}s ({policy}; "
          f"{flops_chip:.4g} FLOPs, {traffic:.4g} bytes, {coll_chip:.4g} "
          f"collective bytes a chip; dominant={terms['dominant']})",
          flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description="dry run of one cell on the "
                                 "fake process group (counts, no device)")
    ap.add_argument("--arch", choices=configs.ARCH_IDS, required=True)
    ap.add_argument("--shape", choices=tuple(SHAPES), required=True)
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--quantized", action="store_true",
                    help="serve with PTQTP-quantized weights (paper path)")
    ap.add_argument("--policy", choices=("auto", "tp", "fsdp_all"),
                    default="tp", help="parallelism policy")
    ap.add_argument("--kv8", action="store_true", help="int8 KV cache")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)
    import torch.distributed as dist

    init_fake_group(512 if args.mesh == "multi" else 256)
    try:
        return run_cell(args.arch, args.shape, args.mesh, args.quantized,
                        Path(args.out), policy=args.policy, kv8=args.kv8)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

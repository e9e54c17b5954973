"""Sharding rules: parameter, batch, decode-state and activation specs.

Mesh axes (``launch/mesh.py``):
  single pod:  ("data", "model") = (16, 16)
  multi-pod:   ("pod", "data", "model") = (2, 16, 16)

Strategy (the reference's ``sharding/partition.py``):
  * TP over "model": attention heads, FFN hidden, vocab, MoE experts
    (expert-parallel when E % tp == 0, else FFN-dim TP),
  * FSDP/ZeRO over "data" (+"pod"): the non-TP dim of every large matrix and
    its optimizer moments,
  * batch over ("pod", "data"),
  * long-context decode: the KV cache's sequence dim over "data" (SP).

Every rule is checked against the mesh's axis sizes and falls back to
replication for a dim that does not divide, so one rule set serves full
configs, smoke configs and any elastic mesh.

A spec is a tuple with one entry per tensor dim: None, an axis name, or a
tuple of axis names (major first), as jax's ``PartitionSpec``; a one-name
tuple is written as the name, as jax normalises it. ``placements(spec,
mesh)`` turns it into the ``Shard``/``Replicate`` list of
``torch.distributed.tensor``. A mesh is a ``DeviceMesh`` or a plain
``{axis name: size}`` mapping in mesh order, so the rules need no process
group.

The port's dense weights are (d_out, d_in), as ``torch.nn.Linear``'s, where
the reference's kernels are (d_in, d_out): each dense rule here names its
dims in the port's order. Trit-planes (…, d_out, d_in // 4) and scales
(…, d_out, d_in // G, 2) are in the same order in both packages. The port's
layers are separate modules, so no spec carries the reference's leading
None of a scan-stacked layer. Rules are keyed on the module types and
attribute names of ``models/``, not on the reference's tree paths.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]

# ---------------------------------------------------------------------------
# parallelism policy:
#   "tp"       — TP over "model" + FSDP over "data"(+"pod")  [default]
#   "fsdp_all" — no TP; FSDP/ZeRO-3 + batch over EVERY mesh axis. For small
#                dense models at large token batches, TP's per-layer
#                activation all-reduces dwarf FSDP's parameter all-gathers.
# ---------------------------------------------------------------------------
_policy_state = threading.local()


def current_policy() -> str:
    return getattr(_policy_state, "policy", "tp")


@contextlib.contextmanager
def parallelism_policy(policy: str):
    if policy not in ("tp", "fsdp_all"):
        raise ValueError(f"policy {policy!r} is not 'tp' or 'fsdp_all'")
    prev = current_policy()
    _policy_state.policy = policy
    try:
        yield
    finally:
        _policy_state.policy = prev


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh order, of a ``DeviceMesh`` or a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _norm(axis: Axis) -> Axis:
    """jax's normal form of a spec entry: a one-name tuple is the name."""
    if isinstance(axis, tuple):
        if not axis:
            return None
        return axis[0] if len(axis) == 1 else axis
    return axis


def spec(*entries: Axis) -> Spec:
    return tuple(_norm(a) for a in entries)


def _axis_size(mesh, axis: Axis) -> int:
    if axis is None:
        return 1
    sizes = mesh_axes(mesh)
    if isinstance(axis, str):
        return sizes[axis]
    return math.prod(sizes[a] for a in axis)


def _maybe(mesh, axis: Axis, dim: int) -> Axis:
    """Use ``axis`` for a dim only if the dim divides the axis size."""
    size = _axis_size(mesh, axis)
    return axis if (size > 1 and dim % size == 0) else None


def fsdp_axes(mesh) -> Axis:
    names = tuple(mesh_axes(mesh))
    if current_policy() == "fsdp_all":
        return names  # ZeRO-3 over every axis
    return ("pod", "data") if "pod" in names else ("data",)


def dp_axes(mesh) -> Axis:
    return fsdp_axes(mesh)


def tp_axis(mesh) -> Axis:
    return None if current_policy() == "fsdp_all" else "model"


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

COLUMN, ROW, REPLICATED = "column", "row", "replicated"


def _roles():
    """(owner type, attribute) -> the role of a dense layer or expert stack:
    column-parallel (input over FSDP, output over TP), row-parallel
    (contraction over TP, output over FSDP) or replicated (the router)."""
    from repro_torch.models.attention import Attention
    from repro_torch.models.mlp import MLP
    from repro_torch.models.moe import Experts, MoE
    from repro_torch.models.rglru import RGLRU
    from repro_torch.models.rwkv6 import RWKVChannel, RWKVTime
    from repro_torch.models.transformer import Transformer

    return {
        Transformer: {"lm_head": COLUMN},
        Attention: {"wq": COLUMN, "wk": COLUMN, "wv": COLUMN, "wo": ROW},
        MLP: {"wi": COLUMN, "wg": COLUMN, "wo": ROW},
        MoE: {"router": REPLICATED},
        Experts: {"wi": COLUMN, "wg": COLUMN, "wo": ROW},
        RGLRU: {"wx": COLUMN, "wgate": COLUMN, "wo": ROW},
        RWKVTime: {"wr": COLUMN, "wk": COLUMN, "wv": COLUMN, "wg": COLUMN,
                   "wo": ROW},
        RWKVChannel: {"wk": COLUMN, "wr": COLUMN, "wv": ROW},
    }


def _dense_axes(role: str, mesh) -> Tuple[Axis, Axis]:
    """(axis of d_in, axis of d_out) of a dense layer, before divisibility."""
    if role == COLUMN:
        return fsdp_axes(mesh), tp_axis(mesh)
    if role == ROW:
        return tp_axis(mesh), fsdp_axes(mesh)
    return None, None


def _dense_specs(layer, role: str, mesh) -> Dict[str, Spec]:
    """Specs of a ``Dense``'s weight (d_out, d_in), bias and planes."""
    d_in, d_out = layer.d_in, layer.d_out
    in_ax, out_ax = _dense_axes(role, mesh)
    in_ax, out_ax = _maybe(mesh, in_ax, d_in), _maybe(mesh, out_ax, d_out)
    out: Dict[str, Spec] = {}
    if layer.weight is not None:
        out["weight"] = spec(out_ax, in_ax)
    if layer.bias is not None:
        out["bias"] = spec(_maybe(mesh, tp_axis(mesh), d_out)
                           if role == COLUMN else None)
    if layer.t1p is not None:
        plane = spec(_maybe(mesh, out_ax, d_out),
                     _maybe(mesh, in_ax, d_in // 4))
        out.update(t1p=plane, t2p=plane,
                   alpha=spec(_maybe(mesh, out_ax, d_out), None, None))
    return out


def _expert_specs(stack, role: str, mesh) -> Dict[str, Spec]:
    """Specs of an ``ExpertDense`` (E, d_out, d_in) stack: the experts over
    TP when E divides it (expert-parallel), else FFN-dim TP."""
    sizes = mesh_axes(mesh)
    tp, fsdp = tp_axis(mesh), fsdp_axes(mesh)
    e, d_in, d_out = stack.n_experts, stack.d_in, stack.d_out
    out: Dict[str, Spec] = {}
    if stack.weight is not None:
        ep = tp is not None and e % sizes[tp] == 0
        if role == ROW:   # wo: (E, d_model, d_expert)
            out["weight"] = (spec(tp, _maybe(mesh, fsdp, d_out), None) if ep
                             else spec(None, _maybe(mesh, fsdp, d_out),
                                       _maybe(mesh, tp, d_in)))
        else:             # wi, wg: (E, d_expert, d_model)
            out["weight"] = (spec(tp, None, _maybe(mesh, fsdp, d_in)) if ep
                             else spec(None, _maybe(mesh, tp, d_out),
                                       _maybe(mesh, fsdp, d_in)))
    if stack.t1p is not None:
        ep = tp is not None and sizes[tp] > 1 and e % sizes[tp] == 0
        if role == ROW:
            out_ax, in_ax = (fsdp, None) if ep else (fsdp, tp)
        else:
            out_ax, in_ax = (None, fsdp) if ep else (tp, fsdp)
        e_ax = tp if ep else None
        plane = spec(e_ax, _maybe(mesh, out_ax, d_out),
                     _maybe(mesh, in_ax, d_in // 4))
        out.update(t1p=plane, t2p=plane,
                   alpha=spec(e_ax, _maybe(mesh, out_ax, d_out), None, None))
    return out


def _leaf_spec(owner, attr: str, name: str, shape, mesh) -> Spec:
    """A floating-point leaf that is not a dense weight: the embedding
    (vocab over TP, width over FSDP), the RG-LRU's ``lam`` and conv weight
    (channels over TP); every other leaf (norm scales, biases, gates, the
    rwkv mixes, LoRAs, decay, u) replicated. ``attr`` is ``owner``'s
    name in its parent."""
    from repro_torch.models.rglru import RGLRU, WB
    from repro_torch.models.transformer import Transformer

    tp = tp_axis(mesh)
    if isinstance(owner, Transformer) and name == "embed":
        return spec(_maybe(mesh, tp, shape[0]),
                    _maybe(mesh, fsdp_axes(mesh), shape[1]))
    if isinstance(owner, RGLRU) and name == "lam":
        return spec(_maybe(mesh, tp, shape[0]))
    if isinstance(owner, WB) and attr == "conv" and name == "w":
        return spec(None, _maybe(mesh, tp, shape[1]))
    return (None,) * len(shape)


def param_specs(model, mesh) -> Dict[str, Spec]:
    """{name: spec} for every parameter of the port's ``Transformer``
    (``named_parameters()`` names) and every quantized buffer (a layer's
    ``t1p``, ``t2p`` and ``alpha``), dense or quantized."""
    from repro_torch.models.common import Dense
    from repro_torch.models.moe import ExpertDense

    roles = _roles()
    out: Dict[str, Spec] = {}

    def walk(module, prefix: str, attr: str, role: Optional[str]):
        if isinstance(module, (Dense, ExpertDense)):
            rule = _dense_specs if isinstance(module, Dense) else _expert_specs
            for leaf, s in rule(module, role or REPLICATED, mesh).items():
                out[prefix + leaf] = s
            return
        for name, p in module.named_parameters(recurse=False):
            out[prefix + name] = _leaf_spec(module, attr, name, p.shape, mesh)
        owned = roles.get(type(module), {})
        for name, child in module.named_children():
            walk(child, f"{prefix}{name}.", name, owned.get(name))

    walk(model, "", "", None)
    return out


def param_leaves(model) -> Dict[str, Any]:
    """{name: tensor} of the leaves ``param_specs`` names: every parameter
    and every quantized buffer of ``model``."""
    out = dict(model.named_parameters())
    for name, buf in model.named_buffers():
        if name.rsplit(".", 1)[-1] in ("t1p", "t2p", "alpha"):
            out[name] = buf
    return out


# ---------------------------------------------------------------------------
# batch / decode-state rules
# ---------------------------------------------------------------------------

def batch_specs(batch: Mapping[str, Any], mesh) -> Dict[str, Spec]:
    """Each leaf's batch dim over the data-parallel axes."""
    dp = dp_axes(mesh)
    return {k: spec(_maybe(mesh, dp, v.shape[0]), *([None] * (v.dim() - 1)))
            for k, v in batch.items()}


def _state_rule(name: str, core, mesh, sequence_sharded: bool) -> Spec:
    dp = dp_axes(mesh)
    if name in ("k_scale", "v_scale"):  # (B, cap, KV) int8-cache scales
        if sequence_sharded:
            return spec(None, _maybe(mesh, "data", core[1]), None)
        return spec(_maybe(mesh, dp, core[0]),
                    _maybe(mesh, "model", core[1]), None)
    if name in ("k", "v"):              # (B, cap, KV, hd)
        if sequence_sharded:
            return spec(None, _maybe(mesh, "data", core[1]), None, None)
        # batch over dp AND cache sequence over "model" (KV heads are too
        # few to TP; slot sharding divides the cache's bytes by tp)
        return spec(_maybe(mesh, dp, core[0]),
                    _maybe(mesh, "model", core[1]), None, None)
    if name == "pos" and len(core) == 2:  # ring position buffer
        if sequence_sharded:
            return spec(None, _maybe(mesh, "data", core[1]))
        return spec(_maybe(mesh, dp, core[0]), _maybe(mesh, "model", core[1]))
    if name == "pos":                     # top-level (B,)
        return spec(_maybe(mesh, dp, core[0]))
    if name == "wkv":                     # (B, H, hd, hd)
        return spec(_maybe(mesh, dp, core[0]), None, None, None)
    if name == "h":                       # (B, R)
        return spec(_maybe(mesh, dp, core[0]), _maybe(mesh, "model", core[1]))
    if name == "conv":                    # (B, W-1, R)
        return spec(_maybe(mesh, dp, core[0]), None,
                    _maybe(mesh, "model", core[2]))
    # x_time / x_chan (B, D); paged pool leaves (P, ps, ...) and the table
    return spec(_maybe(mesh, dp, core[0]), *([None] * (len(core) - 1)))


def state_specs(state: Mapping[str, Any], mesh, *,
                sequence_sharded: bool) -> Dict[str, Any]:
    """Specs of the port's decode state (``init_decode_state``), in its
    structure: ``pos``, one dict a layer, and for the paged layout the
    ``pool`` (each leaf's leading dim stacks the attention layers: None)
    and the ``table``. ``sequence_sharded`` is the long-context (SP) mode."""
    rule = lambda name, core: _state_rule(  # noqa: E731
        name, tuple(core), mesh, sequence_sharded)
    out: Dict[str, Any] = {
        "pos": rule("pos", state["pos"].shape),
        "layers": [{name: rule(name, leaf.shape)
                    for name, leaf in cache.items()}
                   for cache in state["layers"]]}
    if "pool" in state:
        out["pool"] = {name: (None,) + rule(name, leaf.shape[1:])
                       for name, leaf in state["pool"].items()}
        out["table"] = rule("table", state["table"].shape)
    return out


def activation_rules(mesh, *, mode: str) -> Dict[str, Optional[Spec]]:
    """Rules consumed by ``repro_torch.sharding.api.constrain`` inside the
    models."""
    dp = dp_axes(mesh)
    tp = tp_axis(mesh)
    if mode in ("train", "prefill"):
        return {"hidden": spec(dp, None, None),
                "logits": spec(dp, None, tp),
                "decode_logits": spec(dp, tp)}
    if mode == "decode":
        return {"decode_logits": spec(dp, tp), "hidden": None}
    if mode == "decode_long":   # batch 1: only vocab TP applies
        return {"decode_logits": spec(None, tp), "hidden": None}
    raise ValueError(mode)


# ---------------------------------------------------------------------------
# specs -> torch.distributed.tensor
# ---------------------------------------------------------------------------

def placements(spec_: Spec, mesh) -> List[Any]:
    """The ``Shard(d)`` / ``Replicate()`` list of ``spec_``, one entry per
    mesh dim (the counterpart of the reference's ``named()``). A dim over
    several axes is split major axis first, as jax splits it: that needs
    its axes in mesh order, and anything else raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    out: List[Any] = [Replicate() for _ in names]
    for dim, axis in enumerate(spec_):
        if axis is None:
            continue
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        at = [names.index(a) for a in axes]
        if at != sorted(at):
            raise ValueError(f"axes {axes} of dim {dim} are not in the "
                             f"mesh's order {tuple(names)}")
        for i in at:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two dims "
                                 f"in {spec_}")
            out[i] = Shard(dim)
    return out


def local_shape(shape, spec_: Spec, mesh) -> Tuple[int, ...]:
    """The largest local shard's shape of a tensor of ``shape`` under
    ``spec_`` (each sharded dim divided by its axes' size, rounded up)."""
    out = list(shape)
    for dim, axis in enumerate(spec_):
        out[dim] = -(-out[dim] // _axis_size(mesh, axis))
    return tuple(out)

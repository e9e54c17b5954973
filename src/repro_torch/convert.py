"""Carry weights between the reference's params-tree layout and the port's
modules.

``from_jax_params(tree, cfg)`` takes a params tree in the reference's
layout, its leaves numpy arrays (``np.asarray`` of the reference's arrays;
no JAX type is needed here) or torch tensors (an artifact loaded by
``repro_torch.artifacts``), and returns the port's ``Transformer`` holding
the same bytes. Dense kernels are (d_in, d_out) there and become (d_out,
d_in) weights here; quantized kernels — any object or dict with ``t1p``,
``t2p``, ``alpha``, ``d_in``, ``d_out``, ``group_size`` — keep their uint8
packed planes and f32 scales unchanged. Scan-stacked ``blocks/b{i}``
leaves are split into one ``ModuleList`` entry per layer. A MoE layer's
``moe`` subtree carries the f32 ``router``, the ``experts`` stacks
``wi``/``wg``/``wo`` with their leading E axis (kernels (E, d_in, d_out)
there, weights (E, d_out, d_in) here) and the ``shared`` MLP. A recurrent
layer's ``rec`` (RG-LRU) or ``time``/``chan`` (rwkv6) subtree keeps its
floating-point leaves (conv, gates, ``lam``, token-shift mixes, LoRAs,
decay, ``u``, ``ln_x``) in the reference's layout, and its dense kernels
as above.

``to_reference_tree(model, cfg)`` is the inverse: the reference's paths,
key order, scan stacking (a leading L under ``blocks/b{i}``) and kernel
layout, with the model's tensors (on its device) as leaves, so the artifact
writer can store a port model in the reference's format, byte for byte.
The reference's ``init_params`` builds the unstacked ``prefix``/``suffix``
blocks in insertion order and the stacked ``blocks`` with sorted keys
(``jax.tree.map`` sorts them); the tree here follows both.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.core.quantize_model import QuantizedKernel
from repro_torch.device import dtype_of, resolve_device
from repro_torch.models.common import Dense
from repro_torch.models.mlp import MLP
from repro_torch.models.moe import MoE
from repro_torch.models.transformer import Block, Transformer, is_recurrent

#: the rwkv6 time mix's floating-point leaves, in the reference's order
TIME_FP = ("mu_x", "mu", "mix_lora_a", "mix_lora_b", "decay_base",
           "decay_lora_a", "decay_lora_b", "u")

_QK_FIELDS = ("t1p", "t2p", "alpha", "d_in", "d_out", "group_size")


def _field(leaf, name):
    return leaf[name] if isinstance(leaf, dict) else getattr(leaf, name)


def _is_qk(leaf) -> bool:
    if isinstance(leaf, dict):
        return all(f in leaf for f in _QK_FIELDS)
    return all(hasattr(leaf, f) for f in _QK_FIELDS)


def _index(tree, i):
    """Layer i of a scan-stacked subtree (every leaf has a leading L)."""
    if _is_qk(tree):
        return {"t1p": _field(tree, "t1p")[i], "t2p": _field(tree, "t2p")[i],
                "alpha": _field(tree, "alpha")[i],
                "d_in": _field(tree, "d_in"), "d_out": _field(tree, "d_out"),
                "group_size": _field(tree, "group_size")}
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _tensor(a, dtype, device):
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy extension type torch cannot read;
        a = a.astype(np.float32)    # widening is exact
    return torch.from_numpy(np.array(a, order="C")).to(device=device,
                                                       dtype=dtype)


def _load_dense(layer, node: Dict[str, Any], device):
    """A ``Dense`` layer, or a MoE ``ExpertDense`` stack (kernel (E, d_in,
    d_out) there, weight (E, d_out, d_in) here)."""
    kernel = node["kernel"]
    if _is_qk(kernel):
        layer.set_quantized(QuantizedKernel(
            _tensor(_field(kernel, "t1p"), torch.uint8, device),
            _tensor(_field(kernel, "t2p"), torch.uint8, device),
            _tensor(_field(kernel, "alpha"), torch.float32, device),
            int(_field(kernel, "d_in")), int(_field(kernel, "d_out")),
            int(_field(kernel, "group_size"))))
    else:
        kernel = kernel if isinstance(kernel, torch.Tensor) \
            else np.asarray(kernel)
        layer.weight.copy_(_tensor(kernel.swapaxes(-1, -2),
                                   layer.weight.dtype, device))
    if "bias" in node:
        layer.bias.copy_(_tensor(node["bias"], layer.bias.dtype, device))


def _copy(param, leaf, device):
    param.copy_(_tensor(leaf, param.dtype, device))


def _load_recurrent(block: Block, node: Dict[str, Any], device):
    if block.kind == "rwkv":
        _copy(block.time_norm.scale, node["time_norm"]["scale"], device)
        _copy(block.chan_norm.scale, node["chan_norm"]["scale"], device)
        t, tn = block.time, node["time"]
        for name in TIME_FP:
            _copy(getattr(t, name), tn[name], device)
        _copy(t.ln_x.scale, tn["ln_x"]["scale"], device)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            _load_dense(getattr(t, name), tn[name], device)
        c, cn = block.chan, node["chan"]
        _copy(c.mu_k, cn["mu_k"], device)
        _copy(c.mu_r, cn["mu_r"], device)
        for name in ("wk", "wv", "wr"):
            _load_dense(getattr(c, name), cn[name], device)
        return
    _copy(block.rec_norm.scale, node["rec_norm"]["scale"], device)
    _copy(block.mlp_norm.scale, node["mlp_norm"]["scale"], device)
    rec, rn = block.rec, node["rec"]
    for name in ("wx", "wgate", "wo"):
        _load_dense(getattr(rec, name), rn[name], device)
    for name in ("conv", "gate_a", "gate_x"):
        _copy(getattr(rec, name).w, rn[name]["w"], device)
        _copy(getattr(rec, name).b, rn[name]["b"], device)
    _copy(rec.lam, rn["lam"], device)
    _load_mlp(block.mlp, node["mlp"], device)


def _load_block(block: Block, node: Dict[str, Any], device):
    if is_recurrent(block.kind):
        _load_recurrent(block, node, device)
        return
    block.attn_norm.scale.copy_(_tensor(node["attn_norm"]["scale"],
                                        block.attn_norm.scale.dtype, device))
    block.mlp_norm.scale.copy_(_tensor(node["mlp_norm"]["scale"],
                                       block.mlp_norm.scale.dtype, device))
    for name in ("wq", "wk", "wv", "wo"):
        _load_dense(getattr(block.attn, name), node["attn"][name], device)
    if block.moe is not None:
        moe: MoE = block.moe
        _load_dense(moe.router, node["moe"]["router"], device)
        for name in ("wi", "wg", "wo"):
            _load_dense(getattr(moe.experts, name),
                        node["moe"]["experts"][name], device)
        if moe.shared is not None:
            _load_mlp(moe.shared, node["moe"]["shared"], device)
    else:
        _load_mlp(block.mlp, node["mlp"], device)


def _load_mlp(mlp: MLP, node: Dict[str, Any], device):
    for name in ("wi", "wg", "wo"):
        layer = getattr(mlp, name)
        if layer is not None:
            _load_dense(layer, node[name], device)


def _layer_nodes(tree, cfg) -> List[Dict[str, Any]]:
    nodes = [tree["prefix"][f"p{i}"] for i in range(len(cfg.prefix_pattern))]
    for i in range(cfg.n_periods):
        for pidx in range(cfg.period):
            nodes.append(_index(tree["blocks"][f"b{pidx}"], i))
    nodes += [tree["suffix"][f"s{i}"]
              for i in range(len(cfg.remainder_pattern))]
    return nodes


@torch.no_grad()
def from_jax_params(tree: Dict[str, Any], cfg, device="cuda") -> Transformer:
    """The port's model with the reference tree's bytes."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype)
    model = Transformer(cfg, dtype=dtype, device=dev)
    model.embed.copy_(_tensor(tree["embed"]["embedding"], dtype, dev))
    for block, node in zip(model.layers, _layer_nodes(tree, cfg)):
        _load_block(block, node, dev)
    model.final_norm.scale.copy_(_tensor(tree["final_norm"]["scale"], dtype,
                                         dev))
    _load_dense(model.lm_head, tree["lm_head"], dev)
    return model


# ---------------------------------------------------------------------------
# port -> reference layout
# ---------------------------------------------------------------------------

def _dense_node(layer, order=sorted) -> Dict[str, Any]:
    """A dense layer's (or expert stack's) node, keys in ``order``."""
    qk = layer.quant
    node: Dict[str, Any] = {
        "kernel": qk if qk is not None
        else layer.weight.detach().swapaxes(-1, -2).contiguous()}
    if getattr(layer, "bias", None) is not None:
        node["bias"] = layer.bias.detach()
    return {k: node[k] for k in order(node)}


def _insertion(keys):
    """The order of the reference's initializers (``dense_init``: kernel,
    bias; ``mlp_init``: wi, wg, wo; attention: wq, wk, wv, wo; a block:
    attn_norm, attn, mlp_norm, mlp or moe; ``moe_init``: router, experts,
    shared)."""
    rank = ("kernel", "bias", "attn_norm", "attn", "mlp_norm", "mlp", "moe",
            "wq", "wk", "wv", "wi", "wg", "wo", "router", "experts",
            "shared")
    return sorted(keys, key=rank.index)


def _keyed(node: Dict[str, Any], order) -> Dict[str, Any]:
    """``node`` (built in the reference's insertion order) in ``order``."""
    if order is _insertion:
        return node
    return {k: node[k] for k in order(node)}


def _wb(wb, order) -> Dict[str, Any]:
    return _keyed({"w": wb.w.detach(), "b": wb.b.detach()}, order)


def _recurrent_node(block: Block, order) -> Dict[str, Any]:
    """A recurrent layer's subtree in ``order`` (the reference's
    ``_block_init``, ``rglru_init``, ``rwkv_time_init`` and
    ``rwkv_channel_init`` build theirs in insertion order)."""
    if block.kind == "rwkv":
        t, c = block.time, block.chan
        time = {name: getattr(t, name).detach() for name in TIME_FP}
        time.update({name: _dense_node(getattr(t, name), order)
                     for name in ("wr", "wk", "wv", "wg", "wo")})
        time["ln_x"] = {"scale": t.ln_x.scale.detach()}
        chan = {"mu_k": c.mu_k.detach(), "mu_r": c.mu_r.detach()}
        chan.update({name: _dense_node(getattr(c, name), order)
                     for name in ("wk", "wv", "wr")})
        node = {"time_norm": {"scale": block.time_norm.scale.detach()},
                "time": _keyed(time, order),
                "chan_norm": {"scale": block.chan_norm.scale.detach()},
                "chan": _keyed(chan, order)}
        return _keyed(node, order)
    rec = block.rec
    rnode = {"wx": _dense_node(rec.wx, order),
             "wgate": _dense_node(rec.wgate, order),
             "conv": _wb(rec.conv, order),
             "gate_a": _wb(rec.gate_a, order),
             "gate_x": _wb(rec.gate_x, order), "lam": rec.lam.detach(),
             "wo": _dense_node(rec.wo, order)}
    node = {"rec_norm": {"scale": block.rec_norm.scale.detach()},
            "rec": _keyed(rnode, order),
            "mlp_norm": {"scale": block.mlp_norm.scale.detach()},
            "mlp": _mlp_node(block.mlp, order)}
    return _keyed(node, order)


def _mlp_node(mlp: MLP, order) -> Dict[str, Any]:
    return {name: _dense_node(getattr(mlp, name), order)
            for name in order(("wi", "wg", "wo"))
            if getattr(mlp, name) is not None}


def _block_node(block: Block, order=sorted) -> Dict[str, Any]:
    """One layer's subtree, keys in ``order``: sorted for the scan-stacked
    ``blocks``, ``_insertion`` for the ``prefix`` and ``suffix`` blocks."""
    if is_recurrent(block.kind):
        return _recurrent_node(block, order)
    node: Dict[str, Any] = {
        "attn": {name: _dense_node(getattr(block.attn, name), order)
                 for name in order(("wq", "wk", "wv", "wo"))},
        "attn_norm": {"scale": block.attn_norm.scale.detach()},
        "mlp_norm": {"scale": block.mlp_norm.scale.detach()}}
    if block.moe is not None:
        moe = {"router": _dense_node(block.moe.router, order),
               "experts": {name: _dense_node(getattr(block.moe.experts, name),
                                             order)
                           for name in order(("wi", "wg", "wo"))}}
        if block.moe.shared is not None:
            moe["shared"] = _mlp_node(block.moe.shared, order)
        node["moe"] = {k: moe[k] for k in order(moe)}
    else:
        node["mlp"] = _mlp_node(block.mlp, order)
    return {k: node[k] for k in order(node)}


def _stack(nodes: List[Any]) -> Any:
    """Stack per-layer subtrees along a new leading L (quantized kernels
    stack their planes and scales)."""
    first = nodes[0]
    if isinstance(first, QuantizedKernel):
        return QuantizedKernel(*(torch.stack([getattr(n, f) for n in nodes])
                                 for f in ("t1p", "t2p", "alpha")),
                               first.d_in, first.d_out, first.group_size)
    if isinstance(first, dict):
        return {k: _stack([n[k] for n in nodes]) for k in first}
    return torch.stack(nodes)


@torch.no_grad()
def to_reference_tree(model: Transformer, cfg) -> Dict[str, Any]:
    """The reference's params tree of ``model``: ``from_jax_params`` of it
    gives back byte-identical tensors."""
    layers = list(model.layers)
    n_pre = len(cfg.prefix_pattern)
    tree: Dict[str, Any] = {"embed": {"embedding": model.embed.detach()}}
    tree["prefix"] = {f"p{i}": _block_node(layers[i], _insertion)
                      for i in range(n_pre)}
    tree["blocks"] = {
        f"b{pidx}": _stack([_block_node(layers[n_pre + i * cfg.period + pidx])
                            for i in range(cfg.n_periods)])
        for pidx in range(cfg.period) if cfg.n_periods}
    first_suffix = n_pre + cfg.n_periods * cfg.period
    tree["suffix"] = {f"s{i}": _block_node(layers[first_suffix + i],
                                           _insertion)
                      for i in range(len(cfg.remainder_pattern))}
    tree["final_norm"] = {"scale": model.final_norm.scale.detach()}
    tree["lm_head"] = _dense_node(model.lm_head)
    return tree

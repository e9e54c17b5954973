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
leaves are split into one ``ModuleList`` entry per layer.

``to_reference_tree(model, cfg)`` is the inverse: the reference's paths,
key order, scan stacking (a leading L under ``blocks/b{i}``) and kernel
layout, with the model's tensors (on its device) as leaves, so the artifact
writer can store a port model in the reference's format, byte for byte.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.core.quantize_model import QuantizedKernel
from repro_torch.device import dtype_of, resolve_device
from repro_torch.models.common import Dense
from repro_torch.models.transformer import Block, Transformer

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


def _load_dense(layer: Dense, node: Dict[str, Any], device):
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
        layer.weight.copy_(_tensor(kernel.T, layer.weight.dtype, device))
    if "bias" in node:
        layer.bias.copy_(_tensor(node["bias"], layer.bias.dtype, device))


def _load_block(block: Block, node: Dict[str, Any], device):
    block.attn_norm.scale.copy_(_tensor(node["attn_norm"]["scale"],
                                        block.attn_norm.scale.dtype, device))
    block.mlp_norm.scale.copy_(_tensor(node["mlp_norm"]["scale"],
                                       block.mlp_norm.scale.dtype, device))
    for name in ("wq", "wk", "wv", "wo"):
        _load_dense(getattr(block.attn, name), node["attn"][name], device)
    for name in ("wi", "wg", "wo"):
        layer = getattr(block.mlp, name)
        if layer is not None:
            _load_dense(layer, node["mlp"][name], device)


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

def _dense_node(layer: Dense) -> Dict[str, Any]:
    qk = layer.quant
    node: Dict[str, Any] = {}
    if layer.bias is not None:
        node["bias"] = layer.bias.detach()
    node["kernel"] = qk if qk is not None \
        else layer.weight.detach().T.contiguous()
    return node


def _block_node(block: Block) -> Dict[str, Any]:
    """One layer's subtree, keys in sorted order (the order the reference's
    scan-stacked subtrees have)."""
    attn = {name: _dense_node(getattr(block.attn, name))
            for name in ("wk", "wo", "wq", "wv")}
    mlp = {name: _dense_node(getattr(block.mlp, name))
           for name in ("wg", "wi", "wo")
           if getattr(block.mlp, name) is not None}
    return {"attn": attn,
            "attn_norm": {"scale": block.attn_norm.scale.detach()},
            "mlp": mlp,
            "mlp_norm": {"scale": block.mlp_norm.scale.detach()}}


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
    tree["prefix"] = {f"p{i}": _block_node(layers[i]) for i in range(n_pre)}
    tree["blocks"] = {
        f"b{pidx}": _stack([_block_node(layers[n_pre + i * cfg.period + pidx])
                            for i in range(cfg.n_periods)])
        for pidx in range(cfg.period) if cfg.n_periods}
    first_suffix = n_pre + cfg.n_periods * cfg.period
    tree["suffix"] = {f"s{i}": _block_node(layers[first_suffix + i])
                      for i in range(len(cfg.remainder_pattern))}
    tree["final_norm"] = {"scale": model.final_norm.scale.detach()}
    tree["lm_head"] = _dense_node(model.lm_head)
    return tree

"""Artifact format: manifest schema, leaf codec, config (de)serialization (a
copy of the reference's ``repro.artifacts.format``, for torch tensors).

This module owns every byte-level and JSON-level convention of the artifact
directory (see the package docstring for the layout), so the writer and the
reader share one codec. A buffer's bytes are its raw little-endian element
bytes; a ``torch.bfloat16`` buffer is recorded under the dtype string
``"bfloat16"``, as the reference writes it, and read back through a
``uint16`` view, so neither package needs ``ml_dtypes`` to read the other's
artifacts.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.core.quantize_model import QuantizedKernel

FORMAT_NAME = "ptqtp-artifact"
FORMAT_VERSION = 1
MANIFEST_NAME = "manifest.json"
SHARD_ALIGN = 64  # byte alignment of every tensor buffer inside a shard

# QuantizedKernel buffer names, in canonical storage order.
QK_BUFFERS = ("t1p", "t2p", "alpha")
# Flat-key names of the leaf codec (the reference's checkpoint npz suffixes).
QK_KEY_PREFIX = "__qk_"
QK_META_KEY = "__qk_meta"


class ArtifactError(RuntimeError):
    """Malformed, incomplete, or corrupt artifact."""


# ---------------------------------------------------------------------------
# dtypes: manifest strings <-> torch
# ---------------------------------------------------------------------------

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16, "float64": torch.float64,
                 "uint8": torch.uint8, "int8": torch.int8,
                 "int16": torch.int16, "int32": torch.int32,
                 "int64": torch.int64, "bool": torch.bool}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def dtype_name(arr) -> str:
    """The manifest's dtype string of a torch tensor or numpy array (the
    reference's ``str(arr.dtype)``)."""
    if isinstance(arr, torch.Tensor):
        return _DTYPE_NAMES[arr.dtype]
    return str(np.asarray(arr).dtype)


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ArtifactError(f"unsupported buffer dtype {name!r}") from None


# ---------------------------------------------------------------------------
# QuantizedKernel leaf codec
# ---------------------------------------------------------------------------

def encode_quantized_kernel(qk: QuantizedKernel) -> Dict[str, Any]:
    """QuantizedKernel -> flat field dict; the static metadata rides along
    as one int64 vector."""
    fields = {f"{QK_KEY_PREFIX}{name}": getattr(qk, name)
              for name in QK_BUFFERS}
    fields[QK_META_KEY] = np.asarray(
        [qk.d_in, qk.d_out, qk.group_size], np.int64)
    return fields


def decode_quantized_kernel(fields: Dict[str, Any]) -> QuantizedKernel:
    """Inverse of :func:`encode_quantized_kernel`."""
    meta = np.asarray(fields[QK_META_KEY])
    return QuantizedKernel(
        fields[f"{QK_KEY_PREFIX}t1p"], fields[f"{QK_KEY_PREFIX}t2p"],
        fields[f"{QK_KEY_PREFIX}alpha"],
        int(meta[0]), int(meta[1]), int(meta[2]))


# ---------------------------------------------------------------------------
# params-tree walking (writer side) / rebuilding (reader side)
# ---------------------------------------------------------------------------

def iter_tree_leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """Yield (path, leaf) pairs with the reference's ``/a/b`` path naming,
    in the tree's order, one leaf at a time."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from iter_tree_leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from iter_tree_leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def unflatten_paths(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{"/a/b": leaf} -> nested dict tree (model params are dict-only)."""
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        parts = [p for p in path.split("/") if p]
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return root


# ---------------------------------------------------------------------------
# config (de)serialization
# ---------------------------------------------------------------------------

# The reference's PTQTPConfig also carries ``use_search_kernel`` (its Pallas
# routing knob). The planes do not depend on it (the search kernel is
# exact), so the port records the reference's default and drops the key on
# reading: manifests of both packages then carry the same keys.
PTQTP_REFERENCE_ONLY = {"use_search_kernel": False}


def ptqtp_config_to_json(cfg) -> Dict[str, Any]:
    return dict(dataclasses.asdict(cfg), **PTQTP_REFERENCE_ONLY)


def ptqtp_config_from_json(d: Dict[str, Any]):
    from repro_torch.core.ptqtp import PTQTPConfig

    d = {k: v for k, v in d.items() if k not in PTQTP_REFERENCE_ONLY}
    return PTQTPConfig(**d)


# Runtime dispatch knobs that say nothing about the quantized weights: kept
# out of the manifest so artifact identity depends only on the model.
RUNTIME_ONLY_CONFIG_KEYS = ("attn_backend",)


def model_config_to_json(cfg) -> Dict[str, Any]:
    d = dataclasses.asdict(cfg)
    for k in RUNTIME_ONLY_CONFIG_KEYS:
        d.pop(k, None)
    return d


def model_config_from_json(d: Dict[str, Any]):
    """The port's ``ModelConfig`` (fields one for one the reference's)."""
    from repro_torch.configs.base import ModelConfig, MoEConfig

    d = dict(d)
    for k in RUNTIME_ONLY_CONFIG_KEYS:
        d.pop(k, None)
    if d.get("moe") is not None:
        d["moe"] = MoEConfig(**d["moe"])
    for k in ("block_pattern", "prefix_pattern"):
        if d.get(k) is not None:
            d[k] = tuple(d[k])
    return ModelConfig(**d)


# ---------------------------------------------------------------------------
# checksums / buffer records
# ---------------------------------------------------------------------------

def byte_view(arr) -> np.ndarray:
    """Flat uint8 host view of a tensor's or array's raw bytes (a copy to
    the host first for a device tensor)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().reshape(-1).contiguous().cpu()
        return t.view(torch.uint8).numpy()
    return np.ascontiguousarray(np.atleast_1d(arr)).view(np.uint8).reshape(-1)


def checksum(data) -> int:
    """crc32 of a buffer's raw bytes (cheap, catches bit-flips/truncation)."""
    return zlib.crc32(byte_view(data)) & 0xFFFFFFFF


def buffer_record(shard: str, offset: int, arr, raw=None) -> Dict[str, Any]:
    """Manifest entry for one raw buffer inside a shard file (``raw``: its
    bytes, when the caller already holds them)."""
    raw = byte_view(arr) if raw is None else raw
    return {
        "shard": shard,
        "offset": int(offset),
        "nbytes": int(raw.nbytes),
        "shape": list(arr.shape),
        "dtype": dtype_name(arr),
        "crc32": zlib.crc32(raw) & 0xFFFFFFFF,
    }


def align_up(n: int, align: int = SHARD_ALIGN) -> int:
    return (n + align - 1) // align * align

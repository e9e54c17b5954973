"""Sharded, atomic, elastic checkpointing (the reference's
``repro.runtime.checkpoint``, same layout and bytes: either package resumes
from the other's checkpoints).

Layout (one directory per step):

    ckpt_dir/step_000123/
        manifest.json          tree structure, shapes, dtypes, shard map
        host0000.npz           this host's leaves (flat path keys, "//")
    ckpt_dir/step_000123.tmp_* staging dir, atomically renamed on commit
    ckpt_dir/LATEST            text file holding the last committed step

Fault-tolerance posture, as the reference's:
  * **atomic** — writes stage into a tmp dir; ``rename()`` commits. A crash
    mid-write never corrupts the previous checkpoint; LATEST is updated last.
  * **per-host shards** — each host saves its own leaves under the global
    flat paths (one process here).
  * **elastic restore** — ``load_checkpoint`` returns host tensors;
    ``restore_to_device`` puts them on the caller's device.
  * **retention** — keep the newest ``keep`` checkpoints, delete older ones
    after a successful commit (never before).

Leaves are torch tensors (any device; copied to the host as they are
written), numpy arrays or ``QuantizedKernel``s (exploded into fields by
the artifact leaf codec, as the reference's). A bf16 leaf is stored as the
reference stores one: its two raw bytes an element (the npz reads it back
as ``|V2``), with ``"bfloat16"`` in the manifest. ``load_checkpoint``
reads it back through a ``uint16`` view by the manifest's dtype, so no
``ml_dtypes`` is needed; the reference's own ``load_checkpoint`` hands
such a leaf back as ``|V2`` bytes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.artifacts.format import (QK_KEY_PREFIX, decode_quantized_kernel,
                                          dtype_name, encode_quantized_kernel)
from repro_torch.core.quantize_model import QuantizedKernel
from repro_torch.runtime import clock as rtclock

_SEP = "//"
_STEP_DIR = re.compile(r"step_(\d{8})")


def _flatten(tree: Any) -> Dict[str, Any]:
    """Nested dict tree -> {path: leaf}; QuantizedKernel explodes to fields
    via the artifact leaf codec."""
    out: Dict[str, Any] = {}

    def walk(node, path):
        if isinstance(node, QuantizedKernel):
            for key, arr in encode_quantized_kernel(node).items():
                out[f"{path}{_SEP}{key}"] = arr
            return
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}{_SEP}{k}" if path else k)
            return
        out[path] = node

    walk(tree, "")
    return out


def _unflatten(flat: Dict[str, Any]) -> Any:
    qk_groups: Dict[str, Dict[str, Any]] = {}
    plain: Dict[str, Any] = {}
    for path, leaf in flat.items():
        parts = path.split(_SEP)
        if parts[-1].startswith(QK_KEY_PREFIX):
            qk_groups.setdefault(_SEP.join(parts[:-1]), {})[parts[-1]] = leaf
        else:
            plain[path] = leaf
    for base, fields in qk_groups.items():
        plain[base] = decode_quantized_kernel(fields)

    root: Dict[str, Any] = {}
    for path, leaf in plain.items():
        parts = path.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return root


def host_array(leaf) -> Tuple[np.ndarray, str]:
    """(the array the npz stores, the manifest's dtype string) of a leaf: a
    bf16 tensor as its raw two-byte elements (``|V2``), as the reference's
    ``np.savez`` of an ml_dtypes bfloat16 array stores them."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        name = dtype_name(t)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), name
        return t.numpy(), name
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def leaf_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A host tensor of a stored leaf (an array ``np.load`` read, which the
    tensor takes over), by the manifest's dtype string (a ``|V2``
    bfloat16 leaf through a uint16 view)."""
    arr = np.require(arr, requirements=("C", "W"))
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_checkpoint(ckpt_dir: str | Path, step: int, tree: Any,
                    *, host_id: int = 0, extra: Optional[Dict] = None) -> Path:
    """Atomically write checkpoint ``step``. Returns the committed
    directory."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    stage = Path(tempfile.mkdtemp(prefix=final.name + ".tmp_", dir=ckpt_dir))
    try:
        flat = _flatten(tree)
        arrays = {}
        manifest = {"step": step, "time": rtclock.wall_now(),
                    "extra": extra or {}, "leaves": {}}
        for path, leaf in flat.items():
            arr, name = host_array(leaf)
            arrays[path] = arr
            manifest["leaves"][path] = {
                "shape": list(arr.shape), "dtype": name, "host": host_id,
            }
        np.savez(stage / f"host{host_id:04d}.npz", **arrays)
        with open(stage / "manifest.json", "w") as f:
            json.dump(manifest, f)
        if final.exists():  # overwrite-same-step: replace
            shutil.rmtree(final)
        os.rename(stage, final)
    except BaseException:
        shutil.rmtree(stage, ignore_errors=True)
        raise
    # LATEST last: readers never see a pointer to an uncommitted dir
    latest_tmp = ckpt_dir / ".LATEST.tmp"
    latest_tmp.write_text(str(step))
    os.rename(latest_tmp, ckpt_dir / "LATEST")
    return final


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    p = Path(ckpt_dir) / "LATEST"
    if not p.exists():
        return None
    return int(p.read_text().strip())


def step_dir(ckpt_dir: str | Path, step: Optional[int] = None
             ) -> Tuple[int, Path, Dict[str, Any]]:
    """(step, its directory, its manifest) of checkpoint ``step`` (None:
    the LATEST one)."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no LATEST in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    with open(d / "manifest.json") as f:
        manifest = json.load(f)
    return step, d, manifest


def load_checkpoint(ckpt_dir: str | Path, step: Optional[int] = None,
                    ) -> Tuple[int, Any, Dict]:
    """Load checkpoint ``step`` (None: LATEST) as host tensors. Returns
    (step, tree, extra); the caller puts the tree on its own device
    (``restore_to_device``)."""
    step, d, manifest = step_dir(ckpt_dir, step)
    leaves = manifest["leaves"]
    flat: Dict[str, Any] = {}
    for shard in sorted(d.glob("host*.npz")):
        with np.load(shard) as z:
            for k in z.files:
                flat[k] = leaf_tensor(z[k], leaves[k]["dtype"])
    return step, _unflatten(flat), manifest.get("extra", {})


def restore_to_device(tree_host: Any, device) -> Any:
    """Every tensor of a loaded tree on ``device`` (the reference's
    ``restore_sharded`` on one device)."""
    if isinstance(tree_host, QuantizedKernel):
        return QuantizedKernel(*(restore_to_device(getattr(tree_host, f),
                                                   device)
                                 for f in ("t1p", "t2p", "alpha")),
                               tree_host.d_in, tree_host.d_out,
                               tree_host.group_size)
    if isinstance(tree_host, dict):
        return {k: restore_to_device(v, device) for k, v in tree_host.items()}
    return tree_host.to(device)


@dataclasses.dataclass
class CheckpointManager:
    """Periodic + on-demand checkpointing with retention."""

    ckpt_dir: str
    interval_steps: int = 100
    keep: int = 3
    host_id: int = 0

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.interval_steps == 0

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> Path:
        path = save_checkpoint(self.ckpt_dir, step, tree,
                               host_id=self.host_id, extra=extra)
        self._gc()
        return path

    def restore_latest(self):
        return load_checkpoint(self.ckpt_dir)

    def _gc(self):
        root = Path(self.ckpt_dir)
        # Committed steps only: ``step_%08d`` exactly. A save killed
        # mid-write leaves its ``step_%08d.tmp_*`` staging dir behind, which
        # the reference's filter (``not name.endswith(".tmp")``) lets through
        # to ``int()``; skipping it here leaves the layout on disk as it is.
        steps = sorted(int(m.group(1)) for p in root.glob("step_*")
                       if p.is_dir()
                       and (m := _STEP_DIR.fullmatch(p.name)) is not None)
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(root / f"step_{s:08d}", ignore_errors=True)

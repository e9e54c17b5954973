"""Streaming artifact writer: quantize one kernel at a time, commit as you go
(the reference's ``repro.artifacts.writer``, same format and durability).

Durability:

  * data is appended to shard files under ``<out>.staging/``; every
    ``commit_every`` tensors (group commit) the dirty shards are fsync'd
    and then the staging manifest is atomically replaced (tmp +
    ``os.replace``): a tensor is committed iff it appears in the on-disk
    staging manifest, which only advances after the data it references is
    durable;
  * a crash mid-group leaves at worst an uncommitted tail past the last
    committed shard length; resume truncates it and re-quantizes only the
    tensors of the torn group (committed ones are skipped);
  * ``finalize()`` flushes any pending group, marks the manifest complete
    and renames the staging directory onto the final path, so readers
    never see a partial artifact.

Leaves are torch tensors on any device (each is copied to the host once,
as it is written) or numpy arrays; quantization runs on the leaf's device,
so on the card every trit step runs on the search kernel.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.artifacts import format as afmt
from repro_torch.artifacts.format import (MANIFEST_NAME, ArtifactError,
                                          align_up, buffer_record)
from repro_torch.core.quantize_model import EXCLUDE_SUBSTRINGS, QuantizedKernel
from repro_torch.runtime import clock as rtclock

ProgressFn = Callable[[Dict[str, Any]], None]


def _fsync_dir(path: Path):
    """Durably persist a directory entry (rename/replace targets)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds: best effort
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class ArtifactWriter:
    """Incremental, resumable writer for one artifact directory."""

    DEFAULT_COMMIT_EVERY = 8

    def __init__(self, out_dir: str | Path, *, arch: str,
                 model_config: Dict[str, Any], ptqtp_config: Dict[str, Any],
                 resume: bool = True, overwrite: bool = False,
                 shard_max_bytes: int = 1 << 28,
                 commit_every: Optional[int] = None):
        self.final = Path(out_dir)
        self.stage = self.final.with_name(self.final.name + ".staging")
        self.shard_max_bytes = int(shard_max_bytes)
        self.commit_every = max(1, int(commit_every
                                       if commit_every is not None
                                       else self.DEFAULT_COMMIT_EVERY))
        self._pending = 0        # tensors appended since the last commit
        self._dirty: set = set()  # shard files with unfsynced data
        # an existing artifact is only replaced at finalize(): a crash
        # mid-write never destroys the last good artifact
        self._overwrite = overwrite
        if self.final.exists() and not overwrite:
            raise ArtifactError(
                f"artifact already exists: {self.final} "
                "(pass overwrite=True / --overwrite to replace)")
        if overwrite and self.stage.exists():  # overwrite restarts cleanly
            shutil.rmtree(self.stage)

        # JSON-canonical header (tuples → lists) so a resume compares equal
        # against the manifest it reads back from disk
        header = json.loads(json.dumps({
            "format": afmt.FORMAT_NAME,
            "format_version": afmt.FORMAT_VERSION,
            "arch": arch,
            "model_config": model_config,
            "ptqtp_config": ptqtp_config,
        }))
        if resume and (self.stage / MANIFEST_NAME).exists():
            self.manifest = self._resume(header)
        else:
            if self.stage.exists():
                shutil.rmtree(self.stage)
            self.stage.mkdir(parents=True)
            self.manifest = dict(header, complete=False,
                                 created=rtclock.wall_now(), shards=[],
                                 tensors={})
            # commit the header at once, so resume can reject a staging
            # directory written with another config
            self._commit_manifest()

    # ------------------------------------------------------------- resume
    def _resume(self, header: Dict[str, Any]) -> Dict[str, Any]:
        with open(self.stage / MANIFEST_NAME) as f:
            manifest = json.load(f)
        for key, want in header.items():
            if manifest.get(key) != want:
                raise ArtifactError(
                    f"staging dir {self.stage} was written with a different "
                    f"{key!r} (have {manifest.get(key)!r}, want {want!r}); "
                    "remove it or pass overwrite=True to restart")
        # drop any torn tail past the last committed tensor: a shard's
        # nbytes only advances on commit
        for rec in manifest["shards"]:
            p = self.stage / rec["file"]
            if not p.exists() or p.stat().st_size < rec["nbytes"]:
                raise ArtifactError(
                    f"shard {p} is shorter than its committed length "
                    f"({rec['nbytes']}); staging dir is corrupt — remove it")
            os.truncate(p, rec["nbytes"])
        return manifest

    # ------------------------------------------------------------ internals
    def _shard_for(self, nbytes: int) -> Dict[str, Any]:
        """Current shard record, rolling to a new file when adding
        ``nbytes`` would push it past shard_max_bytes (tensors never split
        across shards)."""
        shards = self.manifest["shards"]
        if shards and (shards[-1]["nbytes"] + nbytes <= self.shard_max_bytes
                       or shards[-1]["nbytes"] == 0):
            return shards[-1]
        rec = {"file": f"shard_{len(shards):05d}.bin", "nbytes": 0}
        (self.stage / rec["file"]).touch()
        shards.append(rec)
        return rec

    def _append_buffers(self, arrays: Dict[str, Any]
                        ) -> Dict[str, Dict[str, Any]]:
        """Append tensors' bytes to the current shard; returns buffer
        records. The shard's nbytes advances here in memory only; it
        reaches disk with the manifest commit, after the data is fsync'd."""
        raws = {name: afmt.byte_view(a) for name, a in arrays.items()}
        total = sum(align_up(r.nbytes) for r in raws.values())
        shard = self._shard_for(total)
        records = {}
        with open(self.stage / shard["file"], "r+b") as f:
            f.seek(shard["nbytes"])
            off = shard["nbytes"]
            for name, arr in arrays.items():
                raw = raws[name]
                pad = align_up(off) - off
                if pad:
                    f.write(b"\0" * pad)
                    off += pad
                records[name] = buffer_record(shard["file"], off, arr, raw)
                f.write(raw)
                off += raw.nbytes
            f.flush()
        shard["nbytes"] = off
        self._dirty.add(shard["file"])
        return records

    def _tensor_added(self):
        """Group-commit bookkeeping: count the tensor, flush every N."""
        self._pending += 1
        if self._pending >= self.commit_every:
            self._commit_group()

    def _commit_group(self):
        """fsync the dirty shards first, then (only then) advance the
        on-disk manifest: the commit invariant resume relies on."""
        for name in sorted(self._dirty):
            fd = os.open(self.stage / name, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        self._dirty.clear()
        self._commit_manifest()
        self._pending = 0

    def _commit_manifest(self):
        tmp = self.stage / (MANIFEST_NAME + ".tmp")
        with open(tmp, "w") as f:
            json.dump(self.manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.stage / MANIFEST_NAME)
        _fsync_dir(self.stage)

    # ------------------------------------------------------------------ API
    def committed(self, path: str) -> bool:
        return path in self.manifest["tensors"]

    def add_fp(self, path: str, arr) -> None:
        """Commit one unquantized leaf (a torch tensor or numpy array)."""
        if not isinstance(arr, torch.Tensor):
            arr = np.asarray(arr)
        bufs = self._append_buffers({"data": arr})
        self.manifest["tensors"][path] = {"kind": "fp", "buffers": bufs}
        self._tensor_added()

    def add_quantized(self, path: str, qk: QuantizedKernel, *,
                      source_shape: Tuple[int, ...], source_dtype: str,
                      error: Optional[Dict[str, float]] = None) -> None:
        """Commit one quantized kernel (packed planes + scales + meta)."""
        arrays = {name: getattr(qk, name) for name in afmt.QK_BUFFERS}
        bufs = self._append_buffers(arrays)
        self.manifest["tensors"][path] = {
            "kind": "ptqtp",
            "meta": {"d_in": qk.d_in, "d_out": qk.d_out,
                     "group_size": qk.group_size},
            "source": {"shape": list(source_shape), "dtype": source_dtype},
            "error": error or {},
            "buffers": bufs,
        }
        self._tensor_added()

    def finalize(self) -> Path:
        """Compute summary stats, mark complete, atomically publish."""
        stats = {"n_tensors": 0, "n_quantized": 0, "fp_bytes": 0,
                 "quantized_bytes": 0, "quantized_weight_count": 0,
                 "source_fp16_bytes": 0}
        for rec in self.manifest["tensors"].values():
            stats["n_tensors"] += 1
            nbytes = sum(b["nbytes"] for b in rec["buffers"].values())
            if rec["kind"] == "ptqtp":
                stats["n_quantized"] += 1
                stats["quantized_bytes"] += nbytes
                n_w = int(np.prod(rec["source"]["shape"]))
                stats["quantized_weight_count"] += n_w
                stats["source_fp16_bytes"] += n_w * 2
            else:
                stats["fp_bytes"] += nbytes
        stats["total_bytes"] = stats["fp_bytes"] + stats["quantized_bytes"]
        if stats["quantized_weight_count"]:
            stats["bytes_per_weight"] = (stats["quantized_bytes"]
                                         / stats["quantized_weight_count"])
        self.manifest["stats"] = stats
        self.manifest["complete"] = True
        self.manifest["finalized"] = rtclock.wall_now()
        self._commit_group()  # flush pending tensors with the final commit
        if self.final.exists():
            if not self._overwrite:
                raise ArtifactError(
                    f"artifact appeared at {self.final} during the write "
                    "(pass overwrite=True / --overwrite to replace it)")
            shutil.rmtree(self.final)  # the old artifact survives until here
        os.rename(self.stage, self.final)
        _fsync_dir(self.final.parent)
        return self.final


# ---------------------------------------------------------------------------
# writing a model
# ---------------------------------------------------------------------------

def default_predicate(path: str, leaf: Any, group_size: int) -> bool:
    """The reference's rule, on its layout: a (..., d_in, d_out) leaf named
    ``kernel`` outside embeddings and norms, d_in divisible by G and 4."""
    if not isinstance(leaf, torch.Tensor) or not 2 <= leaf.dim() <= 4:
        return False
    lowered = path.lower()
    if any(s in lowered for s in EXCLUDE_SUBSTRINGS):
        return False
    if not lowered.endswith("kernel"):
        return False
    d_in = leaf.shape[-2]
    return d_in % group_size == 0 and d_in % 4 == 0


def quantize_kernel(kernel: torch.Tensor, cfg) -> QuantizedKernel:
    """Quantize a (..., d_in, d_out) kernel of the reference's layout on its
    device, matrix by matrix over the leading dims (scan-stacked layers,
    expert stacks), as the reference vmaps them."""
    from repro_torch.core import quantize_model

    return quantize_model.quantize_kernel(kernel.swapaxes(-1, -2), cfg)


def _rel_fro_error(kernel: torch.Tensor, qk: QuantizedKernel) -> float:
    """||W - Ŵ||_F / ||W||_F over all leading dims, in f32."""
    from repro_torch.core.quantize_model import dequantize_kernel

    d_in, d_out = kernel.shape[-2:]
    num = den = 0.0
    flat = kernel.reshape((-1, d_in, d_out))
    for i in range(flat.shape[0]):
        w = flat[i].T.to(torch.float32)
        part = QuantizedKernel(
            qk.t1p.reshape((-1,) + qk.t1p.shape[-2:])[i],
            qk.t2p.reshape((-1,) + qk.t2p.shape[-2:])[i],
            qk.alpha.reshape((-1,) + qk.alpha.shape[-3:])[i],
            qk.d_in, qk.d_out, qk.group_size)
        num += float(torch.sum((w - dequantize_kernel(part)) ** 2))
        den += float(torch.sum(w * w))
    return (num ** 0.5) / max(den ** 0.5, 1e-30)


def write_artifact(out_dir: str | Path, *, arch: str, model_cfg, ptqtp_cfg,
                   params: Any, predicate=None, compute_error: bool = True,
                   progress: Optional[ProgressFn] = None, resume: bool = True,
                   overwrite: bool = False,
                   shard_max_bytes: int = 1 << 28,
                   commit_every: Optional[int] = None) -> Path:
    """Quantize a model into an artifact, one kernel at a time.

    ``params`` is a nested-dict tree in the reference's layout (for a port
    model, ``convert.to_reference_tree(model, cfg)`` of its floating-point
    weights) walked leaf by leaf, or an iterable of ``(path, leaf)`` pairs.
    Tensors already committed in a staging manifest are skipped (resume).
    ``commit_every`` sets the fsync group-commit size (1 → per tensor,
    default ``ArtifactWriter.DEFAULT_COMMIT_EVERY``)."""
    from repro_torch.core.ptqtp import PTQTPConfig

    cfg = ptqtp_cfg or PTQTPConfig()
    predicate = predicate or default_predicate
    writer = ArtifactWriter(
        out_dir, arch=arch,
        model_config=afmt.model_config_to_json(model_cfg),
        ptqtp_config=afmt.ptqtp_config_to_json(cfg),
        resume=resume, overwrite=overwrite, shard_max_bytes=shard_max_bytes,
        commit_every=commit_every)

    leaves: Iterable[Tuple[str, Any]]
    leaves = afmt.iter_tree_leaves(params) if isinstance(params, dict) \
        else params
    t0 = rtclock.now()
    for idx, (path, leaf) in enumerate(leaves):
        info = {"index": idx, "path": path, "shape": tuple(leaf.shape),
                "elapsed": rtclock.now() - t0}
        if writer.committed(path):
            progress and progress(dict(info, action="skip"))
            continue
        if predicate(path, leaf, cfg.group_size):
            with torch.no_grad():
                qk = quantize_kernel(leaf, cfg)
                error = None
                if compute_error:
                    error = {"rel_fro_error": _rel_fro_error(leaf, qk)}
            writer.add_quantized(
                path, qk, source_shape=tuple(leaf.shape),
                source_dtype=afmt.dtype_name(leaf), error=error)
            progress and progress(dict(info, action="quantize", error=error))
        else:
            writer.add_fp(path, leaf)
            progress and progress(dict(info, action="fp"))
    return writer.finalize()


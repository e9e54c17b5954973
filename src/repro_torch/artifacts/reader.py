"""Artifact reader: memory-mapped boot of a quantized model (the reference's
``repro.artifacts.reader``, with its checks, errors and messages).

``load_artifact`` rebuilds the params tree in the reference's layout
straight off the shard files: every buffer (packed trit-planes, group
scales, the floating-point leaves) is a torch tensor viewing an
``np.memmap`` at its manifest byte offset, so no second host copy is made
on the CPU. The maps are copy-on-write: a write to a loaded tensor never
reaches the file. Given a ``device``, each buffer is instead read once into
a pinned staging buffer and copied to that device. ``load_model`` turns the
tree into the port's ``Transformer`` through ``convert.from_jax_params``.

Integrity: the manifest must be ``complete`` and of the supported format
version. ``verify`` selects how much of the data is checked before boot:

  * ``"off"`` / ``False`` — trust the bytes.
  * ``"sizes"`` — stat every shard and require its size to equal the
    manifest's byte count exactly; catches a torn copy without reading a
    tensor byte.
  * ``"full"`` / ``True`` — the sizes check plus a crc32 of every buffer. A
    mismatch raises :class:`~.format.ArtifactError` naming the tensor,
    buffer, shard file, byte range and the expected and actual crc32.

``timings`` (a dict, optional) receives the seconds of each boot phase:
``manifest_read``, ``shard_size_check``, ``mmap``, ``tensor_assemble``,
``checksum`` (the crc32 pass of ``"full"``) and, with a device,
``device_copy``.
"""

from __future__ import annotations

import json
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.artifacts import format as afmt
from repro_torch.artifacts.format import MANIFEST_NAME, ArtifactError
from repro_torch.runtime import clock as rtclock


@contextmanager
def _phase(timings: Optional[Dict[str, float]], name: str):
    t0 = rtclock.now()
    try:
        yield
    finally:
        if timings is not None:
            timings[name] = timings.get(name, 0.0) + rtclock.now() - t0


def read_manifest(artifact_dir: str | Path) -> Dict[str, Any]:
    """Load and sanity-check the manifest (no tensor data is touched)."""
    artifact_dir = Path(artifact_dir)
    p = artifact_dir / MANIFEST_NAME
    if not p.exists():
        raise ArtifactError(f"not an artifact directory (no {MANIFEST_NAME}): "
                            f"{artifact_dir}")
    with open(p) as f:
        manifest = json.load(f)
    if manifest.get("format") != afmt.FORMAT_NAME:
        raise ArtifactError(f"{p}: format {manifest.get('format')!r} is not "
                            f"{afmt.FORMAT_NAME!r}")
    if manifest.get("format_version") != afmt.FORMAT_VERSION:
        raise ArtifactError(
            f"{p}: format_version {manifest.get('format_version')} != "
            f"supported {afmt.FORMAT_VERSION}")
    if not manifest.get("complete"):
        raise ArtifactError(
            f"{artifact_dir} is incomplete (interrupted write or torn copy); "
            "re-run the quantize CLI to finish it")
    return manifest


def _buffer_bytes(mm: np.memmap, rec: Dict[str, Any], where: str
                  ) -> np.ndarray:
    end = rec["offset"] + rec["nbytes"]
    if end > mm.shape[0]:
        raise ArtifactError(f"{where}: buffer [{rec['offset']}, {end}) "
                            f"exceeds shard size {mm.shape[0]}")
    return mm[rec["offset"]:end]


def _as_tensor(raw: torch.Tensor, rec: Dict[str, Any]) -> torch.Tensor:
    """uint8 bytes -> the buffer's dtype and shape (no copy)."""
    return raw.view(afmt.torch_dtype(rec["dtype"])).reshape(rec["shape"])


VERIFY_MODES = ("off", "sizes", "full")


def _verify_mode(verify: Union[bool, str, None]) -> str:
    if verify is True:
        return "full"
    if verify is False or verify is None:
        return "off"
    if verify in VERIFY_MODES:
        return verify
    raise ValueError(f"verify must be a bool or one of {VERIFY_MODES}, "
                     f"got {verify!r}")


def check_shard_sizes(artifact_dir: str | Path,
                      manifest: Dict[str, Any]) -> None:
    """The ``verify="sizes"`` pass: every shard file must exist with exactly
    its committed byte count. Reads no tensor bytes."""
    artifact_dir = Path(artifact_dir)
    for shard in manifest["shards"]:
        p = artifact_dir / shard["file"]
        if not p.exists():
            raise ArtifactError(f"shard {p} is missing "
                                f"(manifest commits {shard['nbytes']} bytes)")
        size = p.stat().st_size
        if size != shard["nbytes"]:
            what = "truncated" if size < shard["nbytes"] else "oversized"
            raise ArtifactError(
                f"shard {p} is {what}: {size} bytes on disk vs "
                f"{shard['nbytes']} committed in the manifest — torn copy "
                "or partial download; re-fetch or re-quantize the artifact")


def load_artifact(artifact_dir: str | Path, *,
                  verify: Union[bool, str] = False,
                  device: Union[str, torch.device, None] = None,
                  timings: Optional[Dict[str, float]] = None
                  ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """-> (params_tree, manifest) in the reference's layout: quantized
    kernels are ``QuantizedKernel`` leaves, the rest tensors.

    ``device=None`` gives CPU tensors viewing the shard maps; a device
    gives tensors on it (each buffer staged once in pinned host memory when
    the device is a GPU). ``verify`` and ``timings``: see the module
    docstring."""
    artifact_dir = Path(artifact_dir)
    mode = _verify_mode(verify)
    with _phase(timings, "manifest_read"):
        manifest = read_manifest(artifact_dir)
    if mode in ("sizes", "full"):
        with _phase(timings, "shard_size_check"):
            check_shard_sizes(artifact_dir, manifest)
    mmaps: Dict[str, np.memmap] = {}
    with _phase(timings, "mmap"):
        for shard in manifest["shards"]:
            p = artifact_dir / shard["file"]
            if not p.exists() or p.stat().st_size < shard["nbytes"]:
                raise ArtifactError(f"shard {p} missing or truncated "
                                    f"(need {shard['nbytes']} bytes)")
            if shard["nbytes"]:
                mmaps[shard["file"]] = np.memmap(p, dtype=np.uint8, mode="c")

    views: Dict[str, Dict[str, np.ndarray]] = {}
    crc_s = 0.0
    with _phase(timings, "tensor_assemble"):
        for path, rec in manifest["tensors"].items():
            views[path] = {}
            for name, buf in rec["buffers"].items():
                raw = _buffer_bytes(mmaps[buf["shard"]], buf,
                                    f"{path}:{name}")
                if mode == "full":
                    t0 = rtclock.now()
                    actual = afmt.checksum(raw)
                    crc_s += rtclock.now() - t0
                    if actual != buf["crc32"]:
                        end = buf["offset"] + buf["nbytes"]
                        raise ArtifactError(
                            f"checksum mismatch for tensor {path!r} buffer "
                            f"{name!r}: shard {artifact_dir / buf['shard']} "
                            f"bytes [{buf['offset']}, {end}) expected "
                            f"crc32 {buf['crc32']:#010x}, got {actual:#010x} "
                            "— artifact is corrupt; re-run the quantize CLI "
                            "with --overwrite")
                views[path][name] = raw
    if timings is not None and mode == "full":
        timings["tensor_assemble"] -= crc_s
        timings["checksum"] = crc_s
    dev = torch.device(device) if device is not None else None
    with _phase(timings, "device_copy" if dev is not None
                else "tensor_assemble"):
        tensors = _to_tensors(manifest, views, dev)
    flat: Dict[str, Any] = {}
    for path, rec in manifest["tensors"].items():
        bufs = tensors[path]
        if rec["kind"] == "ptqtp":
            m = rec["meta"]
            fields = {f"{afmt.QK_KEY_PREFIX}{k}": v for k, v in bufs.items()}
            fields[afmt.QK_META_KEY] = np.asarray(
                [m["d_in"], m["d_out"], m["group_size"]], np.int64)
            flat[path] = afmt.decode_quantized_kernel(fields)
        else:
            flat[path] = bufs["data"]
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return afmt.unflatten_paths(flat), manifest


def _to_tensors(manifest, views, dev) -> Dict[str, Dict[str, torch.Tensor]]:
    """Buffer bytes -> typed tensors: views of the maps on the CPU, or one
    pass through a pinned staging buffer to the device."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    stage = None
    if dev is not None and dev.type == "cuda":
        biggest = max((b["nbytes"] for r in manifest["tensors"].values()
                       for b in r["buffers"].values()), default=0)
        stage = torch.empty((max(biggest, 1),), dtype=torch.uint8,
                            pin_memory=True)
    for path, rec in manifest["tensors"].items():
        out[path] = {}
        for name, buf in rec["buffers"].items():
            raw = torch.from_numpy(views[path][name])
            if stage is not None:
                n = buf["nbytes"]
                stage[:n].copy_(raw)
                raw = stage[:n].to(dev)  # pinned -> device, synchronous
            out[path][name] = _as_tensor(raw, buf)
    return out


def load_model_config(manifest: Dict[str, Any]):
    """The port's ModelConfig the artifact's params were built for."""
    return afmt.model_config_from_json(manifest["model_config"])


def verify_artifact(artifact_dir: str | Path,
                    mode: str = "full") -> Dict[str, Any]:
    """Standalone integrity pass (``"full"`` or the stat-only ``"sizes"``);
    returns the manifest stats on success."""
    if _verify_mode(mode) == "off":
        raise ValueError('verify_artifact mode must be "sizes" or "full"')
    _, manifest = load_artifact(artifact_dir, verify=mode)
    return manifest.get("stats", {})


def load_model(artifact_dir: str | Path, *,
               verify: Union[bool, str] = False, device="cuda",
               timings: Optional[Dict[str, float]] = None):
    """-> (Transformer, ModelConfig, manifest): the artifact served by the
    port, its tensors on ``device`` (no floating-point weights are built
    for quantized layers beyond the empty model, and nothing is
    re-quantized). ``timings`` also receives ``model_build``."""
    from repro_torch.convert import from_jax_params
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    tree, manifest = load_artifact(artifact_dir, verify=verify, device=dev,
                                   timings=timings)
    cfg = load_model_config(manifest)
    with _phase(timings, "model_build"):
        model = from_jax_params(tree, cfg, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return model, cfg, manifest

"""Trit-plane artifact store: quantize once, serve many (the reference's
``repro.artifacts``, same format: either package reads what the other
writes).

The deployable unit of a PTQTP model is a **versioned artifact directory**.
A server boots from it with ``np.memmap`` (no floating-point weights, no
re-quantization), and the streaming writer produces it one kernel at a
time.

Directory layout::

    artifact/
        manifest.json       the contract (schema below)
        shard_00000.bin     raw little-endian tensor bytes, 64-byte aligned
        shard_00001.bin     ... (rolled at shard_max_bytes boundaries)

**Manifest schema (stable contract, format_version 1).** Top-level keys:

  ``format``          literal ``"ptqtp-artifact"``
  ``format_version``  integer; readers must reject other versions
  ``complete``        bool; writers only publish ``true`` (atomic rename)
  ``arch``            architecture identifier (the ``configs`` registry
                      key for registry models; informational — readers
                      rebuild the model from ``model_config``)
  ``model_config``    ``ModelConfig`` as JSON (``dataclasses.asdict``)
  ``ptqtp_config``    ``PTQTPConfig`` as JSON
  ``shards``          ``[{"file", "nbytes"}]`` in creation order
  ``tensors``         ``{tree_path: record}`` — tree_path is the params-tree
                      path in the reference's layout
                      (``/blocks/b0/attn/wq/kernel``); record is either

                      * ``kind="fp"``: ``buffers={"data": buf}`` — an
                        unquantized leaf (norms, embeddings, biases, ...);
                      * ``kind="ptqtp"``: ``buffers={"t1p","t2p","alpha"}``
                        (packed uint8 trit-planes + group scales),
                        ``meta={"d_in","d_out","group_size"}``,
                        ``source={"shape","dtype"}`` of the FP kernel, and
                        ``error={"rel_fro_error"}`` — the progressive
                        search's relative Frobenius approximation error;

                      every ``buf`` is ``{"shard", "offset", "nbytes",
                      "shape", "dtype", "crc32"}``
  ``stats``           aggregate byte/tensor counts (``bytes_per_weight`` is
                      the on-disk quantized bytes per source weight)

Compatibility rules: additions land as new optional keys; any change to the
meaning of existing keys or to the shard byte layout bumps
``format_version``.
"""

from repro_torch.artifacts.format import ArtifactError
from repro_torch.artifacts.reader import (VERIFY_MODES, check_shard_sizes,
                                          load_artifact, load_model,
                                          load_model_config, read_manifest,
                                          verify_artifact)
from repro_torch.artifacts.writer import ArtifactWriter, write_artifact

__all__ = [
    "ArtifactError", "ArtifactWriter", "VERIFY_MODES", "check_shard_sizes",
    "load_artifact", "load_model", "load_model_config", "read_manifest",
    "verify_artifact", "write_artifact",
]

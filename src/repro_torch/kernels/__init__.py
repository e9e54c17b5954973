"""Hand-written Hopper kernels, each beside its plain PyTorch version.

``ternary_matmul`` (decode matvec + prefill tiled kernel),
``chunk_attention`` (ring and paged), ``rms_norm`` (alone, and fused with
the residual add before it: ``add_rms_norm``; both with a backward kernel
for training), ``ptqtp_search`` (the
quantizer's trit step), ``decode_attention`` (its op only), and the
recurrences ``rglru_scan`` and ``wkv6``. CUDA
sources live under each package's ``csrc/`` and build at first use
(``_build``); ``launch_counts`` reads the per-kernel launch counters.
"""

from repro_torch.kernels._build import launch_counts, reset_launch_counts

__all__ = ["launch_counts", "reset_launch_counts"]

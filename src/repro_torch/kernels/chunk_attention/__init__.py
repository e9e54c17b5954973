from repro_torch.kernels.chunk_attention.ops import (
    BACKENDS, chunk_attention, chunk_attention_cuda, chunk_attention_paged,
    chunk_attention_paged_cuda, paged_tile, peak_tracked_bytes,
    reset_tracking, tracked_block_bytes)

__all__ = ["BACKENDS", "chunk_attention", "chunk_attention_cuda",
           "chunk_attention_paged", "chunk_attention_paged_cuda",
           "paged_tile", "peak_tracked_bytes", "reset_tracking",
           "tracked_block_bytes"]

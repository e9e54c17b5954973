from repro_torch.kernels.chunk_attention.ops import (
    chunk_attention, chunk_attention_cuda, chunk_attention_paged,
    chunk_attention_paged_cuda)

__all__ = ["chunk_attention", "chunk_attention_cuda", "chunk_attention_paged",
           "chunk_attention_paged_cuda"]

"""The optimizer and gradient compression (the reference's ``repro.optim``,
over flat lists of tensors: ``list(model.parameters())`` and their
gradients, in that order)."""

from repro_torch.optim.adamw import AdamW, cosine_schedule, global_norm
from repro_torch.optim.compress import compress_decompress, init_error_feedback

__all__ = ["AdamW", "compress_decompress", "cosine_schedule", "global_norm",
           "init_error_feedback"]

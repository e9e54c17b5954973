from repro_torch.kernels.rms_norm.ops import (add_rms_norm, add_rms_norm_cuda,
                                              rms_norm, rms_norm_cuda)

__all__ = ["add_rms_norm", "add_rms_norm_cuda", "rms_norm", "rms_norm_cuda"]

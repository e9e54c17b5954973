from repro_torch.kernels.rms_norm.ops import rms_norm, rms_norm_cuda

__all__ = ["rms_norm", "rms_norm_cuda"]

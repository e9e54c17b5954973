from repro_torch.kernels.wkv6.ops import wkv6, wkv6_backward_cuda, wkv6_cuda

__all__ = ["wkv6", "wkv6_backward_cuda", "wkv6_cuda"]

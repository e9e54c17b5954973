from repro_torch.kernels.rglru_scan.ops import rglru_scan, rglru_scan_cuda

__all__ = ["rglru_scan", "rglru_scan_cuda"]

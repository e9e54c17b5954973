from repro_torch.kernels.rglru_scan.ops import (rglru_gated_scan,
                                                rglru_gated_scan_cuda,
                                                rglru_scan, rglru_scan_cuda)

__all__ = ["rglru_gated_scan", "rglru_gated_scan_cuda", "rglru_scan",
           "rglru_scan_cuda"]

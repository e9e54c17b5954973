from repro_torch.kernels.ternary_matmul.ops import (SMALL_M_THRESHOLD,
                                                   ternary_matmul,
                                                   ternary_matmul_experts,
                                                   ternary_matmul_tiled,
                                                   ternary_matvec)

__all__ = ["SMALL_M_THRESHOLD", "ternary_matmul", "ternary_matmul_experts",
           "ternary_matmul_tiled", "ternary_matvec"]

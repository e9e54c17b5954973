from repro_torch.kernels.ptqtp_search.ops import (ptqtp_search,
                                                  ptqtp_search_cuda)

__all__ = ["ptqtp_search", "ptqtp_search_cuda"]

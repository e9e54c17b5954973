"""Baseline PTQ methods the paper compares PTQTP against (Table 1/2,
Fig. 1), as the reference package has them (``repro.core.baselines``).

Every baseline is ``quantize(w, ...) -> (w_hat, meta)``: the dequantized
approximation (for quality comparisons) and its bookkeeping, plain
functions on tensors that run on the weight's device.
"""

from repro_torch.core.baselines.awq import awq_quantize
from repro_torch.core.baselines.billm import billm_quantize
from repro_torch.core.baselines.gptq import gptq_quantize
from repro_torch.core.baselines.rtn import rtn_quantize

__all__ = ["rtn_quantize", "gptq_quantize", "awq_quantize", "billm_quantize"]

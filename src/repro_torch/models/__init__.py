from repro_torch.models.transformer import (Transformer, decode_step, forward,
                                            init_decode_state, init_params,
                                            prefill_chunk)

__all__ = ["Transformer", "decode_step", "forward", "init_decode_state",
           "init_params", "prefill_chunk"]

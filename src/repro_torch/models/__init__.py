from repro_torch.models.transformer import (Transformer, decode_step, forward,
                                            init_decode_state, init_params,
                                            loss_fn, prefill, prefill_chunk,
                                            reset_decode_state)

__all__ = ["Transformer", "decode_step", "forward", "init_decode_state",
           "init_params", "loss_fn", "prefill", "prefill_chunk",
           "reset_decode_state"]

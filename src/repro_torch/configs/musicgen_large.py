"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

Backbone only: the EnCodec frontend is a stub — ``input_specs`` provides
precomputed frame embeddings (B, S, d_model); the decoder predicts codebook
tokens over a 2048-entry vocabulary.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    mlp_type="gelu",
    embed_inputs=False,           # stub frontend feeds frame embeddings
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512,
    param_dtype="float32", activation_dtype="float32", remat="none", q_chunk=16,
)

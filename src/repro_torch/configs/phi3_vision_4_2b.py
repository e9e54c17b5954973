"""phi-3-vision-4.2b — phi3-mini backbone + CLIP stub
[hf:microsoft/Phi-3-vision-128k-instruct; hf].

Backbone only: the CLIP vision tower is a stub — ``input_specs`` provides
precomputed patch/text embeddings (B, S, d_model).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    embed_inputs=False,           # stub CLIP frontend feeds embeddings
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512,
    param_dtype="float32", activation_dtype="float32", remat="none", q_chunk=16,
)

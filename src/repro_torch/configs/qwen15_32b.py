"""qwen1.5-32b — dense MHA (kv=40) with QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    microbatches=4,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512,
    param_dtype="float32", activation_dtype="float32", remat="none",
    q_chunk=16, microbatches=1,
)

"""llama3-405b — dense GQA (kv=8), 128k vocab [arXiv:2407.21783; unverified]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=5e5,
    microbatches=16,              # activation memory: 256×4k tokens → 16 chunks
    optimizer_dtype="bfloat16",   # adam moments in bf16 so 405B fits 256 chips
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128, vocab_size=512,
    param_dtype="float32", activation_dtype="float32", remat="none",
    q_chunk=16, microbatches=1, optimizer_dtype="float32",
)

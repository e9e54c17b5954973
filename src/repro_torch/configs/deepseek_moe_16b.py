"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed top-6
[arXiv:2401.06066; hf]. First layer is a dense FFN (d_ff=10944), the
remaining 27 layers are MoE with per-expert hidden 1408.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,                        # dense first layer (paper Table 1)
    vocab_size=102400,
    prefix_pattern=("attn+mlp",),      # layer 0 dense
    block_pattern=("attn+moe",),
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                  capacity_factor=1.25),
)

SMOKE = CONFIG.scaled(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=1,
                  capacity_factor=-1.0),
    param_dtype="float32", activation_dtype="float32", remat="none", q_chunk=16,
)

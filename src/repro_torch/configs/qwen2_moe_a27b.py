"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

60 % 16 != 0 → experts are NOT EP-sharded on the 16-way model axis; the
expert FFN dim (1408) is sharded instead (expert-TP fallback, DESIGN.md §5).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=0,
    vocab_size=151_936, qkv_bias=True,
    n_experts=60, n_shared_experts=4, experts_per_token=4, d_ff_expert=1408,
    source="[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]",
)

SMOKE = CONFIG.replace(name="qwen2-moe-smoke", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=4, vocab_size=128, n_experts=6,
                       experts_per_token=2, d_ff_expert=32,
                       n_shared_experts=2, dtype="float32")

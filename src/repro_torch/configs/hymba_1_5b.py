"""hymba-1.5b [hybrid] — parallel attn+mamba heads [arXiv:2411.13676; hf].

25 heads × head_dim 64 = 1600; sliding-window attention everywhere except 3
full-attention layers (first / middle / last, per the Hymba paper); the SSM
half runs in parallel within each block.  Meta-tokens are not modeled
(DESIGN.md §5).  vocab 32001 → padded 32016.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab_size=32_001, head_dim=64, ssm_state=16, d_inner=3200,
    sliding_window=1024, global_attn_layers=(0, 15, 31),
    source="[arXiv:2411.13676; hf]",
)

SMOKE = CONFIG.replace(name="hymba-smoke", n_layers=3, d_model=64, n_heads=4,
                       n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
                       d_inner=128, ssm_state=4, sliding_window=8,
                       global_attn_layers=(0, 2), dtype="float32")

"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table) [arXiv:2501.kimi2; unverified].

384 routed experts top-8 + 1 shared (DeepSeek-V3-style); at this scale the
config enables FSDP + bf16 optimizer moments (see DESIGN.md §8).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=0,
    vocab_size=163_840,
    n_experts=384, n_shared_experts=1, experts_per_token=8, d_ff_expert=2048,
    fsdp=True, opt_dtype="bfloat16", loss_chunk=2048,
    source="[arXiv:2501.kimi2; unverified]",
)

SMOKE = CONFIG.replace(name="kimi-k2-smoke", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, vocab_size=128, n_experts=8,
                       experts_per_token=2, d_ff_expert=32,
                       opt_dtype="float32", dtype="float32")

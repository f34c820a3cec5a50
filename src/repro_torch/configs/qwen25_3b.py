"""qwen2.5-3b [dense] — GQA kv=2, QKV bias [hf:Qwen/Qwen2.5-0.5B; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, d_ff=11_008,
    vocab_size=151_936, qkv_bias=True,
    source="[hf:Qwen/Qwen2.5-0.5B; hf]",
)

SMOKE = CONFIG.replace(name="qwen2.5-smoke", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                       dtype="float32")

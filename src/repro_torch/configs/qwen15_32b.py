"""qwen1.5-32b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B; hf] (per-assignment dims)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, d_ff=27_392,
    vocab_size=152_064, qkv_bias=True,
    source="[hf:Qwen/Qwen1.5-0.5B; hf]",
)

SMOKE = CONFIG.replace(name="qwen1.5-smoke", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=128,
                       dtype="float32")

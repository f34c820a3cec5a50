"""In-house ~100M-param llama-style config for the end-to-end training run
(and a ~10M variant that a CPU-only example can actually step)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="repro-100m", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
    vocab_size=32_000, tie_embeddings=True,
    source="[in-house; e2e driver]",
)

SMOKE = CONFIG.replace(name="repro-10m", n_layers=4, d_model=256, n_heads=4,
                       n_kv_heads=2, d_ff=704, vocab_size=4096,
                       dtype="float32")

"""gemma-2b [dense] — GeGLU, head_dim=256, MQA [arXiv:2403.08295; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16_384,
    vocab_size=256_000, head_dim=256, mlp_act="geglu", tie_embeddings=True,
    source="[arXiv:2403.08295; hf]",
)

SMOKE = CONFIG.replace(name="gemma-smoke", n_layers=2, d_model=64, n_heads=4,
                       n_kv_heads=1, head_dim=32, d_ff=128, vocab_size=128,
                       dtype="float32")

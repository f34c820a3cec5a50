"""minicpm-2b [dense] — llama-like, WSD schedule [arXiv:2404.06395; hf].

vocab 122753 is padded to 122768 (multiple of 16) for the model axis.
The WSD (warmup-stable-decay) schedule is selected by the training launcher via
``schedule="wsd"`` for this arch.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_ff=5760,
    vocab_size=122_753, tie_embeddings=True,
    source="[arXiv:2404.06395; hf]",
)

SMOKE = CONFIG.replace(name="minicpm-smoke", n_layers=2, d_model=72,
                       n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=127,
                       dtype="float32")

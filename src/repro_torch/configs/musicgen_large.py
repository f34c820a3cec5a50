"""musicgen-large [audio] — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

4 parallel codebook streams (vocab 2048 each) with summed embeddings and one
LM head per codebook; sinusoidal positions; classic (non-gated) GELU FFN.
The EnCodec tokenizer + delay-pattern scheduling is a frontend STUB —
``input_specs()`` supplies the (B, L, 4) code streams directly.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=2048, n_codebooks=4, pos_embed="sinusoidal", mlp_act="gelu",
    source="[arXiv:2306.05284; hf]",
)

SMOKE = CONFIG.replace(name="musicgen-smoke", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=64,
                       dtype="float32")

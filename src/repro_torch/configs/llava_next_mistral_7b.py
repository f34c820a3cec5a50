"""llava-next-mistral-7b [vlm] — anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

Backbone-only per the assignment: the vision tower + anyres tiling is a
frontend STUB — ``input_specs()`` supplies 2304 precomputed patch embeddings
(base 576 + 3 tiles of 576, projected to d_model) prepended to the text.
Mistral backbone modeled v0.2-style (full 32k attention) → long_500k skipped.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14_336,
    vocab_size=32_000, vision_tokens=2304,
    source="[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]",
)

SMOKE = CONFIG.replace(name="llava-smoke", n_layers=2, d_model=64, n_heads=4,
                       n_kv_heads=2, d_ff=128, vocab_size=128,
                       vision_tokens=4, dtype="float32")

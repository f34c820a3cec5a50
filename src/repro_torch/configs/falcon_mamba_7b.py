"""falcon-mamba-7b [ssm] — Mamba-1, attention-free [arXiv:2410.05355; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=65024, ssm_state=16, d_inner=8192, ssm_conv=4,
    pos_embed="none",
    source="[arXiv:2410.05355; unverified]",
)

SMOKE = CONFIG.replace(name="falcon-mamba-smoke", n_layers=2, d_model=64,
                       d_inner=128, ssm_state=4, vocab_size=128,
                       dtype="float32")

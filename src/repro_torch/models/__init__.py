"""The language model of the port (dense, moe, ssm, hybrid, vlm and audio
families): layers, attention, Mamba, MoE, blocks and the LM, for serving
and training."""
from .layers import cross_entropy_chunked
from .lm import (LM, DecodeState, compute_logits, decode_step, embed_tokens,
                 forward_hidden, gathered_logits_fn, init_decode_state,
                 init_params, layer_windows, lm_loss, prefill)

__all__ = ["LM", "DecodeState", "compute_logits", "cross_entropy_chunked",
           "decode_step", "embed_tokens", "forward_hidden",
           "gathered_logits_fn", "init_decode_state", "init_params",
           "layer_windows", "lm_loss", "prefill"]

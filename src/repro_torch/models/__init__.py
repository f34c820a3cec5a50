"""The language-model serving path of the port (dense, ssm and hybrid
families): layers, attention, Mamba, blocks and the LM."""
from .lm import (LM, DecodeState, compute_logits, decode_step, embed_tokens,
                 forward_hidden, init_decode_state, init_params,
                 layer_windows, prefill)

__all__ = ["LM", "DecodeState", "compute_logits", "decode_step",
           "embed_tokens", "forward_hidden", "init_decode_state",
           "init_params", "layer_windows", "prefill"]

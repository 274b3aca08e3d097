"""flash_attention kernel family: online-softmax attention with causal and
sliding-window masks (prefill of the transformer models)."""

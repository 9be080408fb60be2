"""The LM serving path of the port (counterpart of ``repro.models``):
decoder-only transformers (dense GQA, MoE, MLA), prefill through the
hand-written flash-attention kernel and KV-cache decode."""

"""The LM serving path of the port (counterpart of ``repro.models``):
dense GQA decoder-only transformers, prefill through the hand-written
flash-attention kernel and KV-cache decode."""

"""The LM of the port (counterpart of ``repro.models``): decoder-only
transformers (dense GQA, MoE, MLA), attention through the hand-written
flash kernel (its gradient in plain PyTorch), the training loss,
prefill and KV-cache decode."""

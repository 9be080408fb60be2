"""Training utilities of the port (counterpart of ``repro.train``):
AdamW with float32 master weights and gradient compression."""

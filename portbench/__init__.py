"""The benchmark of the PyTorch and CUDA port of SSH (``repro_torch``)."""

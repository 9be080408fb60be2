"""The ``"ssh"`` encoder: sketch -> shingle -> CWS signature."""
from repro_torch.encoders.base import IndexSpec
from repro_torch.encoders.pipeline import SSHEncoder

__all__ = ["IndexSpec", "SSHEncoder"]

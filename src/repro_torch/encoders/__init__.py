"""Encoders: sketch -> shingle -> CWS signature (``"ssh"``; the
count-sketch ``"ssh-cs"`` lives in ``repro_torch.streaming``)."""
from repro_torch.encoders.base import IndexSpec
from repro_torch.encoders.pipeline import SSHEncoder
from repro_torch.encoders.registry import encoder_class, make_encoder

__all__ = ["IndexSpec", "SSHEncoder", "encoder_class", "make_encoder"]

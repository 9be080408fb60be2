"""Encoders: sketch -> shingle -> CWS signature (``"ssh"``,
``"ssh-multires"``), signed random projections (``"srp"``); the
count-sketch ``"ssh-cs"`` lives in ``repro_torch.streaming``."""
from repro_torch.encoders.base import Encoder, IndexSpec
from repro_torch.encoders.pipeline import MultiResSSHEncoder, SSHEncoder
from repro_torch.encoders.registry import (available_encoders,
                                           encoder_class, make_encoder,
                                           register_encoder)

__all__ = ["Encoder", "IndexSpec", "MultiResSSHEncoder", "SSHEncoder",
           "available_encoders", "encoder_class", "make_encoder",
           "register_encoder"]

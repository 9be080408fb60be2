"""Encoders: sketch -> shingle -> CWS signature (``"ssh"``,
``"ssh-multires"``), signed random projections (``"srp"``); the
count-sketch ``"ssh-cs"`` lives in ``repro_torch.streaming``."""
from repro_torch.encoders.base import (Encoder, Hasher, IndexSpec, Shingler,
                                       Sketcher)
from repro_torch.encoders.pipeline import (CWSHasher, GaussianFilterSketcher,
                                           MultiResShingler,
                                           MultiResSSHEncoder, NgramShingler,
                                           PipelineEncoder, SSHEncoder)
from repro_torch.encoders.registry import (available_encoders,
                                           encoder_class, make_encoder,
                                           register_encoder)

__all__ = ["CWSHasher", "Encoder", "GaussianFilterSketcher", "Hasher",
           "IndexSpec", "MultiResSSHEncoder", "MultiResShingler",
           "NgramShingler", "PipelineEncoder", "SSHEncoder", "Shingler",
           "Sketcher", "available_encoders", "encoder_class",
           "make_encoder", "register_encoder"]

"""``"srp"`` — signed random projections behind the one facade
(counterpart of ``repro.encoders.srp``).

The signature is the K sign bits of the series against K random planes;
the probe counts agreeing bits with the collision-count kernels, as it
counts agreeing CWS hashes for ``"ssh"`` (the ranking of the reference's
Hamming similarity: an agreement count is K times the fraction).  The
planes are (m, K), sized to the series length, so ``materialize`` needs
``length`` and ``load_state`` takes it from the planes.  SRP has no
shift-alignment classes: multiprobe raises, and the facade folds
``multiprobe_offsets`` to 1.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import srp
from repro_torch.encoders.base import Encoder, IndexSpec
from repro_torch.encoders.registry import register_encoder
from repro_torch.kernels import ops


@register_encoder("srp")
class SRPEncoder(Encoder):
    """Params: ``num_hashes`` (K sign bits), ``num_tables`` (L bands);
    defaults K=64, L=16 as the reference's."""

    DEFAULTS = dict(num_hashes=64, num_tables=16)

    def __init__(self, spec: IndexSpec):
        super().__init__(spec)
        p = {**self.DEFAULTS, **spec.params}
        self.num_hashes, self.num_tables = p["num_hashes"], p["num_tables"]
        self.length: Optional[int] = None

    @classmethod
    def validate_params(cls, spec: IndexSpec) -> None:
        cls._check_param_names(spec, cls.DEFAULTS)
        p = {**cls.DEFAULTS, **spec.params}
        if p["num_hashes"] % p["num_tables"]:
            raise ValueError("num_hashes must be divisible by num_tables")

    def materialize(self, device=None, length: Optional[int] = None
                    ) -> "SRPEncoder":
        """Draw the (length, K) planes (idempotent) on the CPU from a
        generator seeded by ``spec.seed``, then move them to ``device``
        (CUDA unless the caller asks for the CPU)."""
        if self._state is None:
            if length is None:
                raise ValueError(
                    "the 'srp' encoder's planes are sized to the series "
                    "length; pass length= (make_encoder forwards it)")
            dev = ops.resolve_device(device)
            gen = torch.Generator().manual_seed(self.spec.seed)
            self.load_state({"planes": srp.make_srp(
                self.num_hashes, int(length), gen).to(dev)})
        return self

    def expected_shapes(self) -> Dict[str, Tuple[Optional[int], ...]]:
        return {"planes": (self.length, self.num_hashes)}

    def _adopt(self) -> None:
        self.length = int(self._state["planes"].shape[0])

    def encode_batch(self, xs: torch.Tensor, *, backend: str = "auto"
                     ) -> torch.Tensor:
        """(B, m) -> (B, K) int32 sign bits."""
        self.check_backend(backend)
        return self.pure_encode_fn()(xs, self._require_state())

    def pure_encode_fn(self):
        """``fn(x, state)``: the sign bits against ``state["planes"]``,
        (m,) -> (K,) or (R, m) -> (R, K) int32 (``srp.py:114-117``)."""
        def encode(x: torch.Tensor, state) -> torch.Tensor:
            planes = state["planes"]
            x = x.to(device=planes.device, dtype=torch.float32)
            return srp.srp_bits(x, planes).to(torch.int32)
        return encode

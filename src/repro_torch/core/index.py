"""SSH index — signatures, band keys, stored series and their envelopes
(counterpart of ``repro.core.index``).

Everything lives on one device: a CUDA index encodes its queries with
the ``sketch_conv`` kernel and probes with ``collision_count_batch``; a
CPU index runs the plain versions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import lower_bounds as lb
from repro_torch.encoders import IndexSpec, SSHEncoder
from repro_torch.kernels import ops


@dataclasses.dataclass
class SSHIndex:
    """An encoder plus the artifacts derived from the database.

    ``env_upper``/``env_lower`` cache the Sakoe-Chiba envelopes of every
    series at ``env_radius``, which makes the cascade's LB_Keogh2 a
    gather and compare.  ``build_backend`` records the route that encoded
    the signatures ("cuda": the ``sketch_conv`` kernel, "cpu": its plain
    version); signature identity is fixed at build time
    (``repro/core/index.py:278-283``), and queries encode on the index's
    own device.
    """
    encoder: SSHEncoder
    signatures: torch.Tensor           # (N, K) int32
    keys: torch.Tensor                 # (N, L) int32 (uint32 bit pattern)
    series: torch.Tensor               # (N, m) float32
    env_radius: Optional[int] = None
    env_upper: Optional[torch.Tensor] = None
    env_lower: Optional[torch.Tensor] = None
    build_backend: str = "cuda"

    @classmethod
    def build(cls, series, spec: IndexSpec, *, device=None) -> "SSHIndex":
        """Paper Alg. 1: encode every series and fold band keys.  Runs on
        CUDA unless ``device="cpu"``."""
        dev = ops.resolve_device(device)
        series = torch.as_tensor(series, dtype=torch.float32).to(dev)
        enc = SSHEncoder(spec).materialize(dev)
        sigs = enc.encode_chunked(series)
        return cls(encoder=enc, signatures=sigs, keys=enc.band_keys(sigs),
                   series=series, build_backend=dev.type)

    @property
    def device(self) -> torch.device:
        return self.series.device

    @property
    def num_tables(self) -> int:
        return self.encoder.num_tables

    def candidate_envelopes(self, radius: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(upper, lower) envelopes of every series at ``radius``; cached,
        recomputed when the radius changes.  Chunks of 65536 rows bound
        the pooling temporaries."""
        n, chunk = int(self.series.shape[0]), 65536
        stale = (self.env_radius != radius or self.env_upper is None
                 or int(self.env_upper.shape[0]) != n)
        if stale:
            ups, los = zip(*(lb.envelope(self.series[lo:lo + chunk], radius)
                             for lo in range(0, n, chunk)))
            self.env_upper, self.env_lower = torch.cat(ups), torch.cat(los)
            self.env_radius = radius
        return self.env_upper, self.env_lower

    def query_signatures_batch(self, qs: torch.Tensor) -> torch.Tensor:
        """(B, m) query block -> (B, K) signatures."""
        return self.encoder.encode_batch(qs)

    def query_signatures_batch_multiprobe(self, qs: torch.Tensor,
                                          offsets: int) -> torch.Tensor:
        """(B, m) -> (B, offsets, K); offset o hashes qs[:, o:]."""
        return self.encoder.encode_batch_multiprobe(qs, offsets)

    def nbytes(self) -> int:
        """Resident bytes: artifacts plus the encoder state."""
        arrays = [self.signatures, self.keys, self.series, self.env_upper,
                  self.env_lower, *self.encoder._require_state().values()]
        return sum(a.numel() * a.element_size()
                   for a in arrays if a is not None)

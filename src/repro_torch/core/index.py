"""SSH index — signatures, band keys, stored series and their envelopes
(counterpart of ``repro.core.index``).

Everything lives on one device: a CUDA index encodes its queries with
the ``sketch_conv`` kernel (and ``cs_tables`` for ``"ssh-cs"``); a CPU
index runs the plain versions.  The single-query encodes are those of
the reference's ``query_*_cached`` without its LRU: a hit there returns
the same bits, so ids cannot differ, and ``sig_cache_hit`` stays 0.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import lower_bounds as lb
from repro_torch.encoders import IndexSpec, SSHEncoder, make_encoder
from repro_torch.kernels import ops

_ENV_CHUNK = 65536       # rows per envelope pass (bounds the pooling temps)


def _envelopes_chunked(series: torch.Tensor, radius: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    ups, los = zip(*(lb.envelope(series[lo:lo + _ENV_CHUNK], radius)
                     for lo in range(0, int(series.shape[0]), _ENV_CHUNK)))
    return torch.cat(ups), torch.cat(los)


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
    encoder: SSHEncoder                # or its subclass for "ssh-cs"
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
        enc = make_encoder(spec, dev)
        sigs = enc.encode_chunked(series)
        return cls(encoder=enc, signatures=sigs, keys=enc.band_keys(sigs),
                   series=series, build_backend=dev.type)

    @property
    def device(self) -> torch.device:
        return self.series.device

    @property
    def num_tables(self) -> int:
        return self.encoder.num_tables

    @property
    def num_hashes(self) -> int:
        return self.encoder.num_hashes

    def candidate_envelopes(self, radius: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(upper, lower) envelopes of every series at ``radius``; cached,
        recomputed when the radius changes."""
        stale = (self.env_radius != radius or self.env_upper is None
                 or int(self.env_upper.shape[0]) != int(self.series.shape[0]))
        if stale:
            self.env_upper, self.env_lower = _envelopes_chunked(self.series,
                                                                radius)
            self.env_radius = radius
        return self.env_upper, self.env_lower

    # -- single-query encodes (the sequential searcher) -------------------
    def query_signature(self, q: torch.Tensor) -> torch.Tensor:
        """(m,) -> (K,) int32 signature."""
        return self.encoder.encode_batch(q[None, :])[0]

    def query_keys(self, q: torch.Tensor) -> torch.Tensor:
        """(m,) -> (L,) int32 band keys."""
        return self.encoder.band_keys(self.query_signature(q))

    def query_signatures_multiprobe(self, q: torch.Tensor, offsets: int
                                    ) -> torch.Tensor:
        """(m,) -> (offsets, K); row o hashes q[o:]."""
        return self.encoder.encode_batch_multiprobe(q[None, :], offsets)[0]

    def query_signatures_batch(self, qs: torch.Tensor) -> torch.Tensor:
        """(B, m) query block -> (B, K) signatures."""
        return self.encoder.encode_batch(qs)

    def query_signatures_batch_multiprobe(self, qs: torch.Tensor,
                                          offsets: int) -> torch.Tensor:
        """(B, m) -> (B, offsets, K); offset o hashes qs[:, o:]."""
        return self.encoder.encode_batch_multiprobe(qs, offsets)

    # -- growth -------------------------------------------------------------
    def insert(self, series: torch.Tensor) -> None:
        """Append and encode (m,)-rows (data-independent hashing, nothing
        to retrain); the envelope cache stays aligned
        (``repro/core/index.py:417-431``)."""
        series = torch.as_tensor(series, dtype=torch.float32).to(
            self.device)
        sigs = self.encoder.encode_chunked(series)
        self.insert_encoded(series, sigs, self.encoder.band_keys(sigs))

    def insert_encoded(self, series: torch.Tensor, signatures: torch.Tensor,
                       keys: torch.Tensor) -> None:
        """Fold pre-encoded rows (a ``StreamIngestor`` fold) into the
        index with no re-hashing (``repro/core/index.py:433-469``)."""
        dev = self.device
        sigs = torch.as_tensor(signatures).to(dev, torch.int32)
        keys = torch.as_tensor(keys).to(dev, torch.int32)
        if int(sigs.shape[-1]) != self.num_hashes:
            raise ValueError(
                f"artifact signatures have K={int(sigs.shape[-1])}, "
                f"index expects K={self.num_hashes}")
        if int(keys.shape[-1]) != self.num_tables:
            raise ValueError(
                f"artifact keys have L={int(keys.shape[-1])}, "
                f"index expects L={self.num_tables}")
        if series is None:
            raise ValueError("index stores raw series for re-ranking; "
                             "artifacts must include them")
        series = torch.as_tensor(series, dtype=torch.float32).to(dev)
        self.signatures = torch.cat([self.signatures, sigs])
        self.keys = torch.cat([self.keys, keys])
        self.series = torch.cat([self.series, series])
        if self.env_radius is not None and self.env_upper is not None:
            u, l = _envelopes_chunked(series, self.env_radius)
            self.env_upper = torch.cat([self.env_upper, u])
            self.env_lower = torch.cat([self.env_lower, l])

    def nbytes(self) -> int:
        """Resident bytes: artifacts plus the encoder state."""
        arrays = [self.signatures, self.keys, self.series, self.env_upper,
                  self.env_lower, *self.encoder._require_state().values()]
        return sum(a.numel() * a.element_size()
                   for a in arrays if a is not None)

"""The ``"ssh"`` encoder: sketch -> shingle -> CWS (counterpart of
``repro.encoders.pipeline``).

Stage 1 takes the sign bits of a strided Gaussian filter-bank projection
(the ``sketch_conv`` kernel on CUDA, its plain version on the CPU),
stage 2 the n-gram shingle histogram, stage 3 a 0-bit CWS signature of K
hashes, evaluated over each row's active shingles only
(``core.minhash.cws_hash_active``).  Band keys fold the K hashes into L
bucket keys.

The random state (filter bank + CWS fields) is either drawn from a
``torch.Generator`` seeded by ``spec.seed`` — the reference's
distributions, not its numbers, since ``jax.random`` cannot be
reproduced — or carried over from the reference with
``repro_torch.convert``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import minhash, shingle, sketch
from repro_torch.encoders.base import IndexSpec
from repro_torch.kernels import ops


class SSHEncoder:
    """The paper's encoder (Fig. 5).  Params (defaults as the reference):
    ``window``, ``step``, ``ngram``, ``num_filters``, ``num_hashes``,
    ``num_tables``."""

    DEFAULTS = dict(window=80, step=3, ngram=15, num_filters=1,
                    num_hashes=20, num_tables=20)

    def __init__(self, spec: IndexSpec):
        spec.validate()
        self.spec = spec
        p = {**self.DEFAULTS, **spec.params}
        self.window, self.step, self.ngram = p["window"], p["step"], p["ngram"]
        self.num_filters = p["num_filters"]
        self.num_hashes, self.num_tables = p["num_hashes"], p["num_tables"]
        self._state: Optional[Dict[str, torch.Tensor]] = None

    @classmethod
    def validate_params(cls, spec: IndexSpec) -> None:
        unknown = sorted(set(spec.params) - set(cls.DEFAULTS))
        if unknown:
            raise ValueError(f"unknown params {unknown} for encoder "
                             f"{spec.encoder!r}; known: "
                             f"{sorted(cls.DEFAULTS)}")
        p = {**cls.DEFAULTS, **spec.params}
        if min(p["window"], p["step"], p["num_filters"]) < 1:
            raise ValueError("window, step, num_filters must be >= 1")
        if p["num_hashes"] % p["num_tables"]:
            raise ValueError("num_hashes must be divisible by num_tables")
        if p["ngram"] > 20:
            raise ValueError("shingle space 2^n exceeds 1M bins; use n<=20")

    # -- shape identity ---------------------------------------------------
    @property
    def dim(self) -> int:
        return shingle.shingle_space(self.ngram, self.num_filters)

    # -- state ------------------------------------------------------------
    def materialize(self, device=None) -> "SSHEncoder":
        """Draw the random functions (idempotent) on the CPU from a
        generator seeded by ``spec.seed``, then move them to ``device``
        (CUDA unless the caller asks for the CPU)."""
        if self._state is None:
            dev = ops.resolve_device(device)
            gen = torch.Generator().manual_seed(self.spec.seed)
            state = {"filters": sketch.make_filter(
                self.window, self.num_filters, gen)}
            cws = minhash.make_cws(self.num_hashes, self.dim, gen)
            state.update({f"cws/{f}": getattr(cws, f) for f in cws._fields})
            state.update(self._draw_extra_state(gen))
            self.load_state({k: v.to(dev) for k, v in state.items()})
        return self

    def _draw_extra_state(self, gen: torch.Generator
                          ) -> Dict[str, torch.Tensor]:
        """State leaves beyond the filter bank and the CWS fields (none
        for ``"ssh"``), drawn after them from the same generator."""
        return {}

    def extra_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Shapes of the extra leaves (``pipeline.py:386-387``)."""
        return {}

    #: extra leaves that hold integers (kept as int64, not float32)
    INT_LEAVES: Tuple[str, ...] = ()

    def expected_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Leaf names and shapes of the state (``pipeline.py:376-388``)."""
        shapes = {"filters": (self.window, self.num_filters)}
        shapes.update({f"cws/{f}": (self.num_hashes, self.dim)
                       for f in minhash.CWSParams._fields})
        shapes.update(self.extra_shapes())
        return shapes

    def load_state(self, state: Mapping[str, torch.Tensor]
                   ) -> "SSHEncoder":
        """Adopt a state dict of tensors on one device; refuses leaves or
        shapes that disagree with the spec.  Float leaves are stored as
        float32, the ``INT_LEAVES`` as int64."""
        want = self.expected_shapes()
        if set(state) != set(want):
            raise ValueError(
                f"encoder state leaves {sorted(state)} do not match "
                f"IndexSpec(encoder={self.spec.encoder!r}, "
                f"params={dict(self.spec.params)!r}): expected "
                f"{sorted(want)}")
        for name, shape in want.items():
            if tuple(state[name].shape) != shape:
                raise ValueError(f"encoder state {name!r} has shape "
                                 f"{tuple(state[name].shape)}, spec implies "
                                 f"{shape}")
        devices = {t.device for t in state.values()}
        if len(devices) != 1:
            raise ValueError(f"encoder state spans devices {devices}")
        self._state = {
            k: v.to(torch.int64 if k in self.INT_LEAVES
                    else torch.float32).contiguous()
            for k, v in state.items()}
        return self

    def _require_state(self) -> Dict[str, torch.Tensor]:
        if self._state is None:
            raise RuntimeError("encoder is not materialized; call "
                               "materialize() or load_state() first")
        return self._state

    def arrays(self) -> Dict[str, np.ndarray]:
        """The state as named host arrays (the reference's leaf names)."""
        return {k: v.cpu().numpy() for k, v in self._require_state().items()}

    @property
    def cws(self) -> minhash.CWSParams:
        st = self._require_state()
        return minhash.CWSParams(
            **{f: st[f"cws/{f}"] for f in minhash.CWSParams._fields})

    # -- encoding ---------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self._require_state()["filters"].device

    def _shingle_ids(self, xs: torch.Tensor,
                     valid_bits: Optional[torch.Tensor]) -> torch.Tensor:
        """(R, m) series -> (R, F·S) int64 shingle ids; ``valid_bits``
        (R,) masks each row to the shingles inside its first valid bits
        (masked ids are the sentinel F·2^n)."""
        st = self._require_state()
        xs = xs.to(device=st["filters"].device, dtype=torch.float32)
        bits = ops.sketch_bits(xs.contiguous(), st["filters"], self.step)
        return shingle.shingle_ids(bits, self.ngram, valid_bits)

    def _hash_shingles(self, ids: torch.Tensor) -> torch.Tensor:
        """The weighted-set and hash stages: (R, S) ids -> (R, K) int32,
        here CWS of the exact shingle histogram."""
        return minhash.cws_hash_active(ids, self.cws)

    def _encode_rows(self, xs: torch.Tensor,
                     valid_bits: Optional[torch.Tensor]) -> torch.Tensor:
        """(R, m) -> (R, K) int32; ``valid_bits`` (R,) masks each row's
        histogram to the shingles inside its first valid bits."""
        return self._hash_shingles(self._shingle_ids(xs, valid_bits))

    def encode_batch(self, xs: torch.Tensor) -> torch.Tensor:
        """Series block (B, m) -> (B, K) int32."""
        return self._encode_rows(xs, None)

    def encode_batch_multiprobe(self, qs: torch.Tensor, offsets: int
                                ) -> torch.Tensor:
        """(B, m) -> (B, O, K); row [b, o] equals ``encode_batch`` of
        qs[b, o:] (``pipeline.py:268-286``): every offset sketches the
        fixed-length shifted slice of the zero-padded query, and its
        histogram keeps only the shingles of the shorter series.  All B·O
        rows go through one sketch launch."""
        b, m = qs.shape
        self._check_offsets(m, offsets)
        qpad = F.pad(qs, (0, offsets - 1))
        xs = torch.stack([qpad[:, o:o + m] for o in range(offsets)], 1)
        valid = torch.tensor([self.num_bits(o, m) for o in range(offsets)],
                             device=qs.device).repeat(b)
        return self._encode_rows(xs.reshape(b * offsets, m),
                                 valid).reshape(b, offsets, -1)

    def encode_chunked(self, series: torch.Tensor, batch: int = 4096
                       ) -> torch.Tensor:
        """Database build: (N, m) -> (N, K) int32 in chunks of ``batch``
        rows, bounding the (batch, K, S) CWS scores."""
        return torch.cat([self.encode_batch(series[lo:lo + batch])
                          for lo in range(0, int(series.shape[0]), batch)])

    def band_keys(self, signatures: torch.Tensor) -> torch.Tensor:
        """(..., K) -> (..., L) int32 bucket keys (uint32 bit pattern)."""
        return minhash.combine_bands(signatures, self.num_tables)

    def num_bits(self, o: int, m: int) -> int:
        """Valid window count for a query shifted by ``o``."""
        return (m - o - self.window) // self.step + 1

    def _check_offsets(self, m: int, offsets: int) -> None:
        """``pipeline.py:340-355``."""
        if offsets < 1:
            raise ValueError(f"offsets must be >= 1, got {offsets}")
        if m - (offsets - 1) < self.window:
            raise ValueError(
                f"query length {m} too short for {offsets} offsets at "
                f"window {self.window}")
        min_bits = self.num_bits(offsets - 1, m)
        if min_bits < self.ngram:
            raise ValueError(
                f"query length {m} yields only {min_bits} sketch bits at "
                f"offset {offsets - 1} — fewer than the shingle length "
                f"{self.ngram}")

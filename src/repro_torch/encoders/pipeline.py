"""Sketch -> shingle -> CWS encoders (counterpart of
``repro.encoders.pipeline``): ``"ssh"`` and ``"ssh-multires"``.

Stage 1 takes the sign bits of a strided Gaussian filter-bank projection
(the ``sketch_conv`` kernel on CUDA, its plain version on the CPU),
stage 2 the n-gram shingle ids, stage 3 a 0-bit CWS signature of K
hashes, evaluated over each row's active shingles only
(``core.minhash.cws_hash_active``).  Band keys fold the K hashes into L
bucket keys.

``"ssh-multires"`` hashes the concatenation of the n-gram histograms at
several shingle lengths (``repro/encoders/pipeline.py:102-130``): the
ids of length ``ngrams[j]`` are offset by the shingle spaces of the
lengths before it, so the weighted set spans their sum (2^10 + 2^15 bins
at the defaults).

The random state (filter bank + CWS fields) is either drawn from a
``torch.Generator`` seeded by ``spec.seed`` — the reference's
distributions, not its numbers, since ``jax.random`` cannot be
reproduced — or carried over from the reference with
``repro_torch.convert``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import minhash, shingle, sketch
from repro_torch.encoders.base import Encoder, IndexSpec
from repro_torch.encoders.registry import register_encoder
from repro_torch.kernels import ops


@register_encoder("ssh")
class SSHEncoder(Encoder):
    """The paper's encoder (Fig. 5).  Params (defaults as the reference):
    ``window``, ``step``, ``ngram``, ``num_filters``, ``num_hashes``,
    ``num_tables``."""

    DEFAULTS = dict(window=80, step=3, ngram=15, num_filters=1,
                    num_hashes=20, num_tables=20)
    supports_multiprobe = True       # δ-residue shingle alignment classes

    def __init__(self, spec: IndexSpec):
        super().__init__(spec)
        p = {**self.DEFAULTS, **spec.params}
        self.window, self.step = p["window"], p["step"]
        self.num_filters = p["num_filters"]
        self.num_hashes, self.num_tables = p["num_hashes"], p["num_tables"]
        self.ngrams: Tuple[int, ...] = self._ngrams(p)
        #: ids of every shingle length lie below this (the sentinel)
        self.shingle_dim = sum(shingle.shingle_space(n, self.num_filters)
                               for n in self.ngrams)

    @staticmethod
    def _ngrams(p) -> Tuple[int, ...]:
        return (int(p["ngram"]),)

    @property
    def ngram(self) -> int:
        return self.ngrams[0]

    @classmethod
    def validate_params(cls, spec: IndexSpec) -> None:
        cls._check_param_names(spec, cls.DEFAULTS)
        p = {**cls.DEFAULTS, **spec.params}
        if min(p["window"], p["step"], p["num_filters"]) < 1:
            raise ValueError("window, step, num_filters must be >= 1")
        if p["num_hashes"] % p["num_tables"]:
            raise ValueError("num_hashes must be divisible by num_tables")
        if any(n > 20 for n in cls._ngrams(p)):
            raise ValueError("shingle space 2^n exceeds 1M bins; use n<=20")

    # -- shape identity ---------------------------------------------------
    @property
    def dim(self) -> int:
        """The weighted set's dimension, which the CWS fields span."""
        return self.shingle_dim

    @property
    def min_bits(self) -> int:
        """Fewest sketch bits that hold one shingle of every length."""
        return max(self.ngrams)

    # -- state ------------------------------------------------------------
    def materialize(self, device=None, length: Optional[int] = None
                    ) -> "SSHEncoder":
        """Draw the random functions (idempotent) on the CPU from a
        generator seeded by ``spec.seed``, then move them to ``device``
        (CUDA unless the caller asks for the CPU); ``length`` is not
        read."""
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
        here), drawn after them from the same generator."""
        return {}

    def extra_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Shapes of the extra leaves (``pipeline.py:386-387``)."""
        return {}

    def expected_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Leaf names and shapes of the state (``pipeline.py:376-388``)."""
        shapes = {"filters": (self.window, self.num_filters)}
        shapes.update({f"cws/{f}": (self.num_hashes, self.dim)
                       for f in minhash.CWSParams._fields})
        shapes.update(self.extra_shapes())
        return shapes

    @property
    def cws(self) -> minhash.CWSParams:
        st = self._require_state()
        return minhash.CWSParams(
            **{f: st[f"cws/{f}"] for f in minhash.CWSParams._fields})

    def legacy_functions(self):
        """The state as the paper's ``SSHFunctions`` (the ``SSHIndex.fns``
        view, no copy; ``repro/encoders/pipeline.py:434-444``).  Only the
        ``"ssh"`` encoder has one."""
        from repro_torch.configs.base import ssh_params
        from repro_torch.core.index import SSHFunctions
        if self.spec.encoder != "ssh":
            raise ValueError(f"encoder {self.spec.encoder!r} has no "
                             "SSHFunctions view; only 'ssh' has")
        return SSHFunctions(params=ssh_params(self.spec),
                            filters=self._require_state()["filters"],
                            cws=self.cws)

    # -- encoding ---------------------------------------------------------
    def _shingle_ids(self, xs: torch.Tensor,
                     valid_bits: Optional[torch.Tensor]) -> torch.Tensor:
        """(R, m) series -> (R, S) int64 shingle ids over every length;
        ``valid_bits`` (R,) masks each row to the shingles inside its
        first valid bits (masked ids are the sentinel ``shingle_dim``)."""
        return self._ids_from_bits(self._sketch_bits(xs), valid_bits)

    def _sketch_bits(self, xs: torch.Tensor) -> torch.Tensor:
        """The sketch stage: (R, m) series -> (R, N_B, F) uint8 sign bits
        of the filter bank's projections at stride ``step``."""
        st = self._require_state()
        xs = xs.to(device=st["filters"].device, dtype=torch.float32)
        return ops.sketch_bits(xs.contiguous(), st["filters"], self.step)

    def _ids_from_bits(self, bits: torch.Tensor,
                       valid_bits: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """(R, N_B, F) sign bits -> (R, S) int64 shingle ids over every
        length (the rolling encode of ``repro_torch.subseq`` feeds the
        bits of windows it gathered from one shared sketch)."""
        if len(self.ngrams) == 1:
            return shingle.shingle_ids(bits, self.ngram, valid_bits)
        out, off = [], 0
        for n in self.ngrams:
            space = shingle.shingle_space(n, self.num_filters)
            ids = shingle.shingle_ids(bits, n, valid_bits)
            out.append(torch.where(ids >= space, self.shingle_dim,
                                   ids + off))
            off += space
        return torch.cat(out, 1)

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
        if min_bits < self.min_bits:
            raise ValueError(
                f"query length {m} yields only {min_bits} sketch bits at "
                f"offset {offsets - 1} — fewer than the shingle length "
                f"{self.min_bits}")


@register_encoder("ssh-multires")
class MultiResSSHEncoder(SSHEncoder):
    """SSH over concatenated multi-resolution shingles (beyond the
    paper; ``repro/encoders/pipeline.py:445-476``).  Params: ``window``,
    ``step``, ``ngrams`` (shingle lengths), ``num_filters``,
    ``num_hashes``, ``num_tables``."""

    DEFAULTS = dict(window=80, step=3, ngrams=(10, 15), num_filters=1,
                    num_hashes=20, num_tables=20)

    @staticmethod
    def _ngrams(p) -> Tuple[int, ...]:
        return tuple(int(n) for n in p["ngrams"])

    @classmethod
    def validate_params(cls, spec: IndexSpec) -> None:
        p = {**cls.DEFAULTS, **spec.params}
        ngrams = cls._ngrams(p)
        if not ngrams:
            raise ValueError("ngrams must name at least one resolution")
        if len(set(ngrams)) != len(ngrams):
            raise ValueError(f"duplicate shingle resolutions in {ngrams}")
        super().validate_params(spec)

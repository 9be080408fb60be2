"""``"ssh-cs"`` — SSH with a count-sketch shingle stage (counterpart of
``repro.streaming.encoder``).

``CountSketchShingler`` replaces the exact F·2^n shingle histogram with
``rows`` signed count-sketch tables of ``width`` bins; the weighted set
handed to CWS is the relu of the level-0 tables, ``rows·width`` wide, so
the CWS state is sized to rows·width whatever n and F are.  It is a
``Shingler`` (``encoders.base``) with the reference's stateful hooks
(``materialize``, ``adopt``, ``extra_shapes``,
``histogram_batch_pallas``), which ``PipelineEncoder`` drives, and the
streaming surface (``update``, ``find_heavy_hitters``) over the
hierarchical aggregate.

Every table goes through ``ops.cs_tables``: the ``cs_tables`` kernel on
a CUDA tensor, its plain version on the CPU.  The encoder takes the
``"entries"`` route of ``PipelineEncoder``: CWS is evaluated over the
active (relu > 0) buckets only, as ``"ssh"`` evaluates it over the
active shingles.  Every such bucket holds at least one of the row's
shingles, so the entries (r·width + bucket, table count) of the row's
shingles cover the active set (``weighted_entries``), and
``core.minhash.cws_hash_sparse`` takes the dense argmin over them.  The
weights are integer counts, so the correctly rounded log table applies.

The encoder also keeps the running hierarchical aggregate ``cs/agg``
(the persisted sketch of everything ingested), which ``absorb_sketch``
grows; signatures never read it.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.core import shingle
from repro_torch.encoders.base import IndexSpec
from repro_torch.encoders.pipeline import (CWSHasher, GaussianFilterSketcher,
                                           PipelineEncoder, _block,
                                           _check_ssh_params, _valid_rows)
from repro_torch.encoders.registry import register_encoder
from repro_torch.kernels import ops
from repro_torch.streaming import count_sketch as cs


class CountSketchShingler:
    """Shingler stage of ``"ssh-cs"``: bit-profile -> relu'd count-sketch
    tables (``repro/streaming/encoder.py:44-166``).  Shingle ids here
    follow the reference's convention: -1 marks a shingle left out."""

    def __init__(self, ngram: int, num_filters: int = 1, rows: int = 4,
                 width: int = 4096, base_bits: int = 4):
        self.ngram, self.num_filters = int(ngram), int(num_filters)
        self.rows, self.width = int(rows), int(width)
        self.base_bits = int(base_bits)
        #: shingle ids live in [0, F·2^n)
        self.id_space = self.num_filters << self.ngram
        self.id_bits = (self.id_space - 1).bit_length()
        self.levels = cs.num_levels(self.id_bits, self.width, self.base_bits)
        self.params: Optional[cs.CSParams] = None

    # -- Shingler protocol -------------------------------------------------
    @property
    def dim(self) -> int:
        return self.rows * self.width

    @property
    def min_bits(self) -> int:
        return self.ngram

    @property
    def ngrams(self) -> Tuple[int, ...]:
        return (self.ngram,)

    def histogram(self, bits: torch.Tensor) -> torch.Tensor:
        """(R, N_B, F) bits -> (R, rows·width) float32 weights, the relu
        of each row's level-0 tables ((N_B, F) -> (rows·width,))."""
        return self._weights(self.shingle_ids(bits))

    def histogram_masked(self, bits: torch.Tensor, valid_bits
                         ) -> torch.Tensor:
        """As :meth:`histogram`, over only the shingles inside each row's
        first ``valid_bits`` bits (an int or (R,))."""
        return self._weights(self.shingle_ids_masked(bits, valid_bits))

    # -- stateful-shingler hooks (PipelineEncoder) -------------------------
    def materialize(self, generator: torch.Generator
                    ) -> Dict[str, torch.Tensor]:
        """The multiply-shift coefficients, drawn on the CPU after the
        sketcher's and the hasher's state, and a zero aggregate."""
        p = cs.make_cs_params(generator, self.levels, self.rows)
        leaves = {f"cs/{f}": getattr(p, f) for f in cs.CSParams._fields}
        leaves["cs/agg"] = torch.zeros(self.sketch_shape)
        return leaves

    def adopt(self, state: Mapping[str, torch.Tensor]) -> None:
        self.params = cs.CSParams(
            *(state[f"cs/{f}"] for f in cs.CSParams._fields))

    def extra_shapes(self) -> Dict[str, Tuple[int, ...]]:
        lr = (self.levels, self.rows)
        shapes = {f"cs/{f}": lr for f in cs.CSParams._fields}
        shapes["cs/agg"] = self.sketch_shape
        return shapes

    def histogram_batch_pallas(self, bits: torch.Tensor) -> torch.Tensor:
        """(B, N_B, F) -> (B, rows·width) weights under the reference's
        name, whose "pallas" is the port's ``cs_tables`` kernel on CUDA
        and plain version on the CPU: :meth:`histogram`."""
        return self.histogram(bits)

    def weighted_entries(self, bits: torch.Tensor, valid_bits=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The weighted set as entries, what ``PipelineEncoder``'s
        ``"entries"`` route hashes: (R, N_B, F) bits -> dims (R, rows·S)
        int64, r·width + the shingle's bucket in table row r (``dim``
        where the shingle is left out), and the int64 weight of each
        entry's dimension, from the relu'd tables."""
        ids = (self.shingle_ids_batch(bits) if valid_bits is None
               else self.shingle_ids_masked(bits, valid_bits))
        bkt, sgn = self._buckets(ids)
        weights = self._relu_tables(bkt, sgn)                 # (R, D)
        offs = torch.arange(self.rows, device=ids.device)[None, :, None] \
            * self.width
        dims = torch.where(bkt >= 0, bkt.to(torch.int64) + offs,
                           self.dim).reshape(ids.shape[0], -1)
        return dims, weights.gather(1, dims.clamp(max=self.dim - 1)).to(
            torch.int64)

    # -- shingle ids -------------------------------------------------------
    def shingle_ids(self, bits: torch.Tensor) -> torch.Tensor:
        """(R, N_B, F) bits -> (R, F·S) int64 ids, all valid ((N_B, F)
        -> (F·S,)); filter f's ids are offset by f << n."""
        blk, one = _block(bits, 3)
        ids = self.shingle_ids_batch(blk)
        return ids[0] if one else ids

    def shingle_ids_masked(self, bits: torch.Tensor, valid_bits
                           ) -> torch.Tensor:
        """As :meth:`shingle_ids`, with -1 for each shingle not inside
        the row's first ``valid_bits`` bits (an int or (R,))."""
        blk, one = _block(bits, 3)
        ids = shingle.shingle_ids(
            blk, self.ngram, _valid_rows(valid_bits, blk.shape[0],
                                         blk.device))
        ids = torch.where(ids >= self.id_space, -1, ids)
        return ids[0] if one else ids

    def shingle_ids_batch(self, bits: torch.Tensor) -> torch.Tensor:
        """(B, N_B, F) -> (B, F·S) int64 shingle ids."""
        return shingle.shingle_ids(bits, self.ngram)

    # -- sketch internals --------------------------------------------------
    @property
    def sketch_shape(self) -> Tuple[int, int, int]:
        return (self.levels, self.rows, self.width)

    def _buckets(self, ids: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(R, S) ids, -1 invalid -> level-0 bucket (R, rows, S) int32
        (-1 invalid) and sign (R, rows, S) float32."""
        p = self.params
        coef = [c[0][None, :, None]
                for c in (p.bucket_a, p.bucket_b, p.sign_a, p.sign_b)]
        return cs.bucket_sign(ids[:, None, :], *coef, self.width)

    def _relu_tables(self, bkt: torch.Tensor, sgn: torch.Tensor
                     ) -> torch.Tensor:
        """(R, rows·width) relu of the tables, through ``ops.cs_tables``."""
        tables = ops.cs_tables(bkt, sgn, self.width)
        return torch.clamp(tables, min=0.0).reshape(bkt.shape[0], self.dim)

    def level0_tables(self, ids: torch.Tensor) -> torch.Tensor:
        """(R, S) shingle ids (-1 invalid) -> (R, rows, width) signed
        tables ((S,) -> (rows, width))."""
        blk, one = _block(ids, 2)
        tables = ops.cs_tables(*self._buckets(blk), self.width)
        return tables[0] if one else tables

    def _weights(self, ids: torch.Tensor) -> torch.Tensor:
        blk, one = _block(ids, 2)
        weights = self._relu_tables(*self._buckets(blk))
        return weights[0] if one else weights

    def update(self, agg: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Fold shingle ids into a hierarchical aggregate (functional)."""
        return cs.update(agg, ids, self.params, base_bits=self.base_bits)

    def find_heavy_hitters(self, agg: torch.Tensor, threshold: float):
        return cs.find_heavy_hitters(agg, self.params,
                                     base_bits=self.base_bits,
                                     id_bits=self.id_bits,
                                     threshold=threshold)


@register_encoder("ssh-cs")
class StreamingSSHEncoder(PipelineEncoder):
    """SSH with the count-sketch shingle stage and streaming sketch state.

    Params: the ``"ssh"`` six plus the sketch geometry ``rows``/``width``/
    ``base_bits`` (defaults as ``repro/streaming/encoder.py:179-181``).
    State: the ``"ssh"`` leaves with the CWS fields at dim rows·width,
    plus ``cs/{bucket_a, bucket_b, sign_a, sign_b}`` (levels, rows) and
    ``cs/agg`` (levels, rows, width).
    """

    DEFAULTS = dict(window=80, step=3, ngram=15, num_filters=1,
                    num_hashes=20, num_tables=20,
                    rows=4, width=4096, base_bits=4)
    INT_LEAVES = tuple(f"cs/{f}" for f in cs.CSParams._fields)

    @classmethod
    def _build_stages(cls, spec: IndexSpec):
        p = {**cls.DEFAULTS, **spec.params}
        shingler = CountSketchShingler(p["ngram"], p["num_filters"],
                                       p["rows"], p["width"], p["base_bits"])
        return (GaussianFilterSketcher(p["window"], p["step"],
                                       p["num_filters"]),
                shingler, CWSHasher(p["num_hashes"]), p["num_tables"])

    @classmethod
    def validate_params(cls, spec: IndexSpec) -> None:
        """``streaming/encoder.py:193-209``."""
        cls._check_param_names(spec, cls.DEFAULTS)
        p = {**cls.DEFAULTS, **spec.params}
        _check_ssh_params(p, (p["ngram"],))
        w = p["width"]
        if w < 128 or (w & (w - 1)):
            raise ValueError(f"width must be a power of two >= 128, got {w}")
        if p["rows"] < 1:
            raise ValueError("rows must be >= 1")
        if not 1 <= p["base_bits"] <= 16:
            raise ValueError("base_bits must be in [1, 16]")

    @property
    def sketch_shape(self) -> Tuple[int, int, int]:
        return self.shingler.sketch_shape

    # -- streaming sketch state -------------------------------------------
    def empty_sketch(self) -> torch.Tensor:
        """A zero hierarchical aggregate on the encoder's device."""
        return torch.zeros(self.sketch_shape, dtype=torch.float32,
                           device=self.device)

    def sketch_batch(self, xs: torch.Tensor, batch: int = 4096, *,
                     backend: str = "auto") -> torch.Tensor:
        """(B, m) series -> their hierarchical sketch contribution, in
        chunks of ``batch`` rows.  Additive and exact, so any partition of
        a stream sums to the sketch of the whole.  ``backend`` as for the
        encodes (``Encoder.check_backend``)."""
        self.check_backend(backend)
        st = self._require_state()
        agg = self.empty_sketch()
        for lo in range(0, int(xs.shape[0]), batch):
            bits = self.sketcher.sketch(xs[lo:lo + batch], st)
            agg = self.shingler.update(agg,
                                       self.shingler.shingle_ids_batch(bits))
        return agg

    def aggregate_sketch(self) -> torch.Tensor:
        """The persisted global aggregate (leaf ``cs/agg``)."""
        return self._require_state()["cs/agg"]

    def absorb_sketch(self, agg: torch.Tensor) -> None:
        """Fold a shard-local aggregate into the global one."""
        st = self._require_state()
        st["cs/agg"] = st["cs/agg"] + agg.to(st["cs/agg"].device,
                                             torch.float32)

    def find_heavy_hitters(self, threshold: float):
        """(ids, estimates) of shingles with estimated frequency >=
        ``threshold`` in the global aggregate."""
        return self.shingler.find_heavy_hitters(self.aggregate_sketch(),
                                                threshold)

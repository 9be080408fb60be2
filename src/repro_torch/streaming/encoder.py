"""``"ssh-cs"`` — SSH with a count-sketch shingle stage (counterpart of
``repro.streaming.encoder``).

``CountSketchShingler`` replaces the exact F·2^n shingle histogram with
``rows`` signed count-sketch tables of ``width`` bins; the weighted set
handed to CWS is the relu of the level-0 tables, ``rows·width`` wide, so
the CWS state is sized to rows·width whatever n and F are.

Encode follows the reference's routing (``encoders/pipeline.py:235-245``):
on a CUDA tensor the whole weighted-set stage goes through the
``cs_tables`` kernel, on the CPU through its plain version.  CWS is then
evaluated over the active (relu > 0) buckets only, as the ``"ssh"``
encoder evaluates it over the active shingles: every such bucket holds
at least one of the row's shingles, so the entries (r·width + bucket,
table value) of the row's shingles cover the active set, and
``core.minhash.cws_hash_sparse`` takes the dense argmin over them.  The
weights are integer counts, so the correctly rounded log table applies.

The encoder also keeps the running hierarchical aggregate ``cs/agg``
(the persisted sketch of everything ingested), which ``absorb_sketch``
grows; signatures never read it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import minhash
from repro_torch.encoders.base import IndexSpec
from repro_torch.encoders.pipeline import SSHEncoder
from repro_torch.kernels import ops
from repro_torch.streaming import count_sketch as cs


class CountSketchShingler:
    """Shingle stage of ``"ssh-cs"``: shingle ids -> signed count-sketch
    tables, plus the streaming surface (``update``/``find_heavy_hitters``)
    over the hierarchical aggregate."""

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

    @property
    def dim(self) -> int:
        return self.rows * self.width

    @property
    def sketch_shape(self) -> Tuple[int, int, int]:
        return (self.levels, self.rows, self.width)

    def level0_buckets(self, ids: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, S) shingle ids (>= F·2^n or < 0 invalid) -> level-0 bucket
        (B, R, S) int32 (-1 invalid) and sign (B, R, S) f32."""
        p = self.params
        ids = torch.where((ids >= 0) & (ids < self.id_space), ids, -1)
        coef = [c[0][None, :, None]
                for c in (p.bucket_a, p.bucket_b, p.sign_a, p.sign_b)]
        return cs.bucket_sign(ids[:, None, :], *coef, self.width)

    def hash_rows(self, ids: torch.Tensor, cws: minhash.CWSParams
                  ) -> torch.Tensor:
        """(B, S) shingle ids -> (B, K) int32: CWS of relu(level-0
        tables) over the rows·width dims, from the active buckets."""
        b = ids.shape[0]
        bkt, sgn = self.level0_buckets(ids)
        tables = ops.cs_tables(bkt, sgn, self.width)           # (B, R, W)
        counts = tables.gather(2, bkt.clamp(min=0).to(torch.int64))
        offs = torch.arange(self.rows, device=ids.device)[None, :, None] \
            * self.width
        dims = torch.where(bkt >= 0, bkt.to(torch.int64) + offs, self.dim)
        return minhash.cws_hash_sparse(
            dims.reshape(b, -1), counts.reshape(b, -1).to(torch.int64), cws)

    def update(self, agg: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Fold shingle ids into a hierarchical aggregate (functional)."""
        return cs.update(agg, ids, self.params, base_bits=self.base_bits)

    def find_heavy_hitters(self, agg: torch.Tensor, threshold: float):
        return cs.find_heavy_hitters(agg, self.params,
                                     base_bits=self.base_bits,
                                     id_bits=self.id_bits,
                                     threshold=threshold)


class StreamingSSHEncoder(SSHEncoder):
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

    def __init__(self, spec: IndexSpec):
        p = {**self.DEFAULTS, **spec.params}
        self.shingler = CountSketchShingler(p["ngram"], p["num_filters"],
                                            p["rows"], p["width"],
                                            p["base_bits"])
        super().__init__(spec)

    @classmethod
    def validate_params(cls, spec: IndexSpec) -> None:
        """``streaming/encoder.py:193-209``."""
        super().validate_params(spec)
        p = {**cls.DEFAULTS, **spec.params}
        w = p["width"]
        if w < 128 or (w & (w - 1)):
            raise ValueError(f"width must be a power of two >= 128, got {w}")
        if p["rows"] < 1:
            raise ValueError("rows must be >= 1")
        if not 1 <= p["base_bits"] <= 16:
            raise ValueError("base_bits must be in [1, 16]")

    @property
    def dim(self) -> int:
        return self.shingler.dim

    @property
    def sketch_shape(self) -> Tuple[int, int, int]:
        return self.shingler.sketch_shape

    # -- state ------------------------------------------------------------
    def _draw_extra_state(self, gen: torch.Generator
                          ) -> Dict[str, torch.Tensor]:
        p = cs.make_cs_params(gen, self.shingler.levels, self.shingler.rows)
        leaves = {f"cs/{f}": getattr(p, f) for f in cs.CSParams._fields}
        leaves["cs/agg"] = torch.zeros(self.sketch_shape)
        return leaves

    def extra_shapes(self) -> Dict[str, Tuple[int, ...]]:
        lr = (self.shingler.levels, self.shingler.rows)
        shapes = {f"cs/{f}": lr for f in cs.CSParams._fields}
        shapes["cs/agg"] = self.sketch_shape
        return shapes

    def load_state(self, state) -> "StreamingSSHEncoder":
        super().load_state(state)
        self.shingler.params = cs.CSParams(
            *(self._state[f"cs/{f}"] for f in cs.CSParams._fields))
        return self

    # -- encoding ---------------------------------------------------------
    def _hash_shingles(self, ids: torch.Tensor) -> torch.Tensor:
        return self.shingler.hash_rows(ids, self.cws)

    # -- streaming sketch state -------------------------------------------
    def empty_sketch(self) -> torch.Tensor:
        """A zero hierarchical aggregate on the encoder's device."""
        return torch.zeros(self.sketch_shape, dtype=torch.float32,
                           device=self.device)

    def sketch_batch(self, xs: torch.Tensor, batch: int = 4096
                     ) -> torch.Tensor:
        """(B, m) series -> their hierarchical sketch contribution, in
        chunks of ``batch`` rows.  Additive and exact, so any partition of
        a stream sums to the sketch of the whole."""
        agg = self.empty_sketch()
        for lo in range(0, int(xs.shape[0]), batch):
            ids = self._shingle_ids(xs[lo:lo + batch], None)
            agg = self.shingler.update(agg, ids)
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

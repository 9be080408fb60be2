"""Sketch -> shingle -> hash stages and their composition (counterpart of
``repro.encoders.pipeline``): ``"ssh"`` and ``"ssh-multires"``.

``PipelineEncoder`` composes a ``Sketcher``, a ``Shingler`` and a
``Hasher`` (``encoders.base``; the three stages of the paper's Fig. 5)
into one ``Encoder``.  The paper's stages:

* ``GaussianFilterSketcher``: the sign bits of a strided Gaussian
  filter-bank projection (the ``sketch_conv`` kernel on CUDA, its plain
  version on the CPU);
* ``NgramShingler``: the n-gram shingle histogram; ``MultiResShingler``
  the concatenation of the histograms at several shingle lengths
  (``"ssh-multires"``): the ids of length ``ngrams[j]`` are offset by the
  shingle spaces of the lengths before it, so the weighted set spans
  their sum (2^10 + 2^15 bins at the defaults);
* ``CWSHasher``: a 0-bit CWS signature of K hashes.

Stage methods take a block of rows, (R, ...) -> (R, ...); the stock
stages also take one row and give one row back.  Band keys fold the K
hashes into L bucket keys.

The random state (filter bank + CWS fields, and a stateful shingler's
leaves) is either drawn from a ``torch.Generator`` seeded by
``spec.seed`` — the reference's distributions, not its numbers, since
``jax.random`` cannot be reproduced — or carried over from the reference
with ``repro_torch.convert``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import minhash, shingle, sketch
from repro_torch.encoders.base import Encoder, IndexSpec
from repro_torch.encoders.registry import register_encoder
from repro_torch.kernels import ops

#: rows a block of the dense route: bounds the (rows, D) histogram and
#: the (rows, K, D) CWS scores (64 x 40 x 2^15 float32 is 335 MB)
DENSE_CHUNK = 64


def _block(t: torch.Tensor, ndim: int) -> Tuple[torch.Tensor, bool]:
    """``t`` as a block of ``ndim`` axes: one row (``ndim - 1`` axes)
    gains a leading axis, and the flag says to take it off the result;
    any other rank raises."""
    if t.dim() == ndim - 1:
        return t[None], True
    if t.dim() != ndim:
        raise ValueError(f"expected a block of {ndim} axes or one row of "
                         f"{ndim - 1}, got shape {tuple(t.shape)}")
    return t, False


def _valid_rows(valid_bits, rows: int, device: torch.device
                ) -> Optional[torch.Tensor]:
    """The (R,) valid bit counts of an int or of an (R,) tensor."""
    if valid_bits is None:
        return None
    v = torch.as_tensor(valid_bits, device=device)
    return v.expand(rows) if v.dim() == 0 else v


# --------------------------------------------------------------------------
# stages
# --------------------------------------------------------------------------

class GaussianFilterSketcher:
    """§4.1: sign bits of a strided random filter-bank projection
    (``repro/encoders/pipeline.py:53-78``)."""

    def __init__(self, window: int, step: int, num_filters: int = 1):
        if min(window, step, num_filters) < 1:
            raise ValueError("window, step, num_filters must be >= 1")
        self.window, self.step = int(window), int(step)
        self.num_filters = int(num_filters)

    def materialize(self, generator: torch.Generator
                    ) -> Dict[str, torch.Tensor]:
        return {"filters": sketch.make_filter(self.window, self.num_filters,
                                              generator)}

    def sketch(self, x: torch.Tensor, state: Mapping[str, torch.Tensor]
               ) -> torch.Tensor:
        """(R, m) series -> (R, N_B, F) uint8 bits ((m,) -> (N_B, F)) on
        the filters' device, through ``ops.sketch_bits``: the
        ``sketch_conv`` kernel there on CUDA, the plain version on the
        CPU."""
        filters = state["filters"]
        xs, one = _block(x, 2)
        xs = xs.to(device=filters.device, dtype=torch.float32)
        bits = ops.sketch_bits(xs.contiguous(), filters, self.step)
        return bits[0] if one else bits

    def sketch_batch_pallas(self, xs: torch.Tensor,
                            state: Mapping[str, torch.Tensor]
                            ) -> torch.Tensor:
        """(B, m) -> (B, N_B, F) under the reference's name, whose
        "pallas" is the port's kernel on CUDA and plain version on the
        CPU: :meth:`sketch`."""
        return self.sketch(xs, state)

    def num_bits(self, o: int, m: int) -> int:
        """Valid window count for a query shifted by ``o``."""
        return (m - o - self.window) // self.step + 1


class MultiResShingler:
    """Concatenated n-gram histograms at several shingle lengths
    (``repro/encoders/pipeline.py:102-130``): the disjoint union of the
    per-length shingle sets."""

    def __init__(self, ngrams: Sequence[int], num_filters: int = 1):
        self.ngrams: Tuple[int, ...] = tuple(int(n) for n in ngrams)
        self.num_filters = int(num_filters)

    @property
    def dim(self) -> int:
        return sum(shingle.shingle_space(n, self.num_filters)
                   for n in self.ngrams)

    @property
    def min_bits(self) -> int:
        return max(self.ngrams)

    def shingle_ids(self, bits: torch.Tensor, valid_bits=None
                    ) -> torch.Tensor:
        """(R, N_B, F) bits -> (R, S) int64 ids over every length
        ((N_B, F) -> (S,)); ``valid_bits`` (an int or (R,)) keeps only
        the shingles inside each row's first valid bits, and a shingle
        it drops gets the sentinel id ``dim``."""
        blk, one = _block(bits, 3)
        valid = _valid_rows(valid_bits, blk.shape[0], blk.device)
        out, off = [], 0
        for n in self.ngrams:
            space = shingle.shingle_space(n, self.num_filters)
            ids = shingle.shingle_ids(blk, n, valid)
            out.append(torch.where(ids >= space, self.dim, ids + off))
            off += space
        ids = torch.cat(out, 1)
        return ids[0] if one else ids

    def histogram(self, bits: torch.Tensor) -> torch.Tensor:
        """(R, N_B, F) -> (R, dim) int32 counts
        (``core.shingle.shingle_histogram`` of each row, the lengths
        concatenated)."""
        return self.histogram_masked(bits, None)

    def histogram_masked(self, bits: torch.Tensor, valid_bits
                         ) -> torch.Tensor:
        """As :meth:`histogram`, counting only the shingles inside each
        row's first ``valid_bits`` bits
        (``core.shingle.shingle_histogram_masked``)."""
        blk, one = _block(bits, 3)
        counts = shingle.histogram_from_ids(
            self.shingle_ids(blk, valid_bits), self.dim)
        return counts[0] if one else counts


class NgramShingler(MultiResShingler):
    """§4.2: the n-gram shingle histogram over the bit-profile
    (``repro/encoders/pipeline.py:81-99``): one shingle length."""

    def __init__(self, ngram: int, num_filters: int = 1):
        super().__init__((ngram,), num_filters)
        self.ngram = int(ngram)


class CWSHasher:
    """§4.3: 0-bit consistent weighted sampling, K independent hashes
    (``repro/encoders/pipeline.py:133-146``)."""

    def __init__(self, num_hashes: int):
        self.num_hashes = int(num_hashes)

    def materialize(self, generator: torch.Generator, dim: int
                    ) -> Dict[str, torch.Tensor]:
        cws = minhash.make_cws(self.num_hashes, dim, generator)
        return {f"cws/{f}": getattr(cws, f) for f in cws._fields}

    @staticmethod
    def cws_params(state: Mapping[str, torch.Tensor]) -> minhash.CWSParams:
        return minhash.CWSParams(
            **{f: state[f"cws/{f}"] for f in minhash.CWSParams._fields})

    def hash(self, counts: torch.Tensor, state: Mapping[str, torch.Tensor]
             ) -> torch.Tensor:
        """Integer counts (R, D) -> (R, K) int32 ((D,) -> (K,)), every
        K·D score evaluated (``minhash.cws_hash_batch``, 64 rows a
        block)."""
        blk, one = _block(counts, 2)
        sigs = minhash.cws_hash_batch(blk, self.cws_params(state))
        return sigs[0] if one else sigs

    def hash_ids(self, ids: torch.Tensor, state: Mapping[str, torch.Tensor],
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The signature of a weighted set given by its entries, equal to
        :meth:`hash` of its counts without forming them: ``ids`` (R, S),
        ids >= D masked -> (R, K) int32.  An id's weight is the number of
        its entries (``minhash.cws_hash_active``), or, with ``weights``
        (R, S) integers, the weight of its dimension given at each of its
        entries (``minhash.cws_hash_sparse``)."""
        cws = self.cws_params(state)
        if weights is None:
            return minhash.cws_hash_active(ids, cws)
        return minhash.cws_hash_sparse(ids, weights, cws)


# --------------------------------------------------------------------------
# the composed encoder
# --------------------------------------------------------------------------

class PipelineEncoder(Encoder):
    """Sketcher ∘ Shingler ∘ Hasher behind the one ``Encoder`` facade
    (``repro/encoders/pipeline.py:149-419``).  A subclass parses
    ``spec.params`` into ``(sketcher, shingler, hasher, num_tables)`` in
    ``_build_stages``; the rest is shared.

    The shingle and hash stages meet by one of three routes, chosen once,
    at construction, from what the stages offer (``route``):

    * ``"ids"``: the shingler gives each row's shingle ids
      (``shingle_ids``) and the hasher hashes their histogram from them
      (``hash_ids``), never forming the (R, D) histogram: ``"ssh"`` and
      ``"ssh-multires"``;
    * ``"entries"``: the shingler gives its weighted set as
      (dimension, weight) entries (``weighted_entries``) and the hasher
      takes them (``hash_ids``): the count-sketch tables of ``"ssh-cs"``;
    * ``"dense"``: ``hasher.hash(shingler.histogram(bits))``, for stages
      that implement only the protocols, in blocks of
      :data:`DENSE_CHUNK` rows.

    The three give the same signatures for the same weighted set.
    """

    supports_multiprobe = True       # δ-residue shingle alignment classes

    def __init__(self, spec: IndexSpec):
        super().__init__(spec)
        self.sketcher, self.shingler, self.hasher, self.num_tables = \
            self._build_stages(spec)
        self.num_hashes = self.hasher.num_hashes
        self.route = self._route_of(self.shingler, self.hasher)

    @classmethod
    def _build_stages(cls, spec: IndexSpec):
        raise NotImplementedError

    @staticmethod
    def _route_of(shingler, hasher) -> str:
        if hasattr(hasher, "hash_ids"):
            if hasattr(shingler, "weighted_entries"):
                return "entries"
            if hasattr(shingler, "shingle_ids"):
                return "ids"
        return "dense"

    # -- the stages' shapes -----------------------------------------------
    @property
    def window(self) -> int:
        return self.sketcher.window

    @property
    def step(self) -> int:
        return self.sketcher.step

    @property
    def num_filters(self) -> int:
        return self.sketcher.num_filters

    @property
    def ngrams(self) -> Tuple[int, ...]:
        return self.shingler.ngrams

    @property
    def ngram(self) -> int:
        """The first shingle length (the only one but in
        ``"ssh-multires"``)."""
        return self.ngrams[0]

    @property
    def dim(self) -> int:
        """The weighted set's dimension, which the CWS fields span."""
        return self.shingler.dim

    @property
    def min_bits(self) -> int:
        """Fewest sketch bits that hold one whole shingle."""
        return self.shingler.min_bits

    # -- state ------------------------------------------------------------
    def materialize(self, device=None, length: Optional[int] = None
                    ) -> "PipelineEncoder":
        """Draw the stages' random state (idempotent) on the CPU from one
        generator seeded by ``spec.seed`` — the sketcher's, then the
        hasher's, then a stateful shingler's — and move it to ``device``
        (CUDA unless the caller asks for the CPU); ``length`` is not
        read."""
        if self._state is None:
            dev = ops.resolve_device(device)
            gen = torch.Generator().manual_seed(self.spec.seed)
            state = dict(self.sketcher.materialize(gen))
            state.update(self.hasher.materialize(gen, self.shingler.dim))
            if hasattr(self.shingler, "materialize"):
                state.update(self.shingler.materialize(gen))
            self.load_state({k: v.to(dev) for k, v in state.items()})
        return self

    def expected_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Leaf names and shapes of the stock sketcher and hasher's state
        and a stateful shingler's ``extra_shapes``
        (``pipeline.py:376-388``); a subclass whose stages draw other
        leaves overrides it."""
        shapes = {"filters": (self.window, self.num_filters)}
        shapes.update({f"cws/{f}": (self.num_hashes, self.dim)
                       for f in minhash.CWSParams._fields})
        if hasattr(self.shingler, "extra_shapes"):
            shapes.update(self.shingler.extra_shapes())
        return shapes

    def _adopt(self) -> None:
        if hasattr(self.shingler, "adopt"):
            self.shingler.adopt(self._state)

    @property
    def cws(self) -> minhash.CWSParams:
        return self.hasher.cws_params(self._require_state())

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
    def encode_bits(self, bits: torch.Tensor, valid_bits=None,
                    state: Optional[Mapping[str, torch.Tensor]] = None
                    ) -> torch.Tensor:
        """The shingle and hash stages by the encoder's route: sketch
        bits (R, N_B, F) -> (R, K) int32.  ``valid_bits`` (an int or
        (R,)) keeps only the shingles inside each row's first valid bits;
        ``state`` defaults to the encoder's.  The rolling encode of
        ``repro_torch.subseq`` feeds it the bits of windows gathered from
        one shared sketch."""
        st = self._require_state() if state is None else state
        if self.route == "ids":
            return self.hasher.hash_ids(
                self.shingler.shingle_ids(bits, valid_bits), st)
        if self.route == "entries":
            dims, weights = self.shingler.weighted_entries(bits, valid_bits)
            return self.hasher.hash_ids(dims, st, weights)
        valid = _valid_rows(valid_bits, bits.shape[0], bits.device)
        out = []
        for lo in range(0, bits.shape[0], DENSE_CHUNK):
            blk = bits[lo:lo + DENSE_CHUNK]
            counts = (self.shingler.histogram(blk) if valid is None else
                      self.shingler.histogram_masked(
                          blk, valid[lo:lo + DENSE_CHUNK]))
            out.append(self.hasher.hash(counts, st))
        return torch.cat(out)

    def encode_batch(self, xs: torch.Tensor, *, backend: str = "auto"
                     ) -> torch.Tensor:
        """Series block (B, m) -> (B, K) int32."""
        self.check_backend(backend)
        return self.encode_bits(
            self.sketcher.sketch(xs, self._require_state()))

    def encode_batch_multiprobe(self, qs: torch.Tensor, offsets: int, *,
                                backend: str = "auto") -> torch.Tensor:
        """(B, m) -> (B, O, K); row [b, o] equals ``encode_batch`` of
        qs[b, o:] (``pipeline.py:268-286``): every offset sketches the
        fixed-length shifted slice of the zero-padded query, and its
        weighted set keeps only the shingles of the shorter series.  All
        B·O rows go through one sketch launch."""
        self.check_backend(backend)
        b, m = qs.shape
        self._check_offsets(m, offsets)
        qpad = F.pad(qs, (0, offsets - 1))
        xs = torch.stack([qpad[:, o:o + m] for o in range(offsets)], 1)
        bits = self.sketcher.sketch(xs.reshape(b * offsets, m),
                                    self._require_state())
        valid = torch.tensor([self.num_bits(o, m) for o in range(offsets)],
                             device=bits.device).repeat(b)
        return self.encode_bits(bits, valid).reshape(b, offsets, -1)

    def pure_encode_fn(self):
        """``fn(x, state)``: the sketch and the encoder's route over the
        state passed, (m,) -> (K,) or (R, m) -> (R, K) int32
        (``pipeline.py:341-349``).  A stateful shingler reads the
        coefficients it adopted, as the reference's does."""
        def encode(x: torch.Tensor, state: Mapping[str, torch.Tensor]
                   ) -> torch.Tensor:
            xs, one = _block(x, 2)
            sigs = self.encode_bits(self.sketcher.sketch(xs, state),
                                    state=state)
            return sigs[0] if one else sigs
        return encode

    def num_bits(self, o: int, m: int) -> int:
        """Valid window count for a query shifted by ``o``."""
        return self.sketcher.num_bits(o, m)

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


def _check_ssh_params(p: Mapping, ngrams: Sequence[int]) -> None:
    if min(p["window"], p["step"], p["num_filters"]) < 1:
        raise ValueError("window, step, num_filters must be >= 1")
    if p["num_hashes"] % p["num_tables"]:
        raise ValueError("num_hashes must be divisible by num_tables")
    if any(n > 20 for n in ngrams):
        raise ValueError("shingle space 2^n exceeds 1M bins; use n<=20")


@register_encoder("ssh")
class SSHEncoder(PipelineEncoder):
    """The paper's encoder (Fig. 5).  Params (defaults as the reference):
    ``window``, ``step``, ``ngram``, ``num_filters``, ``num_hashes``,
    ``num_tables``."""

    DEFAULTS = dict(window=80, step=3, ngram=15, num_filters=1,
                    num_hashes=20, num_tables=20)

    @classmethod
    def _build_stages(cls, spec: IndexSpec):
        p = {**cls.DEFAULTS, **spec.params}
        return (GaussianFilterSketcher(p["window"], p["step"],
                                       p["num_filters"]),
                NgramShingler(p["ngram"], p["num_filters"]),
                CWSHasher(p["num_hashes"]), p["num_tables"])

    @classmethod
    def validate_params(cls, spec: IndexSpec) -> None:
        cls._check_param_names(spec, cls.DEFAULTS)
        p = {**cls.DEFAULTS, **spec.params}
        _check_ssh_params(p, (p["ngram"],))


@register_encoder("ssh-multires")
class MultiResSSHEncoder(PipelineEncoder):
    """SSH over concatenated multi-resolution shingles (beyond the
    paper; ``repro/encoders/pipeline.py:445-476``).  Params: ``window``,
    ``step``, ``ngrams`` (shingle lengths), ``num_filters``,
    ``num_hashes``, ``num_tables``."""

    DEFAULTS = dict(window=80, step=3, ngrams=(10, 15), num_filters=1,
                    num_hashes=20, num_tables=20)

    @classmethod
    def _build_stages(cls, spec: IndexSpec):
        p = {**cls.DEFAULTS, **spec.params}
        return (GaussianFilterSketcher(p["window"], p["step"],
                                       p["num_filters"]),
                MultiResShingler(p["ngrams"], p["num_filters"]),
                CWSHasher(p["num_hashes"]), p["num_tables"])

    @classmethod
    def validate_params(cls, spec: IndexSpec) -> None:
        cls._check_param_names(spec, cls.DEFAULTS)
        p = {**cls.DEFAULTS, **spec.params}
        ngrams = tuple(int(n) for n in p["ngrams"])
        if not ngrams:
            raise ValueError("ngrams must name at least one resolution")
        if len(set(ngrams)) != len(ngrams):
            raise ValueError(f"duplicate shingle resolutions in {ngrams}")
        _check_ssh_params(p, ngrams)

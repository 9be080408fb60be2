"""``IndexSpec`` and the ``Encoder`` base (counterpart of
``repro.encoders.base``).

``IndexSpec`` is what an index *is*: encoder name + stage params + seed.
It round-trips through ``to_dict``/``from_dict`` in the reference's
format, so one spec names the same index in both packages.

An ``Encoder`` turns series into (K,) int32 signatures and folds them
into L band keys.  Its random state is a dict of named tensors on one
device (the reference's leaf names): drawn by ``materialize`` from a
``torch.Generator`` seeded by ``spec.seed``, or adopted by
``load_state`` (tensors) and ``load_arrays`` (host arrays, through
``repro_torch.convert``), both of which refuse a leaf set or a shape
that disagrees with the spec.  ``arrays`` gives the state back as host
arrays in the dtypes the reference stores.

The stage protocols ``Sketcher``, ``Shingler`` and ``Hasher`` are the
contract of the three stages of the paper's Fig. 5, which
``encoders.pipeline.PipelineEncoder`` composes; an out-of-tree stage
that implements one plugs into it.  Stage methods take a leading row
axis where the reference's take one row under ``vmap``: a block
(R, ...) gives (R, ...), and row r of the block equals the reference's
result for row r.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import (Any, Callable, Dict, Iterable, Mapping, Optional,
                    Protocol, Tuple, runtime_checkable)

import numpy as np
import torch

from repro_torch.core import minhash
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class IndexSpec:
    """Encoder name + stage params + seed; unset params take the encoder's
    defaults."""

    encoder: str = "ssh"
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    seed: int = 7

    def __post_init__(self):
        params = {k: tuple(v) if isinstance(v, (list, tuple)) else v
                  for k, v in dict(self.params).items()}
        object.__setattr__(self, "params", params)

    def validate(self) -> "IndexSpec":
        if not isinstance(self.encoder, str) or not self.encoder:
            raise ValueError(
                f"encoder must be a non-empty string, got {self.encoder!r}")
        from repro_torch.encoders.registry import encoder_class
        encoder_class(self.encoder).validate_params(self)
        return self

    def replace(self, **changes: Any) -> "IndexSpec":
        return dataclasses.replace(self, **changes).validate()

    def with_params(self, **params: Any) -> "IndexSpec":
        return self.replace(params={**self.params, **params})

    def __hash__(self):
        # a value type (signature-cache keys, hashed at every lookup);
        # the dict field has no hash of its own.  Frozen, so computed once
        h = self.__dict__.get("_hash")
        if h is None:
            h = hash((self.encoder, tuple(sorted(self.params.items())),
                      self.seed))
            object.__setattr__(self, "_hash", h)
        return h

    def to_dict(self) -> Dict[str, Any]:
        return {"encoder": self.encoder, "params": dict(self.params),
                "seed": self.seed}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "IndexSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        extra = sorted(set(d) - known)
        if extra:
            warnings.warn(f"IndexSpec.from_dict: ignoring unknown fields "
                          f"{extra}", RuntimeWarning, stacklevel=2)
        return cls(**{k: v for k, v in d.items() if k in known})


@runtime_checkable
class Sketcher(Protocol):
    """Stage 1: series (R, m) -> bit-profile (R, N_B, F) uint8."""

    def materialize(self, generator: torch.Generator
                    ) -> Dict[str, torch.Tensor]:
        """Draw the stage's random state (the filter bank) on the CPU."""

    def sketch(self, x: torch.Tensor, state: Mapping[str, torch.Tensor]
               ) -> torch.Tensor:
        """Sign bits of each row."""


@runtime_checkable
class Shingler(Protocol):
    """Stage 2: bit-profile (R, N_B, F) -> weighted set (R, D)."""

    @property
    def dim(self) -> int:
        """D, the weighted set's dimension, which the hasher is sized to."""

    @property
    def min_bits(self) -> int:
        """Fewest bit-profile rows that still hold one whole shingle."""

    def histogram(self, bits: torch.Tensor) -> torch.Tensor:
        """Each row's weighted set: integer-valued counts."""

    def histogram_masked(self, bits: torch.Tensor, valid_bits
                         ) -> torch.Tensor:
        """Counts of only the shingles inside each row's first
        ``valid_bits`` bits (an int, or an (R,) tensor of them): the
        multiprobe path."""


@runtime_checkable
class Hasher(Protocol):
    """Stage 3: weighted set (R, D) -> signature (R, K) int32."""

    def materialize(self, generator: torch.Generator, dim: int
                    ) -> Dict[str, torch.Tensor]:
        """Draw the stage's random state over D dimensions on the CPU."""

    def hash(self, counts: torch.Tensor, state: Mapping[str, torch.Tensor]
             ) -> torch.Tensor:
        """The signature of each row's weighted set."""


class Encoder:
    """Base of the index-side encoders.  A subclass sets ``DEFAULTS``,
    ``num_hashes`` and ``num_tables``, and implements ``materialize``,
    ``expected_shapes`` and ``encode_batch``."""

    #: registry name, set by ``@register_encoder``
    name: str = ""
    DEFAULTS: Dict[str, Any] = {}
    num_hashes: int
    num_tables: int
    #: whether there are shift-alignment classes to multiprobe; the
    #: facade folds ``multiprobe_offsets`` to 1 for encoders without
    supports_multiprobe: bool = False
    #: state leaves that hold integers: int64 on the device, uint32 on
    #: disk (the reference's dtype); every other leaf is float32
    INT_LEAVES: Tuple[str, ...] = ()

    def __init__(self, spec: IndexSpec):
        spec.validate()
        self.spec = spec
        self._state: Optional[Dict[str, torch.Tensor]] = None

    @classmethod
    def validate_params(cls, spec: IndexSpec) -> None:
        cls._check_param_names(spec, cls.DEFAULTS)

    @classmethod
    def _check_param_names(cls, spec: IndexSpec,
                           known: Iterable[str]) -> None:
        unknown = sorted(set(spec.params) - set(known))
        if unknown:
            raise ValueError(f"unknown params {unknown} for encoder "
                             f"{spec.encoder!r}; known: {sorted(known)}")

    # -- state ------------------------------------------------------------
    @property
    def materialized(self) -> bool:
        return self._state is not None

    def materialize(self, device=None, length: Optional[int] = None
                    ) -> "Encoder":
        """Draw the random state (idempotent) on ``device``, CUDA unless
        the caller asks for the CPU.  ``length`` is the series length m,
        read by encoders whose state is sized to it (``"srp"``)."""
        raise NotImplementedError

    def expected_shapes(self) -> Dict[str, Tuple[Optional[int], ...]]:
        """Leaf names and shapes the spec implies; ``None`` is a size the
        spec leaves open (the ``"srp"`` planes' series length)."""
        raise NotImplementedError

    def _check_leaves(self, arrays: Mapping[str, Any],
                      want: Mapping[str, Any]) -> None:
        """Refuse a state whose leaf set differs from the spec's, naming
        every offending leaf."""
        missing = sorted(set(want) - set(arrays))
        if missing:
            raise self._mismatch(f"the state is missing leaves {missing}; "
                                 f"found only {sorted(arrays)}")
        unknown = sorted(set(arrays) - set(want))
        if unknown:
            raise self._mismatch(f"the state has unknown leaves {unknown}; "
                                 f"this spec expects exactly {sorted(want)}")

    def _mismatch(self, detail: str) -> ValueError:
        return ValueError(
            f"encoder state does not match IndexSpec(encoder="
            f"{self.spec.encoder!r}, params={dict(self.spec.params)!r}): "
            f"{detail}")

    def load_state(self, state: Mapping[str, torch.Tensor]) -> "Encoder":
        """Adopt a state dict of tensors on one device: the ``INT_LEAVES``
        as int64, the rest as float32."""
        want = self.expected_shapes()
        self._check_leaves(state, want)
        for name, shape in want.items():
            got = tuple(state[name].shape)
            if len(got) != len(shape) or any(
                    w is not None and g != w for g, w in zip(got, shape)):
                raise self._mismatch(f"leaf {name!r} has shape {got}, spec "
                                     f"implies {shape}")
        devices = {t.device for t in state.values()}
        if len(devices) != 1:
            raise ValueError(f"encoder state spans devices {devices}")
        self._state = {
            k: v.to(torch.int64 if k in self.INT_LEAVES
                    else torch.float32).contiguous()
            for k, v in state.items()}
        self._adopt()
        return self

    def _adopt(self) -> None:
        """Hook run after a state is installed."""

    def load_arrays(self, arrays: Mapping[str, np.ndarray],
                    device=None) -> "Encoder":
        """Adopt a state given as host arrays (a saved or carried state)
        on ``device``, CUDA unless the caller asks for the CPU."""
        from repro_torch import convert
        return self.load_state(convert.encoder_state_from_arrays(
            arrays, device, spec=self.spec))

    def _require_state(self) -> Dict[str, torch.Tensor]:
        if self._state is None:
            raise RuntimeError(
                f"encoder {self.spec.encoder!r} is not materialized; call "
                "materialize() or load_state() first")
        return self._state

    def arrays(self) -> Dict[str, np.ndarray]:
        """The state as named host arrays in the reference's dtypes."""
        return {k: (v.cpu().numpy().astype(np.uint32)
                    if k in self.INT_LEAVES else v.cpu().numpy())
                for k, v in self._require_state().items()}

    def state(self) -> Dict[str, torch.Tensor]:
        """The materialised random state as named device tensors (a new
        dict over the same tensors)."""
        return dict(self._require_state())

    @property
    def device(self) -> torch.device:
        return next(iter(self._require_state().values())).device

    # -- encoding ---------------------------------------------------------
    # Every encode takes the reference's ``backend`` knob, checked against
    # the device of the state (``ops.check_backend``): that device picks
    # the route, the kernels on CUDA and their plain versions on the CPU,
    # and ``"jnp"`` is refused off the CPU.  The public methods check it
    # once and call ``encode_batch`` without it, so an out-of-tree
    # ``encode_batch(xs)`` serves unchanged.
    def check_backend(self, backend: str) -> None:
        """Refuse ``backend`` for this encoder's device."""
        ops.check_backend(backend, self.device)

    def encode(self, x: torch.Tensor, *, backend: str = "auto"
               ) -> torch.Tensor:
        """One series (m,) -> signature (K,) int32: row 0 of
        :meth:`encode_batch`."""
        self.check_backend(backend)
        return self.encode_batch(x[None, :])[0]

    def encode_batch(self, xs: torch.Tensor, *, backend: str = "auto"
                     ) -> torch.Tensor:
        """Series block (B, m) -> (B, K) int32."""
        raise NotImplementedError

    def encode_chunked(self, series: torch.Tensor, batch: int = 4096, *,
                       backend: str = "auto") -> torch.Tensor:
        """Database build: (N, m) -> (N, K) int32 in chunks of ``batch``
        rows, bounding each chunk's working set."""
        self.check_backend(backend)
        return torch.cat([self.encode_batch(series[lo:lo + batch])
                          for lo in range(0, int(series.shape[0]), batch)])

    def encode_multiprobe(self, q: torch.Tensor, offsets: int, *,
                          backend: str = "auto") -> torch.Tensor:
        """(m,) -> (O, K): row o encodes q[o:]; encoders without
        shift-alignment classes raise ``ValueError``."""
        self.check_backend(backend)
        return self.encode_batch_multiprobe(q[None, :], offsets)[0]

    def encode_batch_multiprobe(self, qs: torch.Tensor, offsets: int, *,
                                backend: str = "auto") -> torch.Tensor:
        """(B, m) -> (B, O, K); encoders without shift-alignment classes
        raise."""
        raise ValueError(
            f"encoder {self.spec.encoder!r} has no shift-alignment "
            "classes; use multiprobe_offsets=1")

    def band_keys(self, signatures: torch.Tensor) -> torch.Tensor:
        """(..., K) -> (..., L) int32 bucket keys (uint32 bit pattern)."""
        return minhash.combine_bands(signatures, self.num_tables)

    def pure_encode_fn(self) -> Callable:
        """A function ``fn(x, state)`` of the series and a state dict
        (:meth:`state`'s form): (m,) -> (K,) or (R, m) -> (R, K) int32,
        the stage hyper-parameters closed over (the reference's form for
        ``shard_map``, ``encoders/base.py:267-272``)."""
        raise NotImplementedError

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(spec={self.spec!r}, "
                f"materialized={self.materialized})")

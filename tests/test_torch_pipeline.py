"""The encoder composition of the port (``repro_torch.encoders``:
the stage protocols, the four stages, ``PipelineEncoder``) against
``repro.encoders`` (jnp route and ``kernels/ref.py``), on the CPU.

Inputs are made with numpy from a seed; the reference's state is carried
across with ``repro_torch.convert``.  Integers (sign bits, shingle ids,
histograms, signatures, band keys, count-sketch tables) are held exact;
float32 values the port computes itself at 1e-6.
"""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.encoders import IndexSpec as JaxIndexSpec
from repro.encoders import base as jbase
from repro.encoders import make_encoder as jax_make_encoder
from repro.encoders import pipeline as jpipe
from repro.streaming import encoder as jstream
from repro_torch import convert
from repro_torch.db import SearchConfig, TimeSeriesDB
from repro_torch.encoders import (CWSHasher, Encoder, GaussianFilterSketcher,
                                  Hasher, IndexSpec, MultiResShingler,
                                  NgramShingler, PipelineEncoder, SSHEncoder,
                                  Shingler, Sketcher, make_encoder,
                                  register_encoder)
from repro_torch.encoders.pipeline import DENSE_CHUNK
from repro_torch.streaming import CountSketchShingler, StreamingSSHEncoder

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

SMOKE = dict(window=24, step=3, num_hashes=20, num_tables=20)
PIN_SPECS = {
    "ssh": dict(SMOKE, ngram=8),
    "ssh-multires": dict(SMOKE, ngrams=(6, 8)),
    "ssh-cs": dict(SMOKE, ngram=8, rows=4, width=512),
}

# sha256 of each state leaf and of what a fixed wave encodes to, at seed
# 7, captured before the encoders became compositions of stages
PINNED = {
    "ssh": {
        "state/cws/beta":
            "0abe16783c22fb71f3d2c8c880ddfdb410db6ee0f8037155e86f3b4d2096384f",
        "state/cws/log_c":
            "d270ccdd9a204496a8a089b33b9bde2dfdbc01c8759a6f27c1ee62ad29b5544a",
        "state/cws/log_r":
            "0b82eaddc89f2739eede44e8cd207f101a4907e58ef15cfe1a68875eb8e7dd73",
        "state/cws/r":
            "46b0a2d5473ce5a7fafb766a65b88bdce774fb9e81dcfc8f8faef131fe79d347",
        "state/filters":
            "ea2d753034d0574b44eb5800b5e7db0504cb54a99eb1af2a19e9e7cc08ca7174",
        "signatures":
            "7f03dbeae856bc3787a7a277cc812e025992c77c1a7a5fde7e0f8a9c4b610f45",
        "band_keys":
            "6bbae07b7fb22dcf0f11adf18a51f13ba560062ca602522aa19c5a4d2566e4ff",
        "multiprobe":
            "9f85e5d3f0582ab90c170b7e52823eb46dc10a46d20de4e34d57196356d07e48",
    },
    "ssh-multires": {
        "state/cws/beta":
            "c56434d684aa5b134cd222c738615c5c4e9698928517e30e7012e44b18a6f536",
        "state/cws/log_c":
            "e92d14ba1bcc9604d3ca843c078ee2e9e02783ffad215e263057587cd202f4fa",
        "state/cws/log_r":
            "f927a0ae911af736cf1c4d15ba20929f69a620d23f811b93ab2b5e8df5c7b77c",
        "state/cws/r":
            "26ac83d51d249cd7159aefefa54f13a7c3cb11c63f3ffcb670135aaa75c91003",
        "state/filters":
            "ea2d753034d0574b44eb5800b5e7db0504cb54a99eb1af2a19e9e7cc08ca7174",
        "signatures":
            "0599276d8ce1ef982e6fb0517c63939751f17154223c2af5e648279b9fda4cc8",
        "band_keys":
            "da8be4fa6186726d43503be10179fe14ad251d381e0f38811ce2402aa5eb87f3",
        "multiprobe":
            "a2cef7e16d9ed1dc5e3f6f33c0565658f30d4301f26ad3e5c10de587ab1f9823",
    },
    "ssh-cs": {
        "state/cs/agg":
            "3b4258abd38ca60c82b775c8ca79ce807c2aa59435819114268402f52b940a5a",
        "state/cs/bucket_a":
            "e918c36c5669aa8d9dc8b77e75b34b29de0ba065ead16806f70264f9a0cb80b1",
        "state/cs/bucket_b":
            "60ecf174af4d5331f0355f6a026aedac56bd00d323296ea98d87a8ad17db0e05",
        "state/cs/sign_a":
            "56ff8b82c990b2e30f77afe6688e1add467cbc29dfa8d82df41f86dd60efeaa9",
        "state/cs/sign_b":
            "83fbf4482024bbcd324952465edefe03444093d2bde87a491b2767351492bfa4",
        "state/cws/beta":
            "36df8cb45b5b5fa8febec5493aedd22458a873d50ef612cb4e4cf438de14f6f7",
        "state/cws/log_c":
            "a2a693f164fe8723e9d45d4a916e3730cf5621a47f70d431b9035ade349c3e93",
        "state/cws/log_r":
            "3d04c64c8edfa6b0db8633e701d1cb2204d9622a778d08832d681a9d1f927fe0",
        "state/cws/r":
            "67cf55e89594d04abe272e3bd14daf0fd53e4f6762c309be3c7bf87b6daeb3f1",
        "state/filters":
            "ea2d753034d0574b44eb5800b5e7db0504cb54a99eb1af2a19e9e7cc08ca7174",
        "signatures":
            "aa1941615fa6b274035aa35132c375c066d033bebabb02d7bdaf5eb8e55e7400",
        "band_keys":
            "95a6a8ceb7319d7c37d0fb9af88f1c0b35c7c32d7355f5c287056c75ef56b6a4",
        "multiprobe":
            "16cfd657ad42f56420e0532801dd04867e11a06846c3f1855ff6bf4ba0c76a37",
        "sketch_batch":
            "10ab446d76937eae426e18028a8ab490a8168d248cc1272d5de43687c7266860",
        "heavy_ids":
            "ab1f2a738a1b18e28e45705389429dbea04482c87ccad868768b687bf319ca78",
        "heavy_est":
            "0a6e11cc77a4981ab632b38528fa322747c53f184d894880f49f1fdfd561a852",
    },
}


@pytest.fixture(autouse=True)
def _registry():
    """Encoders a test registers are gone after it."""
    from repro_torch.encoders import registry
    registry.available_encoders()
    saved = dict(registry._ENCODERS)
    yield
    registry._ENCODERS.clear()
    registry._ENCODERS.update(saved)


def _wave(rows=48, m=128, seed=29):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.standard_normal((rows, m)), 1).astype(np.float32)


def _digest(t):
    a = np.ascontiguousarray(t.cpu().numpy() if torch.is_tensor(t)
                             else np.asarray(t))
    return hashlib.sha256(str(a.dtype).encode() + str(a.shape).encode()
                          + a.tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(PIN_SPECS))
def test_seed_state_unchanged(name):
    """Every state leaf the port draws from seed 7, and the signatures,
    band keys, multiprobe signatures (and for ``"ssh-cs"`` the sketch
    and its heavy hitters) of a fixed wave, are bit-identical to the
    digests taken before the refactor (sha256, exact)."""
    enc = make_encoder(IndexSpec(name, PIN_SPECS[name], seed=7), "cpu")
    xs = torch.from_numpy(_wave())
    sigs = enc.encode_batch(xs)
    got = {f"state/{k}": _digest(v) for k, v in enc.state().items()}
    got["signatures"] = _digest(sigs)
    got["band_keys"] = _digest(enc.band_keys(sigs))
    got["multiprobe"] = _digest(enc.encode_batch_multiprobe(xs, 3))
    if name == "ssh-cs":
        agg = enc.sketch_batch(xs)
        got["sketch_batch"] = _digest(agg)
        enc.absorb_sketch(agg)
        ids, est = enc.find_heavy_hitters(8.0)
        got["heavy_ids"], got["heavy_est"] = _digest(ids), _digest(est)
    assert got == PINNED[name]


# -- each stage against the reference's, on the reference's state -----------

SPECS = dict(PIN_SPECS, srp=dict(num_hashes=32, num_tables=8))
M = 128


@pytest.fixture(scope="module")
def pairs():
    """(reference encoder, port encoder holding its state) by name."""
    out = {}
    for name, params in SPECS.items():
        jenc = jax_make_encoder(JaxIndexSpec(name, params, seed=7), length=M)
        out[name] = (jenc, convert.encoder_from_arrays(
            IndexSpec(name, params, seed=7), jenc.arrays(), "cpu"))
    return out


@pytest.fixture(scope="module")
def xs():
    return _wave(rows=40, m=M, seed=5)


def _rows(fn, *args):
    """The reference's per-row ``fn`` over a block, as numpy."""
    return np.asarray(jax.vmap(fn)(*(jnp.asarray(a) for a in args)))


def _bits(enc, xs):
    return enc.sketcher.sketch(torch.from_numpy(xs), enc.state())


@pytest.mark.parametrize("name", ["ssh", "ssh-multires", "ssh-cs"])
def test_sketcher_matches_reference(pairs, xs, name):
    """Sign bits of a block, of one row and through
    ``sketch_batch_pallas`` equal the reference sketcher's (exact)."""
    jenc, enc = pairs[name]
    st, jst = enc.state(), jenc.state()
    want = _rows(lambda x: jenc.sketcher.sketch(x, jst), xs)
    got = enc.sketcher.sketch(torch.from_numpy(xs), st)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        enc.sketcher.sketch(torch.from_numpy(xs[3]), st).numpy(), want[3])
    np.testing.assert_array_equal(
        enc.sketcher.sketch_batch_pallas(torch.from_numpy(xs), st).numpy(),
        want)
    for o in (0, 1, 2):
        assert enc.sketcher.num_bits(o, M) == jenc.sketcher.num_bits(o, M)


@pytest.mark.parametrize("name", ["ssh", "ssh-multires"])
def test_shingler_histograms_match_reference(pairs, xs, name):
    """``histogram`` and ``histogram_masked`` (an int and a per-row
    tensor of valid bits) equal the reference shingler's row by row, and
    ``shingle_ids`` counts to the same histogram (exact)."""
    jenc, enc = pairs[name]
    bits = _bits(enc, xs)
    sh, jsh = enc.shingler, jenc.shingler
    assert (sh.dim, sh.min_bits) == (jsh.dim, jsh.min_bits)
    want = _rows(jsh.histogram, bits.numpy())
    np.testing.assert_array_equal(sh.histogram(bits).numpy(), want)
    np.testing.assert_array_equal(sh.histogram(bits[7]).numpy(), want[7])
    ids = sh.shingle_ids(bits)
    np.testing.assert_array_equal(
        torch.zeros(ids.shape[0], sh.dim + 1, dtype=torch.int32).scatter_add_(
            1, ids, torch.ones_like(ids, dtype=torch.int32))[:, :sh.dim],
        want)
    n_b = bits.shape[1]
    valid = np.array([n_b - (i % 6) * 5 for i in range(len(xs))])
    want_m = np.stack([np.asarray(jsh.histogram_masked(
        jnp.asarray(b), int(v))) for b, v in zip(bits.numpy(), valid)])
    np.testing.assert_array_equal(
        sh.histogram_masked(bits, torch.from_numpy(valid)).numpy(), want_m)
    np.testing.assert_array_equal(
        sh.histogram_masked(bits, int(valid[1])).numpy(),
        _rows(lambda b: jsh.histogram_masked(b, int(valid[1])),
              bits.numpy()))


@pytest.mark.parametrize("name", ["ssh", "ssh-multires", "ssh-cs"])
def test_cws_hasher_matches_reference(pairs, xs, name):
    """``CWSHasher.hash`` on the same counts equals the reference's
    (exact), and ``hash_ids`` on the shingler's entries equals ``hash``
    of the dense counts."""
    jenc, enc = pairs[name]
    st, jst = enc.state(), jenc.state()
    bits = _bits(enc, xs)
    counts = enc.shingler.histogram(bits)
    want = _rows(lambda c: jenc.hasher.hash(c, jst), counts.numpy())
    got = enc.hasher.hash(counts, st)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(enc.hasher.hash(counts[2], st).numpy(),
                                  want[2])
    if name == "ssh-cs":
        dims, weights = enc.shingler.weighted_entries(bits)
        active = enc.hasher.hash_ids(dims, st, weights)
    else:
        active = enc.hasher.hash_ids(enc.shingler.shingle_ids(bits), st)
    np.testing.assert_array_equal(active.numpy(), want)


def test_count_sketch_shingler_matches_reference(pairs, xs):
    """``CountSketchShingler``'s histograms, ids in the -1 convention
    and ``level0_tables`` equal the reference's row by row (exact)."""
    jenc, enc = pairs["ssh-cs"]
    sh, jsh = enc.shingler, jenc.shingler
    bits = _bits(enc, xs)
    b = bits.numpy()
    assert (sh.dim, sh.min_bits, sh.levels, sh.id_bits) == (
        jsh.dim, jsh.min_bits, jsh.levels, jsh.id_bits)
    assert sh.extra_shapes() == jsh.extra_shapes()
    ids = _rows(jsh.shingle_ids, b)
    np.testing.assert_array_equal(sh.shingle_ids(bits).numpy(), ids)
    np.testing.assert_array_equal(sh.shingle_ids_batch(bits).numpy(),
                                  np.asarray(jsh.shingle_ids_batch(
                                      jnp.asarray(b))))
    hist = _rows(jsh.histogram, b)
    np.testing.assert_array_equal(sh.histogram(bits).numpy(), hist)
    np.testing.assert_array_equal(sh.histogram_batch_pallas(bits).numpy(),
                                  hist)
    n_b = bits.shape[1]
    valid = np.array([n_b - (i % 5) * 7 for i in range(len(xs))])
    masked = np.stack([np.asarray(jsh.shingle_ids_masked(jnp.asarray(r),
                                                         int(v)))
                       for r, v in zip(b, valid)])
    np.testing.assert_array_equal(
        sh.shingle_ids_masked(bits, torch.from_numpy(valid)).numpy(), masked)
    np.testing.assert_array_equal(
        sh.histogram_masked(bits, torch.from_numpy(valid)).numpy(),
        np.stack([np.asarray(jsh.histogram_masked(jnp.asarray(r), int(v)))
                  for r, v in zip(b, valid)]))
    tables = _rows(jsh.level0_tables, masked)
    np.testing.assert_array_equal(
        sh.level0_tables(torch.from_numpy(masked)).numpy(), tables)
    np.testing.assert_array_equal(
        sh.level0_tables(torch.from_numpy(masked[0])).numpy(), tables[0])


# -- the composition ---------------------------------------------------------

class _ProtocolOnly:
    """A shingler with the ``Shingler`` protocol's members and nothing
    else: what an out-of-tree stage written to Fig. 5's contract has."""

    def __init__(self, inner):
        self._inner = inner

    @property
    def dim(self):
        return self._inner.dim

    @property
    def min_bits(self):
        return self._inner.min_bits

    def histogram(self, bits):
        return self._inner.histogram(bits)

    def histogram_masked(self, bits, valid_bits):
        return self._inner.histogram_masked(bits, valid_bits)


class _NoHistogram(NgramShingler):
    """The stock n-gram shingler with a dense histogram that raises."""

    def histogram(self, bits):
        raise AssertionError("the dense histogram was formed")

    def histogram_masked(self, bits, valid_bits):
        raise AssertionError("the dense histogram was formed")


def _composed(name, shingler_of):
    """A registered ``PipelineEncoder`` of the ``"ssh"`` params whose
    shingler is ``shingler_of`` the stock one."""
    @register_encoder(name)
    class Composed(PipelineEncoder):
        DEFAULTS = SSHEncoder.DEFAULTS
        validate_params = SSHEncoder.validate_params

        @classmethod
        def _build_stages(cls, spec):
            sk, sh, ha, n_tables = SSHEncoder._build_stages(spec)
            return sk, shingler_of(sh), ha, n_tables
    return Composed


def test_routes_are_chosen_from_the_stages():
    """The stock encoders take the active routes; a protocol-only
    shingler takes the dense one (the route names, exact)."""
    assert make_encoder(IndexSpec("ssh", PIN_SPECS["ssh"]), "cpu").route \
        == "ids"
    assert make_encoder(IndexSpec("ssh-multires", PIN_SPECS["ssh-multires"]),
                        "cpu").route == "ids"
    assert make_encoder(IndexSpec("ssh-cs", PIN_SPECS["ssh-cs"]),
                        "cpu").route == "entries"
    _composed("test-protocol-only", _ProtocolOnly)
    assert make_encoder(IndexSpec("test-protocol-only", PIN_SPECS["ssh"]),
                        "cpu").route == "dense"


@pytest.mark.parametrize("name", ["ssh", "ssh-multires"])
def test_dense_route_equals_the_active_route(name, xs):
    """``hasher.hash(shingler.histogram(...))`` over blocks of
    ``DENSE_CHUNK`` rows gives the active route's signatures and
    multiprobe signatures bit for bit."""
    stock = make_encoder(IndexSpec(name, PIN_SPECS[name], seed=3), "cpu")
    cls = type(stock)

    @register_encoder(f"test-dense-{name}")
    class Dense(cls):
        @classmethod
        def _build_stages(cls_, spec):
            sk, sh, ha, n_tables = cls._build_stages(spec)
            return sk, _ProtocolOnly(sh), ha, n_tables

    dense = make_encoder(IndexSpec(f"test-dense-{name}", PIN_SPECS[name],
                                   seed=3), "cpu")
    assert (stock.route, dense.route) == ("ids", "dense")
    rows = torch.from_numpy(_wave(rows=DENSE_CHUNK + 9, m=M, seed=8))
    assert torch.equal(dense.encode_batch(rows), stock.encode_batch(rows))
    q = torch.from_numpy(xs[:5])
    assert torch.equal(dense.encode_batch_multiprobe(q, 3),
                       stock.encode_batch_multiprobe(q, 3))


def test_the_main_route_never_forms_the_histogram(xs):
    """The ``"ids"`` route reads ``shingle_ids`` only: a shingler whose
    dense histogram raises encodes and multiprobes as ``"ssh"``
    (exact)."""
    _composed("test-no-histogram", lambda sh: _NoHistogram(sh.ngram,
                                                           sh.num_filters))
    enc = make_encoder(IndexSpec("test-no-histogram", PIN_SPECS["ssh"]),
                       "cpu")
    ref = make_encoder(IndexSpec("ssh", PIN_SPECS["ssh"]), "cpu")
    q = torch.from_numpy(xs)
    assert torch.equal(enc.encode_batch(q), ref.encode_batch(q))
    assert torch.equal(enc.encode_batch_multiprobe(q, 3),
                       ref.encode_batch_multiprobe(q, 3))


def test_out_of_tree_pipeline_draws_the_ssh_state_and_serves():
    """A registered ``PipelineEncoder`` of the stock stages draws
    ``SSHEncoder``'s state from the same seed bit for bit, and a database
    built through it answers as the ``"ssh"`` one (ids and signatures
    exact, float32 distances at rtol 1e-6)."""
    _composed("test-stock-stages", lambda sh: sh)
    params = dict(PIN_SPECS["ssh"], num_tables=10)
    ours = make_encoder(IndexSpec("test-stock-stages", params, seed=11),
                        "cpu")
    ssh = make_encoder(IndexSpec("ssh", params, seed=11), "cpu")
    assert ours.state().keys() == ssh.state().keys()
    for k, v in ssh.state().items():
        assert torch.equal(ours.state()[k], v), k
    series = _wave(rows=300, m=M, seed=9)
    cfg = SearchConfig(topk=5, top_c=64, band=6, multiprobe_offsets=3)
    a = TimeSeriesDB.build(series, IndexSpec("test-stock-stages", params,
                                             seed=11), cfg, device="cpu")
    b = TimeSeriesDB.build(series, IndexSpec("ssh", params, seed=11), cfg,
                           device="cpu")
    assert torch.equal(a.index.signatures, b.index.signatures)
    ra, rb = a.search_batch(series[:6]), b.search_batch(series[:6])
    for x, y in zip(ra, rb):
        np.testing.assert_array_equal(x.ids, y.ids)
        np.testing.assert_allclose(x.dists, y.dists, rtol=1e-6)


def test_stage_protocols_answer_as_the_reference():
    """``isinstance`` of every stock stage against the three protocols
    gives the reference's answers (exact); the stock encoders are
    compositions of such stages."""
    port = [GaussianFilterSketcher(24, 3), NgramShingler(8),
            MultiResShingler((6, 8)), CountSketchShingler(8), CWSHasher(20)]
    ref = [jpipe.GaussianFilterSketcher(24, 3), jpipe.NgramShingler(8),
           jpipe.MultiResShingler((6, 8)), jstream.CountSketchShingler(8),
           jpipe.CWSHasher(20)]
    protos = ((Sketcher, jbase.Sketcher), (Shingler, jbase.Shingler),
              (Hasher, jbase.Hasher))
    got = [[isinstance(s, p) for p, _ in protos] for s in port]
    want = [[isinstance(s, p) for _, p in protos] for s in ref]
    assert got == want
    assert isinstance(_ProtocolOnly(NgramShingler(8)), Shingler)
    for name, cls in (("ssh", SSHEncoder), ("ssh-cs", StreamingSSHEncoder)):
        enc = make_encoder(IndexSpec(name, PIN_SPECS[name]), "cpu")
        assert isinstance(enc, PipelineEncoder) and isinstance(enc, cls)
        assert isinstance(enc.sketcher, Sketcher)
        assert isinstance(enc.shingler, Shingler)
        assert isinstance(enc.hasher, Hasher)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_pure_encode_fn_matches_reference(pairs, xs, name):
    """``pure_encode_fn()(x, state)`` on the carried state equals the
    reference's row by row and ``encode_batch`` (exact)."""
    jenc, enc = pairs[name]
    fn, jfn = enc.pure_encode_fn(), jenc.pure_encode_fn()
    jst = jenc.state()
    want = _rows(lambda x: jfn(x, jst), xs)
    got = fn(torch.from_numpy(xs), enc.state())
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        fn(torch.from_numpy(xs[4]), enc.state()).numpy(), want[4])
    assert torch.equal(got, enc.encode_batch(torch.from_numpy(xs)))


def test_the_base_encoder_has_no_pure_encode_fn():
    """As the reference's base (``encoders/base.py:267``)."""
    with pytest.raises(NotImplementedError):
        Encoder(IndexSpec()).pure_encode_fn()
    with pytest.raises(NotImplementedError):
        jbase.Encoder(JaxIndexSpec()).pure_encode_fn()


def test_stage_methods_refuse_other_ranks():
    """A stage takes a block or one row, and refuses any other rank with
    a ``ValueError`` instead of guessing."""
    enc = make_encoder(IndexSpec("ssh", PIN_SPECS["ssh"]), "cpu")
    with pytest.raises(ValueError, match="block of 2 axes"):
        enc.sketcher.sketch(torch.zeros(2, 3, M), enc.state())
    with pytest.raises(ValueError, match="block of 3 axes"):
        enc.shingler.histogram(torch.zeros(2, 2, 40, 1, dtype=torch.uint8))
    with pytest.raises(ValueError, match="block of 2 axes"):
        enc.hasher.hash(torch.zeros(2, 2, enc.dim, dtype=torch.int32),
                        enc.state())

"""The plain reference against the port on the CPU (plain versions), at a
tiny size of both configurations: the encoder's state, database and
multiprobe query signatures, top-C candidates and the top-10 answers."""
import json

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench.data import series
from portbench.reference import judge, ssh
from repro_torch.core import dtw as port_dtw
from repro_torch.db import SearchConfig, TimeSeriesDB
from repro_torch.encoders import IndexSpec

pytestmark = pytest.mark.torch_port


def _config(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())


def _db(cfg, n=1500, m=256, seed=5, top_c=64):
    stream = torch.from_numpy(series.make_stream(cfg, n + m - 1 + 600, seed))
    win = series.windows(stream, m, n)
    held = series.windows(stream[n + m - 1:], m, 40, stride=7)
    spec = IndexSpec(encoder="ssh", params=cfg["params"],
                     seed=cfg["spec_seed"])
    sc = SearchConfig(topk=10, top_c=top_c, band=max(4, m // 20),
                      multiprobe_offsets=cfg["multiprobe_offsets"],
                      stage_timings=False)
    db = TimeSeriesDB.build(win, spec=spec, config=sc, device="cpu")
    return db, win, held, sc


@pytest.mark.parametrize("name", ["ssh-ecg", "ssh-randomwalk"])
def test_encoder_state_drawn_again(name):
    cfg = _config(name)
    db, *_ = _db(cfg, n=300)
    st = ssh.encoder_state(cfg["params"], cfg["spec_seed"], "cpu")
    state = db.index.encoder._require_state()
    assert torch.equal(st.filters, state["filters"][:, 0])
    assert torch.equal(st.r, state["cws/r"])
    assert torch.equal(st.log_c, state["cws/log_c"])
    assert torch.equal(st.beta, state["cws/beta"])


@pytest.mark.parametrize("name", ["ssh-ecg", "ssh-randomwalk"])
def test_signatures_candidates_and_answers(name):
    cfg = _config(name)
    db, win, held, sc = _db(cfg)
    st = ssh.encoder_state(cfg["params"], cfg["spec_seed"], "cpu")
    # database signatures: every row a valid hash; rows with no free bit
    # equal the reference's own
    jd = ssh.judge_signatures(win, db.index.signatures, st)
    assert jd.off == 0 and jd.unsettled == 0
    proj, free = ssh.projections(win, st)
    fixed = ~free.any(1)
    own = ssh.signatures((proj >= 0).to(torch.uint8), st)
    assert fixed.float().mean() > 0.9
    assert torch.equal(own[fixed], db.index.signatures[fixed])
    # query signatures at every multiprobe offset
    o = sc.multiprobe_offsets
    qs = held[:16]
    prog_q = db.index.query_signatures_batch_multiprobe(qs, o)
    jq = ssh.judge_queries(qs, prog_q, st, o)
    assert jq.off == 0
    # candidates and answers, judged as a run judges them
    from repro_torch.serving.batched import batch_probe
    ids, vals = batch_probe(qs, db.index, sc.top_c,
                            multiprobe_offsets=o)
    res = db.search_batch(qs.numpy())
    out = judge.Outputs(db_sigs=db.index.signatures, q_sigs=prog_q,
                        topc_ids=ids, topc_vals=vals,
                        ids=[r.ids for r in res], dists=[r.dists for r in res])
    cfgj = judge.Cfg(params=cfg["params"], seed=cfg["spec_seed"],
                     top_c=sc.top_c, topk=10, band=sc.band, offsets=o)
    got = judge.judge(win, qs, out, cfgj)["checks"]
    assert got["sig_rows_off"] == 0
    assert got["topc_off"] == 0
    assert got["topk_off"] == 0
    assert got["dtw_gap"] < 1e-5
    # the reference's own top-C equals the port's, id for id
    ref_ids, ref_cnt = judge._candidates(jq.accepted,
                                         jd.accepted.t().contiguous(),
                                         sc.top_c)
    assert torch.equal(ref_cnt, vals)
    pos = vals > 0
    assert torch.equal(ref_ids[pos], ids[pos])


@pytest.mark.parametrize("radius", [3, 12, 255])
def test_dtw_reference_matches_port(radius):
    g = torch.Generator().manual_seed(radius)
    q = torch.randn((20, 256), generator=g)
    x = torch.randn((20, 256), generator=g)
    mine = ssh.dtw(q, x, radius)
    port = port_dtw.dtw_banded_pairs(q, x, radius).to(torch.float64)
    np.testing.assert_allclose(mine.numpy(), port.numpy(), rtol=2e-6)


def test_free_bits_cover_float32_orders():
    """A bit the reference fixes comes out the same in float32 under any
    summation order tried; the free bits are rare."""
    cfg = _config("ssh-ecg")
    st = ssh.encoder_state(cfg["params"], cfg["spec_seed"], "cpu")
    stream = torch.from_numpy(series.make_stream(cfg, 3000, 9))
    win = series.windows(stream, 256, 2000)
    proj, free = ssh.projections(win, st)
    unf = win.unfold(1, st.window, st.step)
    f = st.filters
    forward = torch.zeros(unf.shape[:2])
    for w in range(st.window):
        forward = forward + unf[..., w] * f[w]
    backward = torch.zeros(unf.shape[:2])
    for w in reversed(range(st.window)):
        backward = backward + unf[..., w] * f[w]
    for p32 in (forward, backward, unf @ f):
        assert torch.equal((p32 >= 0)[~free], (proj >= 0)[~free])
    assert free.float().mean() < 1e-3


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -3.0 - 2 ** -12])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 * 2 ** -10, -3.0])
    assert torch.equal(ssh.tf32(x), want)

"""The check fails what it must.  A tiny cell runs on the CPU through the
whole of a run but the look for a card; with the timed path broken
underneath, ``correct`` comes out false, once for each fault a search
cell can have: a hash, a candidate or a distance altered where it is
produced, and half of a block left unanswered.  The control (the
reference at TF32 in the program's place) fails the check too."""
import time

import numpy as np
import pytest
import torch

from portbench import harness, spec
from portbench.reference import judge
from portbench.run import run_cell

pytestmark = pytest.mark.torch_port


def _run(root, cell="tiny-bulk", seed=21):
    return run_cell(cell, seed, 0.6, False, device="cpu", root=root,
                    t_start=time.perf_counter())


def _alter_hash(monkeypatch):
    from repro_torch.encoders.pipeline import PipelineEncoder
    orig = PipelineEncoder.encode_batch_multiprobe

    def bad(self, qs, offsets, **kw):
        out = orig(self, qs, offsets, **kw).clone()
        out[:, -1, 0] += 1
        return out
    monkeypatch.setattr(PipelineEncoder, "encode_batch_multiprobe", bad)


def _alter_candidate(monkeypatch):
    from repro_torch.serving import batched
    orig = batched.top_c_by_count

    def bad(counts, c):
        ids, vals = orig(counts, c)
        ids = ids.clone()
        ids[:, c // 2] = (ids[:, c // 2] + 1) % counts.shape[1]
        return ids, vals
    monkeypatch.setattr(batched, "top_c_by_count", bad)


def _alter_distance(monkeypatch):
    from repro_torch.core import rerank
    orig = rerank.dtw_pairs

    def bad(q, x, band, thr=None):
        return orig(q, x, band, thr) * (1.0 + 1e-3)
    monkeypatch.setattr(rerank, "dtw_pairs", bad)


def _drop_half(monkeypatch):
    from repro_torch.serving.batched import BatchSearchResult
    orig = BatchSearchResult.per_query

    def bad(self, b):
        res = orig(self, b)
        if b % 2:
            res.ids, res.dists = res.ids[:0], res.dists[:0]
        return res
    monkeypatch.setattr(BatchSearchResult, "per_query", bad)


def test_a_sound_run_is_correct(tiny_root):
    line = _run(tiny_root)
    assert line["correct"] is True
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    assert list(line)[-2:] == ["checks", "_log"]


@pytest.mark.parametrize("fault, number", [
    (_alter_hash, "sig_rows_off"), (_alter_candidate, "topc_off"),
    (_alter_distance, "dtw_gap"), (_drop_half, "topk_off")])
@pytest.mark.parametrize("cell", ["tiny-bulk", "tiny-serve"])
def test_a_broken_path_is_not_correct(tiny_root, monkeypatch, fault, number,
                                      cell):
    fault(monkeypatch)
    line = _run(tiny_root, cell)
    assert line["correct"] is False
    c = line["checks"][number]
    assert c["value"] > c["limit"], line["checks"]


def test_the_control_is_not_correct(tiny_root):
    """The reference at TF32 in the program's place, judged as a run is:
    some number is past its limit."""
    cell = spec.cell("tiny-bulk", tiny_root)
    cfg = judge.Cfg.of(cell.config, cell.band)
    h = harness.Harness(cell, 5, 0.3, False, torch.device("cpu"), 0.0)
    h.make_data(0)
    rng = np.random.default_rng(0)
    qs = torch.from_numpy(h.pool.rows[rng.choice(len(h.pool.rows), 12,
                                                 replace=False)])
    ctrl = judge.control_outputs(h.windows, qs, cfg)
    got = judge.judge(h.windows, qs, ctrl, cfg)["checks"]
    limits = cell.traffic["limits"]
    assert any(got[k] > limits[k] for k in limits), got
    assert got["sig_rows_off"] > 0

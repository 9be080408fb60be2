"""The comparison that decides ``correct``, and its control.

What the timed path produced for a sample of the window's queries is
held to the plain reference (``reference.ssh``), stage by stage:

* ``sig_rows_off``: database rows and sampled query offsets whose
  signature is no valid hash of the row (encode; limit 0);
* ``topc_off``: sampled queries whose candidates (the top-C rows by
  count, ties to the lowest id, count > 0) differ from the reference's,
  rows and counts (probe; limit 0);
* ``topk_off``: sampled queries whose answer holds a row outside the
  reference's candidates, or fewer rows than min(k, candidates) (re-rank;
  limit 0);
* ``dtw_gap``: the widest gap over the sampled answers, relative to the
  reference's k-th best distance (at least 1), by which a returned
  distance lies off the float64 DTW of its row, or that row's float64
  DTW lies above the reference's k-th best (re-rank; a limit set from
  readings).

The control (:func:`control_outputs`) is the reference put in the
program's place one precision below the configuration's float32: TF32
(inputs rounded to a 10-bit significand, float32 sums) for the sketch's
projections and the DTW.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.reference import ssh

#: the names of the numbers compared, in the order they are printed
CHECKS = ("sig_rows_off", "topc_off", "topk_off", "dtw_gap")


@dataclasses.dataclass
class Outputs:
    """What a searcher produced for S sampled queries."""
    db_sigs: Optional[torch.Tensor]  # (N, K) the database's signatures
    q_sigs: torch.Tensor             # (S, O, K)
    topc_ids: torch.Tensor           # (S, C) int64
    topc_vals: torch.Tensor          # (S, C) int32
    ids: List[np.ndarray]            # S answers, best first
    dists: List[np.ndarray]


@dataclasses.dataclass
class Cfg:
    params: Dict
    seed: int
    top_c: int
    topk: int
    band: int
    offsets: int

    @classmethod
    def of(cls, config: Dict, band: int) -> "Cfg":
        return cls(params=config["params"], seed=int(config["spec_seed"]),
                   top_c=int(config["top_c"]), topk=int(config["topk"]),
                   band=band, offsets=int(config["multiprobe_offsets"]))


def _candidates(qsig: torch.Tensor, db_t: torch.Tensor, c: int,
                group: int = 8):
    """Each query's top-C (ids, counts) over the database, (S, c) each."""
    ids, cnt = [], []
    for lo in range(0, qsig.shape[0], group):
        got = ssh.top_c(ssh.counts(qsig[lo:lo + group], db_t), c)
        ids.append(got[0])
        cnt.append(got[1])
    return torch.cat(ids), torch.cat(cnt)


def _valid_sets(ids: torch.Tensor, cnt: torch.Tensor):
    """Per query the candidate rows: count > 0, or the first C ids when no
    row has a positive count (the program's fallback)."""
    out = []
    for i, c in zip(ids.cpu().numpy(), cnt.cpu().numpy()):
        keep = c > 0
        out.append((i[keep], c[keep]) if keep.any()
                   else (np.arange(len(i)), np.zeros(len(i), c.dtype)))
    return out


def _pairs_dtw(windows: torch.Tensor, queries: torch.Tensor,
               rows: List[np.ndarray], radius: int, dtype=torch.float64,
               precision: str = "exact", block: int = 32768
               ) -> List[torch.Tensor]:
    """DTW of query s against each of ``rows[s]``, one list entry a
    query."""
    dev = windows.device
    qi = np.concatenate([np.full(len(r), s) for s, r in enumerate(rows)]
                        ).astype(np.int64)
    ri = np.concatenate(rows).astype(np.int64)
    out = []
    for lo in range(0, len(ri), block):
        q = queries[torch.from_numpy(qi[lo:lo + block]).to(dev)]
        x = windows[torch.from_numpy(ri[lo:lo + block]).to(dev)]
        if precision == "tf32":
            q, x = ssh.tf32(q), ssh.tf32(x)
        out.append(ssh.dtw(q, x, radius, dtype))
    d = torch.cat(out) if out else torch.zeros(0, dtype=dtype, device=dev)
    return list(torch.split(d, [len(r) for r in rows]))


def judge(windows: torch.Tensor, queries: torch.Tensor, prog: Outputs,
          cfg: Cfg, st: Optional[ssh.State] = None,
          db_judged: Optional[ssh.SigJudgement] = None) -> Dict:
    """The numbers of :data:`CHECKS` for ``prog`` against the reference,
    with ``info`` (free rows, unsettled rows, seconds).  ``windows`` (N,
    m) and ``queries`` (S, m) on the device the reference runs on."""
    t0 = time.perf_counter()
    st = st or ssh.encoder_state(cfg.params, cfg.seed, windows.device)
    jd = db_judged or ssh.judge_signatures(windows, prog.db_sigs, st)
    jq = ssh.judge_queries(queries, prog.q_sigs, st, cfg.offsets)
    db_t = jd.accepted.t().contiguous()
    c = min(cfg.top_c, windows.shape[0])
    ref_ids, ref_cnt = _candidates(jq.accepted, db_t, c)
    del db_t
    ref = _valid_sets(ref_ids, ref_cnt)
    got = _valid_sets(prog.topc_ids, prog.topc_vals)
    topc_off = 0
    for (ri, rc), (gi, gc) in zip(ref, got):
        a = sorted(zip(ri.tolist(), rc.tolist()))
        b = sorted(zip(gi.tolist(), gc.tolist()))
        topc_off += a != b
    cand = [ri for ri, _ in ref]
    d_ref = _pairs_dtw(windows, queries, cand, cfg.band)
    d_got = _pairs_dtw(windows, queries,
                       [np.asarray(i, np.int64) for i in prog.ids], cfg.band)
    topk_off, gap = 0, 0.0
    for s, rows in enumerate(cand):
        ids = np.asarray(prog.ids[s], np.int64)
        want = min(cfg.topk, len(rows))
        best = torch.sort(d_ref[s]).values[:want].cpu().numpy()
        if len(ids) != want or not np.isin(ids, rows).all():
            topk_off += 1
        n = min(len(ids), want)
        if n == 0:
            continue
        mine = d_got[s][:n].cpu().numpy()
        told = np.asarray(prog.dists[s][:n], np.float64)
        scale = np.maximum(best[:n], 1.0)
        g = np.maximum(np.abs(told - mine), mine - best[:n]) / scale
        gap = max(gap, float(g.max()))
    return dict(
        checks=dict(sig_rows_off=jd.off + jq.off, topc_off=int(topc_off),
                    topk_off=int(topk_off), dtw_gap=gap),
        info=dict(free_rows=jd.free_rows + jq.free_rows,
                  unsettled_rows=jd.unsettled + jq.unsettled,
                  sampled=int(queries.shape[0]),
                  reference_s=time.perf_counter() - t0))


def control_outputs(windows: torch.Tensor, queries: torch.Tensor, cfg: Cfg,
                    st: Optional[ssh.State] = None,
                    rows_a_block: int = 16384) -> Outputs:
    """The reference in the program's place at TF32: its signatures,
    candidates and answers for ``queries``."""
    st = st or ssh.encoder_state(cfg.params, cfg.seed, windows.device)

    def sigs(x: torch.Tensor) -> torch.Tensor:
        out = []
        for lo in range(0, x.shape[0], rows_a_block):
            proj, _ = ssh.projections(x[lo:lo + rows_a_block], st, "tf32")
            out.append(ssh.signatures((proj >= 0).to(torch.uint8), st))
        return torch.cat(out)

    db = sigs(windows)
    qs = torch.stack([sigs(x) for x in ssh.query_rows(queries, cfg.offsets)],
                     1)
    db_t = db.t().contiguous()
    c = min(cfg.top_c, windows.shape[0])
    tids, tvals = _candidates(qs, db_t, c)
    del db_t
    cand = [i for i, _ in _valid_sets(tids, tvals)]
    d = _pairs_dtw(windows, queries, cand, cfg.band, torch.float32, "tf32")
    ids, dists = [], []
    for rows, dd in zip(cand, d):
        order = torch.sort(dd, stable=True).indices[:cfg.topk].cpu().numpy()
        ids.append(rows[order])
        dists.append(dd.cpu().numpy()[order])
    return Outputs(db_sigs=db, q_sigs=qs, topc_ids=tids, topc_vals=tvals,
                   ids=ids, dists=dists)

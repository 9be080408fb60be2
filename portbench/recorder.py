"""What the timed path produces, kept for the check after the window.

The facade answers with each query's top-k alone; the check also holds
the query signatures and the candidates to the reference.  So, for the
run, the recorder wraps three calls of the program and keeps what they
return, with no device work of its own:

* ``serving.batched.batch_probe`` (encode and probe of a block): its
  (ids, counts) candidates, with the block's row of each query it knows;
* the index encoder's ``encode_batch_multiprobe`` and ``encode_batch``
  (the query signatures the probe just computed, on the same thread);
* ``serving.batched.ssh_search_batch`` (a block, its ``SearchStats``):
  the stage seconds and re-rank counters of every batch.

A query is known by the leading bytes of its row (``data.series.Pool``),
which the probe receives as the signature cache's keys.  The engine pads
a batch by repeating its first query; a query keeps its first record.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


class Recorder:
    def __init__(self, index, key: Callable[[bytes], Optional[int]]):
        self.index = index
        self.key = key
        #: query -> (ids (B, C), counts (B, C), signatures (B, O, K), row)
        self.probes: Dict[int, Tuple] = {}
        #: (host time at return, SearchStats) a block
        self.batches: List[Tuple[float, object]] = []
        self._local = threading.local()
        self._undo: List[Callable[[], None]] = []

    def install(self) -> "Recorder":
        from repro_torch.serving import batched
        enc = self.index.encoder
        probe, search = batched.batch_probe, batched.ssh_search_batch
        multi, single = enc.encode_batch_multiprobe, enc.encode_batch

        def batch_probe(queries, index, top_c, *args, **kwargs):
            self._local.sigs = None
            ids, vals = probe(queries, index, top_c, *args, **kwargs)
            contents = kwargs.get("contents")
            if contents is None:
                from repro_torch.encoders.sigcache import row_bytes
                contents = row_bytes(queries)
            sigs = self._local.sigs
            for row, content in enumerate(contents):
                q = self.key(content)
                if q is not None and q not in self.probes:
                    self.probes[q] = (ids, vals, sigs, row)
            return ids, vals

        def encode_multi(qs, offsets, **kwargs):
            out = multi(qs, offsets, **kwargs)
            self._local.sigs = out
            return out

        def encode_single(xs, **kwargs):
            out = single(xs, **kwargs)
            self._local.sigs = out[:, None, :]
            return out

        def ssh_search_batch(*args, **kwargs):
            res = search(*args, **kwargs)
            self.batches.append((time.perf_counter(), res.stats))
            return res

        batched.batch_probe = batch_probe
        batched.ssh_search_batch = ssh_search_batch
        enc.encode_batch_multiprobe = encode_multi
        enc.encode_batch = encode_single

        def undo() -> None:
            batched.batch_probe = probe
            batched.ssh_search_batch = search
            del enc.encode_batch_multiprobe
            del enc.encode_batch
        self._undo.append(undo)
        return self

    def uninstall(self) -> None:
        while self._undo:
            self._undo.pop()()

    def outputs(self, qids: np.ndarray):
        """The sampled queries' signatures (S, O, K), candidate ids and
        counts (S, C), on the device they were made on; queries the
        recorder never saw are left out and listed."""
        import torch
        sigs, ids, vals, missing = [], [], [], []
        for q in qids.tolist():
            rec = self.probes.get(q)
            if rec is None or rec[2] is None:
                missing.append(q)
                continue
            i, v, s, row = rec
            sigs.append(s[row])
            ids.append(i[row])
            vals.append(v[row])
        if not sigs:
            return None, None, None, missing
        return (torch.stack(sigs).clone(), torch.stack(ids).clone(),
                torch.stack(vals).clone(), missing)

"""A tiny cell on the card, traced: the profiler span, its device
records and the per-layer readers that need them.  Skips without a
CUDA device (decided in the ``cuda`` fixture)."""
import json
import time

import pytest

from conftest import make_tiny
from portbench.run import run_cell

pytestmark = pytest.mark.torch_port


def test_a_traced_tiny_cell_on_the_card(cuda, tmp_path):
    root = make_tiny(tmp_path)
    pb = root / "portbench"
    # the card serves the tiny cell fast: more rows, full blocks, a pool
    # of 4 x 10,000 queries a second, half of them warped database rows
    config = json.loads((pb / "configs" / "tiny-ecg.json").read_text())
    config["n_subsequences"] = 65536
    (pb / "configs" / "tiny-ecg.json").write_text(json.dumps(config))
    traffic = json.loads((pb / "workloads" / "tiny-bulk.json").read_text())
    traffic.update(block=64, sample=64)
    traffic["pool"]["pool_qps"] = 10000
    (pb / "workloads" / "tiny-bulk.json").write_text(json.dumps(traffic))
    line = run_cell("tiny-bulk", 17, 3.0, True, device="cuda", root=root,
                    t_start=time.perf_counter())
    assert line["correct"] is True, line["checks"]
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert 0 < dev["busy_s"] <= dev["window_s"]
    got = line["metrics"]
    for name in ("encode_ms", "probe_ms", "rerank_ms", "rerank.dtw_pair_frac",
                 "kernel.dtw_wavefront_pairs.ms", "device_idle_frac.bulk"):
        assert name in got, sorted(got)
    roof = got.get("collision_count_batch_roofline")
    assert roof is None or 0 < roof["value"] <= 105
    assert line["breakdown"]["device_ops"]

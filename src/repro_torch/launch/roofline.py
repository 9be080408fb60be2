"""Roofline table: the dry run's reports, the analytic MODEL_FLOPS and,
where the card timed a cell, its share of the peak (counterpart of
``repro.launch.roofline``).

The reference's terms come from compiled HLO (executed dot FLOPs,
bytes accessed, collective payloads).  The port compiles nothing, so
its terms are reckoned from the dry run's report (``launch.dryrun``)
with the H100's peaks (``launch.hlo_analysis``):

  compute_s    = MODEL_FLOPS / (chips · 989 TFLOP/s)
  memory_s     = the step's argument bytes read once / (chips · 3.35 TB/s)
                 (a lower bound: temporaries are not counted)
  collective_s = 0 (no partitioned program; NCCL kernels are counted by
                 ``hlo_analysis.collective_stats`` where a run has them)

and the roofline fraction is the one a measurement gives: where a
measured device time of the cell exists (``chip_smoke.py`` writes them,
at its own batch, to a JSON list read with ``--measured``),
``roofline_frac`` = MODEL_FLOPS of that run / (seconds x chips x peak);
otherwise the predicted one, MODEL_FLOPS / (chips x peak) / max(term).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.launch.dryrun import REPORT_DIR
from repro_torch.launch.hlo_analysis import (HBM_BW, ICI_BW,
                                             PEAK_FLOPS_BF16)

OUT = REPORT_DIR.parent / "roofline.md"


def load_reports(report_dir: Path = REPORT_DIR) -> List[Dict]:
    return [json.loads(p.read_text())
            for p in sorted(Path(report_dir).glob("*.json"))]


def measured_frac(model_flops: float, seconds: float,
                  n_chips: int = 1) -> float:
    """Share of the bf16 peak a run sustained: MODEL_FLOPS of the run
    over its measured time."""
    return model_flops / (seconds * n_chips * PEAK_FLOPS_BF16)


def load_measured(path: Optional[Path]) -> Dict[tuple, Dict]:
    """``[{"arch", "shape", "model_flops", "seconds", "n_chips"?,
    ...}, ...]`` keyed by (arch, shape); {} without a file."""
    if path is None or not Path(path).exists():
        return {}
    return {(m["arch"], m["shape"]): m
            for m in json.loads(Path(path).read_text())}


def enrich(rep: Dict, measured: Optional[Dict] = None) -> Dict:
    mf = rep["model_flops"]
    n = rep["n_chips"]
    compute_s = mf / (n * PEAK_FLOPS_BF16)
    memory_s = rep["roofline"]["memory_s"]
    collective_s = rep["roofline"].get("collective_s", 0.0)
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", collective_s), key=lambda kv: kv[1])
    step_s = max(compute_s, memory_s, collective_s)
    rep.update({
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "dominant": dominant[0],
        "measured_s": None,
        "roofline_frac": compute_s / step_s if step_s > 0 else 0.0,
        "frac_source": "predicted",
    })
    if measured is not None:
        rep["measured_s"] = measured["seconds"]
        rep["roofline_frac"] = measured_frac(
            measured["model_flops"], measured["seconds"],
            measured.get("n_chips", 1))
        rep["frac_source"] = "measured"
    return rep


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def table(reports: List[Dict], mesh: str = "single") -> str:
    rows = [r for r in reports if r["mesh"] == mesh]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    chips = rows[0]["n_chips"] if rows else 0
    lines = [
        f"### Roofline — {mesh} mesh ({chips} chips, H100 peaks)",
        "",
        "| arch | shape | kind | MODEL FLOPs | args/device | "
        "compute | memory* | collective | dominant | measured | "
        "roofline frac |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        meas = "—" if r["measured_s"] is None else fmt_s(r["measured_s"])
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['kind']} "
            f"| {r['model_flops']:.2e} "
            f"| {r['memory']['argument_bytes'] / 1e9:.2f} GB "
            f"| {fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} "
            f"| {fmt_s(r['collective_s'])} | {r['dominant']} "
            f"| {meas} | {r['roofline_frac']:.3f} "
            f"({r['frac_source']}) |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--report-dir", default=str(REPORT_DIR))
    ap.add_argument("--measured", default=None,
                    help="JSON list of measured cells (chip_smoke.py's)")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    measured = load_measured(args.measured)
    reports = [enrich(r, measured.get((r["arch"], r["shape"]))
                      if r["mesh"] == "local" else None)
               for r in load_reports(Path(args.report_dir))]
    meshes = sorted({r["mesh"] for r in reports})
    md = []
    for m in meshes:
        md += [table(reports, m), ""]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("\n".join(md) + "\n")
    print("\n".join(md))
    print(f"wrote {args.out} ({len(reports)} cells; HBM {HBM_BW:.3g} B/s, "
          f"link {ICI_BW:.3g} B/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""CLI: validate BENCH_*.json files against the schema (counterpart of
``repro.bench.validate``).

  PYTHONPATH=src python -m repro_torch.bench.validate reports/bench/BENCH_*.json

Exits nonzero on an invalid (or stage-breakdown-less) report.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.bench.schema import (SchemaError, has_full_stage_breakdown,
                                      validate_report)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("files", nargs="+", help="BENCH_*.json paths")
    ap.add_argument("--no-require-stages", action="store_true",
                    help="skip the full-stage-breakdown requirement")
    args = ap.parse_args(argv)
    rc = 0
    for path in args.files:
        try:
            with open(path) as f:
                doc = json.load(f)
            validate_report(doc)
        except (OSError, json.JSONDecodeError, SchemaError) as exc:
            print(f"INVALID {path}: {exc}")
            rc = 1
            continue
        if not args.no_require_stages and not has_full_stage_breakdown(doc):
            print(f"INVALID {path}: no result carries the full "
                  "encode/probe/lb/dtw stage breakdown")
            rc = 1
            continue
        print(f"ok      {path}: {len(doc['results'])} results "
              f"(scale={doc['scale']}, sha={doc['git_sha'][:9] or 'n/a'})")
    return rc


if __name__ == "__main__":
    sys.exit(main())

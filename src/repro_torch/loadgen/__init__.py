"""Synthetic traffic and the open-loop load harness (counterpart of
``repro.loadgen``; DESIGN.md §12).

Public API:
  poisson_arrivals / mmpp_arrivals / diurnal_arrivals / make_arrivals
      — seeded arrival-time generators (ARRIVAL_PROCESSES registry)
  Mixture / WorkloadSpec / RequestTrace / generate_trace
      — declarative workload → replayable per-request trace
  run_trace / sweep / LoadResult
      — drive a live ServingEngine, measure coordinated-omission-safe
        latency, derive max_sustainable_qps over an offered-load ladder
"""
from repro_torch.loadgen.arrivals import (ARRIVAL_PROCESSES,
                                         diurnal_arrivals, make_arrivals,
                                         mmpp_arrivals, poisson_arrivals)
from repro_torch.loadgen.harness import LoadResult, run_trace, sweep
from repro_torch.loadgen.workload import (Mixture, RequestTrace,
                                         WorkloadSpec, generate_trace)

__all__ = [
    "ARRIVAL_PROCESSES", "poisson_arrivals", "mmpp_arrivals",
    "diurnal_arrivals", "make_arrivals",
    "Mixture", "WorkloadSpec", "RequestTrace", "generate_trace",
    "LoadResult", "run_trace", "sweep",
]

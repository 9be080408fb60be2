"""Core SSH math: sketch, shingle, CWS, DTW, lower bounds, index,
re-rank, search.

The reference's public API (``repro.core``), loaded on first use so
that importing a submodule does not load the search stack:
  SSHParams, SSHFunctions, SSHIndex   — index construction
  ssh_search / ucr_search / srp_search / brute_force_topk — query paths
  dtw_batch, znormalize               — similarity measure

``repro_torch.core.dtw`` stays the module: the reference's ``repro.core``
binds the name to the function, which hides the module from ``from
repro.core import dtw``; here the function is ``core.dtw.dtw``.
"""
_LAZY = {
    **{name: "repro_torch.core.dtw" for name in (
        "dtw_batch", "dtw_pairwise", "dtw_distance", "znormalize")},
    **{name: "repro_torch.core.index" for name in (
        "SSHParams", "SSHFunctions", "SSHIndex", "build_signatures",
        "band_keys", "signature_collisions", "probe_topc",
        "signature_collisions_batch", "probe_topc_batch")},
    "SearchStats": "repro_torch.core.rerank",
    **{name: "repro_torch.core.search" for name in (
        "SearchResult", "hash_probe", "ssh_search", "ucr_search",
        "srp_search", "brute_force_topk", "precision_at_k", "ndcg_at_k")},
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib
        value = getattr(importlib.import_module(_LAZY[name]), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

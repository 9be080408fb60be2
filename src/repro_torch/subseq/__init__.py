"""repro_torch.subseq — sliding-window subsequence search over one long
stream (counterpart of ``repro.subseq``; DESIGN.md §10).

Build once with the rolling encode (one shared sketch, CWS over each
window's active shingles), search with the probe → cascade → DTW
pipeline over windows gathered from the stream, grow with
``extend_stream``::

    from repro_torch.subseq import SubsequenceIndex
    idx = SubsequenceIndex.build(stream, spec, length=128, hop=4)
    res = idx.search(query, config)     # res.offsets — match positions

The facade's entry points are ``repro_torch.db.TimeSeriesDB``'s
``build_stream`` / ``search_subsequence`` / ``extend_stream``.
"""
from repro_torch.subseq.index import SubsequenceIndex, SubsequenceResult
from repro_torch.subseq.persistence import (is_subseq_dir, load_subseq,
                                            save_subseq)
from repro_torch.subseq.rolling import (delta_histograms, global_shingle_ids,
                                        num_windows, rolling_signatures,
                                        rolling_sketch_bits)

__all__ = [
    "SubsequenceIndex", "SubsequenceResult",
    "rolling_signatures", "rolling_sketch_bits", "global_shingle_ids",
    "delta_histograms", "num_windows",
    "save_subseq", "load_subseq", "is_subseq_dir",
]

"""Core SSH math: sketch, shingle, CWS, DTW, lower bounds, index,
re-rank."""

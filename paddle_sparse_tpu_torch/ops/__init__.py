"""Sparse operators: index conversions, SpMM entry points, segment
reductions, SpGEMM planning and neighbour sampling."""

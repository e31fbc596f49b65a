"""Sparse operators: index conversions, SpMM and segment reductions."""

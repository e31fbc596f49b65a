"""Sparse operators: index conversions and SpMM."""

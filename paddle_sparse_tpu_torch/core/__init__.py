"""Padded static-capacity sparse matrix core and SpGEMM on it."""
from .matrix import PaddedCOO, padded_coo_from_jax
from .spgemm import (SpGEMMResult, matmul_padded, spspmm_padded,
                     spspmm_rowblocked, spspmm_rowsorted)

__all__ = ["PaddedCOO", "SpGEMMResult", "matmul_padded", "padded_coo_from_jax",
           "spspmm_padded", "spspmm_rowblocked", "spspmm_rowsorted"]

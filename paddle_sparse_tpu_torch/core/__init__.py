"""Padded static-capacity sparse matrix core."""
from .matrix import PaddedCOO

__all__ = ["PaddedCOO"]

"""Test-matrix helpers (port of ``paddle_sparse_tpu/testing.py``).

The dtype grid of the reference's tests: float16/32/64, bfloat16 and
int32/64 (all available in torch, so none is skipped), and its devices, the
CPU and the card; :func:`maybe_skip_testing` skips a case on ``"cuda"``
where there is no card, when the test runs, not when it is collected;
:func:`set_testing_device` makes a device the default for new tensors, as
the reference's makes one JAX's default device.
"""
from typing import List

import pytest
import torch

dtypes: List[torch.dtype] = [torch.float16, torch.bfloat16, torch.float32,
                             torch.float64, torch.int32, torch.int64]
grad_dtypes: List[torch.dtype] = [torch.float32, torch.float64]
devices: List[str] = ["cpu", "cuda"]


def tensor(data, dtype, device: str = "cpu") -> torch.Tensor:
    return torch.tensor(data, dtype=dtype, device=device)


def maybe_skip_testing(dtype, device: str) -> None:
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def set_testing_device(device) -> None:
    """New tensors land on ``device`` (``torch.set_default_device``); the
    reference sets ``jax_default_device``. ``None`` restores the CPU
    default."""
    torch.set_default_device(device)

"""Feature probe and shared type aliases.

Port of ``paddle_sparse_tpu/typing_.py``: a probe for the card in place of
the JAX package's TPU and x64 probes. It is a function, so importing this
module asks nothing of the CUDA runtime.
"""
from typing import Tuple, Union

import numpy as np
import torch


def with_cuda() -> bool:
    """True when a CUDA card is visible to this process."""
    return torch.cuda.is_available()


Shape2D = Tuple[int, int]
ArrayLike = Union[torch.Tensor, np.ndarray, list, tuple]

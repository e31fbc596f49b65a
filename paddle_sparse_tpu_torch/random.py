"""The eager facade's random stream (port of ``paddle_sparse_tpu/random.py``).

The reference draws from global framework state; the facade keeps its own
explicit ``torch.Generator`` on the CPU, which callers seed with
:func:`seed` and random ops draw from (:func:`generator`), so the facade's
draws do not move torch's global stream.
"""
import torch

_generator = torch.Generator().manual_seed(0)


def seed(n: int) -> None:
    """Seed the facade's random stream."""
    _generator.manual_seed(n)


def generator() -> torch.Generator:
    """The facade's generator."""
    return _generator

"""The eager facade's random streams (port of ``paddle_sparse_tpu/random.py``).

The reference draws from global framework state; the facade keeps its own
explicit ``torch.Generator`` per device, which callers seed with :func:`seed`
and random ops draw from (:func:`generator`), so the facade's draws do not
move torch's global streams. A generator draws only on its own device
(``torch.rand(..., device="cuda", generator=cpu_generator)`` raises), so
each device has one, made on first use and seeded with the last seed.
"""
from typing import Dict, Optional

import torch

_seed = 0
_generators: Dict[torch.device, torch.Generator] = {
    torch.device("cpu"): torch.Generator().manual_seed(_seed)}


def _key(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def seed(n: int) -> None:
    """Seed the facade's random stream on every device."""
    global _seed
    _seed = n
    for g in _generators.values():
        g.manual_seed(n)


def generator(device: Optional[torch.device] = None) -> torch.Generator:
    """The facade's generator on ``device`` (the CPU one when None)."""
    dev = _key("cpu" if device is None else device)
    g = _generators.get(dev)
    if g is None:
        g = _generators[dev] = torch.Generator(device=dev).manual_seed(_seed)
    return g

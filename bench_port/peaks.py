"""Published peaks of the cards the benchmark knows, by the name that
``torch.cuda.get_device_name()`` gives. NVIDIA's H100 SXM data sheet, dense
rates without sparsity, at the full 700 W power limit; a card set below it
runs slower, so a run prints the card's limit beside its numbers.

The rate is float32's outside the tensor cores: the benchmark runs float32
alone, its GEMMs in full f32 (TF32 off) and the sparse kernels' FMAs on the
CUDA cores. A card that is not in the table has no peak, and a reader of a
share of a peak then finds nothing to read.
"""
from typing import Optional

FLOAT32_BYTES = 4

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "flops_per_s": 67e12},
}


def peak(device_kind: str) -> Optional[dict]:
    """``{"hbm_bytes_per_s", "flops_per_s"}`` of ``device_kind`` at
    float32's rate, or None for a card not in the table."""
    return PEAKS.get(device_kind)

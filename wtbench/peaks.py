"""Published peaks of the cards the benchmark knows, by the name
``torch.cuda.get_device_name`` gives.

NVIDIA's H100 data sheet: the SXM part's HBM3 moves 3.35 TB/s at its
700 W limit.  A card set to a lower power limit may not reach it; the run
records the limit beside its numbers.
"""

HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_bytes_per_s(kind: str):
    """The card's peak memory bandwidth, or None for a card not listed."""
    return HBM_BYTES_PER_S.get(kind)

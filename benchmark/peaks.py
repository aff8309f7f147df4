"""Published peaks of the cards the benchmark knows, by the name that
``torch.cuda.get_device_name()`` gives.

NVIDIA H100 (SXM5, 80 GB HBM3) data sheet: 3.35 TB/s of HBM bandwidth,
at the full power limit of 700 W.
"""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def hbm_bytes_per_s(kind):
    """The card's HBM bandwidth in bytes a second, or None if unknown."""
    return PEAKS.get(kind, {}).get("hbm_bytes_per_s")

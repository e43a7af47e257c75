"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheets, dense rates): HBM bytes per second and float32 operations per
second outside the tensor cores. A roofline share divides the least time
these allow for a kernel's work by the kernel's measured time."""

from __future__ import annotations

PEAKS = {
    # H100 SXM5 80 GB (HBM3), at its full 700 W power limit.
    "H100 SXM": dict(bytes_per_s=3.35e12, f32_ops_per_s=67e12),
    "H100 PCIe": dict(bytes_per_s=2.0e12, f32_ops_per_s=51e12),
}


def peaks_for(device_name: str):
    """The peaks of a card by `torch.cuda.get_device_name()`, or None for
    a card the table does not hold."""
    if "H100" not in device_name:
        return None
    if "PCIe" in device_name:
        return PEAKS["H100 PCIe"]
    return PEAKS["H100 SXM"]


def bound_ms(peaks, n_bytes: float, n_ops: float) -> float:
    """The least time in ms that moving n_bytes and doing n_ops float32
    operations can take: the larger of the two over their peaks."""
    return 1e3 * max(n_bytes / peaks["bytes_per_s"],
                     n_ops / peaks["f32_ops_per_s"])

"""Published peaks of the cards the benchmark runs on: NVIDIA's data
sheet of the H100 SXM (dense, 700 W). The float32 rate is the one outside
the tensor cores: the port keeps TF32 off (``device.set_precision_policy``).
A card whose name matches no entry has no peaks, and the readers that
divide by one return nothing."""

from __future__ import annotations

PEAKS = {
    "H100": {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks_for(device_name: str | None) -> dict | None:
    for key, peaks in PEAKS.items():
        if device_name and key in device_name:
            return peaks
    return None


def least_seconds(ops: float, nbytes: float, peaks: dict) -> float:
    """The least time a call could take: the larger of its operations over
    the float32 rate and its bytes over the memory bandwidth."""
    return max(ops / peaks["fp32_flops"], nbytes / peaks["hbm_bytes_per_s"])

"""The card's published peaks and a kernel's least time, for the
`<kernel>_roofline` metrics a later change adds (copied from
chip_smoke.py, which held them for its kernel rows). NVIDIA H100 SXM at
700 W, dense rates: 67 TFLOP/s in float32 outside the tensor cores, HBM
at 3.35 TB/s."""
from __future__ import annotations

PEAK_FP32 = 67e12        # FLOP/s
PEAK_BYTES = 3.35e12     # bytes/s


def bound_s(ops: float, nbytes: float) -> float:
    """The least seconds the card could take: the larger of the
    operations over the float32 peak and the bytes over the bandwidth."""
    return max(ops / PEAK_FP32, nbytes / PEAK_BYTES)


def share_pct(ops: float, nbytes: float, seconds: float) -> float | None:
    """The kernel's share of its roofline, percent; None where it did not
    run (never 0 for a share that was not read)."""
    return 100.0 * bound_s(ops, nbytes) / seconds if seconds > 0 else None

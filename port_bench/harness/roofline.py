"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense) and the least
time of attention work, from shapes.

The attention arithmetic is a copy of ``chip_smoke.py::bound_ms`` l.716-743
(per head, each input read once and each output written once; forward
2*Sq*Sk*(d + dv) operations, the fused backward #2 2*Sq*Sk*(3d + 2dv)),
with one change: float32 work is held to the TF32 peak of 495 TFLOP/s, the
fastest rate at which the card takes float32 operands, and not to the
3xTF32 rate that the port's own kernels reach, so that no implementation
can read above 100 %."""

from __future__ import annotations

__all__ = ["BF16_PEAK", "TF32_PEAK", "HBM_RATE", "peak_for", "attention_bound_s"]

BF16_PEAK = 989e12  # FLOP/s, bfloat16 / float16 tensor cores
TF32_PEAK = 495e12  # FLOP/s, TF32 tensor cores: the ceiling for float32 operands
HBM_RATE = 3.35e12  # bytes/s


def peak_for(dtype: str) -> float:
    return {"bfloat16": BF16_PEAK, "float32": TF32_PEAK}[dtype]


def attention_bound_s(site: dict, dtype: str, backward: bool) -> float:
    """Least seconds of one call's work: the forward, and with ``backward``
    the fused backward too, each the larger of its bytes over the memory
    rate and its operations over the peak for ``dtype``. ``site``: b, sq,
    sk, h, d, dv, masked, itemsize."""
    b, sq, sk, h, d, dv = (site[k] for k in ("b", "sq", "sk", "h", "d", "dv"))
    itemsize = site["itemsize"]
    q, k, v, o = b * sq * h * d, b * sk * h * d, b * sk * h * dv, b * sq * h * dv
    mask = b * sk if site["masked"] else 0
    lse = 4 * b * h * sq
    peak = peak_for(dtype)
    kinds = [("fwd", q + k + v, o, d + dv)]
    if backward:
        kinds.append(("bwd", q + k + v + 2 * o, q + k + v, 3 * d + 2 * dv))
    total = 0.0
    for _, ins, outs, per_pair in kinds:
        nbytes = itemsize * (ins + outs) + lse + mask
        flops = 2 * b * h * sq * sk * per_pair
        total += max(nbytes / HBM_RATE, flops / peak)
    return total

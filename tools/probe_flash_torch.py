"""Time the PyTorch port's packed flash-attention kernels at the encoder's
shapes on the GPU: the port's counterpart of ``tools/probe_flash.py``.

    python tools/probe_flash_torch.py [--sq 7056] [--b 1] [--hd 256] [--heads 8] [--rate 0.1]

Random bfloat16 q, k, v of (B, Sq, hd) (``default_rng(0)``, Sk = Sq, no key
mask, dropout ``--rate`` with seed 7, as the JAX probe); ``hd / heads`` is a
head's width. Device times from CUDA-graph replay, the best of 3 replays
after a warm-up: kernel #1's forward (``ops/cuda/flash_attention.py::
flash_attention_fwd``), and the forward plus the backward that
``backward_plan`` picks for the card (kernel #2, or #3 and #4 where #2's
shared-memory layout does not fit), each wrapper's call whole (the
backward's float32 dQ zeroing, delta and cast included). Beside them the
least time the work could take, as PERF.md's kernel table computes it: the
larger of the bytes each kernel must move (each input read once, each
output written once) over 3.35 TB/s and its FLOPs over 989 TFLOP/s
(bfloat16 tensor cores), H100 SXM data-sheet peaks at a 700 W power limit;
and as a yardstick the time of ``F.scaled_dot_product_attention`` on the
same operands (head-major, the same dropout rate; forward, and forward plus
backward through autograd), which the port never runs.

It needs the GPU: under ``--device cpu`` it exits non-zero, since the
kernels do not run there (their plain versions are not what it measures).
Prints the card's name and power limit (nvidia-smi) first and one JSON line
last. Imports torch, numpy and the port only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

BF16_PEAK = 989e12  # H100 SXM dense bfloat16 tensor-core FLOP/s (700 W)
HBM_RATE = 3.35e12  # H100 SXM bytes/s
SEED = 7
REPLAYS = 3


def bound_ms(b: int, sq: int, sk: int, h: int, d: int, dv: int, itemsize: int, kind: str) -> tuple[float, str]:
    """Least milliseconds for one kernel's work and what bounds it, per head
    with each input read once and each output written once (no key mask):
    fwd (#1): q, k, v in, out and lse out, 2*Sq*Sk*(d + dv) FLOPs; bwd
    (#2): q, k, v, out, dO, lse in, dQ, dK, dV out, 2*Sq*Sk*(3d + 2dv); dq
    (#3): dQ out, 2*Sq*Sk*(2d + dv); dkv (#4): dK, dV out, 2*Sq*Sk*(2d +
    2dv)."""
    q, k, v, o = b * sq * h * d, b * sk * h * d, b * sk * h * dv, b * sq * h * dv
    grads_out, per_pair = {"fwd": (o, d + dv), "bwd": (q + k + v, 3 * d + 2 * dv),
                           "dq": (q, 2 * d + dv), "dkv": (k + v, 2 * d + 2 * dv)}[kind]
    ins = q + k + v + (0 if kind == "fwd" else 2 * o)
    nbytes = itemsize * (ins + grads_out) + 4 * b * h * sq
    flops = 2 * b * h * sq * sk * per_pair
    t_bytes, t_ops = nbytes / HBM_RATE * 1e3, flops / BF16_PEAK * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def graph_ms(torch, fn) -> float:
    """Device milliseconds of one ``fn()``: several calls captured in one
    CUDA graph (after a warm-up on a side stream), the best of
    :data:`REPLAYS` replays between two CUDA events, over the calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    calls = int(min(20, max(1, 5.0 / max(start.elapsed_time(end), 1e-3))))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(REPLAYS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return min(times)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "nvidia-smi: none"


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("probe_flash_torch")
    ap.add_argument("--sq", type=int, default=7056)
    ap.add_argument("--b", type=int, default=1)
    ap.add_argument("--hd", type=int, default=256)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--bq", type=int, default=512, help="the JAX probe's Pallas block; ignored (no counterpart)")
    ap.add_argument("--bk", type=int, default=512, help="the JAX probe's Pallas block; ignored (no counterpart)")
    ap.add_argument("--rate", type=float, default=0.1)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default the GPU (the kernels do not run on the CPU)")
    return ap


def main(argv=None) -> dict:
    import torch
    import torch.nn.functional as F

    from object_detection_destr_tpu_torch.config import resolve_device
    from object_detection_destr_tpu_torch.ops.cuda import flash_attention as fa

    args = get_parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda":
        print(f"probe_flash_torch: the kernels run on a GPU only, not on {device}", file=sys.stderr)
        raise SystemExit(2)
    card = card_line()
    print(card, flush=True)
    b, sq, h = args.b, args.sq, args.heads
    d = args.hd // h
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, sq, args.hd)).astype(np.float32)).to(device, torch.bfloat16)
               for _ in range(3))
    d_out = torch.from_numpy(rng.normal(size=(b, sq, args.hd)).astype(np.float32)).to(device, torch.bfloat16)
    optin = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    plan = fa.backward_plan(d, d, torch.bfloat16, optin)
    counted = [fa.flash_attention_fwd, fa.flash_attention_bwd, fa.flash_attention_dq, fa.flash_attention_dkv]
    before = [kern.launches for kern in counted]

    def forward():
        return fa.flash_attention_fwd(q, k, v, h, None, None, args.rate, SEED)

    def forward_backward():
        out, lse = forward()
        grads = (q, k, v, h, None, out, lse, d_out, None, args.rate, SEED)
        if plan == "fused":
            return fa.flash_attention_bwd(*grads)
        return fa.flash_attention_dq(*grads), fa.flash_attention_dkv(*grads)

    fwd_ms = graph_ms(torch, forward)
    fwd_bwd_ms = graph_ms(torch, forward_backward)
    launches = [kern.launches - n for kern, n in zip(counted, before)]

    qh, kh, vh = (t.view(b, sq, h, d).transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    doh = d_out.view(b, sq, h, d).transpose(1, 2)
    sdpa_fwd_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh, dropout_p=args.rate))

    def sdpa_fwd_bwd():
        torch.autograd.grad(F.scaled_dot_product_attention(qh, kh, vh, dropout_p=args.rate), (qh, kh, vh), doh)

    sdpa_fwd_bwd_ms = graph_ms(torch, sdpa_fwd_bwd)

    fwd_bound, fwd_by = bound_ms(b, sq, sq, h, d, d, 2, "fwd")
    bwd_kinds = ["bwd"] if plan == "fused" else ["dq", "dkv"]
    bwd_bound = sum(bound_ms(b, sq, sq, h, d, d, 2, kind)[0] for kind in bwd_kinds)
    result = {
        "sq": sq, "sk": sq, "b": b, "hd": args.hd, "heads": h, "rate": args.rate, "dtype": "bfloat16",
        "backward_plan": plan, "fwd_ms": fwd_ms, "fwd_bwd_ms": fwd_bwd_ms,
        "fwd_bound_ms": fwd_bound, "fwd_bound_by": fwd_by, "fwd_bwd_bound_ms": fwd_bound + bwd_bound,
        "sdpa_fwd_ms": sdpa_fwd_ms, "sdpa_fwd_bwd_ms": sdpa_fwd_bwd_ms,
        "launches": dict(zip(("#1", "#2", "#3", "#4"), launches)),
        "device": torch.cuda.get_device_name(device), "card": card,
        "per": "device ms of one call from CUDA-graph replay, best of 3; bounds at H100 SXM peaks "
               "(3.35 TB/s, 989 TFLOP/s bf16, 700 W); SDPA a yardstick, never on the port's path",
    }
    print(f"fwd (#1): {fwd_ms:.4f} ms (bound {fwd_bound:.4f}, {fwd_by}; SDPA {sdpa_fwd_ms:.4f}); "
          f"fwd+bwd (#1 + {'#2' if plan == 'fused' else '#3 + #4'}): {fwd_bwd_ms:.4f} ms (bound "
          f"{fwd_bound + bwd_bound:.4f}; SDPA {sdpa_fwd_bwd_ms:.4f}) at B={b} Sq=Sk={sq} heads={h} d={d} "
          f"rate={args.rate} ({card})", flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()

"""Analytic roofline of the convolutions in the PyTorch port's DESTR train
step on an NVIDIA H100: the port's counterpart of ``tools/roofline_conv.py``.

For each convolution of the step (the ResNet-50 backbone at ``--image``
px, ``reduce_dim`` and the mini-detector's three stacks), forward and, where
the port computes them, the weight gradient (dW) and the input gradient
(dX): the FLOPs and the least HBM traffic (each activation read once,
bfloat16 activations under autocast, float32 filters and filter gradients,
no re-reads for a 3x3 halo), and the least time ``max(FLOPs / 989e12,
bytes / 3.35e12)`` summed over the convolutions: H100 SXM data-sheet peaks
(dense bfloat16 tensor cores, HBM) at a 700 W power limit. The measured
convolution time cannot beat it. ``conv_cost`` and ``bottleneck`` are this
tool's own copies of the JAX tool's model, residual traffic included (in
the port the residual add and ReLU run as PyTorch elementwise kernels, not
in cuDNN's, so the table also gives the bound without them).

What the port runs, from ``models/resnet.py`` and
``models/destr/mini_detector.py`` (not the JAX text): the stem is the plain
7x7/2 convolution over 3 channels (the JAX package's is a space-to-depth
4x4 over 12); the stem and layer1 are frozen (the optimizer never moves
them) but every parameter takes a gradient, since the global-norm clip and
the finite check count them (``train/state.py``), so autograd computes the
stem's dW (the images take no gradient: no dX) and layer1's dW and dX;
layer2-4, ``reduce_dim`` and the mini-detector's 3 x 4 3x3 convolutions
train.

    python tools/roofline_conv_torch.py [--batch 16] [--image 640] [--profile TRACE]

``--profile`` takes a ``torch.profiler`` trace that ``train/profiler.py::
StepTrace`` wrote (``tools/profile_step_torch.py --trace_dir``, or a
trainer's ``--profile_dir``), reads the convolution category's device ms a
step from ``parse_trace`` (``profile_step_torch.category``) and prints the
share of the bound it reaches. Needs no device. Prints one JSON line last.
Imports torch, numpy and the port only (and the profile tool beside it).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

PEAK_FLOPS = 989e12  # H100 SXM dense bfloat16 tensor-core FLOP/s (700 W)
PEAK_BW = 3.35e12  # H100 SXM HBM bytes/s
PEAKS = "H100 SXM data sheet at 700 W: 989e12 bf16 FLOP/s, 3.35e12 B/s"


def conv_cost(b, h, w, cin, cout, k, stride=1, train=True, act_bytes=2, dx=True):
    """(tag, flops, bytes) entries of one convolution: forward, and with
    ``train`` the weight gradient and (with ``dx``) the input gradient."""
    ho, wo = h // stride, w // stride
    flops = 2 * b * ho * wo * cin * cout * k * k
    w_bytes = k * k * cin * cout * 4  # float32 parameters
    in_b = b * h * w * cin * act_bytes
    out_b = b * ho * wo * cout * act_bytes
    entries = [("fwd", flops, in_b + out_b + w_bytes)]
    if train:
        # dL/dW: reads the input and the output gradient, writes the float32 filter gradient
        entries.append(("dW", flops, in_b + out_b + w_bytes * 2))
        if dx:
            # dL/dX: reads the output gradient and the weights, writes the input-shaped gradient
            entries.append(("dX", flops, in_b + out_b + w_bytes))
    return entries


def bottleneck(b, hw, width, cin, stride, train, project, act_bytes=2):
    """A torchvision bottleneck: 1x1 cin->w, 3x3 w->w (stride), 1x1 w->4w
    (and the 1x1 cin->4w projection at the stride), with the residual
    add's traffic (forward: the residual read; backward: the ReLU mask's
    read of the saved activation and the fanned-out gradient's write)."""
    convs = [
        (b, hw, hw, cin, width, 1, 1),
        (b, hw, hw, width, width, 3, stride),
        (b, hw // stride, hw // stride, width, width * 4, 1, 1),
    ]
    if project:
        convs.append((b, hw, hw, cin, width * 4, 1, stride))
    out = []
    for c in convs:
        out.extend(conv_cost(*c, train=train))
    res_elems = b * (hw // stride) ** 2 * width * 4
    out.append(("res_fwd", res_elems, res_elems * act_bytes))
    if train:
        out.append(("res_bwd", res_elems, 2 * res_elems * act_bytes))
    return out


def conv_groups(batch: int, image: int, hidden: int = 256) -> dict[str, list]:
    """The step's convolutions by group: {group: [(tag, flops, bytes)]}."""
    b, s = batch, image
    groups = {
        # the plain 7x7/2 stem over 3 channels; frozen, its weight gradient computed
        "stem (frozen, dW)": conv_cost(b, s, s, 3, 64, 7, 2, train=True, dx=False),
    }
    hw = s // 4
    l1 = bottleneck(b, hw, 64, 64, 1, True, True)
    for _ in range(2):
        l1 += bottleneck(b, hw, 64, 256, 1, True, False)
    groups["layer1 (frozen, dW dX)"] = l1
    for i, (blocks, width, cin, hw_in) in enumerate([(4, 128, 256, s // 4), (6, 256, 512, s // 8),
                                                     (3, 512, 1024, s // 16)]):
        g = bottleneck(b, hw_in, width, cin, 2, True, True)
        for _ in range(blocks - 1):
            g += bottleneck(b, hw_in // 2, width, width * 4, 1, True, False)
        groups[f"layer{i + 2}"] = g
    c5 = s // 32
    groups["reduce_dim 1x1"] = conv_cost(b, c5, c5, 2048, hidden, 1, 1, train=True)
    groups["mini-detector"] = [e for _ in range(3 * 4)  # cls / pos / reg stacks, 4 x (3x3 C->C) each
                               for e in conv_cost(b, c5, c5, hidden, hidden, 3, 1, train=True)]
    return groups


def _bound(entries) -> float:
    return sum(max(f / PEAK_FLOPS, by / PEAK_BW) for _, f, by in entries)


def measured_conv_ms(trace: str) -> tuple[float, int]:
    """(the convolution category's device ms a step, the traced steps) of a
    StepTrace trace, as ``tools/profile_step_torch.py`` sorts its kernels."""
    from object_detection_destr_tpu_torch.train.profiler import parse_trace

    spec = importlib.util.spec_from_file_location(
        "profile_step_torch", os.path.join(os.path.dirname(os.path.abspath(__file__)), "profile_step_torch.py"))
    profile = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(profile)
    parsed = parse_trace(trace)
    steps = max(len(parsed["steps"]), 1)
    seconds = sum(v["seconds"] for name, v in parsed["device_time"].items()
                  if profile.category(name, v["category"]) == "convolution")
    return seconds * 1e3 / steps, len(parsed["steps"])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("roofline_conv_torch")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--image", type=int, default=640)
    ap.add_argument("--profile", type=str, default=None,
                    help="a StepTrace trace (file or directory): compare its convolution ms with the bound")
    args = ap.parse_args(argv)
    groups = conv_groups(args.batch, args.image)

    print(f"{'group':<24}{'GFLOP':>9}{'GB':>8}{'t_flops ms':>11}{'t_bw ms':>9}{'t_lb ms':>9}  bound")
    rows, tot_f, tot_b, tot_lb, res_lb = [], 0.0, 0.0, 0.0, 0.0
    for name, entries in groups.items():
        f = sum(e[1] for e in entries)
        by = sum(e[2] for e in entries)
        lb = _bound(entries)
        res = _bound([e for e in entries if e[0].startswith("res_")])
        tot_f, tot_b, tot_lb, res_lb = tot_f + f, tot_b + by, tot_lb + lb, res_lb + res
        tf, tb = f / PEAK_FLOPS, by / PEAK_BW
        rows.append({"group": name, "gflop": f / 1e9, "gb": by / 1e9, "bound_ms": lb * 1e3,
                     "bound_by": "operations" if tf > tb else "bytes"})
        print(f"{name:<24}{f / 1e9:>9.1f}{by / 1e9:>8.2f}{tf * 1e3:>11.2f}{tb * 1e3:>9.2f}{lb * 1e3:>9.2f}  "
              f"{rows[-1]['bound_by']}")
    print(f"{'TOTAL':<24}{tot_f / 1e9:>9.1f}{tot_b / 1e9:>8.2f}{tot_f / PEAK_FLOPS * 1e3:>11.2f}"
          f"{tot_b / PEAK_BW * 1e3:>9.2f}{tot_lb * 1e3:>9.2f}")
    conv_lb = tot_lb - res_lb
    print(f"\nleast time of the step's convolutions (sum of max(FLOPs, bytes) a convolution, {PEAKS}): "
          f"{tot_lb * 1e3:.3f} ms at B={args.batch}, {args.image} px; {conv_lb * 1e3:.3f} ms without the "
          f"residual adds, which the port runs as elementwise kernels")
    result = {"batch": args.batch, "image": args.image, "groups": rows, "total_gflop": tot_f / 1e9,
              "total_gb": tot_b / 1e9, "bound_ms": tot_lb * 1e3, "conv_only_bound_ms": conv_lb * 1e3,
              "peaks": PEAKS}
    if args.profile:
        ms, steps = measured_conv_ms(args.profile)
        result.update(measured_conv_ms=ms, traced_steps=steps, share_of_bound=conv_lb * 1e3 / ms if ms else None)
        print(f"measured: the convolution category {ms:.3f} ms a step over {steps} traced steps "
              f"({args.profile}); the bound without residual adds is "
              + (f"{100 * conv_lb * 1e3 / ms:.1f} % of it" if ms else "not comparable (no device time)"))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()

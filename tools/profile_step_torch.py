"""Profile the PyTorch port's captured DESTR train step and print where its
device time goes, by kernel: the port's counterpart of
``tools/profile_step.py``, which profiles the JAX package's step.

    python tools/profile_step_torch.py [--steps 3] [--batch 8] [--image 640]

The step is the one ``train.train --device_cache --epoch_scan`` replays:
bfloat16 DESTR at the default widths (hidden 256, 6+6 blocks, top_k 300,
dropout 0.3), the default TrainConfig, synthetic canvases cached on the
device and augmented there, through ``train/epoch_scan.py::EpochRunner``. The
first step is the runner's warm-up and capture; the next ``--steps`` are
graph replays traced with ``torch.profiler`` (``train/profiler.py``). The
summary prints the median step's device busy time, the total device time of
the kernels, copies and memsets, a table by category (the port's CUDA
kernels by name, convolution, GEMM, elementwise / reduction, copies and
memsets) and the top ``--top`` kernels, each with ms a step, share and count
a step. Runs on the GPU unless ``--device cpu`` is given (a CPU trace holds
no device events). Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import os
import re
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# the port's CUDA kernels as the trace names them; #5, #6 and #7 launch the
# kernels of #1, #3 and #4 with head-major strides
PORT_KERNELS = (
    ("flash_attention_fwd #1/#5", r"flash_fwd_(tc|f32)_kernel"),
    ("flash_attention_bwd #2", r"flash_bwd_(tc_)?kernel"),
    ("flash_attention_dq #3/#6", r"flash_two_pass_tc_kernel(<false|ILb0E)|flash_dq_kernel"),
    ("flash_attention_dkv #4/#7", r"flash_two_pass_tc_kernel(<true|ILb1E)|flash_dkv_kernel"),
    ("fused_auction #9", r"fused_auction_kernel"),
    ("auction_kernel #8", r"(?<!fused_)auction_kernel"),
)
# the library kernels by family, tried in this order after the port's
# (cuDNN's implicit-GEMM convolutions and its layout transposes before GEMM)
LIBRARY_KERNELS = (
    ("convolution", r"conv|fprop|dgrad|wgrad|implicit_gemm|nchwToNhwc|nhwcToNchw|cudnn"),
    ("GEMM", r"gemm|gemv|nvjet|cutlass|cublas|splitK"),
)
COPIES = "copies and memsets"
OTHER = "elementwise / reduction"


def category(name: str, trace_category: str) -> str:
    """The summary's category of one device event."""
    if trace_category in ("gpu_memcpy", "gpu_memset"):
        return COPIES
    for label, pattern in PORT_KERNELS + LIBRARY_KERNELS:
        if re.search(pattern, name):
            return label
    return OTHER


def summarize(parsed: dict, steps: int, top: int = 40) -> dict:
    """Print and return the step's device time by category and by kernel
    from :func:`parse_trace`'s result over ``steps`` traced steps:
    {"step_busy_ms", "step_period_ms" (medians), "busy_ms_per_step" (the
    union of the device events over the window, a step), "total_ms_per_step"
    (the sum of their durations, a step), "categories" and "top" (rows of
    name, ms_per_step, share, count_per_step)}."""
    by_name = parsed["device_time"]
    total = sum(v["seconds"] for v in by_name.values())
    cats: dict[str, dict] = {}
    for name, v in by_name.items():
        entry = cats.setdefault(category(name, v["category"]), {"seconds": 0.0, "count": 0})
        entry["seconds"] += v["seconds"]
        entry["count"] += v["count"]

    def row(name, seconds, count):
        return {"name": name, "ms_per_step": seconds * 1e3 / steps,
                "share": seconds / total if total > 0 else 0.0, "count_per_step": count / steps}

    out = {
        "step_busy_ms": statistics.median(s["busy_s"] * 1e3 for s in parsed["steps"]) if parsed["steps"] else 0.0,
        "step_period_ms": statistics.median(s["period_s"] * 1e3 for s in parsed["steps"]) if parsed["steps"] else 0.0,
        "busy_ms_per_step": parsed["busy_s"] * 1e3 / steps,
        "total_ms_per_step": total * 1e3 / steps,
        "categories": [row(c, v["seconds"], v["count"])
                       for c, v in sorted(cats.items(), key=lambda kv: -kv[1]["seconds"])],
        "top": [row(n, v["seconds"], v["count"])
                for n, v in sorted(by_name.items(), key=lambda kv: -kv[1]["seconds"])[:top]],
    }
    if not by_name:
        print(f"the trace of {steps} steps holds no device event (a CPU run): device time not measured")
        return out
    print(f"step device time: median busy {out['step_busy_ms']:.2f} ms of a {out['step_period_ms']:.2f} ms "
          f"period over {len(parsed['steps'])} steps (idle share {parsed['idle_share']:.4f})")
    print(f"total device time of the kernels, copies and memsets: {total * 1e3:.2f} ms over {steps} steps "
          f"({out['total_ms_per_step']:.2f} ms/step; busy {out['busy_ms_per_step']:.2f} ms/step)")
    print(f"\n{'category':<28} {'ms/step':>9} {'%':>6} {'count/step':>10}")
    for r in out["categories"]:
        print(f"{r['name']:<28} {r['ms_per_step']:>9.3f} {100 * r['share']:>6.2f} {r['count_per_step']:>10.1f}")
    print(f"\n{'kernel':<72} {'ms/step':>8} {'%':>6} {'cnt':>6}")
    for r in out["top"]:
        print(f"{r['name'][:72]:<72} {r['ms_per_step']:>8.3f} {100 * r['share']:>6.2f} {r['count_per_step']:>6.1f}")
    return out


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("profile_step_torch")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--image", type=int, default=640)
    ap.add_argument("--trace_dir", type=str,
                    default=os.path.join(REPO, "object_detection_destr_tpu_torch", "_build", "traces", "profile_step"))
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--flash", action="store_true",
                    help="accepted for the JAX tool's command lines; changes nothing: the port launches its "
                         "CUDA kernels whenever the tensors are on the GPU")
    ap.add_argument("--backbone", type=str, default="resnet50")
    ap.add_argument("--dilation", action="store_true")
    ap.add_argument("--opt_layout", type=str, default="auto",
                    choices=["auto", "per-leaf", "grouped", "flat"])
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default the GPU ('cpu' must be asked for)")
    return ap


def build_runner(args):
    """The captured DESTR step of ``args`` (this parser's flags): its epoch
    runner after the warm-up step and the capture, and the index rows of the
    next ``args.steps`` steps."""
    import torch

    from object_detection_destr_tpu_torch.config import Config, DataConfig, DestrConfig, TrainConfig, resolve_device
    from object_detection_destr_tpu_torch.data.device_cache import DeviceCachedLoader
    from object_detection_destr_tpu_torch.data.transforms import destr_train_transform
    from object_detection_destr_tpu_torch.models.destr.model import build_destr
    from object_detection_destr_tpu_torch.train.driver import _aug_seed, _make_loaders
    from object_detection_destr_tpu_torch.train.epoch_scan import EpochRunner
    from object_detection_destr_tpu_torch.train.state import create_destr_state
    from object_detection_destr_tpu_torch.train.steps import make_destr_step_core

    device = resolve_device(args.device)
    canvas = int(args.image * 672 / 640)  # the trainer's canvas
    train_cfg = TrainConfig(batch_size=args.batch, image_size=args.image, opt_layout=args.opt_layout)
    config = Config(
        destr=DestrConfig(compute_dtype="bfloat16", backbone=args.backbone, dilation=args.dilation),
        train=train_cfg,
        data=DataConfig(image_size=canvas, augment_factor=1, num_train_samples=args.batch * (args.steps + 1),
                        num_valid_samples=0, device_cache=True),
    )
    cache = DeviceCachedLoader(_make_loaders(config, canvas, "destr")[0], device)
    torch.manual_seed(train_cfg.seed)
    state = create_destr_state(build_destr(config.destr, device), train_cfg, steps_per_epoch=len(cache))
    runner = EpochRunner(
        state, make_destr_step_core(train_cfg),
        lambda raw, gen: destr_train_transform(raw["images"], raw["boxes"], raw["labels"], raw["valid"], gen,
                                               out_size=args.image),
        cache.data, lambda step: _aug_seed(train_cfg.seed, step), len(cache),
    )
    _, idx = cache.epoch_index_matrix()
    runner.run(idx[:1], 0)  # the warm-up step and the capture
    if device.type == "cuda":
        torch.cuda.synchronize()
    return runner, idx[1:]


def main(argv=None) -> dict:
    """Profile and print; returns :func:`summarize`'s dict with the parsed
    trace under "trace"."""
    from object_detection_destr_tpu_torch.train.profiler import StepTrace, parse_trace

    args = get_parser().parse_args(argv)
    runner, idx = build_runner(args)
    trace = StepTrace(args.trace_dir)
    trace.start()
    runner.run(idx, 1, step_scope=trace.step)
    path = trace.stop()
    parsed = parse_trace(path)
    print(f"trace: {path}")
    return {**summarize(parsed, args.steps, args.top), "trace": parsed}


if __name__ == "__main__":
    main()

"""Check that a ``torch.profiler`` trace of captured DESTR train steps holds
every device event of the steps, with ``StepTrace``'s idle margins and
without them.

    python tools/trace_window_check.py [--rounds 12] [--steps 3] [--batch 16] [--image 640]

The step is ``tools/profile_step_torch.py``'s (the replay of one CUDA graph
a step). Each round traces ``--steps`` replays twice: once with the margins
set to 0 and once at ``StepTrace.MARGIN_S``. Every replay of the graph runs
the same device events, so a window whose steps differ in their count of
device events, or whose launches of the port's kernels differ from the first
window's, lost events. Prints one JSON line a window (the device events a
step, the port's kernels a step by category, ``parse_trace``'s launch lead)
and a last line with the lossy windows of each variant and the least launch
lead. Runs on the GPU; imports torch and the port only.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import profile_step_torch  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("trace_window_check")
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--image", type=int, default=640)
    args = ap.parse_args(argv)

    import torch

    from object_detection_destr_tpu_torch.train.profiler import StepTrace, parse_trace

    if not torch.cuda.is_available():
        raise RuntimeError("trace_window_check needs a GPU: a CPU trace holds no device events")
    print(f"card: {torch.cuda.get_device_name(0)}, torch {torch.__version__}")
    runner_args = profile_step_torch.get_parser().parse_args(
        ["--steps", str(args.steps), "--batch", str(args.batch), "--image", str(args.image)])
    runner, idx = profile_step_torch.build_runner(runner_args)
    trace_dir = os.path.join(profile_step_torch.REPO, "object_detection_destr_tpu_torch", "_build", "traces",
                             "trace_window_check")
    ported = [label for label, _ in profile_step_torch.PORT_KERNELS]
    first = None
    summary = {variant: {"windows": 0, "lossy": [], "least_launch_lead_s": None} for variant in ("no margin", "margin")}
    for r in range(args.rounds):
        for variant in summary:
            shutil.rmtree(trace_dir, ignore_errors=True)
            trace = StepTrace(trace_dir)
            trace.MARGIN_S = 0.0 if variant == "no margin" else StepTrace.MARGIN_S
            trace.start()
            runner.run(idx, runner.state.step, step_scope=trace.step)
            parsed = parse_trace(trace.stop())
            kernels = {label: 0 for label in ported}
            for name, n in parsed["launches"].items():
                label = profile_step_torch.category(name, "kernel")
                if label in kernels:
                    kernels[label] += n
            kernels = {k: v / args.steps for k, v in kernels.items()}
            first = first or kernels
            events = [s["events"] for s in parsed["steps"]]
            row = {"round": r, "variant": variant, "margin_s": trace.MARGIN_S, "events_a_step": events,
                   "kernels_a_step": kernels, "launch_lead_s": parsed["launch_lead_s"],
                   "unattributed": parsed["unattributed"]}
            print(json.dumps(row), flush=True)
            entry = summary[variant]
            entry["windows"] += 1
            if len(set(events)) != 1 or len(events) != args.steps or kernels != first:
                entry["lossy"].append(r)
            lead = parsed["launch_lead_s"]
            if lead is not None and (entry["least_launch_lead_s"] is None or lead < entry["least_launch_lead_s"]):
                entry["least_launch_lead_s"] = lead
    shutil.rmtree(trace_dir, ignore_errors=True)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()

"""SSD's run of record on the port (all three segments of
scripts/train_prod_ssd_torch.sh) against the JAX package's
(artifacts/prod_r5_ssd/metrics.jsonl), as Markdown tables and, with --json,
one JSON line.

    python artifacts/port_ssd_r2/compare.py [--port PATH] [--ref PATH] [--segments PATH] [--json]

Both metrics files are the trainers' ``metrics.jsonl`` (32-step train means
of ``class``, ``local`` and ``loss``; ``Loss/valid/*``, ``Metric/mAP`` and,
in segment 1, ``Metric/ema_mAP`` at the validated steps). The segments are
the JAX record's own: a new process at steps 1664 and 7040 (its train
records restart there), 14720 steps in all (115 epochs of 128 steps).
Printed: for each segment the band (min-max) of each run's 32-step train
means and of its validation loss, mAP and EMA mAP; every validation at the
steps both runs validated; and the port's continuity across the segment
boundaries: the train records' step axis (every 32 steps, once each), the
step, loader epoch and best val loss of each segment's ``_last`` checkpoint
(``segments.jsonl``), and the best val loss against the lowest validation
loss logged up to there.
"""

import argparse
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS_PER_EPOCH = 128
LOG_EVERY = 32
SEGMENTS = ((1, 1664), (1665, 7040), (7041, 14720))  # the JAX record's processes, by step
TAGS = ("Loss/valid/loss", "Loss/valid/class", "Loss/valid/local", "Metric/mAP", "Metric/ema_mAP")


def read(path: str) -> tuple[dict, dict]:
    """(train records by step, validation scalars by step); a step logged
    twice raises."""
    train, valid = {}, {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            if r.get("prefix") == "train":
                if r["step"] in train:
                    raise ValueError(f"{path}: train step {r['step']} logged twice")
                train[r["step"]] = r
            elif r.get("tag") in TAGS:
                valid.setdefault(r["step"], {})[r["tag"]] = float(r["value"])
    return train, valid


def band(values: list) -> list:
    return [min(values), max(values)] if values else []


def segment_bands(train: dict, valid: dict) -> list[dict]:
    out = []
    for lo, hi in SEGMENTS:
        t = [r for s, r in train.items() if lo <= s <= hi]
        v = {s: x for s, x in valid.items() if lo <= s <= hi}
        out.append({"steps": [lo, hi], "train_records": len(t),
                    **{f"train_{k}": band([r[k] for r in t]) for k in ("class", "loss")},
                    "validated_steps": sorted(v),
                    **{tag: band([x[tag] for x in v.values() if tag in x]) for tag in TAGS}})
    return out


def fmt(b: list) -> str:
    return f"{b[0]:.4f}-{b[1]:.4f}" if b else "-"


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--port", default=os.path.join(HERE, "metrics.jsonl"))
    p.add_argument("--ref", default=os.path.join(HERE, "..", "prod_r5_ssd", "metrics.jsonl"))
    p.add_argument("--segments", default=os.path.join(HERE, "segments.jsonl"))
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    (port_t, port_v), (ref_t, ref_v) = read(args.port), read(args.ref)
    bands = {"port": segment_bands(port_t, port_v), "jax": segment_bands(ref_t, ref_v)}

    print("| segment (steps) | run | train records | train class | train loss | val loss | mAP | EMA mAP |")
    print("|---|---|---|---|---|---|---|---|")
    for i, (lo, hi) in enumerate(SEGMENTS):
        for name in ("port", "jax"):
            b = bands[name][i]
            print(f"| {i + 1} ({lo}-{hi}) | {name} | {b['train_records']} | {fmt(b['train_class'])} | "
                  f"{fmt(b['train_loss'])} | {fmt(b['Loss/valid/loss'])} | {fmt(b['Metric/mAP'])} | "
                  f"{fmt(b['Metric/ema_mAP'])} |")

    steps = sorted(set(port_v) & set(ref_v))
    print("\n| step | val loss port | JAX | mAP port | JAX | EMA mAP port | JAX |\n|---|---|---|---|---|---|---|")
    for s in steps:
        cells = [f"{port_v[s].get(t, float('nan')):.4f} | {ref_v[s].get(t, float('nan')):.4f}"
                 for t in ("Loss/valid/loss", "Metric/mAP", "Metric/ema_mAP")]
        print(f"| {s} | " + " | ".join(cells) + " |")
    only = {"port": sorted(set(port_v) - set(ref_v)), "jax": sorted(set(ref_v) - set(port_v))}
    print(f"\nvalidated by one run only: port {only['port']}, JAX {only['jax']}")

    # continuity across the boundaries
    last = max(port_t)
    axis_whole = sorted(port_t) == list(range(LOG_EVERY, last + 1, LOG_EVERY))
    segments = []
    if os.path.exists(args.segments):
        with open(args.segments) as f:
            segments = [json.loads(line) for line in f]
    lowest, rows = float("inf"), []
    for seg in segments:
        ck = seg["checkpoints"]["port_ssd_r2_last"]
        lowest = min([lowest] + [x["Loss/valid/loss"] for s, x in port_v.items()
                                 if s <= ck["step"] and "Loss/valid/loss" in x])
        rows.append({"step": ck["step"], "loader": ck["loader"], "best_val": ck["best_val"],
                     "lowest_logged_val_loss": lowest, "best_ckpt_step": seg["checkpoints"]["port_ssd_r2"]["step"],
                     "seconds": seg["seconds"], "card": seg["card"]})
    print(f"\nport train records: steps {min(port_t)}-{last}, every {LOG_EVERY} once each: {axis_whole}")
    print("| segment | _last step | loader | best val loss | lowest val loss logged | best checkpoint's step | "
          "seconds |\n|---|---|---|---|---|---|---|")
    for i, r in enumerate(rows):
        print(f"| {i + 1} | {r['step']} | {r['loader']} | {r['best_val']:.4f} | {r['lowest_logged_val_loss']:.4f} | "
              f"{r['best_ckpt_step']} | {r['seconds']} |")
    if args.json:
        print(json.dumps({"bands": bands, "valid": {s: {"port": port_v[s], "jax": ref_v[s]} for s in steps},
                          "validated_by_one_run_only": only, "step_axis_whole": axis_whole, "last_step": last,
                          "segments": rows}))


if __name__ == "__main__":
    main()

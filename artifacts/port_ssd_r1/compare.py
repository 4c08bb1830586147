"""The port's SSD recipe run against the JAX package's segment 1 of the
ssd_prod run (artifacts/prod_r5_ssd), as Markdown tables and, with --json,
one JSON line.

    python artifacts/port_ssd_r1/compare.py [--port PATH] [--ref PATH] [--json]

Both files are the trainers' ``metrics.jsonl``, logged every 32 steps (128
steps an epoch at 4096 images and batch 32). Printed: per epoch, the mean of
the train ``class`` and ``loss`` records of both runs (steps up to
``--last_step``, 1536 by default: the JAX segment 1); every
``Loss/valid/*``, ``Metric/mAP`` and ``Metric/ema_mAP`` at the steps both
runs validated; and the range of each run's 32-step ``class`` means.
"""

import argparse
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS_PER_EPOCH = 128
TAGS = ("Loss/valid/loss", "Loss/valid/class", "Loss/valid/local", "Metric/mAP", "Metric/ema_mAP")


def read(path: str, last_step: int) -> tuple[dict, dict]:
    """(train records by step, validation scalars by step) up to ``last_step``."""
    train, valid = {}, {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            if r["step"] > last_step:
                continue
            if r.get("prefix") == "train":
                train[r["step"]] = r
            elif r.get("tag") in TAGS:
                valid.setdefault(r["step"], {})[r["tag"]] = float(r["value"])
    return train, valid


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--port", default=os.path.join(HERE, "metrics.jsonl"))
    p.add_argument("--ref", default=os.path.join(HERE, "..", "prod_r5_ssd", "metrics.jsonl"))
    p.add_argument("--last_step", type=int, default=1536)
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    (port_t, port_v), (ref_t, ref_v) = read(args.port, args.last_step), read(args.ref, args.last_step)

    def epoch_mean(train, epoch, key):
        vals = [r[key] for s, r in train.items() if (s - 1) // STEPS_PER_EPOCH == epoch]
        return sum(vals) / len(vals) if vals else float("nan")

    epochs = sorted({(s - 1) // STEPS_PER_EPOCH for s in port_t} & {(s - 1) // STEPS_PER_EPOCH for s in ref_t})
    print("| epoch | class port | JAX | loss port | JAX |\n|---|---|---|---|---|")
    rows = []
    for e in epochs:
        row = [epoch_mean(t, e, k) for k in ("class", "loss") for t in (port_t, ref_t)]
        rows.append({"epoch": e, "class": row[:2], "loss": row[2:]})
        print(f"| {e} | " + " | ".join(f"{v:.2f}" for v in row) + " |")
    steps = sorted(set(port_v) & set(ref_v))
    print("\n| step | " + " | ".join(f"{t} port | JAX" for t in TAGS) + " |\n" + "|---" * (1 + 2 * len(TAGS)) + "|")
    for s in steps:
        print(f"| {s} | " + " | ".join(f"{port_v[s].get(t, float('nan')):.4f} | {ref_v[s].get(t, float('nan')):.4f}"
                                      for t in TAGS) + " |")
    bands = {name: [min(r["class"] for r in t.values()), max(r["class"] for r in t.values())]
             for name, t in (("port", port_t), ("jax", ref_t))}
    print(f"\n32-step class means up to step {args.last_step}: port {bands['port'][0]:.2f}-{bands['port'][1]:.2f}, "
          f"JAX {bands['jax'][0]:.2f}-{bands['jax'][1]:.2f}")
    if args.json:
        print(json.dumps({"epochs": rows, "valid": {s: {"port": port_v[s], "jax": ref_v[s]} for s in steps},
                          "class_bands": bands}))


if __name__ == "__main__":
    main()

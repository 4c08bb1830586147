"""Per-epoch validation of the port's production-recipe run against the JAX
package's prod_r5 run, as a Markdown table and, with --json, one JSON line.

    python artifacts/port_prod_r1/compare.py [--port PATH] [--ref PATH] [--json]

Both files are the trainers' ``metrics.jsonl``. An epoch is matched by its
step (128 steps an epoch at the recipe's 2048 images and batch 16). Printed
per epoch: ``Loss/valid/loss_model``, ``Metric/mAP`` and
``Metric/coco_mAP`` of both runs; then, over the epochs both ran, the
range of each metric in the last 10 of them (the bands the runs are held
to: their initial weights differ, so they are compared as bands, not bits).
"""

import argparse
import json
import os

TAGS = ("Loss/valid/loss_model", "Metric/mAP", "Metric/coco_mAP")
HERE = os.path.dirname(os.path.abspath(__file__))


def per_step(path: str) -> dict[int, dict[str, float]]:
    out: dict[int, dict[str, float]] = {}
    with open(path) as f:
        for line in f:
            record = json.loads(line)
            if record.get("tag") in TAGS:
                out.setdefault(int(record["step"]), {})[record["tag"]] = float(record["value"])
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--port", default=os.path.join(HERE, "metrics.jsonl"))
    p.add_argument("--ref", default=os.path.join(HERE, "..", "prod_r5", "metrics.jsonl"))
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    port, ref = per_step(args.port), per_step(args.ref)
    steps = sorted(s for s in port if s in ref)
    print("| epoch | step | " + " | ".join(f"{t} port | JAX" for t in TAGS) + " |")
    print("|---" * (2 + 2 * len(TAGS)) + "|")
    for s in steps:
        cells = " | ".join(f"{port[s].get(t, float('nan')):.4f} | {ref[s].get(t, float('nan')):.4f}" for t in TAGS)
        print(f"| {s // 128 - 1} | {s} | {cells} |")
    last = steps[-10:]
    bands = {t: {name: [min(run[s][t] for s in last), max(run[s][t] for s in last)]
                 for name, run in (("port", port), ("jax", ref))} for t in TAGS}
    print(f"\nlast {len(last)} common epochs (steps {last[0]}-{last[-1]}): " + "; ".join(
        f"{t} port {b['port'][0]:.4f}-{b['port'][1]:.4f}, JAX {b['jax'][0]:.4f}-{b['jax'][1]:.4f}"
        for t, b in bands.items()))
    if args.json:
        print(json.dumps({"epochs": len(steps), "last_steps": last, "bands": bands}))


if __name__ == "__main__":
    main()

"""The port's run of record of the production DESTR recipe against the JAX
package's (``../prod_r5/metrics_r5b.jsonl``), as Markdown tables and, with
--json, one JSON line.

    python artifacts/port_prod_r2/compare.py [--port PATH] [--ref PATH] [--json]

Both files are the trainers' ``metrics.jsonl``; an epoch is matched by its
step (128 steps an epoch at the recipe's 2048 images and batch 16). Printed:
every 8th epoch both ran (validation ``loss_model``, ``Metric/mAP``,
``Metric/coco_mAP``, ``Metric/ema_mAP``, ``Metric/ema_coco_mAP``); the
post-lr_drop plateau, every validation after the drop's step (90 x 128 =
11520), as median / mean / min / max of the four metrics for both runs and
beside the table BASELINE.md records for JAX (l.989-999); whether the port's
plateau median ref-mAP reaches JAX's bar of 0.50; and the standalone
re-scores (``eval_*_nv{256,1024}.json``) of both runs' best-val and best-EMA
checkpoints. The two runs start from different random weights and JAX's
came by another path (epochs 0-49 at lr_backbone 1e-4 without EMA, then a
resume), so they are compared as bands, not step for step.
"""

import argparse
import json
import os
import statistics

HERE = os.path.dirname(os.path.abspath(__file__))
REF_DIR = os.path.join(HERE, "..", "prod_r5")
LOSS = "Loss/valid/loss_model"
METRICS = {"ref mAP": "Metric/mAP", "COCO mAP": "Metric/coco_mAP", "EMA ref": "Metric/ema_mAP",
           "EMA COCO": "Metric/ema_coco_mAP"}
STEPS_PER_EPOCH = 128
DROP_STEP = 90 * STEPS_PER_EPOCH
BAR = 0.50  # JAX's own: the plateau's median ref-mAP
# BASELINE.md l.989-999, JAX's plateau (epochs 91-118, 28 validations): median, mean, min, max
BASELINE_PLATEAU = {"ref mAP": (0.5238, 0.4956, 0.4339, 0.5327), "COCO mAP": (0.5441, 0.5405, 0.5131, 0.5711),
                    "EMA ref": (0.4440, 0.4788, 0.4389, 0.5323), "EMA COCO": (0.5437, 0.5429, 0.5284, 0.5534)}
# the re-scores: (the port's file, JAX's file)
RESCORES = [("eval_port_prod_r2_nv256.json", "eval_prod_r5b_nv256.json"),
            ("eval_port_prod_r2_nv1024.json", "eval_prod_r5b_nv1024.json"),
            ("eval_port_prod_r2_ema_nv256.json", "eval_prod_r5b_ema_nv256.json"),
            ("eval_port_prod_r2_ema_nv1024.json", "eval_prod_r5b_ema_nv1024.json")]


def per_step(path: str) -> dict[int, dict[str, float]]:
    tags = (LOSS, *METRICS.values())
    out: dict[int, dict[str, float]] = {}
    with open(path) as f:
        for line in f:
            record = json.loads(line)
            if record.get("tag") in tags:
                out.setdefault(int(record["step"]), {})[record["tag"]] = float(record["value"])
    return out


def plateau(run: dict[int, dict[str, float]]) -> dict:
    """{metric: [median, mean, min, max], "n": validations} after the drop."""
    steps = [s for s in sorted(run) if s > DROP_STEP]
    out = {"n": len(steps), "steps": [steps[0], steps[-1]] if steps else []}
    for name, tag in METRICS.items():
        values = [run[s][tag] for s in steps if tag in run[s]]
        out[name] = [statistics.median(values), statistics.mean(values), min(values), max(values)] if values else None
    return out


def row(values) -> str:
    return " / ".join(f"{v:.4f}" for v in values) if values else "n/a"


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--port", default=os.path.join(HERE, "metrics.jsonl"))
    p.add_argument("--ref", default=os.path.join(REF_DIR, "metrics_r5b.jsonl"))
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    port, ref = per_step(args.port), per_step(args.ref)

    tags = (LOSS, *METRICS.values())
    common = [s for s in sorted(port) if s in ref and (s // STEPS_PER_EPOCH) % 8 == 0]
    print("| epoch | step | " + " | ".join(f"{t} port | JAX" for t in tags) + " |")
    print("|---" * (2 + 2 * len(tags)) + "|")
    for s in common:
        cells = " | ".join(f"{port[s].get(t, float('nan')):.4f} | {ref[s].get(t, float('nan')):.4f}" for t in tags)
        print(f"| {s // STEPS_PER_EPOCH} | {s} | {cells} |")

    ours, theirs = plateau(port), plateau(ref)
    print(f"\nplateau, every validation after step {DROP_STEP}: port {ours['n']} (steps {ours['steps']}), "
          f"JAX {theirs['n']} (steps {theirs['steps']})")
    print("| metric | port median / mean / min / max | JAX metrics_r5b.jsonl | JAX BASELINE.md |")
    print("|---|---|---|---|")
    for name in METRICS:
        print(f"| {name} | {row(ours[name])} | {row(theirs[name])} | {row(BASELINE_PLATEAU[name])} |")
    met = ours["ref mAP"] is not None and ours["ref mAP"][0] >= BAR
    print(f"\nthe port's plateau median ref-mAP {row(ours['ref mAP'][:1]) if ours['ref mAP'] else 'n/a'} "
          f">= {BAR}: {met}")

    rescores = []
    print("\n| checkpoint | images | port ref mAP | COCO | JAX ref mAP | COCO |")
    print("|---|---|---|---|---|---|")
    for mine, jax in RESCORES:
        path = os.path.join(os.path.dirname(os.path.abspath(args.port)), mine)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            a = json.load(f)
        with open(os.path.join(REF_DIR, jax)) as f:
            b = json.load(f)
        rescores.append({"port": a, "jax": b})
        print(f"| {a['checkpoint']} / {b['checkpoint']} | {a['n_images']} | {a['map']:.4f} | {a['coco_map']:.4f} "
              f"| {b['map']:.4f} | {b['coco_map']:.4f} |")
    result = {"plateau": {"port": ours, "jax": theirs}, "bar": BAR, "bar_met": met, "rescores": rescores,
              "last_step": max(port) if port else None}
    if args.json:
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

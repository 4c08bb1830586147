"""The noise of chip_smoke.py phase 17 (b) on one card: how far the trainer's
resumed steps and tools/postmortem_divergence_torch.py's replays of them lie
apart, and how often the phase's criterion fails when nothing is wrong.

Run from the root of a tree on the card. It builds the flash and auction
kernels, trains chip_smoke's post-mortem epoch (``TRAIN_ARGS``,
``PM_STEPS`` steps, bfloat16, hidden 256) to ``pm_last``, then alternates
``--resumes`` resumes of the trainer from it with ``--replays`` replays by
the tool, each logging ``PM_STEPS`` steps, all in one process as the phase
runs them. It prints the card (nvidia-smi name, power limit), and one line
``PM {json}``: every run's rows of ``chip_smoke.PM_KEYS`` by step, and

* ``first_equal``: every run's first step equal to the first resume's (to
  the trainer log's rounding, 1e-6);
* ``fail_rate``: for each replay, over ``--draws`` random draws of
  ``PM_RESUMES`` resumes, the share of draws in which
  ``chip_smoke.pm_verdict`` fails (``--resumes-drawn`` / ``--factor`` set
  them; chip_smoke's by default); also with a held-out resume in the
  replay's place, which no fault can make different;
* per key and step: the mean and standard deviation of the resumes and of
  the replays;
* ``criteria``: for each (resumes drawn, factor) of ``CRITERIA``, the share
  of ``--draws`` draws from all runs pooled (resumes and replays) in which
  one run fails against the others, with every value of its last step
  shifted by 0, 2, 3, 4, 5, 6 and 8 standard deviations of its key: the
  false-failure rate at 0, the power against a fault of that size beyond.

``--analyze FILE`` reads the ``PM`` line of an earlier run's output and
prints its analysis again, on any machine.

    python3 artifacts/port_f32_bwd_r1/postmortem_noise.py [--resumes 32] [--replays 16] [--draws 4000]
    python3 artifacts/port_f32_bwd_r1/postmortem_noise.py --analyze pm_noise_r8.txt
"""
import argparse
import json
import os
import random
import shutil
import statistics
import sys
import tempfile

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402

CRITERIA = ((4, 2.0), (8, 1.0), (8, 1.25), (10, 1.0), (10, 1.25), (12, 1.0))
SHIFTS = (0, 2, 3, 4, 5, 6, 8)


def fail_rate(item, pool, draws, rng, k, factor):
    """The share of ``draws`` random draws of ``k`` runs of ``pool`` in
    which ``item`` fails the phase's criterion against them."""
    return sum(not cs.pm_verdict(item, rng.sample(pool, k), factor)["ok"] for _ in range(draws)) / draws


def criteria_table(runs, draws, rng):
    """{"k x factor": [fail share at each of SHIFTS]} over draws of k + 1
    runs, one shifted and held against the other k."""
    last = cs.PM_STEPS - 1
    sigma = [statistics.pstdev([r[last][j] for r in runs]) for j in range(len(cs.PM_KEYS))]
    table = {}
    for k, factor in CRITERIA:
        row = []
        for shift in SHIFTS:
            fails = 0
            for _ in range(draws):
                item, *others = rng.sample(runs, k + 1)
                item = item[:last] + [[x + shift * s for x, s in zip(item[last], sigma)]]
                fails += not cs.pm_verdict(item, others, factor)["ok"]
            row.append(fails / draws)
        table[f"{k} x {factor}"] = row
    return table


def analyze(result, draws, seed, k, factor):
    """The fail rates, moments and criteria table of a run's rows."""
    resumes, replays = result["resumes"], result["replays"]
    rng = random.Random(seed)
    first = resumes[0][0]
    result["first_equal"] = all(max(abs(x - y) for x, y in zip(run[0], first)) <= 1e-6 for run in resumes + replays)
    result["fail_rate"] = {"k": k, "factor": factor,
                           "replays": [fail_rate(r, resumes, draws, rng, k, factor) for r in replays],
                           "held_out_resumes": [fail_rate(r, resumes[:i] + resumes[i + 1:], draws, rng, k, factor)
                                                for i, r in enumerate(resumes)]}
    result["moments"] = {}
    for s in range(cs.PM_STEPS):
        for j, key in enumerate(cs.PM_KEYS):
            a, b = [r[s][j] for r in resumes], [r[s][j] for r in replays]
            result["moments"][f"{key} step {s}"] = {"resumes": [statistics.mean(a), statistics.pstdev(a)],
                                                    "replays": [statistics.mean(b), statistics.pstdev(b)]}
    result["criteria"] = {"shifts": list(SHIFTS), **criteria_table(resumes + replays, draws, rng)}
    card = result.get("card", "")
    for name in ("replays", "held_out_resumes"):
        rates = result["fail_rate"][name]
        cs.log(f"pm noise ({card}): {name} against {k} resumes, factor {factor}: mean fail rate "
               f"{statistics.mean(rates):.4f}, by run " + " ".join(f"{x:.3f}" for x in rates))
    for name, row in result["criteria"].items():
        if name != "shifts":
            cs.log(f"pm noise ({card}): {name}: fail share at shifts {list(SHIFTS)} sd: "
                   + " ".join(f"{x:.4f}" for x in row))
    return result


def run(args):
    """The runs on the card (see the module's docstring)."""
    import torch
    from object_detection_destr_tpu_torch.ops.cuda import auction
    from object_detection_destr_tpu_torch.ops.cuda import flash_attention as fa
    from object_detection_destr_tpu_torch.train import train as train_cli

    card = cs.phase_device(torch)
    cs.phase_build([fa.FWD_LIBRARY, fa.BWD_LIBRARY, fa.TWO_PASS_LIBRARY, auction.LIBRARY])
    tool = cs.repo_module("postmortem_divergence_torch", os.path.join("tools", "postmortem_divergence_torch.py"))
    work = tempfile.mkdtemp(prefix="pm_noise_", dir=os.path.join(os.getcwd(), cs.PKG, "_build"))
    try:
        base = cs.TRAIN_ARGS + ["--seed", str(args.seed), "--num_train_samples", str(cs.PM_STEPS * cs.TRAIN_B),
                                "--num_valid_samples", "0", "--checkpoint_dir", work]
        train_cli.main(base + ["--save_as", "pm", "--log_dir", ""])
        resumes, replays = [], []
        for i in range(max(args.resumes, args.replays)):
            if i < args.resumes:
                run_dir = os.path.join(work, f"resume{i}")
                train_cli.main(base + ["--save_as", f"resume{i}", "--resume", "--resume_from", "pm_last",
                                       "--log_dir", run_dir])
                os.remove(os.path.join(work, f"resume{i}_last"))
                log_ = cs._train_log(os.path.join(run_dir, "metrics.jsonl"))
                resumes.append([[log_[s][k] for k in cs.PM_KEYS] for s in sorted(log_)])
            if i < args.replays:
                out = tool.main(base + ["--resume", "--resume_from", "pm_last", "--log_dir", "", "--steps",
                                        str(cs.PM_STEPS), "--out", os.path.join(work, "postmortem.jsonl")])
                replays.append([[round(row[key], 6) for key in cs.PM_KEYS.values()] for row in out["rows"]])
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"card": card, "keys": list(cs.PM_KEYS), "resumes": resumes, "replays": replays}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--resumes", type=int, default=32)
    parser.add_argument("--replays", type=int, default=16)
    parser.add_argument("--draws", type=int, default=4000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--resumes-drawn", type=int, default=cs.PM_RESUMES)
    parser.add_argument("--factor", type=float, default=cs.PM_FACTOR)
    parser.add_argument("--analyze", default=None, help="an earlier run's output holding its PM line")
    args = parser.parse_args()
    if args.analyze:
        with open(args.analyze) as f:
            result = json.loads(next(line for line in f if line.startswith("PM "))[3:])
    else:
        result = run(args)
    result = analyze(result, args.draws, args.seed, args.resumes_drawn, args.factor)
    print("PM " + json.dumps(result), flush=True)


if __name__ == "__main__":
    main()

"""The per-step losses of the trainer's resumes from one checkpoint and of
the post-mortem replay of the same steps on the card, with cuDNN's default
and its deterministic engines (3 resumes and 2 replays each): how far apart
two runs of a step are.

    python3 artifacts/port_tools_r1/pm_gaps.py   # on a machine with one H100

Its output of one run is ``pm_gaps_run3.log``; ``check_rates.py`` reads it.
"""
import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from object_detection_destr_tpu_torch.ops.cuda import auction  # noqa: E402
from object_detection_destr_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402
from object_detection_destr_tpu_torch.train import train as train_cli  # noqa: E402

card = cs.phase_device(torch)
cs.phase_build([fa.FWD_LIBRARY, fa.BWD_LIBRARY, auction.LIBRARY])
tool = cs.repo_module("pm", os.path.join("tools", "postmortem_divergence_torch.py"))
work = tempfile.mkdtemp(dir=os.path.join(REPO, cs.PKG, "_build"))
base = cs.TRAIN_ARGS + ["--seed", "0", "--num_train_samples", str(cs.PM_STEPS * cs.TRAIN_B), "--num_valid_samples",
                        "0", "--checkpoint_dir", work]
import contextlib, io


def q(fn, *a):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a)


try:
    q(train_cli.main, base + ["--save_as", "pm", "--log_dir", ""])
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        series = []
        for r in range(3):
            d = os.path.join(work, f"r{det}{r}")
            q(train_cli.main, base + ["--save_as", f"r{r}", "--resume", "--resume_from", "pm_last", "--log_dir", d])
            log = cs._train_log(os.path.join(d, "metrics.jsonl"))
            series.append(("resume", [[log[s][k] for k in cs.PM_KEYS] for s in sorted(log)]))
        for r in range(2):
            out = q(tool.main, base + ["--resume", "--resume_from", "pm_last", "--log_dir", "", "--steps", "2",
                                       "--out", os.path.join(work, "pm.jsonl")])
            series.append(("replay", [[round(row[v], 6) for v in cs.PM_KEYS.values()] for row in out["rows"]]))
        cs.log(f"cudnn.deterministic={det}")
        for kind, rows in series:
            cs.log(f"  {kind}: " + " | ".join(" ".join(f"{x:.6f}" for x in row) for row in rows))
finally:
    shutil.rmtree(work, ignore_errors=True)

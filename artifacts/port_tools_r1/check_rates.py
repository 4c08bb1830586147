"""How often a check of the post-mortem replay against the trainer's resumes
would fail when the replay is one more run like them: over every ordered
draw of distinct runs from the second replayed step's losses of
``pm_gaps_run3.log`` (10 runs: 3 resumes and 2 replays, with cuDNN's
default and its deterministic engines), the share of draws in which the
replay's largest loss gap to the nearest of k resumes exceeds twice the
largest gap between two of them (plus 1e-6), for k = 2, 3, 4. k = 2 with
the first resume is also given.

    python artifacts/port_tools_r1/check_rates.py
"""

import itertools
import os

import numpy as np


def second_steps(path):
    """The 5 losses of the second replayed step of each run in the log."""
    runs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith(("resume:", "replay:")):
                steps = line.split(":", 1)[1].split("|")
                runs.append([float(v) for v in steps[1].split()])
    return np.asarray(runs)


def fail_rate(x, k, nearest=True):
    fails = total = 0
    for draw in itertools.permutations(range(len(x)), k + 1):
        resumes, replay = x[list(draw[:k])], x[draw[k]]
        spread = max(np.abs(a - b).max() for a in resumes for b in resumes)
        gaps = [np.abs(replay - r).max() for r in resumes]
        gap = min(gaps) if nearest else gaps[0]
        fails += gap > 2 * spread + 1e-6
        total += 1
    return fails / total


if __name__ == "__main__":
    x = second_steps(os.path.join(os.path.dirname(os.path.abspath(__file__)), "pm_gaps_run3.log"))
    print(f"{len(x)} runs; second step's loss {x[:, 0].min():.6f}-{x[:, 0].max():.6f}")
    print(f"k=2, against the first resume: {fail_rate(x, 2, nearest=False):.4f}")
    for k in (2, 3, 4):
        print(f"k={k}, against the nearest resume: {fail_rate(x, k):.4f}")

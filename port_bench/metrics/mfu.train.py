"""The traced steps' model operations (the reference's forward and
backward an image, counted by FlopCounterMode, times the images) over the
traced window's seconds, as a share of the bfloat16 peak."""

LAYER = "train step (train/epoch_scan.py, train/steps.py)"
UNIT = "%"
MOVES = "train_images_per_s"


def read(run: dict):
    t = run.get("trace")
    if not t or not t.get("steps") or t["window_s"] <= 0:
        return None
    images = t["steps"] * run["images"] / run["steps"]
    return 100.0 * run["flops_per_image"] * images / t["window_s"] / run["peak_flops"]

"""The share of the traced window in which no operation ran on the device."""

LAYER = "device"
UNIT = "%"
MOVES = "train_images_per_s"


def read(run: dict):
    t = run.get("trace")
    if not t or not t.get("steps") or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

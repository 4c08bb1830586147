"""The least time of the traced steps' attention work (every call site's
forward and fused backward from its shapes: bytes at 3.35 TB/s, operations
at the bfloat16 peak) over the device time of the port's flash kernels in
those steps."""

LAYER = "kernels (ops/cuda/flash_attention.py, csrc/flash_attention_*.cu)"
UNIT = "%"
MOVES = "train_images_per_s"


def read(run: dict):
    t = run.get("trace")
    if not t or not t.get("steps") or t["flash_s"] <= 0:
        return None
    return 100.0 * run["attention_bound_s"] * t["steps"] / t["flash_s"]

"""Device milliseconds a step of the elementwise and reduction kernels (the
family that is neither the port's kernels, convolutions, GEMM nor copies)
over the traced steps."""

from port_bench.harness.trace import OTHER

LAYER = "forward and backward (models/destr, models/resnet.py, autograd)"
UNIT = "ms"
MOVES = "train_images_per_s"


def read(run: dict):
    t = run.get("trace")
    if not t or not t.get("steps"):
        return None
    return 1e3 * t["families"].get(OTHER, 0.0) / t["steps"]

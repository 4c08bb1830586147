"""Device milliseconds a step of the ResNet's forward with ``reduce_dim`` and
the position map (the span ``backbone``) and its backward
(``backward.backbone``, from the gradient of C5 on): the sum of the spans'
medians over the spans stretch's replays of the captured step
(``port_bench/harness/spans.py``)."""

from port_bench.harness.spans import span_ms

LAYER = "backbone (models/resnet.py)"
UNIT = "ms"
MOVES = "train_images_per_s"
SPANS = ("backbone", "backward.backbone")


def read(run: dict):
    return span_ms(run, SPANS)

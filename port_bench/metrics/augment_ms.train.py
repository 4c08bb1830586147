"""Device milliseconds a step of the gather of the step's batch from the device
cache and the train transform (the span ``augment``): the sum of the spans'
medians over the spans stretch's replays of the captured step
(``port_bench/harness/spans.py``)."""

from port_bench.harness.spans import span_ms

LAYER = "augmentation (data/device_cache.py, data/transforms.py)"
UNIT = "ms"
MOVES = "train_images_per_s"
SPANS = ("augment",)


def read(run: dict):
    return span_ms(run, SPANS)

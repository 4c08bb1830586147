"""Device milliseconds a step of the fused cost and auction launch of both
criteria's matching (the span ``match``): the sum of the spans' medians over
the spans stretch's replays of the captured step
(``port_bench/harness/spans.py``)."""

from port_bench.harness.spans import span_ms

LAYER = "matcher (train/steps.py::_match_pair, ops/cuda/auction.py)"
UNIT = "ms"
MOVES = "train_images_per_s"
SPANS = ("match",)


def read(run: dict):
    return span_ms(run, SPANS)

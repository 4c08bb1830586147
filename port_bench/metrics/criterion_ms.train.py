"""Device milliseconds a step of both set criteria and their weighting, forward
(the span ``criterion``; its backward is in ``backward.heads``): the sum of
the spans' medians over the spans stretch's replays of the captured step
(``port_bench/harness/spans.py``)."""

from port_bench.harness.spans import span_ms

LAYER = "criterion (losses/criterion.py)"
UNIT = "ms"
MOVES = "train_images_per_s"
SPANS = ("criterion",)


def read(run: dict):
    return span_ms(run, SPANS)

"""Device milliseconds a step of the encoder, the mini-detector and the decoder
with the output heads, forward (the spans ``encoder``, ``mini_detector``,
``decoder``) and backward (``backward.heads``, which holds the criterion's
backward too, up to the encoder's output; ``backward.encoder``, from there
to C5): the sum of the spans' medians over the spans stretch's replays of
the captured step (``port_bench/harness/spans.py``)."""

from port_bench.harness.spans import span_ms

LAYER = "transformer (models/destr)"
UNIT = "ms"
MOVES = "train_images_per_s"
SPANS = ("encoder", "mini_detector", "decoder", "backward.encoder", "backward.heads")


def read(run: dict):
    return span_ms(run, SPANS)

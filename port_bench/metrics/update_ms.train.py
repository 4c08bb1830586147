"""Device milliseconds a step of the BatchNorm statistics guard and the AdamW
update with its global-norm clip (the span ``update``) and the parameters'
EMA (``ema``): the sum of the spans' medians over the spans stretch's
replays of the captured step (``port_bench/harness/spans.py``)."""

from port_bench.harness.spans import span_ms

LAYER = "optimizer and EMA (train/optim.py, _make_ema)"
UNIT = "ms"
MOVES = "train_images_per_s"
SPANS = ("update", "ema")


def read(run: dict):
    return span_ms(run, SPANS)

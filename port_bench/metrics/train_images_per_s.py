"""Images trained a second: every image of every step the window ran, over
the window's seconds (from the first step enqueued after set-up to the
synchronize after the last), epoch boundaries included."""

UNIT = "images/s"


def read(run: dict):
    if "images" not in run:
        return None
    return run["images"] / run["window_s"]

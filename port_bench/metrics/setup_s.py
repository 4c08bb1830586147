"""Set-up seconds: from the process's start to the first timed step or
request (building or loading the kernels, the inputs, the model, warm-up
and capture)."""

UNIT = "s"


def read(run: dict):
    return run.get("setup_s")

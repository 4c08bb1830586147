"""The most device memory the training process allocated, set-up and window
(``torch.cuda.max_memory_allocated`` when the window closes): the eager
first step and the capture set it, since a replay allocates nothing. It
bounds the batch a user can train."""

LAYER = "device memory"
UNIT = "GiB"
MOVES = "train_images_per_s"


def read(run: dict):
    if "images" not in run or not run.get("memory_peak_bytes"):
        return None
    return run["memory_peak_bytes"] / 2**30

"""The device the run measures, and its memory readings (the CPU, where a
test drives a run without a card, reads 0)."""

from __future__ import annotations

import torch

__all__ = ["cuda_or_cpu", "synchronize", "memory_peak", "reset_peak", "empty_cache"]


def cuda_or_cpu() -> torch.device:
    return torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def memory_peak(dev: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def empty_cache(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()

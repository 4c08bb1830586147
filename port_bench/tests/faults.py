"""Faults planted in the program under a run, to show that ``correct``
catches them: a training step that leaves the state unchanged, and a step
that leaves out half of its batch (the mean taken over the rest). Each is a
context manager that patches the program for the block."""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

__all__ = ["FAULTS", "unchanged_state", "half_batch"]


def _patched_core(wrap):
    import object_detection_destr_tpu_torch.train.steps as steps

    original = steps.make_destr_step_core

    def make(cfg, mesh=None, observer=None):
        return wrap(original(cfg, mesh, observer))

    return mock.patch.object(steps, "make_destr_step_core", make)


def unchanged_state():
    """The step computes its loss and gradient and leaves the parameters as
    they were."""

    def wrap(core):
        def step(state, batch):
            saved = [p.detach().clone() for p in state.model.parameters()]
            metrics = core(state, batch)
            with torch.no_grad():
                for p, s in zip(state.model.parameters(), saved):
                    p.copy_(s)
            return metrics

        return step

    return _patched_core(wrap)


def half_batch():
    """The step trains on the first half of its batch only."""

    def wrap(core):
        def step(state, batch):
            half = next(iter(batch.values())).shape[0] // 2
            return core(state, {k: v[:half] for k, v in batch.items()})

        return step

    return _patched_core(wrap)


FAULTS = {"unchanged": unchanged_state, "half": half_batch}


@contextlib.contextmanager
def planted(name):
    """``planted(None)`` plants nothing."""
    if name is None:
        yield
        return
    with FAULTS[name]():
        yield

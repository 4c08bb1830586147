"""A cell cut to a size a CPU test run can hold: the real cell's mix and
limits, a two-block DESTR of width 32 on the full ResNet, 64 px inputs,
eight small training images. Training runs in float32 here: in bfloat16 on
the CPU the program's plain attention backward rounds otherwise than the
reference's autograd, and Adam's first steps carry that into the change of
every leaf (with the program's choices replayed, ``choices.py``, the worst
leaf's change still reads 0.065-0.085 at this size; on the card, at the
cell's size, the choices are what moves it)."""

from __future__ import annotations

import copy
import time

from port_bench.harness import cli, registry

TINY_MODEL = dict(hidden_dim=32, num_heads=4, num_encoder_blocks=2, num_decoder_blocks=2, ffn_dim=64, top_k=8)


def tiny_cell(name: str) -> registry.Cell:
    cell = registry.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["model"].update(TINY_MODEL)
    cfg["train"].update(batch_size=2, image_size=64, compute_dtype="float32")
    params = dict(cell.params, sizes=[[48, 64], [64, 48], [43, 64]], images=8, chunk_steps=2, trace_steps=2)
    return registry.Cell(cell.name, cell.entry, cfg, params)


def tiny_ctx(name: str, work_dir, seed: int = 2**31 + 12345, seconds: float = 1.0) -> cli.Ctx:
    return cli.Ctx(tiny_cell(name), seed, seconds, False, time.perf_counter(), str(work_dir), lambda m: None)


def run_tiny(name: str, work_dir, seed: int = 2**31 + 12345, seconds: float = 1.0):
    """(run, checks) of a tiny run of cell ``name`` on the CPU."""
    ctx = tiny_ctx(name, work_dir, seed, seconds)
    generator = registry.load_generator(ctx.cell.generator)
    run = generator.measure(ctx)
    return run, generator.check(ctx, run)

"""Training from the device cache: the trainer's ``--device_cache
--epoch_scan`` path, epochs of one captured step replayed.

Set-up writes the cell's COCO tree from the seed, builds the program's
loader, its device cache, the model with the benchmark's seeded weights,
the train state, the step core, the train transform and the EMA, and the
:class:`EpochRunner` over them, as ``train/driver.py::_fit`` builds them.
The runner's first call takes the first ``check_steps`` rows of epoch 0
(its first step eager, then the capture, then replays): the reference
follows those steps after the window. The window continues that epoch and
the next ones through the same call, ``chunk_steps`` rows at a time (each
call ends in a read of its metrics, as an epoch's end does in the
trainer), until ``seconds`` have passed at a chunk's end. With ``trace`` the
profiler covers ``trace_steps`` rows after the first chunk of the window.

Parameters (the mix's, with the cell's on top): ``images`` in the tree and
their ``sizes`` (H, W) in turn, ``chunk_steps``, ``check_steps``, ``trace_steps``, and ``limits`` of the
compared numbers."""

from __future__ import annotations

import gc
import re
import time

import torch

from port_bench.harness import compare, device
from port_bench.harness.coco_tree import write_coco_tree
from port_bench.harness.roofline import attention_bound_s, peak_for
from port_bench.harness.trace import FLASH, Trace, breakdown, family_seconds, parse_trace
from port_bench.reference import steps as reference
from port_bench.reference.weights import seeded_weights


def _program(ctx, root: str, dev: torch.device):
    """The program's objects, built as the trainer builds them."""
    from object_detection_destr_tpu_torch.config import DestrConfig, TrainConfig
    from object_detection_destr_tpu_torch.data import DetectionLoader, build_dataset, destr_train_transform
    from object_detection_destr_tpu_torch.data.device_cache import DeviceCachedLoader
    from object_detection_destr_tpu_torch.models.destr.model import build_destr
    from object_detection_destr_tpu_torch.ops.cuda import auction, flash_attention
    from object_detection_destr_tpu_torch.ops.cuda.build import build_all
    from object_detection_destr_tpu_torch.train.driver import _aug_seed, _make_ema
    from object_detection_destr_tpu_torch.train.epoch_scan import EpochRunner
    from object_detection_destr_tpu_torch.train.state import create_destr_state
    from object_detection_destr_tpu_torch.train.steps import make_destr_step_core

    cfg = ctx.cell.config
    m_cfg, t_cfg, d_cfg = cfg["model"], cfg["train"], cfg["data"]
    t0 = time.perf_counter()
    if dev.type == "cuda":
        build_all([flash_attention.FWD_LIBRARY, flash_attention.BWD_LIBRARY, flash_attention.TWO_PASS_LIBRARY,
                   auction.LIBRARY])
    t_build = time.perf_counter()
    train_cfg = TrainConfig(**{k: v for k, v in t_cfg.items() if k in TrainConfig.__dataclass_fields__},
                            seed=ctx.seed)
    canvas = int(t_cfg["image_size"] * 672 / 640)
    dataset = build_dataset("coco", root, "train", image_size=t_cfg["image_size"],
                            max_items_per_img=d_cfg["max_targets"], seed=ctx.seed)
    loader = DetectionLoader(dataset, batch_size=t_cfg["batch_size"], canvas_size=canvas,
                             max_targets=d_cfg["max_targets"], augment_factor=1, shuffle=True, seed=ctx.seed)
    cache = DeviceCachedLoader(loader, dev)
    t_cache = time.perf_counter()
    destr_cfg = DestrConfig(**m_cfg, compute_dtype=t_cfg["compute_dtype"])
    with torch.device(dev):
        model = build_destr(destr_cfg, dev)
    seeded_weights(model, ctx.seed)
    state = create_destr_state(model, train_cfg, steps_per_epoch=len(cache))
    transform = lambda raw, gen: destr_train_transform(raw["images"], raw["boxes"], raw["labels"], raw["valid"],
                                                       gen, raw.get("content_hw"), out_size=t_cfg["image_size"])
    ema = None
    if train_cfg.ema_decay:
        ema_init, ema_update = _make_ema(train_cfg.ema_decay)
        ema = (ema_init(model), ema_update)
    runner = EpochRunner(state, make_destr_step_core(train_cfg), transform, cache.data,
                         lambda step: _aug_seed(train_cfg.seed, step, 7), len(cache), ema=ema)
    ctx.log(f"set-up: kernels {t_build - t0:.2f} s, tree decoded into the device cache "
            f"({cache.nbytes / 1e9:.3f} GB) {t_cache - t_build:.2f} s, model and state "
            f"{time.perf_counter() - t_cache:.2f} s")
    return runner, cache, state


def measure(ctx) -> dict:
    cfg, p = ctx.cell.config, ctx.cell.params
    t_cfg = cfg["train"]
    dev = device.cuda_or_cpu()
    batch = t_cfg["batch_size"]
    t0 = time.perf_counter()
    root = f"{ctx.work_dir}/coco"
    write_coco_tree(root, ctx.seed, p["images"], sizes=[tuple(hw) for hw in p["sizes"]])
    ctx.log(f"set-up: the COCO tree of {p['images']} images {time.perf_counter() - t0:.2f} s")
    runner, cache, state = _program(ctx, root, dev)

    # the first steps through the window's own call, for the reference
    n_check = p["check_steps"]
    _, idx = cache.epoch_index_matrix()
    start = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    t_first = time.perf_counter()
    first = runner.run(idx[:1], 0)
    b1 = state.optimizer.b1
    grad = {k: float(m.float().norm()) / (1.0 - b1) for k, m in state.optimizer.m.items()}
    t_capture = time.perf_counter()
    rest = runner.run(idx[1:n_check], 1)
    losses = {k: [float(v) for v in list(first[k]) + list(rest[k])] for k in ("loss", "loss_model", "loss_det")}
    change = {k: float((v.detach() - start[k]).float().norm()) for k, v in state.model.named_parameters()}
    del start
    ctx.log(f"set-up: eager step and capture {t_capture - t_first:.2f} s, {n_check - 1} replays "
            f"{time.perf_counter() - t_capture:.2f} s")

    device.synchronize(dev)
    setup_s = time.perf_counter() - ctx.started
    trace = Trace(f"{ctx.work_dir}/trace") if ctx.trace else None
    trace_path, traced = None, 0
    pos, steps, chunk = n_check, 0, p["chunk_steps"]
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < ctx.seconds or (trace is not None and trace_path is None):
        if pos >= len(idx):
            cache.advance_epoch()
            _, idx = cache.epoch_index_matrix()
            pos = 0
        if trace is not None and trace_path is None and steps >= chunk:
            traced = min(p["trace_steps"], len(idx) - pos)
            trace.start()
            runner.run(idx[pos:pos + traced], state.step, step_scope=lambda step: Trace.range(f"step {step}"))
            trace_path = trace.stop()
            n = traced
        else:
            n = min(chunk, len(idx) - pos)
            runner.run(idx[pos:pos + n], state.step)
        pos += n
        steps += n
    device.synchronize(dev)
    window_s = time.perf_counter() - t_start
    peak = device.memory_peak(dev)
    run = {"cell": ctx.cell.name, "setup_s": setup_s, "window_s": window_s, "images": steps * batch,
           "steps": steps, "attempted": steps * batch, "failed": 0,
           "memory_peak_bytes": peak,
           "program": {**losses, "grad": grad, "change": change},
           "tree": root}
    del runner, cache, state
    gc.collect()
    device.empty_cache(dev)

    if trace_path is not None:
        t_parse = time.perf_counter()
        parsed = parse_trace(trace_path)
        ctx.log(f"trace: parsed in {time.perf_counter() - t_parse:.2f} s")
        run["trace"] = {"busy_s": parsed["busy_s"], "window_s": parsed["window_s"], "steps": traced,
                        "families": family_seconds(parsed),
                        "flash_s": sum(v["seconds"] for name, v in parsed["device_time"].items()
                                       if re.search(FLASH, name))}
        run["breakdown"] = breakdown(parsed)
        size = t_cfg["image_size"]
        run["flops_per_image"] = reference.model_flops(cfg["model"], batch, size, backward=True) / batch
        sites = reference.attention_work(cfg["model"], batch, size, t_cfg["compute_dtype"])
        run["attention_bound_s"] = sum(attention_bound_s(s, t_cfg["compute_dtype"], backward=True) for s in sites)
        run["peak_flops"] = peak_for(t_cfg["compute_dtype"])
    ctx.log(f"window: {steps} steps of {batch} in {window_s:.3f} s; set-up {setup_s:.2f} s; peak "
            f"{peak / 2**30:.2f} GiB")
    return run


def numbers(ctx, run: dict) -> dict:
    """The reference over the checked steps, held to the program's: every
    number :func:`compare.train_numbers` gives."""
    dev = device.cuda_or_cpu()
    t0 = time.perf_counter()
    t_cfg, p = ctx.cell.config["train"], ctx.cell.params
    rows = reference.epoch_rows(p["images"], t_cfg["batch_size"], ctx.seed)[:p["check_steps"]]
    ref = reference.train_steps(ctx.cell.config, ctx.seed, run["tree"], rows, dev)
    ctx.log(f"reference: {len(ref['loss'])} steps in {time.perf_counter() - t0:.2f} s; program / reference "
            + "; ".join(f"{k} {run['program'][k]} / {ref[k]}" for k in ("loss", "loss_model", "loss_det")))
    for key in ("grad", "change"):
        ctx.log(f"worst leaves by {key} (gap, program, reference): "
                + "; ".join(f"{k} {g:.4g} {a:.4g} {b:.4g}" for k, g, a, b in compare.worst_leaves(run["program"], ref, key)))
    return compare.train_numbers(run["program"], ref)


def check(ctx, run: dict) -> dict:
    """{number: (value, limit)} of the numbers the cell compares."""
    values = numbers(ctx, run)
    return {k: (values[k], limit) for k, limit in ctx.cell.params["limits"].items()}

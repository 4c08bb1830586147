"""Divergence post-mortem: replay the PyTorch port's DESTR training from one
of its checkpoints with per-step diagnostics; the port's counterpart of
``tools/postmortem_divergence.py``.

A run that diverges (the JAX run of record's losses jumped 3-4x inside one
32-step logging window near step 6700 and went NaN within about 100 steps)
cannot be localized from logged window means. This tool restores the
checkpoint (``train/checkpoint.py::restore_checkpoint``: the model, the
optimizer, the step, the train loader's (epoch, step) and ``best_val``)
into the trainer's own state and replays the steps through the trainer's
own eager step (``train/driver.py::_Run.eager_step``: the augmentation
generator reseeded from ``(seed + 7, step)``, then the train transform, then
``make_destr_train_step``, which reseeds the dropout stream from the step).
The batches come from the trainer's loader as it takes them, from device
memory under ``--device_cache`` (``data/device_cache.py``). Validation
sweeps do not touch the train state and are skipped. On the CPU the replay
equals the driver's run bit for bit.

The diagnostics come from the real step, not a second pass: an observer
(``make_destr_step_core(observer=...)``) sees the step's outputs, both
criteria's components and ``AdamW.step``'s pre-clip global gradient norm,
finite flag and whether the update applied; the gradients stay in
``.grad``; the update that landed is the parameters' change across the step.
One JSON line a step goes to ``--out``:

* ``step`` (the step count before the update; the trainer logs the same
  step's metrics as step + 1), ``epoch``, ``batch_indices`` (the dataset
  items of the batch, from the loader's ``default_rng((seed, epoch))``
  shuffle);
* ``m_class`` / ``m_bbox`` / ``m_ciou`` and ``d_*`` (the model's and the
  mini-detector's criterion, unweighted), ``loss``, ``loss_model``,
  ``loss_det``;
* ``grad_norm`` (pre-clip, global), ``grad_finite``, ``applied``, and
  ``g_<module>`` for each top-level module (backbone, encoder, decoder,
  mini_detector, the heads);
* ``update_norm``, ``update_finite``, ``u_<module>`` (the change that
  landed), ``params_finite`` (the parameters the step started from);
* ``min_gt_area``, ``mean_gt_area``, ``n_gt`` (the valid ground truths'
  cxcyhw h*w), ``max_abs_logit``, ``min_pred_area``, ``max_pred_hw``,
  ``min_pred_hw`` (the model's top-k predictions).

It stops ``--stop-after`` steps after the first non-finite gradient so the
trace brackets the event.

Which step runs: always the eager one. A checkpoint written by the captured
runner (``--epoch_scan``, ``train/epoch_scan.py``) replays eagerly; the
captured step is held to the eager one only within five eager steps' spread
(PERF.md), so on the GPU such a replay follows the run within that spread,
not bit for bit. On the GPU no two runs of a step are bit-equal anyway:
kernel #2 adds dQ with atomics. Judge a GPU replay against several of
the driver's own runs of the same steps from the same checkpoint
(``chip_smoke.py`` holds it within the largest gap between ten of them).

IMPORTANT: pass the run's exact data flags, ``--augment_factor`` in
particular (the parser's default is 5): a mismatch changes the epoch length
and the shuffle and feeds other batches. The tool prints steps/epoch at the
start; check it against the run's epoch stride. ``--compute_dtype float32``
replays in float32 (the JAX tool's ``--f32``; the trajectory then differs
from a bfloat16 run on purpose, and on the GPU the float32 kernel #2 runs).

Usage (the trainer's flags, the production recipe)::

    python tools/postmortem_divergence_torch.py --dataset synthetic \\
        --synthetic_size 672 --num_train_samples 2048 --num_valid_samples 256 \\
        --augment_factor 1 --image_size 640 --batch_size 16 \\
        --compute_dtype bfloat16 --num_encoder_blocks 6 --num_decoder_blocks 6 \\
        --top_k 300 --lr 1e-4 --lr_backbone 1e-4 --lr_drop 90 \\
        --lr_warmup_steps 1000 --class_norm boxes --set_cost_class 1 \\
        --set_cost_bbox 2.5 --set_cost_ciou 1 --grad_clip_norm 0.1 \\
        --skip_nonfinite 100 --device_cache --checkpoint_dir ckpt \\
        --resume --resume_from prod_last --steps 520 --out postmortem.jsonl

Runs on the GPU unless ``--device cpu`` is given, on one device. Prints one
JSON line last (the steps replayed, the first non-finite step, the output
file, the device). Imports torch, numpy and the port only.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from object_detection_destr_tpu_torch.geometry.boxes import xyxy_to_cxcyhw  # noqa: E402
from object_detection_destr_tpu_torch.train.arg_parser import config_from_args, get_parser  # noqa: E402
from object_detection_destr_tpu_torch.train.checkpoint import restore_checkpoint  # noqa: E402
from object_detection_destr_tpu_torch.train.driver import _destr_run, _mesh_of  # noqa: E402


def _norm(tensors) -> torch.Tensor:
    """The global 2-norm of ``tensors`` in float32."""
    return torch.stack([t.float().norm() for t in tensors]).square().sum().sqrt()


def _all_finite(tensors) -> torch.Tensor:
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


class Diagnostics:
    """Per-step diagnostics of a model's training: :meth:`begin` before a
    step keeps the parameters it starts from, the step's observer
    (:meth:`observe`) keeps what the step computed, and :meth:`record` after
    the step reads both, with the gradients in ``.grad`` and the parameters'
    change, into one row of floats (one copy to the host)."""

    def __init__(self):
        self._before: list[torch.Tensor] = []
        self._seen: dict = {}

    def begin(self, model: torch.nn.Module) -> None:
        self._before = [p.detach().clone() for p in model.parameters()]

    def observe(self, seen: dict) -> None:
        self._seen = seen

    @torch.no_grad()
    def record(self, model: torch.nn.Module) -> dict:
        seen, model_out, targets = self._seen, self._seen["model_out"], self._seen["targets"]
        names, params = zip(*model.named_parameters())
        modules = sorted({n.split(".")[0] for n in names})  # backbone, encoder, decoder, ... heads
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        deltas = [p.detach() - b for p, b in zip(params, self._before)]
        by_module = lambda tensors, m: [t for n, t in zip(names, tensors) if n.split(".")[0] == m]
        wh = xyxy_to_cxcyhw(targets["boxes"].float())[..., 2:]
        area = (wh[..., 0] * wh[..., 1])[targets["valid"]]
        phw = model_out["pred_boxes"][..., 2:].float()
        nan = torch.tensor(float("nan"), device=area.device)
        values = {
            **{f"m_{k}": v for k, v in seen["l_model"].items()},
            **{f"d_{k}": v for k, v in seen["l_det"].items()},
            "loss": seen["loss"], "loss_model": seen["loss_model"], "loss_det": seen["loss_det"],
            "min_gt_area": area.min() if area.numel() else nan,
            "mean_gt_area": area.mean() if area.numel() else nan,
            "n_gt": targets["valid"].sum(),
            "max_abs_logit": model_out["pred_class"].float().abs().max(),
            "min_pred_area": (phw[..., 0] * phw[..., 1]).min(),
            "max_pred_hw": phw.max(),
            "min_pred_hw": phw.min(),
            "grad_norm": seen["optimizer"]["grad_norm"],
            "grad_finite": seen["optimizer"]["finite"],
            "applied": seen["optimizer"]["applied"],
            **{f"g_{m}": _norm(by_module(grads, m)) for m in modules},
            "update_norm": _norm(deltas),
            "update_finite": _all_finite(deltas),
            **{f"u_{m}": _norm(by_module(deltas, m)) for m in modules},
            "params_finite": _all_finite(self._before),
        }
        fetched = torch.stack([v.detach().float().reshape(()) for v in values.values()]).cpu().tolist()
        return dict(zip(values, fetched))


def epoch_order(loader, epoch: int) -> np.ndarray:
    """The loader's virtual sample order of ``epoch``
    (``default_rng((seed, epoch))`` over ``augment_factor`` passes)."""
    order = np.arange(loader.num_samples)
    if loader.shuffle:
        np.random.default_rng((loader.seed, epoch)).shuffle(order)
    return order


def replay(config, device, out: str, steps: int, stop_after: int = 8, diagnose: bool = True) -> dict:
    """Restore ``config.train.resume_from`` into the trainer's state and run
    up to ``steps`` steps through its eager step, one row a step to ``out``
    (no diagnostics with ``diagnose=False``, the rows then hold the step,
    epoch, batch and the step's metrics only). Returns {"state", "rows",
    "first_nonfinite", "start_step"}."""
    cfg_t = config.train
    mesh, step_mesh, device = _mesh_of(config, device, None)
    if step_mesh is not None:
        raise ValueError("the post-mortem replays on one device; run it without a launcher")
    diag = Diagnostics() if diagnose else None
    run, train_loader, _ = _destr_run(config, mesh, step_mesh, device,
                                      observer=None if diag is None else diag.observe)
    state = run.state
    restored = restore_checkpoint(cfg_t.checkpoint_dir, cfg_t.resume_from, state)
    train_loader.load_state_dict(restored["loader"])
    base = getattr(train_loader, "base", train_loader)  # the host loader behind a device cache
    n_items = len(base.dataset)
    start_step = state.step
    print(f"restored at step {start_step} (best_val {restored['best_val']}); tracing {steps} steps "
        f"(compute={config.destr.compute_dtype}); steps/epoch={len(train_loader)} "
        f"(MUST match the run's epoch stride)", flush=True)
    gen = torch.Generator(device=device)
    rows, done, nonfinite = [], 0, None
    with open(out, "w") as f:
        while done < steps:
            loader_state = train_loader.state_dict()
            epoch, first = loader_state["epoch"], loader_state["step"]  # first: nonzero mid-epoch
            order = epoch_order(base, epoch)
            for step_in_epoch, raw in enumerate(train_loader, start=first):
                step = state.step
                if diag is not None:
                    diag.begin(state.model)
                metrics = run.eager_step(raw, device, gen, cfg_t.seed)
                lo = step_in_epoch * cfg_t.batch_size
                row = {"step": step, "epoch": int(epoch),
                       "batch_indices": (order[lo:lo + cfg_t.batch_size] % n_items).tolist()}
                if diag is not None:
                    row.update(diag.record(state.model))
                else:
                    row.update({k: float(v) for k, v in metrics.items()})
                f.write(json.dumps(row) + "\n")
                f.flush()
                rows.append(row)
                done += 1
                if diag is not None and not row["grad_finite"] and nonfinite is None:
                    nonfinite = step
                    print(f"FIRST NON-FINITE GRAD at step {nonfinite}; tracing {stop_after} more", flush=True)
                if nonfinite is not None and step - nonfinite >= stop_after:
                    done = steps
                if done >= steps:
                    break
    print(f"wrote {out}; first non-finite grad: {nonfinite}", flush=True)
    return {"state": state, "rows": rows, "first_nonfinite": nonfinite, "start_step": start_step}


def main(argv=None) -> dict:
    parser = get_parser("destr")
    parser.add_argument("--steps", type=int, default=520)
    parser.add_argument("--stop-after", type=int, default=8,
                        help="extra steps to trace past the first non-finite gradient")
    parser.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "postmortem.jsonl"))
    args = parser.parse_args(argv)
    config = config_from_args(args, "destr")
    result = replay(config, args.device, args.out, args.steps, args.stop_after)
    device = next(result["state"].model.parameters()).device
    summary = {"out": args.out, "start_step": result["start_step"], "steps": len(result["rows"]),
               "first_nonfinite_step": result["first_nonfinite"],
               "compute_dtype": config.destr.compute_dtype,
               "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    print(json.dumps(summary), flush=True)
    return {**summary, **result}


if __name__ == "__main__":
    main()

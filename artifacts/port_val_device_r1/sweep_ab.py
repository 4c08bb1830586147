"""Time the trainers' validation sweeps of one checkout of the repository:
the port's ``train/driver.py`` sweeps exactly as its trainers run them
(DESTR through ``_destr_run``'s own sweep, SSD through ``_ssd_val_sweep``
with the eval step ``train_ssd`` builds), on random weights from the seed.

    python3 artifacts/port_val_device_r1/sweep_ab.py TREE COCO_ROOT [--sweeps 2]

TREE is the checkout whose package is imported (this one, or a parent
unpacked with ``git archive``), COCO_ROOT a COCO-layout tree
(``chip_smoke.write_coco_tree``). Three cells, each swept ``--sweeps`` times
on one trainer state (the first sweep of a captured eval step includes its
capture): validate-coco-800 (DESTR-R50, --num_cls 81, 800 px, B=8, bf16,
COCO AP on), validate-coco-ssd-300 (SSD300, 80 classes, B=12, bf16) and
validate-640 (the production recipe on 672 px synthetic canvases, B=16).
Prints one line ``SWEEP {json}`` with each sweep's host seconds and
images/s. Needs one GPU.
"""
import json
import os
import subprocess
import sys
import time

TREE, COCO = os.path.abspath(sys.argv[1]), os.path.abspath(sys.argv[2])
SWEEPS = int(sys.argv[sys.argv.index("--sweeps") + 1]) if "--sweeps" in sys.argv else 2
DEVICE = "cuda"
sys.path.insert(0, TREE)
import torch  # noqa: E402

from object_detection_destr_tpu_torch.losses.metrics import MeanAveragePrecision  # noqa: E402
from object_detection_destr_tpu_torch.models.ssd import build_ssd  # noqa: E402
from object_detection_destr_tpu_torch.train import driver, steps  # noqa: E402
from object_detection_destr_tpu_torch.train.arg_parser import config_from_args, get_parser  # noqa: E402
from object_detection_destr_tpu_torch.train.state import create_ssd_state  # noqa: E402

RECIPE = ["--compute_dtype", "bfloat16", "--num_encoder_blocks", "6", "--num_decoder_blocks", "6", "--top_k", "300",
          "--epochs", "1", "--augment_factor", "1", "--log_dir", "", "--seed", "0"]
CELLS = {
    "validate-coco-800": ("destr", ["--dataset", "coco", "--data_root", COCO, "--num_cls", "81", "--image_size", "800",
                                    "--batch_size", "8", "--coco_eval", "--num_train_samples", "8",
                                    "--num_valid_samples", "64"] + RECIPE),
    "validate-coco-ssd-300": ("ssd", ["--dataset", "coco", "--data_root", COCO, "--num_cls", "80", "--epochs", "1",
                                      "--augment_factor", "1", "--log_dir", "", "--seed", "0",
                                      "--num_train_samples", "12", "--num_valid_samples", "96"]),
    "validate-640": ("destr", ["--dataset", "synthetic", "--synthetic_size", "672", "--image_size", "640",
                               "--batch_size", "16", "--num_train_samples", "16", "--num_valid_samples", "128"]
                     + RECIPE),
}


def sweeps_of(kind, argv):
    config = config_from_args(get_parser(kind).parse_args(argv), kind)
    mesh, _, device = driver._mesh_of(config, DEVICE, None)
    if kind == "destr":
        run, _, _ = driver._destr_run(config, mesh, None, device)
        sweep, images = run.sweep, (config.data.num_valid_samples // config.train.batch_size) * config.train.batch_size
    else:
        ssd_cfg = config.ssd
        _, valid_loader = driver._make_loaders(config, int(ssd_cfg.image_size * 1.28), "ssd")
        torch.manual_seed(config.train.seed)
        state = create_ssd_state(build_ssd(ssd_cfg, device), config.train, steps_per_epoch=1)
        eval_step = steps.make_ssd_eval_step(config.train, ssd_cfg)
        if hasattr(steps, "CapturedEvalStep"):  # as train_ssd builds it in a checkout that has it
            eval_step = steps.CapturedEvalStep(eval_step)
        metric = MeanAveragePrecision(num_cls=ssd_cfg.num_cls)
        sweep = lambda: driver._ssd_val_sweep(state, valid_loader, eval_step, metric, device, ssd_cfg.image_size)
        images = len(valid_loader) * config.train.batch_size
    out = []
    for _ in range(SWEEPS):
        means, m_ap, coco_ap, seconds = sweep()
        out.append({"seconds": seconds, "images_per_sec": images / seconds, "map": m_ap, "coco_map": coco_ap,
                    "means": means})
    return {"images": images, "sweeps": out}


card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip()
t0 = time.perf_counter()
result = {"tree": TREE, "card": card, "captured": hasattr(steps, "CapturedEvalStep"),
          "cells": {name: sweeps_of(kind, argv) for name, (kind, argv) in CELLS.items()}}
result["seconds"] = time.perf_counter() - t0
print("SWEEP " + json.dumps(result), flush=True)

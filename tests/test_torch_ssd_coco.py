"""BASELINE.json's config 1 on the CPU: SSD300 over COCO's 80 classes
(``--num_cls 80``, so ``A * 81`` confidence channels) on a COCO-layout tree,
the port against the JAX package.

The tree is ``chip_smoke.write_coco_tree``'s, as phase 21 writes it on the
card, at COCO's sizes (their aspects are not square, so SSD's stretch to its
384 px canvas, ``int(300 * 1.28)``, resizes every image). One SSD300 with
random flax variables (``test_torch_modules._random_variables``; the class
heads scaled by 8, so that the random weights' scores spread over the 81
channels instead of sitting near 1/81) is shared by the model cases, loaded
into both packages. The trainer's defaults of config 1
(``scripts/train_ssd_torch.sh``): B = 2 here, 300 px, ``reference`` hard
negative mining, lr 1e-5; float32 compute. Tolerances, and why:

- the loaders (valid and train split, SSD's canvas): boxes, labels and valid
  equal; images within one grey level, the bound of
  tests/test_torch_driver_loaders.py (the JAX package resizes with its
  native pool or cv2, the port with the same native pool or PyTorch's
  bilinear, which round differently; where both native pools build, as on
  this host, they are equal);
- one float32 train step at 80 classes on a batch of the tree, as
  tests/test_torch_ssd_train.py holds its step: losses 1e-5 relative; Adam's
  first moment per leaf, error 2-norm against the leaf's 2-norm, 1e-4 for
  the heads and 1e-2 for the extra blocks (their gradient passes the
  batch-statistics BatchNorm backward, whose nearly cancelling sums move by
  about 2e-3 of the norm under 1e-6 changes of the input). The same 1e-2
  holds the last class head, which test_torch_ssd_train.py's paper mining
  leaves at 0 but the reference mining trains here: it reads the last extra
  block's 1 x 1 output, normalized by the statistics of 2 values; in the
  port alone its moment moves by 6.8e-4 of its norm when the images change
  by 1e-6 relative, and it is 1.1e-3 from JAX's (the other heads: 2e-7 to
  8e-5 from JAX's, as far as that perturbation moves them); the extra blocks'
  BatchNorm statistics within 1e-4 of each statistic's largest value; the
  frozen VGG trunk unmoved. With 81 channels the reference mining ranks the
  background loss over a wider softmax, which is where a difference would
  show;
- ``MeanAveragePrecision(num_cls=80)`` on random outputs and targets over two
  updates (images that lack most classes, classes with no ground truth in
  the batch): the rank histograms and ground-truth counts equal, mAP within
  1e-6;
- ``infer.evaluate --model ssd`` against JAX's ``evaluate_ssd`` on the same
  weights over the tree's val split (each package's checkpoint reader
  stubbed to hand over those weights; both evaluators read the port's
  loader, so both models see the same pixels: the loaders are held against
  each other above): map within 1e-6, the val loss within 1e-4 relative, the
  localization diagnostics within 1e-4 relative;
- ``infer.cli --model ssd --num_cls 80`` on 3 JPEGs of three aspects in one
  invocation against JAX's ``DetectionService``: the same number of
  detections, each with one of the same label whose box and score are
  within 1e-5 (float32 VGG-16 summed in other orders; scores within 1e-5 of
  each other may swap places). The CLI stretches each decoded JPEG to 300 px
  with the port's resize; JAX's service is handed those stretched pixels,
  which it passes on unresized.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from object_detection_destr_tpu.infer import evaluate as jax_evaluate  # noqa: E402
from object_detection_destr_tpu.infer.server import DetectionService as JaxService  # noqa: E402
from object_detection_destr_tpu.losses.metrics import MeanAveragePrecision as JaxMap  # noqa: E402
from object_detection_destr_tpu.models.ssd.model import build_ssd as jax_build_ssd  # noqa: E402
from object_detection_destr_tpu.train import arg_parser as jax_args  # noqa: E402
from object_detection_destr_tpu.train import driver as jax_driver  # noqa: E402
from object_detection_destr_tpu.train.optim import build_optimizer  # noqa: E402
from object_detection_destr_tpu.train.state import TrainState as JaxTrainState  # noqa: E402
from object_detection_destr_tpu.train.state import _lr_specs as jax_lr_specs  # noqa: E402
from object_detection_destr_tpu.train.steps import flat_anchors as jax_flat_anchors  # noqa: E402
from object_detection_destr_tpu.train.steps import make_ssd_train_step as jax_make_step  # noqa: E402
from object_detection_destr_tpu_torch.data.loader import _resize_canvas  # noqa: E402
from object_detection_destr_tpu_torch.data.transforms import ssd_eval_transform  # noqa: E402
from object_detection_destr_tpu_torch.infer import cli, evaluate  # noqa: E402
from object_detection_destr_tpu_torch.losses.metrics import MeanAveragePrecision  # noqa: E402
from object_detection_destr_tpu_torch.models.convert import (  # noqa: E402
    flax_variables_from_state_dict,
    load_flax_variables,
    save_variables_npz,
    state_dict_from_flax,
)
from object_detection_destr_tpu_torch.models.ssd import build_ssd  # noqa: E402
from object_detection_destr_tpu_torch.train import arg_parser as port_args  # noqa: E402
from object_detection_destr_tpu_torch.train.driver import _make_loaders  # noqa: E402
from object_detection_destr_tpu_torch.train.state import create_ssd_state  # noqa: E402
from object_detection_destr_tpu_torch.train.steps import make_ssd_train_step  # noqa: E402

from test_torch_modules import _random_variables  # noqa: E402
from test_torch_train_step import _mu_tree  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401

NUM_CLS = 80  # COCO's classes; the heads add the background channel
SIZE = 300
CANVAS = int(SIZE * 1.28)  # 384, the SSD trainer's and evaluator's canvas
FLAGS = ["--num_cls", str(NUM_CLS), "--batch_size", "2", "--seed", "4", "--compute_dtype", "float32"]
HEAD_SCALE = 8.0
SCORE_THRESH = 0.1


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    written = chip_smoke.write_coco_tree(str(root), 7, n_train=4, n_valid=4)
    return root, written


@pytest.fixture(scope="module")
def model():
    """The JAX SSD300 at 80 classes and its random variables."""
    config = _configs(".")[1].ssd
    jax_model = jax_build_ssd(config)
    variables = _random_variables(jax_model, np.random.default_rng(0), jnp.zeros((1, SIZE, SIZE, 3)))
    for i in range(6):
        variables["params"][f"conf_head{i}"]["kernel"] = variables["params"][f"conf_head{i}"]["kernel"] * HEAD_SCALE
    return jax_model, variables


def _configs(root, extra=()):
    """Both SSD trainers' configs from config 1's flags on the tree."""
    argv = ["--dataset", "coco", "--data_root", str(root), *FLAGS, *extra]
    return [m.config_from_args(m.get_parser("ssd").parse_args(argv), "ssd") for m in (port_args, jax_args)]


def _port_model(variables):
    return load_flax_variables(build_ssd(_configs(".")[0].ssd, "cpu"), variables)


def test_loaders_match_jax(tree):
    """Both drivers' SSD loaders on the tree at SSD's canvas: every valid
    batch and the first train batch."""
    root, written = tree
    ours, ref = (make(cfg, CANVAS, "ssd") for make, cfg in zip((_make_loaders, jax_driver._make_loaders),
                                                                _configs(root)))
    assert ours[1].dataset.num_classes == ref[1].dataset.num_classes == NUM_CLS
    assert not ours[1].letterbox and not ref[1].letterbox
    seen = 0
    for split, a, b in (("train", ours[0], ref[0]), ("valid", ours[1], ref[1])):
        assert len(a) == len(b) == (10 if split == "train" else 2), split  # the train split augmented 5x
        pairs = list(zip(a, b))[: 1 if split == "train" else None]
        for mine, theirs in pairs:
            assert sorted(mine) == sorted(theirs) == ["boxes", "images", "labels", "valid"], split
            for key in ("boxes", "labels", "valid"):
                np.testing.assert_array_equal(mine[key], theirs[key], err_msg=f"{split} {key}")
            assert mine["images"].shape == (2, CANVAS, CANVAS, 3) and mine["images"].dtype == np.uint8
            diff = np.abs(mine["images"].astype(int) - theirs["images"].astype(int)).max()
            assert diff <= 1, (split, diff)
            if split == "valid":
                seen += int(mine["valid"].sum())
    # the val split's boxes, all of them through the loader
    assert seen == written["val2017"][1]
    # COCO's sizes are not square: the stretch resizes every image
    assert all(h != w for h, w in chip_smoke.COCO_SIZES)


def test_train_step_80_classes_matches_jax(tree, model):
    """One float32 SSD train step of each package at 80 classes, reference
    mining, on the first valid batch of the tree (SSD's deterministic eval
    transform to 300 px)."""
    root, _ = tree
    jax_model, variables = model
    port_cfg, jax_cfg = _configs(root)
    assert port_cfg.ssd.hard_neg_mining == jax_cfg.ssd.hard_neg_mining == "reference"
    raw = next(iter(_make_loaders(port_cfg, CANVAS, "ssd")[1]))
    prep = ssd_eval_transform(*(torch.from_numpy(raw[k]) for k in ("images", "boxes", "labels", "valid")),
                              out_size=SIZE)
    batch = {k: v.numpy() for k, v in prep.items()}
    assert batch["valid"].sum() >= 4 and len(np.unique(batch["labels"][batch["valid"]])) >= 4

    jcfg = jax_cfg.train
    lr, lr_bb = jax_lr_specs(jcfg, 10)
    params = jax.tree.map(jnp.asarray, variables["params"])
    tx = build_optimizer(params, lr=lr, lr_backbone=lr_bb, grad_clip=jcfg.grad_clip_norm or None,
                         skip_nonfinite=jcfg.skip_nonfinite_updates)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                          opt_state=tx.init(params), rng=jax.random.key(0))
    state, ref_metrics = jax_make_step(jax_model, tx, jcfg, jax_cfg.ssd)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    ref_vars = jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    mu = state_dict_from_flax({"params": _mu_tree(state.opt_state)})

    torch_model = _port_model(variables)
    assert torch_model.conf_head0.weight.shape[0] % (NUM_CLS + 1) == 0
    tstate = create_ssd_state(torch_model, port_cfg.train, steps_per_epoch=10)
    metrics = make_ssd_train_step(port_cfg.train, port_cfg.ssd)(tstate, {k: torch.from_numpy(v)
                                                                          for k, v in batch.items()})
    assert set(metrics) == set(ref_metrics) == {"loss", "class", "local"}
    for k, v in ref_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, err_msg=k)
    assert set(mu) == set(tstate.optimizer.m) and not any(name.startswith("backbone.") for name in mu)
    for name, m in tstate.optimizer.m.items():
        norm = mu[name].norm().item()
        if norm == 0:
            assert not m.any(), name
            continue
        tol = 1e-2 if name.startswith(("extra", "conf_head5")) else 1e-4
        assert (m - mu[name]).norm().item() <= tol * norm, name
    ours = flax_variables_from_state_dict(torch_model)
    for path, a, b in zip(jax.tree_util.tree_flatten_with_path(ref_vars["batch_stats"])[0],
                          jax.tree.leaves(ours["batch_stats"]), jax.tree.leaves(ref_vars["batch_stats"])):
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), jax.tree_util.keystr(path[0])
    assert np.array_equal(ours["params"]["backbone"]["conv3"]["kernel"],
                          variables["params"]["backbone"]["conv3"]["kernel"])
    assert not np.array_equal(ours["params"]["conf_head0"]["kernel"], variables["params"]["conf_head0"]["kernel"])


def _map_batch(rng, b=4, n=120, t=10):
    """Random SSD-like outputs (``pred_class`` logits over 81 channels,
    ``pred_boxes`` cxcyhw) and xyxy targets: each image holds 1-t boxes of
    2-4 classes out of 80 (so it lacks most), a third of the predictions
    jitter a target box and favour its class, the rest are clutter."""
    xy = rng.uniform(0.0, 0.6, (b, t, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.05, 0.4, (b, t, 2))], -1).astype(np.float32)
    valid = np.arange(t)[None, :] < rng.integers(1, t + 1, (b, 1))
    labels = np.stack([rng.choice(rng.choice(NUM_CLS, rng.integers(2, 5), replace=False), t) for _ in range(b)])
    logits = rng.normal(size=(b, n, NUM_CLS + 1)).astype(np.float32)
    cxcyhw = np.concatenate([rng.uniform(0.1, 0.9, (b, n, 2)), rng.uniform(0.05, 0.4, (b, n, 2))], -1)
    for i in range(b):
        for j in range(n // 3):
            k = j % int(valid[i].sum())
            x0, y0, x1, y1 = boxes[i, k] + rng.normal(scale=0.02, size=4)
            cxcyhw[i, j] = [(x0 + x1) / 2, (y0 + y1) / 2, y1 - y0, x1 - x0]
            logits[i, j, labels[i, k]] += rng.uniform(1.0, 4.0)
    outputs = {"pred_class": logits, "pred_boxes": np.clip(cxcyhw, 0.01, 1.0).astype(np.float32)}
    return outputs, {"boxes": boxes, "labels": labels.astype(np.int32), "valid": valid}


def test_map_80_classes_matches_jax():
    """``MeanAveragePrecision(num_cls=80)`` (the SSD driver's and
    evaluator's metric) against JAX's vmapped ``_update_one_class``: two
    updates, then compute."""
    rng = np.random.default_rng(11)
    ours, ref = MeanAveragePrecision(num_cls=NUM_CLS), JaxMap(num_cls=NUM_CLS)
    s_ours, s_ref = ours.init_state(), ref.init_state()
    present = set()
    for _ in range(2):
        outputs, targets = _map_batch(rng)
        present |= set(targets["labels"][targets["valid"]].tolist())
        s_ours = ours.update(s_ours, {k: torch.from_numpy(v) for k, v in outputs.items()},
                             {k: torch.from_numpy(v) for k, v in targets.items()})
        s_ref = ref.update(s_ref, {k: jnp.asarray(v) for k, v in outputs.items()},
                           {k: jnp.asarray(v) for k, v in targets.items()})
    assert 8 <= len(present) < NUM_CLS  # classes with no ground truth remain
    for key in ("tp", "fp", "num_gts"):
        np.testing.assert_array_equal(np.asarray(s_ours[key]), np.asarray(s_ref[key]), err_msg=key)
    got, want = ours.compute(s_ours), ref.compute(s_ref)
    assert want > 0 and abs(got - want) <= 1e-6, (got, want)


def test_evaluate_ssd_matches_jax(tree, model, monkeypatch):
    """``infer.evaluate --model ssd`` (the port's ``main``) against JAX's
    ``evaluate_ssd`` on the tree's val split, on the same weights."""
    root, _ = tree
    _, variables = model
    torch_model = _port_model(variables)
    monkeypatch.setattr(evaluate, "restore_for_inference", lambda d, name: torch_model.state_dict())
    monkeypatch.setattr(jax_evaluate, "restore_for_inference", lambda d, name: variables)
    port_cfg, jax_cfg = _configs(root)
    port_valid = _make_loaders(port_cfg, CANVAS, "ssd")[1]
    monkeypatch.setattr(jax_driver, "_make_loaders", lambda config, canvas, kind, mesh=None: (None, port_valid))
    argv = ["--dataset", "coco", "--data_root", str(root), *FLAGS]
    ours = evaluate.main(argv + ["--model", "ssd", "--device", "cpu", "--resume_from", "w"])
    ref = jax_evaluate.evaluate_ssd(dataclasses.replace(jax_cfg), "w")
    assert ours["n_images"] == ref["n_images"] == 4 and ours["n_gt"] == ref["n_gt"] > 0
    assert ref["map"] > 0 and abs(ours["map"] - ref["map"]) <= 1e-6, (ours["map"], ref["map"])
    for key in ("val_loss", "gt_localized_frac", "mean_best_iou_per_gt"):
        assert abs(ours[key] - ref[key]) <= 1e-4 * max(abs(ref[key]), 1e-3), (key, ours[key], ref[key])


def test_cli_80_classes_matches_jax_service(model, tmp_path):
    """``infer.cli --model ssd --num_cls 80`` on 3 COCO-layout JPEGs of three
    aspects in one invocation against JAX's stretching ``DetectionService``."""
    from PIL import Image

    jax_model, variables = model
    save_variables_npz(variables, str(tmp_path / "ssd.npz"))
    chip_smoke.write_coco_tree(str(tmp_path / "coco"), 5, n_train=0, n_valid=3, sizes=chip_smoke.COCO_SIZES[:3])
    files = [str(tmp_path / "coco" / "val2017" / f"{i + 1:012d}.jpg") for i in range(3)]
    records = cli.main(["--model", "ssd", "--device", "cpu", "--checkpoint_dir", str(tmp_path), "--weights",
                        "ssd.npz", "--num_cls", str(NUM_CLS), "--score_thresh", str(SCORE_THRESH),
                        "--images", *files, "--output", str(tmp_path / "d.json")])
    service = JaxService("ssd", jax_model, variables, SIZE, SCORE_THRESH, anchors=jax_flat_anchors(jax_model.config),
                         letterbox=False)
    aspects = set()
    for rec, f in zip(records, files):
        decoded = np.asarray(Image.open(f).convert("RGB"))
        aspects.add(round(decoded.shape[1] / decoded.shape[0], 3))
        ref = service.predict_image(_resize_canvas(decoded, SIZE))
        assert 0 < len(rec["boxes"]) == len(ref["boxes"])
        assert sorted(rec["labels"]) == sorted(ref["labels"]) and all(0 <= c < NUM_CLS for c in rec["labels"])
        ref_rows = np.concatenate([np.asarray(ref["boxes"]), np.asarray(ref["scores"])[:, None]], 1)
        for box, score, label in zip(rec["boxes"], rec["scores"], rec["labels"]):
            close = np.abs(ref_rows - np.asarray(box + [score])).max(1) <= 1e-5
            assert (close & (np.asarray(ref["labels"]) == label)).sum() == 1, (f, box, score, label)
    assert len(aspects) == 3

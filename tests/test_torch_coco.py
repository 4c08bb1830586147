"""BASELINE.json's config 2 on the CPU at a tiny size: DESTR over COCO's 80
classes (``--num_cls 81``, the background channel last) on a COCO-layout
tree, the port against the JAX package.

The tree is ``chip_smoke.write_coco_tree``'s, as phase 20 writes it on the
card, at COCO's aspects cut to the canvas (105 px) on the long side, so
that the letterbox pastes them unresized: COCO's 80 category
ids with their 10 gaps, 1-20 boxes an image over all 80 classes, crowd and
zero-width annotations that the readers skip. One tiny DESTR (hidden 32, 2
+ 2 blocks, top_k 4, 81 class channels) with random flax variables
(``test_torch_modules._random_variables``) is shared by the model cases, at
100 px, where the stride-32 grid is 4 x 4 and a 4:3 image's letterboxed
content is not square on it. Tolerances, and why:

- readers: items, boxes, labels and raw bytes equal; loaders' first batches,
  letterboxed and stretched: images, boxes, labels, valid and content
  extents equal (the JAX package resizes with cv2 or its native pool, the
  port with PyTorch's bilinear, which tests/test_torch_driver_loaders.py
  holds within a grey level; here the letterbox pastes the images unresized
  and the stretch leaves them at the canvas's long side);
- one train step at 81 classes (float32, dropout 0, the fused matcher's path
  on both sides through ``OBJDET_FORCE_PALLAS_MATCHER=1``) on a batch of the
  tree: losses 1e-4 relative, Adam's first moment, parameters and BatchNorm
  statistics as tests/test_torch_train_step.py holds its first step;
- kernel #9's plain version at C = 81 against ``hungarian_match_pallas`` in
  interpret mode: rows equal;
- ``infer.evaluate`` against JAX's ``evaluate_destr`` on the same weights
  (each package's checkpoint reader stubbed to hand over those weights):
  map and coco_map within 1e-6 (float32 scores that differ by about 1e-6
  can reorder only near-equal detections), the continuous diagnostics
  within 1e-4 relative;
- ``infer.cli --num_cls 81`` on 3 JPEGs of three aspects whose long side is
  the model's 100 px (so that neither package resizes them) against JAX's
  ``DetectionService``: labels equal, boxes and scores within 1e-5 (float32
  through the same model; the outputs differ by about 1e-6).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from object_detection_destr_tpu.config import DestrConfig as JaxDestrConfig  # noqa: E402
from object_detection_destr_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from object_detection_destr_tpu.data import datasets as jax_ds  # noqa: E402
from object_detection_destr_tpu.infer import evaluate as jax_evaluate  # noqa: E402
from object_detection_destr_tpu.infer.server import DetectionService as JaxService  # noqa: E402
from object_detection_destr_tpu.models.destr.model import build_destr as jax_build_destr  # noqa: E402
from object_detection_destr_tpu.ops.pallas.auction import hungarian_match_pallas  # noqa: E402
from object_detection_destr_tpu.train import arg_parser as jax_args  # noqa: E402
from object_detection_destr_tpu.train.driver import _make_loaders as jax_make_loaders  # noqa: E402
from object_detection_destr_tpu.train.optim import build_optimizer  # noqa: E402
from object_detection_destr_tpu.train.state import TrainState as JaxTrainState  # noqa: E402
from object_detection_destr_tpu.train.state import _lr_specs as jax_lr_specs  # noqa: E402
from object_detection_destr_tpu.train.steps import make_destr_train_step as jax_make_step  # noqa: E402
from object_detection_destr_tpu_torch.config import DestrConfig, TrainConfig  # noqa: E402
from object_detection_destr_tpu_torch.data import datasets as ds  # noqa: E402
from object_detection_destr_tpu_torch.data.transforms import destr_eval_transform  # noqa: E402
from object_detection_destr_tpu_torch.infer import cli, evaluate  # noqa: E402
from object_detection_destr_tpu_torch.models.convert import (  # noqa: E402
    flax_variables_from_state_dict,
    load_flax_variables,
    save_variables_npz,
    state_dict_from_flax,
)
from object_detection_destr_tpu_torch.models.destr.model import build_destr  # noqa: E402
from object_detection_destr_tpu_torch.ops.cuda.auction import hungarian_match_fused_reference  # noqa: E402
from object_detection_destr_tpu_torch.train import arg_parser as port_args  # noqa: E402
from object_detection_destr_tpu_torch.train.driver import _make_loaders  # noqa: E402
from object_detection_destr_tpu_torch.train.state import create_destr_state  # noqa: E402
from object_detection_destr_tpu_torch.train.steps import make_destr_train_step  # noqa: E402

from test_torch_modules import _random_variables  # noqa: E402
from test_torch_train_step import _mu_tree  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401

NUM_CLS = 81
SIZE = 100  # C5 4 x 4 (100 -> 50 -> 25 -> 13 -> 7 -> 4)
CANVAS = int(SIZE * 672 / 640)  # 105, the trainer's canvas
T = 8  # target columns a train-step problem keeps (the mini-detector's problems have 16 rows)
TINY = dict(hidden_dim=32, num_heads=4, ffn_dim=64, num_encoder_blocks=2, num_decoder_blocks=2, top_k=4,
            dropout=0.0)
TRAIN = dict(lr=1e-4, lr_backbone=1e-5, batch_size=2, set_cost_class=1.0, set_cost_bbox=2.5,
             set_cost_ciou=1.0, class_norm="boxes", grad_clip_norm=0.1, skip_nonfinite_updates=100,
             lr_warmup_steps=3)
# COCO's aspects with the canvas's long side: the letterbox pastes them unresized, so both packages' loaders
# hand their models the same pixels
SIZES = [(h * CANVAS // max(h, w), w * CANVAS // max(h, w)) for h, w in chip_smoke.COCO_SIZES]
FLAGS = ["--num_cls", str(NUM_CLS), "--image_size", str(SIZE), "--hidden_dim", "32", "--num_heads", "4",
         "--ffn_dim", "64", "--num_encoder_blocks", "2", "--num_decoder_blocks", "2", "--top_k", "4"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    written = chip_smoke.write_coco_tree(str(root), 3, n_train=10, n_valid=4, sizes=SIZES)
    return root, written


@pytest.fixture(scope="module")
def model():
    """The JAX model at 81 classes and its random variables."""
    jax_model = jax_build_destr(JaxDestrConfig(**TINY, num_cls=NUM_CLS, use_flash_attention=True))
    variables = _random_variables(jax_model, np.random.default_rng(0), jnp.zeros((1, SIZE, SIZE, 3)))
    return jax_model, variables


def _configs(root, extra=()):
    """Both trainers' configs from config 2's flags at the tiny size."""
    argv = ["--dataset", "coco", "--data_root", str(root), "--batch_size", "2", "--seed", "4", *FLAGS, *extra]
    return [m.config_from_args(m.get_parser("destr").parse_args(argv), "destr") for m in (port_args, jax_args)]


def test_tree_and_readers_match_jax(tree):
    """The readers on the written tree: COCO's 80 ids in id order (with the
    gaps), the classes of each split distinct up to 80, crowd and zero-width
    annotations skipped; items and raw bytes equal to the JAX reader's."""
    root, written = tree
    assert len(chip_smoke.COCO_CATEGORY_IDS) == 80 and chip_smoke.COCO_CATEGORY_IDS[-1] == 90
    for split in ("train2017", "val2017"):
        ours, ref = ds.CocoDetection(str(root), split), jax_ds.CocoDetection(str(root), split)
        assert ours.num_classes == ref.num_classes == NUM_CLS - 1
        assert ours.cat_to_idx == ref.cat_to_idx and ours.cat_to_idx[90] == 79 and 12 not in ours.cat_to_idx
        assert len(ours) == len(ref) == written[split][0]
        labels = []
        for i in range(len(ref)):
            for a, b in zip(ours[i], ref[i]):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(ours.raw_item(i), ref.raw_item(i)):
                assert a == b if isinstance(b, bytes) else np.array_equal(a, b)
            assert ours[i][0].shape[:2] == SIZES[i % len(SIZES)]
            labels += ours[i][2].tolist()
        # the classes run through a permutation of the 80 in turn
        assert len(labels) == written[split][1] and len(set(labels)) == min(len(labels), NUM_CLS - 1)
    assert written["train2017"][1] >= NUM_CLS - 1  # so the train split holds every class


@pytest.mark.parametrize("letterbox", [True, False], ids=["letterbox", "stretch"])
def test_loaders_match_jax(tree, letterbox):
    """Both drivers' loaders on the tree at config 2's canvas rule (105 for
    100 px): the first train and valid batches."""
    root, _ = tree
    extra = ["--letterbox"] if letterbox else ["--no-letterbox_eval"]
    ours, ref = (make(cfg, CANVAS, "destr") for make, cfg in zip((_make_loaders, jax_make_loaders),
                                                                  _configs(root, extra)))
    for split, a, b in zip(("train", "valid"), ours, ref):
        assert len(a) == len(b) and a.letterbox == b.letterbox == letterbox, split
        mine, theirs = next(iter(a)), next(iter(b))
        assert sorted(mine) == sorted(theirs), split
        for key in ("boxes", "labels", "valid", "content_hw"):
            if key in theirs:
                np.testing.assert_array_equal(mine[key], theirs[key], err_msg=f"{split} {key}")
        if letterbox:  # a 4:3 image's content is not square on the canvas
            assert (mine["content_hw"][:, 0] != mine["content_hw"][:, 1]).all()
        np.testing.assert_array_equal(mine["images"], theirs["images"], err_msg=split)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_train_step_81_classes_matches_jax(tree, model, monkeypatch_module):
    """One train step of each package at 81 classes on a batch of the tree
    (its eval transform's deterministic crop, the first T target columns)."""
    monkeypatch_module.setenv("OBJDET_FORCE_PALLAS_MATCHER", "1")
    root, _ = tree
    jax_model, variables = model
    raw = next(iter(_make_loaders(_configs(root)[0], CANVAS, "destr")[0]))
    prep = destr_eval_transform(*(torch.from_numpy(raw[k]) for k in ("images", "boxes", "labels", "valid")),
                                resize_to=CANVAS, out_size=SIZE)
    batch = {k: v.numpy() for k, v in prep.items()}
    batch.update({k: np.ascontiguousarray(batch[k][:, :T]) for k in ("boxes", "labels", "valid")})
    assert batch["valid"].sum() >= 4 and len(np.unique(batch["labels"][batch["valid"]])) >= 3

    jcfg = JaxTrainConfig(**TRAIN)
    lr, lr_bb = jax_lr_specs(jcfg, 10)
    params = jax.tree.map(jnp.asarray, variables["params"])
    tx = build_optimizer(params, lr=lr, lr_backbone=lr_bb, grad_clip=jcfg.grad_clip_norm,
                         skip_nonfinite=jcfg.skip_nonfinite_updates)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                          opt_state=tx.init(params), rng=jax.random.key(0))
    state, ref_metrics = jax_make_step(jax_model, tx, jcfg)(state, {k: jnp.asarray(v) for k, v in batch.items()})
    ref_vars = jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    mu = state_dict_from_flax({"params": _mu_tree(state.opt_state)})

    torch_model = load_flax_variables(build_destr(DestrConfig(**TINY, num_cls=NUM_CLS), "cpu"), variables)
    tstate = create_destr_state(torch_model, TrainConfig(**TRAIN), steps_per_epoch=10)
    metrics = make_destr_train_step(TrainConfig(**TRAIN))(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert torch_model.cls_embed.weight.shape[0] == NUM_CLS
    for k, v in ref_metrics.items():
        assert abs(float(metrics[k]) - float(v)) <= 1e-4 * max(abs(float(v)), 1e-3), (k, float(metrics[k]), v)
    floor = 1e-4 * max(t.abs().max().item() for t in mu.values())
    for name, m in tstate.optimizer.m.items():
        scale = max(mu[name].abs().max().item(), floor)
        tol = 1e-1 if name.startswith("backbone.") else 5e-3
        assert (m - mu[name]).abs().max().item() <= tol * scale, name
    ours = flax_variables_from_state_dict(torch_model)
    for a, b in zip(jax.tree.leaves(ours["params"]), jax.tree.leaves(ref_vars["params"])):
        assert np.abs(a - b).max() <= 2 * TRAIN["lr"] + 1e-6
    for a, b in zip(jax.tree.leaves(ours["batch_stats"]), jax.tree.leaves(ref_vars["batch_stats"])):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_matcher_81_classes_matches_pallas(seed):
    """#9's plain version at C = 81 against the Pallas kernel in interpret
    mode, stacked as a step stacks them (the model's top-k rows padded to
    the tokens): 1-20 valid targets a problem, labels over all 80 classes,
    random labels on the invalid columns."""
    rng = np.random.default_rng(seed)
    b, n, t = 4, 48, 20
    logits = (rng.normal(size=(b, n, NUM_CLS)) * 2).astype(np.float32)
    pb = np.stack([rng.uniform(0.2, 0.8, (b, n)), rng.uniform(0.2, 0.8, (b, n)), rng.uniform(0.05, 0.4, (b, n)),
                   rng.uniform(0.05, 0.4, (b, n))], -1).astype(np.float32)
    xy = rng.uniform(0, 0.7, (b, t, 2))
    tb = np.concatenate([xy, xy + rng.uniform(0.02, 0.3, (b, t, 2))], -1).astype(np.float32)
    valid = np.arange(t)[None, :] < rng.integers(1, t + 1, (b, 1))
    labels = rng.integers(0, NUM_CLS - 1, (b, t)).astype(np.int32)
    labels[valid] = np.arange(valid.sum()) * 7 % (NUM_CLS - 1)
    row_valid = np.ones((b, n), bool)
    row_valid[: b // 2, 30:] = False
    args = (logits, pb, tb, labels, valid)
    ref = np.asarray(hungarian_match_pallas(*map(jnp.asarray, args), row_valid=jnp.asarray(row_valid)))
    ours, rounds = hungarian_match_fused_reference(*map(torch.from_numpy, args), row_valid=torch.from_numpy(row_valid))
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert (rounds > 0).all() and len(np.unique(labels[valid])) >= 30


def test_evaluate_matches_jax(tree, model, monkeypatch):
    """``infer.evaluate`` (the port's ``main``) against JAX's
    ``evaluate_destr`` on the tree's val split, letterboxed, on the same
    weights, in float32 (the trainers' default bfloat16 rounds at other
    places in flax and under torch.autocast)."""
    root, _ = tree
    jax_model, variables = model
    torch_model = load_flax_variables(build_destr(DestrConfig(**TINY, num_cls=NUM_CLS), "cpu"), variables)
    monkeypatch.setattr(evaluate, "restore_for_inference", lambda d, name: torch_model.state_dict())
    monkeypatch.setattr(jax_evaluate, "restore_for_inference", lambda d, name: variables)
    argv = ["--dataset", "coco", "--data_root", str(root), "--batch_size", "2", "--seed", "4",
            "--compute_dtype", "float32", *FLAGS]
    ours = evaluate.main(argv + ["--device", "cpu", "--resume_from", "w"])
    jax_config = jax_args.config_from_args(jax_args.get_parser("destr").parse_args(argv), "destr")
    jax_config = dataclasses.replace(jax_config, destr=dataclasses.replace(jax_config.destr, use_flash_attention=True))
    ref = jax_evaluate.evaluate_destr(jax_config, "w")
    assert ours["n_images"] == ref["n_images"] == 4 and ours["n_gt"] == ref["n_gt"] > 0
    for key in ("map", "coco_map"):
        assert abs(ours[key] - ref[key]) <= 1e-6, (key, ours[key], ref[key])
    for key in ("gt_localized_frac", "mean_best_iou_per_gt", "mean_top_pred_iou", "mean_image_max_score",
                "max_score"):
        assert abs(ours[key] - ref[key]) <= 1e-4 * max(abs(ref[key]), 1e-3), (key, ours[key], ref[key])


def test_cli_81_classes_matches_jax_service(model, tmp_path):
    """``infer.cli --num_cls 81`` on 3 COCO-layout JPEGs (three aspects) in
    one invocation against JAX's letterboxed ``DetectionService``."""
    from PIL import Image

    jax_model, variables = model
    save_variables_npz(variables, str(tmp_path / "destr.npz"))
    # COCO-layout JPEGs whose long side is the model's 100 px: the letterbox pastes them unresized on both sides
    sizes = [(h * SIZE // max(h, w), w * SIZE // max(h, w)) for h, w in chip_smoke.COCO_SIZES[:3]]
    chip_smoke.write_coco_tree(str(tmp_path / "coco"), 5, n_train=0, n_valid=3, sizes=sizes)
    files = [str(tmp_path / "coco" / "val2017" / f"{i + 1:012d}.jpg") for i in range(3)]
    records = cli.main(["--device", "cpu", "--checkpoint_dir", str(tmp_path), "--weights", "destr.npz",
                        "--score_thresh", "0.0", *FLAGS, "--images", *files, "--output", str(tmp_path / "d.json")])
    service = JaxService("destr", jax_model, variables, SIZE, 0.0, letterbox=True)
    for rec, f in zip(records, files):
        ref = service.predict_image(np.asarray(Image.open(f).convert("RGB")))
        assert len(rec["labels"]) == TINY["top_k"] and rec["labels"] == list(ref["labels"])
        assert all(0 <= label < NUM_CLS - 1 for label in rec["labels"])
        np.testing.assert_allclose(rec["scores"], ref["scores"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(rec["boxes"], ref["boxes"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("change", [None, "order", "token"])
def test_cli_against_service_check(model, monkeypatch, change):
    """chip_smoke's hold of the CLI's batched detections to the service's
    image by image, on the CPU at 100 px: equal choices pass on the
    detections; a B=1 forward whose top-k order is permuted passes as the
    same choices (a tie between two partners' IoUs may still pick another
    pair: margin 0, replayed); one whose last top-k token is replaced by
    the next one is a flip at its score margin, held through the replay of
    the batch's choices, and refused above the near-tie bound."""
    from object_detection_destr_tpu_torch.infer.cli import predict_arrays
    from object_detection_destr_tpu_torch.infer.server import DetectionService
    from object_detection_destr_tpu_torch.models.destr import mini_detector

    _, variables = model
    torch_model = load_flax_variables(build_destr(DestrConfig(**TINY, num_cls=NUM_CLS), "cpu"), variables)
    monkeypatch.setattr(chip_smoke, "C2_IMAGE", SIZE)
    rng = np.random.default_rng(6)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in ((75, 100), (100, 75), (66, 100))]
    batch = predict_arrays(torch_model, "destr", images, SIZE, 0.0)
    records = [chip_smoke._dets_of(batch, i) for i in range(3)]
    original = mini_detector.masked_topk_with_recycle

    def changed(scores, k, valid):
        out = original(scores, k, valid)
        if scores.shape[0] == 1 and change == "order":
            out = out[:, [1, 0, *range(2, k)]]
        elif scores.shape[0] == 1 and change == "token":
            out = torch.cat([out[:, :-1], original(scores, k + 1, valid)[:, -1:]], 1)
        return out

    monkeypatch.setattr(mini_detector, "masked_topk_with_recycle", changed)
    service = DetectionService("destr", torch_model, SIZE, 0.0)
    served = [service.predict_image(image) for image in images]
    if change == "token":
        with pytest.raises(AssertionError, match="near tie|margins"):
            chip_smoke.c2_cli_against_service(torch, torch_model, images, records, served)
        monkeypatch.setattr(chip_smoke, "C2_NEAR_TIE", 1.0)
    gaps, flips = chip_smoke.c2_cli_against_service(torch, torch_model, images, records, served)
    assert gaps["cli_vs_batch"] == 0.0 and gaps["alone_vs_service"] <= 1e-6
    assert all(g <= 1e-5 for g in gaps["cli_vs_service"] + gaps["cli_vs_replayed"])
    if change is None:
        assert not flips and len(gaps["cli_vs_service"]) == 3
    elif change == "order":
        assert all(margin == 0.0 for f in flips.values() for kind, margin in f["choices"] if kind == "pairs")
        assert all(kind == "pairs" for f in flips.values() for kind, _ in f["choices"])
    else:
        assert sorted(flips) == [0, 1, 2] and all(f["choices"][0][0] == "topk" for f in flips.values())

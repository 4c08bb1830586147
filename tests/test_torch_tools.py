"""The port's counterparts of the JAX package's tools (``tools/*_torch.py``)
on the CPU, at a tiny DESTR (2+2 blocks, hidden 32, 64 px, B=2; the
ResNet-50 stays full size), against the port's own driver and the JAX
tools.

* val_noise: on a checkpoint of the port's trainer, the sweep's metric
  state is the same under two valid-loader orders and the per-image rows
  sum back to its mAP and COCO AP; on seeded outputs the rows equal the JAX
  tool's (rank rows exactly, COCO scores within 1e-6) and the bootstrap over
  them equals the JAX tool's ``_ref_ap_from_rows`` / ``_coco_ap_from_records``
  with the same ``default_rng(0)`` exactly; ``_coco_batch_records`` against
  JAX's within 1e-6.
* postmortem: a 3-step replay from the driver's ``_last`` ends with the
  parameters of the driver's own resume over the same steps, bit for bit,
  with diagnostics and without; each row's losses are the losses the driver
  logged for that step; ``update_norm`` is the norm of the parameters'
  change; a NaN batch is the first non-finite step and the replay stops
  ``--stop-after`` steps later; one step's diagnostics against the JAX
  tool's ``make_diagnostics_fn`` on the same weights and batch (float32,
  dropout 0, the fused matcher's path on both sides): losses within 1e-4
  relative.
* roofline: the FLOPs and bytes of layer1-4, reduce_dim and the
  mini-detector equal the JAX tool's ``conv_cost`` / ``bottleneck`` sums
  (the stem differs by design); each group's forward FLOPs equal those of
  the port model's own convolutions; the trace reader on a written trace.
* bench_loader on 8 JPEGs at 64 px; probe_flash refuses the CPU.
"""

import importlib.util
import json
import os
import tempfile

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from object_detection_destr_tpu.config import DestrConfig as JaxDestrConfig  # noqa: E402
from object_detection_destr_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from object_detection_destr_tpu.losses.metrics import CocoAveragePrecision as JaxCoco  # noqa: E402
from object_detection_destr_tpu.losses.metrics import MeanAveragePrecision as JaxMap  # noqa: E402
from object_detection_destr_tpu.losses.metrics import _coco_batch_records as jax_coco_records  # noqa: E402
from object_detection_destr_tpu.models.destr.model import build_destr as jax_build_destr  # noqa: E402
from object_detection_destr_tpu.train.optim import build_optimizer  # noqa: E402
from object_detection_destr_tpu.train.state import TrainState as JaxTrainState  # noqa: E402
from object_detection_destr_tpu.train.state import _lr_specs as jax_lr_specs  # noqa: E402
from object_detection_destr_tpu_torch.config import DestrConfig, TrainConfig  # noqa: E402
from object_detection_destr_tpu_torch.losses.metrics import CocoAveragePrecision, MeanAveragePrecision  # noqa: E402
from object_detection_destr_tpu_torch.losses.metrics import _coco_batch_records  # noqa: E402
from object_detection_destr_tpu_torch.models.convert import load_flax_variables  # noqa: E402
from object_detection_destr_tpu_torch.models.destr.model import build_destr  # noqa: E402
from object_detection_destr_tpu_torch.train import driver  # noqa: E402
from object_detection_destr_tpu_torch.train import train as train_cli  # noqa: E402
from object_detection_destr_tpu_torch.train.arg_parser import config_from_args, get_parser  # noqa: E402
from object_detection_destr_tpu_torch.train.checkpoint import restore_for_inference  # noqa: E402
from object_detection_destr_tpu_torch.train.state import create_destr_state  # noqa: E402
from object_detection_destr_tpu_torch.train.steps import make_destr_train_step  # noqa: E402

from test_torch_modules import _random_variables  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


val_noise = _tool("val_noise_torch")
postmortem = _tool("postmortem_divergence_torch")
roofline = _tool("roofline_conv_torch")
bench_loader = _tool("bench_loader_torch")
probe_flash = _tool("probe_flash_torch")

# no validation split while training and the backbone at lr 0 (no moments
# for it): each checkpoint about 90 MB, one kept at a time
RUN = ["--device", "cpu", "--batch_size", "2", "--image_size", "64", "--synthetic_size", "67",
       "--num_encoder_blocks", "2", "--num_decoder_blocks", "2", "--hidden_dim", "32", "--ffn_dim", "64",
       "--num_heads", "4", "--top_k", "4", "--num_train_samples", "6", "--num_valid_samples", "0",
       "--augment_factor", "1", "--log_interval", "1", "--lr", "1e-3", "--lr_backbone", "0", "--seed", "5",
       "--log_dir", ""]
STEPS = 3  # a 6-sample epoch at B=2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny model gains nothing from more, and the
    other test workers keep their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Recorder(driver.MetricLogger):
    """The driver's logger, keeping each step's metrics as floats."""

    steps: dict = {}

    def accumulate(self, step, metrics):
        _Recorder.steps[step] = {k: float(v) for k, v in metrics.items()}
        super().accumulate(step, metrics)


@pytest.fixture(scope="module")
def run():
    """One epoch of the port's trainer to ``pm_last`` (step 3), then the
    driver's own resume for one more epoch (steps 3-5), its per-step
    metrics recorded (its own ``res_last`` removed: the state is kept)."""
    mp = pytest.MonkeyPatch()
    with tempfile.TemporaryDirectory() as d:
        train_cli.main(RUN + ["--epochs", "1", "--checkpoint_dir", d, "--save_as", "pm"])
        mp.setattr(driver, "MetricLogger", _Recorder)
        _Recorder.steps = {}
        resumed = train_cli.main(RUN + ["--epochs", "1", "--checkpoint_dir", d, "--save_as", "res", "--resume",
                                        "--resume_from", "pm_last"])
        mp.undo()
        os.remove(os.path.join(d, "res_last"))
        yield {"dir": d, "resumed": resumed["state"], "logged": dict(_Recorder.steps)}


def _replay(run, steps, diagnose=True, stop_after=8):
    config = config_from_args(get_parser("destr").parse_args(RUN + ["--checkpoint_dir", run["dir"],
                                                                    "--resume_from", "pm_last"]), "destr")
    return postmortem.replay(config, "cpu", os.path.join(run["dir"], f"pm_{steps}_{diagnose}.jsonl"), steps,
                             stop_after, diagnose)


@pytest.fixture(scope="module")
def replays(run):
    return {diagnose: _replay(run, STEPS, diagnose) for diagnose in (True, False)}


# ---------------------------------------------------------------- val_noise


def test_val_noise_on_a_port_checkpoint(run, capsys):
    out = val_noise.main(RUN + ["--num_valid_samples", "4", "--checkpoint_dir", run["dir"], "--resume_from",
                                "pm_last", "--orders", "2", "--bootstrap", "20"])
    assert out["order_invariant"] and out["per_image_rows_reproduce_sweep"]
    assert out["n_images"] == 4 and out["orders_tested"] == 2 and out["device"] == "cpu"
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out


def _detections(seed, b=6, n=12, t=5, num_cls=1):
    """Seeded outputs with boxes near the targets, so that hits occur."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.1, 0.5, (b, t, 2))
    wh = rng.uniform(0.1, 0.4, (b, t, 2))
    gt = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = rng.uniform(size=(b, t)) < 0.7
    valid[0] = False  # an image without ground truth
    src = rng.integers(0, t, (b, n))
    centre = np.take_along_axis((gt[..., :2] + gt[..., 2:]) / 2, src[..., None], 1)
    size = np.take_along_axis(gt[..., 2:] - gt[..., :2], src[..., None], 1)
    boxes = np.concatenate([centre + rng.normal(0, 0.02, centre.shape), size * rng.uniform(0.8, 1.2, size.shape)],
                           -1).astype(np.float32)  # cxcyhw
    logits = rng.normal(0, 2, (b, n, num_cls + 1)).astype(np.float32)
    labels = rng.integers(0, num_cls, (b, t)).astype(np.int32)
    return {"pred_class": logits, "pred_boxes": boxes}, {"boxes": gt, "labels": labels, "valid": valid}


def _jax_rows(outputs, targets, metric, coco):
    """The JAX tool's per-image rows (val_noise.py:108-128)."""
    rows = {k: [] for k in val_noise.ROW_KEYS}
    for i in range(outputs["pred_class"].shape[0]):
        s1 = metric.update(metric.init_state(), {k: v[i:i + 1] for k, v in outputs.items()},
                           {k: v[i:i + 1] for k, v in targets.items()})
        rows["tp"].append(np.asarray(s1["tp"][0]))
        rows["fp"].append(np.asarray(s1["fp"][0]))
        rows["n_gt"].append(int(s1["num_gts"][0]))
    sc, tp, ng = jax_coco_records(outputs, targets, num_cls=coco.num_cls, max_dets=coco.max_dets,
                                  iou_thresholds=coco.IOU_THRESHOLDS)
    rows["coco_scores"].append(np.asarray(sc))
    rows["coco_tp"].append(np.asarray(tp))
    rows["coco_ngt"].append(np.asarray(ng))
    return val_noise.stacked(rows)


def test_val_noise_rows_and_bootstrap_match_jax():
    ref_tool = _tool("val_noise")
    outputs, targets = _detections(0)
    metric, coco = MeanAveragePrecision(num_cls=1, num_pred=12), CocoAveragePrecision(num_cls=1)
    rows = {k: [] for k in val_noise.ROW_KEYS}
    for lo in (0, 3):  # two batches of three images
        val_noise.image_rows(rows, metric, coco, {k: torch.from_numpy(v[lo:lo + 3]) for k, v in outputs.items()},
                             {k: torch.from_numpy(v[lo:lo + 3]) for k, v in targets.items()})
    ours = val_noise.stacked(rows)
    jmetric, jcoco = JaxMap(num_cls=1, num_pred=12), JaxCoco(num_cls=1)
    ref = _jax_rows(outputs, targets, jmetric, jcoco)
    for k in ("tp", "fp", "n_gt", "coco_tp", "coco_ngt"):
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    np.testing.assert_allclose(ours["coco_scores"], ref["coco_scores"], rtol=0, atol=1e-6)
    assert ours["tp"].sum() > 0 and ours["coco_tp"].sum() > 0  # the seeded outputs hit

    # the bootstrap over one set of rows: the port's functions and the JAX tool's, the same draws
    maps, cocos = val_noise.bootstrap(ours, 50, metric, coco)
    ref_maps, ref_cocos = val_noise.bootstrap(ours, 50, jmetric, jcoco, ref_tool._ref_ap_from_rows,
                                              ref_tool._coco_ap_from_records)
    np.testing.assert_array_equal(maps, ref_maps)
    np.testing.assert_array_equal(cocos, ref_cocos)
    assert maps.std() > 0 and cocos.std() > 0
    # the rows sum back to the metrics of the whole set
    whole = metric.update(metric.init_state(), *({k: torch.from_numpy(v) for k, v in d.items()}
                                                 for d in (outputs, targets)))
    assert val_noise.ref_ap_from_rows(ours["tp"], ours["fp"], ours["n_gt"], metric) == metric.compute(whole)


@pytest.mark.parametrize("max_dets,num_cls", [(8, 2), (100, 1)])
def test_coco_batch_records_match_jax(max_dets, num_cls):
    outputs, targets = _detections(1, b=4, n=20, t=6, num_cls=num_cls)
    thresholds = CocoAveragePrecision.IOU_THRESHOLDS
    ours = _coco_batch_records({k: torch.from_numpy(v) for k, v in outputs.items()},
                               {k: torch.from_numpy(v) for k, v in targets.items()},
                               num_cls=num_cls, max_dets=max_dets, iou_thresholds=thresholds)
    ref = [np.asarray(x) for x in jax_coco_records(outputs, targets, num_cls=num_cls, max_dets=max_dets,
                                                   iou_thresholds=thresholds)]
    assert [o.shape for o in ours] == [r.shape for r in ref]
    np.testing.assert_allclose(ours[0], ref[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours[1], ref[1], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ours[2], ref[2])
    assert ours[1].sum() > 0


# ---------------------------------------------------------------- postmortem


def test_replay_reproduces_the_drivers_resume(run, replays):
    ref = run["resumed"].model.state_dict()
    for diagnose, out in replays.items():
        assert [r["step"] for r in out["rows"]] == [3, 4, 5] and out["start_step"] == 3, diagnose
        assert {r["epoch"] for r in out["rows"]} == {1}
        ours = out["state"].model.state_dict()
        assert all(torch.equal(ours[k], ref[k]) for k in ref), f"diagnose={diagnose}"
        assert out["state"].step == run["resumed"].step == 6


def test_replay_rows_hold_the_steps_metrics(run, replays):
    rows = replays[True]["rows"]
    for row in rows:
        logged = run["logged"][row["step"] + 1]  # the driver logs a step's metrics at the step after it
        assert (row["loss"], row["loss_model"], row["loss_det"], row["m_class"], row["m_ciou"]) == (
            logged["loss"], logged["loss_model"], logged["loss_det"], logged["loss_class"], logged["loss_ciou"])
        assert row["grad_finite"] == row["applied"] == row["update_finite"] == row["params_finite"] == 1.0
        modules = [k[2:] for k in row if k.startswith("u_")]
        assert modules == ["backbone", "bbox_embed", "cls_embed", "decoder", "encoder", "mini_detector",
                           "pos_head", "reduce_dim"]
        assert np.isclose(sum(row[f"u_{m}"] ** 2 for m in modules), row["update_norm"] ** 2, rtol=1e-5)
        assert np.isclose(sum(row[f"g_{m}"] ** 2 for m in modules), row["grad_norm"] ** 2, rtol=1e-5)
    # the batch's dataset items: the loader's order of epoch 1
    loader = driver._make_loaders(config_from_args(get_parser("destr").parse_args(RUN), "destr"), 67)[0]
    loader.epoch = 1
    order = loader._epoch_order()
    assert [r["batch_indices"] for r in rows] == [order[i:i + 2].tolist() for i in (0, 2, 4)]
    # the update that landed: the norm of the parameters' change over the first step
    one = _replay(run, 1)
    before = restore_for_inference(run["dir"], "pm_last")
    after = one["state"].model.state_dict()
    names = [n for n, _ in one["state"].model.named_parameters()]
    delta = np.sqrt(sum(((after[n].double() - before[n].double()) ** 2).sum().item() for n in names))
    assert one["rows"][0]["update_norm"] == pytest.approx(delta, rel=1e-5)
    assert one["rows"][0]["loss"] == rows[0]["loss"]


def test_replay_stops_after_a_nan_batch(run, monkeypatch):
    to_device = driver._to_device
    seen = []

    def poisoned(raw, device):
        batch = to_device(raw, device)
        seen.append(1)
        if len(seen) == 2:  # the second replayed step, step 4
            batch["images"] = batch["images"].float().clone()
            batch["images"][0, 0, 0, 0] = float("nan")
        return batch

    monkeypatch.setattr(driver, "_to_device", poisoned)
    out = _replay(run, 10, stop_after=1)
    assert out["first_nonfinite"] == 4
    assert [r["step"] for r in out["rows"]] == [3, 4, 5]
    assert [r["grad_finite"] for r in out["rows"]] == [1.0, 0.0, 0.0]
    assert out["rows"][0]["params_finite"] == 1.0


def test_diagnostics_match_the_jax_tool(monkeypatch):
    """One float32 step at dropout 0 from the same weights and batch: the
    loss components within 1e-4 relative, the box statistics within 1e-5."""
    monkeypatch.setenv("OBJDET_FORCE_PALLAS_MATCHER", "1")
    ref_tool = _tool("postmortem_divergence")
    tiny = dict(hidden_dim=32, num_heads=4, ffn_dim=64, num_encoder_blocks=2, num_decoder_blocks=2, top_k=4,
                dropout=0.0)
    train = dict(lr=1e-4, lr_backbone=1e-5, batch_size=2, set_cost_class=1.0, set_cost_bbox=2.5,
                 set_cost_ciou=1.0, class_norm="boxes", grad_clip_norm=0.1, skip_nonfinite_updates=100)
    size, t = 64, 6
    rng = np.random.default_rng(3)
    jax_model = jax_build_destr(JaxDestrConfig(**tiny, use_flash_attention=True))
    variables = _random_variables(jax_model, rng, jnp.zeros((1, size, size, 3)))
    xy, wh = rng.uniform(0.0, 0.6, (2, t, 2)), rng.uniform(0.1, 0.4, (2, t, 2))
    valid = np.zeros((2, t), bool)
    valid[0, :3] = valid[1, :5] = True
    batch = {"images": rng.normal(size=(2, size, size, 3)).astype(np.float32),
             "boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
             "labels": np.zeros((2, t), np.int32), "valid": valid}

    jcfg = JaxTrainConfig(**train)
    lr, lr_bb = jax_lr_specs(jcfg, 10)
    params = jax.tree.map(jnp.asarray, variables["params"])
    tx = build_optimizer(params, lr=lr, lr_backbone=lr_bb, grad_clip=jcfg.grad_clip_norm,
                         skip_nonfinite=jcfg.skip_nonfinite_updates)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                          opt_state=tx.init(params), rng=jax.random.key(0))
    ref = {k: float(v) for k, v in ref_tool.make_diagnostics_fn(jax_model, tx, jcfg)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}).items()}

    model = load_flax_variables(build_destr(DestrConfig(**tiny), "cpu"), variables)
    tstate = create_destr_state(model, TrainConfig(**train), steps_per_epoch=10)
    diag = postmortem.Diagnostics()
    step = make_destr_train_step(TrainConfig(**train), observer=diag.observe)
    diag.begin(model)
    step(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    ours = diag.record(model)

    for k in ("m_class", "m_bbox", "m_ciou", "d_class", "d_bbox", "d_ciou", "loss", "loss_model", "loss_det"):
        assert ours[k] == pytest.approx(ref[k], rel=1e-4), k
    for k in ("min_gt_area", "mean_gt_area", "n_gt", "max_abs_logit", "min_pred_area", "max_pred_hw",
              "min_pred_hw"):
        assert ours[k] == pytest.approx(ref[k], rel=1e-5, abs=1e-6), k
    assert ours["grad_finite"] == float(ref["grad_finite"]) == 1.0


# ---------------------------------------------------------------- roofline


def test_roofline_matches_the_jax_model():
    ref_tool = _tool("roofline_conv")
    b, s = 16, 640
    groups = roofline.conv_groups(b, s)
    totals = lambda entries: (sum(e[1] for e in entries), sum(e[2] for e in entries))
    l1 = ref_tool.bottleneck(b, s // 4, 64, 64, 1, True, True)
    for _ in range(2):
        l1 += ref_tool.bottleneck(b, s // 4, 64, 256, 1, True, False)
    ref = {"layer1 (frozen, dW dX)": l1}
    for i, (blocks, width, cin, hw) in enumerate([(4, 128, 256, s // 4), (6, 256, 512, s // 8),
                                                  (3, 512, 1024, s // 16)]):
        g = ref_tool.bottleneck(b, hw, width, cin, 2, True, True)
        for _ in range(blocks - 1):
            g += ref_tool.bottleneck(b, hw // 2, width, width * 4, 1, True, False)
        ref[f"layer{i + 2}"] = g
    ref["reduce_dim 1x1"] = ref_tool.conv_cost(b, s // 32, s // 32, 2048, 256, 1, 1, train=True)
    ref["mini-detector"] = [e for _ in range(12) for e in ref_tool.conv_cost(b, s // 32, s // 32, 256, 256, 3, 1)]
    for name, entries in ref.items():
        assert totals(groups[name]) == totals(entries), name
    # the stem differs by design: the port's 7x7/2 over 3 channels, its weight gradient computed
    assert [e[0] for e in groups["stem (frozen, dW)"]] == ["fwd", "dW"]
    assert groups["stem (frozen, dW)"][0][1] == 2 * b * (s // 2) ** 2 * 3 * 64 * 49


def test_roofline_convs_are_the_ports(run):
    """Each group's forward FLOPs equal those of the port model's own
    convolutions (forward hooks at B=1, 64 px, hidden 32), and the frozen
    stem and layer1 take weight gradients in a port train step."""
    model = build_destr(DestrConfig(hidden_dim=32, num_heads=4, ffn_dim=64, num_encoder_blocks=2,
                                    num_decoder_blocks=2, top_k=4), "cpu")
    flops: dict[str, int] = {}

    def group(name):
        if name == "backbone.conv1":
            return "stem (frozen, dW)"
        if name.startswith("backbone.layer"):
            n = name.split(".")[1][len("layer")]
            return "layer1 (frozen, dW dX)" if n == "1" else f"layer{n}"
        return {"reduce_dim": "reduce_dim 1x1"}.get(name, "mini-detector")

    def hook(name):
        def count(module, inputs, output):
            kh, kw = module.kernel_size
            flops[group(name)] = flops.get(group(name), 0) + 2 * output.numel() * module.in_channels * kh * kw
        return count

    for name, module in model.named_modules():
        if isinstance(module, torch.nn.Conv2d):
            module.register_forward_hook(hook(name))
    with torch.no_grad():
        model(torch.zeros(1, 64, 64, 3))
    ours = {name: sum(e[1] for e in entries if e[0] == "fwd")
            for name, entries in roofline.conv_groups(1, 64, hidden=32).items()}
    assert flops == ours
    trained = run["resumed"].model.backbone
    assert trained.conv1.weight.grad is not None and trained.layer1_0.conv1.weight.grad is not None


def test_roofline_reads_a_trace(tmp_path, capsys):
    """The convolution category's device ms a step, from a written trace of
    two steps (cuDNN-named kernels; a GEMM, which is not counted)."""
    events = []
    for i in range(2):
        t0 = 1000.0 * i
        events.append({"ph": "X", "cat": "user_annotation", "name": f"odtt_step {i}", "ts": t0, "dur": 500.0})
        for j, (name, dur) in enumerate([("sm90_xmma_fprop_implicit_gemm_bf16", 300.0), ("cudnn_wgrad", 200.0),
                                         ("nvjet_gemm", 100.0)]):
            corr = 10 * i + j
            events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t0 + 10 * j,
                           "dur": 5.0, "args": {"correlation": corr}})
            events.append({"ph": "X", "cat": "kernel", "name": name, "ts": t0 + 100 + 10 * j, "dur": dur,
                           "args": {"correlation": corr}})
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": events}))
    out = roofline.main(["--batch", "2", "--image", "64", "--profile", str(tmp_path)])
    assert out["traced_steps"] == 2 and out["measured_conv_ms"] == pytest.approx(0.5)
    assert out["share_of_bound"] == pytest.approx(out["conv_only_bound_ms"] / 0.5)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out


# ---------------------------------------------------------------- bench_loader, probe_flash


def test_bench_loader_on_a_small_corpus(tmp_path, capsys):
    bench_loader.build_synthetic_coco(str(tmp_path), 8, (48, 64))
    out = bench_loader.main(["--root", str(tmp_path), "--batch_size", "2", "--canvas", "64", "--num_workers", "2",
                             "--repeats", "1"])
    assert out["value"] > 0 and out["unit"] == "images/sec" and out["path"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out


def test_probe_flash_refuses_the_cpu():
    with pytest.raises(SystemExit) as exc:
        probe_flash.main(["--device", "cpu", "--sq", "64"])
    assert exc.value.code != 0

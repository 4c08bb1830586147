"""The port's import CLI (``models/import_weights.py``), a train run resumed
from what it writes, ``ops.multi_head_attention`` and the summary of
``tools/profile_step_torch.py``, on the CPU.

* ``get_parser()`` declares the JAX CLI's flags with its defaults, choices
  and types, and ``--device``; without it and without CUDA ``main`` raises.
* For DESTR (a torchvision-layout ResNet-50 with random weights and BN
  statistics, hidden 32, 2+2 blocks) and SSD (a VGG-16 trunk): the state
  dict written as ``.npz`` and as a torch ``.pth`` gives two checkpoints
  with equal tensors; the checkpoint's backbone equals the port's converted
  tree exactly; ``train.main`` / ``train_ssd.main`` with ``--resume
  --resume_from pretrained --device cpu`` takes one step from it (64 px for
  DESTR, 300 px for SSD) with finite losses. After it DESTR's stem, layer1
  and every FrozenBN tensor hold the imported values while layer2-4 moved
  (the JAX package's ``param_labels``), and SSD's VGG trunk, which the JAX
  package trains frozen, holds them all.
* ``multi_head_attention`` equals JAX's at a tiny size with a key mask
  (float32, 1e-6).
* ``summarize`` over a Chrome trace written here, shaped as the GPU's: the
  category table and the top kernels as worked out by hand.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from object_detection_destr_tpu.models import import_weights as jax_import_weights  # noqa: E402
from object_detection_destr_tpu.ops import multi_head_attention as jax_mha  # noqa: E402
from object_detection_destr_tpu_torch.models import convert, import_weights  # noqa: E402
from object_detection_destr_tpu_torch.ops import multi_head_attention  # noqa: E402
from object_detection_destr_tpu_torch.train import train as train_cli  # noqa: E402
from object_detection_destr_tpu_torch.train import train_ssd  # noqa: E402
from object_detection_destr_tpu_torch.train.profiler import STEP_PREFIX, parse_trace  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
from tools.profile_step_torch import summarize  # noqa: E402
from tools.ref_torch_models import TorchResNet, torch_vgg16_features  # noqa: E402

MODEL = ["--hidden_dim", "32", "--ffn_dim", "64", "--num_heads", "4", "--num_encoder_blocks", "2",
         "--num_decoder_blocks", "2", "--top_k", "4"]
TRAIN = {
    "destr": (train_cli, MODEL + ["--image_size", "64", "--synthetic_size", "67", "--batch_size", "2",
                                  "--num_train_samples", "2", "--lr_backbone", "1e-5"]),
    "ssd": (train_ssd, ["--batch_size", "1", "--num_train_samples", "1", "--synthetic_size", "96",
                        "--hard_neg_mining", "paper"]),
}
COMMON = ["--device", "cpu", "--epochs", "1", "--num_valid_samples", "0", "--augment_factor", "1",
          "--compute_dtype", "float32", "--log_interval", "1", "--lr", "1e-4", "--resume", "--resume_from",
          "pretrained"]


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type, a.required, a.nargs, a.const)
            for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax():
    ours, theirs = _actions(import_weights.get_parser()), _actions(jax_import_weights.get_parser())
    assert ours.pop("device")[:2] == (("--device",), None)
    assert ours == theirs
    if not torch.cuda.is_available():  # the GPU unless the CPU is asked for
        with pytest.raises(RuntimeError, match="CUDA"):
            import_weights.main(["--weights", "absent.npz"])


def _torch_state_dict(model_kind):
    """The torchvision layout with seeded weights (and BN statistics away from identity)."""
    torch.manual_seed(11)
    module = TorchResNet((3, 4, 6, 3)) if model_kind == "destr" else torch_vgg16_features()
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0.0, 0.2)
                m.running_mean.normal_(0.0, 0.5)
                m.running_var.uniform_(0.5, 2.0)
    return module.state_dict()


@pytest.mark.parametrize("model_kind", ["destr", "ssd"])
def test_import_then_resume(tmp_path, model_kind):
    sd = _torch_state_dict(model_kind)
    np.savez(tmp_path / "w.npz", **{k: v.numpy() for k, v in sd.items()})
    torch.save(sd, tmp_path / "w.pth")
    shape = MODEL if model_kind == "destr" else []
    paths = [import_weights.main(["--model", model_kind, "--weights", str(tmp_path / f"w.{ext}"), "--device", "cpu",
                                  "--checkpoint_dir", str(tmp_path / ext)] + shape) for ext in ("npz", "pth")]
    a, b = (torch.load(p, weights_only=True) for p in paths)
    assert a["step"] == 0 and a["loader"] == {"epoch": 0, "step": 0} and a["best_val"] == float("inf")
    assert a["model"].keys() == b["model"].keys() and all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
    for moment in ("m", "v"):
        assert all(torch.equal(a["optimizer"][moment][k], b["optimizer"][moment][k]) for k in a["optimizer"][moment])
    numpy_sd = {k: v.numpy() for k, v in sd.items()}
    tree = (convert.resnet_params_from_torch(numpy_sd) if model_kind == "destr"
            else convert.vgg16_params_from_torch(numpy_sd))
    imported = {"backbone." + k: v for k, v in convert.state_dict_from_flax({"params": tree}).items()}
    assert all(torch.equal(a["model"][k], v) for k, v in imported.items())

    module, flags = TRAIN[model_kind]
    # no log dir: no metrics file and no TensorBoard writer (whose import takes seconds)
    result = module.main(flags + COMMON + ["--checkpoint_dir", str(tmp_path / "npz"), "--log_dir", ""])
    assert result["state"].step == 1
    assert result["metrics"] and all(np.isfinite(v) for v in result["metrics"].values())
    after = result["state"].model.state_dict()
    held = {k: torch.equal(after[k], v) for k, v in imported.items()}
    if model_kind == "ssd":
        assert all(held.values())  # the trunk trains frozen
    else:
        trains = lambda k: k.split(".")[1].startswith(("layer2", "layer3", "layer4")) and "conv" in k.split(".")[2]
        assert {k for k, same in held.items() if not same} == {k for k in held if trains(k)}


def test_multi_head_attention_matches_jax():
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, s, 16)).astype(np.float32) for s in (5, 7, 7))
    valid = np.ones((2, 7), bool)
    valid[1, 4:] = False
    ref = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 4, key_valid_mask=jnp.asarray(valid))
    ours = multi_head_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 4,
                                key_valid_mask=torch.from_numpy(valid))
    assert ours.shape == (2, 5, 16)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def _x(cat, name, ts, dur, pid=1, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur, "args": args}


def test_profile_summary(tmp_path, capsys):
    """Two graph replays of the same five kernels, a copy and a memset (us):
    flash forward 30, flash backward 50, fused auction 5, a cuDNN fprop 100,
    a cuBLAS GEMM 10, an elementwise kernel 4, a memcpy 1, a memset 1 a step."""
    step = [("kernel", "void flash_fwd_tc_kernel<1, 32>(...)", 30), ("kernel", "void flash_bwd_tc_kernel<64>(...)", 50),
            ("kernel", "fused_auction_kernel", 5),
            ("kernel", "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", 100),
            ("kernel", "nvjet_hsh_128x256_64x4_1x2_h_bz_coopA_NNN", 10),
            ("kernel", "void at::native::vectorized_elementwise_kernel<4>(...)", 4),
            ("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 1), ("gpu_memset", "Memset (Device)", 1)]
    events = []
    for i, t0 in enumerate((1000.0, 2000.0)):
        events += [_x("user_annotation", f"{STEP_PREFIX}{i}", t0, 20.0),
                   _x("cuda_runtime", "cudaGraphLaunch", t0 + 5, 5.0, correlation=i + 1)]
        t = t0 + 100
        for cat, name, dur in step:
            events.append(_x(cat, name, t, dur, pid=0, tid=7, correlation=i + 1))
            t += dur
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": events}))
    parsed = parse_trace(str(tmp_path))
    assert parsed["device_time"]["fused_auction_kernel"] == {"category": "kernel", "count": 2,
                                                             "seconds": pytest.approx(10e-6)}
    assert parsed["launch_lead_s"] == pytest.approx(95e-6)  # cudaGraphLaunch at t0 + 5, its first kernel at t0 + 100
    out = summarize(parsed, steps=2, top=3)
    assert out["busy_ms_per_step"] == pytest.approx(0.201) and out["total_ms_per_step"] == pytest.approx(0.201)
    assert out["step_busy_ms"] == pytest.approx(0.201) and out["step_period_ms"] == pytest.approx((1.0 + 0.201) / 2)
    table = {r["name"]: (round(r["ms_per_step"], 6), round(r["share"], 6), r["count_per_step"])
             for r in out["categories"]}
    assert table == {"convolution": (0.1, round(100 / 201, 6), 1.0),
                     "flash_attention_bwd #2": (0.05, round(50 / 201, 6), 1.0),
                     "flash_attention_fwd #1/#5": (0.03, round(30 / 201, 6), 1.0),
                     "GEMM": (0.01, round(10 / 201, 6), 1.0),
                     "fused_auction #9": (0.005, round(5 / 201, 6), 1.0),
                     "elementwise / reduction": (0.004, round(4 / 201, 6), 1.0),
                     "copies and memsets": (0.002, round(2 / 201, 6), 2.0)}
    assert [r["name"] for r in out["categories"]][:2] == ["convolution", "flash_attention_bwd #2"]
    assert [r["name"][:20] for r in out["top"]] == ["sm90_xmma_fprop_impl", "void flash_bwd_tc_ke",
                                                    "void flash_fwd_tc_ke"]
    printed = capsys.readouterr().out
    assert "median busy 0.20 ms" in printed and "flash_attention_fwd #1/#5" in printed

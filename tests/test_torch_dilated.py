"""Parity of the port's dilated-C5 configuration (BASELINE.json's config 4:
ResNet-101 with layer4 at stride 1 and dilation 2, 1333 px) with the JAX
package on the CPU, at odd sizes where the 1/16 feature map and
``downsample_mask``'s floor rule meet rounding.

The same flax variables go into both packages: random values (weights ~
1/sqrt(fan_in), non-trivial BatchNorm statistics, as
tests/test_torch_modules.py draws them) on the flax tree of the port's
model, which the JAX module must take as it is (flax raises on a missing
leaf), carried into the port by ``load_flax_variables``; inputs come from a
numpy seed. The tree comes from the port's model rather than from JAX's
``init``, whose trace of the whole model would double each test's time. Tolerances, each relative to the reference's largest absolute value:

- backbone stages (ResNet-50 at 97 px, ResNet-101 at 65 px, dilated): 1e-5
  (float32 on both sides; only the convolutions' summation order differs);
- the whole dilated DESTR-R50 forward at 97 px with padded valid masks:
  the mini-detector's dense outputs 2e-4, the model heads' pred_class 1e-2
  and pred_boxes 2e-3, as tests/test_torch_model.py holds the stride-32
  model (the decoder's inverse_sigmoid amplifies small center
  differences); the selected top-k token indices equal.

ResNet-101 stays at stage level: its whole model through JAX takes about a
minute on the CPU. Beside them: config 4's flags through both trainers'
parsers, kernel #9's shared-memory plan at the dilated C5's 7056 tokens,
and chip_smoke.py's split of a traced step's flash time by call site.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from object_detection_destr_tpu.config import DestrConfig as JaxDestrConfig  # noqa: E402
from object_detection_destr_tpu.models import resnet as jresnet  # noqa: E402
from object_detection_destr_tpu.models.destr.model import build_destr as jax_build_destr  # noqa: E402
from object_detection_destr_tpu.ops.topk import masked_topk_with_recycle as jax_topk  # noqa: E402
from object_detection_destr_tpu.train import arg_parser as jax_args  # noqa: E402
from object_detection_destr_tpu_torch.config import DestrConfig  # noqa: E402
from object_detection_destr_tpu_torch.models import resnet as tresnet  # noqa: E402
from object_detection_destr_tpu_torch.models.convert import load_flax_variables  # noqa: E402
from object_detection_destr_tpu_torch.models.destr.model import build_destr  # noqa: E402
from object_detection_destr_tpu_torch.ops.cuda.auction import solver_smem_bytes, value_rows_in_smem  # noqa: E402
from object_detection_destr_tpu_torch.ops.topk import masked_topk_with_recycle  # noqa: E402
from object_detection_destr_tpu_torch.train import arg_parser as port_args  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

from object_detection_destr_tpu_torch.models.convert import flax_variables_from_state_dict  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401

STAGE_TOL = 1e-5
DET_TOL = 2e-4
TINY = dict(hidden_dim=32, num_heads=4, ffn_dim=64, num_encoder_blocks=2,
            num_decoder_blocks=2, top_k=4, dropout=0.0)
# BASELINE.json config 4 as the trainer's flags (the JAX package's bench.py
# runs it as BENCH_BACKBONE=resnet101 BENCH_DILATION=1 BENCH_IMAGE=1333
# BENCH_BATCH=1); 1399 = int(1333 * 672 / 640), the trainer's canvas
CONFIG_4 = ["--backbone", "resnet101", "--dilation", "--image_size", "1333", "--batch_size", "1",
            "--synthetic_size", "1399"]


def _random_variables(model, rng):
    """Random flax variables on the tree of the port's ``model``, drawn by
    tests/test_torch_modules.py's rule, loaded into ``model`` too."""
    tree = flax_variables_from_state_dict(model)

    def fill(name, shape):
        normal = rng.standard_normal(shape, dtype=np.float32)
        if name == "kernel":
            return normal / np.float32(np.sqrt(np.prod(shape[:-1])))
        if name in ("running_var", "var"):
            return rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
        if name in ("scale", "weight"):
            return 1.0 + 0.1 * normal
        if name == "embedding":
            return normal
        return 0.1 * normal  # bias, means

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else fill(k, v.shape) for k, v in node.items()}

    variables = {k: walk(v) for k, v in tree.items() if v}
    load_flax_variables(model, variables)
    return variables


def _close(ours, ref, name, tol):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
    err = np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-6)
    assert err <= tol, f"{name}: relative error {err:.2e}"


@pytest.mark.parametrize("depth,size", [(50, 97), (101, 65)], ids=["resnet50_97px", "resnet101_65px"])
def test_dilated_resnet_stages(depth, size):
    """Each stage of the dilated backbone; C5 stays at C4's 1/16 grid."""
    rng = np.random.default_rng(depth)
    x = rng.normal(size=(1, size, size, 3)).astype(np.float32)
    model = getattr(tresnet, f"resnet{depth}")(dilation=True).eval()
    variables = _random_variables(model, rng)
    ref = jax.jit(getattr(jresnet, f"resnet{depth}")(dilation=True).apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        ours = model(torch.from_numpy(x))
    assert ours["layer4"].shape[1:3] == ours["layer3"].shape[1:3]
    for stage in ("layer1", "layer2", "layer3", "layer4"):
        _close(ours[stage].numpy(), ref[stage], stage, STAGE_TOL)


def _c5_valid(valid, hw):
    """``downsample_mask``'s rule, ``src = floor(dst * H / h)``, in numpy."""
    h, w = hw
    rows = (np.arange(h) * valid.shape[1]) // h
    cols = (np.arange(w) * valid.shape[2]) // w
    return valid[:, rows][:, :, cols]


def _topk(det_output, valid, module):
    """The mini-detector's query selection recomputed from its dense output
    on the dilated C5 grid (97 px: 7 x 7 tokens)."""
    scores = 1.0 / (1.0 + np.exp(-det_output["pred_class"].astype(np.float64)))
    scores = scores.max(-1).astype(np.float32)
    flat_valid = _c5_valid(valid, (7, 7)).reshape(valid.shape[0], -1)
    assert scores.shape == flat_valid.shape
    if module == "jax":
        return np.asarray(jax_topk(jnp.asarray(scores), TINY["top_k"], jnp.asarray(flat_valid)))
    return masked_topk_with_recycle(torch.from_numpy(scores), TINY["top_k"], torch.from_numpy(flat_valid)).numpy()


def test_dilated_destr_forward():
    """The whole DESTR-R50 forward with the dilated C5 at 97 px, with padded
    pixel masks whose 1/16 samples fall on both sides of the floor rule."""
    rng = np.random.default_rng(0)
    images = rng.normal(size=(2, 97, 97, 3)).astype(np.float32)
    valid = np.ones((2, 97, 97), bool)
    valid[0, 61:, :] = False  # image 0: C5 rows 5 and 6 padded (sources 69 and 83)
    valid[1, :, 40:] = False  # image 1: C5 columns 3-6 padded (sources 41, 55, 69, 83)
    assert _c5_valid(valid, (7, 7))[0, :, 0].tolist() == [True] * 5 + [False] * 2
    model = build_destr(DestrConfig(**TINY, dilation=True), "cpu")
    variables = _random_variables(model, rng)
    jax_model = jax_build_destr(JaxDestrConfig(**TINY, dilation=True, use_flash_attention=True))
    ref = jax.jit(jax_model.apply)(variables, jnp.asarray(images), valid_mask=jnp.asarray(valid))
    ref_model, ref_det = jax.tree.map(np.asarray, ref)
    with torch.no_grad():
        out = model(torch.from_numpy(images), torch.from_numpy(valid))
    ours_model, ours_det = jax.tree.map(lambda t: t.numpy(), out, is_leaf=torch.is_tensor)
    _close(ours_det["pred_class"], ref_det["pred_class"], "det/pred_class", DET_TOL)
    _close(ours_det["pred_boxes"], ref_det["pred_boxes"], "det/pred_boxes", DET_TOL)
    _close(ours_model["pred_class"], ref_model["pred_class"], "pred_class", 1e-2)
    _close(ours_model["pred_boxes"], ref_model["pred_boxes"], "pred_boxes", 2e-3)
    np.testing.assert_array_equal(_topk(ours_det, valid, "torch"), _topk(ref_det, valid, "jax"))


def test_config_4_flags_parse_alike():
    """The two trainers' parsers turn config 4's flags into equal configs,
    field for field (``--device`` is no field of either)."""
    configs = []
    for module in (jax_args, port_args):
        args = module.get_parser("destr").parse_args(CONFIG_4)
        configs.append(dataclasses.asdict(module.config_from_args(args, "destr")))
    jax_cfg, port_cfg = configs
    assert (jax_cfg["destr"]["backbone"], jax_cfg["destr"]["dilation"]) == ("resnet101", True)
    assert (jax_cfg["train"]["image_size"], jax_cfg["train"]["batch_size"]) == (1333, 1)
    for section in jax_cfg:
        for field, value in jax_cfg[section].items():
            assert port_cfg[section][field] == value, f"{section}.{field}: port {port_cfg[section][field]!r}, " \
                                                      f"JAX {value!r}"
    assert port_cfg == jax_cfg


def test_auction_plan_at_dilated_c5():
    """Kernel #9's shared-memory plan for the mini-detector's problems at
    config 4 (N = 84 x 84 = 7056 tokens, T = 300): the solver's state and the
    value rows kept beside it fit one block on sm_90 (227 KB, less the
    static counts), where the 96 KB value budget alone asked for 3 rows and
    a launch the card refused; the 640 px plan (N = 400) is unchanged, and a
    problem whose state alone passes a block is refused before a launch."""
    limit = 227 * 1024 - 1024
    assert value_rows_in_smem(7056, 300) == 2
    assert solver_smem_bytes(7056, 300, 2) <= limit < solver_smem_bytes(7056, 300, 3)
    assert value_rows_in_smem(400, 300) == 61 and value_rows_in_smem(300, 8) == 8
    with pytest.raises(ValueError, match="shared memory"):
        value_rows_in_smem(12000, 300)


def _write_trace(path, order_1, order_2, steps=2):
    """A trace of ``steps`` DESTR steps' flash launches: #1 at the sites of
    ``order_1``, then #2 at those of ``order_2``, one grid a site."""
    grids = {"encoder_self": [111, 8, 1], "decoder_self": [5, 8, 1], "cross_cls_reg": [10, 1, 1]}
    events, ts = [], 0.0
    for _ in range(steps):
        for kernel, order, dur in (("flash_fwd_tc_kernel<1, 32>", order_1, 10.0),
                                   ("flash_bwd_tc_kernel<32, 1, 64>", order_2, 30.0)):
            for site in order:
                events.append({"ph": "X", "cat": "kernel", "name": kernel, "ts": ts, "dur": dur,
                               "args": {"grid": grids[site]}})
                ts += 2 * dur
    with open(os.path.join(path, "trace.json"), "w") as f:
        json.dump({"traceEvents": events}, f)


def test_flash_site_ms_attributes_by_order(tmp_path):
    """chip_smoke's split of a traced step's #1 / #2 time by call site (the
    trace names no shapes): a forward's order encoder x 6, then (decoder
    self, cross) x 6, and the backward's reverse give each site its own ms;
    an order that puts two grids on one site is refused."""
    forward = chip_smoke.FORWARD_SITES
    assert forward[:6] == ["encoder_self"] * 6 and len(forward) == 18
    _write_trace(tmp_path, forward, forward[::-1])
    sites = chip_smoke.flash_site_ms(str(tmp_path), 2)
    names = ("encoder_self", "decoder_self", "cross_cls_reg")
    assert sites == {"#1": {s: pytest.approx(6 * 10.0 / 1e3) for s in names},
                     "#2": {s: pytest.approx(6 * 30.0 / 1e3) for s in names}}
    _write_trace(tmp_path, forward, forward)  # #2 in the forward's order: sites mixed
    with pytest.raises(AssertionError, match="one shape a site"):
        chip_smoke.flash_site_ms(str(tmp_path), 2)

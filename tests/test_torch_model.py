"""Whole-DESTR parity of the PyTorch port with the JAX package at a tiny size
(64px, hidden 32, 4 heads, FFN 64, 2+2 blocks, top_k 4, dropout 0), with the
flash path on both sides and a non-square pixel valid-mask so the key masks
are live.

Tolerances are those of tests/test_full_model_parity.py:96-105 and for its
reason: the dense det_output path is tight (2e-4 of the largest value); the
decoder refines boxes through inverse_sigmoid(selected_centers), whose
derivative 1/(p(1-p)) amplifies small center differences, so pred_class is
held to 1e-2 and pred_boxes to 2e-3. The selected top-k indices must be equal.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from object_detection_destr_tpu.config import DestrConfig as JaxDestrConfig  # noqa: E402
from object_detection_destr_tpu.models.destr.model import build_destr as jax_build_destr  # noqa: E402
from object_detection_destr_tpu.ops.topk import masked_topk_with_recycle as jax_topk  # noqa: E402
from object_detection_destr_tpu_torch.config import DestrConfig  # noqa: E402
from object_detection_destr_tpu_torch.models.convert import (  # noqa: E402
    flax_variables_from_state_dict,
    load_flax_variables,
    load_variables_npz,
    save_variables_npz,
    state_dict_from_flax,
)
from object_detection_destr_tpu_torch.models.destr.layers import DropoutRng  # noqa: E402
from object_detection_destr_tpu_torch.models.destr.model import build_destr  # noqa: E402
from object_detection_destr_tpu_torch.ops.topk import masked_topk_with_recycle  # noqa: E402

from test_torch_modules import _random_variables  # noqa: E402

TINY = dict(hidden_dim=32, num_heads=4, ffn_dim=64, num_encoder_blocks=2,
            num_decoder_blocks=2, top_k=4, dropout=0.0)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    images = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    valid = np.ones((2, 64, 64), bool)
    valid[0, 30:, :] = False  # image 0: bottom C5 row padded (2 of 4 tokens valid)
    valid[1, :, 20:] = False  # image 1: right C5 column padded
    jax_model = jax_build_destr(JaxDestrConfig(**TINY, use_flash_attention=True))
    variables = _random_variables(jax_model, rng, jnp.zeros((1, 64, 64, 3)))
    ref = jax_model.apply(variables, jnp.asarray(images), valid_mask=jnp.asarray(valid))
    ref = jax.tree.map(np.asarray, ref)
    return images, valid, variables, ref


def _run(model, images, valid):
    with torch.no_grad():
        out = model(torch.from_numpy(images), torch.from_numpy(valid))
    return jax.tree.map(lambda t: t.numpy(), out, is_leaf=torch.is_tensor)


def _close(ours, ref, name, tol):
    scale = max(np.abs(ref).max(), 1e-6)
    err = np.abs(ours - ref).max() / scale
    assert err < tol, f"{name}: relative error {err:.2e}"


def _topk(det_output, valid, module):
    """The mini-detector's query selection recomputed from its dense output."""
    scores = 1.0 / (1.0 + np.exp(-det_output["pred_class"].astype(np.float64)))
    scores = scores.max(-1).astype(np.float32)
    flat_valid = valid[:, ::32, ::32].reshape(valid.shape[0], -1)
    if module == "jax":
        return np.asarray(jax_topk(jnp.asarray(scores), TINY["top_k"], jnp.asarray(flat_valid)))
    return masked_topk_with_recycle(
        torch.from_numpy(scores), TINY["top_k"], torch.from_numpy(flat_valid)
    ).numpy()


@pytest.mark.parametrize("weights_from", ["variables", "npz"])
def test_whole_destr_parity(setup, tmp_path, weights_from):
    images, valid, variables, (ref_model, ref_det) = setup
    if weights_from == "npz":
        path = str(tmp_path / "weights.npz")
        save_variables_npz(variables, path)
        variables = load_variables_npz(path)
    model = load_flax_variables(build_destr(DestrConfig(**TINY), "cpu"), variables)
    ours_model, ours_det = _run(model, images, valid)

    _close(ours_det["pred_class"], ref_det["pred_class"], "det/pred_class", 2e-4)
    _close(ours_det["pred_boxes"], ref_det["pred_boxes"], "det/pred_boxes", 2e-4)
    _close(ours_model["pred_class"], ref_model["pred_class"], "pred_class", 1e-2)
    _close(ours_model["pred_boxes"], ref_model["pred_boxes"], "pred_boxes", 2e-3)
    np.testing.assert_array_equal(_topk(ours_det, valid, "torch"), _topk(ref_det, valid, "jax"))


def test_flash_and_plain_paths_agree(setup):
    images, valid, variables, _ = setup
    flash = load_flax_variables(build_destr(DestrConfig(**TINY), "cpu"), variables)
    plain = load_flax_variables(
        build_destr(DestrConfig(**TINY, use_flash_attention=False), "cpu"), variables
    )
    a, b = _run(flash, images, valid), _run(plain, images, valid)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5)


def test_weight_mapping_round_trip(setup):
    _, _, variables, _ = setup
    model = load_flax_variables(build_destr(DestrConfig(**TINY), "cpu"), variables)
    # every LayerNorm keeps flax's eps, not torch's 1e-5
    norms = [m for m in model.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert norms and all(m.eps == 1e-6 for m in norms)
    back = flax_variables_from_state_dict(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(variables)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(x, y)
    # strict loading names what is missing
    partial = state_dict_from_flax(variables)
    assert "backbone.conv1.weight" in partial and partial["backbone.conv1.weight"].shape == (64, 3, 7, 7)
    del back["params"]["cls_embed"]
    with pytest.raises(KeyError, match="cls_embed"):
        load_flax_variables(build_destr(DestrConfig(**TINY), "cpu"), back)


def test_entry_point_rules():
    # no CUDA device and no explicit CPU: raise, never run on the CPU quietly
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_destr(DestrConfig(**TINY))
    # bfloat16 compute runs: float32 outputs, bfloat16 inside
    bf16 = build_destr(DestrConfig(**TINY, compute_dtype="bfloat16"), "cpu")
    with torch.no_grad():
        out, det = bf16(torch.zeros(1, 64, 64, 3))
    assert out["pred_class"].dtype == det["pred_boxes"].dtype == torch.float32
    # train mode runs: dropout from an explicit stream, BatchNorm on batch
    # statistics (the running statistics move), gradients reach the weights
    model = build_destr(DestrConfig(**dict(TINY, dropout=0.3)), "cpu")
    before = model.mini_detector.cls_conv.bn0.running_mean.clone()
    out, det = model(torch.randn(2, 64, 64, 3), train=True, rng=DropoutRng(0))
    (out["pred_class"].sum() + det["pred_boxes"].sum()).backward()
    assert not torch.equal(model.mini_detector.cls_conv.bn0.running_mean, before)
    assert model.encoder.block0.fc1.weight.grad is not None
    # remat builds, and recomputing the blocks changes no output
    torch.manual_seed(0)
    plain = build_destr(DestrConfig(**dict(TINY, dropout=0.3)), "cpu")
    remat = build_destr(DestrConfig(**dict(TINY, dropout=0.3), remat=True), "cpu")
    remat.load_state_dict(plain.state_dict())
    x = torch.randn(2, 64, 64, 3)
    out_p, _ = plain(x, train=True, rng=DropoutRng(1))
    out_r, _ = remat(x, train=True, rng=DropoutRng(1))
    assert torch.equal(out_p["pred_boxes"], out_r["pred_boxes"])

"""Module-by-module parity of the PyTorch port with the JAX package.

Each case feeds the same numpy inputs (from a seed) and the same flax
variables (random values, with non-trivial frozen and running BatchNorm
statistics) to the JAX module and to its port. Modules that hold the flash
kernel run it on both sides: the JAX side forces the Pallas kernel on in
interpret mode, the port's wrapper runs its plain version on the CPU.

Tolerance: 1e-4 of the reference's largest absolute value (float32 on both
sides; convolution and matmul summation orders differ). Index outputs
(top-k, pairs) must be equal.
"""

import math

import numpy as np
import pytest
import torch
from torch import nn as tnn

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax import linen as fnn  # noqa: E402

from object_detection_destr_tpu.geometry import boxes as jboxes  # noqa: E402
from object_detection_destr_tpu.geometry import embeddings as jemb  # noqa: E402
from object_detection_destr_tpu.models import resnet as jresnet  # noqa: E402
from object_detection_destr_tpu.models.destr import decoder as jdec  # noqa: E402
from object_detection_destr_tpu.models.destr import encoder as jenc  # noqa: E402
from object_detection_destr_tpu.models.destr import layers as jlayers  # noqa: E402
from object_detection_destr_tpu.models.destr import mini_detector as jmini  # noqa: E402
from object_detection_destr_tpu.models.destr import pair_attention as jpair  # noqa: E402
from object_detection_destr_tpu.ops.topk import masked_topk_with_recycle as j_topk  # noqa: E402
from object_detection_destr_tpu_torch.geometry import boxes as tboxes  # noqa: E402
from object_detection_destr_tpu_torch.geometry import embeddings as temb  # noqa: E402
from object_detection_destr_tpu_torch.models import resnet as tresnet  # noqa: E402
from object_detection_destr_tpu_torch.models.convert import load_flax_variables  # noqa: E402
from object_detection_destr_tpu_torch.models.destr import decoder as tdec  # noqa: E402
from object_detection_destr_tpu_torch.models.destr import encoder as tenc  # noqa: E402
from object_detection_destr_tpu_torch.models.destr import layers as tlayers  # noqa: E402
from object_detection_destr_tpu_torch.models.destr import mini_detector as tmini  # noqa: E402
from object_detection_destr_tpu_torch.models.destr import pair_attention as tpair  # noqa: E402
from object_detection_destr_tpu_torch.ops.topk import masked_topk_with_recycle as t_topk  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401

TOL = 1e-4


def _close(ours, ref, name, tol=TOL):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-6)
    err = np.abs(ours - ref).max() / scale
    assert err <= tol, f"{name}: relative error {err:.2e}"


def _random_variables(module, rng, *args, **kwargs):
    """Flax variables of ``module`` with random values: weights ~ 1/sqrt(fan_in),
    scales near 1, and BatchNorm statistics away from identity."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *args, **kwargs))

    def fill(path, sds):
        name, shape = str(path[-1].key), sds.shape
        if name == "kernel":
            return (rng.normal(size=shape) / math.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if name in ("running_var", "var"):
            return rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
        if name in ("scale", "weight"):
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        if name == "embedding":
            return rng.normal(size=shape).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)  # bias, means

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree.map(np.asarray, fnn.meta.unbox(dict(tree)))


def _to_torch(x):
    return torch.from_numpy(np.asarray(x))


def _run_pair(jmod, tmod, variables, args):
    """Apply the flax module and its port to the same inputs."""
    load_flax_variables(tmod, variables)
    tmod.eval()
    ref = jmod.apply(variables, *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        ours = tmod(*(_to_torch(a) for a in args))
    return ours, ref


def _compare_trees(ours, ref, name):
    o_leaves = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), ours, is_leaf=torch.is_tensor))
    r_leaves = jax.tree.leaves(ref)
    assert len(o_leaves) == len(r_leaves), name
    for i, (o, r) in enumerate(zip(o_leaves, r_leaves)):
        _close(o, r, f"{name}[{i}]")


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def _geometry_inputs():
    rng = np.random.default_rng(0)
    boxes = rng.uniform(0.0, 1.0, size=(2, 7, 4)).astype(np.float32)
    mask = np.ones((2, 5, 6), bool)
    mask[0, 3:] = False
    mask[1, :, 4:] = False
    probs = np.concatenate(
        [rng.uniform(0, 1, size=10), [0.0, 1e-7, 1.0, 1.0 - 1e-7, 0.5]]
    ).astype(np.float32)
    return boxes, mask, probs


GEOMETRY = {
    "cxcyhw_to_xyxy": (lambda m, b, k, p: m.cxcyhw_to_xyxy(b), "boxes"),
    "box_l1_size": (lambda m, b, k, p: m.box_l1_size(b), "boxes"),
    "sine_position_map": (lambda m, b, k, p: m.sine_position_map(k, num_pos_feats=16), "emb"),
    "sine_embed_centers": (lambda m, b, k, p: m.sine_embed_centers(b[..., :2], d_model=32), "emb"),
    "inverse_sigmoid": (lambda m, b, k, p: m.inverse_sigmoid(p), "emb"),
}


@pytest.mark.parametrize("name", sorted(GEOMETRY))
def test_geometry_parity(name):
    fn, kind = GEOMETRY[name]
    boxes, mask, probs = _geometry_inputs()
    jm, tm = (jboxes, tboxes) if kind == "boxes" else (jemb, temb)
    ref = fn(jm, jnp.asarray(boxes), jnp.asarray(mask), jnp.asarray(probs))
    ours = fn(tm, _to_torch(boxes), _to_torch(mask), _to_torch(probs))
    _close(ours.numpy(), ref, name, tol=1e-5)
    assert np.isfinite(ours.numpy()).all()


# ---------------------------------------------------------------------------
# masked top-k
# ---------------------------------------------------------------------------

TOPK = {
    # equal scores must order lowest index first, as lax.top_k does
    "ties": (np.array([[0.3, 0.7, 0.7, 0.1, 0.7, 0.3]], np.float32),
             np.ones((1, 6), bool), 5),
    # fewer valid tokens than k: indices recycle flip-tile style
    "valid_lt_k": (np.array([[0.9, 0.2, 0.8, 0.4, 0.6, 0.5],
                             [0.5, 0.5, 0.1, 0.2, 0.3, 0.9]], np.float32),
                   np.array([[1, 0, 1, 0, 0, 1], [1, 1, 1, 1, 1, 1]], bool), 5),
    # scores near 0.5 where the +1e-12 tie-break vanishes in float32, plus
    # a row with no valid token
    "near_half_and_empty": (np.array([[0.5, 0.5, 0.5, 0.25], [0.1, 0.2, 0.3, 0.4]], np.float32),
                            np.array([[1, 1, 0, 1], [0, 0, 0, 0]], bool), 4),
}


@pytest.mark.parametrize("name", sorted(TOPK))
def test_masked_topk_with_recycle(name):
    scores, valid, k = TOPK[name]
    ref = np.asarray(j_topk(jnp.asarray(scores), k, jnp.asarray(valid)))
    ours = t_topk(_to_torch(scores), k, _to_torch(valid)).numpy()
    np.testing.assert_array_equal(ours, ref)


# ---------------------------------------------------------------------------
# backbone
# ---------------------------------------------------------------------------


def test_frozen_batch_norm():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 3, 8)).astype(np.float32)
    jmod = jresnet.FrozenBatchNorm(8)
    variables = _random_variables(jmod, rng, jnp.asarray(x))
    tmod = tresnet.FrozenBatchNorm(8)
    load_flax_variables(tmod, variables)
    ref = jmod.apply(variables, jnp.asarray(x))
    ours = tmod(_to_torch(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(ours.numpy(), ref, "frozen_bn", tol=1e-6)


def test_resnet50_64px():
    """The JAX stem is the space-to-depth rewrite, the port's the plain conv:
    the same function of the same (7, 7, 3, 64) parameter."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    jmod = jresnet.resnet50()
    variables = _random_variables(jmod, rng, jnp.asarray(x))
    ours, ref = _run_pair(jmod, tresnet.resnet50(), variables, [x])
    for stage in ("layer1", "layer2", "layer3", "layer4"):
        _close(ours[stage].numpy(), ref[stage], stage)


def test_resnet101_dilated_weight_layout():
    """ResNet-101 with a dilated C5 takes the flax tree strictly, and the
    dilated stage keeps stride 1 (C5 at 1/16 of the input)."""
    rng = np.random.default_rng(6)
    x = jnp.zeros((1, 64, 64, 3))
    variables = _random_variables(jresnet.resnet101(dilation=True), rng, x)
    model = load_flax_variables(tresnet.resnet101(dilation=True), variables).eval()
    assert model.layer4_1.conv2.dilation == (2, 2) and model.layer4_0.conv2.stride == (1, 1)
    with torch.no_grad():
        assert model(torch.zeros(1, 64, 64, 3))["layer4"].shape == (1, 4, 4, 2048)


def test_learned_position_embedding():
    rng = np.random.default_rng(7)
    jmod = jlayers.LearnedPositionEmbedding(num_pos_feats=16)
    variables = _random_variables(jmod, rng, 3, 5)
    tmod = load_flax_variables(tlayers.LearnedPositionEmbedding(num_pos_feats=16), variables)
    ref = jmod.apply(variables, 3, 5)
    with torch.no_grad():
        _close(tmod(3, 5).numpy(), ref, "learned_pos", tol=0.0)


# ---------------------------------------------------------------------------
# transformer modules (flash path on both sides)
# ---------------------------------------------------------------------------

B, C, HEADS, S, L = 2, 32, 4, 6, 10


def _tokens(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _key_mask():
    mask = np.ones((B, L), bool)
    mask[0, 7:] = False
    return mask


def _mha(rng):
    args = [_tokens(rng, B, S, C), _tokens(rng, B, L, C), _tokens(rng, B, L, C), _key_mask()]
    return (jlayers.MultiHeadAttention(HEADS, use_flash=True),
            tlayers.MultiHeadAttention(C, HEADS, use_flash=True), args)


def _encoder_block(rng):
    args = [_tokens(rng, B, L, C), _tokens(rng, B, L, C), _key_mask()]
    return (jenc.EncoderBlock(C, HEADS, 64, dropout=0.0, use_flash=True),
            tenc.EncoderBlock(C, HEADS, 64, use_flash=True), args)


def _encoder(rng):
    args = [_tokens(rng, B, L, C), _tokens(rng, B, L, C), _key_mask()]
    return (jenc.Encoder(C, HEADS, 64, num_blocks=2, dropout=0.0, use_flash=True),
            tenc.Encoder(C, HEADS, 64, num_blocks=2, use_flash=True), args)


def _conv_bn_stack(rng):
    return jmini.ConvBnStack(C), tmini.ConvBnStack(C), [_tokens(rng, B, 4, 5, C)]


class _JaxMini(fnn.Module):
    top_k: int

    def setup(self):
        self.cls_embed = fnn.Dense(3)
        self.bbox_embed = jlayers.Mlp([C, 4])
        self.pos_head = jlayers.Mlp([C, C, 2])
        self.mini = jmini.MiniDetector(
            self.top_k, self.cls_embed, self.bbox_embed, self.pos_head, hidden_dim=C
        )

    def __call__(self, features, fine_pos, valid):
        return self.mini(features, fine_pos, valid)


class _TorchMini(tnn.Module):
    def __init__(self, top_k):
        super().__init__()
        self.cls_embed = tnn.Linear(C, 3)
        self.bbox_embed = tlayers.Mlp(C, [C, 4])
        self.pos_head = tlayers.Mlp(C, [C, C, 2])
        self.mini = tmini.MiniDetector(top_k, C)

    def forward(self, features, fine_pos, valid):
        return self.mini(features, fine_pos, valid, self.cls_embed, self.bbox_embed, self.pos_head)


def _mini_detector(rng):
    valid = np.ones((B, 4, 5), bool)
    valid[0, 2:] = False  # 10 valid tokens of 20 -> top_k 12 recycles
    args = [_tokens(rng, B, 4, 5, C), _tokens(rng, B, 4, 5, C), valid]
    return _JaxMini(12), _TorchMini(12), args


def _decoder_inputs(rng):
    coords = rng.uniform(0.05, 0.95, size=(B, S, 4)).astype(np.float32)
    return [_tokens(rng, B, S, 2 * C), _tokens(rng, B, L, C), _tokens(rng, B, L, C),
            _key_mask(), coords, _tokens(rng, B, S, C), _tokens(rng, B, S, C)]


def _decoder_block(rng):
    return (jdec.DecoderBlock(C, HEADS, dropout=0.0, use_flash=True),
            tdec.DecoderBlock(C, HEADS, use_flash=True), _decoder_inputs(rng))


class _JaxDecoder(fnn.Module):
    def setup(self):
        self.bbox_embed = jlayers.Mlp([C, 4])
        self.decoder = jdec.Decoder(C, HEADS, num_blocks=2, dropout=0.0, use_flash=True)

    def __call__(self, objects, enc, enc_valid, fine_pos, obj_pos, centers):
        return self.decoder(objects, enc, enc_valid, fine_pos, obj_pos, centers, self.bbox_embed)


class _TorchDecoder(tnn.Module):
    def __init__(self):
        super().__init__()
        self.bbox_embed = tlayers.Mlp(C, [C, 4])
        self.decoder = tdec.Decoder(C, HEADS, num_blocks=2, use_flash=True)

    def forward(self, objects, enc, enc_valid, fine_pos, obj_pos, centers):
        return self.decoder(objects, enc, enc_valid, fine_pos, obj_pos, centers, self.bbox_embed)


def _decoder(rng):
    centers = rng.uniform(0.05, 0.95, size=(B, S, 2)).astype(np.float32)
    args = [_tokens(rng, B, S, 2 * C), _tokens(rng, B, L, C), _key_mask(),
            _tokens(rng, B, L, C), _tokens(rng, B, S, C), centers]
    return _JaxDecoder(), _TorchDecoder(), args


MODULES = {
    "multi_head_attention": _mha,
    "encoder_block": _encoder_block,
    "encoder": _encoder,
    "conv_bn_stack": _conv_bn_stack,
    "mini_detector": _mini_detector,
    "decoder_block": _decoder_block,
    "decoder": _decoder,
}


@pytest.mark.parametrize("name", list(MODULES))
def test_module_parity(name):
    rng = np.random.default_rng(sorted(MODULES).index(name) + 10)
    jmod, tmod, args = MODULES[name](rng)
    variables = _random_variables(jmod, rng, *(jnp.asarray(a) for a in args))
    ours, ref = _run_pair(jmod, tmod, variables, args)
    _compare_trees(ours, ref, name)


# ---------------------------------------------------------------------------
# pair attention
# ---------------------------------------------------------------------------


def test_get_pairs_equal():
    rng = np.random.default_rng(3)
    boxes = rng.uniform(0.1, 0.9, size=(2, 9, 4)).astype(np.float32)
    boxes[:, 4] = boxes[:, 0]  # identical boxes: argmax takes the first maximum
    boxes[1, 6, :2] = [0.02, 0.02]  # clipped and disjoint boxes: negative "IoU"
    ref = np.asarray(jpair.get_pairs(jnp.asarray(boxes)))
    ours = tpair.get_pairs(_to_torch(boxes)).numpy()
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("pair_mode", ["reference", "paper"])
@pytest.mark.parametrize("pair_output_mode", ["reference", "paper"])
def test_pair_self_attention(pair_mode, pair_output_mode):
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(B, HEADS, S, 8)).astype(np.float32) for _ in range(3))
    centers = rng.uniform(0.1, 0.9, size=(B, S, 4)).astype(np.float32)
    kw = dict(pair_mode=pair_mode, pair_output_mode=pair_output_mode)
    ref = jpair.pair_self_attention(*(jnp.asarray(a) for a in (q, k, v, centers)), **kw)
    ours = tpair.pair_self_attention(*(_to_torch(a) for a in (q, k, v, centers)), **kw)
    _close(ours.numpy(), ref, f"pair[{pair_mode},{pair_output_mode}]")

"""The port's torch-checkpoint importers (``models/convert.py``) against the
JAX package's: the same seeded numpy state dict goes through both, and the
two flax trees must have the same keys and equal leaves (exactly: the
importers only rename, transpose, split and select).

* ``resnet_params_from_torch`` on torchvision-layout ResNet-50 and
  ResNet-101 state dicts (``tools/ref_torch_models.py``, its ``fc`` head and
  ``num_batches_tracked`` included), key mapping only; the tree loads
  strictly into the port's ResNet;
* ``vgg16_params_from_torch`` with and without the ``features.`` prefix;
* the encoder and decoder importers at hidden 32, 2 blocks;
* ``destr_variables_from_torch`` and ``ssd_variables_from_torch``
  (``num_cls`` 3) on reference-layout dicts written by
  ``tests/reference_layout.py`` from a random flax tree; on both packages
  the importer gives that tree back (the round trip);
* one forward: the JAX DESTR with the JAX importer's tree and the port's
  DESTR with the port's, float32, dropout 0, 64 px. Both models carry the
  same weights, so the tolerances are those of ``tests/test_torch_model.py``
  and for its reason: the dense mini-detector output 2e-4 of its largest
  value, the decoder's boxes 2e-3 and classes 1e-2 (the decoder refines
  through ``inverse_sigmoid``, whose derivative amplifies small center
  differences); the top-k queries equal.
"""

import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from object_detection_destr_tpu.config import DestrConfig as JaxDestrConfig  # noqa: E402
from object_detection_destr_tpu.config import SSDConfig as JaxSSDConfig  # noqa: E402
from object_detection_destr_tpu.models import convert as jax_convert  # noqa: E402
from object_detection_destr_tpu.models.destr.model import build_destr as jax_build_destr  # noqa: E402
from object_detection_destr_tpu.models.ssd.model import build_ssd as jax_build_ssd  # noqa: E402
from object_detection_destr_tpu_torch.config import DestrConfig  # noqa: E402
from object_detection_destr_tpu_torch.models import convert  # noqa: E402
from object_detection_destr_tpu_torch.models.destr.model import build_destr  # noqa: E402
from object_detection_destr_tpu_torch.models.resnet import ResNet  # noqa: E402
from object_detection_destr_tpu_torch.models.ssd.model import VGG16Features  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
from tools.ref_torch_models import TorchResNet, torch_vgg16_features  # noqa: E402

import reference_layout as layout  # noqa: E402
from test_torch_model import TINY, _close, _topk  # noqa: E402
from test_torch_modules import _random_variables  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401

SIZE = 64
NUM_CLS = 3


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def assert_trees_equal(ours, theirs):
    a, b = _flat(ours), _flat(theirs)
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg="/".join(key))


def _numpy_state_dict(module, seed):
    torch.manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.normal_(0.0, 0.1)
    return {k: v.numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def destr_tree():
    """Random flax variables of the tiny DESTR (ResNet-50 backbone)."""
    model = jax_build_destr(JaxDestrConfig(**TINY))
    return _random_variables(model, np.random.default_rng(5), jnp.zeros((1, SIZE, SIZE, 3)))


@pytest.mark.parametrize("stage_sizes", [(3, 4, 6, 3), (3, 4, 23, 3)], ids=["resnet50", "resnet101"])
def test_resnet_importer_matches_jax(stage_sizes):
    sd = _numpy_state_dict(TorchResNet(stage_sizes), seed=1)
    assert "fc.weight" in sd and any(k.endswith("num_batches_tracked") for k in sd)
    ours = convert.resnet_params_from_torch(sd, stage_sizes)
    assert_trees_equal(ours, jax_convert.resnet_params_from_torch(sd, stage_sizes))
    convert.load_flax_variables(ResNet(stage_sizes), {"params": ours})  # strict: every tensor of the port's


@pytest.mark.parametrize("prefix", ["features.", ""], ids=["features", "bare"])
def test_vgg16_importer_matches_jax(prefix):
    sd = {prefix + k: v for k, v in _numpy_state_dict(torch_vgg16_features(), seed=2).items()}
    ours = convert.vgg16_params_from_torch(sd)
    assert_trees_equal(ours, jax_convert.vgg16_params_from_torch(sd))
    convert.load_flax_variables(VGG16Features(), {"params": ours})


@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_transformer_importers_match_jax(destr_tree, part):
    source = destr_tree["params"][part]
    sd = getattr(layout, f"reference_{part}_state_dict")(source)
    name = f"destr_{part}_params_from_torch"
    ours = getattr(convert, name)(sd, num_blocks=2)
    assert_trees_equal(ours, getattr(jax_convert, name)(sd, num_blocks=2))
    assert_trees_equal(ours, source)


def test_destr_variables_match_jax_and_round_trip(destr_tree):
    sd = layout.reference_destr_state_dict(destr_tree)
    assert "_mini_detector._cls_conv.15.running_var" in sd and "_backbone.0.body.fc.weight" in sd
    ours = convert.destr_variables_from_torch(sd, num_encoder_blocks=2, num_decoder_blocks=2)
    assert_trees_equal(ours, jax_convert.destr_variables_from_torch(sd, num_encoder_blocks=2,
                                                                    num_decoder_blocks=2))
    assert_trees_equal(ours, destr_tree)


def test_ssd_variables_match_jax_and_round_trip():
    model = jax_build_ssd(JaxSSDConfig(num_cls=NUM_CLS))
    tree = _random_variables(model, np.random.default_rng(6), jnp.zeros((1, 300, 300, 3)))
    sd = layout.reference_ssd_state_dict(tree, num_cls=NUM_CLS)
    assert sd["_detectors.conf.0.weight"].shape[0] == 4 * (NUM_CLS + 2)  # the dead channel is there
    ours = convert.ssd_variables_from_torch(sd, num_cls=NUM_CLS)
    assert_trees_equal(ours, jax_convert.ssd_variables_from_torch(sd, num_cls=NUM_CLS))
    assert_trees_equal(ours, tree)


def test_imported_destr_forward_matches_jax(destr_tree):
    sd = layout.reference_destr_state_dict(destr_tree)
    kw = dict(num_encoder_blocks=2, num_decoder_blocks=2)
    theirs = jax_convert.destr_variables_from_torch(sd, **kw)
    ours = convert.destr_variables_from_torch(sd, **kw)
    rng = np.random.default_rng(7)
    images = rng.normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    valid = np.ones((2, SIZE, SIZE), bool)
    valid[1, :, 40:] = False
    jax_model = jax_build_destr(JaxDestrConfig(**TINY))
    apply = jax.jit(lambda v, x, m: jax_model.apply(v, x, valid_mask=m))  # one compile, not one an op
    ref_model, ref_det = jax.tree.map(np.asarray, apply(theirs, jnp.asarray(images), jnp.asarray(valid)))
    model = convert.load_flax_variables(build_destr(DestrConfig(**TINY), "cpu"), ours)
    with torch.no_grad():
        out_model, out_det = model(torch.from_numpy(images), torch.from_numpy(valid))
    out_model, out_det = ({k: v.numpy() for k, v in d.items()} for d in (out_model, out_det))
    _close(out_det["pred_class"], ref_det["pred_class"], "det/pred_class", 2e-4)
    _close(out_det["pred_boxes"], ref_det["pred_boxes"], "det/pred_boxes", 2e-4)
    _close(out_model["pred_class"], ref_model["pred_class"], "pred_class", 1e-2)
    _close(out_model["pred_boxes"], ref_model["pred_boxes"], "pred_boxes", 2e-3)
    np.testing.assert_array_equal(_topk(out_det, valid, "torch"), _topk(ref_det, valid, "jax"))

"""``tools/orbax_to_npz.py``: a checkpoint that the JAX package's trainer
code saves (``train/checkpoint.py::save_checkpoint`` of a fresh
``create_destr_state`` / ``create_ssd_state``, Orbax) becomes the port's
``.npz`` weights file, and the port serves it.

* The ``.npz`` holds every ``params`` and ``batch_stats`` leaf of the
  checkpoint, bit-equal, under ``/`` keys.
* The port's model loaded from the ``.npz`` gives, bit for bit, what the
  port's model loaded from the JAX variables in memory gives.
* Against the JAX model's forward on the same input (float32, eval): the
  mini-detector's dense outputs of a tiny DESTR (64 px, 2 + 2 blocks) and the
  SSD300 heads within 1e-5 of each output's largest magnitude.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from object_detection_destr_tpu.config import DestrConfig as JaxDestrConfig  # noqa: E402
from object_detection_destr_tpu.config import SSDConfig as JaxSSDConfig  # noqa: E402
from object_detection_destr_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from object_detection_destr_tpu.models.destr.model import build_destr as jax_build_destr  # noqa: E402
from object_detection_destr_tpu.models.ssd.model import build_ssd as jax_build_ssd  # noqa: E402
from object_detection_destr_tpu.train.checkpoint import save_checkpoint  # noqa: E402
from object_detection_destr_tpu.train.state import create_destr_state, create_ssd_state  # noqa: E402
from object_detection_destr_tpu_torch.config import DestrConfig, SSDConfig  # noqa: E402
from object_detection_destr_tpu_torch.models.convert import load_flax_variables, load_variables_npz  # noqa: E402
from object_detection_destr_tpu_torch.models.destr.model import build_destr  # noqa: E402
from object_detection_destr_tpu_torch.models.ssd import build_ssd  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import orbax_to_npz  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401

TINY = dict(hidden_dim=32, num_heads=4, ffn_dim=64, num_encoder_blocks=2, num_decoder_blocks=2, top_k=4,
            dropout=0.0)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if isinstance(v, dict) else {"/".join(prefix + (k,)): np.asarray(v)})
    return out


def _relative(ours, ref):
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-6))


@pytest.mark.parametrize("model_name", ["destr", "ssd"])
def test_converted_checkpoint_serves_in_the_port(tmp_path, capsys, model_name):
    size = 64 if model_name == "destr" else 300
    if model_name == "destr":
        jax_model = jax_build_destr(JaxDestrConfig(**TINY))
        state, _ = create_destr_state(jax_model, JaxTrainConfig(), image_size=size)
    else:
        jax_model = jax_build_ssd(JaxSSDConfig())
        state, _ = create_ssd_state(jax_model, JaxTrainConfig(), image_size=size)
    save_checkpoint(str(tmp_path / "ckpt"), "model_weights", state)
    out = str(tmp_path / "weights" / "model_weights.npz")
    result = orbax_to_npz.main(["--checkpoint_dir", str(tmp_path / "ckpt"), "--output", out])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == result

    variables = {"params": state.params, "batch_stats": state.batch_stats}
    expected = _flat(jax.tree.map(np.asarray, variables))
    with np.load(out) as data:
        assert sorted(data.files) == sorted(expected)
        for k in data.files:
            np.testing.assert_array_equal(data[k], expected[k], err_msg=k)
    assert result["leaves"] == len(expected)

    images = np.random.default_rng(1).normal(size=(1, size, size, 3)).astype(np.float32)
    build = (lambda: build_destr(DestrConfig(**TINY), "cpu")) if model_name == "destr" else \
        (lambda: build_ssd(SSDConfig(), "cpu"))
    from_npz = load_flax_variables(build(), load_variables_npz(out))
    from_memory = load_flax_variables(build(), jax.tree.map(np.asarray, variables))
    ref = jax_model.apply(variables, jnp.asarray(images), train=False)
    with torch.no_grad():
        ours, again = from_npz(torch.from_numpy(images)), from_memory(torch.from_numpy(images))
    if model_name == "destr":
        pairs = [(ours[1][k], again[1][k], ref[1][k]) for k in ("pred_class", "pred_boxes")]
    else:
        pairs = [(o, a, r) for key in ("boxes", "conf") for o, a, r in zip(ours[key], again[key], ref[key])]
    for o, a, r in pairs:
        assert torch.equal(o, a)
        assert _relative(o.numpy(), np.asarray(r)) <= 1e-5

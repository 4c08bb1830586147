"""One float32 SSD300 train step of the port against the JAX package's
``make_ssd_train_step``: B=2 at 300 px, the same random flax variables
carried across, the same batch (cxcyhw targets, some padded), and the SSD
production recipe's optimizer options (paper mining, lr 1e-4 on both
groups, warmup 500, skip-if-non-finite 100).

Tolerances, and why:
  * losses ("loss", "class", "local"): 1e-5 relative (float32 through VGG-16,
    the extra blocks and the criterion, summed in another order);
  * the Adam first moment after the step, 0.1 x the gradient of every
    trained leaf (the extra blocks and the heads; the VGG trunk is frozen in
    both packages and has none), each leaf's error 2-norm against its own
    2-norm: 1e-4 for the heads; 1e-2 for the extra blocks, whose gradient
    passes the batch-statistics BatchNorm backward (differences of sums
    over 2 x 37 x 37 positions that nearly cancel): in the port alone it
    moves by up to 2.1e-3 of its norm when the images change by 1e-6
    relative, and it is 9e-4 to 2e-3 from JAX's. Leaves whose gradient is
    exactly 0 on both sides (the last extra block and head, at 1 x 1) stay 0;
  * the extra blocks' BatchNorm running statistics (flax momentum 0.9,
    biased batch variance): 1e-4 of each statistic's largest value (the
    batch means come through ten float32 convolutions; measured 1.3e-5);
  * the frozen trunk did not move, the heads did.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from object_detection_destr_tpu.config import SSDConfig as JaxSSDConfig  # noqa: E402
from object_detection_destr_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from object_detection_destr_tpu.models.ssd.model import build_ssd as jax_build_ssd  # noqa: E402
from object_detection_destr_tpu.train.optim import build_optimizer  # noqa: E402
from object_detection_destr_tpu.train.state import TrainState as JaxTrainState  # noqa: E402
from object_detection_destr_tpu.train.state import _lr_specs as jax_lr_specs  # noqa: E402
from object_detection_destr_tpu.train.steps import make_ssd_train_step as jax_make_step  # noqa: E402
from object_detection_destr_tpu_torch.config import SSDConfig, TrainConfig  # noqa: E402
from object_detection_destr_tpu_torch.models.convert import (  # noqa: E402
    flax_variables_from_state_dict,
    load_flax_variables,
    state_dict_from_flax,
)
from object_detection_destr_tpu_torch.models.ssd import build_ssd  # noqa: E402
from object_detection_destr_tpu_torch.train.state import create_ssd_state  # noqa: E402
from object_detection_destr_tpu_torch.train.steps import make_ssd_train_step  # noqa: E402

from test_torch_modules import _random_variables  # noqa: E402
from test_torch_train_step import _mu_tree  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401

TRAIN = dict(lr=1e-4, lr_backbone=1e-4, batch_size=2, lr_warmup_steps=500, skip_nonfinite_updates=100)
SSD = dict(hard_neg_mining="paper")
SIZE, T = 300, 5


def _batch(rng):
    cxcy = rng.uniform(0.3, 0.7, (2, T, 2))
    hw = rng.uniform(0.1, 0.4, (2, T, 2))
    valid = np.zeros((2, T), bool)
    valid[0, :2] = True
    valid[1, :4] = True
    return {
        "images": rng.normal(size=(2, SIZE, SIZE, 3)).astype(np.float32),
        "boxes": np.concatenate([cxcy, hw], -1).astype(np.float32),
        "labels": rng.integers(0, 20, (2, T)).astype(np.int32),
        "valid": valid,
    }


@pytest.fixture(scope="module")
def step():
    rng = np.random.default_rng(1)
    jax_model = jax_build_ssd(JaxSSDConfig(**SSD))
    variables = _random_variables(jax_model, rng, jnp.zeros((1, SIZE, SIZE, 3)))
    batch = _batch(rng)

    jcfg = JaxTrainConfig(**TRAIN)
    lr, lr_bb = jax_lr_specs(jcfg, 10)
    params = jax.tree.map(jnp.asarray, variables["params"])
    tx = build_optimizer(params, lr=lr, lr_backbone=lr_bb, skip_nonfinite=jcfg.skip_nonfinite_updates)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                          opt_state=tx.init(params), rng=jax.random.key(0))
    state, metrics = jax_make_step(jax_model, tx, jcfg, JaxSSDConfig(**SSD))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    ref = (jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats}),
           {k: float(v) for k, v in metrics.items()}, _mu_tree(state.opt_state))

    model = load_flax_variables(build_ssd(SSDConfig(**SSD), "cpu"), variables)
    tstate = create_ssd_state(model, TrainConfig(**TRAIN), steps_per_epoch=10)
    metrics = make_ssd_train_step(TrainConfig(**TRAIN), SSDConfig(**SSD))(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    ours = (flax_variables_from_state_dict(model), {k: float(v) for k, v in metrics.items()},
            dict(tstate.optimizer.m))
    return variables, ref, ours, tstate


def test_ssd_train_step_matches_jax(step):
    variables, (ref_vars, ref_metrics, ref_mu), (our_vars, our_metrics, our_m), _ = step
    assert set(our_metrics) == set(ref_metrics) == {"loss", "class", "local"}
    for k, v in ref_metrics.items():
        np.testing.assert_allclose(our_metrics[k], v, rtol=1e-5, err_msg=k)
    mu = state_dict_from_flax({"params": ref_mu})
    assert set(mu) == set(our_m) and not any(name.startswith("backbone.") for name in mu)
    for name, m in our_m.items():
        norm = mu[name].norm().item()
        if norm == 0:
            assert not m.any(), name
            continue
        tol = 1e-2 if name.startswith("extra") else 1e-4
        assert (m - mu[name]).norm().item() <= tol * norm, name
    for path, a, b in zip(jax.tree_util.tree_flatten_with_path(ref_vars["batch_stats"])[0],
                          jax.tree.leaves(our_vars["batch_stats"]), jax.tree.leaves(ref_vars["batch_stats"])):
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), jax.tree_util.keystr(path[0])
    assert np.array_equal(our_vars["params"]["backbone"]["conv3"]["kernel"],
                          variables["params"]["backbone"]["conv3"]["kernel"])
    assert not np.array_equal(our_vars["params"]["conf_head0"]["kernel"], variables["params"]["conf_head0"]["kernel"])
    assert not np.array_equal(our_vars["batch_stats"]["extra2"]["bn2"]["var"],
                              variables["batch_stats"]["extra2"]["bn2"]["var"])


def test_ssd_state_counts(step):
    *_, tstate = step
    assert tstate.step == 1 and tstate.optimizer.count == 1
    # the frozen trunk carries gradients (the clip and the finite check count them)
    assert tstate.model.backbone.conv0.weight.grad is not None

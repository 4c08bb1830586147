"""One and two tiny DESTR train steps of the port against the JAX package's
``make_destr_train_step``: same weights (random flax variables carried
across), same batch, dropout 0, float32, the flash path on both sides, the
production optimizer options (boxes-normalized class loss, L1 weight 2.5,
clip 0.1, skip-if-non-finite, warmup, lr 1e-4 / 1e-5), and the matcher on the
fused kernel's path on both sides (``OBJDET_FORCE_PALLAS_MATCHER=1`` routes
the JAX step through ``hungarian_match_pallas`` in interpret mode; the port
always matches that way).

Tolerances, and why:
  * losses and metrics: 1e-4 relative (float32 through a ResNet-50, the
    transformer and the criterion, summed in another order);
  * the Adam first moment after the step, which is 0.1 x the clipped
    gradient of every trained leaf, relative to each leaf's largest value
    (floored at 1e-4 of the largest of all, for leaves whose gradient is zero
    in exact arithmetic): after the first step 5e-3, and 1e-1 for the
    backbone, whose gradients at this tiny random configuration move by
    1.7e-2 in the JAX step itself when the images change by 1e-6; after the
    second step 2e-1 everywhere, since the first step's Adam update already
    differs by +-lr on elements whose gradient is noise (next point);
  * updated parameters: within 2 x lr + 1e-6 of JAX's. Adam's first step
    moves every element by lr times m/sqrt(v), about +-1 whatever the
    gradient's size, so an element whose gradient is float32 noise may step
    the other way; everything above noise is held by the moment check;
  * mini-detector BatchNorm statistics: 1e-5 relative after the first step;
    after the second (weights apart by the +-lr steps above) 1e-4 of each
    statistic's largest value.
A bf16 forward is compared at 5e-2 of each output's largest value (bf16
rounds at other places in flax and under torch.autocast).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from object_detection_destr_tpu.config import DestrConfig as JaxDestrConfig  # noqa: E402
from object_detection_destr_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from object_detection_destr_tpu.models.destr.model import build_destr as jax_build_destr  # noqa: E402
from object_detection_destr_tpu.train.optim import build_optimizer  # noqa: E402
from object_detection_destr_tpu.train.state import TrainState as JaxTrainState  # noqa: E402
from object_detection_destr_tpu.train.state import _lr_specs as jax_lr_specs  # noqa: E402
from object_detection_destr_tpu.train.steps import make_destr_train_step as jax_make_step  # noqa: E402
from object_detection_destr_tpu_torch.config import DestrConfig, TrainConfig  # noqa: E402
from object_detection_destr_tpu_torch.models.convert import (  # noqa: E402
    flax_variables_from_state_dict,
    load_flax_variables,
    state_dict_from_flax,
)
from object_detection_destr_tpu_torch.models.destr.model import build_destr  # noqa: E402
from object_detection_destr_tpu_torch.ops.topk import masked_topk_with_recycle  # noqa: E402
from object_detection_destr_tpu_torch.train.state import create_destr_state  # noqa: E402
from object_detection_destr_tpu_torch.train.steps import make_destr_train_step  # noqa: E402

from test_torch_modules import _random_variables  # noqa: E402

TINY = dict(hidden_dim=32, num_heads=4, ffn_dim=64, num_encoder_blocks=2,
            num_decoder_blocks=2, top_k=4, dropout=0.0)
TRAIN = dict(lr=1e-4, lr_backbone=1e-5, batch_size=2, set_cost_class=1.0, set_cost_bbox=2.5,
             set_cost_ciou=1.0, class_norm="boxes", grad_clip_norm=0.1,
             skip_nonfinite_updates=100, lr_warmup_steps=3)
SIZE, T = 128, 6


def _batches(n):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        xy = rng.uniform(0.0, 0.6, (2, T, 2))
        wh = rng.uniform(0.1, 0.4, (2, T, 2))
        valid = np.zeros((2, T), bool)
        valid[0, :3] = True
        valid[1, :5] = True
        out.append({
            "images": rng.normal(size=(2, SIZE, SIZE, 3)).astype(np.float32),
            "boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
            "labels": np.zeros((2, T), np.int32),
            "valid": valid,
        })
    return out


def _mu_tree(opt_state):
    """The Adam first moments of the optax state as a flax params tree."""
    tree = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        names = [getattr(p, "name", getattr(p, "key", None)) for p in path]
        if "mu" not in names:
            continue
        keys = [str(k) for k in names[names.index("mu") + 1:]]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.asarray(leaf)
    return tree


@pytest.fixture(scope="module")
def steps(monkeypatch_module):
    monkeypatch_module.setenv("OBJDET_FORCE_PALLAS_MATCHER", "1")
    rng = np.random.default_rng(0)
    jax_model = jax_build_destr(JaxDestrConfig(**TINY, use_flash_attention=True))
    variables = _random_variables(jax_model, rng, jnp.zeros((1, SIZE, SIZE, 3)))
    batches = _batches(2)

    jcfg = JaxTrainConfig(**TRAIN)
    lr, lr_bb = jax_lr_specs(jcfg, 10)
    params = jax.tree.map(jnp.asarray, variables["params"])
    tx = build_optimizer(params, lr=lr, lr_backbone=lr_bb, grad_clip=jcfg.grad_clip_norm,
                         skip_nonfinite=jcfg.skip_nonfinite_updates)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                          opt_state=tx.init(params), rng=jax.random.key(0))
    jstep = jax_make_step(jax_model, tx, jcfg)
    ref = []
    for batch in batches:
        state, metrics = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
        ref.append((jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats}),
                    {k: float(v) for k, v in metrics.items()}, _mu_tree(state.opt_state)))

    model = load_flax_variables(build_destr(DestrConfig(**TINY), "cpu"), variables)
    tstate = create_destr_state(model, TrainConfig(**TRAIN), steps_per_epoch=10)
    tstep = make_destr_train_step(TrainConfig(**TRAIN))
    ours = []
    for batch in batches:
        metrics = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        ours.append((flax_variables_from_state_dict(model), {k: float(v) for k, v in metrics.items()},
                     {name: m.clone() for name, m in tstate.optimizer.m.items()}))
    return variables, ref, ours, tstate


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_matches_jax(steps, step):
    variables, ref, ours, _ = steps
    (ref_vars, ref_metrics, ref_mu), (our_vars, our_metrics, our_m) = ref[step], ours[step]
    for k, v in ref_metrics.items():
        assert abs(our_metrics[k] - v) <= 1e-4 * max(abs(v), 1e-3), (k, our_metrics[k], v)

    # gradients, through the Adam first moment (torch layout on both sides)
    mu = state_dict_from_flax({"params": ref_mu})
    assert set(mu) == set(our_m)
    # leaves whose gradient is zero in exact arithmetic (a key projection's
    # bias: softmax ignores a shift common to a row) hold float32 noise:
    # their scale is floored at 1e-4 of the largest moment
    floor = 1e-4 * max(t.abs().max().item() for t in mu.values())
    for name, m in our_m.items():
        scale = max(mu[name].abs().max().item(), floor)
        tol = 2e-1 if step else (1e-1 if name.startswith("backbone.") else 5e-3)
        assert (m - mu[name]).abs().max().item() <= tol * scale, name

    lr = TRAIN["lr"]
    for path, a, b in zip(jax.tree_util.tree_flatten_with_path(ref_vars["params"])[0],
                          jax.tree.leaves(our_vars["params"]), jax.tree.leaves(ref_vars["params"])):
        assert np.abs(a - b).max() <= 2 * lr + 1e-6, jax.tree_util.keystr(path[0])
    for a, b in zip(jax.tree.leaves(our_vars["batch_stats"]), jax.tree.leaves(ref_vars["batch_stats"])):
        if step == 0:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        else:
            assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
    # the frozen leaves did not move, the trained ones did
    assert np.array_equal(our_vars["params"]["backbone"]["conv1"]["kernel"],
                          variables["params"]["backbone"]["conv1"]["kernel"])
    assert not np.array_equal(our_vars["params"]["cls_embed"]["kernel"], variables["params"]["cls_embed"]["kernel"])


def test_train_state_counts(steps):
    *_, tstate = steps
    assert tstate.step == 2 and tstate.optimizer.count == 2
    # the frozen backbone leaves carry gradients (the clip counts them)
    assert tstate.model.backbone.bn1.running_var.grad is not None


def test_bf16_forward_matches_jax():
    """The class head's weights are scaled down so the mini-detector's scores
    are not saturated: the decoder's inputs are the top-k of those scores
    and its pairs an argmax of IoUs, discrete choices that bf16 rounding can
    flip where two candidates nearly tie (as float32 noise does on the card,
    see chip_smoke.py). This seed has no flip, which the equal top-k indices confirm."""
    rng = np.random.default_rng(2)
    cfg = dict(TINY, compute_dtype="bfloat16")
    jax_model = jax_build_destr(JaxDestrConfig(**cfg, use_flash_attention=True))
    variables = _random_variables(jax_model, rng, jnp.zeros((1, SIZE, SIZE, 3)))
    variables["params"]["cls_embed"]["kernel"] = variables["params"]["cls_embed"]["kernel"] * 0.05
    images = rng.normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    ref = jax.tree.map(np.asarray, jax_model.apply(variables, jnp.asarray(images)))
    model = load_flax_variables(build_destr(DestrConfig(**cfg), "cpu"), variables)
    with torch.no_grad():
        ours = model(torch.from_numpy(images))
    for part_ours, part_ref in zip(ours, ref):
        for key in ("pred_class", "pred_boxes"):
            o, r = part_ours[key], part_ref[key]
            assert o.dtype == torch.float32 and r.dtype == np.float32
            assert np.abs(o.numpy() - r).max() <= 5e-2 * np.abs(r).max(), key
    valid = torch.ones(2, (SIZE // 32) ** 2, dtype=torch.bool)
    topk = [masked_topk_with_recycle(torch.sigmoid(torch.as_tensor(det["pred_class"])).amax(-1), TINY["top_k"], valid)
            for det in (ours[1], ref[1])]
    assert torch.equal(topk[0], topk[1])

"""``DestrConfig(remat=True)``: each encoder and decoder block recomputed in
the backward (``torch.utils.checkpoint``; ``nn.remat`` in the JAX package).

* One tiny DESTR train step with remat against the JAX package's step with
  remat, at dropout 0 (the setting and the loss and moment tolerances of
  ``tests/test_torch_train_step.py``: same weights, float32, the flash path
  and the fused matcher's path on both sides), and each parameter's change
  against JAX's.
* The port's step with and without remat at dropout 0.3 from one state: the
  recomputation replays the forward's dropout masks and flash-kernel seeds,
  so the gradients (read through Adam's first moment) and the updated
  parameters are equal, bit for bit on the CPU. A recomputation that draws
  afresh instead (the replay switched off) gives other gradients: the check
  sees a wrong replay.
"""

import contextlib

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
from object_detection_destr_tpu_torch.models.convert import load_flax_variables, state_dict_from_flax  # noqa: E402
from object_detection_destr_tpu_torch.models.destr.layers import DropoutRng  # noqa: E402
from object_detection_destr_tpu_torch.models.destr.model import build_destr  # noqa: E402
from object_detection_destr_tpu_torch.train.optim import param_labels  # noqa: E402
from object_detection_destr_tpu_torch.train.state import create_destr_state  # noqa: E402
from object_detection_destr_tpu_torch.train.steps import make_destr_train_step  # noqa: E402

from test_torch_modules import _random_variables  # noqa: E402
from test_torch_train_step import _mu_tree  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401

TINY = dict(hidden_dim=32, num_heads=4, ffn_dim=64, num_encoder_blocks=2, num_decoder_blocks=2, top_k=4)
TRAIN = dict(lr=1e-4, lr_backbone=1e-5, batch_size=2, set_cost_class=1.0, set_cost_bbox=2.5,
             set_cost_ciou=1.0, class_norm="boxes", grad_clip_norm=0.1, skip_nonfinite_updates=100,
             lr_warmup_steps=3)
SIZE, T = 64, 6


def _batch(seed=7):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.0, 0.6, (2, T, 2))
    wh = rng.uniform(0.1, 0.4, (2, T, 2))
    valid = np.zeros((2, T), bool)
    valid[0, :3] = True
    valid[1, :5] = True
    return {"images": rng.normal(size=(2, SIZE, SIZE, 3)).astype(np.float32),
            "boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
            "labels": np.zeros((2, T), np.int32), "valid": valid}


def test_remat_step_matches_jax_remat(monkeypatch):
    monkeypatch.setenv("OBJDET_FORCE_PALLAS_MATCHER", "1")
    rng = np.random.default_rng(0)
    jax_model = jax_build_destr(JaxDestrConfig(**TINY, dropout=0.0, use_flash_attention=True, remat=True))
    variables = _random_variables(jax_model, rng, jnp.zeros((1, SIZE, SIZE, 3)))
    batch = _batch()

    jcfg = JaxTrainConfig(**TRAIN)
    lr, lr_bb = jax_lr_specs(jcfg, 10)
    params = jax.tree.map(jnp.asarray, variables["params"])
    tx = build_optimizer(params, lr=lr, lr_backbone=lr_bb, grad_clip=jcfg.grad_clip_norm,
                         skip_nonfinite=jcfg.skip_nonfinite_updates)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                          opt_state=tx.init(params), rng=jax.random.key(0))
    state, ref_metrics = jax_make_step(jax_model, tx, jcfg)(state, {k: jnp.asarray(v) for k, v in batch.items()})
    ref_params = jax.tree.map(np.asarray, state.params)
    mu = state_dict_from_flax({"params": _mu_tree(state.opt_state)})

    model = load_flax_variables(build_destr(DestrConfig(**TINY, dropout=0.0, remat=True), "cpu"), variables)
    assert model.encoder.remat and model.decoder.remat
    tstate = create_destr_state(model, TrainConfig(**TRAIN), steps_per_epoch=10)
    metrics = make_destr_train_step(TrainConfig(**TRAIN))(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})

    for k, v in ref_metrics.items():
        v = float(v)
        assert abs(float(metrics[k]) - v) <= 1e-4 * max(abs(v), 1e-3), (k, float(metrics[k]), v)
    floor = 1e-4 * max(t.abs().max().item() for t in mu.values())
    for name, m in tstate.optimizer.m.items():
        scale = max(mu[name].abs().max().item(), floor)
        tol = 1e-1 if name.startswith("backbone.") else 5e-3
        assert (m - mu[name]).abs().max().item() <= tol * scale, name
    # each parameter's change against JAX's: within 1% of it, plus 1% of the
    # group's lr in RMS for the leaves whose gradient is rounding noise (a
    # bias before a BatchNorm, a key projection's bias), where Adam's
    # g / (|g| + eps) has no sign to agree on
    start = state_dict_from_flax({"params": variables["params"]})
    ref_sd = state_dict_from_flax({"params": ref_params})
    lrs = {"main": TRAIN["lr"], "backbone": TRAIN["lr_backbone"], "frozen": TRAIN["lr"]}
    labels = param_labels(model)
    for name, p in model.named_parameters():
        ours, theirs = (p.detach() - start[name]).double(), (ref_sd[name] - start[name]).double()
        floor = 1e-2 * lrs[labels[name]] * ours.numel() ** 0.5
        assert (ours - theirs).norm() <= 1e-2 * theirs.norm() + floor, name


def _step_at_dropout(remat: bool, replay: bool = True):
    """One port step at dropout 0.3 from one seeded state: (Adam's first
    moment by name, the parameters after the update)."""
    torch.manual_seed(0)
    model = build_destr(DestrConfig(**TINY, dropout=0.3, remat=remat), "cpu")
    tstate = create_destr_state(model, TrainConfig(**TRAIN), steps_per_epoch=10)
    patch = contextlib.nullcontext() if replay else pytest.MonkeyPatch.context()
    with patch as mp:
        if not replay:  # the planted fault: the recomputation draws new masks and seeds
            mp.setattr(DropoutRng, "taped", lambda self, tape, replay: contextlib.nullcontext())
        make_destr_train_step(TrainConfig(**TRAIN))(tstate, {k: torch.from_numpy(v) for k, v in _batch(3).items()})
    return ({k: v.clone() for k, v in tstate.optimizer.m.items()},
            {k: v.detach().clone() for k, v in model.named_parameters()})


def test_remat_replays_dropout():
    plain_m, plain_p = _step_at_dropout(remat=False)
    remat_m, remat_p = _step_at_dropout(remat=True)
    assert set(plain_m) == set(remat_m)
    for name in plain_m:
        assert torch.equal(plain_m[name], remat_m[name]), name
    for name in plain_p:
        assert torch.equal(plain_p[name], remat_p[name]), name
    # without the replay the recomputed blocks draw other masks: the gradients move
    fault_m, _ = _step_at_dropout(remat=True, replay=False)
    differ = [n for n in plain_m if not torch.equal(plain_m[n], fault_m[n])]
    assert any(n.startswith(("encoder.block", "decoder.block")) for n in differ)

"""One tiny DESTR train step of the port against the JAX package's at a
hidden width whose merged cross-attention head (d = 2C) is wider than 512:
the width at which the port's backward leaves the fused kernel for the
two-pass one (``backward_plan``), as the production recipe does with
``--hidden_dim 512``. On the CPU the port's autograd Function then runs the
plain versions of kernels #3 and #4; the test counts their calls.

Setting, tolerances and their reasons as in tests/test_torch_train_step.py
(first step): same weights and batch, dropout 0, float32, the flash path on
both sides, the production optimizer options, and the fused matcher's path
on both sides. The step takes discrete choices (the mini-detector's top-k,
the pairs, the matcher's rows) that float32 noise can flip at a near-tie;
the losses then still agree, but single leaves' gradients move by a few
percent (weights from seed 1 show it). The weights here come from seed 0,
at which every moment agrees within 5e-4 of its leaf's largest value.
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
from object_detection_destr_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402
from object_detection_destr_tpu_torch.train.state import create_destr_state  # noqa: E402
from object_detection_destr_tpu_torch.train.steps import make_destr_train_step  # noqa: E402

from test_torch_modules import _random_variables  # noqa: E402
from test_torch_train_step import SIZE, TRAIN, _batches, _mu_tree  # noqa: E402

# cross-attention head 2 * 272 = 544 wide, past the fused backward's 512;
# encoder (68) and decoder self-attention (136) stay on the fused one. At
# hidden 520 the cross head is 1040 wide, past the 1024 of a hidden-512
# model, where the kernels split the gradient's columns (float32) or the
# forward streams q (float32); the plain versions take any width. That case
# runs one block of each kind to stay small
WIDE = dict(hidden_dim=272, num_heads=4, ffn_dim=64, num_encoder_blocks=2,
            num_decoder_blocks=2, top_k=4, dropout=0.0)


@pytest.mark.parametrize("size", [{}, dict(hidden_dim=520, num_encoder_blocks=1, num_decoder_blocks=1)],
                         ids=["h272", "h520"])
def test_wide_train_step_matches_jax(monkeypatch, size):
    WIDE = dict(globals()["WIDE"], **size)
    monkeypatch.setenv("OBJDET_FORCE_PALLAS_MATCHER", "1")
    rng = np.random.default_rng(0)
    jax_model = jax_build_destr(JaxDestrConfig(**WIDE, use_flash_attention=True))
    variables = _random_variables(jax_model, rng, jnp.zeros((1, SIZE, SIZE, 3)))
    batch = _batches(1)[0]

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

    calls = {"fused": 0, "dq": 0, "dkv": 0}

    def counted(name, fn):
        def inner(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return inner

    monkeypatch.setattr(fa, "flash_attention_packed_backward_reference",
                        counted("fused", fa.flash_attention_packed_backward_reference))
    monkeypatch.setattr(fa, "flash_attention_dq_reference", counted("dq", fa.flash_attention_dq_reference))
    monkeypatch.setattr(fa, "flash_attention_dkv_reference", counted("dkv", fa.flash_attention_dkv_reference))
    model = load_flax_variables(build_destr(DestrConfig(**WIDE), "cpu"), variables)
    tstate = create_destr_state(model, TrainConfig(**TRAIN), steps_per_epoch=10)
    metrics = make_destr_train_step(TrainConfig(**TRAIN))(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    # per decoder block: the cross-attention two-pass, the self-attention fused;
    # per encoder block: fused
    blocks = WIDE["num_decoder_blocks"]
    assert calls == {"fused": WIDE["num_encoder_blocks"] + blocks, "dq": blocks, "dkv": blocks}

    for k, v in ref_metrics.items():
        v = float(v)
        assert abs(float(metrics[k]) - v) <= 1e-4 * max(abs(v), 1e-3), (k, float(metrics[k]), v)
    our_m = tstate.optimizer.m
    assert set(mu) == set(our_m)
    floor = 1e-4 * max(t.abs().max().item() for t in mu.values())
    for name, m in our_m.items():
        scale = max(mu[name].abs().max().item(), floor)
        tol = 1e-1 if name.startswith("backbone.") else 5e-3
        assert (m - mu[name]).abs().max().item() <= tol * scale, name
    ours = flax_variables_from_state_dict(model)["params"]
    for path, a, b in zip(jax.tree_util.tree_flatten_with_path(ref_params)[0], jax.tree.leaves(ours),
                          jax.tree.leaves(ref_params)):
        assert np.abs(a - b).max() <= 2 * TRAIN["lr"] + 1e-6, jax.tree_util.keystr(path[0])

"""The port's AdamW (train/optim.py) against the JAX package's optax chain
(train/optim.py::build_optimizer, per-leaf layout) over several steps: the
main / backbone / frozen groups, weight decay 0.01, the global-norm clip
whose norm counts the frozen leaves' gradients, warmup and lr_drop
schedules, and skip-if-non-finite including optax's give-up after
``skip_nonfinite`` consecutive bad steps.

Both sides get the same parameters and the same gradient sequence (numpy,
seeded). Tolerance: 2e-6 absolute on parameters of order 1 (float32 Adam
arithmetic in another order).
"""

import numpy as np
import pytest
import torch
from torch import nn

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from object_detection_destr_tpu.train.optim import build_optimizer  # noqa: E402
from object_detection_destr_tpu.train.state import _lr_specs as jax_lr_specs  # noqa: E402
from object_detection_destr_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from object_detection_destr_tpu_torch.config import TrainConfig  # noqa: E402
from object_detection_destr_tpu_torch.train.optim import AdamW, param_labels  # noqa: E402
from object_detection_destr_tpu_torch.train.state import _lr_specs  # noqa: E402

# (path, shape): stem conv, a FrozenBN tensor, layer1 (frozen), layer2 conv
# (backbone), a layer2 FrozenBN tensor (frozen), main weights
LEAVES = {
    ("backbone", "conv1", "weight"): (4, 3),
    ("backbone", "bn1", "running_var"): (4,),
    ("backbone", "layer1_0", "conv1", "weight"): (3, 3),
    ("backbone", "layer2_0", "conv1", "weight"): (5, 2),
    ("backbone", "layer2_0", "downsample_bn", "bias"): (5,),
    ("encoder", "fc", "weight"): (6, 4),
    ("encoder", "fc", "bias"): (6,),
    ("cls_embed", "weight"): (2, 3),
}
EXPECTED = ["frozen", "frozen", "frozen", "backbone", "frozen", "main", "main", "main"]


class Tree(nn.Module):
    def __init__(self, values):
        super().__init__()
        children = {}
        for path, value in values.items():
            children.setdefault(path[0], {})[path[1:]] = value
        for name, sub in children.items():
            if list(sub) == [()]:
                self.register_parameter(name, nn.Parameter(torch.from_numpy(sub[()].copy())))
            else:
                self.add_module(name, Tree(sub))


def _nest(flat):
    tree = {}
    for path, value in flat.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    return tree


def _run(cfg_kwargs, grads_seq, steps_per_epoch=2):
    rng = np.random.default_rng(0)
    init = {p: rng.normal(size=s).astype(np.float32) for p, s in LEAVES.items()}
    jcfg = JaxTrainConfig(**cfg_kwargs)
    lr, lr_bb = jax_lr_specs(jcfg, steps_per_epoch)
    params = _nest({p: jnp.asarray(v) for p, v in init.items()})
    tx = build_optimizer(params, lr=lr, lr_backbone=lr_bb, grad_clip=jcfg.grad_clip_norm or None,
                         skip_nonfinite=jcfg.skip_nonfinite_updates)
    opt_state = tx.init(params)

    model = Tree(init)
    tcfg = TrainConfig(**cfg_kwargs)
    t_lr, t_lr_bb = _lr_specs(tcfg, steps_per_epoch)
    opt = AdamW(model, lr=t_lr, lr_backbone=t_lr_bb, grad_clip=tcfg.grad_clip_norm or None,
                skip_nonfinite=tcfg.skip_nonfinite_updates)
    assert list(param_labels(model).values()) == EXPECTED
    named = dict(model.named_parameters())
    for grads in grads_seq:
        upd, opt_state = tx.update(_nest({p: jnp.asarray(g) for p, g in grads.items()}), opt_state, params)
        params = optax.apply_updates(params, upd)
        for path, g in grads.items():
            named[".".join(path)].grad = torch.from_numpy(g.copy())
        opt.step()
    flat_ref = {p: np.asarray(_get(params, p)) for p in LEAVES}
    return flat_ref, {p: named[".".join(p)].detach().numpy() for p in LEAVES}, opt


def _get(tree, path):
    for part in path:
        tree = tree[part]
    return tree


def _grads(seed, scale=1.0, nan_at=()):
    rng = np.random.default_rng(seed)
    out = []
    for step in range(6):
        g = {p: (rng.normal(size=s) * scale).astype(np.float32) for p, s in LEAVES.items()}
        if step in nan_at:
            g[("backbone", "bn1", "running_var")][0] = np.nan  # a frozen leaf's gradient
        out.append(g)
    return out


CASES = {
    "groups": (dict(lr=1e-2, lr_backbone=1e-3), _grads(1)),
    "frozen_backbone": (dict(lr=1e-2, lr_backbone=0.0), _grads(2)),
    "clip_warmup_drop": (dict(lr=1e-2, lr_backbone=1e-3, grad_clip_norm=0.1, lr_warmup_steps=3,
                              lr_drop=2), _grads(3, scale=10.0)),
    "skip_nonfinite": (dict(lr=1e-2, lr_backbone=1e-3, grad_clip_norm=0.1, skip_nonfinite_updates=3,
                            lr_warmup_steps=2), _grads(4, nan_at=(1, 3))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_adamw_matches_optax(name):
    cfg, grads = CASES[name]
    ref, ours, _ = _run(cfg, grads)
    for p in LEAVES:
        np.testing.assert_allclose(ours[p], ref[p], rtol=0, atol=2e-6, err_msg=str(p))


def test_skip_nonfinite_gives_up_like_optax():
    """Three bad steps in a row with max 2: the first two change nothing,
    the third is applied (NaN parameters), as optax.apply_if_finite does."""
    cfg = dict(lr=1e-2, lr_backbone=1e-3, skip_nonfinite_updates=2)
    grads = _grads(5, nan_at=(0, 1, 2))[:3]
    for g in grads:
        g[("encoder", "fc", "bias")][0] = np.nan
    ref, ours, opt = _run(cfg, grads[:2])
    for p in LEAVES:
        np.testing.assert_array_equal(ours[p], ref[p])
    assert opt.count == 0 and opt.notfinite_count == 2
    ref, ours, opt = _run(cfg, grads)
    assert np.isnan(ours[("encoder", "fc", "bias")]).any() and np.isnan(ref[("encoder", "fc", "bias")]).any()
    assert opt.count == 1

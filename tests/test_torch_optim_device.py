"""The port's AdamW with its decisions on the device (train/optim.py):
the update count and the non-finite count are int64 tensors, the lr schedule
and the bias corrections are computed from the count there, a skipped step
is a ``torch.where``. Held against the JAX package's optax chain
(``build_optimizer``, per-leaf layout, ``optax.apply_if_finite``) through
warmup, the lr drop and sequences of non-finite and finite gradients, and
the schedule against the JAX package's in float32.

Tolerance: 2e-6 absolute on parameters of order 1 (float32 Adam arithmetic
in another order), as tests/test_torch_optim.py; the schedule exactly.
"""

import numpy as np
import pytest
import torch
from torch import nn

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from object_detection_destr_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from object_detection_destr_tpu.train.optim import build_optimizer  # noqa: E402
from object_detection_destr_tpu.train.state import _lr_specs as jax_lr_specs  # noqa: E402
from object_detection_destr_tpu_torch.config import TrainConfig  # noqa: E402
from object_detection_destr_tpu_torch.train.optim import AdamW  # noqa: E402
from object_detection_destr_tpu_torch.train.state import _lr_specs  # noqa: E402

# a main leaf, a backbone leaf and a frozen one (the global norm counts it)
SHAPES = {("encoder", "w"): (4, 3), ("backbone", "layer3_0", "conv1", "weight"): (5,),
          ("backbone", "bn1", "weight"): (2,)}


class _Tree(nn.Module):
    def __init__(self, values: dict, depth: int = 0):
        super().__init__()
        groups = {}
        for path, value in values.items():
            groups.setdefault(path[depth], {})[path] = value
        for name, sub in groups.items():
            if len(sub) == 1 and len(next(iter(sub))) == depth + 1:
                self.register_parameter(name, nn.Parameter(torch.from_numpy(next(iter(sub.values())).copy())))
            else:
                self.add_module(name, _Tree(sub, depth + 1))


def _nest(flat):
    tree = {}
    for path, value in flat.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    return tree


def _leaf(tree, path):
    for part in path:
        tree = tree[part]
    return tree


def _run(cfg_kwargs, bad_steps, n_steps, steps_per_epoch=3):
    rng = np.random.default_rng(7)
    init = {p: rng.normal(size=s).astype(np.float32) for p, s in SHAPES.items()}
    grads = [{p: (rng.normal(size=s) * 3.0).astype(np.float32) for p, s in SHAPES.items()} for _ in range(n_steps)]
    for i in bad_steps:
        grads[i][("backbone", "bn1", "weight")][1] = np.inf if i % 2 else np.nan
    jcfg = JaxTrainConfig(**cfg_kwargs)
    lr, lr_bb = jax_lr_specs(jcfg, steps_per_epoch)
    params = _nest({p: jnp.asarray(v) for p, v in init.items()})
    tx = build_optimizer(params, lr=lr, lr_backbone=lr_bb, grad_clip=jcfg.grad_clip_norm or None,
                         skip_nonfinite=jcfg.skip_nonfinite_updates)
    opt_state = tx.init(params)
    model = _Tree(init)
    tcfg = TrainConfig(**cfg_kwargs)
    t_lr, t_lr_bb = _lr_specs(tcfg, steps_per_epoch)
    opt = AdamW(model, lr=t_lr, lr_backbone=t_lr_bb, grad_clip=tcfg.grad_clip_norm or None,
                skip_nonfinite=tcfg.skip_nonfinite_updates)
    named = dict(model.named_parameters())
    trace = []
    for g in grads:
        upd, opt_state = tx.update(_nest({p: jnp.asarray(v) for p, v in g.items()}), opt_state, params)
        params = optax.apply_updates(params, upd)
        for path, v in g.items():
            named[".".join(path)].grad = torch.from_numpy(v.copy())
        out = opt.step()
        trace.append((bool(out["finite"]), bool(out["applied"]), opt.count, opt.notfinite_count))
    ref = {p: np.asarray(_leaf(params, p)) for p in SHAPES}
    ours = {p: named[".".join(p)].detach().numpy() for p in SHAPES}
    return ref, ours, opt, trace


BASE = dict(lr=1e-2, lr_backbone=1e-3, grad_clip_norm=0.1, lr_warmup_steps=4, lr_drop=2)


@pytest.mark.parametrize("bad_steps, skip", [
    ((), 3),                 # warmup and the drop at step 6, nothing skipped
    ((1, 4, 5), 3),          # single and paired bad steps, each skipped
    ((2, 3, 4, 5, 8), 2),    # three in a row with a window of 2: the third applies
    ((0, 1, 2), 0),          # no skipping: a bad step applies at once
])
def test_device_adamw_matches_optax(bad_steps, skip):
    ref, ours, opt, trace = _run(dict(BASE, skip_nonfinite_updates=skip), bad_steps, n_steps=10)
    for p in SHAPES:
        np.testing.assert_allclose(ours[p], ref[p], rtol=0, atol=2e-6, err_msg=str(p))
    assert opt._count.dtype == torch.int64 and opt._count.dim() == 0
    # optax.apply_if_finite's counters, step by step
    notfinite, count = 0, 0
    for i, (finite, applied, c, nf) in enumerate(trace):
        bad = i in bad_steps
        notfinite = notfinite + 1 if bad else 0
        apply = not bad or not skip or notfinite > skip
        count += apply
        assert (finite, applied, c, nf) == (not bad, apply, count, notfinite if skip else 0), i


def test_schedule_on_the_device_equals_jax():
    cfg = dict(lr=3e-4, lr_backbone=1e-5, lr_warmup_steps=5, lr_drop=2, lr_drop_factor=0.1)
    ours, _ = _lr_specs(TrainConfig(**cfg), 4)
    ref, _ = jax_lr_specs(JaxTrainConfig(**cfg), 4)
    counts = np.arange(12)
    got = np.array([float(ours(torch.tensor(c))) for c in counts], np.float32)
    want = np.array([np.float32(ref(jnp.int32(c))) for c in counts], np.float32)
    np.testing.assert_array_equal(got, want)
    assert ours(torch.tensor(3)).dtype == torch.float32


def test_counts_are_read_and_set_through_the_device():
    model = _Tree({("encoder", "w"): np.ones((2,), np.float32)})
    opt = AdamW(model, lr=1e-3, skip_nonfinite=2)
    opt.count, opt.notfinite_count = 5, 1
    assert (opt.count, opt.notfinite_count) == (5, 1)
    assert int(opt._count) == 5 and int(opt._notfinite) == 1
    assert opt.m["encoder.w"].data_ptr() == opt._m["main"].data_ptr()  # a view into the group's buffer

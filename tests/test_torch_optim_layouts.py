"""The port's AdamW under every optimizer layout, both moment dtypes and
gradient accumulation, against the JAX package's ``build_optimizer``
(``fused`` per-leaf / "grouped" / flat, ``moment_dtype``, ``optax.MultiSteps``
around ``apply_if_finite(chain(clip, adamw))``).

Both sides get the same parameters and the same mini-step gradients (numpy,
seeded), with the global-norm clip, ``skip_nonfinite`` and an ``lr_drop``
boundary that the schedule counts in applied updates (so with k = 3 it falls
three times later in mini-steps); one case has a NaN mini-step, which
poisons the accumulator (optax's ``(1 - emit) * acc``), so every later update
is rejected until ``skip_nonfinite`` is exceeded, and then the parameters
turn NaN, on a mini-step that does not emit (``emit * update`` = 0 * NaN),
as in optax; the flat layout's frozen leaves turn NaN with them (its lr 0
times a NaN update). Tolerances: parameters within 1e-6 (float32 Adam arithmetic,
a reduction order apart); bfloat16 moments bit-equal; float32 moments
within 1e-6 of their largest value.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from object_detection_destr_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from object_detection_destr_tpu.train import optim as jax_optim  # noqa: E402
from object_detection_destr_tpu.train.state import _lr_specs as jax_lr_specs  # noqa: E402
from object_detection_destr_tpu_torch.config import TrainConfig  # noqa: E402
from object_detection_destr_tpu_torch.train.optim import AdamW  # noqa: E402
from object_detection_destr_tpu_torch.train.state import _lr_specs  # noqa: E402

from test_torch_optim import Tree, _get, _nest  # noqa: E402

# (path, shape): stem conv, FrozenBN and layer1 tensors (frozen), a layer2
# conv (backbone), main leaves, two of one shape (one stacked group)
LEAVES = {
    ("backbone", "conv1", "weight"): (4, 3),
    ("backbone", "bn1", "running_var"): (4,),
    ("backbone", "layer1_0", "conv1", "weight"): (3, 3),
    ("backbone", "layer2_0", "conv1", "weight"): (5, 2),
    ("backbone", "layer2_0", "downsample_bn", "bias"): (5,),
    ("decoder", "block0", "weight"): (6, 4),
    ("decoder", "block1", "weight"): (6, 4),
    ("encoder", "fc", "bias"): (6,),
    ("cls_embed", "weight"): (2, 3),
}
STEPS = 10
STEPS_PER_EPOCH = 2  # the lr_drop boundary: 1 epoch = 2 applied updates


def _grads(seed, nan_at=None):
    rng = np.random.default_rng(seed)
    out = []
    for step in range(STEPS):
        g = {p: (rng.normal(size=s) * 3.0).astype(np.float32) for p, s in LEAVES.items()}
        if step == nan_at:
            g[("backbone", "bn1", "running_var")][0] = np.nan  # a frozen leaf's gradient
        out.append(g)
    return out


def _jax_moments(state, params, layout, bb_frozen):
    """{path: (mu, nu)} of the JAX optimizer state, whatever its layout."""
    paths = [tuple(k.key for k in p) for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    found = {}

    def leaf_paths(tree):
        return [tuple(k.key for k in p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]

    def visit(node):
        if isinstance(node, (optax.ScaleByAdamState, jax_optim.ScaleByAdamCompactState)):
            for path, mu, nu in zip(leaf_paths(node.mu), jax.tree.leaves(node.mu), jax.tree.leaves(node.nu)):
                found[path] = (np.asarray(mu), np.asarray(nu))
        elif isinstance(node, jax_optim.GroupedAdamWState):
            labels = jax.tree.leaves(jax_optim.param_labels(params))
            by_key = {}
            for i, (leaf, lab) in enumerate(zip(jax.tree.leaves(params), labels)):
                if lab == "frozen" or (lab == "backbone" and bb_frozen):
                    continue
                by_key.setdefault((lab, tuple(leaf.shape), jnp.dtype(leaf.dtype).name), []).append(i)
            for gi, key in enumerate(sorted(by_key)):
                for j, i in enumerate(by_key[key]):
                    found[paths[i]] = (np.asarray(node.m[gi][j]), np.asarray(node.v[gi][j]))
        elif isinstance(node, jax_optim.FusedAdamWState):
            offset = 0
            for path, leaf in zip(paths, jax.tree.leaves(params)):
                n = leaf.size
                found[path] = (np.asarray(node.m[offset:offset + n]).reshape(leaf.shape),
                               np.asarray(node.v[offset:offset + n]).reshape(leaf.shape))
                offset += n
        elif isinstance(node, (tuple, list)):
            for child in node:
                visit(child)
        elif isinstance(node, dict):
            for child in node.values():
                visit(child)

    visit(state)
    return found


def _run(cfg_kwargs, grads_seq, layout, moment_dtype, k):
    rng = np.random.default_rng(0)
    init = {p: rng.normal(size=s).astype(np.float32) for p, s in LEAVES.items()}
    jcfg = JaxTrainConfig(**cfg_kwargs)
    lr, lr_bb = jax_lr_specs(jcfg, STEPS_PER_EPOCH)
    params = _nest({p: jnp.asarray(v) for p, v in init.items()})
    tx = jax_optim.build_optimizer(
        params, lr=lr, lr_backbone=lr_bb, grad_clip=jcfg.grad_clip_norm or None,
        skip_nonfinite=jcfg.skip_nonfinite_updates, grad_accum_steps=k,
        fused={"per-leaf": False, "grouped": "grouped", "flat": True}[layout],
        moment_dtype=None if moment_dtype == "float32" else moment_dtype,
    )
    opt_state = tx.init(params)
    update = jax.jit(tx.update)

    model = Tree(init)
    tcfg = TrainConfig(**cfg_kwargs)
    t_lr, t_lr_bb = _lr_specs(tcfg, STEPS_PER_EPOCH)
    opt = AdamW(model, lr=t_lr, lr_backbone=t_lr_bb, grad_clip=tcfg.grad_clip_norm or None,
                skip_nonfinite=tcfg.skip_nonfinite_updates, layout=layout,
                moment_dtype={"float32": torch.float32, "bfloat16": torch.bfloat16}[moment_dtype],
                accum_steps=k)
    named = dict(model.named_parameters())
    history = []  # the port's parameters after each mini-step
    for grads in grads_seq:
        upd, opt_state = update(_nest({p: jnp.asarray(g) for p, g in grads.items()}), opt_state, params)
        params = optax.apply_updates(params, upd)
        for path, g in grads.items():
            named[".".join(path)].grad = torch.from_numpy(g.copy())
        opt.step()
        history.append({p: named[".".join(p)].detach().clone() for p in LEAVES})
    ref = {p: np.asarray(_get(params, p)) for p in LEAVES}
    moments = _jax_moments(opt_state, params, layout, bb_frozen=not cfg_kwargs.get("lr_backbone", 1e-4) > 0)
    return ref, opt, moments, history


CASES = {
    "clip_drop": (dict(lr=1e-2, lr_backbone=1e-3, grad_clip_norm=0.5, skip_nonfinite_updates=2, lr_drop=1,
                       lr_drop_factor=0.1), _grads(1)),
    "nan_ministep": (dict(lr=1e-2, lr_backbone=0.0, grad_clip_norm=0.5, skip_nonfinite_updates=2),
                     _grads(2, nan_at=3)),
}


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["per-leaf", "grouped", "flat"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_layouts_match_build_optimizer(case, layout, moment_dtype, k):
    cfg, grads = CASES[case]
    if layout == "flat" and case == "clip_drop":  # a schedule: the flat layout refuses it on both sides
        jcfg = JaxTrainConfig(**cfg)
        lr, lr_bb = jax_lr_specs(jcfg, STEPS_PER_EPOCH)
        params = _nest({p: jnp.zeros(s) for p, s in LEAVES.items()})
        with pytest.raises(ValueError, match="schedule"):
            jax_optim.build_optimizer(params, lr=lr, lr_backbone=lr_bb, fused=True)
        t_lr, t_lr_bb = _lr_specs(TrainConfig(**cfg), STEPS_PER_EPOCH)
        with pytest.raises(ValueError, match="schedule"):
            AdamW(Tree({p: np.zeros(s, np.float32) for p, s in LEAVES.items()}), lr=t_lr, lr_backbone=t_lr_bb,
                  layout="flat")
        return
    ref, opt, moments, history = _run(cfg, grads, layout, moment_dtype, k)
    named = dict(opt.params)
    for p in LEAVES:
        np.testing.assert_allclose(named[".".join(p)].detach().numpy(), ref[p], rtol=0, atol=1e-6, err_msg=str(p))
    # the state: which leaves carry moments, their dtype, and their values
    expected_dtype = torch.float32 if layout == "flat" else getattr(torch, moment_dtype)
    assert {tuple(n.split(".")) for n in opt.m} == set(moments)
    for name, m in opt.m.items():
        assert m.dtype == expected_dtype
        mu, nu = moments[tuple(name.split("."))]
        for ours, theirs in ((m, mu), (opt.v[name], nu)):
            if expected_dtype == torch.bfloat16:
                assert theirs.dtype == jnp.bfloat16
                np.testing.assert_array_equal(ours.view(torch.int16).numpy(), theirs.view(np.int16), err_msg=name)
            else:
                scale = max(float(np.abs(theirs).max()), 1e-30)
                np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-6 * scale, err_msg=name)
    # accumulation: the parameters move on the k-th mini-step only
    for i in range(STEPS - 1):
        step = i + 2  # the 1-based mini-step between history[i] and history[i + 1]
        moved = any(not torch.equal(history[i][p], history[i + 1][p]) for p in LEAVES)
        rejected = case == "nan_ministep" and (step == 4 if k == 1 else step > 4)
        # k = 3: at mini-step 10 the third non-finite mean exceeds
        # skip_nonfinite = 2, the update is applied, and MultiSteps' emit * update
        # is 0 * NaN: the parameters turn NaN without an emitting mini-step
        gave_up = case == "nan_ministep" and k == 3 and step == 10
        assert moved == ((step % k == 0 and not rejected) or gave_up), step
    if case == "nan_ministep":
        # k = 1: the NaN step alone is rejected; k = 3: the poisoned mean
        # rejects the updates at mini-steps 6 and 9 (optax, the same way)
        assert (opt.count, opt.notfinite_count) == ((9, 0) if k == 1 else (1, 2))
        if k == 3:
            assert np.isnan(opt.accumulated.numpy()).any()

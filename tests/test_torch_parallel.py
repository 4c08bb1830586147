"""Data parallelism of the port (``parallel/mesh.py`` and the steps, loaders
and epoch runner over a mesh), held against the JAX package's ``shard_map``
steps and against the port's own single process.

Ranks are threads of this process, each with a ``ProcessGroupGloo`` on a
shared ``HashStore``: no process is spawned. Every thread is joined with a
timeout and a rank that fails fails the test (a rank left waiting in a
collective gives up after the group's timeout).

Tolerances, and why:
  * against JAX's 2-device steps (DESTR: hidden 32, 1+1 blocks, top_k 4,
    64 px, B=4, dropout 0, the matcher on the fused kernel's path on both
    sides; SSD300: B=2): JAX's own, from ``tests/test_parallel.py::
    test_shard_map_step_matches_single_device`` — metrics rtol 2e-4 / atol
    2e-5, the updated ``cls_embed`` / ``bbox_embed`` rtol 2e-3 / atol 2e-5,
    ``mini_detector.cls_conv.bn0``'s running mean rtol 2e-4 / atol 2e-5
    (SSD: every extra block's BatchNorm statistics); Adam's first moment
    (0.1 x the all-reduced gradient after a first step with no clip, so
    its scale and sign are the gradient's) within 2e-3 of its 2-norm over
    every trained leaf (SSD's extra blocks 1e-2, and DESTR's held against
    JAX's single-device step: see the tests);
  * two ranks against one process of the port: the same tolerances (the
    global batch's sums are taken in another order, over the ranks), the
    gradient read through the accumulator after a mini-step and through
    Adam's first moment after an update;
  * across ranks: bit for bit (the gradients are all-reduced, so every
    rank applies the same update to the same parameters);
  * the epoch runner against the per-step loop on the CPU: bit for bit (it
    runs the same body uncaptured).
"""

import copy
import datetime
import logging
import threading
import uuid

import numpy as np
import pytest
import torch
import torch.distributed as dist

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from object_detection_destr_tpu.config import DestrConfig as JaxDestrConfig  # noqa: E402
from object_detection_destr_tpu.config import SSDConfig as JaxSSDConfig  # noqa: E402
from object_detection_destr_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from object_detection_destr_tpu.models.destr.model import build_destr as jax_build_destr  # noqa: E402
from object_detection_destr_tpu.models.ssd.model import build_ssd as jax_build_ssd  # noqa: E402
from object_detection_destr_tpu.parallel import mesh as jax_mesh  # noqa: E402
from object_detection_destr_tpu.train.state import create_destr_state as jax_create_state  # noqa: E402
from object_detection_destr_tpu.train.state import create_ssd_state as jax_create_ssd_state  # noqa: E402
from object_detection_destr_tpu.train.steps import make_destr_train_step as jax_make_step  # noqa: E402
from object_detection_destr_tpu.train.steps import make_ssd_train_step as jax_make_ssd_step  # noqa: E402
from object_detection_destr_tpu_torch.config import DestrConfig, SSDConfig, TrainConfig  # noqa: E402
from object_detection_destr_tpu_torch.data.transforms import destr_train_transform  # noqa: E402
from object_detection_destr_tpu_torch.models.convert import (  # noqa: E402
    flax_variables_from_state_dict,
    load_flax_variables,
    state_dict_from_flax,
)
from object_detection_destr_tpu_torch.models.destr.mini_detector import sync_batch_norms  # noqa: E402
from object_detection_destr_tpu_torch.models.destr.model import build_destr  # noqa: E402
from object_detection_destr_tpu_torch.models.ssd.model import build_ssd  # noqa: E402
from object_detection_destr_tpu_torch.parallel import mesh as port_mesh  # noqa: E402
from object_detection_destr_tpu_torch.parallel.mesh import Mesh, fold_seed, group_from_store, shard_batch  # noqa: E402
from object_detection_destr_tpu_torch.train.epoch_scan import EpochRunner  # noqa: E402
from object_detection_destr_tpu_torch.train.state import create_destr_state, create_ssd_state  # noqa: E402
from object_detection_destr_tpu_torch.train.steps import (  # noqa: E402
    make_destr_step_core,
    make_destr_train_step,
    make_ssd_train_step,
)

from test_torch_train_step import _mu_tree  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401

TINY = dict(hidden_dim=32, num_heads=4, num_encoder_blocks=1, num_decoder_blocks=1, top_k=4, ffn_dim=64,
            dropout=0.0)
SIZE, B, T = 64, 4, 4
JOIN_S = 300  # a rank thread's join timeout: above the groups' own


def _run_ranks(fn, n: int = 2):
    """``fn(mesh)`` on n thread-ranks of one gloo group; their results."""
    store = dist.PrefixStore(uuid.uuid4().hex, dist.HashStore())
    results, errors = [None] * n, [None] * n

    def target(r):
        try:
            group = group_from_store(store, r, n, "gloo", timeout=datetime.timedelta(seconds=120))
            results[r] = fn(Mesh(group, r, n, "cpu", "gloo"))
        except BaseException as e:  # noqa: BLE001 — handed to the test thread, which raises it
            errors[r] = e

    threads = [threading.Thread(target=target, args=(r,), daemon=True) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads), "a rank did not finish"
    for e in errors:
        if e is not None:
            raise e
    return results


def _batch(rng, b=B, t=T, size=SIZE):
    """tests/test_parallel.py::_tiny_destr_batch."""
    return {
        "images": rng.normal(size=(b, size, size, 3)).astype(np.float32),
        "boxes": np.stack([rng.uniform(0.1, 0.4, size=(b, t)), rng.uniform(0.1, 0.4, size=(b, t)),
                           rng.uniform(0.5, 0.9, size=(b, t)), rng.uniform(0.5, 0.9, size=(b, t))],
                          -1).astype(np.float32),
        "labels": np.zeros((b, t), np.int32),
        "valid": np.ones((b, t), bool),
    }


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _destr_ranks(model, cfg, batches, mesh):
    """One rank's run (one process's with ``mesh`` None): a copy of
    ``model`` synced over ``mesh``, a step per global batch on the rank's
    rows; (metrics per step, the model, the state, the gradient
    accumulator after each step, None without accumulation)."""
    ours = copy.deepcopy(model) if mesh is None else sync_batch_norms(copy.deepcopy(model), "data", mesh)
    state = create_destr_state(ours, cfg)
    step = make_destr_train_step(cfg, mesh)
    metrics, acc = [], []
    for b in batches:
        metrics.append({k: float(v) for k, v in step(state, b if mesh is None else shard_batch(b, mesh)).items()})
        acc.append(None if state.optimizer.accumulated is None else state.optimizer.accumulated.clone())
    return metrics, ours, state, acc


def _close(ours, ref, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=rtol, atol=atol, err_msg=what)


def _norm_close(ours, ref, rtol, what):
    """``ours`` within ``rtol`` of ``ref``'s 2-norm, each a tensor or a dict
    of tensors (over ``ref``'s keys, which ``ours`` must all have)."""
    if isinstance(ref, dict):
        assert set(ref) <= set(ours), (what, sorted(set(ref) - set(ours))[:5])
        ours, ref = (torch.cat([t[k].float().reshape(-1) for k in ref]) for t in (ours, ref))
    err, norm = float((ours.float() - ref.float()).norm()), float(ref.float().norm())
    assert norm > 0 and err <= rtol * norm, (what, err / max(norm, 1e-30))


def _moments(state):
    return {k: v.clone() for k, v in state.optimizer.m.items()}


def _heads_and_bn(variables):
    p, s = variables["params"], variables["batch_stats"]
    return ([np.asarray(x) for x in jax.tree.leaves({k: p[k] for k in ("cls_embed", "bbox_embed")})],
            np.asarray(s["mini_detector"]["cls_conv"]["bn0"]["mean"]))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two ranks share the cores of one test worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pallas_matcher():
    """The JAX steps match through the fused kernel's path, as the port does."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OBJDET_FORCE_PALLAS_MATCHER", "1")
    yield
    mp.undo()


def _jax_two_devices(step, state, batch):
    """One JAX step over ``make_mesh(num_data=2)``: (metrics, the updated
    variables, Adam's first moment in the port's names)."""
    mesh = jax_mesh.make_mesh(num_data=2)
    state, metrics = step(mesh)(jax.device_put(state, jax_mesh.replicated_sharding(mesh)),
                                jax_mesh.shard_batch(batch, mesh))
    state = jax.device_get(state)
    return ({k: float(v) for k, v in jax.device_get(metrics).items()},
            {"params": state.params, "batch_stats": state.batch_stats},
            state_dict_from_flax({"params": _mu_tree(state.opt_state)}))


JAX_TRAIN = dict(batch_size=B, image_size=SIZE, lr=1e-3, lr_backbone=1e-3)


@pytest.fixture(scope="module")
def jax_two_device_step(pallas_matcher):
    """One step of JAX's ``make_destr_train_step(..., mesh=make_mesh(num_data=2))``
    with ``bn_axis_name="data"``: (the initial variables, the global batch,
    its metrics, the updated heads and ``bn0``'s running mean), and Adam's
    first moment after one step of JAX's single-device step on the same
    weights and batch."""
    jcfg = JaxTrainConfig(**JAX_TRAIN)
    jmodel = jax_build_destr(JaxDestrConfig(**TINY, bn_axis_name="data"))
    state, tx = jax_create_state(jmodel, jcfg, image_size=SIZE)
    variables = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    batch = _batch(np.random.default_rng(5))
    one, _ = jax_make_step(jax_build_destr(JaxDestrConfig(**TINY)), tx, jcfg)(jax.tree.map(jnp.copy, state),
                                                                               jax.tree.map(jnp.asarray, batch))
    mu = state_dict_from_flax({"params": _mu_tree(jax.device_get(one.opt_state))})
    ref, updated, _ = _jax_two_devices(lambda mesh: jax_make_step(jmodel, tx, jcfg, mesh=mesh), state, batch)
    return (variables, batch, ref, *_heads_and_bn(updated), mu)


@pytest.mark.parametrize("opt_layout", ["per-leaf", "grouped", "flat"])
def test_destr_two_ranks_match_jax_shard_map(jax_two_device_step, opt_layout):
    """Two thread-ranks of the port, in each optimizer layout, against JAX's
    2-device ``shard_map`` step on the same weights and global batch. JAX's
    step runs its default layout: its layouts lay the update out in memory
    differently and compute the same arithmetic (``train/optim.py``), so
    one compiled JAX step is every layout's reference.

    The gradient is held against JAX's single-device step: in JAX's
    2-device step the criterion's psummed terms (bbox, ciou) reach each
    device's gradient N times, since a psum's transpose sums every
    device's cotangent, before the gradients are psummed (a leaf's first
    moment is 1.15 to 3.65 times the single device's, median 2.000001).
    Adam's first update hides that (the heads agree); the port does not
    copy it."""
    variables, batch, ref, ref_heads, ref_bn, ref_mu = jax_two_device_step
    model = load_flax_variables(build_destr(DestrConfig(**TINY), "cpu"), variables)
    train = TrainConfig(**JAX_TRAIN, opt_layout=opt_layout)
    runs = _run_ranks(lambda m: _destr_ranks(model, train, [batch], m))
    for metrics, ours, state, _ in runs:
        for k, v in ref.items():
            _close(metrics[0][k], v, 2e-4, 2e-5, k)
        _norm_close(_moments(state), ref_mu, 2e-3, "Adam's first moment")
        heads, bn = _heads_and_bn(flax_variables_from_state_dict(ours))
        for a, b in zip(heads, ref_heads):
            _close(a, b, 2e-3, 2e-5, "heads")
        _close(bn, ref_bn, 2e-4, 2e-5, "bn0 mean")


def _state_arrays(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _assert_ranks_identical(runs):
    first = _state_arrays(runs[0][1])
    for _, model, *_ in runs[1:]:
        for k, v in _state_arrays(model).items():
            assert torch.equal(v, first[k]), k


def _bn_stats(model):
    return {k: v for k, v in _state_arrays(model).items() if k.endswith(("running_mean", "running_var"))}


def _assert_near_one_process(runs, one):
    """Two ranks' metrics, gradient accumulators, Adam's first moment and
    BatchNorm statistics against one process's."""
    one_metrics, one_model, one_state, one_acc = one
    ref_m, ref_bn = _moments(one_state), _bn_stats(one_model)
    for metrics, model, state, acc in runs:
        for got, want in zip(metrics, one_metrics):
            for k in want:
                _close(got[k], want[k], 2e-4, 2e-5, k)
        for i, (got, want) in enumerate(zip(acc, one_acc)):
            if want is not None and want.any():  # zero after an update
                _norm_close(got, want, 2e-3, f"the accumulated gradient after mini-step {i}")
        _norm_close(_moments(state), ref_m, 2e-3, "Adam's first moment")
        for k, v in _bn_stats(model).items():
            _close(v, ref_bn[k], 2e-4, 2e-5, k)


def test_destr_two_ranks_with_accumulation_match_one_process():
    """``grad_accum_steps=2``: each mini-step's gradient is already the
    global batch's, so two ranks accumulate and update as one process does
    (the accumulator after the first mini-step, the moment after the
    update)."""
    cfg = TrainConfig(batch_size=B, image_size=SIZE, lr=1e-3, lr_backbone=1e-3, grad_accum_steps=2)
    torch.manual_seed(0)
    model = build_destr(DestrConfig(**TINY), "cpu")
    rng = np.random.default_rng(11)
    batches = [_tensors(_batch(rng)) for _ in range(2)]
    runs = _run_ranks(lambda m: _destr_ranks(model, cfg, batches, m))
    one = _destr_ranks(model, cfg, batches, None)
    assert one[0][0]["loss"] != one[0][1]["loss"] and one[3][0].any() and not one[3][1].any()
    _assert_near_one_process(runs, one)
    _assert_ranks_identical(runs)


SSD_TRAIN = dict(batch_size=2, lr=1e-3, lr_backbone=1e-3)


@pytest.fixture(scope="module")
def ssd_runs():
    """SSD300 at B=2 (one image a rank) from JAX's initial variables: JAX's
    2-device step (metrics, updated variables, Adam's first moment), the
    port's two thread-ranks and its one process."""
    jcfg, jssd = JaxTrainConfig(**SSD_TRAIN), JaxSSDConfig(num_cls=3, bn_axis_name="data")
    jmodel = jax_build_ssd(jssd)
    state, tx = jax_create_ssd_state(jmodel, jcfg, image_size=300)
    variables = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    b = _batch(np.random.default_rng(13), b=2, t=3, size=300)
    xy, wh = b["boxes"][..., :2], b["boxes"][..., 2:] - b["boxes"][..., :2]
    b["boxes"] = np.concatenate([xy + wh / 2, wh[..., ::-1]], -1).astype(np.float32)  # cxcyhw
    jax_ref = _jax_two_devices(lambda mesh: jax_make_ssd_step(jmodel, tx, jcfg, jssd, mesh=mesh), state, b)

    cfg, ssd_cfg = TrainConfig(**SSD_TRAIN), SSDConfig(num_cls=3)
    model = load_flax_variables(build_ssd(ssd_cfg, "cpu"), variables)

    def run(mesh):
        ours = copy.deepcopy(model) if mesh is None else sync_batch_norms(copy.deepcopy(model), "data", mesh)
        state = create_ssd_state(ours, cfg)
        step = make_ssd_train_step(cfg, ssd_cfg, mesh)
        x = _tensors(b)
        return [{k: float(v) for k, v in step(state, x if mesh is None else shard_batch(x, mesh)).items()}], \
            ours, state, [None]

    return jax_ref, _run_ranks(run), run(None)


def test_ssd_two_ranks_match_one_process(ssd_runs):
    """SSD300 at B=2 (one image a rank): gradients and metrics averaged over
    the ranks, the extra blocks' BatchNorms synced."""
    _, runs, one = ssd_runs
    _assert_near_one_process(runs, one)
    _assert_ranks_identical(runs)


def test_ssd_two_ranks_match_jax_shard_map(ssd_runs):
    """The port's two SSD ranks against JAX's 2-device ``shard_map`` SSD
    step (``tests/test_parallel_ssd.py``'s step at 2 devices) on the same
    weights and global batch: the pmeaned metrics, Adam's first moment (the
    pmeaned gradient) and the extra blocks' synced BatchNorm statistics.
    The extra blocks' moment is held at ``tests/test_torch_ssd_train.py``'s
    1e-2 of its norm: their gradient passes the batch-statistics BatchNorm
    backward, whose nearly cancelling sums put the port's single device
    5e-3 to 8e-3 of a leaf's norm from JAX's at this seed."""
    (ref, updated, ref_mu), runs, _ = ssd_runs
    ref_bn = {k: v for k, v in state_dict_from_flax({"batch_stats": updated["batch_stats"]}).items()}
    for metrics, model, state, _ in runs:
        for k, v in ref.items():
            _close(metrics[0][k], v, 2e-4, 2e-5, k)
        ours = _moments(state)
        for part, rtol in (("heads", 2e-3), ("extra blocks", 1e-2)):
            names = [k for k in ref_mu if k.startswith("extra") == (part == "extra blocks")]
            _norm_close(ours, {k: ref_mu[k] for k in names}, rtol, f"Adam's first moment, {part}")
        bn = _bn_stats(model)
        assert set(ref_bn) == set(bn)
        for k, v in ref_bn.items():
            _close(bn[k], v, 2e-4, 2e-5, k)


def test_ranks_stay_identical_with_dropout():
    """Two steps at dropout 0.3: the ranks draw distinct dropout masks (the
    rank folds into the seed) and still hold bit-identical parameters and
    BatchNorm statistics."""
    cfg = TrainConfig(batch_size=B, image_size=SIZE, lr=1e-3, lr_backbone=1e-3)
    torch.manual_seed(1)
    model = build_destr(DestrConfig(**{**TINY, "dropout": 0.3}), "cpu")
    rng = np.random.default_rng(17)
    batches = [_tensors(_batch(rng)) for _ in range(2)]

    runs = _run_ranks(lambda m: _destr_ranks(model, cfg, batches, m))
    assert runs[0][2].rng.generator.initial_seed() != runs[1][2].rng.generator.initial_seed()
    _assert_ranks_identical(runs)
    for metrics, *_ in runs:
        assert metrics == runs[0][0]
        assert all(np.isfinite(v) for m in metrics for v in m.values())


def test_epoch_runner_two_ranks_match_step_loop():
    """``EpochRunner`` over a mesh on the CPU (the body uncaptured) against
    the per-step loop of the same ranks: each replays its columns of the
    global index rows, with the rank folded into the dropout and the
    augmentation seeds."""
    cfg = TrainConfig(batch_size=B, image_size=SIZE, lr=1e-3, lr_backbone=1e-3)
    torch.manual_seed(2)
    model = build_destr(DestrConfig(**{**TINY, "dropout": 0.1}), "cpu")
    rng = np.random.default_rng(19)
    data = {k: torch.from_numpy(v) for k, v in _batch(rng, b=6, size=80).items()}
    data["images"] = (data["images"].abs() * 60).clamp(0, 255).to(torch.uint8)
    idx = np.array([[0, 5, 2, 3], [4, 1, 3, 0]], dtype=np.int64)
    aug_seed = lambda step: 1_000 + step
    transform = lambda raw, gen: destr_train_transform(raw["images"], raw["boxes"], raw["labels"], raw["valid"],
                                                       gen, out_size=SIZE)

    def run(mesh):
        scanned = sync_batch_norms(copy.deepcopy(model), "data", mesh)
        state = create_destr_state(scanned, cfg)
        runner = EpochRunner(state, make_destr_step_core(cfg, mesh), transform, data, aug_seed, 2, mesh=mesh)
        fetched = runner.run(idx, 0)

        looped = sync_batch_norms(copy.deepcopy(model), "data", mesh)
        lstate = create_destr_state(looped, cfg)
        core, gen = make_destr_step_core(cfg, mesh), torch.Generator()
        metrics = []
        for step, row in enumerate(idx):
            lstate.rng.begin_step(step, mesh.rank)
            gen.manual_seed(fold_seed(aug_seed(step), mesh.rank))
            raw = {k: v[torch.from_numpy(row[mesh.rows(B)])] for k, v in data.items()}
            metrics.append(core(lstate, transform(raw, gen)))
        return fetched, scanned, metrics, looped

    for fetched, scanned, metrics, looped in _run_ranks(run):
        for k, v in fetched.items():
            assert np.array_equal(v, np.array([float(m[k]) for m in metrics])), k
        for (name, a), b in zip(scanned.state_dict().items(), looped.state_dict().values()):
            assert torch.equal(a, b), name


def test_synced_mini_detector_reduces_once_a_layer(monkeypatch):
    """Over a mesh the mini-detector's three BatchNorm stacks run layer by
    layer with one pmean a layer for all three: 4 all-reduces in the forward
    and 4 in the backward, one chain that every rank's backward walks in the
    same order. Over a 1-rank mesh the outputs and gradients are the
    unsynced model's, bit for bit."""
    torch.manual_seed(3)
    plain = build_destr(DestrConfig(**TINY), "cpu")
    group = group_from_store(dist.PrefixStore(uuid.uuid4().hex, dist.HashStore()), 0, 1, "gloo")
    mesh = Mesh(group, 0, 1, "cpu", "gloo")
    synced = sync_batch_norms(copy.deepcopy(plain), "data", mesh)
    calls = []
    reduce = Mesh.all_reduce_
    monkeypatch.setattr(Mesh, "all_reduce_", lambda self, t: calls.append(tuple(t.shape)) or reduce(self, t))
    images = torch.from_numpy(_batch(np.random.default_rng(23))["images"])
    grads = []
    for model in (plain, synced):
        calls.clear()
        model_out, det_out = model(images, train=True)
        loss = sum(v.float().sum() for out in (model_out, det_out) for v in out.values())
        forward_calls = len(calls)
        loss.backward()
        grads.append(({k: v.detach() for k, v in det_out.items()},
                      {n: p.grad for n, p in model.named_parameters() if p.grad is not None}))
        if model is synced:
            assert forward_calls == 4 and calls == [(3, 2, TINY["hidden_dim"])] * 8, calls
    (out_a, grad_a), (out_b, grad_b) = grads
    for k in out_a:
        assert torch.equal(out_a[k], out_b[k]), k
    assert set(grad_a) == set(grad_b)
    for n in grad_a:
        assert torch.equal(grad_a[n], grad_b[n]), n


def test_auto_mesh_warns_and_make_mesh_refuses(monkeypatch, caplog):
    """``auto_mesh(12)`` on a world of 8 takes the 6 first ranks with JAX's
    warning (on JAX's 8 CPU devices, the same text); the 2 others get an
    inactive mesh. ``make_mesh`` refuses an axis above the world with JAX's
    error."""
    with caplog.at_level(logging.WARNING):
        assert jax_mesh.auto_mesh(12).shape["data"] == 6
    want = [r.getMessage() for r in caplog.records if "auto_mesh" in r.getMessage()]
    with pytest.raises(ValueError) as jax_err:
        jax_mesh.make_mesh(num_data=9)

    world = object()
    monkeypatch.setattr(dist, "new_group", lambda ranks, timeout: ("sub", tuple(ranks), timeout))
    meshes = []
    for rank in range(8):
        monkeypatch.setattr(port_mesh, "_world", lambda rank=rank: (world, rank, 8, "gloo"))
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            meshes.append(port_mesh.auto_mesh(12, device="cpu"))
        assert [r.getMessage() for r in caplog.records if "auto_mesh" in r.getMessage()] == want
    assert [(m.size, m.rank, m.active) for m in meshes[:6]] == [(6, r, True) for r in range(6)]
    assert meshes[0].group == ("sub", tuple(range(6)), port_mesh.CPU_TIMEOUT)
    assert not meshes[6].active and not meshes[7].active
    with pytest.raises(ValueError) as ours:
        port_mesh.make_mesh(num_data=9, device="cpu")
    assert str(ours.value) == str(jax_err.value)


@pytest.mark.parametrize("num_data,num_model,world", [(2, 2, 4), (1, 2, 2), (2, 2, 5)])
def test_make_mesh_lays_ranks_on_jax_grid(monkeypatch, num_data, num_model, world):
    """``make_mesh(num_data, num_model)`` puts global rank r where JAX's
    reshape of the devices puts device r: data index r // num_model, model
    index r % num_model. Every rank creates the num_model column groups in
    one order, its mesh carries its column's group, its rows of a batch are
    JAX's shard on its device, and only (0, 0) is main; ranks past the grid
    are inactive. A grid above the world raises JAX's error."""
    devices = jax.devices()[:world]
    jmesh = jax_mesh.make_mesh(num_data=num_data, num_model=num_model, devices=devices)
    where = {dev.id: tuple(int(i) for i in np.argwhere(jmesh.devices == dev)[0]) for dev in jmesh.devices.flat}
    batch = {"x": np.arange(16, dtype=np.float32).reshape(8, 2)}
    shards = {s.device.id: np.asarray(s.data) for s in jax_mesh.shard_batch(batch, jmesh)["x"].addressable_shards}
    columns = [tuple(d * num_model + m for d in range(num_data)) for m in range(num_model)]
    created, w = [], object()
    monkeypatch.setattr(dist, "new_group", lambda ranks, timeout: created.append(tuple(ranks)) or ("column", tuple(ranks)))
    for rank in range(world):
        created.clear()
        monkeypatch.setattr(port_mesh, "_world", lambda rank=rank: (w, rank, world, "gloo"))
        mesh = port_mesh.make_mesh(num_data, num_model, device="cpu")
        assert created == columns
        if rank >= num_data * num_model:
            assert not mesh.active and not mesh.is_main
            continue
        assert (mesh.rank, mesh.model_index) == where[devices[rank].id] and mesh.size == num_data
        assert mesh.group == ("column", columns[rank % num_model])
        assert mesh.is_main == (rank == 0)
        np.testing.assert_array_equal(shard_batch(batch, mesh)["x"].numpy(), shards[devices[rank].id])
    with pytest.raises(ValueError) as jax_err:
        jax_mesh.make_mesh(num_data=num_data + 1, num_model=num_model, devices=devices)
    with pytest.raises(ValueError) as ours:
        port_mesh.make_mesh(num_data + 1, num_model, device="cpu")
    assert str(ours.value) == str(jax_err.value)


def test_shard_batch_gives_each_rank_its_rows():
    """Rank r of 4 holds rows [r B/4, (r+1) B/4): JAX's shard on device r."""
    batch = {"x": np.arange(32, dtype=np.float32).reshape(8, 4), "v": np.arange(8) % 3 == 0}
    sharded = jax_mesh.shard_batch(batch, jax_mesh.make_mesh(num_data=4))
    shards = {k: {s.device.id: np.asarray(s.data) for s in v.addressable_shards} for k, v in sharded.items()}
    devices = [d.id for d in jax.devices()[:4]]
    for r in range(4):
        ours = shard_batch(batch, Mesh(object(), r, 4, "cpu"))
        for k in batch:
            np.testing.assert_array_equal(ours[k].numpy(), shards[k][devices[r]])
    with pytest.raises(ValueError):
        Mesh(object(), 0, 3, "cpu").rows(8)

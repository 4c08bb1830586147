"""The port's auction matchers against the JAX package's, the way
tests/test_assignment.py runs them: same random problems, rows compared.

* the fused cost + auction (the plain version of CUDA kernel #9,
  ops/cuda/auction.py::hungarian_match_fused_reference) against
  ``hungarian_match_pallas`` in interpret mode;
* the auction on a precomputed cost (the plain version of kernel #8,
  ``solve_auction`` on ``precomputed_value``) against
  ``auction_assignment_pallas`` in interpret mode, and the port's
  ``ops.batched_assignment`` / ``ops.auction_assignment`` against the JAX
  package's functions of the same names; then the entry points that reach
  it: ``hungarian_match(cost_bbox=2.5)`` and ``set_criterion(rows=None,
  cost_bbox=2.5)``.

Rows must be equal. Both sides build the cost in float32 but from different
libraries (XLA and PyTorch), so a near-tie can resolve the other way; a test
whose rows differ says so and instead requires both assignments to be
duplicate-free and within the auction's bound, T * eps, of the optimal total
cost from ``scipy.optimize.linear_sum_assignment``.
"""

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from object_detection_destr_tpu.losses.criterion import set_criterion as jax_set_criterion  # noqa: E402
from object_detection_destr_tpu.losses.matcher import hungarian_cost_matrix as jax_cost  # noqa: E402
from object_detection_destr_tpu.losses.matcher import hungarian_match as jax_hungarian_match  # noqa: E402
from object_detection_destr_tpu.ops import auction_assignment as jax_auction_assignment  # noqa: E402
from object_detection_destr_tpu.ops import batched_assignment as jax_batched_assignment  # noqa: E402
from object_detection_destr_tpu.ops.pallas.auction import (  # noqa: E402
    auction_assignment_pallas,
    hungarian_match_pallas,
)
from object_detection_destr_tpu_torch.losses.criterion import set_criterion  # noqa: E402
from object_detection_destr_tpu_torch.losses.matcher import hungarian_cost_matrix, hungarian_match  # noqa: E402
from object_detection_destr_tpu_torch.ops import auction_assignment, batched_assignment  # noqa: E402
from object_detection_destr_tpu_torch.ops.cuda.auction import (  # noqa: E402
    auction_kernel,
    fused_auction,
    hungarian_match_fused,
    hungarian_match_fused_reference,
)

EPS_FRAC = 0.001


def _problem(b, n, t, c, seed, valid_frac=0.8):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, n, c)).astype(np.float32)
    pb = np.stack(
        [rng.uniform(0.2, 0.8, (b, n)), rng.uniform(0.2, 0.8, (b, n)),
         rng.uniform(0.05, 0.4, (b, n)), rng.uniform(0.05, 0.4, (b, n))], -1
    ).astype(np.float32)
    raw = rng.uniform(0, 1, (b, t, 4)).astype(np.float32)
    tb = np.stack(
        [np.minimum(raw[..., 0], raw[..., 2]), np.minimum(raw[..., 1], raw[..., 3]),
         np.maximum(raw[..., 0], raw[..., 2]), np.maximum(raw[..., 1], raw[..., 3])], -1,
    )
    lab = rng.integers(0, c, (b, t)).astype(np.int32)
    valid = rng.uniform(size=(b, t)) < valid_frac
    return logits, pb, tb, lab, valid


def _check(ours, ref, cost, valid, row_valid, label):
    """Equal rows; else a stated near-tie within the eps bound of scipy."""
    b, n, t = cost.shape
    for i in range(b):
        assert len(set(ours[i].tolist())) == t, f"{label}: duplicate rows in problem {i}"
    if np.array_equal(ours, ref):
        return
    print(f"{label}: rows differ at {(ours != ref).sum()} targets (near-tie); checking the total cost")
    for i in range(b):
        v = valid[i]
        real = np.where(row_valid[i])[0]
        c = cost[i][real][:, v]
        r, col = linear_sum_assignment(c)
        best = c[r, col].sum()
        real_cost = np.where(row_valid[i][:, None], cost[i], 0.0)
        rng_ = real_cost[row_valid[i]][:, v]
        value_range = max(rng_.max() - min(rng_.min(), 0.0 if (~v).any() else rng_.min()), 1e-6)
        bound = v.sum() * EPS_FRAC * value_range + 1e-4
        for rows in (ours[i], ref[i]):
            assert np.isin(rows[v], real).all()
            assert cost[i][rows[v], np.where(v)[0]].sum() <= best + bound, label


@pytest.mark.parametrize("n,t,c,seed", [(25, 8, 2, 0), (400, 32, 2, 1), (60, 10, 5, 2)])
def test_fused_matcher_matches_pallas(n, t, c, seed):
    """The cases of tests/test_assignment.py:135, with invalid columns."""
    logits, pb, tb, lab, valid = _problem(3, n, t, c, seed)
    ref = np.asarray(hungarian_match_pallas(*map(jnp.asarray, (logits, pb, tb, lab, valid))))
    ours = hungarian_match_fused(*map(torch.from_numpy, (logits, pb, tb, lab, valid))).numpy()
    cost = np.asarray(jax_cost({"pred_class": logits, "pred_boxes": pb},
                               {"boxes": tb, "labels": lab, "valid": valid}))
    _check(ours, ref, cost, valid, np.ones(logits.shape[:2], bool), f"n={n} t={t}")


@pytest.mark.parametrize("seed", [3, 4])
def test_row_valid_stacking_matches_pallas(seed):
    """Two problem kinds in one call, as the train step stacks them: the
    first half of the batch has only 14 real rows of 20 (the model's top-k
    padded to the mini-detector's token count), every problem has invalid
    columns, and one has none valid at all."""
    logits, pb, tb, lab, valid = _problem(4, 20, 9, 2, seed, valid_frac=0.6)
    valid[3] = False
    row_valid = np.ones((4, 20), bool)
    row_valid[:2, 14:] = False
    args = (logits, pb, tb, lab, valid)
    ref = np.asarray(hungarian_match_pallas(*map(jnp.asarray, args), row_valid=jnp.asarray(row_valid)))
    ours, rounds = hungarian_match_fused_reference(*map(torch.from_numpy, args),
                                                   row_valid=torch.from_numpy(row_valid))
    cost = np.asarray(jax_cost({"pred_class": logits, "pred_boxes": pb},
                               {"boxes": tb, "labels": lab, "valid": valid}))
    _check(ours.numpy(), ref, cost, valid, row_valid, f"stacked seed={seed}")
    assert (ours[:2][torch.from_numpy(valid[:2])] < 14).all()  # padded rows never win
    assert rounds[3] == 0 and (rounds[:3] > 0).all()


def test_cost_matrix_matches_jax():
    logits, pb, tb, lab, valid = _problem(2, 30, 7, 3, 5)
    outs = {"pred_class": logits, "pred_boxes": pb}
    tgts = {"boxes": tb, "labels": lab, "valid": valid}
    for cost_bbox in (0.0, 2.5):
        ref = np.asarray(jax_cost(outs, tgts, 1.0, cost_bbox, 1.0))
        ours = hungarian_cost_matrix({k: torch.from_numpy(v) for k, v in outs.items()},
                                     {k: torch.from_numpy(v) for k, v in tgts.items()}, 1.0, cost_bbox, 1.0)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_precomputed_cost_auction_matches_pallas():
    """ops/assignment.py::batched_assignment, the function of kernel #8."""
    rng = np.random.default_rng(6)
    cost = (rng.normal(size=(3, 37, 5)) * 2).astype(np.float32)
    valid = np.ones((3, 5), bool)
    valid[1, 2] = False
    ref = np.asarray(auction_assignment_pallas(jnp.asarray(cost), jnp.asarray(valid)))
    ours = batched_assignment(torch.from_numpy(cost), torch.from_numpy(valid)).numpy()
    _check(ours, ref, cost, valid, np.ones((3, 37), bool), "precomputed cost")


@pytest.mark.parametrize("seed", [7, 8])
def test_assignment_names_match_jax(seed):
    """``batched_assignment`` solves a (B, N, M) batch and
    ``auction_assignment`` one (N, M) problem, in the port as in the JAX
    package: the same costs give the same rows (both sides negate the same
    float32 costs and run the same auction, so no near-tie can differ)."""
    rng = np.random.default_rng(seed)
    cost = rng.uniform(-2, 2, (3, 40, 12)).astype(np.float32)
    valid = rng.uniform(size=(3, 12)) < 0.75
    ref = np.asarray(jax_batched_assignment(jnp.asarray(cost), jnp.asarray(valid)))
    ours = batched_assignment(torch.from_numpy(cost), torch.from_numpy(valid))
    assert ours.shape == (3, 12) and ours.dtype == torch.int64
    np.testing.assert_array_equal(ours.numpy(), ref)
    for i in range(3):
        ref1 = np.asarray(jax_auction_assignment(jnp.asarray(cost[i]), jnp.asarray(valid[i])))
        ours1 = auction_assignment(torch.from_numpy(cost[i]), torch.from_numpy(valid[i]))
        assert ours1.shape == (12,)
        np.testing.assert_array_equal(ours1.numpy(), ref1)


def _outputs_targets(seed, b=3, n=30, t=9, c=3):
    logits, pb, tb, lab, valid = _problem(b, n, t, c, seed, valid_frac=0.7)
    valid[-1] = False  # an image with no targets
    outs = {"pred_class": logits, "pred_boxes": pb}
    tgts = {"boxes": tb, "labels": lab, "valid": valid}
    return outs, tgts


@pytest.mark.parametrize("seed", [9, 10])
def test_hungarian_match_with_l1_cost_matches_jax(seed):
    """``hungarian_match(cost_bbox=2.5)`` goes through the cost matrix and
    #8's function on both sides (the JAX package's CPU path is
    ``batched_assignment``). The costs come from XLA and from PyTorch, so a
    near-tie may resolve the other way: rows equal, or both within the
    auction's bound of scipy's optimum (``_check``)."""
    outs, tgts = _outputs_targets(seed)
    ref = np.asarray(jax_hungarian_match({k: jnp.asarray(v) for k, v in outs.items()},
                                         {k: jnp.asarray(v) for k, v in tgts.items()}, cost_bbox=2.5))
    ours = hungarian_match({k: torch.from_numpy(v) for k, v in outs.items()},
                           {k: torch.from_numpy(v) for k, v in tgts.items()}, cost_bbox=2.5).numpy()
    cost = np.asarray(jax_cost(outs, tgts, 1.0, 2.5, 1.0))
    _check(ours, ref, cost, tgts["valid"], np.ones(outs["pred_class"].shape[:2], bool), f"l1 seed={seed}")


def test_set_criterion_matches_jax_through_the_l1_matcher():
    """``set_criterion(rows=None, cost_bbox=2.5)``: the criterion matches by
    itself through #8's function. Losses within 1e-5 of JAX's, the tolerance
    of tests/test_torch_criterion.py."""
    outs, tgts = _outputs_targets(11)
    ref = jax_set_criterion({k: jnp.asarray(v) for k, v in outs.items()},
                            {k: jnp.asarray(v) for k, v in tgts.items()}, cost_bbox=2.5, class_norm="boxes")
    ours = set_criterion({k: torch.from_numpy(v) for k, v in outs.items()},
                         {k: torch.from_numpy(v) for k, v in tgts.items()}, cost_bbox=2.5, class_norm="boxes")
    for k in ("class", "bbox", "ciou"):
        r = float(ref[k])
        assert abs(float(ours[k]) - r) <= 1e-5 * max(abs(r), 1e-3), (k, float(ours[k]), r)


def test_kernel_wrapper_takes_cuda_tensors_only():
    logits, pb, tb, lab, valid = (torch.from_numpy(a) for a in _problem(1, 10, 4, 2, 0))
    before = fused_auction.launches
    with pytest.raises(ValueError, match="CUDA"):
        fused_auction(logits, pb, tb, lab, valid)
    assert fused_auction.launches == before


def test_precomputed_kernel_wrapper_takes_cuda_tensors_only():
    valid = torch.ones(1, 4, dtype=torch.bool)
    before = auction_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        auction_kernel(torch.zeros(1, 4, 10), valid, torch.ones(1, 10, dtype=torch.bool))
    assert auction_kernel.launches == before


def _stacked_problem(seed, b=4, n=40, t=24, c=3, valid_frac=0.45, real=(30, 40, 26, 40)):
    """Valid and invalid columns interleaved at random, and problems whose
    last rows are not real, as the train step stacks the model's top-k
    queries with the mini-detector's tokens."""
    logits, pb, tb, lab, valid = _problem(b, n, t, c, seed, valid_frac=valid_frac)
    row_valid = np.arange(n)[None, :] < np.array(real)[:, None]
    return (logits, pb, tb, lab, valid), row_valid


@pytest.mark.parametrize("max_iters", [1, 2, 4])
def test_capped_fused_auction_matches_pallas(max_iters):
    """With the rounds capped at 1, 2 or 4, valid columns are left without a
    row and the greedy completion places them in column order among the
    invalid ones. The plain #9 (and its public entry) equal
    ``hungarian_match_pallas`` in interpret mode row for row, and the cap
    bites: some problem stops at it while its uncapped auction runs on."""
    args, row_valid = _stacked_problem(12 + max_iters)
    ref = np.asarray(hungarian_match_pallas(*map(jnp.asarray, args), max_iters=max_iters,
                                            row_valid=jnp.asarray(row_valid)))
    targs = tuple(map(torch.from_numpy, args))
    ours, rounds = hungarian_match_fused_reference(*targs, row_valid=torch.from_numpy(row_valid),
                                                   max_iters=max_iters)
    np.testing.assert_array_equal(ours.numpy(), ref)
    public = hungarian_match_fused(*targs, row_valid=torch.from_numpy(row_valid), max_iters=max_iters)
    np.testing.assert_array_equal(public.numpy(), ref)
    _, full_rounds = hungarian_match_fused_reference(*targs, row_valid=torch.from_numpy(row_valid))
    assert ((rounds == max_iters) & (full_rounds > max_iters)).any()
    valid = args[-1]
    for i in range(len(ref)):
        assert len(set(ref[i].tolist())) == ref.shape[1]
        assert row_valid[i][ref[i][valid[i]]].all()  # a valid target never takes a row that is not real


@pytest.mark.parametrize("max_iters", [1, 2, 4])
def test_capped_precomputed_auction_matches_pallas(max_iters):
    """#8's plain version (``batched_assignment`` on the CPU) against
    ``auction_assignment_pallas`` in interpret mode with the rounds capped,
    on invalid columns interleaved with valid ones: the same float32 costs
    on both sides, so the rows are equal."""
    rng = np.random.default_rng(20 + max_iters)
    cost = rng.uniform(-2, 2, (4, 36, 20)).astype(np.float32)
    valid = rng.uniform(size=(4, 20)) < 0.5
    ref = np.asarray(auction_assignment_pallas(jnp.asarray(cost), jnp.asarray(valid), max_iters=max_iters))
    ours = batched_assignment(torch.from_numpy(cost), torch.from_numpy(valid), max_iters=max_iters).numpy()
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("seed", [30, 31])
def test_invalid_columns_take_the_lowest_free_real_rows(seed):
    """When every valid column holds a row after the rounds, the invalid
    columns, in column order, take the free real rows from the lowest up,
    and row 0 once none is left (the argmax of fill over -1e9 everywhere);
    here the second and fourth problems have fewer real rows than columns,
    so their last invalid columns get row 0. The plain #9 equals
    ``hungarian_match_pallas`` in interpret mode on the same problems."""
    args, row_valid = _stacked_problem(seed, b=4, n=20, t=16, valid_frac=0.35, real=(20, 12, 17, 14))
    targs = tuple(map(torch.from_numpy, args))
    ours, rounds = hungarian_match_fused_reference(*targs, row_valid=torch.from_numpy(row_valid))
    ours = ours.numpy()
    ref = np.asarray(hungarian_match_pallas(*map(jnp.asarray, args), row_valid=jnp.asarray(row_valid)))
    np.testing.assert_array_equal(ours, ref)
    assert (rounds < 256).all()
    valid = args[-1]
    exhausted = 0
    for i in range(len(ours)):
        taken = set(ours[i][valid[i]].tolist())
        free_real = [r for r in range(row_valid.shape[1]) if row_valid[i, r] and r not in taken]
        want = [free_real[m] if m < len(free_real) else 0 for m in range((~valid[i]).sum())]
        assert ours[i][~valid[i]].tolist() == want
        exhausted += (~valid[i]).sum() > len(free_real)
    assert exhausted >= 1

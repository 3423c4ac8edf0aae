"""Port ``ops/metrics.py`` against the JAX package and the reference oracle.

Same numpy inputs through ``eval_users`` / ``mean_metrics`` /
``topk_recommendations`` of both packages.  Position counts and hits are
integers and must be bit-equal (so must hr, prec and rec, one f32 division
each); auc and ndcg within rtol 1e-6 (the f32 log of two libraries); the
means within rtol 1e-6 (f32 sums in another order).  Against
``tests/reference_oracle.py`` the golden tolerances, rtol 2e-3, atol 2e-4.
Tie data: scores quantized to a few levels, so ties are everywhere, which
the reference's stable heapq order resolves (earlier eval items win ties)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.data.interactions import multi_hot as jmulti_hot
from fashionvisualexpl_tpu.ops import metrics as J
from fashionvisualexpl_tpu_torch.data.interactions import multi_hot, pad_lists
from fashionvisualexpl_tpu_torch.ops import metrics as P
from tests.reference_oracle import mean_eval_oracle

GOLDEN = dict(rtol=2e-3, atol=2e-4)


def _case(seed, U=30, I=50, ties=False, max_eval=3):
    rng = np.random.default_rng(seed)
    training, evals = [], []
    for _ in range(U):
        items = rng.choice(I, size=12, replace=False)
        n_eval = int(rng.integers(0, max_eval + 1))  # empty eval lists too
        evals.append(items[:n_eval].tolist())
        training.append(items[n_eval:].tolist())
    scores = rng.normal(size=(U, I)).astype(np.float32)
    if ties:
        scores = np.round(scores * 2) / 2  # ~9 levels: ties everywhere
    return scores, training, evals


def _both(scores, training, evals, k):
    I = scores.shape[1]
    items, counts = pad_lists(evals, pad_value=0)
    mask = multi_hot(training, I)
    assert np.array_equal(mask, jmulti_hot(training, I))
    jm = J.eval_users(jnp.asarray(scores), jnp.asarray(mask), jnp.asarray(items),
                      jnp.asarray(counts), k)
    pm = P.eval_users(torch.from_numpy(scores), torch.from_numpy(mask),
                      torch.from_numpy(items), torch.from_numpy(counts), k)
    return jm, pm


@pytest.mark.parametrize("ties", [False, True], ids=["gaussian", "ties"])
@pytest.mark.parametrize("seed,k", [(0, 5), (1, 10), (2, 1)])
def test_eval_users_matches_jax_and_oracle(seed, k, ties):
    scores, training, evals = _case(seed, ties=ties)
    jm, pm = _both(scores, training, evals, k)
    for f in ("hr", "prec", "rec", "valid"):
        np.testing.assert_array_equal(getattr(pm, f).numpy(), np.asarray(getattr(jm, f)),
                                      err_msg=f)
    for f in ("auc", "ndcg"):
        np.testing.assert_allclose(getattr(pm, f).numpy(), np.asarray(getattr(jm, f)),
                                   rtol=1e-6, atol=0, err_msg=f)
    jmean, pmean = J.mean_metrics(jm), P.mean_metrics(pm)
    assert int(pmean.num_users) == int(jmean.num_users) == sum(1 for e in evals if e)
    got = np.array([float(getattr(pmean, f)) for f in ("hr", "prec", "rec", "auc", "ndcg")])
    want = np.array([float(getattr(jmean, f)) for f in ("hr", "prec", "rec", "auc", "ndcg")])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, mean_eval_oracle(scores, training, evals, k), **GOLDEN)


def test_eval_users_position_counts_bit_equal():
    """AUC carries the position count exactly: 1 - position / denom with
    integer position and denom, so equal aucs on tie data mean equal
    counts; checked against the count taken straight from the scores."""
    scores, training, evals = _case(5, ties=True, max_eval=1)
    items, counts = pad_lists(evals, pad_value=0)
    pm = P.eval_users(torch.from_numpy(scores), torch.from_numpy(multi_hot(training, 50)),
                      torch.from_numpy(items), torch.from_numpy(counts), 5)
    for u, (tr, ev) in enumerate(zip(training, evals)):
        if not ev:
            continue
        neg = np.setdiff1d(np.arange(50), np.concatenate([tr, ev]))
        position = int((scores[u, neg] >= scores[u, ev[0]]).sum())
        assert float(pm.auc[u]) == np.float32(1.0) - np.float32(position) / np.float32(len(neg))


@pytest.mark.parametrize("k", [1, 7])
def test_topk_recommendations_matches_jax(k):
    rng = np.random.default_rng(k)
    scores = rng.normal(size=(20, 40)).astype(np.float32)  # tie-free
    mask = rng.random((20, 40)) < 0.3
    jidx, jval = J.topk_recommendations(jnp.asarray(scores), jnp.asarray(mask), k)
    pidx, pval = P.topk_recommendations(torch.from_numpy(scores), torch.from_numpy(mask), k)
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(pval.numpy(), np.asarray(jval))
    # tie data: the ranked values agree (ids may order ties differently)
    tied = np.round(scores)
    _, jval = J.topk_recommendations(jnp.asarray(tied), jnp.asarray(mask), k)
    pidx, pval = P.topk_recommendations(torch.from_numpy(tied), torch.from_numpy(mask), k)
    np.testing.assert_array_equal(pval.numpy(), np.asarray(jval))
    assert not mask[np.arange(20)[:, None], pidx.numpy()].any()

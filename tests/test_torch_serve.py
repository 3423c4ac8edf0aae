"""Port RecServer vs the JAX RecServer (Pallas stage 1 in interpret mode)
and the numpy oracle, mirroring tests/test_serve.py's single-device cases.

Ids must be equal on tie-free data; values match at rtol 1e-5, atol 1e-6
(the fp32 rescore sums in another order than JAX's).  On tie-storm data the
ranked values must be equal and each id must carry its true score."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.data.interactions import synthetic_interactions as j_synth
from fashionvisualexpl_tpu.models.bprmf import BPRMF as JBPRMF
from fashionvisualexpl_tpu.serve import RecServer as JRecServer
from fashionvisualexpl_tpu.serve import quantize_rows as j_quantize_rows
from fashionvisualexpl_tpu_torch.data.interactions import synthetic_interactions
from fashionvisualexpl_tpu_torch.models.bprmf import BPRMF
from fashionvisualexpl_tpu_torch.models.convert import bprmf_from_jax
from fashionvisualexpl_tpu_torch.ops import segmax as S
from fashionvisualexpl_tpu_torch.serve import RecServer, quantize_rows

RTOL, ATOL = 1e-5, 1e-6


class Case:
    """One dataset + weights, held by both packages."""

    def __init__(self, U=60, I=90, K=8, seed=0, per_user=6, bias=True):
        self.jdata = j_synth(U, I, interactions_per_user=per_user, seed=seed)
        self.data = synthetic_interactions(U, I, interactions_per_user=per_user, seed=seed)
        self.jmodel = JBPRMF(U, I, embed_k=K)
        params, self.frozen = self.jmodel.init(jax.random.PRNGKey(seed))
        if bias:  # JAX init leaves Bi at zero; exercise the bias path
            rng = np.random.default_rng(seed + 100)
            params["Bi"] = jnp.asarray(rng.normal(size=I).astype(np.float32) * 0.1)
        self.params = params
        self.np_params = {k: np.asarray(v) for k, v in params.items()}
        self.model = bprmf_from_jax(self.np_params, device="cpu")
        self.users = np.arange(U, dtype=np.int32)

    def port(self, **kw):
        srv = RecServer(self.model, self.data, device="cpu", **kw)
        srv.refresh()
        return srv

    def jax(self, **kw):
        srv = JRecServer(self.jmodel, self.jdata, segmax_kernel="interpret", **kw)
        srv.refresh(self.params, self.frozen)
        return srv

    def oracle(self, k):
        p = self.np_params
        scores = p["Gu"] @ p["Gi"].T + p["Bi"][None, :]
        for u, row in enumerate(self.data.training_list):
            scores[u, list(row)] = -np.inf
        ids = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        return ids, np.take_along_axis(scores, ids, axis=1)


def _check_against_jax_and_oracle(case, k, **kw):
    ids, vals = case.port(k=k, **kw).query(case.users)
    assert ids.dtype == np.int32 and vals.dtype == np.float32
    assert ids.shape == vals.shape == (case.users.size, k)
    o_ids, o_vals = case.oracle(k)
    np.testing.assert_array_equal(ids, o_ids)
    np.testing.assert_allclose(vals, o_vals, rtol=RTOL, atol=ATOL)
    j_ids, j_vals = case.jax(k=k, **kw).query(case.users)
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_allclose(vals, j_vals, rtol=RTOL, atol=ATOL)
    return ids, vals


def test_exact_query_matches_jax_and_oracle():
    _check_against_jax_and_oracle(Case(), k=5, item_block=32)


def test_fp32_stage1_exact_mode_matches_jax_and_oracle():
    """fp32 stage 1 makes the candidates exact: the served ranking is the
    true fp32 top-k even at oversample=1."""
    _check_against_jax_and_oracle(
        Case(U=40, I=300, K=16, seed=7), k=5, item_block=64, oversample=1,
        stage1_dtype="fp32",
    )


def test_whole_slice_synthetic_to_query():
    """synthetic data -> JAX BPRMF.init -> bprmf_from_jax -> refresh ->
    query every user; the bf16 stage 1 goes through segmax_scores."""
    case = Case(U=48, I=200, K=16, seed=21)
    S.segmax_scores.launches = 0
    _check_against_jax_and_oracle(case, k=10, seg=8, item_block=64)
    assert S.segmax_scores.launches == 0  # CPU: the plain version


def test_train_items_never_served():
    case = Case(seed=3)
    ids, _ = case.port(k=7).query(np.arange(case.data.num_users))
    for u, row in enumerate(case.data.training_list):
        assert not set(ids[u]) & set(row)


def test_quantized_query_matches_exact_and_jax():
    case = Case(U=50, I=200, K=16, seed=1)
    e_ids, e_vals = case.port(k=5, item_block=64).query(case.users)
    q_ids, q_vals = case.port(k=5, item_block=64, quantized=True,
                              oversample=4).query(case.users)
    np.testing.assert_array_equal(q_ids, e_ids)
    np.testing.assert_allclose(q_vals, e_vals, rtol=RTOL, atol=ATOL)
    j_ids, _ = case.jax(k=5, item_block=64, quantized=True,
                        oversample=4).query(case.users)
    np.testing.assert_array_equal(q_ids, j_ids)


def test_quantize_rows_bit_equal_to_jax_and_error_bounded():
    x = np.random.default_rng(0).normal(size=(32, 16)).astype(np.float32)
    x[3] = 0.0  # an all-zero row takes the 1e-30 scale floor
    q, s = quantize_rows(torch.from_numpy(x))
    jq, js = j_quantize_rows(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    err = np.abs(q.numpy().astype(np.float32) * s.numpy()[:, None] - x)
    # max error is half a quantization step per row (+ fp32 slack)
    assert (err <= s.numpy()[:, None] * 0.51).all()


def test_batch_bucketing_and_chunking():
    case = Case(seed=2)
    srv = case.port(k=4, max_batch=16)
    all_ids, all_vals = srv.query(np.arange(case.data.num_users))
    some = np.asarray([3, 17, 41], np.int32)
    ids, vals = srv.query(some)
    np.testing.assert_array_equal(ids, all_ids[some])
    np.testing.assert_allclose(vals, all_vals[some], rtol=1e-6)
    one = srv.query_user(9)
    assert [i for i, _ in one] == list(all_ids[9])
    empty_ids, empty_vals = srv.query(np.zeros((0,), np.int32))
    assert empty_ids.shape == (0, 4) and empty_vals.shape == (0, 4)
    j_ids, _ = case.jax(k=4, max_batch=16).query(np.arange(case.data.num_users))
    np.testing.assert_array_equal(all_ids, j_ids)


@pytest.mark.parametrize(
    "bad",
    [np.asarray([2**32], np.int64),  # wraps to 0 under an int32 cast
     [-1], [0, 60], np.asarray([60], np.uint64)],
)
def test_query_rejects_out_of_range_ids(bad):
    srv = Case(seed=6).port(k=3)
    with pytest.raises(ValueError, match="out of range"):
        srv.query(bad)


def test_query_before_refresh_and_non_factored_model_raise():
    case = Case()
    with pytest.raises(RuntimeError, match="refresh"):
        RecServer(case.model, case.data, k=3, device="cpu").query([0])
    with pytest.raises(NotImplementedError, match="factored"):
        RecServer(torch.nn.Linear(2, 2), case.data, k=3, device="cpu")


def test_segment_pruning_regime_matches_jax_and_oracle():
    """k_seg << segments: the candidate horizon actually prunes."""
    case = Case(U=16, I=4096, K=8, seed=9)
    kw = dict(seg=8, item_block=512, oversample=2)
    assert case.port(k=3, **kw)._k_seg < 4096 // 8
    ids, _ = _check_against_jax_and_oracle(case, k=3, **kw)
    q_ids, _ = case.port(k=3, quantized=True, **kw).query(case.users)
    np.testing.assert_array_equal(q_ids, ids)


def test_hierarchical_segment_selection_matches_jax_and_oracle():
    """S >= 4096 engages the two-level (super-segment) selection path."""
    case = Case(U=8, I=40960, K=8, seed=11)
    kw = dict(seg=8, superseg=8, item_block=8192, oversample=2)
    assert case.port(k=5, **kw)._padded_items // 8 >= 4096
    _check_against_jax_and_oracle(case, k=5, **kw)


def test_history_override_matches_default():
    case = Case(seed=4)
    P = 9
    padded = np.zeros((case.data.num_users, P), np.int32)
    counts = np.zeros(case.data.num_users, np.int32)
    for u, row in enumerate(case.data.training_list):
        padded[u, : len(row)] = row
        counts[u] = len(row)
    a_ids, a_vals = case.port(k=6).query(case.users)
    b_ids, b_vals = case.port(k=6, history=(padded, counts)).query(case.users)
    np.testing.assert_array_equal(a_ids, b_ids)
    np.testing.assert_array_equal(a_vals, b_vals)


@pytest.mark.parametrize("trial", range(6))
def test_serve_fuzz_ties_and_geometries(trial):
    """Randomized geometries with heavily tied scores: ranked SCORES must
    match the oracle exactly (ids are tie-ambiguous), every served id must
    be a real non-train item carrying its true score, no duplicates."""
    rng = np.random.default_rng(100 + trial)
    U = int(rng.integers(5, 40))
    I = int(rng.integers(30, 300))
    K = int(rng.choice([4, 8, 16]))
    k = int(rng.integers(1, 8))
    seg = int(rng.choice([4, 8, 32]))
    item_block = int(rng.choice([16, 64, 4096]))
    oversample = int(rng.choice([2, 4]))
    quantized = bool(trial % 2)
    data = synthetic_interactions(U, I, interactions_per_user=int(rng.integers(2, 6)),
                                  seed=trial)
    jm = JBPRMF(U, I, embed_k=K)
    params, _ = jm.init(jax.random.PRNGKey(trial))
    # quantize factors so many items share EXACT scores (tie storm)
    params = {
        name: np.asarray(jnp.round(arr * 2) / 2 if name != "Bi" else jnp.zeros_like(arr))
        for name, arr in params.items()
    }
    srv = RecServer(bprmf_from_jax(params, device="cpu"), data, k=k, seg=seg,
                    item_block=item_block, oversample=oversample,
                    quantized=quantized, device="cpu")
    srv.refresh()
    ids, vals = srv.query(np.arange(U, dtype=np.int32))

    scores = params["Gu"].astype(np.float64) @ params["Gi"].T.astype(np.float64)
    scores += params["Bi"][None, :].astype(np.float64)
    for u in range(U):
        row = scores[u].copy()
        banned = set(data.training_list[u])
        row[list(banned)] = -np.inf
        want = np.sort(row)[::-1][:k]
        np.testing.assert_allclose(vals[u], want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"user {u} ranked scores")
        assert len(set(ids[u].tolist())) == k, u
        for j in range(k):
            assert ids[u][j] not in banned
            np.testing.assert_allclose(vals[u][j], row[ids[u][j]], rtol=RTOL,
                                       atol=ATOL, err_msg=f"user {u} id/score pair")

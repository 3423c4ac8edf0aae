"""Port sampler vs the JAX sampler: fed JAX's own ``split(key)`` draws, the
core ``triplets_from_draws`` must give JAX's ``sample_triplets`` triples
bit for bit, for every scheme, materialised and derived, on uniform and
ragged data, for partial and full epochs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.data import sampler as jsampler
from fashionvisualexpl_tpu_torch.data import sampler as tsampler
from fashionvisualexpl_tpu_torch.data.interactions import (
    pad_sorted_positives,
    synthetic_interactions,
)

NUM_ITEMS = 300


def _uniform_sorted(U=40, P=6, seed=0):
    """Every user has P positives stored ascending: derived mode eligible."""
    rng = np.random.default_rng(seed)
    rows = np.sort(np.stack([rng.choice(NUM_ITEMS, P, replace=False)
                             for _ in range(U)]), axis=1).astype(np.int32)
    pairs = np.stack([np.repeat(np.arange(U, dtype=np.int32), P),
                      rows.reshape(-1)], axis=1)
    return pairs, rows, np.full(U, P, np.int32)


def _uniform_shuffled():
    """Uniform counts, pairs in the (shuffled) stored order: materialised."""
    data = synthetic_interactions(40, NUM_ITEMS, interactions_per_user=8, seed=1)
    return data.train_pairs, data.padded_pos, data.pos_counts


def _ragged(U=40, seed=2):
    """Zipf-like counts, zero-count users included: the ragged path."""
    rng = np.random.default_rng(seed)
    counts = np.minimum(rng.zipf(1.6, U), 15)
    counts[[3, 17, 39]] = 0
    lists = [list(rng.choice(NUM_ITEMS, c, replace=False)) for c in counts]
    pairs = np.array([(u, i) for u, row in enumerate(lists) for i in row], np.int32)
    padded, cnt = pad_sorted_positives(lists, NUM_ITEMS)
    return pairs, padded, cnt


DATA = {"uniform_sorted": _uniform_sorted, "uniform_shuffled": _uniform_shuffled,
        "ragged": _ragged}


def _jax_draws(key, scheme, n, U, take):
    perm_key, neg_key = jax.random.split(key)
    if scheme == "bootstrap":
        order = jax.random.randint(perm_key, (take,), 0, n)
    else:
        order = jax.random.permutation(perm_key, U if scheme == "user_perm" else n)
    return np.array(order), np.array(jax.random.uniform(neg_key, (take,)))


@pytest.mark.parametrize("scheme", ["user_perm", "pair_perm", "bootstrap"])
@pytest.mark.parametrize("data_name,derived", [
    ("uniform_sorted", False), ("uniform_sorted", True),
    ("uniform_shuffled", False), ("ragged", False),
])
def test_core_fed_jax_draws_is_bit_equal(scheme, data_name, derived):
    pairs, padded, counts = DATA[data_name]()
    U, Pw = padded.shape
    n = pairs.shape[0]
    if derived:
        assert tsampler.derived_pairs_ok(pairs, padded)
        assert jsampler.derived_pairs_ok(pairs, padded)
    # a partial epoch (consumed-prefix slice) and the full one
    for steps, batch in ((3, 16), (n // 8, 8)):
        take = steps * batch
        key = jax.random.PRNGKey(steps)
        want = jsampler.sample_triplets(
            key, None if derived else jnp.asarray(pairs), jnp.asarray(padded),
            jnp.asarray(counts), NUM_ITEMS, steps, batch, with_replacement=scheme,
        )
        order, u01 = _jax_draws(key, scheme, n, U, take)
        got = tsampler.triplets_from_draws(
            scheme, torch.from_numpy(order), torch.from_numpy(u01),
            None if derived else torch.from_numpy(pairs),
            torch.from_numpy(padded), torch.from_numpy(counts),
            NUM_ITEMS, steps, batch,
        )
        for name, g, w in zip(("users", "pos", "neg"), got, want):
            assert g.dtype == torch.int32 and g.shape == (steps, batch), name
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("data_name", sorted(DATA))
def test_derived_pairs_ok_matches_jax(data_name):
    pairs, padded, _ = DATA[data_name]()
    assert tsampler.derived_pairs_ok(pairs, padded) == jsampler.derived_pairs_ok(
        pairs, padded)


def test_sample_negatives_fed_jax_draws():
    pairs, padded, counts = _ragged()
    users = np.random.default_rng(5).integers(0, padded.shape[0], 500).astype(np.int32)
    key = jax.random.PRNGKey(5)
    want = jsampler.sample_negatives(key, jnp.asarray(users), jnp.asarray(padded),
                                     jnp.asarray(counts), NUM_ITEMS)
    u01 = np.array(jax.random.uniform(key, (500,)))
    got = tsampler.sample_negatives(torch.from_numpy(u01), torch.from_numpy(users),
                                    torch.from_numpy(padded), torch.from_numpy(counts),
                                    NUM_ITEMS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scheme", ["user_perm", "pair_perm", "bootstrap"])
def test_wrapper_draws_valid_triples(scheme):
    pairs, padded, counts = _ragged()
    tabs = [torch.from_numpy(a) for a in (pairs, padded, counts)]
    out = tsampler.sample_triplets(7, *tabs, NUM_ITEMS, 5, 16,
                                   with_replacement=scheme, device="cpu")
    again = tsampler.sample_triplets(7, *tabs, NUM_ITEMS, 5, 16,
                                     with_replacement=scheme, device="cpu")
    positives = {(int(u), int(i)) for u, i in pairs}
    for a, b in zip(out, again):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    users, pos, neg = (t.reshape(-1).numpy() for t in out)
    assert all((u, p) in positives for u, p in zip(users, pos))
    assert all((u, q) not in positives for u, q in zip(users, neg))
    assert ((neg >= 0) & (neg < NUM_ITEMS)).all()
    with pytest.raises(ValueError, match="unknown sampling scheme"):
        tsampler.sample_triplets(7, *tabs, NUM_ITEMS, 5, 16,
                                 with_replacement="nope", device="cpu")

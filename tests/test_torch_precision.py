"""Port ``core/precision.py`` and the bf16 towers vs the JAX package, on the
CPU: the twins of ``tests/test_precision.py``, each run on the port alone
(its own f32 against its bf16, at the JAX test's tolerances: encodings
3e-2 and scores and CNN outputs 5e-2 of the f32 maximum) and held against
the JAX function on the same inputs and weights (``models/convert.py``).

- ``resolve_compute_dtype`` names the JAX package's two dtypes and refuses
  others;
- float32 is a no-op: the default and an explicit float32 give the same
  bits, and JAX's scores at rtol 1e-5;
- AttentiveFashion's bf16 encodings and scores are f32 tensors tracking
  the f32 ones, and JAX's bf16 ones within one bf16 rounding (4e-3 of the
  maximum; the attention's bf16 matmuls sum in another order);
- packed bf16 training keeps every param and moment f32 and learns, and
  its first epoch's loss from JAX's init and draws is JAX's (rtol 1e-3:
  bf16 roundings of the encoders' sums);
- the bf16 CNN tracks the f32 one and JAX's bf16 CNN (4e-3 of max);
- CompVBPR's bf16 loss is f32, finite, and JAX's with JAX's dropout masks
  (rtol 1e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.core.config import TrainConfig as JTrainConfig
from fashionvisualexpl_tpu.core.precision import resolve_compute_dtype as jresolve
from fashionvisualexpl_tpu.data import sampler as jsampler
from fashionvisualexpl_tpu.data.features import synthetic_features
from fashionvisualexpl_tpu.data.interactions import synthetic_interactions as jsynth
from fashionvisualexpl_tpu.models.attentive_fashion import AttentiveFashion as JAF
from fashionvisualexpl_tpu.models.cnn import CNN as JCNN
from fashionvisualexpl_tpu.models.comp_vbpr import CompVBPR as JCompVBPR
from fashionvisualexpl_tpu.train.trainer import Trainer as JTrainer
from fashionvisualexpl_tpu_torch.core.config import TrainConfig
from fashionvisualexpl_tpu_torch.core.precision import cast_compute, cast_f32, resolve_compute_dtype
from fashionvisualexpl_tpu_torch.data.interactions import synthetic_interactions
from fashionvisualexpl_tpu_torch.models.attentive_fashion import AttentiveFashion
from fashionvisualexpl_tpu_torch.models.cnn import CNN
from fashionvisualexpl_tpu_torch.models.convert import (
    attentive_fashion_from_jax,
    comp_vbpr_from_jax,
    flatten_params,
)
from fashionvisualexpl_tpu_torch.train import packed_generic as tpg
from fashionvisualexpl_tpu_torch.train.trainer import Trainer
from tests.test_torch_comp_vbpr import jax_masks

ONE_BF16 = 4e-3  # one bf16 rounding (2^-8) of the largest value


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _arrays(I=16, img=12, seed=0):
    rng = np.random.default_rng(seed)
    color = synthetic_features(I, 10, seed=seed)
    edges = rng.random((I, img, img, 1)).astype(np.float32)
    cls = np.eye(5, dtype=np.float32)[rng.integers(0, 5, I)]
    return color, edges, cls


def _attentive(compute_dtype, U=12, I=16, key=0, **kw):
    """(JAX model, params, frozen, the port's model on the same weights)."""
    jm = JAF(U, I, *_arrays(I), embed_k=8, attention_layers=(6, 1), encoder_hidden=16,
             item_block=7, compute_dtype=compute_dtype, **kw)
    params, frozen = jm.init(jax.random.PRNGKey(key))
    return jm, params, frozen, attentive_fashion_from_jax(jm, _np(params), _np(frozen), "cpu")


def _close_to_max(got, want, share):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=share * np.abs(want).max())


def test_resolve_compute_dtype_validates():
    assert resolve_compute_dtype("float32") == torch.float32
    assert resolve_compute_dtype("bfloat16") == torch.bfloat16
    assert resolve_compute_dtype(torch.bfloat16) == torch.bfloat16
    for name in ("float32", "bfloat16"):  # the JAX package's names
        assert str(resolve_compute_dtype(name)) == f"torch.{jresolve(name).name}"
    for bad in ("float16", "not-a-dtype", torch.float16):
        with pytest.raises(ValueError, match="compute_dtype must be one of"):
            resolve_compute_dtype(bad)
    x = torch.ones(2)
    assert cast_compute(x, torch.float32) is x and cast_f32(x) is x
    assert cast_compute(x, torch.bfloat16).dtype == torch.bfloat16
    assert cast_f32(x.bfloat16()).dtype == torch.float32


def test_fp32_default_unchanged():
    """compute_dtype='float32' is a no-op: the same bits as a model built
    without the argument, and JAX's scores."""
    jm, params, frozen, explicit = _attentive("float32")
    default = AttentiveFashion(12, 16, *_arrays(16), embed_k=8, attention_layers=(6, 1),
                               encoder_hidden=16, item_block=7, device="cpu")
    default.load_state_dict(explicit.state_dict())
    assert default.compute_dtype == explicit.compute_dtype == torch.float32
    got = explicit.predict_all()
    assert torch.equal(got, default.predict_all())
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.predict_all(params, frozen)),
                               rtol=1e-5, atol=1e-7)


def test_bf16_encoder_tracks_fp32():
    _, params, frozen, m32 = _attentive("float32", key=1)
    j16, _, _, m16 = _attentive("bfloat16", key=1)
    e32 = m32.encode_items().detach()
    e16 = m16.encode_items().detach()
    assert e16.dtype == torch.float32  # towers return f32
    _close_to_max(e16, e32, 3e-2)
    assert not torch.equal(e16, e32)  # the towers did run in bf16
    _close_to_max(e16, j16.encode_items(params, frozen), ONE_BF16)


def test_bf16_scores_track_fp32():
    _, params, frozen, m32 = _attentive("float32", key=2)
    j16, _, _, m16 = _attentive("bfloat16", key=2)
    s32, s16 = m32.predict_all(), m16.predict_all()
    assert s16.dtype == torch.float32
    _close_to_max(s16, s32, 5e-2)
    _close_to_max(s16, j16.predict_all(params, frozen), ONE_BF16)


def test_bf16_training_keeps_fp32_params_and_learns():
    """Four packed epochs under bf16: losses finite and falling, params and
    their moments f32 throughout; the first epoch, fed JAX's sampler draws
    without dropout, is JAX's."""
    jm, params, frozen, model = _attentive("bfloat16", U=20, I=24, dropout_rate=0.0)
    data = synthetic_interactions(20, 24, interactions_per_user=5, seed=3)
    cfg = dict(batch_size=16, epochs=1, lr=0.01, reg=0.0, train_path="packed")
    trainer = Trainer(model, data, TrainConfig(**cfg))
    state, frozen_t = trainer.init_state()
    jtrainer = JTrainer(jm, jsynth(20, 24, interactions_per_user=5, seed=3), JTrainConfig(**cfg))
    key = jax.random.PRNGKey(0)
    sample_key, _ = jax.random.split(key)
    triples = jsampler.sample_triplets(
        sample_key, jtrainer._train_pairs, jtrainer._padded_pos, jtrainer._pos_counts, 24,
        jtrainer.steps_per_epoch, 16, with_replacement=jtrainer.cfg.sampling_scheme)
    losses = []
    state, loss = trainer.run_steps(state, frozen_t, tuple(torch.from_numpy(np.array(t))
                                                           for t in triples), step_key=0)
    losses.append(float(loss))
    jl = _jax_packed_epoch_loss(jm, params, frozen, triples, cfg)
    np.testing.assert_allclose(losses[0], jl, rtol=1e-3)
    for e in range(1, 4):
        state, loss = trainer.run_epoch(state, frozen_t, e)
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    for name, p in state.params.items():
        assert p.dtype == torch.float32, name
    for name, pmv in state.inner.dense.items():
        for x in pmv:
            assert all(t.dtype == torch.float32 for t in tpg._flat_dense(name, x).values()), name
    assert state.inner.user_pmv.dtype == state.inner.item_pmv.dtype == torch.float32


def _jax_packed_epoch_loss(jm, params, frozen, triples, cfg):
    """JAX's packed epoch loss over ``triples`` from ``params``."""
    from fashionvisualexpl_tpu.train import packed_generic as jpg

    jstate = jpg.pack_generic_state(jm, params, moment_dtype="float32")
    step = jax.jit(jpg.make_generic_packed_step(jm, cfg["lr"], cfg["reg"]))
    total = 0.0
    for u, p, n in zip(*triples):
        jstate, loss = step(jstate, (frozen, (u, p, n), None))
        total += float(loss)
    return total


def test_cnn_bf16_tracks_fp32():
    jcnn = JCNN(6, in_channels=1, input_hw=(16, 16), compute_dtype="bfloat16")
    params = jcnn.init(jax.random.PRNGKey(0))
    cnn32 = CNN(6, in_channels=1, input_hw=(16, 16), device="cpu")
    cnn16 = CNN(6, in_channels=1, input_hw=(16, 16), compute_dtype="bfloat16", device="cpu")
    with torch.no_grad():
        for cnn in (cnn32, cnn16):
            for name, p in cnn.named_parameters():
                p.copy_(torch.from_numpy(np.array(params[name])))
    imgs = np.random.default_rng(0).random((4, 16, 16, 1), dtype=np.float32)
    with torch.no_grad():
        y32, y16 = (c.encode(torch.from_numpy(imgs)) for c in (cnn32, cnn16))
    assert y16.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in cnn16.parameters())
    _close_to_max(y16, y32, 5e-2)
    _close_to_max(y16, jcnn.apply(params, jnp.asarray(imgs)), ONE_BF16)


def test_comp_vbpr_bf16_loss_finite():
    I, U = 18, 14
    rng = np.random.default_rng(4)
    feats = (synthetic_features(I, 12, seed=1), synthetic_features(I, 10, seed=2),
             rng.random((I, 16, 16, 1)).astype(np.float32), synthetic_features(I, 8, seed=3))
    jm = JCompVBPR(U, I, *feats, embed_k=8, embed_d=4, compute_dtype="bfloat16")
    params, frozen = jm.init(jax.random.PRNGKey(0))
    model = comp_vbpr_from_jax(flatten_params(_np(params)), *feats, device="cpu",
                               compute_dtype="bfloat16")
    assert model.cnn.compute_dtype == torch.bfloat16
    users, pos, neg = [0, 3, 7], [1, 2, 3], [4, 5, 6]
    key = jax.random.PRNGKey(1)
    jl = jm.loss(params, frozen, *map(jnp.asarray, (users, pos, neg)), 0.01, rng=key)
    loss = model.loss(*map(torch.tensor, (users, pos, neg)), 0.01, rng=jax_masks(key, 3))
    assert loss.dtype == torch.float32 and np.isfinite(float(loss.detach()))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-3)

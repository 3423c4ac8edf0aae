"""Port segment-max stage 1 vs the JAX Pallas kernel (interpret mode).

Tolerance atol = rtol = 1e-5: both sides sum bf16 x bf16 (exact in f32) or
f32 products in f32, in different orders; pad segments are bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionvisualexpl_tpu.ops.segmax import segmax_scores as jax_segmax
from fashionvisualexpl_tpu_torch.ops import segmax as S

B, IP, TILE = 16, 256, 64
N_PAD = 40  # trailing pad items: one whole pad segment for seg <= 32, plus a partial one


def _inputs(D, seed):
    rng = np.random.default_rng(seed)
    uf = rng.normal(size=(B, D)).astype(np.float32) / np.sqrt(D) * 3
    iv = rng.normal(size=(IP, D)).astype(np.float32)
    ib = rng.normal(size=IP).astype(np.float32) * 0.1
    ib[IP - N_PAD:] = -1e30
    return uf, iv, ib


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("seg", [4, 8, 32])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("D", [16, 128, 148, 150, 160, 176, 208, 256])
def test_plain_version_matches_jax_interpret(D, dtype, seg, transposed):
    uf, iv, ib = _inputs(D, seed=seg + D)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    want = np.asarray(jax_segmax(
        jnp.asarray(uf).astype(jdt), jnp.asarray(iv).astype(jdt), jnp.asarray(ib),
        seg, item_tile=TILE, interpret=True, transposed_out=transposed,
    ))
    S.segmax_scores.launches = 0
    got = S.segmax_scores(
        torch.from_numpy(uf).to(tdt), torch.from_numpy(iv).to(tdt),
        torch.from_numpy(ib), seg,
    )
    assert S.segmax_scores.launches == 0  # CPU tensors: plain version, no launch
    assert got.dtype == torch.float32 and got.shape == (B, IP // seg)
    got = got.numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    full_pad = (IP - N_PAD + seg - 1) // seg  # first segment made only of pads
    np.testing.assert_array_equal(got[:, full_pad:], want[:, full_pad:])
    assert (got[:, full_pad:] == np.float32(-1e30)).all()


def test_reference_is_the_definition():
    uf, iv, ib = _inputs(8, seed=1)
    got = S.segmax_scores_reference(
        torch.from_numpy(uf), torch.from_numpy(iv), torch.from_numpy(ib), 8
    ).numpy()
    scores = uf.astype(np.float64) @ iv.T.astype(np.float64) + ib
    np.testing.assert_allclose(got, scores.reshape(B, -1, 8).max(-1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "uf_shape,iv_shape,ib_len,seg,dtypes,match",
    [
        ((4, 8), (64, 8), 64, 5, ("f32", "f32"), "multiple of seg"),
        ((4, 8), (64, 6), 64, 8, ("f32", "f32"), "shape mismatch"),
        ((4, 8), (64, 8), 63, 8, ("f32", "f32"), "shape mismatch"),
        ((4, 8), (64, 8), 64, 8, ("bf16", "f32"), "share dtype"),
        ((4, 8), (64, 8), 64, 8, ("f16", "f16"), "share dtype"),
    ],
)
def test_wrapper_rejects_bad_inputs(uf_shape, iv_shape, ib_len, seg, dtypes, match):
    dt = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
    with pytest.raises(ValueError, match=match):
        S.segmax_scores(
            torch.zeros(uf_shape, dtype=dt[dtypes[0]]),
            torch.zeros(iv_shape, dtype=dt[dtypes[1]]),
            torch.zeros(ib_len), seg,
        )

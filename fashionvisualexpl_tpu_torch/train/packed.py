"""LazyAdam on packed rows (port of the row update of
``fashionvisualexpl_tpu/train/packed.py``).

A packed row holds a parameter row and its Adam moments side by side
([p | m | v]), so one gather reads and one scatter writes all three.  The
update touches the gathered rows only: LazyAdam's catch-up decay b^dt for
the dt steps since the row's last touch, then the standard update, and
optionally the closed-form momentum tail of the skipped steps
(``_momentum_catchup``).  The generic engine (``train/packed_generic.py``)
builds on these two functions.

Not ported: the specialized per-model steps and their states
(``PackedLazyState``, ``make_packed_bprmf_step``, the VBPR and GradFashion
steps, ``PackedTrainState``); the JAX package reaches them only from
``scripts/scaled_bench.py --packed_engine specialized`` and pins them equal
to the generic engine.  They wait in ROADMAP queue 1 (The specialized
packed steps).
"""

from __future__ import annotations

import torch

from fashionvisualexpl_tpu_torch.train.fast import B1, B2, EPS


def ieee_sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 square root rounded once to nearest, as IEEE (and the JAX
    package) define it: taken in float64, then rounded (exact for sqrt).
    PyTorch's vectorized CPU sqrt can be one ulp off."""
    return torch.sqrt(x.double()).to(x.dtype)


def _momentum_catchup(p, m, v, dt, t, lr):
    """Apply the momentum tail dense Adam would have applied over the
    dt - 1 skipped steps, in closed form: skipped step j has m_j = m B1^j
    and v_j = v B2^j, so with the bias corrections taken at the touch step
    the tail is a geometric sum in r = B1 / sqrt(B2):

        p -= lr * m_hat / (sqrt(v_hat) + EPS) * sum_{j=1}^{dt-1} r^j

    All float32, in the JAX package's order of operations."""
    r = B1 / ieee_sqrt(torch.tensor(B2, dtype=torch.float32, device=p.device))
    geom = r * (1.0 - torch.pow(r, torch.clamp(dt - 1.0, min=0.0))) / (1.0 - r)
    m_hat = m / (1.0 - torch.pow(B1, t))
    v_hat = v / (1.0 - torch.pow(B2, t))
    return p - lr * geom * m_hat / (ieee_sqrt(v_hat) + EPS)


def _lazy_rows(rows, g, dt, t, lr, catchup: bool = False):
    """LazyAdam on gathered packed rows: ``rows`` [S, 3K] as p|m|v column
    groups, ``g`` [S, K] the summed gradients of the p columns, ``dt``
    [S, 1] the steps since each row's last touch, ``t`` the float32 step.
    ``catchup=True`` first applies the momentum tail of the skipped steps
    (``_momentum_catchup``).  Returns the new [S, 3K] rows."""
    K = g.shape[1]
    p, m, v = rows[:, :K], rows[:, K:2 * K], rows[:, 2 * K:3 * K]
    if catchup:
        p = _momentum_catchup(p, m, v, dt, t, lr)
    m = m * torch.pow(B1, dt) + (1.0 - B1) * g
    v = v * torch.pow(B2, dt) + (1.0 - B2) * torch.square(g)
    m_hat = m / (1.0 - torch.pow(B1, t))
    v_hat = v / (1.0 - torch.pow(B2, t))
    p = p - lr * m_hat / (ieee_sqrt(v_hat) + EPS)
    return torch.cat([p, m, v], dim=1)

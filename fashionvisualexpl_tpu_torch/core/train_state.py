"""Train state and TF-parity Adam (port of
``fashionvisualexpl_tpu/core/train_state.py``).

The JAX package threads an immutable ``TrainState(step, params, opt_state)``
through a jitted step and uses optax's Adam.  Here the params are the
model's own ``nn.Parameter``s, updated in place; the state carries them by
name beside the step count and the Adam moments.

Adam is written out in optax's order of operations (optax.adam ->
scale_by_adam, scale_by_learning_rate, apply_updates): both moments as
(1-b)*g**k + b*moment, an int32 count incremented first, bias correction
as moment / (1 - b**count) in float32, update = mu_hat / (sqrt(nu_hat) +
eps), scaled by -lr and added to the params.  ``torch.optim.Adam`` puts eps
on the other side of the bias correction, so it is not used.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

Params = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    """optax's ScaleByAdamState: ``count`` is a 0-d int32 tensor."""

    count: torch.Tensor
    mu: Params
    nu: Params


class TrainState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    params: Params
    opt_state: AdamState


class Adam:
    """optax.adam(learning_rate, b1, b2, eps) as an ``init`` / ``update``
    pair over dicts of tensors."""

    def __init__(self, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps

    def init(self, params: Params) -> AdamState:
        dev = next(iter(params.values())).device
        zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}
        return AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                         zeros(), zeros())

    @torch.no_grad()
    def update(self, grads: Params, state: AdamState) -> Tuple[Params, AdamState]:
        """(updates, new state); the updates are already scaled by -lr."""
        b1, b2 = self.b1, self.b2
        mu = {k: (1 - b1) * g + b1 * state.mu[k] for k, g in grads.items()}
        nu = {k: (1 - b2) * g**2 + b2 * state.nu[k] for k, g in grads.items()}
        count = state.count + 1  # int32; optax saturates at 2**31 - 1
        c = count.to(torch.float32)
        bc1 = 1 - torch.pow(b1, c)
        bc2 = 1 - torch.pow(b2, c)
        updates = {
            k: -self.lr * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps))
            for k in grads
        }
        return updates, AdamState(count, mu, nu)


def tf_parity_adam(lr: float) -> Adam:
    """Adam with TF-Keras defaults.

    The reference uses ``tf.keras.optimizers.Adam(lr)`` (BPRMF.py:52), whose
    epsilon is 1e-7 (optax's default is 1e-8); bias correction is
    equivalent.  TF's sparse path decays the full moment buffers every step
    and applies the dense update to all rows, so a dense Adam reproduces
    it exactly."""
    return Adam(learning_rate=lr, b1=0.9, b2=0.999, eps=1e-7)


def create_train_state(params: Params, tx: Adam) -> TrainState:
    """``params`` are used as they are (not copied): ``apply_gradients``
    updates them in place."""
    dev = next(iter(params.values())).device
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      params=params, opt_state=tx.init(params))


@torch.no_grad()
def apply_gradients(state: TrainState, grads: Params, tx: Adam) -> TrainState:
    updates, new_opt_state = tx.update(grads, state.opt_state)
    for k, u in updates.items():
        state.params[k].add_(u)
    return TrainState(state.step + 1, state.params, new_opt_state)

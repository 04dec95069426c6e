"""ZeRO-style sharded optimizer state over a mesh axis (PyTorch port).

The counterpart of ``dmlc_core_tpu/parallel/zero.py``: each
data-parallel rank owns 1/P of every parameter's optimizer state.

* backward gives each rank its local gradients;
* :func:`~dmlc_core_tpu_torch.parallel.collectives.psum_scatter` reduces
  them over the axis and leaves each rank ONLY its 1/P slice (of the
  flattened gradient, padded to a multiple of P), divided by P;
* Adam runs on the slice, with JAX's bias correction;
* one ``all_gather`` rebuilds the full update for the replicated
  parameters.

Every rank calls :meth:`ZeroAdam.init` and :meth:`ZeroAdam.step` (they
are collective over the axis); the state tensors live where the
parameters do.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from dmlc_core_tpu_torch.parallel.collectives import (
    all_gather, psum_scatter)

__all__ = ["ZeroAdam", "ZeroState"]


class ZeroState(NamedTuple):
    """This rank's optimizer shard: first/second moments + step count."""
    mu: Any       # dict of [ceil(size/P)] f32 slices
    nu: Any
    count: int


def _flat_pad(x: torch.Tensor, P: int) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % P
    return torch.nn.functional.pad(flat, (0, pad))


class ZeroAdam:
    """Adam with parameters replicated but optimizer state sharded 1/P
    over ``axis`` of ``mesh``::

        opt = ZeroAdam(lr=1e-3, mesh=mesh)
        state = opt.init(params)                  # this rank's shards
        params, state = opt.step(params, grads, state)
    """

    def __init__(self, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, axis: str = "data", *, mesh):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.axis = axis
        self.mesh = mesh

    def init(self, params: Dict[str, torch.Tensor]) -> ZeroState:
        P = self.mesh.axis_size(self.axis)
        zeros = {k: torch.zeros(_flat_pad(p, P).shape[0] // P,
                                dtype=torch.float32, device=p.device)
                 for k, p in params.items()}
        return ZeroState(mu=zeros, nu={k: v.clone() for k, v in zeros.items()},
                         count=0)

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], state: ZeroState):
        """One update from this rank's local gradients (the reduce over
        the axis happens in here).  Returns ``(params, state)``, new
        tensors."""
        P = self.mesh.axis_size(self.axis)
        count = state.count + 1
        # f32 powf with a float exponent, as jnp's ``b ** count`` (an
        # integer exponent takes another rounding)
        n = torch.tensor(float(count))
        b1c = 1.0 - torch.tensor(self.b1, dtype=torch.float32) ** n
        b2c = 1.0 - torch.tensor(self.b2, dtype=torch.float32) ** n
        new_p, mu2, nu2 = {}, {}, {}
        for k, p in params.items():
            flat_g = _flat_pad(grads[k], P)
            # mean-reduce across ranks, keeping only this rank's 1/P slice
            g = psum_scatter(flat_g, self.axis, mesh=self.mesh) / P
            mu = self.b1 * state.mu[k] + (1 - self.b1) * g
            nu = self.b2 * state.nu[k] + (1 - self.b2) * g * g
            delta = (self.lr * (mu / b1c.to(g.device))
                     / (torch.sqrt(nu / b2c.to(g.device)) + self.eps))
            # the full parameter delta for the replicated parameters
            full = all_gather(delta, self.axis, mesh=self.mesh)
            new_p[k] = p - full[: p.numel()].reshape(p.shape)
            mu2[k], nu2[k] = mu, nu
        return new_p, ZeroState(mu=mu2, nu=nu2, count=count)

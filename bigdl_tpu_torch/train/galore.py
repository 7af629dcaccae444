"""GaLore — Gradient Low-Rank Projection (port of bigdl_tpu/train/galore.py)
as a torch optimizer.

Full-parameter training at LoRA-like optimizer memory: the inner Adam
runs in a low-rank subspace of each 2-D weight's gradient. Per weight
G [m, n] with min(m, n) > rank:

    P   <- top-r singular vectors of G on the smaller side (refreshed
           when step % update_proj_gap == 0)
    low <- project(G, P)              # [r, n] or [m, r]
    upd <- adam(low)                  # the moments live at rank r
    W   <- W - lr * (scale * back_project(upd) + weight_decay * W)

which is the JAX package's optax chain
`galore(scale_by_adam(), rank, gap, scale) -> add_decayed_weights(wd) ->
scale(-lr)` with optax's `scale_by_adam` (b1 0.9, b2 0.999, eps 1e-8, bias
correction) and optax's dtype rules: the projected gradient, the moments
and the update are in the weight's dtype (bf16 parameters take bf16
updates), projections and back-projections in f32. Other leaves (norms,
1-D, anything at or below the rank) pass through the same Adam
unprojected. A 3-D leaf [L, O, I] (JAX's stacked layers) projects per
layer over its last two dims, which equals the port's per-layer weights.

The projector is the top-r eigenvectors of the smaller Gram matrix (G G^T
or G^T G, in f32, `torch.linalg.eigh`): the same subspace as JAX's
`jnp.linalg.svd`, at a fraction of an SVD's cost on the card (an 8B
model refreshes some 230 weights up to [128256, 4096]). Singular vectors
are defined up to sign, and the two packages' solvers pick signs of their
own: inside one projector window Adam's update is odd in the gradient,
so a flipped column flips back on the back-projection and the result
does not depend on it; across a refresh the moments carried from the old
basis meet each package's new signs differently.
"""

from __future__ import annotations

from typing import Iterable

import torch


def is_projected(p: torch.Tensor, rank: int) -> bool:
    # stacked layers are [L, O, I]: project per layer over (O, I)
    return p.dim() in (2, 3) and min(p.shape[-2:]) > rank


def orient_left(p: torch.Tensor) -> bool:
    # project the smaller side: left (rows) when m <= n
    return p.shape[-2] <= p.shape[-1]


def project(g: torch.Tensor, P: torch.Tensor, left: bool) -> torch.Tensor:
    if left:  # P [..., m, r]
        return torch.einsum("...mr,...mn->...rn", P, g)
    return torch.einsum("...mn,...nr->...mr", g, P)  # P [..., n, r]


def back_project(low: torch.Tensor, P: torch.Tensor, left: bool) -> torch.Tensor:
    if left:
        return torch.einsum("...mr,...rn->...mn", P, low)
    return torch.einsum("...mr,...nr->...mn", low, P)


def projector(g: torch.Tensor, rank: int, left: bool) -> torch.Tensor:
    """The top-`rank` singular vectors of g (f32) on its `left` (rows) or
    right side, as columns in descending order of singular value: the
    eigenvectors of the Gram matrix of that side."""
    gf = g.float()
    gram = gf @ gf.mT if left else gf.mT @ gf
    _, vecs = torch.linalg.eigh(gram)  # ascending eigenvalues
    return vecs[..., -rank:].flip(-1).contiguous()


def _bias_correction(decay: float, step: int, dtype) -> torch.Tensor:
    # in f32 and then cast, as optax (decay**count rounds to 1 in bf16)
    return (1 - torch.tensor(decay, dtype=torch.float32) ** step).to(dtype)


class GaLore(torch.optim.Optimizer):
    """GaLore over Adam; see the module docstring. `step()` updates every
    parameter that has a gradient, in place."""

    def __init__(self, params: Iterable, lr: float, rank: int = 128,
                 update_proj_gap: int = 200, scale: float = 0.25,
                 betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        if rank < 1 or update_proj_gap < 1:
            raise ValueError(f"GaLore: rank {rank} and update_proj_gap "
                             f"{update_proj_gap} must be >= 1")
        super().__init__(params, dict(lr=lr, rank=rank, update_proj_gap=update_proj_gap,
                                      scale=scale, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    def _init_state(self, p: torch.Tensor, rank: int) -> dict:
        st = {"step": 0, "proj": None}
        shape = p.shape
        if is_projected(p, rank):
            left = orient_left(p)
            shape = (*p.shape[:-2], rank, p.shape[-1]) if left else (*p.shape[:-1], rank)
            side = p.shape[-2] if left else p.shape[-1]
            st["proj"] = torch.zeros((*p.shape[:-2], side, rank), dtype=torch.float32,
                                     device=p.device)
        st["mu"] = torch.zeros(shape, dtype=p.dtype, device=p.device)
        st["nu"] = torch.zeros(shape, dtype=p.dtype, device=p.device)
        return st

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            rank, b1, b2 = group["rank"], *group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st.update(self._init_state(p, rank))
                g = p.grad
                P = st["proj"]
                left = P is not None and orient_left(p)
                if P is not None:
                    if st["step"] % group["update_proj_gap"] == 0:
                        P = st["proj"] = projector(g, rank, left)
                    g = project(g.float(), P, left).to(g.dtype)
                # optax scale_by_adam, in the moments' dtype
                mu, nu = st["mu"], st["nu"]
                mu.mul_(b1).add_(g * (1 - b1))
                nu.mul_(b2).add_(g * g * (1 - b2))
                st["step"] += 1
                mu_hat = mu / _bias_correction(b1, st["step"], mu.dtype)
                nu_hat = nu / _bias_correction(b2, st["step"], nu.dtype)
                upd = mu_hat / (torch.sqrt(nu_hat) + group["eps"])
                if P is not None:
                    upd = (group["scale"] * back_project(upd.float(), P, left)).to(upd.dtype)
                if group["weight_decay"]:
                    upd = upd + group["weight_decay"] * p
                p.add_(upd * -group["lr"])
        return loss

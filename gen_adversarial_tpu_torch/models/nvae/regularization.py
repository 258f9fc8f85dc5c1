"""NVAE training regularizers (counterpart of
gen_adversarial_tpu/models/nvae/regularization.py): the spectral
regularization of every convolution kernel by power iteration, batched over
the kernels of one flattened shape, and the batch-norm max|scale| penalty.

The singular-vector estimates are an explicit state (init -> update ->
loss), as in the JAX package. Each kernel is the matrix (out, kh * kw * in)
of JAX's HWIO kernel, flattened in JAX's (kh, kw, in) order (the port's OIHW
weight permuted to O, H, W, I first), so the estimates are the same vectors
in both packages. Kernels of one shape are stacked in the sorted order of
their flax paths (`core/convert.py`'s names; the order of a JAX variable
tree that went through a tree map). No trainer of either package calls
these.
"""

from __future__ import annotations

from collections import defaultdict

import torch
from torch import nn

from gen_adversarial_tpu_torch.core.convert import _flax_modules
from gen_adversarial_tpu_torch.models.nvae.distributions import as_draws


def _conv_matrices(model: nn.Module, detach: bool = False) -> dict:
    """{(out, kh * kw * in): (N, out, kh * kw * in)} over every conv kernel."""
    convs = sorted(((path, m.weight) for path, m in _flax_modules(model)
                    if isinstance(m, nn.Conv2d)), key=lambda item: item[0])
    groups = defaultdict(list)
    for _, w in convs:
        w = w.detach() if detach else w
        w = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)
        groups[tuple(w.shape)].append(w)
    return {shape: torch.stack(ws) for shape, ws in groups.items()}


def _normalize(a: torch.Tensor) -> torch.Tensor:
    return a / torch.clamp(torch.linalg.norm(a, dim=1, keepdim=True), min=1e-3)


def _power_iterations(u, v, w, n: int):
    for _ in range(n):
        v = _normalize(torch.einsum("nr,nrc->nc", u, w))
        u = _normalize(torch.einsum("nrc,nc->nr", w, v))
    return u, v


@torch.no_grad()
def init_sr_state(model: nn.Module, draws, num_power_iter: int = 4) -> dict:
    """Left and right singular-vector estimates of every kernel group:
    normalized normal draws (`draws`: a generator or replayed tensors; u then
    v for each group, in the groups' order), warmed up with 9 x
    num_power_iter iterations, so that the first loss has run 10 x."""
    draws = as_draws(draws)
    state = {}
    for shape, w in _conv_matrices(model, detach=True).items():
        n, r, c = w.shape
        u = _normalize(draws.normal((n, r), w))
        v = _normalize(draws.normal((n, c), w))
        u, v = _power_iterations(u, v, w, 10 * num_power_iter - num_power_iter)
        state[shape] = {"u": u, "v": v}
    return state


def spectral_norm_loss(model: nn.Module, sr_state: dict, num_power_iter: int = 4):
    """(sum of the estimated largest singular values over all conv kernels,
    new state). The power iterations run without gradient; the gradient
    flows through the final u^T W v only."""
    loss = 0.0
    new_state = {}
    for shape, w in _conv_matrices(model).items():
        st = sr_state[shape]
        with torch.no_grad():
            u, v = _power_iterations(st["u"], st["v"], w.detach(), num_power_iter)
        loss = loss + torch.einsum("nr,nrc,nc->n", u, w, v).sum()
        new_state[shape] = {"u": u, "v": v}
    return loss, new_state


def batch_norm_loss(model: nn.Module) -> torch.Tensor:
    """Sum over the BatchNorm layers of max |scale|."""
    return sum(m.weight.abs().max() for m in model.modules()
               if isinstance(m, nn.modules.batchnorm._BatchNorm))

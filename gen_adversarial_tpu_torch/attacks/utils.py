"""Shared attack math (counterpart of gen_adversarial_tpu/attacks/utils.py),
batched: every tensor carries the batch as its first dim."""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.func import vmap

from gen_adversarial_tpu_torch.defenses.base import several_backwards

# class cotangents x images a backward where no block is given. At the CLI's
# batch of 8 and EoT-32 on the flagship (ids), blocks of 2 peak at 70.9 GiB
# of an H100's 79.2 and blocks of 4 run out, for DeepFool's 8 classes and
# FAB's 100 alike (NVIDIA H100 80GB HBM3, attack_memory.py)
COT_SAMPLES = 16


def class_block(n_classes: int, batch: int) -> int | None:
    """The class-Jacobian block of DeepFool and FAB where none is given:
    COT_SAMPLES // batch cotangents (at least 1), or None (one block, the
    JAX package's default) where that covers every class. A block changes
    the live memory of class_grads' backward, not its result."""
    block = max(1, COT_SAMPLES // batch)
    return None if block >= n_classes else block


def class_grads(net, x: torch.Tensor, draws, class_idx: torch.Tensor | None = None,
                cotangent_chunk: int | None = None):
    """Per-sample input gradients of selected logits from ONE forward.

    One forward of net(x, draws), then torch.autograd.grad under
    torch.func.vmap over the one-hot class cotangents: every class gradient
    differentiates the same forward, with the same draws (the JAX function's
    one jax.vjp applied to the cotangents under vmap). torch.autograd and not
    torch.func.vjp, because a defense with remat (torch.utils.checkpoint)
    works only under the former; torch.func.vmap and not
    `is_grads_batched`, whose older vmap ignores the kernels' batching rules
    (K2's backward applies its Function again, which then cannot reach the
    kernel).

    class_idx: (B, K) class selectors, or None for all C classes.
    cotangent_chunk: if set, one batched backward per block of that many
    cotangents (the last block padded with zero cotangents, whose gradients
    are dropped, so every block has one shape), the graph kept between
    blocks: the backward's live memory falls by K / chunk; under remat every
    block recomputes the purifier. The results equal the unchunked ones.
    The forward then runs under `defenses.base.several_backwards()`, so a
    remat_policy gives way to plain recompute there (a policy's saved
    outputs serve one backward); the chunk is known to be below K before the
    forward only where class_idx gives K, so with class_idx None any
    cotangent_chunk counts.
    Returns logits (B, C) and grads (K, B, ...) (K = C when None)."""
    x = x.detach().requires_grad_(True)
    blocked = cotangent_chunk is not None and (class_idx is None
                                               or cotangent_chunk < class_idx.shape[1])
    with torch.enable_grad(), several_backwards() if blocked else contextlib.nullcontext():
        logits = net(x, draws)
    b, n_classes = logits.shape
    if class_idx is None:
        eye = torch.eye(n_classes, dtype=logits.dtype, device=logits.device)
        cotangents = eye[:, None, :].expand(n_classes, b, n_classes)
    else:
        cotangents = F.one_hot(class_idx.T.long(), n_classes).to(logits.dtype)  # (K, B, C)
    k = cotangents.shape[0]
    chunk = min(cotangent_chunk or k, k)
    pad = (-k) % chunk
    if pad:
        cotangents = torch.cat([cotangents, cotangents.new_zeros(pad, b, n_classes)])
    blocks = cotangents.split(chunk)
    grads = []
    for i, block in enumerate(blocks):
        keep = i < len(blocks) - 1

        def vjp(ct, keep=keep):
            return torch.autograd.grad(logits, x, ct, retain_graph=keep)[0]

        grads.append(vmap(vjp)(block))
    return logits.detach(), torch.cat(grads)[:k]


def l2_norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Per-sample L2 norm over all non-batch dims: (B, ...) -> (B,), or
    (B, 1, ..., 1) with keepdim."""
    return torch.sqrt(torch.sum(x ** 2, dim=tuple(range(1, x.dim())), keepdim=keepdim))


def normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Per-sample L2 normalization."""
    return x / torch.clamp(l2_norm(x, keepdim=True), min=eps)


def projection_l2(points_to_project: torch.Tensor, w_hyperplane: torch.Tensor,
                  b_hyperplane: torch.Tensor) -> torch.Tensor:
    """Closed-form L2 projection of `points` onto {z : w.z = b} intersected
    with the [0, 1] box, by sorting and a binary search of a fixed
    ceil(log2 D) steps; masked selects stand in for the reference's
    `if c4.any()` branches.

    points, w: (N, D); b: (N, 1). Returns d (N, D) with z* = point + d."""
    t, w, b = points_to_project, w_hyperplane, b_hyperplane
    n, d_dim = w.shape

    c = torch.sum(w * t, dim=1) - b[:, 0]
    ind2 = 2.0 * (c >= 0) - 1.0
    w = w * ind2[:, None]
    c = c * ind2

    r = torch.clamp(torch.maximum(t / w, (t - 1) / w), -1e12, 1e12)
    r = torch.where(torch.abs(w) < 1e-8, 1e12, r)
    r = torch.where(r == -1e12, -r, r)
    indr = torch.argsort(r, dim=1, stable=True)
    rs = torch.gather(r, 1, indr)
    rs2 = F.pad(rs[:, 1:], (0, 1))
    rs = torch.where(rs == 1e12, 0.0, rs)
    rs2 = torch.where(rs2 == 1e12, 0.0, rs2)

    w3s = torch.gather(w ** 2, 1, indr)
    w5 = torch.sum(w3s, dim=1, keepdim=True)
    ws = w5 - torch.cumsum(w3s, dim=1)
    d = -(r * w)
    d = d * (torch.abs(w) > 1e-8)
    s = torch.cat([-w5 * rs[:, 0:1],
                   torch.cumsum((-rs2 + rs) * ws, dim=1) - w5 * rs[:, 0:1]], dim=1)

    c4 = (s[:, 0] + c) < 0
    c3 = (torch.sum(d * w, dim=1) + c) > 0
    c2 = ~(c4 | c3)

    # fixed-trip binary search over all rows (masked by c2 at the end)
    lb = torch.zeros(n, dtype=w.dtype, device=w.device)
    ub = torch.full((n,), float(d_dim - 1), dtype=w.dtype, device=w.device)
    for _ in range(int(math.ceil(math.log2(max(d_dim, 2))))):
        mid = torch.floor((lb + ub) / 2)
        sel = torch.gather(s, 1, mid.long()[:, None])[:, 0]
        go_up = (sel + c) > 0
        lb, ub = torch.where(go_up, mid, lb), torch.where(go_up, ub, mid)
    lb_idx = lb.long()[:, None]

    # c4 rows: the plain hyperplane projection
    d_c4 = -(c / w5[:, 0])[:, None] * w

    # c2 rows: the box-constrained solution at the breakpoint found
    s_lb = torch.gather(s, 1, lb_idx)[:, 0]
    ws_lb = torch.gather(ws, 1, lb_idx)[:, 0]
    rs_lb = torch.gather(rs, 1, lb_idx)[:, 0]
    alpha_c2 = torch.where(ws_lb == 0, 0.0,
                           (s_lb + c) / torch.where(ws_lb == 0, 1.0, ws_lb) + rs_lb)
    c5 = (alpha_c2[:, None] > r).to(w.dtype)
    d_c2 = d * c5 - alpha_c2[:, None] * w * (1 - c5)

    d = torch.where(c4[:, None], d_c4, d)
    d = torch.where(c2[:, None], d_c2, d)
    return d * (torch.abs(w) > 1e-8)

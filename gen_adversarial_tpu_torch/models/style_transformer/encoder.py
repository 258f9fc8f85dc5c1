"""Style-Transformer encoder on NCHW tensors (counterpart of
gen_adversarial_tpu/models/style_transformer/encoder.py): the IR-SE-50 trunk
and its feature pyramid, cross-attended by the learned query tokens through
three post-norm DETR decoder layers (coarse -> medium -> fine), in eval mode.

Attention is written out as plain tensor math (project, split heads,
softmax(q k^T / sqrt(dh)), merge heads, project out), as the JAX module
writes it, with torch.nn.MultiheadAttention's packed-qkv parameters.
Submodule names follow the JAX variable tree (`trunk.body_12`,
`layer_coarse.self_attn`, `norm1`, `linear1`, `z`) so core/convert.py maps
weights by name.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from gen_adversarial_tpu_torch.models.e4e.encoder import IRSE50Trunk, upsample_add

D_MODEL = 512
NUM_HEADS = 4
DIM_FEEDFORWARD = 1024


class TorchMHA(nn.Module):
    """4-head attention on batch-first (B, L, 512) tensors, with
    `in_proj_weight` (3D, D), `in_proj_bias` (3D,), `out_proj_weight` (D, D)
    and `out_proj_bias` (D,) in torch's (out, in) layout."""

    def __init__(self, device=None):
        super().__init__()
        d = D_MODEL
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d, device=device))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d, device=device))
        self.out_proj_weight = nn.Parameter(torch.empty(d, d, device=device))
        self.out_proj_bias = nn.Parameter(torch.empty(d, device=device))

    def forward(self, q, k, v):
        d = q.shape[-1]
        w, bias = self.in_proj_weight, self.in_proj_bias
        qp = q @ w[:d].T + bias[:d]
        kp = k @ w[d:2 * d].T + bias[d:2 * d]
        vp = v @ w[2 * d:].T + bias[2 * d:]
        b, lq, lk, h = q.shape[0], q.shape[1], k.shape[1], NUM_HEADS
        dh = d // h
        qp = qp.reshape(b, lq, h, dh).transpose(1, 2)
        kp = kp.reshape(b, lk, h, dh).transpose(1, 2)
        vp = vp.reshape(b, lk, h, dh).transpose(1, 2)
        attn = torch.softmax(qp @ kp.transpose(2, 3) / math.sqrt(dh), dim=-1)
        out = (attn @ vp).transpose(1, 2).reshape(b, lq, d)
        return out @ self.out_proj_weight.T + self.out_proj_bias


class TransformerDecoderLayer(nn.Module):
    """DETR decoder layer, post-norm: self-attention -> norm1, cross-attention
    against the memory -> norm2, linear1 (1024) -> ReLU -> linear2 -> norm3
    (dropout is the identity at inference)."""

    def __init__(self, device=None):
        super().__init__()
        d = D_MODEL
        self.self_attn = TorchMHA(device=device)
        self.norm1 = nn.LayerNorm(d, eps=1e-5, device=device)
        self.multihead_attn = TorchMHA(device=device)
        self.norm2 = nn.LayerNorm(d, eps=1e-5, device=device)
        self.linear1 = nn.Linear(d, DIM_FEEDFORWARD, device=device)
        self.linear2 = nn.Linear(DIM_FEEDFORWARD, d, device=device)
        self.norm3 = nn.LayerNorm(d, eps=1e-5, device=device)

    def forward(self, tgt, memory):
        tgt = self.norm1(tgt + self.self_attn(tgt, tgt, tgt))
        tgt = self.norm2(tgt + self.multihead_attn(tgt, memory, memory))
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


def tokens(f: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H * W, C), row-major over the pixels (the JAX
    package's reshape of NHWC, torch's flatten(2) of NCHW)."""
    return f.flatten(2).transpose(1, 2)


class GradualStyleEncoder(nn.Module):
    """The trunk's features c1, c2, c3 and the pyramid p2 = c3 upsampled +
    latlayer1(c2), p1 = p2 upsampled + latlayer2(c1); the query tokens
    attend to c3, then p2, then p1. `z` (1, n_styles, 512) is the learned
    query, which the container pushes through the generator's style MLP."""

    def __init__(self, n_styles: int = 16, device=None):
        super().__init__()
        self.trunk = IRSE50Trunk(device=device)
        self.latlayer1 = nn.Conv2d(256, D_MODEL, 1, device=device)
        self.latlayer2 = nn.Conv2d(128, D_MODEL, 1, device=device)
        self.layer_coarse = TransformerDecoderLayer(device=device)
        self.layer_medium = TransformerDecoderLayer(device=device)
        self.layer_fine = TransformerDecoderLayer(device=device)
        self.z = nn.Parameter(torch.empty(1, n_styles, D_MODEL, device=device))

    def forward(self, x, query):
        """x: (B, 3, H, W) images; query: (B, n_styles, 512) -> codes
        (B, n_styles, 512)."""
        c1, c2, c3 = self.trunk(x)
        p2 = upsample_add(c3, self.latlayer1(c2))
        p1 = upsample_add(p2, self.latlayer2(c1))
        q = self.layer_coarse(query, tokens(c3))
        q = self.layer_medium(q, tokens(p2))
        return self.layer_fine(q, tokens(p1))

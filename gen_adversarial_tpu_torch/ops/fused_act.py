"""Fused bias + scaled LeakyReLU (counterpart of
gen_adversarial_tpu/ops/fused_act.py): sqrt(2) * leaky_relu(x + bias) with
slope 0.2, the values every StyleGAN2 caller uses. Plain PyTorch; the bias
lies on the channel axis, which is dim 1 both for NCHW activations and for
(B, D) vectors."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    x = x + bias.view(1, -1, *([1] * (x.dim() - 2)))
    return F.leaky_relu(x, 0.2) * math.sqrt(2.0)

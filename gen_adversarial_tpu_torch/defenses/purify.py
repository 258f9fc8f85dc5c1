"""Purify halves of the NVAE and E4E families (counterpart of
`make_nvae_purify_split`, `_mix_codes` and `make_e4e_purify_split` in
gen_adversarial_tpu/defenses/purify.py). Each returns
    encode(x) -> state, decode(alphas, state, draws) -> purified
on NHWC images, with purify = decode(encode(x)) by construction; the encode
half draws nothing. The Style-Transformer family comes with its slice."""

from __future__ import annotations

from collections.abc import Callable

import torch

from gen_adversarial_tpu_torch.models.e4e.psp import PSP
from gen_adversarial_tpu_torch.models.nvae.distributions import Draws
from gen_adversarial_tpu_torch.models.nvae.model import NVAE


def make_nvae_purify_split(model: NVAE, temperature: float = 0.6):
    """On [0, 1] NHWC images (the NVAE normalizes internally)."""

    def encode(x):
        return model.purify_encode(x)

    def decode(alphas, state, draws):
        return model.purify_decode(state, alphas, draws, temperature)

    return encode, decode


def _mix_codes(draws: Draws, style_fn: Callable, codes: torch.Tensor,
               alphas: torch.Tensor, noise_std: float) -> torch.Tensor:
    """(1 - a) * codes + a * style(N(0, std)) per latent layer; one draw of
    shape (n_codes, B, d), as the JAX function draws it."""
    b, n_codes, d = codes.shape
    noises = noise_std * draws.normal((n_codes, b, d), codes)
    styles = style_fn(noises.reshape(n_codes * b, d)).reshape(n_codes, b, d)
    a = alphas.reshape(-1, 1, 1)
    return ((1 - a) * codes.transpose(0, 1) + a * styles).transpose(0, 1)


def make_e4e_purify_split(model: PSP):
    """E4E purify on NHWC images in the normalized domain [-1, 1]: encode ->
    mix each code with a style of N(0, 1) -> decode (fixed noise buffers),
    pooled to 256 x 256."""

    def encode(x):
        return model.encode(x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))

    def decode(alphas, codes, draws):
        codes = _mix_codes(draws, model.style, codes, alphas, 1.0)
        return model.decode(codes).permute(0, 2, 3, 1)

    return encode, decode

"""Purify halves of the NVAE, E4E and Style-Transformer families
(counterpart of `make_nvae_purify_split`, `_mix_codes`,
`make_e4e_purify_split` and `make_trans_purify_split` in
gen_adversarial_tpu/defenses/purify.py). Each returns
    encode(x) -> state, decode(alphas, state, draws) -> purified
on NHWC images, with purify = decode(encode(x)) by construction; the encode
half draws nothing.

The halves are bound methods of a small object that holds the model, not
closures over it: `copy.deepcopy` of a defense that holds them copies that
object with the defense, and its model is the copy's own purifier (the
memo of one deepcopy maps the model to one copy), so a copy that is cast
(`core/precision.defense_astype`) or re-weighted computes from its own
weights."""

from __future__ import annotations

from collections.abc import Callable

import torch
import torch.nn.functional as F

from gen_adversarial_tpu_torch.models.e4e.psp import PSP
from gen_adversarial_tpu_torch.models.nvae.distributions import Draws
from gen_adversarial_tpu_torch.models.nvae.model import NVAE
from gen_adversarial_tpu_torch.models.style_transformer.model import StyleTransformer
from gen_adversarial_tpu_torch.ops.image import resize_bilinear

# the Style-Transformer's letterbox: the cars images fill rows 32:-32 of the
# 256 x 256 frame the generator was trained on
LETTERBOX = 32


class NVAEPurifySplit:
    """The NVAE's purify halves on [0, 1] NHWC images (the NVAE normalizes
    internally)."""

    def __init__(self, model: NVAE, temperature: float):
        self.model, self.temperature = model, temperature

    def encode(self, x):
        return self.model.purify_encode(x)

    def decode(self, alphas, state, draws):
        return self.model.purify_decode(state, alphas, draws, self.temperature)


def make_nvae_purify_split(model: NVAE, temperature: float = 0.6):
    """(encode, decode) of `NVAEPurifySplit`."""
    split = NVAEPurifySplit(model, temperature)
    return split.encode, split.decode


def _mix_codes(draws: Draws, style_fn: Callable, codes: torch.Tensor,
               alphas: torch.Tensor, noise_std: float) -> torch.Tensor:
    """(1 - a) * codes + a * style(N(0, std)) per latent layer; one draw of
    shape (n_codes, B, d), as the JAX function draws it."""
    b, n_codes, d = codes.shape
    noises = noise_std * draws.normal((n_codes, b, d), codes)
    styles = style_fn(noises.reshape(n_codes * b, d)).reshape(n_codes, b, d)
    a = alphas.reshape(-1, 1, 1)
    return ((1 - a) * codes.transpose(0, 1) + a * styles).transpose(0, 1)


class E4EPurifySplit:
    """E4E purify on NHWC images in the normalized domain [-1, 1]: encode ->
    mix each code with a style of N(0, 1) -> decode (fixed noise buffers),
    pooled to 256 x 256."""

    def __init__(self, model: PSP):
        self.model = model

    def encode(self, x):
        return self.model.encode(_nchw(x))

    def decode(self, alphas, codes, draws):
        codes = _mix_codes(draws, self.model.style, codes, alphas, 1.0)
        return self.model.decode(codes).permute(0, 2, 3, 1)


def make_e4e_purify_split(model: PSP):
    """(encode, decode) of `E4EPurifySplit`."""
    split = E4EPurifySplit(model)
    return split.encode, split.decode


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


class TransPurifySplit:
    """Style-Transformer purify on NHWC images in [-1, 1]: resize to 256
    (half-pixel bilinear, no antialias), crop the letterbox rows, encode |
    mix each code with a style of N(0, 0.8^2) -> decode (pooled to 256) ->
    set the letterbox rows to -1 -> resize to 128."""

    def __init__(self, model: StyleTransformer):
        self.model = model

    def encode(self, x):
        x = resize_bilinear(_nchw(x), 256, 256)
        return self.model.encode(x[:, :, LETTERBOX:-LETTERBOX].contiguous(
            memory_format=torch.channels_last))

    def decode(self, alphas, codes, draws):
        codes = _mix_codes(draws, self.model.style, codes, alphas, 0.8)
        images = self.model.decode(codes)[:, :, LETTERBOX:-LETTERBOX]
        images = F.pad(images, (0, 0, LETTERBOX, LETTERBOX), value=-1.0)
        return resize_bilinear(images, 128, 128).permute(0, 2, 3, 1)


def make_trans_purify_split(model: StyleTransformer):
    """(encode, decode) of `TransPurifySplit`."""
    split = TransPurifySplit(model)
    return split.encode, split.decode

"""Purify halves of the NVAE family (counterpart of `make_nvae_purify_split`
in gen_adversarial_tpu/defenses/purify.py). The E4E and Style-Transformer
families come with the StyleGAN2 slices."""

from __future__ import annotations

from gen_adversarial_tpu_torch.models.nvae.model import NVAE


def make_nvae_purify_split(model: NVAE, temperature: float = 0.6):
    """(encode(x) -> state, decode(alphas, state, draws) -> purified) on
    [0, 1] NHWC images (the NVAE normalizes internally); purify is
    decode(encode(x)) by construction."""

    def encode(x):
        return model.purify_encode(x)

    def decode(alphas, state, draws):
        return model.purify_decode(state, alphas, draws, temperature)

    return encode, decode

"""The gender defense (counterpart of `eval/factory.load_defense` on
configs/ours_cosine_noise_gender.yaml): an E4E IR-SE-50 encoder and a
1024-px StyleGAN2 generator (PSP, 18 styles, `latent_avg`, fixed noise
buffers, the decode pooled to 256 x 256) purify 256-px images in [-1, 1]
(normalize_before_purify), each code mixed with a style of N(0, 1) on the
cosine alpha schedule; then ResNet50 with the projector head over 2 classes,
through the 0.5 / 0.5 classifier normalization. Initial noise eps 4.0, no
gaussian blur, alpha_attenuation 1.0. EoT is defenses/eot.py's.

Weights are random, made from a seed by a generator on the target device:
the modules are built on the meta device and filled in place (the purifier
holds 297.5 M parameters, the classifier 27.8 M; nothing weight-sized is
made on the host).
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import numpy as np
import torch
from torch import nn

from gen_adversarial_tpu_torch.defenses.base import MLVGMDefense, make_classifier_apply
from gen_adversarial_tpu_torch.defenses.purify import make_e4e_purify_split
from gen_adversarial_tpu_torch.flagship import init_tensor_, random_init_
from gen_adversarial_tpu_torch.models.classifiers import ResNetBackbone
from gen_adversarial_tpu_torch.models.e4e.psp import PSP

# interpolation_alphas of configs/ours_cosine_noise_gender.yaml (the port
# reads no YAML); alpha_attenuation there is 1.0
GENDER_ALPHAS = (0.008, 0.03, 0.067, 0.117, 0.179, 0.25, 0.329, 0.413, 0.5, 0.587, 0.671,
                 0.75, 0.821, 0.883, 0.933, 0.97, 0.992, 1.0)
ALPHA_ATTENUATION = 1.0
INITIAL_NOISE_EPS = 4.0
N_CLASSES = 2
IMAGE_SIZE = 256
RESNET50_LAYERS = (3, 4, 6, 3)


def resampled_alphas(alphas, attenuation: float, n_latent: int) -> np.ndarray:
    """A config's alphas times its attenuation; for a smaller generator (a
    rehearsal) the same schedule resampled to its n_latent codes."""
    a = np.asarray(alphas, np.float32)
    if n_latent != len(a):
        a = np.interp(np.linspace(0, len(a) - 1, n_latent), np.arange(len(a)), a)
    return (a * attenuation).astype(np.float32)


def gender_alphas(n_latent: int = len(GENDER_ALPHAS)) -> np.ndarray:
    return resampled_alphas(GENDER_ALPHAS, ALPHA_ATTENUATION, n_latent)


@torch.no_grad()
def init_stylegan_tensor_(mod: nn.Module, name: str, t: torch.Tensor,
                          generator: torch.Generator) -> None:
    """StyleGAN2 / E4E / Style-Transformer tensors at the scales their own
    inits use: equalized weights at unit variance (the discriminator's
    EqualConv2d too; the style MLP's at
    1 / lr_mul), the constant input and the noise maps N(0, 1), modulation
    biases near their init 1; PReLU slopes near 0.25; codes' latent_avg and
    the learned query z N(0, 1); attention projections N(0, 1 / fan_in) with
    biases N(0, 0.01^2). Everything else (LayerNorm as BatchNorm) as the
    flagship's init (flagship.init_tensor_)."""
    kind = type(mod).__name__
    if kind == "EqualLinear" and name == "weight":
        t.normal_(0.0, 1.0 / mod.lr_mul, generator=generator)
    elif kind == "EqualLinear" and name == "bias":
        t.normal_(mod.bias_init, 0.01, generator=generator)
    elif kind in ("ModulatedConv2d", "EqualConv2d") and name == "weight":
        t.normal_(0.0, 1.0, generator=generator)
    elif kind == "Generator":  # const_input, noise_{i}
        t.normal_(0.0, 1.0, generator=generator)
    elif kind == "NoiseInjection":
        t.normal_(0.0, 0.1, generator=generator)
    elif kind == "PReLU":
        t.normal_(0.25, 0.01, generator=generator)
    elif kind in ("PSP", "StyleTransformer", "GradualStyleEncoder"):  # latent_avg, z
        t.normal_(0.0, 1.0, generator=generator)
    elif kind == "TorchMHA" and t.dim() == 2:
        t.normal_(0.0, 1.0 / math.sqrt(t.shape[1]), generator=generator)
    elif kind == "TorchMHA":
        t.normal_(0.0, 0.01, generator=generator)
    else:
        init_tensor_(mod, name, t, generator)


def gender_defense(initial_noise_eps: float = INITIAL_NOISE_EPS, device="cuda",
                   seed: int = 0, stylegan_size: int = 1024,
                   classifier_layers: Sequence[int] = RESNET50_LAYERS,
                   remat: bool = True) -> MLVGMDefense:
    """The gender MLVGMDefense with random weights from `seed`. remat is on,
    as the JAX factory sets it for the StyleGAN2 families: their attack
    gradients do not fit without it.

    `stylegan_size` and `classifier_layers` exist only to rehearse the
    defense at a reduced size (the tests, the smoke's parity phase)."""
    device = torch.device(device)
    with torch.device("meta"):
        psp = PSP(stylegan_size, device="meta")
        clf = ResNetBackbone(N_CLASSES, layers=classifier_layers, device="meta")
    generator = torch.Generator(device=device).manual_seed(seed)
    psp = random_init_(psp.to_empty(device=device), generator, init_stylegan_tensor_)
    clf = random_init_(clf.to_empty(device=device), generator)
    psp = psp.requires_grad_(False).to(memory_format=torch.channels_last)
    clf = clf.requires_grad_(False).to(memory_format=torch.channels_last)
    alphas = torch.as_tensor(gender_alphas(psp.decoder.n_latent), device=device)
    encode, decode = make_e4e_purify_split(psp)
    return MLVGMDefense(
        purifier=psp, classifier=clf, alphas=alphas, purify_encode=encode,
        purify_decode=decode, classifier_apply=make_classifier_apply(clf),
        initial_noise_eps=initial_noise_eps, normalize_before_purify=True, remat=remat)


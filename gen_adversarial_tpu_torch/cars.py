"""The cars defense (counterpart of `eval/factory.load_defense` on
configs/ours_cosine_noise_cars.yaml): a Style-Transformer (IR-SE-50 encoder
with 16 learned query tokens, a 512-px StyleGAN2 generator, `latent_avg`,
fixed noise buffers) purifies 128-px images in [-1, 1]
(normalize_before_purify): resized to 256 and cropped to the letterbox rows
32:-32, encoded, each code mixed with a style of N(0, 0.8^2) on the cosine
alpha schedule (attenuated by 0.7), decoded, the letterbox rows set to -1,
resized to 128. Then ResNeXt50-32x4d with the projector head over 4
classes, through the 0.5 / 0.5 classifier normalization. Initial noise eps
4.0, no gaussian blur. EoT is defenses/eot.py's.

Weights are random, made from a seed by a generator on the target device:
the modules are built on the meta device and filled in place.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from gen_adversarial_tpu_torch.defenses.base import MLVGMDefense, make_classifier_apply
from gen_adversarial_tpu_torch.defenses.purify import make_trans_purify_split
from gen_adversarial_tpu_torch.flagship import random_init_
from gen_adversarial_tpu_torch.gender import (
    RESNET50_LAYERS, init_stylegan_tensor_, resampled_alphas)
from gen_adversarial_tpu_torch.models.classifiers import ResNetBackbone
from gen_adversarial_tpu_torch.models.style_transformer.model import StyleTransformer

# interpolation_alphas of configs/ours_cosine_noise_cars.yaml (the port
# reads no YAML), applied times alpha_attenuation
CARS_ALPHAS = (0.01, 0.038, 0.084, 0.146, 0.222, 0.309, 0.402, 0.5, 0.598, 0.691, 0.778,
               0.854, 0.916, 0.962, 0.99, 1.0)
ALPHA_ATTENUATION = 0.7
INITIAL_NOISE_EPS = 4.0
N_CLASSES = 4
IMAGE_SIZE = 128
OUTPUT_SIZE = 512  # the generator's resolution: 16 styles
RESNEXT_GROUPS, RESNEXT_BASE_WIDTH = 32, 4


def cars_alphas(n_latent: int = len(CARS_ALPHAS)) -> np.ndarray:
    return resampled_alphas(CARS_ALPHAS, ALPHA_ATTENUATION, n_latent)


def cars_defense(initial_noise_eps: float = INITIAL_NOISE_EPS, device="cuda",
                 seed: int = 0, output_size: int = OUTPUT_SIZE,
                 classifier_layers: Sequence[int] = RESNET50_LAYERS,
                 remat: bool = True) -> MLVGMDefense:
    """The cars MLVGMDefense with random weights from `seed`, remat on as for
    gender (gender.gender_defense).

    `output_size` and `classifier_layers` exist only to rehearse the defense
    at a reduced size (the tests, the smoke's parity phase)."""
    device = torch.device(device)
    with torch.device("meta"):
        trans = StyleTransformer(output_size, device="meta")
        clf = ResNetBackbone(N_CLASSES, layers=classifier_layers, groups=RESNEXT_GROUPS,
                             base_width=RESNEXT_BASE_WIDTH, device="meta")
    generator = torch.Generator(device=device).manual_seed(seed)
    trans = random_init_(trans.to_empty(device=device), generator, init_stylegan_tensor_)
    clf = random_init_(clf.to_empty(device=device), generator)
    trans = trans.requires_grad_(False).to(memory_format=torch.channels_last)
    clf = clf.requires_grad_(False).to(memory_format=torch.channels_last)
    alphas = torch.as_tensor(cars_alphas(trans.decoder.n_latent), device=device)
    encode, decode = make_trans_purify_split(trans)
    return MLVGMDefense(
        purifier=trans, classifier=clf, alphas=alphas, purify_encode=encode,
        purify_decode=decode, classifier_apply=make_classifier_apply(clf),
        initial_noise_eps=initial_noise_eps, normalize_before_purify=True,
        image_size=IMAGE_SIZE, remat=remat)

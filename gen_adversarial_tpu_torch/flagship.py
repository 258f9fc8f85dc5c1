"""The flagship defense at the ids scale (counterpart of `_flagship` in the
repository's `__graft_entry__.py`): an NVAE with 32 initial channels and
3 scales x 8 groups (24 latent groups) at 64 px, temperature 0.6, the linear
alpha schedule, and VGG11-BN with the projector head over 100 classes.

Weights are random, made from a seed by a generator on the target device:
the modules are built on the meta device and filled in place, so nothing
weight-sized is made on the host (the VGG head alone is 25088 x 25088 float32,
2.5 GB).
"""

from __future__ import annotations

import math
from collections.abc import Callable, Sequence

import numpy as np
import torch
from torch import nn

from gen_adversarial_tpu_torch.defenses.base import MLVGMDefense, make_classifier_apply
from gen_adversarial_tpu_torch.defenses.purify import make_nvae_purify_split
from gen_adversarial_tpu_torch.models.classifiers import VGG11_PLAN, VGG11BN
from gen_adversarial_tpu_torch.models.nvae.model import NVAE, NVAEConfig

FLAGSHIP_NVAE = NVAEConfig(resolution=64, initial_channels=32, n_pre_post_blocks=1,
                           n_pre_post_cells=2, num_scales=3, num_groups_per_scale=8,
                           is_adaptive=False, num_cells_per_group=2,
                           num_latent_per_group=20, num_nf_cells=None)
N_CLASSES = 100
TEMPERATURE = 0.6


def alpha_schedule(n_latents: int) -> np.ndarray:
    """Linear 0.04 -> 1.0 over the latent groups, times 0.7."""
    return (np.interp(np.arange(1, n_latents + 1), [1, n_latents], [0.04, 1.0])
            .astype(np.float32) * 0.7)


@torch.no_grad()
def init_tensor_(mod: nn.Module, name: str, t: torch.Tensor,
                 generator: torch.Generator) -> None:
    """Conv/linear weights N(0, 1/fan_in), biases N(0, 0.01^2), BatchNorm
    weights 1 + N(0, 0.1^2) and running variances U(0.5, 1.5), other tensors
    (running means, the NVAE's constant prior) N(0, 0.1^2) or U(0, 1)."""
    if not t.is_floating_point():
        t.zero_()
    elif name == "weight" and isinstance(mod, (nn.Conv2d, nn.Linear)):
        t.normal_(0.0, 1.0 / math.sqrt(t[0].numel()), generator=generator)
    elif name == "weight":  # BatchNorm
        t.normal_(1.0, 0.1, generator=generator)
    elif name == "running_var":
        t.uniform_(0.5, 1.5, generator=generator)
    elif name == "bias":
        t.normal_(0.0, 0.01, generator=generator)
    elif name == "const_prior":
        t.uniform_(0.0, 1.0, generator=generator)
    else:
        t.normal_(0.0, 0.1, generator=generator)


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator,
                 init: Callable = init_tensor_) -> nn.Module:
    """Fill every parameter and buffer from `generator` with `init(module,
    name, tensor, generator)`, in a fixed order."""
    for mod in module.modules():
        for name, t in list(mod.named_parameters(recurse=False)) + \
                list(mod.named_buffers(recurse=False)):
            init(mod, name, t, generator)
    return module


def flagship(initial_noise_eps: float = 2.0, device="cuda", seed: int = 0,
             cfg: NVAEConfig = FLAGSHIP_NVAE, vgg_plan: Sequence = VGG11_PLAN,
             n_classes: int = N_CLASSES) -> MLVGMDefense:
    """The flagship MLVGMDefense with random weights from `seed`.

    initial_noise_eps 2.0 is the ours_*_noise_ids configs; 0.0 the
    no-preprocessing ones, which take the shared-encode EoT path. `cfg` and
    `vgg_plan` exist to rehearse the flagship at a reduced size."""
    device = torch.device(device)
    with torch.device("meta"):
        nvae = NVAE(cfg, device="meta")
        clf = VGG11BN(n_classes, plan=vgg_plan, device="meta")
    generator = torch.Generator(device=device).manual_seed(seed)
    nvae = random_init_(nvae.to_empty(device=device), generator).requires_grad_(False)
    clf = random_init_(clf.to_empty(device=device), generator).requires_grad_(False)
    nvae = nvae.to(memory_format=torch.channels_last)
    clf = clf.to(memory_format=torch.channels_last)
    alphas = torch.as_tensor(alpha_schedule(cfg.n_latents), device=device)
    encode, decode = make_nvae_purify_split(nvae, TEMPERATURE)
    return MLVGMDefense(
        purifier=nvae, classifier=clf, alphas=alphas, purify_encode=encode,
        purify_decode=decode, classifier_apply=make_classifier_apply(clf),
        initial_noise_eps=initial_noise_eps)

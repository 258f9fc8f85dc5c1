"""Fresh weights as flax initializes them, from an explicit generator (the
JAX trainers start from `model.init(key)`; the port's trainers start from
`flax_init_(module, generator)`): convolution and linear weights
lecun-normal (a normal truncated at two standard deviations, scaled to
variance 1 / fan_in), their biases zero, BatchNorm scale 1, bias 0, mean 0,
var 1, and the NVAE's constant prior U(0, 1). A module whose flax
initializers are its own names them in its `FLAX_INIT` (leaf -> "normal"
N(0, 1), "zeros" or "uniform" U(0, 1)): the A-VAE's equalized weights and
constant input N(0, 1), its biases and noise weights zero; the ND-VAE's
constant `h` U(0, 1). The values are not JAX's:
JAX's keys cannot be replayed here, so the tests load JAX weights instead.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gen_adversarial_tpu_torch.flagship import random_init_

# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def init_flax_tensor_(mod: nn.Module, name: str, t: torch.Tensor,
                      generator: torch.Generator) -> None:
    """One parameter or buffer as flax initializes it (see the module)."""
    rule = getattr(mod, "FLAX_INIT", {}).get(name)
    if not t.is_floating_point():
        t.zero_()
    elif rule == "normal":
        t.normal_(0.0, 1.0, generator=generator)
    elif rule == "uniform":
        t.uniform_(0.0, 1.0, generator=generator)
    elif rule == "zeros":
        t.zero_()
    elif name == "weight" and isinstance(mod, (nn.Conv2d, nn.Linear)):
        std = math.sqrt(1.0 / t[0].numel()) / _TRUNCATED_STD
        nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    elif name in ("weight", "running_var"):  # BatchNorm scale and variance
        t.fill_(1.0)
    elif name == "const_prior":
        t.uniform_(0.0, 1.0, generator=generator)
    else:  # biases and running means
        t.zero_()


def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Every parameter and buffer of `module` set from `generator` in place,
    in a fixed order (flagship.random_init_'s); returns the module."""
    return random_init_(module, generator, init_flax_tensor_)

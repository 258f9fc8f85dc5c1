"""bfloat16 casts of a defense (counterpart of
gen_adversarial_tpu/core/precision.py).

`defense_astype` casts every floating parameter and buffer of a defense once
(the BN running statistics, the `alphas` buffer, the StyleGAN2 fixed noise
maps, `latent_avg` and the constant inputs included) and sets its
`compute_dtype`, so that the model's forward and backward run in that dtype
while the defense's contract stays float32: the input noise, blur and clamp
run in float32 before the cast, and logits and purified images come back as
float32, so the attacks' math (gradients, norms, projections) does not
degrade. Casting once matters: a cast on every call would read every weight
again on each attack step. A bfloat16 defense's robust accuracy has to be
validated against float32 on each checkpoint before it is reported.

The casts are in place, as `nn.Module.to` is: a caller that still needs the
float32 defense casts a `copy.deepcopy` of it (a copy's purify halves and
classifier call reach the copy's own modules: defenses/purify.py). The builders
(`flagship.py`, `gender.py`, `cars.py`) take no dtype; the caller applies
`defense_astype` after the build.
"""

from __future__ import annotations

import torch
from torch import nn

# how a bfloat16 result is held to its reference: at most this many times as
# far from the float32 result as the reference's own bfloat16 result is.
# bfloat16 rounds at other places in torch and in JAX (and on the card and
# the CPU), so the tests and the smoke bound distances, not elements.
BF16_GAP_FACTOR = 2.0


def cast_floating(obj, dtype: torch.dtype = torch.bfloat16):
    """A floating tensor cast to `dtype` (others returned as they are), or a
    module with every floating parameter and buffer cast, in place."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dtype) if obj.is_floating_point() else obj
    return obj.to(dtype)


@torch.no_grad()
def round_floating(module: nn.Module, dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Every floating parameter and buffer rounded to `dtype` and kept in its
    own dtype, in place. This is what the JAX package computes for a defense
    without a compute_dtype: its weights are cast, its float32 inputs
    promote the pipeline back to float32, so every weight enters a float32
    operation as a rounded value. torch does not promote across a
    convolution (a float32 input with bfloat16 weights raises), so the
    rounding is made once here instead."""
    for t in [*module.parameters(), *module.buffers()]:
        if t.is_floating_point():
            t.copy_(t.to(dtype))
    return module


def defense_astype(defense: nn.Module, dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """The defense with its floating weights cast to `dtype` and, where it
    has one (`MLVGMDefense`, `ClassifierDefense`), `compute_dtype` set; in
    place. A defense that computes in float32 whatever its weights
    (`weights_only_cast`: the noise and blur ablations) gets its weights
    rounded to `dtype` and kept in float32 (`round_floating`); so does the
    ND-VAE competitor, whose flax layers the JAX package runs in float32 on
    float32 inputs (but for its BatchNorms' coefficients, which flax
    computes in bfloat16: defenses/competitors.py). A defense that the JAX package cannot run in `dtype` at
    all (the A-VAE) names why in `cast_error`, and the cast raises it as a
    TypeError."""
    cast_error = getattr(defense, "cast_error", None)
    if cast_error is not None and dtype != torch.float32:
        raise TypeError(cast_error)
    if getattr(defense, "weights_only_cast", False):
        return round_floating(defense, dtype)
    cast_floating(defense, dtype)
    if hasattr(defense, "compute_dtype"):
        defense.compute_dtype = dtype
    return defense

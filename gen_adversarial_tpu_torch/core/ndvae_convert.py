"""Torch state dict -> flax variable tree of the ND-VAE competitor, the port's
copy of gen_adversarial_tpu/core/ndvae_convert.py (numpy only).

The reference builds its decoder's constant `h` as
nn.Parameter(...).unsqueeze(0), which is a plain tensor, not a parameter: it
is neither trained nor saved. The flax tree keeps `h` as a parameter, and
the JAX converter fills it with `jax.random.uniform(jax.random.PRNGKey(0),
shape)`; `jax_uniform_key0` computes those same float32 values in numpy
(threefry-2x32 in JAX's partitionable bit layout), so both converters write
the same file and `load_defense` reads it alike."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gen_adversarial_tpu_torch.core.torch_convert import take_bn, take_conv, take_linear


@dataclass(frozen=True)
class NDVAEArch:
    """The Defence_NVAE's architecture integers (the converter CLI's
    `--ndvae XCH ENC PREGROUPS SCALES GROUPS CELLS` and `--image-size`)."""
    x_channels: int
    encoding_channels: int
    pre_proc_groups: int
    scales: int
    groups: int
    cells: int
    input_dim: int

    @property
    def h_shape(self) -> tuple:
        """The decoder constant's NHWC shape, (1, r, r, channels)."""
        r = max(self.input_dim // 2 ** (self.scales + 1), 4)
        ch = self.encoding_channels * 2 ** self.pre_proc_groups * 2 ** (self.scales - 1)
        return (1, r, r, ch)


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of counter pairs (x0, x1) under
    the key (k0, k1), uint32 arrays, as jax._src.prng computes it."""
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    ks = (np.uint32(k0), np.uint32(k1), np.uint32(k0) ^ np.uint32(k1) ^ np.uint32(0x1BD11BDA))
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def jax_uniform_key0(shape: tuple) -> np.ndarray:
    """`jax.random.uniform(jax.random.PRNGKey(0), shape)` (float32 in [0,
    1)) in numpy: the 32 bits of element n are the xor of the hash of the
    counter pair (0, n) under the key (0, 0); their top 23 bits make the
    mantissa of a float in [1, 2), less 1."""
    n = int(np.prod(shape))
    with np.errstate(over="ignore"):
        b0, b1 = _threefry2x32(0, 0, np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))
    bits = (b0 ^ b1) >> np.uint32(9) | np.uint32(0x3F800000)
    return (bits.view(np.float32) - np.float32(1.0)).reshape(shape)


def _se(sd, prefix):
    return {"fc1": take_linear(sd, f"{prefix}.se.0"), "fc2": take_linear(sd, f"{prefix}.se.2")}


def _residual_cell(sd, prefix, stride):
    p, s = {}, {}
    p["bn1"], s["bn1"] = take_bn(sd, f"{prefix}.bn1")
    p["conv1"] = take_conv(sd, f"{prefix}.conv1")
    p["bn2"], s["bn2"] = take_bn(sd, f"{prefix}.bn2")
    p["conv2"] = take_conv(sd, f"{prefix}.conv2")
    p["se"] = _se(sd, f"{prefix}.squeeze_excitation")
    if stride == 2:
        p["skip"] = {f"conv_{i}": take_conv(sd, f"{prefix}.skip.conv_{i}") for i in (1, 2, 3, 4)}
    return p, s


def _generative_cell(sd, prefix, upsample=False):
    p, s = {}, {}
    p["bn1"], s["bn1"] = take_bn(sd, f"{prefix}.bn1")
    p["expand"] = take_conv(sd, f"{prefix}.expand")
    p["bn_expanded1"], s["bn_expanded1"] = take_bn(sd, f"{prefix}.bn_expanded1")
    p["dw"] = take_conv(sd, f"{prefix}.dep_sep_conv.depthwise")
    p["pw"] = take_conv(sd, f"{prefix}.dep_sep_conv.pointwise")
    p["bn_expanded2"], s["bn_expanded2"] = take_bn(sd, f"{prefix}.bn_expanded2")
    p["expand2"] = take_conv(sd, f"{prefix}.expand2")
    p["bn2"], s["bn2"] = take_bn(sd, f"{prefix}.bn2")
    p["se"] = _se(sd, f"{prefix}.squeeze_excitation")
    if upsample:
        p["skip_conv"] = take_conv(sd, f"{prefix}.skip.1")
    return p, s


def convert_ndvae(sd: dict, arch: NDVAEArch) -> dict:
    """The Defence_NVAE's state dict -> its flax variables (`h` as the JAX
    converter makes it: see the module)."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    params, stats = {}, {}
    params["stem"] = take_conv(sd, "stem")

    i = 0
    for g in range(arch.pre_proc_groups):
        for c in range(arch.cells):
            stride = 2 if c == arch.cells - 1 else 1
            params[f"pre_cells_{i}"], stats[f"pre_cells_{i}"] = _residual_cell(
                sd, f"pre_proc.tower.{g}.{c}", stride)
            i += 1

    for s_ in range(arch.scales):
        j = 0
        for g in range(arch.groups):
            for c in range(arch.cells):
                p, st = _residual_cell(sd, f"encoder.enc_tower.{s_}.{g}.{c}", 1)
                params[f"enc_scales_{s_}_{j}"], stats[f"enc_scales_{s_}_{j}"] = p, st
                j += 1
        if s_ < arch.scales - 1:
            p, st = _residual_cell(sd, f"encoder.enc_tower.{s_}.{arch.groups}", 2)
            params[f"enc_scales_{s_}_{j}"], stats[f"enc_scales_{s_}_{j}"] = p, st

    for idx in range(arch.scales):
        params[f"enc_combiners_{idx}"] = take_conv(sd, f"encoder.combiner_cells.{idx}.conv")
    for idx in range(arch.scales + 1):
        params[f"dec_combiners_{idx}"] = take_conv(sd, f"decoder.combiner_cells.{idx}.conv")
        params[f"samplers_{idx}"] = {
            "cell": take_conv(sd, f"decoder.samplers.{idx}.cell"),
            "prior_conv": take_conv(sd, f"decoder.samplers.{idx}.prior_cell.1")}

    for s_ in range(arch.scales):
        for g in range(arch.groups):
            for c in range(arch.cells):
                p, st = _generative_cell(sd, f"decoder.dec_tower.{s_}.{g}.group.{c}")
                params[f"dec_mods_{s_}_{g}_0_{c}"], stats[f"dec_mods_{s_}_{g}_0_{c}"] = p, st
            params[f"dec_mods_{s_}_{g}_1"] = take_conv(
                sd, f"decoder.dec_tower.{s_}.{g}.combiner.conv")
        if s_ != 0:
            p, st = _generative_cell(sd, f"decoder.dec_tower.{s_}.{arch.groups}", upsample=True)
            params[f"dec_mods_{s_}_{arch.groups}"] = p
            stats[f"dec_mods_{s_}_{arch.groups}"] = st

    i = 0
    for _ in range(arch.pre_proc_groups):
        for c in range(arch.cells):
            params[f"post_cells_{i}"], stats[f"post_cells_{i}"] = _generative_cell(
                sd, f"post_proc.tower.{i}", upsample=c == 0)
            i += 1

    params["image_conditional_conv"] = take_conv(sd, "image_conditional.1")
    params["h"] = jax_uniform_key0(arch.h_shape)
    return {"params": params, "batch_stats": stats}

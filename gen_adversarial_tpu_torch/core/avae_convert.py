"""Torch state dict -> flax variable tree of the A-VAE's StyledGenerator, the
port's copy of gen_adversarial_tpu/core/avae_convert.py (numpy only). The
reference's equalized learning rate stores each weight as `weight_orig` and
scales it at call time, as the port's model does, so weights copy over
unchanged (transposed to flax's layouts)."""

from __future__ import annotations

import numpy as np

from gen_adversarial_tpu_torch.models.avae.model import avae_generator_plan


def _eq_conv(sd, prefix):
    return {"weight": np.transpose(np.asarray(sd[f"{prefix}.conv.weight_orig"]), (2, 3, 1, 0)),
            "bias": np.asarray(sd[f"{prefix}.conv.bias"])}


def _eq_linear(sd, prefix):
    return {"weight": np.transpose(np.asarray(sd[f"{prefix}.linear.weight_orig"])),
            "bias": np.asarray(sd[f"{prefix}.linear.bias"])}


def _noise(sd, prefix):
    return {"weight": np.transpose(np.asarray(sd[f"{prefix}.weight_orig"]), (0, 2, 3, 1))}


def _adain(sd, prefix):
    return {"style": _eq_linear(sd, f"{prefix}.style")}


def _encode_block(sd, prefix):
    return {"conv1": _eq_conv(sd, f"{prefix}.conv1"), "conv2": _eq_conv(sd, f"{prefix}.conv2")}


def _styled_block(sd, prefix, initial, upsample, fused):
    p = {}
    if initial:
        p["const_input"] = np.transpose(np.asarray(sd[f"{prefix}.conv1.input"]), (0, 2, 3, 1))
    elif upsample and fused:  # FusedUpsample stores (in, out, k, k)
        p["conv1_fused"] = {
            "weight": np.transpose(np.asarray(sd[f"{prefix}.conv1.0.weight"]), (2, 3, 0, 1)),
            "bias": np.asarray(sd[f"{prefix}.conv1.0.bias"])}
    elif upsample:
        p["conv1"] = _eq_conv(sd, f"{prefix}.conv1.1")
    else:
        p["conv1"] = _eq_conv(sd, f"{prefix}.conv1")
    p["noise1"] = _noise(sd, f"{prefix}.noise1")
    p["adain1"] = _adain(sd, f"{prefix}.adain1")
    p["conv2"] = _eq_conv(sd, f"{prefix}.conv2")
    p["noise2"] = _noise(sd, f"{prefix}.noise2")
    p["adain2"] = _adain(sd, f"{prefix}.adain2")
    return p


def convert_avae(sd: dict, image_size: int) -> dict:
    """The StyledGenerator's state dict (the EMA g_running checkpoint the
    reference's defense loads) -> its flax variables."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    params = {"encoder": {}, "generator": {}}
    for blk in ("conv2", "conv3", "conv4"):
        params["encoder"][blk] = _encode_block(sd, f"encoder.{blk}")
    for i, (_, _, initial, upsample, fused) in enumerate(avae_generator_plan(image_size)):
        params["generator"][f"progression_{i}"] = _styled_block(
            sd, f"generator.progression.{i}", initial, upsample, fused)
    params["generator"]["to_rgb"] = _eq_conv(sd, "generator.to_rgb")
    # the style MLP: EqualLinears at the Sequential's indices 1, 3, 5, 7
    for j, idx in enumerate((1, 3, 5, 7)):
        params[f"style_layers_{j}"] = _eq_linear(sd, f"style.{idx}")
    return {"params": params}

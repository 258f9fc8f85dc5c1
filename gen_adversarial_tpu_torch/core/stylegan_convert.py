"""Torch state dicts -> flax variable trees for the StyleGAN2 stack, the
port's copy of gen_adversarial_tpu/core/stylegan_convert.py (numpy only):
the generator, the E4E encoder and the pSp checkpoint that holds both
(`convert_psp`: 'encoder.' / 'decoder.' keys and 'latent_avg'), the
Style-Transformer checkpoint (`convert_style_transformer`: the same under
'encoder.module.' / 'decoder.module.'), and the discriminator
(`convert_discriminator`). The trees are the JAX package's, leaf for leaf.
"""

from __future__ import annotations

import math

import numpy as np

from gen_adversarial_tpu_torch.core.torch_convert import linear_w, take_bn


def strip_prefix(sd: dict, name: str) -> dict:
    """The keys under `name.`, without it (the reference's get_keys); a
    checkpoint dict is looked into at its 'state_dict'."""
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k[len(name) + 1:]: np.asarray(v) for k, v in sd.items()
            if k.startswith(name + ".")}


def _equal_linear(sd, prefix):
    out = {"weight": linear_w(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"]
    return out


def _plain_conv(sd, prefix, bias=True):
    out = {"kernel": np.transpose(sd[f"{prefix}.weight"], (2, 3, 1, 0))}
    if bias and f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"]
    return out


def _equal_conv(sd, prefix, bias=True):
    out = {"weight": np.transpose(sd[f"{prefix}.weight"], (2, 3, 1, 0))}
    if bias and f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"]
    return out


def _mod_conv(sd, prefix):
    """ModulatedConv2d: weight (1, out, in, k, k) -> (k, k, in, out)."""
    w = sd[f"{prefix}.weight"][0]
    return {"weight": np.transpose(w, (2, 3, 1, 0)).copy(),
            "modulation": _equal_linear(sd, f"{prefix}.modulation")}


def _styled_conv(sd, prefix):
    return {"conv": _mod_conv(sd, f"{prefix}.conv"),
            "noise": {"weight": sd[f"{prefix}.noise.weight"]},
            "activate_bias": sd[f"{prefix}.activate.bias"]}


def _to_rgb(sd, prefix):
    return {"conv": _mod_conv(sd, f"{prefix}.conv"),
            "bias": np.transpose(sd[f"{prefix}.bias"], (0, 2, 3, 1))}


def convert_generator(sd: dict, size: int) -> dict:
    """A generator's state dict (prefix stripped) -> {'params', 'noise'}."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    params, noise = {}, {}
    for i in range(8):  # the style MLP
        params[f"style_{i}"] = _equal_linear(sd, f"style.{i + 1}")
    params["const_input"] = np.transpose(sd["input.input"], (0, 2, 3, 1))
    params["conv1"] = _styled_conv(sd, "conv1")
    params["to_rgb1"] = _to_rgb(sd, "to_rgb1")

    log_size = int(math.log2(size))
    n_pairs = log_size - 2
    for j in range(2 * n_pairs):
        params[f"convs_{j}"] = _styled_conv(sd, f"convs.{j}")
    for i in range(n_pairs):
        params[f"to_rgbs_{i}"] = _to_rgb(sd, f"to_rgbs.{i}")
    for i in range(2 * n_pairs + 1):
        noise[f"noise_{i}"] = np.transpose(sd[f"noises.noise_{i}"], (0, 2, 3, 1))
    return {"params": params, "noise": noise}


def _conv_layer(sd, prefix, downsample=False, activate=True, bias=True):
    """A ConvLayer, an nn.Sequential [Blur]? -> EqualConv2d -> [activation]?:
    the EqualConv2d sits at index 1 after a downsample Blur (whose fixed
    kernel buffer is not read), its activation's bias after it."""
    ci = 1 if downsample else 0
    out = {"conv": _equal_conv(sd, f"{prefix}.{ci}", bias=bias and not activate)}
    if activate and bias:
        out["activate_bias"] = sd[f"{prefix}.{ci + 1}.bias"]
    return out


def convert_discriminator(sd: dict, size: int) -> dict:
    """A discriminator's state dict (prefix stripped) -> {'params'} of
    models/stylegan2/discriminator.py."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    params = {"conv_in": _conv_layer(sd, "convs.0")}
    for n, i in enumerate(range(int(math.log2(size)), 2, -1), start=1):
        p = f"convs.{n}"
        params[f"res_{i}"] = {
            "conv1": _conv_layer(sd, f"{p}.conv1"),
            "conv2": _conv_layer(sd, f"{p}.conv2", downsample=True),
            "skip": _conv_layer(sd, f"{p}.skip", downsample=True, activate=False, bias=False),
        }
    params["final_conv"] = _conv_layer(sd, "final_conv")
    params["final_linear0"] = _equal_linear(sd, "final_linear.0")
    params["final_linear1"] = _equal_linear(sd, "final_linear.1")
    return {"params": params}


def _prelu(sd, prefix):
    return {"alpha": sd[f"{prefix}.weight"]}


def _irse_trunk(sd: dict) -> tuple:
    """The IR-SE input layer and body (E4E's and the Style-Transformer's)
    -> (params, batch_stats)."""
    p, s = {}, {}
    p["input_conv"] = _plain_conv(sd, "input_layer.0", bias=False)
    p["input_bn"], s["input_bn"] = take_bn(sd, "input_layer.1")
    p["input_prelu"] = _prelu(sd, "input_layer.2")
    i = 0
    while f"body.{i}.res_layer.1.weight" in sd:
        bp, bs = {}, {}
        bp["bn0"], bs["bn0"] = take_bn(sd, f"body.{i}.res_layer.0")
        bp["conv1"] = _plain_conv(sd, f"body.{i}.res_layer.1", bias=False)
        bp["prelu"] = _prelu(sd, f"body.{i}.res_layer.2")
        bp["conv2"] = _plain_conv(sd, f"body.{i}.res_layer.3", bias=False)
        bp["bn2"], bs["bn2"] = take_bn(sd, f"body.{i}.res_layer.4")
        bp["se"] = {"fc1": _plain_conv(sd, f"body.{i}.res_layer.5.fc1", bias=False),
                    "fc2": _plain_conv(sd, f"body.{i}.res_layer.5.fc2", bias=False)}
        if f"body.{i}.shortcut_layer.0.weight" in sd:
            bp["shortcut_conv"] = _plain_conv(sd, f"body.{i}.shortcut_layer.0", bias=False)
            bp["shortcut_bn"], bs["shortcut_bn"] = take_bn(sd, f"body.{i}.shortcut_layer.1")
        p[f"body_{i}"], s[f"body_{i}"] = bp, bs
        i += 1
    return p, s


def _gradual_style_block(sd, prefix, spatial):
    p = {}
    for i in range(int(math.log2(spatial))):
        p[f"conv{i}"] = _plain_conv(sd, f"{prefix}.convs.{2 * i}")
    p["linear"] = _equal_linear(sd, f"{prefix}.linear")
    return p


def convert_e4e_encoder(sd: dict, stylegan_size: int = 1024) -> dict:
    sd = {k: np.asarray(v) for k, v in sd.items()}
    params, stats = {}, {}
    params["trunk"], stats["trunk"] = _irse_trunk(sd)
    for i in range(int(2 * math.log2(stylegan_size) - 2)):
        spatial = 16 if i < 3 else 32 if i < 7 else 64
        params[f"style_{i}"] = _gradual_style_block(sd, f"styles.{i}", spatial)
    params["latlayer1"] = _plain_conv(sd, "latlayer1")
    params["latlayer2"] = _plain_conv(sd, "latlayer2")
    return {"params": params, "batch_stats": stats}


def convert_psp(ckpt: dict, stylegan_size: int = 1024) -> dict:
    """A whole E4E / pSp checkpoint -> the PSP's variables; a 1-D
    latent_avg is tiled over the generator's latents."""
    enc = convert_e4e_encoder(strip_prefix(ckpt, "encoder"), stylegan_size)
    gen = convert_generator(strip_prefix(ckpt, "decoder"), stylegan_size)
    latent_avg = np.asarray(ckpt["latent_avg"])
    if latent_avg.ndim == 1:
        n_latent = int(2 * math.log2(stylegan_size) - 2)
        latent_avg = np.tile(latent_avg[None], (n_latent, 1))
    return {
        "params": {"encoder": enc["params"], "decoder": gen["params"]},
        "batch_stats": {"encoder": enc["batch_stats"]},
        "noise": {"decoder": gen["noise"]},
        "buffers": {"latent_avg": latent_avg},
    }


def _mha(sd, prefix):
    return {"in_proj_weight": sd[f"{prefix}.in_proj_weight"],
            "in_proj_bias": sd[f"{prefix}.in_proj_bias"],
            "out_proj_weight": sd[f"{prefix}.out_proj.weight"],
            "out_proj_bias": sd[f"{prefix}.out_proj.bias"]}


def _ln(sd, prefix):
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _detr_layer(sd, prefix):
    return {"self_attn": _mha(sd, f"{prefix}.self_attn"),
            "multihead_attn": _mha(sd, f"{prefix}.multihead_attn"),
            "linear1": {"kernel": linear_w(sd[f"{prefix}.linear1.weight"]),
                        "bias": sd[f"{prefix}.linear1.bias"]},
            "linear2": {"kernel": linear_w(sd[f"{prefix}.linear2.weight"]),
                        "bias": sd[f"{prefix}.linear2.bias"]},
            "norm1": _ln(sd, f"{prefix}.norm1"),
            "norm2": _ln(sd, f"{prefix}.norm2"),
            "norm3": _ln(sd, f"{prefix}.norm3")}


def convert_style_transformer_encoder(sd: dict) -> dict:
    sd = {k: np.asarray(v) for k, v in sd.items()}
    params, stats = {}, {}
    params["trunk"], stats["trunk"] = _irse_trunk(sd)
    params["latlayer1"] = _plain_conv(sd, "latlayer1")
    params["latlayer2"] = _plain_conv(sd, "latlayer2")
    params["layer_coarse"] = _detr_layer(sd, "transformerlayer_coarse")
    params["layer_medium"] = _detr_layer(sd, "transformerlayer_medium")
    params["layer_fine"] = _detr_layer(sd, "transformerlayer_fine")
    params["z"] = sd["z"]
    return {"params": params, "batch_stats": stats}


def convert_style_transformer(ckpt: dict, output_size: int = 512) -> dict:
    """A Style-Transformer checkpoint ('encoder.module.' / 'decoder.module.'
    keys, or without 'module.') -> the StyleTransformer's variables;
    latent_avg zeros where the checkpoint has none."""
    enc_sd = strip_prefix(ckpt, "encoder.module") or strip_prefix(ckpt, "encoder")
    dec_sd = strip_prefix(ckpt, "decoder.module") or strip_prefix(ckpt, "decoder")
    enc = convert_style_transformer_encoder(enc_sd)
    gen = convert_generator(dec_sd, output_size)
    if "latent_avg" in ckpt:
        latent_avg = np.asarray(ckpt["latent_avg"])
    else:
        latent_avg = np.zeros((int(2 * math.log2(output_size) - 2), 512), np.float32)
    return {
        "params": {"encoder": enc["params"], "decoder": gen["params"]},
        "batch_stats": {"encoder": enc["batch_stats"]},
        "noise": {"decoder": gen["noise"]},
        "buffers": {"latent_avg": latent_avg},
    }

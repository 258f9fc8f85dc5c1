"""Reference-format state dicts made from flax variable trees, for testing
the checkpoint converters without the paper's released files (none is in the
repository, and none can be fetched). Each function here inverts one
converter of core/*_convert.py: it writes, under the reference's key names
and in torch's layouts, every key the converter reads, and no other key.
numpy only (no jax, no torch), so chip_smoke.py uses it too.

The tests hold the fabricator to the JAX converters: they read every key it
writes, and turn its dict back into the tree it was made from (exactly,
except a weight-norm form, which the fold rounds, and the flow cells'
masked taps, which the converter zeroes).

Weight-norm forms of a conv (`form`): 'plain' writes `.weight`; 'weight_g'
writes `.weight_g` (the per-output-channel norm, (O, 1, 1, 1)) and
`.weight_v` (the weight times a random positive per-channel factor);
'parametrizations' writes the same pair as
`.parametrizations.weight.original0` / `original1`.
"""

from __future__ import annotations

import math

import numpy as np

FORMS = ("plain", "weight_g", "parametrizations")
_OIHW = (2, 3, 1, 0)   # torch OIHW -> flax HWIO, as the converters transpose
_NHWC = (0, 2, 3, 1)   # torch NCHW -> flax NHWC


def _inv(a, axes) -> np.ndarray:
    """The array that np.transpose(., axes) maps onto `a`."""
    return np.ascontiguousarray(np.transpose(np.asarray(a), np.argsort(axes)))


class _Writer:
    def __init__(self, form: str = "plain", seed: int = 0):
        if form not in FORMS:
            raise ValueError(f"form {form!r}: one of {FORMS}")
        self.sd, self.form, self.rng = {}, form, np.random.RandomState(seed)

    def put(self, key: str, value) -> None:
        assert key not in self.sd, key
        self.sd[key] = np.asarray(value)

    def conv(self, prefix: str, leaf: dict, form: str | None = None) -> None:
        """A conv leaf {'kernel' HWIO, 'bias'?} in torch's OIHW, in the
        writer's weight-norm form unless `form` says otherwise."""
        w = _inv(leaf["kernel"], _OIHW)
        form = form or self.form
        if form == "plain":
            self.put(f"{prefix}.weight", w)
        else:
            norm = np.sqrt(np.sum(w.reshape(w.shape[0], -1) ** 2, axis=1))
            g = norm.reshape((-1,) + (1,) * (w.ndim - 1)).astype(w.dtype)
            scale = self.rng.uniform(0.5, 2.0, g.shape).astype(w.dtype)
            names = (("weight_g", "weight_v") if form == "weight_g"
                     else ("parametrizations.weight.original0",
                           "parametrizations.weight.original1"))
            self.put(f"{prefix}.{names[0]}", g)
            self.put(f"{prefix}.{names[1]}", w * scale)
        if "bias" in leaf:
            self.put(f"{prefix}.bias", leaf["bias"])

    def plain_conv(self, prefix: str, leaf: dict) -> None:
        self.conv(prefix, leaf, form="plain")

    def linear(self, prefix: str, leaf: dict, name: str = "kernel") -> None:
        self.put(f"{prefix}.weight", np.ascontiguousarray(np.asarray(leaf[name]).T))
        if "bias" in leaf:
            self.put(f"{prefix}.bias", leaf["bias"])

    def bn(self, prefix: str, params: dict, stats: dict) -> None:
        self.put(f"{prefix}.weight", params["scale"])
        self.put(f"{prefix}.bias", params["bias"])
        self.put(f"{prefix}.running_mean", stats["mean"])
        self.put(f"{prefix}.running_var", stats["var"])


# ------------------------------------------------------------ classifiers
def _projector(w: _Writer, prefix: str, p: dict, s: dict) -> None:
    w.linear(f"{prefix}.0", p["fc0"])
    w.bn(f"{prefix}.1", p["bn"], s["bn"])
    w.linear(f"{prefix}.3", p["fc1"])


def classifier_state_dict(tree: dict, model_type: str) -> dict:
    """A classifier's tree -> the reference trainer's 'state_dict' (keys
    under 'model.'): torchvision's VGG11-BN for 'vgg' (a plan with VGG11's
    pools, of any width), its ResNet50 / ResNeXt50 for 'resnet' /
    'resnext' (3, 4, 6, 3 blocks, of any width)."""
    p, s = tree["params"], tree["batch_stats"]
    w = _Writer()
    if model_type == "vgg":
        n_conv = sum(1 for k in p if k.startswith("conv"))
        t_idx = 0
        for i in range(n_conv):
            w.conv(f"model.features.{t_idx}", p[f"conv{i}"])
            w.bn(f"model.features.{t_idx + 1}", p[f"bn{i}"], s[f"bn{i}"])
            # VGG11's plan: a pool after convs 0, 1, 3, 5 and 7
            t_idx += 3 + (i in (0, 1, 3, 5, 7))
        _projector(w, "model.classifier", p["classifier"], s["classifier"])
        return w.sd
    if model_type not in ("resnet", "resnext"):
        raise ValueError(model_type)
    w.conv("model.conv1", p["conv1"])
    w.bn("model.bn1", p["bn1"], s["bn1"])
    for stage, n_blocks in enumerate((3, 4, 6, 3)):
        for i in range(n_blocks):
            tp, bp, bs = f"model.layer{stage + 1}.{i}", p[f"layer{stage + 1}_{i}"], \
                s[f"layer{stage + 1}_{i}"]
            for c in ("1", "2", "3"):
                w.conv(f"{tp}.conv{c}", bp[f"conv{c}"])
                w.bn(f"{tp}.bn{c}", bp[f"bn{c}"], bs[f"bn{c}"])
            if "downsample_conv" in bp:
                w.conv(f"{tp}.downsample.0", bp["downsample_conv"])
                w.bn(f"{tp}.downsample.1", bp["downsample_bn"], bs["downsample_bn"])
    _projector(w, "model.fc", p["fc"], s["fc"])
    return w.sd


# ------------------------------------------------------------ NVAE
def reference_ae_args(cfg) -> dict:
    """The reference's 'autoencoder' arguments of an NVAEConfig (what
    NVAEConfig.from_reference_dict reads)."""
    return {"initial_channels": cfg.initial_channels,
            "num_pre-post_process_blocks": cfg.n_pre_post_blocks,
            "num_pre-post_process_cells": cfg.n_pre_post_cells,
            "num_logistic_mixtures": cfg.num_mixtures, "num_scales": cfg.num_scales,
            "min_groups_per_scale": cfg.min_groups_per_scale,
            "num_groups_per_scale": cfg.num_groups_per_scale,
            "is_adaptive": cfg.is_adaptive, "num_cells_per_group": cfg.num_cells_per_group,
            "num_latent_per_group": cfg.num_latent_per_group, "num_nf_cells": cfg.num_nf_cells}


def _enc_cell(w, prefix, p, s):
    w.bn(f"{prefix}.residual.0", p["bn0"], s["bn0"])
    w.conv(f"{prefix}.residual.2", p["conv0"])
    w.bn(f"{prefix}.residual.3", p["bn1"], s["bn1"])
    w.conv(f"{prefix}.residual.5", p["conv1"])
    if "se" in p:
        w.linear(f"{prefix}.residual.6.linear_1", p["se"]["linear_1"])
        w.linear(f"{prefix}.residual.6.linear_2", p["se"]["linear_2"])
    if "skip" in p:
        w.conv(f"{prefix}.skip_connection.conv", p["skip"]["conv"])


def _dec_cell(w, prefix, p, s, upsampling):
    o = 1 if upsampling else 0
    w.bn(f"{prefix}.residual.{0 + o}", p["bn0"], s["bn0"])
    w.conv(f"{prefix}.residual.{1 + o}", p["conv_expand"])
    w.bn(f"{prefix}.residual.{2 + o}", p["bn1"], s["bn1"])
    w.conv(f"{prefix}.residual.{4 + o}", p["conv_depthwise"])
    w.bn(f"{prefix}.residual.{5 + o}", p["bn2"], s["bn2"])
    w.conv(f"{prefix}.residual.{7 + o}", p["conv_project"])
    w.bn(f"{prefix}.residual.{8 + o}", p["bn3"], s["bn3"])
    if "se" in p:
        w.linear(f"{prefix}.residual.{9 + o}.linear_1", p["se"]["linear_1"])
        w.linear(f"{prefix}.residual.{9 + o}.linear_2", p["se"]["linear_2"])
    if upsampling:
        w.conv(f"{prefix}.skip_connection.conv", p["skip"]["conv"])


def nvae_state_dict(tree: dict, cfg, form: str = "plain", seed: int = 0) -> dict:
    """An NVAE's tree (`cfg` an NVAEConfig of either package) -> the
    reference AutoEncoder's state dict, every conv in weight-norm `form`
    (see the module; `seed` draws the 'weight_v' factors)."""
    p, s = tree["params"], tree["batch_stats"]
    w = _Writer(form, seed)
    gps = cfg.groups_per_scale
    w.conv("preprocessing_block.init_conv", p["init_conv"])
    for b in range(cfg.n_pre_post_blocks):
        for c in range(cfg.n_pre_post_cells):
            _enc_cell(w, f"preprocessing_block.block_{b}.cell_{c}", p[f"pre_cells_{b}_{c}"],
                      s[f"pre_cells_{b}_{c}"])
    for s_ in range(cfg.num_scales - 1, -1, -1):
        for g in range(gps[s_]):
            for c in range(cfg.num_cells_per_group):
                name = f"enc_cells_{s_}_{g}_{c}"
                _enc_cell(w, f"encoder_tower.scale_{s_}.group_{g}.cell_{c}", p[name], s[name])
            if not (s_ == 0 and g == 0):
                w.conv(f"encoder_combiners.combiner_{s_}:{g}.conv",
                       p[f"enc_combiners_{s_}_{g}"]["conv"])
        if s_ > 0:
            _enc_cell(w, f"encoder_tower.scale_{s_}.downsampling", p[f"enc_cells_{s_}_down"],
                      s[f"enc_cells_{s_}_down"])
    w.conv("encoder_0.1", p["encoder_0_conv"])
    for s_ in range(cfg.num_scales):
        for g in range(gps[s_]):
            w.conv(f"enc_sampler.sampler_{s_}:{g}", p[f"enc_sampler_{s_}_{g}"])
            for i in range(cfg.num_nf_cells or 0):
                blk = p[f"nf_cells_{s_}_{g}_{i}"]
                for cell in ("cell1", "cell2"):
                    for name, idx in (("conv0", 0), ("conv1", 2), ("conv2", 4)):
                        w.conv(f"nf_cells.nf_{s_}:{g}.{i}.{cell}.layers.{idx}", blk[cell][name])
            if not (s_ == 0 and g == 0):
                w.conv(f"dec_sampler.sampler_{s_}:{g}.1", p[f"dec_sampler_{s_}_{g}"])
    for s_ in range(cfg.num_scales):
        for g in range(gps[s_]):
            if not (s_ == 0 and g == 0):
                for c in range(cfg.num_cells_per_group):
                    name = f"dec_cells_{s_}_{g}_{c}"
                    _dec_cell(w, f"decoder_tower.scale_{s_}.group_{g}.cell_{c}", p[name],
                              s[name], False)
            w.conv(f"decoder_combiners.combiner_{s_}:{g}.conv",
                   p[f"dec_combiners_{s_}_{g}"]["conv"])
        if s_ < cfg.num_scales - 1:
            _dec_cell(w, f"decoder_tower.scale_{s_}.upsampling", p[f"dec_cells_{s_}_up"],
                      s[f"dec_cells_{s_}_up"], True)
    for b in range(cfg.n_pre_post_blocks):
        for c in range(cfg.n_pre_post_cells):
            _dec_cell(w, f"postprocessing_block.block_{b}.cell_{c}", p[f"post_cells_{b}_{c}"],
                      s[f"post_cells_{b}_{c}"], c == 0)
    w.conv("to_logits.1", p["to_logits_conv"])
    w.put("const_prior", _inv(p["const_prior"], _NHWC))
    return w.sd


def nvae_checkpoint(tree: dict, cfg, temperature: float = 0.6, form: str = "plain",
                    seed: int = 0) -> dict:
    """The reference's NVAE checkpoint: {'configuration': {'autoencoder',
    'resolution'}, 'state_dict_temp=<t>': state dict}."""
    return {"configuration": {"autoencoder": reference_ae_args(cfg),
                              "resolution": (cfg.img_channels, cfg.resolution)},
            f"state_dict_temp={temperature}": nvae_state_dict(tree, cfg, form, seed)}


# ------------------------------------------------------------ StyleGAN2 stack
def _styled_conv_weight(w, prefix, leaf):
    w.put(f"{prefix}.weight", _inv(leaf["weight"], _OIHW)[None])
    w.linear(f"{prefix}.modulation", leaf["modulation"], name="weight")


def generator_state_dict(params: dict, noise: dict, size: int, prefix: str) -> dict:
    """A StyleGAN2 generator's params and noise -> its state dict, keys
    under `prefix`."""
    w = _Writer()
    for i in range(8):
        w.linear(f"{prefix}style.{i + 1}", params[f"style_{i}"], name="weight")
    w.put(f"{prefix}input.input", _inv(params["const_input"], _NHWC))
    n_pairs = int(math.log2(size)) - 2
    for name, key in [("conv1", "conv1")] + [(f"convs_{j}", f"convs.{j}")
                                             for j in range(2 * n_pairs)]:
        leaf = params[name]
        _styled_conv_weight(w, f"{prefix}{key}.conv", leaf["conv"])
        w.put(f"{prefix}{key}.noise.weight", leaf["noise"]["weight"])
        w.put(f"{prefix}{key}.activate.bias", leaf["activate_bias"])
    for name, key in [("to_rgb1", "to_rgb1")] + [(f"to_rgbs_{i}", f"to_rgbs.{i}")
                                                 for i in range(n_pairs)]:
        _styled_conv_weight(w, f"{prefix}{key}.conv", params[name]["conv"])
        w.put(f"{prefix}{key}.bias", _inv(params[name]["bias"], _NHWC))
    for i in range(2 * n_pairs + 1):
        w.put(f"{prefix}noises.noise_{i}", _inv(noise[f"noise_{i}"], _NHWC))
    return w.sd


def _irse_trunk(w, prefix, p, s):
    w.plain_conv(f"{prefix}input_layer.0", p["input_conv"])
    w.bn(f"{prefix}input_layer.1", p["input_bn"], s["input_bn"])
    w.put(f"{prefix}input_layer.2.weight", p["input_prelu"]["alpha"])
    i = 0
    while f"body_{i}" in p:
        bp, bs, k = p[f"body_{i}"], s[f"body_{i}"], f"{prefix}body.{i}"
        w.bn(f"{k}.res_layer.0", bp["bn0"], bs["bn0"])
        w.plain_conv(f"{k}.res_layer.1", bp["conv1"])
        w.put(f"{k}.res_layer.2.weight", bp["prelu"]["alpha"])
        w.plain_conv(f"{k}.res_layer.3", bp["conv2"])
        w.bn(f"{k}.res_layer.4", bp["bn2"], bs["bn2"])
        w.plain_conv(f"{k}.res_layer.5.fc1", bp["se"]["fc1"])
        w.plain_conv(f"{k}.res_layer.5.fc2", bp["se"]["fc2"])
        if "shortcut_conv" in bp:
            w.plain_conv(f"{k}.shortcut_layer.0", bp["shortcut_conv"])
            w.bn(f"{k}.shortcut_layer.1", bp["shortcut_bn"], bs["shortcut_bn"])
        i += 1


def psp_state_dict(tree: dict, stylegan_size: int) -> dict:
    """A PSP's (E4E + generator) tree -> the pSp checkpoint's 'state_dict'
    (keys under 'encoder.' and 'decoder.') with its 'latent_avg' beside the
    keys, as the converter CLI hands it to convert_psp."""
    pe, se = tree["params"]["encoder"], tree["batch_stats"]["encoder"]
    w = _Writer()
    _irse_trunk(w, "encoder.", pe["trunk"], se["trunk"])
    for i in range(int(2 * math.log2(stylegan_size) - 2)):
        blk = pe[f"style_{i}"]
        for j in range(sum(1 for k in blk if k.startswith("conv"))):
            w.plain_conv(f"encoder.styles.{i}.convs.{2 * j}", blk[f"conv{j}"])
        w.linear(f"encoder.styles.{i}.linear", blk["linear"], name="weight")
    w.plain_conv("encoder.latlayer1", pe["latlayer1"])
    w.plain_conv("encoder.latlayer2", pe["latlayer2"])
    sd = dict(w.sd)
    sd.update(generator_state_dict(tree["params"]["decoder"], tree["noise"]["decoder"],
                                   stylegan_size, "decoder."))
    sd["latent_avg"] = np.asarray(tree["buffers"]["latent_avg"])
    return sd


def style_transformer_state_dict(tree: dict, output_size: int,
                                 module_prefix: bool = True) -> dict:
    """A StyleTransformer's tree -> its checkpoint's 'state_dict' (keys under
    'encoder.module.' and 'decoder.module.', or without 'module.') with its
    'latent_avg' beside the keys."""
    pe, se = tree["params"]["encoder"], tree["batch_stats"]["encoder"]
    enc, dec = ("encoder.module.", "decoder.module.") if module_prefix else \
        ("encoder.", "decoder.")
    w = _Writer()
    _irse_trunk(w, enc, pe["trunk"], se["trunk"])
    w.plain_conv(f"{enc}latlayer1", pe["latlayer1"])
    w.plain_conv(f"{enc}latlayer2", pe["latlayer2"])
    for name in ("coarse", "medium", "fine"):
        layer, k = pe[f"layer_{name}"], f"{enc}transformerlayer_{name}"
        for attn in ("self_attn", "multihead_attn"):
            a = layer[attn]
            w.put(f"{k}.{attn}.in_proj_weight", a["in_proj_weight"])
            w.put(f"{k}.{attn}.in_proj_bias", a["in_proj_bias"])
            w.put(f"{k}.{attn}.out_proj.weight", a["out_proj_weight"])
            w.put(f"{k}.{attn}.out_proj.bias", a["out_proj_bias"])
        w.linear(f"{k}.linear1", layer["linear1"])
        w.linear(f"{k}.linear2", layer["linear2"])
        for norm in ("norm1", "norm2", "norm3"):
            w.put(f"{k}.{norm}.weight", layer[norm]["scale"])
            w.put(f"{k}.{norm}.bias", layer[norm]["bias"])
    w.put(f"{enc}z", pe["z"])
    sd = dict(w.sd)
    sd.update(generator_state_dict(tree["params"]["decoder"], tree["noise"]["decoder"],
                                   output_size, dec))
    sd["latent_avg"] = np.asarray(tree["buffers"]["latent_avg"])
    return sd


def _conv_layer(w, prefix, leaf, downsample=False):
    """A ConvLayer (nn.Sequential [Blur]? -> EqualConv2d -> [activation]?):
    the EqualConv2d at index 1 after a downsample Blur, whose fixed kernel
    buffer the converter does not read."""
    ci = 1 if downsample else 0
    w.put(f"{prefix}.{ci}.weight", _inv(leaf["conv"]["weight"], _OIHW))
    if "bias" in leaf["conv"]:
        w.put(f"{prefix}.{ci}.bias", leaf["conv"]["bias"])
    if "activate_bias" in leaf:
        w.put(f"{prefix}.{ci + 1}.bias", leaf["activate_bias"])


def discriminator_state_dict(params: dict, size: int) -> dict:
    """A StyleGAN2 discriminator's params -> its state dict."""
    w = _Writer()
    _conv_layer(w, "convs.0", params["conv_in"])
    for n, i in enumerate(range(int(math.log2(size)), 2, -1), start=1):
        block = params[f"res_{i}"]
        _conv_layer(w, f"convs.{n}.conv1", block["conv1"])
        _conv_layer(w, f"convs.{n}.conv2", block["conv2"], downsample=True)
        _conv_layer(w, f"convs.{n}.skip", block["skip"], downsample=True)
    _conv_layer(w, "final_conv", params["final_conv"])
    w.linear("final_linear.0", params["final_linear0"], name="weight")
    w.linear("final_linear.1", params["final_linear1"], name="weight")
    return w.sd


# ------------------------------------------------------------ A-VAE
def _eq_conv(w, prefix, leaf):
    w.put(f"{prefix}.conv.weight_orig", _inv(leaf["weight"], _OIHW))
    w.put(f"{prefix}.conv.bias", leaf["bias"])


def _eq_linear(w, prefix, leaf):
    w.put(f"{prefix}.linear.weight_orig", np.ascontiguousarray(np.asarray(leaf["weight"]).T))
    w.put(f"{prefix}.linear.bias", leaf["bias"])


def avae_state_dict(tree: dict) -> dict:
    """The A-VAE's StyledGenerator tree -> its (g_running) state dict."""
    p = tree["params"]
    w = _Writer()
    for blk in ("conv2", "conv3", "conv4"):
        for conv in ("conv1", "conv2"):
            _eq_conv(w, f"encoder.{blk}.{conv}", p["encoder"][blk][conv])
    i = 0
    while f"progression_{i}" in p["generator"]:
        b, k = p["generator"][f"progression_{i}"], f"generator.progression.{i}"
        if "const_input" in b:
            w.put(f"{k}.conv1.input", _inv(b["const_input"], _NHWC))
        elif "conv1_fused" in b:
            w.put(f"{k}.conv1.0.weight", _inv(b["conv1_fused"]["weight"], (2, 3, 0, 1)))
            w.put(f"{k}.conv1.0.bias", b["conv1_fused"]["bias"])
        else:  # every block after the first upsamples: its conv follows the Upsample
            _eq_conv(w, f"{k}.conv1.1", b["conv1"])
        for n in ("1", "2"):
            w.put(f"{k}.noise{n}.weight_orig", _inv(b[f"noise{n}"]["weight"], _NHWC))
            _eq_linear(w, f"{k}.adain{n}.style", b[f"adain{n}"]["style"])
        _eq_conv(w, f"{k}.conv2", b["conv2"])
        i += 1
    _eq_conv(w, "generator.to_rgb", p["generator"]["to_rgb"])
    for j, idx in enumerate((1, 3, 5, 7)):
        _eq_linear(w, f"style.{idx}", p[f"style_layers_{j}"])
    return w.sd


# ------------------------------------------------------------ ND-VAE
def _nd_se(w, prefix, p):
    w.linear(f"{prefix}.se.0", p["fc1"])
    w.linear(f"{prefix}.se.2", p["fc2"])


def _nd_residual(w, prefix, p, s):
    w.bn(f"{prefix}.bn1", p["bn1"], s["bn1"])
    w.conv(f"{prefix}.conv1", p["conv1"])
    w.bn(f"{prefix}.bn2", p["bn2"], s["bn2"])
    w.conv(f"{prefix}.conv2", p["conv2"])
    _nd_se(w, f"{prefix}.squeeze_excitation", p["se"])
    if "skip" in p:
        for i in (1, 2, 3, 4):
            w.conv(f"{prefix}.skip.conv_{i}", p["skip"][f"conv_{i}"])


def _nd_generative(w, prefix, p, s):
    w.bn(f"{prefix}.bn1", p["bn1"], s["bn1"])
    w.conv(f"{prefix}.expand", p["expand"])
    w.bn(f"{prefix}.bn_expanded1", p["bn_expanded1"], s["bn_expanded1"])
    w.conv(f"{prefix}.dep_sep_conv.depthwise", p["dw"])
    w.conv(f"{prefix}.dep_sep_conv.pointwise", p["pw"])
    w.bn(f"{prefix}.bn_expanded2", p["bn_expanded2"], s["bn_expanded2"])
    w.conv(f"{prefix}.expand2", p["expand2"])
    w.bn(f"{prefix}.bn2", p["bn2"], s["bn2"])
    _nd_se(w, f"{prefix}.squeeze_excitation", p["se"])
    if "skip_conv" in p:
        w.conv(f"{prefix}.skip.1", p["skip_conv"])


def ndvae_state_dict(tree: dict, pre_proc_groups: int, scales: int, groups: int,
                     cells: int) -> dict:
    """The ND-VAE's tree -> the reference Defence_NVAE's state dict (its
    decoder constant `h` is not saved: see core/ndvae_convert.py)."""
    p, s = tree["params"], tree["batch_stats"]
    w = _Writer()
    w.conv("stem", p["stem"])
    for i in range(pre_proc_groups * cells):
        _nd_residual(w, f"pre_proc.tower.{i // cells}.{i % cells}", p[f"pre_cells_{i}"],
                     s[f"pre_cells_{i}"])
    for s_ in range(scales):
        for j in range(groups * cells + (s_ < scales - 1)):
            k = f"encoder.enc_tower.{s_}." + (f"{j // cells}.{j % cells}" if j < groups * cells
                                              else f"{groups}")
            _nd_residual(w, k, p[f"enc_scales_{s_}_{j}"], s[f"enc_scales_{s_}_{j}"])
    for idx in range(scales):
        w.conv(f"encoder.combiner_cells.{idx}.conv", p[f"enc_combiners_{idx}"])
    for idx in range(scales + 1):
        w.conv(f"decoder.combiner_cells.{idx}.conv", p[f"dec_combiners_{idx}"])
        w.conv(f"decoder.samplers.{idx}.cell", p[f"samplers_{idx}"]["cell"])
        w.conv(f"decoder.samplers.{idx}.prior_cell.1", p[f"samplers_{idx}"]["prior_conv"])
    for s_ in range(scales):
        for g in range(groups):
            for c in range(cells):
                name = f"dec_mods_{s_}_{g}_0_{c}"
                _nd_generative(w, f"decoder.dec_tower.{s_}.{g}.group.{c}", p[name], s[name])
            w.conv(f"decoder.dec_tower.{s_}.{g}.combiner.conv", p[f"dec_mods_{s_}_{g}_1"])
        if s_ != 0:
            name = f"dec_mods_{s_}_{groups}"
            _nd_generative(w, f"decoder.dec_tower.{s_}.{groups}", p[name], s[name])
    for i in range(pre_proc_groups * cells):
        _nd_generative(w, f"post_proc.tower.{i}", p[f"post_cells_{i}"], s[f"post_cells_{i}"])
    w.conv("image_conditional.1", p["image_conditional_conv"])
    return w.sd

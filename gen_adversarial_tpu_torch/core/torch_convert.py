"""Torch state dicts (as {key: numpy array}) -> flax variable trees, the
port's copy of gen_adversarial_tpu/core/torch_convert.py (numpy only; the
converter CLI, cli/convert_checkpoints.py, does the torch.load). It covers
the reference's classifier checkpoints ({'state_dict': ...} of a torchvision
VGG11-BN, ResNet50 or ResNeXt50 under a 'model.' wrapper: `convert_classifier`)
and NVAE checkpoints ({'configuration', 'state_dict_temp=t'}: `convert_nvae`),
and the raw torchvision backbones of the classifier trainer's `--pretrained`
(`convert_torchvision_backbone`). The trees are the JAX package's, leaf for
leaf; `core/convert.from_jax_variables` loads them into the port's modules.

Layout rules: conv OIHW -> HWIO, linear (o, i) -> (i, o), BatchNorm
weight / bias / running_mean / running_var -> scale / bias / mean / var,
weight-norm parametrized convs folded (w = g * v / ||v||).
"""

from __future__ import annotations

import numpy as np

from gen_adversarial_tpu_torch.models.classifiers import VGG11_PLAN
from gen_adversarial_tpu_torch.models.nvae.cells import make_ar_mask


def conv_w(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def linear_w(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w))


def fold_weight_norm(sd: dict, prefix: str) -> np.ndarray:
    """A weight_norm parametrized conv's plain weight: torch >= 2 stores
    `parametrizations.weight.original0` (g) and `original1` (v), older
    checkpoints `weight_g` / `weight_v`; w = g * v / ||v|| per output
    channel."""
    p = f"{prefix}.parametrizations.weight"
    if f"{p}.original0" in sd:
        g, v = sd[f"{p}.original0"], sd[f"{p}.original1"]
    elif f"{prefix}.weight_g" in sd:
        g, v = sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"]
    else:
        return sd[f"{prefix}.weight"]
    norm = np.sqrt(np.sum(v.reshape(v.shape[0], -1) ** 2, axis=1))
    norm = norm.reshape((-1,) + (1,) * (v.ndim - 1))
    return g * v / np.maximum(norm, 1e-12)


def take_bn(sd: dict, prefix: str):
    params = {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}
    stats = {"mean": sd[f"{prefix}.running_mean"], "var": sd[f"{prefix}.running_var"]}
    return params, stats


def take_conv(sd: dict, prefix: str, bias: bool = True):
    out = {"kernel": conv_w(fold_weight_norm(sd, prefix))}
    if bias and f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"]
    return out


def take_linear(sd: dict, prefix: str, bias: bool = True):
    out = {"kernel": linear_w(sd[f"{prefix}.weight"])}
    if bias and f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"]
    return out


def _projector(sd: dict, prefix: str):
    """The 3-layer head: Sequential(Linear, BatchNorm1d, ReLU, Linear)."""
    params = {"fc0": take_linear(sd, f"{prefix}.0", bias=False),
              "fc1": take_linear(sd, f"{prefix}.3")}
    bnp, bns = take_bn(sd, f"{prefix}.1")
    params["bn"] = bnp
    return params, {"bn": bns}


def convert_resnet(sd: dict, layers=(3, 4, 6, 3), head: bool = True) -> dict:
    """torchvision resnet50 / resnext50 (keys under a 'model.' wrapper) ->
    ResNetBackbone variables; head=False converts the backbone only."""
    params, stats = {}, {}
    params["conv1"] = {"kernel": conv_w(sd["model.conv1.weight"])}
    params["bn1"], stats["bn1"] = take_bn(sd, "model.bn1")
    for stage, n_blocks in enumerate(layers):
        for i in range(n_blocks):
            tp = f"model.layer{stage + 1}.{i}"
            fp = f"layer{stage + 1}_{i}"
            bp, bs = {}, {}
            for c in ("1", "2", "3"):
                bp[f"conv{c}"] = {"kernel": conv_w(sd[f"{tp}.conv{c}.weight"])}
                bp[f"bn{c}"], bs[f"bn{c}"] = take_bn(sd, f"{tp}.bn{c}")
            if f"{tp}.downsample.0.weight" in sd:
                bp["downsample_conv"] = {"kernel": conv_w(sd[f"{tp}.downsample.0.weight"])}
                bp["downsample_bn"], bs["downsample_bn"] = take_bn(sd, f"{tp}.downsample.1")
            params[fp], stats[fp] = bp, bs
    if head:
        params["fc"], stats["fc"] = _projector(sd, "model.fc")
    return {"params": params, "batch_stats": stats}


def convert_vgg(sd: dict, plan=VGG11_PLAN, head: bool = True) -> dict:
    """torchvision vgg11_bn (keys under a 'model.' wrapper) -> VGG11BN
    variables; head=False converts the features only."""
    params, stats = {}, {}
    t_idx, conv_i = 0, 0
    for item in plan:
        if item == "M":
            t_idx += 1
            continue
        params[f"conv{conv_i}"] = take_conv(sd, f"model.features.{t_idx}")
        params[f"bn{conv_i}"], stats[f"bn{conv_i}"] = take_bn(sd, f"model.features.{t_idx + 1}")
        t_idx += 3
        conv_i += 1
    if head:
        params["classifier"], stats["classifier"] = _projector(sd, "model.classifier")
    return {"params": params, "batch_stats": stats}


def _enc_cell(sd: dict, prefix: str, downsampling: bool, use_se: bool = True):
    """The reference's ResidualCellEncoder: its residual Sequential is [BN,
    SiLU, conv, BN, SiLU, conv, SE?]; the skip is SkipDown.conv when it
    downsamples."""
    p, s = {}, {}
    p["bn0"], s["bn0"] = take_bn(sd, f"{prefix}.residual.0")
    p["conv0"] = take_conv(sd, f"{prefix}.residual.2")
    p["bn1"], s["bn1"] = take_bn(sd, f"{prefix}.residual.3")
    p["conv1"] = take_conv(sd, f"{prefix}.residual.5")
    if use_se:
        p["se"] = {"linear_1": take_linear(sd, f"{prefix}.residual.6.linear_1"),
                   "linear_2": take_linear(sd, f"{prefix}.residual.6.linear_2")}
    if downsampling:
        p["skip"] = {"conv": take_conv(sd, f"{prefix}.skip_connection.conv")}
    return p, s


def _dec_cell(sd: dict, prefix: str, upsampling: bool, use_se: bool = True):
    """The reference's ResidualCellDecoder: its residual Sequential is
    [Upsample?] + [BN, conv1x1, BN, SiLU, dwconv5x5, BN, SiLU, conv1x1, BN,
    SE?]."""
    o = 1 if upsampling else 0
    p, s = {}, {}
    p["bn0"], s["bn0"] = take_bn(sd, f"{prefix}.residual.{0 + o}")
    p["conv_expand"] = take_conv(sd, f"{prefix}.residual.{1 + o}", bias=False)
    p["bn1"], s["bn1"] = take_bn(sd, f"{prefix}.residual.{2 + o}")
    p["conv_depthwise"] = take_conv(sd, f"{prefix}.residual.{4 + o}", bias=False)
    p["bn2"], s["bn2"] = take_bn(sd, f"{prefix}.residual.{5 + o}")
    p["conv_project"] = take_conv(sd, f"{prefix}.residual.{7 + o}", bias=False)
    p["bn3"], s["bn3"] = take_bn(sd, f"{prefix}.residual.{8 + o}")
    if use_se:
        p["se"] = {"linear_1": take_linear(sd, f"{prefix}.residual.{9 + o}.linear_1"),
                   "linear_2": take_linear(sd, f"{prefix}.residual.{9 + o}.linear_2")}
    if upsampling:
        p["skip"] = {"conv": take_conv(sd, f"{prefix}.skip_connection.conv")}
    return p, s


def _nf_stack(sd: dict, prefix: str, n_blocks: int) -> dict:
    """nf_cells.nf_{s}:{g}, a Sequential of NFBlocks, each with cell1 and
    cell2 of MaskedConv2d layers at indices 0, 2 and 4. The stored weights
    may or may not be masked already; masking again changes nothing."""
    out = {}
    for i in range(n_blocks):
        blk = {}
        for cell, mirror in (("cell1", False), ("cell2", True)):
            cp = {}
            for name, idx, k, zero_diag in (("conv0", 0, 3, True), ("conv1", 2, 5, False),
                                            ("conv2", 4, 1, False)):
                conv = take_conv(sd, f"{prefix}.{i}.{cell}.layers.{idx}")
                mask = make_ar_mask(k, k, mirror, zero_diag)
                conv["kernel"] = conv["kernel"] * mask[:, :, None, None]
                cp[name] = conv
            blk[cell] = cp
        out[i] = blk
    return out


def convert_nvae(sd: dict, cfg) -> dict:
    """The reference NVAE's state dict (its module tree, weight-normed convs,
    SyncBatchNorms) -> the NVAE's flax variables; `cfg` is an NVAEConfig."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    params, stats = {}, {}
    gps = cfg.groups_per_scale

    params["init_conv"] = take_conv(sd, "preprocessing_block.init_conv")
    for b in range(cfg.n_pre_post_blocks):
        for c in range(cfg.n_pre_post_cells):
            last = c == cfg.n_pre_post_cells - 1
            p, s = _enc_cell(sd, f"preprocessing_block.block_{b}.cell_{c}",
                             downsampling=last, use_se=cfg.use_se)
            params[f"pre_cells_{b}_{c}"], stats[f"pre_cells_{b}_{c}"] = p, s

    for s_ in range(cfg.num_scales - 1, -1, -1):
        for g in range(gps[s_]):
            for c in range(cfg.num_cells_per_group):
                p, st = _enc_cell(sd, f"encoder_tower.scale_{s_}.group_{g}.cell_{c}",
                                  downsampling=False, use_se=cfg.use_se)
                params[f"enc_cells_{s_}_{g}_{c}"] = p
                stats[f"enc_cells_{s_}_{g}_{c}"] = st
            if not (s_ == 0 and g == 0):
                params[f"enc_combiners_{s_}_{g}"] = {
                    "conv": take_conv(sd, f"encoder_combiners.combiner_{s_}:{g}.conv")}
        if s_ > 0:
            p, st = _enc_cell(sd, f"encoder_tower.scale_{s_}.downsampling",
                              downsampling=True, use_se=cfg.use_se)
            params[f"enc_cells_{s_}_down"] = p
            stats[f"enc_cells_{s_}_down"] = st

    params["encoder_0_conv"] = take_conv(sd, "encoder_0.1")

    for s_ in range(cfg.num_scales):
        for g in range(gps[s_]):
            params[f"enc_sampler_{s_}_{g}"] = take_conv(sd, f"enc_sampler.sampler_{s_}:{g}")
            if cfg.num_nf_cells:  # 0 or None: empty flow Sequentials, nothing to map
                # flax names list entries '<name>_<index>': nf_cells_{s}_{g}_{i}
                for i, blk in _nf_stack(sd, f"nf_cells.nf_{s_}:{g}", cfg.num_nf_cells).items():
                    params[f"nf_cells_{s_}_{g}_{i}"] = blk
            if not (s_ == 0 and g == 0):
                params[f"dec_sampler_{s_}_{g}"] = take_conv(sd, f"dec_sampler.sampler_{s_}:{g}.1")

    for s_ in range(cfg.num_scales):
        for g in range(gps[s_]):
            if not (s_ == 0 and g == 0):
                for c in range(cfg.num_cells_per_group):
                    p, st = _dec_cell(sd, f"decoder_tower.scale_{s_}.group_{g}.cell_{c}",
                                      upsampling=False, use_se=cfg.use_se)
                    params[f"dec_cells_{s_}_{g}_{c}"] = p
                    stats[f"dec_cells_{s_}_{g}_{c}"] = st
            params[f"dec_combiners_{s_}_{g}"] = {
                "conv": take_conv(sd, f"decoder_combiners.combiner_{s_}:{g}.conv")}
        if s_ < cfg.num_scales - 1:
            p, st = _dec_cell(sd, f"decoder_tower.scale_{s_}.upsampling",
                              upsampling=True, use_se=cfg.use_se)
            params[f"dec_cells_{s_}_up"] = p
            stats[f"dec_cells_{s_}_up"] = st

    for b in range(cfg.n_pre_post_blocks):
        for c in range(cfg.n_pre_post_cells):
            p, st = _dec_cell(sd, f"postprocessing_block.block_{b}.cell_{c}",
                              upsampling=c == 0, use_se=cfg.use_se)
            params[f"post_cells_{b}_{c}"], stats[f"post_cells_{b}_{c}"] = p, st

    params["to_logits_conv"] = take_conv(sd, "to_logits.1")
    params["const_prior"] = np.transpose(sd["const_prior"], (0, 2, 3, 1))
    return {"params": params, "batch_stats": stats}


def convert_classifier(sd: dict, model_type: str) -> dict:
    """A reference classifier's state dict ('model.' wrapper) -> the flax
    tree of its model_type: 'resnet', 'resnext' or 'vgg'."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    if model_type in ("resnet", "resnext"):
        return convert_resnet(sd)
    if model_type == "vgg":
        return convert_vgg(sd)
    raise ValueError(model_type)


def convert_torchvision_backbone(sd: dict, model_type: str, init_variables: dict,
                                 **kw) -> dict:
    """ImageNet-pretrained initialization: `sd` is a raw torchvision state
    dict (no 'model.' wrapper, the 1000-class head still in it), which is
    dropped; the returned tree holds the converted backbone and the
    projector head of `init_variables` (a fresh model's flax tree,
    `core/convert.to_jax_variables`)."""
    head_name = "fc" if model_type in ("resnet", "resnext") else "classifier"
    sd = {f"model.{k}": np.asarray(v) for k, v in sd.items()
          if not k.startswith(f"{head_name}.")}
    if model_type in ("resnet", "resnext"):
        conv = convert_resnet(sd, head=False, **kw)
    elif model_type == "vgg":
        conv = convert_vgg(sd, head=False, **kw)
    else:
        raise ValueError(model_type)
    params = dict(conv["params"])
    stats = dict(conv["batch_stats"])
    params[head_name] = init_variables["params"][head_name]
    stats[head_name] = init_variables["batch_stats"][head_name]
    return {"params": params, "batch_stats": stats}

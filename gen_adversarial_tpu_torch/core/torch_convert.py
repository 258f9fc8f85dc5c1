"""torchvision state dicts -> flax variable trees (the part of
gen_adversarial_tpu/core/torch_convert.py that the classifier trainer's
`--pretrained` needs): `convert_torchvision_backbone` maps a raw torchvision
VGG11-BN, ResNet50 or ResNeXt50 state dict (as {key: numpy array}) onto the
classifiers' flax variable tree with a fresh projector head, which
`core/convert.from_jax_variables` loads into the port's module. The tree is
the JAX package's, leaf for leaf.

Layout rules: conv OIHW -> HWIO, linear (o, i) -> (i, o), BatchNorm
weight / bias / running_mean / running_var -> scale / bias / mean / var,
weight-norm parametrized convs folded (w = g * v / ||v||).
"""

from __future__ import annotations

import numpy as np

from gen_adversarial_tpu_torch.models.classifiers import VGG11_PLAN


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

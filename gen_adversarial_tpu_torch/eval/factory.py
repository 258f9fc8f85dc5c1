"""Defense factory (counterpart of gen_adversarial_tpu/eval/factory.py): a
config file of configs/ -> the defense, on the device, with its experiment's
attack suite.

The config's name gives the defense type and the experiment
(`core/config.defense_type_of`, `experiment_of`); its checkpoint paths point
at flax msgpack files (`core/checkpoint.py`), which load into the port's
modules through `core/convert.from_jax_variables`. Modules are built on the
meta device and filled on the target device, so nothing weight-sized is
made twice on the host. The model constructors are module-level names
(`make_classifier`, `NVAE`, `PSP`, `StyleTransformer`, `StyledGenerator`,
`DefenceNVAE`), so a test can build smaller models in their place.

The flagship (`flagship.py`), gender (`gender.py`) and cars (`cars.py`)
builders make the same defenses with random weights from a seed.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from functools import partial

import numpy as np
import torch
from torch import nn

from gen_adversarial_tpu_torch.attacks import autoattack, cw_attack, deepfool_attack
from gen_adversarial_tpu_torch.core.checkpoint import load_variables
from gen_adversarial_tpu_torch.core.distributed import local_device
from gen_adversarial_tpu_torch.core.config import (
    ATTACK_SUITES, IMAGE_SIZE, N_CLASSES, DefenseConfig, defense_type_of, experiment_of)
from gen_adversarial_tpu_torch.core.convert import from_jax_variables
from gen_adversarial_tpu_torch.core.precision import defense_astype
from gen_adversarial_tpu_torch.defenses.ablations import (
    GaussianBlurDefense, GaussianNoiseDefense)
from gen_adversarial_tpu_torch.defenses.base import (
    ClassifierDefense, MLVGMDefense, make_classifier_apply)
from gen_adversarial_tpu_torch.defenses.competitors import AVaeDefense, NDVaeDefense
from gen_adversarial_tpu_torch.defenses.eot import eot_wrap
from gen_adversarial_tpu_torch.defenses.purify import (
    make_e4e_purify_split, make_nvae_purify_split, make_trans_purify_split)
from gen_adversarial_tpu_torch.models.avae.model import StyledGenerator
from gen_adversarial_tpu_torch.models.classifiers import make_classifier
from gen_adversarial_tpu_torch.models.e4e.psp import PSP
from gen_adversarial_tpu_torch.models.ndvae.model import DefenceNVAE
from gen_adversarial_tpu_torch.models.nvae.model import NVAE, NVAEConfig
from gen_adversarial_tpu_torch.models.style_transformer.model import StyleTransformer

CLASSIFIER_TYPE = {"gender": "resnet", "ids": "vgg", "cars": "resnext"}
NVAE_TEMPERATURE = 0.6
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class LoadedDefense:
    experiment: str
    defense_type: str
    image_size: int
    n_classes: int
    defense: nn.Module               # callable(x, draws, preds_only)
    eot_steps: int
    eot_chunk: int | None
    attacks: dict                    # name -> attack(net, images, labels, generator)
    dtype: str = "float32"           # part of the harness's resume fingerprint
    device: torch.device = field(default_factory=lambda: torch.device("cuda"))

    @property
    def net(self):
        """The EoT-wrapped logits: net(x, draws) (defenses/eot.py)."""
        return eot_wrap(self.defense, self.eot_steps, chunk=self.eot_chunk)

    def get_purified(self, x, draws):
        return self.defense.get_purified(x, draws)


def build_attacks(experiment: str, n_classes: int, deepfool_chunk: int | None = None,
                  fab_chunk: int | None = None) -> dict:
    """name -> attack(net, images, labels, generator). deepfool_chunk and
    fab_chunk are the class-jacobian blocks (attacks/utils.class_grads) of
    DeepFool and of AutoAttack's FAB: the same results, less live memory."""
    s = ATTACK_SUITES[experiment]
    return {
        "deepfool": partial(deepfool_attack, num_classes=s.deepfool_num_classes,
                            overshoot=s.deepfool_overshoot, max_iter=s.deepfool_max_iter,
                            cotangent_chunk=deepfool_chunk),
        "c&w": partial(cw_attack, c=s.cw_c, kappa=s.cw_kappa, steps=s.cw_steps, lr=s.cw_lr,
                       n_restarts=s.cw_n_restarts,
                       early_stopping_steps=s.cw_early_stopping_steps),
        "autoattack": partial(autoattack, n_classes=n_classes, cotangent_chunk=fab_chunk),
    }


def _on_device(build, variables: dict, device: torch.device) -> nn.Module:
    """build(device) made on the meta device, then filled from the flax
    variables on `device`, frozen, in eval mode, channels_last."""
    with torch.device("meta"):
        module = build("meta")
    module = module.to_empty(device=device)
    for t in module.buffers():
        if not t.is_floating_point():  # BatchNorm's num_batches_tracked
            t.zero_()
    from_jax_variables(variables, module)
    return module.requires_grad_(False).eval().to(memory_format=torch.channels_last)


def load_classifier_parts(experiment: str, path: str, device="cuda"):
    """(classifier, classifier_apply) of an experiment from its checkpoint."""
    variables, _ = load_variables(path)
    model = _on_device(lambda d: make_classifier(CLASSIFIER_TYPE[experiment],
                                                 N_CLASSES[experiment], device=d),
                       variables, torch.device(device))
    return model, make_classifier_apply(model)


def _ours_components(experiment: str, variables: dict, meta: dict, device: torch.device):
    """(purifier, (encode, decode), normalize_before_purify)."""
    if experiment == "gender":
        model = _on_device(lambda d: PSP(1024, device=d), variables, device)
        return model, make_e4e_purify_split(model), True
    if experiment == "ids":
        cfg = NVAEConfig(**meta["config"]) if "config" in meta else NVAEConfig()
        model = _on_device(lambda d: NVAE(cfg, device=d), variables, device)
        return model, make_nvae_purify_split(model, NVAE_TEMPERATURE), False
    model = _on_device(lambda d: StyleTransformer(512, device=d), variables, device)
    return model, make_trans_purify_split(model), True


def resolve_device(device, who: str) -> torch.device:
    """torch.device(device); 'cuda' without CUDA raises, naming `who`.
    Under torchrun a bare 'cuda' is this process's GPU, cuda:LOCAL_RANK
    (core/distributed.local_device)."""
    device = local_device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: device 'cuda' asked for, but CUDA is not available "
                           "(pass device='cpu' to run on the CPU)")
    return device


def load_defense(config_path: str, eot_steps: int = 32, eot_chunk: int | None = None,
                 remat: bool | None = None, remat_policy: str | None = None,
                 dtype: str | None = None, device="cuda") -> LoadedDefense:
    """The defense named by a config file (its name encodes the defense type
    and the experiment, e.g. ours_cosine_noise_cars.yaml), on `device`
    ('cuda' unless the caller asks for the CPU; without CUDA, 'cuda' raises).

    remat defaults to on for the StyleGAN2 families (gender, cars), whose
    attack gradients do not fit without it; a remat_policy turns it on.
    dtype 'bfloat16' casts the defense once (core/precision.defense_astype;
    the A-VAE raises, as the JAX package's does once its weights are traced);
    the attacks' math stays float32. The competitors (A-VAE, ND-VAE) run at
    the caller's eot_steps, without remat. As in the JAX package, the
    environment's GAT_DF_COT_CHUNK sets DeepFool's cotangent_chunk and
    GAT_COT_CHUNK AutoAttack's FAB's (0 or unset: None, which for FAB is
    attacks/autoattack.fab_block's block); under a remat_policy
    the forwards that are differentiated in blocks recompute their purifier
    whole (defenses/base.py)."""
    device = resolve_device(device, "load_defense")
    if dtype is not None and dtype not in DTYPES:
        raise ValueError(f"dtype {dtype!r}: one of {sorted(DTYPES)}")
    deepfool_chunk = int(os.environ.get("GAT_DF_COT_CHUNK", "0")) or None
    fab_chunk = int(os.environ.get("GAT_COT_CHUNK", "0")) or None
    cfg = DefenseConfig.from_yaml(config_path)
    defense_type = defense_type_of(config_path)
    experiment = experiment_of(config_path)
    image_size = IMAGE_SIZE[experiment]
    n_classes = N_CLASSES[experiment]

    clf, clf_apply = load_classifier_parts(experiment, cfg.classifier_path, device)
    attacks = build_attacks(experiment, n_classes, deepfool_chunk, fab_chunk)

    if defense_type in ("base", "trades"):
        # a deterministic model: EoT over it changes nothing but costs eot_steps x
        defense = ClassifierDefense(clf, clf_apply)
        eot_steps = 1
    elif defense_type == "ablation":
        if cfg.type == "noise":
            defense = GaussianNoiseDefense(clf, clf_apply,
                                           eps=2.0 if experiment == "ids" else 4.0)
        else:
            defense = GaussianBlurDefense(clf, clf_apply, image_size)
    elif defense_type == "A-VAE":
        variables, _ = load_variables(cfg.autoencoder_path)
        model = _on_device(lambda d: StyledGenerator(image_size, device=d), variables, device)
        defense = AVaeDefense(model, clf, clf_apply, cfg.kernel_size)
    elif defense_type == "ND-VAE":
        variables, _ = load_variables(cfg.autoencoder_path)
        model = _on_device(lambda d: DefenceNVAE(
            x_channels=cfg.x_channels, encoding_channels=cfg.encoding_channels,
            pre_proc_groups=cfg.pre_proc_groups, scales=cfg.scales, groups=cfg.groups,
            cells=cfg.cells, input_dim=image_size, device=d), variables, device)
        defense = NDVaeDefense(model, clf, clf_apply, cfg.noise_std)
    elif defense_type == "ours":
        alphas = (np.asarray(cfg.interpolation_alphas, np.float32)
                  * np.float32(cfg.alpha_attenuation))
        variables, meta = load_variables(cfg.autoencoder_path)
        purifier, (encode, decode), normalize = _ours_components(
            experiment, variables, meta, device)
        if remat is None:
            remat = experiment in ("gender", "cars")
        if remat_policy is not None:
            remat = True  # a policy only acts under remat
        defense = MLVGMDefense(
            purifier=purifier, classifier=clf, alphas=torch.as_tensor(alphas, device=device),
            purify_encode=encode, purify_decode=decode, classifier_apply=clf_apply,
            initial_noise_eps=cfg.initial_noise_eps, normalize_before_purify=normalize,
            apply_blur=cfg.gaussian_blur_input, image_size=image_size, remat=remat,
            remat_policy=remat_policy)
    else:
        raise NotImplementedError(defense_type)

    if dtype is not None and dtype != "float32":
        defense = defense_astype(defense, DTYPES[dtype])
    return LoadedDefense(experiment, defense_type, image_size, n_classes, defense, eot_steps,
                         eot_chunk, attacks, dtype=dtype or "float32", device=device)


def load_ours_for_search(config_path: str, device="cuda"):
    """For the alpha search: the 'ours' defense's classifier and purifier
    loaded once (as load_defense loads them), and (experiment, image_size,
    make_defense). make_defense(alphas) returns an MLVGMDefense over those
    modules with the given (already attenuated) alphas, initial noise eps
    0.0, no blur and the family's normalize_before_purify; the search
    (search/alphas.AlphaEvaluator) then writes its alphas buffer in place."""
    device = resolve_device(device, "load_ours_for_search")
    if defense_type_of(config_path) != "ours":
        raise ValueError(f"{config_path}: the alpha search takes an ours_* config")
    cfg = DefenseConfig.from_yaml(config_path)
    experiment = experiment_of(config_path)
    image_size = IMAGE_SIZE[experiment]
    clf, clf_apply = load_classifier_parts(experiment, cfg.classifier_path, device)
    variables, meta = load_variables(cfg.autoencoder_path)
    purifier, (encode, decode), normalize = _ours_components(experiment, variables, meta,
                                                             device)

    def make_defense(alphas):
        return MLVGMDefense(
            purifier=purifier, classifier=clf,
            alphas=torch.as_tensor(np.asarray(alphas, np.float32), device=device),
            purify_encode=encode, purify_decode=decode, classifier_apply=clf_apply,
            initial_noise_eps=0.0, normalize_before_purify=normalize, apply_blur=False,
            image_size=image_size)

    return experiment, image_size, make_defense

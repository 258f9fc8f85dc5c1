"""The configuration layer (the port's copy of gen_adversarial_tpu/core/config.py,
which imports yaml; the port imports nothing of the JAX package): the
experiments' constants, each experiment's attack hyperparameters, the
`DefenseConfig` schema of the files in configs/ with a reader of their flat
YAML subset, and the config-name rules `defense_type_of` and `experiment_of`.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path

EXPERIMENTS = ("gender", "ids", "cars")

# image side per experiment
IMAGE_SIZE = {"gender": 256, "ids": 64, "cars": 128}
# classes per experiment
N_CLASSES = {"gender": 2, "ids": 100, "cars": 4}
# latent hierarchy depth per experiment: 18 w-vectors for the 1024-px
# StyleGAN2 (gender), 24 NVAE groups (ids), 16 w-vectors for the 512-px
# StyleGAN2 (cars)
N_LATENTS = {"gender": 18, "ids": 24, "cars": 16}


@dataclass(frozen=True)
class AttackSuiteConfig:
    """DeepFool's and C&W's hyperparameters for one experiment."""
    deepfool_num_classes: int
    deepfool_overshoot: float
    deepfool_max_iter: int
    cw_c: float
    cw_kappa: float
    cw_steps: int
    cw_lr: float
    cw_n_restarts: int
    cw_early_stopping_steps: int


ATTACK_SUITES = {
    "gender": AttackSuiteConfig(2, 0.01, 1024, 64.0, 0.01, 1024, 1e-3, 8, 32),
    "ids": AttackSuiteConfig(8, 0.02, 128, 16.0, 0.05, 1024, 5e-3, 8, 16),
    "cars": AttackSuiteConfig(4, 0.02, 256, 24.0, 0.02, 1024, 2e-3, 8, 16),
}

# YAML 1.1 scalars, as yaml.safe_load resolves them (a float needs a dot)
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_INF_NAN = {".inf": float("inf"), "+.inf": float("inf"), "-.inf": float("-inf"),
            ".nan": float("nan")}
_BOOL = {"true": True, "yes": True, "on": True, "false": False, "no": False, "off": False}
_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_]*):(\s+(.*))?$")


def _scalar(text: str, where: str):
    """One plain or quoted YAML scalar."""
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if text[:1] in "[]{}&*!|>'\"%@`":
        raise ValueError(f"{where}: unsupported YAML construct {text!r}")
    low = text.lower()
    if low in ("", "~", "null"):
        return None
    if low in _BOOL and text in (low, low.capitalize(), low.upper()):
        return _BOOL[low]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text) and text not in (".", "+.", "-."):
        return float(text.replace("_", ""))
    if low in _INF_NAN:
        return _INF_NAN[low]
    return text


def read_flat_yaml(path: str | Path) -> dict:
    """The flat YAML of configs/: `key: scalar` lines and `- item` lists under
    a `key:` line, with comments and blank lines. Any other construct raises,
    naming the file and the line."""
    out: dict = {}
    current = None  # the key whose `- item` lines follow
    for n, line in enumerate(Path(path).read_text(encoding="utf-8").splitlines(), 1):
        where = f"{path}:{n}"
        text = re.sub(r"(^|\s)#.*$", "", line).rstrip()
        if not text.strip() or text.strip() == "---":
            continue
        if text.startswith("- ") or text == "-":
            if current is None:
                raise ValueError(f"{where}: a list item outside a list")
            out[current].append(_scalar(text[1:].strip(), where))
            continue
        m = _KEY.match(text)
        if m is None:
            raise ValueError(f"{where}: unsupported YAML construct {line!r}")
        key, value = m.group(1), (m.group(3) or "").strip()
        if key in out:
            raise ValueError(f"{where}: key {key!r} given twice")
        if value:
            out[key], current = _scalar(value, where), None
        else:
            out[key], current = [], key
    # a key with no items is YAML's null
    return {k: (None if v == [] else v) for k, v in out.items()}


@dataclass
class DefenseConfig:
    """Schema covering every defense YAML in configs/."""
    classifier_path: str = ""
    autoencoder_path: str = ""
    # 'ours'
    interpolation_alphas: list[float] = field(default_factory=list)
    alpha_attenuation: float = 1.0
    initial_noise_eps: float = 0.0
    gaussian_blur_input: bool = False
    # ablation
    type: str = ""  # 'noise' | 'blur'
    # A-VAE
    kernel_size: int = 0
    # ND-VAE
    noise_std: float = 0.0
    x_channels: int = 3
    pre_proc_groups: int = 2
    encoding_channels: int = 16
    scales: int = 2
    groups: int = 2
    cells: int = 4

    @classmethod
    def from_yaml(cls, path: str | Path) -> "DefenseConfig":
        """The config of a file in configs/; unknown keys are dropped."""
        raw = read_flat_yaml(path)
        return cls(**{k: v for k, v in raw.items() if k in cls.__dataclass_fields__})


def defense_type_of(config_name: str) -> str:
    """Map a config file name to the defense type (one of base, ablation,
    A-VAE, ND-VAE, trades, ours)."""
    stem = Path(config_name).stem
    if stem.startswith("no_defense"):
        return "base"
    if stem.startswith("ablation"):
        return "ablation"
    if stem.startswith("competitor_avae"):
        return "A-VAE"
    if stem.startswith("competitor_ndvae"):
        return "ND-VAE"
    if stem.startswith("competitor_trades"):
        return "trades"
    if stem.startswith("ours"):
        return "ours"
    raise ValueError(f"unknown config family: {config_name}")


def experiment_of(config_name: str) -> str:
    stem = Path(config_name).stem
    for exp in EXPERIMENTS:
        if stem.endswith("_" + exp):
            return exp
    raise ValueError(f"config name does not end in an experiment: {config_name}")

"""The port's config layer (gen_adversarial_tpu_torch/core/config.py, which
reads the flat YAML of configs/ without yaml) against the JAX package's on
every config file: `DefenseConfig.from_yaml` (value and type of every
field), `defense_type_of` and `experiment_of`; the constants; and the
reader's refusals."""

import dataclasses
from pathlib import Path

import pytest

from gen_adversarial_tpu.core import config as jax_config
from gen_adversarial_tpu_torch.core import config

CONFIGS = sorted((Path(__file__).resolve().parent.parent / "configs").glob("*.yaml"))


def test_the_repository_has_45_configs():
    assert len(CONFIGS) == 45


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_config_reader_matches_jax(path):
    got = dataclasses.asdict(config.DefenseConfig.from_yaml(path))
    want = dataclasses.asdict(jax_config.DefenseConfig.from_yaml(path))
    assert got == want
    assert {k: type(v) for k, v in got.items()} == {k: type(v) for k, v in want.items()}
    assert [type(a) for a in got["interpolation_alphas"]] == \
        [type(a) for a in want["interpolation_alphas"]]
    assert config.defense_type_of(path.name) == jax_config.defense_type_of(path.name)
    assert config.experiment_of(path.name) == jax_config.experiment_of(path.name)


def test_constants_match_jax():
    assert config.EXPERIMENTS == jax_config.EXPERIMENTS
    assert config.IMAGE_SIZE == jax_config.IMAGE_SIZE
    assert config.N_CLASSES == jax_config.N_CLASSES
    assert config.N_LATENTS == jax_config.N_LATENTS
    assert {f.name for f in dataclasses.fields(config.DefenseConfig)} == \
        {f.name for f in dataclasses.fields(jax_config.DefenseConfig)}


def test_scalars_resolve_as_yaml_does(tmp_path):
    """YAML 1.1 scalars as yaml.safe_load resolves them (1e-3 without a dot
    is a string there), comments, quotes, an unknown key dropped."""
    text = ("# a comment\nclassifier_path: 'a b.msgpack'  # trailing\n"
            "autoencoder_path: /x/y\ninitial_noise_eps: 1e-3\nalpha_attenuation: 2.\n"
            "gaussian_blur_input: True\nkernel_size: 8\nunknown_key: 3\n"
            "interpolation_alphas:\n- 0\n- .5\n- -1.5e+2\n")
    path = tmp_path / "ours_x_ids.yaml"
    path.write_text(text)
    got = dataclasses.asdict(config.DefenseConfig.from_yaml(path))
    assert got == dataclasses.asdict(jax_config.DefenseConfig.from_yaml(path))
    assert got["initial_noise_eps"] == "1e-3" and got["interpolation_alphas"] == [0, 0.5, -150.0]


@pytest.mark.parametrize("text,line", [
    ("classifier_path: a\nnested:\n  key: 1\n", 3),
    ("interpolation_alphas: [0.1, 0.2]\n", 1),
    ("- 0.1\n", 1),
    ("type: noise\ntype: blur\n", 2),
])
def test_unsupported_yaml_raises_with_file_and_line(tmp_path, text, line):
    path = tmp_path / "ablation_noise_ids.yaml"
    path.write_text(text)
    with pytest.raises(ValueError, match=f"ablation_noise_ids.yaml:{line}"):
        config.DefenseConfig.from_yaml(path)

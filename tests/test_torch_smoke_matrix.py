"""The config matrix (gen_adversarial_tpu_torch/smoke_all_configs.py) on the
CPU, small: the factory's module-level constructors build small models
(the tiny VGG of tests/test_torch_factory.py, ResNets of one block a stage,
the PSP and the Style-Transformer at a 32-px generator, a narrow ND-VAE),
the twin's NVAE is test_torch_factory's small one (4 latent groups), and
the configs are copies of configs/ with the ours_* alphas resampled to the
small purifiers' latents. One run of `main` over one config of each kind,
with one config's fabrication made to raise; then a rerun. The twin's ids
files and two of its config copies are held against the JAX package. Then
`--cli-defaults` on four kinds at a batch of 4 and EoT-4.

The files are made from seed MATRIX_SEED, where every row's images start
misclassified, so DeepFool takes no step (its steps are held to JAX in
tests/test_torch_attack_defense.py): at the twin's seed 0 the small cars
classifier gets both images right, and DeepFool's steps through the
192 x 256 IR-SE-50 encoder (cars) and the ND-VAE cars row's 256 steps took
about 64 and 684 s of CPU."""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gen_adversarial_tpu.eval.factory as jax_factory
import gen_adversarial_tpu_torch.eval.factory as factory
import gen_adversarial_tpu_torch.smoke_all_configs as smoke
from gen_adversarial_tpu.core.checkpoint import load_variables as jax_load
from gen_adversarial_tpu_torch.core.config import read_flat_yaml
from gen_adversarial_tpu_torch.core.convert import to_jax_variables
from gen_adversarial_tpu_torch.flagship import init_tensor_
from gen_adversarial_tpu_torch.gender import resampled_alphas
from gen_adversarial_tpu_torch.models.classifiers import ResNetBackbone, VGG11BN
from gen_adversarial_tpu_torch.models.e4e.psp import PSP
from gen_adversarial_tpu_torch.models.ndvae.model import DefenceNVAE
from gen_adversarial_tpu_torch.models.nvae.model import NVAEConfig
from gen_adversarial_tpu_torch.models.style_transformer.model import StyleTransformer
from tests.test_torch_factory import (  # noqa: F401  (tiny_classifier: a fixture)
    EOT, KEY, NVAE_CFG, TINY_PLAN, TOL, _draws, _images, tiny_classifier)
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parents[1]
LAYERS = (1, 1, 1, 1)
N_LATENTS = {"ids": 4, "gender": 8, "cars": 8}  # the small purifiers' codes
# one config of each kind (the ids ours_* in each preprocessing)
KINDS = ["ours_cosine_noise_ids", "ours_cosine_blur_ids", "ours_learned_no_preprocessing_ids",
         "ours_linear_noise_gender", "ours_cosine_blur_cars", "ablation_noise_cars",
         "ablation_blur_ids", "no_defense_gender", "competitor_trades_cars",
         "competitor_avae_ids", "competitor_ndvae_ids"]
FAILING = "competitor_ndvae_cars"  # its fabrication raises in the first run
MATRIX_SEED = 2


def _small_classifier(kind, n, device):
    if kind == "vgg":
        return VGG11BN(n, plan=TINY_PLAN, device=device)
    if kind == "resnet":
        return ResNetBackbone(n, layers=LAYERS, device=device)
    return ResNetBackbone(n, layers=LAYERS, groups=32, base_width=4, device=device)


def _small_configs(root: Path, names=None) -> Path:
    """Copies of configs/ (`names`, default KINDS and FAILING), ours_*
    alphas resampled."""
    for name in names or KINDS + [FAILING]:
        text = (REPO / "configs" / f"{name}.yaml").read_text()
        if name.startswith("ours"):
            alphas = read_flat_yaml(REPO / "configs" / f"{name}.yaml")["interpolation_alphas"]
            small = resampled_alphas(alphas, 1.0, N_LATENTS[name.rsplit("_", 1)[1]])
            lines = [ln for ln in text.splitlines() if not ln.startswith("- ")]
            at = lines.index("interpolation_alphas:") + 1
            lines[at:at] = [f"- {a:.4f}" for a in small]
            text = "\n".join(lines) + "\n"
        (root / f"{name}.yaml").write_text(text)
    return root


@pytest.fixture(scope="module")
def matrix(tmp_path_factory):
    """Two runs of main: the first with FAILING's fabrication raising, the
    second (a rerun into the same report) without. Returns (the reports,
    the exit codes, the names run_config ran in each run, the work dir)."""
    tmp = tmp_path_factory.mktemp("matrix")
    out, work = tmp / "SMOKE.json", tmp / "work"
    reports, codes, ran = [], [], []
    fabricate_ndvae = smoke.fabricate_ndvae
    run_config = smoke.run_config

    def failing_ndvae(path, experiment, cfg, device):
        if experiment == "cars":
            raise OSError("fabrication refused")
        return fabricate_ndvae(path, experiment, cfg, device)

    def recorded_run_config(name, *args):
        ran[-1].append(name)
        return run_config(name, *args)

    small_nvae = NVAEConfig(**NVAE_CFG)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(smoke, "SEED", MATRIX_SEED)
        mp.setattr(factory, "make_classifier", _small_classifier)
        mp.setattr(factory, "PSP", lambda size, device: PSP(32, device=device))
        mp.setattr(factory, "StyleTransformer",
                   lambda size, device: StyleTransformer(32, device=device))
        mp.setattr(factory, "DefenceNVAE", lambda **kw: DefenceNVAE(
            **{**kw, "encoding_channels": 8, "groups": 1, "cells": 1}))
        mp.setattr(smoke, "NVAE_CONFIG", small_nvae)
        mp.setattr(smoke, "FLOW_NVAE_CONFIG", dataclasses.replace(small_nvae, num_nf_cells=1))
        mp.setattr(smoke, "CONFIGS", _small_configs(tmp))
        mp.setattr(smoke, "run_config", recorded_run_config)
        for fabricate in (failing_ndvae, fabricate_ndvae):
            mp.setattr(smoke, "fabricate_ndvae", fabricate)
            ran.append([])
            codes.append(smoke.main(["--out", str(out), "--work", str(work),
                                     "--device", "cpu"]))
            reports.append(json.loads(out.read_text()))
    return reports, codes, ran, work


@pytest.mark.parametrize("name", KINDS + [smoke.EXTRA_ROW])
def test_every_kind_runs_to_results(matrix, name):
    """Each kind's row is ok, with the report's keys, and its results.json
    holds DeepFool's distances of the 2 images; no kernel launched (CPU)."""
    (report, _), _, ran, work = matrix
    row = (report["extra"] if name == smoke.EXTRA_ROW else report["configs"])[name]
    assert row["ok"], row
    assert {"secs", "attack_secs", "clean", "load_secs", "peak_gib", "k1_launches",
            "k2_launches", "deepfool_steps"} <= set(row)
    assert row["k1_launches"] == row["k2_launches"] == 0 and row["peak_gib"] is None
    assert 0.0 <= row["clean"] <= 1.0 and row["secs"] >= row["load_secs"] > 0
    results = json.loads((work / "results" / name / "results.json").read_text())
    assert len(results["DeepFool"]) == smoke.MAX_IMAGES
    batch = smoke.BATCH[name.split("_")[-2 if name == smoke.EXTRA_ROW else -1]]
    assert len(row["deepfool_steps"]) == smoke.MAX_IMAGES // batch
    assert name in ran[0]


def test_a_failed_fabrication_is_a_row_and_the_rerun_retries_it(matrix):
    """The raising fabrication gives its row ok false with the error; the
    other configs go on, and the exit code is 1. The rerun keeps every ok
    row as it was, runs only the failed config, and exits 0."""
    (first, second), codes, ran, _ = matrix
    assert codes == [1, 0]
    assert first["configs"][FAILING] == {"ok": False,
                                         "error": "OSError: fabrication refused",
                                         "k1_launches": 0, "k2_launches": 0}
    assert first["ok"] == len(KINDS) and first["total"] == len(KINDS) + 1
    assert sorted(ran[0]) == sorted(KINDS + [smoke.EXTRA_ROW])
    assert ran[1] == [FAILING]
    assert second["configs"][FAILING]["ok"]
    assert {k: v for k, v in second["configs"].items() if k != FAILING} == \
        {k: v for k, v in first["configs"].items() if k != FAILING}
    assert second["extra"] == first["extra"] and not second["partial"]
    assert second["ok"] == second["total"] == len(KINDS) + 1
    assert second["backend"] == "cpu" and second["nvidia_smi"] == "not available"
    assert len(second["sources_sha256"]) == 64
    # each file made once, in the run that first needed it
    assert sorted(second["files"]) == [
        "cars/classifier.msgpack", "cars/ndvae.msgpack", "cars/ours_ae.msgpack",
        "gender/classifier.msgpack", "gender/ours_ae.msgpack",
        "ids/avae.msgpack", "ids/classifier.msgpack", "ids/ndvae.msgpack",
        "ids/ours_ae.msgpack", "ids/ours_ae_flow.msgpack"]


def test_cuda_without_a_device_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        smoke.main(["--out", str(tmp_path / "SMOKE.json"), "--work", str(tmp_path)])
    assert not (tmp_path / "SMOKE.json").exists()


def test_launch_checks_follow_each_path():
    cuda = torch.device("cuda")
    assert smoke.path_kernels("ours_cosine_blur_ids", "ids", cuda) == {"K1"}
    assert smoke.path_kernels(smoke.EXTRA_ROW, "ids", cuda) == {"K1"}
    assert smoke.path_kernels("ours_linear_noise_cars", "cars", cuda) == {"K2"}
    assert smoke.path_kernels("ablation_blur_gender", "gender", cuda) == set()
    assert smoke.path_kernels("ours_cosine_blur_ids", "ids", torch.device("cpu")) == set()
    smoke.check_launches({"K1": 50, "K2": 0}, {"K1"})
    smoke.check_launches({"K1": 0, "K2": 0}, set())
    for launches, expected in ((({"K1": 0, "K2": 0}), {"K1"}), ({"K1": 50, "K2": 8}, {"K1"}),
                               ({"K1": 0, "K2": 8}, set())):
        with pytest.raises(RuntimeError, match="kernel launches"):
            smoke.check_launches(launches, expected)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def test_jax_reads_the_fabricated_ids_files(matrix, monkeypatch):
    """JAX's load_variables reads the twin's ids NVAE and classifier to the
    trees of to_jax_variables of the same modules made again (from the same
    seed), and the meta the factories read."""
    work = matrix[3]
    monkeypatch.setattr(smoke, "SEED", MATRIX_SEED)
    remade = {"ours_ae": smoke._random(lambda d: factory.NVAE(NVAEConfig(**NVAE_CFG), device=d),
                                       torch.device("cpu"), init_tensor_),
              "classifier": smoke._random(lambda d: _small_classifier("vgg", 100, d),
                                          torch.device("cpu"), init_tensor_)}
    for name, module in remade.items():
        got, meta = jax_load(work / "ids" / f"{name}.msgpack")
        want = dict(_leaves(to_jax_variables(module)))
        got = dict(_leaves(jax.tree.map(np.asarray, got)))
        assert sorted(got) == sorted(want), name
        for path, w in want.items():
            np.testing.assert_array_equal(got[path], w, err_msg=f"{name} {path}")
        assert meta == ({"config": dataclasses.asdict(NVAEConfig(**NVAE_CFG))}
                        if name == "ours_ae" else {"model_type": "vgg"})


@pytest.mark.parametrize("name", ["ours_cosine_blur_ids", "ablation_blur_ids"])
def test_jax_load_defense_on_the_twins_config_copies(matrix, tiny_classifier, name):
    """JAX's load_defense on the twin's config copy gives the port's EoT-2
    logits on the same draws (TOL: test_torch_factory's, ~30 float32
    convolution layers summed in another order)."""
    config = str(matrix[3] / f"{name}.yaml")
    want_loaded = jax_factory.load_defense(config, eot_steps=EOT)
    loaded = factory.load_defense(config, eot_steps=EOT, device="cpu")
    x = _images(3)
    jax_call, draws = _draws(name)
    want = jax_call(lambda: want_loaded.net(KEY, jnp.asarray(x)))
    with torch.no_grad():
        got = loaded.net(torch.tensor(x), draws)
    assert np.all(np.isfinite(np.asarray(want)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --cli-defaults: the kinds, and the draw budget and cotangent samples
# lowered so that both defaults act at a batch of 4 and EoT-4 (the ids
# ours_* config: an EoT chunk of 1, DeepFool's 8 classes in blocks of 2)
DEFAULTS_KINDS = ["ours_cosine_noise_ids", "ablation_blur_ids", "no_defense_gender",
                  "competitor_trades_cars"]
DEFAULTS_BATCH, DEFAULTS_EOT = 4, 4


@pytest.fixture(scope="module")
def defaults_matrix(tmp_path_factory):
    """One run of main with --cli-defaults --batch-size 4 over
    DEFAULTS_KINDS; returns (exit code, report, work dir)."""
    from gen_adversarial_tpu_torch.attacks import utils as attack_utils
    tmp = tmp_path_factory.mktemp("matrix_defaults")
    configs = tmp / "configs"
    configs.mkdir()
    out, work = tmp / "SMOKE_DEFAULTS.json", tmp / "work"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(smoke, "SEED", MATRIX_SEED)
        mp.setattr(factory, "make_classifier", _small_classifier)
        mp.setattr(smoke, "NVAE_CONFIG", NVAEConfig(**NVAE_CFG))
        mp.setattr(smoke, "CONFIGS", _small_configs(configs, DEFAULTS_KINDS))
        mp.setattr(smoke, "CLI_EOT_STEPS", DEFAULTS_EOT)
        mp.setitem(factory.EOT_DRAW_BUDGET, ("ids", "ours"), DEFAULTS_BATCH)
        mp.setattr(attack_utils, "COT_SAMPLES", 8)
        code = smoke.main(["--out", str(out), "--work", str(work), "--device", "cpu",
                           "--cli-defaults", "--batch-size", str(DEFAULTS_BATCH)])
    return code, json.loads(out.read_text()), work


@pytest.mark.parametrize("name,eot_steps,eot_chunk,block", [
    ("ours_cosine_noise_ids", DEFAULTS_EOT, 1, 2), ("ablation_blur_ids", DEFAULTS_EOT, None, 2),
    ("no_defense_gender", 1, None, None), ("competitor_trades_cars", 1, None, 2)])
def test_cli_defaults_rows_record_the_chunk_and_blocks(defaults_matrix, name, eot_steps,
                                                      eot_chunk, block):
    """--cli-defaults runs each config as the CLI does without flags, on one
    batch of 4 images all classified 0: the row is ok, DeepFool took its one
    step, and the row holds the EoT chunk loaded (default_eot_chunk's; EoT 1
    and no chunk for the bare classifiers) and the block DeepFool's class
    Jacobian took (class_block's: 2 of 8 ids or 4 cars classes, one block
    of gender's 2); results.json holds the 4 images; no extra row."""
    code, report, work = defaults_matrix
    assert code == 0 and report["ok"] == report["total"] == len(DEFAULTS_KINDS)
    assert report["cli_defaults"] and report["extra"] == {}
    assert (report["batch"], report["max_images"], report["eot_steps"]) == \
        (DEFAULTS_BATCH, DEFAULTS_BATCH, DEFAULTS_EOT)
    row = report["configs"][name]
    assert row["ok"], row
    assert (row["batch"], row["eot_steps"], row["eot_chunk"]) == (DEFAULTS_BATCH, eot_steps,
                                                                  eot_chunk)
    assert row["deepfool_blocks"] == [block] and row["deepfool_steps"] == [1]
    assert row["labels"]["bias_raise"] > 0 and row["peak_gib"] is None
    results = json.loads((work / "results" / name / "results.json").read_text())
    assert len(results["DeepFool"]) == DEFAULTS_BATCH

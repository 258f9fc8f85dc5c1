"""The port's efficacy experiment (gen_adversarial_tpu_torch/efficacy_run.py)
on the CPU: stage 0's PNG files pixel-equal to what tools/efficacy_run.py's
`synth_image` and `.round()` give on the same RandomState, and stages 1-3
at a tiny size (constants patched: 2 classes of 4 images at 32 px, one
epoch, a 1-scale NVAE, 2 grid and 1 BO step) writing their files in the JAX
package's formats."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import gen_adversarial_tpu_torch.efficacy_run as er
from gen_adversarial_tpu.core.checkpoint import load_variables as jax_load
from gen_adversarial_tpu.models.classifiers import VGG11BN as JaxVGG
from gen_adversarial_tpu.models.nvae.model import NVAE as JaxNVAE
from gen_adversarial_tpu.models.nvae.model import NVAEConfig as JaxNVAEConfig
from gen_adversarial_tpu.search.alphas import get_best_combination
from gen_adversarial_tpu_torch.data import png
from tests.torch_port_helpers import no_onednn, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "no_onednn")

REPO = Path(__file__).resolve().parent.parent


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_efficacy_run",
                                                  REPO / "tools" / "efficacy_run.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    for name, value in dict(WORK=tmp_path / "work", REPORT=tmp_path / "EFFICACY_torch.json",
                            IMAGE_SIZE=32, N_CLASSES=2, N_TRAIN_PER_CLASS=4,
                            N_TEST_PER_CLASS=2, CLF_EPOCHS=1, CLF_BATCH=4, NVAE_EPOCHS=1,
                            NVAE_BATCH=4, EOT_STEPS=2, EVAL_BATCH=4, N_ADV=4,
                            ADV_MAX_ITER=3, GRID_STEPS=2, BO_STEPS=1).items():
        monkeypatch.setattr(er, name, value)
    monkeypatch.setattr(er, "NVAE_CONFIG", dict(er.NVAE_CONFIG, resolution=32, num_scales=1,
                                                num_groups_per_scale=1, initial_channels=4,
                                                num_latent_per_group=2))
    return tmp_path / "work"


def test_stage0_images_equal_the_jax_tools(tiny, monkeypatch):
    monkeypatch.setenv("GAT_EFFICACY_STAGE", "0")
    er.main(["--device", "cpu"])
    tool = _jax_tool()
    rng = np.random.RandomState(er.SEED)
    n = 0
    for split, n_per in (("train", 4), ("test", 2)):
        for cls in range(2):
            for i in range(n_per):
                want = (tool.synth_image(rng, cls, 32) * 255).round().astype(np.uint8)
                got = png.read_rgb(tiny / "data" / split / f"class_{cls}" / f"{i:04d}.png")
                np.testing.assert_array_equal(got, want)
                n += 1
    assert n == 12 and (tiny / "data" / ".done").exists()
    assert json.loads((tiny / "stages.json").read_text())["0"]["seconds"] >= 0


def test_stages_1_to_3_write_the_jax_formats(tiny, monkeypatch):
    monkeypatch.setenv("GAT_EFFICACY_STAGE", "3")
    er.main(["--device", "cpu"])
    stages = json.loads((tiny / "stages.json").read_text())
    assert set(stages) == {"0", "1", "2", "3"}
    assert 0.0 <= stages["1"]["clean_test_acc"] <= 1.0
    assert 0.0 <= stages["2"]["recon_acc"] <= 1.0 and stages["2"]["recon_l2"] > 0
    x = jnp.asarray(np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32))

    # the classifier and the NVAE load in the JAX package and run there
    variables, meta = jax_load(tiny / "classifier.msgpack")
    assert meta["plan"] == list(er.VGG_PLAN) and meta["test_acc"] == stages["1"]["clean_test_acc"]
    logits = JaxVGG(n_classes=2, plan=er.VGG_PLAN).apply(variables, x, train=False)
    assert logits.shape == (2, 2) and np.all(np.isfinite(np.asarray(logits)))
    variables, meta = jax_load(tiny / "nvae_final.msgpack")
    assert (meta["recon_acc"], meta["recon_l2"]) == (stages["2"]["recon_acc"],
                                                   stages["2"]["recon_l2"])
    nvae = JaxNVAE(JaxNVAEConfig(**meta["config"]))
    rec = nvae.apply(variables, x, jax.random.PRNGKey(0), True, method=JaxNVAE.reconstruct)
    assert rec.shape == x.shape and np.all(np.isfinite(np.asarray(rec)))

    # the adversarial set and the searches' files, read by the JAX package
    kept = sorted((tiny / "adv_set").rglob("*.png"))
    assert len(kept) == stages["3"]["n_adv"] > 0
    assert all(png.read_rgb(f).shape == (32, 32, 3) for f in kept)
    for mode, rows in (("search_grid", 2), ("search_bo", 5 + 1)):
        alphas = np.load(tiny / mode / "alphas.npy")
        accs = np.load(tiny / mode / "accuracies.npy")
        assert alphas.shape == (rows, 1) and accs.shape == (rows, 1)
        np.testing.assert_allclose(get_best_combination(str(tiny / mode)),
                                   stages["3"][mode]["alphas"], atol=1e-4)
        assert stages["3"][mode]["best_acc"] == float(accs.max())
    assert np.load(tiny / "best_alphas.npy").shape == (1,)

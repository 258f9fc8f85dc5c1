"""The port's attack benchmark (eval/harness.py) on the CPU, on the tiny
world of tests/test_harness.py (tests/torch_port_helpers.tiny_world): its
results.json against the JAX harness's under DeepFool on the deterministic
`no_defense` tiny VGG; per-batch resume (a run that dies after its first
batch and is run again equals an uninterrupted run; a progress file of
another setup, the JAX harness's included, is not resumed); the ragged
last batch trimmed, a second attack merged beside the first, the progress
file removed, the plots written; and the plot against the JAX
`save_example_plot`, with PIL and with the port's bitmap font."""

import json
import sys
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import gen_adversarial_tpu.eval.factory as jax_factory
from gen_adversarial_tpu.attacks import deepfool_attack as jax_deepfool
from gen_adversarial_tpu.eval.harness import run_benchmark as jax_run_benchmark
from gen_adversarial_tpu.eval.harness import save_example_plot as jax_save_example_plot
from gen_adversarial_tpu_torch.attacks import cw_attack, deepfool_attack
from gen_adversarial_tpu_torch.data import png
from gen_adversarial_tpu_torch.eval import factory
from gen_adversarial_tpu_torch.eval.harness import (
    TITLE_STRIP, batch_generator, run_benchmark, save_example_plot)
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from tests.torch_port_helpers import patch_tiny_classifier, tiny_world

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DEEPFOOL = dict(num_classes=8, overshoot=0.02, max_iter=50)
# per-image minimal L2 after up to 50 DeepFool steps through ~10 float32
# layers, summed in other orders in torch and XLA (measured 4.5e-7)
L2_RTOL = 1e-4


@pytest.fixture()
def world(tmp_path, monkeypatch):
    patch_tiny_classifier(monkeypatch)
    data_dir, ckpt = tiny_world(tmp_path)
    for name, text in (("no_defense_ids", ""), ("ablation_noise_ids", "type: noise\n")):
        (tmp_path / f"{name}.yaml").write_text(f"classifier_path: {ckpt}\n{text}")
    return data_dir, tmp_path


def _port(tmp, name, **kw):
    loaded = factory.load_defense(str(tmp / f"{name}.yaml"), device="cpu", **kw)
    loaded.attacks["deepfool"] = partial(deepfool_attack, **DEEPFOOL)
    loaded.attacks["c&w"] = partial(cw_attack, c=16.0, kappa=0.05, steps=3, lr=5e-3,
                                    n_restarts=1, early_stopping_steps=16)
    return loaded


def test_deepfool_results_match_jax(world):
    data_dir, tmp = world
    jax_loaded = jax_factory.load_defense(str(tmp / "no_defense_ids.yaml"))
    jax_loaded.attacks["deepfool"] = partial(jax_deepfool, **DEEPFOOL)
    kw = dict(batch_size=4, max_images=6, attack_filter="deepfool", plots=False,
              log_fn=lambda s: None)
    want = jax_run_benchmark(jax_loaded, str(data_dir), str(tmp / "jax"), **kw)
    got = run_benchmark(_port(tmp, "no_defense_ids"), str(data_dir), str(tmp / "port"), **kw)
    assert got == json.loads((tmp / "port" / "results.json").read_text())
    assert sorted(got) == sorted(want) == ["Clean", "DeepFool"]
    assert got["Clean"] == want["Clean"]
    g, w = np.asarray(got["DeepFool"]), np.asarray(want["DeepFool"])
    assert len(g) == 6 and np.array_equal(g == 100.0, w == 100.0)
    assert np.any((w > 0) & (w < 100.0)), w  # some attacks found an adversary
    np.testing.assert_allclose(g, w, rtol=L2_RTOL)


def test_resume_after_a_crash_equals_an_uninterrupted_run(world):
    """The stochastic noise ablation (EoT-2): the second batch dies inside
    its attack, the rerun continues from image 2 and recomputes two batches,
    and every number equals the uninterrupted run's."""
    data_dir, tmp = world
    loaded = _port(tmp, "ablation_noise_ids", eot_steps=2)
    kw = dict(batch_size=2, max_images=6, attack_filter="deepfool", plots=False)
    want = run_benchmark(loaded, str(data_dir), str(tmp / "full"), log_fn=lambda s: None, **kw)

    class Boom(RuntimeError):
        pass

    calls = {"n": 0}

    def crashing_log(msg):
        if msg.startswith("[deepfool]"):
            calls["n"] += 1
            if calls["n"] == 2:
                raise Boom()

    with pytest.raises(Boom):
        run_benchmark(loaded, str(data_dir), str(tmp / "res"), log_fn=crashing_log, **kw)
    progress = json.loads((tmp / "res" / "progress_p0.json").read_text())
    assert progress["n_seen"] == 2 and progress["fingerprint"]["backend"] == "torch"
    logs = []
    got = run_benchmark(loaded, str(data_dir), str(tmp / "res"), log_fn=logs.append, **kw)
    assert any(line.startswith("[resume] continuing from image 2") for line in logs)
    assert sum(line.startswith("[deepfool]") for line in logs) == 2
    assert not (tmp / "res" / "progress_p0.json").exists()
    assert got == want
    assert (tmp / "full" / "results.json").read_text() == (tmp / "res" / "results.json").read_text()


def test_a_progress_file_of_another_setup_restarts(world):
    """Another fingerprint (here the JAX harness's, which has no backend
    key) is ignored, not merged."""
    data_dir, tmp = world
    loaded = _port(tmp, "no_defense_ids", eot_steps=2)
    kw = dict(batch_size=2, max_images=4, attack_filter="deepfool", plots=False)
    run_benchmark(loaded, str(data_dir), str(tmp / "ref"), log_fn=lambda s: None, **kw)
    out = tmp / "mismatch"
    out.mkdir()
    fingerprint = {"seed": 42, "batch_size": 2, "attacks": ["deepfool"], "max_images": 4,
                   "pid": 0, "pcount": 1, "n_images": 12, "eot_steps": 1,
                   "defense_type": "base", "experiment": "ids", "eot_chunk": None,
                   "dtype": "float32", "n_devices": None}
    (out / "progress_p0.json").write_text(json.dumps(
        {"fingerprint": fingerprint, "n_seen": 4, "clean_correct": [True] * 4,
         "distortions": {"deepfool": [1.0] * 4}}))
    logs = []
    got = run_benchmark(loaded, str(data_dir), str(out), log_fn=logs.append, **kw)
    assert any("does not match" in line for line in logs)
    assert sum(line.startswith("[deepfool]") for line in logs) == 2
    assert got == json.loads((tmp / "ref" / "results.json").read_text())


def test_ragged_tail_merge_plots_and_generators(world):
    """batch 4 over 5 images: one batch padded from 1 row, trimmed; C&W run
    after DeepFool merges beside it; the plots of images 0 and 5 of each
    attack decode; the progress file is gone. Each (batch, stage) has its
    own generator."""
    data_dir, tmp = world
    loaded = _port(tmp, "no_defense_ids")
    kw = dict(batch_size=4, max_images=5, log_fn=lambda s: None)
    first = run_benchmark(loaded, str(data_dir), str(tmp / "res"), attack_filter="deepfool", **kw)
    second = run_benchmark(loaded, str(data_dir), str(tmp / "res"), attack_filter="c&w", **kw)
    written = json.loads((tmp / "res" / "results.json").read_text())
    assert written == second and sorted(written) == ["C&W", "Clean", "DeepFool"]
    assert written["DeepFool"] == first["DeepFool"]
    for name in ("DeepFool", "C&W"):
        values = np.asarray(written[name])
        assert len(values) == 5 and np.all(np.isfinite(values))
        assert np.all((values >= 0) & (values <= 100.0))
    for attack in ("deepfool", "c&w"):
        for i in (0, 5):
            path = tmp / "res" / "plots" / f"{attack}_example={i}.png"
            if i < 5:
                pixels = png.read_rgb(path)
                assert pixels.shape == (TITLE_STRIP + 64 + 12, 3 * (64 + 12), 3)
            else:
                assert not path.exists()  # image 5 is beyond max_images
    assert not (tmp / "res" / "progress_p0.json").exists()
    seeds = {batch_generator(42, 0, b, s, torch.device("cpu")).initial_seed()
             for b in range(3) for s in range(4)}
    assert len(seeds) == 12


def _plot_inputs():
    rng = np.random.RandomState(0)
    x = rng.rand(64, 64, 3).astype(np.float32)
    adv = (x + 0.3 * rng.randn(64, 64, 3)).astype(np.float32)  # outside [0, 1]: clipped
    purified = rng.rand(64, 64, 3).astype(np.float32)
    return x, adv, purified


@pytest.mark.parametrize("success,bound", [(True, 1.2345), (False, float("inf"))])
def test_plot_matches_jax(tmp_path, success, bound):
    """With PIL installed both draw the title with ImageDraw: the same image."""
    jax_save_example_plot(tmp_path / "jax.png", *_plot_inputs(), success, bound)
    save_example_plot(tmp_path / "port.png", *_plot_inputs(), success, bound)
    with Image.open(tmp_path / "jax.png") as a, Image.open(tmp_path / "port.png") as b:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_plot_without_pil_uses_the_bitmap_font(tmp_path, monkeypatch):
    """The tiles are the JAX plot's (decoded by PIL); the title strip holds
    white glyph pixels, black elsewhere."""
    jax_save_example_plot(tmp_path / "jax.png", *_plot_inputs(), True, 12.5)
    monkeypatch.setitem(sys.modules, "PIL", None)
    save_example_plot(tmp_path / "port.png", *_plot_inputs(), True, 12.5)
    monkeypatch.delitem(sys.modules, "PIL")
    with Image.open(tmp_path / "jax.png") as a, Image.open(tmp_path / "port.png") as b:
        want, got = np.asarray(a), np.asarray(b)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[TITLE_STRIP:], want[TITLE_STRIP:])
    strip = got[:TITLE_STRIP]
    assert set(np.unique(strip).tolist()) == {0, 255} and (strip == 255).sum() > 200

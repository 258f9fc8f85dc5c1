"""The port's alpha-search CLI (gen_adversarial_tpu_torch/cli/alpha_search.py)
and `eval/factory.load_ours_for_search` on the CPU, on the tiny world of
tests/test_harness.py (64-px PNGs in class folders 'a' and 'b', a tiny
VGG11-BN over 100 classes) with a small ids NVAE (2 scales x 2 groups, so 4
alphas) written by the JAX `save_variables`: load_ours_for_search's logits
against the JAX package's on the same draws, and `main()` with --device cpu
in its three modes at EoT 2 and 1-2 search steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gen_adversarial_tpu.eval.factory as jax_factory
import gen_adversarial_tpu_torch.eval.factory as factory
from gen_adversarial_tpu.core.checkpoint import save_variables as jax_save
from gen_adversarial_tpu.defenses.eot import eot_wrap as jax_eot_wrap
from gen_adversarial_tpu.models.nvae.model import NVAE as JaxNVAE
from gen_adversarial_tpu.models.nvae.model import NVAEConfig as JaxNVAEConfig
from gen_adversarial_tpu_torch.cli.alpha_search import main
from gen_adversarial_tpu_torch.core.checkpoint import load_variables, save_variables
from gen_adversarial_tpu_torch.core.config import N_LATENTS
from gen_adversarial_tpu_torch.data import png
from gen_adversarial_tpu_torch.defenses.eot import eot_wrap
from gen_adversarial_tpu_torch.models.nvae.model import NVAEConfig, eps_shapes
from tests.torch_port_helpers import keyed_normal_call, one_torch_thread  # noqa: F401
from tests.torch_port_helpers import patch_tiny_classifier, random_variables, tiny_world

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NVAE_CFG = dict(resolution=64, initial_channels=8, num_scales=2, num_groups_per_scale=2,
                is_adaptive=False, num_cells_per_group=1, num_latent_per_group=4,
                num_mixtures=3)
N_ALPHAS = 4
EOT = 2
# ~30 float32 convolution layers summed in another order, then a mean (as
# tests/test_torch_factory.py)
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture()
def world(tmp_path, monkeypatch):
    """(images folder, the ours_linear_noise_ids config); both factories
    build the tiny VGG, and the ids search has the small NVAE's 4 alphas."""
    patch_tiny_classifier(monkeypatch)
    monkeypatch.setitem(N_LATENTS, "ids", N_ALPHAS)
    data_dir, ckpt = tiny_world(tmp_path, n_per_class=3)
    key = jax.random.PRNGKey(0)
    nvae = JaxNVAE(JaxNVAEConfig(**NVAE_CFG))
    variables = random_variables(jax.eval_shape(
        lambda: nvae.init({"params": key}, jnp.zeros((1, 64, 64, 3)), key)), 2)
    jax_save(tmp_path / "nvae.msgpack", jax.tree.map(np.asarray, variables),
             {"config": NVAE_CFG})
    config = tmp_path / "ours_linear_noise_ids.yaml"
    config.write_text(
        f"classifier_path: {ckpt}\nautoencoder_path: {tmp_path / 'nvae.msgpack'}\n"
        "interpolation_alphas:\n" + "".join(f"- {a}\n" for a in (0.25, 0.5, 0.75, 1.0))
        + "alpha_attenuation: 0.7\ninitial_noise_eps: 2.0\ngaussian_blur_input: false\n")
    return data_dir, config


def test_load_ours_for_search_matches_jax(world):
    """make_defense(alphas) on both sides: initial noise eps 0 (the shared
    encode), no blur, the NVAE's own normalization; EoT-2 logits of 2 images
    with the same numpy draws."""
    _, config = world
    search_alphas = np.array([0.1, 0.9, 0.4, 0.7], np.float32) * np.float32(0.7)
    want_exp, want_size, jax_make = jax_factory.load_ours_for_search(str(config))
    exp, size, make_defense = factory.load_ours_for_search(str(config), device="cpu")
    assert (exp, size) == (want_exp, want_size) == ("ids", 64)
    defense = make_defense(search_alphas)
    assert (defense.initial_noise_eps, defense.apply_blur, defense.normalize_before_purify,
            defense.remat) == (0.0, False, False, False)
    assert defense.alphas.dtype == torch.float32
    np.testing.assert_array_equal(defense.alphas.numpy(), search_alphas)

    x = np.random.RandomState(3).rand(2, 64, 64, 3).astype(np.float32)
    rng = np.random.RandomState(5)
    shapes = eps_shapes(NVAEConfig(**NVAE_CFG), 2)
    eps = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(EOT)]
    key = jax.random.PRNGKey(1)
    per_draw = [(None, [e.transpose(0, 2, 3, 1) for e in eps[d]] + [None]) for d in range(EOT)]
    jax_call = keyed_normal_call(key, per_draw)
    jnet = jax.jit(lambda d, k, v: jax_eot_wrap(d, EOT)(k, v))  # the defense an argument
    want = jax_call(lambda: jnet(jax_make(jnp.asarray(search_alphas)), key, jnp.asarray(x)))
    draws = [torch.tensor(np.concatenate([eps[d][j] for d in range(EOT)]))
             for j in range(len(shapes))]
    with torch.no_grad():
        got = eot_wrap(defense, EOT)(torch.tensor(x), draws)
    assert np.all(np.isfinite(np.asarray(want)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _common(config, tmp_path):
    return ["--config", str(config), "--eot-steps", str(EOT), "--batch-size", "4",
            "--device", "cpu", "--results-folder", str(tmp_path / "results")]


def test_make_adv_writes_the_kept_adversaries(world, tmp_path):
    """FGSM at the ids bound (2.0) through load_defense's defense, here the
    reconstruction-only one (all alphas 0, as the reference makes its set):
    every kept file is a 64 x 64 RGB PNG under its source's class folder and
    name, within L2 2.0 (plus the truncation, under one level a value) of
    its source; at most --n-samples are kept, and at least one is. The
    random tiny VGG puts every image on class 0 by ~0.32 over class 1, which
    FGSM at 2.0 cannot cross: the class-1 bias is raised to leave the 'a'
    images' mean margin at 0.01 (FGSM then moved images 0 and 1 of 'a')."""
    data_dir, config = world
    config.write_text(config.read_text().replace(
        "- 0.25\n- 0.5\n- 0.75\n- 1.0\n", "- 0.0\n" * N_ALPHAS))
    images = torch.tensor(np.stack([png.read_rgb(data_dir / "a" / f"{i}.png")
                                    for i in range(3)]) / np.float32(255.0))
    with torch.no_grad():
        logits = factory.load_defense(str(config), eot_steps=EOT, device="cpu").net(
            images, torch.Generator().manual_seed(0))
    ckpt = tmp_path / "classifier.msgpack"
    variables, meta = load_variables(ckpt)
    variables["params"]["classifier"]["fc1"]["bias"][1] += \
        (logits[:, 0] - logits[:, 1]).mean().item() - 0.01
    save_variables(ckpt, variables, meta)

    out = tmp_path / "adv"
    kept = main(["--mode", "make-adv", "--images-path", str(data_dir), "--out-dir", str(out),
                 "--n-samples", "4"] + _common(config, tmp_path))
    files = sorted(out.rglob("*.png"))
    assert 1 <= kept == len(files) <= 4
    print(f"kept {[f.relative_to(out).as_posix() for f in files]}")
    for f in files:
        source = data_dir / f.parent.name / f.name
        assert source.exists(), f
        adv, src = png.read_rgb(f) / 255.0, png.read_rgb(source) / 255.0
        assert adv.shape == (64, 64, 3)
        assert np.sqrt(np.sum((adv - src) ** 2)) <= 2.0 + np.sqrt(adv.size) / 255 + 1e-6


@pytest.mark.parametrize("mode,n_steps,rows", [("grid", 2, 2), ("bo", 1, 6)])
def test_searches_write_their_results(world, tmp_path, mode, n_steps, rows, capsys):
    """grid (2 random vectors) and bo (the 5 seed schedules and 1 GP step)
    over the 6 images as the adversarial set: alphas.npy (rows, 4) in
    [0, 1], accuracies.npy (rows, 1) in multiples of 1/6, the progress
    marker removed; bo prints its best alphas."""
    data_dir, config = world
    xs, accs = main(["--mode", mode, "--adv-images-path", str(data_dir),
                     "--n-steps", str(n_steps)] + _common(config, tmp_path))
    folder = tmp_path / "results"
    np.testing.assert_array_equal(np.load(folder / "alphas.npy"), xs)
    np.testing.assert_array_equal(np.load(folder / "accuracies.npy"), accs)
    assert xs.shape == (rows, N_ALPHAS) and accs.shape == (rows, 1)
    assert np.all((xs >= 0) & (xs <= 1))
    np.testing.assert_allclose(accs * 6, np.round(accs * 6), atol=1e-9)
    assert not list(folder.glob("*_progress.json"))
    if mode == "bo":
        assert "best alphas: " in capsys.readouterr().out


def test_the_default_device_is_cuda(world, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    data_dir, config = world
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--mode", "grid", "--config", str(config), "--adv-images-path", str(data_dir),
              "--results-folder", str(tmp_path / "results")])

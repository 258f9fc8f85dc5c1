"""The port's alpha-search CLI (gen_adversarial_tpu_torch/cli/alpha_search.py)
and `eval/factory.load_ours_for_search` on the CPU, on the tiny world of
tests/test_harness.py (64-px PNGs in class folders 'a' and 'b', a tiny
VGG11-BN over 100 classes) with a small ids NVAE (2 scales x 2 groups, so 4
alphas) written by the JAX `save_variables`: load_ours_for_search's logits
against the JAX package's on the same draws, `main()` with --device cpu in
its three modes at EoT 2 and 1-2 search steps, make-adv with an EoT chunk
against make-adv without one and against the JAX CLI's on the same draws,
and the EoT chunk each mode passes on (the family's default unless
--eot-chunk is given)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gen_adversarial_tpu.eval.factory as jax_factory
import gen_adversarial_tpu_torch.eval.factory as factory
import gen_adversarial_tpu_torch.search.alphas as search_alphas
import gen_adversarial_tpu_torch.search.grid as grid
from gen_adversarial_tpu.cli.alpha_search import main as jax_main
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
from tests.torch_port_helpers import keyed_normal_call, keyed_normal_calls  # noqa: F401
from tests.torch_port_helpers import one_torch_thread  # noqa: F401
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


def _reconstruction_only(world, tmp_path):
    """The world's config with all alphas 0 (the reference makes its
    adversarial set against the reconstruction-only defense). The random
    tiny VGG puts every image on class 0 by ~0.32 over class 1, which FGSM
    at 2.0 cannot cross: the class-1 bias is raised to leave the 'a' images'
    mean margin at 0.01."""
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


def test_make_adv_writes_the_kept_adversaries(world, tmp_path):
    """FGSM at the ids bound (2.0) through load_defense's defense, here the
    reconstruction-only one (_reconstruction_only): every kept file is a
    64 x 64 RGB PNG under its source's class folder and name, within L2 2.0
    (plus the truncation, under one level a value) of its source; at most
    --n-samples are kept, and at least one is (FGSM moved images 0 and 1 of
    'a')."""
    data_dir, config = world
    _reconstruction_only(world, tmp_path)

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


# the kept adversaries' pixels, port against JAX: (adv * 255) truncated, so a
# value within float32 rounding of a level boundary may land one level off
# (tests/test_torch_search.py); and FGSM steps each value by the sign of its
# gradient entry (2.0 / sqrt(64 * 64 * 3) = 4.6 levels), so an entry within
# float32 rounding of 0 in XLA's and torch's backward may step the other way
# (measured: one value of 12288, 9 levels apart, behind the tiny VGG's
# max-pools)
MAX_OFF_PIXELS = 16
MAX_SIGN_FLIPS = 2
FGSM_STEP_LEVELS = 2.0 / np.sqrt(64 * 64 * 3) * 255


def _fgsm_draws(batch: int, seed: int):
    """Numpy draws of one EoT-2 forward of the small NVAE defense (eps 2.0)
    over `batch` images: the JAX per_draw list, and the port's draws
    unchunked and in chunks of 1 (per chunk: the input noise, then each
    latent group's eps)."""
    rng = np.random.RandomState(seed)
    shapes = eps_shapes(NVAEConfig(**NVAE_CFG), batch)
    noise = [rng.standard_normal((batch, 64, 64, 3)).astype(np.float32) for _ in range(EOT)]
    eps = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(EOT)]
    per_draw = [(noise[d], [e.transpose(0, 2, 3, 1) for e in eps[d]] + [None])
                for d in range(EOT)]
    whole = [np.concatenate(noise)] + [np.concatenate([eps[d][j] for d in range(EOT)])
                                       for j in range(len(shapes))]
    chunked = [a for d in range(EOT) for a in [noise[d]] + eps[d]]
    return per_draw, {None: whole, 1: chunked}


def test_make_adv_with_a_chunk_matches_unchunked_and_jax(world, tmp_path, monkeypatch):
    """make-adv on the reconstruction-only world in batches of 3, the same
    numpy draws for each batch's two FGSM forwards: with --eot-chunk 1 (the
    draws replayed chunk by chunk) the port writes the same files, byte for
    byte, and FGSM returns the same success, bounds and images exactly as
    without a chunk; and the JAX CLI (whose make-adv runs unchunked) keeps
    the same files, their pixels equal but for at most MAX_OFF_PIXELS values
    one level apart."""
    data_dir, config = world
    _reconstruction_only(world, tmp_path)
    batch, n_batches = 3, 2
    key, jax_keys, draws = jax.random.PRNGKey(0), [], {}
    for b in range(n_batches):
        key, sub = jax.random.split(key)  # the JAX make-adv's key of batch b
        jax_keys.append(jax.random.split(sub))  # FGSM's two forwards
        for f in range(2):
            draws[b, f] = _fgsm_draws(batch, 20 + 2 * b + f)
    jax_call = keyed_normal_calls([(jax_keys[b][f], draws[b, f][0])
                                   for b in range(n_batches) for f in range(2)])
    chunk, outputs = None, []

    def replayed(device, seed, b):
        return [torch.tensor(a) for f in range(2) for a in draws[b, f][1][chunk]]

    def recorded_fgsm(*args):
        outputs[-1].append(fgsm(*args))
        return outputs[-1][-1]

    fgsm = grid.fgsm_attack
    monkeypatch.setattr(grid, "position_generator", replayed)
    monkeypatch.setattr(grid, "fgsm_attack", recorded_fgsm)
    common = ["--mode", "make-adv", "--config", str(config), "--images-path", str(data_dir),
              "--n-samples", "6", "--eot-steps", str(EOT), "--batch-size", str(batch)]
    kept = {}
    for chunk in (None, 1):
        outputs.append([])
        flags = [] if chunk is None else ["--eot-chunk", str(chunk)]
        kept[chunk] = main(common + ["--out-dir", str(tmp_path / f"port{chunk}"),
                                     "--device", "cpu"] + flags)
    monkeypatch.setattr(sys, "argv", ["alpha_search"] + common
                        + ["--out-dir", str(tmp_path / "jax")])
    jax_call(jax_main)

    def files(name):
        return {p.relative_to(tmp_path / name).as_posix(): p.read_bytes()
                for p in (tmp_path / name).rglob("*.png")}

    assert 0 < kept[None] == kept[1] == len(files("portNone")) < 6
    assert files("port1") == files("portNone")
    assert len(outputs[0]) == len(outputs[1]) == n_batches
    for got, want in zip(outputs[1], outputs[0]):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    names = sorted(files("portNone"))
    assert sorted(files("jax")) == names
    off = flips = 0
    for name in names:
        a = png.read_rgb(tmp_path / "portNone" / name).astype(int)
        b = png.read_rgb(tmp_path / "jax" / name).astype(int)
        d = np.abs(a - b)
        flips += int(np.count_nonzero(d > 1))
        assert d.max() <= 2 * FGSM_STEP_LEVELS + 1, name
        off += int(np.count_nonzero(d))
    print(f"kept {names}; {off} pixel values off JAX's, {flips} by a flipped step")
    assert off <= MAX_OFF_PIXELS and flips <= MAX_SIGN_FLIPS, (off, flips)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("mode,name,flags,want", [
    ("make-adv", "ours_cosine_noise_gender", [], 1),
    ("make-adv", "ours_cosine_noise_cars", [], 2),
    ("make-adv", "ours_cosine_noise_gender", ["--eot-chunk", "4"], 4),
    ("grid", "ours_cosine_noise_gender", ["--batch-size", "4"], 2),
    ("bo", "ours_linear_noise_cars", [], 2),
    ("grid", "ours_linear_noise_ids", [], None),
    ("bo", "ours_cosine_noise_cars", ["--eot-chunk", "8"], 8)])
def test_each_mode_passes_the_default_eot_chunk_unless_given(tmp_path, monkeypatch, mode,
                                                             name, flags, want):
    """Without --eot-chunk every mode takes factory.default_eot_chunk's at
    --batch-size (8 by default): gender 1 (2 at batch 4), cars 2, ids none;
    make-adv passes it to load_defense, grid and bo to the AlphaEvaluator;
    a given --eot-chunk wins. The loaders are replaced by recorders (no
    model is built)."""
    seen = {}

    def load_defense(config, **kw):
        seen.update(kw)
        raise _Stop

    def evaluator(*args, **kw):
        seen.update(kw)
        raise _Stop

    data_dir, _ = tiny_world(tmp_path, n_per_class=1)
    monkeypatch.setattr(factory, "load_defense", load_defense)
    monkeypatch.setattr(factory, "load_ours_for_search",
                        lambda config, device: (name.rsplit("_", 1)[1], 64, lambda a: None))
    monkeypatch.setattr(search_alphas, "AlphaEvaluator", evaluator)
    with pytest.raises(_Stop):
        main(["--mode", mode, "--config", str(tmp_path / f"{name}.yaml"),
              "--images-path", str(data_dir), "--adv-images-path", str(data_dir),
              "--out-dir", str(tmp_path / "adv"), "--device", "cpu"] + flags)
    assert seen["eot_chunk"] == want


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

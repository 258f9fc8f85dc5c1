"""The port's defense factory (eval/factory.py) against the JAX package's
`load_defense` on the same checkpoints and configs, on the CPU: a tiny
VGG11-BN classifier (both factories' `make_classifier` patched to build it)
and a small ids NVAE whose config comes from the checkpoint's meta, written
by the JAX `save_variables`; the `ours` family at initial noise eps 2.0 and
at eps 0.0 with the input blur (the shared encode), the noise and blur
ablations, `no_defense` and TRADES, under EoT-2 with every draw made by
numpy and replayed on both sides. The gender and cars families load through
the same factory from checkpoints the port wrote (their constructors
patched small) and compute what the builders' defenses compute. A-VAE and
ND-VAE configs on the NVAE's checkpoint raise; bfloat16 casts; 'cuda'
without CUDA raises. GAT_DF_COT_CHUNK reaches DeepFool and GAT_COT_CHUNK
AutoAttack's FAB, as in the JAX package."""

import dataclasses
from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gen_adversarial_tpu.eval.factory as jax_factory
import gen_adversarial_tpu_torch.eval.factory as factory
from gen_adversarial_tpu.core.checkpoint import save_variables as jax_save
from gen_adversarial_tpu.models.classifiers import VGG11BN as JaxVGG
from gen_adversarial_tpu.models.nvae.model import NVAE as JaxNVAE
from gen_adversarial_tpu.models.nvae.model import NVAEConfig as JaxNVAEConfig
from gen_adversarial_tpu_torch.attacks import class_grads
from gen_adversarial_tpu_torch.cars import cars_defense
from gen_adversarial_tpu_torch.core.checkpoint import save_variables
from gen_adversarial_tpu_torch.core.convert import to_jax_variables
from gen_adversarial_tpu_torch.defenses.eot import eot_wrap
from gen_adversarial_tpu_torch.gender import gender_defense
from gen_adversarial_tpu_torch.models.classifiers import ResNetBackbone, VGG11BN
from gen_adversarial_tpu_torch.models.e4e.psp import PSP
from gen_adversarial_tpu_torch.models.nvae.model import NVAEConfig, eps_shapes
from gen_adversarial_tpu_torch.models.style_transformer.model import StyleTransformer
from tests.torch_port_helpers import keyed_normal_call, one_torch_thread  # noqa: F401
from tests.torch_port_helpers import random_variables

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KEY = jax.random.PRNGKey(0)
TINY_PLAN = (4, "M", 8, "M", 8, 8, "M", 8, 8, "M", 8, 8, "M")
NVAE_CFG = dict(resolution=64, initial_channels=8, num_scales=2, num_groups_per_scale=2,
                is_adaptive=False, num_cells_per_group=1, num_latent_per_group=4,
                num_mixtures=3)
ALPHAS = (0.1, 0.35, 0.6, 1.0)
B, EOT, SIZE = 2, 2, 64
# ~30 float32 convolution layers summed in another order, then a mean
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Checkpoints the JAX save_variables wrote, and one config per family."""
    tmp = tmp_path_factory.mktemp("factory")
    clf_vars = random_variables(jax.eval_shape(lambda: JaxVGG(n_classes=100, plan=TINY_PLAN)
                                               .init(KEY, jnp.zeros((1, SIZE, SIZE, 3)),
                                                     train=False)), 1)
    jax_save(tmp / "vgg.msgpack", jax.tree.map(np.asarray, clf_vars), {"model_type": "vgg"})
    nvae = JaxNVAE(JaxNVAEConfig(**NVAE_CFG))
    nvae_vars = random_variables(jax.eval_shape(
        lambda: nvae.init({"params": KEY}, jnp.zeros((1, SIZE, SIZE, 3)), KEY)), 2)
    jax_save(tmp / "nvae.msgpack", jax.tree.map(np.asarray, nvae_vars), {"config": NVAE_CFG})
    paths = f"classifier_path: {tmp / 'vgg.msgpack'}\nautoencoder_path: {tmp / 'nvae.msgpack'}\n"
    alphas = "interpolation_alphas:\n" + "".join(f"- {a}\n" for a in ALPHAS)
    configs = {
        "ours_linear_noise_ids": alphas + "alpha_attenuation: 0.7\ninitial_noise_eps: 2.0\n"
                                          "gaussian_blur_input: false\n",
        "ours_linear_blur_ids": alphas + "alpha_attenuation: 0.7\ninitial_noise_eps: 0.0\n"
                                         "gaussian_blur_input: true\n",
        "ablation_noise_ids": "type: noise\n", "ablation_blur_ids": "type: blur\n",
        "no_defense_ids": "", "competitor_trades_ids": "",
        "competitor_avae_ids": "kernel_size: 4\n", "competitor_ndvae_ids": "noise_std: 0.05\n"}
    for name, text in configs.items():
        (tmp / f"{name}.yaml").write_text(paths + text)
    return tmp


@pytest.fixture()
def tiny_classifier(monkeypatch):
    """Both factories build the tiny VGG in place of VGG11-BN."""
    monkeypatch.setattr(jax_factory, "make_classifier",
                        lambda t, n: JaxVGG(n_classes=n, plan=TINY_PLAN))
    monkeypatch.setattr(factory, "make_classifier",
                        lambda t, n, device: VGG11BN(n, plan=TINY_PLAN, device=device))


def _images(seed):
    x = np.random.RandomState(seed).rand(B, SIZE, SIZE, 3).astype(np.float32)
    x[0, 0, :4] = [[-0.2, 0.5, 1.3]] * 4  # out of the box: the clamp matters
    return x


def _draws(name):
    """(jax_call, port draws) of EoT-2 over the family's numpy draws (see
    tests/torch_port_helpers.keyed_normal_call); the JAX ablation draws its
    noise with each draw's key itself."""
    rng = np.random.RandomState(5)
    noise = [rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32) for _ in range(EOT)]
    if name.startswith("ablation_noise"):
        table = {tuple(np.asarray(k).tolist()): n
                 for k, n in zip(jax.random.split(KEY, EOT), noise)}
        keys = jnp.asarray(np.stack([np.asarray(k) for k in jax.random.split(KEY, EOT)]))
        vals = jnp.asarray(np.stack(list(table.values())))
        real = jax.random.normal

        def jax_call(fn):
            def fake(k, shape=(), dtype=jnp.float32):
                match = jnp.all(keys == k, axis=-1)
                return jnp.where(jnp.any(match), vals[jnp.argmax(match)], jnp.nan).astype(dtype)
            jax.random.normal = fake
            try:
                return fn()
            finally:
                jax.random.normal = real

        return jax_call, [torch.tensor(np.concatenate(noise))]
    if not name.startswith("ours"):
        return (lambda fn: fn()), []
    with_noise = "noise" in name
    shapes = eps_shapes(NVAEConfig(**NVAE_CFG), B)
    eps = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(EOT)]
    per_draw = [(noise[d] if with_noise else None,
                 [e.transpose(0, 2, 3, 1) for e in eps[d]] + [None]) for d in range(EOT)]
    draws = [np.concatenate(noise)] if with_noise else []
    draws += [np.concatenate([eps[d][j] for d in range(EOT)]) for j in range(len(shapes))]
    return keyed_normal_call(KEY, per_draw), [torch.tensor(d) for d in draws]


@pytest.mark.parametrize("name", ["ours_linear_noise_ids", "ours_linear_blur_ids",
                                  "ablation_noise_ids", "ablation_blur_ids", "no_defense_ids",
                                  "competitor_trades_ids"])
def test_load_defense_matches_jax(world, tiny_classifier, name):
    config = str(world / f"{name}.yaml")
    want_loaded = jax_factory.load_defense(config, eot_steps=EOT)
    loaded = factory.load_defense(config, eot_steps=EOT, device="cpu")
    for field in ("experiment", "defense_type", "image_size", "n_classes", "eot_steps",
                  "eot_chunk", "dtype"):
        assert getattr(loaded, field) == getattr(want_loaded, field), field
    assert sorted(loaded.attacks) == sorted(want_loaded.attacks)
    x = _images(3)
    jax_call, draws = _draws(name)
    want = jax_call(lambda: want_loaded.net(KEY, jnp.asarray(x)))
    with torch.no_grad():
        got = loaded.net(torch.tensor(x), draws)
    assert np.all(np.isfinite(np.asarray(want)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ours_options_follow_the_jax_factory(world, tiny_classifier, monkeypatch):
    """remat off for ids unless a policy asks for it; alphas times the
    attenuation in float32; bfloat16 casts once; GAT_DF_COT_CHUNK reaches
    the attacks."""
    config = str(world / "ours_linear_noise_ids.yaml")
    monkeypatch.setenv("GAT_DF_COT_CHUNK", "3")
    loaded = factory.load_defense(config, device="cpu")
    assert loaded.defense.remat is False and loaded.eot_steps == 32
    assert loaded.attacks["deepfool"].keywords["cotangent_chunk"] == 3
    want = jax_factory.load_defense(config).defense.alphas
    np.testing.assert_array_equal(loaded.defense.alphas.numpy(), np.asarray(want))
    monkeypatch.delenv("GAT_DF_COT_CHUNK")
    loaded = factory.load_defense(config, remat_policy="dots_saveable", dtype="bfloat16",
                                  device="cpu")
    assert loaded.defense.remat is True and loaded.defense.remat_policy == "dots_saveable"
    assert loaded.dtype == "bfloat16" and loaded.defense.compute_dtype == torch.bfloat16
    assert loaded.defense.purifier.init_conv.weight.dtype == torch.bfloat16


def test_a_remat_policy_with_a_cotangent_chunk_raises_before_loading(world, tiny_classifier,
                                                                    monkeypatch):
    """A remat_policy with GAT_DF_COT_CHUNK set loads (nothing raises), and
    its DeepFool (2 steps, 8 classes in blocks of 3, EoT-2), whose forwards
    run without the policy, gives policy None's success, bounds, images and
    step count exactly, and so do the class gradients of its first step:
    the same recompute from the same draws. (At 2 steps both fail on this
    random world, so the class gradients carry the comparison.)"""
    config = str(world / "ours_linear_noise_ids.yaml")
    monkeypatch.setenv("GAT_DF_COT_CHUNK", "3")
    x = torch.tensor(_images(7))
    results = {}
    for policy in (None, "dots_saveable"):
        loaded = factory.load_defense(config, eot_steps=EOT, remat=True, remat_policy=policy,
                                      device="cpu")
        if policy is None:  # the labels DeepFool's first draws predict: both images step
            with torch.no_grad():
                y = loaded.net(x, torch.Generator().manual_seed(9)).argmax(1)
        deepfool = loaded.attacks["deepfool"]
        assert deepfool.keywords["cotangent_chunk"] == 3
        with pytest.warns(UserWarning, match="dropped") if policy else nullcontext():
            results[policy] = deepfool(loaded.net, x, y, torch.Generator().manual_seed(9),
                                       max_iter=2, return_iters=True)
            order = torch.arange(8).expand(2, 8)
            results[policy] += class_grads(loaded.net, x, torch.Generator().manual_seed(9),
                                           order, cotangent_chunk=3)
    want, got = results[None], results["dots_saveable"]
    assert torch.isfinite(want[2]).all() and want[3] == got[3] == 2
    assert want[5].abs().max() > 0
    for g, w in zip(got[:3] + got[4:], want[:3] + want[4:]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("env", [{"GAT_DF_COT_CHUNK": "3"}, {"GAT_COT_CHUNK": "5"},
                                 {"GAT_DF_COT_CHUNK": "3", "GAT_COT_CHUNK": "5"},
                                 {"GAT_DF_COT_CHUNK": "0", "GAT_COT_CHUNK": "0"}])
def test_each_cotangent_chunk_reaches_its_attack(world, tiny_classifier, monkeypatch,
                                                 tmp_path, env):
    """As in the JAX package, GAT_DF_COT_CHUNK is DeepFool's class-jacobian
    block and GAT_COT_CHUNK FAB's (0 or unset: None), each set alone and
    both: the attacks' keywords, and the chunk FAB is called with inside the
    monolithic AutoAttack and inside the staged one that run_benchmark builds
    (APGD and FAB replaced by recorders; C&W takes no chunk): GAT_COT_CHUNK's
    where it is set, else the ensemble's own `fab_block` (8 of the 100
    classes at a batch of 2)."""
    for name in ("GAT_DF_COT_CHUNK", "GAT_COT_CHUNK"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    deepfool_chunk = int(env.get("GAT_DF_COT_CHUNK", "0")) or None
    fab_chunk = int(env.get("GAT_COT_CHUNK", "0")) or None
    loaded = factory.load_defense(str(world / "no_defense_ids.yaml"), device="cpu")
    assert loaded.attacks["deepfool"].keywords["cotangent_chunk"] == deepfool_chunk
    assert loaded.attacks["autoattack"].keywords == {"n_classes": 100,
                                                     "cotangent_chunk": fab_chunk}
    assert "cotangent_chunk" not in loaded.attacks["c&w"].keywords

    seen = []

    def fake_apgd(net, images, labels, draws, *args):
        n = images.shape[0]
        return torch.zeros(n, dtype=torch.bool), torch.full((n,), 100.0), images

    def fake_fab(net, images, labels, draws, **kw):
        seen.append(kw["cotangent_chunk"])
        return fake_apgd(net, images, labels, draws)

    import importlib

    from gen_adversarial_tpu_torch.data import png
    from gen_adversarial_tpu_torch.eval.harness import run_benchmark
    # the package's `autoattack` function hides its module's name
    autoattack_module = importlib.import_module("gen_adversarial_tpu_torch.attacks.autoattack")
    monkeypatch.setattr(autoattack_module, "apgd_attack", fake_apgd)
    monkeypatch.setattr(autoattack_module, "fab_attack", fake_fab)
    x = torch.tensor(_images(4)).clamp(0, 1)
    loaded.attacks["autoattack"](loaded.net, x, torch.tensor([0, 1]), torch.Generator())
    for i in range(2):
        png.write(tmp_path / "images" / "c" / f"{i}.png",
                  (_images(i)[0].clip(0, 1) * 255).round().astype(np.uint8))
    run_benchmark(loaded, str(tmp_path / "images"), str(tmp_path / "results"), batch_size=2,
                  attack_filter="autoattack", plots=False, log_fn=lambda msg: None)
    want = fab_chunk or autoattack_module.fab_block(100, 2)
    assert want == (fab_chunk or 8) and seen == [want, want]


@pytest.mark.parametrize("name", ["competitor_avae_ids", "competitor_ndvae_ids"])
def test_competitors_raise_naming_the_roadmap_item(world, tiny_classifier, name):
    """The competitors load (tests/test_torch_competitor_cli.py holds them to
    JAX on their own checkpoints); pointed at the NVAE's checkpoint, as
    here, they raise naming a leaf that is not theirs."""
    with pytest.raises(ValueError, match="flax leaf|no submodule|not in the flax tree"):
        factory.load_defense(str(world / f"{name}.yaml"), device="cpu")


def test_cuda_without_a_device_raises(world, tiny_classifier):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        factory.load_defense(str(world / "no_defense_ids.yaml"))


def _small_family(family):
    """A small builder defense, its purifier's constructor and its
    classifier's, at the builder's reduced size."""
    layers = (1, 1, 1, 1)
    if family == "gender":
        built = gender_defense(device="cpu", seed=3, stylegan_size=32, classifier_layers=layers)
        return built, ("PSP", lambda size, device: PSP(32, device=device)), \
            lambda t, n, device: ResNetBackbone(n, layers=layers, device=device)
    built = cars_defense(device="cpu", seed=3, output_size=32, classifier_layers=layers)
    return built, ("StyleTransformer", lambda size, device: StyleTransformer(32, device=device)), \
        lambda t, n, device: ResNetBackbone(n, layers=layers, groups=32, base_width=4,
                                            device=device)


@pytest.mark.parametrize("family", ["gender", "cars"])
def test_stylegan_families_load_through_the_factory(tmp_path, monkeypatch, family):
    """The builder's small defense written by the port (to_jax_variables +
    save_variables), loaded by load_defense with the constructors patched
    small: remat on, and the same logits as the built defense on the same
    draws (8 codes of the 32-px generator, so 8 alphas in the config). The
    alpha search's load_ours_for_search reads the same files: its defense
    (initial noise eps 0, no blur, the family's normalize) computes what the
    built defense computes at eps 0 with the alphas it is given."""
    built, (name, purifier), classifier = _small_family(family)
    monkeypatch.setattr(factory, name, purifier)
    monkeypatch.setattr(factory, "make_classifier", classifier)
    save_variables(tmp_path / "purifier.msgpack", to_jax_variables(built.purifier))
    save_variables(tmp_path / "classifier.msgpack", to_jax_variables(built.classifier))
    alphas = np.round(np.linspace(0.05, 1.0, 8), 2)
    (tmp_path / f"ours_linear_noise_{family}.yaml").write_text(
        f"classifier_path: {tmp_path / 'classifier.msgpack'}\n"
        f"autoencoder_path: {tmp_path / 'purifier.msgpack'}\ninterpolation_alphas:\n"
        + "".join(f"- {a}\n" for a in alphas)
        + "alpha_attenuation: 0.7\ninitial_noise_eps: 4.0\ngaussian_blur_input: false\n")
    loaded = factory.load_defense(str(tmp_path / f"ours_linear_noise_{family}.yaml"),
                                  eot_steps=2, device="cpu")
    assert loaded.defense.remat is True and loaded.defense.normalize_before_purify
    built.alphas.copy_(torch.tensor(alphas.astype(np.float32) * np.float32(0.7)))
    size = loaded.image_size
    x = torch.tensor(np.random.RandomState(4).rand(1, size, size, 3).astype(np.float32))
    rng = np.random.RandomState(6)
    draws = [torch.tensor(rng.standard_normal(s).astype(np.float32))
             for s in [(2, size, size, 3), (8, 2, 512)]]
    with torch.no_grad():
        want = eot_wrap(built, 2)(x, list(draws))
        got = loaded.net(x, list(draws))
    assert torch.isfinite(want).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)

    experiment, image_size, make_defense = factory.load_ours_for_search(
        str(tmp_path / f"ours_linear_noise_{family}.yaml"), device="cpu")
    assert (experiment, image_size) == (family, size)
    search_alphas = np.linspace(1.0, 0.0, 8).astype(np.float32)
    defense = make_defense(search_alphas)
    assert (defense.initial_noise_eps, defense.apply_blur, defense.normalize_before_purify,
            defense.remat) == (0.0, False, True, False)
    built.alphas.copy_(torch.tensor(search_alphas))
    built.initial_noise_eps = 0.0
    with torch.no_grad():
        want = eot_wrap(built, 2)(x, list(draws[1:]))
        got = eot_wrap(defense, 2)(x, list(draws[1:]))
    torch.testing.assert_close(got, want, rtol=0, atol=0)

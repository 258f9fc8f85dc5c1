"""The port's purify -> classify slice against the JAX package on the CPU, at
a tiny NVAE and a narrow VGG11-BN: the NVAE purify, the classifier, and the
whole EoT defense (MLVGMDefense + eot_wrap) at initial noise eps 2.0 and 0.0
(the shared-encode path), with every random draw made by numpy and replayed
on both sides, and its input gradient (torch.func.vjp against jax.vjp, and
vmap over the class cotangents against a loop). Also: a CPU rehearsal of the
flagship factory at reduced depth, and that the port imports nothing of JAX
or the JAX package."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.func import vjp, vmap

from gen_adversarial_tpu.defenses.base import MLVGMDefense as JaxDefense
from gen_adversarial_tpu.defenses.base import make_classifier_apply as jax_classifier_apply
from gen_adversarial_tpu.defenses.eot import eot_wrap as jax_eot_wrap
from gen_adversarial_tpu.defenses.purify import _compose, make_nvae_purify_split as jax_split
from gen_adversarial_tpu.models.classifiers import VGG11BN as JaxVGG
from gen_adversarial_tpu.models.nvae.model import NVAE as JaxNVAE
from gen_adversarial_tpu.models.nvae.model import NVAEConfig as JaxNVAEConfig
from gen_adversarial_tpu_torch.core.convert import from_jax_variables
from gen_adversarial_tpu_torch.defenses.base import MLVGMDefense, make_classifier_apply
from gen_adversarial_tpu_torch.defenses.eot import eot_wrap
from gen_adversarial_tpu_torch.defenses.purify import make_nvae_purify_split
from gen_adversarial_tpu_torch.flagship import FLAGSHIP_NVAE, flagship
from gen_adversarial_tpu_torch.models.classifiers import VGG11BN
from gen_adversarial_tpu_torch.models.nvae.model import NVAE, NVAEConfig, eps_shapes
from tests.torch_port_helpers import load_port, random_variables, rel_err, to_nchw

REPO = Path(__file__).resolve().parent.parent
CFG = dict(resolution=16, initial_channels=8, n_pre_post_blocks=1, n_pre_post_cells=2,
           num_scales=2, num_groups_per_scale=2, is_adaptive=False,
           num_cells_per_group=1, num_latent_per_group=4, num_mixtures=3)
PLAN = (8, "M", 16, "M", 16, "M")
N_CLASSES = 10
B = 2
TEMP = 0.6
# ~30 float32 convolution layers summed in another order, then a softmax
# mean: relative 1e-4 of the output's scale
SLICE_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    """JAX and port NVAE + VGG with the same random weights."""
    jcfg, tcfg = JaxNVAEConfig(**CFG), NVAEConfig(**CFG)
    x0 = jnp.zeros((1, 16, 16, 3))
    k = jax.random.PRNGKey(0)
    jnvae = JaxNVAE(jcfg)
    nvae_vars = random_variables(jax.eval_shape(
        lambda: jnvae.init({"params": k}, x0, k)), 1)
    jclf = JaxVGG(n_classes=N_CLASSES, plan=PLAN)
    clf_vars = random_variables(jax.eval_shape(
        lambda: jclf.init(k, x0, train=False)), 2)
    tnvae = load_port(NVAE(tcfg, device="cpu"), nvae_vars)
    tclf = load_port(VGG11BN(N_CLASSES, plan=PLAN, device="cpu"), clf_vars)
    alphas = np.linspace(0.1, 0.9, tcfg.n_latents).astype(np.float32)
    return dict(jcfg=jcfg, tcfg=tcfg, jnvae=jnvae, nvae_vars=nvae_vars, jclf=jclf,
                clf_vars=clf_vars, tnvae=tnvae, tclf=tclf, alphas=alphas)


def _images(seed, b=B):
    x = np.random.RandomState(seed).rand(b, 16, 16, 3).astype(np.float32)
    x[0, 0, :4] = [[-0.2, 0.5, 1.3]] * 4  # out of the box: the clamp matters
    return x


def test_classifier_matches_jax(models):
    x = _images(3)
    want = models["jclf"].apply(models["clf_vars"], jnp.asarray(x), train=False)
    with torch.no_grad():
        got = models["tclf"](to_nchw(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SLICE_TOL)


def test_nvae_purify_matches_jax(models, monkeypatch):
    """Eps drawn by numpy, replayed in draw order: z_0, then each group."""
    x = _images(4)
    rng = np.random.RandomState(5)
    eps = [rng.standard_normal(s).astype(np.float32) for s in eps_shapes(models["tcfg"], B)]
    replay = [e.transpose(0, 2, 3, 1) for e in eps]
    real_normal = jax.random.normal

    def fake_normal(key, shape=(), dtype=jnp.float32):
        assert replay and tuple(shape) == replay[0].shape, shape
        return jnp.asarray(replay.pop(0), dtype)

    monkeypatch.setattr(jax.random, "normal", fake_normal)
    want = models["jnvae"].apply(models["nvae_vars"], jnp.asarray(x), jax.random.PRNGKey(0),
                                 jnp.asarray(models["alphas"]), TEMP, method=JaxNVAE.purify)
    monkeypatch.setattr(jax.random, "normal", real_normal)
    assert not replay
    with torch.no_grad():
        got = models["tnvae"].purify(torch.tensor(x), torch.tensor(models["alphas"]),
                                     [torch.tensor(e) for e in eps], TEMP)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SLICE_TOL)


def _jax_key_tables(key, eot, n_latents):
    """The keys the JAX EoT defense draws its noise and eps with: per draw d,
    (noise key, the n_latents + 1 purify keys)."""
    out = []
    for kd in jax.random.split(key, eot):
        k_noise, k_purify = jax.random.split(kd)
        out.append((np.asarray(k_noise), np.asarray(jax.random.split(k_purify, n_latents + 1))))
    return out


def _eot_pair(models, noise_eps, chunk, eot=4):
    """The JAX and the port EoT defense (MLVGMDefense + eot_wrap) with the
    same numpy draws. JAX draws inside a vmap over keys, so `jax_call(fn)`
    runs fn with jax.random.normal replaced by a lookup of the draw's key in
    a table of the numpy draws; the port replays the same draws folded into
    its batch, draw-major, chunk by chunk. Returns (jax_net(x), jax_call,
    port_net(x))."""
    tcfg = models["tcfg"]
    n = tcfg.n_latents
    rng = np.random.RandomState(7)
    noise = [rng.standard_normal((B, 16, 16, 3)).astype(np.float32) for _ in range(eot)]
    eps = [[rng.standard_normal(s).astype(np.float32) for s in eps_shapes(tcfg, B)]
           for _ in range(eot)]
    key = jax.random.PRNGKey(11)

    tables = {}
    for d, (k_noise, k_eps) in enumerate(_jax_key_tables(key, eot, n)):
        entries = [(k_noise, noise[d])] + [
            (k_eps[j], eps[d][j].transpose(0, 2, 3, 1)) for j in range(n)]
        for k, v in entries:
            keys, vals = tables.setdefault(v.shape, ([], []))
            keys.append(k)
            vals.append(v)
    tables = {s: (jnp.asarray(np.stack(k)), jnp.asarray(np.stack(v)))
              for s, (k, v) in tables.items()}
    real_normal = jax.random.normal

    def fake_normal(k, shape=(), dtype=jnp.float32):
        keys, vals = tables[tuple(shape)]
        match = jnp.all(keys == k, axis=-1)
        # a key that is not in the table gives NaN, and the test fails
        return jnp.where(jnp.any(match), vals[jnp.argmax(match)], jnp.nan).astype(dtype)

    def jax_call(fn):
        jax.random.normal = fake_normal
        try:
            return fn()
        finally:
            jax.random.normal = real_normal

    enc, dec = jax_split(models["jnvae"], TEMP)
    jdef = JaxDefense(
        purify_variables=models["nvae_vars"], classifier_variables=models["clf_vars"],
        alphas=jnp.asarray(models["alphas"]), purify_apply=_compose(enc, dec),
        purify_encode_apply=enc, purify_decode_apply=dec,
        classifier_apply=jax_classifier_apply(models["jclf"]), image_size=16,
        initial_noise_eps=noise_eps, normalize_before_purify=False)
    jnet = jax_eot_wrap(jdef, eot_steps=eot, chunk=chunk)

    per = chunk or eot
    draws = []
    for c0 in range(0, eot, per):
        ds = range(c0, c0 + per)
        if noise_eps > 0:
            draws.append(np.concatenate([noise[d] for d in ds]))
        draws += [np.concatenate([eps[d][j] for d in ds]) for j in range(n)]
    tenc, tdec = make_nvae_purify_split(models["tnvae"], TEMP)
    tdef = MLVGMDefense(
        models["tnvae"], models["tclf"], torch.tensor(models["alphas"]), tenc, tdec,
        make_classifier_apply(models["tclf"]), initial_noise_eps=noise_eps)
    tnet = eot_wrap(tdef, eot_steps=eot, chunk=chunk)
    return ((lambda x: jnet(key, x)), jax_call,
            (lambda x: tnet(x, [torch.tensor(d) for d in draws])))


@pytest.mark.parametrize("noise_eps,chunk", [(2.0, None), (0.0, None), (2.0, 2)])
def test_eot_defense_matches_jax(models, noise_eps, chunk):
    """MLVGMDefense + eot_wrap, EoT 4, every draw made by numpy on both sides
    (see _eot_pair)."""
    jnet, jax_call, tnet = _eot_pair(models, noise_eps, chunk)
    x = _images(6)
    want = jax_call(lambda: jnet(jnp.asarray(x)))
    with torch.no_grad():
        got = tnet(torch.tensor(x))
    assert np.all(np.isfinite(np.asarray(want)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SLICE_TOL)


# the input gradient through the defense, port vs JAX: measured at 3.4e-7 and
# 4.6e-7 relative (float32 on both sides, other summation orders)
GRAD_RTOL = 1e-5


@pytest.mark.parametrize("noise_eps", [2.0, 0.0])
def test_eot_defense_input_gradient_matches_jax(models, noise_eps):
    """The input gradient of the EoT-4 defense under a numpy-seeded cotangent
    on the logits: torch.func.vjp through the port (K1's autograd Function
    inside) against jax.vjp, relative to the largest entry."""
    jnet, jax_call, tnet = _eot_pair(models, noise_eps, None)
    x = _images(6)
    g = np.random.RandomState(8).randn(B, N_CLASSES).astype(np.float32)
    want = jax_call(lambda: jax.vjp(jnet, jnp.asarray(x))[1](jnp.asarray(g))[0])
    _, vjp_fn = vjp(tnet, torch.tensor(x))
    (got,) = vjp_fn(torch.tensor(g))
    assert np.all(np.isfinite(np.asarray(want))) and np.abs(np.asarray(want)).max() > 0
    assert rel_err(got.detach().numpy(), want) <= GRAD_RTOL


def test_class_gradients_vmap_over_vjp_match_a_loop(models):
    """What an attack's class gradients do: vmap of the defense's vjp_fn over
    the one-hot class cotangents (K1's vmap rule folds the classes into N)
    equals a loop of single vjps."""
    _, _, tnet = _eot_pair(models, 2.0, None)
    logits, vjp_fn = vjp(tnet, torch.tensor(_images(6)))
    onehots = torch.eye(N_CLASSES)[:, None, :].expand(N_CLASSES, B, N_CLASSES)
    (batched,) = vmap(vjp_fn)(onehots)
    looped = torch.stack([vjp_fn(o)[0] for o in onehots])
    assert batched.shape == (N_CLASSES, B, 16, 16, 3)
    assert rel_err(batched.detach().numpy(), looped.detach().numpy()) <= GRAD_RTOL


def test_convert_reports_missing_and_misshapen_leaves(models):
    params = jax.tree.map(np.asarray, models["clf_vars"])
    with pytest.raises(ValueError, match="not in the flax tree"):
        from_jax_variables({"params": params["params"]},
                           VGG11BN(N_CLASSES, plan=PLAN, device="cpu"))
    with pytest.raises(ValueError):
        from_jax_variables(params, VGG11BN(N_CLASSES + 1, plan=PLAN, device="cpu"))


def test_flagship_rehearsal_at_reduced_depth():
    """The flagship factory on the CPU at full NVAE width, one group per
    scale and one cell per group, with a narrow VGG (the real head is
    25088 x 25088): EoT-2 logits of the right shape, finite."""
    cfg = dataclasses.replace(FLAGSHIP_NVAE, num_groups_per_scale=1, num_cells_per_group=1)
    defense = flagship(device="cpu", cfg=cfg, vgg_plan=(8, "M", 8, "M", 8, "M", 8, "M", 8, "M"))
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        logits = eot_wrap(defense, eot_steps=2)(x, torch.Generator().manual_seed(1))
    assert logits.shape == (2, 100)
    assert torch.isfinite(logits).all()
    assert len(cfg.decoder_segment_shapes()) == 6
    assert len(FLAGSHIP_NVAE.decoder_segment_shapes()) == 50


BANNED = {"jax", "jaxlib", "flax", "optax", "yaml", "msgpack", "gen_adversarial_tpu"}
# PIL only where an image format or the plot's title needs it, inside a
# function, so that every module imports without it
OPTIONAL = {"PIL": ("data/datasets.py", "eval/harness.py", "search/grid.py")}


def _port_files():
    # chip_smoke.py fabricates reference checkpoints with tests/torch_reference_layout.py
    return sorted((REPO / "gen_adversarial_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "torch_reference_layout.py"]


SLICE_MODULES = [  # the modules of each port slice, which the checks below cover
    "ops/depthwise.py", "models/nvae/model.py", "flagship.py",
    "ops/upfirdn2d.py", "ops/fused_act.py", "ops/upfirdn.py", "ops/image.py",
    "models/stylegan2/layers.py", "models/stylegan2/generator.py",
    "models/e4e/encoder.py", "models/e4e/psp.py", "defenses/purify.py",
    "defenses/base.py", "models/classifiers.py", "core/convert.py", "gender.py",
    "models/style_transformer/encoder.py", "models/style_transformer/model.py", "cars.py",
    "ops/blur.py", "defenses/ablations.py",
    "attacks/utils.py", "attacks/fgsm.py", "attacks/deepfool.py", "attacks/cw.py",
    "attacks/apgd.py", "attacks/fab.py", "attacks/autoattack.py", "core/config.py",
    "eval/factory.py", "core/precision.py",
    "models/nvae/cells.py", "ab_k1.py", "ab_k2.py",
    "core/checkpoint.py", "data/png.py", "data/datasets.py", "eval/harness.py",
    "cli/test_defense.py",
    "search/alphas.py", "search/grid.py", "search/gp.py", "cli/alpha_search.py",
    "models/batchnorm.py", "models/nvae/distributions.py", "models/nvae/regularization.py",
    "core/init.py", "core/runlog.py", "core/torch_convert.py", "train/augment.py",
    "train/classifier.py", "train/nvae.py", "cli/train_classifier.py", "cli/train_nvae.py",
    "efficacy_run.py",
    "models/avae/model.py", "models/ndvae/model.py", "defenses/competitors.py",
    "train/avae.py", "train/ndvae.py", "train/trades.py", "cli/train_avae.py",
    "cli/train_ndvae.py", "cli/trades_finetune.py",
    "core/stylegan_convert.py", "core/avae_convert.py", "core/ndvae_convert.py",
    "cli/convert_checkpoints.py",
    "core/distributed.py", "models/stylegan2/discriminator.py",
    "smoke_all_configs.py", "smoke_autoattack.py", "attack_memory.py", "smoke_cli_defaults.py",
]


def test_import_checks_cover_every_slice_module():
    files = set(_port_files())
    for rel in SLICE_MODULES:
        assert REPO / "gen_adversarial_tpu_torch" / rel in files, rel


def test_port_sources_import_no_jax():
    """Every import statement of the port and chip_smoke.py, also those inside
    functions, and no use of torch.utils.cpp_extension."""
    for path in _port_files():
        text = path.read_text()
        assert "cpp_extension" not in text, path
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in BANNED, f"{path}: imports {name}"
                if top in OPTIONAL:
                    rel = path.relative_to(REPO / "gen_adversarial_tpu_torch").as_posix()
                    assert rel in OPTIONAL[top] and node.col_offset > 0, \
                        f"{path}: imports {name} where it is not optional"


def test_port_imports_with_jax_blocked():
    """A fresh interpreter in which importing any banned name, or PIL, fails
    imports every port module and chip_smoke.py."""
    modules = [".".join(p.relative_to(REPO).with_suffix("").parts) for p in _port_files()]
    modules = [m[:-len(".__init__")] if m.endswith(".__init__") else m for m in modules]
    code = (
        "import importlib, sys\n"
        f"banned = {sorted(BANNED | set(OPTIONAL))!r}\n"
        "for name in banned:\n"
        "    sys.modules[name] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in banned and sys.modules[m]]\n"
        "assert not loaded, loaded\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

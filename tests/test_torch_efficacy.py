"""The port's efficacy experiment (gen_adversarial_tpu_torch/efficacy_run.py)
on the CPU: stage 0's PNG files pixel-equal to what tools/efficacy_run.py's
`synth_image` and `.round()` give on the same RandomState, and stages 1-3
at a tiny size (constants patched: 2 classes of 4 images at 32 px, one
epoch, a 1-scale NVAE, 2 grid and 1 BO step) writing their files in the JAX
package's formats."""

import dataclasses
import importlib.util
import json
import shutil
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gen_adversarial_tpu_torch.core.init as init_module
import gen_adversarial_tpu_torch.efficacy_run as er
import gen_adversarial_tpu.train.nvae as jax_train_nvae
import gen_adversarial_tpu_torch.train.classifier as classifier_module
import gen_adversarial_tpu_torch.train.nvae as nvae_module
from gen_adversarial_tpu.core.checkpoint import load_variables as jax_load
from gen_adversarial_tpu.models.classifiers import VGG11BN as JaxVGG
from gen_adversarial_tpu.models.nvae.model import NVAE as JaxNVAE
from gen_adversarial_tpu.models.nvae.model import NVAEConfig as JaxNVAEConfig
from gen_adversarial_tpu.search.alphas import get_best_combination
from gen_adversarial_tpu_torch.core.convert import to_jax_variables
from gen_adversarial_tpu_torch.core.init import flax_init_
from gen_adversarial_tpu_torch.models.classifiers import VGG11BN
from gen_adversarial_tpu_torch.models.nvae.model import NVAE, eps_shapes
from gen_adversarial_tpu_torch.data import png
from tests.torch_port_helpers import load_port, no_onednn, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "no_onednn")

REPO = Path(__file__).resolve().parent.parent


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_efficacy_run",
                                                  REPO / "tools" / "efficacy_run.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TINY = dict(IMAGE_SIZE=32, N_CLASSES=2, N_TRAIN_PER_CLASS=4, N_TEST_PER_CLASS=2, CLF_EPOCHS=1,
            CLF_BATCH=4, NVAE_EPOCHS=1, NVAE_BATCH=4, EOT_STEPS=2, EVAL_BATCH=4)
TINY_NVAE = dict(resolution=32, num_scales=1, num_groups_per_scale=1, initial_channels=4,
                 num_latent_per_group=2)


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """The port's tool shrunk (its constants patched), working under
    tmp_path/work."""
    for name, value in dict(TINY, WORK=tmp_path / "work",
                            REPORT=tmp_path / "EFFICACY_torch.json", N_ADV=4, ADV_MAX_ITER=3,
                            GRID_STEPS=2, BO_STEPS=1).items():
        monkeypatch.setattr(er, name, value)
    monkeypatch.setattr(er, "NVAE_CONFIG", dict(er.NVAE_CONFIG, **TINY_NVAE))
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


def _fresh(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


RECIPE = ("IMAGE_SIZE", "N_CLASSES", "N_TRAIN_PER_CLASS", "N_TEST_PER_CLASS", "SEED",
          "VGG_PLAN", "CLF_EPOCHS", "CLF_LR", "CLF_BATCH", "NVAE_EPOCHS", "NVAE_LR",
          "NVAE_BATCH", "NVAE_INPUT_NOISE", "EOT_STEPS", "EVAL_BATCH", "N_EVAL_IMAGES")


def test_the_recipe_is_the_jax_tools():
    """The two tools' unpatched constants and NVAE configurations are equal
    (the stage tests below give the JAX tool the port's)."""
    port = _fresh(REPO / "gen_adversarial_tpu_torch" / "efficacy_run.py", "port_efficacy_run")
    tool = _jax_tool()
    for name in RECIPE:
        assert getattr(port, name) == getattr(tool, name), name
    assert dataclasses.asdict(port.nvae_config()) == tool.nvae_config().__dict__


def _jax_tool_as_port(work: Path):
    """The JAX tool with the port tool's (patched) constants, its data a
    copy of the port's stage 0 under `work`."""
    tool = _jax_tool()
    for name in RECIPE:
        setattr(tool, name, getattr(er, name))
    tool.WORK = work
    tool.nvae_config = lambda: JaxNVAEConfig(**er.NVAE_CONFIG)
    shutil.copytree(er.WORK / "data", work / "data")
    return tool


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _float64_model(model):
    """`model` (a flax module) whose init returns float64 variables: its
    apply then computes in float64 on float32 inputs."""
    class Float64:
        def init(self, *args, **kwargs):
            return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), model.init(*args, **kwargs))

        def __getattr__(self, name):
            return getattr(model, name)

    return Float64()


def _rel_l2(got, want) -> float:
    """|got - want| / |want| over every leaf of the trees at once."""
    got, want = _flat(got), _flat(want)
    num = sum(float(np.sum((np.asarray(got[p], np.float64) - w) ** 2)) for p, w in want.items())
    return float(np.sqrt(num / sum(float(np.sum(np.asarray(w, np.float64) ** 2))
                                   for w in want.values())))


EPOCHS = 2
# stage 1 at 64 px: 2 epochs x 4 SGD steps (momentum 0.9) of VGG11-BN at 1/8
# width over 64 gratings. The loss is ill-conditioned in float32 on these
# images: at the first step JAX's own float32 gradient stands 1-2 % of its
# largest element from its float64 gradient, and the gap grows with every
# step, so two float32 runs cannot be held elementwise. The port's float32
# run is held to JAX's float64 run by twice JAX's own float32 run's distance
# from it (the repository's gap rule), per epoch, for the weights and for
# the BatchNorm statistics. An epoch's mean loss (4 numbers) has no such
# scale of its own: it is held by the same rule or to 5 % of float64's.
GAP_FACTOR = 2.0
LOSS_RTOL = 0.05


def _jax_stage1(tool, per_epoch, float64):
    """JAX's stage1_classifier: (variables after each epoch, step losses,
    test accuracy), from its tool's own jitted `step` (recorded through a
    patched jax.jit)."""
    epochs, losses = [], []
    real_jit = jax.jit

    def jit(fn, *args, **kwargs):
        compiled = real_jit(fn, *args, **kwargs)
        if getattr(fn, "__name__", "") != "step":
            return compiled

        def recorded(*a):
            out = compiled(*a)
            losses.append(float(out[2]))
            if len(losses) % per_epoch == 0:
                epochs.append(jax.tree.map(lambda v: np.asarray(v, np.float64), out[0]))
            return out
        return recorded

    if float64:
        model = tool._clf_model()
        tool._clf_model = lambda: _float64_model(model)
    jax.jit = jit
    try:
        with jax.enable_x64(float64):
            _, _, acc = tool.stage1_classifier(lambda msg: None)
    finally:
        jax.jit = real_jit
    return epochs, losses, acc


def test_stage1_epochs_match_the_jax_tools(tiny, monkeypatch):
    """stage1_classifier of both tools over 2 epochs, from JAX's initial
    weights (the port's `flax_init_` patched to load them), held after each
    epoch by the gap rule above; the clean test accuracy is JAX's. No draws:
    the normalize-only steps take none."""
    for name, value in dict(IMAGE_SIZE=64, N_TRAIN_PER_CLASS=32, CLF_BATCH=16,
                            CLF_EPOCHS=EPOCHS).items():
        monkeypatch.setattr(er, name, value)
    er.stage0_dataset(lambda msg: None, er.SEED)
    per_epoch = er.N_CLASSES * er.N_TRAIN_PER_CLASS // er.CLF_BATCH
    want, want_losses, want_acc = _jax_stage1(_jax_tool_as_port(tiny.parent / "jax32"),
                                              per_epoch, float64=False)
    ref, ref_losses, _ = _jax_stage1(_jax_tool_as_port(tiny.parent / "jax64"), per_epoch,
                                     float64=True)

    init = JaxVGG(n_classes=er.N_CLASSES, plan=er.VGG_PLAN).init(
        jax.random.PRNGKey(er.SEED), jnp.zeros((1, 64, 64, 3)), train=False)
    port = {}

    def load_jax_init(model, generator):
        port["model"] = load_port(model, init)
        return model

    monkeypatch.setattr(init_module, "flax_init_", load_jax_init)
    losses, epochs = [], []
    real_step = classifier_module.train_step

    def step(*args, **kwargs):
        loss = real_step(*args, **kwargs)
        losses.append(float(loss))
        return loss

    monkeypatch.setattr(classifier_module, "train_step", step)

    def log(msg):
        if msg.startswith("[stage1 epoch"):
            epochs.append(jax.tree.map(np.array, to_jax_variables(port["model"])))

    _, acc = er.stage1_classifier(log, torch.device("cpu"), er.SEED)
    assert len(epochs) == len(want) == len(ref) == EPOCHS
    assert len(losses) == len(want_losses) == EPOCHS * per_epoch
    for e in range(EPOCHS):
        for part in ("params", "batch_stats"):
            own = _rel_l2(want[e][part], ref[e][part])
            got = _rel_l2(epochs[e][part], ref[e][part])
            assert got <= GAP_FACTOR * own, (e, part, got, own)
        span = slice(e * per_epoch, (e + 1) * per_epoch)
        got, own, ref_loss = (np.mean(losses[span]) - np.mean(ref_losses[span]),
                              np.mean(want_losses[span]) - np.mean(ref_losses[span]),
                              np.mean(ref_losses[span]))
        assert abs(got) <= max(GAP_FACTOR * abs(own), LOSS_RTOL * ref_loss), (e, got, own)
    assert acc == want_acc


# stage 2: 2 epochs x 4 Adamax steps of a 2-scale NVAE; the port's float32
# run stays within float32 noise of JAX's (2e-5 of the weights' norm), leaf
# by leaf in L2: |port - JAX| <= rtol |JAX| + atol sqrt(size). Adamax
# divides by max(|g|, eps=1e-3), so where a gradient element is near eps its
# float32 noise changes that element's step by up to lr = 6e-3 (one element
# of a depthwise kernel stood 6.5e-4 apart after 4 steps), and a parameter
# whose true gradient is 0 (a conv bias feeding a training BatchNorm) moves
# by normalized noise: up to ~1.5e-4 after 8 steps, hence the absolute term.
# The losses sum over every pixel (~2e4).
STAGE2_TOL = dict(rtol=1e-3, atol=3e-4)
STAGE2_LOSS_RTOL = 1e-5


def _assert_leaves_close_l2(got, want, what, rtol, atol):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        w = np.asarray(w, np.float64)
        diff = np.linalg.norm(np.asarray(got[path], np.float64) - w)
        assert diff <= rtol * np.linalg.norm(w) + atol * np.sqrt(w.size), (what, path, diff)


def _latent_draws(key, cfg, shape):
    """The draws of one JAX train step from its key, NCHW tensors: the
    input noise, then one normal a latent group (the split of
    gen_adversarial_tpu/train/nvae.py and models/nvae/model.py)."""
    key, kn = jax.random.split(key)
    draws = [torch.tensor(np.asarray(jax.random.normal(kn, shape)))]
    keys = jax.random.split(key, cfg.n_latents + 1)
    draws += [torch.tensor(np.asarray(jax.random.normal(k, (s[0], s[2], s[3], s[1]))))
              .permute(0, 3, 1, 2).contiguous() for k, s in zip(keys, eps_shapes(cfg, shape[0]))]
    return draws


def test_stage2_epochs_match_the_jax_tools(tiny, monkeypatch):
    """stage2_nvae of both tools (fit_nvae: Adamax, the annealed balanced
    KL, input noise 0.03) over 2 epochs, from JAX's initial weights, with
    JAX's draws replayed into the port (its position_generator patched):
    after each epoch the weights, the BatchNorm statistics and the epoch's
    mean loss, recon and KL agree, and so do the reconstructions' accuracy
    and L2."""
    for name, value in dict(N_TRAIN_PER_CLASS=16, NVAE_BATCH=8, NVAE_EPOCHS=EPOCHS).items():
        monkeypatch.setattr(er, name, value)
    monkeypatch.setattr(er, "NVAE_CONFIG", dict(er.NVAE_CONFIG, num_scales=2))
    er.stage0_dataset(lambda msg: None, er.SEED)
    tool = _jax_tool_as_port(tiny.parent / "jax_work")
    cfg = er.nvae_config()
    per_epoch = er.N_CLASSES * er.N_TRAIN_PER_CLASS // er.NVAE_BATCH

    want, want_losses, keys = [], [], []
    real_make = jax_train_nvae.make_nvae_train_step

    def make(*args, **kwargs):
        tx, train_step = real_make(*args, **kwargs)

        def recorded(variables, opt_state, batch, key, global_step):
            out = train_step(variables, opt_state, batch, key, global_step)
            keys.append((key, batch["image"].shape))
            want_losses.append([float(v) for v in out[2:]])
            if len(want_losses) % per_epoch == 0:
                want.append(jax.tree.map(np.asarray, out[0]))
            return out
        return tx, recorded

    monkeypatch.setattr(jax_train_nvae, "make_nvae_train_step", make)
    clf = JaxVGG(n_classes=er.N_CLASSES, plan=er.VGG_PLAN)
    clf_init = clf.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)), train=False)
    _, _, want_meta = tool.stage2_nvae(lambda msg: None, clf, clf_init)

    jnvae = JaxNVAE(JaxNVAEConfig(**er.NVAE_CONFIG))
    x0 = jnp.zeros((1, 32, 32, 3))
    init = jax.jit(lambda k: jnvae.init({"params": k}, x0, k))(jax.random.PRNGKey(er.SEED))
    draws = [_latent_draws(k, cfg, shape) for k, shape in keys]
    port, losses, epochs = {}, [], []

    def load_jax_init(model, generator):
        port["model"] = load_port(model, init)
        return model

    real_port_make = nvae_module.make_nvae_train_step

    def port_make(*args, **kwargs):
        optimizer, train_step = real_port_make(*args, **kwargs)

        def recorded(*a):
            out = train_step(*a)
            losses.append([float(v) for v in out])
            return out
        return optimizer, recorded

    monkeypatch.setattr(nvae_module, "flax_init_", load_jax_init)
    monkeypatch.setattr(nvae_module, "make_nvae_train_step", port_make)
    monkeypatch.setattr(nvae_module, "position_generator",
                        lambda device, seed, step: draws[step])

    def log(msg):
        if msg.startswith("[nvae epoch"):
            epochs.append(jax.tree.map(np.array, to_jax_variables(port["model"])))

    port_clf = load_port(VGG11BN(er.N_CLASSES, plan=er.VGG_PLAN, device="cpu"), clf_init)
    _, meta = er.stage2_nvae(log, port_clf, torch.device("cpu"), er.SEED)
    assert len(epochs) == len(want) == EPOCHS and len(losses) == EPOCHS * per_epoch
    for e in range(EPOCHS):
        _assert_leaves_close_l2(epochs[e], want[e], f"epoch {e + 1}", **STAGE2_TOL)
        span = slice(e * per_epoch, (e + 1) * per_epoch)
        np.testing.assert_allclose(np.mean(losses[span], 0), np.mean(want_losses[span], 0),
                                   rtol=STAGE2_LOSS_RTOL)
    assert meta["recon_acc"] == want_meta["recon_acc"]
    np.testing.assert_allclose(meta["recon_l2"], want_meta["recon_l2"], rtol=1e-4)


INIT_SEEDS = 4
# a two-sample test per leaf at 5 standard errors: the means' difference
# against the pooled spread x sqrt(2 / n), the standard deviations' ratio
# against sqrt(1 / n) (n draws a side over the seeds)
INIT_Z = 5.0


@pytest.mark.parametrize("model", ["vgg", "nvae"])
def test_flax_init_draws_flax_inits_distribution(model):
    """The efficacy twin's fresh weights (`flax_init_`, the port's trainers'
    start) against flax's `model.init` of the same JAX module (the JAX
    tool's start), over 4 seeds each: the same leaves and shapes, leaves
    that flax makes exactly 0 or 1 equal, every other leaf alike in mean
    and standard deviation."""
    if model == "vgg":
        jax_model = JaxVGG(n_classes=er.N_CLASSES, plan=er.VGG_PLAN)
        jax_init = jax.jit(lambda k: jax_model.init(k, jnp.zeros((1, 64, 64, 3)), train=False))
        build = lambda: VGG11BN(er.N_CLASSES, plan=er.VGG_PLAN, device="cpu")  # noqa: E731
    else:
        jax_model = JaxNVAE(JaxNVAEConfig(**er.NVAE_CONFIG))
        x0 = jnp.zeros((1, 64, 64, 3))
        jax_init = jax.jit(lambda k: jax_model.init({"params": k}, x0, k))
        build = lambda: NVAE(er.nvae_config(), device="cpu")  # noqa: E731
    want = [_flat(jax_init(jax.random.PRNGKey(s))) for s in range(INIT_SEEDS)]
    got = [_flat(to_jax_variables(flax_init_(build(), torch.Generator().manual_seed(s))))
           for s in range(INIT_SEEDS)]
    assert sorted(got[0]) == sorted(want[0])
    n_random = 0
    for path in want[0]:
        assert got[0][path].shape == want[0][path].shape, path
        w = np.concatenate([t[path].ravel() for t in want])
        g = np.concatenate([t[path].ravel() for t in got])
        if np.all(w == 0) or np.all(w == 1):
            np.testing.assert_array_equal(g, w, err_msg=path)
            continue
        n_random += 1
        assert abs(g.mean() - w.mean()) <= INIT_Z * w.std() * np.sqrt(2 / w.size), path
        assert abs(g.std() / w.std() - 1) <= INIT_Z * np.sqrt(1 / w.size), path
    assert n_random > 0

"""The competitors from files and the competitor CLIs on the CPU: the six
competitor_{avae,ndvae}_{ids,gender,cars} configs loaded by the port's
load_defense give the logits of the JAX package's load_defense on the same
checkpoints (written by the JAX save_variables, the purifiers at the
configs' widths, both factories' classifier patched to a tiny VGG), batch 1
under EoT-2 from the same draws; bfloat16 raises for the A-VAE on both
sides. Then cli/train_avae.py (a resumed run bit-identical to an unbroken
one), cli/train_ndvae.py and cli/trades_finetune.py with --device cpu at
tiny sizes, their files read by the JAX package's load_variables."""

import shutil
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

import gen_adversarial_tpu.eval.factory as jax_factory
import gen_adversarial_tpu_torch.eval.factory as factory
import gen_adversarial_tpu_torch.train.ndvae as tndvae_train
from gen_adversarial_tpu.core.checkpoint import load_variables as jax_load
from gen_adversarial_tpu.core.checkpoint import save_variables as jax_save
from gen_adversarial_tpu.defenses.eot import eot_wrap as jax_eot
from gen_adversarial_tpu.models.avae.model import StyledGenerator as JaxStyledGenerator
from gen_adversarial_tpu.models.classifiers import VGG11BN as JaxVGG
from gen_adversarial_tpu.models.ndvae.model import DefenceNVAE as JaxNDVAE
from gen_adversarial_tpu_torch.cli import trades_finetune, train_avae, train_ndvae
from gen_adversarial_tpu_torch.core.config import IMAGE_SIZE, N_CLASSES, DefenseConfig
from gen_adversarial_tpu_torch.core.convert import to_jax_variables
from gen_adversarial_tpu_torch.models.nvae.distributions import RecordingDraws
from tests.torch_port_helpers import (  # noqa: F401 (fixtures)
    TINY_PLAN, keyed_normal_call, keyed_normal_table, no_onednn,
    one_torch_thread, patch_tiny_classifier, random_variables, rel_err)

pytestmark = pytest.mark.usefixtures("one_torch_thread", "no_onednn")

KEY = jax.random.PRNGKey(0)
EOT = 2
REPO = Path(__file__).resolve().parent.parent
# a full-width purifier and a tiny VGG in float32, summed in another order;
# relative to the largest logit
LOGIT_RTOL = 1e-4
COMPETITORS = [f"competitor_{kind}_{exp}" for kind in ("avae", "ndvae")
               for exp in ("ids", "gender", "cars")]


@pytest.fixture
def out_path(tmp_path):
    """tmp_path, emptied after the test: the A-VAE's train states are ~0.7
    GB each, and pytest keeps the temporary directories of three runs."""
    yield tmp_path
    for child in tmp_path.iterdir():
        shutil.rmtree(child) if child.is_dir() else child.unlink()


def _write_world(tmp, name):
    """A tiny VGG's and the purifier's checkpoints (JAX save_variables, random
    from a numpy seed) and the config pointing at them."""
    experiment = name.rsplit("_", 1)[1]
    size = IMAGE_SIZE[experiment]
    clf = JaxVGG(n_classes=N_CLASSES[experiment], plan=TINY_PLAN)
    clf_vars = random_variables(jax.eval_shape(lambda: clf.init(
        KEY, jnp.zeros((1, size, size, 3)), train=False)), 1)
    jax_save(tmp / "clf.msgpack", jax.tree.map(np.asarray, clf_vars), {"model_type": "vgg"})
    text = (f"classifier_path: {tmp / 'clf.msgpack'}\n"
            f"autoencoder_path: {tmp / 'purifier.msgpack'}\n")
    config = (REPO / "configs" / f"{name}.yaml").read_text()
    text += "".join(line + "\n" for line in config.splitlines() if "_path:" not in line)
    (tmp / f"{name}.yaml").write_text(text)
    cfg = DefenseConfig.from_yaml(tmp / f"{name}.yaml")
    if "avae" in name:
        model = JaxStyledGenerator(size)
        x0 = jnp.zeros((1, size // cfg.kernel_size, size // cfg.kernel_size, 3))
        variables = jax.tree.map(np.asarray, random_variables(
            jax.eval_shape(lambda: model.init(KEY, x0, KEY)), 2))
    else:
        model = JaxNDVAE(x_channels=cfg.x_channels, encoding_channels=cfg.encoding_channels,
                         pre_proc_groups=cfg.pre_proc_groups, scales=cfg.scales,
                         groups=cfg.groups, cells=cfg.cells, input_dim=size)
        variables = jax.tree.map(np.asarray, random_variables(jax.eval_shape(
            lambda: model.init(KEY, jnp.zeros((1, size, size, 3)), KEY)), 3))
    jax_save(tmp / "purifier.msgpack", variables)
    return tmp / f"{name}.yaml", size


@pytest.mark.parametrize("name", COMPETITORS)
def test_load_defense_on_competitor_configs_matches_jax(out_path, monkeypatch, name):
    patch_tiny_classifier(monkeypatch)
    config, size = _write_world(out_path, name)
    loaded = factory.load_defense(str(config), eot_steps=EOT, device="cpu")
    want_loaded = jax_factory.load_defense(str(config), eot_steps=EOT)
    assert (loaded.defense_type, loaded.eot_steps) == (want_loaded.defense_type, EOT)
    assert not loaded.defense.supports_shared_encode

    x = np.random.RandomState(4).rand(1, size, size, 3).astype(np.float32)
    rec = RecordingDraws(torch.Generator().manual_seed(6))
    with torch.no_grad():
        got = loaded.net(torch.tensor(x), rec)
    record = rec.record
    # the port's folded draws, split by EoT draw for the JAX side's keys
    if "avae" in name:
        per_draw = [([r[d:d + 1].permute(0, 2, 3, 1).numpy() for r in record[:-1]],
                     record[-1][d:d + 1].permute(0, 2, 3, 1).numpy()) for d in range(EOT)]
    else:
        per_draw = [(record[0][d:d + 1].numpy(),
                     [r[d:d + 1].permute(0, 2, 3, 1).numpy() for r in record[1:]] + [None])
                    for d in range(EOT)]
    jax_call = keyed_normal_call(KEY, per_draw)
    jnet = jax.jit(lambda d, xx: jax_eot(d, EOT)(KEY, xx))
    want = jax_call(lambda: jnet(want_loaded.defense, jnp.asarray(x)))
    assert got.shape == (1, N_CLASSES[name.rsplit("_", 1)[1]])
    assert rel_err(got.numpy(), np.asarray(want)) <= LOGIT_RTOL

    if name == "competitor_avae_ids":
        # bfloat16: JAX's A-VAE raises once its weights are traced; the port's
        # load_defense refuses the cast
        jax16 = jax_factory.load_defense(str(config), eot_steps=EOT, dtype="bfloat16")
        with pytest.raises(TypeError, match="same dtypes"):
            jnet(jax16.defense, jnp.asarray(x))
        with pytest.raises(TypeError, match="A-VAE does not run in bfloat16"):
            factory.load_defense(str(config), eot_steps=EOT, dtype="bfloat16", device="cpu")


# ---- the CLIs ---------------------------------------------------------------

def _folder(root, n_per_class, size, seed):
    rng = np.random.RandomState(seed)
    for cls in ("a", "b"):
        (root / cls).mkdir(parents=True)
        for i in range(n_per_class):
            arr = (rng.rand(size, size, 3) * 255).astype(np.uint8)
            Image.fromarray(arr).save(root / cls / f"{i}.png")
    return root


def test_train_avae_cli_resume_is_bit_identical(out_path):
    """2 iterations unbroken against 1, then --resume to 2: the state at
    iteration 1 is mid-epoch (batch 1 of 4), so the resumed run skips into
    its epoch. The same last.msgpack bytes and the same final train state;
    JAX's load_variables reads the EMA generator as a StyledGenerator(64)
    tree."""
    data = _folder(out_path / "data", 2, 64, 0)
    args = ["--path", str(data), "--img-size", "64", "--batch-size", "1", "--lr", "1e-3",
            "--save-every", "1", "--device", "cpu"]
    train_avae.main(args + ["--iters", "2", "--out", str(out_path / "A")])
    # what run A wrote and the test no longer reads (disk: ~0.8 GB)
    shutil.rmtree(out_path / "A" / "state" / "step_00000001")
    (out_path / "A" / "iter_0000000.msgpack").unlink()
    train_avae.main(args + ["--iters", "1", "--out", str(out_path / "B")])
    ema = train_avae.main(args + ["--iters", "2", "--out", str(out_path / "B"), "--resume"])
    for f in ("last.msgpack", "state/step_00000002/train_state.msgpack"):
        assert (out_path / "A" / f).read_bytes() == (out_path / "B" / f).read_bytes(), f
    assert "[resume] at iteration 1" in (out_path / "B" / "log.txt").read_text()
    variables, meta = jax_load(out_path / "A" / "last.msgpack")
    assert meta == {"img_size": 64, "iter": 2}
    shapes = jax.eval_shape(lambda: JaxStyledGenerator(64).init(
        KEY, jnp.zeros((1, 32, 32, 3)), KEY))
    assert jax.tree.structure(shapes) == jax.tree.structure(variables)
    want = to_jax_variables(ema)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(variables),
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(w), np.asarray(g), err_msg=str(path))
    assert (out_path / "A" / "iter_0000001.msgpack").exists()


ND_RECIPE = dict(image_size=32, epochs=2, lr=1e-3, batch_size=2,
                 params=dict(x_channels=3, pre_proc_groups=2, encoding_channels=4, scales=2,
                             groups=1, cells=1),
                 noise_max=0.1, use_noise=True)


def test_train_ndvae_cli_writes_what_jax_reads(tmp_path, monkeypatch):
    """The cars128 recipe made tiny: 2 epochs over 4 pairs at 32 px. The
    file is JAX's DefenceNVAE tree and purifies as the trained model does;
    the celeba64 recipe (one scale) raises."""
    monkeypatch.setitem(tndvae_train.NDVAE_RECIPES, "cars128", ND_RECIPE)
    _folder(tmp_path / "data" / "train", 2, 32, 0)
    _folder(tmp_path / "data" / "ndvae_adversaries", 2, 32, 1)
    model = train_ndvae.main(["--images-path", str(tmp_path / "data"), "--type", "cars128",
                              "--out", str(tmp_path / "out"), "--device", "cpu"])
    variables, meta = jax_load(tmp_path / "out" / "nd_vae.msgpack")
    assert meta["task"] == "cars128" and meta["params"] == ND_RECIPE["params"]
    log = (tmp_path / "out" / "log.txt").read_text()
    assert "[epoch 2/2]" in log
    jm = JaxNDVAE(input_dim=32, **ND_RECIPE["params"])
    rng = np.random.RandomState(2)
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    rec = RecordingDraws(torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = model.purify(torch.tensor(x).permute(0, 3, 1, 2), rec)
    record = rec.record
    key = jax.random.PRNGKey(1)
    jax_call = keyed_normal_table(list(zip(jax.random.split(key, 4),
                                           [r.permute(0, 2, 3, 1).numpy() for r in record])))
    want = jax_call(lambda: jm.apply(variables, jnp.asarray(x), key, method=JaxNDVAE.purify))
    assert rel_err(got.permute(0, 2, 3, 1).numpy(), np.asarray(want)) <= LOGIT_RTOL
    with pytest.raises(ValueError, match="at least 2 scales"):
        train_ndvae.main(["--images-path", str(tmp_path / "data"), "--type", "celeba64",
                          "--out", str(tmp_path / "out64"), "--device", "cpu"])


def test_trades_finetune_cli_writes_what_jax_reads(tmp_path, monkeypatch):
    """One epoch of TRADES on a tiny VGG (the ids recipe: eps 2.0, beta 1.0,
    16 inner steps) over 8 images at 64 px; the JAX VGG on the written tree
    gives the port's logits. --n-devices 2 and --distributed outside
    torchrun refuse, naming the torchrun command."""
    patch_tiny_classifier(monkeypatch)
    _folder(tmp_path / "data" / "train", 4, 64, 0)
    clf = JaxVGG(n_classes=100, plan=TINY_PLAN)
    variables = jax.tree.map(np.asarray, random_variables(jax.eval_shape(lambda: clf.init(
        KEY, jnp.zeros((1, 64, 64, 3)), train=False)), 5))
    jax_save(tmp_path / "clf.msgpack", variables, {"model_type": "vgg"})
    args = ["--data-path", str(tmp_path / "data"), "--experiment", "ids", "--classifier-path",
            str(tmp_path / "clf.msgpack"), "--epochs", "1", "--lr", "0.01", "--cumulative-bs",
            "4", "--out", str(tmp_path / "out"), "--device", "cpu"]
    state = trades_finetune.main(args)
    assert state.step == 2
    tuned, meta = jax_load(tmp_path / "out" / "last.msgpack")
    assert meta == {"experiment": "ids", "trades": {"beta": 1.0, "epsilon": 2.0}}
    moved = jax.tree.map(lambda a, b: float(np.abs(np.asarray(a) - np.asarray(b)).max()),
                         tuned["params"], variables["params"])
    assert max(jax.tree.leaves(moved)) > 0
    x = np.random.RandomState(6).rand(2, 64, 64, 3).astype(np.float32)
    want = clf.apply(tuned, (jnp.asarray(x) - 0.5) / 0.5, train=False)
    with torch.no_grad():
        got = state.model.eval()(((torch.tensor(x) - 0.5) / 0.5).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    for extra, error in ((["--n-devices", "2"], ValueError), (["--distributed"], SystemExit)):
        with pytest.raises(error, match="torchrun --nproc-per-node"):
            trades_finetune.main(args + extra)

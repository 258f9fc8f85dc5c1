"""The port's training CLIs (cli/train_classifier.py, cli/train_nvae.py)
with --device cpu on tiny folders of PNGs (built as tiny_world builds its
images): the written checkpoints load in the JAX package's load_variables
and give the JAX models the port's logits and deterministic
reconstructions; they load in the port's load_defense; and the NVAE
trainer resumes from its file."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

import gen_adversarial_tpu_torch.eval.factory as factory
import gen_adversarial_tpu_torch.train.classifier as tclf
from gen_adversarial_tpu.core.checkpoint import load_variables as jax_load
from gen_adversarial_tpu.models.classifiers import VGG11BN as JaxVGG
from gen_adversarial_tpu.models.nvae.model import NVAE as JaxNVAE
from gen_adversarial_tpu.models.nvae.model import NVAEConfig as JaxNVAEConfig
from gen_adversarial_tpu_torch.cli import train_classifier, train_nvae
from gen_adversarial_tpu_torch.models.classifiers import VGG11BN
from tests.torch_port_helpers import TINY_PLAN, no_onednn, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "no_onednn")

# ~30 float32 layers in another summation order
FORWARD_TOL = dict(rtol=1e-4, atol=1e-4)
NVAE_ARGS = ["--resolution", "64", "--channels", "4", "--scales", "1", "--groups", "1",
             "--cells", "1", "--latent", "2", "--mixtures", "3", "--batch-size", "4",
             "--lr", "6e-3", "--input-noise", "0.03", "--seed", "1", "--device", "cpu"]


def _folder(root, n_per_class, seed):
    """Two class folders of 64-px PNGs: dark 'a', bright 'b', as tiny_world."""
    rng = np.random.RandomState(seed)
    for cls in ("a", "b"):
        (root / cls).mkdir(parents=True)
        base = 60 if cls == "a" else 190
        for i in range(n_per_class):
            arr = (rng.rand(64, 64, 3) * 40 + base).clip(0, 255).astype(np.uint8)
            Image.fromarray(arr).save(root / cls / f"{i}.png")
    return root


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    _folder(root / "train", 4, 0)
    _folder(root / "validation", 2, 1)
    return root


def _images(n=3):
    return np.random.RandomState(7).rand(n, 64, 64, 3).astype(np.float32)


def test_train_classifier_cli_writes_what_jax_and_load_defense_read(data, tmp_path,
                                                                    monkeypatch):
    small = lambda t, n, device: VGG11BN(n, plan=TINY_PLAN, device=device)  # noqa: E731
    monkeypatch.setattr(tclf, "make_classifier", small)
    ckpt = tmp_path / "ckpt"
    state, history = train_classifier.main([
        "--data-path", str(data), "--model-type", "vgg", "--n-classes", "2",
        "--cumulative-bs", "4", "--image-size", "64", "--epochs", "2", "--lr", "0.05",
        "--checkpoint-path", str(ckpt), "--device", "cpu"])
    assert [h["epoch"] for h in history] == [0, 1]
    variables, meta = jax_load(ckpt / "last.msgpack")
    assert meta == {"model_type": "vgg", "n_classes": 2, "history": history}
    x = _images()
    want = JaxVGG(n_classes=2, plan=TINY_PLAN).apply(variables, (jnp.asarray(x) - 0.5) / 0.5,
                                                     train=False)
    with torch.no_grad():
        got = state.model.eval()((torch.tensor(x) - 0.5).permute(0, 3, 1, 2) / 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FORWARD_TOL)
    # the port's loader reads it too (the ids experiment's classifier, made tiny)
    monkeypatch.setattr(factory, "make_classifier",
                        lambda t, n, device: VGG11BN(2, plan=TINY_PLAN, device=device))
    model, apply = factory.load_classifier_parts("ids", str(ckpt / "last.msgpack"),
                                                 device="cpu")
    with torch.no_grad():
        np.testing.assert_allclose(apply(torch.tensor(x)).numpy(), got.numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_train_nvae_cli_writes_what_jax_reads_and_resumes(data, tmp_path, monkeypatch):
    out = tmp_path / "nvae"
    model = train_nvae.main(["--images-path", str(data / "train"), "--epochs", "2",
                             "--out", str(out)] + NVAE_ARGS)
    variables, meta = jax_load(out / "nvae.msgpack")
    assert meta["epoch"] == 1
    cfg = JaxNVAEConfig(**meta["config"])
    assert (cfg.initial_channels, cfg.num_scales, cfg.num_mixtures) == (4, 1, 3)
    x = _images()
    want = JaxNVAE(cfg).apply(variables, jnp.asarray(x), jax.random.PRNGKey(0), True,
                              method=JaxNVAE.reconstruct)
    with torch.no_grad():
        got = model.reconstruct(torch.tensor(x), deterministic=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FORWARD_TOL)
    log = (out / "log.txt").read_text()
    assert "[nvae epoch 2/2]" in log and "[done]" in log

    # a rerun with more epochs resumes after the saved epoch
    train_nvae.main(["--images-path", str(data / "train"), "--epochs", "3",
                     "--out", str(out)] + NVAE_ARGS)
    log = (out / "log.txt").read_text()
    assert f"[resume] NVAE from {out / 'nvae.msgpack'} epoch 2" in log
    assert "[nvae epoch 3/3]" in log and "[nvae epoch 1/3]" not in log
    assert jax_load(out / "nvae.msgpack")[1]["epoch"] == 2

    # the port's load_defense reads the file as an ids purifier
    ckpt = tmp_path / "clf.msgpack"
    from gen_adversarial_tpu_torch.core.checkpoint import save_variables
    from gen_adversarial_tpu_torch.core.convert import to_jax_variables
    from gen_adversarial_tpu_torch.core.init import flax_init_
    clf = flax_init_(VGG11BN(2, plan=TINY_PLAN, device="cpu"), torch.Generator().manual_seed(0))
    save_variables(ckpt, to_jax_variables(clf), {"model_type": "vgg"})
    monkeypatch.setattr(factory, "make_classifier",
                        lambda t, n, device: VGG11BN(2, plan=TINY_PLAN, device=device))
    config = tmp_path / "ours_linear_noise_ids.yaml"
    config.write_text(f"classifier_path: {ckpt}\nautoencoder_path: {out / 'nvae.msgpack'}\n"
                      "interpolation_alphas:\n- 0.5\nalpha_attenuation: 0.7\n"
                      "initial_noise_eps: 0.0\ngaussian_blur_input: false\n")
    loaded = factory.load_defense(str(config), eot_steps=2, device="cpu")
    with torch.no_grad():
        logits = loaded.net(torch.tensor(x), torch.Generator().manual_seed(0))
    assert logits.shape == (3, 2) and torch.isfinite(logits).all()

"""The port's classifier trainer against the JAX package on the CPU: the
training augmentations with each branch forced on (the JAX side's
bernoulli draws patched, its crop uniforms computed from its keys and fed
to the port), one train_step of a tiny VGG11-BN with the augmentation fixed
on both sides (loss, parameters after SGD with momentum, running
statistics), eval_step, fit's resume and its ragged validation tail, and
convert_torchvision_backbone on the torchvision-shaped references of
tests/torch_refs.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gen_adversarial_tpu_torch.train.classifier as tclf
from gen_adversarial_tpu.core import torch_convert as jconvert
from gen_adversarial_tpu.models.classifiers import ResNetBackbone as JaxResNet
from gen_adversarial_tpu.models.classifiers import VGG11BN as JaxVGG
from gen_adversarial_tpu.train import augment as jaug
from gen_adversarial_tpu.train import classifier as jclf
from gen_adversarial_tpu_torch.core import torch_convert as tconvert
from gen_adversarial_tpu_torch.core.checkpoint import latest_step
from gen_adversarial_tpu_torch.core.convert import from_jax_variables, to_jax_variables
from gen_adversarial_tpu_torch.data.datasets import ImageLabelDataset
from gen_adversarial_tpu_torch.models.classifiers import ResNetBackbone, VGG11BN
from gen_adversarial_tpu_torch.train import augment as taug
from tests.torch_port_helpers import (  # noqa: F401 (fixtures)
    TINY_PLAN, load_port, no_onednn, one_torch_thread, random_variables, tiny_world)
from tests.torch_refs import TVResNet, TVVgg, numpy_state_dict

pytestmark = pytest.mark.usefixtures("one_torch_thread", "no_onednn")

FLAGS = ("flip", "brightness", "contrast", "equalize", "grayscale")
# bilinear crops, brightness, contrast and grayscale in another op order
AUG_TOL = dict(rtol=1e-5, atol=1e-5)
# a tiny VGG's forward, backward and SGD steps in float32: an element moves
# by lr x its gradient, whose float32 error is a small part of the
# gradient's scale, whatever the element's own size
STEP_TOL = dict(rtol=1e-4, atol=1e-5)


def _jax_crop_values(key, b):
    """The crop uniforms JAX's _augment_one draws from `key`'s per-sample
    keys (area, log ratio, y0 and x0 fractions), as (b,) tensors."""
    out = {k: [] for k in ("area", "log_ratio", "y0", "x0")}
    for k in jax.random.split(key, b):
        kc = jax.random.split(k, 6)[1]
        k1, k2, k3, k4 = jax.random.split(kc, 4)
        out["area"].append(jax.random.uniform(k1, (), minval=0.75, maxval=1.0))
        out["log_ratio"].append(jax.random.uniform(k2, (), minval=jnp.log(3 / 4),
                                                   maxval=jnp.log(4 / 3)))
        out["y0"].append(jax.random.uniform(k3, ()))
        out["x0"].append(jax.random.uniform(k4, ()))
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in out.items()}


def _jax_flags(key, b):
    """The bernoulli flags JAX's _augment_one draws from `key`."""
    out = {k: [] for k in FLAGS}
    probs = dict(flip=0.5, brightness=0.3, contrast=0.3, equalize=0.3, grayscale=0.1)
    for k in jax.random.split(key, b):
        kf, _, kb1, kc2, ke1, kg = jax.random.split(k, 6)
        for name, kk in zip(FLAGS, (kf, kb1, kc2, ke1, kg)):
            out[name].append(bool(jax.random.bernoulli(kk, probs[name])))
    return {k: torch.tensor(v) for k, v in out.items()}


@pytest.mark.parametrize("forced", FLAGS + ("all",))
def test_augment_with_a_branch_forced_on_matches_jax(forced, monkeypatch):
    """JAX's bernoulli draws patched to True for the forced branch (in the
    order _augment_one draws them) and False for the others; the crop
    always on, from JAX's own uniforms."""
    b = 6
    images = np.random.RandomState(1).rand(b, 20, 20, 3).astype(np.float32)
    key = jax.random.PRNGKey(11)
    calls = {"n": 0}

    def bernoulli(k, p=0.5, shape=None):
        name = FLAGS[calls["n"] % len(FLAGS)]
        calls["n"] += 1
        return jnp.bool_(forced in (name, "all"))

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    out = jax.vmap(jaug._augment_one)(jax.random.split(key, b), jnp.asarray(images))
    want = np.asarray((out - 0.5) / 0.5)
    params = {**_jax_crop_values(key, b),
              **{name: torch.full((b,), forced in (name, "all")) for name in FLAGS}}
    got = (taug.apply_augment(torch.tensor(images), params) - 0.5) / 0.5
    np.testing.assert_allclose(got.numpy(), want, **AUG_TOL)


def test_train_augment_draws_its_values_from_the_generator():
    """train_augment = apply_augment(draw_augment(generator)), normalized;
    the draws' ranges are the pipeline's."""
    images = torch.rand(64, 8, 8, 3, generator=torch.Generator().manual_seed(0))
    got = taug.train_augment(images, torch.Generator().manual_seed(5))
    params = taug.draw_augment(torch.Generator().manual_seed(5), 64)
    torch.testing.assert_close(got, (taug.apply_augment(images, params) - 0.5) / 0.5)
    assert ((params["area"] >= 0.75) & (params["area"] < 1.0)).all()
    assert ((params["log_ratio"] >= np.log(3 / 4)) & (params["log_ratio"] < np.log(4 / 3))).all()
    assert 0 < params["grayscale"].sum() < params["brightness"].sum() < params["flip"].sum()


def _tiny(seed=0, size=32, n_classes=4):
    model = JaxVGG(n_classes=n_classes, plan=TINY_PLAN)
    variables = jax.tree.map(np.asarray, random_variables(jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)),
                           train=False)), seed))
    return model, variables


def _batch(n=8, size=32, n_classes=4, seed=0):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, n_classes, size=n).astype(np.int32)
    images = np.clip(rng.rand(n, size, size, 3).astype(np.float32) * 0.2
                     + labels[:, None, None, None] / n_classes * 0.8, 0, 1)
    return {"image": images, "label": labels}


def _assert_trees_close(got, want, what, **tol):
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    for path, w in flat:
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), err_msg=f"{what} {path}",
                                   **tol)


def test_train_step_and_eval_step_match_jax():
    """One train_step of a tiny VGG11-BN from the same weights, the
    augmentation of JAX's key fed to the port: the loss, the parameters
    after SGD (lr 0.05, momentum 0.9) and the BatchNorm statistics (flax's
    momentum 0.9 and biased variance, the projector's BatchNorm1d
    included); then a second step from there, which reads the momentum;
    then eval_step."""
    jmodel, variables = _tiny()
    state = jclf.create_train_state(jmodel, jax.random.PRNGKey(0), 32, lr=0.05)
    state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"])
    tmodel = load_port(VGG11BN(4, plan=TINY_PLAN, device="cpu"), variables)
    tstate = tclf.create_train_state(tmodel, 0.05)
    for i in range(2):
        batch = _batch(seed=i)
        key = jax.random.PRNGKey(20 + i)
        params = {**_jax_crop_values(key, 8), **_jax_flags(key, 8)}
        state, loss = jclf.train_step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                      key)
        got = tclf.train_step(tstate, batch, None, augment=lambda x, g: (
            taug.apply_augment(x, params) - 0.5) / 0.5)
        np.testing.assert_allclose(got.item(), float(loss), rtol=STEP_TOL["rtol"])
        tree = to_jax_variables(tmodel)
        _assert_trees_close(tree["params"], state.params, f"params, step {i}", **STEP_TOL)
        _assert_trees_close(tree["batch_stats"], state.batch_stats,
                            f"batch_stats, step {i}", **STEP_TOL)
    assert tstate.step == 2
    batch = _batch(n=10, seed=5)
    want_c, want_n = jclf.eval_step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    assert tclf.eval_step(tstate, batch) == (int(want_c), int(want_n))


@pytest.fixture
def world(tmp_path, monkeypatch):
    """tiny_world's 12 images (two classes), the port's fit building the
    tiny VGG in place of VGG11-BN."""
    images, _ = tiny_world(tmp_path)
    monkeypatch.setattr(tclf, "make_classifier",
                        lambda t, n, device: VGG11BN(n, plan=TINY_PLAN, device=device))
    return ImageLabelDataset(str(images), 64)


def test_fit_resumed_equals_uninterrupted_and_counts_the_ragged_tail(world, tmp_path,
                                                                     monkeypatch):
    """fit over 3 epochs, checkpointing every epoch; a second fit resumed
    from the state after epoch 2 ends with the same weights, statistics,
    loss and accuracy. Validation at batch 5 over 12 images counts the
    ragged batch of 2."""
    seen = []
    real_eval = tclf.eval_step

    def counting(state, batch):
        c, n = real_eval(state, batch)
        seen.append(n)
        return c, n

    monkeypatch.setattr(tclf, "eval_step", counting)
    kw = dict(epochs=3, lr=0.05, batch_size=5, seed=3, save_every=1, device="cpu",
              log_fn=lambda s: None)
    ckpt = tmp_path / "ckpt"
    full, history = tclf.fit("vgg", 2, 64, world, world, checkpoint_dir=str(ckpt), **kw)
    assert [h["epoch"] for h in history] == [0, 1, 2]
    assert seen == [5, 5, 2] * 3
    assert latest_step(ckpt) == 3 and (ckpt / "step_00000002").is_dir()
    assert "parameters in" in (ckpt / "log.txt").read_text()
    resumed, rhistory = tclf.fit("vgg", 2, 64, world, world, checkpoint_dir=str(ckpt),
                                 resume_step=2, **kw)
    assert rhistory == history[2:]
    assert resumed.step == full.step == 6  # 2 full batches of 5 in each epoch
    want, got = to_jax_variables(full.model), to_jax_variables(resumed.model)
    _assert_trees_close(got, want, "resumed", rtol=0, atol=0)


def test_fit_refuses_several_devices():
    """Several devices in one process name the torchrun command;
    distributed=True without a process group refuses to train alone."""
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        tclf.fit("vgg", 2, 64, None, None, 1, 0.1, 4, n_devices=2, device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        tclf.fit("vgg", 2, 64, None, None, 1, 0.1, 4, distributed=True, device="cpu")


@pytest.mark.parametrize("model_type", ["vgg", "resnet", "resnext"])
def test_convert_torchvision_backbone_matches_jax(model_type):
    """A raw torchvision state dict (the 1000-class head in it) onto the
    classifier's tree with a fresh projector: the port's tree equals the
    JAX package's leaf for leaf, and loads into the port's model."""
    torch.manual_seed(0)
    layers, kw = (1, 1, 1, 1), {}
    if model_type == "vgg":
        tv, jmodel, kw = TVVgg(TINY_PLAN, n_classes=1000), JaxVGG(4, plan=TINY_PLAN), \
            {"plan": TINY_PLAN}
        tmodel = VGG11BN(4, plan=TINY_PLAN, device="cpu")
    else:
        gw = dict(groups=32, base_width=4) if model_type == "resnext" else {}
        tv = TVResNet(layers, n_classes=1000, **gw)
        jmodel = JaxResNet(4, layers=layers, **gw)
        tmodel = ResNetBackbone(4, layers=layers, device="cpu", **gw)
        kw = {"layers": layers}
    with torch.no_grad():  # non-trivial running statistics
        for name, t in tv.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                t.uniform_(0.5, 1.5)
    raw = numpy_state_dict(tv)
    init = jax.tree.map(np.asarray, random_variables(jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)), 1))
    want = jconvert.convert_torchvision_backbone(raw, model_type, init, **kw)
    got = tconvert.convert_torchvision_backbone(raw, model_type, init, **kw)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, dict(want)))
    _assert_trees_close(got, want, "converted", rtol=0, atol=0)
    from_jax_variables(got, tmodel)

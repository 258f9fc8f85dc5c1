"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: random flax variables from a numpy seed, their transfer into a port
module, NHWC/NCHW moves, and the relative error the gradient tests bound.
JAX is imported inside the helpers that use it, so the tests that need a
card (tests/test_torch_gpu.py, run where JAX is not installed) can import
this module too."""

import re

import numpy as np
import pytest
import torch

from gen_adversarial_tpu_torch.core.convert import from_jax_variables
from gen_adversarial_tpu_torch.core.precision import BF16_GAP_FACTOR


def random_variables(variables, seed: int):
    """Every leaf of a flax variable tree (or of its `jax.eval_shape`, which
    skips compiling the init) drawn from a numpy seed, with
    scales that keep a deep eval-mode network finite and its BatchNorms
    non-trivial: kernels N(0, 1/fan_in), biases N(0, 0.05^2), BN scales
    1 + N(0, 0.1^2), running means N(0, 0.2^2), running variances U(0.5, 1.5),
    the NVAE's constant prior U(0, 1).

    StyleGAN2 leaves at the scales of their own inits: equalized `weight`
    leaves are stored at unit variance and scaled at call time, so N(0, 1)
    (which also makes every NoiseInjection weight non-zero); the style MLP's
    (`style_<i>/weight` of the generator) divided by its lr_mul 0.01, so
    N(0, 100^2); the constant input and the fixed `noise_<i>` maps N(0, 1).
    The A-VAE's equalized weights, `style_layers_<i>` included, are N(0, 1)
    as flax initializes them."""
    import jax

    rng = np.random.RandomState(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(variables)
    out = []
    for path, leaf in flat:
        names = [str(getattr(k, "key", k)) for k in path]
        name = names[-1]
        shape = tuple(leaf.shape)
        if name == "weight" and len(names) > 1 and re.fullmatch(r"style_\d+", names[-2]):
            v = rng.randn(*shape) / 0.01
        elif name == "weight" or name == "const_input" or name.startswith("noise_"):
            v = rng.randn(*shape)
        elif name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.randn(*shape) / np.sqrt(fan_in)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.randn(*shape)
        elif name == "mean":
            v = 0.2 * rng.randn(*shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "const_prior":
            v = rng.uniform(0.0, 1.0, shape)
        else:
            v = 0.05 * rng.randn(*shape)
        out.append(np.asarray(v, np.float32))
    return jax.tree_util.tree_unflatten(treedef, out)


def load_port(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Port module with the flax variables loaded, in eval mode."""
    import jax

    return from_jax_variables(jax.tree.map(np.asarray, variables), module).eval()


def to_nchw(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def rel_err(got, want) -> float:
    """max |got - want| over max |want|, in float64."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def keyed_normal_call(key, per_draw):
    """Replays numpy draws into a JAX defense that draws inside a vmap over
    `jax.random.split(key, len(per_draw))`, splitting each draw's key into
    (k_noise, k_purify) as MLVGMDefense does. per_draw[d] is the pair
    (input noise, purifier draw) of draw d, either None where that key draws
    nothing, either a list where the defense splits its key into one key a
    draw (the NVAE's k_purify: z_0, then each group; the A-VAE's k_noise: a
    noise map a progression step); a key is looked up in a
    table of these keys by the shape asked for. The value comes back in the
    dtype asked for: a bfloat16 defense gets the draws rounded, as the
    port's `Draws` rounds them to the tensor they are drawn for.

    Returns jax_call(fn): fn() run with jax.random.normal swapped for the
    lookup, restored afterwards. A key that is not in the table gives NaN,
    and the test fails; a shape that is not in it falls through to the real
    normal (flax checks some parameter shapes by evaluating their inits)."""
    return keyed_normal_calls([(key, per_draw)])


def keyed_normal_calls(pairs):
    """keyed_normal_call over several (key, per_draw) pairs in one table: a
    function jitted under the returned jax_call finds the draws of every
    key, so one trace serves calls with any of them."""
    import jax

    entries = []
    for key, per_draw in pairs:
        for d, kd in enumerate(jax.random.split(key, len(per_draw))):
            k_noise, k_purify = jax.random.split(kd)
            for k, v in zip((k_noise, k_purify), per_draw[d]):
                if isinstance(v, (list, tuple)):
                    entries += list(zip(jax.random.split(k, len(v)), v))
                else:
                    entries.append((k, v))
    return keyed_normal_table(entries)


def keyed_normal_table(entries):
    """jax_call(fn) that runs fn() with jax.random.normal(k, shape) giving
    the value of `entries` ((key, value) pairs; a None value is skipped)
    whose key is k, looked up among the values of that shape (see
    keyed_normal_call)."""
    import jax

    import jax.numpy as jnp

    tables = {}
    for k, v in entries:
        if v is None:
            continue
        keys, vals = tables.setdefault(v.shape, ([], []))
        keys.append(np.asarray(k))
        vals.append(v)
    tables = {s: (jnp.asarray(np.stack(k)), jnp.asarray(np.stack(v)))
              for s, (k, v) in tables.items()}
    real_normal = jax.random.normal

    def fake_normal(k, shape=(), dtype=None):
        dtype = jnp.result_type(float) if dtype is None else dtype  # float64 under x64
        if tuple(shape) not in tables:
            return real_normal(k, shape, dtype)
        keys, vals = tables[tuple(shape)]
        match = jnp.all(keys == k, axis=-1)
        return jnp.where(jnp.any(match), vals[jnp.argmax(match)], jnp.nan).astype(dtype)

    def jax_call(fn):
        jax.random.normal = fake_normal
        try:
            return fn()
        finally:
            jax.random.normal = real_normal

    return jax_call


def rel_l2(got, want) -> float:
    """||got - want|| / ||want||, in float64: the distance the bfloat16 tests
    hold their results to, over a whole output rather than its worst
    element (bfloat16 rounds at other places in the two frameworks)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def assert_within_bf16_gap(port16, jax16, jax32, what: str) -> tuple[float, float]:
    """The port's bfloat16 result against JAX's float32 one, within
    BF16_GAP_FACTOR x JAX bfloat16's own distance from it; returns (the
    port's distance, JAX's)."""
    err, gap = rel_l2(port16, jax32), rel_l2(jax16, jax32)
    print(f"{what}: JAX bfloat16 vs float32 {gap:.3e}; port bfloat16 vs JAX float32 "
          f"{err:.3e} (vs JAX bfloat16 {rel_l2(port16, jax16):.3e})")
    assert 0 < gap < 0.5, (what, gap)
    assert err <= BF16_GAP_FACTOR * gap, (what, err, gap)
    return err, gap


def bf16_logits(pair, x):
    """(port bfloat16, JAX bfloat16, JAX float32) logits of a defense pair
    builder: pair(bf16) -> (jax_net(defense, x), the JAX defense, jax_call,
    port_net(x)), both defenses cast by their package's defense_astype when
    bf16 is true; the JAX side jitted with the defense as an argument."""
    import jax
    import jax.numpy as jnp

    want = {}
    for bf16 in (False, True):
        jnet, jdef, jax_call, tnet = pair(bf16)
        want[bf16] = np.asarray(jax_call(lambda: jax.jit(jnet)(jdef, jnp.asarray(x))))
    with torch.no_grad():
        got = tnet(torch.tensor(x))
    assert got.dtype == torch.float32 and want[True].dtype == np.float32
    return got.numpy(), want[True], want[False]


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch on one intra-op thread for a module's tests, restored after. The
    suite runs several workers on few cores, where torch's threads wait on
    each other at every operation: a remat test of a small NVAE took 143 s
    among 4 busy workers and under 1 s alone on 8 cores (16 s with one
    thread against 8 spinning processes, over 150 s with 8 threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TINY_PLAN = (4, "M", 8, "M", 8, 8, "M", 8, 8, "M", 8, 8, "M")


def tiny_world(tmp_path, n_per_class: int = 6):
    """The synthetic world of tests/test_harness.py for the harness and the
    CLI: two class folders of 64-px PNGs (dark 'a', bright 'b', written by
    PIL) and the JAX `save_variables` checkpoint of a tiny VGG11-BN over 100
    classes, random from a numpy seed, its last bias raised on classes 0
    and 1, almost alike: the images are classified as 0 or 1, some right,
    and DeepFool crosses the boundary between the two in a few steps.
    Returns (images folder, checkpoint path)."""
    import jax
    import jax.numpy as jnp
    from PIL import Image

    from gen_adversarial_tpu.core.checkpoint import save_variables
    from gen_adversarial_tpu.models.classifiers import VGG11BN

    rng = np.random.RandomState(0)
    data_dir = tmp_path / "images"
    for cls in ("a", "b"):
        (data_dir / cls).mkdir(parents=True)
        base = 60 if cls == "a" else 190
        for i in range(n_per_class):
            arr = (rng.rand(64, 64, 3) * 40 + base).clip(0, 255).astype(np.uint8)
            Image.fromarray(arr).save(data_dir / cls / f"{i}.png")
    model = VGG11BN(n_classes=100, plan=TINY_PLAN)
    variables = jax.tree.map(np.asarray, random_variables(jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False)), 0))
    bias = variables["params"]["classifier"]["fc1"]["bias"]
    bias[0] += 3.0
    bias[1] = bias[0] - 0.02
    ckpt = tmp_path / "classifier.msgpack"
    save_variables(ckpt, variables, {"model_type": "vgg"})
    return data_dir, ckpt


def patch_tiny_classifier(monkeypatch):
    """Both factories build the tiny VGG of `tiny_world` in place of
    VGG11-BN."""
    import gen_adversarial_tpu.eval.factory as jax_factory
    import gen_adversarial_tpu_torch.eval.factory as factory
    from gen_adversarial_tpu.models.classifiers import VGG11BN as JaxVGG
    from gen_adversarial_tpu_torch.models.classifiers import VGG11BN

    monkeypatch.setattr(jax_factory, "make_classifier",
                        lambda t, n: JaxVGG(n_classes=n, plan=TINY_PLAN))
    monkeypatch.setattr(factory, "make_classifier",
                        lambda t, n, device: VGG11BN(n, plan=TINY_PLAN, device=device))


@pytest.fixture(scope="module")
def no_onednn():
    """oneDNN off for a module's tests (restored after): its convolution
    backward corrupted the heap ('double free or corruption', then an abort
    or a segfault, at random) in NVAE training steps on torch 2.13's CPU
    build; the plain CPU convolutions give the same results."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def grads_as_jax(module: torch.nn.Module) -> dict:
    """The module's parameter gradients as its flax params tree (the flax
    layouts of `to_jax_variables`; zeros where a parameter has none)."""
    import copy

    from gen_adversarial_tpu_torch.core.convert import to_jax_variables

    twin = copy.deepcopy(module)
    with torch.no_grad():
        for p, g in zip(twin.parameters(), module.parameters()):
            p.copy_(g.grad if g.grad is not None else torch.zeros_like(g))
    return to_jax_variables(twin)["params"]


# the small NVAE of the train-step tests on the card and on the CPU
SMALL_TRAIN_NVAE = dict(resolution=16, initial_channels=8, num_scales=2, num_groups_per_scale=2,
                        is_adaptive=False, num_cells_per_group=1, num_latent_per_group=4,
                        num_mixtures=3)


def small_nvae_train_case(gen: torch.Generator):
    """(cfg, model, x, draws) of one make_nvae_train_step step of the small
    NVAE: flax's init, a batch of 2 images and the step's draws (the input
    noise, then the latents), all from `gen`, on the CPU."""
    from gen_adversarial_tpu_torch.core.init import flax_init_
    from gen_adversarial_tpu_torch.models.nvae.model import NVAE, NVAEConfig, eps_shapes

    cfg = NVAEConfig(**SMALL_TRAIN_NVAE)
    model = flax_init_(NVAE(cfg, device="cpu"), gen)
    x = torch.rand((2, 16, 16, 3), generator=gen)
    draws = [torch.randn((2, 16, 16, 3), generator=gen)]
    draws += [torch.randn(s, generator=gen) for s in eps_shapes(cfg, 2)]
    return cfg, model, x, draws


def nvae_train_step(model: torch.nn.Module, x: torch.Tensor, draws) -> tuple:
    """One make_nvae_train_step step (lr 6e-3, 100 iterations in all, input
    noise 0.03, global step 5) of `model` in place, on its device, oneDNN
    off: (loss, name -> gradient, name -> floating-point buffer)."""
    from gen_adversarial_tpu_torch.train import nvae as train_nvae

    device = next(model.parameters()).device
    _, step = train_nvae.make_nvae_train_step(model, 6e-3, 100, input_noise=0.03)
    with torch.backends.mkldnn.flags(enabled=False):
        loss = step({"image": x.to(device)}, [d.to(device) for d in draws], 5)[0].item()
    return (loss, {n: p.grad for n, p in model.named_parameters()},
            {n: b for n, b in model.named_buffers() if b.is_floating_point()})


def bn_buffer_errors(got: dict, want: dict) -> dict:
    """Each floating-point buffer's error after a training step, in the units
    of what it normalises: a BatchNorm's `running_mean` by max |got - want|
    / sqrt(want's `running_var`) over its channels (the units of the
    activations it centres: a mean that is rounding noise next to its
    activations' spread, as after a BN that follows another BN, moves by
    its own size under a change of 1e-6 in the draws), every other buffer
    (`running_var` among them) by max |got - want| over max |want|.
    got / want: name -> tensor; returns name -> error."""
    errors = {}
    for name, w in want.items():
        w = w.double()
        diff = (got[name].double().cpu() - w).abs()
        if name.endswith("running_mean"):
            var = want[name[:-len("mean")] + "var"].double()
            errors[name] = (diff / var.clamp(min=1e-30).sqrt()).max().item()
        else:
            errors[name] = (diff.max() / w.abs().max().clamp(min=1e-12)).item()
    return errors


def assert_bn_buffers_close(got: dict, want: dict, tol: float = 1e-4) -> None:
    """Every buffer within `tol` by bn_buffer_errors; the message names the
    worst one."""
    errors = bn_buffer_errors(got, want)
    worst = max(errors, key=errors.get)
    assert errors[worst] <= tol, f"{worst}: {errors[worst]:.3e} > {tol:.0e}"


def small_vgg_train_case(gen: torch.Generator):
    """(model, batch, augment) of one train_step of a small VGG11-BN over 10
    classes: flax's init, 4 images of 16 px and their labels, and the
    training augmentation with its parameters drawn once, all from `gen`,
    on the CPU."""
    from gen_adversarial_tpu_torch.core.init import flax_init_
    from gen_adversarial_tpu_torch.models.classifiers import VGG11BN
    from gen_adversarial_tpu_torch.train import augment

    model = flax_init_(VGG11BN(10, plan=(8, "M", 16, "M", 16, "M"), device="cpu"), gen)
    batch = {"image": torch.rand((4, 16, 16, 3), generator=gen),
             "label": torch.randint(0, 10, (4,), generator=gen)}
    params = augment.draw_augment(gen, 4)

    def fixed(images, generator):
        out = augment.apply_augment(images, {k: v.to(images.device) for k, v in params.items()})
        return (out - 0.5) / 0.5

    return model, batch, fixed


def vgg_train_step(model: torch.nn.Module, batch: dict, augment) -> tuple:
    """One train_step (SGD, lr 0.01) of `model` in place, on its device,
    oneDNN off: (loss, name -> floating-point state)."""
    from gen_adversarial_tpu_torch.train import classifier as train_clf

    with torch.backends.mkldnn.flags(enabled=False):
        loss = train_clf.train_step(train_clf.create_train_state(model, 0.01), batch, None,
                                    augment=augment).item()
    return loss, {k: v for k, v in model.state_dict().items() if v.is_floating_point()}


def assert_step_close(got: dict, want: dict, before: dict, params, tol: float = 1e-4) -> None:
    """The state after one optimizer step from `before` on two devices: each
    parameter (the names in `params`) within `tol` x the largest change of
    any parameter in `want`'s step (the step's units, as the gradients are
    held against the largest gradient: a convolution's bias ahead of a
    training BatchNorm has a gradient of rounding noise, so after the step
    it is rounding noise too, and a measure relative to its own size reads
    it as 1), every other entry by bn_buffer_errors."""
    step = max((want[n] - before[n]).abs().max().item() for n in params)
    worst = max(params, key=lambda n: (got[n].double().cpu() - want[n]).abs().max().item())
    err = (got[worst].double().cpu() - want[worst]).abs().max().item()
    assert err <= tol * step, f"{worst}: {err:.3e} > {tol:.0e} x the largest step {step:.3e}"
    assert_bn_buffers_close({n: got[n] for n in want if n not in params},
                            {n: want[n] for n in want if n not in params}, tol)

"""The port's reference-checkpoint converters (core/torch_convert.py,
core/stylegan_convert.py, core/avae_convert.py, core/ndvae_convert.py) and
their CLI (cli/convert_checkpoints.py) against the JAX package's, on
reference-format state dicts fabricated by tests/torch_reference_layout.py
from random flax trees (`jax.eval_shape` of the JAX module's init, filled by
`torch_port_helpers.random_variables`): no released checkpoint is in the
repository.

The fabricator is held to the JAX converter first: the converter reads every
key it writes (reads recorded through the keys' own comparisons) and turns
its dict back into the tree. Then the port's converter gives the JAX
converter's tree leaf for leaf, exactly (the same paths, values and dtypes),
for each kind: the classifier as VGG and ResNet, the NVAE with and without
flow cells and in each weight-norm form, E4E (pSp), the Style-Transformer,
the A-VAE, the ND-VAE (its unsaved constant `h` drawn as JAX draws it) and
the StyleGAN2 discriminator.
The CLI writes the JAX tool's file and meta from the same `.pt`, for the six
kinds, and `load_defense` reads an ids config whose NVAE and VGG files the
port's CLI wrote."""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gen_adversarial_tpu.core import avae_convert as javae
from gen_adversarial_tpu.core import ndvae_convert as jndvae
from gen_adversarial_tpu.core import stylegan_convert as jstyle
from gen_adversarial_tpu.core import torch_convert as jconvert
from gen_adversarial_tpu.core.checkpoint import load_variables as jax_load
from gen_adversarial_tpu.models.avae.model import StyledGenerator as JaxAVAE
from gen_adversarial_tpu.models.classifiers import ResNetBackbone as JaxResNet
from gen_adversarial_tpu.models.classifiers import VGG11BN as JaxVGG
from gen_adversarial_tpu.models.e4e.psp import PSP as JaxPSP
from gen_adversarial_tpu.models.ndvae.model import DefenceNVAE as JaxNDVAE
from gen_adversarial_tpu.models.nvae.cells import make_ar_mask
from gen_adversarial_tpu.models.nvae.model import NVAE as JaxNVAE
from gen_adversarial_tpu.models.nvae.model import NVAEConfig as JaxNVAEConfig
from gen_adversarial_tpu.models.style_transformer.model import StyleTransformer as JaxTrans
from gen_adversarial_tpu.models.stylegan2.discriminator import Discriminator as JaxDiscriminator
from gen_adversarial_tpu_torch.cli import convert_checkpoints as cli
from gen_adversarial_tpu_torch.core import avae_convert as tavae
from gen_adversarial_tpu_torch.core import ndvae_convert as tndvae
from gen_adversarial_tpu_torch.core import stylegan_convert as tstyle
from gen_adversarial_tpu_torch.core import torch_convert as tconvert
from gen_adversarial_tpu_torch.core.convert import to_jax_variables
from gen_adversarial_tpu_torch.models.nvae.model import NVAEConfig
from tests import torch_reference_layout as layout
from tests.torch_port_helpers import TINY_PLAN, one_torch_thread  # noqa: F401
from tests.torch_port_helpers import patch_tiny_classifier, random_variables

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent
KEY = jax.random.PRNGKey(0)
# ids-sized (64 px) so that load_defense takes the CLI's files; adaptive
# groups (1 at the top scale, 2 below) and flow cells
NVAE_CFG = dict(resolution=64, initial_channels=8, num_scales=2, num_groups_per_scale=2,
                min_groups_per_scale=1, is_adaptive=True, num_cells_per_group=1,
                num_latent_per_group=4, num_mixtures=3, num_nf_cells=1)
ND = dict(x_channels=3, encoding_channels=4, pre_proc_groups=2, scales=2, groups=1, cells=2,
          input_dim=32)
SIZE = 32  # the StyleGAN2 generators' (E4E's stylegan_size, the Style-Transformer's)
AVAE_SIZE = 64
# a weight-norm fold (a norm, a quotient, a product in float32) against the
# weight it was made from
FOLD_TOL = dict(rtol=1e-5, atol=1e-7)


def _tree(module, *inputs, seed):
    return jax.tree.map(np.asarray, random_variables(
        jax.eval_shape(lambda: module.init(KEY, *inputs)), seed))


def _with_style_mlp(tree):
    """The PSP's tree with its generator's style MLP, which a pSp checkpoint
    holds and the converter reads, but the PSP's init does not create (its
    decode takes latents); at random_variables' scales."""
    rng = np.random.RandomState(55)
    for i in range(8):
        tree["params"]["decoder"][f"style_{i}"] = {
            "weight": (rng.randn(512, 512) / 0.01).astype(np.float32),
            "bias": (0.05 * rng.randn(512)).astype(np.float32)}
    return tree


@pytest.fixture(scope="module")
def trees():
    """name -> random flax tree (numpy), built at first use."""
    makers = {
        "vgg": lambda: _tree(JaxVGG(n_classes=100, plan=TINY_PLAN),
                             jnp.zeros((1, 64, 64, 3)), seed=1),
        "resnet": lambda: _tree(JaxResNet(4, base_width=8), jnp.zeros((1, 32, 32, 3)), seed=2),
        "nvae": lambda: _tree(JaxNVAE(JaxNVAEConfig(**dict(NVAE_CFG, num_nf_cells=None))),
                              jnp.zeros((1, 64, 64, 3)), KEY, seed=3),
        "nvae_flows": lambda: _tree(JaxNVAE(JaxNVAEConfig(**NVAE_CFG)),
                                    jnp.zeros((1, 64, 64, 3)), KEY, seed=4),
        "e4e": lambda: _with_style_mlp(_tree(JaxPSP(stylegan_size=SIZE),
                                             jnp.zeros((1, 256, 256, 3)), seed=5)),
        "trans": lambda: _tree(JaxTrans(output_size=SIZE), jnp.zeros((1, 256, 256, 3)),
                               seed=6),
        "avae": lambda: _tree(JaxAVAE(AVAE_SIZE), jnp.zeros((1, AVAE_SIZE // 4,
                                                               AVAE_SIZE // 4, 3)),
                              KEY, seed=7),
        "ndvae": lambda: _tree(JaxNDVAE(**ND), jnp.zeros((1, 32, 32, 3)), KEY, seed=8),
        "discriminator": lambda: _tree(JaxDiscriminator(SIZE),
                                       jnp.zeros((4, SIZE, SIZE, 3)), seed=9),
    }
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = makers[name]()
        return cache[name]

    return get


def _nvae_cfg(name, cls=NVAEConfig):
    return cls(**(NVAE_CFG if name == "nvae_flows" else dict(NVAE_CFG, num_nf_cells=None)))


def _nd_arch():
    return tndvae.NDVAEArch(**ND)


# (fabricate(tree), JAX converter, port converter) of each kind
KINDS = {
    "vgg": (lambda t: layout.classifier_state_dict(t, "vgg"),
            lambda sd: jconvert.convert_classifier(sd, "vgg"),
            lambda sd: tconvert.convert_classifier(sd, "vgg")),
    "resnet": (lambda t: layout.classifier_state_dict(t, "resnet"),
               lambda sd: jconvert.convert_classifier(sd, "resnet"),
               lambda sd: tconvert.convert_classifier(sd, "resnet")),
    "e4e": (lambda t: layout.psp_state_dict(t, SIZE),
            lambda sd: jstyle.convert_psp(sd, SIZE), lambda sd: tstyle.convert_psp(sd, SIZE)),
    "trans": (lambda t: layout.style_transformer_state_dict(t, SIZE),
              lambda sd: jstyle.convert_style_transformer(sd, SIZE),
              lambda sd: tstyle.convert_style_transformer(sd, SIZE)),
    "discriminator": (lambda t: layout.discriminator_state_dict(t["params"], SIZE),
                      lambda sd: jstyle.convert_discriminator(sd, SIZE),
                      lambda sd: tstyle.convert_discriminator(sd, SIZE)),
    "avae": (layout.avae_state_dict, lambda sd: javae.convert_avae(sd, AVAE_SIZE),
             lambda sd: tavae.convert_avae(sd, AVAE_SIZE)),
    "ndvae": (lambda t: layout.ndvae_state_dict(t, ND["pre_proc_groups"], ND["scales"],
                                                ND["groups"], ND["cells"]),
              lambda sd: jndvae.convert_ndvae(sd, JaxNDVAE(**ND)),
              lambda sd: tndvae.convert_ndvae(sd, _nd_arch())),
}
for _name in ("nvae", "nvae_flows"):
    for _form in layout.FORMS:
        KINDS[f"{_name}-{_form}"] = (
            lambda t, n=_name, f=_form: layout.nvae_state_dict(t, _nvae_cfg(n), f),
            lambda sd, n=_name: jconvert.convert_nvae(sd, _nvae_cfg(n, JaxNVAEConfig)),
            lambda sd, n=_name: tconvert.convert_nvae(sd, _nvae_cfg(n)))


class _Key(str):
    """A state dict key that records its original key in `reads` whenever
    a dict lookup compares it (slices, as strip_prefix takes, stay
    recording)."""
    __hash__ = str.__hash__

    def __new__(cls, value, origin, reads):
        key = super().__new__(cls, value)
        key.origin, key.reads = origin, reads
        return key

    def __eq__(self, other):
        equal = str.__eq__(self, other)
        if equal is True:
            self.reads.add(self.origin)
        return equal

    def __getitem__(self, index):
        return _Key(str.__getitem__(self, index), self.origin, self.reads)


def _recording(sd: dict):
    reads = set()
    return {_Key(k, k, reads): v for k, v in sd.items()}, reads


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_identical(got, want):
    """The same tree paths, and each leaf of the same dtype and values."""
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert np.asarray(g).dtype == np.asarray(w).dtype, path
        assert np.array_equal(np.asarray(g), np.asarray(w)), path


def _expected(kind, tree):
    """What the JAX converter should give back: the tree, its flow cells'
    masked taps zeroed, the ND-VAE's unsaved `h` drawn as JAX draws it."""
    if kind.startswith("nvae_flows") or kind == "ndvae":
        tree = jax.tree.map(np.array, tree)  # a copy: the fixture's tree is shared
    if kind.startswith("nvae_flows"):
        p = tree["params"]
        for name in (k for k in p if k.startswith("nf_cells_")):
            for cell, mirror in (("cell1", False), ("cell2", True)):
                for conv, k, zero_diag in (("conv0", 3, True), ("conv1", 5, False),
                                           ("conv2", 1, False)):
                    leaf = p[name][cell][conv]
                    leaf["kernel"] = leaf["kernel"] * make_ar_mask(k, k, mirror,
                                                                   zero_diag)[:, :, None, None]
    if kind == "ndvae":
        tree["params"]["h"] = np.asarray(jax.random.uniform(KEY, tree["params"]["h"].shape))
    return tree


@pytest.mark.parametrize("kind", list(KINDS))
def test_port_converter_equals_jax_on_fabricated_state_dict(trees, kind):
    fabricate, jax_convert, port_convert = KINDS[kind]
    tree = trees(kind.split("-")[0])
    sd = fabricate(tree)
    recording, reads = _recording(sd)
    want = jax_convert(recording)
    assert reads == set(sd), sorted(set(sd) - reads)[:5]
    expected = _expected(kind, tree)
    if kind.endswith(("weight_g", "parametrizations")):
        flat_want, flat_expected = _flat(want), _flat(expected)
        assert sorted(flat_want) == sorted(flat_expected)
        for path, e in flat_expected.items():
            np.testing.assert_allclose(flat_want[path], e, err_msg=path, **FOLD_TOL)
    else:
        _assert_identical(want, expected)
    _assert_identical(port_convert(sd), want)


def test_ndvae_h_is_jax_uniform_of_key_0():
    """The ND-VAE's unsaved `h`: the port's numpy threefry against
    jax.random.uniform(PRNGKey(0), shape) at two shapes."""
    for shape in [(1, 8, 8, 64), (7,)]:
        want = np.asarray(jax.random.uniform(KEY, shape))
        got = tndvae.jax_uniform_key0(shape)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert _nd_arch().h_shape == (1, 4, 4, 32)


def _torch_state(sd: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _pt_file(kind, tree, path) -> list:
    """A reference-format .pt of `kind` in the layout the CLI expects;
    returns the CLI arguments that name its kind and shape."""
    if kind == "classifier":
        torch.save({"epoch": 5, "state_dict": _torch_state(
            layout.classifier_state_dict(tree, "vgg"))}, path)
        return ["--model-type", "vgg"]
    if kind == "nvae":
        ckpt = layout.nvae_checkpoint(tree, _nvae_cfg("nvae_flows"), form="parametrizations")
        ckpt["state_dict_temp=0.6"] = _torch_state(ckpt["state_dict_temp=0.6"])
        torch.save(ckpt, path)
        return ["--temperature", "0.6"]
    if kind in ("e4e", "trans"):
        sd = (layout.psp_state_dict(tree, SIZE) if kind == "e4e"
              else layout.style_transformer_state_dict(tree, SIZE))
        latent_avg = torch.from_numpy(sd.pop("latent_avg"))
        torch.save({"state_dict": _torch_state(sd), "latent_avg": latent_avg,
                    "opts": {"size": SIZE}}, path)
        return ["--stylegan-size" if kind == "e4e" else "--output-size", str(SIZE)]
    if kind == "avae":
        torch.save(_torch_state(layout.avae_state_dict(tree)), path)
        return ["--image-size", str(AVAE_SIZE)]
    torch.save(_torch_state(KINDS["ndvae"][0](tree)), path)
    return ["--ndvae", *(str(ND[k]) for k in ("x_channels", "encoding_channels",
                                               "pre_proc_groups", "scales", "groups",
                                               "cells")), "--image-size", str(ND["input_dim"])]


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_convert_checkpoints",
                                                  REPO / "tools" / "convert_checkpoints.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CLI_TREES = {"classifier": "vgg", "nvae": "nvae_flows", "e4e": "e4e", "trans": "trans",
             "avae": "avae", "ndvae": "ndvae"}


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    return tmp_path_factory.mktemp("convert_cli")


@pytest.mark.parametrize("kind", list(CLI_TREES))
def test_cli_writes_the_jax_tools_file(trees, cli_files, monkeypatch, capsys, kind):
    """The port's CLI and the JAX tool (main with sys.argv patched, in
    process) on the same fabricated .pt: the same msgpack bytes, the same
    tree read back, the same meta."""
    src = cli_files / f"{kind}.pt"
    extra = _pt_file(kind, trees(CLI_TREES[kind]), src)
    port_dst, jax_dst = cli_files / f"{kind}.msgpack", cli_files / f"{kind}_jax.msgpack"
    args = ["--kind", kind, "--src", str(src)]
    _, meta = cli.main(args + ["--dst", str(port_dst)] + extra)
    monkeypatch.setattr(sys, "argv", ["convert_checkpoints.py"] + args
                        + ["--dst", str(jax_dst)] + extra)
    _jax_tool().main()
    assert "converted" in capsys.readouterr().out
    want, want_meta = jax_load(jax_dst)
    got, got_meta = jax_load(port_dst)
    _assert_identical(got, want)
    assert got_meta == want_meta == json.loads(json.dumps(meta))
    assert port_dst.read_bytes() == jax_dst.read_bytes()
    if kind == "nvae":  # what load_defense rebuilds the NVAE from
        assert NVAEConfig(**got_meta["config"]) == _nvae_cfg("nvae_flows")


def test_load_defense_reads_the_clis_files(trees, cli_files, monkeypatch):
    """An ids config whose NVAE and VGG files the port's CLI wrote (the
    tiny VGG of the factory tests): load_defense rebuilds the flow-equipped
    NVAE from the meta, holds the fabricated weights, and its EoT-2 logits
    are finite."""
    import gen_adversarial_tpu_torch.eval.factory as factory

    paths = {}
    for kind in ("classifier", "nvae"):
        src, dst = cli_files / f"{kind}_ids.pt", cli_files / f"{kind}_ids.msgpack"
        extra = _pt_file(kind, trees(CLI_TREES[kind]), src)
        cli.main(["--kind", kind, "--src", str(src), "--dst", str(dst)] + extra)
        paths[kind] = dst
    config = cli_files / "ours_linear_noise_ids.yaml"
    config.write_text(f"classifier_path: {paths['classifier']}\n"
                      f"autoencoder_path: {paths['nvae']}\n"
                      "interpolation_alphas:\n" + "- 0.5\n" * 3
                      + "alpha_attenuation: 0.7\ninitial_noise_eps: 2.0\n"
                        "gaussian_blur_input: false\n")
    patch_tiny_classifier(monkeypatch)
    loaded = factory.load_defense(str(config), eot_steps=2, device="cpu")
    assert loaded.defense.purifier.cfg == _nvae_cfg("nvae_flows")
    want_nvae = jax.tree.map(np.asarray, jconvert.convert_nvae(
        layout.nvae_state_dict(trees("nvae_flows"), _nvae_cfg("nvae_flows"), "parametrizations"),
        _nvae_cfg("nvae_flows", JaxNVAEConfig)))
    _assert_identical(to_jax_variables(loaded.defense.purifier), want_nvae)
    _assert_identical(to_jax_variables(loaded.defense.classifier), trees("vgg"))
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        logits = loaded.net(x, torch.Generator().manual_seed(1))
    assert logits.shape == (2, 100) and torch.isfinite(logits).all()

"""The port's checkpoint IO (core/checkpoint.py: a msgpack reader and writer
in Python) against flax's, and `core/convert.to_jax_variables` against
`from_jax_variables`, on the variable trees of the defenses' models: a small
ids NVAE, a small VGG11-BN, the gender PSP (E4E + StyleGAN2, at
stylegan_size 32) and a Style-Transformer (output_size 32), random from a
numpy seed. Trees the JAX `save_variables` wrote read back equal; the
port's writer writes the same bytes, which flax reads; a bfloat16 leaf and
a chunked leaf (flax's MAX_CHUNK_SIZE patched small) go both ways."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from gen_adversarial_tpu.core.checkpoint import save_variables as jax_save
from gen_adversarial_tpu.models.classifiers import VGG11BN as JaxVGG
from gen_adversarial_tpu.models.e4e.psp import PSP as JaxPSP
from gen_adversarial_tpu.models.nvae.model import NVAE as JaxNVAE
from gen_adversarial_tpu.models.nvae.model import NVAEConfig as JaxNVAEConfig
from gen_adversarial_tpu.models.style_transformer.model import (
    StyleTransformer as JaxStyleTransformer)
from gen_adversarial_tpu_torch.core import checkpoint
from gen_adversarial_tpu_torch.core.checkpoint import load_variables, save_variables
from gen_adversarial_tpu_torch.core.convert import from_jax_variables, to_jax_variables
from gen_adversarial_tpu_torch.models.classifiers import VGG11BN
from gen_adversarial_tpu_torch.models.e4e.psp import PSP
from gen_adversarial_tpu_torch.models.nvae.model import NVAE, NVAEConfig
from gen_adversarial_tpu_torch.models.style_transformer.model import StyleTransformer
from tests.torch_port_helpers import random_variables

KEY = jax.random.PRNGKey(0)
NVAE_CFG = dict(resolution=16, initial_channels=8, num_scales=2, num_groups_per_scale=2,
                is_adaptive=False, num_cells_per_group=1, num_latent_per_group=4,
                num_mixtures=3, num_nf_cells=1)
PLAN = (8, "M", 16, "M")
FAMILIES = ("nvae", "vgg", "psp", "style_transformer")


def _tree(family):
    """(numpy flax tree, port module to load it into, meta)."""
    if family == "nvae":
        model = JaxNVAE(JaxNVAEConfig(**NVAE_CFG))
        shapes = jax.eval_shape(lambda: model.init({"params": KEY}, jnp.zeros((1, 16, 16, 3)),
                                                   KEY))
        port, meta = NVAE(NVAEConfig(**NVAE_CFG), device="cpu"), {"config": NVAE_CFG}
    elif family == "vgg":
        model = JaxVGG(n_classes=10, plan=PLAN)
        shapes = jax.eval_shape(lambda: model.init(KEY, jnp.zeros((1, 16, 16, 3)), train=False))
        port, meta = VGG11BN(10, plan=PLAN, device="cpu"), {"model_type": "vgg"}
    elif family == "psp":
        model = JaxPSP(stylegan_size=32)
        shapes = jax.eval_shape(lambda: model.init(KEY, jnp.zeros((1, 64, 64, 3)),
                                                   method=JaxPSP.init_all))
        port, meta = PSP(32, device="cpu"), {"stylegan_size": 32}
    else:
        model = JaxStyleTransformer(output_size=32)
        shapes = jax.eval_shape(lambda: model.init(KEY, jnp.zeros((1, 64, 64, 3))))
        port, meta = StyleTransformer(32, device="cpu"), {"output_size": 32}
    return jax.tree.map(np.asarray, random_variables(shapes, FAMILIES.index(family))), port, meta


@pytest.fixture(scope="module")
def trees():
    cache = {}

    def get(family):
        if family not in cache:
            cache[family] = _tree(family)
        return cache[family]

    return get


@pytest.fixture
def files(tmp_path):
    """tmp_path, with its checkpoints removed after the test (a PSP tree is
    ~0.55 GB a file)."""
    yield tmp_path
    for f in tmp_path.glob("*.msgpack"):
        f.unlink()


def _assert_trees_equal(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("family", FAMILIES)
def test_trees_written_by_jax_read_back_equal(trees, files, family):
    tmp_path = files
    tree, _, meta = trees(family)
    jax_save(tmp_path / "jax.msgpack", tree, meta)
    got, got_meta = load_variables(tmp_path / "jax.msgpack")
    _assert_trees_equal(got, tree)
    assert got_meta == meta


@pytest.mark.parametrize("family", FAMILIES)
def test_port_writer_writes_the_bytes_flax_writes(trees, files, family):
    tmp_path = files
    tree, _, meta = trees(family)
    jax_save(tmp_path / "jax.msgpack", tree, meta)
    save_variables(tmp_path / "port.msgpack", tree, meta)
    data = (tmp_path / "port.msgpack").read_bytes()
    assert data == (tmp_path / "jax.msgpack").read_bytes()
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    _assert_trees_equal(serialization.msgpack_restore(data), tree)


@pytest.mark.parametrize("family", FAMILIES)
def test_to_jax_variables_inverts_from_jax_variables(trees, family):
    tree, port, _ = trees(family)
    _assert_trees_equal(to_jax_variables(from_jax_variables(tree, port)), tree)


def test_bfloat16_and_chunked_leaves_both_ways(tmp_path, monkeypatch):
    """A bfloat16 leaf comes back as a torch.bfloat16 tensor over the same
    bits; an array above MAX_CHUNK_SIZE (patched to 64 bytes on both sides)
    is written and read as flax's chunked-array dict, a bfloat16 one too;
    a bfloat16 leaf loads into a float32 module."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(checkpoint, "MAX_CHUNK_SIZE", 64)
    rng = np.random.RandomState(0)
    big = rng.randn(10, 9).astype(np.float32)          # 360 bytes: 6 chunks
    bf = jnp.asarray(rng.randn(3, 4), jnp.bfloat16)     # 24 bytes
    bf_big = jnp.asarray(rng.randn(7, 11), jnp.bfloat16)  # 154 bytes: 3 chunks
    tree = {"params": {"big": big, "bf": bf, "bf_big": bf_big,
                       "small": np.arange(5, dtype=np.int32)}}
    jax_save(tmp_path / "jax.msgpack", tree)
    got, meta = load_variables(tmp_path / "jax.msgpack")
    assert meta == {}
    np.testing.assert_array_equal(got["params"]["big"], big)
    np.testing.assert_array_equal(got["params"]["small"], tree["params"]["small"])
    for name in ("bf", "bf_big"):
        leaf = got["params"][name]
        assert isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
        want = np.asarray(tree["params"][name]).view(np.uint16)
        np.testing.assert_array_equal(leaf.view(torch.uint16).numpy(), want)
    save_variables(tmp_path / "port.msgpack", got)
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "jax.msgpack").read_bytes()
    back = serialization.msgpack_restore((tmp_path / "port.msgpack").read_bytes())
    for name, leaf in tree["params"].items():
        np.testing.assert_array_equal(np.asarray(back["params"][name]), np.asarray(leaf))
    # a bfloat16 tree into a float32 module: the values cast as they are copied
    vgg = VGG11BN(10, plan=PLAN, device="cpu")
    bf_tree = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)).to(torch.bfloat16),
                           to_jax_variables(vgg))
    from_jax_variables(bf_tree, vgg)
    assert vgg.conv0.weight.dtype == torch.float32
    torch.testing.assert_close(vgg.conv0.weight.permute(2, 3, 1, 0),
                               bf_tree["params"]["conv0"]["kernel"].float(), rtol=0, atol=0)


def test_malformed_files_raise_naming_the_file(tmp_path):
    save_variables(tmp_path / "t.msgpack", {"params": {"a": np.arange(6.0)}})
    data = (tmp_path / "t.msgpack").read_bytes()
    (tmp_path / "cut.msgpack").write_bytes(data[:-5])
    (tmp_path / "long.msgpack").write_bytes(data + b"\x00")
    (tmp_path / "empty.msgpack").write_bytes(b"")
    for name in ("cut", "long", "empty"):
        with pytest.raises(ValueError, match=f"{name}.msgpack"):
            load_variables(tmp_path / f"{name}.msgpack")


def test_train_state_names_its_trainer(tmp_path):
    """A trainer's state reads back under its own name only: one trainer's
    loader refuses another's file in the same step directory layout."""
    tree = {"it": 3, "w": np.arange(4.0, dtype=np.float32)}
    checkpoint.save_state(tmp_path, 3, "avae", tree)
    got = checkpoint.load_state(tmp_path, 3, "avae")
    assert got["trainer"] == "avae" and int(got["it"]) == 3
    np.testing.assert_array_equal(np.asarray(got["w"]), tree["w"])
    assert checkpoint.latest_step(tmp_path) == 3
    with pytest.raises(ValueError, match="'avae' trainer's state, not the 'classifier'"):
        checkpoint.load_state(tmp_path, 3, "classifier")

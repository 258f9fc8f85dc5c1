"""The port's NVAE regularizers (models/nvae/regularization.py) against the
JAX package's on a small NVAE with flow cells (its masked and depthwise
kernels included): the spectral loss, its new singular-vector state and its
weight gradient from the same initial u and v, the warm-up of
init_sr_state from JAX's own normals, and batch_norm_loss."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gen_adversarial_tpu.models.nvae import regularization as jreg
from gen_adversarial_tpu.models.nvae.model import NVAE as JaxNVAE
from gen_adversarial_tpu.models.nvae.model import NVAEConfig as JaxNVAEConfig
from gen_adversarial_tpu_torch.models.nvae import regularization as treg
from gen_adversarial_tpu_torch.models.nvae.model import NVAE, NVAEConfig
from tests.torch_port_helpers import (  # noqa: F401 (fixtures)
    grads_as_jax, load_port, one_torch_thread, random_variables, rel_err)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CFG = dict(resolution=16, initial_channels=8, n_pre_post_blocks=1, n_pre_post_cells=2,
           num_scales=2, num_groups_per_scale=2, is_adaptive=False,
           num_cells_per_group=1, num_latent_per_group=4, num_mixtures=3, num_nf_cells=1)
# float32 matrix-vector products in another summation order, 4 to 40 power
# iterations deep
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    jnvae = JaxNVAE(JaxNVAEConfig(**CFG))
    k = jax.random.PRNGKey(0)
    variables = jax.tree.map(np.asarray, random_variables(jax.eval_shape(
        lambda: jnvae.init({"params": k}, jnp.zeros((1, 16, 16, 3)), k)), 5))
    return variables, load_port(NVAE(NVAEConfig(**CFG), device="cpu"), variables)


def _torch_state(state):
    return {shape: {k: torch.tensor(np.asarray(v)) for k, v in st.items()}
            for shape, st in state.items()}


def _assert_states_close(got, want):
    assert set(got) == set(want)
    for shape in want:
        for k in ("u", "v"):
            np.testing.assert_allclose(got[shape][k].numpy(), np.asarray(want[shape][k]),
                                       err_msg=f"{shape} {k}", **TOL)


def test_init_sr_state_matches_jax(models):
    """The same normals (JAX's, one key split a group, u then v) warmed up
    by 9 x 4 power iterations: the same states, group by group in JAX's
    order."""
    variables, tnvae = models
    key = jax.random.PRNGKey(3)
    want = jreg.init_sr_state(variables["params"], key)  # eager: its groups' order
    draws, k = [], key
    for (n, r, c) in [(len(st["u"]),) + shape for shape, st in want.items()]:
        k, k1, k2 = jax.random.split(k, 3)
        draws += [torch.tensor(np.asarray(jax.random.normal(k1, (n, r)))),
                  torch.tensor(np.asarray(jax.random.normal(k2, (n, c))))]
    got = treg.init_sr_state(tnvae, draws)
    assert list(got) == list(want)  # the groups, in the order they draw
    assert len(want) > 5  # convs of many shapes, the depthwise and masked ones among them
    _assert_states_close(got, want)


def test_spectral_norm_loss_and_gradient_match_jax(models):
    variables, tnvae = models
    rng = np.random.RandomState(4)  # normalized random u and v for every group
    state = {shape: {k: (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)
                     for k, a in (("u", rng.randn(len(w), shape[0])),
                                  ("v", rng.randn(len(w), shape[1])))}
             for shape, w in jreg._conv_matrices(variables["params"]).items()}
    (want, want_state), want_grad = jax.jit(jax.value_and_grad(
        jreg.spectral_norm_loss, has_aux=True))(variables["params"], state)
    tnvae.zero_grad(set_to_none=True)
    got, got_state = treg.spectral_norm_loss(tnvae, _torch_state(state))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    _assert_states_close(got_state, want_state)
    grads = grads_as_jax(tnvae)
    flat, _ = jax.tree_util.tree_flatten_with_path(want_grad)
    kernels = 0
    for path, w in flat:
        g = grads
        for p in path:
            g = g[p.key]
        if path[-1].key == "kernel" and np.ndim(w) == 4:
            kernels += 1
            assert rel_err(g, w) <= 1e-4, path
        else:  # no other leaf is regularized
            assert not np.any(np.asarray(w)) and not np.any(np.asarray(g)), path
    assert kernels > 20


def test_batch_norm_loss_matches_jax(models):
    variables, tnvae = models
    want = jreg.batch_norm_loss(variables["params"])
    np.testing.assert_allclose(treg.batch_norm_loss(tnvae).item(), float(want), rtol=1e-6)

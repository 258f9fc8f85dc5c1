"""The port's NVAE normalizing-flow cells against the JAX package on the CPU:
the autoregressive mask, one flow block forward and input gradient, and a
small NVAE with `num_nf_cells=1` (weights carried over by
core/convert.from_jax_variables): its purify_decode, and the ids EoT defense
built on it, forward and input gradient, every draw made by numpy and
replayed on both sides (the method and tolerances of test_torch_slice.py)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.func import vjp

from gen_adversarial_tpu.models.classifiers import VGG11BN as JaxVGG
from gen_adversarial_tpu.models.nvae import cells as jcells
from gen_adversarial_tpu.models.nvae.model import NVAE as JaxNVAE
from gen_adversarial_tpu.models.nvae.model import NVAEConfig as JaxNVAEConfig
from gen_adversarial_tpu_torch.models.classifiers import VGG11BN
from gen_adversarial_tpu_torch.models.nvae import cells as tcells
from gen_adversarial_tpu_torch.models.nvae.model import NVAE, NVAEConfig, eps_shapes
from tests.test_torch_slice import (
    B, CFG, GRAD_RTOL, N_CLASSES, PLAN, SLICE_TOL, TEMP, _eot_pair, _images)
from tests.torch_port_helpers import (  # noqa: F401 (fixture)
    load_port, one_torch_thread, random_variables, rel_err, to_nchw, to_nhwc)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NF_CFG = dict(CFG, num_nf_cells=1)
# the flow block alone: three float32 convolutions summed in another order
NF_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("mirror", [False, True])
@pytest.mark.parametrize("zero_diag", [False, True])
def test_make_ar_mask_matches_jax(k, mirror, zero_diag):
    want = jcells.make_ar_mask(k, k, mirror, zero_diag)
    got = tcells.make_ar_mask(k, k, mirror, zero_diag)
    assert got.dtype == np.float32 and got.shape == (k, k)
    np.testing.assert_array_equal(got, want)


def test_nf_block_matches_jax():
    """One NFBlock (cell1, then the mirrored cell2) on 8 x 8 latents of 4
    channels, forward and the input gradient under a numpy cotangent. Every
    tap of the random kernels is non-zero, so a mask that is not applied at
    the call shows."""
    num_z = 4
    rng = np.random.RandomState(0)
    z = rng.standard_normal((2, 8, 8, num_z)).astype(np.float32)
    jblock = jcells.NFBlock(num_z)
    variables = random_variables(jax.eval_shape(
        lambda: jblock.init(jax.random.PRNGKey(0), jnp.asarray(z))), 1)
    kernel = np.asarray(variables["params"]["cell1"]["conv1"]["kernel"])
    assert kernel.shape == (5, 5, 1, 6 * num_z) and np.all(kernel != 0)
    tblock = load_port(tcells.NFBlock(num_z, device="cpu"), variables)
    assert tuple(tblock.cell1.conv1.weight.shape) == (6 * num_z, 1, 5, 5)

    want, jvjp = jax.vjp(lambda v: jblock.apply(variables, v), jnp.asarray(z))
    got, tvjp = vjp(tblock, to_nchw(z))
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), **NF_TOL)

    g = rng.standard_normal(z.shape).astype(np.float32)
    (want_dz,) = jvjp(jnp.asarray(g))
    (got_dz,) = tvjp(to_nchw(g))
    assert rel_err(to_nhwc(got_dz), want_dz) <= GRAD_RTOL


@pytest.fixture(scope="module")
def nf_models():
    """JAX and port NVAE with flow cells, and the VGG of test_torch_slice,
    with the same random weights."""
    jcfg, tcfg = JaxNVAEConfig(**NF_CFG), NVAEConfig(**NF_CFG)
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


def test_nvae_builds_one_flow_block_per_group(nf_models):
    tnvae, tcfg = nf_models["tnvae"], nf_models["tcfg"]
    assert sorted(tnvae.nf_cells) == sorted(
        f"{s}_{g}_0" for s in range(tcfg.num_scales) for g in range(tcfg.groups_per_scale[s]))
    without = NVAE(dataclasses.replace(tcfg, num_nf_cells=None), device="cpu")
    assert len(without.nf_cells) == 0


def test_nf_purify_decode_matches_jax(nf_models, monkeypatch):
    """purify_encode then purify_decode with the flow cells after each mix;
    eps drawn by numpy, replayed in draw order (z_0, then each group)."""
    x = _images(4)
    rng = np.random.RandomState(5)
    eps = [rng.standard_normal(s).astype(np.float32) for s in eps_shapes(nf_models["tcfg"], B)]
    replay = [e.transpose(0, 2, 3, 1) for e in eps]
    real_normal = jax.random.normal

    def fake_normal(key, shape=(), dtype=jnp.float32):
        assert replay and tuple(shape) == replay[0].shape, shape
        return jnp.asarray(replay.pop(0), dtype)

    monkeypatch.setattr(jax.random, "normal", fake_normal)
    jnvae, variables = nf_models["jnvae"], nf_models["nvae_vars"]

    def purify(v, images, alphas):  # jitted: the draws are replayed as it traces
        state = jnvae.apply(v, images, method=JaxNVAE.purify_encode)
        return jnvae.apply(v, state, jax.random.PRNGKey(0), alphas, TEMP,
                           method=JaxNVAE.purify_decode)

    want = jax.jit(purify)(variables, jnp.asarray(x), jnp.asarray(nf_models["alphas"]))
    monkeypatch.setattr(jax.random, "normal", real_normal)
    assert not replay
    tnvae = nf_models["tnvae"]
    with torch.no_grad():
        got = tnvae.purify_decode(tnvae.purify_encode(torch.tensor(x)),
                                  torch.tensor(nf_models["alphas"]),
                                  [torch.tensor(e) for e in eps], TEMP)
        # the flow cells are on the path: without them the result moves
        flows = tnvae.nf_cells
        tnvae.nf_cells = torch.nn.ModuleDict({k: torch.nn.Identity() for k in flows})
        try:
            bare = tnvae.purify(torch.tensor(x), torch.tensor(nf_models["alphas"]),
                                [torch.tensor(e) for e in eps], TEMP)
        finally:
            tnvae.nf_cells = flows
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SLICE_TOL)
    assert np.abs(bare.numpy() - np.asarray(want)).max() > 100 * SLICE_TOL["atol"]


@pytest.mark.parametrize("noise_eps", [2.0, 0.0])
def test_nf_defense_matches_jax(nf_models, noise_eps):
    """The ids MLVGMDefense on the flow-equipped NVAE under EoT-4: forward,
    and the input gradient (torch.func.vjp against jax.vjp) under a
    numpy-seeded cotangent on the logits."""
    jnet, jax_call, tnet = _eot_pair(nf_models, noise_eps, None)
    x = _images(6)
    g = np.random.RandomState(8).randn(B, N_CLASSES).astype(np.float32)

    def forward_and_vjp(v, cot):
        out, pull = jax.vjp(jnet, v)
        return out, pull(cot)[0]

    # jitted once (the numpy draws are swapped in while it traces)
    want, want_dx = jax_call(lambda: jax.jit(forward_and_vjp)(jnp.asarray(x), jnp.asarray(g)))
    got, vjp_fn = vjp(tnet, torch.tensor(x))
    (got_dx,) = vjp_fn(torch.tensor(g))
    assert np.all(np.isfinite(np.asarray(want)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **SLICE_TOL)
    assert np.abs(np.asarray(want_dx)).max() > 0
    assert rel_err(got_dx.detach().numpy(), want_dx) <= GRAD_RTOL

"""remat in the port's MLVGMDefense (torch.utils.checkpoint around the
purifier, the counterpart of the JAX `remat` with remat_policy None): the
input gradients of a small gender defense and of a small ids defense are
the same with remat on and off, with draws from a torch.Generator (so the
recompute must replay the draws of the forward it replaces) and with the
class cotangents in chunks (a recompute per chunk); the route that shares
one encode across the EoT draws as well. The remat policies
(`dots_saveable`, `dots_with_no_batch_dims_saveable`: selective activation
checkpointing) give the same gradients as None, and one backward per
forward is all torch allows them, so class gradients in blocks run their
forward without the policy (plain recompute) and give policy None's
gradients as well. Also: other policy names raise, and the
factories' defaults are the JAX factory's. Port only: the JAX remat is held
against the plain defense by the JAX package's own tests."""

import inspect

import pytest
import torch

from gen_adversarial_tpu_torch.attacks import class_grads
from gen_adversarial_tpu_torch.cars import cars_defense
from gen_adversarial_tpu_torch.defenses.base import REMAT_POLICIES, MLVGMDefense
from gen_adversarial_tpu_torch.defenses.eot import eot_wrap
from gen_adversarial_tpu_torch.flagship import flagship
from gen_adversarial_tpu_torch.gender import gender_defense
from gen_adversarial_tpu_torch.models.nvae.model import NVAEConfig
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

# one torch thread (see the fixture): the suite runs several workers on few cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, EOT = 2, 4
# the same float32 operations in the same order: the recompute runs the
# forward again with the replayed draws
REMAT_RTOL = 1e-6


def _small_ids(eps):
    cfg = NVAEConfig(resolution=16, initial_channels=8, num_scales=2, num_groups_per_scale=2,
                     is_adaptive=False, num_cells_per_group=1, num_latent_per_group=4,
                     num_mixtures=3)
    return flagship(device="cpu", initial_noise_eps=eps, seed=3, cfg=cfg,
                    vgg_plan=(8, "M", 16, "M"), n_classes=10), 16


@pytest.fixture(scope="module")
def gender():
    """A small gender defense: a 32-px generator, the full-width encoder,
    one ResNet block a stage; 64-px images."""
    return gender_defense(device="cpu", seed=3, stylegan_size=32,
                          classifier_layers=(1, 1, 1, 1)), 64


def _defense(family, eps, gender):
    """The small defense of a family at initial noise eps (gender's built
    once; eps 0 takes the shared-encode route)."""
    if family == "ids":
        return _small_ids(eps)
    defense, size = gender
    defense.initial_noise_eps = eps
    return defense, size


def _grads(defense, size, remat, chunk, policy=None):
    defense.remat, defense.remat_policy = remat, policy
    x = torch.rand(B, size, size, 3, generator=torch.Generator().manual_seed(0))
    net = eot_wrap(defense, EOT)
    logits, grads = class_grads(net, x, torch.Generator().manual_seed(1),
                                cotangent_chunk=chunk)
    return logits, grads


def _rel(got, want):
    return ((got.double() - want.double()).abs().max() / want.double().abs().max()).item()


@pytest.mark.parametrize("family,eps,chunk", [
    ("gender", 4.0, 1), ("gender", 0.0, None),
    ("ids", 2.0, None), ("ids", 2.0, 3), ("ids", 0.0, 3)])
def test_remat_input_gradients_equal_the_plain_ones(gender, family, eps, chunk):
    """All class gradients of EoT-4 through the defense (eps 0: the shared
    encode, whose two halves are checkpointed apart), remat off against on,
    each from a generator seeded alike; chunk 1 and 3 run a backward, and
    under remat a recompute, per block (both sides chunked alike: another
    block size folds another batch into the convolutions)."""
    defense, size = _defense(family, eps, gender)
    want_logits, want = _grads(defense, size, False, chunk)
    got_logits, got = _grads(defense, size, True, chunk)
    assert torch.isfinite(want).all() and want.abs().max() > 0
    torch.testing.assert_close(got_logits, want_logits, rtol=0, atol=0)
    assert _rel(got, want) <= REMAT_RTOL


@pytest.mark.parametrize("family,eps", [("gender", 4.0), ("ids", 2.0)])
def test_remat_loss_gradient_equals_the_plain_one(gender, family, eps):
    """One backward of a scalar loss, as APGD and C&W take it: outside vmap,
    a recompute that drew afresh would raise nothing and give a wrong
    gradient."""
    defense, size = _defense(family, eps, gender)
    x = torch.rand(B, size, size, 3, generator=torch.Generator().manual_seed(0))
    grads = []
    for remat in (False, True):
        defense.remat = remat
        v = x.clone().requires_grad_(True)
        logits = eot_wrap(defense, EOT)(v, torch.Generator().manual_seed(1))
        weights = torch.linspace(-1.0, 1.0, logits.shape[1])
        grads.append(torch.autograd.grad((logits * weights).sum(), v)[0])
    assert grads[0].abs().max() > 0
    assert _rel(grads[1], grads[0]) <= REMAT_RTOL


@pytest.fixture(scope="module")
def policy_none():
    """(logits, class gradients) under remat with policy None, once per
    (family, eps)."""
    return {}


@pytest.mark.parametrize("family,eps", [("gender", 4.0), ("ids", 2.0), ("ids", 0.0)])
@pytest.mark.parametrize("policy", sorted(REMAT_POLICIES))
def test_remat_policies_give_the_gradients_of_policy_none(gender, policy_none, family, eps,
                                                          policy):
    """All class gradients of EoT-4 in one batched backward (the attacks'
    class_grads without a cotangent_chunk), and the logits, equal to remat
    with policy None: a policy only chooses what is saved."""
    defense, size = _defense(family, eps, gender)
    if (family, eps) not in policy_none:
        policy_none[family, eps] = _grads(defense, size, True, None)
    want_logits, want = policy_none[family, eps]
    got_logits, got = _grads(defense, size, True, None, policy)
    defense.remat_policy = None
    assert torch.isfinite(want).all() and want.abs().max() > 0
    torch.testing.assert_close(got_logits, want_logits, rtol=0, atol=0)
    assert _rel(got, want) <= REMAT_RTOL


def test_a_policy_allows_one_backward_per_forward():
    """class_grads in blocks runs a backward per block over one forward,
    and torch keeps a policy's saved outputs for one backward only: the
    forward runs without the policy, with a warning, and under each policy
    the logits and the class gradients in blocks of 3 equal policy None's
    (the same recompute, so the same float32 operations)."""
    defense, size = _small_ids(2.0)
    want_logits, want = _grads(defense, size, True, 3)
    assert torch.isfinite(want).all() and want.abs().max() > 0
    for policy in sorted(REMAT_POLICIES):
        with pytest.warns(UserWarning, match=f"remat_policy '{policy}' dropped"):
            got_logits, got = _grads(defense, size, True, 3, policy)
        torch.testing.assert_close(got_logits, want_logits, rtol=0, atol=0)
        assert _rel(got, want) <= REMAT_RTOL, policy


@pytest.mark.parametrize("policy", sorted(REMAT_POLICIES))
def test_blocked_class_grads_under_a_policy_on_the_shared_encode(policy):
    """The shared-encode route (eps 0: the encode and the decode
    checkpointed apart), class gradients in blocks of 3 under a policy
    against policy None, and against no remat at all."""
    defense, size = _small_ids(0.0)
    plain_logits, plain = _grads(defense, size, False, 3)
    want_logits, want = _grads(defense, size, True, 3)
    with pytest.warns(UserWarning, match="dropped"):
        got_logits, got = _grads(defense, size, True, 3, policy)
    torch.testing.assert_close(got_logits, want_logits, rtol=0, atol=0)
    assert _rel(got, want) <= REMAT_RTOL
    assert _rel(got, plain) <= REMAT_RTOL


def test_only_the_save_nothing_policy_is_ported():
    """None and the policies of REMAT_POLICIES are ported; any other name
    raises and lists them."""
    assert sorted(REMAT_POLICIES) == ["dots_saveable", "dots_with_no_batch_dims_saveable"]
    with pytest.raises(ValueError, match="dots_saveable.*dots_with_no_batch_dims_saveable"):
        MLVGMDefense(None, None, torch.zeros(1), None, None, None, remat=True,
                     remat_policy="nothing_saveable")


def test_factories_turn_remat_on_for_the_stylegan_families():
    """The JAX factory's rule: on for gender and cars, off for ids."""
    assert inspect.signature(gender_defense).parameters["remat"].default is True
    assert inspect.signature(cars_defense).parameters["remat"].default is True
    assert _small_ids(2.0)[0].remat is False

"""A `copy.deepcopy` of a defense is a defense of its own: for each family
(ids with flow cells, gender, cars, small, on the CPU), a copy cast by
`core/precision.defense_astype` or given other weights computes from its own
weights, and the original's logits and purified images stay exactly what
they were."""

import copy

import pytest
import torch

from gen_adversarial_tpu_torch import cars
from gen_adversarial_tpu_torch.core.precision import defense_astype
from gen_adversarial_tpu_torch.flagship import flagship
from gen_adversarial_tpu_torch.gender import gender_defense
from gen_adversarial_tpu_torch.models.nvae.model import NVAEConfig
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

IDS_CFG = NVAEConfig(resolution=16, initial_channels=8, num_scales=2, num_groups_per_scale=2,
                     is_adaptive=False, num_cells_per_group=1, num_latent_per_group=4,
                     num_mixtures=3, num_nf_cells=1)
SMALL = {  # (builder, image size)
    "ids": (lambda: flagship(device="cpu", seed=3, cfg=IDS_CFG, vgg_plan=(8, "M", 16, "M"),
                             n_classes=10), 16),
    "gender": (lambda: gender_defense(device="cpu", seed=3, stylegan_size=32,
                                      classifier_layers=(1, 1, 1, 1), remat=False), 64),
    "cars": (lambda: cars.cars_defense(device="cpu", seed=3, output_size=32,
                                       classifier_layers=(1, 1, 1, 1), remat=False),
             cars.IMAGE_SIZE),
}


def _run(defense, x):
    with torch.no_grad():
        return defense(x, torch.Generator().manual_seed(0), preds_only=False)


@torch.no_grad()
def _reweight(defense):
    gen = torch.Generator().manual_seed(1)
    for p in [*defense.purifier.parameters(), *defense.classifier.parameters()]:
        p.mul_(1 + 0.05 * torch.randn(p.shape, generator=gen))
    return defense


@pytest.mark.parametrize("change", ["astype", "reweight"])
@pytest.mark.parametrize("family", sorted(SMALL))
def test_deep_copy_computes_from_its_own_weights(family, change):
    make, size = SMALL[family]
    original = make()
    x = torch.rand(2, size, size, 3, generator=torch.Generator().manual_seed(2))
    logits, purified = _run(original, x)

    twin = copy.deepcopy(original)
    # the copy's purify halves and classifier call reach the copy's modules
    assert twin.purify_encode.__self__.model is twin.purifier
    assert twin.purify_decode.__self__.model is twin.purifier
    assert twin.classifier_apply.model is twin.classifier
    if change == "astype":
        defense_astype(twin)
        floating = [t for t in [*twin.parameters(), *twin.buffers()] if t.is_floating_point()]
        assert all(t.dtype == torch.bfloat16 for t in floating)  # the flow cells too
        assert all(t.dtype == torch.float32 for t in original.parameters())
    else:
        _reweight(twin)
    twin_logits, twin_purified = _run(twin, x)
    again_logits, again_purified = _run(original, x)

    assert torch.equal(again_logits, logits) and torch.equal(again_purified, purified)
    assert twin_logits.dtype == torch.float32 and torch.isfinite(twin_logits).all()
    assert (twin_purified - purified).abs().max() > 1e-3
    assert (twin_logits - logits).abs().max() > 1e-4

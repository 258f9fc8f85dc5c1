"""The port's bfloat16 path through the gender family on the CPU: the small
gender defense of tests/test_torch_gender.py (32-px generator, full-width
IR-SE-50 encoder, EoT-4, batch 2) cast by each package's defense_astype, on
the same weights and numpy draws. bfloat16 rounds at other places in the
two frameworks (torch's BatchNorm computes in float32 inside, flax takes
rsqrt(var + eps) in bfloat16), so the port's logits may be at most
BF16_GAP_FACTOR x as far from JAX's float32 ones as JAX's own bfloat16
logits are, measured here. The forward only: the gradients' bfloat16 path
is held on the NVAE defense (tests/test_torch_precision.py). The cars
family's counterpart is tests/test_torch_precision_cars.py."""

import pytest

from tests import test_torch_gender as gender
from tests.torch_port_helpers import (  # noqa: F401 (one_torch_thread: a fixture)
    assert_within_bf16_gap, bf16_logits, one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_gender_bf16_forward_within_jax_bf16_gap():
    """EoT-4, batch 2, initial noise eps 4.0."""
    models = gender.build_models()
    got, want16, want32 = bf16_logits(
        lambda bf16: gender._gender_pair(models, 4.0, None, bf16=bf16), gender._images(5))
    assert_within_bf16_gap(got, want16, want32, "gender EoT-4 logits")

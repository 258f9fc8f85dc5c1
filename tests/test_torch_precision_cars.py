"""The port's bfloat16 path through the cars family on the CPU: the small
cars defense of tests/test_torch_cars.py (16-px generator, the encoder at
192 x 256, EoT-2, batch 2) cast by each package's defense_astype, on the
same weights and numpy draws, held to the gap rule of
tests/test_torch_precision_gender.py."""

import pytest

from tests import test_torch_cars as cars
from tests.torch_port_helpers import (  # noqa: F401 (one_torch_thread: a fixture)
    assert_within_bf16_gap, bf16_logits, one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_cars_bf16_forward_within_jax_bf16_gap():
    """EoT-2, batch 2, initial noise eps 4.0."""
    models = cars.build_models()
    got, want16, want32 = bf16_logits(
        lambda bf16: cars._cars_pair(models, 4.0, bf16=bf16), cars._images(5))
    assert_within_bf16_gap(got, want16, want32, "cars EoT-2 logits")

"""The decoder cell's float32 segment weights (`ResidualCellDecoder.segment_args`:
the depthwise taps and the two BatchNorm affines K1 takes) are made once and
reused, and never go stale: after a tap, a BN statistic, the whole state or
the dtype changes, the cell computes what a cell with no cache computes."""

import copy

import pytest
import torch

from gen_adversarial_tpu_torch.core.precision import defense_astype
from gen_adversarial_tpu_torch.models.nvae.cells import ResidualCellDecoder
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _cell(seed=0):
    torch.manual_seed(seed)
    cell = ResidualCellDecoder(8, 8, upsampling=False, use_se=True, device="cpu")
    with torch.no_grad():
        for bn in (cell.bn0, cell.bn1, cell.bn2, cell.bn3):
            bn.running_mean.normal_(0.0, 0.2)
            bn.running_var.uniform_(0.5, 1.5)
    return cell.requires_grad_(False).eval()


def _uncached(cell, x):
    """The cell's output with its cache emptied first: made from its
    weights as they are now."""
    cell._segment_cache = None
    return cell(x)


def test_segment_weights_are_made_once_and_follow_every_change():
    cell = _cell()
    x = torch.randn(2, 8, 9, 9, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y0 = cell(x)
        first = cell.segment_args()
        assert cell.segment_args() is first  # reused while nothing changed
        assert all(t.dtype == torch.float32 for t in first)

        changes = [
            lambda: cell.conv_depthwise.weight[3, 0, 2, 1].add_(0.5),  # a tap, in place
            lambda: cell.bn1.running_var.mul_(1.7),                     # a BN statistic
            lambda: cell.bn2.running_mean.add_(0.3),
            lambda: cell.bn2.weight.copy_(torch.linspace(0.5, 1.5, 48)),
            lambda: cell.load_state_dict(_cell(seed=5).state_dict()),   # other weights
            lambda: setattr(cell.bn1.bias, "data", cell.bn1.bias.data + 0.25),  # new storage
        ]
        before = y0
        for change in changes:
            change()
            got = cell(x)
            want = _uncached(cell, x)
            assert torch.equal(got, want)
            assert (got - before).abs().max() > 1e-4
            before = got


def test_segment_weights_follow_a_cast_and_a_copy():
    cell = _cell()
    x = torch.randn(2, 8, 9, 9, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        y32 = cell(x)
        twin = copy.deepcopy(cell)
        twin.conv_depthwise.weight.mul_(-1.0)
        assert not torch.equal(twin(x), y32)
        assert torch.equal(cell(x), y32)  # the original's cache is its own
        defense_astype(cell)  # every floating weight to bfloat16, in place
        got = cell(x.bfloat16())
        assert all(t.dtype == torch.float32 for t in cell.segment_args())
        assert torch.equal(got, _uncached(cell, x.bfloat16()))


def test_segment_weights_are_not_cached_where_they_are_differentiated():
    cell = _cell().requires_grad_(True)
    x = torch.randn(1, 8, 9, 9, generator=torch.Generator().manual_seed(3))
    cell(x).sum().backward()
    assert cell._segment_cache is None
    assert cell.conv_depthwise.weight.grad.abs().sum() > 0

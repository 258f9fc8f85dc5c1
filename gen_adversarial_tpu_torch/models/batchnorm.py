"""BatchNorm that trains as flax's `nn.BatchNorm` does (the JAX package's
`_bn` in models/classifiers.py and models/nvae/cells.py).

In eval mode these are torch's BatchNorm layers: the running statistics
normalise. In training mode the batch is normalised by hand with flax's
statistics, mean(x) and the biased variance max(mean(x^2) - mean(x)^2, 0)
over every axis but the channels, and the running statistics move towards
those: `running = (1 - momentum) * running + momentum * batch`, where torch's
`momentum` is 1 - flax's (0.05 for the NVAE's 0.95, 0.1 for the classifiers'
0.9). torch's own training BatchNorm would store the unbiased variance, so
the running variance (which the eval decode's K1 affines read) would drift
away from JAX's.

Under a process group of more than one process (data-parallel training,
core/distributed.py) the training statistics are the global batch's, as
the JAX trainer's are (it normalises the whole sharded batch as one array):
sum(x), sum(x^2) and the count are summed over the ranks by a
differentiable all-reduce, so each rank's input gradient also carries the
other ranks' losses, as SyncBatchNorm's does.
"""

from __future__ import annotations

import torch
from torch import nn

from gen_adversarial_tpu_torch.core import distributed


class _FlaxTraining:
    def forward(self, x):
        if not self.training:
            return super().forward(x)
        dims = [0, *range(2, x.dim())]
        shape = [1, -1] + [1] * (x.dim() - 2)
        if distributed.multi_process():
            mean, var = _global_moments(x, dims)
        else:
            mean = x.mean(dims)
            var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1 - m).add_(var.detach(), alpha=m)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)


def _global_moments(x, dims):
    """flax's mean and biased variance over the ranks' concatenated batch."""
    count = x.new_tensor([x.numel() / x.shape[1]])
    sums = distributed.all_reduce_sum(torch.cat([x.sum(dims), (x * x).sum(dims), count]))
    c = x.shape[1]
    mean = sums[:c] / sums[-1]
    return mean, torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean, min=0.0)


class BatchNorm1d(_FlaxTraining, nn.BatchNorm1d):
    """nn.BatchNorm1d that trains as flax's BatchNorm (see the module)."""


class BatchNorm2d(_FlaxTraining, nn.BatchNorm2d):
    """nn.BatchNorm2d that trains as flax's BatchNorm (see the module)."""

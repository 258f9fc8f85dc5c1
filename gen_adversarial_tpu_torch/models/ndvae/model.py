"""The ND-VAE competitor on NCHW tensors (counterpart of
gen_adversarial_tpu/models/ndvae/model.py): a simplified NVAE denoiser
trained on (adversarial -> clean) pairs, whose purify is the mean of its
10-mixture discretized logistic, mapped to [0, 1].

In eval mode every BatchNorm uses its running statistics; under
`module.train()` it normalises with the batch's statistics and moves its
running ones as flax's BatchNorm does (`models/batchnorm.py`; flax's
momentum 0.9). Its Normal adds 1e-2 to sigma after the soft clamp, unlike
the NVAE's.

Submodule names follow the JAX package's variable tree, so core/convert.py
maps weights by name: `pre_cells_<i>`, `enc_scales_<s>_<i>`,
`enc_combiners_<s>`, the decoder's `dec_mods_<s>_<j>_0_<c>` (a group's
cells), `dec_mods_<s>_<j>_1` (its combiner) and `dec_mods_<s>_<j>` (an
up cell), `dec_combiners_<k>`, `samplers_<k>`, `post_cells_<i>`. The
decoder's constant `h` is stored NCHW, (1, C, r, r).

Random draws come from a `Draws` source (models/nvae/distributions.py):
one eps a sampler, top first, each of its latent's NCHW shape.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from gen_adversarial_tpu_torch.models.batchnorm import BatchNorm2d
from gen_adversarial_tpu_torch.models.nvae.distributions import (
    DiscMixLogistic, Draws, as_draws, soft_clamp)
from gen_adversarial_tpu_torch.ops.image import clamp01, upsample_bilinear2x


class NDNormal:
    """N(soft_clamp(mu), temp * (exp(soft_clamp(log_sigma)) + 1e-2))."""

    def __init__(self, mu, log_sigma, temp: float = 1.0):
        self.mu = soft_clamp(mu)
        self.sigma = torch.exp(soft_clamp(log_sigma)) + 1e-2
        if temp != 1.0:
            self.sigma = self.sigma * temp

    def sample(self, draws: Draws):
        eps = draws.normal(self.mu.shape, self.mu)
        return self.mu + eps * self.sigma, eps

    def log_p(self, samples):
        z = (samples - self.mu) / self.sigma
        return -0.5 * z * z - 0.5 * math.log(2 * math.pi) - torch.log(self.sigma)

    def kl(self, other: "NDNormal"):
        t1 = (self.mu - other.mu) / other.sigma
        t2 = self.sigma / other.sigma
        return 0.5 * (t1 * t1 + t2 * t2) - 0.5 - torch.log(t2)


def _bn(ch: int, device) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=1e-5, momentum=0.1, device=device)


def _conv1x1(in_ch: int, out_ch: int, device, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_ch, out_ch, 1, stride=stride, device=device)


class NDSE(nn.Module):
    def __init__(self, channels: int, device=None):
        super().__init__()
        hidden = max(channels // 16, 4)
        self.fc1 = nn.Linear(channels, hidden, device=device)
        self.fc2 = nn.Linear(hidden, channels, device=device)

    def forward(self, x):
        se = torch.sigmoid(self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3))))))
        return x * se[:, :, None, None]


class FactorizedReduce(nn.Module):
    """SiLU, then four stride-2 1x1 convs of the input shifted by (0, 0),
    (1, 1), (0, 1) and (1, 0) pixels (rows, columns), concatenated."""

    def __init__(self, in_ch: int, out_ch: int, device=None):
        super().__init__()
        c4 = out_ch // 4
        self.conv_1 = _conv1x1(in_ch, c4, device, 2)
        self.conv_2 = _conv1x1(in_ch, c4, device, 2)
        self.conv_3 = _conv1x1(in_ch, c4, device, 2)
        self.conv_4 = _conv1x1(in_ch, out_ch - 3 * c4, device, 2)

    def forward(self, x):
        out = F.silu(x)
        return torch.cat([self.conv_1(out), self.conv_2(out[:, :, 1:, 1:]),
                          self.conv_3(out[:, :, :, 1:]), self.conv_4(out[:, :, 1:, :])], dim=1)


class ResidualCell(nn.Module):
    """(BN, SiLU, conv3x3) x 2 + SE, and the skip (a FactorizedReduce when
    the cell halves the resolution)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, device=None):
        super().__init__()
        self.skip = FactorizedReduce(in_ch, out_ch, device) if stride != 1 else None
        self.bn1 = _bn(in_ch, device)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, stride=stride, padding=1, device=device)
        self.bn2 = _bn(out_ch, device)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1, device=device)
        self.se = NDSE(out_ch, device)

    def forward(self, x):
        skip = x if self.skip is None else self.skip(x)
        y = self.conv1(F.silu(self.bn1(x)))
        y = self.conv2(F.silu(self.bn2(y)))
        return skip + self.se(y)


class GenerativeCell(nn.Module):
    """MBConv cell: BN, 1x1 expand by e_param, BN, SiLU, 5x5 depthwise, 1x1,
    BN, SiLU, 1x1 project, BN, SE; with upsample, nearest x2 and a skip of a
    bilinear (align_corners) x2 resize and a 1x1 halving the channels."""

    def __init__(self, in_channels: int, e_param: int, upsample: bool = False, device=None):
        super().__init__()
        out_ch = in_channels // 2 if upsample else in_channels
        expanded = in_channels * e_param
        self.upsample = upsample
        if upsample:
            self.skip_conv = _conv1x1(in_channels, out_ch, device)
        self.bn1 = _bn(in_channels, device)
        self.expand = _conv1x1(in_channels, expanded, device)
        self.bn_expanded1 = _bn(expanded, device)
        self.dw = nn.Conv2d(expanded, expanded, 5, padding=2, groups=expanded, device=device)
        self.pw = _conv1x1(expanded, expanded, device)
        self.bn_expanded2 = _bn(expanded, device)
        self.expand2 = _conv1x1(expanded, out_ch, device)
        self.bn2 = _bn(out_ch, device)
        self.se = NDSE(out_ch, device)

    def forward(self, x):
        if self.upsample:
            skip = self.skip_conv(upsample_bilinear2x(x))
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        else:
            skip = x
        y = F.silu(self.bn_expanded1(self.expand(self.bn1(x))))
        y = F.silu(self.bn_expanded2(self.pw(self.dw(y))))
        return skip + self.se(self.bn2(self.expand2(y)))


class Sampler(nn.Module):
    """The prior (1x1 conv of ELU(x)) and the posterior (3x3 conv of x,
    added to the prior's parameters); a latent drawn from the posterior."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.prior_conv = _conv1x1(channels, 2 * channels, device)
        self.cell = nn.Conv2d(channels, 2 * channels, 3, padding=1, device=device)

    def forward(self, x, draws: Draws):
        """-> (z, q, p, log_q(z), log_p(z))."""
        mu_p, log_sig_p = self.prior_conv(F.elu(x)).chunk(2, dim=1)
        mu_q, log_sig_q = self.cell(x).chunk(2, dim=1)
        q = NDNormal(mu_q + mu_p, log_sig_q + log_sig_p)
        z, _ = q.sample(draws)
        p = NDNormal(mu_p, log_sig_p)
        return z, q, p, q.log_p(z), p.log_p(z)


class DefenceNVAE(nn.Module):
    """Stem, pre-process tower (each group's last cell halves the resolution
    and doubles the channels), encoder scales, decoder scales with one
    sampler each (and the top one on the raw top encoding, beside the
    learned constant `h`), post-process tower, the mixture's conv."""

    FLAX_INIT = {"h": "uniform"}

    def __init__(self, x_channels: int = 3, encoding_channels: int = 16,
                 pre_proc_groups: int = 2, scales: int = 2, groups: int = 2, cells: int = 4,
                 input_dim: int = 64, num_mixtures: int = 10, device=None):
        super().__init__()
        self.scales, self.cells = scales, cells
        ch = encoding_channels
        self.stem = nn.Conv2d(x_channels, ch, 3, padding=1, device=device)

        pre, cur = [], ch
        for _ in range(pre_proc_groups):
            for c in range(cells):
                if c == cells - 1:
                    pre.append(ResidualCell(cur, cur * 2, stride=2, device=device))
                    cur *= 2
                else:
                    pre.append(ResidualCell(cur, cur, device=device))
        self.pre_cells = nn.ModuleList(pre)

        enc, enc_comb_ch = {}, []
        for s in range(scales):
            n = groups * cells
            for i in range(n):
                enc[f"{s}_{i}"] = ResidualCell(cur, cur, device=device)
            enc_comb_ch.insert(0, cur)
            if s < scales - 1:
                enc[f"{s}_{n}"] = ResidualCell(cur, cur * 2, stride=2, device=device)
                cur *= 2
        self.enc_scales = nn.ModuleDict(enc)
        self.enc_lengths = [groups * cells + (s < scales - 1) for s in range(scales)]
        self.enc_combiners = nn.ModuleList(_conv1x1(c, c, device) for c in enc_comb_ch)

        r = max(input_dim // 2 ** (scales + 1), 4)
        self.h = nn.Parameter(torch.empty(1, cur, r, r, device=device))

        dec, dec_comb_ch, self.dec_plan = {}, [], []
        for s in range(scales):
            plan = []
            for j in range(groups):
                for c in range(cells):
                    dec[f"{s}_{j}_0_{c}"] = GenerativeCell(cur, 2, device=device)
                dec[f"{s}_{j}_1"] = _conv1x1(2 * cur, cur, device)
                plan.append("group")
            dec_comb_ch.append(cur)
            if s != 0:
                dec[f"{s}_{groups}"] = GenerativeCell(cur, 2, upsample=True, device=device)
                plan.append("up")
                cur //= 2
            self.dec_plan.append(plan)
        dec_comb_ch.append(cur)
        self.dec_mods = nn.ModuleDict(dec)
        self.dec_combiners = nn.ModuleList(_conv1x1(2 * c, c, device) for c in dec_comb_ch)
        sampler_ch, c = [enc_comb_ch[0]], enc_comb_ch[0]
        for s in range(scales):
            if s != 0:
                c //= 2
            sampler_ch.append(c)
        self.samplers = nn.ModuleList(Sampler(c, device) for c in sampler_ch)

        post, mult = [], 2 ** pre_proc_groups
        for _ in range(pre_proc_groups):
            for c in range(cells):
                channels = encoding_channels * mult
                if c == 0:
                    post.append(GenerativeCell(channels, 2, upsample=True, device=device))
                    mult //= 2
                else:
                    # the reference's expansion factor is the width itself
                    post.append(GenerativeCell(channels, channels, device=device))
        self.post_cells = nn.ModuleList(post)
        self.image_conditional_conv = nn.Conv2d(
            encoding_channels, num_mixtures + num_mixtures * 3 * x_channels, 3, padding=1,
            device=device)

    def _decode(self, x, draws: Draws):
        """-> (mixture logits, [(q, p, log_q, log_p)] top first)."""
        x = self.stem(clamp01(x) * 2.0 - 1.0)
        for cell in self.pre_cells:
            x = cell(x)
        latents = [x]
        for s, n in enumerate(self.enc_lengths):
            for i in range(n):
                x = self.enc_scales[f"{s}_{i}"](x)
            latents.append(x)
        latents.reverse()

        z, *dist = self.samplers[0](latents[0], draws)
        dists = [dist]
        h = self.h.expand(z.shape[0], -1, -1, -1)
        out = self.dec_combiners[0](torch.cat([z, h], dim=1))
        for s in range(self.scales):
            y = out
            for j, kind in enumerate(self.dec_plan[s]):
                if kind == "group":
                    yy = y
                    for c in range(self.cells):
                        yy = self.dec_mods[f"{s}_{j}_0_{c}"](yy)
                    y = self.dec_mods[f"{s}_{j}_1"](torch.cat([y, yy], dim=1))
                else:
                    y = self.dec_mods[f"{s}_{j}"](y)
            combined = latents[s + 1] + self.enc_combiners[s](y)
            z, *dist = self.samplers[s + 1](combined, draws)
            dists.append(dist)
            out = self.dec_combiners[s + 1](torch.cat([z, y], dim=1))

        for cell in self.post_cells:
            out = cell(out)
        return self.image_conditional_conv(F.elu(out)), dists

    def forward(self, x, draws):
        """x: (B, 3, H, W) in [0, 1] -> (mixture logits, log_q (B,), log_p
        (B,), the per-sampler KL sums [(B,)], top first)."""
        logits, dists = self._decode(x, as_draws(draws))
        kl_all, log_q, log_p = [], 0.0, 0.0
        for q, p, lq, lp in dists:
            kl_all.append(q.kl(p).sum(dim=(1, 2, 3)))
            log_q = log_q + lq.sum(dim=(1, 2, 3))
            log_p = log_p + lp.sum(dim=(1, 2, 3))
        return logits, log_q, log_p, kl_all

    def purify(self, x, draws):
        """The defense's decode: the mixture's mean mapped to [0, 1]
        ((mean + 1) / 2, the ND-VAE's own mean), (B, 3, H, W)."""
        logits, _ = self._decode(x, as_draws(draws))
        return (DiscMixLogistic(logits).mean() + 1.0) / 2.0

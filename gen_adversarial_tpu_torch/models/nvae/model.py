"""Hierarchical NVAE on NCHW tensors (counterpart of
gen_adversarial_tpu/models/nvae/model.py): the purify path, the training
forward with its per-group KL, `reconstruction_loss`, prior `sample` and
posterior `reconstruct`.

Submodules carry the JAX variable tree's names (`init_conv`,
`pre_cells_0_0`, `enc_cells_1_0_0`, `dec_sampler_1_1`, ...: a ModuleDict
attribute plus its key), so `core/convert.py` loads JAX weights by name.
The module is built in eval mode; `module.train()` gives the training
forward its batch statistics (`models/nvae/cells.py`). With `num_nf_cells`
set, each latent group has that many normalizing-flow blocks
(`nf_cells_{s}_{g}_{i}`), applied to the group's z after it is drawn or
mixed, as in the JAX package.

Images come in and go out NHWC in [0, 1], as in the JAX package; the
mixture's logits are NCHW. Draws (a `Draws` source) are taken in JAX's
order: z_0, then each latent group in decode order, then, where the decode
is sampled, the mixture's gumbel uniforms (the logits' shape) and its
logistic uniforms (the image's shape).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gen_adversarial_tpu_torch.models.nvae.cells import (
    Conv1x1, DecCombinerCell, EncCombinerCell, NFBlock, ResidualCellDecoder,
    ResidualCellEncoder)
from gen_adversarial_tpu_torch.models.nvae.distributions import (
    DiscMixLogistic, Normal, as_draws)


@dataclass(frozen=True)
class NVAEConfig:
    """The reference's ae_args (a copy of the JAX package's NVAEConfig)."""
    resolution: int = 64
    img_channels: int = 3
    initial_channels: int = 32
    n_pre_post_blocks: int = 1      # 'num_pre-post_process_blocks'
    n_pre_post_cells: int = 2       # 'num_pre-post_process_cells'
    num_mixtures: int = 10          # 'num_logistic_mixtures'
    num_scales: int = 3
    min_groups_per_scale: int = 4   # 'min_groups_per_scale'
    num_groups_per_scale: int = 16  # 'num_groups_per_scale'
    is_adaptive: bool = True
    num_cells_per_group: int = 2
    num_latent_per_group: int = 20
    num_nf_cells: int | None = None
    use_se: bool = True

    @classmethod
    def from_reference_dict(cls, ae_args: dict, resolution: tuple) -> "NVAEConfig":
        """From the ae_args dict stored inside reference NVAE checkpoints;
        `resolution` is (channels, size)."""
        return cls(
            resolution=resolution[1], img_channels=resolution[0],
            initial_channels=ae_args["initial_channels"],
            n_pre_post_blocks=ae_args["num_pre-post_process_blocks"],
            n_pre_post_cells=ae_args["num_pre-post_process_cells"],
            num_mixtures=ae_args["num_logistic_mixtures"],
            num_scales=ae_args["num_scales"],
            min_groups_per_scale=ae_args["min_groups_per_scale"],
            num_groups_per_scale=ae_args["num_groups_per_scale"],
            is_adaptive=ae_args["is_adaptive"],
            num_cells_per_group=ae_args["num_cells_per_group"],
            num_latent_per_group=ae_args["num_latent_per_group"],
            num_nf_cells=ae_args["num_nf_cells"],
        )

    @property
    def groups_per_scale(self) -> list:
        g = [max(self.min_groups_per_scale, self.num_groups_per_scale // (2 ** i))
             if self.is_adaptive else self.num_groups_per_scale
             for i in range(self.num_scales)]
        g.reverse()
        return g

    @property
    def scaling_factor(self) -> int:
        return 2 ** (self.n_pre_post_blocks + self.num_scales - 1)

    @property
    def n_latents(self) -> int:
        return sum(self.groups_per_scale)

    def kl_alpha(self) -> np.ndarray:
        """Per-group KL weights (the square schedule over the scales), in
        decode order, normalized to min 1."""
        parts = [(2 ** i) ** 2 / self.groups_per_scale[self.num_scales - i - 1]
                 * np.ones(self.groups_per_scale[self.num_scales - i - 1])
                 for i in range(self.num_scales)]
        kl = np.concatenate(parts)
        return kl / kl.min()

    def decoder_segment_shapes(self) -> list[tuple[int, int]]:
        """(hidden channels, spatial size) of the fused depthwise segment of
        every decoder cell one decode runs, in order."""
        shapes = []
        top = self.resolution // self.scaling_factor
        ch = self.initial_channels * 2 ** (self.n_pre_post_blocks + self.num_scales - 1)
        for s in range(self.num_scales):
            res = top * 2 ** s
            shapes += [(6 * ch, res)] * (self.num_cells_per_group * (self.groups_per_scale[s] - (s == 0)))
            if s < self.num_scales - 1:
                shapes.append((6 * ch, 2 * res))
                ch //= 2
        res = top * 2 ** self.num_scales
        for b in range(self.n_pre_post_blocks):
            for c in range(self.n_pre_post_cells):
                shapes.append((3 * ch, res))
                if c == 0:
                    ch //= 2
            res *= 2
        return shapes


class NVAE(nn.Module):
    def __init__(self, cfg: NVAEConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        base = cfg.initial_channels
        gps = cfg.groups_per_scale
        se = cfg.use_se
        pre_out_mult = 2 ** cfg.n_pre_post_blocks
        enc_mult = {s: pre_out_mult * 2 ** (cfg.num_scales - 1 - s)
                    for s in range(cfg.num_scales)}
        top_mult = pre_out_mult * 2 ** (cfg.num_scales - 1)
        z = cfg.num_latent_per_group

        self.init_conv = nn.Conv2d(cfg.img_channels, base, 3, padding=1, device=device)
        pre, mult = {}, 1
        for b in range(cfg.n_pre_post_blocks):
            for c in range(cfg.n_pre_post_cells):
                last = c == cfg.n_pre_post_cells - 1
                ch = base * mult
                pre[f"{b}_{c}"] = ResidualCellEncoder(
                    ch, ch * 2 if last else ch, downsampling=last, use_se=se, device=device)
                if last:
                    mult *= 2
        self.pre_cells = nn.ModuleDict(pre)

        enc, enc_comb = {}, {}
        for s in range(cfg.num_scales - 1, -1, -1):
            ch = base * enc_mult[s]
            for g in range(gps[s] - 1, -1, -1):
                for c in range(cfg.num_cells_per_group):
                    enc[f"{s}_{g}_{c}"] = ResidualCellEncoder(
                        ch, ch, downsampling=False, use_se=se, device=device)
                if not (s == 0 and g == 0):
                    enc_comb[f"{s}_{g}"] = EncCombinerCell(ch, ch, device=device)
            if s > 0:
                enc[f"{s}_down"] = ResidualCellEncoder(
                    ch, ch * 2, downsampling=True, use_se=se, device=device)
        self.enc_cells = nn.ModuleDict(enc)
        self.enc_combiners = nn.ModuleDict(enc_comb)
        top_ch = base * top_mult
        self.encoder_0_conv = Conv1x1(top_ch, top_ch, device=device)

        enc_sampler, dec_sampler, nf = {}, {}, {}
        for s in range(cfg.num_scales):
            ch = top_ch // (2 ** s)
            for g in range(gps[s]):
                enc_sampler[f"{s}_{g}"] = nn.Conv2d(ch, 2 * z, 3, padding=1, device=device)
                for i in range(cfg.num_nf_cells or 0):
                    nf[f"{s}_{g}_{i}"] = NFBlock(z, device=device)
                if not (s == 0 and g == 0):
                    dec_sampler[f"{s}_{g}"] = Conv1x1(ch, 2 * z, device=device)
        self.enc_sampler = nn.ModuleDict(enc_sampler)
        self.dec_sampler = nn.ModuleDict(dec_sampler)
        self.nf_cells = nn.ModuleDict(nf)

        dec, dec_comb = {}, {}
        for s in range(cfg.num_scales):
            ch = top_ch // (2 ** s)
            for g in range(gps[s]):
                if not (s == 0 and g == 0):
                    for c in range(cfg.num_cells_per_group):
                        dec[f"{s}_{g}_{c}"] = ResidualCellDecoder(
                            ch, ch, upsampling=False, use_se=se, device=device)
                dec_comb[f"{s}_{g}"] = DecCombinerCell(ch + z, ch, device=device)
            if s < cfg.num_scales - 1:
                dec[f"{s}_up"] = ResidualCellDecoder(
                    ch, ch // 2, upsampling=True, use_se=se, device=device)
        self.dec_cells = nn.ModuleDict(dec)
        self.dec_combiners = nn.ModuleDict(dec_comb)

        post, mult = {}, pre_out_mult
        for b in range(cfg.n_pre_post_blocks):
            for c in range(cfg.n_pre_post_cells):
                first = c == 0
                ch = base * mult
                post[f"{b}_{c}"] = ResidualCellDecoder(
                    ch, ch // 2 if first else ch, upsampling=first, use_se=se,
                    hidden_mul=3, device=device)
                if first:
                    mult //= 2
        self.post_cells = nn.ModuleDict(post)

        out_ch = cfg.num_mixtures * (1 + 3 * cfg.img_channels)
        self.to_logits_conv = nn.Conv2d(base, out_ch, 3, padding=1, device=device)
        r = cfg.resolution // cfg.scaling_factor
        self.const_prior = nn.Parameter(torch.rand(1, top_ch, r, r, device=device))
        self.eval()

    def _preprocess(self, x):
        x = (x - 0.5) / 0.5
        x = self.init_conv(x)
        for b in range(self.cfg.n_pre_post_blocks):
            for c in range(self.cfg.n_pre_post_cells):
                x = self.pre_cells[f"{b}_{c}"](x)
        return x

    def _encode_tower(self, x):
        cfg = self.cfg
        feats = {}
        for s in range(cfg.num_scales - 1, -1, -1):
            for g in range(cfg.groups_per_scale[s]):
                for c in range(cfg.num_cells_per_group):
                    x = self.enc_cells[f"{s}_{g}_{c}"](x)
                if not (s == 0 and g == 0):
                    feats[f"{s}_{g}"] = x
            if s > 0:
                x = self.enc_cells[f"{s}_down"](x)
        x = F.elu(self.encoder_0_conv(F.elu(x)))
        return feats, x

    def _apply_nf(self, s, g, z):
        for i in range(self.cfg.num_nf_cells or 0):
            z = self.nf_cells[f"{s}_{g}_{i}"](z)
        return z

    def _postprocess_to_logits(self, x):
        for b in range(self.cfg.n_pre_post_blocks):
            for c in range(self.cfg.n_pre_post_cells):
                x = self.post_cells[f"{b}_{c}"](x)
        return self.to_logits_conv(F.elu(x))

    def _decode_groups(self, b, z_0, group_fn):
        cfg = self.cfg
        x = self.const_prior.expand(b, -1, -1, -1)
        x = self.dec_combiners["0_0"](x, z_0)
        latent_idx = 1
        for s in range(cfg.num_scales):
            for g in range(cfg.groups_per_scale[s]):
                if not (s == 0 and g == 0):
                    for c in range(cfg.num_cells_per_group):
                        x = self.dec_cells[f"{s}_{g}_{c}"](x)
                    z_i = group_fn(s, g, x, latent_idx)
                    x = self.dec_combiners[f"{s}_{g}"](x, z_i)
                    latent_idx += 1
            if s < cfg.num_scales - 1:
                x = self.dec_cells[f"{s}_up"](x)
        return x

    def _prior_params(self, s, g, x):
        return self.dec_sampler[f"{s}_{g}"](F.elu(x)).chunk(2, dim=1)

    def _posterior(self, s, g, feats, x, temperature: float = 1.0):
        """(prior at `temperature`, posterior) Normals of group (s, g) given
        the decoder's x."""
        mu_p, log_sig_p = self._prior_params(s, g, x)
        comb = self.enc_combiners[f"{s}_{g}"](feats[f"{s}_{g}"], x)
        mu_q, log_sig_q = self.enc_sampler[f"{s}_{g}"](comb).chunk(2, dim=1)
        return (Normal(mu_p, log_sig_p, temp=temperature),
                Normal(mu_p + mu_q, log_sig_p + log_sig_q))

    def forward(self, x, draws):
        """The training forward: x (B, H, W, 3) NHWC in [0, 1] -> (mixture
        logits (B, M * 10, H, W), KL (B, n_latents)). Each group's z is drawn
        from its posterior; with flow cells the KL is log q(z) - log p(f(z))
        at the drawn z, without them the closed-form KL."""
        draws = as_draws(draws)
        flows = self.cfg.num_nf_cells is not None
        feats, top = self.purify_encode(x)
        b = top.shape[0]
        mu_q, log_sig_q = self.enc_sampler["0_0"](top).chunk(2, dim=1)
        dist_enc = Normal(mu_q, log_sig_q)
        dist_dec = Normal(torch.zeros_like(mu_q), torch.zeros_like(log_sig_q))
        kls = []

        def draw(s, g, dist_enc, dist_dec):
            z = dist_enc.sample(draws)[0]
            if flows:
                log_enc = dist_enc.log_p(z)
                z = self._apply_nf(s, g, z)
                kl = log_enc - dist_dec.log_p(z)
            else:
                kl = dist_enc.kl(dist_dec)
            kls.append(kl.sum((1, 2, 3)))
            return z

        def group_fn(s, g, x, latent_idx):
            return draw(s, g, *reversed(self._posterior(s, g, feats, x)))

        z_0 = draw(0, 0, dist_enc, dist_dec)
        x = self._decode_groups(b, z_0, group_fn)
        return self._postprocess_to_logits(x), torch.stack(kls, dim=1)

    @staticmethod
    def reconstruction_loss(x, logits):
        """-log p(x | logits) per sample: x (B, H, W, 3) NHWC in [0, 1],
        logits NCHW -> (B,)."""
        normalized = ((x - 0.5) / 0.5).permute(0, 3, 1, 2)
        return -DiscMixLogistic(logits).log_prob(normalized).sum((1, 2))

    def sample(self, num_samples: int, draws, temperature: float = 1.0,
               dtype=torch.float32):
        """Images (num_samples, H, W, 3) in [0, 1] from the prior at
        `temperature`, the decode sampled from the mixture."""
        draws = as_draws(draws)
        cfg = self.cfg
        r = cfg.resolution // cfg.scaling_factor
        zeros = torch.zeros((num_samples, cfg.num_latent_per_group, r, r), dtype=dtype,
                            device=self.const_prior.device)
        z_0 = Normal(zeros, zeros, temp=temperature).sample(draws)[0]

        def group_fn(s, g, x, latent_idx):
            return Normal(*self._prior_params(s, g, x), temp=temperature).sample(draws)[0]

        x = self._decode_groups(num_samples, z_0, group_fn)
        out = DiscMixLogistic(self._postprocess_to_logits(x)).sample(draws)
        return (out * 0.5 + 0.5).permute(0, 2, 3, 1)

    def reconstruct(self, x, draws=None, deterministic: bool = False):
        """Posterior reconstruction of x (B, H, W, 3) NHWC in [0, 1], NHWC in
        [0, 1]: with `deterministic` every z is its posterior mean and the
        decode the mixture's mean (no draws), else each is drawn."""
        draws = None if deterministic else as_draws(draws)
        feats, top = self.purify_encode(x)
        b = top.shape[0]
        mu_q, log_sig_q = self.enc_sampler["0_0"](top).chunk(2, dim=1)
        dist_enc = Normal(mu_q, log_sig_q)
        z_0 = dist_enc.mu if deterministic else dist_enc.sample(draws)[0]
        z_0 = self._apply_nf(0, 0, z_0)

        def group_fn(s, g, x, latent_idx):
            dist_enc = self._posterior(s, g, feats, x)[1]
            z_i = dist_enc.mu if deterministic else dist_enc.sample(draws)[0]
            return self._apply_nf(s, g, z_i)

        x = self._decode_groups(b, z_0, group_fn)
        dm = DiscMixLogistic(self._postprocess_to_logits(x))
        out = dm.mean() if deterministic else dm.sample(draws)
        return (out * 0.5 + 0.5).permute(0, 2, 3, 1)

    def purify_encode(self, x):
        """The encoder (the deterministic half of `purify`): x (B, H, W, 3)
        NHWC in [0, 1] -> (feats dict, top feature), NCHW channels_last."""
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return self._encode_tower(self._preprocess(x))

    def purify_decode(self, state, alphas, draws, temperature: float = 0.6):
        """Stochastic half of `purify`: at every latent group,
        (1 - alpha) * posterior mean + alpha * prior sample (temperature),
        each mixed latent through its flow blocks (if any), decoded to the
        mixture mean. `draws`: a `torch.Generator`, or the
        eps tensors (NCHW, the shape of each group's mean) in draw order,
        z_0 first, then each group in decode order. Returns NHWC images in
        [0, 1]."""
        draws = as_draws(draws)
        feats, top = state
        b = top.shape[0]
        mu_q, log_sig_q = self.enc_sampler["0_0"](top).chunk(2, dim=1)
        dist_enc = Normal(mu_q, log_sig_q)
        dist_dec = Normal(torch.zeros_like(mu_q), torch.zeros_like(log_sig_q),
                          temp=temperature)
        z_0 = (1 - alphas[0]) * dist_enc.mu + alphas[0] * dist_dec.sample(draws)[0]
        z_0 = self._apply_nf(0, 0, z_0)

        def group_fn(s, g, x, latent_idx):
            dist_dec, dist_enc = self._posterior(s, g, feats, x, temperature)
            a = alphas[latent_idx]
            return self._apply_nf(s, g, (1 - a) * dist_enc.mu + a * dist_dec.sample(draws)[0])

        x = self._decode_groups(b, z_0, group_fn)
        out = DiscMixLogistic(self._postprocess_to_logits(x)).mean()
        return (out * 0.5 + 0.5).permute(0, 2, 3, 1)

    def purify(self, x, alphas, draws, temperature: float = 0.6):
        """The defense op: `purify_decode(purify_encode(x))`, NHWC in and out."""
        return self.purify_decode(self.purify_encode(x), alphas, draws, temperature)


def eps_shapes(cfg: NVAEConfig, batch: int) -> list[tuple[int, ...]]:
    """NCHW shapes of the purify eps draws, in draw order."""
    r = cfg.resolution // cfg.scaling_factor
    shapes = [(batch, cfg.num_latent_per_group, r, r)]
    for s in range(cfg.num_scales):
        shapes += [(batch, cfg.num_latent_per_group, r * 2 ** s, r * 2 ** s)] * (
            cfg.groups_per_scale[s] - (s == 0))
    return shapes


"""A-VAE WGAN-GP trainer (counterpart of gen_adversarial_tpu/train/avae.py;
the reference's a_vae/train.py): a critic step with the WGAN loss, a 0.001
drift term and a 10x gradient penalty, a generator step of KL + adversarial
loss (the generator at temperature 1), and an EMA shadow generator
(`accumulate`, 0.999).

The gradient penalty differentiates a gradient: `torch.autograd.grad(...,
create_graph=True)` of the critic's score with respect to its input, then a
backward through that gradient (through `blur3`, `FusedDownsample` and
`instance_norm`) into the critic's parameters.

Both optimizers are Adam(b1 0, b2 0.99) (`optax.adam(lr, b1=0.0, b2=0.99)`);
the generator's style MLP (`style_layers`) learns at lr x 0.01, as its own
parameter group. Images are NCHW in [-1, 1]. Draws come from a `Draws`
source: a d_step draws the generator's (its noise maps, then its eps), then
the penalty's mixing weights U(0, 1) of shape (B, 1, 1, 1); a g_step the
generator's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from gen_adversarial_tpu_torch.core.init import flax_init_
from gen_adversarial_tpu_torch.models.avae.model import AVAEDiscriminator, StyledGenerator
from gen_adversarial_tpu_torch.models.nvae.distributions import as_draws
from gen_adversarial_tpu_torch.ops.image import avg_pool2d

EMA_DECAY = 0.999
STYLE_LR_MUL = 0.01


@dataclass
class AVAETrainers:
    """The generator, its critic, their optimizers and the three steps.

    d_step(real, draws) -> (WGAN loss, gradient penalty); g_step(real,
    draws) -> (adversarial loss, KL); accumulate(ema, decay) moves the EMA
    generator `ema`'s parameters towards the generator's. Each updates its
    modules in place and returns device tensors."""
    gen: StyledGenerator
    disc: AVAEDiscriminator
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    kernel_size: int

    def init(self, generator: torch.Generator) -> None:
        """Fresh weights as flax initializes them (the generator's, then the
        critic's) from `generator`."""
        flax_init_(self.gen, generator)
        flax_init_(self.disc, generator)

    def _params_grads(self, loss, module: nn.Module):
        params = list(module.parameters())
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = g

    def d_step(self, real, draws):
        """The critic's update on real images (B, 3, H, W) in [-1, 1]."""
        draws = as_draws(draws)
        with torch.no_grad():
            _, _, fake = self.gen(avg_pool2d(real, self.kernel_size), draws)
        real_pred = self.disc(real)[:, 0]
        fake_pred = self.disc(fake)[:, 0]
        real_loss = -(real_pred.mean() - 0.001 * (real_pred ** 2).mean())
        fake_loss = fake_pred.mean()
        eps = draws.uniform((real.shape[0], 1, 1, 1), real)
        x_hat = (eps * real + (1 - eps) * fake).requires_grad_(True)
        g, = torch.autograd.grad(self.disc(x_hat).sum(), x_hat, create_graph=True)
        gnorm = torch.sqrt(torch.sum(g.reshape(g.shape[0], -1) ** 2, dim=1))
        gp = 10.0 * torch.mean((gnorm - 1.0) ** 2)
        self._params_grads(real_loss + fake_loss + gp, self.disc)
        self.d_opt.step()
        return (real_loss + fake_loss).detach(), gp.detach()

    def g_step(self, real, draws):
        """The generator's update: KL of its posterior + the critic's
        adversarial loss on its reconstruction of the pooled `real`."""
        m, v, fake = self.gen(avg_pool2d(real, self.kernel_size), as_draws(draws))
        rec_loss = -self.disc(fake)[:, 0].mean()
        kl_loss = -0.5 * torch.mean(-torch.exp(v) - m ** 2 + v + 1)
        self._params_grads(kl_loss + rec_loss, self.gen)
        self.g_opt.step()
        return rec_loss.detach(), kl_loss.detach()

    @torch.no_grad()
    def accumulate(self, ema: nn.Module, decay: float = EMA_DECAY) -> None:
        for e, p in zip(ema.parameters(), self.gen.parameters()):
            e.copy_(e * decay + p * (1 - decay))


def make_avae_trainers(img_size: int, kernel_size: int, lr: float = 1e-3,
                       device="cuda") -> AVAETrainers:
    """The A-VAE at `img_size`, its critic and their Adam optimizers on
    `device` (weights uninitialized: call `init`)."""
    gen = StyledGenerator(img_size, device=device)
    disc = AVAEDiscriminator(img_size, device=device)
    style = [p for n, p in gen.named_parameters() if n.startswith("style_layers")]
    rest = [p for n, p in gen.named_parameters() if not n.startswith("style_layers")]
    g_opt = torch.optim.Adam([{"params": style, "lr": lr * STYLE_LR_MUL},
                              {"params": rest, "lr": lr}], betas=(0.0, 0.99))
    d_opt = torch.optim.Adam(disc.parameters(), lr=lr, betas=(0.0, 0.99))
    return AVAETrainers(gen, disc, g_opt, d_opt, kernel_size)

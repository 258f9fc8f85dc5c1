"""pSp container on NCHW tensors (counterpart of
gen_adversarial_tpu/models/e4e/psp.py): the E4E encoder, the StyleGAN2
generator and the face pool, with the `latent_avg` buffer the codes start
from. Only what the defense's purify runs: `encode`, `decode` (fixed noise
buffers, pooled to 256 x 256) and `style` (the generator's style MLP)."""

from __future__ import annotations

import torch
from torch import nn

from gen_adversarial_tpu_torch.models.e4e.encoder import Encoder4Editing
from gen_adversarial_tpu_torch.models.stylegan2.generator import Generator
from gen_adversarial_tpu_torch.ops.image import adaptive_avg_pool_general


class PSP(nn.Module):
    def __init__(self, stylegan_size: int = 1024, device=None):
        super().__init__()
        self.encoder = Encoder4Editing(stylegan_size, device=device)
        self.decoder = Generator(stylegan_size, device=device)
        self.register_buffer("latent_avg",
                             torch.empty(self.decoder.n_latent, 512, device=device))
        self.eval()

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> codes (B, n_latent, 512), shifted by latent_avg
        (the defenses' start_from_latent_avg)."""
        return self.encoder(x) + self.latent_avg[None]

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (B, n_latent, 512) -> images (B, 3, 256, 256)."""
        images, _ = self.decoder([codes], input_is_latent=True, randomize_noise=False)
        return adaptive_avg_pool_general(images, 256, 256)

    def style(self, z: torch.Tensor) -> torch.Tensor:
        """The generator's style MLP (new w's for the purify mix)."""
        return self.decoder.run_style(z)

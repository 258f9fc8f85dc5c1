"""Style-Transformer container on NCHW tensors (counterpart of
gen_adversarial_tpu/models/style_transformer/model.py): the query-token
encoder, a StyleGAN2 generator (512 px for the cars checkpoint, 16 styles)
and the `latent_avg` buffer the codes start from. Only what the defense's
purify runs: `encode`, `decode` (fixed noise buffers, pooled to 256 x 256)
and `style` (the generator's style MLP).

The JAX decode's phase-domain RGB route (`phase_rgb`, on by default at
512 px and up) is a TPU layout of the same math; the port runs the plain
generator.
"""

from __future__ import annotations

import torch
from torch import nn

from gen_adversarial_tpu_torch.models.style_transformer.encoder import GradualStyleEncoder
from gen_adversarial_tpu_torch.models.stylegan2.generator import Generator
from gen_adversarial_tpu_torch.ops.image import adaptive_avg_pool_general


class StyleTransformer(nn.Module):
    def __init__(self, output_size: int = 512, device=None):
        super().__init__()
        self.decoder = Generator(output_size, device=device)
        self.encoder = GradualStyleEncoder(self.decoder.n_latent, device=device)
        self.register_buffer("latent_avg",
                             torch.empty(self.decoder.n_latent, 512, device=device))
        self.eval()

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> codes (B, n_styles, 512): the learned z through
        the style MLP, cross-attended against the encoder's features,
        shifted by latent_avg."""
        b = x.shape[0]
        _, n, c = self.encoder.z.shape
        query = self.decoder.run_style(
            self.encoder.z.expand(b, n, c).reshape(b * n, c)).reshape(b, n, c)
        return self.encoder(x, query) + self.latent_avg[None]

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (B, n_styles, 512) -> images (B, 3, 256, 256)."""
        images, _ = self.decoder([codes], input_is_latent=True, randomize_noise=False)
        return adaptive_avg_pool_general(images, 256, 256)

    def style(self, z: torch.Tensor) -> torch.Tensor:
        """The generator's style MLP (new w's for the purify mix)."""
        return self.decoder.run_style(z)

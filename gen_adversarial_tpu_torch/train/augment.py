"""Training augmentations on the device (counterpart of
gen_adversarial_tpu/train/augment.py, the reference's kornia pipeline):
RandomHorizontalFlip(0.5) -> RandomResizedCrop(scale=(0.75, 1.0), ratio
(3/4, 4/3)) -> brightness 0.5 (p 0.3) -> contrast 0.5 (p 0.3) -> 256-bin
equalize (p 0.3) -> grayscale (p 0.1) -> Normalize(0.5, 0.5), each sample
on its own draws.

The draws are split from their application: `draw_augment` takes each
sample's flip, crop (area, log aspect ratio, y0 and x0 fractions) and the
four flags from a generator, and `apply_augment` is a pure function of the
images and those values, so the tests feed it what the JAX package draws
from its keys. Images are NHWC in [0, 1].
"""

from __future__ import annotations

import math

import torch

SCALE = (0.75, 1.0)
LOG_RATIO = (math.log(3 / 4), math.log(4 / 3))
P_BRIGHTNESS = P_CONTRAST = P_EQUALIZE = 0.3
P_GRAYSCALE = 0.1


def draw_augment(generator: torch.Generator, batch: int) -> dict:
    """Each sample's augmentation values, (batch,) tensors on the
    generator's device: `flip`, `brightness`, `contrast`, `equalize`,
    `grayscale` (bool) and `area`, `log_ratio`, `y0`, `x0` (float32)."""
    u = torch.rand((9, batch), generator=generator, device=generator.device)
    return {"flip": u[0] < 0.5,
            "area": SCALE[0] + (SCALE[1] - SCALE[0]) * u[1],
            "log_ratio": LOG_RATIO[0] + (LOG_RATIO[1] - LOG_RATIO[0]) * u[2],
            "y0": u[3], "x0": u[4],
            "brightness": u[5] < P_BRIGHTNESS, "contrast": u[6] < P_CONTRAST,
            "equalize": u[7] < P_EQUALIZE, "grayscale": u[8] < P_GRAYSCALE}


def _source_index(start, extent, size: int):
    """Bilinear source rows of a crop of `extent` from `start` on a grid of
    `size` outputs: (B, size) coordinates clamped to the image, as torch's
    area_pixel_compute_source_index (the border replicates the edge)."""
    grid = torch.arange(size, dtype=start.dtype, device=start.device)
    pos = start[:, None] + (grid + 0.5) * extent[:, None] / size - 0.5
    pos = torch.clamp(pos, 0.0, size - 1.0)
    lo = torch.clamp(torch.floor(pos).long(), 0, size - 1)
    return lo, torch.clamp(lo + 1, 0, size - 1), pos - lo


def _resized_crop(img, area_frac, log_ratio, y0_frac, x0_frac):
    """RandomResizedCrop to the input's size (square), bilinear."""
    b, h, w, _ = img.shape
    area = area_frac * h * w
    r = torch.exp(log_ratio)
    cw = torch.clamp(torch.sqrt(area * r), 1.0, w)
    ch = torch.clamp(torch.sqrt(area / r), 1.0, h)
    ylo, yhi, yf = _source_index(y0_frac * (h - ch), ch, h)
    xlo, xhi, xf = _source_index(x0_frac * (w - cw), cw, w)
    bi = torch.arange(b, device=img.device)[:, None, None]
    yf, xf = yf[:, :, None, None], xf[:, None, :, None]

    def at(rows, cols):
        return img[bi, rows[:, :, None], cols[:, None, :]]

    top = at(ylo, xlo) * (1 - xf) + at(ylo, xhi) * xf
    bot = at(yhi, xlo) * (1 - xf) + at(yhi, xhi) * xf
    return top * (1 - yf) + bot * yf


def _equalize(img):
    """Histogram equalization of each channel of each image (256 bins; the
    lowest level maps to 0, cdf_min taken at the first non-empty bin)."""
    b, h, w, c = img.shape
    levels = torch.clamp((img * 255.0).to(torch.int32), 0, 255).long()
    flat = levels.permute(0, 3, 1, 2).reshape(b * c, h * w)
    hist = torch.zeros((b * c, 256), dtype=img.dtype, device=img.device)
    hist.scatter_add_(1, flat, torch.ones_like(flat, dtype=img.dtype))
    cdf = torch.cumsum(hist, dim=1)
    cdf_min = torch.gather(cdf, 1, torch.argmax((hist > 0).to(torch.uint8), dim=1,
                                                keepdim=True))
    denom = torch.clamp(cdf[:, -1:] - cdf_min, min=1.0)
    lut = torch.clamp((cdf - cdf_min) / denom, 0.0, 1.0)
    return torch.gather(lut, 1, flat).reshape(b, c, h, w).permute(0, 2, 3, 1)


def apply_augment(images: torch.Tensor, params: dict) -> torch.Tensor:
    """The augmentations of `params` (`draw_augment`'s keys) applied to
    images (B, H, W, C) in [0, 1]; returns images in [0, 1], not
    normalized."""
    def pick(flag, new, old):
        return torch.where(flag[:, None, None, None], new, old)

    img = pick(params["flip"], images.flip(2), images)
    img = _resized_crop(img, params["area"], params["log_ratio"], params["y0"], params["x0"])
    # brightness: kornia factor 0.5 -> clip(img + f - 1); contrast: clip(img * f)
    img = pick(params["brightness"], torch.clamp(img - 0.5, 0.0, 1.0), img)
    img = pick(params["contrast"], torch.clamp(img * 0.5, 0.0, 1.0), img)
    img = pick(params["equalize"], _equalize(img), img)
    gray = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    return pick(params["grayscale"], torch.stack([gray] * 3, -1), img)


def train_augment(images: torch.Tensor, generator: torch.Generator,
                  batch_slice: tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Per-sample augmentations + Normalize(0.5, 0.5); images (B, H, W, C)
    in [0, 1]. batch_slice = (i, n): the images are the i-th of n equal
    parts of a global batch (a data-parallel rank's); the draws are the
    global batch's, and the part's are kept, so that every rank augments
    as one process would."""
    i, n = batch_slice
    b = images.shape[0]
    params = {k: v[i * b:(i + 1) * b] for k, v in draw_augment(generator, b * n).items()}
    return (apply_augment(images, params) - 0.5) / 0.5


def eval_normalize(images: torch.Tensor) -> torch.Tensor:
    return (images - 0.5) / 0.5

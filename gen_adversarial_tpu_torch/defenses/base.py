"""The defenses (counterpart of gen_adversarial_tpu/defenses/base.py): the
bare classifier, and the purify-based defense: optional gaussian blur ->
L2-ball gaussian noise (or the unconditional clamp at eps 0) -> optional
(x - 0.5) / 0.5 -> purify -> optional * 0.5 + 0.5 -> classifier. Images are
NHWC in [0, 1], as in the JAX package. The NVAE family purifies [0, 1]
images (it normalizes inside: normalize_before_purify=False); the StyleGAN2
families purify in [-1, 1] (normalize_before_purify=True).

Random draws come from a `Draws` source (models/nvae/distributions.py): a
`torch.Generator`, or recorded tensors replayed in order. One call draws the
input noise first (NHWC, the image's shape; only when initial_noise_eps > 0),
then the purifier's draws (the NVAE's eps, or the StyleGAN2 mix noise).

remat recomputes the purifier in the backward (torch.utils.checkpoint,
non-reentrant; the JAX `remat_policy=None`, which saves nothing). It works
under torch.autograd, not under torch.func, whose transforms refuse the
checkpoint's saved-tensor hooks: the attacks (attacks/utils.class_grads)
take their gradients through torch.autograd. A `remat_policy` (the JAX
`jax.checkpoint_policies` names of REMAT_POLICIES) saves the outputs of the
matrix products it names and recomputes the rest (selective activation
checkpointing). torch allows one backward per forward of such a region,
so a forward that is differentiated in blocks (class_grads with a
cotangent_chunk, which runs it under `several_backwards()`) recomputes its
region whole instead, as policy None does, and says so once in a warning;
the gradients are the same, and the policy's memory meaning holds for every
other forward. The kernels'
ctypes launches inside their autograd Functions are no aten operations, so
no policy saves them: they are recomputed, from the replayed draws.

compute_dtype (set by core/precision.defense_astype, which also casts the
weights once) runs the purifier and the classifier in that dtype (bfloat16):
the blur, the input noise and the clamp run in float32, the image is cast
after them and before the normalize, and the logits and the purified image
come back as float32, so the attacks' math stays float32. Under remat the
checkpointed region takes the cast tensor, and the draws it records are in
the compute dtype.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import warnings
from collections.abc import Callable
from functools import partial
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import (
    checkpoint, create_selective_checkpoint_contexts, noop_context_fn)

from gen_adversarial_tpu_torch.models.nvae.distributions import Draws, RecordingDraws, as_draws
from gen_adversarial_tpu_torch.ops.blur import gaussian_blur2d
from gen_adversarial_tpu_torch.ops.image import clamp01


# remat_policy -> the aten operations whose outputs the checkpointed region
# saves: jax.checkpoint_policies.dots_saveable saves every dot_general and
# conv_general_dilated; dots_with_no_batch_dims_saveable only the dot_generals
# without batch dimensions (the 2-D products)
REMAT_POLICIES = {
    "dots_saveable": ("convolution", "mm", "addmm", "bmm"),
    "dots_with_no_batch_dims_saveable": ("mm", "addmm"),
}


# set while a forward runs that more than one backward will differentiate
_SEVERAL_BACKWARDS = contextvars.ContextVar("several_backwards", default=False)


@contextlib.contextmanager
def several_backwards():
    """Forwards run inside this context are differentiated by more than one
    backward (attacks/utils.class_grads in blocks): a checkpointed region
    made there runs without its remat_policy (see _remat_call)."""
    token = _SEVERAL_BACKWARDS.set(True)
    try:
        yield
    finally:
        _SEVERAL_BACKWARDS.reset(token)


def blur_kernel_size(h: int) -> int:
    """The reference's kernel size for an H-px image, 2**(sqrt(H) // 2) - 1
    (31 at 128 px): most likely meant as log2(H) upstream, but the sizes it
    gives are the ones the results were measured with, so it is kept."""
    return int(2 ** (math.sqrt(h) // 2) - 1)


def add_l2_gaussian_noise(x: torch.Tensor, eps: float, draws: Draws) -> torch.Tensor:
    """Noise with per-sample L2 norm exactly eps, then the [0, 1] clamp."""
    noise = draws.normal(x.shape, x)
    dims = tuple(range(1, x.dim()))
    norm = torch.sqrt(torch.sum(noise ** 2, dim=dims, keepdim=True))
    return clamp01(x + noise * (eps / norm))


def _remat_call(fn: Callable, draws: Draws | None, *args, policy: str | None = None):
    """fn(*args, draws) with nothing of it saved for the backward, which
    runs it again (torch.utils.checkpoint, non-reentrant), or, under a
    `policy` of REMAT_POLICIES, only the outputs of its operations saved.
    The draws of the first run are recorded and replayed, in order, by every
    recompute (one per backward pass), so each backward differentiates the
    forward that ran and not one with fresh noise. Nothing else in a
    purifier is random, so the global RNG states are not stashed.

    Inside `several_backwards()` the policy is dropped, with a warning:
    torch keeps a policy's saved outputs for one backward only, and plain
    recompute serves any number of them, each replaying the recorded draws."""
    record: list[torch.Tensor] = []
    runs = 0

    def region(*a):
        nonlocal runs
        runs += 1
        if draws is None:
            return fn(*a, None)
        return fn(*a, RecordingDraws(draws, record) if runs == 1 else Draws(record))

    if policy is not None and _SEVERAL_BACKWARDS.get():
        warnings.warn(f"remat_policy {policy!r} dropped for a forward that is differentiated "
                      "in blocks (a policy's saved outputs serve one backward): its purifier "
                      "is recomputed whole in each block's backward, as under policy None",
                      stacklevel=2)
        policy = None
    context_fn = noop_context_fn
    if policy is not None:
        ops = [getattr(torch.ops.aten, op).default for op in REMAT_POLICIES[policy]]
        context_fn = partial(create_selective_checkpoint_contexts, ops)
    return checkpoint(region, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=context_fn)


class ClassifierDefense(nn.Module):
    """The bare classifier (the 'base' and 'trades' defense types): draws
    nothing, purifies nothing. The JAX factory runs it with EoT 1. The
    ablations (defenses/ablations.py) are this with a `get_purified`.
    compute_dtype casts the classifier's input; the logits come back as
    float32."""

    supports_shared_encode = False

    def __init__(self, classifier: nn.Module, classifier_apply: Callable):
        super().__init__()
        self.classifier = classifier
        self.classifier_apply = classifier_apply
        self.compute_dtype = None

    def classify(self, x):
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        return self.classifier_apply(x).float()

    def forward(self, x, draws=None, preds_only: bool = True):
        purified = self.get_purified(x, draws)
        logits = self.classify(purified)
        return logits if preds_only else (logits, purified)

    def get_purified(self, x, draws=None):
        return x


class MLVGMDefense(nn.Module):
    """purify-based defense.

    purify_encode(x) -> state and purify_decode(alphas, state, draws) ->
    purified are the halves of the purifier (defenses/purify.py); the encode
    half draws nothing, so with initial_noise_eps == 0 an EoT wrapper runs it
    once for all draws (defenses/eot.py). apply_blur blurs the input with
    the kernel size of an image_size image before the noise. remat
    recomputes the purify (both halves, or each half on the shared-encode
    route) in the backward instead of saving its activations, and
    remat_policy (None: save nothing; or a name of REMAT_POLICIES) chooses
    what it saves all the same. compute_dtype: see the module docstring."""

    def __init__(self, purifier: nn.Module, classifier: nn.Module, alphas: torch.Tensor,
                 purify_encode: Callable, purify_decode: Callable,
                 classifier_apply: Callable, initial_noise_eps: float = 0.0,
                 normalize_before_purify: bool = False, apply_blur: bool = False,
                 image_size: int = 64, remat: bool = False, remat_policy: str | None = None):
        super().__init__()
        if remat_policy is not None and remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {remat_policy!r}: None or one of "
                             f"{sorted(REMAT_POLICIES)}")
        self.purifier = purifier
        self.classifier = classifier
        self.register_buffer("alphas", alphas)
        self.purify_encode = purify_encode
        self.purify_decode = purify_decode
        self.classifier_apply = classifier_apply
        self.initial_noise_eps = initial_noise_eps
        self.normalize_before_purify = normalize_before_purify
        self.apply_blur = apply_blur
        self.image_size = image_size
        self.remat = remat
        self.remat_policy = remat_policy
        self.compute_dtype = None

    def _call(self, fn, draws, *args):
        if self.remat:
            return _remat_call(fn, draws, *args, policy=self.remat_policy)
        return fn(*args, draws)

    def _purify(self, x, draws):
        return self.purify_decode(self.alphas, self.purify_encode(x), draws)

    def _decode(self, state, draws):
        return self.purify_decode(self.alphas, state, draws)

    def _normalize(self, x):
        """The purifier's input: cast to compute_dtype (after the float32
        preprocessing), then (x - 0.5) / 0.5 where the purifier wants it."""
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        return (x - 0.5) / 0.5 if self.normalize_before_purify else x

    def _denormalize(self, out):
        return out * 0.5 + 0.5 if self.normalize_before_purify else out

    def preprocess(self, x, draws: Draws | None):
        if self.apply_blur:
            x = gaussian_blur2d(x, blur_kernel_size(self.image_size), 1.0)
        if self.initial_noise_eps > 0:
            return add_l2_gaussian_noise(x, self.initial_noise_eps, draws)
        # the reference adds its noise unconditionally: at eps 0 that is
        # still a clamp to [0, 1], which changes out-of-box inputs
        return clamp01(x)

    def purified(self, x, draws):
        draws = as_draws(draws)
        x = self._normalize(self.preprocess(x, draws))
        return self._denormalize(self._call(self._purify, draws, x))

    @property
    def supports_shared_encode(self) -> bool:
        """True when every EoT draw sees the same encode: deterministic
        preprocessing (initial_noise_eps == 0)."""
        return self.initial_noise_eps == 0

    def purify_state(self, x):
        """Preprocessing and the encode half, once. Only valid when
        supports_shared_encode."""
        if not self.supports_shared_encode:
            raise ValueError("shared encode needs initial_noise_eps == 0")
        x = self._normalize(self.preprocess(x, None))
        return self._call(lambda v, _: self.purify_encode(v), None, x)

    def purified_from_state(self, state, draws):
        return self._denormalize(self._call(self._decode, as_draws(draws), state))

    def _classify(self, purified, preds_only):
        logits = self.classifier_apply(purified).float()
        return logits if preds_only else (logits, purified.float())

    def state_call(self, state, draws, preds_only: bool = True):
        return self._classify(self.purified_from_state(state, draws), preds_only)

    def forward(self, x, draws, preds_only: bool = True):
        """x: (B, H, W, C) in [0, 1] -> logits (B, n_classes), or
        (logits, purified) with preds_only=False."""
        return self._classify(self.purified(x, draws), preds_only)

    def get_purified(self, x, draws):
        return self.purified(x, draws).float()


class ClassifierApply:
    """Optional (x - mean) / std, then the classifier, on NHWC images. An
    object holding the model rather than a closure over it, so a deep copy
    of a defense classifies with its own copy (see defenses/purify.py)."""

    def __init__(self, model: nn.Module, mean: float | None = 0.5, std: float = 0.5):
        self.model, self.mean, self.std = model, mean, std

    def __call__(self, x) -> torch.Tensor:
        if self.mean is not None:
            x = (x - self.mean) / self.std
        return self.model(x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))


def make_classifier_apply(model: nn.Module, mean: float | None = 0.5,
                          std: float = 0.5) -> Callable[[Any], torch.Tensor]:
    """Optional (x - mean) / std, then the classifier. Takes NHWC images."""
    return ClassifierApply(model, mean, std)

"""Classifier trainer on one GPU (counterpart of
gen_adversarial_tpu/train/classifier.py, the reference's DDP trainer):
augment, train-mode forward, softmax cross-entropy, SGD with momentum 0.9
(`torch.optim.SGD(lr, momentum=0.9)` is `optax.sgd(lr, momentum=0.9)`), and
`fit`'s epoch structure: shuffle with seed + epoch, validate every
`eval_freq` epochs and at the last, periodic train-state checkpoints
(`core/checkpoint.save_train_state`) and resume.

Each step's augmentation draws come from a generator seeded by its position
(seed + 1, epoch, step), so a resumed run draws what the uninterrupted run
drew. One device only: `n_devices` > 1 and `distributed=True` raise
(multi-GPU is ROADMAP Queue 1, item 5); the JAX package's padding of the
ragged validation tail to the mesh size becomes a plain partial batch here.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import torch
import torch.nn.functional as F
from torch import nn

from gen_adversarial_tpu_torch.core.checkpoint import load_train_state, save_train_state
from gen_adversarial_tpu_torch.core.convert import from_jax_variables
from gen_adversarial_tpu_torch.core.init import flax_init_
from gen_adversarial_tpu_torch.core.runlog import RunLog, param_summary
from gen_adversarial_tpu_torch.data.datasets import iterate_batches
from gen_adversarial_tpu_torch.eval.factory import resolve_device
from gen_adversarial_tpu_torch.models.classifiers import make_classifier
from gen_adversarial_tpu_torch.models.nvae.distributions import position_generator
from gen_adversarial_tpu_torch.train.augment import eval_normalize, train_augment


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(model: nn.Module, lr: float, momentum: float = 0.9) -> TrainState:
    return TrainState(model, torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits, labels)


def _on(model: nn.Module, batch: dict):
    """(images NHWC in the model's dtype, labels int64) of a numpy or tensor
    batch, on the model's device."""
    param = next(model.parameters())
    images = torch.as_tensor(batch["image"], dtype=param.dtype, device=param.device)
    return images, torch.as_tensor(batch["label"], device=param.device).long()


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def train_step(state: TrainState, batch: dict, generator: torch.Generator,
               augment=train_augment) -> torch.Tensor:
    """One SGD step on `batch` ({'image': (B, H, W, 3) in [0, 1], 'label'}),
    augmented by `augment(images, generator)` (normalized); the model's
    BatchNorms train. Returns the loss (a device tensor)."""
    model = state.model.train()
    images, labels = _on(model, batch)
    loss = cross_entropy(model(_nchw(augment(images, generator))), labels)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return loss.detach()


@torch.no_grad()
def eval_step(state: TrainState, batch: dict) -> tuple[int, int]:
    """(correct, count) of the eval-mode model on a normalized batch."""
    model = state.model.eval()
    images, labels = _on(model, batch)
    logits = model(_nchw(eval_normalize(images)))
    return int((logits.argmax(-1) == labels).sum()), int(labels.shape[0])


def fit(model_type: str, n_classes: int, image_size: int, train_ds, val_ds,
        epochs: int, lr: float, batch_size: int, seed: int = 0,
        eval_freq: int | None = None, log_fn=print, n_devices: int | None = None,
        checkpoint_dir: str | None = None, resume_step: int | None = None,
        save_every: int | None = None, init_variables: dict | None = None,
        distributed: bool = False, device="cuda"):
    """Train a fresh classifier (weights from a generator seeded `seed`, or
    `init_variables`, a flax tree such as `core/torch_convert.
    convert_torchvision_backbone`'s) and return (state, history): validate
    every eval_freq epochs (1 if epochs <= 50, else 5) and at the last,
    checkpoint every save_every epochs (2 x eval_freq) and at the last,
    resume from `resume_step` (an epoch count) in `checkpoint_dir`."""
    if (n_devices or 1) > 1 or distributed:
        raise NotImplementedError("the port's classifier trainer runs on one device: "
                                  "multi-GPU training is ROADMAP Queue 1, item 5")
    device = resolve_device(device, "train.classifier.fit")
    model = make_classifier(model_type, n_classes, device=device)
    flax_init_(model, torch.Generator(device=device).manual_seed(seed))
    if init_variables is not None:
        # e.g. an ImageNet-pretrained backbone with a fresh projector
        from_jax_variables(init_variables, model)
    model = model.to(memory_format=torch.channels_last)
    state = create_train_state(model, lr)
    start_epoch = 0
    if checkpoint_dir and resume_step is not None:
        state = load_train_state(checkpoint_dir, resume_step, state)
        start_epoch = resume_step
        log_fn(f"[resume] from {checkpoint_dir} epoch {resume_step}")
    if eval_freq is None:
        eval_freq = 1 if epochs <= 50 else 5
    if save_every is None:
        save_every = eval_freq * 2
    if checkpoint_dir:
        log_fn = RunLog(Path(checkpoint_dir) / "log.txt", log_fn)
        log_fn(param_summary(model, model_type))

    history = []
    for epoch in range(start_epoch, epochs):
        losses = []
        for i, batch in enumerate(iterate_batches(train_ds, batch_size, shuffle=True,
                                                  seed=seed + epoch)):
            losses.append(train_step(state, batch,
                                     position_generator(device, seed + 1, epoch, i)))
        epoch_loss = float(torch.stack(losses).mean())
        log_fn(f"[epoch {epoch + 1}/{epochs}] loss {epoch_loss:.4f}")
        if epoch % eval_freq == 0 or epoch == epochs - 1:
            correct = total = 0
            for batch in iterate_batches(val_ds, batch_size, drop_last=False):
                c, n = eval_step(state, batch)
                correct += c
                total += n
            acc = correct / max(total, 1)
            log_fn(f"[epoch {epoch + 1}] val accuracy {acc * 100:.2f}")
            history.append({"epoch": epoch, "loss": epoch_loss, "acc": acc})
        if checkpoint_dir and (epoch % save_every == 0 or epoch == epochs - 1):
            save_train_state(checkpoint_dir, state, epoch + 1)
    state.model.eval()
    return state, history

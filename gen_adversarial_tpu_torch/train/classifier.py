"""Classifier trainer (counterpart of gen_adversarial_tpu/train/classifier.py,
the reference's DDP trainer): augment, train-mode forward, softmax
cross-entropy, SGD with momentum 0.9 (`torch.optim.SGD(lr, momentum=0.9)` is
`optax.sgd(lr, momentum=0.9)`), and `fit`'s epoch structure: shuffle with
seed + epoch, validate every `eval_freq` epochs and at the last, periodic
train-state checkpoints (`core/checkpoint.save_train_state`) and resume.

Each step's augmentation draws come from a generator seeded by its position
(seed + 1, epoch, step), so a resumed run draws what the uninterrupted run
drew.

Data parallel (`distributed=True` in a torchrun process group,
core/distributed.py): one process per GPU. Every rank walks the same
shuffled order and decodes its contiguous part of each global batch
(`iterate_batches(batch_slice=...)`), draws the global batch's augmentation
and keeps its part, normalises with the global batch's BatchNorm statistics
(models/batchnorm.py) and averages its gradients with the others' through
DistributedDataParallel, so the trajectory is one process's on the global
batch. The epoch loss and the validation counts are summed over the ranks,
so every rank's history is the same. Rank 0 alone logs and writes
checkpoints, of the unwrapped module. More than one device in one process
raises (core/distributed.check_n_devices).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from pathlib import Path

import torch
import torch.nn.functional as F
from torch import nn

from gen_adversarial_tpu_torch.core import distributed as dist_util
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
    """`model` is the plain module (what checkpoints hold); `ddp` its
    DistributedDataParallel wrapper in a data-parallel run, which the
    training forwards go through."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    ddp: nn.Module | None = None

    @property
    def net(self) -> nn.Module:
        return self.model if self.ddp is None else self.ddp


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
    net = state.net.train()
    images, labels = _on(state.model, batch)
    loss = cross_entropy(net(_nchw(augment(images, generator))), labels)
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
    resume from `resume_step` (an epoch count) in `checkpoint_dir`.
    distributed=True trains data parallel over the initialized process
    group (see the module); batch_size is the global batch."""
    dist_util.check_n_devices(n_devices, "gen_adversarial_tpu_torch.cli.train_classifier")
    device = resolve_device(device, "train.classifier.fit")
    pid, n_proc = dist_util.data_parallel_shard(distributed, "train.classifier.fit")
    if batch_size % n_proc:
        raise ValueError(f"batch_size {batch_size} is not divisible by {n_proc} processes")
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
    if distributed:
        state.ddp = dist_util.wrap_ddp(model)
    if eval_freq is None:
        eval_freq = 1 if epochs <= 50 else 5
    if save_every is None:
        save_every = eval_freq * 2
    if pid != 0:
        log_fn = lambda s: None  # noqa: E731 (rank 0 logs)
    elif checkpoint_dir:
        log_fn = RunLog(Path(checkpoint_dir) / "log.txt", log_fn)
        log_fn(param_summary(model, model_type))
    augment = partial(train_augment, batch_slice=(pid, n_proc))

    history = []
    for epoch in range(start_epoch, epochs):
        losses = []
        for i, batch in enumerate(iterate_batches(train_ds, batch_size, shuffle=True,
                                                  seed=seed + epoch,
                                                  batch_slice=(pid, n_proc))):
            losses.append(train_step(state, batch,
                                     position_generator(device, seed + 1, epoch, i), augment))
        epoch_loss = float(_sum_over_ranks(torch.stack(losses).mean(), n_proc) / n_proc)
        log_fn(f"[epoch {epoch + 1}/{epochs}] loss {epoch_loss:.4f}")
        if epoch % eval_freq == 0 or epoch == epochs - 1:
            counts = torch.zeros(2, dtype=torch.int64, device=device)
            for batch in iterate_batches(val_ds, batch_size, drop_last=False,
                                         batch_slice=(pid, n_proc)):
                if len(batch["label"]):  # a ragged tail's part can be empty
                    counts += torch.tensor(eval_step(state, batch), device=device)
            correct, total = _sum_over_ranks(counts, n_proc).tolist()
            acc = correct / max(total, 1)
            log_fn(f"[epoch {epoch + 1}] val accuracy {acc * 100:.2f}")
            history.append({"epoch": epoch, "loss": epoch_loss, "acc": acc})
        if checkpoint_dir and pid == 0 and (epoch % save_every == 0 or epoch == epochs - 1):
            save_train_state(checkpoint_dir, state, epoch + 1)
    state.model.eval()
    return state, history


def _sum_over_ranks(t: torch.Tensor, n_proc: int) -> torch.Tensor:
    if n_proc > 1:
        t = t.clone()
        torch.distributed.all_reduce(t)
    return t

"""Folder-of-class-folders image datasets (counterpart of
gen_adversarial_tpu/data/datasets.py): `rglob` over png/jpg/bmp/JPEG, the
label of a file is the sorted index of its parent folder's name, and images
come out HWC float32 in [0, 1], in numpy batches from a prefetch thread.

PNG files are decoded by `data/png.py`, without PIL. JPEG and BMP files, and
any image that is not already image_size x image_size (the bilinear resize),
need PIL; where it does not import they raise an error naming the file.
There is no native batch decoder (the JAX package's native/fastloader.cpp).
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path

import numpy as np

from gen_adversarial_tpu_torch.data import png

EXTENSIONS = (".png", ".jpg", ".bmp", ".JPEG")


def _find_images(root: Path):
    files = [p for p in sorted(root.rglob("*")) if p.suffix in EXTENSIONS]
    if not files:
        raise FileNotFoundError(f"no images under {root}")
    return files


def _pil_image(path: Path, why: str):
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"{path}: {why} needs PIL, which is not installed (PNG files "
                           "at the model's image size are read without it)") from None
    return Image


def read_image(path: str | Path, image_size: int) -> np.ndarray:
    """(image_size, image_size, 3) uint8 RGB, bilinearly resized where it is
    not that size (as PIL's convert('RGB') and resize(BILINEAR))."""
    path = Path(path)
    if path.suffix == ".png":
        rgb = png.read_rgb(path)
    else:
        Image = _pil_image(path, f"reading a {path.suffix} file")
        with Image.open(path) as img:
            rgb = np.asarray(img.convert("RGB"))
    if rgb.shape[:2] != (image_size, image_size):
        Image = _pil_image(path, f"resizing a {rgb.shape[1]}x{rgb.shape[0]} image to "
                                 f"{image_size}x{image_size}")
        rgb = np.asarray(Image.fromarray(rgb).resize((image_size, image_size),
                                                     Image.BILINEAR))
    return rgb


class ImageLabelDataset:
    """Images + integer labels derived from the parent folder name."""

    def __init__(self, folder: str, image_size: int):
        self.root = Path(folder)
        self.files = _find_images(self.root)
        self.image_size = image_size
        classes = sorted({f.parent.name for f in self.files})
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.labels = np.array([self.class_to_idx[f.parent.name] for f in self.files],
                               dtype=np.int32)

    def __len__(self):
        return len(self.files)

    def load_image(self, idx: int) -> np.ndarray:
        """HWC float32 in [0, 1]."""
        return np.asarray(read_image(self.files[idx], self.image_size), np.float32) / 255.0

    def __getitem__(self, idx: int):
        return self.load_image(idx), self.labels[idx]


class ImageNameLabelDataset(ImageLabelDataset):
    """Additionally returns the last two path components (class/filename),
    used when writing adversarial examples back into class folders."""

    def __getitem__(self, idx: int):
        img, label = super().__getitem__(idx)
        f = self.files[idx]
        return img, label, f"{f.parent.name}/{f.name}"


def iterate_batches(dataset: ImageLabelDataset, batch_size: int,
                    shuffle: bool = False, seed: int = 0,
                    drop_last: bool = True, prefetch: int = 2,
                    shard: tuple[int, int] = (0, 1),
                    batch_slice: tuple[int, int] = (0, 1)):
    """Yield dict batches {'image': (B, H, W, C) float32, 'label': (B,) int32}
    in file order, or with shuffle in the order
    `np.random.RandomState(seed).shuffle` gives (the JAX package's), decoded
    by a background thread, `prefetch` batches ahead.

    shard = (pid, pcount): every pcount-th image of that order from pid
    (round robin; the harness's ranks). batch_slice = (i, n): the i-th
    contiguous n-th of each batch of that order (the trainers' ranks: every
    rank walks the same order and decodes only its part of each global
    batch; a ragged tail may slice empty). A decode error is raised in the
    consumer."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    pid, pcount = shard
    order = order[pid::pcount]
    n_batches = len(order) // batch_size if drop_last else -(-len(order) // batch_size)
    sl, sn = batch_slice
    hw = (dataset.image_size, dataset.image_size)

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def _put(item) -> bool:
        """Bounded put that gives up when the consumer is gone (an early
        `break` out of the batch loop must not pin this thread on a full
        queue forever)."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for b in range(n_batches):
                idx = order[b * batch_size:(b + 1) * batch_size]
                idx = idx[sl * len(idx) // sn:(sl + 1) * len(idx) // sn]
                imgs = (np.stack([dataset.load_image(i) for i in idx]) if len(idx)
                        else np.zeros((0,) + hw + (3,), np.float32))
                if not _put({"image": imgs, "label": dataset.labels[idx]}):
                    return
            _put(None)
        except BaseException as e:  # surface decode errors in the consumer
            _put(e)                 # (a dead producer would deadlock q.get)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()

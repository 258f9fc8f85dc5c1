"""Checkpoint IO (counterpart of `save_variables` and `load_variables` in
gen_adversarial_tpu/core/checkpoint.py): a variable tree as a flax msgpack
file, with an optional JSON meta beside it (`<name>.json`). Both packages
read what the other wrote.

The msgpack reader and writer are written here in Python: the GPU machine
has neither msgpack nor flax. They cover what flax's `msgpack_serialize`
writes for a variable tree: maps, arrays, str, bin, int, float, bool, nil,
flax's ndarray extension (ext type 1, and 3 for a numpy scalar, which is
read but never written; the payload is the msgpack array `(shape, dtype
name, C-order bytes)`) and its
chunked-array marker: an array of more than `MAX_CHUNK_SIZE` bytes is
written as `{'__msgpack_chunked_array__': True, 'shape': {'0': d0, ...},
'chunks': {'0': flat chunk, ...}}`.

Reading maps the file (copy on write) and takes every array's bytes from
the mapping with `np.frombuffer`, so nothing is copied until a chunked array
is joined or a caller converts. A `bfloat16` leaf (numpy has no such dtype)
comes back as a `torch.bfloat16` tensor over the same bytes.

A trainer's periodic state (`save_state`, `load_state`, `latest_step`) is
a directory `step_NNNNNNNN/` holding `train_state.msgpack`: the trainer's
name under `trainer` (`load_state` refuses another trainer's) and its tree
of arrays and numbers. The classifier trainer's (`save_train_state`,
`load_train_state`) holds the model's flax variable tree (`params`,
`batch_stats`, as `save_variables` writes them), the SGD state under
`optimizer` and the `step`; the A-VAE trainer's its models, optimizers and
position. `optimizer_tree` keys an optimizer's state by the port's
parameter names, in the port's layout. The JAX package writes the same
directory names with orbax (which the GPU machine does not have), so
`latest_step` finds either package's, but the two packages' train states do
not read each other's. Their `save_variables` files do.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from pathlib import Path

import numpy as np
import torch

from gen_adversarial_tpu_torch.core.convert import from_jax_variables, to_jax_variables

# flax.serialization.MAX_CHUNK_SIZE: larger arrays are written in chunks
MAX_CHUNK_SIZE = 2 ** 30
EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, buf, path):
        self.buf, self.path, self.pos = buf, path, 0
        self.view = memoryview(buf)

    def _take(self, n: int) -> int:
        start = self.pos
        self.pos += n
        if self.pos > len(self.buf):
            raise ValueError(f"{self.path}: msgpack data ends inside a value at byte {start}")
        return start

    def _unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack_from(fmt, self.buf, self._take(size))[0]

    def _str(self, n: int) -> str:
        start = self._take(n)
        return bytes(self.view[start:start + n]).decode("utf-8")

    def _bin(self, n: int) -> bytes:
        start = self._take(n)
        return bytes(self.view[start:start + n])

    def _ext(self, n: int):
        """flax's array: ext type 1 (3 for a scalar) around the msgpack array
        (shape, dtype name, bin of the C-order bytes)."""
        code = self._unpack(">b")
        end = self.pos + n
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"{self.path}: msgpack ext type {code} before byte {end} is "
                             "not a flax array")
        if self.buf[self._take(1)] != 0x93:
            raise ValueError(f"{self.path}: malformed flax array before byte {end}")
        shape, dtype = self.value(), self.value()
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        fmt = lengths.get(self.buf[self._take(1)])
        if fmt is None or not isinstance(dtype, str):
            raise ValueError(f"{self.path}: malformed flax array before byte {end}")
        nbytes = self._unpack(fmt)
        offset = self._take(nbytes)
        if self.pos != end:
            raise ValueError(f"{self.path}: malformed flax array before byte {end}")
        arr = self._array(tuple(int(d) for d in shape), dtype, offset, nbytes)
        return arr[()] if code == EXT_NPSCALAR else arr

    def _array(self, shape: tuple, dtype: str, offset: int, nbytes: int):
        if dtype == "bfloat16":
            flat = np.frombuffer(self.buf, np.uint16, nbytes // 2, offset)
            return torch.from_numpy(flat.reshape(shape)).view(torch.bfloat16)
        dt = np.dtype(dtype)
        if dt.hasobject:
            raise ValueError(f"{self.path}: object arrays are not read")
        return np.frombuffer(self.buf, dt, nbytes // dt.itemsize, offset).reshape(shape)

    def _seq(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def value(self):
        b = self.buf[self._take(1)]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._seq(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if b in _CONSTANTS:
            return _CONSTANTS[b]
        if b in _NUMBERS:
            return self._unpack(_NUMBERS[b])
        if b in _FIXEXT:
            return self._ext(_FIXEXT[b])
        if b in _SIZED:
            fmt, kind = _SIZED[b]
            return getattr(self, kind)(self._unpack(fmt))
        raise ValueError(f"{self.path}: byte 0x{b:02x} at {self.pos - 1} starts no msgpack value")


# msgpack's type bytes beside the fix forms: nil / false / true; numbers by
# struct format; fixext by payload length; values whose length comes first,
# by (format of the length, reader method)
_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_SIZED = {0xC4: (">B", "_bin"), 0xC5: (">H", "_bin"), 0xC6: (">I", "_bin"),
          0xC7: (">B", "_ext"), 0xC8: (">H", "_ext"), 0xC9: (">I", "_ext"),
          0xD9: (">B", "_str"), 0xDA: (">H", "_str"), 0xDB: (">I", "_str"),
          0xDC: (">H", "_seq"), 0xDD: (">I", "_seq"),
          0xDE: (">H", "_map"), 0xDF: (">I", "_map")}


def _unchunk(tree):
    """flax's chunked-array dicts joined into arrays, in place."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(CHUNKED) is True:
        shape = tuple(int(tree["shape"][str(i)]) for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    for k, v in tree.items():
        tree[k] = _unchunk(v)
    return tree


def msgpack_restore(path: str | Path):
    """The tree of a flax msgpack file, its arrays over the file's mapping."""
    path = Path(path)
    with open(path, "rb") as f:
        if os.fstat(f.fileno()).st_size == 0:
            raise ValueError(f"{path}: empty file")
        # copy on write: the arrays are writable, the file is never changed
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    reader = _Reader(buf, path)
    tree = reader.value()
    if reader.pos != len(buf):
        raise ValueError(f"{path}: {len(buf) - reader.pos} bytes after the msgpack value")
    return _unchunk(tree)


def _header(small: int, codes: tuple, n: int) -> bytes:
    """The header of a str / bin / array / map / ext of n items or bytes:
    the fix form below `small`, else the 8-, 16- or 32-bit length form
    (codes in that order; None where msgpack has no such form)."""
    if small and n < small:
        return bytes([codes[0] | n])
    for code, fmt, limit in zip(codes[1:], (">B", ">H", ">I"), (2 ** 8, 2 ** 16, 2 ** 32)):
        if code is not None and n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"a msgpack value of {n} items or bytes is too large")


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    forms = ((0, 2 ** 8, 0xCC, ">B"), (0, 2 ** 16, 0xCD, ">H"), (0, 2 ** 32, 0xCE, ">I"),
             (0, 2 ** 64, 0xCF, ">Q"), (-2 ** 7, 0, 0xD0, ">b"), (-2 ** 15, 0, 0xD1, ">h"),
             (-2 ** 31, 0, 0xD2, ">i"), (-2 ** 63, 0, 0xD3, ">q"))
    for lo, hi, code, fmt in forms:
        if lo <= v < hi:
            return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"integer {v} does not fit msgpack")


def _str(s: str) -> bytes:
    data = s.encode("utf-8")
    return _header(32, (0xA0, 0xD9, 0xDA, 0xDB), len(data)) + data


def _dtype_name(arr) -> str:
    return "bfloat16" if arr.dtype == torch.bfloat16 else arr.dtype.name


def _array_parts(arr) -> list:
    """An ndarray (or a bfloat16 tensor) as flax's ext: header, then the
    payload's header, then its bytes (written from the array's memory)."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype != torch.bfloat16:
            raise ValueError(f"torch leaves are written only as bfloat16, not {arr.dtype}")
        name, shape = "bfloat16", tuple(arr.shape)
        data = arr.detach().cpu().contiguous().view(torch.uint16).numpy()
    else:
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes are not written")
        name, shape, data = arr.dtype.name, arr.shape, np.ascontiguousarray(arr)
    head = bytes([0x93]) + _header(16, (0x90, None, 0xDC, 0xDD), len(shape))
    head += b"".join(_int(int(d)) for d in shape) + _str(name)
    head += _header(0, (None, 0xC4, 0xC5, 0xC6), data.nbytes)
    n = len(head) + data.nbytes
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    ext = bytes([fixext[n]]) if n in fixext else _header(0, (None, 0xC7, 0xC8, 0xC9), n)
    return [ext + struct.pack(">b", EXT_NDARRAY) + head, memoryview(data.reshape(-1)).cast("B")]


def _chunk(arr) -> dict:
    """flax's `_chunk`: the flat array in pieces of MAX_CHUNK_SIZE bytes."""
    itemsize = 2 if isinstance(arr, torch.Tensor) else arr.dtype.itemsize
    step = max(1, MAX_CHUNK_SIZE // itemsize)
    flat = arr.reshape(-1)
    return {CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[s:s + step]
                       for i, s in enumerate(range(0, flat.shape[0], step))}}


def _parts(v, out: list) -> None:
    if isinstance(v, dict):
        out.append(_header(16, (0x80, None, 0xDE, 0xDF), len(v)))
        for k, item in v.items():
            if not isinstance(k, str):
                raise ValueError(f"map key {k!r} is not a str")
            out.append(_str(k))
            _parts(item, out)
    elif isinstance(v, (np.ndarray, np.generic, torch.Tensor)):
        # a numpy scalar as a 0-d array, as the JAX save_variables writes it
        v = v if isinstance(v, torch.Tensor) else np.asarray(v)
        nbytes = v.numel() * v.element_size() if isinstance(v, torch.Tensor) else v.nbytes
        if nbytes > MAX_CHUNK_SIZE:
            _parts(_chunk(v), out)
        else:
            out.extend(_array_parts(v))
    elif v is None or isinstance(v, bool):
        out.append({None: b"\xc0", False: b"\xc2", True: b"\xc3"}[v])
    elif isinstance(v, int):
        out.append(_int(v))
    elif isinstance(v, float):
        out.append(b"\xcb" + struct.pack(">d", v))
    elif isinstance(v, str):
        out.append(_str(v))
    elif isinstance(v, bytes):
        out.append(_header(0, (None, 0xC4, 0xC5, 0xC6), len(v)) + v)
    elif isinstance(v, (list, tuple)):
        out.append(_header(16, (0x90, None, 0xDC, 0xDD), len(v)))
        for item in v:
            _parts(item, out)
    else:
        raise ValueError(f"cannot write a {type(v).__name__} to msgpack")


def _sorted(tree):
    """The tree's dicts with their keys sorted, as a JAX tree map returns them
    (flax's `msgpack_serialize` writes that copy of the tree)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def msgpack_write(path: str | Path, tree) -> None:
    """`tree` as the JAX `save_variables` writes it (flax's
    `msgpack_serialize` of the tree with its leaves as numpy arrays: the same
    bytes), into `path`, through a temporary file renamed into place, so a
    reader's mapping of an older file is never changed under it."""
    parts: list = []
    _parts(_sorted(tree), parts)
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        for p in parts:
            f.write(p)
    os.replace(tmp, path)


def save_variables(path: str | Path, variables: dict, meta: dict | None = None) -> None:
    """A variable tree (nested dicts of numpy arrays, or bfloat16 tensors) as
    a flax msgpack file, with `meta` as JSON beside it."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    msgpack_write(path, variables)
    if meta is not None:
        path.with_suffix(".json").write_text(json.dumps(meta, indent=2))


def load_variables(path: str | Path) -> tuple:
    """(variables, meta) of a checkpoint; meta is {} without a JSON file."""
    path = Path(path)
    variables = msgpack_restore(path)
    meta_path = path.with_suffix(".json")
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return variables, meta


TRAIN_STATE_FILE = "train_state.msgpack"


def _step_dir(ckpt_dir: str | Path, step: int) -> Path:
    return Path(ckpt_dir) / f"step_{step:08d}"


def save_state(ckpt_dir: str | Path, step: int, trainer: str, tree: dict) -> None:
    """A trainer's whole state, a tree of arrays and numbers, as
    `ckpt_dir/step_NNNNNNNN/train_state.msgpack`, under the trainer's name."""
    d = _step_dir(ckpt_dir, step)
    d.mkdir(parents=True, exist_ok=True)
    msgpack_write(d / TRAIN_STATE_FILE, {"trainer": trainer, **tree})


def load_state(ckpt_dir: str | Path, step: int, trainer: str) -> dict:
    """The tree `save_state` wrote at `step`; a ValueError where another
    trainer wrote it."""
    path = _step_dir(ckpt_dir, step) / TRAIN_STATE_FILE
    tree = msgpack_restore(path)
    if tree.get("trainer") != trainer:
        raise ValueError(f"{path} holds the {tree.get('trainer')!r} trainer's state, "
                         f"not the {trainer!r} trainer's")
    return tree


def optimizer_tree(optimizer: torch.optim.Optimizer, module: torch.nn.Module) -> dict:
    """An optimizer's per-parameter state as {parameter name: {key: array}},
    the names `module`'s (SGD's momentum_buffer; Adam's step, exp_avg and
    exp_avg_sq)."""
    names = {id(p): n for n, p in module.named_parameters()}
    return {names[id(p)]: {k: v.detach().cpu().numpy() for k, v in state.items()}
            for p, state in optimizer.state.items() if id(p) in names}


def load_optimizer_tree(optimizer: torch.optim.Optimizer, module: torch.nn.Module,
                        tree: dict) -> None:
    """`optimizer_tree`'s inverse, in place: each tensor on its parameter's
    device in its dtype, except a `step` count, which stays on the CPU as
    torch's optimizers keep it."""
    params = dict(module.named_parameters())
    for name, state in tree.items():
        p = params[name]
        optimizer.state[p] = {
            k: torch.tensor(np.array(v)) if k == "step" else torch.tensor(np.array(v)).to(p)
            for k, v in state.items()}


def save_train_state(ckpt_dir: str | Path, state, step: int) -> None:
    """`state` (a `train/classifier.TrainState`: model, SGD optimizer, step)
    into `ckpt_dir/step_NNNNNNNN/`."""
    save_state(ckpt_dir, step, "classifier", {
        **to_jax_variables(state.model),
        "optimizer": optimizer_tree(state.optimizer, state.model), "step": int(state.step)})


def load_train_state(ckpt_dir: str | Path, step: int, target):
    """The state saved at `step` loaded into `target` (a TrainState of the
    same model and optimizer) in place; returns it."""
    tree = load_state(ckpt_dir, step, "classifier")
    from_jax_variables({k: tree[k] for k in ("params", "batch_stats") if k in tree},
                       target.model)
    load_optimizer_tree(target.optimizer, target.model, tree["optimizer"])
    target.step = int(tree["step"])
    return target


def latest_step(ckpt_dir: str | Path) -> int | None:
    """Highest step_NNNNNNNN checkpoint directory in ckpt_dir (either
    package's), or None if there is none."""
    steps = sorted(int(p.name.split("_")[1])
                   for p in Path(ckpt_dir).glob("step_*") if p.is_dir())
    return steps[-1] if steps else None

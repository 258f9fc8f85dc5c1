"""The port's PNG codec (data/png.py, zlib and numpy) against PIL, and its
datasets (data/datasets.py) against the JAX package's on a PNG folder.

PIL writes files of modes L, LA, P, RGB and RGBA whose content makes its
encoder pick the None, Sub, Up and Paeth filters; it never picks Average,
so files with every row filter chosen by the test (a numpy filter written
here) cover all five, with PIL's decode as the reference. Files the port
writes decode equal in PIL. Interlaced and 16-bit files raise naming the
file; without PIL, so does a JPEG or an image that needs a resize."""

import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from gen_adversarial_tpu.data.datasets import ImageLabelDataset as JaxDataset
from gen_adversarial_tpu.data.datasets import ImageNameLabelDataset as JaxNameDataset
from gen_adversarial_tpu.data.datasets import iterate_batches as jax_iterate_batches
from gen_adversarial_tpu_torch.data import png
from gen_adversarial_tpu_torch.data.datasets import (
    ImageLabelDataset, ImageNameLabelDataset, iterate_batches)

MODES = {"L": 1, "LA": 2, "P": 1, "RGB": 3, "RGBA": 4}


def _content(h, w, c, seed):
    """Bands of gradient, noise, smooth waves and row ramps, a different band
    per channel: PIL's adaptive filter choice varies from row to row."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    kinds = [(xx * 3 + yy * 5) % 256, rng.randint(0, 256, (h, w)),
             128 + 100 * np.sin(xx / 5.0) * np.cos(yy / 7.0), (yy * 4) % 256,
             np.where((xx // 4 + yy // 4) % 2 == 0, 30, 220)]
    out = np.empty((h, w, c), np.uint8)
    for i in range(c):
        out[..., i] = np.choose((yy // 6 + i) % len(kinds), kinds).astype(np.uint8)
    return out


def _pil_file(tmp_path, mode, seed=0):
    arr = _content(60, 50, MODES[mode], seed)
    if mode == "P":  # 200 colors of a random palette
        img = Image.frombytes("P", (50, 60), (arr[..., 0] % 200).tobytes())
        img.putpalette(np.random.RandomState(seed).randint(0, 256, 600).tolist())
    else:
        img = Image.fromarray(arr.squeeze(-1) if mode == "L" else arr, mode)
    path = tmp_path / f"{mode}.png"
    img.save(path)
    return path


def _filters(path):
    """The filter type of every row of a file."""
    pixels, color, _ = png.decode(path)
    data = zlib.decompress(b"".join(p for k, p in png._chunks(path.read_bytes(), path)
                                    if k == b"IDAT"))
    stride = pixels.shape[1] * pixels.shape[2] + 1
    return set(np.frombuffer(data, np.uint8).reshape(-1, stride)[:, 0].tolist())


@pytest.mark.parametrize("mode", list(MODES))
def test_decoder_matches_pil_on_files_pil_wrote(tmp_path, mode):
    path = _pil_file(tmp_path, mode)
    with Image.open(path) as img:
        want, want_rgb = np.asarray(img), np.asarray(img.convert("RGB"))
    pixels, color, palette = png.decode(path)
    np.testing.assert_array_equal(pixels.reshape(want.shape), want)
    np.testing.assert_array_equal(png.read_rgb(path), want_rgb)


def test_pil_files_use_four_filters(tmp_path):
    used = set().union(*(_filters(_pil_file(tmp_path, m, seed=1)) for m in MODES))
    assert used == {0, 1, 2, 4}, used


def _filtered_png(pixels, filters):
    """A PNG whose row y uses filter filters[y % len(filters)] (the spec's
    filters, written independently of data/png.py)."""
    h, w, c = pixels.shape
    rows = pixels.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        kind = filters[y % len(filters)]
        x, up = rows[y], rows[y - 1] if y else np.zeros(w * c, np.int64)
        left = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if kind == 0:
            pred = np.zeros_like(x)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        out.append(np.concatenate([[kind], (x - pred) % 256]))
    color = png.COLOR_TYPE[c]
    chunk = lambda k, d: struct.pack(">I", len(d)) + k + d + struct.pack(">I", zlib.crc32(k + d))
    return (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(np.asarray(out, np.uint8).tobytes()))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_every_filter_type_decodes_as_pil_decodes(tmp_path, channels):
    pixels = _content(23, 19, channels, 2)
    path = tmp_path / "f.png"
    path.write_bytes(_filtered_png(pixels, [0, 1, 2, 3, 4, 3, 4, 1]))
    assert _filters(path) == {0, 1, 2, 3, 4}
    with Image.open(path) as img:
        np.testing.assert_array_equal(np.asarray(img).reshape(pixels.shape), pixels)
    np.testing.assert_array_equal(png.decode(path)[0], pixels)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_encoder_output_decodes_equal_in_pil(tmp_path, channels):
    pixels = _content(37, 41, channels, 3)
    png.write(tmp_path / "e.png", pixels if channels > 1 else pixels[..., 0])
    with Image.open(tmp_path / "e.png") as img:
        assert img.mode == {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[channels]
        np.testing.assert_array_equal(np.asarray(img).reshape(pixels.shape), pixels)
    np.testing.assert_array_equal(png.decode(tmp_path / "e.png")[0], pixels)


def test_interlaced_16_bit_and_corrupt_files_raise_naming_the_file(tmp_path):
    data = bytearray(png.encode(_content(8, 8, 3, 4)))
    ihdr = data[12:29]  # type + payload
    ihdr[-1] = 1  # Adam7
    data[12:29] = ihdr
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(ihdr)))
    (tmp_path / "interlaced.png").write_bytes(bytes(data))
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000).save(
        tmp_path / "deep.png")
    assert Image.open(tmp_path / "deep.png").mode.startswith("I")
    (tmp_path / "corrupt.png").write_bytes(png.encode(_content(8, 8, 3, 4))[:-20] + b"x" * 20)
    for name, what in (("interlaced", "interlaced"), ("deep", "16-bit"), ("corrupt", "CRC")):
        with pytest.raises(ValueError, match=f"{name}.png.*{what}"):
            png.decode(tmp_path / f"{name}.png")


@pytest.fixture()
def folder(tmp_path):
    """Three class folders of PNGs PIL wrote, in every mode, one of them not
    24 x 24 (resized through PIL, bilinear)."""
    rng = np.random.RandomState(0)
    for k, cls in enumerate(("zebra", "apple", "mango")):
        (tmp_path / cls).mkdir()
        for i, mode in enumerate(MODES):
            arr = rng.randint(0, 256, (24, 24, 4)).astype(np.uint8)
            img = Image.fromarray(arr[..., :MODES[mode]].squeeze(-1) if MODES[mode] == 1
                                  else arr[..., :MODES[mode]], "L" if mode == "P" else mode)
            if mode == "P":
                img = img.convert("P")
            if k == 1 and i == 0:
                img = img.resize((30, 20))
            img.save(tmp_path / cls / f"{i}.png")
    return tmp_path


def test_datasets_match_jax(folder):
    jax_ds, ds = JaxDataset(str(folder), 24), ImageLabelDataset(str(folder), 24)
    assert ds.class_to_idx == jax_ds.class_to_idx and ds.files == jax_ds.files
    np.testing.assert_array_equal(ds.labels, jax_ds.labels)
    for i in range(len(ds)):
        img, label = ds[i]
        want, want_label = jax_ds[i]
        assert img.dtype == np.float32 and label == want_label
        np.testing.assert_array_equal(img, want)
    assert ImageNameLabelDataset(str(folder), 24)[4][2] == JaxNameDataset(str(folder), 24)[4][2]


@pytest.mark.parametrize("kw", [dict(drop_last=False), dict(),
                                dict(drop_last=False, shard=(1, 2)),
                                dict(shard=(2, 3), prefetch=1),
                                dict(shuffle=True, seed=3, drop_last=False),
                                dict(shuffle=True, seed=1, shard=(1, 2))])
def test_iterate_batches_matches_jax(folder, kw):
    jax_ds, ds = JaxDataset(str(folder), 24), ImageLabelDataset(str(folder), 24)
    want = list(jax_iterate_batches(jax_ds, 4, use_native=False, **kw))
    got = list(iterate_batches(ds, 4, **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["label"], w["label"])


def test_without_pil_a_jpeg_or_a_resize_raises_naming_the_file(tmp_path, monkeypatch):
    (tmp_path / "a").mkdir()
    Image.fromarray(_content(16, 16, 3, 5)).save(tmp_path / "a" / "photo.jpg")
    png.write(tmp_path / "a" / "small.png", _content(8, 8, 3, 6))
    png.write(tmp_path / "a" / "fits.png", _content(16, 16, 3, 7))
    monkeypatch.setitem(sys.modules, "PIL", None)
    ds = ImageLabelDataset(str(tmp_path), 16)
    names = [f.name for f in ds.files]
    np.testing.assert_array_equal(ds.load_image(names.index("fits.png")),
                                  _content(16, 16, 3, 7).astype(np.float32) / 255.0)
    for name in ("photo.jpg", "small.png"):
        with pytest.raises(RuntimeError, match=f"{name}.*needs PIL"):
            ds.load_image(names.index(name))
    with pytest.raises(RuntimeError, match="needs PIL"):
        list(iterate_batches(ds, 3, drop_last=False))

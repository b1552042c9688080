"""The port's PNG reader and bicubic resize (``utils/images.py``) against
Pillow 12.1.0 and the JAX package's ``score_folder.load_images`` on the CPU.

- ``read_png``: bitwise Pillow's ``Image.open(p).convert("RGB")`` on files
  written by Pillow in modes RGB, RGBA, L and P at 1×1, 37×53 and 256×256
  (Pillow picks None, Sub, Up and Paeth rows there, and 1- to 8-bit
  palettes), on the port's own ``encode_png`` files, and on files this test
  writes with every row filter in turn (Average among them, which Pillow's
  writer picks rarely). Measured difference: 0 everywhere.
- ``resize_bicubic``: bitwise Pillow's ``Image.BICUBIC`` at 1024→224,
  256→32, 37→224 and 224→224 (measured 0).
- ``score_folder.load_images``: bitwise the JAX package's on one folder.
- JPEG, 16-bit and interlaced files raise, naming the file.

Pillow is imported inside the tests: the port does not use it.
"""

import io
import struct
import zlib

import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu_torch.evaluate import score_folder
from hyperscalees_t2i_tpu_torch.utils import images

torch.set_num_threads(1)
SIZES = [(1, 1), (37, 53), (256, 256)]


def _content(h, w, seed=0):
    """Smooth ramps in two channels and noise in the third, so that Pillow's
    adaptive writer picks several row filters."""
    yy, xx = np.mgrid[:h, :w]
    noise = np.random.default_rng(seed).integers(0, 256, size=(h, w))
    return np.stack([(xx * 3 + yy) % 256, (xx * yy) % 256, noise], -1).astype(np.uint8)


def _pillow_png(arr, mode):
    from PIL import Image

    img = Image.fromarray(arr, "RGB")
    img = img.convert("P", palette=Image.ADAPTIVE, colors=200) if mode == "P" else img.convert(mode)
    buf = io.BytesIO()
    img.save(buf, "PNG")
    return buf.getvalue()


def _pillow_rgb(data):
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _filtered_png(pix, color):
    """An 8-bit PNG of ``pix [H, W, C]`` whose row ``y`` uses filter ``y % 5``,
    its image data split over three ``IDAT`` chunks."""
    h, w, c = pix.shape
    bpp, rows, prior = c, [], np.zeros(w * c, np.int32)
    for y in range(h):
        cur = pix[y].reshape(-1).astype(np.int32)
        kind = y % 5
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) >> 1
        else:
            p = left + prior - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, up_left))
        rows.append(bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prior = cur
    data = zlib.compress(b"".join(rows))
    parts = [data[:len(data) // 3], data[len(data) // 3:2 * len(data) // 3], data[2 * len(data) // 3:]]
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + b"".join(_chunk(b"IDAT", p) for p in parts) + _chunk(b"IEND", b""))


def _row_filters(data):
    w, h, _, color = struct.unpack(">IIBB", data[16:26])
    stride = 1 + w * {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    pos, idat = 8, b""
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        idat += data[pos + 8:pos + 8 + n] if kind == b"IDAT" else b""
        pos += 12 + n
    return set(np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, stride)[:, 0].tolist())


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P"])
@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_read_png_is_pillows_decode_bitwise(tmp_path, mode, hw):
    data = _pillow_png(_content(*hw), mode)
    path = tmp_path / "img.png"
    path.write_bytes(data)
    ours = images.read_png(path)
    assert ours.dtype == np.uint8 and ours.shape == (*hw, 3)
    np.testing.assert_array_equal(ours, _pillow_rgb(data))


@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_read_png_round_trips_encode_png(tmp_path, hw):
    arr = _content(*hw, seed=1)
    path = images.write_png(tmp_path / "ours.png", arr)
    np.testing.assert_array_equal(images.read_png(path), arr)
    np.testing.assert_array_equal(images.read_png(path), _pillow_rgb(path.read_bytes()))


@pytest.mark.parametrize("color,channels", [(0, 1), (2, 3), (4, 2), (6, 4)])
def test_every_row_filter_decodes_as_pillow(color, channels):
    pix = np.random.default_rng(color).integers(0, 256, size=(23, 17, channels), dtype=np.uint8)
    pix[::2] = np.sort(pix[::2], axis=1)  # smooth rows beside random ones
    data = _filtered_png(pix, color)
    assert _row_filters(data) == {0, 1, 2, 3, 4}
    np.testing.assert_array_equal(images.decode_png(data), _pillow_rgb(data))


def test_pillow_files_here_cover_the_vectorized_filters():
    used = set()
    for mode in ("RGB", "RGBA", "L", "P"):
        for hw in SIZES:
            used |= _row_filters(_pillow_png(_content(*hw), mode))
    assert {0, 1, 2, 4} <= used


@pytest.mark.parametrize("src,dst", [(1024, 224), (256, 32), (37, 224), (224, 224)])
def test_resize_bicubic_is_pillows_bitwise(src, dst):
    from PIL import Image

    arr = np.random.default_rng(src).integers(0, 256, size=(src, src, 3), dtype=np.uint8)
    arr[: src // 2] = _content(src // 2, src)  # smooth rows above random ones
    ref = np.asarray(Image.fromarray(arr).resize((dst, dst), Image.BICUBIC))
    ours = images.resize_bicubic(arr, (dst, dst))
    assert ours.shape == (dst, dst, 3)
    np.testing.assert_array_equal(ours, ref)


def test_resize_bicubic_non_square_as_pillow():
    from PIL import Image

    arr = _content(53, 37, seed=3)
    ref = np.asarray(Image.fromarray(arr).resize((20, 90), Image.BICUBIC))
    np.testing.assert_array_equal(images.resize_bicubic(arr, (20, 90)), ref)


def test_load_images_is_the_reference_loaders_bitwise(tmp_path):
    from hyperscalees_t2i_tpu.evaluate.score_folder import load_images as jload_images

    paths = [images.write_png(tmp_path / "0000_ours.png", _content(64, 64, seed=5))]
    for i, (mode, hw) in enumerate([("RGB", (256, 256)), ("RGBA", (37, 53)), ("L", (40, 40)), ("P", (224, 224))]):
        p = tmp_path / f"{i + 1:04d}_pillow.png"
        p.write_bytes(_pillow_png(_content(*hw, seed=i), mode))
        paths.append(p)
    ours, theirs = score_folder.load_images(paths, 32), jload_images(paths, 32)
    assert ours.dtype == theirs.dtype == np.float32 and ours.shape == (5, 32, 32, 3)
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("suffix", [".jpg", ".jpeg", ".JPG"])
def test_jpeg_raises_naming_the_file(tmp_path, suffix):
    from PIL import Image

    path = tmp_path / f"0000_photo{suffix}"
    Image.fromarray(_content(8, 8)).save(path, "JPEG")
    with pytest.raises(ValueError, match=f"0000_photo\\{suffix}: JPEG is not read"):
        images.read_png(path)
    with pytest.raises(ValueError, match="JPEG"):
        score_folder.load_images([path], 32)


def test_unread_png_kinds_raise_naming_the_file(tmp_path):
    from PIL import Image

    deep = tmp_path / "deep.png"
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000).save(deep)
    with pytest.raises(ValueError, match="deep.png: PNG bit depth 16"):
        images.read_png(deep)
    data = bytearray(_filtered_png(_content(4, 4), 2))
    data[28] = 1  # the IHDR's interlace byte
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
    laced = tmp_path / "laced.png"
    laced.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="laced.png: interlaced PNG"):
        images.read_png(laced)
    broken = tmp_path / "broken.png"
    broken.write_bytes(bytes(data[:30]) + b"\x00" + bytes(data[31:]))
    with pytest.raises(ValueError, match="broken.png: broken PNG chunk"):
        images.read_png(broken)
    text = tmp_path / "text.png"
    text.write_text("hi")
    with pytest.raises(ValueError, match="text.png: not a PNG"):
        images.read_png(text)

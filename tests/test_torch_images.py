"""The port's image utilities (``utils/images.py``) against the JAX package's
and Pillow on the CPU.

- ``to_uint8``: bitwise the reference's.
- ``resize_lanczos``: within ±1 level of Pillow's ``Image.LANCZOS`` on
  random and smooth images, up and down; measured difference 0 at every
  case here (the port rounds its fixed-point coefficients and sums as
  Pillow's ``Resample.c`` does).
- ``make_prompt_strip``: within ±1 level of the reference's strip (its
  Pillow image as an array); measured 0.
- The PNG writer: Pillow decodes its files to the array, bitwise.
"""

import io

import numpy as np
import pytest
import torch
from PIL import Image

from hyperscalees_t2i_tpu.utils import images as jimages
from hyperscalees_t2i_tpu_torch.utils import images

torch.set_num_threads(1)
LEVELS = 1  # tolerance of the resize and the strip, in 8-bit levels


def _random(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _smooth(h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([np.sin(yy / 7.0), np.cos(xx / 11.0), np.sin((xx + yy) / 13.0)], -1) * 0.5 + 0.5


def test_to_uint8_bitwise():
    x = np.concatenate([_random((4, 5, 3)).ravel() * 1.4 - 0.2, [0.5 / 255, 1.5 / 255, 0.0, 1.0, -1.0, 2.0]])
    x = x.astype(np.float32)
    np.testing.assert_array_equal(images.to_uint8(x), jimages.to_uint8(x))
    u8 = (x * 200).astype(np.uint8)
    assert images.to_uint8(u8) is u8


@pytest.mark.parametrize("kind", ["random", "smooth"])
@pytest.mark.parametrize("hw, size", [((64, 64), (256, 256)), ((300, 200), (256, 256)), ((512, 512), (256, 256)),
                                      ((37, 91), (100, 50)), ((40, 24), (24, 256))])
def test_resize_lanczos_matches_pillow(kind, hw, size):
    img = images.to_uint8(_random((*hw, 3), seed=hw[0]) if kind == "random" else _smooth(*hw))
    ours = images.resize_lanczos(img, size)
    ref = np.asarray(Image.fromarray(img).resize(size, Image.LANCZOS))
    assert ours.shape == ref.shape == (size[1], size[0], 3) and ours.dtype == np.uint8
    diff = int(np.abs(ours.astype(int) - ref.astype(int)).max())
    print(f"{kind} {hw} -> {size}: max diff {diff} levels")
    assert diff <= LEVELS


@pytest.mark.parametrize("num_prompts, n_images", [(3, 3), (4, 2)])
def test_make_prompt_strip_matches_jax(num_prompts, n_images):
    imgs = [_random((48, 40, 3), seed=i) if i % 2 else _smooth(48, 40) for i in range(n_images)]
    ours = images.make_prompt_strip(imgs, num_prompts)
    ref = np.asarray(jimages.make_prompt_strip(imgs, num_prompts))
    assert ours.shape == ref.shape == (256, 256 * num_prompts, 3)
    assert int(np.abs(ours.astype(int) - ref.astype(int)).max()) <= LEVELS
    assert images.make_prompt_strip(imgs, 0) is None and jimages.make_prompt_strip(imgs, 0) is None


def test_png_writer_decodes_bitwise_through_pillow(tmp_path):
    img = images.to_uint8(_random((33, 70, 3), seed=5))
    with Image.open(io.BytesIO(images.encode_png(img))) as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), img)
    path = images.write_png(tmp_path / "a" / "b.png", img)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), img)
    # save_image converts a float image as the reference's save does
    f = _random((9, 7, 3), seed=6)
    images.save_image(f, tmp_path / "f.png")
    jimages.save_image(f, tmp_path / "jf.png")
    with Image.open(tmp_path / "f.png") as a, Image.open(tmp_path / "jf.png") as b:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    images.save_image(None, tmp_path / "none.png")
    assert not (tmp_path / "none.png").exists()

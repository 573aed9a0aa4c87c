"""Texture files through the demo's asset directory (txr_torch/apps/demo.py:
demo_textures, utils/image.py: load_image), as the reference's 8k planet
JPEGs are loaded, at 512×1024.

A banded planet made by the demo's own generator is written as RGBA8: as a
PNG, which the port decodes itself and must give back its u8 codes
exactly (k/255 in float32), and as a JPEG, which must equal PIL's decode
of the same file.  Textures with no file stay procedural.
"""

import numpy as np
import torch
from PIL import Image

from txr_torch.apps import demo

# one intra-op thread: parallel test workers share the cores
torch.set_num_threads(1)

SIZE = (512, 1024)


def _codes(name):
    tex = demo._banded_planet(*SIZE, *demo.PLANETS[name]).numpy()
    return np.round(np.clip(tex, 0.0, 1.0) * 255.0).astype(np.uint8)


def test_planet_png_and_jpeg_through_demo_textures(tmp_path):
    jupiter, saturn = _codes("jupiter"), _codes("saturn")
    Image.fromarray(jupiter, "RGBA").save(tmp_path / "jupiter.png")
    Image.fromarray(saturn[..., :3], "RGB").save(tmp_path / "saturn.jpg", quality=95)
    tex = demo.demo_textures(str(tmp_path))

    got = tex.sphere[0].numpy()
    assert got.shape == SIZE + (4,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, (jupiter / 255.0).astype(np.float32))

    with Image.open(tmp_path / "saturn.jpg") as img:
        want = np.asarray(img.convert("RGBA"))
    assert np.abs(want[..., :3].astype(int) - saturn[..., :3]).max() > 0      # lossy
    np.testing.assert_array_equal(tex.sphere[1].numpy(), (want / 255.0).astype(np.float32))

    # no file: the procedural textures, bit for bit
    ref = demo.demo_textures()
    assert torch.equal(tex.sphere[2], ref.sphere[2]) and torch.equal(tex.box, ref.box)
    assert torch.equal(tex.ring, ref.ring) and torch.equal(tex.cubemap, ref.cubemap)

"""The port's RandAugment (``processors/randaugment.py``) against the JAX
package's numpy original on the CPU: every op gives the same uint8 image on
seeded images at several levels, and RandomAugment / VideoRandomAugment
draw the same ops with the same arguments from equally seeded generators."""

import numpy as np
import pytest

from spider_tpu.processors import randaugment as jR
from spider_tpu_torch.processors import randaugment as tR


def _image(seed, h=23, w=31):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    img[:4, :5] = 17                          # a flat patch: equalize's and autocontrast's edges
    return img


def test_the_op_table_is_the_jax_one():
    assert list(tR.OPS) == list(jR.OPS) and tR.MAX_LEVEL == jR.MAX_LEVEL


@pytest.mark.parametrize("name", list(jR.OPS))
@pytest.mark.parametrize("level", [1, 5, 10])
def test_each_op_gives_the_jax_uint8_output(name, level):
    fn, to_args = tR.OPS[name]
    jfn, jto_args = jR.OPS[name]
    for seed in range(3):
        img = _image(seed)
        args = to_args(level, np.random.default_rng(seed))
        assert args == jto_args(level, np.random.default_rng(seed))
        out, want = fn(img.copy(), *args), jfn(img.copy(), *args)
        assert out.dtype == np.uint8 and out.shape == img.shape
        np.testing.assert_array_equal(out, want)


def test_ops_on_flat_and_two_valued_images():
    flat = np.full((9, 7, 3), 90, np.uint8)
    two = np.where(np.arange(63).reshape(9, 7, 1) % 2, 200, 10).astype(np.uint8).repeat(3, 2)
    for img in (flat, two):
        for fn, jfn in ((tR.autocontrast, jR.autocontrast), (tR.equalize, jR.equalize),
                        (tR.sharpness, jR.sharpness)):
            args = (0.3,) if fn is tR.sharpness else ()
            np.testing.assert_array_equal(fn(img, *args), jfn(img, *args))
    np.testing.assert_array_equal(tR.posterize(two, 8), two)


def test_cutout_with_a_seeded_generator():
    img = _image(4)
    for pad in (0, 3, 40):
        out = tR.cutout(img, pad, rng=np.random.default_rng(pad))
        np.testing.assert_array_equal(out, jR.cutout(img, pad, rng=np.random.default_rng(pad)))


@pytest.mark.parametrize("augs", [None, ["Identity", "AutoContrast", "Equalize", "Brightness",
                                         "Sharpness", "ShearX", "ShearY", "TranslateX",
                                         "TranslateY", "Rotate"]])
def test_random_augment_equals_the_jax_one(augs):
    t = tR.RandomAugment(N=2, M=5, augs=augs, rng=np.random.default_rng(7))
    j = jR.RandomAugment(N=2, M=5, augs=augs, rng=np.random.default_rng(7))
    for seed in range(8):
        img = _image(seed)
        np.testing.assert_array_equal(t(img), j(img))
    as_float = _image(9).astype(np.float32) * 1.5
    np.testing.assert_array_equal(t(as_float), j(as_float))


def test_video_random_augment_equals_the_jax_one():
    frames = np.stack([_image(s, 16, 20) for s in range(4)])
    for p in (0.0, 0.5):
        t = tR.VideoRandomAugment(N=3, M=7, p=p, rng=np.random.default_rng(3))
        j = jR.VideoRandomAugment(N=3, M=7, p=p, rng=np.random.default_rng(3))
        for _ in range(4):
            out = t(frames)
            assert out.dtype == np.float32 and out.shape == frames.shape
            np.testing.assert_array_equal(out, j(frames))

"""The processors the port registers (spider_tpu_torch/processors/__init__.py)
against the JAX package's (spider_tpu/processors/__init__.py), and the
fields of ``LoraConfig`` against the JAX one's.

Each processor runs on the same input in both packages: the caption's text
equal, the eval transform's array equal, the train transform's array equal
under the same numpy seed (both are numpy on the host).
"""

import dataclasses

import numpy as np
import pytest

import spider_tpu.processors as jproc
import spider_tpu_torch.processors as tproc
from spider_tpu.common.registry import registry as jregistry
from spider_tpu.models import llama as jL
from spider_tpu_torch.common.registry import registry as tregistry
from spider_tpu_torch.models import llama as tL

NAMES = ("blip_caption", "blip2_image_train", "blip2_image_eval")


@pytest.mark.parametrize("name", NAMES)
def test_the_port_registers_the_jax_packages_processors(name):
    cls = tregistry.get_processor_class(name)
    assert cls is not None and cls.__module__ == tproc.__name__
    assert jregistry.get_processor_class(name).__name__ == cls.__name__


def _image(seed):
    return np.random.default_rng(seed).integers(0, 256, (40, 56, 3)).astype(np.uint8)


def test_blip_caption_equals_the_jax_processor():
    caption = "  A Dog, running on the BEACH!!  with   two  birds;  " + "word " * 60
    for kw in (dict(), dict(prompt="a photo of ", max_words=5)):
        assert tproc.CaptionProcessor(**kw)(caption) == jproc.CaptionProcessor(**kw)(caption)


def test_blip2_image_eval_equals_the_jax_processor():
    img = _image(1)
    np.testing.assert_array_equal(tproc.ImageEvalProcessor(image_size=32)(img),
                                  jproc.ImageEvalProcessor(image_size=32)(img))


def test_blip2_image_train_equals_the_jax_processor_under_one_seed():
    img = _image(2)
    got = tproc.ImageTrainProcessor(image_size=32)(img, rng=np.random.default_rng(5))
    want = jproc.ImageTrainProcessor(image_size=32)(img, rng=np.random.default_rng(5))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_lora_config_fields_equal_the_jax_ones():
    fields = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(tL.LoraConfig) == fields(jL.LoraConfig)
    assert tL.LoraConfig(dropout=0.1).dropout == 0.1

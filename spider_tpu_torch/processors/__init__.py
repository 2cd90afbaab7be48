"""Preprocessing pipelines (numpy, host-side): copies of the framework-free
``text``, ``vision``, ``video`` and ``audio`` modules of
spider_tpu/processors/.

Importing registers the three named processors the JAX package registers
(its processors/__init__.py): ``blip_caption``, ``blip2_image_train`` and
``blip2_image_eval``, the port's own copies.
"""

from spider_tpu_torch.common.registry import registry
from spider_tpu_torch.processors.text import text_processor
from spider_tpu_torch.processors.vision import clip_image_transform, train_augment


@registry.register_processor("blip_caption")
class CaptionProcessor:
    """Text cleanup: the prompt, then the caption cleaned and cut to
    max_words words."""

    def __init__(self, prompt: str = "", max_words: int = 50):
        self.prompt = prompt
        self.max_words = max_words

    def __call__(self, caption: str) -> str:
        return self.prompt + text_processor(caption, max_words=self.max_words)


@registry.register_processor("blip2_image_train")
class ImageTrainProcessor:
    """The random crop and flip of ``train_augment``, then the CLIP
    resize and normalisation."""

    def __init__(self, image_size: int = 224):
        self.image_size = image_size

    def __call__(self, img, rng=None):
        return clip_image_transform(train_augment(img, rng=rng), size=self.image_size)


@registry.register_processor("blip2_image_eval")
class ImageEvalProcessor:
    """The CLIP resize and normalisation."""

    def __init__(self, image_size: int = 224):
        self.image_size = image_size

    def __call__(self, img):
        return clip_image_transform(img, size=self.image_size)

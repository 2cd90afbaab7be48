"""Dataset builders. Importing registers all 21 builders of the JAX package
with the registry: text->X and X->text (``text2x``, ``x2text``), grounding
(``grounding``), story (``story``) and travel (``travel_guide``)."""

from spider_tpu_torch.datasets import grounding  # noqa: F401
from spider_tpu_torch.datasets import story  # noqa: F401
from spider_tpu_torch.datasets import text2x  # noqa: F401
from spider_tpu_torch.datasets import travel_guide  # noqa: F401
from spider_tpu_torch.datasets import x2text  # noqa: F401

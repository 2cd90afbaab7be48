"""Dataset builders. Importing registers the ported builders with the
registry: the text->X and X->text families (``text2x``, ``x2text``). The
grounding, referring, story and travel families are not ported yet."""

from spider_tpu_torch.datasets import text2x  # noqa: F401
from spider_tpu_torch.datasets import x2text  # noqa: F401

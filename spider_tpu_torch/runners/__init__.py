"""Training runners; importing registers ``runner_base``."""

from spider_tpu_torch.runners.runner import RunnerBase  # noqa: F401

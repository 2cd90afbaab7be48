"""Task registry."""

from spider_tpu_torch.common.registry import registry
from spider_tpu_torch.tasks.base_task import BaseTask, ImageTextPretrainTask  # noqa: F401


def setup_task(cfg):
    task_name = cfg.run.task if "task" in cfg.run else "image_text_pretrain"
    task_cls = registry.get_task_class(task_name)
    if task_cls is None:
        raise KeyError(f"unknown task {task_name}")
    return task_cls.setup_task(cfg=cfg)

"""Task layer (counterpart of spider_tpu/tasks/base_task.py): builds the model
from cfg.model.type via the registry on an explicit device, builds
{split: {name: dataset}} dicts with batch_size and sample_ratio attached, and
evaluates by loss. One process: the per-rank seed offsets and result shards
of the reference wait for the multi-card slice."""

from __future__ import annotations

import logging
from typing import Any, Dict

import torch

from spider_tpu_torch.common.registry import registry


class BaseTask:
    @classmethod
    def setup_task(cls, **kwargs):
        return cls()

    def build_model(self, cfg, *, device):
        model_config = dict(cfg.model)
        model_type = model_config.pop("type")
        model_cls = registry.get_model_class(model_type)
        if model_cls is None:
            raise KeyError(f"unknown model {model_type}")
        if hasattr(model_cls, "from_config"):
            return model_cls.from_config(model_config, device=device)
        return model_cls(**model_config)

    def build_datasets(self, cfg) -> Dict[str, Dict[str, Any]]:
        """cfg.datasets: {name: {batch_size, sample_ratio, build_info, ...}}
        -> {split: {name: dict(dataset, batch_size, sample_ratio)}}."""
        datasets: Dict[str, Dict[str, Any]] = {}
        for name, dataset_cfg in cfg.datasets.items():
            builder_cls = registry.get_builder_class(name)
            if builder_cls is None:
                raise KeyError(f"unknown dataset builder {name}")
            dataset_cfg = dict(dataset_cfg)
            dataset = builder_cls(dataset_cfg).build_datasets()
            if dataset is None:
                logging.warning("builder %s produced no dataset", name)
                continue
            entry = datasets.setdefault(dataset_cfg.get("split", "train"), {})
            entry[name] = dict(dataset=dataset,
                               batch_size=dataset_cfg.get("batch_size", 1),
                               sample_ratio=dataset_cfg.get("sample_ratio", 1.0))
        return datasets

    def evaluation(self, model, data_loader, max_batches: int = 8):
        results = []
        for i, samples in enumerate(data_loader):
            if i >= max_batches:
                break
            with torch.no_grad():
                out = model.forward(samples)
            results.append({k: float(v) for k, v in out.items()})
        return results


@registry.register_task("image_text_pretrain")
class ImageTextPretrainTask(BaseTask):
    pass

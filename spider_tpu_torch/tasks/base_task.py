"""Task layer (counterpart of spider_tpu/tasks/base_task.py): builds the model
from cfg.model.type via the registry on an explicit device, builds
{split: {name: dataset}} dicts with batch_size and sample_ratio attached, and
evaluates by loss. Each data-parallel rank draws its own samples (seeds
offset by that rank); ``save_result`` writes every rank's shard and merges
them on rank 0 after a barrier."""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict

import torch

from spider_tpu_torch.common import dist
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

    def build_datasets(self, cfg, data_rank: int = 0) -> Dict[str, Dict[str, Any]]:
        """cfg.datasets: {name: {batch_size, sample_ratio, build_info, ...}}
        -> {split: {name: dict(dataset, batch_size, sample_ratio)}}.
        data_rank: this rank's index over data x fsdp
        (``dist.data_parallel_rank``); context peers share it."""
        datasets: Dict[str, Dict[str, Any]] = {}
        for name, dataset_cfg in cfg.datasets.items():
            builder_cls = registry.get_builder_class(name)
            if builder_cls is None:
                raise KeyError(f"unknown dataset builder {name}")
            # Every data-parallel rank draws its own samples: a per-source
            # seed offset of rank * 9973, as in the JAX package (which
            # offsets by process; here the data-parallel rank, so that the
            # ranks of a context group draw the same sequences). Every
            # builder gets an explicit seed, so one whose own default is not
            # 0 (flintstones) draws what the JAX task's does.
            dataset_cfg = dict(dataset_cfg)
            build_info = dict(dataset_cfg.get("build_info", {}))
            build_info["seed"] = build_info.get("seed", 0) + data_rank * 9973
            dataset_cfg["build_info"] = build_info
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

    def save_result(self, results, result_dir, filename) -> str:
        """Every rank writes its shard; after a barrier (which the JAX
        package lacks, C20: its process 0 could merge before the others had
        written) rank 0 merges them in rank order. Returns the merged
        file's path."""
        rank, world_size = dist.get_rank(), dist.get_world_size()
        os.makedirs(result_dir, exist_ok=True)
        shard = os.path.join(result_dir, f"{filename}_rank{rank}.json")
        with open(shard, "w") as f:
            json.dump(results, f)
        final = os.path.join(result_dir, f"{filename}.json")
        dist.barrier()
        if rank == 0:
            merged = []
            for r in range(world_size):
                path = os.path.join(result_dir, f"{filename}_rank{r}.json")
                if os.path.exists(path):
                    with open(path) as f:
                        merged.extend(json.load(f))
            with open(final, "w") as f:
                json.dump(merged, f)
        dist.barrier()
        return final


@registry.register_task("image_text_pretrain")
class ImageTextPretrainTask(BaseTask):
    pass

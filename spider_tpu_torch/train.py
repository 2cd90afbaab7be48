"""Training entry point of the port:

    python -m spider_tpu_torch.train <config.py> [--device cuda|cpu] [--options k=v ...]
    torchrun --nproc_per_node N -m spider_tpu_torch.train <config.py> [--device cpu]

It reads the same ``train_configs/*.py`` files as the JAX package's
``train.py`` and runs on ``cuda:LOCAL_RANK`` (``cuda:0`` alone) unless the
caller asks for the CPU. Under torchrun, or with ``run.mesh`` in the config,
the ranks join one process group (nccl on the card, gloo with ``--device
cpu``) and the runner shards the model over ``run.mesh``.
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch

from spider_tpu_torch.common.config import Config, apply_overrides
from spider_tpu_torch.common.logger import setup_logger
from spider_tpu_torch.common.registry import registry
from spider_tpu_torch.common.utils import now


def register_all() -> None:
    """Import every submodule that registers itself with the registry."""
    import spider_tpu_torch.datasets  # noqa: F401
    import spider_tpu_torch.models.spider  # noqa: F401
    import spider_tpu_torch.runners  # noqa: F401
    import spider_tpu_torch.tasks  # noqa: F401


def setup_seeds(cfg) -> None:
    seed = int(cfg.run.get("seed", 42))
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="spider training (PyTorch port)")
    parser.add_argument("cfg_path", help="path to configuration file")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda (the default; cuda:LOCAL_RANK) or cpu")
    parser.add_argument("--options", nargs="*", default=[],
                        help="dotted key=value overrides, e.g. run.max_epoch=2")
    return parser.parse_args(argv)


def build_runner(cfg, device, job_id: str):
    """Output directory, logger, seeds, task, datasets, model and runner from
    a loaded config: everything ``main`` does before ``runner.train()``."""
    from spider_tpu_torch import tasks
    from spider_tpu_torch.common import dist
    from spider_tpu_torch.runners.runner import build_mesh

    register_all()
    mesh = build_mesh(cfg.run, device)       # raises where the world cannot hold run.mesh
    output_dir = cfg.run.get("output_dir", f"output/{job_id}")
    registry.register_path("output_dir", output_dir)
    setup_logger(output_dir)
    setup_seeds(cfg)

    task = tasks.setup_task(cfg)
    datasets = task.build_datasets(cfg, data_rank=dist.data_parallel_rank(mesh)[0])
    model = task.build_model(cfg, device=device)

    runner_cls = registry.get_runner_class(cfg.run.get("runner", "runner_base"))
    return runner_cls(cfg=cfg, task=task, model=model, datasets=datasets, job_id=job_id,
                      mesh=mesh)


def main(argv=None):
    """Build task, datasets, model and runner from the config and train;
    returns the runner."""
    job_id = now()
    args = parse_args(argv)
    cfg = apply_overrides(Config.fromfile(args.cfg_path), args.options)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("spider_tpu_torch.train: no CUDA device; pass --device cpu to train "
                         "on the CPU")
    device = (torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
              if args.device == "cuda" else torch.device("cpu"))
    runner = build_runner(cfg, device, job_id)
    runner.train()
    return runner


if __name__ == "__main__":
    main()

"""Training runner (counterpart of spider_tpu/runners/runner.py).

Responsibilities: ratio-mixed dataloaders, the train step over Spider's
trainable parameters (prepare the batch on the host, pad it to a length
bucket, encode the modalities with the frozen encoder, take the decoder's
text conditioning as the target, loss, backward, optimizer), AdamW with
warmup-decay and frozen embedding rows, metric logging with a
``metrics.jsonl`` stream, checkpoint save and resume (``torch.save`` of the
trainable parameters, the optimizer state, the step and the epoch), eval
epochs, and a checkpoint on SIGTERM.

``run.mesh`` ({"data": 2, "context": 4, ...}) is honoured over the ranks of
the process group (``build_mesh``; a world of several ranks with no
``run.mesh`` puts them all on ``data``): a mesh the world cannot hold raises
ValueError and is never run on fewer ranks. The model is then sharded
(``train_step.shard_model``: TP over ``model``, ring attention over
``context`` when it is > 1, FSDP2/HSDP over data x fsdp). Each data-parallel
rank draws its own batch of ``batch_size`` (the task's seeds are offset by
its rank) and context peers draw the same one, so the global batch is the
concatenation over data-parallel ranks, as in the JAX package's multi-host
model. The whole sequence is prepared on the host, padded to a multiple of
the bucket and of the context size, its targets shifted, and then cut to
this context rank's rows (``Spider.batch_loss``, through the model's
``shards``). Losses are token-weighted across ranks; the metrics written and
the eval losses compared for the best checkpoint are the whole batch's,
alike on every rank. Rank 0 writes ``metrics.jsonl`` and the checkpoints,
which hold whole tensors. Without a mesh (one process, no ``run.mesh``)
nothing is wrapped, and the same step runs on the whole batch.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from spider_tpu_torch.common import dist
from spider_tpu_torch.common.logger import MetricLogger, SmoothedValue
from spider_tpu_torch.common.optims import build_schedule
from spider_tpu_torch.common.registry import registry
from spider_tpu_torch.datasets.utils.loaders import MultiIterLoader, batched
from spider_tpu_torch.models.spider import Spider
from spider_tpu_torch.parallel import partition
from spider_tpu_torch.runners.train_step import backward_and_step, build_optimizer, shard_model


def build_mesh(run, device):
    """The DeviceMesh ``run.mesh`` asks for over the process group, or None
    for one process without ``run.mesh``. Starts the group where none is
    (torchrun's environment, else a world of one on `device`). Raises
    ValueError where the world cannot hold the mesh."""
    mesh_cfg = dict(run.get("mesh") or {})
    if not mesh_cfg and int(os.environ.get("WORLD_SIZE", 1)) == 1 \
            and not dist.is_dist_avail_and_initialized():
        return None
    if not dist.is_dist_avail_and_initialized():
        dist.init_distributed_mode(device)
    return dist.make_mesh(**mesh_cfg)


@registry.register_runner("runner_base")
class RunnerBase:
    mesh = None         # the DeviceMesh the model is sharded over, if any

    def __init__(self, cfg, task, model: Spider, datasets, job_id: str, mesh=None):
        self.config = cfg
        self.task = task
        self.model = model
        self.datasets = datasets
        self.job_id = job_id

        run = cfg.run
        self.max_epoch = int(run.get("max_epoch", 1))
        self.iters_per_epoch = int(run.get("iters_per_epoch", 100))
        self.log_freq = int(run.get("log_freq", 50))
        self.seed = int(run.get("seed", 42))
        self.length_bucket = int(run.get("length_bucket", 32))
        self.output_dir = run.get("output_dir", "output/" + job_id)
        os.makedirs(self.output_dir, exist_ok=True)
        self.start_epoch = 0

        self.schedule = build_schedule(
            run.get("lr_sched", "warmup_decay_lr"),
            init_lr=float(run.get("init_lr", 1e-4)),
            min_lr=float(run.get("min_lr", 0.0)),
            warmup_steps=int(run.get("warmup_steps", 500)),
            total_steps=self.max_epoch * self.iters_per_epoch,
            decay_rate=float(run.get("lr_decay_rate", 0.9)),
            steps_per_epoch=self.iters_per_epoch,
        )
        trainable_patterns = run.get("trainable_patterns")
        patterns = tuple(trainable_patterns) if trainable_patterns else None
        # What the optimizer does not hold never moves: take it out of
        # autograd too, so its gradient is neither computed nor stored.
        if patterns is not None:
            keep = partition.trainable_mask(model, patterns)
            for name, p in model.trainable_params().items():
                if not keep[name]:
                    p.requires_grad_(False)
        self.mesh = mesh if mesh is not None else build_mesh(run, model.device)
        if self.mesh is not None:
            shard_model(model, self.mesh, partition.SPIDER_RULES)
        self.optimizer = build_optimizer(
            self.schedule,
            params=model.trainable_params(),
            weight_decay=float(run.get("weight_decay", 0.0)),
            max_grad_norm=float(run.get("max_grad_norm", 1.0)),
            grad_accum_steps=int(run.get("accum_grad_iters", 1)),
            num_frozen_embed_rows=int(run.get("num_frozen_embed_rows", 0)),
            trainable_patterns=patterns,
        )
        self.global_step = 0
        self._loaders: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------- loaders
    @property
    def dataloaders(self) -> Dict[str, Any]:
        if self._loaders is None:
            self._loaders = {}
            for split, entries in self.datasets.items():
                iters, ratios = [], []
                for entry in entries.values():
                    iters.append(batched(iter(entry["dataset"]), entry["batch_size"]))
                    ratios.append(entry["sample_ratio"])
                self._loaders[split] = MultiIterLoader(iters, ratios, seed=self.seed)
        return self._loaders

    # ---------------------------------------------------------- train step
    def loss_dict(self, samples: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The step's forward: samples -> this rank's shares of
        ``Spider.compute_loss``'s dict, the batch padded to the length bucket."""
        return self.model.batch_loss(samples, self.length_bucket)

    def train_step(self, samples: Dict[str, Any]) -> Dict[str, float]:
        self.model.train()
        shards = self.model.shards
        out = self.loss_dict(samples)
        backward_and_step(out["loss"], self.optimizer, shards)
        out = shards.reduce_metrics(out)
        self.global_step += 1
        return {k: float(v) for k, v in out.items()}

    # -------------------------------------------------------------- epochs
    def train_epoch(self, epoch: int) -> Dict[str, str]:
        metric_logger = MetricLogger(delimiter="  ")
        metric_logger.add_meter("lr", SmoothedValue(window_size=1, fmt="{value:.6f}"))
        loader = self.dataloaders["train"]
        header = f"Train: data epoch: [{epoch}]"
        metrics_path = os.path.join(self.output_dir, "metrics.jsonl")
        mf = open(metrics_path, "a") if dist.is_main_process() else None
        try:
            for _ in metric_logger.log_every(range(self.iters_per_epoch), self.log_freq,
                                             header):
                metrics = self.train_step(next(loader))
                lr = float(self.schedule(self.global_step))
                metric_logger.update(**metrics)
                metric_logger.update(lr=lr)
                if mf is not None:      # per-iteration scalar stream, rank 0's
                    mf.write(json.dumps({"step": self.global_step, "epoch": epoch, "lr": lr,
                                         **metrics}) + "\n")
        finally:
            if mf is not None:
                mf.close()
        metric_logger.synchronize_between_processes()
        return {k: f"{m.global_avg:.3f}" for k, m in metric_logger.meters.items()}

    def eval_epoch(self, split: str = "val", max_batches: int = 8):
        """The task's evaluation; each batch's values are the whole batch's
        (every rank scored its piece), alike on every rank, so that every
        rank takes the same branch at the best checkpoint."""
        if split not in self.dataloaders:
            return None
        self.model.eval()
        results = self.task.evaluation(self.model, self.dataloaders[split], max_batches)
        device = self.model.device
        return [{k: float(v) for k, v in self.model.shards.reduce_metrics(
                    {k: torch.tensor(v, device=device) for k, v in r.items()}).items()}
                for r in results]

    def install_preemption_handler(self) -> None:
        """Save a checkpoint on SIGTERM (preemption), then exit 143."""

        def handler(signum, frame):
            logging.warning("SIGTERM: saving preemption checkpoint")
            self.save_checkpoint(epoch=-1)
            raise SystemExit(143)

        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not on the main thread

    def train(self) -> Dict[str, Any]:
        """Epoch loop with per-epoch eval and best-checkpoint tracking."""
        start = time.time()
        self.install_preemption_handler()
        resume_path = self.config.run.get("resume_ckpt_path")
        if resume_path:
            self.load_checkpoint(resume_path)
        stats: Dict[str, Any] = {}
        best_metric = float("inf")
        for epoch in range(self.start_epoch, self.max_epoch):
            stats = self.train_epoch(epoch)
            logging.info("epoch %d: %s", epoch, stats)
            self.save_checkpoint(epoch)
            val = self.eval_epoch("val")
            if val:
                mean_loss = float(np.mean([r.get("loss", 0.0) for r in val]))
                logging.info("epoch %d val loss %.4f", epoch, mean_loss)
                if mean_loss < best_metric:
                    best_metric = mean_loss
                    self.save_checkpoint_best(epoch)
        logging.info("Training time %.1fs", time.time() - start)
        return stats

    # --------------------------------------------------------- checkpoints
    def _ckpt_path(self, name: str) -> str:
        return os.path.join(os.path.abspath(self.output_dir), f"checkpoint_{name}.pt")

    def _params_state(self) -> Dict[str, torch.Tensor]:
        """Whole tensors (a sharded parameter is gathered: every rank calls)."""
        return {n: (p.full_tensor() if hasattr(p, "full_tensor") else p).detach()
                for n, p in self.optimizer.params.items()}

    def save_checkpoint_best(self, epoch: int) -> str:
        path = self._ckpt_path("best")
        state = dict(params=self._params_state(), epoch=epoch)
        if dist.is_main_process():
            torch.save(state, path)
        dist.barrier()
        return path

    def save_checkpoint(self, epoch: int) -> str:
        path = self._ckpt_path(str(epoch))
        state = dict(params=self._params_state(), opt_state=self.optimizer.state_dict(),
                     step=self.global_step, epoch=epoch)
        if dist.is_main_process():
            torch.save(state, path)
            logging.info("Saved checkpoint to %s", path)
        dist.barrier()
        return path

    def load_checkpoint(self, path: str) -> None:
        # weights_only: a checkpoint holds tensors, ints and dicts, nothing
        # that needs unpickling code
        state = torch.load(path, map_location=self.model.device, weights_only=True)
        params = self.optimizer.params
        if set(state["params"]) != set(params):
            raise KeyError("checkpoint parameters do not match the trainable parameters")
        with torch.no_grad():
            for n, t in state["params"].items():
                local = params[n]._local_tensor if hasattr(params[n], "_local_tensor") \
                    else params[n]
                local.copy_(self.optimizer.shard(n, t))
        self.optimizer.load_state_dict(state["opt_state"])
        self.global_step = int(state["step"])
        self.start_epoch = int(state["epoch"]) + 1
        logging.info("Resumed from %s (epoch %d)", path, self.start_epoch)

    # ----------------------------------------------------------------- misc
    def model_forward(self, samples):
        return self.model.forward(samples)

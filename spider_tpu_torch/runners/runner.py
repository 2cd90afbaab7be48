"""Training runner on one device (counterpart of spider_tpu/runners/runner.py
without its mesh: sharded state and the context axis wait for the multi-card
slice).

Responsibilities: ratio-mixed dataloaders, the train step over Spider's
trainable parameters (prepare the batch on the host, pad it to a length
bucket, encode the modalities with the frozen encoder, take the decoder's
text conditioning as the target, loss, backward, optimizer), AdamW with
warmup-decay and frozen embedding rows, metric logging with a
``metrics.jsonl`` stream, checkpoint save and resume (``torch.save`` of the
trainable parameters, the optimizer state, the step and the epoch), eval
epochs, and a checkpoint on SIGTERM.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from spider_tpu_torch.common.logger import MetricLogger, SmoothedValue
from spider_tpu_torch.common.optims import build_schedule
from spider_tpu_torch.common.registry import registry
from spider_tpu_torch.datasets.utils.loaders import MultiIterLoader, batched
from spider_tpu_torch.models.spider import IGNORE, PreparedBatch, Spider
from spider_tpu_torch.runners.train_step import backward_and_step, build_optimizer


def _pad_to_bucket(batch: PreparedBatch, bucket: int, pad_id: int) -> PreparedBatch:
    """Pad the sequence length to the next multiple of `bucket`, so a run
    meets a bounded number of sequence lengths."""
    B, L = batch.input_ids.shape
    target = ((L + bucket - 1) // bucket) * bucket
    if target == L:
        return batch
    padl = target - L

    def pad2(a, fill):
        return np.pad(a, ((0, 0), (0, padl)), constant_values=fill)

    return dataclasses.replace(
        batch,
        input_ids=pad2(batch.input_ids, pad_id),
        targets=pad2(batch.targets, IGNORE),
        slot_mask={m: pad2(v, False) for m, v in batch.slot_mask.items()},
        slot_index={m: pad2(v, 0) for m, v in batch.slot_index.items()},
    )


@registry.register_runner("runner_base")
class RunnerBase:
    def __init__(self, cfg, task, model: Spider, datasets, job_id: str):
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
        self.optimizer = build_optimizer(
            self.schedule,
            params=model.trainable_params(),
            weight_decay=float(run.get("weight_decay", 0.0)),
            max_grad_norm=float(run.get("max_grad_norm", 1.0)),
            grad_accum_steps=int(run.get("accum_grad_iters", 1)),
            num_frozen_embed_rows=int(run.get("num_frozen_embed_rows", 0)),
            trainable_patterns=tuple(trainable_patterns) if trainable_patterns else None,
        )
        # What the optimizer does not hold never moves: take it out of
        # autograd too, so its gradient is neither computed nor stored.
        for name, p in model.trainable_params().items():
            if name not in self.optimizer.params:
                p.requires_grad_(False)
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
        """The step's forward: samples -> Spider.compute_loss's dict, with
        the batch padded to the length bucket."""
        spider = self.model
        task = samples.get("TaskPrompt", ["[TEXT]"])[0][1:-1]
        batch = spider.prepare_batch(samples)
        batch = _pad_to_bucket(batch, self.length_bucket, spider.tokenizer.pad_token_id)
        modality_embeds = spider.encode_modalities(batch)
        cond = None
        if task in ("IMAGE", "VIDEO", "AUDIO") \
                and task in spider.diffusion_pipes and "Caption" in samples:
            cond = spider.diffusion_pipes[task](prompt=samples["Caption"],
                                                return_prompts_only=True)
        aux = spider.mask_arrays(samples) if task == "MASK" else None
        if task == "MASK" and aux is None:
            task = "TEXT"       # no SAM: MASK trains the text loss only
        return spider.compute_loss(batch, modality_embeds, cond, task, aux)

    def train_step(self, samples: Dict[str, Any]) -> Dict[str, float]:
        self.model.train()
        out = self.loss_dict(samples)
        backward_and_step(out["loss"], self.optimizer)
        self.global_step += 1
        return {k: float(v.detach()) for k, v in out.items()}

    # -------------------------------------------------------------- epochs
    def train_epoch(self, epoch: int) -> Dict[str, str]:
        metric_logger = MetricLogger(delimiter="  ")
        metric_logger.add_meter("lr", SmoothedValue(window_size=1, fmt="{value:.6f}"))
        loader = self.dataloaders["train"]
        header = f"Train: data epoch: [{epoch}]"
        metrics_path = os.path.join(self.output_dir, "metrics.jsonl")
        with open(metrics_path, "a") as mf:
            for _ in metric_logger.log_every(range(self.iters_per_epoch), self.log_freq,
                                             header):
                metrics = self.train_step(next(loader))
                lr = float(self.schedule(self.global_step))
                metric_logger.update(**metrics)
                metric_logger.update(lr=lr)
                # per-iteration scalar stream
                mf.write(json.dumps({"step": self.global_step, "epoch": epoch, "lr": lr,
                                     **metrics}) + "\n")
        return {k: f"{m.global_avg:.3f}" for k, m in metric_logger.meters.items()}

    def eval_epoch(self, split: str = "val", max_batches: int = 8):
        if split not in self.dataloaders:
            return None
        self.model.eval()
        return self.task.evaluation(self.model, self.dataloaders[split], max_batches)

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
        return {n: p.detach() for n, p in self.optimizer.params.items()}

    def save_checkpoint_best(self, epoch: int) -> str:
        path = self._ckpt_path("best")
        torch.save(dict(params=self._params_state(), epoch=epoch), path)
        return path

    def save_checkpoint(self, epoch: int) -> str:
        path = self._ckpt_path(str(epoch))
        torch.save(dict(params=self._params_state(),
                        opt_state=self.optimizer.state_dict(),
                        step=self.global_step, epoch=epoch), path)
        logging.info("Saved checkpoint to %s", path)
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
                params[n].copy_(t)
        self.optimizer.load_state_dict(state["opt_state"])
        self.global_step = int(state["step"])
        self.start_epoch = int(state["epoch"]) + 1
        logging.info("Resumed from %s (epoch %d)", path, self.start_epoch)

    # ----------------------------------------------------------------- misc
    def model_forward(self, samples):
        return self.model.forward(samples)

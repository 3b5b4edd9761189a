"""Native training for dense FCNN models on one device.

Port of the single-device half of :mod:`tpu_dist_nn.train.trainer`: the
reference's recipe (Adam lr 1e-3, cross-entropy, batch 64,
``generate_mnist_pytorch.py:37-52``) as an eager PyTorch loop with the
optax-matched optimizer of :mod:`tpu_dist_nn_torch.train.optimizers`.

The step is plain autograd over ``torch.matmul`` (the JAX package
computes these products with ``jnp``, outside any Pallas kernel); the
chain kernel, which has no backward, runs only in :func:`evaluate_fcnn`
on the card. Epoch-level checkpoints and resume go through
:mod:`tpu_dist_nn_torch.checkpoint`.

The pipelined trainer is :mod:`tpu_dist_nn_torch.train.pipeline_trainer`.
Left for later slices: the data-parallel ``mesh`` step (a single-stage
data-parallel placement collapses to one device in the port's Engine)
and conv-network training (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from tpu_dist_nn_torch.checkpoint.store import flush, resume_or_init
from tpu_dist_nn_torch.core.schema import ModelSpec, save_model
from tpu_dist_nn_torch.data.datasets import Dataset
from tpu_dist_nn_torch.data.feed import batch_iterator
from tpu_dist_nn_torch.models.fcnn import forward_logits, spec_from_params
from tpu_dist_nn_torch.models.network import dense_forward
from tpu_dist_nn_torch.obs.registry import REGISTRY
from tpu_dist_nn_torch.obs.trace import TRACER
from tpu_dist_nn_torch.train.metrics import classification_metrics
from tpu_dist_nn_torch.train.optimizers import Optimizer, apply_updates, build_optimizer
from tpu_dist_nn_torch.utils.errors import check_full_batch

# Trainer metric families (the JAX package's names), updated at epoch
# boundaries only: the step loop itself stays untouched.
_EPOCH_SECONDS = REGISTRY.histogram(
    "tdn_train_epoch_seconds", "wall time per training epoch",
    buckets=(0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0, 1800.0),
)
_TRAIN_LOSS = REGISTRY.gauge(
    "tdn_train_loss", "latest recorded training loss", labels=("trainer",),
)
_TRAIN_STEPS = REGISTRY.counter(
    "tdn_train_steps_total", "optimizer steps completed", labels=("trainer",),
)
_CHECKPOINT_SAVES = REGISTRY.counter(
    "tdn_checkpoint_saves_total", "checkpoint save events", labels=("trainer",),
)


@dataclasses.dataclass
class TrainConfig:
    """Reference training recipe defaults (generate_mnist_pytorch.py:12,37-38)."""

    learning_rate: float = 1e-3
    epochs: int = 5
    batch_size: int = 64
    seed: int = 0
    clip_norm: float | None = None
    warmup_steps: int = 0
    lr_schedule: str = "constant"
    weight_decay: float = 0.0
    grad_accum: int = 1


def optimizer_for(config: TrainConfig, train_data: Dataset) -> Optimizer:
    """The configured optimizer; the cosine horizon is the run's step
    count (epochs x full batches an epoch)."""
    steps_per_epoch = max(1, len(train_data) // config.batch_size)
    return build_optimizer(
        config.learning_rate,
        schedule=config.lr_schedule,
        warmup_steps=config.warmup_steps,
        total_steps=steps_per_epoch * config.epochs,
        clip_norm=config.clip_norm,
        weight_decay=config.weight_decay,
        grad_accum=config.grad_accum,
    )


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy from raw logits (sparse labels)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels[:, None].long())[:, 0].mean()


def _split_params(params):
    """Trainable ``{w, b}`` copies (leaves that require grad) and the
    activation ids, which the optimizer never touches."""
    wb = [{"w": p["w"].detach().clone().requires_grad_(True),
           "b": p["b"].detach().clone().requires_grad_(True)} for p in params]
    return wb, [int(p["act"]) for p in params]


def _join_params(wb, acts):
    return [{"w": p["w"], "b": p["b"], "act": a} for p, a in zip(wb, acts)]


def _leaves(wb) -> list[torch.Tensor]:
    return [t for p in wb for t in (p["w"], p["b"])]


def make_train_step(acts, optimizer: Optimizer):
    """``step(wb, opt_state, x, y) -> (wb, opt_state, loss)``: forward,
    autograd backward, optimizer update applied in place; ``loss`` is a
    detached scalar tensor (reading it synchronises)."""

    def step(wb, opt_state, x, y):
        leaves = _leaves(wb)
        loss = cross_entropy(forward_logits(_join_params(wb, acts), x), y)
        grads = torch.autograd.grad(loss, leaves)
        updates = optimizer.update(grads, opt_state, leaves)
        if updates is not None:
            apply_updates(leaves, updates)
        return wb, opt_state, loss.detach()

    return step


def run_training_loop(step, params, opt_state, train_data: Dataset, config: TrainConfig,
                      eval_fn=None, checkpoints=None):
    """The epoch/batch loop: shuffled full batches (seed ``config.seed +
    epoch``), one history record per epoch (mean loss, wall seconds of
    the steps, and ``eval`` when ``eval_fn`` is given), epoch spans on
    the tracer, and per-epoch checkpoints when ``checkpoints`` is given.
    The latest checkpoint, if any, is restored into the caller's
    ``(params, opt_state)`` template first, and training continues from
    the next epoch (checkpoint step k = k completed epochs)."""
    check_full_batch(len(train_data), config.batch_size)
    history = []
    start_epoch, state = resume_or_init(checkpoints, {"params": params, "opt_state": opt_state})
    params, opt_state = state["params"], state["opt_state"]
    device = _leaves(params)[0].device
    # One trace per run: epoch spans are recorded at the epoch boundary,
    # after the loss read already synchronised.
    run_span = TRACER.start("train.classifier", attrs={"epochs": config.epochs})
    try:
        for epoch in range(start_epoch, config.epochs):
            t0 = time.monotonic()
            losses = []
            for bx, by in batch_iterator(train_data.x, train_data.y, config.batch_size,
                                         shuffle=True, seed=config.seed + epoch,
                                         drop_remainder=True):
                x = torch.as_tensor(bx, dtype=torch.float32, device=device)
                y = torch.as_tensor(by, dtype=torch.long, device=device)
                params, opt_state, loss = step(params, opt_state, x, y)
                losses.append(loss)
            record = {
                "epoch": epoch,
                "loss": float(torch.stack(losses).mean()),
                "seconds": time.monotonic() - t0,
            }
            if run_span.sampled:
                TRACER.record_span("epoch", run_span.ctx, t0, record["seconds"],
                                   attrs={"epoch": epoch, "loss": record["loss"]})
            _EPOCH_SECONDS.observe(record["seconds"])
            _TRAIN_LOSS.labels(trainer="classifier").set(record["loss"])
            _TRAIN_STEPS.labels(trainer="classifier").inc(len(losses))
            if eval_fn is not None:
                record["eval"] = eval_fn(params)
            history.append(record)
            if checkpoints is not None:
                checkpoints.save(epoch + 1, {"params": params, "opt_state": opt_state},
                                 metadata=record)
                _CHECKPOINT_SAVES.labels(trainer="classifier").inc()
    except BaseException:
        # Enqueued async saves become durable even when the loop raises.
        flush(checkpoints)
        raise
    else:
        flush(checkpoints)
    finally:
        run_span.end()
    return params, history


def train_fcnn(params, train_data: Dataset, config: TrainConfig = TrainConfig(),
               eval_data: Dataset | None = None, checkpoints=None):
    """Train dense params on their device; returns ``(params, history)``.
    The caller's tensors are not modified: the returned params are new
    contiguous float32 tensors (detached) with the same activation ids."""
    wb, acts = _split_params(params)
    optimizer = optimizer_for(config, train_data)
    opt_state = optimizer.init(_leaves(wb))
    step = make_train_step(acts, optimizer)
    eval_fn = None
    if eval_data is not None:
        eval_fn = lambda wb_: evaluate_fcnn(_join_params(wb_, acts), eval_data)  # noqa: E731
    wb, history = run_training_loop(step, wb, opt_state, train_data, config, eval_fn,
                                    checkpoints=checkpoints)
    return [{"w": p["w"].detach(), "b": p["b"].detach(), "act": a}
            for p, a in zip(wb, acts)], history


@torch.no_grad()
def evaluate_fcnn(params, data: Dataset, batch_size: int = 1024) -> dict:
    """Full classification metrics over a dataset, in batches of
    ``batch_size`` through :func:`dense_forward`: the chain kernel on
    the card, its plain version on the CPU."""
    params = [{"w": p["w"].detach(), "b": p["b"].detach(), "act": int(p["act"])}
              for p in params]
    device = params[0]["w"].device
    preds = []
    for bx in batch_iterator(data.x, batch_size=batch_size):
        x = torch.as_tensor(bx, dtype=torch.float32, device=device)
        preds.append(dense_forward(params, x).argmax(-1).cpu().numpy())
    return classification_metrics(np.concatenate(preds), data.y, data.num_classes)


def export_model(params, activations, path, metrics: dict | None = None,
                 extra_metadata: dict | None = None) -> ModelSpec:
    """Export trained params to the public JSON schema, embedding eval
    metrics under ``inference_metrics`` (notebook cell 10 parity)."""
    metadata = dict(extra_metadata or {})
    if metrics is not None:
        metadata["inference_metrics"] = metrics
    spec = spec_from_params(params, activations, metadata)
    save_model(spec, path)
    return spec

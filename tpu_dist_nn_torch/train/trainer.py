"""Native training for dense FCNN and mixed-layer (conv) networks on one
device.

Port of the single-device half of :mod:`tpu_dist_nn.train.trainer`: the
reference's recipe (Adam lr 1e-3, cross-entropy, batch 64,
``generate_mnist_pytorch.py:37-52``) as an eager PyTorch loop with the
optax-matched optimizer of :mod:`tpu_dist_nn_torch.train.optimizers`:
:func:`train_fcnn` for dense params, :func:`train_network` for a
network's layer plan (conv / pool / dense).

The step is plain autograd: ``torch.matmul`` for a dense model, and
:func:`~tpu_dist_nn_torch.models.network.network_logits` (``F.conv2d``,
``F.max_pool2d``, matmuls) for a network, as the JAX package computes
these ops outside any Pallas kernel. A network step's convs run under
cuDNN's deterministic algorithms with TF32 off (:func:`conv_flags`):
float32 products as the dense step's, and a captured step equal to the
eager one. The kernels, which have no backward, run in
:func:`evaluate_fcnn` and :func:`evaluate_network` on the card. On a
card the step runs as a captured CUDA graph, replayed each step over
static batch buffers (:mod:`~tpu_dist_nn_torch.train.graphs`: the
counterpart of the JAX package's ``jax.jit`` of the step); on the CPU it
runs eagerly. Epoch-level checkpoints and resume go through
:mod:`tpu_dist_nn_torch.checkpoint`.

With a ``mesh`` (a data-parallel placement's data slots) the dense
step splits each batch's rows over the data slots: each slot computes
its rows' loss on its own stream from its own view of the params (a
peer copy on another card), one backward gives every slot's gradients,
and they are summed on the params in slot order before the one update
(:func:`make_train_step`). The pipelined trainers are
:mod:`tpu_dist_nn_torch.train.pipeline_trainer` (dense) and
:mod:`tpu_dist_nn_torch.train.hetero_trainer` (conv).
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from tpu_dist_nn_torch.checkpoint.store import flush, resume_or_init
from tpu_dist_nn_torch.core.schema import ModelSpec, save_model
from tpu_dist_nn_torch.data.datasets import Dataset
from tpu_dist_nn_torch.data.feed import batch_iterator
from tpu_dist_nn_torch.models.fcnn import forward_logits, spec_from_params
from tpu_dist_nn_torch.models.network import dense_forward, network_forward, network_logits
from tpu_dist_nn_torch.obs.registry import REGISTRY
from tpu_dist_nn_torch.obs.trace import TRACER
from tpu_dist_nn_torch.parallel.collectives import fork, join, on_slot, psum, take
from tpu_dist_nn_torch.parallel.mesh import AXIS_DATA
from tpu_dist_nn_torch.train.metrics import classification_metrics
from tpu_dist_nn_torch.train.optimizers import Optimizer, apply_updates, build_optimizer
from tpu_dist_nn_torch.utils.errors import check_full_batch

log = logging.getLogger("tpu_dist_nn_torch.train")

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


def _leaves(params) -> list[torch.Tensor]:
    """The trainable tensors of ``params`` in order: ``w`` then ``b`` of
    each layer (a pool's ``{}`` has none); nested lists (a pipeline's
    stages) flatten in order."""
    out = []
    for p in params:
        if isinstance(p, (list, tuple)):
            out += _leaves(p)
        elif p:
            out += [p["w"], p["b"]]
    return out


def _trainable(params) -> list:
    """Copies of a network's (or a stage list's) ``{"w", "b"}`` / ``{}``
    params whose tensors require grad; the caller's stay as they are."""
    return [_trainable(p) if isinstance(p, (list, tuple)) else
            {k: p[k].detach().clone().requires_grad_(True) for k in ("w", "b")} if p else {}
            for p in params]


def _detached(params) -> list:
    return [_detached(p) if isinstance(p, (list, tuple)) else
            {k: p[k].detach() for k in ("w", "b")} if p else {} for p in params]


def conv_flags():
    """Where a network step runs: cuDNN's deterministic algorithms with
    TF32 off and no autotuning, so its float32 convs are FP32 products
    and a graph captured from the step replays what the eager step
    computes. Set around the step, not for the process."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                      allow_tf32=False)


def make_train_step(acts, optimizer: Optimizer, mesh=None):
    """``step(wb, opt_state, x, y) -> (wb, opt_state, loss)``: forward,
    autograd backward, optimizer update applied in place; ``loss`` is a
    detached scalar tensor (reading it synchronises). This is the eager
    step; :func:`run_training_loop` captures it on a card.
    ``micro_step``: see :meth:`Optimizer.update`.

    With ``mesh`` (data slots): the rows split evenly over the data
    slots, each slot's loss on its stream from its own view of the
    leaves, the loss the mean of theirs, and each leaf's gradient the
    sum of the slots' in slot order on the caller's stream (the JAX
    step's all-reduce); one update. The step carries ``mesh``."""

    def loss_of(wb, x, y):
        return cross_entropy(forward_logits(_join_params(wb, acts), x), y)

    if mesh is None:
        def step(wb, opt_state, x, y, *, micro_step=None):
            leaves = _leaves(wb)
            loss = loss_of(wb, x, y)
            grads = torch.autograd.grad(loss, leaves)
            updates = optimizer.update(grads, opt_state, leaves, micro_step=micro_step)
            if updates is not None:
                apply_updates(leaves, updates)
            return wb, opt_state, loss.detach()

        return step
    slots = list(mesh.slots[0])  # each data replica's lead
    n = len(slots)

    def step(wb, opt_state, x, y, *, micro_step=None):
        leaves = _leaves(wb)
        caller = fork(slots)
        views, losses = [], []
        for slot, xd, yd in zip(slots, x.chunk(n), y.chunk(n)):
            with on_slot(slot):
                mine = [take(slot, t.detach()).requires_grad_(True) for t in leaves]
                views.append(mine)
                wb_d = [{"w": mine[2 * i], "b": mine[2 * i + 1]} for i in range(len(wb))]
                losses.append(loss_of(wb_d, take(slot, xd), take(slot, yd)))
        with on_slot(slots[0]):
            loss = psum(losses, slots) / n
        grads = torch.autograd.grad(loss, [t for mine in views for t in mine])
        join(caller, slots)
        L = len(leaves)
        summed = []
        for i, leaf in enumerate(leaves):
            total = grads[i].to(leaf.device)
            for d in range(1, n):
                total = total + grads[d * L + i].to(leaf.device)
            summed.append(total)
        updates = optimizer.update(summed, opt_state, leaves, micro_step=micro_step)
        if updates is not None:
            apply_updates(leaves, updates)
        return wb, opt_state, loss.detach()

    step.mesh = mesh
    return step


def make_network_train_step(plan, optimizer: Optimizer):
    """The mixed-layer network's step (JAX ``make_network_train_step``):
    ``step(params, opt_state, x, y) -> (params, opt_state, loss)`` with
    ``params`` the plan's ``{"w", "b"}`` / ``{}`` list of leaves that
    require grad; cross-entropy of :func:`network_logits`, autograd,
    the update applied in place, under :func:`conv_flags`."""

    def step(params, opt_state, x, y, *, micro_step=None):
        leaves = _leaves(params)
        with conv_flags():
            loss = cross_entropy(network_logits(plan, params, x), y)
            grads = torch.autograd.grad(loss, leaves)
        updates = optimizer.update(grads, opt_state, leaves, micro_step=micro_step)
        if updates is not None:
            apply_updates(leaves, updates)
        return params, opt_state, loss.detach()

    return step


def compile_train_step(step, params, opt_state, optimizer: Optimizer, batch_size: int,
                       in_dim: int):
    """``step`` over ``(batch_size, in_dim)`` float32 rows and int64
    labels as a :class:`~tpu_dist_nn_torch.train.graphs.CompiledStep`
    on the leaves' card: ``compiled(bx, by) -> loss``, the host batch
    copied into static buffers, one replay a step. ``params`` is any
    tree :func:`_leaves` reads (dense ``{w, b}`` layers, a network's
    plan list, a pipeline's stage lists) with every leaf on one card."""
    from tpu_dist_nn_torch.train.graphs import CompiledStep

    like = [((batch_size, in_dim), torch.float32), ((batch_size,), torch.int64)]
    return CompiledStep(step, (params, opt_state), like, optimizer, opt_state,
                        _leaves(params)[0].device)


def run_training_loop(step, params, opt_state, train_data: Dataset, config: TrainConfig,
                      eval_fn=None, checkpoints=None, optimizer: Optimizer | None = None):
    """The epoch/batch loop: shuffled full batches (seed ``config.seed +
    epoch``), one history record per epoch (mean loss, wall seconds of
    the steps, and ``eval`` when ``eval_fn`` is given), epoch spans on
    the tracer, and per-epoch checkpoints when ``checkpoints`` is given.
    The latest checkpoint, if any, is restored into the caller's
    ``(params, opt_state)`` template first, and training continues from
    the next epoch (checkpoint step k = k completed epochs). With every
    leaf on one card, ``step`` (built with ``optimizer``) runs as a
    captured graph (:func:`compile_train_step`); on the CPU, or with
    leaves or a step's ``mesh`` slots on several cards, it is called as
    it is."""
    check_full_batch(len(train_data), config.batch_size)
    history = []
    start_epoch, state = resume_or_init(checkpoints, {"params": params, "opt_state": opt_state})
    params, opt_state = state["params"], state["opt_state"]
    devices = {t.device for t in _leaves(params)}
    device = _leaves(params)[0].device
    compiled = None
    slots = getattr(step, "mesh", None)
    if device.type == "cuda" and len(devices) == 1 and (slots is None
                                                        or slots.devices == {device}):
        if optimizer is None:
            raise ValueError("a step on the card is captured: pass its optimizer")
        compiled = compile_train_step(step, params, opt_state, optimizer, config.batch_size,
                                      train_data.x.shape[1])
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
                if compiled is not None:
                    # the graph's loss is overwritten by the next replay
                    losses.append(compiled(bx, by).clone())
                    continue
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
               eval_data: Dataset | None = None, checkpoints=None, mesh=None):
    """Train dense params on their device; returns ``(params, history)``.
    The caller's tensors are not modified: the returned params are new
    contiguous float32 tensors (detached) with the same activation ids.

    With ``mesh`` (a data-parallel placement's data slots) each batch's
    rows split over the data slots (:func:`make_train_step`): the same
    gradients, the mean over the batch being row-partition-invariant,
    computed on every slot. A batch size the data axis does not divide
    trains on one device, with a warning."""
    wb, acts = _split_params(params)
    optimizer = optimizer_for(config, train_data)
    opt_state = optimizer.init(_leaves(wb))
    data_size = 1 if mesh is None else mesh.shape.get(AXIS_DATA, 1)
    if mesh is not None and data_size > 1:
        if config.batch_size % data_size:
            # A silent downgrade from data-parallel to single-device
            # training must be visible in library use.
            log.warning(
                "train: batch_size %d not divisible by data axis %d; "
                "training single-device", config.batch_size, data_size,
            )
            step = make_train_step(acts, optimizer)
        else:
            step = make_train_step(acts, optimizer, mesh=mesh)
    else:
        step = make_train_step(acts, optimizer)
    eval_fn = None
    if eval_data is not None:
        eval_fn = lambda wb_: evaluate_fcnn(_join_params(wb_, acts), eval_data)  # noqa: E731
    wb, history = run_training_loop(step, wb, opt_state, train_data, config, eval_fn,
                                    checkpoints=checkpoints, optimizer=optimizer)
    return [{"w": p["w"].detach(), "b": p["b"].detach(), "act": a}
            for p, a in zip(wb, acts)], history


def train_network(plan, params, train_data: Dataset, config: TrainConfig = TrainConfig(),
                  eval_data: Dataset | None = None, checkpoints=None):
    """Train a mixed-layer network (JAX ``train_network``); returns
    ``(params, history)``: new detached tensors in the plan's ``{"w",
    "b"}`` / ``{}`` layout, the caller's left as they are."""
    params = _trainable(params)
    optimizer = optimizer_for(config, train_data)
    opt_state = optimizer.init(_leaves(params))
    step = make_network_train_step(plan, optimizer)
    eval_fn = None
    if eval_data is not None:
        eval_fn = lambda p: evaluate_network(plan, p, eval_data)  # noqa: E731
    params, history = run_training_loop(step, params, opt_state, train_data, config, eval_fn,
                                        checkpoints=checkpoints, optimizer=optimizer)
    return _detached(params), history


@torch.no_grad()
def evaluate_network(plan, params, data: Dataset, batch_size: int = 1024) -> dict:
    """Classification metrics over a dataset through
    :func:`~tpu_dist_nn_torch.models.network.network_forward`: the conv
    and chain kernels on the card, their plain versions on the CPU."""
    params = _detached(params)
    device = _leaves(params)[0].device
    preds = []
    for bx in batch_iterator(data.x, batch_size=batch_size):
        x = torch.as_tensor(bx, dtype=torch.float32, device=device)
        preds.append(network_forward(plan, params, x).argmax(-1).cpu().numpy())
    return classification_metrics(np.concatenate(preds), data.y, data.num_classes)


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

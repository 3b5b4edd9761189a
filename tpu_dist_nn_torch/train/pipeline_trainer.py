"""Training through the layer-distribution pipeline.

Port of :mod:`tpu_dist_nn.train.pipeline_trainer`:
:func:`prepare_pipeline_batch`, :func:`make_pipeline_train_step`,
:func:`train_pipelined` and :func:`evaluate_pipelined`, on the FCNN trainer's
optimizer (:func:`~tpu_dist_nn_torch.train.trainer.optimizer_for`),
batch iterator and checkpoint store.

The leaves are per-slot tensors of the real layers only
(:func:`place_leaves`): the JAX package masks the identity filler and
padding out of its padded gradients and updates (``grad_masks``); here
they are not leaves, so nothing outside a real block can train. A step
plays the schedule's op order with eager autograd
(:func:`~tpu_dist_nn_torch.parallel.one_f_one_b.run_schedule`), then
one optimizer update. The kernels have no backward, so training runs
``torch.matmul``; evaluation runs the pipelined forward, through the
chain kernel on a card.

``data > 1``: each data replica holds its own copy of the leaves on its
slot column and takes its share of every microbatch's rows, in the data
axis order. The replicas' gradients are summed in replica order into
replica 0's, which takes the update; the others copy its weights, so
the replicas stay identical.

Checkpoints hold the padded layout, ``{"weights": {"w", "b"},
"opt_state": {...}}`` with Adam's moments padded the same way (zeros
outside the real blocks), so a resume and an ``extract_model`` of a
checkpoint read the same blocks. Multi-process training (the JAX
``jax.process_count() > 1`` branches) is not ported.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpu_dist_nn_torch.checkpoint.store import flush, resume_or_init
from tpu_dist_nn_torch.data.datasets import Dataset
from tpu_dist_nn_torch.data.feed import batch_iterator
from tpu_dist_nn_torch.models.fcnn import forward as fcnn_forward
from tpu_dist_nn_torch.parallel.mesh import AXIS_DATA, Mesh
from tpu_dist_nn_torch.parallel.one_f_one_b import run_schedule, training_order, validate_schedule
from tpu_dist_nn_torch.parallel.pipeline import (
    PipelineMeta,
    PipelineParams,
    PipelineWeights,
    PlacedPipeline,
    check_chunk_count,
    pad_batch,
    pad_blocks,
    place_pipeline,
    run_placed,
)
from tpu_dist_nn_torch.train.metrics import classification_metrics
from tpu_dist_nn_torch.train.optimizers import OptState, apply_updates
from tpu_dist_nn_torch.train.trainer import TrainConfig, optimizer_for
from tpu_dist_nn_torch.utils.errors import check_full_batch


def prepare_pipeline_batch(meta: PipelineMeta, x, y, num_microbatches: int, data_size: int,
                           dtype=np.float32):
    """Pad a host batch for the pipeline (the geometry of
    :func:`~tpu_dist_nn_torch.parallel.pipeline.pad_batch`). Returns
    numpy ``(xs, labels, label_mask)``: ``xs (M, B, D)``, labels and mask
    ``(M, B)``; padded rows carry label 0 and mask 0."""
    xs, n = pad_batch(meta, x, num_microbatches, data_size, dtype)
    m, bsz = xs.shape[0], xs.shape[1]
    labels = np.pad(np.asarray(y, dtype=np.int32), (0, m * bsz - n)).reshape(m, bsz)
    mask = np.pad(np.ones(n, np.float32), (0, m * bsz - n)).reshape(m, bsz)
    return xs, labels, mask


def place_leaves(mesh: Mesh, params: PipelineParams, num_virtual: int = 1) -> PlacedPipeline:
    """The trainable placement: every replica's real layers on its
    slots with the logits activations, ``w`` and ``b`` leaves that
    require grad."""
    placed = place_pipeline(mesh, params, num_virtual=num_virtual, logits=True)
    for row in placed.chunks:
        for layers in row:
            for layer in layers:
                layer["w"].requires_grad_(True)
                layer["b"].requires_grad_(True)
    return placed


def _leaves(placed: PlacedPipeline, d: int = 0) -> list[torch.Tensor]:
    """Replica ``d``'s leaves, chunk by chunk and layer by layer, ``w``
    before ``b``: the optimizer's order."""
    return [layer[k] for layers in placed.chunks[d] for layer in layers for k in ("w", "b")]


def _unflatten(meta: PipelineMeta, flat) -> list[list[dict]]:
    """A list in :func:`_leaves` order -> ``chunks[c][li] = {"w", "b"}``."""
    it = iter(flat)
    return [[{"w": next(it), "b": next(it)} for _ in range(meta.num_layers(c))]
            for c in range(meta.num_stages)]


def serving_view(placed: PlacedPipeline) -> PlacedPipeline:
    """The trained leaves (detached, shared storage) with the serving
    activations: what evaluation runs."""
    acts = placed.meta.act_array(False)
    chunks = [[[{"w": layer["w"].detach(), "b": layer["b"].detach(), "act": int(acts[c, li])}
                for li, layer in enumerate(layers)] for c, layers in enumerate(row)]
              for row in placed.chunks]
    return PlacedPipeline(placed.mesh, placed.meta, chunks, placed.num_virtual)


def _feed(placed: PlacedPipeline, xs, labels, mask):
    """Host arrays -> per (microbatch, replica) tensors: rows on the
    replica's first slot, labels and the mask (divided by the global
    row count) on the slot of its last chunk; one copy of each a
    replica."""
    mesh, meta = placed.mesh, placed.meta
    S, D = mesh.spec.stage, mesh.spec.data
    b = xs.shape[1] // D
    mask = np.asarray(mask, np.float32)
    mask = mask / mask.sum()
    last = (meta.num_stages - 1) % S
    cols = [[None] * D for _ in range(3)]
    for d in range(D):
        rows = slice(d * b, (d + 1) * b)
        first, tail = mesh.slots[0][d].device, mesh.slots[last][d].device
        cols[0][d] = torch.tensor(np.asarray(xs)[:, rows, :meta.in_dim], device=first)
        cols[1][d] = torch.tensor(np.asarray(labels)[:, rows], dtype=torch.int64, device=tail)
        cols[2][d] = torch.tensor(mask[:, rows], device=tail)
    return tuple([[col[d][m] for d in range(D)] for m in range(xs.shape[0])] for col in cols)


def _loss_and_grads(placed: PlacedPipeline, order, xs, labels, mask):
    """Play ``order`` on one padded batch: ``(loss, grads)`` with the
    loss a scalar tensor on replica 0's first device and ``grads`` the
    replicas' gradients summed in replica order, in :func:`_leaves`
    order. The leaves' ``.grad`` is cleared."""
    losses = run_schedule(placed.mesh, placed.chunk_fns(fcnn_forward), order,
                          *_feed(placed, xs, labels, mask))
    dev = placed.device
    loss = torch.stack([l.to(dev) for l, _ in losses]).sum()
    grads = None
    for d in range(placed.mesh.spec.data):
        leaves = _leaves(placed, d)
        g_d = [p.grad for p in leaves]
        grads = g_d if grads is None else [a + g.to(a.device) for a, g in zip(grads, g_d)]
        for p in leaves:
            p.grad = None
    return loss, grads


def make_pipeline_train_step(mesh: Mesh, meta: PipelineMeta, num_microbatches: int, optimizer,
                             dtype=torch.float32, schedule: str = "gpipe",
                             num_virtual: int = 1):
    """``step(placed, opt_state, xs, labels, mask) -> (placed, opt_state,
    loss)`` for one padded batch (:func:`prepare_pipeline_batch`):
    ``schedule`` "gpipe", "1f1b" or "interleaved" (``num_virtual`` >
    1 chunks a slot), then one optimizer update of the leaves in place.
    The three schedules compute the same loss and gradients."""
    validate_schedule(schedule)
    if schedule in ("zb", "zb-v", "zb-stash"):
        raise ValueError(
            "zero-bubble schedules are implemented for the "
            "transformer LM pipeline only (tdn lm --schedule zb); the "
            "dense classifier pipeline supports gpipe/1f1b/interleaved"
        )
    if num_virtual > 1 and schedule != "interleaved":
        raise ValueError(
            f"num_virtual={num_virtual} only applies to "
            "schedule='interleaved' (it would be silently ignored)"
        )
    S = mesh.spec.stage
    if schedule == "interleaved":
        check_chunk_count(meta.num_stages, S, num_virtual)
    elif meta.num_stages != S:
        raise ValueError(
            f"pipeline has {meta.num_stages} stages but the mesh 'stage' axis has size {S}")
    order = training_order(schedule, S, num_virtual, num_microbatches)

    def step(placed: PlacedPipeline, opt_state: OptState, xs, labels, mask):
        loss, grads = _loss_and_grads(placed, order, xs, labels, mask)
        leaves = _leaves(placed, 0)
        updates = optimizer.update(grads, opt_state, leaves)
        if updates is not None:
            apply_updates(leaves, updates)
            with torch.no_grad():
                for d in range(1, mesh.spec.data):
                    for dst, src in zip(_leaves(placed, d), leaves):
                        dst.copy_(src)
        return placed, opt_state, loss.detach()

    return step


def pipeline_loss_and_grad(mesh: Mesh, params: PipelineParams, xs, labels, mask, *,
                           schedule: str = "gpipe", num_microbatches: int,
                           num_virtual: int = 1) -> tuple[float, PipelineWeights]:
    """One schedule's loss and gradients at ``params`` on one padded
    batch, the gradients in the padded layout (zeros outside the real
    blocks): the counterpart of the JAX ``compiled_1f1b_grad`` /
    ``compiled_interleaved_dense_grad`` / GPipe ``value_and_grad``."""
    validate_schedule(schedule)
    placed = place_leaves(mesh, params, num_virtual)
    order = training_order(schedule, mesh.spec.stage, num_virtual, num_microbatches)
    loss, grads = _loss_and_grads(placed, order, xs, labels, mask)
    return float(loss), pad_blocks(params.meta, _unflatten(params.meta, grads), identity=False)


def _padded_state(placed: PlacedPipeline, opt_state: OptState) -> dict:
    """The checkpointed state in the padded layout (host numpy)."""
    meta = placed.meta

    def padded(flat, identity=False):
        w = pad_blocks(meta, _unflatten(meta, flat), identity=identity)
        return {"w": w.w, "b": w.b}

    return {
        "weights": padded(_leaves(placed, 0), identity=True),
        "opt_state": {
            "count": int(opt_state.count), "mini_step": int(opt_state.mini_step),
            "mu": padded(opt_state.mu), "nu": padded(opt_state.nu),
            "acc": None if opt_state.acc is None else padded(opt_state.acc),
        },
    }


def _load_state(placed: PlacedPipeline, opt_state: OptState, state: dict) -> None:
    """Pour a restored padded state into the leaves (every replica) and
    the optimizer state."""
    meta = placed.meta

    def blocks(tree):
        return [a for c in range(meta.num_stages) for li in range(meta.num_layers(c))
                for a in (tree["w"][c, li, :meta.in_width[c][li], :meta.width[c][li]],
                          tree["b"][c, li, :meta.width[c][li]])]

    with torch.no_grad():
        for d in range(placed.mesh.spec.data):
            for leaf, a in zip(_leaves(placed, d), blocks(state["weights"])):
                leaf.copy_(torch.from_numpy(np.ascontiguousarray(a)))
    ref = _leaves(placed, 0)

    def tensors(tree):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(p.device)
                for p, a in zip(ref, blocks(tree))]

    o = state["opt_state"]
    opt_state.count, opt_state.mini_step = int(o["count"]), int(o["mini_step"])
    opt_state.mu, opt_state.nu = tensors(o["mu"]), tensors(o["nu"])
    opt_state.acc = None if o["acc"] is None else tensors(o["acc"])


def train_pipelined(params: PipelineParams, mesh: Mesh, train_data: Dataset,
                    config: TrainConfig = TrainConfig(), *, num_microbatches: int = 4,
                    eval_data: Dataset | None = None, checkpoints=None,
                    schedule: str = "gpipe", num_virtual: int = 1):
    """Train pipelined weights over the slots; returns ``(params,
    history)`` with the trained padded params (numpy).

    Shuffled full batches (seed ``config.seed + epoch``), one history
    record per epoch (mean loss, seconds, and ``eval`` through the
    pipelined forward when ``eval_data`` is given), epoch-level
    checkpoints and resume with ``checkpoints``.
    ``schedule="interleaved"`` with ``num_virtual=v`` trains the
    virtual-stage placement (``meta`` of ``stage * v`` chunks)."""
    meta = params.meta
    data_size = mesh.shape[AXIS_DATA]
    optimizer = optimizer_for(config, train_data)
    placed = place_leaves(mesh, params, num_virtual)
    opt_state = optimizer.init(_leaves(placed, 0))
    step = make_pipeline_train_step(mesh, meta, num_microbatches, optimizer,
                                    schedule=schedule, num_virtual=num_virtual)
    check_full_batch(len(train_data), config.batch_size)
    start_epoch, state = resume_or_init(checkpoints, _padded_state(placed, opt_state))
    if start_epoch:
        _load_state(placed, opt_state, state)
    history = []
    try:
        for epoch in range(start_epoch, config.epochs):
            t0 = time.monotonic()
            losses = []
            for bx, by in batch_iterator(train_data.x, train_data.y, config.batch_size,
                                         shuffle=True, seed=config.seed + epoch,
                                         drop_remainder=True):
                xs, labels, mask = prepare_pipeline_batch(meta, bx, by, num_microbatches,
                                                          data_size)
                placed, opt_state, loss = step(placed, opt_state, xs, labels, mask)
                losses.append(loss)
            record = {
                "epoch": epoch,
                "loss": float(torch.stack(losses).mean()),
                "seconds": time.monotonic() - t0,
            }
            if eval_data is not None:
                record["eval"] = _evaluate(serving_view(placed), eval_data, num_microbatches)
            history.append(record)
            if checkpoints is not None:
                checkpoints.save(epoch + 1, _padded_state(placed, opt_state), metadata=record)
    except BaseException:
        # Enqueued async saves become durable even when the loop raises.
        flush(checkpoints)
        raise
    else:
        flush(checkpoints)
    weights = pad_blocks(meta, placed.chunks[0])
    return PipelineParams(weights, meta), history


@torch.no_grad()
def _evaluate(placed: PlacedPipeline, data: Dataset, num_microbatches: int,
              batch_size: int = 1024) -> dict:
    preds = []
    for bx in batch_iterator(data.x, batch_size=batch_size):
        x = torch.as_tensor(np.asarray(bx, np.float32), device=placed.device)
        preds.append(run_placed(placed, x, num_microbatches).argmax(-1).cpu().numpy())
    return classification_metrics(np.concatenate(preds), data.y, data.num_classes)


def evaluate_pipelined(params: PipelineParams, mesh: Mesh, data: Dataset, *,
                       num_microbatches: int = 1, batch_size: int = 1024,
                       num_virtual: int = 1) -> dict:
    """Classification metrics of the pipelined forward over ``data``, in
    batches of ``batch_size``."""
    return _evaluate(place_pipeline(mesh, params, num_virtual=num_virtual), data,
                     num_microbatches, batch_size)

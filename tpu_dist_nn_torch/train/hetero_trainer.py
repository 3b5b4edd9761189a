"""Training through the heterogeneous (conv / pool / dense) pipeline.

Port of the training half of :mod:`tpu_dist_nn.parallel.hetero_pipeline`:
:func:`make_hetero_train_step` and :func:`train_hetero`, over the stage
slots of a :class:`~tpu_dist_nn_torch.parallel.hetero_pipeline.HeteroPipeline`
and on the single-program trainer's loop, loss and optimizer
(:mod:`tpu_dist_nn_torch.train.trainer`).

A hand-played GPipe schedule with per-stage backward passes that
recompute the stage from its saved input (:func:`_stage_bwd`), so only
the stage-boundary activations live across the schedule; gradients
accumulate on each stage's slot, and one optimizer update takes every
stage's leaves (Adam is elementwise, so it equals JAX's per-stage
updates). Global-norm clipping spans the stages and runs on the device.
The whole step, its forward wave included, runs under
:func:`~tpu_dist_nn_torch.train.trainer.conv_flags`, as the single
program's step does: cuDNN's convs are FP32 products whatever the
process's flags. On one card the step is one captured CUDA graph: the
slot streams fork from the capturing stream and join it again, so each
stage keeps its stream and its hand-off events as graph edges. Slots on
several cards run the step eagerly, as the dense pipeline does: a graph
and its memory pool belong to one card.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_dist_nn_torch.models.network import network_forward_lax, network_logits
from tpu_dist_nn_torch.parallel.gpipe import caller_event, launch
from tpu_dist_nn_torch.parallel.hetero_pipeline import HeteroPipeline
from tpu_dist_nn_torch.train.metrics import classification_metrics
from tpu_dist_nn_torch.train.optimizers import apply_updates
from tpu_dist_nn_torch.train.trainer import (
    TrainConfig,
    _detached,
    _leaves,
    _trainable,
    conv_flags,
    cross_entropy,
    optimizer_for,
    run_training_loop,
)


def _stage_fwd(plan, params, x: torch.Tensor) -> torch.Tensor:
    """Training-time stage forward: :func:`network_forward_lax`, no
    graph kept (the backward recomputes it)."""
    with torch.no_grad():
        return network_forward_lax(plan, params, x)


def _grads(out, leaves, x_in, grad_out=None):
    """``(g_params, g_x)`` of ``out`` (a loss, or a stage output with
    cotangent ``grad_out``); ``g_x`` None for a stage input that needs
    no gradient (the first stage's rows)."""
    wrt = leaves + ([x_in] if x_in.requires_grad else [])
    grads = torch.autograd.grad(out, wrt, grad_out)
    return list(grads[:len(leaves)]), (grads[-1] if x_in.requires_grad else None)


def _stage_bwd(plan, params, x: torch.Tensor, g: torch.Tensor, *, need_dx: bool = True):
    """``(g_params, g_x)`` of a stage at its saved input ``x`` with output
    cotangent ``g``: the stage is recomputed with autograd from ``x``, so
    the schedule keeps only boundary activations."""
    with torch.enable_grad():
        x_in = x.detach().requires_grad_(need_dx)
        out = network_forward_lax(plan, params, x_in)
        return _grads(out, _leaves(params), x_in, g)


def _last_stage_loss_bwd(plan, params, x: torch.Tensor, y: torch.Tensor, *,
                         need_dx: bool = True):
    """``(loss, g_params, g_x)``: cross-entropy of the sub-chain's logits
    (final activation skipped, as ``train_network``)."""
    with torch.enable_grad():
        x_in = x.detach().requires_grad_(need_dx)
        loss = cross_entropy(network_logits(plan, params, x_in), y)
        gp, gx = _grads(loss, _leaves(params), x_in)
    return loss.detach(), gp, gx


def _add(acc, g):
    return g if acc is None else [a + b for a, b in zip(acc, g)]


def make_hetero_train_step(hp: HeteroPipeline, optimizer, num_microbatches: int,
                           clip_norm: float | None = None):
    """``step(params_list, opt_state, x, y) -> (params_list, opt_state,
    loss)``: the GPipe schedule over the stage slots (JAX
    ``make_hetero_train_step``). ``params_list[i]`` is stage ``i``'s
    ``{"w", "b"}`` / ``{}`` list with leaves that require grad on its
    slot's device; ``opt_state`` is ``optimizer.init`` of every stage's
    leaves in order (``optimizer`` clip-free: clipping is here).

    A forward wave (every microbatch through every stage, the stage
    inputs saved), then a backward wave (per microbatch from the last
    stage down, each stage's gradient summed on its slot), the mean over
    the equal microbatches, global-norm clipping across the stages
    computed on the device (``g * where(norm > clip, clip / norm, 1)``,
    exact where JAX does not clip), and one optimizer update in place.
    Everything runs under :func:`conv_flags`."""
    stages = hp.stages
    S = len(stages)
    M = num_microbatches

    def schedule(params_list, x, y):
        """Both waves: ``(per-stage summed gradients, microbatch losses)``."""
        mb = len(x) // M
        ready = caller_event(x)
        for stage in stages:  # fork: the slots start after the caller's work
            if stage.slot.stream is not None:
                stage.slot.stream.wait_stream(torch.cuda.current_stream(stage.slot.device))
        # Forward wave: the stage inputs (boundary activations) are the
        # only saved state; every call is issued before any is awaited.
        inputs = [[None] * S for _ in range(M)]
        for m in range(M):
            h, ev = x[m * mb:(m + 1) * mb], ready
            for i, stage in enumerate(stages):
                def fwd(t, i=i, stage=stage):
                    t = t.contiguous()
                    return t, (_stage_fwd(stage.plan, params_list[i], t) if i + 1 < S else None)

                (saved, h), ev = launch(stage.slot, fwd, h, ev)
                inputs[m][i] = saved
        # Backward wave: each microbatch's cotangent flows tail to head;
        # the gradients accumulate on each stage's slot.
        grads = [None] * S
        losses = []
        for m in range(M):
            def tail(ym, m=m):
                loss, gp, gx = _last_stage_loss_bwd(stages[-1].plan, params_list[-1],
                                                    inputs[m][-1], ym, need_dx=S > 1)
                grads[-1] = _add(grads[-1], gp)
                return gx, loss

            (gx, loss), ev = launch(stages[-1].slot, tail, y[m * mb:(m + 1) * mb], ready)
            losses.append(loss)
            for i in reversed(range(S - 1)):
                def bwd(g, i=i):
                    gp, gx_ = _stage_bwd(stages[i].plan, params_list[i], inputs[m][i], g,
                                         need_dx=i > 0)
                    grads[i] = _add(grads[i], gp)
                    return gx_

                gx, ev = launch(stages[i].slot, bwd, gx, ev)
        for stage in stages:  # join: the caller's stream waits for every slot
            if stage.slot.stream is not None:
                torch.cuda.current_stream(stage.slot.device).wait_stream(stage.slot.stream)
        return grads, losses

    def step(params_list, opt_state, x, y, *, micro_step=None):
        if len(x) % M:
            raise ValueError(
                f"batch of {len(x)} rows does not split into "
                f"{M} equal microbatches"
            )
        with conv_flags():
            grads, losses = schedule(params_list, x.to(hp.device),
                                     y.to(stages[-1].slot.device))
        flat = [g * (1.0 / M) for stage_grads in grads for g in stage_grads]
        if clip_norm is not None:
            # Global-norm clipping spans the stages (JAX's host-side
            # float norm, here on the device: a captured step reads no
            # host value). The optimizer is built clip-free.
            dev = flat[0].device
            norm = torch.sqrt(sum(torch.sum(g * g).to(dev) for g in flat))
            scale = torch.where(norm > clip_norm, clip_norm / norm, torch.ones_like(norm))
            flat = [g * scale.to(g.device) for g in flat]
        leaves = _leaves(params_list)
        updates = optimizer.update(flat, opt_state, leaves, micro_step=micro_step)
        if updates is not None:
            apply_updates(leaves, updates)
        dev = losses[0].device
        return params_list, opt_state, torch.stack([l.to(dev) for l in losses]).mean()

    return step


def train_hetero(hp: HeteroPipeline, train_data, config=None, eval_data=None,
                 checkpoints=None, num_microbatches: int = 2):
    """Train a heterogeneous (conv / pool / dense) model through its
    stage placement (JAX ``train_hetero``); returns ``(params_list,
    history)`` and installs the trained params into ``hp``. The loop,
    loss, shuffling and optimizer are
    :func:`~tpu_dist_nn_torch.train.trainer.train_network`'s: only where
    the compute runs differs. With every slot on one card the step is a
    captured CUDA graph."""
    config = config or TrainConfig()
    if config.clip_norm is not None and config.grad_accum > 1:
        raise ValueError(
            "clip_norm with grad_accum > 1 is not supported through the "
            "hetero pipeline (clipping would apply per micro-step, not "
            "to the accumulated gradient); drop one of the two or train "
            "with the single-program executor"
        )
    if config.batch_size % num_microbatches:
        raise ValueError(
            f"batch_size {config.batch_size} must be a multiple of "
            f"num_microbatches {num_microbatches}"
        )
    # Clipping spans the stages inside the step: the optimizer is
    # clip-free, or it would clip a second time.
    opt_config = (dataclasses.replace(config, clip_norm=None)
                  if config.clip_norm is not None else config)
    optimizer = optimizer_for(opt_config, train_data)
    params_list = _trainable(hp.stage_params())
    opt_state = optimizer.init(_leaves(params_list))
    step = make_hetero_train_step(hp, optimizer, num_microbatches, clip_norm=config.clip_norm)

    eval_fn = None
    if eval_data is not None:
        def eval_fn(params_list_):
            hp.set_stage_params(params_list_)
            preds = hp.forward(eval_data.x).argmax(-1)
            return classification_metrics(preds, eval_data.y, eval_data.num_classes)

    params_list, history = run_training_loop(step, params_list, opt_state, train_data, config,
                                             eval_fn, checkpoints=checkpoints,
                                             optimizer=optimizer)
    params_list = _detached(params_list)
    hp.set_stage_params(params_list)
    return params_list, history

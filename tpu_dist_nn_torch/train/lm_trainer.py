"""Language-model training: the byte-level Transformer, on one device or pipelined.

Port of :mod:`tpu_dist_nn.train.lm_trainer`'s single-chip and pipelined
trainers:
next-token cross-entropy, the optax-matched Adam of
:mod:`tpu_dist_nn_torch.train.optimizers`, one optimizer step per
batch. Attention defaults to
:func:`tpu_dist_nn_torch.kernels.flash_attention.default_attn_fn`: the
flash kernels on the card (training and evaluation alike), the
materialised reference on the CPU.

On a card :func:`train_lm` runs the step as a captured CUDA graph
(:mod:`~tpu_dist_nn_torch.train.graphs`), replayed each step over a
static token buffer: the counterpart of the JAX package's ``jax.jit`` of
the step. ``steps_per_call = K > 1`` is the JAX package's ``lax.scan``
superstep: K steps per host call and K losses read at most once, as K
replays with no host sync between them (on the card one graph of K
steps ran no faster than K replays of one). On the CPU the superstep
runs the K eager steps in one call.

Checkpoints (``train_lm(checkpoints=)``, the store of
:mod:`tpu_dist_nn_torch.checkpoint.store`) save and resume the params
and the Adam state at step granularity, as the JAX package's do.

The pipelined trainer (:func:`make_pipeline_lm_train_step`, and
:func:`train_lm` with a ``mesh`` and ``num_stages > 1``) runs the per-block
pipeline over stage slots (GPipe, 1F1B, interleaved, and the zero-bubble
zb, zb-v and zb-stash), optionally Megatron-sharded over the mesh's model
slots, with the batch over its data slots
(:mod:`~tpu_dist_nn_torch.parallel.transformer_pipeline`). Its step is a
Python loop of per-slot ops; when every slot is on the params' card,
:func:`train_lm` captures it as one CUDA graph as it does the single
program's (the slot streams fork from the capturing stream and join it
again inside the capture), and slots on several cards run it eager (a
graph and its memory pool belong to one card). Its params live in the
staged layout (:func:`lm_block_layout`), so a checkpoint records the
layout and a resume into another is refused.

The sequence-parallel trainers split each row over the mesh's seq slots
with ring or Ulysses attention (:mod:`~tpu_dist_nn_torch.parallel.
ring_attention`): :func:`make_seq_parallel_lm_train_step` on a ``(seq,
data)`` grid, :func:`make_pipeline_sp_lm_train_step` through the
pipeline (every schedule but zb-stash, Megatron-sharded with
``tensor_parallel``). Their rows are full (input + target) rows scored
by the masked CE, and sp keeps the dense and Megatron block layouts.
:func:`train_lm` runs them for a mesh with seq slots, captured when every
slot is on the params' card, and runs eager otherwise.

The mixture-of-experts trainers (a :class:`~tpu_dist_nn_torch.parallel.
expert_parallel.MoEConfig`; :mod:`~tpu_dist_nn_torch.parallel.
expert_parallel`) take the CE plus the weighted router loss:
:func:`make_moe_lm_train_step` on one program or with the experts over a
mesh's expert slots (the batch over ``(data, expert)``),
:func:`make_ep_tp_moe_lm_train_step` with each expert's FFN Megatron-split
over model slots, :func:`make_sp_moe_lm_train_step` with the sequence over
seq slots, and :func:`make_pipeline_moe_lm_train_step` through the
pipeline on every schedule but zb-stash (with seq slots: GPipe only).
:func:`train_lm` picks one from the mesh for a MoE config, in the expert
layouts (:func:`lm_block_layout` with ``ep``), and captures it as the
dense steps are captured. :func:`evaluate_moe_lm` scores the CE alone.

The ZeRO-1 and FSDP steps (:mod:`~tpu_dist_nn_torch.parallel.zero`, the
batch over a mesh's data slots with Adam's state, and for FSDP the
params, sliced over them) come in as a ``step_fn``, as the JAX CLI
passes them: :func:`train_lm` takes their sliced state from
``step.init_opt_state``, slices the params with ``step.shard_params``
and returns them whole, and captures the step when every slot is on the
params' card. Left for later slices: the multi-host trainers.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable

import numpy as np
import torch

from tpu_dist_nn_torch.checkpoint.store import flush, resume_or_init
from tpu_dist_nn_torch.kernels.flash_attention import default_attn_fn
from tpu_dist_nn_torch.models.transformer import (
    TransformerConfig,
    lm_loss,
    next_token_ce,
    param_leaves,
    tree_map,
)
from tpu_dist_nn_torch.parallel import expert_parallel as epl
from tpu_dist_nn_torch.parallel import transformer_pipeline as tpl
from tpu_dist_nn_torch.parallel.mesh import AXIS_EXPERT, AXIS_MODEL, AXIS_SEQ
from tpu_dist_nn_torch.parallel.ring_attention import make_seq_parallel_lm_loss
from tpu_dist_nn_torch.parallel.one_f_one_b import validate_schedule
from tpu_dist_nn_torch.train.graphs import CompiledStep
from tpu_dist_nn_torch.train.optimizers import Optimizer, apply_updates, build_optimizer
from tpu_dist_nn_torch.utils.errors import InvalidArgumentError


@dataclasses.dataclass(frozen=True)
class LMTrainConfig:
    learning_rate: float = 1e-3
    steps: int = 200
    batch_size: int = 16
    seq_len: int = 128
    log_every: int = 50
    clip_norm: float | None = None
    warmup_steps: int = 0
    lr_schedule: str = "constant"
    weight_decay: float = 0.0
    grad_accum: int = 1
    steps_per_call: int = 1


def make_lm_train_step(cfg: TransformerConfig, optimizer: Optimizer, attn_fn=None, *,
                       steps_per_call: int = 1):
    """``step(params, opt_state, tokens) -> (params, opt_state, loss)``:
    forward, backward, optimizer update. ``params`` (float32 leaves that
    require grad) are updated in place and returned; ``loss`` is a
    detached scalar tensor (reading it synchronises).

    ``steps_per_call=K > 1`` returns the superstep
    ``(params, opt_state, tokens_k (K, B, T+1)) -> (..., losses (K,))``:
    K optimizer steps in one call with no host sync between them.
    ``micro_step`` (a role, or K roles for a superstep): see
    :meth:`Optimizer.update`. These are the eager steps;
    :func:`train_lm` captures the one-step one on a card.
    """
    attn_fn = attn_fn or default_attn_fn()
    return _autograd_step(lambda params, tokens: lm_loss(params, tokens, cfg, attn_fn),
                          optimizer, steps_per_call)


def _autograd_step(loss_fn, optimizer: Optimizer, steps_per_call: int = 1):
    """The step (or K-step superstep) of a ``loss_fn(params, tokens)``
    differentiated by autograd: see :func:`make_lm_train_step`."""

    def step(params, opt_state, tokens, *, micro_step=None):
        leaves = param_leaves(params)
        loss = loss_fn(params, tokens)
        grads = torch.autograd.grad(loss, leaves)
        updates = optimizer.update(grads, opt_state, leaves, micro_step=micro_step)
        if updates is not None:
            apply_updates(leaves, updates)
        return params, opt_state, loss.detach()

    if steps_per_call == 1:
        return step
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")

    def superstep(params, opt_state, tokens_k, *, micro_step=None):
        losses = []
        for j in range(tokens_k.shape[0]):
            role = None if micro_step is None else micro_step[j]
            params, opt_state, loss = step(params, opt_state, tokens_k[j], micro_step=role)
            losses.append(loss)
        return params, opt_state, torch.stack(losses)

    return superstep


def make_seq_parallel_lm_train_step(mesh, cfg: TransformerConfig, optimizer: Optimizer,
                                    mode: str = "ring", attn_fn=None):
    """The sequence-parallel step over the mesh's seq slots (and data
    slots): ``mode`` "ring" (K/V rotation, O(T/N) memory a slot) or
    "ulysses" (all-to-all head scatter, the flash kernels on a card).
    Tokens are full (input + target) rows: the masked CE scores
    positions ``0..T-2``. Same signature and in-place updates as
    :func:`make_lm_train_step`'s step."""
    return _autograd_step(make_seq_parallel_lm_loss(mesh, cfg, mode, attn_fn), optimizer)


def make_pipeline_sp_lm_train_step(mesh, cfg: TransformerConfig, num_stages: int,
                                   num_microbatches: int, optimizer: Optimizer,
                                   mode: str = "ring", schedule: str = "gpipe",
                                   num_virtual: int = 1, tensor_parallel: int = 1,
                                   attn_fn=None):
    """Pipeline x sequence-parallel step: blocks over the stage slots,
    each microbatch's sequence over the seq slots, the batch over the
    data slots, tokens full rows. ``schedule`` and the layouts as
    :func:`make_pipeline_lm_train_step`'s, but zb-stash, which is refused
    (the stash split knows only the dense block); ``tensor_parallel > 1``
    Megatron-shards each chunk over the model slots (PP x TP x SP x DP).
    ``attn_fn``: Ulysses' local attention."""
    validate_schedule(schedule)
    if schedule == "zb-stash":
        raise ValueError(
            "zb-stash is dense-LM only (the stash split knows the "
            "dense block structure); use schedule='zb' with "
            "seq-parallel"
        )
    _check_model_axis(mesh, tensor_parallel)
    T = "_tp" if tensor_parallel > 1 else ""
    if schedule == "zb-v":
        vag = getattr(tpl, f"make_pipeline{T}_sp_lm_zb_v_grad")(mesh, cfg, num_microbatches,
                                                                mode, attn_fn=attn_fn)
    elif schedule in ("interleaved", "zb"):
        vag = getattr(tpl, f"make_pipeline{T}_sp_lm_{schedule}_grad")(
            mesh, cfg, num_virtual, num_microbatches, mode, attn_fn=attn_fn)
    else:
        vag = getattr(tpl, f"make_pipeline{T}_sp_lm_{schedule}_grad")(
            mesh, cfg, num_stages, num_microbatches, mode, attn_fn=attn_fn)
    return _vag_step(vag, optimizer)


def _check_model_axis(mesh, tensor_parallel: int) -> None:
    if tensor_parallel > 1 and mesh.shape.get(AXIS_MODEL, 1) != tensor_parallel:
        raise ValueError(
            f"tensor_parallel={tensor_parallel} but the mesh '{AXIS_MODEL}' "
            f"axis has size {mesh.shape.get(AXIS_MODEL, 1)}"
        )


def _vag_step(vag, optimizer: Optimizer):
    """The step of a ``vag(params, tokens) -> (loss, grads)``."""

    def step(params, opt_state, tokens, *, micro_step=None):
        loss, grads = vag(params, tokens)
        leaves = param_leaves(params)
        updates = optimizer.update(param_leaves(grads), opt_state, leaves, micro_step=micro_step)
        if updates is not None:
            apply_updates(leaves, updates)
        return params, opt_state, loss.detach()

    return step


def make_pipeline_lm_train_step(mesh, cfg: TransformerConfig, num_stages: int,
                                num_microbatches: int, optimizer: Optimizer, attn_fn=None,
                                schedule: str = "gpipe", num_virtual: int = 1,
                                tensor_parallel: int = 1):
    """The pipelined step ``(params, opt_state, tokens, *, micro_step=None)
    -> (params, opt_state, loss)``, params updated in place.

    ``schedule``: "gpipe" or "1f1b" (blocks in :func:`~tpu_dist_nn_torch.
    parallel.transformer_pipeline.shard_blocks` layout), "interleaved",
    "zb" or "zb-stash" (``num_virtual`` chunks a stage, :func:`~tpu_dist_nn_torch.
    parallel.transformer_pipeline.shard_blocks_interleaved`; zb's default
    is the contiguous ``num_virtual = 1``) or "zb-v" (two chunks a stage
    on the V shape, :func:`~tpu_dist_nn_torch.parallel.transformer_pipeline.
    shard_blocks_vshape`). ``tensor_parallel > 1`` Megatron-shards each
    chunk over the mesh's model slots, with every schedule but zb-stash
    (the ``_pp_tp`` / ``_interleaved_tp`` / ``_vshape_tp`` layouts).
    ``micro_step``: see :meth:`Optimizer.update`."""
    validate_schedule(schedule)
    _check_model_axis(mesh, tensor_parallel)
    tp = tensor_parallel > 1
    if schedule == "zb-v":
        make = tpl.make_pipeline_tp_lm_zb_v_grad if tp else tpl.make_pipeline_lm_zb_v_grad
        vag = make(mesh, cfg, num_microbatches, attn_fn)
    elif schedule == "zb-stash":
        if tp:
            raise ValueError(
                "zb-stash is dense-LM only (the stash split knows the "
                "dense block structure); use schedule='zb' with "
                "tensor_parallel"
            )
        vag = tpl.make_pipeline_lm_zb_stash_grad(mesh, cfg, num_virtual, num_microbatches,
                                                 attn_fn)
    elif schedule in ("interleaved", "zb"):
        make = {
            ("interleaved", False): tpl.make_pipeline_lm_interleaved_grad,
            ("interleaved", True): tpl.make_pipeline_tp_lm_interleaved_grad,
            ("zb", False): tpl.make_pipeline_lm_zb_grad,
            ("zb", True): tpl.make_pipeline_tp_lm_zb_grad,
        }[(schedule, tp)]
        vag = make(mesh, cfg, num_virtual, num_microbatches, attn_fn)
    else:
        tpl._check_stages(mesh, num_stages)
        vag = tpl._scheduled_grad(mesh, cfg, schedule, 1, num_microbatches, attn_fn,
                                  interleaved=False, tp=tp)
    return _vag_step(vag, optimizer)


def make_moe_lm_train_step(cfg, optimizer: Optimizer, mesh=None, attn_fn=None):
    """The MoE step (CE + weighted router loss; same signature and
    in-place updates as :func:`make_lm_train_step`'s step): the single
    program (``mesh=None``), or the experts over the mesh's expert slots
    with the batch over ``(data, expert)`` (blocks in
    :func:`~tpu_dist_nn_torch.parallel.expert_parallel.ep_shard_blocks`
    layout; ``expert == 1`` is plain data parallelism over that layout).
    ``cfg`` is a :class:`~tpu_dist_nn_torch.parallel.expert_parallel.
    MoEConfig`."""
    attn_fn = attn_fn or default_attn_fn()
    if mesh is None:
        return _autograd_step(lambda p, t: epl.moe_lm_loss(p, t, cfg, attn_fn=attn_fn), optimizer)
    return _autograd_step(epl.make_ep_lm_forward(mesh, cfg, attn_fn, with_loss=True), optimizer)


def make_ep_tp_moe_lm_train_step(mesh, cfg, optimizer: Optimizer, attn_fn=None):
    """Tensor parallelism inside the experts: the experts over the expert
    slots and each expert's FFN Megatron-split over its shard's model
    slots (:func:`~tpu_dist_nn_torch.parallel.expert_parallel.
    make_ep_tp_lm_loss`); ``ep_shard_blocks`` layout."""
    return _autograd_step(epl.make_ep_tp_lm_loss(mesh, cfg, attn_fn), optimizer)


def make_sp_moe_lm_train_step(mesh, cfg, optimizer: Optimizer, mode: str = "ring",
                              attn_fn=None):
    """Long-context MoE: ring or Ulysses attention over the seq slots x
    the experts over the expert slots, the batch over ``(data, expert)``
    (:func:`~tpu_dist_nn_torch.parallel.expert_parallel.
    make_sp_ep_lm_loss`); full rows, ``ep_shard_blocks`` layout."""
    return _autograd_step(epl.make_sp_ep_lm_loss(mesh, cfg, mode, attn_fn), optimizer)


def make_pipeline_moe_lm_train_step(mesh, cfg, num_stages: int, num_microbatches: int,
                                    optimizer: Optimizer, attn_fn=None,
                                    schedule: str = "gpipe", num_virtual: int = 1,
                                    sp_mode: str | None = None):
    """Pipeline x expert parallelism: MoE blocks over the stage slots,
    the experts over each stage's expert slots, the batch over ``(data,
    expert)``; the router losses on the executors' aux channel.
    ``schedule`` gpipe or 1f1b (:func:`~tpu_dist_nn_torch.parallel.
    expert_parallel.shard_blocks_pp_ep` layout), interleaved or zb
    (``shard_blocks_interleaved_ep``), zb-v (``shard_blocks_vshape_ep``);
    zb-stash is refused (JAX's text). ``sp_mode`` adds the seq slots
    (pipeline x sequence x expert, GPipe only; full rows)."""
    validate_schedule(schedule)
    if schedule == "zb-stash":
        raise ValueError(
            "zb-stash is dense-LM only (the stash split knows the "
            "dense block structure); use schedule='zb' with --experts"
        )
    if sp_mode is not None:
        if schedule != "gpipe":
            raise ValueError(
                f"--experts x --seq-parallel x --stages supports the "
                f"gpipe schedule only (got {schedule!r}): the scheduled "
                "executors' three-axis product (aux channel + "
                "in-schedule ring + expert all_to_all per tick branch) "
                "is out of scope; the gpipe cell carries the "
                "three-axis parity evidence"
            )
        return _vag_step(epl.make_pipeline_sp_ep_lm_gpipe_grad(
            mesh, cfg, num_stages, num_microbatches, sp_mode, attn_fn), optimizer)
    if schedule == "zb-v":
        vag = epl.make_pipeline_ep_lm_zb_v_grad(mesh, cfg, num_microbatches, attn_fn)
    elif schedule in ("interleaved", "zb"):
        vag = getattr(epl, f"make_pipeline_ep_lm_{schedule}_grad")(
            mesh, cfg, num_virtual, num_microbatches, attn_fn)
    else:
        vag = getattr(epl, f"make_pipeline_ep_lm_{schedule}_grad")(
            mesh, cfg, num_stages, num_microbatches, attn_fn)
    return _vag_step(vag, optimizer)


def lm_block_layout(sched: str, stages: int, num_virtual: int, *, cfg=None, tp: int = 1,
                    ep: int = 0):
    """-> ``(shard_blocks_fn, unshard_blocks_fn)`` for the pipelined LM's
    param layout under (schedule, sharding): ``ep > 0`` the expert-sharded
    family (``ep`` expert shards; ``cfg`` unused), ``tp > 1`` the
    Megatron family (needs ``cfg``), else the dense one."""
    validate_schedule(sched)
    if ep:
        if sched == "zb-v":
            return lambda b: epl.shard_blocks_vshape_ep(b, stages, ep), epl.unshard_blocks_vshape_ep
        if sched in ("interleaved", "zb"):
            return (lambda b: epl.shard_blocks_interleaved_ep(b, stages, num_virtual, ep),
                    epl.unshard_blocks_interleaved_ep)
        return lambda b: epl.shard_blocks_pp_ep(b, stages, ep), epl.unshard_blocks_pp_ep
    if tp > 1:
        if sched == "zb-v":
            return (lambda b: tpl.shard_blocks_vshape_tp(b, cfg, stages, tp),
                    lambda b: tpl.unshard_blocks_vshape_tp(b, cfg))
        if sched in ("interleaved", "zb"):
            return (lambda b: tpl.shard_blocks_interleaved_tp(b, cfg, stages, num_virtual, tp),
                    lambda b: tpl.unshard_blocks_interleaved_tp(b, cfg))
        return (lambda b: tpl.shard_blocks_pp_tp(b, cfg, stages, tp),
                lambda b: tpl.unshard_blocks_pp_tp(b, cfg))
    if sched == "zb-v":
        return lambda b: tpl.shard_blocks_vshape(b, stages), tpl.unshard_blocks_vshape
    if sched in ("interleaved", "zb", "zb-stash"):
        return (lambda b: tpl.shard_blocks_interleaved(b, stages, num_virtual),
                tpl.unshard_blocks_interleaved)
    return (lambda b: tpl.shard_blocks(b, stages), tpl.unshard_blocks)


def _device_of(params: dict) -> torch.device:
    return param_leaves(params)[0].device


def train_lm(params: dict, cfg: TransformerConfig, batches: Iterable[np.ndarray],
             train_cfg: LMTrainConfig, *, attn_fn=None, step_fn=None, checkpoints=None,
             checkpoint_every: int | None = None, mesh=None, num_stages: int = 1,
             num_microbatches: int = 1, schedule: str = "gpipe", num_virtual: int = 1,
             tensor_parallel: int = 1, sp_mode: str = "ring"):
    """Train for ``train_cfg.steps`` batches of ``(batch, seq_len + 1)``
    token rows on the params' device; returns ``(params, history)``.

    A :class:`~tpu_dist_nn_torch.parallel.expert_parallel.MoEConfig`
    trains the MoE LM: on one program without a ``mesh``; with one, in
    the expert layouts (returned in the standard one), through the
    pipeline when ``num_stages > 1`` (:func:`make_pipeline_moe_lm_train_step`),
    else with seq slots :func:`make_sp_moe_lm_train_step`, with model
    slots :func:`make_ep_tp_moe_lm_train_step`, and otherwise over the
    ``(data, expert)`` slots (:func:`make_moe_lm_train_step`).

    Pipelined when ``mesh`` and ``num_stages > 1`` (and no ``step_fn``):
    the params are regrouped into ``schedule``'s staged layout
    (:func:`lm_block_layout`, Megatron-sharded when ``tensor_parallel >
    1``) for the run, and come back in the standard layout. Sequence-
    parallel when the mesh has seq slots (``sp_mode`` ring or ulysses):
    alone (:func:`make_seq_parallel_lm_train_step`) or through the
    pipeline (:func:`make_pipeline_sp_lm_train_step`); the rows are then
    full rows (``cfg.max_seq_len`` must hold ``seq_len + 1`` positions).
    A step over slots is captured when every slot is on the params'
    card, and runs eager otherwise.

    The caller's tensors are not modified (the loop trains a copy).
    ``history`` holds ``{"step", "loss", "seconds"}`` every
    ``log_every`` steps and at the last, each stamped after
    ``float(loss)``, which waits for the step to finish on the device.
    ``step_fn``: ``optimizer -> step`` factory overriding the built-in
    step (one step a call; on a card it is captured too, so it takes
    ``micro_step`` as :func:`make_lm_train_step`'s steps do). The step's
    optional attributes: ``init_opt_state`` (the optimizer state, in
    place of ``optimizer.init``), ``shard_params`` / ``unshard_params``
    (the params' layout for the run, and back), ``mesh`` (its slots: it
    is captured only when they are all on the params' card) — the ZeRO
    and FSDP steps of :mod:`~tpu_dist_nn_torch.parallel.zero` have them.

    ``checkpoints`` (a checkpoint manager) saves and resumes ``{"params",
    "opt_state"}``: the newest checkpoint is restored before the first
    step (and so before a card captures the step, whose graph then
    updates the restored tensors in place), its index counts completed
    steps, and the batch stream is consumed up to it so a seeded stream
    stays aligned. Saves land every ``checkpoint_every`` steps (default
    ``log_every``) and at the last step, with ``{"step", "loss"}``
    metadata; enqueued asynchronous saves are flushed on both exits of
    the loop. The saved tensors are the ones the step updates in place.

    With ``train_cfg.steps_per_call=K > 1`` the loop feeds groups of K
    batches, ending on the global step grid (a last shorter group is a
    superstep of its own length): losses are read at most once a group,
    at log boundaries, which must land on group ends, as must
    checkpoints (the JAX package's validation and texts). On the CPU a
    group runs through the eager superstep; on a card the step is one
    captured graph
    (:class:`~tpu_dist_nn_torch.train.graphs.CompiledStep`) replayed
    once a step of the group with no host sync between: one graph of K
    steps was measured no faster on the card (PERF.md, section 6).
    """
    optimizer = build_optimizer(
        train_cfg.learning_rate, schedule=train_cfg.lr_schedule,
        warmup_steps=train_cfg.warmup_steps, total_steps=train_cfg.steps,
        clip_norm=train_cfg.clip_norm, weight_decay=train_cfg.weight_decay,
        grad_accum=train_cfg.grad_accum)
    k = train_cfg.steps_per_call
    if k < 1:
        # Same contract as make_lm_train_step: reject, don't clamp — a
        # silently-ignored 0 would make an A/B harness believe it
        # measured an arm that never ran.
        raise ValueError(f"steps_per_call must be >= 1, got {k}")
    if k > 1 and train_cfg.log_every % k != 0:
        raise ValueError(
            f"log_every ({train_cfg.log_every}) must be a multiple of "
            f"steps_per_call ({k}): per-step timestamps inside one "
            "grouped device call are not fetch barriers"
        )
    if k > 1 and checkpoint_every and checkpoint_every % k != 0:
        raise ValueError(
            f"checkpoint_every ({checkpoint_every}) must be a multiple "
            f"of steps_per_call ({k}): checkpoints inside one grouped "
            "device call can only capture group-end state"
        )
    validate_schedule(schedule)
    moe = isinstance(cfg, epl.MoEConfig) and step_fn is None
    pipelined = step_fn is None and mesh is not None and num_stages > 1
    sp = step_fn is None and mesh is not None and mesh.shape[AXIS_SEQ] > 1
    over_slots = pipelined or sp or (moe and mesh is not None)
    if schedule != "gpipe" and not pipelined:
        raise ValueError(
            f"schedule={schedule!r} requires the pipelined dense LM path "
            "(mesh + num_stages > 1, no custom step_fn)"
        )
    if k > 1 and (step_fn is not None or pipelined or sp or moe):
        raise ValueError(
            "steps_per_call > 1 is the built-in single-chip path only "
            "(custom step_fn and pipelined schedules run one step per "
            "call)"
        )
    unshard = None
    if pipelined:
        shard, unshard = lm_block_layout(schedule, num_stages, num_virtual, cfg=cfg,
                                         tp=tensor_parallel,
                                         ep=mesh.shape[AXIS_EXPERT] if moe else 0)
        params = dict(params, blocks=shard(params["blocks"]))
        if moe:
            step = make_pipeline_moe_lm_train_step(
                mesh, cfg, num_stages, num_microbatches, optimizer, attn_fn, schedule=schedule,
                num_virtual=num_virtual, sp_mode=sp_mode if sp else None)
        elif sp:
            step = make_pipeline_sp_lm_train_step(
                mesh, cfg, num_stages, num_microbatches, optimizer, sp_mode, schedule=schedule,
                num_virtual=num_virtual, tensor_parallel=tensor_parallel, attn_fn=attn_fn)
        else:
            step = make_pipeline_lm_train_step(mesh, cfg, num_stages, num_microbatches,
                                               optimizer, attn_fn, schedule=schedule,
                                               num_virtual=num_virtual,
                                               tensor_parallel=tensor_parallel)
        params = tree_map(lambda a: a.detach().clone(), params)
    else:
        if moe and mesh is not None:
            params = dict(params, blocks=epl.ep_shard_blocks(params["blocks"],
                                                             mesh.shape[AXIS_EXPERT]))
            unshard = epl.ep_unshard_blocks
            if sp:
                step = make_sp_moe_lm_train_step(mesh, cfg, optimizer, sp_mode, attn_fn)
            elif mesh.shape[AXIS_MODEL] > 1:
                step = make_ep_tp_moe_lm_train_step(mesh, cfg, optimizer, attn_fn)
            else:
                step = make_moe_lm_train_step(cfg, optimizer, mesh, attn_fn)
        elif moe:
            step = make_moe_lm_train_step(cfg, optimizer, attn_fn=attn_fn)
        elif sp:
            step = make_seq_parallel_lm_train_step(mesh, cfg, optimizer, sp_mode, attn_fn)
        elif step_fn is not None:
            step = step_fn(optimizer)
        else:
            step = make_lm_train_step(cfg, optimizer, attn_fn)
        params = tree_map(lambda a: a.detach().clone().requires_grad_(True), params)
    if getattr(step, "shard_params", None) is not None:
        params = step.shard_params(params)
    device = _device_of(params)
    # A graph and its memory pool belong to one card: slots elsewhere run eager.
    step_mesh = mesh if over_slots else getattr(step, "mesh", None)
    graphed = device.type == "cuda" and (step_mesh is None or step_mesh.devices == {device})
    init_opt_state = getattr(step, "init_opt_state", optimizer.init)
    start_step, state = resume_or_init(
        checkpoints, {"params": params, "opt_state": init_opt_state(param_leaves(params))})
    params, opt_state = state["params"], state["opt_state"]
    every = checkpoint_every or train_cfg.log_every
    superstep = make_lm_train_step(cfg, optimizer, attn_fn, steps_per_call=k) if k > 1 else None
    compiled = None

    def run_group(group):
        """Run one group (one step, or one superstep), log and save it."""
        nonlocal compiled
        stack = np.stack([np.asarray(b) for _, b in group])
        if graphed:
            # One captured step over a static token buffer, replayed for
            # every step of the group with no host sync between them.
            if compiled is None:
                compiled = CompiledStep(step, (params, opt_state),
                                        [(stack.shape[1:], torch.int64)], optimizer,
                                        opt_state, device)
            # the graph's loss is overwritten by the next replay
            out = [compiled(x).clone() for x in stack]
        elif superstep is not None:
            out = superstep(params, opt_state, torch.as_tensor(stack, device=device).long())[2]
        else:
            out = [step(params, opt_state, torch.as_tensor(stack[0], device=device).long())[2]]
        for j, (i, _) in enumerate(group):
            if (i + 1) % train_cfg.log_every == 0 or i == train_cfg.steps - 1:
                # float() is the host sync: at most one fetch a group.
                history.append({"step": i + 1, "loss": float(out[j]),
                                "seconds": time.monotonic() - t0})
        if checkpoints is not None and any(
                (i + 1) % every == 0 or i == train_cfg.steps - 1 for i, _ in group):
            done = group[-1][0] + 1
            checkpoints.save(done, {"params": params, "opt_state": opt_state},
                             metadata={"step": done, "loss": float(out[-1])})

    history = []
    t0 = time.monotonic()
    try:
        group = []
        for i, batch in enumerate(batches):
            if i >= train_cfg.steps:
                break
            if i < start_step:
                continue  # replay-skip: keeps a seeded stream aligned
            group.append((i, batch))
            # Flush on the global step grid: after a resume at a step
            # off the grid the first group is shorter; a last shorter
            # group is a superstep of its own length.
            if (i + 1) % k == 0 or i == train_cfg.steps - 1:
                run_group(group)
                group = []
        if group:
            run_group(group)
    except BaseException:
        # Enqueued async saves become durable even when the loop raises.
        flush(checkpoints)
        raise
    else:
        flush(checkpoints)
    if getattr(step, "unshard_params", None) is not None:
        return tree_map(lambda a: a.detach(), step.unshard_params(params)), history
    params = tree_map(lambda a: a.detach(), params)
    if unshard is not None:
        params = dict(params, blocks=unshard(params["blocks"]))
    return params, history


def evaluate_lm(params: dict, cfg: TransformerConfig, rows: np.ndarray, batch_size: int = 16,
                max_batches: int | None = None) -> dict:
    """Mean next-token CE, perplexity and bits/byte over ``(N, T + 1)``
    rows, in full batches (at most ``max_batches``); one host sync at
    the end."""
    attn_fn = default_attn_fn()
    return _evaluate_ce(lambda batch: lm_loss(params, batch, cfg, attn_fn), params, rows,
                        batch_size, max_batches)


def evaluate_moe_lm(params: dict, cfg, rows: np.ndarray, batch_size: int = 16,
                    max_batches: int | None = None) -> dict:
    """:func:`evaluate_lm` for the MoE LM (one program, one routing group
    a batch): the CE alone, without the router loss, so perplexity and
    bits/byte compare with the dense model's."""
    attn_fn = default_attn_fn()

    def ce(batch):
        return next_token_ce(epl.moe_forward(params, batch[:, :-1], cfg, attn_fn=attn_fn)[0],
                             batch[:, 1:])

    return _evaluate_ce(ce, params, rows, batch_size, max_batches)


@torch.no_grad()
def _evaluate_ce(loss_fn, params: dict, rows: np.ndarray, batch_size: int,
                 max_batches: int | None) -> dict:
    device = _device_of(params)
    total, n = None, 0
    for i in range(0, len(rows) - batch_size + 1, batch_size):
        if max_batches is not None and n >= max_batches:
            break
        batch = torch.as_tensor(np.asarray(rows[i : i + batch_size]), device=device).long()
        loss_b = loss_fn(batch)
        total = loss_b if total is None else total + loss_b
        n += 1
    if n == 0:
        raise InvalidArgumentError("not enough rows for one eval batch")
    loss = float(total) / n
    return {
        "loss_nats_per_token": loss,
        "perplexity": float(np.exp(loss)),
        "bits_per_byte": loss / np.log(2),
        "eval_rows_used": n * batch_size,
    }

"""Language-model training on one device: the byte-level Transformer.

Port of the single-chip half of :mod:`tpu_dist_nn.train.lm_trainer`:
next-token cross-entropy, the optax-matched Adam of
:mod:`tpu_dist_nn_torch.train.optimizers`, one optimizer step per
batch. Attention defaults to
:func:`tpu_dist_nn_torch.kernels.flash_attention.default_attn_fn`: the
flash kernels on the card (training and evaluation alike), the
materialised reference on the CPU.

Left for later slices: the mesh and pipeline trainers, checkpoints,
custom ``step_fn``s, and ``steps_per_call > 1`` (the JAX package's
``lax.scan`` superstep, whose CUDA counterpart is a CUDA graph: ROADMAP
Queue 1 item 7).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable

import numpy as np
import torch

from tpu_dist_nn_torch.kernels.flash_attention import default_attn_fn
from tpu_dist_nn_torch.models.transformer import (
    TransformerConfig,
    lm_loss,
    param_leaves,
    tree_map,
)
from tpu_dist_nn_torch.train.optimizers import Optimizer, apply_updates, build_optimizer
from tpu_dist_nn_torch.utils.errors import InvalidArgumentError

_SUPERSTEP = ("steps_per_call > 1 (the JAX package's lax.scan superstep; on the card a "
              "CUDA graph) is not ported yet: ROADMAP Queue 1 item 7")


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
    detached scalar tensor (reading it synchronises)."""
    if steps_per_call != 1:
        raise InvalidArgumentError(_SUPERSTEP)
    attn_fn = attn_fn or default_attn_fn()

    def step(params, opt_state, tokens):
        leaves = param_leaves(params)
        loss = lm_loss(params, tokens, cfg, attn_fn)
        grads = torch.autograd.grad(loss, leaves)
        updates = optimizer.update(grads, opt_state, leaves)
        if updates is not None:
            apply_updates(leaves, updates)
        return params, opt_state, loss.detach()

    return step


def _device_of(params: dict) -> torch.device:
    return param_leaves(params)[0].device


def train_lm(params: dict, cfg: TransformerConfig, batches: Iterable[np.ndarray],
             train_cfg: LMTrainConfig, *, attn_fn=None):
    """Train for ``train_cfg.steps`` batches of ``(batch, seq_len + 1)``
    token rows on the params' device; returns ``(params, history)``.

    The caller's tensors are not modified (the loop trains a copy).
    ``history`` holds ``{"step", "loss", "seconds"}`` every
    ``log_every`` steps and at the last, each stamped after
    ``float(loss)``, which waits for the step to finish on the device.
    """
    if train_cfg.steps_per_call != 1:
        raise InvalidArgumentError(_SUPERSTEP)
    optimizer = build_optimizer(
        train_cfg.learning_rate, schedule=train_cfg.lr_schedule,
        warmup_steps=train_cfg.warmup_steps, total_steps=train_cfg.steps,
        clip_norm=train_cfg.clip_norm, weight_decay=train_cfg.weight_decay,
        grad_accum=train_cfg.grad_accum)
    step = make_lm_train_step(cfg, optimizer, attn_fn)
    params = tree_map(lambda a: a.detach().clone().requires_grad_(True), params)
    device = _device_of(params)
    opt_state = optimizer.init(param_leaves(params))
    history = []
    t0 = time.monotonic()
    for i, batch in enumerate(batches):
        if i >= train_cfg.steps:
            break
        tokens = torch.as_tensor(np.asarray(batch), device=device).long()
        params, opt_state, loss = step(params, opt_state, tokens)
        if (i + 1) % train_cfg.log_every == 0 or i == train_cfg.steps - 1:
            history.append({"step": i + 1, "loss": float(loss),
                            "seconds": time.monotonic() - t0})
    return tree_map(lambda a: a.detach(), params), history


@torch.no_grad()
def evaluate_lm(params: dict, cfg: TransformerConfig, rows: np.ndarray, batch_size: int = 16,
                max_batches: int | None = None) -> dict:
    """Mean next-token CE, perplexity and bits/byte over ``(N, T + 1)``
    rows, in full batches (at most ``max_batches``); one host sync at
    the end."""
    attn_fn = default_attn_fn()
    device = _device_of(params)
    total, n = None, 0
    for i in range(0, len(rows) - batch_size + 1, batch_size):
        if max_batches is not None and n >= max_batches:
            break
        batch = torch.as_tensor(np.asarray(rows[i : i + batch_size]), device=device).long()
        loss_b = lm_loss(params, batch, cfg, attn_fn)
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

"""ZeRO-1 / FSDP: optimizer-state (and optionally parameter) sharding
over the data slots.

Port of :mod:`tpu_dist_nn.parallel.zero`. The JAX package pins the
optimizer state (and, for FSDP, the params) to a layout sharded over the
mesh's ``data`` axis and lets XLA's partitioner turn the gradient
reduction into a reduce-scatter and the update into an all-gather. The
port's one process drives the data slots (:mod:`~tpu_dist_nn_torch.
parallel.mesh`) and does the same schedule by hand, one step:

1. Slot ``d`` computes the loss of its rows of the batch and, through
   one backward over every slot, the gradients of its own copy of the
   leaves (views of the params on their card, a peer copy on another;
   under FSDP the slices gathered on the slot).
2. Slice ``j`` of every gradient is summed on slot ``j``'s stream in
   shard order 0, 1, ..., N-1 (:func:`~tpu_dist_nn_torch.parallel.
   collectives.reduce_scatter`), so a repeat gives the same bits.
3. Slot ``j`` applies Adam to its slices of ``mu``, ``nu`` and the
   params on its stream (:meth:`~tpu_dist_nn_torch.train.optimizers.
   Optimizer.accumulate` and :meth:`~tpu_dist_nn_torch.train.optimizers.
   Optimizer.apply`), with ``clip_norm``'s global norm: each slot's
   partial sum of squares, added in slot order on slot 0's stream. The
   count advances once, after every slot.
4. The updated params are gathered back: ZeRO-1 writes each slice into
   the one replica of the params (in place on their card, so every
   slot reads the update at the next step), FSDP keeps the slices and
   gathers them on each slot at its next use.

Per-leaf layout (:func:`zero_opt_shardings`, the JAX rule): the largest
dim divisible by the data-slot count N (and at least N) is sharded, the
later dim on a tie; a leaf without one (a scalar, an odd shape) stays
whole, owned by slot 0, which updates it once for every slot. A
sharded leaf is a :class:`Shards`: its slices, each on its slot's card.
The checkpoint store saves it whole under the leaf's usual key and
re-slices it on restore, so a ZeRO checkpoint and an unsharded one are
the same file. ``init_opt_state`` allocates only the slices: a
full-size moment never exists.

On one card the slices save no memory: every slot is on that card, and
the plain replicas already share one copy of the params. The sharding
pays only when the slots sit on different cards; the step allocates
nothing to imitate the JAX package's per-device copies (FSDP's gathers
are its own: one full copy of a leaf a slot, inside the step).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_dist_nn_torch.kernels.flash_attention import default_attn_fn
from tpu_dist_nn_torch.models.transformer import TransformerConfig, lm_loss, param_leaves
from tpu_dist_nn_torch.parallel.collectives import (
    fork,
    gather_slices,
    hand_off,
    join,
    on_slot,
    psum,
    reduce_scatter,
    take,
)
from tpu_dist_nn_torch.parallel.mesh import AXIS_DATA
from tpu_dist_nn_torch.train.optimizers import OptState


class Shards:
    """A leaf split along ``dim`` into equal slices, ``parts[j]`` on data
    slot ``j``'s card. ``shape``, ``dtype`` and ``device`` (slice 0's)
    describe the whole leaf."""

    __slots__ = ("parts", "dim", "shape")

    def __init__(self, parts, dim: int):
        self.parts = list(parts)
        self.dim = dim
        shape = list(self.parts[0].shape)
        shape[dim] *= len(self.parts)
        self.shape = torch.Size(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    def numel(self) -> int:
        return sum(p.numel() for p in self.parts)

    @classmethod
    def split(cls, t: torch.Tensor, dim: int, devices) -> "Shards":
        """``t``'s slices along ``dim``, slice ``j`` copied to ``devices[j]``."""
        return cls([p.detach().to(dev, copy=True)
                    for p, dev in zip(t.chunk(len(devices), dim=dim), devices)], dim)

    def whole(self, device=None) -> torch.Tensor:
        """The leaf, its slices concatenated on ``device`` (default: slice 0's)."""
        device = self.device if device is None else device
        return torch.cat([p.detach().to(device) for p in self.parts], dim=self.dim)

    def host_array(self) -> np.ndarray:
        """The whole leaf on the host (the checkpoint store's save)."""
        _settle(self.parts)
        return np.concatenate([p.detach().cpu().numpy() for p in self.parts], axis=self.dim)

    def restored(self, arr: np.ndarray) -> "Shards":
        """``arr`` (the whole leaf) re-sliced onto these slices' cards and dtype."""
        whole = torch.from_numpy(np.ascontiguousarray(arr))
        parts = [p.to(device=q.device, dtype=q.dtype)
                 for p, q in zip(whole.chunk(len(self.parts), dim=self.dim), self.parts)]
        _settle(parts)
        return Shards(parts, self.dim)


def _settle(parts) -> None:
    """Wait for every card that holds one of ``parts``: a slice is written
    on its slot's stream, and a copy to or from the host runs on its
    card's current stream, which did not wait for that slot when the slot
    is on another card than the caller's."""
    for dev in {p.device for p in parts if p.is_cuda}:
        torch.cuda.synchronize(dev)


def _data_size(mesh_or_n, axis: str) -> int:
    return mesh_or_n if isinstance(mesh_or_n, int) else mesh_or_n.shape[axis]


def shard_dim(shape, n: int) -> int | None:
    """The layout rule for one leaf: the largest dim divisible by ``n``
    and at least ``n`` (the later one on a tie), or None."""
    cands = [(size, i) for i, size in enumerate(shape) if size % n == 0 and size >= n]
    return max(cands)[1] if cands else None


def zero_opt_shardings(opt_state_shapes, mesh, axis: str = AXIS_DATA):
    """Each leaf's sharded dim (or None: whole) over ``mesh``'s ``axis``
    (or over ``mesh`` data slots when it is an int), in the structure of
    ``opt_state_shapes`` (dicts, lists and tuples of anything with a
    ``.shape``: tensors, arrays, :class:`Shards`)."""
    n = _data_size(mesh, axis)

    def rule(tree):
        if isinstance(tree, dict):
            return {k: rule(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rule(v) for v in tree)
        return shard_dim(tuple(getattr(tree, "shape", ())), n)

    return rule(opt_state_shapes)


def _rebuild(template: dict, leaves) -> dict:
    """``template``'s dict structure with its leaves (``param_leaves``
    order: keys sorted, depth first) taken from the iterator ``leaves``."""
    return {k: _rebuild(template[k], leaves) if isinstance(template[k], dict) else next(leaves)
            for k in sorted(template)}


def _make_sharded_step(mesh, cfg: TransformerConfig, optimizer, params, shard_params: bool,
                       attn_fn, *, loss_fn=None):
    """The step ``(params, opt_state, tokens, *, micro_step=None) ->
    (params, opt_state, loss)`` (params and state updated in place) of
    the module docstring, with ``init_opt_state``, ``shard_params`` and
    ``unshard_params`` attached and ``mesh`` its slots. ``loss_fn(trees,
    tokens)`` takes one param tree a data slot and returns the loss on
    the caller's stream; the default is each slot's mean CE over its
    rows, averaged over the slots."""
    slots = list(mesh.slots[0])  # each data replica's lead
    n, lead = len(slots), slots[0]
    leaves = param_leaves(params)
    dims = [shard_dim(tuple(leaf.shape), n) for leaf in leaves]
    if loss_fn is None:
        attn_fn = attn_fn or default_attn_fn()

        def loss_fn(trees, tokens):
            if tokens.shape[0] % n:
                raise ValueError(f"batch {tokens.shape[0]} not divisible by data axis {n}")
            losses = []
            for slot, tree, rows in zip(slots, trees, tokens.chunk(n, dim=0)):
                with on_slot(slot):
                    losses.append(lm_loss(tree, take(slot, rows), cfg, attn_fn))
            with on_slot(lead):
                total = psum(losses, slots) / n
            return total

    def replicas(params) -> list[dict]:
        """One tree a data slot of leaves that require grad (after a fork)."""
        flat = param_leaves(params)
        trees = []
        for slot in slots:
            with on_slot(slot):
                mine = [gather_slices(leaf.parts, slot, dim) if isinstance(leaf, Shards)
                        else take(slot, leaf.detach()) for leaf, dim in zip(flat, dims)]
            trees.append(_rebuild(params, iter([t.requires_grad_(True) for t in mine])))
        return trees

    def owned(flat) -> tuple[list, list]:
        """The param pieces each slot updates (``[(slot, [piece])]``) and
        the views to write back where a slot is not on the replica's card."""
        pieces, back = [[] for _ in slots], []
        for leaf, dim in zip(flat, dims):
            if isinstance(leaf, Shards):
                for j, part in enumerate(leaf.parts):
                    pieces[j].append(part)
            elif dim is None:
                pieces[0].append(leaf.detach())
            else:
                for j, (slot, view) in enumerate(zip(slots, leaf.detach().chunk(n, dim=dim))):
                    if slot.device == view.device:
                        pieces[j].append(view)
                    else:
                        with on_slot(slot):
                            pieces[j].append(take(slot, view).clone())
                        back.append((j, view, pieces[j][-1]))
        return pieces, back

    def step(params, opt_state, tokens, *, micro_step=None):
        caller = fork(slots)
        trees = replicas(params)
        loss = loss_fn(trees, tokens)
        n_leaves = len(dims)
        grads = torch.autograd.grad(loss, [leaf for t in trees for leaf in param_leaves(t)])
        # Reduce-scatter: slot j's gradient pieces, in the order owned()
        # lists its param pieces.
        g_by_slot = [[] for _ in slots]
        for i, dim in enumerate(dims):
            parts = [grads[d * n_leaves + i] for d in range(n)]
            if dim is None:
                # A whole leaf: the sum in shard order on slot 0 (a
                # reduce-scatter over one owner).
                g_by_slot[0].append(reduce_scatter([p[None] for p in parts], [lead], 0)[0][0])
            else:
                for j, g in enumerate(reduce_scatter(parts, slots, dim)):
                    g_by_slot[j].append(g)
        p_by_slot, back = owned(param_leaves(params))
        # Each slot's part of the state, in the same order.
        mu, nu = _by_slot(opt_state.mu, n), _by_slot(opt_state.nu, n)
        acc = [None] * n if opt_state.acc is None else _by_slot(opt_state.acc, n)
        parts = [OptState(count=opt_state.count, mu=m, nu=v, acc=a)
                 for m, v, a in zip(mu, nu, acc)]
        k = opt_state.mini_step if micro_step is None else micro_step
        if micro_step is None:
            opt_state.mini_step = optimizer.next_micro_step(k)
        for j, slot in enumerate(slots):
            with on_slot(slot):
                g_by_slot[j] = optimizer.accumulate(g_by_slot[j], parts[j], k)
        applied = g_by_slot[0] is not None
        if applied:
            norms = (_global_norm(slots, g_by_slot) if optimizer.clip_norm is not None
                     else [None] * n)
            for slot, grads_, part, pieces, norm in zip(slots, g_by_slot, parts, p_by_slot,
                                                       norms):
                with on_slot(slot), torch.no_grad():
                    updates = optimizer.apply(grads_, part, pieces, norm=norm, advance=False)
                    torch._foreach_add_(pieces, [u.to(p.dtype) for u, p in zip(updates, pieces)])
            # ZeRO-1's gather for a slot on another card than the replica.
            for j, whole_view, piece in back:
                with on_slot(lead), torch.no_grad():
                    whole_view.copy_(hand_off(lead, slots[j], piece))
        join(caller, slots)
        if applied:
            opt_state.count.add_(1)  # after every slot read it
        return params, opt_state, loss.detach()

    def init_opt_state(params_leaves) -> OptState:
        """Adam's state with each moment allocated only as its slices."""
        home = params_leaves[0].device

        def zeros():
            out = []
            for leaf, dim in zip(params_leaves, dims):
                if dim is None:
                    out.append(torch.zeros(tuple(leaf.shape), dtype=torch.float32, device=home))
                    continue
                shape = list(leaf.shape)
                shape[dim] //= n
                out.append(Shards([torch.zeros(shape, dtype=torch.float32, device=slot.device)
                                   for slot in slots], dim))
            return out

        return OptState(count=torch.zeros((), dtype=torch.int64, device=home), mu=zeros(),
                        nu=zeros(), acc=zeros() if optimizer.grad_accum > 1 else None)

    def shard(params: dict) -> dict:
        """FSDP: the params as their slices; ZeRO-1: as they are."""
        if not shard_params:
            return params
        devices = [slot.device for slot in slots]
        flat = [leaf if dim is None else Shards.split(leaf, dim, devices)
                for leaf, dim in zip(param_leaves(params), dims)]
        return _rebuild(params, iter(flat))

    def unshard(params: dict) -> dict:
        """The params in the standard layout: whole detached tensors on the
        lead's card."""
        flat = [leaf.whole() if isinstance(leaf, Shards) else leaf.detach()
                for leaf in param_leaves(params)]
        return _rebuild(params, iter(flat))

    step.init_opt_state = init_opt_state
    step.shard_params = shard
    step.unshard_params = unshard
    step.mesh = mesh
    step.layout = dims
    return step


def _by_slot(leaves, n: int) -> list[list[torch.Tensor]]:
    """Each slot's pieces of a state list, leaf order: a sliced leaf's
    slice ``j`` to slot ``j``, a whole leaf to slot 0."""
    rows = [[] for _ in range(n)]
    for leaf in leaves:
        for j, part in enumerate(leaf.parts if isinstance(leaf, Shards) else [leaf]):
            rows[j].append(part)
    return rows


def _global_norm(slots, grads_by_slot) -> list[torch.Tensor]:
    """``clip_norm``'s global norm over every slot's gradient pieces:
    each slot's partial sum of squares on its stream, added in slot order
    on slot 0's; returned as one tensor a slot, valid on its stream."""
    lead, total = slots[0], None
    with on_slot(lead):
        for slot, grads in zip(slots, grads_by_slot):
            if not grads:
                continue
            with on_slot(slot):
                partial = sum(torch.sum(g * g) for g in grads)
            part = hand_off(lead, slot, partial)
            total = part if total is None else total + part
        norm = torch.sqrt(total)
    out = []
    for slot in slots:
        with on_slot(slot):
            out.append(hand_off(slot, lead, norm))
    return out


def make_zero_lm_train_step(mesh, cfg: TransformerConfig, optimizer, params, attn_fn=None):
    """ZeRO-1 ``step(params, opt_state, tokens)`` for the dense LM over
    the mesh's data slots: params replicated, Adam's moments sliced.

    ``params`` supplies structure only. Pass the *same* optimizer the
    trainer builds; ``step.init_opt_state(param_leaves(params))``
    allocates the sliced state (``train_lm`` picks it up by
    ``getattr(step, "init_opt_state", optimizer.init)``)."""
    return _make_sharded_step(mesh, cfg, optimizer, params, False, attn_fn)


def make_fsdp_lm_train_step(mesh, cfg: TransformerConfig, optimizer, params, attn_fn=None):
    """Fully-sharded step (the FSDP / ZeRO-3 analogue): params and
    moments sliced over the data slots by the same layout rule. The
    params go in as ``step.shard_params(params)`` (each slot keeps its
    slices) and come back whole with ``step.unshard_params``; the
    forward gathers each leaf on each slot inside the step."""
    return _make_sharded_step(mesh, cfg, optimizer, params, True, attn_fn)


def make_sp_sharded_lm_train_step(mesh, cfg: TransformerConfig, optimizer, params,
                                  mode: str = "ring", shard_params: bool = False,
                                  attn_fn=None):
    """Sequence parallelism x sharded optimizer state: ZeRO-1
    (``shard_params=False``) or FSDP (``True``) over the data slots of a
    ``(seq, data)`` mesh, with the ring or Ulysses loss of
    :func:`~tpu_dist_nn_torch.parallel.ring_attention.
    make_seq_parallel_lm_loss` (full input + target rows, the masked
    CE). Each data replica's seq slots read that replica's leaves, so
    its gradients are its own and the reduce-scatter is the plain
    data-parallel one, orthogonal to the seq axis. ``attn_fn``:
    Ulysses' local attention."""
    from tpu_dist_nn_torch.parallel.ring_attention import make_seq_parallel_lm_loss

    loss = make_seq_parallel_lm_loss(mesh, cfg, mode, attn_fn)
    return _make_sharded_step(mesh, cfg, optimizer, params, shard_params, None,
                              loss_fn=lambda trees, tokens: loss(trees, tokens))

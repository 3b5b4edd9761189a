"""The layer-distribution pipeline: padded contract, placement, forwards.

Port of :mod:`tpu_dist_nn.parallel.pipeline` (the reference's
container-per-stage pipeline, ``run_grpc_fcnn.py:182-218,266``).

**The padded contract.** :func:`build_pipeline_params` stacks the
stages into ``(S, L, D, D)`` weights and ``(S, L, D)`` biases — each
real layer's matrix at ``[:in_dim, :out_dim]``, identity filler for
missing layers — equal element for element to the JAX arrays, and a
frozen :class:`PipelineMeta`. The JAX package needs that padding because
SPMD runs one traced program on every device. It stays the port's data
contract: :func:`extract_model`, checkpoints, the int8 contract
(``quantize_pipeline_weights``) and :func:`pipeline_params_from_jax` all
read and write it. :func:`_masked_activation` and :func:`_stage_apply`
are the plain reference of one padded stage.

**Placement.** The port does not compute on the padding: at 784-128-64-10
on ``[1, 1, 1]`` it would mean three 784x784 products in place of
784x128, 128x64 and 64x10. :func:`place_pipeline` slices each stage's
real layers out of the contract onto its slot's device as the
``[{"w", "b", "act"}]`` list that
:func:`~tpu_dist_nn_torch.models.network.dense_forward` serves through
the chain kernel (``fcnn_fused_forward``; ``fused_dense`` where
``chain_segments`` cuts out one layer), and
:func:`place_pipeline_quantized` the int8 blocks that it serves through
the int8 chain kernel. An empty stage is the identity and launches
nothing.

**Forwards.** :func:`pipeline_forward` and its interleaved, int8, and
interleaved int8 twins keep the JAX checks and error texts, split the
rows into microbatches (:func:`split_rows`: the JAX ``pad_batch``
grouping without its padding rows, so a last microbatch may be short)
and run :func:`~tpu_dist_nn_torch.parallel.gpipe.gpipe_forward` or
:func:`~tpu_dist_nn_torch.parallel.interleaved.interleaved_forward`
over the slots. A cut f32 run sums in another order than one chain
(``models/network.py``), so it is held to the oracle, not bit for bit
to the single program; the int8 chain re-quantises every layer from
f32 wherever the activation sits, so the int8 pipeline is bit-equal to
the single-program int8 engine.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from tpu_dist_nn_torch.core.activations import SOFTMAX_ID, activation_id, apply_activation_by_id
from tpu_dist_nn_torch.core.schema import ModelSpec, StageSpec, validate_distribution
from tpu_dist_nn_torch.kernels.quantized import pack_wq
from tpu_dist_nn_torch.models.network import dense_forward
from tpu_dist_nn_torch.parallel.gpipe import caller_event, gather, gpipe_forward
from tpu_dist_nn_torch.parallel.interleaved import interleaved_forward
from tpu_dist_nn_torch.parallel.mesh import AXIS_STAGE, Mesh
from tpu_dist_nn_torch.train.graphs import GraphedStep


class PipelineWeights(NamedTuple):
    """Stage parameters stacked over a leading stage axis (numpy).

    ``w``: (S, L, D, D) — each real layer's (in, out) matrix embedded at
    ``[:in_dim, :out_dim]``; identity filler for missing layers.
    ``b``: (S, L, D).
    """

    w: np.ndarray
    b: np.ndarray


@dataclasses.dataclass(frozen=True)
class PipelineMeta:
    """Static pipeline structure (the JAX ``PipelineMeta``).

    ``act``/``act_logits``: (S, L) activation ids; the logits variant has
    the final real layer forced to linear. ``width``: (S, L) output
    width per layer slot; ``in_width`` its input width (0 for identity
    filler).
    """

    act: tuple[tuple[int, ...], ...]
    act_logits: tuple[tuple[int, ...], ...]
    width: tuple[tuple[int, ...], ...]
    in_width: tuple[tuple[int, ...], ...]
    in_dim: int
    final_dim: int
    num_stages: int
    layers_per_stage: int
    max_dim: int

    def act_array(self, logits: bool) -> np.ndarray:
        return np.asarray(self.act_logits if logits else self.act, dtype=np.int32)

    def num_layers(self, s: int) -> int:
        """Real layers of stage (chunk) ``s``: the filler has in_width 0."""
        return sum(1 for w in self.in_width[s] if w > 0)

    def grad_masks(self) -> tuple[np.ndarray, np.ndarray]:
        """0/1 masks over (S,L,D,D) weights and (S,L,D) biases selecting
        the real layer blocks: the only entries that train."""
        S, L, D = self.num_stages, self.layers_per_stage, self.max_dim
        w_mask = np.zeros((S, L, D, D), dtype=np.float32)
        b_mask = np.zeros((S, L, D), dtype=np.float32)
        for s in range(S):
            for li in range(L):
                fan_in, fan_out = self.in_width[s][li], self.width[s][li]
                if fan_in > 0:
                    w_mask[s, li, :fan_in, :fan_out] = 1.0
                    b_mask[s, li, :fan_out] = 1.0
        return w_mask, b_mask


class PipelineParams(NamedTuple):
    weights: PipelineWeights
    meta: PipelineMeta


def build_pipeline_params(stages: Sequence[StageSpec], dtype=np.float32) -> PipelineParams:
    """Pad and stack per-stage layer chains into uniform blocks."""
    if not stages:
        raise ValueError("need at least one stage")
    S = len(stages)
    L = max(1, max(len(s.layers) for s in stages))
    dims = [stages[0].expected_input_dim]
    for s in stages:
        for layer in s.layers:
            dims.append(layer.out_dim)
    D = max(dims)

    w = np.zeros((S, L, D, D), dtype=np.float64)
    b = np.zeros((S, L, D), dtype=np.float64)
    act = np.zeros((S, L), dtype=np.int32)
    width = np.zeros((S, L), dtype=np.int32)
    in_width = np.zeros((S, L), dtype=np.int32)
    eye = np.eye(D)
    for si, stage in enumerate(stages):
        for li in range(L):
            if li < len(stage.layers):
                layer = stage.layers[li]
                w[si, li, : layer.in_dim, : layer.out_dim] = layer.weights
                b[si, li, : layer.out_dim] = layer.biases
                act[si, li] = activation_id(layer.activation)
                width[si, li] = layer.out_dim
                in_width[si, li] = layer.in_dim
            else:
                # Identity filler: x @ I = x at full width.
                w[si, li] = eye
                width[si, li] = D

    act_logits = act.copy()
    real_stages = [si for si, s in enumerate(stages) if s.layers]
    if real_stages:
        si = real_stages[-1]
        act_logits[si, len(stages[si].layers) - 1] = 0

    meta = PipelineMeta(
        act=tuple(map(tuple, act.tolist())),
        act_logits=tuple(map(tuple, act_logits.tolist())),
        width=tuple(map(tuple, width.tolist())),
        in_width=tuple(map(tuple, in_width.tolist())),
        in_dim=stages[0].expected_input_dim,
        final_dim=stages[-1].output_dim,
        num_stages=S,
        layers_per_stage=L,
        max_dim=D,
    )
    return PipelineParams(PipelineWeights(w=w.astype(dtype), b=b.astype(dtype)), meta)


def pipeline_params_from_jax(params) -> PipelineParams:
    """The JAX package's ``PipelineParams`` (leaves numpy reads, the
    frozen meta) -> the port's, so both packages hold the same blocks."""
    weights, meta = params
    fields = {f.name: getattr(meta, f.name) for f in dataclasses.fields(PipelineMeta)}
    return PipelineParams(
        PipelineWeights(w=np.array(weights.w, np.float32), b=np.array(weights.b, np.float32)),
        PipelineMeta(**fields),
    )


# ---------------------------------------------------------------------------
# The plain reference of a padded stage
# ---------------------------------------------------------------------------

def _masked_activation(z: torch.Tensor, act_id: int, width: int) -> torch.Tensor:
    """An activation restricted to the first ``width`` columns: padding
    columns come out exactly 0, and softmax masks its input with -inf so
    padding never enters the normaliser."""
    mask = torch.arange(z.shape[-1], device=z.device) < int(width)
    if int(act_id) == SOFTMAX_ID:
        y = torch.softmax(torch.where(mask, z, torch.full_like(z, -torch.inf)), dim=-1)
    else:
        y = apply_activation_by_id(z, int(act_id))
    return torch.where(mask, y, torch.zeros((), dtype=z.dtype, device=z.device))


def _stage_apply(w, b, act, width, x: torch.Tensor) -> torch.Tensor:
    """One padded stage on ``x: (mb, D)``: ``(L, D, D)`` weights,
    ``(L, D)`` biases, ``(L,)`` ids and widths, every slot masked."""
    for li in range(len(act)):
        x = _masked_activation(x @ w[li] + b[li], act[li], width[li])
    return x


def regroup_chunks(a, num_stages: int, num_virtual: int):
    """``(V, ...) -> (S, v, ...)``: global chunk ``c`` to slot ``c % S``,
    local chunk ``c // S`` (the Megatron virtual-stage placement)."""
    a = np.asarray(a)
    return np.swapaxes(a.reshape(num_virtual, num_stages, *a.shape[1:]), 0, 1)


def check_chunk_count(num_chunks: int, num_stages: int, num_virtual: int):
    """The one ``V == S * v`` validation of the interleaved executors."""
    if num_chunks != num_stages * num_virtual:
        raise ValueError(
            f"meta has {num_chunks} chunks but mesh stage axis "
            f"{num_stages} x virtual {num_virtual} = "
            f"{num_stages * num_virtual}; build the pipeline params "
            f"with a {num_stages * num_virtual}-entry distribution"
        )


def _check_stage_count(mesh: Mesh, meta: PipelineMeta) -> None:
    stage_size = mesh.shape[AXIS_STAGE]
    if meta.num_stages != stage_size:
        raise ValueError(
            f"pipeline has {meta.num_stages} stages but the mesh '{AXIS_STAGE}' "
            f"axis has size {stage_size}"
        )


def _check_input(meta: PipelineMeta, x) -> None:
    if x.ndim != 2 or x.shape[1] != meta.in_dim:
        raise ValueError(
            f"expected input of shape (N, {meta.in_dim}), got {tuple(x.shape)}"
        )


def pad_batch(meta: PipelineMeta, x, num_microbatches: int, data_size: int, dtype=np.float32):
    """Pad a host batch as the JAX executor takes it: features to the
    uniform stage width, rows to a multiple of ``num_microbatches *
    data_size``. Returns ``(xs, n)``, ``xs`` numpy ``(M, B, D)`` and
    ``n`` the original row count. The trainer feeds this geometry; the
    forwards use :func:`split_rows`, which has no padding rows."""
    x = np.asarray(x, dtype)
    _check_input(meta, x)
    n = x.shape[0]
    m = num_microbatches
    n_pad = -n % (m * data_size)
    x = np.pad(x, ((0, n_pad), (0, meta.max_dim - meta.in_dim)))
    return x.reshape(m, (n + n_pad) // m, meta.max_dim), n


def split_rows(n: int, num_microbatches: int, data_size: int) -> list[list[slice | None]]:
    """``[m][d]``: the rows of microbatch ``m`` for data replica ``d``, in
    :func:`pad_batch`'s grouping (``B = ceil(n / (M * data)) * data``
    rows a microbatch, ``B / data`` a replica) without the padding rows:
    a trailing slice may be short, and one past ``n`` is None."""
    per = -(-n // (num_microbatches * data_size))
    out = []
    for m in range(num_microbatches):
        row = []
        for d in range(data_size):
            start = (m * data_size + d) * per
            row.append(slice(start, min(start + per, n)) if start < n else None)
        out.append(row)
    return out


# ---------------------------------------------------------------------------
# Placement on the stage slots
# ---------------------------------------------------------------------------

def stage_blocks(meta: PipelineMeta, w, b, s: int):
    """``[(w_block, b_block, in_dim, out_dim)]``: stage ``s``'s real
    layers sliced out of padded ``w``/``b`` (numpy or tensors)."""
    return [(w[s, li, :fi, :fo], b[s, li, :fo], fi, fo)
            for li, (fi, fo) in enumerate(zip(meta.in_width[s], meta.width[s])) if fi > 0]


@dataclasses.dataclass
class PlacedPipeline:
    """Stages on their slots: ``chunks[d][c]`` is chunk ``c``'s real
    layers on slot ``(c % S, d)``, as ``dense_forward`` takes them (the
    ``quantize_fcnn`` form when ``quantized``)."""

    mesh: Mesh
    meta: PipelineMeta
    chunks: list[list[list[dict]]]
    num_virtual: int = 1
    quantized: bool = False

    def chunk_fns(self, apply=None):
        """``[d][c]``: chunk ``c``'s function of one tensor on replica
        ``d``, ``apply(layers, x)`` (default: ``dense_forward``, the
        chain kernels). An empty stage is the identity and launches
        nothing."""
        if apply is None:
            apply = functools.partial(dense_forward, quantized=self.quantized)

        def fn(layers):
            return (lambda x: apply(layers, x)) if layers else (lambda x: x)

        return [[fn(layers) for layers in row] for row in self.chunks]

    @property
    def device(self) -> torch.device:
        """Where the rows enter: stage 0 of replica 0."""
        return self.mesh.slots[0][0].device


def _slot_device(mesh: Mesh, c: int, d: int) -> torch.device:
    return mesh.slots[c % mesh.spec.stage][d].device


def place_pipeline(mesh: Mesh, params: PipelineParams, *, num_virtual: int = 1,
                   logits: bool = False) -> PlacedPipeline:
    """Each chunk's real float32 layers onto its slot (``act`` from the
    meta, the final real layer linear with ``logits``)."""
    weights, meta = params
    acts = meta.act_array(logits)
    chunks = []
    for d in range(mesh.spec.data):
        row = []
        for c in range(meta.num_stages):
            dev = _slot_device(mesh, c, d)
            # Copies: a trainer updates these tensors in place, and the
            # contract it was placed from must not move with them.
            row.append([{"w": torch.from_numpy(np.array(wb, np.float32)).to(dev),
                         "b": torch.from_numpy(np.array(bb, np.float32)).to(dev),
                         "act": int(acts[c, li])}
                        for li, (wb, bb, _, _) in enumerate(stage_blocks(meta, weights.w,
                                                                         weights.b, c))])
        chunks.append(row)
    return PlacedPipeline(mesh, meta, chunks, num_virtual)


def place_pipeline_quantized(mesh: Mesh, qweights: dict, meta: PipelineMeta, *,
                             num_virtual: int = 1) -> PlacedPipeline:
    """Each chunk's real int8 blocks (``quantize_pipeline_weights``'
    contract) onto its slot in ``quantize_fcnn``'s form: the codes, the
    kernel's packed operands, scales, biases and activation ids."""
    acts = meta.act_array(False)
    wq, scale, bias = (np.asarray(qweights[k]) for k in ("wq", "scale", "b"))
    chunks = []
    for d in range(mesh.spec.data):
        row = []
        for c in range(meta.num_stages):
            dev = _slot_device(mesh, c, d)
            layers = []
            for li, (q, bb, _, fo) in enumerate(stage_blocks(meta, wq, bias, c)):
                q = torch.from_numpy(np.array(q)).to(dev)
                layers.append({
                    "wq": q, "wq_packed": pack_wq(q),
                    "scale": torch.from_numpy(np.array(scale[c, li, :fo])).to(dev),
                    "b": torch.from_numpy(np.array(bb)).to(dev),
                    "act": int(acts[c, li]),
                })
            row.append(layers)
        chunks.append(row)
    return PlacedPipeline(mesh, meta, chunks, num_virtual, quantized=True)


def run_placed(placed: PlacedPipeline, x: torch.Tensor, num_microbatches: int) -> torch.Tensor:
    """Serve ``x: (N, in_dim)`` (on ``placed.device``) through the placed
    pipeline: rows split by :func:`split_rows`, the GPipe schedule (or
    the interleaved table at ``num_virtual > 1``) over the slots, the
    last chunk's outputs gathered on ``x``'s device in row order on the
    caller's current stream. No host sync."""
    mesh = placed.mesh
    n = int(x.shape[0])
    if n == 0:
        return torch.empty((0, placed.meta.final_dim), dtype=torch.float32, device=x.device)
    rows = split_rows(n, num_microbatches, mesh.spec.data)
    xs = [[None if r is None else x[r] for r in row] for row in rows]
    fns = placed.chunk_fns()
    ready = caller_event(x)
    if placed.num_virtual > 1:
        outs = interleaved_forward(mesh, fns, placed.num_virtual, xs, ready)
    else:
        outs = gpipe_forward(mesh, fns, xs, ready)
    flat = [o for row in outs for o in row if o is not None]
    return torch.cat(gather(flat, x.device))


def row_bucket(n: int) -> int:
    """The pow2 row bucket of ``n`` rows (1, 2, 4, ...)."""
    return 1 << (n - 1).bit_length() if n > 1 else 1


class GraphedPlaced:
    """:func:`run_placed` on a card as one captured CUDA graph a pow2
    row bucket and input dtype (the JAX package's jitted pipelined
    forward, one program a padded shape).

    A batch of ``n`` rows is copied into its bucket's static input
    (rows past ``n`` keep whatever an earlier batch left; each row is
    computed on its own), the bucket's graph is replayed (its first use
    runs the eager forward, then captures it), and the first ``n`` rows
    of the graph's output are copied out on the stream right after the
    replay: the next replay of the bucket overwrites the static output
    while an earlier batch may still be in flight. The chain kernels'
    K ranges are fixed by K, so a row's bits do not depend on its
    batch: the graphed forward equals the eager one bit for bit.
    Slots on several cards are refused (a graph belongs to one card)."""

    def __init__(self, placed: PlacedPipeline, num_microbatches: int):
        if not placed.mesh.on_one_card:
            raise ValueError(
                "a captured pipelined forward needs every slot on one card, got "
                f"{sorted(map(str, placed.mesh.devices))}")
        self.placed = placed
        self.num_microbatches = int(num_microbatches)
        #: (bucket rows, dtype) -> (static input, GraphedStep)
        self.graphs: dict = {}

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        n = int(x.shape[0])
        if n == 0:
            return run_placed(self.placed, x, self.num_microbatches)
        key = (row_bucket(n), x.dtype)
        entry = self.graphs.get(key)
        if entry is None:
            static = torch.zeros((key[0], x.shape[1]), dtype=x.dtype, device=self.placed.device)
            # No reference back to self: graphs are freed by reference count.
            graph = GraphedStep(
                functools.partial(run_placed, self.placed, static, self.num_microbatches),
                self.placed.device)
            entry = self.graphs[key] = (static, graph)
        static, graph = entry
        static[:n].copy_(x, non_blocking=True)
        return graph()[:n].clone()


def _host_rows(meta: PipelineMeta, x, device: torch.device) -> torch.Tensor:
    x = np.asarray(x, np.float32)
    _check_input(meta, x)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def pipeline_forward(mesh: Mesh, params: PipelineParams, x, *, num_microbatches: int = 1,
                     logits: bool = False) -> torch.Tensor:
    """Run the pipelined forward over ``x: (N, in_dim)`` -> ``(N,
    final_dim)`` float32 on the first slot's device (the chain kernel
    on a card, its plain version on the CPU)."""
    _check_stage_count(mesh, params.meta)
    placed = place_pipeline(mesh, params, logits=logits)
    return run_placed(placed, _host_rows(params.meta, x, placed.device), num_microbatches)


def pipeline_forward_interleaved(mesh: Mesh, params: PipelineParams, x, *, num_virtual: int,
                                 num_microbatches: int = 1,
                                 logits: bool = False) -> torch.Tensor:
    """:func:`pipeline_forward`'s virtual-stage twin: the meta's ``V``
    chunks on ``V / num_virtual`` stage slots."""
    check_chunk_count(params.meta.num_stages, mesh.shape[AXIS_STAGE], num_virtual)
    placed = place_pipeline(mesh, params, num_virtual=num_virtual, logits=logits)
    return run_placed(placed, _host_rows(params.meta, x, placed.device), num_microbatches)


def pipeline_forward_quantized(mesh: Mesh, qweights: dict, meta: PipelineMeta, x, *,
                               num_microbatches: int = 1) -> torch.Tensor:
    """:func:`pipeline_forward`'s int8 twin over ``quantize_pipeline_weights``'
    blocks (the int8 chain kernel on a card)."""
    _check_stage_count(mesh, meta)
    placed = place_pipeline_quantized(mesh, qweights, meta)
    return run_placed(placed, _host_rows(meta, x, placed.device), num_microbatches)


def pipeline_forward_interleaved_quantized(mesh: Mesh, qweights: dict, meta: PipelineMeta, x,
                                           *, num_virtual: int,
                                           num_microbatches: int = 1) -> torch.Tensor:
    """:func:`pipeline_forward_interleaved`'s int8 twin."""
    check_chunk_count(meta.num_stages, mesh.shape[AXIS_STAGE], num_virtual)
    placed = place_pipeline_quantized(mesh, qweights, meta, num_virtual=num_virtual)
    return run_placed(placed, _host_rows(meta, x, placed.device), num_microbatches)


# ---------------------------------------------------------------------------
# Export and summaries
# ---------------------------------------------------------------------------

def pad_blocks(meta: PipelineMeta, chunks, key_w: str = "w", key_b: str = "b",
               identity: bool = True) -> PipelineWeights:
    """The inverse of placement: per-chunk layer lists (``chunks[c]``,
    tensors or numpy) back into padded ``(S, L, D, D)`` / ``(S, L, D)``
    numpy float32, with identity filler (``identity``) or zeros."""
    S, L, D = meta.num_stages, meta.layers_per_stage, meta.max_dim
    w = np.zeros((S, L, D, D), np.float32)
    b = np.zeros((S, L, D), np.float32)
    for s in range(S):
        real = meta.num_layers(s)
        for li in range(L):
            if li < real:
                fi, fo = meta.in_width[s][li], meta.width[s][li]
                layer = chunks[s][li]
                w[s, li, :fi, :fo] = _host(layer[key_w])
                b[s, li, :fo] = _host(layer[key_b])
            elif identity:
                w[s, li] = np.eye(D, dtype=np.float32)
    return PipelineWeights(w=w, b=b)


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def extract_model(params: PipelineParams, template: ModelSpec, distribution) -> ModelSpec:
    """Slice trained stage blocks back into a ModelSpec (``template``
    gives the structure: activations, type tags)."""
    weights, meta = params
    validate_distribution(distribution, len(template.layers))
    if len(distribution) != meta.num_stages:
        raise ValueError(
            f"distribution has {len(distribution)} stages but params were "
            f"built with {meta.num_stages}"
        )
    idx = 0
    for si, count in enumerate(int(d) for d in distribution):
        for li in range(count):
            tl = template.layers[idx]
            if (tl.in_dim, tl.out_dim) != (meta.in_width[si][li], meta.width[si][li]):
                raise ValueError(
                    f"template layer {idx} has dims ({tl.in_dim}, {tl.out_dim}) but "
                    f"stage {si} slot {li} was built as "
                    f"({meta.in_width[si][li]}, {meta.width[si][li]})"
                )
            idx += 1
    w = np.asarray(weights.w, np.float64)
    b = np.asarray(weights.b, np.float64)
    new_layers = []
    idx = 0
    for si, count in enumerate(int(d) for d in distribution):
        for li in range(count):
            old = template.layers[idx]
            new_layers.append(dataclasses.replace(
                old,
                weights=w[si, li, : old.in_dim, : old.out_dim].copy(),
                biases=b[si, li, : old.out_dim].copy(),
            ))
            idx += 1
    return ModelSpec(layers=new_layers, metadata=dict(template.metadata))


def pipeline_spec_summary(params: PipelineParams) -> dict:
    """Placement summary (the reference orchestrator's spawn log,
    run_grpc_fcnn.py:133-143)."""
    meta = params.meta
    return {
        "num_stages": meta.num_stages,
        "layers_per_stage": meta.layers_per_stage,
        "padded_width": meta.max_dim,
        "input_dim": meta.in_dim,
        "output_dim": meta.final_dim,
    }


"""Stage slots: the port's counterpart of the JAX device mesh.

Port of :mod:`tpu_dist_nn.parallel.mesh` for the pipelines and the
Megatron split. The
JAX package runs every stage as one SPMD program over a
``jax.sharding.Mesh``; the port runs one process that drives a grid of
**stage slots**. A slot is a device plus its own CUDA stream: each
stage's kernels are issued on its slot's stream, and a stage hands its
output to the next after a CUDA event (with a device-to-device copy
when the next slot is another card). A card named more than once gets
one slot (one stream) per mention, so one H100 can run a multi-stage
schedule, as the JAX tests run one on eight virtual host devices. CPU
slots have no stream: their ops run in issue order.

Slots sit on the ``(stage, data, seq, model, expert)`` axes of the JAX
mesh, in its device order ``(data, seq, stage, model, expert)``: data
outermost, expert innermost, so slot ``(s, d, q, m, x)`` is
``devices[(((d * seq + q) * stage + s) * model + m) * expert + x]``.
``seq_slots[s][d][q]`` holds the model slots of seq shard ``q`` of the
``(stage, data)`` cell at expert shard 0; ``model_slots[s][d]`` is seq
shard 0's and ``slots[s][d]`` its model slot 0 (the cell's lead).
``expert_slots[s][d][q][m]`` holds the expert shards of slot ``(s, d, q,
m)``, the first being ``seq_slots[s][d][q][m]``. With ``expert == 1``
(the default) the grid is the ``(stage, data, seq, model)`` one; with
``seq == 1`` too the Megatron ``(stage, data, model)`` one, and with
``model == 1`` as well the ``(stage, data)`` one of the dense pipelines.

Under expert parallelism a cell's shards are its ``(expert, seq)``
pairs, expert-major (:meth:`Mesh.shards`): the batch splits over
``(data, expert)`` jointly, data-major, as the JAX package's
``P((data, expert))`` does, and each shard holds one routing group.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from tpu_dist_nn_torch.utils.device import resolve_device

AXIS_STAGE = "stage"
AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"
AXIS_EXPERT = "expert"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Pipeline stages x data replicas x model (tensor-parallel) shards x
    seq (sequence-parallel) shards x expert shards; the product must fit
    the slots."""

    stage: int = 1
    data: int = 1
    model: int = 1
    seq: int = 1
    expert: int = 1

    @property
    def num_devices(self) -> int:
        return self.stage * self.data * self.model * self.seq * self.expert


@dataclasses.dataclass(frozen=True)
class StageSlot:
    """One stage's place: its device and (on a card) its own stream."""

    device: torch.device
    stream: "torch.cuda.Stream | None"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(stage, data, seq, model, expert)`` grid of :class:`StageSlot`:
    ``seq_slots[s][d][q][m]`` (expert shard 0); ``model_slots[s][d]`` is
    ``seq_slots[s][d][0]`` and ``slots[s][d]`` is ``model_slots[s][d][0]``;
    ``expert_slots[s][d][q][m][x]`` every slot (None when ``expert == 1``)."""

    spec: MeshSpec
    seq_slots: tuple[tuple[tuple[tuple[StageSlot, ...], ...], ...], ...]
    expert_slots: tuple | None = None

    @functools.cached_property
    def model_slots(self) -> tuple[tuple[tuple[StageSlot, ...], ...], ...]:
        """Each ``(stage, data)`` cell's model slots of seq shard 0."""
        return tuple(tuple(cell[0] for cell in row) for row in self.seq_slots)

    @functools.cached_property
    def slots(self) -> tuple[tuple[StageSlot, ...], ...]:
        """Each ``(stage, data)`` cell's lead slot (seq and model shard 0)."""
        return tuple(tuple(cell[0] for cell in row) for row in self.model_slots)

    def seq_leads(self, s: int, d: int) -> tuple[StageSlot, ...]:
        """The lead (model shard 0) of each seq shard of cell ``(s, d)``."""
        return tuple(shard[0] for shard in self.seq_slots[s][d])

    def shard_model_slots(self, s: int, d: int) -> tuple[tuple[StageSlot, ...], ...]:
        """Cell ``(s, d)``'s shards, ``(expert, seq)`` pairs expert-major,
        each as the tuple of its model slots."""
        X, Q, N = self.spec.expert, self.spec.seq, self.spec.model
        if self.expert_slots is None:
            return tuple(self.seq_slots[s][d])
        return tuple(tuple(self.expert_slots[s][d][q][m][x] for m in range(N))
                     for x in range(X) for q in range(Q))

    def shards(self, s: int, d: int) -> tuple[StageSlot, ...]:
        """The lead (model shard 0) of each of cell ``(s, d)``'s shards."""
        return tuple(row[0] for row in self.shard_model_slots(s, d))

    def cell(self, s: int, d: int):
        """Where :func:`~tpu_dist_nn_torch.parallel.gpipe.launch` issues
        cell ``(s, d)``'s ops: its lead slot, or with seq or expert shards
        the tuple of their leads (:meth:`shards`)."""
        if self.spec.seq == 1 and self.spec.expert == 1:
            return self.slots[s][d]
        return self.shards(s, d)

    @property
    def all_slots(self) -> list[StageSlot]:
        """Every slot, in grid order."""
        if self.expert_slots is not None:
            return [slot for row in self.expert_slots for cell in row for shard in cell
                    for model in shard for slot in model]
        return [slot for row in self.seq_slots for cell in row for shard in cell
                for slot in shard]

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes by name, as ``jax.sharding.Mesh.shape`` gives them."""
        return {AXIS_STAGE: self.spec.stage, AXIS_DATA: self.spec.data,
                AXIS_MODEL: self.spec.model, AXIS_SEQ: self.spec.seq,
                AXIS_EXPERT: self.spec.expert}

    @property
    def devices(self) -> set[torch.device]:
        """The distinct devices of the slots."""
        return {slot.device for slot in self.all_slots}

    @property
    def on_one_card(self) -> bool:
        """Every slot on one CUDA card: where a step or a forward over
        the slots can be one CUDA graph (a graph and its memory pool
        belong to one card)."""
        devices = self.devices
        return len(devices) == 1 and next(iter(devices)).type == "cuda"


def visible_devices(device=None) -> list[torch.device]:
    """The default placement: every visible card once (``device`` None
    or a CUDA device), or the one CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def build_mesh(spec: MeshSpec, devices=None) -> Mesh:
    """Build the ``(stage, data, seq, model, expert)`` slot grid from
    ``devices`` (default: :func:`visible_devices`). Each CUDA slot gets a
    new stream, so a card listed k times carries k streams. Raises when
    fewer devices are given than ``stage x data x model x seq x expert``,
    as the JAX ``build_mesh`` does."""
    devices = visible_devices() if devices is None else [resolve_device(d) for d in devices]
    if spec.num_devices > len(devices):
        axes = f"{spec.stage} stage x {spec.data} data"
        if spec.model != 1:
            axes += f" x {spec.model} model"
        if spec.seq != 1:
            axes += f" x {spec.seq} seq"
        if spec.expert != 1:
            axes += f" x {spec.expert} expert"
        raise ValueError(
            f"mesh spec needs {spec.num_devices} devices ({axes}) but only "
            f"{len(devices)} are available"
        )

    def slot(dev: torch.device) -> StageSlot:
        if dev.type != "cuda":
            return StageSlot(dev, None)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return StageSlot(dev, torch.cuda.Stream(device=dev))

    flat = [slot(d) for d in devices[: spec.num_devices]]
    S, D, N, Q, X = spec.stage, spec.data, spec.model, spec.seq, spec.expert
    full = tuple(tuple(tuple(tuple(tuple(flat[(((d * Q + q) * S + s) * N + m) * X + x]
                                         for x in range(X)) for m in range(N))
                             for q in range(Q)) for d in range(D)) for s in range(S))
    grid = tuple(tuple(tuple(tuple(shard[0] for shard in seq) for seq in cell) for cell in row)
                 for row in full)
    return Mesh(spec, grid, full if X > 1 else None)

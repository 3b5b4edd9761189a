"""Stage slots: the port's counterpart of the JAX device mesh.

Port of :mod:`tpu_dist_nn.parallel.mesh` for the dense pipeline. The
JAX package runs every stage as one SPMD program over a
``jax.sharding.Mesh``; the port runs one process that drives a grid of
**stage slots**. A slot is a device plus its own CUDA stream: each
stage's kernels are issued on its slot's stream, and a stage hands its
output to the next after a CUDA event (with a device-to-device copy
when the next slot is another card). A card named more than once gets
one slot (one stream) per mention, so one H100 can run a multi-stage
schedule, as the JAX tests run one on eight virtual host devices. CPU
slots have no stream: their ops run in issue order.

Slots sit on the ``(stage, data)`` axes of the JAX mesh, in its device
order: data outermost, so slot ``(s, d)`` is ``devices[d * stage + s]``.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_dist_nn_torch.utils.device import resolve_device

AXIS_STAGE = "stage"
AXIS_DATA = "data"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Pipeline stages x data replicas; the product must fit the slots."""

    stage: int = 1
    data: int = 1

    @property
    def num_devices(self) -> int:
        return self.stage * self.data


@dataclasses.dataclass(frozen=True)
class StageSlot:
    """One stage's place: its device and (on a card) its own stream."""

    device: torch.device
    stream: "torch.cuda.Stream | None"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(stage, data)`` grid of :class:`StageSlot`: ``slots[s][d]``."""

    spec: MeshSpec
    slots: tuple[tuple[StageSlot, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes by name, as ``jax.sharding.Mesh.shape`` gives them."""
        return {AXIS_STAGE: self.spec.stage, AXIS_DATA: self.spec.data}


def visible_devices(device=None) -> list[torch.device]:
    """The default placement: every visible card once (``device`` None
    or a CUDA device), or the one CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def build_mesh(spec: MeshSpec, devices=None) -> Mesh:
    """Build the ``(stage, data)`` slot grid from ``devices`` (default:
    :func:`visible_devices`). Each CUDA slot gets a new stream, so a
    card listed k times carries k streams. Raises when fewer devices are
    given than ``stage x data``, as the JAX ``build_mesh`` does."""
    devices = visible_devices() if devices is None else [resolve_device(d) for d in devices]
    if spec.num_devices > len(devices):
        raise ValueError(
            f"mesh spec needs {spec.num_devices} devices ({spec.stage} stage x "
            f"{spec.data} data) but only {len(devices)} are available"
        )

    def slot(dev: torch.device) -> StageSlot:
        if dev.type != "cuda":
            return StageSlot(dev, None)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return StageSlot(dev, torch.cuda.Stream(device=dev))

    flat = [slot(d) for d in devices[: spec.num_devices]]
    grid = tuple(tuple(flat[d * spec.stage + s] for d in range(spec.data))
                 for s in range(spec.stage))
    return Mesh(spec, grid)

"""Scenario-parallel entry points: one planner step for a batch of scenarios,
on one device or split over a mesh of devices.

The scenarios are independent, so the batch is a leading axis of every
tensor; the encoder weights and the robot geometry are shared.

* ``batched_planner_step`` — the step on one device (the JAX package's
  vmap of ``pan_forward``).
* ``sharded_planner_step`` — the step with the scenario axis split over a
  ``Mesh``, the counterpart of the JAX package's ``shard_map``. Nothing
  crosses devices inside the step, so one process drives every device:
  it issues each shard's batched step on that shard's device, one after
  another, and the cards run them concurrently (the launches are
  asynchronous). ``torch.distributed`` is not used: it needs a process per
  rank, and NCCL refuses two ranks on one card, which a mesh that names
  one device several times (``Mesh((cuda:0,) * 4)``, the analogue of the
  JAX suite's virtual host devices) needs.

Outputs stay split: each field of the returned ``PANOutput`` (and of its
``state``) is a ``Sharded``, which the next step takes where it lies;
``gather`` concatenates them on one device.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

import torch

from neupan_torch.ops.nrmp import AdjustParams
from neupan_torch.ops.pan import PANOutput, PANSpec, PANState, init_state, pan_forward


def batched_init_state(spec: PANSpec, batch: int, device=None) -> PANState:
    """The empty state of ``batch`` scenarios on ``device`` (None = the card)."""
    one = init_state(spec, device)
    return PANState(*(v.expand((batch,) + v.shape).clone() for v in one))


def batched_planner_step(spec: PANSpec, encoder, vertices: torch.Tensor,
                         G: torch.Tensor, h: torch.Tensor, adjust: AdjustParams,
                         nom_s, nom_u, ref_s, ref_us, points, velocities, mask,
                         state: PANState) -> PANOutput:
    """The full PAN control step for a batch of scenarios.

    Every tensor argument but the shared encoder, robot geometry (vertices,
    G, h) and ``adjust`` carries a leading batch dimension; all must sit on
    one device.
    """
    return pan_forward(spec, encoder, vertices, G, h, adjust, nom_s, nom_u,
                       ref_s, ref_us, points, velocities, mask, state)


def _device(d) -> torch.device:
    """``d`` as a torch.device with its index filled in for a card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the devices that the scenario axis is split over, in
    order. A device may repeat (``Mesh((torch.device("cpu"),) * 8)``): its
    shards then run one after another on it. Holds the replicas of the
    shared weights, one per distinct device (``replicated_sharding``)."""

    devices: Tuple[torch.device, ...]
    axis_name: str = "scenario"
    _replicas: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                        compare=False)

    def __post_init__(self):
        devices = tuple(_device(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devices)

    def __len__(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "scenario") -> Mesh:
    """The first ``n_devices`` CUDA cards (all of them by default) as a mesh.
    Raises where there is no card, or fewer than asked for; a mesh of other
    devices is built with ``Mesh`` itself."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh takes CUDA cards and none is available; build the mesh from explicit "
            "devices to run elsewhere, e.g. Mesh((torch.device('cpu'),) * 8)")
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"asked for {n} CUDA devices, {count} present")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis_name)


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A tensor split along its leading axis: shard i lies on the mesh's
    device i."""

    shards: Tuple[torch.Tensor, ...]

    def __len__(self) -> int:
        return len(self.shards)

    @property
    def shape(self) -> torch.Size:
        first = self.shards[0].shape
        return torch.Size((sum(s.shape[0] for s in self.shards),) + tuple(first[1:]))

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first shard's)."""
        device = self.shards[0].device if device is None else device
        return torch.cat([s.to(device) for s in self.shards])


def _is_tuple_of_fields(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def gather(x, device=None):
    """``x`` with every ``Sharded`` in it (a NamedTuple such as ``PANOutput``
    is gathered field by field) concatenated on ``device``."""
    if isinstance(x, Sharded):
        return x.gather(device)
    if _is_tuple_of_fields(x):
        return type(x)(*(gather(v, device) for v in x))
    return x


@dataclasses.dataclass(frozen=True)
class ScenarioSharding:
    """Split axis 0 into ``len(mesh)`` equal shards, one per device (the
    JAX package's ``NamedSharding(mesh, P("scenario"))``)."""

    mesh: Mesh

    def put(self, x):
        """A tensor as a ``Sharded``; a ``Sharded`` moved shard by shard where
        a shard is not on its device (no copy where it is); a NamedTuple
        field by field; None as None."""
        if x is None:
            return None
        n = len(self.mesh)
        if isinstance(x, Sharded):
            if len(x) != n:
                raise ValueError(f"{len(x)} shards for a mesh of {n} devices")
            return Sharded(tuple(s.to(d) for s, d in zip(x.shards, self.mesh.devices)))
        if _is_tuple_of_fields(x):
            return type(x)(*(self.put(v) for v in x))
        B = x.shape[0]
        if B % n:
            raise ValueError(f"the scenario axis ({B}) does not split evenly over "
                             f"{n} devices")
        return Sharded(tuple(c.to(d) for c, d in zip(torch.split(x, B // n),
                                                      self.mesh.devices)))


@dataclasses.dataclass(frozen=True)
class Replicated:
    """One copy per distinct device of the mesh (the JAX package's
    ``NamedSharding(mesh, P())``)."""

    mesh: Mesh

    def put(self, x) -> tuple:
        """Entry i is ``x`` on the mesh's device i; entries on one device are
        one object. A tensor or module already on a device is used there as
        it is; other copies are cached on the mesh, keyed by the storage
        and version counter of each parameter, so an update in place (a
        trained or tuned encoder) is copied again. A tensor that records a
        gradient is copied at each call (``.to`` keeps the graph); a module
        copy carries no gradient back to its original."""
        copies = {d: self._copy(x, d) for d in dict.fromkeys(self.mesh.devices)}
        return tuple(copies[d] for d in self.mesh.devices)

    def _copy(self, x, device: torch.device):
        if x is None:
            return None
        if _is_tuple_of_fields(x):
            return type(x)(*(self._copy(v, device) for v in x))
        module = isinstance(x, torch.nn.Module)
        tensors = list(x.parameters()) + list(x.buffers()) if module else [x]
        if all(t.device == device for t in tensors):
            return x
        if not module and x.requires_grad and torch.is_grad_enabled():
            return x.to(device)
        stamp = tuple((t.data_ptr(), t._version) for t in tensors)
        key = (id(x), device)
        hit = self.mesh._replicas.get(key)
        if hit is not None and hit[0] is x and hit[1] == stamp:
            return hit[2]
        with torch.no_grad():
            rep = copy.deepcopy(x).to(device) if module else x.to(device)
        self.mesh._replicas[key] = (x, stamp, rep)
        return rep


def scenario_sharding(mesh: Mesh, axis_name: str = "scenario") -> ScenarioSharding:
    if axis_name != mesh.axis_name:
        raise ValueError(f"the mesh's axis is {mesh.axis_name!r}, not {axis_name!r}")
    return ScenarioSharding(mesh)


def replicated_sharding(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


def _as_sharded(outputs):
    """Per-shard outputs (NamedTuples of tensors) as one NamedTuple of
    ``Sharded`` fields."""
    first = outputs[0]
    if first is None:
        return None
    if _is_tuple_of_fields(first):
        return type(first)(*(_as_sharded(list(v)) for v in zip(*outputs)))
    return Sharded(tuple(outputs))


def sharded_planner_step(spec: PANSpec, mesh: Mesh, encoder, vertices, G, h,
                         adjust: AdjustParams, nom_s, nom_u, ref_s, ref_us, points,
                         velocities, mask, state: PANState,
                         axis_name: str = "scenario") -> PANOutput:
    """``batched_planner_step`` with the scenario axis split over ``mesh``.

    The per-scenario arguments may be whole tensors (split on entry; the
    batch must divide by ``len(mesh)``) or ``Sharded`` ones (used where
    they lie, as a chained step passes ``out.state``); the encoder, the
    geometry and ``adjust`` are replicated, once per distinct device. Each
    shard runs the batched step on its device, so each kernel launches
    ``len(mesh)`` times as often as in one batched step. Returns a
    ``PANOutput`` of ``Sharded`` fields (``opt_d`` None without obstacle
    slots). A loss on the gathered outputs differentiates in ``adjust`` as
    the batched step's does.
    """
    split = scenario_sharding(mesh, axis_name)
    per = [split.put(a) for a in (nom_s, nom_u, ref_s, ref_us, points, velocities, mask)]
    state = split.put(state)
    repl = replicated_sharding(mesh)
    shared = [repl.put(a) for a in (encoder, vertices, G, h, adjust)]
    outs = [batched_planner_step(spec, *(s[i] for s in shared), *(a.shards[i] for a in per),
                                 PANState(*(v.shards[i] for v in state)))
            for i in range(len(mesh))]
    return _as_sharded(outs)

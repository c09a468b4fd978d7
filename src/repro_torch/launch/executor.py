"""Executor layer of the port: where a session's physical batches go and
how the flat accumulator is summed across ranks, as the reference
package's ``launch/executor.py``, over ``torch.distributed``.

  * :class:`LocalExecutor` — one process: a physical batch moves to the
    session's device whole, and :meth:`~LocalExecutor.reduce` returns the
    accumulator untouched.  The default, and exactly what the session did
    before this layer existed.
  * :class:`MeshExecutor` — one process per rank of a named-axis mesh
    (``torch.distributed`` must be initialised, one rank per mesh point).
    The ``dp`` layout: params replicated (broadcast from rank 0 once), each
    physical batch split by rows over the mesh as the reference's
    ``batch_spec`` splits it (:meth:`~MeshExecutor.split_axes`), and the
    flat accumulator summed over the ranks that hold different rows, once
    per logical batch, by a fixed-order fold
    (:func:`~repro_torch.utils.collectives.fold_sum_`).  Every rank then
    applies the same noisy update with the same key to the same sum, so the
    noise is drawn once per step, not once per rank, and no second
    collective is needed.

Select one with :class:`LaunchConfig`::

    LaunchConfig()                  # local
    LaunchConfig(mesh=(4,))         # 4 ranks over "data" (under torchrun)
    LaunchConfig(mesh="test")       # 2 x 2 ("data", "model")

The ``dp_sp`` and ``2d`` layouts and per-example grads stored in bf16
(``pe_bf16``) are not ported: asking for them raises.  The pod presets
resolve to their shapes and raise when built with fewer ranks.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Optional, Tuple, Union

import torch

from ..utils import collectives

# the reference's production geometry (``launch/mesh.py``): 16 x 16 = 256
# chips a pod, two pods multi-pod
POD_SHAPE = ((16, 16), ("data", "model"))
MULTIPOD_SHAPE = ((2, 16, 16), ("pod", "data", "model"))

MESH_PRESETS = {
    "local": None,
    "test": ((2, 2), ("data", "model")),
    "production": POD_SHAPE,
    "production-multipod": MULTIPOD_SHAPE,
}
_DEFAULT_AXES = {1: ("data",), 2: ("data", "model"),
                 3: ("pod", "data", "model")}
LAYOUTS = ("dp", "dp_sp", "2d")
PORTED_LAYOUTS = ("dp",)
_KNOWN_AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    """Where and how a session executes: mesh (preset name or shape), axis
    names, layout, and per-example-grad storage dtype."""
    mesh: Union[str, Tuple[int, ...], None] = None   # None/"local" => local
    axes: Optional[Tuple[str, ...]] = None           # for tuple mesh shapes
    layout: str = "dp"                               # dp | dp_sp | 2d
    pe_bf16: bool = False                            # store pe grads in bf16

    def validate(self) -> "LaunchConfig":
        if self.layout not in LAYOUTS:
            raise ValueError(f"Unknown layout {self.layout!r}; "
                             f"expected one of {LAYOUTS}")
        self.resolved()
        return self

    def resolved(self) -> Tuple[Optional[Tuple[int, ...]],
                                Optional[Tuple[str, ...]]]:
        """(mesh shape, axis names) — (None, None) means local execution."""
        mesh = self.mesh
        if mesh is None:
            return None, None
        if isinstance(mesh, str):
            if mesh not in MESH_PRESETS:
                raise ValueError(
                    f"Unknown mesh preset {mesh!r}; expected one of "
                    f"{sorted(MESH_PRESETS)} or an explicit shape tuple.")
            preset = MESH_PRESETS[mesh]
            if preset is None:
                return None, None
            return preset
        shape = tuple(int(s) for s in mesh)
        axes = self.axes if self.axes is not None \
            else _DEFAULT_AXES.get(len(shape))
        if axes is None or len(axes) != len(shape):
            raise ValueError(
                f"mesh shape {shape} needs {len(shape)} axis names; got "
                f"axes={self.axes!r} (defaults exist for 1-3 axes).")
        return shape, tuple(axes)

    @property
    def is_local(self) -> bool:
        return self.resolved()[0] is None

    def mesh_shape(self) -> Optional[dict]:
        """axis -> size, without touching any process group (cost models
        describe meshes far larger than the host with it)."""
        shape, axes = self.resolved()
        if shape is None:
            return None
        return dict(zip(axes, shape))

    def build_mesh(self) -> Optional["RankMesh"]:
        """This rank's place in the mesh; raises unless the initialised
        process group has exactly one rank per mesh point."""
        shape, axes = self.resolved()
        if shape is None:
            return None
        need = math.prod(shape)
        dist = torch.distributed
        have = dist.get_world_size() if dist.is_initialized() else 0
        if have != need:
            raise RuntimeError(
                f"mesh {dict(zip(axes, shape))} needs {need} ranks but "
                f"torch.distributed has "
                f"{have if have else 'no process group'}: launch one "
                f"process per rank (torchrun --nproc-per-node {need}) and "
                f"call repro_torch.launch.executor.init_distributed() "
                f"first; the mesh is never cut to the ranks found.")
        return RankMesh(shape, axes, dist.get_rank())


def parse_mesh(text: Optional[str]):
    """A ``--mesh`` value: a preset name, or a shape such as ``4`` or
    ``2x2``."""
    if text is None or text in MESH_PRESETS:
        return text
    try:
        return tuple(int(s) for s in text.split("x"))
    except ValueError:
        raise ValueError(f"--mesh {text!r} is neither a preset "
                         f"{sorted(MESH_PRESETS)} nor a shape such as 4 or "
                         f"2x2") from None


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """One rank's view of the mesh: rank r sits at the row-major
    coordinates of r over ``axes``."""
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    rank: int

    @property
    def size(self) -> dict:
        return dict(zip(self.axes, self.shape))

    def coords(self, rank: Optional[int] = None) -> dict:
        r = self.rank if rank is None else rank
        out = {}
        for axis, n in reversed(list(zip(self.axes, self.shape))):
            r, out[axis] = divmod(r, n)
        return {a: out[a] for a in self.axes}

    def block(self, split: Tuple[str, ...]) -> int:
        """Row-major index of this rank's coordinates over the ``split``
        axes: which block of a split batch it holds."""
        c, b = self.coords(), 0
        for a in split:
            b = b * self.size[a] + c[a]
        return b

    def peers(self, split: Tuple[str, ...]):
        """For each way of fixing the axes outside ``split``, the ranks that
        vary only along ``split``, in rank order (= block order)."""
        fixed = [a for a in self.axes if a not in split]
        groups = {}
        for r in range(math.prod(self.shape)):
            c = self.coords(r)
            groups.setdefault(tuple(c[a] for a in fixed), []).append(r)
        return list(groups.values())


def init_distributed(device="cuda", backend: Optional[str] = None
                     ) -> torch.device:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
    return this rank's device: ``cuda:LOCAL_RANK`` for ``"cuda"`` (made the
    current device), the device as given when it names an index or the
    CPU.  The backend is NCCL on the card and gloo on the CPU unless
    ``backend`` names one; a failure raises (nothing falls back to one
    process or another backend)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the ranks on the CPU over gloo")
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not torch.distributed.is_initialized():
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"torch.distributed needs {missing} in the environment: "
                f"launch under torchrun")
        torch.distributed.init_process_group(
            backend, init_method="env://",
            timeout=datetime.timedelta(seconds=600))
    return dev


class Executor:
    """Owns placement of physical batches and the reduction of the flat
    accumulator; the session never touches ranks itself."""

    world = 1
    rank = 0

    def local_rows(self, bsz: int) -> slice:
        """The rows of a physical batch of ``bsz`` this rank holds."""
        return slice(0, bsz)

    def move(self, data, mask, device):
        """Host (or device) arrays -> ``device``, rows unchanged."""
        return ({k: torch.as_tensor(v).to(device, non_blocking=True)
                 for k, v in data.items()},
                torch.as_tensor(mask).to(device, non_blocking=True))

    def place(self, data, mask, device):
        """One whole physical batch -> this rank's rows on ``device``."""
        return self.move(data, mask, device)

    def place_state(self, state):
        return state

    def place_cache(self, cache, batch_size: int):
        """A serving pool's decode cache of ``batch_size`` slots -> where
        the decode step reads it: where ``init_cache`` made it, one
        process."""
        return cache

    def reduce(self, flat: torch.Tensor) -> torch.Tensor:
        """The flat partial sum of this rank's rows -> the logical batch's
        sum, once per logical batch, before the update."""
        return flat

    def describe(self) -> dict:
        raise NotImplementedError


class LocalExecutor(Executor):
    """One process, one device: batches move whole and ``reduce`` returns
    its argument (no copy, no rounding)."""

    def __init__(self, launch: Optional[LaunchConfig] = None):
        self.launch = launch if launch is not None else LaunchConfig()

    def describe(self) -> dict:
        return {"executor": "local"}


class MeshExecutor(Executor):
    """One rank of a mesh in the ``dp`` layout (see the module docstring).

    Placement follows the reference's ``batch_spec`` for ``dp``: a batch
    that divides by the whole mesh is split over every axis; else one that
    divides by the data axes (``pod``, ``data``) or by ``data`` alone is
    split over those and replicated over the rest; else every rank holds
    the whole batch.  The fold then runs over the ranks that differ only
    along the split axes, so ranks holding the same rows are not summed
    twice."""

    def __init__(self, launch: LaunchConfig):
        launch.validate()
        if launch.is_local:
            raise ValueError("LaunchConfig resolves to local execution; "
                             "use LocalExecutor (via build_executor).")
        require_ported(launch)
        unknown = [a for a in launch.resolved()[1] if a not in _KNOWN_AXES]
        if unknown:
            raise ValueError(
                f"MeshExecutor's sharding rules know the axes "
                f"{_KNOWN_AXES}; got unknown axes {unknown}. Name the "
                f"LaunchConfig axes accordingly — arbitrary names are only "
                f"for LaunchConfig.mesh_shape() cost descriptions.")
        self.launch = launch
        self.layout = launch.layout
        self.mesh = launch.build_mesh()
        self.world = math.prod(self.mesh.shape)
        self.rank = self.mesh.rank
        self._groups = {}
        # the split of the logical batch being accumulated; a reduce closes
        # it, and the next placement opens the next one
        self._pending: Optional[Tuple[str, ...]] = None
        self._closed = False

    # -- placement ---------------------------------------------------------

    def split_axes(self, bsz: int) -> Tuple[str, ...]:
        """The mesh axes a physical batch of ``bsz`` rows is split over
        (the reference's ``MeshExecutor.batch_spec`` in ``dp``, falling
        back to ``utils/sharding.batch_pspec``)."""
        size, axes = self.mesh.size, self.mesh.axes
        if bsz % self.world == 0:
            return axes
        data = tuple(a for a in ("pod", "data") if a in size)
        if data and bsz % math.prod(size[a] for a in data) == 0:
            return data
        if "data" in size and bsz % size["data"] == 0:
            return ("data",)
        return ()

    def local_rows(self, bsz: int) -> slice:
        split = self.split_axes(bsz)
        if self._closed:
            self._pending, self._closed = None, False
        if self._pending is not None and split != self._pending:
            raise ValueError(
                f"a logical batch mixes physical batches split over "
                f"{self._pending} and {split}; the fold needs one split per "
                f"logical batch (keep the physical batch size fixed)")
        self._pending = split
        n = math.prod(self.mesh.size[a] for a in split)
        b, per = self.mesh.block(split), bsz // n
        return slice(b * per, (b + 1) * per)

    def place(self, data, mask, device):
        rows = self.local_rows(len(mask))
        return self.move({k: v[rows] for k, v in data.items()}, mask[rows],
                         device)

    def place_state(self, state):
        """Params replicated: every rank takes rank 0's."""
        if self.world > 1:
            for p in state.params.values():
                torch.distributed.broadcast(p, src=0)
        return state

    def place_cache(self, cache, batch_size: int):
        """Serving across ranks is not ported: refuse rather than serve on
        one rank."""
        raise NotImplementedError(
            "serving on a mesh is not ported yet (ROADMAP queue 1 item 5: "
            "the cache sharded over the mesh); serve with a local executor")

    # -- the reduction -----------------------------------------------------

    def _group(self, split: Tuple[str, ...]):
        """The process group of ranks that differ only along ``split``
        (created once per split, by every rank together)."""
        if split == self.mesh.axes:
            return None                           # the default group
        if split not in self._groups:
            mine, _ = torch.distributed.new_subgroups_by_enumeration(
                self.mesh.peers(split))
            self._groups[split] = mine
        return self._groups[split]

    def reduce(self, flat: torch.Tensor) -> torch.Tensor:
        """Fold the ranks' partial sums in rank order, in place; a batch
        held whole by every rank (no split) is already the sum."""
        split = self.mesh.axes if self._pending is None else self._pending
        self._closed = True
        if not split:
            return flat
        return collectives.fold_sum_(flat, self._group(split))

    def describe(self) -> dict:
        return {"executor": "mesh", "mesh": self.mesh.size,
                "layout": self.layout}


def require_ported(launch: LaunchConfig) -> LaunchConfig:
    """Raise for what the port does not run yet: a mesh in another layout
    than ``dp``, and per-example grads stored in bf16."""
    if not launch.is_local and launch.layout not in PORTED_LAYOUTS:
        raise NotImplementedError(
            f"layout {launch.layout!r} is not ported yet (ROADMAP queue 1 "
            f"item 5: sequence parallelism over 'model' and FSDP + TP); "
            f"the port runs {PORTED_LAYOUTS}")
    if launch.pe_bf16:
        raise NotImplementedError(
            "pe_bf16 (per-example grads stored in bf16) is not ported")
    return launch


def build_executor(launch: Optional[LaunchConfig]) -> Executor:
    """The one place an executor is chosen from a LaunchConfig."""
    launch = launch if launch is not None else LaunchConfig()
    launch.validate()          # local configs are validated too
    if launch.is_local:
        return LocalExecutor(require_ported(launch))
    return MeshExecutor(launch)

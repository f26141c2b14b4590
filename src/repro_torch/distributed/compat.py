"""The port's ``shard_map`` and collectives, for one controlling process.

Ported from ``repro.distributed.compat``, whose ``shard_map`` shim runs a
body once per device under XLA, with collectives as stage boundaries
inside it.  Here one Python process drives every coordinate of a
:class:`~repro_torch.distributed.meshctx.Mesh`:

* :class:`Sharded` is a value split along one dimension over the mesh:
  one tensor per coordinate, each on its coordinate's device.
* :class:`Replicated` is a value placed once per *distinct* device; on a
  repeated-device mesh it is one tensor.
* :func:`shard_map` loops a body over the shards of a split (the mesh
  coordinates that vary only along its axes, in shard order), handing
  each its index and device, and returns the per-shard results for the
  caller to combine.
* :func:`psum`, :func:`pmax`, :func:`all_gather` and :func:`all_to_all`
  combine per-coordinate tensors: each copies its inputs to the target
  device and reduces them **in shard order**, with no float atomics and
  no process group, so a call gives the same bits every time.  A body
  that needs a collective mid-way is written as two stages around it.
  :func:`all_reduce` and :func:`exchange` give every member of a group
  its own result (the partitioned dense layers' row-parallel sums and
  their head / sequence all-to-alls), each member's work at its
  coordinate.

Copies between distinct devices go through ``Tensor.to``; nothing here
assumes the devices differ.

For a recorder (``launch/op_analysis.py``), :func:`shard_map` runs body
``i`` at its coordinate (:func:`at`), a :class:`Sharded` built by a
sharding (``NamedSharding.place`` / ``cut``) knows each block's
coordinate (``coords``), so per-block loops can do the same, and each
collective reports its per-shard operand bytes under the reference's
HLO name (``all-reduce``, ``all-gather``, ``all-to-all``).  Without a
recorder these cost one global read.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..kernels import work as _work
from .meshctx import Mesh

_NOWHERE = contextlib.nullcontext()


def at(coord):
    """A context that runs its body at mesh coordinate ``coord`` for the
    active recorder (none: the recorder's home coordinate).  ``coord``
    may be a tuple of coordinates instead: one body that stands for each
    of them, counted at every one (``distributed/tensor_parallel.py``'s
    class dispatch on a ``meta`` mesh)."""
    rec = _work.RECORDER
    if rec is None or coord is None:
        return _NOWHERE
    if coord and isinstance(coord[0], tuple):
        return rec.at(coord)
    return rec.at((coord,))


def record_collective(kind: str, xs) -> None:
    """Report a collective over the per-shard operands ``xs`` to the
    active recorder (none: nothing)."""
    rec = _work.RECORDER
    if rec is not None:
        rec.collective(kind, xs)


def record_collective_at(kind: str, sent) -> None:
    """Report a collective's ``(coordinate, tensor)`` pairs (an iterable,
    read only inside a recorder) to the active recorder: each tensor's
    bytes to that coordinate alone, its sender (for a piece read from the
    traced coordinate that stands for an untraced sender,
    ``distributed/tensor_parallel.py``)."""
    rec = _work.RECORDER
    if rec is not None:
        rec.collective_at(kind, sent)


class Sharded:
    """A value split into blocks, block i on its own device.  ``dim`` is
    the split dimension, or a tuple of them (a spec that splits several
    dimensions); ``grid`` the number of blocks along each, row-major
    (default: every block along the one ``dim``), which is the order of
    :meth:`Mesh.shard_coords` over the spec's axes.  ``shape`` is the
    whole value's; numpy reads (``np.asarray``) concatenate the blocks on
    the host.  ``coords``: each block's mesh coordinate, where a sharding
    placed it (else None)."""
    __slots__ = ("shards", "dim", "grid", "coords")

    def __init__(self, shards: Sequence[torch.Tensor], dim=0, grid=None,
                 coords=None):
        self.shards = tuple(shards)
        self.dim = dim
        self.grid = (len(self.shards),) if grid is None else tuple(grid)
        self.coords = None if coords is None else tuple(coords)
        if int(np.prod(self.grid, dtype=np.int64)) != len(self.shards):
            raise ValueError(f"Sharded: {len(self.shards)} blocks for a "
                             f"grid of {self.grid}")

    def like(self, shards: Sequence[torch.Tensor]) -> "Sharded":
        """New blocks laid out as these (dim, grid, coordinates)."""
        return Sharded(shards, self.dim, self.grid, self.coords)

    def block_coords(self) -> tuple:
        """Each block's coordinate (None where unknown)."""
        return self.coords or (None,) * len(self.shards)

    @property
    def dims(self) -> Tuple[int, ...]:
        return tuple(self.dim) if isinstance(self.dim, tuple) else (
            self.dim,)

    @property
    def shape(self) -> torch.Size:
        s = list(self.shards[0].shape)
        for k, (d, g) in enumerate(zip(self.dims, self.grid)):
            stride = int(np.prod(self.grid[k + 1:], dtype=np.int64))
            s[d] = sum(int(self.shards[j * stride].shape[d])
                       for j in range(g))
        return torch.Size(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shards[0].shape)

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(t.device for t in self.shards)

    def block_slices(self) -> List[Tuple[slice, ...]]:
        """Block i's place in the whole value: one slice per dimension,
        for every block in order."""
        out = []
        for j, t in enumerate(self.shards):
            sl = [slice(None)] * t.dim()
            for d, i in zip(self.dims, np.unravel_index(j, self.grid)):
                n = int(t.shape[d])
                sl[d] = slice(int(i) * n, (int(i) + 1) * n)
            out.append(tuple(sl))
        return out

    def gather(self, device) -> torch.Tensor:
        """The whole value on ``device`` (blocks concatenated in order)."""
        return _cat_grid([t.to(device) for t in self.shards], self.dims,
                         self.grid, torch.cat)

    def select(self, j: int) -> "Sharded":
        """Index ``j`` of dimension 0, which must not be a split one
        (a fused window's step axis)."""
        if 0 in self.dims:
            raise ValueError("Sharded.select indexes an unsplit leading dim")
        dim = (self.dim - 1 if isinstance(self.dim, int)
               else tuple(d - 1 for d in self.dim))
        return Sharded([t[j] for t in self.shards], dim, self.grid,
                       self.coords)

    def __array__(self, dtype=None, copy=None):
        a = _cat_grid([t.detach().cpu().numpy() for t in self.shards],
                      self.dims, self.grid, np.concatenate)
        return a if dtype is None else a.astype(dtype)

    def __repr__(self) -> str:
        return (f"Sharded(shape={tuple(self.shape)}, dim={self.dim}, "
                f"grid={self.grid}, "
                f"devices={[str(d) for d in self.devices]})")


def _cat_grid(blocks: list, dims: Sequence[int], grid: Sequence[int], cat):
    """Row-major ``blocks`` over ``grid`` joined along ``dims`` with
    ``cat(list, dim)`` (``torch.cat`` or ``np.concatenate``)."""
    if not dims:
        return blocks[0]
    n = len(blocks) // grid[0]
    return cat([_cat_grid(blocks[i * n:(i + 1) * n], dims[1:], grid[1:],
                          cat) for i in range(grid[0])], dims[0])


class Replicated:
    """One copy of a value per distinct device (insertion order = the
    mesh's).  ``value`` is the first copy; numpy reads read it."""
    __slots__ = ("copies",)

    def __init__(self, copies: Dict[torch.device, torch.Tensor]):
        self.copies = dict(copies)

    @property
    def value(self) -> torch.Tensor:
        return next(iter(self.copies.values()))

    def on(self, device) -> torch.Tensor:
        return self.copies[torch.device(device)]

    @property
    def shape(self) -> torch.Size:
        return self.value.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.value.dtype

    @property
    def ndim(self) -> int:
        return self.value.dim()

    def __array__(self, dtype=None, copy=None):
        a = self.value.detach().cpu().numpy()
        return a if dtype is None else a.astype(dtype)

    def __repr__(self) -> str:
        return (f"Replicated(shape={tuple(self.shape)}, devices="
                f"{[str(d) for d in self.copies]})")


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def split(x, devices: Sequence[torch.device], dim: int = 0) -> Sharded:
    """``x`` (a tensor, or numpy) cut into ``len(devices)`` equal blocks
    along ``dim``, block i copied to ``devices[i]``."""
    x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    n = len(devices)
    if x.shape[dim] % n:
        raise ValueError(f"split: dim {dim} of {tuple(x.shape)} does not "
                         f"divide into {n} shards")
    return Sharded([b.to(d, non_blocking=True)
                    for b, d in zip(x.chunk(n, dim), devices)], dim)


def split_grid(x: torch.Tensor, dims: Sequence[int], grid: Sequence[int],
               devices: Sequence[torch.device], copy: bool = False,
               coords=None) -> Sharded:
    """``x`` cut into ``grid[k]`` equal blocks along each ``dims[k]``,
    row-major, block i copied to ``devices[i]`` (``copy=True``: a block of
    its own even where it lies already, so it holds no view of ``x``;
    ``coords``: the blocks' mesh coordinates, each copy made there)."""
    blocks = [x]
    for d, g in zip(dims, grid):
        if x.shape[d] % g:
            raise ValueError(f"split_grid: dim {d} of {tuple(x.shape)} "
                             f"does not divide into {g} blocks")
        blocks = [c for b in blocks for c in b.chunk(g, d)]
    if len(blocks) != len(devices):
        raise ValueError(f"split_grid: {len(blocks)} blocks for "
                         f"{len(devices)} devices")
    out = []
    for b, dev, c in zip(blocks, devices, coords or [None] * len(blocks)):
        with at(c):
            b = b.to(dev, copy=copy)
            out.append(b.contiguous() if copy else b)
    dim = dims[0] if len(dims) == 1 else tuple(dims)
    return Sharded(out, dim, grid, coords)


def replicate(x: torch.Tensor, devices: Sequence[torch.device]
              ) -> Replicated:
    """``x`` placed once per distinct device of ``devices`` (a copy only
    where ``x`` does not already lie)."""
    return Replicated({d: x.to(d) for d in dict.fromkeys(devices)})


def local(x, i: int, device) -> Any:
    """Coordinate ``i``'s view of ``x`` on ``device``: its block of a
    :class:`Sharded`, its device's copy of a :class:`Replicated`, or a
    plain tensor moved there (a no-op where it lies already)."""
    if isinstance(x, Sharded):
        return x.shards[i]
    if isinstance(x, Replicated):
        return x.on(device)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return x


def to_home(x, device) -> Any:
    """``x`` as one tensor on ``device`` (a :class:`Sharded` gathered, a
    :class:`Replicated` read from its first copy)."""
    if isinstance(x, Sharded):
        return x.gather(device)
    if isinstance(x, Replicated):
        return x.value.to(device)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return x


def host_copy(x) -> torch.Tensor:
    """``x`` whole on the host, in memory of its own (a :class:`Sharded`
    gathered in shard order, a :class:`Replicated`'s first copy)."""
    if isinstance(x, Sharded):
        return x.gather("cpu").detach()
    if isinstance(x, Replicated):
        x = x.value
    return torch.as_tensor(x).detach().to("cpu", copy=True)


# ---------------------------------------------------------------------------
# collectives (fixed shard order)
# ---------------------------------------------------------------------------

def psum(xs: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """``xs[0] + xs[1] + ...`` on ``device`` (default ``xs[0]``'s), summed
    left to right."""
    record_collective("all-reduce", xs)
    device = xs[0].device if device is None else device
    out = xs[0].to(device)
    for x in xs[1:]:
        out = out + x.to(device)
    return out


def pmax(xs: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    record_collective("all-reduce", xs)
    device = xs[0].device if device is None else device
    out = xs[0].to(device)
    for x in xs[1:]:
        out = torch.maximum(out, x.to(device))
    return out


def all_gather(xs: Sequence[torch.Tensor], dim: int = 0,
               device=None) -> torch.Tensor:
    """The blocks concatenated along ``dim`` in shard order."""
    record_collective("all-gather", xs)
    device = xs[0].device if device is None else device
    return torch.cat([x.to(device) for x in xs], dim)


def all_to_all(xs: Sequence[torch.Tensor], split_dim: int = 0,
               concat_dim: int = 0) -> List[torch.Tensor]:
    """Shard i cuts its tensor into ``len(xs)`` blocks along
    ``split_dim`` and sends block j to shard j; shard j concatenates what
    it receives along ``concat_dim`` in sender order, on its own device
    (``jax.lax.all_to_all(tiled=True)``)."""
    record_collective("all-to-all", xs)
    n = len(xs)
    blocks = [x.chunk(n, split_dim) for x in xs]
    return [torch.cat([blocks[i][j].to(xs[j].device) for i in range(n)],
                      concat_dim) for j in range(n)]


def all_reduce(xs: Sequence[torch.Tensor], coords: Sequence,
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The sum of ``xs`` for every member, as a reduce-scatter then an
    all-gather: member j sums block j of the flattened operands left to
    right at its coordinate (in f32 for a 16-bit dtype, rounded once), then
    each member concatenates the blocks on its device.  Every element is
    summed in shard order, so each member's result is the same bits every
    call.  ``coords[j]``: member j's coordinate (or the coordinates it
    stands for, :func:`at`)."""
    record_collective("all-reduce", xs)
    n, shape, dtype = len(xs), xs[0].shape, xs[0].dtype
    acc = (torch.float32 if dtype in (torch.bfloat16, torch.float16)
           else dtype)
    chunks = []
    for x, c in zip(xs, coords):
        with at(c):
            chunks.append(x.reshape(-1).tensor_split(n))
    parts = []
    for j in range(n):
        with at(coords[j]):
            s = None
            for ch in chunks:
                b = ch[j].to(devices[j])
                s = b.to(acc) if s is None else s + b
            parts.append(s.to(dtype))
    out = []
    for j in range(n):
        with at(coords[j]):
            out.append(torch.cat([p.to(devices[j]) for p in parts])
                       .view(shape))
    return out


def exchange(pieces: Sequence[Sequence[Tuple[int, torch.Tensor]]],
             coords: Sequence, devices: Sequence[torch.device], dim: int,
             kind: str = "all-to-all") -> List[Any]:
    """A general all-to-all within one group: ``pieces[j]`` lists
    ``(i, t)``, the tensors member j receives, in order, each ``t`` held
    by member i.  Member j concatenates its pieces along ``dim`` on its
    device at its coordinate (None where it receives nothing; a lone
    piece of its own stays a view).  Each piece sent to another member
    counts to its sender under ``kind``."""
    record_collective(kind, [t for j, ps in enumerate(pieces)
                             for i, t in ps if i != j])
    out = []
    for j, ps in enumerate(pieces):
        with at(coords[j]):
            if not ps:
                out.append(None)
            elif len(ps) == 1 and ps[0][0] == j:
                out.append(ps[0][1])
            else:
                out.append(torch.cat([t.to(devices[j]) for _, t in ps],
                                     dim))
    return out


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------

def shard_map(f: Callable, mesh: Mesh, axes: Sequence[str]) -> List[Any]:
    """``f(i, device)`` once per shard ``i`` of a value split over
    ``axes`` (the coordinates of ``Mesh.shard_coords``, in shard order),
    on that coordinate's device; returns the per-shard results for the
    caller's collectives.  Body ``i`` runs :func:`at` its coordinate."""
    out = []
    for i, c in enumerate(mesh.shard_coords(axes)):
        with at(c):
            out.append(f(i, mesh.device_at(c)))
    return out


def abstract_mesh(axis_sizes: Sequence[int],
                  axis_names: Sequence[str]) -> Mesh:
    """A device-free mesh (shape and names only): the sharding rules'
    input, as the reference's ``AbstractMesh``."""
    return Mesh(None, axis_names, axis_sizes)

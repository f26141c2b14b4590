"""Device meshes and the mesh policy context.

Ported from ``repro.distributed.meshctx``.  The reference's mesh is a
``jax.sharding.Mesh`` driven by one process (single controller).  The
port keeps that shape: :class:`Mesh` is an n-d array of
``torch.device``\\ s with axis names, and one process drives every
coordinate of it (``distributed.compat`` loops a body over the
coordinates and combines their results with fixed-order collectives).

A mesh may repeat a device.  A *debug mesh* of four entries may be four
times ``cpu`` (the CPU tests) or four times ``cuda:0`` (one card): the
counterpart of the reference's ``--xla_force_host_platform_device_count``.
Values sharded over such a mesh still get one tensor per coordinate;
replicated values are placed once per *distinct* device, so on a
repeated-device mesh a replicated leaf is one tensor and costs no memory.

Model code is written against *logical* parallelism (batch axes, a model
axis, an optional sequence axis).  A :class:`MeshPolicy` installed with
:func:`use_policy` (or passed down explicitly) selects the explicit
mesh branches the reference writes itself: the expert-parallel MoE
(``models.moe.moe_ffn_sharded``) and the sequence-parallel decode
attention (``models.attention``).  With no policy every module runs its
single-device path.

Dense layers.  The reference leaves their tensor parallelism to XLA's
SPMD partitioner, which has no PyTorch counterpart; the port writes it
out.  A policy with a rule table (``rules``, the reference's
``make_rules``) over a stack whose every layer is GQA attention or a
Mamba2 layer with a dense, MoE or no FFN
(``distributed.sharding.dense_layout``: llama3-8b, starcoder2-3b,
gemma2-9b, deepseek-7b, pixtral-12b, phi3.5-MoE, mamba2-1.3b, jamba)
runs ``prefill`` and ``decode_step`` partitioned by those rules on
params, cache and batch placed by them
(``distributed.sharding.place_params`` / ``place_cache`` /
``place_batch``): each coordinate computes its batch rows, its query
heads, its MLP columns, its experts (the expert body on its data
shard's own tokens), its SSM heads and its vocab rows, with fixed-order
collectives between (``distributed/tensor_parallel.py``).  Any other
stack (MLA, cross-attention), training, and a policy without
rules keep the dense layers whole on the mesh's home device, the
explicit branches above splitting what they split.
:func:`constrain` places nothing: the partitioned loop lays out its
activations itself, one tensor per coordinate.

Training's hot-expert plan (the reference's ``_MOE_HOT`` global) stays
an argument of the trainer's step, as elsewhere in the port.
"""
from __future__ import annotations

import contextlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def _indexed(d) -> torch.device:
    """``d`` as a device that compares equal to its tensors' devices
    (``"cuda"`` -> ``cuda:<current>``)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """An n-d array of ``torch.device``\\ s with one name per axis.

    ``devices=None`` makes an *abstract* mesh (shape and names only),
    enough for the sharding rules.  ``shape`` maps axis name -> size, as
    the reference's ``mesh.shape``."""

    def __init__(self, devices, axis_names: Sequence[str],
                 axis_sizes: Optional[Sequence[int]] = None):
        self.axis_names = tuple(axis_names)
        if devices is None:
            if axis_sizes is None:
                raise ValueError("an abstract mesh needs axis_sizes")
            self.devices = None
            sizes = tuple(int(s) for s in axis_sizes)
        else:
            arr = np.empty(np.shape(np.array(devices, dtype=object)),
                           dtype=object)
            flat = np.array(devices, dtype=object).reshape(-1)
            arr.reshape(-1)[:] = [_indexed(d) for d in flat]
            self.devices = arr
            sizes = arr.shape
        if len(sizes) != len(self.axis_names):
            raise ValueError(f"mesh of shape {sizes} needs "
                             f"{len(sizes)} axis names, got "
                             f"{self.axis_names}")
        self.shape = OrderedDict(zip(self.axis_names, sizes))
        self._shard_coords: dict = {}       # axes -> shard_coords(axes)

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values()), dtype=np.int64))

    @property
    def device_list(self) -> Tuple[torch.device, ...]:
        """Every coordinate's device, in row-major coordinate order."""
        return tuple(self.devices.reshape(-1))

    @property
    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """The distinct devices, in order of first appearance."""
        return tuple(dict.fromkeys(self.device_list))

    @property
    def home(self) -> torch.device:
        """The first coordinate's device: where the controller gathers
        what it reads (outputs, merged sketches)."""
        return self.device_list[0]

    def device_at(self, coord) -> torch.device:
        return self.devices[tuple(coord)]

    def coords(self) -> Tuple[Tuple[int, ...], ...]:
        """Every coordinate, row-major."""
        return tuple(np.ndindex(*self.shape.values()))

    def axis_index(self, coord, axes: Sequence[str]) -> int:
        """Row-major index of ``coord`` over the axes ``axes`` (the
        shard number of a value split over them)."""
        idx = 0
        for a in axes:
            i = self.axis_names.index(a)
            idx = idx * self.shape[a] + coord[i]
        return idx

    def shard_coords(self, axes: Sequence[str]) -> Tuple[Tuple[int, ...], ...]:
        """One coordinate per shard of a value split over ``axes``: those
        that vary only along ``axes`` (every other axis at 0), in shard
        order (:meth:`axis_index` over ``axes``)."""
        key = tuple(axes)
        if key not in self._shard_coords:
            others = [k for k, a in enumerate(self.axis_names)
                      if a not in axes]
            cs = [c for c in self.coords()
                  if all(c[k] == 0 for k in others)]
            self._shard_coords[key] = tuple(
                sorted(cs, key=lambda c: self.axis_index(c, axes)))
        return self._shard_coords[key]

    def axes_size(self, axes: Sequence[str]) -> int:
        n = 1
        for a in axes:
            n *= self.shape[a]
        return n

    def __repr__(self) -> str:
        devs = (None if self.devices is None
                else [str(d) for d in self.device_list])
        return f"Mesh({dict(self.shape)}, devices={devs})"


@dataclass(frozen=True)
class MeshPolicy:
    """The reference's policy, less what only its SPMD partitioner reads
    (the FSDP and sequence axes, the decode attention implementation,
    the MoE implementation): the port's explicit branches read the mesh,
    the batch axes and the model axis, and the partitioned dense layers
    the rule table (``rules``; None keeps them on the home device)."""
    mesh: Optional[Mesh] = None
    batch_axes: Tuple[str, ...] = ("data",)   # activations' batch sharding
    model_axis: str = "model"                 # TP / EP / sequence axis
    rules: Optional[dict] = field(default=None, compare=False)

    @property
    def n_model(self) -> int:
        if self.mesh is None:
            return 1
        return self.mesh.shape.get(self.model_axis, 1)

    @property
    def n_batch_shards(self) -> int:
        if self.mesh is None:
            return 1
        return self.mesh.axes_size(self.batch_axes)


def data_plane_mesh(n_devices: Optional[int] = None, axis: str = "data",
                    device="cuda") -> Optional[Mesh]:
    """One-dimensional serving mesh over the visible devices of
    ``device``'s type — the layout the sharded
    :class:`~repro_torch.core.runtime.MorpheusRuntime` expects (batch
    and sketches split over ``axis``, tables replicated).  ``None`` when
    one device (or the CPU) is all there is, so callers degrade to the
    single-device runtime with no special casing, as in the reference.
    A repeated-device mesh is built with :func:`~repro_torch.launch.\
mesh.make_debug_mesh` instead."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    if not torch.cuda.is_available():
        raise RuntimeError(
            "data_plane_mesh: CUDA is not available; pass device='cpu' "
            "(no mesh) or build a debug mesh")
    n = torch.cuda.device_count()
    if n_devices is not None:
        n = min(n, n_devices)
    if n <= 1:
        return None
    return Mesh([torch.device("cuda", i) for i in range(n)], (axis,))


_CURRENT: Optional[MeshPolicy] = None


def get_policy() -> Optional[MeshPolicy]:
    return _CURRENT


def set_policy(p: Optional[MeshPolicy]) -> None:
    global _CURRENT
    _CURRENT = p


@contextlib.contextmanager
def use_policy(p: Optional[MeshPolicy]):
    prev = get_policy()
    set_policy(p)
    try:
        yield p
    finally:
        set_policy(prev)


def constrain(x: torch.Tensor,
              logical_axes: Tuple[Optional[str], ...]) -> torch.Tensor:
    """The reference's activation sharding constraint, at the same
    points of the model code.  The port has no SPMD partitioner to pin:
    on the home layout activations stay whole on the mesh's home device
    (the explicit branches split what they split), and the partitioned
    dense loop holds one tensor per coordinate, laid out by its own
    code.  So this checks the logical axes against ``x``'s rank and
    returns ``x`` unchanged."""
    if len(logical_axes) != x.dim():
        raise ValueError(f"constrain: {len(logical_axes)} logical axes "
                         f"for a tensor of rank {x.dim()}")
    return x

"""Op-stream analysis: FLOPs, HBM traffic, collective bytes and live
memory of one step, per mesh coordinate, and its roofline on an H100.

The port's counterpart of ``repro.launch.hlo_analysis``.  The reference
re-walks XLA's optimised HLO text, with while-loop trip counts, because
``compiled.cost_analysis()`` visits a loop body once.  PyTorch has no
HLO and no compile: eager PyTorch runs the step's Python once and
dispatches each operation as it comes, fusing nothing.  So the port's
record of a step is the stream of operations it dispatches, caught by a
``TorchDispatchMode`` (:class:`Recorder`) entered around the real step,
on the card, on the host or on ``meta`` tensors (shapes, no memory, no
computation: the dry run's device).  A loop is then counted once per
trip by construction.

Counting rules, per operation:

* FLOPs: a product (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  ``convolution``, ``_scaled_dot_product_*``) counts 2 M N K, by
  ``torch.utils.flop_counter``'s formulas, kept by operand class
  (``kernels/work.flop_class``: bf16 / fp16, or f32, which runs on the
  CUDA cores since the port turns TF32 off).
* Bytes: its operands' bytes plus its result's bytes, the traffic each
  operation makes on the card with nothing fused.  Views, metadata
  operations and pure allocations (``empty``, ``empty_strided``) count
  0; fills count the bytes they write; ``copy_`` its source and its
  destination.  An operation on scalars alone (0-d tensors: the loss,
  the gradient norm, the optimizer's step counter, which a ``meta``
  state keeps on the host) counts no bytes.
* A hand-written kernel (``kernels/ops.py``) is one call with its own
  work (``kernels/work.py``), on any device; what runs inside it (the
  plain version on the host, the wrapper's allocations on the card) is
  not counted.
* Coordinates: an operation counts to the mesh coordinate of the
  ``compat.shard_map`` body (or per-block loop) it runs in, else to the
  mesh's home coordinate, where the port runs everything else.  A body
  that stands for several coordinates (``Recorder.at``: the
  partitioned dense loop's class dispatch on ``meta``) counts its
  operations, kernel calls, collective bytes and live storage at each.
* Collectives (``compat.psum`` / ``pmax`` / ``all_gather`` /
  ``all_to_all`` and the gradient cut of ``launch/steps.py``) count each
  shard's operand bytes to the coordinate that made it, under the
  reference's names.  The partitioned loop's collectives across model
  groups (``TPRun.gather_rows``, ``TPRun.psum_all``: the MoE decode
  body's tokens and the MoE metrics) count each traced operand at every
  coordinate its class stands for, so each coordinate counts what a
  full dispatch gives it; their sums run at the home coordinate.  Where
  coordinates of one class hold different blocks (a batch of 1, whose KV
  cache splits its slots over the data axes too), the loop runs at
  every coordinate and names each piece's sender
  (``TPRun.deliver`` writing a block, ``TPRun.gather_all`` receiving
  every block's attention partials; ``Recorder.collective_at``), so a
  piece counts at its sender once for each coordinate it goes to.  The
  Mamba layer's two exchanges over the model group (in-projection
  columns to conv blocks and heads; conv channels to heads, ``B`` and
  ``C`` all-gathered) are ``TPRun.exchange``\\ s, counted as the other
  all-to-alls.
* Live bytes: every storage an operation (or a kernel call) allocates
  is live from then until its last tensor, views included, is freed;
  the peak is kept per coordinate.  The step's arguments are not in it (``launch/dryrun.py``
  adds them).

The roofline takes the H100 SXM data sheet's dense peaks at 700 W:
989e12 bf16 FLOP/s on the tensor cores, 67e12 f32 FLOP/s on the CUDA
cores, 495e12 TF32 FLOP/s, 3.35e12 HBM bytes/s and 450e9 NVLink bytes/s
each way.  A 16 x 16 mesh spans more than one 8-card NVLink host, so
``t_collective`` is a lower bound there.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import Counter, defaultdict
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels import work as _work

BF16_FLOP_PER_S = 989e12       # H100 SXM, dense bf16 / fp16 tensor cores
F32_FLOP_PER_S = 67e12         # H100 SXM, f32 outside the tensor cores
TF32_FLOP_PER_S = 495e12       # H100 SXM, dense TF32 tensor cores
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
NVLINK_BYTES_PER_S = 450e9     # H100 SXM NVLink, each way
# seconds are FLOPs / PEAK_FLOPS[class] (kernels/work.py's classes)
PEAK_FLOPS = {"bf16": BF16_FLOP_PER_S, "f32": F32_FLOP_PER_S,
              "tf32x2": TF32_FLOP_PER_S / 2, "tf32x3": TF32_FLOP_PER_S / 3}
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# operations that move no bytes: metadata, host reads, pure allocations
_FREE = frozenset({
    "empty", "empty_strided", "empty_like", "new_empty",
    "new_empty_strided", "_local_scalar_dense", "lift_fresh", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
    "_has_compatible_shallow_copy_type", "set_", "resize_",
    "record_stream", "is_nonzero"})
# views whose schemas do not say so
_VIEWS = frozenset({"_unsafe_view", "alias", "lift_fresh"})
# operations that write their result and read nothing of their operands
_WRITE_ONLY = frozenset({
    "fill_", "zero_", "fill", "zeros", "ones", "full", "zeros_like",
    "ones_like", "full_like", "new_zeros", "new_ones", "new_full",
    "arange", "scalar_tensor", "randn", "rand", "normal_", "uniform_",
    "randn_like", "rand_like", "eye", "linspace"})


def _tensors(x, out=None) -> list:
    """The tensors in ``x`` (nested lists, tuples and dicts), in order."""
    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _NotMeta(Exception):
    """An operand that keeps an operation out of the meta memo."""


_KEY_TYPES = (int, float, bool, str, type(None), torch.dtype, torch.device,
              torch.layout, torch.memory_format)


def _meta_key(x):
    """A hashable image of an operation's arguments: a ``meta`` tensor by
    its shape, strides and dtype; a host or card tensor, or an argument
    of another kind, raises :class:`_NotMeta`."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise _NotMeta
        return ("T", tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_meta_key(y) for y in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _meta_key(v)) for k, v in x.items()))
    if isinstance(x, _KEY_TYPES):
        return (type(x).__name__, x)
    raise _NotMeta


def _out_spec(out):
    if isinstance(out, torch.Tensor):
        if out.device.type != "meta":
            raise _NotMeta
        return ("T", tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)):
        return (type(out),) + tuple(_out_spec(o) for o in out)
    return ("V", out)


def _from_spec(spec):
    if spec[0] == "T":
        return torch.empty_strided(spec[1], spec[2], dtype=spec[3],
                                   device="meta")
    if spec[0] == "V":
        return spec[1]
    return spec[0]([_from_spec(s) for s in spec[1:]])


class _Coord:
    """One coordinate's counts."""
    __slots__ = ("flops", "hbm_bytes", "per_collective", "live", "peak",
                 "ops")

    def __init__(self):
        self.flops: Counter = Counter()
        self.hbm_bytes = 0
        self.per_collective: Counter = Counter()
        self.live = 0
        self.peak = 0
        self.ops = 0


class Recorder(TorchDispatchMode):
    """Counts what the code run inside it dispatches (the module
    docstring's rules).  ``mesh``: the mesh the step runs on (its home
    coordinate takes what no shard body claims); None: one coordinate,
    ``()``.  ``host``: a device type (``"cpu"``) whose operations are the
    host's and count nothing, for a step whose work lies on another (the
    card, or ``meta`` standing for it): the schedule's scalars, the RNG
    states a remat saves.  Enter it around one step; read it with
    :func:`analyze`."""

    def __init__(self, mesh=None, host: Optional[str] = None):
        super().__init__()
        self.host = host
        self.home: Tuple[int, ...] = (
            () if mesh is None else (0,) * len(mesh.axis_names))
        # the coordinates an operation counts to: the home one, the
        # coordinate of the body it runs in, or every coordinate a class
        # body stands for (``at``)
        self.targets: Tuple[Tuple[int, ...], ...] = (self.home,)
        self.coords: Dict[Tuple[int, ...], _Coord] = defaultdict(_Coord)
        self.kernels: Dict[str, dict] = {}
        self._suppress = 0
        self._live: Dict[int, list] = {}    # storage -> [refs, targets, bytes]
        self._refs: Dict = {}               # weakref to a tensor -> storage
        self._info: Dict = {}
        self._meta_memo: Dict = {}
        self._prev = None

    # -- installation -----------------------------------------------------
    def __enter__(self):
        self._prev, _work.RECORDER = _work.RECORDER, self
        self.coords[self.home]          # the home coordinate always reports
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _work.RECORDER = self._prev

    @contextlib.contextmanager
    def at(self, coords):
        """A body that stands for each of ``coords`` (a tuple of
        coordinates, most often one): everything it does counts at every
        one of them (its FLOPs, bytes, kernel calls and collective bytes,
        and the storage it allocates, live at each)."""
        prev, self.targets = self.targets, tuple(map(tuple, coords))
        try:
            yield
        finally:
            self.targets = prev

    # -- live bytes -------------------------------------------------------
    def _track(self, t: torch.Tensor, targets, new: bool = True) -> None:
        """``t`` holds its storage live until it is freed; ``new=False``
        (a view's result) only where the storage is already tracked."""
        st = t.untyped_storage()
        key = st._cdata
        ent = self._live.get(key)
        if ent is None and not new:
            return
        if ent is None:
            ent = self._live[key] = [0, targets, st.nbytes()]
            for coord in targets:
                c = self.coords[coord]
                c.live += ent[2]
                c.peak = max(c.peak, c.live)
        ent[0] += 1
        ref = weakref.ref(t, self._release)
        self._refs[ref] = key

    def _release(self, ref) -> None:
        key = self._refs.pop(ref, None)
        ent = self._live.get(key)
        if ent is None:
            return
        ent[0] -= 1
        if ent[0] == 0:
            del self._live[key]
            for coord in ent[1]:
                self.coords[coord].live -= ent[2]

    def _targets_of(self, t: torch.Tensor):
        ent = self._live.get(t.untyped_storage()._cdata)
        return self.targets if ent is None else ent[1]

    # -- what the step reports --------------------------------------------
    @contextlib.contextmanager
    def kernel(self, name: str, work):
        """One hand-written kernel call of ``work`` (``kernels/work.py``)
        at the current coordinate; nothing dispatched inside counts, and
        the outputs the caller appends stay live."""
        if self._suppress:                  # a kernel inside a kernel
            yield []
            return
        outs: list = []
        self._suppress += 1
        try:
            yield outs
        finally:
            self._suppress -= 1
        targets = self.targets
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "flops_by_class": Counter(),
                                           "bytes": 0.0})
        for coord in targets:
            c = self.coords[coord]
            c.flops.update(work.flops)
            c.hbm_bytes += work.bytes
            k["calls"] += 1
            k["flops"] += work.total_flops
            k["flops_by_class"].update(work.flops)
            k["bytes"] += work.bytes
        for t in _tensors(outs):
            self._track(t, targets)

    def collective(self, kind: str, xs) -> None:
        """A collective over the per-shard operands ``xs``: each shard's
        bytes to the coordinate that made it (to each, for a class
        body's)."""
        if self._suppress:
            return
        for x in _tensors(list(xs)):
            n = _nbytes(x)
            for coord in self._targets_of(x):
                self.coords[coord].per_collective[kind] += n

    def collective_at(self, kind: str, sent) -> None:
        """A collective's ``(coordinate, tensor)`` pairs: each tensor's
        bytes to its coordinate alone."""
        if self._suppress:
            return
        for coord, x in sent:
            self.coords[tuple(coord)].per_collective[kind] += _nbytes(x)

    # -- the op stream ----------------------------------------------------
    def _op_info(self, func):
        info = self._info.get(func)
        if info is None:
            name = func.overloadpacket.__name__
            rets, params = func._schema.returns, func._schema.arguments
            aliases = (func.is_view or name in _VIEWS or any(
                r.alias_info is not None for r in rets))
            inplace = (len(rets) == 1 and rets[0].alias_info is not None
                       and rets[0].alias_info.is_write and params
                       and params[0].alias_info is not None
                       and params[0].alias_info.is_write
                       and name not in _FREE)
            info = (name, aliases, inplace, func.is_view or name in _FREE
                    or name in _VIEWS,
                    flop_registry.get(func.overloadpacket))
            self._info[func] = info
        return info

    def _run_meta(self, func, aliases: bool, inplace: bool, args, kwargs):
        """``func`` on ``meta`` tensors, its result's metadata memoised by
        the inputs': an operation that returns fresh tensors, or one that
        writes its first operand in place and returns it (``meta`` holds
        no values, so once such a call has passed its checks on these
        shapes, the next returns the operand)."""
        if aliases and not inplace:
            return func(*args, **kwargs)
        try:
            key = (func, _meta_key(args), _meta_key(kwargs))
        except _NotMeta:
            return func(*args, **kwargs)
        spec = self._meta_memo.get(key)
        if spec is not None:
            return args[0] if inplace else _from_spec(spec)
        out = func(*args, **kwargs)
        try:
            self._meta_memo[key] = True if inplace else _out_spec(out)
        except _NotMeta:                # a host result: never memoised
            pass
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name, aliases, inplace, free, flop_fn = self._op_info(func)
        out = self._run_meta(func, aliases, inplace, args, kwargs)
        if self._suppress:
            return out
        ins = _tensors(kwargs, _tensors(args))
        outs = _tensors(out)
        if self.host is not None and all(t.device.type == self.host
                                         for t in ins + outs):
            return out
        targets = self.targets
        flops = nbytes = 0
        if flop_fn is not None:
            flops = flop_fn(*args, **kwargs, out_val=out)
            cls = _work.flop_class(ins[0].dtype)
        if not free and any(t.dim() for t in ins + outs):
            if name in _WRITE_ONLY:
                nbytes = sum(map(_nbytes, outs))
            elif name == "copy_":
                nbytes = _nbytes(args[0]) + _nbytes(args[1])
            else:
                nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for coord in targets:
            c = self.coords[coord]
            c.ops += 1
            if flop_fn is not None:
                c.flops[cls] += flops
            c.hbm_bytes += nbytes
        if not inplace:         # a view (``_unsafe_view`` too) holds it
            for t in outs:
                self._track(t, targets, new=not aliases)
        return out


# ---------------------------------------------------------------------------
# reading a recorder
# ---------------------------------------------------------------------------

def compute_seconds(flops_by_class) -> float:
    """Each class's FLOPs at its own peak (``PEAK_FLOPS``)."""
    return sum(f / PEAK_FLOPS[c] for c, f in flops_by_class.items())


def bound(work) -> Tuple[float, str]:
    """``(seconds, "operations" | "bytes")``: the least time the card
    could take for ``work`` (``kernels/work.Work``), the larger of its
    FLOPs at their classes' peaks and its bytes at the HBM rate."""
    t_ops = compute_seconds(work.flops)
    t_bytes = work.bytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _coord_key(coord) -> str:
    return ",".join(str(i) for i in coord)


def analyze(rec: Recorder) -> dict:
    """The reference's keys for the most loaded coordinate (the largest
    ``max(t_compute, t_memory)``): ``flops``, ``hbm_bytes``,
    ``collective_bytes`` and ``per_collective``; and the port's:
    ``flops_by_class``, ``peak_live_bytes`` and ``output_live_bytes``
    (what stays live, allocated in the step) of that coordinate,
    ``coordinate``, ``kernels`` (name -> calls, flops, flops_by_class,
    bytes, over every coordinate) and ``per_coordinate`` (``"i,j"`` ->
    the same per-coordinate figures)."""
    per = {}
    for coord, c in sorted(rec.coords.items()):
        per[_coord_key(coord)] = {
            "flops": float(sum(c.flops.values())),
            "flops_by_class": dict(c.flops),
            "hbm_bytes": float(c.hbm_bytes),
            "collective_bytes": float(sum(c.per_collective.values())),
            "per_collective": {k: float(c.per_collective.get(k, 0))
                               for k in COLLECTIVES},
            "peak_live_bytes": float(c.peak),
            "output_live_bytes": float(c.live),
            "ops": c.ops,
        }

    def load(key):
        p = per[key]
        return max(compute_seconds(p["flops_by_class"]),
                   p["hbm_bytes"] / HBM_BYTES_PER_S)
    top = max(per, key=load)
    out = {k: per[top][k] for k in
           ("flops", "hbm_bytes", "collective_bytes", "per_collective",
            "flops_by_class", "peak_live_bytes", "output_live_bytes")}
    out["coordinate"] = top
    out["kernels"] = {n: {**k, "flops_by_class": dict(k["flops_by_class"])}
                      for n, k in sorted(rec.kernels.items())}
    out["per_coordinate"] = per
    return out


def roofline(analysis: dict) -> Dict[str, float]:
    """Seconds per step of the analysed coordinate, the reference's keys:
    compute (each FLOP class at its own peak), memory (HBM) and
    collective (NVLink) terms, and the dominant one."""
    t_compute = compute_seconds(analysis["flops_by_class"])
    t_memory = analysis["hbm_bytes"] / HBM_BYTES_PER_S
    t_coll = analysis["collective_bytes"] / NVLINK_BYTES_PER_S
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]
    return {"t_compute": t_compute, "t_memory": t_memory,
            "t_collective": t_coll, "dominant": dominant}

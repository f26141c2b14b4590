"""The per-coordinate program of a partitioned stack (GQA attention and
Mamba2 layers with dense, MoE or no FFNs).

The reference leaves a dense layer's tensor parallelism to XLA's SPMD
partitioner, which runs one program per device on the blocks the rules
give it.  The port writes that program out: one Python process runs it
for every coordinate of the mesh in turn, each on its own blocks, with
the fixed-order collectives of ``distributed/compat.py`` between the
stages.  :class:`TPRun` is one call's view of the mesh: the coordinates
it runs, their batch rows and model shards, every placed param and cache
leaf's block at each coordinate (checked against its spec first), and
the collectives: over each model group (all-reduce, all-to-all,
all-gather), over the batch rows (:meth:`TPRun.gather_rows`, the MoE
decode body's tokens), over every coordinate (:meth:`TPRun.psum_all`,
the MoE metrics) and from every coordinate to each
(:meth:`TPRun.gather_all`, a batch of 1's attention partials).  The
model code (``models/layers.py``, ``models/attention.py``,
``models/moe.py``, ``models/ssd.py``, ``models/transformer.py``) holds
its activations as ``{coordinate: tensor}``.  A Mamba layer's state
blocks are written only at the coordinates that hold them
(:meth:`TPRun.write_blocks`).

A batch of 1 (or any batch the batch axes do not divide) is not split:
every coordinate runs the same rows, the Mamba layers and the MoE psum
body repeat their work over the data axis, as XLA's replicated program
does, and the KV cache splits its slots over ``("data", "model")``
(``seq_kv``'s rule), so each coordinate attends its own block of slots
and receives its heads' partials from every block across model groups.

Class dispatch.  On a ``meta`` mesh the blocks hold no values, and every
coordinate that differs from another only along the batch axes computes
the same shapes: its rows are other rows of equal count, and every spec
this layout accepts splits nothing else over those axes, but for cache
blocks, which are written (and, at a batch of 1, the KV slots attended)
at every coordinate that holds one (:meth:`TPRun.every` for the
positions, :meth:`TPRun.write_blocks`, :meth:`TPRun.deliver`).  So the
dry run traces one model group, the coordinates at 0 on every other
axis, and the recorder counts each of its bodies at every coordinate it
stands for (``compat.at`` with a tuple of coordinates).  A collective across
model groups reads, for an untraced coordinate, the traced one that
stands for it (:attr:`TPRun.rep`), and its bytes count at every
coordinate each traced operand stands for, or at the sender it names,
so each coordinate counts what a full dispatch gives it.
``CLASS_DISPATCH = False`` traces every coordinate instead; the tests
hold the two to the same counts.  On a card or the host every coordinate
runs.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from ..models.params import flat_tree, unflat_tree
from . import compat
from .meshctx import MeshPolicy
from .sharding import NamedSharding, batch_shardings, cache_pspecs, \
    logical_axes, param_pspecs, serving_shardings

CLASS_DISPATCH = True     # on a meta mesh, one model group for all rows

Coord = Tuple[int, ...]


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _stands_for(members) -> Tuple[Coord, ...]:
    """The coordinates a ``members`` entry counts for: a class's tuple of
    coordinates, or one coordinate."""
    return members if members and isinstance(members[0], tuple) else (
        members,)


class TPRun:
    """One partitioned call over ``policy``'s mesh with a batch of ``B``
    rows, on ``params`` and ``cache`` placed by the policy's rules
    (``sharding.place_params`` / ``place_cache``; a leaf laid out
    otherwise raises ``ValueError``).

    * ``coords``: the coordinates the call runs, row-major; ``members[c]``
      what ``c`` counts for (``c`` itself, or its class on ``meta``).
    * ``groups``: ``coords`` cut into model groups (equal off the model
      axis), each in model order: the members of one collective.
    * ``rows(c)``: ``c``'s batch rows; ``B_l`` rows a coordinate, ``B``
      in all; ``n_batch`` the policy's batch shards (its ``batch_axes``).
    * ``rep[d]``: for every coordinate ``d`` of the mesh, the coordinate
      of ``coords`` that runs its program (``d`` itself, or its class).
    * ``params[c]`` / ``cache[c]``: nested dicts of ``c``'s blocks of
      every leaf (stacked leaves whole: index a layer with ``[i]``);
      ``param_sh`` / ``cache_sh`` the leaves' :class:`NamedSharding`\\ s.
    """

    def __init__(self, policy: MeshPolicy, B: int, params, cache):
        mesh, rules = policy.mesh, policy.rules
        self.mesh, self.model_axis = mesh, policy.model_axis
        if self.model_axis not in mesh.shape:
            raise ValueError(f"the mesh {dict(mesh.shape)} has no model "
                             f"axis {self.model_axis!r}")
        self._mi = mesh.axis_names.index(self.model_axis)
        self.n_model = mesh.shape[self.model_axis]
        row = batch_shardings({"rows": torch.empty((B,), device="meta")},
                              mesh, rules)["rows"]
        self.row_axes = _axes(row[0]) if row else ()
        self.n_rows = mesh.axes_size(self.row_axes)
        self.B, self.B_l = B, B // self.n_rows
        self.batch_axes = tuple(policy.batch_axes)
        self.n_batch = policy.n_batch_shards
        self.rules = rules
        self.param_sh, self.cache_sh = serving_shardings(params, cache,
                                                         mesh, rules)
        pflat, cflat = flat_tree(params), flat_tree(cache)
        psh, csh = flat_tree(self.param_sh), flat_tree(self.cache_sh)
        for flat, sh, pspecs, is_cache in (
                (pflat, psh, param_pspecs(params), False),
                (cflat, csh, cache_pspecs(cache), True)):
            axes = logical_axes(pspecs)
            for key, s in sh.items():
                self._check(key, flat[key], s, axes[key], is_cache)

        every = mesh.coords()
        if mesh.home.type == "meta" and CLASS_DISPATCH:
            self.coords = tuple(mesh.shard_coords((self.model_axis,)))
            self.members = {c: tuple(d for d in every
                                     if d[self._mi] == c[self._mi])
                            for c in self.coords}
        else:
            self.coords = tuple(every)
            self.members = {c: c for c in self.coords}
        self.rep = {d: c for c in self.coords for d in _stands_for(
            self.members[c])}
        groups: Dict[Coord, List[Coord]] = {}
        for c in self.coords:
            off = c[:self._mi] + c[self._mi + 1:]
            groups.setdefault(off, []).append(c)
        self.groups = [sorted(g, key=self.m) for g in groups.values()]
        self._cflat, self._csh = cflat, csh
        self.params = {c: unflat_tree({k: self._block(pflat[k], s, c)
                                       for k, s in psh.items()})
                       for c in self.coords}
        self.cache = {c: unflat_tree({k: self._block(cflat[k], s, c)
                                      for k, s in csh.items()})
                      for c in self.coords}

    # -- placement ---------------------------------------------------------
    def _check(self, key: str, leaf, sh: NamedSharding, logical,
               is_cache: bool) -> None:
        """``leaf`` lies as ``sh`` places it, and ``sh`` splits its
        ``"batch"`` dim over the rows' axes alone and every other dim over
        the model axis or nothing (what the per-row program and class
        dispatch assume).  Two exceptions, both cache leaves whose blocks
        are written at the coordinates that hold them: one without a
        batch dim, the cache's ``pos``, may split over the rows' axes
        too; and where the batch is not split (``row_axes == ()``, a
        batch of 1) the batch axes are free, so ``pos`` and the KV
        cache's ``seq_kv`` may split over them as well (the reference's
        256-way KV split at ``long_500k``).  A param split over the batch
        axes (the FSDP rules) raises ``NotImplementedError``: serving on
        FSDP-split params is not ported.  An expert stack (a leaf with an
        ``"experts"`` dim) must split its experts over the model axis,
        the MoE body's expert shards, and a Mamba leaf with an
        ``"ssm_heads"`` dim its heads (a model axis that does not divide
        them keeps them whole); any other placement of them raises
        ``NotImplementedError``."""
        if not sh.holds(leaf):
            raise ValueError(
                f"{key}: {leaf!r} is not placed by its spec {sh.spec} on "
                f"{self.mesh} (distributed.sharding.place_params / "
                f"place_cache / place_batch lay a tree out)")
        own = set(self.row_axes) | {self.model_axis}
        if not self.row_axes:               # a batch of 1: the axes are free
            own |= set(self.batch_axes)
        for d in range(len(logical)):
            axes = _axes(sh.spec[d] if d < len(sh.spec) else None)
            if (logical[d] == "ssm_heads" and self.n_model > 1
                    and axes != (self.model_axis,)):
                raise NotImplementedError(
                    f"{key}: spec {sh.spec} keeps the {leaf.shape[d]} SSM "
                    f"heads whole; the partitioned Mamba layer owns them in "
                    f"contiguous blocks over {self.model_axis!r}, so the "
                    f"rules must put 'ssm_heads' there and the model axis "
                    f"({self.n_model}) must divide them")
            if logical[d] == "batch":
                ok = axes == self.row_axes
            elif is_cache and ("batch" not in logical   # the positions
                               or (logical[d] == "seq_kv"
                                   and not self.row_axes)):
                ok = set(axes) <= own
            else:
                ok = axes in ((), (self.model_axis,))
            if ok and logical[d] == "experts" and axes != (
                    self.model_axis,):
                raise NotImplementedError(
                    f"{key}: spec {sh.spec} keeps the experts whole; the "
                    f"partitioned MoE body owns them in contiguous blocks "
                    f"over {self.model_axis!r}, so the rules must put "
                    f"'experts' there and the model axis must divide them")
            if ok:
                continue
            if not is_cache and logical[d] == "experts":
                raise NotImplementedError(
                    f"{key}: spec {sh.spec} splits the experts over "
                    f"{axes}; the partitioned MoE body owns them over "
                    f"{self.model_axis!r} alone")
            if not is_cache:
                raise NotImplementedError(
                    f"{key}: spec {sh.spec} splits dim {d} over {axes}; the "
                    f"partitioned dense loop splits params over "
                    f"{self.model_axis!r} alone (serving on FSDP-split "
                    f"params, make_rules(fsdp=True), is not ported)")
            raise NotImplementedError(
                f"{key}: spec {sh.spec} splits dim {d} over {axes}; the "
                f"partitioned dense loop splits the batch rows over "
                f"{self.row_axes} and everything else over "
                f"{self.model_axis!r} alone (a batch that does not "
                f"divide the batch axes is not ported)")

    def _block(self, leaf, sh: NamedSharding, c: Coord):
        dev = self.device(c)
        if isinstance(leaf, compat.Sharded):
            return leaf.shards[sh.index_at(c)].to(dev)
        if isinstance(leaf, compat.Replicated):
            return leaf.on(dev)
        return leaf.to(dev)

    # -- coordinates -------------------------------------------------------
    def device(self, c: Coord) -> torch.device:
        return self.mesh.device_at(c)

    def m(self, c: Coord) -> int:
        """``c``'s index along the model axis."""
        return c[self._mi]

    def rows(self, c: Coord) -> slice:
        r = self.mesh.axis_index(c, self.row_axes)
        return slice(r * self.B_l, (r + 1) * self.B_l)

    def each(self, fn: Callable[[Coord], object]) -> dict:
        """``{c: fn(c)}`` over ``coords``, each body at its coordinate."""
        out = {}
        for c in self.coords:
            with compat.at(self.members[c]):
                out[c] = fn(c)
        return out

    def every(self, fn: Callable[[Coord], object]) -> None:
        """``fn(c)`` at every coordinate of the mesh, class dispatch or
        not: for writes whose blocks differ along the batch axes (the
        cache's positions)."""
        for c in self.mesh.coords():
            with compat.at(c):
                fn(c)

    def cache_block(self, key: str, c: Coord):
        """Coordinate ``c``'s block of the placed cache leaf ``key``
        (``flat_tree``'s key), for any coordinate of the mesh."""
        return self._block(self._cflat[key], self._csh[key], c)

    def write_blocks(self, key: str, vals, i=None) -> None:
        """Every block of the placed cache leaf ``key`` (its layer ``i``
        of a stacked leaf), each once, at the coordinate ``o`` that holds
        it (a split leaf's blocks at their placement coordinates, a
        replicated leaf's copies at the first coordinate on each device),
        set to ``vals[rep[o]]``, the value of the traced coordinate that
        runs o's program (cast to the block's dtype), or zeroed where
        ``vals`` is None."""
        leaf, sh = self._cflat[key], self._csh[key]
        if isinstance(leaf, compat.Sharded):
            owned = zip(sh.coords, leaf.shards)
        else:
            first: Dict[torch.device, Coord] = {}
            for c in self.mesh.coords():
                first.setdefault(self.device(c), c)
            owned = ([(first[d], t) for d, t in leaf.copies.items()]
                     if isinstance(leaf, compat.Replicated)
                     else [(first[leaf.device], leaf)])
        for o, blk in owned:
            with compat.at(o):
                t = blk if i is None else blk[i]
                if vals is None:
                    t.zero_()
                else:
                    t.copy_(vals[self.rep[o]].to(t.dtype))

    @staticmethod
    def pieces(c: Coord, group, lo: int, hi: int, held: Callable,
               take: Callable) -> list:
        """``(member, tensor)`` pieces covering the range [lo, hi) of an
        index that each member ``g`` of ``group`` holds as ``held(g)`` =
        [a, b): c's own where it holds the index, else the first member
        in model order that does; ``take(src, i, j)`` is src's tensor of
        its local [i, j)."""
        out, i = [], lo
        while i < hi:
            src = c if held(c)[0] <= i < held(c)[1] else next(
                g for g in group if held(g)[0] <= i < held(g)[1])
            a, b = held(src)
            end = min(hi, b)
            out.append((src, take(src, i - a, end - a)))
            i = end
        return out

    def model_group(self, d: Coord) -> List[Coord]:
        """The mesh coordinates equal to ``d`` off the model axis, in
        model order (``d``'s model group, traced or not)."""
        return [d[:self._mi] + (j,) + d[self._mi + 1:]
                for j in range(self.n_model)]

    def deliver(self, dest: Coord, pieces, dim: int) -> torch.Tensor:
        """At mesh coordinate ``dest`` (traced or not): the ``(src,
        tensor)`` pieces (``src`` a mesh coordinate, the tensor its value,
        or the value of the traced coordinate that stands for it)
        concatenated along ``dim`` on ``dest``'s device; each piece from
        another coordinate counts to its ``src`` alone, as an
        all-to-all."""
        compat.record_collective_at("all-to-all", (
            (s, t) for s, t in pieces if s != dest))
        with compat.at(dest):
            if len(pieces) == 1 and pieces[0][0] == dest:
                return pieces[0][1]
            dev = self.device(dest)
            return torch.cat([t.to(dev) for _, t in pieces], dim)

    def gather_all(self, want: Callable, senders, dim: int) -> dict:
        """Every coordinate ``c`` of ``coords`` gets ``want(c, d)`` (a
        tensor, or None: nothing) from every mesh coordinate ``d`` of
        ``senders`` (row-major), across model groups, in that order,
        concatenated along ``dim`` on its device.  A piece counts to its
        sender once for every mesh coordinate it goes to (each that ``c``
        stands for, ``d`` aside), as a full dispatch counts it, as an
        all-to-all."""
        got = {}
        for c in self.coords:
            with compat.at(self.members[c]):
                got[c] = [want(c, d) for d in senders]
        compat.record_collective_at("all-to-all", (
            (d, got[self.rep[r]][k]) for r in self.mesh.coords()
            for k, d in enumerate(senders)
            if d != r and got[self.rep[r]][k] is not None))
        out = {}
        for c in self.coords:
            with compat.at(self.members[c]):
                dev = self.device(c)
                out[c] = torch.cat([t.to(dev) for t in got[c]
                                    if t is not None], dim)
        return out

    def split_rows(self, x) -> dict:
        """A batch input as each coordinate's rows on its device: a whole
        tensor cut, or a tensor placed by ``sharding.place_batch`` read
        block by block (one placed otherwise raises)."""
        if isinstance(x, torch.Tensor):
            return self.each(lambda c: x[self.rows(c)].to(self.device(c)))
        sh = NamedSharding(self.mesh, batch_shardings(
            {"x": x}, self.mesh, self.rules)["x"])
        self._check("batch", x, sh, ("batch",) + (None,) * (x.ndim - 1),
                    False)
        return self.each(lambda c: self._block(x, sh, c))

    # -- collectives over each model group, in model order ---------------
    def all_reduce(self, xs: dict) -> dict:
        out = {}
        for g in self.groups:
            out.update(zip(g, compat.all_reduce(
                [xs[c] for c in g], [self.members[c] for c in g],
                [self.device(c) for c in g])))
        return out

    def exchange(self, want: Callable, dim: int,
                 kind: str = "all-to-all") -> dict:
        """``want(c, group)`` lists ``(src, tensor)`` pairs, the pieces
        ``c`` receives from the members of its group (``src`` a member,
        the tensor its); ``c`` gets them concatenated along ``dim``
        (``compat.exchange``)."""
        out = {}
        for g in self.groups:
            pos = {c: j for j, c in enumerate(g)}
            pieces = []
            for c in g:
                with compat.at(self.members[c]):
                    pieces.append([(pos[s], t) for s, t in want(c, g)])
            out.update(zip(g, compat.exchange(
                pieces, [self.members[c] for c in g],
                [self.device(c) for c in g], dim, kind)))
        return out

    # -- collectives across model groups -----------------------------------
    def _at(self, c: Coord, axes: Tuple[str, ...], idx: int) -> Coord:
        """``c`` moved to row-major index ``idx`` over ``axes``."""
        out = list(c)
        for a in reversed(axes):
            idx, out[self.mesh.axis_names.index(a)] = divmod(
                idx, self.mesh.shape[a])
        return tuple(out)

    def gather_rows(self, xs: dict) -> dict:
        """Every coordinate gets the tensors of the coordinates that hold
        each row shard at its own place off the row axes (its model index
        among them), concatenated along dim 0 in row order: the whole
        batch's rows, an all-gather over the batch axes.  Each operand's
        bytes count to the coordinates it stands for."""
        if self.n_rows == 1:
            return dict(xs)
        compat.record_collective("all-gather", [xs[c] for c in self.coords])
        out = {}
        for c in self.coords:
            with compat.at(self.members[c]):
                dev = self.device(c)
                out[c] = torch.cat([
                    xs[self.rep[self._at(c, self.row_axes, r)]].to(dev)
                    for r in range(self.n_rows)])
        return out

    def psum_all(self, xs: dict) -> torch.Tensor:
        """The sum of every mesh coordinate's tensor (an untraced one's
        its class's), left to right in row-major coordinate order, on the
        mesh's home device."""
        compat.record_collective("all-reduce", [xs[c] for c in self.coords])
        home = self.mesh.home
        out = None
        for d in self.mesh.coords():
            x = xs[self.rep[d]].to(home)
            out = x if out is None else out + x
        return out

    def assemble(self, xs: dict, dim: int, split: bool) -> compat.Sharded:
        """Per-coordinate blocks of a value split over the rows (dim 0)
        and, where ``split``, over the model axis along ``dim`` (the
        logits: batch and vocab) as one Sharded, blocks in (row, model)
        order; on ``meta`` under class dispatch the traced rows' blocks
        stand for every row shard's."""
        n_m = self.n_model if split else 1
        by = {}
        for c in self.coords:
            r = self.mesh.axis_index(c, self.row_axes)
            by.setdefault((r, self.m(c) if split else 0), c)
        blocks, coords = [], []
        for r in range(self.n_rows):
            for j in range(n_m):
                c = by.get((r, j), by.get((0, j)))
                blocks.append(xs[c])
                coords.append(c)
        return compat.Sharded(blocks, (0, dim), (self.n_rows, n_m), coords)

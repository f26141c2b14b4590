"""Mesh construction.

Ported from ``repro.launch.mesh``.  Functions, not module-level
constants, so importing this module touches no device.

:func:`make_production_mesh` is the reference's layout over as many
visible cards: 16 x 16 ``(data, model)``, or 2 x 16 x 16
``(pod, data, model)`` with ``multi_pod``; given a ``device`` it
repeats that one device at every coordinate instead (the dry run's
``meta`` mesh, which allocates nothing).  :func:`make_debug_mesh` is
the small mesh of the sharding tests; it repeats one device at every
coordinate unless given a device per coordinate, so a ``(2, 2)`` debug
mesh runs on one card (or on the CPU), where the reference forces host
devices with ``--xla_force_host_platform_device_count``.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from .. import resolve_device
from ..distributed.meshctx import Mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device: Union[str, torch.device, None] = None
                         ) -> Mesh:
    """The production layout over one card per coordinate, or over
    ``device`` repeated at every coordinate (``"meta"`` for the dry
    run)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    if device is not None:
        return make_debug_mesh(*shape[-2:], multi_pod=multi_pod,
                               device=device)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise ValueError(f"make_production_mesh: a {shape} mesh needs {n} "
                         f"cards, {have} visible")
    devs = np.array([torch.device("cuda", i) for i in range(n)],
                    dtype=object).reshape(shape)
    return Mesh(devs, axes)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *,
                    multi_pod: bool = False,
                    device: Union[str, torch.device,
                                  Sequence] = "cuda") -> Mesh:
    """A ``(n_data, n_model)`` mesh (``(2, n_data, n_model)`` with
    ``multi_pod``).  ``device`` is one device, repeated at every
    coordinate (default the card; ``"cpu"`` for the host, ``"meta"`` for
    shapes alone), or a sequence
    of one device per coordinate in row-major order."""
    shape = (2, n_data, n_model) if multi_pod else (n_data, n_model)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    if isinstance(device, (str, torch.device)):
        dev = torch.device(device)
        devs = [dev if dev.type == "meta" else resolve_device(dev)] * n
    else:
        devs = [resolve_device(d) for d in device]
        if len(devs) != n:
            raise ValueError(f"make_debug_mesh: {len(devs)} devices for a "
                             f"{shape} mesh")
    return Mesh(np.array(devs, dtype=object).reshape(shape), axes)

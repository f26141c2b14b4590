"""Cross-process plan-signature fingerprints.

Ported from ``repro.testing.fingerprint``.  Morpheus' executable
identity is the plan *signature* — the tuple of the plan's constants
(site specs, pinned flags, instrumented bit).  Two independent processes
fed the identical schedule must plan the identical signature, or the
executable cache serves wrong code.

``plan_fingerprint`` hashes a signature with sha256 over a canonical,
type-tagged serialization (never Python ``hash()``, which is salted per
process).  The serialization is the reference's byte for byte, so equal
plans of the two packages give equal fingerprints.  (The reference's
cross-process CLI, ``run_fingerprints``, is not ported: nothing in the
port runs it.)
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch


def _canon(x, out: list) -> None:
    """Append a canonical, type-tagged byte serialization of ``x``."""
    if x is None:
        out.append(b"N")
    elif isinstance(x, bool):
        out.append(b"b1" if x else b"b0")
    elif isinstance(x, int):
        out.append(b"i" + str(x).encode())
    elif isinstance(x, float):
        out.append(b"f" + repr(x).encode())
    elif isinstance(x, str):
        e = x.encode()
        out.append(b"s" + str(len(e)).encode() + b":" + e)
    elif isinstance(x, bytes):
        out.append(b"y" + str(len(x)).encode() + b":" + x)
    elif isinstance(x, (tuple, list)):
        out.append(b"(")
        for e in x:
            _canon(e, out)
        out.append(b")")
    elif isinstance(x, dict):
        out.append(b"{")
        for k in sorted(x, key=repr):
            _canon(k, out)
            _canon(x[k], out)
        out.append(b"}")
    elif hasattr(x, "arr"):                    # passes.table_jit._Frozen
        _canon(np.asarray(x.arr), out)
    elif isinstance(x, torch.Tensor):
        _canon(x.detach().cpu().numpy(), out)
    elif isinstance(x, np.ndarray):
        out.append(b"A" + str(x.dtype).encode() + b"|"
                   + repr(x.shape).encode() + b"|" + x.tobytes())
    elif hasattr(x, "__dataclass_fields__"):   # SiteSpec and friends
        out.append(b"D" + type(x).__name__.encode())
        _canon({f: getattr(x, f) for f in x.__dataclass_fields__}, out)
    elif isinstance(x, np.integer):
        _canon(int(x), out)
    elif isinstance(x, np.floating):
        _canon(float(x), out)
    else:
        raise TypeError(
            f"plan_fingerprint: unserializable value of type "
            f"{type(x).__name__!r} in signature: {x!r}")


def plan_fingerprint(plan) -> str:
    """sha256 hex digest of ``plan.signature``'s canonical form."""
    out: list = []
    _canon(plan.signature, out)
    return hashlib.sha256(b"".join(out)).hexdigest()


"""Cross-process plan-signature fingerprints.

Ported from ``repro.testing.fingerprint``.  Morpheus' executable
identity is the plan *signature* — the tuple of the plan's constants
(site specs, pinned flags, instrumented bit).  Two independent processes
fed the identical schedule must plan the identical signature, or the
executable cache serves wrong code.

``plan_fingerprint`` hashes a signature with sha256 over a canonical,
type-tagged serialization (never Python ``hash()``, which is salted per
process).  The serialization is the reference's byte for byte, so equal
plans of the two packages give equal fingerprints.

``python -m repro_torch.testing.fingerprint [--seed N] [--device DEV]
[arch ...]`` prints a JSON map ``{arch: fingerprint}`` for the
deterministic warmup scenario of :func:`run_fingerprints`, so a test can
spawn it under a different ``PYTHONHASHSEED`` and diff against an
in-process run.  ``--device`` (default ``cuda``) is where the planes
run; without a card, ``--device cpu`` runs them on the host, and
leaving it out raises as every entry point of the port does.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from typing import Dict, Iterable, Optional

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


def run_fingerprints(arch_ids: Optional[Iterable[str]] = None,
                     seed: int = 0, n_steps: int = 12,
                     device="cuda") -> Dict[str, str]:
    """The canonical warmup scenario, one plan per arch: pinned
    sampling, ``n_steps`` seeded batches, one blocking recompile,
    fingerprint the planned signature.  Everything feeding the plan —
    tables, params, batches, sampling cadence — is derived from
    ``seed``, so the returned map must be process-independent, and
    device-independent for every plane whose plan reads no weight (a
    MoE plane's plan follows its router's choices)."""
    from ..configs import ARCH_IDS
    from .archzoo import build_plane, make_batch
    from .conformance import _Pair

    fps: Dict[str, str] = {}
    for arch in (tuple(arch_ids) if arch_ids else ARCH_IDS):
        plane = build_plane(arch)
        pair = _Pair(plane, seed, device)
        try:
            rng = np.random.default_rng(seed + 1)
            for _ in range(n_steps):
                pair.spec.step(make_batch(plane, rng))
            pair.recompile()
            fps[arch] = plan_fingerprint(pair.spec.plan)
        finally:
            pair.close()
    return fps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.testing.fingerprint",
        description="print {arch: plan fingerprint} as JSON")
    ap.add_argument("arch", nargs="*",
                    help="arch ids (default: every configs.ARCH_IDS)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device the planes run on (default: the card; "
                         "'cpu' runs on the host)")
    args = ap.parse_args(argv)
    json.dump(run_fingerprints(args.arch or None, seed=args.seed,
                               device=args.device),
              sys.stdout, indent=0, sort_keys=True)
    sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

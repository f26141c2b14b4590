"""Plain PyTorch versions of the kernels on the serving path.

These are the semantics of record, ported from ``repro.kernels.ref``:
the CPU takes them directly (``kernels.ops``), and the CUDA kernels are
held against them bit for bit on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def hot_gather_ref(table: torch.Tensor, hot_rows: torch.Tensor,
                   hot_ids: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The fast-path cache's semantics: rows whose id appears in
    ``hot_ids`` come from ``hot_rows`` (the first matching position),
    every other row from ``table`` at ``idx`` clipped to ``[0, V-1]``.
    With ``hot_rows`` a verbatim copy the result equals ``table[idx]``.

    table: (V, D); hot_rows: (Hn, D); hot_ids: (Hn,); idx: (T,) -> (T, D).
    """
    match = idx[:, None] == hot_ids[None, :]                    # (T, Hn)
    hit = match.any(dim=1)
    # argmax over a 0/1 int tensor returns the first maximal position
    hot_pos = match.to(torch.int32).argmax(dim=1)
    from_hot = hot_rows.index_select(0, hot_pos)
    from_table = table.index_select(
        0, idx.clamp(0, table.shape[0] - 1))
    return torch.where(hit[:, None], from_hot, from_table)


def onehot_lookup_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table: (V, D), idx: (T,) -> (T, D) via a one-hot matmul (the
    data-structure specialization for small V)."""
    onehot = F.one_hot(idx.long(), table.shape[0]).to(table.dtype)
    return onehot @ table

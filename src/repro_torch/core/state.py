"""PlaneState — the data plane's device state as one object.

Everything the step function threads through travels as a single
:class:`PlaneState`:

  tables  table name -> field name -> device tensor (the match-action maps)
  instr   site id    -> sketch state (count-min + candidate ring)
  guards  table name -> (1,) int32, nonzero once the data plane wrote the
          table (the in-step RW site guard, §4.3.6)

Every executable the engine builds follows one contract::

    step(params, state: PlaneState, batch) -> (out, PlaneState)

Executables never write their input state: a step returns fresh tensors
for what it changed and shares the rest, so the previous state stays
valid (the reference donates it instead; here replaying a state is safe).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict

import torch


@dataclass
class PlaneState:
    tables: Dict[str, Dict[str, torch.Tensor]]
    instr: Dict[str, Dict[str, torch.Tensor]]
    guards: Dict[str, torch.Tensor]

    def replace(self, **kw) -> "PlaneState":
        """A new PlaneState with the given fields swapped (leaves are
        shared, not copied)."""
        return dataclasses.replace(self, **kw)

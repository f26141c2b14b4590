"""``examples/serve_specialized_torch.py``, the port's twin of the
reference's drifting-traffic serving example, runs small on the CPU:
on one device and on a 4-entry debug mesh of the host, each phase
recompiles, the control update deopts and a recompile re-specializes."""
import importlib.util
from pathlib import Path

import pytest

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / \
    "serve_specialized_torch.py"


@pytest.mark.parametrize("mesh", ["none", "debug4"])
def test_serve_specialized_twin_runs_on_the_host(capsys, mesh):
    spec = importlib.util.spec_from_file_location("serve_specialized_torch",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)            # no work at import
    stats = mod.main(device="cpu", mesh=mesh, phase_steps=8,
                     recompile_every=4)
    assert stats["n_devices"] == (4 if mesh == "debug4" else 1)
    assert stats["steps"] == 4 * 8 + 1
    assert stats["recompiles"] == 4 * 8 // 4 + 1
    assert stats["deopt_steps"] >= 1
    assert stats["plan_label"].startswith("specialized")
    assert stats["phases"][1] is not None       # hot set A found
    out = capsys.readouterr().out
    for line in ("hot-set-A", "control-plane update",
                 "guard caught the update", "re-specialized: specialized",
                 "totals:"):
        assert line in out

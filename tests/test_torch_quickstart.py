"""``examples/quickstart_torch.py``, the port's twin of the reference's
quickstart, runs small on the CPU: its specialized output equals its
generic output exactly."""
import importlib.util
from pathlib import Path

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / \
    "quickstart_torch.py"


def test_quickstart_twin_specialized_equals_generic_on_the_host(capsys):
    spec = importlib.util.spec_from_file_location("quickstart_torch",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)            # no work at import
    assert mod.main(device="cpu", n=6) == 0.0
    out = capsys.readouterr().out
    for line in ("static analysis:", "plan: specialized", "hot experts:",
                 "generic ", "specialized ",
                 "max |specialized - generic| = 0.0"):
        assert line in out

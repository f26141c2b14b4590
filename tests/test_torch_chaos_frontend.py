"""The port's frontend chaos cell against the reference's: the same
schedule served through each package's ``ServingFrontend`` gives the
same report.  The report's ``rejected_degraded`` and ``requests_failed``
depend on the health machine's clock through the post-recovery
admission ramp (a token bucket at 200 req/s for 0.5 s), and the two
packages serve the schedule at very different wall speeds, so both runs
read one virtual health clock: each ``clock()`` call advances it 1 ms.
A file of its own: the reference's run takes about a minute."""
import dataclasses

import repro.testing.chaos as J
import repro_torch.testing.chaos as T


def _virtual_health_clock(monkeypatch, mod, step=1e-3):
    orig = mod.chaos_health_config
    t = [1000.0]

    def clock():
        t[0] += step
        return t[0]

    monkeypatch.setattr(mod, "chaos_health_config",
                        lambda mode: dataclasses.replace(orig(mode),
                                                         clock=clock))


def test_llama3_frontend_chaos_report_equals_the_reference(monkeypatch):
    _virtual_health_clock(monkeypatch, J)
    _virtual_health_clock(monkeypatch, T)
    report = T.run_chaos("llama3-8b", "frontend", seed=0, device="cpu")
    ref = J.run_chaos("llama3-8b", "frontend", seed=0)
    assert report == ref
    assert report["rejected_degraded"] >= 1
    assert report["requests_failed"] >= 1
    assert ("__frontend__", "batch_shape") in report["impls_seen"]

"""The port's serving CLI (``repro_torch.launch.serve``) against the
reference's on the CPU: fed the reference's weights and batches, the
plan label and hot experts after each recompile equal the reference's
``run_serve`` on the same seed.  (Split from ``test_torch_serve.py``,
unchanged, so that two workers share the two files.)"""
import jax
import numpy as np
import torch

import repro.launch.serve as J
import repro_torch.launch.serve as T
from repro.core import MorpheusRuntime as JRuntime
from repro.serving import ServeConfig as JServeConfig, \
    build_params as j_build_params, \
    make_synthetic_batch as j_make_synthetic_batch
from repro.testing.fingerprint import plan_fingerprint as j_fingerprint
from repro_torch.core import MorpheusRuntime
from repro_torch.serving import params_from_numpy
from repro_torch.testing.fingerprint import plan_fingerprint


def test_plans_after_each_recompile_equal_the_reference(monkeypatch):
    """Fed the reference's weights (seed 0) and its synthetic batches
    (``PRNGKey(i)``), the port's ``run_serve`` plans what the
    reference's does after each recompile: the label, the hot experts
    and the plan's fingerprint."""
    def ref_params(cfg, seed, device="cuda"):
        jp = j_build_params(JServeConfig(**cfg.__dict__),
                            jax.random.PRNGKey(seed))
        return params_from_numpy(jax.tree.map(np.asarray, jp), device)

    def ref_batch(cfg, seed=0, batch_size=8, locality="high",
                  device="cuda", **kw):
        b = j_make_synthetic_batch(JServeConfig(**cfg.__dict__),
                                   jax.random.PRNGKey(seed), batch_size,
                                   locality=locality, **kw)
        return {k: torch.from_numpy(np.array(v)).to(device)
                for k, v in b.items()}

    def record(cls, fingerprint, seen):
        real = cls.recompile

        def recompile(self, block=True):
            info = real(self, block=block)
            seen.append((info["plan"], self.hot_experts(),
                         fingerprint(self.plan)))
            return info
        monkeypatch.setattr(cls, "recompile", recompile)

    monkeypatch.setattr(T, "build_params", ref_params)
    monkeypatch.setattr(T, "make_synthetic_batch", ref_batch)
    seen, jseen = [], []
    record(MorpheusRuntime, plan_fingerprint, seen)
    record(JRuntime, j_fingerprint, jseen)
    stats, rt = T.run_serve(steps=60, recompile_every=30, quiet=True,
                            device="cpu")
    rt.close()
    jstats, jrt = J.run_serve(steps=60, recompile_every=30, quiet=True,
                              mesh="none")
    jrt.close()
    assert len(seen) == 2 and seen == jseen
    assert all(label == "specialized" for label, _, _ in seen)
    assert set(seen[-1][1]) == {0, 1, 2}
    for key in ("revalidations", "deopt_steps", "instr_steps", "steps"):
        assert getattr(stats["runtime"], key) == \
            getattr(jstats["runtime"], key)

"""The twins of ``tests/test_properties.py``'s hypothesis properties on
the port, on the CPU, with the reference's ``@settings``: count-min
never undercounts (and estimates what the reference's sketch estimates
for the same keys), the sketch total tracks the records, attention of a
constant v returns it, SSD maps zero input to zero output and state,
padded vocab columns never change the loss, a plan's signature and
fingerprint are pure in (sites, flags, instrumented) and equal the
reference's for the same plan, and the streaming histogram's quantile
stays within its ~5 % bound of the order statistic and equals the
reference's.

``test_hlo_while_multiplier`` parses XLA HLO and waits for the mesh
slice's analyzer (ROADMAP item 12)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip(
    "hypothesis",
    reason="hypothesis not installed (see requirements-dev.txt)")
from hypothesis import given, settings, strategies as st

from repro.core import SketchConfig as JSketchConfig
from repro.core import StreamingHistogram as JStreamingHistogram
from repro.core import instrument as JI
from repro.core.specialize import SiteSpec as JSiteSpec, \
    SpecializationPlan as JSpecializationPlan
from repro.testing.fingerprint import plan_fingerprint as j_plan_fingerprint
from repro_torch.core import SketchConfig, StreamingHistogram, instrument
from repro_torch.core.specialize import SiteSpec, SpecializationPlan
from repro_torch.kernels import ref as R
from repro_torch.models.model import cross_entropy
from repro_torch.testing import plan_fingerprint

SK = SketchConfig(width=256, candidates=64)
JSK = JSketchConfig(width=256, candidates=64)


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(0, 1000), min_size=1, max_size=200))
def test_count_min_never_undercounts(keys):
    """CMS point estimates are always >= true counts."""
    keys = np.asarray(keys, np.int32)
    state = instrument.record(instrument.init_site_state(SK, "cpu"),
                              torch.from_numpy(keys), SK)
    uniq, counts = np.unique(keys, return_counts=True)
    est = instrument.estimate(state, torch.from_numpy(uniq)).numpy()
    assert (est >= counts).all()
    # the reference's sketch of the same keys, padded with the ignored
    # key -1 to one shape (one XLA compile for every example)
    pad = lambda a: np.pad(a, (0, 200 - len(a)), constant_values=-1)
    jstate = JI.record(JI.init_site_state(JSK), jnp.asarray(pad(keys)),
                       JSK)
    jest = np.asarray(JI.estimate(jstate, jnp.asarray(pad(uniq))))
    np.testing.assert_array_equal(est, jest[:len(uniq)])


@settings(max_examples=20, deadline=None)
@given(st.integers(2, 64), st.integers(1, 8))
def test_sketch_total_tracks_records(n_keys, n_rounds):
    state = instrument.init_site_state(SK, "cpu")
    for _ in range(n_rounds):
        state = instrument.record(
            state, torch.arange(n_keys, dtype=torch.int32), SK)
    assert int(state["total"]) == n_keys * n_rounds


@settings(max_examples=15, deadline=None)
@given(st.integers(1, 4), st.integers(8, 64), st.integers(1, 4))
def test_attention_rows_sum_to_one(b, s, h):
    """Softmax invariance: output is a convex combination of V rows, so
    attention of constant-v inputs returns that constant."""
    rng = np.random.default_rng(b * 1000 + s)
    q = _randn(rng, b, s, h, 16)
    k = _randn(rng, b, s, h, 16)
    v = torch.ones((b, s, h, 16))
    out = R.flash_attention_ref(q, k, v, causal=True, block=16)
    torch.testing.assert_close(out, torch.ones_like(out), rtol=1e-4,
                               atol=1e-4)


@settings(max_examples=15, deadline=None)
@given(st.integers(1, 3), st.integers(4, 32))
def test_ssd_zero_input_zero_output(b, s):
    """SSD is linear in x: zero input => zero output and zero state."""
    rng = np.random.default_rng(s)
    H_, P, N = 2, 4, 8
    x = torch.zeros((b, s, H_, P))
    dt = torch.nn.functional.softplus(_randn(rng, b, s, H_))
    A = -torch.exp(_randn(rng, H_))
    Bm = _randn(rng, b, s, 1, N)
    Cm = _randn(rng, b, s, 1, N)
    y, fin = R.ssd_scan_ref(x, dt, A, Bm, Cm, 8)
    assert float(y.abs().max()) == 0.0
    assert float(fin.abs().max()) == 0.0


@settings(max_examples=15, deadline=None)
@given(st.integers(2, 50), st.integers(51, 80))
def test_vocab_padding_does_not_change_loss(vocab, padded):
    """Masked-CE invariant: padded logit columns never affect the loss."""
    rng = np.random.default_rng(vocab)
    logits = _randn(rng, 2, 8, padded)
    labels = torch.from_numpy(rng.integers(0, vocab, (2, 8)))
    base = cross_entropy(logits[..., :vocab], labels)
    pad = logits.clone()
    pad[..., vocab:] = 1e4
    padded_loss = cross_entropy(pad, labels, n_valid=vocab)
    np.testing.assert_allclose(float(base), float(padded_loss), rtol=1e-5)


_site_specs = st.builds(
    SiteSpec,
    impl=st.sampled_from(["gather", "onehot", "hot_cache",
                          "moe_fastpath", "ssd_fastpath"]),
    hot_keys=st.lists(st.integers(0, 255), max_size=4).map(tuple),
    guarded=st.booleans())
_sites = st.lists(
    st.tuples(st.sampled_from(["a#0", "a#1", "b#0", "c#0"]),
              _site_specs),
    max_size=4, unique_by=lambda s: s[0]).map(tuple)
_flags = st.dictionaries(st.sampled_from(["f1", "f2", "f3"]),
                         st.booleans(), max_size=3)


@settings(max_examples=30, deadline=None)
@given(_sites, _flags, st.booleans(), st.integers(0, 1000),
       st.integers(0, 1000))
def test_plan_signature_pure_in_sites_flags_instrumented(
        sites, flags, instrumented, v1, v2):
    """The signature (and its canonical fingerprint) is a pure function
    of (sites, flags, instrumented): version and label never leak in —
    and the fingerprint is the reference's for the same plan."""
    p1 = SpecializationPlan(version=v1, sites=sites, flags=dict(flags),
                            instrumented=instrumented, label="x")
    p2 = SpecializationPlan(version=v2, sites=sites, flags=dict(flags),
                            instrumented=instrumented, label="y")
    assert p1.signature == p2.signature
    assert plan_fingerprint(p1) == plan_fingerprint(p2)
    # ... and each component IS load-bearing
    p3 = SpecializationPlan(version=v1, sites=sites, flags=dict(flags),
                            instrumented=not instrumented)
    assert plan_fingerprint(p3) != plan_fingerprint(p1)
    flipped = dict(flags)
    flipped["f1"] = not flipped.get("f1", False)
    p4 = SpecializationPlan(version=v1, sites=sites, flags=flipped,
                            instrumented=instrumented)
    assert plan_fingerprint(p4) != plan_fingerprint(p1)
    jsites = tuple((sid, JSiteSpec(impl=s.impl, hot_keys=s.hot_keys,
                                   guarded=s.guarded))
                   for sid, s in sites)
    j1 = JSpecializationPlan(version=v1, sites=jsites, flags=dict(flags),
                             instrumented=instrumented, label="x")
    assert plan_fingerprint(p1) == j_plan_fingerprint(j1)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.floats(min_value=1e-6, max_value=1e3,
                          allow_nan=False, allow_infinity=False),
                min_size=1, max_size=300),
       st.floats(min_value=0.0, max_value=1.0))
def test_histogram_quantile_error_bound(xs, q):
    """StreamingHistogram.quantile stays within the documented ~5%
    relative-error bound of the true order statistic (``inverted_cdf``:
    sorted[ceil(q*n)-1]) for any stream inside [lo, hi), and returns the
    reference's value."""
    h = StreamingHistogram()          # lo=1e-7, hi=1e4, 512 buckets
    h.observe_all(xs)
    got = h.quantile(q)
    want = float(np.quantile(np.asarray(xs), q, method="inverted_cdf"))
    assert got == pytest.approx(want, rel=0.06)
    jh = JStreamingHistogram()
    jh.observe_all(xs)
    assert got == jh.quantile(q)

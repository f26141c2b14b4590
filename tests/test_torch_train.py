"""The port's training path against the reference's at ``smoke()``
scale, on the CPU, with the reference's weights carried across by
``params_from_numpy`` and the same numpy inputs:

- ``Model.loss`` and the gradient of every parameter against
  ``jax.value_and_grad(model.loss)`` in f32 (so routing is f32 too):
  starcoder2-3b (tied embeddings, ungated GELU MLP), phi3.5-MoE with the
  generic dispatch and with the hot-expert branch (the reference reads
  the hot set from ``meshctx.use_moe_hot``, the port takes it as an
  argument), pixtral-12b (media positions cut from the logits),
  deepseek-v2 (MLA's blocked loop, out of place under autograd),
  gemma2-9b (window, both softcaps, out of place under autograd),
  mamba2-1.3b (every layer through ``ssd_scan``'s plain version, against
  the reference's ``jax.value_and_grad`` through its ``ssd_scan_ref``),
  jamba-v0.1-52b (Mamba, attention and MoE layers together) and
  seamless-m4t-medium (the encoder-decoder branch, ``encoder_forward``
  rematerialized a layer at a time; the reference's encoder scan runs
  only in bf16, so its f32 loss is composed from its own layers, and the
  port's encoder carry is set to f32 for the case).  The loss within
  ``LOSS_RTOL`` relative, each gradient leaf within ``GRAD_TOL`` times
  its largest entry (normwise: the same arithmetic, its sums in other
  orders; gemma2, jamba and seamless at their own f32 noise);
- ``adamw_update`` fed the same numpy gradients: master, m and v within
  ``ADAM_RTOL`` relative after one update (and 10x that after two more),
  and ``schedule``;
- the twin of ``test_substrate.py``'s microbatch test, at its
  tolerances; ``remat`` on and off give the same bits (a dense, a MoE,
  a Mamba and an encoder-decoder stack); the port's
  ``TokenPipeline`` gives the reference's batches bit for bit, and its
  Zipf skew (the twin of ``test_substrate.py::test_pipeline_zipf_skew``);
- the twins of ``test_substrate.py``'s CLI tests (crash and resume, the
  hot-expert swap) through ``python -m repro_torch.launch.train --device
  cpu``, and the driver's device-loss and grow-back flags.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data import DataConfig as JDataConfig
from repro.data import TokenPipeline as JTokenPipeline
from repro.distributed.meshctx import use_moe_hot
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.model import Model as JModel
from repro.models.model import cross_entropy as j_cross_entropy
from repro.models.params import unzip
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_update as j_adamw_update
from repro.optim import schedule as j_schedule
from repro_torch.checkpoint import latest_step
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import build_state
from repro_torch.models import encdec as TE
from repro_torch.models.model import Model, params_from_numpy
from repro_torch.models.params import flat_tree, trainable
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state, \
    schedule

LOSS_RTOL, GRAD_TOL, ADAM_RTOL = 1e-5, 1e-4, 1e-6
B, S = 2, 24
ENV = {**os.environ, "PYTHONPATH": "src", "OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-scale ops gain nothing from torch's intra-op threads, and the
    suite's parallel workers oversubscribe the cores with them (the chaos
    cells take 17 s with one thread, several times that with the default
    beside five other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat_ref(tree, prefix=""):
    """The reference tree's leaves keyed by path, as the port's
    ``flat_tree`` keys them."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_ref(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _reference(arch):
    """(jax Model, f32 jax params, the port's Model, trainable f32
    params) at smoke() scale, the same weights."""
    jm = JModel(j_get_config(arch).smoke())
    jp = unzip(jm.init(jax.random.PRNGKey(0)))[0]
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp = trainable(params_from_numpy(jax.tree.map(np.asarray, jp),
                                     device="cpu"))
    return jm, jp, Model(get_config(arch).smoke()), tp


S_ENC = 16     # an encoder-decoder batch's frames


def _batch(cfg, seed=0, media=False):
    """Tokens and labels; an encoder-decoder config's frames (rounded to
    bf16, which both encoders cast them to first); with ``media`` the
    media embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if media:
        b["media"] = rng.standard_normal(
            (B, cfg.num_media_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encdec:
        frames = rng.standard_normal((B, S_ENC, cfg.d_model))
        b["frames"] = np.asarray(jnp.asarray(frames, jnp.bfloat16),
                                 np.float32)
    return b


def _encdec_loss_f32(jm, batch):
    """The reference's f32 loss of an encoder-decoder config, composed
    from its own ``layer_forward`` / ``rmsnorm`` / ``lm_forward`` /
    ``cross_entropy`` in the order its ``encdec_forward`` and ``loss``
    run them: its encoder's ``lax.scan`` carries the frames cast to bf16
    and refuses f32 weights (``TypeError``), so ``jm.loss`` runs only in
    bf16, where the gradient is the bf16 rounding's noise."""
    cfg = jm.cfg

    def loss(p):
        x = batch["frames"]
        pos = jnp.arange(x.shape[1], dtype=jnp.int32)
        for i in range(cfg.n_enc_layers):
            layer = jax.tree.map(lambda a: a[i], p["encoder"]["blocks"])
            x = JT.layer_forward(layer, cfg, JE.ENC_SPEC, x, pos,
                                 causal=False)[0]
        enc = JL.rmsnorm(p["encoder"]["final_norm"], x, cfg.rms_eps)
        logits = JT.lm_forward(p["decoder"], cfg, batch["tokens"],
                               enc_out=enc)[0]
        return j_cross_entropy(logits, batch["labels"], n_valid=cfg.vocab)
    return loss


def _close(got, ref, tol, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * max(scale, 1e-30), \
        f"{what}: max err {err} > {tol} x {scale}"


# gemma2's smoke gradient is noisier in f32 in both packages: on these
# inputs the reference's own f32 gradient lies up to 2.2e-4 of a leaf's max
# from the f64 gradient of the same weights (the port's up to 1.3e-4)
GEMMA2_GRAD_TOL = 5e-4
# jamba's (Mamba, attention and top-2 MoE layers) likewise: the reference's
# f32 gradient lies up to 6.5e-4 of a leaf's max from its f64 gradient, the
# port's up to 9.3e-4, and the two up to 9.0e-4 from each other
JAMBA_GRAD_TOL = 2e-3
# seamless's (near-argmax cross-attention at random weights amplifies a
# last-bit difference ~10x): the reference's composed f32 gradient lies up
# to 4.8e-4 from its f64 one, the port's up to 5.7e-4, the two up to 1.8e-4
# from each other
ENCDEC_GRAD_TOL = 5e-4


@pytest.mark.parametrize("arch,hot,media,tol", [
    ("starcoder2-3b", None, False, GRAD_TOL),
    ("phi3.5-moe-42b-a6.6b", None, False, GRAD_TOL),
    ("phi3.5-moe-42b-a6.6b", (0, 1, 2), False, GRAD_TOL),
    ("phi3.5-moe-42b-a6.6b", (1, 3), False, GRAD_TOL),
    ("pixtral-12b", None, True, GRAD_TOL),
    ("deepseek-v2-236b", None, False, GRAD_TOL),
    ("gemma2-9b", None, False, GEMMA2_GRAD_TOL),
    ("mamba2-1.3b", None, False, GRAD_TOL),
    ("jamba-v0.1-52b", None, False, JAMBA_GRAD_TOL),
    ("seamless-m4t-medium", None, False, ENCDEC_GRAD_TOL),
    ("llama3-8b", None, False, GRAD_TOL),
    ("deepseek-7b", None, False, GRAD_TOL),
], ids=["starcoder2", "phi3.5-moe", "phi3.5-moe-hot-hit",
        "phi3.5-moe-hot-miss", "pixtral-media", "deepseek-v2-mla",
        "gemma2-softcaps", "mamba2-ssd", "jamba-hybrid", "seamless-encdec",
        "llama3", "deepseek-7b"])
def test_loss_and_grads_match_the_reference(arch, hot, media, tol,
                                            monkeypatch):
    jm, jp, tm, tp = _reference(arch)
    nb = _batch(jm.cfg, media=media)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}

    def jloss(p):
        return jm.loss(p, jb)[0]
    if jm.cfg.encdec:
        # f32 on both sides (``_encdec_loss_f32``): the port's encoder
        # checks its weights against its carry's dtype, here f32
        jloss = _encdec_loss_f32(jm, jb)
        monkeypatch.setattr(TE, "CARRY_DTYPE", torch.float32)
    with use_moe_hot(hot):
        jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    tl, _ = tm.loss(tp, tb, hot_experts=hot)
    tl.backward()
    assert abs(tl.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    ref = _flat_ref(jg)
    got = flat_tree(tp)
    assert set(got) == set(ref)
    for k, p in got.items():
        _close(p.grad, ref[k], tol, k)


def test_hot_expert_branch_runs_the_hot_path(monkeypatch):
    """``Model.loss(hot_experts=)`` reaches ``moe_ffn_hotpath`` in every
    MoE layer, and no call without it does."""
    from repro_torch.core.passes import branch_inject
    calls = []
    real = branch_inject.moe_ffn_hotpath

    def spy(*a, **kw):
        calls.append(a[3])
        return real(*a, **kw)
    monkeypatch.setattr(branch_inject, "moe_ffn_hotpath", spy)
    _, _, tm, tp = _reference("phi3.5-moe-42b-a6.6b")
    tb = {k: torch.from_numpy(v) for k, v in _batch(tm.cfg).items()}
    tm.loss(tp, tb)
    assert calls == []
    tm.loss(tp, tb, hot_experts=(0, 2))
    assert calls == [(0, 2)] * tm.cfg.n_layers


def test_adamw_update_matches_the_reference():
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 5), "b": (5,), "scale": (3, 2, 4)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 3).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    jcfg = JAdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    tcfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jopt = {"master": {k: jnp.asarray(v) for k, v in p0.items()},
            "m": {k: jnp.zeros(v.shape) for k, v in p0.items()},
            "v": {k: jnp.zeros(v.shape) for k, v in p0.items()},
            "step": jnp.zeros((), jnp.int32)}
    tparams = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    topt = init_opt_state(tparams)
    for i, g in enumerate(grads):
        # one update is held at ADAM_RTOL; the later ones at 10x: the
        # gradient norm's sums run in other orders (a last-bit difference
        # of the clip scale), and m = b1 m + (1 - b1) g cancels digits
        rtol = ADAM_RTOL if i == 0 else 10 * ADAM_RTOL
        jp, jopt, jmet = j_adamw_update(
            jcfg, {k: jnp.asarray(v) for k, v in g.items()}, jopt)
        tparams, topt, tmet = adamw_update(
            tcfg, {k: torch.from_numpy(v) for k, v in g.items()}, topt,
            params=tparams)
        assert int(topt["step"]) == int(jopt["step"])
        assert float(tmet["lr"]) == pytest.approx(float(jmet["lr"]),
                                                  rel=rtol)
        assert float(tmet["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=rtol)
        for part in ("master", "m", "v"):
            for k in shapes:
                np.testing.assert_allclose(topt[part][k].numpy(),
                                           np.asarray(jopt[part][k]),
                                           rtol=rtol, atol=1e-12)
        for k in shapes:
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jp[k]),
                                       rtol=rtol, atol=1e-12)


def test_global_norm_stays_finite_where_f32_squares_overflow():
    """A gradient entry of 1e20 squares past f32's range: the reference's
    norm is inf (and its clip then zeroes the update), the port's is the
    true norm (a divergence kept on purpose: ROADMAP Queue 3)."""
    from repro.optim import global_norm as j_global_norm
    from repro_torch.optim import global_norm
    g = np.zeros((4, 8), np.float32)
    g[1, 2], g[3, 5] = 3e20, 4e20
    assert not np.isfinite(float(j_global_norm({"w": jnp.asarray(g)})))
    assert float(global_norm({"w": torch.from_numpy(g)})) == \
        pytest.approx(5e20, rel=1e-6)
    small = {"w": torch.from_numpy(np.full((4, 8), 0.5, np.float32))}
    assert float(global_norm(small)) == pytest.approx(
        float(j_global_norm({"w": jnp.full((4, 8), 0.5)})), rel=1e-7)


def test_adamw_keeps_each_params_dtype_and_updates_in_place():
    params = {"w": torch.ones(4, 4, dtype=torch.bfloat16),
              "s": torch.ones(4)}
    ids = {k: id(v) for k, v in params.items()}
    opt = init_opt_state(params)
    grads = {k: torch.full_like(v, 0.01) for k, v in params.items()}
    out, opt2, _ = adamw_update(AdamWConfig(lr=1e-2), grads, opt,
                                params=params)
    assert opt2 is opt and int(opt["step"]) == 1
    assert {k: id(v) for k, v in out.items()} == ids
    assert out["w"].dtype == torch.bfloat16 and out["s"].dtype == \
        torch.float32
    assert opt["master"]["w"].dtype == torch.float32
    assert float((out["s"] - 1).abs().max()) > 0


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 50, 99, 100, 150])
def test_schedule_matches_the_reference(step):
    jc = JAdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    tc = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                     min_lr_ratio=0.1)
    assert float(schedule(tc, step)) == pytest.approx(
        float(j_schedule(jc, jnp.int32(step))), rel=1e-6, abs=1e-7)
    if step == 0:
        assert float(schedule(tc, step)) == 0.0
    if step == 10:
        assert abs(float(schedule(tc, step)) - 1.0) < 1e-6
    if step >= 100:
        assert float(schedule(tc, step)) <= 0.1 + 1e-6


def test_microbatch_grad_accumulation_matches_full_batch():
    """The twin of ``test_substrate.py``'s, at its tolerances."""
    cfg = get_config("starcoder2-3b").smoke()
    model = Model(cfg)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)),
        "labels": torch.from_numpy(
            rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32))}
    out = []
    for k in (1, 2):
        state = build_state(model, 0, "cpu")
        state, m = make_train_step(model, AdamWConfig(), microbatches=k)(
            state, batch)
        out.append((float(m["loss"]), flat_tree(state["opt"]["master"])))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=2e-2)
    for key, a in out[0][1].items():
        np.testing.assert_allclose(a.numpy(), out[1][1][key].numpy(),
                                   rtol=0.1, atol=1e-3)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "phi3.5-moe-42b-a6.6b",
                                  "mamba2-1.3b", "seamless-m4t-medium"])
def test_remat_equals_no_remat_bit_for_bit(arch):
    cfg = get_config(arch).smoke()
    model = Model(cfg)
    params = trainable(model.init(0, "cpu"))
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    got = []
    for remat in (True, False):
        params.zero_grad(set_to_none=True)
        loss, _ = model.loss(params, tb, remat=remat)
        loss.backward()
        got.append((loss.detach().clone(),
                    [p.grad.clone() for p in params.parameters()]))
    assert torch.equal(got[0][0], got[1][0])
    assert all(torch.equal(a, b) for a, b in zip(got[0][1], got[1][1]))


def test_token_pipeline_equals_the_reference_bit_for_bit():
    kw = dict(vocab=300, seq=12, global_batch=3, seed=7, media_tokens=5,
              d_model=16, enc_seq=6)
    ref = JTokenPipeline(JDataConfig(**kw))
    port = TokenPipeline(DataConfig(**kw), device="cpu")
    for _ in range(3):
        a, b = ref.next_batch(), port.next_batch()
        assert set(a) == set(b) == {"tokens", "labels", "media", "frames"}
        for k in a:
            x, y = np.asarray(a[k]), b[k]
            if y.dtype == torch.bfloat16:
                assert x.dtype.name == "bfloat16"
                np.testing.assert_array_equal(
                    x.view(np.uint16), y.view(torch.int16).numpy().view(
                        np.uint16))
            else:
                assert str(x.dtype) == str(y.dtype).removeprefix("torch.")
                np.testing.assert_array_equal(x, y.numpy())
    assert port.state_dict() == ref.state_dict()


def test_pipeline_zipf_skew():
    """The twin of ``test_substrate.py::test_pipeline_zipf_skew`` on the
    port's pipeline (``DataConfig.zipf_a``), and the same tokens as the
    reference's."""
    kw = dict(vocab=512, seq=64, global_batch=16, seed=0)
    toks = TokenPipeline(DataConfig(**kw), device="cpu").next_batch()[
        "tokens"].numpy().ravel()
    # Zipf: token 0 should be much more common than the tail
    assert (toks == 0).sum() > (toks >= 256).sum() / 4
    ref = np.asarray(JTokenPipeline(JDataConfig(**kw)).next_batch()[
        "tokens"]).ravel()
    np.testing.assert_array_equal(toks, ref)


def test_train_crash_resume_end_to_end(tmp_path):
    """The twin of ``test_substrate.py``'s: crash mid-run, resume from the
    atomic checkpoint, the stream continues where it left off."""
    args = ["--arch", "starcoder2-3b", "--smoke", "--steps", "14",
            "--batch", "2", "--seq", "16", "--ckpt-every", "5",
            "--ckpt-dir", str(tmp_path), "--log-every", "50",
            "--device", "cpu"]
    r1 = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args,
         "--fail-at-step", "8"],
        capture_output=True, text=True, env=ENV, cwd=os.getcwd(),
        timeout=300)
    assert "SimulatedFailure" in r1.stderr
    assert latest_step(str(tmp_path)) == 5
    r2 = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args,
         "--resume"],
        capture_output=True, text=True, env=ENV, cwd=os.getcwd(),
        timeout=300)
    assert r2.returncode == 0, r2.stderr[-800:]
    assert "resumed from step 5" in r2.stdout
    assert "done at step 14" in r2.stdout


def test_train_morpheus_hot_expert_swap():
    """The twin of ``test_substrate.py``'s: the driver re-plans hot experts
    from router statistics and swaps in the branch-injected step."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train",
         "--arch", "phi3.5-moe-42b-a6.6b", "--smoke", "--steps", "24",
         "--batch", "2", "--seq", "16", "--ckpt-every", "0",
         "--respecialize-every", "8", "--hot-coverage", "0.7",
         "--log-every", "100", "--device", "cpu"],
        capture_output=True, text=True, env=ENV, cwd=os.getcwd(),
        timeout=300)
    assert r.returncode == 0, r.stderr[-800:]
    assert "morpheus: swapped in hot-expert step" in r.stdout
    assert "done at step 24" in r.stdout


def test_elastic_flags_raise():
    """``--device-loss-at-step`` / ``--grow-back-after`` (the name
    predates them): the driver trains on one device, as the reference's,
    so the device loss reshards onto that device, verified, and the
    grow-back has nothing to add; the run reaches its end."""
    from repro_torch.launch.train import main
    seen = []
    rc = main(["--arch", "starcoder2-3b", "--smoke", "--steps", "8",
               "--batch", "2", "--seq", "16", "--ckpt-every", "0",
               "--log-every", "100", "--device-loss-at-step", "3",
               "--grow-back-after", "2", "--device", "cpu"],
              on_step=lambda step, state, m, dt, sup: seen.append(
                  (step, sup.stats(), int(state["opt"]["step"]))))
    assert rc == 0
    last = seen[-1][1]
    assert last["device_losses"] == 1 and last["reshard_verified"] == 1
    assert last["grow_backs"] == 0 and last["mesh_epoch"] == 1
    assert [s[1]["device_losses"] for s in seen] == [0, 0, 0] + [1] * 5
    assert [s[2] for s in seen] == list(range(1, 9))


def test_the_trainer_needs_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--arch", "starcoder2-3b", "--smoke", "--steps", "1"])

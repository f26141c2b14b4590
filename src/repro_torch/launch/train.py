"""Training driver, ported from ``repro.launch.train``.

The reference's flags and log lines (``[train] step=...``, ``resumed
from step N``, ``done at step N``), plus ``--device`` (default ``cuda``;
the card must be there: nothing falls back to the CPU).  The path is
``TrainSupervisor.step`` -> ``make_train_step`` -> ``Model.loss`` ->
``lm_forward`` (remat on; every attention call through the
``flash_attention`` kernel forward and its ``flash_attention_bwd``
backward on the card, every Mamba layer's scan through ``ssd_scan`` and
its ``ssd_scan_bwd`` backward) -> AdamW in place, with atomic and async
checkpoints, failure injection with resume, straggler monitoring, and
the hot-expert respecialization of the supervisor.

Fault taxonomy (``distributed/fault.py``):

  * ``--fail-at-step N`` — a *process crash*: the exception escapes the
    driver; rerun with ``--resume`` restores the latest atomic checkpoint
    and replays **bit-exactly**.
  * ``--step-fault-at N`` — an *in-process* fault at the supervisor's
    boundary: deopts to generic, retries the same batch, never loses an
    optimizer step.
  * ``--device-loss-at-step N`` / ``--grow-back-after K`` — a device
    drops out at step N: snapshot, device-set shrink, verified elastic
    reshard, degraded generic steps while re-specialization proceeds in
    the background; K steps later the device set grows back.  The driver
    trains on one device, as the reference's does, so the survivors are
    that device and the grow-back has nothing to add.

Examples:
    python -m repro_torch.launch.train --arch starcoder2-3b --batch 4 \\
        --seq 2048 --steps 6 --ckpt-every 0
    python -m repro_torch.launch.train --arch mamba2-1.3b --batch 4 \\
        --seq 2048 --steps 6 --ckpt-every 0
    python -m repro_torch.launch.train --arch phi3.5-moe-42b-a6.6b --smoke \\
        --steps 40 --fail-at-step 25 --device cpu   # crash, then --resume
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

from .. import resolve_device
from ..checkpoint import latest_step, restore, save, save_async
from ..configs import get_config
from ..data import DataConfig, TokenPipeline
from ..distributed.fault import FailureInjector, SimulatedDeviceLoss, \
    SimulatedFailure, StragglerMonitor
from ..models.model import Model
from ..models.params import param_count, trainable
from ..optim import AdamWConfig, init_opt_state
from ..training import SupervisorConfig, TrainSupervisor

def cut_layers(cfg, layers: int):
    """``cfg`` cut to its first ``layers`` layers at every width: a
    multiple of the block pattern's period, or fewer layers than one
    period, which cuts the pattern to them (jamba's layers 0-1: Mamba with
    a dense FFN, then Mamba with the MoE FFN)."""
    if cfg.block_pattern and layers < len(cfg.block_pattern):
        return cfg.replace(n_layers=layers,
                           block_pattern=cfg.block_pattern[:layers])
    return cfg.replace(n_layers=layers)


def build_state(model: Model, seed: int, device="cuda") -> dict:
    """``{"params": trainable bf16 params drawn from seed, "opt": AdamW
    state}`` on ``device``."""
    params = trainable(model.init(seed, device))
    return {"params": params, "opt": init_opt_state(params)}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to its first this many layers "
                    "(0 = all), every width as published (cut_layers)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--ckpt-async", action="store_true")
    ap.add_argument("--keep-last", type=int, default=None,
                    help="retain only the newest N checkpoints "
                    "(default: keep everything)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="process-crash injection (escapes the driver; "
                    "resume from the latest checkpoint)")
    ap.add_argument("--step-fault-at", type=int, default=None,
                    help="in-process fault at the supervisor boundary "
                    "(deopt + retry, no lost step)")
    ap.add_argument("--device-loss-at-step", type=int, default=None,
                    help="simulate losing a device: snapshot + mesh "
                    "shrink + elastic reshard + degraded continue")
    ap.add_argument("--grow-back-after", type=int, default=None,
                    help="grow the mesh back N steps after the device "
                    "loss")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--respecialize-every", type=int, default=0,
                    help="Morpheus on the training backend: every N steps "
                    "re-plan hot experts from router statistics and swap "
                    "in the branch-injected train step (0 = off)")
    ap.add_argument("--hot-coverage", type=float, default=0.95)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv=None, on_step=None) -> int:
    """The driver.  ``on_step(step, state, metrics, seconds, supervisor)``,
    when given, is called after every step (a caller's measurements)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.layers:
        cfg = cut_layers(cfg, args.layers)
    model = Model(cfg)

    state = build_state(model, args.seed, device)
    n_params = param_count(state["params"])
    print(f"[train] {cfg.name}: {n_params/1e6:.1f}M params", flush=True)

    dcfg = DataConfig(vocab=cfg.vocab, seq=args.seq,
                      global_batch=args.batch, seed=args.seed,
                      media_tokens=cfg.num_media_tokens,
                      d_model=cfg.d_model,
                      enc_seq=(args.seq // cfg.enc_seq_divisor
                               if cfg.encdec else 0))
    pipe = TokenPipeline(dcfg, device)

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             f"repro_torch_ckpt_{cfg.name}")

    # the supervisor owns the step executables: the resident generic is
    # built here (the one training-thread build of the run); specialized
    # steps build on its scheduler thread
    fault_injector = FailureInjector(seed=args.seed)
    sup = TrainSupervisor(
        model, opt_cfg, state, pipe.peek_batch(),
        cfg=SupervisorConfig(respecialize_every=args.respecialize_every,
                             hot_coverage=args.hot_coverage,
                             microbatches=args.microbatches),
        injector=fault_injector, ckpt_dir=ckpt_dir,
        meta_fn=lambda: {"arch": cfg.name},
        log_fn=lambda m: print(f"[train] {m}", flush=True))

    start_step = 0
    if args.resume and latest_step(ckpt_dir) is not None:
        state, meta = restore(ckpt_dir, None, state)
        pipe.load_state_dict(meta["data"])
        start_step = meta["step"]
        # revalidate-or-deopt: the checkpointed plan re-stages for
        # activation at start_step and builds in the background
        sup.restore_spec(meta.get("morpheus"), resume_step=start_step)
        print(f"[train] resumed from step {start_step}", flush=True)

    crash_injector = FailureInjector(fail_at_step=args.fail_at_step,
                                     seed=args.seed)
    straggler = StragglerMonitor(
        on_straggler=lambda s, t: print(
            f"[train] straggler mitigation fired at step {s} "
            f"({t*1e3:.0f} ms)", flush=True))

    def ckpt_meta():
        return {"data": pipe.state_dict(), "arch": cfg.name,
                "morpheus": sup.spec_meta()}

    pending = None
    try:
        for step in range(start_step, args.steps):
            # process-crash injection: escapes the driver (resume from
            # the checkpoint)
            crash_injector.check(step)
            if args.step_fault_at is not None and step == args.step_fault_at:
                fault_injector.arm_next(
                    SimulatedFailure(f"injected failure at step {step}"))
            if (args.device_loss_at_step is not None
                    and step == args.device_loss_at_step):
                fault_injector.arm_next(
                    SimulatedDeviceLoss(f"device lost at step {step}"))
            if (args.device_loss_at_step is not None
                    and args.grow_back_after is not None
                    and step == (args.device_loss_at_step
                                 + args.grow_back_after)):
                state = sup.recover_devices(state)
            t0 = time.time()
            batch = pipe.next_batch()
            state, metrics = sup.step(state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            straggler.observe(step, dt)
            if on_step is not None:
                on_step(step, state, metrics, dt, sup)

            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"[train] step={step} loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"lr={float(metrics['lr']):.2e} {dt*1e3:.0f}ms",
                      flush=True)
            if not np.isfinite(loss):
                print("[train] non-finite loss — aborting", flush=True)
                return 2
            if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
                if pending is not None:
                    pending.join()       # surface async write errors
                if args.ckpt_async:      # before queuing the next one
                    pending = save_async(ckpt_dir, step + 1, state,
                                         ckpt_meta(),
                                         keep_last=args.keep_last)
                else:
                    save(ckpt_dir, step + 1, state, ckpt_meta(),
                         keep_last=args.keep_last)
        if pending is not None:
            pending.join()               # re-raises write failures
            pending = None
        print(f"[train] done at step {args.steps}", flush=True)
    finally:
        if pending is not None:
            try:
                pending.join(timeout=60.0)
            except Exception as e:       # noqa: BLE001 — already failing
                print(f"[train] async checkpoint write failed: {e}",
                      flush=True)
        sup.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --mode fmi --data-axis 2 --allreduce ring --batch 4 --seq 2048 --steps 8

Port of :mod:`repro.launch.train`, with the same flags plus ``--device``
(default ``cuda``; with no GPU it raises instead of falling back).  Both
distribution modes run: ``xla`` (one replica over the global batch) and
``fmi`` (``--data-axis`` ranks stacked on the device, gradients averaged
by an explicit FMI collective, ``--compression int8`` through the Hopper
quantize kernels).  It trains the dense family (llama3.2-1b, ...) and the
ssm family (xlstm-125m).  On the card, attention forward and backward go
through the hand-written flash-attention kernels, and every mLSTM layer's
scan forward and backward through the gated-linear-attention scan
kernels.  ``--reduced`` trains the smoke-sized config of the same family
(runs on the CPU too)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --reduced --steps 4 --batch 4 --seq 64 --mode fmi --data-axis 2 \\
        --device cpu

Each step prints the reference's line (loss, ce, lr, grad norm, time) plus
tokens/s; the run ends with the peak device memory.  ``--profile`` traces
the last step with ``torch.profiler`` and prints where its time went.  ZeRO-1, the bucketed
schedule, the elastic heal path, checkpoints and the sanitizer are not
ported yet and raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .. import configs
from ..data.pipeline import DataConfig, synthetic_batch
from ..devices import resolve_device
from ..models import lm
from ..optim.optimizer import OptConfig
from ..training.train_step import TrainConfig, init_opt_state, make_train_step
from .mesh import make_host_mesh
from .serve import report_profile

_UNPORTED = {
    "zero1": "--zero1 (ZeRO-1) is not ported yet (ROADMAP Queue 1, item 15)",
    "bucketed": "--schedule bucketed (CommScheduler) is not ported yet "
                "(ROADMAP Queue 1, item 4)",
    "elastic": "--elastic/--kill-rank training is not ported yet (ROADMAP "
               "Queue 1, item 15: checkpoint/store.py and the elastic trainer)",
    "ckpt": "--ckpt-dir (checkpoint/store.py) is not ported yet (ROADMAP "
            "Queue 1, item 15)",
    "sanitize": "--sanitize for training is not ported yet (ROADMAP Queue 1, "
                "item 16)",
}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mode", default="xla", choices=["xla", "fmi"])
    ap.add_argument("--allreduce", default="auto")
    ap.add_argument("--schedule", default="blocking",
                    choices=["blocking", "bucketed"])
    ap.add_argument("--bucket-mb", type=float, default=None)
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--compression", default="none", choices=["none", "int8"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data-axis", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--out-json", default="")
    ap.add_argument("--elastic", action="store_true")
    ap.add_argument("--regroup", default="pow2_floor",
                    choices=["auto", "pow2_floor", "ring", "recursive_doubling"])
    ap.add_argument("--kill-rank", type=int, default=None)
    ap.add_argument("--kill-at-step", type=int, default=None)
    ap.add_argument("--sanitize", action="store_true")
    ap.add_argument("--sanitize-out", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random initial weights")
    ap.add_argument("--profile", action="store_true",
                    help="trace the last step with torch.profiler and print "
                         "the top host ops and device kernels")
    return ap


def _refuse_unported(args) -> None:
    if args.zero1:
        raise NotImplementedError(_UNPORTED["zero1"])
    if args.schedule == "bucketed":
        raise NotImplementedError(_UNPORTED["bucketed"])
    if args.elastic or args.kill_rank is not None:
        raise NotImplementedError(_UNPORTED["elastic"])
    if args.ckpt_dir:
        raise NotImplementedError(_UNPORTED["ckpt"])
    if args.sanitize or args.sanitize_out:
        raise NotImplementedError(_UNPORTED["sanitize"])


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def main(argv=None) -> list[dict]:
    """Run the launcher; returns the per-step history (also printed)."""
    args = _parser().parse_args(argv)
    _refuse_unported(args)
    device = resolve_device(args.device)
    cfg = configs.get_reduced(args.arch) if args.reduced else configs.get(args.arch)
    mesh = make_host_mesh(args.data_axis, args.model_axis)
    tcfg = TrainConfig(
        mode=args.mode,
        microbatches=args.microbatches,
        optimizer=OptConfig(lr=args.lr, total_steps=args.steps,
                            warmup_steps=min(20, args.steps // 5 + 1)),
        allreduce=args.allreduce,
        compression=args.compression,
    )
    step_fn, _, _ = make_train_step(cfg, tcfg, mesh, device=device)
    dcfg = DataConfig()
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    t0 = time.perf_counter()
    model = lm.init_params(cfg, seed=args.seed, device=device)
    opt_state = init_opt_state(cfg, tcfg, model)
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{cfg.name}: {n_params} parameters, {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, mode {args.mode}, data ranks "
          f"{args.data_axis * args.model_axis}, compute {cfg.dtype}, on "
          f"{device} (init {time.perf_counter() - t0:.2f}s)", flush=True)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    history = []
    tokens = args.batch * args.seq
    t_start = time.perf_counter()
    for step in range(args.steps):
        batch = synthetic_batch(dcfg, cfg, args.batch, args.seq, step)
        prof = _profiler(device) if args.profile and step == args.steps - 1 \
            else None
        sync()
        t1 = time.perf_counter()
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        sync()
        dt = time.perf_counter() - t1
        if prof is not None:
            prof.__exit__(None, None, None)
            report_profile(prof, dt)
        m = {k: float(v) for k, v in metrics.items()}
        rec = {"step": step, "time_s": dt, "tokens_per_s": tokens / dt, **m}
        if cuda:
            rec["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        history.append(rec)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {m['loss']:.4f} ce {m['ce']:.4f} "
                  f"lr {m['lr']:.2e} gnorm {m.get('grad_norm', 0):.2f} "
                  f"{dt * 1e3:.0f}ms {tokens / dt:.1f} tok/s", flush=True)
    total = time.perf_counter() - t_start
    first, last = history[0]["ce"], history[-1]["ce"]
    peak = (f"; peak device memory {torch.cuda.max_memory_allocated(device)} B"
            if cuda else "")
    print(f"done: {args.steps} steps in {total:.1f}s; ce {first:.3f} -> "
          f"{last:.3f}{peak}", flush=True)
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(history, f)
    return history


if __name__ == "__main__":
    main()

"""Serving launcher of the port: FMI continuous batching on the GPU.

Port of the continuous policy of :mod:`repro.launch.serve`.  It drives
:class:`repro_torch.serving.engine.ContinuousBatchingEngine` — the
tensor-parallel runtime with a rank-sharded paged KV cache, per-step
admit/evict, explicit decode collectives through the request layer, and
elastic kill-rank recovery — on ``--device`` (default ``cuda``; with no GPU
it fails rather than running on the CPU).  The model is the TP decoder at
the architecture's published widths; ``--dry-run`` serves the reference
launcher's reduced (smoke-test) widths instead.

    # serve 16 requests through the TP engine on 4 simulated ranks, decode
    # attention through the hand-written paged-attention kernel:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --tp 4 --requests 16 --batch 4 --kv-pages 64 --max-new 16 \\
        --attn kernel

    # kill rank 3 mid-decode and watch the engine heal:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --tp 4 --kill-rank 3 --kill-at-step 2 --attn kernel

    # tiny end-to-end run on the CPU:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --dry-run --device cpu

The fleet (``--fleet``) and the wave policy (``--batch-policy wave``) are
not ported yet and raise.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from ..serving.engine import ContinuousBatchingEngine
from ..serving.tp_lm import TPServeConfig

#: Published widths of the architectures the port serves, and the
#: reference launcher's reduced (smoke-test) widths of the same family.
ARCHS = {
    "qwen3-1.7b": {
        "full": dict(vocab_size=151936, d_model=2048, n_heads=16,
                     head_dim=128, d_ff=6144, n_layers=28),
        "reduced": dict(vocab_size=512, d_model=128, n_heads=4, head_dim=32,
                        d_ff=256, n_layers=2),
    },
}


def tp_config(arch: str, prompt_len: int, max_new: int,
              reduced: bool = False) -> TPServeConfig:
    """The TP serving model's shape for ``arch`` (``ff_chunks`` as in the
    reference launcher: ``max(4, n_heads)``)."""
    key = arch.lower().replace("_", "-")
    if key not in ARCHS:
        raise SystemExit(f"unknown --arch {arch!r}; the port serves "
                         f"{sorted(ARCHS)}")
    w = ARCHS[key]["reduced" if reduced else "full"]
    return TPServeConfig(max_len=prompt_len + max_new,
                         ff_chunks=max(4, w["n_heads"]), **w)


def _explain(scfg: TPServeConfig, args) -> None:
    from ..core.selector import explain_serve_plan

    full = tp_config(args.arch, args.prompt_len, args.max_new)
    print(f"production serve plan for {args.arch} "
          f"(full config, {args.channel} channel):\n")
    print(explain_serve_plan(
        full.d_model, full.n_layers, full.vocab_size, P=args.tp * 4,
        batch=args.batch * 4, prompt_len=args.prompt_len * 64,
        channels=(args.channel,), logits_mode=args.logits_mode,
    ))
    print(f"\n{'reduced ' if args.dry_run else ''}engine plan (what this "
          f"launcher runs, sim channel, tp={args.tp}):\n")
    with ContinuousBatchingEngine(
        scfg, world=args.tp, max_slots=args.batch, kv_pages=args.kv_pages,
        page_size=args.page_size, logits_mode=args.logits_mode,
        kv_dtype=args.kv_dtype, attn_backend=args.attn, device=args.device,
    ) as eng:
        print(explain_serve_plan(
            scfg.d_model, scfg.n_layers, scfg.vocab_size, P=args.tp,
            batch=args.batch, prompt_len=args.prompt_len,
            channels=(eng.channel,), logits_mode=args.logits_mode,
            flops_per_token=scfg.flops_per_token,
            kv_dtype=args.kv_dtype))


#: The port's own kernels, by the prefix of their names in ``csrc/``.
KERNEL_FAMILIES = ("flash_", "gla_", "paged_attention", "quantize",
                   "dequantize")


def report_profile(prof, wall_s: float) -> None:
    """Where the traced span's time went: host ops by self CPU time, device
    kernels by self device time, the device's busy share of the wall time,
    and each family of the port's own kernels with its share of the device
    time."""
    events = prof.key_averages()
    # device events only: a host op also reports the device time of the
    # kernels it launched, so summing every event would count them twice
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    print(f"profile: wall {wall_s*1e3:.3f} ms, device kernels "
          f"{dev_us/1e3:.3f} ms (busy {100*dev_us/1e6/wall_s:.2f}% of wall)")
    for fam in KERNEL_FAMILIES:
        mine = [e for e in kernels if f"::{fam}" in e.key]
        us = sum(e.self_device_time_total for e in mine)
        if mine:
            print(f"  {fam}* kernels: {us/1e3:.3f} ms in "
                  f"{sum(e.count for e in mine)} launches "
                  f"({100*us/max(dev_us, 1e-9):.2f}% of device time)")
    for rows, key, title in ((events, "self_cpu_time_total", "host ops"),
                             (kernels, "self_device_time_total",
                              "device kernels")):
        print(f"top {title}:")
        for e in sorted(rows, key=lambda e: -getattr(e, key))[:12]:
            print(f"  {getattr(e, key)/1e3:10.3f} ms  {e.count:7d}x  "
                  f"{e.key[:90]}")


def _run_continuous(scfg: TPServeConfig, args) -> None:
    rng = np.random.default_rng(args.seed)
    with ContinuousBatchingEngine(
        scfg, world=args.tp, max_slots=args.batch, kv_pages=args.kv_pages,
        page_size=args.page_size, seed=args.seed,
        logits_mode=args.logits_mode, kv_dtype=args.kv_dtype,
        attn_backend=args.attn, device=args.device,
    ) as eng:
        for _ in range(args.requests):
            plen = int(rng.integers(max(1, args.prompt_len // 2),
                                    args.prompt_len + 1))
            eng.submit(rng.integers(0, scfg.vocab_size, plen),
                       max_new=args.max_new)
        prof = None
        if args.profile:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if eng.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
        t0 = time.perf_counter()
        step = 0
        heals = 0
        while not eng.done:
            if args.kill_rank is not None and step == args.kill_at_step:
                print(f"step {step}: injecting failure of rank "
                      f"{args.kill_rank} (mid-collective)")
                eng.transport.kill(args.kill_rank, after_rounds=3)
            done, healed = eng.step_or_heal()
            if healed:
                heals += 1
                h = eng.controller.history[-1]
                print(f"healed: regrouped to world={h['dp']} "
                      f"(cancelled {h['cancelled']} in-flight, replayed "
                      f"{h['step']} sequences from the KV-page manifest)")
            if done:
                print(f"step {step}: finished {done} "
                      f"(active {len(eng.active)}, waiting "
                      f"{len(eng.waiting)}, "
                      f"pages {eng.kv.pages_in_use}/{eng.kv.n_pages})")
            step += 1
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        dt = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
            report_profile(prof, dt)
        toks = eng.tokens_emitted
        waits = sum(w for _, _, w in eng.comm_log)
        print(f"served {len(eng.finished)} requests / {toks} tokens in "
              f"{dt:.2f}s ({toks/dt:.1f} tok/s greedy, tp={eng.world} "
              f"sim ranks on {eng.device}, {heals} heal(s), comm wait "
              f"{waits*1e3:.1f}ms, peak pages "
              f"{eng.kv.peak_in_use}/{eng.kv.n_pages} "
              f"[{args.kv_dtype}: {eng.kv.peak_in_use*eng.kv.page_nbytes}"
              f" B/rank], attn={args.attn})")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the engine runs (no silent CPU fallback)")
    ap.add_argument("--batch-policy", choices=["continuous", "wave"],
                    default="continuous")
    ap.add_argument("--tp", type=int, default=2,
                    help="tensor-parallel world size")
    ap.add_argument("--batch", type=int, default=4,
                    help="max concurrent slots")
    ap.add_argument("--kv-pages", type=int, default=64,
                    help="KV page-pool size per rank shard")
    ap.add_argument("--page-size", type=int, default=8,
                    help="tokens per KV page")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--channel", default="ici",
                    help="channel the production --explain plan prices")
    ap.add_argument("--logits-mode", choices=["gather", "local-argmax"],
                    default="gather")
    ap.add_argument("--kv-dtype", choices=["f32", "bf16", "int8", "fp8"],
                    default="f32",
                    help="KV page storage tier (int8: 4x smaller pages, "
                    "per-(page, head) scales; emission wire follows)")
    ap.add_argument("--attn", choices=["gather", "kernel"],
                    default="gather",
                    help="decode attention backend: gather-and-pad, or the "
                    "paged-attention kernel reading the page pool in place")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kill-rank", type=int, default=None,
                    help="inject a rank failure mid-decode (elastic demo)")
    ap.add_argument("--kill-at-step", type=int, default=2)
    ap.add_argument("--fleet", type=int, default=0,
                    help="fleet of engine replicas (not ported yet)")
    ap.add_argument("--explain", action="store_true",
                    help="print the serve_plan tables (prefill + decode) "
                    "and exit")
    ap.add_argument("--dry-run", action="store_true",
                    help="tiny end-to-end smoke run at the reduced widths")
    ap.add_argument("--profile", action="store_true",
                    help="trace the serve loop with torch.profiler and print "
                    "where the host and device time went")
    args = ap.parse_args(argv)

    if args.fleet:
        raise SystemExit("--fleet is not yet ported (ROADMAP Queue 1, item 9)")
    if args.batch_policy == "wave":
        raise SystemExit("--batch-policy wave is not yet ported "
                         "(ROADMAP Queue 1, item 16)")
    if args.dry_run:
        args.requests = min(args.requests, 3)
        args.prompt_len = min(args.prompt_len, 4)
        args.max_new = min(args.max_new, 4)
        args.kv_pages = min(args.kv_pages, 16)
    scfg = tp_config(args.arch, args.prompt_len, args.max_new,
                     reduced=args.dry_run)
    if args.explain:
        _explain(scfg, args)
        return
    _run_continuous(scfg, args)
    if args.dry_run:
        print("dry-run ok")


if __name__ == "__main__":
    main()

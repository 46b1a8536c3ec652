#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card, drives the
port's main path — ``ContinuousBatchingEngine`` serving requests with
tensor-parallel decode at the published widths of qwen3-1.7b, decode
attention through the paged-attention kernel — and checks the serving
contract (cross-world token identity, kill-rank heal replay).  Every
phase prints one line; any failure raises and exits non-zero.  The last
lines are the card (``nvidia-smi`` name and power limit), one JSON object
with the kernels' numbers, and ``{"ok": true, "device": {...}}``.

It needs CUDA and the rest of the repository: without a GPU, or run from a
directory that holds nothing else of the repository, it exits non-zero and
prints no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import os
import sys

# cuBLAS is deterministic only with a fixed workspace, set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.modules["jax"] = None  # the port must never reach for JAX

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS = 67e12  # H100 SXM float32 rate outside the tensor cores
TIER_ORACLE = dict(rtol=2e-6, atol=2e-6)
TIER_INT8_VS_F32 = dict(rtol=0.0, atol=5e-2)

# the main path: the launcher's model at qwen3-1.7b's published widths over
# 4 simulated TP ranks, 8-token pages, 64 pages per rank; the contract phase
# cuts the depth to 4 layers
ARCH, CONTRACT_LAYERS = "qwen3-1.7b", 4
PS, WORLD, PAGES_PER_RANK = 8, 4, 64


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3 helpers: inputs at the slice's shapes
# ---------------------------------------------------------------------------


def quantize_pages(x: torch.Tensor):
    """Per-(page, head) symmetric int8 over ``[n_pages, ps, H, d]`` (scale
    = max-abs / 127, 1.0 for a zero block; round half to even, clip)."""
    amax = x.abs().amax(dim=(1, 3))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale[:, None, :, None]), -127, 127)
    return q.to(torch.int8), scale


def make_case(rng, cfg, rows: int, npm: int, dev, layers: int = 1):
    """Stacked pools of WORLD ranks x PAGES_PER_RANK pages (``layers`` of
    them) at ``cfg``'s head widths, a page table of ``npm`` distinct
    rank-local pages per row, and lengths in [1, npm*ps]; heads map to ranks
    as the TP engine maps them."""
    HQ, HD = cfg.n_heads, cfg.head_dim
    Hl = HQ // WORLD
    n_pages = WORLD * PAGES_PER_RANK
    f = lambda *s: torch.as_tensor(  # noqa: E731
        rng.standard_normal(s).astype(np.float32), device=dev)
    q = f(rows, HQ, HD)
    k = f(layers, n_pages, PS, Hl, HD)
    v = f(layers, n_pages, PS, Hl, HD)
    table = np.stack([rng.choice(PAGES_PER_RANK, npm, replace=False)
                      for _ in range(rows)]).astype(np.int32)
    lengths = rng.integers(1, npm * PS + 1, size=rows).astype(np.int32)
    lengths[0] = npm * PS  # one full row
    heads = np.arange(HQ)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)  # noqa: E731
    return dict(q=q, k=k, v=v, table=i32(table), lengths=i32(lengths),
                kv_head=i32(heads % Hl),
                page_offset=i32((heads // Hl) * PAGES_PER_RANK),
                lengths_np=lengths)


def tier_pools(k: torch.Tensor, v: torch.Tensor, tier: str):
    """(k_pages, v_pages, k_scale, v_scale) of one storage tier."""
    if tier == "f32":
        return k, v, None, None
    if tier == "bf16":
        return k.to(torch.bfloat16), v.to(torch.bfloat16), None, None
    if tier == "fp8":
        return (k.to(torch.float8_e4m3fn), v.to(torch.float8_e4m3fn),
                None, None)
    kq, ks = quantize_pages(k)
    vq, vs = quantize_pages(v)
    return kq, vq, ks, vs


def full_scales(scale, kp):
    if scale is not None:
        return scale
    return torch.ones(kp.shape[0], kp.shape[2], dtype=torch.float32,
                      device=kp.device)


def time_ms(fn, iters: int) -> tuple[float, float]:
    """``(device_ms, stream_ms)`` per call of ``fn`` over ``iters`` calls,
    after a warm-up.  ``device_ms`` sums the device time of every kernel
    the calls launched (``torch.profiler``); ``stream_ms`` is the CUDA-event
    span of the whole loop, so it also holds the gaps where the device
    waited for the host.  Where the profiler records no device time,
    ``device_ms`` is the event span too."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    stream_ms = start.elapsed_time(end) / iters
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    device_us = sum(getattr(e, "self_device_time_total", 0.0) or
                    getattr(e, "self_cuda_time_total", 0.0)
                    for e in prof.key_averages())
    device_ms = device_us / 1e3 / iters if device_us > 0 else stream_ms
    return device_ms, stream_ms


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_kernel(pa, cfg, seed: int, dev) -> dict:
    """Kernel vs plain on all four pool tiers, the five bitwise
    invariances, the zero-length row, and the timings, at the head widths
    and depth of ``cfg``."""
    rng = np.random.default_rng(seed)
    HQ, HD = cfg.n_heads, cfg.head_dim
    kern, plain = pa.paged_attention, pa.paged_attention_plain
    max_err = 0.0

    def both(c, kp, vp, ks, vs):
        args = dict(q=c["q"], k_pages=kp, v_pages=vp, table=c["table"],
                    lengths=c["lengths"], k_scale=ks, v_scale=vs,
                    kv_head=c["kv_head"], page_offset=c["page_offset"])
        return kern(**args), plain(**args)

    for rows, npm in ((4, 4), (8, 8), (8, 5)):
        c = make_case(rng, cfg, rows, npm, dev)
        k, v = c["k"][0], c["v"][0]
        f32_out = None
        for tier in ("f32", "bf16", "int8", "fp8"):
            kp, vp, ks, vs = tier_pools(k, v, tier)
            got, want = both(c, kp, vp, ks, vs)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"{tier} rows={rows}: non-finite output")
            torch.testing.assert_close(got, want, **TIER_ORACLE)
            max_err = max(max_err, float((got - want).abs().max()))
            if tier == "f32":
                f32_out = got
            if tier == "int8":
                torch.testing.assert_close(got, f32_out, **TIER_INT8_VS_F32)
                if torch.equal(got, f32_out):
                    raise AssertionError("int8 tier equals f32: not quantized")
        log("kernel", f"rows={rows} npm={npm}: f32/bf16/int8/fp8 within "
                      f"rtol=atol=2e-6 of plain, int8 within atol=5e-2 of f32")

    # invariances (bitwise), on the f32 and int8 tiers
    c = make_case(rng, cfg, 6, 5, dev)
    for tier in ("f32", "int8"):
        kp, vp, ks, vs = tier_pools(c["k"][0], c["v"][0], tier)
        ks, vs = full_scales(ks, kp), full_scales(vs, vp)
        args = dict(k_scale=ks, v_scale=vs)
        full = kern(c["q"], kp, vp, c["table"], c["lengths"],
                    kv_head=c["kv_head"], page_offset=c["page_offset"], **args)
        for h in range(HQ):  # head partition
            one = kern(c["q"][:, h:h + 1].contiguous(), kp, vp, c["table"],
                       c["lengths"], kv_head=c["kv_head"][h:h + 1].contiguous(),
                       page_offset=c["page_offset"][h:h + 1].contiguous(),
                       **args)
            assert torch.equal(one[:, 0], full[:, h]), f"{tier} head {h}"
        for b in range(c["q"].shape[0]):  # row partition
            one = kern(c["q"][b:b + 1], kp, vp, c["table"][b:b + 1],
                       c["lengths"][b:b + 1], kv_head=c["kv_head"],
                       page_offset=c["page_offset"], **args)
            assert torch.equal(one[0], full[b]), f"{tier} row {b}"
        for extra in (1, 3):  # pad columns
            padded = torch.cat([c["table"], torch.zeros(
                (c["table"].shape[0], extra), dtype=torch.int32,
                device=dev)], dim=1)
            got = kern(c["q"], kp, vp, padded, c["lengths"],
                       kv_head=c["kv_head"], page_offset=c["page_offset"],
                       **args)
            assert torch.equal(got, full), f"{tier} pad {extra}"
        # page relocation: the same permutation inside every rank's region
        perm = rng.permutation(PAGES_PER_RANK)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(PAGES_PER_RANK)
        gperm = torch.as_tensor(np.concatenate(
            [r * PAGES_PER_RANK + perm for r in range(WORLD)]), device=dev)
        tbl = torch.as_tensor(inv[c["table"].cpu().numpy()].astype(np.int32),
                              device=dev)
        got = kern(c["q"], kp[gperm].contiguous(), vp[gperm].contiguous(),
                   tbl, c["lengths"], k_scale=ks[gperm].contiguous(),
                   v_scale=vs[gperm].contiguous(), kv_head=c["kv_head"],
                   page_offset=c["page_offset"])
        assert torch.equal(got, full), f"{tier} page relocation"
        # stacked pool vs per-rank calls
        Hl = HQ // WORLD
        for r in range(WORLD):
            sl = slice(r * PAGES_PER_RANK, (r + 1) * PAGES_PER_RANK)
            one = kern(c["q"][:, r * Hl:(r + 1) * Hl].contiguous(),
                       kp[sl].contiguous(), vp[sl].contiguous(), c["table"],
                       c["lengths"], k_scale=ks[sl].contiguous(),
                       v_scale=vs[sl].contiguous())
            assert torch.equal(one, full[:, r * Hl:(r + 1) * Hl]), \
                f"{tier} rank {r}"
        # zero-length row: exact zero, other rows untouched
        q0 = torch.cat([c["q"], c["q"][:1]])
        t0 = torch.cat([c["table"], c["table"][:1]])
        l0 = torch.cat([c["lengths"], torch.zeros(1, dtype=torch.int32,
                                                  device=dev)])
        got = kern(q0, kp, vp, t0, l0, kv_head=c["kv_head"],
                   page_offset=c["page_offset"], **args)
        assert torch.equal(got[:-1], full), f"{tier} zero row perturbs"
        assert bool((got[-1] == 0).all()), f"{tier} zero row not exact 0"
    torch.cuda.synchronize()
    log("kernel", "bitwise: head partition, row partition, pad columns, "
                  "page relocation, stacked pool vs per-rank, zero-length "
                  "row = exact 0 (f32 and int8 pools)")

    # timing at the decode shape of the serve phase, called as the engine
    # calls it (scales passed in, deterministic mode on): 4 rows, 4 pages
    # each, rotating over every layer's pool so the pages come from device
    # memory
    layers = cfg.n_layers
    c = make_case(rng, cfg, 4, 4, dev, layers=layers)
    lens = c["lengths_np"]
    ones = full_scales(None, c["k"][0])
    state = {"i": 0}

    def run_kernel():
        i = state["i"] = (state["i"] + 1) % layers
        kern(c["q"], c["k"][i], c["v"][i], c["table"], c["lengths"],
             k_scale=ones, v_scale=ones, kv_head=c["kv_head"],
             page_offset=c["page_offset"])

    def run_plain():
        i = state["i"] = (state["i"] + 1) % layers
        plain(c["q"], c["k"][i], c["v"][i], c["table"], c["lengths"],
              k_scale=ones, v_scale=ones, kv_head=c["kv_head"],
              page_offset=c["page_offset"])

    # the library yardstick: SDPA over K/V already gathered contiguously
    S = c["table"].shape[1] * PS
    gathered = []
    for i in range(layers):
        pages = (c["table"].long()[:, None, :] +
                 c["page_offset"].long()[None, :, None])  # [B, Hq, npm]
        hsel = c["kv_head"].long()[None, :, None].expand_as(pages)
        kk = c["k"][i][pages, :, hsel].reshape(4, HQ, S, HD)
        vv = c["v"][i][pages, :, hsel].reshape(4, HQ, S, HD)
        gathered.append((kk.contiguous(), vv.contiguous()))
    mask = (torch.arange(S, device=dev)[None, :] <
            c["lengths"].long()[:, None])[:, None, None, :]  # [B, 1, 1, S]
    q4 = c["q"][:, :, None, :]

    def run_library():
        i = state["i"] = (state["i"] + 1) % layers
        torch.nn.functional.scaled_dot_product_attention(
            q4, gathered[i][0], gathered[i][1], attn_mask=mask)

    times = {}
    for name, fn in (("plain", run_plain), ("kernel", run_kernel),
                     ("kernel2", run_kernel), ("plain2", run_plain),
                     ("library", run_library)):
        times[name] = time_ms(fn, 280)
    ms = min(times["kernel"][0], times["kernel2"][0])
    plain_ms = min(times["plain"][0], times["plain2"][0])
    # least work: each visible token's K and V row read once per head, q
    # read once, out written once; table/lengths/head maps are negligible
    kv_bytes = int(2 * HQ * int(lens.sum()) * HD * 4)
    io_bytes = kv_bytes + 2 * 4 * HQ * HD * 4
    flops = 4.0 * HQ * int(lens.sum()) * HD
    bound_bytes_ms = io_bytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = flops / F32_FLOPS * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    log("kernel", f"decode shape rows=4 Hq={HQ} d={HD} ps={PS} npm=4 "
                  f"lengths={lens.tolist()}, device time per call (stream "
                  f"span per call incl. host gaps): kernel "
                  f"{times['kernel'][0]:.6f}/{times['kernel2'][0]:.6f} ms "
                  f"({times['kernel'][1]:.6f}/{times['kernel2'][1]:.6f}), "
                  f"plain {times['plain'][0]:.6f}/{times['plain2'][0]:.6f} ms "
                  f"({times['plain'][1]:.6f}/{times['plain2'][1]:.6f}), "
                  f"SDPA on gathered K/V {times['library'][0]:.6f} ms "
                  f"({times['library'][1]:.6f}); moves {io_bytes} B "
                  f"({kv_bytes} B of K/V, {io_bytes - kv_bytes} B of q and "
                  f"out), bound {bound_ms:.6f} ms at 3.35 TB/s")
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:131",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else
            "operations",
            "library_ms": times["library"][0]}


def serve(eng_cls, cfg, params, prompts, max_new, kill=None, **kw):
    """Run every prompt to completion; returns (tokens by request, engine
    facts)."""
    with eng_cls(cfg, params=params, **kw) as eng:
        for p in prompts:
            eng.submit(p, max_new=max_new)
        heals, n = 0, 0
        while not eng.done:
            if n > 10_000:
                raise AssertionError("engine did not finish")
            if kill is not None and n == kill[1]:
                eng.transport.kill(kill[0], after_rounds=3)
            _, healed = eng.step_or_heal()
            heals += healed
            n += 1
        out = {k: [int(t) for t in v] for k, v in eng.finished.items()}
        facts = dict(world=eng.world, heals=heals,
                     decode_steps=eng.decode_steps,
                     peak_pages=eng.kv.peak_in_use, n_pages=eng.kv.n_pages,
                     tokens=eng.tokens_emitted,
                     pending=eng.transport.trace.pending,
                     pages=eng.kv.pages_in_use)
        return out, facts


def phase_serve(pa, seed: int, dev) -> int:
    """The main path at full width: returns the kernel launches it made."""
    from repro_torch.launch.serve import tp_config
    from repro_torch.serving.engine import ContinuousBatchingEngine
    from repro_torch.serving.tp_lm import init_params

    rng = np.random.default_rng(seed)
    max_new = 16
    V = tp_config(ARCH, 0, 0).vocab_size
    prompts = [rng.integers(0, V, int(rng.integers(8, 17))).tolist()
               for _ in range(8)]
    cfg = tp_config(ARCH, max(map(len, prompts)), max_new)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in [params["embed"], params["pos"],
                                       params["head"]] +
                   [w for l in params["layers"] for w in l.values()])
    log("serve", f"{ARCH} widths: {n_params} parameters "
                 f"({n_params * 4 / 1e9:.2f} GB f32) drawn in "
                 f"{time.perf_counter() - t0:.2f}s")
    torch.cuda.reset_peak_memory_stats()
    pa.paged_attention.launches = 0
    t0 = time.perf_counter()
    out, facts = serve(ContinuousBatchingEngine, cfg, params, prompts,
                       max_new, world=WORLD, max_slots=4, kv_pages=64,
                       page_size=PS, attn_backend="kernel", kv_dtype="f32",
                       device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = pa.paged_attention.launches
    if sorted(out) != list(range(len(prompts))):
        raise AssertionError(f"finished {sorted(out)}")
    for sid, toks in out.items():
        if len(toks) != max_new or not all(0 <= t < cfg.vocab_size
                                           for t in toks):
            raise AssertionError(f"request {sid}: bad tokens {toks}")
    if launches <= 0 or launches != cfg.n_layers * facts["decode_steps"]:
        raise AssertionError(f"paged_attention launches {launches} != "
                             f"{cfg.n_layers} x {facts['decode_steps']} "
                             f"decode steps")
    if facts["pending"] or facts["pages"]:
        raise AssertionError(f"leaked requests/pages: {facts}")
    toks = facts["tokens"]
    log("serve", f"served {len(out)} requests / {toks} tokens in {dt:.3f}s "
                 f"({toks / dt:.3f} tok/s, world={WORLD} sim ranks on one "
                 f"card, attn=kernel, kv=f32), peak pages "
                 f"{facts['peak_pages']}/{facts['n_pages']}, peak device "
                 f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
                 f"paged_attention.launches={launches} = {cfg.n_layers} x "
                 f"{facts['decode_steps']} decode steps")
    del params
    torch.cuda.empty_cache()
    return launches


def phase_contract(seed: int, dev) -> None:
    """The serving contract on the card: a small model agrees with the
    port's CPU path; at full width (4 layers) world 1 == world 4, kernel ==
    gather, and the kill-rank heal (f32 and int8) replays the unfailed
    tokens."""
    from repro_torch.launch.serve import tp_config
    from repro_torch.serving.engine import ContinuousBatchingEngine as Eng
    from repro_torch.serving.tp_lm import (TPServeConfig, init_params,
                                           weights_from_reference)

    # small input, same weights on the card and on the CPU
    small = TPServeConfig(vocab_size=64, d_model=32, n_heads=4, head_dim=8,
                          d_ff=64, n_layers=2, max_len=32, ff_chunks=4)
    r = np.random.default_rng(seed)
    D, H, hd, F, V = 32, 4, 8, 64, 64
    w = lambda *s: (r.normal(size=s) * 0.08).astype(np.float32)  # noqa: E731
    logical = {"embed": w(V, D), "pos": w(32, D), "head": w(D, V),
               "layers": [{"wq": w(D, H, hd), "wk": w(D, H, hd),
                           "wv": w(D, H, hd), "wo": w(H, hd, D),
                           "w_up": w(D, F), "w_down": w(F, D)}
                          for _ in range(2)]}
    prompts = [[5, 9, 2], [7, 1], [3, 3, 3, 3], [11]]
    kw = dict(max_slots=3, kv_pages=16, page_size=4, attn_backend="kernel")
    for world in (1, 4):
        for kv_dtype in ("f32", "int8"):
            cpu, _ = serve(Eng, small, weights_from_reference(
                logical, small, "cpu"), prompts, 6, world=world,
                kv_dtype=kv_dtype, device="cpu", **kw)
            gpu, _ = serve(Eng, small, weights_from_reference(
                logical, small, dev), prompts, 6, world=world,
                kv_dtype=kv_dtype, device=dev, **kw)
            if cpu != gpu:
                raise AssertionError(f"small model world={world} {kv_dtype}:"
                                     f" card {gpu} != cpu {cpu}")
    log("contract", "small model: card tokens == CPU plain-path tokens "
                    "(kernel backend, world 1 and 4, f32 and int8)")

    rng = np.random.default_rng(seed + 1)
    max_new = 16
    V = tp_config(ARCH, 0, 0).vocab_size
    prompts = [rng.integers(0, V, int(rng.integers(8, 17))).tolist()
               for _ in range(8)]
    cfg = dataclasses.replace(tp_config(ARCH, max(map(len, prompts)),
                                        max_new), n_layers=CONTRACT_LAYERS)
    params = init_params(cfg, seed=seed, device=dev)
    kw = dict(max_slots=4, kv_pages=64, page_size=PS, device=dev)
    runs = {}
    for name, extra in (
        ("w1", dict(world=1, attn_backend="kernel")),
        ("w4", dict(world=4, attn_backend="kernel")),
        ("w4_gather", dict(world=4, attn_backend="gather")),
        ("w4_kill", dict(world=4, attn_backend="kernel", kill=(3, 2))),
        ("w4_i8", dict(world=4, attn_backend="kernel", kv_dtype="int8")),
        ("w4_i8_kill", dict(world=4, attn_backend="kernel", kv_dtype="int8",
                            kill=(3, 2))),
    ):
        runs[name] = serve(Eng, cfg, params, prompts, max_new, **kw, **extra)
    tok = {k: v[0] for k, v in runs.items()}
    if tok["w1"] != tok["w4"]:
        raise AssertionError("world 1 and world 4 tokens differ")
    if tok["w4_gather"] != tok["w4"]:
        raise AssertionError("gather and kernel backends emit different "
                             "tokens")
    for name, base in (("w4_kill", "w4"), ("w4_i8_kill", "w4_i8")):
        facts = runs[name][1]
        if facts["heals"] != 1 or facts["world"] != 2:
            raise AssertionError(f"{name}: heal facts {facts}")
        if tok[name] != tok[base]:
            raise AssertionError(f"{name}: healed tokens differ from {base}")
    log("contract", f"{ARCH} widths, {cfg.n_layers} layers, "
                    f"{len(prompts)} requests x "
                    f"{max_new} tokens: world 1 == world 4, kernel == gather, "
                    f"kill_rank(3, after_rounds=3) at step 2 heals to world 2 "
                    f"and replays the unfailed tokens (f32 and int8)")
    del params
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.serve import tp_config

    # 1. device and numerics settings
    smi = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda", 0)
    log("device", f"{smi}; torch {torch.__version__} CUDA "
                  f"{torch.version.cuda}; deterministic algorithms on, "
                  f"TF32 off")

    # 2. build every kernel from the checkout's sources
    t0 = time.perf_counter()
    libs = _build.build(_build.sources())
    log("build", f"{len(libs)} kernel(s) built in "
                 f"{time.perf_counter() - t0:.2f}s: "
                 f"{', '.join(sorted(libs))}")
    for name, rec in _build.BUILD_LOG.items():
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"{name}: {line.strip()}")

    # 3. kernel vs plain, invariances, timings
    record = phase_kernel(pa, tp_config(ARCH, 16, 16), args.seed, dev)

    # 4. the main path at full width; 5. the contract on the card
    record["launches"] = phase_serve(pa, args.seed, dev)
    phase_contract(args.seed, dev)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi)
    print(json.dumps({"kernels": [{k: record[k] for k in keys}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

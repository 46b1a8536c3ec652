"""Model-driven channel/algorithm selection (the paper's §5 pay-off).

Port of :mod:`repro.core.selector`, framework-free and kept line for line
so that its tables are string-equal to the reference's.  The flow-level
backend (``explain(flow=True)``, :func:`calibrate`) is not ported yet
(ROADMAP Queue 1, item 3).

Given (op, payload bytes, participants, channels, objective) the selector
enumerates every feasible candidate, prices it with the α-β(+γ) time model
and the $ model, and returns the argmin.  ``explain()`` returns the full
candidate table — used by benchmarks and by ``launch/dryrun.py --explain``.

Three candidate families (vs. the seed's single flat family):

* **flat direct/provider** — every algorithm in ``models.DIRECT_ALGOS`` on
  every registered channel, and for the bandwidth-class algorithms every
  pipeline depth in ``models.PIPELINE_DEPTHS`` (chunk streaming: round
  k+1's send overlaps round k's reduce; see ``algorithms.PIPELINED``);
* **mediated storage** — the paper's S3/DynamoDB/Redis collectives, priced
  by operation counts (``models.mediated_collective``);
* **hierarchical composites** — two-level allreduce from
  :mod:`repro_torch.core.hierarchical`: reduce-scatter on the inner channel,
  allreduce of the owned chunk on the outer channel, allgather back on the
  inner channel.  Channel name ``"<inner>+<outer>"``, mirroring the paper's
  hierarchical multi-protocol communication.

Channels are resolved through :mod:`repro_torch.core.channels` — registering a new
channel there makes it a selector candidate with no change here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Mapping

from .channels import default_channels, get_channel
from .models import (
    DIRECT_ALGOS,
    FAAS_CHANNELS,
    GAMMA_REDUCE,
    PIPELINE_DEPTHS,
    PIPELINEABLE,
    STORAGE_CHANNELS,
    feasible,
    is_pow2,
    mediated_collective,
)
from .pricing import P_CHIP_S


@dataclass(frozen=True)
class Candidate:
    op: str
    channel: str  # registry name, or "<inner>+<outer>" for composites
    algorithm: str
    time_s: float
    price_usd: float
    depth: int = 1  # chunk-pipelining depth (1 = unpipelined)

    @property
    def hierarchical(self) -> bool:
        return "+" in self.channel

    def objective(self, objective: str, price_weight: float = 0.5) -> float:
        if objective == "time":
            return self.time_s
        if objective == "price":
            return self.price_usd
        if objective == "weighted":
            return (1 - price_weight) * self.time_s + price_weight * self.price_usd
        raise ValueError(f"unknown objective {objective!r}")


def _flowsim(name: str):
    """The flow-level simulation backend is not ported yet."""
    raise NotImplementedError(
        f"flowsim.{name} is not ported yet (ROADMAP Queue 1, item 3)")


def _default_inner(P: int) -> int | None:
    """Default two-level split: the largest proper power-of-two divisor
    (stands in for the pod size when the caller gives no topology)."""
    d = 1 << (max(P - 1, 1).bit_length() - 1)  # largest pow2 < P
    while d > 1:
        if P % d == 0:
            return d
        d //= 2
    return None


def _flat_candidates(op, nbytes, P, ch_name, mem_gib, depths):
    ch = get_channel(ch_name)
    spec = ch.spec
    out = []
    if spec.kind == "mediated" and ch_name in STORAGE_CHANNELS:
        try:
            m = mediated_collective(op, nbytes, P, spec)
        except KeyError:
            return out
        cost = ch.price(op, nbytes, P, mem_gib=mem_gib)
        out.append(Candidate(op, ch_name, "storage", m.time, cost.total_usd))
        return out
    for algo in DIRECT_ALGOS.get(op, []):
        if not feasible(op, algo, P):
            continue
        algo_depths = depths if (op, algo) in PIPELINEABLE else (1,)
        for depth in algo_depths:
            t = ch.time(op, algo, nbytes, P, depth=depth)
            cost = ch.price(op, nbytes, P, algo=algo, mem_gib=mem_gib, time_s=t)
            out.append(Candidate(op, ch_name, algo, t, cost.total_usd, depth=depth))
    return out


def _hier_candidates(op, nbytes, P, channels, inner_P, mem_gib):
    """Two-level composites over ordered channel pairs (allreduce only —
    the op hierarchical.py implements).  FaaS-priced channels (AWS
    storage + direct TCP) are excluded: their per-function dollar model
    doesn't compose with the chip-occupancy price composites are billed at,
    and the storage ones have no round-schedule algorithms at all."""
    from .hierarchical import hierarchical_time

    if op != "allreduce":
        return []
    iP = inner_P if inner_P is not None else _default_inner(P)
    if not iP or not (1 < iP < P) or P % iP:
        return []
    oP = P // iP
    inner_rs = "recursive_halving" if is_pow2(iP) else "ring"
    inner_ag = "recursive_doubling" if is_pow2(iP) else "ring"
    legs = [
        c for c in channels
        if c not in FAAS_CHANNELS and get_channel(c).spec.kind != "provider"
    ]  # provider (xla) shares ici's wire: composing it would duplicate rows
    out = []
    for ci in legs:
        for co in legs:
            if ci == co:
                continue
            # gamma: same reduce-compute basis the flat candidates pay
            t = hierarchical_time(
                nbytes, iP, oP, inner_channel=ci, outer_channel=co,
                inner_rs=inner_rs, inner_ag=inner_ag, gamma=GAMMA_REDUCE,
            )
            # composite occupancy price: all P ranks are busy end-to-end
            price = P * t * P_CHIP_S
            out.append(
                Candidate(op, f"{ci}+{co}", f"hier[{iP}x{oP}](rs+ar+ag)",
                          t, price)
            )
    return out


def candidates(
    op: str,
    nbytes: float,
    P: int,
    channels: tuple[str, ...] | None = None,
    mem_gib: float = 2.0,
    inner_P: int | None = None,
    depths: tuple[int, ...] = PIPELINE_DEPTHS,
    hierarchical: bool = True,
    calibration: "Calibration | None" = None,
) -> list[Candidate]:
    if channels is None:
        channels = default_channels()
    out: list[Candidate] = []
    for ch_name in channels:
        out.extend(_flat_candidates(op, nbytes, P, ch_name, mem_gib, depths))
    if hierarchical and len(channels) > 1:
        out.extend(_hier_candidates(op, nbytes, P, channels, inner_P, mem_gib))
    if calibration is not None:
        out = [replace(c, time_s=calibration.apply(c.channel, c.time_s))
               for c in out]
    return out


def select(
    op: str,
    nbytes: float,
    P: int,
    channels: tuple[str, ...] | None = None,
    objective: str = "time",
    mem_gib: float = 2.0,
    price_weight: float = 0.5,
    inner_P: int | None = None,
    calibration: "Calibration | None" = None,
) -> Candidate:
    cands = candidates(op, nbytes, P, channels, mem_gib, inner_P=inner_P,
                       calibration=calibration)
    if not cands:
        raise ValueError(f"no feasible algorithm for {op} with P={P} on {channels}")
    return min(cands, key=lambda c: c.objective(objective, price_weight))


def crossover_nbytes(
    op: str,
    P: int,
    fast: str,
    slow: str,
    lo: float = 8.0,
    hi: float = float(1 << 30),
    objective: str = "time",
    rel_tol: float = 0.01,
) -> float:
    """Payload size where the selector's pick flips from the low-latency
    channel ``fast`` to the high-bandwidth channel ``slow``.

    The α-β model makes every per-candidate time affine in ``nbytes``, so
    the best-of-each-channel envelope crosses once: below the returned size
    ``fast`` wins (its smaller α dominates), above it ``slow`` wins (its
    smaller effective β does).  Bisects the flat-candidate envelope
    (hierarchical composites would blur the two-channel comparison) to
    ``rel_tol`` relative precision.  This is how the ``rdma`` lease channel
    is priced against the two-sided channels — e.g. rdma wins the 8-byte
    decode argmax exchange and hands over to the host broker at ~100 KB:

    >>> xb = crossover_nbytes("allreduce", 8, "rdma", "host")
    >>> pick = lambda n: select("allreduce", n, 8,
    ...                         channels=("rdma", "host")).channel
    >>> pick(64), pick(xb * 4)
    ('rdma', 'host')
    """

    def pick(n: float) -> str:
        cands = candidates(op, n, P, (fast, slow), hierarchical=False)
        if not cands:
            raise ValueError(f"no feasible algorithm for {op} with P={P}")
        return min(cands, key=lambda c: c.objective(objective)).channel

    if pick(lo) != fast:
        raise ValueError(f"{fast!r} does not win at nbytes={lo}")
    if pick(hi) != slow:
        raise ValueError(f"{slow!r} does not win at nbytes={hi}")
    while hi / lo > 1.0 + rel_tol:
        mid = math.sqrt(lo * hi)
        if pick(mid) == fast:
            lo = mid
        else:
            hi = mid
    return math.sqrt(lo * hi)


# ---------------------------------------------------------------------------
# Bucket planning — how big should a fused communication bucket be?
# ---------------------------------------------------------------------------

# Candidate bucket sizes the planner prices (powers of two, 256 KiB..128 MiB);
# the full payload (one bucket) is always also a candidate.
BUCKET_SIZES: tuple[int, ...] = tuple((1 << 18) << k for k in range(10))


@dataclass(frozen=True)
class BucketPlan:
    """The selector's answer to "how should many small tensors be fused?"

    ``candidate`` is the best (channel, algorithm, depth) at the per-bucket
    payload size; ``time_s`` is the modeled *exposed* time of draining all
    ``n_buckets`` with overlap: every bucket but the last can hide behind
    the ``compute_s`` window it was issued under (gradients keep becoming
    ready while earlier buckets drain), the last bucket is always exposed.
    """

    op: str
    total_bytes: float
    P: int
    bucket_bytes: int
    n_buckets: int
    candidate: Candidate
    per_bucket_time_s: float
    time_s: float
    price_usd: float
    compute_s: float = 0.0
    slowdown: float = 1.0  # observed comm-slowdown factor the plan priced in


def _exposed_time(n: int, t_bucket: float, compute_s: float) -> float:
    """Critical path of draining ``n`` buckets of per-bucket time
    ``t_bucket`` issued across a ``compute_s``-long producer window: the
    first ``n-1`` buckets overlap whatever compute remains, the last cannot
    (it is only ready when the producer finishes)."""
    return max(compute_s, (n - 1) * t_bucket) + t_bucket


def bucket_plan(
    op: str,
    total_bytes: float,
    P: int,
    channels: tuple[str, ...] | None = None,
    objective: str = "time",
    mem_gib: float = 2.0,
    compute_s: float = 0.0,
    bucket_sizes: tuple[int, ...] = BUCKET_SIZES,
    price_weight: float = 0.5,
    slowdown: float = 1.0,
    calibration: "Calibration | None" = None,
) -> BucketPlan:
    """Choose the bucket size for coalescing a ``total_bytes`` payload that
    becomes ready incrementally (per-layer gradients) into fused collectives.

    ``slowdown`` (>= 1) stretches every candidate's wire time by an observed
    communication-slowdown factor — the straggler-mitigation hook:
    :meth:`repro.core.scheduler.CommScheduler.replan` re-plans with the
    factor the per-request wait-time trace implies, while the compute window
    is unaffected (the straggler slows the wire, not this rank's backward).

    The α-β trade the plan encodes: **latency-bound** payloads (small, or a
    high-α channel) want few big buckets — every extra bucket pays the full
    per-collective latency again; **bandwidth-bound** payloads with compute
    to hide behind (``compute_s > 0``) want smaller buckets — only the last
    bucket's wire time is exposed once the rest overlap the producer.  With
    ``compute_s == 0`` the plan degenerates to a single fused bucket (pure
    serialized α-β time is minimized by paying α once), which is exactly
    the blocking ``allreduce_tree`` behaviour.
    """
    total = max(1.0, float(total_bytes))
    slowdown = max(1.0, float(slowdown))
    sizes = sorted({int(b) for b in bucket_sizes if 0 < b < total} | {int(total)})
    best: BucketPlan | None = None
    for B in sizes:
        n = max(1, int(math.ceil(total / B)))
        per_bucket = total / n  # even split (the scheduler pads the tail)
        cand = select(op, per_bucket, P, channels=channels,
                      objective=objective, mem_gib=mem_gib,
                      price_weight=price_weight, calibration=calibration)
        t_bucket = cand.time_s * slowdown
        t = _exposed_time(n, t_bucket, compute_s)
        # occupancy pricing scales with actual wall time, so the slowdown
        # stretches the dollar cost too (price/weighted replans must react)
        price = n * cand.price_usd * slowdown
        plan = BucketPlan(op, total, P, B, n, cand, t_bucket, t, price,
                          compute_s, slowdown)
        key = {"time": t, "price": price,
               "weighted": (1 - price_weight) * t + price_weight * price}[objective]
        best_key = None if best is None else {
            "time": best.time_s, "price": best.price_usd,
            "weighted": (1 - price_weight) * best.time_s
            + price_weight * best.price_usd,
        }[objective]
        if best is None or key < best_key:
            best = plan
    assert best is not None
    return best


def explain_bucket_plan(
    op: str,
    total_bytes: float,
    P: int,
    channels: tuple[str, ...] | None = None,
    compute_s: float = 0.0,
    bucket_sizes: tuple[int, ...] = BUCKET_SIZES,
) -> str:
    """Full bucket-size table, chosen row marked — what
    ``launch/dryrun.py --explain`` prints under the flat candidate table."""
    total = max(1.0, float(total_bytes))
    chosen = bucket_plan(op, total, P, channels=channels, compute_s=compute_s,
                         bucket_sizes=bucket_sizes)
    sizes = sorted({int(b) for b in bucket_sizes if 0 < b < total} | {int(total)})
    lines = [
        f"bucket plan: {op}, {total/1e6:.1f} MB total, P={P}, "
        f"overlap window {compute_s*1e3:.2f} ms",
        f"{'':2s}{'bucket':>10s} {'n':>4s} {'channel':10s} {'algorithm':20s} "
        f"{'depth':>5s} {'t/bucket':>10s} {'exposed':>10s} {'price $':>12s}",
        "-" * 90,
    ]
    for B in sizes:
        n = max(1, int(math.ceil(total / B)))
        cand = select(op, total / n, P, channels=channels)
        t = _exposed_time(n, cand.time_s, compute_s)
        mark = "*" if B == chosen.bucket_bytes else " "
        lines.append(
            f"{mark:2s}{B/1e6:8.2f}MB {n:4d} {cand.channel:10s} "
            f"{cand.algorithm:20s} {cand.depth:5d} {cand.time_s*1e6:8.1f}us "
            f"{t*1e6:8.1f}us {n*cand.price_usd:12.3e}"
        )
    lines.append(
        f"-> bucket={chosen.bucket_bytes/1e6:.2f}MB x{chosen.n_buckets} on "
        f"{chosen.candidate.channel}/{chosen.candidate.algorithm} "
        f"depth={chosen.candidate.depth}: exposed {chosen.time_s*1e6:.1f}us, "
        f"${chosen.price_usd:.3e}"
    )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Serve planning — price the two inference regimes per step (the serving
# runtime's cost question; see serving/engine.py and docs/serving.md)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ServePhase:
    """One priced inference regime (``'prefill'`` or ``'decode'``).

    ``allreduce`` is the candidate chosen for the per-layer TP-partial
    sync (2 per layer), ``allgather`` the one for the token-emission
    exchange; ``step_s = compute_s + comm_s`` is the modeled step latency
    and ``usd_per_mtok`` its chip-occupancy price per million tokens
    (:func:`repro_torch.core.pricing.usd_per_mtok`)."""

    phase: str
    tokens_per_step: float
    nbytes_allreduce: float
    nbytes_allgather: float
    allreduce: Candidate | None
    allgather: Candidate | None
    comm_s: float
    compute_s: float
    step_s: float
    usd_per_step: float
    usd_per_mtok: float


@dataclass(frozen=True)
class ServePlan:
    """The serving cost model's answer for one engine shape: both regimes
    priced with the same α-β(+γ) channel models the selector uses
    everywhere else.  ``kv_dtype`` is the engine's KV/emission storage tier;
    ``kv_bytes_per_token`` the per-rank cache growth per decoded token
    (what admission capacity scales with — int8 quarters it vs f32)."""

    P: int
    batch: int
    prompt_len: int
    d_model: int
    n_layers: int
    vocab_size: int
    prefill: ServePhase
    decode: ServePhase
    kv_dtype: str = "f32"
    kv_bytes_per_token: float = 0.0


def serve_plan(
    d_model: int,
    n_layers: int,
    vocab_size: int,
    P: int,
    batch: int,
    prompt_len: int,
    channels: tuple[str, ...] | None = None,
    objective: str = "time",
    itemsize: int = 4,
    flops_per_token: float | None = None,
    peak_flops: float | None = None,
    mem_gib: float = 2.0,
    logits_mode: str = "gather",
    kv_dtype: str = "f32",
) -> ServePlan:
    """Price one decode step and one prefill step of a TP-sharded server.

    Per layer a TP decode step moves two row-parallel partial allreduces of
    ``batch·d_model`` elements (attention output + MLP down projection) and
    one token-emission allgather of the vocab-sharded logits
    (``batch·vocab`` elements under ``logits_mode='gather'``, a ``batch·2``
    max/argmax pair under ``'local-argmax'``).  Prefill moves the same
    traffic scaled by ``prompt_len``.  The two regimes therefore sit at
    opposite ends of the α-β trade — decode is **latency-bound** (small
    messages: the selector leans to recursive doubling at depth 1), prefill
    **bandwidth-bound** (the selector leans to ring/Rabenseifner and picks
    a chunk-pipelining depth) — and FMI's model-driven selection applies to
    inference exactly as it does to training:

    >>> plan = serve_plan(d_model=4096, n_layers=32, vocab_size=128256,
    ...                   P=8, batch=4, prompt_len=2048, channels=("ici",))
    >>> plan.decode.allreduce.algorithm    # 64 KB: latency-optimal
    'recursive_doubling'
    >>> plan.prefill.allreduce.algorithm   # 134 MB: bandwidth-optimal
    'rabenseifner'
    >>> plan.decode.allreduce.depth, plan.prefill.allreduce.depth > 1
    (1, True)
    >>> plan.decode.usd_per_mtok > plan.prefill.usd_per_mtok  # amortization
    True

    The software channels show the same regime split: against the
    lease-based one-sided ``rdma`` channel and the ``hops=2`` host broker,
    the 8-bytes-per-rank ``local-argmax`` emission exchange is pure latency
    — rdma wins — while the bandwidth-bound prefill allreduce falls back to
    the broker past the modeled crossover (:func:`crossover_nbytes`):

    >>> soft = serve_plan(d_model=4096, n_layers=32, vocab_size=128256,
    ...                   P=8, batch=4, prompt_len=2048,
    ...                   channels=("rdma", "host"),
    ...                   logits_mode="local-argmax")
    >>> soft.decode.allgather.channel      # 8 B/rank max+argmax pair
    'rdma'
    >>> soft.prefill.allreduce.channel     # 134 MB: bandwidth-bound
    'host'

    ``compute_s`` comes from ``flops_per_token`` (default: the dense
    ``12·L·D² + 2·D·V`` estimate) over ``P`` chips at ``peak_flops``
    (default v5e bf16); the dollar column is chip occupancy of the whole
    step — compute *and* exposed communication — so shaving the collective
    time shows up directly in $/1M tokens.

    ``kv_dtype`` is the engine's quantization tier
    (:data:`repro_torch.serving.kv_cache.KV_ITEMSIZE`): the emission wire follows
    it in the engine, so under ``logits_mode='gather'`` the logits
    allgather payload shrinks with the tier (int8 → 4× smaller than f32),
    and ``kv_bytes_per_token`` reports the per-rank cache footprint the
    tier buys back.  The ``local-argmax`` 8-byte exchange is already
    minimal and is priced unquantized."""
    from ..serving.kv_cache import KV_ITEMSIZE
    from .models import V5E
    from .pricing import usd_per_mtok

    if peak_flops is None:
        peak_flops = V5E.peak_flops_bf16
    if flops_per_token is None:
        flops_per_token = 2.0 * (12 * n_layers * d_model * d_model
                                 + 2 * d_model * vocab_size)
    kv_item = KV_ITEMSIZE[kv_dtype]

    def phase(name: str, tokens: int) -> ServePhase:
        # per-step payloads: `tokens` activation rows in flight at once
        ar_bytes = float(batch * tokens * d_model * itemsize)
        if logits_mode == "local-argmax":
            ag_bytes = float(P * batch * 2 * itemsize)
        else:
            # the engine quantizes the emission wire to the KV tier
            ag_bytes = float(batch * vocab_size * kv_item)
        if P > 1:
            ar = select("allreduce", ar_bytes, P, channels=channels,
                        objective=objective, mem_gib=mem_gib)
            ag = select("allgather", ag_bytes, P, channels=channels,
                        objective=objective, mem_gib=mem_gib)
            comm_s = 2 * n_layers * ar.time_s + ag.time_s
        else:
            ar = ag = None
            comm_s = 0.0
        compute_s = flops_per_token * batch * tokens / (P * peak_flops)
        step_s = compute_s + comm_s
        tps = float(batch * tokens)
        usd_step = P * step_s * P_CHIP_S
        return ServePhase(name, tps, ar_bytes, ag_bytes, ar, ag, comm_s,
                          compute_s, step_s, usd_step,
                          usd_per_mtok(P, step_s, tps))

    # per-rank KV growth per decoded token: K+V across layers, head-sharded
    kv_bpt = 2.0 * n_layers * d_model * kv_item / P
    return ServePlan(P, batch, prompt_len, d_model, n_layers, vocab_size,
                     prefill=phase("prefill", prompt_len),
                     decode=phase("decode", 1),
                     kv_dtype=kv_dtype, kv_bytes_per_token=kv_bpt)


def explain_serve_plan(
    d_model: int,
    n_layers: int,
    vocab_size: int,
    P: int,
    batch: int,
    prompt_len: int,
    channels: tuple[str, ...] | None = None,
    **kwargs,
) -> str:
    """Both serving regimes as a table — what ``launch/serve.py --explain``
    prints: per regime the chosen (channel, algorithm, depth) for the
    TP-partial allreduce and the logits allgather, the predicted step
    latency split compute/comm, and the $/1M-tokens price."""
    def fmt_bytes(n: float) -> str:
        if n < 1e3:
            return f"{n:.0f}B"
        if n < 1e6:
            return f"{n/1e3:.1f}KB"
        return f"{n/1e6:.2f}MB"

    plan = serve_plan(d_model, n_layers, vocab_size, P, batch, prompt_len,
                      channels=channels, **kwargs)
    lines = [
        f"serve plan: P={P}, batch={batch}, prompt {prompt_len}, "
        f"d_model={d_model}, {n_layers} layers, vocab {vocab_size}",
        f"{'phase':8s} {'op':10s} {'payload':>10s} {'channel':10s} "
        f"{'algorithm':20s} {'depth':>5s} {'t/op':>10s} {'n/step':>6s}",
        "-" * 86,
    ]
    for ph in (plan.prefill, plan.decode):
        for op, cand, nbytes, n in (
            ("allreduce", ph.allreduce, ph.nbytes_allreduce, 2 * n_layers),
            ("allgather", ph.allgather, ph.nbytes_allgather, 1),
        ):
            if cand is None:
                lines.append(f"{ph.phase:8s} {op:10s} {fmt_bytes(nbytes):>10s} "
                             f"{'-':10s} {'(single rank)':20s} {'-':>5s} "
                             f"{0.0:8.1f}us {n:6d}")
                continue
            lines.append(
                f"{ph.phase:8s} {op:10s} {fmt_bytes(nbytes):>10s} "
                f"{cand.channel:10s} {cand.algorithm:20s} {cand.depth:5d} "
                f"{cand.time_s*1e6:8.1f}us {n:6d}"
            )
    lines.append("-" * 86)
    for ph in (plan.prefill, plan.decode):
        lines.append(
            f"-> {ph.phase}: step {ph.step_s*1e3:.3f}ms "
            f"(compute {ph.compute_s*1e3:.3f}ms + comm {ph.comm_s*1e3:.3f}ms), "
            f"{ph.tokens_per_step:.0f} tok/step, "
            f"${ph.usd_per_mtok:.4f}/1M tokens"
        )
    lines.append(
        f"-> kv: dtype {plan.kv_dtype}, "
        f"{plan.kv_bytes_per_token:.0f} B/token/rank cache growth"
    )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Fleet planning — scale-up (bigger TP) vs scale-out (more replicas) at an
# SLO (see serving/fleet.py and docs/fleet.md)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FleetOption:
    """One candidate fleet shape: ``replicas`` TP-``tp`` engines.

    ``modeled_p99_ms`` is the M/D/1-style sojourn bound at the offered
    load (``inf`` when the shape cannot keep up); ``usd_per_mtok`` is
    :func:`repro_torch.core.pricing.usd_per_mtok_at_slo` — ``inf`` when the
    shape misses the SLO, so an infeasible shape can never win on price."""

    tp: int
    replicas: int
    mode: str  # 'scale-up' | 'scale-out' | 'hybrid'
    chips: int
    step_s: float  # one replica's modeled decode step
    capacity_tps: float  # fleet-wide token throughput ceiling
    utilization: float
    modeled_p99_ms: float
    usd_per_mtok: float


@dataclass(frozen=True)
class FleetPlan:
    """The fleet cost model's answer: every (tp, replicas) shape on the
    grid, priced at the offered load against the p99 SLO, with ``best``
    the cheapest feasible shape (deterministic tie-break: fewer chips,
    lower p99, fewer replicas, lower tp)."""

    offered_tps: float
    slo_p99_ms: float
    options: tuple[FleetOption, ...]
    best: FleetOption


def fleet_plan(
    d_model: int,
    n_layers: int,
    vocab_size: int,
    offered_tps: float,
    slo_p99_ms: float,
    batch: int = 8,
    prompt_len: int = 64,
    tokens_per_request: int = 32,
    channels: tuple[str, ...] | None = None,
    max_chips: int = 32,
    tp_grid: tuple[int, ...] = (1, 2, 4, 8),
    replica_grid: tuple[int, ...] = (1, 2, 4, 8),
    cold_start_s: float = 2.0,
    horizon_s: float = 3600.0,
    **serve_kwargs,
) -> FleetPlan:
    """Price *scale-up vs scale-out* for a serving deployment.

    Both axes spend chips, but differently: **scale-up** (bigger TP per
    replica) shrinks the decode step via the same α-β collective terms
    :func:`serve_plan` prices — it buys *latency*, the only way to meet a
    tight SLO — while **scale-out** (more replicas) multiplies throughput
    at constant step time and pays a cold-start premium (``cold_start_s``
    of boot per chip, the serving analogue of :func:`restart_cost_s`,
    amortized over ``horizon_s``) — it buys *cheap capacity*.  Each
    (tp, replicas) shape on the grid gets a modeled p99 from an
    M/D/1-style sojourn bound — service time ``tokens_per_request ·
    step_s`` inflated by ``1/(1-utilization)`` at the offered load — and
    a $/1M-tokens-at-SLO price (``inf`` when the SLO is missed), so the
    winner is the cheapest shape that actually meets the SLO:

    >>> plan = fleet_plan(d_model=1024, n_layers=8, vocab_size=32000,
    ...                   offered_tps=20000.0, slo_p99_ms=40.0,
    ...                   channels=("ici",))
    >>> plan.best.usd_per_mtok < float("inf")  # a feasible shape exists
    True
    >>> all(o.usd_per_mtok == float("inf") for o in plan.options
    ...     if o.modeled_p99_ms > plan.slo_p99_ms)  # SLO-miss never wins
    True
    >>> tight = fleet_plan(d_model=1024, n_layers=8, vocab_size=32000,
    ...                    offered_tps=20000.0, slo_p99_ms=4.0,
    ...                    channels=("ici",))
    >>> tight.best.tp >= plan.best.tp   # tighter SLO -> buy latency (TP)
    True

    When no shape meets the SLO the plan still answers — ``best`` is the
    lowest-p99 shape (what you would have to relax toward) with an
    ``inf`` price."""
    from .pricing import usd_per_mtok_at_slo

    if offered_tps <= 0:
        raise ValueError("offered_tps must be positive")
    options: list[FleetOption] = []
    for tp in tp_grid:
        sp = serve_plan(d_model, n_layers, vocab_size, P=tp, batch=batch,
                        prompt_len=prompt_len, channels=channels,
                        **serve_kwargs)
        step_s = sp.decode.step_s
        per_replica_tps = batch / step_s
        for replicas in replica_grid:
            chips = tp * replicas
            if chips > max_chips:
                continue
            capacity = replicas * per_replica_tps
            util = offered_tps / capacity
            service_s = tokens_per_request * step_s
            if util < 1.0:
                p99_ms = service_s / (1.0 - util) * 1e3
            else:
                p99_ms = float("inf")
            usd = usd_per_mtok_at_slo(
                chips, offered_tps, p99_ms, slo_p99_ms,
                cold_start_chip_s=chips * cold_start_s,
                horizon_s=horizon_s)
            mode = ("scale-up" if replicas == 1
                    else "scale-out" if tp == 1 else "hybrid")
            options.append(FleetOption(
                tp=tp, replicas=replicas, mode=mode, chips=chips,
                step_s=step_s, capacity_tps=capacity, utilization=util,
                modeled_p99_ms=p99_ms, usd_per_mtok=usd))
    if not options:
        raise ValueError("grid empty under max_chips")
    feasible = [o for o in options if o.usd_per_mtok < float("inf")]
    if feasible:
        best = min(feasible, key=lambda o: (o.usd_per_mtok, o.chips,
                                            o.modeled_p99_ms, o.replicas,
                                            o.tp))
    else:
        best = min(options, key=lambda o: (o.modeled_p99_ms, o.chips,
                                           o.replicas, o.tp))
    return FleetPlan(offered_tps=offered_tps, slo_p99_ms=slo_p99_ms,
                     options=tuple(options), best=best)


def explain_fleet_plan(
    d_model: int,
    n_layers: int,
    vocab_size: int,
    offered_tps: float,
    slo_p99_ms: float,
    **kwargs,
) -> str:
    """The fleet grid as a table — what ``launch/serve.py --fleet N
    --slo-p99-ms X --explain`` prints: per (tp × replicas) shape the chip
    count, step time, capacity, utilization at the offered load, modeled
    p99 against the SLO, and the $/1M-tokens-at-SLO price; ``*`` marks
    the winner."""
    plan = fleet_plan(d_model, n_layers, vocab_size, offered_tps,
                      slo_p99_ms, **kwargs)
    lines = [
        f"fleet plan: offered {offered_tps:.0f} tok/s, "
        f"SLO p99 <= {slo_p99_ms:g}ms",
        f"  {'shape':12s} {'mode':10s} {'chips':>5s} {'step':>9s} "
        f"{'capacity':>10s} {'util':>6s} {'p99':>10s} {'$/Mtok':>9s}",
        "  " + "-" * 78,
    ]
    for o in plan.options:
        star = "*" if o is plan.best else " "
        p99 = "inf" if o.modeled_p99_ms == float("inf") else f"{o.modeled_p99_ms:.2f}ms"
        usd = "miss" if o.usd_per_mtok == float("inf") else f"{o.usd_per_mtok:.4f}"
        lines.append(
            f"{star} tp={o.tp:<2d}x r={o.replicas:<3d} {o.mode:10s} "
            f"{o.chips:5d} {o.step_s*1e3:7.3f}ms {o.capacity_tps:8.0f}t/s "
            f"{o.utilization*100:5.1f}% {p99:>10s} {usd:>9s}"
        )
    b = plan.best
    verdict = ("no shape meets the SLO; closest is"
               if b.usd_per_mtok == float("inf") else "best:")
    lines.append(
        f"-> {verdict} tp={b.tp} x {b.replicas} replicas ({b.mode}, "
        f"{b.chips} chips): p99 "
        + ("inf" if b.modeled_p99_ms == float("inf")
           else f"{b.modeled_p99_ms:.2f}ms")
        + (f", ${b.usd_per_mtok:.4f}/1M tokens"
           if b.usd_per_mtok < float("inf") else "")
    )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Rescale planning — continue degraded vs. regroup now (the elastic runtime's
# cost question; see runtime/elastic.py and docs/elasticity.md)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RescaleOption:
    """One priced answer to "a rank died — what now?".

    ``step_time_s`` is the modeled per-step time (compute + exposed grad
    sync) under this option; ``restart_s`` the one-time cost of getting
    there (0 for continuing); ``total_s``/``price_usd`` the run-to-horizon
    totals the plan is argmin'd over."""

    action: str  # 'continue-degraded' | 'regroup-pow2' | 'regroup-full'
    world: int  # active ranks under this option
    algorithm: str  # grad-sync algorithm the selector picked at that size
    step_time_s: float
    restart_s: float
    total_s: float
    price_usd: float
    note: str = ""


@dataclass(frozen=True)
class RescalePlan:
    """The full continue-vs-regroup table plus the chosen row."""

    P: int
    survivors: int
    steps_remaining: int
    options: tuple[RescaleOption, ...]
    best: RescaleOption


def restart_cost_s(
    ckpt_bytes: float,
    world: int,
    steps_since_ckpt: int = 0,
    healthy_step_s: float = 0.0,
    form_s: float = 1.0,
    restore_channel: str = "host",
) -> float:
    """The new restart-cost term of the rescale model: what one regroup
    costs before the first productive step at the new size.

    Three parts: group re-formation (``form_s`` — membership joins +
    controller overhead; the paper's §3.1 timer bounds it, this prices its
    expectation), resharding (every rank re-reads its ``ckpt_bytes/world``
    checkpoint slice through the ``restore_channel``'s α-β model, in
    parallel), and lost work (``steps_since_ckpt`` healthy steps redone —
    everything since the last committed checkpoint re-executes)."""
    spec = get_channel(restore_channel).spec
    reshard = spec.p2p_time(ckpt_bytes / max(1, world)) if ckpt_bytes else 0.0
    return float(form_s) + reshard + steps_since_ckpt * healthy_step_s


def rescale_plan(
    nbytes: float,
    P: int,
    survivors: int,
    steps_remaining: int,
    compute_s: float,
    channels: tuple[str, ...] | None = None,
    ckpt_bytes: float = 0.0,
    steps_since_ckpt: int = 0,
    slowdown: float = 2.0,
    form_s: float = 1.0,
    restore_channel: str = "host",
    objective: str = "time",
    price_weight: float = 0.5,
) -> RescalePlan:
    """Price "continue degraded vs. regroup now" after losing ranks.

    ``nbytes`` is the per-rank gradient payload of one step, ``compute_s``
    the healthy per-step compute at the full world ``P``.  Three options
    are priced with the same α-β(+γ) channel models the selector uses for
    everything else, plus the :func:`restart_cost_s` term:

    * **continue-degraded** — keep the ``P``-rank group: the dead ranks'
      microbatches re-execute on backup buddies (compute doubles on the
      critical path — see ``StragglerPolicy.backup_plan``) and every
      collective stretches by ``slowdown`` (the group is only as fast as
      its slowest member).  No restart cost.
    * **regroup-pow2** — pow2-floor of the survivors is active (fast-path
      collectives, the rest idle as spares): pay the restart once, then
      compute scales by ``P/world`` (same global batch on fewer ranks).
    * **regroup-full** — every survivor stays active at a non-pow2 size
      (ring / recursive-doubling-with-spares): least compute inflation,
      non-pow2 collective schedule.

    Dollar cost is chip occupancy of every *surviving* chip (idle spares
    are still reserved) over the option's total time.  ``best`` is the
    argmin under ``objective``; ``explain_rescale_plan`` renders the table
    that ``dryrun --explain`` prints."""
    from .pricing import P_CHIP_S

    survivors = int(survivors)
    steps = max(0, int(steps_remaining))
    if not 0 < survivors <= P:
        raise ValueError(f"survivors {survivors} outside (0, {P}]")

    def sync_time(world: int) -> tuple[float, str]:
        cand = select("allreduce", nbytes, world, channels=channels,
                      objective="time") if world > 1 else None
        return (cand.time_s, cand.algorithm) if cand else (0.0, "-")

    healthy_comm, algo_P = sync_time(P)
    healthy_step = compute_s + healthy_comm

    options = []
    # continue degraded: full-world group limps with backups + stretched wire
    if survivors < P:
        t_step = 2.0 * compute_s + healthy_comm * max(1.0, slowdown)
        note = f"buddies re-execute {P - survivors} lost microbatch(es)"
    else:
        t_step, note = healthy_step, "no failure: healthy baseline"
    total = steps * t_step
    options.append(RescaleOption(
        "continue-degraded", P, algo_P, t_step, 0.0, total,
        survivors * total * P_CHIP_S, note))

    worlds = []
    p2 = 1 << (survivors.bit_length() - 1)
    worlds.append(("regroup-pow2", p2,
                   f"{survivors - p2} spare(s) idle" if survivors - p2
                   else "all survivors on the pow2 fast path"))
    if p2 != survivors:
        worlds.append(("regroup-full", survivors,
                       "all survivors active (non-pow2 schedule)"))
    for action, world, wnote in worlds:
        comm, algo = sync_time(world)
        t_step = compute_s * (P / world) + comm
        restart = restart_cost_s(ckpt_bytes, world, steps_since_ckpt,
                                 healthy_step, form_s, restore_channel)
        total = restart + steps * t_step
        options.append(RescaleOption(
            action, world, algo, t_step, restart, total,
            survivors * total * P_CHIP_S, wnote))

    def key(o: RescaleOption) -> float:
        if objective == "time":
            return o.total_s
        if objective == "price":
            return o.price_usd
        if objective == "weighted":
            return (1 - price_weight) * o.total_s + price_weight * o.price_usd
        raise ValueError(f"unknown objective {objective!r}")

    opts = tuple(options)
    return RescalePlan(P, survivors, steps, opts, min(opts, key=key))


def explain_rescale_plan(
    nbytes: float,
    P: int,
    survivors: int,
    steps_remaining: int,
    compute_s: float,
    channels: tuple[str, ...] | None = None,
    **kwargs,
) -> str:
    """The rescale decision as a table, chosen row marked — what
    ``launch/dryrun.py --explain`` prints under the bucket plan."""
    plan = rescale_plan(nbytes, P, survivors, steps_remaining, compute_s,
                        channels=channels, **kwargs)
    lines = [
        f"rescale plan: {survivors}/{P} ranks alive, "
        f"{plan.steps_remaining} steps to go, "
        f"grad sync {nbytes/1e6:.1f} MB/rank, compute {compute_s*1e3:.2f} ms/step",
        f"{'':2s}{'action':18s} {'world':>5s} {'algorithm':20s} "
        f"{'t/step':>10s} {'restart':>10s} {'total':>10s} {'price $':>12s}",
        "-" * 94,
    ]
    for o in plan.options:
        mark = "*" if o is plan.best else " "
        lines.append(
            f"{mark:2s}{o.action:18s} {o.world:5d} {o.algorithm:20s} "
            f"{o.step_time_s*1e3:8.2f}ms {o.restart_s*1e3:8.2f}ms "
            f"{o.total_s:9.2f}s {o.price_usd:12.3e}  {o.note}"
        )
    lines.append(
        f"-> {plan.best.action} at world={plan.best.world}: "
        f"{plan.best.total_s:.2f}s total, ${plan.best.price_usd:.3e}"
    )
    return "\n".join(lines)


def explain(
    op: str,
    nbytes: float,
    P: int,
    channels: tuple[str, ...] | None = None,
    mem_gib: float = 2.0,
    inner_P: int | None = None,
    flow: bool = False,
    calibration: "Calibration | None" = None,
) -> str:
    """The full candidate table, best first.  ``channels=None`` considers
    every registered channel with a transport (plus their hierarchical
    composites) — the table ``dryrun.py --explain`` prints.

    ``flow=True`` adds the modeled-vs-flow divergence columns: each flat
    candidate is re-run on the flow-level backend
    (:func:`repro.core.flowsim.flow_time`, topology derived from the
    channel spec) and the signed relative divergence of the emergent time
    from the α-β prediction is printed next to it.  Composite and
    storage-priced rows have no flow expansion and show ``-``."""
    rows = sorted(
        candidates(op, nbytes, P, channels, mem_gib, inner_P=inner_P,
                   calibration=calibration),
        key=lambda c: c.time_s,
    )
    hdr = (f"{'channel':10s} {'algorithm':22s} {'depth':>5s} {'time':>12s} "
           f"{'price $':>14s}")
    if flow:
        hdr += f" {'flow time':>12s} {'diverg.':>8s}"
    lines = [hdr, "-" * (68 + (22 if flow else 0))]
    for c in rows:
        line = (f"{c.channel:10s} {c.algorithm:22s} {c.depth:5d} "
                f"{c.time_s*1e6:10.1f}us {c.price_usd:14.3e}")
        if flow:
            if c.hierarchical or c.algorithm == "storage":
                line += f" {'-':>12s} {'-':>8s}"
            else:
                compare_backends = _flowsim("compare_backends")
                cmpr = compare_backends(op, c.algorithm, int(nbytes), P,
                                        channel=c.channel, depth=c.depth)
                line += (f" {cmpr.flow_s*1e6:10.1f}us "
                         f"{cmpr.divergence*100:+7.1f}%")
        lines.append(line)
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Calibration — close the loop between the α-β model and the flow backend
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CalibrationSample:
    """One sweep point: the α-β prediction next to the emergent flow time."""

    channel: str
    op: str
    algorithm: str
    nbytes: int
    P: int
    modeled_s: float
    flow_s: float

    @property
    def ratio(self) -> float:
        """``flow / modeled`` — the correction this point votes for."""
        return self.flow_s / self.modeled_s


@dataclass(frozen=True)
class Calibration:
    """Per-channel multiplicative corrections fitted against the flow
    backend, plus the sweep they were fitted on.

    ``scales[ch]`` is the **weighted median** of the per-sample ratios
    ``r_i = flow_i / modeled_i`` with weights ``1/r_i``: the exact minimizer
    of the mean relative error ``mean_i |s·m_i − f_i| / f_i`` over scalar
    ``s`` (the objective is convex piecewise-linear in ``s`` with kinks at
    the ``r_i``).  Because ``s = 1`` is always in the feasible set, the
    corrected error can never exceed the uncorrected one — the property
    ``tests/test_flowsim.py`` asserts — and a positive scale preserves the
    model's monotonicity in ``nbytes``."""

    scales: Mapping[str, float]
    samples: tuple[CalibrationSample, ...]
    mean_rel_err_before: float
    mean_rel_err_after: float

    def scale(self, channel: str) -> float:
        """Correction for ``channel``; uncalibrated names get 1.0, and a
        hierarchical composite ``"<inner>+<outer>"`` inherits the larger
        leg's correction (congestion on either leg bounds the composite)."""
        if channel in self.scales:
            return float(self.scales[channel])
        if "+" in channel:
            return max(self.scale(p) for p in channel.split("+"))
        return 1.0

    def apply(self, channel: str, time_s: float) -> float:
        return time_s * self.scale(channel)


def _weighted_median(values: list[float], weights: list[float]) -> float:
    order = sorted(range(len(values)), key=lambda i: values[i])
    half = sum(weights) / 2.0
    acc = 0.0
    for i in order:
        acc += weights[i]
        if acc >= half:
            return values[i]
    return values[order[-1]]


def _mean_rel_err(samples, scales: Mapping[str, float]) -> float:
    if not samples:
        return 0.0
    errs = [abs(scales.get(s.channel, 1.0) * s.modeled_s - s.flow_s) / s.flow_s
            for s in samples]
    return sum(errs) / len(errs)


def calibrate(
    channels: tuple[str, ...] = ("sim",),
    ops: tuple[str, ...] = ("allreduce", "reduce_scatter", "allgather"),
    P_values: tuple[int, ...] = (4, 8),
    nbytes_grid: tuple[int, ...] = (1 << 12, 1 << 15, 1 << 18, 1 << 21),
    topology=None,
) -> Calibration:
    """Run the candidate sweep on both backends and fit per-channel
    corrections.

    For every channel × P × (op, feasible algorithm) × payload the α-β
    model's prediction (:meth:`~repro_torch.core.channels.Channel.time`, depth 1)
    is paired with the emergent flow-simulated completion time
    (:func:`repro.core.flowsim.flow_time`) on that channel's implied
    topology — flat switch for direct channels, broker star for mediated
    ones (:meth:`~repro.core.flowsim.Topology.from_spec`).  ``topology``
    overrides the default: a callable receives ``(spec, P)`` and returns a
    :class:`~repro.core.flowsim.Topology`; a plain topology instance is
    used for every sweep point (single-P sweeps).

    The fitted :class:`Calibration` plugs straight back into
    :func:`select`/:func:`bucket_plan` via their ``calibration=`` parameter,
    scaling every candidate's predicted time — the correction-feedback loop
    the flow backend exists to close."""
    Topology, flow_time = _flowsim("Topology"), _flowsim("flow_time")
    samples: list[CalibrationSample] = []
    for ch_name in channels:
        ch = get_channel(ch_name)
        for P in P_values:
            if topology is None:
                topo = Topology.from_spec(ch.spec, P)
            elif callable(topology):
                topo = topology(ch.spec, P)
            else:
                topo = topology
            for op in ops:
                for algo in DIRECT_ALGOS.get(op, []):
                    if not feasible(op, algo, P):
                        continue
                    for nb in nbytes_grid:
                        m = ch.time(op, algo, nb, P, depth=1)
                        f = flow_time(op, algo, nb, P, topology=topo)
                        if m > 0 and f > 0:
                            samples.append(CalibrationSample(
                                ch_name, op, algo, int(nb), P, m, f))
    scales: dict[str, float] = {}
    for ch_name in channels:
        ss = [s for s in samples if s.channel == ch_name]
        if not ss:
            continue
        ratios = [s.ratio for s in ss]
        weights = [1.0 / r for r in ratios]
        scales[ch_name] = _weighted_median(ratios, weights)
    return Calibration(
        scales=scales,
        samples=tuple(samples),
        mean_rel_err_before=_mean_rel_err(samples, {}),
        mean_rel_err_after=_mean_rel_err(samples, scales),
    )


def explain_calibration(cal: Calibration) -> str:
    """The calibration result as a table — per-channel correction and the
    sweep-wide error cut — what ``dryrun --explain`` prints under the
    divergence column."""
    lines = [
        f"flow-sim calibration: {len(cal.samples)} sweep points, "
        f"mean |rel err| {cal.mean_rel_err_before*100:.1f}% -> "
        f"{cal.mean_rel_err_after*100:.1f}%",
        f"{'channel':10s} {'scale':>8s} {'points':>7s} "
        f"{'err before':>11s} {'err after':>10s}",
        "-" * 50,
    ]
    for ch in sorted(cal.scales):
        ss = [s for s in cal.samples if s.channel == ch]
        before = _mean_rel_err(ss, {})
        after = _mean_rel_err(ss, cal.scales)
        lines.append(
            f"{ch:10s} {cal.scales[ch]:8.3f} {len(ss):7d} "
            f"{before*100:10.1f}% {after*100:9.1f}%"
        )
    return "\n".join(lines)

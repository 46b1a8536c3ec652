"""Analytical α-β performance models for FMI channels (paper §4/§5).

Copy of :mod:`repro.core.models` (framework-free; the channel specs keep the
reference's values and notes so selections match it exactly).

The paper models point-to-point time as ``T = α + s·β`` per channel and
derives collective times from the algorithm's round/byte schedule.  We keep
the same structure and extend it with the TPU channels that exist on the
production mesh:

* paper channels (AWS, Table 2): ``s3``, ``dynamodb``, ``redis``,
  ``direct`` (TCP between lambdas),
* TPU channels: ``ici`` (intra-pod inter-chip links), ``dcn`` (cross-pod
  data-center network), ``xla`` (the provider-managed black-box collective —
  modelled as ici with zero software overhead; measured, not scheduled,
  by us), ``host`` (HBM→host→HBM staging; the mediated-channel analogue).

For every (op, algorithm) pair, :func:`round_schedule` returns the exact
per-round byte counts of our implementations in
:mod:`repro_torch.core.algorithms`.  Property tests assert these match the
instrumented :class:`SimTransport` trace *exactly* — the model is the code.
"""

from __future__ import annotations

from dataclasses import dataclass


def ceil_log2(n: int) -> int:
    return max(0, (int(n) - 1).bit_length())


def is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


# ---------------------------------------------------------------------------
# Channels
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ChannelSpec:
    """α-β parameters (+ metadata) of one communication channel."""

    name: str
    alpha: float  # seconds of latency per message
    beta: float  # seconds per byte (1/bandwidth)
    kind: str  # 'direct' | 'mediated' | 'provider'
    push: bool  # push (receiver blocks) vs pull (receiver polls)
    persistent: bool = False
    serverless: bool = True  # no user-side provisioning needed
    max_message: float = float("inf")  # bytes
    hops: int = 1  # serialized store-and-forward hops per message (mediated: 2)
    one_sided: bool = False  # RDMA-style: put lands in a pre-registered
    # remote buffer with no receiver CPU on the data path (lease-gated)
    notes: str = ""

    def p2p_time(self, nbytes: float) -> float:
        return self.hops * (self.alpha + nbytes * self.beta)


MB = 1e6
GB = 1e9

# --- paper Table 2 (AWS eu-central-1, 2 GiB lambdas) -----------------------
PAPER_CHANNELS: dict[str, ChannelSpec] = {
    "s3": ChannelSpec(
        "s3", alpha=14.7e-3, beta=1 / (50 * MB), kind="mediated", push=False,
        persistent=True, max_message=5e12,
        notes="object storage; polling via GET/LIST; Tab.4 time implies an "
        "effective 1/beta of 500 MB/s for the 1MB row (paper-internal "
        "inconsistency with Tab.2's 50 MB/s; we expose both)",
    ),
    "dynamodb": ChannelSpec(
        "dynamodb", alpha=8.9e-3, beta=1 / (7 * MB), kind="mediated", push=False,
        persistent=True, max_message=400e3,
        notes="NoSQL key-value store; 400kB item limit; per-kB write pricing",
    ),
    "redis": ChannelSpec(
        "redis", alpha=0.88e-3, beta=1 / (100 * MB), kind="mediated", push=False,
        persistent=False, serverless=False, max_message=512e6,
        notes="in-memory cache; user-side scaling (cache.t3.small)",
    ),
    "direct": ChannelSpec(
        "direct", alpha=0.39e-3, beta=1 / (400 * MB), kind="direct", push=True,
        notes="TCP between lambdas via NAT hole punching (TCPunch)",
    ),
}

# --- TPU v5e channels (the production mesh; hardware constants per brief) --
TPU_CHANNELS: dict[str, ChannelSpec] = {
    # ~50 GB/s per ICI link; ~1 us software+serdes latency per hop.
    "ici": ChannelSpec(
        "ici", alpha=1e-6, beta=1 / (50 * GB), kind="direct", push=True,
        notes="intra-pod inter-chip interconnect (per link, per direction)",
    ),
    # Cross-pod DCN: ~25 GB/s per-chip aggregate is optimistic; we model a
    # conservative 6.25 GB/s/chip (50 Gb/s NIC share) and 10 us latency.
    "dcn": ChannelSpec(
        "dcn", alpha=10e-6, beta=1 / (6.25 * GB), kind="direct", push=True,
        notes="cross-pod data-center network (per chip share)",
    ),
    # Provider-managed collectives (XLA): same wire, no user scheduling.
    "xla": ChannelSpec(
        "xla", alpha=1e-6, beta=1 / (50 * GB), kind="provider", push=True,
        notes="XLA built-in collectives - the 'provider channel'",
    ),
    # Host-staged mediated channel: HBM->host RAM->HBM, PCIe-class bw.
    # hops=2: every message is a PUT to the host broker then a GET from it,
    # each paying the PCIe latency and occupying PCIe bandwidth once —
    # matching the 2-records-per-ppermute trace of transport.HostTransport.
    "host": ChannelSpec(
        "host", alpha=20e-6, beta=1 / (8 * GB), kind="mediated", push=False,
        persistent=True, hops=2,
        notes="host-broker staged exchange; the TPU analogue of the paper's "
        "storage channels (S3/Redis): PUT+GET through shared host memory",
    ),
    # Instrumented software channel (numpy lockstep).  Modelled as a slow
    # shared-memory interconnect so the selector has a genuine three-way
    # choice; its trace is the oracle that validates every other model.
    "sim": ChannelSpec(
        "sim", alpha=5e-6, beta=1 / (16 * GB), kind="direct", push=True,
        notes="instrumented numpy lockstep channel (test/cost oracle)",
    ),
    # Flow-level simulation backend: same wire constants as "sim" (so the
    # two backends price identically under the α-β model), but the transport
    # expands every message into per-link flows and completion times emerge
    # from max-min fair sharing (repro.core.flowsim; not ported yet).  Registered private —
    # it is a validation instrument, not a selector candidate.
    "flow": ChannelSpec(
        "flow", alpha=5e-6, beta=1 / (16 * GB), kind="direct", push=True,
        notes="flow-level network simulation backend (emergent contention; "
        "see repro.core.flowsim)",
    ),
    # Lease-based one-sided RDMA (the rFaaS design, repro.core.rdma): a put
    # lands directly in a pre-registered remote buffer over a warm queue
    # pair, so the per-message software overhead collapses to near-α (no
    # rendezvous, no receiver CPU) — but registered-buffer bandwidth is
    # modest, so the two-sided channels win back past the crossover
    # (p2p: ≈ 7 KB vs sim, ≈ 152 KB vs the hops=2 host broker; best-of-
    # channel allreduce envelope at P=8 flips vs host near 0.5 MB — see
    # selector.crossover_nbytes and docs/rdma.md).
    "rdma": ChannelSpec(
        "rdma", alpha=2e-6, beta=1 / (2 * GB), kind="direct", push=True,
        hops=1, one_sided=True,
        notes="lease-based one-sided RDMA into pre-registered remote "
        "buffers (rFaaS-style; see repro.core.rdma)",
    ),
}

CHANNELS: dict[str, ChannelSpec] = {**PAPER_CHANNELS, **TPU_CHANNELS}

# Storage-backed channels priced by operation counts (mediated_collective)
# rather than a round schedule; FAAS_CHANNELS are priced per serverless
# function (paper eq. 1) — neither basis composes with chip-occupancy
# pricing, which is why the selector excludes them from hierarchical
# composites.
STORAGE_CHANNELS: tuple[str, ...] = ("s3", "dynamodb", "redis")
FAAS_CHANNELS: tuple[str, ...] = ("s3", "dynamodb", "redis", "direct")


# TPU v5e chip-level roofline constants (targets; container runs CPU).
@dataclass(frozen=True)
class HardwareSpec:
    name: str = "tpu-v5e"
    peak_flops_bf16: float = 197e12  # FLOP/s per chip
    hbm_bw: float = 819e9  # B/s per chip
    ici_bw: float = 50e9  # B/s per link per direction
    ici_links: int = 4  # 2D torus: +/-x, +/-y
    hbm_gib: float = 16.0
    vmem_mib: float = 128.0
    dcn_bw: float = 6.25e9  # B/s per chip (cross-pod share)


V5E = HardwareSpec()


# ---------------------------------------------------------------------------
# Round/byte schedules — MUST match SimTransport traces exactly
# ---------------------------------------------------------------------------


def round_schedule(op: str, algo: str, nbytes: float, P: int) -> list[float]:
    """Per-round bytes sent by the busiest rank, for ``op`` over ``P`` ranks.

    ``nbytes`` convention per op (matches collectives.py):
      allreduce / bcast / reduce / scan : full per-rank payload
      reduce_scatter / allgather / alltoall / scatter / gather :
          full logical buffer (P × chunk)
    """
    s = float(nbytes)
    c = s / P
    L = ceil_log2(P)
    if P <= 1:
        return []

    key = (op, algo)
    if key == ("allreduce", "recursive_doubling"):
        if is_pow2(P):
            return [s] * L
        p2 = 1 << (P.bit_length() - 1)
        return [s] + [s] * ceil_log2(p2) + [s]  # fold-in + RD + fold-out
    if key == ("allreduce", "ring"):
        return [c] * (P - 1) + [c] * (P - 1)
    if key == ("allreduce", "rabenseifner"):
        rs = [s / (1 << (k + 1)) for k in range(L)]
        ag = list(reversed(rs))
        return rs + ag
    if key == ("reduce_scatter", "ring"):
        return [c] * (P - 1)
    if key == ("reduce_scatter", "recursive_halving"):
        return [s / (1 << (k + 1)) for k in range(L)]
    if key == ("allgather", "ring"):
        return [c] * (P - 1)
    if key == ("allgather", "recursive_doubling"):
        return [c * (1 << k) for k in range(L)]
    if key == ("bcast", "binomial"):
        return [s] * L
    if key == ("reduce", "binomial"):
        return [s] * L
    if key == ("scan", "hillis_steele"):
        return [s] * L
    if key == ("alltoall", "pairwise"):
        return [c] * (P - 1)
    if key == ("scatter", "binomial_halving"):
        return [s / (1 << (k + 1)) for k in range(L)]
    if key == ("gather", "ring"):
        return [c] * (P - 1)
    if key == ("gather", "binomial"):  # model-only (true binomial gather)
        return [c * (1 << k) for k in range(L)]
    if key == ("barrier", "recursive_doubling"):
        return [4.0] * L if is_pow2(P) else [4.0] * (ceil_log2(1 << (P.bit_length() - 1)) + 2)
    raise KeyError(f"no schedule for {key}")


def collective_time(
    op: str, algo: str, nbytes: float, P: int, channel: ChannelSpec
) -> float:
    """α-β wire time of one collective: Σ_rounds hops·(α + bytes·β)."""
    sched = round_schedule(op, algo, nbytes, P)
    return sum(channel.hops * (channel.alpha + b * channel.beta) for b in sched)


# ---------------------------------------------------------------------------
# Chunk pipelining (overlap round k+1's send with round k's reduce)
# ---------------------------------------------------------------------------

# Reduce throughput of one chip: the reduction reads both operands from and
# writes the result to HBM — 3 HBM touches per byte.  This is the γ term the
# α-β model needs to price pipelining: without it, overlapping communication
# with the reduce is free and depth would always be 1.
GAMMA_REDUCE = 3.0 / 819e9  # s/byte (v5e HBM; see HardwareSpec below)

# Injection overhead of each extra in-flight segment: the overlapped message
# skips the propagation latency (it streams behind its predecessor) but
# still pays the software send setup — a fixed fraction of α.
SEG_ALPHA_FRACTION = 0.25

# (op, algo) pairs whose implementation supports chunk-streamed pipelining
# (see algorithms.ring_reduce_scatter_pipelined and friends).
PIPELINEABLE = {
    ("allreduce", "ring"),
    ("allreduce", "rabenseifner"),
    ("reduce_scatter", "ring"),
    ("reduce_scatter", "recursive_halving"),
}

PIPELINE_DEPTHS = (1, 2, 4, 8)


def reduce_round_count(op: str, algo: str, P: int) -> int:
    """How many leading rounds of ``round_schedule`` apply the reduction
    operator (those are the rounds pipelining can overlap)."""
    L = ceil_log2(P)
    if P <= 1:
        return 0
    table = {
        ("allreduce", "ring"): P - 1,  # reduce-scatter phase
        ("allreduce", "rabenseifner"): L,  # halving phase
        ("reduce_scatter", "ring"): P - 1,
        ("reduce_scatter", "recursive_halving"): L,
    }
    if (op, algo) in table:
        return table[(op, algo)]
    if (op, algo) == ("allreduce", "recursive_doubling") and not is_pow2(P):
        # fold-in + RD rounds reduce; the trailing fold-out only copies
        return len(round_schedule(op, algo, 1.0, P)) - 1
    if op in ("allreduce", "reduce", "scan", "barrier"):
        return len(round_schedule(op, algo, 1.0, P))  # every round reduces
    return 0


def collective_time_ext(
    op: str,
    algo: str,
    nbytes: float,
    P: int,
    channel: ChannelSpec,
    depth: int = 1,
    gamma: float = GAMMA_REDUCE,
) -> float:
    """Wire time + exposed reduce time with chunk pipelining at ``depth``.

    Per reducing round moving ``b`` bytes the serialized cost is

        hops·(α + b·β)  +  b/depth·γ
          +  (depth−1)·α·(SEG_ALPHA_FRACTION + hops − 1)

    — the link stays busy for all of ``b`` regardless of segmentation, but
    only the *last* segment's reduce is exposed (the others overlap the next
    segment's transfer), at the price of one extra injection per segment.
    On a store-and-forward channel (hops > 1) each extra segment also
    exposes a full serialized download hop — a depth-D exchange through the
    host broker costs D+1 slots, not 2, exactly as its trace records.
    ``depth=1`` degenerates to the unpipelined serialized chain
    (receive, then reduce, then send).  Used by the selector so depth-1 and
    depth-D candidates are priced consistently."""
    if (op, algo) not in PIPELINEABLE:
        depth = 1
    depth = max(1, int(depth))
    sched = round_schedule(op, algo, nbytes, P)
    nred = reduce_round_count(op, algo, P)
    seg_alpha = channel.alpha * (SEG_ALPHA_FRACTION + (channel.hops - 1))
    t = 0.0
    for k, b in enumerate(sched):
        t += channel.hops * (channel.alpha + b * channel.beta)
        if k < nred:
            t += (b / depth) * gamma
            t += (depth - 1) * seg_alpha
    return t


def best_pipeline_depth(
    op: str, algo: str, nbytes: float, P: int, channel: ChannelSpec,
    depths: tuple = PIPELINE_DEPTHS,
) -> int:
    """argmin over ``depths`` of :func:`collective_time_ext` — the selector's
    pipeline-depth decision in isolation."""
    if (op, algo) not in PIPELINEABLE:
        return 1
    return min(depths, key=lambda d: collective_time_ext(op, algo, nbytes, P, channel, d))


def pipeline_round_counts(op: str, algo: str, P: int, depth: int) -> tuple[int, int]:
    """(total messages, serialized rounds) of the pipelined execution.

    Chunk streaming splits every reducing round into ``depth`` messages, but
    the extra messages overlap the previous segment's reduce — so the
    serialized-round count stays at the unpipelined schedule length while
    the message count grows.  The instrumented channel must confirm both
    numbers exactly (``trace.rounds`` / ``trace.serial_rounds``)."""
    sched_len = len(round_schedule(op, algo, float(P), P))
    if (op, algo) not in PIPELINEABLE:
        depth = 1
    nred = reduce_round_count(op, algo, P)
    total = nred * max(1, depth) + (sched_len - nred)
    return total, sched_len


def total_bytes_on_wire(op: str, algo: str, nbytes: float, P: int) -> float:
    """Aggregate bytes crossing links (all ranks), for price/occupancy models."""
    sched = round_schedule(op, algo, nbytes, P)
    # every round is (near-)all-ranks-active for our algorithms except trees;
    # use the busiest-rank schedule × active ranks per round conservatively.
    active = {
        ("bcast", "binomial"): lambda k: min(1 << k, P),  # senders double
        ("reduce", "binomial"): lambda k: min(1 << (len(sched) - 1 - k), P),
    }.get((op, algo))
    if active is None:
        return float(sum(b * P for b in sched))
    return float(sum(b * active(k) for k, b in enumerate(sched)))


# ---------------------------------------------------------------------------
# Mediated-channel collective models (paper §3.3, "Mediated channels")
# ---------------------------------------------------------------------------


@dataclass
class MediatedOps:
    """Operation counts of a storage-based collective (for pricing)."""

    puts: int = 0
    gets: int = 0
    lists: int = 0
    put_bytes: float = 0.0
    get_bytes: float = 0.0
    time: float = 0.0  # modelled minimal-transfer critical path


def mediated_collective(
    op: str, nbytes: float, P: int, channel: ChannelSpec, poll_s: float = 20e-3
) -> MediatedOps:
    """Paper §3.3 storage algorithms: critical-path time + operation counts.

    Minimal-transfer convention (paper §5): no waiting/polling delay is added
    to the time (senders/receivers perfectly synchronized); polling *costs*
    (expected extra GET/LIST requests) are still counted for pricing, one
    poll per transfer by default.
    """
    s = float(nbytes)
    a, b = channel.alpha, channel.beta
    m = MediatedOps()
    if P <= 1:
        return m
    if op == "bcast":
        # root PUT, P-1 parallel GETs (storage bandwidth scales with readers)
        m.puts, m.gets = 1, P - 1
        m.put_bytes, m.get_bytes = s, s * (P - 1)
        m.time = (a + s * b) + (a + s * b)
    elif op == "barrier":
        m.puts, m.lists = P, P  # each uploads 1B marker; ranks poll LIST
        m.put_bytes = P * 1.0
        m.time = (a + b) + a
    elif op == "gather":
        c = s / P
        m.puts, m.gets = P - 1, P - 1
        m.put_bytes, m.get_bytes = c * (P - 1), c * (P - 1)
        # root drains P-1 objects at channel bandwidth
        m.time = (a + c * b) + (a + (P - 1) * c * b)
    elif op == "scatter":
        c = s / P
        m.puts, m.gets = P - 1, P - 1
        m.put_bytes, m.get_bytes = c * (P - 1), c * (P - 1)
        m.time = (a + (P - 1) * c * b) + (a + c * b)
    elif op in ("reduce", "allreduce"):
        g = mediated_collective("gather", s * P, P, channel)
        m.puts, m.gets = g.puts, g.gets
        m.put_bytes, m.get_bytes = g.put_bytes, g.get_bytes
        m.time = g.time
        if op == "allreduce":
            bc = mediated_collective("bcast", s, P, channel)
            m.puts += bc.puts
            m.gets += bc.gets
            m.put_bytes += bc.put_bytes
            m.get_bytes += bc.get_bytes
            m.time += bc.time
    elif op == "scan":
        # each rank polls its predecessor's partial: sequential chain
        m.puts, m.gets = P - 1, P - 1
        m.put_bytes = m.get_bytes = s * (P - 1)
        m.time = (P - 1) * ((a + s * b) + (a + s * b))
    else:
        raise KeyError(f"no mediated model for {op}")
    return m


# ---------------------------------------------------------------------------
# Candidate enumeration for the selector
# ---------------------------------------------------------------------------

DIRECT_ALGOS: dict[str, list[str]] = {
    "allreduce": ["recursive_doubling", "ring", "rabenseifner"],
    "reduce_scatter": ["ring", "recursive_halving"],
    "allgather": ["ring", "recursive_doubling"],
    "bcast": ["binomial"],
    "reduce": ["binomial"],
    "scan": ["hillis_steele"],
    "alltoall": ["pairwise"],
    "scatter": ["binomial_halving"],
    "gather": ["ring", "binomial"],
    "barrier": ["recursive_doubling"],
}

POW2_ONLY = {
    ("reduce_scatter", "recursive_halving"),
    ("allgather", "recursive_doubling"),
    ("allreduce", "rabenseifner"),
    ("alltoall", "pairwise"),
    ("scatter", "binomial_halving"),
}


def feasible(op: str, algo: str, P: int) -> bool:
    if (op, algo) in POW2_ONLY:
        return is_pow2(P)
    return True

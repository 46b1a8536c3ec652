"""Price models (paper §5, Tables 3–4) and their TPU extension.

The paper's total cost of one communication epoch is

    cost = cost_of_FaaS_time + cost_of_channel_operations
    c_function = P · t · p_faas · M                              (eq. 1)

We reproduce Table 4 (1 MB between two 2 GiB lambdas, 10⁶ exchanges) to the
cent where the paper is internally consistent, and document the two known
paper-internal inconsistencies (S3 row time implies 500 MB/s vs. Table 2's
50 MB/s; the printed Redis *channel* cost is inconsistent with its own total
— the total matches p_redis·t, which is what we compute).

TPU extension: communication has no per-message fee, but it occupies chips —
``cost = chips · time · p_chip`` — which is exactly the paper's
"communication time is money" argument transplanted to reserved hardware.
The serving runtime surfaces the same occupancy price **per generated
token** (:func:`usd_per_mtok`), which is how ``serve_plan`` turns a decode
step time into the $/1M-tokens column of ``launch/serve.py --explain``.

Doctest — the paper's Table 4 headline numbers reproduce to the cent::

    >>> t4 = paper_table4()
    >>> round(t4["s3"].total_usd, 2)
    6.95
    >>> round(t4["redis"].total_usd, 2)
    0.84
    >>> round(t4["direct"].total_usd, 2)
    0.2
    >>> cost = p2p_exchange_cost("direct", nbytes=1e6, n_exchanges=1)
    >>> cost.time_s == CHANNELS["direct"].alpha + 1e6 * CHANNELS["direct"].beta
    True
"""

from __future__ import annotations

from dataclasses import dataclass

from .models import (
    CHANNELS,
    STORAGE_CHANNELS,
    ChannelSpec,
    collective_time,
    mediated_collective,
)

# --- paper Table 3 (AWS eu-central-1, USD) ---------------------------------
P_FAAS = 1.67e-5  # Lambda, per GiB·s
P_HPS = 3.72e-6  # t2.micro hole-punching server, per s
P_REDIS = 1.05e-5  # cache.t3.small, per s
P_S3_GET = 4.3e-7  # per request
P_S3_PUT = 5.4e-6  # per request
P_DDB_READ = 7.62e-8  # per kB
P_DDB_WRITE = 1.5e-6  # per kB

# --- TPU price anchor (documented assumption; configurable) -----------------
P_CHIP_S = 1.20 / 3600.0  # $/chip-second (~$1.20 per v5e chip-hour)


@dataclass
class ExchangeCost:
    channel: str
    time_s: float  # one exchange
    faas_usd: float  # function/chip time cost (total over n_exchanges)
    channel_usd: float  # per-operation / infrastructure cost
    total_usd: float


def faas_cost(P: int, t: float, mem_gib: float, n: int = 1) -> float:
    """Paper eq. (1): P participants × time × $/GiB-s × memory, n times.

    >>> faas_cost(2, 1.0, 2.0) == 2 * 1.0 * P_FAAS * 2.0
    True
    """
    return P * t * P_FAAS * mem_gib * n


def usd_per_mtok(P: int, step_s: float, tokens_per_step: float,
                 p_chip_s: float = P_CHIP_S) -> float:
    """Chip-occupancy dollars per **million generated tokens**: ``P`` chips
    are reserved for ``step_s`` seconds to emit ``tokens_per_step`` tokens.
    This is the serving-side reading of the paper's "communication time is
    money": every microsecond the decode-step collectives add to ``step_s``
    shows up linearly in the $/1M-tokens bill that
    ``launch/serve.py --explain`` prints.

    >>> round(usd_per_mtok(8, 0.01, 16), 4)   # 8 chips, 10ms step, 16 tok
    1.6667
    >>> usd_per_mtok(8, 0.02, 16) == 2 * usd_per_mtok(8, 0.01, 16)
    True
    """
    if tokens_per_step <= 0:
        raise ValueError("tokens_per_step must be positive")
    return P * step_s * p_chip_s / tokens_per_step * 1e6


def usd_per_mtok_at_slo(
    chips: int,
    offered_tps: float,
    modeled_p99_ms: float,
    slo_p99_ms: float,
    p_chip_s: float = P_CHIP_S,
    cold_start_chip_s: float = 0.0,
    horizon_s: float = 3600.0,
) -> float:
    """$/1M-tokens **at an SLO**: the fleet extension of
    :func:`usd_per_mtok`.  A deployment of ``chips`` chips serving
    ``offered_tps`` tokens/s is only *worth* its price if its modeled p99
    meets the latency SLO — an infeasible deployment costs ``inf`` (you
    cannot buy back a missed SLO with a lower bill).  ``cold_start_chip_s``
    amortizes replica boot time (the ``restart_cost_s`` analogue: chip-
    seconds spent booting rather than serving) over ``horizon_s`` of
    steady traffic, which is what makes scale-out — more, smaller
    replicas, each a potential cold start — pay a real premium over
    scale-up in :func:`repro_torch.core.selector.fleet_plan`.

    >>> round(usd_per_mtok_at_slo(8, 1000.0, 40.0, 50.0), 4)
    2.6667
    >>> usd_per_mtok_at_slo(8, 1000.0, 60.0, 50.0)   # misses the SLO
    inf
    >>> a = usd_per_mtok_at_slo(8, 1000.0, 40.0, 50.0)
    >>> b = usd_per_mtok_at_slo(8, 1000.0, 40.0, 50.0,
    ...                         cold_start_chip_s=16.0)
    >>> b > a                      # cold starts are not free
    True
    """
    if offered_tps <= 0:
        raise ValueError("offered_tps must be positive")
    if slo_p99_ms <= 0:
        raise ValueError("slo_p99_ms must be positive")
    if modeled_p99_ms > slo_p99_ms:
        return float("inf")
    usd_per_s = chips * p_chip_s + cold_start_chip_s * p_chip_s / horizon_s
    return usd_per_s / offered_tps * 1e6


def p2p_exchange_cost(
    channel_name: str,
    nbytes: float = 1e6,
    P: int = 2,
    mem_gib: float = 2.0,
    n_exchanges: int = 1_000_000,
    s3_effective_beta: bool = True,
) -> ExchangeCost:
    """Cost of ``n`` point-to-point exchanges — reproduces paper Table 4.

    ``s3_effective_beta``: the paper's Table 4 S3 time (16.70 ms for 1 MB)
    matches α + s/(500 MB/s), not Table 2's 50 MB/s.  True reproduces the
    table; False uses Table 2's stated bandwidth.
    """
    ch = CHANNELS[channel_name]
    beta = ch.beta
    if channel_name == "s3" and s3_effective_beta:
        beta = 1 / 500e6
    t = ch.alpha + nbytes * beta

    f_usd = faas_cost(P, t, mem_gib, n_exchanges)
    if channel_name == "s3":
        c_usd = (P_S3_PUT + P_S3_GET) * n_exchanges
    elif channel_name == "dynamodb":
        kb = nbytes / 1e3
        c_usd = (P_DDB_WRITE + P_DDB_READ) * kb * n_exchanges
    elif channel_name == "redis":
        c_usd = P_REDIS * t * n_exchanges
    elif channel_name == "direct":
        c_usd = P_HPS * t * n_exchanges
    elif channel_name in ("ici", "dcn", "xla", "host", "sim", "rdma"):
        c_usd = 0.0  # wire/host path is part of the chip price
        f_usd = P * t * P_CHIP_S * n_exchanges
    else:
        raise KeyError(channel_name)
    return ExchangeCost(channel_name, t, f_usd, c_usd, f_usd + c_usd)


def paper_table4() -> dict[str, ExchangeCost]:
    """Paper Table 4: S3 $6.95 / DynamoDB ~$1,590 / Redis $0.84 / Direct $0.20."""
    return {c: p2p_exchange_cost(c) for c in ("s3", "dynamodb", "redis", "direct")}


# ---------------------------------------------------------------------------
# Collective pricing (used by the selector's 'price' objective)
# ---------------------------------------------------------------------------


def collective_cost(
    op: str,
    nbytes: float,
    P: int,
    channel_name: str,
    algo: str | None = None,
    mem_gib: float = 2.0,
    poll_s: float = 20e-3,
    spec: ChannelSpec | None = None,
    time_s: float | None = None,
) -> ExchangeCost:
    """$ of ONE collective on a channel (direct: α-β time × occupancy;
    mediated: storage ops + function time).

    ``spec`` lets registry-registered channels price themselves without an
    entry in :data:`~repro_torch.core.models.CHANNELS`; ``time_s`` overrides the
    modelled time (the selector passes its pipelining-aware estimate so the
    occupancy price matches the time it ranks by)."""
    ch = spec if spec is not None else CHANNELS[channel_name]
    if ch.kind == "mediated" and channel_name in STORAGE_CHANNELS:
        m = mediated_collective(op, nbytes, P, ch, poll_s)
        t = m.time
        f_usd = faas_cost(P, t, mem_gib)
        if channel_name == "s3":
            c_usd = m.puts * P_S3_PUT + (m.gets + m.lists) * P_S3_GET
        elif channel_name == "dynamodb":
            c_usd = (
                m.put_bytes / 1e3 * P_DDB_WRITE + m.get_bytes / 1e3 * P_DDB_READ
            )
        else:  # redis: infra-time cost only
            c_usd = P_REDIS * t
        return ExchangeCost(channel_name, t, f_usd, c_usd, f_usd + c_usd)

    if algo is None:
        raise ValueError("direct channels need an algorithm")
    t = time_s if time_s is not None else collective_time(op, algo, nbytes, P, ch)
    if channel_name == "direct":
        f_usd = faas_cost(P, t, mem_gib)
        c_usd = P_HPS * t
    else:  # TPU/registered channels: chip-occupancy price
        f_usd = P * t * P_CHIP_S
        c_usd = 0.0
    return ExchangeCost(channel_name, t, f_usd, c_usd, f_usd + c_usd)

"""CommSanitizer: opt-in runtime race/leak detector for the collective stack.

The static pass (:mod:`repro.analysis.lint`) checks what is visible in the
source; this module checks what only exists at runtime — the actual ladder
of collectives each rank executed, the actual lifetime of each request, the
actual page accounting of the KV cache.  It is **off by default** and costs
one module-global check per hook when off; enable it with either::

    FMI_SANITIZE=1 python ...                  # process-wide
    Communicator(axes=..., sizes=..., sanitize=True)   # from a group build
    with sanitizer.scoped() as s: ...          # test-scoped, fresh instance

What it detects (diagnostic ``kind`` in parentheses):

* per-rank collective-sequence divergence, compared at barrier points from
  hashed op/byte ladders (``collective-mismatch``);
* a request garbage-collected while still pending, reported with its
  creation stack (``request-leak``);
* waiting a request whose communicator regrouped past the request's
  generation — the wait can never be answered (``cross-generation-wait``);
* concurrent same-peer ``isend`` s under different tags — delivery order
  between them is undefined on a real network (``tag-race``);
* double-cancel at the request or transport level (``double-cancel``) and,
  when ``flag_rewait=True``, re-waiting a completed request
  (``double-wait`` — off by default because the scheduler's drain re-waits
  legitimately);
* KV page reservations still held at engine close (``kv-page-leak``),
  staged broker keys never claimed or discarded (``broker-key-leak``), and
  requests still pending when their queue's owner closes
  (``pending-at-close``).

Diagnostics are *recorded*, not raised (``strict=True`` raises
:class:`SanitizerError` at the offending hook instead), so a sanitized run
completes and ends with a :class:`SanitizerReport` — what
``launch/train.py --sanitize`` and ``launch/serve.py --sanitize`` print and
write as an artifact.  The hooks live in :mod:`repro_torch.core.requests`,
:mod:`repro_torch.core.transport`, :mod:`repro.core.scheduler`,
:mod:`repro_torch.core.collectives`, :mod:`repro_torch.serving.kv_cache` and
:mod:`repro_torch.serving.engine`; this module imports nothing from them (it is
the bottom of the dependency stack).

Example — seeding a leak and reading the report::

    >>> import gc
    >>> class Handle: pass
    >>> with scoped() as s:
    ...     h = Handle()
    ...     s.track_state(h, {"done": False, "op": "recv", "generation": 0,
    ...                       "comm_key": None, "stack": ""})
    ...     del h                          # dropped while pending
    ...     _ = gc.collect()
    >>> [d.kind for d in s.report().diagnostics]
    ['request-leak']
"""

from __future__ import annotations

import os
import traceback
import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field


class SanitizerError(RuntimeError):
    """Raised at the offending hook when ``CommSanitizer(strict=True)``."""


@dataclass(frozen=True)
class Diagnostic:
    """One detected violation: machine-stable ``kind``, human message, and
    (when available) the creation stack of the offending object."""

    kind: str
    message: str
    where: str = ""

    def format(self) -> str:
        s = f"[{self.kind}] {self.message}"
        if self.where:
            s += "\n" + "\n".join(f"    {ln}" for ln in
                                  self.where.rstrip().splitlines())
        return s


@dataclass(frozen=True)
class SanitizerReport:
    """Immutable snapshot of a sanitizer's findings — the artifact surfaced
    by ``--sanitize`` launches."""

    diagnostics: tuple[Diagnostic, ...]
    counters: dict[str, int] = field(default_factory=dict)

    @property
    def clean(self) -> bool:
        return not self.diagnostics

    def kinds(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for d in self.diagnostics:
            out[d.kind] = out.get(d.kind, 0) + 1
        return out

    def to_dict(self) -> dict:
        return {
            "clean": self.clean,
            "diagnostics": [
                {"kind": d.kind, "message": d.message, "where": d.where}
                for d in self.diagnostics
            ],
            "counters": dict(self.counters),
        }

    def format(self) -> str:
        head = (f"CommSanitizer: {len(self.diagnostics)} diagnostic(s)"
                if self.diagnostics else "CommSanitizer: clean")
        lines = [head]
        lines += [d.format() for d in self.diagnostics]
        if self.counters:
            stats = ", ".join(f"{k}={v}"
                              for k, v in sorted(self.counters.items()))
            lines.append(f"  counters: {stats}")
        return "\n".join(lines)


class CommSanitizer:
    """The runtime checker.  One instance accumulates diagnostics across
    every hook call while it is the *active* sanitizer (see
    :func:`activate` / :func:`scoped`)."""

    def __init__(self, strict: bool = False, flag_rewait: bool = False,
                 max_ladder: int = 32):
        self.strict = strict
        self.flag_rewait = flag_rewait
        self.max_ladder = int(max_ladder)
        self._diags: list[Diagnostic] = []
        self.counters: dict[str, int] = {}
        self._gen: dict[str, int] = {}        # comm key -> latest generation
        self._digests: dict[str, dict[int, int]] = {}   # key -> rank -> hash
        self._ladders: dict[str, dict[int, list[str]]] = {}
        self._sends: dict[tuple, set] = {}    # (id(t), src, dst) -> tags

    # -- bookkeeping ---------------------------------------------------------
    def _bump(self, key: str, n: int = 1) -> None:
        self.counters[key] = self.counters.get(key, 0) + n

    def _diag(self, kind: str, message: str, where: str = "",
              raising: bool = True) -> None:
        self._diags.append(Diagnostic(kind, message, where))
        self._bump("diagnostics")
        if self.strict and raising:
            raise SanitizerError(f"{kind}: {message}")

    def report(self) -> SanitizerReport:
        return SanitizerReport(tuple(self._diags), dict(self.counters))

    # -- request lifecycle ---------------------------------------------------
    def on_request_created(self, req) -> None:
        """Track a pending request for GC-leak detection.  Requests that
        complete at issue carry nothing to leak and are only counted."""
        self._bump("requests")
        if getattr(req, "_done", True):
            return
        stack = "".join(traceback.format_list(
            traceback.extract_stack(limit=10)[:-3]))
        state = {
            "done": False, "op": req.op, "generation": req.generation,
            "comm_key": None, "stack": stack,
        }
        req._fmi_san = state
        self.track_state(req, state)

    def track_state(self, owner, state: dict) -> None:
        """Arm the GC-leak finalizer: when ``owner`` is collected while
        ``state['done']`` is still false, a request-leak diagnostic is
        recorded (split out of :meth:`on_request_created` so the mechanism
        is testable without a real request)."""
        me = weakref.ref(self)

        def _finalize(s=state, me=me):
            san = me()
            if san is not None and not s["done"]:
                san._diag(
                    "request-leak",
                    f"{s['op']} request (generation {s['generation']}) was "
                    "garbage-collected while still pending — it was never "
                    "waited, tested or cancelled",
                    s["stack"], raising=False)

        weakref.finalize(owner, _finalize)

    def on_issue(self, req, comm_key: str, generation: int) -> None:
        """Associate an issued request with its communicator epoch."""
        self._bump("issues")
        self._gen[comm_key] = max(self._gen.get(comm_key, -1), generation)
        state = getattr(req, "_fmi_san", None)
        if state is not None:
            state["comm_key"] = comm_key

    def on_wait(self, req) -> None:
        self._bump("waits")
        if getattr(req, "cancelled", False):
            # waiting a cancelled request raises CancelledError by contract
            self._bump("waits_after_cancel")
            return
        state = getattr(req, "_fmi_san", None)
        if state is None:
            return
        if state["done"]:
            self._bump("rewaits")
            if self.flag_rewait:
                self._diag("double-wait",
                           f"{state['op']} request waited again after "
                           "completion", state["stack"])
            return
        key = state["comm_key"]
        current = self._gen.get(key) if key is not None else None
        if current is not None and state["generation"] < current:
            self._diag(
                "cross-generation-wait",
                f"{state['op']} request from generation "
                f"{state['generation']} waited after {key} regrouped to "
                f"generation {current} — the stale exchange can never be "
                "answered (quiesce should have cancelled it)",
                state["stack"])

    def on_cancel(self, req) -> None:
        self._bump("cancels")
        if getattr(req, "cancelled", False):
            self._diag("double-cancel",
                       f"{req.op} request cancelled twice")
            return
        state = getattr(req, "_fmi_san", None)
        if state is not None and not state["done"]:
            state["done"] = True

    # -- transport level -----------------------------------------------------
    def on_transport_cancel(self, treq) -> None:
        self._bump("transport_cancels")

    def on_transport_double_cancel(self, treq) -> None:
        self._diag("double-cancel", "transport request cancelled twice")

    # -- collective ladders --------------------------------------------------
    def on_collective(self, comm_key: str, op: str, nbytes: int, size: int,
                      rank: int | None = None) -> None:
        """Record one collective on every rank's ladder (``rank=None``: the
        lockstep case — one call covers all ranks; a per-rank caller passes
        its own rank)."""
        self._bump("collectives")
        digests = self._digests.setdefault(comm_key, {})
        ladders = self._ladders.setdefault(comm_key, {})
        for r in (range(size) if rank is None else (rank,)):
            digests[r] = hash((digests.get(r, 0), op, int(nbytes)))
            lad = ladders.setdefault(r, [])
            if len(lad) < self.max_ladder:
                lad.append(f"{op}:{int(nbytes)}B")

    def barrier_check(self, comm_key: str, size: int) -> None:
        """Compare the per-rank ladder digests at a synchronization point;
        divergence means some rank ran a different collective sequence.
        The ladders reset afterwards (a barrier starts a new epoch)."""
        self._bump("barriers")
        digests = self._digests.pop(comm_key, {})
        ladders = self._ladders.pop(comm_key, {})
        seen = {digests.get(r, 0) for r in range(size)}
        if len(seen) > 1:
            detail = "; ".join(
                f"rank {r}: [{', '.join(ladders.get(r, []))}]"
                for r in range(size))
            self._diag("collective-mismatch",
                       f"per-rank collective sequences diverged on "
                       f"{comm_key}: {detail}")

    def on_regroup(self, comm_key: str, generation: int) -> None:
        """A membership change: bump the key's epoch and reset its ladders
        (the regrouped world starts a fresh sequence)."""
        self._bump("regroups")
        self._gen[comm_key] = max(self._gen.get(comm_key, -1), generation)
        self._digests.pop(comm_key, None)
        self._ladders.pop(comm_key, None)

    # -- point-to-point tag matching -----------------------------------------
    def on_isend(self, t, pairs, tag) -> None:
        self._bump("isends")
        for src, dst in pairs:
            key = (id(t), src, dst)
            live = self._sends.setdefault(key, set())
            if live and tag not in live:
                self._diag(
                    "tag-race",
                    f"isend tag {tag!r} issued while tags "
                    f"{sorted(map(repr, live))} are still in flight on pair "
                    f"({src}->{dst}) — concurrent same-peer sends have no "
                    "ordering guarantee")
            live.add(tag)

    def on_irecv(self, t, tag) -> None:
        self._bump("irecvs")
        for key in [k for k in self._sends if k[0] == id(t)]:
            self._sends[key].discard(tag)
            if not self._sends[key]:
                del self._sends[key]

    def on_mailbox_abort(self, t, n: int) -> None:
        self._bump("mailbox_aborts", n)
        for key in [k for k in self._sends if k[0] == id(t)]:
            del self._sends[key]

    # -- resource accounting (KV cache / broker / queues) --------------------
    def on_kv_alloc(self, kv, seq_id: int, pages) -> None:
        self._bump("kv_allocs")

    def on_kv_free(self, kv, seq_id: int, n_pages: int) -> None:
        self._bump("kv_frees")

    def check_kv(self, kv, where: str) -> None:
        """Report reservations still held when their owner shuts down."""
        live = tuple(getattr(kv, "live_seqs", ()))
        if live:
            self._diag(
                "kv-page-leak",
                f"{len(live)} sequence reservation(s) {list(live)} still "
                f"hold {kv.pages_in_use} page(s) at {where} — evict/free "
                "was skipped on some path")

    def check_broker(self, broker, where: str) -> None:
        live = broker.stats.live_keys
        if live:
            self._diag(
                "broker-key-leak",
                f"{live} staged broker key(s) never claimed or discarded "
                f"at {where} (puts={broker.stats.puts}, "
                f"gets={broker.stats.gets}, aborts={broker.stats.aborts})")

    def check_queue(self, queue, where: str) -> None:
        pending = getattr(queue, "pending", 0)
        if pending:
            self._diag(
                "pending-at-close",
                f"{pending} request(s) still pending at {where} — drain or "
                "cancel before closing")

    def on_scheduler_abort(self, n_cancelled: int) -> None:
        self._bump("scheduler_aborts")
        self._bump("scheduler_cancelled", n_cancelled)


# ---------------------------------------------------------------------------
# Activation (process-global, env-gated, or scoped)
# ---------------------------------------------------------------------------

_active: CommSanitizer | None = None
_env_checked = False


def enabled_by_env() -> bool:
    return os.environ.get("FMI_SANITIZE", "").strip().lower() in (
        "1", "true", "yes", "on")


def get_active() -> CommSanitizer | None:
    """The active sanitizer, or None when sanitizing is off.  On the first
    call this consults ``FMI_SANITIZE`` and, when set, installs a global
    instance — so an env-enabled run needs no code changes anywhere."""
    global _active, _env_checked
    if _active is not None:
        return _active
    if not _env_checked:
        _env_checked = True
        if enabled_by_env():
            _active = CommSanitizer()
    return _active


def activate(s: CommSanitizer | None = None) -> CommSanitizer:
    """Install ``s`` (or a fresh instance) as the active sanitizer."""
    global _active
    _active = s if s is not None else CommSanitizer()
    return _active


def deactivate() -> CommSanitizer | None:
    """Remove the active sanitizer; returns it so a report can still be
    taken."""
    global _active
    s, _active = _active, None
    return s


def ensure_active() -> CommSanitizer:
    """The active sanitizer, installing a global one if none is active
    (what ``Communicator(sanitize=True)`` and ``--sanitize`` call)."""
    s = get_active()
    return s if s is not None else activate()


@contextmanager
def scoped(**kwargs):
    """A fresh sanitizer active for the ``with`` body only — the test
    idiom: diagnostics never leak between scenarios, and any process-global
    sanitizer is restored on exit."""
    global _active, _env_checked
    prev, prev_checked = _active, _env_checked
    s = CommSanitizer(**kwargs)
    _active, _env_checked = s, True
    try:
        yield s
    finally:
        _active, _env_checked = prev, prev_checked


def _reset_for_tests() -> None:
    """Forget activation state (including the env cache)."""
    global _active, _env_checked
    _active = None
    _env_checked = False

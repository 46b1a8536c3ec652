"""FMI continuous-batching serving engine on PyTorch.

Port of the FMI path of :mod:`repro.serving.engine`
(:class:`ContinuousBatchingEngine`): the tensor-parallel continuous-batching
runtime.  Per step it *decodes* the live batch, *admits* waiting requests
(page-reservation gate on the rank-sharded
:class:`~repro_torch.serving.kv_cache.PagedKVCache`) and prefills them, then
*evicts* finished sequences, with every collective issued through the
nonblocking request layer on an engine-owned instrumented channel.  A rank
killed mid-decode heals through the elastic runtime (quiesce → regroup →
replay from the KV-page manifest).

Weights, KV pools, activations and logits live on the engine's device
(``device=None``: CUDA, raising when there is none); the emitted tokens
leave the device once per step, when the step's emissions are drained.
The mesh wave path of the reference (``ServeEngine``, ``make_serve_fns``)
is not ported yet (ROADMAP Queue 1, item 16).

Doctest — continuous batching end to end on two simulated ranks::

    >>> from repro_torch.serving.tp_lm import TPServeConfig
    >>> cfg = TPServeConfig(vocab_size=32, d_model=16, n_heads=4, head_dim=4,
    ...                     d_ff=32, n_layers=1, max_len=16, ff_chunks=4)
    >>> eng = ContinuousBatchingEngine(cfg, world=2, max_slots=2, kv_pages=8,
    ...                                page_size=4, device="cpu")
    >>> for prompt in ([1, 2, 3], [4, 5], [6]):
    ...     _ = eng.submit(prompt, max_new=3)
    >>> out = eng.run()
    >>> sorted(out), sorted(len(v) for v in out.values())
    ([0, 1, 2], [3, 3, 3])
    >>> eng.transport.trace.pending      # every request drained
    0
    >>> eng.close()
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..analysis.sanitizer import get_active as _sanitizer
from ..core.communicator import Communicator
from ..core.requests import RequestQueue
from ..devices import resolve_device
from . import tp_lm
from .kv_cache import KVPageManifest, OutOfPages, PagedKVCache
from .tp_lm import TPServeConfig


@dataclass
class _SeqState:
    prompt: list
    max_new: int
    generated: list


class ContinuousBatchingEngine:
    """Tensor-parallel continuous batching over the FMI request layer.

    One :meth:`step` is the continuous-batching cycle:

    1. **decode** — every active sequence advances one token: the TP
       forward issues two latency-bound partial allreduces per layer and
       the token-emission collective (logits-shard allgather, or the
       8-byte ``local-argmax`` exchange) is left **in flight**;
    2. **admit** — waiting requests are admitted while a slot and their
       full page reservation (``prompt + max_new`` tokens) are available;
       each admit prefills in one bandwidth-bound pass.  The decode
       emission request stays undrained across the admission work
       (MPI-style deferred completion);
    3. **drain** — emissions complete, the step's tokens leave the device
       in one copy and append, finished sequences evict (their pages free
       for the next step's admissions).

    The engine owns a private registered channel (an instrumented
    :class:`~repro_torch.core.transport.SimTransport` by default) so traces,
    fault injection (``engine.transport.kill``) and regrouping stay under
    its control; :meth:`close` unregisters it.

    Elasticity: :meth:`step_or_heal` runs a step under the runtime's
    detect → quiesce → regroup → reshard protocol
    (:class:`repro_torch.runtime.elastic.ElasticController`).  ``restore``
    replays every live sequence from the KV-page manifest at the regrouped
    world size; bit-exactness across world sizes means the healed run
    emits exactly the tokens the unfailed run would have.

    ``params`` are port weights (:func:`~repro_torch.serving.tp_lm.init_params`
    or :func:`~repro_torch.serving.tp_lm.weights_from_reference`) on the
    engine's ``device``; without them the engine draws its own from
    ``seed`` on that device.  ``decode_steps`` counts the steps that ran a
    non-empty decode batch.
    """

    _n_engines = 0  # suffix for unique per-engine channel names

    def __init__(self, cfg: TPServeConfig | None = None, *, world: int = 1,
                 max_slots: int = 4, kv_pages: int = 64, page_size: int = 8,
                 params: dict | None = None, seed: int = 0,
                 logits_mode: str = "gather", max_new_default: int = 16,
                 objective: str = "time", strategy: str = "pow2_floor",
                 kv_dtype: str = "f32", attn_backend: str = "gather",
                 wire_dtype: str | None = None, device=None):
        from ..core import channels as CH
        from ..core.models import ChannelSpec
        from ..runtime import ElasticController, Membership
        from .kv_cache import KV_ITEMSIZE

        self.cfg = cfg if cfg is not None else TPServeConfig()
        self.cfg.validate_world(world)
        if logits_mode not in ("gather", "local-argmax"):
            raise ValueError(f"unknown logits_mode {logits_mode!r}")
        if kv_dtype not in KV_ITEMSIZE:
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
        # the emission wire follows the KV tier unless pinned explicitly —
        # a quantized cache usually wants the quantized allgather too
        self.kv_dtype = kv_dtype
        self.wire_dtype = kv_dtype if wire_dtype is None else wire_dtype
        tp_lm._wire_codec(self.wire_dtype)  # validate eagerly
        self.max_slots = int(max_slots)
        self.kv_pages = int(kv_pages)
        self.page_size = int(page_size)
        self.logits_mode = logits_mode
        self.max_new_default = int(max_new_default)
        self.objective = objective
        self.device = resolve_device(device)
        if params is None:
            params = tp_lm.init_params(self.cfg, seed, device=self.device)
        elif params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.weights = params
        self.decoder = tp_lm.TPDecoder(self.weights, self.cfg,
                                       attn_backend=attn_backend)

        self.queue = RequestQueue()
        self.comm_log: list = []  # (op, nbytes, wait_s) per drained request
        self._waiting: deque = deque()
        self._states: dict[int, _SeqState] = {}
        self._active: list[int] = []
        self.finished: dict[int, np.ndarray] = {}
        self._next_id = 0
        self.steps = 0
        self.decode_steps = 0
        self.tokens_emitted = 0

        self.membership = Membership(expected=world)
        for r in range(world):
            self.membership.join(r)
        self.controller = ElasticController(
            membership=self.membership, rebuild=self._rebuild,
            restore=self._replay, quiesce=self._quiesce, strategy=strategy,
        )

        # engine-owned instrumented channel (sim α-β constants).  private=
        # True keeps it out of default_channels(): resolvable by name, never
        # enumerated by unrelated algorithm='auto' selections.
        self._box: dict = {"t": None}
        ContinuousBatchingEngine._n_engines += 1
        self.channel = f"serve{ContinuousBatchingEngine._n_engines}"
        CH.register_channel(
            ChannelSpec(self.channel, alpha=5e-6, beta=1 / 16e9,
                        kind="direct", push=True),
            transport_factory=lambda **kw: self._box["t"],
            private=True,
        )
        self._closed = False
        try:
            self.comm = Communicator(axes=("data",), sizes=(world,),
                                     channel=self.channel)
            self._build_world(world)
        except BaseException:
            self.close()  # never leak the registration on a failed init
            raise

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        """Release engine-owned resources and unregister the private channel
        (idempotent).  Under :mod:`repro_torch.analysis.sanitizer` this is also the
        leak checkpoint: requests still pending and KV reservations never
        released are diagnosed *before* being cleaned up, so an engine
        abandoned mid-serve shows up in the sanitizer report rather than
        silently evaporating with its channel."""
        if self._closed:
            return
        from ..core import channels as CH

        where = f"ContinuousBatchingEngine[{self.channel}].close"
        s = _sanitizer()
        queue = getattr(self, "queue", None)
        kv = getattr(self, "kv", None)
        try:
            if s is not None:
                if queue is not None:
                    s.check_queue(queue, where)
                if kv is not None:
                    s.check_kv(kv, where)
        finally:
            # abort-path hygiene: drop in-flight requests and return reserved
            # pages before the channel registration disappears
            if queue is not None:
                queue.cancel_all()
            if kv is not None:
                for sid in kv.live_seqs:
                    kv.free(sid)
            CH.unregister(self.channel)
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    @property
    def world(self) -> int:
        return self.comm.size

    @property
    def transport(self):
        """The live instrumented transport (fault injection entry point)."""
        return self._box["t"]

    def _build_world(self, world: int) -> None:
        from ..core.transport import SimTransport

        self.cfg.validate_world(world)
        # fmi-lint: disable=FMI004 -- engine-owned private channel: this raw
        self._box["t"] = SimTransport(world, self.device)  # transport IS the registration
        if self.comm.size != world:
            self.comm = self.comm.regroup(sizes=(world,))
        self.kv = PagedKVCache(
            self.cfg.n_layers, self.kv_pages, self.page_size,
            heads_local=self.cfg.n_heads // world,
            head_dim=self.cfg.head_dim, world=world,
            kv_dtype=self.kv_dtype, device=self.device,
        )

    # -- request intake -----------------------------------------------------
    def submit(self, prompt_tokens, max_new: int | None = None) -> int:
        """Queue one request; returns its sequence id."""
        prompt = [int(t) for t in np.asarray(prompt_tokens).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        max_new = self.max_new_default if max_new is None else int(max_new)
        total = len(prompt) + max_new
        if total > self.cfg.max_len:
            raise ValueError(f"prompt+max_new {total} exceeds max_len "
                             f"{self.cfg.max_len}")
        if self.kv.pages_for(total) > self.kv.n_pages:
            raise ValueError(f"request needs {self.kv.pages_for(total)} "
                             f"pages; pool only has {self.kv.n_pages}")
        sid = self._next_id
        self._next_id += 1
        self._states[sid] = _SeqState(prompt=prompt, max_new=max_new,
                                      generated=[])
        self._waiting.append(sid)
        return sid

    @property
    def waiting(self) -> tuple[int, ...]:
        return tuple(self._waiting)

    @property
    def active(self) -> tuple[int, ...]:
        return tuple(self._active)

    @property
    def done(self) -> bool:
        return not self._waiting and not self._active

    # -- the continuous-batching cycle --------------------------------------
    def _emit(self, shard) -> "object":
        """Issue the token-emission collective for a logits shard.  Returns
        the request and the pick that turns its result into the emitted
        token ids (a tensor on the engine's device)."""
        if self.logits_mode == "gather":
            req = tp_lm.gather_logits(self.comm, shard, self.queue,
                                      wire=self.wire_dtype)
            return req, lambda out: torch.argmax(out[0], dim=-1)
        req = tp_lm.local_argmax(self.comm, shard, self.queue)
        return req, lambda out: out[0]

    @staticmethod
    def _drain(emissions) -> list[list[int]]:
        """Wait every ``(req, pick)`` emission in issue order and bring all
        their tokens to the host in one copy."""
        picks = [pick(req.wait()).reshape(-1) for req, pick in emissions]
        if not picks:
            return []
        flat = torch.cat(picks).tolist()
        out, i = [], 0
        for p in picks:
            out.append(flat[i:i + p.numel()])
            i += p.numel()
        return out

    def _forward(self, sids, tokens, positions):
        return self.decoder.forward(
            self.comm, self.kv, sids, tokens, positions,
            queue=self.queue, comm_log=self.comm_log,
        )

    def step(self) -> list[int]:
        """One admit/decode/evict cycle.  Returns the sequence ids that
        finished this step (their outputs land in :attr:`finished`)."""
        decode_req = None
        batch = list(self._active)
        if batch:
            tokens = np.array([[self._states[s].generated[-1]]
                               for s in batch])
            positions = np.array([[self.kv.length(s)] for s in batch])
            shard = self._forward(batch, tokens, positions)
            for s in batch:
                self.kv.advance(s, 1)
            decode_req = self._emit(shard)
            self.decode_steps += 1

        # admissions: prefill while the decode emission is still in flight
        prefill_reqs = []
        while len(self._active) < self.max_slots and self._waiting:
            sid = self._waiting[0]
            st = self._states[sid]
            try:
                self.kv.alloc(sid, capacity=len(st.prompt) + st.max_new)
            except OutOfPages:
                break
            toks = np.array([st.prompt])
            pos = np.arange(len(st.prompt))[None]
            # a RankFailure inside this prefill leaves the request queued:
            # the pop below only commits once the forward has completed (the
            # heal discards the whole cache, so the partial alloc is moot)
            shard = self._forward([sid], toks, pos)
            self.kv.advance(sid, len(st.prompt))
            self._waiting.popleft()
            self._active.append(sid)  # live from here on: the manifest (and
            # a replay) covers it even if a later prefill hits a failure
            prefill_reqs.append((sid, self._emit(shard)))

        # drain: decode emission first (issue order), then the prefills
        finished = []
        emissions = [e for _, e in prefill_reqs]
        if decode_req is not None:
            emissions.insert(0, decode_req)
        drained = self._drain(emissions)
        if decode_req is not None:
            for s, tok in zip(batch, drained.pop(0)):
                self._states[s].generated.append(int(tok))
                self.tokens_emitted += 1
        for (sid, _), toks in zip(prefill_reqs, drained):
            self._states[sid].generated.append(int(toks[0]))
            self.tokens_emitted += 1
        self.queue.waitall()  # retire completed requests from the queue

        for s in list(self._active):
            st = self._states[s]
            if len(st.generated) >= st.max_new:
                self.kv.free(s)
                self._active.remove(s)
                self.finished[s] = np.asarray(st.generated, np.int64)
                finished.append(s)
        self.steps += 1
        return finished

    def run(self, max_steps: int | None = None) -> dict[int, np.ndarray]:
        """Serve until every submitted request finishes (or ``max_steps``);
        heals on the way if ranks die.  Returns ``{seq_id: generated}``."""
        n = 0
        while not self.done and (max_steps is None or n < max_steps):
            self.step_or_heal()
            n += 1
        return dict(self.finished)

    # -- elasticity: detect -> quiesce -> regroup -> replay ------------------
    def step_or_heal(self) -> tuple[list[int], bool]:
        """Run one step under failure protection.  On a
        :class:`~repro_torch.core.transport.RankFailure` the elastic controller
        quiesces in-flight requests, regroups the survivors, and replays
        every live sequence from the KV-page manifest; the interrupted
        step's tokens are re-derived by the replay itself."""
        # lockstep liveness: this process IS every rank, so each cycle beats
        # the whole current group — failure detection here is transport
        # evidence (RankFailure), not timers; the heartbeat path matters on
        # real multi-host deployments (paper §3.1)
        for r in sorted(self.membership.group()):
            self.membership.heartbeat(r)
        out: list[int] = []
        healed = self.controller.step_or_heal(
            lambda: out.extend(self.step()))
        return out, healed

    def manifest(self) -> KVPageManifest:
        """The KV-page manifest: everything needed to rebuild the live
        batch elsewhere (token history + page accounting per sequence)."""
        man = KVPageManifest(world=self.world,
                             generation=self.comm.generation)
        for s in self._active:
            st = self._states[s]
            man.seqs[s] = {
                "tokens": list(st.prompt) + list(st.generated),
                "n_prompt": len(st.prompt), "max_new": st.max_new,
                **self.kv.manifest_entry(s),
            }
        return man

    def evacuate(self) -> dict:
        """Drain this replica for **fleet-level** re-routing (the reference's
        ``FleetController``; the fleet is not ported yet): snapshot the live
        batch's KV-page manifest plus the not-yet-admitted queue, release
        every page reservation, and return the evacuation record.  The KV
        pages themselves are *not* shipped — exactly like the intra-engine
        heal, the token histories in the manifest are the recoverable
        state, and the receiving replica re-prefills them (prefill ≡
        incremental decode bitwise, so the re-routed sequence continues on
        the unfailed trajectory).  After evacuation the engine is empty
        and :meth:`close` is leak-free under the sanitizer."""
        record = {
            "manifest": self.manifest(),
            "waiting": tuple(
                (sid, tuple(self._states[sid].prompt),
                 self._states[sid].max_new)
                for sid in self._waiting),
        }
        for sid in list(self._active):
            self.kv.free(sid)
        self._active.clear()
        self._waiting.clear()
        return record

    def _quiesce(self) -> int:
        self._replay_manifest = self.manifest()
        return self.queue.cancel_all(self.comm.generation)

    def _rebuild(self, world: int) -> None:
        self._build_world(world)

    def _replay(self) -> int:
        """Re-prefill every manifest sequence at the new world size and
        re-derive the token the failed step was computing."""
        man = self._replay_manifest
        emissions = []
        for sid in man.live:
            entry = man.seqs[sid]
            self.kv.alloc(sid, capacity=entry["n_prompt"] + entry["max_new"])
            toks = np.array([entry["tokens"]])
            pos = np.arange(toks.shape[1])[None]
            shard = self._forward([sid], toks, pos)
            self.kv.advance(sid, toks.shape[1])
            emissions.append(self._emit(shard))
        for sid, toks in zip(man.live, self._drain(emissions)):
            self._states[sid].generated.append(int(toks[0]))
            self.tokens_emitted += 1
        replayed = len(emissions)
        self.queue.waitall()
        # a replay can complete a sequence outright
        for s in list(self._active):
            st = self._states[s]
            if len(st.generated) >= st.max_new:
                self.kv.free(s)
                self._active.remove(s)
                self.finished[s] = np.asarray(st.generated, np.int64)
        return replayed

    # -- model-driven plan ---------------------------------------------------
    def serve_plan(self, prompt_len: int = 64, **kwargs):
        """The per-step cost plan for this engine's shape on its channel
        (see :func:`repro_torch.core.selector.serve_plan`)."""
        from ..core.selector import serve_plan as _serve_plan

        return _serve_plan(
            d_model=self.cfg.d_model, n_layers=self.cfg.n_layers,
            vocab_size=self.cfg.vocab_size, P=self.world,
            batch=self.max_slots, prompt_len=prompt_len,
            channels=(self.channel,), objective=self.objective,
            flops_per_token=self.cfg.flops_per_token,
            logits_mode=self.logits_mode,
            kv_dtype=kwargs.pop("kv_dtype", self.kv_dtype), **kwargs,
        )

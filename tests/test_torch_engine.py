"""The port's continuous-batching engine against the JAX package's, at the
serving tests' config and weights: identical emitted tokens for the gather
and kernel attention backends × f32/bf16/int8 KV × world 1/2/4; and, inside
the port, the serving contract — kill-rank heal replay equal to the
unfailed run (also under int8), batch-composition invariance, local-argmax
≡ gather, admit/evict invariants, and a clean channel registry."""

import functools
import os

import pytest

torch = pytest.importorskip("torch")

from repro.serving import tp_lm as R  # noqa: E402
from repro.serving.engine import ContinuousBatchingEngine as REngine  # noqa: E402
from repro_torch.core import channels  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving import tp_lm as T  # noqa: E402
from repro_torch.serving.engine import ContinuousBatchingEngine  # noqa: E402
from repro_torch.serving.kv_cache import KVPageManifest  # noqa: E402

CFG = R.TPServeConfig(vocab_size=64, d_model=32, n_heads=4, head_dim=8,
                      d_ff=64, n_layers=2, max_len=32, ff_chunks=4)
PCFG = T.TPServeConfig(**CFG.__dict__)
PROMPTS = [[5, 9, 2], [7, 1], [3, 3, 3, 3], [11]]
ENGINE = dict(max_slots=3, kv_pages=16, page_size=4)


@pytest.fixture(autouse=True, scope="module")
def _torch_settings():
    # parity numerics: deterministic kernels, no TF32 (cuBLAS needs the
    # workspace setting before CUDA starts; harmless on the CPU)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    threads = torch.get_num_threads()
    det = torch.are_deterministic_algorithms_enabled()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.set_num_threads(threads)
    torch.use_deterministic_algorithms(det)
    torch.backends.cuda.matmul.allow_tf32 = tf32


@functools.lru_cache(maxsize=1)
def _weights():
    return T.weights_from_reference(R.init_params(CFG, seed=1), PCFG, "cpu")


def _drive(eng, prompts, max_new, kill):
    for p in prompts:
        eng.submit(p, max_new=max_new)
    heals, n = 0, 0
    while not eng.done and n < 200:
        if kill is not None and n == kill[1]:
            eng.transport.kill(kill[0], after_rounds=3)
        _, healed = eng.step_or_heal()
        heals += healed
        n += 1
    assert eng.done
    facts = dict(world=eng.world, heals=heals,
                 pending=eng.transport.trace.pending,
                 pages=eng.kv.pages_in_use, queue=len(eng.queue),
                 generation=eng.comm.generation,
                 history=list(eng.controller.history),
                 decode_steps=getattr(eng, "decode_steps", None))
    return {k: [int(t) for t in v] for k, v in eng.finished.items()}, facts


def serve(world, prompts=PROMPTS, max_new=6, kill=None, **kw):
    eng = ContinuousBatchingEngine(PCFG, world=world, params=_weights(),
                                   device="cpu", **{**ENGINE, **kw})
    with eng:
        return _drive(eng, prompts, max_new, kill)


@functools.lru_cache(maxsize=None)
def _reference(world, attn_backend, kv_dtype):
    with REngine(CFG, world=world, seed=1, attn_backend=attn_backend,
                 kv_dtype=kv_dtype, **ENGINE) as eng:
        return _drive(eng, PROMPTS, 6, None)[0]


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("attn_backend", ["gather", "kernel"])
def test_tokens_match_reference_engine(attn_backend, kv_dtype, world):
    got, facts = serve(world, attn_backend=attn_backend, kv_dtype=kv_dtype)
    assert got == _reference(world, attn_backend, kv_dtype)
    assert facts["pending"] == 0 and facts["pages"] == 0
    assert facts["queue"] == 0


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_kill_rank_mid_decode_heals_to_unfailed_tokens(kv_dtype):
    ref, clean = serve(4, attn_backend="kernel", kv_dtype=kv_dtype)
    got, facts = serve(4, attn_backend="kernel", kv_dtype=kv_dtype,
                       kill=(3, 2))
    assert clean["heals"] == 0 and facts["heals"] == 1
    assert facts["world"] == 2 and facts["generation"] == 1
    assert got == ref
    assert facts["pending"] == 0 and facts["pages"] == 0
    h = facts["history"][0]
    assert h["dp"] == 2 and h["survivors"] == 3 and h["step"] >= 1


def test_kill_during_first_admission_prefill_loses_no_request():
    ref, _ = serve(4)
    got, facts = serve(4, kill=(2, 0))
    assert facts["heals"] == 1 and facts["world"] == 2
    assert got == ref and facts["pages"] == 0


def test_local_argmax_mode_matches_gather():
    assert serve(4, logits_mode="local-argmax")[0] == serve(4)[0]


def test_batch_composition_does_not_change_outputs():
    solo, _ = serve(2, prompts=[PROMPTS[0]], max_new=5)
    shared, _ = serve(2, prompts=PROMPTS, max_new=5)
    assert shared[0] == solo[0]


def test_kernel_backend_calls_attention_once_per_layer_per_decode_step(
        monkeypatch):
    calls = []
    real = ops.paged_attention

    def counting(*args, **kwargs):
        calls.append(args[0].shape[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(ops, "paged_attention", counting)
    # prompts of 2+ tokens: a 1-token prefill would take the kernel too
    _, facts = serve(2, prompts=PROMPTS[:3], attn_backend="kernel")
    assert len(calls) == PCFG.n_layers * facts["decode_steps"] > 0


def test_engine_admit_evict_invariants():
    eng = ContinuousBatchingEngine(PCFG, world=1, params=_weights(),
                                   device="cpu", max_slots=2, kv_pages=4,
                                   page_size=4)
    with eng:
        sids = [eng.submit(p, max_new=4) for p in PROMPTS]
        seen = []
        while not eng.done:
            eng.step()
            assert len(eng.active) <= 2
            expect = sum(eng.kv.pages_for(len(eng._states[s].prompt) + 4)
                         for s in eng.active)
            assert eng.kv.pages_in_use == expect
            seen.append(set(eng.active))
        assert sorted(eng.finished) == sids
        assert eng.kv.pages_in_use == 0 and eng.kv.allocs == eng.kv.frees == 4
        assert eng.transport.trace.pending == 0 and len(eng.queue) == 0
        assert any(len(s) == 2 for s in seen)


def test_manifest_and_evacuate():
    eng = ContinuousBatchingEngine(PCFG, world=2, params=_weights(),
                                   device="cpu", **ENGINE)
    with eng:
        eng.submit([5, 9, 2], max_new=4)
        eng.submit([7, 1], max_new=4)
        eng.step()
        man = eng.manifest()
        assert isinstance(man, KVPageManifest)
        assert man.live == (0, 1) and man.world == 2
        e = man.seqs[0]
        assert e["tokens"][:3] == [5, 9, 2] and len(e["tokens"]) == 4
        assert e["n_prompt"] == 3 and e["length"] == 3
        rec = eng.evacuate()
        assert rec["manifest"].live == (0, 1) and eng.done
        assert eng.kv.pages_in_use == 0


def test_close_unregisters_channel(expected_default_channels):
    eng = ContinuousBatchingEngine(PCFG, world=2, params=_weights(),
                                   device="cpu", **ENGINE)
    name = eng.channel
    assert name in channels.names()
    assert name not in expected_default_channels
    assert set(channels.default_channels()) == expected_default_channels
    eng.close()
    assert name not in channels.names()
    eng.close()  # idempotent


def test_failed_init_does_not_leak_channel():
    before = channels.names()
    with pytest.raises(ValueError):
        ContinuousBatchingEngine(PCFG, world=2, params=_weights(),
                                 device="cpu", kv_pages=0)
    assert channels.names() == before


def test_engine_validation():
    with pytest.raises(ValueError):
        ContinuousBatchingEngine(PCFG, device="cpu", kv_dtype="f16")
    with pytest.raises(ValueError):
        ContinuousBatchingEngine(PCFG, device="cpu", attn_backend="flash")
    with pytest.raises(ValueError):
        ContinuousBatchingEngine(PCFG, device="cpu", wire_dtype="f64")
    with ContinuousBatchingEngine(PCFG, device="cpu", kv_pages=2,
                                  page_size=4) as eng:
        with pytest.raises(ValueError):
            eng.submit([], max_new=4)
        with pytest.raises(ValueError):
            eng.submit([1], max_new=PCFG.max_len)
        with pytest.raises(ValueError):
            eng.submit([1, 2, 3], max_new=9)


def test_serve_plan_uses_engine_channel():
    eng = ContinuousBatchingEngine(PCFG, world=2, params=_weights(),
                                   device="cpu", **ENGINE)
    with eng:
        plan = eng.serve_plan(prompt_len=8)
        assert plan.decode.allreduce.channel == eng.channel
        assert plan.P == 2 and plan.decode.usd_per_mtok > 0

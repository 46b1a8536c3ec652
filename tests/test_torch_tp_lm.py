"""The port's TP decoder against the JAX package's, at the serving tests'
config: prefill logits within rtol=atol=1e-5 with identical greedy tokens
(the port sums each dot product in another order than numpy's per-vector
gemv), bitwise-equal emission codecs and tree sums, and — inside the port —
logits bitwise across worlds and decode ≡ prefill on the gather path."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.communicator import Communicator as RComm  # noqa: E402
from repro.serving import tp_lm as R  # noqa: E402
from repro_torch.core.communicator import Communicator as PComm  # noqa: E402
from repro_torch.serving import tp_lm as T  # noqa: E402
from repro_torch.serving.kv_cache import PagedKVCache  # noqa: E402

CFG = R.TPServeConfig(vocab_size=64, d_model=32, n_heads=4, head_dim=8,
                      d_ff=64, n_layers=2, max_len=32, ff_chunks=4)
PCFG = T.TPServeConfig(**CFG.__dict__)
PROMPTS = [[5, 9, 2, 17, 30], [7, 1], [3, 3, 3, 3, 3, 3, 3, 3, 3]]


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


@pytest.fixture(scope="module")
def weights():
    logical = R.init_params(CFG, seed=0)
    return (R.split_weights(logical, CFG),
            T.weights_from_reference(logical, PCFG, "cpu"))


def _pcomm(P):
    return PComm(axes=("data",), sizes=(P,), channel="sim", device="cpu")


@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("prompt", PROMPTS, ids=lambda p: f"T{len(p)}")
def test_prefill_logits_match_reference(weights, P, prompt):
    rw, pw = weights
    toks = np.array([prompt])
    want = R.prefill_logits(rw, CFG, RComm(axes=("data",), sizes=(P,),
                                           channel="sim"), toks)
    got = T.prefill_logits(pw, PCFG, _pcomm(P), toks)
    assert tuple(got.shape) == want.shape == (P, 1, CFG.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert got.argmax(-1).tolist() == want.argmax(-1).tolist()


@pytest.mark.parametrize("prompt", PROMPTS, ids=lambda p: f"T{len(p)}")
def test_prefill_logits_bitwise_across_worlds(weights, prompt):
    _, pw = weights
    toks = np.array([prompt])
    ref = T.prefill_logits(pw, PCFG, _pcomm(1), toks)
    for P in (2, 4):
        got = T.prefill_logits(pw, PCFG, _pcomm(P), toks)
        assert torch.equal(got[0], ref[0]), f"P={P} logits diverged"
        for r in range(1, P):
            assert torch.equal(got[0], got[r])


@pytest.mark.parametrize("P", [1, 4])
def test_decode_equals_prefill_bitwise_on_gather_path(weights, P):
    """A token decoded after a shorter prefill gets the bits of the same
    token inside one longer prefill (fixed row tiles, fixed reservation)."""
    _, pw = weights
    toks = np.array([[5, 9, 2, 17, 30, 8, 1]])
    comm = _pcomm(P)

    def fresh():
        kv = PagedKVCache(PCFG.n_layers, 8, 4, PCFG.n_heads // P,
                          PCFG.head_dim, P, device="cpu")
        kv.alloc(0, capacity=12)
        return kv

    a = fresh()
    full = T.forward_tokens(pw, PCFG, comm, a, [0], toks, np.arange(7)[None])
    b = fresh()
    T.forward_tokens(pw, PCFG, comm, b, [0], toks[:, :5], np.arange(5)[None])
    T.forward_tokens(pw, PCFG, comm, b, [0], toks[:, 5:6], np.array([[5]]))
    dec = T.forward_tokens(pw, PCFG, comm, b, [0], toks[:, 6:], np.array([[6]]))
    assert torch.equal(full, dec)
    assert torch.equal(a.k_pool, b.k_pool) and torch.equal(a.v_pool, b.v_pool)


def test_kernel_backend_decode_within_tier_of_gather(weights):
    _, pw = weights
    toks = np.array([[5, 9, 2, 17, 30]])
    out = {}
    for be in ("gather", "kernel"):
        kv = PagedKVCache(PCFG.n_layers, 8, 4, 2, PCFG.head_dim, 2,
                          device="cpu")
        kv.alloc(0, capacity=8)
        comm = _pcomm(2)
        T.forward_tokens(pw, PCFG, comm, kv, [0], toks[:, :4],
                         np.arange(4)[None], attn_backend=be)
        out[be] = T.forward_tokens(pw, PCFG, comm, kv, [0], toks[:, 4:],
                                   np.array([[4]]), attn_backend=be)
    torch.testing.assert_close(out["kernel"], out["gather"], rtol=1e-5,
                               atol=1e-5)


def test_tree_sum_is_the_reference_tree():
    rng = np.random.default_rng(2)
    for n in (1, 2, 4, 8, 16):
        parts = rng.normal(size=(n, 5)).astype(np.float32) * 1e3
        want = R.tree_sum([parts[i] for i in range(n)])
        got = T.tree_sum(torch.from_numpy(parts))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8", "fp8"])
def test_wire_codec_bitwise(wire):
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(2, 3, 16)) * 3).astype(np.float32)
    renc, rdec = R._wire_codec(wire)
    penc, pdec = T._wire_codec(wire)
    want = np.asarray(renc(x))
    got = penc(torch.from_numpy(x))
    assert np.ascontiguousarray(want).tobytes() == \
        got.contiguous().view(torch.uint8).numpy().tobytes()
    np.testing.assert_array_equal(pdec(got).numpy(), rdec(want))
    with pytest.raises(ValueError):
        T._wire_codec("f64")


@pytest.mark.parametrize("P", [1, 2, 4])
def test_local_argmax_matches_gather(weights, P):
    rng = np.random.default_rng(P)
    shard = torch.from_numpy(rng.normal(size=(P, 3, 64 // P)).astype(
        np.float32))
    shard[:, 1] = 0.0  # an all-tie row: first max wins
    comm = _pcomm(P)
    full = T.gather_logits(comm, shard).wait()
    picked = T.local_argmax(comm, shard).wait()
    assert picked.tolist() == full.argmax(-1).tolist()
    assert picked[:, 1].tolist() == [0] * P


def test_weights_are_fused_views(weights):
    _, pw = weights
    layer = pw["layers"][0]
    assert tuple(layer["wq"].shape) == (CFG.d_model, CFG.n_heads * CFG.head_dim)
    assert tuple(layer["w_down"].shape) == (CFG.ff_chunks,
                                            CFG.d_ff // CFG.ff_chunks,
                                            CFG.d_model)
    logical = R.init_params(CFG, seed=0)
    np.testing.assert_array_equal(layer["wq"].reshape(CFG.d_model, CFG.n_heads,
                                                      CFG.head_dim).numpy(),
                                  logical["layers"][0]["wq"])
    own = T.init_params(PCFG, seed=0, device="cpu")
    again = T.init_params(PCFG, seed=0, device="cpu")
    assert torch.equal(own["head"], again["head"])  # seeded generator

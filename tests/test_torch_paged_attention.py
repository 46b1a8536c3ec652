"""The port's paged-attention plain version and wrapper against the JAX
package: its blocked-recurrence oracle (``repro.kernels.ref``), its
vectorized XLA twin and its Pallas kernel in interpret mode, over the
reference's sweep cases and pool tiers, at the reference's tolerance tiers.
The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against the plain version there); its test here skips."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.paged_attention import paged_attention as pa_pallas  # noqa: E402
from repro_torch.kernels import ops as pops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402

# the reference's tiers (tests/test_kernels.py)
TIER_ORACLE = dict(rtol=2e-6, atol=2e-6)
TIER_INT8_VS_F32 = dict(atol=5e-2)

PA_CASES = [
    # B, Hq, Hkv, d, ps, n_pages, npm
    (2, 4, 4, 16, 8, 8, 3),     # MHA
    (2, 8, 2, 16, 8, 8, 2),     # GQA group 4
    (1, 4, 1, 32, 4, 6, 4),     # MQA, small pages
    (4, 2, 2, 8, 16, 8, 2),     # wide pages
    (3, 4, 2, 16, 8, 10, 3),    # odd batch
]
CUDA_REASON = "needs an NVIDIA GPU; chip_smoke.py covers it"


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


def _case(case, tier, seed=0):
    """numpy inputs for one sweep case and tier (int8 pools quantized by the
    reference's ``quantize_page``).  Returns (q, k, v, table, lengths,
    k_scale, v_scale) as numpy arrays (pools in their storage dtype)."""
    rng = np.random.default_rng(seed)
    B, Hq, Hkv, d, ps, n_pages, npm = case
    q = rng.normal(size=(B, Hq, d)).astype(np.float32)
    kp = rng.normal(size=(n_pages, ps, Hkv, d)).astype(np.float32)
    vp = rng.normal(size=(n_pages, ps, Hkv, d)).astype(np.float32)
    table = np.stack([rng.choice(n_pages, npm, replace=False)
                      for _ in range(B)]).astype(np.int32)
    lengths = rng.integers(1, npm * ps + 1, size=B).astype(np.int32)
    if tier == "f32":
        return q, kp, vp, table, lengths, None, None
    if tier == "bf16":
        return (q, np.asarray(jnp.asarray(kp, jnp.bfloat16)),
                np.asarray(jnp.asarray(vp, jnp.bfloat16)), table, lengths,
                None, None)
    kq, ks = ref.quantize_page(jnp.asarray(kp))
    vq, vs = ref.quantize_page(jnp.asarray(vp))
    return (q, np.asarray(kq), np.asarray(vq), table, lengths,
            np.asarray(ks), np.asarray(vs))


def _torch_pool(a):
    if a.dtype == np.int8:
        return torch.from_numpy(a.copy())
    if a.dtype == np.float32:
        return torch.from_numpy(a.copy())
    # bf16 (ml_dtypes): exact through f32
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def _port(q, kp, vp, table, lengths, ks, vs, **kw):
    t = lambda a: None if a is None else torch.from_numpy(np.asarray(a).copy())  # noqa: E731
    return pops.paged_attention(t(q), _torch_pool(kp), _torch_pool(vp),
                                t(table), t(lengths), k_scale=t(ks),
                                v_scale=t(vs), **kw).numpy()


def _jnp(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("tier", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", PA_CASES, ids=[str(c) for c in PA_CASES])
def test_plain_vs_blocked_oracle_and_xla_twin(case, tier):
    args = _case(case, tier)
    got = _port(*args)
    q, kp, vp, tbl, ln, ks, vs = _jnp(*args)
    want = ref.paged_attention(q, kp, vp, tbl, ln, k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(got, np.asarray(want), **TIER_ORACLE)
    twin = rops.paged_attention(q, kp, vp, tbl, ln, k_scale=ks, v_scale=vs,
                                backend="xla")
    np.testing.assert_allclose(got, np.asarray(twin), **TIER_ORACLE)


@pytest.mark.parametrize("case", PA_CASES[:3], ids=[str(c) for c in PA_CASES[:3]])
def test_plain_vs_pallas_kernel_interpret(case):
    args = _case(case, "f32", seed=1)
    q, kp, vp, tbl, ln, ks, vs = _jnp(*args)
    want = pa_pallas(q, kp, vp, tbl, ln, k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(_port(*args), np.asarray(want), **TIER_ORACLE)


def test_int8_tier_vs_f32():
    f32 = _case(PA_CASES[0], "f32")
    i8 = _case(PA_CASES[0], "int8")
    a, b = _port(*f32), _port(*i8)
    np.testing.assert_allclose(b, a, **TIER_INT8_VS_F32)
    assert not np.array_equal(a, b)  # really quantized


def test_stacked_pool_heads_match_reference_twin():
    """The engine's one-call-over-all-ranks layout (kv_head, page_offset)
    agrees with the reference twin given the same head map."""
    P, Hl, d, ps, n_pages, npm, B = 2, 2, 8, 4, 6, 2, 3
    rng = np.random.default_rng(4)
    q = rng.normal(size=(B, P * Hl, d)).astype(np.float32)
    kp = rng.normal(size=(P * n_pages, ps, Hl, d)).astype(np.float32)
    vp = rng.normal(size=(P * n_pages, ps, Hl, d)).astype(np.float32)
    tbl = np.stack([rng.choice(n_pages, npm, replace=False)
                    for _ in range(B)]).astype(np.int32)
    ln = np.array([8, 3, 5], np.int32)
    heads = np.arange(P * Hl, dtype=np.int32)
    kvh, off = heads % Hl, (heads // Hl) * n_pages
    got = _port(q, kp, vp, tbl, ln, None, None,
                kv_head=torch.from_numpy(kvh), page_offset=torch.from_numpy(off))
    want = rops.paged_attention(*_jnp(q, kp, vp, tbl, ln), kv_head=jnp.asarray(kvh),
                                page_offset=jnp.asarray(off), backend="xla")
    np.testing.assert_allclose(got, np.asarray(want), **TIER_ORACLE)


def test_zero_length_row_is_exact_zero_and_cpu_calls_are_not_launches():
    q, kp, vp, tbl, ln, _, _ = _case(PA_CASES[0], "f32")
    before = pa.paged_attention.launches
    base = _port(q, kp, vp, tbl, ln, None, None)
    q0 = np.concatenate([q, q[:1]])
    t0 = np.concatenate([tbl, tbl[:1]])
    l0 = np.concatenate([ln, [0]]).astype(np.int32)
    got = _port(q0, kp, vp, t0, l0, None, None)
    assert (got[-1] == 0.0).all()
    np.testing.assert_allclose(got[:-1], base, **TIER_ORACLE)
    assert pa.paged_attention.launches == before  # CPU: plain version only


def test_docstring_example():
    out = pa.paged_attention(torch.ones(1, 2, 4), torch.ones(2, 2, 1, 4),
                             torch.arange(16.).reshape(2, 2, 1, 4),
                             torch.tensor([[1, 0]], dtype=torch.int32),
                             torch.tensor([3], dtype=torch.int32))
    want = np.mean([[8, 9, 10, 11], [12, 13, 14, 15], [0, 1, 2, 3]], 0)
    np.testing.assert_allclose(out[0, 0].numpy(), want, rtol=1e-6)


def test_unsupported_device_raises():
    q = torch.ones(1, 2, 4, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        pa.paged_attention(q, torch.ones(2, 2, 1, 4, device="meta"),
                           torch.ones(2, 2, 1, 4, device="meta"),
                           torch.zeros(1, 2, dtype=torch.int32, device="meta"),
                           torch.ones(1, dtype=torch.int32, device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["f32", "bf16", "int8"])
def test_cuda_kernel_vs_plain(tier):
    if not torch.cuda.is_available():
        pytest.skip(CUDA_REASON)
    q, kp, vp, tbl, ln, ks, vs = _case(PA_CASES[1], tier)
    dev = torch.device("cuda")
    t = lambda a: None if a is None else torch.from_numpy(np.asarray(a).copy()).to(dev)  # noqa: E731
    args = (t(q), _torch_pool(kp).to(dev), _torch_pool(vp).to(dev), t(tbl),
            t(ln))
    before = pa.paged_attention.launches
    got = pa.paged_attention(*args, k_scale=t(ks), v_scale=t(vs))
    assert pa.paged_attention.launches == before + 1
    want = pa.paged_attention_plain(*args, k_scale=t(ks), v_scale=t(vs))
    torch.testing.assert_close(got, want, **TIER_ORACLE)

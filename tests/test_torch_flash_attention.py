"""The port's flash attention against the JAX package: its plain version
against the Pallas kernel in interpret mode and against the naive oracle
``repro.kernels.ref.attention`` over the reference's sweep (``ATT_CASES``
of tests/test_kernels.py) in f32 and bf16, at the reference's tolerances;
its gradients (autograd through the plain version) against ``jax.grad``
of the oracle; and the wrapper's contract.  The CUDA kernels run only on
the card (``chip_smoke.py`` holds them against the plain version there);
their tests here skip."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as fa_pallas  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

ATT_CASES = [
    # B, Hq, Hkv, T, S, d, causal, window, q_offset (tests/test_kernels.py)
    (2, 4, 2, 256, 256, 64, True, 0, 0),
    (1, 8, 2, 128, 384, 64, True, 0, 256),   # decode-style offset
    (2, 4, 4, 200, 200, 32, True, 0, 0),     # non-block-multiple
    (1, 2, 1, 256, 256, 64, False, 0, 0),    # bidirectional (hubert)
    (2, 4, 2, 256, 256, 64, True, 64, 0),    # sliding window
    (1, 1, 1, 64, 64, 128, True, 0, 0),
    (1, 4, 2, 1, 513, 64, True, 0, 512),     # single-token decode
]
IDS = [str(c) for c in ATT_CASES]
ATOL = {"f32": 3e-5, "bf16": 3e-2}  # tests/test_kernels.py:49
CUDA_REASON = "needs an NVIDIA GPU; chip_smoke.py covers it"


@pytest.fixture(autouse=True, scope="module")
def _torch_settings():
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    threads = torch.get_num_threads()
    det = torch.are_deterministic_algorithms_enabled()
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    yield
    torch.set_num_threads(threads)
    torch.use_deterministic_algorithms(det)


def _inputs(case, dtype, seed=0):
    """Seeded numpy inputs, rounded to bf16 when asked (so both packages
    see the same values).  Returns (q, k, v) as numpy f32 arrays."""
    B, Hq, Hkv, T, S, d = case[:6]
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=s).astype(np.float32)
           for s in ((B, Hq, T, d), (B, Hkv, S, d), (B, Hkv, S, d))]
    if dtype == "bf16":
        out = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32) for a in out]
    return out


def _torch(a, dtype):
    t = torch.from_numpy(a.copy())
    return t.to(torch.bfloat16) if dtype == "bf16" else t


def _jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bf16" else jnp.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", ATT_CASES, ids=IDS)
def test_plain_vs_pallas_interpret_and_oracle(case, dtype):
    causal, window, off = case[6:]
    q, k, v = _inputs(case, dtype)
    got = fa.flash_attention_plain(_torch(q, dtype), _torch(k, dtype),
                                   _torch(v, dtype), causal, window, off)
    assert got.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    got = got.float().numpy()
    jq, jk, jv = (_jax(a, dtype) for a in (q, k, v))
    pallas = fa_pallas(jq, jk, jv, causal=causal, window=window, q_offset=off,
                       interpret=True)
    oracle = ref.attention(jq, jk, jv, causal=causal, window=window,
                           q_offset=off)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=ATOL[dtype])


@pytest.mark.parametrize("case", ATT_CASES, ids=IDS)
def test_plain_gradients_vs_jax_grad_of_oracle(case):
    causal, window, off = case[6:]
    q, k, v = _inputs(case, "f32", seed=1)
    g = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)

    def f(q_, k_, v_):
        out = ref.attention(q_, k_, v_, causal=causal, window=window,
                            q_offset=off)
        return jnp.sum(out * g)

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a.copy()).requires_grad_(True)
                  for a in (q, k, v))
    out = fa.flash_attention_plain(tq, tk, tv, causal, window, off)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   err_msg=f"d{name}")


def test_wrapper_runs_the_plain_version_on_cpu():
    case = ATT_CASES[4]
    q, k, v = (torch.from_numpy(a) for a in _inputs(case, "f32"))
    before = (fa.flash_attention.launches, fa.flash_attention_bwd.launches)
    want = fa.flash_attention_plain(q, k, v, True, 64, 0)
    for got in (fa.flash_attention(q, k, v, True, 64, 0),
                ops.flash_attention(q, k, v, True, 64, 0)):
        assert torch.equal(got, want)
    assert (fa.flash_attention.launches,
            fa.flash_attention_bwd.launches) == before


def test_wrapper_contract_refusals():
    q = torch.zeros((1, 2, 4, 16))
    with pytest.raises(NotImplementedError, match="q_offset"):
        ops.flash_attention(q, q, q, q_offset=torch.tensor(3))
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
    # what the kernel does not take is refused before any build or launch
    with pytest.raises(ValueError, match="head dim"):
        fa._check_cuda(torch.zeros((1, 2, 4, 80)), torch.zeros((1, 2, 4, 80)),
                       torch.zeros((1, 2, 4, 80)), 0, 0)
    with pytest.raises(ValueError, match="static q_offset"):
        fa._check_cuda(q, q, q, 0, -1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa._check_cuda(q.half(), q.half(), q.half(), 0, 0)


def test_cuda_call_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        q = torch.zeros((1, 2, 4, 16), device="cuda")
        fa.flash_attention(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_kernels_vs_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip(CUDA_REASON)
    case = ATT_CASES[4]
    causal, window, off = case[6:]
    dev = torch.device("cuda")
    q, k, v = (_torch(a, dtype).to(dev).requires_grad_(True)
               for a in _inputs(case, dtype))
    out = fa.flash_attention(q, k, v, causal, window, off)
    want = fa.flash_attention_plain(q, k, v, causal, window, off)
    np.testing.assert_allclose(out.float().detach().cpu().numpy(),
                               want.float().detach().cpu().numpy(),
                               atol=ATOL[dtype])
    g = torch.ones_like(out)
    got = torch.autograd.grad(out, (q, k, v), g)
    ref_g = torch.autograd.grad(want, (q, k, v), g)
    for a, b in zip(got, ref_g):
        scale = float(b.float().abs().max())
        tol = 1e-4 if dtype == "f32" else 2e-2 * scale
        np.testing.assert_allclose(a.float().cpu().numpy(),
                                   b.float().cpu().numpy(), atol=tol)

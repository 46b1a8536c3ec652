"""The port's gated-linear-attention scan against the JAX package: its
plain version against the Pallas kernel in interpret mode and against the
per-step oracle ``repro.kernels.ref.gla_scan`` over the reference's sweep
(``GLA_CASES`` of tests/test_kernels.py) in f32 and bf16, at the
reference's tolerances (output atol 2e-4 f32 / 6e-2 bf16,
tests/test_kernels.py:96; final state atol 2e-3, :111); its gradients
(autograd through the plain version) against ``jax.grad`` of the
reference's XLA twin ``repro.kernels.ops._xla_gla_scan`` for all five
inputs, within 1e-4 × max|ref| (the two differ by float32 rounding: the
largest gap seen is 3e-6 × max|ref|); and the wrapper's contract.  The
CUDA kernels run only on the card (``chip_smoke.py`` holds them against
the plain version there); their test here skips."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.ssm_scan import gla_scan as gla_pallas  # noqa: E402
from repro_torch.kernels import gla_scan as gs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

GLA_CASES = [
    # B, H, T, dk, dv, normalize, chunk (tests/test_kernels.py:79)
    (2, 2, 256, 32, 32, True, 128),
    (2, 2, 256, 32, 32, False, 128),
    (1, 4, 200, 64, 48, True, 128),   # non-multiple of chunk
    (1, 1, 512, 16, 16, True, 64),
]
GRAD_CASES = GLA_CASES + [
    (1, 2, 150, 16, 32, False, 64),   # SSD form, T not a chunk multiple
    (2, 1, 40, 32, 16, True, 128),    # one chunk shorter than the chunk size
]
IDS = [str(c) for c in GLA_CASES]
ATOL = {"f32": 2e-4, "bf16": 6e-2}  # tests/test_kernels.py:96
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


def _inputs(case, dtype="f32", seed=0):
    """Seeded numpy inputs as the reference's test draws them (log forget
    gates <= 0, input gates >= 0); q, k, v rounded to bf16 when asked so
    both packages see the same values."""
    B, H, T, dk, dv = case[:5]
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(B, H, T, dk)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(B, H, T, dv)).astype(np.float32)
    if dtype == "bf16":
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                   for a in (q, k, v))
    lf = (-np.abs(rng.normal(size=(B, H, T)) * 0.5)).astype(np.float32)
    ig = np.abs(rng.normal(size=(B, H, T))).astype(np.float32)
    return q, k, v, lf, ig


def _torch(a, dtype="f32"):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.bfloat16) if dtype == "bf16" else t


def _jax(a, dtype="f32"):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bf16" else jnp.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", GLA_CASES, ids=IDS)
def test_plain_vs_pallas_interpret_and_oracle(case, dtype):
    norm, chunk = case[5:]
    q, k, v, lf, ig = _inputs(case, dtype)
    out, state = gs.gla_scan_plain(_torch(q, dtype), _torch(k, dtype),
                                   _torch(v, dtype), _torch(lf), _torch(ig),
                                   norm, chunk)
    assert out.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    assert state.dtype == torch.float32
    jq, jk, jv = _jax(q, dtype), _jax(k, dtype), _jax(v, dtype)
    p_out, p_state = gla_pallas(jq, jk, jv, jnp.asarray(lf), jnp.asarray(ig),
                                normalize=norm, chunk=chunk, interpret=True)
    want = ref.gla_scan(jq, jk, jv, jnp.asarray(lf), jnp.asarray(ig),
                        normalize=norm)
    got = out.float().numpy()
    for other in (p_out, want):
        np.testing.assert_allclose(got, np.asarray(other, np.float32),
                                   atol=ATOL[dtype])
    np.testing.assert_allclose(state.numpy(), np.asarray(p_state), atol=2e-3)


@pytest.mark.parametrize("case", GRAD_CASES, ids=[str(c) for c in GRAD_CASES])
def test_plain_gradients_vs_jax_grad_of_the_xla_twin(case):
    norm, chunk = case[5:]
    arrays = _inputs(case, seed=1)
    shape = case[:3] + (case[4],)
    g = np.random.default_rng(2).normal(size=shape).astype(np.float32)

    def f(*a):
        out, _ = rops._xla_gla_scan(*a, normalize=norm, chunk=chunk)
        return jnp.sum(out * g)

    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrays))
    ts = [_torch(a).requires_grad_(True) for a in arrays]
    out, _ = gs.gla_scan_plain(*ts, norm, chunk)
    got = torch.autograd.grad(out, ts, torch.from_numpy(g))
    for name, a, b in zip(("q", "k", "v", "log_f", "i_gate"), got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * np.abs(b).max(),
                                   err_msg=f"d{name}")


def _tiled_backward(q, k, v, lf, ig, dout, normalize, chunk, tile=gs.TILE):
    """The backward of ``csrc/gla_scan.cu`` written out in float64: value
    tiles of ``tile`` columns (tile 0 also carries the normalizer column)
    walk the chunks in reverse carrying their slice of dC, and dq, dk and
    the gate gradients are sums of the tiles' partials."""
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    L = min(chunk, T)
    nc = -(-T // L)
    pad = nc * L - T

    def P(x):
        return torch.nn.functional.pad(x, [0, 0] * (x.dim() - 3) + [0, pad])

    qs, ks, vs, lfp, igp, dop = (P(x) for x in (q * dk**-0.5, k, v, lf, ig,
                                                 dout))
    causal = torch.ones((L, L), dtype=torch.bool).tril()
    ones = torch.ones((B, H, L, 1), dtype=q.dtype)

    def chunk_of(c):
        sl = slice(c * L, (c + 1) * L)
        b = lfp[:, :, sl].cumsum(-1)
        ex = torch.exp(torch.where(causal, b[..., :, None] - b[..., None, :],
                                   float("-inf")))
        w = torch.exp(b[..., -1:] - b) * igp[:, :, sl]
        return sl, b, ex, w

    # forward: the state entering every chunk and every step's normalizer
    C = torch.zeros((B, H, dk, dv + 1), dtype=q.dtype)
    states, nums = [], []
    for c in range(nc):
        sl, b, ex, w = chunk_of(c)
        va = torch.cat([vs[:, :, sl], ones], -1)
        S = qs[:, :, sl] @ ks[:, :, sl].transpose(-1, -2)
        states.append(C)
        nums.append((S * ex * igp[:, :, None, sl]) @ va
                    + torch.exp(b)[..., None] * (qs[:, :, sl] @ C))
        C = torch.exp(b[..., -1:])[..., None] * C + \
            (ks[:, :, sl] * w[..., None]).transpose(-1, -2) @ va
    num = torch.cat(nums, 2)
    n = num[..., dv]
    den = torch.clamp_min(n.abs(), 1.0) if normalize else torch.ones_like(n)
    out = num[..., :dv] / den[..., None]
    g = -torch.sign(n) * (n.abs() > 1) / den * (dop * out).sum(-1) \
        if normalize else torch.zeros_like(n)
    grads = [torch.zeros_like(x) for x in (qs, ks, vs, lfp, igp)]
    for j0 in range(0, dv, tile):
        cols = list(range(j0, min(j0 + tile, dv))) + ([dv] if j0 == 0 else [])
        dC = torch.zeros((B, H, dk, len(cols)), dtype=q.dtype)
        for c in reversed(range(nc)):
            sl, b, ex, w = chunk_of(c)
            qc, kc, igc = qs[:, :, sl], ks[:, :, sl], igp[:, :, sl]
            va = torch.cat([vs[:, :, sl], ones], -1)[..., cols]
            Cc = states[c][..., cols]
            dN = torch.cat([dop[:, :, sl] / den[:, :, sl, None],
                            g[:, :, sl, None]], -1)[..., cols]
            eb, ebL = torch.exp(b), torch.exp(b[..., -1])
            S = qc @ kc.transpose(-1, -2)
            dvh = (S * ex * igc[..., None, :]).transpose(-1, -2) @ dN \
                + w[..., None] * (kc @ dC)
            dA = dN @ va.transpose(-1, -2)
            dS, E = dA * ex * igc[..., None, :], dA * S * ex
            r, u = dN @ Cc.transpose(-1, -2), va @ dC.transpose(-1, -2)
            dw = (kc * u).sum(-1)
            db = (E * igc[..., None, :]).sum(-1) - igc * E.sum(-2) \
                + eb * (qc * r).sum(-1) - dw * w
            db[..., -1] += ebL * (dC * Cc).sum((-1, -2)) + (dw * w).sum(-1)
            grads[0][:, :, sl] += dS @ kc + eb[..., None] * r
            grads[1][:, :, sl] += dS.transpose(-1, -2) @ qc + w[..., None] * u
            nv = min(j0 + tile, dv) - j0
            grads[2][:, :, sl, j0:j0 + nv] += dvh[..., :nv]
            grads[3][:, :, sl] += db.flip(-1).cumsum(-1).flip(-1)
            grads[4][:, :, sl] += E.sum(-2) + dw * torch.exp(b[..., -1:] - b)
            dC = ebL[..., None, None] * dC + \
                (qc * eb[..., None]).transpose(-1, -2) @ dN
    grads[0] = grads[0] * dk**-0.5
    return [x[:, :, :T] for x in grads]


@pytest.mark.parametrize("case", GRAD_CASES + [(1, 2, 300, 16, 80, True, 128)],
                         ids=[str(c) for c in GRAD_CASES + [(1, 2, 300, 16, 80, True, 128)]])
def test_the_kernels_tiled_backward_matches_autograd(case):
    """The hand-derived backward the CUDA kernel implements (tiles,
    partials, normalizer column on tile 0), in float64, against autograd
    through the plain version (float32): within 1e-4 × max|autograd|."""
    norm, chunk = case[5:]
    arrays = _inputs(case, seed=4)
    ts = [_torch(a).requires_grad_(True) for a in arrays]
    out, _ = gs.gla_scan_plain(*ts, norm, chunk)
    dout = torch.from_numpy(np.random.default_rng(5).normal(
        size=out.shape).astype(np.float32))
    want = torch.autograd.grad(out, ts, dout)
    got = _tiled_backward(*(t.detach().double() for t in ts), dout.double(),
                          norm, chunk)
    for name, a, b in zip(("q", "k", "v", "log_f", "i_gate"), got, want):
        np.testing.assert_allclose(a.numpy(), b.double().numpy(),
                                   atol=1e-4 * float(b.abs().max()),
                                   err_msg=f"d{name}")


def test_plain_output_matches_the_xla_twin_state_and_all():
    case = GLA_CASES[2]
    arrays = _inputs(case, seed=3)
    o1, s1 = rops._xla_gla_scan(*map(jnp.asarray, arrays), normalize=True)
    o2, s2 = gs.gla_scan_plain(*map(_torch, arrays))
    np.testing.assert_allclose(o2.numpy(), np.asarray(o1), atol=2e-4)
    np.testing.assert_allclose(s2.numpy(), np.asarray(s1), atol=2e-3)


def test_wrapper_runs_the_plain_version_on_cpu():
    arrays = [_torch(a) for a in _inputs(GLA_CASES[0])]
    before = (gs.gla_scan.launches, gs.gla_scan_bwd.launches)
    want = gs.gla_scan_plain(*arrays)
    for got in (gs.gla_scan(*arrays), ops.gla_scan(*arrays)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (gs.gla_scan.launches, gs.gla_scan_bwd.launches) == before


def test_wrapper_contract_refusals():
    def t(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)

    q, v, g = t(1, 2, 8, 16), t(1, 2, 8, 32), t(1, 2, 8)
    with pytest.raises(ValueError, match="cpu or cuda"):
        gs.gla_scan(*(x.to("meta") for x in (q, q, v, g, g)))
    # what the kernels do not take is refused before any build or launch
    with pytest.raises(ValueError, match="dk=24"):
        gs._check_cuda(t(1, 2, 8, 24), t(1, 2, 8, 24), v, g, g, 128)
    with pytest.raises(ValueError, match="dk=400"):
        gs._check_cuda(t(1, 1, 8, 400), t(1, 1, 8, 400), t(1, 1, 8, 32),
                       t(1, 1, 8), t(1, 1, 8), 128)
    with pytest.raises(ValueError, match="dv=40"):
        gs._check_cuda(q, q, t(1, 2, 8, 40), g, g, 128)
    with pytest.raises(ValueError, match="chunks of at most"):
        gs._check_cuda(q, q, v, g, g, 256)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gs._check_cuda(q.half(), q.half(), v.half(), g, g, 128)
    with pytest.raises(TypeError, match="log_f and i_gate"):
        gs._check_cuda(q, q, v, g.double(), g, 128)
    with pytest.raises(ValueError, match="contiguous"):
        gs._check_cuda(t(1, 8, 2, 16).transpose(1, 2), q, v, g, g, 128)
    with pytest.raises(ValueError, match="do not match"):
        gs._check_cuda(q, q, v, t(1, 2, 9), g, 128)
    assert gs._check_cuda(q, q, v, g, g, 128) == (1, 2, 8, 16, 32, 8, 1)
    # a gradient on the final state (the decode caches) is refused
    with pytest.raises(NotImplementedError, match="Queue 1, item 14"):
        gs.GlaScanFn.backward(None, None, torch.zeros(1))


def test_cuda_call_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        q = torch.zeros((1, 2, 8, 16), device="cuda")
        gs.gla_scan(q, q, q, q[..., 0], q[..., 0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_kernels_vs_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip(CUDA_REASON)
    case = GLA_CASES[2]
    norm, chunk = case[5:]
    dev = torch.device("cuda")
    arrays = _inputs(case, dtype)
    ts = [_torch(a, dtype if i < 3 else "f32").to(dev).requires_grad_(True)
          for i, a in enumerate(arrays)]
    out, state = gs.gla_scan(*ts, norm, chunk)
    want, want_state = gs.gla_scan_plain(*ts, norm, chunk)
    np.testing.assert_allclose(out.float().detach().cpu().numpy(),
                               want.float().detach().cpu().numpy(),
                               atol=ATOL[dtype])
    np.testing.assert_allclose(state.cpu().numpy(),
                               want_state.detach().cpu().numpy(), atol=2e-3)
    g = torch.ones_like(out)
    for a, b in zip(torch.autograd.grad(out, ts, g),
                    torch.autograd.grad(want, ts, g)):
        scale = float(b.float().abs().max())
        tol = 1e-4 * scale if dtype == "f32" else 2e-2 * scale
        np.testing.assert_allclose(a.float().cpu().numpy(),
                                   b.float().cpu().numpy(), atol=tol)

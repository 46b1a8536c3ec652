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
the plain version there); their test here skips.  What the CPU can check
of them is their arithmetic: the f32 route's tiled backward
(``_tiled_backward``) and the bf16 route's chunk-parallel algorithm
(``_chunk_parallel``), exactly and with the kernels' bf16 roundings."""

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
# forget gates: the reference's draw, log_f = -|N(0, 1)| / 2, decays a
# 128-step chunk's state by ~e^-51, so every term that carries the state
# (or its gradient) across chunks is checked at ~1e-22 of its size; the
# weak draw, log_f = -|N(0, 1)| / 100, keeps ~e^-1 of it a chunk
DECAY = {"strong": 0.5, "weak": 0.01}
# weak-decay cases: three chunks or more, since <dC, C> is zero unless a
# chunk has both a state entering it and a gradient leaving it
WEAK_CASES = [(1, 2, 300, 16, 80, True, 128), (1, 2, 150, 16, 32, False, 64)]


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


def _inputs(case, dtype="f32", seed=0, decay="strong"):
    """Seeded numpy inputs as the reference's test draws them (log forget
    gates <= 0 scaled by ``DECAY[decay]``, input gates >= 0); q, k, v
    rounded to bf16 when asked so both packages see the same values."""
    B, H, T, dk, dv = case[:5]
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(B, H, T, dk)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(B, H, T, dv)).astype(np.float32)
    if dtype == "bf16":
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                   for a in (q, k, v))
    lf = (-np.abs(rng.normal(size=(B, H, T)) * DECAY[decay])).astype(
        np.float32)
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


# past one chunk: the per-step oracle's gradient is finite at any T, where
# the XLA twin's is NaN once a chunk's gates sum below -88 (ROADMAP Queue
# 3, F2); log_f = -|N(0, 1)| x 2 sums to ~-100 over a chunk of 64
DEEP_CASES = [(1, 2, 130, 16, 32, True, 128), (1, 2, 384, 16, 32, True, 128),
              (1, 2, 384, 32, 16, False, 64)]


@pytest.mark.parametrize("case", DEEP_CASES, ids=[str(c) for c in DEEP_CASES])
def test_plain_vs_jax_grad_of_the_per_step_oracle_past_one_chunk(case):
    """Outputs and all five gradients of the plain version against the
    per-step oracle ``repro.kernels.ref.gla_scan`` and ``jax.grad`` of it,
    at T past one chunk with gates summing below -88 inside a chunk, in
    f32: outputs within 2e-4 (the reference's f32 tolerance; the largest
    gap seen is 2.8e-5), gradients within 1e-4 x max|ref| (the largest gap
    seen is 6.1e-6 x max|ref|, float32 rounding of two summation orders)."""
    B, H, T, dk, dv, norm, chunk = case
    rng = np.random.default_rng(5)
    q, k = (rng.normal(size=(B, H, T, dk)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(B, H, T, dv)).astype(np.float32)
    lf = (-np.abs(rng.normal(size=(B, H, T))) * 2.0).astype(np.float32)
    ig = np.abs(rng.normal(size=(B, H, T))).astype(np.float32)
    sums = np.add.reduceat(lf, np.arange(0, T, chunk), axis=-1)
    assert sums.min() < -88  # what makes the XLA twin's gradient NaN
    g = rng.normal(size=(B, H, T, dv)).astype(np.float32)
    arrays = (q, k, v, lf, ig)

    def f(*a):
        return jnp.sum(ref.gla_scan(*a, normalize=norm) * g)

    jarr = [jnp.asarray(a) for a in arrays]
    want_out = np.asarray(ref.gla_scan(*jarr, normalize=norm))
    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(*jarr)
    ts = [_torch(a).requires_grad_(True) for a in arrays]
    out, _ = gs.gla_scan_plain(*ts, norm, chunk)
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=2e-4)
    got = torch.autograd.grad(out, ts, torch.from_numpy(g))
    for name, a, b in zip(("q", "k", "v", "log_f", "i_gate"), got, want):
        b = np.asarray(b)
        assert np.isfinite(b).all() and torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * np.abs(b).max(),
                                   err_msg=f"d{name}")


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
    """The backward of ``csrc/gla_scan.cu``'s f32 route written out in
    float64: value tiles of ``tile`` columns (tile 0 also carries the
    normalizer column) walk the chunks in reverse carrying their slice of
    dC, and dq, dk and the gate gradients are sums of the tiles'
    partials."""
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


TILED_CASES = GRAD_CASES + [(1, 2, 300, 16, 80, True, 128)]


def _with_weak(cases):
    """``(case, decay)`` parameters: ``cases`` at the reference's decay
    under their old ids, then ``WEAK_CASES`` at the weak one."""
    return pytest.mark.parametrize(
        "case,decay", [(c, "strong") for c in cases]
        + [(c, "weak") for c in WEAK_CASES],
        ids=[str(c) for c in cases] + [f"{c}-weak" for c in WEAK_CASES])


@_with_weak(TILED_CASES)
def test_the_kernels_tiled_backward_matches_autograd(case, decay):
    """The hand-derived backward the CUDA kernel implements (tiles,
    partials, normalizer column on tile 0), in float64, against autograd
    through the plain version (float32): within 1e-4 × max|autograd|."""
    norm, chunk = case[5:]
    arrays = _inputs(case, seed=4, decay=decay)
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


def _split(x):
    """An f32 operand as the bf16 kernels feed it to ``wgmma``: a pair of
    bf16 values, ``hi = bf16(x)`` and ``lo = bf16(x - hi)``."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _chunk_parallel(q, k, v, lf, ig, dout, normalize, chunk, rounded=False,
                    carry_grad=True):
    """The algorithm of the bf16 route of ``csrc/gla_scan.cu`` (namespace
    tc), written out per pass: forward, a state pass along the chunks
    (the state entering each chunk) and an output pass over all chunks at
    once; backward, a state-gradient pass in reverse and per-chunk
    gradients from a key side (rows s: dk, dv, di) and a query side (rows
    t: dq), whose gate terms a last pass adds and reverse-sums.  With
    ``rounded=False`` everything is float64.  With ``rounded=True`` it is
    float32 with the kernels' roundings: every product of an f32
    intermediate and a bf16 input takes the intermediate as a bf16 hi/lo
    pair (two products into one f32 sum); out, dq, dk and dv are rounded
    to bf16.  ``carry_grad=False`` drops exp(b_L) <dC, C> from db, as a
    gates kernel that forgot it would (a control).  Returns ``(out, state,
    (dq, dk, dv, dlog_f, di_gate))``."""
    dt = torch.float32 if rounded else torch.float64

    def mm(a, b, split):  # the operand named by ``split`` is an f32 value
        if not rounded:
            return a @ b
        if split == "a":
            return sum(x @ b for x in _split(a))
        return sum(a @ x for x in _split(b))

    def out_dtype(x):
        return x.to(torch.bfloat16).to(dt) if rounded else x

    B, H, T, dk = q.shape
    dv = v.shape[-1]
    L = min(chunk, T)
    nc = -(-T // L)
    pad = nc * L - T
    scale = dk**-0.5

    def P(x):
        x = torch.nn.functional.pad(x.to(dt), [0, 0] * (x.dim() - 3) + [0, pad])
        return x.reshape(x.shape[:2] + (nc, L) + x.shape[3:])

    qs, ks, vs, lfs, igs, dos = (P(x) for x in (q, k, v, lf, ig, dout))
    causal = torch.ones((L, L), dtype=torch.bool).tril()
    b = lfs.cumsum(-1)                                   # [B, H, nc, L]
    eb, bL = torch.exp(b), b[..., -1:]
    w = torch.exp(bL - b) * igs
    ebL = torch.exp(bL)[..., None]                      # [B, H, nc, 1, 1]
    ex = torch.where(causal, torch.exp(torch.where(
        causal, b[..., :, None] - b[..., None, :], 0.0)), 0.0)

    # state pass: C and the normalizer column n entering every chunk
    C = torch.zeros((B, H, dk, dv), dtype=dt)
    n = torch.zeros((B, H, dk), dtype=dt)
    Cs, ns = [], []
    for c in range(nc):
        Cs.append(C)
        ns.append(n)
        kw = ks[:, :, c] * w[:, :, c, :, None]
        C = ebL[:, :, c] * C + mm(kw.transpose(-1, -2), vs[:, :, c], "a")
        n = ebL[:, :, c, 0] * n + kw.sum(-2)
    state = torch.cat([C, n[..., None]], -1)
    Cs, ns = torch.stack(Cs, 2), torch.stack(ns, 2)     # [B, H, nc, dk, ...]

    # output pass, every chunk at once
    S = scale * (qs @ ks.transpose(-1, -2))
    A = S * ex * igs[..., None, :]
    num_n = A.sum(-1) + eb * scale * (qs @ ns[..., None])[..., 0]
    den = torch.clamp_min(num_n.abs(), 1.0) if normalize \
        else torch.ones_like(num_n)
    num = eb[..., None] * scale * mm(qs, Cs, "b") + mm(A, vs, "a")
    out = out_dtype(num / den[..., None])

    # backward: g, the gradient reaching the normalizer (prep kernel)
    g = -torch.sign(num_n) * (num_n.abs() > 1) / den * (dos * out).sum(-1) \
        if normalize else torch.zeros_like(num_n)
    # state-gradient pass: dC leaving every chunk, and <dC, C> per chunk
    dC = torch.zeros((B, H, dk, dv), dtype=dt)
    dn = torch.zeros((B, H, dk), dtype=dt)
    dCs, dns, dcc = [None] * nc, [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        dCs[c], dns[c] = dC, dn
        dcc[c] = (dC * Cs[:, :, c]).sum((-1, -2)) + (dn * ns[:, :, c]).sum(-1)
        dN = (scale * eb[:, :, c] / den[:, :, c])[..., None] * dos[:, :, c]
        dC = ebL[:, :, c] * dC + mm(qs[:, :, c].transpose(-1, -2), dN, "b")
        dn = ebL[:, :, c, 0] * dn + (scale * eb[:, :, c] * g[:, :, c])[
            ..., None].mul(qs[:, :, c]).sum(-2)
    dCs, dns, dcc = torch.stack(dCs, 2), torch.stack(dns, 2), torch.stack(dcc, 2)

    dA = (dos @ vs.transpose(-1, -2)) / den[..., None] + g[..., None]
    dS = dA * ex * igs[..., None, :]
    E = dA * S * ex
    # key side (rows s)
    colE = E.sum(-2)
    dv_ = mm((A / den[..., None]).transpose(-1, -2), dos, "a") \
        + w[..., None] * mm(ks, dCs, "b")
    u = mm(vs, dCs.transpose(-1, -2), "b") + dns[..., None, :]
    dw = (ks * u).sum(-1)
    dk_ = w[..., None] * u + mm((scale * dS).transpose(-1, -2), qs, "a")
    di = colE + dw * torch.exp(bL - b)
    # query side (rows t)
    r = mm(dos, Cs.transpose(-1, -2), "b") / den[..., None] \
        + g[..., None] * ns[..., None, :]
    dbq = (E * igs[..., None, :]).sum(-1) + eb * scale * (qs * r).sum(-1)
    dq = scale * (mm(dS, ks, "a") + eb[..., None] * r)
    # gates: db, then dlog_f as its reverse cumulative sum in the chunk
    db = dbq - igs * colE - dw * w
    db[..., -1] += ebL[..., 0, 0] * dcc * carry_grad + (dw * w).sum(-1)
    dlf = db.flip(-1).cumsum(-1).flip(-1)

    def unP(x):
        return x.reshape(x.shape[:2] + (nc * L,) + x.shape[4:])[:, :, :T]

    grads = (out_dtype(dq), out_dtype(dk_), out_dtype(dv_), dlf, di)
    return unP(out), state, tuple(unP(x) for x in grads)


CP_CASES = GRAD_CASES + [(1, 2, 300, 16, 80, True, 128),
                         (1, 1, 70, 48, 32, True, 128)]


@_with_weak(CP_CASES)
def test_chunk_parallel_algorithm_matches_plain_and_autograd(case, decay):
    """The bf16 route's chunk-parallel algorithm in float64 against the
    plain version (output and state 1e-4) and autograd through it (all
    five gradients within 1e-4 × max|autograd|), float32 both."""
    norm, chunk = case[5:]
    arrays = _inputs(case, seed=6, decay=decay)
    ts = [_torch(a).requires_grad_(True) for a in arrays]
    out, state = gs.gla_scan_plain(*ts, norm, chunk)
    dout = torch.from_numpy(np.random.default_rng(7).normal(
        size=out.shape).astype(np.float32))
    want = torch.autograd.grad(out, ts, dout)
    got_out, got_state, got = _chunk_parallel(
        *(t.detach().double() for t in ts), dout.double(), norm, chunk)
    np.testing.assert_allclose(got_out.numpy(), out.detach().double().numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(got_state.numpy(), state.detach().double().numpy(),
                               atol=1e-4)
    for name, a, b in zip(("q", "k", "v", "log_f", "i_gate"), got, want):
        np.testing.assert_allclose(a.numpy(), b.double().numpy(),
                                   atol=1e-4 * float(b.abs().max()),
                                   err_msg=f"d{name}")


def _card_inputs(case, seed, decay="strong"):
    """Inputs drawn as ``chip_smoke.gla_inputs`` draws them: a torch
    generator, q, k, v rounded to bf16, log_f = -|N(0, 1)| x
    ``DECAY[decay]``, i = |N(0, 1)|; then dout in bf16."""
    B, H, T, dk, dv = case[:5]
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    ins = [r(B, H, T, dk).bfloat16(), r(B, H, T, dk).bfloat16(),
           r(B, H, T, dv).bfloat16(), -(r(B, H, T) * DECAY[decay]).abs(),
           r(B, H, T).abs()]
    return ins, r(B, H, T, dv).bfloat16()


XLSTM_WEAK = (1, 2, 384, 384, 384, True, 128)


@pytest.mark.parametrize("case,decay", [
    ((1, 2, 256, 384, 384, True, 128), "strong"),
    ((1, 2, 256, 384, 384, False, 128), "strong"),
    ((2, 3, 300, 16, 64, False, 128), "strong"),
    (XLSTM_WEAK, "weak")], ids=["xlstm-widths", "xlstm-widths-ssd",
                                "hymba-widths", "xlstm-widths-weak-decay"])
def test_bf16_kernel_roundings_meet_the_card_limits(case, decay):
    """The bf16 route's arithmetic, roundings and all, at the model widths
    (xlstm-125m dk = dv = 384, two chunks, and three at the weak decay,
    where the state and its gradient carry across chunks; hymba-1.5b's SSD
    heads), held to ``chip_smoke.py``'s limits against the plain version
    on the same bf16 inputs: output 6e-2 + 2^-8 |out| of its f32 result
    (the bf16 rounding of the output is at most half an ulp, at most 2^-8
    |out|), state 2e-3, gradients 2e-2 × max|plain|; the state and the
    gradients also with a margin, under half their limits, so that the
    card's other summation order has room (one ulp of dq's largest element
    is already ~0.2 of the gradients' limit)."""
    norm, chunk = case[5:]
    ins, dout = _card_inputs(case, seed=2, decay=decay)
    leaves = [x.clone().requires_grad_(True) for x in ins]
    want, want_state = gs.gla_scan_plain(*leaves, norm, chunk)
    refs = torch.autograd.grad(want, leaves, dout)
    out, state, grads = _chunk_parallel(*(x.float() for x in ins),
                                        dout.float(), norm, chunk,
                                        rounded=True)
    want = gs.gla_scan_plain(*(x.float() for x in ins), norm, chunk)[0]
    diff = (out - want).abs()
    assert bool((diff <= 6e-2 + 2.0**-8 * want.abs()).all()), \
        float(diff.max())
    assert float((state - want_state.detach()).abs().max()) <= 2e-3 / 2
    for name, a, b in zip(("q", "k", "v", "log_f", "i_gate"), grads, refs):
        err = float((a - b.float()).abs().max())
        assert err <= 2e-2 / 2 * float(b.float().abs().max()), (name, err)


def test_one_bf16_rounding_of_the_state_update_breaks_the_state_limit(
        monkeypatch):
    """The control of the test above: the same emulation with every f32
    operand rounded to bf16 once (no lo part) puts the final state past
    its 2e-3 limit at the xlstm-125m widths, which is why the kernels feed
    f32 operands as hi/lo pairs."""
    case = (1, 2, 256, 384, 384, True, 128)
    ins, dout = _card_inputs(case, seed=2)
    _, want_state = gs.gla_scan_plain(*ins, True, 128)
    monkeypatch.setitem(globals(), "_split", lambda x: (
        x.to(torch.bfloat16).float(), torch.zeros_like(x)))
    _, state, _ = _chunk_parallel(*(x.float() for x in ins), dout.float(),
                                  True, 128, rounded=True)
    assert float((state - want_state).abs().max()) > 2e-3


@pytest.mark.parametrize("decay", ["strong", "weak"])
def test_dropping_the_carried_gradient_fails_only_the_weak_decay(decay):
    """The control of the weak-decay case: the rounding emulation with
    exp(b_L) <dC, C> left out of db (a gates kernel that dropped the
    state-gradient pass's partials) puts dlog_f past its 2e-2 × max|plain|
    limit at the xlstm-125m widths under the weak decay, and passes
    unnoticed under the reference's, where the term is ~1e-22 of its
    size: the strong draw alone cannot check the carried terms."""
    norm, chunk = XLSTM_WEAK[5:]
    ins, dout = _card_inputs(XLSTM_WEAK, seed=2, decay=decay)
    lf = ins[3].clone().requires_grad_(True)
    want, _ = gs.gla_scan_plain(*ins[:3], lf, ins[4], norm, chunk)
    (ref,) = torch.autograd.grad(want, [lf], dout)
    _, _, grads = _chunk_parallel(*(x.float() for x in ins), dout.float(),
                                  norm, chunk, rounded=True, carry_grad=False)
    err = float((grads[3] - ref).abs().max()) / float(ref.abs().max())
    assert (err > 2e-2) == (decay == "weak"), err


def test_backward_checks_the_saved_tensors_of_its_route():
    """``gla_scan_bwd`` takes the forward's ``saved`` tuple and refuses,
    before any build or launch, tensors that are not what its route's
    forward saves: panel pairs on the bf16 route, f32 states on the f32
    route, and a missing normalizer."""
    bf, f32 = torch.bfloat16, torch.float32
    B, H, T, dk, dv = 1, 2, 8, 16, 32
    q, v = torch.zeros((B, H, T, dk), dtype=bf), torch.zeros((B, H, T, dv),
                                                             dtype=bf)
    g = torch.zeros((B, H, T))
    tiles = torch.zeros((B * H, 1, 1, 1, 2, gs.TC_TILE, gs.TC_TILE), dtype=bf)
    tiles_n, norms = torch.zeros((B * H, 1, dk)), torch.zeros((B, H, T))
    args = (q, q, v, g, g, v, v)
    before = (gs.gla_scan.launches, gs.gla_scan_bwd.launches)
    with pytest.raises(ValueError, match="tiles must be"):
        gs.gla_scan_bwd(*args, (tiles[:, :, :, :, :1], tiles_n, norms))
    with pytest.raises(ValueError, match="tiles_n must be"):
        gs.gla_scan_bwd(*args, (tiles, tiles_n.double(), norms))
    with pytest.raises(ValueError, match="norms must be"):
        gs.gla_scan_bwd(*args, (tiles, tiles_n, None))
    states = torch.zeros((B, H, 1, dk, dv + 1), dtype=f32)
    f_args = (q.float(), q.float(), v.float(), g, g, v.float(), v.float())
    with pytest.raises(ValueError, match="states must be"):
        gs.gla_scan_bwd(*f_args, (states[..., :dv], norms))
    assert (gs.gla_scan.launches, gs.gla_scan_bwd.launches) == before

"""The port's flash attention against the JAX package: its plain version
against the Pallas kernel in interpret mode and against the naive oracle
``repro.kernels.ref.attention`` over the reference's sweep (``ATT_CASES``
of tests/test_kernels.py) and the head widths the configs reach beyond it
(d 80; d 192 with dv 128; d 48 with dv 32) in f32 and bf16, at the
reference's tolerances;
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
from repro_torch import configs  # noqa: E402
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
    # beyond the reference's sweep, a 10th entry dv (the v width): the
    # widths the configs reach at published or reduced size
    (1, 2, 2, 160, 160, 80, False, 0, 0, 80),    # hubert-xlarge, bidirectional
    (1, 4, 2, 128, 128, 192, True, 0, 0, 128),   # deepseek-v2 MLA, GQA
    (2, 2, 1, 100, 100, 48, True, 0, 0, 32),     # reduced MLA, ragged T
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


def _dv(case):
    """The v width of a case: its 10th entry, else d."""
    return case[9] if len(case) > 9 else case[5]


def _round(arrays, dtype):
    if dtype == "bf16":
        return [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                for a in arrays]
    return arrays


def _inputs(case, dtype, seed=0):
    """Seeded numpy inputs, rounded to bf16 when asked (so both packages
    see the same values).  Returns (q, k, v) as numpy f32 arrays."""
    B, Hq, Hkv, T, S, d = case[:6]
    rng = np.random.default_rng(seed)
    return _round([rng.normal(size=s).astype(np.float32)
                   for s in ((B, Hq, T, d), (B, Hkv, S, d),
                             (B, Hkv, S, _dv(case)))], dtype)


def _dout(case, dtype, seed):
    """A seeded output gradient ``[B, Hq, T, dv]``."""
    B, Hq, _, T = case[:4]
    rng = np.random.default_rng(seed)
    return _round([rng.normal(size=(B, Hq, T, _dv(case))).astype(np.float32)],
                  dtype)[0]


def _torch(a, dtype):
    t = torch.from_numpy(a.copy())
    return t.to(torch.bfloat16) if dtype == "bf16" else t


def _jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bf16" else jnp.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", ATT_CASES, ids=IDS)
def test_plain_vs_pallas_interpret_and_oracle(case, dtype):
    causal, window, off = case[6:9]
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
    causal, window, off = case[6:9]
    q, k, v = _inputs(case, "f32", seed=1)
    g = _dout(case, "f32", seed=2)

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
    wide = (torch.from_numpy(a) for a in _inputs(ATT_CASES[8], "f32"))
    assert fa.flash_attention(*wide).shape == (1, 4, 128, 128)  # dv
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
    # what the kernel does not take is refused before any build or launch:
    # a (d, dv) pair outside SHAPES, and a v whose width is not the pair's
    w96 = torch.zeros((1, 2, 4, 96))
    with pytest.raises(ValueError, match="SHAPES"):
        fa._check_cuda(w96, w96, w96, 0, 0)
    w80, w128 = torch.zeros((1, 2, 4, 80)), torch.zeros((1, 2, 4, 128))
    with pytest.raises(ValueError, match="SHAPES"):
        fa._check_cuda(w80, w80, w128, 0, 0)
    assert fa._check_cuda(w80, w80, w80, 0, 0)[-2:] == (80, 80)
    w192 = torch.zeros((1, 2, 4, 192))
    assert fa._check_cuda(w192, w192, w128, 0, 0)[-2:] == (192, 128)
    with pytest.raises(ValueError, match="do not match"):
        fa._check_cuda(w192, w128, w128, 0, 0)
    with pytest.raises(ValueError, match="static q_offset"):
        fa._check_cuda(q, q, q, 0, -1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa._check_cuda(q.half(), q.half(), q.half(), 0, 0)


def test_bf16_base_address_off_16_bytes_is_refused():
    """The bf16 kernels read by TMA, which needs 16-byte base addresses: a
    contiguous view that starts one element into its storage is refused
    before any build or launch."""
    q = torch.zeros(2 * 4 * 16 + 1, dtype=torch.bfloat16)[1:].view(1, 2, 4, 16)
    ok = torch.zeros((1, 2, 4, 16), dtype=torch.bfloat16)
    assert q.is_contiguous() and q.data_ptr() % 16
    fa._check_cuda(ok, ok, ok, 0, 0)
    with pytest.raises(ValueError, match="16-byte boundary"):
        fa._check_cuda(q, ok, ok, 0, 0)
    with pytest.raises(ValueError, match="16-byte boundary"):
        fa._check_cuda(ok, ok, q, 0, 0)


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
    causal, window, off = case[6:9]
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


# ---------------------------------------------------------------------------
# CPU emulation of the bf16 tensor-core kernels (csrc/flash_attention.cu,
# namespace tc): their tiles, skip ranges, column panels, f32 statistics in
# log2 units, and their rounding points (P to bf16 before P.V, dS to bf16
# before the dK and dQ products), held against the Pallas kernel, the
# oracle and jax.grad of the oracle at the card's tolerances.
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
EMU_CASES = ATT_CASES + [(2, 4, 2, 100, 100, 16, True, 0, 0)]
EMU_IDS = [str(c) for c in EMU_CASES]
# the forward and the dq kernel: 64 q rows a block, kv tiles of 64 keys;
# the dk/dv kernel: 64 keys a block, q tiles of dkv_bq(d) rows
BM, BK, DKV_BN = 64, 64, 64


def dkv_bq(d, dv):
    """q rows per tile of the dK/dV kernel."""
    return 64 if d <= 64 and dv <= 64 else 32


def panels(w):
    """``Panels<W>`` of csrc/hopper.cuh: the column panels ``(c0, width)``
    of a width-w tile, 64-column panels first, then at most one of 32 and
    one of 16."""
    out = [(c, 64) for c in range(0, w - w % 64, 64)]
    if w % 64 >= 32:
        out.append((w - w % 64, 32))
    if w % 32 == 16:
        out.append((w - 16, 16))
    return out


def panel_runs(w):
    """The output products ``rs_panels`` issues over a width-w tile: one
    over the run of 64-column panels, one for a 32- and one for a
    16-column panel, as ``(c0, n)`` column ranges."""
    p = panels(w)
    runs = [(0, 64 * sum(1 for _, pw in p if pw == 64))] if w >= 64 else []
    return runs + [(c0, pw) for c0, pw in p if pw < 64]


def by_panels(a, b):
    """``a @ b.T`` reduced along the width as the kernels reduce it: each
    panel's k16 steps, the panels' sums added in panel order (S = Q K^T,
    dP = dO V^T)."""
    out = 0
    for c0, pw in panels(a.shape[-1]):
        out = out + torch.matmul(a[..., c0:c0 + pw],
                                 b[..., c0:c0 + pw].transpose(-1, -2))
    return out


def into_panels(p, b):
    """``p @ b`` with its output columns issued as ``rs_panels`` issues
    them: one product per run, each into its own columns."""
    return torch.cat([torch.matmul(p, b[..., c0:c0 + n])
                      for c0, n in panel_runs(b.shape[-1])], dim=-1)


def kv_tiles(q_first, q_last, tile, S, causal, window):
    """``Mask::kv_tiles``: [lo, hi) kv tiles holding a key that some q
    position in [q_first, q_last] sees."""
    k_max = min(S - 1, q_last) if causal else S - 1
    k_min = max(0, q_first - window + 1) if window else 0
    if k_max < k_min:
        return 0, 0
    return k_min // tile, k_max // tile + 1


def q_rows(k_first, k_last, T, causal, window, off):
    """``Mask::q_rows``: [lo, hi) q rows that see a key in [k_first,
    k_last]."""
    a = max(0, k_first - off) if causal else 0
    b = min(T, k_last + window - off) if window else T
    return a, max(a, b)


def q_tiles(k0, S, T, bq, causal, window, off):
    """The dK/dV kernel's q tiles (aligned to ``bq``) for keys [k0, k0+64)."""
    lo, hi = q_rows(k0, min(S, k0 + DKV_BN) - 1, T, causal, window, off)
    return range(lo // bq, -(-hi // bq) if hi > lo else lo // bq)


def tile_full(q_first, q_last, k_first, k_last, S, causal, window):
    """``tile_full``: every valid q row of the tile sees every key."""
    full = k_last < S
    if causal:
        full = full and k_last <= q_first
    if window:
        full = full and k_first > q_last - window
    return full


def _visible(qpos, kpos, S, causal, window):
    ok = kpos < S
    if causal:
        ok = ok & (kpos <= qpos)
    if window:
        ok = ok & (kpos > qpos - window)
    return ok


def _bf16(x):
    return x.to(torch.bfloat16).float()


def emulate_fwd(q, k, v, causal, window, off):
    """The bf16 forward kernel's arithmetic → (out bf16, lse f32)."""
    B, Hq, T, d = q.shape
    Hkv, S, dv = k.shape[1], k.shape[2], v.shape[3]
    group = Hq // Hkv
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(group, 1) for t in (k, v))
    sl2 = torch.tensor(d**-0.5, dtype=torch.float32) * LOG2E
    out = torch.zeros((B, Hq, T, dv))
    lse = torch.zeros((B, Hq, T))
    bk = BK
    for q0 in range(0, T, BM):
        rows = min(T, q0 + BM) - q0
        q_first, q_last = off + q0, off + q0 + rows - 1
        qpos = torch.arange(q_first, q_last + 1)[:, None]
        m = torch.full((B, Hq, rows), -1e30)
        l = torch.zeros((B, Hq, rows))
        acc = torch.zeros((B, Hq, rows, dv))
        for t in range(*kv_tiles(q_first, q_last, bk, S, causal, window)):
            k0 = t * bk
            kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
            x = by_panels(qf[:, :, q0:q0 + rows], kt) * sl2
            vis = _visible(qpos, torch.arange(k0, k0 + kt.shape[2])[None],
                           S, causal, window)
            if tile_full(q_first, q_last, k0, k0 + bk - 1, S, causal, window):
                assert bool(vis.all())
            else:
                x = torch.where(vis, x, torch.tensor(-torch.inf))
            mx = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - mx)
            m = mx
            p = torch.exp2(x - m[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + into_panels(_bf16(p), vt)
        out[:, :, q0:q0 + rows] = acc / torch.clamp_min(l, 1e-30)[..., None]
        lse[:, :, q0:q0 + rows] = torch.where(l > 0, m * LN2 + torch.log(l),
                                              torch.zeros_like(l))
    return out.to(torch.bfloat16), lse


def emulate_bwd(q, k, v, out, dout, lse, causal, window, off):
    """The bf16 backward kernels' arithmetic → (dq, dk, dv) in bf16."""
    B, Hq, T, d = q.shape
    Hkv, S, dv = k.shape[1], k.shape[2], v.shape[3]
    group = Hq // Hkv
    scale = torch.tensor(d**-0.5, dtype=torch.float32)
    sl2 = scale * LOG2E
    qf, gf = q.float(), dout.float()
    delta = (gf * out.float()).sum(-1)
    lse2 = lse * LOG2E
    # dq: one block per 64 q rows, kv tiles of 64 in order
    kx, vx = (t.float().repeat_interleave(group, 1) for t in (k, v))
    dq = torch.zeros((B, Hq, T, d))
    for q0 in range(0, T, BM):
        rows = min(T, q0 + BM) - q0
        q_first, q_last = off + q0, off + q0 + rows - 1
        qpos = torch.arange(q_first, q_last + 1)[:, None]
        sl = slice(q0, q0 + rows)
        acc = torch.zeros((B, Hq, rows, d))
        for t in range(*kv_tiles(q_first, q_last, BK, S, causal, window)):
            k0 = t * BK
            kt, vt = kx[:, :, k0:k0 + BK], vx[:, :, k0:k0 + BK]
            x = by_panels(qf[:, :, sl], kt)
            dp = by_panels(gf[:, :, sl], vt)
            p = torch.exp2(x * sl2 - lse2[:, :, sl, None])
            if not tile_full(q_first, q_last, k0, k0 + BK - 1, S, causal,
                             window):
                vis = _visible(qpos, torch.arange(k0, k0 + kt.shape[2])[None],
                               S, causal, window)
                p = torch.where(vis, p, torch.zeros_like(p))
            ds = p * (dp - delta[:, :, sl, None])
            acc = acc + into_panels(_bf16(ds), kt)
        dq[:, :, sl] = acc * scale
    # dk, dv: one block per 64 keys; the group's heads, then each head's
    # visible q tiles, in order
    bq = dkv_bq(d, dv)
    kf, vf = k.float(), v.float()
    qg = qf.view(B, Hkv, group, T, d)
    gg = gf.view(B, Hkv, group, T, dv)
    lg, dg = (t.view(B, Hkv, group, T) for t in (lse2, delta))
    dk, dvv = torch.zeros((B, Hkv, S, d)), torch.zeros((B, Hkv, S, dv))
    for k0 in range(0, S, DKV_BN):
        keys = min(S, k0 + DKV_BN) - k0
        kt, vt = kf[:, :, k0:k0 + keys], vf[:, :, k0:k0 + keys]
        kpos = torch.arange(k0, k0 + keys)[:, None]
        gk = torch.zeros((B, Hkv, keys, d))
        gv = torch.zeros((B, Hkv, keys, dv))
        for g in range(group):
            for tq in q_tiles(k0, S, T, bq, causal, window, off):
                t0 = tq * bq
                sl = slice(t0, min(T, t0 + bq))
                qt, gt = qg[:, :, g, sl], gg[:, :, g, sl]
                x = by_panels(kt, qt)
                p = torch.exp2(x * sl2 - lg[:, :, g, None, sl])
                if not (t0 + bq <= T and tile_full(
                        off + t0, off + t0 + bq - 1, k0, k0 + DKV_BN - 1, S,
                        causal, window)):
                    qpos = off + torch.arange(t0, t0 + qt.shape[2])[None]
                    p = torch.where(_visible(qpos, kpos, S, causal, window),
                                    p, torch.zeros_like(p))
                dpt = by_panels(vt, gt)
                dst = p * (dpt - dg[:, :, g, None, sl])
                gv = gv + into_panels(_bf16(p), gt)
                gk = gk + into_panels(_bf16(dst), qt)
        dk[:, :, k0:k0 + keys] = gk * scale
        dvv[:, :, k0:k0 + keys] = gv
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dvv))


@pytest.mark.parametrize("case", EMU_CASES, ids=EMU_IDS)
def test_bf16_kernel_emulation_vs_pallas_and_oracle(case):
    causal, window, off = case[6:9]
    q, k, v = _inputs(case, "bf16")
    got, lse = emulate_fwd(*(_torch(a, "bf16") for a in (q, k, v)), causal,
                           window, off)
    assert got.dtype == torch.bfloat16 and lse.shape == got.shape[:3]
    got = got.float().numpy()
    jq, jk, jv = (_jax(a, "bf16") for a in (q, k, v))
    pallas = fa_pallas(jq, jk, jv, causal=causal, window=window, q_offset=off,
                       interpret=True)
    oracle = ref.attention(jq, jk, jv, causal=causal, window=window,
                           q_offset=off)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=ATOL["bf16"])


@pytest.mark.parametrize("case", EMU_CASES, ids=EMU_IDS)
def test_bf16_kernel_emulation_gradients_vs_jax_grad(case):
    causal, window, off = case[6:9]
    q, k, v = _inputs(case, "bf16", seed=1)
    g = _dout(case, "bf16", seed=2)

    def f(q_, k_, v_):
        out = ref.attention(q_, k_, v_, causal=causal, window=window,
                            q_offset=off)
        return jnp.sum(out * g)

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv, tg = (_torch(a, "bf16") for a in (q, k, v, g))
    out, lse = emulate_fwd(tq, tk, tv, causal, window, off)
    got = emulate_bwd(tq, tk, tv, out, tg, lse, causal, window, off)
    for name, a, b in zip("qkv", got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.float().numpy(), b,
                                   atol=2e-2 * float(np.abs(b).max()),
                                   err_msg=f"d{name}")


def _tile_sweep():
    shapes = {(c[3], c[4], c[6], c[7], c[8]) for c in EMU_CASES}
    for T in (1, 63, 64, 65, 130):
        for S in (1, 64, 100, 129, 300):
            for off in (0, 1, 64, 200):
                for window in (0, 1, 17, 64, 100):
                    for causal in (True, False):
                        shapes.add((T, S, causal, window, off))
    return sorted(shapes)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_tile_ranges_vs_element_mask(d):
    """Every tile the kernels skip holds no visible (q, k) pair; every
    kept range is tight; every tile classed full is visible whole.

    ``kv_tiles``, ``q_rows``, ``q_tiles`` and ``tile_full`` above are
    copies of ``Mask::kv_tiles``, ``Mask::q_rows``, ``Mask::q_tiles`` and
    ``Mask::tile_full`` in ``csrc/flash_attention.cu`` and must be kept in
    step with them.  The C++ functions themselves are held against the
    same element mask on the card: ``chip_smoke.py``'s
    ``check_tile_plan`` runs them through ``flash_attention.tile_plan``."""
    for T, S, causal, window, off in _tile_sweep():
        vis = np.broadcast_to(_visible(off + np.arange(T)[:, None],
                                       np.arange(S)[None], S, causal, window),
                              (T, S))
        # forward and dq: kv tiles of each q block
        for q0 in range(0, T, BM):
            rows = vis[q0:q0 + BM]
            q_first, q_last = off + q0, off + q0 + rows.shape[0] - 1
            lo, hi = kv_tiles(q_first, q_last, BK, S, causal, window)
            need = np.flatnonzero(rows.any(0)) // BK
            assert (lo, hi) == ((need.min(), need.max() + 1) if need.size
                                else (0, 0)), (T, S, causal, window, off)
            for t in range(lo, hi):
                if tile_full(q_first, q_last, t * BK, t * BK + BK - 1, S,
                             causal, window):
                    assert rows[:, t * BK:t * BK + BK].all()
                    assert t * BK + BK <= S
        # dk/dv: q tiles of each key block
        bq = dkv_bq(d, d)
        for k0 in range(0, S, DKV_BN):
            cols = vis[:, k0:k0 + DKV_BN]
            tiles = q_tiles(k0, S, T, bq, causal, window, off)
            need = np.flatnonzero(cols.any(1))
            assert set(need // bq) <= set(tiles), (T, S, causal, window, off)
            lo, hi = q_rows(k0, min(S, k0 + DKV_BN) - 1, T, causal, window,
                            off)
            assert (lo, hi) == ((need.min(), need.max() + 1) if need.size
                                else (lo, lo)), (T, S, causal, window, off)
            for t in tiles:
                t0 = t * bq
                if t0 + bq <= T and tile_full(off + t0, off + t0 + bq - 1, k0,
                                              k0 + DKV_BN - 1, S, causal,
                                              window):
                    assert cols[t0:t0 + bq].all() and k0 + DKV_BN <= S


WIDTHS = sorted({w for pair in fa.SHAPES for w in pair})


@pytest.mark.parametrize("w", WIDTHS)
def test_panels_cover_the_width_and_start_on_their_swizzle(w):
    """``Panels<W>``: the panels tile [0, w) in order, 64-column ones
    first, then at most one of 32 and one of 16; in a tile of 32 or 64 rows
    (the kernels' q and kv tiles) each starts on the repeat of its swizzle
    (8 rows of its row bytes: 1024, 512 or 256 bytes) and every tile of one
    width is a whole number of 1024-byte swizzle repeats, so the tiles of a
    stage stay aligned; a k16 step never straddles two panels; and the
    panelled products equal the plain ones."""
    p = panels(w)
    assert [c0 for c0, _ in p] == list(np.cumsum([0] + [pw for _, pw in p]))[:-1]
    assert sum(pw for _, pw in p) == w
    widths = [pw for _, pw in p]
    assert widths == sorted(widths, reverse=True) and widths.count(32) <= 1 \
        and widths.count(16) <= 1 and set(widths) <= {16, 32, 64}
    for rows in (32, 64):
        assert rows * w * 2 % 1024 == 0
        for c0, pw in p:
            assert (rows * 2 * c0) % (8 * pw * 2) == 0, (rows, c0, pw)
    for k in range(w // 16):
        assert any(c0 <= 16 * k and 16 * k + 16 <= c0 + pw for c0, pw in p)
    runs = panel_runs(w)
    assert sum(n for _, n in runs) == w and all(n % 8 == 0 for _, n in runs)
    rng = np.random.default_rng(w)
    a, b = (torch.from_numpy(rng.normal(size=(3, 40, w)).astype(np.float32))
            for _ in range(2))
    torch.testing.assert_close(by_panels(a, b), a @ b.transpose(-1, -2),
                               rtol=1e-5, atol=1e-4)
    pm = torch.from_numpy(rng.normal(size=(3, 24, 40)).astype(np.float32))
    torch.testing.assert_close(into_panels(pm, b), pm @ b, rtol=0, atol=0)


def _flash_widths(cfg):
    """The (d, dv) a config passes to flash attention: none for the ssm
    family; MLA's q/k carry qk_nope + qk_rope columns against v_dim."""
    if not cfg.has_attention:
        return set()
    if cfg.mla is not None:
        return {(cfg.mla.qk_nope + cfg.mla.qk_rope, cfg.mla.v_dim)}
    return {(cfg.hd, cfg.hd)}


def test_every_config_reaches_only_compiled_shapes():
    """Every (d, dv) that a config of ``repro_torch.configs`` passes to
    flash attention, at published and reduced size, is one the kernels
    are compiled for; and every compiled pair but the smallest is reached
    by some config or the reference's sweep."""
    reached = set()
    for arch in configs.ARCH_IDS:
        for cfg in (configs.get(arch), configs.get_reduced(arch)):
            shapes = _flash_widths(cfg)
            assert shapes <= set(fa.SHAPES), (cfg.name, shapes)
            reached |= shapes
    assert {(80, 80), (192, 128), (48, 32)} <= reached
    swept = {(c[5], _dv(c)) for c in EMU_CASES}
    assert set(fa.SHAPES) - {(16, 16)} <= reached | swept

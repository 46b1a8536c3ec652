"""The port's int8 quantizers against the JAX package's Pallas kernels in
interpret mode and its ``repro.kernels.ref`` oracles, with the sweep and
bounds of tests/test_kernels.py: blockwise bit-exact in f32, |Δq| ≤ 1 on
under 1% of entries in bf16, scales within rtol 1e-6, the round-trip bound,
exact zero blocks; per-(page, head) bit-exact on the reference's page
shapes (tests/test_kernels.py:351) and the zoo's head widths in f32 and
bf16, zero pages and half-step ties exact.  How the page kernels cut a pool
(``page_plan``) and the index arithmetic of their loops (each unit of a
(page, head) visited once, the dequantize walk's carried digits) are
checked here in Python.  The CUDA kernels run only on the card
(``chip_smoke.py`` holds them bit-exact against the plain versions there);
their tests here skip."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.quantize import dequantize_blockwise as dq_pallas  # noqa: E402
from repro.kernels.quantize import dequantize_page as dqp_pallas  # noqa: E402
from repro.kernels.quantize import quantize_blockwise as q_pallas  # noqa: E402
from repro.kernels.quantize import quantize_page as qp_pallas  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quantize as qz  # noqa: E402

SWEEP = [(8, 1024, 256), (3, 512, 128), (16, 4096, 256), (1, 256, 256)]
PAGE_SHAPES = [(6, 8, 2, 16), (3, 4, 4, 8)]  # tests/test_kernels.py:351
# head widths of the zoo (48, 80, 192), one- and 16-token pages, 1 to 8
# heads, odd page counts
PAGE_SWEEP = [(3, 1, 1, 48), (5, 16, 8, 80), (3, 16, 1, 192), (7, 1, 8, 192),
              (5, 16, 4, 48)]
CUDA_REASON = "needs an NVIDIA GPU; chip_smoke.py covers it"


@pytest.fixture(autouse=True, scope="module")
def _torch_settings():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(R, N, dtype, seed=0):
    a = np.random.default_rng(seed).normal(size=(R, N)).astype(np.float32)
    if dtype == "bf16":
        a = np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    return a


def _both(a, dtype):
    if dtype == "bf16":
        return torch.from_numpy(a.copy()).to(torch.bfloat16), jnp.asarray(a, jnp.bfloat16)
    return torch.from_numpy(a.copy()), jnp.asarray(a)


@pytest.mark.parametrize("R,N,block", SWEEP)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_vs_pallas_interpret(R, N, block, dtype):
    a = _x(R, N, dtype)
    xt, xj = _both(a, dtype)
    q1, s1 = qz.quantize_blockwise_plain(xt, block)
    q2, s2 = q_pallas(xj, block=block, interpret=True)
    assert q1.dtype == torch.int8 and s1.dtype == torch.float32
    dq = np.abs(q1.numpy().astype(np.int32) - np.asarray(q2, np.int32))
    if dtype == "f32":
        assert (dq == 0).all()
    else:  # tests/test_kernels.py: a 1-ULP scale difference at a tie
        assert dq.max() <= 1 and (dq != 0).mean() < 1e-2
    np.testing.assert_allclose(s1.numpy(), np.asarray(s2), rtol=1e-6)
    d1 = qz.dequantize_blockwise_plain(q1, s1, block).numpy()
    d2 = np.asarray(dq_pallas(q2, s2, block=block, interpret=True))
    np.testing.assert_allclose(d1, d2, atol=float(np.asarray(s2).max()) * 1.01)
    # round-trip error bound: half an int8 step per block
    xf = a.reshape(R, N // block, block)
    bound = np.abs(xf).max(-1, keepdims=True) / 127.0 * 0.5 + 1e-7
    err = np.abs(d1.reshape(xf.shape) - xf)
    assert (err <= bound + 1e-6).all()


@pytest.mark.parametrize("R,N,block", SWEEP)
def test_plain_is_bit_exact_with_the_oracle_f32(R, N, block):
    a = _x(R, N, "f32", seed=3) * 5
    q1, s1 = qz.quantize_blockwise_plain(torch.from_numpy(a), block)
    q2, s2 = ref.quantize_blockwise(jnp.asarray(a), block)
    np.testing.assert_array_equal(q1.numpy(), np.asarray(q2))
    np.testing.assert_array_equal(s1.numpy(), np.asarray(s2))
    d1 = qz.dequantize_blockwise_plain(q1, s1, block)
    np.testing.assert_array_equal(
        d1.numpy(), np.asarray(ref.dequantize_blockwise(q2, s2, block)))


def test_half_ties_round_to_even_and_zero_blocks_are_exact():
    # a block whose max-abs is 127 gives scale 1.0: x / 1 lands on .5 ties
    ties = np.concatenate([np.arange(-127, 127) + 0.5, [127.0, -127.0]])
    a = np.zeros((2, 512), np.float32)
    a[0, :256] = ties.astype(np.float32)
    q, s = qz.quantize_blockwise(torch.from_numpy(a), 256)
    want_q, want_s = ref.quantize_blockwise(jnp.asarray(a), 256)
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))
    assert q[0, :4].tolist() == [-126, -126, -124, -124]  # -126.5, -125.5, ...
    assert (q[1] == 0).all() and (s[0, 1:] == 1).all() and (s[1] == 1).all()
    d = qz.dequantize_blockwise(q, s, 256)
    assert (d[1] == 0).all() and (d[0, 256:] == 0).all()


def test_ops_entry_points_match_the_reference_xla_backend():
    a = _x(1, 1024, "f32", seed=4)[0]  # 1-D, as ops.py:283 accepts
    q1, s1 = ops.quantize_blockwise(torch.from_numpy(a.copy()))
    q2, s2 = rops.quantize_blockwise(jnp.asarray(a), backend="xla")
    np.testing.assert_array_equal(q1.numpy(), np.asarray(q2))
    np.testing.assert_array_equal(s1.numpy(), np.asarray(s2))
    np.testing.assert_array_equal(
        ops.dequantize_blockwise(q1, s1).numpy(),
        np.asarray(rops.dequantize_blockwise(q2, s2, backend="xla")))


def test_wrapper_contract():
    x = torch.zeros((2, 300))
    with pytest.raises(ValueError, match="multiple of block"):
        qz.quantize_blockwise(x, 256)
    before = (qz.quantize_blockwise.launches, qz.dequantize_blockwise.launches)
    q, s = qz.quantize_blockwise(torch.ones((2, 256)))
    qz.dequantize_blockwise(q, s)
    assert (qz.quantize_blockwise.launches,
            qz.dequantize_blockwise.launches) == before  # CPU: no launch
    with pytest.raises(ValueError, match="cpu or cuda"):
        qz.quantize_blockwise(torch.ones((2, 256), device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_kernels_bit_exact_vs_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip(CUDA_REASON)
    xt, _ = _both(_x(16, 4096, dtype), dtype)
    xt = xt.cuda()
    q1, s1 = qz.quantize_blockwise(xt, 256)
    q2, s2 = qz.quantize_blockwise_plain(xt, 256)
    assert torch.equal(q1, q2) and torch.equal(s1, s2)
    assert torch.equal(qz.dequantize_blockwise(q1, s1, 256),
                       qz.dequantize_blockwise_plain(q2, s2, 256))


def _pages(shape, dtype, seed=0):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 3
    a[0, :, -1] = 0  # one (page, head) of zeros
    return _both(a if dtype == "f32" else
                 np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32), dtype)


@pytest.mark.parametrize("shape", PAGE_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_page_plain_bit_exact_vs_pallas_interpret_and_oracle(shape, dtype):
    xt, xj = _pages(shape, dtype)
    q1, s1 = qz.quantize_page_plain(xt)
    assert q1.dtype == torch.int8 and tuple(s1.shape) == (shape[0], shape[2])
    q2, s2 = ref.quantize_page(xj)
    np.testing.assert_array_equal(q1.numpy(), np.asarray(q2))
    np.testing.assert_array_equal(s1.numpy(), np.asarray(s2))
    # the Pallas kernel's scales may sit one ulp off the oracle's; the
    # reference holds them to rtol 1e-6 (tests/test_kernels.py:357)
    q3, s3 = qp_pallas(xj, interpret=True)
    np.testing.assert_array_equal(q1.numpy(), np.asarray(q3))
    np.testing.assert_allclose(s1.numpy(), np.asarray(s3), rtol=1e-6)
    assert float(s1[0, -1]) == 1.0 and (q1[0, :, -1] == 0).all()
    for out_t, out_j in ((torch.float32, jnp.float32),
                         (torch.bfloat16, jnp.bfloat16)):
        d1 = qz.dequantize_page_plain(q1, s1, out_t).float().numpy()
        d2 = np.asarray(ref.dequantize_page(q2, s2, out_j), np.float32)
        np.testing.assert_array_equal(d1, d2)
    d3 = np.asarray(dqp_pallas(q2, s2, interpret=True))
    np.testing.assert_allclose(qz.dequantize_page_plain(q1, s1).numpy(), d3,
                               rtol=1e-6)


@pytest.mark.parametrize("shape", PAGE_SWEEP)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_page_sweep_plain_bit_exact_vs_oracle_and_pallas_interpret(shape,
                                                                   dtype):
    """Bit-exact with the oracle (q, scales, dequantized in f32 and bf16).
    Against the Pallas kernel: q equal in every (page, head) whose scale
    equals the oracle's; where the kernel's scale is one ulp off (as in 2
    to 5 (page, head)s of most of these shapes), q within 1 there (it
    differs in one element of (5, 16, 8, 80) and of (5, 16, 4, 48) in
    bf16)."""
    xt, xj = _pages(shape, dtype)
    q1, s1 = qz.quantize_page_plain(xt)
    q2, s2 = ref.quantize_page(xj)
    np.testing.assert_array_equal(q1.numpy(), np.asarray(q2))
    np.testing.assert_array_equal(s1.numpy(), np.asarray(s2))
    for out_t, out_j in ((torch.float32, jnp.float32),
                         (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            qz.dequantize_page_plain(q1, s1, out_t).float().numpy(),
            np.asarray(ref.dequantize_page(q2, s2, out_j), np.float32))
    q3, s3 = (np.asarray(a) for a in qp_pallas(xj, interpret=True))
    np.testing.assert_allclose(s1.numpy(), s3, rtol=1e-6)
    same = (s1.numpy() == s3)[:, None, :, None]
    dq = np.abs(q1.numpy().astype(np.int32) - q3)
    assert (dq[np.broadcast_to(same, dq.shape)] == 0).all()
    assert dq.max() <= 1
    np.testing.assert_allclose(
        qz.dequantize_page_plain(q1, s1).numpy(),
        np.asarray(dqp_pallas(jnp.asarray(q3), jnp.asarray(s3),
                              interpret=True)),
        rtol=1e-6, atol=float(s3.max()) * 1.01)


def test_page_zero_pool_is_exact_and_the_wrapper_runs_plain_on_cpu():
    x = torch.zeros((2, 4, 2, 8))
    before = (qz.quantize_page.launches, qz.dequantize_page.launches)
    for quant, dequant in ((qz.quantize_page, qz.dequantize_page),
                           (ops.quantize_page, ops.dequantize_page)):
        q, s = quant(x)
        assert (q == 0).all() and (s == 1.0).all()
        assert (dequant(q, s) == 0).all()
    assert (qz.quantize_page.launches, qz.dequantize_page.launches) == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        qz.quantize_page(torch.ones((2, 4, 2, 8), device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_page_kernels_bit_exact_vs_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip(CUDA_REASON)
    xt, _ = _pages((64, 8, 4, 128), dtype)
    xt = xt.cuda()
    q1, s1 = qz.quantize_page(xt)
    q2, s2 = qz.quantize_page_plain(xt)
    assert torch.equal(q1, q2) and torch.equal(s1, s2)
    assert torch.equal(qz.dequantize_page(q1, s1),
                       qz.dequantize_page_plain(q2, s2))


def test_page_half_step_ties_round_to_even():
    # a (page, head) whose max-abs is 127 has scale 1: x / 1 lands on ties
    ties = np.concatenate([[127.0], np.arange(-127, 127) + 0.5])
    a = np.random.default_rng(6).normal(size=(3, 16, 2, 16)).astype(np.float32)
    a[1, :, 0] = np.resize(ties, 256).reshape(16, 16)
    q, s = qz.quantize_page_plain(torch.from_numpy(a))
    want_q, want_s = ref.quantize_page(jnp.asarray(a))
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))
    assert float(s[1, 0]) == 1.0
    assert q[1, 0, 0, :4].tolist() == [127, -126, -126, -124]


def _ptr(offset: int) -> int:
    return 0x7F0000000000 + offset


@pytest.mark.parametrize("shape,dtype,offset,want", [
    ((7168, 8, 4, 128), torch.float32, 0, dict(vec=4, ppb=2, staged=True)),
    ((7168, 8, 4, 128), torch.bfloat16, 0, dict(vec=8, ppb=2, staged=True)),
    ((7168, 8, 4, 128), torch.float32, 4, dict(vec=1, ppb=2, staged=True)),
    ((7168, 8, 4, 128), torch.bfloat16, 2, dict(vec=1, ppb=2, staged=True)),
    ((64, 16, 1, 128), torch.bfloat16, 0, dict(vec=8, ppb=8, staged=True)),
    ((3, 16, 8, 192), torch.float32, 0, dict(vec=4, ppb=1, staged=True)),
    ((9, 64, 1, 192), torch.float32, 0, dict(vec=4, ppb=4, staged=True)),
    ((3, 128, 8, 128), torch.float32, 0, dict(vec=4, ppb=1, staged=False)),
    ((3, 128, 8, 128), torch.bfloat16, 0, dict(vec=8, ppb=1, staged=False)),
    ((7, 1, 1, 8), torch.float32, 0, dict(vec=4, ppb=7, staged=True)),
    ((5, 8, 4, 6), torch.float32, 0, dict(vec=1, ppb=5, staged=True)),
    ((5, 8, 4, 12), torch.bfloat16, 0, dict(vec=1, ppb=5, staged=True)),
])
def test_quantize_page_plan(shape, dtype, offset, want):
    """Units of 16 bytes where ``d`` and the input's address allow them;
    whole pages a block, one (page, head) a warp and at least 16 KB; staged
    while they fit 200 KB."""
    assert qz.page_plan("quantize", shape, dtype, _ptr(offset),
                        _ptr(0)) == want


@pytest.mark.parametrize("shape,dtype,offset,want", [
    ((7168, 8, 4, 128), torch.float32, 0, dict(unit=4, ppb=4)),
    ((7168, 8, 4, 128), torch.bfloat16, 0, dict(unit=8, ppb=4)),
    ((7168, 8, 4, 128), torch.float32, 1, dict(unit=1, ppb=4)),
    ((7168, 8, 4, 128), torch.bfloat16, 4, dict(unit=1, ppb=4)),
    ((7, 1, 1, 8), torch.bfloat16, 0, dict(unit=8, ppb=7)),
    ((5, 8, 4, 6), torch.float32, 0, dict(unit=1, ppb=5)),
    ((2, 1, 8192, 16), torch.float32, 0, dict(unit=4, ppb=1)),
])
def test_dequantize_page_plan(shape, dtype, offset, want):
    """4 (f32 out) or 8 (bf16 out) int8 a thread at a time, one 16-byte
    store each, where ``d`` and the int8 address allow them; 16 KB of int8
    a block."""
    assert qz.page_plan("dequantize", shape, dtype, _ptr(offset),
                        _ptr(0)) == want


def test_page_plan_refuses_an_unknown_kind():
    with pytest.raises(ValueError, match="quantize"):
        qz.page_plan("scale", (1, 1, 1, 8), torch.float32, 0, 0)


THREADS, WARPS = 256, 8  # kThreads, kWarps of csrc/quantize.cu


def _quantize_tasks(np_, ps, H, nv):
    """The units (page, row, head, unit in row) each warp of one quantize
    block reads, as ``quantize_page_kernel`` walks them: tasks (page, head,
    row share j of R), lanes over rows and units as ``Lanes``."""
    heads = np_ * H
    R = 1 if heads >= WARPS else WARPS // heads
    seen = []
    for warp in range(WARPS):
        tasks = (range(warp, heads, WARPS) if R == 1 else
                 [warp // R] if warp // R < heads else [])
        for ph in tasks:
            pb, h, j = ph // H, ph % H, (0 if R == 1 else warp % R)
            for lane in range(32):
                rr, c0, cstep, rpw = ((0, lane, 32, 1) if nv >= 32 else
                                      (lane // nv, lane % nv, nv, 32 // nv))
                if rr >= rpw:
                    continue
                for r in range(j + R * rr, ps, R * rpw):
                    for c in range(c0, nv, cstep):
                        seen.append((pb, r, h, c))
    return seen


@pytest.mark.parametrize("np_,ps,H,nv", [
    (1, 8, 4, 32), (2, 8, 4, 16), (1, 16, 8, 48), (5, 8, 4, 2), (7, 1, 1, 12),
    (1, 16, 1, 20), (3, 16, 8, 10), (512, 1, 1, 2), (1, 128, 8, 32),
    (2, 3, 3, 33)])
def test_quantize_tasks_visit_every_unit_once(np_, ps, H, nv):
    seen = _quantize_tasks(np_, ps, H, nv)
    assert len(seen) == len(set(seen)) == np_ * ps * H * nv


def _dequantize_walk(np_, ps, H, nv):
    """(page, head) of each unit of one dequantize block, as
    ``dequantize_page_kernel``'s carried digits give them."""
    got = {}
    dc, dseg = THREADS % nv, THREADS // nv
    dh, drows = dseg % H, dseg // H
    dr, dpb = drows % ps, drows // ps
    for t in range(THREADS):
        c, seg = t % nv, t // nv
        h, rows = seg % H, seg // H
        r, pb = rows % ps, rows // ps
        for u in range(t, np_ * ps * H * nv, THREADS):
            got[u] = (pb, h)
            c += dc
            if c >= nv:
                c, h = c - nv, h + 1
            h += dh
            if h >= H:
                h, r = h - H, r + 1
            r += dr
            if r >= ps:
                r, pb = r - ps, pb + 1
            pb += dpb
    return got


@pytest.mark.parametrize("np_,ps,H,nv", [
    (4, 8, 4, 8), (7, 1, 1, 1), (5, 8, 4, 1), (1, 16, 8, 12), (3, 16, 1, 5),
    (2, 1, 8192, 1), (1, 1, 300, 3), (16, 3, 7, 1), (1, 256, 1, 1)])
def test_dequantize_walk_carries_page_and_head(np_, ps, H, nv):
    got = _dequantize_walk(np_, ps, H, nv)
    assert len(got) == np_ * ps * H * nv
    for u, (pb, h) in got.items():
        assert (pb, h) == (u // nv // H // ps, u // nv % H), u


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_page_kernels_bit_exact_over_the_sweep(dtype):
    """chip_smoke.py's sweep: d 8-192, pages of 1-16 tokens and one too
    large to stage, 1-8 heads, from aligned pools and at an offset of one
    element (the one-element units), int8 at an offset of one byte."""
    if not torch.cuda.is_available():
        pytest.skip(CUDA_REASON)
    shapes = [(n, ps, H, d) for d in (8, 48, 80, 128, 192)
              for n, ps, H in ((7, 1, 1), (5, 8, 4), (3, 16, 8))]
    for shape in shapes + [(3, 128, 8, 128)]:
        xt, _ = _pages(shape, "f32")
        buf = torch.empty(xt.numel() + 1, dtype=dtype, device="cuda")
        x_off = buf[1:].view(shape)
        x_off.copy_(xt)
        for x in (x_off.clone(), x_off):
            q1, s1 = qz.quantize_page(x)
            q2, s2 = qz.quantize_page_plain(x)
            assert torch.equal(q1, q2) and torch.equal(s1, s2), shape
            qb = torch.empty(q1.numel() + 1, dtype=torch.int8, device="cuda")
            q_off = qb[1:].view(shape)
            q_off.copy_(q1)
            for out_t in (torch.float32, torch.bfloat16):
                want = qz.dequantize_page_plain(q2, s2, out_t)
                for qq in (q1, q_off):
                    assert torch.equal(qz.dequantize_page(qq, s1, out_t),
                                       want), shape

"""The port's int8 quantizers against the JAX package's Pallas kernels in
interpret mode and its ``repro.kernels.ref`` oracles, with the sweep and
bounds of tests/test_kernels.py: blockwise bit-exact in f32, |Δq| ≤ 1 on
under 1% of entries in bf16, scales within rtol 1e-6, the round-trip bound,
exact zero blocks; per-(page, head) bit-exact on the reference's page
shapes (tests/test_kernels.py:351) in f32 and bf16, zero pages exact.  The CUDA kernels run only on the card
(``chip_smoke.py`` holds them bit-exact against the plain versions there);
their test here skips."""

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

"""The port's compressed collectives against the JAX package's: the int8
ring allreduce and its error-feedback wrapper on the port's stacked CPU
``SimTransport`` against the reference's on its numpy ``SimTransport(P)``
give bitwise-equal outputs and identical traces (rounds, serialized
rounds, slot bytes), for P in {2, 4, 8}; the wire-byte and α-β models
agree."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import compression as RC  # noqa: E402
from repro.core.transport import SimTransport as RSim  # noqa: E402
from repro_torch.core import compression as PC  # noqa: E402
from repro_torch.core.transport import SimTransport as PSim  # noqa: E402
from repro_torch.kernels import quantize as qz  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _torch_settings():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trace(t):
    tr = t.trace
    return tr.rounds, tr.serial_rounds, tr.slot_bytes(), tr.bytes_per_rank


def _payload(P, n, seed):
    return (np.random.default_rng(seed).normal(size=(P, n)) * 3).astype(np.float32)


@pytest.mark.parametrize("P", [2, 4, 8])
@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("block", [256, 64])
def test_compressed_ring_allreduce_bitwise(P, mean, block):
    x = _payload(P, 3 * P * block, seed=P)
    rt, pt = RSim(P), PSim(P, device="cpu")
    want = RC.compressed_ring_allreduce(rt, x, block=block, mean=mean)
    got = PC.compressed_ring_allreduce(pt, torch.from_numpy(x.copy()),
                                       block=block, mean=mean)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert _trace(pt) == _trace(rt)
    assert pt.trace.pending == 0
    # every rank ends with the same bits (the allgather ships one encoding)
    assert all(np.array_equal(want[0], want[r]) for r in range(P))


@pytest.mark.parametrize("P", [2, 4, 8])
def test_compressed_allreduce_with_ef_bitwise(P):
    block = 128
    x = _payload(P, 2 * P * block, seed=10 + P)
    res = _payload(P, 2 * P * block, seed=20 + P) * 0.01
    rt, pt = RSim(P), PSim(P, device="cpu")
    want, want_res = RC.compressed_allreduce_with_ef(rt, x, res, block=block,
                                                     mean=True)
    got, got_res = PC.compressed_allreduce_with_ef(
        pt, torch.from_numpy(x.copy()), torch.from_numpy(res.copy()),
        block=block, mean=True)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_res.numpy(), want_res)
    assert _trace(pt) == _trace(rt)


def test_codec_calls_per_allreduce():
    """P quantize and 2P-1 dequantize calls per allreduce, each over the
    whole stacked [P, c] chunk (one kernel launch each on the card)."""
    P, block = 4, 256
    calls = {"q": [], "d": []}
    q0, d0 = qz.quantize_blockwise, qz.dequantize_blockwise

    def q(x, block=256):
        calls["q"].append(tuple(x.shape))
        return q0(x, block)

    def d(q_, s, block=256, out_dtype=torch.float32):
        calls["d"].append(tuple(q_.shape))
        return d0(q_, s, block, out_dtype)

    mp = pytest.MonkeyPatch()
    mp.setattr(qz, "quantize_blockwise", q)
    mp.setattr(qz, "dequantize_blockwise", d)
    try:
        PC.compressed_ring_allreduce(PSim(P, device="cpu"),
                                     torch.from_numpy(_payload(P, P * block, 1)),
                                     block=block, mean=True)
    finally:
        mp.undo()
    assert len(calls["q"]) == P and len(calls["d"]) == 2 * P - 1
    assert set(calls["q"]) == set(calls["d"]) == {(P, 1, block)}


def test_refuses_undivisible_payload_and_passes_world_one():
    with pytest.raises(ValueError, match="divisible"):
        PC.compressed_ring_allreduce(PSim(2, device="cpu"), torch.zeros((2, 300)))
    x = torch.ones((1, 256))
    assert PC.compressed_ring_allreduce(PSim(1, device="cpu"), x) is x


@pytest.mark.parametrize("c,block", [(1024, 256), (4096, 64), (100, 10)])
def test_wire_models_match_the_reference(c, block):
    assert PC.compressed_hop_bytes(c, block) == RC.compressed_hop_bytes(c, block)
    for P in (2, 4, 8):
        assert PC.compressed_ring_time(4e6, P, 1e-5, 1 / 6.25e9, block) == \
            RC.compressed_ring_time(4e6, P, 1e-5, 1 / 6.25e9, block)

"""The port's lockstep channel and collective algorithms against the JAX
package's: the same payloads (numpy, seeded) through ``repro.core`` on
numpy and through ``repro_torch.core`` on CPU tensors give bitwise-equal
results and identical traces (``rounds``, ``serial_rounds``,
``slot_bytes()``) — elementwise f32 adds in the same order are exact."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import algorithms as RA  # noqa: E402
from repro.core import collectives as RC  # noqa: E402
from repro.core.communicator import Communicator as RComm  # noqa: E402
from repro.core.transport import SimTransport as RSim  # noqa: E402
from repro_torch.core import algorithms as PA  # noqa: E402
from repro_torch.core import collectives as PC  # noqa: E402
from repro_torch.core.communicator import Communicator as PComm  # noqa: E402
from repro_torch.core.transport import RankFailure  # noqa: E402
from repro_torch.core.transport import SimTransport as PSim  # noqa: E402


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


def _payload(P, shape, seed=0):
    return np.random.default_rng(seed).normal(
        size=(P,) + tuple(shape)).astype(np.float32)


def _trace(t):
    tr = t.trace
    return tr.rounds, tr.serial_rounds, tr.slot_bytes(), tr.bytes_per_rank


def _run_both(fn_ref, fn_port, x, P):
    rt, pt = RSim(P), PSim(P, device="cpu")
    want = np.asarray(fn_ref(rt, x))
    got = fn_port(pt, torch.from_numpy(x.copy()))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert _trace(pt) == _trace(rt)
    assert pt.trace.pending == 0


WORLDS = [1, 2, 4, 8]


@pytest.mark.parametrize("P", WORLDS + [3, 6])
def test_allreduce_recursive_doubling_bitwise(P):
    x = _payload(P, (7, 3), seed=P)
    _run_both(RA.allreduce_recursive_doubling,
              PA.allreduce_recursive_doubling, x, P)


@pytest.mark.parametrize("P", WORLDS + [3, 6])
def test_allreduce_ring_bitwise(P):
    x = _payload(P, (P * 5,), seed=10 + P)
    _run_both(RA.allreduce_ring, PA.allreduce_ring, x, P)


@pytest.mark.parametrize("P", WORLDS)
def test_allreduce_ring_pipelined_bitwise(P):
    x = _payload(P, (P * 6,), seed=20 + P)
    _run_both(lambda t, v: RA.allreduce_ring_pipelined(t, v, depth=3),
              lambda t, v: PA.allreduce_ring_pipelined(t, v, depth=3), x, P)


@pytest.mark.parametrize("P", [2, 4, 8])
def test_allreduce_rabenseifner_bitwise(P):
    x = _payload(P, (P * 4,), seed=30 + P)
    _run_both(RA.allreduce_rabenseifner, PA.allreduce_rabenseifner, x, P)


@pytest.mark.parametrize("P", WORLDS)
def test_allgather_doubling_bitwise(P):
    x = _payload(P, (6,), seed=40 + P)
    _run_both(RA.doubling_allgather, PA.doubling_allgather, x, P)


@pytest.mark.parametrize("P", WORLDS + [3])
def test_allgather_ring_bitwise(P):
    x = _payload(P, (6,), seed=50 + P)
    _run_both(RA.allgather_natural_ring, PA.allgather_natural_ring, x, P)


@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("P", [2, 4, 8])
def test_collectives_auto_allreduce_bitwise(P, op):
    """Through the communicator: ``algorithm='auto'`` selects the same
    (algorithm, depth) in both packages and pads the same way."""
    x = _payload(P, (37,), seed=60 + P)
    want = RC.allreduce(x, RComm(axes=("d",), sizes=(P,), channel="sim"),
                        op=op)
    got = PC.allreduce(torch.from_numpy(x.copy()),
                       PComm(axes=("d",), sizes=(P,), channel="sim",
                             device="cpu"), op=op)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("P", WORLDS)
def test_collectives_allgather_and_reduce_scatter_bitwise(P):
    x = _payload(P, (5, 3), seed=70 + P)
    rcomm = RComm(axes=("d",), sizes=(P,), channel="sim")
    pcomm = PComm(axes=("d",), sizes=(P,), channel="sim", device="cpu")
    np.testing.assert_array_equal(
        PC.allgather(torch.from_numpy(x.copy()), pcomm).numpy(),
        np.asarray(RC.allgather(x, rcomm)))
    np.testing.assert_array_equal(
        PC.reduce_scatter(torch.from_numpy(x.copy()), pcomm).numpy(),
        np.asarray(RC.reduce_scatter(x, rcomm)))


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float8_e4m3fn"])
def test_allgather_moves_narrow_dtypes_exactly(dtype):
    """The emission wire's dtypes cross the channel byte for byte."""
    P = 4
    x = torch.from_numpy(_payload(P, (6,), seed=80)).to(getattr(torch, dtype))
    t = PSim(P, device="cpu")
    out = PA.doubling_allgather(t, x)
    for holder in range(P):
        for r in range(P):
            assert torch.equal(out[holder, r].view(torch.uint8),
                               x[r].view(torch.uint8))
    assert t.trace.slot_bytes() == [6 * x.element_size() * k
                                    for k in (1, 2)]


def test_kill_mid_collective_raises_rank_failure():
    P = 4
    t = PSim(P, device="cpu")
    x = torch.from_numpy(_payload(P, (P * 3,)))
    t.kill(3, after_rounds=2)
    with pytest.raises(RankFailure) as err:
        PA.allreduce_ring(t, x)
    assert err.value.rank == 3
    assert t.dead == frozenset({3})
    t.revive(3)
    PA.allreduce_ring(t, x)  # the flap: the group works again


def test_where_keeps_rank_arithmetic_on_host():
    t = PSim(4, device="cpu")
    r = t.rank()
    starts = t.where(r % 2 == 0, 1, 0)
    assert isinstance(starts, np.ndarray) and starts.tolist() == [1, 0, 1, 0]
    x = torch.arange(8.0).reshape(4, 2)
    picked = t.where(r >= 2, x, torch.zeros_like(x))
    assert picked.tolist() == [[0, 0], [0, 0], [4, 5], [6, 7]]
    assert t.dynslice(x, starts, 1, axis=0).tolist() == [[1], [2], [5], [6]]


def test_barrier_and_scan_match_reference():
    P = 4
    x = _payload(P, (3,), seed=90)
    rt, pt = RSim(P), PSim(P, device="cpu")
    np.testing.assert_array_equal(
        PA.scan_hillis_steele(pt, torch.from_numpy(x.copy())).numpy(),
        np.asarray(RA.scan_hillis_steele(rt, x)))
    assert PA.barrier(pt).tolist() == np.asarray(RA.barrier(rt)).tolist()
    assert _trace(pt) == _trace(rt)


def test_isend_irecv_and_mailbox_abort_match_reference():
    from repro.core import requests as RR
    from repro_torch.core import requests as PR

    P = 4
    x = _payload(P, (5,), seed=91)
    pairs = [(i, (i + 1) % P) for i in range(P)]
    rt, pt = RSim(P), PSim(P, device="cpu")
    RR.isend(x, rt, pairs, tag=1)
    PR.isend(torch.from_numpy(x.copy()), pt, pairs, tag=1)
    np.testing.assert_array_equal(PR.irecv(pt, tag=1).wait().numpy(),
                                  np.asarray(RR.irecv(rt, tag=1).wait()))
    RR.isend(x, rt, pairs, tag=2)
    PR.isend(torch.from_numpy(x.copy()), pt, pairs, tag=2)
    assert PR.abort_mailbox(pt) == RR.abort_mailbox(rt) == 1
    assert _trace(pt) == _trace(rt) and pt.trace.pending == 0


@pytest.mark.parametrize("P", [2, 4, 8])
def test_hierarchical_sim_phases_match_reference(P):
    """Halving reduce-scatter → (outer phase) → doubling allgather, the
    sim-channel composition of the two-level allreduce."""
    from repro.core import hierarchical as RH
    from repro_torch.core import hierarchical as PH

    x = _payload(P, (P * 3,), seed=100 + P)
    rt, pt = RSim(P), PSim(P, device="cpu")
    want = RH.hierarchical_allreduce_sim(rt, lambda c: c * 2, x)
    got = PH.hierarchical_allreduce_sim(pt, lambda c: c * 2,
                                        torch.from_numpy(x.copy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _trace(pt) == _trace(rt)


def test_sim_transport_default_device_is_the_card():
    t = PSim(2, device="cpu")
    assert t.device == torch.device("cpu")
    if torch.cuda.is_available():
        assert PSim(2).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PSim(2)

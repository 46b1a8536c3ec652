"""The port's paged KV cache against the JAX package's: the same writes
leave bitwise-equal pool bytes and scale tables on every tier (f32, bf16,
int8, fp8) — the port's batched every-head ``write_rows`` against the
reference's ``append`` and per-head ``write_kv`` — the page accounting is
the same, and the int8 write-once scale policy holds."""

import os

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving.kv_cache import PagedKVCache as RKV  # noqa: E402
from repro_torch.serving.kv_cache import OutOfPages  # noqa: E402
from repro_torch.serving.kv_cache import PagedKVCache as PKV  # noqa: E402

TIERS = ["f32", "bf16", "int8", "fp8"]
GEOM = dict(layers=2, n_pages=6, page_size=4, heads_local=2, head_dim=8,
            world=2)


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


def _bytes(a) -> bytes:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(a).tobytes()


def _assert_same_state(port: PKV, ref: RKV):
    for name in ("k_pool", "v_pool", "k_scale", "v_scale"):
        assert _bytes(getattr(port, name)) == _bytes(getattr(ref, name)), name
    assert port.live_seqs == ref.live_seqs
    assert (port.free_pages, port.pages_in_use, port.peak_in_use,
            port.allocs, port.frees) == (ref.free_pages, ref.pages_in_use,
                                         ref.peak_in_use, ref.allocs,
                                         ref.frees)


def _tokens(rng, L, P, T, Hl, hd, scale=1.0):
    return (rng.normal(size=(L, P, T, Hl, hd)) * scale).astype(np.float32)


def _port_append(port: PKV, sid: int, k: np.ndarray, v: np.ndarray):
    """The reference's ``append`` (``[L, P, T, Hl, hd]`` at the current
    length) through the port's one write path."""
    start, T = port.length(sid), k.shape[2]
    slots = [port.slot(sid, start + t) for t in range(T)]
    pages, offs = [p for p, _ in slots], [o for _, o in slots]
    for li in range(k.shape[0]):
        port.write_rows(li, pages, offs,
                        torch.from_numpy(k[li].transpose(1, 0, 2, 3).copy()),
                        torch.from_numpy(v[li].transpose(1, 0, 2, 3).copy()))
    port.advance(sid, T)


@pytest.mark.parametrize("tier", TIERS)
def test_same_write_sequence_same_pool_bytes(tier):
    """alloc → batched append (reference) / rows (port) → per-head writes
    (reference) / one row per token (port) → free → realloc: every pool
    byte and scale equal after each phase."""
    rng = np.random.default_rng(7)
    ref = RKV(kv_dtype=tier, **GEOM)
    port = PKV(kv_dtype=tier, device="cpu", **GEOM)
    L, P, Hl, hd = GEOM["layers"], GEOM["world"], 2, 8
    for kv in (ref, port):
        kv.alloc(0, capacity=9)
        kv.alloc(1, capacity=4)
    k, v = _tokens(rng, L, P, 5, Hl, hd), _tokens(rng, L, P, 5, Hl, hd)
    ref.append(0, k, v)
    _port_append(port, 0, k, v)
    _assert_same_state(port, ref)
    # incremental writes of seq 1: per (layer, rank, head) in the reference
    for pos in range(3):
        page, off = ref.slot(1, pos)
        assert port.slot(1, pos) == (page, off)
        tok = (rng.normal(size=(L, P, Hl, 2, hd)) * 3).astype(np.float32)
        for li in range(L):
            for r in range(P):
                for h in range(Hl):
                    ref.write_kv(li, r, h, page, off, tok[li, r, h, 0],
                                 tok[li, r, h, 1])
            port.write_rows(li, [page], [off],
                            torch.from_numpy(tok[li, None, :, :, 0].copy()),
                            torch.from_numpy(tok[li, None, :, :, 1].copy()))
        ref.advance(1, 1)
        port.advance(1, 1)
    _assert_same_state(port, ref)
    gk_r, gv_r = ref.gather(1, layer=1, pad=True)
    gk_p, gv_p = port.gather(1, layer=1, pad=True)
    np.testing.assert_array_equal(gk_p.numpy(), gk_r)
    np.testing.assert_array_equal(gv_p.numpy(), gv_r)
    assert port.free(0) == ref.free(0)
    _assert_same_state(port, ref)
    for kv in (ref, port):
        kv.alloc(2, capacity=12)
    k, v = _tokens(rng, L, P, 7, Hl, hd), _tokens(rng, L, P, 7, Hl, hd)
    ref.append(2, k, v)
    _port_append(port, 2, k, v)
    _assert_same_state(port, ref)
    gk_r, _ = ref.gather(2, pad=True)
    np.testing.assert_array_equal(port.gather(2, pad=True)[0].numpy(), gk_r)
    assert port.manifest_entry(2) == ref.manifest_entry(2)
    np.testing.assert_array_equal(port.table(2, width=4), ref.table(2, width=4))


def test_int8_write_once_scale_policy():
    """Counterpart of the reference's write-once test: the page-opening
    token fixes the per-(page, head) scale; one batched write and
    token-by-token writes give identical bits; later tokens clip to the
    opening grid; free() resets the scales."""
    rng = np.random.default_rng(3)
    k = torch.from_numpy(rng.normal(size=(4, 1, 2, 4)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(4, 1, 2, 4)).astype(np.float32))
    mk = lambda: PKV(layers=1, n_pages=2, page_size=4,  # noqa: E731
                     heads_local=2, head_dim=4, world=1, kv_dtype="int8",
                     device="cpu")
    batched = mk()
    batched.alloc(0, capacity=4)
    batched.write_rows(0, [0] * 4, [0, 1, 2, 3], k, v)
    stepped = mk()
    stepped.alloc(0, capacity=4)
    for t in range(4):
        page, off = stepped.slot(0, t)
        stepped.write_rows(0, [page], [off], k[t:t + 1], v[t:t + 1])
    assert batched.k_pool.dtype == torch.int8
    for name in ("k_pool", "v_pool", "k_scale", "v_scale"):
        assert torch.equal(getattr(batched, name), getattr(stepped, name))
    expect = k[0, 0].abs().amax(-1).numpy() / np.float32(127.0)
    np.testing.assert_array_equal(batched.k_scale[0, 0, 0].numpy(), expect)
    batched.advance(0, 4)
    gk, _ = batched.gather(0, pad=True)
    step = batched.k_scale[0, 0, 0].numpy()[None, :, None]
    clipped = np.clip(k[:, 0].numpy(), -127 * step, 127 * step)
    assert np.abs(gk[0, :4].numpy() - clipped).max() <= step.max() * 0.5 + 1e-7
    batched.free(0)
    assert bool((batched.k_scale == 1.0).all()) and \
        bool((batched.v_scale == 1.0).all())


def test_page_reservation_and_accounting():
    kv = PKV(layers=1, n_pages=6, page_size=4, heads_local=2, head_dim=4,
             world=1, device="cpu")
    assert kv.pages_for(1) == 1 and kv.pages_for(9) == 3
    a = kv.alloc(0, capacity=9)
    b = kv.alloc(1, capacity=4)
    assert len(a) == 3 and len(b) == 1
    assert kv.pages_in_use == 4 and kv.free_pages == 2
    with pytest.raises(OutOfPages):
        kv.alloc(2, capacity=12)
    with pytest.raises(ValueError):
        kv.alloc(0, capacity=4)
    assert kv.free(0) == 3
    assert kv.pages_in_use == 1 and kv.peak_in_use == 4
    assert kv.allocs == 2 and kv.frees == 1 and kv.live_seqs == (1,)
    with pytest.raises(ValueError):
        kv.advance(1, 5)  # past the reservation
    with pytest.raises(IndexError):
        kv.slot(1, 4)


def test_gather_views_share_the_pool():
    kv = PKV(layers=2, n_pages=4, page_size=4, heads_local=2, head_dim=4,
             world=2, device="cpu")
    kv.alloc(7, capacity=6)
    k = torch.randn(2, 2, 3, 2, 4)  # [L, P, T, Hl, hd]
    _port_append(kv, 7, k.numpy(), k.numpy())
    kpages, _ = kv.gather(7)
    assert isinstance(kpages, tuple) and len(kpages) == 2
    base = kv.k_pool.untyped_storage().data_ptr()
    assert all(p.untyped_storage().data_ptr() == base for p in kpages)
    gk, _ = kv.gather(7, pad=True)
    assert tuple(gk.shape) == (2, 2, 8, 2, 4)
    assert torch.equal(gk[:, :, :3], k) and not gk[:, :, 3:].any()
    assert gk.untyped_storage().data_ptr() != base


def test_page_bytes_tiers_match_reference():
    for tier in TIERS:
        kw = dict(layers=1, n_pages=2, page_size=8, heads_local=2,
                  head_dim=16, world=1, kv_dtype=tier)
        assert PKV(device="cpu", **kw).page_nbytes == RKV(**kw).page_nbytes
    with pytest.raises(ValueError):
        PKV(layers=1, n_pages=2, page_size=8, heads_local=2, head_dim=16,
            world=1, kv_dtype="f16", device="cpu")


def test_fp8_cast_matches_ml_dtypes_in_range_and_records_the_rest():
    """e4m3 casts: the port's ``to_e4m3`` gives ml_dtypes' bytes for every
    input — round to nearest even up to ±464, and NaN with the input's
    sign beyond it and for ±inf.  The rest is recorded: PyTorch's own cast
    saturates those values to ±448, which is why the port does not use it
    bare."""
    from repro_torch.serving.kv_cache import to_e4m3

    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(size=4096) * 50, rng.normal(size=512) * 1e3,
                        [0.0, -0.0, 447.9, 448.0, 460.0, -463.0, 464.0,
                         -464.0, 464.01, 465.0, 1000.0, -1e4, np.inf, -np.inf]]
                       ).astype(np.float32)
    ml = x.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    pt = to_e4m3(torch.from_numpy(x)).view(torch.uint8).numpy()
    np.testing.assert_array_equal(pt, ml)
    big = np.array([465.0, 1000.0, -1e4], np.float32)
    assert np.isnan(big.astype(ml_dtypes.float8_e4m3fn).astype(np.float32)).all()
    sat = torch.from_numpy(big).to(torch.float8_e4m3fn).float().tolist()
    assert sat == [448.0, 448.0, -448.0]


def test_fp8_out_of_range_writes_give_the_reference_pool_bytes():
    """Values beyond ±464 (and ±inf) written through ``PagedKVCache`` in
    both packages leave the same fp8 pool bytes: e4m3 NaN, not ±448."""
    rng = np.random.default_rng(11)
    ref = RKV(kv_dtype="fp8", **GEOM)
    port = PKV(kv_dtype="fp8", device="cpu", **GEOM)
    L, P, Hl, hd = GEOM["layers"], GEOM["world"], 2, 8
    for kv in (ref, port):
        kv.alloc(0, capacity=8)
    k = _tokens(rng, L, P, 6, Hl, hd, scale=600.0)
    v = _tokens(rng, L, P, 6, Hl, hd, scale=600.0)
    k[0, 0, 0, 0, :3] = [np.inf, -np.inf, 464.0]
    v[1, 1, 2, 1, :2] = [-465.0, 1e6]
    assert (np.abs(k) > 464).any() and (np.abs(v) > 464).any()
    ref.append(0, k, v)
    _port_append(port, 0, k, v)
    _assert_same_state(port, ref)
    assert torch.isnan(port.k_pool.float()).any()

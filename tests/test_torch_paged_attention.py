"""The port's paged-attention plain version and wrapper against the JAX
package: its blocked-recurrence oracle (``repro.kernels.ref``), its
vectorized XLA twin and its Pallas kernel in interpret mode, over the
reference's sweep cases and pool tiers, at the reference's tolerance tiers.
The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
them against the plain version there); their test here skips.  Their
arithmetic (rows cut into splits, chunks of whole pages, one online-softmax
update a chunk, per-page scales, the merge of a row's splits in order) is
emulated here in numpy and held against the Pallas kernel and the oracle,
and against its own invariances."""

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


def test_cuda_contract_refusals_and_copy_size():
    """What the kernel does not take is refused before any build or
    launch: widths not multiples of 4, d past 256; the copy size is the
    largest of 16, 8, 4 dividing a K row and a V row (int8 rows of 8
    columns copy 8 bytes at a time)."""
    def check(d, dv, dtype=torch.float32):
        kp = torch.zeros((4, 2, 1, d), dtype=dtype)
        vp = torch.zeros((4, 2, 1, dv), dtype=dtype)
        ones = torch.ones((4, 1))
        heads = torch.zeros(2, dtype=torch.int32)
        return pa._check_cuda(torch.zeros((1, 2, d)), kp, vp,
                              torch.zeros((1, 2), dtype=torch.int32),
                              torch.ones(1, dtype=torch.int32), ones, ones,
                              heads, heads)
    assert check(8, 8, torch.int8)[2:4] == (8, 8)
    for d, dv in ((6, 8), (8, 6), (260, 8), (8, 516)):
        with pytest.raises(ValueError, match="multiples of 4"):
            check(d, dv)
    assert [pa.copy_bytes(d, d, e) for d, e in
            ((128, 4), (8, 1), (4, 1), (8, 2), (80, 1))] == [16, 8, 4, 16, 16]


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


# ---------------------------------------------------------------------------
# numpy emulation of the Hopper kernels (csrc/paged_attention.cu): the grid
# of (split, head group, row) blocks, each walking its split in chunks of
# whole pages with one online-softmax update a chunk, scores summed as the
# kernel's lanes sum them, then the merge of a row's splits in split order.
# ---------------------------------------------------------------------------

F32 = np.float32


def _lane_dot(k, q):
    """``sum_e k[..., j, e] q[g, e]`` as the kernel's warp sums it: lane L
    adds its columns 4L..4L+3 and 128+4L..128+4L+3 in order, then a
    butterfly over lanes (xor 16, 8, 4, 2, 1).  k ``[J, d]``, q ``[G, d]``
    → ``[G, J]``."""
    J, d = k.shape
    a = np.zeros((q.shape[0], J, 32), F32)
    lane = np.arange(32)
    for r in range(2):
        for i in range(4):
            e = 4 * lane + 128 * r + i
            ok = e < d
            a[..., ok] = a[..., ok] + k[None, :, e[ok]] * q[:, None, e[ok]]
    for o in (16, 8, 4, 2, 1):
        a = a + a[..., lane ^ o]
    return a[..., 0]


def _lane_sum(x):
    """``sum_j x[g, j]`` as the kernel's warp sums it: lane L adds j = L,
    L + 32, ... in order, then the butterfly."""
    G, J = x.shape
    a = np.zeros((G, 32), F32)
    for j0 in range(0, J, 32):
        part = x[:, j0:j0 + 32]
        a[:, :part.shape[1]] = a[:, :part.shape[1]] + part
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        a = a + a[:, lane ^ o]
    return a[:, 0]


def _block(qg, kf, vf, ks, vs, table, b, hk, poff, sm, s, n, chunk, split,
           ps):
    """One block of the split kernel: split ``s`` of row ``b`` (``n``
    tokens) for the q heads ``qg [G, d]`` → its (m, l, acc) combined over
    the block's warps.  Each warp keeps its own online softmax over its
    share of every chunk's slots: scores as the lanes sum them, one update
    a chunk, acc scaled by alpha and then each page's p . v part times its
    v_scale added in page order; then the warps' states in warp order."""
    G, dv = qg.shape[0], vf.shape[-1]
    W = pa._WARPS
    qw = -(-chunk // W)
    m = np.full((W, G), -1e30, F32)
    l = np.zeros((W, G), F32)
    acc = np.zeros((W, G, dv), F32)
    nt = min(n, s * split + split) - s * split
    for t0 in range(0, nt, chunk):
        rows = min(chunk, nt - t0)
        for w in range(W):
            nw = min(rows - w * qw, qw)
            if nw <= 0:
                continue
            tok = s * split + t0 + w * qw + np.arange(nw)
            pid = table[b, tok // ps].astype(np.int64) + poff
            kc, vc = kf[pid, tok % ps, hk], vf[pid, tok % ps, hk]
            sc = _lane_dot(kc, qg) * (ks[pid, hk].astype(F32) * sm)[None]
            mx = np.maximum(m[w], sc.max(axis=1))
            alpha = np.exp(m[w] - mx)
            p = np.exp(sc - mx[:, None])
            l[w] = l[w] * alpha + _lane_sum(p)
            m[w] = mx
            acc[w] = acc[w] * alpha[:, None]
            part = np.zeros((G, dv), F32)
            for t in range(nw):
                part = part + p[:, t, None] * vc[None, t]
                if t == nw - 1 or (tok[t] + 1) % ps == 0:
                    acc[w] = acc[w] + part * vs[pid[t], hk]
                    part = np.zeros((G, dv), F32)
    mx = m.max(axis=0)
    lt = np.zeros(G, F32)
    at = np.zeros((G, dv), F32)
    for w in range(W):
        f = np.exp(m[w] - mx)
        lt = lt + l[w] * f
        at = at + acc[w] * f[:, None]
    return mx, lt, at


def emulate(q, kp, vp, table, lengths, k_scale=None, v_scale=None,
            kv_head=None, page_offset=None, sm_scale=None):
    """The kernels' arithmetic on numpy inputs (pools in their storage
    dtype) → ``[B, Hq, dv]`` f32: the grid of (split, head group, row)
    blocks (blocks past a row's own splits exit), then the merge of a
    row's splits in split order."""
    B, Hq, d = q.shape
    n_pages, ps, Hkv, dv = vp.shape
    npm = table.shape[1]
    grouped = kv_head is None and page_offset is None
    sm = F32(d**-0.5 if sm_scale is None else sm_scale)
    ks = np.ones((n_pages, Hkv), F32) if k_scale is None else k_scale
    vs = np.ones((n_pages, Hkv), F32) if v_scale is None else v_scale
    if kv_head is None:
        kv_head = np.arange(Hq) // (Hq // Hkv)
    if page_offset is None:
        page_offset = np.zeros(Hq, np.int64)
    kf, vf = kp.astype(F32), vp.astype(F32)
    chunk, split = pa.plan(ps, d, dv, kp.dtype.itemsize)
    group = pa.block_group(Hq, Hkv, dv, grouped)
    n_splits = max(1, -(-npm * ps // split))
    out = np.zeros((B, Hq, dv), F32)
    for b in range(B):
        n = int(min(max(int(lengths[b]), 0), npm * ps))
        ns = -(-n // split) if n else 1
        for h0 in range(0, Hq, group):
            parts = [_block(q[b, h0:h0 + group].astype(F32), kf, vf, ks, vs,
                            table, b, int(kv_head[h0]), int(page_offset[h0]),
                            sm, s, n, chunk, split, ps)
                     for s in range(n_splits) if s < ns]
            if ns == 1:
                _, lt, at = parts[0]
                out[b, h0:h0 + group] = at / np.maximum(lt, F32(1e-30))[:, None]
                continue
            mx = np.max([m for m, _, _ in parts], axis=0)  # the merge kernel
            lsum = np.zeros(group, F32)
            asum = np.zeros((group, dv), F32)
            for m, l, a in parts:
                f = np.exp(m - mx)
                lsum = lsum + l * f
                asum = asum + a * f[:, None]
            out[b, h0:h0 + group] = asum / np.maximum(lsum, F32(1e-30))[:, None]
    return out


def _long_case(d, ps, Hq, Hkv, tier, seed=0):
    """Rows at the split edges of the plan for (ps, d) in ``tier``: lengths
    0, 1, one chunk, one split, one split + 1, three splits; pages spread
    over a shuffled pool."""
    elem = {"f32": 4, "bf16": 2, "int8": 1}[tier]
    chunk, split = pa.plan(ps, d, d, elem)
    lengths = np.array([0, 1, chunk, split, split + 1, 3 * split], np.int32)
    npm = 3 * split // ps
    B = len(lengths)
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, d)).astype(np.float32)
    kp = rng.normal(size=(B * npm, ps, Hkv, d)).astype(np.float32)
    vp = rng.normal(size=(B * npm, ps, Hkv, d)).astype(np.float32)
    table = rng.permutation(B * npm).reshape(B, npm).astype(np.int32)
    ks = vs = None
    if tier == "bf16":
        kp, vp = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (kp, vp))
    elif tier == "int8":
        kq, ks = ref.quantize_page(jnp.asarray(kp))
        vq, vs = ref.quantize_page(jnp.asarray(vp))
        kp, vp, ks, vs = (np.asarray(a) for a in (kq, vq, ks, vs))
    return q, kp, vp, table, lengths, ks, vs


LONG_CASES = [  # d = dv, ps, Hq, Hkv, tier
    (16, 16, 2, 1, "f32"),   # chunks of 8 pages (128 tokens), GQA group 2
    (64, 8, 4, 2, "f32"),    # 8 pages (64 tokens: 4 chunks a split)
    (128, 8, 2, 2, "bf16"),  # 8 pages (64 tokens)
    (32, 4, 2, 1, "int8"),   # 32 pages (128 tokens), per-page scales
]


@pytest.mark.parametrize("case", LONG_CASES, ids=[str(c) for c in LONG_CASES])
def test_emulated_kernels_vs_pallas_and_oracle_across_splits(case):
    """The split/chunk/merge arithmetic at lengths 0, 1, one chunk, one
    split, one split + 1 and three splits, against the Pallas kernel
    (interpret mode) and the per-page oracle, within TIER_ORACLE."""
    args = _long_case(*case)
    got = emulate(*args)
    assert (got[0] == 0).all()  # length 0: exact zero
    q, kp, vp, tbl, ln, ks, vs = _jnp(*args)
    pallas = pa_pallas(q, kp, vp, tbl, ln, k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(got, np.asarray(pallas), **TIER_ORACLE)
    oracle = ref.paged_attention(q, kp, vp, tbl, ln, k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(got, np.asarray(oracle), **TIER_ORACLE)


def test_emulated_kernels_group_and_pad_columns_are_bitwise_invariant():
    """A block of 2 q heads (plain GQA) gives each head the bits that a
    block of one gives it (explicit head maps), and pad columns that push
    npm * ps past one split (so that a merge launch follows) change no
    bit, for rows of one split and of several."""
    q, kp, vp, tbl, ln, ks, vs = _long_case(64, 8, 4, 2, "f32", seed=3)
    grouped = emulate(q, kp, vp, tbl, ln, ks, vs)
    assert pa.block_group(4, 2, 64, True) == 2
    single = emulate(q, kp, vp, tbl, ln, ks, vs, kv_head=np.arange(4) // 2,
                     page_offset=np.zeros(4, np.int32))
    assert np.array_equal(grouped, single)
    # rows of at most one split, table of exactly one split's pages, then
    # padded past it
    _, split = pa.plan(8, 64, 64, 4)
    short = ln <= split
    t1 = tbl[short, :split // 8]
    one = emulate(q[short], kp, vp, t1, ln[short])
    pad = np.concatenate([t1, np.zeros((t1.shape[0], 3), np.int32)], axis=1)
    assert np.array_equal(one, emulate(q[short], kp, vp, pad, ln[short]))
    # rows of several splits keep their bits under more pad columns too
    wide = np.concatenate([tbl, np.zeros((tbl.shape[0], 70), np.int32)], 1)
    assert np.array_equal(grouped, emulate(q, kp, vp, wide, ln, ks, vs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8,
                                   torch.float8_e4m3fn])
@pytest.mark.parametrize("ps", [1, 8, 16, 128])
def test_plan_cuts_whole_pages_and_chunks(dtype, ps):
    """A chunk is whole pages, at most CHUNK_BYTES of K and V unless one
    page is more and at most MAX_CHUNK tokens unless one page is more; a
    split is whole chunks, SPLIT_TOKENS unless one chunk is more.  At the
    serve shape (ps 8, d = dv = 128): 32 f32 tokens, 64 bf16, 128 int8."""
    elem = torch.empty((), dtype=dtype).element_size()
    for d in (16, 64, 128, 256):
        chunk, split = pa.plan(ps, d, d, elem)
        assert chunk % ps == 0 and split % chunk == 0
        assert chunk == ps or (chunk * 2 * d * elem <= pa.CHUNK_BYTES
                               and chunk <= pa.MAX_CHUNK)
        assert split == max(chunk, pa.SPLIT_TOKENS // chunk * chunk)
    if ps == 8:
        assert pa.plan(8, 128, 128, elem)[0] == {4: 32, 2: 64, 1: 128}[elem]

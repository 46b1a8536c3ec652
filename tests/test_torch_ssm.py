"""The port's recurrent mixers against the JAX package's
``repro.models.ssm`` on the reference's own initial weights (carried
across, never re-drawn), at the reduced xlstm-125m config (mLSTM, sLSTM)
and the reduced hymba-1.5b config (SSD heads), in f32: outputs within
atol 2e-5 and gradients with respect to the input within 1e-4 ×
max|ref| (float32 rounding of two implementations; the largest gaps
seen are 4e-6 and 3e-6 × max|ref|).  The decode branches and the
``*_init_state`` helpers raise, naming their ROADMAP item."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as rconfigs  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models import ssm as rssm  # noqa: E402
from repro.models.layers import NO_SHARD  # noqa: E402
from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.models import ssm as pssm  # noqa: E402


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


@pytest.fixture(scope="module")
def xlstm():
    rcfg = rconfigs.get_reduced("xlstm-125m")
    pcfg = pconfigs.get_reduced("xlstm-125m")
    tree = jax.tree.map(np.asarray, rlm.init_params(rcfg, jax.random.key(0)))
    return rcfg, pcfg, tree["groups"]


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _compare(r_apply, p_apply, rp, pcfg, rcfg, shape, seed=0):
    """Outputs and input gradients of one block, reference vs port."""
    x = _x(shape, seed)
    g = _x(shape, seed + 1)

    def f(xj):
        y, _ = r_apply(rp, xj, rcfg, NO_SHARD)
        return jnp.sum(y * g), y

    (_, y_ref), dx_ref = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    pp = _to_torch(rp)
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    y, _ = p_apply(pp, xt, pcfg, None)
    (dx,) = torch.autograd.grad(y, (xt,), torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               atol=2e-5)
    dx_ref = np.asarray(dx_ref)
    np.testing.assert_allclose(dx.numpy(), dx_ref,
                               atol=1e-4 * np.abs(dx_ref).max())


def test_mlstm_matches_the_reference(xlstm):
    rcfg, pcfg, groups = xlstm
    mp = jax.tree.map(lambda a: a[1, 2], groups["mlstm"])
    _compare(rssm.mlstm_apply, pssm.mlstm_apply, mp, pcfg, rcfg,
             (2, 24, rcfg.d_model))


def test_mlstm_past_one_chunk_has_the_outputs_and_a_finite_gradient(xlstm):
    """At T = 130 (a full chunk of 128 and a padded one) the forget gates
    of these weights sum to below -88 inside a chunk.  The reference's XLA
    twin takes ``exp(b_t - b_s)`` before masking the s > t entries with
    ``jnp.where``, so those overflow to inf and the masked branch's
    gradient is 0 × inf = NaN; its forward is unharmed.  The port selects
    before the exp: same outputs, a finite gradient (ROADMAP Queue 3)."""
    rcfg, pcfg, groups = xlstm
    mp = jax.tree.map(lambda a: a[1, 2], groups["mlstm"])
    x, g = _x((2, 130, rcfg.d_model)), _x((2, 130, rcfg.d_model), 1)

    def f(xj):
        y, _ = rssm.mlstm_apply(mp, xj, rcfg, NO_SHARD)
        return jnp.sum(y * g), y

    (_, y_ref), dx_ref = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    assert np.isnan(np.asarray(dx_ref)).any()  # the reference's fault
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    y, _ = pssm.mlstm_apply(_to_torch(mp), xt, pcfg, None)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               atol=2e-5)
    (dx,) = torch.autograd.grad(y, (xt,), torch.from_numpy(g))
    assert bool(torch.isfinite(dx).all())


def test_slstm_matches_the_reference(xlstm):
    rcfg, pcfg, groups = xlstm
    sp = jax.tree.map(lambda a: a[0], groups["slstm"])
    _compare(rssm.slstm_apply, pssm.slstm_apply, sp, pcfg, rcfg,
             (2, 20, rcfg.d_model), seed=3)


def test_ssd_matches_the_reference():
    rcfg = rconfigs.get_reduced("hymba-1.5b")
    pcfg = pconfigs.get_reduced("hymba-1.5b")
    sp = jax.tree.map(np.asarray, rssm.ssd_init(jax.random.key(1), rcfg))
    # the reference initialises A_log and dt_bias to 0: move them off it
    rng = np.random.default_rng(7)
    sp["A_log"] = (rng.normal(size=sp["A_log"].shape) * 0.5).astype(np.float32)
    sp["dt_bias"] = (rng.normal(size=sp["dt_bias"].shape) * 0.5).astype(np.float32)
    _compare(rssm.ssd_apply, pssm.ssd_apply, sp, pcfg, rcfg,
             (2, 40, rcfg.d_model), seed=5)


def test_conv1d_and_gates_match_the_reference():
    w = {"w": _x((4, 6))}
    x = _x((2, 9, 6), seed=1)
    y_ref, tail_ref = rssm.conv1d_apply(w, jnp.asarray(x))
    y, tail = pssm.conv1d_apply(_to_torch(w), torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-6)
    np.testing.assert_array_equal(tail.numpy(), np.asarray(tail_ref))
    pre = _x((2, 7, 8), seed=2) * 4
    for a, b in zip(pssm._mlstm_gates(torch.from_numpy(pre), 4),
                    rssm._mlstm_gates(jnp.asarray(pre), 4)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_init_shapes_are_the_references(xlstm):
    rcfg, pcfg, groups = xlstm
    g = torch.Generator().manual_seed(0)
    for init, ref_tree in ((pssm.mlstm_init, jax.tree.map(lambda a: a[0, 0], groups["mlstm"])),
                           (pssm.slstm_init, jax.tree.map(lambda a: a[0], groups["slstm"]))):
        got = jax.tree.map(lambda t: tuple(t.shape), init(g, pcfg, "cpu"))
        assert got == jax.tree.map(lambda a: tuple(a.shape), ref_tree)
    hcfg = pconfigs.get_reduced("hymba-1.5b")
    got = {k: tuple(v.shape) for k, v in pssm.ssd_init(g, hcfg, "cpu").items()
           if not isinstance(v, dict)}
    want = jax.eval_shape(lambda: rssm.ssd_init(jax.random.key(0),
                                                rconfigs.get_reduced("hymba-1.5b")))
    assert got == {k: tuple(v.shape) for k, v in want.items()
                   if not isinstance(v, dict)}


def test_decode_branches_raise(xlstm):
    rcfg, pcfg, groups = xlstm
    x = torch.zeros((1, 1, pcfg.d_model))
    mp = _to_torch(jax.tree.map(lambda a: a[0, 0], groups["mlstm"]))
    sp = _to_torch(jax.tree.map(lambda a: a[0], groups["slstm"]))
    for call in (lambda: pssm.mlstm_apply(mp, x, pcfg, None, state={}),
                 lambda: pssm.slstm_apply(sp, x, pcfg, None, state=()),
                 lambda: pssm.mlstm_init_state(pcfg, 1),
                 lambda: pssm.slstm_init_state(pcfg, 1),
                 lambda: pssm.ssd_init_state(pcfg, 1),
                 lambda: pssm.conv1d_apply(mp["conv"], x, state=x)):
        with pytest.raises(NotImplementedError, match="Queue 1, item 14"):
            call()

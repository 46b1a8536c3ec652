"""The port's training path against the JAX package's on ``TINY`` of
tests/test_training.py: ``xla`` mode for 5 steps from the reference's own
initial weights gives the reference's losses (within 1e-4) and parameters
(within 2e-4, the reference's bound); first-step gradients match
``jax.grad`` (atol 1e-5); the port's ``fmi`` mode at world 2 and 4 matches
its ``xla`` mode within 5e-3 (tests/test_multidevice.py's cross-mode
bound), recursive doubling matches ring within 1e-4, int8 compression
trains; microbatching agrees with one batch; ``synthetic_batch`` arrays
are the reference's; and the launcher runs and refuses what is not
ported.  The ssm family (``X_TINY``: xlstm-125m cut to one group of 3
mLSTM blocks and an sLSTM block at width 64) is held to the same bounds:
xla mode against the reference, first-step gradients against ``jax.grad``,
fmi against xla, int8 trains, the launcher trains.  Its sequences stay
within one 128-step chunk, where the reference's gradient is finite (see
tests/test_torch_ssm.py); past one chunk the scan's gradients are held
against ``jax.grad`` of the per-step oracle instead, in
tests/test_torch_gla_scan.py
(``test_plain_vs_jax_grad_of_the_per_step_oracle_past_one_chunk``)."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import compat  # noqa: E402
from repro import configs as rconfigs  # noqa: E402
from repro.data import pipeline as rdata  # noqa: E402
from repro.launch.mesh import make_host_mesh as r_mesh  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models.layers import NO_SHARD  # noqa: E402
from repro.optim.optimizer import OptConfig as ROpt  # noqa: E402
from repro.training import train_step as rts  # noqa: E402
from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.data import pipeline as pdata  # noqa: E402
from repro_torch.launch import train as ptrain  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh as p_mesh  # noqa: E402
from repro_torch.models import lm as plm  # noqa: E402
from repro_torch.optim.optimizer import OptConfig as POpt  # noqa: E402
from repro_torch.training import train_step as pts  # noqa: E402

TINY_KW = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
               vocab_size=256, head_dim=16)
R_TINY = rconfigs.get_reduced("llama3_2_1b", **TINY_KW)
P_TINY = pconfigs.get_reduced("llama3_2_1b", **TINY_KW)
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10, clip_norm=0.0)
X_KW = dict(n_layers=4, d_model=64, n_heads=4, vocab_size=256)
R_XTINY = rconfigs.get_reduced("xlstm-125m", **X_KW)
P_XTINY = pconfigs.get_reduced("xlstm-125m", **X_KW)


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
def ref_tree():
    return jax.tree.map(np.asarray, rlm.init_params(R_TINY, jax.random.key(0)))


def _port_params(model) -> dict:
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def _ref_leaf(tree, name):
    path = plm.reference_path(name)
    node = tree
    for k in path[:-1] if path[0] == "groups" else path:
        node = node[k]
    return np.asarray(node[path[-1]] if path[0] == "groups" else node)


@pytest.fixture(scope="module")
def xlstm_tree():
    return jax.tree.map(np.asarray, rlm.init_params(R_XTINY, jax.random.key(0)))


@pytest.fixture(scope="module")
def xlstm_port_xla(xlstm_tree):
    return _port_run(xlstm_tree, 3, pcfg=P_XTINY, mode="xla")


def _ref_run(tree, steps, batch=8, seq=32, rcfg=R_TINY, **opt):
    tcfg = rts.TrainConfig(mode="xla", optimizer=ROpt(**(opt or OPT)),
                           donate=False)
    mesh = r_mesh(1, 1)
    step_fn, _, _ = rts.make_train_step(rcfg, tcfg, mesh, False)
    dcfg = rdata.DataConfig()
    with compat.set_mesh(mesh):
        params = jax.tree.map(jnp.asarray, tree)
        opt_state = rts.init_opt_state(rcfg, tcfg, params)
        losses = []
        for s in range(steps):
            b = jax.tree.map(jnp.asarray,
                             rdata.synthetic_batch(dcfg, rcfg, batch, seq, s))
            params, opt_state, m = step_fn(params, opt_state, b)
            losses.append((float(m["loss"]), float(m["ce"])))
    return losses, jax.tree.map(np.asarray, params)


def _port_run(tree, steps, batch=8, seq=32, opt=None, mesh=(1, 1),
              pcfg=P_TINY, **tkw):
    tcfg = pts.TrainConfig(optimizer=POpt(**(opt or OPT)), **tkw)
    step_fn, _, _ = pts.make_train_step(pcfg, tcfg, p_mesh(*mesh),
                                        device="cpu")
    model = plm.params_from_reference(tree, pcfg, device="cpu")
    opt_state = pts.init_opt_state(pcfg, tcfg, model)
    dcfg = pdata.DataConfig()
    losses = []
    for s in range(steps):
        b = pdata.synthetic_batch(dcfg, pcfg, batch, seq, s)
        model, opt_state, m = step_fn(model, opt_state, b)
        losses.append((float(m["loss"]), float(m["ce"])))
    return losses, _port_params(model)


def _max_dparam(a: dict, b: dict) -> float:
    return max(float(np.abs(a[n] - b[n]).max()) for n in a)


@pytest.fixture(scope="module")
def port_xla(ref_tree):
    return _port_run(ref_tree, 3, mode="xla")


def test_xla_mode_matches_the_reference(ref_tree):
    want_losses, want_params = _ref_run(ref_tree, 5)
    got_losses, got_params = _port_run(ref_tree, 5, mode="xla")
    np.testing.assert_allclose(np.array(got_losses), np.array(want_losses),
                               atol=1e-4)
    d = max(float(np.abs(p - _ref_leaf(want_params, n)).max())
            for n, p in got_params.items())
    assert d < 2e-4, d  # tests/test_training.py:64


def test_first_step_gradients_match_jax_grad(ref_tree):
    b = rdata.synthetic_batch(rdata.DataConfig(), R_TINY, 4, 32, 0)
    jb = jax.tree.map(jnp.asarray, b)

    def loss(p):
        return rts._loss(p, R_TINY, NO_SHARD, jb)[0]

    want = jax.tree.map(np.asarray, jax.grad(loss)(jax.tree.map(jnp.asarray,
                                                                ref_tree)))
    model = plm.params_from_reference(ref_tree, P_TINY, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    loss_p, ce_p, grads = pts._grad_accum(model, P_TINY, None, tb, 1)
    np.testing.assert_allclose(float(loss_p), float(loss(jax.tree.map(
        jnp.asarray, ref_tree))), rtol=1e-5)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), _ref_leaf(want, n), atol=1e-5,
                                   err_msg=n)


@pytest.mark.parametrize("world", [2, 4])
def test_fmi_mode_matches_xla_mode(ref_tree, port_xla, world):
    l_xla, p_xla = port_xla
    l_fmi, p_fmi = _port_run(ref_tree, 3, mode="fmi", allreduce="ring",
                             mesh=(world, 1))
    assert max(abs(a[0] - b[0]) for a, b in zip(l_xla, l_fmi)) < 5e-3
    assert _max_dparam(p_xla, p_fmi) < 5e-3


def test_fmi_pure_dp_over_both_mesh_axes(ref_tree, port_xla):
    """llama3.2-1b plans pure DP: a (2, 2) mesh is 4 data ranks."""
    l_fmi, p_fmi = _port_run(ref_tree, 3, mode="fmi", allreduce="ring",
                             mesh=(2, 2))
    assert _max_dparam(port_xla[1], p_fmi) < 5e-3


def test_recursive_doubling_matches_ring(ref_tree):
    l_ring, p_ring = _port_run(ref_tree, 3, mode="fmi", allreduce="ring",
                               mesh=(4, 1))
    l_rd, p_rd = _port_run(ref_tree, 3, mode="fmi",
                           allreduce="recursive_doubling", mesh=(4, 1))
    assert max(abs(a[0] - b[0]) for a, b in zip(l_ring, l_rd)) < 1e-4
    assert _max_dparam(p_ring, p_rd) < 1e-4


def test_int8_compressed_sync_trains(ref_tree):
    losses, _ = _port_run(ref_tree, 6, mode="fmi", compression="int8",
                          mesh=(4, 1))
    loss = [a for a, _ in losses]
    assert np.isfinite(loss).all()
    assert loss[-1] < loss[0] + 0.05  # tests/test_multidevice.py:156


def test_grad_accum_matches_single_batch(ref_tree):
    """tests/test_training.py:46 on the port."""
    l1, p1 = _port_run(ref_tree, 1, mode="xla", microbatches=1)
    l4, p4 = _port_run(ref_tree, 1, mode="xla", microbatches=4)
    assert abs(l1[0][0] - l4[0][0]) < 2e-2
    assert _max_dparam(p1, p4) < 2e-4


@pytest.mark.parametrize("arch", ["llama3.2-1b", "hubert-xlarge",
                                  "llama-3.2-vision-90b"])
@pytest.mark.parametrize("step,rank", [(0, 0), (3, 1)])
def test_synthetic_batch_is_the_references(arch, step, rank):
    rc, pc = rconfigs.get_reduced(arch), pconfigs.get_reduced(arch)
    for seed in (1234, 7):
        want = rdata.synthetic_batch(rdata.DataConfig(seed=seed), rc, 3, 80,
                                     step, rank)
        got = pdata.synthetic_batch(pdata.DataConfig(seed=seed), pc, 3, 80,
                                    step, rank)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("kw,match", [
    (dict(mode="fmi", zero1=True), "ZeRO-1"),
    (dict(mode="fmi", hierarchical=True), "hierarchical"),
    (dict(mode="fmi", schedule="bucketed"), "bucketed"),
])
def test_train_step_refuses_what_is_not_ported(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        pts.make_train_step(P_TINY, pts.TrainConfig(**kw), p_mesh(2, 1),
                            device="cpu")


def test_xlstm_xla_mode_matches_the_reference(xlstm_tree, xlstm_port_xla):
    """Losses within 1e-4 (they agree to 1e-6).  Parameters: AdamW scales
    every gradient entry to about ±lr whatever its size, so an entry whose
    gradient is near zero, where the two float32 sums differ relatively
    most, may move by up to ~lr either way: one entry in 16384 of one
    mLSTM ``wv`` differs by 3.5e-4 after 3 steps.  So at most one entry in
    10^4 may exceed the dense bound of 2e-4 (tests/test_training.py:64),
    and none may exceed 3 × lr."""
    want_losses, want_params = _ref_run(xlstm_tree, 3, rcfg=R_XTINY)
    got_losses, got_params = xlstm_port_xla
    np.testing.assert_allclose(np.array(got_losses), np.array(want_losses),
                               atol=1e-4)
    d = np.concatenate([np.abs(p - _ref_leaf(want_params, n)).ravel()
                        for n, p in got_params.items()])
    assert d.max() < 3 * OPT["lr"], d.max()
    assert (d >= 2e-4).mean() <= 1e-4, (d >= 2e-4).sum()


def test_xlstm_first_step_gradients_match_jax_grad(xlstm_tree):
    """Within 2e-5 × max(1, max|ref|) per leaf: the embedding's gradient
    reaches 1.25 here and differs from ``jax.grad`` by 1.4e-5 (float32
    rounding, 1.1e-5 relative); every other leaf's is below 1.5e-5
    relative."""
    b = rdata.synthetic_batch(rdata.DataConfig(), R_XTINY, 4, 32, 0)
    jb = jax.tree.map(jnp.asarray, b)

    def loss(p):
        return rts._loss(p, R_XTINY, NO_SHARD, jb)[0]

    want = jax.tree.map(np.asarray, jax.grad(loss)(jax.tree.map(jnp.asarray,
                                                                xlstm_tree)))
    model = plm.params_from_reference(xlstm_tree, P_XTINY, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    loss_p, _, grads = pts._grad_accum(model, P_XTINY, None, tb, 1)
    np.testing.assert_allclose(float(loss_p), float(loss(jax.tree.map(
        jnp.asarray, xlstm_tree))), rtol=1e-5)
    assert len(grads) == len(list(model.parameters()))
    for n, g in grads.items():
        ref_g = _ref_leaf(want, n)
        np.testing.assert_allclose(g.numpy(), ref_g, err_msg=n,
                                   atol=2e-5 * max(1.0, np.abs(ref_g).max()))


def _block(name: str) -> str:
    """The block a parameter belongs to: ``layers.<g>.mlstm.<i>``,
    ``layers.<g>.slstm``, else its first component."""
    m = re.match(r"(layers\.\d+\.(?:mlstm\.\d+|slstm))", name)
    return m[1] if m else name.split(".")[0]


def _block_gaps(a: dict, b: dict) -> dict:
    """||a - b|| / ||b|| over each block's parameters."""
    num, den = {}, {}
    for n in a:
        k = _block(n)
        num[k] = num.get(k, 0.0) + float(((a[n] - b[n]) ** 2).sum())
        den[k] = den.get(k, 0.0) + float((b[n] ** 2).sum())
    return {k: (num[k] / den[k]) ** 0.5 for k in num}


def test_xlstm_bf16_first_step_gradients_per_block(xlstm_tree):
    """bf16 compute, the reduced xlstm config, one chunk (T 64): the
    port's first-step gradients (plain scan) against ``jax.grad`` of the
    reference in bf16, block by block.  bf16 gradients of this model hold
    only to ~10-30%: the reference's own bf16 gradients differ from its
    f32 ones by 3.5e-2 (final norm) to 1.9e-1 (first mLSTM) of each
    block's norm.  The port's differ from the reference's bf16 ones by
    2.2e-2 to 1.9e-1, less than that in every block (bound: 0.25 of the
    block's norm, and no more than the reference's own bf16 gap), and the
    blocks' gradient norms agree within 1.8% (bound 5%).  So at this size
    the port's bf16 gradients are as close to the reference's as bf16
    allows; whether that holds at full depth past one chunk, where the
    scan routes' gradients spread (ROADMAP Queue 3, F1), this test
    cannot show."""
    grads = {}
    for dt in ("float32", "bfloat16"):
        rcfg = rconfigs.get_reduced("xlstm-125m", **X_KW, dtype=dt)
        pcfg = pconfigs.get_reduced("xlstm-125m", **X_KW, dtype=dt)
        b = rdata.synthetic_batch(rdata.DataConfig(), rcfg, 4, 64, 0)
        jb = jax.tree.map(jnp.asarray, b)
        want = jax.grad(lambda p: rts._loss(p, rcfg, NO_SHARD, jb)[0])(
            jax.tree.map(jnp.asarray, xlstm_tree))
        model = plm.params_from_reference(xlstm_tree, pcfg, device="cpu")
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        _, _, got = pts._grad_accum(model, pcfg, None, tb, 1)
        grads[dt] = ({n: g.float().numpy() for n, g in got.items()},
                     {n: _ref_leaf(want, n).astype(np.float32) for n in got})
    port16, ref16 = grads["bfloat16"]
    _, ref32 = grads["float32"]
    gap = _block_gaps(port16, ref16)
    own = _block_gaps(ref16, ref32)
    assert set(gap) == {"embed", "final_norm", "layers.0.mlstm.0",
                        "layers.0.mlstm.1", "layers.0.mlstm.2",
                        "layers.0.slstm"}
    for k in gap:
        assert gap[k] <= 0.25 and gap[k] <= own[k], (k, gap[k], own[k])
        norm = lambda g: sum(float((g[n] ** 2).sum()) for n in g  # noqa: E731
                             if _block(n) == k) ** 0.5
        assert abs(norm(port16) / norm(ref16) - 1) <= 0.05, k


@pytest.mark.parametrize("world", [2, 4])
def test_xlstm_fmi_mode_matches_xla_mode(xlstm_tree, xlstm_port_xla, world):
    l_xla, p_xla = xlstm_port_xla
    l_fmi, p_fmi = _port_run(xlstm_tree, 3, pcfg=P_XTINY, mode="fmi",
                             allreduce="ring", mesh=(world, 1))
    assert max(abs(a[0] - b[0]) for a, b in zip(l_xla, l_fmi)) < 5e-3
    assert _max_dparam(p_xla, p_fmi) < 5e-3


def test_xlstm_int8_compressed_sync_trains(xlstm_tree):
    losses, _ = _port_run(xlstm_tree, 6, pcfg=P_XTINY, mode="fmi",
                          compression="int8", mesh=(4, 1))
    loss = [a for a, _ in losses]
    assert np.isfinite(loss).all()
    assert loss[-1] < loss[0] + 0.05  # tests/test_multidevice.py:156


@pytest.mark.parametrize("flags", [[], ["--profile"]])
def test_launcher_trains_on_cpu(capsys, flags):
    hist = ptrain.main(["--arch", "llama3.2-1b", "--reduced", "--steps", "3",
                        "--batch", "4", "--seq", "32", "--mode", "fmi",
                        "--data-axis", "2", "--allreduce", "ring",
                        "--device", "cpu", *flags])
    out = capsys.readouterr().out
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert "step     2 loss" in out and "tok/s" in out and "done: 3 steps" in out
    # --profile traces the last step only
    assert out.count("profile: wall") == (1 if flags else 0)
    assert ("top host ops:" in out) == bool(flags)


def test_launcher_trains_xlstm_on_cpu(capsys):
    hist = ptrain.main(["--arch", "xlstm-125m", "--reduced", "--steps", "3",
                        "--batch", "4", "--seq", "32", "--mode", "fmi",
                        "--data-axis", "2", "--allreduce", "ring",
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert "xlstm-125m: 2107264 parameters, 8 layers" in out
    assert "done: 3 steps" in out


@pytest.mark.parametrize("flags", [["--zero1"], ["--schedule", "bucketed"],
                                   ["--elastic"], ["--kill-rank", "1"],
                                   ["--ckpt-dir", "ck"], ["--sanitize"]])
def test_launcher_refuses_unported_flags(flags):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ptrain.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
                     *flags])

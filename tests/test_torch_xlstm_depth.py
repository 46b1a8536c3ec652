"""xlstm-125m's first training step at its published depth, past one scan
chunk: the port's gradients against ``jax.grad`` of the reference.

The config is ``get_reduced("xlstm-125m", n_layers=12, d_model=64,
n_heads=4, vocab_size=256)`` in both packages (3 groups of 3 mLSTM blocks
and one sLSTM, as published), the batch ``synthetic_batch(DataConfig(),
cfg, 2, 256, 0)``: T 256 is two chunks of 128 of the mLSTM's scan.  Both
packages start from the same parameters (``lm.params_from_reference``).

The reference's own scan (``ops.gla_scan``, its chunked XLA twin on the
CPU) has a NaN gradient here: the model's forget gates sum below -88 within
a 128-step chunk (ROADMAP Queue 3, F2).  So the reference runs with its
scan replaced, through ``monkeypatch``, by its per-step oracle
``repro.kernels.ref.gla_scan``; and, to read how far the reference's step
moves under a mere change of summation order, by its XLA twin at chunks of
64 and 32 (finite: the gates sum to about -44 and -22 a chunk).  The port
runs as it is (the plain scan, chunks of 128).

Three things are held:

* f32: every leaf of the port's gradient lies within the larger of
  ``2e-5 x max(1, max|ref|)`` and twice the reference's own spread (the
  largest gap between its oracle run and its two chunked runs, per leaf).
  At this depth the reference does not meet 2e-5 against itself: its three
  scans give embedding gradients up to 1.39e-4 of max|ref| apart, and the
  embedding and seven leaves of the first block pass 2e-5.  The port's gap
  is 1.13e-4 at the embedding and at most 1.07x the reference's spread on
  the leaves past 2e-5 (1.72x at d_model 384 with 12 blocks, 1.70x at 768
  with 4: hence twice); everywhere else it is within 2e-5.  A plain gelu
  in place of the tanh one, or ten times the sLSTM FFN norm's epsilon,
  fail this check by 30x and 3x; the sLSTM's stabiliser started at 0
  instead of -1e30 fails it at the loss.
* bf16: one ulp planted in one element of every scan call's output (the
  same element and direction in both packages, from a numpy seed; the
  gradient passes through unchanged) moves each block's gradient by
  ``r = ||g_planted - g|| / ||g||``: 0.005-0.030 in the reference,
  0.007-0.049 in the port, within 1.81x of each other (bound: 2x; at
  d_model 384 with 12 blocks 0.04-0.14 and 0.045-0.10, within 1.5x).
* bf16 against f32: the port's bf16 gradient is no farther from the
  reference's f32 gradient than 1.5x the reference's own bf16 gradient is
  (seen: 0.43-0.96 against 0.45-0.88 of each block's norm, at most
  1.18x).  Against each other the two packages' bf16 gradients differ by
  0.55-0.80 of each block's norm: far more than one planted ulp moves
  either, because the two frameworks round bf16 at different places
  (XLA may keep excess precision inside fused ops; eager PyTorch rounds
  each op), and at this depth any such change moves a bf16 gradient by
  about its own size, as the reference's own bf16-vs-f32 gap shows.

Run with ``-s`` to print the per-block table.  ``python
tests/test_torch_xlstm_depth.py --d-model 768 --n-layers 4 --batch 1``
prints the same table at another size (``--help``).
"""

from __future__ import annotations

import argparse
import os
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as rconfigs  # noqa: E402
from repro.data import pipeline as rdata  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models.layers import NO_SHARD  # noqa: E402
from repro.training import train_step as rts  # noqa: E402
from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.kernels import ops as pops  # noqa: E402
from repro_torch.models import lm as plm  # noqa: E402
from repro_torch.training import train_step as pts  # noqa: E402

DEPTH_KW = dict(n_layers=12, d_model=64, n_heads=4, vocab_size=256)
BATCH, SEQ = 2, 256
PLANT_SEED = 17
F32_ATOL, SPREAD_FACTOR = 2e-5, 2.0
R_FACTOR, BF16_VS_F32_FACTOR = 2.0, 1.5
BLOCKS = ["embed", "final_norm"] + [
    f"layers.{g}.{b}" for g in range(3)
    for b in ("mlstm.0", "mlstm.1", "mlstm.2", "slstm")]


@pytest.fixture(autouse=True, scope="module")
def _torch_settings():
    threads = torch.get_num_threads()
    det = torch.are_deterministic_algorithms_enabled()
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    yield
    torch.set_num_threads(threads)
    torch.use_deterministic_algorithms(det)


def _plant():
    """The planted element, as a fraction of each output's flat length, and
    its direction (+1: one ulp up in the bit pattern, away from zero)."""
    rng = np.random.default_rng(PLANT_SEED)
    return float(rng.random()), int(rng.choice([-1, 1]))


def _ref_scan(kind: str, plant: bool):
    """A stand-in for ``repro.kernels.ops.gla_scan``: the per-step oracle
    (``kind == "oracle"``) or the XLA twin at chunks of ``int(kind)``,
    optionally with one bf16 ulp planted in its output."""
    frac, sign = _plant()

    def scan(q, k, v, log_f, i_gate, normalize=True, chunk=128,
             backend="auto"):
        if kind == "oracle":
            out, state = rref.gla_scan(q, k, v, log_f, i_gate, normalize), None
        else:
            out, state = rops._xla_gla_scan(q, k, v, log_f, i_gate, normalize,
                                            int(kind))
        if plant:
            bits = jax.lax.bitcast_convert_type(out, jnp.int16).reshape(-1)
            i = int(frac * bits.size)
            step = jnp.where((bits[i] & 0x7FFF) == 0, 1, sign).astype(jnp.int16)
            moved = jax.lax.bitcast_convert_type(
                bits.at[i].add(step).reshape(out.shape), out.dtype)
            out = out + jax.lax.stop_gradient(moved - out)
        return out, state

    return scan


def _port_scan(scan):
    """``scan`` (the port's ``ops.gla_scan``) with the same ulp planted."""
    frac, sign = _plant()

    def planted(q, k, v, log_f, i_gate, normalize=True, chunk=128):
        out, state = scan(q, k, v, log_f, i_gate, normalize, chunk)
        with torch.no_grad():
            moved = out.detach().contiguous().clone()
            flat = moved.view(torch.int16).view(-1)
            i = int(frac * flat.numel())
            flat[i] += 1 if int(flat[i]) & 0x7FFF == 0 else sign
        return out + (moved - out.detach()), state

    return planted


def _ref_leaf(tree, name):
    path = plm.reference_path(name)
    node = tree
    for k in path[:-1] if path[0] == "groups" else path:
        node = node[k]
    return np.asarray(node[path[-1]] if path[0] == "groups" else node,
                      np.float32)


def _block(name: str) -> str:
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


def first_steps(d_model=64, n_layers=12, batch=BATCH, seq=SEQ) -> dict:
    """First-step gradients of both packages at one size, as ``{run:
    {leaf: f32 array}}``: ``ref32`` (the oracle scan), ``ref32_c64`` and
    ``ref32_c32`` (the XLA twin at chunks of 64 and 32), ``port32``; in
    bf16 ``ref16``, ``ref16_planted``, ``port16``, ``port16_planted``.
    Also ``loss`` (f32, both packages) and ``seconds`` for each run."""
    kw = dict(DEPTH_KW, d_model=d_model, n_layers=n_layers)
    tree = jax.tree.map(np.asarray, rlm.init_params(
        rconfigs.get_reduced("xlstm-125m", **kw), jax.random.key(0)))
    out = {"seconds": {}, "loss": {}}
    with pytest.MonkeyPatch.context() as mp:
        for dt, runs in (("float32", (("ref32", "oracle", False),
                                      ("ref32_c64", "64", False),
                                      ("ref32_c32", "32", False),
                                      ("port32", None, False))),
                         ("bfloat16", (("ref16", "oracle", False),
                                       ("ref16_planted", "oracle", True),
                                       ("port16", None, False),
                                       ("port16_planted", None, True)))):
            rcfg = rconfigs.get_reduced("xlstm-125m", **kw, dtype=dt)
            pcfg = pconfigs.get_reduced("xlstm-125m", **kw, dtype=dt)
            b = rdata.synthetic_batch(rdata.DataConfig(), rcfg, batch, seq, 0)
            jb = jax.tree.map(jnp.asarray, b)
            tb = {k: torch.from_numpy(v) for k, v in b.items()}
            for name, kind, plant in runs:
                t0 = time.perf_counter()
                model = plm.params_from_reference(tree, pcfg, device="cpu")
                if kind is not None:
                    mp.setattr(rops, "gla_scan", _ref_scan(kind, plant))
                    jax.clear_caches()  # else a cached trace keeps the old scan
                    loss, g = jax.value_and_grad(
                        lambda p: rts._loss(p, rcfg, NO_SHARD, jb)[0])(
                        jax.tree.map(jnp.asarray, tree))
                    out[name] = {n: _ref_leaf(g, n)
                                 for n, _ in model.named_parameters()}
                else:
                    scan = pops.gla_scan
                    if plant:
                        mp.setattr(pops, "gla_scan", _port_scan(scan))
                    loss, _, g = pts._grad_accum(model, pcfg, None, tb, 1)
                    mp.setattr(pops, "gla_scan", scan)
                    out[name] = {n: t.float().numpy() for n, t in g.items()}
                out["seconds"][name] = time.perf_counter() - t0
                out["loss"][name] = float(loss)
    return out


def f32_table(runs: dict) -> dict:
    """Per leaf: the port's gap to the reference and the reference's own
    spread, both as max|difference| / max(1, max|ref|)."""
    ref = runs["ref32"]
    rows = {}
    for n, g in runs["port32"].items():
        scale = max(1.0, float(np.abs(ref[n]).max()))
        spread = max(float(np.abs(runs[k][n] - ref[n]).max())
                     for k in ("ref32_c64", "ref32_c32"))
        rows[n] = (float(np.abs(g - ref[n]).max()) / scale, spread / scale)
    return rows


def bf16_table(runs: dict) -> dict:
    """Per block: ``r`` of each package (planted against unplanted), the
    packages' bf16 gap, and each package's bf16 gradient against the
    reference's f32 one, all as ||a - b|| / ||b||."""
    cols = (_block_gaps(runs["ref16_planted"], runs["ref16"]),
            _block_gaps(runs["port16_planted"], runs["port16"]),
            _block_gaps(runs["port16"], runs["ref16"]),
            _block_gaps(runs["ref16"], runs["ref32"]),
            _block_gaps(runs["port16"], runs["ref32"]))
    return {k: tuple(c[k] for c in cols) for k in cols[0]}


def report(runs: dict) -> str:
    lines = ["f32 leaves above 2e-5 (port gap, reference spread; of "
             "max(1, max|ref|)):"]
    for n, (gap, spread) in f32_table(runs).items():
        if max(gap, spread) > F32_ATOL:
            lines.append(f"  {n:32s} {gap:.3e} {spread:.3e}")
    lines.append(f"{'block':18s} {'r ref':>9s} {'r port':>9s} "
                 f"{'port-ref16':>10s} {'ref16-ref32':>11s} "
                 f"{'port16-ref32':>12s}")
    for k, row in bf16_table(runs).items():
        lines.append(f"{k:18s} " + " ".join(
            f"{v:{w}.3e}" for v, w in zip(row, (9, 9, 10, 11, 12))))
    lines.append("seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in runs["seconds"].items()))
    return "\n".join(lines)


@pytest.fixture(scope="module")
def runs():
    r = first_steps()
    print("\n" + report(r))
    return r


def test_f32_gradients_at_depth_match_the_reference(runs):
    np.testing.assert_allclose(runs["loss"]["port32"], runs["loss"]["ref32"],
                               rtol=1e-5)
    table = f32_table(runs)
    assert len(table) == len(runs["ref32"])
    assert {_block(n) for n in table} == set(BLOCKS)
    for n, (gap, spread) in table.items():
        assert np.isfinite(gap) and gap <= max(F32_ATOL,
                                               SPREAD_FACTOR * spread), (
            n, gap, spread)


def test_reference_f32_spread_at_depth_exceeds_the_shallow_bound(runs):
    """Why the bound above is not 2e-5 alone: the reference against itself
    (oracle against chunked scans) misses it at the embedding."""
    gap, spread = f32_table(runs)["embed"]
    assert spread > F32_ATOL and gap > F32_ATOL


def test_bf16_planted_ulp_moves_both_packages_alike(runs):
    table = bf16_table(runs)
    assert set(table) == set(BLOCKS)
    for k, (r_ref, r_port, *_) in table.items():
        assert 0 < r_ref and 0 < r_port, k
        assert r_port <= R_FACTOR * r_ref and r_ref <= R_FACTOR * r_port, (
            k, r_ref, r_port)


def test_bf16_gradients_as_near_f32_as_the_reference(runs):
    for k, (_, _, _, ref_vs_f32, port_vs_f32) in bf16_table(runs).items():
        assert port_vs_f32 <= BF16_VS_F32_FACTOR * ref_vs_f32, (
            k, port_vs_f32, ref_vs_f32)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=(
        "Print the per-leaf f32 and per-block bf16 table of both packages' "
        "first xlstm-125m step at one size (CPU)."))
    ap.add_argument("--d-model", type=int, default=DEPTH_KW["d_model"])
    ap.add_argument("--n-layers", type=int, default=DEPTH_KW["n_layers"])
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--seq", type=int, default=SEQ)
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    t0 = time.perf_counter()
    r = first_steps(a.d_model, a.n_layers, a.batch, a.seq)
    print(f"xlstm-125m d_model {a.d_model}, {a.n_layers} blocks, batch "
          f"{a.batch}, T {a.seq}; loss ref {r['loss']['ref32']:.6f}, port "
          f"{r['loss']['port32']:.6f}")
    print(report(r))
    print(f"total {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main()

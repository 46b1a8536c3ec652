"""The port's LM (dense and ssm families) against the JAX package's
``repro.models.lm``: the reference's own initial weights converted with
``params_from_reference`` (never re-drawn) give the same logits (atol
1e-4) and the same loss and ce (rtol 1e-5) on the reduced llama3.2-1b,
qwen3-1.7b (``qk_norm``) and xlstm-125m, in f32 and, at a bf16
tolerance, in the full configs' bf16 compute; ``count_params`` agrees at
full size; and the AdamW decay set is the reference's: every leaf of its
stacked tree with ``ndim >= 2``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as rconfigs  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models.layers import NO_SHARD  # noqa: E402
from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.models import lm as plm  # noqa: E402

ARCHS = ["llama3.2-1b", "qwen3-1.7b"]
LM_ARCHS = ARCHS + ["xlstm-125m"]
DENSE = ["llama3.2-1b", "qwen3-1.7b", "yi-6b", "granite-3-8b"]


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


def _pair(arch, **over):
    rcfg = rconfigs.get_reduced(arch, **over)
    pcfg = pconfigs.get_reduced(arch, **over)
    tree = jax.tree.map(np.asarray, rlm.init_params(rcfg, jax.random.key(0)))
    return rcfg, pcfg, tree


def _batch(cfg, B=2, T=24, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:].copy()


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def test_configs_are_the_reference_configs():
    for name in rconfigs.ARCH_IDS:
        r, p = rconfigs.get(name), pconfigs.get(name)
        assert r.name == p.name and r.family == p.family
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab_size", "head_dim", "qk_norm", "causal",
                  "sliding_window", "rope_theta", "tie_embeddings", "norm_eps",
                  "dtype", "param_dtype", "remat"):
            assert getattr(r, f) == getattr(p, f), (name, f)
        assert (r.hd, r.group_size, r.n_groups) == (p.hd, p.group_size,
                                                    p.n_groups)
        rr, pr = r.reduced(), p.reduced()
        assert (rr.d_model, rr.n_layers, rr.vocab_size, rr.dtype) == \
            (pr.d_model, pr.n_layers, pr.vocab_size, pr.dtype)


def _n_stacked(path, a) -> int:
    """Port leaves a reference leaf splits into: one per entry of its stack
    axes (the group axis; the mLSTM's block axis too)."""
    if path[0] != "groups":
        return 1
    return a.shape[0] * (a.shape[1] if path[1] == "mlstm" else 1)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_params_from_reference_copies_every_leaf(arch):
    rcfg, pcfg, tree = _pair(arch)
    model = plm.params_from_reference(tree, pcfg, device="cpu")
    ref = {path: a for path, a in _leaves(tree)}
    got = dict(model.named_parameters())
    assert len(got) == sum(_n_stacked(path, a) for path, a in ref.items())
    for name, p in got.items():
        path = plm.reference_path(name)
        if path[0] == "groups":
            want = ref[path[:-1]][path[-1]]
        else:
            want = ref[path]
        np.testing.assert_array_equal(p.detach().numpy(), want, err_msg=name)
    if pcfg.qk_norm:
        assert "layers.0.attn.q_norm" in got
    if pcfg.family == "ssm":
        assert "layers.1.mlstm.2.conv.w" in got and "layers.1.slstm.r" in got


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_logits_loss_and_ce_match_the_reference(arch):
    rcfg, pcfg, tree = _pair(arch)
    model = plm.params_from_reference(tree, pcfg, device="cpu")
    toks, labels = _batch(pcfg)
    logits_r, aux_r, _ = rlm.forward(tree, rcfg, NO_SHARD,
                                     {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        logits_p, aux_p, _ = plm.forward(model, pcfg, None,
                                         {"tokens": torch.from_numpy(toks)})
    assert tuple(logits_p.shape) == logits_r.shape
    np.testing.assert_allclose(logits_p.numpy(), np.asarray(logits_r), atol=1e-4)
    loss_r, ce_r = rlm.loss_fn(logits_r, jnp.asarray(labels), rcfg, aux_r)
    loss_p, ce_p = plm.loss_fn(logits_p, torch.from_numpy(labels), pcfg, aux_p)
    np.testing.assert_allclose(float(loss_p), float(loss_r), rtol=1e-5)
    np.testing.assert_allclose(float(ce_p), float(ce_r), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_loss_and_ce_match_the_reference(arch):
    """The full configs' precision: bf16 compute over f32 parameters, with
    rmsnorm, SiLU, rope and the loss in f32.  Both packages round to bf16
    in different orders, so single logits differ by up to about one bf16
    ulp (8.8e-3 at |logit| < 1); the mean difference is 1.5e-3, and
    computing rmsnorm in bf16 instead raises it to 2.3e-3."""
    rcfg, pcfg, tree = _pair(arch, dtype="bfloat16")
    model = plm.params_from_reference(tree, pcfg, device="cpu")
    toks, labels = _batch(pcfg)
    logits_r, aux_r, _ = rlm.forward(tree, rcfg, NO_SHARD,
                                     {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        logits_p, aux_p, _ = plm.forward(model, pcfg, None,
                                         {"tokens": torch.from_numpy(toks)})
    assert logits_r.dtype == jnp.bfloat16 and logits_p.dtype == torch.bfloat16
    diff = np.abs(logits_p.float().numpy() - np.asarray(logits_r, np.float32))
    assert diff.max() <= 1.2e-2 and diff.mean() <= 2e-3, (diff.max(),
                                                          diff.mean())
    loss_r, ce_r = rlm.loss_fn(logits_r, jnp.asarray(labels), rcfg, aux_r)
    loss_p, ce_p = plm.loss_fn(logits_p, torch.from_numpy(labels), pcfg, aux_p)
    np.testing.assert_allclose(float(loss_p), float(loss_r), rtol=1e-4)
    np.testing.assert_allclose(float(ce_p), float(ce_r), rtol=1e-4)


def test_xlstm_bf16_logits_loss_and_ce_match_the_reference():
    """xlstm-125m in bf16 compute.  One block differs from the reference
    by at most one bf16 ulp (tests/test_torch_ssm.py holds each in f32);
    the 8 residual blocks carry those flips forward, growing from 4e-3 after
    the first block to 0.28 after the eighth (|x| up to 6.7), so single
    logits differ by up to 0.22 (mean 0.014) while loss and ce agree within
    4e-4 relative."""
    rcfg, pcfg, tree = _pair("xlstm-125m", dtype="bfloat16")
    model = plm.params_from_reference(tree, pcfg, device="cpu")
    toks, labels = _batch(pcfg)
    logits_r, aux_r, _ = rlm.forward(tree, rcfg, NO_SHARD,
                                     {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        logits_p, aux_p, _ = plm.forward(model, pcfg, None,
                                         {"tokens": torch.from_numpy(toks)})
    assert logits_p.dtype == torch.bfloat16
    diff = np.abs(logits_p.float().numpy() - np.asarray(logits_r, np.float32))
    assert diff.max() <= 0.3 and diff.mean() <= 2e-2, (diff.max(),
                                                       diff.mean())
    loss_r, ce_r = rlm.loss_fn(logits_r, jnp.asarray(labels), rcfg, aux_r)
    loss_p, ce_p = plm.loss_fn(logits_p, torch.from_numpy(labels), pcfg, aux_p)
    np.testing.assert_allclose(float(loss_p), float(loss_r), rtol=1e-3)
    np.testing.assert_allclose(float(ce_p), float(ce_r), rtol=1e-3)


def test_loss_chunks_and_label_masking_match_the_reference():
    """Several 512-token chunks, masked labels, padded vocab."""
    rcfg, pcfg, _ = _pair("llama3.2-1b", vocab_size=300)
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 1024, 384)).astype(np.float32) * 3
    labels = rng.integers(-1, 300, (2, 1024)).astype(np.int32)
    want = rlm.loss_fn(jnp.asarray(logits), jnp.asarray(labels), rcfg)
    got = plm.loss_fn(torch.from_numpy(logits), torch.from_numpy(labels), pcfg)
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)


@pytest.mark.parametrize("arch", DENSE + ["xlstm-125m"])
def test_count_params_matches_the_reference(arch):
    assert plm.count_params(pconfigs.get(arch)) == rlm.count_params(rconfigs.get(arch))
    assert plm.count_params(pconfigs.get_reduced(arch)) == \
        rlm.count_params(rconfigs.get_reduced(arch))


def test_llama_1b_parameter_count():
    assert plm.count_params(pconfigs.get("llama3.2-1b")) == 1_235_814_400


def test_xlstm_125m_parameter_count():
    assert plm.count_params(pconfigs.get("xlstm-125m")) == 147_942_912


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decayed_leaves_are_the_references(arch):
    """The reference decays ``p.ndim >= 2`` of its stacked tree: per-layer
    norms (stacked to [G, D], the mLSTM's to [G, 3, D]) are decayed,
    ``final_norm`` is not."""
    rcfg, pcfg, tree = _pair(arch)
    want = {path for path, a in _leaves(tree) if a.ndim >= 2}
    model = plm.params_from_reference(tree, pcfg, device="cpu")
    got = set()
    for name, p in model.named_parameters():
        path = plm.reference_path(name)
        key = path[:-1] if path[0] == "groups" else path
        if plm.decayed(name, p):
            got.add(key)
        else:
            assert key not in want, name
    assert got == want
    norm = ("groups", "mlstm", "norm") if pcfg.family == "ssm" else \
        ("groups", "ln1")
    assert norm in got and ("final_norm",) not in got


def test_other_families_raise():
    for arch in ("deepseek-v2-236b", "hymba-1.5b", "hubert-xlarge",
                 "llama-3.2-vision-90b"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            plm.init_params(pconfigs.get_reduced(arch), device="cpu")


def test_init_params_draws_seeded_reference_shaped_weights():
    pcfg = pconfigs.get_reduced("llama3.2-1b")
    a = plm.init_params(pcfg, seed=3, device="cpu")
    b = plm.init_params(pcfg, seed=3, device="cpu")
    shapes = {n: tuple(p.shape) for n, p in a.named_parameters()}
    for n, p in b.named_parameters():
        assert torch.equal(p, dict(a.named_parameters())[n])
    _, _, tree = _pair("llama3.2-1b")
    ref = dict(_leaves(tree))
    for n, s in shapes.items():
        path = plm.reference_path(n)
        want = ref[path[:-1]].shape[1:] if path[0] == "groups" else ref[path].shape
        assert s == tuple(want), n
    w = a.layers[0].attn["wq"].detach()
    assert float(w.abs().max()) <= 3 * pcfg.d_model**-0.5 + 1e-6


def test_xlstm_init_params_draws_seeded_reference_shaped_weights():
    pcfg = pconfigs.get_reduced("xlstm-125m")
    a = plm.init_params(pcfg, seed=3, device="cpu")
    b = plm.init_params(pcfg, seed=3, device="cpu")
    pa = dict(a.named_parameters())
    for n, p in b.named_parameters():
        assert torch.equal(p, pa[n])
    _, _, tree = _pair("xlstm-125m")
    ref = dict(_leaves(tree))
    for n, p in pa.items():
        path = plm.reference_path(n)
        if path[0] == "groups":
            want = ref[path[:-1]].shape[2 if path[1] == "mlstm" else 1:]
        else:
            want = ref[path].shape
        assert tuple(p.shape) == tuple(want), n
    assert len(a.layers) == pcfg.n_groups == 2
    assert len(a.layers[0].mlstm) == pcfg.ssm.slstm_every - 1

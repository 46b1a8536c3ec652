"""The port's framework-free planning layer against the JAX package's: the
selector's tables and picks, the channel registry and the pricing model
are copies, so their outputs must be string-equal on the same inputs."""

from dataclasses import asdict

import pytest

pytest.importorskip("torch")

from repro.core import channels as RCH  # noqa: E402
from repro.core import pricing as RPR  # noqa: E402
from repro.core import selector as RS  # noqa: E402
from repro_torch.core import channels as PCH  # noqa: E402
from repro_torch.core import pricing as PPR  # noqa: E402
from repro_torch.core import selector as PS  # noqa: E402
from repro_torch.core.communicator import Communicator  # noqa: E402

# the engine's shapes: qwen3-1.7b widths at the reduced and published sizes
ENGINE_SHAPES = [
    dict(d_model=2048, n_layers=28, vocab_size=151936, P=4, batch=4,
         prompt_len=16),
    dict(d_model=128, n_layers=2, vocab_size=512, P=2, batch=4, prompt_len=16),
    dict(d_model=32, n_layers=2, vocab_size=64, P=4, batch=3, prompt_len=4),
]
CHANNEL_SETS = [("ici",), ("sim",), ("rdma", "host"), None]


def test_default_channels_match(expected_default_channels):
    assert PCH.default_channels() == RCH.default_channels()
    assert set(PCH.default_channels()) == expected_default_channels
    assert PCH.names() == RCH.names()


@pytest.mark.parametrize("channels", CHANNEL_SETS, ids=str)
@pytest.mark.parametrize("shape", ENGINE_SHAPES, ids=lambda s: str(s["d_model"]))
@pytest.mark.parametrize("kw", [{}, {"logits_mode": "local-argmax"},
                                {"kv_dtype": "int8"}], ids=str)
def test_explain_serve_plan_string_equal(shape, channels, kw):
    assert PS.explain_serve_plan(channels=channels, **shape, **kw) == \
        RS.explain_serve_plan(channels=channels, **shape, **kw)


@pytest.mark.parametrize("op,nbytes,P", [
    ("allreduce", 2 * 4 * 2048 * 4, 4),  # decode partial, 4 slots
    ("allreduce", 16 * 2048 * 4, 4),  # prefill partial
    ("allgather", 4 * 151936 * 4, 4),  # logits shards
    ("allgather", 4 * 2 * 4, 4),  # local-argmax pairs
    ("allreduce", 1 << 20, 8),
    ("reduce_scatter", 1 << 16, 6),
])
@pytest.mark.parametrize("channels", CHANNEL_SETS, ids=str)
def test_select_and_explain_equal(op, nbytes, P, channels):
    want = RS.select(op, nbytes, P, channels=channels)
    got = PS.select(op, nbytes, P, channels=channels)
    assert (got.op, got.channel, got.algorithm, got.time_s, got.price_usd,
            got.depth) == (want.op, want.channel, want.algorithm, want.time_s,
                           want.price_usd, want.depth)
    assert PS.explain(op, nbytes, P, channels=channels) == \
        RS.explain(op, nbytes, P, channels=channels)


def test_fleet_rescale_bucket_plans_string_equal():
    kw = dict(d_model=2048, n_layers=28, vocab_size=151936,
              offered_tps=5000.0, slo_p99_ms=50.0, channels=("ici",))
    assert PS.explain_fleet_plan(**kw) == RS.explain_fleet_plan(**kw)
    kw = dict(nbytes=64e6, P=8, survivors=7, steps_remaining=100,
              compute_s=0.05)
    assert PS.explain_rescale_plan(**kw) == RS.explain_rescale_plan(**kw)
    kw = dict(op="allreduce", total_bytes=200e6, P=8, compute_s=0.02)
    assert PS.explain_bucket_plan(**kw) == RS.explain_bucket_plan(**kw)
    assert PS.crossover_nbytes("allreduce", 8, "rdma", "host") == \
        RS.crossover_nbytes("allreduce", 8, "rdma", "host")


def test_pricing_tables_equal():
    as_dicts = lambda t: {k: asdict(v) for k, v in t.items()}  # noqa: E731
    assert as_dicts(PPR.paper_table4()) == as_dicts(RPR.paper_table4())
    assert PPR.usd_per_mtok(8, 0.01, 16) == RPR.usd_per_mtok(8, 0.01, 16)


def test_communicator_serve_plan_thread_through():
    comm = Communicator(axes=("data",), sizes=(8,), channel="ici")
    plan = comm.serve_plan(d_model=2048, n_layers=28, vocab_size=151936,
                           batch=16, prompt_len=1024)
    assert plan.P == 8 and plan.decode.allreduce.channel == "ici"


@pytest.mark.parametrize("name", ["ici", "dcn", "host", "rdma", "flow",
                                  "xla"])
def test_unported_channels_stay_registered_but_raise(name):
    ch = PCH.get_channel(name)
    assert asdict(ch.spec) == asdict(RCH.get_channel(name).spec)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Communicator(axes=("d",), sizes=(2,), channel=name,
                     device="cpu").transport()


def test_flow_backend_hooks_raise_until_ported():
    with pytest.raises(NotImplementedError, match="flowsim"):
        PS.explain("allreduce", 1024, 4, channels=("sim",), flow=True)
    with pytest.raises(NotImplementedError, match="flowsim"):
        PS.calibrate()

"""llama4-maverick-400b-a17b — MoE LM, 128 experts top-1 + shared
[hf:meta-llama/Llama-4 family; unverified].

48L, d_model 5120, 40 heads (GQA kv=8), expert d_ff 8192, vocab 202048.
MoE every 2nd layer (interleaved dense/MoE, like the real Maverick: this
is what makes 400B-total / 17B-active).  Early-fusion vision omitted
([moe] family per assignment).  40 heads do not divide the 16-way model axis, so attention heads
stay replicated over TP (the MoE, which dominates compute, is EP-sharded).
"""

from ..models.config import ModelConfig, MoECfg

CONFIG = ModelConfig(
    param_dtype="bfloat16",
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    qk_norm=True,
    rope_theta=500_000.0,
    moe=MoECfg(n_experts=128, top_k=1, d_ff_expert=8192, n_shared=1,
               router_softmax=False, every_k=2),
)

"""deepseek-v2-236b — MoE LM with Multi-head Latent Attention
[arXiv:2405.04434; hf].

60L, d_model 5120, 128 heads MLA (kv_lora 512, q_lora 1536, qk_nope 128,
qk_rope 64, v 128), 160 routed experts top-6 + 2 shared, expert d_ff 1536,
vocab 102400.  Deviation (DESIGN.md): the real model's first dense layer is
made MoE like the rest to keep a uniform scan body.
"""

from ..models.config import MLACfg, ModelConfig, MoECfg

CONFIG = ModelConfig(
    param_dtype="bfloat16",
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=1536,
    vocab_size=102400,
    head_dim=128,
    rope_theta=10_000.0,
    mla=MLACfg(kv_lora=512, q_lora=1536, qk_nope=128, qk_rope=64, v_dim=128),
    moe=MoECfg(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2),
)

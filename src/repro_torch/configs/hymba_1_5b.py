"""hymba-1.5b — hybrid parallel attention + SSM heads [arXiv:2411.13676; hf].

32L, d_model 1600, 25 attn heads (GQA kv=5, hd 64) in parallel with 25
SSD heads (state 16), d_ff 5504, vocab 32001, sliding window 1024.
Deviations (DESIGN.md): mamba-1 heads expressed in SSD form; the three
full-attention layers are sliding-window here (O(W) ring cache -> 500k
decode cell); meta tokens omitted.  25 heads do not divide TP=16 ->
attention heads replicated over the model axis.
"""

from ..models.config import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    sliding_window=1024,
    rope_theta=10_000.0,
    tie_embeddings=True,
    ssm=SSMCfg(kind="ssd", state_size=16, conv_kernel=4, n_ssm_heads=25),
)

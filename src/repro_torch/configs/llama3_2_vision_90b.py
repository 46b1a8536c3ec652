"""llama-3.2-vision-90b — VLM with gated cross-attention image layers
[hf:meta-llama/Llama-3.2-11B-Vision scaled per assignment; unverified].

100L (80 self + 20 cross-attn, every 5th), d_model 8192, 64 heads
(GQA kv=8), d_ff 28672, vocab 128256.  The vision frontend is a STUB:
input_specs supplies precomputed patch embeddings [B, 1601, d_model].
"""

from ..models.config import ModelConfig, VLMCfg

CONFIG = ModelConfig(
    param_dtype="bfloat16",
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500_000.0,
    vlm=VLMCfg(cross_every=5, n_vision_tokens=1601),
)

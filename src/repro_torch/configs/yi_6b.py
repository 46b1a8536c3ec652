"""yi-6b — dense llama-arch GQA LM [arXiv:2403.04652; hf].

32L, d_model 4096, 32 heads (GQA kv=4), d_ff 11008, vocab 64000.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    param_dtype="bfloat16",  # halves FSDP gather wire (Perf 2.4); f32 moments kept
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    head_dim=128,
    rope_theta=5_000_000.0,
    tie_embeddings=False,
)

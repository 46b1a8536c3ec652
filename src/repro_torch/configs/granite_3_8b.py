"""granite-3-8b — dense GQA LM [hf:ibm-granite/granite-3.0 family; hf].

40L, d_model 4096, 32 heads (GQA kv=8), d_ff 12800, vocab 49155.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    param_dtype="bfloat16",  # halves FSDP gather wire (Perf 2.4); f32 moments kept
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    head_dim=128,
    rope_theta=10_000_000.0,
    tie_embeddings=True,
)

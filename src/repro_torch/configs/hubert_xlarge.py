"""hubert-xlarge — encoder-only audio transformer [arXiv:2106.07447; unverified].

48L, d_model 1280, 16 heads (kv=16), d_ff 5120, vocab 504 (cluster units).
Bidirectional attention; masked-prediction objective.  The conv waveform
frontend is a STUB: input_specs supplies frame embeddings [B, T, d_model]
plus a mask.  No decode shapes (encoder-only).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    head_dim=80,
    causal=False,
    rope_theta=10_000.0,
)

"""xlstm-125m — sLSTM + mLSTM recurrent LM [arXiv:2405.04517; unverified].

12L, d_model 768, 4 heads, vocab 50304; d_ff=0 (blocks carry their own
up/down projections: mLSTM proj factor 2, sLSTM post-FFN 4/3).  3 mLSTM :
1 sLSTM per scan group.  O(1) decode state -> runs the 500k cell.
"""

from ..models.config import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=192,
    tie_embeddings=True,
    ssm=SSMCfg(kind="mlstm", proj_factor=2.0, conv_kernel=4, slstm_every=4),
)

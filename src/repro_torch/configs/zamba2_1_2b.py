"""zamba2-1.2b — Mamba2 + shared attn blocks [arXiv:2411.15242; hf].

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64.
Structure: 6 groups of (5 mamba2 + 1 shared-attention application) + 2
tail mamba2 = 38 layer applications; the attention block's weights are
shared across applications (see DESIGN.md for deviations).  Hybrid ->
long_500k runs; the shared-attn KV uses the Atlas sparse plane."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32000, ssm_state=64,
    subquadratic=True, sparse_topk_pages=64)

SMOKE = CONFIG.scaled(n_layers=38, d_model=64, n_heads=4, n_kv_heads=4,
                      d_ff=128, vocab=512, ssm_state=8)

"""kimi-k2-1t-a32b — trillion-param MoE [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8) d_ff=2048(per-expert) vocab=163840,
MoE 384e top-8.  Expert parallelism (384 % 16 == 0) x FSDP; Adafactor
optimizer (AdamW state would not fit 256 chips — see EXPERIMENTS.md).
Serving uses the Atlas expert plane (hot experts in HBM, cold in the far
tier)."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
    n_heads=64, n_kv_heads=8, d_ff=2048, vocab=163840,
    moe_experts=384, moe_topk=8, atlas_experts=True)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=32, vocab=512, moe_experts=8, moe_topk=2)

"""mixtral-8x7b — 8 experts top-2, SWA [arXiv:2401.04088; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2,
sliding window 4096.  SWA is sub-quadratic: long_500k runs with the
ring-buffer window KV plane.  Experts are TP-sharded (8 % 16 != 0 ->
expert-replicated tensor parallelism; see DESIGN.md)."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=32000,
    moe_experts=8, moe_topk=2, sliding_window=4096, subquadratic=True)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, vocab=512, moe_experts=4, sliding_window=32)

"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

24L d_model=1024 4H d_ff=0 (block-internal projections) vocab=50304.
Alternating mLSTM/sLSTM (12 groups of 2).  Recurrent state is O(d_model):
the KV plane is inapplicable (DESIGN.md §Arch-applicability); the plane
manages only far-resident embedding tables in serving.  long_500k runs
natively (O(1) state)."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m", family="ssm", n_layers=24, d_model=1024, n_heads=4,
    n_kv_heads=4, d_ff=0, vocab=50304, subquadratic=True, atlas_kv=False)

SMOKE = CONFIG.scaled(n_layers=4, d_model=64, vocab=512)

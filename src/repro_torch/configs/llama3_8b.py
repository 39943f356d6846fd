"""llama3-8b — GQA, 128k vocab [arXiv:2407.21783; unverified].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
The paper-technique showcase arch: long_500k runs WITH the Atlas hybrid
KV plane (top-k paged sparse decode attention -> sub-quadratic)."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=128256, rope_theta=5e5,
    subquadratic=True, sparse_topk_pages=64)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, vocab=512)

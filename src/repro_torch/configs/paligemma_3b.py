"""paligemma-3b — SigLIP + gemma [arXiv:2407.07726; hf].

18L d_model=2048 8H (MQA kv=1, head_dim=256) d_ff=16384 vocab=257216.
Vision frontend is a STUB: input_specs() provides 256 precomputed patch
embeddings (SigLIP width 1152) projected into the LM.  Full attention:
long_500k skipped."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b", family="vlm", n_layers=18, d_model=2048,
    n_heads=8, n_kv_heads=1, d_ff=16384, vocab=257216, head_dim=256,
    frontend="vision", frontend_seq=256, frontend_dim=1152,
    tie_embeddings=True)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
                      d_ff=128, vocab=512, head_dim=16, frontend_seq=16,
                      frontend_dim=32)

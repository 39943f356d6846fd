"""seamless-m4t-medium — enc-dec, multimodal [arXiv:2308.11596; hf].

12L d_model=1024 16H (kv=16) d_ff=4096 vocab=256206 (padded to 256256 for
TP divisibility).  Audio frontend is a STUB: input_specs() provides
precomputed frame embeddings [B, S/4, d_model].  Enc-dec full attention:
long_500k skipped."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="encdec", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab=256206,
    enc_layers=12, dec_layers=12, frontend="audio")

SMOKE = CONFIG.scaled(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                      d_ff=128, vocab=512, enc_layers=2, dec_layers=2)

"""codeqwen1.5-7b — qwen1.5-arch [hf:Qwen/CodeQwen1.5-7B; hf].

32L d_model=4096 32H (GQA kv=32 == MHA) d_ff=13440 vocab=92416.
Pure full attention: long_500k skipped (DESIGN.md)."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=32, d_ff=13440, vocab=92416, rope_theta=1e6)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                      d_ff=128, vocab=512)

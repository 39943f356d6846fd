"""granite-20b — llama-arch, code [arXiv:2405.04324; hf].

52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
Pure full attention: long_500k skipped."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b", family="dense", n_layers=52, d_model=6144,
    n_heads=48, n_kv_heads=1, d_ff=24576, vocab=49152)

SMOKE = CONFIG.scaled(n_layers=2, d_model=96, n_heads=6, n_kv_heads=1,
                      d_ff=192, vocab=512)

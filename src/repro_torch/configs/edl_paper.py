"""The paper-representative training workload. The paper trains CNNs
(ResNet/VGG); the assigned pool is transformer-family, so the EDL experiments
use a ~160M dense decoder (GPT-small scale) as the elastic job under test —
the elasticity layer is architecture-agnostic."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="edl-paper-160m", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab=32768,
    param_dtype="float32", compute_dtype="float32", remat=False,
    attn_chunk=256, loss_chunk=256, source="EDL paper §6 workload analogue")

SMOKE = ArchConfig(
    name="edl-paper-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
    param_dtype="float32", compute_dtype="float32", remat=False,
    attn_chunk=64, loss_chunk=64, source="reduced edl-paper")

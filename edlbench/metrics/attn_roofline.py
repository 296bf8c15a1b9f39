"""The bf16 flash attention kernels' share of their bound: the least time
of every attention call the traced steps make (remat's recomputed forward
included; ``counts.attention_bound_s``) over the device time of the
kernels matched below."""
from edlbench import counts
from edlbench.readers import roofline

LAYER = "kernels/attention/ (flash_attn_*_tc)"
MOVES = "train_tokens_per_s"
MARKS = ("fwd_tc_kernel", "bwd_dq_tc_kernel", "bwd_dkdv_tc_kernel")


def read(run):
    return roofline(run, MARKS, counts.attention_bound_s)

"""The WKV6 kernels' share of their bound: the least time of every WKV6
call the traced steps make (remat's recomputed forward included;
``counts.wkv_bound_s``) over the device time of the kernels matched
below."""
from edlbench import counts
from edlbench.readers import roofline

LAYER = "kernels/rwkv/ (wkv6_*)"
MOVES = "train_tokens_per_s"
MARKS = ("wkv6_",)


def read(run):
    return roofline(run, MARKS, counts.wkv_bound_s)

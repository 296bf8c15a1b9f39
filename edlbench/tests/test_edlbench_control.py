"""The control: the reference computed in float8, the precision below the
configuration's bfloat16, put in the program's place, must come out not
correct against each cell's committed limits, as it does at the cells'
own sizes on the card (``probe.py``)."""
import pytest
import torch

from edlbench import check
from edlbench.reference import model as ref

from helpers import tiny_files

CELLS = ["phi3.b2x8k"]


def control_fails(workload: str, device: torch.device, seed: int) -> bool:
    files = tiny_files(workload, seq_len=64, dtype="bfloat16")
    m, t = files["model"], files["traffic"]
    gen = torch.Generator().manual_seed(seed)
    batches = []
    for _ in range(t["reference_steps"]):
        tok = torch.randint(0, m["vocab_size"], (t["global_batch"], 65),
                            generator=gen)
        batches.append((tok[:, :-1], tok[:, 1:]))
    kw = dict(rows=t["reference_rows"])
    base = ref.train(m, t["optimizer"], seed, batches, [device], **kw)
    low = ref.train(m, t["optimizer"], seed, batches, [device], low=True,
                    **kw)
    values = check.compare(low, base)["values"]
    return any(values[k] > lim for k, lim in files["limits"].items()
               if k in values)


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    assert all(control_fails(workload, torch.device("cpu"), s)
               for s in (1, 2, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert all(control_fails(workload, torch.device("cuda"), s)
               for s in (1, 2, 3))

"""Small configurations of the benchmark's cells for the CPU tests."""
import copy

from edlbench import run

TINY = {"llama": dict(hidden_size=64, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2,
                      intermediate_size=128, vocab_size=256,
                      reference_attn_chunk=16, reference_loss_chunk=16),
        "rwkv6": dict(hidden_size=128, attention_hidden_size=128,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=2, intermediate_size=256,
                      vocab_size=256, reference_loss_chunk=16)}


def tiny_files(workload: str, *, seq_len: int = 32,
               dtype: str = "float32") -> dict:
    """The cell's files with its model cut to a few thousand parameters
    and its sequences to ``seq_len``, in ``dtype``; its limits as
    committed."""
    files = copy.deepcopy(run.cell_files(workload))
    files["model"].update(TINY[files["model"]["model"]])
    files["model"]["torch_dtype"] = dtype
    files["traffic"]["seq_len"] = seq_len
    return files


# a mix that resizes the job: global B 8 on four slots from p = 4,
# scale_in(2) and scale_out(2) in turn, each once the last committed and
# a step ran; set-up warms both shapes and its two checked steps cross
# both switches
SWITCHING = {
    "global_batch": 8, "init_p": 4, "slots": 4, "n_samples": 4096,
    "partition_samples": 2, "reference_steps": 2, "reference_rows": 2,
    "warm": [{"op": "step"}, {"op": "scale_in", "n": 2}, {"op": "settle"},
             {"op": "scale_out", "n": 2}, {"op": "settle"}],
    "checked": [{"op": "scale_in", "n": 2}, {"op": "step"},
                {"op": "scale_out", "n": 2}, {"op": "step"}],
    "cycle": [{"op": "scale_in", "n": 2}, {"op": "step"}, {"op": "step"},
              {"op": "scale_out", "n": 2}, {"op": "step"}, {"op": "step"}],
    "trace_from": 1, "trace_units": 1}


def switching_files(seq_len: int = 32) -> dict:
    """``phi3.b2x8k``'s files with its traffic replaced by a mix that
    switches, and the switches' own check among the limits."""
    files = tiny_files("phi3.b2x8k", seq_len=seq_len)
    files["traffic"].update(copy.deepcopy(SWITCHING))
    files["limits"]["stops_outside_step"] = 0
    return files

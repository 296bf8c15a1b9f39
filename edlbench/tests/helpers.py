"""Small configurations of the benchmark's cells for the CPU tests."""
import copy
import importlib

from edlbench import run
from edlbench.reference import CONTRACT, kind


def kinds() -> list[str]:
    """Every model kind whose module is found under ``reference/``."""
    out = []
    for path in sorted((run.HERE / "reference").glob("[!_]*.py")):
        mod = importlib.import_module(f"edlbench.reference.{path.stem}")
        if all(hasattr(mod, k) for k in CONTRACT):
            out.append(path.stem)
    return out


def configs(model: str) -> list[str]:
    """The names of the configuration files of one kind."""
    return [p.stem for p in sorted((run.HERE / "configs").glob("*.json"))
            if run.load_json(p)["model"] == model]


def small(config: str, dtype: str = "float32") -> dict:
    """A configuration file cut to its kind's ``TINY`` sizes, in
    ``dtype``."""
    m = run.load_json(run.HERE / "configs" / f"{config}.json")
    m.update(kind(m).TINY)
    m["torch_dtype"] = dtype
    return m


def tiny_files(workload: str, *, seq_len: int = 32,
               dtype: str = "float32") -> dict:
    """The cell's files with its model cut to a few thousand parameters
    (its kind's ``TINY``) and its sequences to ``seq_len``, in ``dtype``;
    its limits as committed."""
    files = copy.deepcopy(run.cell_files(workload))
    files["model"].update(kind(files["model"]).TINY)
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

"""A model kind is added as files only: a module the harness has never
named, with a configuration file naming it, runs a whole cell; a
configuration whose kind has no module is refused by the kind's name."""
import json
import sys
import time
import types

import pytest
import torch

from edlbench import counts, probe, run
from edlbench.reference import CONTRACT, kind
from edlbench.reference import llama
from edlbench.reference import model as ref

from helpers import tiny_files

SEED = 2**31 + 23


def go(files):
    return run.run_cell(files, SEED, 0.5, False, [torch.device("cpu")],
                        trainer_kw={"time_allowance_s": 0},
                        t_start=time.monotonic())


def with_model_file(files: dict, tmp_path, model: str) -> dict:
    """``files`` with its configuration written to a file of its own under
    the kind ``model`` and read back from it."""
    path = tmp_path / f"{model}.json"
    path.write_text(json.dumps(dict(files["model"], model=model)))
    return dict(files, model=run.load_json(path))


def test_a_new_kind_needs_no_edit(monkeypatch, tmp_path):
    toy = types.ModuleType("edlbench.reference.toy")
    for name in CONTRACT:
        setattr(toy, name, getattr(llama, name))
    monkeypatch.setitem(sys.modules, "edlbench.reference.toy", toy)
    files = tiny_files("phi3.b2x8k")
    mine = with_model_file(files, tmp_path, "toy")
    assert kind(mine["model"]) is toy
    a, b = go(files), go(mine)
    assert b["result"]["correct"], b["result"]["compared"]
    assert b["program"]["loss"] == a["program"]["loss"]
    assert b["reference"]["loss"] == a["reference"]["loss"]
    assert b["compare"]["values"] == a["compare"]["values"]
    assert counts.step_model_flops(mine["model"], 2, 32) == \
        counts.step_model_flops(files["model"], 2, 32)


def test_a_kind_without_a_module_is_refused_by_name(monkeypatch, tmp_path):
    files = with_model_file(tiny_files("phi3.b2x8k"), tmp_path, "nosuchkind")
    m = files["model"]
    for call in (lambda: run.port_config(m),
                 lambda: counts.matmul_params(m),
                 lambda: counts.step_model_flops(m, 2, 32),
                 lambda: ref.param_specs(m),
                 lambda: ref.init_params(m, 1, "cpu"),
                 lambda: ref.loss_sum(m, {}, None, None)):
        with pytest.raises(ValueError, match="nosuchkind"):
            call()
    monkeypatch.setattr(run, "cell_files", lambda workload: files)
    with pytest.raises(ValueError, match="nosuchkind"):
        probe.main(["--workload", "phi3.b2x8k", "--seeds", "1",
                    "--out", str(tmp_path / "probe.json")])


@pytest.mark.parametrize("name", ["model", "../llama", ""])
def test_what_is_no_kind_is_refused(name):
    with pytest.raises(ValueError, match="no reference module"):
        kind({"model": name})


def test_a_dotted_field_sets_a_nested_config(monkeypatch):
    """A kind maps a key into the nested dataclasses (``mla.kv_lora``); a
    port config without that part refuses it."""
    toy = types.ModuleType("edlbench.reference.toy")
    for name in CONTRACT:
        setattr(toy, name, getattr(llama, name))
    toy.PORT_FIELDS = dict(llama.PORT_FIELDS, kv_lora_rank="mla.kv_lora")
    monkeypatch.setitem(sys.modules, "edlbench.reference.toy", toy)
    m = dict(tiny_files("phi3.b2x8k")["model"], model="toy", kv_lora_rank=96)
    with pytest.raises(ValueError, match="mla"):
        run.port_config(m)
    cfg = run.port_config(dict(m, arch="deepseek-v2-236b"))
    assert cfg.mla.kv_lora == 96 and cfg.d_model == m["hidden_size"]

"""The port's dry run on the reference's production mesh, a 16×16 fake
world of 256 ranks, at full width: qwen3-0.6b's train step under
``fsdp_tp`` and its decode step under ``tp``, the collective forensics
over the train step, and the CLI's JSON file."""
import json

import pytest
import torch

from _torch_dryrun_common import REF_KEYS, reference_argument_bytes
from repro import configs as jconfigs
from repro.launch import specs as jspecs
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import forensics as tfor

pytestmark = pytest.mark.tier1
torch.set_num_threads(1)

POD = {"data": 16, "model": 16}


@pytest.fixture(scope="module")
def train_result():
    return tdry.dry_run("qwen3-0.6b", "train_4k", policy="fsdp_tp")


def test_qwen3_train_step_on_16x16(train_result):
    res = train_result
    assert REF_KEYS <= set(res)
    assert (res["mesh"], res["chips"]) == ("16x16", 256)
    assert res["memory"]["argument_size_in_bytes"] == \
        reference_argument_bytes(jconfigs.get("qwen3_0p6b"), "train_4k",
                                 "fsdp_tp", POD)
    coll = res["collectives"]
    assert coll["all-gather"]["count"] > 0
    assert coll["reduce-scatter"]["count"] > 0
    assert res["loops"] == [{"body": "attn_mlp layer", "trip": 28,
                             "mult": 1.0}]
    # per device: more than the model's 6·N·D share (remat runs the
    # forward twice), far less than the global count
    share = res["model_flops_per_device"]
    assert share < res["flops_per_device"] < 3 * share
    # the gather always; the other ops DTensor refuses vary with torch,
    # but none is attention's (the heads' layout is the port's)
    assert "aten.gather.default" in {n["op"] for n in res["notes"]}
    for n in res["notes"]:
        assert n["site"].startswith(("repro_torch/models/", "backward:"))
        assert "attention.py" not in n["site"], n


def test_forensics_ranks_the_train_steps_sites(train_result):
    sites = tfor.collective_sites(train_result)
    assert sites == sorted(sites, reverse=True)
    total = sum(s[0] for s in sites)
    assert total == pytest.approx(
        train_result["collective_wire_bytes_per_device"])
    wb, kind, ob, n, mult, site = sites[0]
    assert kind in ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all") and n == 16 and mult >= 1 and site
    lines = tfor.report(sites, 5)
    assert lines[0].startswith("total wire bytes/device:") and len(lines) == 6


def test_qwen3_decode_step_on_16x16_all_reduces(tmp_path, capsys):
    tdry.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
               "--policy", "tp", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.startswith("OK   qwen3_0p6b__decode_32k__16x16__tp:")
    res = json.loads((tmp_path / "qwen3_0p6b__decode_32k__16x16__tp.json")
                     .read_text())
    assert "all-reduce" in res["collectives"]
    cfg = jspecs.serve_config(jconfigs.get("qwen3_0p6b"), "decode_32k")
    assert res["memory"]["argument_size_in_bytes"] == \
        reference_argument_bytes(cfg, "decode_32k", "tp", POD) - 4


def test_the_sweep_reports_a_failure_and_goes_on(tmp_path, capsys,
                                                 monkeypatch):
    """``--all`` prints FAIL for a combination that raises, writes its
    traceback, and runs the next; ``dry_run`` itself raises."""
    calls = []

    def fake(arch, shape, **kw):
        calls.append((arch, shape))
        if len(calls) == 1:
            raise RuntimeError("boom")
        return {"roofline": {"compute_s": 1.0, "memory_s": 2.0,
                             "collective_s": 0.5},
                "bottleneck": "memory_s", "trace_s": 0.1, "notes": []}

    monkeypatch.setattr(tdry, "dry_run", fake)
    tdry.main(["--all", "--out", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("FAIL ") and "RuntimeError: boom" in lines[0]
    assert all(l.startswith("OK   ") for l in lines[1:])
    assert len(lines) == len(calls) == 40
    assert len(list(tmp_path.glob("*.FAILED.txt"))) == 1

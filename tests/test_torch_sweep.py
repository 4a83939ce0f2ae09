"""The port's workload sweep (``repro_torch.workloads.sweep``) on the CPU:
the presets this slice brings to the port (the observed one, and the
elastic 4-host one whose fleet of planes the obs wiring reaches) through
the port's ``run_preset`` and the reference's own on the same preset,
with equal claims, stages and pulls (``tests/test_torch_workloads.py``
holds five more against the reference's sweep; each reference run costs
10–40 s of JAX compilation here); and the whole matrix of eleven presets
through the port's ``sweep`` (``matrix_green``,
``benchmarks/bench_workloads.py``'s claim).  ``overlap_ge_half`` compares
load and compute wall seconds, which a loaded CPU does not hold steady:
the CPU leaves it out, and ``chip_smoke.py`` holds every claim on the
card."""
from __future__ import annotations

import pytest
import torch

from repro.workloads import run_preset as jrun_preset
from repro_torch.workloads import PRESETS, run_preset, sweep

pytestmark = pytest.mark.tier1

# small shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

COMPARED = ["yi@3stages-obs", "granite-moe@4hosts-elastic"]


def _claims(res) -> dict:
    return {k: v for k, v in res.claims.items() if k != "overlap_ge_half"}


@pytest.mark.parametrize("name", COMPARED)
def test_preset_claims_equal_the_references_run_preset(name, tmp_path):
    want = jrun_preset(name, tmp_path / "ref")
    got = run_preset(name, tmp_path / "port", device="cpu")
    assert got.error is None and want.error is None, (got.error, want.error)
    assert _claims(got) == _claims(want)
    assert (got.stages, got.transfers) == (want.stages, want.transfers)
    assert (got.arch, got.family, got.scenario) == \
        (want.arch, want.family, want.scenario)


def test_the_matrix_is_green(tmp_path):
    results = sweep(workdir=tmp_path, device="cpu")
    assert [r.name for r in results] == [p.name for p in PRESETS]
    assert len(results) == 11
    bad = {r.name: (r.claims, r.error) for r in results
           if r.error is not None or not all(_claims(r).values())}
    assert not bad, bad
    assert {r.name for r in results if "kernel_routed" in r.claims} == {
        "falcon-mamba@2stages", "falcon-mamba@stream",
        "recurrentgemma@2stages", "recurrentgemma@serve"}
    for r in results:
        assert r.transfers <= r.stages or r.scenario == "serve"

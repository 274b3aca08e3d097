"""A run of step kind ``fl_aggregate`` whose timed path is broken
underneath comes out not correct: the harness's look for a card is
skipped (the run is on the CPU) and the rest of a run is driven, once for
each fault a cell of this step kind can have.  (A one-process aggregation
has no exchange between chips to leave out.)"""

import json
from pathlib import Path

import pytest
import torch

from portbench import harness
from repro_torch.distributed import fl_mesh

_aggregate = fl_mesh.make_fl_aggregate
_fold = fl_mesh._fold


def unchanged(mesh, *, mode):
    """Every pod keeps its own copy: the round returns its state."""
    return lambda stacked: {k: v.clone() for k, v in stacked.items()}


def altered(mesh, *, mode):
    """One value of one pod's copy of one leaf is altered where the round
    produces it."""
    agg = _aggregate(mesh, mode=mode)

    def run(stacked):
        out = agg(stacked)
        leaf = out[sorted(out)[0]]
        leaf.view(-1)[-1] = -leaf.view(-1)[-1] + 0.5
        return out
    return run


def half_fold(vals):
    """The mean over the first half of the pods alone."""
    return _fold(vals[: vals.shape[0] // 2])


def no_codec(mesh, *, mode):
    """The int8 round run without its codec."""
    return _aggregate(mesh, mode="exact")


FAULTS = {"unchanged": ("make_fl_aggregate", unchanged),
          "altered": ("make_fl_aggregate", altered),
          "half_the_pods": ("_fold", half_fold),
          "no_codec": ("make_fl_aggregate", no_codec)}


#: each fault on each kind of cell that can have it (an exact round has
#: no codec to leave out)
CASES = [(fault, pods, mode) for fault in sorted(FAULTS)
         for pods, mode in ((4, "int8"), (2, "int8"), (4, "exact"),
                            (2, "exact"))
         if not (fault == "no_codec" and mode == "exact")]


@pytest.mark.parametrize("fault,pods,mode", CASES)
def test_broken_round_is_not_correct(tiny, monkeypatch, fault, pods, mode):
    root, name, bench = tiny(pods, mode)
    attr, broken = FAULTS[fault]
    monkeypatch.setattr(fl_mesh, attr, broken)
    res = harness.run(name, 12, 0.02, False, bench=bench, root=root,
                      device="cpu")
    assert res["correct"] is False and res["failed"] == 1
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def committed_cells():
    """Every committed cell file of step kind ``fl_aggregate``: (cell,
    pods, mode, limits, control)."""
    out = []
    for path in sorted((Path(harness.HERE) / "workloads").glob("*.json")):
        spec = json.loads(path.read_text())
        if harness.load_json(harness.HERE, "traffic", spec["traffic"])[
                "step"] != "fl_aggregate":
            continue
        cell = harness.Cell(path.stem)
        out.append((cell.name, int(cell.config["pods"]),
                    cell.traffic["mode"], cell.limits, cell.spec["control"]))
    return out


CELLS = committed_cells()


@pytest.mark.parametrize("cell,pods,mode,limits,control", CELLS,
                         ids=[c[0] for c in CELLS])
def test_limits_of_the_cells_refuse_the_faults(tiny, monkeypatch, cell, pods,
                                               mode, limits, control):
    """Each committed cell's own limits, at its pod count and mode on a
    tiny tree, refuse every fault and pass the sound round."""
    root, name, bench = tiny(pods, mode, limits=limits)
    assert harness.run(name, 3, 0.02, False, bench=bench, root=root,
                       device="cpu")["correct"] is True
    for fault, (attr, broken) in FAULTS.items():
        if fault == "no_codec" and mode == "exact":
            continue
        with monkeypatch.context() as m:
            m.setattr(fl_mesh, attr, broken)
            res = harness.run(name, 3, 0.02, False, bench=bench, root=root,
                              device="cpu")
        assert res["correct"] is False, fault


@pytest.mark.parametrize("cell,pods,mode,limits,control", CELLS,
                         ids=[c[0] for c in CELLS])
def test_control_in_the_programs_place_is_not_correct(
        tiny, monkeypatch, cell, pods, mode, limits, control):
    """Each committed cell's control (the reference in the precision its
    file names) put in the program's place, held to the cell's own
    limits at its pod count and mode on a tiny tree."""
    from portbench.reference import fl_aggregate as reference

    def replaced(mesh, *, mode):
        return lambda t: reference.aggregate(t, mode,
                                             arith=getattr(torch, control))
    root, name, bench = tiny(pods, mode, limits=limits, control=control)
    monkeypatch.setattr(fl_mesh, "make_fl_aggregate", replaced)
    res = harness.run(name, 5, 0.02, False, bench=bench, root=root,
                      device="cpu")
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())

"""``python -m repro_torch.fleet_scale`` against the reference's
``benchmarks/fleet_scale.py``.

* The same arguments give the same report outside its wall-clock fields
  (:func:`repro_torch.fleet_scale.reproducible`): the packet engines and
  the flow engine, every topology, async, ``--replay-check`` and
  ``--flow-gate``, and the same exit code.
* The pins ``chip_smoke.py`` holds on the card (``fleet_scale.PINS``:
  the SHA-256 of each pinned run's reproducible report and a few readable
  fields) are the reference's live runs, and the port reproduces them on
  the CPU.  The 100,000-client pin is recomputed only under ``-m slow``
  (a pair of runs takes about two minutes here).
* The topology and async gates of ``repro_torch.fleet_gates`` take
  ``engine="flow"`` as the reference's benchmarks do, with the same
  results.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import sys

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch import device as port_device  # noqa: E402
from repro_torch import fleet_gates, fleet_scale  # noqa: E402

BENCH = os.path.join(os.path.dirname(__file__), os.pardir, "benchmarks")


def _bench(name: str):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(BENCH, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref_fleet_scale = _bench("fleet_scale")


def reference_run(argv: list[str], tmp_path, monkeypatch) -> tuple[int, dict]:
    """The reference script's exit code and report for ``argv``."""
    out = str(tmp_path / "reference.json")
    monkeypatch.setattr(sys, "argv", ["fleet_scale.py", *argv, "--out", out])
    with contextlib.redirect_stdout(io.StringIO()):
        rc = ref_fleet_scale.main()
    with open(out) as f:
        return rc, json.load(f)


def port_run(argv: list[str], tmp_path) -> tuple[int, dict]:
    """The port's exit code and report for ``argv``, on the CPU."""
    out = str(tmp_path / "port.json")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = fleet_scale.main([*argv, "--device", "cpu", "--out", out])
    with open(out) as f:
        return rc, json.load(f)


CASES = {
    # The reference's harness cell: a small fleet across all transports.
    "batched": ["--clients", "16", "--rounds", "1", "--participation",
                "0.75", "--deadline-s", "20", "--params", "1024"],
    "per_packet_hier": ["--engine", "per_packet", "--clients", "24",
                        "--rounds", "1", "--topology", "hier", "--cells",
                        "3", "--transports", "mudp,tcp"],
    "flow_replay_check": ["--engine", "flow", "--clients", "48,96",
                          "--rounds", "2", "--replay-check"],
    "flow_gossip": ["--engine", "flow", "--clients", "40", "--rounds", "2",
                    "--topology", "gossip", "--neighbors", "3",
                    "--transports", "mudp+fec,udp"],
    "flow_async": ["--engine", "flow", "--clients", "40", "--rounds", "5",
                   "--mode", "async", "--buffer-k", "6", "--transports",
                   "mudp+fec,tcp", "--deadline-s", "6"],
    # The gate's floor at 0 keeps the exit code free of wall-clock noise;
    # its packet events are what the simulation decides.
    "flow_gate": ["--engine", "flow", "--clients", "32", "--rounds", "1",
                  "--transports", "mudp", "--flow-gate",
                  "--flow-gate-clients", "48", "--flow-gate-min", "0"],
}


@pytest.fixture(autouse=True)
def _cpu():
    with port_device.use_device("cpu"):
        yield


@pytest.mark.parametrize("case", sorted(CASES))
def test_report_equals_the_reference(case, tmp_path, monkeypatch):
    argv = CASES[case]
    rc_ref, want = reference_run(argv, tmp_path, monkeypatch)
    rc, got = port_run(argv, tmp_path)
    assert rc == rc_ref == 0
    assert fleet_scale.reproducible(got) == fleet_scale.reproducible(want)
    assert fleet_scale.digest(got) == fleet_scale.digest(want)
    # The wall-clock sections have the reference's shape.
    assert got["wall"].keys() == want["wall"].keys()
    assert [sorted(r) for r in got["scaling"]] == [sorted(r) for r in
                                                   want["scaling"]]
    if "--flow-gate" in argv:
        assert got["flow_gate"].keys() == want["flow_gate"].keys()
        assert got["flow_gate"]["flow"]["packet_events"] > 0


def test_reproducible_drops_only_the_wall_clock():
    report = {"meta": {"a": 1}, "fleets": {"8": {}}, "errors": {},
              "wall": {"8": {"mudp": {"wall_s": 1.0}}},
              "scaling": [{"clients": 8, "wall_s_total": 1.0,
                           "wall_s_per_client": 0.125,
                           "rounds_per_wall_sec": 2.0}],
              "flow_gate": {"batched": {"wall_s": 2.0, "packet_events": 7,
                                        "events_per_sec": 3.5},
                            "flow": {"wall_s": 1.0, "packet_events": 5,
                                     "events_per_sec": 5.0},
                            "ratio": 1.43, "min_ratio": 2.0, "ok": False}}
    assert fleet_scale.reproducible(report) == {
        "meta": {"a": 1}, "fleets": {"8": {}}, "errors": {},
        "scaling": [{"clients": 8}],
        "flow_gate": {"batched": {"packet_events": 7},
                      "flow": {"packet_events": 5}, "min_ratio": 2.0}}
    assert fleet_scale.reproducible({**report, "flow_gate": None})[
        "flow_gate"] is None


def _check_pin(label, tmp_path, monkeypatch):
    argv = fleet_scale.PINNED_ARGV[label]
    pin = fleet_scale.PINS[label]
    rc_ref, want = reference_run(argv, tmp_path, monkeypatch)
    assert rc_ref == 0
    assert fleet_scale.digest(want) == pin["sha256"]
    assert fleet_scale.summary(want) == pin["summary"]
    rc, got = port_run(argv, tmp_path)
    assert rc == 0
    assert fleet_scale.digest(got) == pin["sha256"]


SMALL_PINS = [label for label in fleet_scale.PINNED_ARGV
              if "/hier32/" not in label]


@pytest.mark.parametrize("label", SMALL_PINS)
def test_small_pin_is_the_reference_run(label, tmp_path, monkeypatch):
    _check_pin(label, tmp_path, monkeypatch)


def test_pins_cover_every_transport_and_topology():
    assert sorted(fleet_scale.PINS) == sorted(fleet_scale.PINNED_ARGV)
    cells = {(fleet_scale.PINNED_ARGV[label][
        fleet_scale.PINNED_ARGV[label].index("--topology") + 1]
        if "--topology" in fleet_scale.PINNED_ARGV[label] else "star",
        cell.split("/")[1])
        for label in SMALL_PINS for cell in fleet_scale.PINS[label][
            "summary"]}
    for topology in ("star", "hier", "gossip"):
        for tr in ("mudp", "mudp+fec", "tcp", "udp"):
            assert (topology, tr) in cells
    assert "--mode" in fleet_scale.PINNED_ARGV["flow/async"]


def test_10000_client_pin_is_the_reference_run(tmp_path, monkeypatch):
    """The deployment the reference's docstring names, at 10,000 clients
    for 2 rounds (the pair of runs takes about 15 s here)."""
    _check_pin("flow/hier32/10000", tmp_path, monkeypatch)
    summ = fleet_scale.PINS["flow/hier32/10000"]["summary"]["10000/mudp"]
    assert (summ["bytes_on_wire"], summ["retransmissions"]) == (262459155,
                                                                167)


@pytest.mark.slow
def test_100000_client_pin_is_the_reference_run(tmp_path, monkeypatch):
    _check_pin("flow/hier32/100000", tmp_path, monkeypatch)


def test_cli_refuses_what_the_reference_refuses(capsys):
    with pytest.raises(SystemExit) as exc:
        fleet_scale.main(["--transports", "pigeon", "--device", "cpu"])
    assert exc.value.code == 2
    assert "unknown transport 'pigeon'" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        fleet_scale.main(["--engine", "warp", "--device", "cpu"])
    with pytest.raises(SystemExit):
        fleet_scale.main(["--rounds", "0", "--device", "cpu"])


def test_runs_on_cuda_by_default_and_never_falls_back(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is not refused")
    with port_device.use_device("cuda"), \
            pytest.raises(RuntimeError, match="cuda"):
        fleet_scale.main(["--clients", "4", "--rounds", "1", "--out",
                          str(tmp_path / "x.json")])
    with pytest.raises(RuntimeError, match="CUDA device"):
        fleet_scale.main(["--clients", "4", "--device", "cpu", "--profile",
                          str(tmp_path / "t.json")])


def test_fleet_gates_take_the_flow_engine():
    """``fleet_gates.run_topology`` / ``time_to_target`` with
    ``engine="flow"`` give the reference benchmarks' results."""
    topo = _bench("topology_bench")
    avs = _bench("async_vs_sync")
    kw = dict(n_clients=24, rounds=2, seed=1, n_params=256,
              transport="mudp")
    for topology, extra in (("hier", {"cells": 3}), ("gossip",
                                                     {"neighbors": 3})):
        got = fleet_gates.run_topology(topology, engine="flow", **kw,
                                       **extra)
        want = topo.run_topology(topology, engine="flow", **kw, **extra)
        assert {k: v for k, v in want.items() if k in got} == got
    kw = dict(n_clients=16, seed=2, target_frac=0.05, n_params=256,
              max_rounds=6, transport="mudp", buffer_k=4,
              deadline_ns=8 * 10**9, engine="flow")
    for mode in ("sync", "async"):
        got = fleet_gates.time_to_target(mode, **kw)
        want = avs.time_to_target(mode, **kw)
        got.pop("wall_s"), want.pop("wall_s")
        assert got == want


def test_fleet_gates_cli_takes_the_flow_engine(capsys):
    rc = fleet_gates.main(["--only", "topology", "--engine", "flow",
                           "--device", "cpu"])
    assert rc == 0
    assert "gate_failures" in capsys.readouterr().out

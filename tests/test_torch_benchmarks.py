"""The paper's experiment and the reference's benchmark gates as port
entry points, against the reference's own scripts in the same process.

* ``quickstart`` (``examples/quickstart.py``) and ``fl_convergence``
  (``benchmarks/fl_convergence.py``) start from the reference's
  ``jax.random.PRNGKey(0)`` weights.  Round records and printed trace
  lines are equal; the global parameters of the quickstart and of each
  convergence arm lie within ``PARAM_RTOL`` relative L2 of the
  reference's, leaf by leaf (measured: 1.7e-7 and at most 1.2e-7; the
  clients train in float32 on two frameworks); each convergence arm's
  accuracy lies within ``fl_convergence.ACC_TOL`` of the reference's
  (measured: equal).  The port's own default weights
  (:mod:`repro_torch.threefry`) lie within ``INIT_ULP`` of JAX's draws.
* ``transport_scenarios``, ``transport_comparison`` and
  ``transport_ablation`` are host draws plus the fedavg fold, which is
  the numpy fold's bit for bit: every simulated field is equal, the L2
  errors and global parameters included.
* ``adaptive_bench``'s arms are equal at its default (CI) size and both
  gates hold.  ``simcore``'s digests equal the reference's under both
  engines at 16 clients here; the CI size (64 clients, 256 KiB) is held
  under ``-m slow``.  ``wire_bench``'s wire hashes equal the reference's
  under both wire backends, and the batch bytes equal the loop's.
* Every pin ``chip_smoke.py`` holds on the card is recomputed from the
  reference's live run, every entry point defaults to ``cuda`` (and so
  refuses to run here without ``--device cpu``), and each exits 1 when
  its gate fails.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import core as ref_core  # noqa: E402
from repro.core import wire as ref_wire  # noqa: E402
from repro_torch import (adaptive_bench, fl_convergence, quickstart,  # noqa: E402
                         simcore, threefry,
                         transport_ablation, transport_comparison,
                         transport_scenarios, wire_bench)
from repro_torch.core import wire as port_wire  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.replay import round_record  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
PARAM_RTOL = 1e-5
INIT_ULP = 4
#: simcore's tier-1 size (the CI size runs under -m slow)
SIMCORE_SMALL = {"clients": 16, "payload_kib": 64, "params": 4096,
                 "seed": 0}
WIRE_SMALL_PARAMS = 25_000


def _load(relpath: str, name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / relpath)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        result = fn(*args, **kwargs)
    return result, out.getvalue()


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def _reference_init() -> dict[str, np.ndarray]:
    ref = _load("benchmarks/fl_convergence.py", "reference_fl_convergence")
    return {k: np.asarray(v)
            for k, v in ref.init_mlp(jax.random.PRNGKey(0)).items()}


# --------------------------------------------------------------------------
# threefry: the reference's initial weights without JAX
# --------------------------------------------------------------------------
def test_threefry_keys_and_bits_are_jax_bitwise():
    key = jax.random.PRNGKey(0)
    for _ in range(3):
        key, sub = jax.random.split(key)
    mine = threefry.key(0)
    for _ in range(3):
        mine, my_sub = threefry.split(mine)
    assert np.array_equal(np.asarray(jax.random.key_data(sub)
                                     if hasattr(jax.random, "key_data")
                                     else sub), np.array(my_sub))
    want = np.asarray(jax.random.bits(sub, (1000,), np.uint32))
    assert np.array_equal(threefry.bits(my_sub, 1000), want)


def test_default_weights_are_the_references_within_ulps():
    ref, port = _reference_init(), mlp.init_paper_mlp(0)
    assert sorted(ref) == sorted(port)
    for k in ref:
        assert port[k].dtype == np.float32 and port[k].shape == ref[k].shape
        assert _ulps(port[k], ref[k]) <= INIT_ULP, k


# --------------------------------------------------------------------------
# quickstart
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def quickstart_runs():
    """The reference example's system after its round (its
    FederatedSystem recorded) and the port's run from its weights."""
    example = _load("examples/quickstart.py", "reference_quickstart")
    made = []

    class Recorded(ref_core.FederatedSystem):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    example.FederatedSystem = Recorded
    _, printed = _quiet(example.main)
    init = {k: np.asarray(v)
            for k, v in example.init_mlp(jax.random.PRNGKey(0)).items()}
    report, failures = quickstart.run(global_params=init, device="cpu")
    return made[0], printed, report, failures


def test_quickstart_round_and_trace_equal_the_reference(quickstart_runs):
    ref, _, report, failures = quickstart_runs
    assert failures == []
    assert report["round"] == round_record(ref.history[-1])
    assert report["trace"] == quickstart.shown_trace(ref.sim.trace_lines)


def test_quickstart_parameters_within_tolerance(quickstart_runs):
    ref, _, report, _ = quickstart_runs
    for k, want in ref.global_params.items():
        want = np.asarray(want)
        got = np.asarray(report["global_params"][k])
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= PARAM_RTOL, (k, rel)


def test_quickstart_accuracy_and_pin_are_the_references(quickstart_runs):
    ref, printed, report, _ = quickstart_runs
    assert f"before round: {report['acc0']:.3f}" in printed
    assert f"after round:  {report['acc1']:.3f}" in printed
    assert quickstart.PIN == {
        "round": round_record(ref.history[-1]),
        "trace": quickstart.shown_trace(ref.sim.trace_lines)}
    for line in quickstart.PIN["trace"]:
        assert f"  {line}" in printed


def test_quickstart_entry_point(capsys):
    assert quickstart.main(["--device", "cpu"]) == 0
    assert "OK: lost packet recovered" in capsys.readouterr().out


# --------------------------------------------------------------------------
# transport_scenarios, transport_comparison, transport_ablation
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def scenario_rows():
    ref = _load("benchmarks/transport_scenarios.py",
                "reference_transport_scenarios")
    return ({n: d for n, _, d in transport_scenarios.bench()},
            {n: d for n, _, d in ref.bench()})


@pytest.mark.parametrize("row", sorted(transport_scenarios.PINS))
def test_transport_scenario_row_equals_the_reference(scenario_rows, row):
    port, ref = scenario_rows
    assert port[row] == ref[row] == transport_scenarios.PINS[row]


def test_transport_scenario_pins_are_every_reference_row(scenario_rows):
    _, ref = scenario_rows
    assert transport_scenarios.PINS == ref


@pytest.fixture(scope="module")
def comparison_rows():
    ref = _load("benchmarks/transport_comparison.py",
                "reference_transport_comparison")
    clean, _ = ref.run("mudp", 0.0)
    target = ref_core.flatten_to_vector(clean.global_params)
    want, ref_params = {}, {}
    for p in transport_comparison.LOSS_RATES:
        for tr in ref_core.available_transports():
            system, results = ref.run(tr, p)
            vec = ref_core.flatten_to_vector(system.global_params)
            name = f"transport_comparison/{tr}_p{p:g}"
            want[name] = {"sim_ns": sum(r.duration_ns for r in results),
                          "arrivals": sum(len(r.arrived) for r in results),
                          "of": 2 * len(results),
                          "retx": sum(r.retransmissions for r in results),
                          "l2err": float(np.linalg.norm(vec - target))}
            ref_params[name] = vec
    got = transport_comparison.measure(device="cpu")
    derived = {n: d for n, _, d in ref.bench()}
    return got, want, derived, ref_params


@pytest.mark.parametrize("row", sorted(transport_comparison.PINS))
def test_transport_comparison_row_equals_the_reference(comparison_rows,
                                                       row):
    got, want, derived, _ = comparison_rows
    assert {k: v for k, v in got[row].items() if k != "wall_us"} == want[row]
    assert transport_comparison.derived(got[row]) == derived[row]
    assert transport_comparison.PINS[row] == derived[row]


@pytest.mark.parametrize("transport", ["mudp", "udp"])
def test_transport_comparison_global_model_is_bitwise(comparison_rows,
                                                      transport):
    _, _, _, ref_params = comparison_rows
    from repro_torch.core.packetizer import flatten_to_vector
    system, _ = transport_comparison.run(transport, 0.2, device="cpu")
    np.testing.assert_array_equal(
        flatten_to_vector(system.global_params),
        ref_params[f"transport_comparison/{transport}_p0.2"])


def test_transport_ablation_table_equals_the_reference():
    example = _load("examples/transport_ablation.py",
                    "reference_transport_ablation")
    rc, printed = _quiet(example.main)
    assert rc == 0
    ref_lines = printed.splitlines()[:len(transport_ablation.PINS)]
    lines, failures = transport_ablation.run_table("cpu")
    assert failures == []
    assert lines == ref_lines == transport_ablation.PINS


# --------------------------------------------------------------------------
# fl_convergence
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def convergence_arms():
    ref = _load("benchmarks/fl_convergence.py", "reference_fl_convergence")
    want = {}
    for name, tr, p in fl_convergence.ARMS:
        acc, system = ref.run(tr, p)
        want[name] = {"accuracy": acc,
                      "rounds": [round_record(r) for r in system.history],
                      "global_params": system.global_params}
    init = {k: np.asarray(v)
            for k, v in ref.init_mlp(jax.random.PRNGKey(0)).items()}
    got = fl_convergence.measure(global_params=init, device="cpu")
    return got, want


@pytest.mark.parametrize("arm", [a for a, _, _ in fl_convergence.ARMS])
def test_fl_convergence_arm_equals_the_reference(convergence_arms, arm):
    got, want = convergence_arms
    assert got[arm]["rounds"] == want[arm]["rounds"]
    assert (abs(got[arm]["accuracy"] - want[arm]["accuracy"])
            <= fl_convergence.ACC_TOL)


@pytest.mark.parametrize("arm", [a for a, _, _ in fl_convergence.ARMS])
def test_fl_convergence_parameters_within_tolerance(convergence_arms, arm):
    got, want = convergence_arms
    ref_params = want[arm]["global_params"]
    assert sorted(got[arm]["global_params"]) == sorted(ref_params)
    for k, ref_leaf in ref_params.items():
        ref_leaf = np.asarray(ref_leaf)
        leaf = np.asarray(got[arm]["global_params"][k])
        rel = np.linalg.norm(leaf - ref_leaf) / np.linalg.norm(ref_leaf)
        assert rel <= PARAM_RTOL, (k, rel)


def test_fl_convergence_gates_and_pins(convergence_arms):
    got, want = convergence_arms
    assert fl_convergence.gate_failures(got) == []
    assert fl_convergence.PINS == {
        name: {"accuracy": arm["accuracy"],
               "sha256": fl_convergence.digest(arm["rounds"]),
               "summary": fl_convergence.summary(arm["rounds"])}
        for name, arm in want.items()}
    assert abs(want["lossless_mudp"]["accuracy"] - 0.992) <= 0.001
    assert abs(want["lossy10_udp"]["accuracy"] - 0.764) <= 0.001


def test_fl_convergence_gate_catches_a_degraded_mudp_arm(convergence_arms):
    got, _ = convergence_arms
    bad = {k: dict(v) for k, v in got.items()}
    bad["lossy10_mudp"]["accuracy"] = bad["lossy10_udp"]["accuracy"]
    assert fl_convergence.gate_failures(bad)


def test_fl_convergence_entry_point_from_its_own_weights(capsys):
    assert fl_convergence.main(["--device", "cpu"]) == 0
    assert "acc6rounds=0.992" in capsys.readouterr().out


# --------------------------------------------------------------------------
# adaptive_bench
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def adaptive_reports():
    ref = _load("benchmarks/adaptive_bench.py", "reference_adaptive_bench")
    import argparse
    ns = argparse.Namespace(
        clients=32, seed=0, target_frac=0.02, params=2048, max_rounds=16,
        deadline_s=20.0, engine="batched", check=False, out=None)
    want = ref.compare(ns)
    with port_device_cpu():
        got = adaptive_bench.compare()
    return got, want


@contextlib.contextmanager
def port_device_cpu():
    from repro_torch import device as port_device
    with port_device.use_device("cpu"):
        yield


@pytest.mark.parametrize("arm", [*adaptive_bench.STATIC_ARMS, "adaptive"])
def test_adaptive_arm_equals_the_reference(adaptive_reports, arm):
    got, want = adaptive_reports
    g, w = got["arms"][arm], want["arms"][arm]
    for key in ("sim_ns_to_target", "rounds_to_target", "rounds_run",
                "renegotiations_by_cohort", "final_loss", "trace"):
        assert g[key] == w[key], key
    assert adaptive_bench.arm_view(g) == adaptive_bench.arm_view(w)
    assert adaptive_bench.PINS[arm] == adaptive_bench.arm_view(w)


def test_adaptive_gates_hold(adaptive_reports):
    got, want = adaptive_reports
    assert got["adaptive_beats_every_static"] is True
    assert want["adaptive_beats_every_static"] is True
    with port_device_cpu():
        assert adaptive_bench.check(got) == []


def test_adaptive_check_exits_1_when_a_static_arm_wins(monkeypatch,
                                                      adaptive_reports):
    got, _ = adaptive_reports
    losing = {**got, "adaptive_beats_every_static": False}
    monkeypatch.setattr(adaptive_bench, "compare", lambda **kw: losing)
    monkeypatch.setattr(adaptive_bench, "digests_frozen_under_static",
                        lambda: [])
    rc, _ = _quiet(adaptive_bench.main, ["--device", "cpu", "--check"])
    assert rc == 1


# --------------------------------------------------------------------------
# simcore
# --------------------------------------------------------------------------
def _simcore_pair(meta: dict, repeats: int = 1):
    ref = _load("benchmarks/simcore.py", "reference_simcore")
    want = {}
    for w in simcore.WORKLOADS:
        for tr in ("mudp", "udp", "mudp+fec", "tcp"):
            want[(w, tr)] = ref.run_cell(
                w, tr, n_clients=meta["clients"],
                payload=meta["payload_kib"] * 1024,
                n_params=meta["params"], seed=meta["seed"], repeats=1)
    with port_device_cpu():
        report, failures = simcore.run(repeats=repeats, **meta)
    return report, failures, want


@pytest.fixture(scope="module")
def simcore_small():
    return _simcore_pair(SIMCORE_SMALL)


@pytest.mark.parametrize("workload", list(simcore.WORKLOADS))
@pytest.mark.parametrize("transport", ["mudp", "udp", "mudp+fec", "tcp"])
def test_simcore_digests_equal_the_reference(simcore_small, workload,
                                             transport):
    report, failures, want = simcore_small
    assert failures == []
    cell, ref = report["cells"][workload][transport], want[(workload,
                                                            transport)]
    assert cell["digests_match"] and ref["digests_match"]
    for engine in ("per_packet", "batched"):
        assert cell[engine]["digest"] == ref[engine]["digest"]
        assert cell[engine]["events"] == ref[engine]["events"]


@pytest.mark.slow
def test_simcore_pins_at_the_ci_size():
    report, failures, want = _simcore_pair(simcore.PINNED_META)
    assert report["pinned"] and failures == []
    assert simcore.PINS == {
        w: {tr: want[(w, tr)]["batched"]["digest"]
            for tr in ("mudp", "udp", "mudp+fec", "tcp")}
        for w in simcore.WORKLOADS}


def test_simcore_exits_1_on_an_engine_divergence(monkeypatch, tmp_path):
    def diverging(workload, transport, **kw):
        return {"per_packet": {"wall_s": 1.0, "events_per_sec": 1.0,
                               "digest": "a"},
                "batched": {"wall_s": 1.0, "events_per_sec": 1.0,
                            "digest": "b"},
                "digests_match": False, "speedup_events_per_sec": 1.0}
    monkeypatch.setattr(simcore, "run_cell", diverging)
    rc, _ = _quiet(simcore.main, ["--device", "cpu", "--transports",
                                  "udp", "--out",
                                  str(tmp_path / "simcore.json")])
    assert rc == 1


# --------------------------------------------------------------------------
# wire_bench
# --------------------------------------------------------------------------
def _ref_wire_hashes(n_params: int) -> dict[str, str]:
    import hashlib
    ref = _load("benchmarks/wire_bench.py", "reference_wire_bench")
    vec = np.random.default_rng(0).standard_normal(n_params).astype(
        np.float32)
    out = {}
    for spec in ref.SPECS:
        p = ref_wire.parse_pipeline(spec)
        out[spec] = hashlib.sha256(
            p.encode(vec, ref._fresh_state(p, vec))).hexdigest()
    return out


@pytest.mark.parametrize("backend", port_wire.WIRE_BATCH_BACKENDS)
def test_wire_hashes_equal_the_reference(backend):
    vec = np.random.default_rng(0).standard_normal(
        WIRE_SMALL_PARAMS).astype(np.float32)
    with port_device_cpu(), port_wire.using_batch_backend(backend):
        hashes, failures = wire_bench.wire_hashes(vec)
    assert failures == []
    assert hashes == _ref_wire_hashes(WIRE_SMALL_PARAMS)


def test_wire_pins_are_the_references_at_the_ci_size():
    assert wire_bench.PINS == _ref_wire_hashes(wire_bench.PINNED_PARAMS)


@pytest.mark.parametrize("backend", port_wire.WIRE_BATCH_BACKENDS)
def test_wire_batch_bytes_equal_the_loop(backend, monkeypatch):
    monkeypatch.setattr(wire_bench, "BATCH_CLIENTS", (1, 16))
    with port_device_cpu(), port_wire.using_batch_backend(backend):
        sweep = wire_bench.run_batch_sweep(1)
    assert all(pt["bytes_identical"] for e in sweep for pt in e["points"])


def test_wire_check_exits_1_off_its_pins(monkeypatch):
    monkeypatch.setattr(wire_bench, "PINNED_PARAMS", WIRE_SMALL_PARAMS)
    monkeypatch.setattr(wire_bench, "BATCH_CLIENTS", (1, 16))
    monkeypatch.setattr(wire_bench, "BATCH_GATE_CLIENTS", 16)
    monkeypatch.setattr(wire_bench, "BATCH_GATE_SPEEDUP", 0.0)
    argv = ["--device", "cpu", "--check", "--params",
            str(WIRE_SMALL_PARAMS), "--repeats", "1"]
    monkeypatch.setattr(wire_bench, "PINS",
                        _ref_wire_hashes(WIRE_SMALL_PARAMS))
    assert _quiet(wire_bench.main, argv)[0] == 0
    monkeypatch.setattr(wire_bench, "PINS",
                        dict(wire_bench.PINS, raw="0" * 64))
    assert _quiet(wire_bench.main, argv)[0] == 1


# --------------------------------------------------------------------------
# every entry point
# --------------------------------------------------------------------------
ENTRY_POINTS = (quickstart, transport_scenarios,
                transport_comparison, transport_ablation, fl_convergence,
                adaptive_bench, simcore, wire_bench)


@pytest.mark.parametrize("module", ENTRY_POINTS,
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_entry_point_defaults_to_the_card(module):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    with pytest.raises(RuntimeError, match="cuda"):
        _quiet(module.main, [])


@pytest.mark.parametrize("module,pins,key", [
    (transport_scenarios, "PINS", "transport_scenarios/udp_tc3_lossless"),
    (transport_comparison, "PINS", "transport_comparison/udp_p0"),
])
def test_entry_point_exits_1_off_a_pinned_row(monkeypatch, module, pins,
                                              key):
    monkeypatch.setattr(module, pins, dict(getattr(module, pins),
                                           **{key: "wrong"}))
    assert _quiet(module.main, ["--device", "cpu"])[0] == 1


def test_ablation_exits_1_off_its_pin(monkeypatch):
    monkeypatch.setattr(transport_ablation, "PINS",
                        transport_ablation.PINS[:-1] + ["wrong"])
    assert _quiet(transport_ablation.main, ["--device", "cpu"])[0] == 1


def test_quickstart_exits_1_off_its_pin(monkeypatch):
    monkeypatch.setattr(quickstart, "PIN",
                        dict(quickstart.PIN, trace=["wrong"]))
    assert _quiet(quickstart.main, ["--device", "cpu"])[0] == 1

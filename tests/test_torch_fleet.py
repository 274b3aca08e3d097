"""The adaptive fleet path, the port's second slice, against the reference.

* Cohort draws (``sample_profiles``) are bit-identical.
* Consensus: the reference's and the port's ``build_fleet_training`` on
  the same small adaptive fleet (16 clients, 64 parameters, ``mudp+fec``,
  4 rounds, both packet engines) give equal profiles, equal round
  records, equal tier walks and renegotiation counts, and bitwise equal
  global parameters.  Every stage on that path is numpy-exact or a
  bit-exact kernel twin (the top-k and int8 kernels' plain versions).
* MLP (hidden 8, 8 clients, 3 rounds; the port's minibatch draws replaced
  by the reference's threefry draws, as in ``test_torch_mlp.py``): equal
  round records, tiers and renegotiations, and global parameters within
  ``atol=1e-4``.  Not bitwise: the two trainers differ by float noise of
  a few ULP, which can flip which index a top-k keeps or which int8 code
  a value rounds to, and error feedback carries such a flip into the next
  round.  Transport counts do not move: packet sizes depend only on the
  parameter count, the top-k count and the int8 block.
* The full-width constants ``chip_smoke.py`` checks
  (``repro_torch.fleet_sim.PINNED_ADAPTIVE``) are the reference's live
  48-client, 10-round MLP run, and the port reproduces them.
* What no slice serves is refused with an error naming what is
  available, and the example's CLI runs every option on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import fleet as ref_fleet  # noqa: E402
from repro.core import rounds as ref_rounds  # noqa: E402
from repro_torch import device as port_device  # noqa: E402
from repro_torch import fleet_sim  # noqa: E402
from repro_torch.core import fleet as port_fleet  # noqa: E402
from repro_torch.core import rounds as port_rounds  # noqa: E402
from repro_torch.core.topology import make_topology  # noqa: E402
from repro_torch.kernels.fedavg import ops as fedavg_ops  # noqa: E402
from repro_torch.kernels.quantize import ops as quant_ops  # noqa: E402
from repro_torch.kernels.topk import ops as topk_ops  # noqa: E402
from repro_torch.models import mlp as port_mlp  # noqa: E402
from test_torch_mlp import SMALL, jax_minibatch_indices  # noqa: E402

NS = 1_000_000_000


@pytest.fixture(autouse=True)
def _cpu():
    with port_device.use_device("cpu"):
        yield


def _configs(pkg, *, n_clients, model, model_args, engine="batched",
             kind="mudp+fec", control="adaptive"):
    """``fleet_sim``'s adaptive arm, spelled in either package."""
    fleet_cls, fl_cls, tc_cls = (
        (ref_fleet.FleetConfig, ref_rounds.FLConfig,
         ref_rounds.TransportConfig) if pkg == "ref" else
        (port_fleet.FleetConfig, port_rounds.FLConfig,
         port_rounds.TransportConfig))
    wire = ({"uplink": fleet_sim.UPLINK, "downlink": fleet_sim.DOWNLINK}
            if control == "adaptive" else {})
    fleet = fleet_cls(n_clients=n_clients, seed=fleet_sim.SEED,
                      engine=engine, mode="sync", round_deadline_ns=4 * NS,
                      topology="star", model=model, model_args=model_args,
                      train_backend="python", control=control)
    cfg = fl_cls(aggregation="fedavg", transport=tc_cls(
        kind=kind, timeout_ns=2 * NS, udp_deadline_ns=3 * NS, **wire))
    return fleet, cfg


def _run(pkg, rounds, **kwargs):
    build = (ref_fleet if pkg == "ref" else port_fleet).build_fleet_training(
        *_configs(pkg, **kwargs))
    policy = build.system.core.controller
    records = []
    for _ in range(rounds):
        res = build.system.run_round()
        tiers = ([policy.tier_of(p.addr) for p in build.profiles]
                 if policy is not None else None)
        records.append({
            "roster": res.roster, "arrived": res.arrived,
            "failed": res.failed, "late_folded": res.late_folded,
            "packets": res.packets_sent,
            "retransmissions": res.retransmissions,
            "bytes": res.bytes_sent, "decode_errors": res.decode_errors,
            "tiers": tiers})
    return build, records


def _pinned_view(records):
    """Per-round records in the form of ``fleet_sim.PINNED_ADAPTIVE``."""
    return tuple({"arrived": len(r["arrived"]),
                  "late_folded": r["late_folded"],
                  "retransmissions": r["retransmissions"],
                  "tiers": [r["tiers"].count(t) for t in range(3)]}
                 for r in records)


# --------------------------------------------------------------------------
# Cohorts
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n,seed", [(48, 7), (16, 0), (300, 12)])
def test_profiles_bit_identical(n, seed):
    ours = port_fleet.sample_profiles(port_fleet.FleetConfig(
        n_clients=n, seed=seed))
    theirs = ref_fleet.sample_profiles(ref_fleet.FleetConfig(
        n_clients=n, seed=seed))
    assert [dataclasses.astuple(p) for p in ours] == \
        [dataclasses.astuple(p) for p in theirs]
    assert port_fleet.profiles_digest(ours) == \
        ref_fleet.profiles_digest(theirs)
    assert port_fleet.cohort_counts(ours) == ref_fleet.cohort_counts(theirs)


def test_cohort_presets_match_reference():
    assert {k: dataclasses.astuple(v)
            for k, v in port_fleet.COHORT_PRESETS.items()} == \
        {k: dataclasses.astuple(v)
         for k, v in ref_fleet.COHORT_PRESETS.items()}
    assert port_fleet.DEFAULT_MIX == ref_fleet.DEFAULT_MIX


# --------------------------------------------------------------------------
# The slice as a whole
# --------------------------------------------------------------------------
@pytest.mark.parametrize("engine", ["per_packet", "batched"])
def test_consensus_adaptive_fleet_bitwise(engine):
    kw = dict(n_clients=16, model="consensus", model_args={"n_params": 64},
              engine=engine)
    ours, ours_rec = _run("port", 4, **kw)
    theirs, theirs_rec = _run("ref", 4, **kw)
    assert port_fleet.profiles_digest(ours.profiles) == \
        ref_fleet.profiles_digest(theirs.profiles)
    assert ours_rec == theirs_rec
    assert ours.system.core.renegotiations == \
        theirs.system.core.renegotiations
    assert sum(ours.system.core.renegotiations.values()) > 0
    assert len({t for r in ours_rec for t in r["tiers"]}) == 3
    np.testing.assert_array_equal(
        ours.system.global_params["w"].view(np.uint32),
        theirs.system.global_params["w"].view(np.uint32))


def test_mlp_adaptive_fleet_matches_reference(monkeypatch):
    monkeypatch.setattr(port_mlp, "minibatch_indices",
                        jax_minibatch_indices)
    kw = dict(n_clients=8, model="mlp", model_args=dict(SMALL))
    ours, ours_rec = _run("port", 3, **kw)
    theirs, theirs_rec = _run("ref", 3, **kw)
    assert ours_rec == theirs_rec
    assert ours.system.core.renegotiations == \
        theirs.system.core.renegotiations
    for key, want in theirs.system.global_params.items():
        np.testing.assert_allclose(ours.system.global_params[key], want,
                                   rtol=0, atol=1e-4)


def test_adaptive_path_goes_through_every_kernel_wrapper(monkeypatch):
    """Each client's encode (topk gather, quantize; the EF residual's
    dequantize and topk scatter), the server's batch decode and the
    delta-domain mean (the fedavg fold) all call the kernel wrappers; on
    the card those launch the kernels."""
    calls = {}
    for mod, name in ((topk_ops, "topk_gather"), (topk_ops, "topk_scatter"),
                      (quant_ops, "quantize"), (quant_ops, "dequantize"),
                      (fedavg_ops, "fedavg")):
        def counted(*args, _fn=getattr(mod, name), _name=name, **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, counted)
    _, records = _run("port", 2, n_clients=8, model="consensus",
                      model_args={"n_params": 300})
    assert set(calls) == {"topk_gather", "topk_scatter", "quantize",
                          "dequantize", "fedavg"}
    assert calls["fedavg"] == 2                     # one mean a round
    # Every aggregated uplink was encoded once, per client.
    assert calls["topk_gather"] >= sum(len(r["arrived"]) for r in records)


def test_full_width_constants_are_the_reference_run():
    """``PINNED_ADAPTIVE`` is the reference's 48-client, 10-round MLP run,
    and the port reproduces it.  The port side trains the consensus
    objective at the MLP's 25,450 parameters: the pinned counts depend on
    the parameter count only (the reference gives the same counts either
    way), and the MLP's own parity is the test above."""
    full = dict(n_clients=fleet_sim.N_CLIENTS)
    _, theirs = _run("ref", 10, model="mlp", model_args=None, **full)
    assert _pinned_view(theirs) == fleet_sim.PINNED_ADAPTIVE
    _, ours = _run("port", 10, model="consensus",
                   model_args={"n_params": 25_450}, **full)
    assert _pinned_view(ours) == fleet_sim.PINNED_ADAPTIVE
    assert all(r["decode_errors"] == 0 for r in ours)


def test_fleet_sim_arms_are_the_reference_configs():
    for control in ("static", "adaptive"):
        ours_fleet, ours_cfg = fleet_sim.configs(
            "mudp+fec" if control == "adaptive" else "udp",
            n_clients=12, model="consensus", control=control)
        fleet, cfg = _configs(
            "port", n_clients=12, model="consensus", model_args=None,
            kind="mudp+fec" if control == "adaptive" else "udp",
            control=control)
        assert ours_fleet == fleet and ours_cfg == cfg


def test_fleet_sim_run_records_match_reference():
    recs = fleet_sim.run("udp", rounds=2, n_clients=12, model="consensus",
                         control="static", device="cpu")
    _, theirs = _run("ref", 2, n_clients=12, model="consensus",
                     model_args=None, kind="udp", control="static")
    for rec, want in zip(recs[1:], theirs):
        assert rec["arrived"] == len(want["arrived"])
        assert rec["late_folded"] == want["late_folded"]
        assert rec["bytes_sent"] == want["bytes"]
        assert rec["tiers"] is None


# --------------------------------------------------------------------------
# What no slice serves is refused; every option of the example runs
# --------------------------------------------------------------------------
def test_unported_configurations_are_refused():
    """A name no registry holds raises with the registered names, and the
    flow engine, which waits for a later slice, raises too."""
    with pytest.raises(ValueError, match=r"unknown topology 'ring'.*"
                                         r"'gossip', 'hier', 'star'"):
        port_fleet.FleetConfig(topology="ring")
    with pytest.raises(ValueError, match=r"unknown topology 'ring'.*"
                                         r"'gossip', 'hier', 'star'"):
        make_topology("ring")
    with pytest.raises(ValueError, match=r"unknown mode 'ring'.*"
                                         r"'async', 'sync'"):
        port_fleet.FleetConfig(mode="ring")
    with pytest.raises(ValueError, match=r"unknown train backend 'ring'.*"
                                         r"'python', 'shard', 'vmap'"):
        port_fleet.FleetConfig(train_backend="ring")
    with pytest.raises(NotImplementedError, match="flow"):
        port_fleet.build_fleet_training(port_fleet.FleetConfig(
            n_clients=2, engine="flow"))


@pytest.mark.parametrize("argv", [["--topology", "ring"],
                                  ["--mode", "ring"],
                                  ["--train-backend", "ring"]])
def test_fleet_sim_cli_refuses_what_waits(argv, capsys):
    """The CLI takes the reference example's choices and refuses others."""
    with pytest.raises(SystemExit) as exc:
        fleet_sim.main(argv)
    assert exc.value.code == 2
    assert "invalid choice: 'ring'" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["--mode", "async"],
                                  ["--topology", "hier", "--mode", "sync"],
                                  ["--train-backend", "shard", "--mode",
                                   "sync", "--model", "mlp"]])
def test_fleet_sim_cli_runs_every_option(argv, capsys):
    """``--mode async``, ``--topology hier`` and ``--train-backend shard``
    each run a round of both static arms on the CPU."""
    fleet_sim.main(argv + ["--device", "cpu", "--rounds", "1",
                           "--clients", "12"])
    out = capsys.readouterr().out
    assert out.count("round 0:") == 2             # the mudp and udp arms
    if "shard" in argv:
        assert "[shard] 12 client-trainings in" in out
    if "hier" in argv:
        assert "edge->root" in out


def test_fleet_sim_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with port_device.use_device("cuda"):
        with pytest.raises(RuntimeError, match="cuda"):
            fleet_sim.build(model="consensus")
    with pytest.raises(RuntimeError, match="cuda"):
        fleet_sim.build(model="consensus", device="cuda")

"""The reference's twin of a ``repro_torch.fleet_sim`` arm.

:func:`reference_build` turns the port's configuration of an arm
(:func:`repro_torch.fleet_sim.configs`) into the reference's own
``FleetConfig`` / ``FLConfig`` (the fields are the same) and builds it
with the reference's ``build_fleet_training``, so both packages run the
very arm the reference's ``examples/fleet_sim.py`` runs.  The port's
``fleet_sim.run_rounds`` drives either build (the systems share their
surface), which is how the pins in ``fleet_sim`` are recomputed from the
reference's live run.
"""

from __future__ import annotations

import dataclasses

from repro.core import fleet as ref_fleet
from repro.core import rounds as ref_rounds
from repro_torch import fleet_sim


def to_reference(fleet, cfg):
    """The reference's FleetConfig and FLConfig with the same fields (its
    numpy fedavg in place of the port's kernel backend: the same bits)."""
    ref_cfg = ref_rounds.FLConfig(**{
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)},
        "transport": ref_rounds.TransportConfig(**dataclasses.asdict(
            cfg.transport)),
        "aggregation_backend": "numpy"})
    ref_fl = ref_fleet.FleetConfig(**{
        f.name: getattr(fleet, f.name) for f in dataclasses.fields(fleet)})
    return ref_fl, ref_cfg


def reference_build(transport, **arm):
    """The reference's build of ``fleet_sim.configs(transport, **arm)``."""
    return ref_fleet.build_fleet_training(
        *to_reference(*fleet_sim.configs(transport, **arm)))


def reference_run(transport, rounds=None, **arm):
    """``fleet_sim.run_rounds`` over the reference's build of the arm."""
    if rounds is None:
        rounds = fleet_sim.rounds_for(arm.get("mode", "sync"))
    build = reference_build(transport, **arm)
    return build, fleet_sim.run_rounds(build, rounds)


# --------------------------------------------------------------------------
# The port's twins of the conftest fleet fixtures
# --------------------------------------------------------------------------
NS = 1_000_000_000


def port_consensus_fleet(topology="star", *, n=16, rounds=3, seed=7,
                         obj_params=48, obj_seed=3, transport="mudp",
                         fl_cfg=None, **fleet_kw):
    """The port's ``consensus_fleet``: ``build_fleet`` over a
    ``ConsensusObjective``, then ``rounds`` rounds (0 skips running)."""
    from repro_torch.core import fleet as port_fleet
    from repro_torch.core import rounds as port_rounds
    obj = port_fleet.ConsensusObjective(n, obj_params, seed=obj_seed)
    fleet = port_fleet.FleetConfig(n_clients=n, seed=seed,
                                   topology=topology, **fleet_kw)
    cfg = fl_cfg or port_rounds.FLConfig(
        transport=port_rounds.TransportConfig(kind=transport))
    sim, system, _ = port_fleet.build_fleet(
        fleet, obj.init_params(), lambda i, p: obj.train_fn(i, p), cfg)
    results = system.run_rounds(rounds) if rounds else []
    return obj, sim, system, results


def port_training_fleet(backend, *, seed=0, transport="mudp", mode="sync",
                        topology="star", model="consensus", rounds=2,
                        n_clients=10, model_args=None, **fleet_kw):
    """The port's ``training_fleet``: ``build_fleet_training`` with a model
    and train backend (the same default model arguments)."""
    from repro_torch.core import fleet as port_fleet
    from repro_torch.core import rounds as port_rounds
    if model_args is None:
        model_args = ({"n_params": 96} if model == "consensus"
                      else {"n_train": 512, "n_test": 128,
                            "shard_size": 32, "hidden": 16})
    fleet = port_fleet.FleetConfig(
        n_clients=n_clients, seed=seed, topology=topology, mode=mode,
        model=model, train_backend=backend, model_args=model_args,
        **fleet_kw)
    fl = port_rounds.FLConfig(
        aggregation="fedavg", mode=mode,
        transport=port_rounds.TransportConfig(kind=transport,
                                              timeout_ns=2 * NS,
                                              udp_deadline_ns=3 * NS))
    build = port_fleet.build_fleet_training(fleet, fl)
    results = build.system.run_rounds(rounds)
    return build, results


def records(results) -> list[dict]:
    """Round results as plain dicts (both packages' ``RoundResult`` have
    the same fields)."""
    return [dataclasses.asdict(r) for r in results]

"""The benchmark harness on the port: one suite a paper table (and the
roofline), each row ``name,us_per_call,derived``.

The counterpart of the reference's ``benchmarks/run.py``: the same suites
in the same order, the same ``--only`` choices, the same header and row
format, and one ``<suite>/suite_wall,<us>,complete`` row a suite.  Every
suite's ``bench()`` is the port's own (:data:`SUITES`), with the
reference's arguments, row names and derived fields, except that the
kernel rows say ``_kernel`` where the reference says ``_pallas`` (and add
``;route=cuda|plain``), and the aggregation suite's timing pair is
``fedavg_kernel`` / ``fedavg_torch_ref`` (the reference's
``fedavg_kernel_interpret`` / ``fedavg_jnp_ref``).  On the card the
aggregation and kernels suites, the wire suite's int8 and topk stages
and the FL suites' rounds run on the hand-written kernels (all eight
between them); the codecs suite is host numpy, as the reference's.

Everything runs on ``--device`` (default ``cuda``; nothing falls back to
the CPU).  A suite that raises prints the reference's
``<suite>/SUITE_ERROR,0.0,<Type>:<msg>`` row (its traceback to stderr)
and the other suites still run; unlike the reference's harness, the
process then exits 1, so a failed suite never passes silently.

:data:`PINS` holds every row of the reference's run and its deterministic
fields; :func:`failures` holds a run's rows against them (the wall-derived
fields, ``speedup``, ``eps``, ``enc_mb_s``, ``dec_mb_s`` and
``batch_mb_s``, are not held; ``acc6rounds`` within
:data:`repro_torch.fl_convergence.ACC_TOL`).  The kernel contracts are the
suites' own: the kernels and aggregation suites raise
:class:`repro_torch.kernels.KernelError` where a kernel disagrees with its
plain version, which is a ``SUITE_ERROR`` row.

    PYTHONPATH=src python -m repro_torch.bench_run --device cpu
    PYTHONPATH=src python -m repro_torch.bench_run --device cpu --only codecs
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback

from repro_torch import (adaptive_bench, aggregation_bench, codecs_bench,
                         fl_convergence, fleet_gates, fleet_scale,
                         kernels_bench, roofline, simcore,
                         transport_comparison, transport_scenarios,
                         wire_bench)
from repro_torch import device as _device

SUITES = {
    "simcore": simcore.bench,
    "transport_scenarios": transport_scenarios.bench,
    "transport_comparison": transport_comparison.bench,
    "fleet_scale": fleet_scale.bench,
    "topology": fleet_gates.bench_topology,
    "async_vs_sync": fleet_gates.bench_async_vs_sync,
    "adaptive": adaptive_bench.bench,
    "fl_convergence": fl_convergence.bench,
    "codecs": codecs_bench.bench,
    "wire": wire_bench.bench,
    "aggregation": aggregation_bench.bench,
    "kernels": kernels_bench.bench,
    "roofline": roofline.bench,
    "vmap_train": fleet_gates.bench_vmap_train,
}

#: The derived fields that depend on the simulation or the arithmetic
#: alone, held equal to the reference's strings (``acc6rounds`` within a
#: tolerance).
DETERMINISTIC = frozenset((
    "sim_s", "sent", "retx", "parity", "nacks", "delivered", "arrivals",
    "l2err", "bytes", "loss", "root_bytes", "server_nodes",
    "sim_s_to_target", "rounds", "reneg", "final_loss", "async/sync",
    "beats_every_static", "identical", "bytes_per_param", "max_err",
    "perm_spread_l2", "max_dev_from_fedavg", "bytes_identical",
    "determinism", "acc6rounds"))

#: The reference's rows (the roofline's aside: they follow the dry-run's
#: reports on disk), renamed as the port names them, in order, each with
#: its deterministic fields ("" where it has none).
PINS = {
    "simcore/mudp_burst_c16": "identical=True",
    "simcore/udp_burst_c16": "identical=True",
    "transport_scenarios/mudp_tc1_drop_pkt2":
        "sim_s=8.01;sent=5;retx=1;parity=0;nacks=1;delivered=4/4",
    "transport_scenarios/mudp_tc2_drop_tail":
        "sim_s=14.01;sent=7;retx=3;parity=0;nacks=2;delivered=4/4",
    "transport_scenarios/mudp_tc3_lossless":
        "sim_s=4.01;sent=4;retx=0;parity=0;nacks=0;delivered=4/4",
    "transport_scenarios/mudp+fec_tc1_drop_pkt2":
        "sim_s=4.01;sent=4;retx=0;parity=1;nacks=0;delivered=4/4",
    "transport_scenarios/mudp+fec_tc2_drop_tail":
        "sim_s=14.00;sent=7;retx=3;parity=1;nacks=2;delivered=4/4",
    "transport_scenarios/mudp+fec_tc3_lossless":
        "sim_s=4.01;sent=4;retx=0;parity=1;nacks=0;delivered=4/4",
    "transport_scenarios/tcp_tc1_drop_pkt2":
        "sim_s=22.01;sent=5;retx=1;parity=0;nacks=0;delivered=4/4",
    "transport_scenarios/tcp_tc2_drop_tail":
        "sim_s=38.01;sent=7;retx=3;parity=0;nacks=0;delivered=4/4",
    "transport_scenarios/tcp_tc3_lossless":
        "sim_s=16.01;sent=4;retx=0;parity=0;nacks=0;delivered=4/4",
    "transport_scenarios/udp_tc1_drop_pkt2":
        "sim_s=0.00;sent=4;retx=0;parity=0;nacks=0;delivered=3/4",
    "transport_scenarios/udp_tc2_drop_tail":
        "sim_s=0.00;sent=4;retx=0;parity=0;nacks=0;delivered=1/4",
    "transport_scenarios/udp_tc3_lossless":
        "sim_s=0.00;sent=4;retx=0;parity=0;nacks=0;delivered=4/4",
    **{f"transport_comparison/{name}": fields for name, fields in (
        ("mudp_p0", "sim_s=0.024;arrivals=2/2;retx=0;l2err=0.000"),
        ("mudp+fec_p0", "sim_s=0.024;arrivals=2/2;retx=0;l2err=0.000"),
        ("tcp_p0", "sim_s=0.092;arrivals=2/2;retx=0;l2err=0.000"),
        ("udp_p0", "sim_s=0.019;arrivals=2/2;retx=0;l2err=0.000"),
        ("mudp_p0.05", "sim_s=0.035;arrivals=2/2;retx=9;l2err=0.000"),
        ("mudp+fec_p0.05", "sim_s=2.021;arrivals=2/2;retx=6;l2err=0.000"),
        ("tcp_p0.05", "sim_s=2.251;arrivals=2/2;retx=20;l2err=0.000"),
        ("udp_p0.05", "sim_s=0.019;arrivals=2/2;retx=0;l2err=43.955"),
        ("mudp_p0.1", "sim_s=2.034;arrivals=2/2;retx=22;l2err=0.000"),
        ("mudp+fec_p0.1", "sim_s=2.021;arrivals=2/2;retx=13;l2err=0.000"),
        ("tcp_p0.1", "sim_s=18.392;arrivals=2/2;retx=24;l2err=0.000"),
        ("udp_p0.1", "sim_s=0.019;arrivals=2/2;retx=0;l2err=72.415"),
        ("mudp_p0.2", "sim_s=4.034;arrivals=2/2;retx=54;l2err=0.000"),
        ("mudp+fec_p0.2", "sim_s=4.021;arrivals=2/2;retx=46;l2err=0.000"),
        ("tcp_p0.2", "sim_s=62.574;arrivals=2/2;retx=55;l2err=0.000"),
        ("udp_p0.2", "sim_s=0.019;arrivals=2/2;retx=0;l2err=117.473"))},
    "fleet_scale/mudp_c16": "sim_s=4.70;bytes=121795;retx=13;loss=0.2369",
    "fleet_scale/mudp+fec_c16": "sim_s=3.56;bytes=145402;retx=4;loss=0.2369",
    "fleet_scale/tcp_c16": "sim_s=7.17;bytes=111071;retx=3;loss=0.2369",
    "fleet_scale/udp_c16": "sim_s=4.61;bytes=100968;retx=0;loss=0.3386",
    "topology/star_c16": "loss=0.0593;root_bytes=170425;server_nodes=1",
    "topology/hier_c16": "loss=0.0593;root_bytes=43561;server_nodes=5",
    "topology/gossip_c16": "loss=0.0593;root_bytes=563958;server_nodes=0",
    "async_vs_sync/sync_c16":
        "sim_s_to_target=11.96;rounds=2;final_loss=0.0001",
    "async_vs_sync/async_c16":
        "sim_s_to_target=6.07;rounds=5;final_loss=0.0010",
    "async_vs_sync/ratio": "async/sync=0.508",
    "adaptive/static_tier0_c24":
        "sim_s_to_target=26.13;rounds=4;reneg=0;final_loss=0.0001",
    "adaptive/static_tier1_c24":
        "sim_s_to_target=52.46;rounds=9;reneg=0;final_loss=0.0019",
    "adaptive/static_tier2_c24":
        "sim_s_to_target=0.00;rounds=None;reneg=0;final_loss=0.1804",
    "adaptive/adaptive_c24":
        "sim_s_to_target=16.09;rounds=3;reneg=56;final_loss=0.0003",
    "adaptive/beats_every_static": "beats_every_static=True",
    "fl_convergence/lossless_mudp": "acc6rounds=0.992",
    "fl_convergence/lossy10_mudp": "acc6rounds=0.992",
    "fl_convergence/lossy10_mudp+fec": "acc6rounds=0.992",
    "fl_convergence/lossy10_udp": "acc6rounds=0.764",
    "codecs/hex": "bytes_per_param=8.00;max_err=0.00e+00",
    "codecs/raw": "bytes_per_param=4.00;max_err=0.00e+00",
    "codecs/int8": "bytes_per_param=1.00;max_err=1.86e-02",
    "codecs/topk": "bytes_per_param=0.08;max_err=nan",
    "wire/raw": "bytes_per_param=4.000",
    "wire/hex": "bytes_per_param=8.000",
    "wire/int8(1024)": "bytes_per_param=1.004",
    "wire/topk(0.01)": "bytes_per_param=0.080",
    "wire/delta|ef|int8(1024)": "bytes_per_param=1.004",
    "wire/delta|ef|topk(0.01)|int8(1024)": "bytes_per_param=0.050",
    "wire/topk(0.01)|int8(256)": "bytes_per_param=0.050",
    "wire_batch/int8(1024)@256": "bytes_identical=True",
    "wire_batch/topk(0.01)|int8(256)@256": "bytes_identical=True",
    "wire_batch/delta|ef|topk(0.01)|int8(1024)@256": "bytes_identical=True",
    "wire/determinism": "determinism=ok",
    "aggregation/pairwise_order_dependence":
        "perm_spread_l2=20.621;max_dev_from_fedavg=10.835",
    "aggregation/fedavg_kernel": "",
    "aggregation/fedavg_torch_ref": "",
    **{f"kernels/{name}_{kind}": "" for name in kernels_bench.PAIRS
       for kind in ("kernel", "ref")},
    **{f"vmap_train/{backend}_{k}c": "" for k in (16, 64)
       for backend in ("python", "vmap")},
}

#: The reference's row names where the port's differ.
RENAMES = {"aggregation/fedavg_kernel_interpret": "aggregation/fedavg_kernel",
           "aggregation/fedavg_jnp_ref": "aggregation/fedavg_torch_ref",
           **{f"kernels/{name}_pallas": f"kernels/{name}_kernel"
              for name in kernels_bench.PAIRS}}

def suite_of(row: str) -> str:
    head = row.split("/", 1)[0]
    return "wire" if head == "wire_batch" else head


def fields(row: str, derived: str) -> dict[str, str]:
    """A row's derived fields by name; a bare value (``True``, ``ok``)
    is named after the row's last path part."""
    out = {}
    for part in derived.split(";"):
        key, sep, value = part.partition("=")
        out[key if sep else row.rsplit("/", 1)[-1]] = value if sep else part
    return out


def pinned(row: str, derived: str) -> str:
    """The deterministic fields of a row, as :data:`PINS` writes them."""
    return ";".join(f"{k}={v}" for k, v in fields(row, derived).items()
                    if k in DETERMINISTIC)


def expected_rows(suite: str, roofline_dir: str = roofline.OUT_DIR
                  ) -> list[str]:
    """The rows a suite prints, in order (the roofline's from the dry-run
    reports in ``roofline_dir``), its ``suite_wall`` row aside."""
    if suite != "roofline":
        return [row for row in PINS if suite_of(row) == suite]
    cells = roofline.load_cells(roofline_dir)
    if not cells:
        return ["roofline/missing_inputs"]
    return [f"roofline/{r['arch']}/{r['shape']}/{r['mesh']}"
            for _, r in sorted(cells.items()) if r["status"] == "ok"
            ] + ["roofline/summary"]


def parse(text: str) -> list[tuple[str, float, str]]:
    """The rows of a run's output (its header and any other line aside)."""
    rows = []
    for line in text.splitlines():
        parts = line.split(",", 2)
        if len(parts) != 3 or "/" not in parts[0]:
            continue
        try:
            rows.append((parts[0], float(parts[1]), parts[2]))
        except ValueError:
            continue
    return rows


def failures(rows, suites=None, roofline_dir: str = roofline.OUT_DIR
             ) -> list[str]:
    """A run's rows (``suites``: those it ran, default all) against
    :data:`PINS`: a suite error, a missing, extra or misplaced row, a
    deterministic field off its pin (``acc6rounds`` beyond
    ``ACC_TOL``)."""
    out = []
    by_suite: dict[str, list[tuple[str, str]]] = {}
    for row, _, derived in rows:
        if row.endswith("/SUITE_ERROR"):
            out.append(f"{row}: {derived}")
        elif not row.endswith("/suite_wall"):
            by_suite.setdefault(suite_of(row), []).append((row, derived))
    for suite in suites or SUITES:
        got = by_suite.pop(suite, [])
        want = expected_rows(suite, roofline_dir)
        if [r for r, _ in got] != want:
            out.append(f"{suite}: rows {[r for r, _ in got]} != {want}")
        for row, derived in got:
            have, pin = fields(row, derived), PINS.get(row)
            for key, value in (fields(row, pin) if pin else {}).items():
                if key == "acc6rounds" and key in have:
                    if abs(float(have[key]) - float(value)) \
                            > fl_convergence.ACC_TOL:
                        out.append(f"{row}: {key}={have[key]} not within "
                                   f"{fl_convergence.ACC_TOL} of {value}")
                elif have.get(key) != value:
                    out.append(f"{row}: {key}={have.get(key)} != pinned "
                               f"{value}")
    out += [f"{suite}: rows of a suite not run or not known"
            for suite in by_suite]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None, choices=list(SUITES))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    suites = {args.only: SUITES[args.only]} if args.only else SUITES
    failed = False
    print("name,us_per_call,derived")
    with _device.use_device(dev):
        for name, bench in suites.items():
            t0 = time.perf_counter()
            try:
                for row, us, derived in bench():
                    print(f"{row},{us:.1f},{derived}", flush=True)
            except Exception as e:  # noqa: BLE001 - a suite failure is a row
                traceback.print_exc()
                print(f"{name}/SUITE_ERROR,0.0,{type(e).__name__}:{e}",
                      flush=True)
                failed = True
            print(f"{name}/suite_wall,"
                  f"{(time.perf_counter() - t0) * 1e6:.0f},complete",
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

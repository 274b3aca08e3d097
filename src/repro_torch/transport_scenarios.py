"""The paper's §V test cases (Figs 5-7), quantified for every registered
transport, on the port.

The counterpart of the reference's ``benchmarks/transport_scenarios.py``:
for each (transport, case) one 4-packet transaction from 10.1.2.4 to
10.1.2.5 over 5 Mbps / 2000 ms links, with packet 2 (``tc1_drop_pkt2``),
packets 2-4 (``tc2_drop_tail``) or nothing (``tc3_lossless``) dropped on
the first transmission.  Each row gives the simulated transaction
duration, data packets sent, retransmissions, parity packets, NACKs and
the packets delivered through the unified ``Delivery`` contract.  Reliable
transports must deliver the exact bytes; the UDP baseline reports what
survived.  The triple-loss case takes 14.01 s over ``mudp`` (the paper
logs about 17.5 s for it).

Every field but the wall time equals the reference's row (:data:`PINS`,
recomputed from the reference by ``tests/test_torch_benchmarks.py``).
The transactions are host Python: no device work, no kernel.

    PYTHONPATH=src python -m repro_torch.transport_scenarios --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time

from repro_torch import device as _device
from repro_torch.core.channel import DropList, Link
from repro_torch.core.packetizer import packetize
from repro_torch.core.simulator import Simulator
from repro_torch.core.transport import (TransportConfig, available_transports,
                                        make_transport)
from repro_torch.paper_cases import CLIENT, PAPER_DELAY, PAPER_RATE, SERVER

CASES = {
    "tc1_drop_pkt2": {(2, 0)},
    "tc2_drop_tail": {(2, 0), (3, 0), (4, 0)},
    "tc3_lossless": set(),
}


def run_case(transport_name: str, drops):
    cfg = TransportConfig(kind=transport_name, timeout_ns=6_000_000_000,
                          udp_deadline_ns=30_000_000_000, fec_block=4)
    transport = make_transport(transport_name)
    sim = Simulator()
    sim.connect(CLIENT, SERVER, Link(PAPER_RATE, PAPER_DELAY, DropList(drops)),
                Link(PAPER_RATE, PAPER_DELAY))
    data = bytes(range(256)) * 18  # ~4.6KB -> 4 packets at MTU 1228
    pkts = packetize(data, CLIENT, mtu=1228)
    if len(pkts) != 4:
        raise AssertionError(f"{len(pkts)} packets, the paper's cases use 4")
    got, outcome = {}, {}
    rx = transport.create_receiver(sim, sim.node(SERVER), cfg,
                                   lambda d: got.update(d=d))
    tx = transport.create_sender(sim, sim.node(CLIENT), sim.node(SERVER),
                                 pkts, cfg,
                                 on_complete=lambda s: outcome.update(ok=True),
                                 on_fail=lambda s: outcome.update(ok=False))
    tx.start()
    sim.run()
    d = got.get("d")
    if transport.caps.reliable and not (
            outcome.get("ok") and d is not None and d.complete
            and d.reassemble() == data):
        raise AssertionError(f"{transport_name}: the reliable transport "
                             f"did not deliver the exact bytes")
    return tx, rx, d


def bench() -> list[tuple[str, float, str]]:
    """``(row name, wall us, derived fields)`` for every (transport,
    case), as the reference's ``bench()``."""
    rows = []
    for name in available_transports():
        for case, drops in CASES.items():
            t0 = time.perf_counter()
            tx, rx, d = run_case(name, drops)
            wall_us = (time.perf_counter() - t0) * 1e6
            delivered = 0 if d is None else len(d.packets)
            total = 4 if d is None else d.total
            rows.append((f"transport_scenarios/{name}_{case}", wall_us,
                         f"sim_s={tx.stats.duration_ns/1e9:.2f}"
                         f";sent={tx.stats.data_sent}"
                         f";retx={tx.stats.retransmissions}"
                         f";parity={tx.stats.parity_sent}"
                         f";nacks={getattr(rx, 'stats_nacks_sent', 0)}"
                         f";delivered={delivered}/{total}"))
    return rows


#: The reference's derived fields, by row.
PINS = {
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
}


def pin_failures(rows, pins: dict) -> list[str]:
    """Each row whose derived fields differ from its pin, and each pinned
    row missing."""
    got = {name: derived for name, _, derived in rows}
    return [f"{name}: {got.get(name)} != pinned {want}"
            for name, want in pins.items() if got.get(name) != want] + [
        f"{name}: not pinned" for name in got if name not in pins]


def run() -> tuple[list, list[str]]:
    """``(rows, failures)``: every row held against :data:`PINS`."""
    rows = bench()
    return rows, pin_failures(rows, PINS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda); the transactions "
                         "do no device work")
    args = ap.parse_args(argv)
    with _device.use_device(_device.resolve(args.device)):
        rows, failures = run()
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    for msg in failures:
        print(f"GATE FAILED: {msg}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

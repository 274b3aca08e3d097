"""The paper's §V test cases on the port's Modified UDP.

The counterpart of the reference's ``tests/test_mudp_paper_cases.py``:
client 10.1.2.4 (a second client 10.1.2.6) and server 10.1.2.5 on 5 Mbps
links with a 2000 ms delay (the paper's NS3 configuration), four data
packets a transaction as in the paper's Figs 5-7.  Each case runs
:class:`MudpSender` and :class:`MudpReceiver` over the per-packet
simulator with tracing on:

* ``tc1_drop_pkt2``: packet (2, 4) lost once: one NACK, one resend;
* ``tc2_drop_tail``: packets 2-4 lost: the client's timer resends the
  last packet, then the NACKed two, within three retries;
* ``tc3_lossless``: ACKed at once, no timer;
* ``two_clients``: test case 1 on client one beside a clean client two;
* ``dead_link``: every data packet lost: the sender gives up after three
  retries;
* ``ack_loss``: the first ACK lost: the timer resends and the receiver
  ACKs the completed transaction again.

:func:`run_case` returns what a case leaves (the trace lines, the
simulator's counters, each sender's stats, the NACKs sent, the outcome);
:func:`check` holds the paper's assertions on it; :data:`PINS` holds the
SHA-256 of each record and a few readable fields of the reference's
live run (``tests/test_torch_paper_cases.py`` recomputes them).  The
cases are host Python: no device work, no kernel.  :func:`run` holds
every case; ``tests/test_torch_paper_cases.py`` and ``chip_smoke.py``
call it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import types

from repro_torch.core import channel, mudp, packetizer, packets, simulator

CLIENT = "10.1.2.4"
SERVER = "10.1.2.5"
CLIENT2 = "10.1.2.6"
PAPER_RATE = 5_000_000.0
PAPER_DELAY = 2_000_000_000           # 2000 ms
TIMEOUT_NS = 6_000_000_000

#: the modules a case is built from; a test passes the reference's
PORT = types.SimpleNamespace(
    Simulator=simulator.Simulator, Link=channel.Link,
    DropList=channel.DropList, NoLoss=channel.NoLoss,
    MudpSender=mudp.MudpSender, MudpReceiver=mudp.MudpReceiver,
    packetize=packetizer.packetize, reassemble=packetizer.reassemble,
    PacketKind=packets.PacketKind)

DROPS = {
    "tc1_drop_pkt2": {(2, 0)},
    "tc2_drop_tail": {(2, 0), (3, 0), (4, 0)},
    "tc3_lossless": set(),
    "dead_link": {(s, a) for s in range(1, 5) for a in range(16)},
}
CASES = (*DROPS, "two_clients", "ack_loss")


def four_packets(m, addr: str = CLIENT, payload_bytes: int = 1200):
    data = bytes(range(256)) * (payload_bytes * 4 // 256)
    pkts = m.packetize(data, addr, txn=0, mtu=payload_bytes + 28)
    if len(pkts) != 4:
        raise AssertionError("the paper's scenario uses exactly 4 packets")
    return data, pkts


def _drop_first_ack(m):
    class DropFirstAck:
        dropped = False

        def drops(self, pkt):
            if pkt.kind == m.PacketKind.ACK_OK and not self.dropped:
                self.dropped = True
                return True
            return False
    return DropFirstAck()


def run_case(name: str, m=PORT) -> dict:
    """Run one case on the modules ``m``; returns its record."""
    sim = m.Simulator(trace=True)
    senders: dict[str, dict] = {}
    delivered: dict[str, dict] = {}
    clients = [CLIENT, CLIENT2] if name == "two_clients" else [CLIENT]
    for addr in clients:
        if name in DROPS:
            up = m.Link(PAPER_RATE, PAPER_DELAY, m.DropList(DROPS[name]))
        elif name == "two_clients" and addr == CLIENT:
            up = m.Link(PAPER_RATE, PAPER_DELAY, m.DropList({(2, 0)}))
        else:
            up = m.Link(PAPER_RATE, PAPER_DELAY, m.NoLoss())
        down = (m.Link(PAPER_RATE, PAPER_DELAY, _drop_first_ack(m))
                if name == "ack_loss"
                else m.Link(PAPER_RATE, PAPER_DELAY, m.NoLoss()))
        sim.connect(addr, SERVER, up, down)
    rx = m.MudpReceiver(
        sim, sim.node(SERVER), nack_timeout_ns=TIMEOUT_NS,
        on_deliver=lambda a, t, p: delivered.setdefault(a, {}).update(p))
    txs, data = {}, {}
    for addr in clients:
        data[addr], pkts = four_packets(m, addr)
        outcome = senders.setdefault(addr, {})
        txs[addr] = m.MudpSender(
            sim, sim.node(addr), sim.node(SERVER), pkts,
            timeout_ns=TIMEOUT_NS,
            on_complete=lambda s, o=outcome: o.update(ok=True),
            on_fail=lambda s, o=outcome: o.update(ok=False))
    for addr in clients:
        txs[addr].start()
    sim.run()
    for addr, tx in txs.items():
        got = delivered.get(addr, {})
        senders[addr].update(
            stats=dataclasses.asdict(tx.stats),
            duration_ns=tx.stats.duration_ns,
            delivered=sorted(got),
            intact=bool(got) and m.reassemble(got) == data[addr])
    return {"case": name, "trace_lines": list(sim.trace_lines),
            "sim_stats": dict(sorted(sim.stats.items())),
            "now_ns": sim.now_ns, "nacks_sent": rx.stats_nacks_sent,
            "senders": dict(sorted(senders.items()))}


def digest(rec: dict) -> str:
    return hashlib.sha256(json.dumps(rec, sort_keys=True).encode()
                          ).hexdigest()


def summary(rec: dict) -> dict:
    """The readable fields of a pin: client one's outcome, duration,
    retransmissions and timer resends, and the NACKs sent."""
    s = rec["senders"][CLIENT]
    return {"ok": s.get("ok"), "duration_ns": s["duration_ns"],
            "retransmissions": s["stats"]["retransmissions"],
            "last_packet_retries": s["stats"]["last_packet_retries"],
            "nacks_sent": rec["nacks_sent"],
            "trace_lines": len(rec["trace_lines"])}


#: The reference's records (``tests/test_mudp_paper_cases.py``'s cases run
#: by :func:`run_case` on ``repro``), recomputed by the tier-1 test.
PINS: dict[str, dict] = {
    "tc1_drop_pkt2": {
        "sha256": "b28b16d66866498d9976642fe76f1c6f"
                  "9b261ce9e888d5b5fd2769170a663898",
        "summary": {"ok": True, "duration_ns": 8_009_707_200,
                    "retransmissions": 1, "last_packet_retries": 0,
                    "nacks_sent": 1, "trace_lines": 13}},
    "tc2_drop_tail": {
        "sha256": "a922f481e017e07ea9be5a335c9b35f0"
                  "527575397110d2697b6af79a6a754bb4",
        "summary": {"ok": True, "duration_ns": 14_005_748_800,
                    "retransmissions": 3, "last_packet_retries": 1,
                    "nacks_sent": 2, "trace_lines": 19}},
    "tc3_lossless": {
        "sha256": "13697095ce8a70fd98abc0bc7bde1d26"
                  "31a9bdaa3cf3c6569eabc51f2b6c1f1a",
        "summary": {"ok": True, "duration_ns": 4_007_668_800,
                    "retransmissions": 0, "last_packet_retries": 0,
                    "nacks_sent": 0, "trace_lines": 9}},
    "dead_link": {
        "sha256": "99ed2ff50029c0610ca63eb29f69ef2c"
                  "a04c24e9befc04e5140e3632f0655d8b",
        "summary": {"ok": False, "duration_ns": 24_000_000_000,
                    "retransmissions": 3, "last_packet_retries": 3,
                    "nacks_sent": 0, "trace_lines": 10}},
    "two_clients": {
        "sha256": "529ad72d1c04dc8d9f4a9d07386f71676"
                  "ab1874f80df302b7223003536431e41",
        "summary": {"ok": True, "duration_ns": 8_009_707_200,
                    "retransmissions": 1, "last_packet_retries": 0,
                    "nacks_sent": 1, "trace_lines": 22}},
    "ack_loss": {
        "sha256": "7085e9672ecaa376acb65110421a7e2d"
                  "594eff8225b787b36a3a91f6a0311431",
        "summary": {"ok": True, "duration_ns": 10_001_731_200,
                    "retransmissions": 1, "last_packet_retries": 1,
                    "nacks_sent": 0, "trace_lines": 12}},
}


def check(rec: dict) -> list[str]:
    """The paper's assertions on one case's record (the reference test's);
    returns the ones that fail."""
    name, text = rec["case"], "\n".join(rec["trace_lines"])
    one = rec["senders"][CLIENT]
    st = one["stats"]
    want: list[tuple[bool, str]] = []
    if name != "dead_link":
        want += [(one.get("ok") is True, "the transaction completes"),
                 (one["intact"], "the delivered bytes reassemble")]
    if name == "tc1_drop_pkt2":
        want += [(one["delivered"] == [1, 2, 3, 4], "packets 1-4 arrive"),
                 (rec["nacks_sent"] == 1, "exactly one NACK"),
                 (st["retransmissions"] == 1, "exactly one resend"),
                 (st["last_packet_retries"] == 0, "no timer resend"),
                 ("(2, 4, 10.1.2.4)" in text, "the missing packet traced"),
                 (f"(0, 0, {SERVER})" in text, "the success ACK traced")]
    elif name == "tc2_drop_tail":
        want += [(one["delivered"] == [1, 2, 3, 4], "packets 1-4 arrive"),
                 (st["last_packet_retries"] == 1, "one timer expiry"),
                 (rec["nacks_sent"] == 2, "NACKs for packets 2 and 3"),
                 (st["retransmissions"] == 3, "three resends"),
                 (10_000_000_000 <= one["duration_ns"] <= 25_000_000_000,
                  "the duration in the paper's 10-25 s window")]
    elif name == "tc3_lossless":
        want += [(st["retransmissions"] == 0, "no resend"),
                 (st["last_packet_retries"] == 0, "no timer resend"),
                 (rec["nacks_sent"] == 0, "no NACK"),
                 (2 * PAPER_DELAY <= one["duration_ns"] < 10 * PAPER_DELAY,
                  "the duration dominated by the link delay")]
    elif name == "two_clients":
        two = rec["senders"][CLIENT2]
        want += [(two.get("ok") is True and two["intact"],
                  "client two completes untouched")]
    elif name == "dead_link":
        want += [(one.get("ok") is False, "the transaction fails"),
                 (st["last_packet_retries"] == 3, "after three retries"),
                 (one["delivered"] == [], "nothing delivered")]
    return [f"{name}: {what}" for ok, what in want if not ok]


def run() -> tuple[dict, list[str]]:
    """Every case: ``(records by case, failures)``, a failure for each
    paper assertion that does not hold and each record off its pin."""
    records, failures = {}, []
    for name in CASES:
        rec = run_case(name)
        records[name] = rec
        failures += check(rec)
        pin = PINS[name]
        if digest(rec) != pin["sha256"] or summary(rec) != pin["summary"]:
            failures.append(f"{name}: {digest(rec)} {summary(rec)} != "
                            f"pinned {pin}")
    return records, failures

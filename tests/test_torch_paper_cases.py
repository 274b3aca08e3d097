"""The paper's §V test cases (``tests/test_mudp_paper_cases.py``) on the
port's Modified UDP, against the reference.

:mod:`repro_torch.paper_cases` builds each case from a namespace of
modules; here it runs once on the port's and once on the reference's, in
one process.  The two records must be equal: every trace line string for
string, the simulator's counters and final clock, each sender's
``TxnStats`` and the receiver's NACK count.  On the port's record the
paper's assertions hold (the single NACK and resend of case 1, the timer
resend of case 2 within three retries, the clean case 3 and two
concurrent clients, the dead link that gives up after three retries, the
surviving ACK loss, both duration windows).  The pins ``chip_smoke.py``
holds on the card are recomputed from the reference's records.
"""

from __future__ import annotations

import types

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import channel, mudp, packetizer, packets, simulator  # noqa: E402
from repro_torch import paper_cases  # noqa: E402

REF = types.SimpleNamespace(
    Simulator=simulator.Simulator, Link=channel.Link,
    DropList=channel.DropList, NoLoss=channel.NoLoss,
    MudpSender=mudp.MudpSender, MudpReceiver=mudp.MudpReceiver,
    packetize=packetizer.packetize, reassemble=packetizer.reassemble,
    PacketKind=packets.PacketKind)


@pytest.fixture(scope="module")
def records() -> dict[str, tuple[dict, dict]]:
    """``{case: (port record, reference record)}``."""
    return {case: (paper_cases.run_case(case),
                   paper_cases.run_case(case, REF))
            for case in paper_cases.CASES}


@pytest.mark.parametrize("case", paper_cases.CASES)
def test_case_equals_the_reference(records, case):
    port, ref = records[case]
    assert port["trace_lines"] == ref["trace_lines"]
    assert port["sim_stats"] == ref["sim_stats"]
    assert port["now_ns"] == ref["now_ns"]
    assert port["senders"] == ref["senders"]
    assert port["nacks_sent"] == ref["nacks_sent"]
    assert port == ref


@pytest.mark.parametrize("case", paper_cases.CASES)
def test_paper_assertions_hold_on_the_port(records, case):
    port, ref = records[case]
    assert paper_cases.check(port) == []
    assert paper_cases.check(ref) == []


@pytest.mark.parametrize("case", paper_cases.CASES)
def test_pin_is_the_reference_record(records, case):
    _, ref = records[case]
    assert paper_cases.PINS[case] == {"sha256": paper_cases.digest(ref),
                                      "summary": paper_cases.summary(ref)}


def test_triple_loss_takes_the_reference_time(records):
    """14.01 s in both packages (the paper logs about 17.5 s)."""
    port, ref = records["tc2_drop_tail"]
    assert (port["senders"][paper_cases.CLIENT]["duration_ns"]
            == ref["senders"][paper_cases.CLIENT]["duration_ns"]
            == 14_005_748_800)


@pytest.mark.parametrize("case,field,value", [
    ("tc1_drop_pkt2", "nacks_sent", 2),
    ("tc2_drop_tail", "last_packet_retries", 2),
    ("dead_link", "ok", True),
])
def test_check_reports_a_broken_case(records, case, field, value):
    rec, _ = records[case]
    broken = {**rec, "senders": {a: {**s, "stats": dict(s["stats"])}
                                 for a, s in rec["senders"].items()}}
    one = broken["senders"][paper_cases.CLIENT]
    if field == "nacks_sent":
        broken["nacks_sent"] = value
    elif field == "ok":
        one["ok"] = value
    else:
        one["stats"][field] = value
    assert paper_cases.check(broken)


def test_run_holds_every_case_and_its_pin():
    records, failures = paper_cases.run()
    assert failures == []
    assert sorted(records) == sorted(paper_cases.CASES)
    assert any("packet 2 is missing! requesting resend" in line
               for line in records["tc1_drop_pkt2"]["trace_lines"])


def test_run_fails_off_its_pin(monkeypatch):
    pins = dict(paper_cases.PINS)
    pins["tc3_lossless"] = {**pins["tc3_lossless"], "sha256": "0" * 64}
    monkeypatch.setattr(paper_cases, "PINS", pins)
    _, failures = paper_cases.run()
    assert len(failures) == 1 and failures[0].startswith("tc3_lossless")

"""Transport ablation on the port: every registered transport across loss
rates, as a table.

The counterpart of the reference's ``examples/transport_ablation.py``:
for each loss rate in 0, 0.05 and 0.2 and each transport, one FL round of
:func:`repro_torch.transport_comparison.run`'s configuration (the same
40,000-parameter model, clients, links and config), reporting the round's
simulated time, arrivals, retransmissions, wire MB and the global
model's L2 error against the lossless ``mudp`` result.  The server's
FedAvg runs the fedavg kernel at (2, 40000).  Every line of the table
equals the reference's (:data:`PINS`).

    PYTHONPATH=src python -m repro_torch.transport_ablation --device cpu
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch import device as _device
from repro_torch.core.packetizer import flatten_to_vector
from repro_torch.core.transport import available_transports
from repro_torch.transport_comparison import run

LOSS_RATES = (0.0, 0.05, 0.2)
HEADER = (f"{'transport':>9s} {'loss':>5s} {'t_round(s)':>10s} "
          f"{'arrived':>7s} {'retx':>5s} {'wireMB':>7s} {'L2err':>9s}")


def table(device: _device.DeviceLike | None = None) -> list[str]:
    """The table's lines, header first."""
    clean, _ = run("mudp", 0.0, device=device)
    target = flatten_to_vector(clean.global_params)
    lines = [HEADER]
    for p in LOSS_RATES:
        for tr in available_transports():
            system, (res,) = run(tr, p, device=device)
            vec = flatten_to_vector(system.global_params)
            err = float(np.linalg.norm(vec - target))
            lines.append(f"{tr:>9s} {p:5.2f} {res.duration_ns/1e9:10.3f} "
                         f"{len(res.arrived)}/2{'':>3s} "
                         f"{res.retransmissions:5d} "
                         f"{res.bytes_sent/1e6:7.2f} {err:9.4f}")
    return lines


#: The reference's table.
PINS = [
    HEADER,
    "     mudp  0.00      0.024 2/2        0    0.33    0.0000",
    " mudp+fec  0.00      0.024 2/2        0    0.37    0.0000",
    "      tcp  0.00      0.092 2/2        0    0.34    0.0000",
    "      udp  0.00      0.019 2/2        0    0.33    0.0000",
    "     mudp  0.05      0.035 2/2        9    0.34    0.0000",
    " mudp+fec  0.05      2.021 2/2        6    0.38    0.0000",
    "      tcp  0.05      2.251 2/2       20    0.37    0.0000",
    "      udp  0.05      0.019 2/2        0    0.33   43.9545",
    "     mudp  0.20      4.034 2/2       54    0.41    0.0000",
    " mudp+fec  0.20      4.021 2/2       46    0.44    0.0000",
    "      tcp  0.20     62.574 2/2       55    0.42    0.0000",
    "      udp  0.20      0.019 2/2        0    0.33  117.4734",
]


def run_table(device: _device.DeviceLike | None = None
              ) -> tuple[list[str], list[str]]:
    """``(lines, failures)``: each line held against :data:`PINS`."""
    lines = table(device)
    failures = [f"line {i}: {got!r} != pinned {want!r}"
                for i, (got, want) in enumerate(zip(lines, PINS))
                if got != want]
    if len(lines) != len(PINS):
        failures.append(f"{len(lines)} lines, {len(PINS)} pinned")
    return lines, failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    lines, failures = run_table(_device.resolve(args.device))
    print("\n".join(lines))
    print("\nUDP corrupts the global model as loss rises (zero-filled gaps);"
          "\nTCP recovers but pays handshake+windowing latency; MUDP "
          "recovers at\nnear-UDP latency, and mudp+fec trades ~1/B bandwidth "
          "for fewer\nretransmissions still.")
    for msg in failures:
        print(f"GATE FAILED: {msg}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

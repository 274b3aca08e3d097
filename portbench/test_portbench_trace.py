"""The traced run's reduction and the per-layer readers, on a synthetic
profile: device operations, host events and captured calls whose
figures are worked out by hand."""

import json
import re
from pathlib import Path

import pytest
import torch
from torch.autograd import DeviceType

from portbench import harness, trace, work

HERE = Path(__file__).resolve().parent
MS = 1_000_000  # ns


class FakeStep:
    """A step whose round moves 3.35 GB at least (1 ms at the peak)."""

    def round_work(self):
        return int(3.35e9), 0, work.PEAK_F32_FLOPS


class Event:
    def __init__(self, name, on_device, start, dur, kind):
        self._v = (name, on_device, start, dur, kind)

    def name(self):
        return self._v[0]

    def device_type(self):
        return DeviceType.CUDA if self._v[1] else DeviceType.CPU

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def activity_type(self):
        return self._v[4]


class FakeProfile:
    """What ``reduce`` reads of a ``torch.profiler.profile``."""

    def __init__(self, events):
        class Results:
            def events(self_):
                return events

        class Profiler:
            kineto_results = Results()
        self.profiler = Profiler()


def two_rounds():
    """Two 5 ms rounds; in each, on the device, a fedavg kernel of 1 ms, a
    quantize kernel of 1 ms, a dequantize kernel of 0.5 ms and a 2 ms
    copy that overlaps the fedavg kernel by 0.5 ms; the host in a
    synchronize at each round's end."""
    ev = []
    for r in range(2):
        t = r * 5 * MS
        ev += [
            Event(trace.ROUND, False, t, 5 * MS, "user_annotation"),
            Event(trace.ROUND, True, t, 5 * MS, "gpu_user_annotation"),
            Event("aten::copy_", False, t, MS // 10, "cpu_op"),
            Event("void (anonymous namespace)::fedavg_wide_kernel(float "
                  "const*, float const*, float*, int, long)", True,
                  t + MS // 2, MS, "kernel"),
            Event("void at::native::direct_copy_kernel_cuda(int)", True,
                  t + MS, 2 * MS, "kernel"),
            Event("void (anonymous namespace)::quantize_lanes_kernel<2, 2>"
                  "(float const*)", True, t + 3 * MS, MS, "kernel"),
            Event("void (anonymous namespace)::dequantize_kernel(signed "
                  "char const*)", True, t + 4 * MS, MS // 2, "kernel"),
            Event("cudaDeviceSynchronize", False, t + 4 * MS, MS,
                  "cuda_runtime"),
        ]
    return ev


def fedavg_call(k, n):
    return ([work.Operand((k, n), 4), work.Operand((k,), 4)],
            [work.Operand((n,), 4)])


@pytest.fixture
def t():
    # the calls of one round
    calls = {"repro_torch.kernels.fedavg.ops:fedavg":
             [fedavg_call(4, 100_000)]}
    return trace.reduce(FakeProfile(two_rounds()), calls, FakeStep())


def test_reduce_window_busy_and_ops(t):
    assert t.rounds == 2
    assert t.window_s == pytest.approx(0.010)
    # each round busy from 0.5 to 4.5 ms
    assert t.busy_s == pytest.approx(0.008)
    assert len(t.device_ops) == 8  # the gpu annotations are no operations
    assert t.gaps()[:2] == [(0, MS // 2), (4 * MS + MS // 2, 5 * MS + MS // 2)]


def test_window_ends_with_the_work_sent_ahead():
    """Rounds sent ahead: the host's two rounds take 1 ms each, and the
    device runs each round's 3 ms kernel after the one before; the window
    ends with the second kernel, at 7 ms, and nothing in it is idle but
    the first millisecond."""
    ev = []
    for r in range(2):
        ev += [Event(trace.ROUND, False, r * MS, MS, "user_annotation"),
               Event("fedavg_pods_kernel", True, MS + 3 * r * MS, 3 * MS,
                     "kernel")]
    t = trace.reduce(FakeProfile(ev), {}, FakeStep())
    assert (t.start_ns, t.end_ns, t.rounds) == (0, 7 * MS, 2)
    assert t.window_s == pytest.approx(0.007)
    assert t.busy_s == pytest.approx(0.006)
    assert t.gaps() == [(0, MS)]


def test_readers(t, bench):
    got = {}
    for m in bench["per_layer"]:
        reader = harness.load_module(HERE, "metrics", m["name"])
        got[m["name"]] = reader.read(t)
    assert got["step_mfu"] == pytest.approx(100 * 1e-3 / 5e-3)
    assert got["idle_share"] == pytest.approx(20.0)
    assert got["launches_per_round"] == 4.0
    assert got["agg_copy_ms"] == pytest.approx(2.0)
    # a round's call: (4 + 1) x 100,000 f32 read and 100,000 written, plus
    # 16 B of weights, over the 1 ms its kernel takes a round
    fedavg_s = (5 * 400_000 + 16) / work.PEAK_BYTES_PER_S
    assert got["fedavg_roofline"] == pytest.approx(100 * fedavg_s / 1e-3)
    # kernels on the device but no captured call: nothing to read
    assert got["quantize_roofline"] is None
    assert got["dequantize_roofline"] is None


def test_readers_find_nothing_in_an_empty_window():
    t = trace.Trace(1, 0, MS, [], [], {}, FakeStep())
    for name in ("agg_copy_ms", "launches_per_round", "idle_share",
                 "fedavg_roofline"):
        assert harness.load_module(HERE, "metrics", name).read(t) is None


def test_breakdown(t):
    b = t.breakdown()
    assert set(b) == {"device_ops", "idle_gaps"}
    assert len(b["device_ops"]) <= trace.TOP and len(b["idle_gaps"]) <= 10
    names = [n for n, _ in b["device_ops"]]
    assert names[0] == "at::native::direct_copy_kernel_cuda"
    assert "fedavg_wide_kernel" in names
    assert sum(s for _, s in b["device_ops"]) == pytest.approx(0.009)
    gaps = dict(b["idle_gaps"])
    # the first gap opens while the host copies; the others while it
    # waits at a round's end
    assert gaps["aten::copy_"] == pytest.approx(0.0005)
    assert gaps["cudaDeviceSynchronize"] == pytest.approx(0.0015)
    json.dumps(b)


def test_capture_records_operands_and_restores():
    from repro_torch.kernels.fedavg import ops
    fn = ops.fedavg
    with trace.Capture(["repro_torch.kernels.fedavg.ops:fedavg"]) as cap:
        assert ops.fedavg is not fn
        with torch.profiler.profile() as prof:
            ops.fedavg(torch.ones(3, 8), torch.full((3,), 1 / 3))
    # it records the operands and adds no annotation of its own
    assert not any(e.name.startswith(trace.PREFIX)
                   for e in prof.events())
    assert ops.fedavg is fn
    args, results = cap.calls["repro_torch.kernels.fedavg.ops:fedavg"][0]
    assert args == [work.Operand((3, 8), 4), work.Operand((3,), 4)]
    assert results == [work.Operand((8,), 4)]


def test_kernel_names():
    k = work.KERNELS
    assert k["fedavg"].search("(anonymous namespace)::fedavg_tma_kernel<8>")
    assert k["quantize"].search("quantize_wide_kernel(float const*)")
    assert k["quantize"].search("quantize_lanes_kernel<256, 6>(float*)")
    assert not k["quantize"].search("dequantize_kernel(signed char*)")
    assert k["dequantize"].search("dequantize_kernel(signed char*)")
    assert not any(p.search("direct_copy_kernel_cuda") for p in k.values())
    assert re.fullmatch(r"[\w:<>, ]+", trace.short_name(
        "void (anonymous namespace)::quantize_lanes_kernel<2, 2>(float)"))

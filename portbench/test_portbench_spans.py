"""The program spans' reduction and the pod aggregation's readers, on a
synthetic profile whose figures are worked out by hand."""

import pytest

from portbench import harness, spans, trace
from portbench.test_portbench_trace import (HERE, Event, FakeProfile,
                                            FakeStep, two_rounds)

US = 1_000  # ns
ROUND_US = 4_000
READERS = ("cast_ms", "agg_host_ms", "agg_idle_ms")
#: spans the port no longer opens, which no metric reads: read here by
#: the pairing itself, under the names their readers had
SPANS = {"broadcast_ms": "fl_mesh.broadcast",
         "cast_back_ms": "fl_mesh.cast_back"}
COPY = "void at::native::unrolled_elementwise_kernel<direct_copy>(int)"


def span(name, start, end):
    return Event(spans.PREFIX + name, False, start * US, (end - start) * US,
                 "cpu_op")


def launch(start, name="cudaLaunchKernel"):
    return Event(name, False, start * US, 10 * US, "cuda_runtime")


def op(name, start, end):
    return Event(name, True, start * US, (end - start) * US, "kernel")


def one_round(t):
    """A 4 ms round at ``t`` us of one int8 leaf.  On the host, inside
    ``aggregate`` (100-3100 us): each phase's launches, and a memset
    launched between the cast back and the broadcast; then the harness's
    synchronize.  On the device, in launch order: the cast 1 ms, the
    codec's two kernels, the fold's fill and fedavg, the cast back 0.1
    ms, the memset, and the broadcast in two pieces of 0.1 and 0.7 ms with
    an idle 60 us between them while the host is in the broadcast span;
    beside the cast, the cast span's projection onto the device (its kind
    empty, as torch 2.11 gives it), which no launch made."""
    host = [
        Event(trace.ROUND, False, t * US, ROUND_US * US, "user_annotation"),
        span("fl_mesh.aggregate", t + 100, t + 3100),
        span("fl_mesh.cast", t + 200, t + 600), launch(t + 300),
        span("fl_mesh.codec", t + 700, t + 1100), launch(t + 800),
        launch(t + 900),
        span("fl_mesh.fold", t + 1200, t + 1600), launch(t + 1300),
        launch(t + 1400),
        span("fl_mesh.cast_back", t + 1700, t + 2000), launch(t + 1800),
        launch(t + 2050, "cudaMemsetAsync"),
        span("fl_mesh.broadcast", t + 2100, t + 3000), launch(t + 2200),
        launch(t + 2500, "cuLaunchKernel"),
        Event("cudaDeviceSynchronize", False, (t + 3100) * US, 700 * US,
              "cuda_runtime"),
    ]
    device = [
        op(COPY, t + 320, t + 1320),
        op("void quantize_lanes_kernel<2, 2>(float const*)", t + 1320,
           t + 1720),
        op("void dequantize_kernel(signed char const*)", t + 1720, t + 1920),
        op("void at::native::vectorized_elementwise_kernel<4, "
           "at::native::FillFunctor<float> >(int)", t + 1920, t + 1930),
        op("void fedavg_wide_kernel(float const*)", t + 1930, t + 2330),
        op("void at::native::vectorized_elementwise_kernel<8, "
           "at::native::bfloat16_copy_kernel_cuda>(int)", t + 2330, t + 2430),
        op("Memset (Device)", t + 2430, t + 2440),
        op(COPY, t + 2440, t + 2540),
        op(COPY, t + 2600, t + 3300),
        Event(spans.PREFIX + "fl_mesh.cast", True, (t + 320) * US,
              1000 * US, ""),
    ]
    return host + device


def reduce(events):
    return trace.reduce(FakeProfile(events), {}, FakeStep())


@pytest.fixture
def t():
    return reduce(one_round(0) + one_round(ROUND_US))


def read_all(t):
    got = {name: harness.load_module(HERE, "metrics", name).read(t)
           for name in READERS}
    got.update({name: spans.span_device_ms(t, span)
                for name, span in SPANS.items()})
    return got


def test_readers(t):
    got = read_all(t)
    assert got["cast_ms"] == pytest.approx(1.0)
    assert got["broadcast_ms"] == pytest.approx(0.1 + 0.7)
    assert got["cast_back_ms"] == pytest.approx(0.1)
    # 3 ms inside ``aggregate`` less its nine 10 us launch calls
    assert got["agg_host_ms"] == pytest.approx(3.0 - 0.09)
    # only the 60 us inside the broadcast: the gap before each round's
    # first operation begins outside every span, the one after its last
    # in the harness's synchronize
    assert got["agg_idle_ms"] == pytest.approx(0.06)


def test_agg_host_ms_leaves_out_a_launch_that_waits():
    """A round sent ahead: its one launch call waits 2.5 ms for room in
    the launch queue, inside a 3 ms ``aggregate``, and the profiler
    records the wait inside it; the program's own host time is the other
    0.5 ms."""
    t = reduce([
        Event(trace.ROUND, False, 0, ROUND_US * US, "user_annotation"),
        span("fl_mesh.aggregate", 100, 3100),
        span("fl_mesh.fold", 200, 2900),
        Event("cudaLaunchKernel", False, 300 * US, 2500 * US,
              "cuda_runtime"),
        Event("Command Buffer Full", False, 400 * US, 2300 * US,
              "overhead"),
        op("void fedavg_pods_kernel(float const*)", 2800, 3800)])
    assert harness.load_module(HERE, "metrics", "agg_host_ms").read(t) == \
        pytest.approx(0.5)


def test_pairing(t):
    pairs = spans.launched(t)
    assert len(pairs) == 2 * 9
    owners = [owner for _, owner in pairs[:9]]
    assert owners == [spans.PREFIX + "fl_mesh." + s for s in (
        "cast", "codec", "codec", "fold", "fold", "cast_back", "aggregate",
        "broadcast", "broadcast")]
    assert all(not o.name.startswith(spans.PREFIX) for o, _ in pairs)


def test_pairing_goes_by_order_not_by_the_clocks():
    """The second round's device timestamps read 1.5 ms early, as the
    profiler's drift against the host clock can by the end of a window:
    each operation still takes its own launch's span."""
    early = []
    for e in one_round(ROUND_US):
        name, on_device, start, dur, kind = e._v
        early.append(Event(name, on_device,
                           start - 1500 * US if on_device else start, dur,
                           kind))
    t = reduce(one_round(0) + early)
    got = read_all(t)
    assert got["cast_ms"] == pytest.approx(1.0)
    assert got["broadcast_ms"] == pytest.approx(0.8)
    assert got["cast_back_ms"] == pytest.approx(0.1)


def test_gaps_and_the_breakdown_name_the_spans(t):
    found = spans.gaps(t)
    inside = [(b - a, names) for a, b, names in found
              if spans.AGGREGATE in names]
    assert inside == [(60 * US, (spans.AGGREGATE,
                                 spans.PREFIX + "fl_mesh.broadcast"))] * 2
    idle = dict(t.breakdown()["idle_gaps"])
    assert idle[spans.PREFIX + "fl_mesh.broadcast"] == pytest.approx(120e-6)


def test_a_count_mismatch_gives_no_pairing():
    # the profiler lost one launch's record in the second round
    t = reduce(one_round(0) + [e for e in one_round(ROUND_US)
                               if e.name() != "cuLaunchKernel"])
    assert spans.launched(t) is None
    got = read_all(t)
    assert got["cast_ms"] is None and got["broadcast_ms"] is None
    assert got["cast_back_ms"] is None
    # the host's figures need no pairing (the second round has eight
    # launch calls)
    assert got["agg_host_ms"] == pytest.approx(3.0 - (0.09 + 0.08) / 2)
    assert got["agg_idle_ms"] == pytest.approx(0.06)


def test_nothing_to_read_without_program_spans():
    t = reduce(two_rounds())
    assert spans.launched(t) is None and spans.gaps(t) is None
    assert read_all(t) == dict.fromkeys((*READERS, *SPANS))


def test_launch_names():
    for name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                 "cudaMemcpyAsync", "cudaMemsetAsync", "cuMemsetD8Async"):
        assert spans.LAUNCH.match(name), name
    for name in ("cudaLaunchHostFunc", "cudaDeviceSynchronize",
                 "cudaEventRecordWithFlags", "aten::copy_",
                 "cudaStreamIsCapturing"):
        assert not spans.LAUNCH.match(name), name

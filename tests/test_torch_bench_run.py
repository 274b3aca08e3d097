"""The benchmark harness on the port (``repro_torch.bench_run``) against
the reference's ``benchmarks/run.py``, in one process.

* Every suite's rows against the reference's ``bench()``: the same row
  names in the same order (the port's renames: ``kernels/<name>_kernel``
  for ``_pallas``, ``aggregation/fedavg_kernel`` and ``fedavg_torch_ref``
  for ``fedavg_kernel_interpret`` and ``fedavg_jnp_ref``), and every
  deterministic derived field equal to the reference's string
  (``acc6rounds`` within ``fl_convergence.ACC_TOL``).  Both harnesses run
  in an empty working directory, so both roofline suites report missing
  inputs.
* Two reference suites are cheapened, neither in what it prints: its
  kernels suite runs each Pallas kernel's jnp oracle in the kernel's place
  (interpret mode adds seconds and no field the port is held to), and its
  aggregation suite is not run (interpret-mode fedavg at (8, 4,000,000)
  takes seconds a call on a CPU): its Eq. 1 row is built from
  ``repro.core.aggregation`` on the same draws, and the port's suite runs
  at ``AGG_N`` columns.
* The kernels suite's inputs equal the reference's draws bit for bit (the
  port's flash attention layout transposed back), and the port's plain
  versions lie within ``ORACLE_TOL`` of the reference's oracles on them.
* The harness's contract: the header, one ``suite_wall`` row a suite,
  ``--only``, the ``SUITE_ERROR`` row and exit 1 when a suite raises (a
  kernel off its plain version included), and the refusal to run on
  ``cuda`` without a card.  ``bench_run.PINS`` is recomputed from the
  reference's live run.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import io
import itertools
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import aggregation as ref_aggregation  # noqa: E402
from repro_torch import (  # noqa: E402
    aggregation_bench, bench_run, fl_convergence, kernels_bench)
from repro_torch.device import use_device  # noqa: E402
from repro_torch.kernels import KernelError  # noqa: E402
from repro_torch.kernels.checksum import ref as checksum_ref  # noqa: E402
from repro_torch.kernels.fedavg import ops as fedavg_ops  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
#: the port's aggregation suite's fold width here (the reference's: 4 M)
AGG_N = 4096
#: the port's plain versions against the reference's jnp oracles, on the
#: kernels suite's inputs: float32 folds in two orders (fedavg) and two
#: frameworks' attention and mLSTM arithmetic (the bands of
#: tests/test_torch_flash_attention.py and tests/test_torch_mlstm.py)
ORACLE_TOL = {"fedavg": 1e-6, "flash_attention": 2e-5, "mlstm": 5e-4}


def _run_main(argv) -> tuple[int, str]:
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = bench_run.main(argv)
    return rc, out.getvalue()


def _reference_eq1_row() -> tuple[str, float, str]:
    """``benchmarks/aggregation.py``'s first row, from the reference's
    aggregation on the reference's draws."""
    rng = np.random.default_rng(0)
    clients = [{"w": rng.standard_normal(1000).astype(np.float32)}
               for _ in range(4)]
    g0 = {"w": np.zeros(1000, np.float32)}
    outs = []
    for perm in itertools.permutations(range(4)):
        g = g0
        for i in perm:
            g = ref_aggregation.pairwise_average(g, clients[i])
        outs.append(g["w"])
    spread = float(max(np.linalg.norm(a - b) for a in outs for b in outs))
    fa = ref_aggregation.fedavg(clients)["w"]
    worst = float(max(np.linalg.norm(o - fa) for o in outs))
    return ("aggregation/pairwise_order_dependence", 0.0,
            f"perm_spread_l2={spread:.3f};max_dev_from_fedavg={worst:.3f}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both harnesses' rows by suite, the reference's suite order, and the
    reference kernels suite's recorded calls: ``{name: (inputs, oracle
    output)}``."""
    cwd = tmp_path_factory.mktemp("bench_run")
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(REPO))
        mp.chdir(cwd)
        ref_run = importlib.import_module("benchmarks.run")
        kb = ref_run.SUITES["kernels"]
        calls = {}

        def oracle(name, fn):
            def stand_in(*args, interpret=True):
                out = fn(*args)
                calls[name] = (args, out)
                return out
            return stand_in
        for attr, name, fn in (
                ("fedavg_pallas", "fedavg", kb.fedavg_flat),
                ("quantize_pallas", "quantize", kb.quantize_blockwise),
                ("checksum_pallas", "checksum", kb.chunksum32_jnp),
                ("flash_attention_pallas", "flash_attention",
                 kb.attention_ref),
                ("mlstm_pallas", "mlstm", kb.mlstm_ref)):
            mp.setattr(kb, attr, oracle(name, fn))
        ref_rows = {}
        for suite, mod in ref_run.SUITES.items():
            if suite == "aggregation":
                ref_rows[suite] = [_reference_eq1_row()] + [
                    (f"aggregation/fedavg_{name}", 0.0,
                     "K=8;N=4000000")
                    for name in ("kernel_interpret", "jnp_ref")]
            else:
                ref_rows[suite] = list(mod.bench())
        mp.setitem(bench_run.SUITES, "aggregation",
                   functools.partial(aggregation_bench.bench, n=AGG_N))
        rc, text = _run_main(["--device", "cpu"])
    port_rows: dict[str, list] = {}
    for row in bench_run.parse(text):
        port_rows.setdefault(bench_run.suite_of(row[0]), []).append(row)
    return {"ref": ref_rows, "order": list(ref_run.SUITES), "rc": rc,
            "text": text, "port": port_rows, "calls": calls,
            "roofline_dir": str(cwd / "build" / "port_dryrun")}


def _renamed(rows) -> list[str]:
    return [bench_run.RENAMES.get(r, r) for r, _, _ in rows]


def test_suites_are_the_references_in_its_order(runs):
    assert list(bench_run.SUITES) == runs["order"]


@pytest.mark.parametrize("suite", list(bench_run.SUITES))
def test_suite_rows_match_the_reference(runs, suite):
    ref = runs["ref"][suite]
    port = [r for r in runs["port"][suite]
            if not r[0].endswith("/suite_wall")]
    assert [r for r, _, _ in port] == _renamed(ref)
    for (row, _, want), (_, _, got) in zip(ref, port):
        want_f = bench_run.fields(row, want)
        got_f = bench_run.fields(row, got)
        for key, value in want_f.items():
            if key == "acc6rounds":
                assert abs(float(got_f[key]) - float(value)) \
                    <= fl_convergence.ACC_TOL, row
            elif key in bench_run.DETERMINISTIC:
                assert got_f[key] == value, (row, key)
    if suite == "kernels":
        for (row, _, want), (_, _, got) in zip(ref, port):
            if row.endswith("_pallas"):
                # the reference's fields first, in its order, then route
                assert list(bench_run.fields(row, got)) == [
                    *bench_run.fields(row, want), "route"]
                assert got.endswith(";route=plain")
            else:
                assert got == want == "oracle"


def test_pins_are_the_references_live_run(runs):
    recomputed = {bench_run.RENAMES.get(row, row):
                  bench_run.pinned(row, derived)
                  for suite in runs["order"] if suite != "roofline"
                  for row, _, derived in runs["ref"][suite]}
    assert recomputed == bench_run.PINS
    # the reference's own rows, renamed, hold them
    renamed = [(bench_run.RENAMES.get(r, r), us, d)
               for rows in runs["ref"].values() for r, us, d in rows]
    assert bench_run.failures(renamed,
                              roofline_dir=runs["roofline_dir"]) == []


def test_harness_prints_the_references_csv_and_holds_its_pins(runs):
    lines = runs["text"].splitlines()
    assert runs["rc"] == 0
    assert lines[0] == "name,us_per_call,derived"
    walls = [line for line in lines if "/suite_wall," in line]
    assert [w.split("/")[0] for w in walls] == runs["order"]
    assert all(w.endswith(",complete") and float(w.split(",")[1]) > 0
               for w in walls)
    rows = bench_run.parse(runs["text"])
    assert len(rows) == len(lines) - 1
    assert all(f"{r},{us:.1f},{d}" in lines for r, us, d in rows
               if not r.endswith("/suite_wall"))
    assert bench_run.failures(rows, roofline_dir=runs["roofline_dir"]) == []


def test_kernels_suite_inputs_are_the_references_draws(runs):
    calls, mine = runs["calls"], kernels_bench.inputs()
    assert list(mine) == list(calls)
    for name, arrays in mine.items():
        theirs = [np.asarray(a) for a in calls[name][0]]
        assert len(arrays) == len(theirs), name
        for a, b in zip(arrays, theirs):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert np.array_equal(a, b), name
        # and the port's layout of them
        back = [t.numpy() for t in kernels_bench.port_args(
            name, arrays, torch.device("cpu"))]
        if name == "flash_attention":
            back = [np.swapaxes(t, 1, 2) for t in back]
        if name == "checksum":
            assert back[0].dtype == np.uint8
            back = [back[0].astype(np.int32)]
        for a, b in zip(back, theirs):
            assert np.array_equal(a, b), name


def test_kernels_suite_plain_versions_against_the_references_oracles(runs):
    cpu = torch.device("cpu")
    for name, arrays in kernels_bench.inputs().items():
        _, plain, _ = kernels_bench.PAIRS[name]
        got = plain(*kernels_bench.port_args(name, arrays, cpu))
        want = runs["calls"][name][1]
        if name == "quantize":
            q, s = (t.numpy() for t in got)
            assert np.array_equal(q, np.asarray(want[0]))
            assert np.array_equal(s[:, 0], np.asarray(want[1]))
        elif name == "checksum":
            assert checksum_ref.combine(got) == int(want)
        else:
            out = got.numpy()
            if name == "flash_attention":
                out = np.swapaxes(out, 1, 2)
            tol = ORACLE_TOL[name]
            np.testing.assert_allclose(out, np.asarray(want), rtol=tol,
                                       atol=tol)


def test_only_runs_one_suite():
    rc, text = _run_main(["--device", "cpu", "--only",
                          "transport_scenarios"])
    assert rc == 0
    rows = bench_run.parse(text)
    assert text.splitlines()[0] == "name,us_per_call,derived"
    assert rows[-1][0] == "transport_scenarios/suite_wall"
    assert {bench_run.suite_of(r) for r, _, _ in rows} == {
        "transport_scenarios"}
    assert bench_run.failures(rows, suites=["transport_scenarios"]) == []
    assert bench_run.failures(rows)          # the other suites are missing


def test_a_raising_suite_is_an_error_row_and_exit_1(monkeypatch):
    def boom():
        raise RuntimeError("boom, on purpose")
    monkeypatch.setattr(bench_run, "SUITES", {
        "codecs": boom,
        "transport_scenarios": bench_run.SUITES["transport_scenarios"]})
    rc, text = _run_main(["--device", "cpu"])
    assert rc == 1
    lines = text.splitlines()
    i = lines.index("codecs/SUITE_ERROR,0.0,RuntimeError:boom, on purpose")
    assert lines[i + 1].startswith("codecs/suite_wall,")
    assert lines[-1].startswith("transport_scenarios/suite_wall,")
    fails = bench_run.failures(bench_run.parse(text),
                               suites=["codecs", "transport_scenarios"])
    assert fails[0].startswith("codecs/SUITE_ERROR")
    assert any(f.startswith("codecs: rows") for f in fails)


def test_a_kernel_off_its_plain_version_is_a_suite_error(monkeypatch):
    wrapper, plain, reps = kernels_bench.PAIRS["fedavg"]
    monkeypatch.setitem(kernels_bench.PAIRS, "fedavg",
                        (lambda s, w: wrapper(s, w) + 1e-6, plain, reps))
    rc, text = _run_main(["--device", "cpu", "--only", "kernels"])
    assert rc == 1
    assert "kernels/SUITE_ERROR,0.0,KernelError:fedavg: the plain route " \
           "disagrees" in text


def test_an_aggregation_fold_off_the_plain_version_raises(monkeypatch):
    fold = fedavg_ops.fedavg
    monkeypatch.setattr(fedavg_ops, "fedavg",
                        lambda s, w: fold(s, w).nextafter(
                            torch.tensor(np.inf)))
    with use_device("cpu"), pytest.raises(KernelError,
                                          match=r"fedavg at \(8, 64\)"):
        aggregation_bench.bench(n=64)


def test_failures_catch_fields_off_their_pins(runs):
    rows = [row for rows in runs["port"].values() for row in rows]
    failures = functools.partial(bench_run.failures,
                                 roofline_dir=runs["roofline_dir"])
    assert failures(rows) == []

    def edit(name, old, new):
        return [(r, us, d.replace(old, new) if r == name else d)
                for r, us, d in rows]
    acc = "fl_convergence/lossy10_udp"
    for bad, msg in (
            (edit("topology/hier_c16", "server_nodes=5", "server_nodes=4"),
             "topology/hier_c16: server_nodes=4 != pinned 5"),
            (edit(acc, "acc6rounds=0.764", "acc6rounds=0.780"),
             f"{acc}: acc6rounds=0.780 not within"),
            (edit("wire_batch/int8(1024)@256", "bytes_identical=True",
                  "bytes_identical=False"),
             "wire_batch/int8(1024)@256: bytes_identical=False != pinned "
             "True"),
            ([r for r in rows if r[0] != "wire/determinism"],
             "wire: rows")):
        fails = failures(bad)
        assert len(fails) == 1 and fails[0].startswith(msg), fails
    # within ACC_TOL is held, not failed
    assert failures(edit(acc, "acc6rounds=0.764", "acc6rounds=0.770")) == []


def test_refuses_to_run_on_cuda_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal needs none")
    for argv in ([], ["--device", "cuda"], ["--only", "codecs"]):
        with pytest.raises(RuntimeError, match="cuda.is_available"):
            bench_run.main(argv)
    assert capsys.readouterr().out == ""

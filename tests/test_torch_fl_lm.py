"""Federated LM training over MUDP and the crash-restart story, on the
port against the reference's examples.

``fl_train_lm --scale tiny --rounds 2 --clients 2 --local-steps 2`` runs
in both packages from the same weights (the reference's, carried across
with ``convert.tree_from_reference``).  The round records (simulated
round time, arrivals, retransmissions, wire bytes) must be identical: the
legacy ``int8`` codec's payload sizes, the loss draws and the MUDP
recovery do not depend on the weights' values.

The weights themselves are held after ONE local AdamW step a client (one
round): the relative L2 distance between the port's and the reference's
moves of the global model, (final - initial), must stay within
``PARAM_TOL``.  Measured on this configuration (CPU): 0.035.  The
random-init xLSTM is chaotic, so no longer run can be held by value: its
float32 gradients move by 1% under a nudge of 2^-24 relative on the
weights (the two packages' gradients differ by as much, and each is that
far from a float64 evaluation), and AdamW's first steps, ``lr * g / (|g|
+ eps)``, turn that into 3-12% of a step, 44% by the second step and 92%
by the eighth (the reference against itself).  From the first round on,
the clients train from the global model as the int8 downlink delivers
it, so any such difference also flips int8 codes: the port's 2-round,
2-step run lies 1.03 from the reference's.  Controls on the one-round
run: a port whose local steps leave the weights unchanged reads 1.0 (the
test runs it); FedAvg of the first client alone 0.71, a sum in place of
the mean 1.0, dequantize scales 1.2x too large 1.45.

The eval NLL after each round of the 2-round run must agree within
``NLL_TOL`` nats (after two rounds of two local steps they differ by
0.035).

On the CPU the wire plane's and the server's kernels run their plain
versions; the test checks the path reaches their front doors.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch import convert  # noqa: E402
from repro_torch import device as port_device  # noqa: E402
from repro_torch import elastic_failover, fl_train_lm  # noqa: E402
from repro_torch.kernels.fedavg import ops as fedavg_ops  # noqa: E402
from repro_torch.kernels.quantize import ops as quant_ops  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
NLL_TOL = 0.1
PARAM_TOL = 0.3
ARGV = ["--rounds", "2", "--clients", "2", "--local-steps", "2"]
ONE_STEP_ARGV = ["--rounds", "1", "--clients", "2", "--local-steps", "1"]


@pytest.fixture(autouse=True)
def _cpu():
    with port_device.use_device("cpu"):
        yield


def _reference_run(ckpt_dir, argv=ARGV):
    """The reference's example, its FederatedSystem recording each
    round's result and the initial weights."""
    spec = importlib.util.spec_from_file_location(
        "ref_fl_train_lm", REPO / "examples" / "fl_train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen = {"results": []}

    class Recording(mod.FederatedSystem):
        def __init__(self, sim, server, clients, params, cfg):
            seen["params"] = jax.tree_util.tree_map(np.asarray, params)
            super().__init__(sim, server, clients, params, cfg)

        def run_round(self, *a, **kw):
            res = super().run_round(*a, **kw)
            seen["results"].append(res)
            return res

    mod.FederatedSystem = Recording
    out = io.StringIO()
    saved = sys.argv
    sys.argv = ["fl_train_lm.py", *argv, "--ckpt-dir", str(ckpt_dir)]
    try:
        with contextlib.redirect_stdout(out):
            assert mod.main() == 0
    finally:
        sys.argv = saved
    nll = [float(line.rsplit(" ", 1)[1]) for line in out.getvalue().splitlines()
           if line.startswith("round ") and not line.startswith("round -")]
    return seen, nll, out.getvalue()


def test_tiny_run_matches_reference(tmp_path, capsys, monkeypatch):
    seen, ref_nll, ref_out = _reference_run(tmp_path / "ref")

    calls = {"quantize": 0, "dequantize": 0, "fedavg": 0}
    for mod, name in ((quant_ops, "quantize"), (quant_ops, "dequantize"),
                      (fedavg_ops, "fedavg")):
        def spy(*a, _f=getattr(mod, name), _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, spy)

    args = fl_train_lm.parser().parse_args(
        [*ARGV, "--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"])
    records = fl_train_lm.run(args, convert.tree_from_reference(
        seen["params"], "cpu"))
    out = capsys.readouterr().out

    want = [(r.duration_ns, list(r.arrived), r.retransmissions, r.bytes_sent)
            for r in seen["results"]]
    got = [(r["t_ns"], r["arrived"], r["retx"], r["wire_bytes"])
           for r in records]
    assert got == want
    # the printed lines agree up to the NLL column
    for a, b in zip(ref_out.splitlines(), out.splitlines()):
        if a.startswith("round ") and not a.startswith("round -"):
            assert a.split("eval NLL")[0] == b.split("eval NLL")[0]
    head = [line for line in out.splitlines() if line.startswith("round -")]
    assert head and head[0] in ref_out          # same weights, same NLL
    np.testing.assert_allclose([r["nll"] for r in records], ref_nll,
                               atol=NLL_TOL)
    assert records[-1]["resume_round"] == 2
    assert "resume round would be: 2" in out
    assert all(v > 0 for v in calls.values()), calls

    # the last round's checkpoint is the final model, and the reference
    # reads it
    from repro.checkpoint import CheckpointManager as RefManager
    tree, meta = RefManager(str(tmp_path / "port")).restore(seen["params"])
    assert meta == {"round": 1, "step": 1}
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(seen["params"])


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(a, np.float64).ravel()
                           for a in jax.tree_util.tree_leaves(tree)])


def test_one_local_step_moves_the_global_model_as_the_reference(
        tmp_path, monkeypatch):
    """One round, one local AdamW step a client, from the same weights:
    the global model the port's last checkpoint holds moved as the
    reference's did, within PARAM_TOL relative L2; a port whose local
    steps are no-ops fails the same check."""
    from repro.checkpoint import CheckpointManager as RefManager
    seen, _, _ = _reference_run(tmp_path / "ref", ONE_STEP_ARGV)
    start = seen["params"]
    want = _flat(RefManager(str(tmp_path / "ref")).restore(start)[0]) \
        - _flat(start)

    def port_move(tag):
        args = fl_train_lm.parser().parse_args(
            [*ONE_STEP_ARGV, "--ckpt-dir", str(tmp_path / tag),
             "--device", "cpu"])
        with contextlib.redirect_stdout(io.StringIO()):
            fl_train_lm.run(args, convert.tree_from_reference(start, "cpu"))
        tree, _ = RefManager(str(tmp_path / tag)).restore(start)
        return _flat(tree) - _flat(start)

    def distance(got):
        return float(np.linalg.norm(got - want) / np.linalg.norm(want))

    assert np.linalg.norm(want) > 0
    assert distance(port_move("port")) <= PARAM_TOL

    def no_op_step(cfg, opt):
        return lambda state, batch: (state, {"loss": torch.zeros(())})
    monkeypatch.setattr(fl_train_lm.M, "make_train_step", no_op_step)
    assert distance(port_move("no_op")) > PARAM_TOL


def test_elastic_failover_asserts_hold(tmp_path, capsys):
    assert elastic_failover.main(["--device", "cpu", "--ckpt-dir",
                                  str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "resume at round 3" in out
    assert "all green" in out


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        fl_train_lm.main(["--rounds", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        elastic_failover.main([])


@pytest.mark.parametrize("n,block", [(5000, 1024), (3072, 1024), (77, 16)])
def test_legacy_int8_bytes_go_through_the_kernels_unchanged(n, block,
                                                            monkeypatch):
    """The headerless int8 codec of this path quantizes through the
    quantize kernels' front door (its plain version here) and writes the
    reference codec's bytes; decoding runs the dequantize front door."""
    from repro.core.compression import Int8Codec as RefInt8Codec
    from repro_torch.core.wire import Int8Stage
    calls = []
    for name in ("quantize", "dequantize"):
        def spy(*a, _f=getattr(quant_ops, name), _n=name, **kw):
            calls.append(_n)
            return _f(*a, **kw)
        monkeypatch.setattr(quant_ops, name, spy)
    vec = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    stage = Int8Stage(block)
    data = stage.legacy_encode(vec)
    assert data == RefInt8Codec(block=block).encode(vec)
    got = stage.legacy_decode(data)
    assert got.tobytes() == RefInt8Codec(block=block).decode(data).tobytes()
    assert calls == ["quantize", "dequantize"]

"""The port's wire plane against the reference's, byte for byte.

The same vectors go through both packages for every spec of the port:
encoded bytes (per item and batched, including the delta/EF state they
leave behind), the packets ``packetize`` cuts from them, and the batch
decode of the server (the port on its ``"kernel"`` backend, the
reference on ``"numpy"``) must be identical.  The ``topk`` pipelines are
held to the same bytes and bits on both port backends (``"kernel"``:
the top-k gather/scatter kernels' plain versions on the CPU;
``"numpy"``: the host path).  The pytree flatten that feeds the wire
must follow JAX's sorted-key order.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import packetizer as ref_packetizer  # noqa: E402
from repro.core import wire as ref_wire  # noqa: E402
from repro_torch import device as port_device  # noqa: E402
from repro_torch.core import packetizer as port_packetizer  # noqa: E402
from repro_torch.core import wire as port_wire  # noqa: E402

TOPK_SPECS = ["topk(0.05)", "topk(0.1)|hex", "delta|ef|topk(0.15)|int8(1024)"]
SPECS = ["raw", "hex", "int8(1024)", "int8(512)", "delta|int8(1024)",
         "delta|ef|int8(1024)", "int8(1024)|crc", *TOPK_SPECS]
N_ITEMS, N_PARAMS, N_MESSAGES = 5, 2500, 3


@pytest.fixture(autouse=True)
def _cpu_kernel_backend():
    assert port_wire.batch_backend() == "kernel"
    assert ref_wire.batch_backend() == "numpy"
    with port_device.use_device("cpu"):
        yield


def _messages(seed: int) -> list[list[np.ndarray]]:
    rng = np.random.default_rng(seed)
    return [[rng.standard_normal(N_PARAMS).astype(np.float32)
             * (1.0 + 3.0 * i) for i in range(N_ITEMS)]
            for _ in range(N_MESSAGES)]


def _states(pipe, refs):
    states = [pipe.new_state() for _ in refs]
    for st, ref in zip(states, refs):
        pipe.set_reference(st, ref)
    return states


def _packet_fields(packets):
    return [(int(p.kind), p.seq, p.total, p.addr, p.txn, p.payload,
             p.checksum) for p in packets]


@pytest.mark.parametrize("spec", SPECS)
def test_encoded_bytes_and_packets_identical(spec):
    msgs = _messages(len(spec))
    ours_p, theirs_p = port_wire.parse_pipeline(spec), \
        ref_wire.parse_pipeline(spec)
    refs = msgs[0]
    ours_item, theirs_item = _states(ours_p, refs), _states(theirs_p, refs)
    ours_batch, theirs_batch = _states(ours_p, refs), _states(theirs_p, refs)
    for msg in msgs[1:]:
        a = [ours_p.encode(v, s) for v, s in zip(msg, ours_item)]
        b = [theirs_p.encode(v, s) for v, s in zip(msg, theirs_item)]
        assert a == b
        assert ours_p.encode_batch(msg, ours_batch) == b
        assert theirs_p.encode_batch(msg, theirs_batch) == b
        for i, data in enumerate(b):
            assert _packet_fields(port_packetizer.packetize(
                data, f"10.0.0.{i}", txn=7)) == _packet_fields(
                ref_packetizer.packetize(data, f"10.0.0.{i}", txn=7))
    # The EF residuals the encoders carry forward agree too.
    for ours, theirs in zip(ours_batch + ours_item,
                            theirs_batch + theirs_item):
        for a, b in zip(ours.slots, theirs.slots):
            assert sorted(a) == sorted(b)
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("spec", SPECS)
def test_batch_decode_kernel_backend_matches_reference_numpy(spec):
    msg = _messages(100 + len(spec))[1]
    datas = ref_wire.parse_pipeline(spec).encode_batch(msg)
    ours = port_wire.decode_payload_batch(datas)
    theirs = ref_wire.decode_payload_batch(datas)
    for (va, pa, ea), (vb, pb, eb) in zip(ours, theirs):
        assert ea is None and eb is None
        assert pa.spec == pb.spec
        np.testing.assert_array_equal(va.view(np.uint32),
                                      vb.view(np.uint32))
    single, _ = port_wire.decode_payload(datas[0])
    np.testing.assert_array_equal(single, theirs[0][0])


def test_numpy_backend_gives_the_same_bytes():
    msg = _messages(5)[0]
    pipe = port_wire.parse_pipeline("int8(512)")
    kernel_bytes = pipe.encode_batch(msg)
    with port_wire.using_batch_backend("numpy"):
        assert pipe.encode_batch(msg) == kernel_bytes
    assert port_wire.batch_backend() == "kernel"
    with pytest.raises(port_wire.WireError, match="unknown batch backend"):
        port_wire.set_batch_backend("pallas")


def test_topk_is_registered_and_stages_match_reference():
    assert "topk" in port_wire.available_stages()
    assert port_wire.available_stages() == ref_wire.available_stages()
    assert isinstance(port_wire.parse_stage("topk(0.25)"),
                      port_wire.TopKStage)


@pytest.mark.parametrize("backend", ["kernel", "numpy"])
@pytest.mark.parametrize("spec", TOPK_SPECS)
def test_topk_pipelines_identical_on_both_backends(spec, backend):
    msgs = _messages(7 + len(spec))
    ours_p, theirs_p = port_wire.parse_pipeline(spec), \
        ref_wire.parse_pipeline(spec)
    refs = msgs[0]
    with port_wire.using_batch_backend(backend):
        ours_item, theirs_item = _states(ours_p, refs), \
            _states(theirs_p, refs)
        ours_batch = _states(ours_p, refs)
        for msg in msgs[1:]:
            b = [theirs_p.encode(v, s) for v, s in zip(msg, theirs_item)]
            assert [ours_p.encode(v, s) for v, s in
                    zip(msg, ours_item)] == b
            assert ours_p.encode_batch(msg, ours_batch) == b
            ours = port_wire.decode_payload_batch(b)
            theirs = ref_wire.decode_payload_batch(b)
            for (va, _, ea), (vb, _, eb) in zip(ours, theirs):
                assert ea is None and eb is None
                np.testing.assert_array_equal(va.view(np.uint32),
                                              vb.view(np.uint32))
            for data, (vb, _, _) in zip(b, theirs):
                va, _ = port_wire.decode_payload(data)
                np.testing.assert_array_equal(va.view(np.uint32),
                                              vb.view(np.uint32))


def test_topk_decode_refuses_out_of_range_indices():
    """Wire-supplied u32 indices are range-checked on the host before any
    cast to int32, per item and in batch, on both backends."""
    stage = port_wire.TopKStage(0.5)
    vals, params = stage.encode(np.arange(8, dtype=np.float32), {})
    bad = params[:8] + np.array([1, 2, 3, 2**32 - 1], "<u4").tobytes()
    big = np.array([2**40], ">u8").tobytes() + params[8:]
    for backend in ("kernel", "numpy"):
        with port_wire.using_batch_backend(backend):
            with pytest.raises(port_wire.WireDecodeError, match="range"):
                stage.decode(vals, bad, {})
            with pytest.raises(port_wire.WireDecodeError, match="range"):
                stage.decode_batch(vals[None], [bad], [{}])
            with pytest.raises(port_wire.WireDecodeError,
                               match="MAX_DECODE_PARAMS"):
                stage.decode(vals, big, {})


def _trees():
    rng = np.random.default_rng(3)
    mlp = {"w1": rng.standard_normal((6, 4)).astype(np.float32),
           "b1": rng.standard_normal(4).astype(np.float32),
           "w2": rng.standard_normal((4, 3)).astype(np.float32),
           "b2": rng.standard_normal(3).astype(np.float32)}
    nested = {"z": [np.float32(1.5), {"b": np.arange(3, dtype=np.float32),
                                      "a": np.ones((2, 2), np.float32)}],
              "a": (np.full(2, 7.0, np.float32), None),
              "m": {"y": np.zeros(1, np.float32), "x": np.ones(1)}}
    return {"mlp": mlp, "nested": nested}


@pytest.mark.parametrize("name", ["mlp", "nested"])
def test_flatten_follows_jax_sorted_key_order(name):
    tree = _trees()[name]
    ours = port_packetizer.flatten_to_vector(tree)
    np.testing.assert_array_equal(
        ours, ref_packetizer.flatten_to_vector(tree))
    back = port_packetizer.unflatten_from_vector(ours * 2, tree)
    want = ref_packetizer.unflatten_from_vector(ours * 2, tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(want)
    assert port_packetizer.num_params(tree) == \
        ref_packetizer.num_params(tree)


def test_mlp_flattens_b1_b2_w1_w2():
    tree = _trees()["mlp"]
    vec = port_packetizer.flatten_to_vector(tree)
    np.testing.assert_array_equal(
        vec, np.concatenate([tree[k].reshape(-1)
                             for k in ("b1", "b2", "w1", "w2")]))

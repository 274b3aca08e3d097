"""The VLM family on the port against the reference: the qwen2-vl-72b
text backbone at the smoke widths (M-RoPE sections (2, 3, 3) over head
width 16, an 8-token vision prefix) in float32, with the reference's
parameters.  The prefill's positions carry distinct temporal / height /
width channels over the vision prefix (``torch_lm_parity.vlm_positions``);
decode steps give all three channels the cache position.

Also M-RoPE's angles alone, and the prefill's routes by positions: where
the mask channel is ``arange`` the attention goes through the flash
attention front door (its plain version on the CPU), where it is not
(positions that start at 5) the masked einsum route, and both agree with
the reference.  Tolerances as ``tests/torch_lm_parity.py`` states; the
angles at 1e-6 (f32 products of the same two numbers, cos / sin of
arguments up to ~60).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_lm_parity as H  # noqa: E402
from repro.models import layers as ref_L  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro_torch import device as port_device  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import layers as port_L  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402

ARCH = "qwen2-vl-72b"


@pytest.fixture(autouse=True)
def _cpu():
    with port_device.use_device("cpu"):
        yield


_RUN: dict = {}


def _run():
    if not _RUN:
        with port_device.use_device("cpu"):
            _RUN.update(H.serve_both(ARCH))
    return _RUN


def test_serving_matches_reference():
    run = _run()
    pos = run["batch"]["positions"]
    assert not (pos[1] == pos[0]).all() and not (pos[2] == pos[0]).all()
    H.check_serving(run)


def test_prefill_then_decode_equals_full_prefill():
    H.prefill_then_decode(_run())


def test_loss_and_grads_match_reference():
    run = _run()
    H.loss_and_grads(run["cfg_ref"], run["cfg"], run["params_ref"],
                     run["params"], H.train_batch(run["cfg"]))


@pytest.mark.parametrize("channels", [3, 2])
def test_mrope_angles_match_reference(channels):
    """(3, B, S) positions with distinct channels, and (B, S) ones (which
    give every section the same positions, as the reference's clamped
    gather does)."""
    cfg = _run()["cfg"]
    pos = H.vlm_positions(cfg, 2, 40, start=3)
    if channels == 2:
        pos = pos[0]
    hd, theta, sections = (cfg.resolved_head_dim, cfg.rope_theta,
                           cfg.mrope_sections)
    want = ref_L.rope_cos_sin(jnp.asarray(pos), hd, theta, sections)
    got = port_L.rope_cos_sin(torch.from_numpy(pos), hd, theta, sections)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (2, 40, hd // 2)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    if channels == 3:
        plain = port_L.rope_cos_sin(torch.from_numpy(pos[0]), hd, theta)
        assert not torch.allclose(got[0], plain[0])
    with pytest.raises(ValueError, match="sections"):
        port_L.rope_cos_sin(torch.from_numpy(pos), hd, theta, (1, 2, 3))


def test_prefill_routes_by_positions(monkeypatch):
    """arange positions: the kernel route; positions from 5: the masked
    route, which never reaches the front door, and matches the
    reference's prefill at the same positions."""
    run = _run()
    assert port_L.prefill_route("kernel", torch.arange(9)) == "kernel"
    assert port_L.prefill_route("plain", torch.arange(9)) == "plain"
    assert port_L.prefill_route("kernel", torch.arange(9) + 5) == \
        port_L.MASKED
    assert port_L.prefill_route("einsum", torch.arange(9) + 5) == "einsum"
    cfg, params = run["cfg"], run["params"]
    batch = dict(run["batch"], positions=H.vlm_positions(cfg, H.B, H.P,
                                                         start=5))
    calls = []
    real = flash_ops.flash_attention
    monkeypatch.setattr(flash_ops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    want, _ = jax.jit(ref_model.make_prefill_step(run["cfg_ref"]))(
        run["params_ref"], {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got, _ = port_model.make_prefill_step(cfg)(
            params, {k: torch.from_numpy(np.ascontiguousarray(v))
                     for k, v in batch.items()})
    assert calls == []
    H.assert_logits_close(got.numpy(), np.asarray(want))
    with torch.no_grad():
        port_model.make_prefill_step(cfg)(
            params, {k: torch.from_numpy(np.ascontiguousarray(v))
                     for k, v in run["batch"].items()})
    assert len(calls) == cfg.num_layers

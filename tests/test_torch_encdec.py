"""The encoder-decoder family on the port against the reference: whisper
-tiny at the smoke widths (2 encoder and 2 decoder layers, d 64, 4 MHA
heads of 16, 24 encoder frames) in float32, with the reference's
parameters and seeded frames.  The port's prefill runs the encoder's
bidirectional self-attention and the decoder's causal self-attention and
cross-attention (48 queries over 24 frames) through the flash attention
front door (its plain version on the CPU); the reference's prefill runs
its einsum attention.  Tolerances as ``tests/torch_lm_parity.py`` states.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_lm_parity as H  # noqa: E402
from repro.models import encdec as ref_E  # noqa: E402
from repro_torch import device as port_device  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import encdec as port_E  # noqa: E402

ARCH = "whisper-tiny"


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
    H.check_serving(run)
    assert run["cache"][1]["ck"].shape[2] == run["cfg"].encoder_seq


def test_prefill_then_decode_equals_full_prefill():
    H.prefill_then_decode(_run())


def test_loss_and_grads_match_reference():
    run = _run()
    H.loss_and_grads(run["cfg_ref"], run["cfg"], run["params_ref"],
                     run["params"], H.train_batch(run["cfg"]))


@pytest.mark.parametrize("impl", ["kernel", "einsum"])
def test_encoder_matches_reference(impl, monkeypatch):
    """The encoder alone on the frames, by the front door (one call a
    layer, bidirectional) and by the einsum attention."""
    run = _run()
    calls = []
    real = flash_ops.flash_attention

    def spy(q, k, v, **kw):
        calls.append(kw["causal"])
        return real(q, k, v, **kw)
    monkeypatch.setattr(flash_ops, "flash_attention", spy)
    frames = run["batch"]["frames"]
    want = ref_E.encode(run["cfg_ref"], run["params_ref"],
                        jnp.asarray(frames), remat_policy="none")
    with torch.no_grad():
        got = port_E.encode(run["cfg"], run["params"],
                            torch.from_numpy(frames), "none", impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=H.STATE_TOL, atol=H.STATE_TOL)
    assert calls == ([False] * run["cfg"].encoder_layers
                     if impl == "kernel" else [])


def test_sinusoidal_tables_match_reference():
    """The prefill's table (numpy float64, cast) and the decode step's row
    (float32 on the device) against the reference's."""
    d = 64
    np.testing.assert_array_equal(
        port_E.sinusoidal(30, d, torch.float32).numpy(),
        np.asarray(ref_E.sinusoidal(30, d, jnp.float32)))
    table = port_E.sinusoidal(30, d, torch.float32).numpy()
    for pos in (0, 7, 29):
        np.testing.assert_allclose(
            port_E._sinusoidal_at(pos, d, torch.float32, "cpu").numpy(),
            table[pos], rtol=1e-5, atol=1e-5)

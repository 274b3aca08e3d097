"""The hybrid family on the port against the reference: hymba-1.5b at the
smoke widths with 3 layers (layers 0 and 1 global, as the smoke config's
``full_attn_layers``; layer 2 local with window 16, which a 48-token
prompt passes) in float32, with the reference's parameters.  Serving
holds the SSM state and the conv tail beside the KV cache.

The selective scan alone: the port's log-step scan (``mamba.linear_scan``)
against the reference's ``associative_scan`` over a prompt and with a
carried state (the decode step, with its conv state), and against a
float64 loop over the tokens.  Tolerances as ``tests/torch_lm_parity.py``
states; the scan at 1e-5 relative to the largest output (float32 sums in
another order).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_lm_parity as H  # noqa: E402
from repro.models import mamba as ref_M  # noqa: E402
from repro_torch import device as port_device  # noqa: E402
from repro_torch.models import mamba as port_M  # noqa: E402
from repro_torch.models import transformer as port_T  # noqa: E402

ARCH = "hymba-1.5b"
SCAN_TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    with port_device.use_device("cpu"):
        yield


_RUN: dict = {}


def _run():
    if not _RUN:
        with port_device.use_device("cpu"):
            _RUN.update(H.serve_both(ARCH, num_layers=3))
    return _RUN


def test_serving_matches_reference():
    run = _run()
    assert port_T.layer_windows(run["cfg"]) == [0, 0, 16]
    H.check_serving(run)


def test_prefill_then_decode_equals_full_prefill():
    H.prefill_then_decode(_run())


def test_loss_and_grads_match_reference():
    run = _run()
    H.loss_and_grads(run["cfg_ref"], run["cfg"], run["params_ref"],
                     run["params"], H.train_batch(run["cfg"]))


def _ssm(layer: int = 2):
    run = _run()
    return tuple({k: v[layer] for k, v in tree["layers"]["ssm"].items()}
                 for tree in (run["params_ref"], run["params"]))


def _close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= SCAN_TOL * scale


@pytest.mark.parametrize("S", [1, 37, 64])
def test_selective_scan_matches_reference(S):
    p_ref, p = _ssm()
    x = np.random.default_rng(S).standard_normal(
        (2, S, p["w_dt"].shape[0])).astype(np.float32)
    want = ref_M.selective_scan(jnp.asarray(x), p_ref)
    got = port_M.selective_scan(torch.from_numpy(x), p)
    _close(got[0].numpy(), np.asarray(want[0]))
    _close(got[1].numpy(), np.asarray(want[1]))
    assert got[2] is None and want[2] is None


def test_selective_scan_with_carried_state_matches_reference():
    """One decode step from a prompt's SSM state and conv tail."""
    p_ref, p = _ssm()
    rng = np.random.default_rng(5)
    D = p["w_dt"].shape[0]
    prompt = rng.standard_normal((2, 20, D)).astype(np.float32)
    step = rng.standard_normal((2, 1, D)).astype(np.float32)
    state = port_M.selective_scan(torch.from_numpy(prompt), p)[1]
    conv = torch.from_numpy(prompt[:, -3:])
    want = ref_M.selective_scan(jnp.asarray(step), p_ref,
                                state=jnp.asarray(state.numpy()),
                                conv_state=jnp.asarray(conv.numpy()))
    got = port_M.selective_scan(torch.from_numpy(step), p, state=state,
                                conv_state=conv)
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w))
    # the step continues the prompt: its output is the full scan's last
    full = port_M.selective_scan(torch.from_numpy(
        np.concatenate([prompt, step], axis=1)), p)
    _close(got[0][:, 0].numpy(), full[0][:, -1].numpy())
    _close(got[1].numpy(), full[1].numpy())


@pytest.mark.parametrize("S", [1, 2, 5, 64, 100])
def test_linear_scan_is_the_recurrence(S):
    rng = np.random.default_rng(S)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, S, 3, 4)))
    b = torch.from_numpy(rng.standard_normal((2, S, 3, 4)))
    h, want = torch.zeros_like(b[:, 0]), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(port_M.linear_scan(a, b),
                               torch.stack(want, 1), rtol=1e-12, atol=1e-12)

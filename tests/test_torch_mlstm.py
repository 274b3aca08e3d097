"""The port's chunkwise mLSTM (plain version on the CPU) against the
reference's Pallas kernel in interpret mode, its oracle ``mlstm_ref``
(the reference's ``mlstm_parallel``), and the recurrent ``mlstm_step``.

Tolerances are those of ``tests/test_kernels.py::TestMlstmKernel``:
``3e-4`` at its parametrised shapes, ``5e-4`` for its sweep with gates
centred at 0, and ``2e-3`` against step-by-step recurrence (a different
summation order over 128 steps).  All in f32, where the Pallas kernel's
cast of the gated scores to ``v``'s type is the identity.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.mlstm.mlstm import mlstm_pallas  # noqa: E402
from repro.kernels.mlstm.ref import mlstm_ref  # noqa: E402
from repro.models import xlstm as ref_xlstm  # noqa: E402
from repro_torch import device as port_device  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.mlstm import ops as mlstm_ops  # noqa: E402
from repro_torch.kernels.mlstm import ref as mlstm_plain  # noqa: E402
from repro_torch.models import xlstm as port_xlstm  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu():
    with port_device.use_device("cpu"):
        yield


def _inputs(seed, B, S, nh, dh, f_shift):
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal((B, S, nh, dh)).astype(np.float32)
           for _ in range(3)]
    ig = rng.standard_normal((B, S, nh)).astype(np.float32)
    fg = (rng.standard_normal((B, S, nh)) + f_shift).astype(np.float32)
    return (*qkv, ig, fg)


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("B,S,nh,dh,f_shift,seed,tol", [
    (1, 128, 2, 64, 2.0, 128, 3e-4),
    (2, 256, 1, 32, 2.0, 256, 3e-4),
    (1, 384, 4, 64, 2.0, 384, 3e-4),
    (1, 256, 1, 32, 0.0, 11, 5e-4),
    (1, 256, 3, 32, 0.0, 12, 5e-4),
])
def test_plain_version_matches_pallas_kernel_and_oracle(B, S, nh, dh,
                                                        f_shift, seed, tol):
    jx, pt = _both(_inputs(seed, B, S, nh, dh, f_shift))
    pallas = np.asarray(mlstm_pallas(*jx, interpret=True))
    oracle = np.asarray(mlstm_ref(*jx))
    plain = mlstm_plain.mlstm_parallel(*pt).numpy()
    np.testing.assert_allclose(plain, pallas, rtol=tol, atol=tol)
    np.testing.assert_allclose(plain, oracle, rtol=tol, atol=tol)
    # The front door on a CPU tensor is the plain version itself.
    np.testing.assert_array_equal(mlstm_ops.mlstm(*pt).numpy(), plain)


def test_plain_version_matches_recurrent_stepping():
    """Plain version == the port's step-by-step recurrence (the decode
    path) == the reference's, and the prefill->decode handoff state
    ``mlstm_final_state`` equals the stepped state."""
    B, S, nh, dh = 1, 128, 2, 32
    q, k, v, ig, fg = _inputs(5, B, S, nh, dh, 1.0)
    jx, pt = _both((q, k, v, ig, fg))
    state = (torch.zeros((B, nh, dh, dh)), torch.zeros((B, nh, dh)),
             torch.full((B, nh), -torch.inf))
    jstate = (jnp.zeros((B, nh, dh, dh)), jnp.zeros((B, nh, dh)),
              jnp.full((B, nh), -jnp.inf))
    hs, jhs = [], []
    for t in range(S):
        state, h = port_xlstm.mlstm_step(state, *(a[:, t] for a in pt))
        jstate, jh = ref_xlstm.mlstm_step(jstate, *(a[:, t] for a in jx))
        hs.append(h)
        jhs.append(np.asarray(jh))
    stepped = torch.stack(hs, dim=1).numpy()
    plain = mlstm_plain.mlstm_parallel(*pt).numpy()
    np.testing.assert_allclose(plain, stepped, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(stepped, np.stack(jhs, axis=1), rtol=2e-5,
                               atol=2e-5)
    C, n, m = port_xlstm.mlstm_final_state(*pt)
    # The closed form carries another stabiliser; compare C and n rescaled
    # to the stepped state's m.
    for closed, steppd in ((C, state[0]), (n, state[1])):
        shift = torch.exp(m - state[2])
        while shift.dim() < closed.dim():
            shift = shift[..., None]
        np.testing.assert_allclose((closed * shift).numpy(),
                                   steppd.numpy(), rtol=2e-4, atol=2e-4)


def test_port_mlstm_parallel_is_the_references():
    """models.xlstm.mlstm_parallel (the kernel's plain version) against
    the reference's ``mlstm_parallel`` at a length no tile divides."""
    jx, pt = _both(_inputs(9, 2, 150, 2, 16, 1.0))
    np.testing.assert_allclose(port_xlstm.mlstm_parallel(*pt).numpy(),
                               np.asarray(ref_xlstm.mlstm_parallel(*jx)),
                               rtol=3e-4, atol=3e-4)


def test_front_door_on_cpu_builds_nothing(monkeypatch):
    def _no_build(name):
        raise AssertionError(f"library {name!r} loaded for a CPU tensor")
    monkeypatch.setattr(_build, "load", _no_build)
    kernels.reset_launch_counts()
    _, pt = _both(_inputs(1, 1, 8, 2, 16, 0.0))
    mlstm_ops.mlstm(*pt)
    assert kernels.launch_counts["mlstm"] == 0
    with pytest.raises(ValueError, match="gates"):
        mlstm_ops.mlstm(*pt[:3], pt[3][:, :4], pt[4])


def test_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check "
                    "on the card")
    dev = torch.device("cuda")
    for S in (128, 300):
        _, pt = _both(_inputs(S, 2, S, 2, 64, 1.0))
        got = mlstm_ops.mlstm(*(a.to(dev) for a in pt)).cpu()
        want = mlstm_plain.mlstm_parallel(*pt)
        torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-4)

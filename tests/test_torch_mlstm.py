"""The port's chunkwise mLSTM (plain version on the CPU) against the
reference's Pallas kernel in interpret mode, its oracle ``mlstm_ref``
(the reference's ``mlstm_parallel``), and the recurrent ``mlstm_step``.

Tolerances are those of ``tests/test_kernels.py::TestMlstmKernel``:
``3e-4`` at its parametrised shapes, ``5e-4`` for its sweep with gates
centred at 0, and ``2e-3`` against step-by-step recurrence (a different
summation order over 128 steps).  All in f32, where the Pallas kernel's
cast of the gated scores to ``v``'s type is the identity; in bf16 at
xlstm-350m's head width 512, the band ``chip_smoke.py`` holds the kernel
to (``3e-2`` scaled by the row's largest output).

The tensor-core route's gate terms (``ops.gate_terms``: the stabiliser of
every row before the kernel's loop) are held against the plain version's
own D and row max, and the plain version in that form against the plain
version itself.
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


def _plain_d_and_m(i_gate, f_gate):
    """The plain version's D - m over kept pairs, as (B, nh, q, k), its
    floor exp(-m) as (B, nh, q), the causal mask and max |F|."""
    S = i_gate.shape[1]
    cum = torch.cumsum(torch.nn.functional.logsigmoid(f_gate), dim=1)
    D = cum[:, :, None, :] - cum[:, None, :, :] + i_gate[:, None, :, :]
    t = torch.arange(S)
    causal = t[:, None] >= t[None, :]
    D = torch.where(causal[None, :, :, None], D, -torch.inf)
    m = torch.amax(D, dim=2, keepdim=True)
    return ((D - m).permute(0, 3, 1, 2), torch.exp(-m[:, :, 0, :]).transpose(
        1, 2), causal, float(cum.abs().max()))


@pytest.mark.parametrize("S,f_shift,late", [
    (37, 0.0, False), (200, 2.0, False), (256, 0.0, False),
    (63, 2.0, True), (300, 0.0, True)])
def test_gate_terms_give_the_plain_versions_stabiliser(S, f_shift, late):
    """G_k - M_q = D_qk - m_q on every kept pair and floor = exp(-m), in
    f32: to 1e-5, plus 4 f32 ulps of the largest |F| (both forms subtract
    cumulative log forget gates of that size, each rounded at it).
    ``late``: input gates that rise to a new prefix max near the end."""
    *_, ig, fg = _inputs(S + int(f_shift), 2, S, 3, 1, f_shift)
    if late:
        ig[:, -5:] += np.linspace(4.0, 12.0, 5, dtype=np.float32)[:, None]
    ig, fg = torch.from_numpy(ig), torch.from_numpy(fg)
    G, M, floor = mlstm_ops.gate_terms(ig, fg)
    assert all(t.shape == (2, 3, S) and t.dtype == torch.float32
               and t.is_contiguous() for t in (G, M, floor))
    dm, plain_floor, causal, f_max = _plain_d_and_m(ig, fg)
    tol = 1e-5 + 4 * np.finfo(np.float32).eps * f_max
    E = G[:, :, None, :] - M[:, :, :, None]
    kept = causal[None, None].expand_as(E)
    assert float((E - dm)[kept].abs().max()) <= tol
    assert float(((floor - plain_floor) / plain_floor).abs().max()) <= tol
    if late:   # the prefix max moved in the last rows
        assert bool((M[:, :, -1] > M[:, :, -6]).all())


@pytest.mark.parametrize("B,S,nh,dh,f_shift,seed", [
    (1, 128, 2, 64, 2.0, 21), (2, 150, 2, 16, 1.0, 22),
    (1, 256, 3, 32, 0.0, 23)])
def test_known_stabiliser_form_is_mlstm_parallel(B, S, nh, dh, f_shift,
                                                 seed):
    """The plain version fed the gate terms (the tensor-core kernel's
    arithmetic) equals ``mlstm_parallel`` in f32, to the 3e-4 the plain
    version holds against the Pallas kernel."""
    pt = [torch.from_numpy(a) for a in _inputs(seed, B, S, nh, dh, f_shift)]
    known = mlstm_plain.mlstm_known_stabiliser(
        *pt[:3], *mlstm_ops.gate_terms(*pt[3:]))
    torch.testing.assert_close(known, mlstm_plain.mlstm_parallel(*pt),
                               rtol=3e-4, atol=3e-4)


def _row_band(got, want, band):
    """|got - want| <= band * (1 + the largest |want| of the row)."""
    d = (got.float() - want.float()).abs()
    scale = want.float().abs().amax(dim=-1, keepdim=True)
    return bool((d <= band * (1 + scale)).all()), float(d.max())


@pytest.mark.parametrize("S", [128, 256])
def test_bf16_front_door_at_dh512_matches_pallas_kernel(S):
    """bf16 at xlstm-350m's head width: the front door on the CPU (the
    plain version) against the Pallas kernel in interpret mode, in the
    row-scaled 3e-2 band: both round the gated scores to bf16 before the
    product with v, under other stabilisers."""
    arrays = [a.astype(jnp.bfloat16).astype(np.float32)
              for a in _inputs(S + 512, 1, S, 2, 512, 1.0)]
    jx = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    pt = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    pallas = torch.from_numpy(np.array(
        mlstm_pallas(*jx, interpret=True).astype(jnp.float32)))
    got = mlstm_ops.mlstm(*pt)
    assert got.dtype == torch.bfloat16 and got.shape == (1, S, 2, 512)
    ok, err = _row_band(got, pallas, 3e-2)
    assert ok, err


def test_routes_by_dtype_and_head_width():
    """bf16 at dh 512 takes the tensor-core kernel; f32 everywhere and
    bf16 below 512 the CUDA-core one; nothing else has a route."""
    assert mlstm_ops.ROUTES[(torch.bfloat16, 512)] == "mlstm_wgmma_kernel"
    assert {r for key, r in mlstm_ops.ROUTES.items()
            if key != (torch.bfloat16, 512)} == {"mlstm_kernel"}
    assert set(mlstm_ops.ROUTES) == {
        (dt, dh) for dt in (torch.float32, torch.bfloat16)
        for dh in mlstm_ops.HEAD_DIMS}


@pytest.mark.parametrize("dh,width", [(16, 64), (32, 64), (320, 512)])
def test_padded_head_width_is_the_plain_version(dh, width):
    """What the CUDA route does at a head width it is not compiled for
    (the smoke xLSTM's dh 32, the 100m scale's dh 320): q, k, v
    zero-padded to the next compiled width, the plain version run there
    with the true width's scale, the output cut back.  At 5e-4, the
    gates-centred-at-0 band above."""
    from repro_torch.kernels.head_width import kernel_width, run_padded
    assert kernel_width(dh, mlstm_ops.HEAD_DIMS, "mlstm") == width
    _, pt = _both(_inputs(dh, 2, 130, 2, dh, 0.0))
    got = run_padded(mlstm_plain.mlstm_parallel, *pt,
                     widths=mlstm_ops.HEAD_DIMS, what="mlstm")
    assert got.shape == pt[0].shape
    torch.testing.assert_close(got, mlstm_plain.mlstm_parallel(*pt),
                               rtol=5e-4, atol=5e-4)


def test_kernel_matches_plain_version_on_the_card():
    """f32 at dh 64 and 32 (zero-padded to 64) at 5e-4; bf16 at dh 512
    and 320 (zero-padded to 512) in the row-scaled 3e-2 band."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check "
                    "on the card")
    dev = torch.device("cuda")
    for S in (128, 300):
        _, pt = _both(_inputs(S, 2, S, 2, 64, 1.0))
        got = mlstm_ops.mlstm(*(a.to(dev) for a in pt)).cpu()
        want = mlstm_plain.mlstm_parallel(*pt)
        torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-4)
    # bf16 at dh 512, the tensor-core route: tails, S under one tile, and
    # a q base off the 16-byte grid
    for S in (1, 63, 65, 200):
        _, pt = _both(_inputs(S + 1, 1, S, 2, 512, 2.0))
        pt = [a.to(dev, torch.bfloat16) for a in pt]
        want = mlstm_plain.mlstm_parallel(*pt)
        ok, err = _row_band(mlstm_ops.mlstm(*pt), want, 3e-2)
        assert ok, (S, err)
        q_off = torch.empty(pt[0].numel() + 8, dtype=torch.bfloat16,
                            device=dev)[1:1 + pt[0].numel()].view_as(pt[0])
        q_off.copy_(pt[0])
        ok, err = _row_band(mlstm_ops.mlstm(q_off, *pt[1:]), want, 3e-2)
        assert ok, (S, "q off the 16-byte grid", err)
    for S in (128, 256):
        _, pt = _both(_inputs(S + 2, 1, S, 3, 32, 0.0))
        got = mlstm_ops.mlstm(*(a.to(dev) for a in pt)).cpu()
        torch.testing.assert_close(got, mlstm_plain.mlstm_parallel(*pt),
                                   rtol=5e-4, atol=5e-4)
    _, pt = _both(_inputs(320, 2, 200, 4, 320, 2.0))
    pt = [a.to(dev, torch.bfloat16) for a in pt]
    ok, err = _row_band(mlstm_ops.mlstm(*pt),
                        mlstm_plain.mlstm_parallel(*pt), 3e-2)
    assert ok, ("dh 320", err)

"""The port's flash attention (plain version on the CPU) against the
reference's Pallas kernel in interpret mode, its oracle ``attention_ref``,
and the model's einsum GQA attention.

Tolerance: ``rtol = atol = 2e-5`` in f32, the band ``tests/test_kernels.py``
holds the Pallas kernel to against the same oracle (the plain version sums
in another order than either), and ``3e-2`` in bf16, the band of its
``test_dtypes`` (p is rounded to bf16 before the PV product on both sides,
under running maxima that differ tile by tile).  The shapes are the five
of ``TestFlashAttentionKernel``, plus a prompt length that is not a
multiple of the Pallas kernel's 128-row tile, which only the port takes.
bf16 is the route the card's tensor-core kernel takes (hd 64, 128, 256).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ops import \
    flash_attention as pallas_front_door  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch import device as port_device  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402

TOL = 2e-5
BF16_TOL = 3e-2


@pytest.fixture(autouse=True)
def _cpu():
    with port_device.use_device("cpu"):
        yield


def _randn(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("B,H,S,hd,causal,window", [
    (1, 2, 256, 64, True, 0),
    (2, 1, 128, 128, True, 0),
    (1, 2, 256, 64, True, 64),     # sliding window
    (1, 1, 256, 64, False, 0),     # bidirectional (whisper encoder)
    (2, 3, 384, 32, True, 128),
])
def test_plain_version_matches_pallas_kernel_and_oracle(B, H, S, hd, causal,
                                                        window):
    rng = np.random.default_rng(S + hd)
    q, k, v = (_randn(rng, (B, H, S, hd)) for _ in range(3))
    pallas = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    window=window, interpret=True)
    oracle = attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, window=window)
    plain = flash_ref.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal,
                                    window=window).numpy()
    np.testing.assert_allclose(plain, np.asarray(pallas), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(plain, np.asarray(oracle), rtol=TOL, atol=TOL)
    # The front door, in the model layout, is the same function.
    door = flash_ops.flash_attention(
        *(torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)),
        causal=causal, window=window).transpose(1, 2).numpy()
    np.testing.assert_allclose(door, plain, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("B,S,H,KV,hd,window", [
    (2, 256, 4, 2, 64, 0),       # GQA in the model layout
    (1, 384, 4, 2, 64, 100),     # a window no tile divides
    (1, 384, 4, 2, 128, 100),
    (2, 256, 4, 1, 128, 0),
])
def test_plain_version_matches_pallas_kernel_in_bf16(B, S, H, KV, hd,
                                                     window):
    """bf16 in the model layout: the port's front door (its plain version
    on the CPU) against the reference's Pallas front door in interpret
    mode, on the same bf16 values."""
    rng = np.random.default_rng(10 + S + hd + window)
    q = _randn(rng, (B, S, H, hd))
    k, v = _randn(rng, (B, S, KV, hd)), _randn(rng, (B, S, KV, hd))
    pallas = pallas_front_door(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=True,
        window=window, interpret=True)
    got = flash_ops.flash_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        causal=True, window=window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("S,window", [(128, 0), (200, 0), (200, 48)])
def test_gqa_front_door_matches_model_attention(S, window):
    """GQA in the model layout: the port's front door against the
    reference's einsum ``gqa_attention`` and its Pallas front door (which
    repeats KV heads), at S=200, not a multiple of the 128-row tile, where
    the Pallas kernel cannot run."""
    rng = np.random.default_rng(1 + S + window)
    B, H, KV, hd = 2, 8, 2, 64
    q = _randn(rng, (B, S, H, hd))
    k, v = _randn(rng, (B, S, KV, hd)), _randn(rng, (B, S, KV, hd))
    pos = jnp.arange(S, dtype=jnp.int32)
    ref = ref_layers.gqa_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), q_pos=pos, kv_pos=pos,
                                   causal=True, window=window)
    got = flash_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=True,
                                    window=window).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=TOL, atol=TOL)
    if S % 128 == 0:
        pallas = pallas_front_door(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True,
                                   window=window, interpret=True)
        np.testing.assert_allclose(got, np.asarray(pallas), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("B,S,T,H,KV,hd,causal,window", [
    (2, 64, 256, 6, 6, 64, False, 0),      # cross-attention, S != T
    (1, 128, 384, 4, 4, 64, False, 0),
    (1, 256, 256, 5, 1, 64, True, 100),    # GQA ratio 5 (hymba 25 / 5)
    (1, 128, 128, 4, 4, 128, True, 0),     # MHA, KV = H (olmoe)
])
def test_new_family_shapes_match_reference(B, S, T, H, KV, hd, causal,
                                           window):
    """The shapes the MoE, VLM, encdec and hybrid families bring: the
    port's front door (its plain version on the CPU) against the
    reference's einsum ``gqa_attention`` and, where its tiles divide S and
    T, its Pallas front door in interpret mode."""
    rng = np.random.default_rng(S + T + H)
    q = _randn(rng, (B, S, H, hd))
    k, v = _randn(rng, (B, T, KV, hd)), _randn(rng, (B, T, KV, hd))
    got = flash_ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal=causal, window=window).numpy()
    ref = ref_layers.gqa_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_pos=jnp.arange(S), kv_pos=jnp.arange(T), causal=causal,
        window=window)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=TOL, atol=TOL)
    pallas = pallas_front_door(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, window=window,
                               interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=TOL, atol=TOL)


def test_model_prefill_attention_routes_agree():
    """``layers.attention`` without ``kv_valid``: the kernel route (its
    plain version on the CPU) equals the plain route and the decode path's
    einsum attention; an unknown route raises."""
    rng = np.random.default_rng(3)
    B, S, H, KV, hd = 1, 40, 4, 2, 32
    q = torch.from_numpy(_randn(rng, (B, S, H, hd)))
    k = torch.from_numpy(_randn(rng, (B, S, KV, hd)))
    v = torch.from_numpy(_randn(rng, (B, S, KV, hd)))
    pos = torch.arange(S)
    outs = [port_layers.attention(q, k, v, q_pos=pos, kv_pos=pos, window=16,
                                  impl=impl) for impl in ("kernel", "plain")]
    einsum = port_layers.gqa_attention(q, k, v, q_pos=pos, kv_pos=pos,
                                       window=16)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    torch.testing.assert_close(outs[0], einsum, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="impl"):
        port_layers.attention(q, k, v, q_pos=pos, kv_pos=pos, impl="auto")


def test_front_door_on_cpu_builds_nothing(monkeypatch):
    def _no_build(name):
        raise AssertionError(f"library {name!r} loaded for a CPU tensor")
    monkeypatch.setattr(_build, "load", _no_build)
    kernels.reset_launch_counts()
    q = torch.zeros((1, 8, 2, 16))
    flash_ops.flash_attention(q, q, q)
    assert kernels.launch_counts["flash_attention"] == 0
    with pytest.raises(ValueError, match="KV heads"):
        flash_ops.flash_attention(q, torch.zeros((1, 8, 3, 16)),
                                  torch.zeros((1, 8, 3, 16)))


@pytest.mark.parametrize("hd,width", [(16, 64), (32, 64), (320, 512)])
def test_padded_head_width_is_the_plain_version(hd, width):
    """What the CUDA route does at a head width it is not compiled for:
    q, k, v zero-padded to the next compiled width, the plain version run
    there with the true width's scale, the output cut back.  At 2e-5 (the
    f32 band: the padded sums add zeros in another order)."""
    from repro_torch.kernels.head_width import kernel_width, run_padded
    assert kernel_width(hd, flash_ops.HEAD_DIMS, "flash_attention") == width
    rng = np.random.default_rng(hd)
    q = torch.from_numpy(_randn(rng, (2, 150, 4, hd)))
    k, v = (torch.from_numpy(_randn(rng, (2, 150, 2, hd))) for _ in "kv")
    for causal, window in ((True, 0), (True, 40), (False, 0)):
        got = run_padded(flash_ref.flash_attention, q, k, v,
                         widths=flash_ops.HEAD_DIMS, what="flash_attention",
                         causal=causal, window=window)
        assert got.shape == q.shape
        want = flash_ref.flash_attention(q, k, v, causal=causal,
                                         window=window)
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def test_head_width_above_the_largest_raises():
    from repro_torch.kernels.head_width import kernel_width
    with pytest.raises(ValueError, match="up to 512"):
        kernel_width(576, flash_ops.HEAD_DIMS, "flash_attention")


def test_kernel_matches_plain_version_on_the_card():
    """f32 (the CUDA-core kernel) at 2e-5, and bf16 at hd 64, 128, 256
    (the tensor-core kernel) and 512 (the CUDA-core kernel) within the
    bf16 band, with prompts no 128-row tile divides and windows; hd 16 and
    32 (zero-padded to 64) in both dtypes, including the reference's
    ``(2, 3, 384, 32, window 128)`` case."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check "
                    "on the card")
    rng = np.random.default_rng(4)
    dev = torch.device("cuda")
    for S, window in ((256, 0), (300, 64)):
        q = torch.from_numpy(_randn(rng, (2, S, 8, 64)))
        k = torch.from_numpy(_randn(rng, (2, S, 4, 64)))
        v = torch.from_numpy(_randn(rng, (2, S, 4, 64)))
        got = flash_ops.flash_attention(q.to(dev), k.to(dev), v.to(dev),
                                        window=window).cpu()
        want = flash_ref.flash_attention(q, k, v, window=window)
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    for hd, S, window, causal in ((64, 300, 100, True), (128, 200, 0, True),
                                  (128, 333, 1000, True), (256, 300, 64, True),
                                  (256, 128, 0, False), (512, 100, 0, True)):
        q, k, v = (torch.from_numpy(_randn(rng, (2, S, n, hd))).to(
            torch.bfloat16) for n in (4, 2, 2))
        got = flash_ops.flash_attention(q.to(dev), k.to(dev), v.to(dev),
                                        causal=causal, window=window).cpu()
        want = flash_ref.flash_attention(q, k, v, causal=causal,
                                         window=window)
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=BF16_TOL, atol=BF16_TOL)
    for hd, S, window, dtype, tol in ((32, 384, 128, torch.float32, TOL),
                                      (16, 200, 0, torch.float32, TOL),
                                      (32, 300, 64, torch.bfloat16, BF16_TOL),
                                      (16, 130, 0, torch.bfloat16,
                                       BF16_TOL)):
        q, k, v = (torch.from_numpy(_randn(rng, (2, S, n, hd))).to(dtype)
                   for n in (3, 3, 3))
        got = flash_ops.flash_attention(q.to(dev), k.to(dev), v.to(dev),
                                        window=window).cpu()
        want = flash_ref.flash_attention(q, k, v, window=window)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    # A base address off the 16-byte grid (TMA's tensor maps refuse one):
    # the front door copies the input first.
    q, k, v = (torch.from_numpy(_randn(rng, (1, 64, n, 128))).to(
        torch.bfloat16) for n in (2, 1, 1))
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=dev)
    q_off = flat[1:].view(q.shape).copy_(q)
    assert q_off.data_ptr() % 16
    got = flash_ops.flash_attention(q_off, k.to(dev), v.to(dev)).cpu()
    torch.testing.assert_close(got.float(),
                               flash_ref.flash_attention(q, k, v).float(),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_kernel_at_the_new_family_shapes_on_the_card():
    """bf16 (the tensor-core kernel) within the bf16 band, and f32 (the
    CUDA-core kernel) at 2e-5, at the layer shapes the MoE, VLM, encdec
    and hybrid families give it: hd 64 bidirectional over 1500 frames
    (whisper's encoder), 64 queries over 1500 keys without a mask (its
    cross-attention), MHA with KV = H = 16 at hd 128 (olmoe), and 25 query
    heads over 5 KV heads at hd 64 with window 1024 (hymba)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check "
                    "on the card")
    rng = np.random.default_rng(18)
    dev = torch.device("cuda")
    for B, S, T, H, KV, hd, causal, window in (
            (2, 1500, 1500, 6, 6, 64, False, 0),
            (2, 64, 1500, 6, 6, 64, False, 0),
            (1, 700, 700, 16, 16, 128, True, 0),
            (1, 1500, 1500, 25, 5, 64, True, 1024)):
        q = torch.from_numpy(_randn(rng, (B, S, H, hd)))
        k, v = (torch.from_numpy(_randn(rng, (B, T, KV, hd)))
                for _ in range(2))
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, TOL)):
            qd, kd, vd = (t.to(dtype) for t in (q, k, v))
            got = flash_ops.flash_attention(
                qd.to(dev), kd.to(dev), vd.to(dev), causal=causal,
                window=window).cpu()
            want = flash_ref.flash_attention(qd, kd, vd, causal=causal,
                                             window=window)
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)

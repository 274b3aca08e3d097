"""xLSTM backbone: mLSTM (matrix-memory, parallelizable) and sLSTM
(scalar-memory, sequential) blocks interleaved 7:1 (xLSTM[7:1]); the
reference's ``repro.models.xlstm`` in PyTorch.

Prefill runs the mLSTM over the whole prompt through the chunkwise mLSTM
kernel's front door (where the reference calls its XLA twin
``mlstm_chunked``); decode uses the O(1)/token recurrent forms.  There is
no KV cache, only per-layer state.  Training (``xlstm_hidden``,
``xlstm_loss``) runs the reference's own mLSTM forms under autograd,
``mlstm_chunked`` and its fallback ``mlstm_parallel`` (the kernel has no
backward, and the reference's loss calls none).

Layout, as in the reference: layers come in GROUPS of ``slstm_every``
(7 mLSTM + 1 sLSTM) with stacked params: mLSTM params lead with (G, 7, ...),
sLSTM with (G, ...); the reference's scans are Python loops.

Simplifications the reference records: the short causal conv preceding q/k
in the original mLSTM block is omitted; norms are RMSNorm.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import constraint, gather_weights
from repro_torch.kernels.mlstm import ops as mlstm_ops
from repro_torch.kernels.mlstm import ref as mlstm_ref
from repro_torch.launch import cost
from repro_torch.models import layers as L
from repro_torch.models.transformer import padded_vocab

PROJ_FACTOR = 2  # mLSTM up-projection factor


def _dims(cfg: ModelConfig):
    d = cfg.d_model
    di = PROJ_FACTOR * d
    nh = cfg.num_heads
    dh = di // nh
    return d, di, nh, dh


def _groups(cfg: ModelConfig) -> tuple[int, int]:
    """(G groups, M mLSTM layers per group)."""
    per = cfg.slstm_every
    return cfg.num_layers // per, per - 1


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------
def init_xlstm(cfg: ModelConfig, gen: torch.Generator,
               device: _device.DeviceLike | None = None) -> dict:
    """Random parameters in the reference's tree layout, drawn from ``gen``
    (a generator on ``device``)."""
    dev = _device.resolve(device)
    dt = getattr(torch, cfg.dtype)
    d, di, nh, dh = _dims(cfg)
    dh_s = d // nh          # sLSTM operates at model width
    G, M = _groups(cfg)

    def init(shape, fan):
        return L.dense_init(gen, shape, dt, fan, device=dev)

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=dev)

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    mp, sp = (G, M), (G,)
    return {
        "embed": init((padded_vocab(cfg), d), d),
        "final_norm": ones((d,)),
        "mlstm": {
            "norm": ones(mp + (d,)),
            "w_up": init(mp + (d, di), d),
            "w_z": init(mp + (d, di), d),
            "w_q": init(mp + (di, nh, dh), di),
            "w_k": init(mp + (di, nh, dh), di),
            "w_v": init(mp + (di, nh, dh), di),
            "w_if": init(mp + (di, 2, nh), di),
            "b_if": zeros(mp + (2, nh)),
            "w_down": init(mp + (di, d), di),
        },
        "slstm": {
            "norm": ones(sp + (d,)),
            "w_gates": init(sp + (d, 4, nh, dh_s), d),
            "r_gates": init(sp + (4, nh, dh_s, dh_s), dh_s),
            "b_gates": zeros(sp + (4, nh, dh_s)),
            "w_down": init(sp + (d, d), d),
        },
    }


def xlstm_param_specs(cfg: ModelConfig) -> dict:
    """Logical-axis tree mirroring ``init_xlstm`` output."""
    m = {
        "norm": ("layers", "layers2", None),
        "w_up": ("layers", "layers2", "w_data", "heads"),
        "w_z": ("layers", "layers2", "w_data", "heads"),
        "w_q": ("layers", "layers2", "w_data", None, "head_dim"),
        "w_k": ("layers", "layers2", "w_data", None, "head_dim"),
        "w_v": ("layers", "layers2", "w_data", None, "head_dim"),
        "w_if": ("layers", "layers2", "w_data", None, None),
        "b_if": ("layers", "layers2", None, None),
        "w_down": ("layers", "layers2", "heads", "w_data"),
    }
    s = {
        "norm": ("layers", None),
        "w_gates": ("layers", "w_data", None, None, None),
        "r_gates": ("layers", None, None, None, None),
        "b_gates": ("layers", None, None, None),
        "w_down": ("layers", "w_data", None),
    }
    return {"embed": ("vocab", "embed_d"), "final_norm": (None,),
            "mlstm": m, "slstm": s}


# --------------------------------------------------------------------------
# mLSTM: parallel and chunked (training), kernel (prefill), recurrent (decode)
# --------------------------------------------------------------------------
def mlstm_parallel(q, k, v, i_gate, f_gate, *, scale: float | None = None,
                   round_scores: bool = False):
    """q/k/v: (B,S,nh,dh); i/f raw gate logits: (B,S,nh) -> h (B,S,nh,dh).

    D[t,s] = cumlogsig(f)[t] - cumlogsig(f)[s] + i[s]  (s <= t), stabilized
    per row; h = (exp(D - m) * (q k^T / sqrt(dh))) v / max(|row sum|, e^-m).
    ``scale`` replaces ``1 / sqrt(dh)`` when given.  The reference's model
    form keeps the gated scores float32 into the product with v;
    ``round_scores`` rounds them to v's type first, as the Pallas kernel
    does (the kernel's plain version, ``kernels/mlstm/ref.py``, is this
    function with that flag).  In f32 the two are the same function.
    """
    B, S, nh, dh = q.shape
    logf = F.logsigmoid(f_gate.float())                        # (B,S,nh)
    cum = torch.cumsum(logf, dim=1)
    ii = i_gate.float()
    D = cum[:, :, None, :] - cum[:, None, :, :] + ii[:, None, :, :]
    t_idx = torch.arange(S, device=q.device)
    causal = t_idx[:, None] >= t_idx[None, :]
    D = torch.where(causal[None, :, :, None], D, -torch.inf)   # (B,t,s,nh)
    m = torch.amax(D, dim=2, keepdim=True)                      # (B,t,1,nh)
    d_exp = torch.exp(D - m)
    scores = torch.einsum("bthd,bshd->btsh", q.float(), k.float())
    if scale is None:
        scale = dh ** -0.5
    scores = scores * scale * d_exp
    norm = torch.maximum(torch.abs(scores.sum(dim=2)),
                         torch.exp(-m[:, :, 0, :]))              # (B,t,nh)
    if round_scores:
        scores = scores.to(v.dtype).float()
    h = torch.einsum("btsh,bshd->bthd", scores, v.float())
    return (h / norm[..., None]).to(v.dtype)


def mlstm_chunked(q, k, v, i_gate, f_gate, *, chunk: int = 1024):
    """Blockwise mLSTM: the math of :func:`mlstm_parallel` without the
    (S, S) gating matrix, O(S * chunk) live memory (the reference's XLA
    twin of the kernel).  Query chunks in turn, each over the key chunks
    up to its own with a running (m, n, acc) in the xLSTM stabilized form.
    Falls back to the parallel form when ``chunk`` does not divide S or
    S <= chunk, as the reference does.  (The reference also folds the key
    chunks after the query chunk; they are fully masked, and folding one
    leaves m, n and acc exactly as they were, so they are skipped here.)
    """
    B, S, nh, dh = q.shape
    if S % chunk != 0 or S <= chunk:
        return mlstm_parallel(q, k, v, i_gate, f_gate)
    nc = S // chunk
    logf = F.logsigmoid(f_gate.float())
    cum = torch.cumsum(logf, dim=1)                          # (B,S,nh)
    ii = i_gate.float()
    scale = dh ** -0.5
    pos = torch.arange(S, dtype=torch.int32, device=q.device).reshape(
        nc, chunk)
    qc, kc, vc = (t.split(chunk, dim=1) for t in (q, k, v))
    Fc, ic = cum.split(chunk, dim=1), ii.split(chunk, dim=1)
    outs = []
    for a in range(nc):
        m = torch.full((B, chunk, nh), -torch.inf, device=q.device)
        n = torch.zeros((B, chunk, nh), device=q.device)
        acc = torch.zeros((B, chunk, nh, dh), device=q.device)
        for b in range(a + 1):
            d = Fc[a][:, :, None, :] - Fc[b][:, None, :, :] \
                + ic[b][:, None, :, :]                        # (B,cq,ck,nh)
            causal = pos[a][:, None] >= pos[b][None, :]
            d = torch.where(causal[None, :, :, None], d, -torch.inf)
            m_new = torch.maximum(m, torch.amax(d, dim=2))    # (B,cq,nh)
            m_safe = torch.clamp(m_new, min=-1e30)           # rows w/o keys
            gate = torch.exp(d - m_safe[:, :, None, :])
            s = torch.einsum("bthd,bshd->btsh", qc[a].float(),
                             kc[b].float()) * scale * gate
            corr = torch.exp(torch.clamp(m, min=-1e30) - m_safe)
            corr = torch.where(torch.isfinite(m), corr, 0.0)
            n = corr * n + torch.sum(s, dim=2)
            acc = corr[..., None] * acc + torch.einsum(
                "btsh,bshd->bthd", s, vc[b].float())
            m = m_new
        denom = torch.maximum(torch.abs(n), torch.exp(-m))
        outs.append((acc / denom[..., None]).to(v.dtype))
    return torch.cat(outs, dim=1)


def mlstm_step(state, q, k, v, i_gate, f_gate):
    """Recurrent mLSTM. state: C (B,nh,dh,dh), n (B,nh,dh), m (B,nh).
    q/k/v: (B,nh,dh); gates (B,nh). Returns (new_state, h (B,nh,dh))."""
    C, n, m = state
    dh = q.shape[-1]
    logf = F.logsigmoid(f_gate.float())
    ii = i_gate.float()
    m_new = torch.maximum(logf + m, ii)
    f_s = torch.exp(logf + m - m_new)[..., None]                # (B,nh,1)
    i_s = torch.exp(ii - m_new)[..., None]
    kf, vf, qf = k.float(), v.float(), q.float()
    C = f_s[..., None] * C + i_s[..., None] * kf[..., :, None] * vf[..., None, :]
    n = f_s * n + i_s * kf
    qs = qf * (dh ** -0.5)
    num = torch.einsum("bhd,bhde->bhe", qs, C)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qs, n)),
                        torch.exp(-m_new))
    h = num / den[..., None]
    return (C, n, m_new), h.to(v.dtype)


def _mlstm_inputs(x, p):
    """Pre-norm projections of an mLSTM block: z, q, k, v, i, f."""
    h = L.rmsnorm(x, p["norm"])
    up = sh.matmul(h, p["w_up"])
    z = sh.matmul(h, p["w_z"])
    q = sh.einsum("bse,ehd->bshd", up, p["w_q"])
    k = sh.einsum("bse,ehd->bshd", up, p["w_k"])
    v = sh.einsum("bse,ehd->bshd", up, p["w_v"])
    gates = sh.einsum("bse,egh->bsgh", up, p["w_if"]) + p["b_if"]
    return z, q, k, v, gates[:, :, 0], gates[:, :, 1]            # (B,S,nh)


def _mlstm_out(x, hh, z, p, di):
    out = hh.reshape(hh.shape[0], hh.shape[1], di) * F.silu(z)
    return L.carry(x + sh.matmul(out, p["w_down"]))


#: prefill routes that run the mLSTM's plain version
PLAIN_ROUTES = ("plain", "chunked", "einsum")


def _mlstm_seq(q, k, v, i_g, f_g, impl: str):
    """The prefill mLSTM by route: the kernel, or its plain version for
    ``"plain"`` and for the attention routes the other families take
    (``"chunked"``, ``"einsum"``), which have no mLSTM of their own."""
    if impl == "kernel":
        return mlstm_ops.mlstm(q, k, v, i_g, f_g)
    if impl in PLAIN_ROUTES:
        return mlstm_ref.mlstm_parallel(q, k, v, i_g, f_g)
    raise ValueError(f"mlstm impl {impl!r} not in "
                     f"{('kernel',) + PLAIN_ROUTES}")


#: on a device mesh the mLSTM's and sLSTM's recurrences run on each
#: device's batch rows and heads (DTensor has no rule for their
#: log-sigmoids and cumulative sums): q/k/v (B,S,nh,dh) and gates
#: (B,S,nh); the mLSTM state C (B,nh,dh,dh), n (B,nh,dh), m (B,nh) and a
#: step's (B,nh,dh) / (B,nh) inputs
HEADS = ("batch", None, "heads", None)
SEQ_AXES = (HEADS,) * 3 + (("batch", None, "heads"),) * 2
STATE_AXES = (("batch", "heads", None, None), ("batch", "heads", None),
              ("batch", "heads"))
STEP_AXES = (("batch", "heads", None),) * 3 + (("batch", "heads"),) * 2


def mlstm_block(x, p, cfg, *, state=None):
    """Pre-norm residual mLSTM block. ``state`` triggers the recurrent path
    (decode, S==1); without it the whole sequence runs through
    :func:`mlstm_chunked` (training).  Returns (out, new_state)."""
    d, di, nh, dh = _dims(cfg)
    z, q, k, v, i_g, f_g = _mlstm_inputs(x, p)
    if state is None:
        hh = sh.local_map(mlstm_chunked, SEQ_AXES, HEADS)(q, k, v, i_g, f_g)
        new_state = None
    else:
        step = sh.local_map(
            lambda C, n, m, q, k, v, i, f: mlstm_step((C, n, m), q, k, v, i,
                                                      f),
            STATE_AXES + STEP_AXES, (STATE_AXES, STEP_AXES[0]))
        new_state, h1 = step(*state, q[:, 0], k[:, 0], v[:, 0], i_g[:, 0],
                             f_g[:, 0])
        hh = h1[:, None]
    return _mlstm_out(x, hh, z, p, di), new_state


def mlstm_final_state(q, k, v, i_gate, f_gate):
    """Final recurrent state (C, n, m) equivalent to stepping through the
    sequence -- closed form from the parallel quantities (prefill->decode
    handoff)."""
    logf = F.logsigmoid(f_gate.float())
    cum = torch.cumsum(logf, dim=1)                      # (B,S,nh)
    ii = i_gate.float()
    w = cum[:, -1:, :] - cum + ii                        # (B,S,nh)
    m = torch.amax(w, dim=1)                             # (B,nh)
    wexp = torch.exp(w - m[:, None, :])
    kf, vf = k.float(), v.float()
    C = torch.einsum("bshd,bshe->bhde", wexp[..., None] * kf, vf)
    n = torch.einsum("bsh,bshd->bhd", wexp, kf)
    return C, n, m


# --------------------------------------------------------------------------
# sLSTM: sequential (prefill) + single step (decode)
# --------------------------------------------------------------------------
def _slstm_cell(carry, gz, r):
    """carry: (c, n, m, h_prev) each (B,nh,dh); gz: pre-activations
    (B,4,nh,dh) BEFORE adding recurrence; r: (4,nh,dh,dh)."""
    c, n, m, h_prev = carry
    rec = torch.einsum("bhd,ghde->bghe", h_prev, r)
    zi, zf, zz, zo = [gz[:, j] + rec[:, j] for j in range(4)]
    log_i = zi.float()
    log_f = F.logsigmoid(zf.float())
    m_new = torch.maximum(log_f + m, log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + m - m_new)
    zt = torch.tanh(zz.float())
    ot = torch.sigmoid(zo.float())
    c_new = f_s * c + i_s * zt
    n_new = f_s * n + i_s
    h = (ot * c_new / torch.clamp(n_new, min=1e-6)).to(gz.dtype)
    return (c_new, n_new, m_new, h), h


def _slstm_zero_state(B, nh, dh, dtype, device):
    z0 = torch.zeros((B, nh, dh), dtype=torch.float32, device=device)
    return (z0, z0, torch.full((B, nh, dh), -torch.inf, device=device),
            z0.to(dtype))


def slstm_block(x, p, cfg, *, state=None):
    """Sequential sLSTM over time. state (decode): (c, n, m, h_prev).
    Returns (out, final state)."""
    B, S, d = x.shape
    nh = cfg.num_heads
    dh = d // nh
    h_in = L.rmsnorm(x, p["norm"])
    gz = sh.einsum("bsd,dghe->bsghe", h_in, p["w_gates"]) + p["b_gates"]

    def scan(gz, r, *state):
        carry = (tuple(state) if state[0] is not None else
                 _slstm_zero_state(gz.shape[0], gz.shape[3], dh, x.dtype,
                                   gz.device))
        hs = []
        for t in cost.steps(S):
            carry, h = _slstm_cell(carry, gz[:, t], r)
            hs.append(h)
        return cost.stack_steps(hs, S, dim=1), carry

    cell = ("batch", "heads", None)
    out, carry = sh.local_map(
        scan, (("batch", None, None, "heads", None),
               (None, "heads", None, None)) + (cell,) * 4,
        (HEADS, (cell,) * 4))(gz, p["r_gates"],
                              *(state if state is not None else [None] * 4))
    return L.carry(x + sh.matmul(out.reshape(B, S, d), p["w_down"])), carry


# --------------------------------------------------------------------------
# Full model: training forward and loss
# --------------------------------------------------------------------------
def _group_params(params: dict, g: int, m: int | None = None) -> dict:
    if m is None:
        return {k: w[g] for k, w in params["slstm"].items()}
    return {k: w[g, m] for k, w in params["mlstm"].items()}


def xlstm_hidden(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                 remat_policy: str = "dots") -> torch.Tensor:
    """tokens (B,S) -> final-normed hidden (B,S,D).  A ``remat_policy``
    other than ``"none"`` wraps each group (its mLSTM layers and its
    sLSTM) in ``torch.utils.checkpoint`` (non-reentrant), as the reference
    wraps its group body in ``jax.checkpoint``; values are the same."""
    G, M = _groups(cfg)
    x = constraint(L.embed_tokens(params["embed"], tokens),
                   "batch", "act_seq", None)
    mlayers = L.unstack_layers(params["mlstm"], 2)
    slayers = L.unstack_layers(params["slstm"], 1)

    def group_body(h, g):
        for lp in mlayers[g * M:(g + 1) * M]:
            h, _ = mlstm_block(h, gather_weights(lp), cfg)
        h, _ = slstm_block(h, gather_weights(slayers[g]), cfg)
        return h

    for g in range(G):
        if remat_policy == "none":
            x = group_body(x, g)
        else:
            x = torch.utils.checkpoint.checkpoint(group_body, x, g,
                                                  use_reentrant=False)
    return L.rmsnorm(x, params["final_norm"])


def xlstm_loss(cfg: ModelConfig, params: dict, batch: dict, *,
               remat_policy: str = "dots", **_) -> torch.Tensor:
    """Mean next-token NLL, tied-embedding logits in float32."""
    hidden = xlstm_hidden(cfg, params, batch["tokens"], remat_policy)
    logits = sh.matmul(hidden.float(),
                       sh.gather_weights(params["embed"]).float().T)
    return L.cross_entropy(logits, batch["labels"])


# --------------------------------------------------------------------------
# Serving state: prefill + decode
# --------------------------------------------------------------------------


def init_xlstm_state(cfg: ModelConfig, batch: int,
                     device: _device.DeviceLike | None = None) -> dict:
    """Recurrent decode state (no KV cache -- O(1) in context length)."""
    dev = _device.resolve(device)
    d, di, nh, dh = _dims(cfg)
    dh_s = d // nh
    G, M = _groups(cfg)
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "m_C": torch.zeros((G, M, batch, nh, dh, dh), **f32),
        "m_n": torch.zeros((G, M, batch, nh, dh), **f32),
        "m_m": torch.zeros((G, M, batch, nh), **f32),
        "s_c": torch.zeros((G, batch, nh, dh_s), **f32),
        "s_n": torch.zeros((G, batch, nh, dh_s), **f32),
        "s_m": torch.full((G, batch, nh, dh_s), -torch.inf, **f32),
        "s_h": torch.zeros((G, batch, nh, dh_s),
                           dtype=getattr(torch, cfg.dtype), device=dev),
        "pos": 0,
    }


def xlstm_state_specs(cfg: ModelConfig) -> dict:
    return {"m_C": ("layers", "layers2", "batch", None, None, None),
            "m_n": ("layers", "layers2", "batch", None, None),
            "m_m": ("layers", "layers2", "batch", None),
            "s_c": ("layers", "batch", None, None),
            "s_n": ("layers", "batch", None, None),
            "s_m": ("layers", "batch", None, None),
            "s_h": ("layers", "batch", None, None),
            "pos": ()}


def xlstm_prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
                  impl: str = "kernel"):
    """Process the prompt in parallel, returning last-token logits plus the
    recurrent state ready for decode.  ``impl`` routes the mLSTM through
    the kernel (``"kernel"``) or its plain version (``"plain"``, and the
    other families' attention routes ``"chunked"`` and ``"einsum"``: the
    reference's prefill takes no route)."""
    d, di, nh, dh = _dims(cfg)
    G, M = _groups(cfg)
    x = constraint(L.embed_tokens(params["embed"], tokens),
                   "batch", "act_seq", None)
    states = {k: [] for k in ("m_C", "m_n", "m_m", "s_c", "s_n", "s_m",
                              "s_h")}
    for g in range(G):
        mC, mn, mm = [], [], []
        for m in range(M):
            lp = gather_weights(_group_params(params, g, m))
            z, q, k, v, i_g, f_g = _mlstm_inputs(x, lp)
            hh = sh.local_map(lambda *a: _mlstm_seq(*a, impl), SEQ_AXES,
                              HEADS)(q, k, v, i_g, f_g)
            C, n, mx = sh.local_map(mlstm_final_state, SEQ_AXES,
                                    STATE_AXES)(q, k, v, i_g, f_g)
            x = _mlstm_out(x, hh, z, lp, di)
            mC.append(C)
            mn.append(n)
            mm.append(mx)
        x, (sc, sn, sm, s_h) = slstm_block(
            x, gather_weights(_group_params(params, g)), cfg)
        for key, val in zip(("m_C", "m_n", "m_m"), (mC, mn, mm)):
            states[key].append(torch.stack(val))
        for key, val in zip(("s_c", "s_n", "s_m", "s_h"), (sc, sn, sm, s_h)):
            states[key].append(val)
    x = L.rmsnorm(x, params["final_norm"])
    logits = sh.matmul(x[:, -1].float(),
                       sh.gather_weights(params["embed"]).float().T)
    state = {k: torch.stack(v) for k, v in states.items()}
    state["pos"] = tokens.shape[1]
    return logits, state


def xlstm_decode(cfg: ModelConfig, params: dict, state: dict,
                 tokens: torch.Tensor):
    """One decode step: tokens (B,1) -> (logits (B,V), new state)."""
    G, M = _groups(cfg)
    x = L.embed_tokens(params["embed"], tokens)
    new = {k: [] for k in ("m_C", "m_n", "m_m", "s_c", "s_n", "s_m", "s_h")}
    for g in range(G):
        mC, mn, mm = [], [], []
        for m in range(M):
            x, (C, n, mx) = mlstm_block(
                x, gather_weights(_group_params(params, g, m)), cfg,
                state=(state["m_C"][g, m], state["m_n"][g, m],
                       state["m_m"][g, m]))
            mC.append(C)
            mn.append(n)
            mm.append(mx)
        x, (sc, sn, sm, s_h) = slstm_block(
            x, gather_weights(_group_params(params, g)), cfg,
            state=(state["s_c"][g], state["s_n"][g], state["s_m"][g],
                   state["s_h"][g]))
        for key, val in zip(("m_C", "m_n", "m_m"), (mC, mn, mm)):
            new[key].append(torch.stack(val))
        for key, val in zip(("s_c", "s_n", "s_m", "s_h"), (sc, sn, sm, s_h)):
            new[key].append(val)
    x = L.rmsnorm(x, params["final_norm"])
    logits = sh.matmul(x.float(),
                       sh.gather_weights(params["embed"]).float().T)
    new_state = {k: torch.stack(v) for k, v in new.items()}
    new_state["pos"] = state["pos"] + 1
    return logits[:, 0], new_state

"""Mamba-2 mixer — state-space duality (SSD) [arXiv:2405.21060].

Port of :mod:`repro.models.ssm`.  The full-sequence form is the chunked
SSD algorithm: an attention-like quadratic term inside each chunk, and the
recurrence between chunks, which the reference runs as a ``lax.scan``
(``ssd_chunked`` ``:121-139``) and the port runs through the ``ssd_scan``
op: the hand-written CUDA kernel on the card, its plain version on the
CPU.  Decode is the O(1) recurrent update.  The sharding annotations of
the reference have no counterpart on one card and are dropped.

Layout (n_groups = 1), as in the reference:
  x       (B, S, H, P)     H = ssm_heads, P = ssm_head_dim
  dt      (B, S, H)        softplus(raw + dt_bias)
  A       (H,)             -exp(A_log)
  B, C    (B, S, N)        N = ssm_state (shared across heads, g=1)
  state   (B, H, P, N)

Numerics follow the reference: the SSD core and the convolution run in
float32, and ``proj``, ``y`` and the gated ``y`` are rounded to the compute
dtype at the reference's places.  Two differences, neither visible beyond
float32 rounding: ``F.softplus`` returns ``x`` above 20 where
``jax.nn.softplus`` is ``logaddexp(x, 0)`` (they differ by less than
2e-9 there), and the conv is the reference's sum of K shifted products
(no cuDNN convolution, which would run float32 in TF32 on the card).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ops import ssd_scan_op
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, linear

__all__ = [
    "ssm_params",
    "ssm_forward",
    "ssm_decode_step",
    "init_ssm_state",
    "ssd_chunked",
    "ssd_reference",
]


def _dims(cfg: ModelConfig):
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    d_inner = H * P
    d_conv_ch = d_inner + 2 * N  # conv runs over (x, B, C) channels
    return H, P, N, d_inner, d_conv_ch


def ssm_params(gen: torch.Generator, cfg: ModelConfig, device,
               lead: tuple = ()) -> dict:
    """Mixer weights drawn from ``gen`` on ``device``, stacked along
    ``lead`` (the layer axis): the reference's keys, shapes and scales.
    ``A_log``, ``D`` and ``dt_bias`` are float32 whatever ``param_dtype``
    is, as in the reference."""
    d = cfg.d_model
    H, P, N, d_inner, d_conv_ch = _dims(cfg)
    # in_proj emits [z (d_inner), x (d_inner), B (N), C (N), dt (H)]
    out_dim = 2 * d_inner + 2 * N + H
    f32 = torch.float32
    in_proj = dense_init(gen, d, out_dim, cfg.pdtype, device, lead=lead)
    conv_w = torch.randn(lead + (cfg.ssm_conv, d_conv_ch), generator=gen, device=device)
    conv_w = conv_w.div_(math.sqrt(cfg.ssm_conv)).to(cfg.pdtype)
    out_proj = dense_init(gen, d_inner, d, cfg.pdtype, device, lead=lead)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=f32, device=device))
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros(lead + (d_conv_ch,), dtype=cfg.pdtype, device=device),
        "A_log": a_log.expand(lead + (H,)).clone(),
        "D": torch.ones(lead + (H,), dtype=f32, device=device),
        "dt_bias": torch.zeros(lead + (H,), dtype=f32, device=device),
        "norm_w": torch.ones(lead + (d_inner,), dtype=cfg.pdtype, device=device),
        "out_proj": out_proj,
    }


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """segsum(dA)[..., i, j] = sum_{j<k<=i} dA[..., k]  (lower-triangular,
    -inf above the diagonal).  dA: (..., Q) → (..., Q, Q)."""
    Q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    upper = torch.ones((Q, Q), dtype=torch.bool, device=dA.device).triu_(1)
    return diff.masked_fill_(upper, float("-inf"))


def ssd_chunked(x, dt, A, B, C, chunk: int, initial_state=None):
    """Chunked SSD (Mamba-2 Listing 1 with g=1 shared B/C).

    x: (b,l,h,p)  dt: (b,l,h)  A: (h,)  B,C: (b,l,n)
    Returns y: (b,l,h,p) float32, final_state: (b,h,p,n) float32.

    The recurrence between chunks goes through the ``ssd_scan`` op on every
    call (one chunk included), so a prefill launches the kernel once per
    layer.  The large (b,c,h,Q,Q) float32 intermediates are updated in
    place where the reference builds new arrays.
    """
    b, l, h, p = x.shape
    n = B.shape[-1]
    Q = min(chunk, l) if l < chunk else chunk
    pad = (-l) % Q
    if pad:
        # dt=0 padding is exact: decay exp(0)=1, update dt·x = 0.
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    l_pad = l + pad
    c = l_pad // Q

    f32 = torch.float32
    xc = x.reshape(b, c, Q, h, p).to(f32)
    dtc = dt.reshape(b, c, Q, h).to(f32)
    Bc = B.reshape(b, c, Q, n).to(f32)
    Cc = C.reshape(b, c, Q, n).to(f32)
    del x, dt, B, C
    dA = dtc * A[None, None, None, :]  # (b,c,Q,h)
    dA_h = dA.movedim(-1, 2)  # (b,c,h,Q)
    dA_cs = torch.cumsum(dA_h, dim=-1)  # (b,c,h,Q)

    # ---- intra-chunk (diagonal blocks): attention-like quadratic term ----
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)  # (b,c,Q,Q)
    scores = _segsum(dA_h).exp_().mul_(CB[:, :, None])  # L * CB, (b,c,h,i,j)
    sx = xc * dtc[..., None]  # dt-weighted input
    y_diag = torch.einsum("bchij,bcjhp->bcihp", scores, sx)
    del scores

    # ---- chunk states -----------------------------------------------------
    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)  # (b,c,h,Q)
    states = torch.einsum("bcqn,bchq,bcqhp->bchpn", Bc, decay_states, sx)

    # ---- inter-chunk recurrence: the ssd_scan kernel ----------------------
    chunk_decay = torch.exp(dA_cs[..., -1])  # (b,c,h)
    prev_states, final_state = ssd_scan_op(states, chunk_decay, initial_state)

    # ---- off-diagonal contribution from carried-in states ------------------
    state_decay = torch.exp(dA_cs)  # (b,c,h,Q)
    y_off = torch.einsum("bcqn,bchpn,bchq->bcqhp", Cc, prev_states, state_decay)

    y = (y_diag + y_off).reshape(b, l_pad, h, p)[:, :l]
    return y, final_state


def ssd_reference(x, dt, A, B, C, initial_state=None):
    """O(S·N·P) sequential oracle for tests: the plain recurrence."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    f32 = torch.float32
    state = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if initial_state is None else initial_state.to(f32))
    xs, dts, Bs, Cs = (t.to(f32) for t in (x, dt, B, C))
    ys = []
    for t in range(l):
        dA = torch.exp(dts[:, t] * A)  # (b,h)
        upd = dts[:, t, :, None, None] * xs[:, t, ..., None] * Bs[:, t, None, None, :]
        state = state * dA[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cs[:, t]))
    return torch.stack(ys, dim=1), state


# ---------------------------------------------------------------------------
# full mixer (proj → causal depthwise conv → SSD → gate → out)
# ---------------------------------------------------------------------------


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    H, P, N, d_inner, _ = _dims(cfg)
    return torch.split(proj, [d_inner, d_inner, N, N, H], dim=-1)


def _causal_conv(seq: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """seq: (B, S, Ch); depthwise causal conv, kernel (K, Ch): the
    reference's sum of K shifted products."""
    K = w.shape[0]
    S = seq.shape[1]
    pad = F.pad(seq, (0, 0, K - 1, 0))
    out = sum(pad[:, i: i + S, :] * w[i][None, None, :] for i in range(K))
    return out + b[None, None, :]


def _gate_norm_out(p: dict, cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor):
    """Gate with silu(z), mamba2's RMSNorm before the out projection, and
    the out projection; y: (B, S, d_inner) in the compute dtype."""
    cd = cfg.cdtype
    y = y * F.silu(z.float()).to(cd)
    yf = y.float()
    y = (yf * torch.rsqrt(torch.mean(yf * yf, -1, keepdim=True) + 1e-6)
         * p["norm_w"].float()).to(cd)
    return linear(y, p["out_proj"], compute_dtype=cd)


def ssm_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                initial_state: Optional[torch.Tensor] = None,
                return_state: bool = False):
    """Full-sequence mamba2 mixer.  x: (B,S,d) → (B,S,d); with
    ``return_state`` also ``{"ssm": final state (B,H,P,N) float32, "conv":
    the last K-1 conv inputs (B,K-1,Ch), left-padded with zeros when
    S < K-1}``, from which decode continues exactly.  The state runs over
    every position of ``x``, pad positions of a right-padded batch
    included, as in the reference."""
    cd = cfg.cdtype
    H, P, N, d_inner, _ = _dims(cfg)
    Bsz, S, _ = x.shape
    proj = linear(x, p["in_proj"], compute_dtype=cd)
    z, xin, Bm, Cm, dt_raw = _split_proj(cfg, proj)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in.float(), p["conv_w"].float(),
                                   p["conv_b"].float()))
    xin = conv_out[..., :d_inner]
    Bm = conv_out[..., d_inner: d_inner + N]
    Cm = conv_out[..., d_inner + N:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(Bsz, S, H, P)
    if return_state:
        K = cfg.ssm_conv
        tail = conv_in[:, -(K - 1):].to(cd)
        if tail.shape[1] < K - 1:
            tail = F.pad(tail, (0, 0, K - 1 - tail.shape[1], 0))
    y, final_state = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk,
                                 initial_state=initial_state)
    y = y + p["D"][None, None, :, None] * xh
    out = _gate_norm_out(p, cfg, y.reshape(Bsz, S, d_inner).to(cd), z)
    if return_state:
        return out, {"ssm": final_state, "conv": tail}
    return out


def init_ssm_state(cfg: ModelConfig, batch: int, n_layers: Optional[int] = None,
                   device="cpu") -> dict:
    """Zero decode state: ``ssm`` (L, B, H, P, N) float32 and ``conv``
    (L, B, K-1, Ch) in the compute dtype."""
    H, P, N, _d_inner, d_conv_ch = _dims(cfg)
    L = n_layers if n_layers is not None else cfg.n_layers
    return {
        "ssm": torch.zeros((L, batch, H, P, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((L, batch, cfg.ssm_conv - 1, d_conv_ch), dtype=cfg.cdtype,
                            device=device),
    }


def ssm_decode_step(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    ssm_state: torch.Tensor, conv_state: torch.Tensor):
    """One-token recurrent update.  x: (B,1,d); ssm_state (B,H,P,N)
    float32; conv_state (B,K-1,Ch).  Returns (y, new_ssm_state,
    new_conv_state), new tensors (the caller writes them back)."""
    cd = cfg.cdtype
    H, P, N, d_inner, _ = _dims(cfg)
    Bsz = x.shape[0]
    proj = linear(x, p["in_proj"], compute_dtype=cd)
    z, xin, Bm, Cm, dt_raw = _split_proj(cfg, proj)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)[:, 0]  # (B, Ch)
    window = torch.cat([conv_state, conv_in[:, None, :]], dim=1)  # (B,K,Ch)
    new_conv_state = window[:, 1:]
    w = p["conv_w"].float()
    conv_out = F.silu((window.float() * w[None]).sum(1) + p["conv_b"].float())
    xin = conv_out[:, :d_inner].reshape(Bsz, H, P)
    Bm = conv_out[:, d_inner: d_inner + N]
    Cm = conv_out[:, d_inner + N:]
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"][None, :])
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A[None, :])  # (B,H)
    upd = dt[..., None, None] * xin[..., None] * Bm[:, None, None, :]
    new_state = ssm_state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, Cm)
    y = y + p["D"][None, :, None] * xin
    out = _gate_norm_out(p, cfg, y.reshape(Bsz, 1, d_inner).to(cd), z)
    return out, new_state, new_conv_state

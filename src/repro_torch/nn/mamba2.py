"""Mamba-2 (SSD, state-space duality) block: chunked train / prefill and an
O(1)-per-token decode step, the JAX package's nn/mamba2.py step for step.

The blocked SSD algorithm: the sequence is cut into chunks of length Q;
inside a chunk the quadratic (dual) form runs as matrix products, across
chunks a loop carries the (heads, head_dim, d_state) recurrent state.
Layout: in_proj -> [z | x | B | C | dt], a depthwise causal conv over
[x | B | C], softplus(dt) + bias, a negative A per head, the skip D, a gated
RMSNorm and out_proj. The scan runs in f32 where the reference's does.

One departure (D3): the reference requires the length to be a multiple of
the chunk once it exceeds one chunk. Here a ragged tail is padded to a whole
chunk with xdt = 0, dA = 0 and B = C = 0 and the padded rows are dropped:
they come after every real row, add nothing to the state and do not decay
it, so where the reference runs this computes what it computes.

Memory: the einsums contract pairwise in a stated order. The widest
intermediates are the (b, chunks, q, q, heads) decay and C.B tiles (64 MB
f32 at chunk 256, 64 heads, 1,024 tokens), never a (b, chunks, q, q,
heads, d_state) product (~8.6 GB there).

Under a serving mesh whose model axis divides the heads, a rank holds its
contiguous share of them (z, x, dt and their conv channels, dt_bias,
a_log, d_skip, norm_w, out_proj's rows; B and C whole unless the axis
divides the groups), its SSM state theirs, and the block reads its sizes
from its parameters (_dims): the norm's statistic and out_proj's partials
are summed over the model group (_norm_out).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.nn import shard_ctx
from repro_torch.nn.common import init_param, rmsnorm


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


class SSMState(NamedTuple):
    conv: torch.Tensor    # (b, conv_width - 1, conv_dim) last conv inputs
    ssm: torch.Tensor     # (b, heads, head_dim, d_state) f32 state


def init_mamba2(d_model: int, cfg: SSMConfig, gen: torch.Generator, *,
                device, dtype) -> dict:
    di = cfg.d_inner(d_model)
    h = cfg.n_heads(d_model)
    g, n = cfg.n_groups, cfg.d_state
    conv_dim = di + 2 * g * n
    kw = dict(device=device, dtype=dtype)
    return {
        # in_proj emits [z(di) | x(di) | B(g*n) | C(g*n) | dt(h)]
        "in_proj": init_param((d_model, 2 * di + 2 * g * n + h), gen, **kw),
        "conv_w": init_param((cfg.conv_width, conv_dim), gen, **kw),
        "conv_b": init_param((conv_dim,), None, init="zeros", **kw),
        "dt_bias": init_param((h,), None, init="zeros", **kw),
        "a_log": init_param((h,), None, init="zeros", **kw),
        "d_skip": init_param((h,), None, init="ones", **kw),
        "norm_w": init_param((di,), None, init="zeros", **kw),
        "out_proj": init_param((di, d_model), gen, **kw),
    }


def _dims(params, cfg: SSMConfig) -> Tuple[int, int, int, int]:
    """(d_inner, groups, d_state, heads) of the block `params` hold: the
    config's, or under a serving mesh this rank's share of the heads (and
    of the groups where the mesh splits them; serve/sharding.py)."""
    n = cfg.d_state
    h = params["dt_bias"].shape[0]
    di = h * cfg.head_dim
    return di, (params["conv_b"].shape[0] - di) // (2 * n), n, h


def _split_proj(proj, params, cfg: SSMConfig):
    di, g, n, h = _dims(params, cfg)
    z, xbc, dt = torch.split(proj, [di, di + 2 * g * n, h], dim=-1)
    return z, xbc, dt, (di, g, n, h)


def _norm_out(params, y, d_model: int, cfg: SSMConfig):
    """The gated RMSNorm over d_inner, then out_proj. Where the block holds
    a model-axis share of the heads, the norm's sum of squares is summed
    over the model group (one f32 collective) and out_proj's partials are
    reduced (shard_ctx.reduce_model)."""
    di = cfg.d_inner(d_model)
    if y.shape[-1] == di:
        return rmsnorm(y, params["norm_w"]) @ params["out_proj"]
    yf = y.float()
    var = shard_ctx.sum_model(yf.square().sum(-1, keepdim=True)) / di
    yn = (yf * torch.rsqrt(var + 1e-6)
          * (1.0 + params["norm_w"].float())).to(y.dtype)
    return shard_ctx.reduce_model(
        shard_ctx.row_partial(yn, params["out_proj"])).to(y.dtype)


def _causal_conv(xbc, w, b, init_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv in xbc's dtype; returns (silu(out + b), the
    last W - 1 inputs as the new conv state)."""
    width = w.shape[0]
    if init_state is None:
        pad = xbc.new_zeros((xbc.shape[0], width - 1, xbc.shape[2]))
    else:
        pad = init_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    n = xp.shape[1]
    out = sum(xp[:, i:n - (width - 1 - i)] * w[i] for i in range(width))
    return F.silu(out + b), xp[:, n - (width - 1):]


def ssd_chunked(xdt, dA, B, C, init_state=None, chunk: int = 256):
    """Blocked SSD. xdt (b, l, h, p) [dt-scaled], dA (b, l, h) [dt * A <=
    0], B, C (b, l, g, n). Returns (y (b, l, h, p), final state (b, h, p,
    n)), both f32. A length past `chunk` that is not a multiple of it is
    padded to one (D3, see the module note)."""
    b, l, h, p = xdt.shape
    g, n = B.shape[2], B.shape[3]
    q = min(chunk, l)
    pad = -l % q
    if pad:
        xdt, dA, B, C = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                         for t in (xdt, dA, B, C))
    nc = (l + pad) // q
    hg = h // g

    xc = xdt.float().reshape(b, nc, q, h, p)
    cum = torch.cumsum(dA.float().reshape(b, nc, q, h), dim=2)     # (b,c,q,h)
    total = cum[:, :, -1]                                          # (b,c,h)
    Bh = B.float().reshape(b, nc, q, g, n).repeat_interleave(hg, dim=3)
    Ch = C.float().reshape(b, nc, q, g, n).repeat_interleave(hg, dim=3)

    # intra-chunk: y_diag = ((C B^T) * L) x, with the decay L[q, k] =
    # exp(cum_q - cum_k) for q >= k, contracted as (C B^T) first, then the
    # masked product with L, then x
    mask = torch.tril(torch.ones(q, q, dtype=torch.bool, device=xc.device))
    L = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])   # (b,c,q,k,h)
    L = L.masked_fill_(~mask[None, None, :, :, None], 0.0)
    cb = torch.einsum("bcqhn,bckhn->bcqkh", Ch, Bh)
    y = torch.einsum("bcqkh,bckhp->bcqhp", cb.mul_(L), xc)
    del cb, L

    # each chunk's input -> its end state, decayed to the chunk's end
    decay_to_end = torch.exp(total[:, :, None, :] - cum)           # (b,c,q,h)
    chunk_states = torch.einsum("bckhn,bckhp->bchpn", Bh,
                                xc * decay_to_end[..., None])

    state = (xc.new_zeros((b, h, p, n)) if init_state is None
             else init_state.float())
    states_in = []
    for c in range(nc):
        states_in.append(state)                    # the state entering c
        state = state * torch.exp(total[:, c])[:, :, None, None] \
            + chunk_states[:, c]
    states_in = torch.stack(states_in, dim=1)      # (b,c,h,p,n)

    # inter-chunk: C . (state entering the chunk), decayed to the row
    y_off = torch.einsum("bcqhn,bchpn->bcqhp", Ch, states_in)
    y = y + y_off * torch.exp(cum)[..., None]
    return y.reshape(b, nc * q, h, p)[:, :l], state


def apply_mamba2(params, x: torch.Tensor, d_model: int, cfg: SSMConfig,
                 gate_act: Callable = F.silu,
                 state: Optional[SSMState] = None
                 ) -> Tuple[torch.Tensor, SSMState]:
    """The block over a sequence, x (b, l, d_model) -> (out, the state
    after the last row)."""
    b, l, _ = x.shape
    proj = x @ params["in_proj"]
    z, xbc, dt, (di, g, n, h) = _split_proj(proj, params, cfg)
    p = cfg.head_dim
    conv_in = None if state is None else state.conv
    xbc, conv_state = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                   conv_in)
    xs, B, C = torch.split(xbc, [di, g * n, g * n], dim=-1)
    xs = xs.reshape(b, l, h, p)
    B = B.reshape(b, l, g, n)
    C = C.reshape(b, l, g, n)

    dt = F.softplus(dt.float() + params["dt_bias"].float())       # (b,l,h)
    A = -torch.exp(params["a_log"].float())                         # (h,)
    xdt = xs.float() * dt[..., None]
    dA = dt * A

    ssm_in = None if state is None else state.ssm
    y, ssm_state = ssd_chunked(xdt, dA, B, C, init_state=ssm_in,
                               chunk=cfg.chunk)
    y = y + xs.float() * params["d_skip"].float()[None, None, :, None]
    y = y.reshape(b, l, di).to(x.dtype)
    y = y * gate_act(z)
    return _norm_out(params, y, d_model, cfg), SSMState(conv_state,
                                                        ssm_state)


def decode_mamba2(params, x: torch.Tensor, d_model: int, cfg: SSMConfig,
                  state: SSMState, gate_act: Callable = F.silu
                  ) -> Tuple[torch.Tensor, SSMState]:
    """One recurrent step, x (b, 1, d_model); the state is updated in
    place and returned."""
    b = x.shape[0]
    proj = x[:, 0] @ params["in_proj"]
    z, xbc, dt, (di, g, n, h) = _split_proj(proj, params, cfg)
    p = cfg.head_dim
    w = params["conv_w"]

    # rolling conv buffer: state.conv holds the last W - 1 inputs
    buf = torch.cat([state.conv, xbc[:, None].to(state.conv.dtype)], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", buf.float(), w.float())
    xbc1 = F.silu(conv_out + params["conv_b"].float()).to(x.dtype)

    xs, B, C = torch.split(xbc1, [di, g * n, g * n], dim=-1)
    xs = xs.reshape(b, h, p)
    B = B.reshape(b, g, n).repeat_interleave(h // g, dim=1)      # (b,h,n)
    C = C.reshape(b, g, n).repeat_interleave(h // g, dim=1)

    dt = F.softplus(dt.float() + params["dt_bias"].float())       # (b,h)
    A = -torch.exp(params["a_log"].float())
    decay = torch.exp(dt * A)
    upd = (dt[..., None] * xs.float())[..., None] * B.float()[:, :, None, :]
    new_ssm = state.ssm * decay[:, :, None, None] + upd           # (b,h,p,n)

    y = torch.einsum("bhpn,bhn->bhp", new_ssm, C.float())
    y = y + xs.float() * params["d_skip"].float()[None, :, None]
    y = y.reshape(b, di).to(x.dtype)
    y = y * gate_act(z)
    state.conv.copy_(buf[:, 1:])
    state.ssm.copy_(new_ssm)
    return _norm_out(params, y, d_model, cfg)[:, None], state

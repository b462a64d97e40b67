"""Plain torch versions of the RWKV-6 WKV recurrence.

`wkv_chunked_ref` is the chunked form of `repro.models.rwkv6.wkv_chunked`,
which is what the JAX prefill computes: the CPU path of `ops.wkv`, and
what `chip_smoke.py` holds the CUDA kernel against. `wkv_seq_ref` is the
token-by-token oracle of `repro.kernels.rwkv6.ref.wkv_ref`, for the tests.

Per (batch, head), with a D x D state S:

    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t,        w_t = exp(logw_t)
"""
from __future__ import annotations

import torch


def wkv_chunked_ref(r, k, v, logw, u, h0, chunk: int = 16):
    """r,k,v,logw (B,S,H,D); u (H,D); h0 (B,H,D,D) -> (out (B,S,H,D),
    hT (B,H,D,D)), both float32. (JAX's `wkv_chunked` casts `out` to
    r's dtype; the model does that after the call, as it does after the
    kernel, whose output is float32 like the Pallas kernel's.)

    Within a chunk the decays enter as exp(cumsum(log w)) factors, the
    intra-chunk term is a strictly lower-triangular product and the
    u-bonus its diagonal; the state carries the chunks. Callers clip
    log w to [-5, 0), so exp(-cs) stays below exp(80) at chunk 16."""
    b, s, h, dd = r.shape
    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk

    def split(x):
        return x.float().reshape(b, nc, chunk, h, dd).transpose(0, 1)

    rr, kk, vv, lw = split(r), split(k), split(v), split(logw)
    tri_lo = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    uf = u.float()
    state = h0.float()
    outs = []
    for c in range(nc):
        rc, kc, vc, lwc = rr[c], kk[c], vv[c], lw[c]      # (B,C,H,D)
        cs = torch.cumsum(lwc, dim=1)
        # the state predates token i: decay through tokens 1..i-1
        decay_to_i = torch.exp(cs - lwc)
        r_dec = rc * decay_to_i
        inter = torch.einsum("bchd,bhde->bche", r_dec, state)
        # j < i: decay exp(cs_{i-1} - cs_j); j == i: the u-bonus diagonal
        k_scaled = kc * torch.exp(-cs)
        att = torch.einsum("bchd,bjhd->bhcj", r_dec, k_scaled)
        att = torch.where(tri_lo[None, None], att, 0.0)
        diag = torch.einsum("bchd,bchd->bch", rc * uf, kc)
        intra = torch.einsum("bhcj,bjhe->bche", att, vc)
        intra = intra + diag[..., None] * vc
        # S' = diag(exp(cs_C)) S + sum_j exp(cs_C - cs_j) k_j^T v_j
        total = cs[:, -1][:, None]                        # (B,1,H,D)
        k_dec = kc * torch.exp(total - cs)
        upd = torch.einsum("bchd,bche->bhde", k_dec, vc)
        state = torch.exp(total[:, 0])[..., None] * state + upd
        outs.append(inter + intra)
    out = torch.stack(outs, 0).transpose(0, 1).reshape(b, s, h, dd)
    return out, state


def wkv_step(r, k, v, logw, u, h0):
    """One token, r,k,v,logw (B,H,D): the chunk-of-one case of
    `wkv_chunked_ref` in closed form -> (out (B,H,D), S (B,H,D,D)),
    float32. The decode step's recurrence."""
    rf, kf, vf = r.float(), k.float(), v.float()
    state = h0.float()
    diag = (rf * u.float() * kf).sum(-1)
    out = torch.einsum("bhd,bhde->bhe", rf, state) + diag[..., None] * vf
    kv = kf[..., :, None] * vf[..., None, :]
    return out, torch.exp(logw.float())[..., None] * state + kv


def wkv_seq_ref(r, k, v, logw, u, h0):
    """Token by token, as `repro.kernels.rwkv6.ref.wkv_ref` ->
    (out (B,S,H,D), hT (B,H,D,D)), float32."""
    f32 = [x.float() for x in (r, k, v, logw)]
    uf = u.float()
    state = h0.float()
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, lwt = (x[:, t] for x in f32)          # (B,H,D)
        kv = kt[..., :, None] * vt[..., None, :]
        outs.append(torch.einsum("bhd,bhde->bhe", rt,
                                 state + uf[None, :, :, None] * kv))
        state = torch.exp(lwt)[..., None] * state + kv
    return torch.stack(outs, 1), state

"""Plain torch versions of the RWKV-6 WKV recurrence.

`wkv_chunked_ref` is the chunked form of `repro.models.rwkv6.wkv_chunked`,
which is what the JAX prefill computes: the CPU path of `ops.wkv`, and
what `chip_smoke.py` holds the CUDA kernel against. `wkv_seq_ref` is the
token-by-token oracle of `repro.kernels.rwkv6.ref.wkv_ref`, for the tests.
`wkv_tiles_ref` is the CUDA kernel's own decomposition (its column blocks
of S, the chunk pipeline, the padded ragged tail, the 3xTF32 products),
for the tests only.

Per (batch, head), with a D x D state S:

    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t,        w_t = exp(logw_t)
"""
from __future__ import annotations

import torch

CHUNK = 16          # the CUDA kernel's tokens per chunk (kC of csrc/wkv.cu)


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


def _tf32(x, *, rna: bool):
    """float32 -> float32 with a 10-bit mantissa: rounded as
    cvt.rna.tf32.f32 rounds (to nearest, ties away from zero; finite
    values) when `rna`, else truncated, as the tensor cores read a float32
    register as TF32."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + (0x1000 if rna else 0)) & 0xFFFFE000
    return torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(
        torch.int32).view(torch.float32)


def wkv_tiles_ref(r, k, v, logw, u, h0, *, passes: int = 3):
    """What `csrc/wkv.cu` computes, in its order -> (out (B,S,H,D),
    hT (B,H,D,D)), float32. Used by the tests only.

    Chunks of CHUNK tokens, the last one padded with k = v = r = 0 and
    logw = 0 (the state passes through it unchanged); cs a sequential
    running sum, r_dec = r e^{cs_{i-1}}, k_sc = k e^{-cs} and
    k_dec = k (e^{cs_C} e^{-cs}); att = r_dec k_sc^T summed over two
    halves of d, masked by select, the u-bonus on its diagonal; per
    column block of 16 columns of S (one consumer warp pair's):
    out = r_dec S + att v and S' = diag(e^{cs_C}) S + k_dec^T v. Every
    product is the kernel's tensor-core product: with `passes` = 3 the
    3xTF32 split a_hi b_hi + a_hi b_lo + a_lo b_hi, a_hi rounded as
    cvt.rna.tf32.f32 rounds and a_lo = a - a_hi read truncated to TF32 (a
    bf16 input is exact, so its lo half is 0); with `passes` = 1
    single-pass TF32, a_hi b_hi."""
    b, s, h, dd = r.shape
    nc = -(-s // CHUNK)
    pad = nc * CHUNK - s

    def split(x):
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
        return x.reshape(b, nc, CHUNK, h, dd).permute(1, 0, 3, 2, 4)

    def mm(x, y):                   # x (..., m, k) @ y (..., k, n)
        xh, yh = _tf32(x, rna=True), _tf32(y, rna=True)
        out = xh @ yh
        if passes == 3:
            out = out + (xh @ _tf32(y - yh, rna=False)
                         + _tf32(x - xh, rna=False) @ yh)
        return out

    rr, kk, vv, lw = split(r), split(k), split(v), split(logw)  # (B,H,C,D)
    uf = u.float()[None, :, None, :]
    lower = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.bool), -1)
    state = h0.float().clone()                                 # (B,H,D,D)
    out = torch.empty((nc, b, h, CHUNK, dd), dtype=torch.float32)
    for c in range(nc):
        rc, kc, vc, lwc = rr[c], kk[c], vv[c], lw[c]
        cs = torch.cumsum(lwc, dim=2)
        e_total = torch.exp(cs[:, :, -1:])
        before = torch.nn.functional.pad(cs[:, :, :-1], (0, 0, 1, 0))
        r_dec = rc * torch.exp(before)
        e_neg = torch.exp(-cs)
        k_sc = kc * e_neg
        k_dec = kc * (e_total * e_neg)
        half = dd // 2
        att = (mm(r_dec[..., :half], k_sc[..., :half].transpose(-1, -2))
               + mm(r_dec[..., half:], k_sc[..., half:].transpose(-1, -2)))
        att = torch.where(lower, att, 0.0)
        diag = ((rc * uf) * kc).sum(-1)
        att = att + torch.diag_embed(diag)
        for e0 in range(0, dd, 16):
            blk = slice(e0, e0 + 16)
            ve = vc[..., blk]
            out[c, ..., blk] = mm(r_dec, state[..., blk]) + mm(att, ve)
            state[..., blk] = (e_total[:, :, 0, :, None]
                               * state[..., blk]
                               + mm(k_dec.transpose(-1, -2), ve))
    out = out.permute(1, 0, 3, 2, 4).reshape(b, nc * CHUNK, h, dd)[:, :s]
    return out, state

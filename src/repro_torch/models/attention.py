"""GQA attention: torch counterpart of `repro.models.attention`.

Every attention over more than one new token goes through
`kernels.flash_attention.ops.attend` (the CUDA kernel on the card, its
plain version on the CPU). The JAX package computes the same function in
jnp in three ways -- naive, chunked and windowed -- and picks one by
sequence length; with the preconditions asserted below all three equal
causal (sliding-window) attention over the new tokens, which is what the
kernel computes. Single-token decode stays plain torch
(`decode_attention`), as in JAX.
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention import ops
from .config import ModelConfig
from .layers import apply_rope
from .nn import Initializer

NEG_INF = -1e30


def init_attention(ini: Initializer, cfg: ModelConfig):
    d, hd = cfg.d_model, cfg.hd
    ini.param("wq", (d, cfg.n_heads, hd), init="fan_in")
    ini.param("wk", (d, cfg.n_kv_heads, hd), init="fan_in")
    ini.param("wv", (d, cfg.n_kv_heads, hd), init="fan_in")
    ini.param("wo", (cfg.n_heads, hd, d), init="fan_in")


def naive_attention(q, k, v, *, causal: bool, q_offset=0, kv_len=None,
                    window: int = 0):
    """q (B,S,H,hd), k/v (B,T,K,hd). q_offset: absolute position of q[0]
    relative to k[0] (scalar or (B,)). kv_len: valid cache entries (scalar
    or per-row (B,)). Scores and softmax in float32."""
    b, s, h, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    dev = q.device
    qg = q.reshape(b, s, nkv, h // nkv, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    scores = scores * (hd ** -0.5)
    q_offset = torch.as_tensor(q_offset, device=dev)
    qpos = q_offset[..., None, None] + torch.arange(s, device=dev)[:, None]
    kpos = torch.arange(t, device=dev)[None, :]
    mask = torch.ones(qpos.shape[:-2] + (s, t), dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=dev)
        mask = (mask & (kpos[None] < kv_len.reshape(-1, 1, 1))
                if kv_len.dim() else mask & (kpos < kv_len))
    mask = mask[None, None, None] if mask.dim() == 2 else mask[:, None, None]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(b, s, h, hd)


def decode_attention(q, k_cache, v_cache, kv_len, *, window: int = 0):
    """Single-token decode: q (B,1,H,hd) against cache (B,T,K,hd) with
    `kv_len` valid entries."""
    return naive_attention(q, k_cache, v_cache, causal=False, kv_len=kv_len,
                           window=window, q_offset=kv_len - 1)


def _flash(q, k, v, *, causal: bool, window: int):
    """(B,S,H,hd) layout in and out, through the kernel's (B,H,S,hd)."""
    out = ops.attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                     causal=causal, window=window)
    return out.transpose(1, 2)


def _check_chunking(s: int, t: int):
    """The shapes `repro.models.attention.chunked_attention` takes (it
    asserts them); the port refuses the others too."""
    assert s % min(512, s) == 0 and t % min(1024, t) == 0, \
        f"s={s}, t={t}: not multiples of the 512/1024 chunks"


def _write_cache(cache, k, v, kv_len, s: int):
    """Write the new k/v at [kv_len - s, kv_len), in place (JAX donates the
    cache). Per-row kv_len (B,) with s == 1 writes row r at kv_len[r] - 1
    with JAX's scatter semantics: -1 wraps to the last position, indices
    past either end are dropped. Otherwise one start for all rows, clamped
    into the cache as `dynamic_update_slice` clamps it."""
    kc, vc = cache["k"], cache["v"]
    t = kc.shape[1]
    if s == 1 and torch.is_tensor(kv_len) and kv_len.dim() == 1:
        idx = kv_len.to(kc.device).long() - 1
        idx = torch.where(idx < 0, idx + t, idx)
        keep = ((idx >= 0) & (idx < t))[:, None, None]
        rows = torch.arange(kc.shape[0], device=kc.device)
        idx = idx.clamp(0, t - 1)
        kc[rows, idx] = torch.where(keep, k[:, 0], kc[rows, idx])
        vc[rows, idx] = torch.where(keep, v[:, 0], vc[rows, idx])
    else:
        first = kv_len[0] if torch.is_tensor(kv_len) and kv_len.dim() else \
            kv_len
        start = min(max(int(first) - s, 0), t - s)
        kc[:, start:start + s] = k
        vc[:, start:start + s] = v
    return {"k": kc, "v": vc}


def attention_block(p, cfg: ModelConfig, x, *, cos_sin, window=0,
                    cache=None, kv_len=None):
    """Full causal attention sub-block: qkv proj -> rope -> attention -> out
    proj (the JAX block's `causal=True`, the only value its model passes).

    cache: optional dict with 'k','v' (B,T,K,hd) to read and update in
    place. kv_len: valid cache length *including* the current tokens.
    Returns (out, new_cache)."""
    b, s, d = x.shape
    h, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"].reshape(d, h * hd)).reshape(b, s, h, hd)
    k = (x @ p["wk"].reshape(d, nkv * hd)).reshape(b, s, nkv, hd)
    v = (x @ p["wv"].reshape(d, nkv * hd)).reshape(b, s, nkv, hd)
    if cos_sin is not None:
        cos, sin = cos_sin
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    new_cache = None
    if cache is not None:
        new_cache = _write_cache(cache, k, v, kv_len, s)
        kc, vc = new_cache["k"], new_cache["v"]
        if s == 1:
            out = decode_attention(q, kc, vc, torch.as_tensor(
                kv_len, device=x.device), window=window)
        else:
            out = _prefill_over_cache(q, kc, vc, kv_len, window=window)
    elif s == 1:
        out = naive_attention(q, k, v, causal=True, window=window)
    else:
        if s > 1024:           # JAX's chunked/windowed path
            _check_chunking(s, s)
        out = _flash(q, k, v, causal=True, window=window)
    out = out.reshape(b, s, h * hd) @ p["wo"].reshape(h * hd, d)
    return out, new_cache


def _prefill_over_cache(q, kc, vc, kv_len, *, window):
    """Prefill path: q for the s new tokens, the cache holds kv_len total.

    JAX computes this with `_windowed_attention` (window > 0),
    `naive_attention` with kv_len masking (s <= 1024) or
    `chunked_attention` (longer). From an empty cache kv_len == s, and all
    three are then causal attention over the first s cache rows, which the
    kernel computes."""
    s = q.shape[1]
    kv = torch.as_tensor(kv_len)
    assert bool((kv == s).all()), \
        f"prefill over a cache needs kv_len == s ({s}), got {kv_len}"
    if window > 0:
        assert s % min(512, s) == 0, f"s={s} is not a multiple of 512"
    elif s > 1024:
        _check_chunking(s, s)
    return _flash(q, kc[:, :s], vc[:, :s], causal=True, window=window)

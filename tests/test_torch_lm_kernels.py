"""The plain versions of the port's LM kernels against the JAX package:
the flash attention twin against `attention_ref` and against the model's
naive, chunked and windowed attention; the RG-LRU scan twin against
`rglru_scan_ref` and `chunked_linear_scan`. Inputs are made with numpy
from a seed and handed to both. (Never against the Pallas interpret path:
it raises under jax 0.9.)"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ref as jfa_ref  # noqa: E402
from repro.kernels.rglru import ref as jlru_ref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.rglru import ops as lru_ops  # noqa: E402
from repro_torch.kernels.rglru import ref as lru_ref  # noqa: E402

pytestmark = pytest.mark.tier1

F32_TOL, BF16_TOL = 2e-5, 2e-2       # as tests/test_kernels.py:51
SCAN_TOL = 1e-4                      # as tests/test_kernels.py:82


def _qkv(seed, b, h, kh, s, t, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s, hd), np.float32),
            rng.standard_normal((b, kh, t, hd), np.float32),
            rng.standard_normal((b, kh, t, hd), np.float32))


# the cases of tests/test_kernels.py:35-41
@pytest.mark.parametrize("b,h,kh,s,t,hd,causal,window,dtype", [
    (2, 4, 2, 128, 128, 64, True, 0, "float32"),
    (1, 4, 1, 256, 256, 64, True, 64, "float32"),
    (2, 2, 2, 128, 128, 32, False, 0, "float32"),
    (1, 8, 4, 128, 256, 64, False, 0, "float32"),   # cross, T != S
    (1, 2, 2, 128, 128, 64, True, 0, "bfloat16"),
])
def test_flash_twin_matches_jax_attention_ref(b, h, kh, s, t, hd, causal,
                                              window, dtype):
    q, k, v = _qkv(b * 100 + s, b, h, kh, s, t, hd)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jfa_ref.attention_ref(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                 causal=causal, window=window)
    got = fa_ref.attention_ref(*(torch.from_numpy(x).to(tdt)
                                 for x in (q, k, v)),
                               causal=causal, window=window)
    assert got.dtype == tdt and tuple(got.shape) == (b, h, s, hd)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _to_model_layout(x):
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3))   # (B,S,H,hd)


@pytest.mark.parametrize("path,s,window", [
    ("naive", 64, 0), ("naive", 64, 16), ("chunked", 1024, 0),
    ("windowed", 1024, 128)])
def test_flash_twin_matches_jax_model_attention(path, s, window):
    """After the layout transpose, the twin computes what each of the JAX
    model's attention strategies computes for causal self-attention."""
    b, h, kh, hd = 1, 4, 2, 32
    q, k, v = (_to_model_layout(x)
               for x in _qkv(s + window, b, h, kh, s, s, hd))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    if path == "naive":
        want = jattn.naive_attention(jq, jk, jv, causal=True, window=window)
    elif path == "chunked":
        want = jattn.chunked_attention(jq, jk, jv, causal=True,
                                       q_chunk=256, kv_chunk=256)
    else:
        want = jattn._windowed_attention(jq, jk, jv, q_chunk=256,
                                         window=window)
    tq, tk, tv = (torch.from_numpy(x).transpose(1, 2) for x in (q, k, v))
    got = fa_ref.attention_ref(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want),
                               atol=F32_TOL, rtol=F32_TOL)


def _scan_inputs(seed, b, s, w):
    rng = np.random.default_rng(seed)
    return (-np.abs(rng.standard_normal((b, s, w), np.float32)) * 0.1,
            rng.standard_normal((b, s, w), np.float32),
            rng.standard_normal((b, w), np.float32))


# the cases of tests/test_kernels.py:70-73, each twin chunk
@pytest.mark.parametrize("b,s,w,chunk", [
    (2, 128, 128, 32), (1, 256, 256, 64), (3, 64, 128, 64),
    (1, 128, 384, 128),
])
def test_scan_twin_matches_jax(b, s, w, chunk):
    la, bb, h0 = _scan_inputs(b + s + w, b, s, w)
    j = [jnp.asarray(x) for x in (la, bb, h0)]
    got_all, got_last = lru_ref.rglru_scan_ref(
        *(torch.from_numpy(x) for x in (la, bb, h0)), chunk=chunk)
    for want_all, want_last in (jlru_ref.rglru_scan_ref(*j),
                                jrglru.chunked_linear_scan(*j, chunk=chunk)):
        np.testing.assert_allclose(got_all.numpy(), np.asarray(want_all),
                                   atol=SCAN_TOL, rtol=SCAN_TOL)
        np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                                   atol=SCAN_TOL, rtol=SCAN_TOL)


def test_cpu_tensors_take_the_plain_path_without_a_launch():
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 1, 2, 1, 64, 64, 16))
    la, bb, h0 = (torch.from_numpy(x) for x in _scan_inputs(0, 2, 64, 32))
    fa_ops.reset_launches()
    lru_ops.reset_launches()
    assert torch.equal(fa_ops.attend(q, k, v, causal=True, window=8),
                       fa_ref.attention_ref(q, k, v, causal=True, window=8))
    for g, w in zip(lru_ops.scan(la, bb, h0), lru_ref.rglru_scan_ref(la, bb,
                                                                    h0)):
        assert torch.equal(g, w)
    assert fa_ops.launches == {"flash_attention": 0}
    assert lru_ops.launches == {"rglru_scan": 0}


def test_cuda_request_without_a_card_raises(monkeypatch):
    """A CUDA tensor goes to the kernel or raises; it never falls back to
    the plain version. Without a card, making one raises already."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, AssertionError)):
        fa_ops.attend(*(torch.zeros((1, 1, 16, 16), device="cuda")
                        for _ in range(3)))
    with pytest.raises((RuntimeError, AssertionError)):
        lru_ops.scan(torch.zeros((1, 16, 8), device="cuda"),
                     torch.zeros((1, 16, 8), device="cuda"),
                     torch.zeros((1, 8), device="cuda"))
    meta = torch.zeros((1, 1, 16, 16), device="meta")
    with pytest.raises(ValueError, match="no attention path"):
        fa_ops.attend(meta, meta, meta)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers themselves take CUDA tensors only."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru import rglru
    x = torch.zeros((1, 1, 16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        rglru.rglru_scan(torch.zeros((1, 4, 2)), torch.zeros((1, 4, 2)),
                         torch.zeros((1, 2)))


def test_flash_kernel_takes_every_buildable_attention_head_dim():
    """Every config the port builds with attention blocks, full width and
    reduced, has a head dim the kernel is instantiated for (phi3-mini's is
    96, recurrentgemma's and gemma3's 256)."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import model
    seen = set()
    for arch in configs.ARCHS:
        for cfg in (configs.get(arch), configs.reduced(arch)):
            try:
                model.check_supported(cfg)
            except NotImplementedError:
                continue
            if {"attn", "local"} & set(cfg.pattern):
                assert cfg.hd in flash_attention.HEAD_DIMS, (cfg.name, cfg.hd)
                seen.add(cfg.hd)
    assert {96, 256} <= seen

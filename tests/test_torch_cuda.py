"""The port on the card: the CUDA kernels against their plain versions,
one golden family end to end with the kernel launched once per simulated
tick, and the reduced recurrentgemma and rwkv6 prefills through the LM
kernels against the plain path on the CPU. Needs a CUDA device and nvcc (a CUDA kernel has no CPU
mode), so every test here carries the `cuda` marker and skips elsewhere;
run them on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

No JAX is needed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels.bfc_step import ops  # noqa: E402
from repro_torch.kernels.bfc_step import ref as tref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.rglru import ops as lru_ops  # noqa: E402
from repro_torch.kernels.rglru.ref import rglru_scan_ref  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6 import ref as wkv_ref  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402
from repro_torch.sim.trace import golden  # noqa: E402

pytestmark = [pytest.mark.tier1, pytest.mark.cuda]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


def _inputs(seed, p, q, device, *, srf):
    rng = np.random.default_rng(seed)
    occ = rng.integers(0, 40, (p, q)).astype(np.int32)
    occ[p // 3:p // 2] = 0                            # empty rows
    qpaused = rng.random((p, q)) < 0.3
    qpaused[:5] = True                                # all-paused rows
    ptr = rng.integers(0, q, p).astype(np.int32)
    blocked = rng.random(p) < 0.2
    key = rng.integers(0, tref.BIG + 1, (p, q)).astype(np.int32)
    args = [torch.from_numpy(a).to(device)
            for a in (occ, qpaused, ptr, blocked)]
    return args, (torch.from_numpy(key).to(device) if srf else None)


@pytest.mark.parametrize("scheduler", ["drr", "srf"])
@pytest.mark.parametrize("p,q", [(384, 32), (384, 1), (384, 64), (97, 32),
                                 (24, 32)])
def test_kernels_match_plain_versions(card, p, q, scheduler):
    args, srf_key = _inputs(p + q, p, q, card, srf=scheduler == "srf")
    before = dict(ops.launches)
    got = ops.fused(*args, pause_window=37, scheduler=scheduler,
                    srf_key=srf_key)
    want = tref.bfc_fused_ref(*args, pause_window=37, scheduler=scheduler,
                              srf_key=srf_key)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    got = ops.decide(*args[:3], pause_window=37)
    for g, w in zip(got, tref.bfc_decide_ref(*args[:3], pause_window=37)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert ops.launches["bfc_fused"] == before["bfc_fused"] + 1
    assert ops.launches["bfc_decide"] == before["bfc_decide"] + 1


def test_kernel_rejects_bad_operands(card):
    args, _ = _inputs(1, 8, 4, card, srf=False)
    with pytest.raises(TypeError):
        ops.fused(args[0].long(), *args[1:], pause_window=37)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused(args[0].repeat(1, 2)[:, ::2], *args[1:], pause_window=37)
    with pytest.raises(ValueError):
        ops.fused(*args, pause_window=37, scheduler="srf")


def test_golden_family_on_card(card):
    """`bfc` on the pinned golden case reproduces its fixture on the card,
    with one kernel launch per simulated tick (plus the one step that
    rebuilds the quiescent tail's trace row)."""
    ops.reset_launches()
    out = golden.run_family("bfc", card)
    assert golden.compare("bfc", out) == []
    assert ops.launches["bfc_fused"] == out["active_ticks"] + 1


@pytest.mark.parametrize("b,h,kh,s,t,hd,causal,window,dtype,tol", [
    (2, 10, 1, 1024, 1024, 256, True, 256, "bfloat16", (4e-3, 1e-2)),
    (1, 8, 4, 130, 200, 64, False, 0, "float32", (2e-5, 2e-5)),
    (2, 4, 4, 96, 96, 16, True, 0, "float32", (2e-5, 2e-5)),
    (1, 2, 1, 320, 320, 256, True, 100, "float32", (2e-5, 2e-5)),
    (1, 4, 4, 160, 160, 96, True, 0, "float32", (2e-5, 2e-5)),   # phi3-mini
])
def test_flash_attention_matches_plain_version(card, b, h, kh, s, t, hd,
                                               causal, window, dtype, tol):
    """Tolerance (atol, rtol): f32 2e-5 as tests/test_kernels.py:51; bf16
    one output ulp (rtol 1e-2) plus 4e-3 near 0, as `chip_smoke.py`."""
    gen = torch.Generator(card).manual_seed(s + t)
    dt = getattr(torch, dtype)
    q = torch.randn((b, s, h, hd), generator=gen, device=card).to(
        dt).transpose(1, 2)                   # the model's strided layout
    k, v = (torch.randn((b, kh, t, hd), generator=gen, device=card).to(dt)
            for _ in range(2))
    before = fa_ops.launches["flash_attention"]
    got = fa_ops.attend(q, k, v, causal=causal, window=window)
    want = attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.launches["flash_attention"] == before + 1
    assert got.dtype == dt and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol[0],
                               rtol=tol[1])


@pytest.mark.parametrize("b,s,w", [(2, 1024, 2560), (3, 72, 96)])
def test_rglru_scan_matches_plain_version(card, b, s, w):
    """Tolerance 1e-4: the kernel sums sequentially, the plain version in
    the chunked cumsum form."""
    gen = torch.Generator(card).manual_seed(b * s)
    log_a = -torch.rand((b, s, w), generator=gen, device=card) * 0.1
    bb = torch.randn((b, s, w), generator=gen, device=card)
    h0 = torch.randn((b, w), generator=gen, device=card)
    before = lru_ops.launches["rglru_scan"]
    got = lru_ops.scan(log_a, bb, h0)
    want = rglru_scan_ref(log_a, bb, h0)
    torch.cuda.synchronize()
    assert lru_ops.launches["rglru_scan"] == before + 1
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, atol=1e-4, rtol=1e-4)


def test_lm_kernels_reject_bad_operands(card):
    x = torch.zeros((1, 2, 16, 48), device=card)      # head_dim 48
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.attend(x, x, x)
    with pytest.raises(TypeError):
        lru_ops.scan(*(torch.zeros((1, 8, 4), device=card,
                                   dtype=torch.float16) for _ in range(2)),
                     torch.zeros((1, 4), device=card))


def test_reduced_recurrentgemma_prefill_on_card(card):
    """The prefill through both LM kernels on the card agrees with the
    plain path on the CPU (float32, TF32 off; tolerance 1e-4)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.reduced("recurrentgemma-2b")
    params = model.init_model(cfg, device="cpu", seed=1)
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 256)))
    want_logits, want_cache = steps.make_prefill_step(cfg)(params, tok)
    fa_ops.reset_launches()
    lru_ops.reset_launches()
    got_logits, got_cache = steps.make_prefill_step(cfg)(
        params.to(card), tok.to(card))
    torch.cuda.synchronize()
    assert fa_ops.launches["flash_attention"] == 1
    assert lru_ops.launches["rglru_scan"] == 2 + 1     # unit + remainder
    torch.testing.assert_close(got_logits.cpu(), want_logits, atol=1e-4,
                               rtol=1e-4)
    for name in ("b0", "b1", "b2"):
        for leaf, want in want_cache["units"][0][name].items():
            torch.testing.assert_close(got_cache["units"][0][name][leaf].cpu(),
                                       want, atol=1e-4, rtol=1e-4)


def _wkv_inputs(card, b, s, h, d, dtype):
    """r, k, v in `dtype`; log w in the model's clipped range."""
    gen = torch.Generator(card).manual_seed(b * s + h + d)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=card)
    r, k, v = (normal(b, s, h, d).mul(0.5).to(dtype) for _ in range(3))
    logw = -normal(b, s, h, d).exp().clamp(1e-6, 5.0)
    return r, k, v, logw, normal(h, d) * 0.3, normal(b, h, d, d) * 0.2


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("b,s,h,d,dtype,plain", [
    (2, 1024, 40, 64, "bfloat16", "chunked"),     # rwkv6-3b's heads
    (1, 128, 4, 32, "float32", "chunked"),
    (2, 64, 2, 16, "float32", "chunked"),         # the reduced config's
    (1, 37, 2, 64, "float32", "sequential"),      # a ragged last run
])
def test_wkv_matches_plain_version(card, b, s, h, d, dtype, plain):
    """Tolerance max|d| / max|ref| <= 1e-5: the kernel runs the recurrence
    token by token, the plain version in 16-token chunks (3.9e-7 apart in
    float32 at (1, 2048, 2, 64) with the JAX package's two forms)."""
    x = _wkv_inputs(card, b, s, h, d, getattr(torch, dtype))
    before = wkv_ops.launches["wkv"]
    got = wkv_ops.wkv(*x)
    want = (wkv_ref.wkv_chunked_ref if plain == "chunked"
            else wkv_ref.wkv_seq_ref)(*x)
    torch.cuda.synchronize()
    assert wkv_ops.launches["wkv"] == before + 1
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _rel(g, w) <= 1e-5


def test_wkv_rejects_bad_operands(card):
    r, k, v, logw, u, h0 = _wkv_inputs(card, 1, 16, 2, 64, torch.float32)
    with pytest.raises(TypeError):
        wkv_ops.wkv(r, k.bfloat16(), v, logw, u, h0)
    with pytest.raises(TypeError):
        wkv_ops.wkv(r, k, v, logw.bfloat16(), u, h0)
    with pytest.raises(ValueError, match="head_dim"):
        wkv_ops.wkv(*(t[..., :48] for t in (r, k, v, logw)), u[:, :48],
                    h0[..., :48, :48].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        wkv_ops.wkv(r.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                    logw, u, h0)
    with pytest.raises(ValueError, match="shape"):
        wkv_ops.wkv(r, k, v, logw, u, h0[:, :1])


def test_reduced_rwkv6_prefill_on_card(card):
    """The prefill through the WKV kernel on the card, once per layer,
    agrees with the plain path on the CPU (float32, TF32 off; tolerance
    1e-4)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.reduced("rwkv6-3b")
    params = model.init_model(cfg, device="cpu", seed=1)
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 256)))
    want_logits, want_cache = steps.make_prefill_step(cfg)(params, tok)
    wkv_ops.reset_launches()
    got_logits, got_cache = steps.make_prefill_step(cfg)(
        params.to(card), tok.to(card))
    torch.cuda.synchronize()
    assert wkv_ops.launches["wkv"] == cfg.n_layers == 2
    torch.testing.assert_close(got_logits.cpu(), want_logits, atol=1e-4,
                               rtol=1e-4)
    for unit, want_unit in zip(got_cache["units"], want_cache["units"]):
        for leaf, want in want_unit["b0"].items():
            torch.testing.assert_close(unit["b0"][leaf].cpu(), want,
                                       atol=1e-4, rtol=1e-4)

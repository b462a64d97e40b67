"""The port on the card: the CUDA kernels against their plain versions
(the fused switch step on seeded states and on states stepped from the
golden case), the graphed runner against eager stepping (a golden family
and the paper case's first 1024 ticks), golden families and the paper case
end to end with the kernel launched once per simulated tick, and the
reduced recurrentgemma and rwkv6 prefills through the LM kernels against
the plain path on the CPU. Needs a CUDA device and nvcc (a CUDA kernel has no CPU
mode), so every test here carries the `cuda` marker and skips elsewhere;
run them on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

No JAX is needed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs, testing  # noqa: E402
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
from repro_torch.sim import engine, phases, topology, workload  # noqa: E402
from repro_torch.sim.config import PRESETS  # noqa: E402
from repro_torch.sim.tick_profile import paper_case  # noqa: E402
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


def _assert_derive_equal(got, want, what):
    for name, g, w in zip(tref.DeriveOut._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what} {name}"
        assert torch.equal(g, w), f"{what} {name}"


DERIVE_FLAGS = {"bfc": (True, False), "bfc_pfc": (True, True),
                "pfc": (False, True)}        # backpressure, pfc


@pytest.mark.parametrize("buffer_limit", [None, 1 << 29])
@pytest.mark.parametrize("flags", sorted(DERIVE_FLAGS))
@pytest.mark.parametrize("scheduler", ["drr", "srf"])
@pytest.mark.parametrize("p,q", [(384, 32), (384, 1), (384, 64), (97, 32),
                                 (24, 32)])
def test_derive_kernel_matches_plain_version(card, p, q, scheduler, flags,
                                             buffer_limit):
    """The fused switch step's kernel against `derive_ref` on seeded
    states, every output equal (None: a tight buffer that spreads PFC
    thresholds; 1 << 29: the infinite buffer)."""
    args = testing.random_derive_inputs(p * q, p, q, card,
                                        buffer_limit=buffer_limit)
    bp, pfc = DERIVE_FLAGS[flags]
    kw = dict(n_switches=16, backpressure=bp, pfc=pfc, scheduler=scheduler,
              pfc_frac=0.11, pause_window=37)
    before = ops.launches["bfc_fused"]
    got = ops.derive(*args, **kw)
    want = tref.derive_ref(*args, **kw)
    torch.cuda.synchronize()
    assert ops.launches["bfc_fused"] == before + 1
    _assert_derive_equal(got, want, f"{flags} {scheduler} ({p},{q})")


def _golden_operands(name, card):
    topo, flows = golden.golden_case()
    flows = workload.pad_flowset(flows, golden.GOLDEN_PAD_FLOWS)
    cfg = golden.golden_cfg(PRESETS[name])
    dims = topology.TopoDims.of(topo)
    fops = engine.pack_flows(flows, cfg, card)
    tops = topology.pack_topo(topo, infinite_buffer=cfg.proto.infinite_buffer,
                              device=card)
    return dims, cfg, fops, tops


@pytest.mark.parametrize("name", ["bfc", "bfc_srf", "bfc_pfc", "pfc",
                                  "ideal_fq"])
def test_derive_kernel_on_golden_states(card, name):
    """The kernel against `derive_ref` on states of the golden case stepped
    to ticks 150 and 300 on the card."""
    dims, cfg, fops, tops = _golden_operands(name, card)
    env = phases.make_env(dims, cfg, fops.arrival.shape[0], card)
    for n in (150, 300):
        st, _, _ = engine.simulate(dims, cfg, fops, tops, n,
                                   early_exit=False)
        args, kw = phases.derive_operands(env, st, fops, tops)
        got = ops.derive(*args, **kw)
        want = tref.derive_ref(*args, **kw)
        torch.cuda.synchronize()
        assert int(want.occ.sum()) > 0
        _assert_derive_equal(got, want, f"{name} tick {n}")


def _eager(dims, cfg, fops, tops, n_ticks):
    """Step `n_ticks` with `make_step`'s eager step: (state, emits)."""
    with torch.inference_mode():
        _, init_state, step = engine.make_step(dims, cfg,
                                               fops.arrival.shape[0],
                                               fops.arrival.device)
        st, rows = init_state(), []
        for _ in range(n_ticks):
            st, row = step(st, fops, tops)
            rows.append(row)
        return st, torch.stack(rows)


@pytest.mark.parametrize("case", ["golden-bfc", "paper"])
def test_graphed_simulate_matches_eager_steps(card, case):
    """The graphed runner against eager stepping, every leaf and emit row
    equal: the golden `bfc` case over 700 ticks (not a multiple of
    GRAPH_TICKS), and the paper case's first 1024 ticks."""
    if case == "paper":
        _, topo, flows, cfg = paper_case()
        dims = topology.TopoDims.of(topo)
        fops = engine.pack_flows(flows, cfg, card)
        tops = topology.pack_topo(topo, device=card)
        n = 1024
    else:
        dims, cfg, fops, tops = _golden_operands("bfc", card)
        n = 700
    st, emits, active = engine.simulate(dims, cfg, fops, tops, n,
                                        early_exit=False)
    want_st, want_emits = _eager(dims, cfg, fops, tops, n)
    assert active == n
    testing.assert_state_equal(st, want_st, f"{case} graphed vs eager")
    assert torch.equal(emits, want_emits)


def test_paper_case_launches_once_per_active_tick(card):
    """The whole paper run through the graphed runner: as many kernel
    launches as active ticks (the replays add their captured launches)."""
    _, topo, flows, cfg = paper_case()
    dims = topology.TopoDims.of(topo)
    fops = engine.pack_flows(flows, cfg, card)
    tops = topology.pack_topo(topo, device=card)
    ops.reset_launches()
    st, _, active = engine.simulate(dims, cfg, fops, tops,
                                    flows.horizon + 20_000)
    torch.cuda.synchronize()
    assert active == 29184
    assert ops.launches == {"bfc_fused": active, "bfc_decide": 0}
    assert int((st.done >= 0).sum()) == flows.n_flows


@pytest.mark.parametrize("b,h,kh,s,t,hd,causal,window,dtype,tol", [
    (2, 10, 1, 1024, 1024, 256, True, 256, "bfloat16", (4e-3, 1e-2)),
    (2, 4, 2, 128, 128, 64, True, 0, "bfloat16", (4e-3, 1e-2)),
    (1, 8, 4, 130, 200, 64, False, 0, "bfloat16", (4e-3, 1e-2)),
    (1, 2, 1, 320, 320, 256, True, 100, "bfloat16", (4e-3, 1e-2)),
    (1, 4, 4, 160, 160, 96, True, 0, "bfloat16", (4e-3, 1e-2)),  # phi3-mini
    (2, 4, 4, 200, 200, 16, True, 0, "bfloat16", (4e-3, 1e-2)),
    (1, 8, 4, 130, 200, 64, False, 0, "float32", (2e-5, 2e-5)),
    (2, 4, 4, 96, 96, 16, True, 0, "float32", (2e-5, 2e-5)),
    (1, 2, 1, 320, 320, 256, True, 100, "float32", (2e-5, 2e-5)),
    (1, 4, 4, 160, 160, 96, True, 0, "float32", (2e-5, 2e-5)),   # phi3-mini
])
def test_flash_attention_matches_plain_version(card, b, h, kh, s, t, hd,
                                               causal, window, dtype, tol):
    """Tolerance (atol, rtol): f32 2e-5 as tests/test_kernels.py:51; bf16
    (the tensor-core kernel, P rounded to bf16 before the P V product) one
    output ulp (rtol 1e-2) plus 4e-3 near 0, as `chip_smoke.py`."""
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


# the last two: S under one 128-token tile with W not a multiple of the
# 32-channel tile; 32 tiles along S of a narrow W
@pytest.mark.parametrize("b,s,w", [(2, 1024, 2560), (3, 72, 96),
                                   (2, 100, 40), (2, 4096, 72)])
def test_rglru_scan_matches_plain_version(card, b, s, w):
    """Tolerance 1e-4: the kernel composes sub-chunk and tile pairs and
    steps sequentially from each carry, the plain version takes the
    chunked cumsum form. A second call on the same inputs gives identical
    outputs (the look-back scratch is reset every call, and a carry does
    not depend on how far the other tiles had got)."""
    gen = torch.Generator(card).manual_seed(b * s)
    log_a = -torch.rand((b, s, w), generator=gen, device=card) * 0.1
    bb = torch.randn((b, s, w), generator=gen, device=card)
    h0 = torch.randn((b, w), generator=gen, device=card)
    before = lru_ops.launches["rglru_scan"]
    got = lru_ops.scan(log_a, bb, h0)
    again = lru_ops.scan(log_a, bb, h0)
    want = rglru_scan_ref(log_a, bb, h0)
    torch.cuda.synchronize()
    assert lru_ops.launches["rglru_scan"] == before + 2
    for g, a, w_ in zip(got, again, want):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w_, atol=1e-4, rtol=1e-4)


def test_flash_attention_refuses_bf16_operands_tma_cannot_address(card):
    """The bf16 kernel reads through TMA: a base one element off 16 bytes,
    or a position stride that is not a multiple of 16 bytes, raises
    ValueError (no fallback to another kernel)."""
    bf16 = torch.bfloat16
    k = torch.randn((1, 2, 128, 64), device=card).to(bf16)
    flat = torch.randn(1 + k.numel(), device=card).to(bf16)
    shifted = flat[1:].view(k.shape)                  # base + 2 bytes
    wide = torch.randn((1, 2, 128, 68), device=card).to(bf16)[..., :64]
    before = fa_ops.launches["flash_attention"]
    for q in (shifted, wide):
        with pytest.raises(ValueError, match="TMA"):
            fa_ops.attend(q, k, k)
    with pytest.raises(ValueError, match="TMA"):
        fa_ops.attend(k, k, shifted)
    assert fa_ops.launches["flash_attention"] == before
    # the float32 kernel reads element by element: the same offset is fine
    q32 = torch.randn(1 + k.numel(), device=card)[1:].view(k.shape)
    k32 = k.float()
    torch.testing.assert_close(fa_ops.attend(q32, k32, k32),
                               attention_ref(q32, k32, k32), atol=2e-5,
                               rtol=2e-5)


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


@pytest.mark.parametrize("b,s,h,d,dtype,plain,clip", [
    (2, 1024, 40, 64, "bfloat16", "chunked", False),   # rwkv6-3b's heads
    (1, 128, 4, 32, "float32", "chunked", False),
    (2, 64, 2, 16, "float32", "chunked", False),       # the reduced config's
    (1, 37, 2, 64, "float32", "sequential", False),    # a ragged last chunk
    (1, 37, 2, 16, "float32", "sequential", False),    # the same at D = 16
    (1, 64, 2, 64, "float32", "sequential", True),     # the overflow edge
    (1, 37, 2, 16, "float32", "sequential", True),
])
def test_wkv_matches_plain_version(card, b, s, h, d, dtype, plain, clip):
    """Tolerance max|d| / max|ref| <= 1e-5: the kernel takes 16-token
    chunks with 3xTF32 tensor-core products, the plain versions chunks in
    float32 or single tokens (the JAX package's two forms are 3.9e-7
    apart in float32 at (1, 2048, 2, 64)). With `clip`, log w = -5
    throughout, the model's clip, where e^{-cs} reaches e^80 inside a
    chunk: the masked half of att may overflow and must be dropped by a
    select, so the outputs must also be finite."""
    r, k, v, logw, u, h0 = _wkv_inputs(card, b, s, h, d,
                                       getattr(torch, dtype))
    if clip:
        logw = torch.full_like(logw, -5.0)
    x = (r, k, v, logw, u, h0)
    before = wkv_ops.launches["wkv"]
    got = wkv_ops.wkv(*x)
    again = wkv_ops.wkv(*x)
    want = (wkv_ref.wkv_chunked_ref if plain == "chunked"
            else wkv_ref.wkv_seq_ref)(*x)
    torch.cuda.synchronize()
    assert wkv_ops.launches["wkv"] == before + 2
    for g, a, w in zip(got, again, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert bool(torch.isfinite(g).all())
        assert torch.equal(g, a)
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

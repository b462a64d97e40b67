"""The port's RWKV-6 pieces against the JAX package on the CPU: the WKV
plain versions against `wkv_chunked` and `wkv_ref`, the single-token
closed form against `wkv_chunked` at s=1, and the time and channel mixes
with and without a cache. Inputs are made with numpy from a seed and
handed to both. (Never against the Pallas interpret path: it raises under
jax 0.9.)

Tolerances: the chunked twin against JAX's chunked form 1e-5 (the same
arithmetic in float32, another summation order); anything against the
sequential oracle 1e-3, as tests/test_kernels.py:101-106; the mixes 1e-4,
as the model tests."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels.rwkv6 import ref as jwkv_ref  # noqa: E402
from repro.models import nn as jnn  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6 import ref as wkv_ref  # noqa: E402
from repro_torch.models import nn, rwkv6  # noqa: E402

pytestmark = pytest.mark.tier1

CHUNKED_TOL, SEQ_TOL, MIX_TOL = 1e-5, 1e-3, 1e-4


def _wkv_inputs(seed, b, s, h, d):
    """The distributions of tests/test_kernels.py:92-99."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return (normal(b, s, h, d) * 0.5, normal(b, s, h, d) * 0.5,
            normal(b, s, h, d) * 0.5,
            -np.clip(np.exp(normal(b, s, h, d)), 1e-3, 5.0),
            normal(h, d) * 0.3, normal(b, h, d, d) * 0.2)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


# the cases of tests/test_kernels.py:89-91, each with its chunk
@pytest.mark.parametrize("b,s,h,d,chunk", [
    (2, 64, 2, 64, 16), (1, 128, 4, 32, 16), (2, 32, 1, 64, 8),
])
def test_chunked_twin_matches_jax(b, s, h, d, chunk):
    x = _wkv_inputs(b * 1000 + s + h + d, b, s, h, d)
    j = [jnp.asarray(a) for a in x]
    got_o, got_h = wkv_ref.wkv_chunked_ref(
        *(torch.from_numpy(a) for a in x), chunk=chunk)
    assert got_o.dtype == got_h.dtype == torch.float32
    want_o, want_h = jrwkv.wkv_chunked(*j, chunk=chunk)
    _close(got_o, want_o, CHUNKED_TOL, "out vs wkv_chunked")
    _close(got_h, want_h, CHUNKED_TOL, "hT vs wkv_chunked")
    seq_o, seq_h = jwkv_ref.wkv_ref(*j)
    _close(got_o, seq_o, SEQ_TOL, "out vs wkv_ref")
    _close(got_h, seq_h, SEQ_TOL, "hT vs wkv_ref")


@pytest.mark.parametrize("b,s,h,d", [(2, 32, 2, 16), (1, 48, 1, 64)])
def test_sequential_twin_matches_jax_oracle(b, s, h, d):
    x = _wkv_inputs(7 + s, b, s, h, d)
    got_o, got_h = wkv_ref.wkv_seq_ref(*(torch.from_numpy(a) for a in x))
    want_o, want_h = jwkv_ref.wkv_ref(*(jnp.asarray(a) for a in x))
    _close(got_o, want_o, SEQ_TOL)
    _close(got_h, want_h, SEQ_TOL)


def test_single_token_closed_form_matches_jax_chunk_of_one():
    """The decode step's recurrence is `wkv_chunked` at s=1."""
    x = _wkv_inputs(3, 3, 1, 4, 16)
    want_o, want_h = jrwkv.wkv_chunked(*(jnp.asarray(a) for a in x))
    r, k, v, logw, u, h0 = (torch.from_numpy(a) for a in x)
    got_o, got_h = wkv_ref.wkv_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0],
                                    u, h0)
    _close(got_o, np.asarray(want_o)[:, 0], CHUNKED_TOL)
    _close(got_h, want_h, CHUNKED_TOL)


# ---- the block's mixes ------------------------------------------------------------
def _mix_pair(init_jax, init_port, seed):
    """JAX parameters of one mix and the port's holding the same values."""
    jcfg = jconfigs.reduced("rwkv6-3b")
    ini = jnn.Initializer(jax.random.key(seed), jnp.float32)
    init_jax(ini, jcfg)
    jp = jax.device_get(ini.params)
    tcfg = configs.reduced("rwkv6-3b")
    tp = nn.Params()
    init_port(nn.Initializer(tp, torch.Generator().manual_seed(0)), tcfg)
    with torch.no_grad():
        for name, p in tp.named_parameters():
            p.copy_(torch.from_numpy(np.array(jp[name])))
    assert sorted(dict(tp.named_parameters())) == sorted(jp)
    return jcfg, jp, tcfg, tp


def _mix_inputs(seed, cfg, b, s, cache_leaves):
    rng = np.random.default_rng(seed)
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    shapes = {"shift": (b, d), "S": (b, d // hd, hd, hd)}
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    cache = ({k: (rng.standard_normal(shapes[k]) * 0.3).astype(np.float32)
              for k in cache_leaves} if cache_leaves else None)
    return x, cache


def _run_mix(jfn, tfn, pair, x, cache):
    jcfg, jp, tcfg, tp = pair
    jout, jcache = jfn(jp, jcfg, jnp.asarray(x),
                       cache=None if cache is None else
                       {k: jnp.asarray(v) for k, v in cache.items()})
    tout, tcache = tfn(tp, tcfg, torch.from_numpy(x),
                       cache=None if cache is None else
                       {k: torch.from_numpy(v) for k, v in cache.items()})
    _close(tout, jout, MIX_TOL, "out")
    if cache is None:
        assert tcache is None and jcache is None
        return
    assert sorted(tcache) == sorted(jcache)
    for leaf in jcache:
        _close(tcache[leaf], jcache[leaf], MIX_TOL, leaf)


@pytest.mark.parametrize("s,cached", [(32, False), (32, True), (1, True),
                                      (1, False)])
def test_time_mix_matches_jax(s, cached):
    """s=32 runs the recurrence through `ops.wkv` (two 16-token chunks),
    s=1 through the closed form."""
    pair = _mix_pair(jrwkv.init_rwkv, rwkv6.init_rwkv, 1)
    x, cache = _mix_inputs(10 + s, pair[2], 2, s,
                           ("shift", "S") if cached else ())
    _run_mix(jrwkv.rwkv_time_mix, rwkv6.rwkv_time_mix, pair, x, cache)


@pytest.mark.parametrize("s,cached", [(16, False), (16, True), (1, True)])
def test_channel_mix_matches_jax(s, cached):
    pair = _mix_pair(jrwkv.init_rwkv_cm, rwkv6.init_rwkv_cm, 2)
    x, cache = _mix_inputs(20 + s, pair[2], 3, s,
                           ("shift",) if cached else ())
    _run_mix(jrwkv.rwkv_channel_mix, rwkv6.rwkv_channel_mix, pair, x, cache)


def test_time_mix_refuses_lengths_jax_refuses():
    """The chunked form needs s % 16 == 0 past 16 tokens, as JAX's."""
    _, _, tcfg, tp = _mix_pair(jrwkv.init_rwkv, rwkv6.init_rwkv, 1)
    with pytest.raises(AssertionError):
        rwkv6.rwkv_time_mix(tp, tcfg, torch.zeros((1, 24, tcfg.d_model)))


# ---- dispatch -----------------------------------------------------------------------
def test_cpu_tensors_take_the_plain_path_without_a_launch():
    x = [torch.from_numpy(a) for a in _wkv_inputs(0, 2, 32, 2, 16)]
    wkv_ops.reset_launches()
    for g, w in zip(wkv_ops.wkv(*x), wkv_ref.wkv_chunked_ref(*x)):
        assert torch.equal(g, w)
    assert wkv_ops.launches == {"wkv": 0}


def test_cuda_request_without_a_card_raises(monkeypatch):
    """A CUDA tensor goes to the kernel or raises; it never falls back to
    the plain version. Without a card, making one raises already."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, AssertionError)):
        wkv_ops.wkv(*(torch.zeros((1, 16, 1, 16), device="cuda")
                      for _ in range(4)),
                    torch.zeros((1, 16), device="cuda"),
                    torch.zeros((1, 1, 16, 16), device="cuda"))
    meta = torch.zeros((1, 16, 1, 16), device="meta")
    with pytest.raises(ValueError, match="no WKV path"):
        wkv_ops.wkv(meta, meta, meta, meta, meta, meta)


def test_kernel_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels.rwkv6 import wkv
    x = [torch.from_numpy(a) for a in _wkv_inputs(0, 1, 16, 1, 16)]
    with pytest.raises(ValueError, match="CUDA"):
        wkv.wkv(*x)


def test_kernel_takes_every_buildable_rwkv_head_dim():
    """rwkv6-3b's head dim (64), its reduced one (16) and the JAX kernel
    tests' (32, 64) all have a kernel instance."""
    from repro_torch.kernels.rwkv6 import wkv
    dims = {cfg.rwkv_head_dim for arch in configs.ARCHS
            for cfg in (configs.get(arch), configs.reduced(arch))
            if "rwkv" in cfg.pattern}
    assert dims == {16, 64}
    assert dims | {32} <= set(wkv.HEAD_DIMS)

"""The port's LM stack against the JAX package on the CPU, in float32 on
reduced configs, with JAX's parameters carried across
(`params_from_jax`): prefill logits and caches, per-row decode ticks, and
the cache-free backbone. Tolerance: rtol = atol = 1e-4 (float32 on both
sides; another summation order, and the RG-LRU scan's and the WKV
recurrence's chunked forms)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402
from repro_torch.testing import (cache_from_jax, cache_to_numpy,  # noqa: E402
                                 params_from_jax)

pytestmark = pytest.mark.tier1

TOL = 1e-4
ARCHS = ["recurrentgemma-2b", "gemma3-1b", "phi3-mini-3.8b", "rwkv6-3b"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jcfg = jconfigs.reduced(request.param)
    jparams, _ = jmodel.init_model(jax.random.key(0), jcfg)
    tcfg = configs.reduced(request.param)
    return jcfg, jparams, tcfg, params_from_jax(jax.device_get(jparams),
                                                tcfg)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL, err_msg=what)


def _assert_caches_close(port_cache, jax_cache):
    want = cache_to_numpy(cache_from_jax(jax.device_get(jax_cache)))
    got = cache_to_numpy(port_cache)
    assert len(got["units"]) == len(want["units"])
    assert sorted(got) == sorted(want)
    trees = [(f"units[{i}]", g, w) for i, (g, w) in
             enumerate(zip(got["units"], want["units"]))]
    trees += [(k, got[k], want[k]) for k in want if k != "units"]
    for where, g, w in trees:
        if {"k", "h", "S"} & set(w):          # a single block's cache
            g, w = {"": g}, {"": w}
        assert sorted(g) == sorted(w)
        for blk in w:
            assert sorted(g[blk]) == sorted(w[blk])
            for leaf in w[blk]:
                _close(g[blk][leaf], w[blk][leaf], f"{where}.{blk}.{leaf}")


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def test_params_mirror_the_jax_tree(pair):
    jcfg, jparams, tcfg, tparams = pair
    n_jax = sum(int(x.size) for x in jax.tree.leaves(jparams))
    assert sum(p.numel() for p in tparams.parameters()) == n_jax
    assert all(p.dtype == torch.float32 and not p.requires_grad
               for p in tparams.parameters())


def test_prefill_matches_jax_across_the_window(pair):
    """S=64 crosses the reduced window of 16 on the local layers."""
    jcfg, jparams, tcfg, tparams = pair
    tok = _tokens(1, 2, 64, jcfg.vocab)
    jl, jc = jax.jit(jsteps.make_prefill_step(jcfg))(jparams,
                                                     jnp.asarray(tok))
    tl, tc = steps.make_prefill_step(tcfg)(tparams, torch.from_numpy(tok))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, 1,
                                                             jcfg.vocab)
    _close(tl, jl, "logits")
    _assert_caches_close(tc, jc)


def test_recurrentgemma_prefill_over_eight_scan_chunks():
    """S=1024: eight 128-step chunks of the RG-LRU scan and the windowed
    attention's two 512-row q chunks."""
    name = "recurrentgemma-2b"
    jcfg = jconfigs.reduced(name)
    jparams, _ = jmodel.init_model(jax.random.key(3), jcfg)
    tparams = params_from_jax(jax.device_get(jparams),
                              configs.reduced(name))
    tok = _tokens(2, 1, 1024, jcfg.vocab)
    jl, jc = jax.jit(jsteps.make_prefill_step(jcfg))(jparams,
                                                     jnp.asarray(tok))
    tl, tc = steps.make_prefill_step(configs.reduced(name))(
        tparams, torch.from_numpy(tok))
    _close(tl, jl, "logits")
    _assert_caches_close(tc, jc)


def test_rwkv_prefill_over_sixty_four_wkv_chunks():
    """S=1024: sixty-four 16-token chunks of the WKV recurrence."""
    name = "rwkv6-3b"
    jcfg = jconfigs.reduced(name)
    jparams, _ = jmodel.init_model(jax.random.key(3), jcfg)
    tparams = params_from_jax(jax.device_get(jparams),
                              configs.reduced(name))
    tok = _tokens(2, 1, 1024, jcfg.vocab)
    jl, jc = jax.jit(jsteps.make_prefill_step(jcfg))(jparams,
                                                     jnp.asarray(tok))
    tl, tc = steps.make_prefill_step(configs.reduced(name))(
        tparams, torch.from_numpy(tok))
    _close(tl, jl, "logits")
    _assert_caches_close(tc, jc)


def test_decode_ticks_with_per_row_lengths_match_jax(pair):
    """8 decode ticks on 3 rows at different kv_len, from a cache holding
    random state (JAX's own numbers carried across)."""
    jcfg, jparams, tcfg, tparams = pair
    rng = np.random.default_rng(4)
    jcache = jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype),
        jmodel.init_cache(jcfg, 3, 32, stacked=False))
    tcache = cache_from_jax(jax.device_get(jcache))
    kv = np.array([0, 5, 20], np.int32)
    jdec = jax.jit(jsteps.make_decode_step(jcfg))
    tdec = steps.make_decode_step(tcfg)
    for tick in range(8):
        tok = _tokens(10 + tick, 3, 1, jcfg.vocab)
        jl, jcache = jdec(jparams, jcache, jnp.asarray(tok), jnp.asarray(kv))
        tl, tcache = tdec(tparams, tcache, torch.from_numpy(tok),
                          torch.from_numpy(kv))
        _close(tl, jl, f"logits at tick {tick}")
        kv = kv + 1
    _assert_caches_close(tcache, jcache)


def test_cache_free_backbone_matches_jax(pair):
    jcfg, jparams, tcfg, tparams = pair
    tok = _tokens(5, 2, 32, jcfg.vocab)
    jh, _, _ = jax.jit(lambda p, t: jmodel.backbone(p, jcfg, t))(
        jparams, jnp.asarray(tok))
    th, cache = model.backbone(tparams, tcfg, torch.from_numpy(tok))
    assert cache is None
    _close(th, jh, "hidden")
    _close(model.logits_for(tparams, tcfg, th),
           jmodel.logits_for(jparams, jcfg, jh), "logits")


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "grok-1-314b",
                                  "qwen2-vl-2b", "musicgen-medium"])
def test_unported_blocks_raise(arch):
    with pytest.raises(NotImplementedError, match="does not implement"):
        model.init_model(configs.reduced(arch), device="cpu")


def test_prefill_refuses_shapes_jax_refuses():
    """The chunked paths need s % 512 (windowed) / s % 128 (scan)."""
    cfg = configs.reduced("recurrentgemma-2b")
    params = model.init_model(cfg, device="cpu")
    with pytest.raises(AssertionError):
        steps.make_prefill_step(cfg)(params, torch.zeros((1, 600),
                                                         dtype=torch.long))


def test_rwkv_prefill_refuses_shapes_jax_refuses():
    """The chunked WKV form needs s % 16; 600 is not a multiple of 16."""
    cfg = configs.reduced("rwkv6-3b")
    params = model.init_model(cfg, device="cpu")
    with pytest.raises(AssertionError):
        steps.make_prefill_step(cfg)(params, torch.zeros((1, 600),
                                                         dtype=torch.long))

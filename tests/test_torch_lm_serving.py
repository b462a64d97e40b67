"""The port's BFCServer against the JAX package's, on the five scenarios of
tests/test_serving.py, for reduced phi3 (attention only; this file) and
reduced recurrentgemma (recurrent + local attention;
test_torch_lm_serving_rg.py). Both servers get the same float32 weights
and the same calls; every request must come out with the same tokens, and
the admission-control counters (`ServeStats`) and the submit verdicts
must be equal."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.runtime import serving  # noqa: E402
from repro_torch.testing import params_from_jax  # noqa: E402

pytestmark = pytest.mark.tier1


def _all_complete(srv_mod, srv):
    reqs = [srv_mod.Request(rid=i, client=i % 3, prompt=[1 + i, 2, 3],
                            max_new=4) for i in range(9)]
    verdicts = [srv.submit(r) for r in reqs]
    held = [r for r, ok in zip(reqs, verdicts) if not ok]
    done = srv.drain()
    while held:
        ok = [srv.submit(r) for r in held]
        verdicts += ok
        held = [r for r, o in zip(held, ok) if not o]
        done += srv.drain()
    return done, verdicts


def _pause_threshold(srv_mod, srv):
    verdicts, done = [], []
    for i in range(20):
        verdicts.append(srv.submit(srv_mod.Request(
            rid=i, client=i % 5, prompt=[1, 2], max_new=2)))
        done += srv.tick()
    return done + srv.drain(), verdicts


def _slot_reuse(srv_mod, srv):
    pending = [srv_mod.Request(rid=i, client=0, prompt=[1], max_new=2)
               for i in range(6)]
    verdicts, done = [], []
    for _ in range(50):
        ok = [srv.submit(r) for r in pending]
        verdicts += ok
        pending = [r for r, o in zip(pending, ok) if not o]
        done += srv.drain()
        if not pending:
            break
    return done, verdicts + sorted(srv.free)


def _full_context(srv_mod, srv):
    ok = srv.submit(srv_mod.Request(rid=0, client=0, prompt=[3, 7, 11],
                                    max_new=5))
    return srv.drain(), [ok]


def heterogeneous(max_new):
    def run(srv_mod, srv):
        ok = [srv.submit(srv_mod.Request(rid=0, client=0,
                                         prompt=[5, 6, 7, 8, 9],
                                         max_new=max_new))]
        done = srv.tick() + srv.tick()      # first request mid-prefill
        ok.append(srv.submit(srv_mod.Request(rid=1, client=1,
                                             prompt=[5, 6, 7, 8, 9],
                                             max_new=max_new)))
        return done + srv.drain(), ok
    return run


# scenario -> (BFCServer keyword arguments, the calls it makes)
SCENARIOS = {
    "all_complete": (dict(n_slots=4, max_len=64), _all_complete),
    "pause_threshold": (dict(n_slots=2, max_len=32, hrtt_ticks=2),
                        _pause_threshold),
    "slot_reuse": (dict(n_slots=2, max_len=32), _slot_reuse),
    "full_context": (dict(n_slots=2, max_len=32), _full_context),
    "heterogeneous": (dict(n_slots=2, max_len=32), heterogeneous(3)),
}


def model_pair(arch):
    jcfg = jconfigs.reduced(arch)
    jparams, _ = jmodel.init_model(jax.random.key(0), jcfg)
    tcfg = configs.reduced(arch)
    return jcfg, jparams, tcfg, params_from_jax(jax.device_get(jparams),
                                                tcfg)


def serve_both(pair, kwargs, scenario):
    """Run `scenario` on the JAX server and on the port's; assert the same
    tokens per request, the same verdicts and equal stats. Returns the
    port's {rid: tokens}."""
    jcfg, jparams, tcfg, tparams = pair
    jsrv = jserving.BFCServer(jcfg, jparams, **kwargs)
    tsrv = serving.BFCServer(tcfg, tparams, **kwargs)
    jdone, jverdicts = scenario(jserving, jsrv)
    tdone, tverdicts = scenario(serving, tsrv)
    want = {r.rid: r.out for r in jdone}
    got = {r.rid: r.out for r in tdone}
    assert got == want
    assert tverdicts == jverdicts
    assert dataclasses.asdict(tsrv.stats) == dataclasses.asdict(jsrv.stats)
    assert np.array_equal(tsrv.kv_len, jsrv.kv_len)
    return got


@pytest.fixture(scope="module")
def phi3():
    return model_pair("phi3-mini-3.8b")


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_phi3_server_matches_jax(phi3, scenario):
    kwargs, calls = SCENARIOS[scenario]
    got = serve_both(phi3, kwargs, calls)
    assert got, "no request completed"
    if scenario == "heterogeneous":
        # attention masks by kv_len: arrival time does not matter
        assert got[0] == got[1]

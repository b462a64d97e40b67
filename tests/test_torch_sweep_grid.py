"""`repro_torch.sim.sweep.run_grid` against the JAX package's `run_grid`
on the CPU: two protocol variants (`bfc`, `dctcp`) over two fabrics of
different shapes, interleaved in the case list. The port groups the cases
by protocol into two batched runs and must return the results in case
order, each with JAX's trimmed state, emits and `RunMetrics`, exactly."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.sim import sweep as jsweep  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.sim import sweep as tsweep  # noqa: E402
from test_torch_sweep import CLOS_A, CLOS_B, cases  # noqa: E402

pytestmark = pytest.mark.tier1

GRID = [(proto, clos, seed) for clos, seed in ((CLOS_A, 4), (CLOS_B, 5))
        for proto in ("bfc", "dctcp")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid(pkg):
    out = []
    for proto, clos, seed in GRID:
        (topo, flows, cfg), = cases(pkg, [(clos, seed)], proto)
        out.append((f"{proto}_{clos['n_servers']}srv_s{seed}", cfg, flows,
                    topo))
    return out


def _assert_metrics_equal(got, want, label):
    for field in dataclasses.fields(want):
        a, b = getattr(want, field.name), getattr(got, field.name)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert np.array_equal(np.asarray(a), np.asarray(b)), \
                f"{label} {field.name}"
        elif isinstance(a, float) and np.isnan(a):
            assert np.isnan(b), f"{label} {field.name}"
        else:
            assert a == b, f"{label} {field.name}: {b!r} != {a!r}"


@pytest.mark.slow
def test_run_grid_matches_jax_in_case_order():
    jg, tg = _grid("jax"), _grid("torch")
    n_ticks = int(max(f.horizon for _, _, f, _ in jg) + 1100)
    want = jsweep.run_grid(jg[0][3], [c[:3] for c in jg], n_ticks=n_ticks)
    got = tsweep.run_grid(tg[0][3], [c[:3] for c in tg], n_ticks=n_ticks,
                          device="cpu")
    assert [r.label for r in got] == [c[0] for c in tg]
    assert [r.proto for r in got] == [p for p, _, _ in GRID]
    for g, w in zip(got, want):
        testing.assert_state_equal(g.state, w.state, g.label)
        np.testing.assert_array_equal(g.emits, np.asarray(w.emits),
                                      err_msg=g.label)
        _assert_metrics_equal(g.metrics, w.metrics, g.label)
        assert g.metrics.completed > 0, g.label
        assert 0 < g.active_ticks <= n_ticks, g.label

"""Whole runs through `repro_torch.sim.engine.run` against
`repro.sim.engine.run` on the CPU: the final state (every leaf, float32
leaves included) and every emit row must be equal bit for bit.

The horizon is long enough that the active-horizon runner exits early and
rebuilds a ~4500-tick quiescent tail in closed form: the utilization EWMA
decays through the float32 denormal range (which the reference flushes to
zero), the rate-limited NICs refill their token buckets and the epoch
timers run on."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.sim import config as jconfig  # noqa: E402
from repro.sim import engine as jengine  # noqa: E402
from repro.sim import sweep as jsweep  # noqa: E402
from repro.sim.trace import golden as jgolden  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.sim import config as tconfig  # noqa: E402
from repro_torch.sim import engine as tengine  # noqa: E402
from repro_torch.sim import workload as twork  # noqa: E402
from repro_torch.sim.trace import golden as tgolden  # noqa: E402

pytestmark = pytest.mark.tier1

N_TICKS = 6000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["bfc", "dcqcn", "fairq"])
def test_full_run_matches_jax(name):
    topo, flows = jgolden.golden_case()
    flows = jsweep.pad_flowset(flows, 64)
    jcfg = jconfig.SimConfig(proto=jconfig.PRESETS[name],
                             clos=jgolden.golden_cfg(jconfig.BFC).clos,
                             probe_flow=0)
    j_st, j_em = jengine.run(topo, flows, jcfg, N_TICKS)

    t_topo, t_flows = tgolden.golden_case()
    t_flows = twork.pad_flowset(t_flows, 64)
    tcfg = tconfig.SimConfig(proto=tconfig.PRESETS[name],
                             clos=tgolden.golden_clos(), probe_flow=0)
    t_st, t_em = tengine.run(t_topo, t_flows, tcfg, N_TICKS, device="cpu")
    testing.assert_state_equal(t_st, j_st, name)
    np.testing.assert_array_equal(t_em, j_em)
    assert int(t_st.t) == N_TICKS and (t_st.done[:flows.n_flows] >= 0).any()
    if name == "bfc":
        # the decayed utilization estimate reached zero through the
        # flushed denormal range
        assert (t_st.tx_ewma == 0).all()

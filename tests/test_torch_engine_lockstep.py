"""The port's step against the JAX package's jitted step, tick by tick
(part 1; test_torch_engine_lockstep_part2.py runs more families through
`lockstep` below).

Both engines start from the same operands (the JAX package's packed
FlowOperands / TopoOperands, carried across with `repro_torch.testing`)
on the golden micro-case, and step side by side for 300 ticks on the CPU.
After every tick every `SimState` leaf -- float32 congestion-control
leaves included -- and the emit row (with all trace channels) must be bit
for bit equal. The JAX step runs its inline lax decision path
(`kernel_impl="lax"`); the port's step runs the plain version of the
fused switch step."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.sim import config as jconfig  # noqa: E402
from repro.sim import engine as jengine  # noqa: E402
from repro.sim import sweep as jsweep  # noqa: E402
from repro.sim import topology as jtopo  # noqa: E402
from repro.sim.trace import golden as jgolden  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.sim import config as tconfig  # noqa: E402
from repro_torch.sim import engine as tengine  # noqa: E402
from repro_torch.sim import topology as ttopo  # noqa: E402
from repro_torch.sim.trace import golden as tgolden  # noqa: E402

pytestmark = pytest.mark.tier1

N_TICKS = 300
# bfc: Q=32, Bloom backpressure, dynamic queues. dcqcn: Q=1, float CC
# leaves, ECN hash marking, PFC. bfc_srf / bfc_dest: the SRF key
# scatter-min and dest-keyed queues.
FAMILIES = ["bfc", "dcqcn", "bfc_srf", "bfc_dest"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lockstep(name):
    """Step both engines N_TICKS ticks on the golden case of family `name`
    and assert every state leaf and emit row equal after every tick."""
    topo, flows = jgolden.golden_case()
    flows = jsweep.pad_flowset(flows, tgolden.GOLDEN_PAD_FLOWS)
    jcfg = jgolden.golden_cfg(jconfig.PRESETS[name])
    assert jcfg.proto.kernel_impl == "lax"
    dims = jtopo.TopoDims.of(topo)
    j_init, j_step = jengine.make_step(dims, jcfg, flows.n_flows)
    j_step = jax.jit(j_step)
    j_ops = jengine.pack_flows(flows, jcfg)
    j_topo = jtopo.pack_topo(topo, infinite_buffer=jcfg.proto.infinite_buffer)

    t_ops = testing.flow_operands_from_numpy(jax.device_get(j_ops))
    t_topo = testing.topo_operands_from_numpy(jax.device_get(j_topo))
    tcfg = tgolden.golden_cfg(tconfig.PRESETS[name])
    _, t_init, t_step = tengine.make_step(ttopo.TopoDims(*dims), tcfg,
                                          flows.n_flows, "cpu")

    j_st = j_init()
    t_st = t_init()
    testing.assert_state_equal(t_st, jax.device_get(j_st), f"{name} init")
    for tick in range(N_TICKS):
        j_st, j_row = j_step(j_st, j_ops, j_topo)
        t_st, t_row = t_step(t_st, t_ops, t_topo)
        testing.assert_state_equal(t_st, jax.device_get(j_st),
                                   f"{name} after tick {tick}")
        np.testing.assert_array_equal(t_row.numpy(), np.asarray(j_row),
                                      err_msg=f"{name} emit row {tick}")
    # the run did real work: packets were delivered and flows completed
    assert int(t_st.delivered.sum()) > 0 and int((t_st.done >= 0).sum()) > 0


@pytest.mark.parametrize("name", FAMILIES)
def test_port_step_matches_jax_step(name):
    lockstep(name)


def test_state_roundtrip_and_difference_report():
    """`state_from_numpy` / `state_to_numpy` keep every leaf's dtype and
    value; `assert_state_equal` names the first differing leaf and
    index."""
    topo, flows = jgolden.golden_case()
    jcfg = jgolden.golden_cfg(jconfig.BFC)
    j_init, _ = jengine.make_step(jtopo.TopoDims.of(topo), jcfg,
                                  flows.n_flows)
    host = jax.device_get(j_init())
    back = testing.state_to_numpy(testing.state_from_numpy(host))
    testing.assert_state_equal(back, host)
    for name in tengine.SimState._fields:
        assert getattr(back, name).dtype == np.asarray(
            getattr(host, name)).dtype, name
    bad = back._replace(cwnd=back.cwnd.copy())
    bad.cwnd[3] = np.nextafter(bad.cwnd[3], np.float32(0))
    with pytest.raises(AssertionError, match=r"cwnd: first difference at "
                       r"\(3,\)"):
        testing.assert_state_equal(bad, host)

"""The port's batched lane axis (`repro_torch.sim.sweep`) against the JAX
package's vmapped sweep, exact, on the CPU (part 1; the _part2, _flat,
_grid and _derive files hold more).

The port lays a batch's K lanes side by side as one larger fabric (the
lane offsets are put into the id tables when the batch is stacked). One
`bfc` batch mixes three fabrics of `tests/test_sim_topo_sweep.py`
(CLOS_A; CLOS_B with more ports, servers and switches and a 1024-packet
buffer; CLOS_FAST with 4-tick links against 12), so ports, servers,
switches and the wire ring are padded, and the link delay, the buffer
limit and the occupancy reference are per-lane tables. The port's
`run_batch` must equal JAX's `sweep.run_batch` in every leaf of the padded
batched state (JAX's (K, ...) layout), in the emits and in the per-lane
active ticks; and each lane, trimmed by `select_config`, must equal its
own serial `engine.run` of the port. The horizon lets the lanes go
quiescent at different segment boundaries (per-lane quiescence), so the
batch steps lanes past their own active tick before the closed-form
tail."""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.sim import exec as jexec  # noqa: E402
from repro.sim import sweep as jsweep  # noqa: E402
from repro.sim import topology as jtopo  # noqa: E402
from repro.sim import workload as jwork  # noqa: E402
from repro.sim.config import PRESETS as JPRESETS  # noqa: E402
from repro.sim.config import SimConfig as JSimConfig  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.sim import engine as tengine  # noqa: E402
from repro_torch.sim import sweep as tsweep  # noqa: E402
from repro_torch.sim import topology as ttopo  # noqa: E402
from repro_torch.sim import workload as twork  # noqa: E402
from repro_torch.sim.config import PRESETS as TPRESETS  # noqa: E402
from repro_torch.sim.config import SimConfig as TSimConfig  # noqa: E402

pytestmark = pytest.mark.tier1

# the fabrics of tests/test_sim_topo_sweep.py
CLOS_A = dict(n_servers=8, n_tor=2, n_spine=2, switch_buffer_pkts=512)
CLOS_B = dict(n_servers=12, n_tor=2, n_spine=3, switch_buffer_pkts=1024)
CLOS_FAST = dict(n_servers=8, n_tor=2, n_spine=2, prop_ticks=4,
                 switch_buffer_pkts=512)
N_FLOWS = 40
# (fabric, workload seed) of each lane of the mixed batch
LANES = [(CLOS_A, 1), (CLOS_B, 2), (CLOS_FAST, 3)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cases(pkg, lanes=LANES, proto="bfc", proto_kw=None, **cfg):
    """[(topo, flows, cfg)] of `lanes` in the JAX package ("jax") or the
    port ("torch"): fb_hadoop at load 0.5, N_FLOWS flows, seeded; the
    preset `proto` with the fields of `proto_kw` replaced."""
    topo_m, work_m, presets, sim_config = (
        (jtopo, jwork, JPRESETS, JSimConfig) if pkg == "jax"
        else (ttopo, twork, TPRESETS, TSimConfig))
    out = []
    for clos, seed in lanes:
        params = topo_m.ClosParams(**clos)
        topo = topo_m.build(params)
        wp = work_m.WorkloadParams(workload="fb_hadoop", load=0.5, seed=seed)
        out.append((topo, work_m.generate(topo, wp, N_FLOWS),
                    sim_config(proto=replace(presets[proto],
                                             **(proto_kw or {})),
                               clos=params,
                               **cfg.get(pkg, {}))))
    return out


def horizon(lanes=LANES) -> int:
    return max(f.horizon for _, f, _ in cases("torch", lanes))


def run_jax(n_ticks, lanes=LANES, early_exit=True, **cfg):
    """JAX's run_batch: (state, emits, per-lane active ticks), host numpy.
    JAX's execution tier splits the trace channels off the emits
    (`exec.last_trace`); they are put back beside them, as the port's
    `run_batch` returns them."""
    jc = cases("jax", lanes, **cfg)
    st, em = jsweep.run_batch([t for t, _, _ in jc], [f for _, f, _ in jc],
                              jc[0][2], n_ticks, early_exit=early_exit)
    em = np.asarray(em)
    if jexec.last_trace() is not None:
        em = np.concatenate([em, jexec.last_trace()[0]], axis=2)
    return (jax.device_get(st), em, np.asarray(jexec.last_active_ticks()))


def run_port(n_ticks, lanes=LANES, early_exit=True, **cfg):
    """The port's run_batch on the CPU, as `run_jax`."""
    tc = cases("torch", lanes, **cfg)
    st, em = tsweep.run_batch([t for t, _, _ in tc], [f for _, f, _ in tc],
                              tc[0][2], n_ticks, device="cpu",
                              early_exit=early_exit)
    return st, em, tsweep.last_active_ticks()


def assert_batch_equal(port_run, jax_run, what):
    (t_st, t_em, t_act), (j_st, j_em, j_act) = port_run, jax_run
    testing.assert_state_equal(t_st, j_st, what)
    np.testing.assert_array_equal(t_em, j_em, err_msg=f"{what} emits")
    assert t_act.tolist() == j_act.tolist(), f"{what} active ticks"


@pytest.fixture(scope="module")
def mixed_batch():
    n_ticks = horizon() + 2000
    return run_port(n_ticks), run_jax(n_ticks), n_ticks


def test_mixed_batch_matches_jax_run_batch(mixed_batch):
    port_run, jax_run, n_ticks = mixed_batch
    assert_batch_equal(port_run, jax_run, "mixed bfc batch")
    t_st, t_em, t_act = port_run
    # padded to the union of the fabrics: CLOS_B's ports and CLOS_A's
    # 12-tick wire ring
    assert t_st.qtail.shape[:2] == (3, ttopo.build(
        ttopo.ClosParams(**CLOS_B)).n_ports)
    assert t_st.wire_f.shape[2] == 12 and t_em.shape == (3, n_ticks, 3)
    # the lanes went quiescent at different boundaries, all before the end
    assert len(set(t_act.tolist())) == 3 and max(t_act) < n_ticks
    assert (t_st.delivered.sum(1) > 0).all()


@pytest.mark.slow
def test_each_lane_matches_its_serial_run(mixed_batch):
    (t_st, t_em, t_act), _, n_ticks = mixed_batch
    for k, (topo, flows, cfg) in enumerate(cases("torch")):
        dims = ttopo.TopoDims.of(topo)
        with torch.inference_mode():
            st, em, act = tengine.simulate(
                dims, cfg, tengine.pack_flows(flows, cfg, "cpu"),
                ttopo.pack_topo(topo, device="cpu"), n_ticks)
        got = tsweep.select_config(t_st, k, flows.n_flows, dims)
        testing.assert_state_equal(
            got, tsweep.trim_state(tengine.to_numpy(st), flows.n_flows,
                                   dims), f"lane {k}")
        np.testing.assert_array_equal(t_em[k], em.numpy(),
                                      err_msg=f"lane {k} emits")
        assert t_act[k] == act, f"lane {k} active ticks"
        assert (got.done >= 0).all(), f"lane {k} left flows unfinished"

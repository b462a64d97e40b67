"""The port's fused switch step (`derive_ref`, the plain version of the
kernel's derive mode) against the JAX package's phase 0 on states stepped
from the golden case, exact; and the function the engine captures as a
CUDA graph (`TickGraph`: chained steps, copy-back into the static state,
rows into the static buffer), run eagerly on the CPU, against the per-tick
runner (`TickLoop`), every leaf and emit row equal. The kernel itself is
held against `derive_ref` on the card in test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.bfc_step import ref as jref  # noqa: E402
from repro.sim import config as jconfig  # noqa: E402
from repro.sim import engine as jengine  # noqa: E402
from repro.sim import phases as jphases  # noqa: E402
from repro.sim import sweep as jsweep  # noqa: E402
from repro.sim import topology as jtopo  # noqa: E402
from repro.sim.trace import golden as jgolden  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.kernels.bfc_step import ops as kernel_ops  # noqa: E402
from repro_torch.sim import config as tconfig  # noqa: E402
from repro_torch.sim import engine as tengine  # noqa: E402
from repro_torch.sim import phases as tphases  # noqa: E402
from repro_torch.sim import topology as ttopo  # noqa: E402
from repro_torch.sim import workload as tworkload  # noqa: E402
from repro_torch.sim.trace import golden as tgolden  # noqa: E402

pytestmark = pytest.mark.tier1

CHECK_TICKS = (0, 150, 300)
DERIVE_FIELDS = ("occ", "port_occ", "sw_occ", "qpaused", "th", "pfc_paused",
                 "rem_src")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eq(got, want, what):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    np.testing.assert_array_equal(got, want, err_msg=what)


# bfc: Q=32 with Bloom backpressure; bfc_srf: the SRF key; bfc_pfc and
# pfc: PFC hysteresis (Q=32 and Q=1); ideal_fq: Q=64, no backpressure
@pytest.mark.parametrize("name", ["bfc", "bfc_srf", "bfc_pfc", "pfc",
                                  "ideal_fq"])
def test_derive_ref_matches_jax_derive(name):
    topo, flows = jgolden.golden_case()
    flows = jsweep.pad_flowset(flows, tgolden.GOLDEN_PAD_FLOWS)
    jcfg = jgolden.golden_cfg(jconfig.PRESETS[name])
    assert jcfg.proto.kernel_impl == "lax"
    dims = jtopo.TopoDims.of(topo)
    j_init, j_step = jengine.make_step(dims, jcfg, flows.n_flows)
    j_step = jax.jit(j_step)
    j_ops = jengine.pack_flows(flows, jcfg)
    j_topo = jtopo.pack_topo(topo, infinite_buffer=jcfg.proto.infinite_buffer)
    j_env = jphases.make_env(dims, jcfg, flows.n_flows)

    t_ops = testing.flow_operands_from_numpy(jax.device_get(j_ops))
    t_topo = testing.topo_operands_from_numpy(jax.device_get(j_topo))
    tcfg = tgolden.golden_cfg(tconfig.PRESETS[name])
    t_env = tphases.make_env(ttopo.TopoDims(*dims), tcfg, flows.n_flows,
                             "cpu")
    pc = jcfg.proto

    j_st = j_init()
    kernel_ops.reset_launches()
    busy = 0
    for tick in range(CHECK_TICKS[-1] + 1):
        if tick in CHECK_TICKS:
            want = jphases.derive(j_env, j_st, j_ops, j_topo)
            t_st = testing.state_from_numpy(jax.device_get(j_st))
            got = tphases.derive(t_env, t_st, t_ops, t_topo)
            what = f"{name} tick {tick}"
            for field in DERIVE_FIELDS:
                _eq(getattr(got, field), getattr(want, field),
                    f"{what} {field}")
            blocked = want.pfc_paused | j_topo.port_is_nic
            srf_key = (jnp.minimum(j_st.qsrf, jref.BIG)
                       if pc.scheduler == "srf" else None)
            _, th, _, sel, can_tx, occ_after = jref.bfc_fused_ref(
                want.occ, want.qpaused, j_st.qptr, blocked,
                pause_window=jcfg.timing.pause_window,
                scheduler=pc.scheduler, srf_key=srf_key)
            _eq(got.th, th, f"{what} th (bfc_fused_ref)")
            _eq(got.ksel_q, sel, f"{what} ksel_q")
            _eq(got.kcan_tx, can_tx, f"{what} kcan_tx")
            _eq(got.kocc_after, occ_after, f"{what} kocc_after")
            busy += int(got.occ.sum())
        j_st, _ = j_step(j_st, j_ops, j_topo)
    assert busy > 0                     # the checked states hold packets
    assert kernel_ops.launches == {"bfc_fused": 0, "bfc_decide": 0}


def _golden_run(name):
    topo, flows = tgolden.golden_case()
    flows = tworkload.pad_flowset(flows, tgolden.GOLDEN_PAD_FLOWS)
    cfg = tgolden.golden_cfg(tconfig.PRESETS[name])
    dims = ttopo.TopoDims.of(topo)
    fops = tengine.pack_flows(flows, cfg, "cpu")
    tops = ttopo.pack_topo(topo, infinite_buffer=cfg.proto.infinite_buffer,
                           device="cpu")
    return dims, cfg, fops, tops


# horizons a multiple of neither GRAPH_TICKS nor DEFAULT_SEGMENT; the
# segment of 100 leaves eager ticks inside the run, which are copied back
# into the static state before the next replay
@pytest.mark.parametrize("name,n_ticks,segment", [
    ("bfc", 600, tengine.DEFAULT_SEGMENT), ("dcqcn", 650, 100)])
def test_graph_body_matches_per_tick_runner(name, n_ticks, segment):
    dims, cfg, fops, tops = _golden_run(name)
    assert n_ticks % tengine.GRAPH_TICKS and n_ticks % segment
    out = {}
    with torch.inference_mode():
        for runner in (tengine.TickLoop, tengine.TickGraph):
            env, init_state, step = tengine.make_step(dims, cfg,
                                                      fops.arrival.shape[0],
                                                      "cpu")
            emits = torch.zeros((n_ticks, tengine.emit_width(cfg, dims)),
                                dtype=torch.int32)
            ticks = runner(step, init_state(), fops, tops, emits)
            out[runner] = tengine.run_ticks(env, ticks, step, fops, tops,
                                            n_ticks, segment)
    (st_a, em_a, act_a), (st_b, em_b, act_b) = out.values()
    assert act_a == act_b == n_ticks
    testing.assert_state_equal(st_b, testing.state_to_numpy(st_a),
                               f"{name} graph body vs per-tick")
    np.testing.assert_array_equal(em_b.numpy(), em_a.numpy())
    assert int(st_a.delivered.sum()) > 0


def test_copy_state_is_one_simultaneous_assignment():
    """A source leaf that is another destination leaf is read before that
    leaf is overwritten (a swap); a source that is its own destination is
    left alone."""
    a, b, c = torch.arange(3), torch.arange(3) + 10, torch.arange(3) + 20
    dst = (a, b, c)
    tengine.copy_state(dst, (b, a[:], c))
    assert a.tolist() == [10, 11, 12] and b.tolist() == [0, 1, 2]
    assert c.tolist() == [20, 21, 22]

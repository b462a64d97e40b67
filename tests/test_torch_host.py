"""Port parity of the host-side inputs: topology, packed operands,
workload generation, phantom padding, configuration presets and the
metrics summary, against the JAX package, exact."""
from dataclasses import fields

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.sim import config as jconfig  # noqa: E402
from repro.sim import engine as jengine  # noqa: E402
from repro.sim import metrics as jmetrics  # noqa: E402
from repro.sim import sweep as jsweep  # noqa: E402
from repro.sim import topology as jtopo  # noqa: E402
from repro.sim import workload as jwork  # noqa: E402
from repro.sim.trace import golden as jgolden  # noqa: E402
from repro_torch.sim import config as tconfig  # noqa: E402
from repro_torch.sim import engine as tengine  # noqa: E402
from repro_torch.sim import metrics as tmetrics  # noqa: E402
from repro_torch.sim import topology as ttopo  # noqa: E402
from repro_torch.sim import workload as twork  # noqa: E402
from repro_torch.sim.trace import golden as tgolden  # noqa: E402

pytestmark = pytest.mark.tier1

# (clos kwargs, workload kwargs, n_flows): the golden micro-case and the
# paper's 128-server / 8 ToR / 8 spine fabric at fb_hadoop load 0.6
CASES = {
    "golden": (dict(n_servers=8, n_tor=2, n_spine=2, switch_buffer_pkts=512),
               dict(workload="uniform", load=0.6, seed=11, incast_load=0.15,
                    incast_degree=6, incast_total_kb=1024), 24),
    "paper": (dict(n_servers=128, n_tor=8, n_spine=8),
              dict(workload="fb_hadoop", load=0.6, seed=0), 4000),
    "locality_long_lived": (dict(n_servers=16, n_tor=4, n_spine=2),
                            dict(workload="websearch", load=0.4, seed=3,
                                 locality=0.3), 200),
}


def _case(name):
    clos, wp, n = CASES[name]
    jt = jtopo.build(jtopo.ClosParams(**clos))
    tt = ttopo.build(ttopo.ClosParams(**clos))
    ll = 2 if name == "locality_long_lived" else 0
    jf = jwork.generate(jt, jwork.WorkloadParams(**wp), n, long_lived=ll)
    tf = twork.generate(tt, twork.WorkloadParams(**wp), n, long_lived=ll)
    return jt, tt, jf, tf


def _assert_same_fields(a, b, names):
    for name in names:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, np.ndarray) or hasattr(x, "shape"):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(y, x, err_msg=name)
        else:
            assert x == y, name


@pytest.mark.parametrize("name", sorted(CASES))
def test_topology_and_workload_match_jax(name):
    jt, tt, jf, tf = _case(name)
    _assert_same_fields(jt, tt, ["n_ports", "n_switches", "port_switch",
                                 "port_is_nic", "nic_base", "tor_base",
                                 "spine_base"])
    _assert_same_fields(jf, tf, [f.name for f in fields(jwork.FlowSet)])
    assert ttopo.TopoDims.of(tt) == tuple(jtopo.TopoDims.of(jt))


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("infinite", [False, True])
def test_packed_operands_match_jax(name, infinite):
    jt, tt, jf, tf = _case(name)
    want = jtopo.pack_topo(jt, infinite_buffer=infinite)
    got = ttopo.pack_topo(tt, infinite_buffer=infinite, device="cpu")
    for field in jtopo.TopoOperands._fields:
        w, g = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    cfg_j = jconfig.SimConfig(proto=jconfig.BFC)
    cfg_t = tconfig.SimConfig(proto=tconfig.BFC)
    want = jengine.pack_flows(jf, cfg_j)
    got = tengine.pack_flows(tf, cfg_t, "cpu")
    for field in jengine.FlowOperands._fields:
        w, g = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=field)


def test_padded_topology_matches_jax():
    jt, tt, _, _ = _case("golden")
    dims = jtopo.TopoDims(n_ports=40, n_servers=12, n_switches=6,
                          prop_max=20)
    want = jtopo.pack_topo(jt, dims=dims)
    got = ttopo.pack_topo(tt, dims=ttopo.TopoDims(*dims), device="cpu")
    for field in jtopo.TopoOperands._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    with pytest.raises(ValueError):
        ttopo.pack_topo(tt, dims=ttopo.TopoDims(4, 4, 4, 4), device="cpu")


def test_pad_flowset_matches_jax():
    _, _, jf, tf = _case("golden")
    want, got = jsweep.pad_flowset(jf, 64), twork.pad_flowset(tf, 64)
    _assert_same_fields(want, got, [f.name for f in fields(jwork.FlowSet)])
    assert twork.PHANTOM_ARRIVAL == jengine.PHANTOM_ARRIVAL
    with pytest.raises(ValueError):
        twork.pad_flowset(tf, 3)


def test_presets_match_jax_field_by_field():
    assert sorted(tconfig.PRESETS) == sorted(jconfig.PRESETS)
    port_fields = {f.name for f in fields(tconfig.ProtoConfig)}
    assert {f.name for f in fields(jconfig.ProtoConfig)} - port_fields \
        == {"kernel_impl"}
    for name, jp in jconfig.PRESETS.items():
        tp = tconfig.PRESETS[name]
        for field in port_fields:
            assert getattr(tp, field) == getattr(jp, field), (name, field)
    for cls in ("TimingParams", "SimConfig"):
        jf = [(f.name, f.default) for f in fields(getattr(jconfig, cls))]
        tf = [(f.name, f.default) for f in fields(getattr(tconfig, cls))]
        assert [n for n, _ in jf] == [n for n, _ in tf], cls
    assert tconfig.TimingParams().pause_window == \
        jconfig.TimingParams().pause_window


def test_workload_helpers_match_jax():
    rng_j, rng_t = np.random.default_rng(5), np.random.default_rng(5)
    for wl in ("google", "fb_hadoop", "websearch", "uniform"):
        np.testing.assert_array_equal(twork.sample_sizes(rng_t, 500, wl),
                                      jwork.sample_sizes(rng_j, 500, wl))
    assert twork.mean_size_pkts("google", n=2000) == \
        jwork.mean_size_pkts("google", n=2000)


def test_summarize_matches_jax():
    """`metrics.summarize` on one synthetic host state gives the same
    RunMetrics in both packages."""
    _, _, jf, tf = _case("golden")
    rng = np.random.default_rng(7)
    F = jf.n_flows
    done = np.where(rng.random(F) < 0.8,
                    jf.arrival_tick + rng.integers(1, 500, F), -1)
    state = {name: np.int32(rng.integers(0, 9)) for name in
             ("stat_drops", "stat_collisions", "stat_allocs",
              "stat_overflow", "stat_pauses")}
    state.update(done=done.astype(np.int32),
                 occ_hist=rng.integers(0, 9, 64).astype(np.int32),
                 qlen_hist=rng.integers(0, 9, 64).astype(np.int32),
                 flows_hist=rng.integers(0, 9, 65).astype(np.int32))
    st = type("St", (), state)
    emits = rng.integers(0, 300, (2048, 3)).astype(np.int32)
    kw = dict(n_links=24, occ_bin_ref=512, cap=256)
    for incast_only in (False, True):
        want = jmetrics.summarize("x", st, emits, jf, incast_only=incast_only,
                                  **kw)
        got = tmetrics.summarize("x", st, emits, tf, incast_only=incast_only,
                                 **kw)
        for field in fields(jmetrics.RunMetrics):
            w, g = getattr(want, field.name), getattr(got, field.name)
            if isinstance(w, np.ndarray):
                np.testing.assert_array_equal(g, w, err_msg=field.name)
            elif isinstance(w, float) and np.isnan(w):
                assert np.isnan(g), field.name
            else:
                assert g == w, field.name


def test_golden_pin_matches_jax():
    """The port's copy of the pinned golden case is the JAX package's."""
    assert tgolden.pinned_meta() == jgolden.pinned_meta()
    assert tgolden.GOLDEN_N_TICKS == jgolden.GOLDEN_N_TICKS
    assert tgolden.FIXTURE_DIR == jgolden.FIXTURE_DIR


def test_profile_breakdown_sums_device_time(capsys):
    """The profilers' report: busy time, idle share and top kernels per
    step from (name, device µs) pairs; no kernels is a failure."""
    from repro_torch.sim import tick_profile
    kernels = [("a", 100.0), ("b", 300.0), ("a", 100.0)]
    assert tick_profile.print_breakdown("tick", kernels, 2, 1e-3)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("tick: per step wall 0.500 ms, device busy 0.250 ms, "
                      "idle share 0.5000, 1.5 kernels")
    assert [line.split() for line in out[2:]] == [
        ["0.1500", "0.600", "0.50", "b"], ["0.1000", "0.400", "1.00", "a"]]
    assert not tick_profile.print_breakdown("tick", [], 1, 1.0)

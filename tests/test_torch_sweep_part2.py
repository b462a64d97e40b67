"""The port's batched lane axis against the JAX package's sweep (part 2).

* A lane permutation: the mixed batch of test_torch_sweep.py with its
  lanes reversed equals JAX's forward batch, lane for lane reversed. A
  drop index offset like an id (`where(mask, x, F|P|NSRV)` must be the
  batch total), or a `clamp(min=0)` of a -1 route or switch that reads
  lane 0's row unmasked, lands in a neighbouring lane; reversing the
  lanes moves every neighbour, so such a leak cannot match both orders.
* `pairwise_rank` ranks within each lane's block of ports, as JAX ranks
  each lane alone; the packed keys (the arrival sort key among them) are
  checked against int32 when the batch is made.
* The stacked fabric tables: per-lane scalars stay 0-d when the lanes
  agree and become (K,) tables when they differ; ids move by their lane.
* The host-side helpers (`padded_count`, `pad_flowset`, `batch_dims`,
  `lane_state_bytes`, `trim_state`) against JAX's values."""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.sim import engine as jengine  # noqa: E402
from repro.sim import sweep as jsweep  # noqa: E402
from repro.sim.phases.ctx import pairwise_rank as jpairwise_rank  # noqa
from repro.sim.trace import TraceSpec as JTraceSpec  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.sim import phases as tphases  # noqa: E402
from repro_torch.sim import sweep as tsweep  # noqa: E402
from repro_torch.sim import topology as ttopo  # noqa: E402
from repro_torch.sim import workload as twork  # noqa: E402
from repro_torch.sim.trace.spec import TraceSpec as TTraceSpec  # noqa: E402
from test_torch_sweep import (LANES, cases, horizon, run_jax,  # noqa: E402
                              run_port)

pytestmark = pytest.mark.tier1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.slow
def test_reversed_lanes_give_reversed_results():
    n_ticks = horizon() + 1200
    j_st, j_em, j_act = run_jax(n_ticks)
    r_st, r_em, r_act = run_port(n_ticks, lanes=LANES[::-1])
    back = type(r_st)(*(np.ascontiguousarray(leaf[::-1]) for leaf in r_st))
    testing.assert_state_equal(back, j_st, "reversed batch, lanes reversed")
    np.testing.assert_array_equal(r_em[::-1], j_em)
    assert r_act[::-1].tolist() == j_act.tolist()


@pytest.mark.parametrize("lanes,n", [(1, 7), (3, 7), (4, 16)])
def test_pairwise_rank_stays_within_each_lane(lanes, n):
    rng = np.random.default_rng(lanes * n)
    keys = rng.integers(0, 3, lanes * n).astype(np.int32)
    valid = rng.random(lanes * n) < 0.7
    p = torch.arange(n, dtype=torch.int32)
    got = tphases.pairwise_rank(torch.from_numpy(keys),
                                torch.from_numpy(valid),
                                p[None, :] < p[:, None])
    want = np.concatenate([np.asarray(jpairwise_rank(
        jnp.asarray(keys[k * n:(k + 1) * n]),
        jnp.asarray(valid[k * n:(k + 1) * n]))) for k in range(lanes)])
    np.testing.assert_array_equal(got.numpy(), want)


def test_make_env_refuses_keys_past_int32():
    (topo, _, cfg), = cases("torch", LANES[:1])
    dims = ttopo.TopoDims.of(topo)
    tphases.make_env(dims, cfg, 64, "cpu", lanes=4)
    with pytest.raises(ValueError, match="overflow int32"):
        tphases.make_env(dims, cfg, 64, "cpu", lanes=1 << 20)
    with pytest.raises(ValueError, match="packed"):
        tphases.make_env(dims, cfg, 1 << 15, "cpu", lanes=4)


def test_stacked_fabric_tables():
    tc = cases("torch")
    topos = [t for t, _, _ in tc]
    dims = tsweep.batch_dims(topos)
    ops = tsweep.stack_topos(topos, tc[0][2], dims, "cpu")
    P, NSW = dims.n_ports, dims.n_switches
    # CLOS_A and CLOS_FAST buffer 512 packets, CLOS_B 1024; prop 12/12/4
    assert ops.buffer_limit.tolist() == [512, 1024, 512]
    assert ops.occ_ref.tolist() == [512, 1024, 512]
    assert ops.prop_ticks.tolist() == [12, 12, 4]
    for k, topo in enumerate(topos):
        own = ttopo.pack_topo(topo, dims=dims, device="cpu")
        for name in ("port_switch", "feeds"):
            lane = getattr(ops, name)[k * P:(k + 1) * P]
            want = getattr(own, name)
            assert torch.equal(lane, torch.where(want >= 0, want + k * NSW,
                                                 want)), (k, name)
    same = tsweep.stack_topos(topos[:1] * 2, tc[0][2], dims, "cpu")
    assert same.buffer_limit.dim() == same.prop_ticks.dim() == 0
    flows = [f for _, f, _ in tc]
    fops = tsweep.stack_operands(flows, tc[0][2], 64, dims, "cpu")
    for k, f in enumerate(flows):
        routes = fops.routes[k * 64:k * 64 + f.n_flows]
        want = torch.from_numpy(f.routes)
        assert torch.equal(routes, torch.where(want >= 0, want + k * P,
                                               want))
        assert (fops.routes[k * 64 + f.n_flows:(k + 1) * 64] == -1).all()
        assert torch.equal(fops.dst[k * 64:k * 64 + f.n_flows],
                           torch.from_numpy(f.dst))       # lane-local


@pytest.mark.parametrize("lanes", [slice(0, 1), slice(1, 3), slice(0, 3)])
def test_padding_helpers_match_jax(lanes):
    jc, tc = cases("jax")[lanes], cases("torch")[lanes]
    j_flows, t_flows = [f for _, f, _ in jc], [f for _, f, _ in tc]
    f_max = tsweep.padded_count(t_flows)
    assert f_max == jsweep.padded_count(j_flows) == tsweep.PAD_MULTIPLE \
        * -(-max(f.n_flows for f in t_flows) // tsweep.PAD_MULTIPLE)
    j_dims = jsweep.batch_dims([t for t, _, _ in jc])
    t_dims = tsweep.batch_dims([t for t, _, _ in tc])
    assert tuple(t_dims) == tuple(j_dims)
    for jf, tf in zip(j_flows, t_flows):
        jp, tp = jsweep.pad_flowset(jf, f_max), twork.pad_flowset(tf, f_max)
        for name in ("src", "dst", "size_pkts", "arrival_tick", "routes",
                     "ideal_fct", "fid", "is_incast"):
            a, b = np.asarray(getattr(jp, name)), getattr(tp, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        assert tp.horizon == jp.horizon and tp.n_flows == f_max
    # lane_state_bytes on the union dims, off and with every trace channel
    for j_spec, t_spec in ((JTraceSpec(), TTraceSpec()),
                           (JTraceSpec.full(), TTraceSpec.full())):
        j_cfg = replace(jc[0][2], trace=j_spec)
        t_cfg = replace(tc[0][2], trace=t_spec)
        for n_ticks in (0, 1000):
            want = jsweep.lane_state_bytes(j_dims, j_cfg, f_max, n_ticks)
            got = tsweep.lane_state_bytes(ttopo.TopoDims(*t_dims), t_cfg,
                                          f_max, n_ticks)
            assert got == want > 0


def test_trim_state_rotates_feedback_rings_like_jax():
    """A state padded to a longer wire ring and trimmed back: the port's
    `trim_state` gives JAX's leaves (the feedback rings re-indexed by the
    state's own tick)."""
    rng = np.random.default_rng(5)
    jc = cases("jax")
    topo, flows, cfg = jc[2]                       # CLOS_FAST, prop 4
    dims = jsweep.batch_dims([topo])._replace(prop_max=12)
    init, _ = jengine.make_step(dims, cfg, 64)
    st = jax.device_get(init())
    st = st._replace(**{
        name: rng.integers(0, 9, np.shape(getattr(st, name))).astype(
            np.asarray(getattr(st, name)).dtype)
        for name in ("ack_ring", "mark_ring", "sfc_ring", "wire_f",
                     "f_cnt", "qtail", "d_q", "bucket_cnt")})
    st = st._replace(t=np.int32(37))
    own = jsweep.batch_dims([topo])
    want = jsweep.trim_state(st, flows.n_flows, own)
    got = tsweep.trim_state(st, flows.n_flows, ttopo.TopoDims(*own))
    for name in want._fields:
        a, b = np.asarray(getattr(want, name)), getattr(got, name)
        assert a.shape == b.shape and np.array_equal(a, b), name
    with pytest.raises(ValueError, match="feedback ring"):
        tsweep.trim_state(st, flows.n_flows, ttopo.TopoDims(*dims)._replace(
            prop_max=40))

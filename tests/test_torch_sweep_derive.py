"""The fused switch step's plain version (`derive_ref`, the CPU path of the
kernel's derive mode) over a sweep batch, exact. In the port's layout a
batch is K fabrics laid side by side, so `derive_ref` needs no lane axis:
it is the same function on K*P rows, and only the buffer limit (one per
lane when the fabrics differ) sees the lanes. K lanes stacked by
`testing.stack_derive_lanes` (lane k's flow ids in qbuf moved by k*F, its
switch ids by k*NSW) in one call must equal each lane called alone, on
seeded states whose lanes have their own switch owners, fed switches, NIC
ports and buffer limits. The kernel is held against the same stacked
calls on the card in test_torch_cuda.py.

The seeded states hold what the simulator never makes: a non-NIC port that
no switch owns and a non-empty queue whose head slot is empty. The
reference adds the first to switch 0 and reads flow 0 for the second;
one lane alone is held against the JAX package's `derive` on such states,
so a stacked lane does the same with its own switch 0 and flow 0."""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import testing  # noqa: E402
from repro_torch.kernels.bfc_step import ref as tref  # noqa: E402

pytestmark = pytest.mark.tier1

FLAGS = {"bfc": (True, False), "bfc_pfc": (True, True),
         "pfc": (False, True)}        # backpressure, pfc
NSW = 16


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("scheduler", ["drr", "srf"])
@pytest.mark.parametrize("p,q,lanes", [(24, 32, 5), (97, 8, 3), (40, 1, 2),
                                       (24, 32, 1)])
def test_stacked_derive_ref_equals_each_lane_alone(p, q, lanes, scheduler,
                                                   flags):
    bp, pfc = FLAGS[flags]
    kw = dict(backpressure=bp, pfc=pfc, scheduler=scheduler, pfc_frac=0.11,
              pause_window=37)
    seeds = [1000 * p + q + k for k in range(lanes)]
    # odd lanes an infinite buffer, even lanes a tight one of their own
    alone = [testing.random_derive_inputs(
        seed, p, q, "cpu", buffer_limit=(1 << 29) if k % 2 else None)
        for k, seed in enumerate(seeds)]
    args = testing.stack_derive_lanes(alone, NSW)
    assert args[testing.DERIVE_ARGS.index("buffer_limit")].dim() == (
        0 if lanes == 1 else 1)
    got = tref.derive_ref(*args, n_switches=lanes * NSW, lanes=lanes, **kw)
    f = alone[0][testing.DERIVE_ARGS.index("fpos")].shape[0]
    rows = {"sw_occ": NSW, "rem_src": f}
    for k, lane_args in enumerate(alone):
        one = tref.derive_ref(*lane_args, n_switches=NSW, **kw)
        for name, g, w in zip(tref.DeriveOut._fields, got, one):
            n = rows.get(name, p)
            assert g.dtype == w.dtype, name
            assert torch.equal(g[k * n:(k + 1) * n], w), f"lane {k} {name}"
    if lanes > 1:       # the lanes differ: a lane's slice is not another's
        assert not torch.equal(got.kocc_after[:p], got.kocc_after[p:2 * p])


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("scheduler", ["drr", "srf"])
def test_derive_ref_matches_jax_derive_on_seeded_states(scheduler, flags):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.bfc_step import ref as jref
    from repro.sim import phases as jphases

    bp, pfc = FLAGS[flags]
    p, q = 97, 8
    args = testing.random_derive_inputs(7 + p, p, q, "cpu")
    qhead, qtail, qbuf = (x.numpy() for x in args[:3])
    slot = (qhead % qbuf.shape[2])[..., None]
    blank = ((qtail - qhead) > 0) & (np.arange(p * q).reshape(p, q) % 5 == 0)
    np.put_along_axis(qbuf, slot, np.where(
        blank[..., None], -1, np.take_along_axis(qbuf, slot, 2)), 2)
    nic = args[13].numpy()
    switchless = np.flatnonzero(args[12].numpy() < 0)
    nic[switchless[::2]] = False
    assert blank.any()                                 # empty head slots
    assert ((qtail - qhead).sum(1)[switchless[::2]] > 0).any()
    a = {n: jnp.asarray(x.numpy())
         for n, x in zip(testing.DERIVE_ARGS, args)}
    proto = SimpleNamespace(backpressure=bp, pfc=pfc, pfc_frac=0.11,
                            scheduler=scheduler, kernel_impl="lax")
    env = SimpleNamespace(cfg=SimpleNamespace(
        proto=proto, timing=SimpleNamespace(pause_window=37)),
        P=p, Q=q, S=a["fpos"].shape[1], CAP=16, NSW=NSW)
    want = jphases.derive(env, SimpleNamespace(**a), SimpleNamespace(**a),
                          SimpleNamespace(**a))
    got = tref.derive_ref(*args, n_switches=NSW, backpressure=bp, pfc=pfc,
                          scheduler=scheduler, pfc_frac=0.11,
                          pause_window=37)
    srf_key = (jnp.minimum(a["qsrf"], jref.BIG) if scheduler == "srf"
               else None)
    _, _, _, sel, can_tx, occ_after = jref.bfc_fused_ref(
        want.occ, want.qpaused, a["qptr"], want.pfc_paused | a["port_is_nic"],
        pause_window=37, scheduler=scheduler, srf_key=srf_key)
    for name, w in (("occ", want.occ), ("port_occ", want.port_occ),
                    ("sw_occ", want.sw_occ), ("qpaused", want.qpaused),
                    ("th", want.th), ("pfc_paused", want.pfc_paused),
                    ("rem_src", want.rem_src), ("ksel_q", sel),
                    ("kcan_tx", can_tx), ("kocc_after", occ_after)):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(w), err_msg=name)

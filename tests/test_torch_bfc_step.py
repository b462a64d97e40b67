"""The port's BFC switch decision: plain torch versions against the JAX
package's jnp oracles (`repro.kernels.bfc_step.ref`), exact, on the cases
of tests/test_kernels.py, and the CPU dispatch. The CUDA kernels are held
against the plain versions in test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.bfc_step import ref as jref  # noqa: E402
from repro_torch.kernels.bfc_step import bfc_step, ops  # noqa: E402
from repro_torch.kernels.bfc_step import ref as tref  # noqa: E402

pytestmark = pytest.mark.tier1

FUSED_NAMES = ("nact", "th", "pause", "sel", "cantx", "occ_after")
DECIDE_NAMES = FUSED_NAMES[:4]


def _inputs(seed, p, q, *, srf=False, all_paused=0, all_blocked=False):
    rng = np.random.default_rng(seed)
    occ = rng.integers(0, 40, (p, q)).astype(np.int32)
    qpaused = rng.random((p, q)) < 0.3
    qpaused[:all_paused] = True
    ptr = rng.integers(0, q, p).astype(np.int32)
    blocked = (np.ones(p, bool) if all_blocked
               else rng.random(p) < 0.2)
    key = (rng.integers(0, tref.BIG + 1, (p, q)).astype(np.int32)
           if srf else None)
    return occ, qpaused, ptr, blocked, key


def _assert_equal(got, want, names):
    for g, w, nm in zip(got, want, names):
        w = np.asarray(w)
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, nm
        np.testing.assert_array_equal(g, w, err_msg=nm)


def _fused_both(occ, qpaused, ptr, blocked, key, scheduler, pw=37):
    want = jref.bfc_fused_ref(
        jnp.asarray(occ), jnp.asarray(qpaused), jnp.asarray(ptr),
        jnp.asarray(blocked), pause_window=pw, scheduler=scheduler,
        srf_key=None if key is None else jnp.asarray(key))
    got = tref.bfc_fused_ref(
        torch.from_numpy(occ), torch.from_numpy(qpaused),
        torch.from_numpy(ptr), torch.from_numpy(blocked), pause_window=pw,
        scheduler=scheduler,
        srf_key=None if key is None else torch.from_numpy(key))
    return got, want


@pytest.mark.parametrize("q", [1, 2, 8, 32, 64])
@pytest.mark.parametrize("scheduler", ["drr", "srf"])
@pytest.mark.parametrize("p", [24, 97, 384])
def test_fused_ref_matches_jax(p, q, scheduler):
    occ, qp, ptr, blk, key = _inputs(13 + q + p, p, q,
                                     srf=scheduler == "srf", all_paused=7)
    got, want = _fused_both(occ, qp, ptr, blk, key, scheduler)
    _assert_equal(got, want, FUSED_NAMES)


@pytest.mark.parametrize("scheduler", ["drr", "srf"])
def test_fused_ref_all_ports_blocked(scheduler):
    occ, qp, ptr, blk, key = _inputs(3, 16, 8, srf=scheduler == "srf",
                                     all_blocked=True)
    got, want = _fused_both(occ, qp, ptr, blk, key, scheduler)
    _assert_equal(got, want, FUSED_NAMES)
    assert not got[4].any() and (got[3] == -1).all()
    assert torch.equal(got[5], torch.from_numpy(occ))


@pytest.mark.parametrize("p,q,pw", [(128, 8, 1), (256, 32, 37), (97, 8, 64),
                                    (64, 16, 37)])
def test_decide_ref_matches_jax(p, q, pw):
    occ, qp, ptr, _, _ = _inputs(p * q + pw, p, q)
    want = jref.bfc_decide_ref(jnp.asarray(occ), jnp.asarray(qp),
                               jnp.asarray(ptr), pause_window=pw)
    got = tref.bfc_decide_ref(torch.from_numpy(occ), torch.from_numpy(qp),
                              torch.from_numpy(ptr), pause_window=pw)
    _assert_equal(got, want, DECIDE_NAMES)


def test_decide_sentinel_survives_wide_queue_counts():
    """nq=1025: the only eligible queue packs above 2**20; the sentinel is
    derived from nq, so it is still picked."""
    p, q = 4, 1025
    occ = np.zeros((p, q), np.int32)
    occ[:, q - 1] = 3
    qp = np.zeros((p, q), bool)
    ptr = np.zeros(p, np.int32)
    want = jref.bfc_decide_ref(jnp.asarray(occ), jnp.asarray(qp),
                               jnp.asarray(ptr), pause_window=37)
    got = tref.bfc_decide_ref(torch.from_numpy(occ), torch.from_numpy(qp),
                              torch.from_numpy(ptr), pause_window=37)
    _assert_equal(got, want, DECIDE_NAMES)
    assert got[3].tolist() == [q - 1] * p
    assert tref.packed_sentinel(q, q - 1) == jref.packed_sentinel(q, q - 1)
    with pytest.raises(ValueError):
        tref.packed_sentinel(2**16, 2**16)


def test_ops_on_cpu_take_the_plain_version():
    """A CPU tensor runs the plain version and launches nothing."""
    occ, qp, ptr, blk, key = _inputs(5, 24, 32, srf=True)
    ops.reset_launches()
    args = [torch.from_numpy(a) for a in (occ, qp, ptr, blk)]
    for scheduler in ("drr", "srf"):
        got = ops.fused(*args, pause_window=37, scheduler=scheduler,
                        srf_key=torch.from_numpy(key))
        want = tref.bfc_fused_ref(*args, pause_window=37,
                                  scheduler=scheduler,
                                  srf_key=torch.from_numpy(key))
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    got = ops.decide(*args[:3], pause_window=37)
    for g, w in zip(got, tref.bfc_decide_ref(*args[:3], pause_window=37)):
        assert torch.equal(g, w)
    assert ops.launches == {"bfc_fused": 0, "bfc_decide": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never fall back to the plain version."""
    occ, qp, ptr, blk, _ = _inputs(6, 8, 4)
    args = [torch.from_numpy(a) for a in (occ, qp, ptr, blk)]
    with pytest.raises(ValueError, match="CUDA"):
        bfc_step.bfc_fused(*args, pause_window=37)
    with pytest.raises(ValueError, match="CUDA"):
        bfc_step.bfc_decide(*args[:3], pause_window=37)

"""Port parity: `repro_torch.core` (hashing, Bloom filter, flow table,
backpressure law) against the JAX package's `repro.core`, exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import backpressure as jbp  # noqa: E402
from repro.core import bloom as jbloom  # noqa: E402
from repro.core import flow_table as jft  # noqa: E402
from repro.core import hashing as jh  # noqa: E402
from repro.sim.trace import golden as jgolden  # noqa: E402
from repro_torch.core import backpressure as tbp  # noqa: E402
from repro_torch.core import bloom as tbloom  # noqa: E402
from repro_torch.core import flow_table as tft  # noqa: E402
from repro_torch.core import hashing as th  # noqa: E402

pytestmark = pytest.mark.tier1


@pytest.fixture(scope="module")
def fids():
    """The golden case's flow ids, 10k seeded int32 values and the int32
    edges (negatives, 0, +-2**31)."""
    _, flows = jgolden.golden_case()
    rng = np.random.default_rng(0)
    rand = rng.integers(-2**31, 2**31, 10_000, dtype=np.int64)
    edges = np.array([0, 1, -1, 2**31 - 1, -2**31, -2**31 + 1, 12345,
                      -12345], np.int64)
    return np.concatenate([np.asarray(flows.fid, np.int64), rand,
                           edges]).astype(np.int32)


def test_hash_u32_matches_jax(fids):
    for seed in range(8):
        want = np.asarray(jh.hash_u32(jnp.asarray(fids), seed))
        got = th.hash_u32(torch.from_numpy(fids), seed).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64),
                                      err_msg=f"seed {seed}")


@pytest.mark.parametrize("fn,args", [
    ("bloom_positions", (4, 256)),
    ("bloom_positions", (3, 1000)),
    ("bucket_index", (8192,)),
    ("bucket_index", (97,)),
    ("ecmp_choice", (8,)),
    ("ecmp_choice", (3,)),
])
def test_hash_derivatives_match_jax(fids, fn, args):
    want = np.asarray(getattr(jh, fn)(jnp.asarray(fids), *args))
    got = getattr(th, fn)(torch.from_numpy(fids), *args).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_uint32_add_wraps_like_jax():
    """`hash_u32(fid + t)` in arrivals adds two uint32 values: the sum
    wraps at 2**32 in both packages."""
    fid = np.array([2**31 - 1, -1, -2**31, 5], np.int32)
    t = np.int32(2**31 - 7)
    want = np.asarray(jh.hash_u32(jnp.asarray(fid).astype(jnp.uint32)
                                  + jnp.uint32(t), 3))
    got = th.hash_u32((th.as_u32(torch.from_numpy(fid))
                       + th.as_u32(torch.tensor(t))) & 0xFFFFFFFF, 3)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_bloom_add_batch_snapshot_check_match_jax():
    rng = np.random.default_rng(1)
    params = jbloom.BloomParams(4, 64)
    counts = rng.integers(0, 3, (10, 4, 64)).astype(np.int32)
    filt = rng.integers(0, 10, 200).astype(np.int32)
    pos = rng.integers(0, 64, (200, 4)).astype(np.int32)
    delta = rng.integers(-1, 2, 200).astype(np.int32)
    want = np.asarray(jbloom.add_batch(jnp.asarray(counts),
                                       jnp.asarray(filt), jnp.asarray(pos),
                                       jnp.asarray(delta)))
    got = tbloom.add_batch(torch.from_numpy(counts), torch.from_numpy(filt),
                           torch.from_numpy(pos), torch.from_numpy(delta))
    np.testing.assert_array_equal(got.numpy(), want)
    bits = want > 0
    np.testing.assert_array_equal(tbloom.snapshot(got).numpy(), bits)
    np.testing.assert_array_equal(
        tbloom.check(torch.from_numpy(bits)[filt], torch.from_numpy(pos)
                     ).numpy(),
        np.asarray(jbloom.check(jnp.asarray(bits)[filt], jnp.asarray(pos))))
    assert tbloom.BloomParams(4, 64).size_bytes == params.size_bytes
    assert tbloom.empty_counts(tbloom.BloomParams(4, 64), 3).shape == \
        jbloom.empty_counts(params, 3).shape


def test_flow_table_update_matches_jax():
    rng = np.random.default_rng(2)
    params = jft.FlowTableParams(n_buckets=16, bucket_size=2)
    buckets = rng.integers(0, 4, (3, 16)).astype(np.int32)
    table = rng.integers(0, 3, 100).astype(np.int32)
    bucket = rng.integers(0, 16, 100).astype(np.int32)
    delta = rng.integers(-1, 2, 100).astype(np.int32)
    want_b, want_o = jft.update(jnp.asarray(buckets), jnp.asarray(table),
                                jnp.asarray(bucket), jnp.asarray(delta),
                                params)
    got_b, got_o = tft.update(
        torch.from_numpy(buckets), torch.from_numpy(table),
        torch.from_numpy(bucket), torch.from_numpy(delta),
        tft.FlowTableParams(n_buckets=16, bucket_size=2))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    assert int(got_o) == int(want_o)
    assert tft.FlowTableParams().table_bytes == jft.FlowTableParams().table_bytes


def test_backpressure_law_matches_jax():
    n = np.arange(-2, 70, dtype=np.int32)
    for hrtt, tau, mu in [(25, 12, 1.0), (2.0, 1.0, 3.5), (7, 3.5, 0.25)]:
        jp = jbp.BackpressureParams(hrtt, tau, mu)
        tp = tbp.BackpressureParams(hrtt, tau, mu)
        np.testing.assert_array_equal(
            tbp.pause_threshold(tp, torch.from_numpy(n)).numpy(),
            np.asarray(jbp.pause_threshold(jp, jnp.asarray(n))))
        np.testing.assert_array_equal(
            tbp.worst_case_buffer(tp, torch.from_numpy(n)).numpy(),
            np.asarray(jbp.worst_case_buffer(jp, jnp.asarray(n))))
    q = torch.tensor([3, 10, 40])
    assert tbp.should_pause(q, 10).tolist() == [False, False, True]
    assert tbp.should_resume(q, 10).tolist() == [True, False, False]

"""The mixed batch of test_torch_sweep.py under the protocol families whose
phases take a branch of their own on a batch, exact against the JAX
package's `sweep.run_batch` (every leaf of the padded state, the emits
and the per-lane active ticks):

* sfc: the per-lane feedback slots of the source signal ((K, 1, H) delay,
  (K, F, 1) flow index);
* bfc_srf: the SRF key in the switch step;
* oracle: the SRPT NIC and the SRF switch on an infinite buffer;
* dcqcn, hpcc, fairq: the rate-based congestion control paths.

Three lanes on three fabrics, one with 4-tick links, so the per-lane
delay, buffer and occupancy tables are in play."""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_sweep import (assert_batch_equal, horizon,  # noqa: E402
                              run_jax, run_port)

pytestmark = pytest.mark.tier1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# at load 0.5 no egress reaches the presets' SFC and ECN thresholds (100
# packets): lower ones make the source signal and the marks fire
LOW_THRESHOLDS = {"sfc": {"sfc_threshold": 4},
                  "dcqcn": {"ecn_kmin": 4, "ecn_kmax": 16}}


@pytest.mark.slow
@pytest.mark.parametrize("proto", ["sfc", "bfc_srf", "oracle", "dcqcn",
                                   "hpcc", "fairq"])
def test_family_batch_matches_jax_run_batch(proto):
    n_ticks = horizon() + 1200
    kw = dict(proto=proto, proto_kw=LOW_THRESHOLDS.get(proto))
    port_run = run_port(n_ticks, **kw)
    assert_batch_equal(port_run, run_jax(n_ticks, **kw),
                       f"mixed {proto} batch")
    st = port_run[0]
    if proto == "sfc":          # every lane signalled
        assert (st.sfc_until.max(1) > 0).all()
    if proto == "dcqcn":        # every lane saw marks
        assert (st.alpha.max(1) > 0).all()

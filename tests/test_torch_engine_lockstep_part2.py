"""The port's step against the JAX package's jitted step, tick by tick
(part 2): HPCC path utilization and window law, SFC source signals and
the SRPT NIC scheduling of the centralized oracle. See
test_torch_engine_lockstep.py for the contract."""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_engine_lockstep import lockstep  # noqa: E402

pytestmark = pytest.mark.tier1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["hpcc", "sfc", "oracle"])
def test_port_step_matches_jax_step(name):
    lockstep(name)

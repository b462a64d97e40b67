"""Golden traces through the port (part 1 of 4: families sorted(PRESETS)[0::4]).

Every PRESETS family, run by `repro_torch.sim.engine.simulate` on the CPU
on the pinned golden case (padded to the fixture's 64 flows, early exit
on), must reproduce its committed fixture in tests/fixtures/traces/ bit
for bit: the 3 emit columns, every trace channel and `active_ticks`. The
families are spread over four files so that parallel workers share them."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.sim.config import PRESETS  # noqa: E402
from repro_torch.sim.trace import golden  # noqa: E402

pytestmark = pytest.mark.tier1

FAMILIES = sorted(PRESETS)[0::4]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_reproduces_golden_fixture(name):
    assert golden.compare(name, golden.run_family(name, "cpu")) == []

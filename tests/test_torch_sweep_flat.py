"""The port's batched lane axis against the JAX package's sweep (part 3):
the mixed-fabric batch of test_torch_sweep.py stepped flat
(`early_exit=False`: every lane steps every tick, no closed-form tail),
and the same batch with every trace channel on (per-lane capture rows on
the emits), each against JAX's `run_batch` in every leaf, the emits and
the per-lane active ticks."""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.sim.trace import TraceSpec as JTraceSpec  # noqa: E402
from repro_torch.sim.trace.spec import TraceSpec as TTraceSpec  # noqa: E402
from test_torch_sweep import (LANES, assert_batch_equal, horizon,  # noqa
                              run_jax, run_port)

pytestmark = pytest.mark.tier1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.slow
@pytest.mark.parametrize("case", ["flat", "traced"])
def test_batch_variant_matches_jax_run_batch(case):
    if case == "flat":
        n_ticks, kw = horizon() + 600, dict(early_exit=False)
    else:
        # full trace channels; 700 ticks, none of them quiescent
        n_ticks, kw = 700, dict(jax=dict(trace=JTraceSpec.full()),
                                torch=dict(trace=TTraceSpec.full()))
    port_run = run_port(n_ticks, **kw)
    assert_batch_equal(port_run, run_jax(n_ticks, **kw), f"{case} batch")
    if case == "flat":
        assert port_run[2].tolist() == [n_ticks] * len(LANES)
    else:
        assert port_run[1].shape[2] > 3        # the trace channels

"""The port's BFCServer against the JAX package's on reduced recurrentgemma
(recurrent + local attention blocks): the five scenarios of
tests/test_serving.py, and the reference's slot-state fault, which the
port reproduces rather than fixes."""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_lm_serving import (SCENARIOS, heterogeneous,  # noqa: E402
                                   model_pair, serve_both)

pytestmark = pytest.mark.tier1


@pytest.fixture(scope="module")
def rg():
    return model_pair("recurrentgemma-2b")


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_recurrentgemma_server_matches_jax(rg, scenario):
    kwargs, calls = SCENARIOS[scenario]
    assert serve_both(rg, kwargs, calls)


def test_recurrentgemma_reproduces_the_slot_state_fault(rg):
    """Reference fault, reproduced on purpose: `BFCServer._assign_slots`
    resets only `kv_len`, never a 'rec' block's `h`/`conv` state, and idle
    slots keep being stepped on token 0. Request 1 lands on slot 1 two
    ticks after request 0 started, on state that slot 1 built up from
    token 0 meanwhile, so the same prompt gives other tokens:
    [128, 128, 128, 398, 398, 398] where request 0 (and the full-context
    greedy decode) gives [128, 128, 398, 398, 398, 398]."""
    got = serve_both(rg, dict(n_slots=2, max_len=32), heterogeneous(6))
    assert got[0] == [128, 128, 398, 398, 398, 398]
    assert got[1] == [128, 128, 128, 398, 398, 398]

"""The port's BFCServer against the JAX package's on reduced rwkv6-3b
(attention-free RWKV-6 blocks): the five scenarios of
tests/test_serving.py, and the reference's slot-state fault, which holds
for the RWKV state too and which the port reproduces rather than fixes."""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_lm_serving import (SCENARIOS, heterogeneous,  # noqa: E402
                                   model_pair, serve_both)

pytestmark = pytest.mark.tier1


@pytest.fixture(scope="module")
def rwkv():
    return model_pair("rwkv6-3b")


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_rwkv_server_matches_jax(rwkv, scenario):
    kwargs, calls = SCENARIOS[scenario]
    assert serve_both(rwkv, kwargs, calls)


def test_rwkv_reproduces_the_slot_state_fault(rwkv):
    """Reference fault, reproduced on purpose: `BFCServer._assign_slots`
    resets only `kv_len`, never an 'rwkv' block's `S`, `shift` and
    `shift_cm`, and idle slots keep being stepped on token 0. Request 1
    lands on slot 1 two ticks after request 0 started, on state that slot
    1 built up from token 0 meanwhile, so the same prompt gives other
    tokens: [9, 235, 120, 461, 186, 186] where request 0 (and the
    full-context greedy decode) gives [9, 46, 77, 113, 99, 455]."""
    got = serve_both(rwkv, dict(n_slots=2, max_len=32), heterogeneous(6))
    assert got[0] == [9, 46, 77, 113, 99, 455]
    assert got[1] == [9, 235, 120, 461, 186, 186]

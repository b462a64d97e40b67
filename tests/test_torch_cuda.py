"""The port on the card: the CUDA kernels against their plain versions,
and one golden family end to end with the kernel launched once per
simulated tick. Needs a CUDA device and nvcc (a CUDA kernel has no CPU
mode), so every test here carries the `cuda` marker and skips elsewhere;
run them on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

No JAX is needed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.bfc_step import ops  # noqa: E402
from repro_torch.kernels.bfc_step import ref as tref  # noqa: E402
from repro_torch.sim.trace import golden  # noqa: E402

pytestmark = [pytest.mark.tier1, pytest.mark.cuda]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


def _inputs(seed, p, q, device, *, srf):
    rng = np.random.default_rng(seed)
    occ = rng.integers(0, 40, (p, q)).astype(np.int32)
    occ[p // 3:p // 2] = 0                            # empty rows
    qpaused = rng.random((p, q)) < 0.3
    qpaused[:5] = True                                # all-paused rows
    ptr = rng.integers(0, q, p).astype(np.int32)
    blocked = rng.random(p) < 0.2
    key = rng.integers(0, tref.BIG + 1, (p, q)).astype(np.int32)
    args = [torch.from_numpy(a).to(device)
            for a in (occ, qpaused, ptr, blocked)]
    return args, (torch.from_numpy(key).to(device) if srf else None)


@pytest.mark.parametrize("scheduler", ["drr", "srf"])
@pytest.mark.parametrize("p,q", [(384, 32), (384, 1), (384, 64), (97, 32),
                                 (24, 32)])
def test_kernels_match_plain_versions(card, p, q, scheduler):
    args, srf_key = _inputs(p + q, p, q, card, srf=scheduler == "srf")
    before = dict(ops.launches)
    got = ops.fused(*args, pause_window=37, scheduler=scheduler,
                    srf_key=srf_key)
    want = tref.bfc_fused_ref(*args, pause_window=37, scheduler=scheduler,
                              srf_key=srf_key)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    got = ops.decide(*args[:3], pause_window=37)
    for g, w in zip(got, tref.bfc_decide_ref(*args[:3], pause_window=37)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert ops.launches["bfc_fused"] == before["bfc_fused"] + 1
    assert ops.launches["bfc_decide"] == before["bfc_decide"] + 1


def test_kernel_rejects_bad_operands(card):
    args, _ = _inputs(1, 8, 4, card, srf=False)
    with pytest.raises(TypeError):
        ops.fused(args[0].long(), *args[1:], pause_window=37)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused(args[0].repeat(1, 2)[:, ::2], *args[1:], pause_window=37)
    with pytest.raises(ValueError):
        ops.fused(*args, pause_window=37, scheduler="srf")


def test_golden_family_on_card(card):
    """`bfc` on the pinned golden case reproduces its fixture on the card,
    with one kernel launch per simulated tick (plus the one step that
    rebuilds the quiescent tail's trace row)."""
    ops.reset_launches()
    out = golden.run_family("bfc", card)
    assert golden.compare("bfc", out) == []
    assert ops.launches["bfc_fused"] == out["active_ticks"] + 1

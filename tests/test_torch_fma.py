"""`repro_torch.sim.phases.ctx.fma` rounds ``a * b + c`` to float32 once,
held against exact rational arithmetic, on cases built so that rounding the
float64 sum first would land on a float32 tie."""
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.sim.phases.ctx import fma  # noqa: E402

pytestmark = pytest.mark.tier1


def _round_f32(x: Fraction) -> np.float32:
    """Correctly rounded float32 of an exact rational (ties to even)."""
    mid = np.float32(float(x))
    cands = [np.nextafter(mid, np.float32(-np.inf)), mid,
             np.nextafter(mid, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(np.array(v).view(np.int32)) & 1))


def _tie_cases(rng, n):
    """a, b with 12-bit significands, so ``a * b`` is exact in 25 bits and
    often sits on a float32 midpoint; a ``c`` far below float64's ulp of
    the product decides which way the exact sum rounds."""
    i = rng.integers(1, 4096, n)
    j = rng.integers(1, 4096, n)
    sign = rng.choice([-1.0, 1.0], n)
    a = (sign * (1 + i / 4096)).astype(np.float32)
    b = ((1 + j / 4096) * 2.0 ** rng.integers(-3, 4, n)).astype(np.float32)
    c = (rng.choice([-1.0, 1.0], n) * 2.0 ** -60).astype(np.float32)
    return a, b, c


def _random_cases(rng, n):
    def draw():
        return (rng.standard_normal(n)
                * 2.0 ** rng.integers(-20, 20, n)).astype(np.float32)
    return draw(), draw(), draw()


@pytest.mark.parametrize("make", [_tie_cases, _random_cases],
                         ids=["float32_ties", "random"])
def test_fma_rounds_once(make):
    a, b, c = make(np.random.default_rng(0), 2000)
    got = fma(torch.from_numpy(a), torch.from_numpy(b),
              torch.from_numpy(c)).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_fma_scalar_operands_round_to_float32_first():
    """A Python float operand acts as its float32 value."""
    a = torch.tensor([3.0, -7.5, 1e-3], dtype=torch.float32)
    got = fma(a, 0.1, 1e-8).numpy()
    want = np.array([_round_f32(Fraction(float(x))
                                * Fraction(float(np.float32(0.1)))
                                + Fraction(float(np.float32(1e-8))))
                     for x in a.numpy()], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))

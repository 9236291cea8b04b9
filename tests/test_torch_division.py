"""K1's division (csrc/transform.cuh) emulated with exact rationals.

K1 divides a coefficient y by an integer quant q in 1..255 through the
host's reciprocal r = RN(1/q) (ops/cuda_encode.py::reciprocals):

    z0 = RN(y * r);  e = RN(y - z0 * q)  (an FMA);  z = RN(e * r + z0)  (an FMA)

Here each step is computed exactly with fractions.Fraction and rounded
once, as the card rounds it (float(Fraction) and float products round to
nearest even).  For every q in 1..255, on seeded y at and around the
quotients k, k + 1/2 (the quantizer's rounding ties) and k + 1/4, and on
random y, the remainder is exact and z equals the correctly rounded y / q,
which the plain version computes and __ddiv_rn returns.  chip_smoke.py's
division sweep runs the same comparison on the card at full breadth.
"""

import math
from fractions import Fraction

import numpy as np
import pytest

from imageencoder_tpu_torch.ops.cuda_encode import (coeff_bound_bits_residual,
                                                    reciprocals)

RECIP = reciprocals(np.arange(256))
K_MAX = 2 ** coeff_bound_bits_residual(4, "reference")


def three_step(y: float, q: int):
    """(z, e exact?) of K1's division of y by q."""
    r = float(RECIP[q])
    z0 = y * r
    rem = Fraction(y) - Fraction(z0) * q
    e = float(rem)
    z = float(Fraction(e) * Fraction(r) + Fraction(z0))
    return z, Fraction(e) == rem


def near_ties(q: int, rng: np.random.Generator) -> list[float]:
    """y at and 1-3 ulps around k*q, (k + 1/2)*q and (k + 1/4)*q for a few
    k (0, +-1, +-K_MAX and random), plus random y."""
    ks = [0, 1, -1, K_MAX, -K_MAX] + rng.integers(-K_MAX, K_MAX, 3).tolist()
    ys = []
    for k in ks:
        for c in (k * q, (k + 0.5) * q, (k + 0.25) * q):
            y = float(c)
            ys.append(y)
            up = down = y
            for _ in range(3):
                up, down = math.nextafter(up, math.inf), math.nextafter(
                    down, -math.inf)
                ys += [up, down]
    ys += (rng.standard_normal(8) * 255.0 * K_MAX).tolist()
    return ys


def test_reciprocal_table_covers_integers_1_to_255():
    assert RECIP[0] == 0.0 and RECIP[1] == 1.0 and RECIP[255] == 1.0 / 255
    assert (RECIP[1:] == 1.0 / np.arange(1, 256)).all()
    assert (reciprocals([[0.5, 256.0], [3.0, 2.5]])
            == [[0.0, 0.0], [1.0 / 3, 0.0]]).all()


@pytest.mark.parametrize("part", range(5))
def test_reciprocal_division_equals_correctly_rounded_quotient(part):
    rng = np.random.default_rng(part)
    for q in range(1 + part, 256, 5):
        for y in near_ties(q, rng):
            z, exact = three_step(y, q)
            assert exact, (y, q)
            assert z == y / q, (y, q, z, y / q)

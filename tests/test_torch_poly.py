"""The port's ``Polynomial`` (stark_tpu_torch/poly.py) against
stark_tpu.poly.Polynomial: tests/test_poly.py's cases, merged into one
parametrised test that runs each case through both packages on the same
seeded inputs and compares what comes out (coefficients, values, truth
values, or the exception's type).  Above the 64-coefficient crossover the
port multiplies through its NTT (K1-K3's plain versions here: the
polynomials are made with ``device="cpu"``); the crossover's both sides,
unreduced coefficients, division, ``exp``, interpolation, ``zerofier``,
``scale`` and the colinearity test are among the cases.  On a card (marker
``gpu``): a product above the crossover through the kernels, equal to the
CPU's.  Tolerance zero."""

import numpy as np
import pytest
import torch

from stark_tpu_torch import FiniteField, Polynomial
from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops.fieldops import P
from stark_tpu_torch.poly import _NTT_MUL_CROSSOVER
from torch_port_support import cuda_device  # noqa: F401


class _Pkg:
    """One package's Polynomial, its field, and the keywords its
    constructors take (the port's: ``device="cpu"``)."""

    def __init__(self, cls, field, **kw):
        self.cls, self.field, self.kw = cls, field, kw

    def poly(self, coeffs):
        return self.cls(coeffs, self.field, **self.kw)

    def rand(self, rng, n, bound=P):
        return self.poly(rng.integers(0, bound, size=n, dtype=np.uint64).tolist())


def _result(value):
    if isinstance(value, tuple):
        return tuple(_result(v) for v in value)
    if isinstance(value, list):
        return [_result(v) for v in value]
    if hasattr(value, "coeffs"):
        return ("poly", list(value.coeffs))
    return value


def _mul_sizes(la, lb):
    return lambda k, r: k.rand(r, la) * k.rand(r, lb)


U64 = 1 << 63  # unreduced coefficients: values up to 2^63, far above p

CASES = {
    # structure (mod.rs:54-143)
    "deg": lambda k, r: [k.poly(c).deg() for c in
                         ([], [0, 0, 0], [P, 2 * P], [1, 2, 0, 0], [0, 0, 5])],
    "eq": lambda k, r: [k.poly(a) == k.poly(b) for a, b in (
        ([1, 2], [1, 2, 0, 0]), ([], [0, 0]), ([1, 2], [1, 3]), ([1], [1, 1]),
        ([P + 1, 2], [1, 2]))],
    "is_zero": lambda k, r: [k.poly(c).is_zero() for c in ([], [0], [1], [P])],
    "leading_coeff": lambda k, r: [k.poly(c).leading_coeff() for c in
                                   ([1, 2, 3], [7, 5, 0], [2 * P + 9])],
    "leading_coeff_zero": lambda k, r: k.poly([]).leading_coeff(),
    "constructors": lambda k, r: (k.cls.zero_poly(k.field, **k.kw),
                                  k.cls.constant_poly(k.field, 5, **k.kw),
                                  k.cls.linear_poly(k.field, 3, 4, **k.kw)),
    "repr": lambda k, r: repr(k.rand(r, 5)),
    # add / sub / neg (add.rs, sub.rs, mod.rs:70-75)
    "add": lambda k, r: k.rand(r, 6) + k.rand(r, 9),
    "add_pads": lambda k, r: k.poly([1, 2, 3]) + k.poly([10]),
    "add_wraps": lambda k, r: k.poly([P - 1]) + k.poly([2]),
    "add_unreduced": lambda k, r: k.rand(r, 7, U64) + k.rand(r, 4, U64),
    "sub": lambda k, r: k.rand(r, 9) - k.rand(r, 6),
    "sub_self": lambda k, r: (lambda a: a - a)(k.rand(r, 10)),
    "neg": lambda k, r: -k.rand(r, 12),
    "neg_unreduced": lambda k, r: -k.rand(r, 12, U64),
    # mul (mul.rs:6-29): schoolbook below the crossover, NTT from it on
    "mul": _mul_sizes(5, 9),
    "mul_zero": lambda k, r: (k.rand(r, 7) * k.poly([]), k.poly([0]) * k.rand(r, 7)),
    "mul_identity": lambda k, r: k.rand(r, 7) * k.poly([1]),
    "mul_sparse_skips_zero_lhs": lambda k, r: k.poly([0, 1, 0, 0, 2]) * k.poly([3, 0, 4]),
    "mul_overflow": lambda k, r: k.poly([P - 1, P - 2]) * k.poly([P - 3]),
    "mul_63x63": _mul_sizes(63, 63),
    "mul_64x64": _mul_sizes(64, 64),
    "mul_65x63": _mul_sizes(65, 63),
    "mul_65x65": _mul_sizes(65, 65),
    "mul_101x67": _mul_sizes(101, 67),
    "mul_128x128": _mul_sizes(128, 128),
    "mul_1000x1000": _mul_sizes(1000, 1000),
    "mul_1000x64": _mul_sizes(1000, 64),
    "mul_unreduced_schoolbook": lambda k, r: k.rand(r, 20, U64) * k.rand(r, 30, U64),
    "mul_unreduced_ntt": lambda k, r: k.rand(r, 70, U64) * k.rand(r, 90, U64),
    "mul_zero_coeffs_ntt": lambda k, r: k.poly([0] * 40 + [5] * 40) * k.rand(r, 80),
    # div (div.rs:6-69)
    "divmod": lambda k, r: divmod(k.rand(r, 12), k.rand(r, 5)),
    "divmod_unreduced": lambda k, r: divmod(k.rand(r, 12, U64), k.rand(r, 5, U64)),
    "div_exact": lambda k, r: (lambda a, b: ((a * b).intdiv(b), (a * b) / b, (a * b) % b))(
        k.rand(r, 6), k.rand(r, 4)),
    "div_exact_ntt": lambda k, r: (lambda a, b: (a * b).intdiv(b))(k.rand(r, 90), k.rand(r, 70)),
    "div_smaller_numerator": lambda k, r: divmod(k.rand(r, 3), k.rand(r, 6)),
    "div_self": lambda k, r: (lambda a: divmod(a, a))(k.rand(r, 5)),
    "div_by_zero": lambda k, r: divmod(k.rand(r, 4), k.poly([])),
    "intdiv_remainder": lambda k, r: k.poly([1, 0, 1]).intdiv(k.poly([1, 1])),
    # exp (exp.rs:6-42)
    "exp": lambda k, r: (lambda a: [a.exp(e) for e in range(7)] + [a ^ 5])(k.rand(r, 3)),
    "exp_ntt": lambda k, r: k.rand(r, 40).exp(3),
    "exp_zero_poly": lambda k, r: (k.poly([]).exp(0), k.poly([]).exp(3)),
    # eval (eval.rs)
    "eval": lambda k, r: [k.rand(r, 8).eval(x) for x in (0, 1, 42, P - 1, P + 5)],
    "eval_unreduced": lambda k, r: k.rand(r, 8, U64).eval(12345),
    "eval_field_element": lambda k, r: k.rand(r, 5).eval(k.field.new_element(17)),
    "eval_domain": lambda k, r: k.rand(r, 8).eval_domain([3, 14, 159, P - 1, 0]),
    # interpolate (interpolate.rs:6-44)
    "interpolate": lambda k, r: k.cls.interpolate_domain([1, 2, 5, 7], [3, 1, 4, 1],
                                                         k.field, **k.kw),
    "interpolate_linear": lambda k, r: k.cls.interpolate_domain([0, 1], [5, 8], k.field,
                                                                **k.kw),
    "interpolate_single": lambda k, r: k.cls.interpolate_domain([9], [13], k.field, **k.kw),
    "interpolate_duplicate": lambda k, r: k.cls.interpolate_domain([1, 1], [2, 3], k.field,
                                                                   **k.kw),
    "interpolate_random": lambda k, r: k.cls.interpolate_domain(
        r.permutation(np.arange(1, 100))[:9].tolist(),
        r.integers(0, P, size=9, dtype=np.uint64).tolist(), k.field, **k.kw),
    "interpolate_roundtrip": lambda k, r: (lambda a: k.cls.interpolate_domain(
        list(range(2, 8)), a.eval_domain(list(range(2, 8))), k.field, **k.kw))(k.rand(r, 6)),
    # zerofier, scale, colinearity (mod.rs:77-152)
    "zerofier": lambda k, r: k.cls.zerofier([2, 3, 5, 8], k.field, **k.kw),
    "zerofier_random": lambda k, r: k.cls.zerofier(
        r.integers(0, P, size=12, dtype=np.uint64).tolist(), k.field, **k.kw),
    "scale": lambda k, r: [k.rand(r, 7).scale(c) for c in (12345, 77, 0, 1, P - 1)],
    "scale_field_element": lambda k, r: k.rand(r, 5).scale(k.field.new_element(77)),
    "colinear": lambda k, r: k.cls.test_colinearity([(1, 8), (2, 11), (4, 17)], k.field),
    "not_colinear": lambda k, r: k.cls.test_colinearity([(1, 8), (2, 11), (4, 18)],
                                                        k.field),
    "colinear_two_points": lambda k, r: k.cls.test_colinearity([(1, 5), (9, 2)], k.field),
    "colinear_vertical": lambda k, r: k.cls.test_colinearity([(1, 5), (1, 9)], k.field),
    "colinear_one_point": lambda k, r: k.cls.test_colinearity([(1, 5)], k.field),
}


def _run(pkg, name):
    rng = np.random.default_rng(sorted(CASES).index(name))
    try:
        return _result(CASES[name](pkg, rng))
    except Exception as err:  # the two packages must raise the same type
        return ("raises", type(err).__name__)


@pytest.fixture(scope="module")
def theirs():
    from stark_tpu.field import FiniteField as JField
    from stark_tpu.poly import Polynomial as JPolynomial

    return _Pkg(JPolynomial, JField())


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_matches_stark_tpu(theirs, name):
    got = _run(_Pkg(Polynomial, FiniteField(), device="cpu"), name)
    assert got == _run(theirs, name)


def test_crossover_matches_stark_tpu():
    from stark_tpu.poly import _NTT_MUL_CROSSOVER as J_CROSSOVER

    assert _NTT_MUL_CROSSOVER == J_CROSSOVER == 64


def test_ntt_product_keeps_the_device_and_needs_a_card_by_default():
    a = Polynomial(list(range(1, 80)), device="cpu")
    assert (a * a).device == "cpu" and (a - a).device == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    b = Polynomial(list(range(1, 80)))
    assert (b * Polynomial([1, 2])).coeffs  # schoolbook: no device needed
    with pytest.raises(RuntimeError, match="no CUDA device"):
        b * b


@pytest.mark.gpu
@pytest.mark.parametrize("la,lb", [(64, 64), (1000, 700), (1 << 12, 1 << 12)])
def test_card_product_equals_cpu(cuda_device, la, lb):
    rng = np.random.default_rng(la + lb)
    ca = rng.integers(0, P, size=la, dtype=np.uint64).tolist()
    cb = rng.integers(0, P, size=lb, dtype=np.uint64).tolist()
    cuda.reset_launches()
    got = Polynomial(ca, device=cuda_device) * Polynomial(cb, device=cuda_device)
    counts = cuda.launch_counts()
    assert all(counts[k] == 2 for k in ("ntt_pass1", "ntt_transpose", "ntt_pass2"))
    assert got.coeffs == (Polynomial(ca, device="cpu") * Polynomial(cb, device="cpu")).coeffs

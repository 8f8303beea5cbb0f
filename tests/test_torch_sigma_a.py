"""``repro_torch.core.problems.sigma_A`` (eq. (31)/(33)) against the
reference's ``repro.core.problems.sigma_A``: bit for bit on one BLAS thread
(its last bits follow OpenBLAS's thread count, as tests/test_torch_table2.py
notes), and the very value ``generate_problem`` records, in both packages.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
threadpool_limits = pytest.importorskip("threadpoolctl").threadpool_limits

from repro.core import problems as JP  # noqa: E402
from repro_torch.core import problems  # noqa: E402


@pytest.mark.parametrize("n,d,s", [(10, 64, 0.1), (10, 200, 1.0), (30, 100, 10.0), (4, 257, 1.0)])
def test_sigma_A_bit_equal_to_reference(n, d, s):
    with threadpool_limits(limits=1, user_api="blas"):
        A, x0 = problems.algorithm3(n=n, d=d, noise_scale=s, seed=0)
        got = problems.sigma_A(A)
        jprob = JP.generate_problem(n=n, d=d, noise_scale=s, seed=0)
        prob = problems.generate_problem(n=n, d=d, noise_scale=s, seed=0, device="cpu")
        assert got == JP.sigma_A(A) == jprob.sigma_A == prob.sigma_A  # float64, bit for bit
    assert isinstance(got, float) and got > 0
    assert A.shape == (n, d, d) and A.dtype == np.float64 and x0.shape == (d,)
    # the host arrays are what both packages place on their devices
    np.testing.assert_array_equal(np.asarray(jprob.A), A.astype(np.float32))
    np.testing.assert_array_equal(prob.A.numpy(), A.astype(np.float32))
    np.testing.assert_array_equal(prob.x0.numpy(), x0.astype(np.float32))

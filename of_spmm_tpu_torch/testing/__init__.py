"""testing — numerics harnesses (the reference's test_utils surface)."""

from of_spmm_tpu_torch.testing.autotest import (
    ATOL,
    RTOL,
    assert_close,
    autotest,
    check_grads_against_torch,
    check_module_against_torch,
    torch_equivalent,
)

__all__ = [
    "ATOL",
    "RTOL",
    "assert_close",
    "autotest",
    "check_grads_against_torch",
    "check_module_against_torch",
    "torch_equivalent",
]

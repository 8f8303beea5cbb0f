"""Four gloo ranks of the train step's tensor parallelism over "model" for
deepseek-v2 (moe) (``tests/torch_ranks.py``: one subprocess a part, each with its own
time limit, ``TIMEOUT``, past which the failure names the case each rank was
running).

* each leaf's gradient at (1, 2) (pairs of ranks) and (1, 4) against
  ``trainer.worker_value_and_grad``'s in one process: max |dg| / max |g|
  within LEAF_RTOL or, where that leaf's gradient is rounding residue
  (below 1e-6 of the model's largest), within FLOOR_FACTOR times the single
  process's own distance with the tensor-parallel summation order
  (``sharded_check.OneRank``); the loss within LOSS_ATOL; the expert ids those of the single
  process (no route flips);
* 3 teacher-forced steps at (1, 4) and (2, 2) under marina:perm (bf16
  replicas) and ef21p against the single process, within
  ``sharded_check``'s bounds (``hold``: ACT_BOUNDS, or 1.5x ``OneRank``'s
  floor), the bytes handed to gloo equal to the dry-run's count of the same
  step on ``meta`` each step, and each rank's perm steps launching
  ``rotk_apply_rows`` through its block map (counted in a wrapper: the CPU
  path counts no launch). Rank 0 alone runs the single process and its
  floor and broadcasts the state that teacher-forces the next step.

The in-process tests of these families and the reference's partitioned step
are in tests/test_torch_train_tp_families.py.
"""
import pytest

import torch_ranks as R
from repro_torch.train import sharded_check as SC
from test_torch_train_tp import LEAF_RTOL, LOSS_ATOL

ARCH = "deepseek-v2-236b"


@pytest.fixture(scope="module")
def leaves(tmp_path_factory):
    return R.run(tmp_path_factory.mktemp("leaves"), "leaves", ARCH, R.TIMEOUT["leaves"])


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
@pytest.mark.parametrize("arch", [ARCH])
def test_leaf_gradients_against_the_single_process(leaves, arch, shape):
    """Every leaf within LEAF_RTOL of the single process's gradient, or,
    where its gradient is rounding residue, within FLOOR_FACTOR times the
    single process's own distance in the same run; the loss within
    LOSS_ATOL; a moe config's expert ids those of the single process."""
    R.check_leaves(leaves, arch, shape, LEAF_RTOL, LOSS_ATOL, SC.FLOOR_FACTOR)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return R.run(tmp_path_factory.mktemp("steps"), "steps", ARCH, R.TIMEOUT["steps"])


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("arch", [ARCH])
@pytest.mark.parametrize("name", [c[0] for c in R.CASES])
def test_four_ranks_tensor_parallel_steps_against_single_process(steps, name, arch, shape):
    """3 teacher-forced steps on every rank within ``sharded_check``'s
    bounds (``hold``), bytes handed = counted, the round trip bit for bit
    (``run_case``), perm through the block map on every rank."""
    R.check_steps(steps, name, arch, shape)

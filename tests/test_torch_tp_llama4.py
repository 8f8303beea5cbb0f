"""Four gloo ranks of the train step's tensor parallelism over "model" for
llama4 (moe), and the collectives' new backwards (``tests/torch_ranks.py``:
one subprocess a part, each with its own time limit, ``TIMEOUT``, past which
the failure names the case each rank was running).

* the two backwards ``gather_replicated`` and ``exit_enter`` in float64, as
  finite differences on each pair of ranks (a "model" axis of 2): a
  gathered block used alike on both ranks, and a partial sum that each rank
  uses with its own block;
* each leaf's gradient at (1, 2) (pairs of ranks) and (1, 4) against
  ``trainer.worker_value_and_grad``'s in one process: max |dg| / max |g|
  within LEAF_RTOL or, where that leaf's gradient is rounding residue
  (below 1e-6 of the model's largest), within FLOOR_FACTOR times the single
  process's own distance with the tensor-parallel summation order
  (``sharded_check.OneRank``); the loss within LOSS_ATOL; the expert ids
  those of the single process (no route flips). llama4's router at (1, 4)
  reads 0.132 against OneRank's 0.133: a gradient of 1.7e-9, which top-1
  routing's p / p = 1 leaves to rounding.

The in-process tests of these families and the reference's partitioned step
are in tests/test_torch_train_tp_families.py.
"""
import pytest

import torch_ranks as R
from repro_torch.train import sharded_check as SC
from test_torch_train_tp import LEAF_RTOL, LOSS_ATOL

ARCH = "llama4-maverick-400b-a17b"


@pytest.fixture(scope="module")
def backwards(tmp_path_factory):
    return R.run(tmp_path_factory.mktemp("fd"), "fd", "-", R.TIMEOUT["fd"])


@pytest.mark.parametrize("kind", ["gather_replicated", "exit_enter"])
def test_new_backwards_against_finite_differences(backwards, kind):
    """``gather_replicated`` (all-gather forward, the rank's block of the
    gradient backward) and ``exit_enter`` (all-reduce both ways) on a
    "model" axis of 2, float64: every input's gradient within 1e-6 of
    central differences, on every rank."""
    R.check_backward(backwards, kind)


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

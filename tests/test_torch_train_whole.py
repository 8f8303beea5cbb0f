"""The train step's tensor parallelism over "model" with product weights that
"model" does not split (the reference's ``try_shard`` leaves them whole):
four gloo ranks in one subprocess (``tests/torch_ranks.py``'s ``whole``
part, with its own time limit).

* ``serve/sharded.ServeShard``'s rules for such a weight, on pairs of ranks
  in float64 against central differences: a whole weight whose product only
  the rank's heads read enters "model" (its gradient summed over the pair:
  ``read_in_part``, Mamba2's ``in_proj``); a layer whose output product is
  whole runs alike on every rank (``alike``: the MLP's ``w_in`` / ``w_out``
  whole, no collective on their gradients or on x's; ``alike_gathered``: a
  weight split over "model" read whole there, the rank keeping its block
  of the gradient). Every input within 1e-6 of the differences.
* The smoke variants of ``train/sharded_check.VARIANTS`` at (1, 4): each
  leaf's gradient against ``trainer.worker_value_and_grad`` in one process
  (deepseek-v2 with 3 experts: the router and the experts whole, the routed
  part alike; zamba2 with a Mamba2 state of 17: in_proj (128, 554) and
  conv_w (4, 290) whole, read in part; gemma-2b with d_ff 255 and 511 tokens:
  the MLP and the tied embedding whole), within LEAF_RTOL or, for a leaf
  whose gradient is rounding residue, FLOOR_FACTOR x ``OneRank``'s distance;
  deepseek-v2's expert ids those of the single process.
* 3 teacher-forced steps of the deepseek-v2 and zamba2 variants at (1, 4)
  under marina:perm with bf16 replicas (``sharded_check.hold``: ACT_BOUNDS
  or 1.5x ``OneRank``'s floor), the bytes handed to gloo equal to the
  dry-run's count of the same step on ``meta`` every step, and the whole
  leaves counted once in ||g||^2 (the step's grad norm held to the single
  process's).
"""
import pytest

import torch_ranks as R
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm
from repro_torch.models import params as P
from repro_torch.train import sharded as SH
from repro_torch.train import sharded_check as SC
from test_torch_train_tp import LEAF_RTOL, LOSS_ATOL


@pytest.fixture(scope="module")
def whole(tmp_path_factory):
    return R.run(tmp_path_factory.mktemp("whole"), "whole", ",".join(SC.VARIANTS), R.TIMEOUT["whole"])


@pytest.mark.parametrize("kind", ["read_in_part", "alike", "alike_gathered"])
def test_whole_weight_backwards_against_finite_differences(whole, kind):
    """ServeShard's rules for a weight "model" does not split: every input's
    gradient within 1e-6 of central differences, on every rank."""
    R.check_backward([rep["fd"] for rep in whole], kind)


@pytest.mark.parametrize("arch", SC.VARIANTS)
def test_leaf_gradients_with_whole_weights(whole, arch):
    """Every leaf of a variant at (1, 4) within LEAF_RTOL of the single
    process's gradient (rounding residue: within FLOOR_FACTOR x OneRank's
    distance), the loss within LOSS_ATOL; the variant has whole product
    weights there, and a moe variant routes as the single process does."""
    cfg = SC.variant(arch)
    mesh = Mesh(("data", "model"), (1, 4))
    blocks = SH.model_blocks(cfg, mesh, 0)
    names = {p[-1] for (p, _), b in zip(P.leaves_with_path(lm.lm_spec(cfg)), blocks) if b.whole}
    assert names & {"router", "in_proj", "w_in", "embed"}, names
    R.check_leaves([rep[("leaves", arch)] for rep in whole], arch.partition("@")[0], (1, 4), LEAF_RTOL, LOSS_ATOL,
                   SC.FLOOR_FACTOR)


@pytest.mark.parametrize("arch", R.WHOLE_STEPS)
def test_steps_with_whole_weights(whole, arch):
    """3 teacher-forced steps at (1, 4) within ``sharded_check``'s bounds,
    the bytes handed to gloo equal to the count, the round trip bit for bit
    and the perm downlink through the block map (``check_case``)."""
    R.check_case([rep[("steps", arch)] for rep in whole], (R.WHOLE_CASE[0], R.WHOLE_CASE[4]), SC.bounds(True), 4)

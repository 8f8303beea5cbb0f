"""The LM train step across a process group against the reference's own
sharded step (tests/test_torch_train_sharded.py's ``reference_case``, in a
file of its own so that the suite's workers share the load): the
reference's ``make_train_step`` jitted on a (2, 2) ("data", "model") mesh of
4 forced host devices, one step from its own state after a first, against
the port's 4 gloo ranks from the same state, batch and draws.
"""
import pytest

from test_torch_train_sharded import reference_case


@pytest.mark.parametrize("spec,act", [pytest.param(s, True, id=s) for s in ("marina:perm", "marina:ind", "ef21p:16:64")]
                         + [pytest.param(s, False, id=f"{s}-worker") for s in ("marina:perm", "marina:ind",
                                                                               "ef21p:16:64")])
def test_four_ranks_against_the_reference_sharded_step(tmp_path, spec, act):
    """``act``: the reference's act_spec program against the port's; else its
    default, the ``worker`` layout through XLA (act_spec None) against the
    port's tensor parallelism over "model"."""
    reference_case(tmp_path, spec, act)

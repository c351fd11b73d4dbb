"""The temporal phase of tests/test_torch_train_f32.py: the same batch
and the same three tests, in a file of its own so that xdist's --dist
loadfile runs the two phases on two workers (the file set the pace of
the whole run: scripts/tier1_schedule.py)."""

import pytest

import test_torch_train_f32 as base


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return base.collect(tmp_path_factory.mktemp("train_f32_temporal"),
                        [True])


@pytest.mark.parametrize("temporal", [True], ids=["temporal"])
def test_float32_differs_from_float64_only_at_relu_ties(steps, temporal):
    base.test_float32_differs_from_float64_only_at_relu_ties(steps, temporal)


@pytest.mark.parametrize("temporal", [True], ids=["temporal"])
def test_float32_with_float64_ties_matches_jax_and_float64(steps,
                                                           temporal):
    base.test_float32_with_float64_ties_matches_jax_and_float64(steps,
                                                                temporal)


@pytest.mark.parametrize("temporal", [True], ids=["temporal"])
def test_jax_float32_moves_as_far_op_by_op(steps, temporal):
    base.test_jax_float32_moves_as_far_op_by_op(steps, temporal)

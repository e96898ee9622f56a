"""§5.1 input slicing: the port's train-step programs with ``num_slices=2``
against the reference's, three steps each.  The check and its tolerances
are ``test_torch_train_step.py``'s (kept in a file of its own so that each
file's run stays short)."""
import pytest

from test_torch_train_step import check_against_jax, jparams  # noqa: F401 (fixture)


@pytest.mark.parametrize("mode", ["faithful", "zero", "off"])
def test_sliced_train_step_matches_jax(jparams, mode):
    check_against_jax(jparams, mode, k=2)

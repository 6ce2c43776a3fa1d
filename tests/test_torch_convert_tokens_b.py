"""Greedy tokens of checkpoints loaded by the port against the JAX
package's, on the CPU in f32: the ten converter types of
``test_torch_convert.HF_TINY`` after the first ten (the check is
``test_torch_convert_tokens_a.check_tokens``)."""

import pytest

from test_torch_convert import TYPES
from test_torch_convert_tokens_a import check_tokens
from test_torch_families import one_torch_thread  # noqa: F401

GROUP = TYPES[10:20]


@pytest.mark.parametrize("mt", GROUP)
def test_loaded_checkpoint_greedy_tokens_match_jax(mt, monkeypatch):
    check_tokens(mt, monkeypatch)

"""Greedy tokens of the experts and latent-attention checkpoints in int4
weights against the JAX package's, on the CPU (the check is
``test_torch_convert_tokens_d.check_expert_tokens``; float weights are
there, int8 in ``test_torch_convert_tokens_e.py``)."""

import pytest

from test_torch_convert import EXPERT_TYPES
from test_torch_convert_tokens_d import check_expert_tokens
from test_torch_families import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("mt", list(EXPERT_TYPES))
def test_int4_expert_checkpoint_tokens_match_jax(mt, monkeypatch):
    check_expert_tokens(mt, monkeypatch, "int4")

"""Greedy tokens of checkpoints loaded by the port against the JAX
package's, on the CPU in f32: the later converter types of
``test_torch_convert.HF_TINY`` (gpt_neo to exaone4; the check is
``test_torch_convert_tokens_a.check_tokens``). Each windowed type's
window (8) is shorter than the prompts, so it cuts in prefill and in
decode. The prompts have ``batch_prompts``' shape with the three fresh
ones at 18-22 tokens (the other token files cover prompts of 9-23)."""

import numpy as np
import pytest

from test_torch_convert import TYPES
from test_torch_convert_tokens_a import check_tokens
from test_torch_families import one_torch_thread  # noqa: F401

GROUP = TYPES[20:]


def one_bucket_prompts():
    rng = np.random.default_rng(5)
    out = [rng.integers(0, 128, n).tolist() for n in (20, 22, 18)]
    return out + [out[0][:16] + rng.integers(0, 128, 7).tolist()]


@pytest.mark.parametrize("mt", GROUP)
def test_loaded_checkpoint_greedy_tokens_match_jax(mt, monkeypatch):
    check_tokens(mt, monkeypatch, one_bucket_prompts())

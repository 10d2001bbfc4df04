"""The train-state round trip of every tree the dense one's test
(``tests/test_torch_train_step.py``) does not cover, through
``repro_torch.models.convert`` (rwkv, moe, hybrid, vlm, audio: parameters,
both AdamW moments and the step, bit for bit), and the train CLI on each
of those families (their batches: audio ``frames``, ``labels`` and
``mask``; vlm ``vision_emb`` beside the tokens; each split into the
config's microbatches), on the CPU.  Their losses, gradients and one
AdamW step against the JAX package's: ``tests/test_torch_train_families.py``.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_train_families import FAMILIES, cfgs, jax_state
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import train_state_from_jax, train_state_to_numpy

torch.set_num_threads(1)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_state_round_trip_is_exact(family):
    """Each new tree's train state, with moments unlike the parameters and a
    step, through ``train_state_from_jax`` and back: every leaf equal in
    shape, dtype and bits."""
    cfg, _ = cfgs(family)
    state = jax_state(family)
    rng = np.random.default_rng(1)
    state["opt"]["m"] = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                                     state["params"])
    state["opt"]["step"] = np.asarray(7, np.int32)
    back = train_state_to_numpy(cfg, train_state_from_jax(cfg, state, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_launch_train_cli_trains_every_family(capsys):
    """``python -m repro_torch.launch.train --reduced --device cpu`` for
    each family: finite losses (the audio batch has frames and a mask, the
    vlm batch an image)."""
    for name, _ in FAMILIES.values():
        res = launch_train.main(["--arch", name, "--reduced", "--device", "cpu", "--steps", "2",
                                 "--batch", "2", "--seq", "16", "--log-every", "0"])
        assert len(res.losses) == 2 and all(np.isfinite(res.losses)), name
        assert "trained 2 steps on cpu" in capsys.readouterr().out

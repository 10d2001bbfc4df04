"""The port's synthetic data pipeline against the JAX package's
(``repro.data.pipeline``), on the CPU: ``SyntheticLM.batch_at`` byte for
byte for every family's fields, and the ``Prefetcher`` sequential and
restartable from ``start_step``."""

import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro_torch.configs import get_config
from repro_torch.core.mesh import make_mesh
from repro_torch.data.pipeline import Prefetcher, SyntheticLM

torch.set_num_threads(1)


@pytest.mark.parametrize("step", [0, 7])
@pytest.mark.parametrize("name", ["stablelm-1.6b", "hubert-xlarge", "llama-3.2-vision-11b"],
                         ids=["dense", "audio", "vlm"])
def test_batch_at_is_byte_identical_to_jax(name, step):
    mine = SyntheticLM(get_config(name).reduced(), 4, 16, seed=3).batch_at(step)
    theirs = JSyntheticLM(j_get_config(name).reduced(), 4, 16, seed=3).batch_at(step)
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        assert mine[k].dtype == theirs[k].dtype and mine[k].shape == theirs[k].shape, k
        assert mine[k].tobytes() == theirs[k].tobytes(), k


def test_prefetcher_is_sequential_and_restartable():
    ds = SyntheticLM(get_config("llama3-8b").reduced(), 2, 8, seed=1)
    pf = Prefetcher(ds, "cpu", start_step=0)
    first = [next(pf) for _ in range(5)]
    pf.stop()
    assert [s for s, _ in first] == list(range(5))
    for step, batch in first:
        for k, v in ds.batch_at(step).items():
            assert batch[k].dtype == torch.from_numpy(v).dtype
            np.testing.assert_array_equal(batch[k].numpy(), v)
    again = Prefetcher(ds, "cpu", start_step=3)
    resumed = [next(again) for _ in range(2)]
    again.stop()
    assert [s for s, _ in resumed] == [3, 4]
    for (_, a), (_, b) in zip(resumed, first[3:]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert not again._thread.is_alive()


def test_host_slice_takes_this_process_rows():
    batch = SyntheticLM(get_config("llama3-8b").reduced(), 4, 8).batch_at(0)
    assert SyntheticLM.host_slice(batch) is batch  # one process
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu", processes=2, process_index=1)
    got = SyntheticLM.host_slice(batch, mesh)
    for k, v in batch.items():
        np.testing.assert_array_equal(got[k], v[2:4])

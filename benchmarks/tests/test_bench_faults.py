"""A run with the timed path broken underneath comes out not correct,
for each fault an alignment cell can have: an answer altered where it is
produced, and half of the batch left out.  And the control, the
reference in the program's place one score type down, comes out not
correct where that type cannot hold the cell's scores."""

import numpy as np
import pytest
import torch

from benchmarks import control
from benchmarks.tests.conftest import TINY, cpu_run, tiny_cell


def _alter_a_score(monkeypatch):
    """The fill's scores come out one higher (an off-by-one where they are
    produced); Hirschberg's, which its rescoring of the lines produces,
    too."""
    from tpu_align_torch.distributed import sharding
    from tpu_align_torch.traceback import hirschberg

    fill = sharding.fill_sharded

    def altered(*args, **kw):
        outs = list(fill(*args, **kw))
        outs[0] = [s.clone() for s in outs[0]]
        outs[0][0] += 1
        return tuple(outs)

    monkeypatch.setattr(sharding, "fill_sharded", altered)
    rescore = hirschberg._rescore
    monkeypatch.setattr(hirschberg, "_rescore",
                        lambda p, r, q: rescore(p, r, q) + 1)


def _drop_half(monkeypatch):
    """Each run aligns the first half of its batch alone (Hirschberg's
    leaf runs, nested in it, are left whole)."""
    from tpu_align_torch.runtime.engine import AlignmentEngine

    run = AlignmentEngine.run
    depth = []

    def half(self, ds, *args, **kw):
        if depth:
            return run(self, ds, *args, **kw)
        depth.append(1)
        try:
            return run(self, ds.select(np.arange(len(ds) // 2)), *args,
                       **kw)
        finally:
            depth.pop()

    monkeypatch.setattr(AlignmentEngine, "run", half)


@pytest.mark.parametrize("fault", [_alter_a_score, _drop_half])
@pytest.mark.parametrize("name", sorted(TINY))
def test_a_broken_path_is_not_correct(name, fault, bench, monkeypatch):
    fault(monkeypatch)
    res = cpu_run(tiny_cell(name), bench)
    assert not res["correct"], res["checks"]
    assert any(v["value"] > v["limit"] for v in res["checks"].values())


@pytest.mark.parametrize("name", ["lnw-reads250-device", "lnw-reads250-host"])
def test_int8_control_fails_on_reads_int16_is_exact(name, bench):
    cell = tiny_cell(name)
    cell.config["reference_length"] = 120  # scores past int8, within int16
    low = control.control_run(cell, 7, 0.1, torch.int8, "cpu", bench,
                              log=lambda m: None)
    assert not low["correct"] and low["checks"]["blocks_wrong"]["value"] > 0
    same = control.control_run(cell, 7, 0.1, torch.int16, "cpu", bench,
                               log=lambda m: None)
    assert same["correct"]


@pytest.mark.parametrize("name", ["lnw-long16k-hirschberg",
                                  "lnw-long16k-scores"])
def test_int16_control_fails_on_long_pairs(name, bench):
    cell = tiny_cell(name)
    # 12,000 bp pairs: at the configuration's 1 % divergence their scores
    # (about 35,500) pass 32,767, as the cell's do
    cell.config["reference_length"] = 12000
    cell.traffic.update(batch_pairs=1, pool_batches=1, check_pairs=None)
    res = control.control_run(cell, 7, 0.0, torch.int16, "cpu", bench,
                              log=lambda m: None)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", ["lnw-reads250-device", "lnw-reads250-host"])
def test_one_altered_block_is_caught(name, bench, monkeypatch):
    """The blocks cells compare every pair: one pair's score one higher
    is enough."""
    from tpu_align_torch.distributed import sharding

    fill = sharding.fill_sharded

    def altered(*args, **kw):
        outs = list(fill(*args, **kw))
        outs[0] = [s.clone() for s in outs[0]]
        outs[0][0][3] += 1
        return tuple(outs)

    monkeypatch.setattr(sharding, "fill_sharded", altered)
    res = cpu_run(tiny_cell(name), bench)
    assert not res["correct"]
    assert res["failed"] >= 1

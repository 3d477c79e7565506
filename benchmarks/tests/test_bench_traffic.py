"""The vectorised generator: one seed, one pool; the stated lengths and
mutation rates; the same distribution as the program's own generator."""

import numpy as np
import torch

from benchmarks import traffic


def _batch(seed, ref_len=250, pairs=4000, sub=0.05, ins=0.02, dele=0.02):
    gen = torch.Generator()
    gen.manual_seed(seed)
    sizes = traffic.batch_sizes(seed, ref_len, pairs, ins, dele)
    return traffic.mutated_batch(traffic.rng_for(seed, 0), gen, sizes, sub)


def test_same_seed_same_pool_other_seed_other_pool():
    cfg = {"reference_length": 250,
           "mutation": {"substitution": 0.05, "insertion": 0.02,
                        "deletion": 0.02}}
    t = {"batch_pairs": 300, "pool_batches": 3}
    a = traffic.make_pool(cfg, t, 2**31 + 5)
    b = traffic.make_pool(cfg, t, 2**31 + 5)
    c = traffic.make_pool(cfg, t, 2**31 + 6)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            assert np.array_equal(u, v)
    assert not np.array_equal(a[0][0], c[0][0])
    assert not np.array_equal(a[0][0], a[1][0])  # the pool's batches differ
    assert len(a) == 3 and all(len(x[2]) == 300 for x in a)
    # another seed: the same sizes in another order
    for x, y in zip(a, c):
        assert sorted(x[4]) == sorted(y[4]) and not np.array_equal(x[4], y[4])


def test_layout_and_bases():
    buf, ro, rl, qo, ql = _batch(1, pairs=50)
    assert buf.dtype == np.uint8 and set(np.unique(buf)) <= set(b"ACGT")
    assert (rl == 250).all() and ro[0] == 0
    assert qo[0] == rl.sum() and qo[-1] + ql[-1] == buf.size
    assert (ql >= 1).all()


def test_length_range():
    _, _, rl, _, _ = _batch(2, ref_len=[20, 250], pairs=5000)
    assert rl.min() == 20 and rl.max() == 250
    assert abs(rl.mean() - 135) < 3


def test_substitutions_alone():
    buf, ro, rl, qo, ql = _batch(3, pairs=2000, ins=0, dele=0)
    assert (ql == rl).all()
    ref = buf[:rl.sum()]
    qry = buf[rl.sum():]
    # a substitution draws any of the four bases: 3/4 of them change one
    assert abs((ref != qry).mean() - 0.05 * 0.75) < 0.002


def test_deletions_keep_order():
    buf, ro, rl, qo, ql = _batch(4, pairs=300, sub=0, ins=0)
    assert abs(ql.mean() / 250 - 0.98) < 0.003
    for k in range(20):  # the query is a subsequence of the reference
        ref = buf[ro[k]:ro[k] + rl[k]].tobytes()
        qry = buf[qo[k]:qo[k] + ql[k]].tobytes()
        it = iter(ref)
        assert all(ch in it for ch in qry)


def test_insertions_only_add():
    buf, ro, rl, qo, ql = _batch(5, pairs=3000, sub=0, dele=0)
    assert abs(ql.mean() / 250 - 1.02) < 0.003
    for k in range(20):  # the reference is a subsequence of the query
        ref = buf[ro[k]:ro[k] + rl[k]].tobytes()
        qry = buf[qo[k]:qo[k] + ql[k]].tobytes()
        it = iter(qry)
        assert all(ch in it for ch in ref)


def test_same_distribution_as_the_programs_generator():
    from tpu_align_torch.utils.synthetic import synthetic_dataset

    ds = synthetic_dataset(3000, uniform_len=250, seed=9)
    _, _, _, _, ql = _batch(9, pairs=3000)
    assert abs(ql.mean() - ds.qry_len.mean()) < 0.3
    assert abs(ql.std() - ds.qry_len.std()) < 0.3

"""The one traffic generator: read pairs from a configuration, a traffic
mix and a seed.

A pair is a reference of the configuration's length (one length, or
uniform over a range) over ACGT, and a query that is a mutated copy of
it: Binomial(length, deletion rate) of its bases are deleted, each kept
one is substituted with the substitution rate by a base drawn from ACGT
(which may be the same), then Binomial(kept, insertion rate) bases drawn
from ACGT are inserted at uniform positions; an empty query gets one.
That is the distribution of the program's own generator
(tpu_align_torch/utils/synthetic.py `synthetic_dataset`), drawn for a
whole batch at once instead of a pair at a time.

The per-pair sizes come from one fixed stream, the same for every seed,
and the seed orders them: a run's work does not change with its seed
(the 16 kbp queries straddle a bucket boundary, so drawn sizes would
change a batch's buckets).  The per-base draws run on the run's device
in a few large calls (a torch.Generator seeded from --seed).  A
batch comes back as the flat-buffer form the program's PairDataset takes
(buffer, ref_off, ref_len, qry_off, qry_len), in numpy; nothing of the
program is imported here.
"""

from __future__ import annotations

import numpy as np
import torch

BASES = np.frombuffer(b"ACGT", np.uint8)
SIZES = 0x51CE5  # the stream of the per-pair sizes, one for every seed


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """The host generator of one stream of a run (0: per-pair draws of
    the pool, 1: the sample of outputs kept for the check, 2: the sample
    of pairs a score check compares); any integer seed."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def _starts(counts):
    """Exclusive prefix sums: where each run of `counts` starts."""
    out = torch.zeros_like(counts)
    torch.cumsum(counts[:-1], 0, out=out[1:])
    return out


def batch_sizes(index: int, ref_len, pairs: int, ins_rate: float,
                del_rate: float) -> tuple:
    """Batch `index`'s per-pair sizes, the same for every seed: reference
    lengths, deleted and inserted bases (Binomial(length, deletion rate),
    then Binomial(kept, insertion rate); an empty query gets one
    insertion).  A seed only orders them, so every seed's batches fall
    into the same buckets and carry the same work."""
    rng = np.random.default_rng([SIZES, index])
    if isinstance(ref_len, (list, tuple)):
        lens = rng.integers(int(ref_len[0]), int(ref_len[1]) + 1, pairs)
    else:
        lens = np.full(pairs, int(ref_len))
    n_del = rng.binomial(lens, del_rate)
    kept = lens - n_del
    n_ins = rng.binomial(np.maximum(kept, 1), ins_rate)
    n_ins = np.where(kept + n_ins == 0, 1, n_ins)
    return lens, n_del, n_ins


def mutated_batch(rng: np.random.Generator, gen: torch.Generator,
                  sizes: tuple, sub_rate: float):
    """One batch with the given per-pair sizes in the order rng draws,
    its bases drawn on gen's device: which bases are deleted (uniform,
    without replacement), substituted (each with sub_rate, by any of the
    four bases) and inserted where (uniform positions in [0, kept]).
    Returns (buffer, ref_off, ref_len, qry_off, qry_len) in numpy: the
    references first, then the queries, in one uint8 buffer."""
    dev = gen.device
    order = rng.permutation(len(sizes[0]))
    lens, n_del, n_ins = (torch.from_numpy(x[order].astype(np.int64)).to(dev)
                          for x in sizes)
    pairs = len(order)
    bases = torch.from_numpy(BASES.copy()).to(dev)
    total = int(sizes[0].sum())

    def draw_bases(n):
        return bases[torch.randint(0, 4, (n,), generator=gen, device=dev)]

    owner = torch.repeat_interleave(torch.arange(pairs, device=dev), lens)
    ref = draw_bases(total)
    # a pair's n_del bases with the smallest random keys are deleted
    key = owner.to(torch.float64) + torch.rand(total, generator=gen,
                                               device=dev,
                                               dtype=torch.float64)
    rank = torch.empty(total, dtype=torch.int64, device=dev)
    rank[torch.argsort(key)] = torch.arange(total, device=dev)
    keep = rank - _starts(lens)[owner] >= n_del[owner]
    subs = torch.rand(total, generator=gen, device=dev) < sub_rate
    kept = torch.where(subs, draw_bases(total), ref)[keep]
    kept_owner = owner[keep]
    kept_len = lens - n_del
    ins_owner = torch.repeat_interleave(torch.arange(pairs, device=dev),
                                        n_ins)
    # uniform positions in [0, kept]: an insertion at p goes before kept[p]
    ins_pos = torch.floor(
        torch.rand(ins_owner.numel(), generator=gen, device=dev,
                   dtype=torch.float64)
        * (kept_len[ins_owner] + 1)).to(torch.int64)
    span = int(kept_len.max()) + 2
    ins_pos = torch.sort(ins_owner * span + ins_pos).values - ins_owner * span
    qry_len = kept_len + n_ins
    qry_off = _starts(qry_len)
    ins_first = _starts(n_ins)
    ins_rank = torch.arange(ins_owner.numel(), device=dev) \
        - ins_first[ins_owner]
    kept_idx = torch.arange(kept.numel(), device=dev) \
        - _starts(kept_len)[kept_owner]
    # insertions of the same pair at or before each kept base's index: a
    # running count over each pair's kept_len + 1 insertion slots
    slot_first = _starts(kept_len + 1)
    slots = torch.cumsum(torch.bincount(slot_first[ins_owner] + ins_pos,
                                        minlength=int(kept.numel()) + pairs),
                         0)
    before = slots[slot_first[kept_owner] + kept_idx] - ins_first[kept_owner]
    qry = torch.empty(int(qry_len.sum()), dtype=torch.uint8, device=dev)
    qry[qry_off[kept_owner] + kept_idx + before] = kept
    qry[qry_off[ins_owner] + ins_pos + ins_rank] = draw_bases(
        ins_owner.numel())
    buffer = torch.cat([ref, qry]).cpu().numpy()
    return (buffer, _starts(lens).cpu().numpy(), lens.cpu().numpy(),
            (qry_off + total).cpu().numpy(), qry_len.cpu().numpy())


def make_pool(config: dict, traffic: dict, seed: int,
              device: str = "cpu") -> list[tuple]:
    """The pool of distinct batches a run cycles through: the same sizes
    for every seed, the seed's order and bases (drawn on `device`: the
    same seed and device, the same pool)."""
    rng = rng_for(seed, 0)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    mut = config["mutation"]
    return [mutated_batch(rng, gen,
                          batch_sizes(k, config["reference_length"],
                                      traffic["batch_pairs"],
                                      mut["insertion"], mut["deletion"]),
                          mut["substitution"])
            for k in range(traffic["pool_batches"])]


def pairs_of(batch) -> list[tuple[bytes, bytes]]:
    """The (reference, query) byte strings of a batch, in pair order."""
    buffer, ref_off, ref_len, qry_off, qry_len = batch
    return [(buffer[ro:ro + rl].tobytes(), buffer[qo:qo + ql].tobytes())
            for ro, rl, qo, ql in zip(ref_off.tolist(), ref_len.tolist(),
                                      qry_off.tolist(), qry_len.tolist())]

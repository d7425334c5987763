"""The port's split-bank prefetch: rotated canonical order, merge, the
placement copy, and the one-unit-ahead bank pipeline."""
import numpy as np
import pytest
import torch

from repro.core import placement as jplacement
from repro_torch.core import placement as tplacement
from repro_torch.core import prefetch
from repro_torch.core.execution import BankPipeline

# One intra-op thread per process: the suite runs several test workers, and
# the port's test shapes are too small to gain from more.
torch.set_num_threads(1)


def _shards(pl, width=3):
    """Rank r's resident tree: rows tagged with their canonical slice id."""
    table = pl.table()
    return [
        {"w": torch.as_tensor(table[r], dtype=torch.float32)[:, None].repeat(1, width),
         "sub": {"v": torch.as_tensor(table[r] * 10, dtype=torch.float32)[:, None, None]}}
        for r in range(pl.group_size)
    ]


@pytest.mark.parametrize("experts,group,redundancy", [(8, 4, None), (4, 4, None), (2, 4, None), (6, 3, 1)])
def test_gather_split_bank_rotated_order(experts, group, redundancy):
    pl = tplacement.make_placement(experts, group, redundancy=redundancy)
    g, local = pl.subgroup_size, pl.local_count
    shards = _shards(pl)
    for rank in range(pl.group_size):
        p = rank % g
        bank = prefetch.gather_split_bank(shards, rank, pl)
        assert bank.local is shards[rank]  # the resident shard is never copied
        remote = bank.remote["w"][:, 0].numpy()
        assert remote.shape == ((g - 1) * local,)
        for j in range(g - 1):
            for i in range(local):
                assert remote[j * local + i] == ((p + 1 + j) % g) * local + i
        merged = prefetch.merge_split_bank(bank, rank, pl)
        np.testing.assert_array_equal(merged["w"][:, 0].numpy(), np.arange(pl.num_padded))
        np.testing.assert_array_equal(merged["sub"]["v"][:, 0, 0].numpy(),
                                      10 * np.arange(pl.num_padded))


def test_gather_split_bank_single_rank_and_transports():
    pl = tplacement.make_placement(4, 1)
    shards = _shards(pl)
    bank = prefetch.gather_split_bank(shards, 0, pl)
    assert bank.remote["w"].shape[0] == 0
    assert prefetch.merge_split_bank(bank, 0, pl) is bank.local
    pl4 = tplacement.make_placement(8, 4)
    want = prefetch.gather_split_bank(_shards(pl4), 1, pl4)
    for mode in ("ring", "ring_sliced"):
        got = prefetch.gather_split_bank(_shards(pl4), 1, pl4, mode=mode, num_slices=3)
        assert torch.equal(got.remote["w"], want.remote["w"])
    with pytest.raises(ValueError, match="transport"):
        prefetch.gather_split_bank(_shards(pl4), 0, pl4, mode="tree")


@pytest.mark.parametrize("experts,group", [(8, 4), (256, 4), (3, 4), (5, 8), (8, 1)])
def test_placement_copy_matches_jax(experts, group):
    a = tplacement.make_placement(experts, group)
    b = jplacement.make_placement(experts, group)
    assert (a.num_experts, a.group_size, a.redundancy, a.subgroup_size, a.num_padded,
            a.local_count) == (b.num_experts, b.group_size, b.redundancy, b.subgroup_size,
                               b.num_padded, b.local_count)
    np.testing.assert_array_equal(a.table(), b.table())
    assert a.shift_pairs(1) == b.shift_pairs(1)


def test_bank_pipeline_issues_one_unit_ahead():
    issued = []

    def unit(k):
        def thunk(stream):
            assert stream is None  # CPU: no side stream
            issued.append(k)
            return k
        return (k, thunk)

    pipe = BankPipeline([unit(k) for k in "abcd"], torch.device("cpu"))
    assert pipe.get("a") == "a" and issued == ["a", "b"]
    assert pipe.get("b") == "b" and issued == ["a", "b", "c"]
    assert len(pipe.pending) == 1  # at most the one landing unit waits
    assert pipe.get("c") == "c" and pipe.get("d") == "d"
    assert issued == list("abcd") and not pipe.pending

"""The plain reference against hand-worked rounds."""
import numpy as np
import pytest

from bench.reference import EMPTY, NOTFOUND, Dictionary
from bench.reference.dictionary import OP_DELETE, OP_FIND, OP_INSERT, OP_NOP, OP_RANGE


def apply(d, lanes, cap=4):
    ops, keys, vals = (np.array(x) for x in zip(*lanes))
    return d.apply_round(ops, keys, vals, cap)


def test_point_lanes_apply_in_arrival_order():
    d = Dictionary()
    a = apply(d, [(OP_INSERT, 5, 50), (OP_INSERT, 5, 51), (OP_FIND, 5, 0), (OP_DELETE, 5, 0),
                  (OP_FIND, 5, 0), (OP_DELETE, 5, 0), (OP_INSERT, 5, 52), (OP_NOP, 9, 0)])
    assert a.results.tolist() == [NOTFOUND, 50, 50, 50, NOTFOUND, NOTFOUND, NOTFOUND, NOTFOUND]
    assert a.found.tolist() == [False, True, True, True, False, False, False, False]
    assert d.d == {5: 52}


def test_range_lanes_read_the_round_start_dictionary():
    d = Dictionary()
    apply(d, [(OP_INSERT, k, 10 * k) for k in (1, 3, 5, 7)])
    # the round deletes 3 and inserts 4 before its range lane in arrival
    # order: the range lane still sees the dictionary as of round start
    a = apply(d, [(OP_DELETE, 3, 0), (OP_INSERT, 4, 40), (OP_RANGE, 2, 5), (OP_FIND, 4, 0)])
    assert a.range_lanes.tolist() == [2]
    assert a.count.tolist() == [2] and a.results[2] == 2 and a.found[2]
    assert a.row_keys[0].tolist() == [3, 5, EMPTY, EMPTY]
    assert a.row_vals[0].tolist() == [30, 50, 0, 0]
    assert a.results[3] == 40  # the find after the insert in arrival order
    # the next round sees the writes
    b = apply(d, [(OP_RANGE, 2, 5)])
    assert b.row_keys[0].tolist() == [4, 5, EMPTY, EMPTY]


def test_range_cap_truncation_and_saturating_span():
    d = Dictionary()
    apply(d, [(OP_INSERT, k, k) for k in range(10)])
    a = apply(d, [(OP_RANGE, 2, 100), (OP_RANGE, 8, 2**63 - 1), (OP_RANGE, 20, 5), (OP_RANGE, 3, 0)],
              cap=3)
    assert a.count.tolist() == [3, 2, 0, 0]
    assert a.truncated.tolist() == [True, False, False, False]
    assert a.row_keys[0].tolist() == [2, 3, 4]
    assert a.row_keys[1].tolist() == [8, 9, EMPTY]
    assert a.found.tolist() == [True, True, False, False]


def test_sorted_copy_follows_many_rounds():
    rng = np.random.default_rng(3)
    d = Dictionary()
    for _ in range(20):
        ops = rng.choice([OP_INSERT, OP_DELETE, OP_FIND, OP_RANGE], 64)
        keys = rng.integers(0, 50, 64)
        vals = np.where(ops == OP_RANGE, rng.integers(0, 20, 64), rng.integers(0, 1000, 64))
        snap = dict(d.d)
        a = d.apply_round(ops, keys, vals, 8)
        for j, i in enumerate(a.range_lanes.tolist()):
            want = sorted((k, v) for k, v in snap.items() if keys[i] <= k < keys[i] + vals[i])
            n = int(a.count[j])
            assert list(zip(a.row_keys[j, :n].tolist(), a.row_vals[j, :n].tolist())) == want[:8]
            assert a.truncated[j] == (len(want) > 8)
    sk, sv = d.sorted_items()
    assert dict(zip(sk.tolist(), sv.tolist())) == d.d


@pytest.mark.parametrize("broken", ["range_after_writes", "round_start_reads"])
def test_broken_guarantees_answer_differently(broken):
    lanes = [(OP_INSERT, 1, 10), (OP_INSERT, 2, 20)]
    round2 = [(OP_INSERT, 3, 30), (OP_RANGE, 0, 10), (OP_DELETE, 1, 0), (OP_DELETE, 2, 0),
              (OP_FIND, 1, 0)]
    sound, bad = Dictionary(), Dictionary(broken)
    for d in (sound, bad):
        apply(d, lanes)
    a, b = apply(sound, round2), apply(bad, round2)
    assert a.results.tolist() != b.results.tolist()
    assert sound.d == bad.d  # the writes themselves agree


def test_bad_inputs_are_refused():
    with pytest.raises(ValueError):
        Dictionary("no_such_guarantee")
    with pytest.raises(ValueError):
        apply(Dictionary(), [(7, 1, 1)])
    with pytest.raises(ValueError):
        apply(Dictionary(), [(OP_RANGE, 1, -1)])

"""The traffic generator: the same calls for every seed, in an order and
with tokens the seed draws."""

import pytest

from portbench import spec
from portbench.traffic import Traffic, bucket_length

MIXES = {"ruler_niah_4k_8k": 32000, "ruler_niah_8k_b4": 152064}


def mix(name):
    return spec.load_json(spec.HERE / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", sorted(MIXES))
def test_every_seed_sends_every_call_each_round(name):
    doc = mix(name)
    want = sorted(tuple(c) for c in doc["calls"])
    orders = []
    for seed in (0, 7, 2**31 + 12345):
        rounds = Traffic(doc, MIXES[name], seed).rounds()
        for _ in range(3):
            lens = [tuple(len(p) for p in call) for call in next(rounds)]
            assert sorted(lens) == want
        orders.append(lens)
    assert len({tuple(o) for o in orders}) > 1 or len(want) == 1


def test_mixes_name_their_source():
    for name in MIXES:
        assert mix(name)["source"].strip()


def test_same_seed_same_prompts_and_ids_in_range():
    doc = mix("ruler_niah_4k_8k")
    a = next(Traffic(doc, 32000, 99).rounds())
    b = next(Traffic(doc, 32000, 99).rounds())
    c = next(Traffic(doc, 32000, 100).rounds())
    assert a == b and a != c
    assert min(min(p) for call in a for p in call) >= 5
    assert max(max(p) for call in a for p in call) < 32000 - 5


def test_buckets():
    assert Traffic(mix("ruler_niah_4k_8k"), 32000, 0).buckets() == [4096, 8192]
    assert Traffic(mix("ruler_niah_8k_b4"), 152064, 0).buckets() == [8192]
    assert bucket_length(4096) == 4096 and bucket_length(4097) == 8192


def test_warm_prompts_one_call_per_bucket():
    t = Traffic(mix("ruler_niah_8k_b4"), 152064, 3)
    warm = t.warm_prompts()
    assert len(warm) == 1 and len(warm[0]) == 4
    assert {len(p) for p in warm[0]} == {8064}
    assert [[len(p) for p in c] for c in Traffic(mix("ruler_niah_4k_8k"), 32000, 3)
            .warm_prompts()] == [[3968], [8064]]


def test_calls_of_unequal_lanes_are_refused():
    with pytest.raises(ValueError):
        Traffic({"calls": [[10, 20], [30]], "max_new_tokens": 4}, 100, 0)

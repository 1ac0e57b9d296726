"""Port parity for ValidatorSet.update_with_change_set (reference:
types/validator_set.py:226) and the proposer rotation after it, against
the JAX package.

Each seed drives about 40 heights of random change sets (adds, removals,
power changes, and invalid sets: a duplicate address, a negative power,
the removal of an unknown validator, a set that would be empty or over
the total-power cap) through update_with_change_set and
increment_proposer_priority(1), as update_state applies them; after
every height the order, the powers, the priorities and the proposer
must equal the reference's, and each invalid set must raise the same
error at the same input and leave the set as it was in both. No
signature is verified. Tolerance: exact."""

import hashlib

import numpy as np
import pytest

from test_torch_execution import PORT, REF, outcome

N_KEYS = 48


def pub(i: int) -> bytes:
    from tendermint_tpu_torch.crypto import ed25519_ref

    return ed25519_ref.public_key_from_seed(
        hashlib.sha256(b"change-set-%d" % i).digest())


PUBS = [pub(i) for i in range(N_KEYS)]


def val(p, i: int, power: int):
    return p.validator.Validator.new(p.ed.Ed25519PubKey(PUBS[i]), power)


def view(vs) -> list:
    return ([(v.address, v.voting_power, v.proposer_priority)
             for v in vs.validators],
            vs.get_proposer().address, vs.total_voting_power(), vs.hash())


def random_changes(rng, members: set[int]) -> list[tuple[int, int]]:
    """(key index, power) pairs: a valid change set most of the time,
    an invalid one now and then."""
    kind = rng.integers(0, 10)
    outside = [i for i in range(N_KEYS) if i not in members]
    inside = sorted(members)
    changes: dict[int, int] = {}
    for _ in range(int(rng.integers(1, 4))):
        if outside and rng.random() < 0.4:
            changes[int(rng.choice(outside))] = int(rng.integers(1, 100))
        if inside and rng.random() < 0.4:
            changes[int(rng.choice(inside))] = int(rng.integers(1, 1000))
        if len(inside) > 2 and rng.random() < 0.3:
            changes[int(rng.choice(inside))] = 0
    pairs = list(changes.items()) or [(inside[0], 5)]
    if kind == 0:  # a duplicate address
        pairs.append(pairs[0])
    elif kind == 1:  # a negative power
        pairs.append((int(rng.choice(outside or inside)), -3))
    elif kind == 2 and outside:  # removing an unknown validator
        pairs.append((int(rng.choice(outside)), 0))
    return pairs


@pytest.mark.parametrize("seed", range(6))
def test_random_change_sets_keep_the_reference_order(seed):
    rng = np.random.default_rng(1500 + seed)
    start = sorted(int(i) for i in rng.choice(N_KEYS, 8, replace=False))
    powers = [int(rng.integers(1, 50)) for _ in start]
    sets = {k: p.vset.ValidatorSet([val(p, i, w) for i, w in zip(start, powers)])
            for k, p in (("port", PORT), ("reference", REF))}
    members = set(start)
    errors = 0
    for _ in range(40):
        pairs = random_changes(rng, members)
        got = {}
        for k, p in (("port", PORT), ("reference", REF)):
            vs = sets[k]
            before = view(vs)
            res = outcome(lambda: vs.update_with_change_set(
                [val(p, i, w) for i, w in pairs]))
            if res[0] != "ok":
                assert view(vs) == before  # an invalid set changes nothing
            vs.increment_proposer_priority(1)
            got[k] = (res, view(vs))
        assert got["port"] == got["reference"]
        if got["port"][0][0] == "ok":
            members = {i for i in range(N_KEYS)
                       if sets["port"].has_address(
                           PORT.ed.Ed25519PubKey(PUBS[i]).address())}
        else:
            errors += 1
    assert errors > 0 and len(members) > 2


CASES = {
    "duplicate": ([(0, 5), (0, 6)], "duplicate address in change set"),
    "negative": ([(9, -1)], "negative power update"),
    "unknown_removal": ([(9, 0)], "removing unknown validator"),
    "empty": ([(i, 0) for i in range(4)], "validator set would be empty"),
    "over_cap": ([(9, (1 << 62) // 8)], "total voting power would exceed cap"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_invalid_change_sets_raise_the_reference_error(case):
    pairs, message = CASES[case]
    got = []
    for p in (PORT, REF):
        vs = p.vset.ValidatorSet([val(p, i, 10) for i in range(4)])
        got.append((outcome(lambda: vs.update_with_change_set(
            [val(p, i, w) for i, w in pairs])), view(vs)))
    assert got[0] == got[1] and got[0][0] == ("ValueError", message)


def test_new_validator_priority_and_sort():
    """A new validator starts at -(T + T >> 3) of the new total T before
    the average shift, the set stays sorted by (-power, address), and an
    updated validator keeps its priority."""
    got = []
    for p in (PORT, REF):
        vs = p.vset.ValidatorSet([val(p, i, 10 * (i + 1)) for i in range(5)])
        vs.increment_proposer_priority(3)
        vs.update_with_change_set([val(p, 7, 25), val(p, 2, 5), val(p, 0, 0)])
        got.append(view(vs))
    assert got[0] == got[1]
    rows = got[0][0]
    assert [r[1] for r in rows] == sorted((r[1] for r in rows), reverse=True)
    assert sum(r[2] for r in rows) in range(-len(rows) + 1, len(rows))
    assert len(rows) == 5 and not any(r[0] == val(PORT, 0, 1).address
                                      for r in rows)


def test_empty_change_set_is_a_no_op():
    for p in (PORT, REF):
        vs = p.vset.ValidatorSet([val(p, i, 10) for i in range(3)])
        before = view(vs)
        vs.update_with_change_set([])
        assert view(vs) == before

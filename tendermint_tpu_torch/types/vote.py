"""Vote types (reference: types/vote.go) — only what a commit's sign
bytes and validation need in this slice of the port."""

from __future__ import annotations

import enum


class VoteType(enum.IntEnum):
    PREVOTE = 1
    PRECOMMIT = 2

    @classmethod
    def is_valid(cls, v: int) -> bool:
        return v in (cls.PREVOTE, cls.PRECOMMIT)


MAX_VOTES_COUNT = 10000  # DoS bound, reference types/vote_set.go:14-18

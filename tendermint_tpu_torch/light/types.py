"""Light-client data types (reference: types/light.go) and
LightClientAttackEvidence (reference: types/evidence.go:215).

A LightBlock is the minimum a light client needs per height: the
signed header (header + commit) and the validator set that signed it.
LightClientAttackEvidence proves a set of validators signed a
conflicting light block: the light client's detector builds it on
witness/primary divergence and full nodes verify it against their own
chain, punishing the signers via ABCI (to_abci, the BeginBlock
byzantine_validators entries). The detector is light/client.py's; the
verification, evidence/verify.py's."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..crypto import tmhash
from ..encoding.proto import Reader, Writer
from ..types.block import Commit, Header
from ..types.evidence import Evidence
from ..types.validator import Validator
from ..types.validator_set import ValidatorSet


@dataclass
class SignedHeader:
    header: Header
    commit: Commit

    def validate_basic(self, chain_id: str) -> None:
        if self.header is None or self.commit is None:
            raise ValueError("signed header missing header or commit")
        self.header.validate_basic()
        self.commit.validate_basic()
        if self.header.chain_id != chain_id:
            raise ValueError(
                f"header chain id {self.header.chain_id!r} != {chain_id!r}")
        if self.commit.height != self.header.height:
            raise ValueError("commit height != header height")
        if self.commit.block_id.hash != self.header.hash():
            raise ValueError("commit is for a different block")


@dataclass
class LightBlock:
    signed_header: SignedHeader
    validator_set: ValidatorSet

    def height(self) -> int:
        return self.signed_header.header.height

    def time(self) -> int:
        return self.signed_header.header.time

    def hash(self) -> bytes:
        return self.signed_header.header.hash()

    def validate_basic(self, chain_id: str) -> None:
        self.signed_header.validate_basic(chain_id)
        self.validator_set.validate_basic()
        if self.signed_header.header.validators_hash != \
                self.validator_set.hash():
            raise ValueError(
                "validator set does not match header validators_hash")

    def to_proto(self) -> Writer:
        """Wire layout mirrors the reference proto exactly
        (proto/tendermint/types/types.proto:140 LightBlock:
        signed_header=1, validator_set=2; validator.proto:9
        ValidatorSet: validators=1, proposer=2, total_voting_power=3)
        so evidence bytes and hashes interop with reference-format
        peers."""
        sh = Writer()
        sh.bytes(1, self.signed_header.header.to_proto().finish(),
                 skip_empty=False)
        sh.bytes(2, self.signed_header.commit.to_bytes(),
                 skip_empty=False)
        vs = Writer()
        for v in self.validator_set.validators:
            vs.bytes(1, v.to_proto().finish(), skip_empty=False)
        if self.validator_set.proposer is not None:
            vs.bytes(2, self.validator_set.proposer.to_proto().finish(),
                     skip_empty=False)
        vs.varint(3, self.validator_set.total_voting_power())
        w = Writer()
        w.message(1, sh)
        w.message(2, vs)
        return w

    @classmethod
    def from_bytes(cls, data: bytes) -> "LightBlock":
        r = Reader(data)
        header = commit = None
        proposer: Validator | None = None
        vals: list[Validator] = []
        while not r.at_end():
            f, wt = r.field()
            if f == 1:
                sr = Reader(r.bytes())
                while not sr.at_end():
                    sf, swt = sr.field()
                    if sf == 1:
                        header = Header.from_bytes(sr.bytes())
                    elif sf == 2:
                        commit = Commit.from_bytes(sr.bytes())
                    else:
                        sr.skip(swt)
            elif f == 2:
                vr = Reader(r.bytes())
                while not vr.at_end():
                    vf, vwt = vr.field()
                    if vf == 1:
                        vals.append(Validator.from_bytes(vr.bytes()))
                    elif vf == 2:
                        proposer = Validator.from_bytes(vr.bytes())
                    elif vf == 3:
                        vr.varint()  # total_voting_power: recomputed
                    else:
                        vr.skip(vwt)
            else:
                r.skip(wt)
        if header is None or commit is None:
            raise ValueError("light block missing header or commit")
        # Restore the set EXACTLY (order, priorities, proposer): the
        # ValidatorSet constructor re-runs proposer-priority rotation,
        # which would change the wire bytes and thus the evidence hash.
        vs = ValidatorSet([])
        vs.validators = vals
        if proposer is not None:
            _, vp = vs.get_by_address(proposer.address)
            vs.proposer = vp if vp is not None else proposer
        return cls(SignedHeader(header, commit), vs)


def conflicting_header_is_invalid(conflicting: Header, trusted: Header) -> bool:
    """True when the conflicting header could not have been produced by
    the chain the trusted header is on — a LUNATIC attack: any of the
    deterministically-derived fields differ (reference:
    types/evidence.go ConflictingHeaderIsInvalid)."""
    return (
        conflicting.validators_hash != trusted.validators_hash
        or conflicting.next_validators_hash != trusted.next_validators_hash
        or conflicting.consensus_hash != trusted.consensus_hash
        or conflicting.app_hash != trusted.app_hash
        or conflicting.last_results_hash != trusted.last_results_hash
    )


def compute_byzantine_validators(common_vals: ValidatorSet,
                                 trusted: "SignedHeader",
                                 conflicting_block: "LightBlock"
                                 ) -> list[Validator]:
    """The punishable signer set for an attack, deterministically
    derived so the detector and every verifying full node agree
    (reference: types/evidence.go:253-280 GetByzantineValidators):

    - LUNATIC (conflicting header is invalid w.r.t. the trusted one):
      validators of the COMMON valset that signed the conflicting
      commit — they signed off a header the chain could never produce.
    - EQUIVOCATION (commit ROUNDS equal, header otherwise valid):
      validators that voted in BOTH commits — only signing both is
      double-signing; a validator that precommitted only the
      conflicting block may have done so legitimately. The valsets
      are identical (validators_hash matches), so the commits are
      index-aligned and one indexed pass suffices.
    - AMNESIA (rounds differ, header valid): indeterminable from the
      evidence alone; empty list.

    Ordered by voting power (desc, address tiebreak), matching the
    reference's ValidatorsByVotingPower sort.
    """
    commit = conflicting_block.signed_header.commit
    ch = conflicting_block.signed_header.header
    out: list[Validator] = []
    if conflicting_header_is_invalid(ch, trusted.header):
        for cs in commit.signatures:
            if not cs.for_block():
                continue
            _, val = common_vals.get_by_address(cs.validator_address)
            if val is not None:
                out.append(val.copy())
    elif trusted.commit.round == commit.round:
        trusted_sigs = trusted.commit.signatures
        for i, sig_a in enumerate(commit.signatures):
            if sig_a.is_absent() or i >= len(trusted_sigs):
                continue
            if trusted_sigs[i].is_absent():
                continue
            _, val = conflicting_block.validator_set.get_by_address(
                sig_a.validator_address)
            if val is not None:
                out.append(val.copy())
    else:
        return []
    out.sort(key=lambda v: (-v.voting_power, v.address))
    return out


@dataclass
class LightClientAttackEvidence(Evidence):
    """Proof that validators signed a conflicting light block
    (reference: types/evidence.go:215). Field semantics:

    - conflicting_block: the forged/conflicting block (with the valset
      whose hash its header claims).
    - common_height: the latest height the attacked client and this
      chain agree on; the valset at this height anchors verification.
    - byzantine_validators: computed via compute_byzantine_validators;
      re-derived and cross-checked by every verifier.
    - total_voting_power / timestamp: of/at the common height, pinned
      so ABCI punishment data is deterministic.
    """

    conflicting_block: LightBlock
    common_height: int
    byzantine_validators: list[Validator] = field(default_factory=list)
    total_voting_power: int = 0
    timestamp: int = 0

    def height(self) -> int:
        return self.common_height

    def conflicting_height(self) -> int:
        return self.conflicting_block.height()

    def hash(self) -> bytes:
        return tmhash.sum256(self.to_bytes())

    def validate_basic(self) -> None:
        if self.conflicting_block is None:
            raise ValueError("missing conflicting block")
        if self.common_height <= 0:
            raise ValueError("non-positive common height")
        sh = self.conflicting_block.signed_header
        if sh.header is None or sh.commit is None:
            raise ValueError("conflicting block missing header or commit")
        if self.common_height > sh.header.height:
            raise ValueError(
                f"common height {self.common_height} is after the "
                f"conflicting block height {sh.header.height}")
        sh.header.validate_basic()
        sh.commit.validate_basic()

    def to_abci(self) -> list:
        """BeginBlock byzantine_validators entries, one a byzantine
        validator (reference: light/types.py:242)."""
        from ..abci.types import Misbehavior

        return [
            Misbehavior(
                type="LIGHT_CLIENT_ATTACK",
                validator_address=v.address,
                validator_power=v.voting_power,
                height=self.common_height,
                time=self.timestamp,
                total_voting_power=self.total_voting_power,
            )
            for v in self.byzantine_validators
        ]

    def to_proto(self) -> Writer:
        w = Writer()
        w.message(1, self.conflicting_block.to_proto())
        w.varint(2, self.common_height)
        for v in self.byzantine_validators:
            w.bytes(3, v.to_proto().finish(), skip_empty=False)
        w.varint(4, self.total_voting_power)
        w.varint(5, self.timestamp)
        return w

    def to_bytes(self) -> bytes:
        # Field 2 of the Evidence oneof (see types/evidence.py
        # evidence_from_bytes; field 1 is DuplicateVoteEvidence).
        return Writer().message(2, self.to_proto()).finish()

    @classmethod
    def _from_inner(cls, data: bytes) -> "LightClientAttackEvidence":
        r = Reader(data)
        cb = None
        common = tvp = ts = 0
        byz: list[Validator] = []
        while not r.at_end():
            f, wt = r.field()
            if f == 1:
                cb = LightBlock.from_bytes(r.bytes())
            elif f == 2:
                common = r.varint()
            elif f == 3:
                byz.append(Validator.from_bytes(r.bytes()))
            elif f == 4:
                tvp = r.varint()
            elif f == 5:
                ts = r.varint()
            else:
                r.skip(wt)
        if cb is None:
            raise ValueError("light-client-attack evidence missing block")
        return cls(cb, common, byz, tvp, ts)

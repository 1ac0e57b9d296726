#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device — the card's name and power limit (nvidia-smi);
2. build — the CUDA kernels built from tendermint_tpu_torch/csrc, and
   the port's C message packer (tendermint_tpu_torch/native/pack.c,
   built with cc into build/native/): it must load, or the run fails
   (pad_messages would take its numpy path), and its calls are counted
   from here on, so every later pad of 256 messages or more (every K4
   launch, every bytes-form K3 launch) shows on the C path;
3. kernels — each of K1, K3 and K4 against its plain PyTorch version on
   an adversarial batch (1,024 lanes over 256 keys), K3's structured
   form (K2's assembly inside the launch) on a structured commit with
   one lane's patch off by a byte against assemble_plain + xverify_plain
   and against the bytes form on the host's own sign bytes, K6/K7 on a
   1,024-lane speculation arena holding the adversarial lanes and some
   inactive ones, and K9 on a 1,024-lane sr25519 adversarial batch
   (verdicts also equal to sr25519_ref.verify on every lane, and every
   branch of the ristretto equality and square root taken): verdicts
   bit-identical, tables, sign bytes and the seven spliced buffers
   identical; K4's, K7's and K9's verdict digests equal to
   VERDICT_DIGESTS (K3's bytes form and K4 on C-packed rows);
4. slice — a 10,240-validator set and a signed 10,240-signature commit
   through ValidatorSet.verify_commit, verify_commit_light and
   verify_commit_light_trusting (trust 1/3), a corrupted signature that
   must be named, and a 64-lane BatchVerifier; the launch counters are
   zeroed just before and read just after, and every kernel of the
   path (K1, K3 with K2 inside, K4) must have launched;
5. speculation — the same set and commit through the SpeculationPlane:
   begin_height, the precommits observed in 10 bursts of 1,024 with a
   flush_sync after each (one K6 splice and one K7 launch each, the
   sentinel lane holding), then serve_commit, which must serve a full
   hit with no verification launch; then a commit with one corrupted
   signature, which must be rejected at its index after re-verifying
   that lane alone. Counters zeroed before and read after; K6 (splice,
   clear) and K7 must have launched;
6. mixed — a 10,240-validator set whose odd-numbered keys are sr25519
   (signed with the bulk signer sr_sign_batch) and even-numbered ones
   ed25519, and its signed commit through verify_commit (5 runs, p50,
   and the stages of one run), verify_commit_light and
   verify_commit_light_trusting: each call must launch K9 once for the
   sr25519 lanes and K4 once for the ed25519 lanes, and K1, K3 and K7
   never; a corrupted sr25519 and a corrupted ed25519 signature
   must each be named; one duplicate-vote evidence check on an sr25519
   validator (valid, then with a bad signature);
7. fabric — the multi-device verify fabric on a mesh: every CUDA
   device when there are at least two, else four logical shards of
   cuda:0 (four table blocks, four lane sets, four launches on four
   streams). K5 against its plain version, shard by shard, on the
   adversarial batch (256 keys split over the shards) in both forms:
   the message rows routed (bytes) and assembled in the kernel from the
   templates (structured). Then, with the crossover at 5,120 keys, the
   slice phase's set and commit: the sharded table build (one K1 launch
   a key range), verify_commit (11 runs, p50), _light and _trusting,
   each launching K5 once per shard and K3 never with the slice
   phase's outcome, the corrupted signature rejected at the same index;
   the mixed phase's commit through verify_commit, each call launching
   K4 and K9 once per shard with the mixed phase's outcomes and
   rejections. Counters zeroed before, read after. Then, outside that
   run, the sharded verdicts lane for lane against the one-card set's;
6b. observe — the launch ledger, the watchdog and the tracer, on the
   slice and mixed commits (`observe_phase`; alone: `--phase observe`):
   K3 structured at 10,240 lanes, K4 at 128 (against its plain version)
   and at the mixed commit's 8,192 bucket, K9 at 5,120, K7 at 10,241 of
   12,288 after a K6 splice and K5 on four logical shards, each under a
   workload tag. One record per launch (equal to the wrappers'
   .launches deltas), each gpu with the card's name, its lanes and
   capacity, verdict ok; the HBM registry equal to the tables' and the
   arena's bytes; the watchdog gpu, degraded by drift against a tenth
   of K3's exec; each exec p50 beside its row's device_ms (positive, at
   most 3x, checked after the timing phase); the p50 cost of a span and
   of a record (us);
8. healing — the self-healing fabric on the fabric phase's mesh, with
   the port's clock advanced past each cooldown: K8 (the per-shard
   arena: K6's splice and K7's verify once per device over its block
   of shards, and tm_mesh_clear) against its plain versions on a
   1,024-lane adversarial arena through the (D, per, ...) view; then,
   counters zeroed before and read after, the speculation phase's
   commit through a SpeculationPlane on a MeshResidentArena (10 bursts
   of 1,024, one K6 and one K7 launch a device a flush, counted as
   K8's mesh_splice and mesh_arena_verify, a full hit,
   the per-shard upload bound), a lying shard (its sentinel signature
   flipped on the card: only its entry evicted, one host recheck, the
   commit still served), live reshards of the arena and of the cached
   sharded set 4 -> 3 (K5 three times a call, the slice phase's
   outcomes and rejection, verdicts equal to the one-card set's lane
   for lane), the device.shard_fail failpoint evicting a second entry
   (-> 2), re-admission by half-open probes (-> 4), the backend
   breaker under a 64-lane BatchVerifier and the degraded sr25519
   route; the fallback counters must move by exactly what was
   injected. The comparisons in that run (one-card verdicts, the
   timed probe, the on-device K4 and K9 references) have their
   launches taken back out of the counts;
9. fastsync — fast sync's verify-ahead plane on a 1,000-validator
   chain of 129 blocks (heights 121-249, so the first window crosses
   height 128, with one commit made in round 1, whose template is
   wider): a BlockPool fed by eight peers, and a loop that mirrors the
   reference reactor's _try_sync under asyncio.run (peek 17 blocks,
   WindowPipeline.verdicts, start_ahead, pop_request for each accepted
   block; no block store, no apply_block). Counters zeroed before and
   read after: 8 windows of 16 blocks, one K3 launch a window (16
   template groups, 16 x 667 lanes, bucketed to 11,264) and one K1
   launch for the set, no K4, 7 prefetch hits, every result None. Then
   a copy of the chain with a signature tampered inside one commit's
   quorum prefix and a timestamp changed after signing in another
   window's commit: exactly those two blocks fail, the loop stops at
   each, calls redo_request for both heights and refetches them from
   honest peers, as the reactor does. Then, outside the counted run,
   the verify job's stages (window_items, the MergedSignBatch build,
   _prepare_structured, the launch, the readback), vals.hash() and
   K3 at the window's shape (the xverify_window row);
10. votes — the consensus vote scheduler (VoteScheduler, batch_verdicts,
   VoteSignBatch, VoteSet, HeightVoteSet) at one height over the first
   10,000 validators of the slice phase's set (MAX_VOTES_COUNT, the
   most a VoteSet admits, as the Go reference's MaxVotesCount), at
   ConsensusConfig's defaults: eight
   peers deliver 512 late precommits for the height before (the slice
   commit's), then every validator's prevote and precommit and 32
   round-1 nil precommits in shuffled bursts of 64-512 votes, each
   burst verified and tallied before the next; one burst overflows the
   4,096-vote buffer by 4 (shed on consensus.vote_buf, re-sent in the
   last burst). Planted: 3 forged signatures, a timestamp changed
   after signing, an equivocating precommit, 2 gossip duplicates.
   Counters zeroed before and read after: exactly the planted votes
   rejected, each peer's good/bad counts as planted, no lane for a
   duplicate, one DuplicateVoteEvidence (verified), +2/3 prevotes and
   precommits for the block, make_commit's commit through
   verify_commit, K3 (structured, a VoteSignBatch) once for each batch
   group of 128 lanes or more and K4 once for each of 40-127, K1 once
   for the set's tables. Then the paced run: the valid votes again to
   a fresh HeightVoteSet at 20,000 votes a second, never waiting for
   the scheduler (every vote tallied or shed, +2/3 of both, K3/K4 by
   batch size; the phase's time to +2/3 precommits); a 1,024-vote
   burst of the mixed set's precommits (K4 + K9, verdicts equal to the
   host oracle's) and a 64-vote burst (K4). Outside the counted run:
   batch_verdicts' stages at 1,024 lanes, K3 there (the xverify_votes
   row) and K3 on the run's largest batch against its plain version;
11. light — BASELINE.json config #2: a 150-validator chain of 64
   headers (a sixth of the set rotating every 16), its LightBlocks made
   by the port's codec; counters zeroed before and read after:
   verify_adjacent over every step (K4, 101 lanes), verify_non_adjacent
   from height 1 to 16, 32 and 64 (K4, 51 and 101 lanes), a forged
   target, an expired trusted header and an under-trusted skip
   (trust 2/3) rejected with the reference's classes and texts; then
   64 concurrent skipping verifications (two plans each) and the three
   faults through LightVerifyCollector at LightConfig's defaults (a
   few wide K4 launches, each with the known-answer sentinel lane).
   Then K4 at a commit check's 101 lanes and at the collector's widest
   launch (the general_verify_light_commit and general_verify_light
   rows). Neither phase runs in the f32 child: they add no kernel;
12. light_client — BASELINE.json config #2's 150 validators on a
   node's own stores: a 520-height chain (a sixth of the set rotating
   every 16 heights) built through the port's GenesisDoc,
   make_genesis_state, State.make_block, BlockStore.save_block and
   Store.save_validator_set over MemDB, every client on a fixed clock.
   Counters zeroed before and read after: a Client trusted at height 1
   by hash, its primary a BlockStoreProvider over those stores
   reporting evidence into a recording sink, an honest witness and one
   forking from height 497 (headers with another app hash, re-signed by
   each height's own set), verifies height 512 by bisection; the
   forking witness proves its fork from the common block, and the
   Client raises DivergenceError with two LightClientAttackEvidence and
   purges its store above the common height. verify_evidence on the
   node's stores: the evidence against the witness verifies (one 1/3
   trusting check), the one against the primary matches the committed
   chain, one at the tip (520) lacks its canonical commit. The evidence
   against the witness then goes into an evidence Pool over the node's
   stores (add_evidence: one K4 launch, as verify_evidence's), is
   pending, checks in a block without a launch, raises twice in one
   block, is refilled by a second Pool over the same DB, and update()
   at a state past both max ages commits it and prunes the tip evidence
   added as consensus saw it. A second
   Client (honest witness only): 16 sequential update() steps, 8
   skipping verifications up to 512, a backwards walk below its head
   (hashes only). A ServingPlane at LightConfig's defaults over a third
   Client: 64 concurrent get_verified at 16 heights, then the same 64
   (the cache). Every commit check and collector flush is one K4
   launch; the launches must equal the checks the trace implies plus
   the flushes. No kernel is added: the phase adds to K4's rows;
13. admission — the tx path at MempoolConfig's defaults (a pool of 5,000,
   a 10,000-entry cache, permissive, batches of 256, a 2 ms deadline, a
   2,048-tx pre-verify queue, 1,024 CheckTx in flight): a CListMempool
   over AppConns and LocalClients on a PersistentKVStoreApp, a
   proposer's cycle every 2,000 admitted txs (lock, reap under the
   default block params, BeginBlock/DeliverTx/EndBlock/Commit on the
   consensus connection, save_abci_responses read back, update with
   recheck, unlock). Three nodes, counters zeroed before and read
   after: the reference e2e overload mix (20,000 unique kvstore txs of
   100-200 bytes, 30% garbage-signature envelopes, 10% valid ones from
   1,024 signers, the rest raw) with 1,024 submissions outstanding; a
   signed-only chain (strict: 8,000 valid envelopes, 80 unsigned and 80
   malformed txs); the width probe (255 small envelopes and one of 64
   KiB in one flush, then one at max_tx_bytes). Every valid and raw tx
   admitted and committed exactly once, every garbage, unsigned and
   malformed one shed with its reason and never seen by the app's
   CheckTx, every enveloped tx's verdict equal to the collector's host
   oracle (_host_verify, in 8 spawned processes), one K4 launch a flush
   of 40 txs or more and none below, each app hash equal to a fresh
   app's fed the committed blocks, no backpressure shed. Then K4 at each
   bucket the flushes used and at the probe's two flushes (pack, upload,
   device ms, message width) and the general_verify_admission row (a
   full strict flush: 257 live lanes of 512). No kernel is added;
14. execution — the commit pipeline (BlockExecutor.apply_block) at
   10,000 validators (MAX_VOTES_COUNT, the most signatures a block's
   LastCommit may hold): a genesis of 10,000 ed25519 validators (MockPV
   keys from seeds) started by reconcile_and_handshake (InitChain) on a
   PersistentKVStoreApp behind AppConns, with a CListMempool at
   MempoolConfig's defaults, an evidence Pool, an EventBus and an
   IndexerService. Counters zeroed before and read after. Six clean
   heights: 64 signed envelopes (one admission flush, one K4 launch)
   and 32 raw kvstore txs a height through check_tx, reaped by
   create_proposal_block, the 10,000 precommits signed on the host,
   save_block and apply_block, whose validate_block checks each
   LastCommit by one structured K3 launch; `val:` txs at height 2 add
   a validator and remove one, so the changed set's tables are built
   by K1 in the warm thread before its first commit (height 4's) is
   verified under it. A block whose LastCommit has one flipped
   signature is rejected with BlockValidationError naming the lane
   (the host oracle agrees) and the state, both stores, the app hash
   untouched and no BeginBlock. Two more heights with a
   SpeculationPlane fed the LastCommit's precommits (K6 + K7 a burst),
   served with no K3 launch. Crash recovery over FileDBs: the pipeline
   cut at state.apply.responses_saved and at state.apply.app_committed
   while applying height 3, every store reopened from disk,
   reconcile_and_handshake repairing with exactly state_reapply /
   state_from_responses (one K3 launch each) to the clean run's app
   hash, then one more height. The tx indexer finds every tx at its
   height; every block, app hash, last_results_hash and state store
   digest equals a child's (`--phase execution_host`, run alongside)
   that builds the same chain with crypto.batch's host route forced
   and no kernel; each height's apply_block time and its split, the
   p50, the K1 build and whether its warm thread was done in time;
15. consensus — one validator node among 10,000 (config #5's
   mega-commit cut to MAX_VOTES_COUNT, as the votes and execution phases
   are) running the port's ConsensusState at ConsensusConfig's defaults
   (timeouts 3 s / 1 s / 1 s / 1 s commit, vote batching 2 ms / 1,024 /
   4,096) with a FilePV on disk, FileDB stores, an on-disk WAL, the
   kvstore app, a CListMempool with the admission plane, an evidence
   Pool, an EventBus with the indexers and a SpeculationPlane at its
   defaults flushed by its own flusher. The node's key is the one the
   set's proposer order puts at height 3. The other 9,999 validators are
   a child (`--phase consensus_peers`, host only: the keys, four forked
   signing workers, State.make_block from the node's saved state and
   seen commit): it signs each round's proposal, parts, prevotes and
   precommits, which the parent decodes (decode_consensus_msg) and hands
   to add_peer_msg in shuffled bursts from 8 peer ids, as a reactor
   would. Seven heights: 1; 2 with one peer's forged prevote and
   another peer's equivocating precommit; 3 proposed and signed by
   the node, carrying the DuplicateVoteEvidence; 4 whose round-0
   proposer stays silent (timeout_propose, 10,000-wide nil prevotes and
   precommits, round 1 commits); 5 with 64 signed envelopes and 32 raw
   txs admitted by the node's mempool (one K4 flush) and carried by the
   peers' block; 6, whose commit an `error` at
   consensus.commit.wal_delimited ends (the node halts, wait_for_height
   re-raises it); a restart from the disks (reconcile_and_handshake
   repairs with state_reapply, reconstruct_last_commit, _catchup_replay)
   that commits 7. Counters zeroed before and read after: every height
   committed, K1 once (the genesis set's tables), every K3 and K4
   launch named by the step it served (vote groups of 128 lanes or more
   K3, of 40-127 K4; admission flushes K4; reconstruct_last_commit one
   K4; no verify_commit before the restart: each LastCommit served by
   the plane, whose flusher launched K6 and K7; after it, one K3 per
   verify_commit), the forged prevote rejected (that peer's bad count
   1), exactly one DuplicateVoteEvidence in block 3 and committed, the
   FilePV's state file at the last HRS the node signed, then the peers
   child replays the node's stored blocks from genesis with the host
   route forced, and every block, app hash, last_results_hash and state
   digest equals the node's. Each height's interval from NewHeight to
   commit and its split, the receive routine's host us per message, the
   vote batches' group sizes, the launches, speculation hits and
   misses and the collector's pauses;
16. p2p — the node (node/__init__.py Node) and the p2p stack over TCP on
   127.0.0.1, in two parts, counters zeroed before the first and read
   after the second. Node A also serves its debug server
   (`rpc.pprof_laddr`) and Prometheus listener: its /metrics must count
   one admission ledger record on the card per device flush of Part A,
   /debug/launches hold them, /status read the watchdog at gpu, and a
   mid-run /debug/trace?seconds=10 hold consensus.height,
   state.apply_block and crypto.* spans (the p50 share of apply_block
   in a height and of crypto.device_exec in apply_block printed). Part A, BASELINE.json config #1 (`make localnet`'s
   4-validator genesis) at ConsensusConfig's defaults: node A (validator
   0) here on the card, a Node built by Node.default_new_node from a
   home directory written as `testnet` writes one (config.toml through
   Config.save, genesis.json, node_key.json): FileDB stores, the
   merkle-kvstore app, every reactor, RPC on, a strict admission plane
   (every tx a signed envelope) at MempoolConfig's defaults;
   its key in a FilePV behind a SignerServer in a child (`--phase
   p2p_signer`) that dials the node's `priv_validator_laddr` over a
   SecretConnection; validators 1-3 are Nodes, each in a child of its
   own (`--phase p2p_peers <A's address> <i>`), forced to the host, RPC
   on; persistent peers, all links through Transport and
   SecretConnection. While A is at heights 2-10 a client in a child of
   its own (`--phase p2p_clients <A's RPC port>`, A's height from its
   WS NewBlock events) submits bursts of 64 envelopes every 640 ms over
   A's RPC (broadcast_tx_sync, one HTTP request each, concurrently) and
   one broadcast_tx_commit a height, and B's client bursts of 16 over
   B's RPC; a WS client on A
   subscribes to NewBlock and Tx; D double-prevotes at height 5 (the
   maverick hooks); after height 8 A's signer link drops once and is
   re-adopted before A signs again. Checks: the four nodes' blocks, app
   hashes and last_results_hashes equal to height 12 (or to the height
   where the last tx is committed, at most 8 more), every tx committed
   exactly once and none refused, each broadcast_tx_commit answered
   with its height, one DuplicateVoteEvidence against D committed
   within two heights and gossiped to A by the evidence reactor, A's
   FilePV (in the signer child's files) last signed a precommit at the
   last height, K4 once for each admission flush of 40 or more (the
   bursts arrive over the event loop, one request at a time, so their
   flushes are the 2 ms window's), nothing else on A; over RPC, /block, /commit,
   /validators, /block_results and /tx_search equal from A and B at
   every height, every committed tx's /tx?prove=true proof verifying
   against /block's data hash, /abci_query?prove=true equal at one app
   height, the WS stream naming every committed tx once; a LightProxy
   (primary A's RPC, witnesses B's and C's, trusted at height 1 by
   hash, its 4-lane checks on the host) serving /commit and /block
   equal to A's and a verified abci_query (a merkle proof of one key).
   Printed: each height's NewHeight to commit, the receive routine's
   host us a message by channel, bytes a second by channel, the flush
   sizes, the signer's round trip, each RPC route's p50 ms at its
   client and its handler's ms on A. Part B,
   config #3 cut to 129 blocks:
   a child (`--phase p2p_servers`, host only, started before the
   consensus phase so that its build overlaps it; with `--phase p2p`,
   at the phase's start) builds a
   1,000-validator chain from genesis through BlockExecutor over a
   kvstore app (32 txs a block, each value padded to 2,048 bytes, every
   commit signed by all 1,000, the commit of height 64 in round 1; the
   app snapshots every 32 heights) and serves it from four switches and
   a copy with one forged LastCommit signature in block 78 from two
   more. A fresh node here fast-syncs from the four through
   BlockchainReactor and hands over to consensus: its blocks and state
   digest equal to the chain's at the height it stops (128, or 127 when
   the pool is caught up first), K1 once, K3 once a window job and once
   a LastCommit that apply_block validates, K4 once for the handover's
   reconstruct_last_commit. A second fresh node dials the forged
   servers first: the reactor bans both (redo of heights 77 and 78),
   then applies 77-79 from two honest servers and stops there (the
   heights that decide the ban), its blocks the chain's; K3 as counted.
   Printed: blocks a second end to end and the split between verify
   (the windows' awaits), apply_block, save_block and the network (the
   rest);
17. statesync — a fresh node joins Part B's chain (config #3 cut to
   129 blocks) by a seed, PEX and state sync, then a light serving pool
   answers the chain's clients. The p2p phase's serving child (with
   `--phase statesync`: started at the phase's start) also serves the
   chain, and its app's snapshots at 32, 64, 96 and 128 (about 12.8 MB
   of JSON, 195 chunks of 64 KiB at 96), from four honest switches
   (blockchain, statesync and PEX reactors, their books holding the
   servers) and a poisoner whose snapshot connection flips one byte of
   every chunk it serves; a seed (PEX in seed mode, its other reactors
   over an empty store and app) knows the five; four RPC servers
   (rpc/core.py Environment over the chain's stores) and one over the
   forged copy serve JSON-RPC. On the card: a Node built from a Config
   with `statesync.enable`, `rpc_servers` two of the RPC servers,
   `trust_height` 1 and `trust_hash` height 1's hash, `p2p.seeds` the
   seed (ensure period 1 s): its light client is the node's own
   (_default_state_provider: a Client over RPCProviders), its join the
   node's _run_state_sync. The expanded-table cache cleared, counters
   zeroed before the node starts; the sync starts once every server's
   snapshots are in the pool. Checks: the book holds the five with the
   seed as their source, the seed hangs up, ensure_peers dials the five
   from the book; every server advertises the four snapshots; 128 is
   refused by the light client (no block at 130: BlockNotFoundError
   over RPC) and never offered, 96 is verified backwards from the
   trusted head and restored in three attempts (round robin over the
   five, poisoned; then the poisoner alone, whose id sorts first, named
   by the app and quarantined; then one honest server); the restored
   app at height 96 with the chain's app hash and its `kv:` items'
   digest equal to the chain app's at 96; bootstrap (state store, seen
   commit), fast sync of the tail from 97 to 128 (or 127) with every
   block hash, the app hash and last_results_hash equal to the chain's,
   the handover to consensus; K1 once (the set's tables), K3 once a
   light commit check (four, structured: height 1's, the 1/3 trusting
   and 2/3 checks of the skip to 128, the adjacent 129), a window job
   and a LastCommit apply_block validates, K4 once (the handover's
   reconstruct_last_commit), nothing else, read at the handover. Then
   a ServingPool of four LightProxy workers over one plane (its client
   over the other two RPC servers, trusted at 1) answers 64 concurrent
   clients, each asking verified /commit and /validators at its height
   (2, 4, ..., 128): every answer equal to an honest RPC server's (the
   commit, header and every signature; each page's addresses, keys and
   powers, the keys the genesis's), K4 at least once and once for each
   device flush of the plane's collector (1,000-lane checks), nothing
   else;
   and a LightProxy over the forged RPC server, trusted at 76, refuses
   /commit at 77 (light verification failed). Printed: the discovery
   time, each light height's and commit check's ms, the snapshot's
   chunks and bytes, each restore attempt's fetch, apply and bootstrap
   seconds, the fetch MB/s, the tail's blocks a second, the time from
   start to handover; the pool's verified requests a second, its route
   p50s and launches; for the join and for the pool, the RPC servers'
   handler ms by route and their validator-set decodes (each
   /validators page decodes the stored set, as the port's route does);
17b. cli — the command line (`python -m tendermint_tpu_torch.cmd`),
   after statesync with its servers still up (alone: `--phase cli`).
   `testnet --v 4` writes BASELINE.json config #1's four homes; node0's
   config.toml is edited through Config.load/save (RPC, pprof_laddr, a
   strict admission plane, priv_validator_laddr pinned to its signer's
   link key). Node0's key is served by `signer --connect` in a child;
   node0 is `start` in a child on the card, with no flag; nodes 1-3 are
   `start --device cpu`, node3 with `--misbehavior double-prevote@5`
   (TM_TPU_ENABLE_MAVERICK=1). Bursts of 64 signed envelopes go over
   node0's RPC at heights 2-8: every tx committed once, the four nodes'
   blocks and app hashes equal, one DuplicateVoteEvidence against node3
   committed; node0's /metrics counts one admission ledger record on
   the card per flush of 40 or more (its device route), each record in
   /debug/launches gpu with the card's name (the peers' flushes, on
   their plain K4 when 40 or more, are printed). Node1 is stopped and
   started under TM_TPU_FAILPOINTS='state.apply.app_committed=crash;
   nth=2': it must exit 1 by the crash action; started again it heals
   and rejoins at equal app hashes. `debug dump` on node0 writes a
   bundle with every artifact, its metrics.txt holding the same record
   count; `light --once` (primary node0, witnesses nodes 1 and 2,
   trusted at height 1 by hash) prints a verified height, and so does
   `light --laddr`, whose /commit below its head equals node0's. Node2
   is stopped: `replay-console` and `replay` run on copies of its home,
   `unsafe-reset-all` on a third, which starts as node2 and fast-syncs
   back to equal blocks. `start` under CUDA_VISIBLE_DEVICES="" without
   `--device cpu` must exit non-zero naming NoDeviceError and bind no
   port; `debug kill` on node0 writes its bundle and ends it. Then, in
   this process, counters zeroed before and read after: a BatchVerifier
   of 64 ed25519 and 8 secp256k1 lanes (one bad signature of each type)
   launches K4 once, the secp256k1 lanes verified on the host, verdicts
   the keys' own; and `cmd.main(["light", ..., "--once"])` over two of
   the statesync phase's RPC servers (config #3's 1,000-validator chain)
   with the table cache cleared: K1, K3 (K2 inside) and K4 as its
   checks need. Each command's wall time and the phase's total;
17c. sim — the deterministic simulator (tendermint_tpu_torch/sim: nets
   of full nodes in one process on virtual time, the gossip picks
   seeded) under verify_backend "device", in a child (`--phase sim`;
   alone the same) started when the consensus phase starts, after the
   rows' timing (phase 18, run after the execution phase) so that it
   never shares the card with it, and running beside the consensus,
   p2p, statesync and cli phases; its line is relayed when it ends, its
   launches added to the kernels line's.
   Counters zeroed before each run and read after it. (a)
   mesh_device_loss, seeds 1 and 2, each twice, on four logical shards
   of cuda:0: the probe
   evicts the mesh's fourth entry by name (the watchdog reports it),
   the backend breaker stays closed, the entry is re-admitted, every
   invariant holds, each run moves the fallback counters by exactly
   that one eviction and nothing else, no launch (4 validators), equal
   app hashes within a seed and different across the two; (b)
   trust_collapse (the bad-signature flood), seed 3: its 5 validators'
   batches stay under the 40-lane crossover, so no launch, as in the
   reference; (c) wan_50, seed 1, as the catalog defines it (50 nodes
   on a ring+3 WAN, a 25/25 partition, a churned node, an equivocator
   and a garbage flooder, 420 virtual seconds): every invariant holds,
   evidence committed, K4 launched (each commit of 40 or more
   signatures, on every node that verifies it) and nothing else, one
   ledger record a launch, each on the card with its name and verdict
   ok, no fallback, the sha256 digest of the per-height app hashes
   equal to SIM_DIGESTS. A port fault from a launch (crypto.batch.
   UNCAUGHT) halts only its node inside the net, so the phase keeps it
   and raises it after the run. Printed: wall_s, the final heights, the
   launches and a histogram of lanes a launch, host and device batches,
   the p50 of crypto.device_exec and state.apply_block spans, the digest
   and whether it equals the JAX package's under "host" (same_as_host);
17d. e2e — the e2e harness (tendermint_tpu_torch/e2e), in a child
   (`--phase e2e`; alone the same) started after the cli phase once the
   sim child has ended, so it never shares the host with the sim, and
   running beside the f32 child's tail (its lines relayed when it
   ends; `beside_f32_s` says how long): e2e/sample_manifest.toml as the repo has it, at its
   full width, through the port's Runner with device "cuda" (every
   node `cmd start --device cuda`, the light_proxy perturbation's
   serving plane in the child's process on the card) and every port
   from the OS: 4 validators to wait_height 10 under 5 tx/s of load; a
   kill at 3 and a crash armed at state.apply.app_committed at 4; a
   pause at 5; light_proxy at 5; overload at 6 (device.verify delayed
   25 ms, 150 tx/s, 30% garbage and 10% signed envelopes); a
   disconnect at 7; a restart at 8; disconnect_hard at 9; node 2
   double-prevoting at 4; node 3's power 3 from height 2. Held to what
   the reference's runner and its tests assert: no fork, evidence
   committed, every kill_recoveries entry fired at its point and
   healed, the overload report's heights advancing with sheds (RPC and
   admission), bounded queues and the level cleared, light_proxy under
   12 launches for 24 requests with parity, 429 sheds and its depth
   within the bound, the validator set as scheduled; every node's
   /debug/launches answered and every record in it on the card with
   its name. Counters zeroed before, read after (the child's process);
   the nodes' K4 launches come from their ledgers. At 4 validators
   most batches stay under the 40-lane crossover, so a count of 0 is
   recorded, never forced up. Printed: the K4 launches by node and in
   the child with the lanes of each, each stage's wall time and each
   node start's seconds to its first RPC answer. Then the port's
   signer harness (--secret-connection) against a `cmd signer
   --connect` child must exit 0, and against an in-process signer
   without double-sign protection 5;
18. timing (run after the execution phase, before the fault check, the
   consensus phase and the sim and f32 children) — each kernel at the
   main path's shapes: its device time a call (`ms`: back-to-back
   calls captured in a CUDA graph and the replay timed by CUDA events,
   no host gaps) and its wrapper's time a call (`wrapper_us`: CUDA
   events around as many calls made from Python, the host's work
   between launches included), the plain version's time, its bound,
   and its agreement
   with the plain version, also on a copy with one signature bit and
   one message (K4) or patch (K3) byte flipped, whose two lanes must
   fail (K2's row: what its assembly adds to the
   structured K3 launch that carries it, against the bytes form on the
   same lanes) on those inputs (K4 at the 64-lane BatchVerifier's
   128-lane bucket and, as general_verify_mixed, at the mixed
   commit's 8,192-lane bucket; K9 at its 5,120 lanes); for the kernels
   that spread a key or a lane over many threads (K1, K3, K4, K5, K7,
   K8's verify, K9, in both fields) the launch shapes (grid, block,
   dynamic shared memory, resident warps an SM from
   cudaOccupancyMaxActiveBlocksPerMultiprocessor, registers and stack)
   and the ptxas spills: each launch must run at least 4 threads a key
   or lane, with no spills. Then `native`: the C packer against
   pad_messages' numpy path at the commit's 10,240 sign bytes, a
   fast-sync window's 11,264 lanes, a 512-envelope admission flush of
   0-2,000 bytes and 255, 256 and 257 messages (byte-equal rows, equal
   int32 block counts, host ms a call p50 of 20 on each path), K4 at
   the mixed commit's 8,192-lane bucket and K3's bytes form at 11,264
   lanes launched on C-packed rows, their verdicts equal to the plain
   versions' on numpy-packed rows;
19. fault (run after the timing phase, before the consensus phase) —
   in a child (`--phase fault`; a sticky fault poisons the context): a test-only kernel built from FAULT_SOURCE, never part of
   the port's library, stores through a bad address just before K4
   inside a BatchVerifier; the ladder must raise KernelError with a
   kernel-fault code (700), every breaker closed, no counter moved,
   and the launch ledger's last record `raised`. Before it, the
   watchdog with the card promised and a 3 s window: one K4 launch of
   the plain version on the CPU turns it cpu_fallback, one card launch
   restores gpu, and after the window the raised launch alone turns it
   cpu_fallback again;
20. f32 — in a child with TM_TPU_FIELD=f32 (`--phase f32 --i32
   <digests>`; the field is chosen at import), started when the
   consensus phase ends and running beside the p2p, statesync and cli
   phases and the e2e child's start (its lines relayed when it ends):
   the f32 library built
   (every source with -DTM_FIELD_F32) and the C packer loaded; the
   kernels check again, K1,
   K3, K4, K5, K7 and K9 against their f32 plain versions, their
   verdicts against the digests of the i32 build's (kernels and fabric
   phases) that the parent passes; the slice, speculation, mixed,
   fabric and healing phases again at 10,240 validators, each held to
   its i32 phase's launches, outcomes, rejections, verdicts and (for
   healing) counters; the f32 p50s, flush, fabric and healing times
   beside the i32 ones, and the rows of the field-bearing kernels
   (`<name>_f32`) at the same shapes as the i32 rows, with their
   launches on the five f32 paths.

Each child's lines are relayed as {"phase": <child>, "step": ...}; a
child that fails or outruns its time limit fails the run.
`python3 chip_smoke.py --phase consensus` builds the kernels and runs
the consensus phase alone; `--phase p2p` the p2p phase, `--phase
statesync` the statesync phase, `--phase cli` the cli phase, `--phase
sim` the sim phase, `--phase e2e` the e2e phase. Every phase but healing must end with all breakers
closed and the host fallbacks, rechecks and evictions unchanged (sim:
but for the evictions its mesh_device_loss runs inject, one a run).
Then the kernels line, the
nvidia-smi line and, last, {"ok": true, "device": {...}}. Any failure
raises (exit code 1); no phase is caught. Without a CUDA device it
exits 2 and prints no result; with TM_TPU_FIELD set to anything but
i32 it refuses to run (its f32 phase sets the variable for its child).
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import time
import types

N_VALIDATORS = 10_240
CHAIN = "smoke-chain"
# The field this process's kernels use (crypto/cuda/fieldsel.py reads
# the same variable): i32 here, f32 in the f32 phase's child.
FIELD = os.environ.get("TM_TPU_FIELD", "i32")
# H100 SXM published peaks (NVIDIA H100 datasheet for HBM3 bandwidth;
# Hopper white paper for the int32 rate, 132 SMs x 64 INT32 lanes x 1.98
# GHz, and the FP32 FMA rate, 132 SMs x 128 FP32 lanes x 1.98 GHz).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
FP32_FMA_PER_S = 132 * 128 * 1.98e9
# The operation bound counts the products of the field multiplies the
# function needs: in the i32 field int32 x int32 -> int64 products in
# radix 2^25.5 (ten limbs), 100 for a multiply, 55 for a squaring (as
# the kernels' fe_sqr forms them), against the int32 rate; in the f32 field FP32 FMAs over 32 limbs, 1,024 for a multiply,
# 528 for a squaring, against the FMA rate. Point ops use the
# reference's formulas; SHA-512, the fold, additions and carries are not
# counted, so the bound is a floor.
MUL, SQR, NLIMB, OPS_PER_S = {
    "f32": (1024, 528, 32, FP32_FMA_PER_S)}.get(
        FIELD, (100, 55, 10, INT32_OPS_PER_S))
ADD = 9 * MUL                     # add-2008-hwcd-3 (ge_add)
ADD_Z1 = 8 * MUL                  # Z2 = 1: the comb add (ge_add_z1)
DOUBLE = 4 * SQR + 4 * MUL        # dbl-2008-hwcd (ge_double)
DECOMPRESS = 255 * SQR + 19 * MUL  # + MUL where x * sqrt(-1) is taken
# ristretto decode: 257 squarings (pow_2_252_m3's 251 and six more) and
# 24 multiplies (those by the constant u = 1 not counted), + MUL where
# the root is multiplied by sqrt(-1)
RS_DECODE = 257 * SQR + 24 * MUL
RS_EQUAL = 4 * MUL
ENTRY_BYTES = 4 * NLIMB * 4       # one table entry: X, Y, Z, T, 4-byte limbs

SPEC_BURST = 1024                 # precommits per flush_sync
# bytes a splice writes per row: sb, s_ok, patch, split, patch_len,
# group, active (it reads the packed row, resident.ROW_BYTES)
SPLICE_WRITE = 64 + 1 + 24 + 3 * 4 + 1

REPLACES = {
    "build_tables": "tendermint_tpu/crypto/tpu/expanded.py:128",
    "assemble": "tendermint_tpu/crypto/tpu/expanded.py:318",
    "xverify": "tendermint_tpu/crypto/tpu/expanded.py:186",
    "xverify_window": "tendermint_tpu/crypto/tpu/expanded.py:186",
    "general_verify": "tendermint_tpu/crypto/tpu/verify.py:173",
    "splice": "tendermint_tpu/crypto/tpu/resident.py:65",
    "clear": "tendermint_tpu/crypto/tpu/resident.py:87",
    "arena_verify": "tendermint_tpu/crypto/tpu/resident.py:162",
    "sr_verify": "tendermint_tpu/crypto/tpu/sr_verify.py:51",
    "general_verify_mixed": "tendermint_tpu/crypto/tpu/verify.py:173",
    "xverify_votes": "tendermint_tpu/crypto/tpu/expanded.py:186",
    "general_verify_light_commit": "tendermint_tpu/crypto/tpu/verify.py:173",
    "general_verify_light": "tendermint_tpu/crypto/tpu/verify.py:173",
    "general_verify_light_client": "tendermint_tpu/crypto/tpu/verify.py:173",
    "general_verify_admission": "tendermint_tpu/crypto/tpu/verify.py:173",
    "shard_verify": "tendermint_tpu/crypto/tpu/expanded.py:394",
    "mesh_splice": "tendermint_tpu/crypto/tpu/resident.py:99",
    "mesh_clear": "tendermint_tpu/crypto/tpu/resident.py:126",
    "mesh_arena_verify": "tendermint_tpu/crypto/tpu/resident.py:138",
}
SOURCES = {
    "build_tables": "tendermint_tpu_torch/csrc/build_tables.cu",
    "assemble": "tendermint_tpu_torch/csrc/xverify.cu",
    "xverify": "tendermint_tpu_torch/csrc/xverify.cu",
    "xverify_window": "tendermint_tpu_torch/csrc/xverify.cu",
    "general_verify": "tendermint_tpu_torch/csrc/general_verify.cu",
    "splice": "tendermint_tpu_torch/csrc/splice.cu",
    "clear": "tendermint_tpu_torch/csrc/splice.cu",
    "arena_verify": "tendermint_tpu_torch/csrc/arena_verify.cu",
    "sr_verify": "tendermint_tpu_torch/csrc/sr_verify.cu",
    "general_verify_mixed": "tendermint_tpu_torch/csrc/general_verify.cu",
    "xverify_votes": "tendermint_tpu_torch/csrc/xverify.cu",
    "general_verify_light_commit":
        "tendermint_tpu_torch/csrc/general_verify.cu",
    "general_verify_light": "tendermint_tpu_torch/csrc/general_verify.cu",
    "general_verify_light_client":
        "tendermint_tpu_torch/csrc/general_verify.cu",
    "general_verify_admission": "tendermint_tpu_torch/csrc/general_verify.cu",
    "shard_verify": "tendermint_tpu_torch/csrc/xverify.cu",
    "mesh_splice": "tendermint_tpu_torch/csrc/splice.cu",
    "mesh_clear": "tendermint_tpu_torch/csrc/splice.cu",
    "mesh_arena_verify": "tendermint_tpu_torch/csrc/arena_verify.cu",
}
# The __global__ function of each row (K5 is K3's kernel, and K2 runs
# inside it; K8's splice, clear and verify are K6's and K7's kernels;
# K1 is two launches, the chain's and the rows'; the
# general_verify_mixed row is K4 at the mixed commit's shape, the
# xverify_window row K3 at a fast-sync window's, xverify_votes K3 at a
# vote batch's, general_verify_light_commit K4 at a light commit check's,
# general_verify_light K4 at the light verify collector's widest launch
# and general_verify_light_client K4 at the serving plane's widest flush
# in the light_client phase, a row only when that flush's bucket is one
# no other K4 row has, and general_verify_admission K4 at a full
# admission flush: 256 signed txs and the sentinel lane in the 512-lane
# bucket).
GLOBALS = {name: "k_" + name for name in SOURCES}
GLOBALS.update(assemble="k_xverify", shard_verify="k_xverify",
               xverify_window="k_xverify", xverify_votes="k_xverify",
               mesh_splice="k_splice", mesh_clear="k_clear",
               mesh_arena_verify="k_arena_verify",
               build_tables=("k_build_chain", "k_build_rows"),
               general_verify_mixed="k_general_verify",
               general_verify_light_commit="k_general_verify",
               general_verify_light="k_general_verify",
               general_verify_light_client="k_general_verify",
               general_verify_admission="k_general_verify")
# The kernel whose launches a row counts, where it is not the row's own.
ROW_KERNEL = {"general_verify_mixed": "general_verify",
              "general_verify_light_commit": "general_verify",
              "general_verify_light": "general_verify",
              "general_verify_light_client": "general_verify",
              "general_verify_admission": "general_verify",
              "xverify_window": "xverify", "xverify_votes": "xverify"}
# K2 is no launch of its own: it runs inside the structured form of K3
# and K5 (csrc/xverify.cu), as the reference traces assemble_core into
# _skernel; its row counts the launches that carry it.
INSIDE = {"assemble": ("xverify", "shard_verify")}
# The kernels spread over many threads a key or lane (K1, K3, K4, K5,
# K7, K8's verify, K9): the shape export of each and its number of
# launches (kernels.launch_shapes). Each launch must run at least
# MIN_THREADS_PER_ITEM threads a key or lane, with no spills.
SHAPE_EXPORTS = {"build_tables": ("tm_build_tables_shape", 2),
                 "xverify": ("tm_xverify_shape", 1),
                 "shard_verify": ("tm_xverify_shape", 1),
                 "general_verify": ("tm_general_verify_shape", 1),
                 "sr_verify": ("tm_sr_verify_shape", 1),
                 "arena_verify": ("tm_arena_verify_shape", 1),
                 "mesh_arena_verify": ("tm_arena_verify_shape", 1)}
# K4's, K7's and K9's verdict digests on the kernels check's adversarial
# batches and arena, as the one-thread-a-lane kernels gave them in both
# fields: the four-thread-a-lane bodies must reproduce them.
VERDICT_DIGESTS = {"general_verify": "a106af0ce1da1c4b",
                   "arena_verify": "424457bc6352ff63",
                   "sr_verify": "f73a94992d6667f6"}
MIN_THREADS_PER_ITEM = 4
SLICE_KERNELS = ("build_tables", "xverify", "general_verify")
SPEC_KERNELS = ("splice", "clear", "arena_verify")
MIXED_KERNELS = ("general_verify", "sr_verify")
# The fabric phase's logical mesh when the machine has one card, and
# the crossover that splits the 10,240-key set into 4 x 2,560 keys.
LOGICAL_SHARDS = 4
FABRIC_CROSSOVER = 5120
FABRIC_RUNS = 11  # verify_commit runs on the mesh; the first is dropped
# The fastsync phase's chain: BASELINE.json config #3's 1,000-validator
# set (equal power) and its 10,000 blocks cut to 129 (8 windows of 16
# verified blocks), from height 121 so that the first window crosses
# height 128; the commit for height 125 is made in round 1 (its
# templates are 9 bytes wider: the canonical vote's round field). Eight
# peers serve it (BlockPool's 20 pending requests a peer).
FASTSYNC_VALIDATORS = 1_000
FASTSYNC_START = 121
FASTSYNC_BLOCKS = 129
FASTSYNC_ROUND1 = 125
FASTSYNC_PEERS = 8
# The votes phase: one height of consensus over the first 10,000
# validators of the slice phase's set (BASELINE.json config #5's
# 10,240 cut to MAX_VOTES_COUNT, the most a VoteSet admits) at
# ConsensusConfig's defaults (a 2 ms window, batches of 1,024, a 4,096-vote buffer).
# Eight peers deliver every validator's prevote and precommit and
# VOTES_NIL round-1 nil precommits in bursts of VOTES_BURST votes, after
# VOTES_LATE late precommits for the height before (two bursts); the
# VOTES_OVER_AT-th ordinary burst is VOTES_OVERFLOW votes longer than
# the buffer, and VOTES_FINAL fresh votes are held back for the last
# burst. Then a VOTES_MIXED-vote burst on the mixed set and a
# VOTES_SMALL-vote burst under _EXPAND_MIN.
VOTES_PEERS = 8
VOTES_BURST = (64, 512)
VOTES_NIL = 32
VOTES_LATE = 512
VOTES_OVER_AT = 12
VOTES_OVERFLOW = 4
VOTES_FINAL = 64
VOTES_MIXED = 1024
VOTES_SMALL = 64
# The paced run: the height's valid votes again, to a fresh
# HeightVoteSet, in shuffled bursts of VOTES_BURST from VOTES_PEERS
# peers at VOTES_RATE votes a second, the driver never waiting for the
# scheduler. Its time from the first enqueue to +2/3 precommits is the
# phase's end-to-end figure; the drained run above, where a batch is a
# burst, fixes the launches the outcome checks count. 20,000 votes a
# second brings a 10,000-validator height's 20,000 votes in ~1 s; at
# 40,000 an H100 80GB HBM3 machine's host shed 0 and 1,086 votes in
# two runs (PERF.md).
VOTES_RATE = 20_000
# The light phase: BASELINE.json config #2's 150-validator set, a chain
# of LIGHT_HEIGHTS headers whose set loses a sixth of its validators
# (and gains as many) every LIGHT_ROTATE heights, verified within a
# two-week trusting period; LIGHT_REQUESTS concurrent skipping
# verifications through the verify collector.
LIGHT_VALIDATORS = 150
LIGHT_HEIGHTS = 64
LIGHT_ROTATE = 16
LIGHT_REQUESTS = 64
LIGHT_T0 = 1_753_930_000_000_000_000
LIGHT_PERIOD_NS = 14 * 24 * 3600 * 10**9
# The light_client phase: the same set and rotation on a node's stores,
# LC_HEIGHTS heights so that LC_TARGET's canonical commit (stored with
# the next block) exists; the forking witness diverges from LC_FORK_FROM
# up; LC_UPDATES sequential update() steps; the plane's LC_REQUESTS
# concurrent requests spread over LC_PLANE_HEIGHTS heights.
LC_HEIGHTS = 520
LC_TARGET = 512
LC_FORK_FROM = 497
LC_UPDATES = 16
LC_REQUESTS = 64
LC_PLANE_HEIGHTS = 16
# The admission phase: the tx path at MempoolConfig's defaults (a pool of
# 5,000 txs, a 10,000-entry cache, batches of 256, a 2 ms deadline, a
# 2,048-tx pre-verify queue, 1,024 CheckTx in flight) on a
# PersistentKVStoreApp through AppConns and LocalClients. The mixed
# traffic is the reference e2e overload mix (ADM_MIX: garbage when
# i % 100 < 30, a valid envelope when < 40, raw otherwise) over ADM_TXS
# unique kvstore txs of 100-200 bytes from ADM_SIGNERS signers, with
# ADM_OUTSTANDING submissions outstanding; the signed-only chain's
# traffic ADM_STRICT valid envelopes and ADM_STRICT_BAD unsigned and as
# many malformed txs under `strict`. A proposer cycle every ADM_CYCLE
# admitted txs. The width probe: ADM_PROBE_SMALL small envelopes and one
# of ADM_WIDE bytes in one flush, then one at max_tx_bytes.
ADM_TXS = 20_000
ADM_MIX = (30, 40)
ADM_SIGNERS = 1_024
ADM_OUTSTANDING = 1_024
ADM_STRICT = 8_000
ADM_STRICT_BAD = 80
ADM_CYCLE = 2_000
ADM_PROBE_SMALL = 255
ADM_WIDE = 64 * 1024
ADM_ORACLE_WORKERS = 8
# The execution phase (commit pipeline): a genesis of EXEC_VALIDATORS
# ed25519 validators (MockPV keys derived from seeds, as make_node_chain
# derives them) over a PersistentKVStoreApp; EXEC_HEIGHTS clean heights,
# each with EXEC_ENVELOPES signed envelopes (one admission flush) and
# EXEC_RAW raw kvstore txs through check_tx; at EXEC_CHANGE_AT `val:`
# txs add one validator and remove one (in force at EXEC_CHANGE_AT + 2);
# then one forged LastCommit, and EXEC_SPEC_HEIGHTS heights whose
# LastCommit a fed SpeculationPlane serves. Crash recovery at
# EXEC_CRASH_H over FileDBs, at each point of EXEC_CRASHES.
# 10,000, not N_VALIDATORS: a block's LastCommit may hold at most
# MAX_VOTES_COUNT signatures (types/block.py Commit.validate_basic, the
# reference's rule and the Go reference's MaxVotesCount), so no block
# of a 10,240-validator chain past the first validates.
EXEC_VALIDATORS = 10_000
EXEC_HEIGHTS = 6
EXEC_SPEC_HEIGHTS = 2
EXEC_ENVELOPES = 64
EXEC_RAW = 32
EXEC_CHANGE_AT = 2
EXEC_CRASH_H = 3
EXEC_CRASHES = {"state.apply.responses_saved": ["state_reapply"],
                "state.apply.app_committed": ["state_from_responses"]}
EXEC_T0 = 1_760_000_000_000_000_000
# The consensus phase: one validator among CS_VALIDATORS (config #5's
# mega-commit cut to MAX_VOTES_COUNT, as the votes and execution phases
# are) running ConsensusState at ConsensusConfig's defaults for
# CS_HEIGHTS heights, its peers played by a child (CS_WORKERS signing
# workers). At CS_FORGE_H one peer's prevote carries a forged signature
# and another equivocates on its precommit; the node proposes
# CS_OWN_H (with the evidence); CS_SILENT_H's round-0 proposer stays
# silent; CS_TX_HEIGHTS carry CS_ENVELOPES signed envelopes and CS_RAW
# raw txs through the node's mempool; CS_CRASH_POINT errors while
# CS_CRASH_H commits, and the node restarts from its disks.
CS_VALIDATORS = 10_000
CS_HEIGHTS = 7
CS_PEERS = 8
CS_BURST = (256, 1024)
CS_WORKERS = 4
CS_FORGE_H = 2
CS_OWN_H = 3
CS_SILENT_H = 4
CS_TX_HEIGHTS = (5,)
CS_ENVELOPES = 64
CS_RAW = 32
CS_CRASH_H = 6
CS_CRASH_POINT = "consensus.commit.wal_delimited"
CS_T0 = 1_760_100_000_000_000_000
CS_PEERS_ARGV = None  # the peers child's command (None: this script's)
# Objects a later step of the same process reads: the kernels check's
# arena (sweep_warps.py times K7 on it).
KEEP: dict = {}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def wrappers():
    from tendermint_tpu_torch.crypto.cuda import (expanded, resident,
                                                  sr_verify, verify)

    return {"build_tables": expanded.build_tables,
            "xverify": expanded.xverify,
            "general_verify": verify.general_verify,
            "splice": resident.splice,
            "clear": resident.clear,
            "arena_verify": resident.arena_verify,
            "sr_verify": sr_verify.sr_verify,
            "shard_verify": expanded.shard_verify,
            "mesh_splice": resident.mesh_splice,
            "mesh_clear": resident.mesh_clear,
            "mesh_arena_verify": resident.mesh_arena_verify}


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call by CUDA events around `reps`
    back-to-back calls, after one warm-up: the host's work between the
    launches (a wrapper's checks, allocations, ctypes call) is inside
    it wherever it leaves the card idle."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, replays: int = 3) -> float:
    """Mean device milliseconds of a call of fn, with no host gaps: after
    one warm-up call, `reps` calls captured in one CUDA graph, and the
    graph replayed `replays` times between two CUDA events, so the
    calls' launches and copies run back to back on the card as the
    graph's nodes. The wrappers' Python runs once, at the capture."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * reps)
    del graph
    return ms


def kernel_times(fn, reps: int) -> dict:
    """A row's two times for fn: `ms`, its device time a call
    (device_ms: a CUDA graph's replay), and `wrapper_us`, a call through
    its Python wrapper in microseconds by CUDA events (cuda_ms), host
    gaps included."""
    return {"ms": device_ms(fn, reps), "wrapper_us": cuda_ms(fn, reps) * 1e3}


def ptxas_summary(log: str, fn: str) -> dict:
    """The lines of an `nvcc -Xptxas -v` report for the __global__
    function `fn` (a source may hold several): its registers, stack
    frame and spills. Its mangled name holds len(fn) then fn."""
    tag = f"{len(fn)}{fn}"
    lines = [ln.strip() for ln in log.splitlines()]
    out, inside = {}, False
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln:
            inside = tag in ln
        if not inside:
            continue
        if "Function properties for" in ln and tag in ln and i + 1 < len(lines):
            out["frame"] = lines[i + 1]
        if ln.startswith("ptxas info") and "Used" in ln and "registers" in ln:
            out["registers"] = ln.split(":", 1)[1].strip()
    return out


def kernel_ptxas(name: str) -> dict:
    """ptxas_summary of the kernels line's row `name` (of each of its
    __global__ functions, by name, where it has several)."""
    from tendermint_tpu_torch.crypto.cuda import kernels

    log = kernels.BUILD_INFO.get("ptxas", {}).get(
        SOURCES[name].rsplit("/", 1)[1], "")
    fns = GLOBALS[name]
    if isinstance(fns, tuple):
        return {fn: ptxas_summary(log, fn) for fn in fns}
    return ptxas_summary(log, fns)


def spill_bytes(summary: dict) -> int:
    """Spill stores plus loads in a kernel_ptxas report."""
    subs = (list(summary.values()) if summary and all(
        isinstance(v, dict) for v in summary.values()) else [summary])
    return sum(int(x) for sub in subs
               for x in re.findall(r"(\d+) bytes spill (?:stores|loads)",
                                   sub.get("frame", "")))


def launch_info(name: str, n: int, *form) -> dict:
    """How a redesigned kernel (SHAPE_EXPORTS) launches for n keys or
    lanes on this card: each launch's grid, block, dynamic shared bytes,
    resident warps an SM, registers and stack (the runtime's), the
    threads a key or lane, and the ptxas spills. Fails unless every
    launch runs at least MIN_THREADS_PER_ITEM threads a key or lane and
    nothing spills."""
    from tendermint_tpu_torch.crypto.cuda import kernels

    export, count = SHAPE_EXPORTS[ROW_KERNEL.get(name, name)]
    shapes = kernels.launch_shapes(export, n, *form, launches=count)
    for s in shapes:
        s["threads_per_item"] = s["blocks"] * s["threads"] / n
    ptxas = kernel_ptxas(name)
    out = {"served": n, "launches": shapes, "ptxas": ptxas,
           "spill_bytes": spill_bytes(ptxas)}
    if (min(s["threads_per_item"] for s in shapes) < MIN_THREADS_PER_ITEM
            or out["spill_bytes"] or not ptxas):
        raise AssertionError(f"{name} launch shape: {out}")
    return out


def max_abs_diff(a, b) -> int:
    import torch

    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def sqrt_m1_branches(rows) -> int:
    """How many of the (n, 32) uint8 encodings take ZIP-215
    decompression's x * sqrt(-1) branch (v x^2 == -u): one multiply
    more each."""
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    p, n = ref.P, 0
    for enc in rows.cpu().numpy():
        y = int.from_bytes(enc.tobytes(), "little") & ((1 << 255) - 1)
        u = (y * y - 1) % p
        v = (ref.D * y * y + 1) % p
        x = u * pow(v, 3, p) * pow(u * pow(v, 7, p), (p - 5) // 8, p) % p
        n += (v * x * x + u) % p == 0
    return n


def lane_digits(ab, sb, msg, nblocks):
    """The 69 nibbles of each lane's folded challenge k' and the 69 of
    its S, LSB-first, by the port's plain functions: two (69, N)."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import scalar as sc
    from tendermint_tpu_torch.crypto.cuda import sha512 as sh

    full = torch.cat([sb[:, :32], ab, msg], dim=1)
    digest = sh.compress_blocks(sh.bytes_to_words(full), nblocks)
    k = sc.fold_digest(sh.digest_bytes_le(digest)).flip(0)
    s = sc.bytes_to_nibbles(sb[:, 32:].to(torch.int64).T)
    return k, torch.cat([s, torch.zeros_like(s[:5])])


def adds_after_first(digits) -> int:
    """Point adds an accumulator needs for these (69, N) digits: one
    per nonzero digit, less the first, which only copies."""
    return int(((digits != 0).sum(0) - 1).clamp(min=0).sum().item())


# -- phase 3 -------------------------------------------------------------


def structured_commit(n_lanes: int, seed: int):
    """A commit whose slots mix for-block and nil votes and edge
    timestamps, signed by fresh keys: the shape K2 assembles."""
    from tendermint_tpu_torch.crypto import ed25519_ref as ref
    from tendermint_tpu_torch.types.block import (
        BlockID, BlockIDFlag, Commit, CommitSig, PartSetHeader)

    seeds = [hashlib.sha256(b"sc-%d-%d" % (seed, i)).digest()
             for i in range(n_lanes)]
    pubs = [ref.public_key_from_seed(s) for s in seeds]
    bid = BlockID(bytes(range(32)), PartSetHeader(3, bytes(32)))
    edge = [0, 1, 999_999_999, 1_000_000_000, 1_753_928_000_123_456_789]
    sigs = [CommitSig(BlockIDFlag.NIL if i % 7 == 3 else BlockIDFlag.COMMIT,
                      bytes([i % 256]) * 20, edge[i % len(edge)] + i, b"")
            for i in range(n_lanes)]
    commit = Commit(977, 1, bid, sigs)
    for i, cs in enumerate(sigs):
        cs.signature = ref.sign(seeds[i], commit.vote_sign_bytes(CHAIN, i))
    return pubs, commit


def kernel_phase(n_keys: int, n_lanes: int, dev) -> dict:
    """Each kernel against its plain version on adversarial inputs."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.crypto import vectors
    from tendermint_tpu_torch.crypto.cuda import expanded, verify
    from tendermint_tpu_torch.crypto.cuda.fieldsel import F as fe
    from tendermint_tpu_torch.types.sign_batch import CommitSignBatch

    out = {}
    before = {k: fn.launches for k, fn in wrappers().items()}
    b = vectors.adversarial_batch(n_keys, n_lanes, seed=1)
    expect = b["expect"]
    # K1: tables limb for limb (same arithmetic), and mod p.
    akeys = torch.from_numpy(
        np.frombuffer(b"".join(b["pubkeys"]), np.uint8).reshape(-1, 32).copy()
    ).to(dev)
    tab_k, ok_k = expanded.build_tables(akeys)
    tab_p, ok_p = expanded.build_tables_plain(akeys)
    canon_k = fe.canonical(tab_k.reshape(-1, fe.NLIMB).T.to(fe.DTYPE))
    canon_eq = bool(torch.equal(
        canon_k, fe.canonical(tab_p.reshape(-1, fe.NLIMB).T.to(fe.DTYPE))))
    out["build_tables"] = dict(
        limbs_equal=bool(torch.equal(tab_k, tab_p)), canonical_equal=canon_eq,
        ok_equal=bool(torch.equal(ok_k, ok_p)),
        key_ok_0_1=ok_k.cpu().tolist()[:2])
    # what the other field's build must reproduce: the key flags, and the
    # canonical values of the first 8 keys' tables
    first = fe.from_limbs(canon_k[:, :8 * 69 * 9 * 4])
    digests = {"build_tables": digest(ok_k), "build_tables_canonical": digest(
        b"".join(v.to_bytes(32, "little") for v in first))}
    if not (out["build_tables"]["limbs_equal"] and canon_eq
            and out["build_tables"]["ok_equal"]):
        raise AssertionError(f"K1 differs from its plain version: {out}")
    if ok_k.cpu().tolist()[:2] != [False, True]:
        raise AssertionError("K1 key_ok: undecodable / small-order keys")
    exp = expanded.ExpandedKeys(b["pubkeys"], device=dev)
    # K3 through the bytes path, against the plain version and expect.
    idx, packed, wf = exp._prepare(b["idx"], b["msgs"], b["sigs"])
    t = verify.to_device(dict(packed, idx=idx), dev)
    args = (t["idx"], exp.akeys, t["sb"], t["s_ok"], exp.key_ok, exp.tables,
            verify._btab(dev))
    bform = dict(msg=t["msg"], nblocks=t["nblocks"])
    v_k = expanded.xverify(*args, **bform)
    v_p = expanded.shard_verify_plain(*args, **bform)
    got = v_k.cpu().numpy()[:n_lanes] & wf
    out["xverify"] = dict(equal_plain=bool(torch.equal(v_k, v_p)),
                          equal_expect=bool((got == expect).all()))
    digests["xverify"] = digest(v_k)
    # K4 on the same lanes with per-lane keys.
    pubs = [b["pubkeys"][k] for k in b["idx"]]
    g = verify.verify_batch(pubs, b["msgs"], b["sigs"], device=dev)
    keep = [i for i, s in enumerate(b["sigs"]) if len(s) == 64]
    bucket = verify._chunks(len(keep))[0]
    dp, dm, ds = verify._dummy_triple()
    pad = bucket - len(keep)
    pk = verify.to_device(verify.pack_batch(
        [pubs[i] for i in keep] + [dp] * pad,
        [b["msgs"][i] for i in keep] + [dm] * pad,
        [b["sigs"][i] for i in keep] + [ds] * pad), dev)
    gargs = (pk["ab"], pk["sb"], pk["msg"], pk["nblocks"], pk["s_ok"],
             verify._btab(dev))
    g_k = verify.general_verify(*gargs)
    out["general_verify"] = dict(
        equal_plain=bool(torch.equal(g_k, verify.general_verify_plain(*gargs))),
        equal_expect=bool((g == expect).all()))
    digests["general_verify"] = digest(g_k)
    # K2 inside K3's structured form, on a structured commit with one
    # lane's patch off by one byte: the verdicts against the plain
    # version (assemble_plain, then xverify_plain) and against the bytes
    # form on the host's own padding of the materialized sign bytes,
    # which assemble_plain must reproduce byte for byte.
    spubs, commit = structured_commit(n_lanes, seed=2)
    sexp = expanded.ExpandedKeys(spubs, device=dev)
    lanes = list(range(n_lanes))
    sbatch = CommitSignBatch(CHAIN, commit, lanes)
    sigs = [cs.signature for cs in commit.signatures]
    sidx, fields, _wf, width = sexp._prepare_structured(lanes, sbatch, sigs)
    off = n_lanes // 3  # the lane whose patch (its length prefix) is off
    patch = fields["patch"].copy()
    patch[off, 0] ^= 1
    f = verify.to_device(dict(fields, patch=patch, idx=sidx), dev)
    sargs = (f["idx"], sexp.akeys, f["sb"], f["s_ok"], sexp.key_ok,
             sexp.tables, verify._btab(dev))
    sform = dict(templates=(f["pre"], f["pre_len"], f["suf"], f["suf_len"]),
                 patches=(f["patch"], f["split"], f["patch_len"], f["group"]),
                 width=width)
    v_s = expanded.xverify(*sargs, **sform)
    m_p, nb_p = expanded.assemble_plain(*sform["templates"], *sform["patches"],
                                        width)
    host = verify.pack_sig_msg(fields["sb"][:n_lanes], sbatch.materialize())
    hw = host["msg"].shape[1]
    m_host = m_p.cpu().numpy()[:n_lanes]
    want = np.ones(n_lanes, bool)
    want[off] = False
    out["assemble"] = dict(
        equal_plain=bool(torch.equal(
            v_s, expanded.shard_verify_plain(*sargs, **sform))),
        equal_bytes_form=bool(torch.equal(
            v_s, expanded.xverify(*sargs, msg=m_p, nblocks=nb_p))),
        plain_equal_host=bool(
            (np.delete(m_host, off, 0)[:, :hw]
             == np.delete(host["msg"], off, 0)).all()
            and (m_host[:, hw:] == 0).all()
            and (nb_p.cpu().numpy()[:n_lanes] == host["nblocks"]).all()),
        verdicts_expected=bool((v_s.cpu().numpy()[:n_lanes] == want).all()))
    digests["xverify_structured"] = digest(v_s)
    sv = sexp.verify_structured(lanes, sbatch, sigs)
    out["assemble"]["commit_verifies"] = bool(sv.all())
    timed = arena_check(n_lanes, dev, out, digests)
    timed.update(sr_check(n_lanes, dev, out, digests))
    for name in ("build_tables", "xverify", "general_verify", "assemble",
                 "splice", "clear", "arena_verify", "sr_verify"):
        if not all(out[name].values()):
            raise AssertionError(f"{name} check failed: {out[name]}")
    for name, fn in wrappers().items():
        if name in out:  # K5 is held in the fabric phase
            out[name]["launches"] = fn.launches - before[name]
    if dev.type == "cuda":  # device and wrapper times at these shapes
        out["build_tables"].update(kernel_times(
            lambda: expanded.build_tables(akeys), 3))
        out["xverify"].update(kernel_times(
            lambda: expanded.xverify(*args, **bform), 5))
        out["general_verify"].update(kernel_times(
            lambda: verify.general_verify(*gargs), 5))
        # K2 has no launch: the structured K3 that carries it
        out["assemble"]["in_xverify"] = kernel_times(
            lambda: expanded.xverify(*sargs, **sform), 5)
        for name, (fn, reps) in timed.items():
            out[name].update(kernel_times(fn, reps))
    moved = {k: digests[k] for k, v in VERDICT_DIGESTS.items()
             if digests[k] != v}
    if moved:
        raise AssertionError(f"verdict digests moved: {moved}, expected "
                             f"{VERDICT_DIGESTS}")
    out["verdicts"] = digests
    return out


def digest(x) -> str:
    """A short digest of a tensor's bytes (or of bytes), to hold one
    field's build against the other's across processes."""
    if not isinstance(x, bytes):
        x = x.cpu().numpy().tobytes()
    return hashlib.sha256(x).hexdigest()[:16]


def splice_args(arena, b, keep):
    """The splice arguments of batch b's lanes `keep` (slot = lane + 1)
    against the arena's group-1 template."""
    import numpy as np

    from tendermint_tpu_torch.types import sign_batch as sbm

    ts = np.asarray([b["ts"][i] for i in keep], np.int64)
    group = np.ones(len(keep), np.int32)
    patch, split, patch_len = sbm._build_patches(
        arena.pre_len.astype(np.int64), arena.suf_len, group, ts)
    sig_rows = np.frombuffer(b"".join(b["sigs"][i] for i in keep),
                             np.uint8).reshape(-1, 64)
    return [i + 1 for i in keep], sig_rows, patch, split, patch_len, group


def arena_check(n_lanes: int, dev, out: dict, digests: dict):
    """K6 and K7 against their plain versions on an n_lanes arena: the
    adversarial lanes with 64-byte signatures are spliced (every 50th
    left out), so the arena also holds inactive lanes. Fills out's
    splice/clear/arena_verify entries and K7's verdict digest; returns
    the calls to time (and the arena, under "arena")."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.crypto import vectors
    from tendermint_tpu_torch.crypto.cuda import resident

    b = vectors.arena_batch(256, n_lanes - 1, seed=4)
    arena = resident.ResidentArena(n_lanes, device=dev)
    arena.install_keys([b["pubkeys"][k] for k in b["idx"]])
    arena.set_template(1, b["pre"], b["suf"])
    keep = [i for i, sig in enumerate(b["sigs"])
            if len(sig) == 64 and i % 50 != 7]
    args = splice_args(arena, b, keep)
    packed = torch.from_numpy(arena.pack(*args)).to(dev)
    ptrs = [t.data_ptr() for t in arena.buffers()]
    plain = [t.clone() for t in arena.buffers()]
    arena.splice(*args)
    resident.splice_plain(*plain, packed)
    out["splice"] = dict(
        equal_plain=all(torch.equal(x, y)
                        for x, y in zip(arena.buffers(), plain)),
        in_place=ptrs == [t.data_ptr() for t in arena.buffers()])
    largs = arena.launch_args()
    v_k = resident.arena_verify(*largs)
    v_p = resident.arena_verify_plain(*largs)
    want = np.zeros(arena.capacity, bool)
    want[0] = True
    for i in keep:
        want[i + 1] = b["expect"][i]
    out["arena_verify"] = dict(
        equal_plain=bool(torch.equal(v_k, v_p)),
        equal_expect=bool((v_k.cpu().numpy() == want).all()),
        active_lanes=arena.active_lanes)
    digests["arena_verify"] = digest(v_k)
    act_k, act_p = arena._active.clone(), arena._active.clone()
    resident.clear(act_k)
    resident.clear_plain(act_p)
    out["clear"] = dict(equal_plain=bool(torch.equal(act_k, act_p)),
                        sentinel_only=int(act_k.sum().item()) == 1)
    timed = {"splice": (lambda: resident.splice(*arena.buffers(), packed), 50),
             "clear": (lambda: resident.clear(act_k), 50),
             "arena_verify": (lambda: resident.arena_verify(*largs), 5)}
    KEEP["arena"] = arena
    return timed


def k4_args(vs, commit, lanes, dev):
    """K4's device arguments for these validators' lanes of the commit,
    packed as the entry points pack them: one bucket, padded with the
    dummy triple."""
    from tendermint_tpu_torch.crypto.cuda import verify

    size = verify._chunks(len(lanes))[0]
    dp, dm, ds = verify._dummy_triple()
    pad = size - len(lanes)
    pk = verify.to_device(verify.pack_batch(
        [vs.validators[i].pub_key.bytes() for i in lanes] + [dp] * pad,
        [commit.vote_sign_bytes(CHAIN, i) for i in lanes] + [dm] * pad,
        [commit.signatures[i].signature for i in lanes] + [ds] * pad), dev)
    return (pk["ab"], pk["sb"], pk["msg"], pk["nblocks"], pk["s_ok"],
            verify._btab(dev))


def sr_args(pubs, msgs, sigs, dev):
    """K9's device arguments for these lanes, and the well-formed mask."""
    from tendermint_tpu_torch.crypto.cuda import sr_verify as sv
    from tendermint_tpu_torch.crypto.cuda import verify

    packed, wf = sv.pack_batch_sr(pubs, msgs, sigs)
    t = verify.to_device(packed, dev)
    return (t["ab"], t["rb"], t["kdig"], t["sdig"], t["a_pre"], t["r_pre"],
            t["s_ok"], sv.comb_table(dev)), wf


def sr_branches(args) -> dict:
    """How many lanes take each branch of ristretto equality (V against
    R, on lanes that decode and pass the byte checks) and how many
    decodes of A and R (of encodings that pass the byte checks) take
    each test of sqrt_ratio_m1, by the plain functions."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import ristretto as rs
    from tendermint_tpu_torch.crypto.cuda import sr_verify as sv

    ab, rb, kdig, sdig, a_pre, r_pre, s_ok, btab = args
    v, r, a_ok, r_ok = sv.sr_points_plain(ab, rb, kdig, sdig, a_pre, r_pre,
                                          btab)
    xy, yy = rs.equal_branches(v, r)
    live = a_ok & r_ok & s_ok
    pre = torch.cat([a_pre, r_pre])
    c, f, fi = rs.decode_ratio_branches(sv.encoding_limbs(ab, rb))
    count = lambda m: int(m.sum().item())  # noqa: E731
    return {"equal_xy": count(xy & live), "equal_yy": count(yy & live),
            "ratio_correct": count(c & pre), "ratio_flipped": count(f & pre),
            "ratio_flipped_i": count(fi & pre)}


def sr_check(n_lanes: int, dev, out: dict, digests: dict):
    """K9 against its plain version and the oracle on an n_lanes sr25519
    adversarial batch; every branch must be taken. Fills out's
    sr_verify entry and its verdict digest; returns the call to time."""
    import torch

    from tendermint_tpu_torch.crypto import sr25519_ref as sr
    from tendermint_tpu_torch.crypto import vectors
    from tendermint_tpu_torch.crypto.cuda import sr_verify as sv

    b = vectors.sr_adversarial_batch(n_lanes, seed=5)
    args, wf = sr_args(b["pubs"], b["msgs"], b["sigs"], dev)
    v_k = sv.sr_verify(*args)
    v_p = sv.sr_verify_plain(*args)
    got = v_k.cpu().numpy() & wf
    oracle = [sr.verify(p, m, s) for p, m, s in zip(b["pubs"], b["msgs"],
                                                     b["sigs"])]
    branches = sr_branches(args)
    out["sr_verify"] = dict(equal_plain=bool(torch.equal(v_k, v_p)),
                            equal_oracle=got.tolist() == oracle,
                            equal_expect=bool((got == b["expect"]).all()),
                            every_branch=min(branches.values()) > 0)
    out["sr_branches"] = branches
    digests["sr_verify"] = digest(v_k)
    return {"sr_verify": (lambda: sv.sr_verify(*args), 5)}


# -- phase 4 -------------------------------------------------------------


def make_commit(n: int):
    """n validators of equal power and a commit signed by all of them
    (bench.py's shape: one block id, per-slot timestamps), and each
    key's seed. Keys and signatures by Ed25519PrivKey (OpenSSL where the
    host has it: RFC 8032's bytes, as ed25519_ref gives them)."""
    from tendermint_tpu_torch.crypto import ed25519
    from tendermint_tpu_torch.types.block import (
        BlockID, BlockIDFlag, Commit, CommitSig, PartSetHeader)
    from tendermint_tpu_torch.types.validator import Validator
    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    seeds = [hashlib.sha256(b"smoke-val-%d" % i).digest() for i in range(n)]
    keys = [ed25519.Ed25519PrivKey(s) for s in seeds]
    pubs = [k.pub_key().bytes() for k in keys]
    key_of = dict(zip(pubs, keys))
    vs = ValidatorSet([Validator.new(ed25519.Ed25519PubKey(p), 10)
                       for p in pubs])
    seed_of = {p: s for p, s in zip(pubs, seeds)}
    bid = BlockID(b"\xab" * 32, PartSetHeader(4, b"\xcd" * 32))
    base_ts = 1_753_928_000_000_000_000
    cs = [CommitSig(BlockIDFlag.COMMIT, v.address, base_ts + i * 1_000_003, b"")
          for i, v in enumerate(vs.validators)]
    commit = Commit(123456, 0, bid, cs)
    for i, v in enumerate(vs.validators):
        cs[i].signature = key_of[v.pub_key.bytes()].sign(
            commit.vote_sign_bytes(CHAIN, i))
    return vs, commit, bid, seed_of


def slice_phase(vs, commit, bid) -> dict:
    import numpy as np

    from tendermint_tpu_torch.crypto import ed25519_ref as ref
    from tendermint_tpu_torch.crypto.batch import BatchVerifier
    from tendermint_tpu_torch.types.validator_set import VerificationError

    h = commit.height
    kernels = wrappers()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    warm = vs.warm_device_tables()
    if warm is None:
        raise AssertionError("the set does not take the expanded path")
    warm.join()  # re-raises a failed build
    table_build_s = time.perf_counter() - t0
    if kernels["build_tables"].launches != 1:
        raise AssertionError("the table build did not launch K1 once: "
                             f"{kernels['build_tables'].launches}")
    runs = []
    for _ in range(11):
        t0 = time.perf_counter()
        vs.verify_commit(CHAIN, bid, h, commit)
        runs.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    vs.verify_commit_light(CHAIN, bid, h, commit)
    light_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    vs.verify_commit_light_trusting(CHAIN, commit, 1, 3)
    trusting_ms = (time.perf_counter() - t0) * 1e3
    bad = len(vs.validators) * 27 // 64
    good_sig = commit.signatures[bad].signature
    commit.signatures[bad].signature = good_sig[:40] + bytes(
        [good_sig[40] ^ 4]) + good_sig[41:]
    try:
        vs.verify_commit(CHAIN, bid, h, commit)
    except VerificationError as e:
        message = str(e)
    else:
        raise AssertionError("corrupted commit verified")
    finally:
        commit.signatures[bad].signature = good_sig
    if message != f"invalid signature(s) at index(es) [{bad}]":
        raise AssertionError(f"wrong rejection: {message}")
    # 64 lanes (40 <= n < 128): BatchVerifier's general kernel.
    bv = BatchVerifier()
    for i in range(64):
        v = vs.validators[i]
        sig = commit.signatures[i].signature
        if i == 7:
            sig = sig[:33] + bytes([sig[33] ^ 1]) + sig[34:]
        bv.add(v.pub_key, commit.vote_sign_bytes(CHAIN, i), sig)
    all_ok, lanes = bv.verify()
    want = np.ones(64, bool)
    want[7] = False
    if all_ok or not (lanes == want).all():
        raise AssertionError("BatchVerifier verdicts")
    launches = {name: kernels[name].launches for name in SLICE_KERNELS}
    if not all(launches.values()):
        raise AssertionError(f"a kernel did not launch: {launches}")
    breakdown = commit_breakdown(vs, commit)
    # the repo's oracle on a few lanes of the same commit
    for i in (0, bad, len(vs.validators) - 1):
        v = vs.validators[i]
        if not ref.verify(v.pub_key.bytes(), commit.vote_sign_bytes(CHAIN, i),
                          commit.signatures[i].signature):
            raise AssertionError(f"oracle rejects lane {i}")
    return dict(table_build_s=table_build_s,
                verify_commit_ms=runs[1:],
                verify_commit_p50_ms=statistics.median(runs[1:]),
                first_verify_commit_ms=runs[0],
                verify_commit_light_ms=light_ms,
                verify_commit_light_trusting_ms=trusting_ms,
                rejected=message, launches=launches, breakdown=breakdown)


def commit_breakdown(vs, commit, reps: int = 7) -> dict:
    """Median ms of the stages of one structured verify_commit at this
    size: the host's CommitSignBatch and packing, then the device call
    (uploads, K3 with K2 inside, verdict readback). Its launches are counted
    outside the main-path run (the caller has read the counters)."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import expanded
    from tendermint_tpu_torch.types.sign_batch import CommitSignBatch

    exp = expanded.get_expanded([v.pub_key.bytes() for v in vs.validators])
    lanes = list(range(len(vs.validators)))
    sigs = [cs.signature for cs in commit.signatures]
    stages = {"sign_batch": [], "prepare": [], "device": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        sb = CommitSignBatch(CHAIN, commit, lanes)
        t1 = time.perf_counter()
        prepared = exp._prepare_structured(lanes, sb, sigs)
        t2 = time.perf_counter()
        exp._launch_structured(prepared[0], prepared[1], prepared[3]).cpu()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
            stages[k].append(dt * 1e3)
    return {k + "_ms": statistics.median(v) for k, v in stages.items()}


# -- phase 5 -------------------------------------------------------------


def speculation_phase(vs, commit, bid):
    """The verify-ahead path at full width: precommits observed in
    bursts and flushed (K6 + K7 each), a commit served from the
    speculated verdicts with no verification launch, and a corrupted
    commit rejected after re-verifying its one bad lane. Returns the
    phase's record and the plane's arena."""
    import torch

    from tendermint_tpu_torch.config import SpeculationConfig
    from tendermint_tpu_torch.consensus import SpeculationPlane
    from tendermint_tpu_torch.crypto.cuda.resident import ResidentArena
    from tendermint_tpu_torch.types.validator_set import VerificationError
    from tendermint_tpu_torch.types.vote import Vote, VoteType

    h, r = commit.height, commit.round
    votes = [Vote(VoteType.PRECOMMIT, h, r, bid, cs.timestamp,
                  cs.validator_address, i, cs.signature)
             for i, cs in enumerate(commit.signatures)]
    kernels = wrappers()
    host_ms: dict[str, list] = {"splice": [], "launch": []}

    def timed(name, fn):
        def run(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(self, *a, **kw)
            torch.cuda.synchronize()
            host_ms[name].append((time.perf_counter() - t0) * 1e3)
            return res
        return run

    orig = ResidentArena.splice, ResidentArena.launch
    ResidentArena.splice = timed("splice", orig[0])
    ResidentArena.launch = timed("launch", orig[1])
    try:
        for fn in kernels.values():
            fn.launches = 0
        plane = SpeculationPlane(SpeculationConfig())
        plane.begin_height(CHAIN, vs, h, r, bid)
        flushes = []
        for start in range(0, len(votes), SPEC_BURST):
            for v in votes[start:start + SPEC_BURST]:
                plane.observe_precommit(v)
            k6, k7 = kernels["splice"].launches, kernels["arena_verify"].launches
            t0 = time.perf_counter()
            plane.flush_sync()  # raises if the sentinel lane fails
            flush_ms = (time.perf_counter() - t0) * 1e3
            if (kernels["splice"].launches - k6,
                    kernels["arena_verify"].launches - k7) != (1, 1):
                raise AssertionError("a flush did not launch K6 and K7 once")
            flushes.append(dict(active_lanes=plane._arena.active_lanes,
                                splice_ms=host_ms["splice"][-1],
                                launch_ms=host_ms["launch"][-1],
                                flush_ms=flush_ms))
    finally:
        ResidentArena.splice, ResidentArena.launch = orig
    lanes = plane._heights[h].lanes
    if len(lanes) != len(votes) or not all(ln.verdict for ln in lanes.values()):
        raise AssertionError("a speculated lane did not verify")
    flush_verdicts = digest(bytes(lanes[i].verdict for i in sorted(lanes)))
    verify_kernels = ("xverify", "shard_verify", "general_verify",
                      "arena_verify")
    before = {k: kernels[k].launches for k in verify_kernels}
    t0 = time.perf_counter()
    served = plane.serve_commit(vs, CHAIN, bid, h, commit)
    serve_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    vs.hash()  # serve_commit matches the valset by its hash
    valset_hash_ms = (time.perf_counter() - t0) * 1e3
    during = {k: kernels[k].launches - before[k] for k in verify_kernels}
    if not (served and plane.hits == 1 and not any(plane.misses.values())):
        raise AssertionError(f"no full hit: {plane.hits} {plane.misses}")
    if any(during.values()):
        raise AssertionError(f"a hit launched verification: {during}")
    # one corrupted signature: only its lane may re-verify
    bad = len(votes) * 37 // 64
    good_sig = commit.signatures[bad].signature
    commit.signatures[bad].signature = good_sig[:50] + bytes(
        [good_sig[50] ^ 8]) + good_sig[51:]
    called = []

    def spy(lanes_, msgs, sigs, _orig=vs._batch_verify_lanes):
        called.append(list(lanes_))
        return _orig(lanes_, msgs, sigs)

    vs._batch_verify_lanes = spy
    try:
        plane.serve_commit(vs, CHAIN, bid, h, commit)
    except VerificationError as e:
        message = str(e)
    else:
        raise AssertionError("corrupted commit served")
    finally:
        del vs._batch_verify_lanes
        commit.signatures[bad].signature = good_sig
    if message != f"invalid signature(s) at index(es) [{bad}]" or \
            called != [[bad]] or plane.misses["mismatch"] != 1:
        raise AssertionError(f"wrong rejection: {message} {called}")
    launches = {name: kernels[name].launches for name in SPEC_KERNELS}
    if not all(launches.values()):
        raise AssertionError(f"a kernel did not launch: {launches}")
    lane_verifies = sum(f["active_lanes"] - 1 for f in flushes)
    return dict(flushes=flushes, serve_commit_ms=serve_ms,
                valset_hash_ms=valset_hash_ms, serve_launches=during,
                rejected=message, lane_verifies=lane_verifies,
                flush_verdicts=flush_verdicts, hits=plane.hits,
                misses=dict(plane.misses), launches=launches,
                arena_bytes=plane._arena.arena_bytes(),
                reupload_bytes=plane._arena.reupload_bytes), plane._arena


# -- phase 6 -------------------------------------------------------------


def make_mixed_commit(n: int):
    """n validators of equal power, key i sr25519 when i is odd and
    ed25519 when even (the set sorts them by address), and a commit
    signed by all of them: one block id, per-slot timestamps. The
    ed25519 keys sign as make_commit's do."""
    from tendermint_tpu_torch.crypto import ed25519, sr25519, vectors
    from tendermint_tpu_torch.crypto import sr25519_ref as sr
    from tendermint_tpu_torch.types.block import (
        BlockID, BlockIDFlag, Commit, CommitSig, PartSetHeader)
    from tendermint_tpu_torch.types.validator import Validator
    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    vals, secret_of, key_of = [], {}, {}
    for i in range(n):
        if i % 2:
            secret = hashlib.sha256(b"smoke-sr-%d" % i).digest()
            pk = sr25519.Sr25519PubKey(sr.public_key_from_mini(secret))
        else:
            secret = hashlib.sha256(b"smoke-val-%d" % i).digest()
            key = ed25519.Ed25519PrivKey(secret)
            pk = key.pub_key()
            key_of[pk.bytes()] = key
        vals.append(Validator.new(pk, 10))
        secret_of[pk.bytes()] = secret
    vs = ValidatorSet(vals)
    bid = BlockID(b"\xab" * 32, PartSetHeader(4, b"\xcd" * 32))
    base_ts = 1_753_928_000_000_000_000
    cs = [CommitSig(BlockIDFlag.COMMIT, v.address, base_ts + i * 1_000_003, b"")
          for i, v in enumerate(vs.validators)]
    commit = Commit(123457, 0, bid, cs)
    sr_slots = []
    for i, v in enumerate(vs.validators):
        if v.pub_key.type_name == "sr25519":
            sr_slots.append(i)
        else:
            cs[i].signature = key_of[v.pub_key.bytes()].sign(
                commit.vote_sign_bytes(CHAIN, i))
    sigs = vectors.sr_sign_batch(
        [secret_of[vs.validators[i].pub_key.bytes()] for i in sr_slots],
        [commit.vote_sign_bytes(CHAIN, i) for i in sr_slots])
    for i, sig in zip(sr_slots, sigs):
        cs[i].signature = sig
    return vs, commit, bid, secret_of


def mixed_phase(vs, commit, bid, secret_of, dev) -> dict:
    """The mixed set's commit through the three entry points, launch
    counts read around each call, two corrupted commits and the
    duplicate-vote check."""
    from tendermint_tpu_torch.crypto.cuda import sr_verify as sv
    from tendermint_tpu_torch.crypto.cuda import verify
    from tendermint_tpu_torch.types.validator_set import VerificationError

    h = commit.height
    n_sr = sum(v.pub_key.type_name == "sr25519" for v in vs.validators)
    kernels = wrappers()
    for fn in kernels.values():
        fn.launches = 0
    if vs.warm_device_tables() is not None:
        raise AssertionError("a mixed set took the expanded path")
    groups = []
    real = verify.verify_batch, sv.verify_batch_sr

    def spy(name, fn):
        return lambda *a, **k: groups.append((name, len(a[0]))) or fn(*a, **k)

    def call(fn, *args) -> float:
        before = {k: f.launches for k, f in kernels.items()}
        groups.clear()
        t0 = time.perf_counter()
        fn(*args)
        ms = (time.perf_counter() - t0) * 1e3
        delta = {k: f.launches - before[k] for k, f in kernels.items()}
        want = {k: int(k in MIXED_KERNELS) for k in kernels}
        if delta != want:
            raise AssertionError(f"{fn.__name__} launched {delta}")
        return ms

    verify.verify_batch = spy("ed25519", real[0])
    sv.verify_batch_sr = spy("sr25519", real[1])
    try:
        runs = [call(vs.verify_commit, CHAIN, bid, h, commit)
                for _ in range(5)]
        if sorted(groups) != [("ed25519", len(vs) - n_sr), ("sr25519", n_sr)]:
            raise AssertionError(f"verify_commit's groups: {groups}")
        light_ms = call(vs.verify_commit_light, CHAIN, bid, h, commit)
        light_groups = list(groups)
        trusting_ms = call(vs.verify_commit_light_trusting, CHAIN, commit,
                           1, 3)
        trusting_groups = list(groups)
        rejected = {}
        for kind in ("sr25519", "ed25519"):
            bad = next(i for i in range(len(vs) * 27 // 64, len(vs))
                       if vs.validators[i].pub_key.type_name == kind)
            good = commit.signatures[bad].signature
            commit.signatures[bad].signature = good[:40] + bytes(
                [good[40] ^ 4]) + good[41:]
            try:
                call(vs.verify_commit, CHAIN, bid, h, commit)
            except VerificationError as e:
                rejected[kind] = str(e)
            else:
                raise AssertionError(f"corrupted {kind} commit verified")
            finally:
                commit.signatures[bad].signature = good
            if rejected[kind] != f"invalid signature(s) at index(es) [{bad}]":
                raise AssertionError(f"wrong rejection: {rejected[kind]}")
    finally:
        verify.verify_batch, sv.verify_batch_sr = real
    launches = {name: kernels[name].launches for name in MIXED_KERNELS}
    evidence = duplicate_vote_check(vs, secret_of)
    return dict(sr25519_lanes=n_sr, ed25519_lanes=len(vs) - n_sr,
                verify_commit_ms=runs,
                verify_commit_p50_ms=statistics.median(runs),
                verify_commit_light_ms=light_ms,
                light_groups=light_groups,
                verify_commit_light_trusting_ms=trusting_ms,
                trusting_groups=trusting_groups, rejected=rejected,
                evidence=evidence, launches=launches,
                breakdown=mixed_breakdown(vs, commit, dev))


def duplicate_vote_check(vs, secret_of) -> dict:
    """verify_duplicate_vote on an sr25519 validator's two precommits for
    two block ids: accepted, then rejected with one signature broken."""
    from tendermint_tpu_torch.crypto import sr25519_ref as sr
    from tendermint_tpu_torch.evidence.verify import (EvidenceError,
                                                      verify_duplicate_vote)
    from tendermint_tpu_torch.types.block import BlockID, PartSetHeader
    from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence
    from tendermint_tpu_torch.types.vote import Vote, VoteType

    slot = next(i for i, v in enumerate(vs.validators)
                if v.pub_key.type_name == "sr25519")
    val = vs.validators[slot]
    votes = []
    for b in (0x61, 0x62):
        bid = BlockID(bytes([b]) * 32, PartSetHeader(1, bytes([b]) * 32))
        v = Vote(VoteType.PRECOMMIT, 99, 0, bid, 1_753_928_000_000_000_000,
                 val.address, slot)
        v.signature = sr.sign(secret_of[val.pub_key.bytes()],
                              v.sign_bytes(CHAIN))
        votes.append(v)
    ev = DuplicateVoteEvidence.from_votes(votes[0], votes[1], 1_753_928_000,
                                          vs)
    ev.validate_basic()
    t0 = time.perf_counter()
    verify_duplicate_vote(ev, CHAIN, vs, 1_753_928_000)
    ms = (time.perf_counter() - t0) * 1e3
    good = ev.vote_b.signature
    ev.vote_b.signature = good[:9] + bytes([good[9] ^ 1]) + good[10:]
    try:
        verify_duplicate_vote(ev, CHAIN, vs, 1_753_928_000)
    except EvidenceError as e:
        message = str(e)
    else:
        raise AssertionError("duplicate vote with a bad signature verified")
    if message != "invalid signature on vote B":
        raise AssertionError(f"wrong evidence error: {message}")
    return dict(validator_index=slot, verify_ms=ms, rejected=message)


def mixed_breakdown(vs, commit, dev) -> dict:
    """Milliseconds of the stages of one mixed verify_commit, as its
    code runs them: the slot loop and sign bytes, grouping by key type,
    ed25519 packing and upload, K4 (CUDA events), the Merlin challenges,
    sr25519 packing and upload, K9 (CUDA events), and the readback of
    both verdicts. Its launches are outside the main-path run (the
    caller has read the counters)."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import sr_verify as sv
    from tendermint_tpu_torch.crypto.cuda import verify

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    t = [time.perf_counter()]
    lanes, sigs = [], []
    for idx, cs in enumerate(commit.signatures):
        if not cs.is_absent():
            lanes.append(idx)
            sigs.append(cs.signature)
    msgs = vs._commit_msgs(CHAIN, commit, lanes, lanes)
    t.append(time.perf_counter())
    by_type: dict[str, list[int]] = {}
    for j, i in enumerate(lanes):
        by_type.setdefault(vs.validators[i].pub_key.type_name, []).append(j)
    ed_j, sr_j = by_type["ed25519"], by_type["sr25519"]
    t.append(time.perf_counter())
    size = verify._chunks(len(ed_j))[0]
    dp, dm, ds = verify._dummy_triple()
    pad = size - len(ed_j)
    pk = verify.to_device(verify.pack_batch(
        [vs.validators[lanes[j]].pub_key.bytes() for j in ed_j] + [dp] * pad,
        [msgs[j] for j in ed_j] + [dm] * pad,
        [sigs[j] for j in ed_j] + [ds] * pad), dev)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    ev[0].record()
    v_ed = verify.general_verify(pk["ab"], pk["sb"], pk["msg"], pk["nblocks"],
                                 pk["s_ok"], verify._btab(dev))
    ev[1].record()
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    c = sv.check_bytes([vs.validators[lanes[j]].pub_key.bytes() for j in sr_j],
                       [sigs[j] for j in sr_j])
    t.append(time.perf_counter())
    ks = sv.sr25519_challenges(c["ab"], [msgs[j] for j in sr_j], c["rb"])
    t.append(time.perf_counter())
    st = verify.to_device(dict(
        ab=c["ab"], rb=c["rb"], kdig=sv._nibbles(ks, len(sr_j)),
        sdig=sv._nibbles_of_bytes(c["s_raw"]), a_pre=c["a_pre"],
        r_pre=c["r_pre"], s_ok=c["s_ok"]), dev)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    ev[2].record()
    v_sr = sv.sr_verify(st["ab"], st["rb"], st["kdig"], st["sdig"],
                        st["a_pre"], st["r_pre"], st["s_ok"],
                        sv.comb_table(dev))
    ev[3].record()
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    ok = bool(v_ed.cpu().numpy()[:len(ed_j)].all()) and bool(
        v_sr.cpu().numpy().all())
    t.append(time.perf_counter())
    if not ok:
        raise AssertionError("the breakdown's verdicts reject the commit")
    ms = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
    return {"slot_loop_sign_bytes_ms": ms[0], "grouping_ms": ms[1],
            "ed25519_pack_upload_ms": ms[2],
            "k4_launch_sync_ms": ms[3],
            "k4_events_ms": ev[0].elapsed_time(ev[1]),
            "k4_lanes": size,
            "sr25519_byte_checks_ms": ms[4], "merlin_ms": ms[5],
            "sr25519_nibbles_upload_ms": ms[6],
            "k9_launch_sync_ms": ms[7],
            "k9_events_ms": ev[2].elapsed_time(ev[3]),
            "readback_ms": ms[8]}


def sr_work(args) -> tuple[int, int]:
    """K9's work on lanes whose byte checks pass (the others' verdicts
    are already false): (int32 products, bytes)."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import ristretto as rs
    from tendermint_tpu_torch.crypto.cuda import sr_verify as sv

    ab, rb, kdig, sdig, a_pre, r_pre, s_ok, btab = args
    live = a_pre & r_pre & s_ok
    m = int(live.sum().item())
    c, f, fi = rs.decode_ratio_branches(sv.encoding_limbs(ab[live], rb[live]))
    kd, sd = kdig[:, live], sdig[:, live]
    top = torch.where(kd != 0, torch.arange(64, device=ab.device)[:, None],
                      0).max(0).values  # doublings start after it
    # per lane: decode A and R, the 16-entry table of -A (14 adds), 4
    # doublings per window below k's top nonzero nibble, an add per
    # nonzero nibble of k and of s, the final add, the equality
    ops = (2 * m * RS_DECODE + int((f | fi).sum().item()) * MUL
           + m * 14 * ADD + int(top.sum().item()) * 4 * DOUBLE
           + adds_after_first(kd) * ADD + adds_after_first(sd) * ADD_Z1
           + m * (ADD + RS_EQUAL))
    # A, R, the two nibble rows, three flags and the verdict per lane,
    # and the comb
    nbytes = ab.shape[0] * (32 + 32 + 64 + 64 + 3 + 1) + btab.numel() * 4
    return ops, nbytes


def sr_row(vs, commit, dev) -> dict:
    """K9 at the mixed commit's sr25519 lanes: time, plain time, bound
    and agreement with the plain version."""
    lanes = [i for i, v in enumerate(vs.validators)
             if v.pub_key.type_name == "sr25519"]
    args, _ = sr_args([vs.validators[i].pub_key.bytes() for i in lanes],
                      [commit.vote_sign_bytes(CHAIN, i) for i in lanes],
                      [commit.signatures[i].signature for i in lanes], dev)
    from tendermint_tpu_torch.crypto.cuda import sr_verify as sv

    v_k = sv.sr_verify(*args)
    v_p, p_ms = plain_ms(lambda: sv.sr_verify_plain(*args))
    if not bool(v_k.all()):
        raise AssertionError("K9 rejects the valid commit's lanes")
    ops, nbytes = sr_work(args)
    row = entry("sr_verify", max_abs_diff(v_k, v_p),
                kernel_times(lambda: sv.sr_verify(*args), 10), p_ms, ops,
                nbytes)
    row["lanes"] = len(lanes)
    row["launch"] = launch_info("sr_verify", len(lanes))
    return row


def k4_mixed_row(vs, commit, dev) -> dict:
    """K4 at the mixed commit's ed25519 lanes (one 8,192-lane bucket)."""
    lanes = [i for i, v in enumerate(vs.validators)
             if v.pub_key.type_name == "ed25519"]
    return k4_row("general_verify_mixed", k4_args(vs, commit, lanes, dev),
                  len(lanes))


def k4_row(name, gargs, live: int) -> dict:
    """K4 on gargs, whose first `live` lanes are valid ones (the rest
    the bucket's padding): time, plain time, bound, launch shape and
    agreement with the plain version, on these lanes and on a copy with
    one signature bit and one message byte flipped (there on the two
    lanes and their neighbours: the plain version is lane by lane)."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import verify

    ab, sb, msg, nblocks, s_ok, btab = gargs
    v_k = verify.general_verify(*gargs)
    v_p, p_ms = plain_ms(lambda: verify.general_verify_plain(*gargs))
    if not bool(v_k[:live].all()):
        raise AssertionError("K4 rejects the valid commit's lanes")
    # R of one lane and the first message byte of another: exactly
    # those two lanes must fail, in the kernel as in the plain version
    bad = (live // 3, 2 * live // 3)
    sb_f, msg_f = sb.clone(), msg.clone()
    sb_f[bad[0], 0] ^= 1
    msg_f[bad[1], 0] ^= 1
    fargs = (ab, sb_f, msg_f, nblocks, s_ok, btab)
    f_k = verify.general_verify(*fargs)
    want = torch.ones(live, dtype=torch.bool)
    want[list(bad)] = False
    if not torch.equal(f_k[:live].cpu(), want):
        raise AssertionError(f"{name}: K4 on the flipped copy")
    sel = flip_neighbours(bad, live, ab.device)
    err = max(max_abs_diff(v_k, v_p), max_abs_diff(
        f_k[sel], verify.general_verify_plain(
            ab[sel], sb_f[sel], msg_f[sel], nblocks[sel], s_ok[sel], btab)))
    # the work of the real lanes only: the padding's verdicts are not
    # needed
    real = torch.arange(ab.shape[0], device=ab.device) < live
    ops, nbytes = general_work(ab, sb, msg, nblocks, s_ok.bool() & real)
    row = entry(name, err,
                kernel_times(lambda: verify.general_verify(*gargs), 10), p_ms,
                ops, nbytes + btab.numel() * 4)
    row["flipped_lanes"] = list(bad)
    row["lanes"], row["live_lanes"] = int(ab.shape[0]), live
    row["launch"] = launch_info(name, row["lanes"])
    return row


# -- phase 7 -------------------------------------------------------------


# -- the observe phase: the launch ledger, the watchdog, the tracer -----

# Which wrapper's launch count each ledger kernel stands for.
LEDGER_KERNELS = {"structured": "xverify", "expanded": "xverify",
                  "general": "general_verify", "sr25519": "sr_verify",
                  "resident": "arena_verify",
                  "structured_sharded": "shard_verify",
                  "expanded_sharded": "shard_verify",
                  "resident_mesh": "mesh_arena_verify"}
# The kernels-line row whose device_ms is timed at each observed shape.
OBSERVE_ROWS = {("structured", 10_240): "xverify",
                ("general", 128): "general_verify",
                ("general", 8_192): "general_verify_mixed",
                ("sr25519", 5_120): "sr_verify",
                ("resident", 12_288): "arena_verify"}


def observe_phase(vs, commit, bid, mvs, mcommit, mbid, dev) -> dict:
    """The launch ledger on the card: K3 structured at 10,240 lanes, K4
    at 128 and at the mixed commit's 8,192 bucket, K9 at 5,120, K7 at
    10,241 of 12,288 after a K6 splice and K5 on a four-shard mesh of
    this card, each through its dispatch site under a workload tag.
    One record per launch (the counts equal the wrappers' .launches
    deltas), each stamped gpu with the card's name, its lanes and
    capacity those of the launch, verdict ok and its ok lanes the plain
    version's (K4 at 128) or the oracle's; the HBM registry's bytes
    those of the tensors held; the watchdog at gpu, degraded by drift
    against a tenth of K3's exec; the cost of a span and a record."""
    import numpy as np
    import torch

    from tendermint_tpu_torch import device as tdevice
    from tendermint_tpu_torch.crypto import ed25519_ref as ref
    from tendermint_tpu_torch.crypto.cuda import (expanded, kernels, ledger,
                                                  verify, watchdog)
    from tendermint_tpu_torch.libs import tracing

    name = torch.cuda.get_device_name(0)
    ledger.set_capacity(4096)
    n0 = len(ledger.snapshot())
    wr = wrappers()
    before = {k: f.launches for k, f in wr.items()}
    plan = []  # (kernel, capacity, lanes, expected ok lanes)
    with ledger.workload("bench"):
        h = commit.height
        vs.verify_commit(CHAIN, bid, h, commit)
        n = len(vs.validators)
        plan.append(("structured", 10_240, n, n))
        pubs = [v.pub_key.bytes() for v in vs.validators[:64]]
        msgs = [commit.vote_sign_bytes(CHAIN, i) for i in range(64)]
        sigs = [commit.signatures[i].signature for i in range(64)]
        got = verify.verify_batch(pubs, msgs, sigs)
        oracle = np.array([ref.verify(p, m, s)
                           for p, m, s in zip(pubs, msgs, sigs)])
        t = verify.to_device(verify.pack_batch(
            pubs + [verify._dummy_triple()[0]] * 64,
            msgs + [verify._dummy_triple()[1]] * 64,
            sigs + [verify._dummy_triple()[2]] * 64), dev)
        plain = verify.general_verify_plain(
            t["ab"], t["sb"], t["msg"], t["nblocks"], t["s_ok"],
            verify._btab(dev)).cpu().numpy()[:64]
        if not ((got == oracle).all() and (plain == oracle).all()):
            raise AssertionError("observe: K4 at 128 against its plain "
                                 "version and the oracle")
        plan.append(("general", 128, 64, int(plain.sum())))
        mvs.verify_commit(CHAIN, mbid, mcommit.height, mcommit)
        half = len(mvs.validators) // 2
        plan.append(("sr25519", 5_120, half, half))
        plan.append(("general", 8_192, half, half))
        arena = spec_arena(vs, commit, bid, dev)
        verd = arena.launch()
        plan.append(("resident", arena.capacity, arena.active_lanes,
                     int(verd.sum())))
        expanded.set_shard_crossover(FABRIC_CROSSOVER)
        tdevice.set_mesh([str(dev)] * LOGICAL_SHARDS)
        try:
            sexp = expanded.get_expanded([v.pub_key.bytes()
                                          for v in vs.validators])
            if not sexp.sharded:
                raise AssertionError("observe: the set did not shard")
            vs.verify_commit(CHAIN, bid, h, commit)
            per = n // LOGICAL_SHARDS
            plan += [("structured_sharded", verify.lane_bucket(per), per,
                      per)] * LOGICAL_SHARDS
            shard_bytes = {}
            for shard in sexp.shards:
                for x in shard:
                    shard_bytes[x.data_ptr()] = x.nbytes
            table_shard = sum(shard_bytes.values())
            hbm = ledger.hbm_snapshot()
        finally:
            tdevice.set_mesh(None)
            expanded.set_shard_crossover(None)
            with expanded._CACHE_LOCK:  # the fabric phase builds its own
                for key in [k for k, e in expanded._CACHE.items()
                            if e.sharded]:
                    del expanded._CACHE[key]
    delta = {k: f.launches - before[k] for k, f in wr.items()
             if f.launches != before[k]}
    recs = ledger.snapshot()[n0:]
    by_kernel: dict = {}
    for r in recs:
        by_kernel[r["kernel"]] = by_kernel.get(r["kernel"], 0) + 1
    want_counts: dict = {}
    for kernel, count in by_kernel.items():
        w = LEDGER_KERNELS[kernel]
        want_counts[w] = want_counts.get(w, 0) + count
    if want_counts != {k: v for k, v in delta.items()
                       if k not in ("build_tables", "splice")}:
        raise AssertionError(f"observe: records {by_kernel} against "
                             f"launches {delta}")
    got_plan = [(r["kernel"], r["capacity"], r["lanes"], r["ok_lanes"])
                for r in recs]
    if sorted(got_plan) != sorted(plan):
        raise AssertionError(f"observe: records {got_plan}, want {plan}")
    for r in recs:
        if (r["backend"], r["device"], r["device_name"], r["verdict"],
                r["workload"], r["n_devices"], r["compile_cache"]) != \
                ("gpu", "cuda:0", name, "ok", "bench", 1, "hit") or \
                not r["stages_ms"].get("exec", 0) > 0:
            raise AssertionError(f"observe: a record {r}")
    shards = [r for r in recs if r["kernel"] == "structured_sharded"]
    if [r["shard"] for r in shards] != [f"cuda:0/{d}" for d in
                                        range(LOGICAL_SHARDS)] or \
            any(r["shard_lanes"] != [per] * LOGICAL_SHARDS for r in shards):
        raise AssertionError(f"observe: the K5 records {shards}")
    exp = expanded.get_expanded([v.pub_key.bytes() for v in vs.validators])
    comb = sum(x.nbytes for x in (exp.akeys, exp.tables, exp.key_ok))
    dev_hbm = hbm.get("cuda:0", {})
    if dev_hbm.get("comb_tables") != comb or \
            dev_hbm.get("arena") != arena.arena_bytes() or \
            dev_hbm.get("table_shard") != table_shard:
        raise AssertionError(f"observe: HBM registry {hbm}, want "
                             f"{comb} / {arena.arena_bytes()} / {table_shard}")
    shapes = {}
    for r in recs:
        key = (r["kernel"], r["capacity"])
        if key in OBSERVE_ROWS and key not in shapes:
            row = OBSERVE_ROWS[key]
            export, count = SHAPE_EXPORTS[ROW_KERNEL.get(row, row)]
            form = (1,) if export == "tm_xverify_shape" else ()
            shapes[key] = kernels.launch_shapes(export, r["capacity"], *form,
                                                launches=count)[0]
    exec_ms = {}
    for (kernel, cap), row in OBSERVE_ROWS.items():
        vals = [r["stages_ms"]["exec"] for r in recs
                if (r["kernel"], r["capacity"]) == (kernel, cap)]
        exec_ms[row] = statistics.median(vals)
    # the watchdog: the card promised, then drift against a tenth of K3
    watchdog.configure(backend="gpu")
    ok = watchdog.verdict()
    if (ok["status"], ok["effective_backend"]) != ("ok", "gpu"):
        raise AssertionError(f"observe: watchdog {ok}")
    os.environ["TM_TPU_SILICON_BASELINE_MS"] = str(exec_ms["xverify"] / 10)
    try:
        drift = watchdog.verdict()
    finally:
        del os.environ["TM_TPU_SILICON_BASELINE_MS"]
    if drift["status"] != "degraded" or "drifted" not in drift["reason"]:
        raise AssertionError(f"observe: no drift {drift} (exec {exec_ms})")
    if watchdog.verdict()["status"] != "ok":
        raise AssertionError("observe: the watchdog did not recover")
    # the cost of an armed span (global tracer, metrics bridge on) and
    # of a ledger record, on this host
    span_us, rec_us = [], []
    for _ in range(2000):
        t0 = time.perf_counter_ns()
        with tracing.TRACER.span(tracing.CRYPTO_PACK, lanes=1):
            pass
        span_us.append((time.perf_counter_ns() - t0) / 1e3)
    with ledger.workload("bench"):
        for _ in range(2000):
            t0 = time.perf_counter_ns()
            ledger.record(kernel="general", device="cuda:0", verdict="ok",
                          lanes=1, capacity=128)
            rec_us.append((time.perf_counter_ns() - t0) / 1e3)
    ledger.reset()
    ledger.set_capacity(ledger.DEFAULT_CAPACITY)
    tracing.TRACER.clear()
    return dict(
        records=[{k: r[k] for k in ("kernel", "lanes", "capacity", "shard",
                                    "stages_ms", "bytes_h2d", "bytes_d2h",
                                    "ok_lanes", "compile_cache")}
                 for r in recs],
        launches=delta, by_kernel=by_kernel,
        ok_lanes_digest=digest(np.array(sorted(
            p[3] for p in got_plan)).tobytes()),
        plain_ok_lanes_digest=digest(np.array(sorted(
            p[3] for p in plan)).tobytes()),
        shapes={f"{k} {c}": s for (k, c), s in shapes.items()},
        exec_ms_p50=exec_ms, hbm=hbm,
        watchdog=dict(ok=ok["effective_backend"], drift=drift["reason"]),
        span_us_p50=statistics.median(span_us),
        record_us_p50=statistics.median(rec_us), device=name)


def observe_against_rows(observe: dict, rows: list) -> dict:
    """Each observed kernel's ledger exec p50 beside its row's device_ms
    at the same shape: positive and at most 3x."""
    ms = {r["name"]: r["ms"] for r in rows}
    out = {}
    for row, ex in observe["exec_ms_p50"].items():
        if not 0 < ex <= 3 * ms[row]:
            raise AssertionError(f"observe: {row} exec {ex} ms against "
                                 f"device_ms {ms[row]}")
        out[row] = dict(exec_ms_p50=ex, device_ms=ms[row])
    return out


def fabric_mesh() -> tuple[list[str], str]:
    """Every CUDA device when there are at least two, else
    LOGICAL_SHARDS logical shards of cuda:0."""
    import torch

    n = torch.cuda.device_count()
    if n >= 2:
        return [f"cuda:{i}" for i in range(n)], "physical"
    return ["cuda:0"] * LOGICAL_SHARDS, "logical"


def k5_check(dev) -> dict:
    """K5 against its plain version, shard by shard, on the adversarial
    batch as precommits (256 keys split over the mesh) in both forms,
    and the routed verdicts against the expected ones."""
    import torch

    from tendermint_tpu_torch.crypto import vectors
    from tendermint_tpu_torch.crypto.cuda import expanded, verify

    b = vectors.arena_batch(256, 1024, seed=6)
    expanded.set_shard_crossover(128)
    try:
        exp = expanded.ExpandedKeys(b["pubkeys"])
    finally:
        expanded.set_shard_crossover(FABRIC_CROSSOVER)
    if not exp.sharded:
        raise AssertionError("the adversarial set did not shard")
    idx, packed, wf = exp._prepare(b["idx"], b["msgs"], b["sigs"])
    sidx, fields, swf, width = exp._prepare_structured(
        b["idx"], vectors.LaneSignBatch(b), b["sigs"])
    tpl = verify.to_device({k: fields[k] for k in exp._S_REPL}, dev)
    forms = {"bytes": (idx, packed, {}, wf),
             "structured": (sidx, {k: v for k, v in fields.items()
                                   if k not in exp._S_REPL},
                            dict(templates=tuple(tpl[k] for k in exp._S_REPL),
                                 width=width), swf)}
    out = {"shards": exp.n_shards, "keys_per_shard": exp.keys_per_shard,
           "verdicts": {}}
    for name, (fidx, lanes, form, well_formed) in forms.items():
        lidx, routed, slot = exp._route(fidx, lanes)
        err, got = 0, []
        for d, shard_dev in enumerate(exp.mesh):
            with torch.cuda.device(shard_dev):
                args, kw = exp._k5_args(d, shard_dev, lidx, routed, **form)
                k = expanded.shard_verify(*args, **kw)
                err = max(err, max_abs_diff(
                    k, expanded.shard_verify_plain(*args, **kw)))
            got.append(k.to(dev))
        verdicts = torch.cat(got).cpu().numpy()[slot] & well_formed
        out["verdicts"][f"shard_verify_{name}"] = digest(verdicts.tobytes())
        out[name] = dict(max_abs_err=err, n_local=int(lidx.shape[1]),
                         equal_expect=bool((verdicts == b["expect"]).all()))
        if err or not out[name]["equal_expect"]:
            raise AssertionError(f"K5 check ({name}) failed: {out[name]}")
    return out


def fabric_phase(vs, commit, bid, mvs, mcommit, mbid, rejected_mixed,
                 dev):
    """The fabric on a mesh (fabric_mesh): K5's check, then the sharded
    ed25519 commit and the mixed commit through the entry points with
    the counters zeroed before and read after, then, outside that run,
    the sharded verdicts against the one-card set's, the per-shard lane
    counts and K5's time per shard launch. Returns the phase's record
    and K5's kernels row."""
    from tendermint_tpu_torch.crypto.cuda import expanded
    from tendermint_tpu_torch.device import set_mesh

    pubkeys = [v.pub_key.bytes() for v in vs.validators]
    single = expanded.get_expanded(pubkeys)  # the slice phase's set
    if single.mesh is not None:
        raise AssertionError("the one-card set was built on a mesh")
    mesh, kind = fabric_mesh()
    set_mesh(mesh)
    expanded.set_shard_crossover(FABRIC_CROSSOVER)
    try:
        return _fabric(vs, commit, bid, mvs, mcommit, mbid, rejected_mixed,
                       single, mesh, kind, dev)
    finally:
        expanded.set_shard_crossover(None)
        set_mesh(None)


def _fabric(vs, commit, bid, mvs, mcommit, mbid, rejected_mixed, single,
            mesh, kind, dev):
    import numpy as np

    from tendermint_tpu_torch.crypto.cuda import expanded
    from tendermint_tpu_torch.types.sign_batch import CommitSignBatch
    from tendermint_tpu_torch.types.validator_set import VerificationError

    d_n = len(mesh)
    out = {"mesh": mesh, "mesh_kind": kind, "k5_check": k5_check(dev)}
    kernels = wrappers()

    def call(fn, *args, want: dict):
        """fn(*args): host ms and the VerificationError text, if any;
        its launches must be `want`."""
        before = {k: f.launches for k, f in kernels.items()}
        message = None
        t0 = time.perf_counter()
        try:
            fn(*args)
        except VerificationError as e:
            message = str(e)
        ms = (time.perf_counter() - t0) * 1e3
        delta = {k: f.launches - before[k] for k, f in kernels.items()}
        if delta != {k: want.get(k, 0) for k in kernels}:
            raise AssertionError(f"{fn.__name__} launched {delta}")
        return ms, message

    # the main path: counters zeroed just before, read just after
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    warm = vs.warm_device_tables()
    if warm is None:
        raise AssertionError("the set does not take the expanded path")
    warm.join()
    build_s = time.perf_counter() - t0
    exp = expanded.get_expanded([v.pub_key.bytes() for v in vs.validators])
    if not (exp.sharded and exp.n_shards == d_n
            and kernels["build_tables"].launches == d_n):
        raise AssertionError(f"sharded build: {exp.sharded} {exp.n_shards} "
                             f"{kernels['build_tables'].launches}")
    h = commit.height
    k5 = {"shard_verify": d_n}
    runs = [call(vs.verify_commit, CHAIN, bid, h, commit, want=k5)
            for _ in range(FABRIC_RUNS)]
    light = call(vs.verify_commit_light, CHAIN, bid, h, commit, want=k5)
    trusting = call(vs.verify_commit_light_trusting, CHAIN, commit, 1, 3,
                    want=k5)
    if any(m for _, m in runs + [light, trusting]):
        raise AssertionError("the sharded path rejected the valid commit")
    bad = len(vs.validators) * 27 // 64
    good_sig = commit.signatures[bad].signature
    commit.signatures[bad].signature = good_sig[:40] + bytes(
        [good_sig[40] ^ 4]) + good_sig[41:]
    try:
        _, message = call(vs.verify_commit, CHAIN, bid, h, commit, want=k5)
    finally:
        commit.signatures[bad].signature = good_sig
    if message != f"invalid signature(s) at index(es) [{bad}]":
        raise AssertionError(f"wrong rejection: {message}")
    mixed_want = {"general_verify": d_n, "sr_verify": d_n}
    mixed_ms, mixed_msg = call(mvs.verify_commit, CHAIN, mbid, mcommit.height,
                               mcommit, want=mixed_want)
    if mixed_msg is not None:
        raise AssertionError(f"the mesh rejected the mixed commit: {mixed_msg}")
    mixed_rejected = {}
    for key_type, want_msg in rejected_mixed.items():
        i = int(want_msg.split("[")[1].rstrip("]"))
        good = mcommit.signatures[i].signature
        mcommit.signatures[i].signature = good[:40] + bytes(
            [good[40] ^ 4]) + good[41:]
        try:
            _, mixed_rejected[key_type] = call(
                mvs.verify_commit, CHAIN, mbid, mcommit.height, mcommit,
                want=mixed_want)
        finally:
            mcommit.signatures[i].signature = good
    if mixed_rejected != rejected_mixed:
        raise AssertionError(f"mixed rejections on the mesh: {mixed_rejected}")
    launches = {k: kernels[k].launches for k in
                ("build_tables", "shard_verify", "general_verify",
                 "sr_verify")}
    # outside the main-path run: the sharded verdicts against the
    # one-card set's, lane for lane, in both forms, on the commit with
    # its corrupted signature
    lanes = list(range(len(vs.validators)))
    commit.signatures[bad].signature = good_sig[:40] + bytes(
        [good_sig[40] ^ 4]) + good_sig[41:]
    try:
        sbatch = CommitSignBatch(CHAIN, commit, lanes)
        sigs = [cs.signature for cs in commit.signatures]
        msgs = sbatch.materialize()
        v_sh = exp.verify_structured(lanes, sbatch, sigs)
        v_one = single.verify_structured(lanes, sbatch, sigs)
        b_sh = exp.verify(lanes, msgs, sigs)
        b_one = single.verify(lanes, msgs, sigs)
    finally:
        commit.signatures[bad].signature = good_sig
    want = np.ones(len(lanes), bool)
    want[bad] = False
    if not ((v_sh == v_one).all() and (b_sh == b_one).all()
            and (v_sh == want).all()):
        raise AssertionError("sharded verdicts differ from the one-card set's")
    trusting_lanes = vs.plan_commit_trusting(CHAIN, commit, 1, 3).lanes
    row, shard_ms = k5_row(exp, commit, lanes, dev)
    out.update(
        build_s=build_s, keys_per_shard=exp.keys_per_shard,
        shard_lanes=shard_lanes(exp, lanes),
        trusting_shard_lanes=shard_lanes(exp, trusting_lanes),
        verify_commit_ms=[ms for ms, _ in runs[1:]],
        verify_commit_p50_ms=statistics.median(ms for ms, _ in runs[1:]),
        first_verify_commit_ms=runs[0][0],
        verify_commit_light_ms=light[0],
        verify_commit_light_trusting_ms=trusting[0], rejected=message,
        verdicts_equal_one_card=True, mixed_verify_commit_ms=mixed_ms,
        mixed_rejected=mixed_rejected, k5_ms=shard_ms,
        device_call_ms=device_call_ms(exp, single, commit, lanes),
        launches=launches)
    return out, row


def shard_lanes(exp, lanes) -> dict:
    """Real lanes per shard and the common bucket n_local of a routed
    launch over these lanes."""
    import numpy as np

    counts = np.bincount(np.asarray(lanes) // exp.keys_per_shard,
                         minlength=exp.n_shards)
    return {"real": counts.tolist(),
            "n_local": exp._bucket(max(int(counts.max()), 1))}


def device_call_ms(exp, single, commit, lanes, reps: int = 5) -> dict:
    """Median host ms of the device call of one structured verify of the
    commit (uploads, launches, verdict readback; and the sharded set's
    routing) on the sharded set and on the one-card set, and of the
    routing alone."""
    import torch

    from tendermint_tpu_torch.types.sign_batch import CommitSignBatch

    sbatch = CommitSignBatch(CHAIN, commit, lanes)
    sigs = [cs.signature for cs in commit.signatures]
    out = {}
    for name, keys in (("sharded", exp), ("one_card", single)):
        idx, fields, _wf, width = keys._prepare_structured(lanes, sbatch, sigs)
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            keys._launch_structured(idx, fields, width).cpu()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times)
    idx, fields, _wf, _width = exp._prepare_structured(lanes, sbatch, sigs)
    per = {k: v for k, v in fields.items() if k not in exp._S_REPL}
    times = []
    for _ in range(reps):  # the host routing inside the sharded call
        t0 = time.perf_counter()
        exp._route(idx, per)
        times.append((time.perf_counter() - t0) * 1e3)
    out["sharded_route"] = statistics.median(times)
    return out


def k5_row(exp, commit, lanes, dev):
    """K5 at the main path's shapes: each shard's launch on the valid
    commit's routed lanes timed alone by CUDA events, then all of them
    on their streams; shard 0's against its plain version, with its
    bound and its device time. Returns the kernels row and the
    times."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import expanded, verify
    from tendermint_tpu_torch.types.sign_batch import CommitSignBatch

    sbatch = CommitSignBatch(CHAIN, commit, lanes)
    sigs = [cs.signature for cs in commit.signatures]
    idx, fields, _wf, width = exp._prepare_structured(lanes, sbatch, sigs)
    tpl = verify.to_device({k: fields[k] for k in exp._S_REPL}, dev)
    templates = tuple(tpl[k] for k in exp._S_REPL)
    lidx, routed, _slot = exp._route(idx, {k: v for k, v in fields.items()
                                            if k not in exp._S_REPL})
    shard_ms, calls = [], []
    for d, shard_dev in enumerate(exp.mesh):
        with torch.cuda.device(shard_dev):
            args, kw = exp._k5_args(d, shard_dev, lidx, routed, templates,
                                    width)
            shard_ms.append(cuda_ms(
                lambda: expanded.shard_verify(*args, **kw), 10))
        calls.append((args, kw))
    # all shards' launches as a sharded verify makes them, one stream
    # each: the span from before the first to after the join
    shard_ms.append(cuda_ms(lambda: verify.run_shards(
        exp.mesh, lambda d, _dev: expanded.shard_verify(*calls[d][0],
                                                        **calls[d][1])), 10))
    args, kw = calls[0]
    v_k = expanded.shard_verify(*args, **kw)
    v_p, p_ms = plain_ms(lambda: expanded.shard_verify_plain(*args, **kw))
    msg, nblocks = expanded.assemble_plain(*kw["templates"], *kw["patches"],
                                           width)
    s_idx, akeys, sb, s_ok, key_ok, _tables, btab = args
    ops, lane_bytes, _msg_bytes, m = xverify_work(akeys, key_ok, s_idx, sb,
                                                  s_ok, msg, nblocks)
    # and per lane the patch, split, patch_len and group; the templates;
    # the comb
    nbytes = (lane_bytes + m * (24 + 3 * 4) + btab.numel() * 4
              + sum(t.numel() * t.element_size() for t in kw["templates"]))
    row = entry("shard_verify", max_abs_diff(v_k, v_p), kernel_times(
        lambda: expanded.shard_verify(*args, **kw), 10), p_ms, ops, nbytes)
    row["lanes"] = int(s_idx.shape[0])
    row["launch"] = launch_info("shard_verify", row["lanes"], 1)
    return row, {"per_shard": shard_ms[:-1], "all_shards": shard_ms[-1]}


# -- phase 8 -------------------------------------------------------------


class PhaseClock:
    """The port's clock (libs/clock.py) while the healing phase runs: it
    stands still but where the phase passes the breakers' cooldowns, so
    an evicted entry stays out however long the host takes, and comes
    back exactly when the phase says."""

    def __init__(self):
        self.t = time.monotonic()

    def monotonic(self) -> float:
        return self.t

    def pass_cooldowns(self) -> None:
        from tendermint_tpu_torch.crypto import batch as cbatch

        brs = list(cbatch._BREAKERS.values()) + list(
            cbatch._DEVICE_BREAKERS.values())
        self.t += max(b.cooldown_remaining() for b in brs) + 1.0


def _by(counter, label: str) -> dict:
    """A metric family's values keyed by one of its labels."""
    return {dict(k)[label]: int(v) for k, v in list(counter._values.items())}


def metrics_view(plane: str) -> dict:
    """A plane's counters, read from the port's metric families
    (libs/metrics.py), as plain dicts the phases take deltas of."""
    from tendermint_tpu_torch.libs import metrics as M

    if plane == "light":
        return {"verify_launches": _by(M.light_metrics().verify_launches,
                                       "backend")}
    if plane == "admission":
        a = M.admission_metrics()
        return {"verify_launches": _by(a.launches, "backend"),
                "sheds": _by(a.sheds, "reason"),
                "admitted": _by(a.admitted, "signed")}
    if plane == "p2p":
        p2p = M.p2p_metrics()
        return {f: _by(getattr(p2p, f), "ch") for f in (
            "peer_send_bytes", "peer_receive_bytes", "message_send",
            "message_receive", "send_drops")}
    if plane == "statesync":
        ss = M.statesync_metrics()
        out = {f: int(getattr(ss, f).value()) for f in (
            "snapshots_discovered", "chunks_received", "chunks_served",
            "chunk_retries", "peers_quarantined", "restore_attempts")}
        out["chunks_refetched"] = _by(ss.chunks_refetched, "reason")
        return out
    raise ValueError(plane)


def fallback_state() -> dict:
    """The breakers' states and the fallback counters, to compare a
    phase's end with its start."""
    import copy

    from tendermint_tpu_torch.crypto import batch as cbatch

    return {"breakers": cbatch.breaker_states(),
            "device_breakers": cbatch.device_breaker_states(),
            "metrics": cbatch.counters()}


def no_fallback(phase: str, before: dict) -> None:
    """A phase other than healing must leave every breaker closed and
    the host fallbacks, rechecks and evictions as they were."""
    after = fallback_state()
    closed = (all(v == "closed" for v in after["breakers"].values())
              and all(v == "closed"
                      for v in after["device_breakers"].values()))
    if not closed or after["metrics"] != before["metrics"]:
        raise AssertionError(f"{phase}: a fallback was taken: {before} -> "
                             f"{after}")


def shard_deltas(arena, slots, sig_rows, patch, split, patch_len, group):
    """The splice's delta rows routed by the round-robin rule on its own
    (slot s -> shard (s-1) % D, local slot (s-1) // D + 1; a slot given
    twice keeps its last row): D packed deltas at local slots, for the
    plain version, and per device block one at block lanes, for K8."""
    import numpy as np

    from tendermint_tpu_torch.crypto.cuda import resident, verify

    d_n, per = arena.n_shards, arena.shard_capacity
    last = {s: j for j, s in enumerate(slots)}
    rows = sorted((s, j) for s, j in last.items())
    by_shard = [[(s, j) for s, j in rows if (s - 1) % d_n == d]
                for d in range(d_n)]

    def pack(pairs, pos):
        j = np.asarray([j for _, j in pairs], np.int64)
        return resident.pack_delta(
            pos, sig_rows[j], verify.s_range_ok(sig_rows[j]), patch[j],
            split[j], patch_len[j], group[j])

    local = [pack(p, [(s - 1) // d_n + 1 for s, _ in p]) for p in by_shard]
    blocks = []
    for blk in arena._blocks:
        pairs, pos = [], []
        for e, d in enumerate(blk["shards"]):
            pairs += by_shard[d]
            pos += [e * per + (s - 1) // d_n + 1 for s, _ in by_shard[d]]
        blocks.append(pack(pairs, pos))
    return local, blocks


def k8_check(dev) -> dict:
    """K8 against its plain versions on a 1,024-lane adversarial arena
    over the mesh: the splice (duplicate slots, inactive lanes) byte for
    byte through the (D, per, ...) view, the verdicts and every shard's
    sentinel exactly, then the clear."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.crypto import vectors
    from tendermint_tpu_torch.crypto.cuda import resident, verify

    b = vectors.arena_batch(256, 1023, seed=7)
    arena = resident.MeshResidentArena(1024)
    arena.install_keys([b["pubkeys"][k] for k in b["idx"]])
    arena.set_template(1, b["pre"], b["suf"])
    keep = [i for i, sig in enumerate(b["sigs"])
            if len(sig) == 64 and i % 50 != 7]
    keep += keep[:40:4]  # slots given twice, with the same rows
    slots, *rows = splice_args(arena, b, keep)
    local, _ = shard_deltas(arena, slots, *rows)
    names = ("sb", "s_ok", "patch", "split", "patch_len", "group", "active")
    plain = [arena.view(n, dev) for n in names]
    arena.splice(slots, *rows)
    resident.mesh_splice_plain(plain, [torch.from_numpy(p).to(dev)
                                       for p in local])
    out = {"shards": arena.n_shards, "per": arena.shard_capacity,
           "blocks": len(arena._blocks)}
    out["mesh_splice"] = max(max_abs_diff(arena.view(n, dev), p)
                             for n, p in zip(names, plain))
    verd = arena.launch()
    v = {n: arena.view(n, dev) for n in ("ab", "sb", "s_ok", "active",
                                         "patch", "split", "patch_len",
                                         "group")}
    tpl = arena.launch_args(0)[4:8]
    o_plain = resident.mesh_arena_verify_plain(
        v["ab"], v["sb"], v["s_ok"], v["active"], *tpl, v["patch"],
        v["split"], v["patch_len"], v["group"], verify._btab(dev)).cpu()
    o_kernel = torch.from_numpy(np.stack([verd[1 + d::arena.n_shards]
                                          for d in range(arena.n_shards)]))
    sent = torch.tensor(arena.sentinel_ok)
    out["mesh_arena_verify"] = max(
        max_abs_diff(o_kernel, o_plain[:, 1:]),
        max_abs_diff(sent, o_plain[:, 0]))
    want = np.zeros(arena.capacity, bool)
    want[0] = True
    for i in keep:
        want[i + 1] = b["expect"][i]
    out["equal_expect"] = bool((verd == want).all())
    out["sentinels"] = arena.sentinel_ok
    act = arena.view("active", dev)
    resident.mesh_clear_plain(act)
    arena.deactivate_all()
    out["mesh_clear"] = max_abs_diff(arena.view("active", dev), act)
    if (out["mesh_splice"] or out["mesh_arena_verify"] or out["mesh_clear"]
            or not out["equal_expect"] or not all(arena.sentinel_ok)):
        raise AssertionError(f"K8 check failed: {out}")
    return out


def healing_phase(vs, commit, bid, seed_of, mvs, mcommit, spec, dev):
    """The self-healing fabric on the fabric phase's mesh (fabric_mesh),
    with the port's clock replaced by PhaseClock: K8's check, then,
    with the counters zeroed before and read after, the speculation
    plane on a MeshResidentArena, a lying shard, live reshards 4 -> 3 ->
    2 -> 4 of the cached sharded set and of the arena, the shard_fail
    failpoint, re-admission by half-open probes, the backend breaker and
    the degraded sr25519 route; every fallback counter must move by
    exactly what the phase injected. Returns the phase's record and
    K8's kernels rows."""
    from tendermint_tpu_torch.crypto import batch as cbatch
    from tendermint_tpu_torch.crypto.cuda import expanded
    from tendermint_tpu_torch.device import set_mesh
    from tendermint_tpu_torch.libs import clock, failpoints

    pubkeys = [v.pub_key.bytes() for v in vs.validators]
    single = expanded.get_expanded(pubkeys)  # the slice phase's set
    mesh, kind = fabric_mesh()
    set_mesh(mesh)
    phase_clock = PhaseClock()
    clock.install(phase_clock)
    try:
        return _healing(vs, commit, bid, seed_of, mvs, mcommit, spec, dev,
                        single, mesh, kind, phase_clock)
    finally:
        cbatch.reset_breakers()
        failpoints.disarm_all()
        clock.uninstall()
        expanded.set_shard_crossover(None)
        set_mesh(None)


def _healing(vs, commit, bid, seed_of, mvs, mcommit, spec, dev, single,
             mesh, kind, phase_clock):
    import numpy as np
    import torch

    from tendermint_tpu_torch.config import SpeculationConfig
    from tendermint_tpu_torch.consensus import SpeculationPlane
    from tendermint_tpu_torch.crypto import batch as cbatch
    from tendermint_tpu_torch.crypto import ed25519_ref as ref
    from tendermint_tpu_torch.crypto.batch import BatchVerifier
    from tendermint_tpu_torch.crypto.cuda import expanded, resident
    from tendermint_tpu_torch.crypto.cuda import sr_verify as sv
    from tendermint_tpu_torch.crypto.cuda import verify as tv
    from tendermint_tpu_torch.libs import failpoints
    from tendermint_tpu_torch.types.block import (BlockID, BlockIDFlag,
                                                  Commit, CommitSig,
                                                  PartSetHeader)
    from tendermint_tpu_torch.types.sign_batch import CommitSignBatch
    from tendermint_tpu_torch.types.validator_set import VerificationError
    from tendermint_tpu_torch.types.vote import Vote, VoteType

    pubkeys = [v.pub_key.bytes() for v in vs.validators]
    names = tv._mesh().names
    d_n = len(mesh)
    n_dev = len(set(mesh))
    out = {"mesh": mesh, "mesh_kind": kind, "entries": list(names),
           "k8_check": k8_check(dev)}
    kernels = wrappers()
    before_state = fallback_state()
    m0 = before_state["metrics"]

    def launched(fn, *args, counted=True, **kw):
        """fn's result and host ms, and the launches it made. A call
        outside the healing path's run (a comparison, a timing:
        counted=False) has its launches taken back out of the counts,
        so that they hold the path's own launches alone."""
        before = {k: f.launches for k, f in kernels.items()}
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        delta = {k: f.launches - before[k] for k, f in kernels.items()
                 if f.launches != before[k]}
        if not counted:
            for k, f in kernels.items():
                f.launches = before[k]
        return res, ms, delta

    def expect(delta, want, what):
        if delta != want:
            raise AssertionError(f"{what} launched {delta}, not {want}")

    # the healing path: counters zeroed just before, read just after
    for fn in kernels.values():
        fn.launches = 0
    # 2. speculation on the mesh: 10 bursts of 1,024 and a full hit
    h, r = commit.height, commit.round
    votes = [Vote(VoteType.PRECOMMIT, h, r, bid, cs.timestamp,
                  cs.validator_address, i, cs.signature)
             for i, cs in enumerate(commit.signatures)]
    plane = SpeculationPlane(SpeculationConfig())
    plane.begin_height(CHAIN, vs, h, r, bid)
    flush_ms = []
    per_flush = {"mesh_splice": n_dev, "mesh_arena_verify": n_dev}
    for start in range(0, len(votes), SPEC_BURST):
        for v in votes[start:start + SPEC_BURST]:
            plane.observe_precommit(v)
        _, ms, delta = launched(plane.flush_sync)
        if start == 0:  # the first flush also clears the new arena
            delta.pop("mesh_clear", None)
        expect(delta, per_flush, "a flush")
        flush_ms.append(ms)
    arena = plane._arena
    if not isinstance(arena, resident.MeshResidentArena) or \
            arena.n_shards != d_n or not all(arena.sentinel_ok):
        raise AssertionError("the plane's arena is not the mesh arena")
    served, serve_ms, delta = launched(plane.serve_commit, vs, CHAIN, bid, h,
                                       commit)
    if not served or plane.hits != 1 or delta:
        raise AssertionError(f"no full hit on the mesh: {delta}")
    template_bytes = sum(a.nbytes for a in (arena.pre, arena.pre_len,
                                            arena.suf, arena.suf_len))
    upload = arena.shard_reupload_bytes()
    if max(upload) > spec["reupload_bytes"] / d_n + template_bytes:
        raise AssertionError(f"per-shard upload {upload} over the bound")
    snapshot = [tuple(t.clone() for t in arena.launch_args(b))
                for b in range(len(arena._blocks))]
    last = list(range(len(votes) - SPEC_BURST, len(votes)))
    out.update(flush_ms=flush_ms, flush_p50_ms=statistics.median(flush_ms),
               serve_commit_ms=serve_ms, shard_reupload_bytes=upload,
               single_reupload_bytes=spec["reupload_bytes"],
               template_bytes=template_bytes)
    # 3. a lying shard: shard 2's resident sentinel signature flipped on
    # the card; the next flush (height h+1's first burst) must name it
    h2 = h + 1
    bid2 = BlockID(b"\xba" * 32, PartSetHeader(4, b"\xdc" * 32))
    cs2 = [CommitSig(BlockIDFlag.COMMIT, v.address,
                     1_753_928_100_000_000_000 + i * 1_000_003, b"")
           for i, v in enumerate(vs.validators)]
    commit2 = Commit(h2, 0, bid2, cs2)
    votes2 = []
    for i in range(3 * 256):
        pub = vs.validators[i].pub_key.bytes()
        votes2.append(Vote(VoteType.PRECOMMIT, h2, 0, bid2, cs2[i].timestamp,
                           cs2[i].validator_address, i,
                           ref.sign(seed_of[pub],
                                    commit2.vote_sign_bytes(CHAIN, i))))
    blk = arena._blocks[arena._block_of[2]]
    blk["bufs"]["sb"][int(arena._off_of[2]), 0] ^= 1
    plane.begin_height(CHAIN, vs, h2, 0, bid2)
    for v in votes2[:256]:
        plane.observe_precommit(v)
    _, lie_ms, delta = launched(plane.flush_sync)
    expect(delta, dict(per_flush, mesh_clear=n_dev), "the lying flush")
    if arena.sentinel_ok != [d != 2 for d in range(d_n)] or \
            cbatch.breaker_states()["ed25519"] != "closed" or \
            cbatch.device_breaker_states() != {names[2]: "open"}:
        raise AssertionError(f"the lying shard: {arena.sentinel_ok} "
                             f"{cbatch.device_breaker_states()}")
    lanes2 = plane._heights[h2].lanes
    if not all(lanes2[i].verdict for i in range(256)):
        raise AssertionError("the host recheck lost a verdict")
    served, _, delta = launched(plane.serve_commit, vs, CHAIN, bid, h,
                                commit)
    if not served or plane.hits != 2 or delta:
        raise AssertionError("the commit no longer serves")
    # 4. live reshard 4 -> 3: the arena at the next flush ...
    for v in votes2[256:512]:
        plane.observe_precommit(v)
    _, _, delta = launched(plane.flush_sync)
    if plane._arena is not arena or arena.n_shards != d_n - 1 or \
            not all(arena.sentinel_ok) or names[2] in arena.names:
        raise AssertionError(f"the arena did not reshard: {arena.names}")
    expect(delta, per_flush, "the resharded flush")
    arena_reshard_s = {"4->3": arena.last_reshard_s}
    # ... and the cached sharded set at the next dispatch
    expanded.set_shard_crossover(FABRIC_CROSSOVER)
    exp = expanded.get_expanded(pubkeys)
    bad = len(vs.validators) * 27 // 64
    table_reshard_s = {}

    def entry_points(n_entries, first=None):
        """verify_commit, _light and _trusting on the slice commit, then
        the corrupted commit; K5 once an entry a call (the first call
        also `first`'s launches: a reshard's K1, the probes' K4)."""
        calls = [(vs.verify_commit, (CHAIN, bid, h, commit)),
                 (vs.verify_commit_light, (CHAIN, bid, h, commit)),
                 (vs.verify_commit_light_trusting, (CHAIN, commit, 1, 3))]
        for j, (fn, args) in enumerate(calls):
            _, _, delta = launched(fn, *args)
            want = {"shard_verify": n_entries}
            if j == 0 and first:
                want.update(first)
            expect(delta, want, fn.__name__)
        good_sig = commit.signatures[bad].signature
        commit.signatures[bad].signature = good_sig[:40] + bytes(
            [good_sig[40] ^ 4]) + good_sig[41:]
        try:
            vs.verify_commit(CHAIN, bid, h, commit)
        except VerificationError as e:
            message = str(e)
        else:
            raise AssertionError("corrupted commit verified")
        finally:
            commit.signatures[bad].signature = good_sig
        if message != f"invalid signature(s) at index(es) [{bad}]":
            raise AssertionError(f"wrong rejection: {message}")
        if expanded.get_expanded(pubkeys) is not exp or \
                exp.n_shards != n_entries:
            raise AssertionError("the cached set was not resharded in place")
        return message

    def lane_for_lane():
        """The cached set's verdicts against the one-card set's, lane
        for lane (a comparison: its launches are not the path's)."""
        lanes = list(range(len(vs.validators)))
        commit.signatures[bad].signature = bytes(64)
        try:
            sbatch = CommitSignBatch(CHAIN, commit, lanes)
            sigs = [cs.signature for cs in commit.signatures]
            v_sh = exp.verify_structured(lanes, sbatch, sigs)
            v_one = single.verify_structured(lanes, sbatch, sigs)
        finally:
            commit.signatures[bad].signature = votes[bad].signature
        if not (v_sh == v_one).all() or v_sh.sum() != len(lanes) - 1:
            raise AssertionError("resharded verdicts differ from one card's")
        return len(lanes)

    rejected = entry_points(d_n - 1, {"build_tables": d_n - 1})
    table_reshard_s["4->3"] = exp.last_reshard_s
    launched(lane_for_lane, counted=False)
    # 5. device.shard_fail on a second entry: evicted at the dispatch's
    # entry, and the same dispatch rides the two survivors
    failpoints.arm("device.shard_fail", "corrupt", nth=2)
    try:
        entry_points(d_n - 2, {"build_tables": d_n - 2})
    finally:
        failpoints.disarm_all()
    table_reshard_s["3->2"] = exp.last_reshard_s
    if cbatch.evicted_devices() != sorted([names[1], names[2]]):
        raise AssertionError(f"evicted: {cbatch.evicted_devices()}")
    # 6. re-admission: past the cooldowns the next dispatch runs both
    # due probes (an 8-lane K4 launch each, on the entry's device),
    # closes the breakers and reshards back to every entry
    phase_clock.pass_cooldowns()
    entry_points(d_n, {"general_verify": 2, "build_tables": d_n})
    table_reshard_s["2->4"] = exp.last_reshard_s
    if cbatch.device_breaker_states() != {names[1]: "closed",
                                          names[2]: "closed"}:
        raise AssertionError("the probes did not re-admit the entries")
    launched(lane_for_lane, counted=False)
    for v in votes2[512:]:
        plane.observe_precommit(v)
    _, _, delta = launched(plane.flush_sync)
    expect(delta, per_flush, "the re-admitted flush")
    if arena.n_shards != d_n or not all(arena.sentinel_ok):
        raise AssertionError("the arena did not reshard back")
    arena_reshard_s["3->4"] = arena.last_reshard_s
    if not all(ln.verdict for ln in plane._heights[h2].lanes.values()):
        raise AssertionError("a height h+1 lane did not verify")
    _, probe_ms, delta = launched(cbatch._probe_ed25519, device=mesh[0],
                                  counted=False)
    expect(delta, {"general_verify": 1}, "a probe")
    # 7. the backend breaker: device.verify raises once under a 64-lane
    # BatchVerifier; the host's verdicts equal the device's
    def bv_64():
        bv = BatchVerifier()
        for i in range(64):
            sig = commit.signatures[i].signature
            if i == 7:
                sig = sig[:33] + bytes([sig[33] ^ 1]) + sig[34:]
            bv.add(vs.validators[i].pub_key, commit.vote_sign_bytes(CHAIN, i),
                   sig)
        return bv.verify()[1]

    on_device, _, delta = launched(bv_64, counted=False)
    expect(delta, {"general_verify": 1}, "the 64-lane batch")
    failpoints.arm("device.verify", "error", count=1)
    on_host, _, delta = launched(bv_64)
    expect(delta, {}, "the failed batch")
    if on_host.tolist() != on_device.tolist() or \
            cbatch.breaker_states()["ed25519"] != "open":
        raise AssertionError("the backend breaker did not take the host")
    phase_clock.pass_cooldowns()
    again, _, delta = launched(bv_64)  # the due probe, then the batch
    expect(delta, {"general_verify": 2}, "the re-admitted batch")
    if again.tolist() != on_device.tolist() or \
            cbatch.breaker_states()["ed25519"] != "closed":
        raise AssertionError("the probe did not close the backend breaker")
    # 8. sr25519 degraded: with its breaker open, 64 sr25519 lanes take
    # verify_batch_sr(device="cpu"); the verdicts equal K9's
    sr = [i for i, v in enumerate(mvs.validators)
          if v.pub_key.type_name == "sr25519"][:64]
    items = [(mvs.validators[i].pub_key, mcommit.vote_sign_bytes(CHAIN, i),
              mcommit.signatures[i].signature) for i in sr]
    pk, m, s = items[5]
    items[5] = (pk, m, s[:40] + bytes([s[40] ^ 4]) + s[41:])
    k9, _, delta = launched(sv.verify_batch_sr, [p.bytes() for p, _, _ in items],
                            [m for _, m, _ in items], [s for _, _, s in items],
                            counted=False)
    expect(delta, {"sr_verify": 1}, "K9 on 64 lanes")
    cbatch.mark_device_failed("sr25519")
    bv = BatchVerifier()
    for it in items:
        bv.add(*it)
    (_, degraded), sr_cpu_ms, delta = launched(bv.verify)
    expect(delta, {}, "the degraded sr25519 batch")
    if degraded.tolist() != k9.tolist() or degraded.sum() != 63:
        raise AssertionError("degraded sr25519 verdicts differ from K9's")
    launches = {k: kernels[k].launches for k in kernels}  # the path's alone
    # the counters moved by exactly what the phase injected
    m1 = cbatch.counters()
    moved = {"host_fallbacks": m1["host_fallbacks"] - m0["host_fallbacks"],
             "host_rechecks": m1["host_rechecks"] - m0["host_rechecks"],
             "evictions": {f"{k[0]} {k[1]}": v - m0["evictions"].get(k, 0)
                           for k, v in m1["evictions"].items()
                           if v != m0["evictions"].get(k, 0)},
             "probes": {f"{k[0]} {k[1]}": v - m0["probes"].get(k, 0)
                        for k, v in m1["probes"].items()
                        if v != m0["probes"].get(k, 0)}}
    injected = {"host_fallbacks": 3, "host_rechecks": 1,
                "evictions": {f"{names[2]} sentinel": 1,
                              f"{names[1]} failpoint": 1},
                "probes": {"ed25519 ok": 3}}
    if moved != injected:
        raise AssertionError(f"counters moved {moved}, injected {injected}")
    rows = mesh_arena_rows(arena, snapshot, commit, last, dev)
    out.update(lie_flush_ms=lie_ms, rejected=rejected,
               table_reshard_s=table_reshard_s,
               arena_reshard_s=arena_reshard_s, probe_ms=probe_ms,
               sr_cpu_ms=sr_cpu_ms, counters_moved=moved,
               launches={k: v for k, v in launches.items() if v},
               k7_ms_per_flush=rows[-1]["ms"])
    return out, rows


def mesh_arena_rows(arena, snapshot, commit, last, dev) -> list[dict]:
    """K8 at the healing phase's main-path shapes, on the block buffers
    the plane's arena held after its tenth flush (`snapshot`, one
    launch_args tuple a device): the splice of the last burst, the
    clear, and the verify of every active lane (all devices' launches
    on their streams), each against its plain version over the
    (D, per, ...) view; with their bounds and, for the splice, the
    library call's time."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.crypto.cuda import expanded, resident, verify

    d_n, per = arena.n_shards, arena.shard_capacity
    blocks = arena._blocks

    def view(b_args, i):
        """(D, per, ...) of the snapshot's i-th launch argument."""
        return torch.stack([
            b_args[arena._block_of[d]][i][arena._off_of[d]:
                                           arena._off_of[d] + per]
            for d in range(d_n)])

    # the splice of the last burst into copies of the blocks
    b = dict(ts=[cs.timestamp for cs in commit.signatures],
             sigs=[cs.signature for cs in commit.signatures])
    lengths = types.SimpleNamespace(pre_len=snapshot[0][5].cpu().numpy(),
                                    suf_len=snapshot[0][7].cpu().numpy())
    slots, *rows = splice_args(lengths, b, last)
    local, per_block = shard_deltas(arena, slots, *rows)
    spliced = (1, 2, 8, 9, 10, 11, 3)  # sb s_ok patch split plen group active
    bufs_k = [[snap[i].clone() for i in spliced] for snap in snapshot]
    packed = [torch.from_numpy(p).to(dev) for p in per_block]

    def k_splice():
        for bk, pk in zip(bufs_k, packed):
            resident.mesh_splice(*bk, pk)

    k_splice()
    plain = [view(snapshot, i).clone() for i in spliced]
    lp = [torch.from_numpy(p).to(dev) for p in local]
    _, p_ms = plain_ms(lambda: resident.mesh_splice_plain(plain, lp))
    got = [torch.stack([bufs_k[arena._block_of[d]][j][
        arena._off_of[d]:arena._off_of[d] + per] for d in range(d_n)])
        for j in range(7)]
    err = max(max_abs_diff(x, y) for x, y in zip(got, plain))
    k = len(last)
    row = entry("mesh_splice", err, kernel_times(k_splice, 100), p_ms, 0,
                k * (resident.ROW_BYTES + SPLICE_WRITE))
    lib = [index_copy_splice([t.clone() for t in bk], pk)
           for bk, pk in zip(bufs_k, packed)]
    lib_t = kernel_times(lambda: [f() for f in lib], 100)
    row["library_ms"] = lib_t["ms"]
    row["library_wrapper_us"] = lib_t["wrapper_us"]
    out = [row]
    # the clear of every block
    acts = [snap[3].clone() for snap in snapshot]

    def k_clear():
        for a in acts:
            resident.mesh_clear(a, per)

    k_clear()
    act_p = view(snapshot, 3).clone()
    _, p_ms = plain_ms(lambda: resident.mesh_clear_plain(act_p))
    got = torch.stack([acts[arena._block_of[d]][arena._off_of[d]:
                                                arena._off_of[d] + per]
                       for d in range(d_n)])
    out.append(entry("mesh_clear", max_abs_diff(got, act_p),
                     kernel_times(k_clear, 100), p_ms, 0, d_n * per))
    # the verify of every active lane, on every device's stream
    devices = [blk["device"] for blk in blocks]

    def k_verify():
        return verify.run_shards(devices, lambda j, _d: resident.mesh_arena_verify(
            *snapshot[j], width=arena.width))

    outs = k_verify()
    o_k = torch.stack([outs[arena._block_of[d]].to(dev)[
        arena._off_of[d]:arena._off_of[d] + per] for d in range(d_n)])
    tpl = snapshot[0][4:8]
    v = {n: view(snapshot, i) for n, i in (("ab", 0), ("sb", 1), ("s_ok", 2),
                                            ("active", 3), ("patch", 8),
                                            ("split", 9), ("patch_len", 10),
                                            ("group", 11))}
    o_p, p_ms = plain_ms(lambda: resident.mesh_arena_verify_plain(
        v["ab"], v["sb"], v["s_ok"], v["active"], *tpl, v["patch"],
        v["split"], v["patch_len"], v["group"], snapshot[0][12],
        arena.width))
    err = max_abs_diff(o_k, o_p)
    flat = {n: t.reshape(d_n * per, *t.shape[2:]) for n, t in v.items()}
    live = flat["active"].nonzero()[:, 0]
    msg, nblocks = expanded.assemble_plain(*tpl, flat["patch"][live],
                                           flat["split"][live],
                                           flat["patch_len"][live],
                                           flat["group"][live], arena.width)
    ops, _ = general_work(flat["ab"][live], flat["sb"][live], msg, nblocks,
                          flat["s_ok"][live])
    lanes = max(int(snap[0].shape[0]) for snap in snapshot)
    # as K7's: per active lane its key, signature, s_ok, patch and three
    # ints; every lane's active flag and verdict; templates, the comb
    nbytes = (live.numel() * (32 + 64 + 1 + 24 + 3 * 4) + 2 * d_n * per
              + sum(t.numel() * t.element_size() for t in tpl)
              + snapshot[0][12].numel() * 4)
    row = entry("mesh_arena_verify", err, kernel_times(k_verify, 5), p_ms,
                ops, nbytes)
    row["active_lanes"] = int(live.numel())
    row["launch"] = launch_info("mesh_arena_verify", lanes)  # largest block
    out.append(row)
    if not bool(np.all(o_k[:, 0].cpu().numpy())):
        raise AssertionError("a snapshot sentinel failed")
    return out


# -- phase 9 -------------------------------------------------------------


def make_fastsync_chain(n_vals: int, start: int, n_blocks: int):
    """n_vals ed25519 validators of equal power (keys from a seed,
    signing by OpenSSL where the host has it) and blocks start ..
    start + n_blocks - 1: block h + 1's LastCommit is signed by every
    validator over block h's real BlockID (its hash and its part set's
    header), per-slot timestamps, in round 1 for FASTSYNC_ROUND1 and 0
    otherwise; the first block's LastCommit is for a block before the
    chain (a node that state-synced to it). Each block carries 32
    kvstore transactions from a seeded generator."""
    import numpy as np

    from tendermint_tpu_torch.crypto import ed25519
    from tendermint_tpu_torch.types.block import (
        Block, BlockID, BlockIDFlag, Commit, CommitSig, Data, Header,
        PartSetHeader)
    from tendermint_tpu_torch.types.evidence import EvidenceData
    from tendermint_tpu_torch.types.validator import Validator
    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    keys = [ed25519.Ed25519PrivKey(hashlib.sha256(
        b"fastsync-val-%d" % i).digest()) for i in range(n_vals)]
    key_of = {k.pub_key().bytes(): k for k in keys}
    vs = ValidatorSet([Validator.new(k.pub_key(), 10) for k in keys])
    signers = [key_of[v.pub_key.bytes()] for v in vs.validators]
    base_ts = 1_753_928_000_000_000_000

    def commit_for(h, bid):
        cs = [CommitSig(BlockIDFlag.COMMIT, v.address,
                        base_ts + h * 1_000_000_007 + 977 * i, b"")
              for i, v in enumerate(vs.validators)]
        commit = Commit(h, int(h == FASTSYNC_ROUND1), bid, cs)
        for i, (sig, key) in enumerate(zip(cs, signers)):
            sig.signature = key.sign(commit.vote_sign_bytes(CHAIN, i))
        return commit

    rng = np.random.default_rng(11)
    vhash = vs.hash()
    tag = hashlib.sha256(b"fastsync-before-%d" % start).digest()
    last_bid = BlockID(tag, PartSetHeader(1, tag))
    last_commit = commit_for(start - 1, last_bid)
    blocks = []
    for h in range(start, start + n_blocks):
        txs = [b"key-%d-%d=%s" % (h, j, rng.bytes(24).hex().encode())
               for j in range(32)]
        evidence = EvidenceData()
        header = Header(
            version_block=11, version_app=1, chain_id=CHAIN, height=h,
            time=base_ts + h * 1_000_000_007, last_block_id=last_bid,
            last_commit_hash=last_commit.hash(), data_hash=Data(txs).hash(),
            validators_hash=vhash, next_validators_hash=vhash,
            consensus_hash=rng.bytes(32), app_hash=rng.bytes(32),
            last_results_hash=b"", evidence_hash=evidence.hash(),
            proposer_address=vs.validators[h % n_vals].address)
        block = Block(header, Data(txs), evidence, last_commit)
        blocks.append(block)
        last_bid = BlockID(block.hash(), block.make_part_set().header())
        last_commit = commit_for(h, last_bid)
    return vs, blocks


async def fastsync_loop(vs, chain, honest=None) -> dict:
    """Fast sync over `chain` as the reference reactor's _try_sync
    drives it (blockchain/reactor.py:209-262), without the block store
    and apply_block: a BlockPool fed by FASTSYNC_PEERS peers serving
    `chain`; each pass peeks BATCH_WINDOW + 1 blocks, awaits their
    verdicts (WindowPipeline.verdicts), starts the next window ahead
    and pops each accepted block. At a failed block it stops, calls
    redo_request for its height and the next (the block and the commit
    that verified it) and refetches from new peers serving `honest`;
    the window's later verdicts are not used (a block whose LastCommit
    was changed has another part set, so the next commit fails it too).
    Returns every verdict the loop used, by height, the redone heights
    and the pipeline's prefetch hits."""
    from tendermint_tpu_torch.blockchain import BlockPool
    from tendermint_tpu_torch.blockchain.verify_ahead import (
        BATCH_WINDOW, WindowPipeline)

    start = chain[0].header.height
    top = chain[-1].header.height
    pool = BlockPool(start)
    peers = itertools.count()

    def serve(blocks, n_peers):
        by_height = {b.header.height: b for b in blocks}
        for _ in range(n_peers):
            pool.set_peer_range(f"peer-{next(peers)}", start, top)
        for peer, h in pool.make_next_requests(now=0.0):
            if not pool.add_block(peer, by_height[h], 0):
                raise AssertionError(f"the pool refused height {h}")

    serve(chain, FASTSYNC_PEERS)
    pipe = WindowPipeline()
    verdicts, redone, windows = [], [], 0
    t0 = time.perf_counter()
    while True:
        blocks = pool.peek_blocks(BATCH_WINDOW + 1)
        if len(blocks) < 2:
            break
        items, _parts, results = await pipe.verdicts(vs, CHAIN, blocks)
        pipe.start_ahead(vs, CHAIN, pool.peek_blocks, len(blocks))
        windows += 1
        for i, err in enumerate(results):
            verdicts.append((items[i][1], err))
            if err is not None:
                bad = [items[i][1], blocks[i + 1].header.height]
                for h in bad:
                    pool.redo_request(h)  # bans the peer that served h
                redone.append(bad)
                serve(honest, FASTSYNC_PEERS)
                break
            pool.pop_request()
    return dict(verdicts=verdicts, redone=redone, windows=windows,
                prefetch_hits=pipe.prefetch_hits, height=pool.height,
                seconds=time.perf_counter() - t0)


def fastsync_phase(dev):
    """Fast sync's verify-ahead plane on the GPU (docstring, phase 9).
    Returns the phase's record and the xverify_window kernels row."""
    import asyncio

    from tendermint_tpu_torch.blockchain.verify_ahead import (
        BATCH_WINDOW, WindowPipeline)
    from tendermint_tpu_torch.types.block import Block

    t0 = time.perf_counter()
    vs, chain = make_fastsync_chain(FASTSYNC_VALIDATORS, FASTSYNC_START,
                                    FASTSYNC_BLOCKS)
    setup_s = time.perf_counter() - t0
    kernels = wrappers()
    batches, job_ms = [], []
    real_lanes, real_job = vs._batch_verify_lanes, \
        WindowPipeline._verify_window_job

    def spy(lanes, msgs, sigs):  # runs in the executor's thread
        pre_len = getattr(msgs, "pre_len", None)  # None: full bytes
        batches.append(dict(
            form=type(msgs).__name__, lanes=len(lanes),
            groups=0 if pre_len is None else len(pre_len),
            pre_len=[] if pre_len is None else sorted(set(pre_len.tolist()))))
        return real_lanes(lanes, msgs, sigs)

    def timed_job(vals, chain_id, blocks):
        t1 = time.perf_counter()
        out = real_job(vals, chain_id, blocks)
        job_ms.append((time.perf_counter() - t1) * 1e3)
        return out

    vs._batch_verify_lanes = spy
    WindowPipeline._verify_window_job = staticmethod(timed_job)
    try:
        # the main path: counters zeroed just before, read just after
        for fn in kernels.values():
            fn.launches = 0
        clean = asyncio.run(fastsync_loop(vs, chain))
        launches = {k: f.launches for k, f in kernels.items() if f.launches}
        clean_batches, clean_job_ms = batches[:], job_ms[:]
        # the faulted copy: a signature inside the quorum prefix of the
        # commit for the third window's 5th block, and a timestamp
        # changed after signing in the sixth window's 10th
        bad_sig_h = FASTSYNC_START + 2 * BATCH_WINDOW + 4
        bad_ts_h = FASTSYNC_START + 5 * BATCH_WINDOW + 9
        faulted = list(chain)
        for h, slot in ((bad_sig_h, FASTSYNC_VALIDATORS // 10),
                        (bad_ts_h, FASTSYNC_VALIDATORS // 5)):
            i = h - FASTSYNC_START + 1  # the block carrying h's commit
            faulted[i] = Block.from_bytes(chain[i].to_bytes())
            cs = faulted[i].last_commit.signatures[slot]
            if h == bad_sig_h:
                cs.signature = cs.signature[:20] + bytes(
                    [cs.signature[20] ^ 2]) + cs.signature[21:]
            else:
                cs.timestamp += 1
        before = {k: f.launches for k, f in kernels.items()}
        bad = asyncio.run(fastsync_loop(vs, faulted, honest=chain))
        faulted_launches = {k: f.launches - before[k]
                            for k, f in kernels.items()
                            if f.launches != before[k]}
    finally:
        WindowPipeline._verify_window_job = staticmethod(real_job)
        del vs._batch_verify_lanes
    n_windows = (FASTSYNC_BLOCKS - 1) // BATCH_WINDOW
    quorum = 2 * FASTSYNC_VALIDATORS // 3 + 1  # equal power
    if clean["windows"] != n_windows or clean["prefetch_hits"] != \
            n_windows - 1 or clean["redone"] or \
            clean["height"] != FASTSYNC_START + FASTSYNC_BLOCKS - 1:
        raise AssertionError(f"fast sync: {dict(clean, verdicts=None)}")
    if any(err is not None for _, err in clean["verdicts"]) or \
            [h for h, _ in clean["verdicts"]] != list(range(
                FASTSYNC_START, FASTSYNC_START + FASTSYNC_BLOCKS - 1)):
        raise AssertionError("a clean block did not verify")
    if launches != {"build_tables": 1, "xverify": n_windows}:
        raise AssertionError(f"fast sync launched {launches}")
    want = dict(form="MergedSignBatch", lanes=BATCH_WINDOW * quorum,
                groups=BATCH_WINDOW)
    if len(clean_batches) != n_windows or any(
            {k: b[k] for k in want} != want for b in clean_batches):
        raise AssertionError(f"window batches: {clean_batches}")
    if len(clean_batches[0]["pre_len"]) != 2:
        raise AssertionError("the first window's templates do not mix "
                             f"widths: {clean_batches[0]}")
    failed = {h: err for h, err in bad["verdicts"] if err is not None}
    if sorted(failed) != [bad_sig_h, bad_ts_h] or any(
            type(e).__name__ != "VerificationError"
            or str(e) != f"invalid commit signature(s) for height {h}"
            for h, e in failed.items()):
        raise AssertionError(f"faulted chain: {failed}")
    if bad["redone"] != [[bad_sig_h, bad_sig_h + 1],
                         [bad_ts_h, bad_ts_h + 1]] or \
            bad["height"] != clean["height"]:
        raise AssertionError(f"faulted chain: redone {bad['redone']}, "
                             f"height {bad['height']}")
    out = dict(validators=FASTSYNC_VALIDATORS, blocks=FASTSYNC_BLOCKS,
               heights=[FASTSYNC_START, FASTSYNC_START + FASTSYNC_BLOCKS - 1],
               reduced="BASELINE.json config #3's 10,000 blocks cut to 129 "
                       "(8 windows of 16) to fit the run's time limit",
               not_run="no block store and no apply_block: the reactor, the "
                       "store and the block executor are not ported yet",
               setup_s=setup_s, windows=clean["windows"],
               prefetch_hits=clean["prefetch_hits"],
               window_batches=clean_batches, launches=launches,
               job_ms=clean_job_ms,
               job_p50_ms=statistics.median(clean_job_ms),
               job_max_ms=max(clean_job_ms),
               blocks_per_s_verify_job=(FASTSYNC_BLOCKS - 1) / sum(
                   clean_job_ms) * 1e3,
               loop_s=clean["seconds"],
               blocks_per_s_loop=(FASTSYNC_BLOCKS - 1) / clean["seconds"],
               faulted=dict(rejected={h: str(e) for h, e in failed.items()},
                            redone=bad["redone"], windows=bad["windows"],
                            prefetch_hits=bad["prefetch_hits"],
                            launches=faulted_launches,
                            other_verdicts_none=True))
    breakdown, row = fastsync_breakdown(vs, chain[:BATCH_WINDOW + 1], dev)
    out["breakdown"] = breakdown
    return out, row


def fastsync_breakdown(vs, blocks, dev, reps: int = 5):
    """Outside the counted run: median ms of the verify job's stages on
    one window (window_items' part sets and block ids; the quorum
    selection and the MergedSignBatch build; _prepare_structured; the
    structured launch with its uploads, synchronized; the verdicts'
    readback), vals.hash() (window_key's cost, twice a window), and K3
    at the window's shape: the xverify_window row."""
    import torch

    from tendermint_tpu_torch.blockchain.verify_ahead import window_items
    from tendermint_tpu_torch.crypto.cuda import expanded, kernels
    from tendermint_tpu_torch.types.sign_batch import (CommitSignBatch,
                                                       MergedSignBatch)

    exp = expanded.get_expanded([v.pub_key.bytes() for v in vs.validators])
    need = 2 * vs.total_voting_power()

    def quorum(commit):
        slots, tallied = [], 0
        for idx, cs in enumerate(commit.signatures):
            if cs.for_block():
                slots.append(idx)
                tallied += vs.validators[idx].voting_power
                if 3 * tallied > need:
                    return slots
        raise AssertionError("no quorum")

    stages = {k: [] for k in ("window_items", "merged_sign_batch",
                              "prepare_structured", "launch", "readback",
                              "valset_hash")}
    for _ in range(reps):
        t0 = time.perf_counter()
        items, _parts = window_items(blocks)
        t1 = time.perf_counter()
        per = [(c, quorum(c)) for _, _, c in items]
        lanes = [s for _, slots in per for s in slots]
        sigs = [c.signatures[s].signature for c, slots in per for s in slots]
        merged = MergedSignBatch([CommitSignBatch(CHAIN, c, slots)
                                  for c, slots in per])
        t2 = time.perf_counter()
        idx, fields, _wf, width = exp._prepare_structured(lanes, merged, sigs)
        t3 = time.perf_counter()
        out = exp._launch_structured(idx, fields, width)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        verdicts = kernels.readback(out)
        t5 = time.perf_counter()
        vs.hash()
        t6 = time.perf_counter()
        for k, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                                  t5 - t4, t6 - t5)):
            stages[k].append(dt * 1e3)
        if not verdicts[:len(lanes)].all():
            raise AssertionError("the breakdown's window did not verify")
    row, _ = k3_row("xverify_window", exp, lanes, merged, sigs, dev)
    return {k + "_ms": statistics.median(v) for k, v in stages.items()}, row


# -- phase 10 ------------------------------------------------------------


def make_votes(vs, seed_of, height: int):
    """Every validator's prevote and precommit for one block at `height`
    (round 0) and VOTES_NIL nil precommits of round 1, signed by
    OpenSSL where the host has it, with seeded timestamps; and the
    signer, sign(index, type, round, block_id)."""
    import numpy as np

    from tendermint_tpu_torch.crypto import ed25519
    from tendermint_tpu_torch.types.block import BlockID, PartSetHeader
    from tendermint_tpu_torch.types.vote import Vote, VoteType

    rng = np.random.default_rng(12)
    tag = hashlib.sha256(b"votes-block-%d" % height).digest()
    block = BlockID(tag, PartSetHeader(2, hashlib.sha256(tag).digest()))
    keys = [ed25519.Ed25519PrivKey(seed_of[v.pub_key.bytes()])
            for v in vs.validators]
    base_ts = 1_753_929_000_000_000_000

    def sign(i, type_, round_=0, bid=block):
        v = Vote(type=type_, height=height, round=round_, block_id=bid,
                 timestamp=base_ts + int(rng.integers(0, 1 << 40)),
                 validator_address=vs.validators[i].address,
                 validator_index=i)
        v.signature = keys[i].sign(v.sign_bytes(CHAIN))
        return v

    n = len(vs.validators)
    votes = [sign(i, VoteType.PREVOTE) for i in range(n)]
    votes += [sign(i, VoteType.PRECOMMIT) for i in range(n)]
    votes += [sign(i, VoteType.PRECOMMIT, 1, None) for i in range(VOTES_NIL)]
    return block, votes, sign


def commit_votes(commit):
    """A commit's precommits as the votes that made it (the reference's
    reconstruct_last_commit)."""
    from tendermint_tpu_torch.types.vote import Vote, VoteType

    return [Vote(type=VoteType.PRECOMMIT, height=commit.height,
                 round=commit.round, block_id=commit.block_id,
                 timestamp=cs.timestamp, validator_address=cs.validator_address,
                 validator_index=i, signature=cs.signature)
            for i, cs in enumerate(commit.signatures)]


def vote_deliveries(votes, late, cfg, rng):
    """The phase's bursts, each a list of (vote, peer): the late
    precommits for h - 1 first (two bursts), then every vote of h
    shuffled into bursts of VOTES_BURST sizes, one of them
    cfg.vote_buf_max + VOTES_OVERFLOW long (its last VOTES_OVERFLOW are
    shed), VOTES_FINAL fresh votes held back for the last burst. Returns
    the bursts, the overfull burst's index and the held-back votes."""
    peers = [f"peer-{k}" for k in range(VOTES_PEERS)]

    def deliver(vs_):
        return [(v, peers[int(rng.integers(VOTES_PEERS))]) for v in vs_]

    half = len(late) // 2
    bursts = [deliver(late[:half]), deliver(late[half:])]
    order = [votes[i] for i in rng.permutation(len(votes))]
    held, rest = order[:VOTES_FINAL], order[VOTES_FINAL:]
    over_at = len(bursts) + VOTES_OVER_AT
    while rest:
        size = (cfg.vote_buf_max + VOTES_OVERFLOW if len(bursts) == over_at
                else int(rng.integers(VOTES_BURST[0], VOTES_BURST[1] + 1)))
        bursts.append(deliver(rest[:size]))
        rest = rest[size:]
    if len(bursts[over_at:over_at + 1]) != 1 or \
            len(bursts[over_at]) != cfg.vote_buf_max + VOTES_OVERFLOW:
        raise AssertionError("the votes do not reach the overfull burst")
    return bursts, over_at, held


async def vote_run(sched, bursts, rate: float | None = None):
    """Deliver each burst to the scheduler as gossip would (the whole
    burst before the loop runs again). Without a rate, wait for each
    burst to be verified and tallied before the next. With one, deliver
    burst k when its first vote is due at `rate` votes a second after
    the first enqueue, whatever the scheduler is doing (the loop runs
    between bursts, the verify in the executor), and drain after the
    last. Returns the first enqueue's time, each burst's and the drained
    time."""
    import asyncio

    sched.start()
    sent, at = 0, []
    t0 = time.perf_counter()
    try:
        for burst in bursts:
            if rate is not None:
                await asyncio.sleep(max(0.0, t0 + sent / rate
                                        - time.perf_counter()))
            at.append(time.perf_counter())
            for vote, peer in burst:
                await sched.receive(vote, peer)
            sent += len(burst)
            if rate is None:
                await sched.drain()
        await sched.drain()
        done = time.perf_counter()
    finally:
        await sched.stop()
    return t0, at, done


class VoteTally:
    """The tally step a VoteScheduler is given, as the reference's
    ConsensusState._try_add_vote/_add_vote do it: late precommits into
    the last commit, the rest into the height's vote sets; a conflicting
    vote becomes DuplicateVoteEvidence (timestamped `ev_time`, the
    block time of its height). Times every call, and the moment the
    round-0 precommits first reach +2/3."""

    def __init__(self, ev_time: int):
        self.sched = None
        self.ev_time = ev_time
        self.evidence, self.refused = [], []
        self.calls, self.seconds, self.maj23_at = 0, 0.0, None

    async def __call__(self, vote, peer_id, preverified):
        from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence
        from tendermint_tpu_torch.types.vote_set import (ConflictingVoteError,
                                                         VoteSetError)

        s = self.sched
        t0 = time.perf_counter()
        try:
            if vote.height + 1 == s.height:
                return s.last_commit.add_vote(vote, verify=not preverified)
            return s.votes.add_vote(vote, peer_id, verify=not preverified)
        except ConflictingVoteError as e:
            self.evidence.append(DuplicateVoteEvidence.from_votes(
                e.existing, vote, self.ev_time, s.validators))
            return False
        except VoteSetError as e:
            self.refused.append(str(e))
            return False
        finally:
            self.calls += 1
            now = time.perf_counter()
            self.seconds += now - t0
            if self.maj23_at is None and s.votes is not None and \
                    s.votes.precommits(0).has_two_thirds_majority():
                self.maj23_at = now


class PeerReporter:
    """The per-peer trust feedback a scheduler reports: [good, bad]."""

    def __init__(self):
        self.counts: dict[str, list[int]] = {}

    def observe(self, peer_id, good=0, bad=0):
        c = self.counts.setdefault(peer_id, [0, 0])
        c[0] += good
        c[1] += bad

    async def enforce(self, peer_id, reason):
        pass


def votes_phase(vs, commit, seed_of, mvs, mcommit, dev):
    """The vote scheduler at one height of consensus (docstring, phase
    10) over the first MAX_VOTES_COUNT validators of the slice phase's
    set (a VoteSet admits no more, the Go reference's MaxVotesCount).
    Returns the phase's record and the xverify_votes row."""
    import asyncio

    import numpy as np

    from tendermint_tpu_torch.config import ConsensusConfig
    from tendermint_tpu_torch.consensus import state
    from tendermint_tpu_torch.consensus.cstypes import HeightVoteSet
    from tendermint_tpu_torch.crypto.cuda import expanded
    from tendermint_tpu_torch.evidence.verify import verify_duplicate_vote
    from tendermint_tpu_torch.libs.overload import CONTROLLER
    from tendermint_tpu_torch.types.block import BlockID, PartSetHeader
    from tendermint_tpu_torch.types.validator_set import ValidatorSet
    from tendermint_tpu_torch.types.vote import MAX_VOTES_COUNT, VoteType
    from tendermint_tpu_torch.types.vote_set import VoteSet

    # the same order, so a validator keeps its index (and the slice
    # commit's precommits stay valid votes of h - 1 for it)
    vs = ValidatorSet(vs.validators[:MAX_VOTES_COUNT])
    h = commit.height + 1
    cfg = ConsensusConfig()
    rng = np.random.default_rng(13)
    t0 = time.perf_counter()
    block, votes, sign = make_votes(vs, seed_of, h)
    # h - 1's set: the same validators in another object, as the state
    # machine holds last_validators; the slice's commit is h - 1's, and
    # VOTES_LATE of its precommits arrive late
    last_vals = ValidatorSet(vs.validators)
    last = commit_votes(commit)[:len(vs)]
    late_idx = set(rng.choice(len(last), VOTES_LATE, replace=False).tolist())
    last_commit = VoteSet(CHAIN, h - 1, 0, VoteType.PRECOMMIT, last_vals)
    for i, v in enumerate(last):
        if i not in late_idx:
            last_commit.add_vote(v, verify=False)
    late = [last[i] for i in sorted(late_idx)]
    bursts, over_at, held = vote_deliveries(votes, late, cfg, rng)
    # the planted faults, at seeded places in the ordinary bursts
    ordinary = [v for k, b in enumerate(bursts) if k >= 2 and k != over_at
                for v, _ in b]
    picks = rng.choice(len(ordinary), 7, replace=False).tolist()
    forged = [ordinary[i] for i in picks[:3]]
    for v in forged:
        v.signature = v.signature[:17] + bytes([v.signature[17] ^ 8]) + \
            v.signature[18:]
    retimed = ordinary[picks[3]]
    retimed.timestamp += 1  # changed after signing
    dups = [ordinary[i] for i in picks[4:6]]
    used = {id(v) for v in forged + [retimed] + dups}
    x = next(v for v in ordinary[picks[6]:] + ordinary
             if v.type == VoteType.PRECOMMIT and v.round == 0
             and id(v) not in used)
    other = BlockID(b"\xee" * 32, PartSetHeader(2, b"\xef" * 32))
    equivocation = sign(x.validator_index, VoteType.PRECOMMIT, 0, other)
    shed = [v for v, _ in bursts[over_at][-VOTES_OVERFLOW:]]
    final = [(v, f"peer-{k % VOTES_PEERS}") for k, v in enumerate(
        held + shed + dups + [equivocation])]
    bursts.append(final)
    setup_s = time.perf_counter() - t0
    planted_bad = {id(v) for v in forged + [retimed]}
    # what the run must report: a lane per delivery but the shed and the
    # duplicates, each peer's [good, bad] over its lanes
    want_counts: dict[str, list[int]] = {}
    want_lanes = 0
    shed_ids, dup_ids = {id(v) for v in shed}, {id(v) for v in dups}
    for k, b in enumerate(bursts):
        for j, (v, peer) in enumerate(b):
            if (k == over_at and id(v) in shed_ids) or (
                    k == len(bursts) - 1 and id(v) in dup_ids):
                continue
            want_lanes += 1
            want_counts.setdefault(peer, [0, 0])[
                int(id(v) in planted_bad)] += 1
    # the run: counters zeroed just before, read just after
    tally = VoteTally(ev_time=commit.signatures[0].timestamp)
    sched = state.VoteScheduler(cfg, CHAIN, tally)
    tally.sched = sched
    sched.new_height(h, vs, HeightVoteSet(CHAIN, h, vs), last_commit)
    reporter = PeerReporter()
    sched.reporter_fn = lambda: reporter
    batches, groups = [], []
    real_bv = state.batch_verdicts

    def timed_bv(batch, chain_id):
        t1 = time.perf_counter()
        out = real_bv(batch, chain_id)
        batches.append(dict(ms=(time.perf_counter() - t1) * 1e3,
                            votes=[e[0] for e in batch], verdicts=out.copy()))
        return out

    def spy(vset):
        real = vset._batch_verify_lanes

        def lanes_spy(lanes, msgs, sigs):
            pre_len = getattr(msgs, "pre_len", None)
            groups.append(dict(form=type(msgs).__name__, lanes=len(lanes),
                               templates=0 if pre_len is None
                               else len(pre_len)))
            return real(lanes, msgs, sigs)
        return lanes_spy

    k1_cached = (expanded._placement(len(vs)), hashlib.sha256(b"".join(
        v.pub_key.bytes() for v in vs.validators)).digest()) in expanded._CACHE
    shed0 = CONTROLLER.sheds.get(state.VOTE_BUF_QUEUE, 0)
    kernels = wrappers()
    state.batch_verdicts = timed_bv
    vs._batch_verify_lanes = spy(vs)
    last_vals._batch_verify_lanes = spy(last_vals)
    try:
        for fn in kernels.values():
            fn.launches = 0
        t_first = asyncio.run(vote_run(sched, bursts))[0]
        launches = {k: f.launches for k, f in kernels.items() if f.launches}
    finally:
        state.batch_verdicts = real_bv
        del vs._batch_verify_lanes, last_vals._batch_verify_lanes
    # the outcomes
    rejected = {id(v) for b in batches
                for v, ok in zip(b["votes"], b["verdicts"]) if not ok}
    lanes = sum(len(b["votes"]) for b in batches)
    want_launch = {"xverify": sum(g["lanes"] >= 128 for g in groups),
                   "general_verify": sum(40 <= g["lanes"] < 128
                                         for g in groups)}
    want_launch = {k: n for k, n in want_launch.items() if n}
    if not k1_cached:
        want_launch["build_tables"] = 1
    prevotes, precommits = sched.votes.prevotes(0), sched.votes.precommits(0)
    checks = {
        "rejected": rejected == planted_bad,
        "peer_counts": reporter.counts == want_counts,
        "lanes": lanes == want_lanes,
        "duplicates_burn_no_lane": not any(
            id(v) in dup_ids for b in batches[-1:] for v in b["votes"]),
        "shed": CONTROLLER.sheds.get(state.VOTE_BUF_QUEUE, 0) - shed0
        == VOTES_OVERFLOW,
        "equivocation": len(tally.evidence) == 1
        and tally.evidence[0].vote_a.validator_index == x.validator_index,
        "prevotes_maj23": prevotes.two_thirds_majority() == (block, True),
        "precommits_maj23": precommits.two_thirds_majority() == (block, True),
        "late_precommits": last_commit.votes_bit_array.count() == len(vs),
        "structured": all(g["form"] == "VoteSignBatch"
                          for g in groups if g["lanes"] >= 128),
        "launches": launches == want_launch,
        "nothing_refused": not tally.refused,
    }
    if not all(checks.values()):
        raise AssertionError(f"votes: {checks}, launches {launches} "
                             f"(want {want_launch}), refused {tally.refused}")
    verify_duplicate_vote(tally.evidence[0], CHAIN, vs, tally.ev_time)
    made = precommits.make_commit()
    vs.verify_commit(CHAIN, block, h, made)
    absent = sorted(i for i, cs in enumerate(made.signatures)
                    if cs.is_absent())
    want_absent = sorted(v.validator_index for v in forged + [retimed]
                         if v.type == VoteType.PRECOMMIT and v.round == 0)
    if absent != want_absent:
        raise AssertionError(f"make_commit's absent slots {absent}, "
                             f"want {want_absent}")
    ms = [b["ms"] for b in batches]
    by_size = sorted(groups, key=lambda g: g["lanes"])
    out = dict(
        validators=len(vs), height=h, config=dict(
            vote_batch_window_ms=cfg.vote_batch_window_ms,
            vote_batch_max=cfg.vote_batch_max, vote_buf_max=cfg.vote_buf_max),
        setup_s=setup_s, bursts=len(bursts), batches=len(batches),
        lanes=lanes, batch_lanes=[len(b["votes"]) for b in batches],
        groups=groups, largest_group=by_size[-1],
        launches=launches, k1_cached=k1_cached,
        rejected=sorted((int(v.type), v.validator_index, v.round)
                        for v in forged + [retimed]),
        peer_counts=reporter.counts, shed=VOTES_OVERFLOW,
        evidence=dict(validator=x.validator_index,
                      hash=tally.evidence[0].hash().hex()),
        commit_absent=absent, checks=checks,
        batch_verdicts_ms=ms, batch_verdicts_p50_ms=statistics.median(ms),
        tally_us_per_vote=tally.seconds / tally.calls * 1e6,
        drained_first_enqueue_to_precommit_maj23_ms=(tally.maj23_at
                                                     - t_first) * 1e3)
    valid = [v for v in votes if id(v) not in planted_bad]
    out["paced"] = paced_votes(vs, valid, block, last_commit, cfg)
    out["mixed"] = mixed_vote_burst(mvs, mcommit, cfg)
    out["small"] = small_vote_burst(vs, sign, sched, cfg)
    out["main_run_launches"] = launches
    out["launches"] = dict(launches)
    for extra in (out["paced"], out["mixed"], out["small"]):
        for k, n in extra["launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + n
    largest = max(batches, key=lambda b: len(b["votes"]))["votes"]
    out["breakdown"], row, out["largest_batch_k3"] = vote_breakdown(
        vs, valid, largest, dev)
    return out, row


def paced_votes(vs, valid, block, last_commit, cfg) -> dict:
    """The paced run (VOTES_RATE): `valid`, the height's votes less the
    planted bad ones, to a fresh HeightVoteSet; counters zeroed just
    before and read just after. Every vote tallied or shed (none is at
    this rate on the H100's host), +2/3 prevotes and precommits for the
    block, and K3 for each batch of 128 lanes or more and K4 for each of
    40-127. Returns the time from the
    first enqueue to +2/3 precommits, and from the arrival of the burst
    that completes them."""
    import asyncio

    import numpy as np

    from tendermint_tpu_torch.consensus import state
    from tendermint_tpu_torch.consensus.cstypes import HeightVoteSet
    from tendermint_tpu_torch.libs.overload import CONTROLLER
    from tendermint_tpu_torch.types.vote import VoteType

    rng = np.random.default_rng(14)
    order = [valid[i] for i in rng.permutation(len(valid))]
    bursts = []
    while order:
        size = int(rng.integers(VOTES_BURST[0], VOTES_BURST[1] + 1))
        bursts.append([(v, f"peer-{int(rng.integers(VOTES_PEERS))}")
                       for v in order[:size]])
        order = order[size:]
    # the burst whose arrival takes the block's round-0 precommits past
    # 2/3 of the power
    total, power, completes = vs.total_voting_power(), 0, None
    for k, b in enumerate(bursts):
        power += sum(vs.validators[v.validator_index].voting_power
                     for v, _ in b if v.type == VoteType.PRECOMMIT
                     and v.round == 0 and v.block_id == block)
        if completes is None and 3 * power > 2 * total:
            completes = k
    h = valid[0].height
    tally = VoteTally(ev_time=0)
    sched = state.VoteScheduler(cfg, CHAIN, tally)
    tally.sched = sched
    sched.new_height(h, vs, HeightVoteSet(CHAIN, h, vs), last_commit)
    sizes = []
    real_bv = state.batch_verdicts

    def spy(batch, chain_id):
        sizes.append(len(batch))
        return real_bv(batch, chain_id)

    shed0 = CONTROLLER.sheds.get(state.VOTE_BUF_QUEUE, 0)
    kernels = wrappers()
    state.batch_verdicts = spy
    try:
        for fn in kernels.values():
            fn.launches = 0
        t0, at, done = asyncio.run(vote_run(sched, bursts, VOTES_RATE))
        launches = {k: f.launches for k, f in kernels.items() if f.launches}
    finally:
        state.batch_verdicts = real_bv
    want_launch = {"xverify": sum(n >= 128 for n in sizes),
                   "general_verify": sum(40 <= n < 128 for n in sizes)}
    shed = CONTROLLER.sheds.get(state.VOTE_BUF_QUEUE, 0) - shed0
    checks = {
        "tallied": tally.calls + shed == len(valid) and not tally.refused,
        "prevotes_maj23": sched.votes.prevotes(0).two_thirds_majority()
        == (block, True),
        "precommits_maj23": sched.votes.precommits(0).two_thirds_majority()
        == (block, True),
        "launches": launches == {k: n for k, n in want_launch.items() if n},
    }
    if not all(checks.values()):
        raise AssertionError(f"paced votes: {checks}, {tally.calls} of "
                             f"{len(valid)} tallied, shed {shed}, launches "
                             f"{launches} (want {want_launch})")
    return dict(
        rate_votes_per_s=VOTES_RATE, votes=len(valid), shed=shed,
        bursts=len(bursts),
        arrival_span_ms=(at[-1] - t0) * 1e3, batches=len(sizes),
        batch_lanes=sizes, batch_lanes_p50=statistics.median(sizes),
        launches=launches, checks=checks,
        first_enqueue_to_precommit_maj23_ms=(tally.maj23_at - t0) * 1e3,
        completing_burst=completes,
        completing_burst_arrival_ms=(at[completes] - t0) * 1e3,
        precommit_maj23_after_arrival_ms=(tally.maj23_at - at[completes])
        * 1e3,
        drained_ms=(done - t0) * 1e3,
        tally_us_per_vote=tally.seconds / tally.calls * 1e6)


def burst_run(sched, burst):
    """One burst through a fresh scheduler's run, counters zeroed just
    before and read just after; returns the launches and the batches'
    verdicts with their votes."""
    import asyncio

    from tendermint_tpu_torch.consensus import state

    seen = []
    real_bv = state.batch_verdicts

    def spy(batch, chain_id):
        out = real_bv(batch, chain_id)
        seen.append(([e[0] for e in batch], out.copy()))
        return out

    kernels = wrappers()
    state.batch_verdicts = spy
    try:
        for fn in kernels.values():
            fn.launches = 0
        asyncio.run(vote_run(sched, [burst]))
        launches = {k: f.launches for k, f in kernels.items() if f.launches}
    finally:
        state.batch_verdicts = real_bv
    return launches, seen


def mixed_vote_burst(mvs, mcommit, cfg) -> dict:
    """One VOTES_MIXED-vote burst of the mixed set's precommits (key i
    sr25519 for odd i), one ed25519 and one sr25519 signature broken:
    a batch of vote_batch_max, flushed at once, through BatchVerifier
    (K4 for the ed25519 lanes, K9 for the sr25519 ones), with the host
    oracle's verdicts."""
    from tendermint_tpu_torch.consensus import state
    from tendermint_tpu_torch.consensus.cstypes import HeightVoteSet
    from tendermint_tpu_torch.types.validator_set import ValidatorSet
    from tendermint_tpu_torch.types.vote import MAX_VOTES_COUNT

    mvs = ValidatorSet(mvs.validators[:MAX_VOTES_COUNT])  # the same order
    votes = commit_votes(mcommit)[:VOTES_MIXED]
    bad = {}
    for kind in ("ed25519", "sr25519"):
        i = next(i for i in range(VOTES_MIXED // 3, VOTES_MIXED)
                 if mvs.validators[i].pub_key.type_name == kind)
        v = votes[i]
        v.signature = v.signature[:30] + bytes([v.signature[30] ^ 1]) + \
            v.signature[31:]
        bad[kind] = i
    tally = VoteTally(ev_time=0)
    sched = state.VoteScheduler(cfg, CHAIN, tally)
    tally.sched = sched
    sched.new_height(mcommit.height, mvs,
                     HeightVoteSet(CHAIN, mcommit.height, mvs))
    t0 = time.perf_counter()
    launches, seen = burst_run(sched, [(v, "peer-mixed") for v in votes])
    ms = (time.perf_counter() - t0) * 1e3
    oracle = [mvs.validators[v.validator_index].pub_key.verify_signature(
        v.sign_bytes(CHAIN), v.signature) for v in votes]
    got = [bool(ok) for b in seen for ok in b[1]]
    n_sr = sum(mvs.validators[v.validator_index].pub_key.type_name
               == "sr25519" for v in votes)
    tallied = sched.votes.precommits(0).votes_bit_array.count()
    if [len(b[0]) for b in seen] != [VOTES_MIXED] or got != oracle or \
            launches != {"general_verify": 1, "sr_verify": 1} or \
            tallied != VOTES_MIXED - 2:
        raise AssertionError(f"mixed burst: batches {[len(b[0]) for b in seen]}, "
                             f"launches {launches}, tallied {tallied}")
    return dict(votes=VOTES_MIXED, sr25519_lanes=n_sr,
                ed25519_lanes=VOTES_MIXED - n_sr, rejected=bad,
                launches=launches, ms=ms, oracle_equal=True)


def small_vote_burst(vs, sign, sched, cfg) -> dict:
    """VOTES_SMALL round-1 prevotes in one burst: under _EXPAND_MIN,
    so the batch takes the bytes route, one K4 launch."""
    from tendermint_tpu_torch.consensus import state
    from tendermint_tpu_torch.types.vote import VoteType

    votes = [sign(i, VoteType.PREVOTE, 1) for i in range(VOTES_SMALL)]
    tally = VoteTally(ev_time=0)
    small = state.VoteScheduler(cfg, CHAIN, tally)
    tally.sched = small
    small.new_height(sched.height, sched.validators, sched.votes,
                     sched.last_commit)
    launches, seen = burst_run(small, [(v, "peer-small") for v in votes])
    tallied = sched.votes.prevotes(1).votes_bit_array.count()
    if launches != {"general_verify": 1} or tallied != VOTES_SMALL or \
            [len(b[0]) for b in seen] != [VOTES_SMALL]:
        raise AssertionError(f"small burst: launches {launches}, "
                             f"tallied {tallied}")
    return dict(votes=VOTES_SMALL, launches=launches)


def vote_breakdown(vs, valid, largest, dev, reps: int = 5):
    """Outside the counted run: median ms of batch_verdicts' stages on a
    vote_batch_max batch of valid votes (prevotes, precommits and nil
    precommits: three template groups): the VoteSignBatch build,
    _prepare_structured, the structured launch with its uploads,
    synchronized, and the verdicts' readback; K3 at that shape (the
    xverify_votes row), and K3 on the largest batch of the run against
    its plain version."""
    import torch

    from tendermint_tpu_torch.config import ConsensusConfig
    from tendermint_tpu_torch.crypto.cuda import expanded, kernels
    from tendermint_tpu_torch.types.sign_batch import VoteSignBatch
    from tendermint_tpu_torch.types.vote import VoteType

    n = ConsensusConfig().vote_batch_max
    nil = [v for v in valid if v.block_id is None]
    pre = [v for v in valid if v.type == VoteType.PREVOTE]
    com = [v for v in valid if v.type == VoteType.PRECOMMIT and v.block_id]
    sel = nil + pre[:(n - len(nil)) // 2]
    sel += com[:n - len(sel)]
    exp = expanded.get_expanded([v.pub_key.bytes() for v in vs.validators])
    lanes = [v.validator_index for v in sel]
    sigs = [v.signature for v in sel]
    stages = {k: [] for k in ("vote_sign_batch", "prepare_structured",
                              "launch", "readback")}
    for _ in range(reps):
        t0 = time.perf_counter()
        sb = VoteSignBatch(CHAIN, sel)
        t1 = time.perf_counter()
        idx, fields, _wf, width = exp._prepare_structured(lanes, sb, sigs)
        t2 = time.perf_counter()
        out = exp._launch_structured(idx, fields, width)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        verdicts = kernels.readback(out)
        t4 = time.perf_counter()
        for k, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            stages[k].append(dt * 1e3)
        if not verdicts[:len(sel)].all():
            raise AssertionError("the breakdown's batch did not verify")
    row, _ = k3_row("xverify_votes", exp, lanes, sb, sigs, dev)
    big, _ = k3_row("xverify_votes", exp,
                    [v.validator_index for v in largest],
                    VoteSignBatch(CHAIN, largest),
                    [v.signature for v in largest], dev)
    breakdown = {k + "_ms": statistics.median(v) for k, v in stages.items()}
    breakdown.update(lanes=len(sel), templates=int(sb.pre.shape[0]),
                     k3_ms=row["ms"])
    return breakdown, row, {k: big[k] for k in (
        "lanes", "real_lanes", "groups", "max_abs_err", "ms", "plain_ms",
        "bound_ms")}


# -- phase 11 ------------------------------------------------------------


def make_light_chain(n_vals: int, n_heights: int, rotate_every: int):
    """BASELINE.json config #2's light chain: heights 1 .. n_heights of
    n_vals ed25519 validators of equal power, a sixth of them rotating
    out (and as many new ones in) every `rotate_every` heights; each
    header's commit signed by its whole set (OpenSSL where the host has
    it), each LightBlock made by the port's codec (encoded, then
    decoded). Returns {height: LightBlock}."""
    from tendermint_tpu_torch.crypto import ed25519
    from tendermint_tpu_torch.light.types import LightBlock, SignedHeader
    from tendermint_tpu_torch.types.block import (
        BlockID, BlockIDFlag, Commit, CommitSig, Header, PartSetHeader)
    from tendermint_tpu_torch.types.validator import Validator
    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    step = n_vals // 6
    epochs = n_heights // rotate_every + 1
    keys = [ed25519.Ed25519PrivKey(hashlib.sha256(b"light-val-%d" % i)
                                   .digest())
            for i in range(n_vals + step * epochs)]
    key_of = {k.pub_key().bytes(): k for k in keys}
    sets = [ValidatorSet([Validator.new(k.pub_key(), 10)
                          for k in keys[e * step:e * step + n_vals]])
            for e in range(epochs + 1)]

    def valset(h):
        return sets[(h - 1) // rotate_every]

    blocks, prev = {}, None
    for h in range(1, n_heights + 1):
        vals = valset(h)
        t = LIGHT_T0 + h * 1_000_000_000
        header = Header(
            version_block=11, version_app=1, chain_id=CHAIN, height=h,
            time=t, last_block_id=prev,
            last_commit_hash=hashlib.sha256(b"lc-%d" % h).digest(),
            data_hash=hashlib.sha256(b"data-%d" % h).digest(),
            validators_hash=vals.hash(),
            next_validators_hash=valset(h + 1).hash(),
            consensus_hash=b"\x03" * 32,
            app_hash=hashlib.sha256(b"app-%d" % h).digest(),
            last_results_hash=b"\x05" * 32, evidence_hash=b"\x06" * 32,
            proposer_address=vals.proposer.address)
        bid = BlockID(header.hash(), PartSetHeader(1, hashlib.sha256(
            b"parts-%d" % h).digest()))
        sigs = [CommitSig(BlockIDFlag.COMMIT, v.address, t + 1 + i, b"")
                for i, v in enumerate(vals.validators)]
        commit = Commit(h, 0, bid, sigs)
        for i, v in enumerate(vals.validators):
            sigs[i].signature = key_of[v.pub_key.bytes()].sign(
                commit.vote_sign_bytes(CHAIN, i))
        lb = LightBlock(SignedHeader(header, commit), vals)
        blocks[h] = LightBlock.from_bytes(lb.to_proto().finish())
        prev = bid
    return blocks


def forged_light_block(lb, slot: int):
    """lb with one commit signature bit-flipped (a lying provider)."""
    from tendermint_tpu_torch.light.types import LightBlock, SignedHeader
    from tendermint_tpu_torch.types.block import Commit, CommitSig

    c = lb.signed_header.commit
    sigs = [CommitSig(cs.block_id_flag, cs.validator_address, cs.timestamp,
                      cs.signature[:8] + bytes([cs.signature[8] ^ 1])
                      + cs.signature[9:] if i == slot else cs.signature)
            for i, cs in enumerate(c.signatures)]
    return LightBlock(SignedHeader(lb.signed_header.header,
                                   Commit(c.height, c.round, c.block_id, sigs)),
                      lb.validator_set)


def light_outcome(fn):
    try:
        fn()
        return None
    except Exception as e:  # noqa: BLE001 - the outcome is checked
        return (type(e).__name__, str(e))


def light_phase(dev):
    """The light client's verify layer on BASELINE.json config #2
    (docstring, phase 11). Returns the phase's record and the K4 rows
    at the light shapes."""
    import asyncio
    from fractions import Fraction

    from tendermint_tpu_torch.config import LightConfig
    from tendermint_tpu_torch.light import serving, verifier

    t0 = time.perf_counter()
    b = make_light_chain(LIGHT_VALIDATORS, LIGHT_HEIGHTS, LIGHT_ROTATE)
    setup_s = time.perf_counter() - t0
    top = LIGHT_HEIGHTS
    now = b[top].time() + 1_000_000_000
    sh = b[2].signed_header
    light_plan = b[2].validator_set.plan_commit_light(
        CHAIN, sh.commit.block_id, 2, sh.commit)
    trusting_plan = b[1].validator_set.plan_commit_trusting(
        CHAIN, b[top].signed_header.commit, 1, 3)
    quorum = 2 * LIGHT_VALIDATORS // 3 + 1
    if (len(light_plan), len(trusting_plan)) != (quorum,
                                                 LIGHT_VALIDATORS // 3 + 1):
        raise AssertionError(f"plans of {len(light_plan)} and "
                             f"{len(trusting_plan)} lanes")
    forged = forged_light_block(b[LIGHT_ROTATE + 1], 5)
    # validators of height 1's set still in the top height's
    overlap = LIGHT_VALIDATORS - (top - 1) // LIGHT_ROTATE * (
        LIGHT_VALIDATORS // 6)
    faults = {
        "forged_target": (b[LIGHT_ROTATE], forged, LIGHT_PERIOD_NS, now,
                          verifier.DEFAULT_TRUST_LEVEL),
        "expired_trusted": (b[1], b[top], b[top].time() - b[1].time(),
                            b[top].time(), verifier.DEFAULT_TRUST_LEVEL),
        "under_trusted_skip": (b[1], b[top], LIGHT_PERIOD_NS, now,
                               Fraction(2, 3)),
    }
    want = {
        "forged_target": ("VerificationFailedError", "invalid commit: "
                          "invalid signature(s) at index(es) [5]"),
        "expired_trusted": ("OutsideTrustingPeriodError",
                            f"trusted header from {b[1].time()} expired"),
        "under_trusted_skip": ("NewValSetCantBeTrustedError",
                               "insufficient trusted power: "
                               f"{10 * overlap}"),
    }
    cfg = LightConfig()
    coll = serving.LightVerifyCollector(
        batch_max=cfg.batch_max, flush_ms=cfg.flush_ms,
        pending_max=cfg.pending_max)
    flushes = []
    real_jobs = coll._verify_jobs

    def timed_jobs(plans):
        t1 = time.perf_counter()
        out = real_jobs(plans)
        flushes.append(dict(ms=(time.perf_counter() - t1) * 1e3,
                            lanes=sum(len(p) for p in plans), plans=plans,
                            ok=all(v.all() for v in out)))
        return out

    coll._verify_jobs = timed_jobs
    requests = [(b[1 + i % 8], b[10 + (i * 7) % (top - 9)])
                for i in range(LIGHT_REQUESTS)]

    async def pooled():
        try:
            res = await asyncio.gather(
                *(serving.verify_through(coll, CHAIN, t, u, LIGHT_PERIOD_NS,
                                         now) for t, u in requests),
                *(serving.verify_through(coll, CHAIN, *args)
                  for args in faults.values()),
                return_exceptions=True)
        finally:
            coll.close()
        return [None if r is None else (type(r).__name__, str(r))
                for r in res]

    kernels = wrappers()
    metrics0 = metrics_view("light")["verify_launches"]
    for fn in kernels.values():
        fn.launches = 0
    adjacent_ms, skip_ms = [], []
    for h in range(1, top):
        t1 = time.perf_counter()
        verifier.verify_adjacent(CHAIN, b[h], b[h + 1], LIGHT_PERIOD_NS, now)
        adjacent_ms.append((time.perf_counter() - t1) * 1e3)
    for target in (top // 4, top // 2, top):
        t1 = time.perf_counter()
        verifier.verify_non_adjacent(CHAIN, b[1], b[target],
                                     LIGHT_PERIOD_NS, now)
        skip_ms.append((time.perf_counter() - t1) * 1e3)
    verified = {name: light_outcome(lambda: verifier.verify(CHAIN, *args))
                for name, args in faults.items()}
    direct = {k: f.launches for k, f in kernels.items() if f.launches}
    t1 = time.perf_counter()
    pooled_res = asyncio.run(pooled())
    pooled_s = time.perf_counter() - t1
    launches = {k: f.launches for k, f in kernels.items() if f.launches}
    coll_launches = {k: launches[k] - direct.get(k, 0) for k in launches}
    metrics = {k: n - metrics0.get(k, 0)
               for k, n in metrics_view("light")["verify_launches"].items()
               if n != metrics0.get(k, 0)}
    lanes = [f["lanes"] for f in flushes]
    pooled_faults = dict(zip(faults, pooled_res[LIGHT_REQUESTS:]))
    checks = {
        "requests_verified": pooled_res[:LIGHT_REQUESTS]
        == [None] * LIGHT_REQUESTS,
        "faults_verifier": verified == want,
        "faults_pooled": pooled_faults == want,
        "direct_launches": direct == {"general_verify": top - 1 + 2 * 3 + 1},
        "collector_launches": coll_launches == {
            "general_verify": len(flushes)},
        "metrics": metrics == {"device": len(flushes)},
        "lanes": sum(lanes) == LIGHT_REQUESTS * (len(light_plan) + len(
            trusting_plan)) + len(light_plan),
        "flush_size": all(n >= cfg.batch_max for n in lanes[:-1]),
    }
    if not all(checks.values()):
        raise AssertionError(f"light: {checks}, verified {verified}, pooled "
                             f"{pooled_faults}, direct {direct}, collector "
                             f"{coll_launches}, metrics {metrics}, lanes "
                             f"{lanes}")
    rows = [light_k4_row("general_verify_light_commit",
                         light_plan.triples(), dev)]
    widest = max((f for f in flushes if f["ok"]), key=lambda f: f["lanes"])
    rows.append(light_k4_row(
        "general_verify_light",
        [t for p in widest["plans"] for t in p.triples()], dev,
        sentinel=True))
    out = dict(validators=LIGHT_VALIDATORS, heights=LIGHT_HEIGHTS,
               rotate=dict(every=LIGHT_ROTATE, validators=LIGHT_VALIDATORS // 6),
               setup_s=setup_s, plan_lanes=dict(light=len(light_plan),
                                                trusting=len(trusting_plan)),
               verify_adjacent_ms=adjacent_ms,
               verify_adjacent_p50_ms=statistics.median(adjacent_ms),
               verify_non_adjacent_ms=skip_ms,
               verify_non_adjacent_p50_ms=statistics.median(skip_ms),
               faults=verified, pooled_faults=pooled_faults,
               requests=LIGHT_REQUESTS, pooled_s=pooled_s,
               config=dict(batch_max=cfg.batch_max, flush_ms=cfg.flush_ms,
                           pending_max=cfg.pending_max),
               flush_ms=[f["ms"] for f in flushes], flush_lanes=lanes,
               collector_metrics=metrics, direct_launches=direct,
               collector_launches=coll_launches, launches=launches,
               k4_collector_ms=rows[1]["ms"], checks=checks)
    return out, rows


def light_k4_row(name, triples, dev, sentinel=False):
    """K4 on a light launch's (pub_key, msg, sig) triples (the
    collector's with its known-answer sentinel lane last), packed as
    verify_batch packs them: one bucket, padded with the dummy
    triple."""
    from tendermint_tpu_torch.crypto import batch as cbatch
    from tendermint_tpu_torch.crypto.cuda import verify

    pubs = [pk.bytes() for pk, _, _ in triples]
    msgs = [m for _, m, _ in triples]
    sigs = [s for _, _, s in triples]
    if sentinel:
        spub, smsg, ssig = cbatch._ed_probe_triple()
        pubs, msgs, sigs = pubs + [spub], msgs + [smsg], sigs + [ssig]
    n = len(pubs)
    dp, dm, ds = verify._dummy_triple()
    pad = verify._chunks(n)[0] - n
    t = verify.to_device(verify.pack_batch(
        pubs + [dp] * pad, msgs + [dm] * pad, sigs + [ds] * pad), dev)
    return k4_row(name, (t["ab"], t["sb"], t["msg"], t["nblocks"],
                         t["s_ok"], verify._btab(dev)), n)


# -- phase 12 ------------------------------------------------------------


def sign_node_commit(vals, key_of, height: int, bid, ts: int):
    """Every validator of `vals` precommits `bid` at `height`, round 0,
    at time ts (OpenSSL where the host has it)."""
    from tendermint_tpu_torch.types.block import BlockIDFlag, Commit, CommitSig

    sigs = [CommitSig(BlockIDFlag.COMMIT, v.address, ts, b"")
            for v in vals.validators]
    commit = Commit(height, 0, bid, sigs)
    for i, v in enumerate(vals.validators):
        sigs[i].signature = key_of[v.pub_key.bytes()].sign(
            commit.vote_sign_bytes(CHAIN, i))
    return commit


def make_node_chain(n_vals: int, n_heights: int, rotate_every: int):
    """BASELINE.json config #2's chain committed into a node's stores
    (the port's state.Store and store.BlockStore over MemDB): heights 1
    .. n_heights of n_vals ed25519 validators of equal power, a sixth of
    them rotating out (and as many new ones in) every `rotate_every`
    heights; the genesis by GenesisDoc and make_genesis_state, each
    block by State.make_block (one tx, the previous commit), each commit
    signed by the height's whole set. Returns the state after the last
    block, the two stores and the signing key of each public key."""
    from tendermint_tpu_torch.crypto import ed25519
    from tendermint_tpu_torch.libs.db import MemDB
    from tendermint_tpu_torch.state import make_genesis_state
    from tendermint_tpu_torch.state.store import Store
    from tendermint_tpu_torch.store import BlockStore
    from tendermint_tpu_torch.types.block import BlockID
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from tendermint_tpu_torch.types.validator import Validator
    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    step = n_vals // 6
    epochs = n_heights // rotate_every + 1
    keys = [ed25519.Ed25519PrivKey(hashlib.sha256(b"light-val-%d" % i)
                                   .digest())
            for i in range(n_vals + step * epochs)]
    key_of = {k.pub_key().bytes(): k for k in keys}
    state = make_genesis_state(GenesisDoc(
        chain_id=CHAIN, genesis_time=LIGHT_T0,
        validators=[GenesisValidator(k.pub_key(), 10)
                    for k in keys[:n_vals]]))
    sets = [state.validators] + [
        ValidatorSet([Validator.new(k.pub_key(), 10)
                      for k in keys[e * step:e * step + n_vals]])
        for e in range(1, epochs + 1)]

    def valset(h):
        return sets[(h - 1) // rotate_every]

    state_store, block_store = Store(MemDB()), BlockStore(MemDB())
    commit = None
    for h in range(1, n_heights + 1):
        vals = valset(h)
        state.validators, state.next_validators = vals, valset(h + 1)
        t = LIGHT_T0 + h * 1_000_000_000
        block = state.make_block(h, [b"tx-%d" % h], commit, [],
                                 vals.get_proposer().address, t)
        parts = block.make_part_set()
        bid = BlockID(block.hash(), parts.header())
        commit = sign_node_commit(vals, key_of, h, bid, t + 1)
        block_store.save_block(block, parts, commit)
        state_store.save_validator_set(h, vals)
        state.last_block_height, state.last_block_id = h, bid
        state.last_block_time = t
    state_store.save(state)
    return state, state_store, block_store, key_of


def light_providers(block_store, state_store, key_of):
    """The phase's providers over a node's stores: the primary
    (reporting evidence into a recording sink), an honest witness, a
    witness forking from LC_FORK_FROM (each header from there up with
    another app hash, re-signed by its height's own set), and a primary
    whose head a caller moves (`cap`)."""
    import dataclasses

    from tendermint_tpu_torch.light.provider import (
        BlockNotFoundError, BlockStoreProvider, Provider)
    from tendermint_tpu_torch.light.types import LightBlock, SignedHeader
    from tendermint_tpu_torch.types.block import BlockID, PartSetHeader

    class EvidenceSink:
        def __init__(self):
            self.added = []

        def add_evidence(self, ev):
            self.added.append(ev)

    class Forking(Provider):
        def __init__(self, inner):
            self.inner, self.forged = inner, {}

        def provider_id(self) -> str:
            return "forking"

        async def light_block(self, height):
            lb = await self.inner.light_block(height)
            h = lb.height()
            if h < LC_FORK_FROM:
                return lb
            if h not in self.forged:
                hdr = dataclasses.replace(
                    lb.signed_header.header,
                    app_hash=hashlib.sha256(b"fork-%d" % h).digest())
                bid = BlockID(hdr.hash(), PartSetHeader(1, hashlib.sha256(
                    b"fork-parts-%d" % h).digest()))
                self.forged[h] = LightBlock(SignedHeader(
                    hdr, sign_node_commit(lb.validator_set, key_of, h, bid,
                                          hdr.time + 1)), lb.validator_set)
            return self.forged[h]

    class Head(Provider):
        def __init__(self, inner):
            self.inner, self.cap = inner, 1

        async def light_block(self, height):
            height = height or self.cap
            if height > self.cap:
                raise BlockNotFoundError(f"no light block at height {height}")
            return await self.inner.light_block(height)

    sink = EvidenceSink()
    primary = BlockStoreProvider(block_store, state_store, name="primary",
                                 evidence_pool=sink)
    honest = BlockStoreProvider(block_store, state_store, name="honest")
    return sink, primary, honest, Forking(honest), Head(primary)


def light_client_phase(dev):
    """The light client, its stores, the serving plane and evidence
    verification at BASELINE.json config #2's 150 validators (docstring,
    phase 12). Returns the phase's record and the K4 row of the plane's
    widest flush where its bucket is new (else none)."""
    import asyncio
    import dataclasses

    from tendermint_tpu_torch.config import LightConfig
    from tendermint_tpu_torch.crypto.cuda import verify as tv
    from tendermint_tpu_torch.evidence.verify import verify_evidence
    from tendermint_tpu_torch.libs.db import MemDB
    from tendermint_tpu_torch.light import client as client_mod
    from tendermint_tpu_torch.light import serving
    from tendermint_tpu_torch.light.client import Client, TrustOptions
    from tendermint_tpu_torch.light.errors import DivergenceError
    from tendermint_tpu_torch.light.store import LightStore
    from tendermint_tpu_torch.types import validator_set as vset_mod

    t0 = time.perf_counter()
    state, ss, bs, key_of = make_node_chain(LIGHT_VALIDATORS, LC_HEIGHTS,
                                            LIGHT_ROTATE)
    setup_s = time.perf_counter() - t0
    now = LIGHT_T0 + (LC_HEIGHTS + 1) * 1_000_000_000  # the fixed clock
    sink, primary, honest, forking, head = light_providers(bs, ss, key_of)
    trust = TrustOptions(LIGHT_PERIOD_NS, 1, bs.load_block_meta(1).block_id.hash)

    def new_client(prim, witnesses):
        return Client(CHAIN, trust, prim, witnesses, LightStore(MemDB()),
                      now_fn=lambda: now)

    # the trace: each verify step (its heights, kind, outcome, time and
    # the commit checks it ran) and each commit check run inline
    steps, plans = [], []
    real_verify = client_mod.verify
    real_execute = vset_mod.CommitVerifyPlan.execute

    def traced_verify(chain_id, trusted, block, *args):
        step = dict(trusted=trusted.height(), target=block.height(),
                    kind="adjacent" if block.height() == trusted.height() + 1
                    else "skip", outcome=None, first_plan=len(plans))
        t1 = time.perf_counter()
        try:
            real_verify(chain_id, trusted, block, *args)
        except Exception as e:
            step["outcome"] = type(e).__name__
            raise
        finally:
            step["ms"] = (time.perf_counter() - t1) * 1e3
            step["plans"] = plans[step.pop("first_plan"):]
            steps.append(step)

    def counted_execute(plan):
        plans.append(len(plan))
        return real_execute(plan)

    cfg = LightConfig()
    flushes, timed = [], {}

    async def drive():
        out = {}
        # 1. bisection to LC_TARGET, the forking witness proven
        cl1 = new_client(primary, [honest, forking])
        detect = cl1._detect_divergence

        async def timed_detect(verified, now_ns):
            t1 = time.perf_counter()
            try:
                await detect(verified, now_ns)
            finally:
                timed["detector_ms"] = (time.perf_counter() - t1) * 1e3

        cl1._detect_divergence = timed_detect
        t1 = time.perf_counter()
        try:
            await cl1.verify_light_block_at_height(LC_TARGET)
            out["divergence"] = None
        except DivergenceError as e:
            out["divergence"] = e
        timed["verify_target_ms"] = (time.perf_counter() - t1) * 1e3
        out["cl1"] = cl1
        out["cl1_steps"] = len(steps)
        # 2. the evidences against the node's stores
        div = out["divergence"]
        evs = list(div.evidence) if div is not None else []
        if evs:
            tip = await forking.light_block(LC_HEIGHTS)
            evs.append(dataclasses.replace(evs[0], conflicting_block=tip))
        out["evidence"], timed["verify_evidence_ms"] = [], []
        out["evidence_launches"] = []
        for ev in evs:
            k0 = tv.general_verify.launches
            t1 = time.perf_counter()
            out["evidence"].append(light_outcome(
                lambda: verify_evidence(ev, state, ss, bs)))
            timed["verify_evidence_ms"].append(
                (time.perf_counter() - t1) * 1e3)
            out["evidence_launches"].append(tv.general_verify.launches - k0)
        # 2b. the evidence against the witness through an evidence Pool
        # over the node's stores
        out["pool"] = evidence_pool_steps(evs, state, ss, bs) if evs else {}
        # 3. sequential updates, skipping verifications, a backwards walk
        cl2 = new_client(head, [honest])
        out["updates"], timed["update_ms"] = [], []
        for cap in range(2, 2 + LC_UPDATES):
            head.cap = cap
            t1 = time.perf_counter()
            lb = await cl2.update()
            timed["update_ms"].append((time.perf_counter() - t1) * 1e3)
            out["updates"].append(lb.height() if lb else None)
        head.cap = LC_HEIGHTS
        out["skips"], timed["skip_ms"] = [], []
        for target in range(LC_TARGET // 8, LC_TARGET + 1, LC_TARGET // 8):
            t1 = time.perf_counter()
            lb = await cl2.verify_light_block_at_height(target)
            timed["skip_ms"].append((time.perf_counter() - t1) * 1e3)
            out["skips"].append(lb.hash() ==
                                bs.load_block_meta(target).block_id.hash)
        n0, s0 = len(plans), len(steps)
        t1 = time.perf_counter()
        back = await cl2.verify_light_block_at_height(LC_TARGET - 7)
        timed["backwards_ms"] = (time.perf_counter() - t1) * 1e3
        out["backwards"] = (back.hash() == bs.load_block_meta(
            LC_TARGET - 7).block_id.hash, len(plans) - n0, len(steps) - s0)
        out["cl2"] = cl2
        # 4. the serving plane over a fresh client
        cl3 = new_client(primary, [honest])
        await cl3.initialize()
        plane = serving.ServingPlane(cl3, cfg)
        real_jobs = plane.collector._verify_jobs

        def timed_jobs(job_plans):
            t1 = time.perf_counter()
            res = real_jobs(job_plans)
            flushes.append(dict(ms=(time.perf_counter() - t1) * 1e3,
                                lanes=sum(len(p) for p in job_plans),
                                plans=job_plans,
                                ok=all(v.all() for v in res)))
            return res

        plane.collector._verify_jobs = timed_jobs
        gap = LC_TARGET // LC_PLANE_HEIGHTS
        heights = [gap * (1 + i % LC_PLANE_HEIGHTS)
                   for i in range(LC_REQUESTS)]
        out["active"] = serving.active_plane() is plane
        waves = []
        for wave in range(2):
            hits0 = plane.cache_hits
            t1 = time.perf_counter()
            res = await asyncio.gather(*(plane.get_verified(h)
                                         for h in heights))
            timed.setdefault("wave_ms", []).append(
                (time.perf_counter() - t1) * 1e3)
            waves.append(dict(
                ok=all(lb.hash() == bs.load_block_meta(h).block_id.hash
                       for lb, h in zip(res, heights)),
                cache_hits=plane.cache_hits - hits0))
        out["waves"] = waves
        out["plane"] = dict(requests=plane.requests,
                            coalesced=plane.coalesced,
                            cache_hits=plane.cache_hits,
                            cache_misses=plane.cache_misses,
                            sheds=dict(plane.sheds))
        out["status"] = plane.status_check()
        plane.close()
        out["closed"] = serving.active_plane() is None
        return out

    kernels = wrappers()
    metrics0 = metrics_view("light")["verify_launches"]
    client_mod.verify = traced_verify
    vset_mod.CommitVerifyPlan.execute = counted_execute
    try:
        for fn in kernels.values():
            fn.launches = 0
        t1 = time.perf_counter()
        res = asyncio.run(drive())
        run_s = time.perf_counter() - t1
        launches = {k: f.launches for k, f in kernels.items() if f.launches}
    finally:
        client_mod.verify = real_verify
        vset_mod.CommitVerifyPlan.execute = real_execute
    metrics = {k: n - metrics0.get(k, 0)
               for k, n in metrics_view("light")["verify_launches"].items()
               if n != metrics0.get(k, 0)}
    div = res["divergence"]
    evs = div.evidence if div is not None else []
    common = evs[0].common_height if evs else None
    cl1_steps = steps[:res["cl1_steps"]]
    # what the checks imply: an adjacent step one +2/3 check, a skip two
    # (the 1/3 trusting check, then the +2/3), a skip refused for want of
    # trusted power none (refused while planning); one +2/3 check a
    # client's initialize (three clients), one trusting check for the
    # evidence against the witness by verify_evidence and one by the
    # evidence pool; a plane flush one launch
    # and one more for the evidence the pool verifies
    implied = 3 + 1 + 1 + sum((1 if st["kind"] == "adjacent" else 2)
                              for st in steps if st["outcome"] is None)
    flush_plans = [len(p) for f in flushes for p in f["plans"]]
    quorum, third = 2 * LIGHT_VALIDATORS // 3 + 1, LIGHT_VALIDATORS // 3 + 1
    shapes: dict = {}
    for n in plans:
        key = f"{tv._chunks(n)[0]} lanes, {n} live"
        shapes[key] = shapes.get(key, 0) + 1
    for f in flushes:
        key = f"{tv._chunks(f['lanes'] + 1)[0]} lanes, flush"
        shapes[key] = shapes.get(key, 0) + 1
    want_evidence = [
        None,
        ("EvidenceError", "conflicting block matches the committed chain"),
        ("EvidenceError", f"no committed header+commit at conflicting height "
                          f"{LC_HEIGHTS} (commit lands with block "
                          f"{LC_HEIGHTS + 1})")]
    checks = {
        "divergence": div is not None and len(evs) == 2,
        "fork_common": common is not None and common < LC_FORK_FROM
        and all(ev.common_height == common for ev in evs)
        and evs[0].conflicting_block.hash() != evs[1].conflicting_block.hash()
        and evs[1].conflicting_block.hash() == bs.load_block_meta(
            LC_TARGET).block_id.hash,
        "bisected": sum(st["outcome"] == "NewValSetCantBeTrustedError"
                        for st in cl1_steps) > 0,
        "store_purged": common is not None and max(
            res["cl1"].store.heights()) <= common,
        "reported": [e.hash() for e in sink.added] == [evs[0].hash()]
        if evs else False,
        "witnesses_kept": len(res["cl1"].witnesses) == 2,
        "evidence": res["evidence"] == want_evidence
        and res["evidence_launches"] == [1, 0, 0],
        "pool": res["pool"].get("checks") == {
            "add_launches": res["evidence_launches"][0],
            "pending": True, "check_block": (None, 0),
            "duplicate_in_block": (("EvidenceError",
                                    "duplicate evidence in block"), 0),
            "readd": (0, 1), "refilled": True,
            "update": (True, False, False, 0), "after_update": (0, True)},
        "updates": res["updates"] == list(range(2, 2 + LC_UPDATES)),
        "skips": all(res["skips"]) and len(res["skips"]) == 8,
        "backwards": res["backwards"] == (True, 0, 0),
        "no_divergence": res["cl2"].witnesses == [honest],
        "waves": [w["ok"] for w in res["waves"]] == [True, True]
        and [w["cache_hits"] for w in res["waves"]] == [0, LC_REQUESTS],
        "plane": res["plane"]["requests"] == 2 * LC_REQUESTS
        and res["plane"]["coalesced"] >= LC_REQUESTS - LC_PLANE_HEIGHTS
        and res["plane"]["cache_hits"] == LC_REQUESTS
        and not any(res["plane"]["sheds"].values()),
        "status": res["status"]["status"] == "ok" and res["active"]
        and res["closed"],
        "plan_lanes": set(plans + flush_plans) <= {quorum, third},
        "launches": launches == {"general_verify": len(plans) + len(flushes)},
        "implied": len(plans) == implied,
        "flushes_device": metrics == {"device": len(flushes)}
        and all(f["ok"] for f in flushes),
    }
    if not all(checks.values()):
        raise AssertionError(f"light_client: {checks}, launches {launches}, "
                             f"plans {len(plans)} implied {implied}, "
                             f"flushes {[f['lanes'] for f in flushes]}, "
                             f"evidence {res['evidence']}, updates "
                             f"{res['updates']}, plane {res['plane']}, "
                             f"status {res['status']}")
    rows = []
    known = {128, 2048, 8192}
    new = [f for f in flushes if tv._chunks(f["lanes"] + 1)[0] not in known]
    if new:
        widest = max(new, key=lambda f: f["lanes"])
        rows.append(light_k4_row(
            "general_verify_light_client",
            [t for p in widest["plans"] for t in p.triples()], dev,
            sentinel=True))

    def p50(xs):
        return statistics.median(xs) if xs else None

    ok_skip = [st["ms"] for st in steps
               if st["kind"] == "skip" and st["outcome"] is None]
    refused = [st["ms"] for st in steps if st["outcome"] is not None]
    adjacent = [st["ms"] for st in steps if st["kind"] == "adjacent"]
    out = dict(
        validators=LIGHT_VALIDATORS, heights=LC_HEIGHTS, target=LC_TARGET,
        fork_from=LC_FORK_FROM,
        rotate=dict(every=LIGHT_ROTATE, validators=LIGHT_VALIDATORS // 6),
        setup_s=setup_s, run_s=run_s,
        trace=[(st["trusted"], st["target"], st["outcome"]) for st in
               cl1_steps],
        common_height=common, evidence=res["evidence"],
        skipping_verification_p50_ms=p50(timed["skip_ms"]),
        skipping_verification_ms=timed["skip_ms"],
        bisection_step_p50_ms=p50([st["ms"] for st in steps]),
        step_p50_ms=dict(skip=p50(ok_skip), refused=p50(refused),
                         adjacent=p50(adjacent)),
        update_p50_ms=p50(timed["update_ms"]),
        verify_target_ms=timed["verify_target_ms"],
        detector_ms=timed["detector_ms"],
        verify_evidence_ms=timed["verify_evidence_ms"],
        evidence_pool={k: v for k, v in res["pool"].items() if k != "checks"},
        backwards_ms=timed["backwards_ms"],
        wave_ms=timed["wave_ms"], plane=res["plane"],
        config=dict(batch_max=cfg.batch_max, flush_ms=cfg.flush_ms,
                    pending_max=cfg.pending_max),
        flushes=[dict(ms=f["ms"], lanes=f["lanes"], plans=len(f["plans"]))
                 for f in flushes],
        plans=len(plans), implied=implied, launch_shapes=shapes,
        collector_metrics=metrics, launches=launches, checks=checks)
    return out, rows


def evidence_pool_steps(evs, state, ss, bs) -> dict:
    """The light_client phase's evidence through an evidence Pool over
    the node's stores: the evidence against the witness added from a
    peer (verified, launching K4 as verify_evidence does), then pending,
    checked in a block that holds it (pending: no launch), twice in one
    block (raises), added again (a no-op), refilled by a second Pool
    over the same DB; the tip evidence added as consensus saw it, then
    update() at a state past both evidence max ages commits the first
    and prunes the second, and a third Pool finds nothing pending."""
    from tendermint_tpu_torch.crypto.cuda import verify as tv
    from tendermint_tpu_torch.evidence import Pool
    from tendermint_tpu_torch.libs.db import MemDB

    ev, tip = evs[0], evs[2]
    db = MemDB()
    pool = Pool(db, ss, bs)

    def counted(fn):
        k0 = tv.general_verify.launches
        return fn(), tv.general_verify.launches - k0

    t1 = time.perf_counter()
    _, add_launches = counted(lambda: pool.add_evidence(ev))
    add_ms = (time.perf_counter() - t1) * 1e3
    pending = [e.hash() for e in pool.pending_evidence(-1)] == [ev.hash()]
    check_block = counted(lambda: light_outcome(
        lambda: pool.check_evidence([ev])))
    duplicate = counted(lambda: light_outcome(
        lambda: pool.check_evidence([ev, ev])))
    _, readd = counted(lambda: pool.add_evidence(ev))
    readd = (readd, pool.size())
    refilled = [e.hash() for e in Pool(db, ss, bs).evidence_list] == [
        ev.hash()]
    pool.add_evidence_from_consensus(tip)
    later = state.copy()
    p = later.consensus_params.evidence
    later.last_block_height = tip.height() + p.max_age_num_blocks + 1
    later.last_block_time = tip.timestamp + p.max_age_duration_ns + 1
    t1 = time.perf_counter()
    pool.update(later, [ev])
    update_ms = (time.perf_counter() - t1) * 1e3
    third = Pool(db, ss, bs)
    return dict(add_ms=add_ms, update_ms=update_ms, checks=dict(
        add_launches=add_launches, pending=pending, check_block=check_block,
        duplicate_in_block=duplicate, readd=readd,
        refilled=refilled,
        update=(pool.is_committed(ev), pool.is_pending(ev),
                pool.is_pending(tip), pool.size()),
        after_update=(third.size(), third.is_committed(ev))))


# -- phase 13: admission ---------------------------------------------------


def adm_payload(tag: bytes, i: int, rng) -> bytes:
    """A unique kvstore tx `key=value` of 100-200 bytes."""
    key = b"%s%06d" % (tag, i)
    size = int(rng.integers(100, 201))
    return key + b"=" + rng.bytes(size).hex().encode()[:size - len(key) - 1]


def adm_signers(n: int):
    from tendermint_tpu_torch.crypto.ed25519 import Ed25519PrivKey

    return [Ed25519PrivKey(hashlib.sha256(b"adm-signer-%d" % i).digest())
            for i in range(n)]


def adm_mixed_txs(n: int, signers) -> tuple[list[bytes], list[str]]:
    """The reference e2e overload mix (e2e/runner.py envelope_mix_tx) over
    n unique payloads: each tx and its kind (garbage, valid, raw)."""
    import numpy as np

    from tendermint_tpu_torch.types import tx_envelope

    rng = np.random.default_rng(1401)
    txs, kinds = [], []
    for i in range(n):
        payload, key = adm_payload(b"m", i, rng), signers[i % len(signers)]
        slot = i % 100
        if slot < ADM_MIX[0]:
            txs.append(tx_envelope.encode(key.pub_key().bytes(), bytes(64),
                                          payload))
            kinds.append("garbage")
        elif slot < ADM_MIX[1]:
            txs.append(tx_envelope.sign_tx(key, payload))
            kinds.append("valid")
        else:
            txs.append(payload)
            kinds.append("raw")
    return txs, kinds


def adm_strict_txs(n: int, n_bad: int, signers):
    """A signed-only chain's traffic: n valid envelopes with n_bad
    unsigned and n_bad malformed (MAGIC + a payload) txs spread evenly
    among them."""
    import numpy as np

    from tendermint_tpu_torch.types import tx_envelope

    rng = np.random.default_rng(1402)
    txs = [tx_envelope.sign_tx(signers[i % len(signers)],
                               adm_payload(b"s", i, rng)) for i in range(n)]
    kinds = ["valid"] * n
    every = n // (2 * n_bad)
    for j in range(2 * n_bad):
        bad = adm_payload(b"u" if j % 2 == 0 else b"x", j, rng)
        at = (j + 1) * every + j
        txs.insert(at, bad if j % 2 == 0 else tx_envelope.MAGIC + bad)
        kinds.insert(at, "unsigned" if j % 2 == 0 else "malformed")
    return txs, kinds


def adm_probe_txs(signers, wide: int):
    """ADM_PROBE_SMALL small valid envelopes and one whose whole envelope
    is `wide` bytes."""
    import numpy as np

    from tendermint_tpu_torch.types import tx_envelope

    rng = np.random.default_rng(1403 + wide)
    txs = [tx_envelope.sign_tx(signers[i % len(signers)],
                               adm_payload(b"p%d-" % wide, i, rng))
           for i in range(ADM_PROBE_SMALL)]
    key = b"wide%d=" % wide
    body = key + rng.bytes(wide).hex().encode()
    # the envelope's fields cost their tags and lengths (a varint that
    # shrinks with the body): trim the body until the whole envelope is
    # exactly `wide` bytes
    while (over := len(tx_envelope.encode(bytes(32), bytes(64), body))
           - wide) != 0:
        body = body[:len(body) - over] if over > 0 else body + b"0" * -over
    big = tx_envelope.sign_tx(signers[-1], body)
    if len(big) != wide:
        raise AssertionError(f"probe envelope {len(big)} B, not {wide}")
    return txs + [big]


def oracle_chunk(triples):
    """The collector's own host oracle on (pub_key, signature, payload)
    triples, in a worker process."""
    from tendermint_tpu_torch.mempool.admission import AdmissionCollector
    from tendermint_tpu_torch.types.tx_envelope import TxEnvelope

    return AdmissionCollector._host_verify(
        [TxEnvelope(*t) for t in triples]).tolist()


def host_oracle(envs) -> list[bool]:
    """AdmissionCollector._host_verify over `envs`, split over
    ADM_ORACLE_WORKERS spawned processes (a garbage signature costs the
    pure-Python ZIP-215 recheck, milliseconds each)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    triples = [(e.pub_key, e.signature, e.payload) for e in envs]
    step = -(-len(triples) // (4 * ADM_ORACLE_WORKERS)) or 1
    chunks = [triples[i:i + step] for i in range(0, len(triples), step)]
    with ProcessPoolExecutor(ADM_ORACLE_WORKERS, mp_context=multiprocessing
                             .get_context("spawn")) as ex:
        return [v for part in ex.map(oracle_chunk, chunks) for v in part]


class AdmissionStack:
    """One node's tx path: a PersistentKVStoreApp that records its
    CheckTx calls, AppConns over LocalClients, a CListMempool at
    MempoolConfig's defaults (admission `mode`), a state Store for the
    ABCI responses, and the proposer's cycle over the consensus
    connection. The collector's flushes and verdict latencies are
    recorded."""

    def __init__(self, mode: str):
        from tendermint_tpu_torch.abci import kvstore
        from tendermint_tpu_torch.abci.client import ClientCreator
        from tendermint_tpu_torch.config import MempoolConfig
        from tendermint_tpu_torch.crypto.cuda import verify as tv
        from tendermint_tpu_torch.libs.db import MemDB
        from tendermint_tpu_torch.mempool.clist_mempool import CListMempool
        from tendermint_tpu_torch.proxy import AppConns
        from tendermint_tpu_torch.state.store import Store
        from tendermint_tpu_torch.types.params import ConsensusParams

        class App(kvstore.PersistentKVStoreApp):
            def __init__(self, db):
                super().__init__(db)
                self.checked, self.rechecks = [], 0

            def check_tx(self, req):
                if req.type == 0:
                    self.checked.append(req.tx)
                else:
                    self.rechecks += 1
                return super().check_tx(req)

        self.app = App(MemDB())
        self.conns = AppConns(ClientCreator(app=self.app))
        self.pool = CListMempool(MempoolConfig(admission=mode),
                                 self.conns.mempool)
        self.store = Store(MemDB())
        self.params = ConsensusParams()
        self.height, self.blocks, self.cycles = 0, [], []
        self.app_hash = b""
        self.responses_equal = True
        self.flushes, self.verdict_s = [], []
        coll = self.pool.admission.collector
        real_batch, real_verify = coll._verify_batch, coll.verify

        def recorded(envs):
            k0 = tv.general_verify.launches
            t0 = time.perf_counter()
            out = real_batch(envs)
            self.flushes.append(dict(
                n=len(envs), ms=(time.perf_counter() - t0) * 1e3,
                launches=tv.general_verify.launches - k0, envs=envs,
                verdicts=[bool(v) for v in out]))
            return out

        async def timed_verify(env):
            t0 = time.perf_counter()
            try:
                return await real_verify(env)
            finally:
                self.verdict_s.append(time.perf_counter() - t0)

        coll._verify_batch, coll.verify = recorded, timed_verify

    async def propose(self) -> None:
        """lock, reap under the block params, BeginBlock / DeliverTx /
        EndBlock / Commit on the consensus connection, the responses
        saved and read back, update with recheck, unlock."""
        from tendermint_tpu_torch.abci import types as t

        pool, cons = self.pool, self.conns.consensus
        pool.lock()
        try:
            t0 = time.perf_counter()
            txs = pool.reap_max_bytes_max_gas(self.params.block.max_bytes,
                                              self.params.block.max_gas)
            self.height += 1
            h = self.height
            bb = await cons.begin_block(t.RequestBeginBlock(
                header={"height": h}))
            dtx = [await cons.deliver_tx(t.RequestDeliverTx(tx))
                   for tx in txs]
            eb = await cons.end_block(t.RequestEndBlock(h))
            cm = await cons.commit()
            resp = {"deliver_txs": dtx, "begin_block": bb, "end_block": eb}
            self.store.save_abci_responses(h, resp)
            self.responses_equal &= self.store.load_abci_responses(h) == resp
            await pool.update(h, txs, dtx)
            self.blocks.append(txs)
            self.app_hash = cm.data
            self.cycles.append(dict(txs=len(txs),
                                    ms=(time.perf_counter() - t0) * 1e3))
        finally:
            pool.unlock()

    async def drive(self, txs, outstanding: int) -> dict:
        """Submit `txs` with `outstanding` CheckTx calls open, a proposer
        cycle every ADM_CYCLE admitted txs, backpressure sheds resubmitted
        once the backlog drains, a last cycle for the rest. Returns the
        responses, per-tx CheckTx latencies, sheds and seconds."""
        import asyncio

        from tendermint_tpu_torch.mempool.admission import (
            AdmissionQueueFullError)
        from tendermint_tpu_torch.mempool.clist_mempool import (
            MempoolBusyError, MempoolFullError)

        backpressure = (AdmissionQueueFullError, MempoolBusyError,
                        MempoolFullError)
        results, lat = [None] * len(txs), [0.0] * len(txs)
        sem = asyncio.Semaphore(outstanding)
        sheds: dict = {}
        retry: list = []
        st = {"admitted": 0, "next": ADM_CYCLE, "cycle": None}
        cycles: list = []

        async def one(i):
            t0 = time.perf_counter()
            try:
                res = await self.pool.check_tx(txs[i])
                results[i] = res
                if res.code == 0:
                    st["admitted"] += 1
                    if st["admitted"] >= st["next"] and (
                            st["cycle"] is None or st["cycle"].done()):
                        st["next"] = st["admitted"] + ADM_CYCLE
                        st["cycle"] = asyncio.ensure_future(self.propose())
                        cycles.append(st["cycle"])
            except backpressure as e:
                sheds[type(e).__name__] = sheds.get(type(e).__name__, 0) + 1
                retry.append(i)
            finally:
                lat[i] = time.perf_counter() - t0
                sem.release()

        t0 = time.perf_counter()
        tasks = []
        for i in range(len(txs)):
            await sem.acquire()
            tasks.append(asyncio.ensure_future(one(i)))
        await asyncio.gather(*tasks)
        while retry:
            await asyncio.gather(*cycles)
            again, retry[:] = list(retry), []
            for i in again:
                await sem.acquire()
                tasks.append(asyncio.ensure_future(one(i)))
            await asyncio.gather(*tasks)
        await asyncio.gather(*cycles)
        seconds = time.perf_counter() - t0
        while self.pool.size():
            await self.propose()
        return dict(results=results, lat=lat, sheds=sheds, seconds=seconds,
                    admitted=st["admitted"])

    def close(self) -> None:
        self.pool.close()


def adm_flush_record(f) -> dict:
    from tendermint_tpu_torch.crypto.cuda import verify as tv

    return dict(lanes=f["n"], bucket=tv.lane_bucket(f["n"] + 1)
                if f["n"] >= 40 else None, launches=f["launches"],
                ms=f["ms"])


def adm_packed(envs):
    """A flush's lanes as verify_batch packs them: the envelopes, the
    sentinel lane last, the dummy triple up to the bucket."""
    from tendermint_tpu_torch.crypto import batch as cbatch
    from tendermint_tpu_torch.crypto.cuda import verify as tv
    from tendermint_tpu_torch.types import tx_envelope

    spub, smsg, ssig = cbatch._ed_probe_triple()
    pubs = [e.pub_key for e in envs] + [spub]
    msgs = [tx_envelope.sign_bytes(e.payload) for e in envs] + [smsg]
    sigs = [e.signature for e in envs] + [ssig]
    dp, dm, ds = tv._dummy_triple()
    pad = tv._chunks(len(pubs))[0] - len(pubs)
    return pubs + [dp] * pad, msgs + [dm] * pad, sigs + [ds] * pad


def adm_k4_ms(envs, dev, reps: int = 10) -> dict:
    """K4's device time on a flush's packed lanes (device_ms), the host
    pack and the upload (medians of 3) and the message width."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import verify as tv

    lanes = adm_packed(envs)
    pack_ms, up_ms, packed, t = [], [], None, None
    for _ in range(3):
        t0 = time.perf_counter()
        packed = tv.pack_batch(*lanes)
        pack_ms.append((time.perf_counter() - t0) * 1e3)
    for _ in range(3):
        t = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t = tv.to_device(packed, dev)
        torch.cuda.synchronize()
        up_ms.append((time.perf_counter() - t0) * 1e3)
    args = (t["ab"], t["sb"], t["msg"], t["nblocks"], t["s_ok"],
            tv._btab(dev))
    ok = bool(tv.general_verify(*args)[:len(envs) + 1].all())
    out = dict(lanes=len(envs) + 1, bucket=int(t["ab"].shape[0]),
               msg_width=int(packed["msg"].shape[1]),
               host_bytes=sum(a.nbytes for a in packed.values()),
               pack_ms=statistics.median(pack_ms),
               upload_ms=statistics.median(up_ms),
               k4_ms=device_ms(lambda: tv.general_verify(*args), reps),
               ok=ok)
    return out


def adm_k4_row(name, envs, dev) -> dict:
    """K4 on a full admission flush of valid envelopes, packed as
    verify_batch packs it: the kernels line's row."""
    from tendermint_tpu_torch.crypto.cuda import verify as tv

    t = tv.to_device(tv.pack_batch(*adm_packed(envs)), dev)
    return k4_row(name, (t["ab"], t["sb"], t["msg"], t["nblocks"],
                         t["s_ok"], tv._btab(dev)), len(envs) + 1)


def admission_phase(dev):
    """The tx path on the card (docstring, phase 13): the mixed and the
    strict traffic and the width probe, each through its own node's
    AdmissionStack. Returns the phase's record and the
    general_verify_admission row."""
    import asyncio

    import torch

    from tendermint_tpu_torch.abci import kvstore
    from tendermint_tpu_torch.abci import types as t
    from tendermint_tpu_torch.config import MempoolConfig
    from tendermint_tpu_torch.crypto.cuda import verify as tv
    from tendermint_tpu_torch.libs.db import MemDB
    from tendermint_tpu_torch.libs.overload import CONTROLLER
    from tendermint_tpu_torch.mempool import admission as adm

    t0 = time.perf_counter()
    signers = adm_signers(ADM_SIGNERS)
    mixed, mixed_kinds = adm_mixed_txs(ADM_TXS, signers)
    strict, strict_kinds = adm_strict_txs(ADM_STRICT, ADM_STRICT_BAD, signers)
    max_tx = MempoolConfig().max_tx_bytes
    probes = [adm_probe_txs(signers, w) for w in (ADM_WIDE, max_tx)]
    setup_s = time.perf_counter() - t0
    stacks = {"mixed": AdmissionStack("permissive"),
              "strict": AdmissionStack("strict"),
              "probe": AdmissionStack("permissive")}
    runs, queues = {}, {}

    async def drive():
        for name, txs in (("mixed", mixed), ("strict", strict)):
            await stacks[name].conns.start()
            queues[name] = sorted(CONTROLLER.evaluate()["queues"])
            runs[name] = await stacks[name].drive(txs, ADM_OUTSTANDING)
        await stacks["probe"].conns.start()
        runs["probe"] = [await stacks["probe"].drive(txs, len(txs))
                         for txs in probes]
        for st in stacks.values():
            await st.conns.stop()

    kernels = wrappers()
    metrics0 = metrics_view("admission")
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    asyncio.run(drive())
    run_s = time.perf_counter() - t0
    launches = {k: f.launches for k, f in kernels.items() if f.launches}
    for st in stacks.values():
        st.close()
    metrics = {k: {b: n - metrics0[k].get(b, 0) for b, n in v.items()
                   if n != metrics0[k].get(b, 0)}
               for k, v in metrics_view("admission").items()}
    flushes = [f for st in stacks.values() for f in st.flushes]

    # the host oracle on every enveloped tx's verdict
    t0 = time.perf_counter()
    want = host_oracle([e for f in flushes for e in f["envs"]])
    oracle_s = time.perf_counter() - t0
    got = [v for f in flushes for v in f["verdicts"]]

    def committed(st):
        out = {}
        for block in st.blocks:
            for tx in block:
                out[tx] = out.get(tx, 0) + 1
        return out

    def fresh_app_hash(st):
        app = kvstore.PersistentKVStoreApp(MemDB())
        for h, block in enumerate(st.blocks, 1):
            app.begin_block(t.RequestBeginBlock(header={"height": h}))
            for tx in block:
                app.deliver_tx(t.RequestDeliverTx(tx))
            app.end_block(t.RequestEndBlock(h))
            app.commit(t.RequestCommit())
        return app.app_hash, app.height

    def traffic_checks(name, txs, kinds):
        st, r = stacks[name], runs[name]
        done = committed(st)
        res = r["results"]
        want_shed = {"garbage": "admission: bad_signature",
                     "unsigned": "admission: unsigned",
                     "malformed": "admission: malformed"}
        checked = set(st.app.checked)
        admitted = sum(k in ("valid", "raw") for k in kinds)
        return {
            "admitted_once": all(
                res[i].code == 0 and done.get(tx) == 1
                for i, (tx, k) in enumerate(zip(txs, kinds))
                if k in ("valid", "raw")),
            "shed": all(res[i].code == adm.CODE_ADMISSION_REJECT
                        and res[i].log == want_shed[k] and tx not in done
                        and tx not in checked
                        for i, (tx, k) in enumerate(zip(txs, kinds))
                        if k in want_shed),
            "app_checks": len(st.app.checked) == admitted,
            "committed": sum(done.values()) == r["admitted"] == admitted,
            "app_hash": fresh_app_hash(st) == (st.app_hash, st.height),
            "responses": st.responses_equal,
            "k4_per_flush": all(f["launches"] == (1 if f["n"] >= 40 else 0)
                                for f in st.flushes),
            "pool_empty": st.pool.size() == 0,
        }

    n_env = (sum(k in ("garbage", "valid") for k in mixed_kinds) + ADM_STRICT
             + 2 * (ADM_PROBE_SMALL + 1))
    checks = {
        "mixed": traffic_checks("mixed", mixed, mixed_kinds),
        "strict": traffic_checks("strict", strict, strict_kinds),
        "probe": all(res.code == 0 for r in runs["probe"]
                     for res in r["results"])
        and [f["n"] for f in stacks["probe"].flushes] == [
            ADM_PROBE_SMALL + 1] * 2
        and fresh_app_hash(stacks["probe"]) == (
            stacks["probe"].app_hash, stacks["probe"].height),
        "oracle": got == want and len(got) == n_env,
        "launches": launches == {"general_verify": sum(
            f["n"] >= 40 for f in flushes)}
        and all(f["launches"] == (f["n"] >= 40) for f in flushes),
        "metrics": metrics["verify_launches"].get("device", 0) == sum(
            f["n"] >= 40 for f in flushes)
        and metrics["verify_launches"].get("host", 0) == sum(
            f["n"] < 40 for f in flushes)
        and set(metrics["verify_launches"]) <= {"device", "host"},
        "queues": all({"mempool.pool", "mempool.preverify"} <= set(q)
                      for q in queues.values()),
        "no_backpressure": not runs["mixed"]["sheds"]
        and not runs["strict"]["sheds"],
    }
    if not all(v if isinstance(v, bool) else all(v.values())
               for v in checks.values()):
        raise AssertionError(f"admission: {checks}, launches {launches}, "
                             f"metrics {metrics}, backpressure "
                             f"{runs['mixed']['sheds']} "
                             f"{runs['strict']['sheds']}")

    # K4 at each bucket the flushes used (the widest flush of each), and
    # at the width probe's two flushes
    widest: dict = {}
    for f in stacks["strict"].flushes + stacks["mixed"].flushes:
        if f["n"] >= 40:
            b = tv.lane_bucket(f["n"] + 1)
            if f["n"] > widest.get(b, {"n": -1})["n"]:
                widest[b] = f
    k4_by_bucket = {b: adm_k4_ms(f["envs"], dev)
                    for b, f in sorted(widest.items())}
    probe = []
    for f in stacks["probe"].flushes:
        probe.append(adm_k4_ms(f["envs"], dev, reps=3))
        torch.cuda.empty_cache()
    full = next(f for f in stacks["strict"].flushes
                if f["n"] == MempoolConfig().admission_batch)
    row = adm_k4_row("general_verify_admission", full["envs"], dev)

    def pct(xs, q):
        xs = sorted(xs)
        return xs[min(len(xs) - 1, int(q * len(xs)))] * 1e3 if xs else None

    def traffic(name):
        st, r = stacks[name], runs[name]
        return dict(
            txs=len(r["results"]), admitted=r["admitted"],
            seconds=r["seconds"], admitted_per_s=r["admitted"] / r["seconds"],
            sheds=dict(st.pool.admission.sheds), backpressure=r["sheds"],
            flushes=[adm_flush_record(f) for f in st.flushes],
            flush_ms_p50=statistics.median(f["ms"] for f in st.flushes),
            verdict_p50_ms=pct(st.verdict_s, 0.5),
            verdict_p99_ms=pct(st.verdict_s, 0.99),
            check_tx_p50_ms=pct(r["lat"], 0.5),
            check_tx_p99_ms=pct(r["lat"], 0.99),
            cycles=st.cycles, app_rechecks=st.app.rechecks)

    cfg = MempoolConfig()
    out = dict(
        config=dict(size=cfg.size, cache_size=cfg.cache_size,
                    admission_batch=cfg.admission_batch,
                    admission_flush_ms=cfg.admission_flush_ms,
                    admission_queue=cfg.admission_queue,
                    checktx_max_inflight=cfg.checktx_max_inflight,
                    outstanding=ADM_OUTSTANDING, signers=ADM_SIGNERS),
        setup_s=setup_s, run_s=run_s, oracle_s=oracle_s,
        mixed=traffic("mixed"), strict=traffic("strict"),
        probe=dict(flushes=[adm_flush_record(f)
                            for f in stacks["probe"].flushes],
                   k4=probe, wide_bytes=[ADM_WIDE, max_tx]),
        k4_by_bucket=k4_by_bucket, collector_metrics=metrics,
        launches=launches, checks=checks)
    return out, row


# -- phase 14: execution ---------------------------------------------------


def exec_keys(n: int):
    """n + 1 MockPVs (the last key joins the set at EXEC_CHANGE_AT), their
    keys derived from seeds as make_node_chain derives its keys."""
    from tendermint_tpu_torch.crypto import ed25519
    from tendermint_tpu_torch.types.priv_validator import MockPV

    return [MockPV(ed25519.Ed25519PrivKey(
        hashlib.sha256(b"exec-val-%d" % i).digest())) for i in range(n + 1)]


def exec_genesis(pvs):
    """The genesis of every pvs key but the last, of power 10 each."""
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    return GenesisDoc(chain_id=CHAIN, genesis_time=EXEC_T0,
                      validators=[GenesisValidator(pv.get_pub_key(), 10)
                                  for pv in pvs[:-1]])


def db_digest(db, prefix: bytes | None = None) -> str:
    """A DB's items (those under `prefix` only, where given), hashed."""
    h = hashlib.sha256()
    for k, v in db.iterate() if prefix is None else db.iterate_prefix(prefix):
        h.update(len(k).to_bytes(4, "big") + k + len(v).to_bytes(4, "big") + v)
    return h.hexdigest()[:16]


class ExecNode:
    """One node of the commit pipeline (docstring, phase 14): a state
    Store and a BlockStore, a PersistentKVStoreApp that counts its
    BeginBlocks, AppConns over LocalClients, and, when `full`, a
    CListMempool at MempoolConfig's defaults (the admission plane in
    front of CheckTx), an evidence Pool and an EventBus with an
    IndexerService; a BlockExecutor over them. start() runs
    reconcile_and_handshake."""

    def __init__(self, pvs, dbs=None, full: bool = True):
        from tendermint_tpu_torch.abci import kvstore
        from tendermint_tpu_torch.libs.db import MemDB
        from tendermint_tpu_torch.state.store import Store
        from tendermint_tpu_torch.store import BlockStore

        class App(kvstore.PersistentKVStoreApp):
            def begin_block(self, req):
                self.begin_blocks = getattr(self, "begin_blocks", 0) + 1
                return super().begin_block(req)

        self.pvs = pvs
        self.pv_of = {pv.get_pub_key().address(): pv for pv in pvs}
        self.dbs = dbs or (MemDB(), MemDB(), MemDB())
        self.ss, self.bs = Store(self.dbs[0]), BlockStore(self.dbs[1])
        self.app = App(self.dbs[2])
        self.full = full
        self.last_commit = None

    async def start(self) -> "ExecNode":
        from tendermint_tpu_torch.abci.client import ClientCreator
        from tendermint_tpu_torch.config import MempoolConfig
        from tendermint_tpu_torch.consensus.replay import reconcile_and_handshake
        from tendermint_tpu_torch.evidence import Pool
        from tendermint_tpu_torch.libs.db import MemDB
        from tendermint_tpu_torch.mempool.clist_mempool import CListMempool
        from tendermint_tpu_torch.proxy import AppConns
        from tendermint_tpu_torch.state.execution import BlockExecutor
        from tendermint_tpu_torch.state.txindex import (BlockIndexer,
                                                        IndexerService,
                                                        TxIndexer)
        from tendermint_tpu_torch.types.events import EventBus

        self.conns = AppConns(ClientCreator(app=self.app))
        await self.conns.start()
        self.bus = self.indexer = self.mempool = self.evpool = None
        if self.full:
            self.bus = EventBus()
            self.indexer = IndexerService(TxIndexer(MemDB()), self.bus,
                                          BlockIndexer(MemDB()))
            self.indexer.start()
        t0 = time.perf_counter()
        self.state, self.report = await reconcile_and_handshake(
            None, self.ss, self.bs, exec_genesis(self.pvs), self.conns,
            event_bus=self.bus)
        self.handshake_s = time.perf_counter() - t0
        if self.full:
            self.mempool = CListMempool(MempoolConfig(), self.conns.mempool)
            self.evpool = Pool(MemDB(), self.ss, self.bs)
        self.executor = BlockExecutor(self.ss, self.conns.consensus,
                                      mempool=self.mempool,
                                      evidence_pool=self.evpool,
                                      event_bus=self.bus)
        if self.state.last_block_height:
            self.last_commit = self.bs.load_seen_commit(
                self.state.last_block_height)
        return self

    async def settle(self) -> None:
        """Let the indexer's tasks take every event published so far."""
        import asyncio

        subs = [self.indexer._sub, self.indexer._blk_sub]
        idle = 0
        while idle < 16:  # a message takes a few loop turns past its get
            await asyncio.sleep(0)
            idle = 0 if any(not s.queue.empty() for s in subs) else idle + 1

    async def stop(self) -> None:
        if self.full:
            await self.settle()
            self.indexer.stop()
            self.mempool.close()
        await self.conns.stop()

    def sign_commit(self, vals, height: int, bid, ts: int):
        """Every validator of `vals` precommits bid at height, round 0, at
        time ts, signed by its MockPV (OpenSSL where the host has it)."""
        from tendermint_tpu_torch.types.block import (BlockIDFlag, Commit,
                                                      CommitSig)
        from tendermint_tpu_torch.types.vote import Vote, VoteType

        sigs = []
        for i, v in enumerate(vals.validators):
            vote = Vote(type=VoteType.PRECOMMIT, height=height, round=0,
                        block_id=bid, timestamp=ts,
                        validator_address=v.address, validator_index=i)
            self.pv_of[v.address].sign_vote(CHAIN, vote)
            sigs.append(CommitSig(BlockIDFlag.COMMIT, v.address, ts,
                                  vote.signature))
        return Commit(height, 0, bid, sigs)

    async def admit(self, h: int, signers) -> list[int]:
        """Height h's txs through check_tx: EXEC_ENVELOPES signed envelopes
        at once (one admission flush), then EXEC_RAW raw kvstore txs and,
        at EXEC_CHANGE_AT, the `val:` txs that add the last key and remove
        the fourth. The responses' codes."""
        import asyncio

        from tendermint_tpu_torch.abci.kvstore import encode_validator_tx
        from tendermint_tpu_torch.types import tx_envelope

        envs = [tx_envelope.sign_tx(signers[i], b"env%d-%d=%d" % (h, i, h * i))
                for i in range(EXEC_ENVELOPES)]
        raw = [b"raw%d-%d=%d" % (h, i, i) for i in range(EXEC_RAW)]
        if h == EXEC_CHANGE_AT:
            raw += [encode_validator_tx(
                self.pvs[-1].get_pub_key().bytes().hex(), 10),
                encode_validator_tx(self.pvs[3].get_pub_key().bytes().hex(), 0)]
        codes = []
        for txs in (envs, raw):  # in turn: a deterministic mempool order
            res = await asyncio.gather(*(self.mempool.check_tx(tx)
                                         for tx in txs))
            codes += [r.code for r in res]
        return codes

    def propose(self):
        st = self.state
        return self.executor.create_proposal_block(
            st.last_block_height + 1, st, self.last_commit,
            st.validators.get_proposer().address)

    async def apply(self, block, parts, seen):
        """save_block, then apply_block, as consensus commits a height."""
        from tendermint_tpu_torch.types.block import BlockID

        if self.bs.height < block.header.height:
            self.bs.save_block(block, parts, seen)
        bid = BlockID(block.hash(), parts.header())
        self.state, _ = await self.executor.apply_block(self.state, bid, block)
        self.last_commit = seen


def pipeline_timer(node):
    """Wrap the steps apply_block takes (validate_block, and within it
    ValidatorSet.hash, verify_commit and median_time; the ABCI exec, and
    within it the stored validator set's load; the responses save;
    update_state; Commit with the mempool update; the evidence pool's
    update; the state save; the events) for the length of a `with`; each
    step's ms accumulates in the dict it yields (a speculated height adds
    serve_commit, exec_speculated), and `gc` sums the garbage collector's
    pauses, inside whichever step they fell."""
    import contextlib
    import gc

    from tendermint_tpu_torch.state import execution, validation
    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    acc: dict = {}
    inside = {"validate": False}

    def add(step, t0):
        acc[step] = acc.get(step, 0.0) + (time.perf_counter() - t0) * 1e3

    def timed(step, fn, in_validate=False):
        def run(*a, **kw):
            if in_validate and not inside["validate"]:
                return fn(*a, **kw)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                add(step, t0)
        return run

    def timed_async(step, fn):
        async def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return await fn(*a, **kw)
            finally:
                add(step, t0)
        return run

    real_validate = execution.validate_block

    def validate(*a, **kw):
        inside["validate"] = True
        t0 = time.perf_counter()
        try:
            return real_validate(*a, **kw)
        finally:
            inside["validate"] = False
            add("validate", t0)

    ex = node.executor
    module_patches = [
        (execution, "validate_block", validate),
        (ValidatorSet, "hash", timed("valset_hash", ValidatorSet.hash, True)),
        (ValidatorSet, "verify_commit",
         timed("verify_commit", ValidatorSet.verify_commit, True)),
        (validation, "median_time",
         timed("median_time", validation.median_time, True)),
        (execution, "update_state",
         timed("update_state", execution.update_state))]
    instance_patches = [
        (ex, "_exec_block_on_proxy_app",
         timed_async("exec", ex._exec_block_on_proxy_app)),
        (ex, "_commit", timed_async("commit", ex._commit)),
        (ex, "_fire_events", timed("events", ex._fire_events)),
        (node.ss, "save_abci_responses",
         timed("responses_save", node.ss.save_abci_responses)),
        # build_last_commit_info's stored set of height - 1, in the exec
        (node.ss, "load_validators",
         timed("load_validators", node.ss.load_validators)),
        (node.ss, "save", timed("state_save", node.ss.save))]
    if node.evpool is not None:
        instance_patches.append((node.evpool, "update",
                                 timed("evidence_update", node.evpool.update)))

    gc_start = []

    def gc_pause(phase, info):
        # the collector's pauses, whichever step (or thread) they hit
        if phase == "start":
            gc_start.append(time.perf_counter())
        elif gc_start:
            add("gc", gc_start.pop())

    @contextlib.contextmanager
    def installed():
        saved = [(o, n, getattr(o, n)) for o, n, _ in module_patches]
        for o, n, fn in module_patches + instance_patches:
            setattr(o, n, fn)
        gc.callbacks.append(gc_pause)
        try:
            yield acc
        finally:
            gc.callbacks.remove(gc_pause)
            for o, n, fn in saved:
                setattr(o, n, fn)
            for o, n, _ in instance_patches:
                delattr(o, n)

    return installed()


def exec_counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


def exec_delta(before: dict) -> dict:
    now = exec_counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


async def exec_height(node, h: int, signers, acc=None) -> dict:
    """One clean height: admit its txs, reap them into the proposer's
    block, sign the set's precommits on the host, save_block and
    apply_block. The height's record (times in ms, each step's launches)
    and its (block, parts, seen commit)."""
    import torch

    from tendermint_tpu_torch.types.block import BlockID

    k0 = exec_counts()
    t0 = time.perf_counter()
    codes = await node.admit(h, signers)
    admit_ms = (time.perf_counter() - t0) * 1e3
    if any(codes):
        raise AssertionError(f"height {h}: a tx was refused: {codes}")
    admit_launches = exec_delta(k0)
    t0 = time.perf_counter()
    block = node.propose()
    parts = block.make_part_set()
    bid = BlockID(block.hash(), parts.header())
    propose_ms = (time.perf_counter() - t0) * 1e3
    if len(block.data.txs) != len(codes):
        raise AssertionError(f"height {h}: {len(block.data.txs)} txs reaped "
                             f"of {len(codes)}")
    t0 = time.perf_counter()
    seen = node.sign_commit(node.state.validators, h, bid,
                            block.header.time + 1_000_000_000)
    sign_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    node.bs.save_block(block, parts, seen)
    save_block_ms = (time.perf_counter() - t0) * 1e3
    if acc is not None:
        acc.clear()
    k1 = exec_counts()
    t0 = time.perf_counter()
    await node.apply(block, parts, seen)
    if torch.cuda.is_initialized():  # the host run never touches the card
        torch.cuda.synchronize()
    apply_ms = (time.perf_counter() - t0) * 1e3
    st = node.state
    if st.app_hash != node.app.app_hash or st.last_block_height != h:
        raise AssertionError(f"height {h}: state and app disagree")
    return dict(height=h, txs=len(block.data.txs),
                validators=len(st.validators), admit_ms=admit_ms,
                admit_launches=admit_launches, propose_ms=propose_ms,
                sign_ms=sign_ms, save_block_ms=save_block_ms,
                apply_block_ms=apply_ms, apply_at=t0,
                split_ms=dict(acc) if acc is not None else None,
                apply_launches=exec_delta(k1),
                block_hash=block.hash().hex(), app_hash=st.app_hash.hex(),
                last_results_hash=st.last_results_hash.hex(),
                state_db=db_digest(node.dbs[0])), (block, parts, seen)


async def exec_clean_chain(pvs, signers, node=None, timer=None):
    """EXEC_HEIGHTS clean heights on a started full node (or a fresh
    one): the records and each height's (block, parts, seen)."""
    node = node or await ExecNode(pvs).start()
    records, blocks = [], {}
    for h in range(1, EXEC_HEIGHTS + 1):
        rec, blocks[h] = await exec_height(node, h, signers, timer)
        records.append(rec)
    return node, records, blocks


def exec_host_child() -> int:
    """The execution phase's host run (`--phase execution_host`): the same
    chain with crypto.batch's host route forced and the admission
    collector on its host oracle, so no kernel runs; one line a height
    (block, app and state digests) for the parent to compare."""
    import asyncio

    from tendermint_tpu_torch.crypto import batch as cbatch
    from tendermint_tpu_torch.mempool import admission

    cbatch.set_force_host(True)
    real_init = admission.AdmissionCollector.__init__

    def host_collector(self, *a, **kw):
        real_init(self, *a, **kw)
        self.device_threshold = 10**9

    admission.AdmissionCollector.__init__ = host_collector
    pvs, signers = exec_keys(EXEC_VALIDATORS), adm_signers(EXEC_ENVELOPES)

    async def run():
        node, records, _ = await exec_clean_chain(pvs, signers)
        for h in range(EXEC_HEIGHTS + 1, EXEC_HEIGHTS + EXEC_SPEC_HEIGHTS + 1):
            rec, _ = await exec_height(node, h, signers)
            records.append(rec)
        await node.stop()
        return records

    records = asyncio.run(run())
    if any(exec_counts().values()):
        raise AssertionError(f"the host run launched: {exec_counts()}")
    for r in records:
        emit({"phase": "height", **{k: r[k] for k in (
            "height", "txs", "block_hash", "app_hash", "last_results_hash",
            "state_db", "apply_block_ms")}})
    return 0


async def exec_forged(node) -> dict:
    """A block whose LastCommit has one flipped signature: apply_block must
    raise BlockValidationError naming the lane after one K3 launch, with
    the state, both stores and the app untouched and no BeginBlock."""
    from tendermint_tpu_torch.crypto import ed25519_ref as ref
    from tendermint_tpu_torch.state import median_time
    from tendermint_tpu_torch.state.validation import BlockValidationError
    from tendermint_tpu_torch.types.block import BlockID, Commit, CommitSig

    st, lc = node.state, node.last_commit
    bad = len(lc.signatures) * 29 // 64
    sigs = [CommitSig(cs.block_id_flag, cs.validator_address, cs.timestamp,
                      cs.signature) for cs in lc.signatures]
    good = sigs[bad].signature
    sigs[bad].signature = good[:20] + bytes([good[20] ^ 0x10]) + good[21:]
    forged = Commit(lc.height, lc.round, lc.block_id, sigs)
    block = st.make_block(st.last_block_height + 1, [b"forged=1"], forged, [],
                          st.validators.get_proposer().address,
                          median_time(forged, st.last_validators))
    parts = block.make_part_set()

    def snapshot():
        return (db_digest(node.dbs[0]), db_digest(node.dbs[1]),
                db_digest(node.dbs[2]), node.app.app_hash, node.app.height,
                getattr(node.app, "begin_blocks", 0), node.bs.height)

    before = snapshot()
    k0 = exec_counts()
    t0 = time.perf_counter()
    try:
        await node.executor.apply_block(st, BlockID(block.hash(),
                                                    parts.header()), block)
    except BlockValidationError as e:
        message = str(e)
    else:
        raise AssertionError("the forged LastCommit was applied")
    ms = (time.perf_counter() - t0) * 1e3
    launches = exec_delta(k0)
    want = f"invalid LastCommit: invalid signature(s) at index(es) [{bad}]"
    pub = st.last_validators.validators[bad].pub_key.bytes()
    msg = lc.vote_sign_bytes(CHAIN, bad)
    oracle = (ref.verify(pub, msg, good), ref.verify(pub, msg,
                                                     sigs[bad].signature))
    if message != want or launches.get("xverify") != 1 or \
            oracle != (True, False) or snapshot() != before or \
            node.state is not st:
        raise AssertionError(f"forged block: {message} {launches} {oracle} "
                             f"{before} {snapshot()}")
    return dict(lane=bad, rejected=message, apply_block_ms=ms,
                launches=launches, oracle=list(oracle))


async def exec_speculated(node, h: int, signers, timer) -> dict:
    """Height h with a SpeculationPlane fed the LastCommit's precommits
    (bursts of SPEC_BURST, a flush_sync after each: K6 + K7) before the
    block is applied: validate_block is served by the plane, with no K3
    launch."""
    from tendermint_tpu_torch.config import SpeculationConfig
    from tendermint_tpu_torch.consensus import SpeculationPlane
    from tendermint_tpu_torch.types.vote import Vote, VoteType

    lc, vals = node.last_commit, node.state.last_validators
    k0 = exec_counts()
    t0 = time.perf_counter()
    plane = SpeculationPlane(SpeculationConfig())
    plane.begin_height(CHAIN, vals, lc.height, lc.round, lc.block_id)
    for start in range(0, len(lc.signatures), SPEC_BURST):
        for i in range(start, min(start + SPEC_BURST, len(lc.signatures))):
            cs = lc.signatures[i]
            plane.observe_precommit(Vote(
                VoteType.PRECOMMIT, lc.height, lc.round, lc.block_id,
                cs.timestamp, cs.validator_address, i, cs.signature))
        plane.flush_sync()
    feed_ms = (time.perf_counter() - t0) * 1e3
    feed_launches = exec_delta(k0)
    real_serve = plane.serve_commit

    def serve(*a):
        t = time.perf_counter()
        try:
            return real_serve(*a)
        finally:
            timer["serve_commit"] = (time.perf_counter() - t) * 1e3

    plane.serve_commit = serve
    node.executor.speculation = plane
    try:
        rec, blk = await exec_height(node, h, signers, timer)
    finally:
        node.executor.speculation = None
    if plane.hits != 1 or any(plane.misses.values()) or \
            rec["apply_launches"]:
        raise AssertionError(f"height {h}: not served by the plane: "
                             f"{plane.hits} {plane.misses} "
                             f"{rec['apply_launches']}")
    rec.update(feed_ms=feed_ms, feed_launches=feed_launches)
    return rec, blk


async def exec_crash(pvs, blocks, clean, d, point, want) -> dict:
    """Crash the pipeline at `point` while applying height EXEC_CRASH_H
    over FileDBs in d (the clean run's blocks), reopen every store from
    disk and reconcile: exactly the `want` repairs, one K3 launch for the
    re-apply, the clean run's app hash, then one more height."""
    from tendermint_tpu_torch.libs import failpoints
    from tendermint_tpu_torch.libs.db import FileDB

    def open_dbs():
        return tuple(FileDB(os.path.join(d, f"{n}.db"))
                     for n in ("state", "blocks", "app"))

    dbs = open_dbs()
    node = await ExecNode(pvs, dbs, full=False).start()
    t0 = time.perf_counter()
    for h in range(1, EXEC_CRASH_H + 1):
        if h == EXEC_CRASH_H:
            failpoints.arm(point, "error")
        try:
            await node.apply(*blocks[h])
        except failpoints.FailpointError as e:
            if h != EXEC_CRASH_H or e.name != point:
                raise
        else:
            if h == EXEC_CRASH_H:
                raise AssertionError(f"{point} did not fire")
        finally:
            failpoints.disarm_all()
    grow_s = time.perf_counter() - t0
    await node.stop()
    for db in dbs:
        db.close()
    dbs = open_dbs()  # the restart: every store from disk
    try:
        k0 = exec_counts()
        t0 = time.perf_counter()
        node = await ExecNode(pvs, dbs, full=False).start()
        recover_s = time.perf_counter() - t0
        recover_launches = exec_delta(k0)
        repairs = [r["kind"] for r in node.report.repairs]
        healed = node.state.app_hash.hex()
        t0 = time.perf_counter()
        await node.apply(*blocks[EXEC_CRASH_H + 1])
        next_ms = (time.perf_counter() - t0) * 1e3
        await node.stop()
    finally:
        for db in dbs:
            db.close()
    ok = (repairs == want and recover_launches.get("xverify") == 1
          and healed == clean[EXEC_CRASH_H]["app_hash"]
          and node.state.last_block_height == EXEC_CRASH_H + 1
          and node.state.app_hash.hex() == clean[EXEC_CRASH_H + 1]["app_hash"])
    if not ok:
        raise AssertionError(f"{point}: {repairs} {recover_launches} {healed}")
    return dict(point=point, repairs=repairs, grow_s=grow_s,
                recover_s=recover_s, recover_launches=recover_launches,
                healed_app_hash=healed, next_apply_ms=next_ms,
                report=node.report.to_dict())


def start_host_child():
    """The execution phase's host run (exec_host_child), in a child
    that prints its lines on a pipe."""
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--phase",
         "execution_host"], stdout=subprocess.PIPE, text=True)


def execution_phase():
    """The commit pipeline on the card (docstring, phase 14). Returns the
    phase's record."""
    import asyncio
    import tempfile
    import threading

    import torch

    from tendermint_tpu_torch.crypto import tmhash
    from tendermint_tpu_torch.crypto.cuda import expanded
    from tendermint_tpu_torch.state import execution
    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    child = start_host_child()
    timer = threading.Timer(CHILD_TIMEOUT_S["execution_host"], child.kill)
    timer.start()
    try:
        t0 = time.perf_counter()
        pvs, signers = exec_keys(EXEC_VALIDATORS), adm_signers(EXEC_ENVELOPES)
        setup_s = time.perf_counter() - t0
        kernels = wrappers()
        for fn in kernels.values():
            fn.launches = 0
        warm, builds = [], []
        real_warm = ValidatorSet.warm_device_tables
        real_init = expanded.ExpandedKeys.__init__

        def recording_warm(self):
            thread = real_warm(self)
            warm.append((time.perf_counter(), thread))
            return thread

        def timed_build(self, pubkeys, device=None):
            t = time.perf_counter()
            real_init(self, pubkeys, device)
            torch.cuda.synchronize()
            builds.append(dict(thread=threading.current_thread().name,
                               keys=len(pubkeys), end=time.perf_counter(),
                               ms=(time.perf_counter() - t) * 1e3))

        metrics0 = execution.state_metrics().block_processing_seconds
        metrics0 = {"count": metrics0.count, "sum": metrics0.sum}

        async def run():
            node = await ExecNode(pvs).start()
            out = dict(handshake_s=node.handshake_s)
            with pipeline_timer(node) as acc:
                _, records, blocks = await exec_clean_chain(pvs, signers, node,
                                                            acc)
                for t in [t for _, t in warm]:
                    t.join()  # re-raises a failed build
                out["forged"] = await exec_forged(node)
                for h in range(EXEC_HEIGHTS + 1,
                               EXEC_HEIGHTS + EXEC_SPEC_HEIGHTS + 1):
                    rec, blocks[h] = await exec_speculated(node, h, signers,
                                                           acc)
                    records.append(rec)
            for _, thread in warm:
                thread.join()
            await node.settle()
            found = 0
            for h, (block, _, _) in sorted(blocks.items()):
                for i, tx in enumerate(block.data.txs):
                    r = node.indexer.indexer.get(tmhash.sum256(tx))
                    if r is None or (r.height, r.index) != (h, i):
                        raise AssertionError(f"tx {i} of height {h} not "
                                             f"indexed there: {r}")
                    found += 1
            out["indexed_txs"] = found
            await node.stop()
            clean = {r["height"]: r for r in records}
            out["crashes"] = []
            for point, want in EXEC_CRASHES.items():
                with tempfile.TemporaryDirectory() as d:
                    out["crashes"].append(await exec_crash(
                        pvs, blocks, clean, d, point, want))
            for _, thread in warm:  # the crash runs' re-warms (cache hits)
                thread.join()
            return out, records

        ValidatorSet.warm_device_tables = recording_warm
        expanded.ExpandedKeys.__init__ = timed_build
        try:
            out, records = asyncio.run(run())
        finally:
            ValidatorSet.warm_device_tables = real_warm
            expanded.ExpandedKeys.__init__ = real_init
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in kernels.items()
                    if fn.launches}
        host = [line for line in map(json.loads, child.stdout)]
        if child.wait() != 0:
            raise AssertionError("the execution host child failed")
    finally:
        timer.cancel()
        if child.poll() is None:
            child.kill()
            child.wait()
    keys = ("height", "txs", "block_hash", "app_hash", "last_results_hash",
            "state_db")  # the host child's lines carry these
    mine = [{k: r[k] for k in keys} for r in records]
    theirs = [{k: r[k] for k in keys} for r in host]
    if mine != theirs:
        raise AssertionError(f"the host run differs: {mine} {theirs}")
    # the first LastCommit the changed set signed is block
    # EXEC_CHANGE_AT + 3's; was its tables' warm build done by then?
    first_verify = next(r for r in records
                        if r["height"] == EXEC_CHANGE_AT + 3)["apply_at"]
    warm_build = next(b for b in builds if b["thread"] == "expanded-warm")
    warm_done = warm_build.pop("end") < first_verify
    for b in builds:
        b.pop("end", None)
    for r in records:
        r.pop("apply_at")
    k3 = [r["apply_launches"].get("xverify", 0) for r in records]
    want_k3 = [0] + [1] * (EXEC_HEIGHTS - 1) + [0] * EXEC_SPEC_HEIGHTS
    k4 = [r["admit_launches"].get("general_verify", 0) for r in records]
    if k3 != want_k3 or k4 != [1] * len(records) or \
            len(warm) != 1 + len(EXEC_CRASHES) or \
            launches.get("build_tables") != 2 or \
            [b["keys"] for b in builds] != [EXEC_VALIDATORS] * 2:
        raise AssertionError(f"launches: K3 {k3}, K4 {k4}, warm {len(warm)}, "
                             f"{launches}, builds {builds}")
    for name in ("build_tables", "xverify", "general_verify", "splice",
                 "arena_verify"):
        if not launches.get(name):
            raise AssertionError(f"{name} did not launch: {launches}")
    verified = [r["apply_block_ms"] for r in records[1:EXEC_HEIGHTS]]
    metrics = execution.state_metrics().block_processing_seconds
    metrics = {"count": metrics.count, "sum": metrics.sum}
    return dict(
        validators=EXEC_VALIDATORS, setup_s=setup_s, heights=records,
        apply_block_p50_ms=statistics.median(verified),
        apply_block_p50_of=f"heights 2-{EXEC_HEIGHTS} (one K3 each)",
        served_apply_block_ms=[r["apply_block_ms"]
                               for r in records[EXEC_HEIGHTS:]],
        split_p50_ms={k: statistics.median(r["split_ms"].get(k, 0.0)
                                           for r in records[1:EXEC_HEIGHTS])
                      for k in dict.fromkeys(k for r in records[1:EXEC_HEIGHTS]
                                             for k in r["split_ms"])},
        k3_per_block=k3, k4_per_height=k4,
        table_builds=builds, warm_started_at_height=EXEC_CHANGE_AT,
        warm_done_before_first_verify=warm_done,
        host_run=dict(heights=len(host), equal=True,
                      apply_block_ms=[r["apply_block_ms"] for r in host]),
        block_processing=dict(
            count=metrics["count"] - metrics0["count"],
            seconds=metrics["sum"] - metrics0["sum"]),
        launches=launches, **out)


# -- phase 15: consensus ---------------------------------------------------


def cs_seed(i: int) -> bytes:
    return hashlib.sha256(b"cs-val-%d" % i).digest()


def cs_genesis(pubs):
    """The consensus phase's genesis: every key of power 10."""
    from tendermint_tpu_torch.crypto.ed25519 import Ed25519PubKey
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    gdoc = GenesisDoc(chain_id=CHAIN, genesis_time=CS_T0,
                      validators=[GenesisValidator(Ed25519PubKey(p), 10)
                                  for p in pubs])
    gdoc.validate_and_complete()
    return gdoc


def cs_block_id(bid) -> tuple | None:
    """A BlockID as plain values (None for nil), for the child's pipe."""
    if bid is None:
        return None
    return (bid.hash, bid.part_set_header.total, bid.part_set_header.hash)


def cs_from_block_id(t):
    from tendermint_tpu_torch.types.block import BlockID, PartSetHeader

    return None if t is None else BlockID(t[0], PartSetHeader(t[1], t[2]))


# the peers' keys in the child and its signing workers (forked after the
# keys are made, so each worker inherits them)
_CS_KEYS: list = []
_CS_INDEX: list = []  # key index -> validator index in the set


def cs_sign_slice(vote_type: int, height: int, round_: int, bid_t, ts: int,
                  keys: list, forge: int | None):
    """One signing worker's share of a round's votes: each key's vote as
    the encoded VoteMessage; `forge`'s signature gets a flipped bit."""
    from tendermint_tpu_torch.consensus.messages import (VoteMessage,
                                                          encode_consensus_msg)
    from tendermint_tpu_torch.types.vote import Vote, VoteType

    bid = cs_from_block_id(bid_t)
    out = []
    for k in keys:
        priv = _CS_KEYS[k]
        v = Vote(type=VoteType(vote_type), height=height, round=round_,
                 block_id=bid, timestamp=ts,
                 validator_address=priv.pub_key().address(),
                 validator_index=_CS_INDEX[k])
        v.signature = priv.sign(v.sign_bytes(CHAIN))
        if k == forge:
            v.signature = v.signature[:7] + bytes([v.signature[7] ^ 4]) + \
                v.signature[8:]
        out.append((k, encode_consensus_msg(VoteMessage(v))))
    return out


def cs_frame_write(f, obj) -> None:
    import pickle

    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    f.write(len(data).to_bytes(8, "big") + data)
    f.flush()


def cs_frame_read(f):
    import pickle

    head = f.read(8)
    if len(head) < 8:
        raise EOFError("the peer pipe closed")
    n = int.from_bytes(head, "big")
    data = f.read(n)
    if len(data) < n:
        raise EOFError("the peer pipe closed mid-frame")
    return pickle.loads(data)


def cs_peers_child() -> int:
    """The consensus phase's peers (`--phase consensus_peers`): the other
    validators' signing and block building, on the host, in this process
    and CS_WORKERS forked signing workers; CUDA is never initialised.
    Requests and replies are pickled frames on stdin/stdout:

    votes  — (h, round, block id or None, ts, forge, equivocate): every
             peer's prevote and precommit for it (`forge`'s prevote with a
             flipped signature bit; `equivocate` adds a nil precommit
             beside its precommit for the block);
    build  — (h, round, state JSON, LastCommit bytes, txs, proposer):
             the block State.make_block gives, its proposal signed by the
             proposer, the block's parts, then the votes as above;
    replay — the node's block store path: every stored block re-applied
             from genesis with crypto.batch's host route forced (every
             LastCommit verified on the host) over fresh stores and a
             fresh kvstore app; each height's digests."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    from tendermint_tpu_torch.crypto.ed25519 import Ed25519PrivKey
    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    t0 = time.perf_counter()
    _CS_KEYS[:] = [Ed25519PrivKey(cs_seed(i)) for i in range(CS_VALIDATORS)]
    pubs = [k.pub_key().bytes() for k in _CS_KEYS]
    gdoc = cs_genesis(pubs)
    from tendermint_tpu_torch.types.validator import Validator

    vs = ValidatorSet([Validator.new(k.pub_key(), 10) for k in _CS_KEYS])
    index = {v.address: i for i, v in enumerate(vs.validators)}
    _CS_INDEX[:] = [index[k.pub_key().address()] for k in _CS_KEYS]
    keys_s = time.perf_counter() - t0
    pool = ProcessPoolExecutor(CS_WORKERS, mp_context=mp.get_context("fork"))
    inp, out = sys.stdin.buffer, sys.stdout.buffer
    cs_frame_write(out, {"op": "keys", "pubs": pubs, "keys_s": keys_s})

    def votes(req, skip):
        t = time.perf_counter()
        mine = [k for k in range(CS_VALIDATORS) if k != skip]
        shares = [mine[w::CS_WORKERS] for w in range(CS_WORKERS)]
        res = {}
        for kind, vt in (("prevotes", 1), ("precommits", 2)):
            futs = [pool.submit(cs_sign_slice, vt, req["h"], req["round"],
                                req["bid"], req["ts"], s,
                                req.get("forge") if vt == 1 else None)
                    for s in shares]
            res[kind] = [x for f in futs for x in f.result()]
        eq = req.get("equivocate")
        res["equivocation"] = (cs_sign_slice(2, req["h"], req["round"], None,
                                             req["ts"], [eq], None)
                               if eq is not None else [])
        res["sign_s"] = time.perf_counter() - t
        return res

    while True:
        req = cs_frame_read(inp)
        op = req["op"]
        if op == "exit":
            break
        if op == "votes":
            cs_frame_write(out, votes(req, req["node"]))
        elif op == "build":
            cs_frame_write(out, cs_build(req, votes))
        elif op == "replay":
            cs_frame_write(out, cs_replay(req, gdoc))
    pool.shutdown()
    return 0


def cs_build(req, votes):
    """The `build` request (cs_peers_child): the block, its proposal and
    parts, and the round's votes for it."""
    from tendermint_tpu_torch.consensus.messages import (BlockPartMessage,
                                                          ProposalMessage,
                                                          encode_consensus_msg)
    from tendermint_tpu_torch.libs.db import MemDB
    from tendermint_tpu_torch.state import median_time
    from tendermint_tpu_torch.state.store import _STATE_KEY, Store
    from tendermint_tpu_torch.types.block import NIL_BLOCK_ID, BlockID, Commit
    from tendermint_tpu_torch.types.proposal import Proposal

    t = time.perf_counter()
    db = MemDB()
    db.set(_STATE_KEY, req["state"])
    st = Store(db).load()
    h = req["h"]
    commit = Commit.from_bytes(req["last_commit"]) \
        if req["last_commit"] else None
    if commit is None:
        commit = Commit(0, 0, NIL_BLOCK_ID, [])
        time_ns = st.last_block_time
    else:
        time_ns = median_time(commit, st.last_validators)
    priv = _CS_KEYS[req["proposer"]]
    block = st.make_block(h, req["txs"], commit, [], priv.pub_key().address(),
                          time_ns)
    parts = block.make_part_set()
    bid = BlockID(block.hash(), parts.header())
    prop = Proposal(height=h, round=req["round"], pol_round=-1, block_id=bid,
                    timestamp=time_ns)
    prop.signature = priv.sign(prop.sign_bytes(CHAIN))
    msgs = [encode_consensus_msg(ProposalMessage(prop))] + [
        encode_consensus_msg(BlockPartMessage(h, req["round"],
                                              parts.get_part(i)))
        for i in range(parts.total)]
    build_s = time.perf_counter() - t
    res = votes(dict(req, bid=cs_block_id(bid), ts=time_ns + 1_000_000_000),
                req["node"])
    res.update(proposal=msgs, bid=cs_block_id(bid), build_s=build_s,
               block_time=time_ns)
    return res


def cs_replay(req, gdoc):
    """The `replay` request (cs_peers_child): the node's stored blocks
    re-applied from genesis on the host."""
    import asyncio

    from tendermint_tpu_torch.abci.client import ClientCreator
    from tendermint_tpu_torch.abci.kvstore import PersistentKVStoreApp
    from tendermint_tpu_torch.consensus.replay import reconcile_and_handshake
    from tendermint_tpu_torch.crypto import batch as cbatch
    from tendermint_tpu_torch.evidence import Pool
    from tendermint_tpu_torch.libs.db import FileDB, MemDB
    from tendermint_tpu_torch.proxy import AppConns
    from tendermint_tpu_torch.state.execution import BlockExecutor
    from tendermint_tpu_torch.state.store import Store
    from tendermint_tpu_torch.store import BlockStore
    from tendermint_tpu_torch.types.block import BlockID

    cbatch.set_force_host(True)

    async def run():
        node_bs = BlockStore(FileDB(req["blocks"]))
        ss, app_db = Store(MemDB()), MemDB()
        app = PersistentKVStoreApp(app_db)
        conns = AppConns(ClientCreator(app=app))
        await conns.start()
        state, _ = await reconcile_and_handshake(None, ss, BlockStore(MemDB()),
                                                 gdoc, conns)
        ex = BlockExecutor(ss, conns.consensus,
                           evidence_pool=Pool(MemDB(), ss, node_bs))
        heights = []
        for h in range(1, node_bs.height + 1):
            block = node_bs.load_block(h)
            parts = block.make_part_set()
            t = time.perf_counter()
            state, _ = await ex.apply_block(state, BlockID(block.hash(),
                                                           parts.header()),
                                            block)
            heights.append(dict(
                height=h, block_hash=block.hash().hex(),
                app_hash=state.app_hash.hex(),
                last_results_hash=state.last_results_hash.hex(),
                state_db=db_digest(ss.db),
                evidence=len(block.evidence.evidence),
                apply_block_ms=(time.perf_counter() - t) * 1e3))
        await conns.stop()
        node_bs.db.close()
        return heights

    t = time.perf_counter()
    heights = asyncio.run(run())
    cbatch.set_force_host(False)
    return {"heights": heights, "seconds": time.perf_counter() - t}


class CsPeers:
    """The parent's end of cs_peers_child: one request at a time, each in
    a worker thread so the node's event loop runs meanwhile."""

    def __init__(self, argv=None):
        import concurrent.futures

        self.proc = subprocess.Popen(
            argv or [sys.executable, os.path.abspath(__file__), "--phase",
                     "consensus_peers"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        self.pool = concurrent.futures.ThreadPoolExecutor(1)
        self.first = cs_frame_read(self.proc.stdout)

    def call(self, req):
        cs_frame_write(self.proc.stdin, req)
        return cs_frame_read(self.proc.stdout)

    def submit(self, req):
        """The reply as a concurrent future (one request in flight)."""
        return self.pool.submit(self.call, req)

    def close(self):
        try:
            if self.proc.poll() is None:
                cs_frame_write(self.proc.stdin, {"op": "exit"})
                self.proc.wait(timeout=30)
        except Exception:  # noqa: BLE001 - the child is killed below
            pass
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            self.pool.shutdown()


class CsNode:
    """The consensus phase's validator (docstring, phase 15): FileDBs for
    the state, the blocks, the app and the evidence under `home`, the
    WAL, the kvstore app behind AppConns, an EventBus with the tx and
    block indexers, a CListMempool with the admission plane at
    MempoolConfig's defaults, an evidence Pool, a SpeculationPlane at
    SpeculationConfig's defaults, the BlockExecutor, and ConsensusState
    at ConsensusConfig's defaults signing with the FilePV `pv`.
    start() reconciles the stores (reconcile_and_handshake) first."""

    def __init__(self, gdoc, pv, home):
        self.gdoc, self.pv, self.home = gdoc, pv, home

    async def start(self):
        from tendermint_tpu_torch.abci.client import ClientCreator
        from tendermint_tpu_torch.abci.kvstore import PersistentKVStoreApp
        from tendermint_tpu_torch.config import (ConsensusConfig,
                                                 MempoolConfig,
                                                 SpeculationConfig)
        from tendermint_tpu_torch.consensus import (ConsensusState,
                                                    SpeculationPlane)
        from tendermint_tpu_torch.consensus.replay import reconcile_and_handshake
        from tendermint_tpu_torch.consensus.wal import WAL
        from tendermint_tpu_torch.evidence import Pool
        from tendermint_tpu_torch.libs.db import FileDB, MemDB
        from tendermint_tpu_torch.mempool.clist_mempool import CListMempool
        from tendermint_tpu_torch.proxy import AppConns
        from tendermint_tpu_torch.state.execution import BlockExecutor
        from tendermint_tpu_torch.state.store import Store
        from tendermint_tpu_torch.state.txindex import (BlockIndexer,
                                                        IndexerService,
                                                        TxIndexer)
        from tendermint_tpu_torch.store import BlockStore
        from tendermint_tpu_torch.types.events import EventBus

        self.dbs = tuple(FileDB(os.path.join(self.home, f"{n}.db"))
                         for n in ("state", "blocks", "app", "evidence"))
        self.wal_path = os.path.join(self.home, "cs.wal", "wal")
        self.app = PersistentKVStoreApp(self.dbs[2])
        self.conns = AppConns(ClientCreator(app=self.app))
        await self.conns.start()
        self.ss, self.bs = Store(self.dbs[0]), BlockStore(self.dbs[1])
        self.bus = EventBus()
        self.indexer = IndexerService(TxIndexer(MemDB()), self.bus,
                                      BlockIndexer(MemDB()))
        self.indexer.start()
        t = time.perf_counter()
        self.state, self.report = await reconcile_and_handshake(
            None, self.ss, self.bs, self.gdoc, self.conns,
            event_bus=self.bus, wal_path=self.wal_path)
        self.handshake_s = time.perf_counter() - t
        self.mempool = CListMempool(MempoolConfig(), self.conns.mempool)
        self.evpool = Pool(self.dbs[3], self.ss, self.bs)
        self.plane = SpeculationPlane(SpeculationConfig())
        self.executor = BlockExecutor(self.ss, self.conns.consensus,
                                      mempool=self.mempool,
                                      evidence_pool=self.evpool,
                                      event_bus=self.bus,
                                      speculation=self.plane)
        t = time.perf_counter()
        self.cs = ConsensusState(ConsensusConfig(), self.state,
                                 self.executor, self.bs,
                                 mempool=self.mempool, evpool=self.evpool,
                                 wal=WAL(self.wal_path), event_bus=self.bus,
                                 speculation=self.plane)
        self.cs.set_priv_validator(self.pv)
        self.init_s = time.perf_counter() - t
        return self

    async def stop(self):
        if self.cs.is_running:
            await self.cs.stop()
        self.indexer.stop()
        self.mempool.close()
        await self.conns.stop()
        for db in self.dbs:
            db.close()


class CsProbe:
    """The consensus phase's measurements of one node (a fresh one after
    the restart): wraps ConsensusState's steps and the pieces of its
    receive routine, the WAL, the block store, the executor and the vote
    scheduler's tally; everything accumulates into `heights`' record of
    the height the node is at."""

    def __init__(self, node, heights: dict):
        import gc
        import inspect

        from tendermint_tpu_torch.consensus import messages as m
        from tendermint_tpu_torch.consensus.wal import EndHeightMessage

        cs = node.cs
        self.own_votes: list = []

        def rec():
            h = cs.rs.height
            if h not in heights:
                heights[h] = dict(height=h, host_us={}, msgs={}, gc_ms=0.0,
                                  t={})
            return heights[h]

        self.rec = rec

        def wrap(obj, name, before=None, timed=None):
            """Time obj.name into the height's host_us under timed(*args)
            (None: not timed); call before(*args) first (async only)."""
            real = getattr(obj, name)
            if inspect.iscoroutinefunction(real):
                async def run(*a, **kw):
                    if before:
                        before(*a)
                    t = time.perf_counter()
                    try:
                        return await real(*a, **kw)
                    finally:
                        if timed:
                            add(timed(*a), t)
            else:
                def run(*a, **kw):
                    t = time.perf_counter()
                    try:
                        return real(*a, **kw)
                    finally:
                        if timed:
                            add(timed(*a), t)
            setattr(obj, name, run)

        def add(key, t0):
            if key is None:
                return
            r = rec()
            us = (time.perf_counter() - t0) * 1e6
            r["host_us"][key] = r["host_us"].get(key, 0.0) + us
            r["msgs"][key] = r["msgs"].get(key, 0) + 1

        def stamp(key):
            r = rec()
            r["t"].setdefault(key, time.perf_counter())

        def new_round(h, round_):
            if round_ == 0:
                stamp("new_height")

        def msg_kind(qm):
            return "handle_" + {m.VoteMessage: "vote",
                                m.ProposalMessage: "proposal",
                                m.BlockPartMessage: "part"}.get(
                                    type(qm.msg), "other")

        def wal_kind(msg, *_):
            return "wal_end_height_fsync" if isinstance(
                msg, EndHeightMessage) else None

        real_commit = cs._commit_height

        async def commit_height(h):
            r = rec()
            r["t"]["commit_start"] = time.perf_counter()
            await real_commit(h)
            r["t"]["committed"] = time.perf_counter()

        cs._commit_height = commit_height
        wrap(cs, "_enter_new_round", before=new_round)
        wrap(cs, "_proposal_completed", before=lambda: stamp("proposal"))
        wrap(cs, "_handle_msg", timed=msg_kind)
        wrap(cs.wal, "write", timed=lambda *a: "wal_write")
        wrap(cs.wal, "write_sync", timed=wal_kind)
        wrap(node.bs, "save_block", timed=lambda *a: "save_block")
        wrap(node.executor, "apply_block", timed=lambda *a: "apply_block")
        wrap(cs.scheduler, "_tally", timed=lambda *a: "tally")

        def step_hook(event, payload):
            if event == "step":
                stamp(f"step_{int(payload.step)}_r{payload.round}")
            elif event == "vote" and \
                    payload.validator_address == cs.priv_validator_address:
                self.own_votes.append((payload.height, payload.round,
                                       int(payload.type),
                                       payload.block_id is None))

        cs.broadcast_hooks.append(step_hook)
        self.gc_start: list = []

        def gc_pause(phase, info):
            if phase == "start":
                self.gc_start.append(time.perf_counter())
            elif self.gc_start:
                r = rec()
                r["gc_ms"] += (time.perf_counter() - self.gc_start.pop()) * 1e3

        self.gc_pause = gc_pause
        gc.callbacks.append(gc_pause)

    def close(self):
        import gc

        gc.callbacks.remove(self.gc_pause)


def cs_batch_probe(batches: list, sites: "CsSites"):
    """Record every vote batch batch_verdicts verifies: its group sizes
    (one group a validator set), its kernel launches and its ms (the scheduler calls the
    module's function). Returns the function that undoes it."""
    from tendermint_tpu_torch.consensus import state as cstate

    real = cstate.batch_verdicts

    def probe(batch, chain_id):
        k0 = exec_counts()
        t = time.perf_counter()
        groups: dict = {}
        for _vote, _peer, _pk, vals in batch:
            groups[id(vals)] = groups.get(id(vals), 0) + 1
        try:
            return sites.tagged("votes", real)(batch, chain_id)
        finally:
            batches.append(dict(groups=list(groups.values()),
                                height=max(v.height for v, *_ in batch),
                                ms=(time.perf_counter() - t) * 1e3,
                                launches=exec_delta(k0)))

    cstate.batch_verdicts = probe
    return lambda: setattr(cstate, "batch_verdicts", real)


async def cs_until(cond, node, what: str, timeout: float = 120.0):
    """Poll cond() every 5 ms; raise the node's fault, or on the time
    limit."""
    import asyncio

    t = time.perf_counter()
    while not cond():
        if node.cs.fault is not None:
            raise node.cs.fault
        if time.perf_counter() - t > timeout:
            raise AssertionError(f"consensus: timed out waiting for {what} "
                                 f"(at {node.cs.rs.height}/{node.cs.rs.round} "
                                 f"step {int(node.cs.rs.step)})")
        await asyncio.sleep(0.005)


async def cs_deliver(node, raws, rng, rec, key: str, first=()):
    """The peers' messages (key index, wire bytes) as a reactor hands
    them over: `first` in order, then the rest shuffled, in bursts of
    CS_BURST from CS_PEERS peer ids (a key's peer is its index mod
    CS_PEERS); each decoded by decode_consensus_msg and admitted through
    add_peer_msg. Records the decode time and the last delivery."""
    import asyncio

    from tendermint_tpu_torch.consensus.messages import decode_consensus_msg

    order = list(first) + [raws[i] for i in rng.permutation(len(raws))]
    rec["t"][f"first_{key}"] = time.perf_counter()
    t_dec = 0.0
    i = 0
    while i < len(order):
        n = int(rng.integers(CS_BURST[0], CS_BURST[1] + 1))
        for k, raw in order[i:i + n]:
            if not node.cs.is_running:
                break  # halted: a reactor drops what it cannot hand over
            t = time.perf_counter()
            msg = decode_consensus_msg(raw)
            t_dec += time.perf_counter() - t
            await node.cs.add_peer_msg(msg, f"peer-{k % CS_PEERS}")
        i += n
        await asyncio.sleep(0)
    rec["host_us"]["decode"] = rec["host_us"].get("decode", 0.0) + t_dec * 1e6
    rec["msgs"]["decode"] = rec["msgs"].get("decode", 0) + len(order)
    rec["t"][f"delivered_{key}"] = time.perf_counter()


def cs_txs(h: int, signers):
    """Height h's txs: CS_ENVELOPES signed envelopes, CS_RAW raw."""
    from tendermint_tpu_torch.types import tx_envelope

    envs = [tx_envelope.sign_tx(signers[i], b"cs%d-env%d=%d" % (h, i, h * i))
            for i in range(CS_ENVELOPES)]
    return envs, [b"cs%d-raw%d=%d" % (h, i, i) for i in range(CS_RAW)]


def cs_split(r: dict) -> dict:
    """A height from NewHeight to its commit: each mark's offset from
    NewHeight (ms), the commit's own steps, and the timeout_commit wait
    that follows."""
    t = r["t"]
    cr = r.get("commit_round") or 0
    t0 = t.get("new_height")

    def at(key):
        return (t[key] - t0) * 1e3 if key in t and t0 is not None else None

    def gap(a, b):
        return (t[b] - t[a]) * 1e3 if a in t and b in t else None

    hu = r["host_us"]
    # RoundStep.PRECOMMIT (6) is entered on +2/3 prevotes for the block,
    # RoundStep.COMMIT (8) on +2/3 precommits
    pc, cm = f"step_6_r{cr}", f"step_8_r{cr}"
    return dict(
        offsets_ms=dict(proposal_complete=at("proposal"),
                        first_prevote_handed=at("first_prevotes"),
                        prevotes_23=at(pc),
                        last_prevote_handed=at("delivered_prevotes"),
                        first_precommit_handed=at("first_precommits"),
                        precommits_23=at(cm),
                        last_precommit_handed=at("delivered_precommits"),
                        committed=at("committed"), halted=at("halted")),
        prevotes_23_after_last_handed_ms=gap("delivered_prevotes", pc),
        precommits_23_after_last_handed_ms=gap("delivered_precommits", cm),
        commit_ms=gap("commit_start", "committed"),
        save_block_ms=hu.get("save_block", 0.0) / 1e3,
        end_height_fsync_ms=hu.get("wal_end_height_fsync", 0.0) / 1e3,
        apply_block_ms=hu.get("apply_block", 0.0) / 1e3,
        timeout_commit_wait_ms=r.get("timeout_commit_wait_ms"))


class CsSites:
    """Which step of the node each K3 and K4 launch served: a thread-local
    tag set by the vote batches (batch_verdicts), the speculation plane's
    commit-time serve (its re-verified misses), ValidatorSet.verify_commit
    (a LastCommit the plane did not serve) and ConsensusState.
    reconstruct_last_commit; untagged K4 launches are the admission
    plane's. Records each K3 call (ExpandedKeys.verify_structured / verify)
    and K4 call (verify.general_verify) with its tag, each verify_commit's
    height and whether it came before or after the restart, and each
    speculative flush's lanes (the flusher's _launch_batch) and whether
    it clears the plane's device crossover."""

    def __init__(self):
        import threading

        self.local = threading.local()
        self.k3: list = []
        self.k4: list = []
        self.commit_checks: list = []
        self.flushes: list = []  # the plane's launches: (lanes, on the device)
        self.stage = "before"
        self._undo: list = []

    def site(self) -> str:
        return getattr(self.local, "site", None) or "other"

    def tagged(self, name, fn):
        def run(*a, **kw):
            prev = getattr(self.local, "site", None)
            self.local.site = name
            try:
                return fn(*a, **kw)
            finally:
                self.local.site = prev
        return run

    def _patch(self, obj, attr, fn) -> None:
        self._undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, fn)

    def install(self) -> None:
        from tendermint_tpu_torch.consensus import state as cstate
        from tendermint_tpu_torch.consensus.speculation import SpeculationPlane
        from tendermint_tpu_torch.crypto.cuda import expanded, verify
        from tendermint_tpu_torch.types.validator_set import ValidatorSet

        E = expanded.ExpandedKeys
        real_vs, real_v = E.verify_structured, E.verify
        real_k4 = verify.general_verify
        real_vc = ValidatorSet.verify_commit
        real_launch = SpeculationPlane._launch_batch

        def structured(this, lanes, msgs, sigs):
            self.k3.append((self.site(), type(msgs).__name__, len(lanes)))
            return real_vs(this, lanes, msgs, sigs)

        def rows(this, lanes, msgs, sigs):
            self.k3.append((self.site(), "bytes", len(lanes)))
            return real_v(this, lanes, msgs, sigs)

        sites = self

        class K4:
            """verify.general_verify, recording each call's tag; its
            launch count stays the wrapper's own."""

            launches = property(
                lambda _: real_k4.launches,
                lambda _, n: setattr(real_k4, "launches", n))

            def __call__(self, *a, **kw):
                sites.k4.append((sites.site(), int(a[0].shape[0])))
                return real_k4(*a, **kw)

        def verify_commit(this, chain_id, block_id, height, commit):
            self.commit_checks.append((self.stage, height))
            return real_vc(this, chain_id, block_id, height, commit)

        def launch(plane, entry, batch):
            self.flushes.append((len(batch), len(batch) >= plane.device_min))
            return real_launch(plane, entry, batch)

        self._patch(E, "verify_structured", structured)
        self._patch(E, "verify", rows)
        self._patch(verify, "general_verify", K4())
        self._patch(ValidatorSet, "verify_commit",
                    self.tagged("commit", verify_commit))
        self._patch(cstate.ConsensusState, "reconstruct_last_commit",
                    self.tagged("reconstruct",
                                cstate.ConsensusState.reconstruct_last_commit))
        self._patch(SpeculationPlane, "serve_commit",
                    self.tagged("serve", SpeculationPlane.serve_commit))
        self._patch(SpeculationPlane, "_launch_batch", launch)

    def uninstall(self) -> None:
        for obj, attr, fn in reversed(self._undo):
            setattr(obj, attr, fn)
        self._undo.clear()

    def count(self, kind: str, site: str) -> int:
        return sum(1 for x in (self.k3 if kind == "k3" else self.k4)
                   if x[0] == site)


async def cs_material(probe, pending, material_of):
    """Await the peers' material for the node's current height; record
    the wait (the part the node's loop did not hide) and the child's own
    build and signing seconds."""
    t = time.perf_counter()
    material = await material_of(pending)
    parts = [material, material.get("nil") or {}, material.get("round1") or {}]
    probe.rec()["peers"] = dict(
        wait_ms=(time.perf_counter() - t) * 1e3,
        build_s=sum(m.get("build_s", 0.0) for m in parts),
        sign_s=sum(m.get("sign_s", 0.0) for m in parts))
    return material


def consensus_phase():
    """The consensus state machine on the card (docstring, phase 15).
    Returns the phase's record."""
    import asyncio
    import shutil
    import tempfile

    import numpy as np
    import torch

    from tendermint_tpu_torch.consensus.cstypes import RoundStep
    from tendermint_tpu_torch.libs import failpoints
    from tendermint_tpu_torch.mempool import admission
    from tendermint_tpu_torch.privval import FilePV
    from tendermint_tpu_torch.state import make_genesis_state
    from tendermint_tpu_torch.state.store import _STATE_KEY
    from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence

    t0 = time.perf_counter()
    peers = CsPeers(CS_PEERS_ARGV)
    home = tempfile.mkdtemp(prefix="cs-node-")
    try:
        pubs = peers.first["pubs"]
        gdoc = cs_genesis(pubs)
        vals = make_genesis_state(gdoc).validators
        addr_key = {}
        from tendermint_tpu_torch.crypto.ed25519 import (Ed25519PrivKey,
                                                         Ed25519PubKey)

        for k, p in enumerate(pubs):
            addr_key[Ed25519PubKey(p).address()] = k

        def proposer(h: int, round_: int) -> int:
            vs = vals.copy()
            if h - 1 + round_:
                vs.increment_proposer_priority(h - 1 + round_)
            return addr_key[vs.get_proposer().address]

        node_k = proposer(CS_OWN_H, 0)
        silent, r1 = proposer(CS_SILENT_H, 0), proposer(CS_SILENT_H, 1)
        others = [k for k in range(CS_VALIDATORS) if k != node_k]
        forge, equivocate = others[17], others[29]
        if node_k in (silent, r1) or any(
                proposer(h, 0) == node_k for h in range(1, CS_HEIGHTS + 1)
                if h != CS_OWN_H):
            raise AssertionError("the node proposes at a height it must not")
        key_path = os.path.join(home, "pv_key.json")
        state_path = os.path.join(home, "pv_state.json")
        pv = FilePV(Ed25519PrivKey(cs_seed(node_k)), key_path, state_path)
        pv.save_key()
        signers = adm_signers(CS_ENVELOPES)
        setup_s = time.perf_counter() - t0
        kernels = wrappers()
        for fn in kernels.values():
            fn.launches = 0
        heights: dict = {}
        batches: list = []
        sites = CsSites()
        reporter = PeerReporter()
        adm0 = metrics_view("admission")
        rng = np.random.default_rng(15)
        out: dict = {"node_key": node_k, "setup_s": setup_s,
                     "peer_keys_s": peers.first["keys_s"]}

        async def drive(node, probe, h, material, crash=False):
            """One height from NewHeight to its commit (or, `crash`, to the
            halt the armed failpoint causes)."""
            cs = node.cs
            await cs_until(lambda: cs.rs.height == h and
                           cs.rs.step >= RoundStep.PROPOSE, node,
                           f"NewHeight {h}")
            rec = probe.rec()
            if "txs" in material:
                k0 = exec_counts()
                t = time.perf_counter()
                envs, raw = material["txs"]
                res = []
                for txs in (envs, raw):
                    res += await asyncio.gather(*(node.mempool.check_tx(tx)
                                                  for tx in txs))
                if any(r.code for r in res):
                    raise AssertionError(f"height {h}: a tx was refused")
                rec["check_tx_ms"] = (time.perf_counter() - t) * 1e3
                rec["check_tx_launches"] = exec_delta(k0)
                rec["mempool_size_before"] = node.mempool.size()
            if h == CS_OWN_H:
                await cs_until(lambda: cs.rs.proposal is not None and
                               cs.rs.proposal_complete(), node, "own proposal")
                bid = cs.rs.proposal.block_id
                t = time.perf_counter()
                fut = peers.submit(dict(op="votes", h=h, round=0, node=node_k,
                                        bid=cs_block_id(bid),
                                        ts=cs.rs.proposal_block.header.time
                                        + 1_000_000_000))
                material = await asyncio.wrap_future(fut)
                rec["peers"] = dict(wait_ms=(time.perf_counter() - t) * 1e3,
                                    build_s=0.0, sign_s=material["sign_s"])
                rec["proposer"] = "node"
            elif h == CS_SILENT_H:
                await cs_until(lambda: (h, 0, 1, True) in probe.own_votes,
                               node, "the nil prevote after timeout_propose")
                rec["t"]["timeout_propose"] = time.perf_counter()
                nil = material["nil"]
                await cs_deliver(node, nil["prevotes"], rng, rec, "nil_prevotes")
                await cs_deliver(node, nil["precommits"], rng, rec,
                                 "nil_precommits")
                await cs_until(lambda: cs.rs.round == 1, node, "round 1")
                material = material["round1"]
                rec["proposer"] = "peer (round 1)"
            else:
                rec["proposer"] = "peer"
            if "proposal" in material:
                pk = proposer(h, cs.rs.round)
                await cs_deliver(node, [], rng, rec, "proposal",
                                 first=[(pk, b) for b in material["proposal"]])
            await cs_deliver(node, material["prevotes"], rng, rec, "prevotes")
            if crash:
                failpoints.arm(CS_CRASH_POINT, "error")
            precommits, first = material["precommits"], []
            if material["equivocation"]:
                # the equivocating pair leads the first burst: both land
                # in the height, before its +2/3
                eq = material["equivocation"][0][0]
                first = [x for x in precommits if x[0] == eq] + \
                    material["equivocation"]
                precommits = [x for x in precommits if x[0] != eq]
            await cs_deliver(node, precommits, rng, rec, "precommits",
                             first=first)
            if crash:
                t = time.perf_counter()
                while cs.is_running and time.perf_counter() - t < 120:
                    await asyncio.sleep(0.001)
                if cs.is_running or not isinstance(
                        cs.fault, failpoints.FailpointError):
                    raise AssertionError(f"no halt at {CS_CRASH_POINT}: "
                                         f"{cs.fault!r}")
                failpoints.disarm_all()
                rec["t"]["halted"] = time.perf_counter()
                rec["fault"] = repr(cs.fault)
                return rec
            await cs_until(lambda: cs.state.last_block_height == h, node,
                           f"commit {h}")
            rec["commit_round"] = node.bs.load_seen_commit(h).round
            rec["speculation"] = dict(hits=node.plane.hits,
                                      misses={k: v for k, v in
                                              node.plane.misses.items() if v})
            rec.update(app_hash=cs.state.app_hash.hex(),
                       last_results_hash=cs.state.last_results_hash.hex(),
                       block_hash=node.bs.load_block_meta(h).header.hash().hex(),
                       state_db=db_digest(node.dbs[0]),
                       txs=len(node.bs.load_block(h).data.txs),
                       mempool_size_after=node.mempool.size())
            return rec

        def request(node, h):
            """Height h's material from the peers, asked for as soon as h-1
            is committed (the state and the seen commit are then known)."""
            st = node.ss.db.get(_STATE_KEY)
            lc = node.bs.load_seen_commit(h - 1)
            lcb = lc.to_bytes() if lc is not None else b""
            txs = cs_txs(h, signers) if h in CS_TX_HEIGHTS else None
            base = dict(op="build", h=h, round=0, node=node_k, state=st,
                        last_commit=lcb, txs=[*txs[0], *txs[1]] if txs else [],
                        proposer=proposer(h, 0))
            if h == CS_FORGE_H:
                base.update(forge=forge, equivocate=equivocate)
            if h == CS_OWN_H:
                return {}
            if h == CS_SILENT_H:
                nil = peers.submit(dict(op="votes", h=h, round=0, node=node_k,
                                        bid=None, ts=CS_T0 + h * 10**10))
                r1f = peers.submit(dict(base, round=1, proposer=r1))
                return {"futs": (nil, r1f)}
            fut = peers.submit(base)
            return {"fut": fut, "txs": txs}

        async def material_of(req):
            if "futs" in req:
                nil, r1f = req["futs"]
                return {"nil": await asyncio.wrap_future(nil),
                        "round1": await asyncio.wrap_future(r1f)}
            if "fut" in req:
                m = await asyncio.wrap_future(req["fut"])
                if req["txs"]:
                    m["txs"] = req["txs"]
                return m
            return {}

        async def run():
            node = await CsNode(gdoc, pv, home).start()
            probe = CsProbe(node, heights)
            node.cs.reporter_fn = lambda: reporter
            out["first_start"] = dict(handshake_s=node.handshake_s,
                                      init_s=node.init_s)
            await node.cs.start()
            pending = request(node, 1)
            with pipeline_timer(node) as acc:
                for h in range(1, CS_CRASH_H):
                    material = await cs_material(probe, pending, material_of)
                    rec = await drive(node, probe, h, material)
                    pending = request(node, h + 1)
                    rec["apply_split_ms"] = dict(acc)
                    acc.clear()
                material = await cs_material(probe, pending, material_of)
                await drive(node, probe, CS_CRASH_H, material, crash=True)
            probe.close()
            crashed = dict(fault=repr(node.cs.fault),
                           block_store=node.bs.height,
                           state=node.cs.state.last_block_height)
            await node.stop()
            # the restart: every store, the WAL and the FilePV from disk
            sites.stage = "after"
            k0 = exec_counts()
            t = time.perf_counter()
            pv2 = FilePV.load(key_path, state_path)
            node = await CsNode(gdoc, pv2, home).start()
            probe = CsProbe(node, heights)
            node.cs.reporter_fn = lambda: reporter
            await node.cs.start()
            restart = dict(crashed, handshake_s=node.handshake_s,
                           init_s=node.init_s,
                           seconds=time.perf_counter() - t,
                           repairs=[r["kind"] for r in node.report.repairs],
                           launches=exec_delta(k0),
                           state=node.cs.state.last_block_height)
            heights[CS_CRASH_H].update(
                app_hash=node.cs.state.app_hash.hex(),
                last_results_hash=node.cs.state.last_results_hash.hex(),
                block_hash=node.bs.load_block_meta(
                    CS_CRASH_H).header.hash().hex(),
                state_db=db_digest(node.dbs[0]),
                txs=len(node.bs.load_block(CS_CRASH_H).data.txs))
            with pipeline_timer(node) as acc:
                for h in range(CS_CRASH_H + 1, CS_HEIGHTS + 1):
                    material = await cs_material(probe, request(node, h),
                                                 material_of)
                    rec = await drive(node, probe, h, material)
                    rec["apply_split_ms"] = dict(acc)
                    acc.clear()
            probe.close()
            out["restart"] = restart
            ev_block = node.bs.load_block(CS_OWN_H).evidence.evidence
            evs = [(h, e) for h in range(1, CS_HEIGHTS + 1)
                   for e in node.bs.load_block(h).evidence.evidence]
            out["evidence"] = dict(
                in_blocks=[(h, type(e).__name__,
                            e.vote_a.validator_address.hex())
                           for h, e in evs],
                committed=[node.evpool.is_committed(e) for _, e in evs],
                pending=len(node.evpool.pending_evidence(-1)))
            if len(evs) != 1 or evs[0][0] != CS_OWN_H or \
                    not isinstance(ev_block[0], DuplicateVoteEvidence) or \
                    ev_block[0].vote_a.validator_address != \
                    Ed25519PubKey(pubs[equivocate]).address() or \
                    not all(out["evidence"]["committed"]):
                raise AssertionError(f"evidence: {out['evidence']}")
            lss = FilePV.load(key_path, state_path).last_sign_state
            mem = node.cs.priv_validator.last_sign_state
            out["filepv"] = dict(height=lss.height, round=lss.round,
                                 step=lss.step)
            if (lss.height, lss.round, lss.step, lss.signature) != \
                    (mem.height, mem.round, mem.step, mem.signature) or \
                    (lss.height, lss.step) != (CS_HEIGHTS, 3):
                raise AssertionError(f"FilePV state: {out['filepv']}")
            out["final_height"] = node.cs.state.last_block_height
            out["plane"] = node.plane.status_check()
            await node.stop()

        sites.install()
        undo = cs_batch_probe(batches, sites)
        t_run = time.perf_counter()
        try:
            asyncio.run(run())
        finally:
            undo()
            sites.uninstall()
            failpoints.disarm_all()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
        launches = {name: fn.launches for name, fn in kernels.items()
                    if fn.launches}
        t = time.perf_counter()
        replay = peers.call({"op": "replay",
                             "blocks": os.path.join(home, "blocks.db")})
        replay_s = time.perf_counter() - t
    finally:
        peers.close()
        shutil.rmtree(home, ignore_errors=True)
    keys = ("height", "block_hash", "app_hash", "last_results_hash",
            "state_db")
    mine = [{k: heights[h][k] for k in keys} for h in sorted(heights)
            if h <= CS_HEIGHTS]
    theirs = [{k: r[k] for k in keys} for r in replay["heights"]]
    if mine != theirs:
        raise AssertionError(f"the host replay differs: {mine} {theirs}")
    bad = {p: c for p, c in reporter.counts.items() if c[1]}
    forged_peer = f"peer-{forge % CS_PEERS}"
    if bad != {forged_peer: bad.get(forged_peer)} or bad[forged_peer][1] != 1:
        raise AssertionError(f"bad votes by peer: {reporter.counts}")
    if out["restart"]["repairs"] != ["state_reapply"] or \
            out["final_height"] != CS_HEIGHTS:
        raise AssertionError(f"restart: {out['restart']}")
    # which step each K3 and K4 launch served (CsSites)
    groups = [n for b in batches for n in b["groups"]]
    k3_votes = [n for site, _, n in sites.k3 if site == "votes"]
    before = [h for stage, h in sites.commit_checks if stage == "before"]
    after = [h for stage, h in sites.commit_checks if stage == "after"]
    adm = metrics_view("admission")["verify_launches"].get("device", 0) - \
        adm0["verify_launches"].get("device", 0)
    k4 = {site: sites.count("k4", site) for site in
          ("votes", "serve", "commit", "reconstruct", "other")}
    k3 = {site: sites.count("k3", site) for site in
          ("votes", "serve", "commit", "other")}
    device_flushes = sum(1 for _, dev in sites.flushes if dev)
    want_k4_votes = sum(1 for n in groups if 40 <= n < 128)
    want_k3_votes = sum(1 for n in groups if n >= 128)
    counted = dict(build_tables=1, xverify=len(sites.k3),
                   general_verify=len(sites.k4))
    if {k: launches.get(k, 0) for k in counted} != counted or \
            k3["votes"] != want_k3_votes or k4["votes"] != want_k4_votes or \
            k4["reconstruct"] != 1 or k4["other"] != adm or before or \
            after[:1] != [CS_CRASH_H - 1] or \
            k3["commit"] + k4["commit"] != len(after) or \
            launches.get("arena_verify", 0) != device_flushes or \
            launches.get("splice", 0) != device_flushes:
        raise AssertionError(
            f"launches {launches}, counted {counted}; K3 by step {k3} "
            f"(votes: {want_k3_votes} groups of 128+), K4 by step {k4} "
            f"(votes: {want_k4_votes} groups of 40-127, admission {adm}); "
            f"verify_commit before the restart at {before}, after at {after}; "
            f"{device_flushes} device flushes; vote groups {groups}")
    records = []
    for h in sorted(k for k in heights if k <= CS_HEIGHTS):
        r = heights[h]
        nxt = heights.get(h + 1, {}).get("t", {})
        if "committed" in r["t"] and "new_height" in nxt and \
                h != CS_CRASH_H:
            r["timeout_commit_wait_ms"] = (nxt["new_height"]
                                           - r["t"]["committed"]) * 1e3
        records.append(dict(
            height=h, proposer=r.get("proposer"), peers=r.get("peers"),
            commit_round=r.get("commit_round"), txs=r.get("txs"),
            fault=r.get("fault"), split_ms=cs_split(r),
            apply_split_ms=r.get("apply_split_ms"),
            host_us_per_msg={k: r["host_us"][k] / r["msgs"][k]
                             for k in r["host_us"]},
            msgs=r["msgs"], gc_ms=r["gc_ms"],
            check_tx_ms=r.get("check_tx_ms"),
            check_tx_launches=r.get("check_tx_launches"),
            mempool=(r.get("mempool_size_before"),
                     r.get("mempool_size_after")),
            speculation=r.get("speculation"),
            batches=[b["groups"] for b in batches if b["height"] == h],
            batch_launches=[b["launches"] for b in batches
                            if b["height"] == h and b["launches"]]))
    return dict(
        validators=CS_VALIDATORS, heights=records, run_s=run_s,
        replay=dict(seconds=replay_s, child_seconds=replay["seconds"],
                    equal=True, apply_block_ms=[r["apply_block_ms"]
                                                for r in replay["heights"]]),
        batch_sizes=dict(count=len(groups), p50=statistics.median(groups),
                         max=max(groups), under_40=sum(n < 40 for n in groups),
                         k4_40_127=want_k4_votes, k3_128_up=want_k3_votes),
        k3=dict(by_step=k3, vote_batch_lanes=k3_votes,
                verify_commit_before_restart=before,
                verify_commit_after_restart=after),
        k4=dict(by_step=k4, admission_flushes=adm,
                lanes=[n for _, n in sites.k4]),
        flushes=dict(count=len(sites.flushes), device=device_flushes,
                     p50=statistics.median([n for n, _ in sites.flushes])
                     if sites.flushes else None,
                     max=max((n for n, _ in sites.flushes), default=None)),
        forged_peer=forged_peer, peer_counts=reporter.counts,
        launches=launches, **out)


# -- phase 16: p2p ---------------------------------------------------------

P2P_CHAIN = "p2p-localnet"
P2P_SYNC_CHAIN = "p2p-fastsync"
P2P_T0 = 1_700_000_000 * 10**9
P2P_VALIDATORS = 4
P2P_HEIGHTS = 12
P2P_TX_HEIGHTS = (2, 11)  # the clients submit while their node is at [2, 11)
# A's client: bursts of 64 (one K4 admission flush each) every 640 ms,
# 100 txs a second; B's: bursts of 16, 25 a second. At 400 + 100 and at
# 200 + 50 txs a second the gossip (one tx a message, each receive
# awaiting its check_tx) fell behind, A's mempool filled and its
# proposals missed their round (PERF.md, PR 17)
P2P_BURST, P2P_BURST_S = 64, 0.640
P2P_PEER_BURST, P2P_PEER_BURST_S = 16, 0.640
P2P_SIGNERS = 64
P2P_MAVERICK_H = 5  # D (validator 3) double-prevotes here
P2P_DROP_AFTER = 8  # A's signer link drops once between 8 and 9
P2P_DRAIN_HEIGHTS = 8  # the most heights past 12 the txs may take
P2P_SYNC_VALIDATORS = 1_000
P2P_SYNC_BLOCKS = 129
P2P_SYNC_TXS = 32
P2P_SYNC_VALUE = 2_048  # each tx's value: its number, then filler
P2P_SYNC_ROUND1 = 64  # the commit of this height is made in round 1
P2P_SYNC_SERVERS = 4
P2P_FORGED_AT = 78  # its LastCommit carries one forged signature (a copy)
P2P_FORGED_SERVERS = 2
P2P_WAIT_S = 240.0
P2P_CHILD_CMD = None  # the children's command (None: this script)
# The statesync phase (17) over Part B's chain: the build's app takes a
# snapshot every SS_INTERVAL heights and keeps the last SS_KEEP (32, 64,
# 96, 128), served by four honest switches and a poisoner; a seed knows
# their addresses.
SS_INTERVAL = 32
SS_KEEP = 4
SS_POISONER_KEY = 56  # its node id sorts before the honest servers'
SS_ENSURE_S = 1.0     # the joining node's pex_ensure_period_s
SS_DISCOVERY_S = 2    # its syncer's discovery time (statesync.discovery_time_s)
# the light clients' trusting period: both chains' genesis time (P2P_T0,
# the time of their first block) is years before the card's clock
SS_TRUST_PERIOD_S = 10 * 365 * 86400
SS_POOL_WORKERS = 4   # the serving pool's LightProxy workers
SS_POOL_CLIENTS = 64  # its concurrent clients, each /commit + /validators


def p2p_key(kind: bytes, i: int = 0):
    from tendermint_tpu_torch.crypto.ed25519 import Ed25519PrivKey

    return Ed25519PrivKey(hashlib.sha256(b"p2p-%s-%d" % (kind, i)).digest())


def p2p_genesis(chain_id: str, pubs):
    from tendermint_tpu_torch.crypto.ed25519 import Ed25519PubKey
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    gdoc = GenesisDoc(chain_id=chain_id, genesis_time=P2P_T0,
                      validators=[GenesisValidator(Ed25519PubKey(p), 10)
                                  for p in pubs])
    gdoc.validate_and_complete()
    return gdoc


async def p2p_until(cond, what: str, timeout: float = P2P_WAIT_S,
                    fault=None):
    """Poll `cond` every 10 ms; re-raise what halted a node (`fault()`)."""
    import asyncio

    deadline = time.perf_counter() + timeout
    while not cond():
        exc = fault() if fault is not None else None
        if exc is not None:
            raise exc
        if time.perf_counter() > deadline:
            raise AssertionError(f"p2p: timed out waiting for {what}")
        await asyncio.sleep(0.01)


class P2pNode:
    """A port node of Part B's fast syncs (docstring, phase 16), wired
    through a Switch and a Transport on 127.0.0.1: the kvstore app behind
    AppConns, the state and block stores and an evidence Pool over
    MemDBs, a BlockExecutor, ConsensusState at ConsensusConfig's
    defaults, and the consensus (waiting for the sync), blockchain
    (syncing) and evidence reactors. No key, no mempool."""

    CHANNELS = bytes([0x20, 0x21, 0x22, 0x23, 0x30, 0x38, 0x40])

    def __init__(self, gdoc, name: str):
        from tendermint_tpu_torch.p2p.key import NodeKey

        self.gdoc, self.name = gdoc, name
        self.node_key = NodeKey(p2p_key(b"node-" + name.encode()))
        self.cs = self.switch = None

    async def start(self):
        from tendermint_tpu_torch.abci.client import ClientCreator
        from tendermint_tpu_torch.abci.kvstore import PersistentKVStoreApp
        from tendermint_tpu_torch.blockchain.reactor import BlockchainReactor
        from tendermint_tpu_torch.config import ConsensusConfig
        from tendermint_tpu_torch.consensus.reactor import ConsensusReactor
        from tendermint_tpu_torch.consensus.replay import \
            handshake_and_load_state
        from tendermint_tpu_torch.consensus.state import ConsensusState
        from tendermint_tpu_torch.evidence import Pool
        from tendermint_tpu_torch.evidence.reactor import EvidenceReactor
        from tendermint_tpu_torch.libs.db import MemDB
        from tendermint_tpu_torch.p2p.node_info import NodeInfo
        from tendermint_tpu_torch.p2p.switch import Switch
        from tendermint_tpu_torch.p2p.transport import Transport
        from tendermint_tpu_torch.proxy import AppConns
        from tendermint_tpu_torch.state.execution import BlockExecutor
        from tendermint_tpu_torch.state.store import Store
        from tendermint_tpu_torch.store import BlockStore

        self.dbs = (MemDB(), MemDB(), MemDB(), MemDB())
        self.app = PersistentKVStoreApp(self.dbs[2])
        self.conns = AppConns(ClientCreator(app=self.app))
        await self.conns.start()
        self.ss, self.bs = Store(self.dbs[0]), BlockStore(self.dbs[1])
        state = await handshake_and_load_state(None, self.ss, self.bs,
                                               self.gdoc, self.conns)
        self.evpool = Pool(self.dbs[3], self.ss, self.bs)
        self.executor = BlockExecutor(self.ss, self.conns.consensus,
                                      evidence_pool=self.evpool)
        self.cs = ConsensusState(ConsensusConfig(), state, self.executor,
                                 self.bs, evpool=self.evpool)
        self.reactor = ConsensusReactor(self.cs, wait_sync=True)
        self.bc_reactor = BlockchainReactor(
            state, self.executor, self.bs, fast_sync=True,
            consensus_reactor=self.reactor)
        holder = {}

        def ni():
            t = holder["transport"]
            return NodeInfo(node_id=self.node_key.id,
                            listen_addr=t.listen_addr if t._server else "",
                            network=self.gdoc.chain_id, moniker=self.name,
                            channels=bytes(sorted(
                                set(self.CHANNELS) |
                                set(self.switch.channel_ids()))))

        transport = Transport(self.node_key, ni)
        holder["transport"] = transport
        self.switch = Switch(transport, ni)
        self.switch.add_reactor("consensus", self.reactor)
        self.switch.add_reactor("blockchain", self.bc_reactor)
        self.switch.add_reactor("evidence", EvidenceReactor(self.evpool))
        await transport.listen("127.0.0.1", 0)
        await self.switch.start()
        return self

    def fault(self):
        return self.switch.fault or self.cs.fault

    async def dial(self, addr: str, persistent: bool = True) -> None:
        if persistent:
            self.switch.add_persistent_peers([addr])
        await self.switch.dial_peer(addr, persistent=persistent)

    async def stop(self) -> None:
        if self.cs is not None and self.cs.is_running:
            await self.cs.stop()
        if self.switch is not None and self.switch.is_running:
            await self.switch.stop()
        await self.conns.stop()
        for db in self.dbs:
            db.close()


def store_chain(bs, hi: int) -> list:
    """(block hash, app hash, last_results_hash) at heights 1..hi."""
    out = []
    for h in range(1, hi + 1):
        b = bs.load_block(h)
        out.append((b.hash().hex(), b.header.app_hash.hex(),
                    b.header.last_results_hash.hex()))
    return out


def node_fault(node):
    """What halted a Node (its switch's fault, its state machine's)."""
    return node.switch.fault or node.consensus_state.fault


def free_ports(n: int) -> list:
    """`n` distinct free ports on 127.0.0.1 (all held until all are
    chosen)."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for sk in socks:
            sk.bind(("127.0.0.1", 0))
        return [sk.getsockname()[1] for sk in socks]
    finally:
        for sk in socks:
            sk.close()


def p2p_config(home: str, name: str):
    """A localnet node's Config (BASELINE.json config #1, `make
    localnet`): ConsensusConfig's defaults, the merkle-kvstore app, a
    strict admission plane (every tx a signed envelope) at
    MempoolConfig's defaults, FileDB stores under `home`, p2p
    and RPC on 127.0.0.1 ports from the OS, no PEX (persistent peers),
    broadcast_tx_commit waiting up to P2P_WAIT_S."""
    from tendermint_tpu_torch.config import Config

    cfg = Config()
    cfg.base.home = home
    cfg.base.moniker = name
    cfg.base.fast_sync = False
    cfg.base.proxy_app = "merkle-kvstore"
    cfg.base.db_backend = "filedb"
    cfg.mempool.admission = "strict"
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.pex = False
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    # a tx gossiped one a message may wait out a backlog of heights
    cfg.rpc.timeout_broadcast_tx_commit_ms = int(P2P_WAIT_S * 1000)
    return cfg


def p2p_home(cfg, gdoc, node_key):
    """Write a node's home as `testnet` does (config.toml, genesis.json,
    node_key.json) and load its Config back from the file."""
    from tendermint_tpu_torch.config import Config
    from tendermint_tpu_torch.p2p.key import NodeKey

    path = cfg.base.resolve("config/config.toml")
    cfg.save(path)
    gdoc.save(cfg.base.resolve(cfg.base.genesis_file))
    NodeKey(node_key).save(cfg.base.resolve(cfg.base.node_key_file))
    return Config.load(path)


class TimedRpc:
    """An HTTPClient (rpc/jsonrpc.py) that records each call's ms by
    route into `record`."""

    def __init__(self, port: int, record: dict):
        from tendermint_tpu_torch.rpc.jsonrpc import HTTPClient

        self.http = HTTPClient("127.0.0.1", port, timeout=60.0)
        self.host, self.port = "127.0.0.1", port
        self.record = record

    async def call(self, method: str, **params):
        t = time.perf_counter()
        try:
            return await self.http.call(method, **params)
        finally:
            self.record.setdefault(method, []).append(
                (time.perf_counter() - t) * 1e3)


def _b64(b: bytes) -> str:
    import base64

    return base64.b64encode(b).decode()



class P2pChild:
    """A child of the p2p phase (`--phase <phase> <args>`): pickled frames
    on its stdin and stdout (cs_frame_write, cs_frame_read)."""

    def __init__(self, phase: str, *args):
        cmd = P2P_CHILD_CMD or [sys.executable, os.path.abspath(__file__)]
        self.proc = subprocess.Popen([*cmd, "--phase", phase,
                                      *map(str, args)],
                                     stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE)

    def send(self, obj) -> None:
        cs_frame_write(self.proc.stdin, obj)

    def read(self):
        return cs_frame_read(self.proc.stdout)

    async def aread(self, timeout: float = P2P_WAIT_S):
        import asyncio

        loop = asyncio.get_running_loop()
        return await asyncio.wait_for(loop.run_in_executor(None, self.read),
                                      timeout)

    def close(self) -> None:
        try:
            if self.proc.poll() is None:
                self.send({"op": "exit"})
                self.proc.wait(timeout=30)
        except Exception:  # noqa: BLE001 - the child is killed below
            pass
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()


def p2p_host_only() -> None:
    """A child's nodes verify on the host: crypto.batch's host route
    forced and the admission collector on its host oracle."""
    from tendermint_tpu_torch.crypto import batch as cbatch
    from tendermint_tpu_torch.mempool import admission

    cbatch.set_force_host(True)
    real_init = admission.AdmissionCollector.__init__

    def host_collector(self, *a, **kw):
        real_init(self, *a, **kw)
        self.device_threshold = 10**9

    admission.AdmissionCollector.__init__ = host_collector


async def p2p_submit(rpc, tag: bytes, burst: int, every_s: float,
                     height_of, signers,
                     heights=P2P_TX_HEIGHTS) -> tuple[list, list]:
    """A client: bursts of `burst` signed envelopes (kvstore txs), each by
    concurrent broadcast_tx_sync over `rpc` (one HTTP request a tx),
    every `every_s` while the node is at a height in `heights` [lo, hi).
    The txs the node answered, and every answer's code (an RPC error's
    class and code where the request was refused)."""
    import asyncio

    from tendermint_tpu_torch.types import tx_envelope

    lo, hi = heights
    while height_of() < lo:
        await asyncio.sleep(0.01)
    txs, codes = [], []
    nxt = time.perf_counter()
    while height_of() < hi:
        batch = [tx_envelope.sign_tx(signers[(len(txs) + j) % len(signers)],
                                     b"%s%06d=%d" % (tag, len(txs) + j, j))
                 for j in range(burst)]
        res = await asyncio.gather(*(rpc.call("broadcast_tx_sync",
                                              tx=_b64(tx)) for tx in batch),
                                   return_exceptions=True)
        for tx, r in zip(batch, res):
            if isinstance(r, Exception):  # refused (mempool busy, ...)
                codes.append(f"{type(r).__name__}:{getattr(r, 'code', '')}")
            else:
                txs.append(tx)
                codes.append(r["code"])
        nxt += every_s
        await asyncio.sleep(max(0.0, nxt - time.perf_counter()))
    return txs, codes


async def p2p_commit_txs(rpc, height_of, signer) -> tuple[list, list]:
    """One broadcast_tx_commit a height while the node is at a height in
    P2P_TX_HEIGHTS: the txs, and (height asked at, height committed,
    CheckTx code, DeliverTx code) for each."""
    import asyncio

    from tendermint_tpu_torch.types import tx_envelope

    lo, hi = P2P_TX_HEIGHTS
    txs, res = [], []
    h = lo
    while True:
        while height_of() < h:
            await asyncio.sleep(0.01)
        at = height_of()
        if at >= hi:
            return txs, res
        tx = tx_envelope.sign_tx(signer, b"commit-%06d=%d" % (at, at))
        r = await rpc.call("broadcast_tx_commit", tx=_b64(tx))
        txs.append(tx)
        res.append((at, int(r["height"]), r["check_tx"]["code"],
                    r["deliver_tx"].get("code")))
        h = at + 1


def p2p_peers_child(a_addr: str, i: int) -> int:
    """Validator `i` (1-3) of the localnet (`--phase p2p_peers <A's
    address> <i>`): a port Node (stores in memory, RPC on), forced to
    the host, one a process as a localnet's validators are; D (3)
    double-prevotes at P2P_MAVERICK_H (consensus/misbehavior.py
    DoublePrevote). Frames on stdin/stdout: `up` (its p2p address and
    RPC port) once started; on `dial` it dials A and the given
    addresses as persistent peers, `ready` once it has its three peers;
    on `go` B's (1) client submits over B's RPC; on `txs`, once that
    client is done, its txs and codes (none for C and D); on `stop` (a
    height) its chain to it and any fault."""
    import asyncio
    import shutil
    import tempfile

    from tendermint_tpu_torch.consensus.misbehavior import DoublePrevote
    from tendermint_tpu_torch.node import Node
    from tendermint_tpu_torch.p2p.key import NodeKey
    from tendermint_tpu_torch.types.priv_validator import MockPV

    p2p_host_only()
    keys = [p2p_key(b"val", k) for k in range(P2P_VALIDATORS)]
    gdoc = p2p_genesis(P2P_CHAIN, [k.pub_key().bytes() for k in keys])
    inp, out = sys.stdin.buffer, sys.stdout.buffer
    home = tempfile.mkdtemp(prefix="p2p-peer-")

    async def run():
        loop = asyncio.get_running_loop()

        async def frame():
            return await loop.run_in_executor(None, cs_frame_read, inp)

        name = f"val{i}"
        node = Node(p2p_config(home, name), priv_validator=MockPV(keys[i]),
                    node_key=NodeKey(p2p_key(b"node-" + name.encode())),
                    genesis_doc=gdoc, in_memory=True)
        if i == P2P_VALIDATORS - 1:
            node.misbehaviors[P2P_MAVERICK_H] = DoublePrevote()
        await node.start()
        cs_frame_write(out, {"op": "up", "addr": node.p2p_addr,
                             "rpc": node.rpc_port})
        for other in [a_addr] + (await frame())["addrs"]:
            node.switch.add_persistent_peers([other])
            await node.switch.dial_peer(other, persistent=True)
        await p2p_until(lambda: node.switch.n_peers() == P2P_VALIDATORS - 1,
                        f"{name}'s three peers",
                        fault=lambda: node_fault(node))
        cs_frame_write(out, {"op": "ready"})
        await frame()  # go
        client = None
        if i == 1:
            client = loop.create_task(p2p_submit(
                TimedRpc(node.rpc_port, {}), b"b-", P2P_PEER_BURST,
                P2P_PEER_BURST_S, lambda: node.consensus_state.rs.height,
                adm_signers(P2P_SIGNERS)))
        await frame()  # txs
        try:
            txs, codes = (await client) if client is not None else ([], [])
            rep = {"op": "txs", "txs": txs, "codes": codes}
        except Exception as e:  # noqa: BLE001 - reported to the parent
            rep = {"op": "txs", "error": repr(e)}
        cs_frame_write(out, rep)
        req = await frame()  # stop
        faults = [repr(node_fault(node))] if node_fault(node) else []
        try:
            await node.consensus_state.wait_for_height(req["upto"],
                                                       timeout=60)
            rep = {"op": "chains",
                   "chains": [store_chain(node.block_store, req["upto"])],
                   "faults": faults}
        except Exception as e:  # noqa: BLE001 - reported to the parent
            rep = {"op": "chains", "error": repr(e), "faults": faults}
        cs_frame_write(out, rep)
        await frame()  # exit
        await node.stop()

    try:
        asyncio.run(run())
    finally:
        shutil.rmtree(home, ignore_errors=True)
    return 0


def p2p_clients_child(port: int) -> int:
    """A's clients (`--phase p2p_clients <A's RPC port>`), in a process
    of their own so that their signing and their HTTP and JSON work do
    not share A's event loop. Started with A's peers; on `rpc` (A's RPC
    listening) it follows A's height by its WS NewBlock events and
    answers `up` once subscribed; on `go` the burst client
    (p2p_submit) and the broadcast_tx_commit client (p2p_commit_txs)
    over A's RPC; then one `txs` frame with each client's txs and
    answers and every call's ms by route."""
    import asyncio

    from tendermint_tpu_torch.rpc.jsonrpc import WSClient

    inp, out = sys.stdin.buffer, sys.stdout.buffer

    async def run():
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, cs_frame_read, inp)  # rpc
        record: dict = {}
        rpc = TimedRpc(port, record)
        ws = WSClient("127.0.0.1", port)
        await ws.connect()
        await ws.call("subscribe", query="tm.event='NewBlock'")
        st = await rpc.http.call("status")
        height = [int(st["sync_info"]["latest_block_height"]) + 1]

        async def follow():
            while True:
                d = (await ws.events.get())["result"]["data"]
                if d["type"] == "NewBlock":
                    height[0] = max(height[0],
                                    int(d["block"]["header"]["height"]) + 1)

        follower = loop.create_task(follow())
        cs_frame_write(out, {"op": "up"})
        await loop.run_in_executor(None, cs_frame_read, inp)  # go
        try:
            (a_txs, a_codes), (c_txs, c_res) = await asyncio.gather(
                p2p_submit(rpc, b"a-", P2P_BURST, P2P_BURST_S,
                           lambda: height[0], adm_signers(P2P_SIGNERS)),
                p2p_commit_txs(rpc, lambda: height[0],
                               p2p_key(b"commit-client")))
            rep = {"op": "txs", "a_txs": a_txs, "a_codes": a_codes,
                   "c_txs": c_txs, "c_res": c_res, "routes": record}
        except Exception as e:  # noqa: BLE001 - reported to the parent
            rep = {"op": "txs", "error": repr(e)}
        finally:
            follower.cancel()
            ws.close()
        cs_frame_write(out, rep)
        await loop.run_in_executor(None, cs_frame_read, inp)  # exit

    asyncio.run(run())
    return 0


def p2p_signer_child(port: int, home: str) -> int:
    """A's remote signer (`--phase p2p_signer <port> <home>`): the FilePV
    under `home` behind a SignerServer that dials A's SignerClient on
    127.0.0.1:<port> over a SecretConnection and redials whenever the
    link drops, as a tmkms deployment does. Runs until terminated, or
    until its stdin closes (the parent is gone)."""
    import asyncio
    import threading

    from tendermint_tpu_torch.privval import FilePV, SignerServer

    def orphaned():
        sys.stdin.buffer.read()
        os._exit(0)

    threading.Thread(target=orphaned, daemon=True).start()

    pv = FilePV.load(os.path.join(home, "pv_key.json"),
                     os.path.join(home, "pv_state.json"))
    server = SignerServer(pv, P2P_CHAIN, conn_key=p2p_key(b"signer-link"),
                          expected_node_addr=p2p_key(
                              b"node-link").pub_key().address())
    asyncio.run(server.dial_and_serve("127.0.0.1", port, retries=None,
                                      retry_delay=0.2))
    return 0


async def p2p_localnet(home: str) -> dict:
    """Part A of the p2p phase: A (validator 0) on the card, a Node built
    by Node.default_new_node from its home directory with its key in the
    signer child, validators 1-3 each a Node in a peers child; 12
    heights, txs over RPC."""
    import asyncio
    import collections

    from tendermint_tpu_torch.mempool import admission
    from tendermint_tpu_torch.node import Node
    from tendermint_tpu_torch.p2p.conn import connection
    from tendermint_tpu_torch.p2p.key import NodeKey
    from tendermint_tpu_torch.privval import FilePV
    from tendermint_tpu_torch.rpc.jsonrpc import WSClient

    keys = [p2p_key(b"val", i) for i in range(P2P_VALIDATORS)]
    gdoc = p2p_genesis(P2P_CHAIN, [k.pub_key().bytes() for k in keys])
    pv_home = os.path.join(home, "signer")
    os.makedirs(pv_home)
    FilePV(keys[0], os.path.join(pv_home, "pv_key.json"),
           os.path.join(pv_home, "pv_state.json")).save_key()
    signer_port, a_port, rpc_port, pprof_port, prom_port = free_ports(5)
    cfg = p2p_config(os.path.join(home, "a"), "val0")
    cfg.p2p.laddr = f"tcp://127.0.0.1:{a_port}"
    cfg.rpc.laddr = f"tcp://127.0.0.1:{rpc_port}"
    # A's debug server and Prometheus listener (libs/debugsrv.py)
    cfg.rpc.pprof_laddr = f"tcp://127.0.0.1:{pprof_port}"
    cfg.instrumentation.prometheus = True
    cfg.instrumentation.prometheus_listen_addr = f"127.0.0.1:{prom_port}"
    cfg.base.priv_validator_laddr = f"tcp://127.0.0.1:{signer_port}"
    cfg.base.priv_validator_signer_id = \
        p2p_key(b"signer-link").pub_key().address().hex()
    cfg = p2p_home(cfg, gdoc, p2p_key(b"node-link"))
    signer = P2pChild("p2p_signer", signer_port, pv_home)
    # the peers start while A builds; they dial A once it listens
    a_addr = f"{NodeKey(p2p_key(b'node-link')).id}@127.0.0.1:{a_port}"
    peers = [P2pChild("p2p_peers", a_addr, i)
             for i in range(1, P2P_VALIDATORS)]
    clients = P2pChild("p2p_clients", rpc_port)
    node = Node.default_new_node(cfg)
    ws = None
    out: dict = {}
    routes: dict = {}
    try:
        t = time.perf_counter()
        await node._build()  # listens for the signer and waits for it
        out["build_s"] = time.perf_counter() - t
        client = node._signer_client
        client.timeout = 5.0
        cs = node.consensus_state
        # the receive routine's host time a message, by channel
        recv_us, recv_n = collections.Counter(), collections.Counter()
        on_receive = node.switch._on_peer_receive

        async def timed_receive(peer, chan_id, msg):
            t = time.perf_counter()
            try:
                await on_receive(peer, chan_id, msg)
            finally:
                recv_us[f"{chan_id:#04x}"] += (time.perf_counter() - t) * 1e6
                recv_n[f"{chan_id:#04x}"] += 1

        node.switch._on_peer_receive = timed_receive
        # the signer's round trip a signature
        sign_ms: list = []
        call = client._call

        async def timed_call(req):
            t = time.perf_counter()
            res = await call(req)
            if req["type"].startswith("sign_"):
                sign_ms.append((time.perf_counter() - t) * 1e3)
            return res

        client._call = timed_call
        # the admission flushes: lanes, and whether K4 took them
        flushes: list = []
        collector = node.mempool.admission.collector
        verify_batch = collector._verify_batch

        def timed_batch(envs):
            t = time.perf_counter()
            res = verify_batch(envs)
            flushes.append((len(envs), len(envs) >= collector.device_threshold,
                            (time.perf_counter() - t) * 1e3))
            return res

        collector._verify_batch = timed_batch
        # NewHeight (update_to_state) and commit (_enter_commit) times
        steps: dict = {}
        update_to_state = cs.update_to_state
        enter_commit = cs._enter_commit

        def timed_update(state):
            steps.setdefault(("new_height", state.last_block_height + 1),
                             time.perf_counter())
            return update_to_state(state)

        async def timed_commit(height, commit_round):
            steps.setdefault(("commit", height), time.perf_counter())
            return await enter_commit(height, commit_round)

        cs.update_to_state = timed_update
        cs._enter_commit = timed_commit
        await node.start()  # RPC, the switch, consensus (alone till peers)
        # A's route handlers timed (the server's share of each call)
        handlers: dict = {}
        time_routes(node.rpc_server, handlers)
        if node.rpc_port != rpc_port:
            raise AssertionError(f"p2p: A's RPC listens at {node.rpc_port}")
        clients.send({"op": "rpc"})  # A's RPC is up

        def fault():
            return node_fault(node)

        if node.p2p_addr != a_addr:
            raise AssertionError(f"p2p: A listens at {node.p2p_addr}")
        ups = [await p.aread() for p in peers]
        for k, p in enumerate(peers):
            p.send({"op": "dial", "addrs": [u["addr"] for u in ups[k + 1:]]})
        for p in peers:
            await p.aread()  # ready
        node.switch.add_persistent_peers([u["addr"] for u in ups])
        await p2p_until(lambda: node.switch.n_peers() == P2P_VALIDATORS - 1,
                        "A's three peers", fault=fault)
        await clients.aread()  # up
        a_rpc = TimedRpc(node.rpc_port, routes)
        b_rpc = TimedRpc(ups[0]["rpc"], {})
        ws = WSClient("127.0.0.1", node.rpc_port)
        await ws.connect()
        for q in ("tm.event='NewBlock'", "tm.event='Tx'"):
            await ws.call("subscribe", query=q)
        events: list = []

        async def drain():
            while True:
                events.append(await ws.events.get())

        loop = asyncio.get_running_loop()
        drainer = loop.create_task(drain())
        # A's indexer backlog: the most Tx events waiting in its queue
        backlog = [0]

        async def sample_backlog():
            q = node.indexer_service._sub.queue
            while True:
                backlog[0] = max(backlog[0], q.qsize())
                await asyncio.sleep(0.01)

        sampler = loop.create_task(sample_backlog())
        net0 = metrics_view("p2p")
        adm0 = metrics_view("admission")
        from tendermint_tpu_torch.libs.metrics import tpu_metrics

        ledger0 = tpu_metrics().launch_ledger_records.value(
            workload="admission", backend="gpu")
        k0 = exec_counts()
        for p in peers + [clients]:
            p.send({"op": "go"})
        t_run = time.perf_counter()
        steps.setdefault(("new_height", 1), t_run)
        # the signer link drops once after height P2P_DROP_AFTER commits
        await cs.wait_for_height(P2P_DROP_AFTER, timeout=P2P_WAIT_S)
        # A's own trace of the last 10 s, mid-run, from its debug server
        trace = json.loads(await http_get(
            node.pprof_port, "/debug/trace?seconds=10"))
        t = time.perf_counter()
        client._link.close()
        lost = None
        try:
            await client.ping()
        except Exception as e:  # noqa: BLE001 - the drop is the point
            lost = f"{type(e).__name__}: {e}"
        await p2p_until(lambda: not client._conn_q.empty(),
                        "the signer's redial", fault=fault)
        await client.ping()
        out["signer_drop"] = dict(at_height=cs.rs.height, lost=lost,
                                  readopt_ms=(time.perf_counter() - t) * 1e3)
        await cs.wait_for_height(P2P_HEIGHTS, timeout=P2P_WAIT_S)
        mempool_at_12 = node.mempool.size()
        a_rep = await clients.aread()
        if "error" in a_rep:
            raise AssertionError(f"p2p: A's clients: {a_rep['error']}")
        a_txs, a_codes = a_rep["a_txs"], a_rep["a_codes"]
        c_txs, c_res = a_rep["c_txs"], a_rep["c_res"]
        for r, ms in a_rep["routes"].items():
            routes.setdefault(r, []).extend(ms)
        for p in peers:
            p.send({"op": "txs"})
        b_rep, *others = [await p.aread() for p in peers]
        if "error" in b_rep or any(r.get("txs") for r in others):
            raise AssertionError(f"p2p: B's client: {b_rep.get('error')}")
        # every tx committed exactly once, nothing else: the gossip of
        # one tx a message may leave a backlog past height 12, which the
        # next heights' proposers drain
        submitted = collections.Counter(a_txs + c_txs + b_rep["txs"])
        committed = collections.Counter()
        top = 0
        bs = node.block_store
        while True:
            while top < bs.height:
                top += 1
                committed.update(bs.load_block(top).data.txs)
            if top >= P2P_HEIGHTS and not submitted - committed:
                break
            if top >= P2P_HEIGHTS + P2P_DRAIN_HEIGHTS:
                break
            await cs.wait_for_height(top + 1, timeout=P2P_WAIT_S)
        run_s = time.perf_counter() - t_run
        # A's FilePV (in the signer child's files) before A signs for
        # the next height (the commit timeout, 1 s, holds it back)
        lss = FilePV.load(os.path.join(pv_home, "pv_key.json"),
                          os.path.join(pv_home, "pv_state.json")
                          ).last_sign_state
        out["signer_last_sign"] = [lss.height, lss.round, lss.step]
        net1 = metrics_view("p2p")
        # the RPC of A and B, the WS stream and the light proxy, with
        # both nodes past `top` (every commit to `top` canonical)
        await cs.wait_for_height(top + 1, timeout=P2P_WAIT_S)

        async def b_past_top():
            while True:
                st = await b_rpc.call("status")
                if int(st["sync_info"]["latest_block_height"]) > top:
                    return
                await asyncio.sleep(0.05)

        await asyncio.wait_for(b_past_top(), P2P_WAIT_S)
        t = time.perf_counter()
        rpc = await p2p_rpc_checks(a_rpc, b_rpc, top, committed)
        rpc["seconds"] = time.perf_counter() - t
        drainer.cancel()
        sampler.cancel()
        rpc["indexer_backlog_max"] = backlog[0]
        rpc["ws"] = p2p_ws_checks(events, top, committed)
        t = time.perf_counter()
        rpc["light_proxy"] = await p2p_light_proxy(
            gdoc, node.rpc_port, [u["rpc"] for u in ups[:2]], a_rpc, top,
            committed, routes)
        rpc["light_proxy"]["seconds"] = time.perf_counter() - t
        rpc["routes_p50_ms"] = {r: statistics.median(ms)
                                for r, ms in sorted(routes.items())}
        rpc["route_calls"] = {r: len(ms) for r, ms in sorted(routes.items())}
        rpc["handlers_ms"] = ms_summary(handlers)
        rpc["broadcast_tx_commit"] = c_res
        out["rpc"] = rpc
        k1 = exec_counts()
        for p in peers:
            p.send({"op": "stop", "upto": top})
        reps = [await p.aread() for p in peers]
        rep = {"chains": [c for r in reps for c in r.get("chains", [])],
               "faults": [f for r in reps for f in r["faults"]]}
        errors = [r["error"] for r in reps if "error" in r]
        if errors:
            rep["error"] = errors
        if "error" in rep or rep["faults"] or fault() is not None:
            raise AssertionError(f"p2p: a node failed: {rep.get('error')} "
                                 f"{rep['faults']} {fault()!r}")
        launches = {k: k1[k] - k0[k] for k in k1 if k1[k] != k0[k]}
        device = [n for n, dev, _ in flushes if dev]
        out["observability"] = await p2p_observe(node, ledger0, t_run,
                                                 len(device), trace)
        by_lanes = collections.Counter(n for n, _, _ in flushes)
        heights = []
        for h in range(1, top + 1):
            nh = steps.get(("new_height", h))
            cm = steps.get(("commit", h))
            b = bs.load_block(h)
            heights.append(dict(
                height=h, txs=len(b.data.txs),
                proposer=b.header.proposer_address.hex()[:8],
                commit_round=bs.load_seen_commit(h).round,
                new_height_to_commit_ms=(cm - nh) * 1e3
                if nh and cm else None))
        chans = sorted(set(net1["peer_receive_bytes"]) |
                       set(net1["peer_send_bytes"]))

        def rate(family, ch):
            return (net1[family].get(ch, 0) - net0[family].get(ch, 0)) / run_s

        refused = collections.Counter(c for c in a_codes + b_rep["codes"]
                                      if c)
        out.update(
            validators=P2P_VALIDATORS, a=keys[0].pub_key().address().hex()[:8],
            heights=heights, run_s=run_s, last_height=top,
            txs=dict(a=len(a_txs), commit=len(c_txs), b=len(b_rep["txs"]),
                     committed=sum(committed.values()),
                     missing=sum((submitted - committed).values()),
                     refused=dict(refused),
                     a_bursts=len(a_txs) // P2P_BURST,
                     a_mempool_at_12=mempool_at_12),
            signer_round_trip_ms=dict(
                n=len(sign_ms), p50=statistics.median(sign_ms),
                max=max(sign_ms)) if sign_ms else None,
            recv_host_us_per_msg={ch: recv_us[ch] / recv_n[ch]
                                  for ch in sorted(recv_n)},
            recv_msgs=dict(sorted(recv_n.items())),
            bytes_per_s={ch: dict(recv=rate("peer_receive_bytes", ch),
                                  send=rate("peer_send_bytes", ch))
                         for ch in chans},
            flushes=dict(count=len(flushes), device=len(device),
                         device_lanes=sorted(collections.Counter(device)
                                             .items()),
                         host_lanes=sorted((n, c) for n, c in by_lanes.items()
                                           if n < collector.device_threshold),
                         device_ms_p50=statistics.median(
                             [ms for n, dev, ms in flushes if dev])
                         if device else None),
            speculation=dict(hits=node.speculation.hits,
                             misses={k: v for k, v in
                                     node.speculation.misses.items() if v})
            if node.speculation is not None else None,
            launches=launches)
        try:
            p2p_localnet_checks(node, rep, top, keys, submitted, committed,
                                refused, net0, net1, flushes, launches,
                                device, adm0, c_res, out)
        except AssertionError:
            print(json.dumps({"p2p_localnet": out}, default=str),
                  file=sys.stderr, flush=True)
            raise
        return out
    finally:
        if ws is not None:
            ws.close()
        if node.is_running:
            await node.stop()
        for p in peers + [clients]:
            p.close()
        signer.proc.terminate()
        signer.proc.wait(timeout=30)


async def http_get(port: int, path: str) -> bytes:
    """One HTTP/1.0 GET on 127.0.0.1: the body."""
    import asyncio

    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.0\r\n\r\n".encode())
    await writer.drain()
    data = await reader.read()
    writer.close()
    return data.partition(b"\r\n\r\n")[2]


def trace_shares(trace: dict) -> dict:
    """From a node's Chrome trace: each height's state.apply_block share
    of its consensus.height span, and the crypto.device_exec share of
    each state.apply_block (the spans inside its interval); p50s."""
    ev = trace["traceEvents"]
    heights = {e["args"].get("height"): e for e in ev
               if e["name"] == "consensus.height"}
    applies = [e for e in ev if e["name"] == "state.apply_block"]
    execs = [e for e in ev if e["name"] == "crypto.device_exec"]
    in_height = [a["dur"] / heights[a["args"]["height"]]["dur"]
                 for a in applies
                 if a["args"].get("height") in heights
                 and heights[a["args"]["height"]]["dur"] > 0]
    in_apply = [sum(x["dur"] for x in execs
                    if a["ts"] <= x["ts"] <= a["ts"] + a["dur"]) / a["dur"]
                for a in applies if a["dur"] > 0]
    return dict(
        heights=len(heights), apply_blocks=len(applies),
        crypto_spans=sum(e["name"].startswith("crypto.") for e in ev),
        apply_share_of_height_p50=(statistics.median(in_height)
                                   if in_height else None),
        device_exec_share_of_apply_p50=(statistics.median(in_apply)
                                        if in_apply else None))


async def p2p_observe(node, ledger0: float, t_run: float, device: int,
                      trace: dict) -> dict:
    """A's observability over Part A: /metrics on its Prometheus
    listener counts one admission ledger record on the card per device
    flush (K4 launch); /debug/launches holds them; /status's device
    check reads the watchdog at gpu; the mid-run /debug/trace holds
    the height, apply_block and crypto spans."""
    import re

    text = (await http_get(node.prometheus_port, "/metrics")).decode()
    m = re.search(r'^tpu_launch_ledger_records_total\{backend="gpu",'
                  r'workload="admission"\} (\S+)$', text, re.M)
    counted = (float(m.group(1)) if m else 0.0) - ledger0
    launches = json.loads(await http_get(
        node.pprof_port, "/debug/launches?workload=admission"))
    t_mono = time.monotonic() - (time.perf_counter() - t_run)
    recs = [r for r in launches["records"] if r["mono"] >= t_mono]
    status = json.loads(await http_get(node.pprof_port, "/status"))
    dev = status["checks"]["device"]
    names = {e["name"] for e in trace["traceEvents"]}
    out = dict(admission_records=counted, device_flushes=device,
               ledger_records=len(recs),
               effective_backend=dev["effective_backend"],
               trace=trace_shares(trace),
               trace_dropped=trace["tm_tpu"]["dropped"])
    if counted != device or len(recs) != device or \
            any((r["kernel"], r["backend"]) != ("general", "gpu")
                for r in recs) or dev["effective_backend"] != "gpu" or \
            not {"consensus.height", "state.apply_block"} <= names or \
            not any(n.startswith("crypto.") for n in names):
        raise AssertionError(f"p2p: A's observability {out}")
    return out


async def p2p_rpc_checks(a, b, top: int, committed) -> dict:
    """A's and B's RPC (TimedRpc clients): /block, /commit, /validators,
    /block_results and /tx_search equal at every height to `top`; every
    committed tx's /tx?prove=true proof verifies against /block's data
    hash; /abci_query?prove=true equal at one app height for keys of
    several heights and an absent key."""
    import asyncio
    import base64

    from tendermint_tpu_torch.crypto import merkle

    data_hash, height_of = {}, {}
    search_retries = 0
    for h in range(1, top + 1):
        for route in ("block", "commit", "validators", "block_results"):
            ja, jb = await asyncio.gather(a.call(route, height=h),
                                          b.call(route, height=h))
            if ja != jb:
                raise AssertionError(f"p2p: /{route} at {h}: A and B differ")
            if route == "block":
                data_hash[h] = bytes.fromhex(ja["block"]["header"]["data_hash"])
                for tx in ja["block"]["data"]["txs"]:
                    height_of[base64.b64decode(tx)] = h
            if route == "commit" and not ja["canonical"]:
                raise AssertionError(f"p2p: /commit at {h} not canonical")
        page, got = 1, {"A": [], "B": []}
        while True:
            for retry in range(100):
                # each node's indexer takes a block's Tx events after the
                # commit, from its event bus: wait until both have
                ja, jb = await asyncio.gather(*(
                    c.call("tx_search", query=f"tx.height={h}", page=page,
                           per_page=100) for c in (a, b)))
                if ja == jb and int(ja["total_count"]) == sum(
                        1 for hh in height_of.values() if hh == h):
                    break
                search_retries += 1
                await asyncio.sleep(0.05)
            if ja != jb:
                diff = next((k for k, (x, y) in enumerate(
                    zip(ja["txs"], jb["txs"])) if x != y), None)
                raise AssertionError(
                    f"p2p: /tx_search at {h} page {page}: A and B differ "
                    f"({ja['total_count']} / {jb['total_count']} txs, "
                    f"{len(ja['txs'])} / {len(jb['txs'])} on the page, "
                    f"first difference at {diff}: "
                    f"{ja['txs'][diff] if diff is not None else ''} / "
                    f"{jb['txs'][diff] if diff is not None else ''})")
            got["A"] += ja["txs"]
            if len(got["A"]) >= int(ja["total_count"]) or not ja["txs"]:
                break
            page += 1
        if sorted(base64.b64decode(t["tx"]) for t in got["A"]) != \
                sorted(tx for tx, hh in height_of.items() if hh == h):
            raise AssertionError(f"p2p: /tx_search at {h} misses txs")
    if set(height_of) != set(committed):
        raise AssertionError("p2p: the blocks' txs are not the committed ones")
    proved = 0
    txs = sorted(committed)
    for i in range(0, len(txs), 64):
        res = await asyncio.gather(*(
            a.call("tx", hash=hashlib.sha256(tx).hexdigest(), prove=True)
            for tx in txs[i:i + 64]))
        for tx, r in zip(txs[i:i + 64], res):
            pj = r["proof"]["proof"]
            proof = merkle.Proof(
                total=pj["total"], index=pj["index"],
                leaf_hash=base64.b64decode(pj["leaf_hash"]),
                aunts=[base64.b64decode(x) for x in pj["aunts"]])
            h = int(r["height"])
            if h != height_of[tx] or base64.b64decode(r["tx"]) != tx or \
                    not proof.verify(data_hash[h], tx):
                raise AssertionError("p2p: a /tx proof does not verify")
            proved += 1
    keys = sorted({tx.partition(b"=")[0] for tx in txs})
    picks = [keys[0], keys[len(keys) // 2], keys[-1], b"absent-key"]
    queries = []
    for key in picks:
        for _ in range(400):
            ja, jb = await asyncio.gather(*(
                c.call("abci_query", data=key.hex(), prove=True)
                for c in (a, b)))
            if ja["response"]["height"] == jb["response"]["height"]:
                break
            await asyncio.sleep(0.05)
        if ja != jb or not ja["response"]["proof_ops"]["ops"]:
            raise AssertionError(f"p2p: /abci_query {key!r}: A and B differ")
        queries.append((ja["response"]["height"], ja["response"]["log"]))
    if [q[1] for q in queries] != ["exists"] * 3 + ["does not exist"]:
        raise AssertionError(f"p2p: /abci_query answers {queries}")
    return dict(heights=top, txs_proved=proved, queries=queries,
                tx_search_retries=search_retries)


def p2p_ws_checks(events: list, top: int, committed) -> dict:
    """The WS stream of A (NewBlock and Tx): every committed tx named
    exactly once, a NewBlock for every height from the first seen."""
    import base64
    import collections

    tx_ev = collections.Counter()
    blocks = []
    for e in events:
        d = e["result"]["data"]
        if d["type"] == "Tx" and int(d["height"]) <= top:
            tx_ev[base64.b64decode(d["tx"])] += 1
        elif d["type"] == "NewBlock":
            blocks.append(int(d["block"]["header"]["height"]))
    if tx_ev != committed:
        raise AssertionError("p2p: the WS stream's txs are not the "
                             "committed ones, once each")
    if not blocks or blocks != list(range(blocks[0], blocks[0] + len(blocks))) \
            or blocks[-1] < top:
        raise AssertionError(f"p2p: the WS NewBlock heights {blocks}")
    return dict(events=len(events), tx_events=sum(tx_ev.values()),
                new_blocks=[blocks[0], blocks[-1]])


async def p2p_light_proxy(gdoc, a_port: int, witness_ports, a, top: int,
                          committed, routes: dict) -> dict:
    """A LightProxy whose primary is A's RPC and whose witnesses are B's
    and C's, trusted at height 1 by hash: its /commit and /block at
    `top` equal A's, and its verified abci_query proves a committed key
    against the verified header's app hash."""
    from tendermint_tpu_torch.libs.db import MemDB
    from tendermint_tpu_torch.light import (Client, LightStore, RPCProvider,
                                            TrustOptions)
    from tendermint_tpu_torch.light.proxy import LightProxy
    from tendermint_tpu_torch.rpc.jsonrpc import HTTPClient

    first = await a.call("block", height=1)
    lc = Client(gdoc.chain_id,
                TrustOptions(period_ns=SS_TRUST_PERIOD_S * 10**9, height=1,
                             hash=bytes.fromhex(first["block_id"]["hash"])),
                RPCProvider("127.0.0.1", a_port, name="A"),
                [RPCProvider("127.0.0.1", p, name=n)
                 for p, n in zip(witness_ports, "BC")],
                LightStore(MemDB()))
    faults: list = []
    proxy = LightProxy(lc, forward_client=HTTPClient("127.0.0.1", a_port),
                       on_fault=faults.append)
    port = await proxy.listen("127.0.0.1", 0)
    try:
        lp = TimedRpc(port, {})
        got = {}
        for route in ("commit", "block"):
            got[route] = await lp.call(route, height=top)
            if got[route] != await a.call(route, height=top):
                raise AssertionError(f"p2p: the light proxy's /{route} at "
                                     f"{top} is not A's")
        key = sorted(committed)[0].partition(b"=")[0]
        q = await lp.call("abci_query", data=key.hex())
        if q["response"]["log"] != "exists" or faults:
            raise AssertionError(f"p2p: the light proxy's abci_query {q} "
                                 f"{faults}")
        for r, ms in lp.record.items():
            routes.setdefault("light_proxy." + r, []).extend(ms)
        return dict(trusted_height=lc.store.latest_height(),
                    query_height=q["response"]["height"],
                    witnesses=len(lc.witnesses))
    finally:
        proxy.close()


def p2p_localnet_checks(node, rep, top, keys, submitted, committed,
                        refused, net0, net1, flushes, launches, device, adm0,
                        c_res, out) -> None:
    """Part A's checks (docstring, phase 16); adds the evidence to
    `out`."""
    from tendermint_tpu_torch.mempool import admission
    from tendermint_tpu_torch.privval.file_pv import STEP_PRECOMMIT
    from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence

    if "error" in rep or rep["faults"] or node_fault(node) is not None:
        raise AssertionError(f"p2p: a node failed: {rep.get('error')} "
                             f"{rep['faults']} {node_fault(node)!r}")
    bs = node.block_store
    chain = store_chain(bs, top)
    if any(c != chain for c in rep["chains"]):
        raise AssertionError("p2p: the four nodes' chains differ")
    if refused or committed != submitted or max(submitted.values()) != 1:
        raise AssertionError(
            f"p2p: {sum(submitted.values())} txs submitted, "
            f"{sum(committed.values())} committed to height {top}; "
            f"refused {dict(refused)}")
    if not c_res or any(ch != 0 or dl != 0 or hc < at
                        for at, hc, ch, dl in c_res):
        raise AssertionError(f"p2p: broadcast_tx_commit answers {c_res}")
    evidence = [(h, ev) for h in range(1, top + 1)
                for ev in bs.load_block(h).evidence.evidence]
    d_addr = keys[-1].pub_key().address()
    if len(evidence) != 1 or \
            not isinstance(evidence[0][1], DuplicateVoteEvidence) or \
            evidence[0][1].vote_a.validator_address != d_addr or \
            evidence[0][1].height() != P2P_MAVERICK_H or \
            evidence[0][0] > P2P_MAVERICK_H + 2:
        raise AssertionError(f"p2p: evidence in the chain {evidence}")
    gossiped = net1["message_receive"].get("0x38", 0) - \
        net0["message_receive"].get("0x38", 0)
    out["evidence"] = dict(height=evidence[0][0], against=d_addr.hex()[:8],
                           gossiped_to_a=gossiped)
    if not gossiped:
        raise AssertionError("p2p: no evidence message reached A")
    last = bs.load_seen_commit(top)
    if out["signer_last_sign"] != [top, last.round, STEP_PRECOMMIT]:
        raise AssertionError(f"p2p: A's FilePV last signed "
                             f"{out['signer_last_sign']}")
    if launches != ({"general_verify": len(device)} if device else {}):
        raise AssertionError(f"p2p: A launched {launches} for "
                             f"{len(device)} device flushes")
    if metrics_view("admission")["verify_launches"].get("device", 0) - \
            adm0["verify_launches"].get("device", 0) != len(device):
        raise AssertionError("p2p: the admission counts disagree")


class _TxFeed:
    """The chain builder's mempool: reaps the next block's txs."""

    def __init__(self):
        from tendermint_tpu_torch.mempool import NopMempool

        self.nop = NopMempool()
        self.txs: list = []

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int):
        return list(self.txs)

    def __getattr__(self, name):
        return getattr(self.nop, name)


async def p2p_build_chain(gdoc, keys):
    """Part B's chain from genesis: P2P_SYNC_BLOCKS blocks of
    P2P_SYNC_TXS kvstore txs through a BlockExecutor (the host route
    forced: every LastCommit verified on the host) over a kvstore app;
    each block's commit signed by every validator (OpenSSL where the
    host has it), in round 1 at P2P_SYNC_ROUND1. The block store, and
    the digests (state store, app hash, last_results_hash) after each of
    the last three blocks, by height (a syncing node stops at the second
    last or the one before it). Each tx's value is padded to
    P2P_SYNC_VALUE bytes and the app snapshots every SS_INTERVAL heights
    (keeping SS_KEEP); `extra` holds the state DB, the app's connections
    (left running: the statesync servers serve its snapshots) and the app
    hash after each snapshot height."""
    from tendermint_tpu_torch.abci.client import ClientCreator
    from tendermint_tpu_torch.abci.kvstore import PersistentKVStoreApp
    from tendermint_tpu_torch.consensus.replay import handshake_and_load_state
    from tendermint_tpu_torch.libs.db import MemDB
    from tendermint_tpu_torch.proxy import AppConns
    from tendermint_tpu_torch.state.execution import BlockExecutor
    from tendermint_tpu_torch.state.store import Store
    from tendermint_tpu_torch.store import BlockStore
    from tendermint_tpu_torch.types.block import (BlockID, BlockIDFlag, Commit,
                                                  CommitSig)

    state_db = MemDB()
    ss, bs = Store(state_db), BlockStore(MemDB())
    app = PersistentKVStoreApp(MemDB(), snapshot_interval=SS_INTERVAL,
                               keep_snapshots=SS_KEEP)
    conns = AppConns(ClientCreator(app=app))
    await conns.start()
    state = await handshake_and_load_state(None, ss, bs, gdoc, conns)
    feed = _TxFeed()
    executor = BlockExecutor(ss, conns.consensus, mempool=feed)
    key_of = {k.pub_key().address(): k for k in keys}
    last_commit, sign_s, digests, app_hashes, kv_digests = \
        None, 0.0, {}, {}, {}
    for h in range(1, P2P_SYNC_BLOCKS + 1):
        feed.txs = [b"sync-%d-%d=" % (h, j) +
                    (b"%d" % (h * j)).ljust(P2P_SYNC_VALUE, b".")
                    for j in range(P2P_SYNC_TXS)]
        block = executor.create_proposal_block(
            h, state, last_commit, state.validators.get_proposer().address)
        parts = block.make_part_set()
        bid = BlockID(block.hash(), parts.header())
        ts = block.header.time + 1_000_000_000
        t = time.perf_counter()
        vals = state.validators.validators
        commit = Commit(h, int(h == P2P_SYNC_ROUND1), bid,
                        [CommitSig(BlockIDFlag.COMMIT, v.address, ts, b"")
                         for v in vals])
        for i, v in enumerate(vals):
            commit.signatures[i].signature = key_of[v.address].sign(
                commit.vote_sign_bytes(gdoc.chain_id, i))
        sign_s += time.perf_counter() - t
        bs.save_block(block, parts, commit)
        state, _ = await executor.apply_block(state, bid, block)
        last_commit = commit
        if h >= P2P_SYNC_BLOCKS - 2:
            digests[h] = dict(state_db=db_digest(state_db),
                              app_hash=state.app_hash.hex(),
                              last_results_hash=state.last_results_hash.hex())
        if h % SS_INTERVAL == 0:
            app_hashes[h] = state.app_hash.hex()
            kv_digests[h] = db_digest(app.db, b"kv:")
    return bs, state, digests, sign_s, dict(state_db=state_db, conns=conns,
                                            app_hashes=app_hashes,
                                            kv_digests=kv_digests)


class _ForgedStore:
    """A block store that serves `block` at its height in place of the
    stored one, and its LastCommit as the commit of the height before
    (the forged copy of the chain, over p2p and over RPC)."""

    def __init__(self, bs, block):
        self._bs, self._block = bs, block
        self.height, self.base = bs.height, bs.base

    def load_block(self, h: int):
        return self._block if h == self._block.header.height \
            else self._bs.load_block(h)

    def load_block_commit(self, h: int):
        return self._block.last_commit \
            if h == self._block.header.height - 1 \
            else self._bs.load_block_commit(h)

    def __getattr__(self, name):
        return getattr(self._bs, name)


class _TimedSets:
    """A state store that records each validator set's load (the stored
    JSON decoded, state/store.py load_validators) in ms into
    `record["decode"]`; it keeps nothing."""

    def __init__(self, ss, record: dict):
        self._ss, self._record = ss, record

    def load_validators(self, h: int):
        t = time.perf_counter()
        try:
            return self._ss.load_validators(h)
        finally:
            self._record.setdefault("decode", []).append(
                (time.perf_counter() - t) * 1e3)

    def __getattr__(self, name):
        return getattr(self._ss, name)


def time_routes(srv, record: dict) -> None:
    """Each route of a JSONRPCServer records its handler's ms (the
    server's own time for the call, without the HTTP and JSON around
    it) into `record` by route."""

    def timed(name, fn):
        async def handler(ctx, **params):
            t = time.perf_counter()
            try:
                return await fn(ctx, **params)
            finally:
                record.setdefault(name, []).append(
                    (time.perf_counter() - t) * 1e3)
        return handler

    srv.routes = {n: timed(n, fn) for n, fn in srv.routes.items()}


def ms_summary(record: dict) -> dict:
    """{name: {n, p50, sum}} of a record of ms lists."""
    return {k: dict(n=len(v), p50=statistics.median(v), sum=sum(v))
            for k, v in sorted(record.items()) if v}


async def rpc_server(bs, sets, record: dict):
    """A JSON-RPC server (rpc/core.py Environment, the node's routes) over
    a chain's block store and state store (`sets`, a _TimedSets), its
    handlers timed into `record`; the server and its 'host:port'."""
    from tendermint_tpu_torch.config import Config
    from tendermint_tpu_torch.rpc.core import Environment, serve

    env = Environment(types.SimpleNamespace(block_store=bs,
                                            state_store=sets,
                                            config=Config()))
    srv, port = await serve(env, "127.0.0.1", 0)
    time_routes(srv, record)
    return srv, f"127.0.0.1:{port}"


async def p2p_server(gdoc, state, store, i: int, kind: bytes = b"server",
                     snapshots=None, book=None, seed_mode=False):
    """A serving peer: a Switch with the blockchain reactor over `store`
    (not syncing); with `snapshots` (an app's snapshot connection) also a
    StateSyncReactor serving them, and with `book` a PEXReactor over it
    (in seed mode with `seed_mode`). Its NodeInfo names the channels of
    its reactors."""
    from tendermint_tpu_torch.blockchain.reactor import BlockchainReactor
    from tendermint_tpu_torch.p2p.key import NodeKey
    from tendermint_tpu_torch.p2p.node_info import NodeInfo
    from tendermint_tpu_torch.p2p.pex import PEXReactor
    from tendermint_tpu_torch.p2p.switch import Switch
    from tendermint_tpu_torch.p2p.transport import Transport
    from tendermint_tpu_torch.statesync.reactor import StateSyncReactor

    nk = NodeKey(p2p_key(kind, i))
    holder = {}

    def ni():
        t = holder["transport"]
        return NodeInfo(node_id=nk.id,
                        listen_addr=t.listen_addr if t._server else "",
                        network=gdoc.chain_id, moniker=f"{kind.decode()}{i}",
                        channels=holder["switch"].channel_ids())

    transport = Transport(nk, ni)
    holder["transport"] = transport
    sw = holder["switch"] = Switch(transport, ni)
    sw.add_reactor("blockchain", BlockchainReactor(state, None, store,
                                                   fast_sync=False))
    if snapshots is not None:
        sw.add_reactor("statesync", StateSyncReactor(snapshots))
    if book is not None:
        book.add_our_address(nk.id)
        sw.add_reactor("pex", PEXReactor(book, seed_mode=seed_mode))
    await transport.listen("127.0.0.1", 0)
    await sw.start()
    return sw, f"{nk.id}@{transport.listen_addr}"


class _PoisonedSnapshots:
    """The poisoner's snapshot connection: the app's, each chunk served
    with one byte flipped (on the wire, the attack the reference's
    statesync.serve `corrupt` models; that failpoint is process-wide)."""

    def __init__(self, conn):
        self._conn = conn

    async def load_snapshot_chunk(self, req):
        res = await self._conn.load_snapshot_chunk(req)
        if not res.chunk:
            return res
        b = bytearray(res.chunk)
        b[len(b) // 2] ^= 0x01
        return type(res)(bytes(b))

    def __getattr__(self, name):
        return getattr(self._conn, name)


async def ss_servers(gdoc, state, bs, extra) -> dict:
    """The statesync phase's serving side over Part B's chain and app:
    P2P_SYNC_SERVERS honest switches and a poisoner (blockchain,
    statesync and PEX reactors; their books hold the five), as many RPC
    servers over the chain's stores (rpc/core.py Environment), and a seed (a
    PEXReactor in seed mode whose book holds the five; its blockchain and
    statesync reactors run over an empty store and an empty app, as a
    seed node of the reference does, so a joining node's status and
    snapshot requests get answers instead of an unknown channel)."""
    from tendermint_tpu_torch.abci.client import ClientCreator
    from tendermint_tpu_torch.abci.kvstore import PersistentKVStoreApp
    from tendermint_tpu_torch.libs.db import MemDB
    from tendermint_tpu_torch.p2p.key import NodeKey
    from tendermint_tpu_torch.p2p.pex import AddrBook
    from tendermint_tpu_torch.proxy import AppConns
    from tendermint_tpu_torch.state.store import Store
    from tendermint_tpu_torch.store import BlockStore

    conn = extra["conns"].snapshot
    ids = [NodeKey(p2p_key(b"ss-server", i)).id
           for i in range(P2P_SYNC_SERVERS)]
    if NodeKey(p2p_key(b"ss-poisoner", SS_POISONER_KEY)).id >= min(ids):
        raise AssertionError("statesync: the poisoner's id must sort first")
    books = [AddrBook() for _ in range(P2P_SYNC_SERVERS + 2)]
    servers = [await p2p_server(gdoc, state, bs, i, b"ss-server", conn,
                                books[i]) for i in range(P2P_SYNC_SERVERS)]
    servers.append(await p2p_server(gdoc, state, bs, SS_POISONER_KEY,
                                    b"ss-poisoner", _PoisonedSnapshots(conn),
                                    books[-2]))
    empty = AppConns(ClientCreator(app=PersistentKVStoreApp(MemDB())))
    await empty.start()
    seed = await p2p_server(gdoc, state, BlockStore(MemDB()), 0, b"ss-seed",
                            empty.snapshot, books[-1], seed_mode=True)
    addrs = [a for _, a in servers]
    for book in books:
        for a in addrs:
            book.add_address(a)
    record: dict = {}
    sets = _TimedSets(Store(extra["state_db"]), record)
    rpcs = [await rpc_server(bs, sets, record)
            for _ in range(P2P_SYNC_SERVERS)]
    return dict(switches=[sw for sw, _ in servers] + [seed[0]],
                conns=[extra["conns"], empty], addrs=addrs[:-1],
                poisoner=addrs[-1], seed=seed[1], sets=sets, record=record,
                rpc_servers=[srv for srv, _ in rpcs],
                rpc=[a for _, a in rpcs])


def ss_frame(extra, ss, forged_rpc: str) -> dict:
    """The servers' p2p addresses, their RPC addresses and the forged RPC
    server's, and the app hash and the digest of the app's `kv:` items
    after each snapshot height."""
    return {"op": "statesync", "addrs": ss["addrs"],
            "poisoner": ss["poisoner"], "seed": ss["seed"],
            "rpc": ss["rpc"], "forged_rpc": forged_rpc,
            "app_hashes": extra["app_hashes"],
            "kv_digests": extra["kv_digests"]}


def p2p_servers_child() -> int:
    """Part B's serving peers (`--phase p2p_servers`): builds the chain
    (p2p_build_chain, the host route forced), then serves it from
    P2P_SYNC_SERVERS switches and a copy with one forged signature in
    block P2P_FORGED_AT's LastCommit from P2P_FORGED_SERVERS more (and
    from one RPC server), and the statesync phase's servers and seed
    (ss_servers). One `ready`
    frame (the keys, addresses, block hashes, the digests, the build's
    times), then serves until `exit`, answering each `statesync` frame
    with ss_frame's and each `rpc_stats` frame with its RPC servers'
    handler ms by route and validator-set decodes since the last
    (ms_summary)."""
    import asyncio

    from tendermint_tpu_torch.types.block import Block

    p2p_host_only()
    t0 = time.perf_counter()
    keys = [p2p_key(b"sync-val", i) for i in range(P2P_SYNC_VALIDATORS)]
    pubs = [k.pub_key().bytes() for k in keys]
    gdoc = p2p_genesis(P2P_SYNC_CHAIN, pubs)
    keys_s = time.perf_counter() - t0
    inp, out = sys.stdin.buffer, sys.stdout.buffer

    async def run():
        t = time.perf_counter()
        bs, state, digests, sign_s, extra = await p2p_build_chain(gdoc, keys)
        build_s = time.perf_counter() - t
        forged = Block.from_bytes(bs.load_block(P2P_FORGED_AT).to_bytes())
        sig = bytearray(forged.last_commit.signatures[5].signature)
        sig[7] ^= 0x01
        forged.last_commit.signatures[5].signature = bytes(sig)
        fstore = _ForgedStore(bs, forged)
        servers = [await p2p_server(gdoc, state, bs, i)
                   for i in range(P2P_SYNC_SERVERS)]
        servers += [await p2p_server(gdoc, state, fstore,
                                     P2P_SYNC_SERVERS + i)
                    for i in range(P2P_FORGED_SERVERS)]
        ss = await ss_servers(gdoc, state, bs, extra)
        forged_rpc, forged_addr = await rpc_server(fstore, ss["sets"],
                                                   ss["record"])
        cs_frame_write(out, {
            "op": "ready", "pubs": pubs,
            "addrs": [a for _, a in servers[:P2P_SYNC_SERVERS]],
            "forged": [a for _, a in servers[P2P_SYNC_SERVERS:]],
            "hashes": [bs.load_block(h).hash().hex()
                       for h in range(1, P2P_SYNC_BLOCKS + 1)],
            "digests": digests, "keys_s": keys_s, "build_s": build_s,
            "sign_s": sign_s})
        loop = asyncio.get_running_loop()
        while True:
            op = (await loop.run_in_executor(None, cs_frame_read, inp))["op"]
            if op == "statesync":
                cs_frame_write(out, ss_frame(extra, ss, forged_addr))
            elif op == "rpc_stats":
                cs_frame_write(out, ms_summary(ss["record"]))
                ss["record"].clear()
            else:
                break
        for srv in ss["rpc_servers"] + [forged_rpc]:
            srv.close()
        for sw in [sw for sw, _ in servers] + ss["switches"]:
            await sw.stop()
        for conns in ss["conns"]:
            await conns.stop()

    asyncio.run(run())
    return 0


async def p2p_sync_run(gdoc, addrs, ready, forged=()) -> dict:
    """One fast sync of Part B: a fresh node (no key, MemDBs, the
    blockchain reactor syncing) dials the `forged` servers first and,
    once the reactor has banned each of them, the honest `addrs`. A
    clean run syncs to within one or two of the servers' height (the
    pool is caught up within one of the tallest peer, and the last block
    needs the next one's LastCommit) and hands over to consensus; a
    forged run stops once the banned heights are applied from honest
    peers (its apply_block holds every later block back, and the
    window jobs in flight finish before the counts are read).
    Its blocks and digests must equal the chain's; the window jobs,
    the LastCommit checks, the bans and the time split are returned."""
    import asyncio
    import threading

    from tendermint_tpu_torch.blockchain.verify_ahead import WindowPipeline

    node = await P2pNode(gdoc, "syncer-forged" if forged else "syncer"
                         ).start()
    rec = dict(verify_s=0.0, apply_s=0.0, save_block_s=0.0, windows=[],
               applied_with_last_commit=0, banned=[])
    stop_at = P2P_FORGED_AT + 1 if forged else None
    held = asyncio.Event()
    in_job = [0]
    lock = threading.Lock()
    try:
        pipe = node.bc_reactor.pipeline
        verdicts = pipe.verdicts

        async def timed_verdicts(vals, chain_id, blocks):
            t = time.perf_counter()
            try:
                return await verdicts(vals, chain_id, blocks)
            finally:
                rec["verify_s"] += time.perf_counter() - t

        pipe.verdicts = timed_verdicts
        job = WindowPipeline._verify_window_job

        def counted_job(vals, chain_id, blocks):
            with lock:
                rec["windows"].append(len(blocks) - 1)
                in_job[0] += 1
            try:
                return job(vals, chain_id, blocks)
            finally:
                with lock:
                    in_job[0] -= 1

        pipe._verify_window_job = counted_job
        apply_block = node.executor.apply_block

        async def timed_apply(state, bid, block):
            if stop_at is not None and block.header.height > stop_at:
                held.set()
                await asyncio.Event().wait()  # held until the node stops
            t = time.perf_counter()
            try:
                return await apply_block(state, bid, block)
            finally:
                rec["apply_s"] += time.perf_counter() - t
                rec["applied_with_last_commit"] += block.header.height > 1

        node.executor.apply_block = timed_apply
        save_block = node.bs.save_block

        def timed_save(*a):
            t = time.perf_counter()
            try:
                return save_block(*a)
            finally:
                rec["save_block_s"] += time.perf_counter() - t

        node.bs.save_block = timed_save
        redo = node.bc_reactor.pool.redo_request

        def recorded_redo(h):
            peer = redo(h)
            rec["banned"].append((h, peer))
            return peer

        node.bc_reactor.pool.redo_request = recorded_redo
        t = time.perf_counter()
        if forged:
            ids = {a.split("@")[0] for a in forged}
            for a in forged:
                await node.dial(a, persistent=False)
            await p2p_until(lambda: not ids & set(node.switch.peers),
                            "the forged servers' bans", fault=node.fault)
        for a in addrs:
            await node.dial(a, persistent=False)
        if forged:
            await p2p_until(held.is_set, f"height {stop_at}",
                            fault=node.fault)
            await p2p_until(lambda: in_job[0] == 0 and (
                pipe._prefetch is None or pipe._prefetch[1].done()),
                "the window jobs", fault=node.fault)
        else:
            await node.bc_reactor.wait_synced(timeout=P2P_WAIT_S)
        rec["sync_s"] = time.perf_counter() - t
        # the applied height (a forged run has saved the held block)
        top = node.bc_reactor.state.last_block_height
        got = [node.bs.load_block(h).hash().hex() for h in range(1, top + 1)]
        if forged:
            if top != stop_at or got != ready["hashes"][:top]:
                raise AssertionError(f"p2p: the forged run's chain differs "
                                     f"(height {top})")
        else:
            st = node.bc_reactor.state
            digest = dict(state_db=db_digest(node.dbs[0]),
                          app_hash=st.app_hash.hex(),
                          last_results_hash=st.last_results_hash.hex())
            if top not in ready["digests"] or top == P2P_SYNC_BLOCKS or \
                    st.last_block_height != top or \
                    got != ready["hashes"][:top] or \
                    digest != ready["digests"][top]:
                raise AssertionError(
                    f"p2p: the synced chain differs (height {top}; digest "
                    f"{digest} against {ready['digests'].get(top)})")
            await p2p_until(lambda: node.cs.is_running, "the handover",
                            fault=node.fault)
            rec["consensus_height"] = node.cs.rs.height
        rec.update(height=top, blocks=node.bc_reactor.blocks_synced,
                   blocks_per_s=node.bc_reactor.blocks_synced / rec["sync_s"],
                   prefetch_hits=pipe.prefetch_hits)
        rec["network_s"] = rec["sync_s"] - rec["verify_s"] - \
            rec["apply_s"] - rec["save_block_s"]
        return rec
    finally:
        await node.stop()


async def p2p_fastsync(servers) -> dict:
    """Part B of the p2p phase: a clean sync from the four honest
    servers (counted), then one from the two forged servers that stops
    once the bans are decided and the banned heights applied from two
    honest ones."""
    ready = servers.ready = await servers.aread(timeout=600)
    gdoc = p2p_genesis(P2P_SYNC_CHAIN, ready["pubs"])
    k0 = exec_counts()
    clean = await p2p_sync_run(gdoc, ready["addrs"], ready)
    k1 = exec_counts()
    forged = await p2p_sync_run(gdoc, ready["addrs"][:2], ready,
                                forged=ready["forged"])
    k2 = exec_counts()
    clean["launches"] = {k: k1[k] - k0[k] for k in k1 if k1[k] != k0[k]}
    forged["launches"] = {k: k2[k] - k1[k] for k in k2 if k2[k] != k1[k]}
    # K1 once for the set's tables, K3 once a window job and once a
    # LastCommit apply_block validates, K4 once for the handover's
    # reconstruct_last_commit (the seen commit, 1,000 lanes)
    want = dict(build_tables=1, general_verify=1,
                xverify=len(clean["windows"]) +
                clean["applied_with_last_commit"])
    if clean["launches"] != want or clean["blocks"] != clean["height"]:
        raise AssertionError(f"p2p: the clean sync launched "
                             f"{clean['launches']}, want {want}")
    forged_ids = {a.split("@")[0] for a in ready["forged"]}
    bad = {P2P_FORGED_AT - 1, P2P_FORGED_AT}
    banned = {p for _, p in forged["banned"] if p}
    if forged["launches"] != dict(xverify=len(forged["windows"]) +
                                  forged["applied_with_last_commit"]) or \
            banned != forged_ids or \
            {h for h, _ in forged["banned"]} != bad:
        raise AssertionError(f"p2p: the forged sync: launches "
                             f"{forged['launches']}, bans {forged['banned']}")
    return dict(validators=P2P_SYNC_VALIDATORS, blocks=P2P_SYNC_BLOCKS,
                build=dict(keys_s=ready["keys_s"], build_s=ready["build_s"],
                           sign_s=ready["sign_s"]),
                clean=clean, forged=forged,
                launches={k: clean["launches"].get(k, 0) +
                          forged["launches"].get(k, 0)
                          for k in set(clean["launches"]) |
                          set(forged["launches"])})


def p2p_phase(servers=None) -> dict:
    """p2p on the card (docstring, phase 16), Part B served by `servers`
    (a started `p2p_servers` child; None: started here, building its
    chain while Part A runs). Returns the phase's record."""
    import asyncio
    import shutil
    import tempfile

    own = servers is None
    if own:
        servers = P2pChild("p2p_servers")
    home = tempfile.mkdtemp(prefix="p2p-")
    try:
        kernels = wrappers()
        for fn in kernels.values():
            fn.launches = 0
        t = time.perf_counter()
        localnet = asyncio.run(p2p_localnet(home))
        localnet["seconds"] = time.perf_counter() - t
        t = time.perf_counter()
        fastsync = asyncio.run(p2p_fastsync(servers))
        fastsync["seconds"] = time.perf_counter() - t
        launches = {k: fn.launches for k, fn in kernels.items()
                    if fn.launches}
        want = {}
        for part in (localnet, fastsync):
            for k, n in part["launches"].items():
                want[k] = want.get(k, 0) + n
        if launches != want:
            raise AssertionError(f"p2p: launches {launches}, the parts "
                                 f"{want}")
        return dict(localnet=localnet, fastsync=fastsync, launches=launches)
    finally:
        if own:
            servers.close()
        shutil.rmtree(home, ignore_errors=True)


# -- phase 17: statesync -------------------------------------------------


class SsProbe:
    """The joining node's record for the statesync phase, of what the
    syncer's metric family, the blockchain reactor and the launch counters do
    not keep: the peers the switch removed, the light client's heights
    and commit checks with their times, each restore attempt's fetch
    (source, bytes, seconds, apply seconds) and the window jobs."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.removed, self.heights, self.checks, self.attempts = [], [], [], []
        self.apply_s, self.bytes_in, self.windows = 0.0, 0, []

    def at(self) -> float:
        return time.perf_counter() - self.t0

    def wire(self, node) -> None:
        """Wrap the node's switch's peer removal and its pipeline's
        window job (P2pNode's `instrument` hook: before its switch
        starts)."""
        from tendermint_tpu_torch.blockchain.verify_ahead import \
            WindowPipeline

        sw = node.switch
        remove, job = sw._remove_peer, WindowPipeline._verify_window_job

        async def remove_peer(peer, reason):
            self.removed.append((peer.id, str(reason), self.at()))
            return await remove(peer, reason)

        def counted_job(vals, chain_id, blocks):
            self.windows.append(len(blocks) - 1)
            return job(vals, chain_id, blocks)

        sw._remove_peer = remove_peer
        node.bc_reactor.pipeline._verify_window_job = counted_job

    def wire_sync(self, node, lc):
        """Wrap the light client's height requests, the syncer's fetches
        and the snapshot connection's applies; returns the undo of the
        one class attribute (CommitVerifyPlan.execute: a light commit
        check)."""
        from tendermint_tpu_torch.types import validator_set
        from tendermint_tpu_torch.types.sign_batch import StructuredSignBytes

        verify_at = lc.verify_light_block_at_height

        async def timed_verify_at(height, now_ns=None):
            t = time.perf_counter()
            try:
                lb = await verify_at(height, now_ns)
                self.heights.append((height, "ok", (time.perf_counter() - t)
                                     * 1e3))
                return lb
            except Exception as e:
                self.heights.append((height, type(e).__name__,
                                     (time.perf_counter() - t) * 1e3))
                raise

        lc.verify_light_block_at_height = timed_verify_at
        plan_cls = validator_set.CommitVerifyPlan
        execute = plan_cls.execute

        def timed_execute(plan):
            t = time.perf_counter()
            try:
                return execute(plan)
            finally:
                self.checks.append(dict(
                    lanes=len(plan.lanes),
                    structured=isinstance(plan.msgs, StructuredSignBytes),
                    ms=(time.perf_counter() - t) * 1e3))

        plan_cls.execute = timed_execute
        sy = node.ss_reactor.syncer
        fetch, add_chunk = sy._fetch_and_apply, sy.add_chunk

        async def timed_fetch(snapshot, source=None):
            t, a0, b0 = time.perf_counter(), self.apply_s, self.bytes_in
            ok = "ok"
            try:
                return await fetch(snapshot, source)
            except Exception as e:
                ok = type(e).__name__
                raise
            finally:
                self.attempts.append(dict(
                    height=snapshot.height, source=source, end=ok,
                    seconds=time.perf_counter() - t,
                    apply_s=self.apply_s - a0, bytes=self.bytes_in - b0))

        def counted_chunk(msg, peer_id=""):
            self.bytes_in += len(msg.chunk)
            return add_chunk(msg, peer_id)

        sy._fetch_and_apply, sy.add_chunk = timed_fetch, counted_chunk
        conn = sy.app
        apply_chunk = conn.apply_snapshot_chunk

        async def timed_apply(req):
            t = time.perf_counter()
            try:
                return await apply_chunk(req)
            finally:
                self.apply_s += time.perf_counter() - t

        conn.apply_snapshot_chunk = timed_apply

        def undo():
            plan_cls.execute = execute

        return undo


def ss_config(home: str, frame: dict, ready: dict):
    """The joining node's Config: state sync on, its light client over
    two of the serving child's RPC servers, trusting height 1 by hash
    (a trusting period that spans the chain's genesis time), PEX given
    only the seed (ensure period SS_ENSURE_S), fast sync for the tail,
    stores in memory, RPC on."""
    from tendermint_tpu_torch.config import Config

    cfg = Config()
    cfg.base.home = home
    cfg.base.moniker = "statesyncer"
    cfg.base.db_backend = "memdb"
    cfg.statesync.enable = True
    cfg.statesync.rpc_servers = frame["rpc"][:2]
    cfg.statesync.trust_height = 1
    cfg.statesync.trust_hash = ready["hashes"][0]
    cfg.statesync.trust_period_s = SS_TRUST_PERIOD_S
    cfg.statesync.discovery_time_s = SS_DISCOVERY_S
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.seeds = frame["seed"]
    cfg.p2p.pex_ensure_period_s = SS_ENSURE_S
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    return cfg


async def ss_join(frame, ready, gdoc) -> dict:
    """The join of the statesync phase (docstring, phase 17): a fresh
    Node on the card, given only the seed, finds the servers by PEX and
    state-syncs through its own light client over RPCProviders (the
    node's _default_state_provider): it restores the best snapshot the
    light client verifies, bootstraps its stores, fast-syncs the tail
    and hands over to consensus (the node's _run_state_sync). Launch
    counts read after the handover."""
    import asyncio
    import shutil
    import tempfile

    from tendermint_tpu_torch.crypto.cuda import expanded
    from tendermint_tpu_torch.node import Node
    from tendermint_tpu_torch.p2p.key import NodeKey
    from tendermint_tpu_torch.statesync import syncer as ssyncer

    server_ids = {a.split("@")[0] for a in frame["addrs"] + [frame["poisoner"]]}
    seed_id = frame["seed"].split("@")[0]
    poisoner = frame["poisoner"].split("@")[0]
    snaps = sorted(h for h in range(SS_INTERVAL, P2P_SYNC_BLOCKS + 1,
                                    SS_INTERVAL))[-SS_KEEP:]
    top_snap, want_h = snaps[-1], snaps[-2]
    probe = SsProbe()
    with expanded._CACHE_LOCK:
        expanded._CACHE.clear()  # a fresh node builds its tables
    met0 = metrics_view("statesync")
    home = tempfile.mkdtemp(prefix="ss-join-")
    node = Node(ss_config(home, frame, ready),
                node_key=NodeKey(p2p_key(b"node-statesyncer")),
                genesis_doc=gdoc, in_memory=True)
    k0 = exec_counts()
    probe.t0 = time.perf_counter()
    t: dict = {}

    def fault():
        return node_fault(node)

    try:
        await node._build()
        probe.wire(node)
        sy = node.ss_reactor.syncer
        lc = sy.state_provider.lc
        app = node.client_creator.app
        sync = node.ss_reactor.sync

        async def probed_sync():
            """The node's sync, once every server's snapshots are in the
            pool (the poisoner's id sorts first, so the attempts are the
            same in every run), its light heights, checks and fetches
            recorded; the restored app read before the tail moves it."""
            await p2p_until(lambda: server_ids <= set(node.switch.peers),
                            "the five servers by PEX", fault=fault)
            t["discovery_s"] = probe.at()
            await p2p_until(lambda: len(sy.pool) == SS_KEEP and all(
                set(sy.pool.peers_of(s)) == server_ids
                for s in sy.pool._snapshots.values()),
                "every server's snapshots", fault=fault)
            t["pool_s"] = probe.at()
            undo = probe.wire_sync(node, lc)
            t0 = time.perf_counter()
            try:
                res = await sync()
            except BaseException as e:
                t["error"] = repr(e)
                raise
            finally:
                t["sync_s"] = time.perf_counter() - t0
                undo()
            t["restored"] = dict(height=app.height,
                                 app_hash=app.app_hash.hex(),
                                 kv=db_digest(app.db, b"kv:"))
            return res

        node.ss_reactor.sync = probed_sync
        bootstrap = node.state_store.bootstrap

        def timed_bootstrap(state):
            t0 = time.perf_counter()
            try:
                return bootstrap(state)
            finally:
                t["bootstrap_s"] = time.perf_counter() - t0

        node.state_store.bootstrap = timed_bootstrap
        to_fast_sync = node.bc_reactor.switch_to_fast_sync

        async def timed_switch(state):
            t["tail_t0"] = time.perf_counter()
            return await to_fast_sync(state)

        node.bc_reactor.switch_to_fast_sync = timed_switch
        await node.start()  # the node's _run_state_sync runs the join
        await p2p_until(lambda: "tail_t0" in t or "error" in t,
                        "the restore", fault=fault)
        if "error" in t:
            raise AssertionError(f"statesync: the sync failed: {t['error']}")
        await node.bc_reactor.wait_synced(timeout=P2P_WAIT_S)
        tail_s = time.perf_counter() - t["tail_t0"]
        await p2p_until(lambda: node.consensus_state.is_running,
                        "the handover", fault=fault)
        total_s = probe.at()
        launches = exec_delta(k0)
        top = node.block_store.height
        st = node.bc_reactor.state
        met = {k: (v - met0[k] if isinstance(v, int) else
                   {r: n - met0[k].get(r, 0) for r, n in v.items()
                    if n != met0[k].get(r, 0)})
               for k, v in metrics_view("statesync").items()}
        met["quarantines"] = dict(sy.quarantine_kinds)
        chunks = {s.height: s.chunks for s in sy.pool._snapshots.values()}
        rec = dict(
            validators=P2P_SYNC_VALIDATORS, blocks=P2P_SYNC_BLOCKS,
            snapshots=snaps, node_id=node.node_key.id, seed=seed_id,
            poisoner=poisoner, rpc_servers=node.config.statesync.rpc_servers,
            discovery_s=t["discovery_s"], pool_s=t["pool_s"],
            book_src={ka.node_id: ka.src
                      for ka in node.addr_book._addrs.values()},
            removed=[(p, r[:60], round(s, 3)) for p, r, s in probe.removed],
            light_heights=probe.heights, light_checks=probe.checks,
            attempts=probe.attempts,
            rejected=sorted(k[0] for k in sy.pool._rejected_snapshots),
            quarantined=sy.quarantined_peers(),
            chunks=chunks.get(want_h), restored=t["restored"],
            metrics=met, sync_s=t["sync_s"],
            fetch_s=sum(a["seconds"] - a["apply_s"] for a in probe.attempts),
            apply_s=probe.apply_s, bytes_in=probe.bytes_in,
            bootstrap_s=t["bootstrap_s"],
            tail=dict(seconds=tail_s, blocks=node.bc_reactor.blocks_synced,
                      blocks_per_s=node.bc_reactor.blocks_synced / tail_s,
                      windows=probe.windows, height=top),
            total_s=total_s, launches=launches)
        rec["fetch_mb_per_s"] = probe.bytes_in / 1e6 / rec["fetch_s"]
        rec["snapshot_bytes"] = probe.attempts[-1]["bytes"] \
            if probe.attempts else None
        try:
            ss_checks(rec, probe, node, st, ready, frame, server_ids,
                      top_snap, want_h)
        except AssertionError:
            print(json.dumps({"statesync": rec}, default=str),
                  file=sys.stderr, flush=True)
            raise
        return rec
    finally:
        if node.is_running:
            await node.stop()
        shutil.rmtree(home, ignore_errors=True)


def ss_checks(rec, probe, node, st, ready, frame, server_ids, top_snap,
              want_h) -> None:
    """The join's checks (docstring, phase 17)."""
    seed_id, poisoner = rec["seed"], rec["poisoner"]
    # 1. discovery: the seed is the only address given; the book holds
    # the five with the seed as their source, the seed hung up, and
    # ensure_peers dialed each of the five (an outbound peer)
    if node.pex_reactor.seeds != [frame["seed"]] or \
            any(rec["book_src"].get(i) != seed_id for i in server_ids) or \
            seed_id not in {p for p, _, _ in probe.removed} or \
            not all(node.switch.peers[i].outbound for i in server_ids):
        raise AssertionError("statesync: PEX discovery from the seed failed")
    # 2. the top snapshot refused by the light client (no block at h+2,
    # never offered), the next verified backwards from the trusted head
    # (app_hash, then state and commit from the trusted store); every
    # restore attempt is at want_h
    nxt = [want_h, want_h + 1, want_h + 2]
    want_heights = [(top_snap, "ok"), (top_snap + 1, "ok"),
                    (top_snap + 2, "BlockNotFoundError")] + \
        [(h, "ok") for h in nxt + nxt + [want_h]]
    if rec["rejected"] != [top_snap] or \
            [a["height"] for a in rec["attempts"]] != [want_h] * 3 or \
            [(h, e) for h, e, _ in rec["light_heights"]] != want_heights:
        raise AssertionError("statesync: the snapshots' light checks")
    # 3. the poisoner quarantined by name: the round-robin attempt and
    # the single-source one on the poisoner (its id sorts first; the app
    # names it, the only sender) poisoned, the third restores
    if rec["quarantined"] != [poisoner] or \
            [a["source"] for a in rec["attempts"]] != [
                None, poisoner, sorted(server_ids - {poisoner})[0]] or \
            rec["metrics"]["restore_attempts"] != 3 or \
            rec["metrics"]["peers_quarantined"] != 1 or \
            rec["metrics"]["quarantines"] != {"app_rejected_sender": 1}:
        raise AssertionError("statesync: the poisoner's quarantine")
    # 4. the restored app: its height, its app hash (the kvstore's is
    # only its key count) and its `kv:` items, keys and values, against
    # the chain app's at want_h
    if rec["restored"] != dict(height=want_h,
                               app_hash=frame["app_hashes"][want_h],
                               kv=frame["kv_digests"][want_h]):
        raise AssertionError("statesync: the restored app")
    # 5. the tail: every block from want_h + 1 to the top is the chain's,
    # and the top's app and results hashes
    top = rec["tail"]["height"]
    bs = node.block_store
    got = [bs.load_block(h).hash().hex() for h in range(want_h + 1, top + 1)]
    digest = ready["digests"].get(top, {})
    if top not in (P2P_SYNC_BLOCKS - 1, P2P_SYNC_BLOCKS - 2) or \
            bs.base != want_h + 1 or st.last_block_height != top or \
            got != ready["hashes"][want_h:top] or \
            st.app_hash.hex() != digest.get("app_hash") or \
            st.last_results_hash.hex() != digest.get("last_results_hash") or \
            rec["tail"]["blocks"] != top - want_h:
        raise AssertionError(f"statesync: the tail differs (top {top})")
    # 6. the launches the code implies: K1 once (the set's tables), K3
    # once a light commit check (4, each structured: the trusted block,
    # 1/3 trusting and 2/3 at the top snapshot, the adjacent step), a
    # window job and a LastCommit apply_block validates (one a block the
    # tail applies), K4 once at the handover (reconstruct_last_commit)
    checks = rec["light_checks"]
    want = dict(build_tables=1, general_verify=1,
                xverify=len(checks) + len(rec["tail"]["windows"]) +
                rec["tail"]["blocks"])
    if len(checks) != 4 or not all(c["structured"] for c in checks) or \
            rec["launches"] != want:
        raise AssertionError(f"statesync: launches {rec['launches']}, "
                             f"want {want} ({len(checks)} light checks)")


def rpc_provider(addr: str, name: str):
    from tendermint_tpu_torch.light import RPCProvider

    host, _, port = addr.rpartition(":")
    return RPCProvider(host, int(port), name=name)


async def ss_serving_pool(gdoc, frame, ready) -> dict:
    """After the join: a ServingPool of SS_POOL_WORKERS LightProxy workers
    over one plane, its light client over two of the chain's RPC servers
    (trusted at height 1 by hash), answers SS_POOL_CLIENTS concurrent
    clients, each asking verified /commit and /validators at its height
    (spread over 2..128), every answer held to the chain; then a
    LightProxy whose primary is the forged RPC server (block 78's
    LastCommit, one signature forged, served as the commit of 77),
    trusted at 76, refuses /commit at 77. Launches by part."""
    import asyncio
    import base64

    from tendermint_tpu_torch.config import LightConfig
    from tendermint_tpu_torch.libs.db import MemDB
    from tendermint_tpu_torch.light import (Client, LightStore, ServingPool,
                                            TrustOptions)
    from tendermint_tpu_torch.light import serving
    from tendermint_tpu_torch.light.proxy import LightProxy
    from tendermint_tpu_torch.rpc.jsonrpc import HTTPClient, RPCError

    period = SS_TRUST_PERIOD_S * 10**9
    faults: list = []
    lc = Client(gdoc.chain_id,
                TrustOptions(period_ns=period, height=1,
                             hash=bytes.fromhex(ready["hashes"][0])),
                rpc_provider(frame["rpc"][2], "primary"),
                [rpc_provider(frame["rpc"][3], "witness")],
                LightStore(MemDB()))
    k0 = exec_counts()
    await lc.initialize()
    init_launches = exec_delta(k0)
    pool = ServingPool(lc, workers=SS_POOL_WORKERS, config=LightConfig(),
                       on_fault=faults.append)
    ports = await pool.listen("127.0.0.1")
    heights = [2 + (2 * i) % (P2P_SYNC_BLOCKS - 1)
               for i in range(SS_POOL_CLIENTS)]
    record: dict = {}

    async def one(i: int, h: int):
        cl = TimedRpc(ports[i % len(ports)], record)
        cm = await cl.call("commit", height=h)
        vals = await cl.call("validators", height=h, per_page=100)
        return cm, vals

    met0 = metrics_view("light")
    k1 = exec_counts()
    t0 = time.perf_counter()
    try:
        res = await asyncio.gather(*(one(i, h) for i, h in
                                     enumerate(heights)))
        pool_s = time.perf_counter() - t0
    finally:
        pool.close()
    pool_launches = exec_delta(k1)
    met = {k: {b: n - met0[k].get(b, 0) for b, n in v.items()
               if n != met0[k].get(b, 0)}
           for k, v in metrics_view("light").items()}
    # every answer the chain's: the commit (header and every signature)
    # and the page's validators (address, key, power) as an honest RPC
    # server reads them from the chain's stores
    host, _, port = frame["rpc"][0].rpartition(":")
    honest = HTTPClient(host, int(port))
    pubs = {base64.b64encode(k).decode() for k in ready["pubs"]}
    for h, (cm, vals) in zip(heights, res):
        want_cm = await honest.call("commit", height=h)
        want_vals = await honest.call("validators", height=h, per_page=100)
        if cm["signed_header"] != want_cm["signed_header"] or \
                cm["signed_header"]["commit"]["block_id"]["hash"].lower() \
                != ready["hashes"][h - 1]:
            raise AssertionError(f"statesync: the pool's /commit at {h}")
        if [(v["address"], v["pub_key"], v["voting_power"])
                for v in vals["validators"]] != \
                [(v["address"], v["pub_key"], v["voting_power"])
                 for v in want_vals["validators"]] or \
                len(vals["validators"]) != 100 or \
                vals["total"] != want_vals["total"] or \
                vals["total"] != str(P2P_SYNC_VALIDATORS) or \
                any(v["pub_key"]["value"] not in pubs
                    for v in vals["validators"]):
            raise AssertionError(f"statesync: the pool's /validators at {h}")
    # at least one K4 launch at the pool's width, one a device flush
    device = met["verify_launches"].get("device", 0)
    if faults or pool.fault is not None or device < 1 or \
            pool_launches != {"general_verify": device}:
        raise AssertionError(f"statesync: the pool launched {pool_launches} "
                             f"for {met} ({faults})")
    # the forged primary
    trusted = P2P_FORGED_AT - 2
    flc = Client(gdoc.chain_id,
                 TrustOptions(period_ns=period, height=trusted,
                              hash=bytes.fromhex(ready["hashes"][trusted - 1])),
                 rpc_provider(frame["forged_rpc"], "forged"),
                 [rpc_provider(frame["rpc"][3], "witness")],
                 LightStore(MemDB()))
    k2 = exec_counts()
    await flc.initialize()
    fproxy = LightProxy(flc, on_fault=faults.append)
    port = await fproxy.listen("127.0.0.1", 0)
    try:
        await HTTPClient("127.0.0.1", port).call(
            "commit", height=P2P_FORGED_AT - 1)
        refused = None
    except RPCError as e:
        refused = (e.code, e.message[:160])
    finally:
        fproxy.close()
    forged_launches = exec_delta(k2)
    if refused is None or refused[0] != -32603 or \
            "light verification failed" not in refused[1] or faults or \
            flc.store.latest_height() != trusted:
        raise AssertionError(f"statesync: the forged commit was not "
                             f"refused: {refused} {faults}")
    n_req = 2 * len(heights)
    return dict(workers=SS_POOL_WORKERS, clients=SS_POOL_CLIENTS,
                heights=[min(heights), max(heights), len(set(heights))],
                requests=n_req, seconds=pool_s,
                verified_per_s=n_req / pool_s,
                routes_p50_ms={r: statistics.median(ms)
                               for r, ms in sorted(record.items())},
                plane=dict(requests=pool.plane.requests,
                           coalesced=pool.plane.coalesced,
                           cache_hits=pool.plane.cache_hits,
                           sheds=dict(pool.plane.sheds)),
                metrics=met, init_launches=init_launches,
                launches=pool_launches,
                forged=dict(trusted=trusted, height=P2P_FORGED_AT - 1,
                            refused=refused, launches=forged_launches))


async def ss_phase(servers) -> dict:
    """The statesync phase: the join, then the serving pool."""
    ready = getattr(servers, "ready", None)
    if ready is None:
        ready = servers.ready = await servers.aread(timeout=600)
    servers.send({"op": "statesync"})
    frame = await servers.aread()
    gdoc = p2p_genesis(P2P_SYNC_CHAIN, ready["pubs"])
    kernels = wrappers()
    for fn in kernels.values():
        fn.launches = 0
    t = time.perf_counter()
    servers.send({"op": "rpc_stats"})
    await servers.aread()  # nothing before the join
    join = await ss_join(frame, ready, gdoc)
    join["seconds"] = time.perf_counter() - t
    servers.send({"op": "rpc_stats"})
    join["rpc_servers_ms"] = await servers.aread()
    t = time.perf_counter()
    pool = await ss_serving_pool(gdoc, frame, ready)
    pool["phase_s"] = time.perf_counter() - t
    servers.send({"op": "rpc_stats"})
    pool["rpc_servers_ms"] = await servers.aread()
    launches = {k: fn.launches for k, fn in kernels.items() if fn.launches}
    want: dict = {}
    for part in (join["launches"], pool["init_launches"], pool["launches"],
                 pool["forged"]["launches"]):
        for k, n in part.items():
            want[k] = want.get(k, 0) + n
    if launches != want:
        raise AssertionError(f"statesync: launches {launches}, the parts "
                             f"{want}")
    return dict(join=join, serving_pool=pool, launches=launches)


def statesync_phase(servers=None) -> dict:
    """statesync on the card (docstring, phase 17), served by `servers`
    (the p2p phase's `p2p_servers` child; None: started here)."""
    import asyncio

    own = servers is None
    if own:
        servers = P2pChild("p2p_servers")
    try:
        return asyncio.run(ss_phase(servers))
    finally:
        if own:
            servers.close()


# -- phase 17b: the command line --------------------------------------------

CLI_CHAIN = "cli-localnet"
CLI_VALIDATORS = 4
CLI_TX_HEIGHTS = (2, 9)  # node0's client submits while node0 is at [2, 9)
CLI_BURST, CLI_BURST_S = 64, 0.640
CLI_MAVERICK_H = 5  # node3 double-prevotes here (start --misbehavior)
CLI_CRASH_NTH = 2  # node1's restart crashes at its second app commit
CLI_WAIT_S = 180.0
CLI_ROOT = os.path.dirname(os.path.abspath(__file__))
# The device flag of the commands that run on the card (node0's start,
# the signer, light, replay): none, their default. A CPU rehearsal of the
# phase sets ["--device", "cpu"], and the backend its records stamp.
CLI_DEVICE: list = []
CLI_BACKEND = "gpu"


def cli_env(extra=None) -> dict:
    """A command's environment: this checkout on PYTHONPATH, unbuffered
    output, no failpoint, maverick or field variable but `extra`'s."""
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [CLI_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
    for k in ("TM_TPU_FAILPOINTS", "FAIL_TEST_INDEX", "TM_TPU_ENABLE_MAVERICK",
              "TM_TPU_FIELD"):
        env.pop(k, None)
    env.update(extra or {})
    return env


def cli_step(what: str) -> None:
    """A progress line on stderr (stdout carries the phases' JSON)."""
    print(f"cli: {time.strftime('%H:%M:%S')} {what}", file=sys.stderr,
          flush=True)


def cli_argv(argv) -> list:
    return [sys.executable, "-m", "tendermint_tpu_torch.cmd",
            *map(str, argv)]


class CliProc:
    """`python -m tendermint_tpu_torch.cmd <argv>` in a child, from the
    repo's root, its output in `<logs>/<name>.log`."""

    def __init__(self, name: str, argv, logs: str, env=None):
        self.name = name
        self.path = os.path.join(logs, f"{name}.log")
        self.t0 = time.perf_counter()
        with open(self.path, "w") as log:
            self.proc = subprocess.Popen(
                cli_argv(argv), cwd=CLI_ROOT, env=cli_env(env), stdout=log,
                stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL)

    def text(self) -> str:
        with open(self.path, errors="replace") as f:
            return f.read()

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        return self.proc.returncode


def cli_run(times: dict, name: str, argv, timeout: float = 300.0, env=None,
            stdin: str = "") -> tuple[int, str]:
    """One command run to its end: (exit code, output); its wall time
    into times[name]."""
    t = time.perf_counter()
    res = subprocess.run(cli_argv(argv), cwd=CLI_ROOT, env=cli_env(env),
                         input=stdin, capture_output=True, text=True,
                         timeout=timeout)
    times[name] = time.perf_counter() - t
    return res.returncode, res.stdout + res.stderr


def cli_free_base(n: int) -> int:
    """A starting port for `testnet`: base..base+n-1 (p2p) and
    base+1000..base+1000+n-1 (RPC) all free on 127.0.0.1."""
    import random
    import socket

    rng = random.Random(os.getpid())
    for _ in range(500):
        base = rng.randrange(20_000, 40_000)
        socks = []
        try:
            for p in [base + i for i in range(n)] + \
                    [base + 1000 + i for i in range(n)]:
                sk = socket.socket()
                socks.append(sk)
                sk.bind(("127.0.0.1", p))
        except OSError:
            continue
        finally:
            for sk in socks:
                sk.close()
        return base
    raise AssertionError("cli: no free port range for testnet")


def prom_values(text: str, name: str) -> dict:
    """{label string: value} of metric `name` in a Prometheus exposition."""
    out = {}
    for m in re.finditer(rf"^{re.escape(name)}(\{{[^}}]*\}})? (\S+)$", text,
                         re.M):
        out[m.group(1) or ""] = float(m.group(2))
    return out


def cli_admission(text: str) -> dict:
    """A node's admission flushes by backend and its admission ledger
    records by backend, from its /metrics."""
    return dict(
        launches={k: v for k, v in prom_values(
            text, "admission_verify_launches_total").items() if v},
        records={k: v for k, v in prom_values(
            text, "tpu_launch_ledger_records_total").items()
            if 'workload="admission"' in k and v},
        flush_lanes_sum=sum(prom_values(
            text, "admission_batch_lanes_sum").values()),
        flushes=sum(prom_values(text, "admission_batch_lanes_count").values()))


def cli_get(port: int, path: str) -> bytes:
    """One HTTP GET on 127.0.0.1 (the RPC server's /metrics answers with
    a length and keeps the connection; http_get reads to its end)."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return resp.read()


async def cli_height(port: int) -> int:
    from tendermint_tpu_torch.rpc.jsonrpc import HTTPClient

    try:
        st = await HTTPClient("127.0.0.1", port, timeout=10).call("status")
        return int(st["sync_info"]["latest_block_height"])
    except Exception:  # noqa: BLE001 - not up yet, or gone
        return -1


async def cli_wait(port: int, h: int, what: str, procs=(),
                   timeout: float = CLI_WAIT_S) -> int:
    """Node at `port` past height h - 1; fails early if a child died."""
    import asyncio

    deadline = time.perf_counter() + timeout
    while True:
        got = await cli_height(port)
        if got >= h:
            return got
        for p in procs:
            if p.proc.poll() is not None:
                raise AssertionError(f"cli: {p.name} exited "
                                     f"{p.proc.returncode} waiting for "
                                     f"{what}: {p.text()[-3000:]}")
        if time.perf_counter() > deadline:
            raise AssertionError(f"cli: {what}: height {got} < {h}")
        await asyncio.sleep(0.2)


async def cli_blocks(port: int, lo: int, hi: int) -> list:
    """(block hash, app hash, txs, evidence) at heights lo..hi over RPC."""
    import base64

    from tendermint_tpu_torch.rpc.jsonrpc import HTTPClient

    cli = HTTPClient("127.0.0.1", port, timeout=30)
    out = []
    for h in range(lo, hi + 1):
        r = await cli.call("block", height=h)
        b = r["block"]
        out.append((r["block_id"]["hash"], b["header"]["app_hash"],
                    [base64.b64decode(t) for t in b["data"]["txs"]],
                    [(e["type"], base64.b64decode(e["bytes"]))
                     for e in b["evidence"]["evidence"]]))
    return out


async def cli_same_chain(ports, hi: int, what: str, procs=()) -> None:
    """Every node's blocks and app hashes equal to height hi (each node
    waited for until it is there)."""
    for i, p in enumerate(ports):
        await cli_wait(p, hi, f"node{i} at {hi} ({what})", procs)
    chains = [[(bh, ah) for bh, ah, _, _ in await cli_blocks(p, 1, hi)]
              for p in ports]
    if any(c != chains[0] for c in chains):
        raise AssertionError(f"cli: {what}: the nodes' chains differ to "
                             f"height {hi}")


def cli_phase(servers=None) -> dict:
    """The command line (docstring, phase 17b): a localnet written by
    `testnet` and run by `start`, `signer`, `debug`, `light`, `replay`,
    `replay-console` and `unsafe-reset-all` in children, node0 on the
    card; a mixed secp256k1 BatchVerifier; `light` in this process over
    the statesync phase's 1,000-validator RPC servers (`servers`, the
    p2p phase's serving child; None: started here)."""
    import asyncio
    import shutil
    import tempfile

    own = servers is None
    if own:
        servers = P2pChild("p2p_servers")
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="cli-")
    logs = os.path.join(work, "logs")
    os.makedirs(logs)
    times: dict = {}
    out: dict = {"times_s": times}
    procs: list = []
    try:
        out["localnet"] = asyncio.run(cli_localnet(work, logs, times, procs))
        out["secp256k1"] = cli_secp256k1()
        out["light_full"] = cli_light_full(servers, times)
    finally:
        for p in procs:
            p.stop()
        if own:
            servers.close()
        shutil.rmtree(work, ignore_errors=True)
    out["launches"] = {}
    for part in (out["secp256k1"]["launches"],
                 out["light_full"]["launches"]):
        for k, n in part.items():
            out["launches"][k] = out["launches"].get(k, 0) + n
    out["seconds"] = time.perf_counter() - t_phase
    return out


def cli_no_device(work: str, times: dict) -> dict:
    """(g): `start` on a fresh home with no CUDA device visible and no
    `--device cpu` must exit non-zero naming NoDeviceError, bind neither
    of its ports and write no store."""
    import socket

    from tendermint_tpu_torch.config import Config

    cli_step("(g) no silent CPU")
    spare = os.path.join(work, "spare")
    rc, text = cli_run(times, "init", ["--home", spare, "init", "--chain-id",
                                       CLI_CHAIN])
    if rc:
        raise AssertionError(f"cli: init {rc}: {text[-2000:]}")
    scfg_path = os.path.join(spare, "config", "config.toml")
    scfg = Config.load(scfg_path)
    sp2p, srpc = free_ports(2)
    scfg.p2p.laddr = f"tcp://127.0.0.1:{sp2p}"
    scfg.rpc.laddr = f"tcp://127.0.0.1:{srpc}"
    scfg.save(scfg_path)
    rc, text = cli_run(times, "start_no_device", ["--home", spare, "start"],
                       env={"CUDA_VISIBLE_DEVICES": ""})
    for port in (sp2p, srpc):
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", port))  # raises if the start bound it
    if rc == 0 or "NoDeviceError" not in text or os.path.exists(
            os.path.join(spare, "data", "blockstore.db")):
        raise AssertionError(f"cli: start without a device {rc}: "
                             f"{text[-2000:]}")
    return dict(exit_code=rc, line=text.strip().splitlines()[-1])


async def cli_localnet(work: str, logs: str, times: dict, procs: list) -> dict:
    """(a)-(g) of the phase: the localnet of `testnet`, its load, the
    crash and heal, debug bundles, light, replay, the reset and no
    silent CPU. Every child it starts goes into `procs`."""
    import asyncio
    import shutil
    import socket
    import tarfile

    from tendermint_tpu_torch.config import Config
    from tendermint_tpu_torch.p2p.key import NodeKey
    from tendermint_tpu_torch.rpc.jsonrpc import HTTPClient
    from tendermint_tpu_torch.types.evidence import (DuplicateVoteEvidence,
                                                     evidence_from_bytes)

    out: dict = {}
    # (a) the homes: `make localnet`'s four (BASELINE.json config #1)
    net = os.path.join(work, "net")
    base = cli_free_base(CLI_VALIDATORS)
    rc, text = cli_run(times, "testnet", [
        "testnet", "--v", CLI_VALIDATORS, "--o", net, "--chain-id", CLI_CHAIN,
        "--starting-port", base])
    if rc or "Successfully initialized 4 node directories" not in text:
        raise AssertionError(f"cli: testnet {rc}: {text[-2000:]}")
    homes = [os.path.join(net, f"node{i}") for i in range(CLI_VALIDATORS)]
    rpc = [base + 1000 + i for i in range(CLI_VALIDATORS)]
    signer_port, pprof = free_ports(2)
    path0 = os.path.join(homes[0], "config", "config.toml")
    cfg = Config.load(path0)
    cfg.rpc.pprof_laddr = f"tcp://127.0.0.1:{pprof}"
    cfg.mempool.admission = "strict"
    cfg.base.priv_validator_laddr = f"tcp://127.0.0.1:{signer_port}"
    # the signer's link key is node0's node key (cmd signer): pin it
    cfg.base.priv_validator_signer_id = NodeKey.load(
        cfg.base.resolve(cfg.base.node_key_file)).priv_key.pub_key(
        ).address().hex()
    cfg.save(path0)
    vals = []
    for h in homes:
        with open(os.path.join(h, "config", "priv_validator_key.json")) as f:
            vals.append(bytes.fromhex(json.load(f)["address"]))
    # (g) runs beside the net: it needs a fresh home and no card
    no_device = asyncio.get_running_loop().run_in_executor(
        None, cli_no_device, work, times)
    cli_step("(b) the net")
    # (b) the net: node0's key in a signer child, node0 on the card, nodes
    # 1-3 on the CPU, node3 a maverick
    signer = CliProc("signer", ["--home", homes[0], "signer", "--connect",
                                f"tcp://127.0.0.1:{signer_port}",
                                *CLI_DEVICE], logs)
    procs.append(signer)
    nodes = [CliProc("node0", ["--home", homes[0], "start", *CLI_DEVICE],
                     logs)]
    for i in range(1, CLI_VALIDATORS):
        argv = ["--home", homes[i], "start", "--device", "cpu"]
        env = None
        if i == CLI_VALIDATORS - 1:
            argv += ["--misbehavior", f"double-prevote@{CLI_MAVERICK_H}"]
            env = {"TM_TPU_ENABLE_MAVERICK": "1"}
        nodes.append(CliProc(f"node{i}", argv, logs, env))
    procs.extend(nodes)
    await asyncio.gather(*(cli_wait(rpc[i], 1, f"node{i}'s first height",
                                    [nodes[i], signer])
                           for i in range(CLI_VALIDATORS)))
    times["localnet_to_height_1"] = time.perf_counter() - nodes[0].t0
    cli_step("(c) the load")
    # (c) the load: bursts of 64 signed envelopes over node0's RPC at
    # heights 2-8
    height = [await cli_height(rpc[0])]

    async def follow():
        while True:
            height[0] = max(height[0], await cli_height(rpc[0]))
            await asyncio.sleep(0.05)

    follower = asyncio.get_running_loop().create_task(follow())
    t = time.perf_counter()
    try:
        txs, codes = await p2p_submit(
            TimedRpc(rpc[0], {}), b"cli-", CLI_BURST, CLI_BURST_S,
            lambda: height[0], adm_signers(P2P_SIGNERS),
            heights=CLI_TX_HEIGHTS)
    finally:
        follower.cancel()
    times["load"] = time.perf_counter() - t
    if not txs or any(c != 0 for c in codes):
        raise AssertionError(f"cli: node0 refused txs: {codes}")
    cli_step("the load's commits")
    # every tx committed once, within a few heights of the last burst
    top = await cli_height(rpc[0])
    committed: list = []
    got = 0
    while True:
        h = await cli_wait(rpc[0], got + 1, "the load's commits", nodes)
        for blk in await cli_blocks(rpc[0], got + 1, h):
            committed.extend(blk[2])
        got = h
        if set(txs) <= set(committed) or got > top + P2P_DRAIN_HEIGHTS:
            break
    if sorted(committed) != sorted(set(committed)) or \
            set(committed) != set(txs):
        raise AssertionError(f"cli: {len(txs)} txs submitted, "
                             f"{len(committed)} committed to {got}")
    top = max(got, CLI_MAVERICK_H + 3)
    await cli_same_chain(rpc, top, "after the load", nodes)
    evidence = [(h, evidence_from_bytes(raw))
                for h, blk in enumerate(await cli_blocks(rpc[0], 1, top), 1)
                for _, raw in blk[3]]
    if len(evidence) != 1 or \
            not isinstance(evidence[0][1], DuplicateVoteEvidence) or \
            evidence[0][1].vote_a.validator_address != vals[-1] or \
            evidence[0][1].height() != CLI_MAVERICK_H:
        raise AssertionError(f"cli: evidence in the chain {evidence}")
    cli_step("node0's records")
    # node0's admission records on the card, one a flush of 40 or more
    m0 = cli_admission(cli_get(rpc[0], "/metrics").decode())
    launches = json.loads(cli_get(
        pprof, "/debug/launches?workload=admission"))["records"]
    device = m0["launches"].get('{backend="device"}', 0)
    recs = m0["records"].get(f'{{backend="{CLI_BACKEND}",'
                             'workload="admission"}', 0)
    card = cli_card_name()
    if not device or recs != device or len(launches) != device or any(
            (r["kernel"], r["backend"], r["device_name"]) !=
            ("general", CLI_BACKEND, card) or r["lanes"] < 40
            for r in launches):
        raise AssertionError(f"cli: node0's admission records {m0} "
                             f"{launches[:3]}")
    peers = {}
    for i in range(1, CLI_VALIDATORS):
        peers[f"node{i}"] = cli_admission(
            cli_get(rpc[i], "/metrics").decode())
    out["load"] = dict(
        txs=len(txs), top=top, evidence_height=evidence[0][0],
        node0=dict(m0, lanes=[r["lanes"] for r in launches],
                   device_name=card), peers=peers)
    cli_step("(d) the crash")
    # (d) the crash: node1 restarted under a crash failpoint exits by it;
    # restarted again, it heals and rejoins
    nodes[1].stop()
    h_down = await cli_height(rpc[0])
    await cli_wait(rpc[0], h_down + 3, "three heights without node1", nodes[:1])
    crash_env = {"TM_TPU_FAILPOINTS":
                 f"state.apply.app_committed=crash;nth={CLI_CRASH_NTH}"}
    rc, text = cli_run(times, "node1_crash",
                       ["--home", homes[1], "start", "--device", "cpu"],
                       timeout=CLI_WAIT_S, env=crash_env)
    if rc != 1 or "failpoint firing: state.apply.app_committed " \
                  "action=crash" not in text:
        raise AssertionError(f"cli: node1 under the crash failpoint exited "
                             f"{rc}: {text[-3000:]}")
    nodes[1] = CliProc("node1_healed", ["--home", homes[1], "start",
                                        "--device", "cpu"], logs)
    procs.append(nodes[1])
    h_heal = await cli_height(rpc[0])
    await cli_wait(rpc[1], h_heal + 1, "node1 healed", nodes)
    times["node1_heal"] = time.perf_counter() - nodes[1].t0
    await cli_same_chain(rpc, h_heal + 1, "after node1's crash", nodes)
    healed = re.findall(r"recover\w*[^\n]*", nodes[1].text())[:3]
    out["crash"] = dict(exit_code=rc, down_at=h_down, healed_at=h_heal + 1,
                        log=healed)
    cli_step("(e) debug and light")
    # (e) debug dump on node0, light --once, light --laddr
    dump_dir = os.path.join(work, "dump")
    rc, text = cli_run(times, "debug_dump", [
        "--home", homes[0], "debug", "dump", dump_dir, "--count", 1,
        "--rpc-laddr", f"127.0.0.1:{rpc[0]}",
        "--pprof-laddr", f"127.0.0.1:{pprof}"])
    (bundle,) = os.listdir(dump_dir) if rc == 0 else (None,)
    if bundle is None:
        raise AssertionError(f"cli: debug dump {rc}: {text[-2000:]}")
    with tarfile.open(os.path.join(dump_dir, bundle)) as tar:
        names = set(tar.getnames())
        dumped = cli_admission(tar.extractfile("metrics.txt").read().decode())
    want = {"status.json", "net_info.json", "consensus_state.json",
            "goroutine.txt", "heap.txt", "trace.json", "trace_rollup.json",
            "metrics.txt", "node_health.json", "config.toml", "cs.wal"}
    if not want <= names or "INCOMPLETE.txt" in names or \
            dumped["records"] != m0["records"]:
        raise AssertionError(f"cli: debug bundle {sorted(names)} "
                             f"{dumped['records']} != {m0['records']}")
    h1 = (await HTTPClient("127.0.0.1", rpc[0], timeout=30).call(
        "commit", height=1))["signed_header"]["commit"]["block_id"]["hash"]
    light = ["light", CLI_CHAIN, "--primary", f"127.0.0.1:{rpc[0]}",
             "--witnesses", f"127.0.0.1:{rpc[1]},127.0.0.1:{rpc[2]}",
             "--trust-height", 1, "--trust-hash", h1, *CLI_DEVICE]
    (lport,) = free_ports(1)
    proxy = CliProc("light_proxy", [*light, "--laddr",
                                    f"127.0.0.1:{lport}"], logs)
    procs.append(proxy)
    rc, text = await asyncio.to_thread(cli_run, times, "light_once",
                                       [*light, "--once"])
    verified = re.findall(r"^verified height (\d+): ", text, re.M)
    if rc or not verified:
        raise AssertionError(f"cli: light --once {rc}: {text[-2000:]}")
    deadline = time.perf_counter() + CLI_WAIT_S
    while not re.search(r"^verified height \d+", proxy.text(), re.M):
        if proxy.proc.poll() is not None or time.perf_counter() > deadline:
            raise AssertionError(f"cli: light --laddr: {proxy.text()[-2000:]}")
        await asyncio.sleep(0.1)
    times["light_proxy_to_verified"] = time.perf_counter() - proxy.t0
    ph = int(re.findall(r"^verified height (\d+)", proxy.text(), re.M)[-1])
    # the height below the proxy's head: its canonical commit (the next
    # block's LastCommit) is what both serve now; at the head the proxy
    # keeps the commit node0 had seen when it verified it
    via = await HTTPClient("127.0.0.1", lport, timeout=60).call(
        "commit", height=ph - 1)
    direct = await HTTPClient("127.0.0.1", rpc[0], timeout=30).call(
        "commit", height=ph - 1)
    if via["signed_header"] != direct["signed_header"]:
        raise AssertionError(f"cli: the proxy's /commit at {ph - 1} "
                             f"differs")
    proxy.stop()
    out["light"] = dict(once_verified=int(verified[-1]), proxy_height=ph)
    cli_step("(f) replay and reset")
    # (f) replay-console and replay on copies of node2's stopped home,
    # unsafe-reset-all on a third, which starts again as node2 and
    # fast-syncs back
    nodes[2].stop()
    h_stop = await cli_height(rpc[0])
    copy_a, copy_b, copy_c = (os.path.join(work, f"node2_{c}")
                              for c in "abc")
    for c in (copy_a, copy_b, copy_c):
        shutil.copytree(homes[2], c)
    rc, text = cli_run(times, "unsafe_reset_all",
                       ["--home", copy_b, "unsafe-reset-all"])
    if rc or "Removed all data in" not in text or os.path.exists(
            os.path.join(copy_b, "data", "blockstore.db")):
        raise AssertionError(f"cli: unsafe-reset-all {rc}: {text[-2000:]}")
    # the reset copy starts as node2 while the other two replay (a
    # replay builds a node but binds none of its ports)
    nodes[2] = CliProc("node2_reset", ["--home", copy_b, "start", "--device",
                                       "cpu"], logs)
    procs.append(nodes[2])
    h_back = await cli_height(rpc[0])
    console, replay = await asyncio.gather(
        asyncio.to_thread(cli_run, times, "replay_console",
                          ["--home", copy_a, "replay-console"],
                          stdin="1000000\n"),
        asyncio.to_thread(cli_run, times, "replay",
                          ["--home", copy_c, "replay", *CLI_DEVICE]))
    rc, text = console
    m = re.search(r"end of WAL \((\d+) messages\)", text)
    if rc or not m or int(m.group(1)) == 0:
        raise AssertionError(f"cli: replay-console {rc}: {text[-2000:]}")
    wal_messages = int(m.group(1))
    rc, text = replay
    m = re.search(r"replay complete; consensus at height (\d+)", text)
    if rc or not m:
        raise AssertionError(f"cli: replay {rc}: {text[-2000:]}")
    replay_h = int(m.group(1))
    await cli_wait(rpc[2], h_back, "node2 after the reset", nodes)
    times["node2_fast_sync_back"] = time.perf_counter() - nodes[2].t0
    await cli_same_chain(rpc, h_back, "after node2's reset", nodes)
    out["reset"] = dict(stopped_at=h_stop, wal_messages=wal_messages,
                        replay_height=replay_h, back_to=h_back,
                        log=[ln for ln in nodes[2].text().splitlines()
                             if "fast" in ln.lower()][:3])
    out["no_device"] = await no_device
    cli_step("debug kill")
    # debug kill on node0: the bundle written, the process gone
    kill_out = os.path.join(work, "kill.tar.gz")
    rc, text = cli_run(times, "debug_kill", [
        "--home", homes[0], "debug", "kill", nodes[0].proc.pid, kill_out,
        "--rpc-laddr", f"127.0.0.1:{rpc[0]}",
        "--pprof-laddr", f"127.0.0.1:{pprof}"])
    try:
        code0 = nodes[0].proc.wait(30)
    except subprocess.TimeoutExpired:
        code0 = None
    with tarfile.open(kill_out) as tar:
        knames = set(tar.getnames())
    if rc or code0 in (None, 0) or "INCOMPLETE.txt" in knames or \
            "consensus_state.json" not in knames:
        raise AssertionError(f"cli: debug kill {rc}, node0 {code0}: "
                             f"{text[-2000:]}")
    out["kill"] = dict(node0_exit=code0, bundle=len(knames))
    # the node logs' launch lines: node0 on the card, the peers' flushes
    out["node0_started"] = bool(re.search(r"node node0 started",
                                          nodes[0].text()))
    for p in procs:
        p.stop()
    return out


def cli_card_name() -> str:
    import torch

    return torch.cuda.get_device_name(0) if CLI_BACKEND == "gpu" else ""


def cli_secp256k1() -> dict:
    """(h): a BatchVerifier of 64 ed25519 and 8 secp256k1 lanes, one bad
    signature of each type: K4 once for the ed25519 lanes, the
    secp256k1 lanes on the host; verdicts equal to the keys' own."""
    from tendermint_tpu_torch.crypto.batch import BatchVerifier
    from tendermint_tpu_torch.crypto.ed25519 import Ed25519PrivKey
    from tendermint_tpu_torch.crypto.secp256k1 import Secp256k1PrivKey

    items = []
    for i in range(64):
        k = Ed25519PrivKey(hashlib.sha256(b"cli-ed-%d" % i).digest())
        m = b"cli ed25519 %d" % i
        items.append((k.pub_key(), m, k.sign(m)))
    for i in range(8):
        k = Secp256k1PrivKey.from_secret(b"cli-secp-%d" % i)
        m = b"cli secp256k1 %d" % i
        items.append((k.pub_key(), m, k.sign(m)))
    pk, m, s = items[17]
    items[17] = (pk, m, s[:5] + bytes([s[5] ^ 4]) + s[6:])
    pk, m, s = items[64 + 3]
    items[64 + 3] = (pk, m + b"?", s)
    bv = BatchVerifier()
    for it in items:
        bv.add(*it)
    k0 = exec_counts()
    t = time.perf_counter()
    ok, lanes = bv.verify()
    ms = (time.perf_counter() - t) * 1e3
    launches = exec_delta(k0)
    oracle = [pk.verify_signature(m, s) for pk, m, s in items]
    if ok or lanes.tolist() != oracle or launches != {"general_verify": 1} \
            or sorted(i for i, v in enumerate(oracle) if not v) != [17, 67]:
        raise AssertionError(f"cli: the mixed secp256k1 batch {launches} "
                             f"{[i for i, v in enumerate(lanes) if not v]}")
    return dict(lanes=len(items), rejected=[17, 67], ms=ms,
                launches=launches)


def cli_light_full(servers, times: dict) -> dict:
    """(i): `light --once` in this process over two of the statesync
    phase's RPC servers (BASELINE.json config #3's 1,000-validator chain,
    129 blocks), trusted at height 1 by hash; the expanded-table cache
    cleared and the counters read before and after."""
    import asyncio
    import contextlib
    import io

    from tendermint_tpu_torch import cmd
    from tendermint_tpu_torch.crypto.cuda import expanded

    async def frames():
        ready = getattr(servers, "ready", None)
        if ready is None:
            ready = servers.ready = await servers.aread(timeout=600)
        servers.send({"op": "statesync"})
        return ready, await servers.aread()

    ready, frame = asyncio.run(frames())
    with expanded._CACHE_LOCK:
        expanded._CACHE.clear()  # a fresh light client builds its tables
    argv = ["light", P2P_SYNC_CHAIN, "--primary", frame["rpc"][0],
            "--witnesses", frame["rpc"][1], "--trust-height", "1",
            "--trust-hash", ready["hashes"][0], "--trust-period",
            str(SS_TRUST_PERIOD_S), "--once", *CLI_DEVICE]
    buf = io.StringIO()
    k0 = exec_counts()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cmd.main(argv)
    times["light_1000_validators"] = time.perf_counter() - t
    launches = exec_delta(k0)
    text = buf.getvalue()
    m = re.findall(r"^verified height (\d+): ", text, re.M)
    if rc or not m or not launches.get("xverify") or \
            set(launches) - {"build_tables", "xverify", "general_verify"}:
        raise AssertionError(f"cli: light at 1,000 validators {rc} "
                             f"{launches}: {text[-2000:]}")
    return dict(verified_height=int(m[-1]), launches=launches,
                lines=text.strip().splitlines())


# -- phase 17c -----------------------------------------------------------

# The deterministic simulator under the device backend: mesh_device_loss
# on four logical shards of the card (seeds 1 and 2, each twice), the
# bad-signature flood trust_collapse (seed 3) and the acceptance net
# wan_50 (seed 1) at its 50 nodes, as the catalog defines them.
SIM_MESH = ["cuda:0"] * LOGICAL_SHARDS
SIM_MESH_SEEDS = (1, 2)
SIM_FLOOD_SEED = 3
SIM_WAN_SEED = 1
# trust_collapse's 5 validators stay under the 40-lane crossover (the
# CPU rehearsal: no launch), as in the reference.
SIM_FLOOD_LAUNCHES: dict = {}
# sim_digest of a run's per-height app hashes: pinned from the first
# chip run, so every later run holds determinism across processes on the
# card. SIM_HOST_DIGESTS: the JAX package's digest of the same pair
# under "host" on a CPU box (its gossip picks drawn from the port's
# seed, as tests/test_torch_sim.py draws them), computed once.
SIM_DIGESTS = {("wan_50", 1): "bfce3800c3c9fb9e"}
SIM_HOST_DIGESTS = {("wan_50", 1): "bfce3800c3c9fb9e"}
SIM_SPAN_KINDS = ("crypto.device_exec", "state.apply_block",
                  "crypto.host_verify", "crypto.verify")


def sim_digest(app_hashes) -> str:
    return hashlib.sha256(json.dumps(app_hashes).encode()).hexdigest()[:16]


class SpanTally:
    """The durations (ms) of SIM_SPAN_KINDS spans closed while it is
    installed as the tracer's metrics sink (chained to the one it
    replaces): a 50-node net closes far more spans than the ring holds."""

    def __init__(self):
        self.ms = {k: [] for k in SIM_SPAN_KINDS}

    def __enter__(self):
        from tendermint_tpu_torch.libs import tracing

        self.tracer = tracing.TRACER
        self.prev = self.tracer.metrics_sink
        self.tracer.set_metrics_sink(self.sink)
        return self

    def sink(self, kind: str, seconds: float) -> None:
        if kind in self.ms:
            self.ms[kind].append(seconds * 1e3)
        if self.prev is not None:
            self.prev(kind, seconds)

    def __exit__(self, *exc) -> bool:
        self.tracer.set_metrics_sink(self.prev)
        return False

    def p50(self, kind: str):
        v = self.ms[kind]
        return statistics.median(v) if v else None


class LaunchWatch:
    """crypto.cuda.verify.verify_batch (BatchVerifier's device route)
    wrapped while a scenario runs: a port fault (crypto.batch.UNCAUGHT)
    from a launch halts the node that met it, which the simulator
    reports only as stalled heights, so it is kept here and re-raised
    after the run."""

    def __enter__(self):
        from tendermint_tpu_torch.crypto import batch as cbatch
        from tendermint_tpu_torch.crypto.cuda import verify

        self.verify, self.uncaught = verify, cbatch.UNCAUGHT
        self.orig = verify.verify_batch
        self.faults: list = []

        def watched(*a, **kw):
            try:
                return self.orig(*a, **kw)
            except self.uncaught as e:
                self.faults.append(e)
                raise

        verify.verify_batch = watched
        return self

    def __exit__(self, *exc) -> bool:
        self.verify.verify_batch = self.orig
        if exc[0] is None and self.faults:
            raise self.faults[0]
        return False


def sim_run(scenario, seed: int) -> dict:
    """One scenario run under the device backend: its report, the
    launches by kernel (counters read just before and after), the
    ledger records it added, and its span tally. Every invariant must
    hold."""
    from tendermint_tpu_torch.crypto.cuda import ledger
    from tendermint_tpu_torch.sim import run_scenario

    cap = ledger.capacity()
    ledger.set_capacity(max(cap, 1 << 16))
    try:
        t_mono = time.monotonic()
        k0 = exec_counts()
        with SpanTally() as tally, LaunchWatch():
            report = run_scenario(scenario, seed)
        launches = exec_delta(k0)
        records = [r for r in ledger.snapshot() if r["mono"] >= t_mono]
    finally:
        ledger.set_capacity(cap)
    if report["violations"]:
        raise AssertionError(f"sim: {scenario.name} seed {seed}: "
                             f"{report['violations']}")
    return dict(report=report, launches=launches, records=records,
                tally=tally)


def sim_mesh_runs() -> dict:
    """(a): mesh_device_loss under "device" on four logical shards of
    the card, seeds SIM_MESH_SEEDS, each twice. The probe must evict a
    real entry of that mesh (its fourth), the watchdog report it and the
    entry come back; the backend breaker stays closed; each run moves
    the fallback counters by exactly one eviction (that entry, reason
    "scenario") and nothing else; equal app hashes within a seed,
    different ones across the seeds."""
    import copy

    from tendermint_tpu_torch import device
    from tendermint_tpu_torch.crypto.cuda import verify
    from tendermint_tpu_torch.sim import SCENARIOS

    device.set_mesh(SIM_MESH)
    try:
        names = list(verify._mesh().names)
        runs = []
        for seed in SIM_MESH_SEEDS:
            for _ in range(2):
                sc = SCENARIOS["mesh_device_loss"]()
                # set on the instance: dataclasses.replace drops the probe
                sc.verify_backend = "device"
                before = fallback_state()
                r = sim_run(sc, seed)
                rep = r["report"]
                dev = rep["mesh_device"]
                want = copy.deepcopy(before["metrics"])
                key = (dev, "scenario")
                want["evictions"][key] = want["evictions"].get(key, 0) + 1
                after = fallback_state()
                if dev != names[3] or dev not in rep["mesh_evicted"] or \
                        dev in rep["mesh_readmitted"] or r["launches"] or \
                        after["metrics"] != want or any(
                            v != "closed" for v in
                            list(after["breakers"].values())
                            + list(after["device_breakers"].values())):
                    raise AssertionError(
                        f"sim: mesh_device_loss seed {seed}: {dev} of "
                        f"{names}, {rep['mesh_evicted']} -> "
                        f"{rep['mesh_readmitted']}, {r['launches']}, "
                        f"{before} -> {after}")
                runs.append(dict(seed=seed, entry=dev,
                                 evicted=rep["mesh_evicted"],
                                 readmitted=rep["mesh_readmitted"],
                                 heights=rep["final_heights"],
                                 digest=sim_digest(rep["app_hashes"]),
                                 wall_s=rep["wall_s"]))
    finally:
        device.set_mesh(None)
    digests = {s: {r["digest"] for r in runs if r["seed"] == s}
               for s in SIM_MESH_SEEDS}
    if any(len(d) != 1 for d in digests.values()) or \
            len(set.union(*digests.values())) != len(SIM_MESH_SEEDS):
        raise AssertionError(f"sim: mesh_device_loss digests {digests}")
    return dict(mesh=names, runs=runs)


def sim_flood_run() -> dict:
    """(b): trust_collapse (the bad-signature flood) under "device": its
    5 validators' batches stay under the crossover, so the launches are
    SIM_FLOOD_LAUNCHES."""
    import dataclasses

    from tendermint_tpu_torch.sim import SCENARIOS

    state = fallback_state()
    r = sim_run(dataclasses.replace(SCENARIOS["trust_collapse"](),
                                    verify_backend="device"),
                SIM_FLOOD_SEED)
    no_fallback("sim", state)
    if r["launches"] != SIM_FLOOD_LAUNCHES:
        raise AssertionError(f"sim: trust_collapse launched "
                             f"{r['launches']}, predicted "
                             f"{SIM_FLOOD_LAUNCHES}")
    rep = r["report"]
    return dict(seed=SIM_FLOOD_SEED, launches=r["launches"],
                heights=rep["final_heights"], wall_s=rep["wall_s"],
                host_batches=len(r["tally"].ms["crypto.host_verify"]),
                digest=sim_digest(rep["app_hashes"]))


def sim_wan_run(name: str) -> dict:
    """(c): wan_50 at seed SIM_WAN_SEED under "device", as the catalog
    defines it. Every invariant green, evidence committed, K4 launched,
    every ledger record of the run on the card with its name and verdict
    ok, no fallback; its digest equal to SIM_DIGESTS once pinned."""
    import dataclasses

    from tendermint_tpu_torch.sim import SCENARIOS

    state = fallback_state()
    r = sim_run(dataclasses.replace(SCENARIOS["wan_50"](),
                                    verify_backend="device"), SIM_WAN_SEED)
    no_fallback("sim", state)
    rep, recs, tally = r["report"], r["records"], r["tally"]
    digest = sim_digest(rep["app_hashes"])
    pinned = SIM_DIGESTS[("wan_50", SIM_WAN_SEED)]
    k4 = r["launches"].get("general_verify", 0)
    bad = [x for x in recs if x["backend"] != "gpu"
           or x["device_name"] != name or x["verdict"] != "ok"]
    if rep["evidence_committed"] < 1 or min(rep["final_heights"]) < 10 \
            or rep["restarts"][7] != 1 or not k4 or bad \
            or set(r["launches"]) != {"general_verify"} \
            or len(recs) != k4 or (pinned is not None and digest != pinned):
        raise AssertionError(
            f"sim: wan_50 {r['launches']} evidence "
            f"{rep['evidence_committed']} heights {rep['final_heights']} "
            f"records {len(recs)} bad {bad[:3]} digest {digest} "
            f"pinned {pinned}")
    lanes: dict = {}
    for x in recs:
        lanes[x["lanes"]] = lanes.get(x["lanes"], 0) + 1
    return dict(
        seed=SIM_WAN_SEED, wall_s=rep["wall_s"],
        final_heights=rep["final_heights"],
        evidence_committed=rep["evidence_committed"],
        restarts=rep["restarts"], net=rep["net"],
        launches=r["launches"],
        lanes_per_launch={str(k): lanes[k] for k in sorted(lanes)},
        batches={"host": len(tally.ms["crypto.host_verify"]),
                 "device": len(tally.ms["crypto.verify"])},
        p50_ms={"crypto.device_exec": tally.p50("crypto.device_exec"),
                "state.apply_block": tally.p50("state.apply_block")},
        spans={k: len(v) for k, v in tally.ms.items()},
        digest=digest, pinned=pinned,
        same_as_host=digest == SIM_HOST_DIGESTS[("wan_50", SIM_WAN_SEED)])


def sim_phase() -> dict:
    """The simulator on the card (docstring, phase 17c)."""
    import torch

    t_phase = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    out = {"mesh_device_loss": sim_mesh_runs(),
           "trust_collapse": sim_flood_run(),
           "wan_50": sim_wan_run(name)}
    out["launches"] = dict(out["wan_50"]["launches"])
    out["seconds"] = time.perf_counter() - t_phase
    return out


# -- phase 18 ------------------------------------------------------------


def timing_phase(vs, commit, dev) -> list[dict]:
    """Each kernel at the main path's shapes: time, plain time, bound,
    agreement with the plain version."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import expanded
    from tendermint_tpu_torch.types.sign_batch import CommitSignBatch

    exp = expanded.get_expanded([v.pub_key.bytes() for v in vs.validators])
    n = len(vs.validators)
    lanes = list(range(n))
    sigs = [cs.signature for cs in commit.signatures]
    rows = []
    # K1 at the set's size
    k1 = lambda: expanded.build_tables(exp.akeys)  # noqa: E731
    tab_k, ok_k = k1()
    (tab_p, ok_p), p_ms = plain_ms(lambda: expanded.build_tables_plain(exp.akeys))
    err = max(max_abs_diff(tab_k, tab_p), max_abs_diff(ok_k, ok_p))
    del tab_p
    # per key: decompress, then 7 adds per window and 4 doublings
    # between windows (none after the last); a failed key's table is
    # the identity throughout and needs no adds
    ops = (n * DECOMPRESS + sqrt_m1_branches(exp.akeys) * MUL
           + int(ok_k.sum().item()) * (69 * 7 * ADD + 68 * 4 * DOUBLE))
    nbytes = n * 32 + tab_k.numel() * 4 + n
    del tab_k
    rows.append(entry("build_tables", err, kernel_times(k1, 3), p_ms, ops,
                      nbytes))
    rows[-1]["launch"] = launch_info("build_tables", n)
    torch.cuda.empty_cache()
    # K3 in the structured form on the commit: the main path's launch,
    # K2's assembly inside it
    row, k2 = k3_row("xverify", exp, lanes,
                     CommitSignBatch(CHAIN, commit, lanes), sigs, dev)
    rows.append(row)
    k3, sargs, v_k = k2["times"], k2["sargs"], k2["verdicts"]
    m_p, nb_p = k2["msg"]
    # K2: no launch of its own. What it adds to the launch that carries
    # it: the structured K3's times less the bytes form's on the same
    # lanes, given the rows the plain version assembles; the two forms'
    # verdicts must agree
    bform = dict(msg=m_p, nblocks=nb_p)
    k3b = kernel_times(lambda: expanded.xverify(*sargs, **bform), 10)
    err = max_abs_diff(expanded.xverify(*sargs, **bform), v_k)
    # it reads per live lane the patch and three ints, and the templates;
    # it writes no message to device memory
    row = entry("assemble", err, {k: k3[k] - k3b[k] for k in k3},
                k2["assemble_ms"], 0, k2["live"] * (24 + 3 * 4) + k2["tpl_bytes"])
    row.update(inside="xverify, shard_verify: the structured form",
               structured_xverify=k3, bytes_form_xverify=k3b)
    rows.append(row)
    # K4 at BatchVerifier's 64-lane shape (one 128-lane bucket)
    rows.append(k4_row("general_verify", k4_args(vs, commit, range(64),
                                                 dev), 64))
    return rows


def k3_row(name, exp, lanes, sbatch, sigs, dev):
    """K3 in the structured form (K2's assembly inside the launch) on
    `sbatch`'s lanes over exp's tables, as verify_structured prepares
    them: time, plain time, bound, launch shape and agreement with the
    plain version; every real lane must verify. Returns the row and
    what K2's row reads (the launch's arguments and verdicts, the plain
    assembly's rows and time, the live lanes, the templates' bytes)."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import expanded, verify

    n = len(lanes)
    idx, fields, _wf, width = exp._prepare_structured(lanes, sbatch, sigs)
    f = verify.to_device(dict(fields, idx=idx), dev)
    btab = verify._btab(dev)
    sargs = (f["idx"], exp.akeys, f["sb"], f["s_ok"], exp.key_ok, exp.tables,
             btab)
    tpl = (f["pre"], f["pre_len"], f["suf"], f["suf_len"])
    sform = dict(templates=tpl,
                 patches=(f["patch"], f["split"], f["patch_len"], f["group"]),
                 width=width)
    v_k = expanded.xverify(*sargs, **sform)
    v_p, p_ms = plain_ms(lambda: expanded.shard_verify_plain(*sargs, **sform))
    if not bool(v_k[:n].all()):
        raise AssertionError(f"{name}: K3 rejects a valid lane")
    # R of one lane and the first patch byte of another: exactly those
    # two lanes must fail, in the kernel as in the plain version
    bad = (n // 3, 2 * n // 3)
    sb_f, patch_f = f["sb"].clone(), f["patch"].clone()
    sb_f[bad[0], 0] ^= 1
    patch_f[bad[1], 0] ^= 1
    fargs = (sargs[0], sargs[1], sb_f, *sargs[3:])
    fform = dict(sform, patches=(patch_f, *sform["patches"][1:]))
    f_k = expanded.xverify(*fargs, **fform)
    want = torch.ones(n, dtype=torch.bool)
    want[list(bad)] = False
    if not torch.equal(f_k[:n].cpu(), want):
        raise AssertionError(f"{name}: K3 on the flipped copy")
    sel = flip_neighbours(bad, n, f_k.device)
    err = max(max_abs_diff(v_k, v_p), max_abs_diff(
        f_k[sel], expanded.shard_verify_plain(
            fargs[0][sel], fargs[1], sb_f[sel], fargs[3][sel], *fargs[4:],
            **dict(fform, patches=tuple(t[sel] for t in fform["patches"])))))
    (m_p, nb_p), a_ms = plain_ms(lambda: expanded.assemble_plain(
        *tpl, *sform["patches"], width))
    # the work of the real lanes only: the padding's verdicts are not
    # needed
    real = torch.arange(f["idx"].shape[0], device=f["idx"].device) < n
    ops, lane_bytes, msg_bytes, m = xverify_work(
        exp.akeys, exp.key_ok, f["idx"], f["sb"], f["s_ok"].bool() & real,
        m_p, nb_p)
    # and per live lane its patch, split, patch_len and group; the
    # templates; the comb
    tpl_bytes = sum(t.numel() * t.element_size() for t in tpl)
    nbytes = lane_bytes + m * (24 + 3 * 4) + tpl_bytes + btab.numel() * 4
    times = kernel_times(lambda: expanded.xverify(*sargs, **sform), 10)
    row = entry(name, err, times, p_ms, ops, nbytes)
    row.update(lanes=int(f["idx"].shape[0]), real_lanes=n,
               flipped_lanes=list(bad), groups=int(sbatch.pre.shape[0]),
               launch=launch_info(name, int(f["idx"].shape[0]), 1))
    return row, dict(times=times, sargs=sargs, verdicts=v_k, msg=(m_p, nb_p),
                     assemble_ms=a_ms, live=m, tpl_bytes=tpl_bytes)


def flip_neighbours(bad, n: int, device):
    """The flipped lanes and their neighbours among the first n: where
    a row's flipped copy is held against the plain version."""
    import torch

    return torch.tensor(sorted({b + d for b in bad for d in (-1, 0, 1)
                                if 0 <= b + d < n}), device=device)


def xverify_work(akeys, key_ok, idx, sb, s_ok, msg, nblocks):
    """K3's work (K5's too) on the lanes whose verdict is not already
    false (padding, S >= L, a bad key): (int32 products; bytes of idx,
    signature, s_ok, key_ok, key and the table entries read per lane;
    the message bytes SHA-512 reads; live lanes)."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import scalar

    ki = idx.to(torch.int64)
    live = s_ok.bool() & key_ok[ki].bool()
    m, ki, sb = int(live.sum().item()), ki[live], sb[live]
    dig_k, dig_s = lane_digits(akeys[ki], sb, msg[live], nblocks[live])
    dig_k = scalar.recode_signed(dig_k)
    # per lane: decompress R, a table add per nonzero signed digit, a
    # comb add per nonzero S nibble, + the other sum, + (-R), x8
    ops = (m * DECOMPRESS + sqrt_m1_branches(sb[:, :32]) * MUL
           + adds_after_first(dig_k) * ADD + adds_after_first(dig_s) * ADD_Z1
           + m * (2 * ADD + 3 * DOUBLE))
    msg_bytes = int((nblocks[live].to(torch.int64) * 128 - 64).sum().item())
    lane_bytes = (m * (4 + 64 + 1 + 1 + 32)
                  + int((dig_k != 0).sum().item()) * ENTRY_BYTES)
    return ops, lane_bytes, msg_bytes, m


def general_work(ab, sb, msg, nblocks, live) -> tuple[int, int]:
    """K4's work on the lanes `live` (the others' verdicts are already
    false): (int32 products, bytes read of keys, signatures, s_ok,
    nblocks and the message blocks SHA-512 reads)."""
    import torch

    ab, sb, m = ab[live], sb[live], int(live.sum().item())
    msg, nblocks = msg[live], nblocks[live]
    dig_k, dig_s = lane_digits(ab, sb, msg, nblocks)
    top = torch.where(dig_k != 0, torch.arange(69, device=ab.device)[:, None],
                      0).max(0).values  # doublings start after it
    # per lane: decompress A and R, the 16-entry table of -A (14 adds),
    # 4 doublings per window below k's top nonzero nibble, an add per
    # nonzero nibble of k and of S, + the other sum, + (-R), x8
    ops = (2 * m * DECOMPRESS
           + (sqrt_m1_branches(ab) + sqrt_m1_branches(sb[:, :32])) * MUL
           + m * 14 * ADD + int(top.sum().item()) * 4 * DOUBLE
           + adds_after_first(dig_k) * ADD + adds_after_first(dig_s) * ADD_Z1
           + m * (2 * ADD + 3 * DOUBLE))
    msg_bytes = int((nblocks.to(torch.int64) * 128 - 64).sum().item())
    return ops, m * (32 + 64 + 4 + 1) + msg_bytes


def arena_rows(arena, vs, commit, dev) -> list[dict]:
    """K6 (splice of one 1,024-row burst, clear) and K7 at the
    speculation phase's shapes, on the plane's arena as the phase left
    it: time, plain time, bound, the library call's time for the
    splice, and agreement with the plain version."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import resident

    rows = []
    n = arena.capacity
    # K6 splice: the last burst's rows again, into copies of the buffers
    b = dict(ts=[cs.timestamp for cs in commit.signatures],
             sigs=[cs.signature for cs in commit.signatures])
    keep = list(range(len(vs.validators) - SPEC_BURST, len(vs.validators)))
    args = splice_args(arena, b, keep)
    packed_np = arena.pack(*args)
    packed = torch.from_numpy(packed_np).to(dev)
    bufs_k = [t.clone() for t in arena.buffers()]
    bufs_p = [t.clone() for t in arena.buffers()]
    resident.splice(*bufs_k, packed)
    _, p_ms = plain_ms(lambda: resident.splice_plain(*bufs_p, packed))
    err = max(max_abs_diff(x, y) for x, y in zip(bufs_k, bufs_p))
    k = len(keep)
    row = entry("splice", err,
                kernel_times(lambda: resident.splice(*bufs_k, packed), 100),
                p_ms, 0, k * (resident.ROW_BYTES + SPLICE_WRITE))
    lib_t = kernel_times(index_copy_splice(bufs_p, packed), 100)
    row["library_ms"] = lib_t["ms"]
    row["library_wrapper_us"] = lib_t["wrapper_us"]
    # the burst's upload as the arena makes it (its pinned staging
    # buffer, one asynchronous copy) and as a pageable copy, and the
    # arena's whole splice of it (pack, upload, K6): host ms, medians
    row.update(
        staged_upload_ms=host_ms(lambda: arena._splice._upload(packed_np)),
        pageable_upload_ms=host_ms(
            lambda: torch.from_numpy(packed_np).to(dev)),
        arena_splice_ms=host_ms(lambda: arena.splice(*args)))
    rows.append(row)
    # K6 clear at the arena's capacity
    act_k, act_p = arena._active.clone(), arena._active.clone()
    resident.clear(act_k)
    _, p_ms = plain_ms(lambda: resident.clear_plain(act_p))
    rows.append(entry("clear", max_abs_diff(act_k, act_p),
                      kernel_times(lambda: resident.clear(act_k), 100), p_ms,
                      0, n))
    # over the active lanes the last flush verified, all of them valid
    rows.append(k7_row(arena))
    return rows


def spec_arena(vs, commit, bid, dev):
    """The speculation phase's arena as its last flush leaves it, built
    without the plane: the plane's capacity (SpeculationConfig
    arena_lanes), every validator's key at slot index + 1, the
    commit's precommit template as group 1 and every signature spliced
    (12,288 lanes, 10,241 active at 10,240 validators)."""
    from tendermint_tpu_torch.config import SpeculationConfig
    from tendermint_tpu_torch.crypto.cuda import resident
    from tendermint_tpu_torch.types import canonical
    from tendermint_tpu_torch.types.vote import VoteType

    n = len(vs.validators)
    arena = resident.ResidentArena(SpeculationConfig().arena_lanes, device=dev)
    arena.install_keys([v.pub_key.bytes() for v in vs.validators])
    arena.set_template(1, *canonical.vote_sign_parts(
        CHAIN, int(VoteType.PRECOMMIT), commit.height, commit.round, bid))
    b = dict(ts=[cs.timestamp for cs in commit.signatures],
             sigs=[cs.signature for cs in commit.signatures])
    arena.splice(*splice_args(arena, b, range(n)))
    return arena


def k7_row(arena) -> dict:
    """K7 over the arena's active lanes, all of them valid: time, plain
    time, bound, launch shape and agreement with the plain version."""
    from tendermint_tpu_torch.crypto.cuda import expanded, resident

    n = arena.capacity
    largs = arena.launch_args()
    v_k = resident.arena_verify(*largs)
    v_p, p_ms = plain_ms(lambda: resident.arena_verify_plain(*largs))
    err = max_abs_diff(v_k, v_p)
    if not bool(v_k[largs[3]].all()):
        raise AssertionError("K7 rejects a valid active lane")
    (ab, sbuf, s_okb, act, pre, pre_len, suf, suf_len, pat, spl, plen, grp,
     btab) = largs
    live = act.nonzero()[:, 0]
    msg, nblocks = expanded.assemble_plain(pre, pre_len, suf, suf_len,
                                           pat[live], spl[live], plen[live],
                                           grp[live], arena.width)
    ops, _ = general_work(ab[live], sbuf[live], msg, nblocks, s_okb[live])
    # per active lane: key, signature, s_ok, patch, split, patch_len and
    # group; every lane's active flag and verdict; templates and the comb
    nbytes = (live.numel() * (32 + 64 + 1 + 24 + 3 * 4) + 2 * n
              + sum(t.numel() * t.element_size()
                    for t in (pre, pre_len, suf, suf_len))
              + btab.numel() * 4)
    row = entry("arena_verify", err,
                kernel_times(lambda: resident.arena_verify(*largs), 5),
                p_ms, ops, nbytes)
    row["lanes"], row["active_lanes"] = n, int(live.numel())
    row["launch"] = launch_info("arena_verify", n)
    return row


def index_copy_splice(bufs, packed):
    """The splice of the packed delta rows into the seven buffers (K6's
    order) by seven index_copy_ calls: the library yardstick. Returns
    the call."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import resident

    k = packed.numel() // resident.ROW_BYTES
    ints = packed[:16 * k].view(torch.int32).reshape(4, k)
    rest = packed[16 * k:]
    pos = ints[0].to(torch.int64)
    d_sb = rest[:64 * k].reshape(k, 64)
    d_patch = rest[64 * k:88 * k].reshape(k, 24)
    d_sok = rest[88 * k:].to(torch.bool)
    ones = torch.ones(k, dtype=torch.bool, device=packed.device)
    sb, s_ok, patch, split, patch_len, group, active = bufs

    def library():
        sb.index_copy_(0, pos, d_sb)
        s_ok.index_copy_(0, pos, d_sok)
        patch.index_copy_(0, pos, d_patch)
        split.index_copy_(0, pos, ints[1])
        patch_len.index_copy_(0, pos, ints[2])
        group.index_copy_(0, pos, ints[3])
        active.index_copy_(0, pos, ones)

    return library


def host_ms(fn, reps: int = 20) -> float:
    """Median host milliseconds of a call of fn, synchronized."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def row_launches(name: str, launches: dict) -> int:
    """A kernels-line row's launches on the paths' runs (`launches`, by
    wrapper): its kernel's (ROW_KERNEL), or for K2 those of the launches
    that carry it (INSIDE)."""
    return sum(launches.get(k, 0) for k in
               INSIDE.get(name, (ROW_KERNEL.get(name, name),)))


def plain_ms(fn):
    """One call's result and host milliseconds, synchronized."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, (time.perf_counter() - t0) * 1e3


def entry(name, err, times, plain, ops, nbytes) -> dict:
    """A kernels-line row: `times` is kernel_times' (device ms, wrapper
    us a call)."""
    t_ops = ops / OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if err != 0:
        raise AssertionError(f"{name} differs from its plain version: {err}")
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": None,
            "max_abs_err": err, **times, "plain_ms": plain,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


# -- the native packer: kernels and timing ------------------------------

NATIVE_FLUSH = 512  # an admission flush's bucket
NATIVE_WINDOW_EXTRA = 1024  # a fast-sync window: the commit's 10,240 + these


class CountingPack:
    """The native library with its tm_pack_pad calls counted (`calls`,
    and the messages they padded), installed over native._lib once it
    is loaded: the run then shows which pads took the C path."""

    def __init__(self, lib):
        self.lib, self.calls, self.messages = lib, 0, 0

    def tm_pack_pad(self, *args):
        self.calls += 1
        self.messages += int(args[3])
        return self.lib.tm_pack_pad(*args)

    def __getattr__(self, name):
        return getattr(self.lib, name)


def native_library() -> dict:
    """The port's C packer loaded, from a library built under
    build/native/ from tendermint_tpu_torch/native/pack.c, and counted
    (CountingPack). Without it pad_messages would take its numpy path:
    the run fails instead."""
    from pathlib import Path

    from tendermint_tpu_torch import native
    from tendermint_tpu_torch.crypto.cuda import kernels

    t0 = time.perf_counter()
    lib = native.lib()
    if lib is None:
        raise AssertionError("the native packer did not load (no C compiler "
                             "or a failed build): the numpy path would run")
    if not isinstance(lib, CountingPack):
        so = Path(lib._name).resolve()
        root = (kernels.BUILD_ROOT.parent / "native").resolve()
        if not so.is_relative_to(root) or not native.SOURCE.exists():
            raise AssertionError(f"the native packer is not the port's: {so}")
        native._lib = CountingPack(lib)
    so = Path(native._lib.lib._name).resolve()
    return {"library": str(so.relative_to(kernels.BUILD_ROOT.parent.parent)),
            "load_s": time.perf_counter() - t0}


class numpy_packing:
    """Within: pad_messages takes its numpy path (native.lib() None), as
    on a machine with no C compiler."""

    def __enter__(self):
        from tendermint_tpu_torch import native

        self.saved = native._lib, native._tried
        native._lib, native._tried = None, True

    def __exit__(self, *exc):
        from tendermint_tpu_torch import native

        native._lib, native._tried = self.saved


def native_shapes(commit) -> dict:
    """{shape: messages} at the widths the main path pads: the commit's
    10,240 sign bytes (2-3 lengths), a fast-sync window's 11,264 lanes,
    an admission flush of 512 envelopes of 0-2,000 bytes, and 255, 256
    and 257 messages around the C path's threshold."""
    import numpy as np

    sign = [commit.vote_sign_bytes(CHAIN, i) for i in range(N_VALIDATORS)]
    rng = np.random.default_rng(23)

    def mixed(n: int) -> list:
        return [rng.integers(0, 256, int(k), dtype=np.uint8).tobytes()
                for k in rng.integers(0, 2001, n)]

    return {"commit_sign_bytes": sign,
            "fastsync_window": sign + sign[:NATIVE_WINDOW_EXTRA],
            "admission_flush": mixed(NATIVE_FLUSH),
            **{f"edge_{n}": mixed(n) for n in (255, 256, 257)}}


def native_phase(vs, commit, mvs, mcommit, dev) -> dict:
    """The C packer against the numpy path at each shape (byte-equal rows,
    equal int32 block counts, host ms a call p50 of 20 each), then K4 at
    the mixed commit's 8,192-lane bucket and K3's bytes form at a
    fast-sync window launched on C-packed rows, their verdicts equal to
    the plain versions' on numpy-packed rows."""
    import numpy as np
    import torch

    from tendermint_tpu_torch import native
    from tendermint_tpu_torch.crypto.cuda import expanded, verify
    from tendermint_tpu_torch.crypto.cuda import sha512 as sh

    counter = native._lib
    shapes = {}
    for name, msgs in native_shapes(commit).items():
        calls = counter.calls
        c_rows, c_nb = sh.pad_messages(msgs, prefix_len=64)
        path = "c" if counter.calls > calls else "numpy"
        with numpy_packing():
            p_rows, p_nb = sh.pad_messages(msgs, prefix_len=64)
            p_ms = host_ms(lambda: sh.pad_messages(msgs, prefix_len=64))
        c_ms = host_ms(lambda: sh.pad_messages(msgs, prefix_len=64))
        if (path == "c") != (len(msgs) >= 256):
            raise AssertionError(f"native {name}: the {path} path at "
                                 f"{len(msgs)} messages")
        if not (np.array_equal(c_rows, p_rows) and np.array_equal(c_nb, p_nb)
                and c_nb.dtype == p_nb.dtype == np.int32):
            raise AssertionError(f"native {name}: the C and numpy rows differ")
        shapes[name] = dict(messages=len(msgs), path=path,
                            lengths=len({len(m) for m in msgs}),
                            width=int(c_rows.shape[1]), max_blocks=int(
                                c_nb.max()), c_ms=c_ms, numpy_ms=p_ms)
    # K4 at the mixed commit's ed25519 lanes (one 8,192-lane bucket)
    lanes = [i for i, v in enumerate(mvs.validators)
             if v.pub_key.type_name == "ed25519"]
    c_args = k4_args(mvs, mcommit, lanes, dev)
    with numpy_packing():
        p_args = k4_args(mvs, mcommit, lanes, dev)
    if not all(torch.equal(a, b) for a, b in zip(c_args[:5], p_args[:5])):
        raise AssertionError("native: K4's C-packed arguments differ")
    v_k = verify.general_verify(*c_args)
    v_p = verify.general_verify_plain(*p_args)
    if not (torch.equal(v_k, v_p) and bool(v_k[:len(lanes)].all())):
        raise AssertionError("native: K4 on C-packed rows against its plain "
                             "version on numpy-packed rows")
    k4 = dict(lanes=int(c_args[0].shape[0]), live=len(lanes),
              equal_plain=True, digest=digest(v_k))
    # K3's bytes form at a fast-sync window's 11,264 lanes
    exp = expanded.get_expanded([v.pub_key.bytes() for v in vs.validators])
    w_lanes = list(range(N_VALIDATORS)) + list(range(NATIVE_WINDOW_EXTRA))
    msgs = [commit.vote_sign_bytes(CHAIN, i) for i in w_lanes]
    sigs = [commit.signatures[i].signature for i in w_lanes]
    calls = counter.calls
    idx, fields, _wf = exp._prepare(w_lanes, msgs, sigs)
    if counter.calls != calls + 1:
        raise AssertionError("native: K3's bytes form did not pack in C")
    with numpy_packing():
        p_idx, p_fields, _ = exp._prepare(w_lanes, msgs, sigs)
    if not (np.array_equal(idx, p_idx) and all(
            np.array_equal(fields[k], p_fields[k]) for k in fields)):
        raise AssertionError("native: K3's C-packed fields differ")
    btab = verify._btab(dev)

    def k3(f, fn):
        t = verify.to_device(dict(f[1], idx=f[0]), dev)
        return fn(t["idx"], exp.akeys, t["sb"], t["s_ok"], exp.key_ok,
                  exp.tables, btab, msg=t["msg"], nblocks=t["nblocks"])

    x_k = k3((idx, fields), expanded.xverify)
    x_p = k3((p_idx, p_fields), expanded.shard_verify_plain)
    if not (torch.equal(x_k, x_p) and bool(x_k[:len(w_lanes)].all())):
        raise AssertionError("native: K3 on C-packed rows against its plain "
                             "version on numpy-packed rows")
    k3_out = dict(lanes=int(idx.shape[0]), live=len(w_lanes),
                  equal_plain=True, digest=digest(x_k))
    return dict(shapes=shapes, general_verify_mixed=k4, xverify_window=k3_out,
                c_calls=counter.calls, c_messages=counter.messages)


# -- phase 17d: the e2e harness ------------------------------------------

E2E_MANIFEST = os.path.join(CLI_ROOT, "e2e", "sample_manifest.toml")
# The runner's device and the backend and card name its nodes' ledger
# records must read; a CPU rehearsal sets "cpu", "cpu-fallback" and "".
E2E_DEVICE = "cuda"
E2E_BACKEND = "gpu"
E2E_CHAIN = "e2e-signer-chain"
E2E_HARNESS_TIMEOUT_S = 120.0  # the signer child imports torch first


def e2e_step(what: str) -> None:
    print(f"e2e: {time.strftime('%H:%M:%S')} {what}", file=sys.stderr,
          flush=True)


def e2e_timed(runner, stages: list, starts: list) -> None:
    """Wrap the runner's stages (each call's wall seconds into `stages`)
    and, once setup made them, each node's start (a record into
    `starts`, whose rpc_s the poller fills)."""
    import asyncio

    def wrap(name, label):
        fn = getattr(runner, name)

        if asyncio.iscoroutinefunction(fn):
            async def timed(*a, **k):
                t = time.perf_counter()
                try:
                    return await fn(*a, **k)
                finally:
                    stages.append((label(a), time.perf_counter() - t))
        else:
            def timed(*a, **k):
                t = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    stages.append((label(a), time.perf_counter() - t))
                    if name == "setup":
                        for node in runner.nodes:
                            wrap_start(node)
        setattr(runner, name, timed)

    def wrap_start(node):
        start = node.start

        def timed_start(*a, **k):
            starts.append(dict(node=node, t0=time.perf_counter(),
                               rpc_s=None))
            return start(*a, **k)

        node.start = timed_start

    for name in ("setup", "start", "check_valset", "check",
                 "collect_timeline", "collect_launch_ledger"):
        wrap(name, lambda a, n=name: n)
    wrap("wait_net_height", lambda a: f"wait_net_height {a[0]}")
    wrap("wait_all_height", lambda a: f"wait_all_height {a[0]}")
    wrap("apply", lambda a: f"{a[0].op} node{a[0].node} at {a[0].at_height}")
    wrap("apply_valupdate",
         lambda a: f"valupdate node{a[0].node} at {a[0].at_height}")


async def e2e_drive(runner, starts: list) -> dict:
    """runner.run() beside a poller that reads, for each node start, the
    seconds until its RPC first answers."""
    import asyncio

    async def poll():
        while True:
            for rec in starts:
                if rec["rpc_s"] is None and rec["node"].alive():
                    try:
                        await asyncio.wait_for(
                            runner.height_of(rec["node"]), 2.0)
                    except Exception:  # noqa: BLE001 - not up yet
                        continue
                    rec["rpc_s"] = time.perf_counter() - rec["t0"]
            await asyncio.sleep(0.1)

    task = asyncio.create_task(poll())
    try:
        return await runner.run()
    finally:
        task.cancel()


def e2e_checks(runner, report: dict, card: str) -> dict:
    """What the reference's runner and its tests assert of this
    manifest's run (the runner asserts no fork, recovery, coalescing and
    parity itself), and the nodes' launch ledgers: every node answered
    /debug/launches, every record on E2E_BACKEND with the card's name.
    Returns the K4 launches by node, with their lanes."""
    m = runner.m
    if not report.get("ok") or report["height"] != m.wait_height:
        raise AssertionError(f"e2e: the run did not pass: {report}")
    if report["evidence_committed"] < 1:
        raise AssertionError("e2e: the maverick's evidence was not committed")
    kills = [p for p in m.perturbations if p.op == "kill" and p.failpoint]
    recs = report.get("kill_recoveries", [])
    if len(recs) != len(kills) or not all(
            r["crashed_at_point"] and r["recovered"] for r in recs):
        raise AssertionError(f"e2e: kill_recoveries {recs}")
    (orep,) = runner.overload_reports
    hs = [h for h in orep["heights"] if h]
    if not (hs and all(b >= a for a, b in zip(hs, hs[1:])) and hs[-1] > hs[0]
            and orep["shed_delta"] > 0 and orep["bounded"] and orep["cleared"]
            and orep.get("admission_shed_delta", 0) > 0):
        raise AssertionError(f"e2e: overload report {orep}")
    (lrep,) = report["light_proxy"]
    if not (lrep["verify_launches"] < lrep["requests"] // 2
            and lrep["flood_shed"] >= 1 and lrep["max_queue_depth"] <= 2
            and lrep["net_advanced"]):
        raise AssertionError(f"e2e: light_proxy report {lrep}")
    if report["valset_changes"] != len(m.validator_updates):
        raise AssertionError("e2e: the validator update was not applied")
    if report["txs_sent"] <= 0:
        raise AssertionError("e2e: no load was sent")
    labels = {f"node{i}" for i in range(m.nodes)}
    if set(runner.ledger_answered) != labels:
        raise AssertionError(f"e2e: /debug/launches answered on "
                             f"{runner.ledger_answered}, not every node")
    k4 = {label: {"launches": 0, "lanes": []} for label in sorted(labels)}
    for label, entry in (report.get("launch_ledger") or {}).items():
        for g in entry["launches"]:
            if (g["backend"], g["device_name"]) != (E2E_BACKEND, card):
                raise AssertionError(f"e2e: {label}'s ledger record {g}")
            if g["kernel"] == "general":
                k4[label]["launches"] += g["launches"]
                k4[label]["lanes"] += g["lanes"]
    return k4


def e2e_signer_harness(work: str, logs: str, times: dict) -> dict:
    """The port's signer harness against a `cmd signer --connect` child
    (SecretConnection, the home's key expected): exit 0; then against an
    in-process signer without double-sign protection: exit 5."""
    import asyncio

    from tendermint_tpu_torch.crypto.ed25519 import Ed25519PrivKey
    from tendermint_tpu_torch.privval.signer import SignerServer
    from tendermint_tpu_torch.tools import signer_harness
    from tendermint_tpu_torch.types.priv_validator import MockPV

    home = os.path.join(work, "signer")
    rc, text = cli_run(times, "signer_init", ["--home", home, "init",
                                              "--chain-id", E2E_CHAIN])
    if rc:
        raise AssertionError(f"e2e: init {rc}: {text[-2000:]}")
    key = signer_harness._load_expected_key(
        os.path.join(home, "config", "priv_validator_key.json"))
    (port,) = free_ports(1)
    t0 = time.perf_counter()
    child = CliProc("signer", ["--home", home, "signer", "--connect",
                               f"tcp://127.0.0.1:{port}", "--device",
                               E2E_DEVICE], logs)

    async def harness(conn_key, timeout):
        try:
            return await signer_harness.run_harness(
                f"127.0.0.1:{port}", E2E_CHAIN, expected_key=key,
                timeout=timeout, log=e2e_step, conn_key=conn_key)
        except signer_harness.HarnessFailure as e:
            return e.code

    try:
        code = asyncio.run(harness(Ed25519PrivKey.generate(),
                                   E2E_HARNESS_TIMEOUT_S))
    finally:
        child.stop()
    times["signer_harness"] = time.perf_counter() - t0
    if code != 0:
        raise AssertionError(f"e2e: the harness against `cmd signer` exited "
                             f"{code}: {child.text()[-3000:]}")

    async def unsafe():
        pv = MockPV()  # no last-sign state: re-signs anything
        nonlocal key
        key = pv.get_pub_key().bytes()
        task = asyncio.create_task(harness(None, 20.0))
        await asyncio.sleep(0.3)
        dial = asyncio.create_task(
            SignerServer(pv, E2E_CHAIN).dial_and_serve("127.0.0.1", port))
        try:
            return await asyncio.wait_for(task, 30)
        finally:
            dial.cancel()

    unsafe_code = asyncio.run(unsafe())
    if unsafe_code != 5:
        raise AssertionError(f"e2e: the harness against a signer without "
                             f"double-sign protection exited {unsafe_code}")
    return {"cmd_signer_exit": code, "unsafe_signer_exit": unsafe_code}


def e2e_phase() -> dict:
    """Phase 17d (docstring): the sample manifest through the port's
    runner with its nodes on E2E_DEVICE, its report held to what the
    reference asserts, the launches, stage and start-to-RPC times; then
    the signer harness. Counters zeroed before, read after (the runner's
    process: its light plane)."""
    import asyncio
    import contextlib
    import shutil
    import tempfile

    from tendermint_tpu_torch.e2e import Manifest, Runner

    card = cli_card_name() if E2E_BACKEND == "gpu" else ""
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="e2e-")
    logs = os.path.join(work, "logs")
    os.makedirs(logs)
    kernels = wrappers()
    for fn in kernels.values():
        fn.launches = 0
    stages: list = []
    starts: list = []
    times: dict = {}
    manifest = Manifest.load(E2E_MANIFEST)
    runner = Runner(manifest, os.path.join(work, "net"), base_port=0,
                    log=e2e_step, device=E2E_DEVICE)
    e2e_timed(runner, stages, starts)
    try:
        # testnet's and the harness's lines: stdout is the JSON channel
        with contextlib.redirect_stdout(sys.stderr):
            t0 = time.perf_counter()
            report = asyncio.run(e2e_drive(runner, starts))
            run_s = time.perf_counter() - t0
            runner_launches = {k: fn.launches for k, fn in kernels.items()}
            k4_nodes = e2e_checks(runner, report, card)
            harness = e2e_signer_harness(work, logs, times)
    finally:
        runner.cleanup()
        shutil.rmtree(work, ignore_errors=True)
    launches = {k: n for k, n in runner_launches.items() if n}
    for entry in (report.get("launch_ledger") or {}).values():
        for g in entry["launches"]:
            k = LEDGER_KERNELS.get(g["kernel"], g["kernel"])
            launches[k] = launches.get(k, 0) + g["launches"]
    return dict(
        manifest=os.path.relpath(E2E_MANIFEST, CLI_ROOT), device=E2E_DEVICE,
        nodes=manifest.nodes, wait_height=manifest.wait_height,
        report={k: v for k, v in report.items()
                if k not in ("launch_ledger", "timeline")},
        overload=runner.overload_reports, timeline=report.get("timeline"),
        ledger_answered=sorted(runner.ledger_answered),
        k4_nodes=k4_nodes, runner_launches=runner_launches,
        launches=launches, run_s=run_s,
        stages_s=[{"stage": s, "seconds": t} for s, t in stages],
        start_to_rpc_s=[{"node": r["node"].index, "seconds": r["rpc_s"]}
                        for r in starts],
        signer_harness=harness, times_s=times,
        seconds=time.perf_counter() - t_phase)


def e2e_child() -> int:
    """`--phase e2e`: the phase alone, in a child of its own."""
    from tendermint_tpu_torch.crypto.cuda import kernels

    kernels.build()
    native = native_library()
    state = fallback_state()
    e2e = e2e_phase()
    no_fallback("e2e", state)
    emit(dict(phase="e2e", card=nvidia_smi(), native=native, **e2e))
    return 0


# -- the f32 phase and the fault check: child processes ------------------

# The f32 build's kernels: every field-bearing kernel (K6 does no field
# arithmetic and is the same code in both builds, as are K8's splice and
# clear; K2's assembly, inside K3, is the same byte rule in both). The
# f32 child times them at the i32 rows' shapes, on its own run of the
# same five paths.
F32_KERNELS = ("build_tables", "xverify", "general_verify", "shard_verify",
               "arena_verify", "sr_verify")
F32_ROWS = ("build_tables", "xverify", "general_verify",
            "general_verify_mixed", "sr_verify", "shard_verify",
            "arena_verify", "mesh_arena_verify")
CHILD_TIMEOUT_S = {"f32": 700, "fault": 240, "execution_host": 400,
                   "sim": 900, "e2e": 600}
# The fault check's watchdog window: short, so that one launch decides
# the classification.
FAULT_WINDOW_S = 3.0

# A test-only kernel that stores through an address no allocation owns:
# its launch succeeds and it faults while it runs
# (cudaErrorIllegalAddress). Built by the fault check alone, never into
# the port's library.
FAULT_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void k_fault(int* p) { p[threadIdx.x] = 1; }
extern "C" int tm_fault(void* stream) {
  k_fault<<<1, 32, 0, (cudaStream_t)stream>>>((int*)16);
  return (int)cudaGetLastError();
}
"""


class Child:
    """`python3 chip_smoke.py --phase <phase> args...` (the f32 child
    with TM_TPU_FIELD=f32) started now. Its JSON lines are read as it
    prints them, and relayed at once when `live`; finish() waits for it,
    relays the rest as {"phase": phase, "step": <its phase>, ...} and
    returns them all. A non-zero exit, or the time limit counted from
    its start, fails the parent; the child is killed on the way out."""

    def __init__(self, phase: str, *args, live: bool = True):
        import threading

        env = dict(os.environ)
        if phase == "f32":
            env["TM_TPU_FIELD"] = "f32"
        self.phase, self.live = phase, live
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--phase", phase,
             *args], stdout=subprocess.PIPE, text=True, env=env)
        self.timer = threading.Timer(CHILD_TIMEOUT_S[phase], self.proc.kill)
        self.timer.start()
        self.lines: list = []
        self.relayed = 0
        self.error = None
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self) -> None:
        try:
            for line in self.proc.stdout:
                self.lines.append(json.loads(line))
                if self.live:
                    self._relay()
        except Exception as e:  # noqa: BLE001 - raised by finish()
            self.error = e
            self.proc.kill()

    def _relay(self) -> None:
        for obj in self.lines[self.relayed:]:
            if "kernels" not in obj:
                emit({"phase": self.phase, "step": obj.get("phase"),
                      **{k: v for k, v in obj.items() if k != "phase"}})
        self.relayed = len(self.lines)

    def stop(self) -> None:
        """Kill the child if it still runs (a parent that fails first)."""
        self.timer.cancel()
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def finish(self) -> list[dict]:
        try:
            self.reader.join()
            rc = self.proc.wait()
        finally:
            self.stop()
        if self.error is not None:
            raise self.error
        self._relay()
        if rc != 0:
            raise AssertionError(f"the {self.phase} child exited {rc}")
        return self.lines


def run_child(phase: str, *args) -> list[dict]:
    """Run a child to its end (Child), relaying its lines as it prints
    them."""
    return Child(phase, *args).finish()


def fault_child() -> int:
    """The fault check's child: a test-only kernel that faults is
    launched just before K4 inside a BatchVerifier's device call (after
    a clean call, so every buffer is already allocated). The fault
    shows at the launch's or the readback's CUDA check and must raise
    KernelError through the breaker ladder, with every breaker closed
    and no counter moved. A sticky fault poisons the context, hence a
    process of its own."""
    import ctypes

    from tendermint_tpu_torch.crypto import batch as cbatch
    from tendermint_tpu_torch.crypto import ed25519
    from tendermint_tpu_torch.crypto import ed25519_ref as ref
    from tendermint_tpu_torch.crypto.cuda import (kernels, ledger, verify,
                                                  watchdog)

    out_dir = kernels.BUILD_ROOT.parent / "fault_check"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "fault.cu").write_text(FAULT_SOURCE)
    so = out_dir / f"libfault.{os.getpid()}.so"
    subprocess.run([kernels._nvcc(), kernels.ARCH, "-shared", "-Xcompiler",
                    "-fPIC", "-o", str(so), str(out_dir / "fault.cu")],
                   check=True)
    fault = ctypes.CDLL(str(so))
    fault.tm_fault.argtypes = [ctypes.c_void_p]
    fault.tm_fault.restype = ctypes.c_int
    seeds = [hashlib.sha256(b"fault-%d" % i).digest() for i in range(64)]
    lanes = [(ed25519.Ed25519PubKey(ref.public_key_from_seed(s)),
              b"fault lane %d" % i) for i, s in enumerate(seeds)]
    sigs = [ref.sign(s, m) for s, (_, m) in zip(seeds, lanes)]

    def verify_all():
        bv = cbatch.BatchVerifier()
        for (pk, m), sig in zip(lanes, sigs):
            bv.add(pk, m, sig)
        return bv.verify()

    if not verify_all()[0]:
        raise AssertionError("the clean call rejected its lanes")
    # the watchdog with the card promised and a short window: one launch
    # landing on the CPU degrades it to cpu_fallback, one card launch
    # restores it (reference tests/test_ledger.py:346, on the card)
    watchdog.configure("gpu", FAULT_WINDOW_S)
    time.sleep(FAULT_WINDOW_S + 0.5)
    verify.verify_batch([ref.public_key_from_seed(seeds[0])],
                        [lanes[0][1]], [sigs[0]], device="cpu")
    v_cpu = watchdog.verdict()
    if (v_cpu["status"], v_cpu["effective_backend"]) != \
            ("degraded", "cpu_fallback"):
        raise AssertionError(f"one CPU launch did not degrade: {v_cpu}")
    verify_all()
    v_ok = watchdog.verdict()
    if (v_ok["status"], v_ok["effective_backend"]) != ("ok", "gpu"):
        raise AssertionError(f"one card launch did not restore: {v_ok}")
    time.sleep(FAULT_WINDOW_S + 0.5)
    real = verify.general_verify

    def faulting(*a):
        rc = fault.tm_fault(kernels.stream_ptr(a[0].device))
        if rc:
            raise AssertionError(f"the faulting launch was refused: {rc}")
        return real(*a)

    faulting.launches = 0  # real() counts on the module's name
    state = fallback_state()
    verify.general_verify = faulting
    try:
        verify_all()
    except kernels.KernelError as e:
        message = str(e)
    else:
        raise AssertionError("a kernel fault did not raise KernelError")
    finally:
        verify.general_verify = real
    no_fallback("fault", state)
    code = int(message.split("CUDA error ")[1].split()[0])
    if code not in kernels.KERNEL_FAULTS:
        raise AssertionError(f"not a kernel fault: {message}")
    # the faulting launch's record: raised, then the fault propagated
    last = ledger.snapshot()[-1]
    if (last["kernel"], last["verdict"], last["backend"]) != \
            ("general", "raised", "gpu") or "KernelError" not in last["error"]:
        raise AssertionError(f"the fault's record: {last}")
    v_raised = watchdog.verdict()
    if (v_raised["status"], v_raised["effective_backend"]) != \
            ("degraded", "cpu_fallback"):
        raise AssertionError(f"a raising launch did not degrade: {v_raised}")
    emit({"phase": "fault", "raised": "KernelError", "code": code,
          "message": message, "record": {k: last[k] for k in (
              "kernel", "verdict", "backend", "device_name", "error")},
          "watchdog": dict(cpu_launch=v_cpu["effective_backend"],
                           card_launch=v_ok["effective_backend"],
                           raised=v_raised["effective_backend"])})
    return 0


def f32_child(i32: dict) -> int:
    """The f32 phase's child (TM_TPU_FIELD=f32): the f32 library built;
    the kernels check (K1, K3, K4, K7, K9 and K5, each against its f32
    plain version) with its verdicts held against the i32 build's
    digests `i32`; the slice, speculation, mixed, fabric and healing
    paths at full width through the entry points, each phase given the
    f32 run's own earlier results (the parent holds their launches and
    outcomes to the i32 phases'); then the f32 rows (F32_ROWS) at the
    i32 rows' shapes, with their launches on these five paths. No
    fallback but healing's injected ones: the library, the kernels and
    the checks are the f32 build's or the child fails."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import expanded, kernels
    from tendermint_tpu_torch.crypto.cuda.fieldsel import F as fe
    from tendermint_tpu_torch.device import set_mesh

    if kernels.FIELD != "f32" or fe.NLIMB != 32 or FIELD != "f32":
        raise AssertionError("the f32 child runs without the f32 field")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lib_path = kernels.build()
    emit({"phase": "build", "library": str(lib_path.relative_to(
        kernels.BUILD_ROOT.parent.parent)),
        "seconds": time.perf_counter() - t0,
        "nvcc_seconds": kernels.BUILD_INFO.get("seconds"),
        "ptxas": {k: kernel_ptxas(k) for k in F32_KERNELS},
        "native": native_library()})
    t0 = time.perf_counter()
    state = fallback_state()
    checks = kernel_phase(256, 1024, dev)
    mesh, _kind = fabric_mesh()
    set_mesh(mesh)
    expanded.set_shard_crossover(FABRIC_CROSSOVER)
    try:
        k5 = k5_check(dev)
    finally:
        expanded.set_shard_crossover(None)
        set_mesh(None)
    no_fallback("f32 kernels", state)
    verdicts = dict(checks.pop("verdicts"), **k5.pop("verdicts"))
    differ = sorted(k for k in set(i32) | set(verdicts)
                    if i32.get(k) != verdicts.get(k))
    if differ:
        raise AssertionError(f"f32 verdicts differ from the i32 build's: "
                             f"{differ}")
    emit({"phase": "kernels", "lanes": 1024, "keys": 256, "checks": checks,
          "k5_check": k5, "verdicts_equal_i32": sorted(verdicts),
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    vs, commit, bid, seed_of = make_commit(N_VALIDATORS)
    setup_s = time.perf_counter() - t0
    state = fallback_state()
    res = slice_phase(vs, commit, bid)
    no_fallback("f32 slice", state)
    emit(dict(phase="slice", validators=N_VALIDATORS, setup_s=setup_s, **res))
    t0 = time.perf_counter()
    state = fallback_state()
    spec, arena = speculation_phase(vs, commit, bid)
    no_fallback("f32 speculation", state)
    emit(dict(phase="speculation", validators=N_VALIDATORS,
              bursts=len(spec["flushes"]), burst=SPEC_BURST,
              seconds=time.perf_counter() - t0, **spec))
    t0 = time.perf_counter()
    mvs, mcommit, mbid, secret_of = make_mixed_commit(N_VALIDATORS)
    setup_s = time.perf_counter() - t0
    state = fallback_state()
    mixed = mixed_phase(mvs, mcommit, mbid, secret_of, dev)
    no_fallback("f32 mixed", state)
    emit(dict(phase="mixed", validators=N_VALIDATORS, setup_s=setup_s,
              seconds=time.perf_counter() - t0, **mixed))
    t0 = time.perf_counter()
    state = fallback_state()
    fabric, k5_row = fabric_phase(vs, commit, bid, mvs, mcommit, mbid,
                                  mixed["rejected"], dev)
    no_fallback("f32 fabric", state)
    emit(dict(phase="fabric", validators=N_VALIDATORS,
              crossover=FABRIC_CROSSOVER,
              seconds=time.perf_counter() - t0, **fabric))
    t0 = time.perf_counter()
    healing, k8 = healing_phase(vs, commit, bid, seed_of, mvs, mcommit, spec,
                                dev)
    emit(dict(phase="healing", validators=N_VALIDATORS,
              seconds=time.perf_counter() - t0, **healing))
    state = fallback_state()
    rows = timing_phase(vs, commit, dev)
    rows += [k7_row(arena), sr_row(mvs, mcommit, dev),
             k4_mixed_row(mvs, mcommit, dev), k5_row] + k8
    rows = [r for r in rows if r["name"] in F32_ROWS]
    no_fallback("f32 timing", state)
    launches = {}
    for path in (res, spec, mixed, fabric, healing):  # each path's run
        for kernel, count in path["launches"].items():
            launches[kernel] = launches.get(kernel, 0) + count
    for r in rows:
        r["launches"] = row_launches(r["name"], launches)
        if not r["launches"]:
            raise AssertionError(f"{r['name']}_f32: no launch on the f32 "
                                 "paths")
        r["ptxas"] = kernel_ptxas(r["name"])
        r["name"] += "_f32"
    emit({"phase": "memory",
          "max_allocated_bytes": torch.cuda.max_memory_allocated(dev)})
    emit({"kernels": rows})
    return 0


def f32_phase(lines: list, i32_paths: dict, rows: list) -> list:
    """Given the f32 child's lines (its Child's finish(), which relayed
    them), hold each of its paths' outcomes to the i32 phase's
    (`i32_paths`: slice, speculation, mixed, fabric and healing
    records), print the two fields' times side by side, and return its
    kernels rows."""
    step = {o.get("phase"): o for o in lines}
    f32_rows = next(o["kernels"] for o in lines if "kernels" in o)
    held = {"slice": ("rejected", "launches"),
            "speculation": ("rejected", "launches", "serve_launches",
                            "flush_verdicts", "hits", "misses",
                            "lane_verifies"),
            "mixed": ("rejected", "launches"),
            "fabric": ("rejected", "launches", "mixed_rejected",
                       "verdicts_equal_one_card", "shard_lanes",
                       "trusting_shard_lanes"),
            "healing": ("rejected", "launches", "counters_moved",
                        "entries")}
    for name, keys in held.items():
        for key in keys:
            if step[name][key] != i32_paths[name][key]:
                raise AssertionError(f"f32 {name} {key}: {step[name][key]} "
                                     f"against i32 {i32_paths[name][key]}")
        if name == "healing":
            for key in ("table_reshard_s", "arena_reshard_s"):
                if sorted(step[name][key]) != sorted(i32_paths[name][key]):
                    raise AssertionError(f"f32 healing {key}")
    i32_ms = {r["name"]: r["ms"] for r in rows}

    def side(name, key):
        return {"i32": i32_paths[name][key], "f32": step[name][key]}

    emit({"phase": "f32", "step": "compare", "held": held,
          "verify_commit_p50_ms": side("slice", "verify_commit_p50_ms"),
          "flush_ms": {f: [x["flush_ms"] for x in p["flushes"]] for f, p in
                       (("i32", i32_paths["speculation"]),
                        ("f32", step["speculation"]))},
          "flush_launch_ms": {f: [x["launch_ms"] for x in p["flushes"]]
                              for f, p in (("i32", i32_paths["speculation"]),
                                           ("f32", step["speculation"]))},
          "serve_commit_ms": side("speculation", "serve_commit_ms"),
          "mixed_verify_commit_p50_ms": side("mixed", "verify_commit_p50_ms"),
          "fabric_verify_commit_p50_ms": side("fabric",
                                              "verify_commit_p50_ms"),
          "fabric_build_s": side("fabric", "build_s"),
          "mesh_flush_p50_ms": side("healing", "flush_p50_ms"),
          "lie_flush_ms": side("healing", "lie_flush_ms"),
          "table_reshard_s": side("healing", "table_reshard_s"),
          "probe_ms": side("healing", "probe_ms"),
          "kernel_ms": {r["name"]: {"f32": r["ms"],
                                    "i32": i32_ms.get(r["name"][:-4])}
                        for r in f32_rows}})
    return f32_rows


def main() -> int:
    import torch

    if "--phase" in sys.argv:
        phase = sys.argv[sys.argv.index("--phase") + 1]
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            return 2
        if phase == "fault":
            rc = fault_child()
            sys.stdout.flush()
            os._exit(rc)  # the poisoned context is not torn down
        if phase == "execution_host":
            return exec_host_child()
        if phase == "consensus_peers":
            return cs_peers_child()
        if phase == "p2p_peers":
            i = sys.argv.index("--phase")
            return p2p_peers_child(sys.argv[i + 2], int(sys.argv[i + 3]))
        if phase == "p2p_clients":
            i = sys.argv.index("--phase")
            return p2p_clients_child(int(sys.argv[i + 2]))
        if phase == "p2p_signer":
            i = sys.argv.index("--phase")
            return p2p_signer_child(int(sys.argv[i + 2]), sys.argv[i + 3])
        if phase == "p2p_servers":
            return p2p_servers_child()
        if phase == "p2p":
            from tendermint_tpu_torch.crypto.cuda import kernels

            kernels.build()
            state = fallback_state()
            t0 = time.perf_counter()
            p2p = p2p_phase()
            no_fallback("p2p", state)
            emit(dict(phase="p2p", seconds=time.perf_counter() - t0,
                      card=nvidia_smi(), **p2p))
            return 0
        if phase == "observe":
            from tendermint_tpu_torch.crypto.cuda import kernels

            kernels.lib()
            t0 = time.perf_counter()
            vs, commit, bid, _ = make_commit(N_VALIDATORS)
            mvs, mcommit, mbid, _ = make_mixed_commit(N_VALIDATORS)
            vs.warm_device_tables().join()
            # the main run's earlier phases launch these first: a
            # kernel's first launch in a process also loads its module
            # (CUDA's lazy loading), inside the ledger's exec events
            vs.verify_commit(CHAIN, bid, commit.height, commit)
            mvs.verify_commit(CHAIN, mbid, mcommit.height, mcommit)
            setup_s = time.perf_counter() - t0
            state = fallback_state()
            t0 = time.perf_counter()
            observe = observe_phase(vs, commit, bid, mvs, mcommit, mbid,
                                    torch.device("cuda"))
            no_fallback("observe", state)
            emit(dict(phase="observe", setup_s=setup_s,
                      seconds=time.perf_counter() - t0, card=nvidia_smi(),
                      **observe))
            return 0
        if phase == "statesync":
            from tendermint_tpu_torch.crypto.cuda import kernels

            kernels.build()
            state = fallback_state()
            t0 = time.perf_counter()
            statesync = statesync_phase()
            no_fallback("statesync", state)
            emit(dict(phase="statesync", seconds=time.perf_counter() - t0,
                      card=nvidia_smi(), **statesync))
            return 0
        if phase == "cli":
            from tendermint_tpu_torch.crypto.cuda import kernels

            kernels.build()
            state = fallback_state()
            cli = cli_phase()
            no_fallback("cli", state)
            emit(dict(phase="cli", card=nvidia_smi(), **cli))
            return 0
        if phase == "sim":
            from tendermint_tpu_torch.crypto.cuda import kernels

            kernels.build()
            emit(dict(phase="sim", card=nvidia_smi(), **sim_phase()))
            return 0
        if phase == "e2e":
            return e2e_child()
        if phase == "consensus":
            from tendermint_tpu_torch.crypto.cuda import kernels

            kernels.build()
            state = fallback_state()
            t0 = time.perf_counter()
            consensus = consensus_phase()
            no_fallback("consensus", state)
            emit(dict(phase="consensus", seconds=time.perf_counter() - t0,
                      card=nvidia_smi(), **consensus))
            return 0
        return f32_child(json.loads(sys.argv[sys.argv.index("--i32") + 1]))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if FIELD != "i32":
        print("chip_smoke: run it without TM_TPU_FIELD (its f32 phase sets "
              "the variable for its own child)", file=sys.stderr)
        return 2
    from tendermint_tpu_torch.crypto.cuda import kernels

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    from tendermint_tpu_torch.crypto import ed25519

    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "host_openssl": ed25519._HAVE_OPENSSL})
    t0 = time.perf_counter()
    kernels.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": kernels.BUILD_INFO.get("seconds"),
          "ptxas": {k: kernel_ptxas(k) for k in SOURCES},
          "native": native_library()})
    t0 = time.perf_counter()
    state = fallback_state()
    checks = kernel_phase(256, 1024, torch.device("cuda"))
    no_fallback("kernels", state)
    emit({"phase": "kernels", "lanes": 1024, "keys": 256, "checks": checks,
          "seconds": time.perf_counter() - t0, "card": smi})
    t0 = time.perf_counter()
    vs, commit, bid, seed_of = make_commit(N_VALIDATORS)
    setup_s = time.perf_counter() - t0
    state = fallback_state()
    res = slice_phase(vs, commit, bid)
    no_fallback("slice", state)
    emit(dict(phase="slice", validators=N_VALIDATORS, setup_s=setup_s,
              card=smi, **res))
    t0 = time.perf_counter()
    state = fallback_state()
    spec, arena = speculation_phase(vs, commit, bid)
    no_fallback("speculation", state)
    emit(dict(phase="speculation", validators=N_VALIDATORS,
              bursts=len(spec["flushes"]), burst=SPEC_BURST,
              verify_commit_p50_ms=res["verify_commit_p50_ms"],
              seconds=time.perf_counter() - t0, card=smi, **spec))
    t0 = time.perf_counter()
    mvs, mcommit, mbid, secret_of = make_mixed_commit(N_VALIDATORS)
    setup_s = time.perf_counter() - t0
    state = fallback_state()
    mixed = mixed_phase(mvs, mcommit, mbid, secret_of, torch.device("cuda"))
    no_fallback("mixed", state)
    emit(dict(phase="mixed", validators=N_VALIDATORS, setup_s=setup_s,
              seconds=time.perf_counter() - t0, card=smi, **mixed))
    t0 = time.perf_counter()
    state = fallback_state()
    observe = observe_phase(vs, commit, bid, mvs, mcommit, mbid,
                            torch.device("cuda"))
    no_fallback("observe", state)
    emit(dict(phase="observe", seconds=time.perf_counter() - t0, card=smi,
              **observe))
    t0 = time.perf_counter()
    state = fallback_state()
    fabric, k5 = fabric_phase(vs, commit, bid, mvs, mcommit, mbid,
                              mixed["rejected"], torch.device("cuda"))
    no_fallback("fabric", state)
    emit(dict(phase="fabric", validators=N_VALIDATORS,
              crossover=FABRIC_CROSSOVER,
              one_card_verify_commit_p50_ms=res["verify_commit_p50_ms"],
              seconds=time.perf_counter() - t0, card=smi, **fabric))
    t0 = time.perf_counter()
    healing, k8 = healing_phase(vs, commit, bid, seed_of, mvs, mcommit, spec,
                                torch.device("cuda"))
    emit(dict(phase="healing", validators=N_VALIDATORS,
              seconds=time.perf_counter() - t0, card=smi, **healing))
    t0 = time.perf_counter()
    state = fallback_state()
    fastsync, window_row = fastsync_phase(torch.device("cuda"))
    no_fallback("fastsync", state)
    emit(dict(phase="fastsync", seconds=time.perf_counter() - t0, card=smi,
              **fastsync))
    t0 = time.perf_counter()
    state = fallback_state()
    votes, votes_row = votes_phase(vs, commit, seed_of, mvs, mcommit,
                                   torch.device("cuda"))
    no_fallback("votes", state)
    emit(dict(phase="votes", seconds=time.perf_counter() - t0, card=smi,
              **votes))
    t0 = time.perf_counter()
    state = fallback_state()
    light, light_rows = light_phase(torch.device("cuda"))
    no_fallback("light", state)
    emit(dict(phase="light", seconds=time.perf_counter() - t0, card=smi,
              **light))
    t0 = time.perf_counter()
    state = fallback_state()
    light_client, light_client_rows = light_client_phase(torch.device("cuda"))
    no_fallback("light_client", state)
    emit(dict(phase="light_client", seconds=time.perf_counter() - t0,
              card=smi, **light_client))
    t0 = time.perf_counter()
    state = fallback_state()
    admission, admission_row = admission_phase(torch.device("cuda"))
    no_fallback("admission", state)
    emit(dict(phase="admission", seconds=time.perf_counter() - t0,
              card=smi, **admission))
    t0 = time.perf_counter()
    state = fallback_state()
    execution = execution_phase()
    no_fallback("execution", state)
    emit(dict(phase="execution", seconds=time.perf_counter() - t0,
              card=smi, **execution))
    state = fallback_state()
    rows = timing_phase(vs, commit, torch.device("cuda"))
    rows += arena_rows(arena, vs, commit, torch.device("cuda"))
    rows.append(sr_row(mvs, mcommit, torch.device("cuda")))
    rows.append(k4_mixed_row(mvs, mcommit, torch.device("cuda")))
    rows.append(k5)
    rows += k8
    rows += [window_row, votes_row, *light_rows, *light_client_rows,
             admission_row]
    no_fallback("timing", state)
    emit({"phase": "observe", "step": "exec_vs_device_ms", "card": smi,
          "rows": observe_against_rows(observe, rows)})
    t0 = time.perf_counter()
    state = fallback_state()
    native = native_phase(vs, commit, mvs, mcommit, torch.device("cuda"))
    no_fallback("native", state)
    emit(dict(phase="native", seconds=time.perf_counter() - t0, card=smi,
              **native))
    t0 = time.perf_counter()
    run_child("fault")
    emit({"phase": "fault", "seconds": time.perf_counter() - t0,
          "card": smi})
    # the p2p phase's serving child builds its chain (host only, one
    # process) while the consensus phase runs
    servers = P2pChild("p2p_servers")
    sim_proc = f32_proc = e2e_proc = None
    try:
        try:
            # the sim phase (17c), host Python with a few K4 launches a
            # second, runs in a child from here on, beside the consensus,
            # p2p, statesync and cli phases: never beside the rows'
            # timing (above)
            sim_proc = Child("sim", live=False)
            t0 = time.perf_counter()
            state = fallback_state()
            consensus = consensus_phase()
            no_fallback("consensus", state)
            emit(dict(phase="consensus", seconds=time.perf_counter() - t0,
                      card=smi, **consensus))
            # the f32 child beside the p2p, statesync and cli phases
            torch.cuda.empty_cache()  # it needs 3.3 GB of f32 tables
            t_f32 = time.perf_counter()
            f32_proc = Child("f32", "--i32", json.dumps(dict(
                checks["verdicts"], **fabric["k5_check"]["verdicts"])),
                live=False)
            t0 = time.perf_counter()
            state = fallback_state()
            p2p = p2p_phase(servers)
            no_fallback("p2p", state)
            emit(dict(phase="p2p", seconds=time.perf_counter() - t0,
                      card=smi, **p2p))
            t0 = time.perf_counter()
            state = fallback_state()
            statesync = statesync_phase(servers)
            no_fallback("statesync", state)
            emit(dict(phase="statesync", seconds=time.perf_counter() - t0,
                      card=smi, **statesync))
            state = fallback_state()
            cli = cli_phase(servers)
            no_fallback("cli", state)
            emit(dict(phase="cli", card=smi, **cli))
        finally:
            servers.close()
        t0 = time.perf_counter()
        sim = next(x for x in sim_proc.finish()
                   if x.get("phase") == "sim")
        emit({"phase": "sim", "step": "waited", "card": smi,
              "seconds": time.perf_counter() - t0})
        # the e2e harness's net (17d) once the sim has ended (never
        # beside the sim's host load), beside the f32 child's tail: its
        # nodes launch nothing on the card at 4 validators
        t_e2e = time.perf_counter()
        e2e_proc = Child("e2e", live=False)
        t0 = time.perf_counter()
        f32_rows = f32_phase(f32_proc.finish(),
                             dict(slice=res, speculation=spec, mixed=mixed,
                                  fabric=fabric, healing=healing), rows)
        t_f32_end = time.perf_counter()
        emit({"phase": "f32", "step": "done", "card": smi,
              "seconds": t_f32_end - t_f32, "waited_s": t_f32_end - t0})
        t0 = time.perf_counter()
        e2e = next(x for x in e2e_proc.finish() if x.get("phase") == "e2e")
        emit({"phase": "e2e", "step": "done", "card": smi,
              "seconds": time.perf_counter() - t_e2e,
              "waited_s": time.perf_counter() - t0,
              "beside_f32_s": t_f32_end - t_e2e})
    finally:
        for child in (sim_proc, f32_proc, e2e_proc):
            if child is not None:
                child.stop()
    launches = {}
    for path in (res, spec, mixed, fabric, healing, fastsync, votes, light,
                 light_client, admission, execution, consensus, p2p,
                 statesync, cli, sim, e2e):
        for kernel, count in path["launches"].items():
            launches[kernel] = launches.get(kernel, 0) + count
    for r in rows:
        r["launches"] = row_launches(r["name"], launches)
        if not r["launches"]:
            raise AssertionError(f"{r['name']}: no launch on the main path")
        r["ptxas"] = kernel_ptxas(r["name"])
    emit({"phase": "timing", "card": smi,
          "tolerance": "exact: max_abs_err 0 against the plain version",
          "launch": {r["name"]: r["launch"] for r in rows + f32_rows
                     if "launch" in r}})
    emit({"kernels": rows + f32_rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (matchmaking_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out results.json] [--baseline-tree DIR]
                          [--plan-sweep] [--profile-soak]

Phases, each of which raises (exit code != 0) when it fails:

1. build: compile csrc/block_best.cu and csrc/quality_accum.cu with nvcc
   for sm_90a (one nvcc each) and, beside them, the wire codec
   csrc/codec.cc with g++, all started together; print the card and its
   max SM clock; report each kernel instance's registers, shared memory
   and spills (ptxas) and the ELO scorer's inner-loop instructions per pair
   (cuobjdump -sass, where the toolkit has it).
2. kernels: the block_best kernel against its plain PyTorch version on the
   same CUDA tensors, at full pool width (P = 131,072 slots in blocks of
   8,192, 100k active) and every window bucket (B = 16, 64, 256, 1,024),
   for all four instances (Glicko-2 x filters) with widening off and on;
   plus ragged small shapes and a crafted exact tie across the cluster's
   slices. Slots must be equal and values bit-equal. Times the kernel at
   every bucket (CUDA events, median of 30, device time), the wrapper's
   host time per call at every bucket, and the plain version at B = 1,024,
   and computes the bound. ``--baseline-tree DIR`` loads the wrapper of
   another checkout of the port (e.g. the parent commit, unpacked with
   ``git archive`` under a git-ignored directory), which builds that
   tree's kernel source; it is checked the same way and timed in turns
   with this one (old, new, new, old) on the same inputs. Then block_best's
   span launch (the pruned step's) at full width on a pool laid out by the
   gaussian:1500:300 banded allocator, all four instances, on a window
   whose spans fit W = 6 blocks and on config #1's window, whose do not:
   bit-equal to its plain version with the step's own flag and with the
   flag flipped, and a feasible launch equal to the dense one; span,
   fallback and dense ms at B = 1,024. The same at chunks of 16 rows (the
   bucketed step's, whose spans hold config #1's window): bit-equal to the
   plain version and the dense launch, span and dense ms, the plan and
   the bound. Then quality_accum against its
   plain version at every bucket on step results with real matches
   (histograms and counts equal, sums within 1e-5 relative; every addend
   is >= 0; two launches on the same inputs bit-equal), reading ``now``
   from the packed window's row on the card; timed with its host µs per
   call beside an empty kernel launched the same way (the launch floor),
   at 32 rating and wait edges, and its bound; with ``--baseline-tree``,
   the other tree's quality_accum is checked and timed in turns too.
3. engine: the main path. GpuEngine with configs/elo_1v1.json (backend
   overridden to "gpu"), its warmup() capturing one CUDA graph per (step
   variant, bucket) (capture ms and memory reported; no window may
   capture again): 100k waiting players through restore_columns(),
   then 48 windows of 1,024 through search_columns_async() at the config's
   pipeline depth (2): window N+1 is dispatched before window N is
   collected with collect_ready(), and flush() ends the run. Restores and
   dispatches run under torch.cuda.set_sync_debug_mode("error"). Checks:
   no player in two matches, every pair within both effective thresholds
   (and filters), every request matched, queued or rejected, pool
   accounting, one block_best and one quality_accum launch per window
   chunk, the engine's quality_report() after flush() equal to a host
   recomputation from the outcomes in every rating bucket's count, the
   first 3 windows' pairs equal a CPU columnar engine's, and an object-path
   engine on the card (8 windows, the old path's timing and GC) forms the
   first window's pairs too. Then an expire_deadlines() sweep over the
   5 % of waiting players stamped with a deadline, and 8 more windows
   under torch.profiler for the device's busy share, the launches the host
   queues per window (graph launches and copies) and the kernels the
   device runs per window (at most 401 + 1, the quality state's copies
   aside), among them exactly one prep_kernel, one block_best_kernel and
   one quality_accum_kernel, counted on the device by name. Then every
   window is driven again through an engine that replays its graphs and
   one that runs the same steps eagerly on the card, in lockstep from the
   same pool: each window's pairs, distances (bit for bit) and queued ids,
   and at the end the pools and quality states, must be equal. 3b: the same
   config with BENCH_SWEEP.md §5's pruning (band_spec gaussian:1500:300,
   prune_window_blocks 6, prune_chunk 128): the same 48 windows, checks and
   CPU comparison, and the windows that took the span path rather than the
   dense fallback, counted on the device and read once. 3c: config #1
   bucketed with the JAX bench's geometry (band_spec gaussian:1500:300,
   prune_window_blocks 6, prune_chunk 16): the same 48 windows, checks,
   CPU comparison and lockstep replay (pools, index columns included,
   equal), the span-path count (it fails if no window took the span
   path), formation_report()'s touched fraction and bucket occupancy (equal
   to the device index counts and to a host count of the pool after
   flush()), and one heartbeat() with windows in flight, whose index must
   equal a host rebuild of the pool it read. Configs #2 (filters,
   6 windows) and #4 (Glicko-2 + widening, 24 windows) run the same way,
   and config #4 runs a two-chunk rescan tick between two windows in
   flight, which must form matches, the same as on the CPU and as the
   eager steps on the card (and reconcile its quality samples); one more
   tick runs under torch.profiler (launches queued and kernels run per
   chunk, one of each hand kernel per chunk). 3d: speculation, for
   config #4 (the dense rescan family) and config #1 bucketed (the
   bucketed one): an engine with spec_formation (two passes) and a twin
   take the same restore and 4 windows in lockstep; the engine then
   speculates 30 s later (its live pool must stay bit-equal), validates
   and commits, and its outcome must equal the twin's two cold
   rescan_async ticks at that time, with pools and quality states equal;
   a second speculation, discarded by an admission, leaves the live pool
   as it was. Prints the counters and the device ms of the spare pool's
   copy, a speculation and a commit, with their launches. 3e: grouped
   readback (``readback_group`` k) on config #1 with 100k restored:
   copies of one pool take 48 windows of 1,024 and a two-chunk rescan
   tick, dispatched and then flushed, at k = 1, 2, 3, 4, dense and
   bucketed, and 8 windows sharded D = 2 on ("cuda:0",) × 2 at k = 1 and
   3: pairs, distances, queued ids, pools and quality states bit-equal to
   k = 1. Then k = 1 against k = 3 (wait 2 ms) at depth 2, collected
   interleaved: nobody matched twice, matched + waiting = restored +
   admitted; dispatch p50, turnaround, readback ms a window
   (``util_report``), the group wait and the transfer from the window
   marks. The device's memcpys by name over 8 windows at k = 1 and 3
   (torch.profiler: fewer copies to the host, one device-to-device copy
   more a window), and the graph audit of the grouped engine's dense step
   equal to the ungrouped one's. It runs before phase 14, as every count
   by name does. 3f: the stage profilers (``scripts/torch_profile_step.py``,
   ``torch_profile_stages.py``, ``torch_profile_engine.py``), imported, at
   config #1's width (P = 131,072, blocks of 8,192, 100k active, B =
   1,024, ELO): the stage split (admit, cands, pair at 1/2/4/8 rounds,
   evict, full with and without filters), each stage a CUDA graph of its
   own whose first replay must equal its eager call, timed by 30 replays
   between CUDA events with no host sync among them; exactly one
   block_best launch (a prep and a scorer node) in the cands and full
   graphs and none in the others, read back from the graphs; the full
   graph's kernel nodes plus the quality fold's equal to config #1's
   engine graph (17b: 400). The same split at B = 4,096 (the JAX tool's
   default), and the candidate pass against its plain version at B =
   2,048 and 4,096 (equal slots, bit-equal values). Then the stage modes:
   the engine's graph replayed back to back, dispatch host ms at depths
   0-8, window latency at B = 1,024 and depth 2, prunecheck (dense and
   pruned bit-identical) at W = 6 with chunks of 128 (config #1 pruned:
   this window takes the dense fallback) and with chunks of 16 (3c's
   bucketed chunks: this window must take the span path), a reduced
   rescanstall
   (one rep, a rescan every 10 windows) and profile_engine's per-window
   split; one ``stages`` JSON line sums it up.
4. service: the in-process service on the card: the 10-player demo; a
   soak with 100k restored players and 16,384 requests published in
   bursts (every request answered once from its window, partners agree,
   one publish_batch per window; request latency publish → first answer;
   the quality ledger and the engine's quality state both hold every
   matched player; with the broker's burst consume, every burst decoded
   at consume and no window at the flush), and the same soak with
   consume_batch off (the per-delivery path, the flush decoding each
   window); config #4's service, whose rescan loop must
   publish matches; and config #2's service, both of its queues in one
   app (20k restored and 2,048 requests each): every answer within its
   queue's threshold and filters and from its own queue, one
   publish_batch per window per queue, and a probe pair 100 apart matched
   at casual's threshold 150 and left waiting at ranked's 75. Then config
   #1 bucketed with spec_formation and no rescan loop: two players 400
   apart under fast widening must be matched by the speculation loop
   alone.
5. teams and roles: config #3 (team_5v5.json, P = 65,536) with 50k
   restored solo players and 24 object windows of 1,024 at depth 2, and
   config #5 (role_party.json, P = 16,384) with 12k players (declared
   roles) and 8 windows; every request pins its region and mode, so
   ``team_delegated`` must stay 0. Every match is checked (nobody twice,
   two teams of five, one region and mode, spread within every member's
   effective threshold, team sums within the spread, a perfect role
   assignment per team by brute force), pool accounting is exact, and the
   first 3 windows' raw step results are bit-equal to the same engine's on
   the CPU. Config #3 then runs a rescan tick 30 s later (widened
   thresholds), which must form matches. The engine's quality_report()
   holds one sample per member of every match. Each queue profiles 8 more
   windows (device ms and kernels per window; none of the hand kernels
   may run) and its step alone (kernels,
   device ms, CUDA-event ms, host ms per call: the ``steps`` line; the team
   step must stay within 300 kernels, the role step within 60 more). On a
   200-player role pool a 3-player party hands the queue to the host
   oracle, expires, and after the 5 s quiet period the queue is back on
   the card. The same hand-over through the service: a party with a
   deadline hands the queue to the oracle, the deadline sweep expires it,
   no traffic follows, and the health timer alone brings the queue back
   onto the card within one ``health_interval_s`` of the quiet period's
   end. Config #3's service: 50k restored through the app, 8,192
   requests in bursts of 512, every request answered, every match two
   teams of five, no fault caught.
6. overload control: config #1's service with 100k restored (tiers 0 / 1
   / 2 at 25 / 50 / 25 %) and 16,384 requests of the mixed-tier-peak
   cohorts (ranked tier 0 with a 1.5 s deadline, quick-play tier 1 with
   4 s, bot-fill tier 2 with none) in bursts of 512, unpaced, under
   max_waiting 100,000, max_inflight 8,192, 3 tiers, the "oldest" debt,
   EDF and a 25 ms deadline sweep; then the same soak with no overload
   control. Every request answered once (at most one terminal answer),
   the pool at or under 100,000 after every window, no tier-0 player shed
   while a tier-2 player waits, the shed answers by tier equal to the
   controller's, nobody matched later than its deadline + 25 ms, no
   credit held after the drain. Prints requests/s, latency p50/p99 by
   tier and overall for both soaks, shed and expired by tier, the
   admission cut's host µs and the debt's (pick and eviction) host ms a
   window.
7. the circuit breaker: config #1's service with breaker threshold 2
   (window 30 s, first probe 0.25 s, backoff 2, max 60 s, health timer
   0.05 s) and a chaos script failing device steps 0-1 and the first
   probe; 100k restored, 8 requests: two failed windows trip the breaker
   and the host oracle, with the whole pool, answers them; probe 1 fails,
   probe 2 captures and replays the base step's graph (block_best and
   quality_accum each launched by the replay and by the eager run before
   the capture) and the pool moves onto a fresh engine; 1,024
   more requests in 8 windows answered on the card. The counters must be
   the script's (crashes 2, trips 1, probes 2, probe failures 1, closes
   1), every player answered once, the moved pool the oracle's, the
   quality counts monotone, and the allocated device memory back within
   5 % of one engine's share after the demotion and within 5 % of that
   share after the re-promotion. Prints the ms from the trip to the first
   degraded answer, the probe's build, probe (capture and replay) and
   move ms, and the first 8 windows' dispatch ms after it.

8. durability, the drain and auth: config #1's service at full width
   with 100k restored. 8a: 16,384 requests in bursts of 512 with
   durability off, then with the write-ahead journal on (fsync "window"),
   after a compaction that anchors the 100k (timed, with the snapshot's
   bytes): requests/s and latency p50/p99 for both, the journal's host ms
   a window (ADMIT rows, their append and write, the terminals' append,
   the commit on its thread and the loop's wait for it); every request
   answered once, the segment's ADMIT records equal to the windows
   dispatched. 8b: a second stream crashed (``crash()``) right after its
   4th window is dispatched and journaled, in flight; a successor on the
   same directory recovers on the card (rto_ms
   and its split: attach, snapshot load, removes, tail, heartbeat, the
   re-anchoring compaction; and the device's drain after it): its waiting
   set equal to a host recomputation from the files (read_segment and the
   snapshot), every player answered ``matched`` before the crash absent
   from it and its redelivery replaying that body byte for byte, every
   admitted player without a terminal waiting once; 1,024 new requests
   whose first window's pairs equal those of a port app on the CPU
   recovered from a copy of the directory, then the redeliveries and
   6,144 more; both hand kernels launched, nobody in two matches across
   both apps, the first 8 windows' dispatch ms. 8c: phase 6's overload settings, 100k
   tiered waiting, 1,024 requests answered, then ``drain(dir)`` with 512
   requests reaching the broker after the consumer is cancelled (the
   backlog); a successor's ``restore_checkpoint(dir)``: the pool's columns
   equal after the round trip, the backlog re-published and answered on
   the card, no credit held; save and restore ms and bytes. 8d: auth
   ``rpc`` (an in-process responder, a 5 s timeout), ``static`` and
   ``none``, 1,024
   requests each (one in 8 with a bad token, answered ``unauthorized``),
   requests/s for each. 8b's successor logs the recovery's events the
   CPU app recovering the same files logs.
9. tracing: config #1's service at full width, 100k restored and 16,384
   requests in bursts of 512, three times in this process: tracing off,
   on, and sampled (``trace_sample_n`` 16). Each prints requests/s,
   latency p50/p99, GC ms, the flight recorder's and the attribution's
   host ms (over the soak and a window) and the traces settled, which
   must be the requests answered (on), 1 in 16 of them (sampled), none
   (off). Every window's merged marks must be dispatch, (h2d,
   device_step)+, readback_seal, collect; work + wait must equal the span
   of every trace; each request's own answer quotes its trace id exactly
   when it was traced. Phase 7's event kinds must be the CPU run's
   (``BREAKER_EVENTS``).
10. observability: config #1's service at full width, 100k restored and
   16,384 requests in bursts of 512, twice in this process: (a) the
   telemetry sampler off and no HTTP server; (b) the defaults (sampler at
   1 s, tracing, incident capture) with ``metrics_port`` on a free port
   and an SLO target of 100 ms (windows of 1 and 3 s). During (b) a
   client on the same loop fetches ``/metrics?format=prom`` and
   ``/healthz`` every 100 ms and ``/debug/profile?secs=1`` once after the
   first 4 windows, then every route once. Checks: every request answered
   once; every Prometheus text valid (one TYPE line per family, no
   duplicate series, every value a number); the pool gauge is the
   waiting count; every route's status that of the same configuration on
   the CPU; the queue burns (a /healthz lists it; a ``slo_burn`` bundle
   passes ``validate_bundle``); the profile's Chrome trace names
   prep_kernel, block_best_kernel and quality_accum_kernel, counted
   against the launches its capture saw. Prints requests/s and latency
   of (a) and (b), the scrape's host ms (``build_report`` and
   ``_flatten_prom``), the Prometheus bytes, the telemetry tick's and the
   incident capture's host ms and the profile's ms. Phases 7 and 8b hold
   one valid ``breaker_trip`` and one valid ``crash_recovery`` bundle.

``--plan-sweep`` times five variants at every bucket under every
(rows per CTA, cluster) plan, to check ``plan_grid``'s choice.
``--profile-soak`` (with ``--out``) writes cProfile's functions by own
time over each of phase 4's two soaks and phase 9's three beside the
output file.

11. resilience: config #1's service at full width with 100k restored.
   11a: 16,384 requests in bursts of 512 under seeded broker chaos on the
   request queue (1 % drops and duplicates, seq 0's first attempt
   dropped, seq 1 delivered 9 times, a partition from publish seq 4,096
   to 4,608) with ``debug_invariants``, twice, then without chaos on the
   burst path and with ``consume_batch`` off (the per-delivery path that
   consume faults force): the two chaos runs' fault stats and fault
   events equal, no invariant violated, every request answered, nothing
   dead-lettered; requests/s and latency p50/p99 of each. 11b: the
   journal on (fsync "none"), the 100k recovered from a journal at each
   start; replication off and on in turns, two rounds each (an
   in-process hub, a standby pumped every 20 ms): requests/s, latency,
   the lag in records (p50/p99 over the pumps), the tap's host µs a
   record, a pump's host ms, the baseline's bytes and host ms at 100k
   waiting; the shadow equals the pool, and no tap, send or pump failed.
   11c: a second stream crashed after its 4th window; the standby takes
   over at a scripted time (epoch 2); a successor on the card adopts the
   shadow (RTO and its split: restore, heartbeat, compaction), which is
   the primary's mirror at the crash; the fenced ex-primary's append
   raises and its publish is refused and counted; 512 matched players'
   redeliveries replay their bodies; 1,024 new requests under
   torch.profiler launch block_best and quality_accum, as often as the
   device ran them; nobody matched by both apps; a valid ``failover``
   bundle. 11d: 8,192 requests with a scripted drop, duplicate, delay and
   partition on the replication link: the lag during the partition, the
   peak ``unacked_admit_players`` (the loss bound), and the shadow equal
   to the pool after the heal.

12. network: config #1's service at full width with the journal on
   (fsync "none"), the 100k recovered from a journal at each start, its
   lease at a ``python -m matchmaking_tpu_torch.net.failover_proc lease``
   child and its standby a ``failover_proc host`` child on the card, over
   UDS sockets with 32 MiB frame and send buffer limits on both sides.
   12a: replication off and over the socket in turns, two rounds each:
   requests/s, latency, the lag in records, the tap's µs a record, the IO
   thread's ms and bytes of the 100k baseline frame, send → the child's
   applied baseline, the link's frames, reconnects, drops and liveness
   losses, the loop's longest stall after the start; the child's shadow
   equals the pool, and no send, frame, liveness, lease-request or fence
   error. 12b: the
   JAX soak's cycle-0 script on the fwd flow (a drop, a duplicate, a
   delay, a reset, relative to the baseline's seq): one reconnect, the
   baseline re-sent, every record applied once, the shadow the pool; then
   a crash after the 4th window of a second stream, the child's takeover
   after the real lease expiry, both fences of the ex-primary refused,
   the child serving config #1 on the card adopting its shadow (RTO and
   split, the takeover's epoch), 1,024 requests through the child
   launching block_best and quality_accum there (counted by the child),
   both kernels against their plain versions on the child's pool, nobody
   matched by both. 12c: ``failover_proc.soak`` at JAX's geometry with
   its hosts on the card, ``NET_SOAK_RUNS`` times: no double match, loss
   within the unacked-tail bound, both fences refused after the
   asymmetric partition, reconnects, no heartbeat false positive, equal
   takeover-transcript digests.

13. transports, processes and load. 13a: an app restores the 100k into
   config #1 and drains them into a checkpoint directory; the in-process
   service restores them and takes 8,192 requests in bursts of 512, then
   ``serve`` starts from ``MM_*`` alone over ``amqp://`` (the port's
   ``testing/fake_pika`` the server), restores them and takes the same
   requests from a client ``AmqpBroker`` on its own connection:
   requests/s, client-side p50/p99, the bridge's ms a burst and the
   loop's longest stall of both. A second stream with the service's
   consumer connection killed after its 4th window: a reconnect and a
   redeclare, redeliveries = the unacked at the kill, stale acks, every
   request answered (a redelivery replays its answer), nobody in two
   matches. The JAX package's
   scripted drop/dup over AMQP twice (equal stats); ``stop`` drains into
   the directory and a successor ``serve`` restores every waiting player.
   13b: ``WorkerSupervisor`` over config #2 with two workers and a metrics
   base port: worker 0 on the card, worker 1 the host oracle (the card's
   compute apps gain one context, not two); SIGKILL of worker 0 restarted with backoff on
   the card, SIGTERM exits 0 for both; the loadgen worker under the
   supervisor on the card (config #1, 8,000 requests/s for 3 s, matched
   >= 0.9 x sent, its process's launches); no child builds a kernel.
   13c: config #1 with the 100k, a 60 ms window wait, warm-started; the
   flash-crowd scenario at 3,000 requests/s steady and 15,000/s at the
   peak over 4 s, once static and twice autotuned (0.25 s ticks, target
   40 ms, settle 2 ticks; each view recorded): attainment, p50/p99, shed,
   the moves; every move in range, one a tick at most, the ratchets one
   way, the recorded views replayed through a fresh tuner give the same
   moves, equal arrival digests, no graph capture after the start.
14. the sharded pool and the multi-host runtime, run right after phase
   3d (after phases 4-13 torch.profiler leaves out the first ~27 kernels
   of every session, which 14a counts; ``scripts/torch_profiler_records.py``
   found no form of capture, idle time or live graphs that does it
   alone). 14a: config #1 with
   100k restored; a dense engine takes 48 windows of 1,024, each flushed
   before the next, and a sharded engine on ``(cuda:0,) × D`` (one card
   standing in for D: D = 1, 2, 4, 8 with the all-gather merge, D = 4
   with the ring; D = 1 is a stand-in no configuration reaches, whose
   launches stay out of the main path's total) takes the same restore and windows, its steps replayed
   from CUDA graphs, in lockstep with a twin running the same steps
   eagerly: every window's pairs, distances (bit for bit) and queued ids,
   and the concatenated pools, equal the dense engine's; D ``block_best``
   launches a window and no ``quality_accum`` (a sharded pool's quality is
   the host fold, its report's counts equal the dense one's); each
   shard's launch bit-equal to its plain version on its slice (window
   slots below 0 and past the slice included), and timed; the merge's
   device ms. Then each engine (the dense one too) takes 16 more windows
   at depth 2 (dispatch and turnaround ms) and 8 under torch.profiler
   (device ms and kernels a window; the sharded ones count D
   ``prep_kernel``, D ``block_best_kernel`` and 0
   ``quality_accum_kernel`` a window, the dense one 1 of each; a session
   that torch.profiler leaves short is taken again on fresh windows, at
   most ``PROFILE_TRIES`` in all). 14b: config #1 bucketed
   (gaussian:1500:300) sharded 4 ways with its frontier ladder beside a
   twin without the ladder (the dense sharded step, the same allocator):
   1,500 restored, 8 windows of 256, then 3,000 more (past the ceiling of
   128) and 8 more windows, in lockstep; every window and the pools equal
   the twin's,
   frontier steps, ladder moves and fallbacks counted, each engine's
   ``block_best`` launches counted on its own (the twin's stay out of the
   main path's total), the frontier
   launch at k = 8-128 bit-equal to its plain version and timed. 14c:
   configs #3 (50k) and #5 (12k) sharded 4 ways: the replicated fallback,
   and the ring (linear and tournament merges) within ``team_ring_k``,
   each step's result and pool bit-equal to the single-device step's, the
   device ms of each, ``comms_accounting()``. 14d: a process group of one
   over NCCL from ``MM_DCN_*`` (``init_distributed``): the process mesh's
   step (all-gather and ring) at full width equal to the dense step over
   4 windows, each step's launches counted across its own calls (one a
   window); then ``serve`` under the same ``MM_DCN_*`` over ``amqp://``
   (fake pika) answers 1,024 requests.
15. placement and device-loss failover, run last; launches counted with
   ``cuda_kernels.LAUNCHES`` (the host's counts), never torch.profiler.
   15a: config #1 sharded two ways on the app's logical device inventory
   ``("cuda:0",) × 2``, 100k restored, phase 4's soak (16,384 requests in
   bursts of 512) with the 8th device step lost
   (``chaos.device_lost_steps``): the queue demotes to (0,) once
   (``device_failovers`` 1, the failover audit's ``restored`` the pool at
   the loss), two ``block_best`` launches and no ``quality_accum`` a
   window before the loss, one of each after (less the warm run of each
   first-use capture), the quality counters carried across the rebuild,
   the old engine freed; every request answered once, nobody in two
   matches, lost 0. The blackout is split into the engine build, the
   column restore and the rest; memory allocated and reserved before and
   after. 15b: "soak.hot" at config #1's width (100k restored) and
   "soak.cold" on ``("cuda:0",) × 4`` with the placement controller on;
   seeded load on the hot queue while ``PlacementController.force``
   migrates it (0) → (1), promotes to (1, 2), demotes to (1) and migrates
   it back to (0): every decision applied, lost 0 and duplicated 0 (the
   JAX placement soak's count), ``block_best`` a window 1, 2, 1, 1 at the
   four bindings, each old engine freed, each action's blackout, players
   moved and memory; then one ``step()`` on the live signal view. 15c:
   config #2's two queues both bound to logical device 0, 20k restored
   and 2,048 requests with tiers 0-2 each, the dispatch arbiter on and off
   in turns (on, off, off, on): every answer within its queue's threshold
   and filters, the arbiter engaged with grants (off: none), a contended
   grant always to the least (tier, deadline) then waiting; requests/s
   and p50/p99 by tier.
16. the port's own tools, run after phase 15. 16a: config #1's service
   at full width with the journal on (phase 8's fsync "window") and an
   in-process standby (phase 11's), the 100k recovered from a journal at
   each start, phase 4's soak (16,384 requests in bursts of 512), once
   under the port's ``testing/sanitizer.AsyncSanitizer`` at a 2.0 s stall
   threshold and once without: the sanitized leg is clean
   (``assert_clean``: no lock-order inversion, no await under
   ``_pool_lock`` but the sanctioned ones, no loop stall, no settlement,
   journal, replication or speculation finding); both legs answer every
   request once, lose nobody, put nobody in two matches, launch
   ``block_best`` and ``quality_accum`` once a window, and leave the
   standby's shadow equal to the pool. Printed: the 5 slowest lock sites
   (count, p50, p99, max ms), the longest loop stall, the settles the
   twin counted, requests/s and p50/p99 of both legs. 16b: phase 4's
   speculating bucketed service under the sanitizer: clean, and the
   speculation twin saw at least one commit. 16c: the port's matchlint
   (``analyze_repo()`` of this checkout: nothing outside its baseline,
   no warning) and the model checker at the JAX package's single-queue
   scope (clean, exhaustive; the states explored are printed), on this
   machine's Python; the matchlint's trace-time ``recompile`` and
   ``device`` rules trace the captured steps on the CPU.
17. the trace gate and the graphs on the card, run after phase 16. 17a:
   the ``recompile`` and ``device`` trace-time rules with the traces made
   on the card (``--trace-device cuda``): every captured step family
   traced twice to equal graph code, with no finding; each card trace's
   operators equal the CPU trace's, node for node, and hold the kernel
   operators (``mm_torch::block_best``, ``quality_accum``) the family
   names. 17b: the captured-graph audit (``GpuEngine.graph_audit``: each
   graph captured again with its nodes kept and read back as DOT): config
   #1 at full width warmed up at every bucket, its dense, no-filter and
   rescan graphs, pruned (PRUNE), bucketed with speculation (BUCKETED:
   its three and ``spec``), config #3's team graph and config #5's role
   graph: each graph's ``prep_kernel``, ``block_best_kernel`` and
   ``quality_accum_kernel`` nodes equal the launches a replay counts, no
   host node, no copy to the host; each graph's kernel and memset nodes
   are printed (config #1 dense at B = 1,024 beside phase 3's profiled
   kernels a window). 17c: ``entry()``'s step captured and replayed, bit-equal
   to its eager call on the card and to a CPU run; ``dryrun_multichip(n,
   devices=("cuda:0",) * n)`` for n = 1, 2, 4, 8 prints the line of the
   CPU run. 17d: the offline operator tools on this run's artifacts:
   ``scripts/torch_journal_dump.py`` on 16a's plain leg's journal (intact,
   exit 0; ``--json``), ``scripts/torch_postmortem.py`` on phase 7's
   ``breaker_trip`` bundle (exit 0; ``--json``, no problem).
18. grouped readback in the service, run last. 18a: config #1's soak
   (100k restored, 16,384 requests in bursts of 512, the invariant
   checker armed) with ``readback_group`` 1, 3 (wait 2 ms) and 3 (wait
   8 ms), twice in turns: every request answered once, partners agree,
   one launch of each kernel a window; requests/s, p50/p99, attribution's
   ``readback_group_wait`` and ``readback_transfer`` ms a request. 18b:
   the JAX package's ``tests/test_soak.py`` traffic at k = 3 on the card
   (seeded chaos drop 0.1 / dup 0.15, depth 4, a 2 ms wait, rescan ticks
   every 50 ms): nothing dead lettered, matched + waiting >= 95 %,
   matched > 50 %, no device error.

Each phase's seconds are logged. The last lines of standard output are a
JSON summary of phases 3-18, the
max SM clock, the ``steps`` line (the team and role steps: plain PyTorch),
the card (nvidia-smi name and power limit), one JSON line with the
kernels' numbers (block_best, its span launch inside its entry, and
quality_accum), and one JSON line ``{"ok": true, "device": {...}}``.
Without CUDA, or without the package beside this file, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, HBM3 rate.
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12

FULL_P, FULL_BLOCK, FULL_ACTIVE, FULL_B = 131_072, 8_192, 100_000, 1_024


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def card_line(fields="name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---- phase 1: build, and what the compiler made ----------------------------


def ptxas_report(text):
    """{kernel instance: {registers, smem_bytes, spill_bytes}} from the
    ``-Xptxas -v`` output (block_best: one instance per (glicko2, filters)
    pair; quality_accum: one CTA and a cluster of 8)."""
    report, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            continue
        if fn is None:
            continue
        inst = re.search(r"(prep_kernel|block_best_kernel)ILb(\d)ELb(\d)E", fn)
        if inst is not None:
            key = (f"{inst.group(1)}<glicko2={inst.group(2)},"
                   f"filters={inst.group(3)}>")
        elif (m := re.search(r"quality_accum_kernelILi(\d)E", fn)):
            key = f"quality_accum_kernel<cluster={m.group(1)}>"
        else:
            continue
        entry = report.setdefault(key, {})
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            entry["static_smem_bytes"] = int(m.group(1)) if m else 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entry["spill_bytes"] = int(m.group(1)) + int(m.group(2))
    return report


def sass_inner_loop(so_path, out_dir):
    """Instructions of the ELO scorer's candidate loops (the innermost loops
    that load a record with LDS.64), from ``cuobjdump -sass``; None
    without cuobjdump. The whole SASS of that instance goes to ``out_dir``
    when given."""
    tool = next((c for c in (os.path.join(os.environ.get("CUDA_HOME", ""),
                                          "bin", "cuobjdump"),
                             "/usr/local/cuda/bin/cuobjdump")
                 if os.path.isfile(c)), None)
    if tool is None:
        return None
    text = subprocess.run([tool, "-sass", str(so_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)
    body = next((f for f in funcs if re.match(r"\S*block_best_kernelILb0ELb0E", f)),
                None)
    if body is None:
        return None
    if out_dir:
        with open(os.path.join(out_dir, "block_best_elo.sass"), "w") as f:
            f.write(body)
    insts, labels = [], {}
    for line in body.splitlines():
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            labels[m.group(1)] = len(insts)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            insts.append((int(m.group(1), 16), m.group(2).strip()))
    addr_index = {a: k for k, (a, _) in enumerate(insts)}
    loops = []
    for k, (addr, text_) in enumerate(insts):
        m = re.search(r"\bBRA\b.*?(?:`\((\.L_x_\d+)\)|0x([0-9a-f]+))", text_)
        if not m:
            continue
        start = (labels.get(m.group(1)) if m.group(1)
                 else addr_index.get(int(m.group(2), 16)))
        if start is not None and start <= k:
            loops.append((start, k))
    inner = [(a, b) for a, b in loops  # loops with no loop inside them
             if not any((c, d) != (a, b) and a <= c and d <= b
                        for c, d in loops)]
    found = []
    for a, b in inner:  # the scoring loops: one LDS.64 per candidate
        ops = [t.split()[1] if t.startswith("@") else t.split()[0]
               for _, t in insts[a:b + 1]]
        lds = sum(op == "LDS.64" for op in ops)
        if not lds:
            continue
        hist = {}
        for op in ops:
            hist[op] = hist.get(op, 0) + 1
        pairs = lds * 8  # each candidate feeds the warp's 8 rows
        found.append({"instructions": len(ops), "candidates": lds,
                      "pairs": pairs, "instructions_per_pair": len(ops) / pairs,
                      "opcodes": dict(sorted(hist.items(),
                                             key=lambda kv: -kv[1]))})
    if not found:
        return None
    # The loop without the own-slot test is the one almost every tile runs.
    found.sort(key=lambda f: f["instructions_per_pair"])
    return {"instructions_per_pair": found[0]["instructions_per_pair"],
            "loops": found}


def load_baseline(tree):
    """The ``engine/cuda_kernels`` module of another checkout of the port,
    loaded under its own name. Its ``block_best`` has the same Python
    signature and builds that tree's kernel source into that tree's build
    directory, so any two commits of the port compare through it."""
    import importlib.util

    src = os.path.join(tree, "matchmaking_tpu_torch", "engine", "cuda_kernels.py")
    spec = importlib.util.spec_from_file_location("baseline_cuda_kernels", src)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def now_arg(mod, t, value):
    """``now`` as ``mod``'s ``block_best`` takes it: the one-element f32
    tensor ``t`` on the card (the packed window's now row), or the host
    float ``value`` for a tree whose kernel still took the time as a
    float (the parent of the device-read ``now``)."""
    import inspect

    ann = inspect.signature(mod.block_best).parameters["now"].annotation
    return value if ann in ("float", float) else t


# ---- phase 2: kernel vs plain ---------------------------------------------


def kernel_inputs(torch, seed, capacity, active, rows, filters, device):
    g = torch.Generator(device="cpu").manual_seed(seed)

    def normal(n, mean, std):
        return (torch.randn(n, generator=g) * std + mean).to(device)

    def uniform(n, lo, hi):
        return (torch.rand(n, generator=g) * (hi - lo) + lo).to(device)

    def codes(n, k):
        if not filters:
            return torch.zeros(n, dtype=torch.int32, device=device)
        return torch.randint(0, k, (n,), generator=g, dtype=torch.int32).to(device)

    pool = {
        "rating": normal(capacity, 1500.0, 300.0),
        "rd": uniform(capacity, 0.0, 350.0),
        "region": codes(capacity, 4),
        "mode": codes(capacity, 3),
        "threshold": torch.full((capacity,), 100.0, device=device),
        "enqueue_t": uniform(capacity, 0.0, 30.0),
        "active": torch.randperm(capacity, generator=g).to(device) < active,
    }
    start = max(0, active - rows // 2)
    batch = {
        "slot": torch.arange(start, start + rows, dtype=torch.int32,
                             device=device).clamp_max(capacity),
        "rating": normal(rows, 1500.0, 300.0),
        "rd": uniform(rows, 0.0, 350.0),
        "region": codes(rows, 4),
        "mode": codes(rows, 3),
        "valid": torch.ones(rows, dtype=torch.bool, device=device),
    }
    q_thr = torch.full((rows,), 100.0, device=device)
    return pool, batch, q_thr


def time_ms(torch, fn, reps=30):
    """Median of ``reps`` CUDA-event timings of ``fn`` (after 3 warm-ups).
    Each timing starts behind a ~0.5 ms device sleep, so the host has
    queued ``fn``'s launches before the first event fires: the time is the
    device's, not the Python wrapper's (``host_us`` times that)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_us(torch, fn, reps=100):
    """Host µs per call of ``fn`` (a wrapper that only queues device work):
    the time until ``reps`` calls have returned, with no device wait in
    between, over ``reps``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return us


def compare(torch, got, want, what):
    (kv, ki), (rv, ri) = got, want
    if not torch.equal(ki, ri):
        bad = int((ki != ri).sum())
        raise AssertionError(f"{what}: {bad} candidate slots differ")
    if not torch.equal(kv.view(torch.int32), rv.view(torch.int32)):
        raise AssertionError(f"{what}: values are not bit-equal")
    finite = torch.isfinite(rv)
    if bool(finite.any()):
        return float((kv[finite] - rv[finite]).abs().max())
    return 0.0


#: (glicko2, filters, widen): the four kernel instances, widening off and on.
#: "elo" is the main path's: config #1 windows carry no filters.
VARIANTS = {
    "elo": (False, False, 0.0),
    "elo_widen": (False, False, 5.0),
    "filters": (False, True, 0.0),
    "filters_widen": (False, True, 5.0),
    "glicko2": (True, False, 0.0),
    "glicko2_widen": (True, False, 5.0),
    "glicko2_filters": (True, True, 0.0),
    "all": (True, True, 5.0),
}
BUCKETS = (16, 64, 256, 1024)


def bound(ck, rows, glicko2, filters, *, pairs=None, pool_slots=FULL_P):
    """Least time for one full-width call: the pairs' operations over the
    FP32 peak, or the bytes (each input read once, each output written
    once) over the memory rate, whichever is larger. The span launch
    passes the pairs its spans hold and the pool slots they cover."""
    pairs = rows * FULL_P if pairs is None else pairs
    ops = pairs * ck.ops_per_pair(glicko2=glicko2, filters=filters)
    n_blocks = FULL_P // FULL_BLOCK
    nbytes = (pool_slots * (6 * 4 + 1) + rows * (6 * 4 + 1)
              + rows * n_blocks * 8)
    return roofline({"pairs": pairs}, ops, nbytes)


def roofline(res, ops, nbytes):
    ops_ms, bytes_ms = ops / PEAK_FP32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(res, ops=ops, bytes=nbytes, bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def kernel_split(torch, fn, reps=20):
    """Mean device time (µs) per call of each kernel ``fn`` launches, from
    torch.profiler: the record prep and the scorer, without launch gaps."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        for kernel in ("prep_kernel", "block_best_kernel"):
            if kernel in e.key:
                dev = getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0.0))
                split[kernel] = split.get(kernel, 0.0) + dev / reps
    return split


def phase_kernel(torch, ck, scoring, device, baseline=None):
    """Every variant at every window bucket at full pool width: bit-equal
    to the plain version, and timed (with ``baseline``, another tree's
    ``cuda_kernels`` module, timed in turns beside it: old, new, new,
    old)."""
    kw = dict(pool_block=FULL_BLOCK, max_threshold=250.0,
              g_coeff=scoring.G_COEFF_F32)
    now = torch.tensor([20.0], device=device)
    old_now = now_arg(baseline, now, 20.0) if baseline is not None else None
    results, max_err = {}, 0.0
    for vi, (name, (glicko2, filters, widen)) in enumerate(VARIANTS.items()):
        args = dict(kw, glicko2=glicko2, widen_per_sec=widen, filters=filters)
        res = results[name] = {"ms_by_bucket": {}, "host_us_by_bucket": {}}
        if baseline is not None:
            res["baseline_ms_by_bucket"] = {}
            res["baseline_host_us_by_bucket"] = {}
        for b in BUCKETS:
            pool, batch, q_thr = kernel_inputs(torch, 100 + vi, FULL_P,
                                               FULL_ACTIVE, b, filters, device)
            got = ck.block_best(pool, batch, q_thr, now, **args)
            want = ck.block_best_reference(pool, batch, q_thr, now, **args)
            torch.cuda.synchronize()
            max_err = max(max_err, compare(torch, got, want, f"{name} B={b}"))
            new = lambda: ck.block_best(pool, batch, q_thr, now, **args)
            if baseline is None:
                res["ms_by_bucket"][b] = time_ms(torch, new)
                res["host_us_by_bucket"][b] = host_us(torch, new)
            else:
                old = lambda: baseline.block_best(pool, batch, q_thr,
                                                  old_now, **args)
                compare(torch, old(), want, f"baseline {name} B={b}")
                o1, n1, n2, o2 = (time_ms(torch, f) for f in (old, new, new, old))
                res["ms_by_bucket"][b] = statistics.median([n1, n2])
                res["baseline_ms_by_bucket"][b] = statistics.median([o1, o2])
                o1, n1, n2, o2 = (host_us(torch, f) for f in (old, new, new, old))
                res["host_us_by_bucket"][b] = statistics.median([n1, n2])
                res["baseline_host_us_by_bucket"][b] = statistics.median([o1, o2])
            if name == "elo":
                res.setdefault("kernel_us_by_bucket", {})[b] = kernel_split(
                    torch, new)
            if b == FULL_B:
                res["blocks_with_candidate"] = float(
                    torch.isfinite(got[0]).float().mean())
                res["plain_ms"] = time_ms(torch, lambda: ck.block_best_reference(
                    pool, batch, q_thr, now, **args), reps=20)
                res.update(bound(ck, int(batch["valid"].sum()), glicko2,
                                 filters))
        res["ms"] = res["ms_by_bucket"][FULL_B]
        if "kernel_us_by_bucket" in res:
            log(f"kernel {name}: device µs per call by kernel "
                f"{res['kernel_us_by_bucket']}")
        log(f"kernel {name}: ms by bucket {res['ms_by_bucket']}"
            + (f", baseline {res['baseline_ms_by_bucket']}" if baseline else "")
            + f"; host µs per call {res['host_us_by_bucket']}"
            + (f", baseline {res['baseline_host_us_by_bucket']}" if baseline
               else "")
            + f" (plain {res['plain_ms']:.3f} ms, bound {res['bound_ms']:.4f} ms"
            f" at B={FULL_B})")
    # Ragged shapes: B = 16 / P = 256 (blocks of 64), B = 1, B = 33, and
    # blocks of 125 slots (no 16-slot alignment, no cluster split).
    for seed, (cap, blk, rows, filters) in enumerate(
            [(256, 64, 16, True), (256, 64, 1, False), (2048, 512, 33, True),
             (1000, 125, 20, True)]):
        pool, batch, q_thr = kernel_inputs(torch, 200 + seed, cap, cap * 3 // 4,
                                           rows, filters, device)
        args = dict(kw, pool_block=blk, glicko2=bool(seed % 2), widen_per_sec=3.0,
                    filters=filters)
        max_err = max(max_err, compare(
            torch, ck.block_best(pool, batch, q_thr, now, **args),
            ck.block_best_reference(pool, batch, q_thr, now, **args),
            f"ragged B={rows} P={cap}"))
    # Crafted exact tie: 1490 and 1510 around 1500, in both orders, spread
    # over the quarters of each block (so over the cluster's slices); the
    # lowest slot of each block must win.
    pool, batch, q_thr = kernel_inputs(torch, 300, 4096, 0, 40, False, device)
    firsts = []
    for b in range(4):
        base = b * 1024 + 37 * b + 5
        firsts.append(base)
        for j, r in enumerate((1510.0, 1490.0, 1490.0, 1510.0)):
            pool["rating"][base + 256 * j] = r
            pool["active"][base + 256 * j] = True
    batch["rating"].fill_(1500.0)
    batch["slot"].fill_(4096)
    for filters in (True, False):
        args = dict(kw, pool_block=1024, glicko2=False, widen_per_sec=0.0,
                    filters=filters)
        zero = torch.zeros(1, device=device)
        got = ck.block_best(pool, batch, q_thr, zero, **args)
        compare(torch, got, ck.block_best_reference(pool, batch, q_thr, zero,
                                                    **args), "exact tie")
        expect = torch.tensor(firsts, dtype=torch.int32, device=device)
        if not torch.equal(got[1], expect.expand(40, 4)):
            raise AssertionError("exact tie: the lowest slot did not win")
    torch.cuda.synchronize()
    return results, max_err


def plan_sweep(torch, ck, scoring, device, variants=("elo", "elo_widen",
                                                    "filters", "glicko2",
                                                    "all")):
    """Each variant at every bucket under every (rows per CTA, cluster)
    plan the kernel takes, each launched with that plan (``ck._launch``),
    checked bit-equal and timed: the evidence behind plan_grid's choice."""
    sweep = {}
    n_blocks = FULL_P // FULL_BLOCK
    for name in variants:
        glicko2, filters, widen = VARIANTS[name]
        kw = dict(pool_block=FULL_BLOCK, max_threshold=250.0,
                  glicko2=glicko2, filters=filters, widen_per_sec=widen,
                  g_coeff=scoring.G_COEFF_F32)
        for b in BUCKETS:
            pool, batch, q_thr = kernel_inputs(torch, 100, FULL_P,
                                               FULL_ACTIVE, b, filters, device)
            now = torch.tensor([20.0], device=device)
            ck._check(pool, batch, q_thr, now, FULL_BLOCK)
            want = ck.block_best_reference(pool, batch, q_thr, now, **kw)
            best = ck.plan_grid(b, n_blocks, FULL_BLOCK, ck.sm_count(0))
            row = sweep.setdefault(name, {})[b] = {
                "chosen": f"{best.rows_per_cta}x{best.cluster}"}
            for rows in ck.ROWS_PER_CTA:
                for cluster in (1, 2, 4, 8):
                    plan = ck.GridPlan(rows, cluster,
                                       (n_blocks * cluster, -(-b // rows)))
                    fn = lambda: ck._launch(plan, pool, batch, q_thr, now,
                                            **kw)
                    compare(torch, fn(), want, f"plan {plan} B={b}")
                    row[f"{rows}x{cluster}"] = time_ms(torch, fn)
            log(f"plan sweep {name} B={b}: " + ", ".join(
                f"{k} {v if isinstance(v, str) else round(v * 1e3, 1)}"
                for k, v in row.items()))
    return sweep


#: Float operations per quality sample in the plain formulas: the widened
#: threshold (5), the pair's limit, quality (division, subtraction, two
#: clips, the bucket's multiply: 5), the wait (2), three sums, and a binary
#: search over each axis's edges (3 + 5 compares at the default edges).
QUALITY_OPS_PER_SAMPLE = 24


def step_windows(torch, np, kernels, device, buckets=BUCKETS):
    """Config #1-like step results that form real matches, one per bucket:
    a seeded pool (P = 131,072, 100k active, thresholds 100, widening 5/s
    to 250), a window of arrivals, and config #1's dense step on a copy of
    the pool. Returns {B: (pool after the step, f32[3, B] result, now, the
    packed window on the card)}."""
    rng = np.random.default_rng(12)
    active = np.zeros(FULL_P, bool)
    active[rng.permutation(FULL_P)[:FULL_ACTIVE]] = True
    arrays = {"rating": rng.normal(1500, 300, FULL_P).astype(np.float32),
              "rd": np.full(FULL_P, 350.0, np.float32),
              "region": np.zeros(FULL_P, np.int32),
              "mode": np.zeros(FULL_P, np.int32),
              "threshold": np.full(FULL_P, 100.0, np.float32),
              "enqueue_t": rng.uniform(0, 30, FULL_P).astype(np.float32),
              "active": active}
    ks = kernels.KernelSet(capacity=FULL_P, top_k=8, pool_block=FULL_BLOCK,
                           glicko2=False, widen_per_sec=5.0,
                           max_threshold=250.0)
    free = np.nonzero(~active)[0]
    out = {}
    for b in buckets:
        packed = np.zeros((9, b), np.float32)
        packed[0] = free[:b]
        packed[1] = rng.normal(1500, 300, b)
        packed[2] = 350.0
        packed[5] = 100.0
        packed[6] = rng.uniform(10, 30, b)
        packed[7] = 1.0
        packed[8] = 30.0
        pool = kernels.pool_from_reference(arrays, device)
        packed_dev = torch.from_numpy(packed).to(device)
        res = ks.search_step_packed(pool, packed_dev, skip_filters=True)
        out[b] = (pool, res, 30.0, packed_dev)
    torch.cuda.synchronize()
    return out


def quality_state_check(torch, got, want, what):
    """Histograms and counts equal, sums within 1e-5 of the plain
    version's (every addend is >= 0, so of the sum of their magnitudes);
    returns the largest sum error."""
    for name in ("q_hist", "w_hist", "count"):
        if not torch.equal(got[name], want[name]):
            raise AssertionError(f"{what}: {name} differs")
    max_err = 0.0
    for name in ("q_sum", "w_sum", "d_sum"):
        err = (got[name] - want[name]).abs()
        if bool((err > 1e-5 * want[name].abs()).any()):
            raise AssertionError(f"{what}: {name} off by {float(err.max())}")
        max_err = max(max_err, float(err.max()))
    return max_err


def phase_quality(torch, np, ck, kernels, spec, device, baseline=None):
    """``quality_accum`` against its plain version on the same CUDA
    tensors, at every bucket, on step results with real matches: histograms
    and counts equal, sums within 1e-5 of the sum of their addends (all
    >= 0, so of the sums themselves); two launches on the same inputs end
    bit-equal. The kernel reads ``now`` from the packed window's row on the
    device. Times the kernel at every bucket (device ms, host µs per call),
    beside an empty kernel launched the same way (the launch floor), at 32
    rating and 32 wait edges, the plain version at B = 1,024, and the bound
    from the bytes the call must move. With ``baseline`` (another tree's
    ``cuda_kernels``), its ``QualityAccum`` is checked too and timed in
    turns with this one: old, new, new, old."""
    acc = kernels.QualityAccumKernel(
        capacity=FULL_P, widen_per_sec=5.0, max_threshold=250.0,
        rating_edges=spec.rating_edges, n_quality=spec.n_quality,
        wait_edges=spec.wait_edges)
    kw = dict(widen_per_sec=5.0, max_threshold=250.0,
              rating_edges=acc.rating_edges, n_quality=acc.n_quality,
              wait_edges=acc.wait_edges)
    res = {"ms_by_bucket": {}, "host_us_by_bucket": {},
           "empty_ms_by_bucket": {}, "empty_host_us_by_bucket": {},
           "matches_by_bucket": {}}
    if baseline is not None:
        res["baseline_ms_by_bucket"] = {}
        res["baseline_host_us_by_bucket"] = {}
    max_err = 0.0
    for b, (pool, out, now, packed) in step_windows(torch, np, kernels,
                                                    device).items():
        now_row = packed[-1]  # the packed window's now row, on the card
        plain = lambda state: ck.quality_accum_reference(
            state, pool["rating"], pool["enqueue_t"], pool["threshold"], out,
            now, **kw)
        got, again, want = (acc.init_state(device) for _ in range(3))
        acc.accum(got, pool, out, now_row)
        acc.accum(again, pool, out, now_row)
        plain(want)
        torch.cuda.synchronize()
        matches = int((out[0] < FULL_P).sum())
        if int(got["count"].sum()) != 2 * matches or matches == 0:
            raise AssertionError(f"quality_accum B={b}: {got['count'].sum()} "
                                 f"samples for {matches} matches")
        max_err = max(max_err, quality_state_check(torch, got, want,
                                                   f"quality_accum B={b}"))
        if not torch.equal(got.flat, again.flat):
            raise AssertionError(f"quality_accum B={b}: two launches on the "
                                 f"same inputs differ")
        scratch = acc.init_state(device)
        new = lambda: acc.accum(scratch, pool, out, now_row)
        empty = lambda: acc._bound.launch_empty(out, now_row)
        if baseline is None:
            res["ms_by_bucket"][b] = time_ms(torch, new)
            res["host_us_by_bucket"][b] = host_us(torch, new)
        else:
            cols = (pool["rating"], pool["enqueue_t"], pool["threshold"])
            old = functools.partial(baseline.QualityAccum(
                acc.init_state(device), *cols, capacity=FULL_P, **kw),
                out, now_row)
            check = acc.init_state(device)
            baseline.QualityAccum(check, *cols, capacity=FULL_P, **kw)(
                out, now_row)
            torch.cuda.synchronize()
            quality_state_check(torch, check, want,
                                f"baseline quality_accum B={b}")
            o1, n1, n2, o2 = (time_ms(torch, f) for f in (old, new, new, old))
            res["ms_by_bucket"][b] = statistics.median([n1, n2])
            res["baseline_ms_by_bucket"][b] = statistics.median([o1, o2])
            o1, n1, n2, o2 = (host_us(torch, f) for f in (old, new, new, old))
            res["host_us_by_bucket"][b] = statistics.median([n1, n2])
            res["baseline_host_us_by_bucket"][b] = statistics.median([o1, o2])
        res["empty_ms_by_bucket"][b] = time_ms(torch, empty)
        res["empty_host_us_by_bucket"][b] = host_us(torch, empty)
        res["matches_by_bucket"][b] = matches
        if b == FULL_B:
            res["plain_ms"] = time_ms(torch, lambda: plain(scratch), reps=20)
            # The operator's binding lookup alone (a hit), on the arguments
            # as its CUDA kernel gets them: part of the host µs above.
            consts = (5.0, 250.0, list(acc.rating_edges), acc.n_quality,
                      list(acc.wait_edges))
            res["bind_us"] = host_us(torch, lambda: ck._bind(
                scratch.flat, pool["rating"], pool["enqueue_t"],
                pool["threshold"], *consts))
            # Bytes: the result read once, three gathered columns at both
            # sides' slots of every match, the state read and written.
            nbytes = 3 * b * 4 + 2 * matches * 3 * 4 + 2 * acc.size * 4
            res.update(roofline({"samples": 2 * matches},
                                2 * matches * QUALITY_OPS_PER_SAMPLE, nbytes))
            # The most edges the kernel takes: 32 rating and 32 wait edges
            # (the default spec has 7 and 22).
            wide = kernels.QualityAccumKernel(
                capacity=FULL_P, widen_per_sec=5.0, max_threshold=250.0,
                rating_edges=np.linspace(600.0, 2400.0, 32),
                n_quality=spec.n_quality,
                wait_edges=np.geomspace(1e-3, 60.0, 32))
            w_got, w_want = wide.init_state(device), wide.init_state(device)
            wide.accum(w_got, pool, out, now_row)
            ck.quality_accum_reference(
                w_want, pool["rating"], pool["enqueue_t"], pool["threshold"],
                out, now, **dict(kw, rating_edges=wide.rating_edges,
                                 wait_edges=wide.wait_edges))
            torch.cuda.synchronize()
            max_err = max(max_err, quality_state_check(
                torch, w_got, w_want, "quality_accum, 32 edges"))
            res["ms_32_edges"] = time_ms(
                torch, lambda: wide.accum(w_got, pool, out, now_row))
    res["ms"] = res["ms_by_bucket"][FULL_B]
    res["host_us"] = res["host_us_by_bucket"][FULL_B]
    res["empty_ms"] = res["empty_ms_by_bucket"][FULL_B]
    log(f"quality_accum: ms by bucket {res['ms_by_bucket']}"
        + (f", baseline {res['baseline_ms_by_bucket']}" if baseline else "")
        + f"; host µs per call {res['host_us_by_bucket']}"
        + (f", baseline {res['baseline_host_us_by_bucket']}" if baseline
           else "")
        + f"; empty launch ms {res['empty_ms_by_bucket']}, host µs "
        f"{res['empty_host_us_by_bucket']}; 32 edges {res['ms_32_edges']:.5f}"
        f" ms (plain {res['plain_ms']:.3f} ms, bound {res['bound_ms']:.7f} ms"
        f" by {res['bound_by']} at B={FULL_B}); the binding lookup "
        f"{res['bind_us']:.2f} µs a call; matches "
        f"{res['matches_by_bucket']}; max sum error {max_err}")
    return res, max_err


#: The pruned main path's setting (the JAX package's BENCH_SWEEP.md §5):
#: W = 6 of 16 blocks, chunks of 128, gaussian:1500:300 bands.
PRUNE = {"prune_window_blocks": 6, "prune_chunk": 128,
         "band_spec": "gaussian:1500:300"}
#: Config #1 bucketed, with the JAX bench's bucketed geometry
#: (bench.py ``_bucketed_geometry``: W = ceil(16 · 33 / 100) = 6 blocks,
#: chunks of max(8, min(128, 1024 // 64)) = 16 rows).
BUCKETED = {"bucketed": True, "prune_window_blocks": 6, "prune_chunk": 16,
            "band_spec": "gaussian:1500:300"}


def span_inputs(torch, np, kernels, device, *, glicko2, filters, thr,
                window_std, seed, chunk=PRUNE["prune_chunk"], widen=2.0):
    """A pool laid out by the banded allocator (gaussian:1500:300, one band
    per block; 100k players of N(1500, 300)), a window of 1,024 arrivals
    placed by it too and sorted by rating as the pruned step sorts it, and
    the step's own span starts and feasibility for it."""
    from matchmaking_tpu_torch.core.pool import PlayerPool, band_edges_from_spec
    from matchmaking_tpu_torch.engine.cuda_kernels import effective_threshold
    from matchmaking_tpu_torch.service.contract import RequestColumns

    rng = np.random.default_rng(seed)
    n_blocks = FULL_P // FULL_BLOCK
    pp = PlayerPool(FULL_P, thr, band_edges=band_edges_from_spec(
        PRUNE["band_spec"], n_blocks))

    def cols(prefix, ratings):
        n = ratings.size
        z = np.zeros(n, np.int32)
        return RequestColumns(
            ids=np.char.add(prefix, np.arange(n).astype(str)).astype(object),
            rating=ratings, rd=np.zeros(n, np.float32), region=z, mode=z,
            threshold=np.full(n, np.nan, np.float32),
            enqueued_at=np.zeros(n))

    pp.allocate_columns(cols("p", rng.normal(1500, 300, FULL_ACTIVE)
                             .astype(np.float32)))
    w_rating = np.sort(rng.normal(1500, window_std, FULL_B)).astype(np.float32)
    w_slots = pp.allocate_columns(cols("w", w_rating))
    active = np.zeros(FULL_P, bool)
    active[pp.waiting_slots()] = True
    active[w_slots] = False  # the window's own slots: admitted by the step
    codes = lambda n, k: (rng.integers(0, k, n) if filters
                          else np.zeros(n)).astype(np.int32)
    pool = kernels.pool_from_reference({
        "rating": pp.m_rating.copy(),
        "rd": rng.uniform(0, 350, FULL_P).astype(np.float32),
        "region": codes(FULL_P, 4), "mode": codes(FULL_P, 3),
        "threshold": np.full(FULL_P, thr, np.float32),
        "enqueue_t": rng.uniform(0, 20, FULL_P).astype(np.float32),
        "active": active}, device)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    batch = {"slot": to(w_slots.astype(np.int32)), "rating": to(w_rating),
             "rd": to(rng.uniform(0, 350, FULL_B).astype(np.float32)),
             "region": to(codes(FULL_B, 4)), "mode": to(codes(FULL_B, 3)),
             "threshold": to(np.full(FULL_B, thr, np.float32)),
             "enqueue_t": to(rng.uniform(0, 20, FULL_B).astype(np.float32)),
             "valid": to(np.ones(FULL_B, bool))}
    ks = kernels.KernelSet(capacity=FULL_P, top_k=8, pool_block=FULL_BLOCK,
                           glicko2=glicko2, widen_per_sec=widen,
                           max_threshold=250.0,
                           prune_window_blocks=PRUNE["prune_window_blocks"],
                           prune_chunk=chunk)
    kernels.admit(pool, batch)
    q_thr = effective_threshold(batch["threshold"], batch["enqueue_t"],
                                torch.tensor([20.0], device=device), widen,
                                250.0)
    start, feasible = ks._chunk_windows(batch, q_thr, *ks._live_stats(pool))
    return ks, pool, batch, q_thr, start, feasible


def phase_span(torch, np, ck, kernels, scoring, device, sweep=False):
    """The span launch of block_best at full width on a banded pool, for
    all four instances: a narrow window (thresholds 30, ratings N(1500,
    60)) whose spans fit W = 6 blocks, and config #1's window (thresholds
    100, N(1500, 300)) whose tail chunks do not. Each is bit-equal to the
    plain version with the step's own flag and with the flag flipped, and
    a feasible launch equals the dense launch (its spans hold every
    candidate). At B = 1,024, ELO, on the feasible window: span, fallback
    (the flag unset) and dense device ms on the same inputs, and the span
    launch's bound over its spans' pairs."""
    w = PRUNE["prune_window_blocks"]
    chunk = PRUNE["prune_chunk"]
    res, feasible_seen = {}, set()
    for vi, (glicko2, filters) in enumerate(((False, False), (False, True),
                                             (True, False), (True, True))):
        for thr, std in ((30.0, 60.0), (100.0, 300.0)):
            ks, pool, batch, q_thr, start, feasible = span_inputs(
                torch, np, kernels, device, glicko2=glicko2, filters=filters,
                thr=thr, window_std=std, seed=20 + vi)
            kw = dict(pool_block=FULL_BLOCK, glicko2=glicko2, filters=filters,
                      widen_per_sec=2.0, max_threshold=250.0,
                      g_coeff=scoring.G_COEFF_F32)
            now = torch.tensor([20.0], device=device)
            dense = ck.block_best(pool, batch, q_thr, now, **kw)
            feasible_seen.add(bool(feasible))
            what = f"span glicko2={glicko2} filters={filters} thr={thr}"
            spans = {}
            for flag in (feasible, ~feasible):
                span = ck.Span(start, chunk, w, flag.reshape(1))
                got = ck.block_best(pool, batch, q_thr, now, span=span, **kw)
                compare(torch, got, ck.block_best_span_reference(
                    pool, batch, q_thr, now, span, **kw), what)
                spans[bool(flag)] = span
            if bool(feasible):
                compare(torch, ck.block_best(pool, batch, q_thr, now,
                                             span=spans[True], **kw),
                        dense, f"{what}: span against dense")
            if (glicko2, filters) == (False, False):
                res[f"span_starts_thr{thr:g}"] = start.tolist()
            if (glicko2, filters) == (False, False) and bool(feasible):
                r = res
                for name, fn in (
                        ("span_ms", lambda: ck.block_best(
                            pool, batch, q_thr, now, span=spans[True], **kw)),
                        ("fallback_ms", lambda: ck.block_best(
                            pool, batch, q_thr, now, span=spans[False], **kw)),
                        ("dense_ms", lambda: ck.block_best(
                            pool, batch, q_thr, now, **kw))):
                    r[name] = time_ms(torch, fn)
                starts = start.tolist()
                blocks = {s_ + j for s_ in starts for j in range(w)}
                rows = int(batch["valid"].sum())
                r["span_starts"] = starts
                r["blocks_with_candidate"] = float(
                    torch.isfinite(dense[0]).float().mean())
                r.update(bound(ck, rows, False, False,
                               pairs=rows * w * FULL_BLOCK,
                               pool_slots=len(blocks) * FULL_BLOCK))
                r["plain_ms"] = time_ms(torch, lambda: (
                    ck.block_best_span_reference(pool, batch, q_thr, now,
                                                 spans[True], **kw)), reps=10)
                log(f"span launch, feasible window (thr {thr}): span "
                    f"{r['span_ms']:.4f} ms, fallback {r['fallback_ms']:.4f} "
                    f"ms, dense {r['dense_ms']:.4f} ms, plain "
                    f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
                    f"(span starts {starts})")
    if feasible_seen != {True, False}:
        raise AssertionError(f"span phase: feasibility {feasible_seen}, "
                             f"wanted both")
    res["chunk16"] = span_chunk16(torch, np, ck, kernels, scoring, device,
                                  sweep)
    torch.cuda.synchronize()
    return res


def span_chunk16(torch, np, ck, kernels, scoring, device, sweep=False):
    """The bucketed step's span launch: config #1's window (thresholds 100,
    no widening, N(1500, 300)) cut into chunks of 16 rows, whose spans fit
    W = 6 blocks (chunks of 128 do not; nor do chunks of 16 once 20 s of
    widening at 2/s reach 140), for the ELO instance, and the Glicko-2 +
    filters instance on the same window (its spans, widened by rating
    deviations up to 350, do not fit): bit-equal to the plain version with
    the flag set and flipped, and to the dense launch where the flag is
    the step's own. ELO: span and dense device ms on the
    same inputs, the plan (``plan_grid`` takes 16 rows a CTA so that a
    CTA's rows share one span), the plain version's ms and the bound over
    the spans' pairs. With ``sweep``, every plan with 8 or 16 rows a CTA,
    each checked and timed."""
    w, chunk = BUCKETED["prune_window_blocks"], BUCKETED["prune_chunk"]
    out = {}
    for vi, (glicko2, filters) in enumerate(((False, False), (True, True))):
        ks, pool, batch, q_thr, start, feasible = span_inputs(
            torch, np, kernels, device, glicko2=glicko2, filters=filters,
            thr=100.0, window_std=300.0, seed=30 + vi, chunk=chunk, widen=0.0)
        what = f"span chunk 16 glicko2={glicko2} filters={filters}"
        if bool(feasible) == glicko2:
            raise AssertionError(f"{what}: feasibility {bool(feasible)}")
        kw = dict(pool_block=FULL_BLOCK, glicko2=glicko2, filters=filters,
                  widen_per_sec=0.0, max_threshold=250.0,
                  g_coeff=scoring.G_COEFF_F32)
        now = torch.tensor([20.0], device=device)
        dense = ck.block_best(pool, batch, q_thr, now, **kw)
        spans = {}
        for flag in (True, False):
            span = ck.Span(start, chunk, w, torch.tensor([flag], device=device))
            got = ck.block_best(pool, batch, q_thr, now, span=span, **kw)
            compare(torch, got, ck.block_best_span_reference(
                pool, batch, q_thr, now, span, **kw), what)
            if not flag or bool(feasible):
                compare(torch, got, dense, f"{what}: against dense")
            spans[flag] = span
        if glicko2:
            continue
        plan = ck.plan_grid(FULL_B, FULL_P // FULL_BLOCK, FULL_BLOCK,
                            ck.sm_count(0), chunk)
        starts = start.tolist()
        blocks = {s_ + j for s_ in starts for j in range(w)}
        rows = int(batch["valid"].sum())
        out = {"plan": f"{plan.rows_per_cta}x{plan.cluster}",
               "span_starts": starts,
               "span_ms": time_ms(torch, lambda: ck.block_best(
                   pool, batch, q_thr, now, span=spans[True], **kw)),
               "dense_ms": time_ms(torch, lambda: ck.block_best(
                   pool, batch, q_thr, now, **kw)),
               "plain_ms": time_ms(torch, lambda: ck.block_best_span_reference(
                   pool, batch, q_thr, now, spans[True], **kw), reps=5)}
        out.update(bound(ck, rows, False, False, pairs=rows * w * FULL_BLOCK,
                         pool_slots=len(blocks) * FULL_BLOCK))
        if sweep:
            n_blocks = FULL_P // FULL_BLOCK
            out["plans"] = {}
            for rows_cta in (8, 16):
                for cluster in (1, 2, 4, 8):
                    gp = ck.GridPlan(rows_cta, cluster, (n_blocks * cluster,
                                                         -(-FULL_B // rows_cta)))
                    fn = lambda: ck._launch(gp, pool, batch, q_thr, now,
                                            span=spans[True], **kw)
                    compare(torch, fn(), dense, f"{what} plan {gp}")
                    out["plans"][f"{rows_cta}x{cluster}"] = time_ms(torch, fn)
        log(f"span launch, chunks of 16 (config #1's window, W = {w}, plan "
            f"{out['plan']}): span {out['span_ms']:.5f} ms, dense "
            f"{out['dense_ms']:.5f} ms, plain {out['plain_ms']:.3f} ms, bound "
            f"{out['bound_ms']:.5f} ms; {len(blocks)} blocks in some span"
            + (f"; plans {out['plans']}" if sweep else ""))
    return out


# ---- phase 3: the engine main path (columnar, pipelined) -------------------


class GcClock:
    """Seconds spent in Python's garbage collector while installed."""

    def __init__(self):
        self.total = 0.0
        self._start = None

    def _on_gc(self, phase, info):
        if phase == "start":
            self._start = time.perf_counter()
        elif self._start is not None:
            self.total += time.perf_counter() - self._start
            self._start = None

    def __enter__(self):
        import gc
        gc.callbacks.append(self._on_gc)
        return self

    def __exit__(self, *exc):
        import gc
        gc.callbacks.remove(self._on_gc)


@contextlib.contextmanager
def no_sync(torch):
    """Any device→host synchronisation inside raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


class Population:
    """Seeded players, row k = player ``p<k>``: the columns the engines
    get, and the host copy the checks read."""

    REGIONS = ("eu", "na", "apac", "*")
    MODES = ("ranked", "casual", "*")

    def __init__(self, np, rng, n, t0, *, filters, glicko2, deadline_frac=0.0):
        self.np = np
        self.rating = rng.normal(1500.0, 300.0, n).astype(np.float32)
        self.rd = (rng.uniform(30.0, 350.0, n) if glicko2
                   else np.full(n, 350.0)).astype(np.float32)
        self.waited = rng.uniform(0.0, 20.0, n)
        pick = lambda names: (np.array(names, object)[rng.integers(0, len(names), n)]
                              if filters else np.full(n, "*", object))
        self.region, self.mode = pick(self.REGIONS), pick(self.MODES)
        self.deadline = np.where(rng.random(n) < deadline_frac, t0 + 50.0, 0.0)
        self.ids = np.char.add("p", np.arange(n).astype(str)).astype(object)

    def columns(self, RequestColumns, eng, lo, hi, now, reply="replies"):
        """Rows [lo, hi) enqueued at ``now`` minus their wait, interned by
        ``eng``."""
        np = self.np
        sl = slice(lo, hi)
        region, mode = eng.intern_columns(self.region[sl].tolist(),
                                          self.mode[sl].tolist())
        return RequestColumns(
            ids=self.ids[sl].copy(), rating=self.rating[sl], rd=self.rd[sl],
            region=region, mode=mode,
            threshold=np.full(hi - lo, np.nan, np.float32),
            enqueued_at=now - self.waited[sl],
            reply_to=np.full(hi - lo, reply, object),
            correlation_id=self.ids[sl].copy(), deadline=self.deadline[sl])

    def rows(self, ids):
        return self.np.array([int(p[1:]) for p in ids.tolist()], self.np.int64)


def check_columnar(np, scoring, eng, pop, out, now, enq, seen, glicko2,
                   window_ids=None):
    """The invariants of one collected ColumnarOutcome: nobody in two
    matches, every pair within both effective thresholds and filters, the
    reported distance the pair's, and (traffic windows) every request
    matched, queued or rejected. ``enq`` maps a row to its enqueue time."""
    q = eng.queue
    a, b = pop.rows(out.m_id_a), pop.rows(out.m_id_b)
    for pid in out.m_id_a.tolist() + out.m_id_b.tolist():
        if pid in seen:
            raise AssertionError(f"{pid} is in two matches")
        seen.add(pid)
    for j in range(out.n_matches):
        ra, rb = a[j], b[j]
        d = scoring.distance(float(pop.rating[ra]), float(pop.rating[rb]),
                             float(pop.rd[ra]), float(pop.rd[rb]),
                             glicko2=glicko2)
        eff = [min(q.max_threshold, q.rating_threshold + q.widen_per_sec
                   * max(0.0, now - enq[r])) if q.widen_per_sec > 0
               else q.rating_threshold for r in (ra, rb)]
        if d > min(eff) + 1e-3:
            raise AssertionError(f"pair p{ra}-p{rb}: d={d} > limit {min(eff)}")
        if abs(d - float(out.m_dist[j])) > 1e-3 * max(1.0, d):
            raise AssertionError(f"pair p{ra}-p{rb}: reported {out.m_dist[j]}, "
                                 f"recomputed {d}")
        if not scoring.region_mode_compatible(pop.region[ra], pop.mode[ra],
                                              pop.region[rb], pop.mode[rb]):
            raise AssertionError(f"pair p{ra}-p{rb} breaks the filters")
    if window_ids is not None:
        done = set(out.q_ids.tolist()) | seen | {p for p, _ in out.rejected}
        if any(p not in done for p in window_ids.tolist()):
            raise AssertionError("a request was neither matched, queued "
                                 "nor rejected")
    return out.n_matches


def pair_set(out):
    return {frozenset(p) for p in zip(out.m_id_a.tolist(), out.m_id_b.tolist())}


def pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p * len(xs)))]


def device_work(prof) -> list:
    """The device's entries of a finished profiler session's
    ``key_averages()``: kernels, copies and fills. Left out are the
    device-track twins (gpu_user_annotation) that the card draws of the
    program's own ``mm.*`` ranges (``GpuEngine``'s host spans): they are
    no work of the device, as ``mmbench/trace.py`` also holds."""
    return [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and not e.key.startswith("mm.")]


def device_busy(torch, run):
    """torch.profiler over ``run()``: the device's busy share of the wall
    time, its top kernels, and the host operators that took the most host
    time of their own (queueing the kernels)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        n = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = [(getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0)),
                e.count, e.key) for e in device_work(prof)]
    host_ops = [(e.self_cpu_time_total, e.count, e.key)
                for e in prof.key_averages()
                if not str(e.device_type).endswith("CUDA")
                and (e.key.startswith("aten::") or e.key.startswith("cuda"))]
    kernels.sort(reverse=True)
    host_ops.sort(reverse=True)
    device_us = sum(k[0] for k in kernels)
    calls = {k: c for _, c, k in host_ops}
    # The hand kernels the device ran, by name, as the profiler saw them
    # (inside the graphs' replays too): what backs the LAUNCHES counts,
    # which a replay adds on the host.
    own = {name: sum(k[1] for k in kernels if name in k[2])
           for name in OWN_KERNELS}
    own_ms = {name: sum(k[0] for k in kernels if name in k[2]) / n / 1e3
              for name in OWN_KERNELS}
    return {"windows": n, "wall_ms_per_window": wall / n * 1e3,
            "own_kernels": own, "own_kernel_ms_per_window": own_ms,
            "kernels_per_window": sum(k[1] for k in kernels) / n,
            # What the host queued: kernel launches, graph launches and
            # copies (runtime API calls the profiler saw).
            "queued_per_window": sum(calls.get(k, 0)
                                     for k in LAUNCH_CALLS) / n,
            "graph_launches_per_window": calls.get("cudaGraphLaunch", 0) / n,
            "device_ms_per_window": device_us / n / 1e3,
            "device_busy_share": device_us / 1e6 / wall,
            "device_idle_share": 1.0 - device_us / 1e6 / wall,
            "top_kernels": [{"name": k[2][:90], "count": k[1],
                             "device_ms_per_window": k[0] / n / 1e3}
                            for k in kernels[:10]],
            "top_host_ops": [{"name": k[2], "count": k[1],
                              "host_ms_per_window": k[0] / n / 1e3}
                             for k in host_ops[:12]],
            # The device-track twins of mm.* ranges that device_work left
            # out, by name: their count.
            "ranges_left_out": {e.key: e.count for e in prof.key_averages()
                                if str(e.device_type).endswith("CUDA")
                                and e.key.startswith("mm.")}}


#: The device kernels of csrc/: block_best.cu's two, quality_accum.cu's.
OWN_KERNELS = ("prep_kernel", "block_best_kernel", "quality_accum_kernel")


def check_own_kernels(prof, want, what):
    """The profiled run's hand kernels, counted on the device, must be
    ``want`` of each (one per window chunk on a 1v1 path, none on a team
    or role path)."""
    if prof["own_kernels"] != {name: want for name in OWN_KERNELS}:
        raise AssertionError(f"{what}: the device ran {prof['own_kernels']} "
                             f"of the hand kernels, expected {want} of each")


#: Profiled sessions a gate on the kernels' counts may take.
#: torch.profiler lost up to a window's records at random in 3 of 128
#: sessions on an H100 (``scripts/torch_profiler_records.py``). A kernel
#: that ran another number of times shows it in every session; a lost
#: record never adds one.
PROFILE_TRIES = 3


def device_busy_exact(torch, ck, run_of, want, what):
    """``device_busy(torch, run_of(i))`` for sessions i = 0, 1, ... until
    one counts exactly ``want`` hand kernels by name, at most
    ``PROFILE_TRIES``: that session's numbers, with ``short_sessions``
    (each short session's counts, its kernels a window and the host's
    launches in it). Raises when every session is short, when one counts
    more than ``want``, or when the host launched another number than
    ``want`` (``ck.LAUNCHES``: then no drop explains it)."""
    short = []
    for i in range(PROFILE_TRIES):
        before = dict(ck.LAUNCHES)
        prof = device_busy(torch, run_of(i))
        own = prof["own_kernels"]
        host = {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES}
        if own == want:
            prof["short_sessions"] = short
            return prof
        short.append({"own": own, "host_launches": host,
                      "kernels_per_window": prof["kernels_per_window"],
                      "top_kernels": [(k["name"][:60], k["count"])
                                      for k in prof["top_kernels"]]})
        if (any(own[name] > want[name] for name in want)
                or host["block_best"] != want["block_best_kernel"]):
            break
    raise AssertionError(f"{what}: the device ran {short}, expected {want}")


#: Kernels of ``profiler_lead_in``: well past the ~27 a session that
#: torch.profiler leaves out late in this process.
LEAD_IN_KERNELS = 256


def profiler_lead_in(torch):
    """Open a profiler session with ``LEAD_IN_KERNELS`` tiny kernels of no
    interest (``torch.cuda._sleep``'s spin kernel, which nothing else
    launches), waited for. After phases 4-13 torch.profiler leaves out
    the first ~27 kernels of every session (PERF.md §7); a session whose
    launches are counted by name and cannot be run again (11c's successor)
    begins with these, so that what is lost is theirs
    (``lead_in_seen`` counts what the profiler kept of them)."""
    for _ in range(LEAD_IN_KERNELS):
        torch.cuda._sleep(10)
    torch.cuda.synchronize()


def lead_in_seen(prof) -> int:
    """The lead-in's kernels a finished profiler session counted."""
    return sum(e.count for e in prof.key_averages()
               if "spin_kernel" in e.key)


#: Runtime API calls that queue work on the card: kernel launches, graph
#: launches, copies and fills.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def graph_summary(rep):
    """An engine's ``graph_report()`` in brief: captures, capture and
    warm-up host ms (sum and largest), private memory (sum and by graph)."""
    graphs = rep["graphs"].values()
    return {"captures": rep["captures"],
            "capture_ms_total": sum(g["capture_ms"] for g in graphs),
            "capture_ms_max": max(g["capture_ms"] for g in graphs),
            "warm_ms_total": sum(g["warm_ms"] for g in graphs),
            "memory_bytes_total": sum(g["memory_bytes"] for g in graphs),
            "by_graph": {k: {"capture_ms": round(g["capture_ms"], 3),
                             "memory_bytes": g["memory_bytes"]}
                         for k, g in rep["graphs"].items()}}


def replay_equals_eager(torch, np, mods, cfg, pop, *, waiting, t0, windows,
                        now_of, label):
    """Each window of the main path through an engine that replays its
    captured steps and through one that runs the same steps eagerly on the
    card (its graph set taken away), dispatched and flushed in lockstep
    from the same restored pool: every window's pairs, distances (bit for
    bit) and queued ids equal, and at the end the pools, the quality
    states and the pruned step's counts equal."""
    _, GpuEngine, RequestColumns, _ = mods
    queue = cfg.queues[0]
    graphed, eager = (GpuEngine(cfg, queue, device="cuda") for _ in range(2))
    eager._graphs = None
    for e in (graphed, eager):
        e.warmup()
        e.restore_columns(pop.columns(RequestColumns, e, 0, waiting, t0), t0)
    for w in range(windows):
        outs = []
        for e in (graphed, eager):
            e.search_columns_async(pop.columns(
                RequestColumns, e, waiting + w * FULL_B,
                waiting + (w + 1) * FULL_B, now_of[w]), now_of[w])
            (_, out), = e.flush()
            outs.append(out)
        a, b = outs
        if (a.m_id_a.tolist() != b.m_id_a.tolist()
                or a.m_id_b.tolist() != b.m_id_b.tolist()
                or a.q_ids.tolist() != b.q_ids.tolist()
                or not np.array_equal(a.m_dist.view(np.int32),
                                      b.m_dist.view(np.int32))):
            raise AssertionError(f"{label} window {w}: the replayed step "
                                 f"differs from the eager one")
    torch.cuda.synchronize()
    for name, col in eager.dev_pool.full.items():
        if not torch.equal(graphed.dev_pool.full[name], col):
            raise AssertionError(f"{label}: pool column {name} differs after "
                                 f"{windows} replayed and eager windows")
    if not torch.equal(graphed._q_dev.flat, eager._q_dev.flat):
        raise AssertionError(f"{label}: the quality states differ")
    if graphed.prune_report() != eager.prune_report():
        raise AssertionError(f"{label}: pruned counts {graphed.prune_report()}"
                             f" != {eager.prune_report()}")
    if graphed.formation_report() != eager.formation_report():
        raise AssertionError(f"{label}: formation reports differ")
    return windows


def exact_index(np, active, rating, rd, n_blocks):
    """The bucket index of a pool from its columns, on the host: per block
    the active count, the live rating bounds (+inf / -inf when empty) and
    the largest live rating deviation (0 when empty)."""
    act = active.reshape(n_blocks, -1)
    r = rating.reshape(n_blocks, -1)
    return {"bidx_count": act.sum(1).astype(np.int32),
            "bidx_min": np.where(act, r, np.inf).min(1).astype(np.float32),
            "bidx_max": np.where(act, r, -np.inf).max(1).astype(np.float32),
            "bidx_rd": np.where(act, rd.reshape(n_blocks, -1),
                                0.0).max(1).astype(np.float32)}


def check_bucketed(torch, np, eng, at_heartbeat, windows, label):
    """A bucketed run's index, after ``flush()``: the mid-stream heartbeat's
    rebuild equal to a host rebuild of the pool it read; the device counts
    equal to the mirror's bucket occupancy (``formation_report``) and to a
    host count of the pool, its bounds holding the live bounds; every
    window in the touched count. Returns the formation report's numbers."""
    nb = eng.kernels.n_blocks
    host = {k: v.cpu().numpy() for k, v in at_heartbeat.items()}
    want = exact_index(np, host["active"], host["rating"], host["rd"], nb)
    for k, v in want.items():
        if not np.array_equal(host[k].view(np.int32), v.view(np.int32)):
            raise AssertionError(f"{label}: the heartbeat's {k} "
                                 f"{host[k].tolist()} != {v.tolist()}")
    pool = {k: eng.dev_pool[k].cpu().numpy() for k in (
        "active", "rating", "rd", "bidx_count", "bidx_min", "bidx_max")}
    exact = exact_index(np, pool["active"], pool["rating"], pool["rd"], nb)
    rep = eng.formation_report()
    if (pool["bidx_count"].tolist() != rep["bucket_occupancy"]
            or pool["bidx_count"].tolist() != exact["bidx_count"].tolist()):
        raise AssertionError(f"{label}: index counts {pool['bidx_count']} "
                             f"!= occupancy {rep['bucket_occupancy']} or "
                             f"the pool's {exact['bidx_count']}")
    if ((pool["bidx_min"] > exact["bidx_min"]).any()
            or (pool["bidx_max"] < exact["bidx_max"]).any()):
        raise AssertionError(f"{label}: index bounds narrower than the pool's")
    if rep["windows"] != windows:
        raise AssertionError(f"{label}: formation counted {rep['windows']} "
                             f"of {windows} windows")
    return {k: rep[k] for k in ("windows", "touched_slots", "total_slots",
                                "formation_touched_frac", "bucket_occupancy",
                                "peak_bucket_occupancy")}


def greedy_pair_kernels(torch, kernels, capacity, rows, n_blocks, rounds):
    """Device kernels one ``greedy_pair`` call launches (torch.profiler
    over one call on window-shaped inputs, after a warm-up call)."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cpu").manual_seed(0)
    vals = -torch.rand(rows, n_blocks, generator=g).cuda() * 100.0
    idxs = torch.randint(0, capacity, (rows, n_blocks), generator=g,
                         dtype=torch.int32).cuda()
    slot = torch.arange(rows, dtype=torch.int32).cuda()
    kernels.greedy_pair(vals, idxs, slot, capacity, rounds)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        kernels.greedy_pair(vals, idxs, slot, capacity, rounds)
        torch.cuda.synchronize()
    return sum(e.count for e in device_work(prof))


def reset_counts(ck):
    """Every kernel's launch count to 0, just before a path is driven."""
    for name in ck.LAUNCHES:
        ck.LAUNCHES[name] = 0


def quality_reconciles(np, eng, pop, outs, what):
    """The engine's quality report, read after ``flush()``, against a host
    recomputation from the returned outcomes (engine/quality's host
    accumulator over both sides of every match): the same samples, per
    rating bucket. Returns the report's sample count."""
    from matchmaking_tpu_torch.engine.quality import HostQualityAccum

    host = HostQualityAccum(eng._q_spec)
    for out in outs:
        if out.n_matches:
            host.observe(
                rating=np.concatenate([pop.rating[pop.rows(out.m_id_a)],
                                       pop.rating[pop.rows(out.m_id_b)]]),
                quality=np.concatenate([out.m_quality, out.m_quality]),
                wait_s=np.concatenate([out.m_wait_a, out.m_wait_b]),
                spread=np.concatenate([out.m_dist, out.m_dist]))
    rep = eng.quality_report()
    got = [b["count"] for b in rep["buckets"]]
    want = host.arrays["count"].tolist()
    if got != want:
        raise AssertionError(f"{what}: quality report counts {got} != the "
                             f"outcomes' {want}")
    return rep["samples"]


def run_columnar(torch, np, ck, scoring, mods, path, *, waiting, windows,
                 glicko2, filters, seed, cpu_windows, object_windows,
                 profile_windows, engine_over=None, heartbeat_at=None):
    """The main path: ``restore_columns`` fills the pool, then ``windows``
    windows of 1,024 go through ``search_columns_async`` at the config's
    pipeline depth, each collected with ``collect_ready`` only after the
    next is dispatched, and ``flush`` ends the run. ``engine_over``
    replaces engine keys of the file (the pruned or bucketed path's
    knobs). A bucketed run calls ``heartbeat`` right after window
    ``heartbeat_at`` is dispatched (windows in flight) and holds the index
    it rebuilt to an exact rebuild of the pool at that point."""
    import dataclasses

    Config, GpuEngine, RequestColumns, SearchRequest = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    if engine_over:
        cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
            cfg.engine, **engine_over))
    bucketed = bool(cfg.engine.bucketed)
    label = path + (" (bucketed)" if bucketed
                    else " (pruned)" if engine_over else "")
    queue, depth = cfg.queues[0], cfg.engine.pipeline_depth
    rng = np.random.default_rng(seed)
    t0 = 1_700_000_000.0
    n_all = waiting + (windows + profile_windows) * FULL_B
    pop = Population(np, rng, n_all, t0, filters=filters, glicko2=glicko2,
                     deadline_frac=0.05)
    enq = np.empty(n_all)
    now_of = [t0 + 1.0 + 0.05 * w for w in range(windows + profile_windows)]
    enq[:waiting] = t0 - pop.waited[:waiting]
    for w, now in enumerate(now_of):
        lo = waiting + w * FULL_B
        enq[lo:lo + FULL_B] = now - pop.waited[lo:lo + FULL_B]
    eng = GpuEngine(cfg, queue, device="cuda")
    t = time.perf_counter()
    eng.warmup()
    warmup_s = time.perf_counter() - t
    graphs = graph_summary(eng.graph_report())
    fill = pop.columns(RequestColumns, eng, 0, waiting, t0)
    stream = [pop.columns(RequestColumns, eng, waiting + w * FULL_B,
                          waiting + (w + 1) * FULL_B, now_of[w])
              for w in range(windows + profile_windows)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    with no_sync(torch):
        eng.restore_columns(fill, t0)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    if eng.pool_size() != waiting:
        raise AssertionError(f"restore left {eng.pool_size()} != {waiting}")
    deadlines_waiting = eng.deadline_count()
    util0 = eng.util_report()
    spans0 = dict(eng.spans)
    prune0 = eng.prune_report()  # one read of the span counter, before
    samples0 = eng.quality_report()["samples"]
    reset_counts(ck)  # count the main path's launches only
    dispatch_ms, turnaround_ms, gc_ms = [], [], []
    outs, t_disp, token_window = {}, {}, {}
    at_heartbeat = None
    with GcClock() as gc_clock:
        t_run = time.perf_counter()
        for w in range(windows):
            gc_before = gc_clock.total
            t = time.perf_counter()
            with no_sync(torch):
                tok = eng.search_columns_async(stream[w], now_of[w])
            dispatch_ms.append((time.perf_counter() - t) * 1e3)
            t_disp[tok], token_window[tok] = t, w
            if bucketed and w == heartbeat_at:
                # The rebuild queues behind the windows in flight; so do
                # these copies of its index and of the pool it read.
                with no_sync(torch):
                    eng.heartbeat(now_of[w])
                    at_heartbeat = {k: eng.dev_pool[k].clone() for k in (
                        "active", "rating", "rd", "bidx_count", "bidx_min",
                        "bidx_max", "bidx_rd")}
            if w == 1:
                # Collect windows 0 and 1 together, so the CPU replay of the
                # first three windows sees the same pool at each dispatch.
                torch.cuda.synchronize()
            while eng.inflight() >= depth:
                for tok_c, out in eng.collect_ready():
                    turnaround_ms.append((time.perf_counter() - t_disp[tok_c]) * 1e3)
                    outs[token_window[tok_c]] = out
            gc_ms.append((gc_clock.total - gc_before) * 1e3)
        for tok_c, out in eng.flush():
            turnaround_ms.append((time.perf_counter() - t_disp[tok_c]) * 1e3)
            outs[token_window[tok_c]] = out
        run_s = time.perf_counter() - t_run
    launches = ck.LAUNCHES["block_best"]
    q_launches = ck.LAUNCHES["quality_accum"]
    prune = eng.prune_report()  # and once after flush()
    if prune is not None:
        prune = {k: prune[k] - prune0[k] for k in prune}
    util = eng.util_report()
    spans = {k: (v - spans0[k]) for k, v in eng.spans.items()}
    split = {k[:-2] + "_ms": v / windows * 1e3 for k, v in spans.items()
             if k.endswith("_s")}
    idle = util["device_idle_s"] - util0["device_idle_s"]
    busy = util["device_busy_s"] - util0["device_busy_s"]
    # -- checks, after the timed loop (they build Python objects) --
    if launches != windows or q_launches != windows:
        # one launch of each per <= 1,024-lane window chunk
        raise AssertionError(f"block_best launched {launches} times and "
                             f"quality_accum {q_launches} for {windows} "
                             f"window chunks")
    if prune is not None and prune["windows"] != windows:
        raise AssertionError(f"pruned steps {prune} for {windows} windows")
    formation = (check_bucketed(torch, np, eng, at_heartbeat, windows, label)
                 if bucketed else None)
    if bucketed and prune["span_windows"] == 0:
        raise AssertionError(f"{label}: no window took the span path "
                             f"({prune})")
    seen, matches, admitted = set(), 0, 0
    for w in range(windows):
        out = outs[w]
        matches += check_columnar(np, scoring, eng, pop, out, now_of[w], enq,
                                  seen, glicko2, window_ids=stream[w].ids)
        admitted += len(stream[w]) - len(out.rejected)
    if eng.pool_size() != waiting + admitted - 2 * matches:
        raise AssertionError(f"pool_size {eng.pool_size()} != {waiting} + "
                             f"{admitted} - 2 x {matches}")
    samples = quality_reconciles(np, eng, pop, [outs[w] for w in range(windows)],
                                 label)
    if samples - samples0 != 2 * matches or samples0:
        raise AssertionError(f"{label}: {samples} quality samples for "
                             f"{matches} matches")
    # The deadline sweep: every stamped player still waiting expires (5 %
    # of the rows carry a deadline, arrivals included).
    n_in = waiting + windows * FULL_B
    stamped = pop.deadline[:n_in] != 0.0
    left = sum(1 for p in pop.ids[:n_in][stamped].tolist() if p not in seen)
    if eng.deadline_count() != left or left == 0:
        raise AssertionError(f"deadline_count {eng.deadline_count()} != {left}")
    t = time.perf_counter()
    expired = eng.expire_deadlines(t0 + 50.0)
    sweep_ms = (time.perf_counter() - t) * 1e3
    if len(expired) != left or eng.deadline_count() != 0:
        raise AssertionError(f"expire_deadlines took {len(expired)} of {left}")
    if any(r.id in eng.pool for r in expired):
        raise AssertionError("an expired player is still waiting")
    if eng.graph_report()["captures"] != graphs["captures"]:
        raise AssertionError(f"{label}: a window captured a graph again")
    log(f"columnar {label}: {matches} matches in {windows} windows, "
        f"dispatch p50 {statistics.median(dispatch_ms):.3f} ms p99 "
        f"{pct(dispatch_ms, 0.99):.3f} ms, turnaround "
        f"p50 {statistics.median(turnaround_ms):.2f} ms, "
        f"{windows * FULL_B / run_s:.0f} requests/s, launches {launches} "
        f"block_best + {q_launches} quality_accum, {samples} quality samples "
        f"reconciled, pruned {prune}, formation {formation}, "
        f"deadline sweep {len(expired)} players in {sweep_ms:.2f} ms; "
        f"warmup {warmup_s:.2f} s: {graphs['captures']} graphs captured in "
        f"{graphs['capture_ms_total']:.1f} ms (largest "
        f"{graphs['capture_ms_max']:.1f}), {graphs['memory_bytes_total']} "
        f"bytes of graph memory")
    # The device's busy share over further windows, under torch.profiler.
    prof = None
    if profile_windows:
        def run():
            for w in range(windows, windows + profile_windows):
                eng.search_columns_async(stream[w], now_of[w])
                while eng.inflight() >= depth:
                    eng.collect_ready()
            eng.flush()
            return profile_windows
        prof = device_busy(torch, run)
        check_own_kernels(prof, profile_windows, f"profile {label}")
        from matchmaking_tpu_torch.engine import kernels
        prof["greedy_pair_kernels_per_call"] = greedy_pair_kernels(
            torch, kernels, eng.kernels.capacity, FULL_B, eng.kernels.n_blocks,
            eng.kernels.pair_rounds)
        # The quality state's copies to the host in the profiled run (the
        # flush's, and every quality_report_every windows): memcpys, not
        # step kernels.
        prof["quality_copies"] = 1 + profile_windows // max(
            1, cfg.observability.quality_report_every)
        prof["step_kernels_per_window"] = (prof["kernels_per_window"]
                                           - prof["quality_copies"]
                                           / profile_windows)
        log(f"profile {label}: device busy {prof['device_busy_share']:.3f}, "
            f"{prof['device_ms_per_window']:.3f} device ms, "
            f"{prof['queued_per_window']:.2f} launches queued by the host "
            f"({prof['graph_launches_per_window']:.2f} graph launches) and "
            f"{prof['kernels_per_window']:.2f} kernels per window "
            f"({prof['step_kernels_per_window']:.2f} without the quality "
            f"state's copies), {prof['greedy_pair_kernels_per_call']} in "
            f"greedy_pair; top {prof['top_kernels'][:4]}; device-track "
            f"twins of mm.* ranges left out {prof['ranges_left_out']}")
    # The same first windows on a CPU columnar engine (windows 0 and 1
    # dispatched before any collection, as on the card).
    cpu = GpuEngine(cfg, queue, device="cpu")
    cpu.restore_columns(pop.columns(RequestColumns, cpu, 0, waiting, t0), t0)
    cpu_outs = []
    for w in range(cpu_windows):
        cpu.search_columns_async(pop.columns(
            RequestColumns, cpu, waiting + w * FULL_B,
            waiting + (w + 1) * FULL_B, now_of[w]), now_of[w])
        if w >= 1 or w == cpu_windows - 1:
            cpu_outs += [o for _, o in cpu.flush()]
    for w in range(cpu_windows):
        if pair_set(cpu_outs[w]) != pair_set(outs[w]):
            raise AssertionError(f"{label} window {w}: the CPU engine formed "
                                 f"other pairs")
    # Every window replayed against the same step run eagerly on the card.
    eager_windows = replay_equals_eager(
        torch, np, mods, cfg, pop, waiting=waiting, t0=t0, windows=windows,
        now_of=now_of, label=label)
    log(f"columnar {label}: {eager_windows} windows replayed bit-equal to "
        f"the eager step")
    # The object path on the card, from the same pool: the same first
    # window, then its own windows (its slot layout parts from the
    # columnar one after a window: see PERF.md).
    obj = None
    if object_windows:
        o_eng = GpuEngine(cfg, queue, device="cuda")
        o_eng.warmup()
        o_eng.restore_columns(pop.columns(RequestColumns, o_eng, 0, waiting, t0), t0)
        torch.cuda.synchronize()
        reset_counts(ck)
        step_ms, o_gc, o_seen, o_matches = [], [], set(), 0
        for w in range(object_windows):
            c = stream[w]
            reqs = [SearchRequest(id=c.ids[i], rating=float(c.rating[i]),
                           rating_deviation=float(c.rd[i]),
                           region=pop.region[waiting + w * FULL_B + i],
                           game_mode=pop.mode[waiting + w * FULL_B + i],
                           enqueued_at=float(c.enqueued_at[i]))
                    for i in range(len(c))]
            with GcClock() as g:
                t = time.perf_counter()
                out = o_eng.search(reqs, now_of[w])
                step_ms.append((time.perf_counter() - t) * 1e3)
            o_gc.append(g.total * 1e3)
            ids = {r.id for m in out.matches for r in m.requests()}
            if ids & o_seen:
                raise AssertionError("object path: a player in two matches")
            o_seen |= ids
            o_matches += len(out.matches)
            if w == 0 and ({frozenset(r.id for r in m.requests())
                            for m in out.matches} != pair_set(outs[0])):
                raise AssertionError("object path: window 0 pairs differ "
                                     "from the columnar path's")
        o_launches = ck.LAUNCHES["block_best"]
        if (o_launches != object_windows
                or ck.LAUNCHES["quality_accum"] != object_windows):
            raise AssertionError(f"object path: {ck.LAUNCHES} launches for "
                                 f"{object_windows} windows")
        o_eng.flush()
        if o_eng.quality_report()["samples"] != 2 * o_matches:
            raise AssertionError("object path: quality samples != 2 x "
                                 "matches")
        obj = {"windows": object_windows, "matches": o_matches,
               "launches": o_launches, "step_ms": step_ms, "gc_ms": o_gc,
               "step_ms_p50": statistics.median(step_ms),
               "step_ms_max": max(step_ms)}
        log(f"object {path}: step p50 {obj['step_ms_p50']:.2f} ms, max "
            f"{obj['step_ms_max']:.2f} ms, GC max {max(o_gc):.2f} ms")
    return {
        "config": path, "engine_over": engine_over, "waiting": waiting,
        "windows": windows, "window": FULL_B, "pipeline_depth": depth,
        "matches": matches, "launches": launches,
        "quality_launches": q_launches, "quality_samples": samples,
        "prune": prune, "formation": formation,
        "pool_size_end": eng.pool_size(),
        "restore_s": restore_s,
        "dispatch_ms": dispatch_ms, "turnaround_ms": turnaround_ms,
        "dispatch_ms_p50": statistics.median(dispatch_ms),
        "dispatch_ms_p99": pct(dispatch_ms, 0.99),
        "turnaround_ms_p50": statistics.median(turnaround_ms),
        "turnaround_ms_p99": pct(turnaround_ms, 0.99),
        "requests_per_s": windows * FULL_B / run_s, "run_s": run_s,
        "gc_ms": gc_ms, "gc_ms_total": sum(gc_ms), "gc_ms_max": max(gc_ms),
        "idle_fraction": idle / max(1e-9, idle + busy),
        "util_report": util, "split_ms_per_window": split,
        "deadlines_waiting_at_start": deadlines_waiting,
        "deadline_sweep": {"expired": len(expired), "ms": sweep_ms},
        "cpu_windows_equal": cpu_windows, "profile": prof, "object": obj,
        "eager_windows_equal": eager_windows, "warmup_s": warmup_s,
        "graphs": graphs,
    }


def run_rescan(torch, np, ck, scoring, mods, path, *, waiting, seed):
    """Config #4 (Glicko-2, widening 5/s): a rescan tick dispatched between
    two traffic windows in flight (windows and tick are collected
    together at the end). The tick must form matches the arrivals did
    not, and a CPU engine driven the same way must form the same pairs."""
    Config, GpuEngine, RequestColumns, _ = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    queue = cfg.queues[0]
    chunks = 2  # a tick of two chunks of the largest bucket (the depth-2 cap)
    tick = chunks * max(cfg.engine.batch_buckets)
    rng = np.random.default_rng(seed)
    t0 = 1_700_000_000.0
    pop = Population(np, rng, waiting + 2 * FULL_B, t0, filters=False,
                     glicko2=True)
    nows = (t0 + 1.0, t0 + 30.0, t0 + 30.5)
    enq = np.concatenate([t0 - pop.waited[:waiting],
                          nows[0] - pop.waited[waiting:waiting + FULL_B],
                          nows[2] - pop.waited[waiting + FULL_B:]])

    def drive(device, eager=False):
        eng = GpuEngine(cfg, queue, device=device)
        if eager:
            eng._graphs = None  # the same steps, eagerly on the card
        eng.warmup()
        eng.restore_columns(pop.columns(RequestColumns, eng, 0, waiting, t0), t0)
        a = pop.columns(RequestColumns, eng, waiting, waiting + FULL_B, nows[0])
        b = pop.columns(RequestColumns, eng, waiting + FULL_B,
                        waiting + 2 * FULL_B, nows[2])
        if device != "cpu":
            torch.cuda.synchronize()
            reset_counts(ck)
        with (no_sync(torch) if device != "cpu" else contextlib.nullcontext()):
            ta = eng.search_columns_async(a, nows[0])
            before = dict(ck.LAUNCHES)
            tr = eng.rescan_async(tick, nows[1])
            tick_launches = {k: v - before[k] for k, v in ck.LAUNCHES.items()}
            tb = eng.search_columns_async(b, nows[2])
        outs = dict(eng.flush())
        return eng, (outs[ta], outs[tr], outs[tb]), tick_launches

    eng, outs, tick_counts = drive("cuda")
    launches = dict(ck.LAUNCHES)
    tick_launches = tick_counts["block_best"]
    if (tick_counts != {"block_best": chunks, "quality_accum": chunks}
            or launches != {"block_best": 2 + chunks,
                            "quality_accum": 2 + chunks}):
        raise AssertionError(f"rescan run: {tick_counts} launches for the "
                             f"tick's {chunks} chunks, {launches} in all for "
                             f"{2 + chunks} chunks")
    launches = launches["block_best"]
    seen = set()
    for out, now in zip(outs, nows):
        check_columnar(np, scoring, eng, pop, out, now, enq, seen, True)
    if outs[1].n_matches == 0:
        raise AssertionError("the rescan tick formed no match")
    samples = quality_reconciles(np, eng, pop, outs, "rescan run")
    if samples != 2 * sum(o.n_matches for o in outs):
        raise AssertionError("rescan run: quality samples != 2 x matches")
    _, cpu_outs, _ = drive("cpu")
    for k, (got, want) in enumerate(zip(outs, cpu_outs)):
        if pair_set(got) != pair_set(want):
            raise AssertionError(f"rescan run, outcome {k}: the CPU engine "
                                 f"formed other pairs")
    # The tick's two chunks replay one graph before the tick's readbacks:
    # each reads back its own result, the eager step's.
    _, eager_outs, _ = drive("cuda", eager=True)
    for k, (got, want) in enumerate(zip(outs, eager_outs)):
        if (got.m_id_a.tolist() != want.m_id_a.tolist()
                or not np.array_equal(got.m_dist.view(np.int32),
                                      want.m_dist.view(np.int32))):
            raise AssertionError(f"rescan run, outcome {k}: the replayed "
                                 f"steps differ from the eager ones")
    # One more tick under torch.profiler: what the host queues and the
    # device runs per chunk (each chunk one graph replay).
    def run():
        eng.rescan_async(tick, nows[2] + 1.0)
        eng.flush()
        return chunks
    prof = device_busy(torch, run)
    check_own_kernels(prof, chunks, "rescan tick profile")
    log(f"rescan tick profile: {prof['queued_per_window']:.2f} launches "
        f"queued by the host ({prof['graph_launches_per_window']:.2f} graph "
        f"launches) and {prof['kernels_per_window']:.2f} kernels per chunk, "
        f"{prof['device_ms_per_window']:.3f} device ms a chunk")
    log(f"rescan {path}: tick of {chunks} chunks formed "
        f"{outs[1].n_matches} matches between waiting players "
        f"(arrivals {outs[0].n_matches} + {outs[2].n_matches}); same pairs "
        f"on the CPU and eagerly on the card; launches {tick_launches} in "
        f"the tick, "
        f"{launches - tick_launches} in the arrival windows")
    return {"config": path, "waiting": waiting, "rescan_chunks": chunks,
            "rescan_matches": outs[1].n_matches,
            "arrival_matches": outs[0].n_matches + outs[2].n_matches,
            "launches": launches, "tick_launches": tick_launches,
            "arrival_launches": launches - tick_launches,
            "tick_profile": prof}


def same_outcomes(np, got, want, what):
    """Two columnar outcomes (or lists of them, concatenated) with the same
    pairs in the same order, distances bit for bit, and queued ids."""
    cat = lambda outs, name: [x for o in outs for x in getattr(o, name).tolist()]
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    for name in ("m_id_a", "m_id_b", "q_ids"):
        if cat(got, name) != cat(want, name):
            raise AssertionError(f"{what}: {name} differ")
    gd = np.concatenate([o.m_dist for o in got]).view(np.int32)
    wd = np.concatenate([o.m_dist for o in want]).view(np.int32)
    if not np.array_equal(gd, wd):
        raise AssertionError(f"{what}: distances differ")
    return sum(o.n_matches for o in got)


def same_pools(torch, a, b, what):
    """Two engines' device pools (index columns included) and quality
    states bit-equal."""
    torch.cuda.synchronize()
    for name, col in a.dev_pool.full.items():
        if not torch.equal(col, b.dev_pool.full[name]):
            raise AssertionError(f"{what}: pool column {name} differs")
    if not torch.equal(a._q_dev.flat, b._q_dev.flat):
        raise AssertionError(f"{what}: the quality states differ")


def event_ms(torch, fn):
    """Device ms from a CUDA event before ``fn()`` to one after it (what
    ``fn`` queued on the stream), and ``fn``'s result."""
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b), out


def run_speculation(torch, np, ck, mods, path, *, engine_over, waiting,
                    windows, seed):
    """Phase 3d: speculation on the card. An engine with ``spec_formation``
    (two passes) and a twin without a held speculation take the same
    restore and ``windows`` traffic windows in lockstep (equal outcomes).
    Then the engine speculates 30 s after the stream (widened thresholds
    where the queue widens): its live pool stays bit-equal through it, and
    the commit's outcome equals the twin's two cold ``rescan_async`` ticks
    at the same time (queued back to back, so both pick the same players,
    as the two passes do), pair for pair, distances bit for bit, with equal
    pools (index columns included) and quality states after. A second
    speculation, invalidated by a traffic window, leaves the live pool
    bit-equal to before it, and the next window's outcome and the pools
    again equal the twin's. Times: the spare pool's copy (device ms,
    median of 10), a speculation (device ms from an event before to one
    after: the copy, 2 passes of the rescan graph per chunk, the result
    copies) and a commit (the copy back and one quality fold a chunk),
    with their host ms; the launches of each; the counters."""
    import dataclasses

    Config, GpuEngine, RequestColumns, _ = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, spec_formation=True, spec_max_steps=2, **engine_over))
    label = f"speculation {path}" + (" (bucketed)" if cfg.engine.bucketed
                                     else "")
    queue = cfg.queues[0]
    rng = np.random.default_rng(seed)
    t0 = 1_700_000_000.0
    pop = Population(np, rng, waiting + (windows + 1) * FULL_B, t0,
                     filters=False, glicko2=queue.glicko2)
    now_of = [t0 + 1.0 + 0.05 * w for w in range(windows + 1)]
    eng, twin = (GpuEngine(cfg, queue, device="cuda") for _ in range(2))
    for e in (eng, twin):
        e.warmup()
        e.restore_columns(pop.columns(RequestColumns, e, 0, waiting, t0), t0)

    def window(w):
        outs = []
        for e in (eng, twin):
            e.search_columns_async(pop.columns(
                RequestColumns, e, waiting + w * FULL_B,
                waiting + (w + 1) * FULL_B, now_of[w]), now_of[w])
            (_, out), = e.flush()
            outs.append(out)
        same_outcomes(np, *outs, f"{label} window {w}")

    for w in range(windows):
        window(w)
    same_pools(torch, eng, twin, f"{label} after the stream")
    t_spec = now_of[windows - 1] + 30.0
    torch.cuda.synchronize()
    before = {k: v.clone() for k, v in eng.dev_pool.full.items()}
    reset_counts(ck)
    h = time.perf_counter()
    spec_ms, held = event_ms(torch, lambda: eng.speculate(t_spec))
    spec_host_ms = (time.perf_counter() - h) * 1e3
    spec_launches = dict(ck.LAUNCHES)
    if not held:
        raise AssertionError(f"{label}: no speculation held")
    for k, v in before.items():
        if not torch.equal(eng.dev_pool.full[k], v):
            raise AssertionError(f"{label}: the speculation wrote the live "
                                 f"pool's {k}")
    reset_counts(ck)
    tok = eng.spec_validate(t_spec)
    h = time.perf_counter()
    commit_ms, _ = event_ms(torch, lambda: eng.spec_commit(tok, t_spec))
    commit_host_ms = (time.perf_counter() - h) * 1e3
    commit_launches = dict(ck.LAUNCHES)
    (_, got), = eng.flush()
    # Two ticks queued back to back: the second picks the first's players
    # again (the mirror lags until the flush), as the second pass does.
    for _ in range(2):
        twin.rescan_async(2 * FULL_B, t_spec)
    cold = [o for _, o in twin.flush()]
    matches = same_outcomes(np, got, cold, f"{label}: commit against the "
                            f"cold rescans")
    same_pools(torch, eng, twin, f"{label} after the commit")
    steps = eng.spec_report()["spec_committed_steps"]
    if (matches == 0 or spec_launches["block_best"] != steps
            or spec_launches["quality_accum"] != 0
            or commit_launches != {"block_best": 0, "quality_accum": steps}):
        raise AssertionError(f"{label}: {matches} matches; launches "
                             f"{spec_launches} speculating, "
                             f"{commit_launches} committing, {steps} passes")
    # A speculation discarded by an admission.
    torch.cuda.synchronize()
    before = {k: v.clone() for k, v in eng.dev_pool.full.items()}
    if not eng.speculate(t_spec + 1.0):
        raise AssertionError(f"{label}: no second speculation")
    torch.cuda.synchronize()
    for k, v in before.items():
        if not torch.equal(eng.dev_pool.full[k], v):
            raise AssertionError(f"{label}: the discarded speculation wrote "
                                 f"the live pool's {k}")
    now_of[windows] = t_spec + 2.0
    window(windows)
    if eng.spec_validate(t_spec + 2.0) is not None:
        raise AssertionError(f"{label}: an admission left the speculation")
    same_pools(torch, eng, twin, f"{label} after the discarded speculation")
    report = eng.spec_report()
    if report["spec_hit"] != 1 or report["spec_wasted"] != 1:
        raise AssertionError(f"{label}: counters {report}")
    spare = eng._spec_device_pool()
    copy_ms = statistics.median(event_ms(torch, lambda: eng._copy_pool(
        spare, eng.dev_pool))[0] for _ in range(10))
    # The host's pick of the players (a rescan tick's): what most of a
    # speculation's host time goes to at this pool size.
    h = time.perf_counter()
    eng._rescan_chunks(2 * FULL_B, t_spec)
    pick_host_ms = (time.perf_counter() - h) * 1e3
    # One more speculation and its commit under torch.profiler: the device
    # time of what each queued (kernels and copies), apart from the host's.
    t_prof = t_spec + 3.0
    prof_spec = device_busy(torch, lambda: eng.speculate(t_prof) and 1)
    prof_commit = device_busy(torch, lambda: eng.spec_commit(
        eng.spec_validate(t_prof), t_prof) is not None and 1)
    eng.flush()
    out = {"config": path, "engine_over": engine_over, "waiting": waiting,
           "windows": windows, "commit_matches": matches, "passes": steps,
           "copy_ms": copy_ms, "speculate_ms": spec_ms,
           "speculate_host_ms": spec_host_ms, "pick_host_ms": pick_host_ms,
           "commit_ms": commit_ms,
           "commit_host_ms": commit_host_ms,
           "speculate_device_ms": prof_spec["device_ms_per_window"],
           "speculate_wall_ms": prof_spec["wall_ms_per_window"],
           "speculate_kernels": prof_spec["kernels_per_window"],
           "commit_device_ms": prof_commit["device_ms_per_window"],
           "commit_wall_ms": prof_commit["wall_ms_per_window"],
           "commit_kernels": prof_commit["kernels_per_window"],
           "speculate_launches": spec_launches["block_best"],
           "commit_launches": commit_launches["quality_accum"],
           "counters": report}
    log(f"{label}: commit of {steps} passes formed {matches} matches, equal "
        f"to the twin's cold rescans; pools equal; counters {report}; spare "
        f"pool copy {copy_ms:.4f} ms (events); speculate {spec_ms:.4f} ms "
        f"between events ({spec_host_ms:.3f} host, {pick_host_ms:.3f} of "
        f"it the players' pick), profiled: "
        f"{out['speculate_device_ms']:.4f} device ms in "
        f"{out['speculate_kernels']:.0f} kernels and copies, "
        f"{out['speculate_wall_ms']:.3f} wall; commit {commit_ms:.4f} ms "
        f"between events ({commit_host_ms:.3f} host), profiled "
        f"{out['commit_device_ms']:.4f} device ms in "
        f"{out['commit_kernels']:.0f}, {out['commit_wall_ms']:.3f} wall")
    return out


def check_faults(app, what):
    """The service nacks and revives after a failed window, and retries a
    failed tick, so its answers can all be right after a failure on the
    card: a service run passes only if it caught none."""
    if app.faults():
        raise AssertionError(f"{what}: the service caught failures: "
                             f"{app.faults()}")


# ---- phase 3e: grouped readback --------------------------------------------

#: Phase 3e's groups, each held to k = 1 (every window read back alone).
READBACK_GROUPS = (2, 3, 4)


def copies_by_kind(torch, run):
    """torch.profiler over ``run()``: the device's memcpy records by kind
    ("DtoH", "DtoD", "HtoD") and by name, and what ``run`` returns."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        n = run()
        torch.cuda.synchronize()
    kinds = {"DtoH": 0, "DtoD": 0, "HtoD": 0}
    names = {}
    for e in device_work(prof):
        for kind in kinds:
            if f"Memcpy {kind}" in e.key:
                kinds[kind] += e.count
                names[e.key] = names.get(e.key, 0) + e.count
    return n, kinds, names


def marks_split(eng, tokens):
    """Mean ms a window from its last device step to its "readback_seal"
    mark (waiting for its group) and from the seal to "collect", over
    ``tokens``' window marks (popped)."""
    wait, transfer = [], []
    for tok in tokens:
        marks = eng.window_marks.pop(tok)
        t = dict(marks)
        step = max(s for n, s in marks
                   if n in ("device_step", "formation_bucketed"))
        wait.append((t["readback_seal"] - step) * 1e3)
        transfer.append((t["collect"] - t["readback_seal"]) * 1e3)
    return statistics.fmean(wait), statistics.fmean(transfer)


def run_grouped_readback(torch, np, ck, mods, path, *, waiting, windows,
                         seed, profile_windows):
    """Phase 3e: grouped readback (``readback_group`` k) on config #1 at
    full width with phase 3's seeded population. Copies of one restored
    pool take ``windows`` windows of 1,024 and a two-chunk rescan tick,
    all dispatched, then flushed, at k = 1 and each of
    ``READBACK_GROUPS``, dense and bucketed (the span step and its
    rescan): pairs, distances, queued ids, pools and quality states
    bit-equal to k = 1; the same for the sharded step, D = 2 on
    ``("cuda:0",) × 2``, over 8 windows. Then k = 1 against k = 3 at the
    config's depth with ``readback_group_wait_ms`` 2, each window collected
    once the next is dispatched: nobody matched twice, matched + waiting
    = restored + admitted; dispatch p50, turnaround, readback ms a window
    (``util_report``) and the marks' group wait and transfer. Then the
    memcpys the device ran over ``profile_windows`` more windows at k = 1
    and k = 3 (torch.profiler, by name), and the graph audit of the
    grouped engine's dense step against the ungrouped one's. Returns the
    numbers and the launches of the runs (captures left out)."""
    import dataclasses

    Config, GpuEngine, RequestColumns, _ = mods
    base = Config.from_json(os.path.join(HERE, path), backend="gpu")
    rng = np.random.default_rng(seed)
    t0 = 1_700_000_000.0
    n_all = waiting + (windows + profile_windows) * FULL_B
    pop = Population(np, rng, n_all, t0, filters=False, glicko2=False)
    now_of = [t0 + 1.0 + 0.05 * w for w in range(windows + profile_windows)]
    launches = {"block_best": 0, "quality_accum": 0}

    def counted(fn):
        before = dict(ck.LAUNCHES)
        out = fn()
        for k in launches:
            launches[k] += ck.LAUNCHES[k] - before[k]
        return out

    def engine(k, over=None, d=1):
        cfg = dataclasses.replace(base, engine=dataclasses.replace(
            base.engine, readback_group=k, readback_group_wait_ms=2.0,
            **(over or {})))
        eng = (sharded_engine(mods, cfg, d, False) if d > 1
               else GpuEngine(cfg, cfg.queues[0], device="cuda"))
        eng.warmup()
        eng.restore_columns(pop.columns(RequestColumns, eng, 0, waiting, t0),
                            t0)
        return eng

    def stream(eng, lo, hi):
        return [pop.columns(RequestColumns, eng, waiting + w * FULL_B,
                            waiting + (w + 1) * FULL_B, now_of[w])
                for w in range(lo, hi)]

    def dispatch_all(eng, n, tick=True):
        cols = stream(eng, 0, n)
        torch.cuda.synchronize()

        def run():
            with no_sync(torch):
                for w in range(n):
                    eng.search_columns_async(cols[w], now_of[w])
                if tick:
                    eng.rescan_async(2 * FULL_B, now_of[n - 1] + 0.5)
            return [o for _, o in eng.flush()]
        return counted(run)

    equal = {}
    for family, over in (("dense", None), ("bucketed", BUCKETED)):
        ref = engine(1, over)
        want = dispatch_all(ref, windows)
        if want[-1].n_matches == 0:
            raise AssertionError(f"3e {family}: the rescan tick matched "
                                 f"nobody")
        for k in READBACK_GROUPS:
            eng = engine(k, over)
            got = dispatch_all(eng, windows)
            same_outcomes(np, got[:-1], want[:-1], f"3e {family} k={k}")
            same_outcomes(np, got[-1], want[-1], f"3e {family} k={k} tick")
            same_pools(torch, eng, ref, f"3e {family} k={k}")
            if eng._rb_open or eng.device_error is not None:
                raise AssertionError(f"3e {family} k={k}: a group left open "
                                     f"or a device error")
            eng.close()
        equal[family] = {"windows": windows, "k": list(READBACK_GROUPS),
                         "matches": sum(o.n_matches for o in want[:-1]),
                         "tick_matches": want[-1].n_matches}
        ref.close()
    shard = {}
    for k in (1, 3):
        eng = engine(k, d=2)
        shard[k] = (dispatch_all(eng, 8, tick=False), snapshot_pool(eng))
        eng.close()
    same_outcomes(np, shard[3][0], shard[1][0], "3e sharded D=2 k=3")
    for name, col in shard[1][1].items():
        if not torch.equal(col, shard[3][1][name]):
            raise AssertionError(f"3e sharded D=2: pool column {name} "
                                 f"differs")
    equal["sharded_d2"] = {"windows": 8, "k": [3],
                           "matches": sum(o.n_matches for o in shard[1][0])}
    log(f"3e grouped readback: bit-equal to k = 1: {equal}")
    timed, engines = {}, {}
    depth = base.engine.pipeline_depth
    for k in (1, 3):
        eng = engines[k] = engine(k)
        cols = stream(eng, 0, windows)
        util0, rb0 = eng.util_report(), eng.util["readback_s"]
        torch.cuda.synchronize()
        outs, disp, turn = counted(lambda: drive_columnar(
            torch, eng, cols, now_of, depth, timed=True))
        wait_ms, transfer_ms = marks_split(eng, sorted(eng.window_marks))
        seen, matched, admitted = set(), 0, 0
        for w in range(windows):
            ids = outs[w].m_id_a.tolist() + outs[w].m_id_b.tolist()
            if seen & set(ids) or len(set(ids)) != len(ids):
                raise AssertionError(f"3e k={k}: a player matched twice")
            seen |= set(ids)
            matched += len(ids)
            admitted += len(cols[w]) - len(outs[w].rejected)
        if matched + eng.pool_size() != waiting + admitted:
            raise AssertionError(f"3e k={k}: {matched} matched + "
                                 f"{eng.pool_size()} waiting != {waiting} "
                                 f"+ {admitted}")
        util = eng.util_report()
        timed[k] = {
            "dispatch_ms_p50": statistics.median(disp),
            "dispatch_ms_p99": pct(disp, 0.99),
            "turnaround_ms_p50": statistics.median(turn),
            "turnaround_ms_p99": pct(turn, 0.99),
            "readback_ms_per_window":
                (eng.util["readback_s"] - rb0) * 1e3 / windows,
            "group_wait_ms_per_window": wait_ms,
            "transfer_ms_per_window": transfer_ms,
            "windows": util["windows"] - util0["windows"],
            "players_matched": matched}
        log(f"3e k={k} at depth {depth}, wait 2 ms: dispatch p50 "
            f"{timed[k]['dispatch_ms_p50']:.3f} ms, turnaround p50 "
            f"{timed[k]['turnaround_ms_p50']:.3f} ms, readback "
            f"{timed[k]['readback_ms_per_window']:.3f} ms a window (group "
            f"wait {wait_ms:.3f}, seal -> collect {transfer_ms:.3f}), "
            f"{matched} matched")
    # The copies by name over more windows, dispatched and then flushed:
    # k = 3 reads them back in groups of 3, 3 and 2.
    copies = {}
    for k in (1, 3):
        eng = engines[k]
        cols = stream(eng, windows, windows + profile_windows)

        def run():
            for i, c in enumerate(cols):
                eng.search_columns_async(c, now_of[windows + i])
            eng.flush()
            return profile_windows
        _, kinds, names = counted(lambda: copies_by_kind(torch, run))
        copies[k] = {"per_window": {kind: n / profile_windows
                                    for kind, n in kinds.items()},
                     "by_name": names}
    if not (copies[3]["per_window"]["DtoH"] < copies[1]["per_window"]["DtoH"]
            and copies[3]["per_window"]["DtoD"]
            >= copies[1]["per_window"]["DtoD"] + 1.0):
        raise AssertionError(f"3e copies: k=1 {copies[1]}, k=3 {copies[3]}")
    log(f"3e memcpys a window over {profile_windows} windows: k=1 "
        f"{copies[1]['per_window']}, k=3 {copies[3]['per_window']}; by "
        f"name k=1 {copies[1]['by_name']}, k=3 {copies[3]['by_name']}")
    audit = {}
    for k in (1, 3):
        rep = engines[k].graph_audit("dense", FULL_B)
        if rep["problems"]:
            raise AssertionError(f"3e graph audit k={k}: {rep['problems']}")
        audit[k] = {key: rep[key] for key in ("kernel_nodes", "memset_nodes",
                                              "own_kernel_nodes")}
    if audit[3] != audit[1]:
        raise AssertionError(f"3e graph audit: k=3 {audit[3]} != k=1 "
                             f"{audit[1]}")
    for eng in engines.values():
        eng.close()
    log(f"3e graph audit (dense, B = {FULL_B}): {audit[3]} at k = 3 and 1; "
        f"launches {launches}")
    return {"config": path, "waiting": waiting, "windows": windows,
            "equal": equal, "timed": timed, "copies": copies,
            "graph_audit": audit, "launches": launches}


# ---- phase 3f: the stage profilers ------------------------------------------


def load_script(name):
    """``scripts/<name>.py`` of this checkout as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: Kernel-operator nodes of the stage graphs: one block_best launch (a
#: prep and a scorer node) where the stage scores, none elsewhere.
SCORING_STAGES = ("cands", "cands_nofilter", "full", "full_nofilter")


def stage_nodes_check(split, what):
    for name, s in split["stages"].items():
        own = s["own_kernel_nodes"]
        want = 1 if name in SCORING_STAGES else 0
        got = (own["prep_kernel"], own["block_best_kernel"],
               own["quality_accum_kernel"])
        if got != (want, want, 0):
            raise AssertionError(f"3f {what} {name}: prep, block_best and "
                                 f"quality_accum nodes {got}, want "
                                 f"({want}, {want}, 0)")


def run_stage_profilers(torch, np, ck, mods):
    """Phase 3f: the three stage profilers at config #1's width, imported
    and driven as their command lines drive them. Raises on an unequal
    graph/eager stage, a wrong kernel-operator node count, a full graph
    that does not account for the engine's, an unequal dense/pruned step,
    a span-path prunecheck whose window fell back, or a candidate pass
    unequal to its plain version. ``check_launches`` counts the
    block_best launches of the candidate-pass comparisons."""
    import gc

    Config, GpuEngine, _, _ = mods
    step = load_script("torch_profile_step")
    stages = load_script("torch_profile_stages")
    engine_prof = load_script("torch_profile_engine")
    reset_counts(ck)
    out = {}

    def say(prefix):
        return lambda msg: log(f"3f {prefix}{msg}") if msg else None

    # The stage split at B = 1,024, then at the JAX tool's B = 4,096 (its
    # candidate pass is held to the plain version first).
    split = step.profile(FULL_P, FULL_BLOCK, FULL_B, FULL_ACTIVE, iters=30,
                         threshold=100.0, device="cuda", log=say(""))
    stage_nodes_check(split, f"B={FULL_B}")
    cfg = Config.from_json(os.path.join(HERE, "configs/elo_1v1.json"),
                           backend="gpu")
    eng = GpuEngine(cfg, cfg.queues[0], device="cuda")
    audit = eng.graph_audit("dense", FULL_B)
    eng.close()
    del eng
    fold = audit["own_kernel_nodes"]["quality_accum_kernel"]
    full_nodes = split["stages"]["full"]["kernels"]
    if full_nodes + fold != audit["kernel_nodes"]:
        raise AssertionError(f"3f full graph {full_nodes} kernel nodes + the "
                             f"quality fold's {fold} != config #1's dense "
                             f"graph's {audit['kernel_nodes']}")
    log(f"3f full graph at B = {FULL_B}: {full_nodes} kernel nodes; config "
        f"#1's engine graph {audit['kernel_nodes']} (17b: 400) = the step's "
        f"{full_nodes} + the quality fold's {fold} quality_accum node")
    out["split"] = split
    out["engine_dense_kernel_nodes"] = audit["kernel_nodes"]
    wide = step.profile(FULL_P, FULL_BLOCK, 4096, FULL_ACTIVE, iters=10,
                        threshold=100.0, device="cuda", log=say("B=4096 "))
    stage_nodes_check(wide, "B=4096")
    out["split_4096"] = wide
    # The candidate pass at B = 2,048 against its plain version.
    inp = step.make_inputs(FULL_P, 2048, FULL_ACTIVE, 100.0)
    from matchmaking_tpu_torch.engine.kernels import (
        packed_now,
        pool_from_reference,
        unpack_batch,
    )
    packed = torch.from_numpy(inp["packed"]).cuda()
    batch = unpack_batch(packed)
    out["candidate_checks"] = [
        step.check_candidates(step.kernel_set(FULL_P, FULL_BLOCK),
                              pool_from_reference(inp["arrays"], "cuda"),
                              batch, batch["threshold"], packed_now(packed)),
        wide["candidate_check"]]
    log(f"3f candidate pass vs plain: {out['candidate_checks']}")
    out["check_launches"] = sum(c["launches"]
                                for c in out["candidate_checks"])
    del inp, packed, batch, wide
    gc.collect()
    torch.cuda.empty_cache()

    def mode(*argv):
        args = stages.parse_args([*argv, "--window", str(FULL_B),
                                  "--pool", str(FULL_ACTIVE)])
        res = stages.run(args)
        gc.collect()
        torch.cuda.empty_cache()
        return res

    out["device"] = mode("--mode", "device")
    out["dispatch"] = mode("--mode", "dispatch")
    out["window"] = mode("--mode", "window", "--depth", "2")
    out["prunecheck"] = mode("--mode", "prunecheck", "--prune-window-blocks",
                             "6", "--prune-chunk", "128")
    out["prunecheck_span"] = mode("--mode", "prunecheck",
                                  "--prune-window-blocks", "6",
                                  "--prune-chunk", "16")
    if out["prunecheck_span"]["path"] != "span":
        raise AssertionError("3f prunecheck at chunks of 16: the window took "
                             "the dense fallback, so dense = pruned did not "
                             "test the span path")
    out["rescanstall"] = mode("--mode", "rescanstall", "--reps", "1",
                              "--rescan-every", "10")
    out["engine"] = engine_prof.profile(FULL_B, 10, FULL_ACTIVE, FULL_P,
                                        FULL_BLOCK, "cuda")
    out["launches"] = dict(ck.LAUNCHES)
    torch.cuda.synchronize()
    return out


def stages_line(p3f):
    """Phase 3f's numbers for the ``stages`` line (device ms unless said)."""
    med = statistics.median
    split = p3f["split"]
    st = split["stages"]
    return {
        "window": split["window"], "capacity": split["capacity"],
        "active": split["active"], "iters": split["iters"],
        "stage_ms": {n: st[n]["ms"] for n in ("admit", "cands",
                                              "cands_nofilter", "pair",
                                              "evict", "full",
                                              "full_nofilter")},
        "stage_kernels": {n: st[n]["kernels"] for n in st},
        "stage_host_us": {n: st[n]["host_us"] for n in st},
        "pair_rounds": {r: {"ms": st[f"pair_r{r}"]["ms"],
                            "matches": split["matches"][r]}
                        for r in split["matches"]},
        "sum_cpe_ms": split["sum_cpe_ms"], "sum_acpe_ms": split["sum_acpe_ms"],
        "sum_acpe_nofilter_ms": split["sum_acpe_nofilter_ms"],
        "full_ms": split["full_ms"],
        "mean_candidates": split["mean_candidates"],
        "engine_dense_kernel_nodes": p3f["engine_dense_kernel_nodes"],
        "b4096": {"stage_ms": {n: s["ms"] for n, s in
                               p3f["split_4096"]["stages"].items()},
                  "matches": p3f["split_4096"]["matches"]},
        "engine_step_ms": {v: med(t) for v, t in p3f["device"]["ms"].items()},
        "dispatch_host_ms": {d: {k: med(v) for k, v in row.items()}
                             for d, row in p3f["dispatch"]["depths"].items()},
        "window_b1024_d2": dict(zip(("matches_per_s", "p50_ms", "p99_ms"),
                                    p3f["window"]["median"])),
        "prunecheck": {
            f"W{pc['window_blocks']}_chunk{pc['chunk']}": {
                "path": pc["path"], "bit_identical": pc["bit_identical"],
                "ms": {n: med(t) for n, t in pc["ms"].items()}}
            for pc in (p3f["prunecheck"], p3f["prunecheck_span"])},
        "rescanstall": p3f["rescanstall"],
        "engine_ms_per_window": p3f["engine"]["ms_per_window"],
        "launches": p3f["launches"],
        "check_launches": p3f["check_launches"],
    }


# ---- phase 4: the service ---------------------------------------------------


async def service_soak(np, ck, mods, path, *, waiting, requests, burst,
                       seed, consume_batch=True, profile_to=None,
                       observability=None, engine_over=None,
                       debug_invariants=False):
    """The service at full width: ``waiting`` players restored, then
    ``requests`` published in bursts of ``burst``. Every request is
    answered from its window once (queued or matched) and matched at most
    once, partners agree, one publish_batch per answered window, one
    block_best launch per window (each fits one chunk), and the service
    caught no failure. ``consume_batch`` (the broker's burst consume, on
    by default) off runs the per-delivery path; the codec's decode calls
    are counted: with it on, the bursts are decoded at consume and no
    window at the flush. ``profile_to``: a file that gets cProfile's
    functions by own time over the soak (the event loop's thread, which
    runs every part of the service). ``observability``: fields of the
    config's ``ObservabilityConfig`` to replace (e.g. tracing off).
    ``engine_over``: engine keys to replace (phase 18's readback groups);
    ``debug_invariants`` arms the online invariant checker. The result
    carries attribution's ms a request by category."""
    import dataclasses

    from matchmaking_tpu_torch.native import codec
    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.broker import Properties

    Config, _, RequestColumns, _ = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    cfg = dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, warm_start=True,
                                        **(engine_over or {})),
        broker=dataclasses.replace(cfg.broker, consume_batch=consume_batch),
        debug_invariants=debug_invariants)
    if observability:
        cfg = dataclasses.replace(cfg, observability=dataclasses.replace(
            cfg.observability, **observability))
    decodes = {"consume": 0, "flush": 0}
    real_decode = {"consume": codec.decode_batch_concat,
                   "flush": codec.decode_batch}

    def counted(where):
        def call(*a, **k):
            decodes[where] += 1
            return real_decode[where](*a, **k)
        return call
    rng = np.random.default_rng(seed)
    t0 = time.time()
    pop = Population(np, rng, waiting + requests, t0, filters=False,
                     glicko2=cfg.queues[0].glicko2)
    if cfg.batcher.max_batch > max(cfg.engine.batch_buckets):
        raise AssertionError("soak: a window would take several chunks")
    app = MatchmakingApp(cfg, device="cuda")
    await app.start()  # warm_start: every (variant, bucket) graph captured
    codec.decode_batch_concat = counted("consume")
    codec.decode_batch = counted("flush")
    try:
        reply = "soak.replies"
        app.broker.declare_queue(reply)
        fill = pop.columns(RequestColumns, app.engine, 0, waiting, t0, reply)
        app.restore_columns(fill, pop.region[:waiting],
                                  pop.mode[:waiting], t0)
        reset_counts(ck)  # count the soak's own windows only
        # Latency is publish → the service's response publish (the time a
        # reply is handed to the broker), recorded in the broker's
        # publish_batch, so reading the replies does not time the reader.
        calls, t_pub, first = [], {}, {}
        real = app.broker.publish_batch

        def publish_batch(items):
            calls.append(len(items))
            t = time.perf_counter()
            for _, _, props in items:
                cid = props.correlation_id
                if cid in t_pub and cid not in first:
                    first[cid] = t - t_pub[cid]
            real(items)

        app.broker.publish_batch = publish_batch
        bodies = [json.dumps({"id": pop.ids[k], "rating": float(pop.rating[k]),
                              "rating_deviation": float(pop.rd[k])}).encode()
                  for k in range(waiting, waiting + requests)]
        prof = None
        if profile_to:
            import cProfile

            prof = cProfile.Profile()
            prof.enable()
        gc_clock = GcClock().__enter__()
        t_soak = time.perf_counter()
        for b in range(0, requests, burst):
            for k in range(b, min(b + burst, requests)):
                pid = pop.ids[waiting + k]
                t_pub[pid] = time.perf_counter()
                app.broker.publish(app.queue_cfg.name, bodies[k],
                                   Properties(reply_to=reply,
                                              correlation_id=pid))
            await asyncio.sleep(0.005)
        deadline = time.monotonic() + 120.0
        while len(first) < requests and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        soak_s = time.perf_counter() - t_soak
        gc_clock.__exit__()
        if prof is not None:
            import io
            import pstats

            prof.disable()
            text = io.StringIO()
            pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(40)
            with open(profile_to, "w") as f:
                f.write(text.getvalue())
        while app.engine.inflight() and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        if len(first) != requests:
            raise AssertionError(f"soak: {requests - len(first)} requests "
                                 f"never answered")
        spans, util = app.engine.span_report(), app.engine.util_report()
    finally:
        await app.stop()
        codec.decode_batch_concat = real_decode["consume"]
        codec.decode_batch = real_decode["flush"]
    launches = ck.LAUNCHES["block_best"]
    check_faults(app, "soak")
    if (consume_batch and (decodes["flush"] or not decodes["consume"])) or (
            not consume_batch and decodes["consume"]):
        raise AssertionError(f"soak, consume_batch {consume_batch}: decode "
                             f"calls {decodes}")
    windows = app.counters["windows"]
    if launches != windows or ck.LAUNCHES["quality_accum"] != windows:
        raise AssertionError(f"soak: {ck.LAUNCHES} launches for {windows} "
                             f"windows")
    from matchmaking_tpu_torch.service.contract import decode_response
    seqs, matched = {}, {}
    while True:
        d = await app.broker.get(reply, timeout=0.2)
        if d is None:
            break
        pid = d.properties.correlation_id
        r = decode_response(d.body)
        if r.player_id != pid:
            raise AssertionError(f"soak: answer for {r.player_id} on {pid}")
        seqs.setdefault(pid, []).append(r.status)
        if r.status == "matched":
            if pid in matched:
                raise AssertionError(f"soak: {pid} matched twice")
            matched[pid] = r.match
    for pid in t_pub:
        if seqs.get(pid) not in (["matched"], ["queued"],
                                 ["queued", "matched"]):
            raise AssertionError(f"soak: {pid} answered {seqs.get(pid)}")
    for pid, m in matched.items():
        other = next(p for p in m.players if p != pid)
        if other not in matched or matched[other].match_id != m.match_id:
            raise AssertionError(f"soak: {pid}'s partner disagrees")
    if len(calls) != windows:
        raise AssertionError(f"soak: {len(calls)} publish_batch calls for "
                             f"{windows} windows")
    # The quality ledger got both players of every published match, and
    # the engine's device accumulator (read back at once) agrees.
    ledger = app.quality.snapshot()["queues"][app.queue_cfg.name]
    engine_samples = int(app.engine.quality_checkpoint()["count"].sum())
    if not (ledger["matched_players"] == len(matched) == engine_samples
            == app.counters["players_matched"]) or not matched:
        raise AssertionError(f"soak: ledger {ledger['matched_players']}, "
                             f"engine {engine_samples} quality samples for "
                             f"{len(matched)} matched players")
    lat = [v * 1e3 for v in first.values()]
    attr = app.attribution.snapshot()["queues"].get(app.queue_cfg.name, {})
    res = {"config": path, "waiting": waiting, "requests": requests,
           "burst": burst, "consume_batch": consume_batch,
           "engine_over": engine_over,
           "attribution_ms_per_request": {
               name: cat["total_s"] * 1e3 / max(1, attr["spans"])
               for name, cat in attr.get("categories", {}).items()},
           "gc_ms": gc_clock.total * 1e3,
           "decode_calls": decodes, "windows": windows, "launches": launches,
           "soak_s": soak_s,
           "requests_per_s": requests / soak_s,
           "players_matched": len(matched), "publish_batches": len(calls),
           "latency_ms_p50": statistics.median(lat),
           "latency_ms_p99": pct(lat, 0.99), "latency_ms_max": max(lat),
           "counters": dict(app.counters), "span_report": spans,
           "util_report": util, "quality_samples": engine_samples,
           "ledger": {k: ledger[k] for k in ("matched_players",)}}
    log(f"service soak {path} (consume_batch {consume_batch}): {requests} "
        f"requests over {waiting} waiting, {windows} windows, decode calls "
        f"{decodes}, GC {res['gc_ms']:.1f} ms, "
        f"{res['requests_per_s']:.0f} requests/s, "
        f"latency p50 {res['latency_ms_p50']:.2f} ms p99 "
        f"{res['latency_ms_p99']:.2f} ms")
    return res


async def service_rescan(np, ck, mods, path, *, waiting, seed):
    """Config #4's service: its rescan loop (the file's interval) must
    publish matches between players restored into the pool, every match
    must reach both players, and the service must catch no failure."""
    import dataclasses

    from matchmaking_tpu_torch.service.app import MatchmakingApp

    Config, _, RequestColumns, _ = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, warm_start=True))
    interval = cfg.queues[0].rescan_interval_s
    if interval <= 0:
        raise AssertionError(f"{path} configures no rescan")
    rng = np.random.default_rng(seed)
    t0 = time.time()
    pop = Population(np, rng, waiting, t0, filters=False, glicko2=True)
    app = MatchmakingApp(cfg, device="cuda")
    reply = "rescan.replies"
    await app.start()
    try:
        app.broker.declare_queue(reply)
        app.restore_columns(
            pop.columns(RequestColumns, app.engine, 0, waiting, t0, reply),
            pop.region, pop.mode, t0)
        reset_counts(ck)  # the rescan ticks' chunks only
        deadline = time.monotonic() + 3 * interval + 10.0
        while (app.counters["rescan_matches"] == 0
               and time.monotonic() < deadline):
            await asyncio.sleep(0.05)
    finally:
        await app.stop()
    launches = ck.LAUNCHES["block_best"]
    check_faults(app, "service rescan")
    n = 0
    while await app.broker.get(reply, timeout=0.2) is not None:
        n += 1
    m = app.counters["rescan_matches"]
    if (m == 0 or n != 2 * m or launches == 0
            or ck.LAUNCHES["quality_accum"] != launches):
        raise AssertionError(f"service rescan: {m} matches, {n} answers, "
                             f"{launches} launches")
    log(f"service rescan {path}: {m} matches published by the rescan loop, "
        f"{launches} block_best launches")
    return {"config": path, "waiting": waiting, "rescan_interval_s": interval,
            "rescan_matches": m, "answers": n, "launches": launches}


async def service_spec(ck, mods, path):
    """Config #1 bucketed (the JAX bench's geometry) with speculation on
    and no rescan loop: two players far apart (1500 and 1900) under fast
    widening (threshold 50, 400/s, capped at 2000), the geometry of the
    JAX package's own test. Only the speculation loop can match them; both
    must be answered matched by one match, and the service must catch no
    failure."""
    import dataclasses

    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.client import MatchmakingClient

    Config = mods[0]
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    cfg = dataclasses.replace(
        cfg, engine=dataclasses.replace(
            cfg.engine, warm_start=True, spec_formation=True,
            spec_interval_ms=10.0, spec_max_steps=2, spec_staleness_ms=500.0,
            **BUCKETED),
        queues=(dataclasses.replace(cfg.queues[0], rating_threshold=50.0,
                                    widen_per_sec=400.0, max_threshold=2000.0,
                                    rescan_interval_s=0.0),))
    app = MatchmakingApp(cfg, device="cuda")
    await app.start()
    try:
        reset_counts(ck)
        t = time.perf_counter()
        client = MatchmakingClient(app.broker, cfg.queues[0].name)
        a = client.submit({"id": "alice", "rating": 1500})
        b = client.submit({"id": "bob", "rating": 1900})
        first = [(await client.next_response(h, timeout=30.0)).status
                 for h in (a, b)]
        second = [await client.next_response(h, timeout=30.0) for h in (a, b)]
        wait_s = time.perf_counter() - t
        report = app.engine.spec_report()
        counters = dict(app.counters)
    finally:
        await app.stop()
    check_faults(app, "service speculation")
    if (first != ["queued", "queued"]
            or [r.status for r in second] != ["matched", "matched"]
            or second[0].match.match_id != second[1].match.match_id
            or counters["rescan_matches"] != 1 or counters["spec_commits"] == 0
            or report["spec_hit"] == 0):
        raise AssertionError(f"service speculation: {first}, "
                             f"{[r.status for r in second]}, {counters}, "
                             f"{report}")
    launches = dict(ck.LAUNCHES)
    if launches["block_best"] == 0 or launches["quality_accum"] == 0:
        raise AssertionError(f"service speculation: launches {launches}")
    log(f"service speculation {path} (bucketed): both players matched by the "
        f"speculation loop alone in {wait_s:.3f} s; {counters['spec_commits']} "
        f"commits, counters {report}, launches {launches}")
    return {"config": path, "engine_over": BUCKETED, "matched_after_s": wait_s,
            "spec_commits": counters["spec_commits"], "counters": report,
            "launches": launches["block_best"],
            "quality_launches": launches["quality_accum"]}


# ---- phase 5: team and role queues (configs #3 and #5) ------------------------


#: Region and mode values of the team phases: every request pins both (a
#: wildcard would hand the queue to the host oracle).
TEAM_REGIONS = ("eu", "na", "apac")
TEAM_MODES = ("ranked", "casual")
ROLE_NAMES = ("tank", "healer", "dps")


class TeamPopulation:
    """Seeded solo players, row k = player ``t<k>``: ratings N(1500, 300),
    waits U(0, 20) s, region from 3 values and mode from 2, all pinned;
    with ``roles``, 70 % one role (tank 20 %, healer 20 %, dps 60 %), 20 %
    two roles, 10 % none (eligible for every slot)."""

    def __init__(self, np, rng, n, *, roles, prefix="t"):
        self.rating = rng.normal(1500.0, 300.0, n).astype(np.float32)
        self.waited = rng.uniform(0.0, 20.0, n)
        self.region = np.array(TEAM_REGIONS, object)[rng.integers(0, 3, n)]
        self.mode = np.array(TEAM_MODES, object)[rng.integers(0, 2, n)]
        self.roles = [()] * n
        if roles:
            kind = rng.random(n)
            one = rng.choice(3, n, p=[0.2, 0.2, 0.6])
            two = rng.integers(0, 3, n)
            for k in range(n):
                if kind[k] < 0.7:
                    self.roles[k] = (ROLE_NAMES[one[k]],)
                elif kind[k] < 0.9:
                    self.roles[k] = tuple(r for j, r in enumerate(ROLE_NAMES)
                                          if j != two[k])
        self.ids = [f"{prefix}{k}" for k in range(n)]
        self.row = {pid: k for k, pid in enumerate(self.ids)}

    def requests(self, SearchRequest, lo, hi, now, reply=""):
        return [SearchRequest(id=self.ids[k], rating=float(self.rating[k]),
                              region=self.region[k], game_mode=self.mode[k],
                              roles=self.roles[k], reply_to=reply,
                              correlation_id=self.ids[k],
                              enqueued_at=now - float(self.waited[k]))
                for k in range(lo, hi)]


def _perfect_assignment(itertools, team, slots):
    """Brute force: some member → slot bijection where every member may
    play its slot (no declared roles: any slot)."""
    return any(all(not m.roles or slots[s] in m.roles
                   for m, s in zip(team, perm))
               for perm in itertools.permutations(range(len(slots))))


def check_team_outcome(np, queue, out, now, seen, window=None):
    """The invariants of one collected team/role SearchOutcome: nobody in
    two matches, two teams of ``team_size``, one (region, mode) per match,
    spread ≤ every member's effective threshold, |sum_A − sum_B| ≤ spread,
    quality in [0, 1], a perfect role assignment per team (role queues),
    and (traffic windows) every request matched, queued or rejected."""
    import itertools

    k = queue.team_size
    for m in out.matches:
        members = m.requests()
        ids = [r.id for r in members]
        if len(set(ids)) != 2 * k or any(p in seen for p in ids):
            raise AssertionError(f"match {m.match_id}: a player twice")
        seen.update(ids)
        if [len(t) for t in m.teams] != [k, k]:
            raise AssertionError(f"match {m.match_id}: teams {m.teams}")
        if len({(r.region, r.game_mode) for r in members}) != 1:
            raise AssertionError(f"match {m.match_id}: mixed region/mode")
        ratings = [np.float32(r.rating) for r in members]
        spread = float(max(ratings) - min(ratings))
        for r in members:
            base = (r.rating_threshold if r.rating_threshold is not None
                    else queue.rating_threshold)
            eff = (min(queue.max_threshold, base + queue.widen_per_sec
                       * max(0.0, now - r.enqueued_at))
                   if queue.widen_per_sec > 0 else base)
            if spread > eff + 1e-3:
                raise AssertionError(f"match {m.match_id}: spread {spread} "
                                     f"> {r.id}'s threshold {eff}")
        diff = abs(sum(r.rating for r in m.teams[0])
                   - sum(r.rating for r in m.teams[1]))
        if not queue.role_slots and diff > spread + 1e-3:
            raise AssertionError(f"match {m.match_id}: team sums differ by "
                                 f"{diff} > spread {spread}")
        if not 0.0 <= m.quality <= 1.0:
            raise AssertionError(f"match {m.match_id}: quality {m.quality}")
        if queue.role_slots:
            for team in m.teams:
                if not _perfect_assignment(itertools, team, queue.role_slots):
                    raise AssertionError(f"match {m.match_id}: a team "
                                         f"cannot fill its role slots")
    if window is not None:
        done = ({r.id for r in out.queued} | seen
                | {r.id for r, _ in out.rejected})
        if any(r.id not in done for r in window):
            raise AssertionError("a request was neither matched, queued "
                                 "nor rejected")
    return len(out.matches)


def record_raw(eng):
    """Keep a copy of each finalized window's raw step results (slots,
    spread, limit, split) on the engine instance: the CPU comparison reads
    them. No device work."""
    raws = []
    finalize = eng._finalize_team

    def recording(pending):
        raws.append([r.copy() for r in pending.raw or ()])
        finalize(pending)

    eng._finalize_team = recording
    return raws


def step_bound(np, ks, batch, out_elems):
    """Least time for one team/role step call: the bytes it must move (the
    pool's columns read once, the packed window read once, the admitted
    lanes' columns and the matched slots' ``active`` written once, the
    result f32[rows, max_matches] written once) over the memory rate, or
    its operations (the two stable sorts' P·log2(P) compares each and one
    compare-select per slot per selection round) over the FP32 peak."""
    slot_bytes = 25 + 4 * len(ks.extra_pool_fields)  # 6 x 4-byte + bool
    nbytes = (ks.capacity * slot_bytes + ks.pack_rows * batch * 4
              + batch * slot_bytes + ks.need * ks.max_matches
              + out_elems * 4)
    p = ks.capacity
    ops = 2 * p * int(np.log2(p)) + ks.rounds * p
    return roofline({}, ops, nbytes)


def step_profile(torch, np, ks, src_pool, batch, now, reps=10):
    """The team/role step alone at full width, on fresh copies of
    ``src_pool`` and one window of ``batch`` arrivals into free slots:
    kernels and device ms per call (torch.profiler), CUDA-event ms (median
    of ``reps``), host ms per call, and the bound (``step_bound``)."""
    from torch.profiler import ProfilerActivity, profile

    from matchmaking_tpu_torch.engine.kernels import DevicePool

    active = src_pool["active"].cpu().numpy()
    free = np.nonzero(~active)[0]
    rng = np.random.default_rng(0)
    n = min(batch, free.size)
    packed = np.zeros((ks.pack_rows, batch), np.float32)
    packed[0] = ks.capacity
    packed[0, :n] = free[:n]
    packed[1, :n] = rng.normal(1500.0, 300.0, n)
    packed[3, :n] = rng.integers(1, 4, n)
    packed[4, :n] = rng.integers(1, 3, n)
    packed[5, :n] = 120.0
    packed[6, :n] = now
    packed[7, :n] = 1.0
    if ks.is_role:
        packed[8, :n] = rng.integers(1, 8, n)
    packed[-1] = now
    packed = torch.from_numpy(packed).cuda()
    copies = [DevicePool({k: t.clone() for k, t in src_pool.full.items()})
              for _ in range(3 * reps + 6)]
    torch.cuda.synchronize()
    step = lambda: ks.search_step_packed(copies.pop(), packed)
    out_elems = step().numel()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    kernels = device_us = 0.0
    for e in device_work(prof):
        kernels += e.count
        device_us += getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
    ms = time_ms(torch, step, reps=reps - 3)
    t = time.perf_counter()
    for _ in range(3):
        step()
    host_ms = (time.perf_counter() - t) / 3 * 1e3
    torch.cuda.synchronize()
    return {"launches": kernels / reps, "device_ms": device_us / reps / 1e3,
            "ms": ms, "host_ms": host_ms, "pool": int(active.sum()),
            "batch": batch, **step_bound(np, ks, batch, out_elems)}


def run_team(torch, np, mods, path, *, waiting, windows, profile_windows,
             cpu_windows, seed, roles):
    """A team (config #3) or role (config #5) queue at full width on the
    card: ``waiting`` solo players restored, then ``windows`` object windows
    of 1,024 through ``search_async`` at the config's pipeline depth
    (dispatches under set_sync_debug_mode("error")), collected with
    ``collect_ready`` and ``flush``; every match checked; the first
    ``cpu_windows`` windows' raw step results (slots, spread, limit, split)
    bit-equal to the same engine's on the CPU; ``profile_windows`` more
    under torch.profiler; the step alone profiled and timed."""
    Config, GpuEngine, _, SearchRequest = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    queue, depth = cfg.queues[0], cfg.engine.pipeline_depth
    n_all = waiting + (windows + profile_windows) * FULL_B
    pop = TeamPopulation(np, np.random.default_rng(seed), n_all, roles=roles)
    t0 = 1_700_000_000.0
    now_of = [t0 + 1.0 + 0.05 * w for w in range(windows + profile_windows)]
    stream = [pop.requests(SearchRequest, waiting + w * FULL_B,
                           waiting + (w + 1) * FULL_B, now_of[w])
              for w in range(windows + profile_windows)]
    fill = pop.requests(SearchRequest, 0, waiting, t0)
    eng = GpuEngine(cfg, queue, device="cuda")
    eng.warmup()
    graphs = graph_summary(eng.graph_report())
    raws = record_raw(eng)
    torch.cuda.synchronize()
    t = time.perf_counter()
    with no_sync(torch):
        eng.restore(fill, t0)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    if eng.pool_size() != waiting:
        raise AssertionError(f"restore left {eng.pool_size()} != {waiting}")
    steps = step_profile(torch, np, eng.kernels, eng.dev_pool, FULL_B, 1.0)
    spans0 = dict(eng.spans)
    dispatch_ms, turnaround_ms, matches_per_window = [], [], []
    outs, t_disp, token_window = {}, {}, {}
    t_run = time.perf_counter()
    for w in range(windows):
        t = time.perf_counter()
        with no_sync(torch):
            tok, _ = eng.search_async(stream[w], now_of[w])
        dispatch_ms.append((time.perf_counter() - t) * 1e3)
        t_disp[tok], token_window[tok] = t, w
        if w == 1:
            # Windows 0 and 1 are collected together, so the CPU engine
            # below sees the same pool (and free list) at each dispatch.
            torch.cuda.synchronize()
        while eng.inflight() >= depth:
            for tok_c, out in eng.collect_ready():
                turnaround_ms.append((time.perf_counter() - t_disp[tok_c]) * 1e3)
                outs[token_window[tok_c]] = out
    for tok_c, out in eng.flush():
        turnaround_ms.append((time.perf_counter() - t_disp[tok_c]) * 1e3)
        outs[token_window[tok_c]] = out
    run_s = time.perf_counter() - t_run
    spans = {k: (v - spans0[k]) for k, v in eng.spans.items()}
    seen, matches, admitted = set(), 0, 0
    for w in range(windows):
        n = check_team_outcome(np, queue, outs[w], now_of[w], seen,
                               window=stream[w])
        matches_per_window.append(n)
        matches += n
        admitted += len(stream[w]) - len(outs[w].rejected)
    if eng.pool_size() != waiting + admitted - 2 * queue.team_size * matches:
        raise AssertionError(f"pool_size {eng.pool_size()} != {waiting} + "
                             f"{admitted} - {2 * queue.team_size} x {matches}")
    if eng.counters.get("team_delegated", 0) != 0:
        raise AssertionError(f"a device phase delegated: {eng.counters}")
    # The rescan tick after widening (config #3 widens 2/s): formation
    # over the waiting pool alone, with thresholds 30 s wider.
    rescan = None
    if queue.widen_per_sec > 0:
        left = eng.pool_size()
        now_r = now_of[windows - 1] + 30.0
        tok = eng.rescan_async(FULL_B, now_r)
        (tok_r, out_r), = eng.flush()
        if tok_r != tok or tok not in eng.rescan_tokens:
            raise AssertionError("rescan: token mismatch")
        eng.rescan_tokens.discard(tok)
        n_r = check_team_outcome(np, queue, out_r, now_r, seen)
        if n_r == 0:
            raise AssertionError("the team rescan tick formed no match")
        if eng.pool_size() != left - 2 * queue.team_size * n_r:
            raise AssertionError("rescan: pool accounting")
        rescan = {"waiting_before": left, "matches": n_r,
                  "waiting_after": eng.pool_size()}
    # Quality: no device accumulator on the team steps; each finalized match
    # adds one host sample per member.
    need = 2 * queue.team_size
    formed = matches + (rescan["matches"] if rescan else 0)
    samples = eng.quality_report()["samples"]
    if samples != need * formed or eng._quality is not None:
        raise AssertionError(f"{path}: {samples} quality samples for "
                             f"{formed} matches of {need}")
    # The same first windows on the CPU (windows 0 and 1 dispatched before
    # any collection, as on the card): raw results bit-equal.
    cpu = GpuEngine(cfg, queue, device="cpu")
    cpu_raws = record_raw(cpu)
    cpu.restore(pop.requests(SearchRequest, 0, waiting, t0), t0)
    for w in range(cpu_windows):
        cpu.search_async(pop.requests(SearchRequest, waiting + w * FULL_B,
                                      waiting + (w + 1) * FULL_B, now_of[w]),
                         now_of[w])
        if w >= 1:
            cpu.flush()
    for w in range(cpu_windows):
        for got, want in zip(raws[w], cpu_raws[w]):
            if not np.array_equal(got.view(np.int32), want.view(np.int32)):
                raise AssertionError(f"{path} window {w}: the CPU step's "
                                     f"slots/spread/limit differ")
    # Device time and kernels per window over further windows.
    def run():
        for w in range(windows, windows + profile_windows):
            eng.search_async(stream[w], now_of[w])
            while eng.inflight() >= depth:
                eng.collect_ready()
        eng.flush()
        return profile_windows
    prof = device_busy(torch, run)
    check_own_kernels(prof, 0, f"{path} profile")
    res = {
        "config": path, "waiting": waiting, "windows": windows,
        "window": FULL_B, "pipeline_depth": depth, "matches": matches,
        "matches_per_window": matches_per_window,
        "team_delegated": eng.counters.get("team_delegated", 0),
        "pool_size_end": eng.pool_size(), "restore_s": restore_s,
        "dispatch_ms_p50": statistics.median(dispatch_ms),
        "dispatch_ms_p99": pct(dispatch_ms, 0.99),
        "turnaround_ms_p50": statistics.median(turnaround_ms),
        "turnaround_ms_p99": pct(turnaround_ms, 0.99),
        "requests_per_s": windows * FULL_B / run_s, "run_s": run_s,
        "finalize_ms_per_window": spans["finalize_s"] / windows * 1e3,
        "step_queue_ms_per_window": spans["step_s"] / windows * 1e3,
        "split_ms_per_window": {k[:-2] + "_ms": v / windows * 1e3
                                for k, v in spans.items() if k.endswith("_s")},
        "cpu_windows_equal": cpu_windows, "rescan": rescan,
        "profile": prof, "step": steps, "quality_samples": samples,
        "graphs": graphs,
    }
    if eng.graph_report()["captures"] != graphs["captures"]:
        raise AssertionError(f"{path}: a window captured a graph again")
    log(f"team {path}: {matches} matches in {windows} windows "
        f"(per window {matches_per_window}), dispatch p50/p99 "
        f"{res['dispatch_ms_p50']:.2f}/{res['dispatch_ms_p99']:.2f} ms, "
        f"turnaround p50/p99 {res['turnaround_ms_p50']:.2f}/"
        f"{res['turnaround_ms_p99']:.2f} ms, {res['requests_per_s']:.0f} "
        f"requests/s, finalize {res['finalize_ms_per_window']:.2f} ms a "
        f"window, team_delegated 0; profile: {prof['kernels_per_window']:.0f} "
        f"kernels ({prof['queued_per_window']:.1f} launches queued) and "
        f"{prof['device_ms_per_window']:.3f} device ms a window, "
        f"busy {prof['device_busy_share']:.3f}; step alone: {steps}; rescan "
        f"{rescan}; {samples} quality samples; graphs {graphs}")
    return res


def role_delegation(torch, np, mods, path, *, waiting, seed):
    """Config #5's hand-over on a small pool: ``waiting`` solo players on
    the card, then a 3-player party arrives: the queue moves to the host
    oracle, which serves the party; the party expires (its deadline), the
    5 s quiet period passes, and the queue moves back onto the card, whose
    next window runs the device step."""
    Config, GpuEngine, _, SearchRequest = mods
    from matchmaking_tpu_torch.service.contract import PartyMember

    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    queue = cfg.queues[0]
    pop = TeamPopulation(np, np.random.default_rng(seed), waiting + 64,
                         roles=True, prefix="d")
    t0 = 1_700_000_000.0
    eng = GpuEngine(cfg, queue, device="cuda")
    eng.warmup()
    eng.restore(pop.requests(SearchRequest, 0, waiting, t0), t0)
    party = SearchRequest(
        id="party", rating=-4000.0, region="eu", game_mode="ranked",
        roles=("tank",), enqueued_at=t0 + 1.0, deadline_at=t0 + 3.0,
        party=(PartyMember("party2", -4000.0, roles=("healer",)),
               PartyMember("party3", -4000.0, roles=("dps",))))
    t = time.perf_counter()
    out = eng.search([party], t0 + 1.0)
    oracle_ms = (time.perf_counter() - t) * 1e3
    if eng.counters != {"team_delegated": 1} or eng.dev_pool is not None:
        raise AssertionError(f"the party did not hand the queue over: "
                             f"{eng.counters}")
    if [r.id for r in out.queued] != ["party"]:
        raise AssertionError("the oracle did not serve the party")
    # After a restore the oracle scans the whole pool: it may match
    # restored players in the same window.
    check_team_outcome(np, queue, out, t0 + 1.0, set())
    oracle_matches = len(out.matches)
    if eng.pool_size() != waiting + 1 - 2 * queue.team_size * oracle_matches:
        raise AssertionError("delegation lost waiting players")
    left = eng.pool_size() - 1
    expired = eng.expire_deadlines(t0 + 7.0)  # past the deadline and quiet
    if [r.id for r in expired] != ["party"]:
        raise AssertionError(f"the party did not expire: {expired}")
    if eng.counters != {"team_delegated": 1, "team_repromoted": 1}:
        raise AssertionError(f"not back on the card: {eng.counters}")
    if eng.dev_pool is None or eng.pool_size() != left:
        raise AssertionError("re-promotion lost waiting players")
    torch.cuda.synchronize()
    with no_sync(torch):
        tok, _ = eng.search_async(pop.requests(
            SearchRequest, waiting, waiting + 64, t0 + 8.0), t0 + 8.0)
    (tok_o, out), = eng.flush()
    check_team_outcome(np, queue, out, t0 + 8.0, set())
    res = {"waiting": waiting, "counters": dict(eng.counters),
           "oracle_window_ms": oracle_ms, "oracle_matches": oracle_matches,
           "device_window_after": {"matches": len(out.matches),
                                   "queued": len(out.queued)}}
    log(f"role delegation {path}: {res}")
    return res


async def service_role_health(np, mods, path, *, waiting, seed):
    """Config #5's hand-over through the service, on the card: ``waiting``
    players restored, then a 2-player party with an ``x-deadline`` 0.5 s
    out hands the queue to the host oracle; the deadline sweep answers it
    ``timeout``, after which no traffic is sent, so only the health timer
    (the file's ``health_interval_s``, the default 1 s) can move the queue
    back onto the card once the quiet period (cut from 5 s to 1 s on this
    engine, to keep the smoke short) has passed. Then 64 pinned arrivals
    are answered by the device step."""
    import dataclasses

    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.broker import Properties
    from matchmaking_tpu_torch.service.contract import decode_response

    Config, _, _, SearchRequest = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    cfg = dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, warm_start=True),
        overload=dataclasses.replace(cfg.overload, deadline_sweep_ms=20.0))
    interval, quiet = cfg.engine.health_interval_s, 1.0
    if interval <= 0 or cfg.queues[0].rescan_interval_s > 0:
        raise AssertionError(f"{path}: the health timer must be the only "
                             f"ticker")
    pop = TeamPopulation(np, np.random.default_rng(seed), waiting + 64,
                         roles=True, prefix="h")
    app = MatchmakingApp(cfg, device="cuda")
    await app.start()
    reply = "health.replies"
    try:
        app.broker.declare_queue(reply)
        eng = app.engine
        eng.TEAM_REPROMOTE_QUIET_S = quiet
        t0 = time.time()
        app.restore(pop.requests(SearchRequest, 0, waiting, t0, reply), t0)
        t_arrival = time.time()
        app.broker.publish(app.queue_cfg.name, json.dumps({
            "id": "party", "rating": -4000.0, "region": "eu",
            "game_mode": "ranked", "roles": ["tank"],
            "party": [{"id": "party2", "rating": -4000.0,
                       "roles": ["healer"]}]}).encode(),
            Properties(reply_to=reply, correlation_id="party",
                       headers={"x-deadline": repr(t_arrival + 0.5)}))
        statuses = []
        deadline = time.monotonic() + 30.0
        while "timeout" not in statuses and time.monotonic() < deadline:
            d = await app.broker.get(reply, timeout=0.05)
            if d is not None and d.properties.correlation_id == "party":
                statuses.append(decode_response(d.body).status)
        if statuses != ["queued", "timeout"] or eng.dev_pool is not None:
            raise AssertionError(f"role health: the party got {statuses}, "
                                 f"engine counters {eng.counters}")
        while (not eng.counters.get("team_repromoted")
               and time.monotonic() < deadline):
            await asyncio.sleep(0.005)
        t_back = time.time()
        if (eng.counters != {"team_delegated": 1, "team_repromoted": 1}
                or app.counters["health_repromotions"] < 1
                or eng.dev_pool is None):
            raise AssertionError(f"role health: not back on the card by the "
                                 f"health timer: {eng.counters}, "
                                 f"{app.counters}")
        late_s = t_back - (t_arrival + quiet)
        if late_s > interval + 0.5:
            raise AssertionError(f"role health: back {late_s:.3f} s after "
                                 f"the quiet period, interval {interval} s")
        left = eng.pool_size()
        ids = pop.ids[waiting:]
        for k in range(waiting, waiting + 64):
            app.broker.publish(app.queue_cfg.name, json.dumps({
                "id": pop.ids[k], "rating": float(pop.rating[k]),
                "region": pop.region[k], "game_mode": pop.mode[k],
                "roles": list(pop.roles[k])}).encode(),
                Properties(reply_to=reply, correlation_id=pop.ids[k]))
        got = {}
        while len(got) < 64 and time.monotonic() < deadline:
            d = await app.broker.get(reply, timeout=0.05)
            if d is not None and d.properties.correlation_id in ids:
                got.setdefault(d.properties.correlation_id, decode_response(
                    d.body).status)
        while app.engine.inflight() and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        if len(got) != 64 or eng.counters["team_delegated"] != 1:
            raise AssertionError(f"role health: {len(got)} of 64 arrivals "
                                 f"answered, counters {eng.counters}")
    finally:
        await app.stop()
    check_faults(app, "role health")
    res = {"config": path, "waiting": waiting, "health_interval_s": interval,
           "quiet_s": quiet, "repromoted_after_quiet_s": late_s,
           "pool_after": left, "counters": dict(eng.counters),
           "health_repromotions": app.counters["health_repromotions"],
           "arrivals_after": {s: list(got.values()).count(s)
                              for s in set(got.values())}}
    log(f"role health {path}: {res}")
    return res


async def service_multiqueue(np, ck, mods, path, *, waiting, requests, burst,
                             seed):
    """Config #2's service on the card: both queues (ranked at threshold
    75, casual at 150) served by one app, each with ``waiting`` players
    restored and ``requests`` published in bursts of ``burst`` (regions and
    modes drawn with wildcards). Every request is answered from its window
    once (queued or matched) and matched at most once, within its queue's
    threshold and filters, by a partner from its own queue; each queue gets
    one publish_batch per window; one block_best and one quality_accum
    launch per window. A probe pair 100 apart, far from everyone, is
    matched on casual and left waiting on ranked; a ranked and a casual
    player 10 apart are both left waiting."""
    import dataclasses

    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.broker import Properties
    from matchmaking_tpu_torch.service.contract import decode_response

    Config, _, RequestColumns, _ = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, warm_start=True))
    names = [q.name for q in cfg.queues]
    thr = {q.name: q.rating_threshold for q in cfg.queues}
    if len(names) != 2 or thr[names[0]] == thr[names[1]]:
        raise AssertionError(f"{path}: expected two queues, two thresholds")
    rng = np.random.default_rng(seed)
    t0 = time.time()
    pops, reply = {}, {}
    app = MatchmakingApp(cfg, device="cuda")
    await app.start()
    try:
        for name, prefix in zip(names, "rc"):
            pop = pops[name] = Population(np, rng, waiting + requests, t0,
                                          filters=True, glicko2=False)
            pop.ids = np.char.add(prefix, np.arange(waiting + requests)
                                  .astype(str)).astype(object)
            reply[name] = f"mq.{prefix}.replies"
            app.broker.declare_queue(reply[name])
            eng = app.runtime(name).engine
            app.restore_columns(pop.columns(RequestColumns, eng, 0, waiting, t0,
                                            reply[name]),
                                pop.region[:waiting], pop.mode[:waiting], t0,
                                queue=name)
        reset_counts(ck)  # the service's own windows only
        calls = {name: 0 for name in names}
        queue_of_reply = {v: k for k, v in reply.items()}
        real = app.broker.publish_batch

        def publish_batch(items):
            # Every row of a runtime's batch goes to its queue's replies.
            calls[queue_of_reply[items[0][0]]] += 1
            if len({r for r, _, _ in items}) != 1:
                raise AssertionError("a publish_batch mixed the queues")
            real(items)

        app.broker.publish_batch = publish_batch
        low, high = min(names, key=thr.get), max(names, key=thr.get)
        probes = {(low, "lowA", 6000.0), (high, "highA", 6000.0),
                  (low, "crossA", 8000.0)}
        probes_late = {(low, "lowB", 6100.0), (high, "highB", 6100.0),
                       (high, "crossB", 8010.0)}

        def publish(name, pid, body):
            app.broker.publish(name, json.dumps(body).encode(),
                               Properties(reply_to=reply[name],
                                          correlation_id=pid))

        for name, pid, r in sorted(probes):
            publish(name, pid, {"id": pid, "rating": r})
        t_soak = time.perf_counter()
        for b in range(0, requests, burst):
            for name in names:
                pop = pops[name]
                for k in range(waiting + b, waiting + min(b + burst, requests)):
                    body = {"id": pop.ids[k], "rating": float(pop.rating[k])}
                    if pop.region[k] != "*":
                        body["region"] = pop.region[k]
                    if pop.mode[k] != "*":
                        body["game_mode"] = pop.mode[k]
                    publish(name, pop.ids[k], body)
            await asyncio.sleep(0.005)
        for name, pid, r in sorted(probes_late):
            publish(name, pid, {"id": pid, "rating": r})
        answers = {name: {} for name in names}
        want = {name: set(pops[name].ids[waiting:].tolist())
                | {pid for n, pid, _ in probes | probes_late if n == name}
                for name in names}
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            busy = False
            for name in names:
                d = await app.broker.get(reply[name], timeout=0.01)
                if d is not None:
                    busy = True
                    answers[name].setdefault(d.properties.correlation_id,
                                             []).append(decode_response(d.body))
            if (not busy and all(want[n] <= answers[n].keys() for n in names)
                    and not any(app.runtime(n).engine.inflight()
                                for n in names)):
                break
        soak_s = time.perf_counter() - t_soak
        while True:  # late matches of queued players
            got_any = False
            for name in names:
                d = await app.broker.get(reply[name], timeout=0.2)
                if d is not None:
                    got_any = True
                    answers[name].setdefault(d.properties.correlation_id,
                                             []).append(decode_response(d.body))
            if not got_any:
                break
    finally:
        await app.stop()
    check_faults(app, "multiqueue service")
    windows = {n: app.runtime(n).counters["windows"] for n in names}
    total = sum(windows.values())
    if (ck.LAUNCHES["block_best"] != total
            or ck.LAUNCHES["quality_accum"] != total):
        raise AssertionError(f"multiqueue service: {ck.LAUNCHES} launches for "
                             f"{total} windows")
    if calls != windows:
        raise AssertionError(f"multiqueue service: publish_batch calls "
                             f"{calls} for windows {windows}")
    res = {"config": path, "waiting": waiting, "requests": requests,
           "burst": burst, "windows": windows, "launches": total,
           "soak_s": soak_s, "requests_per_s": 2 * requests / soak_s,
           "players_matched": {}}
    for name in names:
        pop, got = pops[name], answers[name]
        row = {pid: k for k, pid in enumerate(pop.ids.tolist())}
        rating = {pid: float(pop.rating[k]) for pid, k in row.items()}
        rating.update({pid: r for n, pid, r in probes | probes_late
                       if n == name})
        published = set(pop.ids[waiting:].tolist()) | {
            pid for n, pid, _ in probes | probes_late if n == name}
        matched = {}
        for pid, rs in got.items():
            seq = [r.status for r in rs]
            # A restored player gets its match only; a published one its
            # window's answer first.
            if seq not in ((["matched"], ["queued"], ["queued", "matched"])
                           if pid in published else (["matched"],)):
                raise AssertionError(f"{name}: {pid} answered {seq}")
            if seq[-1] == "matched":
                matched[pid] = rs[-1].match
        if len(published & set(got)) != requests + 3:
            raise AssertionError(f"{name}: {len(published & set(got))} of "
                                 f"{requests + 3} requests answered")
        for pid, m in matched.items():
            other = next(p for p in m.players if p != pid)
            if other not in rating:
                raise AssertionError(f"{name}: {pid} matched {other}, who is "
                                     f"not on this queue")
            if abs(rating[pid] - rating[other]) > thr[name]:
                raise AssertionError(f"{name}: {pid} and {other} are "
                                     f"{abs(rating[pid] - rating[other])} "
                                     f"apart, threshold {thr[name]}")
            if pid in row and other in row:
                a, b = row[pid], row[other]
                for col in (pop.region, pop.mode):
                    if "*" not in (col[a], col[b]) and col[a] != col[b]:
                        raise AssertionError(f"{name}: {pid} and {other} "
                                             f"fail a filter")
            if other in matched and matched[other].match_id != m.match_id:
                raise AssertionError(f"{name}: {pid}'s partner disagrees")
        res["players_matched"][name] = len(matched)
        probe_status = {pid: got[pid][-1].status
                        for n, pid, _ in probes | probes_late if n == name}
        res.setdefault("probes", {}).update(probe_status)
    want_probes = {"lowA": "queued", "lowB": "queued", "highA": "matched",
                   "highB": "matched", "crossA": "queued", "crossB": "queued"}
    if res["probes"] != want_probes:
        raise AssertionError(f"multiqueue service: probes {res['probes']}, "
                             f"expected {want_probes}")
    log(f"multiqueue service {path}: {res}")
    return res


async def service_team(np, mods, path, *, waiting, requests, burst, seed,
                       interval_s=0.0):
    """Config #3's service on the card: ``waiting`` players restored
    through the app, then ``requests`` published in bursts of ``burst``,
    5 ms apart, or with ``interval_s`` burst k at k x ``interval_s`` after
    the first (a fixed offered load; scripts/torch_service_ab.py). Every request is
    answered from its window (queued, then at most one matched; or
    matched), every matched answer carries two teams of five whose members
    agree on the match, and the service caught no failure. Unpaced, the
    publisher shares the event loop with the service, so the load offered
    (``offered_per_s``) grows as the service frees the loop sooner."""
    import dataclasses

    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.broker import Properties
    from matchmaking_tpu_torch.service.contract import decode_response

    Config, _, _, SearchRequest = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, warm_start=True))
    k = cfg.queues[0].team_size
    pop = TeamPopulation(np, np.random.default_rng(seed), waiting + requests,
                         roles=False, prefix="s")
    app = MatchmakingApp(cfg, device="cuda")
    await app.start()
    reply = "team.replies"
    try:
        app.broker.declare_queue(reply)
        t0 = time.time()
        app.restore(pop.requests(SearchRequest, 0, waiting, t0, reply), t0)
        calls, t_pub, first = [], {}, {}
        real = app.broker.publish_batch

        def publish_batch(items):
            calls.append(len(items))
            t = time.perf_counter()
            for _, _, props in items:
                cid = props.correlation_id
                if cid in t_pub and cid not in first:
                    first[cid] = t - t_pub[cid]
            real(items)

        app.broker.publish_batch = publish_batch
        bodies = [json.dumps({"id": pop.ids[j], "rating": float(pop.rating[j]),
                              "region": pop.region[j],
                              "game_mode": pop.mode[j]}).encode()
                  for j in range(waiting, waiting + requests)]
        gc_clock = GcClock().__enter__()
        t_soak = time.perf_counter()
        for n, b in enumerate(range(0, requests, burst)):
            if n:
                await asyncio.sleep(max(0.0, t_soak + n * interval_s
                                        - time.perf_counter())
                                    if interval_s else 0.005)
            for j in range(b, min(b + burst, requests)):
                pid = pop.ids[waiting + j]
                t_pub[pid] = time.perf_counter()
                app.broker.publish(app.queue_cfg.name, bodies[j],
                                   Properties(reply_to=reply,
                                              correlation_id=pid))
        publish_s = time.perf_counter() - t_soak
        deadline = time.monotonic() + 120.0
        while len(first) < requests and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        soak_s = time.perf_counter() - t_soak
        gc_clock.__exit__()
        while app.engine.inflight() and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        if len(first) != requests:
            raise AssertionError(f"team service: {requests - len(first)} "
                                 f"requests never answered")
        counters = dict(app.engine.counters)
        spans = app.engine.span_report()
    finally:
        await app.stop()
    check_faults(app, "team service")
    if counters.get("team_delegated", 0):
        raise AssertionError(f"team service delegated: {counters}")
    seqs, matched = {}, {}
    while True:
        d = await app.broker.get(reply, timeout=0.2)
        if d is None:
            break
        pid = d.properties.correlation_id
        r = decode_response(d.body)
        if r.player_id != pid:
            raise AssertionError(f"team service: answer for {r.player_id} "
                                 f"on {pid}")
        seqs.setdefault(pid, []).append(r.status)
        if r.status == "matched":
            if pid in matched:
                raise AssertionError(f"team service: {pid} matched twice")
            if [len(t) for t in r.match.teams] != [k, k]:
                raise AssertionError(f"team service: teams {r.match.teams}")
            matched[pid] = r.match
    for pid in t_pub:
        if seqs.get(pid) not in (["matched"], ["queued"],
                                 ["queued", "matched"]):
            raise AssertionError(f"team service: {pid} answered "
                                 f"{seqs.get(pid)}")
    for pid, m in matched.items():
        for other in m.players:
            if other in matched and matched[other].match_id != m.match_id:
                raise AssertionError(f"team service: {pid} and {other} "
                                     f"disagree on their match")
    lat = [v * 1e3 for v in first.values()]
    res = {"config": path, "waiting": waiting, "requests": requests,
           "burst": burst,
           "gc_ms": gc_clock.total * 1e3, "windows": app.counters["windows"],
           "publish_batches": len(calls), "soak_s": soak_s,
           "interval_s": interval_s, "publish_s": publish_s,
           "offered_per_s": requests / publish_s,
           "requests_per_s": requests / soak_s,
           "players_matched": app.counters["players_matched"],
           "latency_ms_p50": statistics.median(lat),
           "latency_ms_p99": pct(lat, 0.99), "latency_ms_max": max(lat),
           "span_report": spans}
    log(f"team service {path}: {requests} requests over {waiting} waiting, "
        f"{res['windows']} windows, offered {res['offered_per_s']:.0f} and "
        f"served {res['requests_per_s']:.0f} requests/s, "
        f"latency p50 {res['latency_ms_p50']:.2f} ms p99 "
        f"{res['latency_ms_p99']:.2f} ms, {res['players_matched']} players "
        f"matched, GC {res['gc_ms']:.1f} ms")
    return res


# ---- phase 6: overload control -------------------------------------------


def scenario_cohorts(name="mixed-tier-peak"):
    """A committed scenario's cohorts, read through the port's
    ``load_scenario``: (name, share, tier, rating mean, rating sigma,
    deadline in s or None)."""
    from matchmaking_tpu_torch.scenario import load_scenario

    return tuple((c.name, c.weight, c.tier, c.rating_mean, c.rating_sigma,
                  c.deadline_ms / 1e3 if c.deadline_ms > 0 else None)
                 for c in load_scenario(name).cohorts)

#: Phase 6's overload settings (the JAX bench's scenario matrix and its
#: placement soak's credit cap, 8 x window).
OVERLOAD = dict(max_waiting=100_000, max_inflight=8_192, tiers=3,
                shed_policy="oldest", edf=True, deadline_sweep_ms=25.0,
                batch_admission=True)

#: The statuses a request may get, in order: at most one terminal answer.
ANSWER_SEQS = (["queued"], ["matched"], ["queued", "matched"], ["shed"],
               ["queued", "shed"], ["timeout"], ["queued", "timeout"])


class AnswerLog:
    """Every answer the service publishes to ``reply``, with the host
    time of its publish (the broker's ``publish`` and ``publish_batch``
    are wrapped, so reading the replies times nothing)."""

    def __init__(self, app, reply):
        self.times: dict[str, list[float]] = {}
        self.wall: dict[str, list[float]] = {}
        real_one, real_batch = app.broker.publish, app.broker.publish_batch
        in_batch = [False]  # the broker's publish_batch calls publish

        def note(queue, props):
            if queue == reply and props is not None:
                cid = props.correlation_id
                self.times.setdefault(cid, []).append(time.perf_counter())
                self.wall.setdefault(cid, []).append(time.time())

        def publish(queue, body, props=None):
            if not in_batch[0]:
                note(queue, props)
            real_one(queue, body, props)

        def publish_batch(items):
            for queue, _, props in items:
                note(queue, props)
            in_batch[0] = True
            try:
                real_batch(items)
            finally:
                in_batch[0] = False

        app.broker.publish, app.broker.publish_batch = publish, publish_batch
        self.app, self.reply = app, reply

    async def read(self):
        """Every answer on the reply queue: cid → [decoded responses]."""
        from matchmaking_tpu_torch.service.contract import decode_response

        out = {}
        while (d := await self.app.broker.get(self.reply,
                                              timeout=0.2)) is not None:
            out.setdefault(d.properties.correlation_id, []).append(
                decode_response(d.body))
        return out


def cohort_requests(np, rng, n, start):
    """``n`` requests of the mixed-tier-peak cohorts
    (``configs/scenarios/mixed-tier-peak.json``): (id, body, tier,
    deadline budget in s or None), seeded."""
    cohorts = scenario_cohorts()
    pick = rng.choice(len(cohorts), size=n, p=[c[1] for c in cohorts])
    out = []
    for j, c in enumerate(pick.tolist()):
        _, _, tier, mean, sigma, budget = cohorts[c]
        pid = f"r{start + j}"
        body = json.dumps({"id": pid, "rating": round(
            float(rng.normal(mean, sigma)), 3)}).encode()
        out.append((pid, body, tier, budget))
    return out


def timed(obj, name, spans):
    """Wrap ``obj.name`` to append each call's host seconds to
    ``spans``."""
    real = getattr(obj, name)

    def call(*a, **k):
        t = time.perf_counter()
        try:
            return real(*a, **k)
        finally:
            spans.append(time.perf_counter() - t)
    setattr(obj, name, call)


def watch_tier0(rt, tier_of, violations):
    """Record in ``violations`` every shed of a tier-0 player (refused at
    the cut, or picked by the debt) made while a tier-2 player waited in
    the pool (or, for the debt, entered with the window)."""
    real_shed, real_pick = rt._shed_deliveries, rt._pick_victims

    def tier2_waits():
        return rt.engine.pool_tier_counts(3)[2] > 0

    def shed(deliveries):
        if any(d.tier == 0 for d in deliveries) and tier2_waits():
            violations.append(("cut", len(deliveries)))
        real_shed(deliveries)

    def pick(k, entering=()):
        pool_ids, victims = real_pick(k, entering)
        tiers = [tier_of[p] for p in pool_ids] + [v[1] for v in victims]
        if 0 in tiers and (tier2_waits()
                           or any(e[1] == 2 for e in entering)):
            violations.append(("debt", tiers.count(0)))
        return pool_ids, victims

    rt._shed_deliveries, rt._pick_victims = shed, pick


async def service_overload(np, ck, mods, path, *, waiting, requests, burst,
                           seed, overload_on):
    """Config #1's service at full width with 100k waiting (tiered 25 / 50
    / 25 %) and ``requests`` of the mixed-tier-peak cohorts published in
    bursts of ``burst``, unpaced, each with its ``x-tier`` and (ranked,
    quickplay) ``x-deadline``; with ``overload_on`` under OVERLOAD, else
    with no overload control. Checks: every request answered once (at most
    one terminal answer); with overload control, the pool at or under
    max_waiting after every window, no tier-0 player shed while a tier-2
    player waits, the shed answers by tier equal to the controller's
    ``shed_by_tier``, nobody matched later than its deadline plus one
    sweep interval, no credit held after the drain, and the service
    caught no failure. Times the admission cut and the debt's pick and
    eviction per window."""
    import dataclasses

    from matchmaking_tpu_torch.config import OverloadConfig
    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.broker import Properties
    from matchmaking_tpu_torch.service.overload import stamp_deadline

    Config, _, RequestColumns, _ = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    cfg = dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, warm_start=True),
        overload=OverloadConfig(**OVERLOAD) if overload_on
        else OverloadConfig())
    rng = np.random.default_rng(seed)
    t0 = time.time()
    pop = Population(np, rng, waiting, t0, filters=False, glicko2=False)
    pool_tier = rng.choice(3, size=waiting, p=[0.25, 0.5, 0.25]).astype(
        np.int32)
    traffic = cohort_requests(np, rng, requests, 0)
    tier_of = {pid: tier for pid, _, tier, _ in traffic}
    tier_of.update(zip(pop.ids.tolist(), pool_tier.tolist()))
    violations: list = []
    app = MatchmakingApp(cfg, device="cuda")
    reply = "overload.replies"
    await app.start()
    rt = app.runtime(cfg.queues[0].name)
    spans = {"cut": [], "pick": [], "debt": []}
    pool_after: list[int] = []
    backlog: list[int] = []
    try:
        app.broker.declare_queue(reply)
        fill = pop.columns(RequestColumns, app.engine, 0, waiting, t0, reply)
        app.restore_columns(dataclasses.replace(fill, tier=pool_tier),
                            pop.region, pop.mode, t0)
        log_ = AnswerLog(app, reply)
        if overload_on:
            timed(rt, "_admission_cut", spans["cut"])
            timed(rt, "_pick_victims", spans["pick"])
            timed(rt, "_pay_debt", spans["debt"])
            watch_tier0(rt, tier_of, violations)
        real_handle, real_cut = rt._handle_columnar_out, rt._batcher._cut

        def handle(*a, **k):
            real_handle(*a, **k)
            pool_after.append(rt.engine.pool_size())

        def cut():  # the backlog EDF can reorder at each cut
            backlog.append(rt._batcher.depth)
            return real_cut()
        rt._handle_columnar_out, rt._batcher._cut = handle, cut
        reset_counts(ck)  # this soak's windows only
        t_pub, deadline_of = {}, {}
        t_soak = time.perf_counter()
        for b in range(0, requests, burst):
            for pid, body, tier, budget in traffic[b:b + burst]:
                headers = {"x-tier": str(tier)}
                if budget is not None:
                    now = time.time()
                    stamp_deadline(headers, now, budget)
                    deadline_of[pid] = now + budget
                t_pub[pid] = time.perf_counter()
                app.broker.publish(cfg.queues[0].name, body, Properties(
                    reply_to=reply, correlation_id=pid, headers=headers))
            await asyncio.sleep(0.005)
        end = time.monotonic() + 120.0
        while (not all(p in log_.times for p in t_pub)
               and time.monotonic() < end):
            await asyncio.sleep(0.01)
        soak_s = time.perf_counter() - t_soak
        while app.engine.inflight() and time.monotonic() < end:
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.1)  # the last sweep's expiries
        unanswered = [p for p in t_pub if p not in log_.times]
        if unanswered:
            raise AssertionError(f"overload soak: {len(unanswered)} requests "
                                 f"never answered")
        counters = dict(rt.counters)
        shed_by_tier = list(rt.admission.shed_by_tier) if rt.admission else []
        expired_by_tier = (list(rt.admission.expired_by_tier)
                           if rt.admission else [])
    finally:
        await app.stop()
    check_faults(app, "overload soak")
    if overload_on and rt.admission.inflight() != 0:
        raise AssertionError(f"overload soak: {rt.admission.inflight()} "
                             f"credits held after the drain")
    launches = dict(ck.LAUNCHES)
    windows = counters["windows"]
    if launches["block_best"] != windows or launches["quality_accum"] != windows:
        raise AssertionError(f"overload soak: {launches} for {windows} "
                             f"windows")
    answers = await log_.read()
    sweep_s = OVERLOAD["deadline_sweep_ms"] / 1e3
    shed_seen = [0, 0, 0]
    late = 0
    for pid, resps in answers.items():
        seq = [r.status for r in resps]
        if seq not in ANSWER_SEQS:
            raise AssertionError(f"overload soak: {pid} answered {seq}")
        for r, t_wall in zip(resps, log_.wall[pid]):
            if r.status == "shed":
                tier = r.tier if r.tier is not None else tier_of[pid]
                shed_seen[tier] += 1
            if (r.status == "matched" and pid in deadline_of
                    and t_wall > deadline_of[pid] + sweep_s):
                late += 1
    if overload_on:
        if max(pool_after) > OVERLOAD["max_waiting"]:
            raise AssertionError(f"overload soak: the pool reached "
                                 f"{max(pool_after)} after a window")
        if shed_seen != shed_by_tier:
            raise AssertionError(f"overload soak: shed answers by tier "
                                 f"{shed_seen}, shed_by_tier {shed_by_tier}")
        if late:
            raise AssertionError(f"overload soak: {late} players matched "
                                 f"after their deadline + {sweep_s} s")
        if violations:
            raise AssertionError(f"overload soak: tier-0 players shed while "
                                 f"tier 2 waited: {violations[:5]}")
    lat = {t: [] for t in range(3)}
    for pid, t in t_pub.items():
        lat[tier_of[pid]].append((log_.times[pid][0] - t) * 1e3)
    every = [x for xs in lat.values() for x in xs]
    status_by_tier = {t: {} for t in range(3)}
    for pid, _, tier, _ in traffic:
        last = answers[pid][-1].status
        status_by_tier[tier][last] = status_by_tier[tier].get(last, 0) + 1
    res = {"overload": overload_on, "waiting": waiting, "requests": requests,
           "burst": burst, "soak_s": soak_s, "requests_per_s": requests / soak_s,
           "windows": windows, "launches": launches["block_best"],
           "latency_ms_p50": statistics.median(every),
           "latency_ms_p99": pct(every, 0.99),
           "latency_ms_by_tier": {t: {"p50": statistics.median(v),
                                      "p99": pct(v, 0.99)}
                                  for t, v in lat.items()},
           "final_status_by_tier": status_by_tier,
           "shed_by_tier": shed_by_tier, "expired_by_tier": expired_by_tier,
           "backlog_at_cut": {"p50": statistics.median(backlog),
                              "max": max(backlog)},
           "pool_max_after_window": max(pool_after),
           "pool_min_after_window": min(pool_after),
           "matched_late": late,
           "admission_cut_us_per_window": (
               statistics.mean(spans["cut"]) * 1e6 if spans["cut"] else None),
           "debt_windows": len(spans["debt"]),
           "debt_ms_per_window": (statistics.mean(spans["debt"]) * 1e3
                                  if spans["debt"] else None),
           "debt_pick_ms_per_window": (statistics.mean(spans["pick"]) * 1e3
                                       if spans["pick"] else None),
           "counters": {k: v for k, v in counters.items() if v}}
    log(f"overload soak (overload {'on' if overload_on else 'off'}): "
        f"{requests} requests over {waiting} waiting, {windows} windows, "
        f"{res['requests_per_s']:.0f} requests/s, latency p50 "
        f"{res['latency_ms_p50']:.2f} ms p99 {res['latency_ms_p99']:.2f} ms, "
        f"by tier {res['latency_ms_by_tier']}, shed {shed_by_tier}, expired "
        f"{expired_by_tier}, batcher backlog at a cut "
        f"{res['backlog_at_cut']}, pool after a window "
        f"{res['pool_min_after_window']}-{res['pool_max_after_window']}, "
        f"admission cut {res['admission_cut_us_per_window']} us, debt "
        f"{res['debt_ms_per_window']} ms (pick "
        f"{res['debt_pick_ms_per_window']} ms) over {len(spans['debt'])} "
        f"windows")
    return res


# ---- phase 7: the circuit breaker ------------------------------------------


async def service_breaker(np, ck, mods, path, *, waiting, seed,
                          bundle_to=None):
    """Config #1's service at full width with its breaker on (threshold 2,
    window 30 s, probes 0.25 s, backoff 2, max 60 s, health timer 0.05 s)
    and a chaos script failing device steps 0-1 and the first probe:
    100k restored; 8 requests, whose two failed windows trip the breaker,
    answered by the host oracle with the whole pool; probe 1 fails, probe
    2 captures and replays the base step's graph (each kernel launched by
    the replay and by the eager run before the capture) and the pool
    moves onto a fresh engine; 1,024 more requests
    in 8 windows answered on the card. Checks the counters (crashes 2,
    trips 1, probes 2, probe failures 1, closes 1), every player answered
    once, the waiting ids after the move equal the oracle's, the quality
    counters never decrease, and ``torch.cuda.memory_allocated()`` back
    within 5 % of one engine's share after the demotion and within 5 % of
    it after the re-promotion."""
    import dataclasses
    import gc

    import torch

    from matchmaking_tpu_torch.config import ChaosConfig
    from matchmaking_tpu_torch.engine.cpu import CpuEngine
    from matchmaking_tpu_torch.engine.gpu import GpuEngine
    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.broker import Properties

    Config, _, RequestColumns, _ = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    cfg = dataclasses.replace(
        cfg, engine=dataclasses.replace(
            cfg.engine, breaker_threshold=2, breaker_window_s=30.0,
            breaker_probe_initial_s=0.25, breaker_probe_backoff=2.0,
            breaker_probe_max_s=60.0, health_interval_s=0.05),
        chaos=ChaosConfig(fail_step_ranges=((0, 2),), fail_probes=1))
    rng = np.random.default_rng(seed)
    t0 = time.time()
    pop = Population(np, rng, waiting, t0, filters=False, glicko2=False)
    queue = cfg.queues[0].name

    def allocated():
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    mem0 = allocated()
    app = MatchmakingApp(cfg, device="cuda")
    reply = "breaker.replies"
    await app.start()
    rt = app.runtime(queue)
    quality = []

    def quality_count():
        quality.append(int(rt.engine.quality_checkpoint()["count"].sum()))

    async def until(pred, what, timeout=60.0):
        end = time.monotonic() + timeout
        while not pred():
            if time.monotonic() > end:
                raise AssertionError(f"breaker phase: timed out on {what}")
            await asyncio.sleep(0.005)

    def publish(lo, hi):
        for k in range(lo, hi):
            pid = f"b{k}"
            app.broker.publish(queue, json.dumps(
                {"id": pid, "rating": round(float(rng.normal(1500, 300)), 3)}
            ).encode(), Properties(reply_to=reply, correlation_id=pid))

    try:
        app.broker.declare_queue(reply)
        app.restore_columns(
            pop.columns(RequestColumns, app.engine, 0, waiting, t0, reply),
            pop.region, pop.mode, t0)
        engine_share = allocated() - mem0
        quality_count()
        log_ = AnswerLog(app, reply)
        t_demote = time.perf_counter()
        publish(0, 8)
        await until(lambda: all(f"b{k}" in log_.times for k in range(8)),
                    "the degraded answers")
        if not isinstance(rt.engine, CpuEngine):
            raise AssertionError("breaker phase: not demoted to the oracle")
        oracle_s = time.perf_counter() - t_demote
        opened_wall = rt.breaker.opened_at
        first_degraded = min(min(log_.wall[f"b{k}"]) for k in range(8))
        mem_demoted = allocated() - mem0
        quality_count()
        oracle_ids = [r.id for r in rt.engine.waiting()]
        reset_counts(ck)  # the probes' launches only
        await until(lambda: rt.counters["breaker_closes"] == 1,
                    "the re-promotion")
        probe_launches = dict(ck.LAUNCHES)
        if not isinstance(rt.engine, GpuEngine):
            raise AssertionError("breaker phase: not back on the card")
        moved_ids = [r.id for r in rt.engine.waiting()]
        mem_promoted = allocated() - mem0
        quality_count()
        probe = dict(rt.last_probe)
        graphs = rt.engine.graph_report()
        probe["captures"] = graphs["captures"]
        probe["capture_ms"] = sum(g["capture_ms"]
                                  for g in graphs["graphs"].values())
        # 1,024 more requests in 8 windows of 128, each answered before
        # the next: the first windows capture their graphs.
        dispatch_ms = []
        timed(rt.engine, "search_columns_async", dispatch_ms)
        reset_counts(ck)  # the windows after the re-promotion only
        for w in range(8):
            publish(8 + 128 * w, 8 + 128 * (w + 1))
            await until(lambda: all(
                f"b{k}" in log_.times
                for k in range(8 + 128 * w, 8 + 128 * (w + 1))),
                f"window {w} after the re-promotion")
        await until(lambda: rt.engine.inflight() == 0, "the last window")
        after_launches = dict(ck.LAUNCHES)
        quality_count()
        counters = dict(rt.counters)
        hook_steps = app.chaos.engine_hook(queue).steps
    finally:
        await app.stop()
    faults = app.faults()
    events = [k for _, k, _, _ in event_rows(app)]
    if events != BREAKER_EVENTS:
        raise AssertionError(f"breaker phase: events {events}, the CPU "
                             f"run's {BREAKER_EVENTS}")
    want = {"engine_crashes": 2, "breaker_trips": 1, "breaker_probes": 2,
            "breaker_probe_failures": 1, "breaker_closes": 1}
    got = {k: counters[k] for k in want}
    if got != want or faults != {"engine_failures": 2, "revives": 2}:
        raise AssertionError(f"breaker phase: counters {got}, faults "
                             f"{faults}")
    if moved_ids != oracle_ids:
        raise AssertionError("breaker phase: the moved pool differs from "
                             "the oracle's")
    if any(b < a for a, b in zip(quality, quality[1:])):
        raise AssertionError(f"breaker phase: quality counts {quality}")
    # The passing probe replays one graph, captured first: its eager run
    # before the capture launches each kernel once more.
    runs = 1 + probe["captures"]
    if probe_launches != {"block_best": runs, "quality_accum": runs}:
        raise AssertionError(f"breaker phase: the probes launched "
                             f"{probe_launches} (graphs captured: "
                             f"{probe['captures']})")
    windows = counters["windows"]
    if (after_launches["block_best"] < 8
            or after_launches["quality_accum"] != after_launches["block_best"]):
        raise AssertionError(f"breaker phase: {after_launches} launches "
                             f"after the re-promotion")
    if abs(mem_demoted) > 0.05 * engine_share or abs(
            mem_promoted - engine_share) > 0.05 * engine_share:
        raise AssertionError(
            f"breaker phase: memory allocated {mem_demoted} B after the "
            f"demotion, {mem_promoted} B after the re-promotion, one engine "
            f"{engine_share} B")
    # The trip froze one incident bundle (the JAX app's breaker_trip
    # trigger), valid by the schema.
    (bundle,) = check_bundles(app, "breaker_trip", "breaker phase")
    if bundle_to:  # phase 17d reads it with the postmortem tool
        with open(bundle_to, "w", encoding="utf-8") as f:
            json.dump(bundle, f)
    answers = await log_.read()
    for pid, resps in answers.items():
        seq = [r.status for r in resps]
        if seq not in ANSWER_SEQS:
            raise AssertionError(f"breaker phase: {pid} answered {seq}")
    if not all(f"b{k}" in answers for k in range(8 + 1024)):
        raise AssertionError("breaker phase: a request was not answered")
    res = {"waiting": waiting, "counters": got, "faults": faults,
           "chaos_steps": hook_steps, "oracle_share_s": oracle_s,
           "trip_to_first_degraded_answer_ms":
               (first_degraded - opened_wall) * 1e3,
           "probe": probe, "moved": len(moved_ids),
           "first_8_windows_dispatch_ms": [x * 1e3 for x in dispatch_ms],
           "events": events, "incident_capture_ms": bundle["capture_ms"],
           "windows": windows, "probe_launches": probe_launches,
           "launches_after": after_launches["block_best"],
           "quality_counts": quality,
           "memory_bytes": {"one_engine": engine_share,
                            "after_demotion": mem_demoted,
                            "after_repromotion": mem_promoted}}
    log(f"breaker phase: {waiting} waiting; the oracle answered 8 in "
        f"{oracle_s:.2f} s ({res['trip_to_first_degraded_answer_ms']:.1f} ms "
        f"from the trip to its first answer); probe {probe}; "
        f"{len(moved_ids)} moved; first 8 windows' dispatch ms "
        f"{[round(x, 3) for x in res['first_8_windows_dispatch_ms']]}; "
        f"memory {res['memory_bytes']}")
    return res


# ---- phase 8: durability, the drain, auth -----------------------------------


class Crashed(BaseException):
    """Unwinds the task a simulated hard crash stopped (not an Exception:
    no handler of the service may catch it and go on)."""


class Replies:
    """Every answer the service publishes to ``reply``: correlation id →
    [(host time of its publish, body)] (the broker's ``publish`` and
    ``publish_batch`` are wrapped, so reading the replies times
    nothing)."""

    def __init__(self, app, reply):
        self.got: dict[str, list[tuple[float, bytes]]] = {}
        real_one, real_batch = app.broker.publish, app.broker.publish_batch
        in_batch = [False]  # the broker's publish_batch calls publish

        def publish(queue, body, props=None):
            if queue == reply and props is not None and not in_batch[0]:
                self.got.setdefault(props.correlation_id, []).append(
                    (time.perf_counter(), bytes(body)))
            real_one(queue, body, props)

        def publish_batch(items):
            t = time.perf_counter()
            for queue, body, props in items:
                if queue == reply and props is not None:
                    self.got.setdefault(props.correlation_id, []).append(
                        (t, bytes(body)))
            in_batch[0] = True
            try:
                real_batch(items)
            finally:
                in_batch[0] = False

        app.broker.publish, app.broker.publish_batch = publish, publish_batch
        app.broker.declare_queue(reply)

    def statuses(self, pid):
        return [json.loads(b)["status"] for _, b in self.got.get(pid, ())]

    def matched(self):
        """player id → match id of every matched answer."""
        out = {}
        for pid, answers in self.got.items():
            for _, b in answers:
                d = json.loads(b)
                if d["status"] == "matched":
                    out.setdefault(pid, set()).add(d["match"]["match_id"])
        return out


def durable_cfg(Config, path, *, journal_dir, fsync="window", overload=None,
                auth=None, warm=True, compact_interval_s=0.0):
    import dataclasses

    from matchmaking_tpu_torch.config import (
        AuthConfig,
        DurabilityConfig,
        OverloadConfig,
    )

    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    return dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, warm_start=warm),
        durability=DurabilityConfig(journal_dir=journal_dir or "",
                                    fsync=fsync,
                                    compact_interval_s=compact_interval_s),
        overload=OverloadConfig(**overload) if overload else OverloadConfig(),
        auth=AuthConfig(**auth) if auth else AuthConfig())


def request_bodies(pop, lo, hi):
    return [(pop.ids[k], json.dumps({"id": pop.ids[k],
                                     "rating": float(pop.rating[k])}).encode())
            for k in range(lo, hi)]


async def publish_and_wait(app, rows, burst, reply, replies, *, headers=None,
                           timeout=120.0):
    """Publish ``rows`` ((id, body)) in bursts of ``burst`` (5 ms apart),
    then wait until each has an answer. Returns (seconds, publish times)."""
    from matchmaking_tpu_torch.service.broker import Properties

    t_pub = {}
    t0 = time.perf_counter()
    for b in range(0, len(rows), burst):
        for pid, body in rows[b:b + burst]:
            t_pub[pid] = time.perf_counter()
            app.broker.publish(app.queue_cfg.name, body, Properties(
                reply_to=reply, correlation_id=pid,
                headers=dict(headers(pid)) if headers else {}))
        await asyncio.sleep(0.005)
    end = time.monotonic() + timeout
    while (not all(p in replies.got for p in t_pub)
           and time.monotonic() < end):
        await asyncio.sleep(0.01)
    soak_s = time.perf_counter() - t0
    missing = [p for p in t_pub if p not in replies.got]
    if missing:
        raise AssertionError(f"{len(missing)} requests never answered")
    return soak_s, t_pub


async def settle(app, timeout=60.0):
    """Until no window is in flight and no answer waits for its commit."""
    rt = app.runtime(app.queue_cfg.name)
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if (app.engine.inflight() == 0 and rt._settler is None
                and rt._batcher.depth == 0
                and app.broker.queue_depth(app.queue_cfg.name) == 0):
            return
        await asyncio.sleep(0.01)
    raise AssertionError("the service did not settle")


def latency_ms(replies, t_pub):
    lat = [(replies.got[p][0][0] - t) * 1e3 for p, t in t_pub.items()]
    return statistics.median(lat), pct(lat, 0.99)


def journal_account(np, directory, queue):
    """A host recomputation of the waiting set from the files alone: the
    newest snapshot's ids, then every record after its anchor in seq
    order (ADMIT adds its rows, TERMINAL/TERMINALS remove), over the
    retained segments. Returns (waiting set, admitted-and-not-terminal
    set, anchor, records by type)."""
    from matchmaking_tpu_torch.utils import journal as jr

    snaps = jr.list_snapshots(directory, queue)
    anchor, snap = snaps[0]
    with np.load(snap, allow_pickle=False) as z:
        waiting = set(z["ids"].tolist())
    records = []
    live = jr.journal_path(directory, queue)
    for path in (live + ".prev", live):
        if os.path.exists(path):
            _, recs, _, _ = jr.read_segment(path)
            records += recs
    records.sort(key=lambda r: r[0])
    admitted = set()
    kinds: dict[int, int] = {}
    for seq, rtype, payload in records:
        kinds[rtype] = kinds.get(rtype, 0) + 1
        if seq <= anchor:
            continue
        d = json.loads(payload)
        if rtype == jr.RT_ADMIT:
            for row in d["rows"]:
                waiting.add(row[0])
                admitted.add(row[0])
        elif rtype == jr.RT_TERMINALS:
            for pid, _, _ in d["t"]:
                waiting.discard(pid)
                admitted.discard(pid)
        elif rtype == jr.RT_TERMINAL:
            waiting.discard(d["id"])
            admitted.discard(d["id"])
    return waiting, admitted, anchor, kinds


def window_pairs(replies, pids):
    """The pairs among the answers to ``pids``."""
    out = set()
    for pid in pids:
        for _, b in replies.got.get(pid, ()):
            d = json.loads(b)
            if d["status"] == "matched":
                out.add(tuple(sorted(d["match"]["players"])))
    return out


async def service_durability(np, torch, ck, mods, path, *, waiting, requests,
                             burst, seed):
    """8a and 8b. Config #1's service at full width, with 100k restored:
    the soak of ``requests`` in bursts of ``burst`` with durability off,
    then with the journal on (fsync="window"): a compaction first anchors
    the 100k (timed; its snapshot's bytes), then the soak; requests/s,
    latency p50/p99, and the journal's host ms a window (ADMIT rows, their
    append and write, the terminals' append, the commit on its thread and
    the loop's wait for it). Checks: every request answered once, the
    segment's ADMIT records equal the windows dispatched. Then a second
    stream, crashed right after its 4th window is dispatched and
    journaled (in flight, uncollected); a successor on the same
    directory recovers on the card (rto_ms and its split, the device's
    drain after it), its waiting set equal to a host recomputation from
    the files, every player answered ``matched`` before the crash absent
    from it, every admitted player without a terminal waiting once; then
    1,024 new requests (its first window's pairs equal to a port app's on
    the CPU recovered from a copy of the directory) and the second
    stream's redeliveries (each matched player's replaying its body byte
    for byte), then 6,144 more new requests (the first 8 windows' dispatch
    ms), with block_best and quality_accum launched, and nobody in two
    matches across both apps."""
    import dataclasses
    import shutil
    import tempfile

    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.broker import Properties
    from matchmaking_tpu_torch.utils import journal as jr

    Config, _, RequestColumns, _ = mods
    rng = np.random.default_rng(seed)
    t0 = time.time()
    second = 8_192
    pop = Population(np, rng, waiting + requests + second + 7_168, t0,
                     filters=False, glicko2=False)
    res: dict = {}
    work = tempfile.mkdtemp(prefix="mm_journal_")
    jdir = os.path.join(work, "journal")
    reply = "dur.replies"
    queue = None
    try:
        # ---- 8a: the soak with durability off, then on --------------------
        for on in (False, True):
            cfg = durable_cfg(Config, path, journal_dir=jdir if on else None)
            queue = cfg.queues[0].name
            app = MatchmakingApp(cfg, device="cuda")
            await app.start()
            rt = app.runtime(queue)
            replies = Replies(app, reply)
            fill = pop.columns(RequestColumns, app.engine, 0, waiting, t0,
                               reply)
            app.restore_columns(fill, pop.region[:waiting],
                                pop.mode[:waiting], t0)
            leg = {}
            if on:
                t = time.perf_counter()
                anchor = await rt.compact_journal()
                leg["compact_ms"] = (time.perf_counter() - t) * 1e3
                leg["snapshot_bytes"] = os.path.getsize(anchor["snapshot"])
                leg["snapshot_players"] = anchor["count"]
                if anchor["count"] != waiting:
                    raise AssertionError(f"8a: the anchor snapshotted "
                                         f"{anchor['count']} players")
            stats0 = dict(rt.journal_stats)
            windows0 = rt.counters["windows"]
            reset_counts(ck)
            soak_s, t_pub = await publish_and_wait(
                app, request_bodies(pop, waiting, waiting + requests), burst,
                reply, replies)
            await settle(app)
            windows = rt.counters["windows"] - windows0
            p50, p99 = latency_ms(replies, t_pub)
            leg.update({"requests_per_s": requests / soak_s, "soak_s": soak_s,
                        "latency_ms_p50": p50, "latency_ms_p99": p99,
                        "windows": windows,
                        "launches": dict(ck.LAUNCHES)})
            for pid in t_pub:
                if replies.statuses(pid) not in (["queued"], ["matched"],
                                                 ["queued", "matched"]):
                    raise AssertionError(f"8a: {pid} answered "
                                         f"{replies.statuses(pid)}")
            check_faults(app, "8a soak")
            if leg["launches"]["block_best"] != windows or leg["launches"][
                    "quality_accum"] != windows:
                raise AssertionError(f"8a: {leg['launches']} for {windows} "
                                     f"windows")
            if not on:
                await app.stop()
                res["off"] = leg
                continue
            stats = {k: rt.journal_stats[k] - stats0[k] for k in stats0}
            leg["journal_ms_per_window"] = {
                "admit_rows": stats["admit_rows_ms"] / windows,
                "admit_append_write": stats["admit_write_ms"] / windows,
                "terminals_append": stats["terminals_ms"] / windows,
                "commit_thread": stats["commit_thread_ms"] / windows,
                "commit_loop_wait": stats["commit_wait_ms"] / windows}
            leg["commits"] = stats["commits"]
            _, _, anchor_seq, kinds = journal_account(np, jdir, queue)
            _, recs, _, _ = jr.read_segment(jr.journal_path(jdir, queue))
            admits = sum(1 for s, t, _ in recs
                         if t == jr.RT_ADMIT and s > anchor_seq)
            if admits != windows or stats["admit_records"] != windows:
                raise AssertionError(f"8a: {admits} ADMIT records for "
                                     f"{windows} windows")
            leg["segment_bytes"] = os.path.getsize(jr.journal_path(jdir,
                                                                   queue))
            leg["records"] = kinds
            res["on"] = leg
            log(f"8a journal on: {leg['requests_per_s']:.0f} requests/s "
                f"(off {res['off']['requests_per_s']:.0f}), latency p50 "
                f"{p50:.2f} ms p99 {p99:.2f} ms (off "
                f"{res['off']['latency_ms_p50']:.2f}/"
                f"{res['off']['latency_ms_p99']:.2f}), anchor compaction "
                f"{leg['compact_ms']:.1f} ms, snapshot "
                f"{leg['snapshot_bytes']} bytes, journal ms a window "
                f"{leg['journal_ms_per_window']}")

            # ---- 8b: a second stream, crashed with windows in flight ------
            # The crash comes right after the 4th window of the stream is
            # dispatched and its ADMIT record written (so that window is in
            # flight and journaled): crash() (no awaits inside: driven to
            # its end here), then Crashed unwinds the dispatching task as
            # a kill -9 would stop it.
            rows = request_bodies(pop, waiting + requests,
                                  waiting + requests + second)
            state = {}
            real_admit = rt._journal_admit_cols

            def admit_then_crash(cols):
                real_admit(cols)
                state["windows"] = state.get("windows", 0) + 1
                if state["windows"] == 4:
                    state["in_flight"] = app.engine.inflight()
                    crash = app.crash()
                    try:
                        crash.send(None)
                    except StopIteration:
                        pass
                    raise Crashed()
            rt._journal_admit_cols = admit_then_crash
            sent = []
            for b in range(0, second, burst):
                for pid, body in rows[b:b + burst]:
                    sent.append((pid, body))
                    app.broker.publish(queue, body, Properties(
                        reply_to=reply, correlation_id=pid))
                await asyncio.sleep(0.004)
                if "in_flight" in state:
                    break
            crashed_at = state.get("in_flight")
            if not crashed_at:
                raise AssertionError(f"8b: no window in flight at the crash "
                                     f"({state})")
            flusher = rt._batcher._task
            await asyncio.sleep(0.01)
            if flusher.done() and not flusher.cancelled():
                flusher.exception()  # the Crashed it ended with, retrieved
            before = {pid: list(v) for pid, v in replies.got.items()}
            matched_before = replies.matched()
            del app, rt
            copy = os.path.join(work, "copy")
            shutil.copytree(jdir, copy)
            want_waiting, want_admitted, _, kinds = journal_account(
                np, jdir, queue)

            # The successor on the card.
            app2 = MatchmakingApp(durable_cfg(Config, path, journal_dir=jdir),
                                  device="cuda")
            t = time.perf_counter()
            await app2.start()
            start_ms = (time.perf_counter() - t) * 1e3
            recovery_events = event_rows(app2)
            t = time.perf_counter()
            torch.cuda.synchronize()
            drain_ms = (time.perf_counter() - t) * 1e3
            rt2 = app2.runtime(queue)
            rec = rt2.last_recovery
            if rec is None:
                raise AssertionError("8b: the successor did not recover")
            got_waiting = set(rt2.engine.pool._slot_of)
            if got_waiting != want_waiting:
                raise AssertionError(
                    f"8b: recovered {len(got_waiting)} waiting, the files "
                    f"say {len(want_waiting)} "
                    f"({len(got_waiting ^ want_waiting)} differ)")
            active = int(rt2.engine.dev_pool["active"].sum())
            if active != len(got_waiting) or not want_admitted <= got_waiting:
                raise AssertionError(f"8b: {active} active slots for "
                                     f"{len(got_waiting)} waiting")
            published_terminal = {p for p in matched_before}
            if published_terminal & got_waiting:
                raise AssertionError("8b: a player answered matched before "
                                     "the crash is waiting again")
            replies2 = Replies(app2, reply)
            dispatch_ms = []
            timed(rt2.engine, "search_columns_async", dispatch_ms)
            # 1,024 new requests: the first window after the recovery.
            reset_counts(ck)
            lo = waiting + requests + second
            fresh = request_bodies(pop, lo, lo + 1_024)
            await publish_and_wait(app2, fresh, 1_024, reply, replies2)
            first_pairs = window_pairs(replies2, [p for p, _ in fresh])
            # The redeliveries: every request of the second stream.
            expect = [pid for pid, _ in sent if pid not in got_waiting]
            for pid, body in sent:
                app2.broker.publish(queue, body, Properties(
                    reply_to=reply, correlation_id=pid))
            end = time.monotonic() + 120.0
            while (not all(p in replies2.got for p in expect)
                   and time.monotonic() < end):
                await asyncio.sleep(0.01)
            await settle(app2)
            if any(p not in replies2.got for p in expect):
                raise AssertionError("8b: redeliveries unanswered")
            # Six windows more of new requests: the first 8 windows'
            # dispatch ms after the recovery.
            more = request_bodies(pop, lo + 1_024, lo + 7_168)
            await publish_and_wait(app2, more, 1_024, reply, replies2)
            await settle(app2)
            launches = dict(ck.LAUNCHES)
            replays_checked = 0
            for pid, _ in sent:
                if pid not in matched_before:
                    continue
                first = [b for _, b in before[pid]
                         if json.loads(b)["status"] == "matched"][0]
                if replies2.got[pid][0][1] != first:
                    raise AssertionError(f"8b: {pid}'s replay differs")
                replays_checked += 1
            if not replays_checked:
                raise AssertionError("8b: no matched answer to replay")
            for pid, _ in sent:
                # A waiting player's copy enters nothing and gets no answer
                # of its own; an arrival may match the player (and a copy
                # that comes after that replays the match).
                bodies = {b for _, b in replies2.got.get(pid, ())}
                if pid in got_waiting and (
                        len(bodies) > 1 or set(replies2.statuses(pid))
                        - {"matched"}):
                    raise AssertionError(f"8b: waiting {pid} answered "
                                         f"{replies2.statuses(pid)}")
            both = {p: set(v) for p, v in matched_before.items()}
            for p, ids in replies2.matched().items():
                both.setdefault(p, set()).update(ids)
            twice = [p for p, ids in both.items() if len(ids) > 1]
            if twice:
                raise AssertionError(f"8b: {len(twice)} players in two "
                                     f"matches")
            if (launches["block_best"] == 0
                    or launches["quality_accum"] != launches["block_best"]):
                raise AssertionError(f"8b: {launches} on the recovered "
                                     f"service")
            check_faults(app2, "8b successor")
            # The recovery froze one incident bundle (crash_recovered).
            (rec_bundle,) = check_bundles(app2, "crash_recovery",
                                          "8b successor")
            await app2.stop()

            # The same recovery and first window on the CPU.
            cpu = MatchmakingApp(durable_cfg(Config, path, journal_dir=copy,
                                             warm=False), device="cpu")
            await cpu.start()
            cpu_events = event_rows(cpu)
            replies3 = Replies(cpu, reply)
            await publish_and_wait(cpu, fresh, 1_024, reply, replies3)
            cpu_pairs = window_pairs(replies3, [p for p, _ in fresh])
            cpu_rec = cpu.runtime(queue).last_recovery
            cpu_incidents = cpu.incidents.snapshot()["by_class"]
            await cpu.stop()
            if first_pairs != cpu_pairs or not first_pairs:
                raise AssertionError(
                    f"8b: the first window's pairs differ from the CPU "
                    f"app's ({len(first_pairs)} vs {len(cpu_pairs)})")
            if cpu_rec["transcript"] != rec["transcript"]:
                raise AssertionError("8b: the CPU app recovered another "
                                     "transcript")
            if cpu_incidents != app2.incidents.snapshot()["by_class"]:
                raise AssertionError(f"8b: incidents {cpu_incidents} on the "
                                     f"CPU app")
            if (recovery_events != cpu_events or "crash_recovered" not in
                    [k for _, k, _, _ in recovery_events]):
                raise AssertionError(f"8b: the recovery's events "
                                     f"{recovery_events}, the CPU app's "
                                     f"{cpu_events}")
            res["crash"] = {
                "in_flight_at_crash": crashed_at,
                "sent_before_crash": len(sent),
                "answered_matched_before_crash": len(matched_before),
                "records": kinds,
                "rto_ms": rec["rto_ms"], "attach_ms": rec["attach_ms"],
                "split_ms": rec["split_ms"], "start_ms": start_ms,
                "device_drain_after_start_ms": drain_ms,
                "snapshot_players": rec["snapshot_players"],
                "tail_players": rec["tail_players"],
                "removed_players": rec["removed_players"],
                "dedup_entries": rec["dedup_entries"],
                "recovered_waiting": len(got_waiting),
                "first_window_pairs": len(first_pairs),
                "replayed": rt2.counters["deduped_replays"],
                "replays_checked": replays_checked,
                "events": [k for _, k, _, _ in recovery_events],
                "incident_capture_ms": rec_bundle["capture_ms"],
                "launches": launches,
                "first_8_windows_dispatch_ms": [x * 1e3 for x in
                                                dispatch_ms[:8]]}
            log(f"8b crash with {crashed_at} windows in flight after "
                f"{len(sent)} of the second stream: recovered "
                f"{len(got_waiting)} waiting (= the files), rto "
                f"{rec['rto_ms']:.1f} ms (attach {rec['attach_ms']:.1f} ms, "
                f"{rec['split_ms']}), device drain {drain_ms:.1f} ms, "
                f"{rt2.counters['deduped_replays']} replays, first window "
                f"{len(first_pairs)} pairs = CPU app's, first 8 dispatch ms "
                f"{[round(x * 1e3, 3) for x in dispatch_ms[:8]]}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return res


async def service_drain(np, torch, ck, mods, path, *, waiting, backlog, seed):
    """8c. Config #1's service with phase 6's overload settings and 100k
    waiting (tiered), a burst of 1,024 answered, then ``drain(dir)`` while
    ``backlog`` requests reach the broker after the consumer is cancelled
    (the handoff's unconsumed backlog). A successor runs
    ``restore_checkpoint(dir)``: the pool's columns (ids, rating, rd,
    threshold, enqueue time, tier, deadline) equal the predecessor's after
    the round trip, the backlog is re-published and answered on the card,
    and no credit is left held. Times the save and the restore, with the
    files' bytes."""
    import dataclasses
    import shutil
    import tempfile

    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.broker import Properties
    from matchmaking_tpu_torch.utils import checkpoint

    Config, _, RequestColumns, _ = mods
    rng = np.random.default_rng(seed)
    t0 = time.time()
    pop = Population(np, rng, waiting + 1_024 + backlog, t0, filters=False,
                     glicko2=False, deadline_frac=0.05)
    tiers = rng.choice(3, size=waiting, p=[0.25, 0.5, 0.25]).astype(np.int32)
    work = tempfile.mkdtemp(prefix="mm_drain_")
    reply = "drain.replies"
    cfg = durable_cfg(Config, path, journal_dir=None, overload=OVERLOAD)
    queue = cfg.queues[0].name

    def columns(eng):
        cols, _, _ = checkpoint.engine_waiting_columns(eng)
        order = np.argsort(cols.ids.astype(str))
        return {k: getattr(cols, k)[order] for k in (
            "ids", "rating", "rd", "threshold", "enqueued_at", "tier",
            "deadline")}

    try:
        app = MatchmakingApp(cfg, device="cuda")
        await app.start()
        rt = app.runtime(queue)
        replies = Replies(app, reply)
        fill = pop.columns(RequestColumns, app.engine, 0, waiting, t0, reply)
        app.restore_columns(dataclasses.replace(fill, tier=tiers),
                            pop.region[:waiting], pop.mode[:waiting], t0)
        reset_counts(ck)
        await publish_and_wait(app, request_bodies(pop, waiting,
                                                   waiting + 1_024),
                               1_024, reply, replies,
                               headers=lambda pid: {"x-tier": "1"})
        late = request_bodies(pop, waiting + 1_024, waiting + 1_024 + backlog)
        real_cancel = app.broker.basic_cancel

        def cancel(tag):
            real_cancel(tag)
            if tag == rt._tag:  # producers go on publishing
                for pid, body in late:
                    app.broker.publish(queue, body, Properties(
                        reply_to=reply, correlation_id=pid,
                        headers={"x-tier": "1"}))
        app.broker.basic_cancel = cancel
        t = time.perf_counter()
        counts = await app.drain(work)
        save_ms = (time.perf_counter() - t) * 1e3
        if rt.admission.inflight() != 0:
            raise AssertionError(f"8c: {rt.admission.inflight()} credits "
                                 f"held after the drain")
        check_faults(app, "8c predecessor")
        want = columns(app.engine)
        nbytes = {f: os.path.getsize(os.path.join(work, f))
                  for f in sorted(os.listdir(work))}
        with open(os.path.join(work, "_backlog.json")) as f:
            saved_backlog = json.load(f)["count"]
        if saved_backlog != backlog or counts[queue] != len(want["ids"]):
            raise AssertionError(f"8c: saved {counts}, backlog "
                                 f"{saved_backlog}")
        app.engine.close()
        del app, rt

        succ = MatchmakingApp(cfg, device="cuda")
        await succ.start()
        rt2 = succ.runtime(queue)
        replies2 = Replies(succ, reply)
        reset_counts(ck)
        t = time.perf_counter()
        restored = await succ.restore_checkpoint(work)
        restore_ms = (time.perf_counter() - t) * 1e3
        got = columns(succ.engine)  # before the backlog's windows land
        for k, v in want.items():
            same = (np.array_equal(v, got[k], equal_nan=True)
                    if v.dtype.kind == "f" else np.array_equal(v, got[k]))
            if not same:
                raise AssertionError(f"8c: column {k} differs after the "
                                     f"round trip")
        end = time.monotonic() + 60.0
        while (not all(p in replies2.got for p, _ in late)
               and time.monotonic() < end):
            await asyncio.sleep(0.01)
        if any(p not in replies2.got for p, _ in late):
            raise AssertionError("8c: the backlog was not answered")
        await settle(succ)
        launches = dict(ck.LAUNCHES)
        await succ.stop()
        check_faults(succ, "8c successor")
        if rt2.admission.inflight() != 0:
            raise AssertionError("8c: a credit held after the successor")
        if launches["block_best"] == 0 or launches["quality_accum"] == 0:
            raise AssertionError(f"8c: {launches} answering the backlog")
        statuses = {}
        for pid, _ in late:
            s = replies2.statuses(pid)[-1]
            statuses[s] = statuses.get(s, 0) + 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res = {"saved": counts[queue], "restored": restored[queue],
           "backlog": saved_backlog, "save_ms": save_ms,
           "restore_ms": restore_ms, "bytes": nbytes,
           "backlog_final_status": statuses, "launches": launches}
    log(f"8c drain: {counts[queue]} players + {saved_backlog} backlog saved "
        f"in {save_ms:.1f} ms ({nbytes}), restored in {restore_ms:.1f} ms, "
        f"columns equal, backlog answered {statuses}")
    return res


async def service_auth(np, ck, mods, path, *, waiting, requests, seed):
    """8d. Config #1's service with 100k waiting under auth ``rpc`` (an
    in-process responder on ``rpc_queue``, a 5 s timeout), ``static``, and
    ``none``, each
    taking ``requests`` (one in 8 with a bad token) in bursts of 512:
    the bad ones answered ``unauthorized``, the rest queued or matched on
    the card (block_best and quality_accum launched). Requests/s for each
    (rpc runs a task per delivery)."""
    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.broker import Properties

    Config, _, RequestColumns, _ = mods
    rng = np.random.default_rng(seed)
    t0 = time.time()
    pop = Population(np, rng, waiting + requests, t0, filters=False,
                     glicko2=False)
    secret = "tok"
    res = {}
    for mode in ("rpc", "static", "none"):
        # A 5 s rpc timeout: the in-process responder, on the service's
        # own event loop, answers a burst of 512 round trips in series
        # (the default 250 ms timed some good tokens out as
        # auth_unavailable on one card machine).
        cfg = durable_cfg(Config, path, journal_dir=None,
                          auth={"mode": mode, "static_secret": secret,
                                "rpc_timeout_ms": 5_000.0})
        app = MatchmakingApp(cfg, device="cuda")
        await app.start()
        try:
            if mode == "rpc":
                broker = app.broker

                async def verify(d, broker=broker):
                    ok = d.body.startswith(secret.encode())
                    broker.publish(d.properties.reply_to,
                                   b"ok" if ok else b"denied",
                                   Properties(correlation_id=d.properties
                                              .correlation_id))
                    broker.ack(tag, d.delivery_tag)
                tag = broker.basic_consume(cfg.auth.rpc_queue, verify,
                                           prefetch=4096)
            reply = "auth.replies"
            replies = Replies(app, reply)
            fill = pop.columns(RequestColumns, app.engine, 0, waiting, t0,
                               reply)
            app.restore_columns(fill, pop.region[:waiting],
                                pop.mode[:waiting], t0)
            rows = request_bodies(pop, waiting, waiting + requests)
            bad = {pid for j, (pid, _) in enumerate(rows) if j % 8 == 5}
            reset_counts(ck)
            soak_s, t_pub = await publish_and_wait(
                app, rows, 512, reply, replies,
                headers=lambda pid: {"authorization": (
                    "wrong" if pid in bad else f"{secret}-{pid}")})
            await settle(app)
            launches = dict(ck.LAUNCHES)
            check_faults(app, f"8d auth {mode}")
        finally:
            await app.stop()
        for pid, _ in rows:
            seq = replies.statuses(pid)
            if pid in bad and mode != "none":
                body = json.loads(replies.got[pid][0][1])
                if seq != ["error"] or "unauthorized" not in json.dumps(body):
                    raise AssertionError(f"8d {mode}: {pid} answered {seq}")
            elif seq not in (["queued"], ["matched"], ["queued", "matched"]):
                raise AssertionError(f"8d {mode}: {pid} answered {seq}")
        if launches["block_best"] == 0 or launches["quality_accum"] == 0:
            raise AssertionError(f"8d {mode}: {launches}")
        p50, p99 = latency_ms(replies, t_pub)
        res[mode] = {"requests_per_s": requests / soak_s,
                     "latency_ms_p50": p50, "latency_ms_p99": p99,
                     "unauthorized": len(bad) if mode != "none" else 0,
                     "launches": launches}
        log(f"8d auth {mode}: {requests} requests, "
            f"{res[mode]['requests_per_s']:.0f} requests/s, latency p50 "
            f"{p50:.2f} ms p99 {p99:.2f} ms")
    return res


# ---- phase 9: tracing ---------------------------------------------------------

#: The mark names of one 1v1 window: the engine's stamps, merged into every
#: member trace.
WINDOW_MARKS = re.compile(r"dispatch( h2d device_step)+ readback_seal collect")

#: Phase 7's event kinds, as the CPU run of its scenario logs them
#: (tests/test_torch_events.py holds the CPU app to this list): two
#: chaos-failed windows, the trip, the demotion, a failed and a passing
#: probe.
BREAKER_EVENTS = [
    "chaos_step_fault", "engine_crash", "engine_revive", "chaos_step_fault",
    "engine_crash", "breaker_trip", "degraded_revive", "engine_revive",
    "breaker_probe", "chaos_probe_fault", "probe_failed", "breaker_probe",
    "breaker_closed"]


def event_rows(app):
    """The event log without its clocks (a recovery's measured ms masked)."""
    return [(r["component"], r["kind"], r["queue"],
             re.sub(r"rto [0-9.]+ ms", "rto # ms", r["detail"]))
            for r in app.events.snapshot()]


async def service_trace_soak(np, ck, mods, path, *, waiting, requests, burst,
                             seed, mode, profile_to=None):
    """Config #1's service at full width with tracing ``mode``: "off",
    "on" (every request traced) or "sampled" (``trace_sample_n`` 16):
    ``waiting`` players restored, then ``requests`` published in bursts of
    ``burst``. Measures requests/s, latency p50/p99 (publish → first
    answer), GC ms, and the host ms of the flight recorder (its stage
    histograms) and of the attribution, each over the soak and a window.
    Checks: every window's marks are ``WINDOW_MARKS``; the traces settled
    are the requests answered (on), 1 in 16 of them (sampled), none (off);
    work + wait equals the enqueue→publish span for every trace; every
    request's own answer quotes its trace id exactly when it was traced;
    one block_best and one quality_accum launch per window; no fault."""
    import dataclasses

    from matchmaking_tpu_torch.config import ObservabilityConfig
    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.attribution import decompose_marks

    Config, _, RequestColumns, _ = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    sample_n = 16 if mode == "sampled" else 1
    cfg = dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, warm_start=True),
        observability=ObservabilityConfig(trace=mode != "off",
                                          trace_sample_n=sample_n))
    if cfg.batcher.max_batch > max(cfg.engine.batch_buckets):
        raise AssertionError("trace soak: a window would take several chunks")
    rng = np.random.default_rng(seed)
    t0 = time.time()
    pop = Population(np, rng, waiting + requests, t0, filters=False,
                     glicko2=cfg.queues[0].glicko2)
    app = MatchmakingApp(cfg, device="cuda")
    await app.start()
    queue = cfg.queues[0].name
    rt = app.runtime(queue)
    reply = "trace.replies"
    settled = []
    spent = {"recorder": 0.0, "attribution": 0.0}
    real_complete = app.recorder.complete
    real_observe = app.attribution.observe

    def observe(tr):
        t = time.perf_counter()
        real_observe(tr)
        spent["attribution"] += time.perf_counter() - t

    def complete(tr):
        t = time.perf_counter()
        real_complete(tr)
        spent["recorder"] += time.perf_counter() - t
        settled.append(tr)

    app.attribution.observe = observe
    app.recorder.complete = complete
    window_marks = []
    real_merge = rt._merge_window_marks

    def merge(tok, deliveries):
        marks = rt.engine.window_marks.get(tok)
        if marks:
            window_marks.append(" ".join(n for n, _ in marks))
        real_merge(tok, deliveries)

    rt._merge_window_marks = merge
    try:
        replies = Replies(app, reply)
        app.restore_columns(
            pop.columns(RequestColumns, app.engine, 0, waiting, t0, reply),
            pop.region[:waiting], pop.mode[:waiting], t0)
        windows0 = rt.counters["windows"]
        reset_counts(ck)
        prof = None
        if profile_to:
            import cProfile

            prof = cProfile.Profile()
            prof.enable()
        gc_clock = GcClock().__enter__()
        soak_s, t_pub = await publish_and_wait(
            app, request_bodies(pop, waiting, waiting + requests), burst,
            reply, replies)
        gc_clock.__exit__()
        if prof is not None:
            import io
            import pstats

            prof.disable()
            text = io.StringIO()
            pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(40)
            with open(profile_to, "w") as f:
                f.write(text.getvalue())
        await settle(app)
        windows = rt.counters["windows"] - windows0
        launches = dict(ck.LAUNCHES)
        p50, p99 = latency_ms(replies, t_pub)
        stages = app.metrics.report()["stage_seconds"].get(queue, {})
    finally:
        await app.stop()
    check_faults(app, f"trace soak ({mode})")
    bad = [m for m in window_marks if not WINDOW_MARKS.fullmatch(m)]
    if bad or len(window_marks) != windows:
        raise AssertionError(f"trace soak ({mode}): {len(window_marks)} "
                             f"windows' marks for {windows} windows, "
                             f"{len(bad)} not {WINDOW_MARKS.pattern}: "
                             f"{bad[:2]}")
    if (launches["block_best"] != windows
            or launches["quality_accum"] != windows):
        raise AssertionError(f"trace soak ({mode}): {launches} launches for "
                             f"{windows} windows")
    want = {"off": 0, "on": requests, "sampled": requests // sample_n}[mode]
    if abs(len(settled) - want) > (1 if mode == "sampled" else 0):
        raise AssertionError(f"trace soak ({mode}): {len(settled)} traces "
                             f"settled, want {want}")
    traced = {}
    for tr in settled:
        _, work, wait = decompose_marks(tr.marks)
        if abs(work + wait - tr.total_s) > 1e-9:
            raise AssertionError(f"trace soak ({mode}): {tr.trace_id} "
                                 f"work + wait != span")
        if tr.status not in ("matched", "queued"):
            raise AssertionError(f"trace soak ({mode}): {tr.trace_id} "
                                 f"settled {tr.status}")
        traced[tr.correlation_id] = tr.trace_id
    for pid in t_pub:
        got = json.loads(replies.got[pid][0][1]).get("trace_id", "")
        if got != traced.get(pid, ""):
            raise AssertionError(f"trace soak ({mode}): {pid} answered with "
                                 f"trace id {got!r}, traced "
                                 f"{traced.get(pid, '')!r}")
    res = {"mode": mode, "trace_sample_n": sample_n, "waiting": waiting,
           "requests": requests, "burst": burst, "windows": windows,
           "soak_s": soak_s, "requests_per_s": requests / soak_s,
           "latency_ms_p50": p50, "latency_ms_p99": p99,
           "gc_ms": gc_clock.total * 1e3, "traces_settled": len(settled),
           "recorder_ms": (spent["recorder"] - spent["attribution"]) * 1e3,
           "attribution_ms": spent["attribution"] * 1e3,
           "recorder_ms_per_window":
               (spent["recorder"] - spent["attribution"]) * 1e3
               / max(1, windows),
           "attribution_ms_per_window":
               spent["attribution"] * 1e3 / max(1, windows),
           "stage_counts": {k: v["count"] for k, v in stages.items()},
           "launches": launches}
    log(f"trace soak ({mode}): {requests} requests over {waiting} waiting, "
        f"{windows} windows, {res['requests_per_s']:.0f} requests/s, latency "
        f"p50 {p50:.2f} ms p99 {p99:.2f} ms, GC {res['gc_ms']:.1f} ms, "
        f"{len(settled)} traces settled, recorder "
        f"{res['recorder_ms']:.1f} ms ({res['recorder_ms_per_window']:.3f} a "
        f"window), attribution {res['attribution_ms']:.1f} ms "
        f"({res['attribution_ms_per_window']:.3f} a window)")
    return res


# ---- phase 10: telemetry, SLO burn, incidents, the HTTP surfaces ------------

#: Every route of the HTTP server but the profile's, fetched once at the
#: end of the soak (and by the CPU run, whose statuses they must equal).
OBS_ROUTES = ("/healthz", "/metrics", "/metrics?format=prom", "/debug/traces",
              "/debug/attribution", "/debug/quality", "/debug/placement",
              "/debug/autotune", "/debug/telemetry", "/debug/events",
              "/debug/incidents")

_PROM_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")
_PROM_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prom(text):
    """Prometheus exposition text to ({family: type}, [(name, labels,
    value)]), held to tests/test_observability.py's rules: one TYPE line
    per family, before its samples; well-formed samples and labels; no
    duplicate series; every value a number."""
    types, samples, seen = {}, [], set()
    if not text.endswith("\n"):
        raise AssertionError("prom: the text does not end with a newline")
    for line in text.rstrip("\n").split("\n"):
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if (len(parts) != 4 or parts[2] in types or parts[2] in seen
                    or parts[3] not in ("counter", "gauge", "histogram",
                                        "summary", "untyped")):
                raise AssertionError(f"prom: bad TYPE line {line!r}")
            types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _PROM_SAMPLE.match(line)
        if not m:
            raise AssertionError(f"prom: malformed sample {line!r}")
        name, blob, value = m.group(1), m.group(2) or "", m.group(3)
        labels = _PROM_LABEL.findall(blob)
        if ",".join(f'{k}="{v}"' for k, v in labels) != blob:
            raise AssertionError(f"prom: bad labels {line!r}")
        family = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and types.get(
                    name[:-len(suffix)]) == "histogram":
                family = name[:-len(suffix)]
        if family not in types:
            raise AssertionError(f"prom: {name} has no TYPE line")
        seen.add(family)
        float(value)
        samples.append((name, tuple(sorted(labels)), value))
    keys = [(n, lb) for n, lb, _ in samples]
    if len(keys) != len(set(keys)):
        raise AssertionError("prom: a duplicate series")
    return types, samples


def free_port():
    """A port the OS had free (bound to port 0, then released)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def http_get(session, port, path):
    """(status, body, host ms) of one GET on this loop."""
    t = time.perf_counter()
    async with session.get(f"http://127.0.0.1:{port}{path}") as r:
        text = await r.text()
    return r.status, text, (time.perf_counter() - t) * 1e3


def check_bundles(app, cls, what, n=1):
    """``n`` bundles of trigger class ``cls`` in ``app``'s incident ring,
    each accepted by the port's ``validate_bundle``."""
    from matchmaking_tpu_torch.utils.forensics import validate_bundle

    snap = app.incidents.snapshot(include_bundles=True)
    bundles = [b for b in snap["bundles"] if b["trigger"]["class"] == cls]
    bad = [p for b in bundles for p in validate_bundle(b)]
    if len(bundles) != n or bad:
        raise AssertionError(f"{what}: {len(bundles)} {cls} bundles (want "
                             f"{n}), problems {bad}, by class "
                             f"{snap['by_class']}")
    return bundles


def observability_cfg(Config, path, on, port=0):
    """Config #1 with phase 10's observability: ``on`` the defaults
    (sampler at 1 s, tracing, capture) with ``metrics_port``, an SLO
    target of 100 ms and windows of 1 and 3 s; off, the sampler off and
    no server."""
    import dataclasses

    from matchmaking_tpu_torch.config import ObservabilityConfig

    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    obs = (ObservabilityConfig(slo_target_ms=100.0, slo_fast_window_s=1.0,
                               slo_slow_window_s=3.0) if on
           else ObservabilityConfig(snapshot_interval_s=0.0))
    return dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, warm_start=True),
        observability=obs, metrics_port=port if on else 0)


async def cpu_route_statuses(np, Config, path, seed):
    """Phase 10's (b) configuration on the CPU at a small pool: 256
    requests served, then every route's status."""
    import dataclasses

    import aiohttp

    from matchmaking_tpu_torch.service.app import MatchmakingApp

    port = free_port()
    cfg = observability_cfg(Config, path, True, port)
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, pool_capacity=2048, pool_block=256,
        batch_buckets=(16, 64, 256), warm_start=False))
    rng = np.random.default_rng(seed)
    app = MatchmakingApp(cfg, device="cpu")
    await app.start()
    try:
        replies = Replies(app, "cpu.obs.replies")
        rows = [(f"cpu{k}", json.dumps({"id": f"cpu{k}", "rating": float(
            rng.normal(1500, 300))}).encode()) for k in range(256)]
        await publish_and_wait(app, rows, 64, "cpu.obs.replies", replies)
        app.sample_telemetry()
        async with aiohttp.ClientSession() as session:
            out = {p: (await http_get(session, port, p))[0]
                   for p in OBS_ROUTES}
    finally:
        await app.stop()
    return out


class TimedProfile:
    """``torch.profiler.profile`` as ``/debug/profile`` builds it, with
    the hand kernels' launch counts taken at its start and stop and the
    host ms of its stop and export."""

    def __init__(self, ck, real):
        self.ck, self.real, self.runs = ck, real, []

    def __call__(self, *a, **k):
        prof, rec = self.real(*a, **k), {}
        self.runs.append(rec)
        start, stop, export = prof.start, prof.stop, prof.export_chrome_trace

        def on_start():
            t = time.perf_counter()
            start()
            rec["start_ms"] = (time.perf_counter() - t) * 1e3
            rec["launches_at_start"] = dict(self.ck.LAUNCHES)

        def on_stop():
            rec["launches_at_stop"] = dict(self.ck.LAUNCHES)
            rec["t_stop"] = time.perf_counter()
            stop()

        def on_export(path):
            export(path)
            rec["path"] = path
            rec["stop_export_ms"] = (time.perf_counter() - rec["t_stop"]) * 1e3

        prof.start, prof.stop, prof.export_chrome_trace = (on_start, on_stop,
                                                           on_export)
        return prof


def trace_kernel_counts(path):
    """Each hand kernel's device records in a Chrome trace file."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {k: sum(1 for n in names if k in n) for k in OWN_KERNELS}


async def service_observability(np, ck, mods, path, *, waiting, requests,
                                burst, seed, on, cpu_statuses=None):
    """Config #1's service at full width: ``waiting`` restored, then
    ``requests`` in bursts of ``burst``, unpaced (phase 4's soak), (a) with
    the sampler off and no server, or (b) ``on``: the defaults (sampler at
    1 s, tracing, incident capture), ``metrics_port`` on a free port and
    an SLO target of 100 ms (objective 0.99, windows of 1 and 3 s). During
    (b) a client on the same loop fetches ``/metrics?format=prom`` and
    ``/healthz`` every 100 ms and ``/debug/profile?secs=1`` once after
    the first 4 windows, then every route once at the end. Checks: every
    request answered once; every Prometheus text valid; the pool gauge is
    the waiting count; each route's status the CPU run's; the queue burns
    (a /healthz lists it, a valid ``slo_burn`` bundle); the profile's
    trace names the three hand kernels (counted against the launches its
    capture saw); one block_best and one quality_accum launch a window;
    no fault. Measures requests/s, latency, the scrape's host ms split
    into ``build_report`` and ``_flatten_prom``, the Prometheus bytes, the
    tick's and the capture's host ms, the profile's ms."""
    import dataclasses
    import shutil
    import tempfile

    import aiohttp
    import torch.profiler

    from matchmaking_tpu_torch.service import observability
    from matchmaking_tpu_torch.service.app import MatchmakingApp

    Config, _, RequestColumns, _ = mods
    port = free_port() if on else 0
    cfg = observability_cfg(Config, path, on, port)
    profile_dir = tempfile.mkdtemp(prefix="mm_smoke_profile_")
    cfg = dataclasses.replace(cfg, observability=dataclasses.replace(
        cfg.observability, profile_dir=profile_dir))
    rng = np.random.default_rng(seed)
    t0 = time.time()
    pop = Population(np, rng, waiting + requests, t0, filters=False,
                     glicko2=False)
    queue = cfg.queues[0].name
    spent = {"build_report": [], "flatten_prom": [], "tick": []}
    real_build, real_flatten = (observability.build_report,
                                observability._flatten_prom)

    def build_report(app_):
        t = time.perf_counter()
        try:
            return real_build(app_)
        finally:
            spent["build_report"].append((time.perf_counter() - t) * 1e3)

    def flatten_prom(report):
        t = time.perf_counter()
        try:
            return real_flatten(report)
        finally:
            spent["flatten_prom"].append((time.perf_counter() - t) * 1e3)

    timed_profile = TimedProfile(ck, torch.profiler.profile)
    observability.build_report, observability._flatten_prom = (build_report,
                                                               flatten_prom)
    torch.profiler.profile = timed_profile
    app = MatchmakingApp(cfg, device="cuda")
    real_tick = app.sample_telemetry

    def tick(now=None):
        t = time.perf_counter()
        try:
            return real_tick(now)
        finally:
            spent["tick"].append((time.perf_counter() - t) * 1e3)

    app.sample_telemetry = tick
    polls, routes, profile, pool_bounds, traced = [], {}, {}, (), {}
    try:
        await app.start()
        rt = app.runtime(queue)
        reply = "obs.replies"
        replies = Replies(app, reply)
        app.restore_columns(
            pop.columns(RequestColumns, app.engine, 0, waiting, t0, reply),
            pop.region[:waiting], pop.mode[:waiting], t0)
        if on:
            # The soak starts at a tick: the next one (1 s later) falls
            # inside it, with settled traffic in both burn windows.
            while not len(app.telemetry):
                await asyncio.sleep(0.005)
        windows0 = rt.counters["windows"]
        reset_counts(ck)
        done = asyncio.Event()

        async def client():
            async with aiohttp.ClientSession() as session:
                async def poll():
                    while not done.is_set():
                        prom = await http_get(session, port,
                                              "/metrics?format=prom")
                        health = await http_get(session, port, "/healthz")
                        polls.append((prom, health))
                        await asyncio.sleep(0.1)

                async def take_profile():
                    while rt.counters["windows"] - windows0 < 4:
                        await asyncio.sleep(0.005)
                    profile["windows_at_request"] = (rt.counters["windows"]
                                                     - windows0)
                    profile["response"] = await http_get(
                        session, port, "/debug/profile?secs=1")

                await asyncio.gather(poll(), take_profile())

        poller = asyncio.create_task(client()) if on else None
        soak_s, t_pub = await publish_and_wait(
            app, request_bodies(pop, waiting, waiting + requests), burst,
            reply, replies)
        await settle(app)
        if poller is not None:
            while "response" not in profile and not poller.done():
                await asyncio.sleep(0.01)
            done.set()
            await poller
            # Each hand kernel's records in the profile's Chrome trace.
            traced = {}
            for run in timed_profile.runs:
                traced = trace_kernel_counts(run["path"])
            app.sample_telemetry()
            async with aiohttp.ClientSession() as session:
                for p in OBS_ROUTES:
                    before = rt.engine.pool_size()
                    routes[p] = await http_get(session, port, p)
                    if p == "/metrics?format=prom":
                        pool_bounds = (before, rt.engine.pool_size())
                inc = await http_get(session, port,
                                     "/debug/incidents?bundles=1")
        windows = rt.counters["windows"] - windows0
        launches = dict(ck.LAUNCHES)
        p50, p99 = latency_ms(replies, t_pub)
        capture = app.metrics.latency.get("incident_capture")
    finally:
        observability.build_report, observability._flatten_prom = (
            real_build, real_flatten)
        torch.profiler.profile = timed_profile.real
        shutil.rmtree(profile_dir, ignore_errors=True)
        await app.stop()
    mode = "on" if on else "off"
    check_faults(app, f"observability soak ({mode})")
    for pid in t_pub:
        seq = replies.statuses(pid)
        if seq not in (["queued"], ["matched"], ["queued", "matched"]):
            raise AssertionError(f"observability soak ({mode}): {pid} "
                                 f"answered {seq}")
    if (launches["block_best"] != windows
            or launches["quality_accum"] != windows):
        raise AssertionError(f"observability soak ({mode}): {launches} "
                             f"launches for {windows} windows")
    res = {"mode": mode, "waiting": waiting, "requests": requests,
           "burst": burst, "windows": windows, "soak_s": soak_s,
           "requests_per_s": requests / soak_s, "latency_ms_p50": p50,
           "latency_ms_p99": p99, "launches": launches}
    if not on:
        if len(app.telemetry) or app._observability is not None:
            raise AssertionError("observability soak (off): the sampler or "
                                 "the server ran")
        log(f"observability soak (off): {requests} requests over {waiting} "
            f"waiting, {windows} windows, {res['requests_per_s']:.0f} "
            f"requests/s, latency p50 {p50:.2f} ms p99 {p99:.2f} ms")
        return res
    burning = False
    prom_bytes = []
    for (pstat, ptext, _), (hstat, htext, _) in polls:
        if pstat != 200 or hstat != 200:
            raise AssertionError(f"observability soak: a poll answered "
                                 f"{pstat} / {hstat}")
        _, samples = parse_prom(ptext)
        prom_bytes.append(len(ptext.encode()))
        if len([n for n, _, _ in samples
                if n == "matchmaking_pool_size"]) != 1:
            raise AssertionError("observability soak: no pool gauge")
        burning |= queue in json.loads(htext)["slo_burning_queues"]
    # The pool gauge of the last scrape is the waiting count (read just
    # before and after the scrape: a rescan tick may fall between).
    _, samples = parse_prom(routes["/metrics?format=prom"][1])
    (gauge,) = [float(v) for n, _, v in samples
                if n == "matchmaking_pool_size"]
    if not min(pool_bounds) <= gauge <= max(pool_bounds):
        raise AssertionError(f"observability soak: the pool gauge {gauge} "
                             f"is not the waiting count {pool_bounds}")
    statuses = {p: r[0] for p, r in routes.items()}
    if cpu_statuses is not None and statuses != cpu_statuses:
        raise AssertionError(f"observability soak: route statuses "
                             f"{statuses}, the CPU run's {cpu_statuses}")
    if not burning:
        raise AssertionError("observability soak: no /healthz listed the "
                             "queue as burning")
    bundles = [b for b in json.loads(inc[1])["bundles"]
               if b["trigger"]["class"] == "slo_burn"]
    check_bundles(app, "slo_burn", "observability soak", n=len(bundles))
    if not bundles:
        raise AssertionError("observability soak: no slo_burn bundle")
    status, text, profile_ms = profile["response"]
    if status != 200 or sorted(json.loads(text)) != ["secs", "trace_dir",
                                                     "viewer"]:
        raise AssertionError(f"observability soak: /debug/profile {status} "
                             f"{text}")
    (run,) = timed_profile.runs
    in_capture = {k: run["launches_at_stop"][k] - run["launches_at_start"][k]
                  for k in ("block_best", "quality_accum")}
    if not traced or not all(traced.values()):
        raise AssertionError(f"observability soak: the profile's trace "
                             f"counted {traced}")
    scrape = {k: {"p50": pct(v, 0.5), "p99": pct(v, 0.99), "n": len(v)}
              for k, v in spent.items()}
    res.update({
        "polls": len(polls), "prom_bytes_max": max(prom_bytes),
        "prom_bytes_last": prom_bytes[-1], "scrape_host_ms": scrape,
        "incident_capture_ms": capture.summary_ms() if capture else None,
        "incidents": app.incidents.snapshot()["by_class"],
        "slo_events": [e["kind"] for e in app.events.snapshot()
                       if e["kind"].startswith("slo_")],
        "route_statuses": statuses,
        "profile": {"request_ms": profile_ms, "start_ms": run["start_ms"],
                    "stop_export_ms": run["stop_export_ms"],
                    "windows_at_request": profile["windows_at_request"],
                    "launches_in_capture": in_capture,
                    "trace_kernels": traced},
        "telemetry_snapshots": len(app.telemetry)})
    log(f"observability soak (on): {requests} requests over {waiting} "
        f"waiting, {windows} windows, {res['requests_per_s']:.0f} "
        f"requests/s, latency p50 {p50:.2f} ms p99 {p99:.2f} ms; {len(polls)} "
        f"polls, scrape host ms build_report p50 "
        f"{scrape['build_report']['p50']:.3f} p99 "
        f"{scrape['build_report']['p99']:.3f}, _flatten_prom p50 "
        f"{scrape['flatten_prom']['p50']:.3f} p99 "
        f"{scrape['flatten_prom']['p99']:.3f}, prom {prom_bytes[-1]} bytes; "
        f"tick p50 {scrape['tick']['p50']:.3f} ms p99 "
        f"{scrape['tick']['p99']:.3f} ms ({scrape['tick']['n']} ticks); "
        f"capture {res['incident_capture_ms']}; incidents "
        f"{res['incidents']}; profile {profile_ms:.1f} ms (start "
        f"{run['start_ms']:.1f} ms, stop + export "
        f"{run['stop_export_ms']:.1f} ms), launches in the capture "
        f"{in_capture}, trace kernels {traced}")
    return res


# ---- phase 11: resilience: broker chaos, replication, failover --------------

#: 11a's broker chaos (the request queue only): seeded 1 % drops and
#: duplicates, seq 0's first attempt dropped, seq 1 delivered 1 + 8 times,
#: a partition from publish seq 4,096 to 4,608.
RESILIENCE_CHAOS = dict(seed=7, drop_prob=0.01, dup_prob=0.01, drop_seqs=(0,),
                        dup_seqs=((1, 8),), partitions=((4096, 4608),))
#: The replication hub's lease (s) and the primary's pump cadence.
LEASE_S, PUMP_S = 0.5, 0.02
FAULT_STATS = ("dropped", "duplicated", "delayed", "partitions",
               "dead_lettered")
FAULT_KINDS = ("chaos_drop", "chaos_dup", "partition_pause",
               "partition_resume", "dead_letter")


def resilience_cfg(Config, path, *, journal_dir=None, chaos=None,
                   consume_batch=True, replication=False, owner="primary"):
    """Config #1 with phase 11's knobs: the journal with fsync "none"
    (the disk stays out of it), ``chaos`` on the request queue with
    ``debug_invariants``, replication as primary ``owner``."""
    import dataclasses

    from matchmaking_tpu_torch.config import ChaosConfig, ReplicationConfig

    cfg = durable_cfg(Config, path, journal_dir=journal_dir, fsync="none")
    queue = cfg.queues[0].name
    return dataclasses.replace(
        cfg, broker=dataclasses.replace(cfg.broker, consume_batch=consume_batch),
        chaos=(ChaosConfig(queues=(queue,), **chaos) if chaos
               else ChaosConfig()),
        debug_invariants=chaos is not None,
        replication=(ReplicationConfig(role="primary", owner=owner,
                                       pump_interval_s=PUMP_S)
                     if replication else ReplicationConfig()))


def check_answers(replies, pids, what):
    """Every request answered (queued and/or matched), and nobody in two
    matches."""
    for pid in pids:
        if set(replies.statuses(pid)) - {"queued", "matched"} or not (
                replies.statuses(pid)):
            raise AssertionError(f"{what}: {pid} answered "
                                 f"{replies.statuses(pid)}")
    twice = [p for p, ids in replies.matched().items() if len(ids) > 1]
    if twice:
        raise AssertionError(f"{what}: {len(twice)} players in two matches")


async def service_chaos(np, ck, mods, path, *, waiting, requests, burst,
                        seed):
    """11a. Config #1's service at full width, ``waiting`` restored, then
    ``requests`` in bursts of ``burst``: twice with ``RESILIENCE_CHAOS``
    and ``debug_invariants`` (the fault stats and fault events of both
    runs equal, no invariant violated, every request answered, nothing
    dead-lettered), then without chaos on the burst path and on the
    per-delivery path (``consume_batch`` off: the path consume faults
    force). Requests/s and latency p50/p99 of each."""
    from matchmaking_tpu_torch.service.app import MatchmakingApp

    Config, _, RequestColumns, _ = mods
    rng = np.random.default_rng(seed)
    t0 = time.time()
    pop = Population(np, rng, waiting + requests, t0, filters=False,
                     glicko2=False)
    reply = "chaos.replies"
    runs = {}
    for name, chaos, batch in (("chaos_1", RESILIENCE_CHAOS, True),
                               ("chaos_2", RESILIENCE_CHAOS, True),
                               ("off", None, True),
                               ("off_per_delivery", None, False)):
        cfg = resilience_cfg(Config, path, chaos=chaos, consume_batch=batch)
        app = MatchmakingApp(cfg, device="cuda")
        await app.start()
        replies = Replies(app, reply)
        fill = pop.columns(RequestColumns, app.engine, 0, waiting, t0, reply)
        app.restore_columns(fill, pop.region[:waiting], pop.mode[:waiting], t0)
        rt = app.runtime(cfg.queues[0].name)
        reset_counts(ck)
        soak_s, t_pub = await publish_and_wait(
            app, request_bodies(pop, waiting, waiting + requests), burst,
            reply, replies)
        await settle(app)
        launches = dict(ck.LAUNCHES)
        p50, p99 = latency_ms(replies, t_pub)
        check_answers(replies, t_pub, f"11a {name}")
        check_faults(app, f"11a {name}")
        stats = app.broker.stats
        kinds = [e["kind"] for e in app.events.snapshot()]
        runs[name] = {
            "requests_per_s": requests / soak_s, "soak_s": soak_s,
            "latency_ms_p50": p50, "latency_ms_p99": p99,
            "windows": rt.counters["windows"],
            "deduped_replays": rt.counters["deduped_replays"],
            "fault_stats": {k: stats[k] for k in FAULT_STATS},
            "fault_events": {k: kinds.count(k) for k in FAULT_KINDS},
            "launches": launches}
        await app.stop()
        if launches["block_best"] == 0 or (launches["quality_accum"]
                                           != launches["block_best"]):
            raise AssertionError(f"11a {name}: launches {launches}")
    a, b = runs["chaos_1"], runs["chaos_2"]
    if (a["fault_stats"] != b["fault_stats"]
            or a["fault_events"] != b["fault_events"]):
        raise AssertionError(f"11a: the chaos runs differ: {a['fault_stats']} "
                             f"{a['fault_events']} vs {b['fault_stats']} "
                             f"{b['fault_events']}")
    fs = a["fault_stats"]
    if (fs["dead_lettered"] or fs["partitions"] != 1 or fs["dropped"] < 1
            or fs["duplicated"] < 8):
        raise AssertionError(f"11a: fault stats {fs}")
    log("11a broker chaos: " + ", ".join(
        f"{n} {r['requests_per_s']:.0f} requests/s p50 "
        f"{r['latency_ms_p50']:.2f} ms p99 {r['latency_ms_p99']:.2f} ms"
        for n, r in runs.items()) + f"; faults {fs}, events "
        f"{a['fault_events']} (equal in both chaos runs)")
    return runs


class StandbyPump:
    """A standby pumped every ``interval`` s on the loop, beside the
    primary's own pump task: the lag in records at each pump, the tap's,
    the primary pump's and the standby's apply host time (their calls
    wrapped; the in-process standby applies on the service's own loop),
    and, while a link partition holds, the lag and
    ``unacked_admit_players``."""

    def __init__(self, rt, standby, interval=PUMP_S, track_unacked=False):
        self.rt, self.standby = rt, standby
        self.lags, self.partition_lags = [], []
        self.tap_s = self.pump_s = self.apply_s = 0.0
        self.taps = self.pumps = 0
        self.peak_unacked = 0
        self.track_unacked = track_unacked
        real_tap, repl = rt.journal.tap, rt.replication
        real_pump = repl.pump

        def tap(seq, rtype, payload):
            t = time.perf_counter()
            real_tap(seq, rtype, payload)
            self.tap_s += time.perf_counter() - t
            self.taps += 1

        def pump(now):
            t = time.perf_counter()
            real_pump(now)
            self.pump_s += time.perf_counter() - t
            self.pumps += 1
        rt.journal.tap, repl.pump = tap, pump
        self.task = asyncio.ensure_future(self._run(interval))

    async def _run(self, interval):
        repl = self.rt.replication
        while True:
            await asyncio.sleep(interval)
            t = time.perf_counter()
            self.standby.pump()
            self.apply_s += time.perf_counter() - t
            self.lags.append(repl.lag())
            if self.standby.link._partitioned:
                self.partition_lags.append(repl.lag())
                if self.track_unacked:
                    self.peak_unacked = max(self.peak_unacked,
                                            repl.unacked_admit_players())

    async def quiesce(self, timeout=60.0):
        end = time.monotonic() + timeout
        while not self.rt.replication.quiescent:
            if time.monotonic() > end:
                raise AssertionError("replication did not quiesce")
            await asyncio.sleep(0.01)

    def stop(self):
        self.task.cancel()

    def summary(self):
        lags = sorted(self.lags) or [0]
        return {"lag_records_p50": statistics.median(lags),
                "lag_records_p99": pct(lags, 0.99),
                "lag_records_max": lags[-1], "pumps_seen": len(self.lags),
                "tap_us_per_record": self.tap_s / max(1, self.taps) * 1e6,
                "records": self.taps,
                "pump_ms": self.pump_s / max(1, self.pumps) * 1e3,
                "primary_pumps": self.pumps,
                "standby_apply_ms_total": self.apply_s * 1e3}


def check_replication(app, rt, standby, what):
    """The shadow is the pool, and nothing on the replication path failed
    (a tap or a send that raised, a pump error)."""
    errors = (rt.journal.tap_errors, rt.replication.send_errors,
              rt.counters["replication_pump_errors"])
    if any(errors):
        raise AssertionError(f"{what}: tap/send/pump errors {errors}")
    pool = set(rt.engine.pool._slot_of)
    shadow = set(standby.shadow.waiting)
    if pool != shadow:
        raise AssertionError(f"{what}: the shadow differs from the pool in "
                             f"{len(pool ^ shadow)} players")
    if standby.applied_seq != rt.journal.seq:
        raise AssertionError(f"{what}: applied {standby.applied_seq}, "
                             f"journal at {rt.journal.seq}")
    check_faults(app, what)


async def service_replication(np, torch, ck, mods, path, *, waiting,
                              requests, burst, seed):
    """11b-11d. Config #1's service at full width with the journal on
    (fsync "none"). The 100k waiting come from a journal: one app restores
    and anchors them, then crashes; each leg recovers a copy of that
    directory at its start. 11b: replication off and on in turns, two
    rounds each (on: an in-process hub, a standby pumped every
    ``PUMP_S``): requests/s and latency of ``requests`` in bursts of
    ``burst``; on: the lag in records (p50/p99 over the pumps), the tap's
    host µs a record, a pump's host ms, the baseline's bytes and host ms
    at 100k waiting, and the shadow equal to the pool. 11c, on the last
    on leg: a second stream crashed after its 4th window; the standby
    takes over at a scripted time; a successor on the card adopts the
    shadow (RTO and its split); the adopted pool is the shadow's and the
    primary's mirror at the crash; the fenced ex-primary's append raises
    and its publish is refused and counted; matched players' redeliveries
    replay their bodies; 1,024 new requests under torch.profiler launch
    block_best and quality_accum (the device's count equals the launch
    count); nobody is matched by both apps. 11d: a soak of 8,192 with
    ``repl_*`` link faults (a drop, a duplicate, a delay, one partition)
    relative to the baseline's seq: the lag during the partition, the
    peak ``unacked_admit_players``, and the shadow equal to the pool
    after the heal."""
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from matchmaking_tpu_torch.config import ChaosConfig
    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.replication import ReplicationHub
    from matchmaking_tpu_torch.utils.journal import FencedError

    Config, _, RequestColumns, _ = mods
    rng = np.random.default_rng(seed)
    t0 = time.time()
    second, fresh_n, faults_n = 8_192, 1_024, 8_192
    pop = Population(np, rng, waiting + requests + second + fresh_n
                     + 512 + faults_n, t0, filters=False, glicko2=False)
    work = tempfile.mkdtemp(prefix="mm_repl_")
    seed_dir = os.path.join(work, "seed")
    reply = "repl.replies"
    res: dict = {"legs": []}
    try:
        # The 100k in a journal: restored, anchored, crashed.
        cfg0 = resilience_cfg(Config, path, journal_dir=seed_dir)
        queue = cfg0.queues[0].name
        app0 = MatchmakingApp(cfg0, device="cuda")
        await app0.start()
        fill = pop.columns(RequestColumns, app0.engine, 0, waiting, t0, reply)
        app0.restore_columns(fill, pop.region[:waiting], pop.mode[:waiting],
                             t0)
        await app0.runtime(queue).compact_journal()
        await app0.crash()
        del app0

        def leg_app(name, on, hub=None, owner="hostA"):
            jdir = os.path.join(work, name)
            if os.path.exists(seed_dir) and name.startswith("leg"):
                shutil.copytree(seed_dir, jdir)
            return MatchmakingApp(
                resilience_cfg(Config, path, journal_dir=jdir, replication=on,
                               owner=owner),
                device="cuda", replication_hub=hub)

        # ---- 11b: off and on in turns ---------------------------------
        keep = None
        for i, on in enumerate((False, True, False, True)):
            hub = ReplicationHub(lease_s=LEASE_S) if on else None
            app = leg_app(f"leg{i}", on, hub)
            t = time.perf_counter()
            await app.start()
            start_ms = (time.perf_counter() - t) * 1e3
            rt = app.runtime(queue)
            rec = rt.last_recovery
            if rec is None or rec["snapshot_players"] != waiting:
                raise AssertionError(f"11b leg {i}: recovered {rec}")
            meter = standby = None
            baseline_apply_ms = None
            if on:
                standby = hub.standby(queue, owner="hostB")
                # The baseline applied before the soak (a standby that
                # attached before the traffic).
                t = time.perf_counter()
                standby.pump()
                baseline_apply_ms = (time.perf_counter() - t) * 1e3
                meter = StandbyPump(rt, standby)
            replies = Replies(app, reply)
            reset_counts(ck)
            soak_s, t_pub = await publish_and_wait(
                app, request_bodies(pop, waiting, waiting + requests), burst,
                reply, replies)
            await settle(app)
            launches = dict(ck.LAUNCHES)
            p50, p99 = latency_ms(replies, t_pub)
            check_answers(replies, t_pub, f"11b leg {i}")
            leg = {"replication": on, "requests_per_s": requests / soak_s,
                   "latency_ms_p50": p50, "latency_ms_p99": p99,
                   "start_ms": start_ms, "recovery_rto_ms": rec["rto_ms"],
                   "windows": rt.counters["windows"], "launches": launches}
            if on:
                await meter.quiesce()
                standby.pump()
                check_replication(app, rt, standby, f"11b leg {i}")
                leg.update(meter.summary())
                leg["baseline"] = dict(rt.last_baseline,
                                       standby_apply_ms=baseline_apply_ms)
                if rt.last_baseline["players"] != waiting:
                    raise AssertionError(f"11b: baseline {rt.last_baseline}")
            else:
                check_faults(app, f"11b leg {i}")
            res["legs"].append(leg)
            if i < 3:
                if meter is not None:
                    meter.stop()
                await app.stop()
                if on:
                    standby.pump()
                    if not standby.shadow.clean:
                        raise AssertionError("11b: no CLEAN on the stream")
            else:
                keep = (app, rt, hub, standby, meter, replies)
        offs = [leg for leg in res["legs"] if not leg["replication"]]
        ons = [leg for leg in res["legs"] if leg["replication"]]
        log("11b replication off/on in turns: " + ", ".join(
            f"{'on' if leg['replication'] else 'off'} "
            f"{leg['requests_per_s']:.0f}/s p50 {leg['latency_ms_p50']:.2f} "
            f"p99 {leg['latency_ms_p99']:.2f} ms" for leg in res["legs"])
            + f"; lag p50/p99 {[(o['lag_records_p50'], o['lag_records_p99']) for o in ons]} "
            f"records, tap {[round(o['tap_us_per_record'], 2) for o in ons]} "
            f"µs a record, pump {[round(o['pump_ms'], 4) for o in ons]} ms, "
            f"standby apply {[round(o['standby_apply_ms_total'], 1) for o in ons]} "
            f"ms a soak (on the service's loop), "
            f"baseline {ons[0]['baseline']}")
        del offs

        # ---- 11c: failover ----------------------------------------------
        app, rt, hub, standby, meter, replies = keep
        lo = waiting + requests
        rows = request_bodies(pop, lo, lo + second)
        state: dict = {}
        real_admit = rt._journal_admit_cols

        def admit_then_crash(cols):
            real_admit(cols)
            state["windows"] = state.get("windows", 0) + 1
            if state["windows"] == 4:
                state["in_flight"] = app.engine.inflight()
                state["mirror"] = set(rt.engine.pool._slot_of)
                crash = app.crash()
                try:
                    crash.send(None)
                except StopIteration:
                    pass
                raise Crashed()
        rt._journal_admit_cols = admit_then_crash
        sent = []
        from matchmaking_tpu_torch.service.broker import Properties
        for b in range(0, second, burst):
            for pid, body in rows[b:b + burst]:
                sent.append((pid, body))
                app.broker.publish(queue, body, Properties(
                    reply_to=reply, correlation_id=pid))
            await asyncio.sleep(0.004)
            if "in_flight" in state:
                break
        if not state.get("in_flight"):
            raise AssertionError(f"11c: no window in flight at the crash "
                                 f"({state})")
        flusher = rt._batcher._task
        await asyncio.sleep(0.01)
        if flusher.done() and not flusher.cancelled():
            flusher.exception()  # the Crashed it ended with, retrieved
        meter.stop()
        matched_before = replies.matched()
        answered_before = sum(len(v) for v in replies.got.values())
        t = time.perf_counter()
        epoch = standby.takeover(time.monotonic() + LEASE_S + 0.05)
        takeover_ms = (time.perf_counter() - t) * 1e3
        shadow = set(standby.shadow.waiting)
        if epoch != 2 or not rt.replication.superseded():
            raise AssertionError(f"11c: epoch {epoch}")
        try:
            rt.journal.append_admits([["zz", 1500.0, 350.0, "*", "*", None,
                                       t0, reply, "zz", 0, 0.0]])
            raise AssertionError("11c: the fenced primary appended")
        except FencedError:
            pass
        rt._publish(reply, "zz", b"{}")
        refused = rt.counters["fenced_publish_refused"]
        if (refused != 1 or rt.replication.role != "fenced"
                or sum(len(v) for v in replies.got.values())
                != answered_before):
            raise AssertionError(f"11c: the fenced primary published "
                                 f"({refused} refused)")
        if shadow != state["mirror"] or shadow & set(matched_before):
            raise AssertionError(
                f"11c: the shadow ({len(shadow)}) differs from the mirror at "
                f"the crash ({len(state['mirror'])}) in "
                f"{len(shadow ^ state['mirror'])} players")
        app2 = leg_app("successor", True, hub, owner="hostB")
        t = time.perf_counter()
        await app2.start()
        start2_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        torch.cuda.synchronize()
        drain_ms = (time.perf_counter() - t) * 1e3
        rt2 = app2.runtime(queue)
        rec = rt2.last_recovery
        adopted = set(rt2.engine.pool._slot_of)
        active = int(rt2.engine.dev_pool["active"].sum())
        if (rec is None or rec.get("source") != "replica" or adopted != shadow
                or active != len(adopted)):
            raise AssertionError(f"11c: adopted {len(adopted)} ({active} "
                                 f"active), shadow {len(shadow)}, {rec}")
        replies2 = Replies(app2, reply)
        # The matched players' redeliveries replay their bodies.
        again = [(pid, body) for pid, body in sent if pid in matched_before]
        again = again[:512]
        for pid, body in again:
            app2.broker.publish(queue, body, Properties(reply_to=reply,
                                                        correlation_id=pid))
        end = time.monotonic() + 60.0
        while (not all(p in replies2.got for p, _ in again)
               and time.monotonic() < end):
            await asyncio.sleep(0.01)
        for pid, _ in again:
            first = [bd for _, bd in replies.got[pid]
                     if json.loads(bd)["status"] == "matched"][0]
            if replies2.got.get(pid, [(0, b"")])[0][1] != first:
                raise AssertionError(f"11c: {pid}'s replay differs")
        await settle(app2)
        # 1,024 new requests on the successor, under the profiler.
        lo2 = lo + second
        fresh = request_bodies(pop, lo2, lo2 + fresh_n)
        reset_counts(ck)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            profiler_lead_in(torch)
            await publish_and_wait(app2, fresh, fresh_n, reply, replies2)
            await settle(app2)
            torch.cuda.synchronize()
        launches2 = dict(ck.LAUNCHES)
        own = {name: 0 for name in OWN_KERNELS}
        for e in prof.key_averages():
            for name in OWN_KERNELS:
                if name in e.key:
                    own[name] += e.count
        lead = lead_in_seen(prof)
        if (launches2["block_best"] == 0
                or launches2["quality_accum"] != launches2["block_best"]
                or own["block_best_kernel"] != launches2["block_best"]
                or own["quality_accum_kernel"] != launches2["quality_accum"]):
            raise AssertionError(f"11c: successor launches {launches2}, the "
                                 f"device ran {own} (and {lead} of the "
                                 f"{LEAD_IN_KERNELS} lead-in kernels)")
        log(f"11c successor's profiled session: the profiler kept {lead} of "
            f"the {LEAD_IN_KERNELS} lead-in kernels, every own kernel {own}")
        check_answers(replies2, [p for p, _ in fresh], "11c successor")
        both = {p: set(v) for p, v in matched_before.items()}
        for p, ids in replies2.matched().items():
            both.setdefault(p, set()).update(ids)
        twice = [p for p, ids in both.items() if len(ids) > 1]
        if twice:
            raise AssertionError(f"11c: {len(twice)} players matched by both "
                                 f"apps")
        check_faults(app2, "11c successor")
        (bundle,) = check_bundles(app2, "failover", "11c successor")
        await app2.stop()
        res["failover"] = {
            "in_flight_at_crash": state["in_flight"],
            "sent_before_crash": len(sent),
            "matched_before_crash": len(matched_before),
            "takeover_ms": takeover_ms, "epoch": epoch,
            "shadow_players": len(shadow), "adopted_players": len(adopted),
            "rto_ms": rec["rto_ms"], "split_ms": rec["split_ms"],
            "successor_start_ms": start2_ms,
            "device_drain_after_start_ms": drain_ms,
            "dedup_entries": rec["dedup_entries"],
            "replays_checked": len(again),
            "fenced_publish_refused": refused,
            "incident_capture_ms": bundle["capture_ms"],
            "launches": launches2, "device_kernels": own}
        log(f"11c failover: crash with {state['in_flight']} windows in "
            f"flight; takeover {takeover_ms:.2f} ms (epoch {epoch}); the "
            f"successor adopted {len(adopted)} (= the shadow = the mirror), "
            f"rto {rec['rto_ms']:.1f} ms {rec['split_ms']}, {len(again)} "
            f"replays equal, fenced publish refused, successor launches "
            f"{launches2} = device {own}")

        # ---- 11d: link faults ---------------------------------------------
        base = ons[0]["baseline"]["seq"]
        script = ChaosConfig(
            queues=(queue,), repl_drop_seqs=(base + 3,),
            repl_dup_seqs=(base + 5,), repl_delay_seqs=((base + 7, 2),),
            repl_partitions=((base + 8, base + 16),))
        hub = ReplicationHub(lease_s=LEASE_S, chaos=script)
        app = leg_app("leg_faults", True, hub)
        await app.start()
        rt = app.runtime(queue)
        if rt.last_baseline["seq"] != base:
            raise AssertionError(f"11d: baseline seq {rt.last_baseline}, "
                                 f"11b's {base}")
        standby = hub.standby(queue, owner="hostB")
        standby.pump()  # the baseline, before the traffic
        meter = StandbyPump(rt, standby, track_unacked=True)
        replies = Replies(app, reply)
        lo3 = lo2 + fresh_n + 512
        reset_counts(ck)
        soak_s, t_pub = await publish_and_wait(
            app, request_bodies(pop, lo3, lo3 + faults_n), burst, reply,
            replies)
        await settle(app)
        launches3 = dict(ck.LAUNCHES)
        check_answers(replies, t_pub, "11d")
        await meter.quiesce()
        standby.pump()
        meter.stop()
        check_replication(app, rt, standby, "11d")
        link = dict(standby.link.counters)
        if not (link.get("dropped") and link.get("dup") and link.get("delayed")
                and link.get("partitions") == 1 and link.get("retransmits")):
            raise AssertionError(f"11d: link counters {link}")
        plags = sorted(meter.partition_lags) or [0]
        res["link_faults"] = {
            "requests_per_s": faults_n / soak_s, "link": link,
            "partition_lag_records_max": plags[-1],
            "partition_lag_records_p50": statistics.median(plags),
            "peak_unacked_admit_players": meter.peak_unacked,
            "applier": dict(standby.counters), "launches": launches3,
            **{k: v for k, v in meter.summary().items()
               if k.startswith("lag_")}}
        await app.stop()
        log(f"11d link faults: {link}; lag during the partition up to "
            f"{plags[-1]} records, peak unacked_admit_players "
            f"{meter.peak_unacked}; the shadow converged to the pool")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return res


# ---- phase 12: the socket transport under replication and the lease ---------

#: Phase 12's lease (s): a renewal is confirmed every pump (20 ms), so only
#: a stall of the primary's loop longer than the budgeted lease (lease_s -
#: lease_rtt_budget_s) fences it. The stalls phase 11 measured: the 100k
#: baseline, 223-412 ms; an adoption, 1.6-1.9 s (before the successor's
#: acquire, so not inside a lease).
NET_LEASE_S = 3.0
#: Phase 12's frame and send buffer limits, on both sides: the 100k
#: baseline's frame is ~13 MB (9.6 MB of JSON in base64), past the
#: defaults (1 MiB a frame, 4 MiB of send buffer), which drop it.
NET_LIMITS = dict(max_frame_bytes=32 << 20, send_buffer_bytes=32 << 20)
#: Runs of 12c's soak (JAX's geometry: pool 4,096, 3 cycles, 6 pairs + 3
#: singles + 2 late singles a cycle, seed 29). Once: two runs took phase
#: 12 to 114 s; the CPU test holds the two-run digest identity.
NET_SOAK_RUNS = 1
#: The IO thread's name (net/transport.py).
NET_IO_THREAD = "mm-torch-net-io"


async def arpc(child, cmd, timeout=120.0, **kw):
    """A child's command from the event loop, without blocking it (the
    primary's pump and renewals run on that loop)."""
    return await asyncio.to_thread(child.rpc, cmd, timeout, **kw)


class LoopStalls:
    """The longest stall of the event loop: a task that sleeps 5 ms and
    records how much later than that it wakes."""

    def __init__(self, tick=0.005):
        self.tick, self.max_ms = tick, 0.0
        self.task = asyncio.ensure_future(self._run())

    async def _run(self):
        while True:
            t = time.perf_counter()
            await asyncio.sleep(self.tick)
            late = (time.perf_counter() - t - self.tick) * 1e3
            self.max_ms = max(self.max_ms, late)

    def stop(self):
        self.task.cancel()
        return self.max_ms


class FrameClock:
    """Host time spent on frames of at least ``min_bytes`` (the baseline's):
    base64 and ``pack_msg`` in net/link.py, ``encode_frame`` in
    net/transport.py, wrapped while the clock is open; each entry is
    (step, thread, ms, bytes)."""

    def __init__(self, link_mod, transport_mod, min_bytes=1 << 20):
        import base64
        import threading
        import types

        self.entries = []
        self._mods = (link_mod, transport_mod)
        self._saved = (link_mod.pack_msg, link_mod.base64,
                       transport_mod.encode_frame)

        def timed(step, fn, size):
            def wrapper(*a, **kw):
                t = time.perf_counter()
                out = fn(*a, **kw)
                n = size(a, out)
                if n >= min_bytes:
                    self.entries.append(
                        (step, threading.current_thread().name,
                         (time.perf_counter() - t) * 1e3, n))
                return out
            return wrapper

        link_mod.pack_msg = timed("pack_msg", link_mod.pack_msg,
                                  lambda a, out: len(out))
        link_mod.base64 = types.SimpleNamespace(
            b64encode=timed("b64encode", base64.b64encode,
                            lambda a, out: len(a[0])),
            b64decode=base64.b64decode)
        transport_mod.encode_frame = timed(
            "encode_frame", transport_mod.encode_frame,
            lambda a, out: len(out))

    def close(self):
        link_mod, transport_mod = self._mods
        (link_mod.pack_msg, link_mod.base64,
         transport_mod.encode_frame) = self._saved

    def frames(self):
        """(the IO thread's ms, frame bytes, thread) of each large frame
        written to a connection, in send order: its base64, pack and
        encode (a frame drained with no connection up has no encode)."""
        out, cur = [], None
        for step, thread, ms, n in self.entries:
            if step == "b64encode":
                cur = [0.0, 0, thread]
                out.append(cur)
            if cur is not None:
                cur[0] += ms
                if step == "encode_frame":
                    cur[1] = n
        return [tuple(f) for f in out if f[1]]


class SocketMeter:
    """The primary's side of a socket-replicated soak: the lag in records
    every 20 ms and the tap's host time a record (the journal's tap
    wrapped)."""

    def __init__(self, rt, interval=PUMP_S):
        self.rt, self.lags = rt, []
        self.tap_s, self.taps = 0.0, 0
        real_tap = rt.journal.tap

        def tap(seq, rtype, payload):
            t = time.perf_counter()
            real_tap(seq, rtype, payload)
            self.tap_s += time.perf_counter() - t
            self.taps += 1
        rt.journal.tap = tap
        self.task = asyncio.ensure_future(self._run(interval))

    async def _run(self, interval):
        while True:
            await asyncio.sleep(interval)
            self.lags.append(self.rt.replication.lag())

    async def quiesce(self, timeout=60.0):
        end = time.monotonic() + timeout
        while not self.rt.replication.quiescent:
            if time.monotonic() > end:
                raise AssertionError(
                    f"replication did not quiesce: sent "
                    f"{self.rt.replication.sent_seq}, acked "
                    f"{self.rt.replication.acked_seq}")
            await asyncio.sleep(0.01)

    def stop(self):
        self.task.cancel()

    def summary(self):
        lags = sorted(self.lags) or [0]
        return {"lag_records_p50": statistics.median(lags),
                "lag_records_p99": pct(lags, 0.99),
                "lag_records_max": lags[-1], "pumps_seen": len(self.lags),
                "tap_us_per_record": self.tap_s / max(1, self.taps) * 1e6,
                "records": self.taps}


def check_socket_turn(app, rt, hub, rep, what):
    """A clean turn: the child's shadow is the pool at the journal's seq,
    and nothing on the replication path or the wire failed (tap, send,
    pump, frame, liveness, lease request, fence)."""
    from matchmaking_tpu_torch.net.failover_proc import _digest

    pool = set(rt.engine.pool._slot_of)
    if (rep.get("shadow_digest") != _digest(pool)
            or rep.get("shadow_n") != len(pool)):
        raise AssertionError(f"{what}: the child's shadow ({rep.get('shadow_n')}"
                             f") differs from the pool ({len(pool)})")
    if rep.get("applied_seq") != rt.journal.seq:
        raise AssertionError(f"{what}: the child applied "
                             f"{rep.get('applied_seq')}, journal at "
                             f"{rt.journal.seq}")
    link = dict(rt.replication.link.counters)
    slink = rep.get("standby_link", {})
    bad = {
        "tap_errors": rt.journal.tap_errors,
        "send_errors": rt.replication.send_errors,
        "replication_pump_errors": rt.counters["replication_pump_errors"],
        "link_send_errors": link.get("send_errors", 0),
        "frame_errors": link.get("frame_errors", 0)
        + slink.get("frame_errors", 0),
        "liveness_lost": link.get("liveness_lost", 0)
        + slink.get("liveness_lost", 0),
        "rpc_timeouts": hub.authority.counters.get("rpc_timeouts", 0),
        "replication_fenced": app.metrics.counters.get("replication_fenced"),
    }
    if any(bad.values()):
        raise AssertionError(f"{what}: {bad}")
    check_faults(app, what)
    return link, slink


async def wait_baseline(child, seq, sent_at, what, timeout=60.0):
    """Poll the child (every 10 ms) until it applied the baseline of
    ``seq``; the ms since ``sent_at`` (monotonic, one clock for both
    processes)."""
    end = time.monotonic() + timeout
    while True:
        rep = await arpc(child, "report")
        if (rep.get("applied_seq", 0) >= seq
                and rep.get("applier", {}).get("snapshots")):
            return (time.monotonic() - sent_at) * 1e3, rep
        if time.monotonic() > end:
            raise AssertionError(f"{what}: the baseline never applied: {rep}")
        await asyncio.sleep(0.01)


async def service_network(np, torch, ck, mods, path, *, waiting, requests,
                          burst, seed, soak_runs):
    """12a-12c. Config #1's service at full width with the journal on
    (fsync "none"), the 100k recovered from a journal at each start, its
    lease held at a ``failover_proc lease`` child and its standby a
    ``failover_proc host`` child on the card (``--device cuda``), both
    over UDS, frame and send buffer limits ``NET_LIMITS`` on both sides.
    12a: replication off and over the socket in turns, two rounds each
    (``requests`` in bursts of ``burst``): requests/s, p50/p99, the lag
    in records, the tap's µs a record, the IO thread's ms for the
    baseline frame and its bytes, send → the child's applied baseline,
    the link's counters and the loop's longest stall after the start (the
    baseline's own, inside the start, is ``last_baseline["ms"]``); the
    child's shadow is the pool, and no error, liveness loss, lease timeout
    or fence.
    12b: the JAX soak's cycle-0 script on the fwd flow (seqs relative to
    the baseline's): the link reconnects, re-sends the baseline and
    converges, every record applied once; then a crash after the 4th
    window of a second stream, the child's takeover after the real lease
    expiry, the fenced ex-primary refused at both seams, the child serving
    config #1 on the card adopting its shadow (RTO and split; the epoch
    the takeover's), 1,024 requests through the child launching both
    kernels there (its counts), the kernels against their plain versions
    on the child's pool, and nobody matched by both. 12c: the
    cross-process soak (``failover_proc.soak``, JAX's geometry) with its
    hosts on the card, ``soak_runs`` times: JAX's gates, one digest."""
    import dataclasses
    import shutil
    import tempfile

    from matchmaking_tpu_torch.config import ChaosConfig, NetConfig
    from matchmaking_tpu_torch.net import failover_proc
    from matchmaking_tpu_torch.net import link as net_link
    from matchmaking_tpu_torch.net import transport as net_transport
    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.broker import Properties
    from matchmaking_tpu_torch.service.replication import QueueReplication
    from matchmaking_tpu_torch.utils.journal import FencedError

    Config, _, RequestColumns, _ = mods
    rng = np.random.default_rng(seed)
    t0 = time.time()
    faults_n, second, fresh_n = 4_096, 8_192, 1_024
    pop = Population(np, rng, waiting + requests + faults_n + second
                     + fresh_n, t0, filters=False, glicko2=False)
    # A short base: UDS paths stay far under 108 bytes.
    work = tempfile.mkdtemp(prefix="mmnet")
    seed_dir = os.path.join(work, "seed")
    reply = "net.replies"
    lease_addr = f"unix:{work}/lease.sock"
    net = NetConfig(transport="socket", lease_addr=lease_addr, **NET_LIMITS)
    children = []
    res: dict = {"legs": [], "lease_s": NET_LEASE_S, "limits": NET_LIMITS}

    def spawn(name, argv):
        c = failover_proc.Child(name, argv)
        children.append(c)
        return c

    try:
        cfg0 = resilience_cfg(Config, path, journal_dir=seed_dir)
        queue = cfg0.queues[0].name
        # The lease service and the three standbys start beside the seed.
        lease = spawn("lease", ["lease", "--lease-addr", lease_addr,
                                "--lease-s", str(NET_LEASE_S)])
        hosts = {name: spawn(name, failover_proc.host_argv(
            name, queue=queue, lease_addr=lease_addr, lease_s=NET_LEASE_S,
            seed=seed, device="cuda", net=net))
            for name in ("standby1", "standby3", "successor")}
        app0 = MatchmakingApp(cfg0, device="cuda")
        await app0.start()
        fill = pop.columns(RequestColumns, app0.engine, 0, waiting, t0, reply)
        app0.restore_columns(fill, pop.region[:waiting], pop.mode[:waiting],
                             t0)
        await app0.runtime(queue).compact_journal()
        await app0.crash()
        del app0
        for c in children:
            await asyncio.to_thread(c.wait_ev, "ready", 120.0)

        def leg_cfg(name, on, target=None, chaos=None, owner="hostA"):
            jdir = os.path.join(work, name)
            shutil.copytree(seed_dir, jdir)
            cfg = resilience_cfg(Config, path, journal_dir=jdir,
                                 replication=on, owner=owner)
            if on:
                cfg = dataclasses.replace(
                    cfg, net=dataclasses.replace(net, repl_target=target),
                    chaos=chaos or ChaosConfig())
            return cfg

        sent_at = []
        real_send_baseline = QueueReplication.send_baseline

        def send_baseline(self, seq, payload):
            sent_at.append(time.monotonic())
            real_send_baseline(self, seq, payload)
        QueueReplication.send_baseline = send_baseline

        # ---- 12a: off and over the socket in turns ---------------------
        for i, on in enumerate((False, True, False, True)):
            child = hosts.get(f"standby{i}")
            listen = f"unix:{work}/s{i}.sock"
            if on:
                await arpc(child, "standby", listen=listen)
            app = MatchmakingApp(leg_cfg(f"leg{i}", on, target=listen),
                                 device="cuda")
            clock = FrameClock(net_link, net_transport) if on else None
            sent_at.clear()
            t = time.perf_counter()
            await app.start()
            start_ms = (time.perf_counter() - t) * 1e3
            stalls = LoopStalls()
            rt = app.runtime(queue)
            rec = rt.last_recovery
            if rec is None or rec["snapshot_players"] != waiting:
                raise AssertionError(f"12a leg {i}: recovered {rec}")
            leg = {"replication": on, "start_ms": start_ms}
            if on:
                hub = app.replication_hub
                cross_ms, _ = await wait_baseline(
                    child, rt.last_baseline["seq"], sent_at[0],
                    f"12a leg {i}")
                meter = SocketMeter(rt)
            replies = Replies(app, reply)
            reset_counts(ck)
            soak_s, t_pub = await publish_and_wait(
                app, request_bodies(pop, waiting, waiting + requests), burst,
                reply, replies)
            await settle(app)
            launches = dict(ck.LAUNCHES)
            p50, p99 = latency_ms(replies, t_pub)
            check_answers(replies, t_pub, f"12a leg {i}")
            leg.update(requests_per_s=requests / soak_s, latency_ms_p50=p50,
                       latency_ms_p99=p99, windows=rt.counters["windows"],
                       launches=launches)
            if on:
                await meter.quiesce()
                meter.stop()
                rep = await arpc(child, "report")
                link, slink = check_socket_turn(app, rt, hub, rep,
                                                f"12a leg {i}")
                frames = clock.frames()
                clock.close()
                leg.update(meter.summary())
                leg["baseline"] = dict(
                    rt.last_baseline, frame_bytes=frames[0][1],
                    io_thread_ms=frames[0][0], io_thread=frames[0][2],
                    send_to_applied_ms=cross_ms)
                leg["link"] = {k: link.get(k, 0) for k in (
                    "frames_tx", "frames_rx", "connects", "reconnects",
                    "backpressure_dropped", "liveness_lost", "sent")}
                leg["standby_link"] = {k: slink.get(k, 0) for k in (
                    "frames_tx", "frames_rx", "accepts", "liveness_lost",
                    "delivered")}
                leg["lease"] = {k: v for k, v in hub.authority.counters.items()
                                if k in ("rpc_timeouts", "connects",
                                         "reconnects", "frames_tx")}
                if (frames[0][2] != NET_IO_THREAD
                        or rt.last_baseline["players"] != waiting):
                    raise AssertionError(f"12a leg {i}: baseline {frames} "
                                         f"{rt.last_baseline}")
            else:
                check_faults(app, f"12a leg {i}")
            leg["loop_stall_ms_max"] = stalls.stop()
            await app.stop()
            if on:
                if app.replication_hub is not None:
                    raise AssertionError("12a: the owned hub stayed open")
                await arpc(child, "stop")
            res["legs"].append(leg)
        ons = [leg for leg in res["legs"] if leg["replication"]]
        log("12a socket replication off/on in turns: " + ", ".join(
            f"{'on' if leg['replication'] else 'off'} "
            f"{leg['requests_per_s']:.0f}/s p50 {leg['latency_ms_p50']:.2f} "
            f"p99 {leg['latency_ms_p99']:.2f} ms" for leg in res["legs"])
            + f"; lag p50/p99 {[(o['lag_records_p50'], o['lag_records_p99']) for o in ons]}"
            f" records, tap {[round(o['tap_us_per_record'], 2) for o in ons]}"
            f" µs a record, baseline {[o['baseline'] for o in ons]}, link "
            f"{[o['link'] for o in ons]}, loop stall max "
            f"{[round(leg['loop_stall_ms_max'], 1) for leg in res['legs']]} ms")

        # ---- 12b: faults on the fwd flow, then a host loss ----------------
        base = ons[0]["baseline"]["seq"]
        fwd = f"repl:{queue}:fwd"
        script = ChaosConfig(
            seed=seed, queues=(queue,), net_drop_frames=((fwd, base + 2),),
            net_dup_frames=((fwd, base + 3),),
            net_delay_frames=((fwd, base + 4, 2),),
            net_reset_frames=((fwd, base + 6),))
        succ = hosts["successor"]
        listen = f"unix:{work}/sb.sock"
        await arpc(succ, "standby", listen=listen)
        app = MatchmakingApp(leg_cfg("leg_faults", True, target=listen,
                                     chaos=script), device="cuda")
        clock = FrameClock(net_link, net_transport)
        sent_at.clear()
        await app.start()
        stalls = LoopStalls()
        rt = app.runtime(queue)
        hub = app.replication_hub
        if rt.last_baseline["seq"] != base:
            raise AssertionError(f"12b: baseline seq {rt.last_baseline}, "
                                 f"12a's {base}")
        await wait_baseline(succ, base, sent_at[0], "12b")
        meter = SocketMeter(rt)
        replies = Replies(app, reply)
        lo = waiting + requests
        reset_counts(ck)
        soak_s, t_pub = await publish_and_wait(
            app, request_bodies(pop, lo, lo + faults_n), burst, reply,
            replies)
        await settle(app)
        launches_f = dict(ck.LAUNCHES)
        check_answers(replies, t_pub, "12b faults")
        await meter.quiesce()
        rep = await arpc(succ, "report")
        link, slink = dict(rt.replication.link.counters), rep["standby_link"]
        applier = rep["applier"]
        frames = clock.frames()
        clock.close()
        if rep.get("shadow_digest") != failover_proc._digest(
                rt.engine.pool._slot_of) or rep["applied_seq"] != rt.journal.seq:
            raise AssertionError(f"12b: the shadow did not converge: {rep}")
        want = {"nemesis_dropped": 1, "nemesis_dup": 1, "nemesis_delayed": 1,
                "nemesis_resets": 1}
        if ({k: link.get(k, 0) for k in want} != want
                or link.get("reconnects", 0) < 1 or len(frames) < 2
                or applier.get("applied") != rt.journal.seq - base + 1
                or applier.get("snapshots") != 1):
            raise AssertionError(f"12b: link {link}, applier {applier}, "
                                 f"{len(frames)} baseline frames")
        faults = {"requests_per_s": faults_n / soak_s, "link": link,
                  "standby_link": slink, "applier": applier,
                  "baseline_frames": len(frames), "launches": launches_f,
                  **meter.summary()}
        meter.stop()
        # The host loss: a second stream, crashed after its 4th window.
        rows = request_bodies(pop, lo + faults_n, lo + faults_n + second)
        state: dict = {}
        real_admit = rt._journal_admit_cols

        def admit_then_crash(cols):
            real_admit(cols)
            state["windows"] = state.get("windows", 0) + 1
            if state["windows"] == 4:
                state["in_flight"] = app.engine.inflight()
                state["mirror"] = set(rt.engine.pool._slot_of)
                state["kill_bound"] = rt.replication.unacked_admit_players()
                state["lag"] = rt.replication.lag()
                crash = app.crash()
                try:
                    crash.send(None)
                except StopIteration:
                    pass
                raise Crashed()
        rt._journal_admit_cols = admit_then_crash
        reset_counts(ck)
        for b in range(0, second, burst):
            for pid, body in rows[b:b + burst]:
                app.broker.publish(queue, body, Properties(
                    reply_to=reply, correlation_id=pid))
            await asyncio.sleep(0.004)
            if "in_flight" in state:
                break
        if "mirror" not in state:
            raise AssertionError(f"12b: no crash ({state})")
        flusher = rt._batcher._task
        await asyncio.sleep(0.01)
        if flusher.done() and not flusher.cancelled():
            flusher.exception()  # the Crashed it ended with, retrieved
        launches_crash = dict(ck.LAUNCHES)
        stall_b = stalls.stop()
        matched_before = replies.matched()
        t = time.perf_counter()
        to = await arpc(succ, "takeover", timeout_s=4 * NET_LEASE_S + 30.0,
                        timeout=4 * NET_LEASE_S + 60.0)
        takeover_ms = (time.perf_counter() - t) * 1e3
        if not rt.replication.superseded():
            raise AssertionError("12b: the ex-primary is not superseded")
        try:
            rt.journal.append_admits([["zz", 1500.0, 350.0, "*", "*", None,
                                       t0, reply, "zz", 0, 0.0]])
            raise AssertionError("12b: the fenced primary appended")
        except FencedError:
            pass
        answered = sum(len(v) for v in replies.got.values())
        rt._publish(reply, "zz", b"{}")
        refused = rt.counters["fenced_publish_refused"]
        if (refused != 1 or rt.replication.role != "fenced"
                or sum(len(v) for v in replies.got.values()) != answered):
            raise AssertionError(f"12b: the fenced primary published "
                                 f"({refused} refused)")
        rep = await arpc(succ, "report", shadow=True)
        shadow = set(rep["shadow"])
        lost = state["mirror"] - shadow
        if len(lost) > state["kill_bound"] or shadow & set(matched_before):
            raise AssertionError(
                f"12b: {len(lost)} lost (bound {state['kill_bound']}), "
                f"{len(shadow & set(matched_before))} matched players in "
                f"the shadow")
        sv = await arpc(succ, "serve", target=f"unix:{work}/deadend.sock",
                        jdir=os.path.join(work, "successor_j"),
                        config=os.path.join(HERE, path), fsync="none",
                        digest=True, timeout=300.0)
        if (sv["epoch"] != to["epoch"] or sv["recovered_n"] != len(shadow)
                or sv["recovered_digest"] != failover_proc._digest(shadow)):
            raise AssertionError(f"12b: served epoch {sv['epoch']} after "
                                 f"takeover {to['epoch']}, adopted "
                                 f"{sv['recovered_n']} of {len(shadow)}")
        before = await arpc(succ, "report", digest=True)
        lo2 = lo + faults_n + second
        fresh = [[pop.ids[k], float(pop.rating[k])]
                 for k in range(lo2, lo2 + fresh_n)]
        t = time.perf_counter()
        await arpc(succ, "publish", rows=fresh, rate=1e7)
        q = await arpc(succ, "quiesce", replication=False, timeout_s=60.0,
                       timeout=90.0)
        fresh_s = time.perf_counter() - t
        after = await arpc(succ, "report", digest=True)
        launches_s = {k: after["launches"][k] - before["launches"][k]
                      for k in after["launches"]}
        if (not q["ok"] or launches_s["block_best"] == 0
                or launches_s["quality_accum"] != launches_s["block_best"]
                or after["faults"] or any(after["errors"].values())):
            raise AssertionError(f"12b: the successor: quiesced {q}, "
                                 f"launches {launches_s}, faults "
                                 f"{after['faults']}, {after['errors']}")
        kern = await arpc(succ, "kernels", rows=FULL_B)
        both = set(after["match_of"]) & set(matched_before)
        if both:
            raise AssertionError(f"12b: {len(both)} players matched by both "
                                 f"the primary and the child")
        await arpc(succ, "stop", timeout=120.0)
        res["faults"] = faults
        res["failover"] = {
            "in_flight_at_crash": state["in_flight"],
            "kill_bound": state["kill_bound"], "lag_at_crash": state["lag"],
            "lost": len(lost), "matched_before_crash": len(matched_before),
            "takeover_ms_real_expiry": takeover_ms, "epoch": to["epoch"],
            "served_epoch": sv["epoch"], "shadow_players": len(shadow),
            "rto_ms": sv["rto_ms"], "split_ms": sv["split_ms"],
            "loop_stall_ms_max": stall_b, "fresh_s": fresh_s,
            "fenced_publish_refused": refused,
            "launches_before_crash": launches_crash,
            "launches": launches_s, "kernel_check": kern,
            "matched_by_child": len(after["match_of"])}
        log(f"12b faults: link {link}, applier {applier}, "
            f"{len(frames)} baseline frames; host loss with "
            f"{state['in_flight']} windows in flight, lag "
            f"{state['lag']} records, lost {len(lost)} (bound "
            f"{state['kill_bound']}); takeover after the real expiry "
            f"{takeover_ms:.0f} ms (epoch {to['epoch']}), the child adopted "
            f"{len(shadow)} on the card, rto {sv['rto_ms']} ms "
            f"{sv['split_ms']}, its {fresh_n} requests launched "
            f"{launches_s}, kernels vs plain {kern}")
        QueueReplication.send_baseline = real_send_baseline

        # ---- 12c: the cross-process soak, hosts on the card ---------------
        t = time.perf_counter()
        soak = await asyncio.to_thread(
            failover_proc.soak, runs=soak_runs, cycles=3, device="cuda",
            log_fn=log)
        soak["seconds"] = time.perf_counter() - t
        gates = {
            "dup": soak["socket_failover_dup"] == 0,
            "lost_over_bound": soak["socket_failover_lost_over_bound"] == 0,
            "fenced_probes": soak["socket_fenced_probe_failures"] == 0,
            "reconnects": soak["socket_link_reconnects"] >= soak_runs,
            "heartbeat_false_positives":
                soak["heartbeat_false_positive_count"] == 0,
            "recoveries": soak["socket_failover_recoveries"] == 3 * soak_runs,
            "identical": soak_runs < 2
            or soak["socket_failover_transcript_identical"] is True,
            "epochs": all(a == b for run in soak["socket_failover_epochs"]
                          for a, b in run),
            "launches": soak["launches"]["block_best"] > 0
            and soak["launches"]["quality_accum"]
            == soak["launches"]["block_best"]}
        if not all(gates.values()):
            raise AssertionError(f"12c: gates {gates}: {soak}")
        res["soak"] = soak
        log(f"12c cross-process soak ({soak_runs} run(s), 3 cycles, hosts on "
            f"the card): lost {soak['socket_failover_lost']} of bound "
            f"{soak['socket_failover_lost_bound']}, dup "
            f"{soak['socket_failover_dup']}, reconnects "
            f"{soak['socket_link_reconnects']}, heartbeat false positives "
            f"{soak['heartbeat_false_positive_count']}, rto max "
            f"{soak['socket_failover_rto_ms']} ms, digests "
            f"{soak['failover_transcript_digests']}, launches "
            f"{soak['launches']}, {soak['seconds']:.1f} s")
    finally:
        for c in children:
            c.reap()
        shutil.rmtree(work, ignore_errors=True)
    return res


# ---- phase 13: transports, processes and load ---------------------------

#: 13a's load: requests over AMQP in bursts (and the same through the
#: in-process broker), and the request queue's prefetch (config #1's).
AMQP_REQUESTS, AMQP_BURST = 8_192, 512
#: 13a kills the service's consumer connection after this many windows.
AMQP_KILL_AFTER = 4
#: 13b's loadgen worker (config #1 on the card).
LOADGEN_RATE, LOADGEN_SECONDS = 8_000, 3.0
#: 13c's load: flash-crowd at 3,000 requests/s steady and 15,000/s at the
#: peak over 4 s (the rate is the spec's x rate_scale / time_scale), and
#: the tuner's knobs.
FLASH = dict(rate_scale=5.0, time_scale=0.5)
TUNE = dict(interval_s=0.25, target_p99_ms=40.0, settle_ticks=2)


class AmqpMeter:
    """The loop's side of an ``AmqpBroker``'s consume bridge: host ms spent
    in ``_bridge_batched`` and ``_drain_pending`` (the burst handed to the
    app), the bursts drained, and the redelivered deliveries bridged."""

    def __init__(self, broker):
        self.broker, self.ms, self.bursts, self.redelivered = broker, 0.0, 0, 0
        real_bridge, real_drain = broker._bridge_batched, broker._drain_pending

        def bridge(consumer, delivery):
            t = time.perf_counter()
            if delivery.redelivered:
                self.redelivered += 1
            real_bridge(consumer, delivery)
            self.ms += (time.perf_counter() - t) * 1e3

        def drain(consumer):
            t = time.perf_counter()
            n = len(consumer.pending)
            real_drain(consumer)
            self.bursts += n > 0
            self.ms += (time.perf_counter() - t) * 1e3
        broker._bridge_batched, broker._drain_pending = bridge, drain

    def reset(self):
        self.ms, self.bursts, self.redelivered = 0.0, 0, 0


class ServeHandle:
    """``service.app.serve`` on this loop, started from ``MM_*`` alone
    (``env`` is set for the boot and taken back), with ``pika_module``;
    ``app`` is the app serve built (caught at its ``start``)."""

    def __init__(self, env, pika_module):
        self.env, self.pika, self.app = env, pika_module, None
        self.stop = asyncio.Event()
        self.task = None
        self.drained = None

    async def start(self, timeout=240.0):
        from matchmaking_tpu_torch.service import app as app_mod

        cls = app_mod.MatchmakingApp
        real_start = cls.start
        handle = self

        async def start(app):
            handle.app = app
            real_drain = app.drain

            async def drain(*a, **k):
                handle.drained = await real_drain(*a, **k)
                return handle.drained
            app.drain = drain
            await real_start(app)
        saved = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)
        cls.start = start
        try:
            self.task = asyncio.ensure_future(app_mod.serve(
                self.stop, pika_module=self.pika))
            end = time.monotonic() + timeout
            while self.app is None or not self.app._runtimes[
                    self.app.queue_cfg.name]._tag:
                if self.task.done():
                    self.task.result()
                if time.monotonic() > end:
                    raise AssertionError("serve did not start")
                await asyncio.sleep(0.01)
        finally:
            cls.start = real_start
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        return self.app

    async def restored(self, n, timeout=120.0):
        """Until serve's restore of the drain directory re-admitted ``n``
        players (it runs after the start)."""
        end = time.monotonic() + timeout
        while self.app.engine.pool_size() < n:
            if time.monotonic() > end or self.task.done():
                raise AssertionError(f"serve restored "
                                     f"{self.app.engine.pool_size()} of {n}")
            await asyncio.sleep(0.01)

    async def finish(self, timeout=240.0):
        self.stop.set()
        await asyncio.wait_for(self.task, timeout)


class ClientLog(Replies):
    """``Replies`` read on a client's side: every answer on ``reply`` with
    the host time it reached the client's burst consumer (each delivery
    acked)."""

    def __init__(self, broker, reply):
        self.got: dict[str, list[tuple[float, bytes]]] = {}
        self.reply = reply
        broker.declare_queue(reply)

        async def one(d):
            await batch([d])

        async def batch(ds):
            t = time.perf_counter()
            for d in ds:
                self.got.setdefault(d.properties.correlation_id, []).append(
                    (t, bytes(d.body)))
                broker.ack(self.tag, d.delivery_tag)
        self.tag = broker.basic_consume(reply, one, prefetch=1_000_000,
                                        batch_callback=batch)


async def client_soak(client, queue, rows, burst, log, what, timeout=180.0):
    """Publish ``rows`` ((id, body)) through ``client`` in bursts of
    ``burst`` (5 ms apart) and wait until each has an answer: (seconds,
    publish times)."""
    from matchmaking_tpu_torch.service.broker import Properties

    t_pub = {}
    t0 = time.perf_counter()
    for b in range(0, len(rows), burst):
        for pid, body in rows[b:b + burst]:
            t_pub[pid] = time.perf_counter()
            client.publish(queue, body, Properties(
                reply_to=log.reply, correlation_id=pid))
        await asyncio.sleep(0.005)
    end = time.monotonic() + timeout
    while (not all(p in log.got for p in t_pub)
           and time.monotonic() < end):
        await asyncio.sleep(0.01)
    missing = [p for p in t_pub if p not in log.got]
    if missing:
        raise AssertionError(f"{what}: {len(missing)} requests never "
                             f"answered")
    lat = [(log.got[p][0][0] - t) * 1e3 for p, t in t_pub.items()]
    return (time.perf_counter() - t0, statistics.median(lat), pct(lat, 0.99),
            t_pub)


async def service_transports(np, ck, mods, path, *, waiting, requests, burst,
                             seed):
    """13a. Config #1 over AMQP on the card, the port's ``fake_pika`` the
    server. An app of the phase restores ``waiting`` players and drains
    them into a checkpoint directory; the in-process service restores them
    and takes ``requests`` (bursts of ``burst``), then ``serve`` starts
    from ``MM_*`` alone (``MM_CONFIG_JSON``, ``MM_BROKER_URL=amqp://...``,
    ``MM_OVERLOAD_DRAIN_CHECKPOINT_DIR``), restores them, and takes the
    same requests from a client ``AmqpBroker`` on its own connection:
    requests/s, client-side p50/p99, the bridge's ms a burst and the
    loop's longest stall, for both. Then a second stream with the
    service's consumer connection killed after its 4th window: a
    reconnect and a redeclare, redeliveries = the unacked at the kill,
    stale acks recorded, every request answered (a redelivery of an
    answered request replays the same answer: ``deduped_replays``),
    nobody in two matches. Then JAX's scripted drop/dup over AMQP twice (equal stats),
    and ``stop`` drains into the directory, from which a successor
    ``serve`` restores every waiting player."""
    import dataclasses
    import shutil
    import tempfile
    import uuid

    from matchmaking_tpu_torch.config import ChaosConfig
    from matchmaking_tpu_torch.service import amqp_transport
    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.broker import Properties
    from matchmaking_tpu_torch.testing import fake_pika
    from matchmaking_tpu_torch.utils.chaos import ChaosState
    from matchmaking_tpu_torch.utils.trace import EventLog

    Config, _, RequestColumns, _ = mods
    rng = np.random.default_rng(seed)
    t0 = time.time()
    kill_n = requests
    pop = Population(np, rng, waiting + requests + kill_n, t0, filters=False,
                     glicko2=False)
    work = tempfile.mkdtemp(prefix="mmamqp")
    ckpt = os.path.join(work, "drain")
    real_declare = fake_pika.Channel.queue_declare
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    queue = cfg.queues[0].name
    res: dict = {"requests": requests, "burst": burst}
    try:
        # The seed app: the 100k, drained into the checkpoint directory.
        app0 = MatchmakingApp(cfg, device="cuda")
        await app0.start()
        fill = pop.columns(RequestColumns, app0.engine, 0, waiting, t0,
                           "seed.replies")
        app0.restore_columns(fill, pop.region[:waiting], pop.mode[:waiting],
                             t0)
        saved = await app0.drain(ckpt)
        if saved.get(queue) != waiting:
            raise AssertionError(f"13a: the seed drained {saved}")
        rows = request_bodies(pop, waiting, waiting + requests)

        # In-process: the same restore and the same requests.
        app = MatchmakingApp(cfg, device="cuda")
        await app.start()
        restored = await app.restore_checkpoint(ckpt)
        if restored.get(queue) != waiting:
            raise AssertionError(f"13a in-process: restored {restored}")
        ilog = ClientLog(app.broker, "inproc.replies")
        stalls = LoopStalls()
        reset_counts(ck)
        soak_s, p50, p99, t_pub = await client_soak(
            app.broker, queue, rows, burst, ilog, "13a in-process")
        await settle(app)
        inproc = {"requests_per_s": requests / soak_s, "latency_ms_p50": p50,
                  "latency_ms_p99": p99, "loop_stall_ms_max": stalls.stop(),
                  "windows": app.counters["windows"],
                  "launches": dict(ck.LAUNCHES)}
        check_answers(ilog, t_pub, "13a in-process")
        check_faults(app, "13a in-process")
        await app.stop()

        # serve over AMQP, from MM_* alone.
        url = f"amqp://fake-{uuid.uuid4().hex[:8]}"
        server = fake_pika.FakeServer.for_url(url)
        env = {"MM_CONFIG_JSON": os.path.join(HERE, path),
               "MM_BROKER_URL": url,
               "MM_OVERLOAD_DRAIN_CHECKPOINT_DIR": ckpt}
        declares = {"n": 0}

        def declare(self, *a, **k):
            if k.get("queue", a[0] if a else None) == queue:
                declares["n"] += 1
            return real_declare(self, *a, **k)
        fake_pika.Channel.queue_declare = declare
        served = ServeHandle(env, fake_pika)
        sapp = await served.start()
        if not isinstance(sapp.broker, amqp_transport.AmqpBroker):
            raise AssertionError(f"13a: serve built {type(sapp.broker)}")
        await served.restored(waiting)
        meter = AmqpMeter(sapp.broker)
        client = amqp_transport.AmqpBroker(url, pika_module=fake_pika)
        alog = ClientLog(client, "amqp.replies")
        stalls = LoopStalls()
        meter.reset()
        reset_counts(ck)
        soak_s, p50, p99, t_pub = await client_soak(
            client, queue, rows, burst, alog, "13a amqp")
        srt = sapp.runtime(queue)
        await settle(sapp)
        amqp = {"requests_per_s": requests / soak_s, "latency_ms_p50": p50,
                "latency_ms_p99": p99, "loop_stall_ms_max": stalls.stop(),
                "bridge_ms_per_burst": meter.ms / max(1, meter.bursts),
                "bursts": meter.bursts, "windows": srt.counters["windows"],
                "launches": dict(ck.LAUNCHES)}
        check_answers(alog, t_pub, "13a amqp")
        check_faults(sapp, "13a amqp")
        if (amqp["launches"]["block_best"] == 0
                or amqp["launches"]["quality_accum"]
                != amqp["launches"]["block_best"]):
            raise AssertionError(f"13a amqp: launches {amqp['launches']}")
        res["inproc"], res["amqp"] = inproc, amqp
        line = (f"13a {requests} requests, in-process vs AMQP: "
                    f"{inproc['requests_per_s']:.0f} vs "
                    f"{amqp['requests_per_s']:.0f}/s, p50 "
                    f"{inproc['latency_ms_p50']:.1f} vs "
                    f"{amqp['latency_ms_p50']:.1f} ms, p99 "
                    f"{inproc['latency_ms_p99']:.1f} vs "
                    f"{amqp['latency_ms_p99']:.1f} ms, loop stall max "
                    f"{inproc['loop_stall_ms_max']:.1f} vs "
                    f"{amqp['loop_stall_ms_max']:.1f} ms, bridge "
                    f"{amqp['bridge_ms_per_burst']:.3f} ms a burst "
                    f"({amqp['bursts']} bursts)")
        log(line)

        # The consumer connection killed after the 4th window.
        consumer = next(iter(sapp.broker._consumers.values()))
        state: dict = {"windows": 0}
        real_flush = srt._batcher._flush

        async def flush(items):
            await real_flush(items)
            state["windows"] += 1
            if state["windows"] == AMQP_KILL_AFTER:
                with server.lock:
                    state["unacked"] = len(consumer.channel._unacked)
                    state["gen"] = consumer.generation
                    consumer.conn._die_locked()
                    server.cond.notify_all()
        srt._batcher._flush = flush
        stats0 = dict(sapp.broker.stats)
        declares0 = declares["n"]
        dedup0 = srt.counters["deduped_replays"]
        meter.reset()
        klog = ClientLog(client, "kill.replies")
        reset_counts(ck)
        rows2 = request_bodies(pop, waiting + requests,
                               waiting + requests + kill_n)
        soak_s, p50, p99, t_pub = await client_soak(
            client, queue, rows2, burst, klog, "13a kill")
        await settle(sapp)
        end = time.monotonic() + 30.0
        while (meter.redelivered < state.get("unacked", 0)
               and time.monotonic() < end):
            await asyncio.sleep(0.01)
        await settle(sapp)
        srt._batcher._flush = real_flush
        st = sapp.broker.stats
        kill = {"unacked_at_kill": state.get("unacked"),
                "redelivered": meter.redelivered,
                "consumer_reconnects": st["consumer_reconnects"]
                - stats0["consumer_reconnects"],
                "redeclares": declares["n"] - declares0,
                "stale_acks": st["stale_acks"] - stats0["stale_acks"],
                "deduped_replays": srt.counters["deduped_replays"] - dedup0,
                "generation": consumer.generation,
                "requests_per_s": kill_n / soak_s, "latency_ms_p50": p50,
                "latency_ms_p99": p99, "launches": dict(ck.LAUNCHES)}
        check_answers(klog, t_pub, "13a kill")
        check_faults(sapp, "13a kill")
        if (kill["unacked_at_kill"] is None or kill["consumer_reconnects"] < 1
                or kill["redeclares"] < 1
                or kill["redelivered"] != kill["unacked_at_kill"]
                or kill["stale_acks"] < 1
                or kill["generation"] != state["gen"] + 1):
            raise AssertionError(f"13a kill: {kill}")
        res["kill"] = kill
        log(f"13a consumer connection killed after window "
            f"{AMQP_KILL_AFTER}: {kill['unacked_at_kill']} unacked, "
            f"{kill['redelivered']} redelivered, reconnects "
            f"{kill['consumer_reconnects']}, redeclares {kill['redeclares']}"
            f", stale acks {kill['stale_acks']}, dedupe replays "
            f"{kill['deduped_replays']}; every request answered, nobody in "
            f"two matches")

        # The JAX package's scripted drop/dup over AMQP, twice.
        async def scripted():
            url2 = f"amqp://chaos-{uuid.uuid4().hex[:8]}"
            b = amqp_transport.AmqpBroker(url2, pika_module=fake_pika,
                                          reconnect_base_s=0.01,
                                          reconnect_max_s=0.05)
            b.chaos = ChaosState(ChaosConfig(seed=3, queues=("cq",),
                                             drop_seqs=(1,),
                                             dup_seqs=((2, 2),)))
            b.events = EventLog(64)
            got = []

            async def on_delivery(d):
                got.append(d)
                b.ack(tag, d.delivery_tag)
            b.declare_queue("cq")
            tag = b.basic_consume("cq", on_delivery)
            for i in range(3):
                b.publish("cq", f"m{i}".encode(), Properties(
                    reply_to="rq", correlation_id=f"c{i}"))
            end = time.monotonic() + 10.0
            while len(got) < 5 and time.monotonic() < end:
                await asyncio.sleep(0.01)
            await asyncio.sleep(0.05)
            b.close()
            return ({k: b.stats[k] for k in ("published", "acked", "dropped",
                                             "duplicated", "partitions")},
                    sorted(d.body for d in got),
                    [e["kind"] for e in b.events.snapshot()])
        chaos = [await scripted(), await scripted()]
        if (chaos[0] != chaos[1] or chaos[0][1] != [b"m0", b"m1", b"m2",
                                                    b"m2", b"m2"]
                or (chaos[0][0]["dropped"], chaos[0][0]["duplicated"])
                != (1, 2)):
            raise AssertionError(f"13a chaos: {chaos}")
        res["chaos_stats"] = chaos[0][0]
        res["chaos_events"] = chaos[0][2]

        # stop drains into the directory; a successor restores it.
        client.close()
        waiting_at_stop = sapp.engine.pool_size()
        await served.finish()
        drained = served.drained or {}
        successor = ServeHandle(env, fake_pika)
        sapp2 = await successor.start()
        await successor.restored(drained.get(queue, -1))
        res["drain"] = {"waiting_at_stop": waiting_at_stop,
                        "drained": drained.get(queue),
                        "successor_restored": sapp2.engine.pool_size()}
        if (drained.get(queue) != waiting_at_stop
                or sapp2.engine.pool_size() != drained.get(queue)):
            raise AssertionError(f"13a drain: {res['drain']}")
        await successor.finish()
        log(f"13a stop drained {drained.get(queue)} waiting players; the "
            f"successor serve restored {res['drain']['successor_restored']}"
            f"; scripted chaos twice: {chaos[0][0]}")
    finally:
        fake_pika.Channel.queue_declare = real_declare
        fake_pika.FakeServer.reset_all()
        shutil.rmtree(work, ignore_errors=True)
    return res


def kernel_files():
    """(path, mtime, size) of every built kernel library."""
    from matchmaking_tpu_torch.engine import cuda_kernels

    root = cuda_kernels.build_dir()
    out = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            st = os.stat(p)
            out.append((p, st.st_mtime_ns, st.st_size))
    return sorted(out)


def compute_apps():
    """The card's compute apps (one line per CUDA context, nvidia-smi).
    The card machine runs its processes in a pid namespace of their own,
    so the pids nvidia-smi prints are not this machine's: count the lines,
    and read each process's open device files (``nvidia_fds``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def nvidia_fds(pid):
    """The NVIDIA device files process ``pid`` has open."""
    out = set()
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            out.add(target)
    return sorted(out)


def http_json(port, route, timeout=2.0):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                timeout=timeout) as r:
        return json.loads(r.read())


def wait_healthz(sup, port, what, timeout=180.0):
    """Poll the supervisor and ``/healthz`` on ``port`` until it answers;
    a restart meanwhile fails the phase."""
    end = time.monotonic() + timeout
    while True:
        sup.poll()
        try:
            return http_json(port, "/healthz")
        except OSError:
            pass
        if time.monotonic() > end:
            raise AssertionError(f"{what}: /healthz on {port} never answered")
        time.sleep(0.1)


#: The loadgen worker's command: the entry point itself, run as __main__,
#: with its process's kernel launch counts written at exit to the file
#: ``CHIP_SMOKE_LAUNCHES`` names (the worker's result has no such field).
LOADGEN_CMD = (
    "import atexit, json, os, runpy\n"
    "from matchmaking_tpu_torch.engine import cuda_kernels as ck\n"
    "atexit.register(lambda: open(os.environ['CHIP_SMOKE_LAUNCHES'], 'w')"
    ".write(json.dumps(dict(ck.LAUNCHES))))\n"
    "runpy.run_module('matchmaking_tpu_torch.service.loadgen', "
    "run_name='__main__')\n")


def service_processes(mods, path_fleet, path_lg, work):
    """13b. ``WorkerSupervisor`` over config #2 (``path_fleet``) with two
    workers and a metrics base port: worker 0 keeps the card, worker 1 is
    told the CPU engine; each is ready when its ``/healthz`` answers. The
    card's compute apps gain one context, worker 0's, and not worker 1's.
    SIGKILL worker 0:
    restarted with backoff, ``restarts`` 1, ``/healthz`` again on the
    card; SIGTERM ends both with exit 0. Then the loadgen worker under the
    supervisor on the card (``path_lg``, config #1): ``LOADGEN_RATE`` for
    ``LOADGEN_SECONDS``, players matched >= 0.9 x sent. No child builds a
    kernel (the libraries' files unchanged)."""
    import dataclasses
    import signal

    from matchmaking_tpu_torch.service.multiproc import WorkerSupervisor

    Config = mods[0]
    before = kernel_files()
    port = free_port()
    while port + 1 >= 65536:
        port = free_port()
    cfg = Config.from_json(os.path.join(HERE, path_fleet), backend="gpu")
    cfg = dataclasses.replace(cfg, metrics_port=port)
    sup = WorkerSupervisor(cfg, 2, backoff_initial_s=0.5)
    res: dict = {"metrics_port": port}
    apps0 = compute_apps()  # this process's own context
    t = time.perf_counter()
    try:
        sup.start()
        health = [wait_healthz(sup, port + i, f"13b worker {i}")
                  for i in range(2)]
        res["boot_s"] = time.perf_counter() - t
        engines = [sorted({q["engine"] for q in h["queues"].values()})
                   for h in health]
        pids = [w.proc.pid for w in sup.workers]
        apps = compute_apps()
        fds = [nvidia_fds(pid) for pid in pids]
        res["compute_apps"] = {"before": apps0, "ready": apps}
        res["nvidia_fds"] = fds
        if (engines != [["GpuEngine"], ["CpuEngine"]]
                or len(apps) != len(apps0) + 1
                or [w.restarts for w in sup.workers] != [0, 0]):
            raise AssertionError(f"13b: engines {engines}, compute apps "
                                 f"{apps0} then {apps}, restarts "
                                 f"{[w.restarts for w in sup.workers]}")
        res["engines"] = engines
        metrics0 = http_json(port, "/metrics")
        res["device_worker_xla_compiles"] = metrics0["counters"].get(
            "xla_compiles")
        t = time.perf_counter()
        os.kill(pids[0], signal.SIGKILL)
        end = time.monotonic() + 60.0
        while sup.workers[0].proc is None or sup.workers[0].proc.pid == pids[0]:
            sup.poll()
            if time.monotonic() > end:
                raise AssertionError("13b: worker 0 never restarted")
            time.sleep(0.05)
        h0 = wait_healthz(sup, port, "13b worker 0 restarted")
        res["restart_s"] = time.perf_counter() - t
        apps = compute_apps()
        res["compute_apps"]["restarted"] = apps
        if (sup.workers[0].restarts != 1 or sup.workers[1].restarts != 0
                or len(apps) != len(apps0) + 1
                or sorted({q["engine"] for q in h0["queues"].values()})
                != ["GpuEngine"]):
            raise AssertionError(f"13b restart: restarts "
                                 f"{[w.restarts for w in sup.workers]}, "
                                 f"compute apps {apps}")
        res["backoff_s"] = sup.workers[0].backoff
        procs = [w.proc for w in sup.workers]
        sup.stop(term_timeout_s=60.0)
        res["exit_codes"] = [p.returncode for p in procs]
        if res["exit_codes"] != [0, 0]:
            raise AssertionError(f"13b: exit codes {res['exit_codes']}")
    finally:
        sup.stop(term_timeout_s=10.0)
    log(f"13b supervisor over config #2: both ready in {res['boot_s']:.1f} "
        f"s (worker 0 {res['engines'][0]} on the card, worker 1 "
        f"{res['engines'][1]}; the card's compute apps "
        f"{res['compute_apps']}, device files {res['nvidia_fds']}), SIGKILL of "
        f"worker 0 restarted in {res['restart_s']:.1f} s (backoff "
        f"{res['backoff_s']} s), SIGTERM exits {res['exit_codes']}")

    # The loadgen worker under the supervisor on the card.
    out = os.path.join(work, "loadgen.json")
    launches_out = os.path.join(work, "loadgen_launches.json")
    lg_cfg = Config.from_json(os.path.join(HERE, path_lg), backend="gpu")
    sup = WorkerSupervisor(
        lg_cfg, 1, command=[sys.executable, "-c", LOADGEN_CMD],
        extra_env={0: {"MM_LOADGEN_RATE": str(LOADGEN_RATE),
                       "MM_LOADGEN_SECONDS": str(LOADGEN_SECONDS),
                       "MM_LOADGEN_SEED": "26", "MM_LOADGEN_OUT": out,
                       "CHIP_SMOKE_LAUNCHES": launches_out}})
    t = time.perf_counter()
    sup.start()
    try:
        rc = sup.workers[0].proc.wait(timeout=300)
    finally:
        sup.stop()
    res["loadgen_s"] = time.perf_counter() - t
    if rc != 0:
        raise AssertionError(f"13b loadgen worker exited {rc}")
    with open(out) as f:
        lg = json.load(f)
    with open(launches_out) as f:
        lg_launches = json.load(f)
    res["loadgen"], res["loadgen_launches"] = lg, lg_launches
    if (lg["players_matched"] < 0.9 * lg["sent"] or lg["sent"] < 1000
            or lg_launches["block_best"] == 0
            or lg_launches["quality_accum"] != lg_launches["block_best"]):
        raise AssertionError(f"13b loadgen: {lg}, launches {lg_launches}")
    after = kernel_files()
    if after != before:
        raise AssertionError(f"13b: a child built kernels: "
                             f"{sorted(set(after) - set(before))}")
    log(f"13b loadgen worker on the card: sent {lg['sent']} "
        f"({lg['sent_req_s']}/s), matched {lg['players_matched']}, "
        f"{lg_launches} launches, {res['loadgen_s']:.1f} s; no child built "
        f"a kernel")
    return res


class StubTuneApp:
    """What a fresh ``AutoTuner`` replays recorded views against: the
    config's target and depth, runtimes that take knob writes, and a sink
    for events and gauges."""

    def __init__(self, cfg, queues):
        from types import SimpleNamespace

        class Sink:
            def append(self, *a, **k):
                pass

            def inc(self, *a, **k):
                pass

        self.cfg = cfg
        self.events = Sink()
        self.metrics = SimpleNamespace(counters=Sink(),
                                       set_gauge=lambda *a: None)
        self._runtimes = {}
        for q in queues:
            rt = SimpleNamespace(batcher=SimpleNamespace(max_wait_ms=0.0),
                                 pipeline_depth=1, edf_on=False,
                                 admission=None)
            rt.set_edf = lambda on, rt=rt: setattr(rt, "edf_on", on)
            self._runtimes[q] = rt


async def service_autotune(np, ck, mods, path, *, waiting, seed):
    """13c. Config #1 at full width with ``waiting`` restored and a 60 ms
    window wait, warm-started, an SLO target of ``TUNE``'s; the load is
    ``offered_load(flash-crowd, **FLASH)``: once with the autotuner off,
    twice with ``TUNE`` (built by ``start`` from ``cfg.autotune``; the
    phase stops its timer and drives each tick itself, sampling telemetry
    and recording the view: ``step(now, view=signal_view(now))``). Per
    run: SLO attainment, p50/p99 of the total stage, shed, the moves.
    Gates: every move in its range, one a tick at most, the ratchets one
    way, each recorded view replayed through a fresh tuner gives the same
    moves, equal arrival digests, no graph capture after the start."""
    import dataclasses

    from matchmaking_tpu_torch.config import (
        AutotuneConfig,
        BatcherConfig,
    )
    from matchmaking_tpu_torch.control.autotune import (
        EDF,
        MAX_WAIT_MS,
        PIPELINE_DEPTH,
        AutoTuner,
    )
    from matchmaking_tpu_torch.scenario import load_scenario
    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.loadgen import offered_load
    from matchmaking_tpu_torch.utils.metrics import CompileCounter

    Config, _, RequestColumns, _ = mods
    base = Config.from_json(os.path.join(HERE, path), backend="gpu")
    queue = base.queues[0].name
    flash = load_scenario("flash-crowd")
    runs = []
    for tuned in (False, True, True):
        cfg = dataclasses.replace(
            base, engine=dataclasses.replace(base.engine, warm_start=True),
            batcher=BatcherConfig(max_batch=base.batcher.max_batch,
                                  max_wait_ms=60.0),
            observability=dataclasses.replace(
                base.observability, slo_target_ms=TUNE["target_p99_ms"]),
            autotune=(AutotuneConfig(**TUNE, max_wait_ms_min=1.0) if tuned
                      else AutotuneConfig()))
        rng = np.random.default_rng(seed)
        t0 = time.time()
        pop = Population(np, rng, waiting, t0, filters=False, glicko2=False)
        app = MatchmakingApp(cfg, device="cuda")
        await app.start()
        fill = pop.columns(RequestColumns, app.engine, 0, waiting, t0,
                           "seed.replies")
        app.restore_columns(fill, pop.region[:waiting], pop.mode[:waiting],
                            t0)
        tuner = app.autotune
        if tuned != (tuner is not None):
            raise AssertionError(f"13c: autotune {tuned}, tuner {tuner}")
        if tuner is not None:
            tuner.cancel()  # the phase ticks it, recording each view
        compiles0 = CompileCounter.count()
        views, ticks = [], []
        ticking = [True]

        async def ticker():
            while ticking[0]:
                await asyncio.sleep(TUNE["interval_s"])
                now = time.time()
                app.sample_telemetry(now)
                if tuner is not None:
                    view = tuner.signal_view(now)
                    views.append((now, view))
                    before = len(tuner.decisions)
                    tuner.step(now, view=view)
                    ticks.append(len(tuner.decisions) - before)
        tick_task = asyncio.ensure_future(ticker())
        stalls = LoopStalls()
        reset_counts(ck)
        t = time.perf_counter()
        try:
            result = await offered_load(app, queue, rate=0.0, duration=0.0,
                                        seed=seed, scenario=flash, **FLASH)
        finally:
            ticking[0] = False
            await tick_task
        run_s = time.perf_counter() - t
        app.sample_telemetry()
        launches = dict(ck.LAUNCHES)
        hist = app.metrics.stages.get(queue, {}).get("total")
        attr = app.attribution.snapshot()["queues"].get(queue, {})
        run = {"tuned": tuned, "sent": result["sent"],
               "sent_req_s": result["sent_req_s"],
               "matched": result["players_matched"],
               "shed": result["shed"], "shed_requests": result["shed_requests"],
               "digest": result["scenario_digest"],
               "slo_attainment": attr.get("slo_attainment"),
               "latency_ms_p50": hist.percentile(50) * 1e3,
               "latency_ms_p99": hist.percentile(99) * 1e3,
               "loop_stall_ms_max": stalls.stop(), "seconds": run_s,
               "captures_after_start": CompileCounter.count() - compiles0,
               "launches": launches}
        check_faults(app, f"13c {'tuned' if tuned else 'static'}")
        if tuner is not None:
            trace = tuner.decision_trace()
            run["moves"] = [(r[2], r[3], r[4]) for r in trace]
            run["ticks"] = tuner.ticks
            run["knobs"] = tuner.knobs()[queue]
            acfg = cfg.autotune
            for _, _, knob, src, dst, _, status in trace:
                ok = status == "applied" and {
                    MAX_WAIT_MS: lambda: acfg.max_wait_ms_min <= dst < src,
                    EDF: lambda: (src, dst) == (False, True),
                    PIPELINE_DEPTH: lambda: (acfg.pipeline_depth_min <= dst
                                             <= cfg.engine.pipeline_depth)
                }.get(knob, lambda: False)()
                if not ok:
                    raise AssertionError(f"13c: move {knob} {src} -> {dst} "
                                         f"({status}) out of range")
            if max(ticks, default=0) > 1:
                raise AssertionError("13c: two moves in one tick")
            replay = AutoTuner(StubTuneApp(cfg, [queue]), acfg)
            for now, view in views:
                replay.step(now, view=view)
            if [r[1:] for r in replay.decision_trace()] != [
                    r[1:] for r in trace]:
                raise AssertionError(
                    f"13c: the replay moved {replay.decision_trace()}, the "
                    f"run {trace}")
            run["views_replayed"] = len(views)
        await app.stop()
        if run["captures_after_start"]:
            raise AssertionError(f"13c: {run['captures_after_start']} graph "
                                 f"captures after the start")
        if launches["block_best"] == 0 or (launches["quality_accum"]
                                           != launches["block_best"]):
            raise AssertionError(f"13c: launches {launches}")
        runs.append(run)
    if len({r["digest"] for r in runs}) != 1:
        raise AssertionError("13c: the runs' arrival digests differ")
    log("13c flash-crowd (" + ", ".join(f"{k} {v}" for k, v in FLASH.items())
        + "): " + "; ".join(
            f"{'tuned' if r['tuned'] else 'static'} sent {r['sent']} "
            f"({r['sent_req_s']}/s) attainment {r['slo_attainment']} p50 "
            f"{r['latency_ms_p50']:.1f} p99 {r['latency_ms_p99']:.1f} ms shed "
            f"{r['shed']} moves {r.get('moves', [])}" for r in runs))
    return {"runs": runs, "flash": FLASH, "tune": TUNE}


# ---- phase 14: the sharded pool and the multi-host runtime ----------------

#: Phase 14a's meshes: (shards, ring merge), every shard on the one card.
SHARD_RUNS = ((1, False), (2, False), (4, False), (8, False), (4, True))


def sharded_engine(mods, cfg, d, ring, devices=None):
    """A ``GpuEngine`` whose pool is sharded ``d`` ways over ``devices``
    (default: the one card, ``d`` times). ``mesh_pool_axis`` 1 takes the
    dense step, as in the JAX engine, so D = 1 is built through a subclass
    whose kernel set is the sharded one of one shard (a smoke-only
    stand-in, as ``_graphs = None`` is)."""
    import dataclasses

    from matchmaking_tpu_torch.engine import sharded

    _, GpuEngine, _, _ = mods
    devices = devices or ("cuda:0",) * d
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, mesh_pool_axis=d, ring_merge=ring))
    if d > 1:
        return GpuEngine(cfg, cfg.queues[0], device="cuda", devices=devices)

    class OneShard(GpuEngine):
        def _kernel_set(self, queue):
            self._sharded = True
            ec = self.cfg.engine
            return sharded.sharded_kernel_set(
                capacity=ec.pool_capacity, top_k=ec.top_k,
                pool_block=ec.pool_block, glicko2=queue.glicko2,
                widen_per_sec=queue.widen_per_sec,
                max_threshold=queue.max_threshold, n_shards=1, ring=ring,
                pair_rounds=ec.pair_rounds, device_ids=self.devices,
                device="cuda")

    return OneShard(cfg, cfg.queues[0], device="cuda", devices=devices)


def same_columnar(np, got, want, what):
    """Two ColumnarOutcomes: pairs, queued ids, distances bit for bit."""
    if (got.m_id_a.tolist() != want.m_id_a.tolist()
            or got.m_id_b.tolist() != want.m_id_b.tolist()
            or got.q_ids.tolist() != want.q_ids.tolist()
            or not np.array_equal(got.m_dist.view(np.int32),
                                  want.m_dist.view(np.int32))):
        raise AssertionError(f"{what}: the outcome differs")


def drive_columnar(torch, eng, stream, now_of, depth, timed=False):
    """``stream``'s windows through ``eng`` at ``depth`` (each collected
    only after the next is dispatched), dispatch under no sync: the
    outcomes by window, and (``timed``) dispatch and turnaround ms. A
    window may be collected early when its step is done, so the slots the
    next window takes depend on the device's timing: engines are compared
    in lockstep (``lockstep``), not through this."""
    outs, t_disp, token_window = {}, {}, {}
    dispatch_ms, turnaround_ms = [], []
    for w, cols in enumerate(stream):
        t = time.perf_counter()
        with no_sync(torch):
            tok = eng.search_columns_async(cols, now_of[w])
        dispatch_ms.append((time.perf_counter() - t) * 1e3)
        t_disp[tok], token_window[tok] = t, w
        while eng.inflight() >= depth:
            for tok_c, out in eng.collect_ready():
                turnaround_ms.append((time.perf_counter() - t_disp[tok_c])
                                     * 1e3)
                outs[token_window[tok_c]] = out
    for tok_c, out in eng.flush():
        turnaround_ms.append((time.perf_counter() - t_disp[tok_c]) * 1e3)
        outs[token_window[tok_c]] = out
    if timed:
        return outs, dispatch_ms, turnaround_ms
    return outs


def lockstep(ck, engines, cols_of, now_of, n):
    """Window w (``cols_of(engine, w)``) through every engine, each
    dispatched and flushed before the next window, so every engine's
    mirror allocates the same slots: the outcomes by engine and window,
    and each engine's ``block_best`` and ``quality_accum`` launches."""
    outs = [[] for _ in engines]
    launches = [{"block_best": 0, "quality_accum": 0} for _ in engines]
    for w in range(n):
        for i, e in enumerate(engines):
            before = dict(ck.LAUNCHES)
            e.search_columns_async(cols_of(e, w), now_of[w])
            (_, out), = e.flush()
            outs[i].append(out)
            for k in launches[i]:
                launches[i][k] += ck.LAUNCHES[k] - before[k]
    return outs, launches


def snapshot_pool(eng):
    return {name: col.clone() for name, col in eng.dev_pool.items()}


def same_pool(torch, eng, want, what):
    torch.cuda.synchronize()
    for name, col in want.items():
        if not torch.equal(eng.dev_pool[name], col):
            raise AssertionError(f"{what}: pool column {name} differs")


def same_quality(np, got, want, what):
    """A sharded engine's report (the host fold) against the dense
    engine's (``quality_accum`` on the card): the samples and every rating
    bucket's count equal, the means within 1e-5 relative (the host's f64
    waits and qualities may fall in a neighbouring histogram bucket:
    PERF.md, the quality kept difference)."""
    if (got["samples"] != want["samples"]
            or [b["count"] for b in got["buckets"]]
            != [b["count"] for b in want["buckets"]]):
        raise AssertionError(f"{what}: quality counts {got['samples']} != "
                             f"{want['samples']}")
    for key in ("quality_mean", "wait_mean_s", "spread_mean"):
        a, b = got[key], want[key]
        if (a is None) != (b is None) or (
                a is not None and abs(a - b) > 1e-5 * max(1.0, abs(b))):
            raise AssertionError(f"{what}: {key} {a} != {b}")


def shard_launch_check(torch, np, ck, scoring, eng, d, seed):
    """Each shard's ``block_best`` on its slice of ``eng``'s pool, for one
    window of 1,024 rows whose global slots span every shard (so each
    launch sees ids below 0 and past its slice): bit-equal to the plain
    version; the launch timed (device ms, CUDA events). Returns (the
    largest |difference|, ms a launch)."""
    ks = eng.kernels
    lc = ks.local_capacity
    g = torch.Generator(device="cpu").manual_seed(seed)
    rows = FULL_B
    batch = {
        "slot": torch.randint(0, ks.capacity + 1, (rows,), generator=g,
                              dtype=torch.int32).cuda(),
        "rating": (torch.randn(rows, generator=g) * 300 + 1500).cuda(),
        "rd": torch.full((rows,), 350.0).cuda(),
        "region": torch.zeros(rows, dtype=torch.int32).cuda(),
        "mode": torch.zeros(rows, dtype=torch.int32).cuda(),
        "valid": torch.ones(rows, dtype=torch.bool).cuda(),
    }
    q_thr = torch.full((rows,), float(eng.queue.rating_threshold)).cuda()
    now = torch.tensor([2.0], dtype=torch.float32).cuda()
    kw = dict(pool_block=ks.pool_block, glicko2=False, filters=False,
              widen_per_sec=ks.widen_per_sec, max_threshold=ks.max_threshold,
              g_coeff=scoring.G_COEFF_F32)
    err, ms = 0.0, []
    for s, part in enumerate(eng.dev_pool.shards):
        shifted = dict(batch, slot=batch["slot"] - s * lc)
        got = ck.block_best(part, shifted, q_thr, now, **kw)
        want = ck.block_best_reference(part, shifted, q_thr, now, **kw)
        err = max(err, compare(torch, got, want, f"14a D={d} shard {s}"))
        own = shifted["slot"][:, None]
        if bool(((got[1] == own) & (got[1] < lc)).any()):
            raise AssertionError(f"14a D={d} shard {s}: a row took its own "
                                 f"slot")
        if s == 0:
            ms.append(time_ms(torch, lambda: ck.block_best(
                part, shifted, q_thr, now, **kw)))
    return err, ms[0]


def merge_ms(torch, eng):
    """The mesh's merge of one window's candidate lists (f32 and i32
    [1,024, local blocks] a shard), as the step runs it, eagerly: (ms
    between CUDA events, which includes the gaps between its launches;
    the kernels' and copies' device ms under torch.profiler)."""
    ks = eng.kernels
    parts = [(torch.zeros(FULL_B, ks.local_blocks, device="cuda"),
              torch.zeros(FULL_B, ks.local_blocks, dtype=torch.int32,
                          device="cuda")) for _ in range(ks.n_shards)]

    def run():
        for _ in range(10):
            ks.mesh.gather(parts, ring=ks.ring)
        return 10
    return (time_ms(torch, lambda: ks.mesh.gather(parts, ring=ks.ring)),
            device_busy(torch, run)["device_ms_per_window"])


def run_sharded(torch, np, ck, scoring, mods, path, *, waiting, windows,
                timed_windows, profile_windows, seed):
    """14a. Config #1 at P = 131,072 with ``waiting`` restored. A dense
    engine takes ``windows`` windows of 1,024, each flushed before the
    next; for each of ``SHARD_RUNS`` a sharded engine on ``(cuda:0,) × D``
    (its steps replayed from graphs) and a twin running the same steps
    eagerly take the same restore and windows in lockstep. Every window's
    pairs, distances (bit for bit) and queued ids, and the concatenated
    pools at the end, equal the dense engine's; D ``block_best`` launches
    a window and no ``quality_accum``; the quality report equal to the
    dense engine's (``same_quality``); each shard's launch bit-equal to its
    plain version on its slice. Then ``timed_windows`` more at depth 2
    (dispatch and turnaround ms) and ``profile_windows`` under
    torch.profiler, which count D ``prep_kernel``, D
    ``block_best_kernel`` and 0 ``quality_accum_kernel`` a window on the
    device."""
    Config, GpuEngine, RequestColumns, _ = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    queue, depth = cfg.queues[0], cfg.engine.pipeline_depth
    rng = np.random.default_rng(seed)
    t0 = 1_700_000_000.0
    total = windows + timed_windows + PROFILE_TRIES * profile_windows
    pop = Population(np, rng, waiting + total * FULL_B, t0, filters=False,
                     glicko2=False)
    now_of = [t0 + 1.0 + 0.05 * w for w in range(total)]

    def cols_of(eng, w):
        return pop.columns(RequestColumns, eng, waiting + w * FULL_B,
                           waiting + (w + 1) * FULL_B, now_of[w])

    def restored(eng):
        eng.warmup()
        with no_sync(torch):
            eng.restore_columns(pop.columns(RequestColumns, eng, 0, waiting,
                                            t0), t0)
        return eng

    def timed(eng, want_own, label):
        """The pipelined windows' dispatch and turnaround ms, then the
        profiled windows' device numbers (``device_busy_exact``: the hand
        kernels counted by name must be ``want_own``)."""
        lo, hi = windows, windows + timed_windows
        _, disp, turn = drive_columnar(
            torch, eng, [cols_of(eng, w) for w in range(lo, hi)],
            now_of[lo:hi], depth, timed=True)

        def run_of(i):
            lo_p = hi + i * profile_windows
            hi_p = lo_p + profile_windows
            stream = [cols_of(eng, w) for w in range(lo_p, hi_p)]

            def run():
                drive_columnar(torch, eng, stream, now_of[lo_p:hi_p], depth)
                return profile_windows
            return run
        prof = device_busy_exact(torch, ck, run_of, want_own, f"14a {label}")
        return {"dispatch_ms_p50": statistics.median(disp),
                "dispatch_ms_p99": pct(disp, 0.99),
                "turnaround_ms_p50": statistics.median(turn),
                "turnaround_ms_p99": pct(turn, 0.99),
                "device_ms_per_window": prof["device_ms_per_window"],
                "kernels_per_window": prof["kernels_per_window"],
                "queued_per_window": prof["queued_per_window"],
                "own_kernels": prof["own_kernels"],
                "own_kernel_ms_per_window": prof["own_kernel_ms_per_window"],
                "short_profile_sessions": prof["short_sessions"],
                "top_kernels": prof["top_kernels"][:5]}

    dense = restored(GpuEngine(cfg, queue, device="cuda"))
    (want,), _ = lockstep(ck, [dense], cols_of, now_of, windows)
    want_pool = snapshot_pool(dense)
    dense_quality = dense.quality_report()
    res = {"dense": timed(dense, dict.fromkeys(OWN_KERNELS, profile_windows),
                          "dense"), "runs": {}}
    res["dense"]["matches"] = sum(o.n_matches for o in want)
    log(f"14a dense: {res['dense']['matches']} matches, device "
        f"{res['dense']['device_ms_per_window']:.3f} ms and "
        f"{res['dense']['kernels_per_window']:.1f} kernels a window")
    dense.close()
    launches = {}
    for d, ring in SHARD_RUNS:
        label = f"D={d}" + (" ring" if ring else "")
        eng = restored(sharded_engine(mods, cfg, d, ring))
        eager = restored(sharded_engine(mods, cfg, d, ring))
        eager._graphs = None
        graphs = graph_summary(eng.graph_report())
        (outs, e_outs), (counts, _) = lockstep(ck, [eng, eager], cols_of,
                                               now_of, windows)
        if counts["block_best"] != d * windows or counts["quality_accum"]:
            raise AssertionError(f"14a {label}: launches {counts} for "
                                 f"{windows} windows")
        for w in range(windows):
            same_columnar(np, outs[w], want[w], f"14a {label} window {w}")
            same_columnar(np, e_outs[w], want[w],
                          f"14a {label} eager window {w}")
        same_pool(torch, eng, want_pool, f"14a {label}")
        same_pool(torch, eager, want_pool, f"14a {label} eager")
        same_quality(np, eng.quality_report(), dense_quality,
                     f"14a {label}")
        if eng.graph_report()["captures"] != graphs["captures"]:
            raise AssertionError(f"14a {label}: a window captured again")
        eager.close()
        err, launch_ms = shard_launch_check(torch, np, ck, scoring, eng, d,
                                            seed + d)
        m_ms, m_dev = merge_ms(torch, eng)
        run = timed(eng, {"prep_kernel": d * profile_windows,
                          "block_best_kernel": d * profile_windows,
                          "quality_accum_kernel": 0}, label)
        # D = 1 is the smoke's stand-in (``sharded_engine``), which no
        # configuration reaches: its launches stay out of the main path's.
        launches[("stand_in_" if d == 1 else "") + f"sharded_d{d}"
                 + ("_ring" if ring else "")] = counts["block_best"]
        run.update({"shards": d, "ring": ring,
                    "block_best_ms_a_launch": launch_ms, "merge_ms": m_ms,
                    "merge_device_ms": m_dev,
                    "max_abs_err": err, "launches": counts["block_best"],
                    "graphs": {k: v for k, v in graphs.items()
                               if k != "by_graph"},
                    "eager_windows_equal": windows})
        res["runs"][label] = run
        log(f"14a {label}: {windows} windows = dense and = eager, pools "
            f"equal; device {run['device_ms_per_window']:.3f} ms, "
            f"{run['kernels_per_window']:.1f} kernels a window; dispatch "
            f"p50 {run['dispatch_ms_p50']:.3f} ms, turnaround p50 "
            f"{run['turnaround_ms_p50']:.2f} ms; block_best "
            f"{launch_ms:.5f} ms a launch (x{d}), merge {m_ms:.5f} ms "
            f"({m_dev:.5f} device); "
            f"{graphs['captures']} graphs")
        eng.close()
    res["launches"] = launches
    return res


def run_bucket_frontier(torch, np, ck, scoring, mods, path, *, waiting,
                        grow, windows, seed):
    """14b. Config #1 bucketed (bands gaussian:1500:300), sharded 4 ways
    on the card: the bucket frontier with its ladder, beside a twin with
    the ladder taken away (every window on the dense sharded step, the
    same allocator). ``waiting`` restored (at most 128 a global bucket),
    ``windows`` windows of 256; then ``grow`` more restored (past the
    ceiling) and ``windows`` more. Every window and the pools equal the
    twin's; frontier steps, ladder moves and fallbacks counted; the
    frontier launch at every ladder width bit-equal to its plain version
    and timed."""
    import dataclasses

    Config, _, RequestColumns, _ = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, bucketed=True, band_spec="gaussian:1500:300"))
    rng = np.random.default_rng(seed)
    t0 = 1_700_000_000.0
    b = 256
    n_all = waiting + grow + 2 * windows * b
    pop = Population(np, rng, n_all, t0, filters=False, glicko2=False)
    eng = sharded_engine(mods, cfg, 4, False)
    twin = sharded_engine(mods, cfg, 4, False)
    twin._frontier_ladder = ()
    for e in (eng, twin):
        e.warmup()
        e.restore_columns(pop.columns(RequestColumns, e, 0, waiting, t0), t0)
    peak0 = eng.pool.segment_max()
    res = {"ladder": list(eng._frontier_ladder), "waiting": waiting,
           "peak_bucket_at_start": peak0}
    frontier_launch = {}
    ks = eng.kernels
    for k in eng._frontier_ladder:
        fpool, gslot = ks.frontier_pool(eng.dev_pool, k)
        slot = torch.from_numpy(eng.pool.waiting_slots()[:b].astype(
            np.int32)).cuda()
        rows = slot.shape[0]
        batch = {"slot": ks.frontier_rows(gslot, slot, k),
                 "rating": torch.from_numpy(pop.rating[:rows].copy()).cuda(),
                 "rd": torch.full((rows,), 350.0, device="cuda"),
                 "region": torch.zeros(rows, dtype=torch.int32,
                                       device="cuda"),
                 "mode": torch.zeros(rows, dtype=torch.int32, device="cuda"),
                 "valid": torch.ones(rows, dtype=torch.bool, device="cuda")}
        q_thr = torch.full((rows,), 100.0, device="cuda")
        now = torch.tensor([1.0], device="cuda")
        kw = dict(pool_block=k, glicko2=False, filters=True,
                  widen_per_sec=ks.widen_per_sec,
                  max_threshold=ks.max_threshold,
                  g_coeff=scoring.G_COEFF_F32)
        compare(torch, ck.block_best(fpool, batch, q_thr, now, **kw),
                ck.block_best_reference(fpool, batch, q_thr, now, **kw),
                f"14b frontier k={k}")
        f_rows = fpool["rating"].shape[0]
        frontier_launch[k] = bound(ck, rows, False, True,
                                   pairs=rows * f_rows, pool_slots=f_rows)
        frontier_launch[k].update(rows=rows, frontier_rows=f_rows, ms=time_ms(
            torch, lambda: ck.block_best(fpool, batch, q_thr, now, **kw)))
    res["frontier_launch"] = frontier_launch
    seen, counts = 0, [{"block_best": 0, "quality_accum": 0} for _ in range(2)]
    for stage, (lo_rows, now0) in enumerate(((waiting, t0 + 1.0),
                                             (waiting + grow + windows * b,
                                              t0 + 10.0))):
        if stage == 1:
            for e in (eng, twin):
                e.restore_columns(pop.columns(
                    RequestColumns, e, waiting + windows * b,
                    waiting + windows * b + grow, t0 + 5.0), t0 + 5.0)
            res["peak_bucket_after_growth"] = eng.pool.segment_max()
        now_of = [now0 + 0.05 * w for w in range(windows)]
        outs, stage_counts = lockstep(ck, [eng, twin], lambda e, w: pop.columns(
            RequestColumns, e, lo_rows + w * b, lo_rows + (w + 1) * b,
            now_of[w]), now_of, windows)
        for total, part in zip(counts, stage_counts):
            for k in total:
                total[k] += part[k]
        for w in range(windows):
            same_columnar(np, outs[0][w], outs[1][w],
                          f"14b stage {stage} window {w}")
            seen += outs[0][w].n_matches
        same_pool(torch, eng, snapshot_pool(twin), f"14b stage {stage}")
    c = eng.counters
    res.update({k: c.get(k, 0) for k in ("bucket_frontier_steps",
                                         "bucket_frontier_fallback",
                                         "frontier_k_moves")})
    res["frontier_moves"] = [{k: v for k, v in m.items() if k != "t"}
                             for m in eng.frontier_moves]
    res["matches"] = seen
    res["formation"] = {k: v for k, v in eng.formation_report().items()
                        if k not in ("bucket_occupancy", "bands",
                                     "frontier_moves")}
    if not (res["bucket_frontier_steps"] and res["bucket_frontier_fallback"]
            and res["frontier_k_moves"]):
        raise AssertionError(f"14b: the ladder never moved, or never ran, "
                             f"or never fell back: {res}")
    # The frontier engine's windows launch once (the merged frontier), its
    # fallbacks once a shard; the twin (the comparison, which no user runs:
    # its launches stay out of the main path's) once a shard every window.
    res["launches"] = counts[0]["block_best"]
    res["twin_launches"] = counts[1]["block_best"]
    want = (res["bucket_frontier_steps"] + 4 * res["bucket_frontier_fallback"],
            4 * 2 * windows)
    if ((res["launches"], res["twin_launches"]) != want
            or counts[0]["quality_accum"] or counts[1]["quality_accum"]):
        raise AssertionError(f"14b: launches {counts} (engine, twin), "
                             f"expected {want} block_best and no "
                             f"quality_accum")
    log(f"14b: {2 * windows} windows of {b} = the dense sharded step; "
        f"ladder {res['ladder']}, moves {res['frontier_moves']}; "
        f"{res['bucket_frontier_steps']} frontier steps, "
        f"{res['bucket_frontier_fallback']} fallbacks (peak bucket "
        f"{peak0} → {res['peak_bucket_after_growth']}); frontier launch ms "
        + ", ".join(f"k={k} {v['ms']:.5f}" for k, v in
                    frontier_launch.items()))
    for e in (eng, twin):
        e.close()
    return res


def team_arrays(np, rng, capacity, waiting, roles):
    """A team/role pool of ``capacity`` slots with ``waiting`` players in
    random slots (three regions, two modes, pinned), and their role masks
    for a role queue."""
    arrays = {
        "rating": rng.normal(1500, 300, capacity).astype(np.float32),
        "rd": np.zeros(capacity, np.float32),
        "region": rng.integers(1, 4, capacity).astype(np.int32),
        "mode": rng.integers(1, 3, capacity).astype(np.int32),
        "threshold": np.full(capacity, 150.0, np.float32),
        "enqueue_t": rng.uniform(0, 30, capacity).astype(np.float32),
        "active": np.zeros(capacity, bool),
    }
    arrays["active"][rng.choice(capacity, waiting, replace=False)] = True
    if roles:
        arrays["role_mask"] = rng.integers(1, 8, capacity).astype(np.int32)
    return arrays


def team_window(np, rng, ks, arrays, n):
    """A packed window of ``n`` arrivals into free slots."""
    free = np.nonzero(~arrays["active"])[0]
    packed = np.zeros((ks.pack_rows, FULL_B), np.float32)
    packed[0] = ks.capacity
    packed[0, :n] = free[:n]
    packed[1, :n] = rng.normal(1500, 300, n)
    packed[3, :n] = rng.integers(1, 4, n)
    packed[4, :n] = rng.integers(1, 3, n)
    packed[5, :n] = 150.0
    packed[6, :n] = 30.0
    packed[7, :n] = 1.0
    if ks.is_role:
        packed[8, :n] = rng.integers(1, 8, n)
    packed[-1] = 35.0
    return packed


def run_sharded_teams(torch, np, mods, *, seed):
    """14c. Configs #3 (P = 65,536) and #5 (P = 16,384), sharded 4 ways on
    the card: the replicated fallback with the config's waiting
    population, and the ring (``team_ring_k`` 4,096 / 2,048) with the
    linear and the tournament merge on a population within it. Each step's
    packed result and pool bit-equal to the single-device step's on the
    card; device ms a step (torch.profiler over steps on fresh copies) and
    ``comms_accounting()``."""
    import dataclasses

    from matchmaking_tpu_torch.engine import sharded
    from matchmaking_tpu_torch.engine.kernels import pool_from_reference
    from matchmaking_tpu_torch.engine.role_kernels import ShardedRoleKernelSet
    from matchmaking_tpu_torch.engine.teams import ShardedTeamKernelSet

    Config, GpuEngine, _, _ = mods
    rng = np.random.default_rng(seed)
    res = {}
    for name, path, waiting, ring_k in (
            ("team_5v5", "configs/team_5v5.json", 50_000, 4096),
            ("role_party", "configs/role_party.json", 12_000, 2048)):
        cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
        single = GpuEngine(cfg, cfg.queues[0], device="cuda").kernels
        roles = single.is_role
        q = cfg.queues[0]
        kw = dict(capacity=single.capacity, team_size=q.team_size,
                  widen_per_sec=q.widen_per_sec,
                  max_threshold=q.max_threshold,
                  max_matches=cfg.engine.team_max_matches,
                  rounds=cfg.engine.team_rounds,
                  mesh=sharded.pool_mesh(4, [0] * 4), frontier_k=ring_k)
        if roles:
            kw["role_slots"] = tuple(q.role_slots)
        cls = ShardedRoleKernelSet if roles else ShardedTeamKernelSet
        sets = {merge: cls(frontier_merge=merge, **kw)
                for merge in ("linear", "tournament")}
        out = {"comms_accounting": sets["linear"].comms_accounting()}
        for case, n_wait, n_in in (("fallback", waiting, FULL_B),
                                   ("ring", ring_k - FULL_B - 8, FULL_B)):
            arrays = team_arrays(np, rng, single.capacity, n_wait, roles)
            packed = torch.from_numpy(team_window(np, rng, single, arrays,
                                                  n_in)).cuda()
            ref = pool_from_reference(arrays, "cuda",
                                      single.extra_pool_fields)
            want = single.search_step_packed(ref, packed)
            want_pool = {k: v.clone() for k, v in ref.items()}
            steps = {"fallback": (sets["linear"], "search_step_packed")}
            if case == "ring":
                steps = {f"ring_{m}": (s, "search_step_packed_ring")
                         for m, s in sets.items()}
                steps["fallback"] = (sets["linear"], "search_step_packed")
            timing = {"single": (single, "search_step_packed", ref)}
            for label, (ks, fn) in steps.items():
                spool = ks.place_pool(arrays)
                got = getattr(ks, fn)(spool, packed)
                if not torch.equal(got, want):
                    raise AssertionError(f"14c {name} {case} {label}: the "
                                         f"result differs from the single "
                                         f"step's")
                for col, v in want_pool.items():
                    if not torch.equal(spool[col], v):
                        raise AssertionError(f"14c {name} {case} {label}: "
                                             f"pool column {col} differs")
                timing[label] = (ks, fn, None)
            ms = {}
            for label, (ks, fn, _) in timing.items():
                pools = [pool_from_reference(arrays, "cuda",
                                             single.extra_pool_fields)
                         if ks is single else ks.place_pool(arrays)
                         for _ in range(5)]
                getattr(ks, fn)(pools[0], packed)

                def run(ks=ks, fn=fn, pools=pools):
                    for p in pools[1:]:
                        getattr(ks, fn)(p, packed)
                    return len(pools) - 1
                prof = device_busy(torch, run)
                ms[label] = {"device_ms": prof["device_ms_per_window"],
                             "kernels": prof["kernels_per_window"]}
            out[case] = {"waiting": n_wait, "arrivals": n_in,
                         "matches": int((want[0] < single.capacity).sum()),
                         "steps": ms}
            log(f"14c {name} {case} ({n_wait} waiting): "
                + ", ".join(f"{k} = single" for k in steps)
                + "; device ms " + ", ".join(
                    f"{k} {v['device_ms']:.3f} ({v['kernels']:.0f} kernels)"
                    for k, v in ms.items()))
        log(f"14c {name} comms_accounting: {out['comms_accounting']}")
        res[name] = out
    return res


async def run_process_mesh(torch, np, ck, mods, path, *, waiting, windows,
                           seed):
    """14d. ``init_distributed`` joins a group of one over NCCL (the
    ``MM_DCN_*`` variables naming it); the process mesh's sharded step
    (all-gather: ``all_gather_into_tensor``; ring: no hop at one rank) at
    P = 131,072 with ``waiting`` active against the dense step, ``windows``
    windows of 1,024: results and pools bit-equal. Then ``serve`` with the
    same ``MM_DCN_*`` (it joins the group already joined) over ``amqp://``
    (the port's fake pika) answers 1,024 requests: each once, matched or
    queued."""
    import socket
    import uuid

    from matchmaking_tpu_torch.engine import distributed, sharded
    from matchmaking_tpu_torch.engine.kernels import (
        KernelSet,
        pool_from_reference,
    )
    from matchmaking_tpu_torch.service import amqp_transport
    from matchmaking_tpu_torch.testing import fake_pika

    Config, _, _, _ = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    q, ec = cfg.queues[0], cfg.engine
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dcn = {"MM_DCN_COORDINATOR": f"127.0.0.1:{port}",
           "MM_DCN_NUM_PROCESSES": "1", "MM_DCN_PROCESS_ID": "0"}
    saved = {k: os.environ.get(k) for k in dcn}
    os.environ.update(dcn)
    res = {}
    try:
        t = time.perf_counter()
        rank, world = distributed.init_distributed()
        res["init_ms"] = (time.perf_counter() - t) * 1e3
        res["backend"] = torch.distributed.get_backend()
        if (rank, world) != (0, 1) or res["backend"] != "nccl":
            raise AssertionError(f"14d: joined {rank}/{world} over "
                                 f"{res['backend']}")
        rng = np.random.default_rng(seed)
        geo = dict(capacity=FULL_P, top_k=ec.top_k, pool_block=ec.pool_block,
                   glicko2=False, widen_per_sec=q.widen_per_sec,
                   max_threshold=q.max_threshold)
        pool, _, _ = kernel_inputs(torch, seed, FULL_P, waiting, FULL_B,
                                   False, "cuda")
        arrays = {k: v.cpu().numpy() for k, v in pool.items()}
        free = np.nonzero(~arrays["active"])[0]
        dense = KernelSet(**geo)
        dpool = pool_from_reference(arrays, "cuda")
        sets = {ring: sharded.ShardedKernelSet(
            mesh=distributed.global_pool_mesh("cuda"), ring=ring, **geo)
            for ring in (False, True)}
        spools = {ring: ks.place_pool(arrays) for ring, ks in sets.items()}
        names = {False: "process_mesh_all_gather", True: "process_mesh_ring"}
        counts = {name: 0 for name in ("dense", *names.values())}

        def counted(name, step, *args):
            """``step(*args)``, its ``block_best`` launches added to
            ``counts[name]`` (the difference across the call)."""
            before = ck.LAUNCHES["block_best"]
            out = step(*args)
            counts[name] += ck.LAUNCHES["block_best"] - before
            return out
        for w in range(windows):
            packed = np.zeros((9, FULL_B), np.float32)
            packed[0] = free[w * FULL_B:(w + 1) * FULL_B]
            packed[1] = rng.normal(1500, 300, FULL_B)
            packed[2] = 350.0
            packed[5] = q.rating_threshold
            packed[7] = 1.0
            packed[8] = 1.0 + w
            pk = torch.from_numpy(packed).cuda()
            want = counted("dense", dense.search_step_packed, dpool, pk)
            for ring, ks in sets.items():
                got = counted(names[ring], ks.search_step_packed,
                              spools[ring], pk)
                if not torch.equal(got, want):
                    raise AssertionError(f"14d window {w} (ring {ring}): "
                                         f"the process mesh's step differs")
        for ring, sp in spools.items():
            for col, v in dpool.items():
                if not torch.equal(sp[col], v):
                    raise AssertionError(f"14d (ring {ring}): pool column "
                                         f"{col} differs")
        # A group of one holds one shard: one launch a window each.
        if any(n != windows for n in counts.values()):
            raise AssertionError(f"14d: block_best launches {counts} for "
                                 f"{windows} windows")
        # The dense step is what the mesh is compared with: its launches
        # stay out of the process mesh's.
        res["dense_launches"] = counts.pop("dense")
        res["launches"] = counts
        res["windows"] = windows
        # serve under MM_DCN_*: its process joins (already joined) and
        # serves config #1 over the fake AMQP.
        url = f"amqp://dcn-{uuid.uuid4().hex[:8]}"
        handle = ServeHandle({**dcn, "MM_BROKER_URL": url,
                              "MM_CONFIG_JSON": os.path.join(HERE, path)},
                             fake_pika)
        app = await handle.start()
        client = amqp_transport.AmqpBroker(url, pika_module=fake_pika,
                                           reconnect_base_s=0.01)
        clog = ClientLog(client, "dcn.replies")
        pop = Population(np, rng, 1024, time.time(), filters=False,
                         glicko2=False)
        reset_counts(ck)
        soak_s, p50, p99, _ = await client_soak(
            client, app.queue_cfg.name, request_bodies(pop, 0, 1024), 256,
            clog, "14d serve")
        statuses = {}
        for pid, got in clog.got.items():
            status = json.loads(got[0][1])["status"]
            statuses[status] = statuses.get(status, 0) + 1
            if status not in ("matched", "queued"):
                raise AssertionError(f"14d serve: {pid} answered {status}")
        check_faults(app, "14d serve")
        res["serve"] = {"requests": 1024, "seconds": soak_s,
                        "latency_ms_p50": p50, "latency_ms_p99": p99,
                        "statuses": statuses,
                        "launches": ck.LAUNCHES["block_best"],
                        "process_group_joined":
                            distributed.process_group_active()}
        client.close()
        await handle.finish()
    finally:
        distributed.shutdown_distributed()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log(f"14d: NCCL group of one joined in {res['init_ms']:.1f} ms; the "
        f"process mesh's step = dense over {windows} windows (all-gather "
        f"and ring); serve under MM_DCN_* answered 1,024 requests "
        f"({res['serve']['statuses']}), p50 {res['serve']['latency_ms_p50']:.1f}"
        f" ms")
    return res


def phase_sharded(torch, np, ck, scoring, mods, phase_s):
    """Phase 14's four parts, each's seconds into ``phase_s``."""
    elo = "configs/elo_1v1.json"
    parts = {
        "14a": lambda: run_sharded(torch, np, ck, scoring, mods, elo,
                                   waiting=100_000, windows=48,
                                   timed_windows=16, profile_windows=8,
                                   seed=28),
        "14b": lambda: run_bucket_frontier(torch, np, ck, scoring, mods, elo,
                                           waiting=1_500, grow=3_000,
                                           windows=8, seed=29),
        "14c": lambda: run_sharded_teams(torch, np, mods, seed=30),
        "14d": lambda: asyncio.run(run_process_mesh(
            torch, np, ck, mods, elo, waiting=100_000, windows=4, seed=31)),
    }
    res = {}
    for name, run in parts.items():
        t = time.perf_counter()
        res[name] = run()
        phase_s[name] = time.perf_counter() - t
    return res


# ---- phase 15: placement and device-loss failover ---------------------------


def card_memory(torch):
    """(allocated, reserved) MiB after a collection and an emptied cache:
    what the engines alive hold."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return (torch.cuda.memory_allocated() / 2**20,
            torch.cuda.memory_reserved() / 2**20)


def captures_of(eng):
    rep = eng.graph_report()
    return rep["captures"] if rep else 0


class Segment:
    """The ``block_best`` and ``quality_accum`` launches of one engine's
    windows: from ``open`` to ``close``, the launches less the warm run
    each first-use capture makes (D ``block_best`` on a sharded engine),
    over the windows it finalized."""

    def __init__(self, ck, eng, d):
        self.ck, self.eng, self.d = ck, eng, d
        self.launches0 = dict(ck.LAUNCHES)
        self.windows0 = eng.spans["windows"]
        self.captures0 = captures_of(eng)

    def close(self):
        """The segment's counts; the engine is no longer held."""
        ck, eng, d = self.ck, self.eng, self.d
        self.eng = None
        windows = eng.spans["windows"] - self.windows0
        warm = captures_of(eng) - self.captures0
        bb = ck.LAUNCHES["block_best"] - self.launches0["block_best"]
        qa = ck.LAUNCHES["quality_accum"] - self.launches0["quality_accum"]
        return {"d": d, "windows": windows, "warm_runs": warm,
                "block_best": bb, "quality_accum": qa,
                "block_best_a_window": (bb - d * warm) / max(1, windows),
                "quality_accum_a_window": (
                    (qa - (warm if d == 1 else 0)) / max(1, windows))}


def check_segment(seg, what):
    """One a window on one device, D a window and no quality_accum
    sharded; a segment with no window checks nothing."""
    d = seg["d"]
    if not seg["windows"]:
        raise AssertionError(f"{what}: no window ran on D = {d}")
    want = (float(d), 0.0 if d > 1 else 1.0)
    got = (seg["block_best_a_window"], seg["quality_accum_a_window"])
    if got != want:
        raise AssertionError(f"{what}: block_best, quality_accum a window "
                             f"{got} on D = {d}, expected {want}: {seg}")


def matched_of(answers, published, what):
    """Every published request answered from its window once (queued or
    matched), a restored player only matched, partners agree. Returns
    (player → match, players matched more than once)."""
    matched, dup = {}, 0
    for pid, rs in answers.items():
        seq = [r.status for r in rs]
        ok = ((["matched"], ["queued"], ["queued", "matched"])
              if pid in published else (["matched"],))
        if seq not in ok:
            raise AssertionError(f"{what}: {pid} answered {seq}")
        for r in rs:
            if r.status == "matched":
                dup += pid in matched
                matched[pid] = r.match
    for pid, m in matched.items():
        other = next(p for p in m.players if p != pid)
        if other not in matched or matched[other].match_id != m.match_id:
            raise AssertionError(f"{what}: {pid}'s partner disagrees")
    missing = published - set(answers)
    if missing:
        raise AssertionError(f"{what}: {len(missing)} requests never "
                             f"answered")
    return matched, dup


def account_answers(app, answers, restored, published, what):
    """``matched_of``, and every restored or published player matched or
    still waiting, never both. Returns (matched, lost, duplicated) as the
    JAX package's placement soak counts them."""
    matched, dup = matched_of(answers, published, what)
    waiting = set()
    for rt in app._runtimes.values():
        waiting |= {str(p) for p in rt.engine.waiting_columns()[0].ids}
    both = waiting & set(matched)
    if both:
        raise AssertionError(f"{what}: {len(both)} players matched and "
                             f"still waiting")
    lost = len((restored | published) - set(matched) - waiting)
    return matched, lost, dup


async def publish_soak(app, queue, pop, lo, hi, burst, reply, t_pub,
                       between=None, tier_of=None, rng=None):
    """Publish rows [lo, hi) of ``pop`` to ``queue`` in bursts; after each
    burst ``between(k)`` (k = the burst's index) may act. With ``tier_of``
    (a dict), each request gets an ``x-tier`` header drawn from 0-2, which
    ``tier_of`` records."""
    from matchmaking_tpu_torch.service.broker import Properties

    for k, b in enumerate(range(lo, hi, burst)):
        for j in range(b, min(b + burst, hi)):
            pid = pop.ids[j]
            body = {"id": pid, "rating": float(pop.rating[j])}
            if pop.region[j] != "*":
                body["region"] = pop.region[j]
            if pop.mode[j] != "*":
                body["game_mode"] = pop.mode[j]
            headers = {}
            if tier_of is not None:
                tier_of[pid] = int(rng.integers(0, 3))
                headers["x-tier"] = str(tier_of[pid])
            t_pub[pid] = time.perf_counter()
            app.broker.publish(queue, json.dumps(body).encode(), Properties(
                reply_to=reply, correlation_id=pid, headers=headers))
        await asyncio.sleep(0.005)
        if between is not None:
            await between(k)


async def wait_answered(app, alog, want, timeout=120.0):
    """Until every id of ``want`` has an answer (``alog``: an AnswerLog)
    and no window is in flight; then every answer, cid → responses."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if (want <= alog.times.keys() and not any(
                rt.engine.inflight() for rt in app._runtimes.values()
                if hasattr(rt.engine, "inflight"))):
            break
        await asyncio.sleep(0.01)
    await asyncio.sleep(0.05)
    return await alog.read()


async def service_failover(np, torch, ck, mods, path, *, waiting, requests,
                           burst, seed, lost_step):
    """15a: config #1 sharded two ways on the inventory ``("cuda:0",) ×
    2`` (the app's logical devices 0 and 1 on the one card), ``waiting``
    restored, then phase 4's soak with the ``lost_step``-th device step
    lost. The queue demotes to (0,) once: ``device_failovers`` 1, the
    failover audit's ``restored`` the pool before the loss, two
    ``block_best`` launches a window and no ``quality_accum`` before the
    loss, one of each a window after it, the quality counters carried
    across the rebuild, the old engine freed. Every request answered once,
    nobody in two matches. The blackout is split into the engine's build,
    the column restore and the rest."""
    import dataclasses
    import weakref

    from matchmaking_tpu_torch.config import ChaosConfig
    from matchmaking_tpu_torch.service.app import MatchmakingApp

    Config, _, RequestColumns, _ = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    name = cfg.queues[0].name
    cfg = dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, warm_start=True,
                                        mesh_pool_axis=2),
        chaos=ChaosConfig(queues=(name,), device_lost_steps=(lost_step,)))
    if cfg.batcher.max_batch > max(cfg.engine.batch_buckets):
        raise AssertionError("15a: a window would take several chunks")
    rng = np.random.default_rng(seed)
    t0 = time.time()
    pop = Population(np, rng, waiting + requests, t0, filters=False,
                     glicko2=False)
    app = MatchmakingApp(cfg, device="cuda", devices=("cuda:0",) * 2)
    await app.start()
    rt = app.runtime(name)
    reply = "fo.replies"
    app.broker.declare_queue(reply)
    loss: dict = {}
    try:
        if rt.placement is not None or len(rt.engine.kernels.mesh.devices) != 2:
            raise AssertionError("15a: the queue is not sharded two ways")
        app.restore_columns(pop.columns(RequestColumns, app.engine, 0,
                                        waiting, t0, reply),
                            pop.region[:waiting], pop.mode[:waiting], t0)
        reset_counts(ck)
        before = Segment(ck, rt.engine, 2)
        real_revive, real_make = rt._revive, rt._make_engine
        real_restore = rt._restore_into
        split = {}

        def make():
            t = time.perf_counter()
            eng = real_make()
            split["build_ms"] = (time.perf_counter() - t) * 1e3
            return eng

        def restore(engine, *a):
            t = time.perf_counter()
            real_restore(engine, *a)
            split["restore_ms"] = (time.perf_counter() - t) * 1e3

        def revive(now):
            if rt._lost_device is None or loss:
                return real_revive(now)
            old = rt.engine
            loss.update(segment=before.close(), pool=old.pool_size(),
                        quality=old.quality_checkpoint(),
                        memory_before=card_memory(torch))
            ref = weakref.ref(old)
            del old
            t = time.perf_counter()
            real_revive(now)
            loss["revive_ms"] = (time.perf_counter() - t) * 1e3
            loss["split"] = dict(split)
            loss["after"] = Segment(ck, rt.engine, 1)
            quality = rt.engine.quality_checkpoint()
            loss["quality_carried"] = all(
                np.array_equal(quality[k], loss["quality"][k])
                for k in quality)
            # The failed dispatch's traceback still holds the old engine
            # here: it is checked once the soak is over.
            loss["old_engine"] = ref

        rt._revive, rt._make_engine, rt._restore_into = revive, make, restore
        alog = AnswerLog(app, reply)
        t_pub: dict = {}
        t_soak = time.perf_counter()
        await publish_soak(app, name, pop, waiting, waiting + requests,
                           burst, reply, t_pub)
        answers = await wait_answered(app, alog, set(t_pub))
        soak_s = time.perf_counter() - t_soak
        after = loss["after"].close() if loss else None
        if loss:
            # The demoted engine's first-use captures (warm run and
            # capture), paid by its first windows after the blackout.
            rep = rt.engine.graph_report() or {"graphs": {}}
            loss["captures_ms_after"] = sum(
                g["warm_ms"] + g["capture_ms"] for g in rep["graphs"].values())
            loss["memory_after"] = card_memory(torch)
            loss["old_engine_freed"] = loss.pop("old_engine")() is None
        audit = [dict(e) for e in rt.failover_log]
        placement = rt.placement
        quality_samples = int(rt.engine.quality_checkpoint()["count"].sum())
    finally:
        rt._revive = real_revive
        await app.stop()
    if not loss:
        raise AssertionError("15a: no device was lost")
    launches = dict(ck.LAUNCHES)
    matched, lost, dup = account_answers(
        app, answers, set(pop.ids[:waiting].tolist()), set(t_pub), "15a")
    failovers = app.metrics.counters.get("device_failovers")
    if failovers != 1 or placement != (0,) or len(audit) != 1:
        raise AssertionError(f"15a: {failovers} failovers, placement "
                             f"{placement}, audit {audit}")
    entry = audit[0]
    if (entry["from_devices"], entry["to_devices"], entry["restored"]) != (
            [0, 1], [0], loss["pool"]):
        raise AssertionError(f"15a: audit {entry}, pool at the loss "
                             f"{loss['pool']}")
    check_segment(loss["segment"], "15a before the loss")
    check_segment(after, "15a after the loss")
    if not loss["quality_carried"] or not loss["old_engine_freed"]:
        raise AssertionError(f"15a: quality carried "
                             f"{loss['quality_carried']}, old engine freed "
                             f"{loss['old_engine_freed']}")
    ledger = app.quality.snapshot()["queues"][name]["matched_players"]
    if lost or dup or ledger != len(matched) or quality_samples != len(matched):
        raise AssertionError(f"15a: lost {lost}, duplicated {dup}, ledger "
                             f"{ledger}, engine {quality_samples} for "
                             f"{len(matched)} matched")
    faults = app.faults()
    if faults != {"engine_failures": 1, "revives": 1}:
        raise AssertionError(f"15a: faults {faults}")
    blackout = entry["blackout_ms"]
    split = loss["split"]
    split["rest_ms"] = blackout - split["build_ms"] - split["restore_ms"]
    lat = [(alog.times[p][0] - t_pub[p]) * 1e3 for p in t_pub]
    res = {"config": path, "waiting": waiting, "requests": requests,
           "lost_step": lost_step, "blackout_ms": blackout,
           "blackout_split_ms": split, "revive_host_ms": loss["revive_ms"],
           "restored": entry["restored"],
           "before": loss["segment"], "after": after,
           "first_captures_after": after["warm_runs"],
           "first_captures_ms_after": loss["captures_ms_after"],
           "memory_mib_before": loss["memory_before"],
           "memory_mib_after": loss["memory_after"],
           "players_matched": len(matched), "lost": lost, "duplicated": dup,
           "soak_s": soak_s, "requests_per_s": requests / soak_s,
           "latency_ms_p50": statistics.median(lat),
           "latency_ms_p99": pct(lat, 0.99),
           "launches": {k: launches[k] for k in ("block_best",
                                                 "quality_accum")}}
    log(f"15a failover: D=2 -> D=1 at step {lost_step}, {entry['restored']} "
        f"players restored, blackout {blackout:.1f} ms (build "
        f"{split['build_ms']:.1f}, restore {split['restore_ms']:.1f}, rest "
        f"{split['rest_ms']:.1f}); block_best a window "
        f"{loss['segment']['block_best_a_window']} before, "
        f"{after['block_best_a_window']} after ({after['warm_runs']} first "
        f"captures, {loss['captures_ms_after']:.1f} ms); memory MiB allocated, reserved {loss['memory_before']}"
        f" -> {loss['memory_after']}; {res['requests_per_s']:.0f} "
        f"requests/s, p50 {res['latency_ms_p50']:.1f} ms p99 "
        f"{res['latency_ms_p99']:.1f} ms")
    return res


#: The scripted placement cycle (the JAX bench's placement soak): each
#: action at a fraction of the soak's bursts, and its binding's shard
#: degree.
CYCLE = ((0.2, "migrate", (1,)), (0.4, "promote", (1, 2)),
         (0.6, "demote", (1,)), (0.8, "migrate", (0,)))


async def service_placement_cycle(np, torch, ck, mods, path, *, waiting,
                                  requests, burst, seed):
    """15b: "soak.hot" at config #1's width (``waiting`` restored) and
    "soak.cold" on the inventory ``("cuda:0",) × 4``, the controller on
    (``interval_s`` 3600, four devices, ``max_shard`` 2, no cooldown);
    seeded load on the hot queue the whole time while ``CYCLE`` runs
    through ``PlacementController.force``: migrate (0) → (1), promote →
    (1, 2), demote → (1), migrate back → (0). Lost 0 and duplicated 0 (the
    JAX soak's count: every player matched or still waiting, no player
    matched twice), every decision applied, the final binding (0,),
    ``block_best`` launches a window of 1, 2, 1 and 1 at the four
    bindings, each old engine freed. Then one ``step()`` on the live
    signal view."""
    import dataclasses
    import weakref

    from matchmaking_tpu_torch.config import PlacementConfig
    from matchmaking_tpu_torch.service import app as app_module
    from matchmaking_tpu_torch.service.app import MatchmakingApp

    Config, _, RequestColumns, _ = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    base = cfg.queues[0]
    cfg = dataclasses.replace(
        cfg, queues=(dataclasses.replace(base, name="soak.hot"),
                     dataclasses.replace(base, name="soak.cold")),
        engine=dataclasses.replace(cfg.engine, warm_start=True),
        placement=PlacementConfig(interval_s=3600.0, devices=4, max_shard=2,
                                  cooldown_s=0.0))
    rng = np.random.default_rng(seed)
    t0 = time.time()
    pop = Population(np, rng, waiting + requests, t0, filters=False,
                     glicko2=False)
    app = MatchmakingApp(cfg, device="cuda", devices=("cuda:0",) * 4)
    await app.start()
    ctrl, rt = app.placement, app.runtime("soak.hot")
    reply = "cycle.replies"
    app.broker.declare_queue(reply)
    segments, actions = [], []
    real_rebuild = app_module.rebuild_engine
    try:
        boot = {q: app.runtime(q).placement for q in ("soak.hot",
                                                      "soak.cold")}
        if boot != {"soak.hot": (0,), "soak.cold": (1,)}:
            raise AssertionError(f"15b: boot placements {boot}")
        app.restore_columns(pop.columns(RequestColumns, rt.engine, 0, waiting,
                                        t0, reply),
                            pop.region[:waiting], pop.mode[:waiting], t0,
                            queue="soak.hot")
        reset_counts(ck)
        seg = [Segment(ck, rt.engine, 1)]

        def rebuild(old, make, **kw):
            # Under the pool lock, after the drain: the old binding's
            # windows are all in.
            segments.append(seg[0].close())
            return real_rebuild(old, make, **kw)

        app_module.rebuild_engine = rebuild
        n_bursts = -(-requests // burst)
        at = {int(frac * n_bursts): (kind, devs)
              for frac, kind, devs in CYCLE}

        async def between(k):
            if k not in at:
                return
            kind, devs = at[k]
            mem0 = card_memory(torch)
            ref = weakref.ref(rt.engine)
            dec = await ctrl.force(kind, "soak.hot", devs,
                                   reason=f"smoke cycle {kind}")
            mem1 = card_memory(torch)
            seg[0] = Segment(ck, rt.engine, len(devs))
            actions.append({"kind": kind, "to": list(devs),
                            "status": dec["status"],
                            "blackout_ms": dec["blackout_ms"],
                            "transferred": dec["transferred"],
                            "memory_mib_before": mem0,
                            "memory_mib_after": mem1,
                            "old_engine_freed": ref() is None})

        alog = AnswerLog(app, reply)
        t_pub: dict = {}
        t_soak = time.perf_counter()
        await publish_soak(app, "soak.hot", pop, waiting, waiting + requests,
                           burst, reply, t_pub, between=between)
        answers = await wait_answered(app, alog, set(t_pub))
        soak_s = time.perf_counter() - t_soak
        segments.append(seg[0].close())
        final = rt.placement
        snap = ctrl.snapshot()
        # One control tick on the live signal view: what the policy reads
        # and what it chooses after the cycle.
        app.sample_telemetry()
        view = ctrl.signal_view(time.time())
        chosen = await ctrl.step(view=view)
        tick = {"view": {q: s.to_dict() for q, s in view.queues.items()},
                "decision": chosen}
    finally:
        app_module.rebuild_engine = real_rebuild
        await app.stop()
    launches = dict(ck.LAUNCHES)
    matched, lost, dup = account_answers(
        app, answers, set(pop.ids[:waiting].tolist()), set(t_pub), "15b")
    applied = [d for d in snap["decisions"] if d["status"] == "applied"]
    if (lost or dup or final != (0,) or len(actions) != len(CYCLE)
            or len(applied) != len(CYCLE)
            or any(not a["old_engine_freed"] for a in actions)):
        raise AssertionError(f"15b: lost {lost}, duplicated {dup}, final "
                             f"{final}, actions {actions}")
    if [s["d"] for s in segments] != [1, 1, 2, 1, 1]:
        raise AssertionError(f"15b: segments {segments}")
    for s in segments:
        check_segment(s, "15b")
    check_faults(app, "15b")
    lat = [(alog.times[p][0] - t_pub[p]) * 1e3 for p in t_pub]
    res = {"config": path, "waiting": waiting, "requests": requests,
           "actions": actions, "segments": segments,
           "block_best_a_window": [s["block_best_a_window"]
                                   for s in segments[1:]],
           "players_matched": len(matched), "lost": lost, "duplicated": dup,
           "final_binding": list(final), "soak_s": soak_s,
           "requests_per_s": requests / soak_s,
           "latency_ms_p50": statistics.median(lat),
           "latency_ms_p99": pct(lat, 0.99), "tick": tick,
           "launches": {k: launches[k] for k in ("block_best",
                                                 "quality_accum")}}
    log("15b placement cycle: " + "; ".join(
        f"{a['kind']} -> {a['to']} {a['blackout_ms']:.1f} ms, "
        f"{a['transferred']} players, MiB {a['memory_mib_before']} -> "
        f"{a['memory_mib_after']}" for a in actions)
        + f"; block_best a window {res['block_best_a_window']}; lost {lost}"
        f", duplicated {dup}; {res['requests_per_s']:.0f} requests/s, p50 "
        f"{res['latency_ms_p50']:.1f} ms p99 {res['latency_ms_p99']:.1f} ms;"
        f" live tick: view {tick['view']}, chose {tick['decision']}")
    return res


async def service_arbiter(np, ck, mods, path, *, waiting, requests, burst,
                          seed, arbiter):
    """15c, one leg: config #2's two queues both bound to logical device 0
    (``PlacementConfig(interval_s=3600, devices=1)``: the boot packs both
    on (0,), so the dispatch arbiter engages), each with ``waiting``
    restored and ``requests`` published with tiers 0-2, the arbiter on or
    off. Every answer within its queue's threshold and filters; with the
    arbiter on it is engaged and granted every window's dispatch, and a
    contended grant (a window that waited) always went to the least
    (tier, deadline) key then waiting. Requests/s and p50/p99 by tier."""
    import dataclasses

    from matchmaking_tpu_torch.config import OverloadConfig, PlacementConfig
    from matchmaking_tpu_torch.service.app import MatchmakingApp

    Config, _, RequestColumns, _ = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    names = [q.name for q in cfg.queues]
    thr = {q.name: q.rating_threshold for q in cfg.queues}
    cfg = dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, warm_start=True),
        overload=OverloadConfig(tiers=3, edf=True, max_inflight=8_192,
                                batch_admission=True),
        placement=PlacementConfig(interval_s=3600.0, devices=1,
                                  arbiter=arbiter))
    rng = np.random.default_rng(seed)
    t0 = time.time()
    app = MatchmakingApp(cfg, device="cuda", devices=("cuda:0",))
    await app.start()
    ctrl = app.placement
    pops, logs, t_pub = {}, {}, {}
    out_of_order = []
    try:
        bound = {n: app.runtime(n).placement for n in names}
        if set(bound.values()) != {(0,)} or not ctrl.arbiter.engaged(0):
            raise AssertionError(f"15c: bindings {bound}, shared "
                                 f"{ctrl.arbiter.snapshot()}")
        arb = ctrl.arbiter
        real_release = arb._release

        def release(device):
            # The waiter granted next must hold the least key waiting.
            heap = arb._waiting.get(device)
            if heap and heap[0][0] != min(e[0] for e in heap):
                out_of_order.append(heap[0][0])
            real_release(device)

        arb._release = release
        for name, prefix in zip(names, "rc"):
            pop = pops[name] = Population(np, rng, waiting + requests, t0,
                                          filters=True, glicko2=False)
            pop.ids = np.char.add(prefix, np.arange(waiting + requests)
                                  .astype(str)).astype(object)
            reply = f"arb.{prefix}.replies"
            app.broker.declare_queue(reply)
            logs[name] = AnswerLog(app, reply)
            app.restore_columns(pop.columns(RequestColumns,
                                            app.runtime(name).engine, 0,
                                            waiting, t0, reply),
                                pop.region[:waiting], pop.mode[:waiting], t0,
                                queue=name)
        reset_counts(ck)
        tier_of: dict = {}
        t_soak = time.perf_counter()
        await asyncio.gather(*(
            publish_soak(app, name, pops[name], waiting, waiting + requests,
                         burst, f"arb.{p}.replies", t_pub, tier_of=tier_of,
                         rng=np.random.default_rng(seed + i))
            for i, (name, p) in enumerate(zip(names, "rc"))))
        answers = {name: await wait_answered(
            app, logs[name], set(pops[name].ids[waiting:].tolist()))
            for name in names}
        soak_s = time.perf_counter() - t_soak
        snap = arb.snapshot()
    finally:
        await app.stop()
    check_faults(app, "15c")
    windows = sum(app.runtime(n).counters["windows"] for n in names)
    # Every window's dispatch takes the slot once while it is engaged.
    if arbiter and (snap["grants"] != windows or out_of_order):
        raise AssertionError(f"15c: arbiter {snap} for {windows} windows, "
                             f"out of order {out_of_order}")
    if not arbiter and snap["grants"]:
        raise AssertionError(f"15c: the arbiter off granted {snap}")
    res = {"arbiter": arbiter, "requests": 2 * requests, "windows": windows,
           "soak_s": soak_s,
           "requests_per_s": 2 * requests / soak_s,
           "arbiter_snapshot": snap, "latency_ms_by_tier": {},
           "players_matched": {}, "launches": {
               k: ck.LAUNCHES[k] for k in ("block_best", "quality_accum")}}
    lat_tier: dict = {}
    for name in names:
        pop, got = pops[name], answers[name]
        published = set(pop.ids[waiting:].tolist())
        rating = {pid: float(r) for pid, r in zip(pop.ids.tolist(),
                                                  pop.rating.tolist())}
        row = {pid: k for k, pid in enumerate(pop.ids.tolist())}
        matched, dup = matched_of(got, published, f"15c {name}")
        if dup:
            raise AssertionError(f"15c {name}: {dup} players matched twice")
        for pid, m in matched.items():
            other = next(p for p in m.players if p != pid)
            if other not in rating:
                raise AssertionError(f"15c {name}: {pid} matched {other}, "
                                     f"who is not on this queue")
            if abs(rating[pid] - rating[other]) > thr[name]:
                raise AssertionError(f"15c {name}: {pid} and {other} "
                                     f"{abs(rating[pid] - rating[other])} "
                                     f"apart, threshold {thr[name]}")
            a, b = row[pid], row[other]
            for col in (pop.region, pop.mode):
                if "*" not in (col[a], col[b]) and col[a] != col[b]:
                    raise AssertionError(f"15c {name}: {pid} and {other} "
                                         f"fail a filter")
        res["players_matched"][name] = len(matched)
        for pid in published:
            lat_tier.setdefault(tier_of[pid], []).append(
                (logs[name].times[pid][0] - t_pub[pid]) * 1e3)
    res["latency_ms_by_tier"] = {
        t: {"p50": statistics.median(v), "p99": pct(v, 0.99), "n": len(v)}
        for t, v in sorted(lat_tier.items())}
    log(f"15c arbiter {'on' if arbiter else 'off'}: {windows} windows, "
        f"{res['requests_per_s']:.0f} requests/s, by tier "
        + ", ".join(f"t{t} p50 {v['p50']:.1f} p99 {v['p99']:.1f} ms"
                    for t, v in res["latency_ms_by_tier"].items())
        + f"; arbiter {snap}")
    return res


def phase_placement(np, torch, ck, mods, phase_s):
    """Phase 15's three parts, each's seconds into ``phase_s``: 15a the
    failover, 15b the placement cycle, 15c the arbiter on and off in turns
    (on, off, off, on)."""
    elo = "configs/elo_1v1.json"
    res = {}
    t = time.perf_counter()
    res["15a"] = asyncio.run(service_failover(
        np, torch, ck, mods, elo, waiting=100_000, requests=16_384,
        burst=512, seed=32, lost_step=8))
    phase_s["15a"] = time.perf_counter() - t
    t = time.perf_counter()
    res["15b"] = asyncio.run(service_placement_cycle(
        np, torch, ck, mods, elo, waiting=100_000, requests=16_384,
        burst=512, seed=33))
    phase_s["15b"] = time.perf_counter() - t
    t = time.perf_counter()
    legs = []
    for i, on in enumerate((True, False, False, True)):
        legs.append(asyncio.run(service_arbiter(
            np, ck, mods, "configs/multiqueue_filters.json", waiting=20_000,
            requests=2_048, burst=512, seed=34 + i, arbiter=on)))
    res["15c"] = legs
    phase_s["15c"] = time.perf_counter() - t
    return res


# ---- phase 16: the port's sanitizer, matchlint and model checker ------------


def hold_rows(san, top=5):
    """The sanitizer's ``top`` slowest lock sites (by max), the site
    shortened to file:line (function)."""
    return [dict(stats, site=site.replace(HERE + os.sep, ""))
            for site, stats in san.hold_report(top=top).items()]


async def sanitized_leg(np, ck, cfg, pop, *, waiting, requests, burst, san,
                        what):
    """One 16a leg: config #1's service with the journal and an in-process
    standby, the 100k recovered at start, phase 4's soak. ``san`` is the
    installed sanitizer or None. Every request answered once, nobody
    lost or in two matches, one ``block_best`` and one ``quality_accum``
    a window, the standby's shadow the pool."""
    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.replication import ReplicationHub

    queue = cfg.queues[0].name
    reply = "san.replies"
    hub = ReplicationHub(lease_s=LEASE_S)
    app = MatchmakingApp(cfg, device="cuda", replication_hub=hub)
    await app.start()
    rt = app.runtime(queue)
    meter = None
    try:
        rec = rt.last_recovery
        if rec is None or rec["snapshot_players"] != waiting:
            raise AssertionError(f"{what}: recovered {rec}")
        standby = hub.standby(queue, owner="hostB")
        standby.pump()  # the baseline, before the soak
        meter = StandbyPump(rt, standby)
        app.broker.declare_queue(reply)
        alog = AnswerLog(app, reply)
        reset_counts(ck)
        seg = Segment(ck, rt.engine, 1)
        t_pub: dict = {}
        t_soak = time.perf_counter()
        await publish_soak(app, queue, pop, waiting, waiting + requests,
                           burst, reply, t_pub)
        answers = await wait_answered(app, alog, set(t_pub))
        soak_s = time.perf_counter() - t_soak
        await settle(app)
        await meter.quiesce()
        standby.pump()
        check_replication(app, rt, standby, what)
        segment = seg.close()
        launches = dict(ck.LAUNCHES)
        repl = meter.summary()
    finally:
        if meter is not None:
            meter.stop()
        await app.stop()
    matched, lost, dup = account_answers(
        app, answers, set(pop.ids[:waiting].tolist()), set(t_pub), what)
    if lost or dup:
        raise AssertionError(f"{what}: lost {lost}, duplicated {dup}")
    lat = [(alog.times[p][0] - t_pub[p]) * 1e3 for p in t_pub]
    return {"sanitized": san is not None, "requests": requests,
            "requests_per_s": requests / soak_s,
            "latency_ms_p50": statistics.median(lat),
            "latency_ms_p99": pct(lat, 0.99),
            "players_matched": len(matched), "lost": lost,
            "duplicated": dup, "windows": segment["windows"],
            "segment": segment, "recovery_rto_ms": rec["rto_ms"],
            "journal_commits": rt.journal_stats["commits"],
            "replication": repl,
            "launches": {k: launches[k] for k in ("block_best",
                                                  "quality_accum")}}


async def service_sanitized(np, ck, mods, path, *, waiting, requests, burst,
                            seed, keep_journal=None):
    """16a: config #1's service at full width with the journal on (phase
    8's fsync "window") and an in-process standby (phase 11's), the 100k
    recovered from a journal at each start, phase 4's soak: once under
    the port's ``AsyncSanitizer(stall_threshold_s=2.0)``, then once
    without. The sanitized leg must be clean (``assert_clean``); both
    legs answer every request once, lose nobody and launch ``block_best``
    and ``quality_accum`` once a window. Reports the 5 slowest lock sites,
    the longest loop stall, the settles the twin counted, and requests/s
    and p50/p99 of both legs."""
    import contextlib
    import dataclasses
    import shutil
    import tempfile

    from matchmaking_tpu_torch.config import ReplicationConfig
    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.testing.sanitizer import AsyncSanitizer

    Config, _, RequestColumns, _ = mods
    rng = np.random.default_rng(seed)
    t0 = time.time()
    pop = Population(np, rng, waiting + requests, t0, filters=False,
                     glicko2=False)
    work = tempfile.mkdtemp(prefix="mm_san_")
    seed_dir = os.path.join(work, "seed")
    res: dict = {"legs": []}
    try:
        # The 100k in a journal: restored, anchored, crashed.
        cfg0 = durable_cfg(Config, path, journal_dir=seed_dir, fsync="none")
        queue = cfg0.queues[0].name
        if cfg0.batcher.max_batch > max(cfg0.engine.batch_buckets):
            raise AssertionError("16a: a window would take several chunks")
        app0 = MatchmakingApp(cfg0, device="cuda")
        await app0.start()
        app0.restore_columns(pop.columns(RequestColumns, app0.engine, 0,
                                         waiting, t0, "san.replies"),
                             pop.region[:waiting], pop.mode[:waiting], t0)
        await app0.runtime(queue).compact_journal()
        await app0.crash()
        del app0
        for i, on in enumerate((True, False)):
            jdir = os.path.join(work, f"leg{i}")
            shutil.copytree(seed_dir, jdir)
            cfg = dataclasses.replace(
                durable_cfg(Config, path, journal_dir=jdir, fsync="window"),
                replication=ReplicationConfig(
                    role="primary", owner="hostA", pump_interval_s=PUMP_S))
            san = AsyncSanitizer(stall_threshold_s=2.0) if on else None
            what = f"16a {'sanitized' if on else 'plain'}"
            with (san.installed() if on else contextlib.nullcontext()):
                leg = await sanitized_leg(
                    np, ck, cfg, pop, waiting=waiting, requests=requests,
                    burst=burst, san=san, what=what)
            check_segment(leg["segment"], what)
            if on:
                san.assert_clean()
                report = san.settlement_report()
                leg.update(
                    findings=len(san.findings),
                    hold_sites=hold_rows(san),
                    longest_stall_ms=san.longest_stall_s * 1e3,
                    settles=report["settled"],
                    open_credits=len(report["open_credits"]))
                if not report["settled"]:
                    raise AssertionError("16a: the twin saw no settle")
            res["legs"].append(leg)
        if keep_journal:  # phase 17d reads the plain leg's journal
            shutil.copytree(os.path.join(work, "leg1"), keep_journal)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    on, off = res["legs"]
    res["requests_per_s_ratio"] = on["requests_per_s"] / off["requests_per_s"]
    log(f"16a sanitized soak: {on['findings']} findings, "
        f"{on['settles']} settles counted by the twin, longest loop stall "
        f"{on['longest_stall_ms']:.1f} ms; sanitized "
        f"{on['requests_per_s']:.0f} requests/s p50 "
        f"{on['latency_ms_p50']:.1f} p99 {on['latency_ms_p99']:.1f} ms, "
        f"plain {off['requests_per_s']:.0f} requests/s p50 "
        f"{off['latency_ms_p50']:.1f} p99 {off['latency_ms_p99']:.1f} ms; "
        f"{on['windows']} / {off['windows']} windows, lost 0")
    for row in on["hold_sites"]:
        log(f"16a hold site {row['site']}: count {row['count']}, p50 "
            f"{row['p50_ms']} p99 {row['p99_ms']} max {row['max_ms']} ms")
    return res


async def service_sanitized_spec(ck, mods, path):
    """16b: phase 4's speculating service (config #1 bucketed, the
    speculation loop alone matches two far players) under the port's
    sanitizer: clean, and its speculation twin saw at least one commit."""
    from matchmaking_tpu_torch.testing.sanitizer import AsyncSanitizer

    san = AsyncSanitizer(stall_threshold_s=2.0)
    with san.installed():
        run = await service_spec(ck, mods, path)
    san.assert_clean()
    if san.spec_commits < 1:
        raise AssertionError("16b: the speculation twin saw no commit")
    run.update(spec_commits_seen=san.spec_commits,
               longest_stall_ms=san.longest_stall_s * 1e3,
               hold_sites=hold_rows(san, top=3))
    log(f"16b sanitized speculation: clean, {san.spec_commits} commits seen "
        f"by the twin, launches {run['launches']} / "
        f"{run['quality_launches']}")
    return run


def lint_and_modelcheck():
    """16c: the port's matchlint over this checkout (nothing outside its
    baseline, no warnings) and the model checker at the JAX package's
    single-queue scope (clean and exhaustive), on this machine's
    Python."""
    from matchmaking_tpu_torch.analysis.engine import analyze_repo
    from matchmaking_tpu_torch.analysis.modelcheck import (
        ModelCheckConfig,
        run_modelcheck,
    )

    t = time.perf_counter()
    new, accepted, warnings = analyze_repo(HERE, use_cache=False)
    lint_s = time.perf_counter() - t
    if new or warnings:
        raise AssertionError("16c matchlint: " + "; ".join(
            [f.render() for f in new] + warnings))
    rep = run_modelcheck(ModelCheckConfig(
        queues=1, depth=4, admits=2, settles=1, faults=("expire", "drop"),
        fault_budget=2))
    if rep["modelcheck_violations"] or not rep["modelcheck_exhaustive"]:
        raise AssertionError(f"16c model checker: {rep}")
    res = {"python": sys.version.split()[0], "lint_s": lint_s,
           "lint_baselined": len(accepted),
           "modelcheck_states_explored": rep["modelcheck_states_explored"],
           "modelcheck_nodes": rep["modelcheck_nodes"],
           "modelcheck_s": rep["modelcheck_elapsed_s"]}
    log(f"16c matchlint clean in {lint_s:.1f} s ({len(accepted)} "
        f"baselined); model checker clean, "
        f"{res['modelcheck_states_explored']} states explored "
        f"({res['modelcheck_nodes']} schedules) in "
        f"{res['modelcheck_s']:.2f} s on Python {res['python']}")
    return res


def phase_sanitized(np, ck, mods, phase_s, keep_journal=None):
    """Phase 16's three parts, each's seconds into ``phase_s``."""
    elo = "configs/elo_1v1.json"
    res = {}
    t = time.perf_counter()
    res["16a"] = asyncio.run(service_sanitized(
        np, ck, mods, elo, waiting=100_000, requests=16_384, burst=512,
        seed=36, keep_journal=keep_journal))
    phase_s["16a"] = time.perf_counter() - t
    t = time.perf_counter()
    res["16b"] = asyncio.run(service_sanitized_spec(ck, mods, elo))
    phase_s["16b"] = time.perf_counter() - t
    t = time.perf_counter()
    res["16c"] = lint_and_modelcheck()
    phase_s["16c"] = time.perf_counter() - t
    return res


# ---- phase 17: the trace gate and the graphs on the card, entry(), tools ----


def call_targets(graph):
    """The operators a traced graph calls, in order."""
    return [str(n.target) for n in graph.graph.nodes
            if n.op == "call_function"]


def trace_gate_on_card(ck):
    """17a: the trace-time rules with the traces made on the card: clean,
    each family's operators equal its CPU trace's and its kernel operator
    nodes the family's."""
    from matchmaking_tpu_torch.analysis import device_audit, recompile

    t = time.perf_counter()
    cpu = {r.family.name: r for r in recompile.trace_families("cpu")}
    cpu_s = time.perf_counter() - t
    reset_counts(ck)
    t = time.perf_counter()
    card = recompile.trace_families("cuda", fresh=True)
    findings = (recompile.check_dynamic(traces=card)
                + device_audit.check_dynamic(traces=card))
    card_s = time.perf_counter() - t
    launches = dict(ck.LAUNCHES)
    if findings:
        raise AssertionError("17a: " + "; ".join(f.render()
                                                 for f in findings))
    nodes = {}
    for r in card:
        name = r.family.name
        got, want = call_targets(r.graph), call_targets(cpu[name].graph)
        if got != want:
            at = next((i for i, (a, b) in enumerate(zip(got, want))
                       if a != b), min(len(got), len(want)))
            raise AssertionError(
                f"17a {name}: the card trace's operators part from the CPU "
                f"trace's at call {at} of {len(got)} / {len(want)}: "
                f"{got[at:at + 3]} against {want[at:at + 3]}")
        k = recompile.kernel_nodes(r.graph)
        if (k["block_best"], k["quality_accum"]) != (r.family.block_best,
                                                     r.family.quality_accum):
            raise AssertionError(f"17a {name}: kernel operator nodes {k}")
        nodes[name] = {"nodes": len(r.graph.graph.nodes), **k}
    log(f"17a the trace gate on the card: {len(card)} captured step "
        f"families traced twice on cuda in {card_s:.1f} s (CPU "
        f"{cpu_s:.1f} s), graph code stable, operators equal to the CPU "
        f"traces', no finding; launches {launches}")
    return {"families": len(card), "card_s": card_s, "cpu_s": cpu_s,
            "nodes": nodes, "launches": launches}


#: 17b's engines: (label, config file, engine overrides).
AUDITED = (("elo_1v1", "configs/elo_1v1.json", {}),
           ("elo_1v1_pruned", "configs/elo_1v1.json", PRUNE),
           ("elo_1v1_bucketed_spec", "configs/elo_1v1.json",
            dict(BUCKETED, spec_formation=True, spec_max_steps=2)),
           ("team_5v5", "configs/team_5v5.json", {}),
           ("role_party", "configs/role_party.json", {}))


def captured_graph_audit(torch, ck, mods, profiled_kernels):
    """17b: every graph of the audited engines, warmed up at every bucket,
    captured again with its nodes kept and audited (``graphs.audit_dot``).
    ``profiled_kernels``: phase 3's kernels a window on the device."""
    import dataclasses
    import gc

    Config, GpuEngine, _, _ = mods
    reset_counts(ck)
    graphs = {}
    for label, path, over in AUDITED:
        cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
        if over:
            cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
                cfg.engine, **over))
        eng = GpuEngine(cfg, cfg.queues[0], device="cuda")
        eng.warmup()
        variants = eng._variants() + (("spec",) if eng._speculates()
                                      else ())
        for variant in variants:
            for bucket in eng.buckets:
                rep = eng.graph_audit(variant, bucket)
                if rep["problems"]:
                    raise AssertionError(f"17b {label} {variant}/{bucket}: "
                                         f"{rep['problems']}")
                graphs[f"{label}/{variant}/{bucket}"] = {
                    k: rep[k] for k in ("kernel_nodes", "memset_nodes",
                                        "nodes", "own_kernel_nodes",
                                        "launches", "copies")}
        eng.close()
        del eng
        gc.collect()
    launches = dict(ck.LAUNCHES)
    dense = graphs[f"elo_1v1/dense/{FULL_B}"]
    for key, g in graphs.items():
        own = g["own_kernel_nodes"]
        log(f"17b {key}: {g['kernel_nodes']} kernel nodes, "
            f"{g['memset_nodes']} memset, {g['nodes']} nodes; prep "
            f"{own['prep_kernel']}, block_best {own['block_best_kernel']}, "
            f"quality_accum {own['quality_accum_kernel']} = launches "
            f"{g['launches']}")
    log(f"17b config #1 dense at B = {FULL_B}: {dense['kernel_nodes']} "
        f"kernel nodes in its graph, phase 3's profiler {profiled_kernels} "
        f"kernels a window (the window's two copies beside the graph); "
        f"{len(graphs)} graphs audited, none with a host node or a copy "
        f"to the host; warm-up launches {launches}")
    return {"graphs": graphs, "launches": launches,
            "dense_kernel_nodes": dense["kernel_nodes"],
            "profiled_kernels_per_window": profiled_kernels}


def entry_and_dryrun(torch, ck):
    """17c: ``entry()``'s step captured and replayed against its eager call
    and a CPU run; the dry run on one card standing in for n against the
    CPU's line. Launches counted as the engine counts them (the capture's
    warm run and each replay)."""
    import io

    from matchmaking_tpu_torch import entry

    reset_counts(ck)
    graphs, step, rpool = entry.captured_entry("cuda")
    replayed = graphs.replay(step).clone()
    fn, (epool, packed) = entry.entry("cuda")
    eager = fn(epool, packed)
    fn, (cpool, packed) = entry.entry("cpu")
    cpu = fn(cpool, packed)
    if not (torch.equal(replayed.view(torch.int32), eager.view(torch.int32))
            and torch.equal(replayed.cpu().view(torch.int32),
                            cpu.view(torch.int32))):
        raise AssertionError("17c: entry()'s replayed step differs from its "
                             "eager call or the CPU run")
    for name in cpool:
        if not (torch.equal(rpool[name], epool[name])
                and torch.equal(rpool[name].cpu(), cpool[name])):
            raise AssertionError(f"17c: entry()'s pool column {name} differs")
    paired = int((cpu[0] < 8192).sum())
    lines = {}
    for n in (1, 2, 4, 8):
        got = {}
        for side, kw in (("cpu", dict(device="cpu")),
                         ("card", dict(devices=("cuda:0",) * n))):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                entry.dryrun_multichip(n, **kw)
            got[side] = buf.getvalue().strip()
        if got["card"] != got["cpu"]:
            raise AssertionError(f"17c dryrun_multichip({n}): {got}")
        lines[n] = got["card"]
        log(f"17c {got['card']} (= the CPU run's)")
    launches = dict(ck.LAUNCHES)
    log(f"17c entry(): the captured step replayed bit-equal to its eager "
        f"call and the CPU run ({paired} lanes paired of 48); launches "
        f"{launches}")
    return {"paired": paired, "dryrun": lines, "launches": launches}


def operator_tools(journal_dir, bundle_path):
    """17d: the port's offline tools, as an operator runs them, on this
    run's artifacts."""
    def tool(name, *args):
        proc = subprocess.run(
            [sys.executable, os.path.join(HERE, "scripts", name), *args],
            capture_output=True, text=True, timeout=120)
        return proc.returncode, proc.stdout, proc.stderr

    rc, out, err = tool("torch_journal_dump.py", journal_dir)
    if rc != 0 or "intact: True" not in out:
        raise AssertionError(f"17d journal dump: exit {rc}\n{out}\n{err}")
    rc, out, err = tool("torch_journal_dump.py", journal_dir, "--json")
    reports = json.loads(out)
    if rc != 0 or not reports or not all(r["intact"]
                                         for r in reports.values()):
        raise AssertionError(f"17d journal dump --json: exit {rc}\n{err}")
    segments = {q: {k: r["segment"][k] for k in ("records", "seq_min",
                                                 "seq_max", "clean_tail")}
                for q, r in reports.items() if r["segment"]}
    rc, out, err = tool("torch_postmortem.py", bundle_path)
    if rc != 0 or "root chain" not in out:
        raise AssertionError(f"17d postmortem: exit {rc}\n{out}\n{err}")
    rc, out, err = tool("torch_postmortem.py", bundle_path, "--json")
    analysis = json.loads(out)
    if rc != 0 or analysis["problems"]:
        raise AssertionError(f"17d postmortem --json: exit {rc}, "
                             f"{analysis.get('problems')}\n{err}")
    log(f"17d torch_journal_dump on 16a's journal: intact, exit 0, "
        f"segments {segments}; torch_postmortem on phase 7's bundle: exit "
        f"0, root chain {analysis['root_chain_kinds']}")
    return {"segments": segments,
            "root_chain_kinds": analysis["root_chain_kinds"]}


def phase_graphs(torch, ck, mods, phase_s, *, profiled_kernels, journal_dir,
                 bundle_path):
    """Phase 17's four parts, each's seconds into ``phase_s``."""
    res = {}
    for key, fn in (("17a", lambda: trace_gate_on_card(ck)),
                    ("17b", lambda: captured_graph_audit(
                        torch, ck, mods, profiled_kernels)),
                    ("17c", lambda: entry_and_dryrun(torch, ck)),
                    ("17d", lambda: operator_tools(journal_dir,
                                                   bundle_path))):
        t = time.perf_counter()
        res[key] = fn()
        phase_s[key] = time.perf_counter() - t
    return res


# ---- phase 18: grouped readback in the service ------------------------------

#: Phase 18's legs, in turns: (readback_group, readback_group_wait_ms).
GROUPED_LEGS = ((1, 2.0), (3, 2.0), (3, 8.0), (1, 2.0), (3, 2.0), (3, 8.0))


async def service_chaos_grouped(np, ck, mods, *, readback_group, seed=42,
                                n=400):
    """The JAX package's ``tests/test_soak.py`` soak traffic on the card:
    400 requests (ratings N(1500, 120)) in bursts of 50 under seeded
    broker chaos (drop 0.1, dup 0.15 on the request queue), widening, a
    multi-chunk rescan tick every 50 ms, depth 4, buckets 16/64/256, a
    2 ms window and group wait, the invariant checker armed: nothing dead
    lettered, matched + waiting >= 95 % of the players, matched > 50 %,
    no device error and no failure caught."""
    from matchmaking_tpu_torch.config import (
        BatcherConfig,
        BrokerConfig,
        ChaosConfig,
        EngineConfig,
        QueueConfig,
    )
    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.broker import Properties

    Config = mods[0]
    q = QueueConfig(rating_threshold=60.0, widen_per_sec=20.0,
                    max_threshold=300.0, rescan_interval_s=0.05,
                    rescan_window=1024)
    cfg = Config(
        queues=(q,),
        engine=EngineConfig(backend="gpu", pool_capacity=1024,
                            pool_block=256, batch_buckets=(16, 64, 256),
                            pipeline_depth=4, readback_group=readback_group,
                            readback_group_wait_ms=2.0),
        broker=BrokerConfig(max_redelivery=30),
        chaos=ChaosConfig(seed=seed, queues=(q.name,), drop_prob=0.1,
                          dup_prob=0.15),
        batcher=BatcherConfig(max_batch=256, max_wait_ms=2.0),
        debug_invariants=True)
    app = MatchmakingApp(cfg, device="cuda")
    await app.start()
    rng = np.random.default_rng(seed)
    reply = "soak.replies"
    app.broker.declare_queue(reply)
    reset_counts(ck)
    t = time.perf_counter()
    try:
        for i in range(n):
            body = (f'{{"id":"p{i}","rating":'
                    f'{float(rng.normal(1500, 120)):.2f}}}').encode()
            app.broker.publish(q.name, body, Properties(
                reply_to=reply, correlation_id=f"c{i}"))
            if i % 50 == 49:
                await asyncio.sleep(0.05)
        for _ in range(400):
            await asyncio.sleep(0.05)
            matched = app.metrics.counters.get("players_matched")
            waiting = app.runtime(q.name).engine.pool_size()
            if (app.broker.queue_depth(q.name) == 0
                    and matched + waiting >= n * 0.95 and matched > n * 0.5):
                break
        matched = app.metrics.counters.get("players_matched")
        engine = app.runtime(q.name).engine
        waiting = engine.pool_size()
        dead = app.broker.stats["dead_lettered"]
        error = engine.device_error
        grouped = engine._rb_k
    finally:
        await app.stop()
    run_s = time.perf_counter() - t
    check_faults(app, f"18b k={readback_group}")
    if (dead or matched + waiting < n * 0.95 or matched <= n * 0.5
            or error is not None or grouped != readback_group):
        raise AssertionError(f"18b k={readback_group}: dead {dead}, matched "
                             f"{matched}, waiting {waiting}, error {error}")
    res = {"readback_group": readback_group, "players": n,
           "matched": matched, "waiting": waiting, "dead_lettered": dead,
           "chaos": dict(app.broker.stats), "seconds": run_s,
           "launches": dict(ck.LAUNCHES)}
    log(f"18b the JAX soak's traffic at k={readback_group} (chaos, depth "
        f"4): {matched} matched, {waiting} waiting of {n}, 0 dead lettered, "
        f"invariants held, {run_s:.1f} s, launches {res['launches']}")
    return res


def phase_grouped_service(np, ck, mods, phase_s):
    """Phase 18: config #1's service (phase 4's soak: 100k restored,
    16,384 requests in bursts of 512, the invariant checker armed) at
    ``GROUPED_LEGS``' readback groups in turns (18a), then the JAX soak's
    chaos traffic at k = 3 (18b). A full collection runs before each leg,
    so that no leg pays for the garbage of the phases before it (without
    it, on an H100 80GB HBM3 at 700 W: a ~1 s collection inside each of
    the last four legs, k = 1 and 3 alike)."""
    import gc

    t = time.perf_counter()
    legs = []
    for k, wait_ms in GROUPED_LEGS:
        gc.collect()
        run = asyncio.run(service_soak(
            np, ck, mods, "configs/elo_1v1.json", waiting=100_000,
            requests=16_384, burst=512, seed=6, debug_invariants=True,
            engine_over={"readback_group": k,
                         "readback_group_wait_ms": wait_ms}))
        attr = run["attribution_ms_per_request"]
        leg = {"readback_group": k, "readback_group_wait_ms": wait_ms,
               **{key: run[key] for key in (
                   "requests_per_s", "latency_ms_p50", "latency_ms_p99",
                   "windows", "players_matched", "gc_ms")},
               # The soak checks one launch of each kernel a window.
               "launches": {"block_best": run["launches"],
                            "quality_accum": run["windows"]},
               "readback_group_wait_ms_per_request":
                   attr.get("readback_group_wait", 0.0),
               "readback_transfer_ms_per_request":
                   attr.get("readback_transfer", 0.0),
               "readback_ms_per_window":
                   run["util_report"]["readback_s"] * 1e3
                   / max(1, run["util_report"]["windows"])}
        legs.append(leg)
        log(f"18a k={k} wait {wait_ms} ms: {leg['requests_per_s']:.0f} "
            f"requests/s, p50 {leg['latency_ms_p50']:.2f} ms p99 "
            f"{leg['latency_ms_p99']:.2f} ms, readback_group_wait "
            f"{leg['readback_group_wait_ms_per_request']:.3f} and "
            f"readback_transfer "
            f"{leg['readback_transfer_ms_per_request']:.3f} ms a request, "
            f"{leg['windows']} windows, GC {leg['gc_ms']:.1f} ms")
    phase_s["18a"] = time.perf_counter() - t
    t = time.perf_counter()
    chaos = asyncio.run(service_chaos_grouped(np, ck, mods, readback_group=3))
    phase_s["18b"] = time.perf_counter() - t
    return {"18a": legs, "18b": chaos}


def main(argv) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is False: this smoke test needs a GPU")
        return 2
    sys.path.insert(0, HERE)
    try:
        from matchmaking_tpu_torch.config import Config
        from matchmaking_tpu_torch.engine import cuda_kernels as ck
        from matchmaking_tpu_torch.engine import kernels, scoring
        from matchmaking_tpu_torch.engine.gpu import GpuEngine
        from matchmaking_tpu_torch.engine.quality import QualitySpec
        from matchmaking_tpu_torch.native import codec
        from matchmaking_tpu_torch.service.app import run_demo
        from matchmaking_tpu_torch.service.contract import (
            RequestColumns,
            SearchRequest,
        )
    except ImportError as e:
        log(f"the matchmaking_tpu_torch package is not beside this file: {e}")
        return 3
    out_path = argv[argv.index("--out") + 1] if "--out" in argv else None
    out_dir = os.path.dirname(os.path.abspath(out_path)) if out_path else None
    baseline_tree = (argv[argv.index("--baseline-tree") + 1]
                     if "--baseline-tree" in argv else None)
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    # 1. build and identify: one nvcc per kernel source and g++ (the wire
    # codec), all started together
    t = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(ck.SOURCES) + 1) as pool:
        codec_build = pool.submit(codec.build)
        builds = {name: pool.submit(ck.compile_report, name)
                  for name in ck.SOURCES}
        built = {name: f.result() for name, f in builds.items()}
        codec_so = codec_build.result()
    build_s = time.perf_counter() - t
    so = built["block_best"][0]
    log(f"built the wire codec: {codec_so}")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    max_sm_clock = card_line("clocks.max.sm")
    resources = ptxas_report("".join(text for _, text in built.values()))
    log(f"built {', '.join(built)} in {build_s:.1f} s on {kind} ({card}, max "
        f"SM clock {max_sm_clock})")
    for inst, res in resources.items():
        log(f"ptxas {inst}: {res}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    sass = sass_inner_loop(so, out_dir)
    log(f"SASS, ELO scorer's inner loop: {sass}")
    baseline = load_baseline(baseline_tree) if baseline_tree else None
    # 2. kernels vs plain: block_best (dense, then the span launch) and
    #    quality_accum
    kernel, max_err = phase_kernel(torch, ck, scoring, device, baseline)
    sweep = (plan_sweep(torch, ck, scoring, device) if "--plan-sweep" in argv
             else None)
    span = phase_span(torch, np, ck, kernels, scoring, device,
                      sweep=sweep is not None)
    if sweep is not None:
        sweep["span_chunk16"] = span["chunk16"]["plans"]
    quality, q_err = phase_quality(torch, np, ck, kernels, QualitySpec(),
                                   device, baseline)

    # 3. the engine main path: columnar, pipelined, at full width
    phase_s = {"1-2": time.perf_counter() - t_start}
    t_phase = time.perf_counter()
    mods = (Config, GpuEngine, RequestColumns, SearchRequest)
    launches = {}
    main_run = run_columnar(torch, np, ck, scoring, mods, "configs/elo_1v1.json",
                            waiting=100_000, windows=48, glicko2=False,
                            filters=False, seed=1, cpu_windows=3,
                            object_windows=8, profile_windows=8)
    launches["columnar_elo_1v1"] = main_run["launches"]
    launches["object_elo_1v1"] = main_run["object"]["launches"]
    if main_run["profile"]["step_kernels_per_window"] > 402:
        raise AssertionError(f"the main path's window runs "
                             f"{main_run['profile']['step_kernels_per_window']}"
                             f" kernels, over 401 + the quality_accum launch")
    phase_s["3"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # 3b. the pruned main path: config #1 with BENCH_SWEEP.md §5's pruning
    pruned_run = run_columnar(torch, np, ck, scoring, mods,
                              "configs/elo_1v1.json", waiting=100_000,
                              windows=48, glicko2=False, filters=False, seed=1,
                              cpu_windows=3, object_windows=0,
                              profile_windows=8, engine_over=PRUNE)
    launches["columnar_elo_1v1_pruned"] = pruned_run["launches"]
    # 3c. the bucketed main path: config #1 with the JAX bench's bucketed
    #     geometry, a heartbeat (the index rebuild) mid-stream
    phase_s["3b"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    bucketed_run = run_columnar(torch, np, ck, scoring, mods,
                                "configs/elo_1v1.json", waiting=100_000,
                                windows=48, glicko2=False, filters=False,
                                seed=1, cpu_windows=3, object_windows=0,
                                profile_windows=8, engine_over=BUCKETED,
                                heartbeat_at=24)
    launches["columnar_elo_1v1_bucketed"] = bucketed_run["launches"]
    phase_s["3c"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    filters_run = run_columnar(torch, np, ck, scoring, mods,
                               "configs/multiqueue_filters.json",
                               waiting=50_000, windows=6, glicko2=False,
                               filters=True, seed=2, cpu_windows=1,
                               object_windows=0, profile_windows=0)
    launches["columnar_multiqueue_filters"] = filters_run["launches"]
    glicko_run = run_columnar(torch, np, ck, scoring, mods,
                              "configs/glicko2.json", waiting=100_000,
                              windows=24, glicko2=True, filters=False, seed=4,
                              cpu_windows=1, object_windows=0,
                              profile_windows=0)
    launches["columnar_glicko2"] = glicko_run["launches"]
    rescan = run_rescan(torch, np, ck, scoring, mods, "configs/glicko2.json",
                        waiting=50_000, seed=5)
    launches["rescan_tick_glicko2"] = rescan["tick_launches"]
    launches["rescan_arrivals_glicko2"] = rescan["arrival_launches"]
    phase_s["3 (#2, #4, rescan)"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # 3d. speculation: the dense rescan family (config #4) and the
    #     bucketed one (config #1 bucketed)
    speculation = {
        "glicko2": run_speculation(torch, np, ck, mods, "configs/glicko2.json",
                                   engine_over={}, waiting=50_000, windows=4,
                                   seed=14),
        "elo_1v1_bucketed": run_speculation(
            torch, np, ck, mods, "configs/elo_1v1.json", engine_over=BUCKETED,
            waiting=100_000, windows=4, seed=15)}
    for name, run in speculation.items():
        launches["speculation_" + name] = run["speculate_launches"]
    phase_s["3d"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # 3e. grouped readback: config #1 dense, bucketed (with the rescan
    #     tick) and sharded D = 2 at k = 2-4 bit-equal to k = 1; k = 1
    #     against k = 3 at depth 2; the copies by name (torch.profiler,
    #     so before phase 4) and the graph audit
    grouped = run_grouped_readback(torch, np, ck, mods, "configs/elo_1v1.json",
                                   waiting=100_000, windows=48, seed=1,
                                   profile_windows=8)
    phase_s["3e"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # 3f. the stage profilers at config #1's width: the stage split with
    #     its graphs audited, the candidate pass at B = 2,048 and 4,096,
    #     the stage modes and the engine's per-window split
    p3f = run_stage_profilers(torch, np, ck, mods)
    launches["stage_profilers"] = (p3f["launches"]["block_best"]
                                   - p3f["check_launches"])
    # The candidate pass's comparisons with its plain version: a path of
    # their own in launches_by_path, outside the main paths' sum.
    launches["stage_profilers_checks"] = p3f["check_launches"]
    phase_s["3f"] = time.perf_counter() - t_phase

    # 14. the sharded pool and the multi-host runtime: config #1 sharded
    #     D = 1, 2, 4, 8 ways (and the ring at 4) on the one card against
    #     the dense engine; the bucket frontier at D = 4; configs #3 and #5
    #     sharded 4 ways; a process group of one over NCCL and serve under
    #     MM_DCN_*. It runs here, before phase 4: after phases 4-13 in
    #     this process torch.profiler leaves out the same ~27 kernels of
    #     every session (the host launched them), and 14a counts kernels by
    #     name in profiled windows; no form of capture, idle time or live
    #     graphs alone does it (scripts/torch_profiler_records.py).
    p14 = phase_sharded(torch, np, ck, scoring, mods, phase_s)
    shard_run, frontier_run = p14["14a"], p14["14b"]
    shard_teams, process_run = p14["14c"], p14["14d"]
    t_phase = time.perf_counter()

    # 4. the service on the card: the demo, the full-width soak, and
    #    config #4's rescan loop
    answers = asyncio.run(run_demo(device="cuda"))
    by_id = {r.player_id: r for r in answers}
    for r in answers:
        if r.status != "matched":
            raise AssertionError(f"demo: {r.player_id} got {r.status}")
        partner = next(p for p in r.match.players if p != r.player_id)
        if by_id[partner].status != "matched":
            raise AssertionError(f"demo: partner {partner} not matched")
    log(f"service demo: {len(answers)} players answered, all matched")
    profile_soak = "--profile-soak" in argv and out_dir
    soak = asyncio.run(service_soak(
        np, ck, mods, "configs/elo_1v1.json", waiting=100_000,
        requests=16_384, burst=512, seed=6,
        profile_to=(os.path.join(out_dir, "soak_profile_on.txt")
                    if profile_soak else None)))
    launches["service_soak"] = soak["launches"]
    # The same soak on the per-delivery path (consume_batch off).
    soak_off = asyncio.run(service_soak(
        np, ck, mods, "configs/elo_1v1.json", waiting=100_000,
        requests=16_384, burst=512, seed=6, consume_batch=False,
        profile_to=(os.path.join(out_dir, "soak_profile_off.txt")
                    if profile_soak else None)))
    launches["service_soak_per_delivery"] = soak_off["launches"]
    service_rescan_run = asyncio.run(service_rescan(
        np, ck, mods, "configs/glicko2.json", waiting=20_000, seed=7))
    launches["service_rescan_glicko2"] = service_rescan_run["launches"]
    multiqueue = asyncio.run(service_multiqueue(
        np, ck, mods, "configs/multiqueue_filters.json", waiting=20_000,
        requests=2_048, burst=512, seed=12))
    launches["service_multiqueue_filters"] = multiqueue["launches"]
    spec_service = asyncio.run(service_spec(ck, mods, "configs/elo_1v1.json"))
    launches["service_speculation_bucketed"] = spec_service["launches"]
    phase_s["4"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 5. team and role queues at full width: configs #3 and #5 on the card
    #    (their steps score no 1v1 blocks: block_best must stay at 0), the
    #    role queue's hand-over to the host oracle, config #3's service
    ck.LAUNCHES["block_best"] = 0
    team_run = run_team(torch, np, mods, "configs/team_5v5.json",
                        waiting=50_000, windows=24, profile_windows=8,
                        cpu_windows=3, seed=8, roles=False)
    role_run = run_team(torch, np, mods, "configs/role_party.json",
                        waiting=12_000, windows=8, profile_windows=8,
                        cpu_windows=3, seed=9, roles=True)
    delegation = role_delegation(torch, np, mods, "configs/role_party.json",
                                 waiting=200, seed=10)
    role_health = asyncio.run(service_role_health(
        np, mods, "configs/role_party.json", waiting=200, seed=13))
    team_service = asyncio.run(service_team(
        np, mods, "configs/team_5v5.json", waiting=50_000, requests=8_192,
        burst=512, seed=11))
    launches["team_and_role_paths"] = ck.LAUNCHES["block_best"]
    phase_s["5"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 6. overload control at full width: config #1's service with the
    #    waiting cap, tiers, EDF and deadlines, then the same soak without
    overload = {on: asyncio.run(service_overload(
        np, ck, mods, "configs/elo_1v1.json", waiting=100_000,
        requests=16_384, burst=512, seed=16, overload_on=on))
        for on in (True, False)}
    launches["service_overload"] = overload[True]["launches"]
    phase_s["6"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 7. the circuit breaker at full width: two failed windows demote the
    #    queue to the host oracle, the second probe brings it back
    import shutil
    import tempfile

    # Phase 17d's inputs: phase 7's breaker_trip bundle and 16a's journal.
    work17 = tempfile.mkdtemp(prefix="mm17")
    bundle17 = os.path.join(work17, "breaker_bundle.json")
    journal17 = os.path.join(work17, "journal16a")
    breaker_run = asyncio.run(service_breaker(
        np, ck, mods, "configs/elo_1v1.json", waiting=100_000, seed=17,
        bundle_to=bundle17))
    launches["service_breaker_probe"] = (
        breaker_run["probe_launches"]["block_best"])
    launches["service_breaker_after_repromotion"] = (
        breaker_run["launches_after"])
    phase_s["7"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 8. durability at full width: the write-ahead journal's cost (on
    #    against off), a hard crash with windows in flight and the
    #    recovery on the card, the drain's round trip with its backlog,
    #    and auth rpc and static
    elo = "configs/elo_1v1.json"
    durability = asyncio.run(service_durability(
        np, torch, ck, mods, elo, waiting=100_000, requests=16_384,
        burst=512, seed=18))
    drain_run = asyncio.run(service_drain(
        np, torch, ck, mods, elo, waiting=100_000, backlog=512, seed=19))
    auth_run = asyncio.run(service_auth(
        np, ck, mods, elo, waiting=100_000, requests=1_024, seed=20))
    phase8 = {"service_journal_soak": durability["on"]["launches"],
              "service_recovered": durability["crash"]["launches"],
              "service_drain_restore": drain_run["launches"],
              "service_auth_rpc": auth_run["rpc"]["launches"],
              "service_auth_static": auth_run["static"]["launches"]}
    for name, counts in phase8.items():
        launches[name] = counts["block_best"]
    phase_s["8"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 9. tracing at full width: config #1's soak with tracing off, on and
    #    sampled (1 in 16), in turns in this process
    tracing = {mode: asyncio.run(service_trace_soak(
        np, ck, mods, elo, waiting=100_000, requests=16_384, burst=512,
        seed=21, mode=mode,
        profile_to=(os.path.join(out_dir, f"trace_profile_{mode}.txt")
                    if profile_soak else None)))
        for mode in ("off", "on", "sampled")}
    for mode, run in tracing.items():
        launches["service_trace_" + mode] = run["launches"]["block_best"]
    phase_s["9"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 10. telemetry, the SLO burn monitors, incident capture and the HTTP
    #     surfaces at full width: config #1's soak with the sampler off and
    #     no server, then with the defaults, metrics_port and an SLO
    #     target, in turns in this process; the routes' statuses against
    #     a CPU run's
    cpu_statuses = asyncio.run(cpu_route_statuses(np, Config, elo, seed=22))
    observed = {name: asyncio.run(service_observability(
        np, ck, mods, elo, waiting=100_000, requests=16_384, burst=512,
        seed=22, on=on, cpu_statuses=cpu_statuses))
        for name, on in (("off", False), ("on", True))}
    for name, run in observed.items():
        launches["service_observability_" + name] = (
            run["launches"]["block_best"])
    phase_s["10"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 11. resilience at full width: config #1's service under seeded
    #     broker chaos with the invariant checker (twice, then without),
    #     replication off and on in turns, a failover onto a successor on
    #     the card, and replication-link faults
    chaos_runs = asyncio.run(service_chaos(
        np, ck, mods, elo, waiting=100_000, requests=16_384, burst=512,
        seed=23))
    replication = asyncio.run(service_replication(
        np, torch, ck, mods, elo, waiting=100_000, requests=16_384,
        burst=512, seed=24))
    phase11 = {"service_" + name: run["launches"]
               for name, run in chaos_runs.items()}
    phase11.update({f"service_replication_{i}_"
                    f"{'on' if leg['replication'] else 'off'}": leg["launches"]
                    for i, leg in enumerate(replication["legs"])})
    phase11["service_failover_successor"] = (
        replication["failover"]["launches"])
    phase11["service_replication_link_faults"] = (
        replication["link_faults"]["launches"])
    for name, counts in phase11.items():
        launches[name] = counts["block_best"]
    phase_s["11"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 12. the socket transport at full width: config #1's service
    #     replicating to a standby in a child process over UDS, its lease
    #     at a lease child; faults on the wire and a host loss onto the
    #     child; the cross-process failover soak with its hosts on the card
    network = asyncio.run(service_network(
        np, torch, ck, mods, elo, waiting=100_000, requests=16_384,
        burst=512, seed=25, soak_runs=NET_SOAK_RUNS))
    ons11 = [leg for leg in replication["legs"] if leg["replication"]]
    ons12 = [leg for leg in network["legs"] if leg["replication"]]
    log("12a against 11b (on legs, requests/s; p50 / p99 ms): socket "
        + ", ".join(f"{o['requests_per_s']:.0f}; {o['latency_ms_p50']:.1f} / "
                    f"{o['latency_ms_p99']:.1f}" for o in ons12)
        + " · in-process " + ", ".join(
            f"{o['requests_per_s']:.0f}; {o['latency_ms_p50']:.1f} / "
            f"{o['latency_ms_p99']:.1f}" for o in ons11))
    phase12 = {f"service_network_{i}_"
               f"{'on' if leg['replication'] else 'off'}": leg["launches"]
               for i, leg in enumerate(network["legs"])}
    phase12["service_network_faults"] = network["faults"]["launches"]
    phase12["service_network_before_host_loss"] = (
        network["failover"]["launches_before_crash"])
    phase12["child_successor"] = network["failover"]["launches"]
    phase12["child_soak_hosts"] = network["soak"]["launches"]
    for name, counts in phase12.items():
        launches[name] = counts["block_best"]
    phase_s["12"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 13. transports, processes and load: config #1 served over AMQP by
    #     serve (the port's fake_pika the server), against the in-process
    #     broker, a consumer connection killed mid-stream, chaos over the
    #     wire, the drain handed to a successor serve; the supervisor's
    #     fleet over config #2 (worker 0 on the card, worker 1 the host
    #     oracle) and its loadgen worker on the card; the flash-crowd
    #     scenario with the autotuner off and on
    import tempfile

    transports = asyncio.run(service_transports(
        np, ck, mods, elo, waiting=100_000, requests=AMQP_REQUESTS,
        burst=AMQP_BURST, seed=26))
    phase_s["13a"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    work13 = tempfile.mkdtemp(prefix="mm13")
    processes = service_processes(mods, "configs/multiqueue_filters.json",
                                  elo, work13)
    phase_s["13b"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    tuning = asyncio.run(service_autotune(np, ck, mods, elo, waiting=100_000,
                                          seed=27))
    phase_s["13c"] = time.perf_counter() - t_phase
    phase13 = {"service_amqp_inproc": transports["inproc"]["launches"],
               "service_amqp": transports["amqp"]["launches"],
               "service_amqp_consumer_killed": transports["kill"]["launches"],
               "child_loadgen_worker": processes["loadgen_launches"]}
    for i, run in enumerate(tuning["runs"]):
        phase13[f"service_flash_crowd_{i}_"
                f"{'tuned' if run['tuned'] else 'static'}"] = run["launches"]
    for name, counts in phase13.items():
        launches[name] = counts["block_best"]

    # 15. placement and device-loss failover: config #1 sharded two ways
    #     on the inventory ("cuda:0",) × 2 loses a device mid-soak and
    #     demotes to one (15a); the scripted placement cycle through the
    #     controller at config #1's width (15b); config #2's two queues
    #     bound to one device with the dispatch arbiter on and off (15c)
    p15 = phase_placement(np, torch, ck, mods, phase_s)
    phase15 = {"failover": p15["15a"]["launches"],
               "placement_cycle": p15["15b"]["launches"],
               "arbiter": {k: sum(leg["launches"][k] for leg in p15["15c"])
                           for k in ("block_best", "quality_accum")}}
    for name, counts in phase15.items():
        launches[name] = counts["block_best"]

    # 16. the port's tools on the card: config #1's journaled, replicated
    #     soak under the port's sanitizer and without (16a), the
    #     speculating bucketed service under it (16b), the port's matchlint
    #     and model checker on this machine's Python (16c)
    p16 = phase_sanitized(np, ck, mods, phase_s, keep_journal=journal17)
    on16, off16 = p16["16a"]["legs"]
    phase16 = {"sanitized": on16["launches"],
               "sanitized_off": off16["launches"],
               "sanitized_spec": {
                   "block_best": p16["16b"]["launches"],
                   "quality_accum": p16["16b"]["quality_launches"]}}
    for name, counts in phase16.items():
        launches[name] = counts["block_best"]

    # 17. the trace gate and the graphs on the card: the trace-time rules
    #     with the traces made on the card (17a), every captured graph of
    #     configs #1 (dense, pruned, bucketed with speculation), #3 and #5
    #     read back and audited (17b), entry() replayed and the dry run at
    #     n = 1-8 on one card (17c), the operator tools on this run's
    #     journal and bundle (17d)
    p17 = phase_graphs(
        torch, ck, mods, phase_s,
        profiled_kernels=main_run["profile"]["step_kernels_per_window"],
        journal_dir=journal17, bundle_path=bundle17)
    shutil.rmtree(work17, ignore_errors=True)
    phase17 = {"trace_gate_cuda": p17["17a"]["launches"],
               "graph_audit_warm_runs": p17["17b"]["launches"],
               "entry_and_dryrun": p17["17c"]["launches"]}
    for name, counts in phase17.items():
        launches[name] = counts["block_best"]

    # 18. grouped readback in the service: config #1's soak at k = 1 and 3
    #     (wait 2 and 8 ms) in turns with the invariant checker (18a), the
    #     JAX soak's chaos traffic at k = 3 (18b)
    p18 = phase_grouped_service(np, ck, mods, phase_s)
    phase18 = {"grouped_readback": grouped["launches"],
               "grouped_chaos_soak": p18["18b"]["launches"]}
    for i, leg in enumerate(p18["18a"]):
        phase18[f"service_grouped_{i}_k{leg['readback_group']}"] = (
            leg["launches"])
    for name, counts in phase18.items():
        launches[name] = counts["block_best"]

    phase14 = {k: v for k, v in shard_run["launches"].items()
               if not k.startswith("stand_in_")}
    phase14["bucket_frontier"] = frontier_run["launches"]
    phase14.update(process_run["launches"])
    phase14["serve_dcn"] = process_run["serve"]["launches"]
    launches.update(phase14)
    # Listed by path, left out of the main path's total (and of phase14).
    launches.update({k: v for k, v in shard_run["launches"].items()
                     if k.startswith("stand_in_")})
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in phase_s.items()))
    if launches["team_and_role_paths"]:
        raise AssertionError("block_best ran on a team/role path")
    team_launches = team_run["step"]["launches"]
    role_launches = role_run["step"]["launches"]
    if team_launches > 300 or role_launches > team_launches + 60:
        raise AssertionError(f"step launch budget: team {team_launches} "
                             f"(<= 300), role {role_launches} (<= team + 60)")
    torch.cuda.synchronize()

    main_k = kernel["elo"]
    # The main paths: config #1's columnar windows, dense and pruned, and
    # the rescan tick's own chunks (each path's count is in
    # launches_by_path; quality_accum runs once behind each of those steps).
    main_launches = (launches["columnar_elo_1v1"]
                     + launches["columnar_elo_1v1_pruned"]
                     + launches["columnar_elo_1v1_bucketed"]
                     + launches["rescan_tick_glicko2"]
                     + sum(r["speculate_launches"]
                           for r in speculation.values())
                     + sum(c["block_best"] for c in phase8.values())
                     + sum(r["launches"]["block_best"]
                           for r in tracing.values())
                     + sum(r["launches"]["block_best"]
                           for r in observed.values())
                     + sum(c["block_best"] for c in phase11.values())
                     + sum(c["block_best"] for c in phase12.values())
                     + sum(c["block_best"] for c in phase13.values())
                     + sum(phase14.values())
                     + sum(c["block_best"] for c in phase15.values())
                     + sum(c["block_best"] for c in phase16.values())
                     + sum(c["block_best"] for c in phase17.values())
                     + sum(c["block_best"] for c in phase18.values())
                     + launches["stage_profilers"])
    q_launches = (main_run["quality_launches"]
                  + pruned_run["quality_launches"]
                  + bucketed_run["quality_launches"]
                  + rescan["tick_launches"]
                  + sum(r["commit_launches"] for r in speculation.values())
                  + sum(c["quality_accum"] for c in phase8.values())
                  + sum(r["launches"]["quality_accum"]
                        for r in tracing.values())
                  + sum(r["launches"]["quality_accum"]
                        for r in observed.values())
                  + sum(c["quality_accum"] for c in phase11.values())
                  + sum(c["quality_accum"] for c in phase12.values())
                  + sum(c["quality_accum"] for c in phase13.values())
                  + sum(c["quality_accum"] for c in phase15.values())
                  + sum(c["quality_accum"] for c in phase16.values())
                  + sum(c["quality_accum"] for c in phase17.values())
                  + sum(c["quality_accum"] for c in phase18.values())
                  + p3f["launches"]["quality_accum"])
    line = {"kernels": [{
        "name": "block_best",
        "route": "cuda",
        "source": "matchmaking_tpu_torch/csrc/block_best.cu",
        "replaces": "matchmaking_tpu/engine/pallas_kernels.py:153",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": main_k["ms"],
        "plain_ms": main_k["plain_ms"],
        "bound_ms": main_k["bound_ms"],
        "bound_by": main_k["bound_by"],
        "library_ms": None,
        "launches_by_path": launches,
        "ms_by_bucket": main_k["ms_by_bucket"],
        "host_us": main_k["host_us_by_bucket"][FULL_B],
        "span_launch": span,
        "sharded": {
            "block_best_ms_a_launch": {
                label: run["block_best_ms_a_launch"]
                for label, run in shard_run["runs"].items()},
            "max_abs_err": max(run["max_abs_err"]
                               for run in shard_run["runs"].values()),
            "frontier_launch": frontier_run["frontier_launch"]},
    }, {
        "name": "quality_accum",
        "route": "cuda",
        "source": "matchmaking_tpu_torch/csrc/quality_accum.cu",
        "replaces": "matchmaking_tpu/engine/kernels.py:1239",
        "launches": q_launches,
        "max_abs_err": q_err,
        "ms": quality["ms"],
        "plain_ms": quality["plain_ms"],
        "bound_ms": quality["bound_ms"],
        "bound_by": quality["bound_by"],
        "library_ms": None,
        "launches_by_path": {
            "columnar_elo_1v1": main_run["quality_launches"],
            "columnar_elo_1v1_pruned": pruned_run["quality_launches"],
            "columnar_elo_1v1_bucketed": bucketed_run["quality_launches"],
            "rescan_tick_glicko2": rescan["tick_launches"],
            **{"spec_commit_" + name: run["commit_launches"]
               for name, run in speculation.items()},
            "service_speculation_bucketed": spec_service["quality_launches"],
            "service_soak": soak["launches"],
            "service_multiqueue_filters": multiqueue["launches"],
            "service_overload": overload[True]["launches"],
            "service_breaker_probe":
                breaker_run["probe_launches"]["quality_accum"],
            "service_breaker_after_repromotion":
                breaker_run["launches_after"],
            **{name: c["quality_accum"] for name, c in phase8.items()},
            **{"service_trace_" + mode: run["launches"]["quality_accum"]
               for mode, run in tracing.items()},
            **{"service_observability_" + name: run["launches"]["quality_accum"]
               for name, run in observed.items()},
            **{name: c["quality_accum"] for name, c in phase11.items()},
            **{name: c["quality_accum"] for name, c in phase12.items()},
            **{name: c["quality_accum"] for name, c in phase13.items()},
            **{name: c["quality_accum"] for name, c in phase15.items()},
            **{name: c["quality_accum"] for name, c in phase16.items()},
            **{name: c["quality_accum"] for name, c in phase17.items()
               if name != "entry_and_dryrun"},
            **{name: c["quality_accum"] for name, c in phase18.items()},
            "stage_profilers": p3f["launches"]["quality_accum"]},
        "ms_by_bucket": quality["ms_by_bucket"],
        "host_us": quality["host_us"],
        "host_us_by_bucket": quality["host_us_by_bucket"],
        "empty_ms_by_bucket": quality["empty_ms_by_bucket"],
        "empty_host_us_by_bucket": quality["empty_host_us_by_bucket"],
        "ms_32_edges": quality["ms_32_edges"],
        **{k: quality[k] for k in ("baseline_ms_by_bucket",
                                   "baseline_host_us_by_bucket")
           if k in quality},
    }]}
    for k in line["kernels"]:
        for path, n in k["launches_by_path"].items():
            if n == 0 and path != "team_and_role_paths":
                raise AssertionError(f"{k['name']} never ran on {path}")
    columnar = {}
    for name, run in (("elo_1v1", main_run), ("elo_1v1_pruned", pruned_run),
                      ("elo_1v1_bucketed", bucketed_run),
                      ("multiqueue_filters", filters_run),
                      ("glicko2", glicko_run)):
        columnar[name] = {k: run[k] for k in (
            "dispatch_ms_p50", "dispatch_ms_p99", "turnaround_ms_p50",
            "turnaround_ms_p99", "requests_per_s", "idle_fraction",
            "gc_ms_total", "gc_ms_max", "matches", "launches",
            "quality_samples", "prune", "formation", "eager_windows_equal")}
        columnar[name]["graphs"] = {k: v for k, v in run["graphs"].items()
                                    if k != "by_graph"}
        if run["profile"]:
            columnar[name]["kernels_per_window"] = (
                run["profile"]["step_kernels_per_window"])
            columnar[name]["queued_per_window"] = (
                run["profile"]["queued_per_window"])
            columnar[name]["own_kernels"] = run["profile"]["own_kernels"]
            own_ms = run["profile"]["own_kernel_ms_per_window"]
            columnar[name]["block_best_device_ms_per_window"] = (
                own_ms["prep_kernel"] + own_ms["block_best_kernel"])
            columnar[name]["quality_accum_device_ms_per_window"] = (
                own_ms["quality_accum_kernel"])
    summary = {
        "card": card, "columnar": columnar,
        "split_ms_per_window": main_run["split_ms_per_window"],
        "device_busy_share": main_run["profile"]["device_busy_share"],
        "kernels_per_window": main_run["profile"]["kernels_per_window"],
        "greedy_pair_kernels_per_call":
            main_run["profile"]["greedy_pair_kernels_per_call"],
        "object_step_ms_p50": main_run["object"]["step_ms_p50"],
        "object_step_ms_max": main_run["object"]["step_ms_max"],
        "object_gc_ms_max": max(main_run["object"]["gc_ms"]),
        "rescan": {k: v for k, v in rescan.items() if k != "tick_profile"}
        | {"tick_" + k + "_per_chunk": rescan["tick_profile"][k + "_per_window"]
           for k in ("queued", "graph_launches", "kernels", "device_ms")}
        | {"tick_own_kernels": rescan["tick_profile"]["own_kernels"]},
        "service_rescan": service_rescan_run,
        "speculation": speculation,
        "service_speculation": spec_service,
        "phase_s": phase_s,
        "soak": {k: soak[k] for k in ("latency_ms_p50", "latency_ms_p99",
                                      "latency_ms_max", "requests_per_s",
                                      "windows", "publish_batches",
                                      "players_matched", "quality_samples",
                                      "decode_calls")},
        "soak_per_delivery": {k: soak_off[k] for k in (
            "latency_ms_p50", "latency_ms_p99", "latency_ms_max",
            "requests_per_s", "windows", "players_matched", "decode_calls")},
        "team": {name: {k: run[k] for k in (
            "dispatch_ms_p50", "dispatch_ms_p99", "turnaround_ms_p50",
            "turnaround_ms_p99", "requests_per_s", "matches",
            "matches_per_window", "finalize_ms_per_window",
            "team_delegated", "rescan", "quality_samples")}
            | {"kernels_per_window": run["profile"]["kernels_per_window"],
               "queued_per_window": run["profile"]["queued_per_window"],
               "device_ms_per_window": run["profile"]["device_ms_per_window"],
               "device_busy_share": run["profile"]["device_busy_share"],
               "graphs": {k: v for k, v in run["graphs"].items()
                          if k != "by_graph"},
               "step_queue_ms_per_window": run["step_queue_ms_per_window"]}
            for name, run in (("team_5v5", team_run),
                              ("role_party", role_run))},
        "role_delegation": delegation,
        "role_health": role_health,
        "multiqueue_service": {k: multiqueue[k] for k in (
            "windows", "requests_per_s", "players_matched", "probes")},
        "team_service": {k: team_service[k] for k in (
            "latency_ms_p50", "latency_ms_p99", "latency_ms_max",
            "requests_per_s", "windows", "publish_batches",
            "players_matched")},
        "overload": {("on" if on else "off"): {k: run[k] for k in (
            "requests_per_s", "latency_ms_p50", "latency_ms_p99",
            "latency_ms_by_tier", "final_status_by_tier", "shed_by_tier",
            "expired_by_tier", "pool_max_after_window", "backlog_at_cut",
            "admission_cut_us_per_window", "debt_windows",
            "debt_ms_per_window", "debt_pick_ms_per_window", "windows")}
            for on, run in overload.items()},
        "breaker": {k: v for k, v in breaker_run.items()
                    if k != "quality_counts"},
        "durability": durability,
        "drain": drain_run,
        "auth": auth_run,
        "tracing": {mode: {k: v for k, v in run.items()
                           if k not in ("launches", "stage_counts")}
                    for mode, run in tracing.items()},
        "observability": {name: {k: v for k, v in run.items()
                                 if k not in ("launches", "route_statuses")}
                          for name, run in observed.items()},
        "chaos": {name: {k: v for k, v in run.items() if k != "launches"}
                  for name, run in chaos_runs.items()},
        "replication": {
            "legs": [{k: v for k, v in leg.items() if k != "launches"}
                     for leg in replication["legs"]],
            "failover": {k: v for k, v in replication["failover"].items()
                         if k not in ("launches", "device_kernels")},
            "link_faults": {k: v for k, v in
                            replication["link_faults"].items()
                            if k != "launches"}},
        "network": {
            "legs": [{k: v for k, v in leg.items() if k != "launches"}
                     for leg in network["legs"]],
            "faults": {k: v for k, v in network["faults"].items()
                       if k != "launches"},
            "failover": {k: v for k, v in network["failover"].items()
                         if not k.startswith("launches")},
            "soak": {k: v for k, v in network["soak"].items()
                     if k not in ("launches", "socket_failover_epochs")}},
        "transports": {
            "amqp": {k: transports[k] for k in ("inproc", "amqp", "kill",
                                                "drain", "chaos_stats")},
            "processes": {k: v for k, v in processes.items()
                          if k != "loadgen_launches"},
            "flash_crowd": [{k: v for k, v in run.items()
                             if k not in ("launches", "digest")}
                            for run in tuning["runs"]]},
        "sharded": {
            "dense": shard_run["dense"],
            "runs": {label: {k: v for k, v in run.items()
                             if k not in ("top_kernels", "graphs")}
                     for label, run in shard_run["runs"].items()},
            "bucket_frontier": {k: v for k, v in frontier_run.items()
                                if k not in ("frontier_launch",
                                             "formation")},
            "teams": {name: {case: run[case] for case in ("fallback", "ring")}
                      for name, run in shard_teams.items()},
            "process_mesh": process_run},
        "placement": {
            "failover": {k: v for k, v in p15["15a"].items()
                         if k != "launches"},
            "cycle": {k: v for k, v in p15["15b"].items()
                      if k != "launches"},
            "arbiter": [{k: v for k, v in leg.items() if k != "launches"}
                        for leg in p15["15c"]]},
        "sanitized": {
            "soak": [{k: v for k, v in leg.items()
                      if k not in ("launches", "segment", "replication")}
                     for leg in (on16, off16)],
            "spec_commits_seen": p16["16b"]["spec_commits_seen"],
            "lint_and_modelcheck": p16["16c"]},
        "graphs": {
            "trace_gate": {k: p17["17a"][k] for k in ("families", "card_s",
                                                      "cpu_s")},
            "audited_graphs": len(p17["17b"]["graphs"]),
            "dense_kernel_nodes": p17["17b"]["dense_kernel_nodes"],
            "profiled_kernels_per_window":
                p17["17b"]["profiled_kernels_per_window"],
            "entry_paired": p17["17c"]["paired"],
            "dryrun": p17["17c"]["dryrun"],
            "tools": p17["17d"]},
        "grouped_readback": {
            "equal": grouped["equal"], "timed": grouped["timed"],
            "copies_per_window": {k: c["per_window"]
                                  for k, c in grouped["copies"].items()},
            "graph_audit": grouped["graph_audit"][3],
            "service": [{k: v for k, v in leg.items() if k != "launches"}
                        for leg in p18["18a"]],
            "chaos_soak": {k: v for k, v in p18["18b"].items()
                           if k not in ("launches", "chaos")}},
    }
    steps_line = {"steps": [
        dict(name=name, config=run["config"], replaces=src,
             **{k: run["step"][k] for k in ("launches", "device_ms", "ms",
                                            "host_ms", "pool", "batch",
                                            "bound_ms", "bound_by")})
        for name, run, src in (
            ("team_step", team_run, "matchmaking_tpu/engine/teams.py:317"),
            ("role_step", role_run,
             "matchmaking_tpu/engine/role_kernels.py:224"))]}
    stage_split = {"stages": stages_line(p3f)}
    # quality_accum's parameter blocks this process bound (one per engine
    # state and pool it folded quality for; the oldest goes past the cap).
    log(f"quality_accum bindings made in this process: {len(ck._BINDINGS)} "
        f"(at most {ck._MAX_BINDINGS} kept)")
    total_s = time.perf_counter() - t_start
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"card": card, "kind": kind, "build_s": build_s,
                       "max_sm_clock": max_sm_clock, "ptxas": resources,
                       "sass_elo_inner_loop": sass, "plan_sweep": sweep,
                       "kernel": kernel, "max_abs_err": max_err,
                       "span": span, "quality": quality,
                       "columnar": [main_run, pruned_run, bucketed_run,
                                    filters_run, glicko_run],
                       "speculation": speculation,
                       "service_speculation": spec_service,
                       "rescan": rescan, "demo_players": len(answers),
                       "soak": soak, "soak_per_delivery": soak_off,
                       "service_rescan": service_rescan_run,
                       "team": [team_run, role_run],
                       "role_delegation": delegation,
                       "role_health": role_health,
                       "multiqueue_service": multiqueue,
                       "team_service": team_service,
                       "overload": overload, "breaker": breaker_run,
                       "durability": durability, "drain": drain_run,
                       "auth": auth_run, "tracing": tracing,
                       "observability": observed,
                       "cpu_route_statuses": cpu_statuses,
                       "chaos": chaos_runs, "replication": replication,
                       "network": network,
                       "transports": transports, "processes": processes,
                       "autotune": tuning,
                       "sharded": shard_run, "bucket_frontier": frontier_run,
                       "sharded_teams": shard_teams,
                       "process_mesh": process_run,
                       "placement": p15, "sanitized": p16, "graphs": p17,
                       "grouped_readback": grouped, "grouped_service": p18,
                       "stage_profilers": p3f,
                       "total_s": total_s, "summary": summary,
                       "steps_line": steps_line,
                       "kernels_line": line}, f, indent=1)
    print(f"total {total_s:.1f} s")
    print(json.dumps(summary))
    print(f"max SM clock: {max_sm_clock}")
    print(json.dumps(steps_line))
    print(json.dumps(stage_split))
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

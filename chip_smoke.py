"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--seed N] [--levels L]

1. Builds the four hand-written kernel libraries from
   mastic_tpu_torch/csrc/ (one nvcc per source, in parallel, into
   build/kernels/<hash>/) and
   prints nvcc's time, the libraries and ptxas's register/spill lines.
2. Holds each kernel bit-exact against its plain PyTorch version on the
   card at the main path's shapes, and times both: K1 (Keccak) as the
   eval proof's gathered binder sponge over two aggregators' distinct
   level-255 carries (both checks of both aggregators in one launch,
   payloads holding values >= p; also at depth 64 behind a 35-byte
   prefix); its in-place sponge (row keccak_turboshake) at the shapes
   the paths launch, timed: the shard's node proof at level 255 (2 x R
   messages), the key schedule's (R, domain 2), SumVec's joint-rand
   part (the longest message, 99 rate blocks) and helper proof share
   (the longest squeeze, 3056 B), R x (32 + 4096) B, and at its edges
   (lengths at the block ends behind a 13-byte prefix, a 170-byte
   prefix, a view at an odd byte offset, two squeezes, outputs of 1,
   33 and 170 bytes, batches of 1, 33, 37 and 4097); its bare
   permutation at 1, 4097 and 1 048 576 states, 12 and 24 rounds
   (under the row's "permutation", with its launches counted apart as
   "keccak_permute" on every path); K2 (bitsliced AES) as the main
   path's
   `fixed_key_blocks` at the client sharding's extend and convert
   shapes, at R = 4093 with 3 blocks and at 64 seeds a report, and as
   the planes entry at the sharding's plane stack; K3 (the level
   step) at R = 4096 reports x 32 parents (the main path's widest
   level), x 64 parents, and x 32 parents with a 150-byte ctx (a node
   proof over two rate blocks).
   The same kernels at the new slices' shapes, each row under its own
   name: K3 at MasticSum(256, 255)'s widest level (Field64, VALUE_LEN
   17, 10 convert blocks), MasticHistogram(64, 16, 4)'s (Field128,
   VALUE_LEN 17, 18 blocks), both at R x 32 parents, and at depth 0
   with 1026 blocks (SumVec(1024)'s beta share); K1's binder sponge on
   MasticSum(256, 255)'s 17-element Field64 rows at depth 64 (timed
   alone at depth 256, where the plain version does not fit the card)
   and on two Field128 carries at the Histogram path's last level
   (values >= p planted in both); K2 at 10, 18 and 1026 blocks.  The
   field kernel (csrc/field.cu): mul, add and sub at the Field128
   weight check's shapes and a Field64 one (FIELD_ROWS), each against
   the plain limb code on the card with values >= p planted.
   And at the from-root shapes: K3 at the attribute round's 10 000
   reports (not a multiple of 32) x 64 parents; K1's binder sponge on
   that round's flat tree (one aggregator, the schedule's index lists,
   2.3 G limbs), checked at its full size, and on the SumVec round's
   Field128 tree (1025-element rows, 8.5 G limbs), timed there and
   checked on the same tree with the index lists cut to a few rows at
   both ends of the node axis.
   K3's in-range predicate (`ok`, row level_step_ok_predicate): at the
   attribute row's shape, fresh parent seeds drawn until a launch
   returns ok False (about 200 launches expected, at most 3000), and
   that launch held bit-exact against `level_step_plain`, ok included.
   And at phase n's shapes: K3 at MasticMultihotCountVec(64, 16, 4,
   4)'s from-root level (Field128, VALUE_LEN 20, 21 convert blocks, R x
   16 parents) and at the 100 000-report Histogram cell's chunk x 16
   parents; K1's binder sponge on each of those rounds' flat Field128
   trees (level 63 over 16 attributes), timed at the path's report count
   and checked against the plain version (the multihot tree on its first
   BINDER_CHECK_R reports, the Histogram chunk's on every report with
   the index lists cut at both ends); K2 at 21 blocks.
   And at phase q's shapes (the node axis): K3 at the attribute round's
   node block (10 000 reports x 32 parents, node rank 0's half of the
   64 prefixes) and at the Count run's (8192 reports x 32 parents, the
   binder of level 127); K1's binder sponge on the tree a rank holds
   after the exchange (5000 reports x the round's 3332 nodes), timed
   there and checked on every report with the index lists cut at both
   ends of the node axis.
3. Drives seventeen phases, each with every launch counter set to 0 just
   before and read just after; each must have launched every kernel it
   runs (K1's binder sponge and K3 count Field128 launches apart).
   Every path hands its runs the scalar reports behind its batch
   (`ScalarReports`: lane r's scalar shard, built only if the lane's XOF
   sampling fires and the splice reads it):
   a. Count: MasticCount(256) over Field64 with R = 4096 reports (32
      planted 256-bit strings x 64 reports each plus 2048 uniform
      ones, weights 0/1, all from --seed), sharded on the card, then
      the whole 256-level heavy-hitters collection at threshold 48.
      The aggregates of every level must equal a numpy plaintext count
      over the reports that were not rejected, and the heavy hitters
      must be the planted strings.  `--levels L` stops after L levels
      (a cut of depth, printed on its own line).
   a'. Count from the root: the Count path's last level again as one
      `run_round` (the whole grid for both aggregators) over the reports
      the incremental runner kept: its aggregates must equal the
      incremental runner's.
   b. Sum (weighted heavy hitters): MasticSum(256, 255), the same
      strings with weights uniform in [0, 255], through
      `HeavyHittersRun` (the loop of `compute_heavy_hitters`) through 128
      levels (all 256 until phase q needed the time: printed as a
      cut), threshold 48 x 128;
      every level's weighted counts and survivors must equal numpy's.
   c. Histogram (Field128): MasticHistogram(64, 16, 4), R = 4096 reports
      over 16 planted attribute strings, buckets uniform; all 64 levels
      of the resident runner with the attributes' ancestors as the
      frontier and the weight check (joint rand confirmed) at level 0;
      every level's 16-bucket aggregates must equal numpy's.
   d. SumVec (long payload): MasticSumVec(128, 1024, 1, 32), R = 4096
      (four in five reports on 4 hashed attributes), sharded (K3 at
      1026 blocks for the joint-rand parts), then both aggregators'
      weight check from their depth-0 payloads: every honest report must
      be accepted.  Then the batch moves to a pinned `HostReportStore`
      and `aggregate_by_attribute(chunk_size=512, store=...)` runs the
      round from the root over the first SUMVEC_ROOT_R reports in
      chunks of 512 (the flat tree is about 33 MB a report; cut from
      all 4096 for time, printed): every attribute's 1024-entry vector
      must equal numpy's.  No incremental rounds: its carry does
      not fit a 128-level tree.
   e. Attributes: MasticSum(32, 255) over 10 000 reports and 64
      attributes of interest (BASELINE.json's attribute-metrics
      configuration), 100 reports with a flipped correction-word byte
      and 100 with a changed leader proof limb; the one round of
      `AttributeMetricsRun` (what `aggregate_by_attribute` steps): the
      accept mask must reject exactly the tampered reports, RoundMetrics
      attribute them to the eval proof and the weight check, and every
      attribute's aggregate must equal numpy's weight sum over every
      report but the tampered ones.
   f. A forced splice from the root: the attributes round again, over
      SPLICE_ASKED of its attributes (the honest lane's among them; cut
      for time, printed), with the `ok` of an honest report and of a
      report with a tampered proof share cleared after the prep
      (`BatchedMastic.prep_both` wrapped); both lanes' scalar reports
      must marshal to the batch's rows, an unforced round over the same
      attributes must give the full round's aggregates for them, and
      the splice must give the unforced result, the honest lane
      accepted and the tampered one rejected at the weight check.
   g. A forced splice and a checkpoint on the resident runner:
      MasticCount(16) over the Count path's report layout (depth cut
      from 256: at depth 256 each later level reruns a 44 s scalar
      round), lanes forced at levels 8 and 15 (0 and 9 until phase p
      needed the time: printed as a cut), checkpointed after level
      8, restored into a fresh run on the card and finished; every
      level must equal the unforced run's and numpy's.
   i. A chunked checkpoint: phase g's reports through
      `HeavyHittersRun(chunk_size=1024)` (four chunks, pipelined),
      checkpointed after level 8, restored on the card and finished;
      every level must equal phase g's unforced resident run.
   h. Count chunked: MasticCount(256) over 32 768 reports (the Count
      recipe x8: 32 planted strings x 512 reports and 16 384 uniform
      ones, threshold 48 x 8), sharded on the card in batches of 4096,
      moved into a pinned `HostReportStore` and run through
      `HeavyHittersRun(chunk_size=4096)` (8 chunks, pipelined) for the
      first 8 levels (`CHUNKED_LEVELS`); R drops to 16 384 when the
      host's available memory cannot hold the carries and the store.
      Every level must equal numpy's count, and the device peak must be
      at most 1.1x `memory_envelope`'s pipelined per-chunk peak.  The
      cuts (R, levels) are printed, and per level the wall time, the
      card's upload, compute and download times and the overlap.
   n. After phase h: n1, MasticMultihotCountVec(64, 16, 4, 4) over R
      reports (four in five on 16 hashed 64-bit attribute strings, 0-4
      of 16 entries hot), 100 with a changed leader proof limb: both
      aggregators' weight check from their depth-0 payloads (the FLP
      verdicts exactly the untampered reports, every joint rand
      confirmed), then `aggregate_by_attribute` from the root at level
      63 over the 16 attributes: every attribute's 16-entry count equal
      to numpy's, exactly the tampered reports rejected, at the weight
      check.  n2, BASELINE.json's "Histogram(len=16), BITS=64, 100k
      clients": MasticHistogram(64, 16, 4) over 100 000 reports (each
      one of 16 hashed attributes, buckets uniform), sharded in batches
      of 4096 into a pinned `HostReportStore`, then the weight-checked
      round from the root at level 63 in chunks priced by
      `memory_envelope` at the tree's padded width 32 (two chunks in
      flight): every attribute's 16 buckets equal to numpy's, every
      report accepted (32 768 reports past HIST100K_CUT_AFTER_S, printed
      as a cut).
   m. The north-star tool (`python -m mastic_tpu_torch.tools.northstar`,
      its `collect` in this process), after phase n: 32 768
      MasticCount(32) reports (the tool's recipe: three planted paths,
      threshold 0.1 R) chunked in chunks of 4096 from a pinned store,
      `--resident`, and `--mesh 1` over NCCL (one spawned rank, which
      shards its rows and counts its launches); each line must say ok,
      its heavy hitters equal the planted paths and the oracle's
      (`oracle.weighted_heavy_hitters`), and each run must launch K1,
      K2 and K3.  16 bits past NORTHSTAR_CUT_AFTER_S (printed as a cut).
   j. The mesh (`parallel.launch.spawn`, one process a rank,
      each run's counters set to 0 in the rank): over NCCL, 1 rank on
      the card, the Count path's reports through `HeavyHittersRun(mesh=)`
      for 16 levels, each equal to phase a's; over gloo, 2 ranks sharing
      the card (each with `MASTIC_DEVICE_BUDGET_BYTES` at 40% of it):
      MasticCount(256) over 8192 reports (the Count recipe x2, threshold
      96; each rank shards its 4096 rows, then the batch is gathered),
      4096 rows a rank, resident through 128 levels (256 until phase q
      needed the time, printed as a cut; 64 when the smoke has run
      past MESH_CUT_AFTER_S before phase j, printed as a cut), then
      `sharded_gen` against the rank's rows of the shard and
      `sharded_round` at level 0 against numpy; the same
      reports chunked (chunk_size 2047: every chunk pads to 2048, 1024
      rows a rank, the tail holds 4 live reports), pipelined, 8 levels
      (16 until phase p needed the time: printed as a cut), the
      frontier equal to the resident run's and each rank's device
      peak at most 1.1x the envelope's pipelined per-shard peak; and
      phase e's attribute round over both ranks (each sharding its
      5000 reports), held as e is.  Every
      level against numpy; every kernel launched by every rank.
   k. The party layer, after j: leader and helper as processes of
      their own on the card, exchanging only the draft's wire bytes.
      The clients' upload blobs are built from a sharded batch
      (`wire_rows`; a lane whose shard fired is not uploaded), and on
      a few lanes, tampered ones included, each blob must equal
      `wire.encode_report` of the lane's scalar report.
      k1: phase e's cell through `AggregationSession` over spawned
      parties with `kill:party=helper:step=prep_done`: one weight-check
      round at level 31 over the 64 attributes; one respawn, the accept
      bitmap phase e's, every attribute's sum numpy's, the prep-share
      and agg-share bytes count_round_bytes'.  k2: phase a's Count cell
      over two `python -m mastic_tpu_torch.tools.party serve` processes
      dialed by `ProcessCollector(connect=...)` (reliable channels,
      plaintext), 16 levels from the root pruned at the threshold, one
      conn_drop on the leader's link: every level's prefixes and counts
      phase a's, at least one reconnect.  k3: phase c's Histogram
      reports over spawned parties, one weight-check round at level 63
      over the 16 attributes (joint rand through the leader's resolve
      and the helper's confirm): every report accepted, the 16-bucket
      aggregates numpy's.  Each party counts its launches and device
      peak in its own process and writes them to its trace file
      (MASTIC_TRACE_FILE, under build/parties/); each must have launched
      K1 and K3.
   l. The collector service (`drivers/service.py`), after phase k.
      l1: one `CollectorService` on the card (overlap 2, two ingest
      threads, pages of 256, a group-fsync `AdmissionWal` and the status
      endpoints under build/service/, an `UploadFront` and a
      `StatusServer` on 127.0.0.1 port 0) with two tenants: "count",
      MasticCount(256) heavy hitters at threshold 48 over phase a's
      uploads, and "attrs", MasticSum(32, 255) attribute metrics over
      phase e's 64 attributes and its uploads, the tampered ones
      included (they pass the door; the round rejects them).  The
      uploads are phase a's and phase e's `wire_rows` framed as
      `encode_upload` frames them (held against `encode_upload` of the
      scalar report on a few lanes, tampered ones included); the port's
      `LoadGenerator` PUTs them with about 2% malformed extras (202
      while the ingest front is armed, quarantined behind it), then the
      front is stopped and a second malformed burst gets 400s.  One
      epoch per tenant, with `MASTIC_TORCH_PROFILE` armed for the first
      round (its Chrome trace must name K3's kernel).  After the count
      tenant's level 1 the service is snapshotted (`to_bytes`, the WAL
      marked covered), discarded, and restored (`from_bytes` +
      `AdmissionWal.recover`); the restored service finishes both
      epochs.  Checked: the HTTP code mix equals the counters' deltas
      exactly; every count level equals phase a's and the heavy hitters
      are the planted strings (past SERVICE_CUT_AFTER_S the count epoch
      is cut by its deadline after SERVICE_CUT_LEVELS levels, printed,
      and its frontier equals phase a's there); every attribute's sum
      equals phase e's numpy sum, with the tampered reports rejected
      per check; /metrics, /statusz and /varz, fetched mid-run, carry
      both tenants' series; K1 and K3 launched in each tenant's rounds
      (phase a's and e's client shards launched K2).  l2: `python -m
      mastic_tpu_torch.tools.serve --smoke --status-port 0 --device
      cuda` as a child process prints `"ok": true`.
   o. The kernel store (`drivers/artifacts.py`), last.  A store baked
      (`tools.bake.bake`) from a fresh nvcc build in a temporary root,
      each library's kernels held against their plain versions' probe
      digests; then the serve tool's default scenario as fresh child
      processes, each from a temporary copy of the package (no
      build/kernels/ to reuse): o1 without a store (nvcc inline); o2
      with `--artifact-dir` and nvcc off PATH and out of CUDA_HOME: no
      inline build, 3 store hits, no round reporting an inline build,
      results and per-round counters equal o1's; o3 over a copy of the
      store with one byte of the level library's blob flipped: outcome
      `corrupt`, that library alone built inline, results equal o1's;
      o4, run beside o3, killed by `MASTIC_FAULTS=kill:party=collector:
      step=epoch_round:nth=2` with a snapshot, then `--resume`d with the
      store and nvcc hidden: results equal o1's.  Each child's time from
      its spawn to the end of its first round is printed (o3's and o4's
      side by side), with the per-library load and probe times.
   p. The collector service under a report mesh, after o.  p1: one
      `CollectorService(mesh=)` on MESH_RANKS gloo ranks sharing the
      card (`mesh_service_rank`): rank 0 admits phase a's uploads
      through its ingest front and cuts the epoch, rank 0's pages reach
      the other rank at the first quantum, overlap 2; every level a
      rank completed must equal phase a's, both ranks' records be
      equal, and every rank launch K1 and K3 (past
      MESH_SERVICE_CUT_AFTER_S the epoch is cut by rank 0's deadline
      after MESH_SERVICE_CUT_LEVELS levels, printed).  Beside it, as
      children: p2, `tools.serve --mesh 1 --backend nccl --device
      cuda`, whose results must equal phase o's serve child's (the same
      default scenario); p3, `tools.serve --overlap-drill --device
      cuda`, which must print `"ok": true`.
   q. The node axis (`parallel.install_grid_sharding`: a from-root
      round's prefixes split over the node ranks, each walking its
      block's subtree, the tree exchanged so that each rank checks
      every node of its share of the reports).  q1, inside phase j's
      two gloo ranks on a second mesh over them, reports 1 x nodes 2:
      the resident run's last level as one `run_round` from the root
      over its 8192 reports, the aggregates equal to the resident
      run's; then phase e's attribute round (its reports as phase j
      sharded them), held as phase e holds it.  q2, four gloo ranks
      sharing the card, reports 2 x nodes 2: phase e's attribute
      round, held the same way.  Past NODES_CUT_AFTER_S before phase j
      q1's Count run and q2 take 4096 reports (printed as a cut).  Each
      rank prints its walked and shared nodes, the exchange's bytes and
      time (CUDA events around the packing, the copies through host
      memory, the collective and the unpacking), its round time and
      device peak beside phase e's, and its launches; every rank must
      launch K1 (the eval-proof XOF and the binder sponge) and K3.
4. Prints the `kernels` JSON line (every kernel and instantiation; the
   Count rows' `launches_mesh` are rank 0's launches in the gloo
   resident run, its shard of its rows included, the MasticSum rows' in
   the gloo attribute round, likewise; `launches_parties` are each
   party's launches in phase k's sub-phase of the row's instantiation,
   Count k2, MasticSum k1, Field128 k3; `launches_service` are the
   launches in phase l's rounds of the row's tenant, Count rows from
   "count", MasticSum rows from "attrs", Field128 rows null;
   `launches_northstar` on the Count rows are each phase-m run's
   launches, the mesh run's counted in its rank;
   `launches_mesh_service` on the Count rows are each p1 rank's
   launches in its rounds; `launches_nodes` on the Count rows are each
   q1 rank's launches in its Count run, on the MasticSum rows each q1
   and q2 rank's in its attribute round, and phase q's own rows take
   their `launches` from q1's rank 0; phase n's rows take
   their launches from n1 and n2), the card, each path's figures, and
   last `{"ok": true, "device": {...}}`.
   Any failure exits non-zero before that line.

Exits 2 without a card.  Needs the repository beside it (it imports
mastic_tpu_torch).
"""

import argparse
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# H100 SXM peaks: HBM3 bytes/s (NVIDIA data sheet), and 32-bit integer
# logic and shift instructions/s = 132 SMs x 64 results per clock (the
# CUDA C++ Programming Guide's throughput table, compute capability 9.0)
# x 1.98 GHz boost; the data sheet gives no integer rate outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

R = 4096
BITS = 256
PLANTED = 32
PER_PLANTED = 64
THRESHOLD = 48
# Weighted heavy hitters: MasticSum(256, 255), 8-bit weights, the same
# report layout, threshold 48 x 128 (the Count threshold times the mean
# weight: it keeps the frontier near the Count path's 64).
SUM_MAX = 255
SUM_THRESHOLD = 48 * 128
# Its levels: 128 of the 256 since phase q needed the time (printed as
# a cut); the heavy hitters are held to the planted strings at 256.
SUM_LEVELS = 128
SUM_VALUE_LEN = 1 + 2 * SUM_MAX.bit_length()
# The Field128 path: MasticHistogram(64, 16, 4) over 16 planted 64-bit
# attribute strings, and the long-payload shard MasticSumVec(128, 1024,
# 1, 32).
HIST = (64, 16, 4)
HIST_ATTRS = 16
SUMVEC = (128, 1024, 1, 32)
# Attribute metrics: BASELINE.json's "Mastic<Sum(2^8), BITS=32>, 10k
# clients, single agg round", MasticSum(32, 255) over 10 000 reports
# and 64 attributes of interest (four in five reports take one of
# them), with 100 reports of each tampered kind (~1%).
ATTR_BITS = 32
ATTR_R = 10_000
ATTR_ASKED = 64
ATTR_TAMPERED = 100
# SumVec from the root: 4 attributes over the first SUMVEC_ROOT_R of the
# sumvec path's 4096 reports, in chunks of 512 (the flat tree is about
# 33 MB a report, so about 17 GB a chunk and aggregator; about 12 s a
# chunk on an H100, so R is cut from 4096 for time, and the cut
# printed).  K1's SumVec row keeps the 1024 reports of the unchunked
# round it was first held at.
SUMVEC_ASKED = 4
SUMVEC_CHUNK = 512
SUMVEC_ROOT_R = 2048
SUMVEC_BINDER_R = 1024
# K3's in-range predicate on the card: fresh parents at the attribute
# row's shape (10 000 x 64 parents x 2 children x 17 Field64 elements,
# 21.76 M samples a launch, each rejected with probability about
# 2^-32) until a launch returns ok False: about 200 launches expected,
# and a miss in OK_DRAWS launches has probability about e^-15.
OK_DRAWS = 3000
# The resident checkpoint phase: MasticCount(16) over the Count path's
# report layout, lanes forced to the XOF fallback at levels 8 and 15,
# checkpointed after level 8 (the first lane is in `fallback` there).
# The splice reruns a fired lane's scalar round at every later level,
# so the levels were moved from 0 and 9 for the smoke's time (23 scalar
# rounds to 9; the cut is printed).
CKPT_BITS = 16
CKPT_FORCED_LEVELS = (8, 15)
CKPT_SPLIT = 9
# The chunked checkpoint phase: that phase's reports through the chunked
# runner in four chunks, checkpointed at the same split.
CKPT_CHUNK = R // 4
# The chunked Count cell: the Count path's recipe scaled x8 (32 planted
# strings x 512 reports and 16 384 uniform ones), sharded in batches of
# 4096, streamed from pinned host memory in 8 chunks of 4096, pipelined,
# through the first 8 levels, threshold 48 x 8.  A resident run would
# hold 32 768 x 2.0 MiB of carries at width 64 on the card (68.8 GB),
# and its peak, the resident Count path's scaled x8, is past the card.
# CHUNKED_LEVELS was cut from 16 to 8 (its floor) for the smoke's time;
# the cut is printed.
CHUNKED_R = 8 * R
CHUNKED_FALLBACK_R = 4 * R
CHUNKED_CHUNK = R
CHUNKED_LEVELS = 8
CHUNKED_THRESHOLD = 8 * THRESHOLD
# The mesh phase (j), over torch.distributed: NCCL at 1 rank on the card
# (the Count path's reports, MESH_NCCL_LEVELS levels, each against phase
# a's), then gloo at 2 ranks sharing the card.  Resident: the Count
# recipe x2 (32 planted strings x 128 reports and 4096 uniform ones,
# threshold 48 x 2), 4096 rows a rank, MESH_LEVELS levels (MESH_CUT_LEVELS
# when the smoke has run past MESH_CUT_AFTER_S by then, printed as a
# cut; MESH_LEVELS, 256 until phase q needed the time, printed as a
# cut).  Chunked: the same reports at chunk_size 2047 (odd: every chunk
# pads to 2048, 1024 rows a rank, and the tail holds 4 live rows),
# pipelined, MESH_CHUNKED_LEVELS levels (cut from 16 to 8 for the
# smoke's time, printed).  Then the attribute round of phase e over both
# ranks.  Each rank's device budget is 40% of the card, as two share it.
MESH_NCCL_LEVELS = 16
MESH_RANKS = 2
MESH_R = 2 * R
MESH_THRESHOLD = 2 * THRESHOLD
MESH_CHUNK = 2047
MESH_CHUNKED_LEVELS = 8
MESH_LEVELS = 128
MESH_CUT_LEVELS = 64
MESH_CUT_AFTER_S = 600.0
MESH_BUDGET_SHARE = 0.4
MESH_COUNTERS = {
    "resident": ("keccak", "keccak_binder", "aes", "level"),
    "chunked": ("keccak", "keccak_binder", "level"),
    "attributes": ("keccak", "keccak_binder", "aes", "level"),
    "nccl": ("keccak", "keccak_binder", "aes", "level"),
    "nodes": ("keccak", "keccak_binder", "level"),
}
# Phase q, the node axis (`parallel.install_grid_sharding`): q1 on a
# second mesh over phase j's gloo ranks, reports 1 x nodes NODES_AXIS
# (the Count run from the root at the resident run's last level over
# its MESH_R reports, and phase e's attribute round); q2 on
# NODES_Q2_RANKS gloo ranks sharing the card, reports 2 x nodes 2, phase
# e's attribute round.  Past NODES_CUT_AFTER_S before phase j, q1's
# Count run and q2 take NODES_CUT_R reports (printed as a cut).  Every
# rank must launch MESH_COUNTERS["nodes"].  The Count block's K3 row is
# timed at NODES_COUNT_PARENTS parents: node rank 0's half of the
# resident run's 64-prefix frontier.
NODES_AXIS = 2
NODES_Q2_RANKS = 4
NODES_CUT_AFTER_S = 600.0
NODES_CUT_R = R
NODES_COUNT_PARENTS = 2 * PLANTED // NODES_AXIS
# Phase m, the north-star tool (`python -m mastic_tpu_torch.tools.northstar`)
# in this process: NORTHSTAR_R MasticCount reports with the tool's three
# planted paths, chunked in chunks of NORTHSTAR_CHUNK, resident, and over
# NCCL at one rank (chunked); NORTHSTAR_CUT_BITS bits past
# NORTHSTAR_CUT_AFTER_S.
NORTHSTAR_R = 8 * R
NORTHSTAR_CHUNK = R
NORTHSTAR_BITS = 32
NORTHSTAR_CUT_BITS = 16
NORTHSTAR_CUT_AFTER_S = 700.0
NORTHSTAR_RUNS = (("chunked", []), ("resident", ["--resident"]),
                  ("mesh", ["--mesh", "1", "--backend", "nccl"]))
NORTHSTAR_COUNTERS = ("keccak", "keccak_binder", "aes", "level")
# Phase n: MasticMultihotCountVec at the Histogram cell's shape (64-bit
# attribute strings, 16 entries, chunk 4, at most 4 hot) over R reports
# with MULTIHOT_TAMPERED tampered proof shares; MasticHistogram(64, 16,
# 4) at BASELINE.json's 100 000 reports from the root (HIST100K_CUT_R
# past HIST100K_CUT_AFTER_S), its chunk priced by memory_envelope at the
# from-root tree's padded width.  K1's binder rows at these shapes are
# checked on their first BINDER_CHECK_R reports.
MULTIHOT = (64, 16, 4, 4)
MULTIHOT_ATTRS = 16
MULTIHOT_TAMPERED = 100
HIST100K_R = 100_000
HIST100K_CUT_R = 8 * R
HIST100K_CUT_AFTER_S = 650.0
HIST100K_WIDTH = 32
BINDER_CHECK_R = 128
# The launch counters each path must reach (ops/kernels.py): K1's
# in-place sponge and its binder sponge (per field), K2's fixed-key
# entry, K3 and the field kernel (per field).  The from-root
# cross-check of the Count path runs no shard, so no K2.
PATH_COUNTERS = {
    "count": ("keccak", "keccak_binder", "aes", "level", "field"),
    "count_from_root": ("keccak", "keccak_binder", "level", "field"),
    "sum": ("keccak", "keccak_binder", "aes", "level", "field"),
    "histogram": ("keccak", "keccak_binder_f128", "aes", "level_f128",
                  "field_f128"),
    "sumvec": ("keccak", "keccak_binder_f128", "aes", "level_f128",
               "field_f128"),
    "attributes": ("keccak", "keccak_binder", "aes", "level", "field"),
    "attributes_splice": ("keccak", "keccak_binder", "level", "field"),
    "resident_checkpoint": ("keccak", "keccak_binder", "aes", "level",
                            "field"),
    "count_chunked": ("keccak", "keccak_binder", "aes", "level", "field"),
    "chunked_checkpoint": ("keccak", "keccak_binder", "level", "field"),
    "multihot": ("keccak", "keccak_binder_f128", "aes", "level_f128",
                 "field_f128"),
    "histogram_100k": ("keccak", "keccak_binder_f128", "aes", "level_f128",
                       "field_f128"),
}
# Phase k, the party layer: the lanes whose upload blobs are held
# against the scalar encoder in k1, and where the party processes'
# trace files (MASTIC_TRACE_FILE) and the network parties' port files
# go.
PARTY_LANES = 8
PARTY_TRACES = pathlib.Path(__file__).resolve().parent / "build" / "parties"
CTX = b"mastic chip smoke"
LONG_CTX = bytes(range(150))
# Phase l, the collector service: its files (the WAL, the profile trace)
# go to build/service/; the lanes whose blobs are held against
# `encode_upload`; the malformed share of the load; and the depth cut of
# the count tenant when the smoke has run past SERVICE_CUT_AFTER_S
# before phase l.
SERVICE_DIR = pathlib.Path(__file__).resolve().parent / "build" / "service"
SERVICE_LANES = 3
SERVICE_MALFORMED = 0.02
SERVICE_PAGE = 256
SERVICE_CUT_AFTER_S = 750.0
SERVICE_CUT_LEVELS = 64
SERVICE_DRILL_LEVEL = 2      # rounds completed by the count tenant
SERVICE_FETCH_LEVEL = 8      # ... when the endpoints are fetched
PROFILE_KERNEL = "level_kernel"   # K3's __global__ (csrc/level.cu)
# What each tenant's rounds must launch, and its clients' shard.
SERVICE_COUNTERS = {"rounds": ("keccak", "keccak_binder", "level"),
                    "shard": ("aes",)}

# The forced splice from the root asks SPLICE_ASKED of phase e's
# attributes (the honest lane's among them): its scalar prep of the two
# forced lanes grows with the attributes asked (about 78 s at all 64 on
# an H100 host, 12 s at 8), and it is held against an unforced round
# over the same attributes.
SPLICE_ASKED = 4
# Phase o, the kernel store: the library whose blob the corrupted store
# flips a byte of, and the fault that kills the serve child mid-epoch.
STORE_CORRUPT = "level"
STORE_KILL = "kill:party=collector:step=epoch_round:nth=2"
# Phase p, the service under a report mesh: phase a's uploads to one
# CollectorService on MESH_RANKS gloo ranks sharing the card, admitted
# on rank 0 (pages of SERVICE_PAGE, two ingest threads) and broadcast at
# the epoch's first quantum, overlap 2; past MESH_SERVICE_CUT_AFTER_S
# (it always is, at the smoke's end) the epoch is cut by rank 0's
# deadline after MESH_SERVICE_CUT_LEVELS levels, printed.
MESH_SERVICE_DIR = pathlib.Path(__file__).resolve().parent / "build" \
    / "mesh_service"
MESH_SERVICE_CUT_AFTER_S = 800.0
MESH_SERVICE_CUT_LEVELS = 64

# Operation counts for the bounds, in 32-bit instructions as the card
# issues them: one LOP3 computes any function of three words, and a
# 64-bit rotate is two funnel shifts (SHF).
# Keccak round: theta parities 5 columns x 2 halves x 2 LOP3, their
# rotations 5 x 2 SHF, theta applied 25 x 2 LOP3 (a ^ c[x-1] ^ rot
# c[x+1]), rho 24 x 2 SHF, chi 25 x 2 LOP3 (b ^ (~c & d)), iota 2: the
# fewest the function needs.  (ptxas compiles csrc/keccak.cuh's
# keccak_p1600 to 194 a round, 136 LOP3 and 58 SHF: the compiled code's
# loss, not part of the bound.)
KECCAK_PERM_OPS = 12 * (20 + 10 + 50 + 48 + 50 + 2)
KECCAK_ABSORB_OPS = 42          # one rate block: 21 lanes x 2 XOR
# The payload check's arithmetic per Field64 element: 3 values from 4
# limbs (4 each: two halves of one LOP3 and one SHF), the add (2 IADD,
# 2 for the compare and the conditional subtract) and the sub (2 IADD,
# 2 for the borrow's conditional add of p).  A Field128 element: 3
# values from 8 limbs (8 each), the add (4 IADD with carries, 4 for the
# compare against p and the conditional subtract) and the sub (4 with
# borrows, 4 for the conditional add of p).
PAYLOAD_ELEM_OPS = 3 * 4 + 4 + 4
PAYLOAD_ELEM_OPS_F128 = 3 * 8 + 8 + 8
# AES over one column of 32 blocks (a 32-bit word per state bit), in
# 2-input gates: 11 round keys x 128 XOR, 10 x 16 tower S-boxes of 195
# gates, 9 x 16 MixColumns bytes of 35 XOR; charged at two gates per
# LOP3, the most an LOP3 takes from an XOR tree.
SBOX_GATES = 195
AES_BLOCK_OPS = (11 * 128 + 10 * 16 * SBOX_GATES + 9 * 16 * 35) / 2


def _bound(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def _warm(fn, seconds: float = 0.2) -> None:
    """Run fn() until `seconds` have passed, so that the card's clocks
    have left idle before a measurement."""
    t0 = time.perf_counter()
    while True:
        fn()
        torch.cuda.synchronize()
        if time.perf_counter() - t0 >= seconds:
            return


def _time(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs, by CUDA events."""
    _warm(fn)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, names: tuple, reps: int) -> dict:
    """Mean device milliseconds per call of fn() in each kernel whose
    name contains one of `names`, from a torch.profiler trace.  A trace
    that holds no device time for one of them (the profiler now and then
    records none) is taken again, up to five in all; then it fails."""
    _warm(fn)
    for _attempt in range(5):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = dict.fromkeys(names, 0.0)
        for event in prof.key_averages():
            for name in names:
                if name in event.key:
                    out[name] += event.self_device_time_total / 1e3 / reps
        if all(out.values()):
            return out
    raise AssertionError(f"no device time recorded for {names}: {out}")


def _max_err(got, want) -> int:
    """Largest absolute difference over matching outputs (as int64)."""
    err = 0
    for (a, b) in zip(got, want):
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def check_kernels(dev: torch.device, gen: torch.Generator) -> list:
    """Each kernel against its plain version at main-path shapes."""
    from mastic_tpu_torch.ops.field import FIELD64

    rows = []

    # K1's gathered binder sponge at a level-255 carry (W = 64: 32
    # parents per depth), index lists shaped like RoundPlan's.
    rows.append(check_binder_sponge(dev, gen))
    # K1's in-place sponge at the paths' shapes and its permutation.
    rows.append(check_k1_entries(dev, gen))

    rows.append(check_aes(dev, gen))
    # K3 with a level-255 node binder, at the main path's R x 32 parents
    # (padded width 64), at R x 64 parents, and at R x 32 parents with a
    # 150-byte ctx, whose node-proof message takes two rate blocks.
    level_rows = {}
    for (parents, ctx) in ((64, CTX), (32, LONG_CTX), (32, CTX)):
        row = check_level(dev, gen, FIELD64, 2, parents, ctx, "level_step")
        level_rows[(parents, len(ctx))] = row
    for ((parents, ctx_len), row) in level_rows.items():
        print(f"K3: whole call {row['ms']:.4f} ms, kernels "
              f"{row['device_ms']:.4f} ms (plain {row['plain_ms']:.3f} ms, "
              f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}) at "
              f"{row['shape']}, max_abs_err {row['max_abs_err']}")
        if row["max_abs_err"]:
            raise AssertionError(f"K3 disagrees with its plain version at "
                                 f"{row['shape']}")
    threads = 8 * 32 * (R // 32)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"K3 grid at {R} reports x 32 parents: level kernel "
          f"{threads // 128} blocks of 128 threads (four per (child, packed "
          f"word)) on {sms} SMs; node proofs {R * 64 // 128} blocks of 128 "
          f"threads (one per (report, child))")
    main = level_rows[(32, len(CTX))]
    long_row = level_rows[(32, len(LONG_CTX))]
    main["max_abs_err"] = max(r["max_abs_err"] for r in level_rows.values())
    wide = level_rows[(64, len(CTX))]
    main["shape"] += (f"; x 64 parents: whole call {wide['ms']:.4f} ms, "
                      f"kernels {wide['device_ms']:.4f} ms; ctx "
                      f"{len(LONG_CTX)} B: whole call {long_row['ms']:.4f} ms,"
                      f" kernels {long_row['device_ms']:.4f} ms, bound "
                      f"{long_row['bound_ms']:.4f} ms")
    rows.append(main)
    for row in rows:
        if row["max_abs_err"]:
            raise AssertionError(f"{row['name']} disagrees with its plain "
                                 f"version: {row['max_abs_err']}")
    return rows


def field_values(spec, shape: tuple, dev: torch.device,
                 gen: torch.Generator) -> torch.Tensor:
    """Random plain limbs (..., n) int32 of which every 97th element is
    a value >= p (p, p + 1, 2^(16n) - 1 in turn): what the level step
    stores where its in-range mask fails."""
    limbs = torch.randint(0, 1 << 16, shape + (spec.num_limbs,),
                          dtype=torch.int32, device=dev, generator=gen)
    flat = limbs.view(-1, spec.num_limbs)
    for (i, v) in enumerate((spec.modulus, spec.modulus + 1,
                             2 ** (16 * spec.num_limbs) - 1)):
        flat[i::3 * 97] = torch.as_tensor(spec.int_to_limbs(v), device=dev)
    return limbs


def check_level(dev: torch.device, gen: torch.Generator, spec,
                value_len: int, parents: int, ctx: bytes, name: str,
                reports: int = R, binder_len: int = 36,
                until_reject: bool = False) -> dict:
    """K3 against its plain version at `reports` x `parents` with a
    `binder_len`-byte node binder (level 255's by default) and payloads
    of `value_len` elements of `spec`'s field (w_cw holding values >=
    p): the whole call by CUDA events, its two kernels' device time from
    a profiler trace, the plain version's time and the bound.  With
    `until_reject`, fresh parent seeds and control bits are drawn until
    a launch returns `ok` False somewhere (the kernel's in-range
    predicate fired), at most OK_DRAWS launches; that launch's inputs
    are the ones held against the plain version and timed."""
    from mastic_tpu_torch.backend.vidpf import BatchedVidpf
    from mastic_tpu_torch.backend.xof import ts_prefix
    from mastic_tpu_torch.scalar.dst import USAGE_NODE_PROOF, dst
    from mastic_tpu_torch.ops import level

    def rand_u8(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                             generator=gen)

    vid = BatchedVidpf(BITS, value_len, spec)
    (ext_rk, conv_rk) = vid.roundkeys(ctx, rand_u8(reports, 16))
    prefix = ts_prefix(dst(ctx, USAGE_NODE_PROOF), 16)
    cw = (rand_u8(reports, 16), rand_u8(reports, 2) >= 128,
          field_values(spec, (reports, value_len), dev, gen),
          rand_u8(reports, 32))
    binder = rand_u8(2 * parents, binder_len)

    def draw():
        return (spec, vid.convert_blocks, value_len, ext_rk, conv_rk,
                rand_u8(reports, parents, 16),
                rand_u8(reports, parents) >= 128, cw, prefix, binder,
                binder_len)

    args = draw()
    draws = 1
    t0 = time.perf_counter()
    while until_reject and bool(level.level_step(*args)[3].all()):
        if draws == OK_DRAWS:
            raise AssertionError(f"K3 returned no ok False in {draws} "
                                 f"launches at {reports} x {parents}")
        args = draw()
        draws += 1
    draw_s = time.perf_counter() - t0
    got = level.level_step(*args)
    err = _max_err(got, level.level_step_plain(*args))
    false_slots = int((~got[3]).sum())
    del got
    # The whole call by CUDA events (what the main path pays: the
    # wrapper's template and copies, and the kernels), as in PR 1; the
    # kernels' own device time from a profiler trace beside it.
    reps = 5 if vid.convert_blocks < 100 else 2
    split = _device_ms(lambda: level.level_step(*args),
                       ("level_kernel", "node_proof_kernel"), reps)
    ms = _time(lambda: level.level_step(*args), reps)
    plain_ms = _time(lambda: level.level_step_plain(*args), 1)
    pairs = (reports + 31) // 32 * parents
    nb = (len(prefix) + 16 + binder_len) // 168 + 1
    elem = spec.num_limbs * 4
    in_bytes = 2 * 11 * 16 * reports + reports * parents * 17 \
        + reports * (16 + 2 + value_len * elem + 32) + len(prefix) \
        + binder.numel()
    out_bytes = reports * 2 * parents * (16 + 1 + value_len * elem + 1 + 32)
    # Per (packed word x parent): both children's extend and convert AES
    # columns, and 64 node-proof sponges of nb blocks each.
    ops = pairs * (2 * (1 + vid.convert_blocks) * AES_BLOCK_OPS
                   + 64 * nb * (KECCAK_PERM_OPS + KECCAK_ABSORB_OPS))
    (bound, by) = _bound(float(in_bytes + out_bytes), float(ops))
    field = "Field128" if spec.num_limbs == 8 else "Field64"
    drawn = {}
    if until_reject:
        drawn = {"draws": draws, "ok_false_slots": false_slots,
                 "draw_s": draw_s}
    return {
        **drawn, "name": name, "route": "cuda",
        "source": "mastic_tpu_torch/csrc/level.cu",
        "replaces": "mastic_tpu/ops/level_pallas.py:521",
        "max_abs_err": err, "kernel_ms": ms, "ms": ms,
        "device_ms": sum(split.values()),
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": None,
        "shape": f"{reports} reports x {parents} parents, {field} VALUE_LEN "
                 f"{value_len} ({vid.convert_blocks} convert blocks), ctx "
                 f"{len(ctx)} B (node proof {nb} block"
                 f"{'s' if nb > 1 else ''}): level_kernel "
                 f"{split['level_kernel']:.4f} ms + node_proof_kernel "
                 f"{split['node_proof_kernel']:.4f} ms device time"}


def check_new_shapes(dev: torch.device, gen: torch.Generator) -> list:
    """The kernels at the shapes of the Sum, Histogram and SumVec paths,
    each row under its own name: K3 at MasticSum(256, 255)'s (Field64,
    VALUE_LEN 17, 10 convert blocks) and MasticHistogram(64, 16, 4)'s
    (Field128, VALUE_LEN 17, 18 blocks) widest levels (R x 32 parents),
    and at depth 0 with 1026 blocks (SumVec(1024)'s beta share); K1's
    binder sponge on MasticSum(256, 255)'s 17-element Field64 rows (at
    depth 64, and the kernel alone at depth 256) and on two Field128
    carries at the Histogram path's last level; K2 at 10, 18 and 1026
    blocks."""
    from mastic_tpu_torch.ops.field import FIELD64, FIELD128

    rows = []
    for (spec, value_len, parents, name) in (
            (FIELD64, SUM_VALUE_LEN, 32, "level_step_sum"),
            (FIELD128, 1 + HIST[1], 32, "level_step_f128_histogram"),
            (FIELD128, 1 + SUMVEC[1] * SUMVEC[2], 1,
             "level_step_f128_sumvec_depth0")):
        row = check_level(dev, gen, spec, value_len, parents, CTX, name)
        print(f"K3 ({name}): whole call {row['ms']:.4f} ms, kernels "
              f"{row['device_ms']:.4f} ms (plain {row['plain_ms']:.3f} ms, "
              f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}) at "
              f"{row['shape']}, max_abs_err {row['max_abs_err']}")
        rows.append(row)

    # K1's binder sponge on MasticSum(256, 255)'s 17-element Field64
    # rows (the Sum path's width 64, 32 planted strings), checked at depth
    # 64: at depth 256 the two carries take 36.5 GB and the plain
    # version's gathered int64 rows 18 GB each, more than the card holds.
    # The kernel alone is timed and bounded at depth 256 too.
    (err, plain_ms, args) = _binder_compare(
        dev, gen, 64, CTX, value_len=SUM_VALUE_LEN, alg_id=0xFFFF0002)
    row = _binder_row("keccak_binder_sponge_sum", args, err, plain_ms,
                      PAYLOAD_ELEM_OPS)
    del args
    torch.cuda.empty_cache()
    (ms, bound, by, shape) = _binder_cost(
        binder_inputs(dev, gen, BITS, CTX, value_len=SUM_VALUE_LEN,
                      alg_id=0xFFFF0002), PAYLOAD_ELEM_OPS)
    torch.cuda.empty_cache()
    print(f"keccak_binder_sponge_sum at depth {BITS} (kernel alone): "
          f"{shape}, {ms:.4f} ms (bound {bound:.4f} ms by {by})")
    row["shape"] += (f", depth 64; at depth {BITS} (not checked against the "
                     f"plain version): {ms:.4f} ms, bound {bound:.4f} ms by "
                     f"{by}")
    rows.append(row)

    # K1's binder sponge on Field128 carries: the Histogram path's level
    # 63 (width 32, at most 16 parents a depth).
    (err, plain_ms, args) = _binder_compare(
        dev, gen, HIST[0], CTX, spec=FIELD128, width=32,
        value_len=1 + HIST[1], planted=HIST_ATTRS, alg_id=0xFFFF0004)
    rows.append(_binder_row("keccak_binder_sponge_f128", args, err,
                            plain_ms, PAYLOAD_ELEM_OPS_F128))
    del args

    # K2 at the three payloads' convert shapes: R reports x 2 seeds.
    for (blocks, name) in ((10, "aes_fixed_key_blocks_sum"),
                           (18, "aes_fixed_key_blocks_histogram"),
                           (1026, "aes_fixed_key_blocks_sumvec")):
        rows.append(_aes_row(dev, gen, blocks, name))
    for row in rows:
        if row["max_abs_err"]:
            raise AssertionError(f"{row['name']} disagrees with its plain "
                                 f"version: {row['max_abs_err']}")
    return rows


def _aes_row(dev: torch.device, gen: torch.Generator, blocks: int,
             name: str) -> dict:
    """K2's fixed-key entry at a payload's convert shape, R reports x 2
    seeds x `blocks` blocks, against its plain version: the whole call
    (CUDA events), the kernel (profiler), the plain version and the
    bound."""
    from mastic_tpu_torch.backend.xof import (fixed_key_blocks,
                                              fixed_key_blocks_plain)
    from mastic_tpu_torch.ops import aes

    keys = torch.randint(0, 256, (R, 16), dtype=torch.uint8, device=dev,
                         generator=gen)
    seeds = torch.randint(0, 256, (R, 2, 16), dtype=torch.uint8,
                          device=dev, generator=gen)
    rk = aes.aes128_key_schedule(keys)
    err = _max_err([fixed_key_blocks(rk, seeds, blocks)],
                   [fixed_key_blocks_plain(rk, seeds, blocks)])
    ms = _time(lambda: fixed_key_blocks(rk, seeds, blocks), 50)
    device_ms = _device_ms(lambda: fixed_key_blocks(rk, seeds, blocks),
                           ("fixed_key_kernel",), 50)["fixed_key_kernel"]
    plain_ms = _time(lambda: fixed_key_blocks_plain(rk, seeds, blocks), 1)
    columns = R // 32 * 2 * blocks
    (bound, by) = _bound(float(R * (11 * 16 + 2 * 16 + 2 * blocks * 16)),
                         columns * AES_BLOCK_OPS)
    print(f"K2 fixed_key_blocks at {R} reports x 2 seeds x {blocks} "
          f"blocks: whole call {ms:.4f} ms, kernel {device_ms:.4f} ms "
          f"(plain {plain_ms:.3f} ms, bound {bound:.4f} ms by {by}), "
          f"max_abs_err {err}")
    return {"name": name, "route": "cuda",
            "source": "mastic_tpu_torch/csrc/aes.cu",
            "replaces": "mastic_tpu/ops/aes_pallas.py:149",
            "max_abs_err": err, "kernel_ms": ms, "ms": ms,
            "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "shape": f"fixed_key_blocks, {R} reports x 2 seeds x "
                     f"{blocks} blocks"}


# The field kernel's rows (field, name, batch shape, the path whose
# launches the row reports): the Field128 weight check's shapes at the
# Histogram 100k round's chunk of 15 360 reports (the wires (R, arity 8,
# p 8) and the size-2p NTT's rows (R, 16)), and the MasticSum(32, 255)
# attribute round's wires (10 000 x 2 x 32) for Field64.
FIELD_ROWS = (("field128", "wires", (15_360, 8, 8), "histogram_100k"),
              ("field128", "ntt", (15_360, 16), "histogram_100k"),
              ("field64", "wires", (10_000, 2, 32), "attributes"))
FIELD_OPS = ("mul", "add", "sub")


def check_field(dev: torch.device, gen: torch.Generator) -> list:
    """The field kernel (csrc/field.cu) at the weight check's shapes,
    each of add, sub and mul against the plain limb code on the card
    (`spec.plain`), bit for bit on limbs with values >= p among them:
    the whole call (CUDA events), the kernel (profiler), the plain
    version and the bytes bound (two operands read, one written)."""
    from mastic_tpu_torch.ops.field import FIELD64, FIELD128

    specs = {"field64": FIELD64, "field128": FIELD128}
    rows = []
    for (field, label, shape, _path) in FIELD_ROWS:
        spec = specs[field]
        (a, b) = (field_values(spec, shape, dev, gen),
                  field_values(spec, shape, dev, gen))
        for op in FIELD_OPS:
            (fn, plain) = (getattr(spec, op), getattr(spec.plain, op))
            err = _max_err([fn(a, b)], [plain(a, b)])
            ms = _time(lambda: fn(a, b), 50)
            device_ms = _device_ms(lambda: fn(a, b), ("field_kernel",),
                                   50)["field_kernel"]
            plain_ms = _time(lambda: plain(a, b), 3)
            (bound, by) = _bound(3.0 * a.numel() * 4, 0.0)
            print(f"field {op} {field} at {shape}: whole call {ms:.4f} ms, "
                  f"kernel {device_ms:.4f} ms (plain {plain_ms:.3f} ms, "
                  f"bound {bound:.4f} ms by {by}), max_abs_err {err}")
            rows.append({
                "name": f"field_{op}_{field}_{label}", "route": "cuda",
                "source": "mastic_tpu_torch/csrc/field.cu",
                "replaces": "none (mastic_tpu/ops/field_jax.py, fused by "
                            "XLA)",
                "max_abs_err": err, "kernel_ms": ms, "ms": ms,
                "device_ms": device_ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": None,
                "shape": f"{op}, {shape} x {spec.num_limbs} limbs"})
            if err:
                raise AssertionError(f"the field kernel's {op} disagrees "
                                     f"with the plain version at {shape}")
    return rows


def flat_binder_inputs(dev: torch.device, gen: torch.Generator, sched,
                       reports: int, spec, value_len: int,
                       alg_id: int) -> tuple:
    """The arguments of `binder_checks` as the from-root prep passes
    them: one aggregator's random flat tree (reports, 1, T, value_len,
    n) with values >= p (`field_values`) and its node proofs, and the
    schedule's index lists into the flat node axis."""
    from mastic_tpu_torch.backend.xof import ts_prefix
    from mastic_tpu_torch.scalar.dst import (USAGE_ONEHOT_CHECK,
                                             USAGE_PAYLOAD_CHECK, dst_alg)

    total = sched.total_nodes
    w = field_values(spec, (reports, 1, total, value_len), dev, gen)
    proof = torch.randint(0, 256, (reports, 1, total, 32), dtype=torch.uint8,
                          device=dev, generator=gen)
    idx = tuple(torch.as_tensor(x, device=dev) for x in sched.check_indices())
    pre = tuple(ts_prefix(dst_alg(CTX, usage, alg_id), 0)
                for usage in (USAGE_ONEHOT_CHECK, USAGE_PAYLOAD_CHECK))
    return (spec, (w,), (proof,), *idx, *pre)


def _flat_binder_row(name: str, args: tuple, compare: tuple,
                     elem_ops: int, what: str) -> dict:
    """K1's binder sponge on a from-root flat tree: held bit-exact
    against its plain version on the inputs `compare`, the kernel timed
    and bounded on `args` (the path's shape)."""
    from mastic_tpu_torch.ops import binder

    got = binder.binder_checks(*compare)
    t0 = time.perf_counter()
    want = binder.binder_checks_plain(*compare)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = _max_err(got, want)
    del got, want
    (ms, bound, by, shape) = _binder_cost(args, elem_ops)
    print(f"{name}: {shape}, {ms:.4f} ms (bound {bound:.4f} ms by {by}); "
          f"against the plain version ({plain_ms:.1f} ms) {what}: "
          f"max_abs_err {err}")
    return {"name": name, "route": "cuda",
            "source": "mastic_tpu_torch/csrc/keccak.cu",
            "replaces": "mastic_tpu/ops/keccak_pallas.py:72",
            "max_abs_err": err, "kernel_ms": ms, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None, "shape": f"{shape}; checked {what}"}


def _end_rows(args: tuple, onehot: int, payload: int) -> tuple:
    """`flat_binder_inputs`' arguments with the index lists cut to
    their first entry and their last ones (`onehot` onehot rows,
    `payload` payload rows in all), on the same tree: every report's
    rows, the last reports' past 2^32 limbs, at the far end of the node
    axis."""
    (spec, ws, proofs, *idx) = args[:7]

    def ends(t, k):
        return torch.cat((t[:1], t[t.shape[0] - (k - 1):]))

    return (spec, ws, proofs, ends(idx[0], onehot),
            *(ends(t, payload) for t in idx[1:]), *args[7:])


def check_from_root(dev: torch.device, gen: torch.Generator,
                    seed: int) -> list:
    """The kernels at the from-root paths' shapes: K3 at the attribute
    round's (R = 10 000, not a multiple of 32, x 64 parents, Field64
    VALUE_LEN 17, an 8-byte binder); K1's binder sponge on that round's
    flat tree (one aggregator, its schedule's index lists), checked at
    the full R; and on the SumVec round's Field128 tree (1025-element
    rows, 1024 reports x 1008 nodes, 8.5 G limbs), timed there and
    checked against the plain version on that same tree with the index
    lists cut by `_end_rows` (the plain sponge runs its rate blocks one
    by one: the path's 49 000-block payload message would take it tens
    of minutes)."""
    from mastic_tpu_torch import hash_attribute
    from mastic_tpu_torch.backend.mastic import MasticSum, MasticSumVec
    from mastic_tpu_torch.backend.schedule import LevelSchedule
    from mastic_tpu_torch.ops.field import FIELD64, FIELD128

    row = check_level(dev, gen, FIELD64, SUM_VALUE_LEN, ATTR_ASKED, CTX,
                      "level_step_from_root_sum", reports=ATTR_R,
                      binder_len=4 + ATTR_BITS // 8)
    print(f"K3 (level_step_from_root_sum): whole call {row['ms']:.4f} ms, "
          f"kernels {row['device_ms']:.4f} ms (plain {row['plain_ms']:.3f} "
          f"ms, bound {row['bound_ms']:.4f} ms by {row['bound_by']}) at "
          f"{row['shape']}, max_abs_err {row['max_abs_err']}")
    rows = [row]

    # K3's in-range predicate: the same shape, fresh parents until a
    # launch rejects a sample (Field64 only: Field128 rejects about
    # 7 x 2^-62 of its samples, so no launch would).
    row = check_level(dev, gen, FIELD64, SUM_VALUE_LEN, ATTR_ASKED, CTX,
                      "level_step_ok_predicate", reports=ATTR_R,
                      binder_len=4 + ATTR_BITS // 8, until_reject=True)
    row["shape"] += (f"; drawn {row['draws']} launches until ok False "
                     f"({row.pop('draw_s'):.3f} s), at "
                     f"{row['ok_false_slots']} (report, child) slots")
    print(f"K3 ok predicate (level_step_ok_predicate): ok False after "
          f"{row['draws']} launches at {row['ok_false_slots']} (report, "
          f"child) slots, bit-exact against level_step_plain (ok "
          f"included), max_abs_err {row['max_abs_err']}; whole call "
          f"{row['ms']:.4f} ms at {row['shape']}")
    rows.append(row)

    mastic = MasticSum(ATTR_BITS, SUM_MAX)
    asked = attribute_measurements(seed)[0]
    sched = LevelSchedule(sorted(hash_attribute(mastic, a) for a in asked),
                          ATTR_BITS - 1, ATTR_BITS)
    args = flat_binder_inputs(dev, gen, sched, ATTR_R, FIELD64,
                              SUM_VALUE_LEN, MasticSum.ID)
    rows.append(_flat_binder_row(
        "keccak_binder_sponge_from_root_sum", args, args, PAYLOAD_ELEM_OPS,
        f"at the same {ATTR_R} reports x {sched.total_nodes} nodes"))
    del args
    torch.cuda.empty_cache()

    vec = MasticSumVec(*SUMVEC)
    paths = sorted(hash_attribute(vec, f"vector-{i}")
                   for i in range(SUMVEC_ASKED))
    sched = LevelSchedule(paths, vec.bits - 1, vec.bits)
    args = flat_binder_inputs(dev, gen, sched, SUMVEC_BINDER_R, FIELD128,
                              vec.value_len, MasticSumVec.ID)
    compare = _end_rows(args, onehot=8, payload=3)
    limbs = args[1][0].numel()
    rows.append(_flat_binder_row(
        "keccak_binder_sponge_from_root_sumvec", args, compare,
        PAYLOAD_ELEM_OPS_F128,
        f"on {SUMVEC_BINDER_R} reports x {sched.total_nodes} nodes "
        f"({limbs} limbs, {limbs / 2 ** 32:.2f} x 2^32) with the index "
        f"lists cut to onehot rows {compare[3].tolist()} and payload rows "
        f"(par, left, right) {list(zip(*(t.tolist() for t in compare[4:7])))}"))
    del args, compare
    torch.cuda.empty_cache()
    for row in rows:
        if row["max_abs_err"]:
            raise AssertionError(f"{row['name']} disagrees with its plain "
                                 f"version: {row['max_abs_err']}")
    return rows


def check_node_shapes(dev: torch.device, gen: torch.Generator,
                      seed: int) -> list:
    """The kernels at phase q's shapes (the node axis), each row under
    its own name: K3 at the attribute round's node block (10 000 reports
    x the widest depth of node rank 0's block, 32 of the 64 prefixes)
    and at the Count run's (MESH_R reports x NODES_COUNT_PARENTS
    parents, the binder of level MESH_LEVELS - 1); K1's binder sponge on
    the tree a rank holds after the exchange of the attribute round at
    reports 1 x nodes 2 (5000 reports x the round's 3332 nodes), timed
    there and checked on every report with the index lists cut to a few
    rows at both ends of the node axis (`_end_rows`: the plain sponge
    absorbs its ~2000 rate blocks one by one, ~17 s on the full lists
    on an H100's host)."""
    from mastic_tpu_torch import hash_attribute
    from mastic_tpu_torch.backend.mastic import MasticSum
    from mastic_tpu_torch.backend.schedule import LevelSchedule, node_blocks
    from mastic_tpu_torch.ops.field import FIELD64

    mastic = MasticSum(ATTR_BITS, SUM_MAX)
    asked = attribute_measurements(seed)[0]
    sched = LevelSchedule(sorted(hash_attribute(mastic, a) for a in asked),
                          ATTR_BITS - 1, ATTR_BITS)
    block = node_blocks(sched, NODES_AXIS)[0].sched
    rows = [check_level(dev, gen, FIELD64, SUM_VALUE_LEN,
                        max(block.num_children) // 2, CTX,
                        "level_step_from_root_sum_node_block",
                        reports=ATTR_R, binder_len=4 + ATTR_BITS // 8),
            check_level(dev, gen, FIELD64, 2, NODES_COUNT_PARENTS, CTX,
                        "level_step_from_root_count_node_block",
                        reports=MESH_R, binder_len=4 + MESH_LEVELS // 8)]
    for row in rows:
        print(f"K3 ({row['name']}): whole call {row['ms']:.4f} ms, kernels "
              f"{row['device_ms']:.4f} ms (plain {row['plain_ms']:.3f} ms, "
              f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}) at "
              f"{row['shape']}, max_abs_err {row['max_abs_err']}")
    args = flat_binder_inputs(dev, gen, sched, ATTR_R // NODES_AXIS,
                              FIELD64, SUM_VALUE_LEN, MasticSum.ID)
    compare = _end_rows(args, onehot=8, payload=3)
    rows.append(_flat_binder_row(
        "keccak_binder_sponge_from_root_sum_exchanged", args, compare,
        PAYLOAD_ELEM_OPS,
        f"on the same {ATTR_R // NODES_AXIS} reports x "
        f"{sched.total_nodes} nodes with the index lists cut to onehot "
        f"rows {compare[3].tolist()} and payload rows (par, left, right) "
        f"{list(zip(*(t.tolist() for t in compare[4:7])))}"))
    del args, compare
    torch.cuda.empty_cache()
    for row in rows:
        if row["max_abs_err"]:
            raise AssertionError(f"{row['name']} disagrees with its plain "
                                 f"version: {row['max_abs_err']}")
    return rows


def check_aes(dev: torch.device, gen: torch.Generator) -> dict:
    """K2 against its plain versions: the fixed-key entry (the main
    path's `fixed_key_blocks`) at the client shard's extend shape (next
    seeds sliced from the wider convert output, as `gen` passes them)
    and convert shape, at R - 3 reports with 3 blocks and at a
    throughput shape of 64 seeds a report; the planes entry at the
    shard's plane stack.  Times the whole `fixed_key_blocks` call (CUDA
    events), its kernel alone (profiler), the parent's path for the
    same call (PyTorch bit packing around the planes entry) and the
    planes entry."""
    from mastic_tpu_torch.backend.xof import (fixed_key_blocks,
                                              fixed_key_blocks_plain)
    from mastic_tpu_torch.backend.vidpf import BatchedVidpf
    from mastic_tpu_torch.ops import aes

    def inputs(reports, seeds, width=16):
        keys = torch.randint(0, 256, (reports, 16), dtype=torch.uint8,
                             device=dev, generator=gen)
        rows = torch.randint(0, 256, (reports, seeds, width),
                             dtype=torch.uint8, device=dev, generator=gen)
        return (aes.aes128_key_schedule(keys), rows[..., :16])

    def parent_path(round_keys, seeds, blocks):
        """The parent's `fixed_key_blocks` on the card: block indices
        uploaded from numpy, sigma and the feed-forward as byte
        tensors, PyTorch bit packing around the planes entry."""
        idx = np.zeros((blocks, 16), np.uint8)
        idx[:, 0] = np.arange(blocks)
        x = seeds[..., None, :] ^ torch.as_tensor(idx, device=dev)
        sigma = torch.cat([x[..., 8:], x[..., 8:] ^ x[..., :8]], dim=-1)
        planes = aes.bitslice_pack(sigma).contiguous()
        kp = aes.bitslice_keys(round_keys).contiguous()
        enc = aes.bitslice_unpack(aes.aes128_encrypt_bitsliced(kp, planes))
        out = enc ^ sigma
        return out.reshape(out.shape[:-2] + (blocks * 16,))

    def bound(reports, seeds, blocks):
        columns = (reports + 31) // 32 * seeds * blocks
        nbytes = reports * (11 * 16 + seeds * 16 + seeds * blocks * 16)
        return _bound(float(nbytes), columns * AES_BLOCK_OPS)

    convert_blocks = BatchedVidpf(BITS, 2).convert_blocks
    extend = (*inputs(R, 2, 16 * convert_blocks), 2)
    wide = (*inputs(R, 64), 2)
    cases = {"extend": extend, "convert": (*inputs(R, 2), convert_blocks),
             "ragged": (*inputs(R - 3, 2), 3), "throughput": wide}
    errs = {}
    for (name, args) in cases.items():
        errs[name] = _max_err([fixed_key_blocks(*args)],
                              [fixed_key_blocks_plain(*args)])
        (rk, seeds, blocks) = args
        print(f"K2 fixed_key_blocks ({name}): {rk.shape[0]} reports x "
              f"{seeds.shape[1]} seeds x {blocks} blocks, max_abs_err "
              f"{errs[name]}")
    kp = aes.bitslice_keys(extend[0]).contiguous()
    planes = torch.randint(-2 ** 31, 2 ** 31, (8, 16, 2, 2, R // 32),
                           dtype=torch.int32, device=dev, generator=gen)
    errs["planes"] = _max_err([aes.aes128_encrypt_bitsliced(kp, planes)],
                              [aes.aes128_encrypt_bitsliced_plain(kp, planes)])
    errs["parent"] = _max_err([parent_path(*extend)],
                              [fixed_key_blocks_plain(*extend)])
    print(f"K2 planes entry: planes (8, 16, 2, 2, {R // 32}), max_abs_err "
          f"{errs['planes']}; the parent's path through it at the extend "
          f"shape, max_abs_err {errs['parent']}")

    ms = _time(lambda: fixed_key_blocks(*extend), 20)
    device_ms = _device_ms(lambda: fixed_key_blocks(*extend),
                           ("fixed_key_kernel",), 20)["fixed_key_kernel"]
    plain_ms = _time(lambda: fixed_key_blocks_plain(*extend), 2)
    parent_ms = _time(lambda: parent_path(*extend), 20)
    planes_ms = _time(lambda: aes.aes128_encrypt_bitsliced(kp, planes), 20)
    planes_plain = _time(
        lambda: aes.aes128_encrypt_bitsliced_plain(kp, planes), 1)
    wide_ms = _time(lambda: fixed_key_blocks(*wide), 20)
    wide_device = _device_ms(lambda: fixed_key_blocks(*wide),
                             ("fixed_key_kernel",), 20)["fixed_key_kernel"]
    (b, by) = bound(R, 2, 2)
    (wide_b, wide_by) = bound(R, 64, 2)
    threads = 4 * (R // 32) * 2 * 2
    print(f"K2 fixed_key_blocks at {R} reports x 2 seeds x 2 blocks "
          f"({threads // 64} blocks of 64 threads): whole call {ms:.4f} ms, "
          f"kernel {device_ms:.4f} ms (bound {b:.6f} ms by {by}); the "
          f"parent's path (bit packing + planes entry + unpacking) "
          f"{parent_ms:.4f} ms; plain {plain_ms:.3f} ms")
    print(f"K2 fixed_key_blocks at {R} reports x 64 seeds x 2 blocks: whole "
          f"call {wide_ms:.4f} ms, kernel {wide_device:.4f} ms (bound "
          f"{wide_b:.4f} ms by {wide_by}); planes entry at (8, 16, 2, 2, "
          f"{R // 32}) {planes_ms:.4f} ms (plain {planes_plain:.3f} ms; the "
          f"extend shape's {R * 2 * 2} blocks: bound {b:.6f} ms by {by}; "
          f"launched by no program path)")
    return {"name": "aes_fixed_key_blocks", "route": "cuda",
            "source": "mastic_tpu_torch/csrc/aes.cu",
            "replaces": "mastic_tpu/ops/aes_pallas.py:149",
            "max_abs_err": max(errs.values()), "kernel_ms": ms,
            "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": None,
            "shape": f"fixed_key_blocks, {R} reports x 2 seeds x 2 blocks "
                     f"(the shard's extend; also checked at its convert, at "
                     f"{R - 3} reports x 3 blocks and at 64 seeds); the "
                     f"parent's path for this call {parent_ms:.4f} ms; {R} "
                     f"reports x 64 seeds x 2 blocks: whole call "
                     f"{wide_ms:.4f} ms, kernel {wide_device:.4f} ms, bound "
                     f"{wide_b:.4f} ms; planes entry at (8, 16, 2, 2, "
                     f"{R // 32}): {planes_ms:.4f} ms"}


def _binder_indices(gen_np: np.random.Generator, dev: torch.device,
                    bits: int, width: int = 64,
                    planted: int = PLANTED) -> tuple:
    """onehot / payload row lists of a level-(bits-1) round at `width`
    with up to `planted` parents per depth, as RoundPlan lays them out:
    per depth the nodes sit at creation-order positions (here a random
    permutation), onehot lists both children of every depth-(d-1)
    ancestor, payload every ancestor with its two children."""
    pos = [gen_np.permutation(width) for _ in range(bits)]
    anc = [min(2 ** (d + 1), planted) for d in range(bits)]
    onehot = [d * width + pos[d][i] for d in range(bits)
              for i in range(2 if d == 0 else 2 * anc[d - 1])]
    (par, left, right) = ([], [], [])
    for d in range(bits - 1):
        for i in range(anc[d]):
            par.append(d * width + pos[d][i])
            left.append((d + 1) * width + pos[d + 1][2 * i])
            right.append((d + 1) * width + pos[d + 1][2 * i + 1])
    return tuple(torch.as_tensor(np.array(x, np.int64), device=dev)
                 for x in (onehot, par, left, right))


def binder_inputs(dev: torch.device, gen: torch.Generator, bits: int,
                  ctx: bytes, spec=None, width: int = 64,
                  value_len: int = 2, planted: int = PLANTED,
                  alg_id: int = 0xFFFF0001) -> tuple:
    """The arguments of `binder_checks` for two aggregators' distinct
    random carries at depth `bits` (Field64 by default, VALUE_LEN 2: the
    Count path's), each with values >= p from a different first element
    (`field_values`), with RoundPlan-shaped index lists."""
    from mastic_tpu_torch.backend.xof import ts_prefix
    from mastic_tpu_torch.scalar.dst import (USAGE_ONEHOT_CHECK,
                                             USAGE_PAYLOAD_CHECK, dst_alg)
    from mastic_tpu_torch.ops.field import FIELD64

    spec = spec or FIELD64
    (ws, proofs) = ([], [])
    for first in (0, 41):
        w = field_values(spec, (R, bits, width, value_len), dev, gen)
        ws.append(torch.roll(w.view(-1, spec.num_limbs), first, 0).view(
            w.shape))
        proofs.append(torch.randint(0, 256, (R, bits, width, 32),
                                    dtype=torch.uint8, device=dev,
                                    generator=gen))
    idx = _binder_indices(np.random.default_rng(int(torch.randint(
        0, 2 ** 31, (1,), generator=gen, device=dev))), dev, bits, width,
        planted)
    pre = tuple(ts_prefix(dst_alg(ctx, usage, alg_id), 0)
                for usage in (USAGE_ONEHOT_CHECK, USAGE_PAYLOAD_CHECK))
    return (spec, tuple(ws), tuple(proofs), *idx, *pre)


def _binder_compare(dev: torch.device, gen: torch.Generator, bits: int,
                    ctx: bytes, **shape) -> tuple:
    """The binder sponge against its plain version on two aggregators'
    distinct carries at depth `bits`: (max_abs_err, plain ms, the
    inputs of the launch).  Fails unless the two aggregators' outputs
    differ at every report, so a kernel that read one aggregator's rows
    for the other's could not agree."""
    from mastic_tpu_torch.ops import binder

    args = binder_inputs(dev, gen, bits, ctx, **shape)
    pre = args[-2:]
    got = binder.binder_checks(*args)
    t0 = time.perf_counter()
    want = binder.binder_checks_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = _max_err(got, want)
    for (check, out) in zip(("onehot", "payload"), got):
        if not (out[0] != out[1]).any(dim=-1).all():
            raise AssertionError(f"K1 binder sponge: the two aggregators' "
                                 f"{check} checks agree at some report")
    field = "Field128" if args[0].num_limbs == 8 else "Field64"
    print(f"K1 binder sponge, {field}, depth {bits}, prefix {len(pre[0])} B "
          f"({len(pre[0]) % 8} past a lane), 2 aggregators' distinct carries "
          f"(values >= p in both): max_abs_err {err}")
    return (err, plain_ms, args)


def _binder_cost(args: tuple, elem_ops: int) -> tuple:
    """Time one launch of the binder sponge (both checks of both
    aggregators) and bound it: (ms, bound ms, bound by, the shape)."""
    from mastic_tpu_torch.ops import binder

    ms = _time(lambda: binder.binder_checks(*args), 3)
    (spec, ws, _proofs, *idx, prefix_onehot, _prefix_payload) = args
    (onehot_rows, payload_rows) = (idx[0].numel(), idx[1].numel())
    (reports, aggs) = (ws[0].shape[0], len(ws))
    value_len = ws[0].shape[3]
    row_bytes = value_len * spec.encoded_size
    plen = len(prefix_onehot)
    blocks = ((plen + 32 * onehot_rows) // 168 + 1
              + (plen + row_bytes * payload_rows) // 168 + 1)
    # Each input read once: the onehot proof rows and the distinct w rows
    # (int32 limbs) the payload check names, per aggregator and report,
    # and the index lists.
    payload_nodes = torch.unique(torch.cat(idx[1:])).numel()
    w_row = value_len * spec.num_limbs * 4
    in_bytes = aggs * reports * (32.0 * onehot_rows + w_row * payload_nodes) \
        + 8.0 * (onehot_rows + 3 * payload_rows)
    out_bytes = 2 * aggs * reports * 32.0
    ops = aggs * reports * (blocks * (KECCAK_PERM_OPS + KECCAK_ABSORB_OPS)
                            + value_len * payload_rows * elem_ops)
    (bound, by) = _bound(in_bytes + out_bytes, float(ops))
    shape = (f"binder sponge, {aggs} aggregator{'s' if aggs > 1 else ''} x "
             f"{reports} reports x (prefix {plen} B + onehot {onehot_rows} x "
             f"32 B, + payload {payload_rows} x {row_bytes} B)")
    return (ms, bound, by, shape)


def _binder_row(name: str, args: tuple, err: int, plain_ms: float,
                elem_ops: int) -> dict:
    """The kernels-line row of one binder sponge check."""
    (ms, bound, by, shape) = _binder_cost(args, elem_ops)
    print(f"{name}: {shape}, {ms:.4f} ms (plain {plain_ms:.1f} ms; bound "
          f"{bound:.4f} ms by {by}), max_abs_err {err}")
    return {"name": name, "route": "cuda",
            "source": "mastic_tpu_torch/csrc/keccak.cu",
            "replaces": "mastic_tpu/ops/keccak_pallas.py:72",
            "max_abs_err": err, "kernel_ms": ms, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None, "shape": shape}


def _sponge_cost(batch: int, plen: int, length: int, out_len: int) -> tuple:
    """Rate blocks absorbed, permutations, and the bound of TurboSHAKE128
    over `batch` messages of plen + length bytes squeezed to out_len:
    (blocks, permutations, bound ms, bound by).  Each message byte is
    read once and each output byte written once; every absorbed block
    costs a permutation and its XOR, every further 168 output bytes a
    permutation."""
    blocks = (plen + length) // 168 + 1
    perms = blocks + max(0, -(-out_len // 168) - 1)
    ops = batch * (blocks * KECCAK_ABSORB_OPS + perms * KECCAK_PERM_OPS)
    (bound, by) = _bound(batch * float(length + out_len), float(ops))
    return (blocks, perms, bound, by)


def k1_sponge_cases(dev: torch.device, gen: torch.Generator) -> list:
    """K1's in-place sponge (`turbo_shake128_dynamic`): the shapes the
    program paths launch (timed) and the edges of its layout (checked
    only).  Each case: (name, timed, msg, length, domain, out_len,
    prefix)."""
    from mastic_tpu_torch.backend.mastic import MasticCount
    from mastic_tpu_torch.backend.vidpf import KEY_SIZE
    from mastic_tpu_torch.backend.xof import ts_prefix
    from mastic_tpu_torch.scalar.common import to_le_bytes
    from mastic_tpu_torch.scalar.dst import (USAGE_EXTEND, USAGE_NODE_PROOF,
                                             USAGE_ONEHOT_CHECK, dst,
                                             dst_alg)

    def rand_u8(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                             generator=gen)

    def const(data: bytes, shape: tuple) -> torch.Tensor:
        row = torch.tensor(list(data), dtype=torch.uint8, device=dev)
        return row.expand(shape + (len(data),))

    cases = []
    # The shard's node proof at level 255 of MasticCount(256), built as
    # BatchedVidpf._node_proof_dynamic builds it: 2 x R rows of prefix |
    # seed | le16(BITS) | le16(255) | packed path, hashed over their
    # first len(prefix) + 52 bytes.
    prefix = ts_prefix(dst(CTX, USAGE_NODE_PROOF), KEY_SIZE)
    path = rand_u8(R, 1, BITS // 8).expand(R, 2, BITS // 8)
    msg = torch.cat([const(prefix, (R, 2)), rand_u8(R, 2, KEY_SIZE),
                     const(to_le_bytes(BITS, 2) + to_le_bytes(BITS - 1, 2),
                           (R, 2)), path], dim=-1)
    cases.append(("node proof, level 255 of MasticCount(256)", True, msg,
                  len(prefix) + KEY_SIZE + 4 + (BITS - 1) // 8 + 1, 1, 32,
                  b""))
    # fixed_key_schedule's key: le16(len(dst)) | dst | nonce, domain 2.
    ext = dst(CTX, USAGE_EXTEND)
    msg = torch.cat([const(to_le_bytes(len(ext), 2) + ext, (R,)),
                     rand_u8(R, 16)], dim=-1)
    cases.append(("fixed_key_schedule (extend)", True, msg, msg.shape[-1],
                  2, 16, b""))
    # The longest message a path sends: MasticSumVec(128, 1024, 1, 32)'s
    # joint-rand part (prefix | seed | nonce | 1024 Field128 weight
    # shares), and its longest squeeze: the helper proof share's 191
    # Field128 elements from a 64-byte message.
    cases.append(("SumVec joint_rand_part (longest message)", True,
                  rand_u8(R, 16464), 16464, 1, 32, b""))
    cases.append(("SumVec helper_proof_share (longest squeeze)", True,
                  rand_u8(R, 64), 64, 1, 3056, b""))
    # The earlier synthetic shape: 25 rate blocks behind the onehot
    # check's prefix.
    onehot = ts_prefix(dst_alg(CTX, USAGE_ONEHOT_CHECK, MasticCount.ID), 0)
    cases.append(("4096 B behind a 32-byte prefix", True, rand_u8(R, 4096),
                  4096, 1, 32, onehot))
    # Edges: lengths at the block ends behind a 13-byte prefix, and 37
    # rows (not a multiple of a block's messages); a prefix that spans a
    # rate block; a view at an odd byte offset with an odd stride; two
    # squeezes; outputs of lengths that are not a multiple of 4; one
    # message; 4097 messages; a batch of two dimensions.
    pre13 = bytes(rand_u8(13).tolist())
    pre170 = bytes(rand_u8(170).tolist())
    rows = rand_u8(37, 400)
    for length in (0, 154, 155, 156, 167, 168, 169, 400):
        cases.append((f"prefix 13 B, length {length}", False, rows, length,
                      1, 32, pre13))
    for length in (0, 3, 400):
        cases.append((f"prefix 170 B, length {length}", False, rows[:33],
                      length, 1, 32, pre170))
    odd = rand_u8(1 + 45 * 333)[1:].view(45, 333)
    cases.append(("odd byte offset, stride 333", False, odd, 333, 1, 200,
                  pre13[:5]))
    cases.append(("odd byte offset, length 200", False, odd, 200, 7, 32,
                  b""))
    cases.append(("out_len 200", False, rand_u8(64, 1000), 1000, 1, 200,
                  b""))
    for out_len in (1, 33, 170):   # not a multiple of 4: byte stores
        cases.append((f"out_len {out_len}", False, rows, 200, 1, out_len,
                      pre13))
    cases.append(("batch 1", False, rand_u8(1, 300), 300, 1, 32, pre13))
    cases.append(("batch 4097", False, rand_u8(4097, 100), 100, 1, 32,
                  b""))
    cases.append(("batch (3, 5)", False, rand_u8(3, 5, 200), 181, 3, 64,
                  pre13))
    return cases


def check_k1_entries(dev: torch.device, gen: torch.Generator) -> dict:
    """K1's in-place sponge and bare permutation, bit-exact against
    their plain versions at every shape of `k1_sponge_cases` and at
    1, 4097 and 1 048 576 states (12 and 24 rounds); the timed shapes
    by CUDA events (whole call) and the profiler (device time).  The
    row is the sponge's, headed by the 25-block shape, with every timed
    shape under "shapes" and the permutation under "permutation"."""
    from mastic_tpu_torch.ops import keccak

    shapes = []
    err_all = 0
    for (name, timed, msg, length, domain, out_len, prefix) in \
            k1_sponge_cases(dev, gen):
        def call(msg=msg, length=length, domain=domain, out_len=out_len,
                 prefix=prefix):
            return keccak.turbo_shake128_dynamic(msg, length, domain, out_len,
                                                 prefix=prefix)

        def plain(msg=msg, length=length, domain=domain, out_len=out_len,
                  prefix=prefix):
            return keccak.turbo_shake128_dynamic_plain(
                msg, length, domain, out_len, prefix=prefix)

        err = _max_err([call()], [plain()])
        err_all = max(err_all, err)
        batch = msg.numel() // msg.shape[-1]
        (blocks, perms, bound, by) = _sponge_cost(batch, len(prefix), length,
                                                  out_len)
        desc = (f"{name}: {batch} messages x ({len(prefix)} + {length}) B, "
                f"{blocks} rate blocks, {out_len} B out")
        if not timed:
            print(f"K1 sponge, {desc}: max_abs_err {err}")
        else:
            ms = _time(call, 20)
            kernel_ms = _device_ms(call, ("turboshake",), 20)["turboshake"]
            plain_ms = _time(plain, 1)
            print(f"K1 sponge, {desc}: whole call {ms:.4f} ms, kernel "
                  f"{kernel_ms:.4f} ms (plain {plain_ms:.3f} ms, bound "
                  f"{bound:.4f} ms by {by}: {batch * perms} permutations, "
                  f"{bound / kernel_ms:.1%} of it), max_abs_err {err}")
            shapes.append({"shape": desc, "ms": ms, "kernel_ms": kernel_ms,
                           "plain_ms": plain_ms, "bound_ms": bound,
                           "bound_by": by, "max_abs_err": err})
        if err:
            raise AssertionError(f"K1's sponge disagrees with its plain "
                                 f"version at {desc}")
    row = dict(shapes[-1])
    row.update({"name": "keccak_turboshake", "route": "cuda",
                "source": "mastic_tpu_torch/csrc/keccak.cu",
                "replaces": "mastic_tpu/ops/keccak_pallas.py:72",
                "max_abs_err": err_all, "library_ms": None,
                "shapes": shapes})

    perm = []
    for (states, rounds) in ((1, 12), (4097, 12), (4097, 24),
                             (R * 256, 24), (R * 256, 12)):
        lo = torch.randint(-2 ** 31, 2 ** 31, (states, 25), dtype=torch.int32,
                           device=dev, generator=gen)
        hi = torch.randint(-2 ** 31, 2 ** 31, (states, 25), dtype=torch.int32,
                           device=dev, generator=gen)
        err = _max_err(keccak.keccak_p1600(lo, hi, rounds),
                       keccak.keccak_p1600_plain(lo, hi, rounds))
        desc = f"{states} states, {rounds} rounds"
        if err:
            raise AssertionError(f"K1's permutation disagrees with its plain "
                                 f"version at {desc}")
        if states < R * 256:
            print(f"K1 permutation, {desc}: max_abs_err {err}")
            continue
        ms = _time(lambda: keccak.keccak_p1600(lo, hi, rounds), 5)
        kernel_ms = _device_ms(lambda: keccak.keccak_p1600(lo, hi, rounds),
                               ("keccak_permute",), 5)["keccak_permute"]
        plain_ms = _time(lambda: keccak.keccak_p1600_plain(lo, hi, rounds), 1)
        (bound, by) = _bound(states * 400.0,
                             states * KECCAK_PERM_OPS * rounds / 12)
        print(f"K1 permutation, {desc}: whole call {ms:.4f} ms, kernel "
              f"{kernel_ms:.4f} ms (plain {plain_ms:.3f} ms, bound "
              f"{bound:.4f} ms by {by}, {bound / kernel_ms:.1%} of it), "
              f"max_abs_err {err}")
        perm.append({"name": "keccak_permute", "route": "cuda",
                     "source": "mastic_tpu_torch/csrc/keccak.cu",
                     "replaces": "mastic_tpu/ops/keccak_pallas.py:72",
                     "shape": desc, "ms": ms, "kernel_ms": kernel_ms,
                     "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                     "library_ms": None, "max_abs_err": err})
        del lo, hi
    row["permutation"] = perm[-1]
    row["permutation_24_rounds"] = perm[0]
    return row


def check_binder_sponge(dev: torch.device, gen: torch.Generator) -> dict:
    """K1's gathered binder sponge against its plain version at a
    level-255 carry (prefix 32 B) and at depth 64 with a 20-byte ctx
    (prefix 35 B: every message word straddles two rate lanes); times
    the first in the main path's form (both checks of both aggregators,
    one launch)."""
    (err_odd, _ms, _args) = _binder_compare(dev, gen, 64, bytes(range(20)))
    del _args
    (err, plain_ms, args) = _binder_compare(dev, gen, BITS, CTX)
    row = _binder_row("keccak_binder_sponge", args, max(err, err_odd),
                      plain_ms, PAYLOAD_ELEM_OPS)
    row["shape"] += "; also checked at depth 64 with a 35-byte prefix"
    return row


def measurements(seed: int, bits: int = BITS, reports: int = R) -> tuple:
    """32 planted `bits`-bit strings x reports/64 reports each plus
    reports/2 uniform strings (weights 0 or 1), shuffled: (alphas
    (reports, bits) bool, weights (reports,), planted).  At R reports:
    32 x 64 and 2048."""
    rng = np.random.default_rng(seed)
    per_planted = PER_PLANTED * reports // R
    planted = rng.integers(0, 2, (PLANTED, bits)).astype(bool)
    uniform = rng.integers(0, 2, (reports - PLANTED * per_planted, bits))
    uniform = uniform.astype(bool)
    alphas = np.concatenate([np.repeat(planted, per_planted, axis=0),
                             uniform])
    weights = np.concatenate([np.ones(PLANTED * per_planted, np.int64),
                              rng.integers(0, 2, len(uniform))])
    order = rng.permutation(reports)
    return (alphas[order], weights[order], planted)


def plaintext_counts(alphas: np.ndarray, weights: np.ndarray,
                     valid: np.ndarray, prefixes: list) -> list:
    """Weighted count of each candidate prefix over the valid reports."""
    level = len(prefixes[0])
    keys = {}
    packed = np.packbits(alphas[:, :level], axis=1)
    for r in np.flatnonzero(valid):
        key = packed[r].tobytes()
        keys[key] = keys.get(key, 0) + int(weights[r])
    return [keys.get(np.packbits(np.array(p, bool)).tobytes(), 0)
            for p in prefixes]


def main_path(dev: torch.device, seed: int, levels: int) -> dict:
    from mastic_tpu_torch.backend.mastic import BatchedMastic, MasticCount
    from mastic_tpu_torch.drivers.heavy_hitters import HeavyHittersRun
    from mastic_tpu_torch.ops import kernels

    (alphas, weights, planted) = measurements(seed)
    mastic = MasticCount(BITS)
    bm = BatchedMastic(mastic)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    nonces = torch.randint(0, 256, (R, 16), dtype=torch.uint8, device=dev,
                           generator=gen)
    rand = torch.randint(0, 256, (R, mastic.RAND_SIZE), dtype=torch.uint8,
                         device=dev, generator=gen)
    vk = bytes(torch.randint(0, 256, (32,), dtype=torch.uint8, device=dev,
                             generator=gen).cpu().tolist())
    meas = [(tuple(bool(b) for b in alphas[r]), int(weights[r]))
            for r in range(R)]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (a_dev, b_dev) = bm.encode_measurements(meas, dev)
    (batch, shard_ok) = bm.shard_device(CTX, a_dev, b_dev, nonces, rand)
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    shard_launches = dict(kernels.launches)

    reports = ScalarReports(mastic, meas, nonces, rand)
    run = HeavyHittersRun(mastic, CTX, {"default": THRESHOLD}, vk, batch,
                          valid=shard_ok, device=dev, reports=reports)
    excluded_per_level = []
    widths = []
    max_frontier = 0
    t0 = time.perf_counter()
    while run.level < levels:
        max_frontier = max(max_frontier, len(run.prefixes))
        more = run.step()
        excluded_per_level.append(run.excluded())
        widths.append(run.runner.width)
        if not more:
            break
    torch.cuda.synchronize()
    rounds_s = time.perf_counter() - t0

    # Every level's aggregates against the plaintext count.
    for ((prefixes, counts), excluded) in zip(run.level_results,
                                               excluded_per_level):
        want = plaintext_counts(alphas, weights, ~excluded, prefixes)
        if counts != want:
            raise AssertionError(
                f"level {len(prefixes[0]) - 1}: aggregates differ from the "
                f"plaintext count")
    done = len(run.level_results)
    valid = ~excluded_per_level[-1]
    expect = sorted({tuple(bool(b) for b in p[:done]) for p in planted})
    if done == BITS:
        got = sorted(run.result())
    else:
        got = sorted({p[:-1] for p in run.prefixes})
    missing = [p for p in expect if p not in got]
    # Shallow cuts keep uniform prefixes above the threshold too; the
    # full depth keeps the planted strings only.
    if missing or (done == BITS and len(got) != len(expect)):
        raise AssertionError(f"heavy hitters: {len(got)} found, "
                             f"{len(expect)} planted, {len(missing)} missing")
    # Node evals, both aggregators: children of live parents, and every
    # child the padded level step computes (width W per report).
    live = sum(2 * R * 2 * len({p[:-1] for p in prefixes})
               for (prefixes, _c) in run.level_results)
    padded = 2 * R * sum(widths)
    # What the from-root cross-check reads: the last level's prefixes and
    # aggregates, and the reports the incremental runner left out.
    handoff = (bm, vk, batch, excluded_per_level[-1], run.level_results[-1],
               reports)
    # What phase l uploads: the lanes' wire rows, on the host.
    service = {"mastic": mastic, "vk": vk, "rows": [
        wire_rows(bm, batch, a) for a in range(2)],
        "valid": shard_ok.cpu().numpy(), "reports": reports,
        "level_results": run.level_results, "planted": planted,
        "shard_launches": shard_launches}
    return {"handoff": handoff, "service": service, "levels": done,
            "shard_s": shard_s,
            "first_levels": run.level_results[:MESH_NCCL_LEVELS],
            "rounds_s": rounds_s,
            "rejected": int((~valid).sum()),
            "xof_fallbacks": run.metrics[-1].xof_fallbacks,
            "shard_rejected": int((~shard_ok).sum()),
            "live_evals": live, "padded_evals": padded,
            "max_frontier": max_frontier,
            "max_width": run.runner.max_width,
            "heavy_hitters": len(got), "shard_launches": shard_launches}


def count_from_root(dev: torch.device, handoff: tuple) -> dict:
    """The Count path's last level again, as one round from the root
    (`run_round`: the whole grid of that level's prefixes for both
    aggregators, no weight check) over the reports the incremental
    runner kept: its aggregates must equal the incremental runner's."""
    from mastic_tpu_torch.drivers.heavy_hitters import run_round

    (bm, vk, batch, excluded, (prefixes, counts), reports) = handoff
    level = len(prefixes[0]) - 1
    metrics = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = run_round(bm, vk, CTX, (level, tuple(prefixes), False), batch,
                    valid=torch.as_tensor(~excluded, device=dev),
                    metrics_out=metrics, reports=reports)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    if got != counts:
        raise AssertionError(f"from the root at level {level}: aggregates "
                             f"differ from the incremental runner's")
    return {"level": level, "prefixes": len(prefixes), "round_s": round_s,
            "nodes": metrics[0].padded_width,
            "accepted": metrics[0].accepted}


def sum_measurements(seed: int) -> tuple:
    """The Count path's report strings with 8-bit weights: uniform in
    [0, SUM_MAX] from their own generator.  (alphas, weights, planted)."""
    (alphas, _weights, planted) = measurements(seed)
    weights = np.random.default_rng(seed + 2).integers(0, SUM_MAX + 1, R)
    return (alphas, weights, planted)


def survivors(alphas: np.ndarray, weights: np.ndarray, valid: np.ndarray,
              level: int, threshold: int) -> list:
    """Every (level + 1)-bit prefix whose weighted count over the valid
    reports reaches the threshold, sorted: the numpy weighted heavy
    hitters of that level."""
    packed = np.packbits(alphas[valid, :level + 1], axis=1)
    (keys, inverse) = np.unique(packed, axis=0, return_inverse=True)
    sums = np.bincount(inverse.ravel(), weights=weights[valid],
                       minlength=len(keys))
    bits = np.unpackbits(keys[sums >= threshold], axis=1)[:, :level + 1]
    return sorted(tuple(bool(b) for b in row) for row in bits)


def _path_inputs(dev: torch.device, seed: int, rand_size: int,
                 reports: int = R) -> tuple:
    """Nonces, client randomness and the verify key of a path, drawn on
    the card from `seed`."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    nonces = torch.randint(0, 256, (reports, 16), dtype=torch.uint8,
                           device=dev, generator=gen)
    rand = torch.randint(0, 256, (reports, rand_size), dtype=torch.uint8,
                         device=dev, generator=gen)
    vk = bytes(torch.randint(0, 256, (32,), dtype=torch.uint8, device=dev,
                             generator=gen).cpu().tolist())
    return (nonces, rand, vk)


def _shard(dev: torch.device, bm, meas: list, nonces: torch.Tensor,
           rand: torch.Tensor, mesh=None) -> tuple:
    """encode_measurements + shard_device, synchronised: (batch, ok,
    seconds).  With a mesh each rank shards only its rows, then every
    rank gathers the whole batch (the drivers' argument) onto its
    card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if mesh is None:
        (a_dev, b_dev) = bm.encode_measurements(meas, dev)
        (batch, ok) = bm.shard_device(CTX, a_dev, b_dev, nonces, rand)
    else:
        from mastic_tpu_torch.parallel.mesh import gather_rows, tree_map

        (lo, hi) = mesh.bounds(len(meas))
        (batch, ok, _s) = _shard(dev, bm, meas[lo:hi], nonces[lo:hi],
                                 rand[lo:hi])
        (batch, ok) = tree_map(lambda t: gather_rows(mesh, t).to(dev),
                               (batch, ok))
    torch.cuda.synchronize()
    return (batch, ok, time.perf_counter() - t0)


class ScalarReports:
    """The scalar reports behind a path's batch, each built on first
    access: lane r's scalar shard (`Mastic.scalar().shard`) of the same
    measurement, nonce and rand, then `tamper(r, report)` where the path
    tampers with its batch.  The drivers read a lane only where its XOF
    sampling fired, so a run where none fires builds none."""

    def __init__(self, mastic, meas: list, nonces: torch.Tensor,
                 rand: torch.Tensor, tamper=None):
        self.scalar = mastic.scalar()
        self.meas = meas
        self.nonces = nonces.cpu().numpy()
        self.rand = rand.cpu().numpy()
        self.tamper = tamper
        self.built: dict = {}

    def __len__(self) -> int:
        return len(self.meas)

    def __getitem__(self, r: int):
        if r not in self.built:
            nonce = self.nonces[r].tobytes()
            report = (nonce,) + self.scalar.shard(
                CTX, self.meas[r], nonce, self.rand[r].tobytes())
            if self.tamper is not None:
                report = self.tamper(r, report)
            self.built[r] = report
        return self.built[r]


def _marshal_matches(dev: torch.device, bm, batch, reports, lanes) -> None:
    """`marshal_reports` of each lane's scalar report equals that lane's
    row of the device batch."""
    from mastic_tpu_torch import convert

    rows = convert.report_batch_to_arrays(batch)
    for r in lanes:
        got = convert.report_batch_to_arrays(
            bm.marshal_reports([reports[r]], dev))
        for (key, arr) in got.items():
            if not np.array_equal(arr[0], rows[key][r]):
                raise AssertionError(f"lane {r}: the scalar report's {key} "
                                     f"differs from the device batch's")


def sum_path(dev: torch.device, seed: int) -> dict:
    """Weighted heavy hitters: MasticSum(256, 255) through
    HeavyHittersRun for SUM_LEVELS levels, one step a level
    (compute_heavy_hitters' loop); every level's weighted counts and
    survivors against numpy, and at full depth the heavy hitters
    against the planted strings."""
    from mastic_tpu_torch.backend.mastic import BatchedMastic, MasticSum
    from mastic_tpu_torch.drivers.heavy_hitters import HeavyHittersRun
    from mastic_tpu_torch.ops import kernels

    (alphas, weights, planted) = sum_measurements(seed)
    mastic = MasticSum(BITS, SUM_MAX)
    bm = BatchedMastic(mastic)
    (nonces, rand, vk) = _path_inputs(dev, seed + 3, mastic.RAND_SIZE)
    meas = [(tuple(bool(b) for b in alphas[r]), int(weights[r]))
            for r in range(R)]
    (batch, shard_ok, shard_s) = _shard(dev, bm, meas, nonces, rand)
    shard_launches = dict(kernels.launches)

    run = HeavyHittersRun(mastic, CTX, {"default": SUM_THRESHOLD}, vk, batch,
                          valid=shard_ok, device=dev,
                          reports=ScalarReports(mastic, meas, nonces, rand))
    excluded = []
    t0 = time.perf_counter()
    more = True
    while more and run.level < SUM_LEVELS:
        more = run.step()
        excluded.append(run.excluded())
    torch.cuda.synchronize()
    rounds_s = time.perf_counter() - t0
    hh = run.result()
    levels = [(prefixes, counts, ex) for ((prefixes, counts), ex)
              in zip(run.level_results, excluded)]
    for (level, (prefixes, counts, ex)) in enumerate(levels):
        valid = ~ex
        if counts != plaintext_counts(alphas, weights, valid, prefixes):
            raise AssertionError(f"MasticSum level {level}: weighted counts "
                                 f"differ from numpy")
        got = sorted(p for (p, c) in zip(prefixes, counts)
                     if c >= SUM_THRESHOLD)
        if got != survivors(alphas, weights, valid, level, SUM_THRESHOLD):
            raise AssertionError(f"MasticSum level {level}: survivors differ "
                                 f"from numpy's weighted heavy hitters")
    expect = sorted(tuple(bool(b) for b in p) for p in planted)
    if len(levels) != SUM_LEVELS or (SUM_LEVELS == BITS
                                     and sorted(hh) != expect):
        raise AssertionError(f"MasticSum: {len(levels)} levels, "
                             f"{len(hh)} heavy hitters found, "
                             f"{len(expect)} planted")
    planted_weight = min(
        int(weights[(alphas == p).all(axis=1)].sum()) for p in planted)
    live = sum(2 * R * 2 * len({p[:-1] for p in prefixes})
               for (prefixes, _c, _e) in levels)
    return {"levels": len(levels), "shard_s": shard_s, "rounds_s": rounds_s,
            "rejected": int(levels[-1][2].sum()),
            "xof_fallbacks": run.metrics[-1].xof_fallbacks,
            "shard_rejected": int((~shard_ok).sum()), "live_evals": live,
            "max_frontier": max(len(p) for (p, _c, _e) in levels),
            "heavy_hitters": len(hh),
            "planted_weight": planted_weight,
            "shard_launches": shard_launches}


def histogram_inputs(dev: torch.device, seed: int) -> tuple:
    """The Field128 path's reports: 16 planted 64-bit attribute
    strings, each report one of them with a uniform bucket, sharded on
    the card.  (attrs, alphas, buckets, mastic, bm, vk, meas, nonces,
    rand, batch, shard_ok, shard_s)."""
    from mastic_tpu_torch.backend.mastic import (BatchedMastic,
                                                 MasticHistogram)

    (bits, length, _chunk) = HIST
    rng = np.random.default_rng(seed + 4)
    attrs = rng.integers(0, 2, (HIST_ATTRS, bits)).astype(bool)
    alphas = attrs[rng.integers(0, HIST_ATTRS, R)]
    buckets = rng.integers(0, length, R)
    mastic = MasticHistogram(*HIST)
    bm = BatchedMastic(mastic)
    (nonces, rand, vk) = _path_inputs(dev, seed + 5, mastic.RAND_SIZE)
    meas = [(tuple(bool(b) for b in alphas[r]), int(buckets[r]))
            for r in range(R)]
    (batch, shard_ok, shard_s) = _shard(dev, bm, meas, nonces, rand)
    return (attrs, alphas, buckets, mastic, bm, vk, meas, nonces, rand,
            batch, shard_ok, shard_s)


def histogram_path(dev: torch.device, seed: int) -> dict:
    """The Field128 path: MasticHistogram(64, 16, 4) over 16 planted
    attribute strings, every level of the resident runner with the
    frontier = the attributes' ancestors and the weight check (joint
    rand confirmed) at level 0; every level's per-prefix 16-bucket
    aggregate against numpy."""
    from mastic_tpu_torch.drivers.heavy_hitters import IncrementalRunner
    from mastic_tpu_torch.ops import kernels

    (bits, length, _chunk) = HIST
    (attrs, alphas, buckets, mastic, bm, vk, meas, nonces, rand, batch,
     shard_ok, shard_s) = histogram_inputs(dev, seed)
    shard_launches = dict(kernels.launches)

    runner = IncrementalRunner(bm, vk, CTX, batch, valid=shard_ok,
                               reports=ScalarReports(mastic, meas, nonces,
                                                     rand))
    valid = shard_ok.cpu().numpy()
    metrics = []
    t0 = time.perf_counter()
    for level in range(bits):
        prefixes = sorted({tuple(bool(b) for b in a[:level + 1])
                           for a in attrs})
        handle = runner.round_stage((level, tuple(prefixes), level == 0))
        got = runner.round_collect(handle, metrics_out=metrics)
        want = [np.bincount(buckets[valid & (alphas[:, :level + 1]
                                             == np.array(p)).all(axis=1)],
                            minlength=length).tolist() for p in prefixes]
        if got != want:
            raise AssertionError(f"MasticHistogram level {level}: bucket "
                                 f"aggregates differ from numpy")
    torch.cuda.synchronize()
    rounds_s = time.perf_counter() - t0
    return {"levels": bits, "shard_s": shard_s, "rounds_s": rounds_s,
            "rejected": int((~valid).sum()),
            "xof_fallbacks": metrics[-1].xof_fallbacks,
            "shard_rejected": int((~shard_ok).sum()),
            "max_width": runner.max_width, "shard_launches": shard_launches}


def sumvec_path(dev: torch.device, seed: int) -> dict:
    """The long payload: MasticSumVec(128, 1024, 1, 32), R = 4096
    reports of which four in five take one of 4 hashed attributes,
    sharded (the joint-rand parts from both beta shares: K3 at depth 0
    with 1026 convert blocks), then both aggregators' weight check from
    their depth-0 payloads: every honest report must be accepted and
    the two beta shares must sum to the encoded measurement.  Then the
    batch's first SUMVEC_ROOT_R reports move to a pinned
    `HostReportStore` and the attribute-metrics round from the root runs
    over them in chunks of 512
    (`aggregate_by_attribute(chunk_size=512, store=...)`: per chunk 128
    depths of 1026-block level steps for each aggregator, K1 on Field128
    rows of 1025 elements): each attribute's 1024-entry vector must
    equal numpy's sum."""
    from mastic_tpu_torch import (HostReportStore, aggregate_by_attribute,
                                  hash_attribute)
    from mastic_tpu_torch.backend.mastic import BatchedMastic, MasticSumVec
    from mastic_tpu_torch.drivers.chunked import map_batch

    (bits, length, vbits, _chunk) = SUMVEC
    rng = np.random.default_rng(seed + 6)
    mastic = MasticSumVec(*SUMVEC)
    asked = [f"vector-{i}" for i in range(SUMVEC_ASKED)]
    paths = np.array([hash_attribute(mastic, a) for a in asked], bool)
    alphas = np.where((rng.random(R) < 0.8)[:, None],
                      paths[rng.integers(0, SUMVEC_ASKED, R)],
                      rng.integers(0, 2, (R, bits)).astype(bool))
    values = rng.integers(0, 2 ** vbits, (R, length))
    bm = BatchedMastic(mastic)
    (nonces, rand, vk) = _path_inputs(dev, seed + 7, mastic.RAND_SIZE)
    meas = [(tuple(bool(b) for b in alphas[r]), values[r].tolist())
            for r in range(R)]
    (batch, shard_ok, shard_s) = _shard(dev, bm, meas, nonces, rand)
    shard_peak = torch.cuda.max_memory_allocated(dev)

    t0 = time.perf_counter()
    root = bm.schedule((0, ((False,), (True,)), True), dev)
    trees = [bm.vidpf.eval_full(a, batch.cws, batch.keys[:, a], root, CTX,
                                batch.nonces) for a in range(2)]
    (checks, wc_ok) = bm.weight_check_device(vk, CTX, 0, batch, trees[0][0],
                                             trees[1][0])
    accept = checks["weight_check"] & checks["joint_rand"] & wc_ok \
        & trees[0][3] & trees[1][3] & shard_ok
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0
    if not bool(accept.all()):
        raise AssertionError(
            f"MasticSumVec: {int((~accept).sum())} honest reports refused "
            f"(weight_check {int((~checks['weight_check']).sum())}, "
            f"joint_rand {int((~checks['joint_rand']).sum())})")
    spec = bm.spec
    (w0, w1) = (trees[0][0], trees[1][0])
    beta = spec.add(spec.add(w0[:, 0], w0[:, 1]),
                    spec.neg(spec.add(w1[:, 0], w1[:, 1])))
    (_alphas, betas) = bm.encode_measurements(meas[:64], dev)
    if not torch.equal(beta[:64], betas):
        raise AssertionError("MasticSumVec: the beta shares do not sum to "
                             "the encoded measurements")
    cw_bytes = batch.cws.w.numel() * batch.cws.w.element_size()
    accepted = int(accept.sum())
    del trees, checks, wc_ok, accept, beta, w0, w1
    n = SUMVEC_ROOT_R
    shard_rejected = int((~shard_ok).sum())
    t0 = time.perf_counter()
    store = HostReportStore.from_batch(map_batch(batch, lambda t: t[:n]),
                                       SUMVEC_CHUNK)
    store_s = time.perf_counter() - t0
    del batch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)

    metrics = []
    t0 = time.perf_counter()
    got = aggregate_by_attribute(
        mastic, CTX, asked, vk, valid=shard_ok[:n], metrics_out=metrics,
        device=dev, chunk_size=SUMVEC_CHUNK, store=store,
        reports=ScalarReports(mastic, meas[:n], nonces[:n], rand[:n]))
    torch.cuda.synchronize()
    root_s = time.perf_counter() - t0
    (alphas, values) = (alphas[:n], values[:n])
    kept = shard_ok[:n].cpu().numpy()
    if metrics[0].extra["excluded_invalid"] != int((~kept).sum()) \
            or metrics[0].accepted != int(kept.sum()):
        raise AssertionError(f"MasticSumVec from the root: {metrics[0]}")
    want = [(a, values[(alphas == p).all(axis=1) & kept].sum(axis=0)
             .tolist()) for (a, p) in zip(asked, paths)]
    if got != want:
        raise AssertionError("MasticSumVec from the root: per-attribute "
                             "vectors differ from numpy's")
    pipe = metrics[0].extra["pipeline"]
    return {"shard_s": shard_s, "check_s": check_s,
            "shard_rejected": shard_rejected,
            "accepted": accepted, "cws_w_bytes": cw_bytes,
            "shard_peak": shard_peak, "root_s": root_s,
            "root_peak": torch.cuda.max_memory_allocated(dev),
            "root_nodes": metrics[0].padded_width,
            "root_accepted": metrics[0].accepted,
            "root_in_set": int(sum((alphas == p).all(axis=1).sum()
                                   for p in paths)),
            "store_s": store_s, "store_bytes": store.host_bytes(),
            "root_chunks": len(metrics[0].extra["chunks"]),
            "root_mode": (pipe["mode"], pipe["fallback"]),
            "root_overlap": pipe["overlap_efficiency"],
            "root_device_ms": [c.get("device_ms") for c in
                               metrics[0].extra["chunks"]]}


def attribute_measurements(seed: int) -> tuple:
    """The attribute path's reports: 64 attributes of interest, each
    report's attribute one of them (four in five) or one of 2^40 others,
    weights uniform in [0, 255].  (asked, names, weights)."""
    rng = np.random.default_rng(seed + 8)
    asked = [f"attribute-{i}" for i in range(ATTR_ASKED)]
    inside = rng.random(ATTR_R) < 0.8
    names = [asked[int(rng.integers(0, ATTR_ASKED))] if inside[r]
             else f"other-{int(rng.integers(0, 2 ** 40))}"
             for r in range(ATTR_R)]
    return (asked, names, rng.integers(0, SUM_MAX + 1, ATTR_R))


def attribute_sums(asked: list, path_of: dict, alphas: np.ndarray,
                   weights: np.ndarray, keep: np.ndarray) -> list:
    """numpy's weight sum of each attribute of interest over `keep`."""
    return [(a, int(weights[(alphas == path_of[a]).all(axis=1)
                            & keep].sum())) for a in asked]


def attribute_inputs(dev: torch.device, seed: int, mesh=None) -> dict:
    """The attribute path's reports: MasticSum(32, 255) over 10 000
    reports and 64 attributes of interest, sharded on the card (with a
    mesh, each rank its rows, then gathered), 100
    reports with a flipped correction-word byte at a random depth
    (among reports that take an attribute of interest, so the byte is on
    the evaluated grid) and 100 others with a changed leader proof limb,
    and the scalar reports behind the batch, tampered alike."""
    from mastic_tpu_torch import hash_attribute
    from mastic_tpu_torch.backend.mastic import BatchedMastic, MasticSum

    (asked, names, weights) = attribute_measurements(seed)
    mastic = MasticSum(ATTR_BITS, SUM_MAX)
    bm = BatchedMastic(mastic)
    path_of = {n: hash_attribute(mastic, n) for n in set(names) | set(asked)}
    alphas = np.array([path_of[n] for n in names], bool)
    (nonces, rand, vk) = _path_inputs(dev, seed + 9, mastic.RAND_SIZE, ATTR_R)
    meas = [(path_of[n], int(w)) for (n, w) in zip(names, weights)]
    (batch, shard_ok, shard_s) = _shard(dev, bm, meas, nonces, rand, mesh)

    rng = np.random.default_rng(seed + 10)
    asked_paths = np.array([path_of[a] for a in asked], bool)
    in_set = (alphas[:, None, :] == asked_paths[None]).all(-1).any(-1)
    cw_rows = np.sort(rng.choice(np.flatnonzero(in_set), ATTR_TAMPERED,
                                 replace=False))
    proof_rows = np.sort(rng.choice(np.setdiff1d(np.arange(ATTR_R), cw_rows),
                                    ATTR_TAMPERED, replace=False))

    def t(x):
        return torch.as_tensor(x, device=dev)

    cw_at = (rng.integers(0, ATTR_BITS, ATTR_TAMPERED),
             rng.integers(0, 16, ATTR_TAMPERED),
             rng.integers(1, 256, ATTR_TAMPERED).astype(np.uint8))
    batch.cws.seed[t(cw_rows), t(cw_at[0]), t(cw_at[1])] ^= t(cw_at[2])
    proof_at = rng.integers(0, mastic.valid.PROOF_LEN, ATTR_TAMPERED)
    batch.leader_proofs[t(proof_rows), t(proof_at), 0] ^= 1
    tamper_cw = {int(r): (int(d), int(i), int(x))
                 for (r, d, i, x) in zip(cw_rows, *cw_at)}
    tamper_proof = {int(r): int(j) for (r, j) in zip(proof_rows, proof_at)}

    def tamper(r: int, report: tuple) -> tuple:
        """The batch's tampering, on lane r's scalar report: the
        correction word's seed byte, or the leader proof share's
        element whose low limb lost or gained its bit 0."""
        (nonce, public_share, shares) = report
        if r in tamper_cw:
            (d, i, x) = tamper_cw[r]
            public_share = list(public_share)
            (seed, ctrl, w, proof) = public_share[d]
            seed = bytearray(seed)
            seed[i] ^= x
            public_share[d] = (bytes(seed), ctrl, w, proof)
        if r in tamper_proof:
            j = tamper_proof[r]
            (key, proof_share, seed, part) = shares[0]
            proof_share = list(proof_share)
            proof_share[j] = type(proof_share[j])(proof_share[j].int() ^ 1)
            shares = [(key, proof_share, seed, part), shares[1]]
        return (nonce, public_share, shares)

    tampered = np.zeros(ATTR_R, bool)
    tampered[cw_rows] = tampered[proof_rows] = True
    return {"mastic": mastic, "bm": bm, "asked": asked, "path_of": path_of,
            "alphas": alphas, "weights": weights, "vk": vk, "batch": batch,
            "shard_ok": shard_ok, "shard_s": shard_s, "in_set": in_set,
            "cw_rows": cw_rows, "proof_rows": proof_rows,
            "tampered": tampered,
            "reports": ScalarReports(mastic, meas, nonces, rand, tamper)}


def check_attribute_round(inputs: dict, run, accept: np.ndarray,
                          ok: np.ndarray) -> np.ndarray:
    """The attribute round's accept mask must reject exactly the
    tampered reports, RoundMetrics attribute them to the eval proof and
    the weight check, and each attribute's aggregate must equal numpy's
    weight sum over the rest.  Returns the lanes whose XOF sampling
    fired (recomputed by the splice)."""
    valid = inputs["shard_ok"].cpu().numpy()
    tampered = inputs["tampered"]
    m = run.metrics[0]
    if not np.array_equal(accept, valid & ~tampered):
        raise AssertionError("attribute metrics: the accept mask does not "
                             "reject exactly the tampered reports")
    # Lanes whose XOF sampling fired are recomputed by the splice: a
    # tampered one is rejected there (rejected_fallback, its check in
    # extra["rejected_fallback_by"]), the others by their check.
    fallback = ~ok & valid
    live = valid & ~fallback
    if (m.rejected_eval_proof, m.rejected_weight_check, m.rejected_joint_rand,
            m.rejected_fallback, m.accepted, m.xof_fallbacks) != (
            int(live[inputs["cw_rows"]].sum()),
            int(live[inputs["proof_rows"]].sum()), 0,
            int((fallback & tampered).sum()), int((valid & ~tampered).sum()),
            int(fallback.sum())):
        raise AssertionError(f"attribute metrics: rejections misattributed: "
                             f"{m}")
    want = attribute_sums(inputs["asked"], inputs["path_of"],
                          inputs["alphas"], inputs["weights"],
                          valid & ~tampered)
    if run.result() != want:
        raise AssertionError("attribute metrics: per-attribute sums differ "
                             "from numpy's")
    return fallback


def attributes_path(dev: torch.device, seed: int) -> dict:
    """Attribute metrics (`attribute_inputs`): the one weight-checked
    round from the root through `AttributeMetricsRun` (the run
    `aggregate_by_attribute` steps), its accept mask read from the
    round's handle, held to `check_attribute_round`."""
    from mastic_tpu_torch import AttributeMetricsRun
    from mastic_tpu_torch.ops import kernels

    inputs = attribute_inputs(dev, seed)
    inputs["shard_launches"] = dict(kernels.launches)
    (batch, shard_ok) = (inputs["batch"], inputs["shard_ok"])
    run = AttributeMetricsRun(inputs["mastic"], CTX, inputs["asked"],
                              inputs["vk"], batch, valid=shard_ok,
                              device=dev, reports=inputs["reports"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handle = run.step_begin()
    more = run.step_finish(handle)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    if more:
        raise AssertionError("attribute metrics: more than one round")
    fallback = check_attribute_round(inputs, run, handle["accept"],
                                     handle["out"][3].cpu().numpy())
    m = run.metrics[0]
    in_set = inputs["in_set"]
    tampered = inputs["tampered"]
    valid = shard_ok.cpu().numpy()
    service = {k: inputs[k] for k in (
        "mastic", "vk", "reports", "asked", "path_of", "alphas", "weights",
        "tampered", "cw_rows", "proof_rows", "shard_launches")}
    service.update(rows=[wire_rows(inputs["bm"], batch, a) for a in range(2)],
                   valid=valid)
    handoff = {"bm": inputs["bm"], "vk": inputs["vk"], "batch": batch,
               "shard_ok": shard_ok, "reports": inputs["reports"],
               "asked": inputs["asked"], "result": run.result(),
               "path_of": inputs["path_of"], "alphas": inputs["alphas"],
               "metrics": m, "fallback": fallback, "tampered_mask": tampered,
               "honest": int(np.flatnonzero(in_set & ~tampered & valid)[0]),
               "tampered": int(inputs["proof_rows"][0])}
    return {"handoff": handoff, "service": service,
            "shard_s": inputs["shard_s"],
            "round_s": round_s, "nodes": m.padded_width,
            "in_set": int(in_set.sum()), "accepted": m.accepted,
            "rejected_eval_proof": m.rejected_eval_proof,
            "rejected_weight_check": m.rejected_weight_check,
            "xof_fallbacks": m.xof_fallbacks,
            "shard_rejected": int((~shard_ok).sum()),
            "node_evals": m.node_evals,
            "accept": np.asarray(handle["accept"], bool)}


def attributes_splice(dev: torch.device, handoff: dict) -> dict:
    """A forced splice on the from-root engine at full size: the
    attribute round again over the same batch, asking SPLICE_ASKED of
    the attributes (the honest lane's among them), with two lanes' `ok`
    cleared after the prep (`BatchedMastic.prep_both` wrapped here and
    restored after), one honest report and one with a tampered proof
    share.  Their scalar reports (the port's scalar shard of the same
    measurement, nonce and rand, tampered alike) must marshal to the
    device batch's rows.  An unforced round over the same attributes
    must give the full round's aggregates of those attributes (numpy's),
    and the forced round the unforced one's; the two lanes must count
    as XOF fallbacks, the honest one accepted and the tampered one
    rejected by the splice, at the weight check."""
    from mastic_tpu_torch import AttributeMetricsRun
    from mastic_tpu_torch.backend.mastic import BatchedMastic

    h = handoff
    lanes = [h["honest"], h["tampered"]]
    honest = next(a for a in h["asked"]
                  if tuple(h["path_of"][a]) == tuple(h["alphas"][lanes[0]]))
    asked = [a for a in h["asked"]
             if a == honest or h["asked"].index(a) < SPLICE_ASKED - 1]
    t0 = time.perf_counter()
    _marshal_matches(dev, h["bm"], h["batch"], h["reports"], lanes)
    scalar_s = time.perf_counter() - t0
    valid = h["shard_ok"].cpu().numpy()

    def attribute_round() -> tuple:
        run = AttributeMetricsRun(h["bm"].m, CTX, asked, h["vk"], h["batch"],
                                  valid=h["shard_ok"], device=dev,
                                  reports=h["reports"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handle = run.step_begin()
        run.step_finish(handle)
        return (run, handle, time.perf_counter() - t0)

    (base_run, base_handle, _) = attribute_round()
    if base_run.result() != [(a, v) for (a, v) in h["result"] if a in asked]:
        raise AssertionError("forced splice from the root: the unforced "
                             "round over the cut attributes differs from the "
                             "full round's")
    fallback = ~base_handle["out"][3].cpu().numpy() & valid
    real = BatchedMastic.prep_both
    cleared = torch.as_tensor(lanes, device=dev)

    def prep_both(self, *args, **kwargs):
        (p0, p1) = real(self, *args, **kwargs)
        ok = p0.ok.clone()
        ok[cleared] = False
        return (p0._replace(ok=ok), p1)

    BatchedMastic.prep_both = prep_both
    try:
        (run, handle, round_s) = attribute_round()
    finally:
        BatchedMastic.prep_both = real
    (m, base) = (run.metrics[0], base_run.metrics[0])
    accept = handle["accept"]
    forced = fallback.copy()
    forced[lanes] = True
    newly = int(not fallback[h["tampered"]])
    if run.result() != base_run.result():
        raise AssertionError("forced splice from the root: the result "
                             "differs from the unforced round's")
    if (m.xof_fallbacks, m.accepted, m.rejected_fallback,
            m.rejected_weight_check, m.rejected_eval_proof) != (
            int(forced.sum()), base.accepted,
            int((forced & h["tampered_mask"]).sum()),
            base.rejected_weight_check - newly, base.rejected_eval_proof) \
            or not accept[h["honest"]] or accept[h["tampered"]] \
            or m.extra["rejected_fallback_by"].get("weight_check", 0) < 1:
        raise AssertionError(f"forced splice from the root: {m}")
    return {"round_s": round_s, "scalar_shard_s": scalar_s,
            "splice_ms": m.extra["splice_ms"], "lanes": lanes,
            "asked": len(asked), "xof_fallbacks": m.xof_fallbacks,
            "rejected_fallback": m.rejected_fallback,
            "rejected_fallback_by": m.extra["rejected_fallback_by"],
            "accepted": m.accepted}


def resident_checkpoint(dev: torch.device, seed: int) -> dict:
    """A forced splice and a checkpoint on the resident runner:
    MasticCount(16) over the Count path's report layout (32 planted
    strings x 64 reports and 2048 uniform ones; depth cut from 256 to 16
    because the splice reruns the scalar round at every later level),
    with the frontier up to 64.  A planted report's `ok` is cleared at
    each level of CKPT_FORCED_LEVELS (`IncrementalMastic.agg_rounds`
    wrapped here and restored after); the run is checkpointed after
    level 8, with the first lane in `fallback`, dropped, restored from
    the checkpoint into a fresh run on the card and finished.  Every
    level's counts must equal the uninterrupted unforced run's and
    numpy's over all reports."""
    from mastic_tpu_torch.backend.incremental import IncrementalMastic
    from mastic_tpu_torch.backend.mastic import BatchedMastic, MasticCount
    from mastic_tpu_torch.drivers.heavy_hitters import HeavyHittersRun

    (alphas, weights, planted) = measurements(seed, CKPT_BITS)
    mastic = MasticCount(CKPT_BITS)
    bm = BatchedMastic(mastic)
    (nonces, rand, vk) = _path_inputs(dev, seed + 11, mastic.RAND_SIZE)
    meas = [(tuple(bool(b) for b in alphas[r]), int(weights[r]))
            for r in range(R)]
    (batch, shard_ok, shard_s) = _shard(dev, bm, meas, nonces, rand)
    reports = ScalarReports(mastic, meas, nonces, rand)
    thresholds = {"default": THRESHOLD}

    def new_run() -> HeavyHittersRun:
        return HeavyHittersRun(mastic, CTX, thresholds, vk, batch,
                               valid=shard_ok, device=dev, reports=reports)

    t0 = time.perf_counter()
    want = new_run()
    while want.step():
        pass
    torch.cuda.synchronize()
    unforced_s = time.perf_counter() - t0

    rows = np.flatnonzero((alphas[:, None, :] == planted[None])
                          .all(-1).any(-1))
    lanes = dict(zip(CKPT_FORCED_LEVELS, (int(rows[0]), int(rows[1]))))
    real = IncrementalMastic.agg_rounds

    def agg_rounds(self, agg_ids, verify_key, ctx, carries, rnd, *args):
        out = real(self, agg_ids, verify_key, ctx, carries, rnd, *args)
        if rnd.level in lanes:
            (carry, proof, share, ok) = out[0]
            ok = ok.clone()
            ok[lanes[rnd.level]] = False
            out[0] = (carry, proof, share, ok)
        return out

    IncrementalMastic.agg_rounds = agg_rounds
    try:
        t0 = time.perf_counter()
        run = new_run()
        for _ in range(CKPT_SPLIT):
            run.step()
        split_fallback = np.flatnonzero(run.runner.fallback.cpu().numpy())
        t1 = time.perf_counter()
        ckpt = run.to_bytes()
        save_s = time.perf_counter() - t1
        (levels, metrics) = (run.level_results, run.metrics)
        del run
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        back = HeavyHittersRun.from_bytes(mastic, CTX, thresholds, vk, batch,
                                          ckpt, valid=shard_ok, device=dev,
                                          reports=reports)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        while back.step():
            pass
        torch.cuda.synchronize()
        forced_s = time.perf_counter() - t0
    finally:
        IncrementalMastic.agg_rounds = real
    levels = levels + back.level_results
    metrics = metrics + back.metrics
    valid = shard_ok.cpu().numpy()
    if levels != want.level_results or back.result() != want.result():
        raise AssertionError("resident checkpoint: the forced, restored run "
                             "differs from the uninterrupted unforced one")
    for (prefixes, counts) in levels:
        if counts != plaintext_counts(alphas, weights, valid, prefixes):
            raise AssertionError(f"resident checkpoint: level "
                                 f"{len(prefixes[0]) - 1} differs from numpy")
    expect = sorted(tuple(bool(b) for b in p) for p in planted)
    fell = [m.xof_fallbacks for m in metrics]
    want_fell = [sum(level >= f for f in CKPT_FORCED_LEVELS)
                 for level in range(len(fell))]
    if sorted(back.result()) != expect or len(levels) != CKPT_BITS \
            or split_fallback.tolist() != [lanes[CKPT_FORCED_LEVELS[0]]] \
            or fell != want_fell:
        raise AssertionError(f"resident checkpoint: heavy hitters "
                             f"{len(back.result())} of {len(expect)}, "
                             f"fallback at the split "
                             f"{split_fallback.tolist()}, xof_fallbacks "
                             f"{fell}")
    return {"shard_s": shard_s, "unforced_s": unforced_s,
            "forced_s": forced_s, "save_s": save_s, "restore_s": restore_s,
            "ckpt_bytes": len(ckpt), "lanes": lanes,
            "splice_ms": sum(m.extra["splice_ms"] for m in metrics),
            "max_frontier": max(len(p) for (p, _c) in levels),
            "heavy_hitters": len(back.result()),
            "handoff": (mastic, vk, batch, shard_ok, reports,
                        want.level_results, want.result())}


def chunked_checkpoint(dev: torch.device, handoff: tuple) -> dict:
    """The resident checkpoint phase's reports through the chunked
    runner: MasticCount(16), R = 4096 in four chunks of 1024, pipelined,
    checkpointed after level 8 (every chunk's carries in the JAX
    package's format), dropped, restored on the card from the batch (the
    checkpoint's chunk_size rebuilds the store) and finished: every
    level must equal that phase's unforced resident run."""
    from mastic_tpu_torch.drivers.heavy_hitters import HeavyHittersRun

    (mastic, vk, batch, shard_ok, reports, want_levels, want_result) = \
        handoff
    thresholds = {"default": THRESHOLD}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = HeavyHittersRun(mastic, CTX, thresholds, vk, batch, valid=shard_ok,
                          device=dev, reports=reports, chunk_size=CKPT_CHUNK)
    for _ in range(CKPT_SPLIT):
        run.step()
    t1 = time.perf_counter()
    ckpt = run.to_bytes()
    save_s = time.perf_counter() - t1
    (levels, metrics) = (run.level_results, run.metrics)
    del run
    t1 = time.perf_counter()
    back = HeavyHittersRun.from_bytes(mastic, CTX, thresholds, vk, batch, ckpt,
                                      valid=shard_ok, device=dev,
                                      reports=reports)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t1
    while back.step():
        pass
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    levels = levels + back.level_results
    metrics = metrics + back.metrics
    modes = {(m.extra["pipeline"]["mode"], m.extra["pipeline"]["fallback"])
             for m in metrics}
    if levels != want_levels or back.result() != want_result \
            or back.store.num_chunks != R // CKPT_CHUNK \
            or modes != {("pipelined", None)}:
        raise AssertionError(f"chunked checkpoint: the restored chunked run "
                             f"differs from the resident one (modes {modes})")
    return {"run_s": run_s, "save_s": save_s, "restore_s": restore_s,
            "ckpt_bytes": len(ckpt), "levels": len(levels),
            "chunks": back.store.num_chunks,
            "heavy_hitters": len(back.result())}


def _mem_available() -> int:
    """This host's available memory (/proc/meminfo's MemAvailable), in
    bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def count_chunked(dev: torch.device, seed: int, levels: int) -> dict:
    """The chunked Count cell: MasticCount(256) over 32 768 reports (the
    Count recipe x8), sharded on the card in batches of 4096, moved into
    a pinned `HostReportStore`, then `HeavyHittersRun(chunk_size=4096)`
    pipelined through the first `levels` levels.  Every level's
    aggregates must equal numpy's count; the run's device peak must be
    at most 1.1x the envelope's pipelined per-chunk peak.  If the host
    cannot hold the carries and the store in memory, R drops to 16 384
    (printed as a cut)."""
    from mastic_tpu_torch import HostReportStore
    from mastic_tpu_torch.backend.mastic import BatchedMastic, MasticCount
    from mastic_tpu_torch.drivers.chunked import (
        _host_budget, cat_batches, memory_envelope, per_report_bytes)
    from mastic_tpu_torch.drivers.heavy_hitters import HeavyHittersRun
    from mastic_tpu_torch.ops import kernels

    mastic = MasticCount(BITS)
    bm = BatchedMastic(mastic)
    avail = min(_mem_available(), _host_budget())
    reports = CHUNKED_R
    # The carries at width 64 and the store, plus one chunk's carry
    # beside its grown copy.
    env = memory_envelope(bm, CHUNKED_CHUNK, 64, reports, dev)
    need = env["host_bytes_total"] + CHUNKED_CHUNK \
        * env["per_report_bytes"]["carry"]
    if need > avail:
        reports = CHUNKED_FALLBACK_R
    (alphas, weights, _planted) = measurements(seed + 13, BITS, reports)
    (nonces, rand, vk) = _path_inputs(dev, seed + 14, mastic.RAND_SIZE,
                                      reports)
    meas = [(tuple(bool(b) for b in alphas[r]), int(weights[r]))
            for r in range(reports)]
    (batches, oks) = ([], [])
    shard_s = 0.0
    for lo in range(0, reports, R):
        (batch, ok, secs) = _shard(dev, bm, meas[lo:lo + R],
                                   nonces[lo:lo + R], rand[lo:lo + R])
        batches.append(batch)
        oks.append(ok)
        shard_s += secs
    batch = cat_batches(batches)
    shard_ok = torch.cat(oks)
    del batches, oks
    shard_launches = dict(kernels.launches)
    t0 = time.perf_counter()
    store = HostReportStore.from_batch(batch, CHUNKED_CHUNK)
    store_s = time.perf_counter() - t0
    del batch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    run = HeavyHittersRun(mastic, CTX, {"default": CHUNKED_THRESHOLD}, vk,
                          valid=shard_ok, device=dev, store=store,
                          reports=ScalarReports(mastic, meas, nonces, rand))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    per_level = []
    t0 = time.perf_counter()
    while run.level < levels:
        t1 = time.perf_counter()
        more = run.step()
        torch.cuda.synchronize()
        m = run.metrics[-1]
        pipe = m.extra["pipeline"]
        per_level.append(dict(
            level=m.level, s=time.perf_counter() - t1,
            width=m.padded_width, mode=pipe["mode"],
            fallback=pipe["fallback"], overlap=pipe["overlap_efficiency"],
            device_overlap=pipe["device_overlap_efficiency"],
            carry_bytes=m.extra["memory"]["device_carry_bytes"],
            **pipe["device_ms"]))
        if not more:
            break
    rounds_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    excluded = run.excluded()
    for (prefixes, counts) in run.level_results:
        if counts != plaintext_counts(alphas, weights, ~excluded, prefixes):
            raise AssertionError(f"chunked Count: level "
                                 f"{len(prefixes[0]) - 1} differs from "
                                 f"numpy's count")
    env = memory_envelope(bm, CHUNKED_CHUNK, run.runner.max_width, reports,
                          dev)
    bound = env["device_peak_bytes_per_chunk_pipelined"]
    # The resident runner holds the same carries, every report's at once.
    resident_carries = reports * per_report_bytes(
        bm, run.runner.max_width)["carry"]
    modes = {(p["mode"], p["fallback"]) for p in per_level}
    if peak > 1.1 * bound or modes != {("pipelined", None)}:
        raise AssertionError(f"chunked Count: device peak {peak} B against "
                             f"the envelope's {bound} B, modes {modes}")
    mem = run.runner.memory_accounting()
    return {"reports": reports, "avail": avail, "need": need,
            "levels": len(run.level_results), "shard_s": shard_s,
            "store_s": store_s, "init_s": init_s, "rounds_s": rounds_s,
            "per_level": per_level, "peak": peak, "bound": bound,
            "resident_carries": resident_carries,
            "host_bytes": mem["host_bytes_total"],
            "store_bytes": store.host_bytes(),
            "max_width": run.runner.max_width,
            "rejected": int(excluded.sum()),
            "xof_fallbacks": run.metrics[-1].xof_fallbacks,
            "shard_launches": shard_launches}


# -- phase m: the north-star tool ------------------------------------------

def northstar_argv(bits: int) -> list:
    """The tool's command line in phase m, before each run's mode."""
    return ["--reports", str(NORTHSTAR_R), "--bits", str(bits),
            "--chunk-size", str(NORTHSTAR_CHUNK), "--seed", "0",
            "--device", "cuda"]


def northstar_oracle(bits: int) -> tuple:
    """`oracle.weighted_heavy_hitters` over the tool's measurements at
    phase m's shape (identical paths merged into one weighted
    measurement: the weights add, so the result is the same)."""
    from mastic_tpu_torch.oracle import weighted_heavy_hitters
    from mastic_tpu_torch.tools import northstar

    args = northstar.parse_args(northstar_argv(bits))
    rep = northstar.synthetic_reports(args)
    merged: dict = {}
    for (alpha, weight) in zip(np.packbits(rep.alphas, axis=1), rep.weights):
        key = alpha.tobytes()
        merged[key] = merged.get(key, 0) + int(weight)
    meas = [(tuple(bool(b) for b in np.unpackbits(
        np.frombuffer(key, np.uint8))[:bits]), w)
        for (key, w) in merged.items()]
    return (weighted_heavy_hitters(meas, rep.threshold, bits),
            sorted(tuple(bool(b) for b in p) for p in rep.paths))


def northstar_phase(dev: torch.device, elapsed_s: float) -> dict:
    """Phase m: `python -m mastic_tpu_torch.tools.northstar`'s `collect`
    in this process, three times on the same reports (NORTHSTAR_R x
    NORTHSTAR_BITS, three planted paths): chunked from a pinned store in
    chunks of NORTHSTAR_CHUNK, `--resident`, and `--mesh 1` over NCCL
    (one spawned rank, chunked).  Each line must say `ok: true` and its
    heavy hitters must equal the planted paths and the oracle's; every
    run must launch K1 (in-place sponge and binder), K2 and K3, counted
    from 0 just before it (the mesh rank counts its own).  Past
    NORTHSTAR_CUT_AFTER_S the runs take NORTHSTAR_CUT_BITS bits (a cut,
    printed)."""
    from mastic_tpu_torch.drivers.chunked import _release_pinned
    from mastic_tpu_torch.ops import kernels
    from mastic_tpu_torch.tools import northstar

    bits = (NORTHSTAR_BITS if elapsed_s < NORTHSTAR_CUT_AFTER_S
            else NORTHSTAR_CUT_BITS)
    t0 = time.perf_counter()
    (oracle, planted) = northstar_oracle(bits)
    oracle_s = time.perf_counter() - t0
    if oracle != planted:
        raise AssertionError("north star: the oracle's heavy hitters are not "
                             "the planted paths")
    out = {"bits": bits, "oracle_s": oracle_s, "runs": {}}
    for (name, extra) in NORTHSTAR_RUNS:
        torch.cuda.empty_cache()
        _release_pinned()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        (_args, result, ranks) = northstar.collect(northstar_argv(bits)
                                                   + extra)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = ranks[0] if ranks else dict(kernels.launches)
        line = result["line"]
        got = sorted(result["heavy_hitters"])
        if not line["ok"] or got != oracle:
            raise AssertionError(f"north star {name}: ok {line['ok']}, heavy "
                                 f"hitters {len(got)} against the oracle's "
                                 f"{len(oracle)}")
        idle = [c for c in NORTHSTAR_COUNTERS if launches[c] == 0]
        if idle:
            raise AssertionError(f"north star {name}: kernels not launched: "
                                 f"{idle}")
        out["runs"][name] = {
            "line": line, "launches": launches, "wall_s": wall_s,
            "peak": None if ranks else torch.cuda.max_memory_allocated(dev)}
    return out


def _print_northstar(m: dict) -> None:
    if m["bits"] < NORTHSTAR_BITS:
        print(f"cut: the north-star runs took {m['bits']} bits, not "
              f"{NORTHSTAR_BITS}: the smoke had run past "
              f"{NORTHSTAR_CUT_AFTER_S:.0f} s")
    print(f"north star: python -m mastic_tpu_torch.tools.northstar, "
          f"MasticCount({m['bits']}), {NORTHSTAR_R} reports, 3 planted paths; "
          f"every run ok, its heavy hitters = the planted paths = the "
          f"oracle's ({m['oracle_s']:.3f} s)")
    for (name, run) in m["runs"].items():
        line = run["line"]
        env = line["envelope"]
        bound = (env["device_peak_bytes_per_chunk"] if name == "resident"
                 else env["device_peak_bytes_per_chunk_pipelined_per_shard"])
        peak = ("device peak measured in the rank" if run["peak"] is None
                else f"device peak {run['peak']} B against the envelope's "
                     f"{bound} B")
        print(f"north star {name}: {line['levels']} levels, width "
              f"{env['width']}, shard {line['shard_seconds']} s, rounds "
              f"{line['wall_seconds']} s, {line['node_evals_per_sec']} node "
              f"evals/s (p50 a chunk {line['per_chunk_evals_per_sec_p50']}), "
              f"{peak}; call {run['wall_s']:.3f} s; launches "
              + ", ".join(f"{k} {v}" for (k, v) in run["launches"].items()
                          if v))
        print(f"north star {name} line: {json.dumps(line)}")


# -- phase n: MasticMultihotCountVec, and Histogram at 100 000 reports ----

def multihot_inputs(dev: torch.device, seed: int) -> dict:
    """Phase n1's reports: MasticMultihotCountVec(64, 16, 4, 4), R
    reports of which four in five take one of 16 hashed attribute
    strings (the rest one of 2^64 others), each a 16-entry vector with
    0 to 4 entries hot; sharded on the card, then MULTIHOT_TAMPERED
    reports' leader proof shares changed (one limb's bit 0), and the
    scalar reports behind the batch tampered alike."""
    from mastic_tpu_torch import hash_attribute
    from mastic_tpu_torch.backend.mastic import (BatchedMastic,
                                                 MasticMultihotCountVec)

    (bits, length, max_weight, _chunk) = MULTIHOT
    mastic = MasticMultihotCountVec(*MULTIHOT)
    bm = BatchedMastic(mastic)
    rng = np.random.default_rng(seed + 30)
    asked = [f"multihot-{i}" for i in range(MULTIHOT_ATTRS)]
    paths = np.array([hash_attribute(mastic, a) for a in asked], bool)
    alphas = np.where((rng.random(R) < 0.8)[:, None],
                      paths[rng.integers(0, MULTIHOT_ATTRS, R)],
                      rng.integers(0, 2, (R, bits)).astype(bool))
    values = np.zeros((R, length), bool)
    for r in range(R):
        hot = rng.choice(length, int(rng.integers(0, max_weight + 1)),
                         replace=False)
        values[r, hot] = True
    (nonces, rand, vk) = _path_inputs(dev, seed + 31, mastic.RAND_SIZE, R)
    meas = [(tuple(bool(b) for b in alphas[r]), values[r].tolist())
            for r in range(R)]
    (batch, shard_ok, shard_s) = _shard(dev, bm, meas, nonces, rand)
    rows = np.sort(rng.choice(R, MULTIHOT_TAMPERED, replace=False))
    at = rng.integers(0, mastic.valid.PROOF_LEN, MULTIHOT_TAMPERED)
    batch.leader_proofs[torch.as_tensor(rows, device=dev),
                        torch.as_tensor(at, device=dev), 0] ^= 1
    tamper_at = {int(r): int(j) for (r, j) in zip(rows, at)}

    def tamper(r: int, report: tuple) -> tuple:
        if r not in tamper_at:
            return report
        (nonce, public_share, shares) = report
        (key, proof_share, seed_, part) = shares[0]
        proof_share = list(proof_share)
        j = tamper_at[r]
        proof_share[j] = type(proof_share[j])(proof_share[j].int() ^ 1)
        return (nonce, public_share, [(key, proof_share, seed_, part),
                                      shares[1]])

    tampered = np.zeros(R, bool)
    tampered[rows] = True
    return {"mastic": mastic, "bm": bm, "asked": asked, "paths": paths,
            "alphas": alphas, "values": values, "vk": vk, "batch": batch,
            "shard_ok": shard_ok, "shard_s": shard_s, "tampered": tampered,
            "reports": ScalarReports(mastic, meas, nonces, rand, tamper)}


def multihot_path(dev: torch.device, seed: int) -> dict:
    """Phase n1 (`multihot_inputs`): both aggregators' weight check from
    their depth-0 payloads, the joint rand confirmed: exactly the
    tampered reports fail the FLP check.  Then one weight-checked round
    from the root at level 63 over the 16 attributes
    (`aggregate_by_attribute`): every attribute's 16-entry count must
    equal numpy's over the untampered reports, and the round must
    reject exactly the tampered reports, attributed to the weight
    check."""
    from mastic_tpu_torch import aggregate_by_attribute
    from mastic_tpu_torch.ops import kernels

    i = multihot_inputs(dev, seed)
    shard_launches = dict(kernels.launches)
    (bm, batch, vk) = (i["bm"], i["batch"], i["vk"])
    valid = i["shard_ok"].cpu().numpy()
    tampered = i["tampered"]
    t0 = time.perf_counter()
    root = bm.schedule((0, ((False,), (True,)), True), dev)
    trees = [bm.vidpf.eval_full(a, batch.cws, batch.keys[:, a], root, CTX,
                                batch.nonces) for a in range(2)]
    (checks, wc_ok) = bm.weight_check_device(vk, CTX, 0, batch, trees[0][0],
                                             trees[1][0])
    ok = (wc_ok & trees[0][3] & trees[1][3]).cpu().numpy()
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0
    flp = checks["weight_check"].cpu().numpy()
    joint = checks["joint_rand"].cpu().numpy()
    live = valid & ok
    if not (np.array_equal(flp[live], ~tampered[live]) and joint[live].all()):
        raise AssertionError("MasticMultihotCountVec weight check: the FLP "
                             "verdicts are not exactly the untampered "
                             "reports, or a joint rand was not confirmed")
    del trees, checks
    metrics = []
    t0 = time.perf_counter()
    got = aggregate_by_attribute(i["mastic"], CTX, i["asked"], vk, batch,
                                 valid=i["shard_ok"], metrics_out=metrics,
                                 device=dev, reports=i["reports"])
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    keep = valid & ~tampered
    want = [(a, i["values"][(i["alphas"] == p).all(axis=1) & keep]
             .sum(axis=0).tolist()) for (a, p) in zip(i["asked"], i["paths"])]
    if got != want:
        raise AssertionError("MasticMultihotCountVec: per-attribute counts "
                             "differ from numpy's")
    m = metrics[0]
    rejected = int((valid & tampered).sum())
    if (m.accepted, m.rejected_weight_check, m.rejected_eval_proof,
            m.rejected_joint_rand, m.xof_fallbacks) != (
            int(keep.sum()), rejected, 0, 0, 0):
        raise AssertionError(f"MasticMultihotCountVec: rejections "
                             f"misattributed: {m}")
    return {"shard_s": i["shard_s"], "check_s": check_s,
            "round_s": round_s, "accepted": m.accepted,
            "rejected_weight_check": m.rejected_weight_check,
            "rejected_eval_proof": m.rejected_eval_proof,
            "xof_fallbacks": m.xof_fallbacks, "nodes": m.padded_width,
            "in_set": int(sum((i["alphas"] == p).all(axis=1).sum()
                              for p in i["paths"])),
            "shard_rejected": int((~valid).sum()),
            "shard_launches": shard_launches, "levels": 1}


def hist100k_chunk(dev: torch.device, reports: int) -> int:
    """Phase n2's chunk size: `memory_envelope`'s largest pipelined
    chunk at the from-root tree's padded width 32 (two chunks' trees on
    the card at once), in multiples of 1024 when it holds one, at most
    `reports`."""
    from mastic_tpu_torch.backend.mastic import BatchedMastic, MasticHistogram
    from mastic_tpu_torch.drivers.chunked import memory_envelope

    env = memory_envelope(BatchedMastic(MasticHistogram(*HIST)), 1024,
                          HIST100K_WIDTH, reports, dev)
    most = env["max_pipelined_chunk_size_at_width"]
    return min(reports, most // 1024 * 1024 if most >= 1024 else most)


def histogram_100k(dev: torch.device, seed: int, elapsed_s: float) -> dict:
    """Phase n2: BASELINE.json's "Histogram(len=16), BITS=64, 100k
    clients".  MasticHistogram(64, 16, 4) over HIST100K_R reports, the
    Histogram cell's recipe (each report one of 16 attribute strings,
    here hashed names, with a uniform bucket), sharded on the card in
    batches of 4096 into a pinned `HostReportStore`, then the
    weight-checked round from the root at level 63 over the 16
    attributes in chunks (`aggregate_by_attribute(chunk_size=, store=)`,
    the chunk from `hist100k_chunk`): every attribute's 16 buckets must
    equal numpy's, every report accepted.  Past HIST100K_CUT_AFTER_S it
    runs HIST100K_CUT_R reports (a cut, printed)."""
    from mastic_tpu_torch import (HostReportStore, aggregate_by_attribute,
                                  hash_attribute)
    from mastic_tpu_torch.backend.mastic import (BatchedMastic,
                                                 MasticHistogram)
    from mastic_tpu_torch.drivers.chunked import cat_batches
    from mastic_tpu_torch.ops import kernels

    reports = (HIST100K_R if elapsed_s < HIST100K_CUT_AFTER_S
               else HIST100K_CUT_R)
    (bits, length, _chunk) = HIST
    mastic = MasticHistogram(*HIST)
    bm = BatchedMastic(mastic)
    rng = np.random.default_rng(seed + 32)
    asked = [f"histogram-{i}" for i in range(HIST_ATTRS)]
    paths = np.array([hash_attribute(mastic, a) for a in asked], bool)
    attr = rng.integers(0, HIST_ATTRS, reports)
    buckets = rng.integers(0, length, reports)
    (nonces, rand, vk) = _path_inputs(dev, seed + 33, mastic.RAND_SIZE,
                                      reports)
    meas = [(tuple(bool(b) for b in paths[attr[r]]), int(buckets[r]))
            for r in range(reports)]
    (batches, oks) = ([], [])
    shard_s = 0.0
    for lo in range(0, reports, R):
        (batch, ok, secs) = _shard(dev, bm, meas[lo:lo + R],
                                   nonces[lo:lo + R], rand[lo:lo + R])
        batches.append(batch)
        oks.append(ok)
        shard_s += secs
    batch = cat_batches(batches)
    shard_ok = torch.cat(oks)
    del batches, oks
    shard_launches = dict(kernels.launches)
    chunk = hist100k_chunk(dev, reports)
    t0 = time.perf_counter()
    store = HostReportStore.from_batch(batch, chunk)
    store_s = time.perf_counter() - t0
    del batch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    metrics = []
    t0 = time.perf_counter()
    got = aggregate_by_attribute(
        mastic, CTX, asked, vk, valid=shard_ok, metrics_out=metrics,
        device=dev, chunk_size=chunk, store=store,
        reports=ScalarReports(mastic, meas, nonces, rand))
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    valid = shard_ok.cpu().numpy()
    want = [(a, np.bincount(buckets[(attr == k) & valid],
                            minlength=length).tolist())
            for (k, a) in enumerate(asked)]
    m = metrics[0]
    if got != want or m.accepted != int(valid.sum()):
        raise AssertionError(f"Histogram at {reports} reports: buckets "
                             f"differ from numpy's, or a report was "
                             f"rejected ({m.accepted} accepted)")
    pipe = m.extra["pipeline"]
    return {"reports": reports, "chunk": chunk, "shard_s": shard_s,
            "store_s": store_s, "store_bytes": store.host_bytes(),
            "round_s": round_s, "accepted": m.accepted,
            "nodes": m.padded_width, "node_evals": m.node_evals,
            "chunks": len(m.extra["chunks"]),
            "mode": (pipe["mode"], pipe["fallback"]),
            "overlap": pipe["overlap_efficiency"],
            "round_peak": torch.cuda.max_memory_allocated(dev),
            "shard_rejected": int((~valid).sum()),
            "shard_launches": shard_launches, "levels": 1}


def _print_phase_n(results: dict, peaks: dict, counts: dict) -> None:
    r = results["multihot"]
    print(f"multihot path: MasticMultihotCountVec{MULTIHOT}, {R} reports "
          f"({r['in_set']} on the {MULTIHOT_ATTRS} attributes), "
          f"{MULTIHOT_TAMPERED} tampered leader proof shares; both "
          f"aggregators' weight check {r['check_s']:.3f} s (the FLP "
          f"verdicts exactly the untampered reports, every joint rand "
          f"confirmed); the round from the root at level {MULTIHOT[0] - 1} "
          f"over {MULTIHOT_ATTRS} attributes ({r['nodes']} nodes a report) "
          f"{r['round_s']:.3f} s: every attribute's {MULTIHOT[1]}-entry "
          f"count = numpy's, accepted {r['accepted']}, rejected_weight_check "
          f"{r['rejected_weight_check']}, rejected_eval_proof "
          f"{r['rejected_eval_proof']}, xof_fallbacks {r['xof_fallbacks']} "
          f"({r['shard_rejected']} at sharding); shard {r['shard_s']:.3f} s; "
          f"peak device memory {peaks['multihot']} B")
    _print_launches(counts["multihot"], r)
    r = results["histogram_100k"]
    if r["reports"] < HIST100K_R:
        print(f"cut: the Histogram cell ran {r['reports']} reports, not "
              f"{HIST100K_R}: the smoke had run past "
              f"{HIST100K_CUT_AFTER_S:.0f} s")
    print(f"histogram 100k: MasticHistogram{HIST}, {r['reports']} reports "
          f"over {HIST_ATTRS} attributes, sharded in batches of {R} "
          f"({r['shard_s']:.3f} s), a pinned store of {r['store_bytes']} B "
          f"({r['store_s']:.3f} s); the weight-checked round from the root "
          f"at level {HIST[0] - 1} in {r['chunks']} chunks of {r['chunk']} "
          f"(memory_envelope at width {HIST100K_WIDTH}; {r['mode']}, overlap "
          f"efficiency {r['overlap']}) {r['round_s']:.3f} s, {r['nodes']} "
          f"nodes a report, {r['node_evals']} node evals "
          f"({r['node_evals'] / r['round_s']:.4g} evals/s): every "
          f"attribute's {HIST[1]} buckets = numpy's, accepted "
          f"{r['accepted']} ({r['shard_rejected']} rejected at sharding); "
          f"peak device memory of the round {r['round_peak']} B")
    _print_launches(counts["histogram_100k"], r)


def check_phase_n_shapes(dev: torch.device, gen: torch.Generator) -> list:
    """The kernels at phase n's shapes, each row under its own name: K3 at
    MasticMultihotCountVec(64, 16, 4, 4)'s (Field128, VALUE_LEN 20, 21
    convert blocks) from-root level, R x 16 parents, and at the
    Histogram cell's chunk x 16 parents (VALUE_LEN 17); K1's binder
    sponge on each round's flat Field128 tree (one aggregator, the
    schedule's index lists at level 63 over the 16 attributes), timed at
    the path's report count and checked against the plain version: the
    multihot tree on its first BINDER_CHECK_R reports, the Histogram
    chunk's on every report with the index lists cut by `_end_rows`
    (the plain sponge's time goes with the rows); K2 at 21 blocks."""
    from mastic_tpu_torch import hash_attribute
    from mastic_tpu_torch.backend.mastic import (BatchedMastic,
                                                 MasticHistogram,
                                                 MasticMultihotCountVec)
    from mastic_tpu_torch.backend.schedule import LevelSchedule
    from mastic_tpu_torch.ops.field import FIELD128

    rows = []
    multihot = MasticMultihotCountVec(*MULTIHOT)
    hist = MasticHistogram(*HIST)
    chunk = hist100k_chunk(dev, HIST100K_R)
    binder_len = 4 + MULTIHOT[0] // 8
    for (mastic, reports, name) in (
            (multihot, R, "level_step_f128_multihot"),
            (hist, chunk, "level_step_f128_histogram_100k")):
        row = check_level(dev, gen, FIELD128, mastic.value_len,
                          MULTIHOT_ATTRS, CTX, name, reports=reports,
                          binder_len=binder_len)
        print(f"K3 ({name}): whole call {row['ms']:.4f} ms, kernels "
              f"{row['device_ms']:.4f} ms (plain {row['plain_ms']:.3f} ms, "
              f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}) at "
              f"{row['shape']}, max_abs_err {row['max_abs_err']}")
        rows.append(row)
        torch.cuda.empty_cache()
    for (mastic, prefix, reports, name) in (
            (multihot, "multihot", R,
             "keccak_binder_sponge_from_root_multihot"),
            (hist, "histogram", chunk,
             "keccak_binder_sponge_from_root_histogram_100k")):
        paths = sorted(hash_attribute(mastic, f"{prefix}-{i}")
                       for i in range(MULTIHOT_ATTRS))
        sched = LevelSchedule(paths, mastic.bits - 1, mastic.bits)
        args = flat_binder_inputs(dev, gen, sched, reports, FIELD128,
                                  mastic.value_len, type(mastic).ID)
        if mastic is multihot:
            compare = (args[0], (args[1][0][:BINDER_CHECK_R],),
                       (args[2][0][:BINDER_CHECK_R],), *args[3:])
            what = (f"on the first {BINDER_CHECK_R} of {reports} reports x "
                    f"{sched.total_nodes} nodes")
        else:
            # The plain sponge's time goes with the rows, not the
            # reports: every report, the index lists cut at both ends.
            compare = _end_rows(args, onehot=8, payload=3)
            what = (f"on all {reports} reports x {sched.total_nodes} nodes "
                    f"with the index lists cut to onehot rows "
                    f"{compare[3].tolist()} and payload rows (par, left, "
                    f"right) "
                    f"{list(zip(*(t.tolist() for t in compare[4:7])))}")
        rows.append(_flat_binder_row(name, args, compare,
                                     PAYLOAD_ELEM_OPS_F128, what))
        del args, compare
        torch.cuda.empty_cache()
    rows.append(_aes_row(dev, gen,
                         BatchedMastic(multihot).vidpf.convert_blocks,
                         "aes_fixed_key_blocks_multihot"))
    for row in rows:
        if row["max_abs_err"]:
            raise AssertionError(f"{row['name']} disagrees with its plain "
                                 f"version: {row['max_abs_err']}")
    return rows


def _widest_mesh(run) -> dict:
    """extra["mesh"] of the run's widest level."""
    return max(run.metrics, key=lambda m: m.frontier_width).extra["mesh"]


def _mesh_idle(name: str, launches: dict, rank: int) -> None:
    idle = [c for c in MESH_COUNTERS[name] if launches[c] == 0]
    if idle:
        raise AssertionError(f"mesh {name} run, rank {rank}: kernels not "
                             f"launched: {idle}")


def _count_levels(run, levels: int, alphas, weights, planted,
                  what: str) -> None:
    """Step `run` through `levels` levels, each against numpy's count;
    at full depth the heavy hitters must be the planted strings."""
    while run.level < levels and run.step():
        pass
    excluded = run.excluded()
    for (prefixes, counts) in run.level_results:
        if counts != plaintext_counts(alphas, weights, ~excluded, prefixes):
            raise AssertionError(f"{what}: level {len(prefixes[0]) - 1} "
                                 f"differs from numpy's count")
    if len(run.level_results) == BITS:
        want = sorted(tuple(bool(b) for b in p) for p in planted)
        if sorted(run.result()) != want:
            raise AssertionError(f"{what}: the heavy hitters are not the "
                                 f"planted strings")


def mesh_nccl_rank(mesh, seed: int, expect: list) -> dict:
    """Phase j over NCCL, one rank: the Count path's reports (drawn as
    phase a draws them) through `HeavyHittersRun(mesh=)` for as many
    levels as `expect` holds, each equal to phase a's."""
    from mastic_tpu_torch.backend.mastic import BatchedMastic, MasticCount
    from mastic_tpu_torch.drivers.heavy_hitters import HeavyHittersRun
    from mastic_tpu_torch.ops import kernels

    dev = mesh.device
    (alphas, weights, _planted) = measurements(seed, BITS, R)
    mastic = MasticCount(BITS)
    (nonces, rand, vk) = _path_inputs(dev, seed + 1, mastic.RAND_SIZE, R)
    meas = [(tuple(bool(b) for b in alphas[r]), int(weights[r]))
            for r in range(R)]
    t0 = time.perf_counter()
    kernels.reset_launches()
    (batch, shard_ok, _s) = _shard(dev, BatchedMastic(mastic), meas, nonces,
                                   rand)
    run = HeavyHittersRun(mastic, CTX, {"default": THRESHOLD}, vk, batch,
                          valid=shard_ok, device=dev, mesh=mesh,
                          reports=ScalarReports(mastic, meas, nonces, rand))
    t1 = time.perf_counter()
    while run.level < len(expect) and run.step():
        pass
    torch.cuda.synchronize()
    rounds_s = time.perf_counter() - t1
    if run.level_results != expect:
        raise AssertionError("mesh over NCCL: the levels differ from the "
                             "Count path's")
    _mesh_idle("nccl", kernels.launches, mesh.rank)
    return {"levels": len(run.level_results), "rounds_s": rounds_s,
            "wall_s": time.perf_counter() - t0, "mesh": _widest_mesh(run),
            "launches": dict(kernels.launches)}


def mesh_sharded_fns(mesh, bm, meas: list, nonces: torch.Tensor,
                     rand: torch.Tensor, batch, shard_ok: torch.Tensor,
                     alphas: np.ndarray, weights: np.ndarray) -> dict:
    """The JAX package's sharded functions on the card, after the
    resident run (their launches are not the run's): `sharded_gen` on
    this rank's rows equals those rows of the client shard, and
    `sharded_round` at level 0 with the weight check accepts every
    report, its summed aggregates equal to numpy's count."""
    from mastic_tpu_torch.parallel import sharded_gen, sharded_round

    dev = mesh.device
    t0 = time.perf_counter()
    (lo, hi) = mesh.bounds(len(meas))
    (a_dev, b_dev) = bm.encode_measurements(meas, dev)
    (cws, keys, _ok) = sharded_gen(bm, mesh, CTX)(
        a_dev, b_dev, nonces, rand[:, :bm.m.VIDPF_RAND_SIZE])
    if not (torch.equal(keys, batch.keys[lo:hi])
            and all(torch.equal(a, b[lo:hi])
                    for (a, b) in zip(cws, batch.cws))):
        raise AssertionError("sharded_gen differs from the client shard's "
                             "rows")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if not bool(shard_ok.all()):
        raise AssertionError("sharded_round: a report failed its shard")
    t0 = time.perf_counter()
    (agg0, agg1, accept, _ok) = sharded_round(
        bm, mesh, bytes(32), CTX, (0, ((False,), (True,)), True))(batch)
    round_s = time.perf_counter() - t0
    got = bm.m.unshard([bm.agg_share_to_host(a) for a in (agg0, agg1)])
    want = [int(weights[alphas[:, 0] == bit].sum()) for bit in (0, 1)]
    if not bool(accept.all()) or got != want:
        raise AssertionError(f"sharded_round at level 0: {got} against "
                             f"numpy's {want}")
    return {"gen_s": gen_s, "round_s": round_s, "rows": hi - lo,
            "level0": got}


def mesh_gloo_rank(mesh, seed: int, levels: int, nodes_r: int) -> dict:
    """Phase j over gloo, this rank of MESH_RANKS sharing the card: the
    resident run, the chunked run and the attribute round (see
    MESH_R); every level against numpy, the chunked frontier equal to
    the resident run's, the attribute round held as phase e holds
    it.  Phase q1 on a second mesh over the same ranks, reports 1 x
    nodes NODES_AXIS: the resident run's last level from the root over
    its first `nodes_r` reports after the resident run, and the
    attribute round after phase j's."""
    import os

    from mastic_tpu_torch import AttributeMetricsRun, HostReportStore
    from mastic_tpu_torch.backend.mastic import BatchedMastic, MasticCount
    from mastic_tpu_torch.drivers.chunked import memory_envelope
    from mastic_tpu_torch.drivers.heavy_hitters import HeavyHittersRun
    from mastic_tpu_torch.ops import kernels
    from mastic_tpu_torch.parallel import make_mesh

    dev = mesh.device
    nodes_mesh = make_mesh(MESH_RANKS, nodes_axis=NODES_AXIS, device=dev)
    budget = int(MESH_BUDGET_SHARE
                 * torch.cuda.get_device_properties(dev).total_memory)
    os.environ["MASTIC_DEVICE_BUDGET_BYTES"] = str(budget)
    out = {"budget": budget}

    (alphas, weights, planted) = measurements(seed + 20, BITS, MESH_R)
    mastic = MasticCount(BITS)
    bm = BatchedMastic(mastic)
    (nonces, rand, vk) = _path_inputs(dev, seed + 21, mastic.RAND_SIZE,
                                      MESH_R)
    meas = [(tuple(bool(b) for b in alphas[r]), int(weights[r]))
            for r in range(MESH_R)]
    reports = ScalarReports(mastic, meas, nonces, rand)
    thresholds = {"default": MESH_THRESHOLD}

    # Resident: each rank shards its 4096 rows, gathers the whole batch
    # (the same arguments on every rank) and keeps its rows.
    t0 = time.perf_counter()
    kernels.reset_launches()
    (batch, shard_ok, _s) = _shard(dev, bm, meas, nonces, rand, mesh)
    run = HeavyHittersRun(mastic, CTX, thresholds, vk, batch,
                          valid=shard_ok, device=dev, reports=reports,
                          mesh=mesh)
    t1 = time.perf_counter()
    _count_levels(run, levels, alphas, weights, planted, "mesh resident")
    torch.cuda.synchronize()
    _mesh_idle("resident", kernels.launches, mesh.rank)
    resident_levels = [p for (p, _c) in run.level_results]
    out["resident"] = {
        "levels": len(run.level_results),
        "rounds_s": time.perf_counter() - t1,
        "wall_s": time.perf_counter() - t0, "mesh": _widest_mesh(run),
        "max_width": run.runner.max_width,
        "peak": torch.cuda.max_memory_allocated(dev),
        "launches": dict(kernels.launches)}
    (last, excluded) = (run.level_results[-1], run.excluded())
    del run
    torch.cuda.empty_cache()
    out["nodes_count"] = nodes_count(nodes_mesh, mastic, batch, ~excluded,
                                     reports, vk, last, alphas, weights,
                                     nodes_r)
    out["sharded"] = mesh_sharded_fns(mesh, bm, meas, nonces, rand, batch,
                                      shard_ok, alphas, weights)

    # Chunked: the same reports from a pinned store, this rank's 1024
    # rows of every chunk padded to 2048.
    t0 = time.perf_counter()
    kernels.reset_launches()
    store = HostReportStore.from_batch(batch, MESH_CHUNK)
    del batch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    run = HeavyHittersRun(mastic, CTX, thresholds, vk, valid=shard_ok,
                          device=dev, store=store, reports=reports,
                          mesh=mesh)
    t1 = time.perf_counter()
    _count_levels(run, MESH_CHUNKED_LEVELS, alphas, weights, planted,
                  "mesh chunked")
    torch.cuda.synchronize()
    rounds_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated(dev)
    if [p for (p, _c) in run.level_results] != \
            resident_levels[:MESH_CHUNKED_LEVELS]:
        raise AssertionError("mesh chunked: the frontier differs from the "
                             "resident run's")
    modes = {(m.extra["pipeline"]["mode"], m.extra["pipeline"]["fallback"])
             for m in run.metrics}
    env = memory_envelope(bm, MESH_CHUNK, run.runner.max_width, MESH_R, dev,
                          n_device_shards=mesh.shape["reports"])
    bound = env["device_peak_bytes_per_chunk_pipelined_per_shard"]
    if peak > 1.1 * bound or modes != {("pipelined", None)}:
        raise AssertionError(f"mesh chunked: device peak {peak} B against "
                             f"the envelope's {bound} B, modes {modes}")
    _mesh_idle("chunked", kernels.launches, mesh.rank)
    out["chunked"] = {
        "levels": len(run.level_results), "rounds_s": rounds_s,
        "wall_s": time.perf_counter() - t0, "mesh": _widest_mesh(run),
        "max_width": run.runner.max_width, "peak": peak, "bound": bound,
        "tile": run.runner.tile, "num_chunks": store.num_chunks,
        "launches": dict(kernels.launches)}
    del run, store

    # The attribute round of phase e, each rank over its rows.
    t0 = time.perf_counter()
    kernels.reset_launches()
    inputs = attribute_inputs(dev, seed, mesh)
    run = AttributeMetricsRun(inputs["mastic"], CTX, inputs["asked"],
                              inputs["vk"], inputs["batch"],
                              valid=inputs["shard_ok"], device=dev,
                              reports=inputs["reports"], mesh=mesh)
    t1 = time.perf_counter()
    handle = run.step_begin()
    run.step_finish(handle)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t1
    check_attribute_round(inputs, run, handle["accept"], handle["ok"])
    _mesh_idle("attributes", kernels.launches, mesh.rank)
    m = run.metrics[0]
    out["attributes"] = {
        "round_s": round_s, "wall_s": time.perf_counter() - t0,
        "mesh": m.extra["mesh"], "accepted": m.accepted,
        "rejected_eval_proof": m.rejected_eval_proof,
        "rejected_weight_check": m.rejected_weight_check,
        "launches": dict(kernels.launches)}
    del run, handle
    torch.cuda.empty_cache()
    out["nodes_attributes"] = nodes_attributes(nodes_mesh, inputs)
    return out


def _split_stats(bm) -> dict:
    """The round's exchanges (`GridSplit.summary`, one a prep) summed
    over its two preps: this rank's walked nodes of the round's, those
    a lower node rank walks too, bytes each way and the time on the
    card (CUDA events) and on the host's clock, whole and in its three
    phases (packing and the copies to host memory, the collective, the
    copies back and unpacking)."""
    entries = bm.vidpf.constrain_state.summary()
    first = entries[0]
    return {"nodes": first["nodes"], "shared": first["shared"],
            "total": first["total"], "preps": len(entries),
            "bytes_sent": sum(e["bytes_sent"] for e in entries),
            "bytes_received": sum(e["bytes_received"] for e in entries),
            "exchange_ms": sum(e["device_ms"] for e in entries),
            **{key: sum(e[key] for e in entries) for key in (
                "wall_ms", "to_wire_ms", "collective_ms", "from_wire_ms")}}


def nodes_count(nodes_mesh, mastic, batch, valid: np.ndarray, reports, vk,
                last: tuple, alphas: np.ndarray, weights: np.ndarray,
                num: int) -> dict:
    """Phase q1's Count run: the resident run's last level (`last` =
    (prefixes, counts)) as one `run_round` from the root over the first
    `num` reports, split over the node axis; its aggregates must equal
    the resident run's (numpy's over those reports, when cut)."""
    from mastic_tpu_torch.backend.mastic import BatchedMastic
    from mastic_tpu_torch.drivers.heavy_hitters import run_round
    from mastic_tpu_torch.ops import kernels
    from mastic_tpu_torch.parallel import install_grid_sharding
    from mastic_tpu_torch.parallel.mesh import tree_map

    dev = nodes_mesh.device
    (prefixes, counts) = last
    level = len(prefixes[0]) - 1
    want = (counts if num == len(valid)
            else plaintext_counts(alphas[:num], weights[:num], valid[:num],
                                  prefixes))
    if num < len(valid):
        batch = tree_map(lambda t: t[:num].contiguous(), batch)
    bm = BatchedMastic(mastic)
    install_grid_sharding(bm, nodes_mesh)
    metrics: list = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = run_round(bm, vk, CTX, (level, tuple(prefixes), False), batch,
                    valid=torch.as_tensor(valid[:num], device=dev),
                    metrics_out=metrics, reports=reports)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    if got != want:
        raise AssertionError(f"node axis: the Count run from the root at "
                             f"level {level} differs from the resident "
                             f"run's")
    _mesh_idle("nodes", kernels.launches, nodes_mesh.rank)
    return {"level": level, "prefixes": len(prefixes), "reports": num,
            "accepted": metrics[0].accepted, "round_s": round_s,
            "peak": torch.cuda.max_memory_allocated(dev),
            "launches": dict(kernels.launches), **_split_stats(bm)}


def nodes_attributes(nodes_mesh, inputs: dict) -> dict:
    """Phase e's attribute round (`attribute_inputs`) on `nodes_mesh`,
    split over its node axis, held as phase e holds it."""
    from mastic_tpu_torch import AttributeMetricsRun
    from mastic_tpu_torch.ops import kernels
    from mastic_tpu_torch.parallel import install_grid_sharding

    dev = nodes_mesh.device
    run = AttributeMetricsRun(inputs["mastic"], CTX, inputs["asked"],
                              inputs["vk"], inputs["batch"],
                              valid=inputs["shard_ok"], device=dev,
                              reports=inputs["reports"], mesh=nodes_mesh)
    install_grid_sharding(run.bm, nodes_mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    handle = run.step_begin()
    run.step_finish(handle)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    check_attribute_round(inputs, run, handle["accept"], handle["ok"])
    _mesh_idle("nodes", kernels.launches, nodes_mesh.rank)
    m = run.metrics[0]
    return {"reports": len(inputs["weights"]), "round_s": round_s,
            "peak": torch.cuda.max_memory_allocated(dev),
            "mesh": m.extra["mesh"], "accepted": m.accepted,
            "rejected_eval_proof": m.rejected_eval_proof,
            "rejected_weight_check": m.rejected_weight_check,
            "launches": dict(kernels.launches), **_split_stats(run.bm)}


def cut_attribute_inputs(inputs: dict, num: int) -> dict:
    """`attribute_inputs` cut to its first `num` reports."""
    from mastic_tpu_torch.parallel.mesh import tree_map

    out = dict(inputs)
    out["batch"] = tree_map(lambda t: t[:num].contiguous(), inputs["batch"])
    for key in ("shard_ok", "alphas", "weights", "in_set", "tampered"):
        out[key] = inputs[key][:num]
    for key in ("cw_rows", "proof_rows"):
        out[key] = inputs[key][inputs[key] < num]
    return out


def nodes_q2_rank(mesh, seed: int, reports: int) -> dict:
    """Phase q2, this rank of NODES_Q2_RANKS gloo ranks sharing the card:
    phase e's reports sharded over the ranks and gathered, then its
    attribute round over the first `reports` of them on a (reports 2 x
    nodes 2) mesh, split over the node axis."""
    from mastic_tpu_torch.parallel import make_mesh

    dev = mesh.device
    nodes_mesh = make_mesh(mesh.world, nodes_axis=NODES_AXIS, device=dev)
    inputs = attribute_inputs(dev, seed, mesh)
    if reports < ATTR_R:
        inputs = cut_attribute_inputs(inputs, reports)
    return nodes_attributes(nodes_mesh, inputs)


def mesh_phase(elapsed_s: float, seed: int, first_levels: list) -> dict:
    """Phase j: the NCCL rank, then the gloo ranks (see MESH_R), phase
    q1 among them; then phase q2's ranks.  The kernels are built
    already, so no rank compiles."""
    from mastic_tpu_torch.drivers.chunked import _release_pinned
    from mastic_tpu_torch.parallel import spawn

    torch.cuda.empty_cache()
    _release_pinned()
    levels = MESH_LEVELS if elapsed_s < MESH_CUT_AFTER_S else MESH_CUT_LEVELS
    nodes_cut = elapsed_s >= NODES_CUT_AFTER_S
    t0 = time.perf_counter()
    nccl = spawn(mesh_nccl_rank, 1, "nccl", "cuda", seed, first_levels)
    nccl_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gloo = spawn(mesh_gloo_rank, MESH_RANKS, "gloo", "cuda", seed, levels,
                 NODES_CUT_R if nodes_cut else MESH_R)
    gloo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    q2 = spawn(nodes_q2_rank, NODES_Q2_RANKS, "gloo", "cuda", seed,
               NODES_CUT_R if nodes_cut else ATTR_R)
    return {"levels": levels, "nccl": nccl[0][0], "nccl_s": nccl_s,
            "gloo": [r[0] for r in gloo], "gloo_s": gloo_s,
            "nodes_cut": nodes_cut, "q2": [r[0] for r in q2],
            "q2_s": time.perf_counter() - t0}


def _print_mesh(mesh: dict) -> None:
    """Phase j's lines: per run the ranks, the backend, the times, the
    widest level's mesh block and each rank's launches; each rank's
    device peak against its per-shard envelope."""
    def launches(d: dict) -> str:
        return ", ".join(f"{k} {v}" for (k, v) in d.items() if v)

    nccl = mesh["nccl"]
    print(f"mesh nccl: 1 rank, MasticCount({BITS}), {R} reports, "
          f"{nccl['levels']} levels = the Count path's; wall "
          f"{nccl['wall_s']:.3f} s, rounds {nccl['rounds_s']:.3f} s, phase "
          f"{mesh['nccl_s']:.1f} s; widest level's mesh "
          f"{json.dumps(nccl['mesh'])}; launches {launches(nccl['launches'])}")
    gloo = mesh["gloo"]
    print(f"mesh gloo: {len(gloo)} ranks on one card, phase "
          f"{mesh['gloo_s']:.1f} s, device budget a rank "
          f"{gloo[0]['budget']} B (MASTIC_DEVICE_BUDGET_BYTES, "
          f"{MESH_BUDGET_SHARE} of the card)")
    print(f"cut: the mesh resident run takes {MESH_LEVELS} of {BITS} "
          f"levels (256 before phase q was added), for time")
    if mesh["levels"] < MESH_LEVELS:
        print(f"cut: the mesh resident run stopped after {mesh['levels']} "
              f"of {BITS} levels, the smoke having run past "
              f"{MESH_CUT_AFTER_S:.0f} s before phase j")
    print(f"cut: the mesh chunked run takes {MESH_CHUNKED_LEVELS} levels "
          f"(16 before phase p was added), for time")
    for (rank, r) in enumerate(gloo):
        res = r["resident"]
        print(f"mesh gloo rank {rank} resident: MasticCount({BITS}), "
              f"{MESH_R} reports ({MESH_R // len(gloo)} a rank), threshold "
              f"{MESH_THRESHOLD}, {res['levels']} levels = numpy's; wall "
              f"{res['wall_s']:.3f} s, rounds {res['rounds_s']:.3f} s, "
              f"padded width {res['max_width']}, device peak {res['peak']} "
              f"B; widest level's mesh {json.dumps(res['mesh'])}; launches "
              f"{launches(res['launches'])}")
        sh = r["sharded"]
        print(f"mesh gloo rank {rank} sharded functions: sharded_gen over "
              f"{sh['rows']} rows = the client shard's, {sh['gen_s']:.3f} "
              f"s; sharded_round at level 0 with the weight check = "
              f"numpy's {sh['level0']}, {sh['round_s']:.3f} s")
        ch = r["chunked"]
        print(f"mesh gloo rank {rank} chunked: {ch['num_chunks']} chunks of "
              f"{MESH_CHUNK} (rows {ch['tile'][0]}-{ch['tile'][1]} of each, "
              f"padded), {ch['levels']} levels = numpy's = the resident "
              f"frontier; wall {ch['wall_s']:.3f} s, rounds "
              f"{ch['rounds_s']:.3f} s; device peak {ch['peak']} B against "
              f"the envelope's pipelined per-shard peak {ch['bound']} B "
              f"(ratio {ch['peak'] / ch['bound']:.4f}); widest level's mesh "
              f"{json.dumps(ch['mesh'])}; launches "
              f"{launches(ch['launches'])}")
        at = r["attributes"]
        print(f"mesh gloo rank {rank} attributes: MasticSum({ATTR_BITS}, "
              f"{SUM_MAX}), {ATTR_R} reports, {ATTR_ASKED} attributes: sums = "
              f"numpy's, accepted {at['accepted']}, rejected_eval_proof "
              f"{at['rejected_eval_proof']}, rejected_weight_check "
              f"{at['rejected_weight_check']}; wall {at['wall_s']:.3f} s, "
              f"round {at['round_s']:.3f} s; mesh {json.dumps(at['mesh'])}; "
              f"launches {launches(at['launches'])}")


def _print_nodes(mesh: dict, phase_e: dict, phase_e_peak: int) -> None:
    """Phase q's lines: each rank's walked and shared nodes, exchange
    bytes and times, round time and device peak (beside phase e's
    single-rank round), and launches."""
    def launches(d: dict) -> str:
        return ", ".join(f"{k} {v}" for (k, v) in d.items() if v)

    def line(rank: int, r: dict) -> str:
        return (f"rank {rank}: walks {r['nodes']} of the round's "
                f"{r['total']} nodes a report ({r['shared']} shared with a "
                f"lower node rank); exchange over {r['preps']} preps "
                f"{r['bytes_sent']} B sent, {r['bytes_received']} B "
                f"received, {r['exchange_ms']:.3f} ms on the card (CUDA "
                f"events), {r['wall_ms']:.3f} ms on the host's clock (to "
                f"host memory {r['to_wire_ms']:.3f}, all_to_all_single "
                f"{r['collective_ms']:.3f}, back {r['from_wire_ms']:.3f}); "
                f"round {r['round_s']:.3f} s, device peak "
                f"{r['peak']} B ({r['peak'] / 2 ** 30:.2f} GiB); "
                f"launches_nodes {launches(r['launches'])}")

    if mesh["nodes_cut"]:
        print(f"cut: phase q's Count run and q2 take {NODES_CUT_R} "
              f"reports, the smoke having run past {NODES_CUT_AFTER_S:.0f} "
              f"s before phase j")
    reference = (f"phase e, one rank: round {phase_e['round_s']:.3f} s, "
                 f"device peak {phase_e_peak} B "
                 f"({phase_e_peak / 2 ** 30:.2f} GiB)")
    for (rank, r) in enumerate(mesh["gloo"]):
        c = r["nodes_count"]
        print(f"nodes q1 count, reports 1 x nodes {NODES_AXIS}: "
              f"MasticCount({BITS}) level {c['level']} from the root, "
              f"{c['prefixes']} prefixes, {c['reports']} reports, "
              f"aggregates = the resident run's, {c['accepted']} accepted; "
              + line(rank, c))
    for (rank, r) in enumerate(mesh["gloo"]):
        a = r["nodes_attributes"]
        print(f"nodes q1 attributes, reports 1 x nodes {NODES_AXIS}: "
              f"MasticSum({ATTR_BITS}, {SUM_MAX}), {a['reports']} reports, "
              f"{ATTR_ASKED} attributes: sums = numpy's, accepted "
              f"{a['accepted']}, rejected_eval_proof "
              f"{a['rejected_eval_proof']}, rejected_weight_check "
              f"{a['rejected_weight_check']}; mesh {json.dumps(a['mesh'])}; "
              + line(rank, a) + f" ({reference})")
    print(f"nodes q2: {NODES_Q2_RANKS} gloo ranks on one card, reports "
          f"{NODES_Q2_RANKS // NODES_AXIS} x nodes {NODES_AXIS}, phase "
          f"{mesh['q2_s']:.1f} s")
    for (rank, a) in enumerate(mesh["q2"]):
        print(f"nodes q2 attributes: {a['reports']} reports: sums = "
              f"numpy's, accepted {a['accepted']}, rejected_eval_proof "
              f"{a['rejected_eval_proof']}, rejected_weight_check "
              f"{a['rejected_weight_check']}; mesh {json.dumps(a['mesh'])}; "
              + line(rank, a) + f" ({reference})")


def _print_launches(counts: dict, result: dict) -> None:
    """One path's launches, split between its shard and its rounds."""
    shard_n = result["shard_launches"]
    print("launches: " + ", ".join(
        f"{name} {shard_n[name]} in the shard + {n - shard_n[name]} in the "
        f"rounds ({(n - shard_n[name]) / result['levels']:.3g} per level)"
        for (name, n) in counts.items() if n))


# -- phase k: the party layer -------------------------------------------

def wire_rows(bm, batch, agg_id: int) -> np.ndarray:
    """Each lane of a device ReportBatch as aggregator `agg_id`'s upload
    blob in the draft's wire layout, (R, report size) uint8: nonce ‖
    public share (packed ctrl bits, seeds, payloads, proofs) ‖ the input
    share (VIDPF key, then the leader's proof share or the helper's
    seed, and for joint-rand circuits the leader's seed and the peer's
    part).  The clients' side of an upload, built from the batch
    instead of one scalar shard a report."""
    (m, spec) = (bm.m, bm.spec)
    num = batch.nonces.shape[0]

    def host(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy().reshape(num, -1)

    cws = batch.cws
    parts = [host(batch.nonces),
             np.packbits(host(cws.ctrl), axis=1, bitorder="little"),
             host(cws.seed), host(spec.plain_to_le_bytes(cws.w)),
             host(cws.proof), host(batch.keys[:, agg_id])]
    if agg_id == 0:
        parts.append(host(spec.plain_to_le_bytes(batch.leader_proofs)))
        if m.valid.JOINT_RAND_LEN > 0:
            parts.append(host(batch.leader_seeds))
    else:
        parts.append(host(batch.helper_seeds))
    if m.valid.JOINT_RAND_LEN > 0:
        parts.append(host(batch.peer_parts[agg_id]))
    return np.concatenate(parts, axis=1)


def upload_bodies(mastic, bm, batch, valid: np.ndarray, reports,
                  lanes: list) -> tuple:
    """Both parties' upload bodies over the lanes whose client shard
    succeeded (a client whose sampling fired shards again with fresh
    randomness; those lanes are not uploaded), after checking the
    helper: on `lanes` each party's row equals `wire.encode_report` of
    the lane's scalar report (`ScalarReports`, tampered as the batch
    is).  Returns (bodies, seconds to encode, seconds of the check)."""
    from mastic_tpu_torch import wire
    from mastic_tpu_torch.drivers.parties import upload_body

    t0 = time.perf_counter()
    rows = [wire_rows(bm, batch, agg_id) for agg_id in range(2)]
    bodies = [upload_body([row.tobytes() for row in r[valid]])
              for r in rows]
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for r in lanes:
        (nonce, public_share, shares) = reports[r]
        for agg_id in range(2):
            want = wire.encode_report(mastic, agg_id, nonce, public_share,
                                      shares[agg_id])
            if rows[agg_id][r].tobytes() != want:
                raise AssertionError(f"lane {r}: the batch's upload blob for "
                                     f"aggregator {agg_id} differs from "
                                     f"wire.encode_report of the lane's "
                                     f"scalar report")
    return (bodies, encode_s, time.perf_counter() - t0)


def party_trace(path) -> dict:
    """What the party processes wrote to their trace file: per party
    its last shutdown step's launches and device peak, and the bytes of
    its last prep-share blob."""
    from mastic_tpu_torch.obs.trace import read_jsonl

    out: dict = {}
    for sp in read_jsonl(str(path)):
        attrs = sp["attrs"]
        if sp["name"] != "party_step":
            continue
        entry = out.setdefault(attrs["party"], {})
        if attrs["step"] == "shutdown":
            entry.update(launches=attrs["launches"],
                         device_peak=attrs.get("device_peak"))
        elif attrs["step"].startswith("prep done"):
            entry["prep_bytes"] = attrs["bytes"]
    for (party, entry) in out.items():
        if "launches" not in entry:
            raise AssertionError(f"the {party} wrote no shutdown step")
    return out


def _trace_to(path) -> None:
    """Aim this process's tracer, and the party processes it starts
    from now on, at `path` (MASTIC_TRACE_FILE)."""
    import os

    from mastic_tpu_torch.obs import trace as obs_trace

    path.parent.mkdir(parents=True, exist_ok=True)
    if path.exists():
        path.unlink()
    os.environ["MASTIC_TRACE_FILE"] = str(path)
    obs_trace.configure()


def _party_idle(name: str, parties: dict, counters: tuple) -> None:
    for (party, entry) in parties.items():
        idle = [c for c in counters if entry["launches"][c] == 0]
        if idle:
            raise AssertionError(f"phase {name}: the {party} launched no "
                                 f"{idle}")


def _check_bytes(name: str, metrics, parties: dict, shares: tuple) -> None:
    """The round's prep-share bytes (what each party's trace says it
    sent) and agg-share bytes against count_round_bytes' model."""
    prep = sum(entry["prep_bytes"] for entry in parties.values())
    if prep != metrics.bytes_prep_shares \
            or sum(map(len, shares)) != metrics.bytes_agg_shares:
        raise AssertionError(f"phase {name}: prep-share bytes {prep} and "
                             f"agg-share bytes {sum(map(len, shares))} are "
                             f"not the model's {metrics.bytes_prep_shares} "
                             f"and {metrics.bytes_agg_shares}")


def party_attributes(dev: torch.device, seed: int, phase_e: dict) -> dict:
    """k1: phase e's attribute deployment through an AggregationSession
    over spawned parties on the card, the helper killed after its prep
    (the session respawns the pair, replays the upload and reruns the
    round)."""
    from mastic_tpu_torch.drivers.parties import AggregationSession

    inputs = attribute_inputs(dev, seed)
    (mastic, bm) = (inputs["mastic"], inputs["bm"])
    valid = inputs["shard_ok"].cpu().numpy()
    tampered = inputs["tampered"]
    lanes = sorted(
        [int(r) for r in inputs["cw_rows"] if valid[r]][:3]
        + [int(r) for r in inputs["proof_rows"] if valid[r]][:3]
        + np.flatnonzero(valid & ~tampered)[:PARTY_LANES - 6].tolist())
    (bodies, encode_s, check_s) = upload_bodies(
        mastic, bm, inputs["batch"], valid, inputs["reports"], lanes)
    trace = PARTY_TRACES / "k1.jsonl"
    _trace_to(trace)
    t0 = time.perf_counter()
    sess = AggregationSession(mastic, {"class": "MasticSum",
                                       "args": [ATTR_BITS, SUM_MAX]},
                              CTX, inputs["vk"], config=party_config(),
                              faults_spec="kill:party=helper:step=prep_done",
                              device=dev)
    try:
        spawn_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sess.coll.upload_encoded(bodies, int(valid.sum()))
        upload_s = time.perf_counter() - t0
        prefixes = tuple(inputs["path_of"][a] for a in inputs["asked"])
        agg_param = (ATTR_BITS - 1, prefixes, True)
        metrics: list = []
        t0 = time.perf_counter()
        (result, accept, shares) = sess.round(agg_param, metrics_out=metrics)
        round_s = time.perf_counter() - t0
        wire_bytes = sess.coll.wire_bytes()
    finally:
        sess.close()
    if sess.counters["respawns"] != 1:
        raise AssertionError(f"k1: {sess.counters['respawns']} respawns, "
                             f"not 1")
    if not np.array_equal(accept, ~tampered[valid]) \
            or not np.array_equal(accept, phase_e["accept"][valid]):
        raise AssertionError("k1: the accept bitmap is not phase e's (every "
                             "report but the tampered ones)")
    want = attribute_sums(inputs["asked"], inputs["path_of"],
                          inputs["alphas"], inputs["weights"],
                          valid & ~tampered)
    if list(zip(inputs["asked"], result)) != want:
        raise AssertionError("k1: per-attribute sums differ from numpy's")
    parties = party_trace(trace)
    _check_bytes("k1", metrics[0], parties, shares)
    _party_idle("k1", parties, ("keccak", "keccak_binder", "level"))
    return {"reports": int(valid.sum()), "lanes": len(lanes),
            "encode_s": encode_s, "check_s": check_s, "spawn_s": spawn_s,
            "upload_s": upload_s, "round_s": round_s, "wire": wire_bytes,
            "parties": parties, "accepted": int(accept.sum()),
            "counters": dict(sess.counters), "metrics": metrics[0]}


def _serve_party(dev: torch.device, args: list) -> subprocess.Popen:
    import os
    import sys

    return subprocess.Popen(
        [sys.executable, "-m", "mastic_tpu_torch.tools.party", "serve",
         "--listen", "127.0.0.1:0", "--device", str(dev), "--once"] + args,
        cwd=pathlib.Path(__file__).resolve().parent,
        env={**os.environ, **party_config().child_env()})


def _port_file(path, proc: subprocess.Popen) -> dict:
    deadline = time.perf_counter() + 300
    while not path.exists():
        if proc.poll() is not None or time.perf_counter() > deadline:
            raise AssertionError(f"network party did not start (rc "
                                 f"{proc.poll()})")
        time.sleep(0.1)
    return json.loads(path.read_text())


def party_count(dev: torch.device, seed: int, phase_a: list) -> dict:
    """k2: phase a's Count cell, walked from the root for its first
    levels over two standalone network parties on the card (plaintext,
    reliable channels), pruning as phase a does, with one connection
    drop injected on the leader's link; every level equal to phase
    a's."""
    from mastic_tpu_torch.backend.mastic import BatchedMastic, MasticCount
    from mastic_tpu_torch.drivers.parties import ProcessCollector

    (alphas, weights, _planted) = measurements(seed)
    mastic = MasticCount(BITS)
    bm = BatchedMastic(mastic)
    (nonces, rand, vk) = _path_inputs(dev, seed + 1, mastic.RAND_SIZE, R)
    meas = [(tuple(bool(b) for b in alphas[r]), int(weights[r]))
            for r in range(R)]
    (batch, shard_ok, shard_s) = _shard(dev, bm, meas, nonces, rand)
    valid = shard_ok.cpu().numpy()
    (bodies, encode_s, check_s) = upload_bodies(
        mastic, bm, batch, valid, ScalarReports(mastic, meas, nonces, rand),
        [int(np.flatnonzero(valid)[0])])
    trace = PARTY_TRACES / "k2.jsonl"
    _trace_to(trace)
    ports = [PARTY_TRACES / f"k2_{name}.json" for name in ("leader",
                                                           "helper")]
    for path in ports:
        if path.exists():
            path.unlink()
    t0 = time.perf_counter()
    procs = [_serve_party(dev, ["--peer-listen", "127.0.0.1:0",
                                "--port-file", str(ports[0])]),
             _serve_party(dev, ["--port-file", str(ports[1])])]
    try:
        (lp, hp) = (_port_file(ports[0], procs[0]),
                    _port_file(ports[1], procs[1]))
        coll = ProcessCollector(
            mastic, {"class": "MasticCount", "args": [BITS]}, CTX, vk,
            config=party_config(),
            faults_spec="conn_drop:party=leader:step=agg_share:nth=2",
            connect={"leader": ("127.0.0.1", lp["listen"]),
                     "helper": ("127.0.0.1", hp["listen"]),
                     "leader_peer": ("127.0.0.1", lp["peer_listen"])})
        try:
            spawn_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            coll.upload_encoded(bodies, int(valid.sum()))
            upload_s = time.perf_counter() - t0
            prefixes = ((False,), (True,))
            metrics: list = []
            t0 = time.perf_counter()
            for (level, (want_prefixes, want)) in enumerate(phase_a):
                (counts, accept, shares) = coll.round(
                    (level, prefixes, level == 0), metrics_out=metrics)
                if [tuple(map(bool, p)) for p in want_prefixes] \
                        != list(prefixes) or counts != want:
                    raise AssertionError(f"k2: level {level} differs from "
                                         f"phase a's")
                if not accept.all():
                    raise AssertionError(f"k2: level {level} rejected "
                                         f"{int((~accept).sum())} reports")
                prefixes = tuple(p + (b,) for (p, c) in zip(prefixes, counts)
                                 if c >= THRESHOLD for b in (False, True))
            round_s = time.perf_counter() - t0
            wire_bytes = coll.wire_bytes()
            reliability = coll.reliability_counters()
        finally:
            coll.close()
        rcs = [proc.wait(timeout=120) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if rcs != [0, 0]:
        raise AssertionError(f"k2: the network parties exited {rcs}")
    if reliability["reconnects"] < 1:
        raise AssertionError("k2: the injected connection drop caused no "
                             "reconnect")
    parties = party_trace(trace)
    _check_bytes("k2", metrics[-1], parties, shares)
    _party_idle("k2", parties, ("keccak", "keccak_binder", "level"))
    return {"reports": int(valid.sum()), "levels": len(phase_a),
            "shard_s": shard_s, "encode_s": encode_s, "check_s": check_s,
            "spawn_s": spawn_s, "upload_s": upload_s, "round_s": round_s,
            "wire": wire_bytes, "parties": parties,
            "reliability": reliability, "max_prefixes": max(
                m.frontier_width for m in metrics)}


def party_histogram(dev: torch.device, seed: int) -> dict:
    """k3: phase c's MasticHistogram reports, one weight-checked round
    from the root at the last level over the 16 planted attributes,
    over spawned parties on the card: the joint-rand seeds through the
    leader's resolve and the helper's confirm."""
    from mastic_tpu_torch.drivers.parties import ProcessCollector

    (bits, length, _chunk) = HIST
    (attrs, alphas, buckets, mastic, bm, vk, meas, nonces, rand, batch,
     shard_ok, shard_s) = histogram_inputs(dev, seed)
    valid = shard_ok.cpu().numpy()
    (bodies, encode_s, check_s) = upload_bodies(
        mastic, bm, batch, valid, ScalarReports(mastic, meas, nonces, rand),
        np.flatnonzero(valid)[:2].tolist())
    trace = PARTY_TRACES / "k3.jsonl"
    _trace_to(trace)
    t0 = time.perf_counter()
    coll = ProcessCollector(mastic, {"class": "MasticHistogram",
                                     "args": list(HIST)}, CTX, vk,
                            config=party_config(), device=dev)
    try:
        spawn_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        coll.upload_encoded(bodies, int(valid.sum()))
        upload_s = time.perf_counter() - t0
        prefixes = tuple(sorted(tuple(bool(b) for b in a) for a in attrs))
        metrics: list = []
        t0 = time.perf_counter()
        (result, accept, shares) = coll.round((bits - 1, prefixes, True),
                                              metrics_out=metrics)
        round_s = time.perf_counter() - t0
        wire_bytes = coll.wire_bytes()
    finally:
        coll.close()
    if not accept.all():
        raise AssertionError(f"k3: {int((~accept).sum())} honest reports "
                             f"rejected")
    want = [np.bincount(buckets[valid & (alphas == np.array(p)).all(axis=1)],
                        minlength=length).tolist() for p in prefixes]
    if result != want:
        raise AssertionError("k3: bucket aggregates differ from numpy's")
    parties = party_trace(trace)
    _check_bytes("k3", metrics[0], parties, shares)
    _party_idle("k3", parties, ("keccak", "keccak_binder_f128",
                                "level_f128"))
    return {"reports": int(valid.sum()), "shard_s": shard_s,
            "encode_s": encode_s, "check_s": check_s, "spawn_s": spawn_s,
            "upload_s": upload_s, "round_s": round_s, "wire": wire_bytes,
            "parties": parties, "accepted": int(accept.sum())}


def party_config():
    from mastic_tpu_torch.drivers.session import SessionConfig

    return SessionConfig(connect_timeout=300.0, exchange_timeout=300.0,
                         ack_timeout=300.0, round_deadline=400.0,
                         shutdown_timeout=60.0, retries=1, backoff=0.5)


def party_phase(dev: torch.device, seed: int, results: dict) -> dict:
    """Phase k: k1, k2 and k3, each with the smoke's own launch counts
    set to 0 before it (the clients' shard runs here; the parties count
    their own)."""
    from mastic_tpu_torch.ops import kernels

    out = {}
    for (name, drive) in (
            ("k1", lambda: party_attributes(dev, seed,
                                            results["attributes"])),
            ("k2", lambda: party_count(dev, seed,
                                       results["count"]["first_levels"])),
            ("k3", lambda: party_histogram(dev, seed))):
        torch.cuda.empty_cache()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out[name] = drive()
        out[name]["phase_s"] = time.perf_counter() - t0
        out[name]["clients"] = dict(kernels.launches)
    return out


def _print_parties(k: dict) -> None:
    def launches(d: dict) -> str:
        return ", ".join(f"{key} {v}" for (key, v) in d.items() if v)

    what = {"k1": f"MasticSum({ATTR_BITS}, {SUM_MAX}) attribute round over "
                  f"{ATTR_ASKED} attributes, AggregationSession, spawned "
                  f"parties, helper killed after its prep",
            "k2": f"MasticCount({BITS}) from the root, levels 0-"
                  f"{k['k2']['levels'] - 1}, network parties (tools.party "
                  f"serve, reliable channels, plaintext), one conn_drop on "
                  f"the leader's link",
            "k3": f"MasticHistogram{HIST} weight check at level "
                  f"{HIST[0] - 1} over {HIST_ATTRS} attributes, spawned "
                  f"parties"}
    for (name, r) in k.items():
        print(f"parties {name}: {what[name]}; {r['reports']} reports; spawn "
              f"{r['spawn_s']:.3f} s; upload {r['encode_s'] + r['upload_s']:.3f}"
              f" s (encode {r['encode_s']:.3f} s, then the parties' decode and "
              f"marshal {r['upload_s']:.3f} s); round{'s' if name == 'k2' else ''}"
              f" {r['round_s']:.3f} s; wire bytes at the collector "
              f"{json.dumps(r['wire'])}; phase {r['phase_s']:.1f} s; helper "
              f"check on {r.get('lanes', 1 if name == 'k2' else 2)} lanes "
              f"{r['check_s']:.3f} s; the clients' shard launched "
              f"{launches(r['clients'])}")
        for (party, entry) in sorted(r["parties"].items()):
            print(f"parties {name} {party}: device peak "
                  f"{entry['device_peak']} B, prep-share blob "
                  f"{entry['prep_bytes']} B; launches "
                  f"{launches(entry['launches'])}")
    k1 = k["k1"]
    print(f"parties k1: respawns {k1['counters']['respawns']}, retries "
          f"{k1['counters']['retries']}; accept bitmap = phase e's "
          f"({k1['accepted']} accepted, the {ATTR_TAMPERED} tampered "
          f"correction words and {ATTR_TAMPERED} tampered proof shares "
          f"rejected); every attribute's sum = numpy's; prep-share bytes "
          f"{k1['metrics'].bytes_prep_shares} and agg-share bytes "
          f"{k1['metrics'].bytes_agg_shares} = count_round_bytes'")
    k2 = k["k2"]
    print(f"parties k2: every level's prefixes and counts = phase a's "
          f"(widest {k2['max_prefixes']} prefixes); reconnects "
          f"{k2['reliability']['reconnects']}, replayed frames "
          f"{k2['reliability']['replayed_frames']}")
    print(f"parties k3: {k['k3']['accepted']} of {k['k3']['reports']} "
          f"reports accepted (joint rand confirmed by both parties); the "
          f"{HIST[1]}-bucket aggregates = numpy's")


# -- phase l: the collector service --------------------------------------

class TenantLaunches:
    """Per tenant, the kernel launches made inside its runs' `step_begin`
    and `step_finish` (under overlap the tenants' rounds interleave, so a
    phase-wide count cannot tell them apart), and every run the service
    built for it, in order.  Installed for phase l1 only."""

    def __init__(self):
        self.launches: dict = {}
        self.runs: dict = {}
        self._saved: list = []

    def __enter__(self) -> "TenantLaunches":
        from mastic_tpu_torch.drivers.attribute_metrics import (
            AttributeMetricsRun)
        from mastic_tpu_torch.drivers.heavy_hitters import HeavyHittersRun
        from mastic_tpu_torch.ops import kernels

        def wrap(orig):
            def wrapped(run, *args, **kwargs):
                before = dict(kernels.launches)
                try:
                    return orig(run, *args, **kwargs)
                finally:
                    tally = self.launches.setdefault(run.obs_tenant, {})
                    for (k, v) in kernels.launches.items():
                        tally[k] = tally.get(k, 0) + v - before[k]
                    runs = self.runs.setdefault(run.obs_tenant, [])
                    if not any(r is run for r in runs):
                        runs.append(run)
            return wrapped

        for cls in (HeavyHittersRun, AttributeMetricsRun):
            for name in ("step_begin", "step_finish"):
                orig = getattr(cls, name)
                self._saved.append((cls, name, orig))
                setattr(cls, name, wrap(orig))
        return self

    def __exit__(self, *exc) -> None:
        for (cls, name, orig) in self._saved:
            setattr(cls, name, orig)


def service_blobs(tenant: dict) -> tuple:
    """A tenant's uploads: each lane whose client shard succeeded as its
    two wire rows framed as `encode_upload` frames them, held against
    `encode_upload` of the lane's scalar report on SERVICE_LANES lanes
    (the tenant's `check` lanes, tampered ones included).  Returns
    (blobs, their lanes, seconds of the check)."""
    from mastic_tpu_torch import wire
    from mastic_tpu_torch.drivers.service import encode_upload

    (rows, valid) = (tenant["rows"], tenant["valid"])
    lanes = np.flatnonzero(valid)
    blobs = [wire.frame(rows[0][r].tobytes()) + wire.frame(
        rows[1][r].tobytes()) for r in lanes]
    pos = {int(r): i for (i, r) in enumerate(lanes)}
    t0 = time.perf_counter()
    for r in tenant["check"]:
        want = encode_upload(tenant["mastic"], tenant["reports"][r])
        if r in pos and blobs[pos[r]] != want:
            raise AssertionError(f"lane {r}: the upload blob built from the "
                                 f"batch differs from encode_upload of the "
                                 f"lane's scalar report")
    return (blobs, lanes, time.perf_counter() - t0)


def _door_ms(mastic, blobs: list, n: int = 256) -> float:
    """The door's decode (`decode_upload`, both views) per upload, in ms,
    over the first n blobs, on this thread."""
    from mastic_tpu_torch.drivers.service import decode_upload

    t0 = time.perf_counter()
    for blob in blobs[:n]:
        decode_upload(mastic, blob)
    return (time.perf_counter() - t0) * 1e3 / min(n, len(blobs))


def _load(port: int, pools: dict, events: list, workers: int) -> dict:
    """The port's LoadGenerator over an explicit schedule: every event at
    t = 0 (the workers send as fast as the front answers), each event's
    client the index of its blob in the tenant's pool, so every valid
    blob is sent once."""
    from mastic_tpu_torch.net.loadgen import LoadGenerator, LoadProfile

    gen = LoadGenerator("127.0.0.1", port, LoadProfile(
        clients=max(len(p["valid"]) for p in pools.values()),
        malformed_frac=0.0, workers=workers), pools, request_timeout=300.0)
    gen.events = events
    return gen.run()


def _fetch(port: int, path: str) -> bytes:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        if resp.status != 200:
            raise AssertionError(f"GET {path} -> {resp.status}")
        return resp.read()


def _check_endpoints(port: int) -> dict:
    """/metrics, /statusz and /varz of the live service carry both
    tenants' series."""
    metrics = _fetch(port, "/metrics").decode()
    for needle in ('mastic_round_wall_ms_bucket{tenant="count"',
                   'mastic_round_wall_ms_bucket{tenant="attrs"',
                   "mastic_chunk_phase_ms_bucket",
                   'mastic_reports_admitted_total{tenant="count"}',
                   'mastic_reports_admitted_total{tenant="attrs"}',
                   'mastic_reports_quarantined_total{tenant="count"',
                   'mastic_reports_quarantined_total{tenant="attrs"',
                   'mastic_rounds_total{tenant="count"}',
                   'mastic_rounds_total{tenant="attrs"}',
                   "mastic_sched_overhead_ms_total{"):
        if needle not in metrics:
            raise AssertionError(f"/metrics lacks {needle!r}")
    statusz = _fetch(port, "/statusz").decode()
    for needle in ("tenant count", "tenant attrs", "quarantine reasons:",
                   "shed=", "occupancy:"):
        if needle not in statusz:
            raise AssertionError(f"/statusz lacks {needle!r}")
    varz = json.loads(_fetch(port, "/varz"))
    tenants = varz.get("service", {}).get("tenants", {})
    if set(tenants) != {"count", "attrs"} or "metrics" not in varz:
        raise AssertionError("/varz lacks the tenants' snapshot")
    return {"metrics_bytes": len(metrics), "statusz_lines":
            statusz.count("\n"), "varz_tenants": sorted(tenants)}


def service_l1(dev: torch.device, results: dict, cut: bool) -> dict:
    """Phase l1 (module docstring): the collector service in this
    process, on the card."""
    import hashlib
    import os
    import shutil

    from mastic_tpu_torch.drivers.service import (CollectorService,
                                                  ServiceConfig, TenantSpec)
    from mastic_tpu_torch.drivers.session import Deadline
    from mastic_tpu_torch.drivers.wal import AdmissionWal, WalConfig
    from mastic_tpu_torch.net.admission import NetConfig
    from mastic_tpu_torch.net.ingest import UploadFront
    from mastic_tpu_torch.net.loadgen import _Event, malform
    from mastic_tpu_torch.obs import devtime
    from mastic_tpu_torch.obs.registry import get_registry
    from mastic_tpu_torch.obs.statusz import StatusServer

    count = dict(results["count"]["service"])
    attrs = dict(results["attributes"]["service"])
    count["check"] = [int(r) for r in np.flatnonzero(count["valid"])
                      [:SERVICE_LANES]]
    attrs["check"] = [int(attrs["cw_rows"][0]), int(attrs["proof_rows"][0]),
                      int(np.flatnonzero(attrs["valid"]
                                         & ~attrs["tampered"])[0])]
    (count_blobs, count_lanes, count_check_s) = service_blobs(count)
    (attr_blobs, attr_lanes, attr_check_s) = service_blobs(attrs)
    door_ms = {"count": _door_ms(count["mastic"], count_blobs),
               "attrs": _door_ms(attrs["mastic"], attr_blobs)}

    if SERVICE_DIR.exists():
        shutil.rmtree(SERVICE_DIR)
    SERVICE_DIR.mkdir(parents=True)
    wal_dir = str(SERVICE_DIR / "wal")
    profile_dir = SERVICE_DIR / "profile"
    specs = [TenantSpec(name="count", spec={"class": "MasticCount",
                                            "args": [BITS]},
                        ctx=CTX, verify_key=count["vk"],
                        thresholds={"default": THRESHOLD},
                        max_buffered=len(count_blobs)),
             TenantSpec(name="attrs", spec={"class": "MasticSum",
                                            "args": [ATTR_BITS, SUM_MAX]},
                        ctx=CTX, verify_key=attrs["vk"],
                        mode="attribute_metrics", attributes=attrs["asked"],
                        max_buffered=len(attr_blobs))]

    def config() -> ServiceConfig:
        return ServiceConfig(page_size=SERVICE_PAGE, max_pending_epochs=4,
                             quarantine_limit=10 ** 6, epoch_deadline=3600.0,
                             overlap=2, ingest_threads=2, ingest_queue=1024)

    svc = CollectorService(specs, config=config(), device=dev)
    wal = AdmissionWal(wal_dir, config=WalConfig(fsync="group", group_ms=2.0),
                       fresh=True)
    front = UploadFront(svc, config=NetConfig(max_connections=64),
                        persist=wal.append_report).start()
    status = StatusServer(port=0).start()
    status.publish(svc.metrics())

    # The load: every valid upload once, about 2% malformed extras.
    rng = np.random.default_rng(11)
    pools = {}
    events = []
    for (name, blobs) in (("count", count_blobs), ("attrs", attr_blobs)):
        bad = max(1, int(round(SERVICE_MALFORMED * len(blobs))))
        picks = rng.choice(len(blobs), bad, replace=False)
        pools[name] = {"valid": blobs,
                       "malformed": [malform(blobs[i], rng) for i in picks]}
        events += [_Event(0.0, name, i, False) for i in range(len(blobs))]
        events += [_Event(0.0, name, j, True) for j in range(bad)]
    events = [events[i] for i in rng.permutation(len(events))]

    def totals() -> dict:
        out = {}
        for (name, t) in svc.metrics()["tenants"].items():
            c = t["counters"]
            out[name] = (c["admitted"], c["quarantined"], c["shed"])
        return out

    before = totals()
    load = _load(front.port, pools, events, workers=8)
    svc.flush_ingest()
    after = totals()
    n_bad = {name: len(p["malformed"]) for (name, p) in pools.items()}
    n_good = {"count": len(count_blobs), "attrs": len(attr_blobs)}
    deltas = {name: tuple(a - b for (a, b) in zip(after[name], before[name]))
              for name in after}
    if load["transport_errors"] or load["codes"] != {"202": len(events)} \
            or any(deltas[n] != (n_good[n], n_bad[n], 0) for n in deltas):
        raise AssertionError(f"l1 load (ingest front armed): codes "
                             f"{load['codes']}, transport errors "
                             f"{load['transport_errors']}, counter deltas "
                             f"{deltas}, sent {n_good} + {n_bad} malformed")
    # The ingest front stopped, a malformed burst is refused at the door.
    svc.stop_ingest()
    burst = [_Event(0.0, name, j, True) for name in pools for j in range(8)]
    before = totals()
    burst_load = _load(front.port, pools, burst, workers=4)
    after = totals()
    deltas2 = {name: tuple(a - b for (a, b) in zip(after[name], before[name]))
               for name in after}
    if burst_load["codes"] != {"400": len(burst)} \
            or any(d != (0, 8, 0) for d in deltas2.values()):
        raise AssertionError(f"l1 burst: codes {burst_load['codes']}, "
                             f"deltas {deltas2}")
    front.stop()

    # One epoch a tenant, the cuts logged first; the first round profiled.
    for name in ("count", "attrs"):
        wal.append_epoch_cut(name)
        svc.begin_epoch(name)
    os.environ["MASTIC_TORCH_PROFILE"] = str(profile_dir)
    devtime.reset_profile_lever()

    def count_rounds(service) -> int:
        ep = service.tenants["count"].active
        if ep is None:
            recs = service.tenants["count"].completed
            return recs[-1]["levels_completed"] if recs else 0
        return ep.run.rounds_completed() if ep.run is not None else 0

    drill = fetched = None
    steps = 0
    torch.cuda.synchronize()
    t_rounds = time.perf_counter()
    with TenantLaunches() as tl:
        while True:
            more = svc.step()
            steps += 1
            os.environ.pop("MASTIC_TORCH_PROFILE", None)
            status.publish(svc.metrics())
            done = count_rounds(svc)
            if drill is None and done >= SERVICE_DRILL_LEVEL:
                # The crash drill: snapshot (the WAL marked covered by
                # it), drop the live service, restore and recover.
                t0 = time.perf_counter()
                wal_before = wal.stats()
                seq = wal.tail_seq()
                blob = svc.to_bytes()
                save_s = time.perf_counter() - t0
                digest = hashlib.sha256(blob).hexdigest()
                wal.mark_covered(seq, digest)
                wal.close()
                del svc
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                t0 = time.perf_counter()
                svc = CollectorService.from_bytes(blob, config=config(),
                                                  device=dev)
                wal = AdmissionWal(wal_dir, config=WalConfig(
                    fsync="group", group_ms=2.0))
                recovery = wal.recover(svc, snapshot_sha256=digest)
                torch.cuda.synchronize()
                drill = {"snapshot_bytes": len(blob), "save_s": save_s,
                         "restore_s": time.perf_counter() - t0,
                         "at_level": done, "recovery": recovery,
                         "wal": wal_before}
                more = not svc.drained()
            if fetched is None and drill is not None \
                    and done >= SERVICE_FETCH_LEVEL:
                fetched = _check_endpoints(status.port)
            if cut and done >= SERVICE_CUT_LEVELS \
                    and svc.tenants["count"].active is not None:
                # The depth cut: the count epoch's deadline, expired
                # now, truncates it at its last completed level.
                svc.tenants["count"].active.deadline = Deadline(0.0)
            if not more:
                break
    torch.cuda.synchronize()
    rounds_s = time.perf_counter() - t_rounds
    overlap = get_registry().gauge("mastic_sched_overlap_efficiency").value()
    status.publish(svc.metrics())
    if fetched is None:
        fetched = _check_endpoints(status.port)
    status.stop()
    wal_stats = wal.stats()
    wal.close()
    if drill is None:
        raise AssertionError("l1: the crash drill never ran")
    traces = sorted(profile_dir.glob("*.json")) if profile_dir.exists() \
        else []
    if len(traces) != 1:
        raise AssertionError(f"l1: {len(traces)} profile traces, not one")
    trace_text = traces[0].read_text()
    if PROFILE_KERNEL not in trace_text:
        raise AssertionError(f"l1: the profiled round's trace does not name "
                             f"K3's kernel ({PROFILE_KERNEL})")

    mx = svc.metrics()["tenants"]
    (crec, arec) = (mx["count"]["epochs"], mx["attrs"]["epochs"])
    if len(crec) != 1 or len(arec) != 1:
        raise AssertionError(f"l1: epochs {crec} {arec}")
    (crec, arec) = (crec[0], arec[0])
    # The count tenant: every level the runs stepped (the first run up
    # to the drill, the restored one after) equals phase a's.
    levels = []
    for run in tl.runs["count"]:
        levels = levels[:run.rounds_completed() - len(run.level_results)] \
            + run.level_results
    want = count["level_results"]
    done = crec["levels_completed"]
    if len(levels) != done or levels != want[:done]:
        raise AssertionError(f"l1 count: {len(levels)} levels, some differ "
                             f"from phase a's")
    planted = sorted(tuple(bool(b) for b in p) for p in count["planted"])
    got = sorted(tuple(p) for p in crec["result"])
    if cut:
        survivors = sorted(p for (p, c) in zip(*want[done - 1])
                           if c >= THRESHOLD)
        if not crec["truncated"] or done != SERVICE_CUT_LEVELS \
                or got != survivors:
            raise AssertionError(f"l1 count (cut): {crec}")
    elif crec["truncated"] or done != BITS or got != planted:
        raise AssertionError(f"l1 count: heavy hitters are not the planted "
                             f"strings ({len(got)} found)")
    # The attrs tenant: phase e's sums, the tampered reports rejected
    # per check.
    valid = attrs["valid"]
    keep = valid & ~attrs["tampered"]
    want_sums = attribute_sums(attrs["asked"], attrs["path_of"],
                               attrs["alphas"], attrs["weights"], keep)
    if [tuple(x) for x in arec["result"]] != want_sums:
        raise AssertionError("l1 attrs: per-attribute sums differ from "
                             "phase e's numpy sums")
    m = next((run.metrics[0] for run in reversed(tl.runs["attrs"])
              if run.metrics), None)
    if m is None or m.accepted != int(keep.sum()) \
            or m.rejected_eval_proof + m.rejected_weight_check \
            + m.rejected_fallback != int((valid & attrs["tampered"]).sum()):
        raise AssertionError(f"l1 attrs: verdicts {m}")
    for name in ("count", "attrs"):
        idle = [c for c in SERVICE_COUNTERS["rounds"]
                if not tl.launches.get(name, {}).get(c)]
        if idle:
            raise AssertionError(f"l1 {name}: rounds launched no {idle}")
    for (name, t) in (("count", count), ("attrs", attrs)):
        idle = [c for c in SERVICE_COUNTERS["shard"]
                if not t["shard_launches"].get(c)]
        if idle:
            raise AssertionError(f"l1 {name}: the clients' shard launched "
                                 f"no {idle}")
    counters = {name: mx[name]["counters"] for name in mx}
    return {"uploads": n_good, "malformed": n_bad, "load": load,
            "burst_codes": burst_load["codes"], "door_ms": door_ms,
            "check_s": count_check_s + attr_check_s,
            "parse_ms": {"count": crec.get("parse_ms"),
                         "attrs": arec.get("parse_ms")},
            "rounds": {name: counters[name]["rounds"] for name in counters},
            "levels": done, "truncated": crec["truncated"],
            "rounds_s": rounds_s, "steps": steps, "drill": drill,
            "overlap_efficiency": overlap, "endpoints": fetched,
            "trace": str(traces[0].relative_to(SERVICE_DIR.parent.parent)),
            "trace_bytes": len(trace_text), "wal": wal_stats,
            "launches": tl.launches,
            "shard_launches": {"count": count["shard_launches"],
                               "attrs": attrs["shard_launches"]},
            "accepted": m.accepted,
            "rejected": (m.rejected_eval_proof, m.rejected_weight_check,
                         m.rejected_fallback),
            "counters": counters}


def service_l2() -> dict:
    """Phase l2: the service tool's smoke gate as a child process on the
    card."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mastic_tpu_torch.tools.serve", "--smoke",
         "--status-port", "0", "--device", "cuda"],
        cwd=pathlib.Path(__file__).resolve().parent, capture_output=True,
        text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    out = json.loads(lines[-1]) if lines else {}
    if proc.returncode != 0 or out.get("ok") is not True:
        raise AssertionError(f"l2: tools.serve --smoke rc={proc.returncode}"
                             f": {proc.stderr[-2000:]}")
    return {"wall_s": time.perf_counter() - t0, "platform": out["platform"],
            "scheduler_rounds": out["scheduler_rounds"],
            "tenants": sorted(out["tenants"])}


def service_phase(dev: torch.device, results: dict, elapsed_s: float
                  ) -> dict:
    """Phase l: l1 then l2, each with the smoke's launch counts set to 0
    before it.  Past SERVICE_CUT_AFTER_S the count tenant's epoch is cut
    to SERVICE_CUT_LEVELS levels."""
    from mastic_tpu_torch.ops import kernels

    cut = elapsed_s >= SERVICE_CUT_AFTER_S
    torch.cuda.empty_cache()
    kernels.reset_launches()
    t0 = time.perf_counter()
    l1 = service_l1(dev, results, cut)
    l1["phase_s"] = time.perf_counter() - t0
    l1["counts"] = dict(kernels.launches)
    l1["cut"] = cut
    l1["elapsed_before_s"] = elapsed_s
    kernels.reset_launches()
    l2 = service_l2()
    return {"l1": l1, "l2": l2}


def _print_service(s: dict) -> None:
    l1 = s["l1"]
    load = l1["load"]
    print(f"service l1: CollectorService on the card, overlap 2, two ingest "
          f"threads, pages of {SERVICE_PAGE}, group-fsync WAL; tenants "
          f"count (MasticCount({BITS}), threshold {THRESHOLD}, "
          f"{l1['uploads']['count']} uploads) and attrs (MasticSum("
          f"{ATTR_BITS}, {SUM_MAX}), {ATTR_ASKED} attributes, "
          f"{l1['uploads']['attrs']} uploads), malformed extras "
          f"{json.dumps(l1['malformed'])}")
    print(f"service l1: admission {load['answered']} PUTs in "
          f"{load['wall_s']:.3f} s ({load['achieved_rate_per_sec']} "
          f"uploads/s, 8 workers), latency ms {json.dumps(load['latency_ms'])}"
          f", codes {json.dumps(load['codes'])} = the counters' deltas; "
          f"burst behind the stopped ingest front codes "
          f"{json.dumps(l1['burst_codes'])}; door decode (decode_upload, "
          f"one thread) count {l1['door_ms']['count']:.3f} ms, attrs "
          f"{l1['door_ms']['attrs']:.3f} ms an upload; epoch device parse "
          f"count {l1['parse_ms']['count']} ms, attrs "
          f"{l1['parse_ms']['attrs']} ms (the restored count epoch's)")
    if l1["cut"]:
        print(f"cut: the service's count epoch stopped by its deadline after "
              f"{SERVICE_CUT_LEVELS} of {BITS} levels: the smoke had run "
              f"{l1['elapsed_before_s']:.0f} s, past "
              f"{SERVICE_CUT_AFTER_S:.0f} s, before phase l")
    d = l1["drill"]
    print(f"service l1: rounds {json.dumps(l1['rounds'])} in "
          f"{l1['rounds_s']:.3f} s ({l1['steps']} scheduler quanta), count "
          f"levels {l1['levels']} = phase a's (truncated {l1['truncated']}), "
          f"attrs sums = phase e's, accepted {l1['accepted']}, rejected "
          f"(eval proof, weight check, fallback) {l1['rejected']}; "
          f"overlap_efficiency {l1['overlap_efficiency']}")
    print(f"service l1: crash drill after count level {d['at_level'] - 1}: "
          f"snapshot {d['snapshot_bytes']} B in {d['save_s']:.3f} s, restore "
          f"+ WAL recovery {d['restore_s']:.3f} s "
          f"({json.dumps(d['recovery'])})"
          f"; the WAL before the drill {json.dumps(d['wal'])}, the "
          f"recovered WAL at the end {json.dumps(l1['wal'])}")
    print(f"service l1: endpoints mid-run {json.dumps(l1['endpoints'])}; "
          f"profile trace {l1['trace']} ({l1['trace_bytes']} B) names "
          f"{PROFILE_KERNEL}")
    for (name, launches) in sorted(l1["launches"].items()):
        print(f"service l1 {name}: rounds launched " + ", ".join(
            f"{k} {v}" for (k, v) in launches.items() if v)
            + "; its clients' shard launched " + ", ".join(
            f"{k} {v}" for (k, v) in l1["shard_launches"][name].items() if v))
    print(f"service l2: tools.serve --smoke --device cuda ok in "
          f"{s['l2']['wall_s']:.1f} s ({s['l2']['scheduler_rounds']} "
          f"scheduler rounds, tenants {s['l2']['tenants']}); phase l "
          f"{l1['phase_s']:.1f} s + {s['l2']['wall_s']:.1f} s")


# -- phase o: the kernel store --------------------------------------------

def _store_child(what: str, out: dict) -> dict:
    """One serve child's figures: time to its first round, its kernel
    loading, and its rounds' inline builds."""
    from mastic_tpu_torch.tools import bake as bake_tool

    ks = out["kernel_store"]
    return {"what": what, "first_round_s": out["first_round_s"],
            "inline_compiles": ks["inline_compiles"],
            "artifact_hits": ks["artifact_hits"],
            "artifact_load_ms": ks["artifact_load_ms"],
            "outcomes": ks.get("outcomes", {}),
            "timings": ks.get("timings", {}),
            "round_inline": bake_tool.epoch_inline_compiles(out)}


def store_phase(dev: torch.device) -> dict:
    """Phase o: bake a kernel store from a fresh build, then serve from
    it in fresh children (module docstring, o1-o4)."""
    from mastic_tpu_torch.drivers import artifacts
    from mastic_tpu_torch.ops import kernels
    from mastic_tpu_torch.tools import bake as bake_tool

    t_start = time.perf_counter()
    sources = len(kernels.SOURCES)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="mastic_store_phase_"))
    try:
        rec = bake_tool.bake(str(tmp / "store"), dev)
        store = artifacts.ArtifactStore(rec["store"])
        for name in kernels.SOURCES:
            entry = store.entry(artifacts.library_key(name))
            if "registers" not in entry["ptxas"]:
                raise AssertionError(f"o: the store's {name} entry holds no "
                                     f"ptxas report")
        children = {}
        # o1: no store, nvcc inline.
        inline = bake_tool.serve_child(
            bake_tool.package_copy(str(tmp / "o1")), [],
            bake_tool.child_env())
        children["o1"] = _store_child("no store, nvcc inline", inline)
        if inline["kernel_store"]["inline_compiles"] != sources:
            raise AssertionError(f"o1: {children['o1']}")
        # o2: the store, nvcc hidden.
        warm_root = bake_tool.package_copy(str(tmp / "o2"))
        warm = bake_tool.serve_child(
            warm_root, ["--artifact-dir", rec["store"]],
            bake_tool.child_env(hide_nvcc=True))
        children["o2"] = _store_child("the store, nvcc hidden", warm)
        problems = bake_tool.compare_children(inline, warm, "o2")
        ks = warm["kernel_store"]
        if ks["inline_compiles"] or ks["artifact_hits"] != sources \
                or any(children["o2"]["round_inline"]) \
                or ks["outcomes"].get("hit", 0) < sources:
            problems.append(f"o2: {children['o2']}")
        # o3: one byte of one blob flipped, nvcc at hand; beside it, o4:
        # killed mid-epoch with a snapshot, resumed from the store.
        shutil.copytree(rec["store"], tmp / "corrupt")
        blob = tmp / "corrupt" / store.entry(
            artifacts.library_key(STORE_CORRUPT))["blob"]
        data = bytearray(blob.read_bytes())
        data[len(data) // 2] ^= 0x40
        blob.write_bytes(bytes(data))
        snap = str(tmp / "serve.snap")

        def kill_and_resume() -> tuple:
            killed = bake_tool.serve_child(
                warm_root, ["--snapshot", snap, "--artifact-dir",
                            rec["store"]],
                bake_tool.child_env(hide_nvcc=True, MASTIC_FAULTS=STORE_KILL),
                check=False)
            if killed["rc"] == 0 or not pathlib.Path(snap).exists():
                raise AssertionError(f"o4: the faulted child was not killed "
                                     f"after a snapshot (rc {killed['rc']})")
            return (killed, bake_tool.serve_child(
                warm_root, ["--snapshot", snap, "--resume", "--artifact-dir",
                            rec["store"]], bake_tool.child_env(hide_nvcc=True)))

        with ThreadPoolExecutor(2) as pool:
            o4 = pool.submit(kill_and_resume)
            bad = bake_tool.serve_child(
                bake_tool.package_copy(str(tmp / "o3")),
                ["--artifact-dir", str(tmp / "corrupt")],
                bake_tool.child_env())
            (killed, resumed) = o4.result()
        children["o3"] = _store_child(
            f"a store with lib{STORE_CORRUPT}.so corrupted, beside o4", bad)
        problems += bake_tool.compare_children(inline, bad, "o3")
        ks = bad["kernel_store"]
        if not ks["outcomes"].get("corrupt") or ks["inline_compiles"] != 1 \
                or ks["artifact_hits"] != sources - 1:
            problems.append(f"o3: {children['o3']}")
        children["o4"] = _store_child("resumed from a kill, the store, nvcc "
                                      "hidden, beside o3", resumed)
        children["o4"]["killed_rc"] = killed["rc"]
        if resumed["results"] != inline["results"]:
            problems.append(f"o4: results diverge: {resumed['results']} != "
                            f"{inline['results']}")
        if resumed["kernel_store"]["inline_compiles"]:
            problems.append(f"o4: {children['o4']}")
        if problems:
            raise AssertionError("o: " + "; ".join(problems))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"bake": rec, "children": children,
            "results": inline["results"],
            "phase_s": time.perf_counter() - t_start}


def _print_store(o: dict) -> None:
    rec = o["bake"]
    print(f"kernel store: baked {rec['entries']} libraries "
          f"({rec['store_bytes']} B) in {rec['wall_seconds']:.3f} s, nvcc "
          f"{rec['build_seconds']:.3f} s ({rec['nvcc']}), runtime "
          f"{rec['runtime']}, key {rec['key']}; each library's kernels = "
          f"its plain versions' probe digests: " + ", ".join(
              f"{name} plain {lib['plain_probe_s']:.3f} s (CPU), kernels "
              f"{lib['kernel_probe_s']:.3f} s"
              for (name, lib) in rec["libraries"].items()))
    for (name, c) in o["children"].items():
        extra = (f", killed first (rc {c['killed_rc']})"
                 if "killed_rc" in c else "")
        print(f"kernel store {name} ({c['what']}{extra}): first round "
              f"{c['first_round_s']:.3f} s after the spawn; inline builds "
              f"{c['inline_compiles']}, store hits {c['artifact_hits']} "
              f"({c['artifact_load_ms']:.3f} ms in lib()), outcomes "
              f"{c['outcomes']}, rounds' inline builds {c['round_inline']}")
        for (lib, t) in sorted(c["timings"].items()):
            print(f"kernel store {name} lib{lib}.so: load (read, digest, "
                  f"dlopen) {t['load_ms']:.3f} ms, probe {t['probe_ms']:.3f} "
                  f"ms")
    print(f"kernel store: o2, o3 and o4 results = o1's {o['results']}; o2's "
          f"per-round counters = o1's")


# -- phase p: the collector service under a report mesh -------------------

def mesh_service_rank(mesh, blobs_path: str, vk: bytes, cut: bool) -> dict:
    """Phase p1 on one rank: a `CollectorService` with phase a's Count
    tenant over the mesh; rank 0 admits the uploads (read from
    `blobs_path`, one fixed-size row each) through its ingest front (its
    queue deep enough for all of them at once) and cuts the epoch; every
    rank steps the scheduler (overlap 2) until it drains.  With `cut`, rank 0 alone expires the epoch's deadline once
    MESH_SERVICE_CUT_LEVELS levels are done.  Returns the rank's epoch
    records (wall times stripped), every level it stepped, and times."""
    from mastic_tpu_torch.drivers.service import (QUEUED, CollectorService,
                                                  ServiceConfig, TenantSpec)
    from mastic_tpu_torch.drivers.session import Deadline
    from mastic_tpu_torch.ops import kernels
    from mastic_tpu_torch.tools.serve import strip_wall

    spec = TenantSpec(name="count", spec={"class": "MasticCount",
                                          "args": [BITS]},
                      ctx=CTX, verify_key=vk,
                      thresholds={"default": THRESHOLD},
                      max_buffered=10 ** 6)
    svc = CollectorService([spec], config=ServiceConfig(
        page_size=SERVICE_PAGE, max_pending_epochs=4,
        quarantine_limit=10 ** 6, epoch_deadline=3600.0, overlap=2,
        ingest_threads=2, ingest_queue=2 * R), mesh=mesh, device=mesh.device)
    admit_s = 0.0
    uploads = 0
    if mesh.rank == 0:
        rows = np.load(blobs_path)
        t0 = time.perf_counter()
        outcomes = [svc.submit("count", row.tobytes()) for row in rows]
        svc.begin_epoch("count")
        admit_s = time.perf_counter() - t0
        uploads = len(rows)
        if any(o[0] != QUEUED for o in outcomes) or svc.metrics()[
                "tenants"]["count"]["counters"]["admitted"] != uploads:
            raise AssertionError(f"p1: rank 0 admitted "
                                 f"{svc.metrics()['tenants']['count']}")
    kernels.reset_launches()
    runs = []
    mesh.broadcast(None)   # every rank's rounds timed from rank 0's cut
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    more = True
    while more:
        more = svc.step()
        epoch = svc.tenants["count"].active
        if epoch is None or epoch.run is None:
            continue
        if not any(r is epoch.run for r in runs):
            runs.append(epoch.run)
        if cut and mesh.rank == 0 \
                and epoch.run.rounds_completed() >= MESH_SERVICE_CUT_LEVELS:
            epoch.deadline = Deadline(0.0)
    torch.cuda.synchronize()
    rounds_s = time.perf_counter() - t0
    records = strip_wall(svc.metrics()["tenants"]["count"]["epochs"])
    return {"records": records, "uploads": uploads, "admit_s": admit_s,
            "levels": [lv for run in runs for lv in run.level_results],
            "rounds_s": rounds_s, "launches": dict(kernels.launches)}


def _tool_child(args: list) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "mastic_tpu_torch.tools.serve", *args],
        cwd=pathlib.Path(__file__).resolve().parent,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _tool_line(what: str, proc: subprocess.Popen, t0: float) -> dict:
    (out, err) = proc.communicate(timeout=900)
    lines = out.strip().splitlines()
    line = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else {}
    if proc.returncode != 0 or line.get("ok") is not True:
        raise AssertionError(f"{what}: rc={proc.returncode}: {err[-2000:]}")
    line["wall_s"] = time.perf_counter() - t0
    return line


def mesh_service_phase(results: dict, serve_results: dict,
                       elapsed_s: float) -> dict:
    """Phase p: p2 (`tools.serve --mesh 1 --backend nccl`, its results
    held against `serve_results`, phase o's serve child's) and p3
    (`tools.serve --overlap-drill`) as children, beside p1 (the service
    over MESH_RANKS gloo ranks sharing the card, `mesh_service_rank`)
    in this process's ranks.  Every level p1 completed must equal phase
    a's, and both ranks' records must be equal."""
    from mastic_tpu_torch.drivers.chunked import _release_pinned
    from mastic_tpu_torch.parallel import spawn

    torch.cuda.empty_cache()
    _release_pinned()
    count = dict(results["count"]["service"])
    count["check"] = [int(r) for r in np.flatnonzero(count["valid"])
                      [:SERVICE_LANES]]
    (blobs, _lanes, _check_s) = service_blobs(count)
    if MESH_SERVICE_DIR.exists():
        shutil.rmtree(MESH_SERVICE_DIR)
    MESH_SERVICE_DIR.mkdir(parents=True)
    blobs_path = str(MESH_SERVICE_DIR / "uploads.npy")
    np.save(blobs_path, np.stack([np.frombuffer(b, np.uint8)
                                  for b in blobs]))
    cut = elapsed_s >= MESH_SERVICE_CUT_AFTER_S
    t_start = time.perf_counter()
    p2 = _tool_child(["--mesh", "1", "--backend", "nccl", "--device",
                      "cuda"])
    p3 = _tool_child(["--overlap-drill", "--device", "cuda"])
    t0 = time.perf_counter()
    ranks = spawn(mesh_service_rank, MESH_RANKS, "gloo", "cuda", blobs_path,
                  count["vk"], cut)
    p1_s = time.perf_counter() - t0
    p2_line = _tool_line("p2: tools.serve --mesh 1 --backend nccl", p2,
                         t_start)
    p3_line = _tool_line("p3: tools.serve --overlap-drill", p3, t_start)
    p1 = [r[0] for r in ranks]
    rec = p1[0]["records"]
    if any(r["records"] != rec for r in p1):
        raise AssertionError(f"p1: the ranks' records differ: "
                             f"{[r['records'] for r in p1]}")
    if len(rec) != 1:
        raise AssertionError(f"p1: epochs {rec}")
    rec = rec[0]
    done = rec["levels_completed"]
    want = count["level_results"]
    for (rank, r) in enumerate(p1):
        if len(r["levels"]) != done or r["levels"] != want[:done]:
            raise AssertionError(f"p1 rank {rank}: {len(r['levels'])} "
                                 f"levels, some differ from phase a's")
        idle = [c for c in SERVICE_COUNTERS["rounds"]
                if not r["launches"].get(c)]
        if idle:
            raise AssertionError(f"p1 rank {rank}: rounds launched no "
                                 f"{idle}")
    got = sorted(tuple(p) for p in rec["result"])
    if cut:
        survivors = sorted(p for (p, c) in zip(*want[done - 1])
                           if c >= THRESHOLD)
        if not rec["truncated"] or done != MESH_SERVICE_CUT_LEVELS \
                or got != survivors:
            raise AssertionError(f"p1 (cut): {rec}")
    else:
        planted = sorted(tuple(bool(b) for b in p) for p in count["planted"])
        if rec["truncated"] or done != BITS or got != planted:
            raise AssertionError(f"p1: heavy hitters are not the planted "
                                 f"strings ({len(got)} found)")
    if rec["reports"] != p1[0]["uploads"]:
        raise AssertionError(f"p1: the epoch holds {rec['reports']} of "
                             f"{p1[0]['uploads']} uploads")
    if p2_line["results"] != serve_results \
            or p2_line["mesh_devices"] != 1:
        raise AssertionError(f"p2: results {p2_line['results']} != phase "
                             f"o's serve child's {serve_results}")
    if not p3_line["kill9_resume_bit_identical"]:
        raise AssertionError(f"p3: {p3_line}")
    return {"p1": p1, "p1_s": p1_s, "cut": cut, "levels": done,
            "truncated": rec["truncated"], "elapsed_before_s": elapsed_s,
            "p2": p2_line, "p3": p3_line,
            "phase_s": time.perf_counter() - t_start}


def _print_mesh_service(p: dict) -> None:
    def launches(d: dict) -> str:
        return ", ".join(f"{k} {v}" for (k, v) in d.items() if v) or "none"

    r0 = p["p1"][0]
    print(f"mesh service p1: CollectorService on {len(p['p1'])} gloo ranks "
          f"sharing the card, overlap 2, pages of {SERVICE_PAGE}; tenant "
          f"count (MasticCount({BITS}), threshold {THRESHOLD}): rank 0 "
          f"admitted {r0['uploads']} uploads in {r0['admit_s']:.3f} s "
          f"(two ingest threads) and cut the epoch, its pages sent at the "
          f"first quantum; {p['levels']} levels = phase a's on every rank "
          f"(truncated {p['truncated']}), the ranks' records equal; p1 "
          f"{p['p1_s']:.1f} s with the spawn")
    if p["cut"]:
        print(f"cut: the meshed service's epoch stopped by rank 0's deadline "
              f"after {MESH_SERVICE_CUT_LEVELS} of {BITS} levels: the smoke "
              f"had run {p['elapsed_before_s']:.0f} s, past "
              f"{MESH_SERVICE_CUT_AFTER_S:.0f} s, before phase p")
    for (rank, r) in enumerate(p["p1"]):
        print(f"mesh service p1 rank {rank}: rounds {r['rounds_s']:.3f} s; "
              f"launches {launches(r['launches'])}")
    p2 = p["p2"]
    print(f"mesh service p2: tools.serve --mesh 1 --backend nccl --device "
          f"cuda ok in {p2['wall_s']:.1f} s (beside p1), results = phase "
          f"o's serve child's; rank launches "
          + "; ".join(launches(d) for d in p2["rank_launches"]))
    p3 = p["p3"]
    print(f"mesh service p3: tools.serve --overlap-drill --device cuda ok "
          f"in {p3['wall_s']:.1f} s (beside p1): burst "
          f"{p3['burst_submitted']} submitted, {p3['burst_admitted']} "
          f"admitted, {p3['burst_queue_shed']} shed at the queue; kill -9 "
          f"and --resume equal the clean child; phase p "
          f"{p['phase_s']:.1f} s")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--levels", type=int, default=BITS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from mastic_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    t0 = time.perf_counter()
    paths = kernels.build()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
          f"{kernels.build_info.get('seconds', 0.0):.1f} s), libraries "
          f"{', '.join(str(p) for p in paths.values())}")
    for name in kernels.SOURCES:
        log = (paths[name].parent / f"{name}.ptxas.txt").read_text()
        func = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                func = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                print(f"ptxas {name} {func}: {line.strip()}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rows = check_kernels(dev, gen) + check_new_shapes(dev, gen) \
        + check_field(dev, gen) \
        + check_from_root(dev, gen, args.seed) \
        + check_phase_n_shapes(dev, gen) \
        + check_node_shapes(dev, gen, args.seed)
    torch.cuda.empty_cache()

    # Each path with every count set to 0 just before it and read just
    # after; each must have launched every kernel it runs.
    (results, counts, peaks) = ({}, {}, {})
    for (name, drive) in (
            ("count", lambda: main_path(dev, args.seed, args.levels)),
            ("count_from_root", lambda: count_from_root(
                dev, results["count"].pop("handoff"))),
            ("sum", lambda: sum_path(dev, args.seed)),
            ("histogram", lambda: histogram_path(dev, args.seed)),
            ("sumvec", lambda: sumvec_path(dev, args.seed)),
            ("attributes", lambda: attributes_path(dev, args.seed)),
            ("attributes_splice", lambda: attributes_splice(
                dev, results["attributes"].pop("handoff"))),
            ("resident_checkpoint", lambda: resident_checkpoint(
                dev, args.seed)),
            ("chunked_checkpoint", lambda: chunked_checkpoint(
                dev, results["resident_checkpoint"].pop("handoff"))),
            ("count_chunked", lambda: count_chunked(
                dev, args.seed, CHUNKED_LEVELS)),
            ("multihot", lambda: multihot_path(dev, args.seed)),
            ("histogram_100k", lambda: histogram_100k(
                dev, args.seed, time.perf_counter() - t_start))):
        torch.cuda.empty_cache()
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        results[name] = drive()
        torch.cuda.synchronize()
        results[name]["path_s"] = time.perf_counter() - t0
        counts[name] = dict(kernels.launches)
        peaks[name] = torch.cuda.max_memory_allocated(dev)
        idle = [c for c in PATH_COUNTERS[name] if counts[name][c] == 0]
        if idle:
            raise AssertionError(f"kernels not launched on the {name} path: "
                                 f"{idle}")
    # Each row's launches: its kernel's counter in the path of its shape.
    row_counter = {
        "keccak_binder_sponge": ("count", "keccak_binder"),
        "keccak_turboshake": ("count", "keccak"),
        "aes_fixed_key_blocks": ("count", "aes"),
        "level_step": ("count", "level"),
        "level_step_sum": ("sum", "level"),
        "level_step_f128_histogram": ("histogram", "level_f128"),
        "level_step_f128_sumvec_depth0": ("sumvec", "level_f128"),
        "keccak_binder_sponge_sum": ("sum", "keccak_binder"),
        "keccak_binder_sponge_f128": ("histogram", "keccak_binder_f128"),
        "aes_fixed_key_blocks_sum": ("sum", "aes"),
        "aes_fixed_key_blocks_histogram": ("histogram", "aes"),
        "aes_fixed_key_blocks_sumvec": ("sumvec", "aes"),
        "level_step_from_root_sum": ("attributes", "level"),
        "level_step_ok_predicate": ("attributes", "level"),
        "keccak_binder_sponge_from_root_sum": ("attributes", "keccak_binder"),
        "keccak_binder_sponge_from_root_sumvec": ("sumvec",
                                                  "keccak_binder_f128"),
        "level_step_f128_multihot": ("multihot", "level_f128"),
        "level_step_f128_histogram_100k": ("histogram_100k", "level_f128"),
        "keccak_binder_sponge_from_root_multihot": ("multihot",
                                                    "keccak_binder_f128"),
        "keccak_binder_sponge_from_root_histogram_100k": (
            "histogram_100k", "keccak_binder_f128"),
        "aes_fixed_key_blocks_multihot": ("multihot", "aes"),
        # Phase q's shapes: their launches are rank 0's in q1's runs.
        "level_step_from_root_sum_node_block": ("nodes_attributes", "level"),
        "level_step_from_root_count_node_block": ("nodes_count", "level"),
        "keccak_binder_sponge_from_root_sum_exchanged": (
            "nodes_attributes", "keccak_binder")}
    for (field, label, _shape, path) in FIELD_ROWS:
        for op in FIELD_OPS:
            row_counter[f"field_{op}_{field}_{label}"] = (
                path, "field_f128" if field == "field128" else "field")
    for row in rows:
        (path, counter) = row_counter[row["name"]]
        row["launches_path"] = path
        if path not in counts:
            continue
        row["launches"] = counts[path][counter]
        # The chunked phases run MasticCount's instantiation only: its
        # rows get their launches there (K2 only where a phase shards).
        if path == "count":
            row["launches_chunked"] = {
                name: counts[name][counter]
                for name in ("count_chunked", "chunked_checkpoint")}
        # K1's bare permutation, counted apart from the sponge: its
        # launches in the main path's run and in every other path's.
        if "permutation" in row:
            per_path = {name: c["keccak_permute"]
                        for (name, c) in counts.items()}
            for perm in (row["permutation"], row["permutation_24_rounds"]):
                perm.update(launches=per_path["count"], launches_path="count",
                            launches_paths=per_path)
            print("K1 permutation launches per path: " + ", ".join(
                f"{name} {n}" for (name, n) in per_path.items()))

    # Phase m, the north-star tool, before the mesh: each run counted
    # from 0 (the mesh run's rank counts its own).
    northstar = northstar_phase(dev, time.perf_counter() - t_start)
    for row in rows:
        if row["launches_path"] == "count":
            counter = row_counter[row["name"]][1]
            row["launches_northstar"] = {
                name: run["launches"][counter]
                for (name, run) in northstar["runs"].items()}

    # Phase j, the mesh, last: its ranks are processes of their own, each
    # with its counts set to 0 before each run.
    mesh = mesh_phase(time.perf_counter() - t_start, args.seed,
                      results["count"]["first_levels"])
    gloo0 = mesh["gloo"][0]
    for row in rows:
        # Rank 0's launches in the gloo resident run (the Count
        # instantiation) or attribute round (MasticSum); phase j runs
        # no Field128 instantiation.
        counter = row_counter[row["name"]][1]
        run = {"count": "resident", "sum": "attributes",
               "attributes": "attributes"}.get(row["launches_path"])
        row["launches_mesh"] = (None if run is None
                                else gloo0[run]["launches"][counter])
        # Phase q: each q1 rank's launches in its Count run (the Count
        # instantiation) or attribute round (MasticSum), and each q2
        # rank's in its attribute round.
        run = {"count": "nodes_count", "sum": "nodes_attributes",
               "attributes": "nodes_attributes",
               "nodes_count": "nodes_count",
               "nodes_attributes": "nodes_attributes"}.get(
                   row["launches_path"])
        if run is not None and row["launches_path"] == run:
            row["launches"] = gloo0[run]["launches"][counter]
        row["launches_nodes"] = None if run is None else {
            "q1": [r[run]["launches"][counter] for r in mesh["gloo"]],
            "q2": (None if run == "nodes_count"
                   else [r["launches"][counter] for r in mesh["q2"]])}

    # Phase k, the party layer, after the mesh: leader and helper as
    # processes of their own on the card, each counting its launches.
    k = party_phase(dev, args.seed, results)
    for row in rows:
        # Each party's launches in the sub-phase of the row's
        # instantiation (MasticCount: k2, MasticSum: k1, Field128: k3);
        # the parties launch no K2 (their AES runs inside K3).
        counter = row_counter[row["name"]][1]
        sub = {"count": "k2", "sum": "k1", "attributes": "k1",
               "histogram": "k3", "sumvec": "k3"}.get(row["launches_path"])
        row["launches_parties"] = None if sub is None else {
            "phase": sub, **{
                party: entry["launches"][counter]
                for (party, entry) in sorted(k[sub]["parties"].items())}}

    # Phase l, the collector service.
    service = service_phase(dev, results, time.perf_counter() - t_start)

    # Phase o, the kernel store, last: fresh children, each with its own
    # kernel loading.
    torch.cuda.empty_cache()
    store = store_phase(dev)
    tenant_of = {"count": "count", "sum": "attrs", "attributes": "attrs"}
    for row in rows:
        counter = row_counter[row["name"]][1]
        tenant = tenant_of.get(row["launches_path"])
        row["launches_service"] = (
            None if tenant is None
            else service["l1"]["launches"].get(tenant, {}).get(counter, 0))

    # Phase p, the service under a report mesh, after o: its ranks and
    # children are processes of their own, each counting its launches.
    meshed = mesh_service_phase(results, store["results"],
                                time.perf_counter() - t_start)
    for row in rows:
        # Each p1 rank's launches in the Count tenant's rounds.
        counter = row_counter[row["name"]][1]
        row["launches_mesh_service"] = (
            [r["launches"][counter] for r in meshed["p1"]]
            if row["launches_path"] == "count" else None)

    result = results["count"]
    if result["levels"] < BITS:
        print(f"cut: the collection stopped after {result['levels']} of "
              f"{BITS} levels (--levels); the frontier there matched numpy")
    print(f"main path: MasticCount({BITS}), {R} reports, threshold "
          f"{THRESHOLD}, {result['levels']} levels, {result['heavy_hitters']} "
          f"heavy hitters = the planted strings")
    print(f"rejected reports (excluded from the aggregates): "
          f"{result['rejected']} ({result['shard_rejected']} at sharding); "
          f"XOF fallbacks spliced through the scalar layer: "
          f"{result['xof_fallbacks']}")
    print(f"shard: {result['shard_s']:.3f} s; rounds: "
          f"{result['rounds_s']:.3f} s; node evals (both aggregators): "
          f"{result['padded_evals']} computed "
          f"({result['padded_evals'] / result['rounds_s']:.4g} evals/s), "
          f"{result['live_evals']} under live parents "
          f"({result['live_evals'] / result['rounds_s']:.4g} evals/s)")
    _print_launches(counts["count"], result)
    print(f"peak device memory: {peaks['count']} B "
          f"({peaks['count'] / 2 ** 30:.2f} GiB); largest frontier "
          f"{result['max_frontier']} prefixes, padded width "
          f"{result['max_width']}")
    result = results["count_from_root"]
    print(f"count from the root: level {result['level']} ({result['prefixes']} "
          f"prefixes, {result['nodes']} nodes a report) as one run_round: "
          f"aggregates = the incremental runner's, {result['accepted']} "
          f"reports accepted; round {result['round_s']:.3f} s; peak device "
          f"memory {peaks['count_from_root']} B "
          f"({peaks['count_from_root'] / 2 ** 30:.2f} GiB); launches "
          + ", ".join(f"{k} {v}" for (k, v) in
                      counts["count_from_root"].items() if v))

    result = results["sum"]
    print(f"cut: the sum path takes {SUM_LEVELS} of {BITS} levels (all "
          f"{BITS} before phase q was added), for time")
    print(f"sum path: MasticSum({BITS}, {SUM_MAX}) through "
          f"HeavyHittersRun, {R} reports (weights uniform in [0, "
          f"{SUM_MAX}]), threshold {SUM_THRESHOLD}, {result['levels']} "
          f"levels, {result['heavy_hitters']} heavy hitters (lightest "
          f"planted weight {result['planted_weight']}); every level's "
          f"weighted counts and survivors = numpy's")
    print(f"sum path: rejected {result['rejected']} "
          f"({result['shard_rejected']} at sharding), XOF fallbacks spliced "
          f"{result['xof_fallbacks']}; shard "
          f"{result['shard_s']:.3f} s; rounds {result['rounds_s']:.3f} s; "
          f"{result['live_evals']} node evals under live parents "
          f"({result['live_evals'] / result['rounds_s']:.4g} evals/s); "
          f"largest frontier {result['max_frontier']} prefixes; peak device "
          f"memory {peaks['sum']} B ({peaks['sum'] / 2 ** 30:.2f} GiB)")
    _print_launches(counts["sum"], result)

    result = results["histogram"]
    print(f"histogram path: MasticHistogram{HIST}, {R} reports over "
          f"{HIST_ATTRS} attributes, {result['levels']} levels of the "
          f"resident runner, every level's {HIST[1]}-bucket aggregates = "
          f"numpy's; rejected {result['rejected']} "
          f"({result['shard_rejected']} at sharding), XOF fallbacks spliced "
          f"{result['xof_fallbacks']}; shard "
          f"{result['shard_s']:.3f} s; rounds {result['rounds_s']:.3f} s; "
          f"padded width {result['max_width']}; peak device memory "
          f"{peaks['histogram']} B ({peaks['histogram'] / 2 ** 30:.2f} GiB)")
    _print_launches(counts["histogram"], result)

    result = results["sumvec"]
    print(f"sumvec path: MasticSumVec{SUMVEC}, {R} reports: shard "
          f"{result['shard_s']:.3f} s (cws.w {result['cws_w_bytes']} B), "
          f"weight check of both aggregators from their depth-0 payloads "
          f"{result['check_s']:.3f} s, {result['accepted']} of {R} honest "
          f"reports accepted ({result['shard_rejected']} rejected at "
          f"sharding); peak device memory {peaks['sumvec']} B "
          f"({peaks['sumvec'] / 2 ** 30:.2f} GiB); launches "
          + ", ".join(f"{k} {v}" for (k, v) in counts["sumvec"].items()))
    print(f"cut: sumvec from the root over the first {SUMVEC_ROOT_R} of the "
          f"{R} reports, for time")
    print(f"sumvec from the root: {SUMVEC_ASKED} attributes over "
          f"{SUMVEC_ROOT_R} reports from a pinned HostReportStore "
          f"({result['store_bytes']} "
          f"B, {result['store_s']:.3f} s to fill) in "
          f"{result['root_chunks']} chunks of {SUMVEC_CHUNK} "
          f"({result['root_mode']}, overlap efficiency "
          f"{result['root_overlap']}), {result['root_in_set']} of them in "
          f"the set, {result['root_nodes']} nodes a report; each "
          f"attribute's {SUMVEC[1]}-entry vector = numpy's, "
          f"{result['root_accepted']} reports accepted; round "
          f"{result['root_s']:.3f} s; peak device memory of the round "
          f"{result['root_peak']} B ({result['root_peak'] / 2 ** 30:.2f} "
          f"GiB)")
    print("sumvec from the root, per chunk on the card (ms): " + "; ".join(
        ", ".join(f"{k} {v:.3f}" for (k, v) in d.items())
        for d in result["root_device_ms"]))
    result = results["attributes"]
    print(f"attributes path: MasticSum({ATTR_BITS}, {SUM_MAX}), {ATTR_R} "
          f"reports ({result['in_set']} with one of the {ATTR_ASKED} "
          f"attributes of interest), {result['nodes']} nodes a report; "
          f"every attribute's sum = numpy's; {ATTR_TAMPERED} tampered "
          f"correction words and {ATTR_TAMPERED} tampered proof shares: "
          f"rejected_eval_proof {result['rejected_eval_proof']}, "
          f"rejected_weight_check {result['rejected_weight_check']}, "
          f"accepted {result['accepted']}, xof_fallbacks "
          f"{result['xof_fallbacks']} ({result['shard_rejected']} at "
          f"sharding); shard {result['shard_s']:.3f} s; round "
          f"{result['round_s']:.3f} s ({result['node_evals']} node evals, "
          f"{result['node_evals'] / result['round_s']:.4g} evals/s); peak "
          f"device memory {peaks['attributes']} B "
          f"({peaks['attributes'] / 2 ** 30:.2f} GiB); launches "
          + ", ".join(f"{k} {v}" for (k, v) in counts["attributes"].items()
                      if v))
    result = results["attributes_splice"]
    print(f"cut: the forced splice from the root asks {result['asked']} of "
          f"the {ATTR_ASKED} attributes, for time (its scalar prep of the "
          f"forced lanes scales with them), held against an unforced round "
          f"over the same {result['asked']}")
    print(f"forced splice from the root: the attributes round again with "
          f"lanes {result['lanes']} (an honest report, a tampered proof "
          f"share) cleared after the prep; their scalar reports marshal to "
          f"the batch's rows ({result['scalar_shard_s']:.3f} s for both "
          f"scalar shards); result = the unforced round's = numpy's, "
          f"xof_fallbacks {result['xof_fallbacks']}, accepted "
          f"{result['accepted']}, rejected_fallback "
          f"{result['rejected_fallback']} by "
          f"{result['rejected_fallback_by']}; round {result['round_s']:.3f} "
          f"s of which the scalar splice {result['splice_ms'] / 1e3:.3f} s; "
          f"phase {result['path_s']:.3f} s")
    result = results["resident_checkpoint"]
    print(f"cut: the resident checkpoint forces its lanes at levels "
          f"{CKPT_FORCED_LEVELS} (0 and 9 before phase p was added: 23 "
          f"scalar rounds of the splice, now 9), for time")
    print(f"resident checkpoint: MasticCount({CKPT_BITS}), {R} reports "
          f"(depth cut from {BITS} to {CKPT_BITS}), largest frontier "
          f"{result['max_frontier']}, {result['heavy_hitters']} heavy hitters "
          f"= the planted strings; lanes forced at levels {result['lanes']}, "
          f"checkpoint after level {CKPT_SPLIT - 1} ({result['ckpt_bytes']} "
          f"B, {result['save_s']:.3f} s to write, {result['restore_s']:.3f} s "
          f"to restore on the card); every level = the unforced run's = "
          f"numpy's; unforced run {result['unforced_s']:.3f} s, forced run "
          f"with the checkpoint {result['forced_s']:.3f} s of which the "
          f"scalar splices {result['splice_ms'] / 1e3:.3f} s; phase "
          f"{result['path_s']:.3f} s")
    result = results["chunked_checkpoint"]
    print(f"chunked checkpoint: MasticCount({CKPT_BITS}), {R} reports in "
          f"{result['chunks']} chunks of {CKPT_CHUNK}, pipelined, checkpoint "
          f"after level {CKPT_SPLIT - 1} ({result['ckpt_bytes']} B, "
          f"{result['save_s']:.3f} s to write, {result['restore_s']:.3f} s "
          f"to restore on the card); all {result['levels']} levels = the "
          f"resident run's, {result['heavy_hitters']} heavy hitters; run "
          f"{result['run_s']:.3f} s; peak device memory "
          f"{peaks['chunked_checkpoint']} B; launches " + ", ".join(
              f"{k} {v}" for (k, v) in counts["chunked_checkpoint"].items()
              if v))
    result = results["count_chunked"]
    print(f"count chunked: MasticCount({BITS}), {result['reports']} reports "
          f"in chunks of {CHUNKED_CHUNK}, threshold {CHUNKED_THRESHOLD}, "
          f"{result['levels']} levels, every level = numpy's count; host "
          f"memory available {result['avail']} B, needed {result['need']} B")
    if result["reports"] < CHUNKED_R:
        print(f"cut: R is {result['reports']}, not {CHUNKED_R}: the host "
              f"cannot hold the carries and the store")
    print(f"cut: R is {result['reports']} of the north star's 1M reports, "
          f"for host memory and time")
    print(f"cut: levels are {result['levels']} of {BITS}, for time; bits "
          f"({BITS}) and frontier width (up to {result['max_width']}) are "
          f"full")
    print(f"count chunked: shard {result['shard_s']:.3f} s (batches of {R}); "
          f"pinned store {result['store_bytes']} B filled in "
          f"{result['store_s']:.3f} s; runner set-up (pinned carries, round "
          f"keys) {result['init_s']:.3f} s; rounds {result['rounds_s']:.3f} "
          f"s; host bytes {result['host_bytes']}; rejected "
          f"{result['rejected']}, XOF fallbacks {result['xof_fallbacks']}")
    print(f"count chunked: device peak {peaks['count_chunked']} B over the "
          f"phase, {result['peak']} B over the rounds; the envelope's "
          f"pipelined per-chunk peak {result['bound']} B (ratio "
          f"{result['peak'] / result['bound']:.4f})")
    # The resident runner at this R: its carries alone, and the resident
    # Count path's measured peak (4096 reports, all 256 levels) scaled
    # linearly in R, beside the card's memory.
    scaled = peaks["count"] * result["reports"] // R
    print(f"count chunked: a resident run of the same R holds "
          f"{result['resident_carries']} B of carries at width "
          f"{result['max_width']} (per_report_bytes), and the resident Count "
          f"path's peak ({peaks['count']} B at {R} reports) scaled x"
          f"{result['reports'] // R} is {scaled} B, against the card's "
          f"{torch.cuda.get_device_properties(dev).total_memory} B")
    for lv in result["per_level"]:
        moved = lv["carry_bytes"] * (-(-result["reports"] // CHUNKED_CHUNK))
        print(f"count chunked level {lv['level']}: {lv['s']:.3f} s, width "
              f"{lv['width']}, {lv['mode']}, overlap efficiency "
              f"{lv['overlap']} (host phases), {lv['device_overlap']} (the "
              f"card's streams); on the card: uploads {lv['upload_ms']:.3f} "
              f"ms, compute {lv['compute_ms']:.3f} ms, downloads "
              f"{lv['download_ms']:.3f} ms; carries {moved} B each way "
              f"({moved / lv['upload_ms'] / 1e6:.3f} GB/s up, "
              f"{moved / lv['download_ms'] / 1e6:.3f} GB/s down)")
    _print_launches(counts["count_chunked"], result)
    _print_phase_n(results, peaks, counts)
    _print_northstar(northstar)
    _print_mesh(mesh)
    _print_nodes(mesh, results["attributes"], peaks["attributes"])
    _print_parties(k)
    _print_service(service)
    _print_store(store)
    _print_mesh_service(meshed)
    print("path seconds: " + ", ".join(
        f"{name} {r['path_s']:.1f}" for (name, r) in results.items())
        + ", " + ", ".join(
            f"northstar {name} {r['wall_s']:.1f}"
            for (name, r) in northstar["runs"].items())
        + f", mesh {mesh['nccl_s'] + mesh['gloo_s']:.1f} (phase q1 among "
        f"it), nodes q2 {mesh['q2_s']:.1f}, parties "
        + ", ".join(f"{name} {r['phase_s']:.1f}" for (name, r) in k.items())
        + f", service "
        f"{service['l1']['phase_s'] + service['l2']['wall_s']:.1f}"
        + f", store {store['phase_s']:.1f}"
        + f", mesh service {meshed['phase_s']:.1f}")
    print(f"smoke: {time.perf_counter() - t_start:.1f} s in all")
    print("kernel store outcomes (phase o's children, beside the kernels "
          "line): " + json.dumps({name: c["outcomes"] for (name, c) in
                                  store["children"].items()}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

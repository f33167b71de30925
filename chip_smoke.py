#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (seaweedfs_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--workdir DIR] [--phases 1,2,...]

Phases, each fatal on failure (the script exits non-zero and prints no
result). `--phases` runs a subset (default: all); phase 1 always runs, and
the kernels line needs phases 3, 4 and 6 to 16. The kernels of the
phases asked for are built first, all at once (one nvcc per source).

1. device: card name, count, `nvidia-smi` name and power limit;
2. build: kernel K1 (csrc/rs_gf.cu) with nvcc, what ptxas says of it, and
   an opcode histogram of its machine code (cuobjdump);
3. K1 against its plain PyTorch version on the card, byte for byte, at
   (10,4), (14,2), (5,3), (4,2) x C in {16, 48, 100, 384, 4112, 65536,
   65552} (the edges of a thread's 32-byte span) with several loss
   patterns, the seeded entries, batches of 1 and 3 and single stripes,
   the apply entry at the msr codec's solve and repair matrices of (10,4)
   and (14,2), and the main shape [32, 10, 1 MiB];
4. K1's time (CUDA events over many launches, each with another seed),
   its HBM bound and the plain version's time at the main shape, for all
   four entries; encode and reconstruct at RS(14,2) [32, 14, 1 MiB]; at
   the main shape, reconstruct of 2 and of 1 lost shard (how the time
   scales with the outputs), the apply entry at the msr seal's shape
   ([2, 14] over [14, 256 x 16 KiB]) and a device copy of the input (the
   card's reachable memory rate); the SM clock, power and temperature
   around;
5. entry(): ECPipeline(10, 4).forward on [8, 10, 65536] through K1;
6. the main path at real size: ec encode of a 10 GiB + 3 MiB + 12,345 B
   RS(10,4) volume and two 256 MiB volumes in one job (1 GiB / 1 MiB
   blocks), a seeded sample of stripes against the plain version on the
   CPU, loss of shards (0, 5, 10, 13), rebuild, decode, byte comparison
   with the sources; then the same round trip at RS(14,2) on three
   300 MiB + ragged-tail volumes. K1's launch counts are zeroed just
   before this phase and read just after;
7. kernel K3 (csrc/crc32c.cu, batched raw CRC32C states): what ptxas says
   of it (registers, spills) and its shared memory per block; K3 against
   its plain PyTorch version on the card, bit for bit, at B in {1, 3, 4096,
   4225} x L in {0, 512, ..., 1 MiB} with rows of zeros, 0xFF and random
   bytes (4225 rows are more tasks than an H100 holds resident warps, so
   the grid-stride loop runs; [1, 1 MiB] splits its row into 512 segments);
   a non-contiguous input must raise; after
   finalize, against the host CRC on seeded needles. K3's time (CUDA
   events over launches queued back to back, each on another input), its
   HBM bound, the plain version's time and a device copy of the input at
   [4096, 2048] (the scrub's batch), [16384, 4096] and [64, 1 MiB]; the SM
   clock and power around;
8. the scrub main path at deployment size: one Volume of 1,048,576
   needles of 1024 + 0..63 B (weed benchmark's default write set) written
   through Volume.write_needles; 16 data bytes and one stored CRC of live
   needles flipped, 64 needles overwritten (8 of their old records then
   flipped), 64 deleted; scrub_volume(device="cuda") must report exactly
   the 17 damaged ids, with the scanned and checked counts of
   device="off". Every launch count is zeroed just before the cuda scrub
   and read just after; K3 must have launched;
9. EC volumes served from a Store: servers A and B, each a Store on the
   card (coder "torch", kernel K1); 524,288 needles of 1024 + 0..63 B
   (half of weed benchmark's write set: phase 13 runs the same flow at
   full size) written on A through Store.write_needles_bulk,
   Store.generate_ec_shards at RS(10,4) (1 GiB / 1 MiB blocks), shards 7-13
   with copies of the .ecx and .vif moved to B, the source volume deleted,
   both mounted. A seeded sample of 16,384 needles read on A through
   Store.read_needle with the shard reader of server/volume_server.py
   (fetching B's shards from B) healthy, then again after shards (0, 5)
   are lost on A and (10, 13) on B: every payload must equal what was
   written, and the reconstructs must number the sampled intervals on lost
   shards. Then A rebuilds (0, 5) and B rebuilds (10, 13), each with the
   other's shards as remote survivors, to the shards' hashes; a needle
   deleted through the EC volume must read as KeyError; both heartbeats'
   ec_index_bits; B's data shards copied to A and ec_shards_to_volume
   must give back the source .dat's hash and the sample. K1's launch
   counts are zeroed just before this phase and read just after; then,
   outside the counts, the costs of one degraded interval's K1 call at
   [10, ~1 KB] are timed;
10. tiered volumes, on one Store with an `ssd` and an `hdd` location and a
   remote tier `local:<workdir>/tier` (storage/backend.LocalDirRemote, its
   object reads counted): a quarter of the write set of phase 13 (262,144
   needles of 1024 + 0..63 B; depth cut to keep the whole within its time,
   from half when phase 15 came)
   written on `ssd`, 64 needles deleted and 64 overwritten,
   VacuumVolumeCompact + Commit through the RPC bodies of a
   server/volume_server.VolumeServer over that Store (garbage 0, the .dat
   shrunk by exactly the dead records); Store.move_volume_local to `hdd`;
   the .dat tiered up (its VolumeTierMoveDatToRemote) and a seeded sample of 16,384
   needles read through storage/backend.RemoteDatFile; scrub_volume of the
   tiered volume must be "skipped-tiered" with no K3 launch and no remote
   read; a second Store over the same directories loads it; the .dat tiered
   down (its VolumeTierMoveDatFromRemote) and scrubbed through K3 (K3's count
   zeroed just before, read just after; 0 corrupt, every live needle
   checked). Then EC at the fork's RS(14,2) (1 GiB / 1 MiB blocks), shards
   (0, 5) lost, the 14 others offloaded to the tier; the sample read
   through Store.read_needle with server/volume_server.make_shard_reader
   (no peers): healthy intervals from the tier, intervals on (0, 5)
   reconstructed through K1 at one stripe [1, 14, ~1 KB] from 14 survivors
   on the tier, the reconstructs numbering the sampled intervals on (0, 5);
   (0, 5) rebuilt from the tier (K1 at [32, 14, 1 MiB] -> 2 rows) to their
   hashes; promote_ec_shards back to all 16 hashes with an empty tier;
   ec_shards_to_volume to the .dat's hash. K1's counts are zeroed before
   the EC steps and read after; then K1 at one stripe [1, 14, ~1 KB] is
   timed;
11. the layered codecs at deployment size, on one Store on the card: the
   write set of phase 9 (524,288 needles; the full 1,048,576 until phase 15
   took the time) written once and encoded twice. (a) msr at the
   fork's RS(14,2) (1 GiB / 1 MiB blocks, alpha 256): generate_ec_shards
   (plain-RS slabs through K1 encode, then the msr overlay through K1's
   apply entry), a seeded sample of sub-symbol columns against the plain
   version on the CPU; a 4,096-needle sample read healthy, then with shard
   5 lost (repair-plane plans, all 15 helpers present); shard 5 rebuilt on
   the single-loss ranged path, reading exactly
   repair_read_bytes("msr", 14, 2, [5], shard) = 7.5 shards, to its hash;
   shards (0, 14) lost, their sampled needles read (general plans), a
   general rebuild to their hashes; ec_shards_to_volume to the .dat's
   hash. (b) piggyback at RS(10,4) on the decoded volume: shards (3, 7)
   lost (the survivors used take piggybacked parity 11, so b-half
   intervals strip it), their sampled needles read, a general rebuild to
   the hashes; shard 3 alone rebuilt on the ranged path reading exactly
   0.70 of plain RS. Every K1 call on the card is timed with CUDA events
   by entry; K1's counts are zeroed just before the phase and read just
   after, and encode, reconstruct and apply must all have launched;
12. the multi-device EC step on a 1x1 mesh over NCCL (parallel/mesh.py,
   parallel/pipeline.py; a world of one on this card, as the reference's
   build_mesh gives on one chip): ECPipeline.step at RS(10,4)
   [32, 10, 1 MiB] with (0, 5, 10, 13) lost and at RS(14,2) [32, 14, 1 MiB]
   with (0, 5) lost, mismatch 0; a 1,145,031,680 B .dat (the size of
   weed benchmark's write set)
   through ec/stream.encode_volumes with MeshCoder at RS(10,4), 1 GiB /
   1 MiB blocks, batch 32; the mesh-wide scrub of 1,048,576 needles of
   1024 + 0..63 B in [4096, 2048] batches against their stored CRC states,
   17 of them damaged, which the all_reduce must count exactly. K1's and
   K3's counts are zeroed just before these three and read just after.
   Then, outside the counts: the same .dat through TorchCoder, every shard's
   sha256 equal; the step's time by CUDA events beside forward +
   reconstruct of the same shapes without the mesh; NativeCoder (the port's
   AVX2 CPU coder) on [32, 10, 1 MiB] byte-equal to K1, both timed, with
   the host's CPU model; entry.dryrun_multichip(1) on one launched rank;
13. the volume server on the card (server/volume_server.py): servers A, B
   and C, each a VolumeServer over a Store on the card (coder "torch",
   RS(10,4), 1 GiB / 1 MiB blocks) with its HTTP plane on a localhost
   port, joined by one LocalPeers. Phase 9's write set on A through
   Store.write_needles_bulk, then 4,096 needles POSTed over HTTP, each
   acknowledged and read back by GET; VolumeMarkReadonly and
   VolumeEcShardsGenerate (K1 encode); VolumeEcShardsCopy of shards 7-13
   with the .ecx and .vif to B through CopyFile on the peer plane, both
   mounted, 7-13 deleted on A, the source volume deleted. A seeded sample
   of 4,096 needles (16,384 until the replicated data plane's phase took
   the time; a smaller depth of this earlier path, the needles' sizes
   unchanged) GET from A by one keep-alive client, a quarter with a
   Range header, healthy, then after VolumeEcShardsDelete of (0, 5) on A
   and (10, 13) on B: every body equal, the reconstructs (K1 at one
   stripe) numbering the sampled intervals on lost shards; then the
   degraded reads again with A's shard reads over gRPC (grpc_service on A
   and B; the holder lookup from the heartbeats, as no master runs). Shard
   8 moved B -> C by VolumeEcShardsMove on C behind A's location cache:
   its reads refresh the stale locations and fetch from C without a
   reconstruct. B rebuilds (10, 13) by VolumeEcShardsCopyByRebuild and A
   (0, 5) by VolumeEcShardsRebuild (K1 at [32, 10, 1 MiB]) with the
   others' shards as remote survivors, to the shards' hashes. With B's
   breaker open, reads of its shards succeed through the last probe.
   VolumeEcBlobDelete then GET 404; the data shards copied to A and
   VolumeEcShardsToVolume to the .dat's hash, the sample by GET. A regular
   volume of 262,144 needles on C damaged as phase 8 does: VolumeScrub
   with device "" reports exactly the 17 through K3, "auto" the same,
   "off" the same counts in mode cpu. K1's and K3's counts are zeroed just
   before the phase and read just after; then K1 at the degraded reads'
   one-stripe width is timed;
14. the replicated data plane (server/volume_server.py with
   client/http_util.py, storage/bulk.py and the read cache): servers A, B
   and C, each a VolumeServer over a Store on the card, joined by one
   LocalPeers that answers lookup_volume from their heartbeats; the replica
   hops are HTTP over loopback. A fresh "001" volume on A and B; a quarter
   of the write set (262,144 needles of 1024 + 0..63 B, `weed benchmark
   -size 1024`'s needles; the full 1,048,576 until phase 15 took the time,
   half until phase 16 did) PUT to
   A by one client as /bulk frames of 1,024 needles, each frame replicated
   to B in one hop; A's and B's .idx equal by
   sha256. 4,096 POSTs through A, each read back from B; 256 DELETEs, 404 on
   both; one ?type=replicate POST on B lands on B alone. 4,096 sampled GETs
   from A twice: 0 read-cache hits in the first pass, 4,096 in the second.
   1,024 of them GET from C (proxied to a holder, a quarter ranged), then C
   in redirect mode answers 301 to a holder. /bulk-read of a 16,384-needle
   sample from B in frames of 256. VolumeScrub of B's copy with device ""
   (K3): every live needle, 0 corrupt. B's copy sealed by
   VolumeEcShardsGenerate at RS(10,4) (K1 encode), mounted, both plain
   copies deleted, shards (0, 5, 10, 13) deleted: the /bulk-read sample
   again, every body equal and the reconstructs (K1 at one stripe)
   numbering the sampled intervals on lost shards. K1's and K3's counts are
   zeroed just before the phase and read just after;
15. the maintenance plane (server/volume_server.py with qos/, query/ and
   the gRPC binding): servers A, B and C on the card, each served over gRPC
   under mTLS (a CA and a cluster certificate made with openssl; a
   plaintext stub must be refused), their peer plane gRPC with the holder
   lookups from their heartbeats. The full write set (1,048,576 needles of
   1024 + 0..63 B) on A through Store.write_needles_bulk; VolumeCopy A -> C
   (.dat and .idx sha256 equal); 16,384 needles more on A (65,536 until
   phase 16 took the time), then
   VolumeSyncStatus of A, VolumeIncrementalCopy since the copy (== A's .dat
   tail) and VolumeTailReceiver on C from A (C's .dat, .idx and live
   needles == A's); BatchDelete of 4,096 fids on C (202 each, then 404
   each), VolumeNeedleStatus of 1,024 sampled needles (size, CRC, cookie ==
   written), VolumeConfigure "001" (super-block byte and heartbeat);
   VolumeScrub of C's copy through K3 (0 corrupt); VolumeEcShardsGenerate
   of it at RS(10,4) (K1 encode), its parity shards 10-13 copied to B,
   (0, 5, 10, 13) lost, a QoS policy POSTed to every /debug/qos (the maintenance class
   at 256 MB/s), VolumeEcShardsRebuild on C (maintenance class: B admits
   its survivor reads) while one keep-alive client GETs from A: the four
   shards to their hashes, the maintenance wait non-zero; Query (a filter
   and a projection) of 4,096 JSON-lines needles of 1-4 KiB in a volume
   sealed at RS(10,4) with (0, 5, 10, 13) lost, the records == the written
   ones filtered here, the K1 reconstructs == the intervals on lost
   shards; a tenant with a tiny bucket shed with 503 and Retry-After;
   VolumeServerLeave on C: out of the lookups within two pulses, a direct
   GET still 200. K1's and K3's counts are zeroed just before the phase and
   read just after; then, outside them, K1 at the Query's one-stripe widths
   is timed;
16. the rest of the volume server (the profiling plane, telemetry, the
   debug routes and /ui, image resize, the azure: and gcs-json: tiers and
   storage/ref_format.py): (a) a Go SeaweedFS v3 volume written here field
   by field (262,144 needles of 1024 + 0..63 B, a quarter of the write set
   to keep the whole in time, 1,024 tombstones, raw and
   scrambled CRCs, aligned records padded by 8), walk_dat, read_idx and
   every CRC; write_sorted_ecx; its .dat EC-encoded at RS(14,2) (1 GiB /
   1 MiB blocks, K1); shards (3, 15) lost and 16,384 needles re-read through
   the stripe locator with the lost intervals reconstructed (K1 at one
   stripe), parsed by ref_format.parse_needle; the rebuild (K1) to the
   shards' bytes; every live needle re-read; the decode == the Go .dat.
   Then servers A and B on the card joined by LocalPeers: (b) 262,144
   needles on A tiered to azure: (the port's MiniAzure on localhost), GETs
   cold and warm from the remote copy, VolumeScrub "skipped-tiered", the
   .dat brought back byte-equal and scrubbed through K3; the same for
   65,536 needles on gcs-json:; (c) 512 PNGs of 640x480 (made with zlib
   and struct) and, with Pillow, 128 JPEGs with EXIF orientation 6, on an
   RS(10,4) volume laid out as in phase 13 with shards (0, 5, 10, 13)
   lost, each GET as a 128x128 thumbnail and half at width 200 "fit",
   every answer == images.resized on the host (the stored bytes without
   Pillow), the degraded ones through K1; (d) after that traffic
   /debug/profile?mode=summary has read_pool and ec_read samples (and
   ?hz=abc is a 400), /debug/flight the slowest GETs with stages and queue
   depths, /debug/traces and /debug/events are not empty, the failpoint
   ec.shard.read armed on B fires once on a degraded GET from A and is
   disarmed, /debug/lifecycle counts the EC volume's reads and its POST
   stamps a destroy_time (401 when guarded), /ui lists the volumes,
   /metrics has the EC volume's SeaweedFS_hot_requests, a
   /debug/jax-profiler capture around 64 degraded GETs names K1's kernel,
   and a server run in a subprocess under SWTPU_LOCKCHECK=1 reports zero
   lock cycles at /debug/locks; (e) 4,096 healthy GETs with the sampler at
   its rate (two halves) and 4,096 after /debug/profile?hz=0, p50 and p99
   of each. K1's and K3's counts are zeroed just before the phase and read
   just after;
17. summary: one JSON line of every kernel with its launches (K1's from
   phases 6, 9, 10, 11, 12, 13, 14, 15 and 16, K3's from phases 8, 10, 12,
   13, 14, 15 and 16), error against the plain version, times and bound;
   then the result line.

Needs CUDA and the repository beside it; without either it exits 2.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
INT8_OPS_PER_S = 1.979e15      # H100 SXM dense int8 tensor-core peak
MAIN_SHAPE = (32, 10, 1 << 20)  # [batch, d, chunk] of one encode call
LOST_10_4 = (0, 5, 10, 13)
LOST_14_2 = (3, 15)
WIDTHS = (16, 48, 100, 384, 4112, 65536, 65552)
PHASES = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16)
PALLAS = "seaweedfs_tpu/ops/rs_pallas.py"
K1_SOURCE = "seaweedfs_tpu_torch/csrc/rs_gf.cu"
K3_SOURCE = "seaweedfs_tpu_torch/csrc/crc32c.cu"
K3_REPLACES = "seaweedfs_tpu/ops/crc32c.py:183"  # device_crc_states
KERNELS = {2: ("rs_gf",), 7: ("crc32c",), 9: ("rs_gf",),  # phase -> csrc
           10: ("rs_gf", "crc32c"), 11: ("rs_gf",),    # sources it builds
           12: ("rs_gf", "crc32c"), 13: ("rs_gf", "crc32c"),
           14: ("rs_gf", "crc32c"), 15: ("rs_gf", "crc32c"),
           16: ("rs_gf", "crc32c")}
K3_SHAPES = ((4096, 2048), (16384, 4096), (64, 1 << 20))  # first: the scrub's
K3_ROWS = (1, 3, 4096, 4225)  # 4225 = 132 SMs x 32 warps + 1
K3_LENGTHS = (0, 512, 1024, 2048, 4096, 65536, 1 << 20)
NEEDLE_LENGTHS = (0, 1, 511, 512, 513, 1087, 9000)
SCRUB_NEEDLES = 1 << 20
EC_NEEDLES = 1 << 20   # weed benchmark's default write set, as phase 8
EC_STORE_NEEDLES = 1 << 19  # phase 9: half of it (phase 13 runs the same
                            # flow at full size behind the server)
EC_SAMPLE = 16384      # needles read back per pass
EC_VID = 1
A_LOST, B_LOST = (0, 5), (10, 13)
TIER_LOST = (0, 5)     # phase 10's lost shards at RS(14,2)
TIER_NEEDLES = 1 << 18  # phase 10: a quarter of the write set (half until
                        # phase 15 took the time), to keep the whole in time
TIER_CHURN = 64        # phase 10: needles deleted, and needles overwritten
CODEC_SAMPLE = 4096    # phase 11: needles read back per pass
MSR_LOST, MSR_LOST2 = 5, (0, 14)  # phase 11(a) at RS(14,2)
PB_LOST = (3, 7)       # phase 11(b) at RS(10,4): survivors take parity 11
MESH_STEPS = ((10, 4, (0, 5, 10, 13)), (14, 2, (0, 5)))  # phase 12
MESH_DAT = 1_145_031_680  # phase 12: the .dat size of 1,048,576 needles
MESH_SCRUB_NEEDLES = 1 << 20  # phase 12: weed benchmark's default write set
MESH_SCRUB_BATCH = (4096, 2048)
MESH_DAMAGED = 17
SERVER_HTTP_NEEDLES = 4096  # phase 13: needles POSTed over HTTP after the
                            # bulk set; phase 14: POSTs fanned out to B
SERVER_SCRUB_NEEDLES = 1 << 18  # phase 13: the regular volume VolumeScrub checks
SERVER_SAMPLE = 4096   # phase 13: needles GET per pass (cut from 16,384 to
                       # make room for phase 14)
REPLICA_VID = 21       # phase 14's "001" volume
REPLICA_NEEDLES = 1 << 18  # phase 14: a quarter of the write set as /bulk
                           # frames (the whole until phase 15 took the time,
                           # half until phase 16 did)
REPLICA_FRAME = 1024   # phase 14: needles a /bulk frame (the JAX client's
                       # BULK_MAX_FRAME_NEEDLES)
REPLICA_DELETES = 256  # phase 14: DELETEs fanned out
REPLICA_GETS = 4096    # phase 14: GETs on A per pass, twice
REPLICA_PROXIED = 1024  # phase 14: of them, GETs proxied by C
REPLICA_READ_FRAME = 256  # phase 14: needles a /bulk-read frame
MAINT_MORE = 1 << 14   # phase 15: needles written on A after the copy and
                       # caught up by the tail (65,536 until phase 16 took
                       # the time)
MAINT_DELETES = 4096   # phase 15: fids in C's BatchDelete
MAINT_STATUSES = 1024  # phase 15: VolumeNeedleStatus calls (sampled needles)
MAINT_QUERY_NEEDLES = 4096  # phase 15: JSON-lines needles queried
MAINT_QUERY_VID, MAINT_TINY_VID = 31, 32  # phase 15's other volumes
# phase 15: the maintenance class's byte rate, below the ~160 MB/s at which
# an unthrottled rebuild reads B's half of the survivors, so it binds
MAINT_BYTES_PER_S = "128MB"
MAINT_BURST_BYTES = "32MB"   # and burst, on every server
MAINT_QUANTUM = 64 << 20     # phase 15's round-robin quantum (>= a read)
# `python3 -c "import grpc, google.protobuf"` on the card's machine found
# grpc 1.80.0 and protobuf 6.33.6 (PERF.md), so phase 13 also reads its
# degraded sample over gRPC
GRPC_ON_CARD = True
GO_NEEDLES = 1 << 18   # phase 16(a): the Go volume, a quarter of weed
                       # benchmark's write set (depth cut from half, which
                       # took 35 s of the phase, to keep the whole in time)
GO_DELETES = 1024      # phase 16(a): needles deleted by tombstones
GO_SAMPLE = 16384      # phase 16(a): needles read with shards (3, 15) lost
AZURE_NEEDLES = 1 << 18  # phase 16(b): the volume tiered to azure:
GCS_NEEDLES = 1 << 16    # and the one tiered to gcs-json:
TIER_GETS = 1024       # phase 16(b): needles GET cold, then warm (a quarter
                       # of them on gcs-json:)
IMAGE_COUNT = 512      # phase 16(c): PNG needles (depth cut from 1,024 to
                       # keep the whole in time)
IMAGE_JPEGS = 128      # phase 16(c): JPEGs with EXIF orientation 6 (Pillow;
                       # cut from 256 alike)
IMAGE_SIZE = (640, 480)
TRACE_GETS = 64        # phase 16(d): degraded GETs under the device trace
HOOK_GETS = 4096       # phase 16(e): healthy GETs each way
GO_VID, AZURE_VID, GCS_VID, IMAGE_VID, HOOK_VID = 41, 42, 43, 44, 45
K1_ENTRIES = {  # wrapper entry -> the TPU function it replaces
    "encode": f"{PALLAS}:156",
    "encode_seeded": f"{PALLAS}:164",
    "reconstruct": f"{PALLAS}:173",
    "reconstruct_seeded": f"{PALLAS}:182",
    "apply": "seaweedfs_tpu/ops/rs_jax.py:53",  # apply_bitmatrix (K2)
}
GiB, MiB = 1 << 30, 1 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 1 ----------------------------------------------------------------
def _smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def phase_device(torch) -> str:
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = _smi("name,power.limit")
    log(f"[device] {name} count={count} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    log(smi)
    return smi


# -- phase 2 ----------------------------------------------------------------
def build_kernels(phases) -> None:
    """Build the kernels of the phases asked for, one nvcc each, together."""
    from seaweedfs_tpu_torch.ops import _build
    names = sorted({name for ph, names in KERNELS.items() if ph in phases
                    for name in names})
    if names:
        t0 = time.perf_counter()
        _build.build_all(names)
        log(f"[build] {', '.join(names)} built together in "
            f"{time.perf_counter() - t0:.2f} s")


def phase_build(name: str = "rs_gf", tag: str = "build"):
    from seaweedfs_tpu_torch.ops import _build, crc_cuda, rs_cuda
    (rs_cuda if name == "rs_gf" else crc_cuda).load()
    built = _build.build(name)
    log(f"[{tag}] {built.path.name}")
    for line in built.ptxas_log.splitlines():
        if "Used" in line or "spill" in line or "smem" in line:
            log(f"[{tag}] {line.strip()}")
    if name == "crc32c":
        log(f"[{tag}] dynamic shared memory per block of crc_segments_kernel: "
            f"{crc_cuda.load().crc32c_shared_bytes()} B")
    log(f"[{tag}] SASS opcodes (static count): {_sass_opcodes(built.path)}")


def _sass_opcodes(lib) -> str:
    """Opcode histogram of the library's machine code, from cuobjdump."""
    from seaweedfs_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    if not os.access(tool, os.X_OK):
        return "cuobjdump not found"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    ops = collections.Counter(re.findall(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)", sass))
    return f"{sum(ops.values())} in all; " + ", ".join(
        f"{op} {n}" for op, n in ops.most_common(16))


# -- phase 3 ----------------------------------------------------------------
def _max_err(a, b) -> int:
    assert a.shape == b.shape, (tuple(a.shape), tuple(b.shape))
    return int((a.int() - b.int()).abs().max().item()) if a.numel() else 0


def phase_compare(torch, np, seed: int) -> "dict[str, int]":
    from seaweedfs_tpu_torch.ops import gf8, rs_cuda, rs_torch
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    errs = {e: 0 for e in K1_ENTRIES}
    cases = 0

    def check(entry, got, want, what):
        nonlocal cases
        err = _max_err(got, want)
        errs[entry] = max(errs[entry], err)
        cases += 1
        if err:
            raise AssertionError(f"K1 {entry} differs from the plain version "
                                 f"at {what}: max abs err {err}")

    for d, p in ((10, 4), (14, 2), (5, 3), (4, 2)):
        n = d + p
        for C in WIDTHS:
            x = torch.from_numpy(rng.integers(0, 256, (3, d, C), np.uint8)).to(dev)
            par = rs_torch.encode(x, d, p)
            check("encode", rs_cuda.encode(x, d, p), par, f"({d},{p}) C={C}")
            check("encode", rs_cuda.encode(x[1].contiguous(), d, p), par[1],
                  f"({d},{p}) C={C} single stripe")
            check("encode", rs_cuda.encode(x[2:].contiguous(), d, p), par[2:],
                  f"({d},{p}) C={C} batch of 1")
            s = int(rng.integers(1, 256))
            check("encode_seeded", rs_cuda.encode_seeded(x, s, d, p),
                  rs_torch.gf_apply(gf8.parity_matrix(d, p), x, s),
                  f"({d},{p}) C={C} seed={s}")
            shards = torch.cat([x, par], dim=1)
            patterns = [tuple(range(p)), tuple(range(n - p, n)),
                        tuple(sorted(rng.choice(n, p, replace=False).tolist())),
                        (int(rng.integers(0, d)), n - 1)[:p]]
            for lost in patterns:
                present = tuple(i for i in range(n) if i not in lost)
                surv = shards[:, sorted(present)[:d]].contiguous()
                got = rs_cuda.reconstruct(surv, present, lost, d, p)
                check("reconstruct", got, shards[:, list(lost)],
                      f"({d},{p}) C={C} lost={lost}")
                check("reconstruct",
                      rs_cuda.reconstruct(surv[:1].contiguous(), present, lost, d, p),
                      shards[:1, list(lost)], f"({d},{p}) C={C} lost={lost} batch of 1")
                check("reconstruct_seeded",
                      rs_cuda.reconstruct_seeded(surv, s, present, lost, d, p),
                      rs_torch.reconstruct(surv ^ s, present, lost, d, p),
                      f"({d},{p}) C={C} lost={lost} seed={s}")
    # the apply entry at the msr codec's matrices: every solve matrix of a
    # survivor set and every single-loss repair matrix
    for d, p, mat in msr_matrices(np):
        for C in WIDTHS:
            x = torch.from_numpy(rng.integers(0, 256, (mat.shape[1], C),
                                              np.uint8)).to(dev)
            check("apply", rs_cuda.gf_apply(mat, x), rs_torch.gf_apply(mat, x),
                  f"msr ({d},{p}) matrix {tuple(mat.shape)} C={C}")
        x = torch.from_numpy(rng.integers(0, 256, (2, mat.shape[1], 4112),
                                          np.uint8)).to(dev)
        check("apply", rs_cuda.gf_apply(mat, x), rs_torch.gf_apply(mat, x),
              f"msr ({d},{p}) matrix {tuple(mat.shape)} batch of 2")
    # the main shape, as the encode and rebuild paths give it
    x = torch.from_numpy(rng.integers(0, 256, MAIN_SHAPE, np.uint8)).to(dev)
    par = rs_torch.encode(x, 10, 4)
    check("encode", rs_cuda.encode(x, 10, 4), par, "main shape")
    present = tuple(i for i in range(14) if i not in LOST_10_4)
    surv = torch.cat([x, par], dim=1)[:, list(present[:10])].contiguous()
    check("reconstruct", rs_cuda.reconstruct(surv, present, LOST_10_4, 10, 4),
          rs_torch.reconstruct(surv, present, LOST_10_4, 10, 4), "main shape")
    del x, par, surv
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[compare] K1 == plain version on {cases} cases, max abs err "
        f"{max(errs.values())}")
    return errs


def msr_matrices(np):
    """(d, p, GF matrix) of every apply the msr codec makes at RS(10,4) and
    RS(14,2): the solve matrix of each survivor set of the degraded reads
    and rebuilds (all data, one loss, two losses) and each single-loss
    repair matrix."""
    from seaweedfs_tpu_torch.ops.product_matrix import ProductMatrixCoder
    out = []
    for d, p in ((10, 4), (14, 2)):
        n = d + p
        g = ProductMatrixCoder(d, p, backend="numpy").grid
        sets = [tuple(range(d)), tuple(range(1, d + 1)),
                tuple(i for i in range(n) if i not in (0, n - 2))[:d]]
        out += [(d, p, g.solve_matrices(u)[2]) for u in sets]
        out += [(d, p, g.repair_matrices(f)[2]) for f in range(n)]
    return out


# -- phase 4 ----------------------------------------------------------------
def _time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    for i in range(warmup):
        fn(i + 1)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(warmup + i + 1)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _bound(B: int, k: int, m: int, C: int) -> "tuple[float, str]":
    """Least time for [B, k, C] -> [B, m, C]: every byte moved once over
    HBM, or the GF(2) bit-matrix product (2 * 8m * 8k ops per column) at the
    int8 tensor-core peak, whichever is larger."""
    t_bytes = B * C * (k + m) / HBM_BYTES_PER_S
    t_ops = 2 * (8 * m) * (8 * k) * B * C / INT8_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_timing(torch, np, seed: int, card: str) -> "dict[str, dict]":
    from seaweedfs_tpu_torch.ops import gf8, rs_cuda, rs_torch
    B, d, C = MAIN_SHAPE
    p = 4
    rng = np.random.default_rng(seed + 1)
    x = torch.from_numpy(rng.integers(0, 256, MAIN_SHAPE, np.uint8)).to("cuda")
    shape14 = (B, 14, C)
    y = torch.from_numpy(rng.integers(0, 256, shape14, np.uint8)).to("cuda")
    present = tuple(i for i in range(d + p) if i not in LOST_10_4)
    rec = rs_torch.decode_rows(d, p, present, LOST_10_4)
    enc = gf8.parity_matrix(d, p)
    live14 = tuple(i for i in range(16) if i not in LOST_14_2)
    rec14 = rs_torch.decode_rows(14, 2, live14, LOST_14_2)
    enc14 = gf8.parity_matrix(14, 2)
    # (what, K1 call, plain version or None, input shape, outputs); the rows
    # named after an entry are the entries of the kernels line
    rows = [
        ("encode", lambda s: rs_cuda.encode(x, d, p),
         lambda s: rs_torch.gf_apply(enc, x), MAIN_SHAPE, p),
        ("encode_seeded", lambda s: rs_cuda.encode_seeded(x, s, d, p),
         lambda s: rs_torch.gf_apply(enc, x, s), MAIN_SHAPE, p),
        ("reconstruct",
         lambda s: rs_cuda.reconstruct(x, present, LOST_10_4, d, p),
         lambda s: rs_torch.gf_apply(rec, x), MAIN_SHAPE, p),
        ("reconstruct_seeded", lambda s: rs_cuda.reconstruct_seeded(
            x, s, present, LOST_10_4, d, p),
         lambda s: rs_torch.gf_apply(rec, x, s), MAIN_SHAPE, p),
    ]
    # how K1's time scales with its outputs, on the same input
    for lost in (LOST_10_4[:2], LOST_10_4[:1]):
        live = tuple(i for i in range(d + p) if i not in lost)
        rows.append((f"reconstruct of {lost}",
                     lambda s, live=live, lost=lost: rs_cuda.reconstruct(
                         x, live, lost, d, p), None, MAIN_SHAPE, len(lost)))
    # the apply entry at the msr seal's shape: RS(14,2)'s [2, 14] solve
    # matrix over one window's 256 layers x 16 KiB (ec/repair._msr_window)
    from seaweedfs_tpu_torch.ops.product_matrix import ProductMatrixCoder
    seal = ProductMatrixCoder(14, 2, backend="numpy").grid.solve_matrices(
        tuple(range(14)))[2]
    seal_shape = (1, 14, 256 * 16384)
    z = torch.from_numpy(rng.integers(0, 256, seal_shape[1:], np.uint8)).to("cuda")
    rows.append(("apply", lambda s: rs_cuda.gf_apply(seal, z),
                 lambda s: rs_torch.gf_apply(seal, z), seal_shape, 2))
    # the fork's default geometry
    rows += [
        ("encode RS(14,2)", lambda s: rs_cuda.encode(y, 14, 2),
         lambda s: rs_torch.gf_apply(enc14, y), shape14, 2),
        (f"reconstruct RS(14,2) of {LOST_14_2}",
         lambda s: rs_cuda.reconstruct(y, live14, LOST_14_2, 14, 2),
         lambda s: rs_torch.gf_apply(rec14, y), shape14, len(LOST_14_2)),
    ]
    # Every K1 time first, between two readings of the SM clock and power,
    # so that none of the plain version's large float32 products runs among
    # them.
    log(f"[timing] clocks.sm, power.draw, temperature before: "
        f"{_smi('clocks.sm,power.draw,temperature.gpu')}")
    k1_ms = {what: _time_ms(torch, fn, iters=50) for what, fn, *_ in rows}
    copy_ms = _time_ms(torch, lambda s: torch.empty_like(x).copy_(x), iters=50)
    log(f"[timing] clocks.sm, power.draw, temperature after K1: "
        f"{_smi('clocks.sm,power.draw,temperature.gpu')}")
    out = {}
    for what, _, plain, (b, k, c), m in rows:
        ms = k1_ms[what]
        plain_ms = _time_ms(torch, plain, iters=3, warmup=1) if plain else None
        torch.cuda.empty_cache()
        bound_ms, bound_by = _bound(b, k, m, c)
        log(f"[timing] K1 {what} [{b}, {k}, {c}] -> [{b}, {m}, {c}]: "
            f"{ms:.4f} ms, {b * c * (k + m) / ms / 1e6:.1f} GB/s moved, bound "
            f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound"
            + (f"; plain version {plain_ms:.3f} ms" if plain else "")
            + f" [{card}]")
        out[what] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
    log(f"[timing] device copy of the [{B}, {d}, {C}] input: {copy_ms:.4f} ms, "
        f"{2 * x.numel() / copy_ms / 1e6:.1f} GB/s moved [{card}]")
    log("[timing] library yardstick: none (no single PyTorch call computes "
        "a GF(2^8) matrix apply)")
    del x, y, z
    torch.cuda.empty_cache()
    return out


# -- phase 5 ----------------------------------------------------------------
def phase_entry(torch) -> int:
    from seaweedfs_tpu_torch.entry import entry
    from seaweedfs_tpu_torch.ops import rs_torch
    fn, (data,) = entry()
    got = fn(data)
    want = rs_torch.encode(torch.from_numpy(data).cuda(), 10, 4)
    assert got.is_cuda and tuple(got.shape) == (8, 4, 65536)
    err = _max_err(got, want)
    assert err == 0, f"entry forward differs from the plain version: {err}"
    log("[entry] ECPipeline(10, 4).forward [8, 10, 65536] through K1 == plain")
    return err


# -- phase 6 ----------------------------------------------------------------
def make_dat(np, path: str, size: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    piece = 256 * MiB
    with open(path, "wb") as f:
        left = size
        while left > 0:
            n = min(piece, left)
            words = rng.integers(0, 2**64 - 1, (n + 7) // 8, dtype=np.uint64,
                                 endpoint=True)
            f.write(memoryview(words.view(np.uint8)[:n]))
            left -= n


def make_idx(np, path: str, dat_size: int, seed: int, count: int = 4096) -> None:
    """Synthetic .idx: `count` needles spread over the volume, one deleted."""
    from seaweedfs_tpu_torch.storage.needle_map import write_idx_entries
    rng = np.random.default_rng(seed)
    keys = rng.choice(1 << 40, size=count, replace=False).astype(np.uint64)
    offs = np.sort(rng.choice(max(1, dat_size // 8 - 8192), size=count,
                              replace=False)).astype(np.uint32)
    sizes = rng.integers(1, 8192, count).astype(np.uint32)
    sizes[count // 2] = 0xFFFFFFFF
    write_idx_entries(path, keys, offs, sizes)


def files_equal(np, a: str, b: str) -> bool:
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    size = os.path.getsize(a)
    if size == 0:
        return True
    ma = np.memmap(a, dtype=np.uint8, mode="r")
    mb = np.memmap(b, dtype=np.uint8, mode="r")
    step = 256 * MiB
    return all(np.array_equal(ma[o:o + step], mb[o:o + step])
               for o in range(0, size, step))


def sample_stripes(torch, np, base: str, d: int, p: int, shard_size: int,
                   rng, count: int = 64, width: int = 4096) -> int:
    """Parity of `count` random stripe spans (d data bytes at one offset of
    every data shard, `width` columns) recomputed by the plain version on
    the CPU, against the parity shards on disk."""
    from seaweedfs_tpu_torch.ec import files
    from seaweedfs_tpu_torch.ops import rs_torch
    maps = [np.memmap(base + files.shard_ext(i), dtype=np.uint8, mode="r")
            for i in range(d + p)]
    for _ in range(count):
        off = int(rng.integers(0, max(1, shard_size - width)))
        w = min(width, shard_size - off)
        data = np.stack([m[off:off + w] for m in maps[:d]])
        want = rs_torch.encode(torch.from_numpy(data), d, p).numpy()
        got = np.stack([m[off:off + w] for m in maps[d:]])
        if not np.array_equal(got, want):
            raise AssertionError(f"{base}: parity at shard offset {off} "
                                 "differs from the plain version")
    return count


def round_trip(torch, np, workdir: str, d: int, p: int, sizes, lost, seed: int,
               card: str, decode_loses: "tuple[int, ...]" = ()) -> dict:
    from seaweedfs_tpu_torch.ec import encoder, files, stream
    from seaweedfs_tpu_torch.ec.locate import EcGeometry
    from seaweedfs_tpu_torch.ops.coder import TorchCoder

    geo = EcGeometry(d=d, p=p)  # reference blocks: 1 GiB large, 1 MiB small
    shard_sizes = [geo.shard_file_size(s) for s in sizes]
    need = (sum(sizes) + geo.n * sum(shard_sizes) + len(lost) * max(shard_sizes)
            + max(sizes) + GiB)
    free = shutil.disk_usage(workdir).free
    if free < need:
        raise RuntimeError(f"RS({d},{p}) round trip needs {need} B free in "
                           f"{workdir}, has {free} B")
    tag = f"rs{d}_{p}"
    t0 = time.perf_counter()
    jobs = []
    for i, size in enumerate(sizes):
        dat = os.path.join(workdir, f"{tag}_{i}.dat")
        idx = os.path.join(workdir, f"{tag}_{i}.idx")
        make_dat(np, dat, size, seed * 1000 + i)
        make_idx(np, idx, size, seed * 1000 + i)
        jobs.append((dat, os.path.join(workdir, f"{tag}_{i}"), idx))
    log(f"[main] RS({d},{p}): {len(sizes)} volumes, {sum(sizes)} B made from "
        f"seed {seed} in {time.perf_counter() - t0:.1f} s")

    coder = TorchCoder(d, p)
    stats: dict = {}
    stream.encode_volumes(jobs, geo, coder, stats=stats)
    enc_gbs = sum(sizes) / stats["wall_s"] / 1e9
    stage = {k: stats[k] for k in ("open_s", "fill_s", "dispatch_s",
                                   "drain_block_s", "write_s", "write_block_s",
                                   "seal_s", "wall_s")}
    log(f"[main] RS({d},{p}) encode stages {json.dumps(stage)} batches="
        f"{stats['batches']} writers={stats['writers']} [{card}]")
    log(f"[main] RS({d},{p}) encode {sum(sizes)} B in {stats['wall_s']:.3f} s: "
        f"{enc_gbs:.3f} GB/s end to end [{card}]")

    rng = np.random.default_rng(seed + 7)
    sampled = 0
    for (dat, base, _), ss in zip(jobs, shard_sizes):
        sampled += sample_stripes(torch, np, base, d, p, ss, rng)
        info = files.read_vif(base + ".vif")
        assert info["dat_size"] == os.path.getsize(dat) and info["codec"] == "rs"
        assert os.path.getsize(base + ".ecx") > 0
    log(f"[main] RS({d},{p}) {sampled} sampled stripe spans == plain version "
        "on the CPU")

    read = written = 0
    rebuild_s = 0.0
    rstages = dict.fromkeys(("read_s", "write_s", "flush_s", "wall_s"), 0.0)
    for (dat, base, _), ss in zip(jobs, shard_sizes):
        for s in lost:
            os.replace(base + files.shard_ext(s), base + files.shard_ext(s) + ".orig")
        rstats: dict = {}
        t0 = time.perf_counter()
        got = encoder.rebuild_shards(base, geo, coder, stats=rstats)
        rebuild_s += time.perf_counter() - t0
        assert got == sorted(lost), got
        read += rstats["bytes_read"]
        written += rstats["bytes_written"]
        for k in rstages:
            rstages[k] += rstats[k]
        for s in lost:
            orig = base + files.shard_ext(s) + ".orig"
            if not files_equal(np, base + files.shard_ext(s), orig):
                raise AssertionError(f"rebuilt shard {s} of {base} differs")
            os.unlink(orig)
    log(f"[main] RS({d},{p}) rebuild stages {json.dumps(rstages)} [{card}]")
    log(f"[main] RS({d},{p}) rebuild of shards {tuple(lost)} on "
        f"{len(jobs)} volumes: {read} B read, {written} B written in "
        f"{rebuild_s:.3f} s: {read / rebuild_s / 1e9:.3f} GB/s read, "
        f"{written / rebuild_s / 1e9:.3f} GB/s written; rebuilt == original "
        f"[{card}]")

    for dat, base, _ in jobs:
        for s in decode_loses:
            os.unlink(base + files.shard_ext(s))
        out = base + ".decoded.dat"
        encoder.decode_volume(base, out, geo, coder)
        if not files_equal(np, out, dat):
            raise AssertionError(f"decoded {out} differs from {dat}")
        os.unlink(out)
    log(f"[main] RS({d},{p}) decode of {len(jobs)} volumes == source .dat"
        + (f" (data shards {decode_loses} lost and rebuilt first)"
           if decode_loses else ""))
    for name in os.listdir(workdir):
        if name.startswith(tag):
            os.unlink(os.path.join(workdir, name))
    return dict(encode_gbs=enc_gbs, rebuild_read_gbs=read / rebuild_s / 1e9,
                stages=stage, rebuild_stages=rstages)


def phase_main(torch, np, workdir: str, seed: int, card: str) -> "dict[str, int]":
    from seaweedfs_tpu_torch.ops import rs_cuda
    os.makedirs(workdir, exist_ok=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rs_cuda.reset_launches()
    round_trip(torch, np, workdir, 10, 4,
               [10 * GiB + 3 * MiB + 12_345, 256 * MiB, 256 * MiB],
               LOST_10_4, seed, card)
    round_trip(torch, np, workdir, 14, 2,
               [300 * MiB + 4_321, 300 * MiB + 77, 300 * MiB + 1_048_573],
               LOST_14_2, seed + 1, card, decode_loses=(0, 9))
    torch.cuda.synchronize()
    launches = dict(rs_cuda.launches_by_entry)
    log(f"[main] K1 launches on the main path: {json.dumps(launches)}; peak "
        f"device memory {torch.cuda.max_memory_allocated()} B [{card}]")
    for entry in ("encode", "reconstruct"):
        if not launches.get(entry):
            raise AssertionError(f"K1 {entry} never launched on the main path")
    return launches


# -- phase 7 ----------------------------------------------------------------
def _state_err(a, b) -> int:
    """Largest difference of two int64 state vectors (0 when equal)."""
    assert a.shape == b.shape, (tuple(a.shape), tuple(b.shape))
    return int((a - b).abs().max().item()) if a.numel() else 0


def phase_k3_compare(torch, np, seed: int) -> int:
    from seaweedfs_tpu_torch.ops import crc32c, crc_cuda, crc_torch
    from seaweedfs_tpu_torch.storage.scrub import _pad_pow2
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    err = cases = 0
    for b in K3_ROWS:
        for length in K3_LENGTHS:
            for fill in ("zeros", "0xFF", "random"):
                if fill == "random":
                    x = torch.randint(0, 256, (b, length), dtype=torch.uint8,
                                      device="cuda", generator=gen)
                else:
                    x = torch.full((b, length), 0 if fill == "zeros" else 255,
                                   dtype=torch.uint8, device="cuda")
                got = crc_cuda.crc_states(x)
                e = _state_err(got, crc_torch.crc_states(x))
                err = max(err, e)
                cases += 1
                if e:
                    raise AssertionError(f"K3 differs from the plain version "
                                         f"at [{b}, {length}] {fill}")
                del x, got
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    try:
        crc_cuda.crc_states(torch.zeros((4, 1024), dtype=torch.uint8,
                                        device="cuda")[:, :512])
    except ValueError:
        pass
    else:
        raise AssertionError("K3 took a non-contiguous input")
    rng = np.random.default_rng(seed + 3)
    msgs = [rng.integers(0, 256, n, dtype=np.uint8) for n in NEEDLE_LENGTHS]
    width = _pad_pow2(max(NEEDLE_LENGTHS))
    blocks = np.zeros((len(msgs), width), dtype=np.uint8)
    for i, m in enumerate(msgs):
        blocks[i, width - m.size:] = m
    raw = crc_cuda.crc_states(torch.from_numpy(blocks).cuda())
    vals = crc32c.finalize(raw.cpu().numpy().astype(np.uint32),
                           np.array(NEEDLE_LENGTHS))
    want = [crc32c.crc32c(m.tobytes()) for m in msgs]
    if [int(v) for v in vals] != want:
        raise AssertionError(f"K3 + finalize differs from the host CRC: "
                             f"{[hex(v) for v in vals]} != "
                             f"{[hex(v) for v in want]}")
    log(f"[k3] K3 == plain version on {cases} cases (max abs err {err}); "
        f"non-contiguous input refused; after finalize == host crc32c on "
        f"needles of {NEEDLE_LENGTHS} B")
    return err


def _queued_ms(torch, fn, inputs, iters: int) -> float:
    """Device ms per call of fn, each call on the next of `inputs`: the
    calls are queued behind a sleeping kernel, so the card runs them back
    to back however slowly the host enqueues them."""
    for x in inputs[:2]:
        fn(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms at 2 GHz: covers the enqueue
    start.record()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _k3_bound(b: int, length: int) -> "tuple[float, str]":
    """Least time for [B, L] -> [B] states: every input byte read and every
    8-byte state written once over HBM, or the reference's GF(2)
    formulation (per 512-byte chunk, [32, 4096] and [32, 32] bit-matrix
    products, 2 ops per multiply-add) at the int8 tensor-core peak,
    whichever is larger."""
    t_bytes = (b * length + 8 * b) / HBM_BYTES_PER_S
    chunks = length // 512
    t_ops = 2 * 32 * (8 * 512 + 32) * chunks * b / INT8_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_k3_timing(torch, np, seed: int, card: str) -> "dict[tuple, dict]":
    from seaweedfs_tpu_torch.ops import crc_cuda, crc_torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 5)
    sets = {}
    for b, length in K3_SHAPES:
        # distinct inputs adding up to >= 256 MiB, five times the L2
        n = max(4, -(-(256 * MiB) // (b * length)))
        sets[(b, length)] = [torch.randint(0, 256, (b, length), dtype=torch.uint8,
                                           device="cuda", generator=gen)
                             for _ in range(n)]
    log(f"[k3] clocks.sm, power.draw, temperature before: "
        f"{_smi('clocks.sm,power.draw,temperature.gpu')}")
    k3_ms = {shape: _queued_ms(torch, crc_cuda.crc_states, xs,
                               iters=200 if shape[0] * shape[1] < 64 * MiB else 50)
             for shape, xs in sets.items()}
    copy_ms = {shape: _queued_ms(torch, lambda x: torch.empty_like(x).copy_(x),
                                 xs, iters=50)
               for shape, xs in sets.items()}
    log(f"[k3] clocks.sm, power.draw, temperature after K3: "
        f"{_smi('clocks.sm,power.draw,temperature.gpu')}")
    out = {}
    for (b, length), xs in sets.items():
        ms = k3_ms[(b, length)]
        plain_ms = _time_ms(torch, lambda s, x=xs[0]: crc_torch.crc_states(x),
                            iters=3, warmup=1)
        bound_ms, bound_by = _k3_bound(b, length)
        log(f"[k3] K3 [{b}, {length}] -> [{b}]: {ms:.5f} ms, "
            f"{b * length / ms / 1e6:.1f} GB/s read, bound {bound_ms:.5f} ms "
            f"({bound_by}), {bound_ms / ms:.1%} of bound; plain version "
            f"{plain_ms:.3f} ms; device copy of the input "
            f"{copy_ms[(b, length)]:.5f} ms "
            f"({2 * b * length / copy_ms[(b, length)] / 1e6:.1f} GB/s moved); "
            f"{crc_cuda.segments(b, length // 512, crc_cuda.target_tasks(xs[0].device))} "
            f"segment(s) per row [{card}]")
        out[(b, length)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by, copy_ms=copy_ms[(b, length)])
    log("[k3] library yardstick: none (no PyTorch call computes CRC32C)")
    del sets
    torch.cuda.empty_cache()
    return out


# -- phase 8 ----------------------------------------------------------------
def make_scrub_volume(np, vdir: str, seed: int, n: int = SCRUB_NEEDLES,
                      vid: int = 1):
    """Volume `vid` of `n` needles (1,048,576 by default), damaged; returns
    (volume, the 17 ids whose live bytes were damaged, the 64 deleted ids)."""
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.volume import Volume
    rng = np.random.default_rng(seed)
    sizes = 1024 + rng.integers(0, 64, n)
    cookies = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    v = Volume(vdir, "", vid)
    t0 = time.perf_counter()
    frame = 4096
    for lo in range(0, n, frame):
        hi = min(n, lo + frame)
        buf = rng.bytes(int(sizes[lo:hi].sum()))
        ends = np.cumsum(sizes[lo:hi])
        v.write_needles([Needle(id=lo + i + 1, cookie=int(cookies[lo + i]),
                                data=buf[int(e - sizes[lo + i]):int(e)])
                         for i, e in enumerate(ends)])
    log(f"[scrub] wrote {n} needles ({os.path.getsize(v.dat_path)} B of "
        f".dat) through Volume.write_needles in "
        f"{time.perf_counter() - t0:.1f} s")
    pick = rng.choice(n, 16 + 1 + 64 + 64, replace=False) + 1
    flipped, crc_hit = pick[:16], int(pick[16])
    overwritten, deleted = pick[17:81], pick[81:]
    garbage = [(v.nm.get(int(i)).offset, v.nm.get(int(i)).size)
               for i in overwritten[:8]]
    v.write_needles([Needle(id=int(i), cookie=int(cookies[i - 1]),
                            data=rng.bytes(1024)) for i in overwritten])
    for i in deleted:
        assert v.delete_needle(int(i), int(cookies[i - 1]))
    v.sync()

    def flip(f, off: int) -> None:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0x5A]))

    with open(v.dat_path, "r+b") as f:
        for i in flipped:
            nv = v.nm.get(int(i))
            flip(f, nv.offset + 20 + int(rng.integers(0, nv.size - 5)))
        nv = v.nm.get(crc_hit)
        flip(f, nv.offset + 16 + nv.size + int(rng.integers(0, 4)))
        for off, size in garbage:
            flip(f, off + 20 + int(rng.integers(0, size - 5)))
    damaged = sorted(int(i) for i in flipped) + [crc_hit]
    return v, sorted(damaged), deleted


def phase_scrub(torch, np, workdir: str, seed: int, card: str) -> int:
    from seaweedfs_tpu_torch.ops import crc_cuda, rs_cuda
    from seaweedfs_tpu_torch.storage import scrub
    vdir = os.path.join(workdir, "scrub")
    os.makedirs(vdir, exist_ok=True)
    v, damaged, deleted = make_scrub_volume(np, vdir, seed + 11)
    try:
        torch.cuda.synchronize()
        rs_cuda.reset_launches()
        crc_cuda.reset_launches()
        stages: dict = {}
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = scrub.scrub_volume(v, device="cuda", stats=stages)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
        launches = {"crc32c_states": crc_cuda.launches,
                    **{f"rs_gf_apply:{e}": c
                       for e, c in rs_cuda.launches_by_entry.items()}}
        device_us = collections.Counter()
        for avg in prof.key_averages():
            device_us[avg.key] += getattr(avg, "self_device_time_total",
                                          getattr(avg, "self_cuda_time_total", 0))
        k3_ms = sum(us for key, us in device_us.items()
                    if "crc_segments" in key or "crc_combine" in key) / 1e3
        busy_ms = sum(device_us.values()) / 1e3
        by_name = {k: round(us / 1e3, 4) for k, us in device_us.most_common(4)}
        log(f"[scrub] profiler, device time by name (ms): {json.dumps(by_name)}; "
            f"all device work {busy_ms:.3f} ms = {busy_ms / 1e3 / wall:.3%} of "
            f"the {wall:.3f} s wall (idle {1 - busy_ms / 1e3 / wall:.3%})")
        log(f"[scrub] launches on the scrub path: {json.dumps(launches)}")
        if not launches["crc32c_states"]:
            raise AssertionError("K3 never launched on the scrub path")
        if sorted(res.corrupt) != damaged or res.error or res.mode != "device":
            raise AssertionError(f"scrub(cuda) reported {res.corrupt} (error "
                                 f"{res.error!r}, mode {res.mode}); damaged "
                                 f"were {damaged}")
        if res.scanned != SCRUB_NEEDLES - len(deleted):
            raise AssertionError(f"scrub(cuda) scanned {res.scanned}")
        off_stages: dict = {}
        off = scrub.scrub_volume(v, device="off", stats=off_stages)
        if (off.scanned, off.bytes_checked, off.corrupt, off.error) != (
                res.scanned, res.bytes_checked, res.corrupt, res.error):
            raise AssertionError(f"scrub(off) {off} != scrub(cuda) {res}")
        t0 = time.perf_counter()
        walked = sum(len(ids) for ids, _, _ in scrub._iter_batches(
            v, 4096, scrub.ScrubResult(v.id)))
        walk_s = time.perf_counter() - t0
        assert walked == res.scanned
    finally:
        v.close()
    log(f"[scrub] device=cuda: {res.scanned} needles, {res.bytes_checked} B "
        f"checked in {wall:.3f} s: {res.scanned / wall:.0f} needles/s, "
        f"{res.bytes_checked / wall / 1e9:.4f} GB/s; corrupt == the 17 "
        f"damaged ids; stages {json.dumps(stages)}; K3 summed device time "
        f"(profiler) {k3_ms:.3f} ms over {launches['crc32c_states']} launches, "
        f"{k3_ms / 1e3 / wall:.4%} of the wall [{card}]")
    log(f"[scrub] device=off: {off.elapsed_s:.3f} s, "
        f"{off.scanned / off.elapsed_s:.0f} needles/s; stages "
        f"{json.dumps(off_stages)}; same scanned, bytes_checked and corrupt")
    log(f"[scrub] the record walk alone: {walk_s:.3f} s "
        f"({walked / walk_s:.0f} needles/s) [{card}]")
    return launches["crc32c_states"]


# -- phase 9 ----------------------------------------------------------------
def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.file_digest(f, "sha256").hexdigest()


def _serve(store, vid: int):
    """Server `store`'s side of a shard fetch: the bytes of one of its
    mounted shards, or None when it holds no such shard."""
    def fetch(sid: int, off: int, ln: int):
        ev = store.find_ec_volume(vid)
        sh = ev.shards.get(sid) if ev is not None else None
        return None if sh is None else sh.read_at(off, ln)
    return fetch


def _must(fetch):
    """A rebuild's shard_reader over `fetch`: a shard it lacks is an error."""
    def read(sid: int, off: int, ln: int) -> bytes:
        data = fetch(sid, off, ln)
        if data is None:
            raise OSError(f"shard {sid} is not on the remote server")
        return data
    return read


def _pct(np, xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs), q))


def write_set(np, store, rng, sizes, cookies, in_sample,
              vid: int = EC_VID) -> "dict[int, bytes]":
    """Write needles 1..len(sizes) of `sizes` random bytes each into
    volume `vid` of `store` through write_needles_bulk, one frame per 4096;
    returns the payloads of the ids in `in_sample`."""
    from seaweedfs_tpu_torch.storage.needle import Needle
    needles = len(sizes)
    want: "dict[int, bytes]" = {}
    for lo in range(0, needles, 4096):
        hi = min(needles, lo + 4096)
        buf = rng.bytes(int(sizes[lo:hi].sum()))
        ends = np.cumsum(sizes[lo:hi])
        batch = []
        for i, e in enumerate(ends):
            nid = lo + i + 1
            data = buf[int(e - sizes[lo + i]):int(e)]
            batch.append(Needle(id=nid, cookie=int(cookies[lo + i]), data=data))
            if nid in in_sample:
                want[nid] = data
        store.write_needles_bulk(vid, batch)
    return want


def ec_store_round_trip(np, workdir: str, seed: int, card: str, geo,
                        needles: int, sample: int, device: str = "cuda") -> dict:
    """Phase 9's path through two Stores, every check fatal; returns the
    measured numbers and the degraded intervals' lengths."""
    from concurrent.futures import ThreadPoolExecutor
    from seaweedfs_tpu_torch.ec import files
    from seaweedfs_tpu_torch.ec.locate import locate
    from seaweedfs_tpu_torch.server.volume_server import make_shard_reader
    from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
    from seaweedfs_tpu_torch.storage.needle import Needle, record_size_from_header
    from seaweedfs_tpu_torch.storage.store import Store

    lost = set(A_LOST + B_LOST)
    dirs = [os.path.join(workdir, f"server_{x}") for x in "ab"]
    a, b = (Store("127.0.0.1", 8080 + i, "", [DiskLocation(d)],
                  ec_geometry=geo, device=device) for i, d in enumerate(dirs))
    pool = ThreadPoolExecutor(max_workers=8)
    try:
        rng = np.random.default_rng(seed)
        sizes = 1024 + rng.integers(0, 64, needles)
        cookies = rng.integers(0, 1 << 32, needles, dtype=np.uint64)
        picked = rng.choice(needles, sample, replace=False) + 1
        in_sample = set(int(i) for i in picked)
        a.add_volume(EC_VID)
        t0 = time.perf_counter()
        want = write_set(np, a, rng, sizes, cookies, in_sample)
        base_a = a.find_volume(EC_VID).file_name()
        dat_size = os.path.getsize(base_a + ".dat")
        log(f"[ec] server A: wrote {needles} needles ({dat_size} B of .dat) "
            f"through Store.write_needles_bulk in {time.perf_counter() - t0:.1f} s")
        dat_hash = _sha256(base_a + ".dat")

        enc: dict = {}
        t0 = time.perf_counter()
        a.generate_ec_shards(EC_VID, stats=enc)
        enc_s = time.perf_counter() - t0
        log(f"[ec] Store.generate_ec_shards RS({geo.d},{geo.p}) of {dat_size} B "
            f"in {enc_s:.3f} s: {dat_size / enc_s / 1e9:.3f} GB/s end to end "
            f"(stream wall {enc['wall_s']:.3f} s, seal {enc['seal_s']:.3f} s, "
            f"fill {enc['fill_s']:.3f} s) [{card}]")

        # VolumeEcShardsCopy stand-in: shards 7-13 to B with the sidecars
        base_b = os.path.join(dirs[1], os.path.basename(base_a))
        for s in range(7, geo.n):
            os.replace(base_a + files.shard_ext(s), base_b + files.shard_ext(s))
        for ext in (".ecx", ".vif"):
            shutil.copy(base_a + ext, base_b + ext)
        a.delete_volume(EC_VID)
        ev_a, ev_b = a.mount_ec_shards(EC_VID), b.mount_ec_shards(EC_VID)
        if (ev_a.dat_size, sorted(ev_a.shards), sorted(ev_b.shards)) != (
                dat_size, list(range(7)), list(range(7, geo.n))):
            raise AssertionError("EC volume mounted with the wrong shards or size")
        shard_size = ev_a.shard_size

        order = sorted(want)
        on_lost = {}
        for nid in order:
            off, size = ev_a.find_needle(nid)
            on_lost[nid] = [iv.size for iv in locate(
                geo, dat_size, off, record_size_from_header(size))
                if iv.shard_and_offset(geo)[0] in lost]
        rstats: dict = {}
        reader = make_shard_reader(a, EC_VID, _serve(b, EC_VID), pool, rstats)

        def read_pass(tag: str) -> "dict[int, tuple]":
            """(latency, gather, decode) seconds of each sampled read."""
            out = {}
            for nid in order:
                g0, k0 = rstats.get("gather_s", 0.0), rstats.get("decode_s", 0.0)
                t = time.perf_counter()
                n = a.read_needle(EC_VID, nid, cookie=int(cookies[nid - 1]),
                                  shard_reader=reader)
                lat = time.perf_counter() - t
                out[nid] = (lat, rstats.get("gather_s", 0.0) - g0,
                            rstats.get("decode_s", 0.0) - k0)
                if n.data != want[nid]:
                    raise AssertionError(f"{tag} read of needle {nid} differs "
                                         "from what was written")
            return out

        healthy = read_pass("healthy")
        if rstats:
            raise AssertionError(f"healthy reads reconstructed: {rstats}")
        # a healthy read's parts, timed alone on a slice of the sample
        part = order[:2000]
        t_find, t_read, t_parse = [], [], []
        for nid in part:
            t = time.perf_counter()
            off, size = ev_a.find_needle(nid)
            t_find.append(time.perf_counter() - t)
            t = time.perf_counter()
            buf = ev_a.read_logical(off, record_size_from_header(size), reader)
            t_read.append(time.perf_counter() - t)
            t = time.perf_counter()
            Needle.from_bytes(buf)
            t_parse.append(time.perf_counter() - t)
        shard_hash = {s: _sha256((base_a if s < 7 else base_b) + files.shard_ext(s))
                      for s in range(geo.n)}
        for store, base, gone in ((a, base_a, A_LOST), (b, base_b, B_LOST)):
            for s in gone:
                os.unlink(base + files.shard_ext(s))
            store.mount_ec_shards(EC_VID)
        t0 = time.perf_counter()
        degraded = read_pass("degraded")
        pass_s = time.perf_counter() - t0
        expected = sum(len(v) for v in on_lost.values())
        if rstats.get("reconstructs", 0) != expected or not expected:
            raise AssertionError(f"{rstats.get('reconstructs', 0)} degraded "
                                 f"reconstructs; the sample's intervals on "
                                 f"lost shards number {expected}")
        deg_ids = [nid for nid in order if on_lost[nid]]
        lat, gat, dec = (np.array([degraded[i][j] for i in deg_ids]) for j in range(3))
        rest = lat - gat - dec
        h_lat = np.array([healthy[i][0] for i in order])

        def ms(xs, q: float) -> str:
            return f"{_pct(np, xs, q) * 1e3:.4f}"
        log(f"[ec] degraded pass on A: {len(order)} sampled needles == written "
            f"in {pass_s:.3f} s ({len(order) / pass_s:.0f} reads/s); "
            f"{len(deg_ids)} degraded reads, {expected} reconstructed intervals "
            f"== the sample's intervals on shards {sorted(lost)} [{card}]")
        log(f"[ec] degraded reads: {len(deg_ids) / lat.sum():.1f} reads/s one at "
            f"a time, p50 {ms(lat, 50)} ms, p99 {ms(lat, 99)} ms, mean "
            f"{lat.mean() * 1e3:.4f} ms; per read p50 (mean): gather "
            f"{ms(gat, 50)} ({gat.mean() * 1e3:.4f}) ms, K1 call with "
            f"host_result {ms(dec, 50)} ({dec.mean() * 1e3:.4f}) ms, rest "
            f"{ms(rest, 50)} ({rest.mean() * 1e3:.4f}) ms [{card}]")
        log(f"[ec] healthy reads of the same sample: p50 {ms(h_lat, 50)} ms, p99 "
            f"{ms(h_lat, 99)} ms, mean {h_lat.mean() * 1e3:.4f} ms; of the "
            f"degraded reads' needles p50 "
            f"{ms([healthy[i][0] for i in deg_ids], 50)} ms; parts timed alone "
            f"on {len(part)} of them, p50: .ecx search {ms(t_find, 50)} ms, "
            f"interval reads {ms(t_read, 50)} ms, needle parse and CRC "
            f"{ms(t_parse, 50)} ms [{card}]")

        rebuilt = {}
        for tag, store, peer, wanted, remote, base in (
                ("A", a, b, A_LOST, [s for s in range(7, geo.n) if s not in B_LOST],
                 base_a),
                ("B", b, a, B_LOST, list(range(7)), base_b)):
            st: dict = {}
            got = store.rebuild_ec_shards(EC_VID, shard_reader=_must(_serve(peer, EC_VID)),
                                          remote_shards=remote, wanted=list(wanted),
                                          stats=st)
            if got != list(wanted):
                raise AssertionError(f"server {tag} rebuilt {got}, not {wanted}")
            for s in wanted:
                if _sha256(base + files.shard_ext(s)) != shard_hash[s]:
                    raise AssertionError(f"server {tag}: rebuilt shard {s} differs")
            if st["bytes_read"] != geo.d * shard_size:
                raise AssertionError(f"server {tag} read {st['bytes_read']} B, "
                                     f"not d x {shard_size}")
            local_b = st["bytes_read"] - st["remote_bytes_read"]
            log(f"[ec] rebuild on {tag} of {tuple(wanted)}: {st['bytes_read']} B "
                f"read in {st['wall_s']:.3f} s = "
                f"{st['bytes_read'] / st['wall_s'] / 1e9:.3f} GB/s read; remote "
                f"survivors {st['remote_bytes_read']} B in "
                f"{st['remote_read_s']:.3f} s "
                f"({st['remote_bytes_read'] / st['remote_read_s'] / 1e9:.3f} GB/s), "
                f"local {local_b} B in {st['local_read_s']:.3f} s "
                f"({local_b / st['local_read_s'] / 1e9:.3f} GB/s); stages read "
                f"{st['read_s']:.3f} write {st['write_s']:.3f} flush "
                f"{st['flush_s']:.3f} s; == the lost shards' hashes [{card}]")
            rebuilt[tag] = st

        gone = order[0]
        if not a.find_ec_volume(EC_VID).delete_needle(gone):
            raise AssertionError(f"EC delete of needle {gone} found nothing")
        try:
            a.read_needle(EC_VID, gone, shard_reader=reader)
        except KeyError:
            pass
        else:
            raise AssertionError(f"deleted needle {gone} still reads")
        bits = [s.collect_heartbeat()["ec_shards"][0]["ec_index_bits"] for s in (a, b)]
        if bits != [(1 << 7) - 1, ((1 << geo.n) - 1) ^ ((1 << 7) - 1)]:
            raise AssertionError(f"heartbeat ec_index_bits {[hex(x) for x in bits]}")

        for s in range(7, geo.d):
            shutil.copy(base_b + files.shard_ext(s), base_a + files.shard_ext(s))
        t0 = time.perf_counter()
        v = a.ec_shards_to_volume(EC_VID)
        decode_s = time.perf_counter() - t0
        if _sha256(v.dat_path) != dat_hash:
            raise AssertionError("decoded .dat differs from the source's hash")
        for nid in order[1:]:
            if a.read_needle(EC_VID, nid, cookie=int(cookies[nid - 1])).data != want[nid]:
                raise AssertionError(f"needle {nid} differs after decode")
        try:
            a.read_needle(EC_VID, gone)
        except KeyError:
            pass
        else:
            raise AssertionError(f"deleted needle {gone} came back in the decode")
        t0 = time.perf_counter()
        a.reload_volume(EC_VID)
        load_s = time.perf_counter() - t0
        log(f"[ec] ec_shards_to_volume on A: {dat_size} B in {decode_s:.3f} s "
            f"({dat_size / decode_s / 1e9:.3f} GB/s; opening the decoded volume, "
            f"timed again as a reload: {load_s:.3f} s); .dat == source hash, "
            f"sample == written, deleted needle stays deleted; heartbeat "
            f"ec_index_bits A {bits[0]:#x}, B {bits[1]:#x} [{card}]")
        return dict(lengths=[ln for v in on_lost.values() for ln in v])
    finally:
        pool.shutdown()
        a.close()
        b.close()


def one_stripe_costs(torch, np, lengths, seed: int, card: str, d: int = 10,
                     p: int = 4, present=(1, 2, 3, 4, 6, 7, 8, 9, 11, 12),
                     split: bool = True, tag: "str | None" = None) -> dict:
    """One degraded interval's GF step at the path's typical length: K1 at
    [d, L] -> shard 0 (CUDA events), its bound and plain version; with
    `split`, also on the host clock the coder call the degraded read makes
    (pageable H2D, K1, a fresh pinned buffer and event per call) split into
    its parts, and the first call of a new survivor set (host GF inversion
    and table upload)."""
    from seaweedfs_tpu_torch.ops import rs_cuda, rs_torch
    from seaweedfs_tpu_torch.ops.coder import TorchCoder, host_result
    L = int(np.median(lengths))
    lost = (0,)
    rng = np.random.default_rng(seed + 9)
    arr = rng.integers(0, 256, (d, L), dtype=np.uint8)
    x = torch.from_numpy(arr).cuda()
    ms = _queued_ms(torch, lambda x: rs_cuda.reconstruct(x, present, lost, d, p),
                    [x], iters=500)
    rec = rs_torch.decode_rows(d, p, present, lost)
    plain_ms = _time_ms(torch, lambda s: rs_torch.gf_apply(rec, x), iters=50)
    bound_ms, bound_by = _bound(1, d, 1, L)
    tag = tag or ("ec" if split else "tier")
    log(f"[{tag}] K1 reconstruct one stripe RS({d},{p}) "
        f"[1, {d}, {L}] -> [1, 1, {L}]: {ms:.5f} ms, bound {bound_ms:.7f} ms "
        f"({bound_by}), {bound_ms / ms:.3%} of bound; plain version "
        f"{plain_ms:.4f} ms [{card}]")
    if not split:
        return dict(L=L, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by)
    coder = TorchCoder(d, p)

    def host_ms(fn, iters: int = 500) -> float:
        ts = []
        for _ in range(iters):
            t = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t)
        return _pct(np, ts, 50) * 1e3

    def to_device():
        coder._to_device(arr)
        torch.cuda.synchronize()
    out = rs_cuda.reconstruct(x, present, lost, d, p)
    call = host_ms(lambda: host_result(coder.reconstruct(arr, present, lost)))
    h2d = host_ms(to_device)
    launch = host_ms(lambda: (rs_cuda.reconstruct(x, present, lost, d, p),
                              torch.cuda.synchronize()))
    finish = host_ms(lambda: coder._finish(out).wait())
    firsts = []
    for i in range(20):
        rs_cuda._decode_rows.cache_clear()
        rs_cuda._tables.clear()
        t = time.perf_counter()
        host_result(coder.reconstruct(arr, present, lost))
        firsts.append(time.perf_counter() - t)
    rs_cuda._decode_rows.cache_clear()
    t = time.perf_counter()
    rs_cuda._decode_rows(d, p, present, lost)
    inv_ms = (time.perf_counter() - t) * 1e3
    log(f"[ec] one degraded interval's coder call, host clock p50: "
        f"TorchCoder.reconstruct + host_result {call:.4f} ms = pageable H2D "
        f"{h2d:.4f} ms + K1 launch to sync {launch:.4f} ms + pinned D2H buffer, "
        f"copy and event {finish:.4f} ms (each timed alone, synchronized); "
        f"first call of a new survivor set p50 {_pct(np, firsts, 50) * 1e3:.4f} ms, "
        f"of which the GF inversion {inv_ms:.4f} ms [{card}]")
    return dict(L=L, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, call_ms=call)


def phase_ec_store(torch, np, workdir: str, seed: int, card: str) -> "dict[str, int]":
    from seaweedfs_tpu_torch.ec.locate import EcGeometry
    from seaweedfs_tpu_torch.ops import rs_cuda
    os.makedirs(workdir, exist_ok=True)
    torch.cuda.synchronize()
    rs_cuda.reset_launches()
    res = ec_store_round_trip(np, workdir, seed + 13, card, EcGeometry(10, 4),
                              EC_STORE_NEEDLES, EC_SAMPLE)
    torch.cuda.synchronize()
    launches = dict(rs_cuda.launches_by_entry)
    log(f"[ec] K1 launches on the EC store path: {json.dumps(launches)} [{card}]")
    for entry in ("encode", "reconstruct"):
        if not launches.get(entry):
            raise AssertionError(f"K1 {entry} never launched on the EC store path")
    one_stripe_costs(torch, np, res["lengths"], seed, card)
    return launches


# -- phase 10 ---------------------------------------------------------------
def _vacuum(vs, vid: int):
    """VacuumVolumeCompact + VacuumVolumeCommit through the volume server's
    RPC bodies (a tiered volume is refused with FAILED_PRECONDITION);
    returns the compacted Volume and the bytes reclaimed."""
    reclaimed = vs.vacuum_volume_compact(vid)
    vs.vacuum_volume_commit(vid)
    return vs.store.find_volume(vid), reclaimed


def _timed_reads(order, read, counted) -> dict:
    """Read every id of `order` one at a time through read(nid); each read's
    latency, filed as cold when it made a remote object read, else warm."""
    out = {"cold": [], "warm": []}
    for nid in order:
        calls = counted["calls"]
        t = time.perf_counter()
        read(nid)
        out["cold" if counted["calls"] > calls else "warm"].append(
            time.perf_counter() - t)
    return out


def _lat(np, xs) -> str:
    if not xs:
        return "none"
    return (f"{len(xs)} reads p50 {_pct(np, xs, 50) * 1e3:.4f} ms p99 "
            f"{_pct(np, xs, 99) * 1e3:.4f} ms")


def tier_round_trip(np, workdir: str, seed: int, card: str, geo,
                    needles: int, sample: int, device: str = "cuda") -> dict:
    """Phase 10's path on one Store, every check fatal; logs the measured
    numbers and returns the K1 and K3 launch counts of its steps, the
    number of degraded reads and the degraded intervals' lengths."""
    from concurrent.futures import ThreadPoolExecutor
    from seaweedfs_tpu_torch.ec import files
    from seaweedfs_tpu_torch.ec.locate import locate
    from seaweedfs_tpu_torch.ops import crc_cuda, rs_cuda
    from seaweedfs_tpu_torch.server.volume_server import (
        FAILED_PRECONDITION, RpcAbort, VolumeServer, make_shard_reader)
    from seaweedfs_tpu_torch.storage import backend, scrub
    from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
    from seaweedfs_tpu_torch.storage.needle import Needle, record_size_from_header
    from seaweedfs_tpu_torch.storage.store import Store

    counted = collections.Counter()

    class CountingRemote(backend.LocalDirRemote):
        """The tier's client, counting its object reads."""

        def read_object(self, key: str, offset: int, size: int) -> bytes:
            counted["calls"] += 1
            counted["bytes"] += size
            return super().read_object(key, offset, size)

    ssd, hdd, tier = (os.path.join(workdir, x) for x in ("ssd", "hdd", "tier"))
    spec = f"local:{tier}"

    def locations():
        return [DiskLocation(ssd, disk_type="ssd"),
                DiskLocation(hdd, disk_type="hdd")]

    plain_remote, backend.LocalDirRemote = backend.LocalDirRemote, CountingRemote
    store = Store("127.0.0.1", 8080, "", locations(), ec_geometry=geo,
                  device=device)
    # the vacuum and tier moves run through the volume server's RPC bodies
    vs = VolumeServer(store, "127.0.0.1", 8080)
    pool = ThreadPoolExecutor(max_workers=4)
    out: dict = {}
    try:
        rng = np.random.default_rng(seed)
        sizes = 1024 + rng.integers(0, 64, needles)
        cookies = rng.integers(0, 1 << 32, needles, dtype=np.uint64)
        picked = rng.choice(needles, sample + TIER_CHURN, replace=False) + 1
        order = sorted(int(i) for i in picked[:sample])
        deleted = sorted(int(i) for i in picked[sample:])
        overwritten = order[::max(1, sample // TIER_CHURN)][:TIER_CHURN]
        in_sample = set(order)
        store.add_volume(EC_VID, disk_type="ssd")
        t0 = time.perf_counter()
        want = write_set(np, store, rng, sizes, cookies, in_sample)
        v = store.find_volume(EC_VID)
        log(f"[tier] wrote {needles} needles ({v.content_size} B of .dat) on "
            f"ssd through Store.write_needles_bulk in "
            f"{time.perf_counter() - t0:.1f} s")

        # 1. churn and vacuum
        dead = sum(record_size_from_header(v.nm.get(i).size)
                   for i in deleted + overwritten)
        size0 = v.content_size
        for i in deleted:
            if not store.delete_needle(EC_VID, i):
                raise AssertionError(f"delete of needle {i} found nothing")
        dead += v.content_size - size0  # the tombstone records
        fresh = [Needle(id=i, cookie=int(cookies[i - 1]), data=rng.bytes(1024))
                 for i in overwritten]
        store.write_needles_bulk(EC_VID, fresh)
        want.update((n.id, n.data) for n in fresh)
        before = v.content_size
        garbage = v.garbage_ratio()
        t0 = time.perf_counter()
        v, reclaimed = _vacuum(vs, EC_VID)
        vac_s = time.perf_counter() - t0
        if (v.garbage_ratio(), v.content_size, reclaimed) != (
                0.0, before - dead, dead):
            raise AssertionError(
                f"vacuum: garbage {v.garbage_ratio()}, .dat {v.content_size} B "
                f"(reclaimed {reclaimed}); {before} B less {dead} dead expected")
        if v.file_count != needles - len(deleted):
            raise AssertionError(f"vacuum kept {v.file_count} live needles")
        for i in deleted:
            try:
                store.read_needle(EC_VID, i)
            except KeyError:
                continue
            raise AssertionError(f"deleted needle {i} reads after the vacuum")
        log(f"[tier] vacuum of {before} B (garbage ratio {garbage:.6f}): "
            f"{dead} dead B reclaimed in {vac_s:.3f} s = "
            f"{before / vac_s / 1e9:.3f} GB/s of .dat; garbage 0, .dat {before} -> "
            f"{v.content_size} B [{card}]")

        # 2. move to hdd
        moved_b = os.path.getsize(v.dat_path) + os.path.getsize(v.idx_path)
        t0 = time.perf_counter()
        where = store.move_volume_local(EC_VID, "hdd")
        move_s = time.perf_counter() - t0
        v = store.find_volume(EC_VID)
        left = [n for n in os.listdir(ssd) if n.startswith(f"{EC_VID}.")]
        if where != os.path.abspath(hdd) or v.dir != where or left:
            raise AssertionError(f"move to hdd: now in {where}, ssd keeps {left}")
        dat_hash = _sha256(v.dat_path)
        log(f"[tier] move_volume_local ssd -> hdd: {moved_b} B in {move_s:.3f} s "
            f"= {moved_b / move_s / 1e9:.3f} GB/s; ssd copy gone [{card}]")

        # 3. tier the .dat up, read it through the RemoteDatFile
        t0 = time.perf_counter()
        up_b = vs.volume_tier_move_dat_to_remote(EC_VID, spec)["processed"]
        up_s = time.perf_counter() - t0
        v = store.find_volume(EC_VID)
        if v.remote_spec is None or os.path.exists(v.dat_path):
            raise AssertionError("the tiered volume still has a local .dat")

        def read_tiered(nid: int) -> None:
            n = store.read_needle(EC_VID, nid, cookie=int(cookies[nid - 1]))
            if n.data != want[nid]:
                raise AssertionError(f"tiered read of needle {nid} differs")
        tiered = _timed_reads(order, read_tiered, counted)
        try:
            store.write_needle(EC_VID, Needle(id=1, cookie=1, data=b"x"))
        except PermissionError:
            pass
        else:
            raise AssertionError("a tiered volume took a write")
        try:
            _vacuum(vs, EC_VID)
        except RpcAbort as e:
            if e.code != FAILED_PRECONDITION:
                raise
        else:
            raise AssertionError("a tiered volume was compacted")
        calls, k3 = counted["calls"], crc_cuda.launches
        res = scrub.scrub_volume(v, device=device)
        out["k3_tiered"] = crc_cuda.launches - k3
        if (res.mode, res.scanned, counted["calls"] - calls,
                out["k3_tiered"]) != ("skipped-tiered", 0, 0, 0):
            raise AssertionError(f"scrub of the tiered volume: {res}, "
                                 f"{counted['calls'] - calls} remote reads, "
                                 f"{out['k3_tiered']} K3 launches")
        second = Store("127.0.0.1", 8081, "", locations(), ec_geometry=geo,
                       device=device)
        try:
            sv = second.find_volume(EC_VID)
            if sv is None or sv.remote_spec != v.remote_spec:
                raise AssertionError("a second Store did not load the tiered volume")
            if second.read_needle(EC_VID, order[0]).data != want[order[0]]:
                raise AssertionError("the second Store's tiered read differs")
        finally:
            second.close()
        log(f"[tier] tier upload of {up_b} B in {up_s:.3f} s = "
            f"{up_b / up_s / 1e9:.3f} GB/s [{card}]")
        log(f"[tier] tiered needle reads through RemoteDatFile, {len(order)} "
            f"sampled == written: cold blocks {_lat(np, tiered['cold'])}, warm "
            f"blocks {_lat(np, tiered['warm'])} [{card}]")
        log("[tier] scrub of the tiered volume: skipped-tiered, 0 remote "
            "reads, 0 K3 launches; writes and vacuum refused; a second Store "
            "loads it")

        # 4. tier the .dat down, scrub it through K3
        t0 = time.perf_counter()
        down_b = vs.volume_tier_move_dat_from_remote(EC_VID)["processed"]
        down_s = time.perf_counter() - t0
        v = store.find_volume(EC_VID)
        if v.remote_spec is not None or _sha256(v.dat_path) != dat_hash:
            raise AssertionError("the downloaded .dat differs from the uploaded")
        crc_cuda.reset_launches()
        t0 = time.perf_counter()
        res = scrub.scrub_volume(v, device=device)
        scrub_s = time.perf_counter() - t0
        out["k3_scrub"] = crc_cuda.launches
        if (res.corrupt, res.error, res.scanned) != ([], "", v.file_count):
            raise AssertionError(f"scrub after the tier round trip: {res}; "
                                 f"{v.file_count} live")
        log(f"[tier] tier download of {down_b} B in {down_s:.3f} s = "
            f"{down_b / down_s / 1e9:.3f} GB/s; .dat == hash before the upload "
            f"[{card}]")
        log(f"[tier] scrub({device}) after vacuum, move and tier round trip: "
            f"{res.scanned} needles == live, 0 corrupt, in {scrub_s:.3f} s "
            f"({res.scanned / scrub_s:.0f} needles/s); K3 launches "
            f"{out['k3_scrub']} [{card}]")

        # 5. EC at RS(14,2), lose (0, 5), offload the rest
        rs_cuda.reset_launches()
        t0 = time.perf_counter()
        base = store.generate_ec_shards(EC_VID)
        enc_s = time.perf_counter() - t0
        dat_size = os.path.getsize(base + ".dat")
        shard_hash = {s: _sha256(base + files.shard_ext(s)) for s in range(geo.n)}
        store.delete_volume(EC_VID)
        ev = store.mount_ec_shards(EC_VID)
        shard_size = ev.shard_size
        for s in TIER_LOST:
            os.unlink(base + files.shard_ext(s))
        store.unmount_ec_shards(EC_VID, list(TIER_LOST))
        kept = [s for s in range(geo.n) if s not in TIER_LOST]
        t0 = time.perf_counter()
        off_b = store.offload_ec_shards(EC_VID, spec)
        off_s = time.perf_counter() - t0
        ev = store.find_ec_volume(EC_VID)
        rem = files.read_vif(base + ".vif").get("remote_shards", {})
        local = [n for n in os.listdir(hdd) if re.fullmatch(rf"{EC_VID}\.ec\d\d", n)]
        if (off_b, sorted(map(int, rem.get("keys", {}))), ev.remote_shard_ids(),
                local) != (len(kept) * shard_size, kept, kept, []):
            raise AssertionError(f"offload moved {off_b} B, sealed {rem}, serves "
                                 f"{ev.remote_shard_ids()} remote, leaves {local}")
        if store.offload_ec_shards(EC_VID, spec) != 0:
            raise AssertionError("a repeat offload moved bytes")
        try:
            store.offload_ec_shards(EC_VID, spec + "_other")
        except ValueError:
            pass
        else:
            raise AssertionError("an offload to a second tier was taken")
        log(f"[tier] Store.generate_ec_shards RS({geo.d},{geo.p}) of {dat_size} B "
            f"in {enc_s:.3f} s = {dat_size / enc_s / 1e9:.3f} GB/s; shards "
            f"{TIER_LOST} lost; offload of {len(kept)} shards, {off_b} B in "
            f"{off_s:.3f} s = {off_b / off_s / 1e9:.3f} GB/s; .vif remote_shards "
            f"{kept}, no local payload; a repeat offload moves 0 B, a second "
            f"tier is refused [{card}]")

        # 6. serve the sample from the tier
        on_lost = {}
        for nid in order:
            off, size = ev.find_needle(nid)
            on_lost[nid] = [iv.size for iv in locate(
                geo, dat_size, off, record_size_from_header(size))
                if iv.shard_and_offset(geo)[0] in TIER_LOST]
        expected = sum(len(x) for x in on_lost.values())
        rstats: dict = {}
        reader = make_shard_reader(store, EC_VID, lambda *a: None, pool, rstats)
        served = {"healthy": [], "degraded": []}
        cold = {"healthy": 0, "degraded": 0}
        t0 = time.perf_counter()
        for nid in order:
            calls = counted["calls"]
            t = time.perf_counter()
            n = store.read_needle(EC_VID, nid, cookie=int(cookies[nid - 1]),
                                  shard_reader=reader)
            kind = "degraded" if on_lost[nid] else "healthy"
            served[kind].append(time.perf_counter() - t)
            cold[kind] += counted["calls"] > calls
            if n.data != want[nid]:
                raise AssertionError(f"{kind} EC read of needle {nid} from the "
                                     "tier differs from what was written")
        pass_s = time.perf_counter() - t0
        if rstats.get("reconstructs", 0) != expected or not expected:
            raise AssertionError(f"{rstats.get('reconstructs', 0)} reconstructs; "
                                 f"the sample's intervals on {TIER_LOST} "
                                 f"number {expected}")
        out["degraded_reads"] = len(served["degraded"])
        for k, xs in served.items():
            log(f"[tier] {k} EC reads from the tier: {len(xs)} reads "
                f"({cold[k]} with a cold block), {len(xs) / sum(xs):.1f} "
                f"reads/s one at a time, p50 {_pct(np, xs, 50) * 1e3:.4f} ms, "
                f"p99 {_pct(np, xs, 99) * 1e3:.4f} ms [{card}]")
        log(f"[tier] {len(order)} sampled needles == written in {pass_s:.3f} s; "
            f"{expected} reconstructs == the sampled intervals on {TIER_LOST} "
            f"(gather {rstats['gather_s']:.3f} s, K1 call {rstats['decode_s']:.3f} s "
            f"in all) [{card}]")

        # 7. rebuild (0, 5) from the tier
        held = store.find_ec_volume(EC_VID)
        st: dict = {}
        t0 = time.perf_counter()
        got = store.rebuild_ec_shards(
            EC_VID, shard_reader=lambda sid, off, ln: held.shards[sid].read_at(off, ln),
            remote_shards=held.remote_shard_ids(), wanted=list(TIER_LOST), stats=st)
        reb_s = time.perf_counter() - t0
        if got != list(TIER_LOST) or st["remote_bytes_read"] != geo.d * shard_size:
            raise AssertionError(f"rebuilt {got}, {st['remote_bytes_read']} B "
                                 "read from the tier")
        for s in TIER_LOST:
            if _sha256(base + files.shard_ext(s)) != shard_hash[s]:
                raise AssertionError(f"shard {s} rebuilt from the tier differs")
        log(f"[tier] rebuild of {TIER_LOST} from the tier: {st['bytes_read']} B "
            f"read in {reb_s:.3f} s = {st['bytes_read'] / reb_s / 1e9:.3f} GB/s read; "
            f"stages read {st['read_s']:.3f} write {st['write_s']:.3f} flush "
            f"{st['flush_s']:.3f} s; == the lost shards' hashes [{card}]")

        # 8. promote, then decode
        t0 = time.perf_counter()
        prom_b = store.promote_ec_shards(EC_VID)
        prom_s = time.perf_counter() - t0
        ev = store.find_ec_volume(EC_VID)
        bad = [s for s in range(geo.n)
               if _sha256(base + files.shard_ext(s)) != shard_hash[s]]
        objects = plain_remote(tier).list_keys()
        if (prom_b, bad, objects, ev.remote_shard_ids()) != (off_b, [], [], []) \
                or "remote_shards" in files.read_vif(base + ".vif"):
            raise AssertionError(f"promote moved {prom_b} B; shards {bad} differ; "
                                 f"the tier holds {objects}")
        t0 = time.perf_counter()
        v = store.ec_shards_to_volume(EC_VID)
        dec_s = time.perf_counter() - t0
        out["k1"] = dict(rs_cuda.launches_by_entry)
        if _sha256(v.dat_path) != dat_hash:
            raise AssertionError("the decoded .dat differs from the source's hash")
        log(f"[tier] promote of {prom_b} B in {prom_s:.3f} s = "
            f"{prom_b / prom_s / 1e9:.3f} GB/s; all {geo.n} shards == their "
            f"hashes, the tier empty; ec_shards_to_volume in {dec_s:.3f} s, "
            f".dat == the source's hash [{card}]")
        out["lengths"] = [ln for x in on_lost.values() for ln in x]
        return out
    finally:
        backend.LocalDirRemote = plain_remote
        pool.shutdown()
        vs.stop()  # its read pools and the Store


def phase_tier(torch, np, workdir: str, seed: int, card: str) -> dict:
    from seaweedfs_tpu_torch.ec.locate import EcGeometry
    os.makedirs(workdir, exist_ok=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = tier_round_trip(np, workdir, seed + 17, card, EcGeometry(14, 2),
                          TIER_NEEDLES, EC_SAMPLE)
    torch.cuda.synchronize()
    log(f"[tier] K1 launches of the EC steps: {json.dumps(res['k1'])}; K3 "
        f"launches: tiered scrub {res['k3_tiered']}, scrub after the round "
        f"trip {res['k3_scrub']}; phase wall {time.perf_counter() - t0:.1f} s "
        f"[{card}]")
    for entry in ("encode", "reconstruct"):
        if not res["k1"].get(entry):
            raise AssertionError(f"K1 {entry} never launched on the tier path")
    if not res["k3_scrub"]:
        raise AssertionError("K3 never launched in the scrub after the tier "
                             "round trip")
    one_stripe_costs(torch, np, res["lengths"], seed, card, d=14, p=2,
                     present=tuple(i for i in range(16) if i not in TIER_LOST),
                     split=False)
    return res


# -- phase 11 ---------------------------------------------------------------
class K1Probe:
    """CUDA events around every K1 call made on the card while installed
    (rs_cuda.gf_apply, which every entry goes through), summed by entry.
    The events do not synchronise; take() does, and clears them."""

    def __init__(self, torch):
        from seaweedfs_tpu_torch.ops import rs_cuda
        self.torch, self.rs_cuda = torch, rs_cuda
        self.events: "dict[str, list]" = collections.defaultdict(list)

    def __enter__(self) -> "K1Probe":
        real = self._real = self.rs_cuda.gf_apply

        def timed(mat, data, seed=0, entry="apply"):
            if data.device.type != "cuda":
                return real(mat, data, seed, entry)
            ev = (self.torch.cuda.Event(enable_timing=True),
                  self.torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = real(mat, data, seed, entry)
            ev[1].record()
            self.events[entry].append(ev)
            return out
        self.rs_cuda.gf_apply = timed
        return self

    def __exit__(self, *exc) -> None:
        self.rs_cuda.gf_apply = self._real

    def take(self) -> str:
        """'entry N calls x ms' for each entry since the last take()."""
        if self.events:
            self.torch.cuda.synchronize()
        parts = [f"{entry} {len(evs)} calls "
                 f"{sum(a.elapsed_time(b) for a, b in evs):.3f} ms"
                 for entry, evs in sorted(self.events.items())]
        self.events.clear()
        return "; ".join(parts) or "no K1 call on the card"


def _stripes_against_plain(np, coder, base: str, shard_size: int, rng,
                           count: int = 8, width: int = 64) -> None:
    """The codec's parity at `count` seeded spots recomputed on the CPU by
    its plain version (`coder`, device="cpu"), against the shard files: for
    msr, the `width` columns at one inner offset of every sub-symbol; for
    piggyback, one column span of the a-half with its pair in the b-half."""
    from seaweedfs_tpu_torch.ec import files
    d, n = coder.d, coder.n
    maps = [np.memmap(base + files.shard_ext(i), dtype=np.uint8, mode="r")
            for i in range(n)]
    if coder.codec == "msr":
        s = shard_size // coder.alpha
        width = min(width, s)
        for _ in range(count):
            u = int(rng.integers(0, s - width + 1))
            idx = (np.arange(coder.alpha)[:, None] * s + u
                   + np.arange(width)[None, :]).reshape(-1)
            sub = np.stack([m[idx] for m in maps[:d]]).reshape(
                d, coder.alpha, width)
            got = np.stack([m[idx] for m in maps[d:]])
            if not np.array_equal(coder.encode_subsymbols(sub).reshape(
                    n - d, -1), got):
                raise AssertionError(f"msr parity at inner offset {u} "
                                     "differs from the plain version")
        return
    half = shard_size // 2
    width = min(width, half)
    for _ in range(count):
        u = int(rng.integers(0, half - width + 1))
        cols = np.r_[u:u + width, half + u:half + u + width]
        data = np.stack([m[cols] for m in maps[:d]])
        if not np.array_equal(coder.encode(data),
                              np.stack([m[cols] for m in maps[d:]])):
            raise AssertionError(f"piggyback parity at offset {u} differs "
                                 "from the plain version")


def _shard_hashes(base: str, n: int) -> "dict[int, str]":
    from seaweedfs_tpu_torch.ec import files
    return {s: _sha256(base + files.shard_ext(s)) for s in range(n)}


def _rebuild_line(tag: str, st: dict, wall: float, k1: str, card: str) -> str:
    read_s = st["local_read_s"] + st["remote_read_s"]
    return (f"[codec] {tag}: path {st['path']}, {st['bytes_read']} B read "
            f"({st['bytes_read'] / st['shard_size']:.2f} shards) in {wall:.3f} "
            f"s = {st['bytes_read'] / wall / 1e9:.3f} GB/s read, "
            f"{st['bytes_written']} B written = "
            f"{st['bytes_written'] / wall / 1e9:.3f} GB/s; survivor reads "
            f"{read_s:.3f} s, write {st['write_s']:.3f} s, flush "
            f"{st['flush_s']:.3f} s; K1 on the card: {k1} [{card}]")


def codec_round_trip(np, workdir: str, seed: int, card: str, blocks,
                     needles: int, sample: int, device: str = "cuda") -> dict:
    """Phase 11's path on one Store with (large, small) `blocks`, every
    check fatal: the phase-9 write set written once, sealed (a) with msr at
    RS(14,2) and (b) with piggyback at RS(10,4); degraded reads, ranged and
    general rebuilds, decode. Logs the measured numbers; returns the counts
    of degraded reads by kind."""
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from seaweedfs_tpu_torch.ec import files
    from seaweedfs_tpu_torch.ec.locate import EcGeometry, locate
    from seaweedfs_tpu_torch.ops.coder import codec_coder, repair_read_bytes
    from seaweedfs_tpu_torch.server.volume_server import make_shard_reader
    from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
    from seaweedfs_tpu_torch.storage.needle import record_size_from_header
    from seaweedfs_tpu_torch.storage.store import Store

    geo_msr, geo_pb = (EcGeometry(d, p, *blocks) for d, p in ((14, 2), (10, 4)))
    store = Store("127.0.0.1", 8080, "", [DiskLocation(workdir)],
                  ec_geometry=geo_msr, device=device)
    pool = ThreadPoolExecutor(max_workers=8)
    out: dict = {}
    try:
        rng = np.random.default_rng(seed)
        sizes = 1024 + rng.integers(0, 64, needles)
        cookies = rng.integers(0, 1 << 32, needles, dtype=np.uint64)
        order = sorted(int(i) for i in rng.choice(needles, sample, replace=False) + 1)
        store.add_volume(EC_VID)
        t0 = time.perf_counter()
        want = write_set(np, store, rng, sizes, cookies, set(order))
        base = store.find_volume(EC_VID).file_name()
        dat_size = os.path.getsize(base + ".dat")
        dat_hash = _sha256(base + ".dat")
        log(f"[codec] wrote {needles} needles ({dat_size} B of .dat) through "
            f"Store.write_needles_bulk in {time.perf_counter() - t0:.1f} s")

        recs: "dict[int, tuple[int, int]]" = {}  # .dat extents: codec-free

        def lost_intervals(ev, geo, lost) -> "dict[int, int]":
            """Sampled needle -> its intervals on the `lost` shards."""
            if not recs:
                for nid in order:
                    off, size = ev.find_needle(nid)
                    recs[nid] = (off, record_size_from_header(size))
            return {nid: sum(1 for iv in locate(geo, ev.dat_size, *recs[nid])
                             if iv.shard_and_offset(geo)[0] in lost)
                    for nid in order}

        def read_pass(tag: str, ids, reader, stats, kind) -> dict:
            """Read `ids` one at a time; each read's latency filed under
            kind(stats before, stats after)."""
            lat: dict = collections.defaultdict(list)
            t = time.perf_counter()
            for nid in ids:
                before = {k: (dict(v) if isinstance(v, dict) else v)
                          for k, v in stats.items()}
                t1 = time.perf_counter()
                n = store.read_needle(EC_VID, nid, cookie=int(cookies[nid - 1]),
                                      shard_reader=reader)
                lat[kind(before, stats)].append(time.perf_counter() - t1)
                if n.data != want[nid]:
                    raise AssertionError(f"{tag} read of needle {nid} differs "
                                         "from what was written")
            wall = time.perf_counter() - t
            for k, xs in sorted(lat.items()):
                log(f"[codec] {tag} reads, {k}: {_lat(np, xs)}, "
                    f"{len(xs) / sum(xs):.1f} reads/s one at a time [{card}]")
            log(f"[codec] {tag} pass: {len(ids)} needles == written in "
                f"{wall:.3f} s; reader stats "
                f"{json.dumps({k: v for k, v in stats.items() if 'mode' in k or k in ('reconstructs', 'strips', 'fetch_bytes')})}")
            return lat

        def msr_kind(before, after) -> str:
            if after.get("reconstructs", 0) == before.get("reconstructs", 0):
                return "healthy"
            modes = after.get("msr_mode", {})
            new = [m for m in modes if modes[m] != before.get("msr_mode", {}).get(m, 0)]
            return "degraded " + ",".join(sorted(new))

        def pb_kind(before, after) -> str:
            if after.get("reconstructs", 0) == before.get("reconstructs", 0):
                return "healthy"
            strip = after.get("strips", 0) != before.get("strips", 0)
            return "degraded " + ("strip" if strip else "plain")

        def lose(ids) -> None:
            for s in ids:
                os.unlink(base + files.shard_ext(s))
            store.mount_ec_shards(EC_VID)

        probe = K1Probe(torch)
        with probe:
            # (a) msr at geo_msr
            g = geo_msr
            st: dict = {}
            t0 = time.perf_counter()
            store.generate_ec_shards(EC_VID, codec="msr", stats=st)
            enc_s = time.perf_counter() - t0
            log(f"[codec] msr RS({g.d},{g.p}) generate_ec_shards of {dat_size} B "
                f"in {enc_s:.3f} s = {dat_size / enc_s / 1e9:.3f} GB/s end to "
                f"end; plain-RS slab stream {st['wall_s'] - st['seal_s']:.3f} s "
                f"(fill {st['fill_s']:.3f}, dispatch {st['dispatch_s']:.3f}); "
                f"overlay seal {st['overlay_s']:.3f} s = "
                f"{dat_size / st['overlay_s'] / 1e9:.3f} GB/s of .dat; seal "
                f"{st['seal_s']:.3f} s; K1 on the card: {probe.take()} [{card}]")
            shard_size = g.shard_file_size(dat_size)
            plain = codec_coder("msr", g.d, g.p, backend="torch", device="cpu")
            if shard_size % plain.alpha:
                raise AssertionError(f"shard {shard_size} B not divisible by "
                                     f"alpha {plain.alpha}")
            _stripes_against_plain(np, plain, base, shard_size, rng)
            hashes = _shard_hashes(base, g.n)
            store.delete_volume(EC_VID)
            ev = store.mount_ec_shards(EC_VID)
            if (ev.codec, ev.shard_size, sorted(ev.shards)) != (
                    "msr", shard_size, list(range(g.n))):
                raise AssertionError("msr EC volume mounted wrong")
            rstats: dict = {}
            reader = make_shard_reader(store, EC_VID, lambda *a: None, pool,
                                       rstats)
            read_pass("msr healthy", order, reader, rstats, msr_kind)
            if rstats:
                raise AssertionError(f"healthy reads reconstructed: {rstats}")
            on = lost_intervals(ev, g, {MSR_LOST})
            lose((MSR_LOST,))
            read_pass(f"msr shard {MSR_LOST} lost", order, reader, rstats,
                      msr_kind)
            k1 = probe.take()
            log(f"[codec] K1 in those reads: {k1} [{card}]")
            if rstats.get("reconstructs", 0) != sum(on.values()) or not any(on.values()):
                raise AssertionError(f"{rstats.get('reconstructs')} reconstructs; "
                                     f"the sample's intervals on shard "
                                     f"{MSR_LOST} number {sum(on.values())}")
            if {m for k in rstats["msr_mode"] for m in k.split("+")} != {"repair"}:
                raise AssertionError(f"msr modes {rstats['msr_mode']}: all 15 "
                                     "helpers were present")
            out["msr_repair_reads"] = sum(1 for v in on.values() if v)
            st = {}
            t0 = time.perf_counter()
            got = store.rebuild_ec_shards(EC_VID, wanted=[MSR_LOST], stats=st)
            wall = time.perf_counter() - t0
            want_b = repair_read_bytes("msr", g.d, g.p, [MSR_LOST], shard_size)
            if got != [MSR_LOST] or st["path"] != "ranged" or \
                    st["bytes_read"] != want_b:
                raise AssertionError(f"msr single rebuild {got} path "
                                     f"{st['path']} read {st['bytes_read']} B, "
                                     f"not {want_b}")
            if _sha256(base + files.shard_ext(MSR_LOST)) != hashes[MSR_LOST]:
                raise AssertionError(f"rebuilt shard {MSR_LOST} differs")
            log(_rebuild_line(f"msr single-loss rebuild of {MSR_LOST} "
                              f"(== repair_read_bytes, == hash)", st, wall,
                              probe.take(), card))
            ev = store.mount_ec_shards(EC_VID)
            on = lost_intervals(ev, g, set(MSR_LOST2))
            lose(MSR_LOST2)
            rstats.clear()
            read_pass(f"msr shards {MSR_LOST2} lost",
                      [i for i in order if on[i]], reader, rstats, msr_kind)
            log(f"[codec] K1 in those reads: {probe.take()} [{card}]")
            if rstats.get("reconstructs", 0) != sum(on.values()):
                raise AssertionError(f"{rstats.get('reconstructs')} reconstructs; "
                                     f"the sample's intervals on {MSR_LOST2} "
                                     f"number {sum(on.values())}")
            if {m for k in rstats["msr_mode"] for m in k.split("+")} != {"general"}:
                raise AssertionError(f"msr modes {rstats['msr_mode']} with two "
                                     "shards lost")
            out["msr_general_reads"] = sum(1 for v in on.values() if v)
            st = {}
            t0 = time.perf_counter()
            got = store.rebuild_ec_shards(EC_VID, stats=st)
            wall = time.perf_counter() - t0
            if got != list(MSR_LOST2) or st["path"] != "general" or \
                    st["bytes_read"] != g.d * shard_size:
                raise AssertionError(f"msr general rebuild {got} path "
                                     f"{st['path']} read {st['bytes_read']} B")
            for s in MSR_LOST2:
                if _sha256(base + files.shard_ext(s)) != hashes[s]:
                    raise AssertionError(f"rebuilt shard {s} differs")
            log(_rebuild_line(f"msr general rebuild of {MSR_LOST2} (== hashes)",
                              st, wall, probe.take(), card))
            store.mount_ec_shards(EC_VID)
            t0 = time.perf_counter()
            v = store.ec_shards_to_volume(EC_VID)
            dec_s = time.perf_counter() - t0
            if _sha256(v.dat_path) != dat_hash:
                raise AssertionError("decoded .dat differs from the source's hash")
            log(f"[codec] msr ec_shards_to_volume in {dec_s:.3f} s, .dat == the "
                f"source's hash [{card}]")

            # (b) piggyback at geo_pb, on the decoded volume
            g = geo_pb
            for ext in [files.shard_ext(i) for i in range(geo_msr.n)] + [
                    ".ecx", ".ecj", ".vif"]:
                if os.path.exists(base + ext):
                    os.unlink(base + ext)
            st = {}
            t0 = time.perf_counter()
            store.generate_ec_shards(EC_VID, d=g.d, p=g.p, codec="piggyback",
                                     stats=st)
            enc_s = time.perf_counter() - t0
            log(f"[codec] piggyback RS({g.d},{g.p}) generate_ec_shards of "
                f"{dat_size} B in {enc_s:.3f} s = {dat_size / enc_s / 1e9:.3f} "
                f"GB/s end to end; plain-RS slab stream "
                f"{st['wall_s'] - st['seal_s']:.3f} s; overlay seal "
                f"{st['overlay_s']:.3f} s = {dat_size / st['overlay_s'] / 1e9:.3f} "
                f"GB/s of .dat; seal {st['seal_s']:.3f} s; K1 on the card: "
                f"{probe.take()} [{card}]")
            shard_size = g.shard_file_size(dat_size)
            _stripes_against_plain(np, codec_coder("piggyback", g.d, g.p,
                                                   backend="torch", device="cpu"),
                                   base, shard_size, rng)
            hashes = _shard_hashes(base, g.n)
            store.delete_volume(EC_VID)
            ev = store.mount_ec_shards(EC_VID)
            if (ev.codec, ev.geo.d, ev.shard_size) != ("piggyback", g.d, shard_size):
                raise AssertionError("piggyback EC volume mounted wrong")
            on = lost_intervals(ev, g, set(PB_LOST))
            lose(PB_LOST)
            rstats = {}
            reader = make_shard_reader(store, EC_VID, lambda *a: None, pool,
                                       rstats)
            lat = read_pass(f"piggyback shards {PB_LOST} lost",
                            [i for i in order if on[i]], reader, rstats, pb_kind)
            log(f"[codec] K1 in those reads: {probe.take()} [{card}]")
            if rstats.get("reconstructs", 0) != sum(on.values()) or \
                    not rstats.get("strips"):
                raise AssertionError(f"piggyback reads {rstats}; the sample's "
                                     f"intervals on {PB_LOST} number "
                                     f"{sum(on.values())}")
            out["pb_strip_reads"] = len(lat.get("degraded strip", ()))
            out["pb_plain_reads"] = len(lat.get("degraded plain", ()))
            st = {}
            t0 = time.perf_counter()
            got = store.rebuild_ec_shards(EC_VID, stats=st)
            wall = time.perf_counter() - t0
            if got != list(PB_LOST) or st["path"] != "general":
                raise AssertionError(f"piggyback rebuild {got} path {st['path']}")
            for s in PB_LOST:
                if _sha256(base + files.shard_ext(s)) != hashes[s]:
                    raise AssertionError(f"rebuilt shard {s} differs")
            log(_rebuild_line(f"piggyback general rebuild of {PB_LOST} "
                              "(== hashes)", st, wall, probe.take(), card))
            f = PB_LOST[0]
            store.mount_ec_shards(EC_VID)
            lose((f,))
            st = {}
            t0 = time.perf_counter()
            got = store.rebuild_ec_shards(EC_VID, stats=st)
            wall = time.perf_counter() - t0
            want_b = repair_read_bytes("piggyback", g.d, g.p, [f], shard_size)
            if got != [f] or st["path"] != "ranged" or st["bytes_read"] != want_b \
                    or 10 * want_b != 7 * g.d * shard_size:
                raise AssertionError(f"piggyback single rebuild {got} path "
                                     f"{st['path']} read {st['bytes_read']} B, "
                                     f"not {want_b} = 0.70 of plain RS")
            if _sha256(base + files.shard_ext(f)) != hashes[f]:
                raise AssertionError(f"rebuilt shard {f} differs")
            log(_rebuild_line(f"piggyback single-loss rebuild of {f} (0.70 of "
                              "plain RS, == hash)", st, wall, probe.take(), card))
        return out
    finally:
        pool.shutdown()
        store.close()


def phase_codecs(torch, np, workdir: str, seed: int, card: str) -> "dict[str, int]":
    from seaweedfs_tpu_torch.ops import rs_cuda
    os.makedirs(workdir, exist_ok=True)
    torch.cuda.synchronize()
    rs_cuda.reset_launches()
    t0 = time.perf_counter()
    res = codec_round_trip(np, workdir, seed + 19, card, (GiB, MiB),
                           EC_STORE_NEEDLES, CODEC_SAMPLE)
    torch.cuda.synchronize()
    launches = dict(rs_cuda.launches_by_entry)
    log(f"[codec] K1 launches on the codec path: {json.dumps(launches)}; "
        f"degraded reads {json.dumps(res)}; phase wall "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    for entry in ("encode", "reconstruct", "apply"):
        if not launches.get(entry):
            raise AssertionError(f"K1 {entry} never launched on the codec path")
    return launches


# -- phase 12 ---------------------------------------------------------------
def _host_cpu() -> str:
    """The host CPU as /proc/cpuinfo names it (vendor, family, model and
    model name of the first processor), with the number of CPUs."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                key = key.strip()
                if key in ("vendor_id", "cpu family", "model", "model name",
                           "cpu MHz") and key not in fields:
                    fields[key] = value.strip()
    except OSError:
        return "a CPU /proc/cpuinfo does not describe"
    return (f"{fields.get('model name', '?')} ({fields.get('vendor_id', '?')} "
            f"family {fields.get('cpu family', '?')} model "
            f"{fields.get('model', '?')}, {fields.get('cpu MHz', '?')} MHz; "
            f"{os.cpu_count()} CPUs)")


def _trace_breakdown(path: str, steps: int) -> str:
    """Device time per step by kernel or copy name, from a Chrome trace of
    torch.profiler (utils/profiling.start_device_trace)."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    by_name = collections.Counter()
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in ("kernel", "gpu_memcpy",
                                                     "gpu_memset"):
            by_name[ev.get("name", "?")[:60]] += ev.get("dur", 0.0)
    if not by_name:
        return "no device events in the trace (not measured)"
    total = sum(by_name.values())
    return (f"device {total / 1e3 / steps:.3f} ms a step: " + "; ".join(
        f"{name} {us / 1e3 / steps:.3f}" for name, us in by_name.most_common(8)))


def _scrub_batches(np, rng):
    """The scrub's write set as the mesh scrub reads it: MESH_SCRUB_NEEDLES
    needles of 1024 + 0..63 B (phase 8's sizes), left-padded into
    [4096, 2048] batches, with their stored raw CRC states (the host's
    SSE4.2 CRC of each intact padded row from init 0, as written, through
    the native library's crc32c_batch); then MESH_DAMAGED needles damaged
    by one flipped payload byte each. Returns (batches, states, damaged)."""
    from seaweedfs_tpu_torch.ops import native
    lib = native.load()
    rows, width = MESH_SCRUB_BATCH
    n_batches = MESH_SCRUB_NEEDLES // rows
    words = rng.integers(0, 2**64 - 1, n_batches * rows * width // 8,
                         dtype=np.uint64, endpoint=True)
    allblk = words.view(np.uint8).reshape(n_batches, rows, width)
    sizes = 1024 + rng.integers(0, 64, (n_batches, rows))
    cols = np.arange(width)
    batches, states = [], []
    for blk, sz in zip(allblk, sizes):
        blk[cols[None, :] < (width - sz)[:, None]] = 0
        st = np.empty(rows, dtype=np.uint32)
        lib.crc32c_batch(blk.ctypes.data, width, rows, 0, st.ctypes.data)
        states.append(st.astype(np.int64))
        batches.append((blk, sz))
    picks = rng.choice(MESH_SCRUB_NEEDLES, MESH_DAMAGED, replace=False)
    for i in picks:
        blk, sz = batches[i // rows]
        r = i % rows
        blk[r, width - 1 - int(rng.integers(0, sz[r]))] ^= 0x5A
    return batches, states, sorted(int(i) for i in picks)


def phase_mesh(torch, np, workdir: str, seed: int, card: str) -> dict:
    """The multi-device EC step on a 1x1 NCCL mesh; returns the kernel
    launches of its counted run and its times."""
    import torch.distributed as dist

    from seaweedfs_tpu_torch.ec import stream
    from seaweedfs_tpu_torch.ec.locate import EcGeometry
    from seaweedfs_tpu_torch.entry import dryrun_multichip
    from seaweedfs_tpu_torch.models.ec_pipeline import ECPipeline
    from seaweedfs_tpu_torch.ops import crc_cuda, native, rs_cuda
    from seaweedfs_tpu_torch.ops.coder import TorchCoder
    from seaweedfs_tpu_torch.parallel import pipeline as pp
    from seaweedfs_tpu_torch.parallel.mesh import AXES, build_mesh
    from seaweedfs_tpu_torch.utils import profiling
    os.makedirs(workdir, exist_ok=True)
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 23)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 23)
    steps = {(d, p): torch.randint(0, 256, (MAIN_SHAPE[0], d, MAIN_SHAPE[2]),
                                   dtype=torch.uint8, device="cuda",
                                   generator=gen)
             for d, p, _ in MESH_STEPS}
    dat = os.path.join(workdir, "mesh.dat")
    make_dat(np, dat, MESH_DAT, seed + 23)
    batches, states, damaged = _scrub_batches(np, rng)
    geo = EcGeometry(10, 4)  # 1 GiB / 1 MiB blocks
    log(f"[mesh] inputs: steps {[list(t.shape) for t in steps.values()]}, "
        f".dat {MESH_DAT} B, {len(batches)} scrub batches of "
        f"{list(MESH_SCRUB_BATCH)}, damaged needles {damaged} "
        f"({time.perf_counter() - t_phase:.1f} s) [{card}]")

    t0 = time.perf_counter()
    mesh = build_mesh(device="cuda")
    backend = str(dist.get_backend())
    log(f"[mesh] {mesh}: world {dist.get_world_size()} over {backend} in "
        f"{time.perf_counter() - t0:.2f} s [{card}]")
    if backend != "nccl" or mesh.shape != {"data": 1, "shard": 1}:
        raise AssertionError(f"expected a 1x1 NCCL mesh, got {mesh} on {backend}")
    res = {}
    try:
        torch.cuda.synchronize()
        rs_cuda.reset_launches()
        crc_cuda.reset_launches()
        # (a) the step, (b) MeshCoder through encode_volumes, (c) the scrub
        pipes = {}
        for d, p, lost in MESH_STEPS:
            pipes[(d, p)] = ECPipeline(d=d, p=p, mesh=mesh)
            out = pipes[(d, p)].step(steps[(d, p)], lost)
            mism = int(out["rebuild_mismatch_bytes"].item())
            log(f"[mesh] step RS({d},{p}) [{MAIN_SHAPE[0]}, {d}, "
                f"{MAIN_SHAPE[2]}] lost {lost}: mismatch {mism}, "
                f"bytes_encoded {int(out['bytes_encoded'].item())}")
            if mism:
                raise AssertionError(f"step RS({d},{p}) mismatch {mism}")
        mesh_base = os.path.join(workdir, "mesh")
        st = {}
        t0 = time.perf_counter()
        stream.encode_volumes([(dat, mesh_base, None)], geo,
                              pp.MeshCoder(mesh, 10, 4), batch=32, stats=st)
        res["mesh_encode_s"] = time.perf_counter() - t0
        count = 0
        t0 = time.perf_counter()
        for (blk, _), want in zip(batches, states):
            bad = pp.scrub_sharded(mesh, pp.shard_put(mesh, blk, (AXES, None)),
                                   pp.shard_put(mesh, want, (AXES,)))
            count += int(bad.item())
        res["scrub_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = {"k1": dict(rs_cuda.launches_by_entry),
                    "k3": crc_cuda.launches}
        log(f"[mesh] kernel launches on the mesh path: {json.dumps(launches)}")
        if not (launches["k1"].get("encode") and launches["k1"].get("reconstruct")
                and launches["k3"]):
            raise AssertionError("K1 encode, K1 reconstruct or K3 never "
                                 "launched on the mesh path")
        if count != MESH_DAMAGED:
            raise AssertionError(f"mesh scrub counted {count} damaged needles, "
                                 f"want {MESH_DAMAGED}")
        log(f"[mesh] scrub of {MESH_SCRUB_NEEDLES} needles through K3 and "
            f"the all_reduce: {count} damaged (want {MESH_DAMAGED}), "
            f"{res['scrub_s']:.3f} s = "
            f"{MESH_SCRUB_NEEDLES / res['scrub_s']:.0f} needles/s [{card}]")
        res["launches"] = launches

        # outside the counts: the TorchCoder encode of the same .dat
        torch_base = os.path.join(workdir, "torch")
        t0 = time.perf_counter()
        stream.encode_volumes([(dat, torch_base, None)], geo,
                              TorchCoder(10, 4), batch=32)
        res["torch_encode_s"] = time.perf_counter() - t0
        for s in range(geo.n):
            ext = f".ec{s:02d}"
            if _sha256(mesh_base + ext) != _sha256(torch_base + ext):
                raise AssertionError(f"MeshCoder shard {s} differs from "
                                     f"TorchCoder's")
        log(f"[mesh] MeshCoder encode_volumes of {MESH_DAT} B at RS(10,4), "
            f"batch 32: {res['mesh_encode_s']:.3f} s = "
            f"{MESH_DAT / res['mesh_encode_s'] / 1e9:.3f} GB/s (dispatch "
            f"{st['dispatch_s']:.3f}, drain {st['drain_block_s']:.3f}, seal "
            f"{st['seal_s']:.3f} s); TorchCoder {res['torch_encode_s']:.3f} s "
            f"= {MESH_DAT / res['torch_encode_s'] / 1e9:.3f} GB/s; all 14 "
            f"shard sha256 equal [{card}]")

        # the step's time beside forward + reconstruct without the mesh
        for d, p, lost in MESH_STEPS:
            data = steps[(d, p)]
            use = tuple(i for i in range(d + p) if i not in lost)[:d]
            rows = tuple(range(d + p))

            def plain(_, data=data, d=d, p=p, use=use, rows=rows):
                full = torch.cat([data, rs_cuda.encode(data, d, p)], 1)
                return rs_cuda.reconstruct(full[:, list(use)].contiguous(),
                                           use, rows, d, p)

            def step(_, pipe=pipes[(d, p)], data=data, lost=lost):
                return pipe.step(data, lost)

            plain_ms = _time_ms(torch, plain, 10)
            step_ms = _time_ms(torch, step, 10)
            res[f"step_{d}_{p}"] = (step_ms, plain_ms)
            log(f"[mesh] step RS({d},{p}) [{MAIN_SHAPE[0]}, {d}, "
                f"{MAIN_SHAPE[2]}]: {step_ms:.4f} ms by CUDA events; forward "
                f"+ reconstruct of all {d + p} rows without the mesh "
                f"{plain_ms:.4f} ms; the collective layer on one rank "
                f"{step_ms - plain_ms:.4f} ms [{card}]")
        # where the step's device time goes: one torch.profiler capture
        # through the port's profiling hook around 5 steps at RS(10,4)
        torch.cuda.synchronize()
        profiling.start_device_trace(out_dir=workdir)
        for _ in range(5):
            pipes[(10, 4)].step(steps[(10, 4)], MESH_STEPS[0][2])
        torch.cuda.synchronize()
        trace = profiling.stop_device_trace()
        log(f"[mesh] step RS(10,4) under torch.profiler, "
            f"{_trace_breakdown(trace, 5)} [{card}]")
    finally:
        mesh.close()

    # the native CPU coder on this host against K1
    x = steps[(10, 4)]
    host = x.cpu().numpy()
    nat = native.NativeCoder(10, 4)
    t0 = time.perf_counter()
    got = nat.encode(host)
    native_s = time.perf_counter() - t0
    for _ in range(2):
        t0 = time.perf_counter()
        nat.encode(host)
        native_s = min(native_s, time.perf_counter() - t0)
    k1 = rs_cuda.encode(x, 10, 4).cpu().numpy()
    if not np.array_equal(got, k1):
        raise AssertionError("NativeCoder differs from K1 at [32, 10, 1 MiB]")
    k1_ms = _time_ms(torch, lambda i: rs_cuda.encode(x, 10, 4), 20)
    res["native"] = (native_s * 1e3, k1_ms)
    log(f"[mesh] NativeCoder [32, 10, 1 MiB] == K1, byte for byte; native "
        f"{native_s * 1e3:.2f} ms = {x.numel() / native_s / 1e9:.3f} GB/s on "
        f"one thread of {_host_cpu()} ({json.dumps(native.features())}); K1 "
        f"{k1_ms:.4f} ms = {x.numel() / k1_ms / 1e6:.1f} GB/s [{card}]")
    del steps, x

    t0 = time.perf_counter()
    reports = dryrun_multichip(1)
    log(f"[mesh] dryrun_multichip(1) on one launched rank: "
        f"{json.dumps(reports)} in {time.perf_counter() - t0:.1f} s [{card}]")
    log(f"[mesh] phase wall {time.perf_counter() - t_phase:.1f} s [{card}]")
    return res


# -- phase 13 ---------------------------------------------------------------
def _free_port() -> int:
    """A free localhost port whose +10000 gRPC sibling is free and valid."""
    import socket
    for _ in range(200):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        if port + 10000 >= 65536:
            continue
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", port + 10000))
            return port
        except OSError:
            continue
    raise RuntimeError("no free port pair")


class _Client:
    """One HTTP/1.1 client on one keep-alive connection (a user's reads
    one at a time)."""

    def __init__(self, url: str):
        import http.client
        host, port = url.rsplit(":", 1)
        self.conn = http.client.HTTPConnection(host, int(port), timeout=60)

    def request(self, method: str, path: str, body: bytes = None,
                headers: "dict | None" = None) -> "tuple[int, bytes, dict]":
        self.conn.request(method, path, body=body, headers=headers or {})
        r = self.conn.getresponse()
        return r.status, r.read(), dict(r.getheaders())

    def close(self) -> None:
        self.conn.close()


def _intervals(ev, geo, nid: int) -> "list[tuple[int, int]]":
    """(shard, length) of each interval of needle `nid` of EC volume `ev`."""
    from seaweedfs_tpu_torch.ec.locate import locate
    from seaweedfs_tpu_torch.storage.needle import record_size_from_header
    off, size = ev.find_needle(nid)
    return [(iv.shard_and_offset(geo)[0], iv.size) for iv in locate(
        geo, ev.dat_size, off, record_size_from_header(size))]


def server_round_trip(np, workdir: str, seed: int, card: str, geo,
                      needles: int, sample: int, http_needles: int,
                      scrub_needles: int, device: str = "cuda",
                      grpc_pass: bool = GRPC_ON_CARD) -> dict:
    """Phase 13's path through three volume servers, every check fatal;
    logs the measured numbers and returns them with the degraded
    intervals' lengths."""
    from seaweedfs_tpu_torch.ec import files
    from seaweedfs_tpu_torch.ops import crc_cuda
    from seaweedfs_tpu_torch.server.volume_server import LocalPeers, VolumeServer
    from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.store import Store
    from seaweedfs_tpu_torch.storage.types import file_id
    from seaweedfs_tpu_torch.utils import retry

    lost = {"a": A_LOST, "b": B_LOST}
    servers = {}
    for x in "abc":
        port = _free_port()
        store = Store("127.0.0.1", port, "", [DiskLocation(os.path.join(
            workdir, f"server_{x}"))], ec_geometry=geo, coder_name="torch",
            device=device)
        servers[x] = VolumeServer(store, "127.0.0.1", port)
    a, b, c = servers["a"], servers["b"], servers["c"]
    peers = LocalPeers({vs.peer_address: vs for vs in servers.values()})
    client = None
    grpc_servers = []
    out: dict = {}
    retry.reset_breakers()
    try:
        for vs in servers.values():
            vs.start()
        client = _Client(a.url)

        # 2. write: the bulk write set on A, then needles over HTTP
        rng = np.random.default_rng(seed)
        sizes = 1024 + rng.integers(0, 64, needles)
        cookies = rng.integers(0, 1 << 32, needles, dtype=np.uint64)
        order = sorted(int(i) for i in rng.choice(needles, sample,
                                                   replace=False) + 1)
        a.allocate_volume(EC_VID)
        t0 = time.perf_counter()
        want = write_set(np, a.store, rng, sizes, cookies, set(order))
        bulk_s = time.perf_counter() - t0
        posted = {}
        t0 = time.perf_counter()
        for i in range(needles + 1, needles + http_needles + 1):
            body = rng.bytes(int(1024 + rng.integers(0, 64)))
            fid = file_id(EC_VID, i, int(rng.integers(1, 1 << 32)))
            st, resp, _ = client.request("POST", f"/{fid}", body)
            if st != 201 or json.loads(resp)["size"] != len(body):
                raise AssertionError(f"POST of {fid}: {st} {resp[:200]!r}")
            posted[fid] = body
        post_s = time.perf_counter() - t0
        for fid, body in posted.items():
            st, got, _ = client.request("GET", f"/{fid}")
            if (st, got) != (200, body):
                raise AssertionError(f"GET of posted {fid}: {st}")
        base_a = a.store.find_volume(EC_VID).file_name()
        a.store.find_volume(EC_VID).sync()
        dat_size = os.path.getsize(base_a + ".dat")
        dat_hash = _sha256(base_a + ".dat")
        log(f"[server] A: {needles} needles through Store.write_needles_bulk "
            f"in {bulk_s:.1f} s, then {http_needles} POSTed over HTTP in "
            f"{post_s:.3f} s ({http_needles / post_s:.0f} writes/s, one "
            f"client), each acknowledged and read back by GET; .dat {dat_size} B")

        # 3. encode and spread
        a.volume_mark_readonly(EC_VID)
        t0 = time.perf_counter()
        a.volume_ec_shards_generate(EC_VID)
        gen_s = time.perf_counter() - t0
        b.volume_ec_shards_copy(EC_VID, shard_ids=list(range(7, geo.n)),
                                copy_ecx_file=True, copy_vif_file=True,
                                source_data_node=a.peer_address)
        a.volume_ec_shards_mount(EC_VID)
        b.volume_ec_shards_mount(EC_VID)
        a.volume_ec_shards_delete(EC_VID, shard_ids=list(range(7, geo.n)))
        a.volume_delete(EC_VID)
        base_b = b.store.find_ec_volume(EC_VID).base
        ev_a, ev_b = (s.store.find_ec_volume(EC_VID) for s in (a, b))
        if (ev_a.dat_size, sorted(ev_a.shards), sorted(ev_b.shards)) != (
                dat_size, list(range(7)), list(range(7, geo.n))):
            raise AssertionError("EC volume mounted with the wrong shards")
        shard_hash = {s: _sha256((base_a if s < 7 else base_b)
                                 + files.shard_ext(s)) for s in range(geo.n)}
        log(f"[server] VolumeEcShardsGenerate RS({geo.d},{geo.p}) of {dat_size} "
            f"B in {gen_s:.3f} s = {dat_size / gen_s / 1e9:.3f} GB/s; shards "
            f"7-{geo.n - 1} with the .ecx and .vif copied to B through "
            f"CopyFile on the peer plane, mounted, deleted on A, source "
            f"volume deleted [{card}]")

        ivs = {nid: _intervals(ev_a, geo, nid) for nid in order}
        fids = {nid: file_id(EC_VID, nid, int(cookies[nid - 1])) for nid in order}
        ranged = set(order[::4])  # a quarter of the reads carry a Range

        def read_pass(tag: str, ids=None) -> "list[float]":
            """GET each sampled needle (or `ids`) from A; the latencies."""
            lat = []
            for nid in order if ids is None else ids:
                hdr = {}
                data = want[nid]
                if nid in ranged:
                    lo = nid % 97
                    hi = min(len(data), lo + 511)
                    hdr = {"Range": f"bytes={lo}-{hi - 1}"}
                    data = data[lo:hi]
                t = time.perf_counter()
                st, got, _ = client.request("GET", f"/{fids[nid]}",
                                            headers=hdr)
                lat.append(time.perf_counter() - t)
                if (st, got) != (206 if hdr else 200, data):
                    raise AssertionError(f"{tag} GET of needle {nid}: {st}, "
                                         f"body {'==' if got == data else '!='}")
            return lat

        def ms(xs, q):
            return _pct(np, xs, q) * 1e3

        # 4. healthy reads
        healthy = read_pass("healthy")
        if a.read_stats.get("reconstructs"):
            raise AssertionError("healthy reads reconstructed")
        out["healthy"] = healthy
        log(f"[server] healthy GETs on A: {len(order)} sampled needles "
            f"({len(ranged)} ranged) == written; p50 {ms(healthy, 50):.4f} ms, "
            f"p99 {ms(healthy, 99):.4f} ms, {len(order) / sum(healthy):.1f} "
            f"reads/s one client [{card}]")
        # the HTTP layer's cost: a slice of the sample read through the
        # server without HTTP, by GET, and the round trip of GET /status
        part = order[:2000]
        t_read, t_get, t_status = [], [], []
        for nid in part:
            t = time.perf_counter()
            a._store_read(EC_VID, nid, int(cookies[nid - 1]))
            t_read.append(time.perf_counter() - t)
            t = time.perf_counter()
            client.request("GET", f"/{fids[nid]}")
            t_get.append(time.perf_counter() - t)
            t = time.perf_counter()
            client.request("GET", "/status")
            t_status.append(time.perf_counter() - t)
        log(f"[server] the same reads' parts on {len(part)} of them, p50: "
            f"the server's store read without HTTP {ms(t_read, 50):.4f} ms, "
            f"GET {ms(t_get, 50):.4f} ms, GET /status (the HTTP round trip "
            f"alone) {ms(t_status, 50):.4f} ms [{card}]")

        # 5. degraded reads
        a.volume_ec_shards_delete(EC_VID, shard_ids=list(A_LOST))
        b.volume_ec_shards_delete(EC_VID, shard_ids=list(B_LOST))
        gone = set(A_LOST + B_LOST)
        expected = sum(1 for nid in order for s, _ in ivs[nid] if s in gone)
        deg_ids = [nid for nid in order if any(s in gone for s, _ in ivs[nid])]
        r0 = a.read_stats.get("reconstructs", 0)
        degraded = read_pass("degraded")
        got_rec = a.read_stats.get("reconstructs", 0) - r0
        if got_rec != expected or not expected:
            raise AssertionError(f"{got_rec} reconstructs; the sample's "
                                 f"intervals on lost shards number {expected}")
        deg_lat = [degraded[order.index(nid)] for nid in deg_ids]
        out["degraded"] = deg_lat
        out["lengths"] = [ln for nid in order for s, ln in ivs[nid] if s in gone]
        log(f"[server] degraded GETs on A, shards {sorted(gone)} lost: "
            f"{len(order)} sampled == written, {expected} reconstructs == the "
            f"sampled intervals on lost shards; the {len(deg_ids)} degraded "
            f"reads p50 {ms(deg_lat, 50):.4f} ms, p99 {ms(deg_lat, 99):.4f} "
            f"ms, {len(deg_ids) / sum(deg_lat):.1f} reads/s; the same "
            f"needles healthy p50 "
            f"{ms([healthy[order.index(n)] for n in deg_ids], 50):.4f} ms "
            f"[{card}]")

        # 11. the degraded reads again, their shard reads over gRPC
        if grpc_pass:
            from seaweedfs_tpu_torch.server.grpc_service import (GrpcPeers,
                                                                 build_service)
            from seaweedfs_tpu_torch.utils.rpc import serve

            class GrpcReads(GrpcPeers):
                """Shard reads over gRPC to the servers' bindings; the
                holder lookup the master answers comes from the servers'
                heartbeats (no master runs here)."""

                def __init__(self, local):
                    super().__init__("127.0.0.1:1")
                    self.local = local

                def lookup_ec(self, vid):
                    return self.local.lookup_ec(vid)

            for vs in (a, b):
                grpc_servers.append(serve(vs.peer_address, [build_service(vs)]))
            a.peers = GrpcReads(peers)
            r0 = a.read_stats.get("reconstructs", 0)
            try:
                over = read_pass("degraded over gRPC", ids=deg_ids)
            finally:
                a.peers = peers
            got_rec = a.read_stats.get("reconstructs", 0) - r0
            if got_rec != expected:
                raise AssertionError(f"{got_rec} reconstructs over gRPC; "
                                     f"{expected} expected")
            out["grpc_degraded"] = over
            log(f"[server] the {len(deg_ids)} degraded reads again with shard "
                f"reads over gRPC (grpc_service on A and B): == written, "
                f"{got_rec} reconstructs; p50 {ms(over, 50):.4f} ms, p99 "
                f"{ms(over, 99):.4f} ms, {len(over) / sum(over):.1f} reads/s "
                f"[{card}]")
            for g in grpc_servers:
                g.stop(grace=0.5).wait(timeout=10)
            grpc_servers.clear()

        # 6a. stale locations: a shard of B moves to C behind A's cache
        moved = 8
        c.volume_ec_shards_move(EC_VID, shard_ids=[moved],
                                source_data_node=b.peer_address)
        if sorted(c.store.find_ec_volume(EC_VID).shards) != [moved]:
            raise AssertionError("the move left C without the shard")
        fetched = a._ec_loc_cache[EC_VID][1]
        time.sleep(max(0.0, a._EC_LOC_TTL_FAILED
                       - (time.monotonic() - fetched)) + 0.05)
        on_moved = [nid for nid in order
                    if any(s == moved for s, _ in ivs[nid])
                    and not any(s in gone for s, _ in ivs[nid])]
        r0 = a.read_stats.get("reconstructs", 0)
        s0 = a.read_stats.get("stale_locations_refreshed", 0)
        for nid in on_moved:
            st, got, _ = client.request("GET", f"/{fids[nid]}")
            if (st, got) != (200, want[nid]):
                raise AssertionError(f"read of needle {nid} after the move")
        refreshed = a.read_stats.get("stale_locations_refreshed", 0) - s0
        if not on_moved or refreshed < 1 or \
                a.read_stats.get("reconstructs", 0) != r0:
            raise AssertionError(f"after the move: {len(on_moved)} reads, "
                                 f"{refreshed} refreshes, reconstructs "
                                 f"{a.read_stats.get('reconstructs', 0) - r0}")
        log(f"[server] shard {moved} moved B -> C (VolumeEcShardsMove on C): "
            f"{len(on_moved)} reads of it on A == written, "
            f"stale_locations_refreshed {refreshed}, 0 reconstructs")

        # 7. rebuild: B rebuilds (10, 13) by CopyByRebuild, A rebuilds the
        # rest, each with the others' shards as remote survivors
        t0 = time.perf_counter()
        rb = b.volume_ec_shards_copy_by_rebuild(EC_VID,
                                                shard_ids=list(B_LOST))
        rb_s = time.perf_counter() - t0
        b.volume_ec_shards_mount(EC_VID)
        t0 = time.perf_counter()
        ra = a.volume_ec_shards_rebuild(EC_VID)
        ra_s = time.perf_counter() - t0
        if (ra["rebuilt_shard_ids"], rb["rebuilt_shard_ids"]) != (
                list(A_LOST), list(B_LOST)):
            raise AssertionError(f"rebuilt {ra['rebuilt_shard_ids']} on A, "
                                 f"{rb['rebuilt_shard_ids']} on B")
        for base, sids in ((base_a, A_LOST), (base_b, B_LOST)):
            for s in sids:
                if _sha256(base + files.shard_ext(s)) != shard_hash[s]:
                    raise AssertionError(f"rebuilt shard {s} differs")
        out["rebuild"] = []
        for tag, r, wall in (("A VolumeEcShardsRebuild", ra, ra_s),
                             ("B VolumeEcShardsCopyByRebuild", rb, rb_s)):
            st = r["stats"]
            out["rebuild"].append(r["bytes_read"] / wall / 1e9)
            log(f"[server] {tag} of {tuple(r['rebuilt_shard_ids'])}: "
                f"{r['bytes_read']} B read in {wall:.3f} s = "
                f"{r['bytes_read'] / wall / 1e9:.3f} GB/s read (remote "
                f"{st['remote_bytes_read']} B through the peer plane); == "
                f"the lost shards' hashes [{card}]")

        # 6b. B's breaker open (after the rebuild, so that d survivors of a
        # shard of B exist without B): reads that need B's shards succeed
        # through the last probe of circuit-open holders
        retry.breaker(b.peer_address).trip()
        on_b = [nid for nid in order
                if any(s in (7, 9) for s, _ in ivs[nid])][:64]
        p0 = a.read_stats.get("last_probes", 0)
        for nid in on_b:
            st, got, _ = client.request("GET", f"/{fids[nid]}")
            if (st, got) != (200, want[nid]):
                raise AssertionError(f"read of needle {nid} with B's "
                                     "breaker open")
        probes = a.read_stats.get("last_probes", 0) - p0
        if not on_b or probes < 1:
            raise AssertionError(f"{len(on_b)} reads, {probes} last probes")
        retry.reset_breakers()
        log(f"[server] B's breaker open: {len(on_b)} reads of its shards on A "
            f"== written, {probes} through the last probe of circuit-open "
            "holders")

        # 8. delete a needle, then decode
        dead = order[0]
        a.volume_ec_blob_delete(EC_VID, dead)
        st, _, _ = client.request("GET", f"/{fids[dead]}")
        if st != 404:
            raise AssertionError(f"GET of the deleted needle: {st}")
        for src, sids in ((b, [7, 9]), (c, [moved])):
            a.volume_ec_shards_copy(EC_VID, shard_ids=sids,
                                    source_data_node=src.peer_address)
        a.volume_ec_shards_mount(EC_VID)
        t0 = time.perf_counter()
        a.volume_ec_shards_to_volume(EC_VID)
        dec_s = time.perf_counter() - t0
        if _sha256(base_a + ".dat") != dat_hash:
            raise AssertionError("the decoded .dat differs from the source")
        for nid in order[1:]:
            st, got, _ = client.request("GET", f"/{fids[nid]}")
            if (st, got) != (200, want[nid]):
                raise AssertionError(f"GET of needle {nid} after the decode")
        st, _, _ = client.request("GET", f"/{fids[dead]}")
        if st != 404:
            raise AssertionError("the deleted needle came back in the decode")
        out["decode"] = dat_size / dec_s / 1e9
        log(f"[server] VolumeEcBlobDelete: GET 404; data shards copied to A, "
            f"VolumeEcShardsToVolume of {dat_size} B in {dec_s:.3f} s = "
            f"{out['decode']:.3f} GB/s; .dat == the source's hash, the sample "
            f"== written over GET, the deleted needle 404 [{card}]")

        # 9. scrub a damaged regular volume on C through K3
        svid = EC_VID + 1
        v, damaged, _ = make_scrub_volume(
            np, os.path.join(workdir, "server_c"), seed + 3, n=scrub_needles,
            vid=svid)
        v.close()
        c.volume_mount(svid)
        k0 = crc_cuda.launches
        (res,) = c.volume_scrub(svid, device="")
        k3 = crc_cuda.launches - k0
        if sorted(res["corrupt_needle_ids"]) != damaged or res["mode"] != \
                "device" or res["error"] or (device == "cuda" and not k3):
            raise AssertionError(f"VolumeScrub(''): {res}; damaged {damaged}; "
                                 f"{k3} K3 launches")
        (auto,) = c.volume_scrub(svid, device="auto")
        (off,) = c.volume_scrub(svid, device="off")
        keys = ("scanned", "corrupt_needle_ids", "bytes_checked", "mode")
        if [auto[k] for k in keys] != [res[k] for k in keys] or \
                (off["scanned"], off["bytes_checked"], off["mode"]) != (
                    res["scanned"], res["bytes_checked"], "cpu"):
            raise AssertionError(f"VolumeScrub auto {auto} / off {off} "
                                 f"against '' {res}")
        out["scrub"] = res["scanned"] / res["elapsed_s"]
        log(f"[server] VolumeScrub on C of {res['scanned']} needles: device "
            f"'' -> {device}, {len(damaged)} corrupt == the damaged, "
            f"{out['scrub']:.0f} needles/s, {k3} K3 launches; 'auto' the "
            f"same; 'off' the same counts in mode cpu, "
            f"{off['scanned'] / off['elapsed_s']:.0f} needles/s [{card}]")
        out["gen"] = dat_size / gen_s / 1e9
        return out
    finally:
        retry.reset_breakers()
        for g in grpc_servers:
            g.stop(grace=0)
        if client is not None:
            client.close()
        for vs in servers.values():
            vs.stop()


def phase_server(torch, np, workdir: str, seed: int, card: str) -> dict:
    from seaweedfs_tpu_torch.ec.locate import EcGeometry
    from seaweedfs_tpu_torch.ops import crc_cuda, rs_cuda
    os.makedirs(workdir, exist_ok=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rs_cuda.reset_launches()
    crc_cuda.reset_launches()
    res = server_round_trip(np, workdir, seed + 23, card, EcGeometry(10, 4),
                            EC_NEEDLES, SERVER_SAMPLE, SERVER_HTTP_NEEDLES,
                            SERVER_SCRUB_NEEDLES)
    torch.cuda.synchronize()
    k1 = dict(rs_cuda.launches_by_entry)
    k3 = crc_cuda.launches
    log(f"[server] launches on the volume server path: K1 {json.dumps(k1)}, "
        f"K3 {k3}; phase wall {time.perf_counter() - t0:.1f} s [{card}]")
    for entry in ("encode", "reconstruct"):
        if not k1.get(entry):
            raise AssertionError(f"K1 {entry} never launched behind the server")
    if not k3:
        raise AssertionError("K3 never launched behind the server")
    stripe = one_stripe_costs(torch, np, res["lengths"], seed, card,
                              split=False)
    log(f"[server] rates: generate {res['gen']:.3f} GB/s, rebuild "
        f"{' / '.join(f'{x:.3f}' for x in res['rebuild'])} GB/s read, decode "
        f"{res['decode']:.3f} GB/s; GET p50/p99 healthy "
        f"{_pct(np, res['healthy'], 50) * 1e3:.4f} / "
        f"{_pct(np, res['healthy'], 99) * 1e3:.4f} ms, degraded "
        f"{_pct(np, res['degraded'], 50) * 1e3:.4f} / "
        f"{_pct(np, res['degraded'], 99) * 1e3:.4f} ms; scrub "
        f"{res['scrub']:.0f} needles/s; degraded one-stripe width "
        f"{stripe['L']} B (% 16 = {stripe['L'] % 16}), K1 there "
        f"{stripe['ms']:.5f} ms [{card}]")
    return {"k1": k1, "k3": k3}


# -- phase 14 ---------------------------------------------------------------
def replica_round_trip(np, workdir: str, seed: int, card: str, geo,
                       needles: int, frame: int, posts: int, deletes: int,
                       gets: int, proxied: int, bulk_sample: int,
                       bulk_frame: int, device: str = "cuda") -> dict:
    """Phase 14's path through three volume servers, every check fatal:
    a "001" volume on A and B written as /bulk frames on A (each frame
    replicated to B in one HTTP hop), POSTs and DELETEs fanned out, GETs
    through the read cache, proxied and redirected GETs on C, /bulk-read
    of B healthy and, after B's copy is sealed at RS(10,4) and shards
    (0, 5, 10, 13) are lost, degraded (K1 at one stripe); VolumeScrub of
    B's copy through K3. Logs the measured numbers and returns them."""
    from seaweedfs_tpu_torch.ops import crc_cuda
    from seaweedfs_tpu_torch.server.volume_server import LocalPeers, VolumeServer
    from seaweedfs_tpu_torch.stats import READ_CACHE_HITS
    from seaweedfs_tpu_torch.storage import bulk
    from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
    from seaweedfs_tpu_torch.storage.store import Store
    from seaweedfs_tpu_torch.storage.types import file_id
    from seaweedfs_tpu_torch.utils import retry

    vid = REPLICA_VID
    servers = {}
    for x in "abc":
        port = _free_port()
        store = Store("127.0.0.1", port, "", [DiskLocation(os.path.join(
            workdir, f"replica_{x}"))], ec_geometry=geo, coder_name="torch",
            device=device)
        servers[x] = VolumeServer(store, "127.0.0.1", port)
    a, b, c = servers["a"], servers["b"], servers["c"]
    LocalPeers({vs.peer_address: vs for vs in servers.values()})
    clients = []
    out: dict = {}
    retry.reset_breakers()
    try:
        for vs in servers.values():
            vs.start()
        ca, cb, cc = (_Client(vs.url) for vs in (a, b, c))
        clients += [ca, cb, cc]

        def ms(xs, q):
            return _pct(np, xs, q) * 1e3

        # 1. the write set as /bulk frames on A, each replicated to B
        for vs in (a, b):
            vs.allocate_volume(vid, replication="001")
        rng = np.random.default_rng(seed)
        sampled = sorted(int(i) for i in rng.choice(needles, bulk_sample,
                                                    replace=False) + 1)
        keep = set(sampled)
        cookie_of = rng.integers(1, 1 << 32, needles // frame, dtype=np.uint64)
        want: "dict[int, bytes]" = {}
        put_s = 0.0
        total = 0
        for f in range(needles // frame):
            cookie = int(cookie_of[f])
            sizes = 1024 + rng.integers(0, 64, frame)
            buf = rng.bytes(int(sizes.sum()))
            ends = np.cumsum(sizes)
            entries = []
            for i, e in enumerate(ends):
                nid = f * frame + i + 1
                data = buf[int(e - sizes[i]):int(e)]
                entries.append((nid, cookie, data, 0))
                if nid in keep:
                    want[nid] = data
            body = bulk.pack_frame(vid, entries)
            total += len(buf)
            t = time.perf_counter()
            st, resp, _ = ca.request("PUT", f"/bulk?vid={vid}", body)
            put_s += time.perf_counter() - t
            if st != 201 or json.loads(resp)["count"] != frame:
                raise AssertionError(f"/bulk frame {f}: {st} {resp[:200]!r}")
        idx_hash = []
        for vs in (a, b):
            v = vs.store.find_volume(vid)
            v.sync()
            idx_hash.append(_sha256(v.file_name() + ".idx"))
        if idx_hash[0] != idx_hash[1]:
            raise AssertionError("A's and B's .idx differ after the ingest")
        out["ingest"] = needles / put_s
        log(f"[replica] {needles} needles ({total} B) PUT to A as "
            f"{needles // frame} /bulk frames of {frame}, each replicated to B "
            f"in one hop: {out['ingest']:.0f} needles/s, "
            f"{total / put_s / 1e6:.1f} MB/s one client; A's and B's .idx "
            f"sha256 equal [{card}]")

        def cookie(nid):
            return int(cookie_of[(nid - 1) // frame])

        # 2. POSTs and DELETEs through A, fanned out to B
        posted = {}
        post_lat = []
        for nid in range(needles + 1, needles + posts + 1):
            body = rng.bytes(int(1024 + rng.integers(0, 64)))
            fid = file_id(vid, nid, int(rng.integers(1, 1 << 32)))
            t = time.perf_counter()
            st, resp, _ = ca.request("POST", f"/{fid}", body)
            post_lat.append(time.perf_counter() - t)
            if st != 201 or json.loads(resp)["size"] != len(body):
                raise AssertionError(f"POST of {fid}: {st} {resp[:200]!r}")
            if cb.request("GET", f"/{fid}")[:2] != (200, body):
                raise AssertionError(f"the POST of {fid} did not reach B")
            posted[fid] = body
        for fid in list(posted)[:deletes]:
            st, _, _ = ca.request("DELETE", f"/{fid}")
            if st != 202:
                raise AssertionError(f"DELETE of {fid}: {st}")
            if (ca.request("GET", f"/{fid}")[0],
                    cb.request("GET", f"/{fid}")[0]) != (404, 404):
                raise AssertionError(f"the DELETE of {fid} left a copy")
        hop = file_id(vid, needles + posts + 1, 0x5EED)
        if cb.request("POST", f"/{hop}?type=replicate", b"hop" * 300)[0] != 201 \
                or cb.request("GET", f"/{hop}")[:2] != (200, b"hop" * 300) \
                or ca.request("GET", f"/{hop}")[0] != 404:
            raise AssertionError("a replica hop on B did not land on B alone")
        out["post"] = post_lat
        log(f"[replica] {posts} POSTs through A, each replicated to B and read "
            f"back there: p50 {ms(post_lat, 50):.4f} ms, p99 "
            f"{ms(post_lat, 99):.4f} ms, {posts / sum(post_lat):.0f} writes/s "
            f"one client; {deletes} DELETEs 404 on A and B; one "
            f"?type=replicate POST on B landed on B only [{card}]")

        # 3. sampled GETs from A, twice: the second pass from the cache
        get_ids = sorted(int(i) for i in rng.choice(sampled, gets,
                                                    replace=False))
        passes = []
        for tag in ("first", "second"):
            h0 = READ_CACHE_HITS.value()
            lat = []
            for nid in get_ids:
                t = time.perf_counter()
                st, got, _ = ca.request("GET", f"/{file_id(vid, nid, cookie(nid))}")
                lat.append(time.perf_counter() - t)
                if (st, got) != (200, want[nid]):
                    raise AssertionError(f"{tag} GET of needle {nid}: {st}")
            hits = READ_CACHE_HITS.value() - h0
            if hits != (0 if tag == "first" else gets):
                raise AssertionError(f"{tag} pass: {hits} read-cache hits")
            passes.append(lat)
        out["get"] = passes
        log(f"[replica] {gets} sampled GETs from A == written: first pass "
            f"(0 cache hits) p50 {ms(passes[0], 50):.4f} ms, p99 "
            f"{ms(passes[0], 99):.4f} ms; second pass ({gets} cache hits) p50 "
            f"{ms(passes[1], 50):.4f} ms, p99 {ms(passes[1], 99):.4f} ms "
            f"[{card}]")

        # 4. proxied GETs on C (a quarter ranged), then one redirect
        lat = []
        for i, nid in enumerate(get_ids[:proxied]):
            data, hdr = want[nid], {}
            if i % 4 == 0:
                lo = nid % 97
                hdr = {"Range": f"bytes={lo}-{lo + 510}"}
                data = data[lo:lo + 511]
            t = time.perf_counter()
            st, got, _ = cc.request("GET", f"/{file_id(vid, nid, cookie(nid))}",
                                    headers=hdr)
            lat.append(time.perf_counter() - t)
            if (st, got) != (206 if hdr else 200, data):
                raise AssertionError(f"proxied GET of needle {nid}: {st}")
        c.read_mode = "redirect"
        fid = file_id(vid, get_ids[0], cookie(get_ids[0]))
        st, _, hdrs = cc.request("GET", f"/{fid}")
        c.read_mode = "proxy"
        holders = [f"http://{vs.url}/{fid}?proxied=1" for vs in (a, b)]
        if st != 301 or hdrs.get("Location") not in holders:
            raise AssertionError(f"redirect: {st} {hdrs.get('Location')}")
        out["proxy"] = lat
        log(f"[replica] {proxied} GETs on C proxied to a holder "
            f"({len(range(0, proxied, 4))} ranged) == written: p50 "
            f"{ms(lat, 50):.4f} ms, p99 {ms(lat, 99):.4f} ms; C in redirect "
            f"mode: 301 to {hdrs['Location'].split('/')[2]} [{card}]")

        def bulk_read(tag: str) -> float:
            t = time.perf_counter()
            for lo in range(0, len(sampled), bulk_frame):
                ids = sampled[lo:lo + bulk_frame]
                req = bulk.pack_read_request(vid, [(n, cookie(n)) for n in ids])
                st, resp, _ = cb.request("POST", f"/bulk-read?vid={vid}", req)
                if st != 200:
                    raise AssertionError(f"{tag} /bulk-read: {st}")
                _, res = bulk.unpack_read_response(resp)
                if [(r.key, r.status, bytes(r.data)) for r in res] != \
                        [(n, bulk.READ_OK, want[n]) for n in ids]:
                    raise AssertionError(f"{tag} /bulk-read frame at {lo}")
            return len(sampled) / (time.perf_counter() - t)

        # 5. /bulk-read of B, healthy
        out["bulk_read"] = bulk_read("healthy")
        log(f"[replica] /bulk-read of {len(sampled)} sampled needles from B in "
            f"frames of {bulk_frame} == written: {out['bulk_read']:.0f} "
            f"needles/s one client [{card}]")

        # 6. VolumeScrub of B's copy through K3
        live = needles + posts - deletes + 1
        k0 = crc_cuda.launches
        (res,) = b.volume_scrub(vid, device="")
        k3 = crc_cuda.launches - k0
        if (res["scanned"], res["corrupt_needle_ids"], res["mode"]) != (
                live, [], "device") or res["error"] or (
                device == "cuda" and not k3):
            raise AssertionError(f"VolumeScrub of B: {res}; {live} live, "
                                 f"{k3} K3 launches")
        out["scrub"] = res["scanned"] / res["elapsed_s"]
        log(f"[replica] VolumeScrub of B's copy: {res['scanned']} needles, 0 "
            f"corrupt, {out['scrub']:.0f} needles/s, {k3} K3 launches [{card}]")

        # 7. B's copy sealed at RS(10,4), plain copies deleted, four shards
        # lost: /bulk-read reconstructs through K1 at one stripe
        b.volume_mark_readonly(vid)
        t = time.perf_counter()
        b.volume_ec_shards_generate(vid)
        gen_s = time.perf_counter() - t
        b.volume_ec_shards_mount(vid)
        a.volume_delete(vid)
        b.volume_delete(vid)
        b.volume_ec_shards_delete(vid, shard_ids=list(LOST_10_4))
        ev = b.store.find_ec_volume(vid)
        if sorted(ev.shards) != [s for s in range(geo.n) if s not in LOST_10_4]:
            raise AssertionError(f"B mounted shards {sorted(ev.shards)}")
        gone = set(LOST_10_4)
        expected = sum(1 for nid in sampled for s, _ in _intervals(ev, geo, nid)
                       if s in gone)
        r0 = b.read_stats.get("reconstructs", 0)
        out["degraded_bulk_read"] = bulk_read("degraded")
        got_rec = b.read_stats.get("reconstructs", 0) - r0
        if got_rec != expected or not expected:
            raise AssertionError(f"{got_rec} reconstructs; the sample's "
                                 f"intervals on lost shards number {expected}")
        out["gen"] = ev.dat_size / gen_s / 1e9
        out["reconstructs"] = got_rec
        log(f"[replica] B's copy sealed by VolumeEcShardsGenerate RS({geo.d},"
            f"{geo.p}) in {gen_s:.3f} s = {out['gen']:.3f} GB/s, plain copies "
            f"deleted, shards {sorted(gone)} lost: /bulk-read of the "
            f"{len(sampled)} == written, {got_rec} reconstructs == the sampled "
            f"intervals on lost shards; {out['degraded_bulk_read']:.0f} "
            f"needles/s [{card}]")
        return out
    finally:
        retry.reset_breakers()
        for cl in clients:
            cl.close()
        for vs in servers.values():
            vs.stop()


def phase_replica(torch, np, workdir: str, seed: int, card: str) -> dict:
    from seaweedfs_tpu_torch.ec.locate import EcGeometry
    from seaweedfs_tpu_torch.ops import crc_cuda, rs_cuda
    os.makedirs(workdir, exist_ok=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rs_cuda.reset_launches()
    crc_cuda.reset_launches()
    res = replica_round_trip(np, workdir, seed + 29, card, EcGeometry(10, 4),
                             REPLICA_NEEDLES, REPLICA_FRAME, SERVER_HTTP_NEEDLES,
                             REPLICA_DELETES, REPLICA_GETS, REPLICA_PROXIED,
                             EC_SAMPLE, REPLICA_READ_FRAME)
    torch.cuda.synchronize()
    k1 = dict(rs_cuda.launches_by_entry)
    k3 = crc_cuda.launches
    log(f"[replica] launches on the replicated data plane: K1 {json.dumps(k1)}, "
        f"K3 {k3}; phase wall {time.perf_counter() - t0:.1f} s [{card}]")
    for entry in ("encode", "reconstruct"):
        if not k1.get(entry):
            raise AssertionError(f"K1 {entry} never launched on the replica")
    if not k3:
        raise AssertionError("K3 never launched on the replica")
    return {"k1": k1, "k3": k3}


# -- phase 15 ---------------------------------------------------------------
def make_certs(dirname: str) -> "tuple[str, str, str]":
    """(ca, cert, key) paths: a CA and one cluster certificate (CN=swtpu,
    the TlsConfig's server name) made with openssl."""
    os.makedirs(dirname, exist_ok=True)
    ca_key, ca_crt = (os.path.join(dirname, n) for n in ("ca.key", "ca.crt"))
    key, csr, crt = (os.path.join(dirname, n)
                     for n in ("node.key", "node.csr", "node.crt"))
    for cmd in (["req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout",
                 ca_key, "-out", ca_crt, "-days", "1", "-subj", "/CN=swtpu-ca"],
                ["req", "-newkey", "rsa:2048", "-nodes", "-keyout", key,
                 "-out", csr, "-subj", "/CN=swtpu"],
                ["x509", "-req", "-in", csr, "-CA", ca_crt, "-CAkey", ca_key,
                 "-CAcreateserial", "-out", crt, "-days", "1"]):
        subprocess.run(["openssl", *cmd], check=True, capture_output=True,
                       timeout=60)
    return ca_crt, crt, key


def json_lines_set(np, store, vid: int, rng, n: int) -> "dict[int, list]":
    """n JSON-lines needles of 1-4 KiB each in volume `vid` of `store`
    (through write_needles_bulk); returns each needle's records."""
    from seaweedfs_tpu_torch.storage.needle import Needle
    docs: "dict[int, list]" = {}
    batch = []
    for nid in range(1, n + 1):
        target = int(rng.integers(1024, 4097))
        recs, body = [], b""
        while True:
            rec = {"id": nid * 1000 + len(recs),
                   "kind": str(rng.choice(["a", "b", "c"])),
                   "size": int(rng.integers(0, 1 << 20)),
                   "pad": "x" * int(rng.integers(8, 120))}
            line = (json.dumps(rec) + "\n").encode()
            if len(body) + len(line) > target:
                break
            recs.append(rec)
            body += line
        body += b" " * (target - len(body))  # a blank tail line, 1-4 KiB
        docs[nid] = recs
        batch.append(Needle(id=nid, cookie=0xD0C0 + nid, data=body))
    store.write_needles_bulk(vid, batch)
    return docs


def maintenance_round_trip(np, workdir: str, seed: int, card: str, geo,
                           needles: int, more: int, deletes: int,
                           statuses: int, gets: int, query_needles: int,
                           device: str = "cuda", pulse_seconds: float = 2.0,
                           maint_rate: str = MAINT_BYTES_PER_S,
                           maint_burst: str = MAINT_BURST_BYTES) -> dict:
    """Phase 15's path through three volume servers served over gRPC under
    mTLS (certificates made with openssl), each heartbeating to a sink that
    stands in for the master, every check fatal: VolumeCopy A -> C, the
    catch-up by VolumeSyncStatus, VolumeTailReceiver and
    VolumeIncrementalCopy, BatchDelete, VolumeNeedleStatus, VolumeConfigure,
    VolumeScrub of the copy (K3), its seal (K1 encode) and a
    maintenance-class rebuild (K1) that reads half its survivors from B
    under a QoS policy while a client GETs from B, Query over an EC volume
    with lost shards (K1 at one stripe), a shed write, and leave. Logs the
    measured numbers and returns them."""
    import threading

    import grpc

    from seaweedfs_tpu_torch.ec import files
    from seaweedfs_tpu_torch.ops import crc_cuda
    from seaweedfs_tpu_torch.pb import master_pb2 as mpb
    from seaweedfs_tpu_torch.pb import volume_server_pb2 as vpb
    from seaweedfs_tpu_torch.server.grpc_service import (GrpcPeers,
                                                         Heartbeater,
                                                         build_service)
    from seaweedfs_tpu_torch.server.volume_server import LocalPeers, VolumeServer
    from seaweedfs_tpu_torch.stats import (QOS_BYTES, QOS_REQUESTS,
                                           QOS_WAIT_SECONDS)
    from seaweedfs_tpu_torch.ops.crc32c import crc32c
    from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.store import Store
    from seaweedfs_tpu_torch.storage.types import file_id
    from seaweedfs_tpu_torch.utils import retry, rpc

    vid, qvid, tiny_vid = EC_VID, MAINT_QUERY_VID, MAINT_TINY_VID
    out: dict = {}
    t = time.perf_counter()
    rpc.set_tls_config(rpc.TlsConfig(*make_certs(
        os.path.join(workdir, "tls"))))
    log(f"[maint] a CA and a cluster certificate made with openssl in "
        f"{time.perf_counter() - t:.2f} s: every gRPC plane under mTLS")
    servers = {}
    for x in "abc":
        port = _free_port()
        store = Store("127.0.0.1", port, "", [DiskLocation(os.path.join(
            workdir, f"maint_{x}"))], ec_geometry=geo, coder_name="torch",
            device=device)
        servers[x] = VolumeServer(store, "127.0.0.1", port,
                                  pulse_seconds=pulse_seconds)
    a, b, c = servers["a"], servers["b"], servers["c"]
    local = LocalPeers({vs.peer_address: vs for vs in servers.values()})
    sink_address = f"127.0.0.1:{_free_port()}"

    class Sink:
        """The master's end of SendHeartbeat and nothing more: it acks
        each heartbeat as a master does, keeps each server's last one and
        its count, and notes when a server's stream ends."""

        def __init__(self):
            self.last: dict = {}
            self.count: collections.Counter = collections.Counter()
            self.ended: dict = {}
            self.service = rpc.RpcService(rpc.MASTER_SERVICE)
            self.service.stream_stream("SendHeartbeat", mpb.Heartbeat,
                                       mpb.HeartbeatResponse)(self._stream)

        def _stream(self, request_iter, context):
            port = None
            try:
                for hb in request_iter:
                    port = hb.port
                    self.last[port] = hb
                    self.count[port] += 1
                    self.ended.pop(port, None)
                    yield mpb.HeartbeatResponse()
            finally:
                if port is not None:
                    self.ended[port] = time.perf_counter()

    class Peers(GrpcPeers):
        """The peer plane over gRPC; the holder lookups a master answers
        come from the servers themselves (no master runs here)."""

        def __init__(self):
            super().__init__(sink_address)

        def lookup_volume(self, v):
            return local.lookup_volume(v)

        def lookup_ec(self, v):
            return local.lookup_ec(v)

    peers = Peers()
    sink = Sink()
    grpc_servers, clients, beats = [], [], {}
    stop_gets = threading.Event()
    retry.reset_breakers()

    def stub(vs):
        return rpc.Stub(vs.peer_address, rpc.VOLUME_SERVICE)

    def ms(xs, q):
        return _pct(np, xs, q) * 1e3

    try:
        grpc_servers.append(rpc.serve(sink_address, [sink.service]))
        for vs in servers.values():
            vs.peers = peers
            vs.start()
            grpc_servers.append(rpc.serve(vs.peer_address,
                                          [build_service(vs)]))
            beats[vs] = Heartbeater(vs, peers)
            vs.heartbeat_flush = beats[vs].flush
            beats[vs].start()
        ca = _Client(a.url)
        clients.append(ca)

        # 1. mTLS: a TLS stub is served, a plaintext one refused; every
        # server's heartbeat stream acked
        stub(a).call("Ping", vpb.PingRequest(), vpb.PingResponse, timeout=10)
        ch = grpc.insecure_channel(a.peer_address)
        try:
            ch.unary_unary(
                f"/{rpc.VOLUME_SERVICE}/Ping",
                request_serializer=vpb.PingRequest.SerializeToString,
                response_deserializer=vpb.PingResponse.FromString)(
                vpb.PingRequest(), timeout=5)
            raise AssertionError("a plaintext stub was served under mTLS")
        except grpc.RpcError:
            pass
        finally:
            ch.close()
        for vs in servers.values():
            if not vs.flush_heartbeat():
                raise AssertionError(f"no heartbeat of {vs.url} acked")
        log("[maint] Ping over mTLS answered; a plaintext stub refused; "
            "three heartbeat streams acked over mTLS")

        # 2. the write set on A, VolumeCopy onto C
        rng = np.random.default_rng(seed)
        sizes = 1024 + rng.integers(0, 64, needles)
        cookies = rng.integers(0, 1 << 32, needles, dtype=np.uint64)
        sample = sorted(int(i) for i in rng.choice(needles, statuses,
                                                   replace=False) + 1)
        a.allocate_volume(vid)
        t = time.perf_counter()
        want = write_set(np, a.store, rng, sizes, cookies, set(sample))
        bulk_s = time.perf_counter() - t
        va = a.store.find_volume(vid)
        va.sync()
        base_a = va.file_name()
        t = time.perf_counter()
        stub(c).call("VolumeCopy", vpb.VolumeCopyRequest(
            volume_id=vid, source_data_node=a.peer_address),
            vpb.VolumeCopyResponse, timeout=600)
        copy_s = time.perf_counter() - t
        vc = c.store.find_volume(vid)
        base_c = vc.file_name()
        for ext in (".dat", ".idx"):
            if _sha256(base_a + ext) != _sha256(base_c + ext):
                raise AssertionError(f"VolumeCopy: C's {ext} != A's")
        copied = sum(os.path.getsize(base_c + e) for e in (".dat", ".idx"))
        out["copy"] = copied / copy_s / 1e9
        log(f"[maint] A: {needles} needles through Store.write_needles_bulk "
            f"in {bulk_s:.1f} s; VolumeCopy A -> C over gRPC: {copied} B in "
            f"{copy_s:.3f} s = {out['copy']:.3f} GB/s, .dat and .idx sha256 "
            f"equal [{card}]")

        # 3. A moves on; C catches up
        old_size = os.path.getsize(base_c + ".dat")
        since = vc.last_record_append_ns()
        msizes = 1024 + rng.integers(0, 64, more)
        mcookies = rng.integers(0, 1 << 32, more, dtype=np.uint64)
        buf = rng.bytes(int(msizes.sum()))
        ends = np.cumsum(msizes)
        a.store.write_needles_bulk(vid, [
            Needle(id=needles + i + 1, cookie=int(mcookies[i]),
                   data=buf[int(e - msizes[i]):int(e)])
            for i, e in enumerate(ends)])
        st = stub(a).call("VolumeSyncStatus",
                          vpb.VolumeSyncStatusRequest(volume_id=vid),
                          vpb.VolumeSyncStatusResponse)
        if st.tail_offset != os.path.getsize(base_a + ".dat") or \
                st.tail_offset <= old_size:
            raise AssertionError(f"VolumeSyncStatus of A: {st}")
        t = time.perf_counter()
        raw = b"".join(r.file_content for r in stub(a).call_stream(
            "VolumeIncrementalCopy", vpb.VolumeIncrementalCopyRequest(
                volume_id=vid, since_ns=since),
            vpb.VolumeIncrementalCopyResponse))
        inc_s = time.perf_counter() - t
        with open(base_a + ".dat", "rb") as f:
            f.seek(old_size)
            if raw != f.read():
                raise AssertionError("VolumeIncrementalCopy != A's .dat tail")
        t = time.perf_counter()
        got = stub(c).call("VolumeTailReceiver", vpb.VolumeTailReceiverRequest(
            volume_id=vid, since_ns=since, idle_timeout_seconds=1,
            source_volume_server=a.peer_address),
            vpb.VolumeTailReceiverResponse, timeout=600).received
        tail_s = time.perf_counter() - t
        stub(c).call("VolumeSyncStatus",
                     vpb.VolumeSyncStatusRequest(volume_id=vid),
                     vpb.VolumeSyncStatusResponse)  # flushes C's .idx
        if got != more or _sha256(base_a + ".idx") != _sha256(base_c + ".idx") \
                or _sha256(base_a + ".dat") != _sha256(base_c + ".dat") \
                or vc.file_count != a.store.find_volume(vid).file_count:
            raise AssertionError(f"the tail: {got} records of {more}; C's "
                                 ".idx, .dat or live needles differ from A's")
        out["tail"] = more / tail_s
        log(f"[maint] {more} needles more on A; VolumeSyncStatus tail "
            f"{st.tail_offset}; VolumeIncrementalCopy since the copy: {len(raw)} "
            f"B == A's .dat tail in {inc_s:.3f} s; VolumeTailReceiver on C from "
            f"A: {got} records in {tail_s:.3f} s = {out['tail']:.0f} records/s "
            f"(one idle second included), C's .dat, .idx and live needles == "
            f"A's [{card}]")

        # 4. BatchDelete, VolumeNeedleStatus, VolumeConfigure on C
        live_ids = [n for n in range(1, needles + 1) if n not in set(sample)]
        doomed = sorted(int(i) for i in rng.choice(live_ids, deletes,
                                                   replace=False))
        fids = [file_id(vid, n, int(cookies[n - 1])) for n in doomed]
        t = time.perf_counter()
        res = stub(c).call("BatchDelete", vpb.BatchDeleteRequest(file_ids=fids),
                           vpb.BatchDeleteResponse, timeout=120).results
        del_s = time.perf_counter() - t
        if [r.status for r in res] != [202] * deletes:
            raise AssertionError("BatchDelete statuses: " + str(
                collections.Counter(r.status for r in res)))
        again = stub(c).call("BatchDelete", vpb.BatchDeleteRequest(
            file_ids=fids), vpb.BatchDeleteResponse, timeout=120).results
        if [r.status for r in again] != [404] * deletes:
            raise AssertionError("deleted fids were not all 404")
        cc = _Client(c.url)
        clients.append(cc)
        for fid in fids[:256]:
            if cc.request("GET", f"/{fid}")[0] != 404:
                raise AssertionError(f"GET of deleted {fid} on C is not 404")
        t = time.perf_counter()
        for n in sample:
            r = stub(c).call("VolumeNeedleStatus", vpb.VolumeNeedleStatusRequest(
                volume_id=vid, needle_id=n), vpb.VolumeNeedleStatusResponse)
            if (r.needle_id, r.size, r.cookie, r.crc) != (
                    n, len(want[n]), int(cookies[n - 1]), crc32c(want[n])):
                raise AssertionError(f"VolumeNeedleStatus of {n}: {r}")
        stat_s = time.perf_counter() - t
        err = stub(c).call("VolumeConfigure", vpb.VolumeConfigureRequest(
            volume_id=vid, replication="001"),
            vpb.VolumeConfigureResponse).error
        with open(base_c + ".dat", "rb") as f:
            sb = f.read(2)
        # VolumeConfigure returns once a heartbeat covering it is acked
        hb = {v.id: v for v in sink.last[c.port].volumes}
        if err or sb[1] != 1 or hb[vid].replica_placement != 1:
            raise AssertionError(f"VolumeConfigure: {err!r}, super block "
                                 f"{sb[1]}, heartbeat "
                                 f"{hb[vid].replica_placement}")
        log(f"[maint] BatchDelete of {deletes} fids on C in one request (the "
            f"JAX client's group for one server): {deletes} x 202 in "
            f"{del_s:.3f} s, then {deletes} x 404 (and {len(fids[:256])} GETs "
            f"404); "
            f"VolumeNeedleStatus of {statuses} sampled needles: size, CRC and "
            f"cookie == written, {statuses / stat_s:.0f} calls/s; "
            f"VolumeConfigure \"001\": super-block byte 1, the acked "
            f"heartbeat's replica_placement 1 [{card}]")

        # 5. VolumeScrub of C's copy through K3
        live = needles + more - deletes
        k0 = crc_cuda.launches
        (r,) = stub(c).call("VolumeScrub", vpb.VolumeScrubRequest(
            volume_id=vid), vpb.VolumeScrubResponse, timeout=600).results
        k3 = crc_cuda.launches - k0
        if (r.scanned, list(r.corrupt_needle_ids), r.mode, r.error) != (
                live, [], "device", "") or (device == "cuda" and not k3):
            raise AssertionError(f"VolumeScrub of C: {r}; {live} live, {k3} "
                                 "K3 launches")
        out["scrub"] = r.scanned / r.elapsed_s
        log(f"[maint] VolumeScrub of C's copy: {r.scanned} needles, 0 corrupt, "
            f"{out['scrub']:.0f} needles/s, {k3} K3 launches [{card}]")

        # 6. C's copy sealed (K1 encode), shards 7-13 copied to B, four
        # lost, so B holds half the survivors; a maintenance-class rebuild
        # on C under a policy while a tenant GETs from B
        stub(c).call("VolumeMarkReadonly", vpb.VolumeMarkReadonlyRequest(
            volume_id=vid), vpb.VolumeMarkReadonlyResponse)
        t = time.perf_counter()
        stub(c).call("VolumeEcShardsGenerate",
                     vpb.VolumeEcShardsGenerateRequest(volume_id=vid),
                     vpb.VolumeEcShardsGenerateResponse, timeout=600)
        gen_s = time.perf_counter() - t
        sealed = _shard_hashes(base_c, geo.n)
        moved = list(range(geo.n // 2, geo.n))
        stub(b).call("VolumeEcShardsCopy", vpb.VolumeEcShardsCopyRequest(
            volume_id=vid, shard_ids=moved, copy_ecx_file=True,
            copy_vif_file=True, source_data_node=c.peer_address),
            vpb.VolumeEcShardsCopyResponse, timeout=600)
        for vs in (b, c):
            stub(vs).call("VolumeEcShardsMount", vpb.VolumeEcShardsMountRequest(
                volume_id=vid), vpb.VolumeEcShardsMountResponse)
        stub(c).call("VolumeEcShardsDelete", vpb.VolumeEcShardsDeleteRequest(
            volume_id=vid, shard_ids=moved), vpb.VolumeEcShardsDeleteResponse)
        stub(c).call("VolumeDelete", vpb.VolumeDeleteRequest(volume_id=vid),
                     vpb.VolumeDeleteResponse)
        for vs in (b, c):
            lost = [s for s in LOST_10_4 if s in
                    vs.store.find_ec_volume(vid).shards]
            stub(vs).call("VolumeEcShardsDelete",
                          vpb.VolumeEcShardsDeleteRequest(
                              volume_id=vid, shard_ids=lost),
                          vpb.VolumeEcShardsDeleteResponse)
        evb = b.store.find_ec_volume(vid)
        on_b = set(evb.shards)
        if 2 * len(on_b) < geo.d:
            raise AssertionError(f"B holds {sorted(on_b)}: under half the "
                                 "survivors")
        # the tenant reads needles that B serves from its own shards
        ids = [n for n in sample
               if all(s in on_b for s, _ in _intervals(evb, geo, n))][:gets]
        if not ids:
            raise AssertionError(f"no sampled needle lies on B's shards "
                                 f"{sorted(on_b)}")
        policy = {"classes": {"maintenance": {
                      "bytes_per_s": maint_rate, "burst_bytes": maint_burst,
                      "max_wait_s": 60.0}},
                  "tenants": {"tiny": {"rps": 0.01, "burst": 1}},
                  # a plain-RS rebuild's survivor read costs up to chunk x
                  # batch = 32 MiB (ec/encoder.py): a smaller round-robin
                  # quantum would make the queued read wait pump ticks
                  # (0.5 s each) for deficit the byte bucket does not ask
                  # for
                  "quantum_bytes": MAINT_QUANTUM}
        for vs in servers.values():  # the operator's retune path
            cl = _Client(vs.url)
            try:
                st_, body, _ = cl.request("POST", "/debug/qos",
                                          json.dumps(policy).encode())
            finally:
                cl.close()
            if st_ != 200 or not json.loads(body)["enabled"]:
                raise AssertionError(f"POST /debug/qos on {vs.url}: {st_}")

        def qos_now():
            return {"maint_admitted": QOS_REQUESTS.value(
                        "default", "maintenance", "admitted"),
                    "maint_queued": QOS_REQUESTS.value(
                        "default", "maintenance", "queued"),
                    "maint_bytes": QOS_BYTES.value("default", "maintenance"),
                    "maint_waits": QOS_WAIT_SECONDS.count("maintenance"),
                    "maint_wait_s": QOS_WAIT_SECONDS._sums.get(
                        ("maintenance",), 0.0),
                    "interactive": QOS_REQUESTS.value(
                        "default", "interactive", "admitted"),
                    "interactive_queued": QOS_REQUESTS.value(
                        "default", "interactive", "queued")}
        get_lat: list = []
        get_err: list = []

        cb = _Client(b.url)
        clients.append(cb)

        def getter():
            i = 0
            try:
                while not stop_gets.is_set():
                    n = ids[i % len(ids)]
                    i += 1
                    t0 = time.perf_counter()
                    st_, body, _ = cb.request(
                        "GET", f"/{file_id(vid, n, int(cookies[n - 1]))}")
                    get_lat.append(time.perf_counter() - t0)
                    if (st_, body) != (200, want[n]):
                        raise AssertionError(f"GET of {n} on B: {st_}")
            except Exception as e:  # noqa: BLE001 — reported below
                get_err.append(e)

        q0 = qos_now()
        th = threading.Thread(target=getter, name="maint-gets", daemon=True)
        th.start()
        t = time.perf_counter()
        rb = stub(c).call("VolumeEcShardsRebuild",
                          vpb.VolumeEcShardsRebuildRequest(volume_id=vid),
                          vpb.VolumeEcShardsRebuildResponse, timeout=900)
        rb_s = time.perf_counter() - t
        stop_gets.set()
        th.join(timeout=30)
        q1 = qos_now()
        dq = {k: q1[k] - q0[k] for k in q0}
        if get_err:
            raise get_err[0]
        if sorted(rb.rebuilt_shard_ids) != list(LOST_10_4):
            raise AssertionError(f"rebuilt {list(rb.rebuilt_shard_ids)}")
        for s in LOST_10_4:  # all four rebuilt on C
            if _sha256(base_c + files.shard_ext(s)) != sealed[s]:
                raise AssertionError(f"rebuilt shard {s} differs")
        if dq["maint_waits"] <= 0 or dq["maint_wait_s"] <= 0 or \
                dq["maint_bytes"] <= 0 or dq["interactive"] <= 0 or \
                len(get_lat) < 10:
            raise AssertionError(f"QoS deltas {dq}; {len(get_lat)} GETs")
        out["rebuild"] = rb.bytes_read / rb_s / 1e9
        out["gets_during_rebuild"] = get_lat
        out["qos"] = dq
        out["gen"] = os.path.getsize(base_c + files.shard_ext(1)) * geo.d \
            / gen_s / 1e9
        log(f"[maint] VolumeEcShardsGenerate of C's copy RS({geo.d},{geo.p}) in "
            f"{gen_s:.3f} s = {out['gen']:.3f} GB/s; shards {moved[0]}-"
            f"{moved[-1]} to B by VolumeEcShardsCopy; shards "
            f"{list(LOST_10_4)} lost; VolumeEcShardsRebuild on C "
            f"(maintenance class, B's survivor reads of shards "
            f"{sorted(on_b)} admitted at {maint_rate}/s): {rb.bytes_read} B "
            f"read in {rb_s:.3f} s = {out['rebuild']:.3f} GB/s, the four "
            f"shards == their hashes; meanwhile {len(get_lat)} GETs from B "
            f"of {len(ids)} needles on its own shards: p50 "
            f"{ms(get_lat, 50):.4f} ms, p99 {ms(get_lat, 99):.4f} ms; QoS "
            f"deltas "
            f"{json.dumps({k: round(v, 6) for k, v in dq.items()})} [{card}]")

        # 7. Query over an EC volume with four lost shards
        a.allocate_volume(qvid)
        docs = json_lines_set(np, a.store, qvid, rng, query_needles)
        for method, req, resp in (
                ("VolumeMarkReadonly",
                 vpb.VolumeMarkReadonlyRequest(volume_id=qvid),
                 vpb.VolumeMarkReadonlyResponse),
                ("VolumeEcShardsGenerate",
                 vpb.VolumeEcShardsGenerateRequest(volume_id=qvid),
                 vpb.VolumeEcShardsGenerateResponse),
                ("VolumeEcShardsMount",
                 vpb.VolumeEcShardsMountRequest(volume_id=qvid),
                 vpb.VolumeEcShardsMountResponse),
                ("VolumeDelete", vpb.VolumeDeleteRequest(volume_id=qvid),
                 vpb.VolumeDeleteResponse),
                ("VolumeEcShardsDelete", vpb.VolumeEcShardsDeleteRequest(
                    volume_id=qvid, shard_ids=list(LOST_10_4)),
                 vpb.VolumeEcShardsDeleteResponse)):
            stub(a).call(method, req, resp, timeout=600)
        ev = a.store.find_ec_volume(qvid)
        gone = set(LOST_10_4)
        expected = sum(1 for n in docs for s, _ in _intervals(ev, geo, n)
                       if s in gone)
        qfids = [file_id(qvid, n, 0xD0C0 + n) for n in docs]
        req = vpb.QueryRequest(from_file_ids=qfids)
        req.filter.field, req.filter.operand, req.filter.value = \
            "kind", "=", "b"
        req.projections.extend(["id", "size"])
        r0 = a.read_stats.get("reconstructs", 0)
        t = time.perf_counter()
        got_q = b"".join(s.records for s in stub(a).call_stream(
            "Query", req, vpb.QueriedStripe, timeout=600))
        query_s = time.perf_counter() - t
        got_rec = a.read_stats.get("reconstructs", 0) - r0
        # the written records filtered and projected here, without query/
        direct = [[rec["id"], rec["size"]] for n in docs for rec in docs[n]
                  if rec["kind"] == "b"]
        if [json.loads(ln) for ln in got_q.decode().splitlines()] != direct \
                or not direct:
            raise AssertionError("Query records != the direct evaluation")
        if got_rec != expected or not expected:
            raise AssertionError(f"{got_rec} reconstructs in Query; the "
                                 f"intervals on lost shards number {expected}")
        out["query"] = query_needles / query_s
        out["reconstructs"] = got_rec
        out["query_lengths"] = [ln for n in docs for s, ln in
                                _intervals(ev, geo, n) if s in gone]
        log(f"[maint] Query (kind = \"b\", projecting id and size) of "
            f"{query_needles} JSON-lines needles of 1-4 KiB in a volume sealed "
            f"at RS({geo.d},{geo.p}) with shards {sorted(gone)} lost: "
            f"{len(direct)} records == the direct evaluation, {got_rec} K1 "
            f"reconstructs == the intervals on lost shards, "
            f"{out['query']:.0f} needles/s [{card}]")

        # 8. a tenant with a tiny ingest bucket is shed
        a.allocate_volume(tiny_vid, collection="tiny")
        shed = [ca.request("POST", f"/{file_id(tiny_vid, i, 0x71)}",
                           b"t" * 512) for i in (1, 2)]
        if shed[0][0] != 201 or shed[1][0] != 503 or \
                not shed[1][2].get("Retry-After"):
            raise AssertionError(f"shedding: {[s[0] for s in shed]} "
                                 f"{shed[1][2]}")
        log(f"[maint] tenant \"tiny\" (rps 0.01, burst 1): 201, then 503 with "
            f"Retry-After {shed[1][2]['Retry-After']} s")

        # 9. C leaves: its heartbeat stream ends within two pulses and no
        # heartbeat follows; out of the lookups; a direct GET still served
        if not c.flush_heartbeat() or c.port in sink.ended:
            raise AssertionError("C's heartbeat stream is not live")
        stub(c).call("VolumeServerLeave", vpb.VolumeServerLeaveRequest(),
                     vpb.VolumeServerLeaveResponse)
        t = time.perf_counter()
        while c.port not in sink.ended:
            if time.perf_counter() - t > 2 * pulse_seconds:
                raise AssertionError("C's heartbeat stream still open two "
                                     "pulses after leave")
            time.sleep(0.01)
        ended_s = sink.ended[c.port] - t
        beats[c]._thread.join(timeout=pulse_seconds)
        if beats[c]._thread.is_alive() or c.flush_heartbeat() or \
                c.port not in sink.ended:
            raise AssertionError("C's heartbeater runs on after leave")
        if any(c.peer_address in h for h in peers.lookup_ec(vid).values()):
            raise AssertionError("C still in the EC lookups after leave")
        n = sample[0]
        st_, body, _ = cc.request("GET", f"/{file_id(vid, n, int(cookies[n - 1]))}")
        if (st_, body) != (200, want[n]):
            raise AssertionError(f"a direct GET on C after leave: {st_}")
        if a.port in sink.ended or b.port in sink.ended:
            raise AssertionError("A's or B's heartbeat stream ended")
        log(f"[maint] VolumeServerLeave on C: its heartbeat stream ended "
            f"{ended_s:.3f} s later after {sink.count[c.port]} heartbeats "
            f"and its heartbeater stopped (flush false); out of the EC "
            f"lookups; a direct GET on C still 200")
        return out
    finally:
        stop_gets.set()
        retry.reset_breakers()
        for cl in clients:
            cl.close()
        for vs, hb in beats.items():
            vs.heartbeat_flush = None
            hb.stop()
        for g in grpc_servers:
            g.stop(grace=0.5).wait(timeout=10)
        for vs in servers.values():
            vs.stop()
        rpc.set_tls_config(None)


def phase_maintenance(torch, np, workdir: str, seed: int, card: str) -> dict:
    from seaweedfs_tpu_torch.ec.locate import EcGeometry
    from seaweedfs_tpu_torch.ops import crc_cuda, rs_cuda
    os.makedirs(workdir, exist_ok=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rs_cuda.reset_launches()
    crc_cuda.reset_launches()
    res = maintenance_round_trip(np, workdir, seed + 31, card,
                                 EcGeometry(10, 4), EC_NEEDLES, MAINT_MORE,
                                 MAINT_DELETES, MAINT_STATUSES, REPLICA_GETS,
                                 MAINT_QUERY_NEEDLES)
    torch.cuda.synchronize()
    k1 = dict(rs_cuda.launches_by_entry)
    k3 = crc_cuda.launches
    log(f"[maint] launches on the maintenance plane: K1 {json.dumps(k1)}, "
        f"K3 {k3}; phase wall {time.perf_counter() - t0:.1f} s [{card}]")
    for entry in ("encode", "reconstruct"):
        if not k1.get(entry):
            raise AssertionError(f"K1 {entry} never launched on the "
                                 "maintenance plane")
    if not k3:
        raise AssertionError("K3 never launched on the maintenance plane")
    # K1 alone at the Query's one-stripe widths, outside the counts
    lengths = res["query_lengths"]
    stripe = one_stripe_costs(torch, np, lengths, seed, card, split=False,
                              tag="maint")
    log(f"[maint] the Query's {len(lengths)} degraded intervals: widths "
        f"{min(lengths)}-{max(lengths)} B, median {stripe['L']} B (% 16 = "
        f"{stripe['L'] % 16}); K1 there {stripe['ms']:.5f} ms, bound "
        f"{stripe['bound_ms']:.7f} ms, plain {stripe['plain_ms']:.4f} ms "
        f"[{card}]")
    return {"k1": k1, "k3": k3}


# -- phase 16 ---------------------------------------------------------------
def write_go_volume(np, base: str, n: int, deletes: int, seed: int,
                    version: int = 3) -> "tuple[dict, set]":
    """A volume in the Go reference's big-endian layout, written here field
    by field (independent of storage/ref_format.py): the super block of
    `version`; `n` needles of 1024 + seeded 0-63 B (every 16th named, every
    32nd with a mime, every 64th with a last-modified), each CRC32C stored
    raw or, on every third needle, in the legacy scrambled `Value()` form;
    every record padded to 8 bytes, an aligned one by a whole 8; then
    `deletes` seeded needles deleted by tombstone records (size 0) and
    .idx entries of size 0xFFFFFFFF. Writes `base`.dat and .idx; returns
    ({id: (cookie, data)} of the n needles, the deleted ids)."""
    import struct

    from seaweedfs_tpu_torch.ops.crc32c import crc32c
    rng = np.random.default_rng(seed)
    sizes = 1024 + rng.integers(0, 64, n)
    cookies = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    payload = rng.bytes(int(sizes.sum()))
    ends = np.cumsum(sizes)
    tail = 4 + (8 if version == 3 else 0)  # CRC, then v3's append time
    dat = bytearray(bytes([version, 0, 0, 0, 0, 0, 0, 0]))
    idx = bytearray()

    def record(nid: int, cookie: int, body: bytes, crc: int) -> int:
        off = len(dat)
        dat.extend(struct.pack(">IQI", cookie, nid, len(body)))
        dat.extend(body)
        dat.extend(struct.pack(">I", crc))
        if version == 3:
            dat.extend(struct.pack(">Q", 1_700_000_000_000_000_000 + nid))
        dat.extend(bytes(8 - (16 + len(body) + tail) % 8))
        return off

    want = {}
    for i in range(n):
        nid, cookie = i + 1, int(cookies[i])
        data = payload[int(ends[i] - sizes[i]):int(ends[i])]
        flags, extra = 0, b""
        if nid % 16 == 0:
            name = f"go{nid}.bin".encode()
            flags |= 0x02
            extra += bytes([len(name)]) + name
        if nid % 32 == 0:
            flags |= 0x04
            extra += b"\x18application/octet-stream"
        if nid % 64 == 0:
            flags |= 0x08
            extra += (1_700_000_000 + nid).to_bytes(5, "big")
        raw = crc32c(data)
        crc = ((((raw >> 15) | (raw << 17)) + 0xA282EAD8) & 0xFFFFFFFF
               if nid % 3 == 0 else raw)
        body = struct.pack(">I", len(data)) + data + bytes([flags]) + extra
        off = record(nid, cookie, body, crc)
        idx.extend(struct.pack(">QII", nid, off // 8, len(body)))
        want[nid] = (cookie, data)
    deleted = {int(x) + 1 for x in rng.choice(n, deletes, replace=False)}
    for nid in sorted(deleted):
        off = record(nid, want[nid][0], b"", 0)
        idx.extend(struct.pack(">QII", nid, off // 8, 0xFFFFFFFF))
    with open(base + ".dat", "wb") as f:
        f.write(dat)
    with open(base + ".idx", "wb") as f:
        f.write(idx)
    return want, deleted


def go_import(np, workdir: str, seed: int, card: str, geo, n: int,
              deletes: int, sample: int, device: str = "cuda") -> dict:
    """Phase 16(a): a Go volume migrated onto this fork. walk_dat, read_idx
    and every needle's CRC; write_sorted_ecx; the .dat EC-encoded at
    `geo` (K1 encode); shards LOST_14_2 lost, `sample` needles re-read
    through the stripe locator with the lost intervals reconstructed (K1 at
    one stripe) and parsed by ref_format.parse_needle; the lost shards
    rebuilt (K1) to their bytes; every live needle re-read from the shard
    files; the decode byte-identical to the Go .dat."""
    import concurrent.futures as cf

    from seaweedfs_tpu_torch.ec import encoder, files
    from seaweedfs_tpu_torch.ec.locate import locate
    from seaweedfs_tpu_torch.ec.volume import EcVolume
    from seaweedfs_tpu_torch.ops.coder import TorchCoder
    from seaweedfs_tpu_torch.ops.crc32c import crc32c
    from seaweedfs_tpu_torch.server.volume_server import make_shard_reader
    from seaweedfs_tpu_torch.storage import ref_format
    from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
    from seaweedfs_tpu_torch.storage.store import Store

    gdir = os.path.join(workdir, "go")
    os.makedirs(gdir, exist_ok=True)
    src = os.path.join(gdir, "weed_volume")
    t = time.perf_counter()
    want, deleted = write_go_volume(np, src, n, deletes, seed)
    dat_size = os.path.getsize(src + ".dat")
    log(f"[rest] a Go v3 volume written field by field: {n} needles of 1024 "
        f"+ 0..63 B and {deletes} tombstones, .dat {dat_size} B, in "
        f"{time.perf_counter() - t:.1f} s")

    # the walk, the .idx and every CRC
    t = time.perf_counter()
    sb, recs = ref_format.walk_dat(src + ".dat")
    walk_s = time.perf_counter() - t
    tombs = [r for r in recs if r.is_tombstone]
    live = [r for r in recs if not r.is_tombstone]
    bad = [r.id for r in live if not r.crc_ok]
    if (sb.version, len(recs), len(tombs), len(live), bad) != \
            (3, n + deletes, deletes, n, []):
        raise AssertionError(f"walk_dat: v{sb.version}, {len(recs)} records, "
                             f"{len(tombs)} tombstones, CRC failures {bad[:5]}")
    if any((r.cookie, r.data) != want[r.id] for r in live):
        raise AssertionError("walk_dat: a needle's cookie or data differs")
    named = sum(1 for r in live if r.name)
    aligned = sum(1 for r in live if ref_format.padding_length(r.size, 3) == 8)
    # both stored CRC forms occur (crc_ok above accepts either)
    scrambled = sum(1 for r in live[:65536] if r.checksum != crc32c(r.data))
    if not 0 < scrambled < min(len(live), 65536) or not aligned or not named:
        raise AssertionError(f"{scrambled} scrambled CRCs, {aligned} aligned "
                             f"records, {named} named: a case is missing")
    entries = ref_format.read_idx(src + ".idx")
    if (len(entries), sum(e[2] == ref_format.TOMBSTONE for e in entries)) != \
            (n + deletes, deletes):
        raise AssertionError(f"read_idx: {len(entries)} entries")
    log(f"[rest] walk_dat: {len(recs)} records ({n} needles, {deletes} "
        f"tombstones, {named} named, {aligned} aligned records padded by 8, "
        f"{scrambled} of the first 65,536 with the scrambled CRC form) "
        f"in {walk_s:.3f} s = {len(recs) / walk_s:.0f} needles/s, every "
        f"CRC32C good in raw or scrambled form; read_idx {len(entries)} "
        f"entries, {deletes} of them tombstones")

    # the migration: .ecx from the .idx, the .dat EC-encoded
    base = os.path.join(gdir, str(GO_VID))
    t = time.perf_counter()
    count = ref_format.write_sorted_ecx(src + ".idx", base + ".ecx")
    ecx_s = time.perf_counter() - t
    coder = TorchCoder(geo.d, geo.p, device=device)
    stats: dict = {}
    encoder.encode_volume(src + ".dat", base, geo, coder, stats=stats)
    enc_gbs = dat_size / stats["wall_s"] / 1e9
    loc = {}
    for key, off, size in ref_format.read_idx(base + ".ecx"):
        if size != ref_format.TOMBSTONE and key not in deleted:
            loc[key] = (off * 8, size)
    if count != n + deletes or len(loc) != n - deletes:
        raise AssertionError(f"write_sorted_ecx: {count} entries, "
                             f"{len(loc)} live")
    log(f"[rest] write_sorted_ecx {count} entries in {ecx_s:.3f} s; RS("
        f"{geo.d},{geo.p}) encode of the Go .dat {dat_size} B in "
        f"{stats['wall_s']:.3f} s = {enc_gbs:.3f} GB/s [{card}]")

    def reread(ev, nid, reader):
        off, size = loc[nid]
        buf = ev.read_logical(off, ref_format.record_size(size, 3), reader)
        r = ref_format.parse_needle(buf, 0, 3)
        if (r.id, r.cookie, r.data, r.crc_ok) != (nid, *want[nid], True):
            raise AssertionError(f"needle {nid} re-read from the shards "
                                 "differs")

    # shards lost, a sample read with the lost intervals reconstructed
    for s in LOST_14_2:
        os.replace(base + files.shard_ext(s), base + files.shard_ext(s)
                   + ".orig")
    store = Store("127.0.0.1", 0, "", [DiskLocation(gdir)], ec_geometry=geo,
                  coder_name="torch", device=device)
    pool = cf.ThreadPoolExecutor(4)
    try:
        ev = store.find_ec_volume(GO_VID)
        if ev is None or sorted(ev.shards) != [
                s for s in range(geo.n) if s not in LOST_14_2]:
            raise AssertionError("the Go volume's shards did not mount")
        rstats: dict = {}
        reader = make_shard_reader(store, GO_VID, lambda *a: None, pool,
                                   stats=rstats)
        rng = np.random.default_rng(seed + 1)
        ids = sorted(int(x) for x in rng.choice(sorted(loc), min(sample,
                                                                 len(loc)),
                                                replace=False))
        expected = sum(
            1 for nid in ids for iv in locate(geo, ev.dat_size, loc[nid][0],
                                              ref_format.record_size(
                                                  loc[nid][1], 3))
            if iv.shard_and_offset(geo)[0] in LOST_14_2)
        lat = []
        for nid in ids:
            t = time.perf_counter()
            reread(ev, nid, reader)
            lat.append(time.perf_counter() - t)
        if rstats.get("reconstructs") != expected or not expected:
            raise AssertionError(f"{rstats.get('reconstructs')} reconstructs;"
                                 f" the intervals on lost shards number "
                                 f"{expected}")
        log(f"[rest] {len(ids)} sampled needles re-read through the stripe "
            f"locator with shards {LOST_14_2} lost and parsed by "
            f"ref_format.parse_needle == written; {expected} reconstructs == "
            f"the intervals on lost shards; p50 {_pct(np, lat, 50) * 1e3:.4f}"
            f" ms, p99 {_pct(np, lat, 99) * 1e3:.4f} ms [{card}]")
    finally:
        pool.shutdown(wait=True)
        store.close()

    # the rebuild, every live needle re-read, the decode
    bstats: dict = {}
    t = time.perf_counter()
    got = encoder.rebuild_shards(base, geo, coder, stats=bstats)
    reb_s = time.perf_counter() - t
    if got != sorted(LOST_14_2):
        raise AssertionError(f"rebuilt {got}")
    for s in LOST_14_2:
        orig = base + files.shard_ext(s) + ".orig"
        if not files_equal(np, base + files.shard_ext(s), orig):
            raise AssertionError(f"rebuilt shard {s} differs")
        os.unlink(orig)
    ev = EcVolume(base, GO_VID)
    t = time.perf_counter()
    try:
        for nid in loc:
            reread(ev, nid, None)
    finally:
        ev.close()
    reread_s = time.perf_counter() - t
    out_dat = base + ".decoded.dat"
    t = time.perf_counter()
    encoder.decode_volume(base, out_dat, geo, coder)
    dec_s = time.perf_counter() - t
    if not files_equal(np, out_dat, src + ".dat"):
        raise AssertionError("the decoded .dat differs from the Go .dat")
    log(f"[rest] rebuild of shards {LOST_14_2}: {bstats['bytes_read']} B read "
        f"in {reb_s:.3f} s = {bstats['bytes_read'] / reb_s / 1e9:.3f} GB/s; "
        f"every live needle ({len(loc)}) re-read from the shard files and "
        f"parsed == written in {reread_s:.2f} s = {len(loc) / reread_s:.0f} "
        f"needles/s; decode in {dec_s:.3f} s == the Go .dat byte for byte "
        f"[{card}]")
    shutil.rmtree(gdir, ignore_errors=True)
    return dict(walk=len(recs) / walk_s, encode=enc_gbs,
                rebuild=bstats["bytes_read"] / reb_s / 1e9,
                reread=len(loc) / reread_s)


def remote_tier_round_trip(np, a, arg: str, kind: str, vid: int, n: int,
                           gets: int, seed: int, card: str,
                           device: str = "cuda") -> dict:
    """Phase 16(b) on one tier: `n` needles written on server A, its .dat
    moved to the `kind` tier by VolumeTierMoveDatToRemote, `gets` sampled
    needles GET cold, then again warm, from the remote copy; VolumeScrub
    "skipped-tiered"; VolumeTierMoveDatFromRemote, the .dat byte-equal, and
    VolumeScrub through K3 (on the card) of every needle, all clean."""
    from seaweedfs_tpu_torch.ops import crc_cuda
    from seaweedfs_tpu_torch.storage.backend import open_remote
    from seaweedfs_tpu_torch.storage.types import file_id

    spec = f"{kind}:{arg}"
    rng = np.random.default_rng(seed)
    sizes = 1024 + rng.integers(0, 64, n)
    cookies = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    order = sorted(int(i) + 1 for i in rng.choice(n, gets, replace=False))
    a.allocate_volume(vid)
    want = write_set(np, a.store, rng, sizes, cookies, set(order), vid=vid)
    v = a.store.find_volume(vid)
    v.sync()
    dat_size = os.path.getsize(v.dat_path)
    dat_hash = _sha256(v.dat_path)
    t = time.perf_counter()
    a.volume_tier_move_dat_to_remote(vid, spec)
    up_s = time.perf_counter() - t
    tiered = a.store.find_volume(vid)
    if tiered.remote_spec is None or os.path.exists(tiered.dat_path) or \
            open_remote(spec).object_size(f"{vid}.dat") != dat_size:
        raise AssertionError(f"{kind}: the .dat is not on the tier")
    cl = _Client(a.url)
    cold, warm = [], []
    try:
        for nid in order:
            path = f"/{file_id(vid, nid, int(cookies[nid - 1]))}"
            for lat in (cold, warm):
                t = time.perf_counter()
                st, got, _ = cl.request("GET", path)
                lat.append(time.perf_counter() - t)
                if (st, got) != (200, want[nid]):
                    raise AssertionError(f"{kind}: GET of needle {nid} from "
                                         f"the tier: {st}")
    finally:
        cl.close()
    res = a.volume_scrub(vid, device="")[0]
    if res["mode"] != "skipped-tiered" or res["scanned"]:
        raise AssertionError(f"{kind}: VolumeScrub of the tiered volume {res}")
    t = time.perf_counter()
    a.volume_tier_move_dat_from_remote(vid)
    down_s = time.perf_counter() - t
    back = a.store.find_volume(vid)
    if back.remote_spec is not None or _sha256(back.dat_path) != dat_hash:
        raise AssertionError(f"{kind}: the .dat brought back differs")
    k3 = crc_cuda.launches
    t = time.perf_counter()
    res = a.volume_scrub(vid, device="")[0]
    scrub_s = time.perf_counter() - t
    k3 = crc_cuda.launches - k3
    if (res["scanned"], res["corrupt_needle_ids"]) != (n, []) or \
            (device == "cuda" and not k3):
        raise AssertionError(f"{kind}: VolumeScrub after the promotion {res}, "
                             f"K3 launches {k3}")
    log(f"[rest] {kind}: {n} needles on A, .dat {dat_size} B tiered up in "
        f"{up_s:.3f} s = {dat_size / up_s / 1e9:.3f} GB/s; {len(order)} GETs "
        f"from the remote copy == written, cold p50 "
        f"{_pct(np, cold, 50) * 1e3:.4f} ms p99 {_pct(np, cold, 99) * 1e3:.4f}"
        f" ms, warm p50 {_pct(np, warm, 50) * 1e3:.4f} ms; VolumeScrub "
        f"skipped-tiered; back in {down_s:.3f} s = "
        f"{dat_size / down_s / 1e9:.3f} GB/s, sha256 equal; VolumeScrub "
        f"{res['mode']} {res['scanned']} needles clean in {scrub_s:.3f} s = "
        f"{n / scrub_s:.0f} needles/s, K3 {k3} launches [{card}]")
    return dict(up=dat_size / up_s / 1e9, down=dat_size / down_s / 1e9,
                cold=cold, warm=warm)


def smooth_rgb(np, seed: int, w: int, h: int):
    """Seeded smooth content [h, w, 3] uint8: one plane wave a channel,
    sin(fx x + fy y + ph) built from outer products of 1-D terms."""
    rng = np.random.default_rng(seed)
    x = np.arange(w, dtype=np.float32) * (2 * np.pi / w)
    y = np.arange(h, dtype=np.float32) * (2 * np.pi / h)
    out = np.empty((h, w, 3), np.uint8)
    for c in range(3):
        fx, fy, ph = rng.uniform(0.5, 4.0), rng.uniform(0.5, 4.0), \
            rng.uniform(0.0, 6.3)
        plane = (np.outer(np.cos(fy * y), np.sin(fx * x + ph))
                 + np.outer(np.sin(fy * y), np.cos(fx * x + ph)))
        out[..., c] = (127.5 + 127.5 * plane).astype(np.uint8)
    return out


def png_bytes(np, rgb) -> bytes:
    """An 8-bit RGB PNG of `rgb`, made with zlib and struct (no Pillow)."""
    import struct
    import zlib
    h, w, _ = rgb.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)  # filter byte 0 a row
    raw[:, 1:] = rgb.reshape(h, 3 * w)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def jpeg_bytes(np, rgb, orientation: int) -> bytes:
    """A JPEG of `rgb` with the EXIF orientation tag (needs Pillow)."""
    import io

    from PIL import Image
    exif = Image.Exif()
    exif[0x0112] = orientation
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="JPEG", exif=exif.tobytes())
    return buf.getvalue()


# the lock check's server workload, run in a subprocess whose environment
# sets SWTPU_LOCKCHECK=1: the detector patches threading before any lock of
# the package exists, which it cannot do in this process
LOCK_SCRIPT = r'''
import http.client, json, os, socket, sys
workdir, device = sys.argv[1], sys.argv[2]
import seaweedfs_tpu_torch
from seaweedfs_tpu_torch.ec.locate import EcGeometry
from seaweedfs_tpu_torch.server.volume_server import LocalPeers, VolumeServer
from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.types import file_id
from seaweedfs_tpu_torch.utils import locktrack
assert locktrack.installed()
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
store = Store("127.0.0.1", port, "", [DiskLocation(workdir)],
              ec_geometry=EcGeometry(10, 4), coder_name="torch", device=device)
vs = VolumeServer(store, "127.0.0.1", port)
vs.peers = LocalPeers({vs.peer_address: vs})
vs.start()
try:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)

    def req(method, path, body=None):
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, r.read()
    vs.allocate_volume(7)
    bodies = {}
    for i in range(1, 129):
        fid = file_id(7, i, 0x1000 + i)
        bodies[fid] = os.urandom(1000 + i)
        assert req("POST", "/" + fid, bodies[fid])[0] == 201
    for fid, body in bodies.items():
        assert req("GET", "/" + fid) == (200, body)
    vs.volume_mark_readonly(7)
    vs.volume_ec_shards_generate(7)
    vs.volume_ec_shards_mount(7)
    vs.volume_delete(7)
    vs.volume_ec_shards_delete(7, shard_ids=[0])
    for fid, body in bodies.items():  # all on shard 0: each reconstructs
        assert req("GET", "/" + fid) == (200, body)
    status, raw = req("GET", "/debug/locks")
    print(json.dumps({"status": status, "locks": json.loads(raw),
                      "reconstructs": vs.read_stats.get("reconstructs", 0)}))
finally:
    vs.stop()
'''


def lock_check(workdir: str, device: str) -> dict:
    """LOCK_SCRIPT in a subprocess under SWTPU_LOCKCHECK=1: 128 POSTs and
    GETs, a seal, 128 degraded GETs; its /debug/locks must report the
    detector on and zero cycles."""
    here = os.path.dirname(os.path.abspath(__file__))
    wd = os.path.join(workdir, "lockcheck")
    os.makedirs(wd, exist_ok=True)
    env = dict(os.environ, SWTPU_LOCKCHECK="1",
               PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", LOCK_SCRIPT, wd, device],
                          cwd=here, env=env, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the lock check's server failed: "
                             f"{proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    locks = out["locks"]
    if out["status"] != 200 or not locks["enabled"] or locks["cycles"] or \
            not locks["locks_tracked"] or out["reconstructs"] != 128:
        raise AssertionError(f"/debug/locks under SWTPU_LOCKCHECK=1: "
                             f"{json.dumps(out)[:2000]}")
    log(f"[rest] /debug/locks of a server run under SWTPU_LOCKCHECK=1 (128 "
        f"POSTs and GETs, a seal, 128 degraded GETs): {len(locks['cycles'])}"
        f" cycles over {locks['locks_tracked']} tracked locks and "
        f"{locks['edges']} orderings, {len(locks['long_holds'])} long holds "
        f"over {locks['hold_threshold_ms']} ms; {time.perf_counter() - t:.1f}"
        f" s with the subprocess's start")
    return locks


def rest_round_trip(np, workdir: str, seed: int, card: str, go_geo, geo,
                    go_needles: int, go_deletes: int, go_sample: int,
                    azure_needles: int, gcs_needles: int, tier_gets: int,
                    images: int, jpegs: int, image_size, trace_gets: int,
                    hook_gets: int, device: str = "cuda") -> dict:
    """Phase 16's path, every check fatal: (a) the Go-format import; then
    servers A and B (VolumeServers over Stores on `device`, joined by
    LocalPeers) for (b) the `azure:` and `gcs-json:` tiers against the
    port's stand-ins, (c) image needles on a degraded RS(10,4) volume GET
    resized, (d) the debug plane after that traffic and (e) the hooks'
    cost. Logs the measured numbers and returns them."""
    import concurrent.futures as cf

    from seaweedfs_tpu_torch import images as img_ops
    from seaweedfs_tpu_torch.images import resize
    from seaweedfs_tpu_torch.profiling import sampler
    from seaweedfs_tpu_torch.security import Guard
    from seaweedfs_tpu_torch.server.volume_server import LocalPeers, VolumeServer
    from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.store import Store
    from seaweedfs_tpu_torch.storage.types import file_id
    from seaweedfs_tpu_torch.utils import failpoints, retry
    from seaweedfs_tpu_torch.utils.mini_azure import MiniAzure
    from seaweedfs_tpu_torch.utils.mini_gcs import MiniGcs

    out: dict = {}
    out["go"] = go_import(np, workdir, seed, card, go_geo, go_needles,
                          go_deletes, go_sample, device=device)

    # the servers of earlier phases have released the process's sampler:
    # what it holds from here on is this phase's own
    if sampler._refs:
        raise AssertionError(f"{sampler._refs} servers still hold the sampler")
    if sampler.default_sampler() is not None:
        sampler.default_sampler().reset()
    servers = {}
    for x in "ab":
        port = _free_port()
        store = Store("127.0.0.1", port, "", [DiskLocation(os.path.join(
            workdir, f"rest_{x}"))], ec_geometry=geo, coder_name="torch",
            device=device)
        servers[x] = VolumeServer(store, "127.0.0.1", port)
    a, b = servers["a"], servers["b"]
    LocalPeers({vs.peer_address: vs for vs in servers.values()})
    stand_ins = []
    client = None
    retry.reset_breakers()
    try:
        for vs in servers.values():
            vs.start()
        if sampler._refs != 2:
            raise AssertionError(f"the sampler has {sampler._refs} holders")
        client = _Client(a.url)

        # (b) the azure: and gcs-json: tiers
        az = MiniAzure().start()
        gcs = MiniGcs().start()
        stand_ins += [az, gcs]
        from seaweedfs_tpu_torch.remote import parse_azure_spec
        azure_arg = f"{az.endpoint}/tier?{az.account}:{az.key_b64}"
        parse_azure_spec(azure_arg).ensure_container()
        out["azure"] = remote_tier_round_trip(
            np, a, azure_arg, "azure", AZURE_VID, azure_needles, tier_gets,
            seed + 2, card, device)
        out["gcs"] = remote_tier_round_trip(
            np, a, f"{gcs.endpoint}/tier?{gcs.token}", "gcs-json", GCS_VID,
            gcs_needles, max(1, tier_gets // 4), seed + 3, card, device)

        # (c) image needles on a degraded EC volume, GET resized
        pil = resize.HAVE_PIL
        w, h = image_size
        t = time.perf_counter()

        def make(i: int) -> Needle:
            rgb = smooth_rgb(np, seed * 100003 + i, w, h)
            if i > images:  # the JPEGs, with EXIF orientation 6
                return Needle(id=i, cookie=0x1A6E + i, data=jpeg_bytes(
                    np, rgb, 6), name=f"pic{i}.jpg".encode(),
                    mime=b"image/jpeg")
            return Needle(id=i, cookie=0x1A6E + i, data=png_bytes(np, rgb),
                          name=f"pic{i}.png".encode(), mime=b"image/png")
        count = images + (jpegs if pil else 0)
        with cf.ThreadPoolExecutor(8) as pool:
            pics = list(pool.map(make, range(1, count + 1)))
        make_s = time.perf_counter() - t
        a.allocate_volume(IMAGE_VID)
        for lo in range(0, count, 256):
            a.store.write_needles_bulk(IMAGE_VID, pics[lo:lo + 256])
        a.volume_mark_readonly(IMAGE_VID)
        a.volume_ec_shards_generate(IMAGE_VID)
        b.volume_ec_shards_copy(IMAGE_VID, shard_ids=list(range(7, geo.n)),
                                copy_ecx_file=True, copy_vif_file=True,
                                source_data_node=a.peer_address)
        a.volume_ec_shards_mount(IMAGE_VID)
        b.volume_ec_shards_mount(IMAGE_VID)
        a.volume_ec_shards_delete(IMAGE_VID, shard_ids=list(range(7, geo.n)))
        a.volume_delete(IMAGE_VID)
        a.volume_ec_shards_delete(IMAGE_VID, shard_ids=list(A_LOST))
        b.volume_ec_shards_delete(IMAGE_VID, shard_ids=list(B_LOST))
        ev = a.store.find_ec_volume(IMAGE_VID)
        gone = set(A_LOST + B_LOST)
        on_lost = [n.id for n in pics
                   if any(s in gone for s, _ in _intervals(ev, geo, n.id))]
        queries = [(n, "?width=128&height=128") for n in pics] + \
            [(n, "?width=200&mode=fit") for n in pics[::2]]

        def host(job):
            """images.resized on the host, on the stored bytes."""
            n, q = job
            params = dict(kv.split("=") for kv in q[1:].split("&"))
            ext = os.path.splitext(n.name.decode())[1]
            wd, ht, mode, _ = img_ops.should_resize(ext, params)
            data = n.data
            if ext == ".jpg":
                data = img_ops.fix_jpeg_orientation(data)
            return img_ops.resized(ext, data, wd, ht, mode)
        with cf.ThreadPoolExecutor(8) as pool:
            wants = list(pool.map(host, queries))
        r0 = a.read_stats.get("reconstructs", 0)
        lat, resized_bytes = [], 0
        for (n, q), want in zip(queries, wants):
            t = time.perf_counter()
            st, got, _ = client.request(
                "GET", f"/{file_id(IMAGE_VID, n.id, n.cookie)}{q}")
            lat.append(time.perf_counter() - t)
            if (st, got) != (200, want):
                raise AssertionError(f"resized GET of image {n.id}{q}: {st}, "
                                     f"{len(got)} B against {len(want)}")
            if not pil and got != n.data:
                raise AssertionError("without Pillow a resize must serve "
                                     "the stored bytes")
            resized_bytes += len(got)
        recs = a.read_stats.get("reconstructs", 0) - r0
        if not recs or not on_lost:
            raise AssertionError("no resized GET read a lost shard")
        out["images"] = dict(pil=pil, gets=lat, reconstructs=recs)
        stored = sum(len(n.data) for n in pics)
        log(f"[rest] images: Pillow {'present' if pil else 'ABSENT'} on this "
            f"host; {images} PNGs of {w}x{h}"
            + (f" and {jpegs} JPEGs with EXIF orientation 6" if pil else "")
            + f" ({stored} B, made in {make_s:.2f} s) sealed at RS({geo.d},"
            f"{geo.p}) on A and B, shards {sorted(gone)} lost, {len(on_lost)}"
            f" of them with an interval on a lost shard; {len(queries)} "
            f"resized GETs (every one 128x128, half 200 fit) == images.resized"
            f" on the host{'' if pil else ' (the stored bytes)'}, {recs} "
            f"reconstructs; p50 {_pct(np, lat, 50) * 1e3:.4f} ms, p99 "
            f"{_pct(np, lat, 99) * 1e3:.4f} ms, {resized_bytes} B out [{card}]")

        # (d) the debug plane, read after that traffic
        cb = _Client(b.url)
        try:
            def get_json(cl, path, want_status=200):
                st, body, _ = cl.request("GET", path)
                if st != want_status:
                    raise AssertionError(f"GET {path}: {st} {body[:300]!r}")
                return json.loads(body) if want_status == 200 else body

            summary = get_json(client, "/debug/profile?mode=summary")
            cls = summary["classes"]
            for c in ("read_pool", "ec_read"):
                if sum(cls.get(c, {}).values()) == 0:
                    raise AssertionError(f"no samples in thread class {c}: "
                                         f"{cls}")
            get_json(client, "/debug/profile?hz=abc", 400)
            flight = get_json(client, "/debug/flight?type=volume.get&limit=5")
            top = flight["entries"]
            if not top or any(set(e["queue_depths"]) != {"read", "ec_read"}
                              or "store" not in e["stages_ms"] for e in top):
                raise AssertionError(f"/debug/flight: {flight}")
            traces = get_json(client, "/debug/traces?limit=5")
            evs = get_json(client, "/debug/events?limit=5")
            if not traces["count"] or not evs["count"]:
                raise AssertionError("/debug/traces or /debug/events empty")
            log(f"[rest] /debug/profile summary: {summary['samples']} thread-"
                f"samples over {summary['ticks']} ticks at {summary['hz']:g} "
                f"Hz, by class {json.dumps(cls)}; ?hz=abc 400. /debug/flight "
                f"(slow >= {flight['slow_ms']} ms, {flight['recorded']} "
                f"recorded): slowest GETs "
                + "; ".join(f"{e['path'][:24]} {e['duration_ms']} ms stages "
                            f"{json.dumps(e['stages_ms'])} depths "
                            f"{json.dumps(e['queue_depths'])}"
                            for e in top[:3])
                + f"; /debug/traces {traces['buffered']} spans, /debug/events "
                f"{evs['buffered']} events")

            # a failpoint armed on B fires on a degraded GET from A
            fired0 = failpoints.fired("ec.shard.read")
            armed = get_json(cb, "/debug/failpoints?name=ec.shard.read"
                                 "&spec=times:1:error")
            if "ec.shard.read" not in armed["armed"]:
                raise AssertionError(f"/debug/failpoints: {armed}")
            n = next(p for p in pics if p.id in on_lost)
            st, got, _ = client.request(
                "GET", f"/{file_id(IMAGE_VID, n.id, n.cookie)}")
            fired = get_json(cb, "/debug/failpoints")["fired"].get(
                "ec.shard.read", 0) - fired0
            disarmed = get_json(cb, "/debug/failpoints?name=ec.shard.read"
                                    "&spec=off")
            if (st, got) != (200, n.data) or fired != 1 or \
                    "ec.shard.read" in disarmed["armed"]:
                raise AssertionError(f"failpoint: GET {st}, fired {fired}, "
                                     f"armed {disarmed['armed']}")

            # the lifecycle report and its guarded stamp
            life = get_json(client, "/debug/lifecycle")
            reads = life["ec_volumes"][str(IMAGE_VID)]["reads"]
            if reads < len(queries):
                raise AssertionError(f"/debug/lifecycle: {reads} reads")
            at = time.time() + 10 * 365 * 86400
            doc = json.dumps({"volume": IMAGE_VID, "destroy_time": at})
            st, _, _ = client.request("POST", "/debug/lifecycle", doc)
            stamped = get_json(client, "/debug/lifecycle")["ec_volumes"][
                str(IMAGE_VID)]["destroy_time"]
            a.guard = Guard(signing_key="phase-16-key",
                            white_list=["10.9.9.9"])
            try:
                refused, _, _ = client.request("POST", "/debug/lifecycle", doc)
            finally:
                a.guard = None
            if (st, stamped, refused) != (200, at, 401):
                raise AssertionError(f"/debug/lifecycle POST {st}, stamped "
                                     f"{stamped}, guarded {refused}")
            st, page, hdrs = client.request("GET", "/ui")
            page = page.decode()
            if st != 200 or f"<td>{IMAGE_VID}</td>" not in page or \
                    f"<td>{AZURE_VID}</td>" not in page:
                raise AssertionError("/ui does not list the volumes")
            st, metrics, _ = client.request("GET", "/metrics")
            hot = f'SeaweedFS_hot_requests{{kind="volume",key="{IMAGE_VID}"}}'
            if hot not in metrics.decode():
                raise AssertionError(f"/metrics lacks {hot}")
            log(f"[rest] /debug/failpoints on B: ec.shard.read armed "
                f"times:1:error, fired {fired} on a degraded GET from A "
                f"(200, == written), disarmed; /debug/lifecycle {reads} reads "
                f"of the EC volume, POST stamped destroy_time, 401 when "
                f"guarded; /ui lists the volumes; /metrics has {hot}")

            # a device trace around degraded GETs
            st, text, _ = client.request("GET", "/debug/jax-profiler")
            if st != 200:
                raise AssertionError(f"/debug/jax-profiler: {st} {text!r}")
            r0 = a.read_stats.get("reconstructs", 0)
            for i in range(trace_gets):
                n = next(p for p in pics if p.id == on_lost[i % len(on_lost)])
                st, got, _ = client.request(
                    "GET", f"/{file_id(IMAGE_VID, n.id, n.cookie)}")
                if (st, got) != (200, n.data):
                    raise AssertionError("a degraded GET under the trace")
            traced = a.read_stats.get("reconstructs", 0) - r0
            st, text, _ = client.request("GET", "/debug/jax-profiler?stop=1")
            path = text.decode().split("written to ")[-1].strip()
            with open(path) as f:
                tev = json.load(f).get("traceEvents", [])
            os.unlink(path)
            k1 = [e for e in tev if e.get("ph") == "X" and e.get("cat") ==
                  "kernel" and "rs_gf_apply" in e.get("name", "")]
            if st != 200 or (device == "cuda" and not k1):
                raise AssertionError(f"the device trace of {trace_gets} "
                                     f"degraded GETs names no K1 kernel "
                                     f"({len(tev)} events)")
            out["trace_k1"] = len(k1)
            log(f"[rest] /debug/jax-profiler around {trace_gets} degraded "
                f"GETs ({traced} reconstructs): {len(tev)} trace events, "
                f"{len(k1)} K1 kernels ({k1[0]['name'][:60] if k1 else '-'}), "
                f"{sum(e.get('dur', 0) for e in k1):.1f} us of device time "
                f"[{card}]")
        finally:
            cb.close()
        out["locks"] = lock_check(workdir, device)

        # (e) the hooks' cost: healthy GETs with the sampler on, paused, on
        a.allocate_volume(HOOK_VID)
        rng = np.random.default_rng(seed + 5)
        total = 2 * hook_gets
        sizes = 1024 + rng.integers(0, 64, total)
        cookies = rng.integers(0, 1 << 32, total, dtype=np.uint64)
        want = write_set(np, a.store, rng, sizes, cookies,
                         set(range(1, total + 1)), vid=HOOK_VID)
        hz = sampler.default_sampler().hz

        def gets(ids) -> list:
            lat = []
            for nid in ids:
                t = time.perf_counter()
                st, got, _ = client.request(
                    "GET", f"/{file_id(HOOK_VID, nid, int(cookies[nid - 1]))}")
                lat.append(time.perf_counter() - t)
                if (st, got) != (200, want[nid]):
                    raise AssertionError(f"GET of needle {nid}: {st}")
            return lat
        half = hook_gets // 2
        on = gets(range(1, half + 1))
        get_json(client, "/debug/profile?hz=0")
        off = gets(range(half + 1, half + hook_gets + 1))
        get_json(client, f"/debug/profile?hz={hz:g}")
        on += gets(range(half + hook_gets + 1, total + 1))
        out["hooks"] = dict(on=on, off=off)
        log(f"[rest] the hooks' cost, {len(on)} + {len(off)} healthy GETs on "
            f"A, one keep-alive client: sampler at {hz:g} Hz with the flight "
            f"recorder, stage histograms and hot keys (two halves, before and "
            f"after) p50 {_pct(np, on, 50) * 1e3:.4f} ms p99 "
            f"{_pct(np, on, 99) * 1e3:.4f} ms; after /debug/profile?hz=0 p50 "
            f"{_pct(np, off, 50) * 1e3:.4f} ms p99 "
            f"{_pct(np, off, 99) * 1e3:.4f} ms [{card}]")
        return out
    finally:
        failpoints.clear("ec.shard.read")
        retry.reset_breakers()
        if client is not None:
            client.close()
        for vs in servers.values():
            vs.stop()
        for s in stand_ins:
            s.stop()


def phase_rest(torch, np, workdir: str, seed: int, card: str) -> dict:
    from seaweedfs_tpu_torch.ec.locate import EcGeometry
    from seaweedfs_tpu_torch.ops import crc_cuda, rs_cuda
    os.makedirs(workdir, exist_ok=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rs_cuda.reset_launches()
    crc_cuda.reset_launches()
    rest_round_trip(np, workdir, seed + 41, card, EcGeometry(14, 2),
                    EcGeometry(10, 4), GO_NEEDLES, GO_DELETES, GO_SAMPLE,
                    AZURE_NEEDLES, GCS_NEEDLES, TIER_GETS, IMAGE_COUNT,
                    IMAGE_JPEGS, IMAGE_SIZE, TRACE_GETS, HOOK_GETS)
    torch.cuda.synchronize()
    k1 = dict(rs_cuda.launches_by_entry)
    k3 = crc_cuda.launches
    log(f"[rest] launches on the rest of the volume server: K1 "
        f"{json.dumps(k1)}, K3 {k3}; phase wall "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    for entry in ("encode", "reconstruct"):
        if not k1.get(entry):
            raise AssertionError(f"K1 {entry} never launched in phase 16")
    if not k3:
        raise AssertionError("K3 never launched in phase 16")
    return {"k1": k1, "k3": k3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build", "smoke_work"))
    ap.add_argument("--phases", default=",".join(map(str, PHASES)),
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args(argv)
    phases = {int(f) for f in args.phases.split(",") if f.strip()}
    if not phases <= set(PHASES):
        ap.error(f"--phases takes numbers among {PHASES}")

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    try:
        import seaweedfs_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    card = phase_device(torch)
    build_kernels(phases)
    if 2 in phases:
        phase_build()
    errs = phase_compare(torch, np, args.seed) if 3 in phases else None
    times = phase_timing(torch, np, args.seed, card) if 4 in phases else None
    if 5 in phases:
        phase_entry(torch)
    launches = None
    if 6 in phases:
        try:
            launches = phase_main(torch, np, args.workdir, args.seed, card)
        finally:
            shutil.rmtree(args.workdir, ignore_errors=True)
    k3_err = k3_times = k3_launches = None
    if 7 in phases:
        phase_build("crc32c", tag="k3")
        k3_err = phase_k3_compare(torch, np, args.seed)
        k3_times = phase_k3_timing(torch, np, args.seed, card)
    if 8 in phases:
        try:
            k3_launches = phase_scrub(torch, np, args.workdir, args.seed, card)
        finally:
            shutil.rmtree(args.workdir, ignore_errors=True)
    ec_launches = None
    if 9 in phases:
        try:
            ec_launches = phase_ec_store(torch, np, args.workdir, args.seed, card)
        finally:
            shutil.rmtree(args.workdir, ignore_errors=True)
    tier = None
    if 10 in phases:
        try:
            tier = phase_tier(torch, np, args.workdir, args.seed, card)
        finally:
            shutil.rmtree(args.workdir, ignore_errors=True)
    codec_launches = None
    if 11 in phases:
        try:
            codec_launches = phase_codecs(torch, np, args.workdir, args.seed, card)
        finally:
            shutil.rmtree(args.workdir, ignore_errors=True)
    mesh = None
    if 12 in phases:
        try:
            mesh = phase_mesh(torch, np, args.workdir, args.seed, card)
        finally:
            shutil.rmtree(args.workdir, ignore_errors=True)
    server = None
    if 13 in phases:
        try:
            server = phase_server(torch, np, args.workdir, args.seed, card)
        finally:
            shutil.rmtree(args.workdir, ignore_errors=True)
    replica = None
    if 14 in phases:
        try:
            replica = phase_replica(torch, np, args.workdir, args.seed, card)
        finally:
            shutil.rmtree(args.workdir, ignore_errors=True)
    maint = None
    if 15 in phases:
        try:
            maint = phase_maintenance(torch, np, args.workdir, args.seed, card)
        finally:
            shutil.rmtree(args.workdir, ignore_errors=True)
    rest = None
    if 16 in phases:
        try:
            rest = phase_rest(torch, np, args.workdir, args.seed, card)
        finally:
            shutil.rmtree(args.workdir, ignore_errors=True)
    log(f"[done] phases {sorted(phases | {1})} passed in "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    if None not in (errs, times, launches, k3_err, k3_times, k3_launches,
                    ec_launches, tier, codec_launches, mesh, server, replica,
                    maint, rest):
        kernels = [dict(name=f"rs_gf_apply:{entry}", route="cuda",
                        source=K1_SOURCE, replaces=replaces,
                        launches=launches.get(entry, 0)
                        + ec_launches.get(entry, 0)
                        + tier["k1"].get(entry, 0)
                        + codec_launches.get(entry, 0)
                        + mesh["launches"]["k1"].get(entry, 0)
                        + server["k1"].get(entry, 0)
                        + replica["k1"].get(entry, 0)
                        + maint["k1"].get(entry, 0)
                        + rest["k1"].get(entry, 0),
                        max_abs_err=errs[entry], ms=times[entry]["ms"],
                        plain_ms=times[entry]["plain_ms"],
                        bound_ms=times[entry]["bound_ms"],
                        bound_by=times[entry]["bound_by"], library_ms=None)
                   for entry, replaces in K1_ENTRIES.items()]
        k3 = k3_times[K3_SHAPES[0]]  # the scrub path's batch
        kernels.append(dict(name="crc32c_states", route="cuda",
                            source=K3_SOURCE, replaces=K3_REPLACES,
                            launches=k3_launches + tier["k3_scrub"]
                            + mesh["launches"]["k3"] + server["k3"]
                            + replica["k3"] + maint["k3"] + rest["k3"],
                            max_abs_err=k3_err,
                            ms=k3["ms"], plain_ms=k3["plain_ms"],
                            bound_ms=k3["bound_ms"], bound_by=k3["bound_by"],
                            library_ms=None))
        print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

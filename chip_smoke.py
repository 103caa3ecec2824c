#!/usr/bin/env python3
"""On-card check of the PyTorch port: builds its CUDA kernels, holds each one
against its plain PyTorch version, serves and trains full-width deepfm,
full-width dcn-v2 and full-width deepfm with ``picasso_narrow`` and its L2
tier on one card, trains full-width deepfm under ``--grad-compress fp16``
and ``topk``, serves and trains full Criteo DLRM under ``picasso_narrow``,
serves and trains full-width deepfm unpacked under the per-group
``mixed`` assignment and packed under ``ps``, with ``hybrid``,
``mp_nodedup`` and ``allgather_rows`` driven on the packed state, drives
the runtime (checkpoints, guard, chaos, streaming, replanning), serves,
trains and retrieves with full-width sasrec and mind, and runs DLRM and
narrow deepfm with ``--pin-l2`` (the L2 tier and the narrow master in pinned
host memory, read and written by the kernels over the bus) and the
calibrated cost model, and trains full-width deepfm on 4 ranks sharing the
card (phase 17), then under the Supervisor, the guard and chaos with the
ranks' checkpoints (phase 18), then through live reshards 4 -> 2 -> 4 and
checkpoints restored at other worlds (phase 19).

    python3 chip_smoke.py

Phases, in order (any failure raises and exits non-zero):

1. build every kernel from ``src/repro_torch/kernels/csrc`` with nvcc
   (the sixteen ports and ``host_rows.cu``, the row gather/scatter for a
   host-resident table; one nvcc per source, all at once);
2. run each kernel at its path's shape (serving B = 512, training B = 256)
   and at a bulk shape (B = 65,536) against its plain version on the same
   inputs: ``hit``/``slot`` bitwise, rows/bags/FM/gradients/updated rows/
   cross outputs and all four cross cotangents to max-abs <= 1e-5 of the
   value scale, miss rows, empty bags, unused gradient slots exactly 0,
   rows ``dedup_adagrad`` does not touch bitwise unchanged, both cross
   kernels repeating bit for bit; time kernel, plain version and, where
   one PyTorch call computes the same function, that call (CUDA events,
   median of 30 after warm-up) beside the byte/op bound (for the cross
   kernels the 3xTF32 tensor-core bound, the float32-FMA bound beside it).
   ``cross_layer`` is timed again at the training path's B = 256, and both
   cross kernels run on edge shapes (B in 1, 37, 65,537 by d in 16, 29,
   67, 429: within 1e-5 of scale, repeating bit for bit). The embedding
   kernels run again at dcn-v2's D = 16 and n = B x 26 on its table.
   ``gather_project`` and ``gather_project_grad`` run at the narrow plan's
   serving and training shapes (d = 4, D = 10, m = the bucket capacity),
   at DLRM's (d = 32, D = 128, n = 13,312 and 6,656) and at bulk
   (``gather_project`` one launch from ``ops.gather_project_plan``;
   ``gather_project_grad`` a memset and two kernels grouping each slot's
   positions in lists, no sort, lanes from ``ops.gather_project_grad_plan``):
   outputs within 1e-5 of scale, not-kept positions and empty slots exactly
   0, both repeating bit for bit, the gradient reached both standalone and
   through the autograd of ``ops.gather_project``; the gradient also on
   edge lists (n = 0, m = 1, every position on one slot, runs of 32 and
   33 and of 128 and 129 about the lists it sorts in shared memory, slots
   outside [0, m), d = 1, d = 256, d * D = 12,288, g_wide off 16 bytes),
   empty slots exactly +0.0.
   ``fm_interaction`` and ``fm_interaction_bwd`` (samples staged in shared
   memory by ``cp.async``, ``ops.fm_plan`` and ``ops.fm_bwd_plan``) run at
   deepfm's serving and training batches and at bulk: within 1e-5 of
   scale, repeating bit for bit.
   ``dedup_adagrad`` (a memset and two hash-grouping kernels, no sort) runs
   again on the 187,780,711 x 4 narrow master and its 48,806,440-row L2 tier
   at D = 10, on DLRM's 187,767,399 x 32 master and its 4,161,784-row L2
   tier at D = 128, and with rows repeated 1,000, 33 and 2 times: touched
   rows within 1e-5 of scale, the rest bitwise unchanged, a second call
   bitwise the first. ``tier_probe`` (a k-ary search, lanes a query from
   ``ops.tier_probe_plan``; a ranged search at bulk) runs again at the
   training path's n = 9,984, on the 48,806,440-key narrow L2 tier, on
   DLRM's 2,080,896-key L1 (serving and training) and 4,161,784-key L2 at
   D = 128, and on edge cases (H = 1, all hits, all misses, queries above
   every key, a sentinel tail, unsorted queries) at n = 1,037, 40,000,
   70,001 and 150,001 (32, 4, 2 lanes and the ranged search): hit, slot
   and rows bitwise the plain version's, a second call bitwise the first;
   ``searchsorted`` with the masked row gather is its yardstick.
   ``segment_grad`` (one launch along the forward unique's stable sort,
   which must equal ``torch.sort(inv, stable=True)``) runs again at DLRM's
   n = 6,656, D = 128, and on each training path's own zipf (a = 1.2)
   batch packed as the path packs it (runs of up to 200 positions; at bulk
   52,393): bitwise alike with the carried sort and standalone (where the
   wrapper sorts once, counted in ``ops.sorts``), repeating bit for bit,
   within 1e-5 of scale of the plain version, unused slots exactly 0.
   ``gather_pool`` (one launch, no scratch) runs again at the training
   path's n = 9,984 and at DLRM's D = 128 (n = 13,312 and 6,656), on
   multi-position layouts (runs of 1-200 positions with empty bags among
   them and at the tail, a 1,000-position run across tiles, a seg past
   n_bags, n = 1) at D = 1, 3, 10, 128, 129 and 1,024, and with seg =
   arange at D = 1, 3, 129 and 1,024: within 1e-5 of scale of the plain
   version, uncovered bags exactly 0, a second call bitwise the first.
   The four gradient-compression kernels run on the routed rows of a
   training step (m = the bucket capacity, 37.5 % of the rows exactly
   zero, some with tied magnitudes) at deepfm's D = 10 (k = 2), dcn-v2's D = 16 (k = 4) and
   the narrow d = 4 (k = 1), at bulk (m = 4,089,448) and on edge rows (NaN,
   infinities, subnormals, signed zeros): payloads and rows bitwise the
   plain versions', zero rows exactly 0 out, each kernel repeating bit for
   bit, and both compression kernels also bitwise on a view of the rows 4
   bytes off 16 (each kernel launches from its ``ops`` plan:
   ``fp16_compress_plan`` stages tiles of rows in shared memory from D = 9
   on, ``topk_compress_plan`` reads rows directly for k <= 8 and stages
   them for the k passes past 8, ``topk_decompress_plan`` builds tiles,
   ``fp16_decompress_plan`` gives each thread a quad of 4 outputs, two
   where the quads pass what the SMs hold at once). ``fp16_decompress``
   also runs at DLRM's
   d = 32 and on edge payloads (half NaN payloads, +-inf, -0.0, float16
   subnormals, zero rows) at m * D = 1-17 and at D = 3, 10 and 32, with q
   2, 4, 8 and 12 bytes off 16 and the output 4, 8 and 12 bytes off 16:
   bitwise the plain version, repeating bit for bit.
   The two DLRM dot
   kernels (persistent ``cp.async`` rings feeding register tiles, 4 x 4 or
   the forward's 2 x 2 at B <= 264) run at F = 27, D = 128 at both path
   batches, at
   the bench config's D = 16, at bulk and on edge shapes (F = 2 with a B
   that is no multiple of a ring buffer's samples, odd D, D = 1, F = 1),
   and the forward at its plan's boundaries (F = 2 and 27 by D = 1, 3, 16,
   128 and 129 by B = 1, 37 and 65,537): within 1e-5 of scale, repeating
   bit for bit, the backward reached both standalone and through the
   autograd of ``ops.dot_interaction``. ``segment_grad`` and
   ``dedup_adagrad`` also run at the unpacked path's per-table shapes (n =
   256 and 512 at D = 10: ``segment_grad`` along a ps group's identity
   order and a picasso group's unique sort, ``dedup_adagrad`` into a 3-row
   and an 8,192-row table): within 1e-5 of scale, bitwise repeats, no sort;
3. serve full-width deepfm (187,780,711 x 10 table, 4,194,304-row hot tier,
   B = 512) through ``make_serve_step``: 8 warm-up requests feed the
   FCounter, ``engine.flush`` loads the tier, then 300 timed requests with
   the kernel launch counters reset just before and read just after; one
   request with the plain versions must give the same probabilities; a
   deepfm-smoke request served on the card must match the CPU;
4. train full-width deepfm on the train launcher's plan (B = 256, flush
   every 20 steps after 10) through ``make_train_step``: 30 steps from seed
   0 with the launch counters reset just before and read just after; every
   loss finite, every kernel of the path launched, no sort for
   ``segment_grad`` (``ops.sorts``; so on every training path), tier hits
   on every step after the step-20 flush; a second kernel run repeats the
   first bit for bit; the same 30 steps on the plain versions (under
   deterministic algorithms) give the same losses (rtol 1e-4 / atol 1e-5, the JAX
   package's fused-vs-plain bar) and the same hits; then per-stage host
   clock, a profiled window (each port kernel's device us a step printed,
   ``fm_interaction_bwd``'s among them; so on every training path) and
   peak memory; a deepfm-smoke training run on the card must match the
   CPU;
5. free the deepfm states and serve full-width dcn-v2 (187,767,399 x 16
   table, 13 dense features, three cross layers over the 429-wide base,
   MLP 1024-1024-512) as in phase 3: ``cross_layer`` launched 3 times per
   request, tier hits on every request, the plain path's probabilities
   within 1e-5, a dcn-v2-smoke request on the card matching the CPU;
6. train full-width dcn-v2 as in phase 4: ``cross_layer`` and
   ``cross_layer_bwd`` 3 times per step, hits after the flush, the kernel
   path repeating bit for bit, and at steps 1 and 21 one kernel step and
   one plain step from copies of the same state agreeing in loss (rtol
   1e-5) and in every dense gradient (1e-5 of the leaf's largest entry);
   the 30-step kernel vs deterministic-plain loss difference is printed, not
   held to a bar (past the flush it depends on the data, ``PERF.md`` §6);
   a dcn-v2-smoke training run on the card must match the CPU;
7. free the dcn-v2 states and serve full-width deepfm with
   ``picasso_narrow --narrow-dim 4 --l2-budget 2147483648`` (a
   187,780,711 x 4 master, a 4,194,304-row L1 and a 48,806,440-row L2 tier,
   both at D = 10) as in phase 3: per request 2 ``tier_probe``, 1
   ``gather_project``, 1 ``gather_pool`` and 1 ``fm_interaction`` launch,
   tier hits on every request, the plain path within 1e-5; then a flush
   from an FCounter that counts every row fills both tiers (the warm-up's
   ids fit in L1) and five requests take L2 hits, held against the plain
   path; a narrow deepfm-smoke request (both tiers warm) on the card
   matching the CPU;
8. train it on the train launcher's plan with the same flags as in phase
   6: per step 2 ``tier_probe``, 1 ``gather_project``, 2 ``dedup_adagrad``
   (the narrow master at d = 4 and the L2 tier at D = 10) and no
   ``gather_project_grad`` (the engine's backward folds the cotangent
   through the projection itself); the shared-state check also holds the
   trained projection to 1e-5 of its scale; after the profiled steps both
   tiers are filled as in phase 7 and steps 40-42 take L2 hits, step 40's
   flush writing the full tiers back; a narrow deepfm-smoke training run on
   the card matching the CPU;
9. train full-width deepfm as in phase 4 with ``grad_compress='fp16'``, then
   ``'topk'``: per step deepfm's launches plus 1 compress and 1 decompress
   of the mode (0 of the other pair), hits after the flush, the kernel path
   repeating bit for bit, and at steps 1 and 21 the shared-state check of
   phase 6, which also holds the step's compressed payloads and rows bitwise
   to the plain versions on the same rows and the master rows each update
   touched to the plain update within 1e-6 of scale; the 30-step kernel vs
   plain trajectory is printed, and the step times beside phase 4's;
10. free every earlier state and serve full Criteo DLRM (``paper_models.dlrm()``:
   26 fields at D = 128 in one 187,767,399-row group, a 512-256-128 bottom
   MLP whose output joins the 27-vector dots, MLP 1024-1024-512-256) under
   ``picasso_narrow`` with narrow dim 32 and a 2 GiB L2 budget (a
   187,767,399 x 32 master, 2,080,896-row L1 and 4,161,784-row L2 tiers at
   D = 128): after the warm-up a flush from a full FCounter fills both
   tiers, then 300 timed requests, each with L1 and L2 hits and per request
   2 ``tier_probe``, 1 ``gather_project``, 1 ``gather_pool`` and 1
   ``dot_interaction`` launch; the plain path within 1e-5; a
   ``dlrm(criteo=False)`` smoke request on the card matching the CPU;
11. train it as phase 8: per step those launches plus 1 ``segment_grad``, 2
   ``dedup_adagrad`` (the d = 32 master and the L2 tier at D = 128) and 1
   ``dot_interaction_bwd``; the kernel path repeating bit for bit, the
   shared-state check at steps 1 and 21, both tiers filled after step 39;
   a smoke training run on the card matching the CPU;
12. free every earlier state and serve and train full-width deepfm as the
   launchers run ``--no-packing --strategy mixed``: 39 groups, 187,780,711
   rows at D = 10, the cost model's assignment (checked equal to
   ``compile_assignment``'s) 26 ``ps`` groups (the tables of at most 8,192
   rows) and 13 ``picasso`` groups with 3,634,216 tier rows in all; as in
   phases 3-4 with 39 K-Interleaving waves: per request 13 ``tier_probe``,
   39 ``gather_pool``, 1 ``fm_interaction``; per step those plus 39
   ``segment_grad``, 39 ``dedup_adagrad``, 1 ``fm_interaction_bwd``; hits
   on every request and step after the flush, all of them the picasso
   groups' (``cache_hits/ps`` 0); no sort; the kernel path repeating bit
   for bit; the shared-state check at steps 1 and 21; the ps groups'
   budgeted tiers bitwise untouched by every flush and step; a smoke run
   (the categorical tables on picasso, ``SMOKE_MIX``) on the card matching
   the CPU; the configuration's wall time printed;
13. the same for packed full-width deepfm under ``ps``: no ``tier_probe``
   and no hit, ``segment_grad`` over B x 39 positions along the identity
   order; then, on one packed train state, ``hybrid``, ``mp_nodedup`` (on
   ``exact_capacity`` plans) and ``allgather_rows`` each serve 10 requests
   against the plain path (1e-5) and take one kernel step and one plain
   step from copies of the state (the shared-state check), each with its
   launches checked and printed;
14. the runtime at world 1. Full-width deepfm on the train launcher's plan:
   30 steps unguarded, then from the same seed 30 steps with the anomaly
   guard (the step, judged, journals the rows it writes and judges itself
   before the dense update): the state digests (an int64 sum
   on the card of every leaf's bits as int32) and losses bitwise equal, the
   guarded run's launches counted; one ``save_checkpoint`` of that whole
   state (about 9.2 GB) and one ``restore_verified`` into its tensors zeroed,
   the digest bitwise back, bytes, seconds, GB/s and the peak host RSS of
   each printed; a guarded run fed ``nan@12,nan@13`` through
   ``ChaosStream``: both steps rejected with the digest unchanged, training
   going on; ten steps and one replan with the hot envelope halved (half
   the bytes the 4,194,304-row tier holds), master rows, adagrad slots and
   FCounter exactly kept, the harvest, compile and migration seconds
   printed, then one step from a shared state on the new plan against the
   plain path at phase 6's bars. At deepfm-smoke width on the card: the
   ``Supervisor`` through ``nan@7,nan@8,crash@13,ckpt@20`` (checkpoints
   every 5 steps) ends bitwise at a clean run over the batches it kept, the
   torn checkpoint is quarantined; ``run_stream`` publishes three segments;
   ``python -m repro_torch.launch.serve --reload-dir ... --chaos torn@2``
   as a subprocess loads the newest delta, keeps it past the torn one and
   serves within 1e-5 of the trainer's state served in-process; the same
   server under ``PYTHONHASHSEED=1``, run beside it on a copy of the
   deltas, fails on the packing salts;
15. the sequence models. ``gather_pool`` and ``tier_probe`` at sasrec's
   and mind's serving (B = 512) and training (B = 256) shapes,
   ``segment_grad`` (uniform and the path's zipf batch) and
   ``dedup_adagrad`` (on the full table) at B = 256, against their plain
   versions as in phase 2: D = 50 with 101 bags a sample (the first width
   not a multiple of 4) and D = 64 with 54. Then sasrec (a 10,000,050 x 50
   table, a 1,250,008-row L1 tier) and mind (20,002,068 x 64, 2,500,264)
   each as phases 3-4 with 100 timed requests (phase 12 also times 100): served against the plain
   path (1e-5), 30 training steps with the flush at step 20, one kernel
   step held against one plain step from a shared state before step 1 and
   step 21, and their smoke configs on the card against the CPU. Each then
   retrieves the top 10 of 1,048,576 candidates for one user, chunked at
   65,536 and in one chunk, on the kernels and on the plain path: the ids
   equal, and equal to a stable sort of the scores computed straight from
   the table. Last, din, mmoe and can at ``scale=0.01`` serve one request
   and train one step, each against the plain path;
16. ``--pin-l2`` and the calibrated cost model. The bus rate from one 1 GiB
   pinned copy each way; ``tier_probe(fused=False)`` on the card refuses
   host operands. Full Criteo DLRM as phases 10-11 with
   ``TrainConfig(pin_l2=True)``: the narrow master and its accumulator and
   the L2 tier (``embedding.state.pinned_leaves``) moved to mapped pinned
   host memory before anything runs (MemAvailable and the bytes printed,
   those leaves checked pinned by the CUDA driver and every other leaf on the
   card, the peak reset), then phase 10's 300 requests and phase 11's 30
   steps: every request's probabilities, the 30 losses and the state
   digests after steps 1, 20, 21 and 30 bitwise phase 10-11's, the steady
   peak at least 20 GiB below theirs, the L2 probe, both ``dedup_adagrad``
   updates and the master's row gather (``host_rows``) launched on host
   operands (``ops.host_launches``), the plain path refusing them. On the
   trained state's host master (187,767,399 x 32) and L2 tier (4,161,784 x
   128), and on a pinned narrow deepfm L2 tier (48,806,440 x 10):
   ``tier_probe``, ``dedup_adagrad`` and ``host_rows`` bitwise the same
   kernel on device copies (whole tables by digest) and the plain versions,
   each timed beside its bus-byte bound at the measured rate.
   ``get_cost_model('force')`` on the small grid times the four kernels,
   ``'auto'`` reloads it, and ``compile_assignment(cost_model=)`` of
   full-width unpacked deepfm prints its mix beside the constant one. Then
   three launcher subprocesses run together: both launchers with
   ``--pin-l2`` at full-width narrow deepfm (25 steps past the flush; 10
   requests), the pinned bytes checked, and the train launcher with
   ``--strategy auto --calibrate auto --replan-iters 10``, which prints the
   replan's measured, predicted and correction values. Beside them, at
   smoke width: a ``pin_l2`` step refuses a state whose named leaves are on
   the card; a pinned state trains bitwise the unpinned one; a checkpoint
   saved straight after its sixth step, nothing synced in between, restores
   bitwise the synced state; it rejects a poisoned step through the
   journal's host rows and survives a replan migration with its placement
   and values kept;
17. world > 1. Full-width deepfm on 4 ranks (``dist.spawn_ranks``, one
   process each, mesh 2x2, gloo on CUDA tensors: the ranks share the one
   card, which NCCL refuses), each holding a quarter of the table. Each
   rank's rows of the master and the dense parameters are checked equal to
   the world-1 draw (digests); the ranks serve 20 requests of 512 (128 a
   rank) and train 30 steps of 256 (64 a rank), the host flushing at step
   20 after saving the pre-flush state. In this process the world-1 kernel
   path then holds them: every request's probabilities within 1e-5; one
   step from the shared state before step 1 and, after loading the saved
   state and flushing it at world 1, after the flush: the loss to rtol
   1e-5, each dense gradient within 1e-5 of its largest entry, the rows
   every rank touched within 1e-6 of their scale; the flushed keys and the
   FCounter bitwise world 1's where no bucket overflowed (the overflow is
   printed), the 4 ranks' tiers bitwise alike. Each rank launches
   ``tier_probe``, ``gather_pool``, ``fm_interaction`` a request and those
   and ``segment_grad``, ``dedup_adagrad`` and ``fm_interaction_bwd`` a
   step, and its ``dedup_adagrad`` receives rows other ranks routed to it;
   then one step each under ``--grad-compress fp16`` and ``topk`` (one
   compress and one decompress launch) and one under ``picasso_narrow``
   with the largest L2 tier whose hit grads take the dense psum (both tiers
   hit). Request and step p50/p99 and the bytes each collective moves a
   step are printed as 4 ranks time-sharing one card over gloo, beside the
   card's name and power limit: not NCCL numbers;
18. the fault-tolerant loop past world 1, on phase 17's 4 ranks, plan and
   batches: a clean unguarded run of 30 steps, then from the same draw 30
   steps under the ``Supervisor`` (checkpoints every 10 steps, written by
   the 4 ranks together on a background thread, about 9.2 GB each), the
   guard and chaos ``nan@12,nan@13,ckpt@20,crash@24``: both poisoned steps
   rejected on every rank, the step-20 checkpoint torn once every rank's
   save of it is in and quarantined once, the crash rolling every rank back
   to step 10 and the run replaying to step 30, each rank's state digest
   bitwise the clean run's, each rank's launches of the six kernels
   counted (each once a step); the step-30 checkpoint's files, read back
   leaf by leaf, bitwise the ranks' live leaves; a fresh spawn of 4 ranks
   resuming from the directory at step 30 with the same digests. Checkpoint
   GB/s each way, host RSS peaks per rank, the seconds from the crash to
   the first replayed step and the guarded step's p50 against the
   unguarded one are printed as 4 ranks time-sharing one card over gloo,
   beside the card's name and power limit. The checkpoint directory (up to
   three checkpoints, the quarantined one included) is removed after;
19. the elastic reshard past world 1, on phase 17's plan and batches with
   ``exact_capacity`` buckets at every world (``reshard_plan(...,
   exact_capacity=True)``): 10 steps at world 4 (mesh 2x2) under the
   ``Supervisor`` (its checkpoint at step 10), a live reshard to world 2
   (mesh 2x1; ranks 2 and 3 leave and wait), 10 steps there (the host
   flush at step 20 after a pre-flush checkpoint), a live reshard back to
   world 4 with ranks 2 and 3 joining as spares, and 5 steps. Across each
   reshard the ranks' digests of every logical row of ``w``/``acc``/
   ``counts`` (position-weighted) and of every replicated leaf are equal,
   the replicas bitwise alike; no bucket overflows at world 2 and each
   rank launches the six kernels once a step there. In this process the
   step-10 world-4 checkpoint restored at world 1 (``restore_elastic``)
   has the world-4 digests, its sentinels remapped (counted); step 11 from
   it, and step 21 from the step-20 world-2 checkpoint restored and
   flushed at world 1 (keys and FCounter bitwise), meet phase 17's bars
   against the world-2 ranks' steps; a fresh 2-rank spawn restores the
   step-10 checkpoint at world 2 with the same digests. Bytes and seconds
   of each reshard, host RSS peaks, step p50 at each world and the restore
   GB/s are printed as 4 or 2 ranks time-sharing one card over gloo, beside
   the card's name and power limit. The checkpoints are removed after.

Prints, before the last line, the card's name and power limit and one JSON
object of per-kernel numbers; the last line is the JSON device stamp.
Needs one CUDA card and nvcc; it fails without either. It re-runs itself
under ``PYTHONHASHSEED=0``: the packing salt hashes table names, so a fixed
seed makes the served rows, and so the probabilities, repeat run to run.
"""
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Dict, NamedTuple, Tuple

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config, get_shapes  # noqa: E402
from repro_torch.configs.paper_models import PAPER_MODELS, dlrm  # noqa: E402
from repro_torch.core import packed_embedding as pe  # noqa: E402
from repro_torch.core.features import pack_group, table_salts  # noqa: E402
from repro_torch.core.packing import make_plan  # noqa: E402
from repro_torch.data.pipeline import ReplayableStream  # noqa: E402
from repro_torch.data.synthetic import batch_stream, make_batch  # noqa: E402
from repro_torch.embedding.state import pin_to_host, pinned_leaves  # noqa: E402
from repro_torch.engine import (compile_assignment, maybe_compile,  # noqa: E402
                                resolve_assignment)
from repro_torch.kernels import build, host_memory, ops, ref  # noqa: E402
from repro_torch.models.wdl import WDLModel  # noqa: E402
from repro_torch.optim import grad_compression as gcomp  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402
from repro_torch.runtime import (AnomalyGuard, ChaosController, ChaosStream,  # noqa: E402
                                 FaultPlan, PublishPoller, Replanner, apply_plan_meta,
                                 parse_fault_plan, plan_meta, publish_state, run_stream)
from repro_torch.runtime.chaos import tear_published  # noqa: E402
from repro_torch.serve.serve_step import (ServeConfig, init_state,  # noqa: E402
                                          make_retrieval_step, make_serve_step)
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402
from repro_torch.train.fault_tolerance import Supervisor  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12     # H100 SXM dense TF32 on the tensor cores
TOL = 1e-5
SEED = 0
SPIN_CYCLES = 2_000_000  # ~1 ms at H100 clocks: longer than any timed call's enqueue
# the registry's serve_p99 request (B = 512); the bulk shape is 128x that
SERVE_B = next(s["batch"] for s in get_shapes("deepfm") if s.name == "serve_p99")
# the train launcher's default --global-batch and its full-width plan
TRAIN_B, TRAIN_STEPS, FLUSH_ITERS, WARMUP_ITERS = 256, 30, 20, 10
BULK_B = 65_536
LR, EPS = 0.05, 1e-8  # TrainConfig's lr_emb and eps
N_TIMED = 300  # timed requests: enough that p99 is not the maximum
CROSS_D = 26 * 16 + 13  # dcn-v2's base: 26 fields at dim 16 + 13 dense features
DEV = torch.device("cuda", 0)


class Arch(NamedTuple):
    """A full-width configuration: its registry config, packed table and
    tiers, strategy, the kernel launches of its two paths, and how its
    30-step training run is held against the plain path."""

    name: str
    config: str                     # the registry config it runs ('dlrm': paper_models)
    n_fields: int
    dim: int
    rows: int
    hot_rows: int
    serve_launches: Dict[str, int]  # per request; every other kernel 0
    train_launches: Dict[str, int]  # per step; every other kernel 0
    trajectory_bar: bool            # hold the 30 losses to rtol 1e-4 / atol 1e-5
    shared_state_at: Tuple[int, ...]  # steps preceded by the shared-state check
    strategy: str = "picasso"
    narrow_dim: int = 0             # the launchers' --narrow-dim (0: none)
    l2_bytes: int = 0               # the launchers' --l2-budget
    l2_rows: int = 0                # the L2 tier that budget plans
    grad_compress: str = "none"     # the train launcher's --grad-compress
    full_tiers_first: bool = False  # serve the timed requests from full tiers
    packing: bool = True            # False: the launchers' --no-packing
    mix: Tuple[Tuple[str, int], ...] = ()  # the assignment's groups a strategy
    exact_capacity: bool = False    # lossless buckets (mp_nodedup's parity plans)
    n_requests: int = N_TIMED       # timed full-width requests

    @property
    def master_dim(self) -> int:
        return self.narrow_dim or self.dim


_EMB = {"tier_probe": 1, "gather_pool": 1}
ARCHS = {
    "deepfm": Arch("deepfm", "deepfm", 39, 10, 187_780_711, 4_194_304,
                   {**_EMB, "fm_interaction": 1},
                   {**_EMB, "fm_interaction": 1, "segment_grad": 1, "dedup_adagrad": 1,
                    "fm_interaction_bwd": 1}, True, ()),
    # three cross layers: three forward and three backward launches
    "dcn-v2": Arch("dcn-v2", "dcn-v2", 26, 16, 187_767_399, 4_194_304,
                   {**_EMB, "cross_layer": 3},
                   {**_EMB, "cross_layer": 3, "segment_grad": 1, "dedup_adagrad": 1,
                    "cross_layer_bwd": 3}, False, (1, FLUSH_ITERS + 1)),
    # README's frequency-adaptive command at full width: two tier probes (L1,
    # then L2 for the L1 misses), the narrow stitch, and dedup_adagrad on the
    # narrow master and on the L2 tier; the engine's backward folds the wide
    # cotangent through proj^T itself, so gather_project_grad is not launched
    "deepfm-narrow": Arch(
        "deepfm-narrow", "deepfm", 39, 10, 187_780_711, 4_194_304,
        {"tier_probe": 2, "gather_project": 1, "gather_pool": 1, "fm_interaction": 1},
        {"tier_probe": 2, "gather_project": 1, "gather_pool": 1, "fm_interaction": 1,
         "segment_grad": 1, "dedup_adagrad": 2, "fm_interaction_bwd": 1}, False,
        (1, FLUSH_ITERS + 1), "picasso_narrow", 4, 2_147_483_648, 48_806_440),
}
# the train launcher's --grad-compress on full-width deepfm: under 'psum' the
# miss grads' routed hop compresses and decompresses once a step; the plain
# trajectory is printed, not held (a compressed coordinate can flip on a
# last-bit difference of its row)
COMPRESSED = ("deepfm-fp16", "deepfm-topk")
ARCHS.update({name: ARCHS["deepfm"]._replace(
    name=name, trajectory_bar=False, shared_state_at=(1, FLUSH_ITERS + 1),
    train_launches={**ARCHS["deepfm"].train_launches, f"{mode}_compress": 1,
                    f"{mode}_decompress": 1}, grad_compress=mode)
    for name, mode in zip(COMPRESSED, ("fp16", "topk"))})
# full Criteo DLRM (configs/paper_models.dlrm(): 26 fields at D = 128, a
# 512-256-128 bottom MLP whose output joins the 27-vector dots, MLP
# 1024-1024-512-256) under the reference's frequency-adaptive configuration:
# a 96.1 GB wide master does not fit one card, a narrow d = 32 master does
# (24.0 GB), beside the 1 GiB L1 and 2 GiB L2 tiers at D = 128. Phase 10
# serves its timed requests from both tiers filled; phase 11 trains as phase 8
ARCHS["dlrm-narrow"] = Arch(
    "dlrm-narrow", "dlrm", 26, 128, 187_767_399, 2_080_896,
    {"tier_probe": 2, "gather_project": 1, "gather_pool": 1, "dot_interaction": 1},
    {"tier_probe": 2, "gather_project": 1, "gather_pool": 1, "dot_interaction": 1,
     "segment_grad": 1, "dedup_adagrad": 2, "dot_interaction_bwd": 1}, False,
    (1, FLUSH_ITERS + 1), "picasso_narrow", 32, 2_147_483_648, 4_161_784,
    full_tiers_first=True)
# full-width deepfm with --no-packing --strategy mixed: one group a table,
# the cost model puts the 26 tables of at most 8,192 rows on ps and the 13
# big ones on picasso, each with its own hot tier (3,634,216 rows in all). A
# request probes the 13 picasso tiers and pools every group; a step adds a
# segment_grad and a dedup_adagrad a group (owner side for picasso,
# replicated for ps). Phase 12
_MIXED_SERVE = {"tier_probe": 13, "gather_pool": 39, "fm_interaction": 1}
ARCHS["deepfm-mixed"] = Arch(
    "deepfm-mixed", "deepfm", 39, 10, 187_780_711, 3_634_216, _MIXED_SERVE,
    {**_MIXED_SERVE, "segment_grad": 39, "dedup_adagrad": 39, "fm_interaction_bwd": 1},
    False, (1, FLUSH_ITERS + 1), "mixed", packing=False, mix=(("picasso", 13), ("ps", 26)),
    n_requests=100)  # 39 groups make a request ~50 ms: 100 timed keep the phase short
# packed full-width deepfm under --strategy ps: no tier probe (the planned
# tier stays inert), segment_grad along the identity order over B x 39
# positions, dedup_adagrad on the replicated grads. Phase 13, which also
# drives BASELINES on one packed state
_PS_SERVE = {"gather_pool": 1, "fm_interaction": 1}
ARCHS["deepfm-ps"] = Arch(
    "deepfm-ps", "deepfm", 39, 10, 187_780_711, 4_194_304, _PS_SERVE,
    {**_PS_SERVE, "segment_grad": 1, "dedup_adagrad": 1, "fm_interaction_bwd": 1},
    False, (1, FLUSH_ITERS + 1), "ps")
BASELINES = ("hybrid", "mp_nodedup", "allgather_rows")  # same launches as deepfm-ps
# the sequence models at full width (phase 15): one packed group each, a
# bag per history position, position and target (sasrec: 101 at D = 50, the
# first path width not a multiple of 4; mind: 50 history items, the target
# and three profile fields, 54 at D = 64), probed and pooled once a request
# and a step, with one segment_grad and one dedup_adagrad a step. Each is
# held one step from a shared state before step 1 and after the flush, as
# every path since dcn-v2 is; the 30-step loss difference is printed
_SEQ_TRAIN = {**_EMB, "segment_grad": 1, "dedup_adagrad": 1}
ARCHS["sasrec"] = Arch("sasrec", "sasrec", 101, 50, 10_000_050, 1_250_008, _EMB,
                       _SEQ_TRAIN, False, (1, FLUSH_ITERS + 1), n_requests=100)
ARCHS["mind"] = Arch("mind", "mind", 54, 64, 20_002_068, 2_500_264, _EMB, _SEQ_TRAIN,
                     False, (1, FLUSH_ITERS + 1), n_requests=100)
SEQ_PATHS = ("sasrec", "mind")
# two-tower retrieval: the top 10 of 2^20 candidates, chunked and in one go,
# each way timed over 50 calls after one warm-up (about 2 s a way)
RETRIEVAL_N, RETRIEVAL_CHUNK, RETRIEVAL_K = 1 << 20, 65_536, 10
RETRIEVAL_CALLS = 50
# the paper's other configs, at the reference's bench scale
PAPER_SMOKE = ("din", "mmoe", "can")
MAIN = ("deepfm", "dcn-v2", "deepfm-narrow")  # phases 3-8; dlrm-narrow is 10-11
MIXED_PATHS = ("deepfm-mixed", "deepfm-ps")   # phases 12-13
# every deepfm-smoke table fits the ps gate, so the smoke of a mixed path
# puts the categorical tables on picasso and mixes as the full width does
SMOKE_MIX = {"cat_*": "picasso"}
SMOKE_L2_BYTES = 1 << 16  # tests/test_narrow.py's L2 budget at smoke size
SMOKE_NARROW_DIM = 4      # tests/test_narrow.py's, and the bench's D // 4 for dlrm

SOURCES = {
    "tier_probe": ("src/repro_torch/kernels/csrc/tier_probe.cu",
                   "src/repro/kernels/fused_embedding.py:279"),
    "gather_pool": ("src/repro_torch/kernels/csrc/gather_pool.cu",
                    "src/repro/kernels/fused_embedding.py:81"),
    "fm_interaction": ("src/repro_torch/kernels/csrc/fm_interaction.cu",
                       "src/repro/kernels/fm_interaction.py:24"),
    "segment_grad": ("src/repro_torch/kernels/csrc/segment_grad.cu",
                     "src/repro/kernels/fused_embedding.py:111"),
    "dedup_adagrad": ("src/repro_torch/kernels/csrc/dedup_adagrad.cu",
                      "src/repro/kernels/fused_embedding.py:194"),
    "fm_interaction_bwd": ("src/repro_torch/kernels/csrc/fm_interaction_bwd.cu",
                           "src/repro/kernels/interaction_bwd.py:43"),
    "cross_layer": ("src/repro_torch/kernels/csrc/cross_layer.cu",
                    "src/repro/kernels/cross_layer.py:30"),
    "cross_layer_bwd": ("src/repro_torch/kernels/csrc/cross_layer_bwd.cu",
                        "src/repro/kernels/interaction_bwd.py:147"),
    "gather_project": ("src/repro_torch/kernels/csrc/gather_project.cu",
                       "src/repro/kernels/fused_embedding.py:351"),
    "gather_project_grad": ("src/repro_torch/kernels/csrc/gather_project_grad.cu",
                            "src/repro/kernels/fused_embedding.py:412"),
    "fp16_compress": ("src/repro_torch/kernels/csrc/fp16_compress.cu",
                      "src/repro/kernels/grad_compress.py:39"),
    "fp16_decompress": ("src/repro_torch/kernels/csrc/fp16_decompress.cu",
                        "src/repro/kernels/grad_compress.py:65"),
    "topk_compress": ("src/repro_torch/kernels/csrc/topk_compress.cu",
                      "src/repro/kernels/grad_compress.py:108"),
    "topk_decompress": ("src/repro_torch/kernels/csrc/topk_decompress.cu",
                        "src/repro/kernels/grad_compress.py:143"),
    "dot_interaction": ("src/repro_torch/kernels/csrc/dot_interaction.cu",
                        "src/repro/kernels/dot_interaction.py:37"),
    "dot_interaction_bwd": ("src/repro_torch/kernels/csrc/dot_interaction_bwd.cu",
                            "src/repro/kernels/interaction_bwd.py:89"),
    # no TPU kernel: the reference gathers its pinned-host narrow master with
    # jnp.take (an XLA gather, no pallas_call); this kernel does that and the
    # flush's scatters for a host-resident table (phase 16)
    "host_rows": ("src/repro_torch/kernels/csrc/host_rows.cu",
                  "src/repro/core/packed_embedding.py:319"),
}
# the arch whose serving or training path each kernel was ported for
PORTED_FOR = {"tier_probe": ("deepfm", "serve"), "gather_pool": ("deepfm", "serve"),
              "fm_interaction": ("deepfm", "serve"), "segment_grad": ("deepfm", "train"),
              "dedup_adagrad": ("deepfm", "train"),
              "fm_interaction_bwd": ("deepfm", "train"),
              "cross_layer": ("dcn-v2", "serve"), "cross_layer_bwd": ("dcn-v2", "train"),
              "gather_project": ("deepfm-narrow", "serve"),
              "gather_project_grad": ("deepfm-narrow", "train"),
              "fp16_compress": ("deepfm-fp16", "train"),
              "fp16_decompress": ("deepfm-fp16", "train"),
              "topk_compress": ("deepfm-topk", "train"),
              "topk_decompress": ("deepfm-topk", "train"),
              "dot_interaction": ("dlrm-narrow", "serve"),
              "dot_interaction_bwd": ("dlrm-narrow", "train")}


def check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, iters: int = 30, warmup: int = 5, device_only: bool = True) -> float:
    """Median per-call time of ``fn`` over ``iters`` calls (CUDA events).

    ``device_only``: a ~1 ms device spin is queued before each start event,
    so the host has enqueued ``fn``'s launches before the card reaches them
    and the events bracket device time alone. Without it the events also
    take in the host's Python and launch overhead between them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(DEV)
    events = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize(DEV)
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def bound(nbytes: float, nops: float, ops_per_s: float = FP32_OPS_PER_S,
          ops_name: str = "operations"):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else ops_name)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def scale_of(x: torch.Tensor) -> float:
    return max(float(x.abs().max()), 1.0) if x.numel() else 1.0


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit: -0.0 apart from 0.0, any NaN equal to any NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    bits = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return (torch.equal(nan_a, nan_b)
            and torch.equal(a[~nan_a].view(bits), b[~nan_b].view(bits)))


def arch_plan(a: Arch, b: int, *, smoke: bool = False, train: bool = False):
    """``(cfg, plan)`` of ``a`` at batch ``b`` as its launcher builds it, the
    strategy recorded before any state is sized: serving takes the default
    hot budget, training the train launcher's (``hot_bytes=1<<30``, a flush
    every 20 steps after 10). At smoke size training flushes at step 3 after
    2 with a 1<<14-byte tier, and the L2 configuration also serves with that
    tier and a 1<<16-byte L2 (narrow dim 4), so both tiers take hits. The
    smoke DLRM is ``dlrm(criteo=False)`` (26 fields at D = 16). A mixed
    arch is planned with ``--no-packing`` and its assignment compiled as
    the launchers compile it (``SMOKE_MIX`` at smoke size)."""
    cfg = (dlrm(criteo=not smoke) if a.config == "dlrm"
           else get_config(a.config, smoke=smoke))
    kw = {}
    if train:
        kw = (dict(hot_bytes=1 << 14, flush_iters=3, warmup_iters=2) if smoke else
              dict(hot_bytes=1 << 30, flush_iters=FLUSH_ITERS, warmup_iters=WARMUP_ITERS))
    if a.l2_bytes:
        kw.update(l2_bytes=SMOKE_L2_BYTES if smoke else a.l2_bytes,
                  narrow_dim=(SMOKE_NARROW_DIM if smoke else a.narrow_dim) or None)
        if smoke:
            kw["hot_bytes"] = 1 << 14
    plan = make_plan(cfg, world=1, per_device_batch=b, enable_packing=a.packing,
                     exact_capacity=a.exact_capacity, **kw)
    # as the launchers: a mix is compiled for the step's id volume (training:
    # the micro-batch; serving: the batch) and recorded before any state
    maybe_compile(plan, a.strategy, per_device_batch=None if train else b,
                  overrides=SMOKE_MIX if smoke and a.mix else None)
    resolve_assignment(plan, a.strategy)
    return cfg, plan


# ------------------------------------------------------------------ phase 2


def probe_case(b: int, gen: torch.Generator, a: Arch, h: int):
    """Sorted unique queries of a B-sample request, about half of them tier
    keys, against a full ``h``-key tier over the full table's rows."""
    n = b * a.n_fields
    stride = a.rows // h
    keys = (torch.arange(h, device=DEV, dtype=torch.int64) * stride
            + torch.randint(0, stride, (h,), device=DEV, generator=gen)).to(torch.int32)
    rows = torch.randn((h, a.dim), device=DEV, generator=gen)
    half = n // 2
    ids = torch.cat([keys[torch.randint(0, h, (half,), device=DEV, generator=gen)],
                     torch.randint(0, a.rows, (n - half,), device=DEV, generator=gen,
                                   dtype=torch.int32)])
    u = pe.fixed_unique(ids.to(torch.int32), sentinel=a.rows)
    return u.uniq, u.uvalid, keys, rows


def run_tier_probe(b: int, gen: torch.Generator, a: Arch, l2: bool = False) -> dict:
    """The L1 probe, or with ``l2`` the probe of the arch's L2 tier."""
    uniq, uvalid, keys, rows = probe_case(b, gen, a, a.l2_rows if l2 else a.hot_rows)
    hit, slot, out = ops.tier_probe(uniq, uvalid, keys, rows)
    again = ops.tier_probe(uniq, uvalid, keys, rows)
    rhit, rslot, rout = ref.tier_probe_ref(uniq, uvalid, keys, rows)
    torch.cuda.synchronize(DEV)
    check(torch.equal(hit, rhit) and torch.equal(slot, rslot), "tier_probe hit/slot bitwise")
    err = max_err(out, rout)
    check(same_bits(out, rout), f"tier_probe rows bitwise the plain version's (err {err})")
    check(bool((out[~hit] == 0).all()), "tier_probe miss rows exactly 0")
    check(all(same_bits(x, y) for x, y in zip((hit, slot, out), again)),
          "tier_probe repeats bit for bit")
    n, h = uniq.shape[0], keys.shape[0]
    n_hit = int(hit.sum())
    check(n_hit > 0 and n_hit < n, "tier_probe case has hits and misses")
    # the sorted queries share the top of the search tree: past its first
    # log2(n) levels each query walks its own log2(H/n) keys, so the keys
    # the n searches must touch are about n * (log2(H/n) + 2), each read once.
    # The compares are integer work, outside the float32 peak: no ops term.
    keys_read = min(h, n * (math.ceil(math.log2(h / n)) + 2))
    nbytes = n * (4 + 1) + keys_read * 4 + n_hit * a.dim * 4 + n * (1 + 4 + a.dim * 4)
    b_ms, b_by = bound(nbytes, 0)

    def lib():  # searchsorted, then the masked row gather: a chain
        slot = torch.searchsorted(keys, uniq).clamp_(max=h - 1)
        found = (keys[slot] == uniq) & uvalid
        return found, slot, rows[slot].masked_fill_(~found[:, None], 0.0)

    lhit, lslot, lout = lib()
    check(torch.equal(lhit, rhit) and torch.equal(lout, rout),
          "searchsorted + gather yardstick agrees")
    return {"n": n, "d": a.dim, "tier_keys": h, "hits": n_hit,
            "lanes": ops.tier_probe_plan(n, ops.sm_count(DEV)), "max_abs_err": err,
            "ms": cuda_ms(lambda: ops.tier_probe(uniq, uvalid, keys, rows)),
            "call_ms": cuda_ms(lambda: ops.tier_probe(uniq, uvalid, keys, rows),
                               device_only=False),
            "plain_ms": cuda_ms(lambda: ref.tier_probe_ref(uniq, uvalid, keys, rows)),
            "library_ms": cuda_ms(lib), "library_call": "searchsorted, then masked gather",
            "bound_ms": b_ms, "bound_by": b_by}


# query counts that take 32, 4 and 2 lanes a query and the ranged search,
# none a multiple of a 256-thread block
PROBE_EDGE_N = (1_037, 40_000, 70_001, 150_001)
PROBE_EDGES = ("H=1", "all hits", "all misses", "above every key", "sentinel tail",
               "unsorted")
PROBE_SENTINEL = 1 << 26  # above every key; the flush pads a tier with such


def probe_edge_case(kind: str, n: int, gen: torch.Generator, d: int = 10):
    """``n`` queries of one edge case against a tier of 50,000 keys (one
    for 'H=1'), multiples of 8, ``d`` wide; a tenth of them not valid."""
    h = 1 if kind == "H=1" else 50_000
    keys = (torch.sort(torch.randperm(1 << 22, device=DEV, generator=gen)[:h]).values
            * 8).to(torch.int32)
    if kind == "sentinel tail":
        keys[-(h // 4):] = PROBE_SENTINEL
    rows = torch.randn((h, d), device=DEV, generator=gen)
    pick = keys[torch.randint(0, h, (n,), device=DEV, generator=gen)]
    spread = torch.randint(-1_000, 1_000, (n,), device=DEV, generator=gen, dtype=torch.int32)
    q = {"H=1": pick + spread // 100, "all hits": pick, "all misses": pick + 1,
         "above every key": torch.where(spread > 900, torch.full_like(pick, 2**31 - 1),
                                        keys[-1] + 1 + spread.abs()),
         "sentinel tail": torch.where(spread > 0, pick, torch.full_like(pick, PROBE_SENTINEL)),
         "unsorted": torch.where(spread > 0, pick, pick + spread)}[kind]
    if kind != "unsorted":
        q = torch.sort(q).values
    uvalid = torch.rand((n,), device=DEV, generator=gen) < 0.9
    return q.to(torch.int32).contiguous(), uvalid, keys, rows


def run_probe_edges(gen: torch.Generator) -> dict:
    """Each edge case at each of PROBE_EDGE_N: hit, slot and rows bitwise the
    plain version's (a miss row exactly 0) and a second call bitwise the
    first. Returns the lanes each n took."""
    for kind in PROBE_EDGES:
        for n in PROBE_EDGE_N:
            args = probe_edge_case(kind, n, gen)
            got, again = ops.tier_probe(*args), ops.tier_probe(*args)
            exp = ref.tier_probe_ref(*args)
            torch.cuda.synchronize(DEV)
            check(all(same_bits(x, y) for x, y in zip(got, exp)),
                  f"tier_probe {kind} n={n}: hit, slot and rows bitwise the plain version's")
            check(all(same_bits(x, y) for x, y in zip(got, again)),
                  f"tier_probe {kind} n={n} repeats")
    return {"cases": list(PROBE_EDGES),
            "lanes": {n: ops.tier_probe_plan(n, ops.sm_count(DEV)) for n in PROBE_EDGE_N}}


def pool_case(b: int, gen: torch.Generator, a: Arch):
    """``(rows_u, inv, w, seg, n)`` of a B-sample batch in the packed layout
    of every path: one bag per (sample, field), seg = arange."""
    n = b * a.n_fields
    ids = torch.randint(0, max(n // 2, 1), (n,), device=DEV, generator=gen, dtype=torch.int32)
    inv = pe.fixed_unique(ids, sentinel=n).inv
    rows_u = torch.randn((n, a.dim), device=DEV, generator=gen)
    w = torch.rand((n,), device=DEV, generator=gen) + 0.5
    return rows_u, inv, w, torch.arange(n, device=DEV, dtype=torch.int32), n


def pool_bound(rows_u, inv, n: int, n_bags: int):
    """Each distinct row read once, inv, w and seg once, the bags written
    once; two flops an element."""
    d = rows_u.shape[1]
    n_ref = int(torch.unique(inv).numel())
    return bound(n_ref * d * 4 + n * 12 + n_bags * d * 4, 2 * n * d)


def run_gather_pool(b: int, gen: torch.Generator, a: Arch) -> dict:
    rows_u, inv, w, seg, n = pool_case(b, gen, a)
    out = ops.gather_pool(rows_u, inv, w, seg, n)
    rout = ref.gather_pool_ref(rows_u, inv, w, seg, n)
    # an uncovered bag: bag 3's positions move to bag 2
    seg_e = torch.where(seg == 3, torch.full_like(seg, 2), seg)
    out_e = ops.gather_pool(rows_u, inv, w, seg_e, n)
    rout_e = ref.gather_pool_ref(rows_u, inv, w, seg_e, n)
    torch.cuda.synchronize(DEV)
    err = max(max_err(out, rout), max_err(out_e, rout_e))
    check(err <= TOL * scale_of(rout), f"gather_pool err {err}")
    check(bool((out_e[3] == 0).all()), "gather_pool empty bag exactly 0")
    # five trailing bags that no position maps to
    out_t = ops.gather_pool(rows_u, inv, w, seg, n + 5)
    check(torch.equal(out_t[:n], out) and bool((out_t[n:] == 0).all()),
          "gather_pool trailing empty bags exactly 0")
    offsets = torch.searchsorted(seg, torch.arange(n, device=DEV, dtype=torch.int32))
    inv64 = inv.long()
    lib = F.embedding_bag(inv64, rows_u, offsets, mode="sum", per_sample_weights=w)
    check(max_err(lib, rout) <= TOL * scale_of(rout), "embedding_bag yardstick agrees")
    b_ms, b_by = pool_bound(rows_u, inv, n, n)
    return {"n": n, "d": a.dim, "max_abs_err": err,
            "ms": cuda_ms(lambda: ops.gather_pool(rows_u, inv, w, seg, n)),
            "call_ms": cuda_ms(lambda: ops.gather_pool(rows_u, inv, w, seg, n),
                               device_only=False),
            "plain_ms": cuda_ms(lambda: ref.gather_pool_ref(rows_u, inv, w, seg, n)),
            "library_ms": cuda_ms(lambda: F.embedding_bag(
                inv64, rows_u, offsets, mode="sum", per_sample_weights=w)),
            "bound_ms": b_ms, "bound_by": b_by}


# multi-position layouts of the pool: runs of 1-200 positions with empty
# bags among them and at the tail, a 1,000-position run across tiles, a seg
# past n_bags (dropped), a single position
POOL_LAYOUTS = ("runs 1-200", "tile-crossing run", "seg past n_bags", "n=1")
POOL_EDGE_D = (1, 3, 10, 128, 129, 1024)


def pool_layout(kind: str, gen: torch.Generator, d: int):
    """``(rows_u, inv, w, seg, n_bags)`` of one pool layout at width ``d``,
    with ``seg`` sorted."""
    if kind == "runs 1-200":
        runs = torch.randint(1, 201, (60,), device=DEV, generator=gen)
        bags = torch.arange(60, device=DEV) * 7 // 6  # every seventh bag empty
        seg = torch.repeat_interleave(bags, runs).to(torch.int32)
        n_bags = int(bags[-1]) + 6  # and five empty at the tail
    elif kind == "tile-crossing run":
        seg = torch.arange(3_000, device=DEV, dtype=torch.int32)
        seg[1_100:2_100] = 1_100
        n_bags = 3_000
    elif kind == "seg past n_bags":
        seg = torch.arange(2_000, device=DEV, dtype=torch.int32)
        seg[1_990:] = 2_500
        n_bags = 1_995
    else:
        seg, n_bags = torch.ones((1,), device=DEV, dtype=torch.int32), 3
    n = seg.shape[0]
    rows_u = torch.randn((n, d), device=DEV, generator=gen)
    inv = torch.randint(0, n, (n,), device=DEV, generator=gen, dtype=torch.int32)
    w = torch.rand((n,), device=DEV, generator=gen) + 0.5
    return rows_u, inv, w, seg, n_bags


def pool_plain(rows_u, inv, w, seg, n_bags: int):
    """The plain version on the positions whose bag exists (it takes no
    seg outside [0, n_bags); the kernel drops those positions)."""
    keep = (seg >= 0) & (seg < n_bags)
    return ref.gather_pool_ref(rows_u, inv[keep], w[keep], seg[keep], n_bags)


def run_pool_edges(gen: torch.Generator) -> dict:
    """Every layout at each of POOL_EDGE_D, and seg = arange at the widths
    past the paths': within 1e-5 of scale of the plain version, uncovered
    bags exactly 0, a second call bitwise the first."""
    out = {}
    cases = [(k, d) for k in POOL_LAYOUTS for d in POOL_EDGE_D]
    for kind, d in cases + [("arange", d) for d in (1, 3, 129, 1024)]:
        if kind == "arange":
            n = 4_099
            rows_u = torch.randn((n, d), device=DEV, generator=gen)
            inv = torch.randint(0, n, (n,), device=DEV, generator=gen, dtype=torch.int32)
            w = torch.rand((n,), device=DEV, generator=gen) + 0.5
            seg, n_bags = torch.arange(n, device=DEV, dtype=torch.int32), n
        else:
            rows_u, inv, w, seg, n_bags = pool_layout(kind, gen, d)
        got, again = (ops.gather_pool(rows_u, inv, w, seg, n_bags) for _ in range(2))
        exp = pool_plain(rows_u, inv, w, seg, n_bags)
        torch.cuda.synchronize(DEV)
        err = max_err(got, exp) / scale_of(exp)
        covered = torch.zeros((n_bags,), dtype=torch.bool, device=DEV)
        covered[seg[(seg >= 0) & (seg < n_bags)].long()] = True
        check(err <= TOL, f"gather_pool {kind} D={d}: err of scale {err}")
        check(bool((got[~covered] == 0).all()), f"gather_pool {kind} D={d}: empty bags 0")
        check(same_bits(got, again), f"gather_pool {kind} D={d} repeats")
        out[f"{kind} D={d}"] = err
    return out


def run_fm(b: int, gen: torch.Generator, a: Arch) -> dict:
    x = torch.randn((b, a.n_fields, a.dim), device=DEV, generator=gen) * 0.3
    out, again = ops.fm_interaction(x), ops.fm_interaction(x)
    rout = ref.fm_interaction_ref(x)
    torch.cuda.synchronize(DEV)
    err = max_err(out, rout)
    check(err <= TOL * scale_of(rout), f"fm_interaction err {err}")
    check(same_bits(out, again), f"fm_interaction repeats bit for bit at B={b}")
    check(max_err(fm_chain(x), rout) <= TOL * scale_of(rout), "FM chain yardstick agrees")
    b_ms, b_by = bound(x.numel() * 4 + b * 4, b * a.dim * (3 * a.n_fields + 3))
    return {"n": b, "plan": list(ops.fm_plan(b, a.n_fields, a.dim, ops.sm_count(DEV))),
            "max_abs_err": err,
            "ms": cuda_ms(lambda: ops.fm_interaction(x)),
            "call_ms": cuda_ms(lambda: ops.fm_interaction(x), device_only=False),
            "plain_ms": cuda_ms(lambda: ref.fm_interaction_ref(x)),
            "library_ms": cuda_ms(lambda: fm_chain(x)),
            "library_call": "sum, square, subtract, sum (a chain)",
            "bound_ms": b_ms, "bound_by": b_by}


def fm_chain(x: torch.Tensor) -> torch.Tensor:
    """FM's second order as a PyTorch user writes it: its yardstick."""
    return 0.5 * (x.sum(dim=1).square() - x.square().sum(dim=1)).sum(dim=-1, keepdim=True)


def segment_case(b: int, gen: torch.Generator, a: Arch, zipf: bool = False):
    """The packed layout (one bag per (sample, field), seg = arange), its
    bag gradients and the fixed unique of its ids: uniform ids in
    [0, n/2) (runs of about 2), or with ``zipf`` a training batch of the
    arch's own data (zipf a = 1.2) packed as the path packs it (runs of up
    to 200 positions at B = 256, 52,393 at bulk). Returns ``(g_bags, seg,
    w, u)``."""
    n = b * a.n_fields
    if zipf:
        cfg, plan = arch_plan(a, b, train=True)
        batch = make_batch(cfg, b, np.random.default_rng(SEED))
        ids = pack_group(plan.groups[0], batch["fields"], DEV).ids
        sentinel = plan.groups[0].rows
    else:
        ids = torch.randint(0, max(n // 2, 1), (n,), device=DEV, generator=gen,
                            dtype=torch.int32)
        sentinel = n
    u = pe.fixed_unique(ids, sentinel=sentinel)
    g_bags = torch.randn((n, a.dim), device=DEV, generator=gen)
    w = torch.rand((n,), device=DEV, generator=gen) + 0.5
    return g_bags, torch.arange(n, device=DEV, dtype=torch.int32), w, u


def run_segment_grad(b: int, gen: torch.Generator, a: Arch, zipf: bool = False) -> dict:
    """The bag gradients back onto the unique-row slots, along the forward
    unique's stable sort as the engine calls it (no sort), and standalone
    (the wrapper sorts): both bitwise alike and repeating, within 1e-5 of
    scale of the plain version, unused slots exactly 0."""
    g_bags, seg, w, u = segment_case(b, gen, a, zipf)
    n, inv, n_uniq = seg.shape[0], u.inv, int(u.n_uniq)
    sorted_inv, order = torch.sort(inv, stable=True)
    check(torch.equal(u.order, order) and torch.equal(u.slot_sorted, sorted_inv),
          "the forward unique's order and slot_sorted are inv's stable sort")
    ops.reset_launches()
    out = ops.segment_grad(g_bags, seg, w, inv, n, order=u.order, sorted_inv=u.slot_sorted)
    again = ops.segment_grad(g_bags, seg, w, inv, n, order=u.order, sorted_inv=u.slot_sorted)
    check(ops.sorts["segment_grad"] == 0, "segment_grad along the carried sort sorts nothing")
    alone = ops.segment_grad(g_bags, seg, w, inv, n)
    check(ops.sorts["segment_grad"] == 1 and ops.launches["segment_grad"] == 3,
          f"standalone segment_grad sorts once: {ops.sorts}, {ops.launches}")
    rout = ref.segment_grad_ref(g_bags, seg, w, inv, n)
    torch.cuda.synchronize(DEV)
    check(same_bits(out, again) and same_bits(out, alone),
          "segment_grad repeats bit for bit, with or without the carried sort")
    err = max_err(out, rout)
    check(err <= TOL * scale_of(rout), f"segment_grad err {err}")
    check(n_uniq < n and bool((out[n_uniq:] == 0).all()),
          "segment_grad unused slots exactly 0")
    runs = torch.bincount(inv.long(), minlength=1)
    # the library yardstick: embedding_bag's backward onto its weight
    rows_u = torch.randn((n, a.dim), device=DEV, generator=gen).requires_grad_(True)
    offsets = torch.arange(n, device=DEV)
    lib_out = F.embedding_bag(inv.long(), rows_u, offsets, mode="sum", per_sample_weights=w)

    def lib():
        return torch.autograd.grad(lib_out, rows_u, g_bags, retain_graph=True)[0]

    check(max_err(lib(), rout) <= TOL * scale_of(rout), "embedding_bag backward agrees")
    # each input the function needs read once (g_bags, seg, w, inv), the
    # output written once; not the kernel's own int64 order
    b_ms, b_by = bound(g_bags.numel() * 4 + n * (4 + 4 + 4) + n * a.dim * 4,
                       2 * n * a.dim)
    kw = dict(order=u.order, sorted_inv=u.slot_sorted)
    return {"n": n, "d": a.dim, "case": "zipf" if zipf else "uniform", "n_uniq": n_uniq,
            "longest_run": int(runs.max()), "tile_chunk": ops.segment_grad_plan(n, a.dim, ops.sm_count(DEV)),
            "max_abs_err": err,
            "ms": cuda_ms(lambda: ops.segment_grad(g_bags, seg, w, inv, n, **kw)),
            "call_ms": cuda_ms(lambda: ops.segment_grad(g_bags, seg, w, inv, n, **kw),
                               device_only=False),
            "sorting_ms": cuda_ms(lambda: ops.segment_grad(g_bags, seg, w, inv, n)),
            "plain_ms": cuda_ms(lambda: ref.segment_grad_ref(g_bags, seg, w, inv, n)),
            "library_ms": cuda_ms(lib), "bound_ms": b_ms, "bound_by": b_by}


_TABLES = {}


def full_tables(gen: torch.Generator, key: str, rows: int, d: int):
    """Two identical full-size tables + accumulators (kernel and plain
    version each update one in place), made once for all the shapes of
    ``key`` (an arch's master, or one of its tiers)."""
    if _TABLES.get("key") != key:
        _TABLES.clear()
        torch.cuda.empty_cache()
        w = torch.randn((rows, d), device=DEV, generator=gen)
        acc = torch.rand((rows, 1), device=DEV, generator=gen)
        _TABLES.update(key=key, w_k=w, acc_k=acc, w_p=w.clone(), acc_p=acc.clone())
    return _TABLES


# positions of the skewed dedup case's three rows: one far past the 32
# positions a list sorts, one just past, one pair
DEDUP_SKEW = (1000, 33, 2)


def dedup_case(m: int, rows: int, d: int, gen: torch.Generator, skew: bool = False):
    """``(idx, g, valid)`` of m gradient rows into a ``rows``-row table: a
    quarter of them duplicates of other rows, or with ``skew`` the rows of
    DEDUP_SKEW (spread over random rows) repeated at random positions; a
    tenth invalid slots that point at row 0 (the clamped ``recv_local`` of
    an empty bucket slot)."""
    idx = torch.randint(0, rows, (m,), device=DEV, generator=gen, dtype=torch.int32)
    perm = torch.randperm(m, device=DEV, generator=gen)
    if skew:
        heavy = torch.randint(0, rows, (len(DEDUP_SKEW),), device=DEV, generator=gen,
                              dtype=torch.int32)
        at = 0
        for row, k in zip(heavy, DEDUP_SKEW):
            idx[perm[at:at + k]] = row
            at += k
    else:
        dup = perm[: m // 4]
        idx[dup] = idx[torch.randint(0, m, (dup.numel(),), device=DEV, generator=gen)]
    valid = torch.rand((m,), device=DEV, generator=gen) >= 0.1
    if skew:
        valid[perm[:sum(DEDUP_SKEW)]] = True
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    g = torch.randn((m, d), device=DEV, generator=gen)
    return idx, g, valid


def dedup_shape(b: int, a: Arch, tier: bool = False) -> Tuple[int, int, int]:
    """``(m, rows, d)`` of a B-sample step's ``dedup_adagrad`` on ``a``: the
    miss gradients (m = the plan's bucket capacity) into the master (the
    narrow one for ``picasso_narrow``), or with ``tier`` the hit gradients
    of the step's B x fields unique ids into the L2 tier at full width."""
    if tier:
        return b * a.n_fields, a.l2_rows, a.dim
    return arch_plan(a, b)[1].capacity[0], a.rows, a.master_dim


def run_dedup_adagrad(b: int, gen: torch.Generator, a: Arch, tier: bool = False,
                      skew: bool = False) -> dict:
    """``dedup_adagrad`` at a step's shape (``dedup_shape``) on a full table
    against its plain version: touched rows within 1e-5 of scale, every
    other row bitwise unchanged, and a second call from the same state
    bitwise the first."""
    m, rows, d = dedup_shape(b, a, tier)
    t = full_tables(gen, f"{a.name} {'L2' if tier else 'master'}", rows, d)
    w_k, acc_k, w_p, acc_p = t["w_k"], t["acc_k"], t["w_p"], t["acc_p"]
    idx, g, valid = dedup_case(m, rows, d, gen, skew)
    touched = torch.unique(idx[valid]).long()
    u = touched.numel()
    w_p.copy_(w_k)  # the previous shape's timing moved the two apart
    acc_p.copy_(acc_k)
    w0, acc0 = w_k[touched].clone(), acc_k[touched].clone()
    ops.dedup_adagrad(w_k, acc_k, idx, g, valid, LR, EPS)
    ref.dedup_adagrad_ref(w_p, acc_p, idx, g, valid, LR, EPS)
    torch.cuda.synchronize(DEV)
    err_w = max_err(w_k[touched], w_p[touched])
    err_acc = max_err(acc_k[touched], acc_p[touched])
    err = max(err_w, err_acc)
    # acc grows by mean(gsum^2): a row summed from 1,000 positions takes it
    # to about 1,000, where the plain version's atomic sums, in another
    # order, part by an ulp; it is held to its own scale there
    acc_scale = scale_of(acc_p[touched]) if skew else scale_of(w_p[touched])
    check(err_w <= TOL * scale_of(w_p[touched]) and err_acc <= TOL * acc_scale,
          f"dedup_adagrad touched rows err w {err_w}, acc {err_acc}")
    check(not torch.equal(w_k[touched], w0), "dedup_adagrad moved the touched rows")
    first = (w_k[touched].clone(), acc_k[touched].clone())
    # every other row of the full table: put the touched rows back, then the
    # kernel's table must equal the plain version's bit for bit
    for tw, ta in ((w_k, acc_k), (w_p, acc_p)):
        tw[touched], ta[touched] = w0, acc0
    check(torch.equal(w_k, w_p) and torch.equal(acc_k, acc_p),
          "dedup_adagrad untouched rows bitwise unchanged")
    ops.dedup_adagrad(w_k, acc_k, idx, g, valid, LR, EPS)
    check(same_bits(w_k[touched], first[0]) and same_bits(acc_k[touched], first[1]),
          f"dedup_adagrad repeats bit for bit at {(m, rows, d)}, skew={skew}")
    w_k[touched], acc_k[touched] = w0, acc0
    # inputs once (idx, valid, g), touched rows of w and acc read and written
    nbytes = m * (4 + 1 + d * 4) + u * (d * 4 + 4) * 2
    b_ms, b_by = bound(nbytes, m * d + u * (3 * d + 4))
    return {"m": m, "rows": rows, "d": d, "touched_rows": u, "skew": skew,
            "max_abs_err": err,
            "ms": cuda_ms(lambda: ops.dedup_adagrad(w_k, acc_k, idx, g, valid, LR, EPS)),
            "call_ms": cuda_ms(lambda: ops.dedup_adagrad(w_k, acc_k, idx, g, valid, LR, EPS),
                               device_only=False),
            "plain_ms": cuda_ms(lambda: ref.dedup_adagrad_ref(w_p, acc_p, idx, g, valid,
                                                              LR, EPS)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}


# the unpacked path's per-table shapes: B positions of one table at D = 10,
# into a 3-row ps table (every position on one of 3 rows) and an 8,192-row
# one (the largest the ps gate takes)
TABLE_ROWS, TABLE_D = (3, 8_192), 10


def run_table_shapes(gen: torch.Generator) -> dict:
    """``segment_grad`` and ``dedup_adagrad`` at the unpacked path's per-table
    shapes (n = 256 and 512 at D = 10): ``segment_grad`` along a ps group's
    identity order and along a picasso group's unique sort over ``TABLE_ROWS``
    rows, ``dedup_adagrad`` with every position's gradient on those rows. Each
    within 1e-5 of scale of its plain version, repeating bit for bit, no
    sort; rows no position touches bitwise unchanged."""
    out = []
    d = TABLE_D
    for n in (TRAIN_B, SERVE_B):
        g_bags = torch.randn((n, d), device=DEV, generator=gen)
        seg = torch.arange(n, device=DEV, dtype=torch.int32)
        w = torch.rand((n,), device=DEV, generator=gen) + 0.5
        ident = torch.arange(n, device=DEV, dtype=torch.int32)
        for rows in TABLE_ROWS:
            ids = torch.randint(0, rows, (n,), device=DEV, generator=gen, dtype=torch.int32)
            u = pe.fixed_unique(ids, sentinel=rows)
            for kind, (inv, order, srt) in (("ps identity", (ident, ident.long(), ident)),
                                            ("picasso unique", (u.inv, u.order,
                                                                u.slot_sorted))):
                if kind == "ps identity" and rows != TABLE_ROWS[0]:
                    continue  # the identity order does not depend on the table
                ops.reset_launches()
                k = ops.segment_grad(g_bags, seg, w, inv, n, order=order, sorted_inv=srt)
                k2 = ops.segment_grad(g_bags, seg, w, inv, n, order=order, sorted_inv=srt)
                p = ref.segment_grad_ref(g_bags, seg, w, inv, n)
                torch.cuda.synchronize(DEV)
                err = max_err(k, p)
                check(ops.sorts["segment_grad"] == 0 and ops.launches["segment_grad"] == 2
                      and same_bits(k, k2) and err <= TOL * scale_of(p),
                      f"segment_grad {kind} n={n} rows={rows}: err {err}")
                out.append({"kernel": "segment_grad", "case": kind, "n": n, "rows": rows,
                            "d": d, "max_abs_err": err,
                            "ms": cuda_ms(lambda: ops.segment_grad(
                                g_bags, seg, w, inv, n, order=order, sorted_inv=srt)),
                            "plain_ms": cuda_ms(lambda: ref.segment_grad_ref(
                                g_bags, seg, w, inv, n))})
            tw = torch.randn((rows, d), device=DEV, generator=gen)
            ta = torch.rand((rows, 1), device=DEV, generator=gen)
            g = torch.randn((n, d), device=DEV, generator=gen)
            valid = torch.ones((n,), device=DEV, dtype=torch.bool)
            w0, a0 = tw.clone(), ta.clone()
            pw, pa = tw.clone(), ta.clone()
            ops.dedup_adagrad(tw, ta, ids, g, valid, LR, EPS)
            ref.dedup_adagrad_ref(pw, pa, ids, g, valid, LR, EPS)
            first = (tw.clone(), ta.clone())
            tw.copy_(w0)
            ta.copy_(a0)
            ops.dedup_adagrad(tw, ta, ids, g, valid, LR, EPS)
            torch.cuda.synchronize(DEV)
            touched = torch.unique(ids).long()
            untouched = torch.ones((rows,), device=DEV, dtype=torch.bool)
            untouched[touched] = False
            err_w, err_a = max_err(tw, pw), max_err(ta, pa)
            check(same_bits(tw, first[0]) and same_bits(ta, first[1])
                  and err_w <= TOL * scale_of(pw) and err_a <= TOL * scale_of(pa)
                  and torch.equal(tw[untouched], w0[untouched])
                  and torch.equal(ta[untouched], a0[untouched]),
                  f"dedup_adagrad n={n} rows={rows}: err w {err_w}, acc {err_a}")
            out.append({"kernel": "dedup_adagrad", "n": n, "rows": rows, "d": d,
                        "touched_rows": int(touched.numel()),
                        "max_abs_err": max(err_w, err_a),
                        "ms": cuda_ms(lambda: ops.dedup_adagrad(tw, ta, ids, g, valid, LR,
                                                                EPS)),
                        "plain_ms": cuda_ms(lambda: ref.dedup_adagrad_ref(
                            pw, pa, ids, g, valid, LR, EPS))})
    return out


def run_fm_bwd(b: int, gen: torch.Generator, a: Arch) -> dict:
    x = torch.randn((b, a.n_fields, a.dim), device=DEV, generator=gen) * 0.3
    g = torch.randn((b, 1), device=DEV, generator=gen)
    out, again = ops.fm_interaction_bwd(x, g), ops.fm_interaction_bwd(x, g)
    rout = ref.fm_interaction_bwd_ref(x, g)
    torch.cuda.synchronize(DEV)
    err = max_err(out, rout)
    check(err <= TOL * scale_of(rout), f"fm_interaction_bwd err {err}")
    check(same_bits(out, again), f"fm_interaction_bwd repeats bit for bit at B={b}")
    leaf = x.clone().requires_grad_(True)
    chain_out = fm_chain(leaf)

    def lib():  # the chain's autograd
        return torch.autograd.grad(chain_out, leaf, g, retain_graph=True)[0]

    check(max_err(lib(), rout) <= TOL * scale_of(rout), "FM chain's autograd agrees")
    b_ms, b_by = bound(2 * x.numel() * 4 + b * 4, 3 * x.numel())
    return {"n": b, "plan": list(ops.fm_bwd_plan(b, a.n_fields, a.dim, ops.sm_count(DEV))),
            "max_abs_err": err,
            "ms": cuda_ms(lambda: ops.fm_interaction_bwd(x, g)),
            "call_ms": cuda_ms(lambda: ops.fm_interaction_bwd(x, g), device_only=False),
            "plain_ms": cuda_ms(lambda: ref.fm_interaction_bwd_ref(x, g)),
            "library_ms": cuda_ms(lib), "library_call": "autograd of the FM chain",
            "bound_ms": b_ms, "bound_by": b_by}


def cross_case(b: int, gen: torch.Generator, d: int = CROSS_D):
    """dcn-v2's cross layer at batch b: x0, x [b, d], W [d, d] at the
    reference's init scale, a bias and a cotangent (d = the 429-wide base
    unless an edge shape asks for another)."""
    x0 = torch.randn((b, d), device=DEV, generator=gen)
    x = torch.randn((b, d), device=DEV, generator=gen)
    w = torch.randn((d, d), device=DEV, generator=gen) / d ** 0.5
    bias = torch.randn((d,), device=DEV, generator=gen) * 0.1
    g = torch.randn((b, d), device=DEV, generator=gen)
    return x0, x, w, bias, g


def cross_bounds(b: int, d: int, gemms: int, nbytes: float, fp32_ops: float):
    """The cross kernels' bound for the arithmetic they do, 3xTF32: three
    tf32 products of 2·B·d² operations for each of ``gemms`` GEMMs at the
    tensor cores' rate; beside it the float32-FMA bound of earlier rows."""
    b_ms, b_by = bound(nbytes, 3 * gemms * 2 * b * d * d, TF32_OPS_PER_S,
                       "operations (3xTF32)")
    return {"bound_ms": b_ms, "bound_by": b_by, "fp32_bound_ms": bound(nbytes, fp32_ops)[0]}


def run_cross(b: int, gen: torch.Generator, a: Arch) -> dict:
    x0, x, w, bias, _ = cross_case(b, gen)
    d = CROSS_D
    out, again = ops.cross_layer(x0, x, w, bias), ops.cross_layer(x0, x, w, bias)
    rout = ref.cross_layer_ref(x0, x, w, bias)
    lib = torch.addcmul(x, x0, torch.addmm(bias, x, w))
    torch.cuda.synchronize(DEV)
    err = max_err(out, rout)
    check(err <= TOL * scale_of(rout), f"cross_layer err {err}")
    check(same_bits(out, again), "cross_layer repeats bit for bit")
    check(max_err(lib, rout) <= TOL * scale_of(rout), "addmm + addcmul yardstick agrees")
    return {"n": b, "d": d, "cluster": ops.cross_plan(b, d)[0], "tile": "64x64",
            "max_abs_err": err, "max_err_of_scale": err / scale_of(rout),
            "ms": cuda_ms(lambda: ops.cross_layer(x0, x, w, bias)),
            "call_ms": cuda_ms(lambda: ops.cross_layer(x0, x, w, bias), device_only=False),
            "plain_ms": cuda_ms(lambda: ref.cross_layer_ref(x0, x, w, bias)),
            # two calls, timed together: torch.addmm then torch.addcmul
            "library_ms": cuda_ms(lambda: torch.addcmul(x, x0, torch.addmm(bias, x, w))),
            **cross_bounds(b, d, 1, (3 * b * d + d * d + d) * 4, 2 * b * d * d + 3 * b * d)}


def run_cross_bwd(b: int, gen: torch.Generator, a: Arch) -> dict:
    x0, x, w, bias, g = cross_case(b, gen)
    d = CROSS_D
    got = ops.cross_layer_bwd(x0, x, w, bias, g)
    again = ops.cross_layer_bwd(x0, x, w, bias, g)
    exp = ref.cross_layer_bwd_ref(x0, x, w, bias, g)
    # the library yardstick: autograd of addmm + addcmul (three cuBLAS GEMMs)
    leaves = [t.clone().requires_grad_(True) for t in (x0, x, w, bias)]
    lib_out = torch.addcmul(leaves[1], leaves[0], torch.addmm(leaves[3], leaves[1], leaves[2]))

    def lib():
        return torch.autograd.grad(lib_out, leaves, g, retain_graph=True)

    torch.cuda.synchronize(DEV)
    errs = {}  # each cotangent's max-abs error, as a share of its scale
    for name, k, e, lb in zip(("gx0", "gx", "gw", "gb"), got, exp, lib()):
        errs[name] = max_err(k, e) / scale_of(e)
        check(errs[name] <= TOL, f"cross_layer_bwd {name} err {errs[name]} of scale")
        check(max_err(lb, e) <= TOL * scale_of(e), f"autograd yardstick {name} agrees")
    check(all(same_bits(p, q) for p, q in zip(got, again)),
          "cross_layer_bwd repeats bit for bit")
    _, c_dx, c_dw = ops.cross_plan(b, d)
    return {"n": b, "d": d, "cluster": f"dx {c_dx}, dW {c_dw}", "tile": "64x64",
            "max_abs_err": max(max_err(k, e) for k, e in zip(got, exp)),
            "max_err_of_scale": max(errs.values()), "errs_of_scale": errs,
            "ms": cuda_ms(lambda: ops.cross_layer_bwd(x0, x, w, bias, g)),
            "call_ms": cuda_ms(lambda: ops.cross_layer_bwd(x0, x, w, bias, g),
                               device_only=False),
            "plain_ms": cuda_ms(lambda: ref.cross_layer_bwd_ref(x0, x, w, bias, g)),
            "library_ms": cuda_ms(lib),
            **cross_bounds(b, d, 3, (5 * b * d + 2 * d * d + 2 * d) * 4,
                           6 * b * d * d + 5 * b * d)}


# (B, d) edge shapes of the two cross kernels: one row, a B that is no
# multiple of the 64-row tile or the 32-row slab, widths that are no
# multiple of the 8-deep mma step or the 64-wide tile
CROSS_EDGES = tuple((b, d) for b in (1, 37, 65_537) for d in (16, 29, 67, CROSS_D))


def run_cross_edges(gen: torch.Generator) -> dict:
    out = {}
    for b, d in CROSS_EDGES:
        x0, x, w, bias, g = cross_case(b, gen, d)
        fwd, rfwd = ops.cross_layer(x0, x, w, bias), ref.cross_layer_ref(x0, x, w, bias)
        bwd, rbwd = ops.cross_layer_bwd(x0, x, w, bias, g), ref.cross_layer_bwd_ref(
            x0, x, w, bias, g)
        fwd2, bwd2 = ops.cross_layer(x0, x, w, bias), ops.cross_layer_bwd(x0, x, w, bias, g)
        torch.cuda.synchronize(DEV)
        errs = [max_err(fwd, rfwd) / scale_of(rfwd)]
        errs += [max_err(k, e) / scale_of(e) for k, e in zip(bwd, rbwd)]
        check(max(errs) <= TOL, f"cross edge {(b, d)}: errs of scale {errs}")
        check(same_bits(fwd, fwd2) and all(same_bits(p, q) for p, q in zip(bwd, bwd2)),
              f"cross kernels repeat bit for bit at {(b, d)}")
        out[f"{b}x{d}"] = max(errs)
    return out


def project_case(b: int, gen: torch.Generator, a: Arch):
    """The narrow stitch of a B-sample request: n = B x 39 unique positions
    into the routed-back buffer of m = the plan's bucket capacity slots.
    About 60 % of the positions are kept (the misses); they take distinct
    slots as routing gives them, but an eighth of them then share another
    kept position's slot, so the gradient's runs are exercised. The rest
    point at the clamped drop slot m - 1, as ``mp_lookup_narrow`` passes
    them. Slots no kept position takes stay empty."""
    m = arch_plan(a, b)[1].capacity[0]
    n, nd, d = b * a.n_fields, a.narrow_dim, a.dim
    slots = (torch.randperm(m, device=DEV, generator=gen)[:n] if m >= n else
             torch.randint(0, m, (n,), device=DEV, generator=gen)).to(torch.int32)
    kept = torch.rand((n,), device=DEV, generator=gen) < 0.6
    kept_pos = torch.nonzero(kept).squeeze(1)
    n_dup = kept_pos.numel() // 8
    dup = kept_pos[torch.randperm(kept_pos.numel(), device=DEV, generator=gen)[:n_dup]]
    slots[dup] = slots[kept_pos[torch.randint(0, kept_pos.numel(), (n_dup,), device=DEV,
                                              generator=gen)]]
    idx = torch.where(kept, slots, torch.full_like(slots, m - 1))
    back = torch.randn((m, nd), device=DEV, generator=gen)
    proj = torch.randn((nd, d), device=DEV, generator=gen) / nd ** 0.5
    g_wide = torch.randn((n, d), device=DEV, generator=gen)
    g_narrow = torch.randn((n, nd), device=DEV, generator=gen)
    return back, idx, kept, proj, g_wide, g_narrow


def run_gather_project(b: int, gen: torch.Generator, a: Arch) -> dict:
    back, idx, kept, proj, _, _ = project_case(b, gen, a)
    (m, nd), n, d = back.shape, idx.shape[0], a.dim
    wide, narrow = ops.gather_project(back, idx, kept, proj)
    again = ops.gather_project(back, idx, kept, proj)
    rwide, rnarrow = ref.gather_project_ref(back, idx, kept, proj)
    check(same_bits(wide, again[0]) and same_bits(narrow, again[1]),
          f"gather_project repeats bit for bit at n={n}, d={nd}, D={d}")

    def lib():  # two calls, timed together
        return (F.embedding(idx.long(), back) * kept[:, None]) @ proj

    torch.cuda.synchronize(DEV)
    err = max(max_err(wide, rwide) / scale_of(rwide), max_err(narrow, rnarrow) / scale_of(rnarrow))
    check(err <= TOL, f"gather_project err {err} of scale")
    check(bool((wide[~kept] == 0).all() and (narrow[~kept] == 0).all()),
          "gather_project not-kept positions exactly 0")
    check(max_err(lib(), rwide) <= TOL * scale_of(rwide), "embedding @ proj yardstick agrees")
    n_kept = int(kept.sum())
    b_ms, b_by = bound(n * (4 + 1) + n_kept * nd * 4 + nd * d * 4 + n * (d + nd) * 4,
                       2 * n_kept * nd * d)
    return {"n": n, "m": m, "d": d, "narrow_d": nd, "kept": n_kept,
            "plan": list(ops.gather_project_plan(n, nd, d, ops.sm_count(DEV))),
            "max_abs_err": max(max_err(wide, rwide), max_err(narrow, rnarrow)),
            "max_err_of_scale": err,
            "ms": cuda_ms(lambda: ops.gather_project(back, idx, kept, proj)),
            "call_ms": cuda_ms(lambda: ops.gather_project(back, idx, kept, proj),
                               device_only=False),
            "plain_ms": cuda_ms(lambda: ref.gather_project_ref(back, idx, kept, proj)),
            "library_ms": cuda_ms(lib), "library_call": "F.embedding * kept, then @ proj",
            "bound_ms": b_ms, "bound_by": b_by}


def run_gather_project_grad(b: int, gen: torch.Generator, a: Arch) -> dict:
    """The transpose, standalone and through the autograd of
    ``ops.gather_project`` (the same kernel on the same inputs: bitwise
    equal), against its plain version; the projection's cotangent against
    the plain product."""
    back, idx, kept, proj, g_wide, g_narrow = project_case(b, gen, a)
    (m, nd), n, d = back.shape, idx.shape[0], a.dim
    got = ops.gather_project_grad(g_wide, g_narrow, idx, kept, proj, m)
    again = ops.gather_project_grad(g_wide, g_narrow, idx, kept, proj, m)
    exp = ref.gather_project_grad_ref(g_wide, g_narrow, idx, kept, proj, m)
    leaves = [back.clone().requires_grad_(True), proj.clone().requires_grad_(True)]
    before = ops.launches["gather_project_grad"]
    g_back, g_proj = torch.autograd.grad(ops.gather_project(leaves[0], idx, kept, leaves[1]),
                                         leaves, (g_wide, g_narrow))
    via_autograd = ops.launches["gather_project_grad"] - before
    torch.cuda.synchronize(DEV)
    err = max_err(got, exp) / scale_of(exp)
    check(err <= TOL, f"gather_project_grad err {err} of scale")
    check(torch.equal(got, again), "gather_project_grad repeats bit for bit")
    check(via_autograd == 1 and torch.equal(g_back, got),
          "the autograd backward of gather_project launches the same kernel")
    rnarrow = ref.gather_project_ref(back, idx, kept, proj)[1]
    p_exp = rnarrow.T @ g_wide
    check(max_err(g_proj, p_exp) <= TOL * scale_of(p_exp), "projection cotangent agrees")
    touched = torch.zeros((m,), dtype=torch.bool, device=DEV)
    touched[idx[kept].long()] = True
    check(bool((~touched).any()) and bool((got[~touched] == 0).all()),
          "gather_project_grad empty slots exactly 0")
    # the library yardstick: autograd of the two-call chain onto the buffer
    lib_back = back.clone().requires_grad_(True)
    lib_out = (F.embedding(idx.long(), lib_back) * kept[:, None]) @ proj

    def lib():
        return torch.autograd.grad(lib_out, lib_back, g_wide, retain_graph=True)[0]

    p_only = ref.gather_project_grad_ref(g_wide, torch.zeros_like(g_narrow), idx, kept, proj, m)
    check(max_err(lib(), p_only) <= TOL * scale_of(p_only), "embedding backward agrees")
    n_kept = int(kept.sum())
    b_ms, b_by = bound(n * (4 + 1) + n_kept * (d + nd) * 4 + nd * d * 4 + m * nd * 4,
                       n_kept * nd * (2 * d + 2))
    return {"n": n, "m": m, "d": d, "narrow_d": nd, "kept": n_kept,
            "empty_slots": int((~touched).sum()),
            "plan": list(ops.gather_project_grad_plan(m, nd, d, ops.sm_count(DEV))),
            "max_abs_err": max_err(got, exp), "max_err_of_scale": err,
            "ms": cuda_ms(lambda: ops.gather_project_grad(g_wide, g_narrow, idx, kept, proj,
                                                          m)),
            "call_ms": cuda_ms(lambda: ops.gather_project_grad(g_wide, g_narrow, idx, kept,
                                                               proj, m), device_only=False),
            "plain_ms": cuda_ms(lambda: ref.gather_project_grad_ref(g_wide, g_narrow, idx,
                                                                    kept, proj, m)),
            "library_ms": cuda_ms(lib),
            "library_call": "autograd of F.embedding * kept @ proj (g_wide only)",
            "bound_ms": b_ms, "bound_by": b_by}


def project_edge_case(gen: torch.Generator, m: int, n: int, nd: int, d: int, layout: str,
                      off: int = 0):
    """``(g_wide, g_narrow, idx, kept, proj)`` of n positions into m slots
    at narrow width nd and wide width d, by ``layout``: "uniform" (slots
    uniform, 60 % kept), "path" (the same, not-kept positions on slot
    m - 1, as ``mp_lookup_narrow`` passes them), "one slot" (every position
    kept, on slot m // 2: a list far past what the kernel sorts in shared
    memory), "runs" and "long runs" (slot 5 takes exactly 32 or 128 kept
    positions spread over [0, n), slot 6 one more, no other kept position
    takes either: the kernel sorts lists of up to 32 positions at one lane
    a slot and up to 128 from four lanes, and scans for longer ones),
    "outside" (a fifth of the kept positions on -1, -2^31, m, m + 7 and
    2^31 - 1); ``g_wide`` a view ``off`` floats past its buffer's start."""
    idx = torch.randint(0, m, (n,), device=DEV, generator=gen, dtype=torch.int32)
    kept = torch.rand((n,), device=DEV, generator=gen) < 0.6
    if layout == "path":
        idx = torch.where(kept, idx, torch.full_like(idx, m - 1))
    elif layout == "one slot":
        idx.fill_(m // 2)
        kept.fill_(True)
    elif layout in ("runs", "long runs"):
        run = 32 if layout == "runs" else 128
        idx = torch.where((idx == 5) | (idx == 6), idx + 2, idx)
        at = torch.randperm(n, device=DEV, generator=gen)[:2 * run + 1]
        idx[at[:run]] = 5
        idx[at[run:]] = 6
        kept[at] = True
    elif layout == "outside":
        bad = torch.tensor([-1, -2**31, m, m + 7, 2**31 - 1], dtype=torch.int32, device=DEV)
        pick = kept & (torch.rand((n,), device=DEV, generator=gen) < 0.2)
        which = torch.randint(0, bad.numel(), (n,), device=DEV, generator=gen)
        idx = torch.where(pick, bad[which], idx)
    g_wide = torch.randn((n * d + off,), device=DEV, generator=gen)[off:].view(n, d)
    g_narrow = torch.randn((n, nd), device=DEV, generator=gen)
    proj = torch.randn((nd, d), device=DEV, generator=gen) / nd ** 0.5
    return g_wide, g_narrow, idx, kept, proj


# (m, n, d, D, layout, g_wide offset floats) of gather_project_grad's edge lists
PROJECT_GRAD_EDGES = ((100, 0, 4, 10, "uniform", 0), (1, 500, 4, 10, "uniform", 0),
                      (15_976, 9_984, 4, 10, "one slot", 0), (15_976, 9_984, 4, 10, "runs", 0),
                      (15_976, 9_984, 4, 10, "long runs", 0), (15_976, 9_984, 1, 10, "runs", 0),
                      (15_976, 9_984, 4, 10, "outside", 0), (15_976, 9_984, 1, 10, "path", 0),
                      (4_000, 2_000, 256, 48, "path", 0), (4_000, 2_000, 96, 128, "path", 0),
                      (15_976, 9_984, 3, 7, "path", 0), (4_000, 2_000, 32, 128, "runs", 0),
                      (15_976, 9_984, 4, 10, "path", 1))


def project_edge_label(m: int, n: int, nd: int, d: int, layout: str, off: int) -> str:
    return f"m={m} n={n} d={nd} D={d} {layout}" + (f" g_wide off {4 * off}" if off else "")


def run_gather_project_grad_edges(gen: torch.Generator) -> dict:
    """gather_project_grad on ``PROJECT_GRAD_EDGES`` (n = 0, m = 1, one
    slot, runs of 32 and 33 and of 128 and 129, slots outside [0, m), d =
    1, 256, d * D = 12,288, odd widths, DLRM's widths, g_wide off 16
    bytes): within TOL of scale of the plain version, empty slots exactly
    +0.0, a second call bitwise the first. Returns each case's error of
    scale."""
    out = {}
    for m, n, nd, d, layout, off in PROJECT_GRAD_EDGES:
        g_wide, g_narrow, idx, kept, proj = project_edge_case(gen, m, n, nd, d, layout, off)
        got = ops.gather_project_grad(g_wide, g_narrow, idx, kept, proj, m)
        again = ops.gather_project_grad(g_wide, g_narrow, idx, kept, proj, m)
        exp = ref.gather_project_grad_ref(g_wide, g_narrow, idx, kept, proj, m)
        torch.cuda.synchronize(DEV)
        case = project_edge_label(m, n, nd, d, layout, off)
        ok = kept & (idx >= 0) & (idx < m)
        touched = torch.zeros((m,), dtype=torch.bool, device=DEV)
        touched[idx[ok].long()] = True
        err = max_err(got, exp) / scale_of(exp)
        check(err <= TOL, f"gather_project_grad {case}: err {err} of scale")
        check(same_bits(got[~touched], torch.zeros_like(got[~touched])),
              f"gather_project_grad {case}: empty slots exactly +0.0")
        check(same_bits(got, again), f"gather_project_grad {case} repeats")
        out[case] = err
    return out


def grad_rows(b: int, gen: torch.Generator, a: Arch) -> torch.Tensor:
    """The routed gradient rows of a B-sample step as the compression hop
    sees them: m = the plan's bucket capacity slots at the master width, of
    which the B x fields ids fill at most B x fields (37.5 % of the rows stay
    exactly zero at every path shape); an eighth of the filled rows repeat
    their largest magnitude in three columns with mixed signs (ties)."""
    m, d = arch_plan(a, b)[1].capacity[0], a.master_dim
    g = torch.zeros((m, d), device=DEV)
    filled = torch.randperm(m, device=DEV, generator=gen)[: min(b * a.n_fields, m)]
    g[filled] = torch.randn((filled.numel(), d), device=DEV, generator=gen)
    tie = filled[: filled.numel() // 8]
    cols = torch.randint(0, d, (tie.numel(), 3), device=DEV, generator=gen)
    signs = torch.randint(0, 2, (tie.numel(), 3), device=DEV, generator=gen) * 2.0 - 1.0
    g[tie[:, None], cols] = g[tie].abs().amax(1, keepdim=True) * signs
    return g


def zero_rows_of(g: torch.Tensor) -> torch.Tensor:
    zero = (g == 0).all(1)
    check(int(zero.sum()) >= 0.37 * g.shape[0], f"{int(zero.sum())} zero rows of {g.shape[0]}")
    return zero


def view_off_16(g: torch.Tensor, off: int = 4) -> torch.Tensor:
    """A copy of ``g`` in a view ``off`` bytes past a 16-byte boundary."""
    per = 16 // g.element_size()
    buf = torch.empty((g.numel() + 2 * per,), dtype=g.dtype, device=g.device)
    start = (-(buf.data_ptr() % 16) // g.element_size()) % per + off // g.element_size()
    view = buf[start:start + g.numel()].view(g.shape)
    check(view.data_ptr() % 16 == off, f"view at {view.data_ptr() % 16} bytes off 16")
    return view.copy_(g)


def run_fp16_compress(b: int, gen: torch.Generator, a: Arch) -> dict:
    g = grad_rows(b, gen, a)
    (m, d), zero = g.shape, zero_rows_of(g)
    q, s = ops.compress_fp16(g)
    again = ops.compress_fp16(g)
    rq, rs = ref.fp16_compress_ref(g)
    torch.cuda.synchronize(DEV)
    check(same_bits(q, rq) and same_bits(s, rs), "fp16_compress payload bitwise")
    check(same_bits(q, again[0]) and same_bits(s, again[1]), "fp16_compress repeats")
    check(not q[zero].any() and not s[zero].any(), "fp16_compress zero rows exactly 0")
    view = view_off_16(g)
    vq, vs = ops.compress_fp16(view)
    torch.cuda.synchronize(DEV)
    check(same_bits(vq, rq) and same_bits(vs, rs), "fp16_compress on a view 4 bytes off 16")

    def lib():  # amax, clamp_min, div, half: four calls, timed together
        return (g / g.abs().amax(1, keepdim=True).clamp_min(1e-30)).half()

    check(same_bits(lib(), rq), "amax/div/half chain agrees")
    b_ms, b_by = bound(m * d * (4 + 2) + m * 4, 3 * m * d)
    return {"m": m, "d": d, "plan": list(ops.fp16_compress_plan(m, d, ops.sm_count(DEV))),
            "zero_rows": int(zero.sum()),
            "max_abs_err": max(max_err(q.float(), rq.float()), max_err(s, rs)),
            "ms": cuda_ms(lambda: ops.compress_fp16(g)),
            "call_ms": cuda_ms(lambda: ops.compress_fp16(g), device_only=False),
            "plain_ms": cuda_ms(lambda: ref.fp16_compress_ref(g)),
            "library_ms": cuda_ms(lib), "library_call": "amax, clamp_min, div, half",
            "bound_ms": b_ms, "bound_by": b_by}


def run_fp16_decompress(b: int, gen: torch.Generator, a: Arch) -> dict:
    g = grad_rows(b, gen, a)
    (m, d), zero = g.shape, zero_rows_of(g)
    q, s = ref.fp16_compress_ref(g)
    out, again = ops.decompress_fp16(q, s), ops.decompress_fp16(q, s)
    rout = ref.fp16_decompress_ref(q, s)
    torch.cuda.synchronize(DEV)
    check(same_bits(out, rout), "fp16_decompress rows bitwise")
    check(same_bits(out, again), "fp16_decompress repeats")
    check(not out[zero].any(), "fp16 roundtrip of a zero row exactly 0")
    err = max_err(out, g) / scale_of(g)
    check(err <= 2.0 ** -11, f"fp16 roundtrip within a half ulp of the row max: {err}")
    check(same_bits(torch.mul(q, s), rout), "mul yardstick agrees")
    b_ms, b_by = bound(m * d * (2 + 4) + m * 4, m * d)
    return {"m": m, "d": d, "plan": list(ops.fp16_decompress_plan(m, d, ops.sm_count(DEV))),
            "zero_rows": int(zero.sum()), "max_abs_err": max_err(out, rout),
            "roundtrip_err_of_scale": err,
            "ms": cuda_ms(lambda: ops.decompress_fp16(q, s)),
            "call_ms": cuda_ms(lambda: ops.decompress_fp16(q, s), device_only=False),
            "plain_ms": cuda_ms(lambda: ref.fp16_decompress_ref(q, s)),
            "library_ms": cuda_ms(lambda: torch.mul(q, s)), "library_call": "mul",
            "bound_ms": b_ms, "bound_by": b_by}


def fp16_edge_payload(gen: torch.Generator, m: int, d: int):
    """``(q, s)``: compressed rows with the decompression edges: of the
    halves a fifth NaNs of several payloads and both signs, +-inf, -0.0
    and float16 subnormals; 30 % zero rows (scale 0); scales from 1e-6 to
    1e3."""
    q = (torch.rand((m, d), device=DEV, generator=gen) * 2 - 1).half()
    special = torch.tensor([0x7C01, 0xFE00, 0x7FFF, 0x7C00, 0xFC00, 0x8000, 0x0001, 0x83FF],
                           dtype=torch.int32, device=DEV).to(torch.int16)
    pick = torch.rand((m, d), device=DEV, generator=gen) < 0.2
    which = torch.randint(0, special.numel(), (m, d), device=DEV, generator=gen)
    bits = q.view(torch.int16)
    bits.copy_(torch.where(pick, special[which], bits))
    s = 10.0 ** (torch.rand((m, 1), device=DEV, generator=gen) * 9 - 6)
    zero = torch.rand((m,), device=DEV, generator=gen) < 0.3
    q[zero] = 0
    s[zero] = 0
    return q, s


def fp16_decompress_at(q: torch.Tensor, s: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The kernel launched from its plan into ``out`` (any float32 view,
    such as one off 16 bytes, which the wrapper never allocates); not
    counted in ``ops.launches``."""
    m, d = q.shape
    rc = build.launcher("fp16_decompress")(
        q.data_ptr(), s.data_ptr(), out.data_ptr(), m * d, d,
        *ops.fp16_decompress_plan(m, d, ops.sm_count(DEV)),
        torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"fp16_decompress into a view: cudaError {rc}")
    return out


def run_fp16_decompress_edges(gen: torch.Generator) -> dict:
    """fp16_decompress on edge payloads (``fp16_edge_payload``) at m * D =
    1-17 (D = 1, 2, 3 and one row) and at deepfm's D = 10, DLRM's d = 32
    and D = 3, with q 2, 4, 8 and 12 bytes off 16 and the output 4, 8 and
    12 bytes off 16: bitwise the plain version, a second call bitwise the
    first. Returns the number of cases."""
    shapes = sorted({(md // d, d) for md in range(1, 18) for d in (1, 2, 3, md) if md % d == 0})
    cases = 0
    for m, d in shapes + [(15_976, 10), (10_652, 32), (1_001, 3)]:
        q, s = fp16_edge_payload(gen, m, d)
        exp = ref.fp16_decompress_ref(q, s)
        for qoff, ooff in ((0, 0), (2, 0), (4, 0), (8, 0), (12, 0), (0, 4), (0, 8), (0, 12),
                           (2, 12), (6, 4)):
            qv = view_off_16(q, qoff) if qoff else q
            got = (fp16_decompress_at(qv, s, view_off_16(exp, ooff).fill_(7.0)) if ooff
                   else ops.decompress_fp16(qv, s))
            again = ops.decompress_fp16(qv, s)
            torch.cuda.synchronize(DEV)
            what = f"fp16_decompress m={m} D={d} q off {qoff} out off {ooff}"
            check(same_bits(got, exp), f"{what} bitwise the plain version")
            check(same_bits(again, exp), f"{what} repeats")
            cases += 1
    return {"cases": cases}


def run_topk_compress(b: int, gen: torch.Generator, a: Arch) -> dict:
    g = grad_rows(b, gen, a)
    (m, d), zero = g.shape, zero_rows_of(g)
    k = gcomp.topk_k(d)
    vals, idx = ops.compress_topk(g, k)
    again = ops.compress_topk(g, k)
    rvals, ridx = ref.topk_compress_ref(g, k)
    torch.cuda.synchronize(DEV)
    check(same_bits(vals, rvals) and same_bits(idx, ridx), "topk_compress payload bitwise")
    check(same_bits(vals, again[0]) and same_bits(idx, again[1]), "topk_compress repeats")
    first = torch.arange(k, device=DEV, dtype=torch.int32).expand(int(zero.sum()), k)
    check(not vals[zero].any() and torch.equal(idx[zero], first),
          "topk_compress zero rows: value 0 at the first k columns")
    vv, vi = ops.compress_topk(view_off_16(g), k)
    torch.cuda.synchronize(DEV)
    check(same_bits(vv, rvals) and same_bits(vi, ridx), "topk_compress on a view 4 bytes off 16")
    mag = g.abs()

    def lib():  # topk then gather: two calls, timed together (ties in any order)
        return torch.gather(g, 1, torch.topk(mag, k, dim=1).indices)

    check(torch.equal(lib().abs(), vals.abs()), "topk + gather yardstick magnitudes agree")
    b_ms, b_by = bound(m * d * 4 + m * k * 8, m * k * d)
    return {"m": m, "d": d, "k": k,
            "plan": list(ops.topk_compress_plan(m, d, k, ops.sm_count(DEV))),
            "zero_rows": int(zero.sum()), "max_abs_err": max_err(vals, rvals),
            "ms": cuda_ms(lambda: ops.compress_topk(g, k)),
            "call_ms": cuda_ms(lambda: ops.compress_topk(g, k), device_only=False),
            "plain_ms": cuda_ms(lambda: ref.topk_compress_ref(g, k)),
            "library_ms": cuda_ms(lib), "library_call": "topk of |g|, then gather",
            "bound_ms": b_ms, "bound_by": b_by}


def run_topk_decompress(b: int, gen: torch.Generator, a: Arch) -> dict:
    g = grad_rows(b, gen, a)
    (m, d), zero = g.shape, zero_rows_of(g)
    k = gcomp.topk_k(d)
    vals, idx = ref.topk_compress_ref(g, k)
    out, again = ops.decompress_topk(vals, idx, d), ops.decompress_topk(vals, idx, d)
    rout = ref.topk_decompress_ref(vals, idx, d)
    torch.cuda.synchronize(DEV)
    check(same_bits(out, rout), "topk_decompress rows bitwise")
    check(same_bits(out, again), "topk_decompress repeats")
    check(not out[zero].any(), "topk roundtrip of a zero row exactly 0")
    kept = torch.gather(g, 1, idx.long())
    check(same_bits(torch.gather(out, 1, idx.long()), kept)
          and int((out != 0).sum()) == int((kept != 0).sum()), "topk roundtrip keeps k")
    idx64 = idx.long()

    def lib():  # zeros, then scatter: two calls, timed together
        return torch.zeros((m, d), device=DEV).scatter_(1, idx64, vals)

    check(same_bits(lib(), rout), "scatter yardstick agrees")
    b_ms, b_by = bound(m * k * 8 + m * d * 4, m * k)
    return {"m": m, "d": d, "k": k,
            "plan": list(ops.topk_decompress_plan(m, d, ops.sm_count(DEV))),
            "zero_rows": int(zero.sum()), "max_abs_err": max_err(out, rout),
            "ms": cuda_ms(lambda: ops.decompress_topk(vals, idx, d)),
            "call_ms": cuda_ms(lambda: ops.decompress_topk(vals, idx, d),
                               device_only=False),
            "plain_ms": cuda_ms(lambda: ref.topk_decompress_ref(vals, idx, d)),
            "library_ms": cuda_ms(lib), "library_call": "zeros, then scatter_",
            "bound_ms": b_ms, "bound_by": b_by}


def run_compress_edges() -> dict:
    """The four kernels on edge rows against their plain versions: NaN (whole
    fp16 row NaN; topk ranks NaN first), infinities, float32 subnormals
    (kept: no flush to zero), entries that scale to float16 subnormals,
    signed zeros and all-tied rows, at D = 10."""
    g = torch.tensor([[1.0, float("nan"), -3.0, 2.0, 0.5, 0.25, 4.0, -1.0, 0.0, 2.0],
                      [float("inf"), 1.0, -float("inf"), 0.0, 0.0, 5.0, 0.0, 0.0, 0.0, 0.0],
                      [1e-39, -3e-40, 2e-41, 0.0, 1e-45, 0.0, 0.0, 0.0, 0.0, 0.0],
                      [1.0, 1e-6, -3e-7, 1e-8, 6e-8, -2e-5, 0.0, 0.0, 0.0, 0.0],
                      [-0.0, 0.0, -0.0, 0.0, -0.0, 0.0, -0.0, 0.0, -0.0, 0.0],
                      [-2.0, 2.0, 2.0, -2.0, 2.0, 2.0, -2.0, 2.0, 2.0, 2.0]], device=DEV)
    d, k = g.shape[1], 3
    q, s = ops.compress_fp16(g)
    rq, rs = ref.fp16_compress_ref(g)
    vals, idx = ops.compress_topk(g, k)
    rvals, ridx = ref.topk_compress_ref(g, k)
    out16 = ops.decompress_fp16(rq, rs)
    outk = ops.decompress_topk(rvals, ridx, d)
    torch.cuda.synchronize(DEV)
    check(same_bits(q, rq) and same_bits(s, rs), "fp16_compress edge rows bitwise")
    check(same_bits(vals, rvals) and same_bits(idx, ridx), "topk_compress edge rows bitwise")
    check(same_bits(out16, ref.fp16_decompress_ref(rq, rs)), "fp16_decompress edge rows")
    check(same_bits(outk, ref.topk_decompress_ref(rvals, ridx, d)), "topk_decompress edges")
    check(bool(torch.isnan(q[0]).all()) and idx[0].tolist() == [1, 6, 2]
          and float(s[2, 0]) > 0, f"edge semantics: {idx[0].tolist()} {float(s[2, 0])}")
    return {"rows": g.shape[0], "scale": [str(x) for x in s[:, 0].tolist()],
            "topk_idx": idx.tolist()}


def dot_case(b: int, gen: torch.Generator, f: int, d: int):
    """DLRM's interaction input at batch b: F vectors of width D a sample (26
    fields and the bottom MLP's output at full width) at the scale of
    embedding rows, and a cotangent for each of the P = F(F-1)/2 dots."""
    x = torch.randn((b, f, d), device=DEV, generator=gen) / d ** 0.5
    g = torch.randn((b, f * (f - 1) // 2), device=DEV, generator=gen)
    return x, g


def run_dot(b: int, gen: torch.Generator, a: Arch, f: int = 0, d: int = 0) -> dict:
    f, d = f or a.n_fields + 1, d or a.dim
    x, _ = dot_case(b, gen, f, d)
    p = f * (f - 1) // 2
    out, again = ops.dot_interaction(x), ops.dot_interaction(x)
    rout = ref.dot_interaction_ref(x)
    iu, ju = torch.triu_indices(f, f, 1, device=DEV)

    def lib():  # bmm, then the triangle gather: two calls, timed together
        return torch.bmm(x, x.transpose(1, 2))[:, iu, ju]

    torch.cuda.synchronize(DEV)
    err = max_err(out, rout)
    check(err <= TOL * scale_of(rout), f"dot_interaction err {err} at {(b, f, d)}")
    check(torch.equal(out, again), "dot_interaction repeats bit for bit")
    check(max_err(lib(), rout) <= TOL * scale_of(rout), "bmm + gather yardstick agrees")
    b_ms, b_by = bound((b * f * d + b * p) * 4, 2 * b * p * d)
    return {"n": b, "f": f, "d": d, "p": p, "max_abs_err": err,
            "max_err_of_scale": err / scale_of(rout),
            "ms": cuda_ms(lambda: ops.dot_interaction(x)),
            "call_ms": cuda_ms(lambda: ops.dot_interaction(x), device_only=False),
            "plain_ms": cuda_ms(lambda: ref.dot_interaction_ref(x)),
            "library_ms": cuda_ms(lib), "library_call": "bmm, then triangle gather",
            "bound_ms": b_ms, "bound_by": b_by}


def run_dot_bwd(b: int, gen: torch.Generator, a: Arch, f: int = 0, d: int = 0) -> dict:
    """The backward standalone and through the autograd of
    ``ops.dot_interaction`` (the same kernel on the same inputs: bitwise
    equal), against its plain version."""
    f, d = f or a.n_fields + 1, d or a.dim
    x, g = dot_case(b, gen, f, d)
    got, again = ops.dot_interaction_bwd(x, g), ops.dot_interaction_bwd(x, g)
    exp = ref.dot_interaction_bwd_ref(x, g)
    leaf = x.clone().requires_grad_(True)
    before = ops.launches["dot_interaction_bwd"]
    (g_auto,) = torch.autograd.grad(ops.dot_interaction(leaf), leaf, g)
    via_autograd = ops.launches["dot_interaction_bwd"] - before
    iu, ju = torch.triu_indices(f, f, 1, device=DEV)

    def lib():  # zeros, the triangle scatter, add the transpose, bmm
        gz = torch.zeros((b, f, f), device=DEV)
        gz[:, iu, ju] = g
        return torch.bmm(gz + gz.transpose(1, 2), x)

    torch.cuda.synchronize(DEV)
    err = max_err(got, exp)
    check(err <= TOL * scale_of(exp), f"dot_interaction_bwd err {err} at {(b, f, d)}")
    check(torch.equal(got, again), "dot_interaction_bwd repeats bit for bit")
    check(via_autograd == 1 and torch.equal(g_auto, got),
          "the autograd backward of dot_interaction launches the same kernel")
    check(max_err(lib(), exp) <= TOL * scale_of(exp), "scatter + bmm yardstick agrees")
    p = f * (f - 1) // 2
    b_ms, b_by = bound((2 * b * f * d + b * p) * 4, 2 * b * f * (f - 1) * d)
    return {"n": b, "f": f, "d": d, "p": p, "max_abs_err": err,
            "max_err_of_scale": err / scale_of(exp),
            "ms": cuda_ms(lambda: ops.dot_interaction_bwd(x, g)),
            "call_ms": cuda_ms(lambda: ops.dot_interaction_bwd(x, g), device_only=False),
            "plain_ms": cuda_ms(lambda: ref.dot_interaction_bwd_ref(x, g)),
            "library_ms": cuda_ms(lib),
            "library_call": "zeros, triangle scatter, add transpose, bmm",
            "bound_ms": b_ms, "bound_by": b_by}


# (B, F, D) edge shapes of the two dot kernels: a single pair with a block
# of many samples and a B that is no multiple of it, an odd D, one field
DOT_EDGES = ((1000, 2, 3), (333, 27, 127), (77, 5, 1), (9, 1, 8))


def run_dot_edges(gen: torch.Generator) -> dict:
    out = {}
    for b, f, d in DOT_EDGES:
        x, g = dot_case(b, gen, f, d)
        fwd, rfwd = ops.dot_interaction(x), ref.dot_interaction_ref(x)
        bwd, rbwd = ops.dot_interaction_bwd(x, g), ref.dot_interaction_bwd_ref(x, g)
        torch.cuda.synchronize(DEV)
        errs = (max_err(fwd, rfwd) / scale_of(rfwd), max_err(bwd, rbwd) / scale_of(rbwd))
        check(fwd.shape == rfwd.shape and max(errs) <= TOL, f"dot edge {(b, f, d)}: {errs}")
        check(torch.equal(bwd, ops.dot_interaction_bwd(x, g)), f"dot_bwd repeats {(b, f, d)}")
        out[f"{b}x{f}x{d}"] = errs
    return out


# the forward's plan boundaries: a single pair and full width, rows of one,
# three (4-byte copies, a padded column group), 16, 128 and 129 floats, one
# sample, a B that is no multiple of a ring buffer's samples, and B just
# past 65,536 (the most samples a buffer takes)
DOT_FWD_F, DOT_FWD_D, DOT_FWD_B = (2, 27), (1, 3, 16, 128, 129), (1, 37, 65_537)


def run_dot_fwd_plans(gen: torch.Generator) -> dict:
    """``dot_interaction`` at every (B, F, D) of the three sets: within 1e-5
    of scale of the plain version, a second call bitwise the first.
    Returns each shape's plan and error."""
    out = {}
    for f in DOT_FWD_F:
        for d in DOT_FWD_D:
            for b in DOT_FWD_B:
                x, _ = dot_case(b, gen, f, d)
                got, again = ops.dot_interaction(x), ops.dot_interaction(x)
                exp = ref.dot_interaction_ref(x)
                torch.cuda.synchronize(DEV)
                err = max_err(got, exp) / scale_of(exp)
                check(got.shape == exp.shape and err <= TOL, f"dot fwd {(b, f, d)}: {err}")
                check(same_bits(got, again), f"dot fwd repeats {(b, f, d)}")
                out[f"{b}x{f}x{d}"] = {"plan": ops.dot_fwd_plan(b, f, d), "err": err}
                del x, got, again, exp
    return out


# ------------------------------------------------------------------ phase 3


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):  # EmbeddingState / CacheState
        return type(tree)(*(to_device(v, dev) for v in tree))
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def routed(engine, ctx):
    """The lookup ctxs that carry the Shuffle's routing (and tier hits):
    those of the groups whose strategy has ``uses_routing_ctx``, as the
    reference gates them (a ``ps`` ctx has neither)."""
    return [c for gid, c in ctx.ctxs.items() if engine.strategies[gid].uses_routing_ctx]


def warm_tier(serve, state, cfg, rng, n_requests: int):
    """The reference's FCounter warm-up, then one flush loads the L1 tiers
    (of the groups whose strategy reads one)."""
    for _ in range(n_requests):
        _, ctx = serve.score(state, make_batch(cfg, serve.global_batch, rng))
        for gid, c in ctx.ctxs.items():
            if serve.engine.strategies[gid].uses_routing_ctx:
                pe.count_frequencies(state["emb"][str(gid)].counts, c)
    state["emb"] = serve.engine.flush(state["emb"])


def hits_of(engine, ctx) -> int:
    """Ids served by any tier (L1 + L2)."""
    return int(sum(int(pe.cache_hit_count(c)) + int(pe.l2_hit_count(c))
                   for c in routed(engine, ctx)))


def l2_hits_of(engine, ctx) -> int:
    return int(sum(int(pe.l2_hit_count(c)) for c in routed(engine, ctx)))


def inert_tiers(engine, emb) -> Dict[int, list]:
    """Copies of the tiers the engine gates off (a ``ps`` group's budgeted
    tier), to show that no flush or update touches them."""
    return {gid: [t.clone() for t in emb[str(gid)].cache]
            for gid, on in engine.cache_on.items() if not on}


def check_inert(emb, before: Dict[int, list], what: str) -> None:
    check(all(same_bits(x, y) for gid, ts in before.items()
              for x, y in zip(ts, emb[str(gid)].cache)),
          f"{what}: the tiers of the groups without one untouched")


def check_full_plan(a: Arch, plan, b: int, train: bool = False) -> None:
    """One packed group with the arch's table, tiers and master width; or
    with ``--no-packing`` one group a field, the tables summing to the
    arch's rows, the assignment mixed as ``a.mix`` says and equal to
    ``compile_assignment``'s, the picasso groups' tiers summing to
    ``a.hot_rows``."""
    if not a.packing:
        gs = plan.groups
        asg = compile_assignment(plan, per_device_batch=None if train else b).strategy
        cached = [g.gid for g in gs if plan.strategy[g.gid] == "picasso"]
        mix = dict(Counter(plan.strategy.values()))
        check(len(gs) == a.n_fields and sum(g.rows for g in gs) == a.rows
              and {g.dim for g in gs} == {a.dim} and mix == dict(a.mix)
              and asg == plan.strategy
              and sum(plan.cache_rows[gid] for gid in cached) == a.hot_rows,
              f"full {a.name} plan: {len(gs)} groups, {sum(g.rows for g in gs)} rows, "
              f"mix {mix}, tiers {sum(plan.cache_rows[gid] for gid in cached)}")
        return
    g = plan.groups[0]
    check(len(plan.groups) == 1 and (g.rows, g.dim) == (a.rows, a.dim)
          and plan.cache_rows[0] == a.hot_rows and plan.l2_rows.get(0, 0) == a.l2_rows
          and plan.narrow_width(0) == a.master_dim,
          f"full {a.name} plan: {[(x.rows, x.dim) for x in plan.groups]} {plan.cache_rows} "
          f"{plan.l2_rows} width {plan.narrow_width(0)}")


def tier_keys_of(st, rows: int) -> Dict[str, int]:
    out = {"l1": int((st.cache.keys < rows).sum())}
    if st.l2 is not None:
        out["l2"] = int((st.l2.keys < rows).sum())
    return out


def tier_keys_all(engine, emb) -> Dict[str, int]:
    """Tier keys loaded, summed over the groups whose L1 tier is on."""
    out: Dict[str, int] = {}
    for g in engine.plan.groups:
        if engine.cache_on[g.gid]:
            for k, v in tier_keys_of(emb[str(g.gid)], g.rows).items():
                out[k] = out.get(k, 0) + v
    return out


def serve_full_width(arch: str, pin: bool = False) -> dict:
    """``pin`` (phase 16): the state's ``pinned_leaves`` go to pinned host
    memory before anything runs, the peak counts from there, and the plain
    path must refuse the host-resident leaves instead of running."""
    a = ARCHS[arch]
    cfg, plan = arch_plan(a, SERVE_B)
    check_full_plan(a, plan, SERVE_B)
    model = WDLModel(cfg, plan)
    torch.cuda.reset_peak_memory_stats(DEV)
    t0 = time.perf_counter()
    state = init_state(model, plan, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    torch.cuda.synchronize(DEV)
    init_s = time.perf_counter() - t0
    placed = pin_state(state, plan, f"{arch} serve") if pin else None
    serve = make_serve_step(model, plan, SERVE_B,
                            ServeConfig(strategy=a.strategy, use_fused_kernels="auto"), DEV)
    rng = np.random.default_rng(SEED)
    inert = inert_tiers(serve.engine, state["emb"])
    t0 = time.perf_counter()
    warm_tier(serve, state, cfg, rng, 8)
    torch.cuda.synchronize(DEV)
    warm_s = time.perf_counter() - t0
    check_inert(state["emb"], inert, f"{arch} warm-up flush")
    tier_keys = tier_keys_all(serve.engine, state["emb"])
    full_tiers = fill_tiers(serve.engine, state, a, SEED + 3) if a.full_tiers_first else None
    batches = [make_batch(cfg, SERVE_B, rng) for _ in range(a.n_requests)]

    ops.reset_launches()
    lat, hits, l2_hits, probs, all_probs = [], [], [], None, []
    for b in batches:
        t0 = time.perf_counter()
        probs, ctx = serve.score(state, b)
        torch.cuda.synchronize(DEV)
        lat.append((time.perf_counter() - t0) * 1e3)
        hits.append(hits_of(serve.engine, ctx))
        l2_hits.append(l2_hits_of(serve.engine, ctx))
        all_probs.append(probs)
    launches, host_launches = dict(ops.launches), dict(ops.host_launches)
    if a.strategy == "ps":
        # the packed ps group's rows are per position: segment_grad runs
        # over all B x fields of them along the identity order
        c = ctx.ctxs[0]
        check(c.inv.shape[0] == SERVE_B * a.n_fields
              and torch.equal(c.order, torch.arange(c.inv.shape[0], device=DEV)),
              f"{arch}: the ctx carries the identity order over B x fields positions")

    check(tuple(probs.shape) == (SERVE_B, 1) and bool(torch.isfinite(probs).all()),
          "full-width probabilities finite [B, 1]")
    want = {**a.serve_launches, **({"host_rows": 1} if pin else {})}
    check(launches == {n: want.get(n, 0) * a.n_requests for n in launches},
          f"{arch} serving launches per request {want}: {launches}")
    check(host_launches == {n: (PIN_SERVE_LAUNCHES.get(n, 0) * a.n_requests if pin else 0)
                            for n in host_launches},
          f"{arch} serving launches on host operands: {host_launches}")
    check(min(hits) > 0 if serve.engine.any_cache else max(hits) == 0,
          f"cache hits on every request (none without a tier): {hits}")
    check(not a.full_tiers_first or min(l2_hits) > 0, f"L2 hits on every request: {l2_hits}")
    plain = make_serve_step(model, plan, SERVE_B,
                            ServeConfig(strategy=a.strategy, use_fused_kernels="off"), DEV)
    if pin:
        # the plain versions compute on the card and refuse a host leaf
        try:
            plain(state, batches[-1])
            refused = None
        except ValueError as e:
            refused = str(e)
        check(refused is not None and "host-resident" in refused,
              f"the plain path refuses the host-resident leaves: {refused}")
        err = None
    else:
        p_plain = plain(state, batches[-1])
        torch.cuda.synchronize(DEV)
        err = max_err(probs, p_plain)
        check(err <= TOL, f"kernel vs plain probabilities err {err}")
    breakdown = where_time_goes(serve, state, batches[:10])
    out = {"arch": arch, "strategy": a.strategy, "table": [a.rows, a.master_dim],
           "groups": len(plan.groups), "assignment": dict(a.mix) or None,
           "hot_rows": a.hot_rows, "l2_rows": plan.l2_rows.get(0, 0),
           "capacity": plan.capacity[0], "tier_keys_loaded": tier_keys,
           "init_s": init_s, "warmup_and_flush_s": warm_s,
           "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
           "mean_ms": float(np.mean(lat)), "max_ms": float(np.max(lat)),
           "timed_requests": len(lat), "mean_prob": float(probs.mean()),
           "cache_hits_per_request": float(np.mean(hits)),
           "l2_hits_per_request": float(np.mean(l2_hits)),
           "ids_per_request": SERVE_B * a.n_fields, "launches": launches,
           "launches_per_request": {n: v / a.n_requests for n, v in launches.items() if v},
           "plain_vs_kernel_max_abs_err": err,
           "peak_mem_gib": torch.cuda.max_memory_allocated(DEV) / 2**30,
           "where_time_goes": breakdown,
           # every request's probabilities (phase 16 holds its own to them)
           "_probs": torch.stack(all_probs).cpu()}
    if pin:
        out.update(pinned=placed, host_launches=host_launches,
                   plain_refused=refused[:160])
    if full_tiers:
        out["full_tiers"] = full_tiers
    elif a.l2_rows:
        out["full_tiers"] = serve_full_tiers(serve, plain, state, batches[:5], a)
    del state, serve, plain
    torch.cuda.empty_cache()
    return out


def fill_counts(state, seed: int) -> None:
    """An FCounter count of 1-3 on every row (ties by row id), so the next
    flush fills both tiers: all 4,194,304 L1 and 48,806,440 L2 keys. The
    8 warm-up requests or 20 steps cannot: their distinct ids fit in L1."""
    counts = state["emb"]["0"].counts
    counts.copy_(torch.randint(1, 4, counts.shape, dtype=counts.dtype, device=DEV,
                               generator=torch.Generator(device=DEV).manual_seed(seed)))


def fill_tiers(engine, state, a: Arch, seed: int) -> dict:
    """A flush from a full FCounter (timed) fills both tiers to the plan."""
    fill_counts(state, seed)
    torch.cuda.synchronize(DEV)
    t0 = time.perf_counter()
    state["emb"] = engine.flush(state["emb"])
    torch.cuda.synchronize(DEV)
    flush_s = time.perf_counter() - t0
    keys = tier_keys_of(state["emb"]["0"], a.rows)
    check(keys == {"l1": a.hot_rows, "l2": a.l2_rows}, f"both tiers full: {keys}")
    return {"flush_s": flush_s, "tier_keys": keys}


def serve_full_tiers(serve, plain, state, batches, a: Arch) -> dict:
    """The L2 tier at its full size: a flush from a full FCounter (timed),
    then requests that take L2 hits, each held against the plain path."""
    out = fill_tiers(serve.engine, state, a, SEED + 3)
    l2, err = [], 0.0
    for b in batches:
        probs, ctx = serve.score(state, b)
        l2.append(l2_hits_of(serve.engine, ctx))
        err = max(err, max_err(probs, plain(state, b)))
    torch.cuda.synchronize(DEV)
    check(min(l2) > 0 and err <= TOL, f"full tiers: L2 hits {l2}, plain err {err}")
    return {**out, "l2_hits": l2, "plain_vs_kernel_max_abs_err": err}


def port_kernels(per_kernel: Dict[str, float]) -> Dict[str, float]:
    """The profiled device ms of the port's own kernels (``csrc``'s, in
    anonymous namespaces, or an earlier version's ``segment_pool``), by
    kernel name."""
    out = {}
    for key, ms in per_kernel.items():
        m = re.search(r"(?:\(anonymous namespace\)|segment_pool)::(\w+_kernel(?:<\d+>)?)", key)
        if m and "at::" not in key:
            out[m.group(1)] = out.get(m.group(1), 0.0) + ms
    return out


def where_time_goes(serve, state, batches) -> dict:
    """Per-layer host clock (pack -> sparse lookup + pool -> dense), each
    ended by a synchronize, and one profiled window for device time by op."""
    from torch.profiler import ProfilerActivity, profile

    layers = {"pack_ms": [], "sparse_ms": [], "dense_ms": []}
    for b in batches:
        t0 = time.perf_counter()
        packed, side = serve.pack(b)
        torch.cuda.synchronize(DEV)
        t1 = time.perf_counter()
        pooled, _ = serve.sparse(state, packed)
        torch.cuda.synchronize(DEV)
        t2 = time.perf_counter()
        serve.dense(state, pooled, side)
        torch.cuda.synchronize(DEV)
        t3 = time.perf_counter()
        for k, v in zip(layers, (t1 - t0, t2 - t1, t3 - t2)):
            layers[k].append(v * 1e3)
    out = {k: float(np.median(v)) for k, v in layers.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches:
            serve(state, b)
        torch.cuda.synchronize(DEV)
    # kernel-level events only: an aten op's device time is its kernels'
    # (key_averages is built once: on deepfm-mixed it takes seconds)
    events = prof.key_averages()
    per_kernel = {e.key: e.self_device_time_total / 1e3 / len(batches)
                  for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0}
    dev_ms = float(sum(per_kernel.values())) if per_kernel else None
    out["device_ms_per_request"] = dev_ms
    out["kernels_per_request"] = (sum(e.count for e in events
                                      if e.device_type == torch.autograd.DeviceType.CUDA)
                                  / len(batches))
    out["device_busy_share"] = (dev_ms / (out["pack_ms"] + out["sparse_ms"] + out["dense_ms"])
                                if dev_ms else None)
    out["top_kernels_ms_per_request"] = sorted(
        ((k[:70], v) for k, v in per_kernel.items()), key=lambda kv: -kv[1])[:8]
    out["port_kernels_ms_per_request"] = port_kernels(per_kernel)
    return out


def smoke_against_cpu(arch: str) -> dict:
    """The arch's smoke config with warm tiers: the card's kernel path
    against the CPU's plain path on the same state and request."""
    a = ARCHS[arch]
    b = 64
    cfg, plan = arch_plan(a, b, smoke=True)
    model = WDLModel(cfg, plan)
    cpu = torch.device("cpu")
    state = init_state(model, plan, torch.Generator().manual_seed(SEED), cpu)
    serve_cpu = make_serve_step(model, plan, b, ServeConfig(strategy=a.strategy), cpu)
    rng = np.random.default_rng(SEED + 1)
    warm_tier(serve_cpu, state, cfg, rng, 4)
    batch = make_batch(cfg, b, rng)
    p_cpu, ctx_cpu = serve_cpu.score(state, batch)
    ops.reset_launches()
    serve_gpu = make_serve_step(model, plan, b,
                                ServeConfig(strategy=a.strategy, use_fused_kernels="on"), DEV)
    p_gpu, ctx_gpu = serve_gpu.score(to_device(state, DEV), batch)
    err = max_err(p_gpu.cpu(), p_cpu)
    check(err <= TOL, f"smoke card vs CPU probabilities err {err}")
    eng = serve_gpu.engine
    hits, l2_hits = hits_of(eng, ctx_gpu), l2_hits_of(eng, ctx_gpu)
    check(hits == hits_of(serve_cpu.engine, ctx_cpu) and (hits > 0) == eng.any_cache
          and l2_hits == l2_hits_of(serve_cpu.engine, ctx_cpu)
          and (l2_hits > 0 or not a.l2_bytes),
          "smoke cache hits (L1 + L2, and L2) equal, and > 0 where a tier is on")
    check(all(ops.launches[n] > 0 for n in a.serve_launches),
          f"smoke request on the card went through the kernels: {ops.launches}")
    return {"max_abs_err": err, "cache_hits": hits, "l2_hits": l2_hits}


# ------------------------------------------------------------------ phase 4


def clone(tree):
    """A copy of a train state whose tensors share no storage with it."""
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):  # EmbeddingState / CacheState
        return type(tree)(*(clone(v) for v in tree))
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


class HopRecorder:
    """Records, during one train step, each compressed routed hop (the rows
    going in, the payload, the rows coming out) by wrapping
    ``grad_compression.compress_rows``/``decompress_rows``, and with
    ``check_rows`` each master update by wrapping ``pe._dedup_apply``: the
    touched rows it wrote against the plain dedup + Adagrad of the same rows
    from the same state and gradient, as a share of their scale."""

    def __init__(self, check_rows: bool):
        self.hops, self.row_errs, self.check_rows = [], [], check_rows
        self.orig = (gcomp.compress_rows, gcomp.decompress_rows, pe._dedup_apply)

    def compress(self, g, mode, fused=None):
        payload = self.orig[0](g, mode, fused=fused)
        self.hops.append([mode, g, payload])
        return payload

    def decompress(self, payload, d, mode, fused=None):
        out = self.orig[1](payload, d, mode, fused=fused)
        self.hops[-1].append(out)
        return out

    def dedup_apply(self, w, acc, idx, g, valid, lr, eps, fused=None):
        keep = valid & (idx >= 0) & (idx < w.shape[0])
        touched = torch.unique(idx[keep].long())
        w_p, acc_p = w[touched], acc[touched]  # copies of the rows before
        out = self.orig[2](w, acc, idx, g, valid, lr, eps, fused)
        if touched.numel():
            local = torch.searchsorted(touched, idx.long()).clamp(max=touched.numel() - 1)
            ref.dedup_adagrad_ref(w_p, acc_p, local.to(torch.int32), g, keep, lr, eps)
            self.row_errs.append(max(max_err(w[touched], w_p) / scale_of(w_p),
                                     max_err(acc[touched], acc_p) / scale_of(acc_p)))
        return out

    def __enter__(self):
        gcomp.compress_rows, gcomp.decompress_rows = self.compress, self.decompress
        if self.check_rows:
            pe._dedup_apply = self.dedup_apply
        return self

    def __exit__(self, *exc):
        gcomp.compress_rows, gcomp.decompress_rows, pe._dedup_apply = self.orig


def check_hops(kernel: HopRecorder, plain: HopRecorder) -> dict:
    """The kernel step's payloads and rows against the plain versions on
    the same rows, bitwise, zero rows exactly 0 out, every master update
    within 1e-6 of scale; beside them, whether the plain step's own hops
    (from its own, last-bit different, gradients) came out the same."""
    check(kernel.hops and len(kernel.hops) == len(plain.hops),
          f"compressed hops: {len(kernel.hops)} kernel, {len(plain.hops)} plain")
    for mode, g, payload, out in kernel.hops:
        ref_payload = kernel.orig[0](g, mode, fused=False)
        check(all(same_bits(a, b) for a, b in zip(payload, ref_payload)),
              f"{mode} payload of the step bitwise the plain version's")
        check(same_bits(out, kernel.orig[1](ref_payload, g.shape[1], mode, fused=False)),
              f"{mode} rows of the step bitwise the plain roundtrip")
        zero = (g == 0).all(1)
        check(bool(zero.any()) and not out[zero].any(), f"{mode} zero rows exactly 0")
    err = max(kernel.row_errs)
    check(err <= 1e-6, f"touched master rows, kernel vs plain update: {err} of scale")
    same = [all(same_bits(a, b) for a, b in zip(k[2], p[2]))
            for k, p in zip(kernel.hops, plain.hops)]
    return {"hops": len(kernel.hops), "rows": [h[1].shape[0] for h in kernel.hops],
            "zero_rows": [int((h[1] == 0).all(1).sum()) for h in kernel.hops],
            "touched_rows_err_of_scale": err,
            "plain_step_payload_bitwise": same,
            "plain_step_rows_max_abs_diff": [max_err(k[3], p[3])
                                             for k, p in zip(kernel.hops, plain.hops)]}


def shared_state_check(model, plan, step, state, batch) -> dict:
    """One step on the kernel path and one on the plain path, each from its
    own copy of ``state`` on the same batch: the loss to rtol 1e-5, every
    dense gradient to 1e-5 of its leaf's largest entry and, for a narrow
    master, the projection after the sparse backward to 1e-5 of its scale.
    Under ``grad_compress`` the kernel step's compressed hops must equal the
    plain versions on the same rows bit for bit and its master updates the
    plain update to 1e-6 of scale (``check_hops``). The dense stage's
    outputs are read through a wrapper around ``TrainStep.dense``."""
    plain = ts.make_train_step(model, plan, TRAIN_B,
                               dataclasses.replace(step.tcfg, use_fused_kernels="off"), DEV)
    seen, projs, hops = {}, {}, {}
    for name, st in (("kernel", step), ("plain", plain)):
        def dense(*args, _orig=st.dense, _name=name):
            seen[_name] = _orig(*args)
            return seen[_name]

        st.dense = dense
        try:
            copy = clone(state)
            with HopRecorder(check_rows=name == "kernel") as hops[name]:
                st(copy, batch)
            projs[name] = [e.proj.kernel for e in copy["emb"].values() if e.proj is not None]
            del copy
        finally:
            del st.dense
    torch.cuda.synchronize(DEV)
    (lk, gk, pk), (lp, gp, pp) = seen["kernel"], seen["plain"]
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    check(loss_rel <= 1e-5, f"shared-state loss kernel {float(lk)} vs plain {float(lp)}")
    leaf_err = {}
    for path, a, b in zip(leaf_names(gp), tree_leaves(gk), tree_leaves(gp)):
        top = float(b.abs().max())
        leaf_err[path] = max_err(a, b) / top if top > 0 else max_err(a, b)
        check(leaf_err[path] <= TOL, f"shared-state dense gradient {path}: "
              f"{leaf_err[path]} of its largest entry")
    pooled_err = max(max_err(pk[k], pp[k]) / max(float(pp[k].abs().max()), 1e-30)
                     for k in pp)
    proj_err = None
    if projs["plain"]:
        proj_err = max(max_err(a, b) / scale_of(b)
                       for a, b in zip(projs["kernel"], projs["plain"]))
        check(proj_err <= TOL, f"shared-state projection {proj_err} of its scale")
    compressed = (check_hops(hops["kernel"], hops["plain"])
                  if step.tcfg.grad_compress != "none" else None)
    del projs, hops
    torch.cuda.empty_cache()
    return {"loss_kernel": float(lk), "loss_plain": float(lp), "loss_rel_diff": loss_rel,
            "max_dense_grad_rel_err": max(leaf_err.values()),
            "worst_leaf": max(leaf_err, key=leaf_err.get),
            "pooled_grad_rel_err": pooled_err, "proj_err_of_scale": proj_err,
            "compressed_hops": compressed}


def leaf_names(tree, prefix=""):
    """Dotted paths of a nested dict's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in tree for p in leaf_names(tree[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


def train_run(arch: str, fused: str, batches, breakdown: bool = False,
              check_at: Tuple[int, ...] = (), pin: bool = False,
              digest_at: Tuple[int, ...] = (), keep: bool = False) -> dict:
    """30 full-width training steps from seed 0; the state is freed after.
    Before each step in ``check_at`` (1-based) the shared-state check runs on
    copies, outside the timed step, and leaves this run's state alone; after
    each step in ``digest_at`` the state's digest is taken. ``pin`` (phase
    16) trains under ``TrainConfig(pin_l2=True)`` with the state's
    ``pinned_leaves`` placed in pinned host memory before the first step,
    the peak memory counted from there (and read again before the flush).
    ``keep`` returns the trained state and the step under ``_state`` and
    ``_step`` instead of freeing them."""
    a = ARCHS[arch]
    cfg, plan = arch_plan(a, TRAIN_B, train=True)
    model = WDLModel(cfg, plan)
    torch.cuda.reset_peak_memory_stats(DEV)
    state = ts.init_state(model, plan, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    placed = pin_state(state, plan, f"{arch} train") if pin else None
    step = ts.make_train_step(model, plan, TRAIN_B,
                              ts.TrainConfig(strategy=a.strategy, use_fused_kernels=fused,
                                             grad_compress=a.grad_compress, pin_l2=pin),
                              DEV)
    torch.cuda.synchronize(DEV)
    inert = inert_tiers(step.engine, state["emb"])
    ops.reset_launches()
    lat, losses, hits, l2_hits, ps_hits, ovf, checks = [], [], [], [], [], [], {}
    digests, peak_before_flush = {}, None
    for i, b in enumerate(batches[:TRAIN_STEPS], start=1):
        if i in check_at:
            checks[i] = shared_state_check(model, plan, step, state, b)
        if i == FLUSH_ITERS:
            peak_before_flush = torch.cuda.max_memory_allocated(DEV) / 2**30
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize(DEV)
        lat.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        hits.append(int(m["cache_hits"]))
        l2_hits.append(int(m.get("cache_hits/l2", 0)))
        ps_hits.append(int(m.get("cache_hits/ps", 0)))
        ovf.append(int(m["overflow"]))
        if i in digest_at:
            digests[i] = state_digest(state)
    out = {"launches": dict(ops.launches), "sorts": dict(ops.sorts), "lat": lat,
           "losses": losses, "hits": hits, "any_cache": step.engine.any_cache,
           "metric_keys": list(step.engine.metric_keys), "ps_hits": ps_hits,
           "l2_hits": l2_hits, "overflow": ovf, "shared_state_checks": checks,
           "digests": digests, "host_launches": dict(ops.host_launches),
           "peak_before_flush_gib": peak_before_flush, "pinned": placed}
    if pin:  # the placement held across the steps and the flush
        check_placement(state, plan, f"{arch} after {TRAIN_STEPS} pinned steps")
    # a ps group's budgeted tier: no update and no flush (step 20) touches it
    check_inert(state["emb"], inert, f"{arch} training")
    if breakdown:
        out["stages"] = train_breakdown(step, state, batches[TRAIN_STEPS:])
        if a.l2_rows:
            out["full_tiers"] = train_full_tiers(step, state, batches[TRAIN_STEPS + 9:], a)
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated(DEV) / 2**30
    if keep:
        out["_state"], out["_step"] = state, step
    del state, step
    torch.cuda.empty_cache()
    return out


def train_full_tiers(step, state, batches, a: Arch) -> dict:
    """After step 39: a flush from a full FCounter fills both tiers (timed),
    then steps 40-42 take L2 hits (``dedup_adagrad`` on real L2 rows); step
    40's in-step flush writes the full tiers back through the projection's
    pseudo-inverse and carries the resident ids (timed with its step)."""
    check(state["step"] == TRAIN_STEPS + 9, f"full tiers start after step 39: {state['step']}")
    full = fill_tiers(step.engine, state, a, SEED + 4)
    lat, losses, l2 = [], [], []
    for b in batches[:3]:
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize(DEV)
        lat.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        l2.append(int(m["cache_hits/l2"]))
    check(all(np.isfinite(losses)) and min(l2) > 0,
          f"full tiers: losses {losses}, L2 hits {l2}")
    return {"fill_flush_s": full["flush_s"], "tier_keys": full["tier_keys"], "step_ms": lat,
            "flush_step": TRAIN_STEPS + 10, "losses": losses, "l2_hits": l2,
            "tier_keys_after_flush": tier_keys_of(state["emb"]["0"], a.rows)}


def train_breakdown(step, state, batches) -> dict:
    """Steps 31-35 under the profiler (device time by kernel), then steps
    36-39 with the clock read after each named stage (each ended by a
    synchronize). None of them flushes: the next flush is step 40."""
    from torch.profiler import ProfilerActivity, profile

    prof_batches, stage_batches = batches[:5], batches[5:9]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in prof_batches:
            step(state, b)
        torch.cuda.synchronize(DEV)
    stages, last = {}, [0.0]

    def mark(name):
        torch.cuda.synchronize(DEV)
        now = time.perf_counter()
        stages.setdefault(name, []).append((now - last[0]) * 1e3)
        last[0] = now

    step.on_stage = mark
    for b in stage_batches:
        last[0] = time.perf_counter()
        step(state, b)
    step.on_stage = None
    out = {f"{k}_ms": float(np.median(v)) for k, v in stages.items()}
    host_ms = sum(out.values())
    events = prof.key_averages()  # built once, as in where_time_goes
    per_kernel = {e.key: e.self_device_time_total / 1e3 / len(prof_batches)
                  for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0}
    dev_ms = float(sum(per_kernel.values())) if per_kernel else None
    out["host_ms_per_step"] = host_ms
    out["device_ms_per_step"] = dev_ms
    out["kernels_per_step"] = (sum(e.count for e in events
                                   if e.device_type == torch.autograd.DeviceType.CUDA)
                               / len(prof_batches))
    out["device_busy_share"] = dev_ms / host_ms if dev_ms else None
    out["top_kernels_ms_per_step"] = sorted(
        ((k[:70], v) for k, v in per_kernel.items()), key=lambda kv: -kv[1])[:10]
    out["port_kernels_ms_per_step"] = port_kernels(per_kernel)
    return out


def train_full_width(arch: str) -> dict:
    a = ARCHS[arch]
    cfg, plan = arch_plan(a, TRAIN_B, train=True)
    check_full_plan(a, plan, TRAIN_B, train=True)
    # one K-Interleaving wave a packed group
    check(plan.microbatch == TRAIN_B and len(plan.interleave) == len(plan.groups),
          f"full {arch} train plan: {plan.microbatch} {plan.interleave}")
    stream = batch_stream(cfg, TRAIN_B, seed=SEED)
    batches = [next(stream) for _ in range(TRAIN_STEPS + 12)]
    k = train_run(arch, "auto", batches, breakdown=True,
                  digest_at=PIN_DIGEST_AT if arch == PIN_ARCH else ())
    launches = k["launches"]
    check(all(np.isfinite(k["losses"])), f"finite losses: {k['losses']}")
    check(launches == {n: a.train_launches.get(n, 0) * TRAIN_STEPS for n in launches},
          f"{arch} training launches per step {a.train_launches}: {launches}")
    # segment_grad runs along the forward unique's sort: no sort of its own
    check(k["sorts"]["segment_grad"] == 0, f"{arch} training sorted for segment_grad: "
          f"{k['sorts']}")
    check((min(k["hits"][FLUSH_ITERS:]) > 0 if k["any_cache"] else max(k["hits"]) == 0)
          and max(k["hits"][:FLUSH_ITERS]) == 0,
          f"tier hits exactly on the steps after the step-{FLUSH_ITERS} flush (none "
          f"without a tier): {k['hits']}")
    # a mix breaks the hits down by class: every one a picasso group's
    check(max(k["ps_hits"]) == 0 and (not a.mix or "cache_hits/ps" in k["metric_keys"]),
          f"{arch}: cache_hits/ps {k['ps_hits']}, metric keys {k['metric_keys']}")
    # the kernels sum in a fixed order, so the kernel path repeats itself;
    # the second run also holds one kernel step against one plain step from
    # a shared state where the arch asks (dcn-v2: before step 1 and before
    # the first step after the flush)
    k2 = train_run(arch, "auto", batches, check_at=a.shared_state_at)
    check(k2["losses"] == k["losses"] and k2["hits"] == k["hits"],
          "a second kernel run repeats the first bit for bit")
    check(k2["sorts"]["segment_grad"] == 0, f"{arch} second run sorted: {k2['sorts']}")
    # The plain versions' index_add_ sums with atomics, in an order that can
    # change from run to run, and past the flush this model amplifies any
    # last-bit difference by orders of magnitude within a few steps
    # (scripts/torch_train_divergence.py measures it). Deterministic
    # algorithms fix the plain path's order, so the comparison below holds
    # the kernels against one reproducible plain trajectory.
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        p = train_run(arch, "off", batches)
    finally:
        torch.use_deterministic_algorithms(False)
    check(all(v == 0 for v in p["launches"].values()), f"plain run launched: {p['launches']}")
    diff = np.abs(np.array(k["losses"]) - np.array(p["losses"]))
    if a.trajectory_bar:
        check(np.allclose(k["losses"], p["losses"], rtol=1e-4, atol=1e-5),
              f"kernel vs plain loss trajectory: {k['losses']} vs {p['losses']}")
    check(k["hits"] == p["hits"] and k["overflow"] == p["overflow"],
          "kernel vs plain hits and overflow equal")
    lat = np.array(k["lat"])
    steady = np.array([t for i, t in enumerate(lat, start=1)
                       if i > WARMUP_ITERS and i != FLUSH_ITERS])
    return {"arch": arch, "strategy": a.strategy, "table": [a.rows, a.master_dim],
            "groups": len(plan.groups), "waves": len(plan.interleave),
            "metric_keys": k["metric_keys"], "cache_hits_ps": k["ps_hits"],
            "hot_rows": a.hot_rows, "l2_rows": plan.l2_rows.get(0, 0),
            "capacity": plan.capacity[0], "batch": TRAIN_B, "steps": TRAIN_STEPS,
            "step_p50_ms": float(np.percentile(steady, 50)),
            "step_p99_ms": float(np.percentile(steady, 99)),
            "step_mean_ms": float(steady.mean()), "steady_steps": int(steady.size),
            "samples_per_s": float(TRAIN_B / (steady.mean() / 1e3)),
            "flush_step_ms": float(lat[FLUSH_ITERS - 1]), "first_step_ms": float(lat[0]),
            "plain_step_p50_ms": float(np.percentile(
                [t for i, t in enumerate(p["lat"], start=1)
                 if i > WARMUP_ITERS and i != FLUSH_ITERS], 50)),
            "step_ms": k["lat"], "losses": k["losses"], "plain_losses": p["losses"],
            "max_abs_loss_diff": float(diff.max()),
            "max_rel_loss_diff": float((diff / np.abs(p["losses"])).max()),
            "shared_state_checks": k2["shared_state_checks"], "hits": k["hits"],
            "l2_hits": k["l2_hits"], "overflow": k["overflow"], "launches": launches,
            "segment_grad_sorts": k["sorts"]["segment_grad"],
            "launches_per_step": {n: v / TRAIN_STEPS for n, v in launches.items() if v},
            "peak_mem_gib": k["peak_mem_gib"], "where_time_goes": k["stages"],
            "full_tiers": k.get("full_tiers"), "peak_before_flush_gib":
            k["peak_before_flush_gib"], "_digests": k["digests"]}


def train_smoke_against_cpu(arch: str) -> dict:
    """The arch's smoke config with a tiny tier flushed at step 3: 8 steps on
    the card's kernels against 8 on the CPU's plain versions, same state and
    batches."""
    a = ARCHS[arch]
    b = 64
    cfg, plan = arch_plan(a, b, smoke=True, train=True)
    model = WDLModel(cfg, plan)
    cpu = torch.device("cpu")
    state_cpu, state_gpu = (
        ts.init_state(model, plan, torch.Generator().manual_seed(SEED), cpu) for _ in "ab")
    state_gpu = to_device(state_gpu, DEV)
    step_cpu = ts.make_train_step(model, plan, b, ts.TrainConfig(strategy=a.strategy), cpu)
    step_gpu = ts.make_train_step(
        model, plan, b, ts.TrainConfig(strategy=a.strategy, use_fused_kernels="on"), DEV)
    rng = np.random.default_rng(SEED + 2)
    lc, lg, hc, hg = [], [], [], []
    for _ in range(8):
        batch = make_batch(cfg, b, rng)
        state_gpu, mg = step_gpu(state_gpu, batch)
        state_cpu, mc = step_cpu(state_cpu, batch)
        lg.append(float(mg["loss"]))
        lc.append(float(mc["loss"]))
        hg.append((int(mg["cache_hits"]), int(mg.get("cache_hits/l2", 0))))
        hc.append((int(mc["cache_hits"]), int(mc.get("cache_hits/l2", 0))))
    check(np.allclose(lg, lc, rtol=1e-4, atol=1e-5), f"smoke train card vs CPU: {lg} vs {lc}")
    check(hg == hc and (min(h for h, _ in hg[3:]) > 0) == step_gpu.engine.any_cache
          and (min(h2 for _, h2 in hg[3:]) > 0 or not a.l2_bytes),
          f"smoke train hits (L1 + L2, L2) equal and > 0 after flush: {hg} {hc}")
    sg, sc = state_gpu["emb"]["0"], state_cpu["emb"]["0"]
    err = max(max_err(state_gpu["emb"][k].w.cpu(), state_cpu["emb"][k].w)
              for k in state_cpu["emb"])
    check(err <= 1e-4, f"smoke train tables card vs CPU err {err}")
    out = {"losses_card": lg, "losses_cpu": lc,
           "max_abs_loss_diff": float(np.max(np.abs(np.array(lg) - np.array(lc)))),
           "table_max_abs_err": err, "hits_and_l2_hits": hg}
    if sc.proj is not None:
        out["proj_max_abs_err"] = max_err(sg.proj.kernel.cpu(), sc.proj.kernel)
        check(out["proj_max_abs_err"] <= 1e-4, f"smoke projection card vs CPU {out}")
    return out


def serve_and_train(arch: str, runs: dict, t_start: float) -> None:
    """Serve then train one configuration at full width, each followed by
    its smoke config on the card against the CPU; its states are freed
    before the next configuration's."""
    t_phase = time.perf_counter()
    marks = {}
    full = runs[arch, "serve"] = serve_full_width(arch)
    wt = full["where_time_goes"]
    print(f"[serve] {arch} full width " + json.dumps(public(full)), flush=True)
    print(f"[serve] {arch} B={SERVE_B}: p50={full['p50_ms']:.3f}ms "
          f"p99={full['p99_ms']:.3f}ms mean_prob={full['mean_prob']:.4f} "
          f"cache_hits/request={full['cache_hits_per_request']:.1f} "
          f"device ms/request={wt['device_ms_per_request']} "
          f"device ops/request={wt['kernels_per_request']} "
          f"peak={full['peak_mem_gib']:.2f}GiB", flush=True)
    marks["serve"] = time.perf_counter() - t_phase
    print(f"[serve] {arch}-smoke card vs CPU " + json.dumps(smoke_against_cpu(arch)),
          flush=True)
    marks["serve_smoke"] = time.perf_counter() - t_phase
    train = runs[arch, "train"] = train_full_width(arch)
    marks["train"] = time.perf_counter() - t_phase
    print(f"[train] {arch} full width " + json.dumps(public(train)), flush=True)
    print(f"[train] {arch} B={TRAIN_B}: step p50={train['step_p50_ms']:.3f}ms "
          f"p99={train['step_p99_ms']:.3f}ms samples/s={train['samples_per_s']:.0f} "
          f"flush step={train['flush_step_ms']:.1f}ms "
          f"kernel vs plain 30-step loss diff={train['max_abs_loss_diff']:.3g} "
          f"device ms/step={train['where_time_goes']['device_ms_per_step']} "
          f"device ops/step={train['where_time_goes']['kernels_per_step']} "
          f"peak={train['peak_mem_gib']:.2f}GiB", flush=True)
    print_step_kernels(arch, train)
    print(f"[train] {arch}-smoke card vs CPU "
          + json.dumps(train_smoke_against_cpu(arch)), flush=True)
    torch.cuda.empty_cache()
    print(f"[wall] {arch} done at {time.perf_counter() - t_start:.1f}s "
          f"(this configuration {time.perf_counter() - t_phase:.1f}s; cumulative s at "
          + ", ".join(f"{k} {v:.1f}" for k, v in marks.items()) + ")", flush=True)


def drive_baselines() -> dict:
    """Phase 13's other names on one packed full-width deepfm train state:
    ``hybrid``, ``mp_nodedup`` (on ``exact_capacity`` plans, as the
    reference's parity runs) and ``allgather_rows`` each serve 10 requests,
    held against the plain path, and take one training step, kernel and
    plain each from its own copy of the state (``shared_state_check``), so
    no name's update reaches the next. Each launches what ``deepfm-ps``
    launches, without a sort."""
    base = ARCHS["deepfm-ps"]
    state, out = None, {}
    for name in BASELINES:
        a = base._replace(name=f"deepfm-{name}", strategy=name,
                          exact_capacity=name == "mp_nodedup")
        cfg, splan = arch_plan(a, SERVE_B)
        _, tplan = arch_plan(a, TRAIN_B, train=True)
        check_full_plan(a, splan, SERVE_B)
        model = WDLModel(cfg, tplan)
        if state is None:
            state = ts.init_state(model, tplan, torch.Generator(device=DEV).manual_seed(SEED),
                                  DEV)
        serve = make_serve_step(model, splan, SERVE_B, ServeConfig(strategy=name), DEV)
        plain = make_serve_step(model, splan, SERVE_B,
                                ServeConfig(strategy=name, use_fused_kernels="off"), DEV)
        rng = np.random.default_rng(SEED + 5)
        batches = [make_batch(cfg, SERVE_B, rng) for _ in range(10)]
        serve(state, batches[0])  # first call outside the counts and the clock
        torch.cuda.synchronize(DEV)
        ops.reset_launches()
        lat = []
        for b in batches:
            t0 = time.perf_counter()
            probs, ctx = serve.score(state, b)
            torch.cuda.synchronize(DEV)
            lat.append((time.perf_counter() - t0) * 1e3)
        launches = dict(ops.launches)
        check(launches == {n: a.serve_launches.get(n, 0) * len(batches) for n in launches},
              f"{name} serving launches per request {a.serve_launches}: {launches}")
        check(sum(int(c.routing.overflow) for c in routed(serve.engine, ctx)) == 0,
              f"{name}: nothing overflows")
        err = max_err(probs, plain(state, batches[-1]))
        check(bool(torch.isfinite(probs).all()) and err <= TOL,
              f"{name} kernel vs plain probabilities err {err}")
        step = ts.make_train_step(model, tplan, TRAIN_B, ts.TrainConfig(strategy=name), DEV)
        tb = next(batch_stream(cfg, TRAIN_B, seed=SEED))
        ops.reset_launches()
        shared = shared_state_check(model, tplan, step, state, tb)
        step_launches, sorts = dict(ops.launches), dict(ops.sorts)
        check(step_launches == {n: a.train_launches.get(n, 0) for n in step_launches}
              and sorts["segment_grad"] == 0,
              f"{name} step launches {a.train_launches}: {step_launches}, sorts {sorts}")
        out[name] = {"capacity": tplan.capacity[0], "request_ms": lat,
                     "p50_ms": float(np.percentile(lat, 50)),
                     "plain_vs_kernel_max_abs_err": err, "mean_prob": float(probs.mean()),
                     "launches_per_request": {n: v / len(batches)
                                              for n, v in launches.items() if v},
                     "launches_per_step": {n: v for n, v in step_launches.items() if v},
                     "shared_state_check": shared}
        print(f"[baseline] {name} full width " + json.dumps(out[name]), flush=True)
        del serve, plain, step
    del state
    torch.cuda.empty_cache()
    return out


def print_step_kernels(arch: str, train: dict) -> None:
    """The device us a training step of each of the port's kernels, from
    the profiled steps of ``train_breakdown`` (phase 4 reads
    fm_interaction_bwd's here)."""
    per = train["where_time_goes"].get("port_kernels_ms_per_step") or {}
    print(f"[trace] {arch} train device us a step: "
          + json.dumps({k: v * 1e3 for k, v in sorted(per.items())}), flush=True)


def kernel_name(mangled: str) -> str:
    """The last name of a mangled ``_ZN...`` kernel symbol, with its integer
    template arguments (a cluster size, lanes, a vector width) as <...>."""
    i, name = mangled.find("_ZN") + 3, mangled
    while 3 <= i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    m = re.match(r"I((?:Li\d+E)+)E", mangled[i:])
    args = re.findall(r"Li(\d+)E", m.group(1)) if m else []
    return name + (f"<{', '.join(args)}>" if args else "")


def ptxas_usage(log: str):
    """``-Xptxas=-v``'s register lines, each after the kernel it is for and
    with its spills where there are any."""
    out, kernel, spill = [], "", ""
    for ln in log.splitlines():
        m = re.search(r"entry function '(\w+)'", ln)
        if m:
            kernel = kernel_name(m.group(1))
        elif "spill stores" in ln:
            spill = "" if ln.strip().startswith("0 bytes stack") else f" ({ln.strip()})"
        elif "registers" in ln:
            out.append(f"{kernel}: {ln.split(':', 1)[-1].strip()}{spill}")
    return out


# ------------------------------------------------------------------ phase 15


def seq_kernels(gen: torch.Generator) -> Dict[str, list]:
    """The four kernels of the sequence paths at their shapes: gather_pool
    and tier_probe at serving's B = 512 and training's B = 256, segment_grad
    (uniform and on the path's own zipf batch, where the 50 position rows
    recur once a sample) and dedup_adagrad on the full table at B = 256; at
    D = 50 (sasrec: gather_pool's float2 lanes, tier_probe's and
    segment_grad's scalar copies) and D = 64 (mind)."""
    out: Dict[str, list] = {"gather_pool": [], "tier_probe": [], "segment_grad": [],
                            "dedup_adagrad": []}
    for arch in SEQ_PATHS:
        a = ARCHS[arch]
        cases = {f"gather_pool {arch} serve": lambda: run_gather_pool(SERVE_B, gen, a),
                 f"gather_pool {arch} train": lambda: run_gather_pool(TRAIN_B, gen, a),
                 f"tier_probe {arch} serve": lambda: run_tier_probe(SERVE_B, gen, a),
                 f"tier_probe {arch} train": lambda: run_tier_probe(TRAIN_B, gen, a),
                 f"segment_grad {arch} train": lambda: run_segment_grad(TRAIN_B, gen, a),
                 f"segment_grad {arch} train zipf": lambda: run_segment_grad(
                     TRAIN_B, gen, a, zipf=True),
                 f"dedup_adagrad {arch} train": lambda: run_dedup_adagrad(TRAIN_B, gen, a)}
        for label, run in cases.items():
            r = run()
            print(f"[kernel] {label} " + json.dumps(r), flush=True)
            name, shape = label.split(" ", 1)
            out[name].append({"label": shape, **r})
        _TABLES.clear()
        torch.cuda.empty_cache()
    return out


def timed(fn, n: int):
    """``n`` calls of ``fn``, each ended by a synchronize: (last result,
    host ms of each)."""
    lat, res = [], None
    for _ in range(n):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(DEV)
        lat.append((time.perf_counter() - t0) * 1e3)
    return res, lat


def retrieval_full_width(arch: str) -> dict:
    """The serve launcher's ``--retrieval`` at full width: the top 10 of
    2^20 candidates (``arange(n) % vocab``, rows of the packed item table)
    for one user, chunked at 65,536 and in one chunk, on the kernels and on
    the plain path, from one state. The ids of all three must be equal, and
    equal to a stable sort of ``max_k <w[c], user_k>`` over every candidate
    computed straight from the table."""
    a = ARCHS[arch]
    cfg = get_config(a.config)
    plan = make_plan(cfg, world=1, per_device_batch=1, enable_cache=False,
                     exact_capacity=True)
    resolve_assignment(plan, "picasso", use_cache=False)
    model = WDLModel(cfg, plan)
    torch.cuda.reset_peak_memory_stats(DEV)
    state = init_state(model, plan, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    user = make_batch(cfg, 1, np.random.default_rng(1))
    cand = torch.arange(RETRIEVAL_N, dtype=torch.int32, device=DEV) % cfg.fields[0].vocab
    steps = {label: make_retrieval_step(
        model, plan, RETRIEVAL_N, RETRIEVAL_K,
        ServeConfig(use_cache=False, use_fused_kernels=fused), score_chunk=chunk, device=DEV)
        for label, chunk, fused in (("chunked", RETRIEVAL_CHUNK, "auto"),
                                    ("unchunked", None, "auto"),
                                    ("plain", RETRIEVAL_CHUNK, "off"))}
    out, res, calls = {"arch": arch, "candidates": RETRIEVAL_N, "top_k": RETRIEVAL_K,
                       "chunk": RETRIEVAL_CHUNK, "capacity_user": plan.capacity[0],
                       "capacity_chunked": steps["chunked"].cand_engine.strategies[0]
                       .capacity[0]}, {}, 0
    ops.reset_launches()
    for label in ("chunked", "unchunked", "plain"):
        if label == "plain":
            launches = dict(ops.launches)
            check(launches == {n: calls if n == "gather_pool" else 0 for n in launches},
                  f"{arch} retrieval: one gather_pool a call (the user tower), no tier: "
                  f"{launches}")
        res[label], lat = timed(lambda: steps[label](state, user, cand), RETRIEVAL_CALLS + 1)
        calls += len(lat)
        out[f"{label}_first_ms"] = lat[0]
        for q in (50, 90, 99):
            out[f"{label}_p{q}_ms"] = float(np.percentile(lat[1:], q))
    out["timed_calls"] = RETRIEVAL_CALLS
    # device time of ten calls each way: what the host clock's p50 is made of
    from torch.profiler import ProfilerActivity, profile
    for label in ("chunked", "unchunked"):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                steps[label](state, user, cand)
            torch.cuda.synchronize(DEV)
        dev = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / 10
        out[f"{label}_device_ms"] = float(dev) if dev > 0 else None
        out[f"{label}_device_busy_share"] = (dev / out[f"{label}_p50_ms"]
                                             if dev > 0 else None)
    u = steps["chunked"].user(state, user)
    exact = torch.amax(state["emb"]["0"].w[cand.long()] @ u.T, dim=-1)
    order = torch.sort(exact, descending=True, stable=True).indices[:RETRIEVAL_K]
    sv, ids = res["chunked"]
    for label in ("unchunked", "plain"):
        check(torch.equal(res[label][1], ids), f"{arch} retrieval {label} ids "
              f"{res[label][1].tolist()} vs chunked {ids.tolist()}")
    check(torch.equal(ids, cand[order]), f"{arch} retrieval ids vs the table's own scores")
    err = max(max_err(sv, exact[order]), max_err(res["unchunked"][0], sv),
              max_err(res["plain"][0], sv))
    check(bool(torch.isfinite(sv).all()) and bool((sv[:-1] >= sv[1:]).all())
          and err <= TOL * scale_of(exact[order]),
          f"{arch} retrieval scores descending, agreeing to 1e-5 of scale: {err}")
    out.update({"user_vectors": list(u.shape), "top_ids": ids.tolist(),
                "top_scores": sv.tolist(), "max_abs_err": err, "launches": launches,
                "peak_mem_gib": torch.cuda.max_memory_allocated(DEV) / 2**30})
    del state, steps, exact
    torch.cuda.empty_cache()
    return out


def paper_against_plain(name: str) -> dict:
    """A paper config at the reference's bench scale (``scale=0.01``): one
    request on the kernels after a warm-up flush and one on the plain path
    from the same state (1e-5), and one training step held against a plain
    step from a shared state (``shared_state_check``), then one step whose
    launches are counted."""
    cfg = PAPER_MODELS[name](scale=0.01)
    plan = make_plan(cfg, world=1, per_device_batch=SERVE_B)
    model = WDLModel(cfg, plan)
    state = init_state(model, plan, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    serve = make_serve_step(model, plan, SERVE_B, ServeConfig(), DEV)
    rng = np.random.default_rng(SEED)
    warm_tier(serve, state, cfg, rng, 4)
    batch = make_batch(cfg, SERVE_B, rng)
    ops.reset_launches()
    probs, ctx = serve.score(state, batch)
    torch.cuda.synchronize(DEV)
    serve_launches = dict(ops.launches)
    plain = make_serve_step(model, plan, SERVE_B, ServeConfig(use_fused_kernels="off"), DEV)
    err = max_err(probs, plain(state, batch))
    n_g = len(plan.groups)
    check(err <= TOL and tuple(probs.shape) == (SERVE_B, cfg.n_tasks)
          and hits_of(serve.engine, ctx) > 0
          and serve_launches["tier_probe"] == serve_launches["gather_pool"] == n_g,
          f"{name}: request kernel vs plain err {err}, launches {serve_launches}")
    del state, serve, plain
    tplan = make_plan(cfg, world=1, per_device_batch=TRAIN_B, flush_iters=FLUSH_ITERS,
                      warmup_iters=WARMUP_ITERS)
    tmodel = WDLModel(cfg, tplan)
    tstate = ts.init_state(tmodel, tplan, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    step = ts.make_train_step(tmodel, tplan, TRAIN_B, ts.TrainConfig(), DEV)
    tb = next(batch_stream(cfg, TRAIN_B, seed=SEED))
    shared = shared_state_check(tmodel, tplan, step, tstate, tb)
    ops.reset_launches()
    tstate, m = step(tstate, tb)
    torch.cuda.synchronize(DEV)
    train_launches = dict(ops.launches)
    check(bool(np.isfinite(float(m["loss"])))
          and all(train_launches[k] == n_g for k in ("tier_probe", "gather_pool",
                                                     "segment_grad", "dedup_adagrad")),
          f"{name}: step loss {float(m['loss'])}, launches {train_launches}")
    return {"config": name, "groups": n_g, "dims": sorted({g.dim for g in plan.groups}),
            "n_tasks": cfg.n_tasks, "request_max_abs_err": err,
            "request_launches": serve_launches, "step_launches": train_launches,
            "step_loss": float(m["loss"]), "shared_state_check": shared}


def seq_phase(runs: dict, t_start: float) -> Dict[str, list]:
    """Phase 15: the sequence paths' kernel shapes, sasrec and mind served
    (100 timed requests at B = 512) and trained (30 steps at B = 256, flush
    at 20) at full width, full-width retrieval, and din, mmoe and can at
    ``scale=0.01``. Returns the kernel shapes for the kernel line."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 15)
    shapes = seq_kernels(gen)
    print(f"[wall] phase 15 kernels at {time.perf_counter() - t_start:.1f}s", flush=True)
    for arch in SEQ_PATHS:
        serve_and_train(arch, runs, t_start)
        r = runs[arch, "retrieval"] = retrieval_full_width(arch)
        print(f"[retrieval] {arch} full width " + json.dumps(r), flush=True)
        print(f"[retrieval] {arch} top {RETRIEVAL_K} of {RETRIEVAL_N}, "
              f"{RETRIEVAL_CALLS} calls each: chunked p50={r['chunked_p50_ms']:.3f}ms "
              f"p99={r['chunked_p99_ms']:.3f}ms device={r['chunked_device_ms']}ms; "
              f"unchunked p50={r['unchunked_p50_ms']:.3f}ms p99={r['unchunked_p99_ms']:.3f}ms "
              f"device={r['unchunked_device_ms']}ms; plain p50={r['plain_p50_ms']:.3f}ms "
              f"p99={r['plain_p99_ms']:.3f}ms peak={r['peak_mem_gib']:.2f}GiB", flush=True)
    for name in PAPER_SMOKE:
        print(f"[paper] {name} scale=0.01 " + json.dumps(paper_against_plain(name)),
              flush=True)
        torch.cuda.empty_cache()
    stamp = card_stamp()
    for arch in SEQ_PATHS:
        sv, tr, rt = runs[arch, "serve"], runs[arch, "train"], runs[arch, "retrieval"]
        print(f"[phase 15] {arch} on {stamp}: request p50={sv['p50_ms']:.3f}ms "
              f"device ms/request={sv['where_time_goes']['device_ms_per_request']} "
              f"step p50={tr['step_p50_ms']:.3f}ms "
              f"device ms/step={tr['where_time_goes']['device_ms_per_step']} "
              f"retrieval p50={rt['chunked_p50_ms']:.3f}ms (chunked) "
              f"{rt['unchunked_p50_ms']:.3f}ms (one chunk) peak GiB serve/train/retrieval="
              f"{sv['peak_mem_gib']:.2f}/{tr['peak_mem_gib']:.2f}/{rt['peak_mem_gib']:.2f} "
              f"launches/request={sv['launches_per_request']} "
              f"launches/step={tr['launches_per_step']}", flush=True)
    print(f"[wall] phase 15 {time.perf_counter() - t_phase:.1f}s", flush=True)
    return shapes


# ------------------------------------------------------------------ phase 14
# the runtime at world 1: the guard, checkpoints and the replanner at full
# width, the supervisor, stream and reload matrix at smoke width

GUARD_NAN = (12, 13)       # batches the full-width guarded run is fed poisoned
SMOKE_CHAOS = "nan@7,nan@8,crash@13,ckpt@20"
SMOKE_B, SMOKE_STEPS, SMOKE_CKPT_EVERY = 32, 30, 5
SMOKE_SEGMENTS, SMOKE_SEGMENT_STEPS = 3, 5
SERVE_SMOKE_B, SERVE_SMOKE_REQUESTS, SERVE_TORN_AT = 64, 4, 2


def bits_sum(x: torch.Tensor) -> torch.Tensor:
    """The int64 sum on the card of ``x``'s bits viewed as int32, in chunks
    of 2^26 words; a host leaf (``--pin-l2``) is staged over chunk by
    chunk."""
    v = x.detach().reshape(-1)
    v = v.to(torch.int32) if v.dtype == torch.bool else v.view(torch.int32)
    step = 1 << 26  # the int64 sum widens its input: 512 MB at a time
    total = torch.zeros((), dtype=torch.int64, device=DEV)
    for i in range(0, v.shape[0], step):
        total += torch.sum(v[i:i + step].to(DEV), dtype=torch.int64)
    return total


def state_digest(state) -> list:
    """One integer a leaf, in leaf-name order: the int64 sum on the device of
    the leaf's bits viewed as int32 (host ints as they are)."""
    sums, host = [], []
    for name, x in sorted(ckpt._flatten(state).items()):
        if isinstance(x, torch.Tensor):
            sums.append(bits_sum(x))
        else:
            host.append((len(sums) + len(host), int(x)))
    out = torch.stack(sums).tolist() if sums else []
    for i, v in host:
        out.insert(i, v)
    return out


class RssSampler:
    """The process's resident set, sampled every 5 ms on a thread: the peak
    above the level at entry, in bytes."""

    def __enter__(self):
        self.base = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    @staticmethod
    def _rss() -> int:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        return 0

    def _run(self):
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())

    @property
    def above_base(self) -> int:
        return self.peak - self.base


def guard_run(batches, guard: bool, nan=(), keep: bool = False) -> dict:
    """Full-width deepfm on the train launcher's plan from seed 0 over
    ``batches``: unguarded (the default step) or guarded (the step judged by
    ``AnomalyGuard``), the batches at ``nan`` poisoned through
    ``ChaosStream``; launch counters reset just before and read just after.
    Around each poisoned step the digest must not move."""
    a = ARCHS["deepfm"]
    cfg, plan = arch_plan(a, TRAIN_B, train=True)
    model = WDLModel(cfg, plan)
    state = ts.init_state(model, plan, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    step = ts.make_train_step(model, plan, TRAIN_B, ts.TrainConfig(strategy=a.strategy), DEV)
    fn = AnomalyGuard(step) if guard else step
    stream = ChaosStream(iter(batches), frozenset(nan)) if nan else iter(batches)
    torch.cuda.synchronize(DEV)
    ops.reset_launches()
    lat, rejected, losses = [], [], []
    for i, b in enumerate(stream):
        before = state_digest(state) if i in nan else None
        t0 = time.perf_counter()
        state, m = fn(state, b)
        torch.cuda.synchronize(DEV)
        lat.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        if i in nan:
            check(m["anomalous"] == 1 and state_digest(state) == before,
                  f"guarded step {i + 1} (batch {i} poisoned) rejected with the state "
                  f"digest unchanged: {m.get('anomalous')}")
            rejected.append(i)
        elif guard:
            check(m["anomalous"] == 0, f"clean guarded step {i + 1} accepted")
    launches = dict(ops.launches)
    out = {"digest": state_digest(state), "lat": lat, "losses": losses, "launches": launches,
           "rejected": rejected, "accepted": len(lat) - len(rejected),
           "step": state["step"], "plan": plan, "cfg": cfg, "model": model}
    if keep:
        out["state"] = state
    else:
        del state
    del step, fn
    torch.cuda.empty_cache()
    return out


def steady_p50(lat) -> float:
    return float(np.percentile([t for i, t in enumerate(lat, start=1)
                                if i > WARMUP_ITERS and i != FLUSH_ITERS], 50))


def checkpoint_dir() -> str:
    """A new directory on the file system with the most free space of the
    temporary directory and the checkout (removed by the caller)."""
    roots = [tempfile.gettempdir(), str(Path(__file__).resolve().parent)]
    root = max(roots, key=lambda r: shutil.disk_usage(r).free)
    return tempfile.mkdtemp(prefix=".chip_smoke_ckpt_", dir=root)


def full_width_checkpoint(run: dict) -> dict:
    """``save_checkpoint`` of the guarded run's whole train state, then
    ``restore_verified`` into the same tensors zeroed: the digest after the
    restore bitwise the digest before. Bytes, seconds, GB/s each way and the
    peak host RSS above the level before each."""
    state, plan = run["state"], run["plan"]
    nbytes = sum(x.numel() * x.element_size() for x in ckpt._flatten(state).values()
                 if isinstance(x, torch.Tensor))
    d = checkpoint_dir()
    try:
        free = shutil.disk_usage(d).free
        check(free > 1.2 * nbytes, f"free disk {free / 1e9:.1f} GB for a {nbytes / 1e9:.2f} GB "
              "checkpoint")
        before = state_digest(state)
        torch.cuda.synchronize(DEV)
        with RssSampler() as rs_save:
            t0 = time.perf_counter()
            ckpt.save_checkpoint(d, int(state["step"]), state, meta=plan_meta(plan),
                                 salts=table_salts(plan))
            t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        os.sync()
        t_sync = time.perf_counter() - t0
        on_disk = sum(f.stat().st_size for f in Path(d).rglob("*") if f.is_file())
        for x in ckpt._flatten(state).values():
            if isinstance(x, torch.Tensor):
                x.zero_()
        zeroed = state_digest(state)
        check(zeroed != before, "the zeroed template differs from the saved state")
        torch.cuda.synchronize(DEV)
        with RssSampler() as rs_load:
            t0 = time.perf_counter()
            restored, s = ckpt.restore_verified(d, state)
            torch.cuda.synchronize(DEV)
            t_load = time.perf_counter() - t0
        after = state_digest(restored)
        check(after == before and s == int(state["step"]),
              "full-width restore_verified gives back the saved state bit for bit")
        run["state"] = restored
        return {"state_bytes": nbytes, "bytes_on_disk": on_disk, "free_disk_bytes": free,
                "codec": "npy.zst" if ckpt.zstandard is not None else "npy",
                "dir_on": "checkout" if str(Path(d).parent) == str(
                    Path(__file__).resolve().parent) else "tmp",
                "save_s": t_save, "save_gb_per_s": nbytes / t_save / 1e9,
                "sync_after_save_s": t_sync,
                "restore_s": t_load, "restore_gb_per_s": nbytes / t_load / 1e9,
                "save_peak_rss_above_base_bytes": rs_save.above_base,
                "restore_peak_rss_above_base_bytes": rs_load.above_base,
                "chunk_bytes": ckpt.CHUNK_BYTES, "digest_equal": after == before}
    finally:
        shutil.rmtree(d, ignore_errors=True)


def full_width_replan(batches) -> dict:
    """Ten steps, then one replan with the hot envelope halved (half the
    bytes the hot tier holds: the planned 1 GiB caps at 4,194,304 rows, so
    half of it would change nothing): master rows, adagrad slots and the
    FCounter after the migration are exactly the old ones with the tier
    written back, the new tier holds the rows it ranks, and one step from a
    shared state on the new plan meets the kernel-vs-plain bars."""
    a = ARCHS["deepfm"]
    cfg, plan = arch_plan(a, TRAIN_B, train=True)
    model = WDLModel(cfg, plan)
    state = ts.init_state(model, plan, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    step = ts.make_train_step(model, plan, TRAIN_B, ts.TrainConfig(strategy=a.strategy), DEV)
    for b in batches[:10]:
        state, _ = step(state, b)
    g = plan.groups[0]
    hot_now = plan.cache_rows[g.gid] * (g.dim + 1) * 4
    rp = Replanner(plan, strategy=a.strategy, hot_bytes=hot_now // 2)
    st = state["emb"][str(g.gid)]
    w_exp, acc_exp, counts = st.w.clone(), st.acc.clone(), st.counts.clone()
    mine = st.cache.keys < g.rows
    w_exp[st.cache.keys[mine].long()] = st.cache.rows[mine]
    acc_exp[st.cache.keys[mine].long()] = st.cache.acc[mine]
    torch.cuda.synchronize(DEV)
    out = rp.maybe_replan(state, step=10)
    torch.cuda.synchronize(DEV)
    check(out is not None, f"the replan with half the hot tier's bytes changes the plan: "
          f"{rp.events[-1].describe()}")
    plan2, state = out
    ev = rp.events[-1]
    mg = state["emb"][str(g.gid)]
    exact = (torch.equal(mg.w, w_exp) and torch.equal(mg.acc, acc_exp)
             and torch.equal(mg.counts, counts))
    check(exact, "migration keeps every master row, adagrad slot and FCounter entry")
    h1 = plan2.cache_rows[g.gid]
    live = mg.cache.keys < g.rows
    keys = mg.cache.keys[live].long()
    check(mg.cache.keys.shape[0] == h1 and bool((mg.cache.keys[1:] >= mg.cache.keys[:-1]).all())
          and torch.equal(mg.cache.rows[live], w_exp[keys])
          and int(counts[keys].min()) >= int(counts.sort(descending=True).values[h1 - 1]),
          "the new tier holds the top rows by count, loaded from the synced master")
    del w_exp, acc_exp, counts
    torch.cuda.empty_cache()
    model2 = WDLModel(cfg, plan2)
    step2 = ts.make_train_step(model2, plan2, TRAIN_B, ts.TrainConfig(strategy="mixed"), DEV)
    shared = shared_state_check(model2, plan2, step2, state, batches[10])
    state, m = step2(state, batches[10])
    check(np.isfinite(float(m["loss"])), "a step on the replanned state")
    res = {"event": ev.describe(), "seconds": ev.seconds,
           "hot_rows": [plan.cache_rows[g.gid], h1], "hot_bytes": [plan.hot_bytes, hot_now // 2],
           "master_exact": exact, "shared_state": shared}
    del state, step, step2, mg, st
    torch.cuda.empty_cache()
    return res


def smoke_plan():
    """The train launcher's smoke plan at B = 32 with a 1<<14-byte tier
    flushed every 5 steps after 2."""
    cfg = get_config("deepfm", smoke=True)
    plan = make_plan(cfg, world=1, per_device_batch=SMOKE_B, hot_bytes=1 << 14,
                     flush_iters=5, warmup_iters=2, mesh_shape=(1, 1))
    resolve_assignment(plan, "picasso")
    return cfg, plan, WDLModel(cfg, plan)


def smoke_supervised(d: str, chaos: bool):
    cfg, plan, model = smoke_plan()
    state = ts.init_state(model, plan, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    guard = AnomalyGuard(ts.make_train_step(model, plan, SMOKE_B, ts.TrainConfig(), DEV))
    ctl = ChaosController(parse_fault_plan(SMOKE_CHAOS) if chaos else FaultPlan())
    stream = ctl.wrap_stream(ReplayableStream(
        lambda s: batch_stream(cfg, SMOKE_B, seed=SEED, start=s)))
    # every checkpoint kept, so the torn one is still there to be quarantined
    sup = Supervisor(d, ckpt_every=SMOKE_CKPT_EVERY, backoff_s=0.0, salts=table_salts(plan),
                     keep=SMOKE_STEPS // SMOKE_CKPT_EVERY)

    def on_metrics(i, m):
        ctl.after_checkpoint(i, d, sup.ckpt)
        ctl.injector(i)

    state = sup.run(state, guard, stream, SMOKE_STEPS, on_metrics=on_metrics)
    return state, sup, guard, ctl


def smoke_matrix() -> dict:
    """At deepfm-smoke width on the card: the Supervisor through
    ``SMOKE_CHAOS`` (checkpoints every 5 steps) ends bitwise at a clean run
    over the batches it did not reject; ``run_stream`` publishes; a serve
    launcher subprocess follows the deltas (``--reload-dir``, a torn delta
    before request 2) within 1e-5 of the trainer's state served in-process;
    another under a different ``PYTHONHASHSEED`` fails on the salts."""
    out, t0 = {"seconds": {}}, time.perf_counter()
    root = Path(checkpoint_dir())
    try:
        state, sup, guard, ctl = smoke_supervised(str(root / "sup"), chaos=True)
        cfg, plan, model = smoke_plan()
        rejected = sorted(parse_fault_plan(SMOKE_CHAOS).nan_batch)
        clean = ts.init_state(model, plan, torch.Generator(device=DEV).manual_seed(SEED), DEV)
        step = ts.make_train_step(model, plan, SMOKE_B, ts.TrainConfig(), DEV)
        for i, b in enumerate(batch_stream(cfg, SMOKE_B, seed=SEED)):
            if i >= SMOKE_STEPS:
                break
            if i not in rejected:
                clean, _ = step(clean, b)
        same = state_digest(state) == state_digest(clean)
        check(same and [e.kind for e in guard.events] == ["nonfinite"] * len(rejected)
              and sup.total_failures == 1 and ctl.fired == {"crash@13", "ckpt@20"},
              f"supervised chaos run: bitwise {same}, events {guard.events}, failures "
              f"{sup.total_failures}, fired {ctl.fired}")
        template = ts.init_state(model, plan, torch.Generator(device=DEV).manual_seed(1), DEV)
        _, s = ckpt.restore_verified(str(root / "sup"), template, step=15)
        quarantined = sorted(p.name for p in (root / "sup").glob("step_*.corrupt"))
        check(s == 10 and quarantined == ["step_00000015.corrupt"],
              f"the torn step-15 checkpoint is quarantined, restore falls back: {s} "
              f"{quarantined}")
        out["supervisor"] = {"chaos": SMOKE_CHAOS, "bitwise_clean": same,
                             "rejected_batches": rejected, "restores": sup.total_failures,
                             "quarantined": quarantined, "fallback_step": s}
        del state, clean, template
        out["seconds"]["supervisor"] = time.perf_counter() - t0
        # the streaming driver, publishing every segment
        pub = str(root / "pub")
        state = ts.init_state(model, plan, torch.Generator(device=DEV).manual_seed(SEED), DEV)
        writer = ckpt.AsyncCheckpointer(str(root / "stream"), salts=table_salts(plan))
        state, last = run_stream(
            state, step, ReplayableStream(lambda s: batch_stream(cfg, SMOKE_B, seed=SEED,
                                                                 start=s)),
            segment_steps=SMOKE_SEGMENT_STEPS, n_segments=SMOKE_SEGMENTS, checkpointer=writer,
            meta_fn=lambda: plan_meta(plan),
            publisher=lambda i, st: publish_state(pub, i, st, meta=plan_meta(plan),
                                                  salts=table_salts(plan)),
            log=lambda s: None)
        writer.wait()
        check(last == SMOKE_SEGMENTS * SMOKE_SEGMENT_STEPS, f"stream ran to step {last}")
        out["seconds"]["stream"] = time.perf_counter() - t0 - out["seconds"]["supervisor"]
        # a serve launcher follows the deltas (tearing one before request 2)
        # while another, under other salts, tries a copy of them; both start
        # now and run together
        args = ["repro_torch.launch.serve", "--arch", "deepfm", "--smoke", "--batch",
                str(SERVE_SMOKE_B), "--n-requests", str(SERVE_SMOKE_REQUESTS), "--device",
                DEV.type, "--reload-dir"]
        env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent / "src")}
        other = str(root / "pub_other_salts")
        shutil.copytree(pub, other)
        jobs = [start_launcher([*args, pub, "--chaos", f"torn@{SERVE_TORN_AT}"],
                               "serve --reload-dir", env),
                start_launcher([*args, other], "serve under PYTHONHASHSEED=1",
                               {**env, "PYTHONHASHSEED": "1"})]
        try:
            # the trainer's state served in-process on the serve launcher's plan
            plan_s = apply_plan_meta(make_plan(cfg, world=1, per_device_batch=SERVE_SMOKE_B,
                                               mesh_shape=(1, 1)), plan_meta(plan))
            serve = make_serve_step(WDLModel(cfg, plan_s), plan_s, SERVE_SMOKE_B,
                                    ServeConfig(strategy="mixed"), DEV)
            rng = np.random.default_rng(0)  # the launcher's --seed 0 request stream
            want = []
            for _ in range(SERVE_SMOKE_REQUESTS):
                p = serve({"emb": state["emb"], "dense": state["dense"]},
                          make_batch(cfg, SERVE_SMOKE_B, rng))
                want.append((float(p.mean()), [float(x) for x in p.reshape(-1)[:4]]))
            stdout, _, _, t_serve = finish_launcher(jobs[0], timeout=300)
            _, stderr2, rc2, _ = finish_launcher(jobs[1], expect_ok=False, timeout=300)
        finally:
            stop_launchers(jobs)
        out["seconds"]["serve_subprocesses"] = time.perf_counter() - t0 - sum(
            out["seconds"].values())
        got = re.findall(r"^\[serve\] request (\d+): step (\d+) mean_prob=([\d.]+) "
                         r"probs\[:4\]=([\d. ]+)$", stdout, re.M)
        check(len(got) == SERVE_SMOKE_REQUESTS and f"reloaded published step {last}" in stdout
              and "tearing published delta before request" in stdout
              and all(int(g[1]) == last for g in got),
              f"the server loaded step {last} and kept it past the torn delta: {stdout}")
        err = max(max(abs(float(g[2]) - w[0]), *(abs(float(x) - y) for x, y in
                                                  zip(g[3].split(), w[1])))
                  for g, w in zip(got, want))
        check(err <= 1e-5, f"reloaded probabilities within 1e-5 of the trainer's: {err}")
        # another process under other salts must refuse the delta
        check(rc2 != 0 and "SaltMismatch" in stderr2 and "PYTHONHASHSEED" in stderr2,
              f"a server under PYTHONHASHSEED=1 refuses the delta: rc {rc2} "
              f"{stderr2[-1000:]}")
        # in-process (the server tore the step-15 delta): a good delta loads,
        # a newer torn one is skipped and the last good one stays
        poller = PublishPoller(pub)
        tmpl = {"emb": state["emb"], "dense": state["dense"]}
        for s_pub in (last + 5, last + 10):
            publish_state(pub, s_pub, state, meta=plan_meta(plan), salts=table_salts(plan))
            if s_pub == last + 10:
                tear_published(pub)
            got_pub = poller.poll(tmpl)
            check((got_pub is not None) == (s_pub == last + 5) and poller.last_step == last + 5,
                  f"poller at delta {s_pub}: loaded {poller.last_step}, failures "
                  f"{poller.failures}")
        out["stream"] = {"published": last, "serve_subprocess_s": t_serve,
                         "served_steps": [int(g[1]) for g in got],
                         "max_prob_err_vs_in_process": err,
                         "other_salts_exit": rc2,
                         "other_salts_error": stderr2.strip().splitlines()[-1][:300]}
        del state
        torch.cuda.empty_cache()
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def runtime_phase(runs: dict) -> dict:
    """Phase 14."""
    a = ARCHS["deepfm"]
    cfg, _ = arch_plan(a, TRAIN_B, train=True)
    stream = batch_stream(cfg, TRAIN_B, seed=SEED)
    batches = [next(stream) for _ in range(TRAIN_STEPS + 1)]
    t0 = time.perf_counter()
    plain = guard_run(batches[:TRAIN_STEPS], guard=False)
    guarded = guard_run(batches[:TRAIN_STEPS], guard=True, keep=True)
    runs["deepfm-guard", "train"] = {"launches": guarded["launches"]}
    same = guarded["digest"] == plain["digest"]
    check(same and guarded["losses"] == plain["losses"],
          "30 guarded steps bitwise the 30 unguarded steps (state digest and losses)")
    check(guarded["launches"] == {n: a.train_launches.get(n, 0) * TRAIN_STEPS
                                  for n in guarded["launches"]},
          f"guarded launches per step {a.train_launches}: {guarded['launches']}")
    out = {"guard": {"digest_equal": same, "leaves": len(plain["digest"]),
                     "step_p50_ms_unguarded": steady_p50(plain["lat"]),
                     "step_p50_ms_guarded": steady_p50(guarded["lat"]),
                     "launches": guarded["launches"]}}
    print("[runtime] full-width guard " + json.dumps(out["guard"]), flush=True)
    out["checkpoint"] = full_width_checkpoint(guarded)
    print("[runtime] full-width checkpoint " + json.dumps(out["checkpoint"]), flush=True)
    del guarded
    torch.cuda.empty_cache()
    poisoned = guard_run(batches[:GUARD_NAN[-1] + 3], guard=True, nan=GUARD_NAN)
    check(poisoned["rejected"] == list(GUARD_NAN) and poisoned["step"] == poisoned["accepted"]
          and all(np.isfinite(poisoned["losses"][GUARD_NAN[-1] + 1:])),
          f"both poisoned steps rejected, training goes on: {poisoned['rejected']}")
    out["nan"] = {"poisoned_batches": list(GUARD_NAN), "rejected": poisoned["rejected"],
                  "accepted": poisoned["accepted"], "state_step": poisoned["step"],
                  "loss_after": poisoned["losses"][-1]}
    print("[runtime] full-width nan " + json.dumps(out["nan"]), flush=True)
    del poisoned
    out["replan"] = full_width_replan(batches)
    print("[runtime] full-width replan " + json.dumps(out["replan"]), flush=True)
    t_full = time.perf_counter() - t0
    out["smoke"] = smoke_matrix()
    print("[runtime] smoke matrix " + json.dumps(out["smoke"]), flush=True)
    g, c, r = out["guard"], out["checkpoint"], out["replan"]["seconds"]
    print(f"[runtime] deepfm B={TRAIN_B}: step p50 {g['step_p50_ms_unguarded']:.3f}ms "
          f"unguarded, {g['step_p50_ms_guarded']:.3f}ms guarded; checkpoint "
          f"{c['state_bytes'] / 1e9:.2f} GB save {c['save_s']:.2f}s "
          f"({c['save_gb_per_s']:.2f} GB/s) restore {c['restore_s']:.2f}s "
          f"({c['restore_gb_per_s']:.2f} GB/s); replan harvest {r['harvest']:.3f}s compile "
          f"{r['compile']:.3f}s migrate {r['migrate']:.3f}s; full width {t_full:.1f}s",
          flush=True)
    return out


# ------------------------------------------------------------------ phase 16
#
# --pin-l2 (the L2 tier and the narrow masters in pinned host memory, read
# and written by the kernels over the bus) and the calibrated cost model.

PIN_ARCH = "dlrm-narrow"          # phases 10-11's run is the unpinned side
PIN_DIGEST_AT = (1, FLUSH_ITERS, FLUSH_ITERS + 1, TRAIN_STEPS)
# launches a request / a step that go to host operands under --pin-l2: the
# L2 probe, the master's rows gathered for the Shuffle, and in training the
# two dedup_adagrad updates (the narrow master and the L2 tier)
PIN_SERVE_LAUNCHES = {"tier_probe": 1, "host_rows": 1}
PIN_TRAIN_LAUNCHES = {"tier_probe": 1, "host_rows": 1, "dedup_adagrad": 2}
# the step-20 flush is the run's first: both tiers hold only sentinel keys,
# so nothing is written back, and the reload gathers each new tier's rows and
# accumulators from the host master (4 launches)
PIN_FLUSH_HOST_ROWS = 4
BUS_COPY_BYTES = 1 << 30
# the narrow deepfm launchers at full width: 25 steps take the step-20 flush
PIN_LAUNCHER_STEPS = 25
CALIB_REPLAN_ITERS, CALIB_STEPS = 10, 20


def public(d: dict) -> dict:
    """A result without its private (``_``) entries, for printing."""
    return {k: v for k, v in d.items() if not k.startswith("_")}


def mem_available_gib() -> float:
    with open("/proc/meminfo") as f:
        kb = next(int(ln.split()[1]) for ln in f if ln.startswith("MemAvailable:"))
    return kb / 2**20


def check_placement(state, plan, what: str) -> dict:
    """The leaves ``pinned_leaves(plan)`` names are CPU tensors in mapped
    page-locked memory (the CUDA driver's own attributes say so), every other
    tensor of the state is on the card."""
    names = pinned_leaves(plan)
    host, bad = 0, []
    for gid, st in state["emb"].items():
        leaves = {"w": st.w, "acc": st.acc, "counts": st.counts}
        for part in ("cache", "l2", "proj"):
            sub = getattr(st, part)
            if sub is not None:
                leaves.update({f"{part}.{k}": getattr(sub, k) for k in sub._fields})
        for name, t in leaves.items():
            pinned = name in names.get(gid, ())
            ok = (t.device.type == "cpu" and host_memory.driver_pinned(t)) if pinned \
                else t.device == DEV
            host += t.numel() * t.element_size() if pinned else 0
            if not ok:
                bad.append(f"{gid}.{name} on {t.device}")
    rest = [t for k, v in state.items() if k != "emb"
            for t in tree_leaves(v) if isinstance(t, torch.Tensor)]
    bad += [f"dense/opt leaf on {t.device}" for t in rest if t.device != DEV]
    check(not bad, f"{what}: placement {bad[:5]}")
    return {"pinned_leaves": {g: list(v) for g, v in names.items()}, "host_bytes": host}


# the pinned buffers of phase 16's DLRM serve state, which its train state
# (the same leaves, shapes and dtypes) is written into instead of new ones
PINNED_REUSE: Dict[str, object] = {}


def into_held_buffers(emb: dict, plan) -> dict:
    """``emb`` with each leaf ``pinned_leaves(plan)`` names copied into the
    ``PINNED_REUSE`` buffer of the same group and name (its shape and dtype
    checked), so the phase page-locks DLRM's 25 GiB once for serving and
    training."""
    out = {}
    for gid, st in emb.items():
        old, top, l2 = PINNED_REUSE.get(gid), {}, {}
        for name in pinned_leaves(plan).get(gid, ()):
            tier, key = name.startswith("l2."), name.split(".")[-1]
            t = getattr(st.l2 if tier else st, key)
            o = None if old is None else getattr(old.l2 if tier else old, key)
            if o is not None:
                check(o.shape == t.shape and o.dtype == t.dtype,
                      f"g{gid}.{name}: held buffer {tuple(o.shape)} {o.dtype}, leaf "
                      f"{tuple(t.shape)} {t.dtype}")
                (l2 if tier else top)[key] = o.copy_(t)
        if l2:
            top["l2"] = st.l2._replace(**l2)
        out[gid] = st._replace(**top)
    return out


# what hold_pinned_buffers did ahead of the first move: MemAvailable before
# it, its seconds and bytes
HELD: Dict[str, float] = {}


def hold_pinned_buffers(arch: str) -> None:
    """Page-lock exact-size buffers for every leaf ``pinned_leaves`` names in
    the arch's serve state, into ``PINNED_REUSE``, so the state's move only
    copies into them (phase 16 locks DLRM's 25 GiB beside the launcher
    subprocesses, where nothing is timed)."""
    from types import SimpleNamespace

    _, plan = arch_plan(ARCHS[arch], SERVE_B)
    gc.collect()
    HELD["mem_available_gib_before"] = mem_available_gib()
    t0 = time.perf_counter()
    for gid, names in pinned_leaves(plan).items():
        g = plan.group(int(gid))
        nd, h2 = plan.narrow_width(g.gid), plan.l2_rows.get(g.gid, 0)
        shapes = {"w": ((g.rows, nd), torch.float32), "acc": ((g.rows, 1), torch.float32),
                  "l2.keys": ((h2,), torch.int32), "l2.rows": ((h2, g.dim), torch.float32),
                  "l2.acc": ((h2, 1), torch.float32)}
        top, l2 = {}, {}
        for name in names:
            (l2 if name.startswith("l2.") else top)[name.split(".")[-1]] = \
                host_memory.pinned_empty(*shapes[name])
        PINNED_REUSE[gid] = SimpleNamespace(**top, l2=SimpleNamespace(**l2) if l2 else None)
    HELD["lock_s"] = time.perf_counter() - t0
    HELD["bytes"] = host_memory.pinned_bytes()


def pin_state(state, plan, what: str) -> dict:
    """Phase 16's move: MemAvailable, the pinned leaves placed (timed; into
    ``PINNED_REUSE``'s buffers where they fit), the placement checked, the
    peak statistics reset after the move."""
    gc.collect()  # a freed state's pinned buffers go back first
    held = dict(HELD)
    HELD.clear()
    avail = held.get("mem_available_gib_before") or mem_available_gib()
    t0 = time.perf_counter()
    state["emb"] = pin_to_host(into_held_buffers(state["emb"], plan), plan)
    PINNED_REUSE.clear()
    PINNED_REUSE.update({gid: st._replace(counts=None, cache=None, proj=None)
                         for gid, st in state["emb"].items()})
    torch.cuda.synchronize(DEV)
    secs = time.perf_counter() - t0
    out = check_placement(state, plan, what)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(DEV)
    out.update(mem_available_gib_before=avail, pin_s=secs,
               pinned_bytes=host_memory.pinned_bytes(),
               device_gib_after_move=torch.cuda.memory_allocated(DEV) / 2**30)
    if held:
        out.update(locked_ahead_s=held["lock_s"], locked_ahead_bytes=held["bytes"])
    ahead = (f" (page-locked ahead in {held['lock_s']:.2f}s beside the launchers)"
             if held else "")
    print(f"[pin] {what}: MemAvailable {avail:.2f} GiB before; "
          f"{out['pinned_bytes']} bytes pinned, moved in {secs:.2f}s{ahead}; "
          f"{out['device_gib_after_move']:.2f} GiB left on the card", flush=True)
    return out


def bus_bandwidth() -> dict:
    """One 1 GiB copy each way between pinned host memory and the card
    (CUDA events), in bytes a second."""
    h = host_memory.pinned_empty((BUS_COPY_BYTES // 4,), torch.float32)
    d = torch.empty((BUS_COPY_BYTES // 4,), dtype=torch.float32, device=DEV)
    h.fill_(1.0)
    out = {}
    for name, fn in (("h2d", lambda: d.copy_(h)), ("d2h", lambda: h.copy_(d))):
        out[name + "_ms"] = cuda_ms(fn, iters=3, warmup=1, device_only=False)
        out[name + "_bytes_per_s"] = BUS_COPY_BYTES / (out[name + "_ms"] / 1e3)
    del h, d
    torch.cuda.empty_cache()
    return out


def bus_bound(read: float, written: float, bw: dict) -> float:
    """ms the bus needs to read ``read`` bytes from host memory and write
    ``written`` to it (the two directions overlap)."""
    return max(read / bw["h2d_bytes_per_s"], written / bw["d2h_bytes_per_s"]) * 1e3


def host_probe_check(label: str, uniq, uvalid, keys_h, rows_h, bw: dict) -> dict:
    """``tier_probe`` on host keys and rows against the same kernel on
    device copies (bitwise) and the plain version on them (bitwise)."""
    keys_d, rows_d = keys_h.to(DEV), rows_h.to(DEV)
    h = ops.tier_probe(uniq, uvalid, keys_h, rows_h)
    d = ops.tier_probe(uniq, uvalid, keys_d, rows_d)
    r = ref.tier_probe_ref(uniq, uvalid, keys_d, rows_d)
    torch.cuda.synchronize(DEV)
    check(all(same_bits(x, y) for x, y in zip(h, d)) and all(
        same_bits(x, y) for x, y in zip(h, r)),
        f"{label}: tier_probe on host operands bitwise the kernel on device copies and "
        "the plain version")
    n, hh, dd = uniq.shape[0], keys_h.shape[0], rows_h.shape[1]
    n_hit = int(h[0].sum())
    check(0 < n_hit < n, f"{label}: the probe case has hits and misses")
    keys_read = min(hh, n * (math.ceil(math.log2(hh / n)) + 2))
    out = {"label": label, "n": n, "d": dd, "tier_keys": hh, "hits": n_hit,
           "max_abs_err": max_err(h[2], r[2]),
           "ms": cuda_ms(lambda: ops.tier_probe(uniq, uvalid, keys_h, rows_h)),
           "device_copy_ms": cuda_ms(lambda: ops.tier_probe(uniq, uvalid, keys_d, rows_d)),
           "plain_ms": cuda_ms(lambda: ref.tier_probe_ref(uniq, uvalid, keys_d, rows_d)),
           "library_ms": None, "plain_on": "device copies",
           "bound_ms": bus_bound(keys_read * 4 + n_hit * dd * 4, 0, bw),
           "bound_by": "bytes"}
    del keys_d, rows_d
    return out


def host_dedup_check(label: str, w_h, acc_h, idx, g, valid, bw: dict) -> dict:
    """``dedup_adagrad`` into host ``w``/``acc`` against the kernel on device
    copies (bitwise, the whole tables by digest: untouched rows unchanged)
    and the plain version on the touched rows (1e-5 of scale)."""
    w_d, acc_d = w_h.to(DEV), acc_h.to(DEV)
    rows = w_h.shape[0]
    kept = valid & (idx >= 0) & (idx < rows)
    u = torch.unique(idx[kept].long())
    sub_w, sub_a = w_d[u].clone(), acc_d[u].clone()
    sub_idx = torch.searchsorted(u, torch.clamp(idx.long(), 0, rows - 1)).clamp_(
        max=max(u.shape[0] - 1, 0)).to(torch.int32)
    ops.dedup_adagrad(w_h, acc_h, idx, g, valid, LR, EPS)
    ops.dedup_adagrad(w_d, acc_d, idx, g, valid, LR, EPS)
    ref.dedup_adagrad_ref(sub_w, sub_a, sub_idx, g, kept, LR, EPS)
    torch.cuda.synchronize(DEV)
    same = (bits_sum(w_h).item() == bits_sum(w_d).item()
            and bits_sum(acc_h).item() == bits_sum(acc_d).item()
            and same_bits(ops.take_rows(w_h, u), w_d[u])
            and same_bits(ops.take_rows(acc_h, u), acc_d[u]))
    err = max_err(w_d[u], sub_w) / scale_of(sub_w)
    check(same and err <= TOL, f"{label}: dedup_adagrad into host w/acc bitwise the kernel "
          f"on device copies (err vs plain {err} of scale)")
    d = w_h.shape[1]
    touched = u.shape[0]
    out = {"label": label, "m": idx.shape[0], "d": d, "rows": rows, "touched": touched,
           "max_abs_err": err,
           "ms": cuda_ms(lambda: ops.dedup_adagrad(w_h, acc_h, idx, g, valid, LR, EPS)),
           "device_copy_ms": cuda_ms(lambda: ops.dedup_adagrad(w_d, acc_d, idx, g, valid,
                                                               LR, EPS)),
           "plain_ms": cuda_ms(lambda: ref.dedup_adagrad_ref(w_d, acc_d, idx, g, valid, LR,
                                                              EPS)),
           "plain_on": "device copies", "library_ms": None,
           "bound_ms": bus_bound(touched * (d + 1) * 4, touched * (d + 1) * 4, bw),
           "bound_by": "bytes"}
    del w_d, acc_d
    return out


def host_rows_check(label: str, table_h, idx, bw: dict) -> dict:
    """The row helper: a gather of ``idx`` from the host table and a scatter
    of new rows to its distinct rows, each bitwise torch indexing of a
    device copy (the whole table by digest)."""
    table_d = table_h.to(DEV)
    got = ops.take_rows(table_h, idx)
    check(same_bits(got, table_d[idx.long()]), f"{label}: host_rows gather bitwise")
    u = torch.unique(idx.long())
    vals = torch.randn((u.shape[0],) + tuple(table_h.shape[1:]), device=DEV,
                       generator=torch.Generator(device=DEV).manual_seed(SEED + 16))
    ops.put_rows(table_h, u, vals)
    table_d[u] = vals
    torch.cuda.synchronize(DEV)
    check(bits_sum(table_h).item() == bits_sum(table_d).item()
          and same_bits(ops.take_rows(table_h, u), vals), f"{label}: host_rows scatter bitwise")
    width = table_h[0].numel()
    out = {"label": label, "n": idx.shape[0], "d": width, "rows": table_h.shape[0],
           "max_abs_err": 0.0,
           "ms": cuda_ms(lambda: ops.take_rows(table_h, idx)),
           "scatter_ms": cuda_ms(lambda: ops.put_rows(table_h, u, vals)),
           "plain_ms": cuda_ms(lambda: table_d[idx.long()]), "plain_on": "device copy",
           "library_ms": None,
           "bound_ms": bus_bound(idx.shape[0] * width * 4, 0, bw), "bound_by": "bytes",
           "scatter_bound_ms": bus_bound(0, u.shape[0] * width * 4, bw)}
    del table_d
    return out


def path_ids(n: int, rows: int, keys: torch.Tensor, gen: torch.Generator):
    """A path-like sorted unique query set: half tier keys, half random rows."""
    half = n // 2
    ids = torch.cat([keys[torch.randint(0, keys.shape[0], (half,), device=DEV,
                                        generator=gen)],
                     torch.randint(0, rows, (n - half,), device=DEV, generator=gen,
                                   dtype=torch.int32)])
    return pe.fixed_unique(ids.to(torch.int32), sentinel=rows)


def host_kernels(st, a: Arch, bw: dict, gen: torch.Generator, table_label: str) -> list:
    """The three kernels on one state's host-resident master and L2 tier
    (phase 16), at the arch's training shape."""
    out = []
    n = TRAIN_B * a.n_fields
    if st.l2 is not None and host_memory.is_mapped(st.l2.rows):
        keys_d = st.l2.keys.to(DEV)
        live = keys_d[keys_d < a.rows]
        u = path_ids(n, a.rows, live, gen)
        out.append(("tier_probe", host_probe_check(
            f"{table_label} L2 {st.l2.rows.shape[0]:,} x {a.dim}", u.uniq, u.uvalid,
            st.l2.keys, st.l2.rows, bw)))
        slots = torch.randperm(st.l2.rows.shape[0], device=DEV, generator=gen)[:n]
        valid = torch.rand(n, device=DEV, generator=gen) < 0.5
        g = torch.randn((n, a.dim), device=DEV, generator=gen)
        out.append(("dedup_adagrad", host_dedup_check(
            f"{table_label} L2 tier", st.l2.rows, st.l2.acc, slots.to(torch.int32), g,
            valid, bw)))
        out.append(("host_rows", host_rows_check(f"{table_label} L2 tier", st.l2.rows,
                                                 slots, bw)))
        del keys_d, live
    if host_memory.is_mapped(st.w):
        rows, d = st.w.shape
        idx = torch.randint(0, rows, (n,), device=DEV, generator=gen, dtype=torch.int32)
        valid = torch.rand(n, device=DEV, generator=gen) < 0.9
        g = torch.randn((n, d), device=DEV, generator=gen)
        out.append(("dedup_adagrad", host_dedup_check(f"{table_label} master", st.w, st.acc,
                                                      idx, g, valid, bw)))
        out.append(("host_rows", host_rows_check(f"{table_label} master", st.w, idx, bw)))
    return out


def deepfm_l2_kernels(bw: dict, gen: torch.Generator) -> list:
    """The narrow deepfm L2 tier (48,806,440 x 10) in pinned host memory,
    made on the card and moved."""
    a = ARCHS["deepfm-narrow"]
    h = a.l2_rows
    stride = a.rows // h
    keys = (torch.arange(h, device=DEV, dtype=torch.int64) * stride
            + torch.randint(0, stride, (h,), device=DEV, generator=gen)).to(torch.int32)
    tier = pe.CacheState(host_memory.pinned_like(keys),
                         host_memory.pinned_like(torch.randn((h, a.dim), device=DEV,
                                                             generator=gen)),
                         host_memory.pinned_like(torch.rand((h, 1), device=DEV,
                                                            generator=gen)))
    n = TRAIN_B * a.n_fields
    u = path_ids(n, a.rows, keys, gen)
    out = [("tier_probe", host_probe_check(f"deepfm-narrow L2 {h:,} x {a.dim}", u.uniq,
                                           u.uvalid, tier.keys, tier.rows, bw))]
    slots = torch.randperm(h, device=DEV, generator=gen)[:n].to(torch.int32)
    valid = torch.rand(n, device=DEV, generator=gen) < 0.5
    g = torch.randn((n, a.dim), device=DEV, generator=gen)
    out.append(("dedup_adagrad", host_dedup_check("deepfm-narrow L2 tier", tier.rows,
                                                  tier.acc, slots, g, valid, bw)))
    out.append(("host_rows", host_rows_check("deepfm-narrow L2 tier", tier.rows, slots, bw)))
    del tier, keys
    torch.cuda.empty_cache()
    return out


def pinned_dlrm(runs: dict, bw: dict, gen: torch.Generator) -> Tuple[dict, list]:
    """Full Criteo DLRM under ``picasso_narrow`` with its narrow master and L2
    tier in pinned host memory: phase 10's 300 requests and phase 11's 30
    steps again, bitwise theirs; then the three kernels on the trained
    state's host-resident master and L2 tier."""
    a = ARCHS[PIN_ARCH]
    base_s, base_t = runs[PIN_ARCH, "serve"], runs[PIN_ARCH, "train"]
    sv = serve_full_width(PIN_ARCH, pin=True)
    check(same_bits(sv["_probs"], base_s["_probs"]),
          f"pinned DLRM: {a.n_requests} requests' probabilities bitwise phase 10's")
    check(sv["peak_mem_gib"] <= base_s["peak_mem_gib"] - 20,
          f"pinned DLRM serving peak {sv['peak_mem_gib']:.2f} GiB at least 20 GiB below "
          f"{base_s['peak_mem_gib']:.2f}")
    torch.cuda.empty_cache()
    cfg, plan = arch_plan(a, TRAIN_B, train=True)
    stream = batch_stream(cfg, TRAIN_B, seed=SEED)
    batches = [next(stream) for _ in range(TRAIN_STEPS)]
    k = train_run(PIN_ARCH, "auto", batches, pin=True, digest_at=PIN_DIGEST_AT, keep=True)
    state, step = k.pop("_state"), k.pop("_step")
    check(k["losses"] == base_t["losses"],
          f"pinned DLRM: {TRAIN_STEPS} losses bitwise phase 11's: {k['losses']} vs "
          f"{base_t['losses']}")
    check(k["digests"] == base_t["_digests"],
          f"pinned DLRM: state digests at steps {PIN_DIGEST_AT} bitwise phase 11's")
    check(k["hits"] == base_t["hits"] and k["l2_hits"] == base_t["l2_hits"],
          "pinned DLRM: hits equal phase 11's")
    want = {n: (a.train_launches.get(n, 0) + (n == "host_rows")) * TRAIN_STEPS
            + PIN_FLUSH_HOST_ROWS * (n == "host_rows") for n in k["launches"]}
    check(k["launches"] == want, f"pinned DLRM training launches: {k['launches']} vs {want}")
    host_want = {n: PIN_TRAIN_LAUNCHES[n] * TRAIN_STEPS
                 + PIN_FLUSH_HOST_ROWS * (n == "host_rows") for n in k["host_launches"]}
    check(k["host_launches"] == host_want,
          f"pinned DLRM training launches on host operands: {k['host_launches']}")
    steady = k["peak_before_flush_gib"]
    check(steady <= base_t["peak_before_flush_gib"] - 20,
          f"pinned DLRM steady training peak {steady:.2f} GiB at least 20 GiB below "
          f"{base_t['peak_before_flush_gib']:.2f}")
    lat = np.array(k["lat"])
    stead = [t for i, t in enumerate(lat, start=1) if i > WARMUP_ITERS and i != FLUSH_ITERS]
    res = {"serve": {key: sv[key] for key in (
               "p50_ms", "p99_ms", "mean_ms", "peak_mem_gib", "launches", "host_launches",
               "pinned", "plain_refused", "cache_hits_per_request", "l2_hits_per_request",
               "init_s", "warmup_and_flush_s", "full_tiers")},
           "serve_device_ms_per_request": sv["where_time_goes"]["device_ms_per_request"],
           "serve_unpinned": {key: base_s[key] for key in ("p50_ms", "p99_ms",
                                                            "peak_mem_gib")},
           "train": {"step_p50_ms": float(np.percentile(stead, 50)),
                     "step_p99_ms": float(np.percentile(stead, 99)), "step_ms": k["lat"],
                     "flush_step_ms": float(lat[FLUSH_ITERS - 1]),
                     "first_step_ms": float(lat[0]),
                     "peak_before_flush_gib": steady, "peak_mem_gib": k["peak_mem_gib"],
                     "launches": k["launches"], "host_launches": k["host_launches"],
                     "pinned": k["pinned"], "digests_equal_at": list(PIN_DIGEST_AT),
                     "losses_equal": True},
           "train_unpinned": {key: base_t[key] for key in (
               "step_p50_ms", "step_p99_ms", "flush_step_ms", "peak_mem_gib",
               "peak_before_flush_gib")}}
    print("[pin] dlrm-narrow pinned " + json.dumps(res), flush=True)
    # both tiers filled (a flush from a full FCounter, which writes the
    # trained tiers back into the host master first), then the kernels on
    # the host master and L2 tier
    res["fill_flush"] = fill_tiers(step.engine, state, a, SEED + 4)
    check_placement(state, plan, f"{PIN_ARCH} after the full flush")
    print("[pin] dlrm-narrow full flush " + json.dumps(res["fill_flush"]), flush=True)
    rows = host_kernels(state["emb"]["0"], a, bw, gen, "dlrm-narrow")
    del state, k, step
    PINNED_REUSE.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return res, rows


def pinned_bytes_of(plan) -> int:
    """Bytes of the leaves ``pinned_leaves(plan)`` names, from the plan."""
    total = 0
    for gid, names in pinned_leaves(plan).items():
        g = plan.group(int(gid))
        nd, h2 = plan.narrow_width(g.gid), plan.l2_rows.get(g.gid, 0)
        size = {"w": g.rows * nd, "acc": g.rows, "l2.keys": h2, "l2.rows": h2 * g.dim,
                "l2.acc": h2}
        total += 4 * sum(size[n] for n in names)
    return total


class Launcher(NamedTuple):
    """A launcher subprocess started by ``start_launcher``: its output goes
    to files (no pipe fills while the script waits on another one)."""
    proc: subprocess.Popen
    out: object
    err: object
    t0: float
    what: str


def start_launcher(args: list, what: str, env: dict = None) -> Launcher:
    env = env or {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent / "src")}
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-m", *args], stdout=out, stderr=err, text=True,
                            env=env)
    return Launcher(proc, out, err, time.perf_counter(), what)


def finish_launcher(job: Launcher, expect_ok: bool = True,
                    timeout: float = 600) -> Tuple[str, str, int, float]:
    """Wait for ``job`` (killed past ``timeout``): its stdout, stderr, exit
    code and wall seconds from its start. ``expect_ok`` fails the phase on a
    nonzero exit."""
    try:
        job.proc.wait(timeout=timeout)
    finally:
        if job.proc.poll() is None:
            job.proc.kill()
            job.proc.wait()
    secs = time.perf_counter() - job.t0
    texts = []
    for f in (job.out, job.err):
        f.seek(0)
        texts.append(f.read())
        f.close()
    rc = job.proc.returncode
    if expect_ok:
        check(rc == 0, f"{job.what} exited {rc}: {texts[1][-3000:]}")
    return texts[0], texts[1], rc, secs


def stop_launchers(jobs) -> None:
    """Kill whatever of ``jobs`` still runs (a failed phase leaves none)."""
    for job in jobs:
        if job.proc.poll() is None:
            job.proc.kill()
            job.proc.wait()


PIN_FLAGS = ("--arch", "deepfm", "--strategy", ARCHS["deepfm-narrow"].strategy, "--narrow-dim",
             str(ARCHS["deepfm-narrow"].narrow_dim), "--l2-budget",
             str(ARCHS["deepfm-narrow"].l2_bytes), "--pin-l2")


def start_pinned_launchers() -> Dict[str, Launcher]:
    """Both launchers at full-width narrow deepfm with ``--pin-l2``, started
    together: the trainer for 25 steps (past the step-20 flush) with the
    narrow master and the L2 tier pinned, the server with its L2 tier
    pinned."""
    return {"train": start_launcher(["repro_torch.launch.train", *PIN_FLAGS, "--steps",
                                     str(PIN_LAUNCHER_STEPS), "--global-batch", str(TRAIN_B),
                                     "--log-every", "5"], "train --pin-l2"),
            "serve": start_launcher(["repro_torch.launch.serve", *PIN_FLAGS, "--batch",
                                     str(SERVE_B), "--n-requests", "10"], "serve --pin-l2")}


def pinned_launchers(jobs: Dict[str, Launcher]) -> dict:
    """The pinned launchers' output checked: the bytes each pinned, and
    finite steps with hits after the flush or a served line."""
    a = ARCHS["deepfm-narrow"]
    out = {}
    text, _, _, secs = finish_launcher(jobs["train"])
    _, plan = arch_plan(a, TRAIN_B, train=True)
    pinned = [int(x) for x in re.findall(r"^\[train\] pin-l2: (\d+) bytes pinned", text, re.M)]
    steps = re.findall(r"^  step +(\d+) loss=([\d.]+) hits=(\d+) ovf=\d+ l1=(\d+) l2=(\d+)$",
                       text, re.M)
    check(pinned and pinned[0] == pinned_bytes_of(plan) and len(steps) == PIN_LAUNCHER_STEPS // 5
          and all(np.isfinite(float(s[1])) for s in steps) and int(steps[-1][2]) > 0,
          f"train --pin-l2: pinned {pinned} (want {pinned_bytes_of(plan)}), steps {steps}")
    out["train"] = {"seconds": secs, "pinned_bytes": pinned[0],
                    "steps": [[int(s[0]), float(s[1]), int(s[2])] for s in steps]}
    _, splan = arch_plan(a, SERVE_B)
    want = sum(4 * splan.l2_rows[g.gid] * (g.dim + 2) for g in splan.groups
               if splan.l2_rows.get(g.gid, 0))
    text, _, _, secs = finish_launcher(jobs["serve"])
    pinned = [int(x) for x in re.findall(r"^\[serve\] pin-l2: (\d+) bytes pinned", text, re.M)]
    line = re.search(r"^\[serve\] deepfm B=\d+: p50=([\d.]+)ms p99=([\d.]+)ms "
                     r"mean_prob=([\d.]+)$", text, re.M)
    check(pinned == [want] and line is not None,
          f"serve --pin-l2: pinned {pinned} (want {want}): {text[-1500:]}")
    out["serve"] = {"seconds": secs, "pinned_bytes": pinned[0], "p50_ms": float(line.group(1)),
                    "p99_ms": float(line.group(2)), "mean_prob": float(line.group(3)),
                    "ran_beside": "the other launchers and the pinned smoke state"}
    return out


def pinned_smoke() -> dict:
    """A pinned narrow deepfm-smoke state (both tiers, flushed at step 3) on
    the card beside an unpinned one from the same seed: the pinned step
    refusing the unpinned state, 6 steps bitwise alike, a checkpoint saved
    straight after the sixth (no sync), a guarded step fed a NaN rejected
    through the journal's host rows, the checkpoint's round trip and a
    replan migration (half the L2 bytes), each keeping the placement and
    the values bitwise the unpinned side's."""
    a = ARCHS["deepfm-narrow"]
    b = 64  # train_smoke_against_cpu's batch: L2 hits after the step-3 flush
    cfg, plan = arch_plan(a, b, smoke=True, train=True)
    model = WDLModel(cfg, plan)

    def make():
        return ts.init_state(model, plan, torch.Generator(device=DEV).manual_seed(SEED), DEV)

    pinned, plain = make(), make()
    pinned["emb"] = pin_to_host(pinned["emb"], plan)
    check_placement(pinned, plan, "pinned smoke state")
    cfg_p = ts.TrainConfig(strategy=a.strategy, pin_l2=True)
    step_p = ts.make_train_step(model, plan, b, cfg_p, DEV)
    step_u = ts.make_train_step(model, plan, b, ts.TrainConfig(strategy=a.strategy), DEV)
    rng = np.random.default_rng(SEED + 16)
    batches = [make_batch(cfg, b, rng) for _ in range(7)]
    try:  # the step checks the placement and never re-pins a lost leaf
        step_p(plain, batches[0])
        refused = False
    except RuntimeError:
        refused = True
    check(refused, "a pin_l2 step refuses a state whose named leaves are on the card")
    l2 = []
    root = tempfile.mkdtemp(prefix="chip_smoke_pin_")
    try:
        for i, batch in enumerate(batches[:6]):
            pinned, mp = step_p(pinned, batch)
            if i == 5:
                # saved straight after an unguarded step, nothing synced in
                # between: the save waits for the step's queued host-row
                # writes itself (held against the synced state below)
                ckpt.save_checkpoint(root, 6, pinned)
            plain, mu = step_u(plain, batch)
            check(float(mp["loss"]) == float(mu["loss"]), "pinned smoke step bitwise")
            l2.append(int(mp["cache_hits/l2"]))
        check(state_digest(pinned) == state_digest(plain) and max(l2[3:]) > 0,
              f"pinned smoke: 6 steps bitwise the unpinned, L2 hits after the flush {l2}")
        # a rejected step restores its host rows through the journal
        guard = AnomalyGuard(step_p)
        poisoned = next(ChaosStream(iter(batches[6:]), frozenset({0})))
        before = state_digest(pinned)
        pinned, m = guard(pinned, poisoned)
        check(m["anomalous"] == 1 and state_digest(pinned) == before,
              "pinned smoke: the poisoned step rejected, every leaf bitwise as before")
        ops.reset_launches()
        want = state_digest(pinned)
        for t in ckpt._flatten(pinned).values():
            if isinstance(t, torch.Tensor):
                t.zero_()
        restored, step_no = ckpt.restore_checkpoint(root, pinned)
        torch.cuda.synchronize(DEV)
        check(step_no == 6 and state_digest(restored) == want,
              "pinned smoke: the checkpoint saved right after an unsynced step restores "
              "every leaf bitwise the synced state")
        check_placement(restored, plan, "pinned smoke state after restore")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rp_p = Replanner(plan, strategy=a.strategy, l2_bytes=SMOKE_L2_BYTES // 2, pin_l2=True)
    rp_u = Replanner(plan, strategy=a.strategy, l2_bytes=SMOKE_L2_BYTES // 2)
    out_p, out_u = rp_p.maybe_replan(restored, step=6), rp_u.maybe_replan(plain, step=6)
    check(out_p is not None and out_u is not None and plan_meta(out_p[0]) == plan_meta(out_u[0]),
          f"pinned smoke: both replans migrate alike: {rp_p.events[-1].describe()}")
    plan2, new_p = out_p
    new_u = out_u[1]
    check(state_digest(new_p) == state_digest(new_u),
          "pinned smoke: the migrated pinned state bitwise the unpinned one")
    placed = check_placement(new_p, plan2, "pinned smoke state after the replan")
    model2 = WDLModel(cfg, plan2)
    s2p = ts.make_train_step(model2, plan2, b, ts.TrainConfig(strategy="mixed", pin_l2=True),
                             DEV)
    s2u = ts.make_train_step(model2, plan2, b, ts.TrainConfig(strategy="mixed"), DEV)
    new_p, mp = s2p(new_p, batches[6])
    new_u, mu = s2u(new_u, batches[6])
    check(float(mp["loss"]) == float(mu["loss"]) and state_digest(new_p) == state_digest(new_u),
          "pinned smoke: a step on the replanned states bitwise alike")
    res = {"l2_hits": l2, "replan": rp_p.events[-1].describe(),
           "l2_rows": [plan.l2_rows[0], plan2.l2_rows[0]], "pinned_after_replan": placed,
           "host_launches": dict(ops.host_launches)}
    del pinned, plain, restored, new_p, new_u
    torch.cuda.empty_cache()
    return res


def calibration_phase(root: str) -> dict:
    """``get_cost_model('force')`` on the ``small`` grid through the port's
    kernels (launch counters) into ``root``, ``'auto'`` reloading the same
    model, and the calibrated against the constant assignment of full-width
    unpacked deepfm."""
    from repro_torch.perf import get_cost_model

    path = os.path.join(root, "calibration.json")
    ops.reset_launches()
    t0 = time.perf_counter()
    model = get_cost_model("force", path, grid="small", device=DEV,
                           log=lambda s: print(f"[calib] {s}", flush=True))
    secs = time.perf_counter() - t0
    ran = {k: ops.launches[k] for k in ("gather_pool", "dedup_adagrad", "tier_probe",
                                        "gather_project")}
    check(all(v > 0 for v in ran.values()) and model.backend == "torch-cuda",
          f"calibration timed the four kernels on the card: {ran}, {model.backend}")
    again = get_cost_model("auto", path, grid="small", device=DEV)
    check(again.to_json() == model.to_json(), "'auto' reloads the same model")
    curves = {op: c["ys_us"] for op, c in model.to_json()["ops"].items()}
    print("[calib] fitted curves (us at each grid point) " + json.dumps(
        {op: {"xs": c["xs"], "us": c["ys_us"]} for op, c in model.to_json()["ops"].items()}),
        flush=True)
    cfg = get_config("deepfm")
    plan = make_plan(cfg, world=1, per_device_batch=TRAIN_B, enable_packing=False,
                     hot_bytes=1 << 30, flush_iters=FLUSH_ITERS,
                     warmup_iters=WARMUP_ITERS, mesh_shape=(1, 1))
    const = compile_assignment(plan)
    calib = compile_assignment(plan, cost_model=model)
    mix_c, mix_k = dict(Counter(const.strategy.values())), dict(Counter(calib.strategy.values()))
    check(mix_c == dict(ARCHS["deepfm-mixed"].mix)
          and all(s.units == "us" for s in calib.scores.values()),
          f"constant mix {mix_c}, calibrated scores in us")
    return {"calibrate_s": secs, "kernel_launches": ran, "curves_us": curves,
            "mix_constant": mix_c, "mix_calibrated": mix_k, "_path": path}


def start_calibrated_launcher(path: str) -> Launcher:
    """A calibrated full-width training through the launcher (``--strategy
    auto --calibrate auto`` on the file at ``path``), whose replan prints
    the measured, predicted and correction values."""
    return start_launcher(
        ["repro_torch.launch.train", "--arch", "deepfm", "--no-packing", "--strategy",
         "auto", "--calibrate", "auto", "--calib-file", path, "--replan-iters",
         str(CALIB_REPLAN_ITERS), "--steps", str(CALIB_STEPS), "--global-batch",
         str(TRAIN_B), "--log-every", "10"], "train --calibrate auto")


def calibrated_feedback(job: Launcher) -> dict:
    text, _, _, secs = finish_launcher(job)
    fb = re.findall(r"^\[train\] replan (step \d+: .*measured=(\d+)us predicted=(\d+)us "
                    r"corr=([\d.]+).*)$", text, re.M)
    check("[train] calib loaded calibration" in text and len(fb) == 1,
          f"the launcher loaded the calibration and its replan fed back: {text[-2000:]}")
    return {"launcher_s": secs, "replan": fb[0][0], "measured_us": int(fb[0][1]),
            "predicted_us": int(fb[0][2]), "correction": float(fb[0][3]),
            "launcher_ran_beside": "the pinned launchers and the pinned smoke state"}


def pin_phase(runs: dict, t_start: float) -> Tuple[Dict[str, list], int]:
    """Phase 16. Returns the host-operand kernel rows for the kernel line and
    the ``host_rows`` launches of the pinned DLRM run (300 requests, 30
    steps)."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 16)
    bw = bus_bandwidth()
    print("[pin] bus " + json.dumps(bw), flush=True)
    # the plain path on the card refuses a host operand rather than staging it
    keys_h = host_memory.pinned_like(torch.arange(8, dtype=torch.int32, device=DEV))
    rows_h = host_memory.pinned_like(torch.zeros((8, 4), device=DEV))
    q = torch.arange(4, dtype=torch.int32, device=DEV)
    try:
        ops.tier_probe(q, q >= 0, keys_h, rows_h, fused=False)
        refused = False
    except ValueError:
        refused = True
    check(refused, "tier_probe(fused=False) refuses host keys and rows on the card")
    del keys_h, rows_h
    # the calibration times kernels, so it runs alone; then the three
    # launcher subprocesses run together, and beside them DLRM's pinned
    # buffers are page-locked and the pinned smoke state checked (values and
    # placement only, nothing timed); the pinned DLRM runs, timed, after
    root, jobs = tempfile.mkdtemp(prefix="chip_smoke_calib_"), {}
    try:
        calib = calibration_phase(root)
        jobs = start_pinned_launchers()
        jobs["calib"] = start_calibrated_launcher(calib.pop("_path"))
        hold_pinned_buffers(PIN_ARCH)
        smoke = pinned_smoke()
        print("[pin] smoke " + json.dumps(smoke), flush=True)
        launchers = pinned_launchers(jobs)
        print("[pin] launchers " + json.dumps(launchers), flush=True)
        calib.update(calibrated_feedback(jobs["calib"]))
    finally:
        stop_launchers(jobs.values())
        shutil.rmtree(root, ignore_errors=True)
    print("[calib] " + json.dumps(calib), flush=True)
    print(f"[wall] phase 16 calibration, launchers and smoke at "
          f"{time.perf_counter() - t_start:.1f}s", flush=True)
    torch.cuda.empty_cache()
    res, rows = pinned_dlrm(runs, bw, gen)
    rows += deepfm_l2_kernels(bw, gen)
    for name, r in rows:
        print(f"[pin] {name} host operands " + json.dumps(r), flush=True)
    sv, tr = res["serve"], res["train"]
    su, tu = res["serve_unpinned"], res["train_unpinned"]
    print(f"[phase 16] {card_stamp()}: dlrm-narrow pinned {sv['pinned']['host_bytes']} bytes; "
          f"request p50={sv['p50_ms']:.3f}ms p99={sv['p99_ms']:.3f}ms (unpinned "
          f"{su['p50_ms']:.3f}/{su['p99_ms']:.3f}); step p50={tr['step_p50_ms']:.3f}ms "
          f"p99={tr['step_p99_ms']:.3f}ms flush step={tr['flush_step_ms']:.1f}ms (unpinned "
          f"{tu['step_p50_ms']:.3f}/{tu['step_p99_ms']:.3f}/{tu['flush_step_ms']:.1f}); peak "
          f"serve {sv['peak_mem_gib']:.2f} GiB (unpinned {su['peak_mem_gib']:.2f}), train "
          f"steady {tr['peak_before_flush_gib']:.2f} / with the flush {tr['peak_mem_gib']:.2f} "
          f"GiB (unpinned {tu['peak_before_flush_gib']:.2f} / {tu['peak_mem_gib']:.2f}); "
          f"host launches serve {sv['host_launches']} train {tr['host_launches']}; bus "
          f"{bw['h2d_bytes_per_s'] / 1e9:.2f} / {bw['d2h_bytes_per_s'] / 1e9:.2f} GB/s; "
          f"calibrated mix {calib['mix_calibrated']} vs constant {calib['mix_constant']}; "
          f"phase {time.perf_counter() - t_phase:.1f}s", flush=True)
    out: Dict[str, list] = {"tier_probe": [], "dedup_adagrad": [], "host_rows": []}
    for name, r in rows:
        out[name].append({**r, "label": "host " + r["label"]})
    return out, sv["launches"]["host_rows"] + tr["launches"]["host_rows"]


# ------------------------------------------------------------------ phase 17
#
# World > 1: full-width deepfm on 4 ranks, one process each, time-sharing
# the one card over gloo (NCCL refuses two ranks on one device), against the
# world-1 kernel path on the same state. Not NCCL numbers.

WORLD, WORLD_MESH = 4, (2, 2)
WORLD_REQUESTS = 20
WORLD_KERNELS = ("tier_probe", "gather_pool", "fm_interaction", "fm_interaction_bwd",
                 "segment_grad", "dedup_adagrad")


def world_plans(world: int, exact: bool = True):
    """deepfm's train and serve plans at ``world`` as the launchers build
    them at ``--global-batch 256`` and ``--batch 512``: the train
    launcher's tier budget and flush schedule, one micro-batch a step.
    ``exact`` sizes every bucket for all of a rank's ids
    (``exact_capacity``): the packed table's contiguous row blocks give
    the last rank most of deepfm's lookups (its small tables sit at the
    end), which the launchers' uniform capacity drops at world 4, and the
    comparison with world 1 needs every id served."""
    from repro_torch.launch.mesh import mesh_world

    cfg = get_config("deepfm")
    shape = WORLD_MESH if world > 1 else (1, 1)
    check(mesh_world(shape) == world, f"mesh {shape} for world {world}")
    train = make_plan(cfg, world=world, per_device_batch=TRAIN_B // world,
                      hot_bytes=1 << 30, flush_iters=FLUSH_ITERS, warmup_iters=WARMUP_ITERS,
                      mesh_shape=shape, exact_capacity=exact)
    serve = make_plan(cfg, world=world, per_device_batch=SERVE_B // world, mesh_shape=shape,
                      exact_capacity=exact)
    check(train.cache_rows == serve.cache_rows and train.microbatch == TRAIN_B // world,
          f"world {world} plans: tiers {train.cache_rows} {serve.cache_rows}, "
          f"micro {train.microbatch}")
    return cfg, train, serve


def world_batches():
    cfg = get_config("deepfm")
    stream = batch_stream(cfg, TRAIN_B, seed=SEED)
    train = [next(stream) for _ in range(TRAIN_STEPS + 1)]
    rng = np.random.default_rng(SEED + 17)
    return train, [make_batch(cfg, SERVE_B, rng) for _ in range(WORLD_REQUESTS)]


def owned_rows(plan, batch, lo: int, hi: int) -> torch.Tensor:
    """The batch's unique packed ids in rows ``[lo, hi)``."""
    ids = torch.unique(pack_group(plan.groups[0], batch["fields"], DEV).ids.long())
    return ids[(ids >= lo) & (ids < hi)]


def grads_of(step) -> dict:
    """Wrap ``step.dense_update`` to keep the dense gradient it is handed
    (after the psum at world > 1)."""
    seen = {}

    def update(state, g_dense, _orig=step.dense_update):
        seen["g"] = [g.detach().cpu() for g in tree_leaves(g_dense)]
        return _orig(state, g_dense)

    step.dense_update = update
    return seen


def step_record(step, state, batch, plan, lo: int, hi: int) -> dict:
    """One step; its loss, metrics, dense gradient and the rows it touched
    in ``[lo, hi)`` after it."""
    seen = grads_of(step)
    try:
        state, m = step(state, batch)
    finally:
        del step.dense_update
    mine = owned_rows(plan, batch, lo, hi)
    st = state["emb"]["0"]
    return {"loss": float(m["loss"]), "hits": int(m["cache_hits"]),
            "overflow": int(m["overflow"]), "g": seen["g"], "ids": mine.cpu(),
            "w": st.w[mine - lo].cpu(), "acc": st.acc[mine - lo].cpu()}


def world_rank(group, workdir: str) -> dict:
    """One rank of phase 17: serve WORLD_REQUESTS requests of SERVE_B and
    train TRAIN_STEPS steps of TRAIN_B at full width, the flush at step 20
    run by the host (``make_flush_fn``) after the pre-flush state is saved
    to ``workdir`` for the world-1 side; then one step each under fp16 and
    topk routed compression and under picasso_narrow with an L2 tier that
    takes the dense psum."""
    from repro_torch import dist as rdist
    from repro_torch.core.features import agree_salts
    from repro_torch.dist.sharding import row_range

    torch.set_num_threads(2)
    cfg, plan, splan = world_plans(group.world)
    agree_salts(plan, group)
    model = WDLModel(cfg, plan)
    rows = plan.groups[0].rows
    lo, hi = row_range(rows, group)
    live = min(hi, sum(t.vocab for t in plan.groups[0].tables))
    state = ts.init_state(model, plan, torch.Generator(device=DEV).manual_seed(SEED), DEV,
                          group=group)
    st0 = state["emb"]["0"]
    out = {"rank": group.rank, "rows": [lo, hi], "live": live,
           "capacity": plan.capacity[0], "serve_capacity": splan.capacity[0],
           "init_digest": int(bits_sum(st0.w[:live - lo])),
           "dense_digest": [int(bits_sum(x)) for x in tree_leaves(state["dense"])]}
    train_b, serve_b = world_batches()

    # -- serving: each rank scores its 128 of every request of 512
    serve = make_serve_step(model, splan, SERVE_B, ServeConfig(), DEV, group=group)
    ops.reset_launches()
    lat, probs = [], []
    for b in serve_b:
        rdist.barrier(group)
        torch.cuda.synchronize(DEV)
        t0 = time.perf_counter()
        p = serve(state, b)
        torch.cuda.synchronize(DEV)
        lat.append((time.perf_counter() - t0) * 1e3)
        probs.append(rdist.all_gather_tiled(p, group).cpu())
    out["serve"] = {"launches": dict(ops.launches), "lat": lat,
                    "probs": torch.stack(probs) if group.rank == 0 else None}
    # the launcher's own serve plan (uniform bucket capacity): what it drops
    dplan = world_plans(group.world, exact=False)[2]
    dserve = make_serve_step(model, dplan, SERVE_B, ServeConfig(), DEV, group=group)
    dropped = uniq = 0
    for b in serve_b:
        _, ectx = dserve.score(state, b)
        dropped += int(ectx.ctxs[0].routing.overflow)
        uniq += int(ectx.ctxs[0].uvalid.sum())
    out["default_plan"] = {"capacity": dplan.capacity[0], "overflow": dropped,
                           "unique_ids": uniq}
    del dserve

    # -- training: the host flush at step 20, after the save
    tcfg = ts.TrainConfig(flush_in_step=False)
    step = ts.make_train_step(model, plan, TRAIN_B, tcfg, DEV, group=group)
    flush = ts.make_flush_fn(plan, group=group)
    recv = {"rows": 0}
    orig = pe._apply_miss_grads

    def counted(w, acc, ctx, g_u, world, *a, **k):
        # (lr, eps, fused, compress, group) follow ``world`` positionally
        grp = k.get("group", a[4] if len(a) > 4 else rdist.WORLD1)
        peers = [p for p in range(world) if p != grp.rank]
        recv["rows"] += int(ctx.recv_valid[peers].sum())
        return orig(w, acc, ctx, g_u, world, *a, **k)

    pe._apply_miss_grads = counted
    ops.reset_launches()
    lat, losses, hits, ovf, traffic, rec = [], [], [], [], [], {}
    try:
        for i, b in enumerate(train_b[:TRAIN_STEPS], start=1):
            rdist.barrier(group)
            rdist.reset_traffic()
            torch.cuda.synchronize(DEV)
            t0 = time.perf_counter()
            if i in (1, FLUSH_ITERS + 1):
                r = step_record(step, state, b, plan, lo, hi)
                rec[i] = r
                loss, h, o = r["loss"], r["hits"], r["overflow"]
            else:
                state, m = step(state, b)
                loss, h, o = float(m["loss"]), int(m["cache_hits"]), int(m["overflow"])
            if i == FLUSH_ITERS:
                torch.cuda.synchronize(DEV)
                step_ms = (time.perf_counter() - t0) * 1e3
                save_shard(state, group, workdir, lo, live)
                t0 = time.perf_counter()
                state = flush(state)
                torch.cuda.synchronize(DEV)
                out["flush_ms"] = (time.perf_counter() - t0) * 1e3
                st = state["emb"]["0"]
                out["flush"] = {"keys": st.cache.keys.cpu() if group.rank == 0 else None,
                                "keys_digest": int(bits_sum(st.cache.keys)),
                                "rows_digest": int(bits_sum(st.cache.rows)),
                                "counts_digest": int(bits_sum(st.counts[:live - lo])),
                                "counts_total": int(st.counts.sum())}
            else:
                torch.cuda.synchronize(DEV)
                step_ms = (time.perf_counter() - t0) * 1e3
            lat.append(step_ms)
            traffic.append(rdist.traffic_snapshot())
            losses.append(loss)
            hits.append(h)
            ovf.append(o)
    finally:
        pe._apply_miss_grads = orig
    out["train"] = {"launches": dict(ops.launches), "lat": lat, "losses": losses,
                    "hits": hits, "overflow": ovf, "traffic": traffic,
                    "recv_from_others": recv["rows"], "records": rec}

    # -- one step each under routed compression, from the trained state
    out["compressed"] = {}
    for mode in ("fp16", "topk"):
        cstep = ts.make_train_step(model, plan, TRAIN_B,
                                   dataclasses.replace(tcfg, grad_compress=mode), DEV,
                                   group=group)
        ops.reset_launches()
        state, m = cstep(state, train_b[TRAIN_STEPS])
        torch.cuda.synchronize(DEV)
        out["compressed"][mode] = {"loss": float(m["loss"]), "launches": dict(ops.launches),
                                   "hits": int(m["cache_hits"])}
        del cstep
    del state, step, serve, flush
    gc.collect()
    torch.cuda.empty_cache()
    out["narrow"] = world_narrow_rank(group, cfg, train_b[0])
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated(DEV) / 2**30
    return out


def save_shard(state, group, workdir: str, lo: int, live: int) -> None:
    """The pre-flush state for the world-1 side: this rank's live master
    rows, and from rank 0 the replicated leaves."""
    st = state["emb"]["0"]
    n = live - lo
    torch.save({"w": st.w[:n].cpu(), "acc": st.acc[:n].cpu(), "counts": st.counts[:n].cpu()},
               os.path.join(workdir, f"shard{group.rank}.pt"))
    if group.rank == 0:
        torch.save({"cache": [x.cpu() for x in st.cache],
                    "dense": tree_leaves(state["dense"]),
                    "m": tree_leaves(state["opt"]["m"]), "v": tree_leaves(state["opt"]["v"]),
                    "t": state["opt"]["t"], "step": state["step"]},
                   os.path.join(workdir, "replicated.pt"))


def world_narrow_rank(group, cfg, batch) -> dict:
    """picasso_narrow at world 4 with the largest L2 tier whose hit grads
    take the dense psum (its ``H2 * D`` elements at most the all_gather's
    ``(world - 1) * n * (D + 1)``: 8,232 rows at 64 samples a rank) behind
    an L1 of a quarter of the batch's unique ids: FCounter counts on the
    batch's own ids (3 where the id is a multiple of 3, else 2), so a flush
    fills L1 with a third's hottest and L2 with the rest, and one step."""
    from repro_torch.dist.sharding import row_range

    kw = dict(world=group.world, per_device_batch=TRAIN_B // group.world, narrow_dim=4,
              flush_iters=FLUSH_ITERS, warmup_iters=WARMUP_ITERS, mesh_shape=WORLD_MESH,
              exact_capacity=True)
    g0 = make_plan(cfg, **kw)
    d, n = g0.groups[0].dim, g0.microbatch * g0.groups[0].ids_per_sample
    h2 = (group.world - 1) * n * (d + 1) // d // 8 * 8
    n_uniq = int(owned_rows(g0, batch, 0, g0.groups[0].rows).numel())
    plan = make_plan(cfg, l2_bytes=h2 * (d + 1) * 4,
                     hot_bytes=n_uniq // 4 * (d + 1) * 4, **kw)
    resolve_assignment(plan, "picasso_narrow", world=group.world)
    check(plan.l2_rows[0] == h2, f"narrow world-4 plan: L2 rows {plan.l2_rows} for {h2}")
    choice = pe.l2_reduction(group.world, n, d, h2)
    check(choice == "psum", f"narrow world-4 plan: L2 rows {h2}, n {n} take {choice}")
    model = WDLModel(cfg, plan)
    state = ts.init_state(model, plan, torch.Generator(device=DEV).manual_seed(SEED), DEV,
                          group=group)
    lo, hi = row_range(plan.groups[0].rows, group)
    mine = owned_rows(plan, batch, lo, hi)
    st = state["emb"]["0"]
    st.counts[mine - lo] = torch.where(mine % 3 == 0, 3, 2).to(st.counts.dtype)
    state = ts.make_flush_fn(plan, group=group)(state)
    step = ts.make_train_step(model, plan, TRAIN_B,
                              ts.TrainConfig(strategy="picasso_narrow", flush_in_step=False),
                              DEV, group=group)
    ops.reset_launches()
    state, m = step(state, batch)
    torch.cuda.synchronize(DEV)
    out = {"l2_rows": h2, "l1_rows": plan.cache_rows[0], "n": n, "uniq": n_uniq,
           "l2_reduction": choice,
           "loss": float(m["loss"]), "l1_hits": int(m["cache_hits/l1"]),
           "l2_hits": int(m["cache_hits/l2"]), "launches": dict(ops.launches)}
    del state, step
    torch.cuda.empty_cache()
    return out


def world_phase(runs: dict, t_start: float) -> dict:
    """Phase 17: ``world_rank`` on 4 spawned ranks over gloo, then the
    world-1 kernel path in this process on the same state: the init draws
    (digests), every request's probabilities, one step from the shared
    state before step 1 and after the flush (the pre-flush state loaded
    from the ranks' save, flushed at world 1), the flushed keys and
    FCounter bitwise where no bucket overflowed."""
    from repro_torch import dist as rdist

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    roots = [tempfile.gettempdir(), str(Path(__file__).resolve().parent)]
    root = max(roots, key=lambda r: shutil.disk_usage(r).free)
    workdir = tempfile.mkdtemp(prefix=".chip_smoke_world_", dir=root)
    try:
        ranks = rdist.spawn_ranks(world_rank, WORLD, workdir, device="cuda",
                                  workdir=workdir)
        t_ranks = time.perf_counter() - t_phase
        out = world_one_side(ranks, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    out["ranks_s"] = t_ranks
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[wall] phase 17 done at {time.perf_counter() - t_start:.1f}s "
          f"(ranks {t_ranks:.1f}s, phase {out['phase_s']:.1f}s)", flush=True)
    return out


def world_one_side(ranks: list, workdir: str) -> dict:
    """The world-1 side of phase 17 and every check between the two."""
    from repro_torch.dist.compat import backend_for

    r0 = ranks[0]
    backend = backend_for("cuda", WORLD)
    check(backend == "gloo", f"4 ranks on {torch.cuda.device_count()} card(s): {backend}")
    cfg, plan, splan = world_plans(1)
    model = WDLModel(cfg, plan)
    rows1 = plan.groups[0].rows
    state = ts.init_state(model, plan, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    st = state["emb"]["0"]
    for r in ranks:  # every rank holds exactly its rows of the world-1 draw
        lo, live = r["rows"][0], r["live"]
        check(int(bits_sum(st.w[lo:live])) == r["init_digest"],
              f"rank {r['rank']}'s rows {lo}:{live} of the world-1 draw")
        check(r["dense_digest"] == [int(bits_sum(x)) for x in tree_leaves(state["dense"])],
              f"rank {r['rank']}'s dense parameters are the world-1 draw")
    train_b, serve_b = world_batches()

    # -- serving: every request's probabilities against the world-1 kernel path
    serve = make_serve_step(model, splan, SERVE_B, ServeConfig(), DEV)
    lat1, prob_err = [], 0.0
    for i, b in enumerate(serve_b):
        torch.cuda.synchronize(DEV)
        t0 = time.perf_counter()
        p = serve(state, b)
        torch.cuda.synchronize(DEV)
        lat1.append((time.perf_counter() - t0) * 1e3)
        prob_err = max(prob_err, max_err(r0["serve"]["probs"][i].to(DEV), p))
    check(prob_err <= TOL, f"world-4 probabilities vs world 1: {prob_err}")
    for r in ranks:
        check(r["serve"]["launches"] == {n: ARCHS["deepfm"].serve_launches.get(n, 0)
                                         * WORLD_REQUESTS for n in r["serve"]["launches"]},
              f"rank {r['rank']} serving launches {r['serve']['launches']}")

    # -- one step from the shared init state
    step = ts.make_train_step(model, plan, TRAIN_B, ts.TrainConfig(flush_in_step=False), DEV)
    checks = {1: world_step_check(ranks, 1, step, state, train_b[0], plan)}

    # -- the pre-flush state after step 20, flushed at world 1
    for r in ranks:
        lo, live = r["rows"][0], r["live"]
        shard = torch.load(os.path.join(workdir, f"shard{r['rank']}.pt"))
        st.w[lo:live].copy_(shard["w"])
        st.acc[lo:live].copy_(shard["acc"])
        st.counts[lo:live].copy_(shard["counts"])
        del shard
    rep = torch.load(os.path.join(workdir, "replicated.pt"))
    for dst, src in zip(st.cache, rep["cache"]):
        dst.copy_(src)
    for name, leaves in (("dense", rep["dense"]), ("m", rep["m"]), ("v", rep["v"])):
        tree = state["dense"] if name == "dense" else state["opt"][name]
        for dst, src in zip(tree_leaves(tree), leaves):
            dst.copy_(src)
    state["opt"]["t"] = rep["t"].to(DEV)
    state["step"] = rep["step"]
    del rep
    state = ts.make_flush_fn(plan)(state)
    st = state["emb"]["0"]
    ovf = sum(sum(r["train"]["overflow"][:FLUSH_ITERS]) for r in ranks)
    # world 4 pads the table by a row, so its sentinel key is world 1's + 1
    keys4 = r0["flush"]["keys"].to(DEV)
    keys4 = torch.where(keys4 >= rows1, torch.full_like(keys4, rows1), keys4)
    flush = {"overflow_steps_1_20": ovf,
             "keys_equal": bool(torch.equal(keys4, st.cache.keys)),
             "replicas_equal": len({(r["flush"]["keys_digest"], r["flush"]["rows_digest"])
                                    for r in ranks}) == 1,
             "counts_equal": all(int(bits_sum(st.counts[r["rows"][0]:r["live"]]))
                                 == r["flush"]["counts_digest"] for r in ranks),
             "counts_total_1": int(st.counts.sum()),
             "counts_total_4": sum(r["flush"]["counts_total"] for r in ranks),
             "tier_keys": int((st.cache.keys < rows1).sum())}
    check(flush["replicas_equal"], "the 4 ranks' flushed tiers are bitwise alike")
    if ovf == 0:
        check(flush["keys_equal"] and flush["counts_equal"]
              and flush["counts_total_1"] == flush["counts_total_4"],
              f"no bucket overflowed: flushed keys and FCounter bitwise world 1's {flush}")
    checks[FLUSH_ITERS + 1] = world_step_check(ranks, FLUSH_ITERS + 1, step, state,
                                               train_b[FLUSH_ITERS], plan)
    del state, step, serve, st
    gc.collect()
    torch.cuda.empty_cache()

    # -- the ranks' own checks: kernels, routed rows, hits, compression, narrow
    tr_each = ARCHS["deepfm"].train_launches
    for r in ranks:
        t = r["train"]
        check(t["launches"] == {n: tr_each.get(n, 0) * TRAIN_STEPS for n in t["launches"]},
              f"rank {r['rank']} training launches {t['launches']}")
        check(all(t["launches"].get(n, 0) > 0 for n in WORLD_KERNELS),
              f"rank {r['rank']}: every kernel of the path launched")
        check(t["recv_from_others"] > 0,
              f"rank {r['rank']}'s dedup_adagrad got no rows from another rank")
        check(all(np.isfinite(t["losses"])) and max(t["hits"][:FLUSH_ITERS]) == 0
              and min(t["hits"][FLUSH_ITERS:]) > 0, f"rank {r['rank']} hits {t['hits']}")
        for mode, c in r["compressed"].items():
            check(np.isfinite(c["loss"]) and c["launches"].get(f"{mode}_compress") == 1
                  and c["launches"].get(f"{mode}_decompress") == 1,
                  f"rank {r['rank']} {mode} step {c}")
        n = r["narrow"]
        check(np.isfinite(n["loss"]) and n["l1_hits"] > 0 and n["l2_hits"] > 0
              and n["launches"].get("tier_probe") == 2
              and n["launches"].get("gather_project") == 1
              and n["launches"].get("dedup_adagrad") == 1,
              f"rank {r['rank']} narrow step (the L2 tier by the dense psum) {n}")
    check(len({tuple(r["train"]["losses"]) for r in ranks}) == 1,
          "every rank reports the same summed losses")

    lat_s = np.array([max(r["serve"]["lat"][i] for r in ranks)
                      for i in range(1, WORLD_REQUESTS)])
    steady = [i for i in range(WARMUP_ITERS, TRAIN_STEPS) if i != FLUSH_ITERS - 1]
    lat_t = np.array([max(r["train"]["lat"][i] for r in ranks) for i in steady])
    bytes_step = {k: float(np.median([r0["train"]["traffic"][i][k] for i in steady]))
                  for k in r0["train"]["traffic"][0]}
    return {
        "world": WORLD, "mesh": "x".join(map(str, WORLD_MESH)), "backend": backend,
        "rows": [r["rows"] for r in ranks], "capacity": r0["capacity"],
        "serve_capacity": r0["serve_capacity"],
        "launcher_plan_serving": [r["default_plan"] for r in ranks],
        "request_p50_ms": float(np.percentile(lat_s, 50)),
        "request_p99_ms": float(np.percentile(lat_s, 99)),
        "world1_request_p50_ms": float(np.percentile(lat1[1:], 50)),
        "step_p50_ms": float(np.percentile(lat_t, 50)),
        "step_p99_ms": float(np.percentile(lat_t, 99)),
        "flush_ms": [r["flush_ms"] for r in ranks],
        "bytes_per_step_per_rank": bytes_step,
        "flush_step_bytes_rank0": r0["train"]["traffic"][FLUSH_ITERS - 1],
        "probs_max_abs_err": prob_err, "shared_state": checks, "flush": flush,
        "losses": r0["train"]["losses"], "hits": r0["train"]["hits"],
        "overflow_by_rank": [r["train"]["overflow"] for r in ranks],
        "serve_launches_by_rank": [r["serve"]["launches"] for r in ranks],
        "train_launches_by_rank": [r["train"]["launches"] for r in ranks],
        "recv_rows_from_others_by_rank": [r["train"]["recv_from_others"] for r in ranks],
        "compressed": {m: [r["compressed"][m] for r in ranks] for m in ("fp16", "topk")},
        "narrow": [r["narrow"] for r in ranks],
        "peak_mem_gib_by_rank": [r["peak_mem_gib"] for r in ranks]}


def world_step_check(ranks, i: int, step, state, batch, plan) -> dict:
    """World-1 step ``i`` from the state the ranks stepped from: the loss
    to rtol 1e-5, each dense gradient within 1e-5 of its largest entry, the
    rows every rank touched within 1e-6 of their scale."""
    rec = step_record(step, state, batch, plan, 0, plan.groups[0].rows)
    r0 = ranks[0]["train"]["records"][i]
    loss_rel = abs(r0["loss"] - rec["loss"]) / abs(rec["loss"])
    check(loss_rel <= 1e-5, f"step {i}: world-4 loss {r0['loss']} vs world 1 {rec['loss']}")
    g_err = max(max_err(a, b) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(r0["g"], rec["g"]))
    check(g_err <= TOL, f"step {i}: dense gradients {g_err} of their largest entry")
    w1 = state["emb"]["0"]
    row_err, n_rows = 0.0, 0
    for r in ranks:
        rr = r["train"]["records"][i]
        ids = rr["ids"].to(DEV)
        n_rows += int(ids.numel())
        for got, leaf in ((rr["w"], w1.w), (rr["acc"], w1.acc)):
            exp = leaf[ids]
            row_err = max(row_err, max_err(got.to(DEV), exp) / scale_of(exp))
    check(n_rows == int(rec["ids"].numel()), f"step {i}: the ranks own every touched row")
    check(row_err <= 1e-6, f"step {i}: touched master rows {row_err} of their scale")
    return {"loss_4": r0["loss"], "loss_1": rec["loss"], "loss_rel": loss_rel,
            "dense_grad_err": g_err, "rows": n_rows, "row_err_of_scale": row_err,
            "hits_4": r0["hits"], "hits_1": rec["hits"]}


# ------------------------------------------------------------------ phase 18
#
# The fault-tolerant loop past world 1: full-width deepfm on phase 17's 4
# ranks and plan under the Supervisor, the guard and chaos, the ranks
# writing one checkpoint together every 10 steps; the clean run it must end
# at; the step-30 checkpoint's files against the live leaves; a fresh
# 4-rank resume. Times are of 4 ranks time-sharing one card over gloo.

FT_CHAOS = "nan@12,nan@13,ckpt@20,crash@24"
FT_CKPT_EVERY = 10
FT_KEEP = 2          # with the quarantined one, three checkpoints on disk at most
FT_CHECKPOINTS_ON_DISK = 3


def ft_steady(lat) -> float:
    """p50 of ``(state step after, ms)`` pairs past the warm-up, the flush
    step left out."""
    return float(np.percentile([ms for s, ms in lat
                                if s > WARMUP_ITERS and s != FLUSH_ITERS], 50))


def ft_leaf_bytes(state, group) -> int:
    """This rank's share of the logical checkpoint: its rows of the
    row-sharded leaves, and the replicated leaves once (rank 0)."""
    from repro_torch.dist.sharding import row_sharded_leaf

    return sum(x.numel() * x.element_size() for name, x in ckpt._flatten(state).items()
               if isinstance(x, torch.Tensor)
               and (row_sharded_leaf(name) or group.rank == 0))


def ft_files_match(d: str, state, group) -> dict:
    """The checkpoint's files read back leaf by leaf (not through the
    restore): this rank's rows of each row-sharded leaf and every replicated
    leaf, bitwise its live leaves, chunk by chunk; the leaves that differ."""
    import io

    from repro_torch.dist.sharding import row_sharded_leaf

    doc = json.loads((Path(d) / "manifest.json").read_text())
    flat = ckpt._flatten(state)
    bad, nbytes = sorted(set(doc["leaves"]) ^ set(flat)), 0
    for name, info in doc["leaves"].items():
        path = Path(d) / info["file"]
        if path.name.endswith(".zst"):  # a host with zstandard: read it whole
            import zstandard

            with open(path, "rb") as f:
                arr = np.load(io.BytesIO(zstandard.ZstdDecompressor().decompress(f.read())))
        else:
            arr = np.load(path, mmap_mode="r")
        x = flat[name]
        same = arr.dtype == ckpt._np_dtype(x)
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            live = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                              dtype=ckpt._np_dtype(x))
            same &= arr.shape == () and np.asarray(arr).tobytes() == live.tobytes()
        else:
            lo = group.rank * x.shape[0] if row_sharded_leaf(name) else 0
            same &= tuple(arr.shape[1:]) == tuple(x.shape[1:])
            step = max(1, (64 << 20) // max(1, x[:1].numel() * x.element_size()))
            for r0 in range(0, x.shape[0], step):
                r1 = min(x.shape[0], r0 + step)
                got = np.ascontiguousarray(arr[lo + r0:lo + r1])
                same &= got.tobytes() == x[r0:r1].cpu().numpy().tobytes()
                nbytes += got.nbytes
        if not same:
            bad.append(name)
    return {"equal": not bad, "differ": bad, "leaves": len(flat), "bytes_read": nbytes}


def ft_rank(group, d: str) -> dict:
    """One rank of phase 18: an unguarded clean run of TRAIN_STEPS steps;
    then, from the same draw, the Supervisor's run under the guard and
    FT_CHAOS, checkpoints every FT_CKPT_EVERY steps, the launches counted;
    then the step-30 checkpoint's files against the live leaves."""
    from repro_torch import dist as rdist
    from repro_torch.core.features import agree_salts

    torch.set_num_threads(2)
    cfg, plan, _ = world_plans(group.world)
    salts = agree_salts(plan, group)
    model = WDLModel(cfg, plan)
    batches = world_batches()[0][:TRAIN_STEPS]
    out = {"rank": group.rank}

    def timed(fn, lat):
        def call(state, b):
            torch.cuda.synchronize(DEV)
            t0 = time.perf_counter()
            state, m = fn(state, b)
            torch.cuda.synchronize(DEV)
            lat.append((state["step"], (time.perf_counter() - t0) * 1e3, bool(m.get("rejected"))))
            return state, m
        return call

    # -- the clean run
    state = ts.init_state(model, plan, torch.Generator(device=DEV).manual_seed(SEED), DEV,
                          group=group)
    lat = []
    step = timed(ts.make_train_step(model, plan, TRAIN_B, ts.TrainConfig(), DEV,
                                    group=group), lat)
    for b in batches:
        state, _ = step(state, b)
    out["clean"] = {"digest": state_digest(state), "lat": lat, "step": state["step"]}
    out["bytes"] = ft_leaf_bytes(state, group)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()

    # -- the supervised run
    state = ts.init_state(model, plan, torch.Generator(device=DEV).manual_seed(SEED), DEV,
                          group=group)
    guard = AnomalyGuard(ts.make_train_step(model, plan, TRAIN_B, ts.TrainConfig(), DEV,
                                            group=group), group=group)
    ctl = ChaosController(parse_fault_plan(FT_CHAOS), group=group)
    sup = Supervisor(d, ckpt_every=FT_CKPT_EVERY, backoff_s=0.0, keep=FT_KEEP, salts=salts,
                     group=group)
    sup.meta = plan_meta(plan)
    # ckpt@20 tears the checkpoint written at step 20, once every rank's save
    # of it is in: applied right after that save (the launcher applies chaos
    # in its metrics hook, before the step's save, where it tears step 10's)
    save = sup.ckpt.save

    def save_then_chaos(at, st, meta=None):
        save(at, st, meta=meta)
        ctl.after_checkpoint(at, d, sup.ckpt)

    sup.ckpt.save = save_then_chaos
    saves, real_save = [], ckpt.save_checkpoint

    def timed_save(*a, **k):  # on the writer thread
        with RssSampler() as rs:
            t0 = time.perf_counter()
            path = real_save(*a, **k)
            saves.append({"step": a[1], "s": time.perf_counter() - t0,
                          "rss_above_base": rs.above_base})
        return path

    ckpt.save_checkpoint = timed_save
    lat, crash = [], {}

    def on_metrics(i, m):
        if i in ctl.plan.crash and f"crash@{i}" not in ctl.fired:
            crash["at"] = time.perf_counter()
        ctl.injector(i)

    stepper = timed(guard, lat)

    def step_fn(st, b):
        st, m = stepper(st, b)
        if "at" in crash and "replayed" not in crash:
            crash["replayed"] = time.perf_counter()
        return st, m

    torch.cuda.synchronize(DEV)
    ops.reset_launches()
    t0 = time.perf_counter()
    try:
        state = sup.run(state, step_fn, ctl.wrap_stream(ReplayableStream(
            lambda s: iter(batches[s:]))), TRAIN_STEPS, on_metrics=on_metrics)
        sup.ckpt.wait()
    finally:
        ckpt.save_checkpoint = real_save
    torch.cuda.synchronize(DEV)
    launches = dict(ops.launches)
    rdist.barrier(group)  # every rank's writer done, rank 0's listing after
    out["supervised"] = {
        "digest": state_digest(state), "step": state["step"], "seconds": time.perf_counter() - t0,
        "lat": lat, "calls": len(lat), "launches": launches, "saves": saves,
        "events": [(e.step, e.kind, e.consecutive) for e in guard.events],
        "accepted": guard.accepted, "rejected": guard.rejected,
        "failures": sup.total_failures, "fired": sorted(ctl.fired),
        "crash_to_replay_s": crash["replayed"] - crash["at"],
        "dirs": sorted(p.name for p in Path(d).iterdir() if p.name.startswith("step_"))}
    out["files"] = ft_files_match(str(Path(d) / f"step_{TRAIN_STEPS:08d}"), state, group)
    del state, guard, sup
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ft_restart_rank(group, d: str) -> dict:
    """A fresh rank of phase 18: the Supervisor's resume from the ranks'
    newest checkpoint into a state drawn from another seed."""
    from repro_torch.core.features import agree_salts

    torch.set_num_threads(2)
    cfg, plan, _ = world_plans(group.world)
    salts = agree_salts(plan, group)
    model = WDLModel(cfg, plan)
    state = ts.init_state(model, plan, torch.Generator(device=DEV).manual_seed(SEED + 1), DEV,
                          group=group)
    sup = Supervisor(d, ckpt_every=FT_CKPT_EVERY, salts=salts, group=group)
    torch.cuda.synchronize(DEV)
    with RssSampler() as rs:
        t0 = time.perf_counter()
        state, at = sup.maybe_restore(state)
        torch.cuda.synchronize(DEV)
        seconds = time.perf_counter() - t0
    return {"step": at, "state_step": state["step"], "digest": state_digest(state),
            "restore_s": seconds, "restore_rss_above_base": rs.above_base}


def ft_phase(t_start: float) -> dict:
    """Phase 18: ``ft_rank`` on 4 ranks, then ``ft_restart_rank`` on 4
    fresh ones over the same directory (removed after), and the checks."""
    from repro_torch import dist as rdist

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    d = checkpoint_dir()
    try:
        free = shutil.disk_usage(d).free
        ranks = rdist.spawn_ranks(ft_rank, WORLD, d, device="cuda")
        t_ranks = time.perf_counter() - t_phase
        restart = rdist.spawn_ranks(ft_restart_rank, WORLD, d, device="cuda")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    nbytes = sum(r["bytes"] for r in ranks)
    check(free > FT_CHECKPOINTS_ON_DISK * nbytes,
          f"free disk {free / 1e9:.1f} GB for three {nbytes / 1e9:.2f} GB checkpoints")
    per_step = ARCHS["deepfm"].train_launches
    for r in ranks:
        sv, k = r["supervised"], r["rank"]
        check(sv["digest"] == r["clean"]["digest"] and sv["step"] == r["clean"]["step"]
              == TRAIN_STEPS,
              f"rank {k}: the supervised run's step-{TRAIN_STEPS} digest bitwise the clean run's")
        check([e[1] for e in sv["events"]] == ["nonfinite", "nonfinite"] and sv["rejected"] == 2
              and sv["failures"] == 1 and sv["fired"] == ["ckpt@20", "crash@24"],
              f"rank {k}: both poisoned steps rejected, one rollback, chaos fired once: "
              f"{sv['events']} {sv['failures']} {sv['fired']}")
        check(sv["dirs"] == ["step_00000020", "step_00000020.corrupt", "step_00000030"],
              f"rank {k}: the torn step-20 checkpoint quarantined once, the replay wrote "
              f"20 and 30 again: {sv['dirs']}")
        check(sv["launches"] == {n: per_step.get(n, 0) * sv["calls"] for n in sv["launches"]}
              and all(sv["launches"].get(n, 0) > 0 for n in WORLD_KERNELS),
              f"rank {k}: {sv['calls']} steps launched each kernel of the path once a step: "
              f"{sv['launches']}")
        check(r["files"]["equal"], f"rank {k}: the step-{TRAIN_STEPS} checkpoint's files "
              f"bitwise its live leaves (differing: {r['files']['differ']})")
    for r, again in zip(ranks, restart):
        check(again["step"] == again["state_step"] == TRAIN_STEPS
              and again["digest"] == r["supervised"]["digest"],
              f"rank {r['rank']}: a fresh spawn resumed at step {again['step']} with the "
              "live state's digest")
    # each save's seconds on the slowest rank, in order (step 20 twice: the replay)
    save_s = [[s["step"], max(r["supervised"]["saves"][i]["s"] for r in ranks)]
              for i, s in enumerate(ranks[0]["supervised"]["saves"])]
    restore_s = max(r["restore_s"] for r in restart)
    lat_g = [(s, ms) for r in ranks for s, ms, rej in r["supervised"]["lat"] if not rej]
    lat_u = [(s, ms) for r in ranks for s, ms, _ in r["clean"]["lat"]]
    out = {"world": WORLD, "mesh": "x".join(map(str, WORLD_MESH)), "chaos": FT_CHAOS,
           "checkpoint_bytes": nbytes, "free_disk_bytes": free,
           "codec": "npy.zst" if ckpt.zstandard is not None else "npy",
           "save_s_by_step": save_s,
           "save_gb_per_s": nbytes / float(np.median([t for _, t in save_s])) / 1e9,
           "restore_s": restore_s, "restore_gb_per_s": nbytes / restore_s / 1e9,
           "save_rss_peak_above_base_by_rank": [max(s["rss_above_base"]
                                                    for s in r["supervised"]["saves"])
                                                for r in ranks],
           "restore_rss_peak_above_base_by_rank": [a["restore_rss_above_base"]
                                                   for a in restart],
           "crash_to_first_replayed_step_s": max(r["supervised"]["crash_to_replay_s"]
                                                 for r in ranks),
           "step_p50_ms_guarded": ft_steady(lat_g), "step_p50_ms_unguarded": ft_steady(lat_u),
           "supervised_s": max(r["supervised"]["seconds"] for r in ranks),
           "calls_by_rank": [r["supervised"]["calls"] for r in ranks],
           "launches_by_rank": [r["supervised"]["launches"] for r in ranks],
           "files_bytes_read_by_rank": [r["files"]["bytes_read"] for r in ranks],
           "digest_leaves": len(ranks[0]["clean"]["digest"]),
           "ranks_s": t_ranks, "phase_s": time.perf_counter() - t_phase}
    print(f"[wall] phase 18 done at {time.perf_counter() - t_start:.1f}s "
          f"(ranks {t_ranks:.1f}s, phase {out['phase_s']:.1f}s)", flush=True)
    return out


# ------------------------------------------------------------------ phase 19
#
# The elastic reshard past world 1: phase 17's plan and batches, full-width
# deepfm with exact_capacity buckets at every world, 10 steps at world 4
# under the Supervisor (a checkpoint at step 10), a live reshard to world 2,
# 10 steps there (the host flush at step 20 after a pre-flush checkpoint),
# a live reshard back to world 4 with the two ranks that left as spares, and
# 5 steps; then world-1 checks in this process and a fresh 2-rank restore.
# Times are of 4 or 2 ranks time-sharing one card over gloo.

ELASTIC_STEPS = (10, 10, 5)   # steps at world 4, at world 2, at world 4 again
ELASTIC_MESH2 = (2, 1)


def row_digest(x: torch.Tensor, lo: int, n: int) -> Tuple[int, int]:
    """The int64 sum of rows ``x[:n]``'s bits viewed as int32, and that sum
    weighted by each row's table index + 1 (``lo`` the first's), both mod
    2^64: the ranks' digests of a row-sharded leaf add up to the whole
    table's at any world, and a row moved to another index changes the
    weighted one."""
    total = wtotal = 0
    step = 1 << 22
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        v = x[r0:r1].reshape(r1 - r0, -1).to(DEV).view(torch.int32)
        per_row = v.sum(1, dtype=torch.int64)
        idx = torch.arange(lo + r0 + 1, lo + r1 + 1, device=DEV, dtype=torch.int64)
        total += int(per_row.sum())
        wtotal += int((per_row * idx).sum())
    return total % 2**64, wtotal % 2**64


def elastic_digest(state, plan, group) -> dict:
    """This rank's digests: of its logical rows of every row-sharded leaf
    (``row_digest``, to be summed over the ranks) and of every replicated
    leaf (each rank's must be alike), a tier's sentinel keys (its padded
    rows, which depend on the world) counted as -1."""
    from repro_torch.dist.sharding import row_range, row_sharded_leaf

    rows, repl = {}, {}
    for name, x in sorted(ckpt._flatten(state).items()):
        g = plan.group(int(name.split("/")[1])) if name.startswith("emb/") else None
        live = sum(t.vocab for t in g.tables) if g is not None else 0
        if row_sharded_leaf(name):
            lo, hi = row_range(g.rows, group)
            rows[name] = row_digest(x, lo, max(0, min(hi, live) - lo))
        elif name.endswith("/keys"):
            check(bool(((x < live) | (x == g.rows)).all()), f"{name}: keys or the sentinel")
            repl[name] = int(bits_sum(torch.where(x < live, x, torch.full_like(x, -1))))
        else:
            repl[name] = int(bits_sum(x)) if isinstance(x, torch.Tensor) else int(x)
    return {"rows": rows, "replicated": repl}


def gathered(digests: list) -> dict:
    """The ranks' digests as the whole state's: row digests summed mod 2^64,
    the replicated ones once they are alike on every rank (checked)."""
    first = digests[0]
    for d in digests[1:]:
        check(d["replicated"] == first["replicated"], "the replicas are bitwise alike")
    rows = {k: tuple(sum(d["rows"][k][j] for d in digests) % 2**64 for j in (0, 1))
            for k in first["rows"]}
    return {"rows": rows, "replicated": dict(first["replicated"])}


def elastic_reshard(plan, state, new_world: int, group, **kw):
    """``reshard_live`` timed on the card, the host RSS peak above the level
    before it and the bytes this rank sent."""
    from repro_torch import dist as rdist
    from repro_torch.runtime import reshard_live

    rdist.reset_traffic()
    torch.cuda.synchronize(DEV)
    with RssSampler() as rs:
        t0 = time.perf_counter()
        out = reshard_live(plan, state, new_world, TRAIN_B // new_world, group=group,
                           exact_capacity=True, device=DEV, **kw)
        torch.cuda.synchronize(DEV)
        seconds = time.perf_counter() - t0
    return out, {"s": seconds, "rss_above_base": rs.above_base,
                 "bytes_sent": rdist.traffic_snapshot()["rows"]}


def elastic_rank(root, d4: str, d2: str) -> dict:
    """One process of phase 19 (module comment above)."""
    from repro_torch.core.features import agree_salts
    from repro_torch.dist.sharding import row_range
    from repro_torch.runtime.elastic import wait_for_reshard

    torch.set_num_threads(2)
    cfg, plan, _ = world_plans(WORLD)
    salts = agree_salts(plan, root)
    batches = world_batches()[0]
    tcfg = ts.TrainConfig(flush_in_step=False)
    n4, n2, n4b = ELASTIC_STEPS
    out = {"rank": root.rank, "lat": {}}

    def timed(step, lat):
        def call(st, b):
            torch.cuda.synchronize(DEV)
            t0 = time.perf_counter()
            st, m = step(st, b)
            torch.cuda.synchronize(DEV)
            lat.append((time.perf_counter() - t0) * 1e3)
            return st, m
        return call

    # -- world 4: n4 steps under the Supervisor, its checkpoint at step n4
    state = ts.init_state(WDLModel(cfg, plan), plan,
                          torch.Generator(device=DEV).manual_seed(SEED), DEV, group=root)
    sup = Supervisor(d4, ckpt_every=n4, salts=salts, group=root)
    sup.meta = plan_meta(plan)
    out["lat"][4] = []
    step = timed(ts.make_train_step(WDLModel(cfg, plan), plan, TRAIN_B, tcfg, DEV,
                                    group=root), out["lat"][4])
    state = sup.run(state, step, ReplayableStream(lambda s: iter(batches[s:])), n4)
    del sup, step
    out["digest_4"] = elastic_digest(state, plan, root)

    # -- live 4 -> 2: ranks 2 and 3 leave and wait
    (plan2, state, g2), out["reshard_4_2"] = elastic_reshard(plan, state, 2, root,
                                                             mesh_shape=ELASTIC_MESH2)
    gc.collect()
    torch.cuda.empty_cache()
    if g2 is not None:
        out["digest_2"] = elastic_digest(state, plan2, g2)
        # reshard_plan keeps the micro-batch (64: it divides the new per-rank
        # batch), which would split a world-2 step in two; one micro-batch a
        # step, as phase 17's plans take, is what world 1 can be held to
        plan2 = dataclasses.replace(plan2, microbatch=TRAIN_B // 2)
        lo, hi = row_range(plan2.groups[0].rows, g2)
        step2 = ts.make_train_step(WDLModel(cfg, plan2), plan2, TRAIN_B, tcfg, DEV, group=g2)
        out["lat"][2], rec, ovf = [], {}, []
        stepper = timed(step2, out["lat"][2])
        ops.reset_launches()
        for i in range(n4 + 1, n4 + n2 + 1):
            b = batches[i - 1]
            if i == n4 + 1:  # from the shared state right after the reshard
                torch.cuda.synchronize(DEV)
                t0 = time.perf_counter()
                rec[i] = step_record(step2, state, b, plan2, lo, hi)
                torch.cuda.synchronize(DEV)
                out["lat"][2].append((time.perf_counter() - t0) * 1e3)
                ovf.append(rec[i]["overflow"])
            else:
                state, m = stepper(state, b)
                ovf.append(int(m["overflow"]))
        out["launches_2"] = dict(ops.launches)
        out["micro_2"] = (TRAIN_B // 2) // plan2.microbatch
        out["overflow_2"] = ovf
        check(n4 + n2 == FLUSH_ITERS, f"the world-2 stretch ends at the flush step {FLUSH_ITERS}")
        ckpt.save_checkpoint(d2, FLUSH_ITERS, state, meta=plan_meta(plan2), salts=salts,
                             group=g2)
        state = ts.make_flush_fn(plan2, group=g2)(state)
        st = state["emb"]["0"]
        out["flush"] = {"keys": st.cache.keys.cpu() if g2.rank == 0 else None,
                        "digest": elastic_digest(state, plan2, g2)}
        snap = ckpt.device_snapshot(state)  # one step from the flushed state, aside
        rec[FLUSH_ITERS + 1] = step_record(step2, snap, batches[FLUSH_ITERS], plan2, lo, hi)
        del snap, step2, stepper
        gc.collect()
        torch.cuda.empty_cache()
        out["records"] = rec
        # -- live 2 -> 4: ranks 2 and 3 join
        (plan4, state, g4), out["reshard_2_4"] = elastic_reshard(plan2, state, WORLD, g2,
                                                                 mesh_shape=WORLD_MESH)
    else:
        state = None
        ev = wait_for_reshard(root)
        check(ev is not None and ev["world"] == WORLD, f"rank {root.rank}: the event {ev}")
        (plan4, state, g4), out["reshard_2_4"] = elastic_reshard(
            plan2, None, ev["world"], None, mesh_shape=ev["mesh_shape"])
    out["digest_4b"] = elastic_digest(state, plan4, g4)
    out["lat"]["4b"] = []
    step = timed(ts.make_train_step(WDLModel(cfg, plan4), plan4, TRAIN_B, tcfg, DEV,
                                    group=g4), out["lat"]["4b"])
    for i in range(n4 + n2 + 1, n4 + n2 + n4b + 1):
        state, m = step(state, batches[i - 1])
        check(np.isfinite(float(m["loss"])), f"rank {root.rank} step {i} at world 4 again")
    out["step_4b"] = int(state["step"])
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated(DEV) / 2**30
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def elastic_restore_rank(group, d4: str) -> dict:
    """A fresh rank of a 2-rank spawn: ``restore_elastic`` of the world-4
    step-10 checkpoint at world 2, timed, and its digests."""
    from repro_torch.core.packing import reshard_plan
    from repro_torch.runtime import restore_elastic

    torch.set_num_threads(2)
    cfg, plan4, _ = world_plans(WORLD)
    plan2 = reshard_plan(plan4, 2, TRAIN_B // 2, mesh_shape=ELASTIC_MESH2,
                         exact_capacity=True)
    state = ts.init_state(WDLModel(cfg, plan2), plan2,
                          torch.Generator(device=DEV).manual_seed(SEED + 1), DEV, group=group)
    torch.cuda.synchronize(DEV)
    with RssSampler() as rs:
        t0 = time.perf_counter()
        state, at = restore_elastic(d4, plan2, state, group=group)
        torch.cuda.synchronize(DEV)
        seconds = time.perf_counter() - t0
    return {"step": at, "digest": elastic_digest(state, plan2, group), "s": seconds,
            "rss_above_base": rs.above_base, "bytes": ft_leaf_bytes(state, group)}


def elastic_phase(t_start: float) -> dict:
    """Phase 19: ``elastic_rank`` on 4 ranks, ``elastic_restore_rank`` on 2
    fresh ones, then the world-1 side in this process and the checks."""
    from repro_torch import dist as rdist

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    root = checkpoint_dir()
    d4, d2 = os.path.join(root, "world4"), os.path.join(root, "world2")
    try:
        ranks = rdist.spawn_ranks(elastic_rank, WORLD, d4, d2, device="cuda")
        t_ranks = time.perf_counter() - t_phase
        fresh = rdist.spawn_ranks(elastic_restore_rank, 2, d4, device="cuda")
        t_fresh = time.perf_counter() - t_phase - t_ranks
        out = elastic_one_side(ranks, fresh, d4, d2)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out.update(ranks_s=t_ranks, fresh_restore_s=t_fresh,
               phase_s=time.perf_counter() - t_phase)
    print(f"[wall] phase 19 done at {time.perf_counter() - t_start:.1f}s "
          f"(ranks {t_ranks:.1f}s, phase {out['phase_s']:.1f}s)", flush=True)
    return out


def elastic_one_side(ranks: list, fresh: list, d4: str, d2: str) -> dict:
    """Phase 19's checks: the digests across each reshard, the world-2
    launches and overflow, the 2-rank restore, and in this process the
    step-10 checkpoint restored at world 1 (its sentinels remapped), step 11
    from it, the step-20 checkpoint restored at world 1 and flushed (keys
    and FCounter), and step 21 from that, held to phase 17's bars."""
    from repro_torch.dist.compat import WORLD1
    from repro_torch.runtime import restore_elastic

    n4, n2, n4b = ELASTIC_STEPS
    two = [r for r in ranks if "digest_2" in r]
    check([r["rank"] for r in two] == [0, 1], "ranks 0 and 1 hold world 2")
    d4g, d2g = gathered([r["digest_4"] for r in ranks]), gathered([r["digest_2"] for r in two])
    check(d2g == d4g, "4 -> 2: every logical row and replica bitwise across the reshard")
    f2g = gathered([r["flush"]["digest"] for r in two])
    d4bg = gathered([r["digest_4b"] for r in ranks])
    check(d4bg == f2g, "2 -> 4: every logical row and replica bitwise across the reshard")
    check(all(r["step_4b"] == n4 + n2 + n4b for r in ranks), "every rank ends at step 25")
    per_step = ARCHS["deepfm"].train_launches
    micro = two[0]["micro_2"]  # the recut keeps the micro-batch: micro-batches a step
    for r in two:
        check(r["launches_2"] == {k: per_step.get(k, 0) * micro * n2 for k in r["launches_2"]}
              and all(r["launches_2"].get(k, 0) == micro * n2 for k in WORLD_KERNELS),
              f"rank {r['rank']}: each kernel once a micro-batch ({micro} a step) at world 2: "
              f"{r['launches_2']}")
        check(sum(r["overflow_2"]) == 0, f"rank {r['rank']}: no bucket overflowed at world 2")
    for r in fresh:
        check(r["step"] == n4, f"the fresh restore's step {r['step']}")
    check(gathered([r["digest"] for r in fresh]) == d4g,
          "the world-4 checkpoint restored by a fresh 2-rank spawn: digests equal")

    # -- world 1 in this process
    cfg, plan1, _ = world_plans(1)
    rows1 = plan1.groups[0].rows
    model = WDLModel(cfg, plan1)
    step1 = ts.make_train_step(model, plan1, TRAIN_B, ts.TrainConfig(flush_in_step=False), DEV)
    logs = []
    state = ts.init_state(model, plan1, torch.Generator(device=DEV).manual_seed(SEED + 2), DEV)
    torch.cuda.synchronize(DEV)
    t0 = time.perf_counter()
    state, at = restore_elastic(d4, plan1, state, log=logs.append)
    torch.cuda.synchronize(DEV)
    restore1_s = time.perf_counter() - t0
    remapped = int((state["emb"]["0"].cache.keys == rows1).sum())
    d1 = elastic_digest(state, plan1, WORLD1)
    check(at == n4 and logs == [f"restored world={WORLD} checkpoint at world=1 "
                                f"(resharded step {n4})"], f"world-1 restore: {at} {logs}")
    check(d1 == d4g, "the world-4 checkpoint at world 1: every logical row and replica "
                     "bitwise the world-4 digests (the sentinels remapped)")
    view = [{"train": {"records": r["records"]}} for r in two]
    train_b = world_batches()[0]
    checks = {n4 + 1: world_step_check(view, n4 + 1, step1, state, train_b[n4], plan1)}
    del state
    gc.collect()
    torch.cuda.empty_cache()
    state = ts.init_state(model, plan1, torch.Generator(device=DEV).manual_seed(SEED + 3), DEV)
    state, at = restore_elastic(d2, plan1, state)
    check(at == FLUSH_ITERS, f"the world-2 pre-flush checkpoint at world 1: step {at}")
    state = ts.make_flush_fn(plan1)(state)
    st = state["emb"]["0"]
    keys2 = two[0]["flush"]["keys"].to(DEV)
    keys2 = torch.where(keys2 >= rows1, torch.full_like(keys2, rows1), keys2)
    fd1 = elastic_digest(state, plan1, WORLD1)
    flush = {"keys_equal": bool(torch.equal(keys2, st.cache.keys)),
             "counts_equal": fd1["rows"]["emb/0/counts"] == f2g["rows"]["emb/0/counts"],
             "tier_keys": int((st.cache.keys < rows1).sum())}
    check(flush["keys_equal"] and flush["counts_equal"] and flush["tier_keys"] > 0,
          f"the flush at world 2 against world 1: keys and FCounter bitwise {flush}")
    checks[FLUSH_ITERS + 1] = world_step_check(view, FLUSH_ITERS + 1, step1, state,
                                               train_b[FLUSH_ITERS], plan1)
    nbytes = sum(r["bytes"] for r in fresh)
    fresh_s = max(r["s"] for r in fresh)
    del state, step1, st
    gc.collect()
    torch.cuda.empty_cache()

    def p50(key, first=2):
        lat = [ms for r in ranks for ms in r["lat"].get(key, [])[first - 1:]]
        return float(np.percentile(lat, 50)) if lat else None

    return {
        "worlds": [WORLD, 2, WORLD], "meshes": ["2x2", "2x1", "2x2"],
        "steps": list(ELASTIC_STEPS),
        "reshard_4_2": {"s": max(r["reshard_4_2"]["s"] for r in ranks),
                        "bytes_sent": sum(r["reshard_4_2"]["bytes_sent"] for r in ranks),
                        "rss_above_base_by_rank": [r["reshard_4_2"]["rss_above_base"]
                                                   for r in ranks]},
        "reshard_2_4": {"s": max(r["reshard_2_4"]["s"] for r in ranks),
                        "bytes_sent": sum(r["reshard_2_4"]["bytes_sent"] for r in ranks),
                        "rss_above_base_by_rank": [r["reshard_2_4"]["rss_above_base"]
                                                   for r in ranks]},
        "step_p50_ms": {"world4": p50(4), "world2": p50(2), "world4_again": p50("4b")},
        "launches_world2_by_rank": [r["launches_2"] for r in two],
        "overflow_world2_by_rank": [r["overflow_2"] for r in two],
        "shared_state": checks, "flush": flush,
        "sentinels_remapped_world1": remapped,
        "restore_world1_s": restore1_s,
        "restore_world2_fresh_s": fresh_s, "restore_bytes": nbytes,
        "restore_gb_per_s": nbytes / fresh_s / 1e9,
        "restore_rss_above_base_by_rank": [r["rss_above_base"] for r in fresh],
        "peak_mem_gib_by_rank": [r["peak_mem_gib"] for r in ranks]}


# ------------------------------------------------------------------ phase 20
#
# Streaming past world 1, train to serve: phase 17's plan (exact_capacity at
# every world), full-width deepfm streamed by 4 ranks in 3 segments of 5
# steps, a checkpoint and a delta at each boundary (keep=2 of each), a live
# reshard 4 -> 2 at step 5's boundary and torn@10; beside it 2 serving ranks
# (mesh 2x1) answer requests of 512 while they poll the deltas, until they
# serve step 15. Then in this process: step 15's delta loaded at world 1
# (recut 2 -> 1) against the server's last request, and the stream's
# checkpoint directory resumed at world 1 (restore_elastic). Times are of
# ranks time-sharing one card over gloo.

STREAM_SEG, STREAM_SEGMENTS = 5, 3
STREAM_TORN = 10
STREAM_SERVE_S = 420.0   # the server's limit: it stops at step 15 or here
STREAM_PACE_S = 0.05     # between two requests


def serving_of(state) -> dict:
    return {"emb": state["emb"], "dense": state["dense"]}


def stream_rank(root, pub: str, ck: str) -> dict:
    """One trainer process of phase 20 (module comment above)."""
    from repro_torch.core.features import agree_salts
    from repro_torch.runtime.elastic import end_run, wait_for_reshard

    torch.set_num_threads(2)
    cfg, plan, _ = world_plans(WORLD)
    salts = agree_salts(plan, root)
    n = STREAM_SEG * STREAM_SEGMENTS
    batches = world_batches()[0][:n]
    tcfg = ts.TrainConfig(flush_in_step=False)
    chaos = ChaosController(parse_fault_plan(f"torn@{STREAM_TORN}"), group=root)
    cur = {"plan": plan, "group": root,
           "ckpt": ckpt.AsyncCheckpointer(ck, keep=2, salts=salts, group=root)}
    out = {"rank": root.rank, "lat": {WORLD: [], 2: []}, "publish": {}, "digests": {},
           "left_at": None}

    def make_step(plan, group):
        step = ts.make_train_step(WDLModel(cfg, plan), plan, TRAIN_B, tcfg, DEV, group=group)
        lat = out["lat"][group.world]

        def call(st, b):
            torch.cuda.synchronize(DEV)
            t0 = time.perf_counter()
            st, m = step(st, b)
            torch.cuda.synchronize(DEV)
            lat.append((time.perf_counter() - t0) * 1e3)
            check(np.isfinite(float(m["loss"])) and int(m["overflow"]) == 0,
                  f"rank {root.rank} step {st['step']}: loss {float(m['loss'])}, "
                  f"overflow {int(m['overflow'])}")
            return st, m
        return call

    def publisher(step, st):
        g = cur["group"]
        out["digests"][step] = elastic_digest(serving_of(st), cur["plan"], g)
        torch.cuda.synchronize(DEV)
        t0 = time.perf_counter()
        publish_state(pub, step, st, meta=plan_meta(cur["plan"]), salts=salts, group=g,
                      before_latest=lambda: chaos.after_publish(step, pub))
        out["publish"][step] = {"s": time.perf_counter() - t0, "world": g.world,
                                "bytes": ft_leaf_bytes(serving_of(st), g)}

    def on_segment(seg, step, st):
        if seg != 1:
            return None
        cur["ckpt"].wait()  # the rows move on the root's ckpt_pg
        (plan2, st, g2), out["reshard"] = elastic_reshard(
            cur["plan"], st, 2, cur["group"], mesh_shape=ELASTIC_MESH2,
            note={"step": step, "seg": seg})
        if g2 is None:
            return None, None, None, None
        # one micro-batch a step, as phase 19's world-2 stretch
        plan2 = dataclasses.replace(plan2, microbatch=TRAIN_B // 2)
        cur.update(plan=plan2, group=g2,
                   ckpt=ckpt.AsyncCheckpointer(ck, keep=2, salts=salts, group=g2))
        chaos.group = g2
        return st, make_step(plan2, g2), iter(batches[step:]), cur["ckpt"]

    ops.reset_launches()
    # the first state is made inside the call: nothing outside holds the
    # world-4 rows after the reshard
    state, last = run_stream(ts.init_state(WDLModel(cfg, plan), plan,
                                           torch.Generator(device=DEV).manual_seed(SEED),
                                           DEV, group=root),
                             make_step(plan, root), iter(batches),
                             segment_steps=STREAM_SEG, n_segments=STREAM_SEGMENTS,
                             checkpointer=cur["ckpt"], meta_fn=lambda: plan_meta(cur["plan"]),
                             publisher=publisher, on_segment=on_segment, log=lambda s: None)
    cur["ckpt"].wait()
    out["launches"] = dict(ops.launches)
    out["last"] = last
    if state is None:  # left at the reshard: hold nothing, wait for the run's end
        out["left_at"] = last
        gc.collect()
        torch.cuda.empty_cache()
        check(wait_for_reshard(root) is None, f"rank {root.rank}: one reshard only")
        return out
    out["final_digest"] = elastic_digest(state, cur["plan"], cur["group"])
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated(DEV) / 2**30
    del state
    gc.collect()
    torch.cuda.empty_cache()
    end_run(root=root)
    return out


def stream_plan2(serve: bool):
    """deepfm's plan at world 2 (mesh 2x1), exact capacities: the server's
    at ``SERVE_B``, or the trainer's after the reshard."""
    cfg = get_config("deepfm")
    b = SERVE_B if serve else TRAIN_B
    return cfg, make_plan(cfg, world=2, per_device_batch=b // 2, mesh_shape=ELASTIC_MESH2,
                          exact_capacity=True)


def stream_server_rank(group, pub: str, limit_s: float, stop: str) -> dict:
    """One serving process of phase 20: requests of ``SERVE_B`` (its half
    each), a poll of ``pub`` before each, until it serves step 15, or
    ``limit_s`` passes or the file ``stop`` appears (agreed each request)."""
    from repro_torch.core.features import agree_salts
    from repro_torch.dist import compat

    torch.set_num_threads(2)
    cfg, splan = stream_plan2(serve=True)
    check(splan.cache_rows == world_plans(WORLD)[1].cache_rows,
          "the server's tiers are the trainer's")
    agree_salts(splan, group)
    model = WDLModel(cfg, splan)
    state = init_state(model, splan, torch.Generator(device=DEV).manual_seed(SEED + 5), DEV,
                       group=group)
    serve = make_serve_step(model, splan, SERVE_B, ServeConfig(), DEV, group=group)
    poller = PublishPoller(pub, plan=splan, group=group)
    rng = np.random.default_rng(SEED + 20)
    final = STREAM_SEG * STREAM_SEGMENTS
    recs, loads, digests, out = [], {}, {}, {"rank": group.rank, "timed_out": False}
    end = time.monotonic() + limit_s
    ops.reset_launches()
    while True:
        failures, skipping = poller.failures, poller.skips_left > 0
        torch.cuda.synchronize(DEV)
        t0 = time.perf_counter()
        got = poller.poll(serving_of(state))
        torch.cuda.synchronize(DEV)
        poll_ms = (time.perf_counter() - t0) * 1e3
        if got is not None:
            state = {**state, **got[0]}
            loads[got[1]] = poll_ms / 1e3
            digests[got[1]] = elastic_digest(state, splan, group)
        kind = ("load" if got is not None else "fail" if poller.failures > failures
                else "skip" if skipping else "poll")
        b = make_batch(cfg, SERVE_B, rng)
        torch.cuda.synchronize(DEV)
        t0 = time.perf_counter()
        p = serve(state, b)
        torch.cuda.synchronize(DEV)
        recs.append({"step": poller.last_step, "kind": kind, "poll_ms": poll_ms,
                     "serve_ms": (time.perf_counter() - t0) * 1e3})
        if poller.last_step == final:
            out["probs"] = compat.all_gather_tiled(p, group).cpu()
            out["batch"] = b
            break
        over = time.monotonic() > end or os.path.exists(stop)
        if any(v[0] for v in compat.agree([int(over)], group)):
            out["timed_out"] = True
            break
        time.sleep(STREAM_PACE_S)
    out.update(records=recs, loads=loads, digests=digests, launches=dict(ops.launches),
               failures_seen=poller.failures)
    del state, serve
    gc.collect()
    torch.cuda.empty_cache()
    return out


def stream_phase(t_start: float, request_p50_ms: float) -> dict:
    """Phase 20: ``stream_rank`` on 4 processes and ``stream_server_rank``
    on 2 beside them, then the world-1 side in this process and the
    checks."""
    from repro_torch import dist as rdist

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    root = checkpoint_dir()
    pub, ck = os.path.join(root, "pub"), os.path.join(root, "ckpt")
    stop = os.path.join(root, "stop")  # the trainer failed: the server stops too
    served = {}

    def server():
        try:
            served["ranks"] = rdist.spawn_ranks(stream_server_rank, 2, pub, STREAM_SERVE_S,
                                                stop, device="cuda",
                                                deadline_s=STREAM_SERVE_S + 180)
        except BaseException as e:  # noqa: BLE001 — raised below, after the trainer
            served["error"] = e

    try:
        beside = threading.Thread(target=server)
        beside.start()
        try:
            trained = rdist.spawn_ranks(stream_rank, WORLD, pub, ck, device="cuda",
                                        deadline_s=STREAM_SERVE_S + 180)
        except BaseException:
            Path(stop).touch()
            raise
        finally:
            beside.join()
        if "error" in served:
            raise served["error"]
        t_ranks = time.perf_counter() - t_phase
        out = stream_one_side(trained, served["ranks"], pub, ck, request_p50_ms)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out.update(ranks_s=t_ranks, phase_s=time.perf_counter() - t_phase)
    print(f"[wall] phase 20 done at {time.perf_counter() - t_start:.1f}s "
          f"(ranks {t_ranks:.1f}s, phase {out['phase_s']:.1f}s)", flush=True)
    return out


def stream_one_side(trained: list, served: list, pub: str, ck: str,
                    request_p50_ms: float) -> dict:
    """Phase 20's checks: the ranks that left and stayed, the deltas the
    server loaded against the trainer's digests, step 10 never served, one
    step a request on both serving ranks, each rank's launches; then in this
    process step 15's delta at world 1 against the server's last request,
    and the stream's checkpoints resumed at world 1."""
    from repro_torch.dist.compat import WORLD1
    from repro_torch.runtime import load_published, restore_elastic

    n1 = STREAM_SEG
    final = STREAM_SEG * STREAM_SEGMENTS
    check([t["left_at"] for t in trained] == [None, None, n1, n1],
          f"ranks 2 and 3 leave at step {n1}: {[t['left_at'] for t in trained]}")
    live = trained[:2]
    check(all(t["last"] == final for t in live), "the stream ends at step 15")
    # the trainer's digests at each published step, over the ranks that wrote it
    pub_digest = {s: gathered([t["digests"][s] for t in (trained if s == n1 else live)])
                  for s in (n1, STREAM_TORN, final)}
    for sv in served:
        check(not sv["timed_out"], f"server rank {sv['rank']} served step {final} in time")
    steps = [[r["step"] for r in sv["records"]] for sv in served]
    check(steps[0] == steps[1], "every request's step is the same on both serving ranks")
    check(sorted(served[0]["loads"]) == [n1, final],
          f"the server loaded steps {sorted(served[0]['loads'])}: 5 and 15, never 10")
    for s in (n1, final):
        got = gathered([sv["digests"][s] for sv in served])
        check(got == pub_digest[s], f"the delta of step {s} as loaded at world 2 "
              f"({'recut 4 -> 2' if s == n1 else 'the same world'}): the trainer's digests")
    recs = served[0]["records"]
    kinds = [r["kind"] for r in recs]
    check("fail" in kinds and recs[-1]["kind"] == "load" and recs[-1]["step"] == final
          and all(r["step"] == n1 for r in recs[kinds.index("fail"):-1]),
          "the torn step-10 delta skipped, the requests answered from step 5 across it "
          f"until step 15 loaded: {Counter(kinds)}")
    # launches: each kernel once a step a trainer rank, once a request a server rank
    per_step, per_req = ARCHS["deepfm"].train_launches, ARCHS["deepfm"].serve_launches
    for t in trained:
        n = final if t["left_at"] is None else n1
        check(t["launches"] == {k: per_step.get(k, 0) * n for k in t["launches"]}
              and all(t["launches"].get(k, 0) == n for k in WORLD_KERNELS),
              f"trainer rank {t['rank']}: each kernel once a step ({n}): {t['launches']}")
    for sv in served:
        n = len(sv["records"])
        check(sv["launches"] == {k: per_req.get(k, 0) * n for k in sv["launches"]}
              and all(sv["launches"].get(k, 0) == n for k in per_req),
              f"server rank {sv['rank']}: each serving kernel once a request ({n}): "
              f"{sv['launches']}")

    # -- world 1 in this process: step 15's delta recut 2 -> 1, the last request
    cfg, plan1, splan1 = world_plans(1)
    model = WDLModel(cfg, splan1)
    sstate = init_state(model, splan1, torch.Generator(device=DEV).manual_seed(SEED + 6), DEV)
    torch.cuda.synchronize(DEV)
    t0 = time.perf_counter()
    sstate, at = load_published(pub, sstate, plan=splan1, step=final)
    torch.cuda.synchronize(DEV)
    load1_s = time.perf_counter() - t0
    check(at == final and elastic_digest(sstate, splan1, WORLD1) == pub_digest[final],
          "step 15's delta recut 2 -> 1: the trainer's digests")
    probs = make_serve_step(model, splan1, SERVE_B, ServeConfig(), DEV)(
        sstate, served[0]["batch"]).cpu()
    err = float((probs - served[0]["probs"]).abs().max())
    check(err <= TOL, f"the server's last request at world 1: max abs err {err:.3g}")
    del sstate
    gc.collect()
    torch.cuda.empty_cache()
    # -- the stream's checkpoints resumed at world 1 (restore_elastic)
    state = ts.init_state(WDLModel(cfg, plan1), plan1,
                          torch.Generator(device=DEV).manual_seed(SEED + 7), DEV)
    logs = []
    torch.cuda.synchronize(DEV)
    t0 = time.perf_counter()
    state, at = restore_elastic(ck, plan1, state, log=logs.append)
    torch.cuda.synchronize(DEV)
    resume1_s = time.perf_counter() - t0
    check(at == final and logs == [f"restored world=2 checkpoint at world=1 (resharded step "
                                   f"{final})"], f"the stream's checkpoint at world 1: {logs}")
    check(elastic_digest(state, plan1, WORLD1) == gathered([t["final_digest"] for t in live]),
          "the stream's step-15 checkpoint at world 1: the trainer's digests")
    del state
    gc.collect()
    torch.cuda.empty_cache()

    def p50(vals):
        return float(np.percentile(vals, 50)) if vals else None

    pubs = {s: {"s": max(t["publish"][s]["s"] for t in trained if s in t["publish"]),
                "bytes": sum(t["publish"][s]["bytes"] for t in trained if s in t["publish"]),
                "world": live[0]["publish"][s]["world"]} for s in (n1, STREAM_TORN, final)}
    for v in pubs.values():
        v["gb_per_s"] = v["bytes"] / v["s"] / 1e9
    fails = [max(sv["records"][i]["poll_ms"] for sv in served) / 1e3
             for i, r in enumerate(recs) if r["kind"] == "fail"]
    return {
        "worlds": [WORLD, 2], "segments": [STREAM_SEG] * STREAM_SEGMENTS,
        "torn": STREAM_TORN, "publish": pubs,
        "load_s": {"step5_recut_4_to_2": max(sv["loads"][n1] for sv in served),
                   "step15_same_world": max(sv["loads"][final] for sv in served),
                   "step15_recut_2_to_1_world1": load1_s, "failed_attempts": fails},
        "requests": len(recs), "kinds": dict(Counter(r["kind"] for r in recs)),
        "poll_ms_p50": p50([r["poll_ms"] for r in recs if r["kind"] == "poll"]),
        "skip_ms_p50": p50([r["poll_ms"] for r in recs if r["kind"] == "skip"]),
        "serve_ms_p50": p50([r["serve_ms"] for r in recs]),
        "phase17_request_p50_ms": request_p50_ms,
        "step_p50_ms": {"world4": p50([ms for t in trained for ms in t["lat"][WORLD][1:]]),
                        "world2": p50([ms for t in live for ms in t["lat"][2][1:]])},
        "reshard_4_2": {"s": max(t["reshard"]["s"] for t in trained),
                        "bytes_sent": sum(t["reshard"]["bytes_sent"] for t in trained)},
        "resume_world1_s": resume1_s, "last_request_max_abs_err": err,
        "launches_by_rank": [t["launches"] for t in trained],
        "server_launches_by_rank": [sv["launches"] for sv in served],
        "peak_mem_gib_by_rank": [t.get("peak_mem_gib") for t in live]}


def card_stamp() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def warm_profiler() -> None:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4).sum()
    prof.key_averages()


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs an NVIDIA card",
              file=sys.stderr)
        sys.exit(2)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t_start = time.perf_counter()
    # the profiler's first use imports torch._dynamo and sympy (seconds on
    # the card's host): done on a CPU-only window while nvcc builds
    warm = threading.Thread(target=warm_profiler)
    warm.start()
    secs = build.build_all()
    warm.join()
    for name in SOURCES:
        build.launcher(name)
        print(f"[build] {name}: {'; '.join(ptxas_usage(build.BUILD_LOG.get(name, ''))) or 'cached'}",
              flush=True)
    print(f"[build] {len(SOURCES)} kernels in {secs:.2f}s; s to each nvcc's end "
          + json.dumps({k: round(v, 1) for k, v in sorted(build.BUILD_SECONDS.items(),
                                                          key=lambda kv: -kv[1])}),
          flush=True)

    gen = torch.Generator(device=DEV).manual_seed(SEED)
    # name -> (runner, arch, path, the path's batch); each also runs at bulk
    runners = {"tier_probe": (run_tier_probe, "deepfm", "serve", SERVE_B),
               "gather_pool": (run_gather_pool, "deepfm", "serve", SERVE_B),
               "fm_interaction": (run_fm, "deepfm", "serve", SERVE_B),
               "segment_grad": (run_segment_grad, "deepfm", "train", TRAIN_B),
               "dedup_adagrad": (run_dedup_adagrad, "deepfm", "train", TRAIN_B),
               "fm_interaction_bwd": (run_fm_bwd, "deepfm", "train", TRAIN_B),
               "cross_layer": (run_cross, "dcn-v2", "serve", SERVE_B),
               "cross_layer_bwd": (run_cross_bwd, "dcn-v2", "train", TRAIN_B),
               "gather_project": (run_gather_project, "deepfm-narrow", "serve", SERVE_B),
               "gather_project_grad": (run_gather_project_grad, "deepfm-narrow", "train",
                                       TRAIN_B),
               "fp16_compress": (run_fp16_compress, "deepfm-fp16", "train", TRAIN_B),
               "fp16_decompress": (run_fp16_decompress, "deepfm-fp16", "train", TRAIN_B),
               "topk_compress": (run_topk_compress, "deepfm-topk", "train", TRAIN_B),
               "topk_decompress": (run_topk_decompress, "deepfm-topk", "train", TRAIN_B),
               "dot_interaction": (run_dot, "dlrm-narrow", "serve", SERVE_B),
               "dot_interaction_bwd": (run_dot_bwd, "dlrm-narrow", "train", TRAIN_B)}
    main_shape = {}
    # the redesigned kernels'
    other_shapes = {"segment_grad": [], "tier_probe": [], "gather_pool": [],
                    "dot_interaction": [], "fm_interaction": [], "gather_project": [],
                    "fm_interaction_bwd": [], "topk_decompress": [], "fp16_compress": [],
                    "topk_compress": [], "fp16_decompress": [], "gather_project_grad": []}
    for name, (run, arch, path, main_b) in runners.items():
        for label, b in ((path, main_b), ("bulk", BULK_B)):
            r = run(b, gen, ARCHS[arch])
            print(f"[kernel] {name} {label} " + json.dumps(r), flush=True)
            if label != "bulk":
                main_shape[name] = r
            elif name in other_shapes:
                other_shapes[name].append({"label": "bulk", **r})
    # the embedding kernels again at dcn-v2's D = 16, n = B x 26, its table
    for name in ("tier_probe", "gather_pool", "segment_grad", "dedup_adagrad"):
        run, _, path, main_b = runners[name]
        r = run(main_b, gen, ARCHS["dcn-v2"])
        print(f"[kernel] {name} dcn-v2 {path} " + json.dumps(r), flush=True)
        if name in other_shapes:
            other_shapes[name].append({"label": f"dcn-v2 {path}", **r})
    # segment_grad at DLRM's D = 128, and on the path's own zipf data at
    # every training shape and at bulk (runs of hundreds of positions);
    # tier_probe at the training path's n, on DLRM's two tiers at D = 128,
    # and on edge cases
    dl = ARCHS["dlrm-narrow"]
    extra = {"segment_grad dlrm-narrow train": lambda: run_segment_grad(TRAIN_B, gen, dl)}
    for arch in ("deepfm", "dcn-v2", "dlrm-narrow"):
        extra[f"segment_grad {arch} train zipf"] = (
            lambda a=ARCHS[arch]: run_segment_grad(TRAIN_B, gen, a, zipf=True))
    extra.update({
        "segment_grad bulk zipf": lambda: run_segment_grad(BULK_B, gen, ARCHS["deepfm"],
                                                           zipf=True),
        "tier_probe deepfm train": lambda: run_tier_probe(TRAIN_B, gen, ARCHS["deepfm"]),
        "tier_probe dlrm-narrow L1 serve": lambda: run_tier_probe(SERVE_B, gen, dl),
        "tier_probe dlrm-narrow L2 serve": lambda: run_tier_probe(SERVE_B, gen, dl, l2=True),
        "tier_probe dlrm-narrow L1 train": lambda: run_tier_probe(TRAIN_B, gen, dl),
        "gather_pool deepfm train": lambda: run_gather_pool(TRAIN_B, gen, ARCHS["deepfm"]),
        "gather_pool dlrm-narrow serve": lambda: run_gather_pool(SERVE_B, gen, dl),
        "gather_pool dlrm-narrow train": lambda: run_gather_pool(TRAIN_B, gen, dl),
        "fm_interaction deepfm train": lambda: run_fm(TRAIN_B, gen, ARCHS["deepfm"]),
        "fm_interaction_bwd deepfm serve": lambda: run_fm_bwd(SERVE_B, gen, ARCHS["deepfm"]),
        "gather_project deepfm-narrow train": lambda: run_gather_project(
            TRAIN_B, gen, ARCHS["deepfm-narrow"]),
        "gather_project dlrm-narrow serve": lambda: run_gather_project(SERVE_B, gen, dl),
        "gather_project dlrm-narrow train": lambda: run_gather_project(TRAIN_B, gen, dl)})
    for label, run in extra.items():
        r = run()
        print(f"[kernel] {label} " + json.dumps(r), flush=True)
        name, shape = label.split(" ", 1)
        other_shapes[name].append({"label": shape, **r})
    print("[kernel] tier_probe edge cases " + json.dumps(run_probe_edges(gen)), flush=True)
    print("[kernel] gather_pool layouts and widths (err of scale) "
          + json.dumps(run_pool_edges(gen)), flush=True)
    # the narrow configuration: the stitch and its transpose at the other
    # path's batch too, dedup_adagrad on the d = 4 master, the L2 probe
    narrow = ARCHS["deepfm-narrow"]
    extra = {"gather_project_grad serve": lambda: run_gather_project_grad(SERVE_B, gen,
                                                                          narrow),
             "dedup_adagrad narrow-master train": lambda: run_dedup_adagrad(TRAIN_B, gen,
                                                                            narrow),
             "dedup_adagrad narrow L2 tier train": lambda: run_dedup_adagrad(
                 TRAIN_B, gen, narrow, tier=True),
             "tier_probe L2 serve": lambda: run_tier_probe(SERVE_B, gen, narrow, l2=True)}
    extra.update({
        "gather_project_grad dlrm-narrow train": lambda: run_gather_project_grad(TRAIN_B, gen,
                                                                                 dl),
        "gather_project_grad dlrm-narrow serve": lambda: run_gather_project_grad(SERVE_B, gen,
                                                                                 dl)})
    for label, run in extra.items():
        r = run()
        print(f"[kernel] {label} " + json.dumps(r), flush=True)
        if label.startswith("tier_probe"):
            other_shapes["tier_probe"].append({"label": "deepfm-narrow L2 serve", **r})
        elif label.startswith("gather_project_grad"):
            shape = label.split(" ", 1)[1]
            other_shapes["gather_project_grad"].append(
                {"label": shape if "dlrm" in shape else "deepfm-narrow serve", **r})
    print("[kernel] gather_project_grad edge lists (err of scale) "
          + json.dumps(run_gather_project_grad_edges(gen)), flush=True)
    # the compression kernels at the other masters' widths: dcn-v2's D = 16
    # (k = 4) and the narrow d = 4 (k = 1), fp16_decompress also at DLRM's
    # d = 32; and on edge rows
    for name in ("fp16_compress", "fp16_decompress", "topk_compress", "topk_decompress"):
        others = ("dcn-v2", "deepfm-narrow") + (("dlrm-narrow",) if name == "fp16_decompress"
                                               else ())
        for other in others:
            r = runners[name][0](TRAIN_B, gen, ARCHS[other])
            print(f"[kernel] {name} {other} train " + json.dumps(r), flush=True)
            if name in other_shapes:
                other_shapes[name].append({"label": f"{other} train", **r})
    print("[kernel] compression edge rows " + json.dumps(run_compress_edges()), flush=True)
    print("[kernel] fp16_decompress edge payloads and views "
          + json.dumps(run_fp16_decompress_edges(gen)), flush=True)
    # the dot kernels at the other path's batch, at the bench config's D = 16
    # (B = 256), and on edge shapes
    # the cross forward at the training path's B = 256 (3 launches a step),
    # and both cross kernels on edge shapes
    dcn = ARCHS["dcn-v2"]
    second_shape = {"cross_layer": run_cross(TRAIN_B, gen, dcn)}
    print("[kernel] cross_layer train " + json.dumps(second_shape["cross_layer"]), flush=True)
    print("[kernel] cross edge shapes (largest err of scale) "
          + json.dumps(run_cross_edges(gen)), flush=True)
    # dedup_adagrad on DLRM's d = 32 master and its D = 128 L2 tier, then
    # on deepfm's master with rows repeated 1,000, 33 and 2 times
    for label, run in {
            "dedup_adagrad dlrm-narrow master train": lambda: run_dedup_adagrad(TRAIN_B,
                                                                              gen, dl),
            "dedup_adagrad dlrm-narrow L2 tier train": lambda: run_dedup_adagrad(
                TRAIN_B, gen, dl, tier=True),
            "dedup_adagrad skewed rows (1000, 33, 2) train": lambda: run_dedup_adagrad(
                TRAIN_B, gen, ARCHS["deepfm"], skew=True)}.items():
        print(f"[kernel] {label} " + json.dumps(run()), flush=True)
    # segment_grad and dedup_adagrad at the unpacked path's per-table shapes
    print("[kernel] per-table shapes of the unpacked path "
          + json.dumps(run_table_shapes(gen)), flush=True)
    _TABLES.clear()
    torch.cuda.empty_cache()
    print("[kernel] dot_interaction plan boundaries "
          + json.dumps(run_dot_fwd_plans(gen)), flush=True)
    extra = {"dot_interaction train": lambda: run_dot(TRAIN_B, gen, dl),
             "dot_interaction_bwd serve": lambda: run_dot_bwd(SERVE_B, gen, dl),
             "dot_interaction bench D=16": lambda: run_dot(TRAIN_B, gen, dl, d=16),
             "dot_interaction_bwd bench D=16": lambda: run_dot_bwd(TRAIN_B, gen, dl, d=16),
             "dot edge shapes (err of scale: fwd, bwd)": lambda: run_dot_edges(gen)}
    for label, run in extra.items():
        r = run()
        print(f"[kernel] {label} " + json.dumps(r), flush=True)
        if label.startswith("dot_interaction "):
            other_shapes["dot_interaction"].append({"label": label.split(" ", 1)[1], **r})
    _TABLES.clear()
    torch.cuda.empty_cache()
    print(f"[wall] kernels checked at {time.perf_counter() - t_start:.1f}s", flush=True)

    runs = {}
    for arch in MAIN:  # phases 3-8
        serve_and_train(arch, runs, t_start)

    base = runs["deepfm", "train"]
    for arch in COMPRESSED:
        train = runs[arch, "train"] = train_full_width(arch)
        print(f"[train] {arch} full width " + json.dumps(train), flush=True)
        print_step_kernels(arch, train)
        print(f"[train] {arch} B={TRAIN_B}: step p50={train['step_p50_ms']:.3f}ms "
              f"p99={train['step_p99_ms']:.3f}ms flush step={train['flush_step_ms']:.1f}ms; "
              f"uncompressed deepfm p50={base['step_p50_ms']:.3f}ms "
              f"p99={base['step_p99_ms']:.3f}ms flush step={base['flush_step_ms']:.1f}ms; "
              f"kernel vs plain 30-step loss diff={train['max_abs_loss_diff']:.3g}",
              flush=True)
        torch.cuda.empty_cache()
        print(f"[wall] {arch} done at {time.perf_counter() - t_start:.1f}s", flush=True)
    serve_and_train("dlrm-narrow", runs, t_start)  # phases 10-11
    for arch in MIXED_PATHS:  # phases 12-13
        serve_and_train(arch, runs, t_start)
    t_phase = time.perf_counter()
    drive_baselines()
    print(f"[wall] baselines done at {time.perf_counter() - t_start:.1f}s "
          f"(these {time.perf_counter() - t_phase:.1f}s)", flush=True)
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    runtime_phase(runs)  # phase 14
    print(f"[wall] runtime done at {time.perf_counter() - t_start:.1f}s "
          f"(phase 14 {time.perf_counter() - t_phase:.1f}s)", flush=True)
    torch.cuda.empty_cache()
    other_shapes["dedup_adagrad"] = []
    for name, rows in seq_phase(runs, t_start).items():  # phase 15
        other_shapes[name] += rows
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    pinned, host_rows_launches = pin_phase(runs, t_start)  # phase 16
    print(f"[wall] phase 16 done at {time.perf_counter() - t_start:.1f}s "
          f"(phase 16 {time.perf_counter() - t_phase:.1f}s)", flush=True)
    for name in ("tier_probe", "dedup_adagrad"):
        other_shapes[name] += pinned[name]
    world = world_phase(runs, t_start)  # phase 17
    print("[world] " + json.dumps(world), flush=True)
    bs = world["bytes_per_step_per_rank"]
    print(f"[phase 17] {card_stamp()}: 4 ranks time-sharing one card over gloo (not "
          f"NCCL numbers), full-width deepfm mesh {world['mesh']}: request B={SERVE_B} "
          f"p50={world['request_p50_ms']:.3f}ms p99={world['request_p99_ms']:.3f}ms "
          f"(world 1 p50={world['world1_request_p50_ms']:.3f}ms); step B={TRAIN_B} "
          f"p50={world['step_p50_ms']:.3f}ms p99={world['step_p99_ms']:.3f}ms; bytes a "
          f"step a rank: all_to_all={bs['all_to_all']:.0f} psum={bs['psum']:.0f} "
          f"all_gather={bs['all_gather']:.0f}; probs err {world['probs_max_abs_err']:.3g}; "
          f"overflow steps 1-20 {world['flush']['overflow_steps_1_20']}", flush=True)
    ft = ft_phase(t_start)  # phase 18
    print("[ft] " + json.dumps(ft), flush=True)
    rss_s = [round(b / 2**20, 1) for b in ft["save_rss_peak_above_base_by_rank"]]
    rss_r = [round(b / 2**20, 1) for b in ft["restore_rss_peak_above_base_by_rank"]]
    print(f"[phase 18] {card_stamp()}: 4 ranks time-sharing one card over gloo (not NCCL "
          f"numbers), full-width deepfm mesh {ft['mesh']} under the Supervisor, the guard "
          f"and chaos {ft['chaos']}: checkpoint {ft['checkpoint_bytes'] / 1e9:.2f} GB "
          f"({ft['codec']}) save {ft['save_gb_per_s']:.2f} GB/s (median of "
          f"{len(ft['save_s_by_step'])} saves, written while the steps run) restore "
          f"{ft['restore_gb_per_s']:.2f} GB/s ({ft['restore_s']:.2f}s, a fresh spawn); host RSS "
          f"peak above base per rank MiB: save {rss_s} restore {rss_r}; crash to the first "
          f"replayed step {ft['crash_to_first_replayed_step_s']:.2f}s; step p50 "
          f"{ft['step_p50_ms_guarded']:.3f}ms guarded vs {ft['step_p50_ms_unguarded']:.3f}ms "
          "unguarded", flush=True)
    el = elastic_phase(t_start)  # phase 19
    print("[elastic] " + json.dumps(el), flush=True)
    rss = [round(max(el[k]["rss_above_base_by_rank"][i] for k in ("reshard_4_2", "reshard_2_4"))
                 / 2**20, 1) for i in range(WORLD)]
    sp = el["step_p50_ms"]
    print(f"[phase 19] {card_stamp()}: 4 or 2 ranks time-sharing one card over gloo (not "
          f"NCCL numbers), full-width deepfm, exact_capacity, mesh 2x2 -> 2x1 -> 2x2: "
          f"reshard 4 -> 2 {el['reshard_4_2']['bytes_sent'] / 1e9:.3f} GB sent in "
          f"{el['reshard_4_2']['s']:.2f}s, 2 -> 4 {el['reshard_2_4']['bytes_sent'] / 1e9:.3f} "
          f"GB in {el['reshard_2_4']['s']:.2f}s; host RSS peak above base per rank MiB "
          f"{rss}; step p50 world 4 {sp['world4']:.3f}ms, world 2 {sp['world2']:.3f}ms, "
          f"world 4 again {sp['world4_again']:.3f}ms; restore at world 2 "
          f"{el['restore_gb_per_s']:.2f} GB/s ({el['restore_world2_fresh_s']:.2f}s, a fresh "
          f"2-rank spawn), at world 1 {el['restore_world1_s']:.2f}s; "
          f"{el['sentinels_remapped_world1']} tier sentinels remapped at world 1", flush=True)
    sm = stream_phase(t_start, world["request_p50_ms"])  # phase 20
    print("[stream] " + json.dumps(sm), flush=True)
    gbs = {s: round(v["gb_per_s"], 3) for s, v in sm["publish"].items()}
    ld, sp = sm["load_s"], sm["step_p50_ms"]
    print(f"[phase 20] {card_stamp()}: 4 then 2 trainer ranks and 2 serving ranks "
          f"time-sharing one card over gloo (not NCCL numbers), full-width deepfm, "
          f"exact_capacity, stream 3 x {STREAM_SEG} steps, reshard 4 -> 2 at step "
          f"{STREAM_SEG}, torn@{STREAM_TORN}: publish GB/s by step {gbs}; load at world 2 "
          f"{ld['step5_recut_4_to_2']:.2f}s (step 5, recut 4 -> 2), "
          f"{ld['step15_same_world']:.2f}s (step 15, same world), at world 1 "
          f"{ld['step15_recut_2_to_1_world1']:.2f}s (recut 2 -> 1); failed attempts s "
          f"{[round(x, 2) for x in ld['failed_attempts']]}; poll p50 "
          f"{sm['poll_ms_p50']:.3f}ms a request (phase 17's request p50 "
          f"{sm['phase17_request_p50_ms']:.3f}ms), serve p50 {sm['serve_ms_p50']:.3f}ms "
          f"over {sm['requests']} requests {sm['kinds']}; step p50 world 4 "
          f"{sp['world4']:.3f}ms, world 2 {sp['world2']:.3f}ms; checkpoint resumed at world "
          f"1 in {sm['resume_world1_s']:.2f}s", flush=True)

    kernels = []
    for name, (src, replaces) in SOURCES.items():
        if name == "host_rows":
            # its main path is phase 16's pinned DLRM (300 requests, 30
            # steps); the time is the gather at the master's training shape
            r = next(x for x in pinned["host_rows"] if "master" in x["label"])
            kernels.append({
                "name": name, "route": "cuda", "source": src, "replaces": replaces,
                "replaces_note": "no pallas_call: an XLA gather in the reference",
                "launches": host_rows_launches,
                "path": "dlrm-narrow --pin-l2 serve + train",
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "plain_on": r["plain_on"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "bound_note": "bus bytes at the measured rate",
                "library_ms": r["library_ms"],
                "shapes": [{k: x.get(k) for k in (
                    "label", "n", "d", "rows", "ms", "scatter_ms", "plain_ms", "bound_ms",
                    "scatter_bound_ms", "bound_by")} for x in pinned["host_rows"]]})
            continue
        r = main_shape[name]
        # each kernel's launches on the main path it was ported for
        arch, path = PORTED_FOR[name]
        a = ARCHS[arch]
        launches = runs[arch, path]["launches"][name]
        where = (f"{a.config} {path} (grad_compress={a.grad_compress})"
                 if arch in COMPRESSED else f"{arch} {path}")
        if name == "gather_pool":  # once a request and once a step
            launches += runs[arch, "train"]["launches"][name]
            where = f"{arch} serve + train"
        # phase 17's 20 requests and 30 steps, each rank's own launches
        world4 = ([t[name] + sv.get(name, 0)
                   for t, sv in zip(world["train_launches_by_rank"],
                                    world["serve_launches_by_rank"])]
                  if name in WORLD_KERNELS else None)
        # phase 18's supervised run, each rank's own launches
        ft4 = ([la[name] for la in ft["launches_by_rank"]] if name in WORLD_KERNELS
               else None)
        # phase 19's 10 steps at world 2 after the live reshard, each rank's own
        el2 = ([la[name] for la in el["launches_world2_by_rank"]] if name in WORLD_KERNELS
               else None)
        # phase 20's stream (4 trainer ranks, 2 after step 5; 2 serving ranks)
        st20 = ({"trainer": [la[name] for la in sm["launches_by_rank"]],
                 "server": [la.get(name, 0) for la in sm["server_launches_by_rank"]]}
                if name in WORLD_KERNELS else None)
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches, "path": where,
                        "launches_world4_by_rank": world4,
                        "launches_world4_supervised_by_rank": ft4,
                        "launches_world2_resharded_by_rank": el2,
                        "launches_stream_by_rank": st20,
                        # the kernel's launches on every path run (300 requests,
                        # 30 steps each)
                        "launches_by_path": {f"{ar} {pa}": r2["launches"][name]
                                             for (ar, pa), r2 in runs.items()
                                             if r2["launches"].get(name)},
                        "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        if name.startswith("cross_layer"):
            kernels[-1].update({"cluster": r["cluster"], "tile": r["tile"],
                                "fp32_bound_ms": r["fp32_bound_ms"]})
        if name in second_shape:  # the same kernel at its other path's shape
            r2 = second_shape[name]
            kernels[-1]["shapes"] = [{k: r2[k] for k in (
                "n", "cluster", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "fp32_bound_ms", "library_ms")}]
        if name in other_shapes:  # the redesigned kernels at every other shape
            kernels[-1]["shapes"] = [{k: r2.get(k) for k in (
                "label", "n", "m", "d", "k", "narrow_d", "plan", "case", "tier_keys", "lanes",
                "longest_run", "max_abs_err", "ms", "plain_ms", "library_ms", "sorting_ms",
                "device_copy_ms", "bound_ms", "bound_by")} for r2 in other_shapes[name]]
        if name == "gather_project_grad":
            # the engine's backward folds the cotangent through proj^T itself,
            # as the reference's does; the kernel is reached through the
            # autograd of ops.gather_project and standalone (phase 2)
            kernels[-1]["launches_note"] = "0 per step; autograd and standalone only"
    print(f"[wall] chip_smoke {time.perf_counter() - t_start:.1f}s, builds included",
          flush=True)
    print(card_stamp(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    main()

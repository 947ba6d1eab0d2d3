#!/usr/bin/env python3
"""Drive the PyTorch port's lookup, write, scan, split, separator, route-table,
repartition, pipelined-engine, fleet-cache-policy, two-route-axis, telemetry and
host-fallback paths, its paged-KV serving of minitron-4b and of the MoE
model granite-moe-1b-a400m, its Mamba serving of falcon-mamba-7b and
zamba2-2.7b, its MLA serving of minicpm3-4b, its encoder-decoder
serving of whisper-small, its training of minitron-4b and zamba2-2.7b, and
its training launcher (``launch/train.py``: minicpm3-4b, whisper-small,
granite-moe-1b-a400m and falcon-mamba-7b at full width, checkpoints,
failures and a resume) with each training run's peak predicted first by
the dry-run on the meta device, on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--seed 0] [--n-keys 200000000]

Phases, in order; any failure exits non-zero:

  1. device: the card's name and power limit (``nvidia-smi``), CUDA version;
  2. build: compile the CUDA kernels from ``src/repro_torch/csrc``; count
     the tensor-core products (HGMMA) and TMA loads (UTMALDG) in the bf16
     ``flash_attention`` kernels' SASS and in its backward's dK / dV and dQ
     kernels', which must have both (the backward's no ``mma.sync``
     product, HMMA), and the
     ``mma.sync`` products (HMMA) and ``cp.async`` copies (LDGSTS) in the
     bf16 ``paged_attention`` kernels', which must have both, and the
     ``cp.async`` copies (LDGSTS) in the ``mamba_scan`` kernels', which must
     have them, with their exponentials (MUFU.EX2) and FP32 operations in
     all and in the unrolled block of steps, and in its backward's
     (``mamba_scan_bwd_kernel``) the ``cp.async`` copies (LDGSTS) and
     exponentials (MUFU.EX2), which it must have, its shuffles, and
     atomics (ATOM, RED), which neither it nor the launch that adds its
     partials may have; ptxas' registers and spills of each ``mamba_scan``
     kernel and of each of its backward's beside the registers their plans
     assume;
  3. kernels: ``node_search``, ``subtree_walk``, ``leaf_write``,
     ``leaf_scan``, ``leaf_split`` and ``node_search_prefix`` at the main
     path's shapes
     (65,536-lane batches on a 2x4 virtual mesh) on seeded inputs with
     misses, KEY_MIN / KEY_MAX, negative keys and queries below a row's
     first key (for ``leaf_write``: rows with only updates, only inserts,
     both and nothing staged, rows filled to exactly 64, staged keys below
     and above a row's keys; for ``leaf_scan``: real windows of the index
     with starts below, inside and past a leaf, counts of 0, 1, 100 and
     above, and inactive slots; for ``leaf_split``: rows with nothing
     staged, merges without a split, splits at m = 65 and m = 128; for
     ``node_search_prefix``: the index's compressed rows along real
     descents, compressible, incompressible and empty),
     bit-equal to their plain PyTorch versions, and timed beside the plain
     version and a PyTorch yardstick where one exists; ``node_search`` on
     three mixes, (i) those rows with values, (ii) without, (iii) one
     engine descent level (16 route buckets of 16,384 slots, 4,096 live,
     the rest all-KEY_MAX padding), with and without values, plus (i)
     with its KEY_MAX queries turned into hits and (ii) at 1,048,576
     rows, and ``node_search_prefix``,
     each with every variant of the kernel held to the plain version and
     timed with the L2 cold (a 256 MB scratch written and read between
     calls) and hot, beside ``torch.searchsorted``; ``subtree_walk`` the
     same way on two mixes, (contract) 1,048,576 lanes that all walk and
     (engine) the engine's exchange, 32 buckets of 32,768 slots, 2,048
     live at each front, the rest KEY_MAX padding it does not walk
     (``active``), its default, every variant and ``W`` (the first design,
     a warp a lane) beside the bound and the bytes the default's reads
     fetch in 32-byte sectors and 64-byte L2 granules; then
     ``paged_attention`` (64 requests, 24 heads over 8 of 128, a pool of
     4,096 pages of 16 tokens with stale rows everywhere, lengths 0, 1, page
     boundaries, partial pages and the whole 36-page table; its
     log-sum-exp within 1e-3 in bf16 and 1e-5 in f32, -inf at length 0;
     timed as serving calls it, with the L2 cold and hot, beside a gather
     plus SDPA, and again for 8 requests at the full table and for
     granite-moe-1b-a400m's 16 heads over 8 of 64) and
     ``flash_attention`` ([2, 24, 2048, 128] against [2, 8, 2048, 128],
     causal; Sq < Sk; a length that is not a multiple of 64; non-causal;
     zamba2-2.7b's head dim of 80 at [2, 32, 2048, 80] and with Sq < Sk;
     D = 64 non-causal; granite's [2, 16, 2048, 64] over [2, 8, 2048, 64];
     D = 96 at [1, 40, 300, 96]), in bf16 and f32, within 2e-2 and 1e-4 of
     their plain versions, flash timed cold and hot at minitron-4b's,
     zamba2-2.7b's, granite's and minicpm3-4b's prefill shapes (the last
     [2, 40, 2048, 96] with v 64 wide, zero-padded to 96 as ``sdpa`` passes
     it, and held to its plain version) beside SDPA on the unpadded
     operands and its bound at the true head dims, with the padded share of
     each product, and at whisper-small's three non-causal shapes (D = 64,
     12 heads over 12), each held in bf16 and f32 and timed the same way:
     the encoder's [64, 12, 1500, 64], the prefill's cross attention [8,
     12, 448, 64] over [8, 12, 1500, 64] and the decode step's [64, 12, 1,
     64] over [64, 12, 1500, 64] (with the padded share of the 128-row q
     tiles); then the ``flash_attention`` backward kernel against its plain
     version on the forward kernel's own output and log-sum-exp (each of
     dq, dk, dv within 2e-2 of its largest magnitude in bf16, 1e-4 in f32;
     two launches bit-equal; the forward's log-sum-exp within 1e-3 and
     1e-5) at minitron-4b's training shape [2, 24, 4096, 128] over 8 kv
     heads, granite's [2, 16, 2048, 64] over 8 (both causal), whisper's
     non-causal [8, 12, 448, 64] over [8, 12, 1500, 64], zamba2-2.7b's
     [2, 32, 2048, 80] and minicpm3-4b's [2, 40, 2048, 96] (causal, G = 1),
     and two small f32 cases, the bf16 ones timed cold and hot beside the
     plain version, the bound (10 D flops a kept pair and head; the rate
     printed at 10 D and at the 14 D the kernels execute) and
     ``torch.autograd.grad`` of SDPA's output for the same dO; then
     ``mamba_scan`` at falcon-mamba-7b's prefill shape ([2, 2048, 8192],
     N = 16) and zamba2-2.7b's ([2, 2048, 5120], N = 64), operands in bf16
     and f32, at init scales with decay-heavy channels, plus a width off
     the block, L = 1 and ROADMAP queue 3 entry 14's input (2.313), y and
     the final state within 1e-4 + 1e-4 |plain|, timed at the default plan
     and its variants (``mamba_scan.variants``; each held to the plain
     version too) beside the bytes and exponential bounds and the issue
     floor counted from the SASS; then the ``mamba_scan`` backward kernel
     on the forward kernel's saved states against its plain version at
     zamba2-2.7b's training shape ([2, 4096, 5120], N = 64),
     falcon-mamba-7b's ([2, 4096, 8192], N = 16) and an odd one ([2, 67,
     333], N = 8: L off the 32-step chunk, D off the CTA), operands in bf16
     and f32, ``dh_last`` null and not (each gradient within 1e-4 of its
     largest plain magnitude; two launches bit-equal; the odd shape equal
     to the kernel's torch decomposition bit for bit; the forward with its
     states bit-equal to the forward without), the training shapes timed
     cold and hot beside the plain version and the bound (bytes, or ``B L
     D N`` exponentials; and the 1.75 a state and step the design runs);
  4. the port on the CPU and on the card give the same lane results and
     state planes (20k keys, 2x4 mesh, 3 batches): lookups under ``fetch``,
     ``fetch`` with shedding buckets and ``auto``; mixed lookups, updates
     and inserts (hot keys written in every batch, one leaf driven past its
     slack) under ``fetch``, ``fetch`` with shedding buckets, ``offload``
     and ``auto``; the same with scans (``ops=ALL_OPS``); the mixed engine
     with a trained route table (``fetch``, ``offload``, ``auto``) and a
     poisoned one; the pipelined mixed engine under ``fetch`` and ``auto``
     and the pipelined engine with scans (every plane after every push and
     the drain); the divergent fleet-cache policy (peek budget 512) on the
     mixed engine, on lookups and pipelined on lookups and updates;
     ``install_boundaries`` then two batches; one SMO
     round after a burst that overflows eight leaves, then
     ``refresh_sep_planes``; the lookup, mixed and scan engines on a 2x2x2
     virtual mesh (two route axes of 2 x 2 over 2 memory columns, their
     collective counts too); one ``settle_splits`` that settles three
     leaves on the mesh and drains the rest through a ``HostBTree`` mirror
     (a block with three free rows), then a lookup batch through the
     rebuilt ops (the mirror's planes compared too); every plane compared,
     the pool's included; and
     the LM path on reduced minitron-4b (2 layers, d_model 64) in f32 and
     bf16: ten paged decode steps of three requests, one admitted after a
     release, and one ``prefill`` (tables equal, logits within 1e-4 in f32
     and 0.05 x RMS in bf16), and the same for reduced granite-moe-1b-a400m
     and grok-1-314b (top-2 of 4 and of 8 experts; every routing choice
     equal in f32; in bf16 the agreement reported and the logits held where
     no flipped choice reaches); reduced falcon-mamba-7b and zamba2-2.7b in
     f32 and bf16: a ``prefill``, then ten ``decode_step``s of three slots,
     one zeroed after a release (the same limits); reduced minicpm3-4b with
     v 8 wide against q and k 16 (``sdpa`` pads v), a ``prefill`` and ten
     ``decode_step``s, one slot zeroed after a release (the same limits);
     reduced whisper-small (2 + 2 layers) over 48 frames a request: a
     ``prefill`` with the frames, ``prefill_cross_kv`` and ten
     ``decode_step``s of three slots (the logits and the cross planes, the
     same limits);
  5. the main path at full size (one YCSB-C ``fetch`` and one ``offload``
     warm-up batch print what each of their ``node_search`` calls sees:
     rows, KEY_MAX share, all-KEY_MAX rows, values; and each
     ``subtree_walk`` call: lanes, share walked; each profiled batch,
     node_search's and subtree_walk's device ms and share): 200M sorted int64 keys made on the card
     from ``--seed``, level-M = 1 subtree blocks at fill 0.7, a 2x4 virtual
     mesh split at the median key, 65,536 sets x 4 ways of cache per
     virtual device, 65,536-lane batches of YCSB workload C (100% reads)
     under ``offload``, ``fetch`` and ``auto``, then on the same index YCSB
     workload A (50% reads, 50% updates) under ``offload``, ``fetch`` and
     ``auto`` and the paper's insert-intensive mix (50% inserts, 50% reads)
     under ``fetch`` and ``offload``, all scrambled Zipfian, theta 0.99.
     Then, on the same index: the compressed separator planes built at
     load; a split burst (32 fresh keys into each of 2,048 leaves, every
     lane shed ``STATUS_SPLIT`` and settled by ``run_smo`` with exactly
     2,048 on-mesh splits); the planes refreshed (``refresh_sep_planes``)
     and held to a fresh build, and the burst's and a YCSB-C batch's keys
     descended through them with ``node_search_prefix`` held to
     ``node_search`` at every level; a 65,536-lane scan batch across the
     split leaves; YCSB workload E (95% scans of uniform length 1-100, 5%
     inserts) under ``fetch`` and ``offload``, its split lanes settled by
     ``run_smo`` after each batch; a route table of 2**23 slots trained on
     the pool, and YCSB-C and YCSB-A under ``fetch`` in three arms over one
     trace (descent only, leaf-direct, poisoned; the poisoned arm must
     equal the descent arm); and a localized YCSB-C Zipfian (hotspot 0.2,
     then 0.8) under tight buckets, static and with a
     ``RepartitionController``, which must shed fewer lanes; the pipelined
     engine (``pipeline``) against the synchronous one in turns over the
     same batches from the same contents (the pipeline on a copy of the key
     and value planes): YCSB-A under ``fetch`` and ``auto`` (1 warm-up and
     10 timed batches; lanes, statuses and the pool, occupancy and version
     planes after the drain equal), then YCSB-E under ``fetch`` (1 and 5;
     lanes equal where neither shed, the pipeline's extra sheds only
     stall-shed scans, the splits settled after the drain), with stalls a
     batch and one profiled step of each; and the fleet-cache policy
     (``fleet-policy``): YCSB-C under ``fetch`` through a uniform and a
     divergent engine (peek budget 8,192, a device's lanes) in turns from
     cold caches (5 warm-up, 10 timed batches), hits, fetches, peer hits
     and misses, the effective fleet hit rate, equal collective counts,
     then every cached row poisoned and every version bumped and one more
     batch; two route axes (``route-axes``): YCSB-A and YCSB-E under
     ``auto`` on a 2x2x2 virtual mesh (four route partitions of equal key
     count) in turns with the 2x4 engine (1 warm-up and 5 timed batches,
     the 2x2x2 engine on a copy of the key and value planes), each batch's
     collective counts equal to the CPU program's (two ``all_to_all`` a
     route exchange); the telemetry plane (``telemetry``): YCSB-A under
     ``auto`` on the 2x4 engine wrapped by ``BatchTimeline.instrument`` in
     turns with a bare one (lanes, stats, histograms and counts equal, the
     histogram's total the ``STAT_OPS`` delta, no collective under
     ``dex/lat``), a Chrome trace written to ``traces/``, and the
     reference's fig19 mesh-against-simulator gate at 60,000 keys (p50 and
     p99 of lookups and updates within one bucket of the port's
     ``Simulator`` on the host); last on the index, the SMO's host fallback
     (``drain``): a ``HostBTree`` mirror of the contents (build seconds,
     the host's peak RSS), YCSB's ordered load of 65,536 fresh keys above
     the largest into the rightmost leaf through the insert engine, its
     ``STATUS_SPLIT`` lanes through ``settle_splits`` (the drain must
     fire: ``STAT_DRAINS`` 1, the other stats carried over), the ops
     rebuilt, every inserted key read back and a YCSB-C batch equal to the
     mirror, with the ms of each part.  A host oracle carries the applied
     writes forward; every lane that is not shed must match it, scans
     included;
  6. serving at full width and half depth (``SERVE_DEPTH``; the index freed
     first): minitron-4b, 16 of its 32 layers,
     bf16, weights from ``--seed``; 64 request slots over a pool of 4,096
     pages of 16 tokens (8.6 GB of KV), 36 pages a request; seeded prompts
     of 32-512 tokens fed a token a step, then 64 greedy tokens; a finished
     request is released (a range delete of its page keys) and a new one
     admitted in its slot; 640 decode steps, each resolving the batch's page
     tables with one index lookup and running ``paged_attention`` in every
     layer.  A host oracle of (request, page index) -> page must equal every
     live table entry every step, no page may be held twice, and every page
     is free at the end; at every 64th step each layer's kernel call is
     also run through its plain version on the same inputs (max abs error
     <= 2e-2, log-sum-exp <= 1e-3) and the step is repeated with the plain
     attention: RMS of the logit difference <= 0.05 x RMS of the logits
     (its max and the greedy agreement are reported: in bf16 over 32
     layers the max sits near 0.1 x RMS for any attention that is not
     bit-identical).  Then ``prefill`` over two
     2,048-token sequences (tokens/s, ``flash_attention`` ms per call and
     share, one more call with every layer's kernel call held to its plain
     version's f32 result, before its rounding to bf16, within 2e-2, the
     device ms of ``sdpa``'s transposes) and
     two served requests replayed through it (max |dlogit| / RMS and greedy
     agreement, reported);
     6b. (minitron-4b freed) falcon-mamba-7b at full width, 32 of its 64
     layers, bf16:
     64 slots decoded through ``decode_step`` (the recurrent state),
     seeded prompts of 32-512 tokens fed a token a step, then 64 greedy
     tokens, a finished request's slot zeroed and a new one admitted, 640
     steps; 8 finished requests replayed through ``prefill`` (the kernel in
     every layer), RMS of the logit difference <= 0.05 x RMS at every
     generated position; ``prefill`` over 2 x 2,048 tokens, once with every
     layer's kernel call held to its plain version (phase 3's tolerance);
     6c. zamba2-2.7b at full width, 54 layers, bf16: ``prefill`` over
     2 x 2,048 tokens (``mamba_scan`` at N = 64 in every layer,
     ``flash_attention`` at head dim 80 in the 9 shared-block calls, each
     held to its plain version once, as for minitron-4b), then 128 decode
     steps of 32 slots;
     6d. (the earlier models freed) granite-moe-1b-a400m at full width, 12
     of its 24 layers, bf16, 32 experts top-8 at a capacity factor of 1.25: phase 6's
     traffic and checks through the DEX page table (4,096 pages, 3.2 GB of
     KV), the checked steps also reporting the routing agreement of the
     kernel and plain steps and the pairs dropped, the profiled step the
     MoE blocks' device ms (``MOE_BLOCK``); then ``prefill`` over 2 x 2,048
     tokens as for minitron-4b, with its dropped pairs;
     6e. (the earlier models freed) minicpm3-4b at full width, 31 of its 62
     layers, bf16, MLA: ``prefill`` over 2 x 2,048 tokens as for minitron-4b
     (``flash_attention`` at q, k 96 wide and v 64 padded to 96, 31 calls,
     each held to its plain version once); then 256 ``decode_step``s of 64
     slots in lockstep over the compressed cache (``c_kv``, ``k_rope``) of
     256 positions, greedy after a seeded first token, logits finite, one
     step profiled; two slots' 256 tokens replayed through ``prefill`` (max
     |dlogit| / RMS and greedy agreement, reported);
     6f. (the earlier models freed) whisper-small at full width, 12 encoder
     and 12 decoder layers, bf16: the encoder over 64 slots x 1,500 seeded
     frames into a 3.5 GB cross cache (``prefill_cross_kv``, frames/s, a
     profile with ``flash_attention`` by shape and ``sdpa``'s transposes);
     ``prefill`` over 8 x 448 tokens with their frames as for minitron-4b
     (36 flash calls: the encoder's, the decoder's causal ones and the
     cross attention's), profiled by shape; 448 ``decode_step``s of the 64
     slots in lockstep over the cross cache and a self cache of 448
     positions, greedy after a seeded first token, logits finite, one step
     profiled, one step's 12 cross-attention calls (one query row over
     1,500 keys) held to their plain version; two slots replayed through
     ``prefill`` with their frames (max |dlogit| / RMS and greedy
     agreement, reported);
     6g. (the earlier models freed) training of minitron-4b at full width,
     32 layers, bf16, remat: weights from ``--seed`` on the card,
     ``make_train_step`` with AdamW (bf16 moments, 3 steps, 1 of warm-up)
     on three 2 x 4,096-token batches of the port's ``TokenPipeline``;
     first batch 0's gradients with each of the 32 backward kernel calls
     held to its plain version, every leaf's gradient finite and not all
     zero; each step's loss, ms and tokens/s, the peak memory, the loss on
     batch 0 after the updates (must fall), one step profiled (device busy,
     the shares of the flash forward and backward and ``sdpa``'s
     transposes) and the flops a step (6 N tokens, reported);
     6h. (minitron-4b freed) training of zamba2-2.7b at full width, 54
     Mamba layers, d_model 2560, the shared GQA block after every 6, bf16,
     remat, as 6g: batch 0's gradients with one in three ``mamba_scan_bwd``
     calls (18, at least one in each group of six layers) held to the
     plain version within 1e-4 and all 9 ``flash_attention_bwd`` calls
     within 2e-2; every gradient finite and not all zero; each step's loss,
     ms and tokens/s, the peak memory, batch 0's loss after step 1's update
     on it (must fall; after the 3 updates it is reported: under this
     schedule it swings back up), one step profiled (device busy, the
     shares of the ``mamba_scan`` forward and backward, the flash forward
     and backward, the weight products and ``ADAMW_UPDATE``), the flops a
     step (6 N tokens, and with the shared block counted at each
     application);
  7. the equivalence gates in float32: minitron-4b cut to 4 layers, four
     requests of 256 seeded tokens through paged decode, dense
     ``decode_step`` and ``prefill``, pairwise max |dlogit| <= 1e-3 x RMS;
     falcon-mamba-7b cut to 4 layers and zamba2-2.7b to 6 (one shared
     block), ``prefill`` against ``decode_step``, the same limit;
     granite-moe-1b-a400m cut to 4 layers at a capacity factor of 4.0 (=
     experts / top-k: no pair dropped), as for minitron-4b; minicpm3-4b cut
     to 4 layers, ``prefill`` (the f32 flash kernel at D = 96, v padded
     from 64) against ``decode_step`` over the compressed cache, the same
     limit; whisper-small cut to 4 encoder and 4 decoder layers over 1,500
     frames, ``prefill`` against ``prefill_cross_kv`` and ``decode_step``,
     the same limit; minitron-4b cut to 4 layers, falcon-mamba-7b to 4 and
     zamba2-2.7b to 6 (one shared block), one train step's loss and
     gradients over 2 x 2,048 pipeline tokens with the kernels against the
     same with every flash and ``mamba_scan`` call, forward and backward,
     run as its plain version: the loss within 1e-5 relative, each
     gradient within 1e-3 x its RMS;
  7b. ``launch``: minicpm3-4b (62 MLA layers, 2 x 4,096 tokens),
     whisper-small (8 x 448 tokens over 8 x 1,500 frames),
     granite-moe-1b-a400m (2 x 4,096) and falcon-mamba-7b (64 Mamba
     layers, d_model 4,096, 2 x 4,096) built by ``build_run`` and trained 3
     steps by ``train`` on the card (bf16, remat): batch 0's every
     ``flash_attention_bwd`` call held to its plain version within 2e-2,
     and one in eight of falcon-mamba-7b's 64 ``mamba_scan_bwd`` calls (8,
     one in each eighth of the stack) within 1e-4 of the largest plain
     gradient, every gradient finite and not all zero, launches a step
     against ``train_expect`` (falcon-mamba-7b: 128 ``mamba_scan``, 64
     ``mamba_scan_bwd``), ms and tokens/s a step, peak memory, one step
     profiled with the flash and scan time by shape from each launch's
     profiler range; ``launch-ckpt``: minicpm3-4b cut to 2 layers, checkpointed
     every 2 steps, with a fatal and a transient failure and a resume,
     held bit for bit (``phase_launch_ckpt``), each save and restore timed;
     Every training phase (6g, 6h and each ``launch`` run) first asks the
     dry-run (``launch/dryrun.py::lower_cell``: its step on the meta
     device, one microbatch on a 1x1 mesh) for its predicted peak, which
     must fit the card and whose kernel calls must be ``train_expect``'s,
     and prints on a ``roofline <phase>`` line the predicted and measured
     peak (``torch.cuda.max_memory_allocated``), the counted and the model
     flops (``model_flops_for``) and ``roofline_fraction`` (model flops
     over 989e12 x the median step's seconds); a predicted peak off the
     measured one by more than 15% fails the run;
  8. one JSON line of per-kernel launches (summed over the paths of phases
     5 and 6, each counted from 0 just before it; the pipeline's and the
     divergent arm's launches are their own, not their twins' in turns: the
     prefill paths of 6b
     and 6c are ``prefill-ssm`` and ``prefill-hybrid``, 6d's
     ``serving-moe`` and ``prefill-moe``, 6e's ``prefill-mla`` and
     ``serving-mla``, whose decode launches no kernel of the table, 6f's
     ``prefill-encdec`` and ``serving-encdec``, whose encodes and decode
     launch ``flash_attention``, 12 calls each, 6g's ``train``, 64
     ``flash_attention`` and 32 ``flash_attention_bwd`` launches a step,
     6h's ``train-hybrid``, 108 ``mamba_scan`` (54 forwards and remat's 54
     recomputes), 54 ``mamba_scan_bwd``, 9 ``flash_attention`` and 9
     ``flash_attention_bwd`` a step, 7b's ``launch <arch>`` (``launch
     falcon-mamba-7b``: 128 ``mamba_scan`` and 64 ``mamba_scan_bwd`` a
     step) and ``launch-ckpt``), errors and times.

The last line is ``{"ok": true, "device": {...}}``.  Without CUDA the script
prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import subprocess
import sys
import time
import warnings

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

FULL_KEYS = 200_000_000  # the paper's bulk load (YCSB, §8.1)
BATCH = 65_536
# each kernel's least work (bytes, flops, exponentials) and the card's
# rates: roofline/analysis.py, which the port's roofline reads too
from repro_torch.roofline.analysis import (  # noqa: E402
    HBM_BW as HBM_BYTES_PER_S,
    PEAK_FLOPS as BF16_FLOPS_PER_S,
    flash_bwd_bytes,
    flash_bwd_flops,
    flash_bytes,
    flash_flops,
    leaf_scan_bytes,
    leaf_split_bytes,
    leaf_write_bytes,
    mamba_bwd_bytes,
    mamba_bytes,
    mamba_exps,
    node_search_bytes,
    paged_bytes,
    prefix_search_bytes,
    walk_bytes,
)
# the kernel timers: a scratch tensor written and read before each cold
# call (five times the 50 MB L2), and the card's spin a queued call (0.5
# ms at 1.98 GHz, several times the host's cost of a call)
COLD_L2_BYTES = 256 * 2**20
SPIN_CYCLES_PER_CALL = 1_000_000
SCAN_MAX_COUNT = 100  # YCSB workload E's maxscanlength
SMO_LEAVES = 2_048  # leaves the split burst overflows, one per subtree
SMO_KEYS_PER_LEAF = 32
VALUE_XOR = 0x5DEECE66D
# (workload, policy, warm-up batches, timed batches) of phase 5, in order
MAIN_RUNS = (
    ("read-only", "offload", 1, 10),
    ("read-only", "fetch", 2, 10),
    ("read-only", "auto", 3, 20),
    ("ycsb-a", "offload", 1, 5),
    ("ycsb-a", "fetch", 1, 5),
    ("ycsb-a", "auto", 1, 5),
    ("insert-intensive", "fetch", 1, 5),
    ("insert-intensive", "offload", 1, 5),
)
# (policy, warm-up batches, timed batches) of YCSB workload E
SCAN_RUNS = (("fetch", 1, 5), ("offload", 1, 5))
# route-table slots of phase 5: at least the leaves (about 4.55M at 200M
# keys, plus split siblings), 235 MB of table
RT_SLOTS = 2**23
# (workload, warm-up batches, timed batches) of the route-table arms, each
# run under ``fetch`` as descent-only, leaf-direct and poisoned
RT_RUNS = (("read-only", 1, 5), ("ycsb-a", 1, 5))
RT_ARMS = ("descent", "leaf-direct", "poisoned")
# the repartition runs: a localized Zipfian (hotspot fraction, batches)
# under tight buckets, static and with the controller
REPART_PHASES = ((0.2, 5), (0.8, 5))
REPART_FACTOR = 1.25
# the pipeline phase: YCSB-A (policy, warm-up batches, timed batches), the
# pipelined and the synchronous engine in turns; then YCSB-E under fetch
PIPE_RUNS = (("fetch", 1, 10), ("auto", 1, 10))
PIPE_E_RUN = (1, 5)
# the fleet-policy phase: YCSB-C under fetch, uniform and divergent arms in
# turns from cold caches (warm-up, timed batches); the peek budget is a
# device's lane count, so it never binds
FLEET_RUN = (5, 10)
FLEET_PEEK_BUDGET = BATCH // 8
# the route-axes phase: the engine on a 2x2x2 virtual mesh (route axes
# ("data", "pod") of 2 x 2 over 2 memory columns) in turns with the 2x4 one
# under auto, (workload, warm-up batches, timed batches)
AXES_RUNS = (("ycsb-a", 1, 5), ("ycsb-e", 1, 5))
# the telemetry phase: YCSB-A under auto on the 2x4 engine, instrumented and
# bare in turns (warm-up batches, timed batches)
TELEMETRY_RUN = (1, 5)
# the mesh-against-simulator percentile gate, as the reference's
# benchmarks/fig19_latency_tails.py draws it: keys, lanes a batch, forced-
# fetch warm-up batches, measured batches under auto, shed-lane retries
LAT_GATE = (60_000, 1_024, 14, 8, 4)
LAT_BAND = (0.49, 2.05)  # one bucket of slack on geometric midpoints
TRACE_PATH = "traces/chip_smoke_telemetry.json"
# the LM plane: minitron-4b and granite-moe-1b-a400m served through the DEX
# page table; grok-1-314b (628 GB in bf16) runs reduced only
LM_ARCH = "minitron-4b"
MOE_ARCH, GROK_ARCH = "granite-moe-1b-a400m", "grok-1-314b"
# max abs error of an attention kernel against its plain version, by dtype
ATTN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: paged_attention's log-sum-exp: products of bf16 inputs are exact in f32,
#: so only the order of the sums differs from the plain version
LSE_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
SERVE_SLOTS = 64  # requests decoded together
#: the serving phases (6, 6b, 6d, 6e: minitron-4b, falcon-mamba-7b,
#: granite-moe-1b-a400m, minicpm3-4b) run each model at full width and
#: 1 / SERVE_DEPTH of its layers.  Their decode loops are bound by the host
#: (idle 74-94% a step), so their time goes with the layers, and with PR 32's
#: training phase and predictions the whole run took 1,150 s of its 1,200 s
#: limit at full depth on a slow host (1,164 s with the process start)
SERVE_DEPTH = 2
PAGE_SIZE = 16
N_PAGES = 4_096  # 65,536 tokens of KV: 8.6 GB for minitron-4b, 3.2 GB for granite
PAGES_PER_REQ = 36  # 576 tokens: the longest prompt plus the generated tokens
PROMPT_RANGE = (32, 512)  # prompt lengths, uniform, fed a token a step
GEN_TOKENS = 64  # greedy tokens a request
DECODE_STEPS = 640
CHECK_EVERY = 64  # steps repeated with the plain attention
PREFILL_TOKENS = 2_048  # two sequences of this length
PREFILL_RUNS = 3
GATE_REQUESTS, GATE_TOKENS = 4, 256  # the float32 equivalence gates
# the SSM plane: falcon-mamba-7b served through its recurrent state, and
# zamba2-2.7b (Mamba layers with a weight-shared attention block)
SSM_ARCH, HYBRID_ARCH = "falcon-mamba-7b", "zamba2-2.7b"
# mamba_scan at each one's prefill shape: (B, L, D = d_inner, N)
MAMBA_SHAPES = {SSM_ARCH: (2, 2048, 8192, 16), HYBRID_ARCH: (2, 2048, 5120, 64)}
SFU_EXP_PER_CLOCK = 16  # exponentials a clock an SM (H100 special-function units)
SSM_SLOTS = 64  # falcon-mamba-7b requests decoded together
SSM_REPLAYS = 8  # finished requests replayed through prefill
HYBRID_SLOTS, HYBRID_STEPS = 32, 128  # zamba2-2.7b's decode run
# the MLA plane: minicpm3-4b decoded through its compressed dense cache, all
# slots in lockstep (the reference has no paged MLA step)
MLA_ARCH = "minicpm3-4b"
MLA_SLOTS, MLA_STEPS = 64, 256  # slots, and steps = cache positions
MLA_REPLAYS = 2  # slots replayed through prefill
# the encoder-decoder plane: whisper-small, its encoder run once over each
# slot's 1,500 frames into the cross cache, then decoded through dense
# decode_step, all slots in lockstep (the reference has no paged
# encoder-decoder step)
ENCDEC_ARCH = "whisper-small"
ENCDEC_SLOTS = 64
ENCDEC_STEPS = 448  # Whisper's max_target_positions: steps = self-cache positions
ENCDEC_PREFILL = (8, 448)  # requests x decoder tokens of the timed prefill
ENCDEC_REPLAYS = 2  # slots replayed through prefill
ENCODE_RUNS = 3  # timed prefill_cross_kv calls
ENCDEC_TRACE_FRAMES = 48  # frames a request of phase 4's reduced whisper-small
# flash_attention at whisper-small's shapes (D = 64, 12 heads over 12, all
# non-causal): (batch, query rows, keys) of rows 8e, 8f and 8g
ENCDEC_FLASH = {
    "encoder": (64, 1500, 1500),
    "prefill cross": (8, 448, 1500),
    "decode cross": (64, 1, 1500),
}
# training: minitron-4b at full width (bf16, remat), batches of the port's
# token pipeline, and its float32 gate cut to 4 layers
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 4_096, 3  # 8,192 tokens a step
TRAIN_GATE_LAYERS, TRAIN_GATE_SEQ = 4, 2_048
#: a gradient of the flash backward against its plain version: the largest
#: |difference| over the largest |plain| of each of dq, dk, dv (bf16: P and
#: dS are rounded to bf16 as the products' operands)
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the flash backward's phase-3 shapes: q, k and v, causal
FLASH_BWD_SHAPES = {
    f"{LM_ARCH} training": ((2, 24, TRAIN_SEQ, 128), (2, 8, TRAIN_SEQ, 128), True),
    f"{MOE_ARCH} training": ((2, 16, 2048, 64), (2, 8, 2048, 64), True),
    f"{ENCDEC_ARCH} prefill cross": ((8, 12, 448, 64), (8, 12, 1500, 64), False),
    f"{HYBRID_ARCH} shared block": ((2, 32, 2048, 80), (2, 32, 2048, 80), True),
    f"{MLA_ARCH} prefill": ((2, 40, 2048, 96), (2, 40, 2048, 96), True),
}
#: flops the backward kernels execute a kept pair and head, over the 10 D of
#: the bound: the dQ pass recomputes S and dP
BWD_EXECUTED = 14 / 10
FLASH_BWD_F32 = (((1, 6, 300, 96), (1, 2, 400, 96), True), ((1, 4, 130, 64), (1, 4, 90, 64), False))
# the mamba_scan backward's phase-3 shapes, (B, L, D = d_inner, N): each SSM
# model's training shape (2 x TRAIN_SEQ tokens), and an odd one (L off the
# 32-step chunk, D off the CTA's channels, N = 8)
MAMBA_BWD_SHAPES = {
    f"{HYBRID_ARCH} training": (2, TRAIN_SEQ, 5120, 64),
    f"{SSM_ARCH} training": (2, TRAIN_SEQ, 8192, 16),
    "odd": (2, 67, 333, 8),
}
# training of zamba2-2.7b at full width (phase 6h): one in HYBRID_HOLD_EVERY
# of batch 0's mamba_scan_bwd calls is held to its plain version (its
# sequential loop takes about 1.7 s a call on an H100), which holds at
# least one in each group of six layers; every flash_attention_bwd call is
# held
HYBRID_HOLD_EVERY = 3
#: the phase-7 training gates: (arch, layers) at full width in float32
TRAIN_GATES = ((LM_ARCH, TRAIN_GATE_LAYERS), (SSM_ARCH, 4), (HYBRID_ARCH, 6))
# the launch plane (launch/train.py): (arch, batch, seq) trained at full
# width and depth by build_run + train; whisper-small's prefill shape (448
# tokens, its decoder context, over 1,500 frames)
LAUNCH_RUNS = ((MLA_ARCH, 2, 4_096), (ENCDEC_ARCH, 8, 448), (MOE_ARCH, 2, 4_096),
               (SSM_ARCH, 2, 4_096))
LAUNCH_STEPS = 3
# falcon-mamba-7b through the launcher: one in SSM_HOLD_EVERY of batch 0's 64
# mamba_scan_bwd calls is held to its plain version (about 2 s a call on an
# H100, row 11b), one in each eighth of the stack
SSM_HOLD_EVERY = 8
#: a training phase's peak (torch.cuda.max_memory_allocated) against the
#: dry-run's prediction (launch/dryrun.py on the meta device): within this
#: share of the measured peak
PEAK_TOL = 0.15
# the checkpointed runs: minicpm3-4b at full width cut to 2 layers, 2 x
# 4,096 tokens, a checkpoint every 2 steps, keep 2; 6 steps, then a resume
# to 8
CKPT_LAYERS, CKPT_EVERY, CKPT_STEPS, CKPT_RESUME_TO = 2, 2, 6, 8
#: the pipeline positions the failing run trains, in order: the fatal
#: failure at step 2 restores the step-2 checkpoint and retries with batch 2,
#: then the loop draws 2 again (ROADMAP.md queue 3, entry 20)
CKPT_B_ORDER = [0, 1, 2, 2, 3, 4]


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-keys", type=int, default=FULL_KEYS)
    return p.parse_args(argv)


def fail(msg):
    raise RuntimeError(msg)


def share_of(ms, busy):
    """``ms`` over a profile's device-busy ms, or None where the profile
    holds no device time: the profiler lost the run's device trace, which
    ``device_profile`` counts in ``PROFILES`` and which is no fault of
    the program."""
    return ms / busy if busy else None


def idle_of(busy, ms):
    """The idle share of ``ms`` given a profile's device-busy ms, or None
    where the profile holds no device time (see ``share_of``)."""
    return 1 - busy / ms if busy else None


def pct(x):
    """A share printed as a percentage, or "not measured" for None."""
    return "not measured" if x is None else f"{x:.2%}"


def cuda_ms(fn, reps, warmup=2):
    import torch

    for _ in range(warmup):
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


def queue_ahead(reps):
    """Keep the card busy while the host queues ``reps`` calls: a spin of
    about 0.5 ms a call (``torch.cuda._sleep``), so that a kernel of a few
    microseconds is timed on the card and not at the host's launch rate."""
    import torch

    torch.cuda._sleep(int(SPIN_CYCLES_PER_CALL * reps))


def device_ms(fn, reps, cold):
    """Mean device ms of ``fn()`` over ``reps`` calls queued behind a spin
    (``queue_ahead``).  Hot: the calls run back to back on one input, so
    reads that fit in the 50 MB L2 stay there.  Cold: before each call,
    outside the timed events, a scratch tensor of ``COLD_L2_BYTES`` is
    written and then read, so every call finds the L2 holding none of its
    inputs, and holding clean lines: after the write alone, the dirty
    lines a call evicts are written back during it."""
    import torch

    for _ in range(2):
        fn()
    scratch = torch.empty(COLD_L2_BYTES // 4, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    ev = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(reps if cold else 1)
    ]
    queue_ahead(reps)
    if cold:
        for start, end in ev:
            scratch.fill_(0)
            scratch.sum()
            start.record()
            fn()
            end.record()
    else:
        ev[0][0].record()
        for _ in range(reps):
            fn()
        ev[0][1].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / reps


def cold_and_hot(runs, library=None):
    """``device_ms`` of ``library`` (where there is one) and of each of
    ``runs`` (label -> call), cold and hot, 20 calls each: keys ``cold_ms``
    / ``hot_ms`` for the label ``default``, ``<label>_cold_ms`` /
    ``<label>_hot_ms`` else."""
    t = {}
    lib = {} if library is None else {"library": library}
    for label, fn in (*lib.items(), *runs.items()):
        for how in ("cold", "hot"):
            key = f"{how}_ms" if label == "default" else f"{label}_{how}_ms"
            t[key] = device_ms(fn, 20, cold=how == "cold")
    return t


def max_abs_err(got, want):
    return max(
        float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
        for g, w in zip(got, want)
    )


def lse_err(got, want):
    """Max abs difference of two log-sum-exps over their finite entries;
    infinite unless both are -inf at the same places (length 0)."""
    import torch

    inf = torch.isinf(want)
    if not torch.equal(inf, torch.isinf(got)):
        return float("inf")
    return max_abs_err([got[~inf]], [want[~inf]])


def mesh_config(policy, cache_sets, factor=4.0, rt_slots=0):
    from repro_torch.core.dex import DexMeshConfig

    return DexMeshConfig(
        n_route=2,
        n_memory=4,
        cache_sets=cache_sets,
        cache_ways=4,
        policy=policy,
        route_capacity_factor=factor,
        route_table_slots=rt_slots,
    )


def make_index(n_keys, seed, device):
    """``n_keys`` sorted unique int64 keys spanning negative and positive
    values (a cumulative sum of seeded random gaps below 2**24, so a leaf's
    44 keys span about 2**28.4 and most leaves' separators compress to 30
    bits or fewer), values a fixed function of the key, and the blocked
    pool over them."""
    import torch

    from repro_torch.core import pool as pool_mod

    g = torch.Generator(device=device).manual_seed(seed)
    gaps = torch.randint(1, 2**24, (n_keys,), generator=g, device=device)
    keys = torch.cumsum(gaps, 0) - n_keys * 2**22
    del gaps
    values = keys ^ VALUE_XOR
    pool, meta = pool_mod.build_pool(
        keys, values, level_m=1, fill=0.7, n_shards=4, device=device
    )
    del values
    return keys, pool, meta


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    return smi


def phase_build():
    from repro_torch.kernels import mamba_scan as mamba_mod
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    lib, log = ops.build(verbose=True)
    print(log, end="")
    ops.library()
    took = time.perf_counter() - t0
    print(f"build: {took:.1f} s (nvcc {ops.BUILD_SECONDS[0]:.1f} s)")
    sass = sass_evidence(lib)
    ptxas = ptxas_usage(log)
    for name, (regs, stores, loads) in sorted(ptxas.items()):
        for kernel, assumed in (("mamba_scan_kernel", mamba_mod.regs),
                                ("mamba_scan_bwd_kernel", lambda s: mamba_mod.regs_bwd())):
            inst = mamba_instance(name, kernel)
            if inst:
                print(f"ptxas {kernel}<{inst[0]}, S = {inst[1]}, LPC = {inst[2]}>: {regs}"
                      f" registers (the plan assumes {assumed(inst[1])}), spill stores"
                      f" {stores} B, loads {loads} B")
    return {"sass": sass, "ptxas": ptxas}


def sass_blocks(lines):
    """A kernel's SASS lines cut into basic blocks (at branches and branch
    targets): lists of ``(address, instruction)``."""
    import re

    instrs = []
    for line in lines:
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            instrs.append((int(m.group(1), 16), m.group(2)))
    targets = {int(t, 16) for _, text in instrs for t in re.findall(r"BRA (0x[0-9a-f]+)", text)}
    blocks, cur = [], []
    for addr, text in instrs:
        if addr in targets and cur:
            blocks.append(cur)
            cur = []
        cur.append((addr, text))
        if "BRA" in text or "EXIT" in text:
            blocks.append(cur)
            cur = []
    blocks.append(cur)
    return blocks


def op_counts(instrs):
    """Instructions, exponentials, FP32 operations, shifts (the
    exponential's ``SHF.L`` or ``IMAD.SHL``) and shuffles among
    ``(address, instruction)`` pairs."""

    def n(*ops):
        return sum(any(op in text for op in ops) for _, text in instrs)

    return {"instructions": len(instrs), "MUFU.EX2": n("MUFU.EX2"),
            "FP32": n("FFMA", "FMUL", "FADD"), "shifts": n("SHF.L", "IMAD.SHL"),
            "SHFL": n("SHFL")}


def mamba_hot_block(lines):
    """Op counts (``op_counts``) of the basic block with the most
    ``MUFU.EX2`` in a kernel's SASS lines."""
    blocks = sass_blocks(lines)
    return op_counts(max(blocks, key=lambda b: sum("MUFU.EX2" in t for _, t in b)))


def exp_regions(lines):
    """Op counts of the code a loop's iteration runs from each basic block
    that holds an exponential: from the block's start to the first branch
    back (the loop's end) at or after it, in address order."""
    import re

    blocks = sass_blocks(lines)
    flat = [x for b in blocks for x in b]
    out = []
    for b in blocks:
        if not any("MUFU.EX2" in t for _, t in b):
            continue
        i = flat.index(b[0])
        for k in range(i, len(flat)):
            m = re.search(r"BRA (0x[0-9a-f]+)", flat[k][1])
            if m and int(m.group(1), 16) < flat[k][0]:
                break
        out.append(op_counts(flat[i:k + 1]))
    return out


def ptxas_usage(log):
    """Registers and spill bytes of each kernel in ``ptxas -v``'s report:
    name -> (registers, spill stores, spill loads)."""
    out, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        if "Compiling entry function '" in line:
            name, spills = line.split("'")[1], (0, 0)
        elif "bytes spill stores" in line and name:
            w = line.split()
            spills = (int(w[w.index("spill") - 2]), int(w[w.index("spill", w.index("spill") + 1) - 2]))
        elif "Used " in line and " registers" in line and name:
            out[name] = (int(line.split("Used ")[1].split()[0]), *spills)
            name = None
    return out


def mamba_instance(name, kernel="mamba_scan_kernel"):
    """(operand dtype, states a lane, threads a channel) of a mangled
    ``kernel`` instantiation (the forward's, or ``mamba_scan_bwd_kernel``),
    or None."""
    import re

    m = re.search(rf"{kernel}I(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", name)
    return m and ("float32" if m.group(1) == "f" else "bfloat16", int(m.group(2)), int(m.group(3)))


#: per kernel family: the SASS ops counted, and those every kernel must hold
#: (``SASS_ABSENT``: those none may hold)
SASS_OPS = {
    # the mamba_scan backward's first (the forward's family name is in theirs)
    "mamba_scan_bwd_kernel": (("LDGSTS", "MUFU.EX2", "SHFL", "ATOM", "RED."),
                              ("LDGSTS", "MUFU.EX2")),
    "mamba_bwd_partials_sum": (("ATOM", "RED."), ()),
    "flash_attention_wgmma": (("HGMMA", "UTMALDG", "USETMAXREG"), ("HGMMA", "UTMALDG")),
    "bwd_dkdv_wgmma": (("HGMMA", "UTMALDG", "USETMAXREG", "HMMA"), ("HGMMA", "UTMALDG")),
    "bwd_dq_wgmma": (("HGMMA", "UTMALDG", "USETMAXREG", "HMMA"), ("HGMMA", "UTMALDG")),
    "paged_attention_split": (("HMMA", "LDGSTS", "LDSM", "MOVM"), ("HMMA", "LDGSTS")),
    "mamba_scan": (("LDGSTS", "MUFU.EX2", "FFMA", "FMUL", "FADD"), ("LDGSTS",)),
}
SASS_ABSENT = {"bwd_dkdv_wgmma": ("HMMA",), "bwd_dq_wgmma": ("HMMA",),
               "mamba_scan_bwd_kernel": ("ATOM", "RED."),
               "mamba_bwd_partials_sum": ("ATOM", "RED.")}


def sass_evidence(lib):
    """Count, in each kernel of the built library (``cuobjdump
    --dump-sass``): in the bf16 flash_attention kernels and its backward's
    dK / dV and dQ kernels the tensor-core products (``HGMMA``), TMA loads
    (``UTMALDG``) and register hand-overs (``USETMAXREG``), and in the
    backward's the ``mma.sync`` products (``HMMA``), which must be none; in the bf16 paged_attention kernels the ``mma.sync``
    products (``HMMA``), ``cp.async`` copies (``LDGSTS``), ``ldmatrix``
    (``LDSM``) and ``movmatrix`` (``MOVM``); in the mamba_scan kernels the
    ``cp.async`` copies (``LDGSTS``), exponentials (``MUFU.EX2``) and FP32
    operations, and the same in the basic block with the most exponentials
    (the unrolled group of steps: ``mamba_hot_block``); in the mamba_scan
    backward's kernels their ``LDGSTS``, ``MUFU.EX2`` and shuffles, in all
    and in the unrolled sub-block (``mamba_hot_block``), and the atomics
    (``ATOM``, ``RED``), which must be none, as in the kernel that adds its
    partials; and in those the code a sub-block runs from its exponentials'
    block to the loop's end (``exp_regions``).  Fails unless every kernel of each family holds
    its required ops.  Returns ``{name:
    (family, counts)}``, the mamba kernels' counts with a ``hot`` entry."""
    from repro_torch.kernels import ops

    cuobjdump = pathlib.Path(ops._nvcc()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(cuobjdump), "--dump-sass", str(lib)],
        capture_output=True, text=True, check=True, timeout=300,
    ).stdout
    counts, name, family, code = {}, None, None, {}
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            family = next((f for f in SASS_OPS if f in name), None)
            if family:
                counts[name] = (family, dict.fromkeys(SASS_OPS[family][0], 0))
                code[name] = []
        elif name in counts:
            for op in counts[name][1]:
                counts[name][1][op] += line.count(op)
            code[name].append(line)
    for name, (family, c) in counts.items():
        if family in ("mamba_scan", "mamba_scan_bwd_kernel"):
            c["hot"] = mamba_hot_block(code[name])
        if family == "mamba_scan_bwd_kernel":
            c["sub"] = exp_regions(code[name])
    for family, (_, required) in SASS_OPS.items():
        mine = [c for f, c in counts.values() if f == family]
        if not mine or not all(c[op] for c in mine for op in required):
            fail(f"{family}: a kernel lacks one of {required} in its SASS: {counts}")
        absent = SASS_ABSENT.get(family, ())
        if any(c[op] for c in mine for op in absent):
            fail(f"{family}: a kernel holds one of {absent} in its SASS: {counts}")
    for name, (_, c) in counts.items():
        print(f"sass {name}: " + ", ".join(f"{op} {n}" for op, n in c.items()))
    return counts


def node_search_inputs(pool, keys, n, seed):
    """Rows of the real pool (inner and leaf rows) with queries that hit,
    miss, fall below the row's first key, or are KEY_MIN / KEY_MAX /
    negative."""
    import torch

    from repro_torch.core.nodes import KEY_MAX, KEY_MIN

    dev = keys.device
    g = torch.Generator(device=dev).manual_seed(seed)
    flat_k = pool.pool_keys.view(-1, 64)
    flat_v = pool.pool_values.view(-1, 64)
    occupied = torch.nonzero(flat_k[:, 0] != KEY_MAX)[:, 0]
    which = torch.randint(0, occupied.numel(), (n,), generator=g, device=dev)
    rows_id = occupied[which]
    rows = flat_k[rows_id]
    vals = flat_v[rows_id]
    occ = (rows != KEY_MAX).sum(1)
    pick = (torch.rand(n, generator=g, device=dev) * occ).long()
    q = rows.gather(1, pick[:, None])[:, 0].clone()
    lane = torch.arange(n, device=dev)
    q = torch.where(lane % 4 == 1, q + 1, q)
    q = torch.where(lane % 4 == 2, rows[:, 0] - 1, q)
    q = torch.where(lane % 16 == 3, KEY_MAX, q)
    q = torch.where(lane % 16 == 7, KEY_MIN, q)
    q = torch.where(lane % 16 == 11, -3, q)
    return rows.contiguous(), q.contiguous(), vals.contiguous()


def engine_mix(pool, keys, buckets, cap, live, seed):
    """``node_search`` inputs laid out as one descent level of the engine:
    ``buckets`` route buckets of ``cap`` slots, the first ``live`` of each
    a lane of ``node_search_inputs`` (``pack_by_dest`` packs a bucket's
    lanes to its front), every other slot padding as the engine leaves it:
    an all-KEY_MAX row, a KEY_MAX query and zero values."""
    import torch

    from repro_torch.core.nodes import KEY_MAX

    dev = keys.device
    r, q, v = node_search_inputs(pool, keys, buckets * live, seed)
    n = buckets * cap
    slot = torch.arange(buckets, device=dev)[:, None] * cap + torch.arange(
        live, device=dev
    )
    slot = slot.reshape(-1)
    rows = torch.full((n, 64), KEY_MAX, dtype=torch.int64, device=dev)
    vals = torch.zeros((n, 64), dtype=torch.int64, device=dev)
    qs = torch.full((n,), KEY_MAX, dtype=torch.int64, device=dev)
    rows[slot], vals[slot], qs[slot] = r, v, q
    return rows, qs, vals




def node_search_mix(name, rows, q, vals):
    """``node_search`` on one mix: the kernel (its default and every
    variant of ``kernels/node_search.py::VARIANTS``) held bit for bit to
    its plain version, then timed cold and hot beside
    ``torch.searchsorted`` and the mix's bound."""
    import torch

    from repro_torch.core.nodes import KEY_MAX
    from repro_torch.kernels import node_search as ns
    from repro_torch.kernels import ops, ref

    want = ref.node_search_ref(rows, q, vals)
    lib = ops.library()
    runs = {"default": lambda: ops.node_search(rows, q, vals)}
    for v in ns.VARIANTS:
        runs[v] = lambda v=v: ns.launch(lib, rows, q, vals, variant=v)
    err = 0.0
    for v, fn in runs.items():
        got = fn()
        err = max(err, max_abs_err(got, want))
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"node_search {v} differs from its plain version on mix {name}"
                 f" (max abs err {err})")
    t = dict(max_abs_err=err, bound_ms=node_search_bytes(rows, q, vals)
             / HBM_BYTES_PER_S * 1e3)
    t.update(cold_and_hot(
        runs, lambda: torch.searchsorted(rows, q[:, None], right=True)
    ))
    t["rows"] = q.numel()
    t["keymax_share"] = float((q == KEY_MAX).float().mean())
    t["values"] = vals is not None
    card = torch.cuda.get_device_name(rows.device)
    print(f"node_search mix {name} on {card}: {json.dumps(t)}")
    return t




def walk_lanes(pool, meta, keys, n, g):
    """``(subtree int32, queries)`` of ``n`` owner-walk lanes: keys of the
    index, every fourth one above a key (a miss), KEY_MAX, KEY_MIN and -3
    on every sixteenth; the first half on the subtree the top walk gives,
    the rest on random blocks."""
    import torch

    from repro_torch.core import pool as pool_mod
    from repro_torch.core.nodes import KEY_MAX, KEY_MIN

    dev = keys.device
    idx = torch.randint(0, keys.numel(), (n,), generator=g, device=dev)
    q = keys[idx].clone()
    lane = torch.arange(n, device=dev)
    q = torch.where(lane % 4 == 1, q + 1, q)
    q = torch.where(lane % 16 == 3, KEY_MAX, q)
    q = torch.where(lane % 16 == 7, KEY_MIN, q)
    q = torch.where(lane % 16 == 11, -3, q)
    st = pool_mod.top_walk(pool, meta, q)
    rand_st = torch.randint(0, meta.n_subtrees, (n,), generator=g, device=dev)
    return torch.where(lane < n // 2, st, rand_st).to(torch.int32), q


def walk_engine_mix(pool, meta, keys, cfg, wcap, live, g):
    """Owner-walk lanes laid out as the engine's exchange hands them over:
    one bucket of ``wcap`` slots for each (device, source column), the
    first ``live`` a lane of ``walk_lanes`` (``pack_by_dest`` packs a
    bucket's lanes to its front), the rest padding with a KEY_MAX query on
    the device's column's first subtree.  ``active``: the lanes the engine
    walks, those below KEY_MAX."""
    import torch

    from repro_torch.core import mesh
    from repro_torch.core.nodes import KEY_MAX

    dev = keys.device
    nm = cfg.n_memory
    buckets = cfg.n_devices * nm
    l_st, l_q = walk_lanes(pool, meta, keys, buckets * live, g)
    col = mesh.memory_linear_index(cfg, dev).long()  # [Dev]
    s_per = pool.pool_keys.shape[0] // nm
    st = (col.repeat_interleave(nm * wcap) * s_per).to(torch.int32)
    q = torch.full((buckets * wcap,), KEY_MAX, dtype=torch.int64, device=dev)
    slot = torch.arange(buckets, device=dev)[:, None] * wcap + torch.arange(
        live, device=dev
    )
    slot = slot.reshape(-1)
    st[slot], q[slot] = l_st, l_q
    return st, q, q != KEY_MAX


def walk_mix(name, pool, st, q, levels, active):
    """``subtree_walk`` on one mix: the kernel (its default and every variant
    of ``kernels/subtree_walk.py::VARIANTS``, ``W`` the first design) held
    bit for bit to its plain version, then timed cold and hot beside the
    mix's bound and the bytes the default design's reads fetch in 32-byte
    sectors and in the L2's 64-byte granules (``read_sectors``)."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import subtree_walk as sw

    args = (pool.pool_keys, pool.pool_children, pool.pool_values, st, q)
    want = ref.subtree_walk_ref(*args, levels=levels, active=active)
    lib = ops.library()
    runs = {"default": lambda: ops.subtree_walk(*args, levels=levels, active=active)}
    for v in sw.VARIANTS:
        runs[v] = lambda v=v: sw.launch(lib, *args, levels, active, variant=v)
    err = 0.0
    for v, fn in runs.items():
        got = fn()
        err = max(err, max_abs_err(got, want))
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"subtree_walk {v} differs from its plain version on mix {name}"
                 f" (max abs err {err})")
    n = q.numel()
    n_act = n if active is None else int(active.sum())
    sectors, granules = sw.read_sectors(
        pool.pool_keys, pool.pool_children, st, q, levels, active
    )
    lane_bytes = 12 * n_act + (13 + (active is not None)) * n
    bound = walk_bytes(pool, st, q, levels, want[0], active)
    t = dict(
        max_abs_err=err,
        bound_ms=bound / HBM_BYTES_PER_S * 1e3,
        bound_bytes=bound,
        sector_bytes=32 * int(sectors.sum()) + lane_bytes,
        granule_bytes=64 * int(granules.sum()) + lane_bytes,
    )
    t["granule_ms"] = t["granule_bytes"] / HBM_BYTES_PER_S * 1e3
    t.update(cold_and_hot(runs))
    t.update(lanes=n, active_lanes=n_act, plain_ms=cuda_ms(
        lambda: ref.subtree_walk_ref(*args, levels=levels, active=active), 3
    ))
    card = torch.cuda.get_device_name(q.device)
    print(f"subtree_walk mix {name} on {card}: {json.dumps(t)}")
    return t


def leaf_write_inputs(q, seed, dev):
    """Contract inputs of ``leaf_write`` made on the card from ``seed``:
    sorted rows with KEY_MAX padding, KEY_MIN and negative keys; rows with
    only updates, only inserts, both, and nothing staged (by ``row % 4``);
    rows filled to exactly 64 (every eighth from row 1); staged keys below a
    row's first key and above its last; in every third row the active staged
    inserts spread among inactive entries, elsewhere a prefix."""
    import torch

    from repro_torch.core.nodes import KEY_MAX, KEY_MIN

    f = 64
    g = torch.Generator(device=dev).manual_seed(seed)
    big = 2**62

    def ints(shape):
        return torch.randint(-big, big, shape, generator=g, device=dev)

    def counts(high):
        return torch.randint(0, high, (q,), generator=g, device=dev)

    col = torch.arange(f, device=dev)[None, :]
    row = torch.arange(q, device=dev)
    pool = ints((q, 2 * f)).sort(1).values + torch.arange(2 * f, device=dev)
    pool[::5, 0] = KEY_MIN
    inv = torch.rand((q, 2 * f), generator=g, device=dev).argsort(1).argsort(1)
    occ = counts(f + 1)
    kind = row % 4
    n_ins = torch.where((kind == 1) | (kind == 2), counts(f + 1), 0)
    n_ins = torch.minimum(n_ins, f - occ)
    n_ins[1::8] = f - occ[1::8]

    def pick(mask, n):
        idx = (~mask).to(torch.int8).argsort(dim=1, stable=True)[:, :f]
        return torch.where(col < n[:, None], pool.gather(1, idx), KEY_MAX)

    rows_k = pick(inv < occ[:, None], occ)
    staged = pick((inv >= occ[:, None]) & (inv < (occ + n_ins)[:, None]), n_ins)
    rows_v = torch.where(rows_k != KEY_MAX, ints((q, f)), 0)
    # every third row: the active entries at random ascending positions
    rank = torch.rand((q, f), generator=g, device=dev).argsort(1).argsort(1)
    spot = rank < n_ins[:, None]
    nth = (spot.long().cumsum(1) - 1).clamp(min=0)
    spread = torch.where(spot, staged.gather(1, nth), KEY_MAX)
    ins_key = torch.where((row % 3 == 0)[:, None], spread, staged)
    ins_val = torch.where(ins_key != KEY_MAX, ints((q, f)), 0)
    n_upd = torch.where((kind == 0) | (kind == 2), counts(f + 1), 0)
    n_upd = torch.minimum(n_upd, occ)
    scores = torch.where(
        col < occ[:, None], torch.rand((q, f), generator=g, device=dev), 2.0
    )
    slots = scores.argsort(1)
    upd_slot = torch.where(col < n_upd[:, None], slots, -1).to(torch.int32)
    upd_val = torch.where(upd_slot >= 0, ints((q, f)), 0)
    return rows_k, rows_v, upd_slot, upd_val, ins_key, ins_val


def leaf_split_inputs(q, seed, dev):
    """Contract inputs of ``leaf_split`` made on the card from ``seed``:
    sorted rows with KEY_MAX padding, KEY_MIN and negative keys; staged keys
    distinct from the row's, ascending, in every third row spread among
    inactive entries.  By ``row % 8``: nothing staged (rows 0-3, as most
    rows of an SMO round), a merge without a split, a split at exactly
    m = 65, one at m = 128 (a full row and a full staged list), and a
    random mix."""
    import torch

    from repro_torch.core.nodes import KEY_MAX, KEY_MIN

    f = 64
    g = torch.Generator(device=dev).manual_seed(seed)
    big = 2**62

    def ints(shape):
        return torch.randint(-big, big, shape, generator=g, device=dev)

    col = torch.arange(f, device=dev)[None, :]
    row = torch.arange(q, device=dev)
    pool = ints((q, 2 * f)).sort(1).values + torch.arange(2 * f, device=dev)
    pool[::5, 0] = KEY_MIN
    inv = torch.rand((q, 2 * f), generator=g, device=dev).argsort(1).argsort(1)
    occ = torch.randint(0, f + 1, (q,), generator=g, device=dev)
    n_ins = torch.randint(0, f + 1, (q,), generator=g, device=dev)
    kind = row % 8
    n_ins = torch.where(kind < 4, 0, n_ins)
    n_ins = torch.where(kind == 4, torch.minimum(n_ins, f - occ), n_ins)
    occ = torch.where(kind == 5, occ.clamp(min=1), occ)
    n_ins = torch.where(kind == 5, 65 - occ, n_ins)
    occ = torch.where(kind == 6, f, occ)
    n_ins = torch.where(kind == 6, f, n_ins)

    def pick(mask, n):
        idx = (~mask).to(torch.int8).argsort(dim=1, stable=True)[:, :f]
        return torch.where(col < n[:, None], pool.gather(1, idx), KEY_MAX)

    rows_k = pick(inv < occ[:, None], occ)
    staged = pick((inv >= occ[:, None]) & (inv < (occ + n_ins)[:, None]), n_ins)
    rank = torch.rand((q, f), generator=g, device=dev).argsort(1).argsort(1)
    spot = rank < n_ins[:, None]
    nth = (spot.long().cumsum(1) - 1).clamp(min=0)
    spread = torch.where(spot, staged.gather(1, nth), KEY_MAX)
    ins_key = torch.where((row % 3 == 0)[:, None], spread, staged)
    rows_v = torch.where(rows_k != KEY_MAX, ints((q, f)), 0)
    ins_val = torch.where(ins_key != KEY_MAX, ints((q, f)), 0)
    return rows_k, rows_v, ins_key, ins_val




def leaf_scan_inputs(pool, meta, keys, n, seed):
    """Real windows of the index as the engine builds them for ``n`` routed
    slots: one slot in four is an active scan (the share a YCSB-E batch
    fills), its start a bulk key, a key plus one, below its leaf's first
    key or past its last, its count random up to 100, 0, 1, 100 or 150
    (clipped to 100); the start leaf found by a walk, then successor hops
    while the collected records fall short of the count.  Returns
    ``(window_keys, window_values, start, counts, hops)``."""
    import torch

    from repro_torch.core.engine import scan_hops
    from repro_torch.core.nodes import KEY_MAX
    from repro_torch.core.pool import initial_succ, top_walk
    from repro_torch.kernels import ref

    dev = keys.device
    g = torch.Generator(device=dev).manual_seed(seed)
    hops = scan_hops(meta, SCAN_MAX_COUNT)
    lane = torch.arange(n, device=dev)
    active = lane % 4 == 0
    kind = (lane // 4) % 8
    start = keys[torch.randint(0, keys.numel(), (n,), generator=g, device=dev)]
    start = torch.where(kind == 1, start + 1, start)
    counts = torch.randint(0, SCAN_MAX_COUNT + 1, (n,), generator=g, device=dev)
    for k_, c_ in ((2, 0), (3, 1), (4, SCAN_MAX_COUNT), (5, SCAN_MAX_COUNT + 50)):
        counts = torch.where(kind == k_, c_, counts)
    st = top_walk(pool, meta, start)
    _, _, loc = ref.subtree_walk_ref(
        pool.pool_keys, pool.pool_children, pool.pool_values, st.to(torch.int32),
        start, levels=meta.levels_in_subtree,
    )
    gid = st * meta.subtree_cap + loc.long()
    flat_k = pool.pool_keys.view(-1, 64)
    flat_v = pool.pool_values.view(-1, 64)
    row0 = flat_k[gid]
    last = row0.gather(1, ((row0 != KEY_MAX).sum(1, keepdim=True) - 1).clamp(min=0))
    start = torch.where(kind == 6, row0[:, 0] - 1, start)
    start = torch.where(kind == 7, last[:, 0] + 1, start)
    start = torch.where(active, start, KEY_MAX)
    counts = torch.where(active, counts, 0).to(torch.int32)
    cnt = counts.clamp(0, SCAN_MAX_COUNT)
    succ = initial_succ(meta, dev)
    qc = start[:, None]
    win_k = [torch.where(active[:, None], row0, KEY_MAX)]
    win_v = [torch.where(active[:, None], flat_v[gid], 0)]
    collected = ((win_k[0] != KEY_MAX) & (win_k[0] >= qc)).sum(1)
    in_range, g_h = active, gid
    for _ in range(1, hops):
        nxt = succ[torch.where(in_range, g_h, 0)]
        in_range = in_range & (collected < cnt) & (nxt >= 0)
        g_h = torch.where(in_range, nxt, g_h)
        rk = torch.where(in_range[:, None], flat_k[g_h], KEY_MAX)
        win_k.append(rk)
        win_v.append(torch.where(in_range[:, None], flat_v[g_h], 0))
        collected = collected + ((rk != KEY_MAX) & (rk >= qc)).sum(1)
    return (
        torch.cat(win_k, 1).contiguous(),
        torch.cat(win_v, 1).contiguous(),
        start.contiguous(),
        counts,
        hops,
    )


def prefix_search_inputs(pool, meta, sep, keys, n, seed):
    """Gathered rows of the index's compressed planes along real descents:
    each lane walks a bulk key down to its leaf and takes the block root's
    row (every fourth lane), an empty free-list row (every sixteenth from
    lane 5) or the leaf's row; its query equals the key, is one above it,
    below the row's first key, KEY_MIN, negative or KEY_MAX.  Returns
    ``(prefix, nbits, suffix, rows, queries)``."""
    import torch

    from repro_torch.core.nodes import KEY_MAX, KEY_MIN
    from repro_torch.core.pool import top_walk
    from repro_torch.kernels import ref

    dev = keys.device
    g = torch.Generator(device=dev).manual_seed(seed)
    q = keys[torch.randint(0, keys.numel(), (n,), generator=g, device=dev)]
    st = top_walk(pool, meta, q)
    _, _, leaf = ref.subtree_walk_ref(
        pool.pool_keys, pool.pool_children, pool.pool_values, st.to(torch.int32),
        q, levels=meta.levels_in_subtree,
    )
    lane = torch.arange(n, device=dev)
    local = torch.where(lane % 4 == 0, 0, leaf.long())
    local = torch.where(lane % 16 == 5, meta.base_cap, local)
    gid = st * meta.subtree_cap + local
    rows = pool.pool_keys.view(-1, 64)[gid]
    q = torch.where(lane % 8 == 1, q + 1, q)
    q = torch.where(lane % 8 == 2, rows[:, 0] - 1, q)
    q = torch.where(lane % 16 == 3, KEY_MAX, q)
    q = torch.where(lane % 16 == 7, KEY_MIN, q)
    q = torch.where(lane % 16 == 11, -3, q)
    return (
        sep.prefix.view(-1)[gid],
        sep.nbits.view(-1)[gid],
        sep.suffix.view(-1, 64)[gid],
        rows,
        q.contiguous(),
    )




def phase_kernels(pool, meta, keys, seed):
    """Each kernel at the main path's shapes, against its plain version."""
    import torch

    from repro_torch.core import pool as pool_mod
    from repro_torch.core.nodes import KEY_MAX
    from repro_torch.core.routing import route_capacity
    from repro_torch.kernels import node_search as ns_mod
    from repro_torch.kernels import ops, ref

    cfg = mesh_config("auto", 65_536)
    per_dev = BATCH // cfg.n_devices
    cap = route_capacity(per_dev, cfg.n_route, cfg.route_capacity_factor)
    n_ns = cfg.n_devices * cfg.n_route * cap  # descent rows
    wcap = route_capacity(cfg.n_route * cap, cfg.n_memory, cfg.route_capacity_factor)
    n_sw = cfg.n_devices * cfg.n_memory * wcap  # owner-walk lanes
    out = {}

    # node_search on three mixes: (i) pool rows with mixed queries, with
    # values; (ii) the same without; (iii) one descent level of the engine,
    # with and without values; mix (i) is the kernel's row of the table
    rows, q, vals = node_search_inputs(pool, keys, n_ns, seed)
    bucket_live = per_dev // cfg.n_route
    e_rows, e_q, e_vals = engine_mix(
        pool, keys, cfg.n_devices * cfg.n_route, cap, bucket_live, seed
    )
    # mix (i) with its KEY_MAX queries turned into hits on the row's last
    # key: what (i)'s KEY_MAX lanes, each summing a run of padding values
    # of an occupied row, cost
    last_key = rows.gather(1, ((rows != KEY_MAX).sum(1) - 1)[:, None])[:, 0]
    mixes = {
        "i": (rows, q, vals),
        "ii": (rows, q, None),
        "i-without-keymax": (rows, torch.where(q == KEY_MAX, last_key, q), vals),
        "iii": (e_rows, e_q, e_vals),
        "iii-no-values": (e_rows, e_q, None),
    }
    times = {m: node_search_mix(m, *args) for m, args in mixes.items()}
    del mixes, e_rows, e_q, e_vals
    # (ii) at four times the rows: what a row costs once the fixed cost of
    # a launch is spread thin
    big = node_search_inputs(pool, keys, 4 * n_ns, seed)
    node_search_mix("ii-4x", big[0], big[1], None)
    del big
    t = times["i"]
    out["node_search"] = dict(
        name="node_search",
        route="cuda",
        source="src/repro_torch/csrc/node_search.cu",
        replaces="src/repro/kernels/node_search.py:64",
        shape=f"rows [{n_ns}, 64] i64, mix (i), L2 cold",
        bit_equal=True,
        max_abs_err=t["max_abs_err"],
        ms=t["cold_ms"],
        plain_ms=cuda_ms(lambda: ref.node_search_ref(rows, q, vals), 5),
        library_ms=t["library_cold_ms"],
        bound_ms=t["bound_ms"],
        bound_by="bytes",
    )

    # owner walks on two mixes: (contract) every lane walks, real subtrees
    # from the top walk plus random blocks, the table's row; (engine) the
    # engine's exchange, 2,048 live lanes at the front of each of its 32
    # buckets, the rest KEY_MAX padding it does not walk
    g = torch.Generator(device=keys.device).manual_seed(seed + 1)
    levels = meta.levels_in_subtree
    st, qw = walk_lanes(pool, meta, keys, n_sw, g)
    walks = {"contract": walk_mix("contract", pool, st, qw, levels, None)}
    e_st, e_q, e_act = walk_engine_mix(
        pool, meta, keys, cfg, wcap, BATCH // (cfg.n_devices * cfg.n_memory), g
    )
    walks["engine"] = walk_mix("engine", pool, e_st, e_q, levels, e_act)
    del st, qw, e_st, e_q, e_act
    t = walks["contract"]
    out["subtree_walk"] = dict(
        name="subtree_walk",
        route="cuda",
        source="src/repro_torch/csrc/subtree_walk.cu",
        replaces="src/repro/kernels/subtree_walk.py:119",
        shape=f"{n_sw} lanes over pool {list(pool.pool_keys.shape)}, contract mix, hot",
        bit_equal=True,
        max_abs_err=max(w["max_abs_err"] for w in walks.values()),
        ms=t["hot_ms"],
        plain_ms=t["plain_ms"],
        library_ms=None,
        bound_ms=t["bound_ms"],
        bound_by="bytes",
        per_mix={
            m: {k: w[k] for k in ("cold_ms", "hot_ms", "W_cold_ms", "W_hot_ms",
                                  "bound_ms", "granule_ms", "active_lanes")}
            for m, w in walks.items()
        },
    )
    # leaf writes: one staged row per request slot of every column's
    # gathered batch, as the write path stages them
    n_lw = cfg.n_memory * cfg.n_route * cfg.n_memory * wcap
    args = leaf_write_inputs(n_lw, seed + 2, keys.device)
    got = ops.leaf_write(*args)
    want = ref.leaf_write_ref(*args)
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max_abs_err(got, want)
    if not equal:
        fail(f"leaf_write differs from its plain version (max abs err {err})")
    n_upd = int((args[2] >= 0).sum())
    n_ins = int((args[4] != KEY_MAX).sum())
    nbytes = leaf_write_bytes(n_lw, n_upd, n_ins)
    out["leaf_write"] = dict(
        name="leaf_write",
        route="cuda",
        source="src/repro_torch/csrc/leaf_write.cu",
        replaces="src/repro/kernels/leaf_write.py:138",
        shape=f"rows [{n_lw}, 64] i64, {n_upd} updates, {n_ins} inserts staged",
        bit_equal=True,
        max_abs_err=err,
        ms=cuda_ms(lambda: ops.leaf_write(*args), 20),
        plain_ms=cuda_ms(lambda: ref.leaf_write_ref(*args), 3),
        library_ms=None,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
    )
    del args, got, want

    # scans: one window per routed slot of a YCSB-E batch
    wk, wv, start, counts, hops = leaf_scan_inputs(pool, meta, keys, n_ns, seed + 3)
    mc = SCAN_MAX_COUNT
    got = ops.leaf_scan(wk, wv, start, counts, max_count=mc)
    want = ref.leaf_scan_ref(wk, wv, start, counts, max_count=mc)
    err = max_abs_err(got, want)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail(f"leaf_scan differs from its plain version (max abs err {err})")
    n_active = int(((counts > 0) & (start != KEY_MAX)).sum())
    n_sel = int(got[2].sum())
    nbytes = leaf_scan_bytes(n_ns, mc, n_active, n_sel)
    out["leaf_scan"] = dict(
        name="leaf_scan",
        route="cuda",
        source="src/repro_torch/csrc/leaf_scan.cu",
        replaces="src/repro/kernels/leaf_scan.py:107",
        shape=(
            f"windows [{n_ns}, {hops * 64}] i64, {n_active} active, "
            f"{n_sel} records taken, max_count {mc}"
        ),
        bit_equal=True,
        max_abs_err=err,
        ms=cuda_ms(lambda: ops.leaf_scan(wk, wv, start, counts, max_count=mc), 20),
        plain_ms=cuda_ms(
            lambda: ref.leaf_scan_ref(wk, wv, start, counts, max_count=mc), 3
        ),
        library_ms=None,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
    )
    del wk, wv, got, want

    # splits: one row per lane of every column's gathered SMO round
    n_sp = cfg.n_memory * cfg.n_route * cfg.n_memory * per_dev
    args = leaf_split_inputs(n_sp, seed + 4, keys.device)
    got = ops.leaf_split(*args)
    want = ref.leaf_split_ref(*args)
    err = max_abs_err(got, want)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail(f"leaf_split differs from its plain version (max abs err {err})")
    n_ins = int((args[2] != KEY_MAX).sum())
    n_split = int(got[7].sum())
    nbytes = leaf_split_bytes(args)
    out["leaf_split"] = dict(
        name="leaf_split",
        route="cuda",
        source="src/repro_torch/csrc/leaf_split.cu",
        replaces="src/repro/kernels/leaf_split.py:164",
        shape=f"rows [{n_sp}, 64] i64, {n_ins} inserts staged, {n_split} splits",
        bit_equal=True,
        max_abs_err=err,
        ms=cuda_ms(lambda: ops.leaf_split(*args), 20),
        plain_ms=cuda_ms(lambda: ref.leaf_split_ref(*args), 3),
        library_ms=None,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
    )
    del args, got, want

    # compressed separator search: one gathered row triple per descent row
    sep = pool_mod.compress_separators(pool, meta)
    args = prefix_search_inputs(pool, meta, sep, keys, n_ns, seed + 5)
    del sep
    want = ref.node_search_prefix_ref(*args)
    lib = ops.library()
    runs = {"default": lambda: ops.node_search_prefix(*args)}
    for v in ns_mod.PREFIX_VARIANTS:
        runs[v] = lambda v=v: ns_mod.launch_prefix(lib, *args, variant=v)
    err = 0.0
    for v, fn in runs.items():
        got = fn()
        err = max(err, max_abs_err([got], [want]))
        if not torch.equal(got, want):
            fail(f"node_search_prefix {v} differs from its plain version"
                 f" (max abs err {err})")
    slot, _, _ = ref.node_search_ref(args[3], args[4])
    live = args[4] != KEY_MAX
    if not torch.equal(got[live], slot[live]):
        fail("node_search_prefix differs from node_search below KEY_MAX")
    n_comp = int((args[1] >= 0).sum())
    n_empty = int((args[3][:, 0] == KEY_MAX).sum())
    rows_, q_ = args[3], args[4]
    t = cold_and_hot(
        runs, lambda: torch.searchsorted(rows_, q_[:, None], right=True)
    )
    print(f"node_search_prefix on {torch.cuda.get_device_name(keys.device)}:"
          f" {json.dumps(t)}")
    out["node_search_prefix"] = dict(
        name="node_search_prefix",
        route="cuda",
        source="src/repro_torch/csrc/node_search_prefix.cu",
        replaces="src/repro/kernels/node_search.py:159",
        shape=(
            f"{n_ns} lanes, {n_comp} compressible rows ({n_empty} empty),"
            f" {n_ns - n_comp} incompressible, L2 cold"
        ),
        bit_equal=True,
        max_abs_err=err,
        ms=t["cold_ms"],
        plain_ms=cuda_ms(lambda: ref.node_search_prefix_ref(*args), 5),
        library_ms=t["library_cold_ms"],
        bound_ms=prefix_search_bytes(args[0], args[1], args[4])
        / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
    )
    if not 0 < n_comp - n_empty < n_ns - n_empty:
        fail("node_search_prefix inputs lack compressible or incompressible rows")
    del args, got, want, rows_, q_
    card = torch.cuda.get_device_name(keys.device)
    for k in out.values():
        print(
            f"kernel {k['name']}: {k['shape']}: bit-equal, kernel {k['ms']:.4f} ms,"
            f" plain {k['plain_ms']:.4f} ms, library {k['library_ms']} ms,"
            f" bound {k['bound_ms']:.4f} ms on {card}"
        )
    return out


def mixed_batch(rng, keys, lanes, hot, overflow):
    """One batch of random lookups, updates and inserts of fresh keys; the
    ``hot`` keys take the first lanes as updates; ``overflow`` keys (fresh
    keys of one leaf, more than its slack) follow as inserts."""
    from repro_torch.core.engine import OP_INSERT, OP_UPDATE
    from repro_torch.core.nodes import KEY_MAX

    opc = rng.integers(0, 3, size=lanes).astype("int32")
    kk = rng.choice(keys, size=lanes)
    fresh = kk + rng.integers(1, 4, size=lanes)
    ins = (opc == OP_INSERT) & ~np.isin(fresh, keys)
    kk[ins] = fresh[ins]
    h, o = len(hot), len(overflow)
    opc[:h] = OP_UPDATE
    kk[:h] = hot
    opc[h : h + o] = OP_INSERT
    kk[h : h + o] = overflow
    vals = kk ^ rng.integers(1, 2**40, size=lanes)
    kk[::29] = KEY_MAX
    return opc, kk, vals


def fresh_in_leaf(rng, row, n):
    """``n`` distinct keys strictly between a leaf row's first and last key
    and not in the row (the index holds no other key in that range)."""
    from repro_torch.core.nodes import KEY_MAX

    real = row[row != KEY_MAX]
    lo, hi = int(real[0]), int(real[-1])
    while True:
        cand = np.unique(rng.integers(lo + 1, hi, size=2 * n))
        cand = cand[~np.isin(cand, real)]
        if cand.size >= n:
            return rng.permutation(cand)[:n]


def phase_cpu_vs_cuda(seed, devices=("cpu", "cuda")):
    """The port on the CPU (plain versions) and on the card (kernels) give
    the same lane results and state planes: lookups under ``fetch`` (the
    cache and its duplicate admissions), ``fetch`` with buckets small enough
    to shed, and ``auto``; mixed lookups, updates and inserts under
    ``fetch``, shedding ``fetch``, ``offload`` and ``auto``; the same with
    scans (``ops=ALL_OPS``, ``max_count=32``, counts up to 40); the mixed
    engine with a trained route table under ``fetch``, ``offload`` and
    ``auto`` and a poisoned one under ``fetch``; ``install_boundaries`` then
    two mixed batches; and one SMO round after an insert burst that
    overflows eight leaves, then ``refresh_sep_planes``; comparing every
    plane (pool, occupancy, versions, ``n_alloc``, ``succ``, the route table
    and the separator planes included)."""
    import torch

    from repro_torch.core import dex, engine, fleet_cache, repartition, route_table
    from repro_torch.core import pool as pool_mod
    from repro_torch.core import smo, write
    from repro_torch.core.nodes import KEY_MAX, KEY_MIN
    from repro_torch.core.partition import LogicalPartitions
    from repro_torch.obs.registry import (
        STAT_DROPS,
        STAT_PEER_HITS,
        STAT_PEER_MISSES,
        STAT_PIPE_STALLS,
        STAT_RT_MISPREDICTS,
        STAT_RT_SKIPS,
        STAT_SMO_SPLITS,
        STAT_SPLITS,
        STAT_WRITES,
    )

    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(2**40, size=20_000, replace=False).astype(np.int64))
    keys -= 2**39
    bounds = np.array([KEY_MIN, keys[keys.size // 2], KEY_MAX], np.int64)
    lookups = []
    for _ in range(3):
        q = rng.choice(keys, size=4096).astype(np.int64)
        q[::13] += 1
        q[::29] = KEY_MAX
        z = np.zeros(q.shape, np.int64)
        lookups.append((z.astype(np.int32), q, z))
    # 30 fresh keys into one leaf (44 keys at fill 0.7, 20 slots of slack)
    overflow = keys[4400:4430] + 1
    mixed = [
        mixed_batch(rng, keys, 4096, keys[100:116], overflow if i == 1 else [])
        for i in range(3)
    ]
    scans = []
    for i in range(3):
        opc, kk, vals = mixed_batch(
            rng, keys, 4096, keys[100:116], overflow if i == 1 else []
        )
        scn = (np.arange(4096) >= 46) & (rng.random(4096) < 0.35)
        opc[scn] = engine.OP_SCAN
        vals[scn] = rng.integers(1, 41, size=int(scn.sum()))
        scans.append((opc, kk, vals))
    look_planes = ("stats", "miss_ema", "lat_hist", "lat_audit", "route_demand")
    write_ops = ("lookup", "update", "insert")
    runs = [
        ("lookups", ("lookup",), lookups, "fetch", 4.0),
        ("lookups", ("lookup",), lookups, "fetch", 0.5),
        ("lookups", ("lookup",), lookups, "auto", 4.0),
        ("mixed", write_ops, mixed, "fetch", 4.0),
        ("mixed", write_ops, mixed, "fetch", 0.5),
        ("mixed", write_ops, mixed, "offload", 4.0),
        ("mixed", write_ops, mixed, "auto", 4.0),
        ("scans", engine.ALL_OPS, scans, "fetch", 4.0),
        ("scans", engine.ALL_OPS, scans, "fetch", 0.5),
        ("scans", engine.ALL_OPS, scans, "offload", 4.0),
        ("scans", engine.ALL_OPS, scans, "auto", 4.0),
        ("rt trained", write_ops, mixed, "fetch", 4.0),
        ("rt trained", write_ops, mixed, "offload", 4.0),
        ("rt trained", write_ops, mixed, "auto", 4.0),
        ("rt poisoned", write_ops, mixed, "fetch", 4.0),
        ("pipelined", write_ops, mixed, "fetch", 4.0),
        ("pipelined", write_ops, mixed, "auto", 4.0),
        ("pipelined scans", engine.ALL_OPS, scans, "fetch", 4.0),
        ("divergent", write_ops, mixed, "fetch", 4.0),
        ("divergent lookups", ("lookup",), lookups, "fetch", 4.0),
        ("divergent pipelined", ("lookup", "update"), mixed, "fetch", 4.0),
    ]
    for label, ops_, batches, policy, factor in runs:
        table = label.startswith("rt")
        pipelined = "pipelined" in label
        cfg = mesh_config(policy, 64, factor, rt_slots=1024 if table else 0)
        pol = (
            fleet_cache.divergent_policy(cfg, peek_budget=512)
            if label.startswith("divergent") else None
        )
        out = []
        for dev in devices:
            pool, meta = pool_mod.build_pool(
                keys, keys ^ VALUE_XOR, level_m=1, n_shards=4, device=dev
            )
            state = dex.init_state(pool, meta, cfg, bounds, device=dev)
            if table:
                state = route_table.train_route_table(state, meta)
            if label == "rt poisoned":
                state = route_table.poison_route_table(state)
            eng = engine.make_dex_engine(
                meta, cfg, ops=ops_, max_count=32, cache_policy=pol,
                pipeline=pipelined, device=dev,
            )
            out.append([])
            if pipelined:
                eng.start(state)
            # a pipeline's steps: each batch, then the drain
            for step in list(batches) + ([None] if pipelined else []):
                if pipelined:
                    r = eng.push(*step) if step is not None else eng.drain()
                    state = eng.state
                else:
                    state, r = eng(state, *step)
                got = dex.state_to_numpy(state)
                if label in ("lookups", "divergent lookups"):
                    got = {
                        k: a
                        for k, a in got.items()
                        if k.startswith("cache.") or k in look_planes
                    }
                for k, a in (r._asdict() if r is not None else {}).items():
                    if a is not None:
                        got[k] = a.cpu().numpy()
                out[-1].append(got)
        for i, (a, b) in enumerate(zip(*out)):
            for k in a:
                if a[k].shape != b[k].shape or not np.array_equal(a[k], b[k]):
                    fail(
                        f"{label} {policy} x{factor}: CPU and CUDA differ at"
                        f" batch {i}: {k}"
                    )
        stats = out[0][-1]["stats"].sum(0)
        peer = stats[STAT_PEER_HITS] + stats[STAT_PEER_MISSES]
        print(
            f"cpu-vs-cuda {label} {policy} x{factor}: 3 batches of 4096 lanes,"
            f" 2x4 mesh, all {len(a)} planes and results equal"
            f" ({stats[STAT_DROPS]} shed, {stats[STAT_WRITES]} writes,"
            f" {stats[STAT_SPLITS]} splits, {stats[STAT_PIPE_STALLS]} pipeline"
            f" stalls, {stats[STAT_PEER_HITS]} peer hits, {stats[STAT_PEER_MISSES]}"
            " peer misses)"
        )
        inserts = "insert" in ops_
        if inserts and factor >= 1 and stats[STAT_SPLITS] == 0:
            fail(f"{label} {policy} x{factor}: no insert was shed as a split")
        if "scans" in label and not (out[0][-1]["taken"] > 0).any():
            fail(f"{label} {policy} x{factor}: no scan took a record")
        if pipelined and policy == "fetch" and stats[STAT_PIPE_STALLS] == 0:
            fail(f"{label} {policy}: the pipeline forced no stale lane")
        if label.startswith("divergent") and peer == 0:
            fail(f"{label} {policy}: no lane peeked")
        if table and policy == "fetch":
            skips, mis = stats[STAT_RT_SKIPS], stats[STAT_RT_MISPREDICTS]
            if (label == "rt trained") != (skips > 0) or mis == 0:
                fail(f"{label} {policy}: {skips} skips, {mis} mispredicts")

    # install new boundaries, then two mixed batches
    cfg = mesh_config("fetch", 64)
    old = LogicalPartitions(bounds)
    new = old.rebalance([3.0, 1.0], key_range=(int(keys[0]), int(keys[-1])))
    out = []
    for dev in devices:
        pool, meta = pool_mod.build_pool(
            keys, keys ^ VALUE_XOR, level_m=1, n_shards=4, device=dev
        )
        state = dex.init_state(pool, meta, cfg, bounds, device=dev)
        state, *counts = repartition.install_boundaries(state, meta, old, new)
        eng = engine.make_dex_engine(meta, cfg, ops=write_ops, device=dev)
        got = {"counts": np.array(counts)}
        for i, (opc, q, v) in enumerate(mixed[:2]):
            state, r = eng(state, opc, q, v)
            got.update({f"{i}/{k}": a for k, a in dex.state_to_numpy(state).items()})
            got.update({f"{i}/{k}": a.cpu().numpy() for k, a in r._asdict().items()
                        if a is not None})
        out.append(got)
    a, b = out
    for k in a:
        if a[k].shape != b[k].shape or not np.array_equal(a[k], b[k]):
            fail(f"install then two batches: CPU and CUDA differ: {k}")
    if a["counts"][0] == 0:
        fail("install: no node was invalidated")
    print(
        f"cpu-vs-cuda install: boundary {bounds[1]} -> {new.boundaries[1]},"
        f" (invalidated, shared before, shared after) {a['counts'].tolist()},"
        f" then 2 mixed batches, all {len(a)} planes and results equal"
    )

    # one SMO round after a burst of 30 fresh keys into each of eight leaves
    cfg = mesh_config("fetch", 64)
    leaves = (3, 50, 120, 200, 260, 330, 400, 440)
    burst = np.concatenate(
        [fresh_in_leaf(rng, keys[j * 44 : j * 44 + 44], 30) for j in leaves]
    )
    kk = np.full(4096, KEY_MAX, np.int64)
    kk[rng.permutation(4096)[: burst.size]] = burst
    vv = np.where(kk != KEY_MAX, kk ^ VALUE_XOR ^ 77, 0)
    out = []
    for dev in devices:
        pool, meta = pool_mod.build_pool(
            keys, keys ^ VALUE_XOR, level_m=1, n_shards=4, device=dev
        )
        state = dex.init_state(pool, meta, cfg, bounds, device=dev)
        sep = pool_mod.compress_separators(state.pool, meta)
        v0 = state.versions.clone()
        state, st = write.make_dex_insert(meta, cfg, device=dev)(state, kk, vv)
        shed = (st == write.STATUS_SPLIT).cpu().numpy()
        state, st1 = smo.make_dex_smo(meta, cfg, device=dev)(
            state, np.where(shed, kk, KEY_MAX), np.where(shed, vv, 0)
        )
        sep = smo.refresh_sep_planes(sep, state, meta, v0)
        fresh = pool_mod.compress_separators(state.pool, meta)
        if not all(torch.equal(x, y) for x, y in zip(sep, fresh)):
            fail(f"refresh_sep_planes on {dev} differs from a fresh compress")
        got = dex.state_to_numpy(state)
        got.update({f"sep.{k}": t.cpu().numpy() for k, t in sep._asdict().items()})
        got["insert_status"] = st.cpu().numpy()
        got["smo_status"] = st1.cpu().numpy()
        out.append(got)
    a, b = out
    for k in a:
        if a[k].shape != b[k].shape or not np.array_equal(a[k], b[k]):
            fail(f"smo round: CPU and CUDA differ: {k}")
    shed = a["insert_status"] == write.STATUS_SPLIT
    n_split = int(a["stats"][:, STAT_SMO_SPLITS].sum())
    if shed.sum() != burst.size or not (a["smo_status"][shed] == write.STATUS_OK).all():
        fail("smo round: the burst was not shed whole and settled in one round")
    if n_split != len(leaves):
        fail(f"smo round: {n_split} splits, expected {len(leaves)}")
    print(
        f"cpu-vs-cuda smo round: {burst.size} lanes shed and settled, {n_split}"
        f" splits, 2x4 mesh, all {len(a)} planes and statuses equal, separator"
        " planes refreshed equal to a fresh compress"
    )

    # two route axes: the 2x2x2 lookup, mixed and scan engines
    from repro_torch.core import mesh as mesh_mod

    bounds4 = quarter_bounds(keys)
    for label, ops_, batches, policy in (
        ("2x2x2 lookups", ("lookup",), lookups, "fetch"),
        ("2x2x2 mixed", write_ops, mixed, "auto"),
        ("2x2x2 scans", engine.ALL_OPS, scans, "auto"),
    ):
        cfg = axes_config(policy, 64)
        out = []
        for dev in devices:
            pool, meta = pool_mod.build_pool(
                keys, keys ^ VALUE_XOR, level_m=1, n_shards=2, device=dev
            )
            state = dex.init_state(pool, meta, cfg, bounds4, device=dev)
            eng = engine.make_dex_engine(meta, cfg, ops=ops_, max_count=32, device=dev)
            out.append([])
            for step in batches:
                mesh_mod.reset_counts()
                state, r = eng(state, *step)
                got = dex.state_to_numpy(state)
                got.update({k: a.cpu().numpy() for k, a in r._asdict().items()
                            if a is not None})
                got["counts"] = np.array(list(mesh_mod.collective_counts().values()))
                out[-1].append(got)
        for i, (a, b) in enumerate(zip(*out)):
            for k in a:
                if a[k].shape != b[k].shape or not np.array_equal(a[k], b[k]):
                    fail(f"{label} {policy}: CPU and CUDA differ at batch {i}: {k}")
        stats = out[0][-1]["stats"].sum(0)
        print(
            f"cpu-vs-cuda {label} {policy}: 3 batches of 4096 lanes, route axes 2 x 2"
            f" over 2 memory columns, all {len(a)} planes, results and collective"
            f" counts {a['counts'].tolist()} equal ({stats[STAT_DROPS]} shed,"
            f" {stats[STAT_WRITES]} writes, {stats[STAT_SPLITS]} splits)"
        )

    # settle_splits with a drain: 30 fresh keys into each of six leaves of a
    # block whose free list holds three rows
    from repro_torch.core import sim

    cfg = mesh_config("fetch", 64)
    burst = np.concatenate(
        [fresh_in_leaf(rng, keys[j * 44 : j * 44 + 44], 30) for j in range(6)]
    )
    kk = np.full(4096, KEY_MAX, np.int64)
    kk[rng.permutation(4096)[: burst.size]] = burst
    vv = np.where(kk != KEY_MAX, kk ^ VALUE_XOR ^ 99, 0)
    out = []
    for dev in devices:
        pool, meta = pool_mod.build_pool(
            keys, keys ^ VALUE_XOR, level_m=1, n_shards=4, headroom=0.05, device=dev
        )
        state = dex.init_state(pool, meta, cfg, bounds, device=dev)
        mirror = sim.HostBTree(keys, keys ^ VALUE_XOR)
        state, st = write.make_dex_insert(meta, cfg, device=dev)(state, kk, vv)
        shed = (st == write.STATUS_SPLIT).cpu().numpy()
        state, meta, info = smo.settle_splits(
            state, meta, cfg, smo.make_dex_smo(meta, cfg, device=dev), mirror,
            np.where(shed, kk, KEY_MAX), np.where(shed, vv, 0), bounds,
        )
        state, r = engine.make_dex_engine(meta, cfg, device=dev)(
            state, np.zeros(4096, np.int32), np.where(kk == KEY_MAX, keys[:4096], kk),
            np.zeros(4096, np.int64),
        )
        got = dex.state_to_numpy(state)
        got.update({k: a.cpu().numpy() for k, a in r._asdict().items() if a is not None})
        got.update({f"mirror.{p}": getattr(mirror, p) for p in ("K", "V", "NK", "parent")})
        got["insert_status"] = st.cpu().numpy()
        out.append((got, meta, info))
    (a, meta_a, info_a), (b, meta_b, info_b) = out
    if info_a != info_b or meta_a != meta_b:
        fail(f"settle_splits: CPU and CUDA differ: {info_a} {info_b}")
    for k in a:
        if a[k].shape != b[k].shape or not np.array_equal(a[k], b[k]):
            fail(f"settle_splits: CPU and CUDA differ: {k}")
    if not info_a["drained"] or info_a["onmesh"] == 0 or not a["found"].all():
        fail(f"settle_splits: {info_a}, all found {bool(a['found'].all())}")
    print(
        f"cpu-vs-cuda settle_splits: {burst.size} lanes shed, {json.dumps(info_a)},"
        f" pool rebuilt to {meta_a.n_subtrees} subtrees, then a lookup batch; all"
        f" {len(a)} planes, results and mirror planes equal"
    )


def profile_batch(policy, eng, state, median_ms, *inputs):
    """Run one batch under ``torch.profiler``; print its device busy time,
    the idle share of ``median_ms`` (the policy's unprofiled median batch,
    since the profiler itself slows the host) and the kernels that took the
    most device time."""
    out, wall, events, _ = device_profile(lambda: eng(state, *inputs))
    busy = sum(ms for _, ms, _ in events)
    top = "; ".join(f"{k[:48]} {ms:.3f} ms x{n}" for k, ms, n in events[:8])
    shares = []
    for name in ("node_search_kernel", "subtree_walk"):
        mine = [(ms, n) for k, ms, n in events if name in k]
        ms = sum(m for m, _ in mine)
        shares.append(f"{name.removesuffix('_kernel')} {ms:.4f} ms"
                      f" x{sum(n for _, n in mine)}, {pct(share_of(ms, busy))} of busy")
    print(
        f"profile {policy}: wall {wall:.2f} ms under the profiler, device busy"
        f" {busy:.2f} ms, idle {pct(idle_of(busy, median_ms))} of the unprofiled"
        f" median {median_ms:.2f} ms; {'; '.join(shares)}; top: {top}"
    )
    return (*out, idle_of(busy, median_ms))


def recorded_calls(label, eng, state, inputs):
    """One engine batch with every ``node_search`` and ``subtree_walk`` call
    recorded and printed: a search's rows, the share of KEY_MAX queries, of
    all-KEY_MAX rows and of KEY_MAX queries on other rows, and whether it
    reads values; a walk's lanes and the share it walks (``active``).  So
    the layouts phase 3 times (``engine_mix``, ``walk_engine_mix``) can be
    read against real ones."""
    from repro_torch.core.nodes import KEY_MAX
    from repro_torch.kernels import ops

    calls, search, walk = [], ops.node_search, ops.subtree_walk

    def searched(rows, queries, values=None):
        top = queries == KEY_MAX
        empty = (rows == KEY_MAX).all(1)
        calls.append(("node_search", dict(
            rows=queries.numel(),
            keymax_share=float(top.float().mean()),
            empty_row_share=float(empty.float().mean()),
            keymax_on_other_rows=int((top & ~empty).sum()),
            values=values is not None,
        )))
        return search(rows, queries, values)

    def walked(*args, levels, active=None):
        lanes = args[4].numel()
        calls.append(("subtree_walk", dict(
            lanes=lanes,
            active_share=1.0 if active is None else float(active.float().mean()),
            levels=levels,
        )))
        return walk(*args, levels=levels, active=active)

    ops.node_search, ops.subtree_walk = searched, walked
    try:
        out = eng(state, *inputs)
    finally:
        ops.node_search, ops.subtree_walk = search, walk
    for kernel, c in calls:
        print(f"main {label}: {kernel} call {json.dumps(c)}")
    return out


class HostOracle:
    """The index's contents on the host: the bulk-loaded keys (each value a
    fixed function of its key) and every write the engine acknowledged."""

    def __init__(self, host_keys):
        self.keys = host_keys
        self.written = {}  # key -> value of each acknowledged write
        self._arrays = None  # the written keys sorted, and their values

    def apply(self, kk, vals):
        """Take acknowledged writes, in lane order (the last lane of a key
        wins)."""
        self.written.update(zip(kk.tolist(), vals.tolist()))
        self._arrays = None

    def written_arrays(self):
        if self._arrays is None:
            wk = np.fromiter(self.written.keys(), np.int64, len(self.written))
            wv = np.fromiter(self.written.values(), np.int64, len(self.written))
            order = np.argsort(wk)
            self._arrays = (wk[order], wv[order])
        return self._arrays

    def lookup(self, q):
        """``(found, value)`` of each key of ``q`` in the current contents."""
        n = self.keys.size
        # sorted queries let each search start from the last one's answer
        order = np.argsort(q, kind="stable")
        pos = np.empty_like(order)
        pos[order] = np.searchsorted(self.keys, q[order])
        found = (pos < n) & (self.keys[np.minimum(pos, n - 1)] == q)
        wk, wv = self.written_arrays()
        value = q ^ VALUE_XOR
        if wk.size:
            pw = np.minimum(np.searchsorted(wk, q), wk.size - 1)
            in_w = wk[pw] == q
            value = np.where(in_w, wv[pw], value)
            found = found | in_w
        return found, value

    def scan(self, starts, counts, mc):
        """``(keys [n, mc] KEY_MAX-padded, values [n, mc] 0-padded, taken)``:
        the first ``counts`` keys >= each start in the current contents,
        merged from ``mc`` bulk keys and ``mc`` written keys per lane."""
        from repro_torch.core.nodes import KEY_MAX

        col = np.arange(mc)

        def window(arr, s):
            if arr.size == 0:
                return np.full((s.size, mc), KEY_MAX, np.int64)
            idx = np.searchsorted(arr, s)[:, None] + col
            return np.where(idx < arr.size, arr[np.minimum(idx, arr.size - 1)], KEY_MAX)

        wk, wv = self.written_arrays()
        both = np.sort(np.concatenate([window(self.keys, starts), window(wk, starts)], 1), 1)
        dup = np.zeros(both.shape, bool)
        dup[:, 1:] = both[:, 1:] == both[:, :-1]
        both = np.sort(np.where(dup, KEY_MAX, both), 1)[:, :mc]
        both = np.where(col < np.clip(counts, 0, mc)[:, None], both, KEY_MAX)
        real = both != KEY_MAX
        _, vals = self.lookup(both.reshape(-1))
        vals = np.where(real, vals.reshape(both.shape), 0)
        return both, vals, real.sum(1)

    def check(self, where, opc, kk, vals, r, mc=0):
        """Hold one batch's results to the contents before it, then apply
        its acknowledged writes.  A scan lane carries its count in ``vals``
        and must return the first ``count`` keys >= its start.  Returns
        ``(lanes checked, lanes shed, splits)``."""
        from repro_torch.core.engine import OP_INSERT, OP_LOOKUP, OP_SCAN, OP_UPDATE
        from repro_torch.core.write import STATUS_MISS, STATUS_OK, STATUS_SPLIT

        found, values, status, shed = (
            t.cpu().numpy() for t in (r.found, r.values, r.status, r.shed)
        )
        ok = ~shed
        exists, cur = self.lookup(kk)
        lk = ok & (opc == OP_LOOKUP)
        if not (found[lk] == exists[lk]).all():
            fail(f"{where}: found differs from the host oracle")
        if not (values[lk & exists] == cur[lk & exists]).all():
            fail(f"{where}: values differ from the host oracle")
        up = ok & (opc == OP_UPDATE)
        if not (status[up] == np.where(exists[up], STATUS_OK, STATUS_MISS)).all():
            fail(f"{where}: an update's status differs from the host oracle")
        ins = ok & (opc == OP_INSERT)
        if not np.isin(status[ins], (STATUS_OK, STATUS_SPLIT)).all():
            fail(f"{where}: an insert was neither applied nor shed as a split")
        if r.scan_keys is not None:
            sc = np.flatnonzero(ok & (opc == OP_SCAN))
            want_k, want_v, want_t = self.scan(kk[sc], vals[sc], mc)
            taken = r.taken.cpu().numpy()
            if not (taken[sc] == want_t).all():
                fail(f"{where}: a scan's taken differs from the host oracle")
            if not np.array_equal(r.scan_keys.cpu().numpy()[sc], want_k):
                fail(f"{where}: scan keys differ from the host oracle")
            if not np.array_equal(r.scan_values.cpu().numpy()[sc], want_v):
                fail(f"{where}: scan values differ from the host oracle")
            if not (taken[shed & (opc == OP_SCAN)] == -1).all():
                fail(f"{where}: a shed scan did not report taken = -1")
        done = (up | ins) & (status == STATUS_OK)
        self.apply(kk[done], vals[done])
        return int(ok.sum()), int(shed.sum()), int((status == STATUS_SPLIT).sum())


def phase_main(args, keys, pool, meta):
    """The full-size runs of ``MAIN_RUNS``, in order, on one index: the
    engine writes the pool in place, so each run starts from the contents
    the runs before it left, and so does the host oracle."""
    import torch

    from repro_torch.core import dex, engine
    from repro_torch.core.nodes import KEY_MIN, KEY_MAX
    from repro_torch.data import ycsb
    from repro_torch.kernels import ops
    from repro_torch.obs import registry as reg

    n = keys.numel()
    dev = keys.device
    host_keys = keys.cpu().numpy()
    bounds = np.array([KEY_MIN, host_keys[n // 2], KEY_MAX], np.int64)
    oracle = HostOracle(host_keys)
    engine_ops = {
        "read-only": ("lookup",),
        "ycsb-a": ("lookup", "update"),
        "insert-intensive": ("lookup", "insert"),
    }
    # the kernels each path must launch
    path_kernels = {
        "read-only": ("node_search", "subtree_walk"),
        "ycsb-a": ("node_search", "subtree_walk", "leaf_write"),
        "insert-intensive": ("node_search", "subtree_walk", "leaf_write"),
    }
    report, per_path = {}, {}
    batch_no = 0
    for w_i, workload in enumerate(dict.fromkeys(r[0] for r in MAIN_RUNS)):
        runs = [r for r in MAIN_RUNS if r[0] == workload]
        ops.reset_launches()
        total = sum(warm + timed + 1 for _, _, warm, timed in runs)
        wl = ycsb.generate(workload, host_keys, BATCH * total, seed=args.seed + 1 + w_i)
        off = 0
        for _, policy, warm, timed in runs:
            cfg = mesh_config(policy, 65_536)
            state = dex.init_state(pool, meta, cfg, bounds, device=dev)
            eng = engine.make_dex_engine(
                meta, cfg, ops=engine_ops[workload], device=dev
            )
            torch.cuda.reset_peak_memory_stats()
            times, batches = [], []
            for i in range(warm + timed + 1):
                opc = wl.ops[off : off + BATCH]
                kk = wl.keys[off : off + BATCH]
                off += BATCH
                batch_no += 1
                # a value no earlier write of the key has had
                stamp = (batch_no << 20) + np.arange(BATCH)
                vals = kk ^ VALUE_XOR ^ stamp
                inputs = [torch.from_numpy(a).to(dev) for a in (opc, kk, vals)]
                torch.cuda.synchronize()
                if workload == "read-only" and i == 0 and policy != "auto":
                    # a warm-up batch: what each kernel call sees
                    label = f"{workload} {policy}"
                    state, r = recorded_calls(label, eng, state, inputs)
                elif i == warm + timed:
                    # one more batch under the profiler: where the time goes
                    med = float(np.median(times))
                    label = f"{workload} {policy}"
                    state, r, idle = profile_batch(label, eng, state, med, *inputs)
                else:
                    t0 = time.perf_counter()
                    state, r = eng(state, *inputs)
                    torch.cuda.synchronize()
                    if i >= warm:
                        times.append((time.perf_counter() - t0) * 1e3)
                batches.append((opc, kk, vals, r))
            # the oracle's host work runs after the batches, not between them
            checked, shed, splits = 0, 0, 0
            for i, (opc, kk, vals, r) in enumerate(batches):
                where = f"{workload} {policy} batch {i}"
                c, s_, sp = oracle.check(where, opc, kk, vals, r)
                checked, shed, splits = checked + c, shed + s_, splits + sp
            del batches
            stats = state.stats.sum(0).cpu().numpy()
            med = float(np.median(times))
            run = f"{workload}/{policy}"
            report[run] = dict(
                median_ms=med,
                p25_ms=float(np.percentile(times, 25)),
                p75_ms=float(np.percentile(times, 75)),
                ops_per_s=BATCH / med * 1e3,
                batches=timed,
                checked_lanes=checked,
                shed_lanes=shed,
                split_lanes=splits,
                hits=int(stats[reg.STAT_HITS]),
                fetches=int(stats[reg.STAT_FETCHES]),
                offloads=int(stats[reg.STAT_OFFLOADS]),
                writes=int(stats[reg.STAT_WRITES]),
                splits=int(stats[reg.STAT_SPLITS]),
                drops=int(stats[reg.STAT_DROPS]),
                offload_groups=int(stats[reg.STAT_OFFLOAD_GROUPS]),
                fetch_groups=int(stats[reg.STAT_FETCH_GROUPS]),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                idle_share=idle,
            )
            print(f"main {workload} {policy}: {json.dumps(report[run])}")
            del state, eng
        per_path[workload] = dict(ops.LAUNCHES)
        check_launches(workload, per_path[workload], path_kernels[workload])
    print(f"main: {len(oracle.written)} keys written")
    return report, per_path, oracle, bounds


def check_launches(path, launches, kernels):
    print(f"main {path}: launches {launches}")
    for k in kernels:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the {path} path")


def timed_smo(smo, round_ms):
    """``smo`` with each round's milliseconds (host clock around a
    synchronised round) appended to ``round_ms``."""
    import torch

    def run(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = smo(*a)
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    return run


def sep_descent(pool, sep, meta, q):
    """Walk ``q`` down its subtree level by level through the compressed
    planes: at every level ``node_search_prefix``'s slot must equal
    ``node_search``'s on the canonical row.  Returns ``(found, value,
    compressible share per level)`` from the prefix search's leaf slot."""
    import torch

    from repro_torch.core.pool import top_walk
    from repro_torch.kernels import ops

    st = top_walk(pool, meta, q)
    local = torch.zeros_like(q)
    shares = []
    for lvl in range(meta.levels_in_subtree):
        nbits = sep.nbits[st, local]
        rows = pool.pool_keys[st, local]
        slot = ops.node_search_prefix(
            sep.prefix[st, local], nbits, sep.suffix[st, local], rows, q
        )
        want, _, _ = ops.node_search(rows, q)
        if not torch.equal(slot, want):
            bad = int((slot != want).sum())
            fail(f"sep descent: node_search_prefix differs at level {lvl} ({bad} lanes)")
        shares.append(float((nbits >= 0).float().mean()))
        if lvl < meta.level_m:
            local = pool.pool_children[st, local, slot.long()].long()
    slot = slot.long()[:, None]
    found = rows.gather(1, slot)[:, 0] == q
    value = pool.pool_values[st, local].gather(1, slot)[:, 0]
    return found, torch.where(found, value, 0), shares


def phase_splits_and_scans(args, keys, pool, meta, oracle, bounds):
    """On the index the main runs left, with one state carried through: the
    compressed separator planes built at load; a split burst settled on the
    mesh, the planes refreshed and held to a fresh build, and the burst's and
    a YCSB-C batch's keys descended through them; a scan batch across the
    split leaves, then YCSB workload E under each policy of
    ``SCAN_RUNS``."""
    import torch

    from repro_torch.core import dex, engine, smo, write
    from repro_torch.core import pool as pool_mod
    from repro_torch.core.nodes import KEY_MAX
    from repro_torch.core.scan import make_dex_scan
    from repro_torch.data import ycsb
    from repro_torch.kernels import ops
    from repro_torch.obs import registry as reg

    dev = keys.device
    host_keys = oracle.keys
    rng = np.random.default_rng(args.seed + 20)
    cfg = mesh_config("fetch", 65_536)
    state = dex.init_state(pool, meta, cfg, bounds, device=dev)
    smo_round = smo.make_dex_smo(meta, cfg, device=dev)
    report, per_path = {}, {}

    def stat(st, i):
        return int(st.stats[:, i].sum())

    # 0. the compressed separator planes of the pool as loaded here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sep = pool_mod.compress_separators(state.pool, meta)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    # sep_compression_stats counts only rows with a real suffix, so it
    # cannot see incompressible rows; the share of all non-empty rows is
    # counted here
    real = state.pool.pool_keys[..., 0] != KEY_MAX
    report["sep-planes"] = dict(
        build_ms=build_ms,
        plane_bytes=sum(t.numel() * t.element_size() for t in sep),
        nonempty_rows=int(real.sum()),
        compressible_share_of_nonempty=float(
            ((sep.nbits >= 0) & real).sum() / real.sum()
        ),
        **pool_mod.sep_compression_stats(sep, meta),
    )
    print(f"main sep-planes: {json.dumps(report['sep-planes'])}")
    v0 = state.versions.clone()  # a copy: the burst bumps the plane in place

    # 1. the split burst: 32 fresh keys into each of 2,048 leaves, one leaf
    # in each of 2,048 subtrees other than the last
    ops.reset_launches()
    subtrees = rng.choice(meta.n_subtrees - 1, size=SMO_LEAVES, replace=False)
    local = meta.leaf_start + rng.integers(0, meta.leaves_per_subtree, SMO_LEAVES)
    rows = pool.pool_keys[
        torch.from_numpy(subtrees).to(dev), torch.from_numpy(local).to(dev)
    ].cpu().numpy()
    burst = np.concatenate([fresh_in_leaf(rng, r, SMO_KEYS_PER_LEAF) for r in rows])
    kk = rng.permutation(burst)
    vv = kk ^ VALUE_XOR ^ (1 << 50)
    t0 = time.perf_counter()
    state, st = write.make_dex_insert(meta, cfg, device=dev)(state, kk, vv)
    st = st.cpu().numpy()
    if not (st == write.STATUS_SPLIT).all():
        fail(f"split burst: {int((st != write.STATUS_SPLIT).sum())} lanes not shed")
    before = stat(state, reg.STAT_SMO_SPLITS)
    round_ms = []
    state, status, rounds = smo.run_smo(timed_smo(smo_round, round_ms), state, kk, vv)
    took = (time.perf_counter() - t0) * 1e3
    n_split = stat(state, reg.STAT_SMO_SPLITS) - before
    if not (status == write.STATUS_OK).all():
        fail(f"split burst: {int((status != write.STATUS_OK).sum())} lanes unsettled")
    if n_split != SMO_LEAVES:
        fail(f"split burst: {n_split} on-mesh splits, expected {SMO_LEAVES}")
    oracle.apply(kk, vv)
    report["split-burst"] = dict(
        lanes=int(kk.size),
        leaves=SMO_LEAVES,
        smo_splits=n_split,
        rounds=rounds,
        round_ms=round_ms,
        total_ms=took,
    )
    print(f"main split-burst: {json.dumps(report['split-burst'])}")
    per_path["split-burst"] = dict(ops.LAUNCHES)
    check_launches("split-burst", per_path["split-burst"], ("leaf_split", "leaf_write"))

    # 1b. the separator planes after the burst: refreshed from the version
    # delta, equal to a fresh build on every row; then the burst's keys and
    # a YCSB-C batch's keys descend through them
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sep = smo.refresh_sep_planes(sep, state, meta, v0)
    torch.cuda.synchronize()
    refresh_ms = (time.perf_counter() - t0) * 1e3
    fresh = pool_mod.compress_separators(state.pool, meta)
    if not all(torch.equal(a, b) for a, b in zip(sep, fresh)):
        fail("refresh_sep_planes differs from a fresh compress_separators")
    n_changed = int((state.versions[0] != v0[0]).sum())
    del fresh, v0
    ops.reset_launches()
    wl = ycsb.generate("read-only", host_keys, BATCH, seed=args.seed + 22)
    q = np.concatenate([kk, wl.keys])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    found, value, shares = sep_descent(pool, sep, meta, torch.from_numpy(q).to(dev))
    torch.cuda.synchronize()
    descent_ms = (time.perf_counter() - t0) * 1e3
    want_f, want_v = oracle.lookup(q)
    found, value = found.cpu().numpy(), value.cpu().numpy()
    if not (np.array_equal(found, want_f) and np.array_equal(value[found], want_v[found])):
        fail("sep descent: the leaf match differs from the host oracle")
    report["sep-descent"] = dict(
        refresh_ms=refresh_ms,
        rows_refreshed=n_changed,
        lanes=int(q.size),
        found=int(found.sum()),
        compressible_share_by_level=shares,
        descent_ms=descent_ms,
    )
    print(f"main sep-descent: {json.dumps(report['sep-descent'])}")
    per_path["sep-descent"] = dict(ops.LAUNCHES)
    check_launches(
        "sep-descent", per_path["sep-descent"], ("node_search", "node_search_prefix")
    )
    del sep

    # 2. scans across the splits: half start at a burst leaf's first key
    ops.reset_launches()
    scan = make_dex_scan(meta, cfg, max_count=SCAN_MAX_COUNT, device=dev)
    starts = np.concatenate([
        np.resize(rows[:, 0], BATCH // 2),
        rng.choice(host_keys, size=BATCH - BATCH // 2),
    ])
    counts = np.full(BATCH, SCAN_MAX_COUNT, np.int64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, sk, sv, tk = scan(state, starts, counts)
    torch.cuda.synchronize()
    took = (time.perf_counter() - t0) * 1e3
    want_k, want_v, want_t = oracle.scan(starts, counts, SCAN_MAX_COUNT)
    if not (np.array_equal(tk.cpu().numpy(), want_t)
            and np.array_equal(sk.cpu().numpy(), want_k)
            and np.array_equal(sv.cpu().numpy(), want_v)):
        fail("scan check: results differ from the host oracle")
    report["scan-check"] = dict(lanes=BATCH, ms=took, records=int(want_t.sum()))
    print(f"main scan-check: {json.dumps(report['scan-check'])}")
    per_path["scan-check"] = dict(ops.LAUNCHES)
    check_launches("scan-check", per_path["scan-check"], ("node_search", "leaf_scan"))

    # 3. YCSB workload E: 95% scans of uniform length 1-100, 5% inserts
    total = sum(warm + timed + 1 for _, warm, timed in SCAN_RUNS)
    wl = ycsb.generate(
        "ycsb-e", host_keys, BATCH * total, seed=args.seed + 21,
        scan_len=SCAN_MAX_COUNT, scan_len_dist="uniform",
    )
    off = 0
    for policy, warm, timed in SCAN_RUNS:
        ops.reset_launches()
        pcfg = mesh_config(policy, 65_536)
        eng = engine.make_dex_engine(
            meta, pcfg, ops=("insert", "scan"), max_count=SCAN_MAX_COUNT, device=dev
        )
        torch.cuda.reset_peak_memory_stats()
        stats0 = state.stats.sum(0).cpu().numpy()
        times, batches, smo_ms, smo_rounds = [], [], [], 0
        for i in range(warm + timed + 1):
            opc, kk, vals = ycsb.engine_lanes(wl, off, off + BATCH)
            off += BATCH
            stamp = (off << 20) + np.arange(BATCH)
            vals = np.where(opc == engine.OP_SCAN, vals, kk ^ VALUE_XOR ^ stamp)
            inputs = [torch.from_numpy(a).to(dev) for a in (opc, kk, vals)]
            torch.cuda.synchronize()
            if i == warm + timed:
                med = float(np.median(times))
                state, r, idle = profile_batch(
                    f"ycsb-e {policy}", eng, state, med, *inputs
                )
            else:
                t0 = time.perf_counter()
                state, r = eng(state, *inputs)
                torch.cuda.synchronize()
                if i >= warm:
                    times.append((time.perf_counter() - t0) * 1e3)
            # split lanes settle on the mesh after the batch, untimed
            split = (r.status == write.STATUS_SPLIT).cpu().numpy()
            settled = (np.zeros(0, np.int64),) * 2
            if split.any():
                sk_ = np.where(split, kk, KEY_MAX)
                t0 = time.perf_counter()
                state, sst, nr = smo.run_smo(smo_round, state, sk_, vals)
                torch.cuda.synchronize()
                smo_ms.append((time.perf_counter() - t0) * 1e3)
                smo_rounds += nr
                ok = sst == write.STATUS_OK
                settled = (kk[ok], vals[ok])
            batches.append((opc, kk, vals, r, settled))
        checked, shed, splits = 0, 0, 0
        for i, (opc, kk, vals, r, settled) in enumerate(batches):
            c, s_, sp = oracle.check(
                f"ycsb-e {policy} batch {i}", opc, kk, vals, r, SCAN_MAX_COUNT
            )
            oracle.apply(*settled)
            checked, shed, splits = checked + c, shed + s_, splits + sp
        del batches
        stats = state.stats.sum(0).cpu().numpy() - stats0
        med = float(np.median(times))
        run = f"ycsb-e/{policy}"
        report[run] = dict(
            median_ms=med,
            p25_ms=float(np.percentile(times, 25)),
            p75_ms=float(np.percentile(times, 75)),
            ops_per_s=BATCH / med * 1e3,
            batches=timed,
            checked_lanes=checked,
            shed_lanes=shed,
            split_lanes=splits,
            hits=int(stats[reg.STAT_HITS]),
            fetches=int(stats[reg.STAT_FETCHES]),
            offloads=int(stats[reg.STAT_OFFLOADS]),
            writes=int(stats[reg.STAT_WRITES]),
            smo_splits=int(stats[reg.STAT_SMO_SPLITS]),
            smo_rounds=smo_rounds,
            smo_ms=smo_ms,
            drops=int(stats[reg.STAT_DROPS]),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            idle_share=idle,
        )
        print(f"main ycsb-e {policy}: {json.dumps(report[run])}")
        print(
            f"main ycsb-e {policy} smo (untimed, after the batches that shed"
            f" splits): {smo_rounds} rounds, ms {smo_ms}"
        )
        path = f"ycsb-e/{policy}"
        per_path[path] = dict(ops.LAUNCHES)
        need = ("node_search", "leaf_scan", "leaf_write")
        if policy != "fetch":
            need += ("subtree_walk",)
        check_launches(path, per_path[path], need)
        del eng
    print(f"main: {len(oracle.written)} keys written")
    # the successor table and free-list watermarks the splits left: a later
    # scan or split must start from them, not from a fresh state's
    return report, per_path, (state.succ, state.n_alloc)


def run_batches(eng, state, batches, label, dev, profile=True):
    """Run ``(opc, keys, values)`` batches, the first ``warm`` untimed and,
    with ``profile``, the last under the profiler.  Returns ``(state,
    results, times_ms, idle share or None)``."""
    import torch

    times, results, idle = [], [], None
    n = len(batches)
    for i, (warm, opc, kk, vals) in enumerate(batches):
        inputs = [torch.from_numpy(a).to(dev) for a in (opc, kk, vals)]
        torch.cuda.synchronize()
        if profile and i == n - 1:
            state, r, idle = profile_batch(
                label, eng, state, float(np.median(times)), *inputs
            )
        else:
            t0 = time.perf_counter()
            state, r = eng(state, *inputs)
            torch.cuda.synchronize()
            if not warm:
                times.append((time.perf_counter() - t0) * 1e3)
        results.append(r)
    return state, results, times, idle


def phase_route_table(args, keys, pool, meta, oracle, bounds):
    """The leaf-direct route table at full size: trained once on the pool
    the earlier runs left (``RT_SLOTS`` slots), then each workload of
    ``RT_RUNS`` under ``fetch`` in three arms over one trace: descent only,
    leaf-direct and poisoned.  Every arm starts from a fresh state (cold
    caches, zero counters and versions) over the same pool: the value plane
    is restored from a clone taken before the first arm, and the host oracle
    from a copy.  Every lane that is not shed must equal the oracle; the
    poisoned arm must equal the descent arm lane for lane and in fetches,
    with no skip; the leaf-direct arm must skip."""
    import torch

    from repro_torch.core import dex, engine, route_table
    from repro_torch.data import ycsb
    from repro_torch.kernels import ops
    from repro_torch.obs import registry as reg

    dev = keys.device
    report, per_path = {}, {}
    cfg_rt = mesh_config("fetch", 65_536, rt_slots=RT_SLOTS)
    state = dex.init_state(pool, meta, cfg_rt, bounds, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trained = route_table.train_route_table(state, meta)
    torch.cuda.synchronize()
    train_ms = (time.perf_counter() - t0) * 1e3
    live = int((trained.rt_ver >= 0).sum())
    tables = {
        "leaf-direct": trained,
        "poisoned": route_table.poison_route_table(trained),
    }
    report["rt-train"] = dict(
        train_ms=train_ms,
        slots=RT_SLOTS,
        live_entries=live,
        table_bytes=sum(
            getattr(trained, f).numel() * getattr(trained, f).element_size()
            for f in ("rt_keys", "rt_hi", "rt_sub", "rt_local", "rt_ver")
        ),
    )
    print(f"main rt-train: {json.dumps(report['rt-train'])}")
    if live > RT_SLOTS - 1 or live < meta.n_keys // meta.per_node:
        fail(f"route table: {live} live entries for {RT_SLOTS} slots")
    del state
    saved_values = pool.pool_values.clone()
    saved_written = dict(oracle.written)
    engine_ops = {"read-only": ("lookup",), "ycsb-a": ("lookup", "update")}
    path_kernels = {"read-only": ("node_search",), "ycsb-a": ("node_search", "leaf_write")}
    for w_i, (workload, warm, timed) in enumerate(RT_RUNS):
        n_b = warm + timed + 1
        wl = ycsb.generate(workload, oracle.keys, BATCH * n_b, seed=args.seed + 30 + w_i)
        batches = []
        for i in range(n_b):
            opc = wl.ops[i * BATCH : (i + 1) * BATCH]
            kk = wl.keys[i * BATCH : (i + 1) * BATCH]
            vals = kk ^ VALUE_XOR ^ ((700 + i) << 20) ^ np.arange(BATCH)
            batches.append((i < warm, opc, kk, vals))
        descent = None
        for arm in RT_ARMS:
            pool.pool_values.copy_(saved_values)
            oracle.written = dict(saved_written)
            oracle._arrays = None
            cfg = mesh_config("fetch", 65_536) if arm == "descent" else cfg_rt
            state = dex.init_state(pool, meta, cfg, bounds, device=dev)
            if arm != "descent":
                t = tables[arm]
                state = state._replace(
                    rt_keys=t.rt_keys, rt_hi=t.rt_hi, rt_sub=t.rt_sub,
                    rt_local=t.rt_local, rt_ver=t.rt_ver,
                )
            eng = engine.make_dex_engine(meta, cfg, ops=engine_ops[workload], device=dev)
            ops.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            state, results, times, idle = run_batches(
                eng, state, batches, f"rt {workload} {arm}", dev
            )
            lanes = [
                {k: getattr(r, k).cpu().numpy() for k in ("found", "values", "status", "shed")}
                for r in results
            ]
            checked = shed = 0
            for i, ((_, opc, kk, vals), r) in enumerate(zip(batches, results)):
                c, s_, _ = oracle.check(f"rt {workload} {arm} batch {i}", opc, kk, vals, r)
                checked, shed = checked + c, shed + s_
            stats = state.stats.sum(0).cpu().numpy()
            med = float(np.median(times))
            run = f"rt/{workload}/{arm}"
            report[run] = dict(
                median_ms=med,
                p25_ms=float(np.percentile(times, 25)),
                p75_ms=float(np.percentile(times, 75)),
                ops_per_s=BATCH / med * 1e3,
                batches=timed,
                checked_lanes=checked,
                shed_lanes=shed,
                hits=int(stats[reg.STAT_HITS]),
                fetches=int(stats[reg.STAT_FETCHES]),
                fetches_per_op=float(stats[reg.STAT_FETCHES] / stats[reg.STAT_OPS]),
                rt_skips=int(stats[reg.STAT_RT_SKIPS]),
                rt_mispredicts=int(stats[reg.STAT_RT_MISPREDICTS]),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                idle_share=idle,
            )
            print(f"main rt {workload} {arm}: {json.dumps(report[run])}")
            per_path[run] = dict(ops.LAUNCHES)
            check_launches(run, per_path[run], path_kernels[workload])
            if arm == "descent":
                descent = (lanes, report[run])
            elif arm == "poisoned":
                same = all(
                    np.array_equal(a[k], b[k]) for a, b in zip(descent[0], lanes) for k in a
                )
                if not same or report[run]["fetches"] != descent[1]["fetches"]:
                    fail(f"rt {workload}: the poisoned arm differs from the descent arm")
                if report[run]["rt_skips"] != 0 or report[run]["rt_mispredicts"] == 0:
                    fail(f"rt {workload}: the poisoned arm accepted a guess")
            elif report[run]["rt_skips"] == 0:
                fail(f"rt {workload}: the leaf-direct arm skipped nothing")
            del state, eng, results
    pool.pool_values.copy_(saved_values)
    oracle.written = saved_written
    oracle._arrays = None
    del saved_values, tables, trained
    return report, per_path


def phase_repartition(args, keys, pool, meta, oracle, bounds):
    """Live repartitioning at full size: a localized YCSB-C Zipfian
    (``REPART_PHASES``: hotspot 0.2, then 0.8) under tight buckets
    (``REPART_FACTOR``) with a trained route table, once with the static
    boundary table and once with a ``RepartitionController``
    (``imbalance_threshold`` 1.2, ``min_ops`` one batch, no cooldown), which
    retrains the table after each install.  The controller run must shed
    strictly fewer lanes; every lane that is not shed must equal the
    oracle."""
    import torch

    from repro_torch.core import dex, engine, repartition, route_table
    from repro_torch.core.partition import LogicalPartitions
    from repro_torch.data import ycsb
    from repro_torch.kernels import ops
    from repro_torch.obs import registry as reg

    dev = keys.device
    cfg = mesh_config("fetch", 65_536, factor=REPART_FACTOR, rt_slots=RT_SLOTS)
    batches = []
    for p_i, (hotspot, n_b) in enumerate(REPART_PHASES):
        wl = ycsb.generate(
            "read-only", oracle.keys, BATCH * n_b, seed=args.seed + 40 + p_i,
            hotspot=hotspot,
        )
        for i in range(n_b):
            kk = wl.keys[i * BATCH : (i + 1) * BATCH]
            batches.append((False, wl.ops[i * BATCH : (i + 1) * BATCH], kk,
                            np.zeros(BATCH, np.int64)))
    report, per_path = {}, {}
    eng = engine.make_dex_engine(meta, cfg, device=dev)
    for mode in ("static", "controller"):
        ops.reset_launches()
        state = route_table.train_route_table(
            dex.init_state(pool, meta, cfg, bounds, device=dev), meta
        )
        ctl = repartition.RepartitionController(
            LogicalPartitions(bounds),
            n_memory=cfg.n_memory,
            cfg=repartition.RepartitionConfig(
                imbalance_threshold=1.2, min_ops=BATCH, cooldown_batches=0
            ),
        )
        shed_by_batch, times, installs = [], [], []
        for i, (_, opc, kk, vals) in enumerate(batches):
            state, results, t_ms, _ = run_batches(
                eng, state, [(False, opc, kk, vals)], "", dev, profile=False
            )
            times += t_ms
            _, s_, _ = oracle.check(f"repartition {mode} batch {i}", opc, kk, vals,
                                    results[0])
            shed_by_batch.append(s_)
            if mode == "controller":
                ctl.observe(state.stats, kk, demand=state.route_demand)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, rep_ = ctl.maybe_repartition(state, meta)
                torch.cuda.synchronize()
                if rep_ is not None:
                    installs.append(dict(
                        batch=i,
                        ms=(time.perf_counter() - t0) * 1e3,
                        boundary=int(rep_.new_boundaries[1]),
                        nodes_invalidated=rep_.nodes_invalidated,
                        imbalance=rep_.imbalance,
                        fraction_keyspace_moved=rep_.fraction_keyspace_moved,
                    ))
        stats = state.stats.sum(0).cpu().numpy()
        run = f"repartition/{mode}"
        report[run] = dict(
            shed_lanes=int(sum(shed_by_batch)),
            shed_by_batch=shed_by_batch,
            median_ms=float(np.median(times)),
            drops=int(stats[reg.STAT_DROPS]),
            rt_skips=int(stats[reg.STAT_RT_SKIPS]),
            installs=installs,
        )
        print(f"main repartition {mode}: {json.dumps(report[run])}")
        per_path[run] = dict(ops.LAUNCHES)
        check_launches(run, per_path[run], ("node_search",))
        del state
    static, ctl_run = report["repartition/static"], report["repartition/controller"]
    if not ctl_run["installs"] or ctl_run["shed_lanes"] >= static["shed_lanes"]:
        fail(
            f"repartition: the controller shed {ctl_run['shed_lanes']} lanes against"
            f" {static['shed_lanes']} static, with {len(ctl_run['installs'])} installs"
        )
    return report, per_path


def counted(acc, fn, *args):
    """``fn(*args)``, adding the kernel launches it made to ``acc``."""
    from repro_torch.kernels import ops

    before = dict(ops.LAUNCHES)
    out = fn(*args)
    for k, v in ops.LAUNCHES.items():
        acc[k] = acc.get(k, 0) + v - before[k]
    return out


def timed_call(times, fn, *args):
    """``fn(*args)`` between two synchronisations, its host ms appended to
    ``times`` (when ``times`` is a list)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    if times is not None:
        times.append((time.perf_counter() - t0) * 1e3)
    return out


def ms_summary(times):
    return dict(
        median_ms=float(np.median(times)),
        p25_ms=float(np.percentile(times, 25)),
        p75_ms=float(np.percentile(times, 75)),
    )


def results_equal(a, b, fields, mask=None):
    """Do two engine results agree on ``fields`` (on the lanes of ``mask``)?"""
    import torch

    for k in fields:
        x, y = getattr(a, k), getattr(b, k)
        if mask is not None:
            x, y = x[mask], y[mask]
        if not torch.equal(x, y):
            return False
    return True


def check_twice(oracle, where, batches, results_a, results_b, mc=0):
    """Hold two engines' results of the same batches to the oracle: ``a``
    from the contents before the batches, then ``b`` from the same point.
    Both must acknowledge the same writes.  Returns the lanes checked and
    shed of each."""
    saved = dict(oracle.written)
    tally = []
    for tag, results in (("a", results_a), ("b", results_b)):
        oracle.written = dict(saved)
        oracle._arrays = None
        checked = shed = 0
        for i, ((opc, kk, vals), r) in enumerate(zip(batches, results)):
            c, s_, _ = oracle.check(f"{where} {tag} batch {i}", opc, kk, vals, r, mc)
            checked, shed = checked + c, shed + s_
        tally.append((checked, shed))
    return tally


def phase_pipeline(args, keys, pool, meta, oracle, bounds, carried):
    """The pipelined engine at full size, against the synchronous one in
    turns over the same batches from the same contents: the synchronous
    engine writes the index, the pipeline a copy of its key and value planes
    (7.2 GB at 200M keys).  YCSB-A (``PIPE_RUNS``) under ``fetch`` and
    ``auto``: lookups, updates and statuses equal lane for lane, the pool,
    occupancy and version planes equal after the drain, every lane of both
    held to the oracle.  Then YCSB-E under ``fetch`` (``PIPE_E_RUN``): lanes
    equal where neither shed, the pipeline's extra sheds only stall-shed
    scans, its other scans held to the oracle, and the split inserts
    settled after the drain.  One step of each engine profiled.  Launches
    are the pipeline's alone."""
    import torch

    from repro_torch.core import dex, engine, smo, write
    from repro_torch.core.nodes import KEY_MAX
    from repro_torch.data import ycsb
    from repro_torch.kernels import ops
    from repro_torch.obs import registry as reg

    dev = keys.device
    report, per_path = {}, {}
    twin = pool._replace(
        pool_keys=pool.pool_keys.clone(), pool_values=pool.pool_values.clone()
    )
    succ, n_alloc = carried

    def run_arm(label, ops_, cfg, batches, mc=1, extra=None):
        """Both engines in turns; returns the two final states and the
        results, and fills ``report[label]``."""
        twin.pool_keys.copy_(pool.pool_keys)
        twin.pool_values.copy_(pool.pool_values)
        s_sync = dex.init_state(pool, meta, cfg, bounds, device=dev)
        s_pipe = dex.init_state(twin, meta, cfg, bounds, device=dev)
        if extra:
            s_sync, s_pipe = s_sync._replace(**extra), s_pipe._replace(**extra)
        sync = engine.make_dex_engine(meta, cfg, ops=ops_, max_count=mc, device=dev)
        pipe = engine.make_dex_engine(
            meta, cfg, ops=ops_, max_count=mc, pipeline=True, device=dev
        )
        ops.reset_launches()
        launches = dict.fromkeys(ops.LAUNCHES, 0)
        t_sync, t_pipe, r_sync, r_pipe = [], [], [], []
        pipe.start(s_pipe)
        n = len(batches)
        for i, (w, opc, kk, vals) in enumerate(batches):
            inputs = [torch.from_numpy(a).to(dev) for a in (opc, kk, vals)]
            if i == n - 1:
                # one more batch under the profiler: where the time goes
                med_s = float(np.median(t_sync))
                med_p = float(np.median(t_pipe))
                s_sync, r, idle_s = profile_batch(
                    f"pipeline {label} sync", sync, s_sync, med_s, *inputs
                )
                r_sync.append(r)
                _, r, idle_p = counted(
                    launches, profile_batch, f"pipeline {label} pipelined",
                    lambda st, *a: (None, pipe.push(*a)), None, med_p, *inputs,
                )
            else:
                s_sync, r = timed_call(None if w else t_sync, sync, s_sync, *inputs)
                r_sync.append(r)
                r = counted(launches, timed_call, None if w else t_pipe, pipe.push,
                            *inputs)
            if r is not None:
                r_pipe.append(r)
        r_pipe.append(counted(launches, timed_call, None, pipe.drain))
        s_pipe = pipe.state
        return s_sync, s_pipe, r_sync, r_pipe, t_sync, t_pipe, idle_s, idle_p, launches

    # YCSB-A under fetch and auto
    for p_i, (policy, warm, timed) in enumerate(PIPE_RUNS):
        n_b = warm + timed + 1
        wl = ycsb.generate("ycsb-a", oracle.keys, BATCH * n_b, seed=args.seed + 50 + p_i)
        batches = []
        for i in range(n_b):
            sl = slice(i * BATCH, (i + 1) * BATCH)
            stamp = ((900 + 32 * p_i + i) << 20) + np.arange(BATCH)
            batches.append((i < warm, wl.ops[sl], wl.keys[sl],
                            wl.keys[sl] ^ VALUE_XOR ^ stamp))
        cfg = mesh_config(policy, 65_536)
        torch.cuda.reset_peak_memory_stats()
        (s_sync, s_pipe, r_sync, r_pipe, t_sync, t_pipe, idle_s, idle_p,
         launches) = run_arm(f"ycsb-a {policy}", ("lookup", "update"), cfg, batches)
        for i, (a, b) in enumerate(zip(r_sync, r_pipe)):
            if not results_equal(a, b, ("found", "values", "status", "shed")):
                fail(f"pipeline ycsb-a {policy}: batch {i} differs from the synchronous engine")
        for name in ("pool_keys", "pool_values"):
            if not torch.equal(getattr(pool, name), getattr(twin, name)):
                fail(f"pipeline ycsb-a {policy}: {name} differs after the drain")
        for name in ("occupancy", "versions"):
            if not torch.equal(getattr(s_sync, name), getattr(s_pipe, name)):
                fail(f"pipeline ycsb-a {policy}: {name} differs after the drain")
        plain = [(opc, kk, vals) for _, opc, kk, vals in batches]
        (c_p, sh_p), (c_s, sh_s) = check_twice(
            oracle, f"pipeline ycsb-a {policy}", plain, r_pipe, r_sync
        )
        st_p = s_pipe.stats.sum(0).cpu().numpy()
        st_s = s_sync.stats.sum(0).cpu().numpy()
        if st_s[reg.STAT_PIPE_STALLS] != 0:
            fail(f"pipeline ycsb-a {policy}: the synchronous engine stalled")
        run = f"pipeline/ycsb-a/{policy}"
        report[run] = dict(
            pipelined=ms_summary(t_pipe),
            synchronous=ms_summary(t_sync),
            batches=timed,
            stalls=int(st_p[reg.STAT_PIPE_STALLS]),
            stalls_per_batch=float(st_p[reg.STAT_PIPE_STALLS]) / n_b,
            checked_lanes=[c_p, c_s],
            shed_lanes=[sh_p, sh_s],
            offloads=[int(st_p[reg.STAT_OFFLOADS]), int(st_s[reg.STAT_OFFLOADS])],
            writes=[int(st_p[reg.STAT_WRITES]), int(st_s[reg.STAT_WRITES])],
            idle_share=[idle_p, idle_s],
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        )
        print(f"main pipeline ycsb-a {policy} ([pipelined, synchronous]): "
              f"{json.dumps(report[run])}")
        per_path[run] = launches
        check_launches(run, launches, ("node_search", "subtree_walk", "leaf_write"))
        del s_sync, s_pipe, r_sync, r_pipe

    # YCSB-E under fetch: inserts and scans; the splits settle after the
    # drain, on the index
    warm, timed = PIPE_E_RUN
    n_b = warm + timed + 1
    wl = ycsb.generate("ycsb-e", oracle.keys, BATCH * n_b, seed=args.seed + 55,
                       scan_len=SCAN_MAX_COUNT, scan_len_dist="uniform")
    batches = []
    for i in range(n_b):
        opc, kk, vals = ycsb.engine_lanes(wl, i * BATCH, (i + 1) * BATCH)
        stamp = ((960 + i) << 20) + np.arange(BATCH)
        vals = np.where(opc == engine.OP_SCAN, vals, kk ^ VALUE_XOR ^ stamp)
        batches.append((i < warm, opc, kk, vals))
    cfg = mesh_config("fetch", 65_536)
    torch.cuda.reset_peak_memory_stats()
    (s_sync, s_pipe, r_sync, r_pipe, t_sync, t_pipe, idle_s, idle_p,
     launches) = run_arm("ycsb-e fetch", ("insert", "scan"), cfg, batches,
                         mc=SCAN_MAX_COUNT, extra=dict(succ=succ, n_alloc=n_alloc))
    fields = ("found", "values", "status", "shed", "scan_keys", "scan_values", "taken")
    stall_shed = 0
    for i, (a, b) in enumerate(zip(r_sync, r_pipe)):
        if (a.shed & ~b.shed).any():
            fail(f"pipeline ycsb-e: batch {i} lost a shed lane")
        extra = b.shed & ~a.shed
        opc = torch.from_numpy(batches[i][1]).to(dev)
        if (extra & (opc != engine.OP_SCAN)).any() or (b.taken[extra] != -1).any():
            fail(f"pipeline ycsb-e: batch {i} shed a lane that is not a stalled scan")
        stall_shed += int(extra.sum())
        if not results_equal(a, b, fields, ~b.shed):
            fail(f"pipeline ycsb-e: batch {i} differs from the synchronous engine")
    for name in ("pool_keys", "pool_values"):
        if not torch.equal(getattr(pool, name), getattr(twin, name)):
            fail(f"pipeline ycsb-e: {name} differs after the drain")
    if not torch.equal(s_sync.occupancy, s_pipe.occupancy):
        fail("pipeline ycsb-e: occupancy differs after the drain")
    del twin
    checked = shed = splits = 0
    for i, ((_, opc, kk, vals), r) in enumerate(zip(batches, r_pipe)):
        c, s_, sp = oracle.check(f"pipeline ycsb-e batch {i}", opc, kk, vals, r,
                                 SCAN_MAX_COUNT)
        checked, shed, splits = checked + c, shed + s_, splits + sp
    # the split inserts settle on the mesh now, in batch order
    smo_round = smo.make_dex_smo(meta, cfg, device=dev)
    smo_rounds, smo_ms = 0, []
    for (_, opc, kk, vals), r in zip(batches, r_sync):
        split = (r.status == write.STATUS_SPLIT).cpu().numpy()
        if split.any():
            t0 = time.perf_counter()
            s_sync, sst, nr_ = smo.run_smo(smo_round, s_sync, np.where(split, kk, KEY_MAX),
                                           vals)
            torch.cuda.synchronize()
            smo_ms.append((time.perf_counter() - t0) * 1e3)
            smo_rounds += nr_
            ok = sst == write.STATUS_OK
            oracle.apply(kk[ok], vals[ok])
    st_p = s_pipe.stats.sum(0).cpu().numpy()
    run = "pipeline/ycsb-e/fetch"
    report[run] = dict(
        pipelined=ms_summary(t_pipe),
        synchronous=ms_summary(t_sync),
        batches=timed,
        stalls=int(st_p[reg.STAT_PIPE_STALLS]),
        stalls_per_batch=float(st_p[reg.STAT_PIPE_STALLS]) / n_b,
        stall_shed_scans=stall_shed,
        checked_lanes=checked,
        shed_lanes=shed,
        split_lanes=splits,
        smo_rounds=smo_rounds,
        smo_ms=smo_ms,
        idle_share=[idle_p, idle_s],
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    print(f"main pipeline ycsb-e fetch ([pipelined, synchronous]): {json.dumps(report[run])}")
    per_path[run] = launches
    check_launches(run, launches, ("node_search", "leaf_scan", "leaf_write"))
    print(f"main: {len(oracle.written)} keys written")
    # the SMO rounds relinked the successor table
    return report, per_path, (s_sync.succ, n_alloc)


def phase_fleet_policy(args, keys, pool, meta, oracle, bounds):
    """The divergent fleet-cache policy at full size: YCSB-C under
    ``fetch`` through a uniform engine and through ``divergent_policy(cfg,
    peek_budget=FLEET_PEEK_BUDGET)``, both built for lookups and updates as
    the reference's fleet benchmark builds them, in turns over the same
    batches from equal cold caches (``FLEET_RUN``); every lane held to the
    oracle; equal collective counts.  Then every cached row of both arms is
    poisoned and every version bumped, and one more batch must still equal
    the oracle."""
    import torch

    from repro_torch.core import dex, engine, fleet_cache, mesh
    from repro_torch.data import ycsb
    from repro_torch.kernels import ops
    from repro_torch.obs import registry as reg

    dev = keys.device
    cfg = mesh_config("fetch", 65_536)
    policies = {
        "uniform": None,
        "divergent": fleet_cache.divergent_policy(cfg, peek_budget=FLEET_PEEK_BUDGET),
    }
    warm, timed = FLEET_RUN
    n_b = warm + timed + 1
    wl = ycsb.generate("read-only", oracle.keys, BATCH * n_b, seed=args.seed + 60)
    engines, states, times, counts, marks, results = {}, {}, {}, {}, {}, {}
    launches = {arm: dict.fromkeys(ops.LAUNCHES, 0) for arm in policies}
    for arm, pol in policies.items():
        engines[arm] = engine.make_dex_engine(
            meta, cfg, ops=("lookup", "update"), max_count=1, cache_policy=pol, device=dev
        )
        states[arm] = dex.init_state(pool, meta, cfg, bounds, device=dev)
        times[arm], results[arm] = [], []
    ops.reset_launches()
    batches = []
    for i in range(n_b):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        opc, kk = wl.ops[sl], wl.keys[sl]
        batches.append((opc, kk, np.zeros(BATCH, np.int64)))
        inputs = [torch.from_numpy(a).to(dev) for a in batches[-1]]
        if i == n_b - 1:
            # every cached row poisoned, every version bumped
            for arm in policies:
                st = states[arm]
                st.cache.values.fill_(-777_777)
                everything = torch.arange(meta.n_nodes, device=dev)
                states[arm] = st._replace(
                    versions=fleet_cache.invalidate_nodes(st.versions, everything)
                )
                marks[arm, "poison"] = states[arm].stats.sum(0).cpu().numpy()
        for arm in policies:
            if i == warm:
                marks[arm, "warm"] = states[arm].stats.sum(0).cpu().numpy()
            mesh.reset_counts()
            states[arm], r = counted(
                launches[arm], timed_call, times[arm] if warm <= i < n_b - 1 else None,
                engines[arm], states[arm], *inputs,
            )
            counts[arm] = mesh.collective_counts()
            results[arm].append(r)
            if i == n_b - 2:
                marks[arm, "timed"] = states[arm].stats.sum(0).cpu().numpy()
    if counts["uniform"] != counts["divergent"]:
        fail(f"fleet policy: collective counts differ: {counts}")
    report, per_path = {}, {}
    for arm in policies:
        checked = shed = 0
        for i, ((opc, kk, vals), r) in enumerate(zip(batches, results[arm])):
            c, s_, _ = oracle.check(f"fleet {arm} batch {i}", opc, kk, vals, r)
            checked, shed = checked + c, shed + s_
        st = marks[arm, "timed"] - marks[arm, "warm"]
        after = states[arm].stats.sum(0).cpu().numpy() - marks[arm, "poison"]
        hits, fetches = int(st[reg.STAT_HITS]), int(st[reg.STAT_FETCHES])
        ph, pm = int(st[reg.STAT_PEER_HITS]), int(st[reg.STAT_PEER_MISSES])
        run = f"fleet-policy/{arm}"
        report[run] = dict(
            **ms_summary(times[arm]),
            batches=timed,
            checked_lanes=checked,
            shed_lanes=shed,
            hits=hits,
            fetches=fetches,
            peer_hits=ph,
            peer_misses=pm,
            fleet_hit_rate=(hits + ph) / max(hits + ph + pm + fetches, 1),
            collective_counts=counts[arm],
            after_poison=dict(
                hits=int(after[reg.STAT_HITS]), fetches=int(after[reg.STAT_FETCHES]),
                peer_hits=int(after[reg.STAT_PEER_HITS]),
                peer_misses=int(after[reg.STAT_PEER_MISSES]),
            ),
        )
        print(f"main fleet-policy {arm}: {json.dumps(report[run])}")
        per_path[run] = launches[arm]
        need = ("node_search",) + (("subtree_walk",) if arm == "divergent" else ())
        check_launches(run, launches[arm], need)
    div = report["fleet-policy/divergent"]
    if div["peer_hits"] == 0 or div["after_poison"]["peer_misses"] == 0:
        fail(f"fleet policy: peer hits {div['peer_hits']}, misses after the poison"
             f" {div['after_poison']['peer_misses']}")
    del engines, states, results
    return report, per_path


def axes_config(policy, cache_sets, factor=4.0):
    """The 2x2x2 virtual mesh: route axes ``("data", "pod")`` of 2 x 2 (four
    route partitions) over 2 memory columns, the same 8 virtual devices as
    :func:`mesh_config`'s 2x4."""
    from repro_torch.core.dex import DexMeshConfig

    return DexMeshConfig(
        route_axes=("data", "pod"),
        route_shape=(2, 2),
        n_route=4,
        n_memory=2,
        cache_sets=cache_sets,
        cache_ways=4,
        policy=policy,
        route_capacity_factor=factor,
    )


def quarter_bounds(sorted_keys):
    """Route boundaries of four partitions of equal key count."""
    from repro_torch.core.nodes import KEY_MAX, KEY_MIN

    n = sorted_keys.size
    inner = [int(sorted_keys[n * i // 4]) for i in (1, 2, 3)]
    return np.array([KEY_MIN] + inner + [KEY_MAX], np.int64)


def program_counts(cfg, ops_, mc, bounds_of):
    """The collective counts of one batch of ``cfg``'s engine built for
    ``ops_``, run on the CPU on a 20k-key index (the counts are those of
    the program, not of the data; ``tests/test_torch_route_axes.py`` and
    ``tests/test_torch_engine.py`` hold the port's CPU counts to the
    reference's)."""
    from repro_torch.core import dex, engine, mesh
    from repro_torch.core import pool as pool_mod

    rng = np.random.default_rng(5)
    keys = np.sort(rng.choice(2**40, size=20_000, replace=False).astype(np.int64))
    pool, meta = pool_mod.build_pool(keys, keys, level_m=1, n_shards=4, device="cpu")
    state = dex.init_state(pool, meta, cfg, bounds_of(keys), device="cpu")
    eng = engine.make_dex_engine(meta, cfg, ops=ops_, max_count=mc, device="cpu")
    opc = rng.integers(0, 4, size=4096).astype(np.int32)
    kk = rng.choice(keys, size=4096)
    mesh.reset_counts()
    eng(state, opc, kk, np.where(opc == 3, 8, kk))
    return mesh.collective_counts()


def peak_rss_gib():
    """The host's peak resident set of this process in GiB: ``VmHWM`` of
    ``/proc/self/status``, or where that file has no such line,
    ``getrusage``'s ``ru_maxrss``, the same peak in KiB."""
    import resource

    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) / 2**20
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def phase_route_axes(args, keys, pool, meta, oracle, bounds, carried):
    """Two route axes at full size: the engine on a 2x2x2 virtual mesh
    (``axes_config``, four route partitions of equal key count) and the 2x4
    engine in turns over the same batches from the same contents, under
    ``auto``: YCSB-A (lookups and updates) and YCSB-E (inserts and scans)
    (``AXES_RUNS``).  The 2x2x2 engine writes a copy of the index's key and
    value planes, the 2x4 one the index; every lane of both is held to the
    oracle; each batch's collective counts equal the port's CPU program's
    (each route exchange counts two ``all_to_all``).  Launches are the
    2x2x2 engine's."""
    import torch

    from repro_torch.core import dex, engine, mesh
    from repro_torch.core.nodes import KEY_MAX, KEY_MIN
    from repro_torch.data import ycsb
    from repro_torch.kernels import ops

    dev = keys.device
    succ, n_alloc = carried
    bounds4 = quarter_bounds(oracle.keys)
    twin = pool._replace(
        pool_keys=pool.pool_keys.clone(), pool_values=pool.pool_values.clone()
    )
    report, per_path = {}, {}
    engine_ops = {"ycsb-a": ("lookup", "update"), "ycsb-e": ("insert", "scan")}
    need = {"ycsb-a": ("node_search", "subtree_walk", "leaf_write"),
            "ycsb-e": ("node_search", "leaf_scan", "leaf_write")}
    for w_i, (workload, warm, timed) in enumerate(AXES_RUNS):
        n_b = warm + timed
        ops_, mc = engine_ops[workload], SCAN_MAX_COUNT
        kw = {}
        if workload == "ycsb-e":
            kw = dict(scan_len=SCAN_MAX_COUNT, scan_len_dist="uniform")
        wl = ycsb.generate(workload, oracle.keys, BATCH * n_b, seed=args.seed + 70 + w_i,
                           **kw)
        batches = []
        for i in range(n_b):
            opc, kk, vals = ycsb.engine_lanes(wl, i * BATCH, (i + 1) * BATCH)
            stamp = ((1100 + 32 * w_i + i) << 20) + np.arange(BATCH)
            vals = np.where(opc == engine.OP_SCAN, vals, kk ^ VALUE_XOR ^ stamp)
            batches.append((opc, kk, vals))
        twin.pool_keys.copy_(pool.pool_keys)
        twin.pool_values.copy_(pool.pool_values)
        cfgs = {"2x2x2": axes_config("auto", 65_536), "2x4": mesh_config("auto", 65_536)}
        states = {
            "2x2x2": dex.init_state(twin, meta, cfgs["2x2x2"], bounds4, device=dev),
            "2x4": dex.init_state(pool, meta, cfgs["2x4"], bounds, device=dev),
        }
        states = {k: v._replace(succ=succ, n_alloc=n_alloc) for k, v in states.items()}
        engs = {k: engine.make_dex_engine(meta, c, ops=ops_, max_count=mc, device=dev)
                for k, c in cfgs.items()}
        want = {
            "2x2x2": program_counts(cfgs["2x2x2"], ops_, mc, quarter_bounds),
            "2x4": program_counts(
                cfgs["2x4"], ops_, mc,
                lambda k: np.array([KEY_MIN, int(k[k.size // 2]), KEY_MAX], np.int64),
            ),
        }
        if want["2x2x2"] != {
            "all_to_all": want["2x4"]["all_to_all"] + want["2x4"]["route_exchange"],
            "route_exchange": want["2x4"]["route_exchange"],
        }:
            fail(f"route axes {workload}: program counts {want}")
        ops.reset_launches()
        launches = dict.fromkeys(ops.LAUNCHES, 0)
        times = {k: [] for k in engs}
        results = {k: [] for k in engs}
        torch.cuda.reset_peak_memory_stats()
        for i, b in enumerate(batches):
            inputs = [torch.from_numpy(a).to(dev) for a in b]
            for k in ("2x2x2", "2x4"):
                mesh.reset_counts()
                call = (lambda *a: counted(launches, timed_call, *a)) if k == "2x2x2" \
                    else timed_call
                states[k], r = call(times[k] if i >= warm else None, engs[k], states[k],
                                    *inputs)
                got = mesh.collective_counts()
                if got != want[k]:
                    fail(f"route axes {workload} {k} batch {i}: counts {got}, want {want[k]}")
                results[k].append(r)
        (c_a, sh_a), (c_b, sh_b) = check_twice(
            oracle, f"route axes {workload}", batches, results["2x2x2"], results["2x4"], mc
        )
        med = {k: float(np.median(t)) for k, t in times.items()}
        run = f"route-axes/{workload}/auto"
        report[run] = dict(
            **{k: ms_summary(t) for k, t in times.items()},
            ratio_2x2x2_to_2x4=med["2x2x2"] / med["2x4"],
            batches=timed,
            checked_lanes=[c_a, c_b],
            shed_lanes=[sh_a, sh_b],
            collective_counts=want,
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        )
        print(f"main route-axes {workload} auto ([2x2x2, 2x4] where a list):"
              f" {json.dumps(report[run])}")
        per_path[run] = launches
        check_launches(run, launches, need[workload])
        del states, engs, results
    del twin
    torch.cuda.empty_cache()
    return report, per_path


def engine_retries(eng, state, dev, opc, kk, vv, max_retries, obs=None):
    """One engine batch with its shed lanes replayed up to ``max_retries``
    times, as the reference's ``benchmarks/common.py::engine_with_retries``
    replays them (a replay's other lanes are inactive); each dispatch a
    phase of ``obs``.  Returns the state and ``(found, values, status)``
    of the lanes that completed, and which did."""
    import torch

    from repro_torch.core.nodes import KEY_MAX
    from repro_torch.obs.timeline import obs_phase

    done = kk == KEY_MAX
    found = np.zeros(kk.shape, bool)
    vals = np.zeros(kk.shape, np.int64)
    status = np.zeros(kk.shape, np.int32)
    for i in range(max_retries):
        if done.all():
            break
        with obs_phase(obs, "engine" if i == 0 else f"retry/r{i}") as ph:
            planes = (np.where(done, 0, opc).astype(np.int32), np.where(done, KEY_MAX, kk),
                      np.where(done, 0, vv))
            state, r = eng(state, *(torch.from_numpy(a).to(dev) for a in planes))
            if ph is not None:
                ph.fence((state, r))
        sh = r.shed.cpu().numpy()
        ok = ~done & ~sh
        found[ok] = r.found.cpu().numpy()[ok]
        vals[ok] = r.values.cpu().numpy()[ok]
        status[ok] = r.status.cpu().numpy()[ok]
        done |= ok
    return state, (found, vals, status), done


def latency_gate(seed, dev):
    """The reference's cross-plane percentile gate
    (``benchmarks/fig19_latency_tails.py``'s gated YCSB-A arm) on the port:
    60,000 keys, a 2x4 engine warmed under ``fetch`` over one column's keys
    and measured under ``auto`` (cache 2,048 sets, EMA decay 0.5, every
    leaf admitted), shed lanes retried; the port's ``Simulator`` on the
    host runs the identical trace with the identical knobs.  p50 and p99 of
    lookups and updates must agree within one bucket (``LAT_BAND``), and
    the measured histogram must bin each served lane once.  Returns the
    report and the launches of the measured batches."""
    import torch

    from repro_torch.core import dex, engine, sim
    from repro_torch.core import pool as pool_mod
    from repro_torch.core.nodes import KEY_MAX, KEY_MIN
    from repro_torch.data import ycsb
    from repro_torch.kernels import ops
    from repro_torch.obs import drift, latency
    from repro_torch.obs import registry as reg

    n_keys, batch, n_warm, n_meas, retries = LAT_GATE
    dataset = ycsb.make_dataset(n_keys, seed=seed)
    pool, meta = pool_mod.build_pool(dataset, dataset * 7, level_m=1, fill=0.7,
                                     n_shards=4, device=dev)
    bounds = np.array([KEY_MIN, int(dataset[dataset.size // 2]), KEY_MAX], np.int64)
    kw = dict(n_route=2, n_memory=4, cache_sets=2048, cache_ways=4, ema_decay=0.5,
              p_admit_leaf_pct=100, route_capacity_factor=4.0)
    cfg_auto = dex.DexMeshConfig(policy="auto", **kw)
    cfg_fetch = dex.DexMeshConfig(policy="fetch", **kw)
    state = dex.init_state(pool, meta, cfg_auto, bounds, device=dev)
    ops_ = ("lookup", "update")
    eng_fetch = engine.make_dex_engine(meta, cfg_fetch, ops=ops_, max_count=1, device=dev)
    eng_auto = engine.make_dex_engine(meta, cfg_auto, ops=ops_, max_count=1, device=dev)
    wl = ycsb.generate("ycsb-a", dataset, n_meas * batch, theta=0.99, seed=11,
                       hotspot=0.1)
    # the warm sweep over the hot column's keys
    s_per = meta.n_subtrees_padded // cfg_auto.n_memory
    hot_n = min(dataset.size, -(-dataset.size * s_per // max(meta.n_subtrees, 1)))
    rng_w = np.random.default_rng(23)
    warm_keys = np.concatenate([
        rng_w.permutation(dataset[(np.arange(batch) * hot_n // batch + 17 * b) % hot_n])
        for b in range(n_warm)
    ]).astype(np.int64)
    all_ops = np.concatenate([np.zeros(warm_keys.shape, np.int32), wl.ops])
    all_keys = np.concatenate([warm_keys, wl.keys])
    trace = ycsb.Workload(ops=all_ops, keys=all_keys, idx=np.full(all_ops.shape, -1))
    ops.reset_launches()
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    for b in range(n_warm + n_meas):
        if b == n_warm:
            torch.cuda.synchronize()
            stats0 = state.stats.sum(0).cpu().numpy()
            hist0 = state.lat_hist.sum(0).cpu().numpy()
        opc, kk, vv = ycsb.engine_lanes(trace, b * batch, (b + 1) * batch)
        eng = eng_fetch if b < n_warm else eng_auto
        if b < n_warm:
            state, *_ = engine_retries(eng, state, dev, opc, kk, vv, retries)
        else:
            state, *_ = counted(launches, engine_retries, eng, state, dev, opc, kk, vv,
                                retries)
    stats = state.stats.sum(0).cpu().numpy() - stats0
    hist = state.lat_hist.sum(0).cpu().numpy() - hist0
    served = int(stats[reg.STAT_OPS])
    if int(hist.sum()) != served:
        fail(f"latency gate: {int(hist.sum())} lanes binned, {served} served")
    tree = sim.HostBTree(dataset, dataset * 7, fill=0.7, level_m=1,
                         n_mem_servers=cfg_auto.n_memory, placement="blocked",
                         subtrees_per_server=s_per)
    sim_cfg = sim.SimConfig(
        name="dex-engine", n_compute=cfg_auto.n_devices, n_mem_servers=cfg_auto.n_memory,
        level_m=1, write_through=True, offloading=True, group_offload=True,
        group_ema_decay=cfg_auto.ema_decay, coherence_batch=batch,
        route_dispersion=cfg_auto.n_memory, p_admit_leaf=cfg_auto.p_admit_leaf_pct / 100.0,
        cache_bytes=cfg_auto.cache_sets * cfg_auto.cache_ways * 1024,
        offload_c=cfg_auto.offload_c,
    )
    simulator = sim.Simulator(tree, sim_cfg, seed=3)
    warm, meas = slice(0, n_warm * batch), slice(n_warm * batch, None)
    t0 = time.perf_counter()
    simulator.run(all_ops[warm], all_keys[warm], group_policy="fetch")
    simulator.reset_counters()
    simulator.run(all_ops[meas], all_keys[meas])
    sim_s = time.perf_counter() - t0
    sim_hist = simulator.lat_hist.copy()
    if int(sim_hist.sum()) != int(simulator.totals().ops):
        fail("latency gate: the simulator's histogram misses ops")
    classes = ("lookup", "update")
    mesh_g = latency.percentile_gauges(hist, classes=classes)
    sim_g = latency.percentile_gauges(sim_hist, classes=classes)
    if set(mesh_g) != set(sim_g) or len(mesh_g) != 4:
        fail(f"latency gate: gauges {sorted(mesh_g)} against {sorted(sim_g)}")
    tol = {k: drift.ratio(*LAT_BAND) for k in mesh_g}
    rep = drift.compare(mesh_g, sim_g, tol, label="mesh (card) against simulator (host)")
    print(f"telemetry drift: {rep.format()}")
    if not rep.ok:
        fail(f"latency gate: percentiles out of band: {rep.format()}")
    audit = latency.audit_report(*state.lat_audit.sum(0).double().cpu().numpy())
    return dict(
        keys=n_keys, batch=batch, warm_batches=n_warm, measured_batches=n_meas,
        served=served, mesh=mesh_g, sim=sim_g,
        ratios={e.name: e.measured for e in rep.entries},
        mispricing_ratio=audit["mispricing_ratio"], sim_s=sim_s,
    ), launches


def phase_telemetry(args, keys, pool, meta, oracle, bounds, carried):
    """The telemetry plane at full size: YCSB-A under ``auto`` on the 2x4
    engine, each batch wrapped by ``BatchTimeline.instrument``, in turns with
    a bare engine over the same batches (the bare one on a copy of the key
    and value planes); the latency ledger primed after the warm-up batch and
    captured at the end; a Chrome trace written to ``TRACE_PATH``.  Gates:
    the instrumented run's lanes, stats, histogram and collective counts
    equal the bare run's; the captured histogram's total equals the
    ``STAT_OPS`` delta; no collective is counted under ``dex/lat``; every
    lane held to the oracle.  Then :func:`latency_gate`."""
    import torch

    from repro_torch.core import dex, engine, mesh
    from repro_torch.data import ycsb
    from repro_torch.kernels import ops
    from repro_torch.obs import latency, trace
    from repro_torch.obs import registry as reg
    from repro_torch.obs.timeline import BatchTimeline

    dev = keys.device
    warm, timed = TELEMETRY_RUN
    n_b = warm + timed
    wl = ycsb.generate("ycsb-a", oracle.keys, BATCH * n_b, seed=args.seed + 80)
    batches = []
    for i in range(n_b):
        opc, kk, _ = ycsb.engine_lanes(wl, i * BATCH, (i + 1) * BATCH)
        batches.append((opc, kk, kk ^ VALUE_XOR ^ (((1200 + i) << 20) + np.arange(BATCH))))
    cfg = mesh_config("auto", 65_536)
    twin = pool._replace(
        pool_keys=pool.pool_keys.clone(), pool_values=pool.pool_values.clone()
    )
    s_bare = dex.init_state(twin, meta, cfg, bounds, device=dev)
    s_inst = dex.init_state(pool, meta, cfg, bounds, device=dev)
    eng = engine.make_dex_engine(meta, cfg, ops=("lookup", "update"), device=dev)
    tl = BatchTimeline("chip_smoke telemetry ycsb-a",
                       meta={"mesh": "2x4", "keys": int(oracle.keys.size), "batch": BATCH})
    inst = tl.instrument(eng, label="ycsb-a")
    ops.reset_launches()
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    times = {"instrumented": [], "bare": []}
    r_bare, r_inst = [], []
    for i, b in enumerate(batches):
        inputs = [torch.from_numpy(a).to(dev) for a in b]
        mesh.reset_counts()
        s_bare, r = timed_call(times["bare"] if i >= warm else None, eng, s_bare, *inputs)
        c_bare = mesh.collective_counts(by_phase=True)
        r_bare.append(r)
        mesh.reset_counts()
        s_inst, r = counted(launches, timed_call, times["instrumented"] if i >= warm
                            else None, inst, s_inst, *inputs)
        c_inst = mesh.collective_counts(by_phase=True)
        r_inst.append(r)
        if c_inst != c_bare or "dex/lat" in c_inst["phases"]:
            fail(f"telemetry batch {i}: counts {c_inst} against bare {c_bare}")
        if not results_equal(r_inst[-1], r_bare[-1], ("found", "values", "status", "shed")):
            fail(f"telemetry batch {i}: the instrumented lanes differ from the bare run's")
        if i == warm - 1:
            tl.prime(s_inst)
            tl.prime_latency(s_inst)
            ops0 = int(s_inst.stats[:, reg.STAT_OPS].sum())
    hist = tl.capture_latency(s_inst)
    served = int(s_inst.stats[:, reg.STAT_OPS].sum()) - ops0
    if int(hist.sum()) != served:
        fail(f"telemetry: {int(hist.sum())} lanes binned, {served} served")
    for name in ("stats", "lat_hist", "lat_audit", "miss_ema", "versions", "occupancy"):
        if not torch.equal(getattr(s_inst, name), getattr(s_bare, name)):
            fail(f"telemetry: {name} differs from the bare run's")
    for name in ("pool_keys", "pool_values"):
        if not torch.equal(getattr(pool, name), getattr(twin, name)):
            fail(f"telemetry: {name} differs from the bare run's")
    del twin, s_bare
    (c_b, sh_b), (c_i, sh_i) = check_twice(oracle, "telemetry", batches, r_bare, r_inst)
    path = trace.write_trace(tl, str(ROOT / TRACE_PATH))
    summary = tl.summary()
    print(f"telemetry latency_section: {json.dumps(summary['latency'])}")
    print(f"telemetry cost_audit: {json.dumps(summary['cost_audit'])}")
    per_path = {"telemetry/ycsb-a/auto": launches}
    check_launches("telemetry/ycsb-a/auto", launches,
                   ("node_search", "subtree_walk", "leaf_write"))
    t0 = time.perf_counter()
    gate, gate_launches = latency_gate(args.seed, dev)
    gate["seconds"] = time.perf_counter() - t0
    per_path["telemetry/latency-gate"] = gate_launches
    check_launches("telemetry/latency-gate", gate_launches, ("node_search", "subtree_walk"))
    report = {"telemetry/ycsb-a/auto": dict(
        **{k: ms_summary(t) for k, t in times.items()},
        instrumentation_cost=float(np.median(times["instrumented"]))
        / float(np.median(times["bare"])) - 1,
        batches=timed,
        checked_lanes=[c_b, c_i],
        shed_lanes=[sh_b, sh_i],
        binned_lanes=int(hist.sum()),
        percentiles=latency.class_percentiles(hist),
        phases=summary["phases"],
        trace=str(pathlib.Path(path).relative_to(ROOT)),
        trace_events=len(trace.to_trace_events(tl)["traceEvents"]),
    ), "telemetry/latency-gate": gate}
    print(f"main telemetry ycsb-a auto: {json.dumps(report['telemetry/ycsb-a/auto'])}")
    print(f"main telemetry latency gate: {json.dumps(gate)}")
    return report, per_path


def host_contents(oracle):
    """The index's contents as the oracle holds them: sorted keys (the bulk
    load and every acknowledged insert) and their values."""
    keys = oracle.keys
    wk, wv = oracle.written_arrays()
    pos = np.minimum(np.searchsorted(keys, wk), keys.size - 1)
    fresh = wk[keys[pos] != wk]
    if fresh.size:
        keys = np.insert(keys, np.searchsorted(keys, fresh), fresh)
    vals = keys ^ VALUE_XOR
    vals[np.searchsorted(keys, wk)] = wv
    return keys, vals


def phase_drain(args, keys, pool, meta, oracle, bounds, carried):
    """The SMO's host fallback at full size, last on the index (the drain
    rebuilds the pool and releases the old one).  A ``HostBTree`` mirror of
    the index's contents, built on the host (seconds and the host's peak
    RSS); then YCSB's load phase with ``insertorder=ordered``: one batch of
    ``BATCH`` fresh keys above the largest key, every one into the rightmost
    leaf, through the insert engine under ``fetch``; the acknowledged lanes
    go into the mirror, the ``STATUS_SPLIT`` lanes through
    ``smo.settle_splits``, whose drain must fire.  Then the ops are rebuilt
    against the new meta: every inserted key must read back its value, and
    a YCSB-C batch must equal the mirror; ``STAT_DRAINS`` is 1 and the other
    stats carried over.  Times of the insert batch, the SMO rounds, the host
    replay, ``host_items``, ``build_pool``, ``init_state`` and the ops'
    rebuild; the card's peak memory."""
    import torch

    from repro_torch.core import dex, engine, sim, smo, write
    from repro_torch.core.nodes import KEY_MAX
    from repro_torch.data import ycsb
    from repro_torch.kernels import ops
    from repro_torch.obs import registry as reg
    from repro_torch.obs.timeline import BatchTimeline

    dev = keys.device
    succ, n_alloc = carried
    t0 = time.perf_counter()
    all_k, all_v = host_contents(oracle)
    mirror = sim.HostBTree(all_k, all_v, fill=0.7)
    build_s = time.perf_counter() - t0
    rss_build = peak_rss_gib()
    print(f"drain: HostBTree mirror of {all_k.size} keys ({mirror.num_nodes} nodes,"
          f" capacity {mirror.K.shape[0]}) built in {build_s:.1f} s, host peak RSS"
          f" {rss_build:.2f} GiB")
    cfg = mesh_config("fetch", 65_536)
    state = dex.init_state(pool, meta, cfg, bounds, device=dev)
    state = state._replace(succ=succ, n_alloc=n_alloc)
    insert = engine.make_dex_engine(meta, cfg, ops=("insert",), device=dev)
    fresh = int(all_k[-1]) + 1 + np.arange(BATCH, dtype=np.int64)
    vals = fresh ^ VALUE_XOR ^ (77 << 50)
    ops.reset_launches()
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    torch.cuda.reset_peak_memory_stats()
    ins_ms = []
    inputs = [torch.from_numpy(a).to(dev) for a in
              (np.full(BATCH, engine.OP_INSERT, np.int32), fresh, vals)]
    state, r = counted(launches, timed_call, ins_ms, insert, state, *inputs)
    status = r.status.cpu().numpy()
    if r.shed.any():
        fail("drain: the ordered insert batch shed lanes")
    acked = status == write.STATUS_OK
    for k, v in zip(fresh[acked].tolist(), vals[acked].tolist()):
        mirror.insert(k, v)
    split = status == write.STATUS_SPLIT
    # time the drain's parts: each call wrapped, the mirror's replay is the
    # rest of the drain
    parts = {}

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            parts[name] = parts.get(name, 0.0) + (time.perf_counter() - t) * 1e3
            return out
        return run

    before = {}

    def drain_splits(st, *a):
        before["stats"] = st.stats.clone()
        return real_drain(st, *a)

    real_drain = smo.drain_splits
    saved = (write.host_items, write.build_pool, write.init_state, smo.drain_splits)
    write.host_items = timed("host_items", write.host_items)
    write.build_pool = timed("build_pool", write.build_pool)
    write.init_state = timed("init_state", write.init_state)
    smo.drain_splits = timed("drain", drain_splits)
    tl = BatchTimeline("chip_smoke drain")
    smo_round = smo.make_dex_smo(meta, cfg, device=dev)
    try:
        with tl.batch("settle") as b:
            state, new_meta, info = counted(
                launches,
                lambda *a: smo.settle_splits(*a, obs=b),
                state, meta, cfg, smo_round, mirror,
                np.where(split, fresh, KEY_MAX), np.where(split, vals, 0), bounds,
            )
    finally:
        write.host_items, write.build_pool, write.init_state, smo.drain_splits = saved
    del pool, smo_round, insert
    phases = tl.batches[0].phase_seconds()
    if not info["drained"] or new_meta is meta:
        fail(f"drain: the fallback did not fire: {info}")
    if info["onmesh"] + info["residual"] + int(acked.sum()) != BATCH:
        fail(f"drain: lanes unaccounted for: {info}, {int(acked.sum())} acknowledged")
    stats = state.stats.cpu().numpy()
    want = before["stats"].cpu().numpy()
    want[0, reg.STAT_DRAINS] += 1
    if not np.array_equal(stats, want) or stats[:, reg.STAT_DRAINS].sum() != 1:
        fail("drain: the stats did not carry over with one drain counted")
    t = time.perf_counter()
    look = engine.make_dex_engine(new_meta, cfg, ops=("lookup",), device=dev)
    rebuild_ms = (time.perf_counter() - t) * 1e3
    oracle.apply(fresh, vals)
    zeros = np.zeros(BATCH, np.int32)
    state, r = counted(launches, timed_call, None, look, state, torch.from_numpy(zeros).to(dev),
                       torch.from_numpy(fresh).to(dev),
                       torch.from_numpy(np.zeros(BATCH, np.int64)).to(dev))
    if r.shed.any() or not r.found.all() or not np.array_equal(r.values.cpu().numpy(), vals):
        fail("drain: an inserted key did not read back its value")
    wl = ycsb.generate("read-only", all_k, BATCH, seed=args.seed + 90)
    q = wl.keys
    state, r = counted(launches, timed_call, None, look, state, torch.from_numpy(zeros).to(dev),
                       torch.from_numpy(q).to(dev),
                       torch.from_numpy(np.zeros(BATCH, np.int64)).to(dev))
    got = [mirror.get(k) for k in q.tolist()]
    found, values, shed = (t_.cpu().numpy() for t_ in (r.found, r.values, r.shed))
    ok = ~shed
    if not (found[ok] == np.array([g is not None for g in got])[ok]).all() or not all(
        v == g for v, g, o in zip(values.tolist(), got, ok) if o and g is not None
    ):
        fail("drain: the YCSB-C batch differs from the mirror")
    checked, n_shed, _ = oracle.check("drain ycsb-c", zeros, q, np.zeros(BATCH, np.int64), r)
    run = "drain/ordered-insert"
    report = {run: dict(
        mirror_keys=int(all_k.size),
        mirror_build_s=build_s,
        host_peak_rss_gib=peak_rss_gib(),
        host_peak_rss_after_build_gib=rss_build,
        insert_ms=ins_ms[0],
        acknowledged=int(acked.sum()),
        info=info,
        smo_rounds_ms=sum(v for k, v in phases.items() if k.startswith("smo/round")) * 1e3,
        drain_ms=parts["drain"],
        host_replay_ms=parts["drain"] - sum(parts[k] for k in ("host_items", "build_pool",
                                                                "init_state")),
        host_items_ms=parts["host_items"],
        build_pool_ms=parts["build_pool"],
        init_state_ms=parts["init_state"],
        ops_rebuild_ms=rebuild_ms,
        new_subtrees=new_meta.n_subtrees,
        checked_lanes=checked,
        shed_lanes=n_shed,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
    )}
    print(f"main drain: {json.dumps(report[run])}")
    check_launches(run, launches, ("node_search", "leaf_write", "leaf_split"))
    return report, {run: launches}


# ---------------------------------------------------------------------------
# the index mesh over ranks (core/mesh.py's rank backend)
# ---------------------------------------------------------------------------

#: the phase's world: the 2x4 mesh's 8 devices over 4 ranks, 2 a rank
RANK_WORLD = 4
#: (workload, batches, the engine's ops) run in order on one state; one
#: batch each keeps the phase short (every world's ranks take about 10 s
#: to start and a gloo batch 0.5-2.3 s)
RANK_RUNS = (
    ("read-only", 1, ("lookup",)),
    ("ycsb-a", 1, ("lookup", "update")),
    ("ycsb-e", 1, ("insert", "scan")),
)
#: the pipelined YCSB-A step's pushes (then the drain)
RANK_PIPE_PUSHES = 3
#: the YCSB-C batches under ``fetch`` and the divergent policy
RANK_DIV_BATCHES = 2
#: the kernels every rank of a 2x4 world must launch
RANK_KERNELS = ("node_search", "subtree_walk", "leaf_write", "leaf_scan", "leaf_split")
#: the kernels every rank of the 2x2x2 world's YCSB-A batch must launch
RANK_AXES_KERNELS = ("node_search", "subtree_walk", "leaf_write")
RANK_RESULTS = ("found", "values", "status", "shed", "scan_keys", "scan_values", "taken")


def rank_lanes_of(workload, n, host_keys, seed, batch, w_i):
    """``n`` batches of ``workload`` over ``host_keys``, ``(opcodes, keys,
    values)`` each ``[n, batch]``, each write a value no earlier write of
    the key has had (``w_i`` numbers the run)."""
    from repro_torch.core import engine
    from repro_torch.data import ycsb

    kw = dict(scan_len=SCAN_MAX_COUNT, scan_len_dist="uniform") if workload == "ycsb-e" else {}
    wl = ycsb.generate(workload, host_keys, batch * n, seed=seed + 41 + w_i, **kw)
    out = []
    for i in range(n):
        opc, kk, vals = ycsb.engine_lanes(wl, i * batch, (i + 1) * batch)
        stamp = (((w_i + 1) << 8) + i << 20) + np.arange(batch)
        vals = np.where(opc == engine.OP_SCAN, vals, kk ^ VALUE_XOR ^ stamp)
        out.append((opc, kk, vals))
    return tuple(np.stack(planes) for planes in zip(*out))


def rank_batches(host_keys, seed, batch):
    """``[(step, opcodes, keys, values)]``: the batches of ``RANK_RUNS``
    (YCSB-C, A and E, scans of uniform length 1-100), one step each, then
    ``"ycsb-a-pipe"`` (``RANK_PIPE_PUSHES`` YCSB-A batches through the
    pipeline) and ``"ycsb-c-divergent"`` (``RANK_DIV_BATCHES`` YCSB-C
    batches under the divergent policy), their planes ``[n, batch]``."""
    out = []
    for w_i, (workload, n, _) in enumerate(RANK_RUNS):
        opc, kk, vals = rank_lanes_of(workload, n, host_keys, seed, batch, w_i)
        out += [(workload, opc[i], kk[i], vals[i]) for i in range(n)]
    return out + [
        ("ycsb-a-pipe", *rank_lanes_of("ycsb-a", RANK_PIPE_PUSHES, host_keys, seed, batch, 3)),
        ("ycsb-c-divergent",
         *rank_lanes_of("read-only", RANK_DIV_BATCHES, host_keys, seed, batch, 4)),
    ]


def rank_burst(rng, pool, meta, n_leaves):
    """A split burst: ``SMO_KEYS_PER_LEAF`` fresh keys into each of
    ``n_leaves`` leaves, one in each of as many subtrees other than the
    last; ``(keys, values)`` in a random lane order."""
    import torch

    dev = pool.pool_keys.device
    subtrees = rng.choice(meta.n_subtrees - 1, size=n_leaves, replace=False)
    local = meta.leaf_start + rng.integers(0, meta.leaves_per_subtree, n_leaves)
    rows = pool.pool_keys[
        torch.from_numpy(subtrees).to(dev), torch.from_numpy(local).to(dev)
    ].cpu().numpy()
    kk = rng.permutation(
        np.concatenate([fresh_in_leaf(rng, r, SMO_KEYS_PER_LEAF) for r in rows])
    )
    return kk, kk ^ VALUE_XOR ^ (3 << 50)


def rank_spec(host_keys, seed, batch, burst):
    """The phase's steps on the 2x4 mesh, ``[(name, opcodes, keys,
    values)]``: :func:`rank_batches`, then the split burst
    (``"split-burst"``: its keys and values, inserted and settled by SMO
    rounds), then a ``"read-back"`` lookup batch of the burst's keys."""
    from repro_torch.core import engine

    kk, vv = burst
    zero = np.zeros(kk.shape, np.int64)
    return rank_batches(host_keys, seed, batch) + [
        ("split-burst", None, kk, vv),
        ("read-back", np.full(kk.shape, engine.OP_LOOKUP, np.int32), kk, zero),
    ]


def rank_engine(name, meta, cfg, dev):
    """The engine of a step of :func:`rank_spec`: its workload's (the
    read-back: the lookup engine's), the YCSB-A pipeline, or the lookup
    engine under ``fetch`` and ``divergent_policy(peek_budget=
    FLEET_PEEK_BUDGET)``."""
    import dataclasses

    from repro_torch.core import engine, fleet_cache

    if name == "ycsb-a-pipe":
        return engine.make_dex_engine(meta, cfg, ops=("lookup", "update"), max_count=1,
                                      pipeline=True, device=dev)
    if name == "ycsb-c-divergent":
        fcfg = dataclasses.replace(cfg, policy="fetch")
        policy = fleet_cache.divergent_policy(fcfg, peek_budget=FLEET_PEEK_BUDGET)
        return engine.make_dex_engine(meta, fcfg, ops=("lookup",), max_count=1,
                                      cache_policy=policy, device=dev)
    ops_ = dict((w, o) for w, _, o in RANK_RUNS)["read-only" if name == "read-back" else name]
    return engine.make_dex_engine(meta, cfg, ops=ops_, max_count=SCAN_MAX_COUNT, device=dev)


def run_rank_steps(meta, cfg, state, spec, lanes, dev):
    """The steps of ``spec`` (:func:`rank_spec`'s layout) on this process's
    share of the mesh: each batch through its engine, a pipelined step's
    batches pushed in order and drained, the divergent step's batches one
    after another, the split burst through the insert engine and
    ``run_smo``.  ``lanes`` cuts a batch to this process's lanes.  Returns
    ``(state, steps)``: each step's results (an ``EngineResult``; a list of
    them for a step of several batches; for the burst the insert's and the
    rounds' statuses), its collective counts (by phase), the fleet's
    counters after it (``registry.snapshot``, over every rank on ranks) and
    its ms (host clock around a synchronised step)."""
    import torch

    from repro_torch.core import mesh, smo, write
    from repro_torch.core.nodes import KEY_MAX
    from repro_torch.obs import registry

    engines = {}
    insert = write.make_dex_insert(meta, cfg, device=dev)
    smo_round = smo.make_dex_smo(meta, cfg, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def batch(*planes):
        return [torch.from_numpy(lanes(a)).to(dev) for a in planes]

    steps = []
    for name, opc, kk, vals in spec:
        step = dict(name=name)
        if name != "split-burst" and name not in engines:
            engines[name] = rank_engine(name, meta, cfg, dev)
        mesh.reset_counts()
        sync()
        t0 = time.perf_counter()
        if name == "split-burst":
            kk, vals = lanes(kk), lanes(vals)
            state, st = insert(state, kk, vals)
            split = (st == write.STATUS_SPLIT).cpu().numpy()
            state, sst, step["rounds"] = smo.run_smo(
                smo_round, state, np.where(split, kk, KEY_MAX), vals
            )
            r = (st, torch.from_numpy(sst).to(dev))
        elif name == "ycsb-a-pipe":
            pipe = engines[name].start(state)
            r = [pipe.push(*batch(opc[j], kk[j], vals[j])) for j in range(len(kk))][1:]
            r.append(pipe.drain())
            state = pipe.state
        elif name == "ycsb-c-divergent":
            r = []
            for j in range(len(kk)):
                state, rj = engines[name](state, *batch(opc[j], kk[j], vals[j]))
                r.append(rj)
        else:
            state, r = engines[name](state, *batch(opc, kk, vals))
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        step.update(result=r, counts=mesh.collective_counts(by_phase=True), ms=ms)
        snap = registry.snapshot(state)
        step["snapshot"] = dict(fleet=snap.fleet, per_device=snap.per_device)
        steps.append(step)
    return state, steps


def rank_fields(step):
    """``[(field, tensor)]``: a step's lanes, each batch's of a step of
    several."""
    r = step["result"]
    if step["name"] == "split-burst":
        return list(zip(("insert_status", "smo_status"), r))
    rs = r if isinstance(r, list) else [r]
    return [(f"{j}.{f}", getattr(x, f)) for j, x in enumerate(rs) for f in RANK_RESULTS
            if getattr(x, f) is not None]


def state_planes(state):
    """Every plane of a ``DexState`` by field path."""
    out = {}
    for name, value in state._asdict().items():
        if isinstance(value, tuple):
            out.update({f"{name}.{k}": t for k, t in value._asdict().items()})
        else:
            out[name] = value
    return out


def ranks_worker(rm, pool, meta, cfg, bounds, spec, virt_steps, virt_state):
    """One rank of the ``ranks`` phase: its share of the state from the
    parent's pool (shared through CUDA IPC; the rank copies its own share,
    ``dex.shard_pool``), the steps on its lanes, its lanes, collective
    counts and fleet snapshots held to the virtual mesh's, bit for bit, and
    at the end its every plane to the same rows of the virtual mesh's
    planes (``dex.shard_state``: views, no copy).  Returns what the parent
    prints and checks."""
    import torch

    from repro_torch.core import dex, mesh
    from repro_torch.core.pool import SubtreePool
    from repro_torch.kernels import ops

    spec = [(n, None if o is None else o.numpy(), k.numpy(), v.numpy()) for n, o, k, v in spec]
    torch.set_num_threads(2)
    cuda = torch.cuda.is_available()
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    c0, n_cols = mesh.local_columns(cfg)
    shard = SubtreePool(*(t.to(dev, copy=True) for t in dex.shard_pool(pool, cfg, rm)))
    state = dex.init_state(shard, meta, cfg, bounds, device=dev, mesh=rm)
    del shard
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in state_planes(state).values()}
    state_bytes = sum(storages.values())
    pool_bytes = sum(t.numel() * t.element_size() for t in state.pool[2:])

    def lanes(a):
        w = len(a) // rm.world
        return a[rm.rank * w : (rm.rank + 1) * w]

    ops.reset_launches()
    t0 = time.perf_counter()
    state, steps = run_rank_steps(meta, cfg, state, spec, lanes, dev)
    run_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    differ = []
    for mine, want in zip(steps, virt_steps):
        for (f, a), (_, b) in zip(rank_fields(mine), rank_fields(want)):
            if not torch.equal(a, lanes(b).to(dev)):
                differ.append(f"{mine['name']} {f}")
        if mine["counts"] != want["counts"]:
            differ.append(f"{mine['name']} counts {mine['counts']} != {want['counts']}")
        ms, ws = mine["snapshot"], want["snapshot"]
        bad = [k for k, v in ms["per_device"].items()
               if not np.array_equal(v, ws["per_device"][k]) or ms["fleet"][k] != ws["fleet"][k]]
        if bad:
            differ.append(f"{mine['name']} snapshot {bad} {[ms['fleet'][k] for k in bad]} "
                          f"!= {[ws['fleet'][k] for k in bad]}")
    # every plane against the same rows of the virtual mesh's: the shards of
    # all ranks cover every plane, each column's replicas included
    want = state_planes(dex.shard_state(virt_state, cfg, rm))
    mine = state_planes(state)
    for k, t in mine.items():
        if not torch.equal(t, want[k].to(dev)):
            differ.append(f"plane {k}")
    names = [s["name"] for s in steps]
    return dict(
        rank=rm.rank, backend=rm.backend,
        card=torch.cuda.get_device_name(dev) if cuda else "cpu",
        card_index=dev.index,
        peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None,
        pool_bytes=pool_bytes, state_bytes=state_bytes,
        columns=[c0, n_cols], devices=list(rm.block(cfg)),
        ms=[round(s["ms"], 3) for s in steps], names=names,
        counts=[s["counts"] for s in steps], run_s=run_s, launches=launches,
        rounds=steps[names.index("split-burst")]["rounds"] if "split-burst" in names else None,
        differ=differ, planes=len(mine),
    )


def run_rank_world(backend, p, tag, pool, meta, cfg, bounds, spec, vsteps, vstate, need,
                   n_cards):
    """One world of ``phase_ranks``: ``p`` ranks over ``backend`` run
    ``spec`` from the shared ``pool``; every rank must equal the virtual
    mesh's ``vsteps`` and ``vstate`` and launch each kernel of ``need``.
    Returns ``(report, launches summed over the ranks)``."""
    import shutil
    import tempfile

    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import spawn_ranks

    cuda = torch.cuda.is_available()
    how = ("one rank a card" if backend == "nccl" and p > 1 else
           "all 8 virtual devices on one rank" if p == 1 else
           f"{p} ranks on {max(n_cards, 1)} card(s), CUDA tensors staged "
           "through pinned host memory" if cuda else f"{p} ranks on the CPU")
    print(f"main ranks {tag}: backend {backend}, world {p}: {how}")
    payload = [dict(name=s["name"], result=s["result"], counts=s["counts"],
                    snapshot=s["snapshot"]) for s in vsteps]
    # the batches go to the ranks as tensors, through shared memory: a large
    # pickled argument would be written down each rank's start-up pipe
    # while the rank imports, and the ranks would start one after another
    shared_spec = [
        (n, None if o is None else torch.from_numpy(o), torch.from_numpy(k),
         torch.from_numpy(v))
        for n, o, k, v in spec
    ]
    init = tempfile.mkdtemp(prefix=f"dex_ranks_{tag}_")
    t0 = time.perf_counter()
    try:
        res = spawn_ranks(ranks_worker, p, backend, pool, meta, cfg, bounds,
                          shared_spec, payload, vstate, init=init)
    finally:
        shutil.rmtree(init, ignore_errors=True)
    seconds = time.perf_counter() - t0
    launches = {k: 0 for k in ops.LAUNCHES}
    for r in res:
        print(f"main ranks {tag} rank {r['rank']}: card {r['card']} "
              f"(index {r['card_index']}), peak {r['peak_gib']} GiB, pool shard "
              f"{r['pool_bytes']} bytes (columns {r['columns']}), state "
              f"{r['state_bytes']} bytes (devices {r['devices']}), ms per step "
              f"{r['ms']}, steps {r['run_s']:.2f} s, SMO rounds {r['rounds']}, "
              f"{r['planes']} planes held, launches {r['launches']}")
        if r["differ"]:
            fail(f"ranks {tag} rank {r['rank']} differs from the virtual "
                 f"mesh: {r['differ'][:8]}")
        # (a rehearsal on the CPU counts no launch: the plain versions run)
        missing = [k for k in need if r["launches"][k] <= 0]
        if missing and cuda:
            fail(f"ranks {tag} rank {r['rank']} launched no {missing}")
        for k, v in r["launches"].items():
            launches[k] += v
    print(f"main ranks {tag}: every lane, plane, count and snapshot equals the "
          f"virtual mesh's ({seconds:.1f} s with the ranks' start)")
    report = dict(seconds=seconds, steps=res[0]["names"], ranks=[{k: r[k] for k in (
        "rank", "card", "peak_gib", "pool_bytes", "state_bytes", "ms", "run_s")}
        for r in res])
    return report, launches


def run_rank_virtual(tag, meta, cfg, pool, bounds, spec, oracle, dev):
    """The steps of ``spec`` on the virtual mesh over ``pool`` (the engine
    writes it: pass a copy), every lane held to ``oracle``; the divergent
    step must peek.  Returns ``(state, steps)``."""
    from repro_torch.core import dex, write
    from repro_torch.kernels import ops

    vstate = dex.init_state(pool, meta, cfg, bounds, device=dev)
    ops.reset_launches()
    vstate, vsteps = run_rank_steps(meta, cfg, vstate, spec, lambda a: a, dev)
    launches = dict(ops.LAUNCHES)
    prev = None
    for (name, opc, kk, vals), step in zip(spec, vsteps):
        if name == "split-burst":
            st, sst = (t.cpu().numpy() for t in step["result"])
            if not ((st == write.STATUS_OK) | (sst == write.STATUS_OK)).all():
                fail(f"ranks {tag}: a split-burst lane was not settled on the virtual mesh")
            oracle.apply(kk, vals)
        elif isinstance(step["result"], list):
            for j, r in enumerate(step["result"]):
                oracle.check(f"ranks {tag} virtual {name} {j}", opc[j], kk[j], vals[j], r,
                             SCAN_MAX_COUNT)
        else:
            oracle.check(f"ranks {tag} virtual {name}", opc, kk, vals, step["result"],
                         SCAN_MAX_COUNT)
        fleet = step["snapshot"]["fleet"]
        if name == "ycsb-c-divergent":
            step["peeks"] = {k: fleet[k] - prev[k] for k in ("peer_hits", "peer_misses")}
            if not sum(step["peeks"].values()):
                fail(f"ranks {tag}: the divergent policy's YCSB-C batches peeked nothing")
        prev = fleet
    print(f"main ranks {tag}: virtual mesh on one process, ms per step "
          f"{[round(s['ms'], 3) for s in vsteps]} ({[s['name'] for s in vsteps]}), "
          f"collective counts {[s['counts'] for s in vsteps]}, "
          f"peeks {[s.get('peeks') for s in vsteps if 'peeks' in s]}, launches "
          f"{launches}; every lane equals the host oracle")
    return vstate, vsteps


def phase_ranks(args, dev=None, world=RANK_WORLD, batch=BATCH, cache_sets=65_536):
    """The index mesh over ranks (``core/mesh.py``'s rank backend), after
    the index phases with their state freed: the 2x4 mesh of the index
    phases over ``world`` ranks, 2 virtual devices a rank, each rank holding
    the pool rows of its 2 memory columns only.  The pool is built once
    here and shared with the ranks through CUDA IPC; each copies its own
    columns' rows.  The steps (:func:`rank_spec`: YCSB-C, A and E batches,
    YCSB-A through the pipeline, a YCSB-C pair under the divergent policy,
    a split burst settled by SMO rounds, a read-back of its keys) run first
    on the virtual mesh on a copy of the pool, its lanes held to the host
    oracle, then on the ranks: with ``world`` cards or more, one rank a
    card over NCCL; with fewer, the ranks share the cards over gloo with
    CUDA tensors staged through pinned host memory, and a one-rank NCCL
    world holding all 8 virtual devices follows.  Then one YCSB-A batch on
    the 2x2x2 mesh (``axes_config``: one route row of both columns a rank)
    over ``world`` gloo ranks, from the same pool shared the same way.
    Every rank's lanes, planes and fleet snapshots must equal the virtual
    mesh's bit for bit, its collective counts (by phase) the virtual
    mesh's, and every rank must launch each of ``RANK_KERNELS``
    (``RANK_AXES_KERNELS`` on the 2x2x2 mesh)."""
    import torch

    from repro_torch.core.nodes import KEY_MAX, KEY_MIN
    from repro_torch.core.pool import SubtreePool

    t_phase = time.perf_counter()
    dev = torch.device("cuda") if dev is None else torch.device(dev)
    cuda = dev.type == "cuda"
    mem0 = torch.cuda.memory_allocated() if cuda else 0
    keys, pool, meta = make_index(args.n_keys, args.seed + 40, dev)
    host_keys = keys.cpu().numpy()
    del keys
    bounds = np.array([KEY_MIN, host_keys[host_keys.size // 2], KEY_MAX], np.int64)
    cfg = mesh_config("auto", cache_sets)
    rng = np.random.default_rng(args.seed + 40)
    burst = rank_burst(rng, pool, meta, batch // SMO_KEYS_PER_LEAF)
    spec = rank_spec(host_keys, args.seed, batch, burst)
    build_s = time.perf_counter() - t_phase

    # the virtual mesh, on a copy of the pool (the engine writes it in place)
    vstate, vsteps = run_rank_virtual(
        "2x4", meta, cfg, SubtreePool(*(t.clone() for t in pool)), bounds, spec,
        HostOracle(host_keys), dev)
    n_cards = torch.cuda.device_count() if cuda else 0
    if n_cards >= world:
        worlds = [("nccl", world)]
    else:
        worlds = [("gloo", world)] + ([("nccl", 1)] if cuda else [])
    report = dict(n_keys=int(host_keys.size), build_s=build_s,
                  virtual_ms=[round(s["ms"], 3) for s in vsteps],
                  steps=[s["name"] for s in vsteps],
                  peeks=[s["peeks"] for s in vsteps if "peeks" in s], worlds={})
    launches = {}
    for backend, p in worlds:
        tag = f"{backend}{p}"
        report["worlds"][tag], got = run_rank_world(
            backend, p, tag, pool, meta, cfg, bounds, spec, vsteps, vstate, RANK_KERNELS,
            n_cards)
        launches = {k: launches.get(k, 0) + v for k, v in got.items()}
    del vstate, vsteps
    if cuda:
        torch.cuda.empty_cache()

    # the 2x2x2 mesh: one YCSB-A batch from the same (untouched) pool; the
    # virtual mesh's copy shares the children plane, which no update writes
    cfg2 = axes_config("auto", cache_sets)
    bounds4 = quarter_bounds(host_keys)
    opc, kk, vals = rank_lanes_of("ycsb-a", 1, host_keys, args.seed, batch, 5)
    spec2 = [("ycsb-a", opc[0], kk[0], vals[0])]
    twin = pool._replace(pool_keys=pool.pool_keys.clone(),
                         pool_values=pool.pool_values.clone())
    vstate, vsteps = run_rank_virtual("2x2x2", meta, cfg2, twin, bounds4, spec2,
                                      HostOracle(host_keys), dev)
    del twin
    if cuda:
        torch.cuda.empty_cache()
    tag = "gloo4-2x2x2" if n_cards < world else f"nccl{world}-2x2x2"
    report["worlds"][tag], got = run_rank_world(
        "gloo" if n_cards < world else "nccl", world, tag, pool, meta, cfg2, bounds4,
        spec2, vsteps, vstate, RANK_AXES_KERNELS, n_cards)
    launches = {k: launches.get(k, 0) + v for k, v in got.items()}
    report["virtual_2x2x2_ms"] = [round(s["ms"], 3) for s in vsteps]
    del vstate, vsteps, pool
    if cuda:
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()
        # the ranks must have released every block shared with them, or it
        # stays allocated here for the rest of the run
        report["left_gib"] = (torch.cuda.memory_allocated() - mem0) / 2**30
        if report["left_gib"] > 1.0:
            fail(f"ranks: the phase left {report['left_gib']:.2f} GiB allocated on the "
                 "card (blocks shared with the ranks not released)")
    report["seconds"] = time.perf_counter() - t_phase
    print(f"main ranks: {json.dumps({k: v for k, v in report.items() if k != 'worlds'})}")
    print(f"main ranks: phase {report['seconds']:.1f} s")
    return report, {"ranks": launches}


def lm_attention_kernels(seed):
    """``paged_attention`` and ``flash_attention`` at the serving shapes,
    in bf16 and f32, against their plain versions (max abs error <= 2e-2
    in bf16, <= 1e-4 in f32; paged's log-sum-exp <= 1e-3 and 1e-5), and
    timed in bf16 beside the plain version and a PyTorch yardstick; paged
    cold and hot (``device_ms``) as serving calls it (with its lse), also
    for 8 requests at the full table and at granite-moe-1b-a400m's heads
    (16 over 8 of 64, ``per_shape``); flash at minitron-4b's, zamba2-2.7b's,
    granite-moe-1b-a400m's and minicpm3-4b's prefill shapes (``per_arch``;
    minicpm3-4b's q and k 96 wide, v 64 zero-padded to 96 as ``sdpa``
    passes it, its output held to the plain version's), cold and hot,
    beside SDPA on the unpadded operands; the bound counts the products at
    the true head dims, ``padded_share`` the padding of each product."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(dev)
    out = {}
    d = 128
    ppr, page = PAGES_PER_REQ, PAGE_SIZE
    moe_heads = (16, 8, 64)  # granite-moe-1b-a400m: a GQA group of 2 at D = 64
    errs, lse_errs = {}, {}
    for heads in (moe_heads, (24, 8, d)):  # minitron-4b's last: timed below
        for dtype in (torch.float32, torch.bfloat16):
            args = paged_inputs(dtype, seed + 10, dev, heads)
            got, lse = ops.paged_attention(*args, with_lse=True)
            want, want_lse = ref.paged_attention_ref(*args, with_lse=True)
            empty = args[4] == 0
            if not bool((got[empty] == 0).all()) or not bool(
                (lse[empty] == float("-inf")).all()
            ):
                fail("paged_attention: a request of length 0 must give zeros and lse -inf")
            err, l_err = max_abs_err([got], [want.nan_to_num()]), lse_err(lse, want_lse)
            name = dtype_name(dtype)
            if not (err <= ATTN_TOL[name] and l_err <= LSE_TOL[name]):
                fail(f"paged_attention {dtype} heads {heads} differs from its plain"
                     f" version: out {err}, lse {l_err}")
            errs[dtype] = max(errs.get(dtype, 0.0), err)
            lse_errs[dtype] = max(lse_errs.get(dtype, 0.0), l_err)
            if heads == moe_heads and dtype == torch.bfloat16:
                moe_args = args
    q, kp, vp, table, lens = args  # bf16, timed
    full = ppr * page
    long_args = (q[:8].contiguous(), kp, vp, table[:8].contiguous(),
                 torch.full((8,), full, dtype=torch.int32, device=dev))
    got, lse = ops.paged_attention(*long_args, with_lse=True)
    want, want_lse = ref.paged_attention_ref(*long_args, with_lse=True)
    if not (max_abs_err([got], [want]) <= ATTN_TOL["bfloat16"]
            and lse_err(lse, want_lse) <= LSE_TOL["bfloat16"]):
        fail("paged_attention at the full table differs from its plain version")
    del got, lse, want, want_lse

    def paged_row(args):
        q, kp, vp, table, lens = args
        h, hkv, d = q.shape[1], kp.shape[2], q.shape[2]
        item = q.element_size()
        pages_used = int(((lens.long() + page - 1) // page).sum())
        nbytes = paged_bytes(q.shape, hkv, item, int(lens.long().sum()), pages_used)
        nb = q.shape[0]

        def gather_sdpa():
            k = kp[table.long()].reshape(nb, ppr * page, hkv, d).transpose(1, 2)
            v = vp[table.long()].reshape(nb, ppr * page, hkv, d).transpose(1, 2)
            mask = torch.arange(ppr * page, device=dev)[None, :] < lens[:, None]
            return F.scaled_dot_product_attention(
                q[:, :, None, :], k, v, attn_mask=mask[:, None, None, :], enable_gqa=True
            )

        t = cold_and_hot({"default": lambda: ops.paged_attention(*args, with_lse=True)},
                         gather_sdpa)
        return dict(
            shape=(
                f"q [{nb}, {h}, {d}] bf16 over {N_PAGES} pages of {page}, {ppr} a"
                f" request, {int(lens.sum())} live tokens (lengths"
                f" {int(lens.min())}-{int(lens.max())})"
            ),
            ms=t["cold_ms"],
            hot_ms=t["hot_ms"],
            yardstick_ms=t["library_cold_ms"],
            yardstick_hot_ms=t["library_hot_ms"],
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        )

    main = paged_row(args)
    rows = {"serving": main, "8 requests, full table": paged_row(long_args),
            f"{MOE_ARCH} serving": paged_row(moe_args)}
    out["paged_attention"] = dict(
        name="paged_attention",
        route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:76",
        shape=main["shape"],
        check="max abs err bf16 {:.2e}, f32 {:.2e}; lse bf16 {:.2e}, f32 {:.2e}".format(
            errs[torch.bfloat16], errs[torch.float32],
            lse_errs[torch.bfloat16], lse_errs[torch.float32],
        ),
        bit_equal=False,
        max_abs_err=errs[torch.bfloat16],
        max_abs_err_f32=errs[torch.float32],
        lse_max_abs_err=lse_errs[torch.bfloat16],
        lse_max_abs_err_f32=lse_errs[torch.float32],
        ms=main["ms"],
        hot_ms=main["hot_ms"],
        plain_ms=cuda_ms(lambda: ref.paged_attention_ref(*args, with_lse=True), 5),
        library_ms=None,
        yardstick_ms=main["yardstick_ms"],
        yardstick="gather + F.scaled_dot_product_attention(enable_gqa=True), two calls",
        bound_ms=main["bound_ms"],
        bound_by="bytes",
        per_shape=rows,
    )
    for label, r in rows.items():
        print(f"kernel paged_attention {label}: {r['shape']}: kernel {r['ms']:.4f} ms cold,"
              f" {r['hot_ms']:.4f} hot; yardstick {r['yardstick_ms']:.4f} cold,"
              f" {r['yardstick_hot_ms']:.4f} hot; bound {r['bound_ms']:.4f} ms on {card}")
    del args, long_args, moe_args, q, kp, vp

    # flash: the prefill shape, a shorter q against a longer k, lengths that
    # are not a multiple of the tiles, non-causal at D = 128 and 64,
    # zamba2-2.7b's head dim of 80 (32 heads over 32), granite's D = 64
    # (16 heads over 8) at their prefill shapes, and minicpm3-4b's D = 96
    sq, sk = PREFILL_TOKENS, PREFILL_TOKENS
    cases = (((2, 24, sq, d), (2, 8, sk, d), True), ((1, 24, 300, d), (1, 8, sk, d), True),
             ((1, 24, 1000, d), (1, 8, 1000, d), True), ((1, 6, 130, d), (1, 2, 200, d), False),
             ((2, 32, sq, 80), (2, 32, sk, 80), True), ((1, 32, 300, 80), (1, 32, 700, 80), True),
             ((1, 16, 700, 64), (1, 4, 900, 64), False),
             ((2, 16, sq, 64), (2, 8, sk, 64), True),
             ((1, 40, 300, 96), (1, 40, 300, 96), True))
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for qs, ks, causal in cases:
            q, k, v = (
                torch.randn(s, generator=g, device=dev).to(dtype) for s in (qs, ks, ks)
            )
            err = max_abs_err(
                [ops.flash_attention(q, k, v, causal=causal)],
                [ref.flash_attention_ref(q, k, v, causal=causal)],
            )
            if not err <= ATTN_TOL[dtype_name(dtype)]:
                fail(f"flash_attention {dtype} {qs} x {ks} differs from its plain"
                     f" version: {err}")
            errs[dtype] = max(errs.get(dtype, 0.0), err)
    rows = {}
    for arch, (h, hkv, dh, dv) in (
        (LM_ARCH, (24, 8, d, d)), (HYBRID_ARCH, (32, 32, 80, 80)), (MOE_ARCH, (16, 8, 64, 64)),
        (MLA_ARCH, (40, 40, 96, 64)),
    ):
        q, k, v = (
            torch.randn(s, generator=g, device=dev, dtype=torch.bfloat16)
            for s in ((2, h, sq, dh), (2, hkv, sk, dh), (2, hkv, sk, dv))
        )
        vp = F.pad(v, (0, dh - dv))  # v zero-padded to q's width, as sdpa passes it
        # QK^T and PV at the true head dims, not the padded ones, over the
        # (query, key) pairs the causal mask keeps
        flops = flash_flops(2, h, sq, sq, dh, dv, True)
        # q, k, v in at their true widths, the output [2, h, sq, dv] out
        nbytes = flash_bytes(q.numel(), k.numel(), v.numel(), 2 * h * sq * dv, 2)
        if dv != dh:
            err = max_abs_err([ops.flash_attention(q, k, vp)[..., :dv]],
                              [ref.flash_attention_ref(q, k, vp)[..., :dv]])
            if not err <= ATTN_TOL["bfloat16"]:
                fail(f"flash_attention {arch}'s shape, v padded from {dv}, differs from"
                     f" its plain version: {err}")
            errs[torch.bfloat16] = max(errs[torch.bfloat16], err)

        def sdpa_call():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=hkv != h)

        t = cold_and_hot({"default": lambda: ops.flash_attention(q, k, vp)}, sdpa_call)
        padded = fa_mod.plan(dh, torch.bfloat16).padded_d
        rows[arch] = dict(
            shape=f"q [2, {h}, {sq}, {dh}] bf16 over k [2, {hkv}, {sk}, {dh}], v [2, {hkv},"
            f" {sk}, {dv}]{f' padded to {dh}' if dv != dh else ''}, causal",
            ms=t["cold_ms"],
            hot_ms=t["hot_ms"],
            plain_ms=cuda_ms(lambda: ref.flash_attention_ref(q, k, vp), 3),
            library_ms=t["library_cold_ms"],
            library_hot_ms=t["library_hot_ms"],
            bound_ms=max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
            bound_by="operations" if flops / BF16_FLOPS_PER_S > nbytes / HBM_BYTES_PER_S
            else "bytes",
            padded_share={"qk": 1 - dh / padded, "pv": 1 - dv / padded},
        )
        del q, k, v, vp
    # whisper-small's shapes, non-causal at D = 64, G = 1: the encoder's
    # self-attention and the cross attention of prefill and of one decode
    # step (one query row), each held in f32 and bf16
    h, dh = 12, 64
    for label, (b, sq_, sk_) in ENCDEC_FLASH.items():
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (
                torch.randn(s, generator=g, device=dev).to(dtype)
                for s in ((b, h, sq_, dh), (b, h, sk_, dh), (b, h, sk_, dh))
            )
            err = max_abs_err([ops.flash_attention(q, k, v, causal=False)],
                              [ref.flash_attention_ref(q, k, v, causal=False)])
            if not err <= ATTN_TOL[dtype_name(dtype)]:
                fail(f"flash_attention {dtype} {ENCDEC_ARCH} {label} [{b}, {h}, {sq_}, {dh}]"
                     f" over {sk_} keys differs from its plain version: {err}")
            errs[dtype] = max(errs[dtype], err)
        # bf16, timed: every (query, key) pair, 2 (Dq + Dv) flops a head; q,
        # k, v read and the output written once
        flops = flash_flops(b, h, sq_, sk_, dh, dh, False)
        nbytes = flash_bytes(q.numel(), k.numel(), v.numel(), q.numel(), 2)
        t = cold_and_hot({"default": lambda: ops.flash_attention(q, k, v, causal=False)},
                         lambda: F.scaled_dot_product_attention(q, k, v))
        q_rows = -(-sq_ // fa_mod.BLOCK_Q) * fa_mod.BLOCK_Q
        rows[f"{ENCDEC_ARCH} {label}"] = dict(
            shape=f"q [{b}, {h}, {sq_}, {dh}] bf16 over k, v [{b}, {h}, {sk_}, {dh}],"
            " non-causal",
            ms=t["cold_ms"],
            hot_ms=t["hot_ms"],
            plain_ms=cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal=False), 3),
            library_ms=t["library_cold_ms"],
            library_hot_ms=t["library_hot_ms"],
            bound_ms=max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
            bound_by="operations" if flops / BF16_FLOPS_PER_S > nbytes / HBM_BYTES_PER_S
            else "bytes",
            padded_share={"qk": 0.0, "pv": 0.0},
            q_tile_padding_share=1 - sq_ / q_rows,
        )
        del q, k, v
    main = rows[LM_ARCH]
    out["flash_attention"] = dict(
        name="flash_attention",
        route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:78",
        shape=main["shape"],
        check="max abs err bf16 {:.2e}, f32 {:.2e} over {} cases, {}'s shape and {}'s {}".format(
            errs[torch.bfloat16], errs[torch.float32], len(cases), MLA_ARCH, ENCDEC_ARCH,
            len(ENCDEC_FLASH),
        ),
        bit_equal=False,
        max_abs_err=errs[torch.bfloat16],
        max_abs_err_f32=errs[torch.float32],
        **{x: main[x] for x in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        per_arch=rows,
    )
    for arch, r in rows.items():
        print(f"kernel flash_attention {arch} {r['shape']}: kernel {r['ms']:.4f} ms cold,"
              f" {r['hot_ms']:.4f} hot, plain {r['plain_ms']:.4f} ms, library"
              f" {r['library_ms']:.4f} ms cold, {r['library_hot_ms']:.4f} hot, bound"
              f" {r['bound_ms']:.4f} ms ({r['bound_by']}), padded share of the products"
              f" QK {r['padded_share']['qk']:.3f}, PV {r['padded_share']['pv']:.3f}"
              + (f", padded share of the q tiles' rows {r['q_tile_padding_share']:.4f}"
                 if "q_tile_padding_share" in r else "") + f" on {card}")
    for k_ in out.values():
        print(
            f"kernel {k_['name']}: {k_['shape']}: {k_['check']}, kernel"
            f" {k_['ms']:.4f} ms, plain {k_['plain_ms']:.4f} ms, library"
            f" {k_['library_ms']} ms, yardstick {k_.get('yardstick_ms')} ms,"
            f" bound {k_['bound_ms']:.4f} ms on {card}"
        )
    return out




def grad_err(got, want):
    """The largest |difference| over the largest |want| of each of the
    three gradients, and the largest |difference| itself."""
    rel = max(
        float((g.double() - w.double()).abs().max() / w.double().abs().max().clamp(min=1e-30))
        for g, w in zip(got, want)
    )
    return rel, max_abs_err(got, want)


def flash_bwd_kernel(seed):
    """The ``flash_attention`` backward kernel against its plain version
    (``flash_attention_bwd_ref``) on the forward kernel's own output and
    log-sum-exp, at ``FLASH_BWD_SHAPES`` in bf16 and ``FLASH_BWD_F32`` in
    f32 (``GRAD_TOL``); two launches bit-equal; the forward's log-sum-exp
    against the plain version's (``LSE_TOL``); the bf16 shapes timed cold
    and hot beside the plain version, the bound (``10 D`` flops a kept
    pair and head) and the library: ``torch.autograd.grad`` of SDPA's
    output for the same dO, one call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(dev)
    g = torch.Generator(device=dev).manual_seed(seed + 31)
    cases = [(label, *c, torch.bfloat16) for label, c in FLASH_BWD_SHAPES.items()]
    cases += [(f"f32 {c[0]} over {c[1]}", *c, torch.float32) for c in FLASH_BWD_F32]
    errs, abs_errs, lse_errs, rows = {}, {}, {}, {}
    for label, qs, ks, causal, dtype in cases:
        q, k, v = (torch.randn(s, generator=g, device=dev).to(dtype) for s in (qs, ks, ks))
        do = torch.randn(qs, generator=g, device=dev).to(dtype)
        o, lse = ops.flash_attention_fwd(q, k, v, causal=causal, with_lse=True)
        l_err = lse_err(lse, ref.flash_attention_ref(q, k, v, causal=causal, with_lse=True)[1])
        got = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
        again = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            fail(f"flash_attention_bwd {label}: two launches differ")
        err, a_err = grad_err(got, ref.flash_attention_bwd_ref(q, k, v, o, do, lse,
                                                                causal=causal))
        name = dtype_name(dtype)
        if not (err <= GRAD_TOL[name] and l_err <= LSE_TOL[name]):
            fail(f"flash_attention_bwd {label} {name} differs from its plain version:"
                 f" {err} of the largest gradient; forward lse {l_err}")
        errs[name] = max(errs.get(name, 0.0), err)
        abs_errs[name] = max(abs_errs.get(name, 0.0), a_err)
        lse_errs[name] = max(lse_errs.get(name, 0.0), l_err)
        del got, again
        if dtype != torch.bfloat16:
            continue
        b, h, sq, d = qs
        hkv, sk = ks[1], ks[2]
        flops = flash_bwd_flops(b, h, sq, sk, d, causal)
        # q, o, dO and dq like q, k, v, dk and dv like k, lse in f32
        nbytes = flash_bwd_bytes(q.numel(), k.numel(), lse.numel(), 2)
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        so = F.scaled_dot_product_attention(qq, kk, vv, is_causal=causal, enable_gqa=hkv != h)
        t = cold_and_hot(
            {"default": lambda: ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)},
            lambda: torch.autograd.grad(so, (qq, kk, vv), do, retain_graph=True),
        )
        bound = max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        rows[label] = dict(
            shape=f"q [{b}, {h}, {sq}, {d}] bf16 over k, v [{b}, {hkv}, {sk}, {d}]"
            + (", causal" if causal else ", non-causal"),
            ms=t["cold_ms"],
            hot_ms=t["hot_ms"],
            plain_ms=cuda_ms(
                lambda: ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal), 3
            ),
            library_ms=t["library_cold_ms"],
            library_hot_ms=t["library_hot_ms"],
            bound_ms=bound,
            bound_by="operations" if flops / BF16_FLOPS_PER_S > nbytes / HBM_BYTES_PER_S
            else "bytes",
            gflop=flops / 1e9,
            tflops_per_s=flops / t["cold_ms"] / 1e9,
            executed_tflops_per_s=BWD_EXECUTED * flops / t["cold_ms"] / 1e9,
        )
        del so, qq, kk, vv, q, k, v, do, o, lse
    main = rows[f"{LM_ARCH} training"]
    out = dict(
        name="flash_attention_bwd",
        route="cuda",
        source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="none: the reference differentiates its jnp sdpa"
        " (src/repro/models/layers.py:144)",
        shape=main["shape"],
        check="largest |difference| / largest |gradient| bf16 {:.2e}, f32 {:.2e} over {}"
        " cases, bit-equal launches; forward lse bf16 {:.2e}, f32 {:.2e}".format(
            errs["bfloat16"], errs["float32"], len(cases), lse_errs["bfloat16"],
            lse_errs["float32"],
        ),
        bit_equal=False,
        deterministic=True,
        max_abs_err=abs_errs["bfloat16"],
        max_abs_err_f32=abs_errs["float32"],
        max_rel_err=errs["bfloat16"],
        max_rel_err_f32=errs["float32"],
        lse_max_abs_err=lse_errs["bfloat16"],
        lse_max_abs_err_f32=lse_errs["float32"],
        **{x: main[x] for x in ("ms", "hot_ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by")},
        library="torch.autograd.grad of F.scaled_dot_product_attention's output, one call",
        per_shape=rows,
    )
    for label, r in rows.items():
        print(f"kernel flash_attention_bwd {label} {r['shape']}: kernel {r['ms']:.4f} ms"
              f" cold, {r['hot_ms']:.4f} hot ({r['tflops_per_s']:.1f} TFLOP/s at 10 D,"
              f" {r['executed_tflops_per_s']:.1f} at 14 D), plain"
              f" {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms cold,"
              f" {r['library_hot_ms']:.4f} hot, bound {r['bound_ms']:.4f} ms"
              f" ({r['bound_by']}) on {card}")
    print(f"kernel flash_attention_bwd: {out['check']}")
    return {"flash_attention_bwd": out}


def dtype_name(dtype):
    return str(dtype).removeprefix("torch.")


def paged_inputs(dtype, seed, dev, heads=(24, 8, 128)):
    """``paged_attention`` at the serving shapes: 64 requests of ``heads``
    (query heads, kv heads, head dim: minitron-4b's by default), a pool of
    4,096 pages of 16 tokens, 36 pages a request, every row random (so every
    page past a request's length holds stale rows, as a recycled page
    does); lengths 0, 1, 16 and 32 (page boundaries), 17 and 575 (partial
    last pages), 576 (the whole table), the rest uniform in 1-576."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    b, (h, hkv, d) = SERVE_SLOTS, heads
    q = torch.randn((b, h, d), generator=g, device=dev).to(dtype)
    kp = torch.randn((N_PAGES, PAGE_SIZE, hkv, d), generator=g, device=dev).to(dtype)
    vp = torch.randn((N_PAGES, PAGE_SIZE, hkv, d), generator=g, device=dev).to(dtype)
    table = torch.randperm(N_PAGES, generator=g, device=dev)[: b * PAGES_PER_REQ]
    table = table.reshape(b, PAGES_PER_REQ).to(torch.int32)
    full = PAGES_PER_REQ * PAGE_SIZE
    lens = torch.randint(1, full + 1, (b,), generator=g, device=dev)
    lens[:7] = torch.tensor([0, 1, 16, 32, 17, full - 1, full], device=dev)
    return q, kp, vp, table, lens.to(torch.int32)


def lm_trace(cfg, params, dev, seed):
    """Ten paged decode steps for three requests, one admitted after
    another's release (its pages recycled), then one ``prefill``; returns
    the page tables, the decode logits and the prefill logits (on the
    host)."""
    import torch

    from repro_torch.serve.kv_cache import PagedKVCache
    from repro_torch.serve.serve_step import paged_decode_step, prefill

    rng = np.random.default_rng(seed)
    kv = PagedKVCache(cfg=cfg, n_pages=16, page_size=4, max_batch=3, device=dev)
    req = [1, 2, 3]
    for r, n in zip(req, (0, 3, 6)):
        kv.admit_request(r, prompt_len=n)
    tables, logits = [], []
    for t in range(10):
        if t == 5:
            kv.release_request(2)
            kv.admit_request(4, prompt_len=0)
            req = [1, 4, 3]
        for r in req:
            kv.extend_request(r)
        ids = np.array(req)
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, size=(3, 1))).to(dev)
        table = kv.resolve_tables(ids, 4)
        lg, k_new, v_new = paged_decode_step(
            cfg, params, tok, kv.k_pages, kv.v_pages, table, kv.batch_seq_lens(ids)
        )
        kv.append_tokens(ids, k_new, v_new)
        tables.append(table.cpu())
        logits.append(lg.cpu())
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 12))).to(dev)
    return tables, logits, prefill(cfg, params, toks).cpu()


def phase_lm_cpu_vs_cuda(seed, devices=("cpu", "cuda")):
    """The LM path on the CPU (plain versions) and on the card (kernels):
    reduced minitron-4b (2 layers, d_model 64, 4 heads over 2, head dim
    32), granite-moe-1b-a400m (the same, top-2 of 4 experts) and
    grok-1-314b (top-2 of 8), capacity factor 8.0, in f32 and bf16, weights
    from ``seed`` carried bit for bit; page tables identical, logits within
    1e-4 (f32) or 0.05 x RMS (bf16).  Then reduced minicpm3-4b with v
    narrower than q and k (``v_head_dim=8`` against 16: ``sdpa`` pads v)
    through ``dense_cache_trace``, the same limits.  An MoE model's routing is recorded on
    both: in f32 every choice must agree; in bf16 a choice may flip where
    two probabilities nearly tie, and the logits are held where no flip
    reaches (``clean_steps``), the agreement reported."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import model

    for arch in (LM_ARCH, MOE_ARCH, GROK_ARCH):
        for dtype in ("float32", "bfloat16"):
            cfg = get_config(arch).reduced(
                n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=32, dtype=dtype,
                **({"n_experts": 8} if arch == GROK_ARCH else {}),
            )
            host = model.init_params(cfg, seed, device=devices[0])
            card = model.params_from_numpy(cfg, model.params_to_numpy(host), devices[1])
            logs = [], []
            with moe_recorded(logs[0]):
                t_cpu, l_cpu, p_cpu = lm_trace(cfg, host, devices[0], seed)
            with moe_recorded(logs[1]):
                t_gpu, l_gpu, p_gpu = lm_trace(cfg, card, devices[1], seed)
            for i, (a, b_) in enumerate(zip(t_cpu, t_gpu)):
                if not torch.equal(a, b_):
                    fail(f"lm cpu-vs-cuda {arch} {dtype}: page tables differ at step {i}")
            l_cpu, l_gpu = torch.stack(l_cpu, 1), torch.stack(l_gpu, 1)  # [3, 10, V]
            rms = float(l_cpu.double().pow(2).mean().sqrt())
            tol = 1e-4 if dtype == "float32" else 0.05 * rms
            note = ""
            if cfg.moe:
                agree, flips = routing_agreement(*logs)
                n_dec = len(t_cpu) * cfg.n_layers  # the decode steps' calls, then prefill's
                clean_dec = clean_steps(
                    np.stack(flips[:n_dec]).reshape(len(t_cpu), cfg.n_layers, -1)
                )
                clean_pre = clean_steps(
                    np.stack(flips[n_dec:]).reshape(cfg.n_layers, *p_cpu.shape[:2])
                    .transpose(2, 0, 1)
                )
                if dtype == "float32" and agree < 1:
                    fail(f"lm cpu-vs-cuda {arch} f32: routing agreement {agree}")
                keep_dec, keep_pre = torch.from_numpy(clean_dec), torch.from_numpy(clean_pre)
                l_cpu, l_gpu = l_cpu[keep_dec], l_gpu[keep_dec]
                p_cpu, p_gpu = p_cpu[keep_pre], p_gpu[keep_pre]
                note = (f", routing agreement {agree:.4f}, held at {clean_dec.mean():.3f}"
                        f" of decode and {clean_pre.mean():.3f} of prefill positions")
                if not (clean_dec.mean() >= 0.25 and clean_pre.mean() >= 0.25):
                    fail(f"lm cpu-vs-cuda {arch} {dtype}: too few clean positions{note}")
            err = max_abs_err([l_gpu, p_gpu], [l_cpu, p_cpu])
            if not err <= tol:
                fail(f"lm cpu-vs-cuda {arch} {dtype}: logits differ by {err} (limit {tol}){note}")
            print(f"cpu-vs-cuda lm {arch} {dtype}: 10 paged steps + prefill, tables equal,"
                  f" max |dlogit| {err:.3e} (limit {tol:.3e}, RMS {rms:.3f}){note}")
    for dtype in ("float32", "bfloat16"):
        cfg = get_config(MLA_ARCH).reduced(v_head_dim=8, dtype=dtype)
        host = model.init_params(cfg, seed, device=devices[0])
        card = model.params_from_numpy(cfg, model.params_to_numpy(host), devices[1])
        want = dense_cache_trace(cfg, host, devices[0], seed)
        got = dense_cache_trace(cfg, card, devices[1], seed)
        err = max_abs_err(got, want)
        rms = float(np.sqrt(np.mean([float(x.double().pow(2).mean()) for x in want])))
        tol = 1e-4 if dtype == "float32" else 0.05 * rms
        if not err <= tol:
            fail(f"lm cpu-vs-cuda {MLA_ARCH} {dtype}: logits differ by {err} (limit {tol})")
        print(f"cpu-vs-cuda lm {MLA_ARCH} v 8 {dtype}: prefill + 10 decode steps, a slot"
              f" reset, max |dlogit| {err:.3e} (limit {tol:.3e}, RMS {rms:.3f})")
    for dtype in ("float32", "bfloat16"):
        cfg = get_config(ENCDEC_ARCH).reduced(dtype=dtype)
        host = model.init_params(cfg, seed, device=devices[0])
        card = model.params_from_numpy(cfg, model.params_to_numpy(host), devices[1])
        want_logits, want_planes = encdec_trace(cfg, host, devices[0], seed)
        got_logits, got_planes = encdec_trace(cfg, card, devices[1], seed)
        report = []
        for what, got, want in (("logits", got_logits, want_logits),
                                ("cross planes", got_planes, want_planes)):
            err = max_abs_err(got, want)
            rms = float(np.sqrt(np.mean([float(x.double().pow(2).mean()) for x in want])))
            tol = 1e-4 if dtype == "float32" else 0.05 * rms
            if not err <= tol:
                fail(f"lm cpu-vs-cuda {ENCDEC_ARCH} {dtype}: {what} differ by {err}"
                     f" (limit {tol})")
            report.append(f"{what} max abs diff {err:.3e} (limit {tol:.3e}, RMS {rms:.3f})")
        print(f"cpu-vs-cuda lm {ENCDEC_ARCH} {dtype}: prefill, prefill_cross_kv + 10 decode"
              f" steps over {ENCDEC_TRACE_FRAMES} frames, " + "; ".join(report))


def encdec_trace(cfg, params, dev, seed):
    """An encoder-decoder model's paths at ``ENCDEC_TRACE_FRAMES`` seeded
    frames a request: one ``prefill`` of three 12-token requests with their
    frames, then ``prefill_cross_kv`` over the same frames and ten
    ``decode_step``s of the three slots.  Returns the logits and the cross
    planes (``xk``, ``xv``), on the host."""
    import torch

    from repro_torch.models import model
    from repro_torch.models.layers import torch_dtype
    from repro_torch.serve.serve_step import prefill

    rng = np.random.default_rng(seed)
    shape = (3, ENCDEC_TRACE_FRAMES, cfg.d_model)
    emb = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    emb = emb.to(dev, torch_dtype(cfg))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(3, 12))).to(dev)
    logits = [prefill(cfg, params, toks, enc_emb=emb).cpu()]
    cache = model.init_decode_cache(cfg, 3, 10, device=dev, enc_len=ENCDEC_TRACE_FRAMES)
    model.prefill_cross_kv(cfg, params, emb, cache)
    for t in range(10):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, size=(3, 1))).to(dev)
        logits.append(model.decode_step(cfg, params, tok, cache, t)[0].cpu())
    return logits, [cache["xk"].cpu(), cache["xv"].cpu()]


@contextlib.contextmanager
def moe_recorded(log):
    """Within the block, every MoE block call appends ``(idx [T, k], dropped
    pairs)`` to ``log``: its top-k choices and the pairs past its experts'
    capacity, recomputed from the block's input on the host's request (a
    wait for the card: record only steps that are not timed).  One dispatch
    is assumed (at most 8,192 tokens)."""
    from repro_torch.models import layers

    block = layers.moe_block

    def recorded(cfg, p, x, **kw):
        xt = x.reshape(-1, x.shape[-1])
        if xt.shape[0] > 8192:
            fail(f"moe_recorded: {xt.shape[0]} tokens dispatch in chunks")
        _, idx, _ = layers.moe_route(cfg, p["router"], xt)
        keep = layers.moe_queue(idx, layers.moe_capacity(cfg, xt.shape[0]))[3]
        log.append((idx.cpu(), int((~keep).sum())))
        return block(cfg, p, x, **kw)

    layers.moe_block = recorded
    try:
        yield
    finally:
        layers.moe_block = block


def routing_agreement(log_a, log_b):
    """The share of (call, token) top-k sets two ``moe_recorded`` logs agree
    on, and each call's flips ``[T]`` (True where they differ)."""
    if len(log_a) != len(log_b) or not log_a:
        fail(f"routing: {len(log_a)} and {len(log_b)} MoE block calls")
    flips = [
        (a.sort(-1).values != b.sort(-1).values).any(-1).numpy()
        for (a, _), (b, _) in zip(log_a, log_b)
    ]
    return 1.0 - float(np.concatenate(flips).mean()), flips


def clean_steps(flips):
    """``flips`` [steps, layers, slots] -> ``[slots, steps]``, True where no
    layer's choice flipped for the slot at that step or before it (a
    slot's logits depend on its own earlier steps alone when no pair is
    dropped)."""
    return np.cumprod(~flips.any(1), axis=0).astype(bool).T


# the profiles taken and those that came back with no device time (the
# profiler lost the device trace; the run's numbers from them are None)
PROFILES = dict(taken=0, lost=0)


def device_profile(fn, ranges=(), launches=None):
    """``fn()`` under ``torch.profiler``: its result, the wall milliseconds
    under the profiler, the kernels as ``(name, device ms, count)`` sorted
    by device time (kernels only: an operator's row repeats its kernels'
    time), and the device ms of the kernels launched under each profiler
    range named in ``ranges`` (``record_function``, as ``models/layers.py``
    ``sdpa`` marks its copies).  A dict ``launches`` receives, for each ``kernels/ops.py`` launch range
    (``ops.launch_label``: kernel and shapes), its ``calls`` (the ranges
    on the host), ``timed`` (their spans on the device) and ``ms`` (the
    spans' device time): a kernel launched through ``ctypes`` is linked to
    its range's span on the device, not to an operator, and a kernel
    event the profiler drops costs its range's time, not the match of the
    other ranges."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the profiler's notice on event cycles
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    # a record_function range (the engine labels its phases, ops.py each
    # launch) shows up on the device too, spanning its kernels: only
    # kernels and copies count
    host_keys = {e.key for e in averages if e.device_type == DeviceType.CPU}
    events = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in averages
        if e.device_type == DeviceType.CUDA and e.key not in ranges
        and e.key not in host_keys
    ]
    marked = {
        r: sum(e.device_time_total for e in averages
               if e.key == r and e.device_type == DeviceType.CPU) / 1e3
        for r in ranges
    }
    kernels = sorted((e for e in events if e[1] > 0), key=lambda e: -e[1])
    PROFILES["taken"] += 1
    if not kernels:
        PROFILES["lost"] += 1
        print(f"profile {PROFILES['taken']}: no device time, the profiler lost the device trace")
    if launches is not None:
        kinds = tuple(f"{k} " for k in ops.LAUNCHES)
        for e in prof.events():
            if e.name.startswith(kinds):
                row = launches.setdefault(e.name, dict(calls=0, timed=0, ms=0.0))
                if e.device_type == DeviceType.CPU:
                    row["calls"] += 1
                elif e.device_type == DeviceType.CUDA:
                    row["timed"] += 1
                    row["ms"] += e.time_range.elapsed_us() / 1e3
    return out, wall, kernels, marked


def launch_ms(launches, kernel):
    """The device ms of ``device_profile``'s ``launches`` rows of one
    kernel (its launch ranges' spans), all shapes."""
    return sum(row["ms"] for label, row in launches.items() if label.startswith(kernel + " "))


def launch_shares(launches, kernel, busy):
    """``device_profile``'s ``launches`` rows of one kernel, by shape: calls,
    spans timed, device ms a timed call and share of ``busy``."""
    return {
        label.removeprefix(kernel + " "): dict(
            calls=row["calls"], timed=row["timed"],
            ms_per_call=row["ms"] / row["timed"] if row["timed"] else None,
            share=share_of(row["ms"], busy))
        for label, row in launches.items() if label.startswith(kernel + " ")
    }


def attention_errs(out, want):
    """Max abs difference and the share of outputs that differ from
    ``want`` rounded to the output's dtype (``want`` may be the plain
    version's f32 result, before its one rounding to bf16); a plain NaN (a
    request or row that no key reaches) counts as 0, as the kernels write
    it."""
    want = want.nan_to_num()
    return max_abs_err([out], [want]), float((out != want.to(out.dtype)).float().mean())


def paged_errs(out, want):
    """``attention_errs`` of the outputs, and ``lse_err`` of the
    log-sum-exps, of two ``(out, lse)`` pairs."""
    return (*attention_errs(out[0], want[0]), lse_err(out[1], want[1]))


@contextlib.contextmanager
def held_to_plain(errs, kernel="paged_attention", compare=attention_errs, exact=False,
                  plain=None, every=1):
    """Within the block, every ``ops.<kernel>`` call (every ``every``-th,
    from the first) also runs its plain version (``plain``, else
    ``ref.<kernel>_ref``) on the same inputs (the layer's real operands)
    and appends ``compare(kernel output, plain output)`` to ``errs``; the
    plain calls launch no kernel.  ``exact``: the plain
    version runs on the inputs' f32 copies, so its result is not rounded to
    bf16 (it computes in f32 and rounds once at the end, so that rounding is
    all that differs): a bf16 output is then held to the exact attention of
    its inputs, where against the rounded plain output one bf16 step (2**-5
    at magnitudes 4-8, above the 2e-2 limit) is the least disagreement."""
    import torch

    from repro_torch.kernels import ops, ref

    launch = getattr(ops, kernel)
    plain = plain or getattr(ref, f"{kernel}_ref")
    calls = [0]

    def checked(*a, **kw):
        out = launch(*a, **kw)
        calls[0] += 1
        if (calls[0] - 1) % every:
            return out
        if exact:
            a = [x.float() if torch.is_tensor(x) and x.is_floating_point() else x for x in a]
        errs.append(compare(out, plain(*a, **kw)))
        return out

    setattr(ops, kernel, checked)
    try:
        yield
    finally:
        setattr(ops, kernel, launch)


class Request:
    """One request of the serving run: a seeded prompt fed a token a step,
    then greedy tokens until ``GEN_TOKENS`` are generated."""

    def __init__(self, rid, rng, vocab):
        self.id = rid
        self.prompt = rng.integers(0, vocab, size=int(rng.integers(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1)))
        self.fed = []  # tokens fed, in order
        self.gen = []  # greedy tokens out

    def next_input(self):
        n = len(self.fed)
        return int(self.prompt[n]) if n < len(self.prompt) else self.gen[-1]

    def take(self, token):
        """Record the step's output: a generated token once the whole
        prompt is in."""
        if len(self.fed) >= len(self.prompt):
            self.gen.append(int(token))

    @property
    def done(self):
        return len(self.gen) >= GEN_TOKENS


def serve_config(arch):
    """``arch``'s config at 1 / ``SERVE_DEPTH`` of its layers, as the
    serving phases run it."""
    import dataclasses

    from repro_torch.configs.registry import get_config

    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=cfg.n_layers // SERVE_DEPTH)


def phase_serving(seed, arch=LM_ARCH):
    """``arch`` (minitron-4b, or granite-moe-1b-a400m) at full width (bf16,
    weights from ``seed``) served through the DEX page table for
    ``DECODE_STEPS`` steps; every ``CHECK_EVERY``-th step holds each
    layer's kernel call to its plain version on the same inputs and is
    repeated with the plain attention (RMS of the logit difference <= 0.05 x
    RMS; not timed); a host oracle of ``(request, page index) -> page``
    holds the resolved tables every step.  One kernel step and one plain
    step are profiled: device busy ms, kernels, and the plain path's history
    regather (``REGATHER``).  For an MoE model the checked steps also record
    both runs' routing (``moe_recorded``): the agreement of the kernel step
    with the plain one and the pairs dropped, and the profiled step reports
    the device ms under the ``MOE_BLOCK`` ranges.  Returns the report, the
    launches of the path, the params and the two recorded requests (tokens
    fed, decode logits)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import model
    from repro_torch.models.layers import MOE_BLOCK
    from repro_torch.serve.kv_cache import PagedKVCache
    from repro_torch.serve.serve_step import REGATHER, paged_decode_step

    dev = torch.device("cuda")
    cfg = serve_config(arch)
    ranges = (MOE_BLOCK,) if cfg.moe else ()
    t0 = time.perf_counter()
    params = model.init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    kv = PagedKVCache(cfg=cfg, n_pages=N_PAGES, page_size=PAGE_SIZE,
                      max_batch=SERVE_SLOTS, device=dev)
    rng = np.random.default_rng(seed + 7)
    oracle = {}  # request id -> its pages, by page index
    next_id = [1]

    def admit():
        r = Request(next_id[0], rng, cfg.vocab)
        next_id[0] += 1
        oracle[r.id] = kv.admit_request(r.id, prompt_len=0)
        return r

    slots = [admit() for _ in range(SERVE_SLOTS)]
    record = {1: [], 2: []}  # decode logits of two requests, per step
    recorded = {}
    times, len_sum, releases, reused = [], 0, 0, 0
    prof, checks, by_launch = None, [], {}
    prof_step = DECODE_STEPS // 2 + 1  # not a step checked against the plain path
    # the plain step profiled too, at the last check step before prof_step
    plain_prof_step = prof_step // CHECK_EVERY * CHECK_EVERY
    ops.reset_launches()
    lookups0 = kv.lookups
    torch.cuda.reset_peak_memory_stats()
    for step in range(DECODE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, r in enumerate(slots):
            if r.done:  # release (a range delete), admit a new one in the slot
                kv.release_request(r.id)
                del oracle[r.id]
                if r.id in record:
                    recorded[r.id] = r
                releases += 1
                slots[i] = admit()
                reused += 1
        tok = np.array([[r.next_input()] for r in slots], np.int64)
        for b, r in enumerate(slots):
            page = kv.extend_request(r.id)
            if page is not None:
                oracle[r.id].append(page)
            r.fed.append(int(tok[b, 0]))
        ids = np.array([r.id for r in slots])
        table = kv.resolve_tables(ids, PAGES_PER_REQ)
        lens = kv.batch_seq_lens(ids)
        tok_dev = torch.from_numpy(tok).to(dev)
        args = (cfg, params, tok_dev, kv.k_pages, kv.v_pages, table, lens)
        check = step % CHECK_EVERY == 0
        if step == prof_step:
            (logits, k_new, v_new), _, prof, prof_marked = device_profile(
                lambda: paged_decode_step(*args), ranges=ranges, launches=by_launch
            )
        elif check:
            layer_errs, logs = [], ([], [])
            with held_to_plain(layer_errs, compare=paged_errs), moe_recorded(logs[0]):
                logits, k_new, v_new = paged_decode_step(*args)
        else:
            logits, k_new, v_new = paged_decode_step(*args)
        if check:  # the same inputs through the plain attention
            with moe_recorded(logs[1]):
                if step == plain_prof_step:
                    (plain, _, _), _, plain_prof, marked = device_profile(
                        lambda: paged_decode_step(*args, use_kernel=False),
                        ranges=(REGATHER,),
                    )
                else:
                    plain, _, _ = paged_decode_step(*args, use_kernel=False)
            d = logits - plain
            rms = float(plain.pow(2).mean().sqrt())
            moe = {}
            if cfg.moe:
                dropped = sum(n for _, n in logs[0])
                moe = dict(
                    routing_agree=routing_agreement(*logs)[0],
                    dropped_pairs=dropped,
                    dropped_share=dropped / (cfg.n_layers * SERVE_SLOTS * cfg.top_k),
                )
            c = dict(
                step=step,
                layer_max_abs_err=max(e for e, _, _ in layer_errs),
                layer_differing_share=float(np.mean([f for _, f, _ in layer_errs])),
                layer_lse_max_abs_err=max(x for _, _, x in layer_errs),
                max_over_rms=float(d.abs().max()) / rms,
                rms_over_rms=float(d.pow(2).mean().sqrt()) / rms,
                greedy_agree=float((logits.argmax(-1) == plain.argmax(-1)).float().mean()),
                **moe,
            )
            checks.append(c)
            if not (c["layer_max_abs_err"] <= ATTN_TOL["bfloat16"]
                    and c["layer_lse_max_abs_err"] <= LSE_TOL["bfloat16"]
                    and c["rms_over_rms"] <= 0.05):
                fail(f"serving step {step}: kernel vs plain {c}")
            del plain, d
        kv.append_tokens(ids, k_new, v_new)
        nxt = logits.argmax(-1).cpu().numpy()
        torch.cuda.synchronize()
        if step != prof_step and not check:
            times.append((time.perf_counter() - t0) * 1e3)
        for b, r in enumerate(slots):
            r.take(nxt[b])
            if r.id in record:
                record[r.id].append(logits[b].clone())
        # the oracle: every live entry of the table, every step
        host_table = table.cpu().numpy()
        lens_h = lens.cpu().numpy()
        len_sum += int(lens_h.sum())
        for b, r in enumerate(slots):
            pages = oracle[r.id]
            want = np.zeros(PAGES_PER_REQ, np.int32)
            want[: len(pages)] = pages
            if not np.array_equal(host_table[b], want):
                fail(f"serving step {step}: request {r.id}'s table {host_table[b]}"
                     f" differs from the oracle {want}")
        live = [p for pages in oracle.values() for p in pages]
        if len(set(live)) != len(live) or set(live) & set(kv.free) or (
            len(live) + len(kv.free) != N_PAGES
        ):
            fail(f"serving step {step}: a page is held twice or lost")
    launches = dict(ops.LAUNCHES)
    lookups = kv.lookups - lookups0
    peak = torch.cuda.max_memory_allocated() / 2**30
    for r in slots:
        kv.release_request(r.id)
    if sorted(kv.free) != list(range(N_PAGES)):
        fail("serving: the free list does not hold every page after the releases")
    if launches["paged_attention"] != cfg.n_layers * DECODE_STEPS:
        fail(f"serving: {launches['paged_attention']} paged_attention launches,"
             f" expected {cfg.n_layers * DECODE_STEPS}")
    med = float(np.median(times))
    busy = sum(ms for _, ms, _ in prof)
    # the kernel's time: its launch ranges' spans on the device
    paged = launch_ms(by_launch, "paged_attention")
    paged_calls = sum(row["timed"] for label, row in by_launch.items()
                      if label.startswith("paged_attention "))
    top = "; ".join(f"{k[:40]} {ms:.3f} ms x{n}" for k, ms, n in prof[:8])
    report = dict(
        steps=DECODE_STEPS,
        slots=SERVE_SLOTS,
        tokens_per_s=SERVE_SLOTS / med * 1e3,
        median_ms=med,
        p25_ms=float(np.percentile(times, 25)),
        p75_ms=float(np.percentile(times, 75)),
        device_busy_ms=busy,
        idle_share=idle_of(busy, med),
        kernels_per_step=sum(n for _, _, n in prof),
        plain_step_device_busy_ms=sum(ms for _, ms, _ in plain_prof),
        plain_step_kernels=sum(n for _, _, n in plain_prof),
        regather_device_ms=marked[REGATHER],
        paged_attention_ms=paged,
        paged_attention_ms_per_call=paged / paged_calls if paged_calls else None,
        paged_attention_calls=paged_calls,
        paged_attention_share=share_of(paged, busy),
        lookups_per_step=lookups / DECODE_STEPS,
        mean_seq_len=len_sum / (DECODE_STEPS * SERVE_SLOTS),
        releases=releases,
        peak_gib=peak,
        init_s=init_s,
        checks=checks,
    )
    if cfg.moe:
        report.update(
            moe_block_device_ms=prof_marked[MOE_BLOCK],
            moe_block_share=share_of(prof_marked[MOE_BLOCK], busy),
            routing_agree_min=min(c["routing_agree"] for c in checks),
            dropped_pairs_per_step=float(np.mean([c["dropped_pairs"] for c in checks])),
            dropped_share=float(np.mean([c["dropped_share"] for c in checks])),
        )
    print(f"serving {arch}: {json.dumps(report)}")
    print(f"serving profile {arch} (step {prof_step}): top: {top}")
    del kv
    missing = set(record) - set(recorded)
    if missing:
        fail(f"serving: requests {sorted(missing)} did not finish")
    replays = {
        rid: (np.array(recorded[rid].fed), recorded[rid].gen, torch.stack(record[rid]))
        for rid in record
    }
    return report, launches, params, replays


def phase_prefill(params, replays, seed, arch=LM_ARCH):
    """``prefill`` of ``arch`` at full width (bf16) over two sequences of
    ``PREFILL_TOKENS`` (``timed_prefill``: tokens/s, flash_attention's
    device ms a call and share, every call held to its plain version, and
    the device ms of ``sdpa``'s transposes and, for an MoE model, of the
    MoE blocks, with the pairs one call drops); then the two recorded
    requests of the serving run replayed through ``prefill``: max |dlogit|
    / RMS against the decode's logits and the share of greedy tokens that
    agree (reported, not gated: an MoE model's prefill and decode drop
    different pairs)."""
    import torch

    from repro_torch.serve.serve_step import prefill

    dev = torch.device("cuda")
    cfg = serve_config(arch)
    g = torch.Generator(device=dev).manual_seed(seed + 12)
    toks = torch.randint(0, cfg.vocab, (2, PREFILL_TOKENS), generator=g, device=dev)
    report, launches = timed_prefill(cfg, params, toks, {"flash_attention": cfg.n_layers})
    if cfg.moe:
        log = []
        with moe_recorded(log):
            prefill(cfg, params, toks)
        report["dropped_pairs"] = sum(n for _, n in log)
        report["dropped_share"] = report["dropped_pairs"] / (len(log) * toks.numel() * cfg.top_k)
    for rid, (fed, gen, dec) in replays.items():
        n_prompt = len(fed) - len(gen) + 1
        pre = prefill(cfg, params, torch.from_numpy(fed[None]).to(dev))[0]
        rms = float(dec.pow(2).mean().sqrt())
        greedy = pre[n_prompt - 1 :].argmax(-1).cpu().numpy()
        report[f"replay_{rid}"] = dict(
            tokens=len(fed),
            max_dlogit_over_rms=float((pre - dec).abs().max()) / rms,
            greedy_agree=float(np.mean(greedy == np.array(gen))),
        )
        del pre
    print(f"prefill {arch}: {json.dumps(report)}")
    return report, launches


def phase_gate(seed, arch=LM_ARCH, **overrides):
    """The equivalence gate at full width: ``arch`` cut to 4 layers in
    float32 (no TF32), with ``overrides`` (granite-moe-1b-a400m: a capacity
    factor of n_experts / top_k = 4.0, so an expert holds every token and
    decode and prefill drop nothing), four requests of ``GATE_TOKENS``
    seeded tokens through paged decode (the kernel), dense ``decode_step``
    (plain) and ``prefill`` (the flash kernel); pairwise max |dlogit| <=
    1e-3 x RMS."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import model
    from repro_torch.serve.kv_cache import PagedKVCache
    from repro_torch.serve.serve_step import paged_decode_step, prefill

    if torch.backends.cuda.matmul.allow_tf32 or (
        torch.get_float32_matmul_precision() != "highest"
    ):
        fail("gate: float32 products must not use TF32")
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(arch), n_layers=4, dtype="float32", **overrides)
    params = model.init_params(cfg, seed, device=dev)
    b, n = GATE_REQUESTS, GATE_TOKENS
    rng = np.random.default_rng(seed + 13)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(b, n))).to(dev)
    kv = PagedKVCache(cfg=cfg, n_pages=b * n // PAGE_SIZE, page_size=PAGE_SIZE,
                      max_batch=b, device=dev)
    ids = np.arange(1, b + 1)
    for r in ids:
        kv.admit_request(int(r), prompt_len=0)
    dense = model.init_decode_cache(cfg, b, n, device=dev)
    paged_logits, dense_logits = [], []
    for t in range(n):
        for r in ids:
            kv.extend_request(int(r))
        lg, k_new, v_new = paged_decode_step(
            cfg, params, toks[:, t : t + 1], kv.k_pages, kv.v_pages,
            kv.resolve_tables(ids, n // PAGE_SIZE), kv.batch_seq_lens(ids),
        )
        kv.append_tokens(ids, k_new, v_new)
        paged_logits.append(lg)
        dense_logits.append(model.decode_step(cfg, params, toks[:, t : t + 1], dense, t)[0])
    del dense, kv
    paths = {
        "paged": torch.stack(paged_logits, 1),  # [b, n, V]
        "dense": torch.stack(dense_logits, 1),
        "prefill": prefill(cfg, params, toks),
    }
    del paged_logits, dense_logits, params
    rms = float(paths["dense"].double().pow(2).mean().sqrt())
    report = dict(layers=cfg.n_layers, requests=b, tokens=n, rms=rms, **overrides)
    for x, y in (("paged", "dense"), ("paged", "prefill"), ("dense", "prefill")):
        report[f"{x}_vs_{y}"] = float((paths[x] - paths[y]).abs().max()) / rms
    print(f"gate {arch} 4 layers f32: {json.dumps(report)}")
    worst = max(v for k, v in report.items() if "_vs_" in k)
    if not worst <= 1e-3:
        fail(f"gate: max |dlogit| / RMS {worst} > 1e-3")
    return report


# ---------------------------------------------------------------------------
# the SSM plane: falcon-mamba-7b and zamba2-2.7b
# ---------------------------------------------------------------------------


def mamba_tol(got, want):
    """The largest ``|got - want| - 1e-4 * |want|`` over the tensors: <= 1e-4
    is ``mamba_scan``'s tolerance, the reference kernel test's atol and rtol
    (``tests/test_kernels.py``)."""
    return max(
        float(((g.double() - w.double()).abs() - 1e-4 * w.double().abs()).max())
        if g.numel() else 0.0
        for g, w in zip(got, want)
    )


def mamba_inputs(b, l, d, n, dtype, seed, dev):
    """``mamba_scan`` operands at the model's init scales (``A = -(1..N) /
    N`` on every channel, ``delta = softplus(N(0, 1) - 4)``, about 0.018),
    with every seventh channel decay-heavy (``delta`` uniform in 0.5-2);
    ``x``, ``B``, ``C`` N(0, 1) in ``dtype``."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    v = torch.randn((b, l, d), generator=g, device=dev) - 4.0
    delta = torch.nn.functional.softplus(v, threshold=40.0)
    delta[..., ::7] = 0.5 + 1.5 * torch.rand((b, l, (d + 6) // 7), generator=g, device=dev)
    A = -(1.0 + torch.arange(n, device=dev, dtype=torch.float32)) / n
    A = A.expand(d, n).contiguous()
    rest = (torch.randn(s, generator=g, device=dev).to(dtype) for s in ((b, l, n), (b, l, n), (b, l, d)))
    return (delta, A, *rest)




def sm_clock_hz():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return float(smi) * 1e6


def mamba_issue_floor(sass, states, lanes):
    """Instructions a state and step of the bf16 kernel of ``states`` x
    ``lanes``, from the SASS of its unrolled group of steps (one
    ``MUFU.EX2`` a state and step): ``(arithmetic, all)``, the first its
    FP32 operations, MUFUs and shifts, the second every instruction of the
    block (the operand loads, the partial-y stores, the last group's y
    sums); and the block's counts."""
    # serving's instantiation (no states kept: ``Lb0E``) first
    name = next(k for k in sorted(sass, key=lambda k: "Lb0E" not in k)
                if mamba_instance(k) == ("bfloat16", states, lanes))
    hot = sass[name][1]["hot"]
    arith = hot["FP32"] + hot["MUFU.EX2"] + hot["shifts"]
    return arith / hot["MUFU.EX2"], hot["instructions"] / hot["MUFU.EX2"], hot


def mamba_kernels(seed, build):
    """``mamba_scan`` at the prefill shapes of falcon-mamba-7b ([2, 2048,
    8192], N = 16) and zamba2-2.7b ([2, 2048, 5120], N = 64), operands in
    bf16 and in f32; a channel width off the CTA's, L = 1 and ROADMAP
    queue 3 entry 14's input (which must give 2.313); each case's y and
    final state within ``1e-4 + 1e-4 |plain|`` of the plain version;
    timed in bf16 beside the plain version at the default plan and its
    variants (``mamba_scan.variants``), each variant held to the plain
    version too; the bounds (bytes, exponentials) beside the issue floor
    counted from the kernel's SASS (``build``: ``phase_build``'s counts)."""
    import torch

    from repro_torch.kernels import mamba_scan as mamba_mod
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(dev)
    clock = sm_clock_hz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    exps_per_s = SFU_EXP_PER_CLOCK * sms * clock
    issue_per_s = 4 * 32 * sms * clock  # four warp instructions a clock an SM
    worst, errs, rows, state_equal = 0.0, {}, {}, 1.0
    cases = [(shape, dtype) for shape in MAMBA_SHAPES.values()
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [((1, 100, 1000, 16), torch.bfloat16), ((2, 70, 333, 64), torch.float32),
              ((2, 1, 8192, 16), torch.bfloat16), ((2, 1, 5120, 64), torch.float32)]
    for i, (shape, dtype) in enumerate(cases):
        args = mamba_inputs(*shape, dtype, seed + 20 + i, dev)
        got, want = ops.mamba_scan(*args), ref.mamba_scan_ref(*args)
        tol = mamba_tol(got, want)
        if not tol <= 1e-4:
            fail(f"mamba_scan {shape} {dtype} differs from its plain version by"
                 f" {tol} beyond 1e-4 |plain|")
        worst = max(worst, tol)
        state_equal = min(state_equal, float((got[1] == want[1]).float().mean()))
        key = dtype_name(dtype)
        errs[key] = max(errs.get(key, 0.0), max_abs_err(got, want))
    one = torch.ones((1, 35, 1), device=dev)
    y, _ = ops.mamba_scan(2 * one, -torch.ones((1, 1), device=dev), one, one, one)
    entry14 = float(y[0, -1, 0])
    if not abs(entry14 - 2.313) < 1e-3:
        fail(f"mamba_scan on ROADMAP queue 3 entry 14's input gives {entry14}, not 2.313")
    del args, got, want, y
    for arch, (b, l, d, n) in MAMBA_SHAPES.items():
        args = mamba_inputs(b, l, d, n, torch.bfloat16, seed + 30, dev)
        want = ref.mamba_scan_ref(*args)
        nbytes = mamba_bytes(b, l, d, n, 2)
        exps = mamba_exps(b, l, d, n)
        bytes_ms, exps_ms = nbytes / HBM_BYTES_PER_S * 1e3, exps / exps_per_s * 1e3
        plans = mamba_mod.variants(b, d, n, sms)
        plan_ms, plan_rows = {}, {}
        for label, p in plans.items():
            tol = mamba_tol(mamba_mod.launch(ops.library(), *args, plan=p), want)
            if not tol <= 1e-4:
                fail(f"mamba_scan {arch} plan {label} differs from its plain version by {tol}")
            plan_ms[label] = cuda_ms(lambda: mamba_mod.launch(ops.library(), *args, plan=p), 10)
            per_state, per_state_all, counts = mamba_issue_floor(build["sass"], p.states, p.lanes)
            plan_rows[label] = dict(
                lanes=p.lanes, states=p.states, channels=p.channels, ctas=p.ctas,
                chunk=p.chunk, regs=p.regs,
                warps_per_sm=p.warps_per_sm, max_warps_per_sm=p.max_warps_per_sm,
                one_wave=p.one_wave, smem=p.smem_bytes(2), ms=plan_ms[label],
                issue_per_state=per_state, block_per_state=per_state_all, sass=counts,
            )
        floor_ms = exps * plan_rows["default"]["issue_per_state"] / issue_per_s * 1e3
        block_ms = exps * plan_rows["default"]["block_per_state"] / issue_per_s * 1e3
        rows[arch] = dict(
            shape=f"[{b}, {l}, {d}], N = {n}, x / B / C bf16",
            ms=cuda_ms(lambda: ops.mamba_scan(*args), 10),
            plain_ms=cuda_ms(lambda: ref.mamba_scan_ref(*args), 2, warmup=1),
            bound_ms=max(bytes_ms, exps_ms),
            bound_by="bytes" if bytes_ms > exps_ms else "operations",
            bytes_ms=bytes_ms,
            exps_ms=exps_ms,
            issue_floor_ms=floor_ms,
            block_issue_ms=block_ms,
            plans=plan_rows,
        )
        del args, want
    main = rows[SSM_ARCH]
    out = dict(
        name="mamba_scan",
        route="cuda",
        source="src/repro_torch/csrc/mamba_scan.cu",
        replaces="src/repro/kernels/mamba_scan.py:48",
        shape=main["shape"],
        check=f"{len(cases)} cases within 1e-4 + 1e-4 |plain| (worst excess {worst:.2e});"
              f" final state bit-equal in {state_equal:.2%} of entries at least;"
              f" entry 14 gives {entry14:.4f}",
        bit_equal=False,
        max_abs_err=errs["bfloat16"],
        max_abs_err_f32=errs["float32"],
        ms=main["ms"],
        plain_ms=main["plain_ms"],
        library_ms=None,
        bound_ms=main["bound_ms"],
        bound_by=main["bound_by"],
        per_arch=rows,
    )
    for arch, r in rows.items():
        print(f"kernel mamba_scan {arch} {r['shape']}: kernel {r['ms']:.4f} ms, plain"
              f" {r['plain_ms']:.2f} ms, bound {r['bound_ms']:.4f} ms (bytes"
              f" {r['bytes_ms']:.4f}, exps {r['exps_ms']:.4f} at {clock / 1e6:.0f} MHz),"
              f" issue floor {r['issue_floor_ms']:.4f} ms (the steps' whole block at full"
              f" issue {r['block_issue_ms']:.4f} ms) on {card}")
        for label, q in r["plans"].items():
            print(f"  plan {label}: {q['lanes']} lanes x {q['states']} states a channel,"
                  f" {q['channels']} channels a CTA, {q['ctas']} CTAs, warps an SM"
                  f" {q['warps_per_sm']:.2f} mean / {q['max_warps_per_sm']} max"
                  f"{'' if q['one_wave'] else ' (more than one wave)'}, {q['regs']} registers"
                  f" assumed, chunk {q['chunk']}, {q['smem']} B shared:"
                  f" {q['ms']:.4f} ms; {q['issue_per_state']:.2f} arithmetic and"
                  f" {q['block_per_state']:.2f} in all a state and step (SASS of the steps'"
                  f" block {q['sass']})")
    print(f"kernel mamba_scan: {out['check']}, max abs err bf16 {errs['bfloat16']:.2e},"
          f" f32 {errs['float32']:.2e}")
    return {"mamba_scan": out}





def mamba_bwd_issue(sass, states, lanes):
    """The backward's sub-block in the SASS of its bf16 kernel of ``states``
    x ``lanes``, a state and step: ``MUFU.EX2`` and ``SHFL`` of its
    unrolled block of exponentials (``mamba_hot_block``) and of the whole
    kernel, and the arithmetic (FP32 operations, MUFUs and shifts) and all
    instructions a sub-block runs from that block to the loop's end
    (``exp_regions``: the issue floor's count); and the counts."""
    from repro_torch.kernels import mamba_scan as mamba_mod

    name = next(k for k in sass
                if mamba_instance(k, "mamba_scan_bwd_kernel") == ("bfloat16", states, lanes))
    counts = sass[name][1]
    hot, sub = counts["hot"], max(counts["sub"], key=lambda r: r["MUFU.EX2"])
    per = mamba_mod.BWD_SUB * states
    return dict(mufu=hot["MUFU.EX2"] / per, shfl=hot["SHFL"] / per,
                shfl_kernel=counts["SHFL"] / per, shfl_sub=sub["SHFL"] / per,
                arith=(sub["FP32"] + sub["MUFU.EX2"] + sub["shifts"]) / per,
                block=sub["instructions"] / per, sass=hot, sub=sub)


def mamba_bwd_kernel(seed, build):
    """The ``mamba_scan`` backward kernel against its plain version
    (``mamba_scan_bwd_ref``) on the forward kernel's saved states, at
    ``MAMBA_BWD_SHAPES`` (zamba2-2.7b's and falcon-mamba-7b's training
    shapes and an odd one), operands in bf16 and in f32, ``dh_last`` null
    and not: each gradient within ``GRAD_TOL["float32"]`` of its largest
    plain magnitude (the kernel computes in f32 whatever its operands),
    two launches bit-equal, at the odd shape the kernel's torch
    decomposition (``lane_scan_bwd``) bit for bit; the forward with its
    states bit-equal to the forward without.  The bf16 training shapes
    timed cold and hot (``dh_last`` null, as the model's loss gives it)
    beside the plain version, the bound (bytes, ``mamba_bwd_bytes``, or
    ``B L D N`` exponentials at 16 a clock an SM) and the issue floor (the
    instructions of the unrolled sub-block a state and step, from ``build``'s
    SASS, at four warp instructions a clock an SM); the plan (CTA threads,
    cluster, busiest SM against the mean, the clusters the card holds at
    once), the partials' and the saved states' bytes; and the forward with
    and without its states, cold and hot."""
    import torch

    from repro_torch.kernels import mamba_scan as mamba_mod
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(dev)
    clock = sm_clock_hz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    exps_per_s = SFU_EXP_PER_CLOCK * sms * clock
    issue_per_s = 4 * 32 * sms * clock  # four warp instructions a clock an SM
    tol = GRAD_TOL["float32"]
    errs, abs_errs, rows, cases = {}, {}, {}, 0
    for i, (label, (b, l, d, n)) in enumerate(MAMBA_BWD_SHAPES.items()):
        for dtype in (torch.bfloat16, torch.float32):
            args = mamba_inputs(b, l, d, n, dtype, seed + 40 + i, dev)
            g = torch.Generator(device=dev).manual_seed(seed + 50 + i)
            dy = torch.randn((b, l, d), generator=g, device=dev)
            dh = torch.randn((b, d, n), generator=g, device=dev)
            y0, h0 = ops.mamba_scan(*args)
            y, h, states = ops.mamba_scan_fwd(*args, with_states=True)
            if not (torch.equal(y, y0) and torch.equal(h, h0)):
                fail(f"mamba_scan {label}: the forward with its states differs from the forward")
            del y0, h0, y, h
            for dh_last in (None, dh):
                got = ops.mamba_scan_bwd(*args, dy, dh_last, states=states)
                again = ops.mamba_scan_bwd(*args, dy, dh_last, states=states)
                if not all(torch.equal(x, z) for x, z in zip(got, again)):
                    fail(f"mamba_scan_bwd {label}: two launches differ")
                del again
                err, a_err = grad_err(got, ref.mamba_scan_bwd_ref(*args, dy, dh_last))
                key = dtype_name(dtype)
                if not err <= tol:
                    fail(f"mamba_scan_bwd {label} {key} differs from its plain version by {err}"
                         f" of the largest gradient (limit {tol})")
                if label == "odd":
                    p = mamba_mod.device_plan_bwd(ops.library(), dev, b, d, n, dtype.itemsize)
                    mirror = mamba_mod.lane_scan_bwd(*args, dy, dh_last, p)
                    if not all(torch.equal(x, z) for x, z in zip(got, mirror)):
                        fail(f"mamba_scan_bwd {label} {key}: not its decomposition bit for bit")
                errs[key] = max(errs.get(key, 0.0), err)
                abs_errs[key] = max(abs_errs.get(key, 0.0), a_err)
                cases += 1
                del got
            if dtype == torch.bfloat16 and label != "odd":
                p = mamba_mod.device_plan_bwd(ops.library(), dev, b, d, n, 2)
                t = cold_and_hot({"default": lambda: ops.mamba_scan_bwd(*args, dy, states=states)})
                fwd = cold_and_hot({
                    "default": lambda: ops.mamba_scan_fwd(*args, with_states=True),
                    "no_states": lambda: ops.mamba_scan_fwd(*args),
                })
                nbytes = mamba_bwd_bytes(b, l, d, n, 2, False)
                exps = mamba_exps(b, l, d, n)
                bytes_ms, exps_ms = nbytes / HBM_BYTES_PER_S * 1e3, exps / exps_per_s * 1e3
                issue = mamba_bwd_issue(build["sass"], p.states, p.lanes)
                rows[label] = dict(
                    shape=f"[{b}, {l}, {d}], N = {n}, x / B / C bf16, dh_last null",
                    ms=t["cold_ms"],
                    hot_ms=t["hot_ms"],
                    plain_ms=cuda_ms(lambda: ref.mamba_scan_bwd_ref(*args, dy), 1, warmup=0),
                    bound_ms=max(bytes_ms, exps_ms),
                    bound_by="bytes" if bytes_ms > exps_ms else "operations",
                    bytes_ms=bytes_ms,
                    exps_ms=exps_ms,
                    # one exponential a state and step: the forward keeps a
                    # state before every sub-block
                    executed_exps_ms=exps_ms,
                    issue_floor_ms=exps * issue["arith"] / issue_per_s * 1e3,
                    block_issue_ms=exps * issue["block"] / issue_per_s * 1e3,
                    per_state_step=issue,
                    partial_bytes=p.partial_bytes(b, l, n),
                    saved_state_bytes=b * mamba_mod.saves(l) * d * n * 4,
                    fwd_with_states_ms=fwd["cold_ms"],
                    fwd_with_states_hot_ms=fwd["hot_ms"],
                    fwd_ms=fwd["no_states_cold_ms"],
                    fwd_hot_ms=fwd["no_states_hot_ms"],
                    plan=dict(lanes=p.lanes, states=p.states, channels=p.channels,
                              threads=mamba_mod.BWD_THREADS, cluster=p.cluster,
                              clusters=p.clusters, ctas=p.ctas, regs=p.regs, smem=p.smem,
                              busiest_sm=p.per_sm, mean_sm=p.mean_per_sm,
                              imbalance=p.imbalance, resident=p.resident,
                              active_clusters=p.active, rounds=p.rounds,
                              card_clusters=mamba_mod.device_active_clusters(
                                  ops.library(), dev, 1, p.lanes, p.states)),
                )
                del fwd
            del args, dy, dh, states
            torch.cuda.empty_cache()
    main = rows[f"{HYBRID_ARCH} training"]
    out = dict(
        name="mamba_scan_bwd",
        route="cuda",
        source="src/repro_torch/csrc/mamba_scan_bwd.cu",
        replaces="none: the reference differentiates its jnp chunked scan"
        " (src/repro/models/layers.py:551)",
        shape=main["shape"],
        check="largest |difference| / largest |gradient| bf16 operands {:.2e}, f32 {:.2e} over"
        " {} cases, bit-equal launches, the odd shape bit-equal to lane_scan_bwd".format(
            errs["bfloat16"], errs["float32"], cases),
        bit_equal=False,
        deterministic=True,
        max_abs_err=abs_errs["bfloat16"],
        max_abs_err_f32=abs_errs["float32"],
        max_rel_err=errs["bfloat16"],
        max_rel_err_f32=errs["float32"],
        **{x: main[x] for x in ("ms", "hot_ms", "plain_ms", "bound_ms", "bound_by")},
        library_ms=None,
        per_shape=rows,
    )
    for label, r in rows.items():
        q, s = r["plan"], r["per_state_step"]
        print(f"kernel mamba_scan_bwd {label} {r['shape']}: kernel {r['ms']:.4f} ms cold,"
              f" {r['hot_ms']:.4f} hot, plain {r['plain_ms']:.2f} ms, bound {r['bound_ms']:.4f}"
              f" ms ({r['bound_by']}; bytes {r['bytes_ms']:.4f}, exps {r['exps_ms']:.4f}, the"
              f" exps executed {r['executed_exps_ms']:.4f} at {clock / 1e6:.0f} MHz), issue floor"
              f" {r['issue_floor_ms']:.4f} ms (arithmetic; every instruction of the sub-block"
              f" {r['block_issue_ms']:.4f}) on {card}")
        print(f"  plan: {q['threads']} threads a CTA ({q['lanes']} lanes x {q['states']} states,"
              f" {q['channels']} channels), clusters of {q['cluster']} CTAs, {q['clusters']}"
              f" clusters a batch element, {q['ctas']} CTAs; busiest SM {q['busiest_sm']} CTAs"
              f" against a mean of {q['mean_sm']:.3f} ({q['imbalance']:.4f}); {q['resident']}"
              f" resident an SM; {q['rounds']} rounds of {q['active_clusters']} clusters (the"
              f" card holds {q['card_clusters']} of each size at once);"
              f" {q['regs']} registers assumed, {q['smem']} B shared")
        print(f"  bytes: partials {r['partial_bytes'] / 1e6:.1f} MB, saved states"
              f" {r['saved_state_bytes'] / 1e6:.1f} MB; the forward with states"
              f" {r['fwd_with_states_ms']:.4f} ms cold, {r['fwd_with_states_hot_ms']:.4f} hot,"
              f" without {r['fwd_ms']:.4f}, {r['fwd_hot_ms']:.4f}")
        print(f"  SASS a state and step: the unrolled block of exponentials MUFU.EX2"
              f" {s['mufu']:.3f}, SHFL {s['shfl']:.3f} ({s['sass']}); the sub-block from it"
              f" to the loop's end SHFL {s['shfl_sub']:.3f}, arithmetic {s['arith']:.2f}, all"
              f" {s['block']:.2f} ({s['sub']}); the kernel's SHFL {s['shfl_kernel']:.3f}")
    print(f"kernel mamba_scan_bwd: {out['check']}")
    return {"mamba_scan_bwd": out}


def dense_cache_trace(cfg, params, dev, seed):
    """One ``prefill`` of two 12-token sequences, then ten ``decode_step``s
    of three slots over a dense cache; after step 5 slot 1's request is
    released and its cache planes zeroed for a new one.  Returns the logits
    on the host."""
    import torch

    from repro_torch.models import model
    from repro_torch.serve.serve_step import prefill

    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 12))).to(dev)
    out = [prefill(cfg, params, toks).cpu()]
    cache = model.init_decode_cache(cfg, 3, 10, device=dev)
    for t in range(10):
        if t == 5:
            release_slot(cache, 1)
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, size=(3, 1))).to(dev)
        out.append(model.decode_step(cfg, params, tok, cache, t)[0].cpu())
    return out


def release_slot(cache, slot):
    """Zero one slot's planes of a dense cache (recurrent states, the
    hybrid's shared keys and values, MLA's ``c_kv`` and ``k_rope``) for the
    next request."""
    for plane in cache.values():
        plane[:, slot].zero_()


def phase_ssm_cpu_vs_cuda(seed, devices=("cpu", "cuda")):
    """The SSM path on the CPU (plain scan) and on the card (the kernel):
    reduced falcon-mamba-7b and zamba2-2.7b in f32 and bf16, weights from
    ``seed`` carried bit for bit; logits within 1e-4 (f32) or 0.05 x RMS
    (bf16)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model

    for arch in (SSM_ARCH, HYBRID_ARCH):
        for dtype in ("float32", "bfloat16"):
            cfg = get_config(arch).reduced(dtype=dtype)
            host = model.init_params(cfg, seed, device=devices[0])
            card = model.params_from_numpy(cfg, model.params_to_numpy(host), devices[1])
            want = dense_cache_trace(cfg, host, devices[0], seed)
            got = dense_cache_trace(cfg, card, devices[1], seed)
            err = max_abs_err(got, want)
            rms = float(np.sqrt(np.mean([float(x.double().pow(2).mean()) for x in want])))
            tol = 1e-4 if dtype == "float32" else 0.05 * rms
            if not err <= tol:
                fail(f"ssm cpu-vs-cuda {arch} {dtype}: logits differ by {err} (limit {tol})")
            print(f"cpu-vs-cuda {arch} {dtype}: prefill + 10 decode steps, a slot"
                  f" reset, max |dlogit| {err:.3e} (limit {tol:.3e}, RMS {rms:.3f})")


def timed_prefill(cfg, params, toks, expect, enc_emb=None):
    """``PREFILL_RUNS`` timed ``prefill`` calls after a warm-up; the launch
    counts must equal ``expect`` (kernel -> launches a call) times the runs.
    Where ``flash_attention`` runs, one more call holds each of its
    launches to its plain version on the layer's own q, k and v, run in f32
    (``held_to_plain(exact=True)``; max abs error <= 2e-2 in bf16, 1e-4 in
    f32).  The profiled call reports each kernel's device ms a call by its
    launch ranges' spans (None where the profiler timed none of them), and
    the device ms of ``sdpa``'s transposes and, for an MoE model, of its
    MoE blocks.  An
    encoder-decoder model takes its frames ``enc_emb``.  Returns (report,
    launches)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.layers import MOE_BLOCK, SDPA_TRANSPOSES
    from repro_torch.serve.serve_step import prefill

    def run():
        return prefill(cfg, params, toks, enc_emb=enc_emb)

    run()  # warm-up
    ops.reset_launches()
    times = []
    for _ in range(PREFILL_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(ops.LAUNCHES)
    for k, per_call in expect.items():
        if launches[k] != per_call * PREFILL_RUNS:
            fail(f"prefill {cfg.name}: {launches[k]} {k} launches, expected"
                 f" {per_call * PREFILL_RUNS}")
    if not bool(torch.isfinite(logits).all()):
        fail(f"prefill {cfg.name}: logits are not finite")
    del logits
    attention = "flash_attention" in expect
    held = []
    if attention:
        with held_to_plain(held, "flash_attention", exact=True):
            run()
        worst = max(e for e, _ in held)
        if len(held) != expect["flash_attention"] or not worst <= ATTN_TOL[cfg.dtype]:
            fail(f"prefill {cfg.name}: {len(held)} flash_attention calls held to their"
                 f" plain version, max abs error {worst} (limit {ATTN_TOL[cfg.dtype]})")
    ranges = ((SDPA_TRANSPOSES,) if attention else ()) + ((MOE_BLOCK,) if cfg.moe else ())
    by_launch = {}
    _, _, prof, marked = device_profile(run, ranges=ranges, launches=by_launch)
    busy = sum(ms for _, ms, _ in prof)
    med = float(np.median(times))
    report = dict(
        tokens=toks.numel(),
        median_ms=med,
        tokens_per_s=toks.numel() / med * 1e3,
        device_busy_ms=busy,
        idle_share=idle_of(busy, med),
        top=[(k[:48], ms, n) for k, ms, n in prof[:6]],
    )
    for k in expect:  # each kernel's time: its launch ranges' spans on the device
        ms = launch_ms(by_launch, k)
        timed = sum(row["timed"] for label, row in by_launch.items()
                    if label.startswith(k + " "))
        report[f"{k}_ms_per_call"] = ms / timed if timed else None
        report[f"{k}_timed"] = timed
        report[f"{k}_share"] = share_of(ms, busy)
    if attention:
        report["flash_attention_held_to_plain"] = dict(
            calls=len(held),
            max_abs_err=max(e for e, _ in held),
            differing_share=float(np.mean([f for _, f in held])),
        )
        report["sdpa_transposes_device_ms"] = marked[SDPA_TRANSPOSES]
        report["sdpa_transposes_share"] = share_of(marked[SDPA_TRANSPOSES], busy)
    if cfg.moe:
        report["moe_block_device_ms"] = marked[MOE_BLOCK]
        report["moe_block_share"] = share_of(marked[MOE_BLOCK], busy)
    return report, launches


def phase_ssm_serving(seed):
    """falcon-mamba-7b at full width and half depth (``serve_config``: 32 of
    its 64 layers; bf16, weights from ``seed``) served with ``decode_step``
    over ``SSM_SLOTS`` slots for ``DECODE_STEPS`` steps: seeded prompts fed a token a step, then greedy
    tokens; a finished request's slot is zeroed and a new request admitted.
    Then ``SSM_REPLAYS`` finished requests replayed through ``prefill`` (the
    kernel in every layer) against the decode's logits at each generated
    position (RMS of the difference <= 0.05 x RMS), and ``prefill`` over two
    ``PREFILL_TOKENS`` sequences, once with every layer's kernel call held
    to its plain version.  Returns (report, launches of the prefill path)."""
    import torch

    from repro_torch.models import model
    from repro_torch.serve.serve_step import prefill

    dev = torch.device("cuda")
    cfg = serve_config(SSM_ARCH)
    t0 = time.perf_counter()
    params = model.init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    cache = model.init_decode_cache(cfg, SSM_SLOTS, 1, device=dev)
    rng = np.random.default_rng(seed + 17)
    next_id = [1]

    def admit():
        r = Request(next_id[0], rng, cfg.vocab)
        next_id[0] += 1
        return r

    slots = [admit() for _ in range(SSM_SLOTS)]
    record = {rid: [] for rid in range(1, SSM_REPLAYS + 1)}  # generated positions' logits
    finished = {}
    times, releases = [], 0
    prof_step = DECODE_STEPS // 2 + 1
    prof = None
    for step in range(DECODE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, r in enumerate(slots):
            if r.done:
                if r.id in record:
                    finished[r.id] = r
                release_slot(cache, i)
                releases += 1
                slots[i] = admit()
        tok = np.array([[r.next_input()] for r in slots], np.int64)
        for b, r in enumerate(slots):
            r.fed.append(int(tok[b, 0]))
        tok_dev = torch.from_numpy(tok).to(dev)
        if step == prof_step:
            (logits, _), _, prof, _ = device_profile(
                lambda: model.decode_step(cfg, params, tok_dev, cache, step)
            )
        else:
            logits, _ = model.decode_step(cfg, params, tok_dev, cache, step)
        nxt = logits.argmax(-1).cpu().numpy()
        torch.cuda.synchronize()
        if step != prof_step:
            times.append((time.perf_counter() - t0) * 1e3)
        for b, r in enumerate(slots):
            if r.id in record and len(r.fed) >= len(r.prompt):
                record[r.id].append(logits[b].clone())
            r.take(nxt[b])
    peak = torch.cuda.max_memory_allocated() / 2**30
    missing = set(record) - set(finished)
    if missing:
        fail(f"ssm serving: requests {sorted(missing)} did not finish")
    med = float(np.median(times))
    busy = sum(ms for _, ms, _ in prof)
    report = dict(
        arch=SSM_ARCH,
        steps=DECODE_STEPS,
        slots=SSM_SLOTS,
        tokens_per_s=SSM_SLOTS / med * 1e3,
        median_ms=med,
        p25_ms=float(np.percentile(times, 25)),
        p75_ms=float(np.percentile(times, 75)),
        device_busy_ms=busy,
        idle_share=idle_of(busy, med),
        top=[(k[:48], ms, n) for k, ms, n in prof[:6]],
        releases=releases,
        peak_gib=peak,
        init_s=init_s,
    )
    del cache
    replays = []
    for rid, r in sorted(finished.items()):
        dec = torch.stack(record[rid])  # [GEN_TOKENS, V]
        n_prompt = len(r.prompt)
        pre = prefill(cfg, params, torch.tensor([r.fed], device=dev))[0, n_prompt - 1 :]
        rms = float(dec.pow(2).mean().sqrt())
        d = pre - dec
        replays.append(dict(
            request=rid,
            tokens=len(r.fed),
            rms_over_rms=float(d.pow(2).mean().sqrt()) / rms,
            max_over_rms=float(d.abs().max()) / rms,
            greedy_agree=float((pre.argmax(-1) == dec.argmax(-1)).float().mean()),
        ))
        del pre, dec, d
    report["replays"] = replays
    worst = max(x["rms_over_rms"] for x in replays)
    report["replay_rms_over_rms_max"] = worst
    report["replay_max_over_rms_max"] = max(x["max_over_rms"] for x in replays)
    report["replay_greedy_agree_min"] = min(x["greedy_agree"] for x in replays)
    if not worst <= 0.05:
        fail(f"ssm replays: RMS of the logit difference {worst} x RMS > 0.05")
    g = torch.Generator(device=dev).manual_seed(seed + 18)
    toks = torch.randint(0, cfg.vocab, (2, PREFILL_TOKENS), generator=g, device=dev)
    report["prefill"], launches = timed_prefill(cfg, params, toks, {"mamba_scan": cfg.n_layers})
    excess = []
    with held_to_plain(excess, "mamba_scan", mamba_tol):
        prefill(cfg, params, toks)
    if len(excess) != cfg.n_layers or not max(excess) <= 1e-4:
        fail(f"ssm prefill: {len(excess)} layers' kernel calls held to plain, worst"
             f" excess {max(excess)} over 1e-4 |plain|")
    report["prefill"]["held_to_plain_worst_excess"] = max(excess)
    report["peak_gib"] = max(peak, torch.cuda.max_memory_allocated() / 2**30)
    print(f"serving {SSM_ARCH}: {json.dumps(report)}")
    return report, launches


def phase_hybrid(seed):
    """zamba2-2.7b at full width (54 layers, bf16, weights from ``seed``):
    ``prefill`` over two ``PREFILL_TOKENS`` sequences (``mamba_scan`` at
    N = 64 in every layer, ``flash_attention`` at head dim 80 in the 9
    shared-block calls), then ``HYBRID_STEPS`` ``decode_step``s of
    ``HYBRID_SLOTS`` slots, greedy after a seeded first token.  Returns
    (report, launches of the prefill path)."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import model

    dev = torch.device("cuda")
    cfg = get_config(HYBRID_ARCH)
    params = model.init_params(cfg, seed, device=dev)
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(seed + 19)
    toks = torch.randint(0, cfg.vocab, (2, PREFILL_TOKENS), generator=g, device=dev)
    groups = cfg.n_layers // cfg.hybrid_attn_every
    report = {"arch": HYBRID_ARCH}
    report["prefill"], launches = timed_prefill(
        cfg, params, toks, {"mamba_scan": cfg.n_layers, "flash_attention": groups}
    )
    cache = model.init_decode_cache(cfg, HYBRID_SLOTS, HYBRID_STEPS, device=dev)
    tok = torch.randint(0, cfg.vocab, (HYBRID_SLOTS, 1), generator=g, device=dev)
    times = []
    for step in range(HYBRID_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = model.decode_step(cfg, params, tok, cache, step)
        tok = logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if not bool(torch.isfinite(logits).all()):
        fail("hybrid decode: logits are not finite")
    med = float(np.median(times[1:]))
    report["decode"] = dict(
        steps=HYBRID_STEPS,
        slots=HYBRID_SLOTS,
        tokens_per_s=HYBRID_SLOTS / med * 1e3,
        median_ms=med,
        p25_ms=float(np.percentile(times[1:], 25)),
        p75_ms=float(np.percentile(times[1:], 75)),
    )
    report["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"hybrid {HYBRID_ARCH}: {json.dumps(report)}")
    return report, launches


def phase_mla(seed):
    """minicpm3-4b at full width (31 of its 62 layers, bf16, weights from ``seed``):
    ``prefill`` over two ``PREFILL_TOKENS`` sequences (``timed_prefill``:
    ``flash_attention`` at q, k 96 wide and v 64, padded to 96 by ``sdpa``,
    in every layer, each call held to its plain version once), then
    ``MLA_STEPS`` ``decode_step``s of ``MLA_SLOTS`` slots in lockstep over
    a compressed cache of ``MLA_STEPS`` positions, greedy after a seeded
    first token (one step profiled: device busy ms, idle share, kernels a
    step); then ``MLA_REPLAYS`` slots' tokens replayed through ``prefill``
    against the decode's logits (max |dlogit| / RMS and greedy agreement,
    reported).  Returns (report, launches of the prefill path, launches of
    the decode path, which runs no kernel of the table)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import model
    from repro_torch.serve.serve_step import prefill

    dev = torch.device("cuda")
    cfg = serve_config(MLA_ARCH)
    t0 = time.perf_counter()
    params = model.init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    report = {"arch": MLA_ARCH, "init_s": time.perf_counter() - t0}
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(seed + 22)
    toks = torch.randint(0, cfg.vocab, (2, PREFILL_TOKENS), generator=g, device=dev)
    report["prefill"], prefill_launches = timed_prefill(
        cfg, params, toks, {"flash_attention": cfg.n_layers}
    )
    del toks
    cache = model.init_decode_cache(cfg, MLA_SLOTS, MLA_STEPS, device=dev)
    tok = torch.randint(0, cfg.vocab, (MLA_SLOTS, 1), generator=g, device=dev)
    fed, record, times = [], [], []
    prof_step = MLA_STEPS // 2 + 1
    ops.reset_launches()
    for step in range(MLA_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fed.append(tok[:MLA_REPLAYS, 0].clone())
        if step == prof_step:
            (logits, _), _, prof, _ = device_profile(
                lambda: model.decode_step(cfg, params, tok, cache, step)
            )
        else:
            logits, _ = model.decode_step(cfg, params, tok, cache, step)
        tok = logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        if step != prof_step:
            times.append((time.perf_counter() - t0) * 1e3)
        record.append(logits[:MLA_REPLAYS].clone())
    decode_launches = dict(ops.LAUNCHES)
    if not bool(torch.isfinite(logits).all()):
        fail(f"mla decode {MLA_ARCH}: logits are not finite")
    med = float(np.median(times))
    busy = sum(ms for _, ms, _ in prof)
    report["decode"] = dict(
        steps=MLA_STEPS,
        slots=MLA_SLOTS,
        cache_positions=MLA_STEPS,
        tokens_per_s=MLA_SLOTS / med * 1e3,
        median_ms=med,
        p25_ms=float(np.percentile(times, 25)),
        p75_ms=float(np.percentile(times, 75)),
        device_busy_ms=busy,
        idle_share=idle_of(busy, med),
        kernels_per_step=sum(n for _, _, n in prof),
        top=[(k[:48], ms, n) for k, ms, n in prof[:6]],
    )
    report["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del cache, logits
    dec = torch.stack(record, 1)  # [replays, steps, V]
    pre = prefill(cfg, params, torch.stack(fed, 1))
    rms = float(dec.double().pow(2).mean().sqrt())
    report["replays"] = dict(
        slots=MLA_REPLAYS,
        tokens=MLA_STEPS,
        max_dlogit_over_rms=float((pre - dec).abs().max()) / rms,
        greedy_agree=float((pre.argmax(-1) == dec.argmax(-1)).float().mean()),
    )
    del params, pre, dec
    print(f"mla {MLA_ARCH}: {json.dumps(report)}")
    return report, prefill_launches, decode_launches


def encdec_profile(fn, name, shapes):
    """``fn()`` profiled, with its ``flash_attention`` calls by shape:
    ``shapes`` lists the (q shape, k shape, causal, calls) it should make,
    and the launch ranges on the host (``device_profile(launches=)``) and
    ``ops.LAUNCHES`` must count just these; each shape's device time is its
    ranges' spans.  Returns the result and a report: wall and device busy
    ms, kernels, top kernels, each shape's calls, spans timed, device ms a
    call and share of busy, and ``sdpa``'s transposes' device ms and
    share."""
    from repro_torch.kernels import ops
    from repro_torch.models.layers import SDPA_TRANSPOSES

    launches = {}
    before = ops.LAUNCHES["flash_attention"]
    out, wall, prof, marked = device_profile(fn, (SDPA_TRANSPOSES,), launches=launches)
    launched = ops.LAUNCHES["flash_attention"] - before
    want = {ops.launch_label("flash_attention", q, k, causal=causal): n
            for q, k, causal, n in shapes}
    calls = {k: row["calls"] for k, row in launches.items() if k.startswith("flash_attention ")}
    if calls != want or launched != sum(want.values()):
        fail(f"{name}: flash_attention launch ranges {calls}, expected {want};"
             f" {launched} launches counted")
    busy = sum(ms for _, ms, _ in prof)
    report = dict(
        wall_ms=wall,
        device_busy_ms=busy,
        kernels=sum(n for _, _, n in prof),
        top=[(k[:48], ms, n) for k, ms, n in prof[:6]],
        flash_by_shape=launch_shares(launches, "flash_attention", busy),
        sdpa_transposes_device_ms=marked[SDPA_TRANSPOSES],
        sdpa_transposes_share=share_of(marked[SDPA_TRANSPOSES], busy),
    )
    return out, report


def phase_encdec(seed):
    """whisper-small at full width (12 encoder and 12 decoder layers, bf16,
    weights from ``seed``).  Encode: ``prefill_cross_kv`` over
    ``ENCDEC_SLOTS`` slots of 1,500 seeded frames (``ENCODE_RUNS`` timed
    calls after a warm-up, one profiled: frames/s, ``flash_attention`` by
    shape, ``sdpa``'s transposes), filling a cross cache of 3.5 GB.
    Prefill: ``timed_prefill`` over ``ENCDEC_PREFILL`` requests x tokens
    with their frames (36 flash calls a call, each held to its plain
    version once), and one call profiled by shape.  Decode:
    ``ENCDEC_STEPS`` ``decode_step``s of the slots in lockstep over that
    cross cache and a self cache of ``ENCDEC_STEPS`` positions, greedy
    after a seeded first token; one step profiled, and one step's 12
    cross-attention calls held to their plain version (run in f32, within
    2e-2).  Replays: ``ENCDEC_REPLAYS`` slots' tokens through ``prefill``
    with their frames against the decode's logits (max |dlogit| / RMS and
    greedy agreement, reported).  Returns (report, launches of the prefill
    path, launches of the serving path: the timed and profiled encodes and
    the decode)."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model
    from repro_torch.serve.serve_step import prefill

    dev = torch.device("cuda")
    cfg = get_config(ENCDEC_ARCH)
    h, d, t_src = cfg.n_heads, cfg.head_dim, cfg.max_source_positions
    t0 = time.perf_counter()
    params = model.init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    report = {"arch": ENCDEC_ARCH, "init_s": time.perf_counter() - t0}
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(seed + 23)
    b = ENCDEC_SLOTS
    emb = torch.randn((b, t_src, cfg.d_model), generator=g, device=dev).to(torch.bfloat16)
    cache = model.init_decode_cache(cfg, b, ENCDEC_STEPS, device=dev, enc_len=t_src)

    def encode():
        return model.prefill_cross_kv(cfg, params, emb, cache)

    encode()  # warm-up
    ops.reset_launches()
    times = []
    for _ in range(ENCODE_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encode()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    enc_shape = (b, h, t_src, d)
    _, prof = encdec_profile(
        encode, ENCDEC_ARCH, [(enc_shape, enc_shape, False, cfg.enc_layers)]
    )
    med = float(np.median(times))
    report["encode"] = dict(
        slots=b, frames=t_src, median_ms=med, frames_per_s=b * t_src / med * 1e3,
        cross_cache_gb=2 * cache["xk"].numel() * 2 / 1e9,
        idle_share=idle_of(prof["device_busy_ms"], med),
        **prof,
    )

    # decode: every slot in lockstep, greedy after a seeded first token
    tok = torch.randint(0, cfg.vocab, (b, 1), generator=g, device=dev)
    fed, record, times, held = [], [], [], []
    prof_step, held_step = ENCDEC_STEPS // 2 + 1, ENCDEC_STEPS // 2 + 2
    for step in range(ENCDEC_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fed.append(tok[:ENCDEC_REPLAYS, 0].clone())
        if step == prof_step:
            (logits, _), prof = encdec_profile(
                lambda: model.decode_step(cfg, params, tok, cache, step), ENCDEC_ARCH,
                [((b, h, 1, d), (b, h, t_src, d), False, cfg.n_layers)],
            )
        elif step == held_step:
            with held_to_plain(held, "flash_attention", exact=True):
                logits, _ = model.decode_step(cfg, params, tok, cache, step)
        else:
            logits, _ = model.decode_step(cfg, params, tok, cache, step)
        tok = logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        if step not in (prof_step, held_step):
            times.append((time.perf_counter() - t0) * 1e3)
        record.append(logits[:ENCDEC_REPLAYS].clone())
    serving_launches = dict(ops.LAUNCHES)
    want = (ENCODE_RUNS + 1) * cfg.enc_layers + ENCDEC_STEPS * cfg.n_layers
    if serving_launches["flash_attention"] != want:
        fail(f"{ENCDEC_ARCH} serving: {serving_launches['flash_attention']} flash_attention"
             f" launches, expected {want}")
    if not bool(torch.isfinite(logits).all()):
        fail(f"{ENCDEC_ARCH} decode: logits are not finite")
    worst = max(e for e, _ in held)
    if len(held) != cfg.n_layers or not worst <= ATTN_TOL["bfloat16"]:
        fail(f"{ENCDEC_ARCH} decode: {len(held)} cross-attention calls held to their plain"
             f" version, max abs error {worst}")
    med = float(np.median(times))
    report["decode"] = dict(
        steps=ENCDEC_STEPS,
        slots=b,
        cache_positions=ENCDEC_STEPS,
        source_frames=t_src,
        tokens_per_s=b / med * 1e3,
        median_ms=med,
        p25_ms=float(np.percentile(times, 25)),
        p75_ms=float(np.percentile(times, 75)),
        idle_share=idle_of(prof["device_busy_ms"], med),
        cross_held_to_plain=dict(calls=len(held), max_abs_err=worst,
                                 differing_share=float(np.mean([f for _, f in held]))),
        **prof,
    )
    del cache, logits
    dec = torch.stack(record, 1)  # [replays, steps, V]
    replay_emb = emb[:ENCDEC_REPLAYS].contiguous()
    del emb
    torch.cuda.empty_cache()

    # prefill: ENCDEC_PREFILL requests x tokens, each with its frames
    n_req, n_tok = ENCDEC_PREFILL
    toks = torch.randint(0, cfg.vocab, (n_req, n_tok), generator=g, device=dev)
    frames = torch.randn((n_req, t_src, cfg.d_model), generator=g, device=dev)
    frames = frames.to(torch.bfloat16)
    per_call = cfg.enc_layers + 2 * cfg.n_layers
    report["prefill"], prefill_launches = timed_prefill(
        cfg, params, toks, {"flash_attention": per_call}, enc_emb=frames
    )
    report["prefill"]["frames"] = n_req * t_src
    self_shape, src_shape = (n_req, h, n_tok, d), (n_req, h, t_src, d)
    _, report["prefill"]["profile_by_shape"] = encdec_profile(
        lambda: prefill(cfg, params, toks, enc_emb=frames), ENCDEC_ARCH,
        [(src_shape, src_shape, False, cfg.enc_layers),
         (self_shape, self_shape, True, cfg.n_layers),
         (self_shape, src_shape, False, cfg.n_layers)],
    )
    del toks, frames

    pre = prefill(cfg, params, torch.stack(fed, 1), enc_emb=replay_emb)
    rms = float(dec.double().pow(2).mean().sqrt())
    report["replays"] = dict(
        slots=ENCDEC_REPLAYS,
        tokens=ENCDEC_STEPS,
        max_dlogit_over_rms=float((pre - dec).abs().max()) / rms,
        greedy_agree=float((pre.argmax(-1) == dec.argmax(-1)).float().mean()),
    )
    report["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del params, pre, dec, replay_emb
    print(f"encdec {ENCDEC_ARCH}: {json.dumps(report)}")
    return report, prefill_launches, serving_launches


def phase_decode_gate(seed, models):
    """The dense-cache equivalence gate at full width in float32 (no TF32):
    each ``(arch, layers)`` of ``models`` cut to that depth (falcon-mamba-7b
    to 4 layers, zamba2-2.7b to 6, one shared block; minicpm3-4b to 4;
    whisper-small to 4 encoder and 4 decoder layers), four requests of
    ``GATE_TOKENS`` seeded tokens through ``prefill`` (the kernels) and
    ``decode_step`` a token at a time (the recurrence, or MLA's compressed
    cache; for an encoder-decoder model, with ``max_source_positions``
    seeded frames a request, through the cross cache ``prefill_cross_kv``
    fills); max |dlogit| <= 1e-3 x RMS."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import model
    from repro_torch.serve.serve_step import prefill

    names = ", ".join(a for a, _ in models)
    if torch.backends.cuda.matmul.allow_tf32 or (
        torch.get_float32_matmul_precision() != "highest"
    ):
        fail(f"gate {names}: float32 products must not use TF32")
    dev = torch.device("cuda")
    report = {}
    for arch, layers in models:
        cut = {"enc_layers": layers} if get_config(arch).encdec else {}
        cfg = dataclasses.replace(get_config(arch), n_layers=layers, dtype="float32", **cut)
        params = model.init_params(cfg, seed, device=dev)
        b, n = GATE_REQUESTS, GATE_TOKENS
        rng = np.random.default_rng(seed + 21)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(b, n))).to(dev)
        emb, frames = None, cfg.max_source_positions if cfg.encdec else 0
        cache = model.init_decode_cache(cfg, b, n, device=dev, enc_len=frames)
        if cfg.encdec:
            emb = torch.from_numpy(
                rng.standard_normal((b, frames, cfg.d_model)).astype(np.float32)
            ).to(dev)
            model.prefill_cross_kv(cfg, params, emb, cache)
        dec = torch.stack(
            [model.decode_step(cfg, params, toks[:, t : t + 1], cache, t)[0] for t in range(n)], 1
        )
        pre = prefill(cfg, params, toks, enc_emb=emb)
        rms = float(dec.double().pow(2).mean().sqrt())
        report[arch] = dict(layers=layers, requests=b, tokens=n, rms=rms,
                            prefill_vs_decode=float((pre - dec).abs().max()) / rms, **cut)
        if cfg.encdec:
            report[arch]["source_frames"] = frames
        del params, cache, dec, pre, emb
        torch.cuda.empty_cache()
    print(f"gate {names} f32: {json.dumps(report)}")
    worst = max(r["prefill_vs_decode"] for r in report.values())
    if not worst <= 1e-3:
        fail(f"gate {names}: max |dlogit| / RMS {worst} > 1e-3")
    return report


def plain_mamba_fwd(*args, with_states=False):
    """``ops.mamba_scan_fwd``'s plain version: no states to keep."""
    from repro_torch.kernels import ref

    out = ref.mamba_scan_ref(*args)
    return (*out, None) if with_states else out


def plain_mamba_bwd(*args, states=None):
    """``ops.mamba_scan_bwd``'s plain version, which needs no states."""
    from repro_torch.kernels import ref

    return ref.mamba_scan_bwd_ref(*args)


@contextlib.contextmanager
def plain_kernels():
    """Within the block, every ``flash_attention`` and ``mamba_scan``
    forward and backward runs its plain version (``flash_attention_ref(
    with_lse=True)``, ``flash_attention_bwd_ref``, ``mamba_scan_ref``,
    ``mamba_scan_bwd_ref``) in place of the kernel, through the same
    ``FlashAttention`` and ``MambaScan`` functions."""
    from repro_torch.kernels import ops, ref

    names = ("flash_attention_fwd", "flash_attention_bwd", "mamba_scan_fwd", "mamba_scan_bwd")
    kept = {k: getattr(ops, k) for k in names}
    ops.flash_attention_fwd = ref.flash_attention_ref
    ops.flash_attention_bwd = ref.flash_attention_bwd_ref
    ops.mamba_scan_fwd = plain_mamba_fwd
    ops.mamba_scan_bwd = plain_mamba_bwd
    try:
        yield
    finally:
        for k, v in kept.items():
            setattr(ops, k, v)


def grad_check(params, grads, what):
    """Every parameter leaf has a finite gradient of its shape that is not
    all zero (a gradient cut at a kernel would be zero or missing)."""
    import torch

    from repro_torch.train.optimizer import leaves

    n = 0
    for p, g in zip(leaves(params), leaves(grads)):
        if g is None or g.shape != p.shape or not bool(torch.isfinite(g).all()):
            fail(f"{what}: a gradient is missing or not finite")
        if not bool((g != 0).any()):
            fail(f"{what}: a leaf of shape {tuple(p.shape)} has an all-zero gradient")
        n += 1
    return n


def train_expect(cfg):
    """Kernel -> launches of one train step of ``cfg`` with remat: a
    checkpointed layer's forward kernel runs twice (the checkpoint's
    forward, the recompute) and its backward once; the hybrid's shared
    block is not checkpointed, so its flash forward runs once an
    application; an encoder layer is checkpointed like a decoder layer."""
    n = cfg.n_layers
    if not cfg.ssm:
        # an encoder-decoder's decoder layer attends twice (self and
        # cross), and each encoder layer once (non-causal)
        calls = 2 * n + cfg.enc_layers if cfg.encdec else n
        return {"flash_attention": 2 * calls, "flash_attention_bwd": calls}
    out = {"mamba_scan": 2 * n, "mamba_scan_bwd": n}
    if cfg.hybrid_attn_every:
        groups = n // cfg.hybrid_attn_every
        out.update(flash_attention=groups, flash_attention_bwd=groups)
    return out


def train_prediction(cfg, batch, seq):
    """The dry-run of one train step of ``cfg`` on ``batch`` x ``seq``
    tokens, one microbatch on a 1x1 mesh (``launch/dryrun.py::lower_cell``
    on the meta device, nothing allocated): its predicted peak (the
    parameters', moments' and batch's bytes plus the step's counted peak),
    its counted flops and bytes, the model flops (``model_flops_for``) and
    its kernel calls, which must be ``train_expect``'s.  Fails where the
    predicted peak exceeds the card's memory."""
    import torch

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.config import ShapeCell
    from repro_torch.roofline.analysis import model_flops_for

    cell = ShapeCell("card", seq, batch, "train")
    low = dryrun.lower_cell(cfg, cell, make_mesh((1, 1), ("data", "model"), "meta"), "1x1",
                            microbatches=1)
    tot = low.counter.totals()
    calls = {k: v["calls"] for k, v in low.counter.kernels.items()}
    pred = dict(
        predicted_peak_bytes=low.argument_bytes + low.temp_bytes,
        argument_bytes=low.argument_bytes, temp_bytes=low.temp_bytes,
        counted_flops=tot["flops"], counted_matmul_flops=tot["matmul_flops"],
        counted_kernel_flops=tot["kernel_flops"], counted_bytes=tot["bytes"],
        model_flops=model_flops_for(cfg, cell), kernel_calls=calls, dryrun_s=low.seconds,
    )
    if calls != train_expect(cfg):
        fail(f"dry-run {cfg.name}: kernel calls {calls}, the card's step launches"
             f" {train_expect(cfg)}")
    total = torch.cuda.get_device_properties(0).total_memory
    if pred["predicted_peak_bytes"] > total:
        fail(f"dry-run {cfg.name}: predicted peak {pred['predicted_peak_bytes'] / 2**30:.2f} GiB"
             f" exceeds the card's {total / 2**30:.2f} GiB")
    return pred


def peak_report(what, pred, peak_bytes, median_ms):
    """Print the dry-run's predicted peak beside the measured one, the
    counted and the model flops and ``roofline_fraction`` (model flops over
    the bf16 peak rate times the median step); fails where the prediction
    is off by more than ``PEAK_TOL`` of the measured peak."""
    ratio = pred["predicted_peak_bytes"] / peak_bytes
    line = dict(
        predicted_peak_gib=pred["predicted_peak_bytes"] / 2**30,
        measured_peak_gib=peak_bytes / 2**30,
        predicted_over_measured=ratio,
        argument_gib=pred["argument_bytes"] / 2**30,
        temp_gib=pred["temp_bytes"] / 2**30,
        counted_flops=pred["counted_flops"],
        counted_matmul_flops=pred["counted_matmul_flops"],
        counted_kernel_flops=pred["counted_kernel_flops"],
        counted_bytes=pred["counted_bytes"],
        model_flops=pred["model_flops"],
        median_step_ms=median_ms,
        roofline_fraction=pred["model_flops"] / (BF16_FLOPS_PER_S * median_ms / 1e3),
        dryrun_s=pred["dryrun_s"],
    )
    print(f"roofline {what}: {json.dumps(line)}")
    if not abs(ratio - 1) <= PEAK_TOL:
        fail(f"{what}: predicted peak {line['predicted_peak_gib']:.2f} GiB, measured"
             f" {line['measured_peak_gib']:.2f} GiB (limit {PEAK_TOL:.0%})")
    return line


def phase_train(seed, arch=LM_ARCH):
    """Phase 6g (minitron-4b, 32 layers) and 6h (zamba2-2.7b, 54 Mamba
    layers and the shared GQA block after every 6): ``arch`` at full width
    (bf16, remat), weights from ``seed`` on the card, trained by
    ``make_train_step`` with ``OptConfig(total_steps=3, warmup_steps=1)``
    for ``TRAIN_STEPS`` steps on ``TokenPipeline(batch=2, seq_len=4096)``
    batches (8,192 tokens a step).  First the gradients of batch 0 (step
    1's) with each backward kernel call held to its plain version (every
    ``flash_attention_bwd`` within ``GRAD_TOL`` of the model's dtype; one
    in ``HYBRID_HOLD_EVERY`` ``mamba_scan_bwd`` calls, from the last
    layer's, within ``GRAD_TOL["float32"]``, as it computes in f32): every
    leaf's gradient finite and not all zero.  Then the steps, each timed
    (ms, tokens/s) with its loss, their launches (``train_expect``); the
    peak memory; the loss on batch 0 after step 1's update and after all
    the updates, the last (minitron-4b) or the first (zamba2-2.7b) below
    step 1's; one more step profiled: device busy ms, the shares of
    the flash forward and backward and of the ``mamba_scan`` forward and
    backward (their launch ranges' spans, by shape), and of ``sdpa``'s
    transposes, the weight products' ms and
    the optimizer's (``ADAMW_UPDATE``) beside its bytes' bound; the flops a
    step, ``6 N tokens`` with N the non-embedding parameters plus the head
    (the tied embedding where it is the head), and with the hybrid's
    shared block counted at each application (reported).  Returns (report,
    launches of the timed steps)."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenPipeline, to_device
    from repro_torch.kernels import ops
    from repro_torch.models import model
    from repro_torch.models.layers import SDPA_TRANSPOSES
    from repro_torch.train.optimizer import ADAMW_UPDATE, OptConfig, init_opt_state
    from repro_torch.train.train_step import loss_and_grads, make_train_step

    dev = torch.device("cuda")
    cfg = get_config(arch)
    if not cfg.remat or cfg.dtype != "bfloat16":
        fail(f"train: {arch} should train in bf16 with remat")
    expect = train_expect(cfg)
    pred = train_prediction(cfg, TRAIN_BATCH, TRAIN_SEQ)
    params = model.init_params(cfg, seed, device=dev)
    ocfg = OptConfig(total_steps=TRAIN_STEPS, warmup_steps=1)
    state = init_opt_state(params, ocfg)
    pipe = TokenPipeline(cfg, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=seed)
    batches = [to_device(pipe.next_batch(), cfg, dev) for _ in range(TRAIN_STEPS + 1)]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = sum(p.numel() for k, p in model_leaves(params)
                   if k != "embed" or cfg.tie_embeddings)
    shared = sum(p.numel() for k, p in model_leaves(params) if k.startswith("shared_attn."))
    applied = n_params + shared * (expect.get("flash_attention", 1) - 1)
    # the optimizer's least bytes: each parameter and its gradient (of the
    # parameter's dtype) read, the parameter written; each moment read and
    # written
    opt_bytes = sum(
        p.numel() * (3 * p.element_size() + 4 * m.element_size())
        for (_, p), (_, m) in zip(model_leaves(params), model_leaves(state.mu))
    )

    held, held_scan = [], []
    with contextlib.ExitStack() as stack:
        if "flash_attention_bwd" in expect:
            stack.enter_context(held_to_plain(held, "flash_attention_bwd", compare=grad_err))
        if "mamba_scan_bwd" in expect:
            stack.enter_context(held_to_plain(held_scan, "mamba_scan_bwd", compare=grad_err,
                                              plain=plain_mamba_bwd, every=HYBRID_HOLD_EVERY))
        loss0, _, grads = loss_and_grads(cfg, params, batches[0])
    leaves_checked = grad_check(params, grads, f"train {arch}")
    held_report = {}
    for kernel, errs, tol, calls in (
        ("flash_attention_bwd", held, GRAD_TOL[cfg.dtype], expect.get("flash_attention_bwd", 0)),
        ("mamba_scan_bwd", held_scan, GRAD_TOL["float32"],
         -(-expect.get("mamba_scan_bwd", 0) // HYBRID_HOLD_EVERY)),
    ):
        if not calls:
            continue
        worst = max(e for e, _ in errs) if errs else float("inf")
        if len(errs) != calls or not worst <= tol:
            fail(f"train {arch}: {len(errs)} {kernel} calls held to their plain version"
                 f" (expected {calls}), worst {worst} of the largest gradient (limit {tol})")
        held_report[kernel] = dict(calls=len(errs), max_rel_err=worst,
                                   max_abs_err=max(a for _, a in errs))
    if held_scan:
        # the backward runs from the last layer: call i is layer n - 1 - i x every
        held_report["mamba_scan_bwd"]["layers"] = [
            cfg.n_layers - 1 - i * HYBRID_HOLD_EVERY for i in range(len(held_scan))]
    del grads
    torch.cuda.empty_cache()

    step = make_train_step(cfg, ocfg)
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batches[i])
        loss = float(m["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        steps.append(dict(loss=loss, ms=ms, tokens_per_s=tokens / ms * 1e3,
                          grad_norm=float(m["grad_norm"]), lr=float(m["lr"])))
        if i == 0:  # batch 0's loss after the update on it, outside the timing
            launches = dict(ops.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 2**30
            with torch.no_grad():
                after_first = float(model.loss_fn(cfg, params, batches[0])[0])
            ops.LAUNCHES.update(launches)
            torch.cuda.reset_peak_memory_stats()
    launches = dict(ops.LAUNCHES)
    peak = max(peak, torch.cuda.max_memory_allocated() / 2**30)
    for k, per_step in expect.items():
        if launches[k] != per_step * TRAIN_STEPS:
            fail(f"train {arch}: {launches[k]} {k} launches, expected {per_step * TRAIN_STEPS}")
    if not all(np.isfinite(x["loss"]) for x in steps):
        fail(f"train {arch}: a loss is not finite: {[x['loss'] for x in steps]}")
    if abs(steps[0]["loss"] - float(loss0)) > 1e-3 * abs(float(loss0)):
        fail(f"train {arch}: step 1's loss {steps[0]['loss']} is not batch 0's {float(loss0)}")
    with torch.no_grad():
        after = float(model.loss_fn(cfg, params, batches[0])[0])
    # Batch 0's loss must fall: minitron-4b's after all the updates,
    # zamba2-2.7b's after the update on batch 0.  Under this schedule (no
    # warm-up, three steps, random tokens) the loss swings between the
    # first steps, in float32 as in bf16, and the two models swing the
    # other way round: minitron-4b's rises after step 1 and falls after
    # step 3, zamba2-2.7b's falls after step 1 and rises after step 2
    # (PERF.md, section 6).
    fell = after if arch == LM_ARCH else after_first
    if not fell < steps[0]["loss"]:
        fail(f"train {arch}: batch 0's loss {after_first} after step 1's update on it,"
             f" {after} after {TRAIN_STEPS} updates; step 1's was {steps[0]['loss']}")

    by_launch = {}
    _, wall, prof, marked = device_profile(
        lambda: step(params, state, batches[TRAIN_STEPS]),
        ranges=(SDPA_TRANSPOSES, ADAMW_UPDATE), launches=by_launch,
    )
    busy = sum(ms for _, ms, _ in prof)
    # each kernel's time: its launch ranges' spans on the device
    fwd = launch_ms(by_launch, "flash_attention")
    bwd = launch_ms(by_launch, "flash_attention_bwd")
    scan = launch_ms(by_launch, "mamba_scan")
    scan_bwd = launch_ms(by_launch, "mamba_scan_bwd")
    products = sum(ms for k, ms, _ in prof if any(x in k for x in ("nvjet", "gemm", "cutlass")))
    med = float(np.median([x["ms"] for x in steps[1:]]))
    flops = 6 * n_params * tokens
    profiled = dict(
        wall_ms=wall,
        device_busy_ms=busy,
        idle_share=idle_of(busy, wall),
        flash_fwd_ms=fwd,
        flash_fwd_share=share_of(fwd, busy),
        flash_bwd_ms=bwd,
        flash_bwd_share=share_of(bwd, busy),
        flash_fwd_by_shape=launch_shares(by_launch, "flash_attention", busy),
        flash_bwd_by_shape=launch_shares(by_launch, "flash_attention_bwd", busy),
        sdpa_transposes_ms=marked[SDPA_TRANSPOSES],
        sdpa_transposes_share=share_of(marked[SDPA_TRANSPOSES], busy),
    )
    if cfg.ssm:
        profiled.update(mamba_scan_ms=scan, mamba_scan_share=share_of(scan, busy),
                        mamba_scan_bwd_ms=scan_bwd, mamba_scan_bwd_share=share_of(scan_bwd, busy),
                        mamba_scan_by_shape=launch_shares(by_launch, "mamba_scan", busy),
                        mamba_scan_bwd_by_shape=launch_shares(by_launch, "mamba_scan_bwd",
                                                              busy))
    profiled.update(
        rest_share=share_of(busy - fwd - bwd - scan - scan_bwd - marked[SDPA_TRANSPOSES], busy),
        # within the rest: the matrix products (cuBLAS), the optimizer
        weight_products_ms=products,
        weight_products_share=share_of(products, busy),
        adamw_update_ms=marked[ADAMW_UPDATE],
        adamw_update_share=share_of(marked[ADAMW_UPDATE], busy),
        adamw_update_bound_ms=opt_bytes / HBM_BYTES_PER_S * 1e3,
        kernels=sum(n for _, _, n in prof),
        top=[(k[:48], ms, n) for k, ms, n in prof[:12]],
    )
    report = dict(
        arch=arch,
        layers=cfg.n_layers,
        batch=TRAIN_BATCH,
        seq_len=TRAIN_SEQ,
        tokens_per_step=tokens,
        steps=steps,
        median_ms=med,
        tokens_per_s=tokens / med * 1e3,
        batch0_loss_after_first=after_first,
        batch0_loss_after=after,
        peak_gib=peak,
        leaves_with_grad=leaves_checked,
        held_to_plain=held_report,
        profiled_step=profiled,
        params_non_embedding_plus_head=n_params,
        flops_per_step=flops,
        tflops_per_s=flops / med / 1e9,
    )
    if applied != n_params:
        report.update(params_applied=applied, flops_per_step_applied=6 * applied * tokens,
                      tflops_per_s_applied=6 * applied * tokens / med / 1e9)
    report["roofline"] = peak_report(f"train {arch}", pred, peak * 2**30, med)
    print(f"train {arch}: {json.dumps(report)}")
    if cfg.ssm:
        print(f"train {arch}: the scan's backward {scan_bwd:.2f} ms of {busy:.2f} device ms in the"
              f" profiled step ({pct(share_of(scan_bwd, busy))}), its forward {scan:.2f} ms"
              f" ({pct(share_of(scan, busy))}); median step {med:.2f} ms; peak {peak:.2f} GiB")
    del params, state, batches
    return report, launches


def model_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from model_leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def phase_train_gate(seed, arch=LM_ARCH, layers=TRAIN_GATE_LAYERS):
    """Phase 7's training gates: ``arch`` cut to ``layers`` layers at full
    width in float32 (no TF32; minitron-4b 4, falcon-mamba-7b 4, zamba2-2.7b
    6 with one shared block), one batch of the token pipeline (2 x
    ``TRAIN_GATE_SEQ`` tokens), the loss and every gradient of one train
    step with the kernels against the same step with every flash and
    ``mamba_scan`` call, forward and backward, run as its plain version
    (``plain_kernels``): the loss within 1e-5 relative, each leaf's
    gradient within 1e-3 x its RMS; the backward kernels launched
    ``train_expect``'s counts with the kernels and none with the plain
    versions."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenPipeline, to_device
    from repro_torch.kernels import ops
    from repro_torch.models import model
    from repro_torch.train.train_step import loss_and_grads

    if torch.backends.cuda.matmul.allow_tf32 or (
        torch.get_float32_matmul_precision() != "highest"
    ):
        fail("train gate: float32 products must not use TF32")
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(arch), n_layers=layers, dtype="float32")
    bwd = {k: v for k, v in train_expect(cfg).items() if k.endswith("_bwd")}
    params = model.init_params(cfg, seed, device=dev)
    batch = to_device(
        TokenPipeline(cfg, global_batch=2, seq_len=TRAIN_GATE_SEQ, seed=seed + 41).next_batch(),
        cfg, dev,
    )
    before = dict(ops.LAUNCHES)
    loss_k, _, grads_k = loss_and_grads(cfg, params, batch)
    launched = {k: ops.LAUNCHES[k] - before[k] for k in bwd}
    with plain_kernels():
        loss_p, _, grads_p = loss_and_grads(cfg, params, batch)
    after = {k: ops.LAUNCHES[k] - before[k] for k in bwd}
    if launched != bwd or after != launched:
        fail(f"train gate {arch}: backward launches {launched} with the kernels, expected"
             f" {bwd}, and {after} after the plain versions (no more)")
    grad_check(params, grads_k, f"train gate {arch}")
    per_leaf = {}
    for (name, gk), (_, gp) in zip(model_leaves(grads_k), model_leaves(grads_p)):
        rms = float(gp.double().pow(2).mean().sqrt())
        per_leaf[name] = float((gk - gp).abs().max()) / rms
    worst = max(per_leaf.values())
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    report = dict(layers=cfg.n_layers, tokens=batch["tokens"].numel(), loss=float(loss_p),
                  loss_rel_diff=loss_rel, max_grad_diff_over_rms=worst,
                  grad_diff_over_rms=per_leaf)
    print(f"gate train {arch} {cfg.n_layers} layers f32: {json.dumps(report)}")
    if not (loss_rel <= 1e-5 and worst <= 1e-3):
        fail(f"train gate {arch}: loss differs by {loss_rel} (limit 1e-5), a gradient by"
             f" {worst} x its RMS (limit 1e-3)")
    del params, grads_k, grads_p
    torch.cuda.empty_cache()
    return report


def phase_launch(seed, arch, batch, seq):
    """Phase ``launch``: ``arch`` at full width and depth (bf16, remat)
    through the launcher, ``build_run(arch, batch=, seq=,
    steps=LAUNCH_STEPS, seed=)`` on the card, then ``train(run,
    LAUNCH_STEPS, ckpt_every=0)`` on its ``TokenPipeline`` batches.  First
    the gradients of batch 0 with every ``flash_attention_bwd`` call held
    to its plain version within ``GRAD_TOL`` (minicpm3-4b at head dim 96,
    v padded from 64; whisper-small's non-causal encoder over 1,500 frames,
    its causal decoder and its cross attention; granite-moe-1b-a400m at 64)
    and every leaf's gradient finite and not all zero.  Then the
    launcher's steps, each timed by the launcher (``run.step_seconds``, from
    the step's call to its loss on the host) with its loss, their
    launches against ``train_expect``, the peak memory, the first step's
    loss within 1e-3 of batch 0's from the gradient pass (granite's
    ``index_add_`` combine is not bit-stable on the card, so the two may
    differ by a rounding; the other models match to that too), and one
    more step profiled: device busy, the flash forward's and backward's
    ms and shares by shape (their launch ranges), ``sdpa``'s transposes,
    the weight products and the optimizer.  Returns (report, launches of
    the launcher's steps)."""
    import torch

    from repro_torch.data.pipeline import TokenPipeline, to_device
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch
    from repro_torch.models.layers import SDPA_TRANSPOSES
    from repro_torch.train.optimizer import ADAMW_UPDATE
    from repro_torch.train.train_step import loss_and_grads, make_train_step

    from repro_torch.configs.registry import get_config

    pred = train_prediction(get_config(arch), batch, seq)
    t0 = time.perf_counter()
    run = launch.build_run(arch, batch=batch, seq=seq, steps=LAUNCH_STEPS, seed=seed)
    torch.cuda.synchronize()
    built_s = time.perf_counter() - t0
    cfg, dev = run.cfg, run.mesh.device
    if not cfg.remat or cfg.dtype != "bfloat16":
        fail(f"launch: {arch} should train in bf16 with remat")
    expect = train_expect(cfg)
    tokens = batch * seq
    first = to_device(TokenPipeline(cfg, global_batch=batch, seq_len=seq, seed=seed)
                      .next_batch(), cfg, dev)
    held, held_scan = [], []
    with contextlib.ExitStack() as stack:
        if "flash_attention_bwd" in expect:
            stack.enter_context(held_to_plain(held, "flash_attention_bwd", compare=grad_err))
        if "mamba_scan_bwd" in expect:
            stack.enter_context(held_to_plain(held_scan, "mamba_scan_bwd", compare=grad_err,
                                              plain=plain_mamba_bwd, every=SSM_HOLD_EVERY))
        loss0, _, grads = loss_and_grads(cfg, run.params, first)
    leaves_checked = grad_check(run.params, grads, f"launch {arch}")
    held_report = {}
    for kernel, errs, tol, calls in (
        ("flash_attention_bwd", held, GRAD_TOL[cfg.dtype], expect.get("flash_attention_bwd", 0)),
        ("mamba_scan_bwd", held_scan, GRAD_TOL["float32"],
         -(-expect.get("mamba_scan_bwd", 0) // SSM_HOLD_EVERY)),
    ):
        if not calls:
            continue
        worst = max(e for e, _ in errs) if errs else float("inf")
        if len(errs) != calls or not worst <= tol:
            fail(f"launch {arch}: {len(errs)} {kernel} calls held to their plain version"
                 f" (expected {calls}), worst {worst} of the largest gradient (limit {tol})")
        held_report[kernel] = dict(calls=len(errs), max_rel_err=worst,
                                   max_abs_err=max(a for _, a in errs))
    if held_scan:
        # the backward runs from the last layer: call i is layer n - 1 - i x every
        held_report["mamba_scan_bwd"]["layers"] = [
            cfg.n_layers - 1 - i * SSM_HOLD_EVERY for i in range(len(held_scan))]
    del grads, first
    torch.cuda.empty_cache()

    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, watchdog = launch.train(run, LAUNCH_STEPS, ckpt_every=0, log_every=1)
    step_ms = [s * 1e3 for s in run.step_seconds]
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for k, per_step in expect.items():
        if launches[k] != per_step * LAUNCH_STEPS:
            fail(f"launch {arch}: {launches[k]} {k} launches, expected"
                 f" {per_step * LAUNCH_STEPS}")
    if (run.step != LAUNCH_STEPS or len(losses) != LAUNCH_STEPS
            or not all(np.isfinite(x) for x in losses)):
        fail(f"launch {arch}: step {run.step}, losses {losses}")
    if abs(losses[0] - float(loss0)) > 1e-3 * abs(float(loss0)):
        fail(f"launch {arch}: step 1's loss {losses[0]} is not batch 0's {float(loss0)}")

    step = make_train_step(cfg, run.opt_cfg)
    nxt = to_device(run.pipeline.next_batch(), cfg, dev)
    by_launch = {}
    _, wall, prof, marked = device_profile(
        lambda: step(run.params, run.opt_state, nxt),
        ranges=(SDPA_TRANSPOSES, ADAMW_UPDATE), launches=by_launch,
    )
    busy = sum(ms for _, ms, _ in prof)
    fwd = launch_shares(by_launch, "flash_attention", busy)
    bwd = launch_shares(by_launch, "flash_attention_bwd", busy)
    fwd_ms = launch_ms(by_launch, "flash_attention")
    bwd_ms = launch_ms(by_launch, "flash_attention_bwd")
    scan_ms = launch_ms(by_launch, "mamba_scan")
    scan_bwd_ms = launch_ms(by_launch, "mamba_scan_bwd")
    products = sum(ms for k, ms, _ in prof if any(x in k for x in ("nvjet", "gemm", "cutlass")))
    med = float(np.median(step_ms))
    report = dict(
        arch=arch, layers=cfg.n_layers, enc_layers=cfg.enc_layers, batch=batch, seq_len=seq,
        source_frames=cfg.max_source_positions if cfg.encdec else None,
        tokens_per_step=tokens, build_run_s=built_s,
        losses=losses, step_ms=step_ms, median_ms=med, tokens_per_s=tokens / med * 1e3,
        watchdog=dict(steps=watchdog.steps, ema_ms=watchdog.ema * 1e3,
                      stragglers=watchdog.stragglers),
        batch0_loss=float(loss0), peak_gib=peak, leaves_with_grad=leaves_checked,
        held_to_plain=held_report,
        launches_per_step={k: launches[k] // LAUNCH_STEPS for k in expect},
        profiled_step=dict(
            wall_ms=wall, device_busy_ms=busy, idle_share=idle_of(busy, wall),
            flash_fwd_ms=fwd_ms, flash_fwd_share=share_of(fwd_ms, busy),
            flash_bwd_ms=bwd_ms, flash_bwd_share=share_of(bwd_ms, busy),
            flash_fwd_by_shape=fwd, flash_bwd_by_shape=bwd,
            mamba_scan_ms=scan_ms, mamba_scan_share=share_of(scan_ms, busy),
            mamba_scan_bwd_ms=scan_bwd_ms, mamba_scan_bwd_share=share_of(scan_bwd_ms, busy),
            mamba_scan_by_shape=launch_shares(by_launch, "mamba_scan", busy),
            mamba_scan_bwd_by_shape=launch_shares(by_launch, "mamba_scan_bwd", busy),
            sdpa_transposes_ms=marked[SDPA_TRANSPOSES],
            weight_products_ms=products, weight_products_share=share_of(products, busy),
            adamw_update_ms=marked[ADAMW_UPDATE],
            adamw_update_share=share_of(marked[ADAMW_UPDATE], busy),
            kernels=sum(n for _, _, n in prof),
            top=[(k[:48], ms, n) for k, ms, n in prof[:8]],
        ),
    )
    report["roofline"] = peak_report(f"launch {arch}", pred, peak * 2**30, med)
    print(f"launch {arch}: {json.dumps(report)}")
    del run, step, nxt
    torch.cuda.empty_cache()
    return report, launches


@contextlib.contextmanager
def arch_cut(arch, **overrides):
    """Within the block, the registry's ``arch`` is its config with
    ``overrides`` (``build_run`` takes a registry name)."""
    import dataclasses

    from repro_torch.configs import registry

    kept = registry.ARCHS[arch]
    registry.ARCHS[arch] = dataclasses.replace(kept, **overrides)
    try:
        yield
    finally:
        registry.ARCHS[arch] = kept


@contextlib.contextmanager
def timed_checkpoints(log):
    """Within the block, every ``CheckpointManager.save`` and ``restore``
    appends ``(kind, seconds, bytes on disk)`` to ``log`` (a save's
    seconds include the copy off the card, a restore's the copy onto
    it)."""
    import torch

    from repro_torch.train.checkpoint import CheckpointManager

    save, restore = CheckpointManager.save, CheckpointManager.restore

    def step_bytes(d):
        return sum(f.stat().st_size for f in pathlib.Path(d).rglob("*.npy"))

    def timed_save(self, step, state, extra=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = save(self, step, state, extra)
        log.append(("save", time.perf_counter() - t0, step_bytes(out)))
        return out

    def timed_restore(self, template, *, step=None, shardings=None):
        t0 = time.perf_counter()
        out = restore(self, template, step=step, shardings=shardings)
        torch.cuda.synchronize()
        log.append(("restore", time.perf_counter() - t0,
                    step_bytes(os.path.join(self.root, f"step_{out[1]:08d}"))))
        return out

    CheckpointManager.save, CheckpointManager.restore = timed_save, timed_restore
    try:
        yield
    finally:
        CheckpointManager.save, CheckpointManager.restore = save, restore


def state_of(run):
    """Copies of ``run``'s parameters and moments, in tree order."""
    from repro_torch.train.optimizer import leaves

    return [t.clone() for tree in (run.params, run.opt_state.mu, run.opt_state.nu)
            for t in leaves(tree)]


def same_state(a, b):
    import torch

    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def phase_launch_ckpt(seed):
    """Phase ``launch-ckpt``: minicpm3-4b at full width cut to
    ``CKPT_LAYERS`` layers (bf16, 2 x 4,096 tokens), trained by the launcher
    in a temporary directory that the phase removes.  Runs: (a) without
    checkpoints, 3 steps, then on to ``CKPT_STEPS``; (b) checkpointed every
    ``CKPT_EVERY`` steps (keep 2) with ``FailureInjector({2: FatalError, 3:
    TransientError})``, 3 steps, then resumed from its step-3 checkpoint
    to ``CKPT_STEPS``; (r) the pipeline's batches at positions
    ``CKPT_B_ORDER``, [0, 1, 2, 2, 3, 4], through ``make_train_step``
    without the launcher; (c) a fresh ``build_run`` on (b)'s directory, to
    ``CKPT_RESUME_TO``.  Gates, bit for bit on the parameters and moments:
    (b) at step 3, after its restore and the retried step, equals (a) at
    step 3; (b) trains the batches in (r)'s order (``ROADMAP.md`` queue 3,
    entry 20: the retried step trains the failing iteration's batch, then
    the loop draws again from the restored position), so it ends equal to
    (r) and unlike (a), at pipeline position 5; every leaf of (b)'s last
    checkpoint restored from disk equals (b)'s live tensor; (c) resumes at
    step 6 from position 5 and runs 2 steps, to position 7.  Reports each save's and restore's seconds and
    bytes.  Gradients were run-to-run bit-stable on the card at this
    shape, so no deterministic switch is set.  Returns (report, launches
    of the runs)."""
    import shutil
    import tempfile

    import torch

    from repro_torch.data.pipeline import to_device
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.fault import FailureInjector, FatalError, TransientError
    from repro_torch.train.optimizer import leaves
    from repro_torch.train.train_step import make_train_step

    root = tempfile.mkdtemp(prefix="launch_ckpt_")
    io = []
    ops.reset_launches()
    try:
        with arch_cut(MLA_ARCH, n_layers=CKPT_LAYERS), timed_checkpoints(io):

            def new_run(name):
                run = launch.build_run(MLA_ARCH, batch=2, seq=TRAIN_SEQ, steps=CKPT_RESUME_TO,
                                       seed=seed, ckpt_dir=name and os.path.join(root, name))
                if run.ckpt is not None:
                    run.ckpt.keep = 2
                return run

            run = new_run(None)
            launch.train(run, 3, log_every=CKPT_STEPS)
            a3 = state_of(run)
            losses_a, _ = launch.train(run, CKPT_STEPS, log_every=CKPT_STEPS)
            a6 = state_of(run)
            bytes_state = sum(t.numel() * t.element_size() for t in a6)
            del run

            run = new_run("b")
            injector = FailureInjector({2: FatalError, 3: TransientError})
            launch.train(run, 3, ckpt_every=CKPT_EVERY, injector=injector, log_every=CKPT_STEPS)
            after_restore_exact = same_state(state_of(run), a3)
            del a3
            launch.train(run, CKPT_STEPS, ckpt_every=CKPT_EVERY, injector=injector,
                         log_every=CKPT_STEPS)
            b6 = state_of(run)
            b_position = run.pipeline.state.step
            mgr = CheckpointManager(os.path.join(root, "b"), keep=2)
            back, back_step, _ = mgr.restore((run.params, run.opt_state))
            on_disk_exact = back_step == CKPT_STEPS and back[1].step == CKPT_STEPS and same_state(
                [t for tree in (back[0], back[1].mu, back[1].nu) for t in leaves(tree)], b6)
            del run, back

            run = new_run(None)
            drawn = [to_device(run.pipeline.next_batch(), run.cfg, run.mesh.device)
                     for _ in range(max(CKPT_B_ORDER) + 1)]
            step = make_train_step(run.cfg, run.opt_cfg)
            for i in CKPT_B_ORDER:
                run.params, run.opt_state, _ = step(run.params, run.opt_state, drawn[i])
            replay_exact = same_state(state_of(run), b6)
            b_equals_a = same_state(b6, a6)
            del run, drawn, step, a6, b6
            torch.cuda.empty_cache()
            if not after_restore_exact:
                fail("launch-ckpt: (b) after its restore and retried step differs from (a)")
            if (injector.schedule or b_position != max(CKPT_B_ORDER) + 1 or not replay_exact
                    or b_equals_a):
                fail(f"launch-ckpt: (b) at pipeline position {b_position} (expected"
                     f" {max(CKPT_B_ORDER) + 1}), faults left {injector.schedule}, equal to the"
                     f" replay of {CKPT_B_ORDER} {replay_exact}, to (a) {b_equals_a}")
            if not on_disk_exact:
                fail(f"launch-ckpt: step {back_step}'s checkpoint restored from disk differs from"
                     f" (b)'s live state")

            run = new_run("b")
            losses_c, _ = launch.train(run, CKPT_RESUME_TO, ckpt_every=CKPT_EVERY, log_every=1)
            c_position = run.pipeline.state.step
            if (run.step != CKPT_RESUME_TO or len(losses_c) != CKPT_RESUME_TO - CKPT_STEPS
                    or c_position != b_position + len(losses_c)):
                fail(f"launch-ckpt: (c) ended at step {run.step} after {len(losses_c)} steps, at"
                     f" pipeline position {c_position} (expected {CKPT_RESUME_TO} after"
                     f" {CKPT_RESUME_TO - CKPT_STEPS}, at {b_position + 2})")
            kept = run.ckpt.all_steps()
            del run
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    saves = [(s, b) for k, s, b in io if k == "save"]
    restores = [(s, b) for k, s, b in io if k == "restore"]
    report = dict(
        arch=MLA_ARCH, layers=CKPT_LAYERS, tokens_per_step=2 * TRAIN_SEQ,
        state_bytes_on_card=bytes_state, losses_a=losses_a, losses_c=losses_c,
        after_restore_exact=after_restore_exact, b_order=CKPT_B_ORDER, b_position=b_position,
        b_equals_replay=replay_exact, b_equals_a=b_equals_a, c_position=c_position,
        on_disk_exact=on_disk_exact, kept_steps=kept,
        saves=len(saves), save_s=[s for s, _ in saves], save_bytes=saves[0][1],
        save_gb_per_s=float(np.median([b / s for s, b in saves])) / 1e9,
        restores=len(restores), restore_s=[s for s, _ in restores],
        restore_bytes=restores[0][1],
        restore_gb_per_s=float(np.median([b / s for s, b in restores])) / 1e9,
    )
    print(f"launch-ckpt: {json.dumps(report)}")
    return report, dict(ops.LAUNCHES)


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; no result", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside the repository)

    t_start = time.perf_counter()
    smi = phase_device()
    build = phase_build()
    dev = torch.device("cuda")
    if args.n_keys != FULL_KEYS:
        print("reduced: " + json.dumps(
            {"n_keys": args.n_keys, "reason": "--n-keys set on the command line"}
        ))
    t0 = time.perf_counter()
    keys, pool, meta = make_index(args.n_keys, args.seed, dev)
    torch.cuda.synchronize()
    print(
        f"index: {args.n_keys} keys, {meta.n_subtrees_padded} subtrees x "
        f"{meta.subtree_cap} nodes, top height {meta.top_height}, "
        f"built in {time.perf_counter() - t0:.1f} s"
    )
    t0 = time.perf_counter()
    kernels = phase_kernels(pool, meta, keys, args.seed)
    kernels.update(lm_attention_kernels(args.seed))
    kernels.update(flash_bwd_kernel(args.seed))
    kernels.update(mamba_kernels(args.seed, build))
    kernels.update(mamba_bwd_kernel(args.seed, build))
    t1 = time.perf_counter()
    phase_cpu_vs_cuda(args.seed)
    phase_lm_cpu_vs_cuda(args.seed)
    phase_ssm_cpu_vs_cuda(args.seed)
    t2 = time.perf_counter()
    report, per_path, oracle, bounds = phase_main(args, keys, pool, meta)
    t3 = time.perf_counter()
    more, more_paths, carried = phase_splits_and_scans(
        args, keys, pool, meta, oracle, bounds
    )
    report.update(more)
    per_path.update(more_paths)
    t4 = time.perf_counter()
    more, more_paths = phase_route_table(args, keys, pool, meta, oracle, bounds)
    report.update(more)
    per_path.update(more_paths)
    t5 = time.perf_counter()
    more, more_paths = phase_repartition(args, keys, pool, meta, oracle, bounds)
    report.update(more)
    per_path.update(more_paths)
    t6a = time.perf_counter()
    more, more_paths, carried = phase_pipeline(
        args, keys, pool, meta, oracle, bounds, carried
    )
    report.update(more)
    per_path.update(more_paths)
    torch.cuda.empty_cache()
    t6b = time.perf_counter()
    more, more_paths = phase_fleet_policy(args, keys, pool, meta, oracle, bounds)
    report.update(more)
    per_path.update(more_paths)
    t6c = time.perf_counter()
    more, more_paths = phase_route_axes(args, keys, pool, meta, oracle, bounds, carried)
    report.update(more)
    per_path.update(more_paths)
    t6d = time.perf_counter()
    more, more_paths = phase_telemetry(args, keys, pool, meta, oracle, bounds, carried)
    report.update(more)
    per_path.update(more_paths)
    torch.cuda.empty_cache()
    t6e = time.perf_counter()
    # last on the index: the drain rebuilds the pool and releases the old one
    more, more_paths = phase_drain(args, keys, pool, meta, oracle, bounds, carried)
    report.update(more)
    per_path.update(more_paths)
    t6 = time.perf_counter()
    del keys, pool, meta, oracle, bounds, carried
    torch.cuda.empty_cache()
    # the index mesh over ranks, on an index of its own
    report["ranks"], more_paths = phase_ranks(args)
    per_path.update(more_paths)
    torch.cuda.empty_cache()
    t6r = time.perf_counter()
    # the LM phases run without the index
    report["serving"], per_path["serving"], params, replays = phase_serving(args.seed)
    check_launches("serving", per_path["serving"], ("paged_attention", "node_search"))
    t7 = time.perf_counter()
    report["prefill"], per_path["prefill"] = phase_prefill(params, replays, args.seed)
    check_launches("prefill", per_path["prefill"], ("flash_attention",))
    del params, replays
    torch.cuda.empty_cache()
    t8 = time.perf_counter()
    report["gate"] = phase_gate(args.seed)
    t9 = time.perf_counter()
    # the SSM plane, each model's weights freed before the next
    report["serving-ssm"], per_path["prefill-ssm"] = phase_ssm_serving(args.seed)
    check_launches("prefill-ssm", per_path["prefill-ssm"], ("mamba_scan",))
    torch.cuda.empty_cache()
    t10 = time.perf_counter()
    report["hybrid"], per_path["prefill-hybrid"] = phase_hybrid(args.seed)
    check_launches("prefill-hybrid", per_path["prefill-hybrid"],
                   ("mamba_scan", "flash_attention"))
    torch.cuda.empty_cache()
    t11 = time.perf_counter()
    report["gate-ssm"] = phase_decode_gate(args.seed, ((SSM_ARCH, 4), (HYBRID_ARCH, 6)))
    t12 = time.perf_counter()
    # the MoE plane: granite-moe-1b-a400m, the earlier models freed
    report["serving-moe"], per_path["serving-moe"], params, replays = phase_serving(
        args.seed, MOE_ARCH
    )
    check_launches("serving-moe", per_path["serving-moe"], ("paged_attention", "node_search"))
    report["prefill-moe"], per_path["prefill-moe"] = phase_prefill(
        params, replays, args.seed, MOE_ARCH
    )
    check_launches("prefill-moe", per_path["prefill-moe"], ("flash_attention",))
    del params, replays
    torch.cuda.empty_cache()
    t13 = time.perf_counter()
    report["gate-moe"] = phase_gate(args.seed, MOE_ARCH, moe_capacity_factor=4.0)
    t14 = time.perf_counter()
    # the MLA plane: minicpm3-4b, the earlier models freed
    report["mla"], per_path["prefill-mla"], per_path["serving-mla"] = phase_mla(args.seed)
    check_launches("prefill-mla", per_path["prefill-mla"], ("flash_attention",))
    print(f"main serving-mla: launches {per_path['serving-mla']}")
    torch.cuda.empty_cache()
    t15 = time.perf_counter()
    report["gate-mla"] = phase_decode_gate(args.seed, ((MLA_ARCH, 4),))
    t16 = time.perf_counter()
    # the encoder-decoder plane: whisper-small, the earlier models freed
    report["encdec"], per_path["prefill-encdec"], per_path["serving-encdec"] = phase_encdec(
        args.seed
    )
    check_launches("prefill-encdec", per_path["prefill-encdec"], ("flash_attention",))
    check_launches("serving-encdec", per_path["serving-encdec"], ("flash_attention",))
    torch.cuda.empty_cache()
    t17 = time.perf_counter()
    report["gate-encdec"] = phase_decode_gate(args.seed, ((ENCDEC_ARCH, 4),))
    t18 = time.perf_counter()
    # training: minitron-4b, then zamba2-2.7b, at full width, the earlier
    # models freed
    report["train"], per_path["train"] = phase_train(args.seed)
    check_launches("train", per_path["train"], ("flash_attention", "flash_attention_bwd"))
    torch.cuda.empty_cache()
    t19 = time.perf_counter()
    report["train-hybrid"], per_path["train-hybrid"] = phase_train(args.seed, HYBRID_ARCH)
    check_launches("train-hybrid", per_path["train-hybrid"],
                   ("mamba_scan", "mamba_scan_bwd", "flash_attention", "flash_attention_bwd"))
    torch.cuda.empty_cache()
    t20 = time.perf_counter()
    report["gate-train"] = {arch: phase_train_gate(args.seed, arch, layers)
                            for arch, layers in TRAIN_GATES}
    t21 = time.perf_counter()
    # the launch plane: build_run + train at full width, the earlier models
    # freed; then the checkpointed runs
    report["launch"] = {}
    for arch, batch, seq in LAUNCH_RUNS:
        report["launch"][arch], per_path[f"launch {arch}"] = phase_launch(
            args.seed, arch, batch, seq)
        check_launches(f"launch {arch}", per_path[f"launch {arch}"],
                       tuple(report["launch"][arch]["launches_per_step"]))
    t22 = time.perf_counter()
    report["launch-ckpt"], per_path["launch-ckpt"] = phase_launch_ckpt(args.seed)
    check_launches("launch-ckpt", per_path["launch-ckpt"],
                   ("flash_attention", "flash_attention_bwd"))
    t23 = time.perf_counter()
    launches = {k: sum(p[k] for p in per_path.values()) for k in per_path["read-only"]}
    print(f"main: launches {launches}")
    print(f"phases: kernels {t1 - t0:.1f} s, cpu-vs-cuda {t2 - t1:.1f} s,"
          f" main {t3 - t2:.1f} s, splits and scans {t4 - t3:.1f} s,"
          f" route table {t5 - t4:.1f} s, repartition {t6a - t5:.1f} s,"
          f" pipeline {t6b - t6a:.1f} s, fleet policy {t6c - t6b:.1f} s,"
          f" route axes {t6d - t6c:.1f} s, telemetry {t6e - t6d:.1f} s,"
          f" drain {t6 - t6e:.1f} s, ranks {t6r - t6:.1f} s,"
          f" serving {t7 - t6r:.1f} s, prefill {t8 - t7:.1f} s, gate {t9 - t8:.1f} s,"
          f" ssm serving and prefill {t10 - t9:.1f} s, hybrid {t11 - t10:.1f} s,"
          f" ssm gate {t12 - t11:.1f} s, moe serving and prefill {t13 - t12:.1f} s,"
          f" moe gate {t14 - t13:.1f} s, mla serving and prefill {t15 - t14:.1f} s,"
          f" mla gate {t16 - t15:.1f} s, encdec serving and prefill {t17 - t16:.1f} s,"
          f" encdec gate {t18 - t17:.1f} s, train {t19 - t18:.1f} s,"
          f" train hybrid {t20 - t19:.1f} s, train gates {t21 - t20:.1f} s,"
          f" launch {t22 - t21:.1f} s, launch-ckpt {t23 - t22:.1f} s")
    rows = []
    for name, k in kernels.items():
        rows.append(dict(
            name=name,
            route=k["route"],
            source=k["source"],
            replaces=k["replaces"],
            launches=launches[name],
            max_abs_err=k["max_abs_err"],
            ms=k["ms"],
            plain_ms=k["plain_ms"],
            bound_ms=k["bound_ms"],
            bound_by=k["bound_by"],
            library_ms=k["library_ms"],
            bit_equal=k["bit_equal"],
            **{x: k[x] for x in ("max_abs_err_f32", "max_rel_err", "max_rel_err_f32",
                                 "deterministic", "lse_max_abs_err", "lse_max_abs_err_f32",
                                 "hot_ms", "yardstick_ms", "per_arch", "per_shape", "per_mix")
               if x in k},
        ))
    print(f"profiles: {PROFILES['taken']} taken, {PROFILES['lost']} with no device time")
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

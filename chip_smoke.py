#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA GPU and
check it.

    python3 chip_smoke.py [--out results.json]

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a)
and ``nvcc``. The phases, each of which raises on failure:

0. setup: the card's name and power limit, torch/CUDA/nvcc versions, and
   the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``,
   with each kernel's registers and spills (none allowed in the receive
   kernel's grouped route, nor in the tensor-core flash kernel at any of
   its head_dims), both flash kernels' shared memory a block
   against the card's opt-in limit, and int8_sr's threefry instructions an
   element read off the tiled send kernel's SASS (``cuobjdump``) for its
   bound;
1. each kernel against its plain PyTorch version on the card, at the
   shapes of the paper's datasets (d = 10, 57, 9947), the receive kernel's
   lane groups (d = 1, 7, 16, 32), a K > C case and K = 9: the receive
   kernel on the f32 wire and in every decode mode (bf16, f16, affine
   int8, int4, ternary), and with each defense screen (norm_clip,
   cosine_gate) after the f32, affine int8, int4 and ternary decodes on
   rows crafted for every verdict (gated and clipped counts equal, and the
   screened lastModel bit for bit where the screen's sum order is known;
   also at d = 33, 64, 96, 100 and 128 on the strided route, and at
   d = 6 and 8 where the jitted reference sums some nodes unfused, N =
   20 003 and 40 001), and at every d <= 32 its grouped route against its
   strided route forced on the same inputs (bit for bit; K = 9 on the
   strided route); the bf16/f16
   decodes timed at N = 10^6, and the f32 decode at spambase's and
   reuters' shapes (d = 57, N = 4140; d = 9947, N = 2000); the
   voted-predict kernel at the serving shapes on both its routes (grouped
   at d <= 32, strided), in snapshot and gathered form (bitwise, with zero
   scores and exact-half ties); the send kernels for int8, int8_sr, int4,
   int4_ef, ternary and ternary_ef (bitwise, on rows of mixed-sign zeros
   and NaN too), each shape on the route ``send_route`` picks and, where
   that is the tiled one, against the strided route forced on the same
   models (bitwise); both send routes timed on the same models (and EF
   residuals) at N = 10^6 and d = 10, 32, 57 and 128 for every codec; the
   cosine_gate screen timed at N = 10^6; kernels #6 and #7
   (``pegasos_update``, ``merge_update``) at N = 10^6, d = 10 and 57, and
   N = 4096, d = 9947, driven ten steps each through ``kernels/ops.py``
   (every launch of both on the tiled layout) and timed at N = 10^6,
   d = 10, and each kernel's two layouts against each other and timed at
   N = 10^6, d = 10, 32, 57 and 128; kernel #8 (``flash_attention``) over
   head_dim 64, 128, 48 and 256, H/KV 1, 2 and 8, causal or not, window None
   or 64, S = 1, 37, 128, 300 and 2048, in float32 and bfloat16, and on
   strided and unaligned inputs (at head_dim 128 and 256), each case on
   the route it must take (bf16 at head_dim 64/128/256 on the tensor-core
   kernel, the rest on the CUDA-core kernel);
2. the sharded engine with the kernels against the port's reference engine
   on the card (N = 20 000, the paper's extreme scenario) on the f32 wire
   and on int8_sr, int4_ef and ternary, and the first chunk's threefry draw
   tables made on the card against the CPU's; then under Byzantine faults
   with a defense (fault counters equal too), and a run with a serving hook
   against one without (bit for bit) on both engines; and 200 000 float32
   ``random.normal`` draws made on the card bit for bit the CPU's;
3. the main path at full width: ``run_simulation(engine="sharded")`` at
   N = 10^6 nodes, d = 10, extreme scenario, MU, K = 4, cache 10, 20
   cycles; launches (all 20 on the receive kernel's grouped route), curves,
   the message economy, wall time, node-cycles/s and peak memory, then the
   receive kernel's time per launch on the main path's own inputs beside
   its bound, the strided route's and its plain version's time and its
   agreement with both there, and a profiled rerun; then the same run
   armed with a ``Telemetry`` (bit for bit the unarmed run, its metric
   streams summing to the run's totals) and unarmed once more: the armed
   wall time against both unarmed ones, the split of the host's time by
   span (``repro_torch.core.telemetry.SPAN_NAMES``), and the Chrome trace,
   written next to ``--out`` and read back by ``tools/trace_report.py``;
4. the same path on the quantized wire (int8_sr, int4_ef, ternary): for
   each, 20 receive and 20 send launches (the send launches all on the
   tiled route), the economy, the wire and buffer bytes against f32's, wall
   time, peak memory, and each kernel's time per launch on the path's own
   last-launch inputs beside its bound, the other route's time there (the
   strided one), and its plain version's time, and a profiled rerun;
5. the protocol under attack, served live: the phase-3 path with 10 %
   sign_flip Byzantine nodes and the norm_clip screen, and a
   ``GossipServer`` (batches of 256 on the voted-predict kernel) fed 2048
   test queries at each eval point: launches, fault counters, economy,
   node-cycles/s, the snapshot copies' time, queries/s, p50/p99 batch
   latency, served accuracy, peak memory, the screened receive kernel's
   and the voted-predict kernel's (M = 1, 256 and 65 536; its launches by
   route) time per launch beside their bounds (the voted-predict kernel's
   replayed from a CUDA graph, so that the host's cost of a call is left
   out, on its grouped route and its strided one, and also per call as
   the server makes it), and a profiled rerun; then the protocol and a
   new server armed on one ``Telemetry``: bit for bit the unarmed run and
   its answers, the server's histogram shared, the ``snapshot_adopt`` and
   ``serve_batch`` spans' totals;
6. LM serving at full width: the reduced qwen3-1.7b (f32) served on the
   card (kernel #8's CUDA-core route) against the same weights served on
   the CPU (its plain version), then qwen3-1.7b in bf16 with random
   weights from a seeded generator, ``DecodeServer(batch=4,
   max_len=4096)``, a fused prefill of a 2048-token prompt (28 launches of
   kernel #8, all on its tensor-core route) and 64 greedy decode steps:
   prefill and decode times and tokens/s, peak memory, a profiled rerun;
   kernel #8 on the path's own last-layer q, k, v beside its bound, its
   plain version and ``scaled_dot_product_attention``, and its CUDA-core
   route on the same q, k, v in float32 beside the float32 bound; and the
   same server on the plain attention path (``attn_impl="xla"``): prefill
   logits within a stated tolerance, the share of equal greedy tokens;
7. the compact packings and the vector apply: at N = 20 000 (extreme) on
   the f32, int8_sr, int4_ef and ternary wires and under sign_flip +
   norm_clip, the forced ``compact`` and ``compact_all`` runs and the cost
   model's choice bit for bit the forced dense run (curves, economy, fault
   counters, EF norm, the cache at every eval point), with kernel #1's
   launches by route (once a cycle, twice under ``compact``: K = 1 over
   all N, then K - 1 rounds over the gathered round-2 receivers) and
   #2-#4's on the senders' rows; kernel #2 with ``rows`` bitwise its plain
   version on both routes and the dense encode's rows; Adaline and
   logistic regression on the sharded engine (the vector apply) against
   the reference engine; then the three packings at N = 10^6, d = 10 in
   the extreme and sparse-d0.8-o0.1 scenarios, armed: wall time,
   node-cycles/s, the host's spans, launches, peak memory, bit for bit
   across packings, and kernel #1 on the last subset launch beside its
   bound;
8. the paper's experiments: the five drivers of ``repro_torch.paper``
   (Table I, Fig. 1-3, Theorem 1) at their quick settings, then Fig. 1's
   failure-free MU run on spambase and reuters (each against the port's
   reference engine on the card: economy equal, curves within 0.02) and
   its WB1/WB2 over 2000 models on reuters (against the same run on the
   CPU: indices and t equal, W within ``BAGGING_W_RTOL`` of max |W|,
   curves within 0.02); every protocol run's economy adding up, kernel #1
   once a cycle, kernel #6 once a bagging cycle and once a chain
   iteration on the layout ``ROW_PATHS`` names, Theorem 1 holding on every
   geometry; #6 on each path's last-launch inputs (replayed from a CUDA
   graph, beside a call's time, the other layout's and the plain
   version's) and #1 on the MU runs' beside their bounds, and the
   phase's seconds;
9. gossip-SGD training: ``repro_torch.launch.train.train`` at its reduced
   default on the card (all-reduce, then gossip with 4 peers, mu,
   hypercube, AdamW; the loss and peer disagreement each step, finite and
   falling); qwen3-1.7b at its published widths with the depth cut to 8
   layers (4 if the peak passes 72 GB), 4 peers, batch 8 x 128, AdamW,
   ``make_gossip_train_step`` under mu (int4 exchange), um (int8) and rw:
   each step's loss, disagreement and split (fwd+bwd, optimizer, merge,
   exchange), a profiled fourth mu step, each run's peak memory; then on
   those stacked parameters one
   ``gossip_merge`` per codec (bf16, int8, int4, ternary, int4_ef), each
   bit for bit the merge with the codec's plain encode on the card, send
   kernels #2 and #4 launched once a leaf (counted from the start of the
   full-width runs), one whole exchange timed per codec, and #2 and #4 on
   every leaf's rows beside their plain versions and bounds;
10. the moe, ssm and hybrid families: each of mixtral-8x22b,
   llama4-scout-17b-a16e, recurrentgemma-9b and mamba2-780m reduced (f32)
   served on the card against the same weights on the CPU (logits within
   phase 6's tolerance, greedy tokens equal); then each at its published
   widths in bf16 (mamba2 in f32) with random weights from a seeded
   generator, the depth cut (``FAMILY_RUNS``): mixtral at 4 of 56 layers,
   ``DecodeServer(batch=2, max_len=8192)``, a 4608-token prompt past its
   4096 window (the window bites in kernel #8 and the KV ring wraps), 4
   launches of #8 all on ``tensor_core``, 32 greedy steps; llama4-scout at
   4 of 48 layers, top-1, 512 tokens, 8 steps; recurrentgemma at 5 of 38
   layers (one rglru, rglru, local period and the two-rglru tail), 3072
   tokens past its 2048 window at batch 2, #8 once on ``tensor_core``
   (bf16, hd 256, one kv head, 64-key tiles), 32 steps; mamba2 whole (48
   layers), batch 4 x
   2048, 32 steps, no kernel. Each run's prefill and decode times and
   tokens/s and peak memory; where it has attention, the same server on
   the plain path (``attn_impl="xla"``): the expert choices that differ
   between the two prefills counted, the prefill logits within
   ``LM_PATH_LOGIT_TOL`` with the kernel path's choices pinned on the
   plain path (equal to the unpinned comparison where none differ), the
   share of equal greedy tokens; #8 on the run's last attention layer's
   q, k, v beside its bound, its plain version and
   ``scaled_dot_product_attention`` with the band as a boolean mask, and
   at recurrentgemma's shape the CUDA-core route forced on the same q, k,
   v in the same call (``FAMILY_FORCED_ROUTES``);
11. the audio and vlm families: whisper-medium and llama-3.2-vision-11b
   reduced (f32, every cross layer's gates set to seeded values in
   [0.3, 1): at their init of zero a cross layer adds nothing) served on
   the card against the same weights on the CPU (logits within phase 6's
   tolerance, greedy tokens equal; the 100-token prompt runs past
   whisper's 64 reduced positions); then each whole at its published
   widths with random weights from a seeded generator (``ENCDEC_RUNS``,
   through ``family_run``): whisper-medium, 24 encoder and 24 decoder
   layers in f32 weights and bf16 compute, ``DecodeServer(batch=4,
   max_len=448)`` with its 1500 frames drawn from key 0 as the
   reference's server draws them, a 256-token prompt, 64 greedy steps and
   no launch of #8 (the reference routes whisper's attention to the plain
   path); llama-3.2-vision-11b, 40 layers in bf16, the gates set,
   ``DecodeServer(batch=2, max_len=2048)`` with its 1601 patches, a
   1024-token prompt, 32 launches of #8 all on ``tensor_core``, 32 greedy
   steps, the same server on ``attn_impl="xla"`` (prefill logits within
   ``LM_PATH_LOGIT_TOL``, the share of equal greedy tokens) and #8 on the
   last self-attention layer's q, k, v beside its bound, its plain
   version and ``scaled_dot_product_attention``. Each run's prefill and
   decode times and tokens/s and peak memory;
12. llama3-405b served and the new families trained: (a) llama3-405b at
   its published widths (d_model 16 384, 128 q over 8 kv heads of 128,
   untied 128 256 vocab) with the depth cut to 4 of 126 layers (3 if the
   peak passes ``BIG_PEAK_LIMIT``), bf16, through ``family_run``:
   ``DecodeServer(batch=2, max_len=4096)``, a 2048-token prompt, 4
   launches of #8 all on ``tensor_core`` at GQA 16:1, 16 greedy steps,
   against its ``attn_impl="xla"`` run (prefill logits within
   ``LM_PATH_LOGIT_TOL``, the share of equal greedy tokens), #8 on the
   last layer's q, k, v beside its bound, its plain version and
   ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)``; the
   prefill's model FLOPs (``launch/roofline.py``, 2 N D: the embedding
   counted and the head over every token) over its wall and
   ``PEAK_FLOPS_BF16``, and the same prefill's matmul FLOPs counted on
   ``meta`` tensors against them and over the wall and the peak (the
   tensor cores' utilization); (b) mamba2-780m whole (f32, AdamW), recurrentgemma-9b at
   one period (3 layers) and mixtral-8x22b at 1 layer (bf16,
   SGD-momentum) trained by ``launch.train.train`` at their published
   widths: gossip over 2 peers, mu, the int8 exchange (kernel #2 once a
   leaf a merge, counted from 0 at each run's start), 3 steps of batch
   4 x 256: each step's split (fwd+bwd, optimizer, merge), the peak, the
   first loss against ln(vocab), then #2 held bit for bit to its plain
   version on every distinct (rows, d) shape of the run's final
   parameters stacked for the peers; (c) each of the moe, ssm and hybrid
   families reduced, 5 gossip steps (``make_gossip_train_step`` as
   ``train()`` builds it, int8 exchange) on the card and on the CPU from
   the CPU's seeded weights, losses within ``REDUCED_TRAIN_RTOL``;
13. the protocol across ranks: ``MESH_RANKS`` = 2 processes share the
   card over a gloo group (``launch.mesh.run_ranks``; NCCL refuses two
   ranks on one device, so the exchange stages through host memory and
   the phase measures what it costs, not how the protocol scales). (a)
   The node mesh: phase 3's path on the f32 wire and on int8_sr, 500,000
   nodes a rank, every count set to 0 in each rank just before its run
   and read just after: #1 launched 20 times on each rank (all
   ``grouped``) and #2 20 times on int8_sr, with the block's global rows;
   each rank's economy, curves, fault counters and EF norm, and every
   node's final lanes (``final_state``, hashed), bit for bit the
   one-process run (rerun here with ``final_state=True`` and itself equal
   to phase 3's and 4's); each rank's wall, the exchange's all-to-all
   bytes and seconds (``sharding.compat.STATS``), the eval's gathers, the
   router's seconds against a broadcast of its winners from rank 0, and
   #1 and #2 on rank 0's last launch (a shard of 500,000 rows) beside
   their plain versions and bounds; (b) the peer mesh: qwen3-1.7b's widths
   at 2 layers (f32), 2 peers as 2 ranks, batch 2 x 128, 3 gossip steps
   of mu on the int8 exchange (#2 on every leaf on each rank) and 1 of
   rw, SGD without a clip, against the stacked 2-peer step in each rank's
   process: losses within ``PEER_LOSS_RTOL``, each leaf bit for bit (a
   leaf that differs fails the phase, its max abs difference printed); (c) ``linear_gossip_mesh_step``, 10 cycles (mu
   with drops, um, rw), bit for bit the one-process cycles;
14. the LM across ranks (``launch/specs.py``'s step builders on DTensor,
   the ranks sharing the card over gloo, DTensor's collectives staged
   through pinned host memory), each rank against a one-process run of
   the same seeded weights in its own process: (a) qwen3-1.7b whole
   (bf16), tensor parallel on a (1, 2) ``("data", "model")`` mesh, the
   fused prefill of 4 x 2048 tokens through ``build_prefill_step`` and 16
   greedy steps through ``build_decode_step(profile="context")``: the
   prefill logits within ``LM_PATH_LOGIT_TOL``, 28 launches of #8 a rank
   on its 8 query and 4 kv heads (timed on rank 0's last, beside its
   plain version, its bound and SDPA), the share of equal greedy tokens,
   each rank's prefill wall, decode ms/step, collectives and peak; (b)
   mixtral-8x22b at 1 of 56 layers, 2 x 4608 tokens on (2, 2), G = 2 and
   the reduce combine on every rank, the expert choices pinned to the
   one-process run's, logits within ``LM_PATH_LOGIT_TOL``; (c) qwen3-1.7b
   at 2 layers, one ``build_train_step`` step at step 50: all-reduce
   (AdamW, FSDP on (2, 1)) and gossip (mu, int8, SGD on (2, 2); #2 once a
   leaf on each rank's local rows, held bit for bit to its plain version
   and timed on rank 0), within ``TRAIN_LOSS_RTOL`` and
   ``TRAIN_PARAM_FRAC`` of the one-process steps.
15. everything under a mesh (2 ranks sharing the card over gloo): (a)
   phase 5's served population on a ``("nodes",)`` mesh, armed, a
   ``GossipServer`` on each rank's shard (the cache never gathered):
   every voted and fresh answer, the curves, the economy, the fault
   counters and every stream bit for bit phase 5's armed one-process
   run, #1 and #5 on each shard (timed on rank 0's), each rank's span
   split; phase 4's int4_ef armed, its EF residual within
   ``EF_MESH_RTOL`` of a one-process armed run (bit for bit said where
   so), #3 timed on rank 0's shard; (b) mamba2-780m (4 of 48 layers),
   recurrentgemma-9b (one period), whisper-medium (2 encoder and 2
   decoder layers, 1500 frames, a 256-token prompt inside its 448
   positions) and llama-3.2-vision-11b (one period, 1601 patches) at
   their published widths (mamba2 computing in float32), tensor parallel
   on (1, 2): a fused prefill of 2 x 1024 tokens (whisper 2 x 256) and 8
   greedy steps each, prefill logits within
   ``LM_PATH_LOGIT_TOL`` of the one-process run, #8 on the ranks' local
   heads (hd 256 with the one kv head replicated; the vision model's
   16 of 32 query and 4 of 8 kv heads) timed on rank 0's against its
   bound and SDPA, the collectives and each rank's peak.

Prints one JSON line of per-kernel results (with phase 3's armed seconds
by span under ``"phase3_spans"``), the ``nvidia-smi`` name and power
limit, and last ``{"ok": true, "device": {...}}``. Exits non-zero,
printing no result, without a CUDA device or outside a checkout.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
# H100 SXM float32 outside the tensor cores (an FMA counted as two
# operations): 132 SMs x 128 FP32 lanes x 2 x 1.98 GHz
F32_FLOPS_PER_S = 67e12
# H100 SXM integer instructions: Hopper has 64 INT32 lanes an SM against
# 128 FP32 lanes (NVIDIA's Hopper architecture white paper), so half the
# FP32 lanes' rate at the clock the data sheet's 67 TFLOP/s implies; an
# integer multiply-add (IMAD, which the compiler also uses for adds and
# moves) issues on the FMA pipe at F32_FLOPS_PER_S / 2 instructions a second
INT32_OPS_PER_S = F32_FLOPS_PER_S / 4
FMA_PIPE_OPS_PER_S = F32_FLOPS_PER_S / 2
INT_FIELDS = ("last_t", "cache_t", "ptr", "count")
STATE = ("last_w", "last_t", "cache_w", "cache_t", "ptr", "count")
ORDER = STATE + ("msg_w", "msg_t", "valid", "x", "y")
META = ("msg_scale", "msg_zp")
# phase 1's receive shapes (N, d, C, K, atol): the paper's d = 10, 57 and
# 9947 (atol 1e-4 there: the margin is summed in another order), the
# grouped route's lane groups at d = 1, 7, 16 (K > C) and 32, and K = 9,
# past the grouped route's rounds
RECEIVE_SHAPES = ((4099, 10, 10, 4, 1e-5), (4099, 57, 10, 4, 1e-5),
                  (2000, 9947, 10, 4, 1e-4), (257, 16, 3, 5, 1e-5),
                  (4099, 1, 10, 4, 1e-5), (4099, 7, 10, 4, 1e-5),
                  (4099, 32, 10, 4, 1e-5), (1031, 10, 3, 9, 1e-5))
# the paper's other datasets (configs/gossip_linear.py), timed at their
# own N: (name, N, d, atol)
PAPER_SHAPES = (("spambase", 4140, 57, 1e-5), ("reuters", 2000, 9947, 1e-4))
# the receive kernel's decode modes, each with a codec that selects it
DECODE_WIRES = {"bf16": "bf16", "f16": "f16", "affine8": "int8",
                "int4": "int4", "ternary": "ternary"}
SEND_CODECS = ("int8", "int8_sr", "int4", "int4_ef", "ternary", "ternary_ef")
# the codecs without and with error feedback (the tiled send route serves
# both), and the widths at which phase 1 times the tiled route against the
# strided one
TILED_CODECS = ("int8", "int8_sr", "int4", "ternary")
EF_CODECS = ("int4_ef", "ternary_ef")
SEND_SWEEP_WIDTHS = (10, 32, 57, 128)
# phase 1's send shapes (N, d): the paper's d = 10, 57 and 9947, the tiled
# route's ragged tiles (N not a multiple of its rows) at d = 1, 7, 16, 32
# and 57, and N below one tile
SEND_SHAPES = ((4099, 10), (4099, 57), (2000, 9947), (257, 1), (257, 7),
               (1031, 16), (4099, 32), (255, 10), (4097, 57))
DEFENSE_MODES = ("norm_clip", "cosine_gate")
# the screen's sum orders (f32, mu): past d = 32, on the strided route, two
# halves at 33-64, 32-wide chunks at multiples of 32, and a width whose
# order is not known (butterflies); at d = 6 and 8 the nodes the jitted
# reference sums unfused (faults.screen_split: on an 8-CPU host every node
# fused at N = 20 003, a vector loop in each of three workgroups at
# N = 40 001), on both routes; (N, d)
SCREEN_ORDER_SHAPES = ((4099, 33), (4099, 64), (4099, 96), (2000, 100),
                       (2000, 128), (20_003, 6), (40_001, 8))
# the screens are checked after each decode family: f32, affine int8,
# int4 and ternary
SCREEN_WIRES = {"affine8": "int8", "int4": "int4", "ternary": "ternary"}
VOTED_SHAPES = ((256, 10, 10), (4099, 10, 57), (64, 10, 9947),
                (65_536, 10, 10))
# phase 5's voted-predict batches: one query's chain, the server's batch,
# and a large one
VOTED_BATCHES = (1, 256, 65_536)
# phase 2's fault runs (fault model, wire, defense) at N = 20 000
FAULT_RUNS = (("sign_flip", None, "norm_clip"),
              ("sign_flip", None, "cosine_gate"),
              ("random_payload", "int8_sr", "cosine_gate"),
              ("stale_replay", "int8_sr", "norm_clip"),
              ("bitflip", "int4_ef", "norm_clip"))
MAIN_WIRES = ("int8_sr", "int4_ef", "ternary")
# rows #2-#4 of the TPU-kernel table in PERF.md: each send kernel and the
# Pallas call it replaces (phase 4 drives them with MAIN_WIRES in order)
SEND_ROWS = {
    "affine8": "src/repro/kernels/gossip_cycle.py:422",
    "packed_ef": "src/repro/kernels/gossip_cycle.py:446",
    "packed": "src/repro/kernels/gossip_cycle.py:457",
}
# rows #6 and #7: the population kernels through kernels/ops.py, and the
# Pallas calls they replace
ROW_KERNELS = {"pegasos_update": "src/repro/kernels/pegasos_update.py:63",
               "merge_update": "src/repro/kernels/gossip_merge.py:48"}
ROW_STEPS = 10          # steps a phase-1 run of each takes through ops.py
ROW_SHAPES = ((1_000_000, 10), (1_000_000, 57), (4096, 9947))
# the widths at which phase 1 times #6's and #7's tiled layouts against
# their strided ones (N = 10^6)
ROW_SWEEP_WIDTHS = (10, 32, 57, 128)
# row #8, its two routes' sources, and the shapes of phase 1's sweep of it
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:121"
FLASH_SOURCES = {
    "tensor_core": "src/repro_torch/kernels/csrc/flash_attention_hopper.cu",
    "cuda_core": "src/repro_torch/kernels/csrc/flash_attention.cu"}
FLASH_HEAD_DIMS = (64, 128, 48, 256)
FLASH_GROUPS = (1, 2, 8)                 # H / KV
FLASH_SEQS = (1, 37, 128, 300, 2048)
# H100 SXM dense bf16 on the tensor cores: the least time of attention's
# products in bf16, whatever units a kernel runs them on
BF16_FLOPS_PER_S = 989e12
# phase 6: the serving configuration
LM_ARCH, LM_BATCH, LM_MAX_LEN, LM_PROMPT, LM_STEPS = (
    "qwen3-1.7b", 4, 4096, 2048, 64)
# the kernel path's prefill logits against the plain attention path's: bf16
# activations, and the two paths order and round P V differently, which
# 28 layers amplify. Measured 0.033 at a largest |logit| of 4.5 on an H100
# with the CUDA-core kernel (p in float32); the bound is 3x.
LM_PATH_LOGIT_TOL = 0.1
# phase 10: the moe, ssm and hybrid families at their published widths,
# the depth cut to fit the card and the phase's budget: (arch, layers,
# batch, max_len, prompt, greedy steps, kernel #8's route; None: no
# attention). mixtral's and recurrentgemma's prompts pass their windows
# (4096 and 2048), so #8's window bites and the KV rings wrap.
FAMILY_RUNS = (
    ("mixtral-8x22b", 4, 2, 8192, 4608, 32, "tensor_core"),
    ("llama4-scout-17b-a16e", 4, 2, 1024, 512, 8, "tensor_core"),
    ("recurrentgemma-9b", 5, 2, 4096, 3072, 32, "tensor_core"),
    ("mamba2-780m", 48, 4, 4096, 2048, 32, None),
)
# phase 11: the audio and vlm families whole, in FAMILY_RUNS' form.
# whisper's attention never reaches #8 (the reference routes it to the
# plain path); the vision model's 32 self-attention layers do
ENCDEC_RUNS = (
    ("whisper-medium", 24, 4, 448, 256, 64, None),
    ("llama-3.2-vision-11b", 40, 2, 2048, 1024, 32, "tensor_core"),
)
# the runs whose #8 launches stand in the kernels line as rows of their
# own: windowed GQA, hd 256 MQA (64-key tiles), the vision model's causal
# GQA beside its cross layers, all on the tensor cores
FAMILY_ROWS = {"mixtral-8x22b": "windowed_gqa",
               "recurrentgemma-9b": "hd256_mqa",
               "llama-3.2-vision-11b": "vlm",
               "llama3-405b": "gqa16"}
# the runs whose library time is scaled_dot_product_attention's own causal
# path (is_causal=True, enable_gqa=True) rather than the band as a mask
CAUSAL_SDPA = ("llama3-405b", "qwen3-1.7b[tp]")
# the other route of #8 forced on a run's captured q, k, v and timed in the
# same call: hd 256 bf16 ran on the CUDA cores before its tensor-core tiles
FAMILY_FORCED_ROUTES = {"recurrentgemma-9b": "cuda_core"}
# phase 7: the packings (core/sharded_engine.py's PACKINGS), the wire and
# fault mixes they run at N = 20 000 against the dense run, the scenarios
# timed at N = 10^6, the learners of the vector apply, and kernel #2's
# ``rows`` shapes (senders, d, population; d = 4500 puts the noise's
# positions past 2^32)
PACKINGS = ("dense", "compact", "compact_all")
PACKING_MIXES = ((None, None, "none"), ("int8_sr", None, "none"),
                 ("int4_ef", None, "none"), ("ternary", None, "none"),
                 (None, "sign_flip", "norm_clip"))
PACKING_SCENARIOS = ("extreme", "sparse-d0.8-o0.1")
VECTOR_LEARNERS = ("adaline", "logistic")
SEND_ROWS_SHAPES = ((20_000, 10, 1_000_000), (3_000, 4500, 1_000_000))


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_time_ms(fn, reps: int, replays: int = 5) -> float:
    """ms per call of ``fn``, ``reps`` calls captured in one CUDA graph and
    the graph replayed: the device's time for launches already queued,
    without the host's cost of making each call."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (reps * replays)
    del graph
    return ms


def receive_inputs(seed, n, d, c, k, device, wire=None, crafted=False):
    """A mid-run state with a random valid mask, made with numpy. With
    ``wire``, the messages are that codec's payload (encoded by the port's
    plain codec on ``device``), with ``msg_scale``/``msg_zp`` where the
    codec carries them. ``crafted`` adds rows for the defense screens
    (``craft_screen_rows``)."""
    import numpy as np
    import torch
    from repro_torch.core.wire_codec import get_codec
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)
    i = lambda lo, hi, *s: rng.integers(lo, hi, size=s, dtype=np.int32)
    arrs = dict(
        last_w=f(n, d), last_t=i(0, 40, n), cache_w=f(n, c, d),
        cache_t=i(0, 40, n, c), ptr=i(1, 3 * c, n), count=i(1, c + 1, n),
        msg_w=f(k, n, d) * 3, msg_t=i(0, 40, k, n),
        valid=(rng.random((k, n)) < 0.6).astype(np.int32), x=f(n, d),
        y=np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32))
    bad_rows = craft_screen_rows(arrs) if crafted else None
    out = {key: torch.from_numpy(v).to(device) for key, v in arrs.items()}
    if wire is not None:
        q, sc, zp = get_codec(wire).encode(out["msg_w"])
        out["msg_w"] = q
        out.update({k_: v for k_, v in zip(META, (sc, zp)) if v is not None})
    if bad_rows is not None and bad_rows.size:
        # non-finite messages: in the payload of a float wire, through the
        # f16 scale of a quantized one
        r = torch.from_numpy(bad_rows).to(device)
        if "msg_scale" in out:
            out["msg_scale"][0, r[0::2]] = float("inf")
            out["msg_scale"][0, r[1::2]] = float("nan")
        else:
            out["msg_w"][0, r[0::2], 0] = float("inf")
            out["msg_w"][0, r[1::2], -1] = float("nan")
    return out


def craft_screen_rows(arrs):
    """Rows that reach every verdict of the defense screens, written into
    the numpy inputs in place (six blocks of nodes from node 0, each
    block's rounds all valid): an oversized message (clipped) followed by
    more rounds (merged against the rescaled lastModel); a zero lastModel
    with messages above and below the floor of 1; a message anti-aligned
    with lastModel (gated by cosine_gate); a subnormal message of the
    opposite sign to lastModel (flushed by the screen, so not gated).
    Returns the rows of the fifth block, which get a non-finite message in
    round 0 once the payload is encoded."""
    import numpy as np
    lw, msg, valid = arrs["last_w"], arrs["msg_w"], arrs["valid"]
    n, d = lw.shape
    b = min(16, n // 6)
    if b == 0:
        return np.zeros(0, np.int64)
    big, zero_lw, anti, tiny, bad, _ = (np.arange(j * b, (j + 1) * b)
                                        for j in range(6))
    valid[:, :6 * b] = 1
    msg[0, big] *= 1e3                        # clipped, then round 1
    lw[zero_lw] = 0.0                         # the floor thr = 1
    msg[0, zero_lw[::2]] = 0.1 / np.sqrt(d)   # norm 0.1: passes
    msg[0, anti] = -lw[anti]                  # cos = -1
    msg[0, tiny] = np.where(lw[tiny] > 0, -1e-40, 1e-40).astype(np.float32)
    return bad


def compare_kernel(inputs, variant, lam, atol, rtol=1e-5, wire=None,
                   defense="none"):
    """Run the kernel and the plain version on copies of ``inputs`` on the
    card; integer state and the screen's gated/clipped counts must be
    equal, float state within tolerance, and under a screen lastModel (the
    screened, possibly rescaled message) bit for bit where the screen's
    sums take a known order (``faults.screen_order_known``), which both
    take. Returns the max abs error over the float state and the (gated,
    clipped) totals."""
    import torch
    from repro_torch.core import faults
    from repro_torch.kernels import gossip_cycle as gc
    a = {k: v.clone() for k, v in inputs.items()}
    b = {k: v.clone() for k, v in inputs.items()}
    kw = dict(variant=variant, lam=lam, wire=wire, defense=defense)
    out = gc.fused_receive_apply(*(a[k] for k in ORDER),
                                 **{k: a[k] for k in META if k in a}, **kw)
    want = gc.fused_receive_apply_plain(
        *(b[k] for k in ORDER), **{k: b[k] for k in META if k in b}, **kw)
    torch.cuda.synchronize()
    for label, g, p in zip(("gated", "clipped"), out[6:], want[6:]):
        if not torch.equal(g, p):
            bad = int((g != p).sum())
            raise AssertionError(f"{variant} {defense}: {label} counts "
                                 f"differ in {bad} nodes")
    counts = (int(want[6].sum()), int(want[7].sum()))
    if (defense != "none" and faults.screen_order_known(a["x"].shape[1])
            and not torch.equal(a["last_w"].view(torch.int32),
                                b["last_w"].view(torch.int32))):
        bad = int((a["last_w"] != b["last_w"]).any(dim=1).sum())
        raise AssertionError(f"{variant} {defense}: lastModel differs from "
                             f"the plain version's in {bad} nodes")
    err = 0.0
    for k in STATE:
        if k in INT_FIELDS:
            if not torch.equal(a[k], b[k]):
                bad = int((a[k] != b[k]).sum())
                raise AssertionError(f"{variant}: {k} differs in {bad} "
                                     "entries")
        else:
            if not torch.isfinite(a[k]).all():
                raise AssertionError(f"{variant}: {k} not finite")
            err = max(err, float((a[k] - b[k]).abs().max()))
            if not torch.allclose(a[k], b[k], rtol=rtol, atol=atol):
                raise AssertionError(f"{variant}: {k} off by {err}")
    return err, counts


def run_route(inputs, variant, lam, wire=None, defense="none", route=None):
    """The receive kernel on copies of ``inputs``, on ``route`` (None: the
    route ``receive_route`` picks, through the public wrapper; else forced
    through the private launch). Returns the state and counts, and the
    route each launch took."""
    from repro_torch.kernels import gossip_cycle as gc
    a = {k: v.clone() for k, v in inputs.items()}
    kw = dict(variant=variant, lam=lam, wire=wire, defense=defense)
    before = dict(gc.fused_receive_apply.route_launches)
    if route is None:
        out = gc.fused_receive_apply(*(a[k] for k in ORDER),
                                     **{k: a[k] for k in META if k in a},
                                     **kw)
        counts = out[6:]
    else:
        mode = gc._check_receive(*(a[k] for k in ORDER), a.get("msg_scale"),
                                 a.get("msg_zp"), wire, variant, defense)
        counts = gc._launch_receive(*(a[k] for k in ORDER),
                                    a.get("msg_scale"), a.get("msg_zp"),
                                    mode, variant, float(lam), defense,
                                    route=route)
    took = [r for r, n in gc.fused_receive_apply.route_launches.items()
            if n != before[r]]
    return a, counts, took


def compare_routes(inputs, variant, lam, wire=None, defense="none"):
    """The route ``receive_route`` picks for these shapes against the
    strided route forced on the same inputs: every state tensor (floats
    by their bits), cache_t and the gated and clipped counts equal.
    Returns the route taken."""
    import torch
    from repro_torch.kernels import gossip_cycle as gc
    k, _, _ = inputs["msg_w"].shape
    d = inputs["x"].shape[1]
    want = gc.receive_route(d, k)
    a, ca, took = run_route(inputs, variant, lam, wire, defense)
    if took != [want]:
        raise AssertionError(f"receive d={d} K={k}: took {took}, not "
                             f"{want}")
    b, cb, _ = run_route(inputs, variant, lam, wire, defense, "strided")
    torch.cuda.synchronize()
    bits = lambda t: t.view(torch.int32) if t.is_floating_point() else t
    for label, x, y in [(key, a[key], b[key]) for key in STATE] + list(
            zip(("gated", "clipped"), ca, cb)):
        if not torch.equal(bits(x), bits(y)):
            bad = int((bits(x) != bits(y)).sum())
            raise AssertionError(f"receive {want} vs strided, {variant} "
                                 f"{defense} d={d} K={k}: {label} differs "
                                 f"in {bad} entries")
    return want


def voted_inputs(seed, m, c, d, device):
    """A snapshot of M nodes and M queries, made with numpy: w (M, C, d),
    count (M,) in [1, C], X (M, d) and assign (M,) (with repeats). Node 0
    holds an all-zero cache (every score 0, votes +1); nodes 1 and 2 hold
    count 2 with one positive and one negative score for every query
    assigned to them (p_ratio exactly 0.5, answered +1); node 3 count 4
    with one positive score (0.25, answered -1). Queries 0-3 are assigned
    to nodes 0-3, and copies of X[1], X[2], X[3] steer the slots."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((m, c, d), dtype=np.float32)
    count = rng.integers(1, c + 1, size=m, dtype=np.int32)
    X = rng.standard_normal((m, d), dtype=np.float32)
    assign = rng.integers(0, m, size=m, dtype=np.int32)
    assign[:4] = np.arange(4)
    w[0] = 0.0
    for node in (1, 2):
        count[node] = 2
        w[node, 0], w[node, 1] = X[node], -X[node]
    count[3] = 4
    w[3, 0], w[3, 1:4] = X[3], -X[3]
    t = lambda a: torch.from_numpy(a).to(device)
    return t(w), t(count), t(X), t(assign)


def voted_routes(d: int, c: int):
    """The voted-predict kernel's routes that take (d, C): ``voted_route``'s
    first, then the strided one where that is another."""
    from repro_torch.kernels import voted_predict as vp
    route = vp.voted_route(d, c)
    return (route,) if route == "strided" else (route, "strided")


def compare_voted(w, count, X, assign):
    """The voted-predict kernel against its plain version on the card, on
    the snapshot rows (``assign``) and on the gathered rows (the TPU
    kernel's form: ``assign = arange(M)``), through the wrapper (the route
    ``voted_route`` picks) and on the strided route forced where that is
    another: answers must be equal bit for bit. Returns the answers."""
    import torch
    from repro_torch.kernels import voted_predict as vp
    a = assign.long()
    want = vp.voted_predict_batched_plain(w[a], count[a], X)
    rows = torch.arange(len(a), dtype=torch.int32, device=a.device)
    _, c, d = w.shape
    for form in ((w, count, X, assign),
                 (w[a].contiguous(), count[a].contiguous(), X, rows)):
        for route in voted_routes(d, c):
            got = (vp.voted_predict_batched(*form)
                   if route == vp.voted_route(d, c) else
                   vp._launch(*form, route=route))
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int32),
                               want.view(torch.int32)):
                bad = int((got != want).sum())
                raise AssertionError(
                    f"voted_predict_batched ({route}) differs from the plain "
                    f"version in {bad} of {len(want)} answers")
    return want


def send_inputs(seed, n, d, device):
    """(N, d) fresh models and an EF residual, made with numpy, with rows
    that reach the codecs' edge cases: all zero (scale 0), constant, codes
    on .5 ties, a saturating f16 scale, f16-subnormal scales, zeros of both
    signs (the affine range orders -0.0 below +0.0), all -0.0, and a NaN."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, d), dtype=np.float32) * 3
    w[0] = 0.0
    w[1] = 0.75
    w[2] = np.round(w[2] * 2) / 2
    w[3] *= 1e5
    w[4] *= 1e-6
    w[5] = np.where(np.arange(d) % 2 == 0, -0.0, 0.0)
    w[6] = -0.0
    w[7, d // 2] = np.nan
    ef = rng.standard_normal((n, d), dtype=np.float32) * 0.2
    return torch.from_numpy(w).to(device), torch.from_numpy(ef).to(device)


def run_send(w, name, key=None, ef=None, route=None, rows=None):
    """``quantize_send`` on the card with ``route`` forced (``send_route``'s
    choice when None), through the wrapper's own checks."""
    from repro_torch.kernels import gossip_cycle as gc
    codec = gc._check_send(w, name, key, ef, rows)
    return gc._launch_send(w, codec, key, ef, route=route, rows=rows)


def same_outputs(name, label, got, want, what):
    """Each output of ``got`` equal to ``want``'s bit for bit."""
    import torch
    for lab, g, p in zip(label, got, want):
        if g.dtype != p.dtype or g.shape != p.shape:
            raise AssertionError(f"{name}: {lab} is {g.dtype} "
                                 f"{tuple(g.shape)}, {what} {p.dtype} "
                                 f"{tuple(p.shape)}")
        if not torch.equal(g.contiguous().view(torch.uint8),
                           p.contiguous().view(torch.uint8)):
            bad = int((g.view(torch.uint8) != p.view(torch.uint8)).sum())
            raise AssertionError(f"{name}: {lab} differs from the {what} in "
                                 f"{bad} bytes")


def compare_send(name, w, ef, key):
    """Run the send kernel on the route ``send_route`` picks and its plain
    version on the card on the same inputs, and, where that route is
    ``tiled``, the strided route forced on them too; every output (codes or
    packed bytes, scale, zero-point, residual) must be equal bit for bit.
    Returns the outputs' names and the route taken."""
    import torch
    from repro_torch.core.wire_codec import get_codec
    from repro_torch.kernels import gossip_cycle as gc
    codec = get_codec(name)
    kw = dict(key=key if codec.stochastic else None,
              ef=ef if codec.ef else None)
    route = gc.send_route(w.shape[1], name, gc.send_aligned(w, kw["ef"]))
    before = dict(gc.quantize_send.route_launches)
    got = gc.quantize_send(w, name, **kw)
    if gc.quantize_send.route_launches != dict(
            before, **{route: before[route] + 1}):
        raise AssertionError(f"{name}: quantize_send did not launch the "
                             f"{route} route")
    want = gc.quantize_send_plain(w, name, **kw)
    torch.cuda.synchronize()
    names = (("q", "scale", "zp") if codec.has_zp
             else ("payload", "scale", "resid")[:len(want)])
    same_outputs(name, names, got, want, "plain version")
    if route == "tiled":
        same_outputs(name, names, got, run_send(w, name, route="strided",
                                                **kw), "strided route")
    return names, route


def compare_engines(cfg, X, y, n: int, device, **kw):
    """Run the port's reference engine and its sharded engine (the kernels
    on the card) on the same inputs: the receive kernel, and on a quantized
    wire the codec's send kernel, must launch once a cycle; both economies
    add up and agree exactly, as do the fault counters (Byzantine sends,
    gated and clipped messages), the wire and buffer bytes agree, the
    curves agree within 0.02 and the EF residual norms within rtol 1e-4.
    Returns the sharded result, the max curve difference and the reference
    result."""
    from repro_torch.core.simulation import run_simulation
    from repro_torch.core.wire_codec import get_codec
    from repro_torch.kernels import gossip_cycle as gc
    codec = get_codec(cfg.wire_dtype)
    args = (cfg, X[:n], y[:n], X[n:], y[n:])
    ref = run_simulation(*args, engine="reference", device=device, **kw)
    before = gc.fused_receive_apply.launches
    sends = dict(gc.quantize_send.launches)
    sh = run_simulation(*args, engine="sharded", device=device, **kw)
    launches = gc.fused_receive_apply.launches - before
    if launches != kw["cycles"]:
        raise AssertionError(f"sharded engine launched the kernel {launches} "
                             f"times in {kw['cycles']} cycles")
    if codec.quantized:
        kernel = gc.send_kernel_name(codec.name)
        sent = gc.quantize_send.launches[kernel] - sends[kernel]
        if sent != kw["cycles"]:
            raise AssertionError(f"sharded engine launched the {kernel} send "
                                 f"kernel {sent} times in {kw['cycles']} "
                                 "cycles")
    econ = lambda r: (r.sent_total, r.delivered_total, r.lost_total,
                      r.overflow_total, r.in_flight_total,
                      list(r.delivered_per_cycle))
    for r in (ref, sh):
        if r.sent_total != (r.delivered_total + r.lost_total
                            + r.overflow_total + r.in_flight_total):
            raise AssertionError("message economy does not add up")
    if econ(ref) != econ(sh):
        raise AssertionError(f"economy differs: {econ(ref)[:5]} vs "
                             f"{econ(sh)[:5]}")
    if ref.fault_stats != sh.fault_stats:
        raise AssertionError(f"fault counters differ: {ref.fault_stats} vs "
                             f"{sh.fault_stats}")
    if (ref.wire_bytes_total, ref.buf_payload_bytes) != (
            sh.wire_bytes_total, sh.buf_payload_bytes):
        raise AssertionError("wire or buffer bytes differ")
    if ref.cycles != sh.cycles:
        raise AssertionError("eval points differ")
    curve_diff = max(abs(a - b) for a, b in zip(
        ref.err_fresh + ref.err_voted, sh.err_fresh + sh.err_voted))
    if not curve_diff <= 0.02:
        raise AssertionError(f"curves differ by {curve_diff}")
    ef_ref, ef_sh = ref.ef_residual_norm, sh.ef_residual_norm
    if codec.ef and not (ef_ref > 0 and abs(ef_sh - ef_ref)
                         <= 1e-4 * ef_ref):
        raise AssertionError(f"EF residual norms differ: {ef_sh} vs "
                             f"{ef_ref}")
    return sh, curve_diff, ref


def feed_server(server, X_test, y_test, queries: int, seed: int = 17):
    """A ``serve_hook`` that adopts each snapshot into ``server`` and
    submits ``queries`` test points drawn with replacement from a numpy
    stream, as ``benchmarks/serving.py`` does; returns (hook, labels), the
    labels of the submitted queries filled in as they are drawn."""
    import numpy as np
    rng = np.random.default_rng(seed)
    labels = []

    def hook(cycle, snapshot):
        server.serve_hook(cycle, snapshot)
        idx = rng.integers(0, len(X_test), queries)
        labels.append(y_test[idx])
        server.submit(X_test[idx])
    return hook, labels


def hooked_equals_unhooked(cfg, X, y, n: int, device, engine: str,
                           unhooked, **kw):
    """The ``engine`` run with a serving hook (a ``GossipServer`` answering
    512 queries at each eval point on the voted-predict kernel) must give
    bit for bit the curves, economy and fault counters of ``unhooked``.
    Returns the number of queries served."""
    from repro_torch.core.simulation import run_simulation
    from repro_torch.launch.gossip_serve import GossipServer
    server = GossipServer(batch_size=256)
    hook, _ = feed_server(server, X[n:], y[n:], 512)
    res = run_simulation(cfg, X[:n], y[:n], X[n:], y[n:], engine=engine,
                         device=device, serve_hook=hook, **kw)
    server.flush()
    same = lambda r: (r.err_fresh, r.err_voted, r.similarity, r.sent_total,
                      r.delivered_total, r.fault_stats)
    if same(res) != same(unhooked):
        raise AssertionError(f"{engine}: a hooked run differs from an "
                             "unhooked one")
    return server.stats().queries


def voted_bound(count, assign, d: int):
    """Least bytes and operations of one voted-predict launch: each
    distinct assigned node's count and its count valid cache rows read
    once, each query's x and assign entry read and its answer written;
    2 d operations a valid row of each query."""
    import torch
    a = assign.long()
    nodes = torch.unique(a)
    rows = int(count[nodes].sum())
    m = a.numel()
    nbytes = 4 * nodes.numel() + 4 * d * rows + m * (4 * d + 4 + 4)
    ops = 2 * d * int(count[a].sum())
    ms, by = bound(nbytes, ops)
    return ms, by, nbytes


def time_voted(snap, X_test, m: int, seed: int) -> dict:
    """The voted-predict kernel on a snapshot at M queries (test points
    drawn with numpy, nodes assigned as the server assigns them): bitwise
    agreement with the plain version on both routes, ms per launch on the
    route ``voted_route`` picks, on the grouped route at each of its two
    widths a query (one warp; all C groups at once) and on the strided
    route on the same inputs, and the plain version's ms
    (``serving.serve_voted``: gather and plain vote), all replayed from a
    CUDA graph, the kernel's ms per call
    as the server makes it (the wrapper's host time included) and the
    bound."""
    import numpy as np
    import torch
    from repro_torch.core import serving
    rng = np.random.default_rng(seed)
    dev = snap.w.device
    Xq = torch.from_numpy(X_test[rng.integers(0, len(X_test), m)]).to(dev)
    aq = torch.from_numpy(serving.assign_queries(
        m, snap.count.shape[0], seed=seed)).to(dev)
    return time_voted_on(snap.w, snap.count, Xq, aq)


def time_voted_on(w, count, Xq, aq) -> dict:
    """:func:`time_voted`'s checks and times on the given launch inputs:
    the cache rows ``w`` and ``count``, the queries ``Xq`` and their rows
    ``aq``."""
    from repro_torch.core import serving
    from repro_torch.kernels import voted_predict as vp
    compare_voted(w, count, Xq, aq)
    kernel = lambda: vp.voted_predict_batched(w, count, Xq, aq)
    _, c, d = w.shape
    bound_ms, bound_by, nbytes = voted_bound(count, aq, d)
    lanes = {n: graph_time_ms(lambda: vp._launch(
        w, count, Xq, aq, route="grouped", lanes=n), reps=50)
        for n in sorted({32, vp.grouped_lanes_all(c, d)})}
    return dict(
        route=vp.voted_route(d, c), ms=graph_time_ms(kernel, reps=50),
        grouped_lanes_ms=lanes,
        strided_ms=graph_time_ms(lambda: vp._launch(
            w, count, Xq, aq, route="strided"), reps=50),
        call_ms=cuda_time_ms(kernel, reps=50),
        plain_ms=graph_time_ms(lambda: serving.serve_voted(
            w, count, Xq, aq), reps=20),
        bound_ms=bound_ms, bound_by=bound_by, bound_bytes=nbytes,
        queries=int(Xq.shape[0]))


def bound(nbytes: float, ops: float):
    """(least ms, what bounds it) for ``nbytes`` of device memory traffic
    and ``ops`` operations."""
    ms_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ms_ops = ops / F32_FLOPS_PER_S * 1e3
    return (max(ms_bytes, ms_ops),
            "bytes" if ms_bytes >= ms_ops else "operations")


def receive_bound(valid, variant: str, d: int, msg_bytes: int = None,
                  defense: str = "none", gated: int = 0):
    """Least bytes and flops of one receive launch on these inputs: the
    valid lanes; per valid (node, round) the message (``msg_bytes``: its
    payload row with its scale and zero-point, 4 d on the f32 wire) and
    counter read and one cache row and counter written; per node with a
    valid round its x, y, ptr, count, last_t read (last_w too for mu/um,
    and under a defense, which screens against it) and last_w, last_t,
    ptr, count written; under a defense also the (2, N) gated and clipped
    counts written, and the screen's sums (sq, rn, dot) and rescale, about
    7 operations an element of a valid round; a ``gated`` message is read
    and screened but writes no cache row and is not merged."""
    k, n = valid.shape
    if msg_bytes is None:
        msg_bytes = 4 * d
    screened = defense != "none"
    v = int((valid > 0).sum())
    r = int(((valid > 0).sum(0) > 0).sum())
    nbytes = (4 * k * n + v * (msg_bytes + 4) + (v - gated) * (4 * d + 4)
              + r * ((4 * d + 4)
                     + (4 * d if variant != "rw" or screened else 0)
                     + 4 * d + 3 * 4 + 3 * 4)
              + (8 * n if screened else 0))
    per_elem = {"rw": 5, "mu": 7, "um": 12}[variant]    # merge, margin, step
    ops = (v - gated) * per_elem * d + (v * 7 * d if screened else 0)
    ms, by = bound(nbytes, ops)
    return ms, by, nbytes


def send_bound(name: str, n: int, d: int, threefry: dict):
    """Least bytes and operations of one send launch: w (and ef) read once;
    codes or packed bytes, the f16 scale (and zero-point) and the EF
    residual written once. About 6 float operations an element; for
    int8_sr also threefry's integer instructions an element
    (``threefry``: {"int32": n, "imad": n}, counted in the built kernel's
    SASS by ``threefry_sass``), the INT32 ones at ``INT32_OPS_PER_S`` and
    the IMADs on the FMA pipe beside the float work, the larger of the two
    pipes' times."""
    from repro_torch.core.wire_codec import get_codec
    codec = get_codec(name)
    nbytes = (4 * n * d * (2 if codec.ef else 1)
              + n * codec.payload_bytes(d) + n * codec.overhead_bytes
              + (4 * n * d if codec.ef else 0) + (8 if codec.stochastic
                                                  else 0))
    if not codec.stochastic:
        ms, by = bound(nbytes, n * d * 6)
        return ms, by, nbytes
    ms_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ms_ops = max(n * d * threefry["int32"] / INT32_OPS_PER_S,
                 n * d * (6 / F32_FLOPS_PER_S
                          + threefry["imad"] / FMA_PIPE_OPS_PER_S)) * 1e3
    return (max(ms_bytes, ms_ops),
            "bytes" if ms_bytes >= ms_ops else "operations", nbytes)


# the SASS opcodes that issue on the INT32 pipe, by their stem
_INT32_OPCODES = ("IADD3", "IADD", "VIADD", "LOP3", "LOP", "SHF", "SHL",
                  "SHR", "LEA", "IABS", "IMNMX", "ISETP", "SEL", "PRMT",
                  "BMSK", "SGXT", "FLO", "POPC", "BREV")


def threefry_sass(lib) -> dict:
    """Integer instructions an element of int8_sr's threefry noise, from
    the built ``quantize_send`` library's SASS (``cuobjdump -sass``): the
    tiled affine8 kernel with the noise minus the one without, both
    without ``rows`` (the dense send's instantiations), over the four
    elements one pass of its code loop encodes. Returns {"int32",
    "imad", "other": instructions an element, "by_opcode": the difference
    by opcode}."""
    import collections
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            fn = head.group(1)
            counts[fn] = collections.Counter()
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                       r"([A-Z][A-Z0-9_]*)", line)
        if fn and ins:
            counts[fn][ins.group(1)] += 1
    pick = {sr: [c for f, c in counts.items()
                 if f"affine8_tiled_kernelILb{sr}ELb0E" in f]
            for sr in (0, 1)}
    if any(len(v) != 1 for v in pick.values()):
        raise AssertionError(f"threefry_sass: affine8 tiled kernels not found "
                             f"in {lib} ({sorted(counts)[:8]} ...)")
    diff = pick[1][0].copy()
    diff.subtract(pick[0][0])
    per = {"int32": 0.0, "imad": 0.0, "other": 0.0}
    for op, c in diff.items():
        kind = ("imad" if op.startswith("IMAD") else
                "int32" if op in _INT32_OPCODES else "other")
        per[kind] += c / 4
    per["by_opcode"] = {op: c for op, c in sorted(diff.items()) if c}
    return per


def profile_run(run, tag: str, card: str):
    """Run ``run()`` under the profiler: wall, device busy time and the
    top device-time entries; prints them and returns a dict."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)
    # device-side events only (kernels, copies): an op's own device time
    # repeats its kernels'
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA), key=dev_us,
                    reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = [(e.key, dev_us(e) / 1e3, e.count) for e in events[:8]
           if dev_us(e) > 0]
    print(f"[{tag}] {card}: profiled rerun wall {pwall:.3f} s, device busy "
          f"{busy_ms:.1f} ms ({busy_ms / 1e3 / pwall:.2%}), idle share "
          f"{1 - busy_ms / 1e3 / pwall:.2%}")
    for key, t_ms, count in top:
        print(f"[{tag}]   {t_ms:9.3f} ms  x{count:<6d} {key[:90]}")
    return dict(wall_s=pwall, device_busy_ms=busy_ms,
                top=[dict(name=k, ms=t, count=c) for k, t, c in top])


def main_path(cfg, X, y, n: int, cycles: int, device, serve_hook=None,
              telemetry=None):
    """One main-path run (``run_simulation(engine="sharded")`` on the card,
    with ``serve_hook`` and ``telemetry`` if given) with every launch count
    set to 0 just
    before it and read just after, keeping a copy of the last receive and
    send launches' inputs; every receive launch must take the grouped
    route (d = 10, K = 4), and every send launch ``send_route``'s route for
    the codec at d = 10. Returns (result, wall s, peak bytes, receive
    launches, send launches by kernel, captured receive inputs, captured
    send inputs, voted-predict launches, receive launches by route, send
    launches by route, voted-predict launches by route)."""
    import numpy as np
    import torch
    from repro_torch.core.simulation import run_simulation
    from repro_torch.kernels import gossip_cycle as gc
    from repro_torch.kernels import voted_predict as vp

    recv, send = gc.fused_receive_apply, gc.quantize_send
    voted = vp.voted_predict_batched
    got_recv, got_send, got_voted = {}, {}, {}
    clone = lambda v: v.clone() if isinstance(v, torch.Tensor) else v

    def capture_recv(*a, **kw):
        if recv.launches == cycles - 1:
            got_recv.update({k: v.clone() for k, v in zip(ORDER, a)})
            got_recv.update({k: kw[k].clone() for k in META
                             if kw.get(k) is not None})
            got_recv["wire"] = kw.get("wire")
            got_recv["defense"] = kw.get("defense", "none")
        return recv(*a, **kw)

    def capture_send(w, name, key=None, ef=None, rows=None):
        if send.launches[gc.send_kernel_name(name)] == cycles - 1:
            got_send.update(w=w.clone(), name=name, key=clone(key),
                            ef=clone(ef))
        return send(w, name, key=key, ef=ef, rows=rows)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gc.fused_receive_apply, gc.quantize_send = capture_recv, capture_send
    try:
        recv.launches = vp.voted_predict_batched.launches = 0
        for k in send.launches:
            send.launches[k] = 0
        for k in recv.route_launches:
            recv.route_launches[k] = 0
        for k in send.route_launches:
            send.route_launches[k] = 0
        for k in vp.voted_predict_batched.route_launches:
            vp.voted_predict_batched.route_launches[k] = 0
        t0 = time.perf_counter()
        res = run_simulation(cfg, X[:n], y[:n], X[n:], y[n:],
                             engine="sharded", cycles=cycles, eval_every=10,
                             seed=0, k_rounds=4, device=device,
                             serve_hook=serve_hook, telemetry=telemetry)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, sends = recv.launches, dict(send.launches)
        routes = dict(recv.route_launches)
        send_routes = dict(send.route_launches)
        voted = vp.voted_predict_batched.launches
        voted_by_route = dict(vp.voted_predict_batched.route_launches)
    finally:
        gc.fused_receive_apply, gc.quantize_send = recv, send
    peak = torch.cuda.max_memory_allocated()
    if launches != cycles:
        raise AssertionError(f"main path launched the receive kernel "
                             f"{launches} times, expected {cycles}")
    if routes != dict(grouped=cycles, strided=0):
        raise AssertionError(f"main path's receive launches by route "
                             f"{routes}, expected all {cycles} grouped")
    if cfg.wire_dtype in SEND_CODECS:
        want = dict.fromkeys(gc.SEND_ROUTES, 0)
        want[gc.send_route(X.shape[1], cfg.wire_dtype)] = cycles
        if send_routes != want:
            raise AssertionError(f"main path's send launches by route "
                                 f"{send_routes}, expected {want}")
    if res.sent_total != (res.delivered_total + res.lost_total
                          + res.overflow_total + res.in_flight_total):
        raise AssertionError("message economy does not add up")
    curves = res.err_fresh + res.err_voted + res.similarity
    if not (len(res.cycles) == 2 and all(np.isfinite(curves))
            and all(0.0 <= e <= 0.5 for e in res.err_fresh + res.err_voted)):
        raise AssertionError(f"bad curves {curves}")
    return (res, wall, peak, launches, sends, got_recv, got_send, voted,
            routes, send_routes, voted_by_route)


def run_outcome(res):
    """What an armed run must leave bit for bit as the unarmed run has it:
    curves, economy, fault counters, wire bytes and the EF norm."""
    return (res.cycles, res.err_fresh, res.err_voted, res.similarity,
            res.sent_total, res.delivered_total, res.lost_total,
            res.overflow_total, res.in_flight_total,
            list(res.delivered_per_cycle), dict(res.fault_stats),
            res.wire_bytes_total, res.buf_payload_bytes,
            res.ef_residual_norm)


def check_armed(tel, armed, unarmed, cycles: int, tag: str):
    """An armed run against its unarmed twin: the outcome equal bit for
    bit, and the metric streams, one value a cycle (a value an eval point
    for the EF residual), summing to the run's totals with ``in_flight``
    ending at sent - delivered - lost - overflow."""
    if run_outcome(armed) != run_outcome(unarmed):
        raise AssertionError(f"{tag}: the armed run differs from the "
                             f"unarmed one: {run_outcome(armed)[:9]} vs "
                             f"{run_outcome(unarmed)[:9]}")
    s = tel.stream_array
    totals = dict(sent=armed.sent_total, delivered=armed.delivered_total,
                  lost=armed.lost_total, overflow=armed.overflow_total,
                  wire_bytes=armed.wire_bytes_total, **armed.fault_stats)
    for name, total in totals.items():
        if s(name).size != cycles or int(s(name).sum()) != total:
            raise AssertionError(f"{tag}: stream {name} has {s(name).size} "
                                 f"values summing to {s(name).sum()}, "
                                 f"expected {cycles} summing to {total}")
    balance = (armed.sent_total - armed.delivered_total - armed.lost_total
               - armed.overflow_total)
    if not int(s("in_flight")[-1]) == balance == armed.in_flight_total:
        raise AssertionError(f"{tag}: in_flight ends at "
                             f"{s('in_flight')[-1]}, the economy at "
                             f"{balance}")
    if s("delivered").tolist() != list(armed.delivered_per_cycle):
        raise AssertionError(f"{tag}: delivered stream differs")
    ef = s("ef_residual_rms")
    if ef.size != len(armed.cycles) or ef[-1] != armed.ef_residual_norm:
        raise AssertionError(f"{tag}: ef_residual_rms {ef.tolist()} against "
                             f"the run's {armed.ef_residual_norm}")


def span_split(tel) -> dict:
    """Per span name: total seconds, share of the spanned wall time, count
    and kernel libraries built or loaded inside."""
    wall = tel.wall_seconds()
    out = {}
    for sp in tel.spans:
        row = out.setdefault(sp.name, dict(s=0.0, count=0, compiles=0))
        row["s"] += sp.seconds
        row["count"] += 1
        row["compiles"] += sp.compiles
    for row in out.values():
        row["share"] = row["s"] / wall if wall > 0 else 0.0
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["s"]))


def trace_report(path) -> str:
    """``tools/trace_report.py`` on an exported trace: it must read it and
    find the streams' balance invariant."""
    proc = subprocess.run([sys.executable,
                           str(ROOT / "tools" / "trace_report.py"),
                           str(path)], capture_output=True, text=True,
                          timeout=120)
    if proc.returncode != 0 or "balance invariant OK" not in proc.stdout:
        raise AssertionError(f"tools/trace_report.py on {path}: exit "
                             f"{proc.returncode}\n{proc.stdout}\n"
                             f"{proc.stderr}")
    return proc.stdout


def time_receive(captured, variant: str, lam: float, d: int,
                 atol: float = 1e-5):
    """The receive kernel on captured main-path inputs (with their
    ``wire`` and ``defense``): agreement with the plain version there
    (integers equal, floats within ``atol`` and rtol 1e-5), and bitwise
    with the strided route where the grouped one serves them; ms per
    launch, the strided route's ms on the same inputs when it is not the
    route taken, the plain version's ms, and the bound. Returns a dict:
    err, ms, route, strided_ms, plain_ms, bound_ms, bound_by, bytes."""
    from repro_torch.core.wire_codec import get_codec
    from repro_torch.kernels import gossip_cycle as gc
    wire = captured.get("wire")
    defense = captured.get("defense", "none")
    inputs = {k: v for k, v in captured.items()
              if k not in ("wire", "defense")}
    err, (gated, _) = compare_kernel(inputs, variant, lam, atol, wire=wire,
                                     defense=defense)
    route = gc.receive_route(d, inputs["msg_w"].shape[0])
    if route == "grouped":
        compare_routes(inputs, variant, lam, wire, defense)
    kw = dict(variant=variant, lam=lam, wire=wire, defense=defense)

    def runner(fn):
        st = {k: v.clone() for k, v in inputs.items()}
        args = [st[k] for k in ORDER]
        meta = {k: st[k] for k in META if k in st}
        return lambda: fn(*args, **meta, **kw)

    def strided(*args, msg_scale=None, msg_zp=None, wire=None, variant,
                lam, defense):
        mode = gc._check_receive(*args, msg_scale, msg_zp, wire, variant,
                                 defense)
        return gc._launch_receive(*args, msg_scale, msg_zp, mode, variant,
                                  float(lam), defense, route="strided")
    ms = cuda_time_ms(runner(gc.fused_receive_apply), reps=20)
    strided_ms = (cuda_time_ms(runner(strided), reps=20)
                  if route != "strided" else ms)
    plain_ms = cuda_time_ms(runner(gc.fused_receive_apply_plain), reps=5,
                            warmup=1)
    codec = get_codec(wire)
    bound_ms, bound_by, nbytes = receive_bound(
        inputs["valid"], variant, d,
        codec.payload_bytes(d) + codec.overhead_bytes, defense, gated)
    return dict(err=err, ms=ms, route=route, strided_ms=strided_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes)


def receive_line(t: dict) -> str:
    """A ``time_receive`` result as printed."""
    strided = (f"; the strided route {t['strided_ms']:.4f} ms on the same "
               "inputs, bitwise equal" if t["route"] != "strided" else "")
    return (f"{t['ms']:.4f} ms/launch ({t['route']}) vs bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}, {t['bytes']} B)"
            f"{strided}; plain version {t['plain_ms']:.4f} ms; max abs err "
            f"vs plain {t['err']:.3e}")


def time_send(captured, threefry: dict):
    """The send kernel on captured main-path inputs: bitwise agreement with
    the plain version there (and with the strided route where the tiled one
    serves them); ms per launch, the strided route's ms on the same inputs
    when it is not the route taken, the plain version's ms, and the bound.
    Returns a dict: ms, route, strided_ms, plain_ms, bound_ms, bound_by,
    bytes."""
    from repro_torch.kernels import gossip_cycle as gc
    w, name, key, ef = (captured[k] for k in ("w", "name", "key", "ef"))
    _, route = compare_send(name, w, ef, key)
    ms = cuda_time_ms(lambda: gc.quantize_send(w, name, key=key, ef=ef),
                      reps=20)
    strided_ms = (cuda_time_ms(lambda: run_send(w, name, key, ef,
                                                route="strided"), reps=20)
                  if route != "strided" else ms)
    plain_ms = cuda_time_ms(
        lambda: gc.quantize_send_plain(w, name, key=key, ef=ef), reps=5,
        warmup=1)
    bound_ms, bound_by, nbytes = send_bound(name, *w.shape, threefry)
    return dict(ms=ms, route=route, strided_ms=strided_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes)


def send_width_sweep(card: str, threefry: dict, dev) -> dict:
    """The two send routes forced on the same models (and EF residuals) at
    N = 10^6 and d = 10, 32, 57 and 128 for every codec: bitwise equal,
    and each route's ms per launch (where the tiled route is no slower,
    ``send_route``'s limit may reach). Returns {d: {codec: {...}}}."""
    import torch
    from repro_torch import random
    from repro_torch.core.wire_codec import get_codec
    from repro_torch.kernels import gossip_cycle as gc
    key = random.key(99, device=dev)
    out = {}
    for d in SEND_SWEEP_WIDTHS:
        w, ef = send_inputs(d, 1_000_000, d, dev)
        out[d] = {}
        for name in TILED_CODECS + EF_CODECS:
            k = key if get_codec(name).stochastic else None
            e = ef if get_codec(name).ef else None
            tiled = run_send(w, name, k, e, route="tiled")
            strided = run_send(w, name, k, e, route="strided")
            torch.cuda.synchronize()
            same_outputs(name, ("codes", "scale", "zp/resid"), tiled,
                         strided, "strided route")
            row = dict(
                tiled_ms=cuda_time_ms(lambda: run_send(w, name, k, e,
                                                       route="tiled"), 20),
                strided_ms=cuda_time_ms(lambda: run_send(
                    w, name, k, e, route="strided"), 20),
                bound_ms=send_bound(name, *w.shape, threefry)[0])
            out[d][name] = row
            print(f"[1] {card}: quantize_send {name} N=10^6 d={d}: tiled "
                  f"{row['tiled_ms']:.4f} ms, strided {row['strided_ms']:.4f}"
                  f" ms (bitwise equal), bound {row['bound_ms']:.4f} ms; "
                  f"send_route takes {gc.send_route(d, name)}")
        del w, ef
        torch.cuda.empty_cache()
    return out


def row_inputs(seed, n, d, device, merge=False):
    """(N, d) models with counters in [0, 100), examples and ±1 labels,
    made with numpy: (w, t, x, y), or (w1, t1, w2, t2, x, y) for the
    merge."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2 if merge else 1):
        out += [rng.standard_normal((n, d), dtype=np.float32),
                rng.integers(0, 100, n, dtype=np.int32)]
    out += [rng.standard_normal((n, d), dtype=np.float32),
            np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)]
    return tuple(torch.from_numpy(a).to(device) for a in out)


def row_plain(name):
    from repro_torch.kernels import ref
    return {"pegasos_update": ref.pegasos_update_ref,
            "merge_update": ref.merge_update_ref}[name]


def compare_rows(name, inputs, lam):
    """Kernel #6 (``name`` "pegasos_update") or #7 ("merge_update")
    through ``kernels/ops.py`` against its plain version on the card: t
    equal; w within rtol 2e-5, atol 1e-5 (only the margin is summed in
    another order, so w is bitwise equal but in a row whose margin lies
    within that sum's rounding of 1). Returns (max abs err, rows not
    bitwise equal)."""
    import torch
    from repro_torch.kernels import ops
    w, t = getattr(ops, name)(*inputs, lam=lam)
    pw, pt = row_plain(name)(*inputs, lam)
    torch.cuda.synchronize()
    if not torch.equal(t, pt):
        raise AssertionError(f"{name}: t differs in {int((t != pt).sum())} "
                             "rows")
    if not torch.isfinite(w).all():
        raise AssertionError(f"{name}: w not finite")
    err = float((w - pw).abs().max())
    if not torch.allclose(w, pw, rtol=2e-5, atol=1e-5):
        raise AssertionError(f"{name}: w off by {err}")
    return err, int((w != pw).any(dim=1).sum())


def rows_bound(name, n: int, d: int):
    """Least bytes and operations of one launch of kernel #6 or #7: the
    model(s), x, t and y read once, w' and t' written once; about 5
    operations an element (margin product and sum, decay, hinge product,
    add), 7 with the merge's add and halving."""
    merge = name == "merge_update"
    nbytes = n * ((16 if merge else 12) * d + (16 if merge else 12))
    ms, by = bound(nbytes, n * d * (7 if merge else 5))
    return ms, by, nbytes


def launch_layout(name):
    """The forcing helper of kernel #6 (``name`` "pegasos_update") or #7
    ("merge_update"): (tensors, n, d, lam, route=) -> (w', t')."""
    from repro_torch.kernels import gossip_merge as gm
    from repro_torch.kernels import pegasos_update as pu
    return {"pegasos_update": pu._launch_step,
            "merge_update": gm._launch_merge}[name]


def time_rows(name, inputs, lam):
    """ms per launch of kernel #6 or #7 through ``kernels/ops.py``, the
    strided layout's ms on the same inputs, its plain version's ms, and
    the bound."""
    from repro_torch.kernels import ops
    fn = getattr(ops, name)
    ms = cuda_time_ms(lambda: fn(*inputs, lam=lam), reps=20)
    n, d = inputs[0].shape
    strided_ms = cuda_time_ms(lambda: launch_layout(name)(
        inputs, n, d, lam, route="strided"), reps=20)
    plain = row_plain(name)
    plain_ms = cuda_time_ms(lambda: plain(*inputs, lam), reps=10)
    return (ms, strided_ms, plain_ms) + rows_bound(name, n, d)


def hinge_may_flip(inputs):
    """The rows of a step (w, t, x, y) or a merge (w1, t1, w2, t2, x, y)
    whose hinge (margin < 1) another order of the margin's sum may decide
    the other way: the plain version's margin lies within 2 gamma_(d-1)
    sum_j |m_j x_j| of 1, twice the bound on a float32 sum's rounding error
    in any order (Higham), the products rounded as both round them. A
    flipped hinge moves w' by eta y x, far past any float tolerance."""
    import torch
    if len(inputs) == 6:
        w1, _, w2, _, x, y = inputs
        terms = (w1 + w2) / 2.0 * x
    else:
        w, _, x, y = inputs
        terms = w * x
    d = x.shape[1]
    u = 2.0 ** -24
    gamma = (d - 1) * u / (1 - (d - 1) * u)
    margin = (y * torch.sum(terms, dim=-1)).double()
    return (margin - 1.0).abs() <= 2 * gamma * terms.double().abs().sum(-1)


def row_width_sweep(card: str, dev) -> dict:
    """#6's and #7's two layouts forced on the same inputs at N = 10^6 and
    d = 10, 32, 57 and 128: t' equal, w' within ``compare_rows``' tolerance
    of the plain version on every row whose hinge no sum order can flip
    (``hinge_may_flip``; at these sizes a few rows lie that close to 1),
    and each layout's ms per launch (where the tiled layout is no slower,
    ``row_route``'s limit for that kernel may reach). Returns
    {kernel: {d: {...}}}."""
    import torch
    from repro_torch.kernels import pegasos_update as pu
    out = {}
    for name in ROW_KERNELS:
        merge = name == "merge_update"
        launch = launch_layout(name)
        out[name] = {}
        for d in ROW_SWEEP_WIDTHS:
            n = 1_000_000
            inputs = row_inputs(d, n, d, dev, merge=merge)
            got = {route: launch(inputs, n, d, 1e-3, route=route)
                   for route in pu.ROW_ROUTES}
            pw, pt = row_plain(name)(*inputs, 1e-3)
            fixed = ~hinge_may_flip(inputs)
            torch.cuda.synchronize()
            off = {}
            for route, (w, t) in got.items():
                if not (torch.equal(t, pt) and torch.allclose(
                        w[fixed], pw[fixed], rtol=2e-5, atol=1e-5)):
                    raise AssertionError(f"{name} {route} d={d}: off the "
                                         "plain version")
                off[route] = int((w != pw).any(dim=1).sum())
            apart = int((got["tiled"][0] != got["strided"][0]).any(
                dim=1).sum())
            row = dict(
                tiled_ms=cuda_time_ms(lambda: launch(
                    inputs, n, d, 1e-3, route="tiled"), 20),
                strided_ms=cuda_time_ms(lambda: launch(
                    inputs, n, d, 1e-3, route="strided"), 20),
                bound_ms=rows_bound(name, n, d)[0],
                rows_not_bitwise=off, rows_apart=apart,
                hinge_may_flip=int((~fixed).sum()))
            out[name][d] = row
            print(f"[1] {card}: {name} N=10^6 d={d}: tiled "
                  f"{row['tiled_ms']:.4f} ms, strided "
                  f"{row['strided_ms']:.4f} ms (t equal, w within rtol 2e-5 "
                  f"atol 1e-5 but on the {row['hinge_may_flip']} rows whose "
                  f"hinge an order may flip; rows not bitwise equal to "
                  f"plain {off}, to each other {apart}), bound "
                  f"{row['bound_ms']:.4f} ms; row_route takes "
                  f"{pu.row_route(d, merge)}")
            del inputs, got
            torch.cuda.empty_cache()
    return out


def flash_inputs(seed, b, s, h, kv, hd, dtype, device, strided=False,
                 unaligned=False):
    """q (B, S, H, hd), k and v (B, S, KV, hd) of ``dtype``, normal draws
    from a seeded generator on ``device``; ``strided``: views of
    (B, heads, S, hd) tensors, so only hd is contiguous; ``unaligned``:
    contiguous views that start one element past a 16-byte boundary."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def make(heads):
        shape = (b, heads, s, hd) if strided else (b, s, heads, hd)
        x = torch.randn(shape, generator=g, device=device).to(dtype)
        x = x.transpose(1, 2) if strided else x
        if unaligned:
            buf = torch.empty(x.numel() + 1, dtype=dtype, device=device)
            x = buf[1:].view(x.shape).copy_(x)
        return x
    return make(h), make(kv), make(kv)


def compare_flash(q, k, v, causal, window, route=None):
    """Kernel #8 against its plain version on the card: float32 within
    rtol = atol = 2e-4, bfloat16 within atol 3e-2 (tests/test_kernels.py's
    tolerances) and rtol 2^-7: both sides round once to q's type, so a
    bf16 output may differ by one rounding step, 2^-7 of it, which passes
    3e-2 above |o| = 4 (the serving path's values reach that); the
    tensor-core route also rounds P to bf16 (about 2^-9 max|v| more).
    ``route``: the route the call must take. Returns the max abs error."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    before = dict(fa.flash_attention.route_launches)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    took = [r for r, n in fa.flash_attention.route_launches.items()
            if n != before[r]]
    if route is not None and took != [route]:
        raise AssertionError(f"flash_attention {q.dtype} {tuple(q.shape)} "
                             f"strides {q.stride()}: took {took}, not "
                             f"{route}")
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    if got.dtype != q.dtype or got.shape != q.shape:
        raise AssertionError(f"flash_attention gave {got.dtype} "
                             f"{tuple(got.shape)} for q {q.dtype} "
                             f"{tuple(q.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError("flash_attention: output not finite")
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    tol = (dict(rtol=2e-4, atol=2e-4) if q.dtype == torch.float32
           else dict(rtol=2.0 ** -7, atol=3e-2))
    if not torch.allclose(g, w, **tol):
        raise AssertionError(f"flash_attention {q.dtype} {tuple(q.shape)} "
                             f"kv {k.shape[2]} causal={causal} "
                             f"window={window}: off by {err}")
    return err


def visible_pairs(s: int, causal: bool, window) -> int:
    """(query, key) pairs the mask lets through at Sq = Sk = s."""
    import numpy as np
    i = np.arange(s, dtype=np.int64)
    lo = np.zeros(s, np.int64) if window is None else np.maximum(
        0, i - window + 1)
    hi = i + 1 if causal else np.full(s, s, np.int64)
    return int((hi - lo).sum())


def flash_bound(q, kv_heads: int, causal: bool, window):
    """Least bytes and operations of one launch of kernel #8: q, k, v read
    once and the output written once; 4 hd operations (the two products)
    a visible (query, key) pair of each head, at the dense tensor-core rate
    for bf16 and the float32 rate otherwise. Returns (ms, bound_by, bytes,
    operations)."""
    import torch
    b, s, h, hd = q.shape
    nbytes = q.element_size() * b * s * hd * (2 * h + 2 * kv_heads)
    flops = 4 * b * h * hd * visible_pairs(s, causal, window)
    rate = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else F32_FLOPS_PER_S
    ms_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ms_ops = flops / rate * 1e3
    return (max(ms_bytes, ms_ops),
            "bytes" if ms_bytes >= ms_ops else "operations", nbytes, flops)


def serve_once(cfg, params, prompts, steps: int, max_len: int = LM_MAX_LEN):
    """A ``DecodeServer(batch=len(prompts), max_len=max_len)``: fused
    prefill of ``prompts``, then ``steps`` greedy decode steps. Returns
    (prefill logits, tokens, prefill s, decode s)."""
    import torch
    from repro_torch.launch.serve import DecodeServer
    srv = DecodeServer(cfg, params, batch=prompts.shape[0],
                       max_len=max_len)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, start = srv.prefill(prompts)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    toks = srv.decode(logits, start, steps)      # ends in a read-back
    t2 = time.perf_counter()
    return logits, toks, t1 - t0, t2 - t1


def small_server_check(device, seed: int = 1, arch: str = LM_ARCH,
                       prepare=None):
    """The reduced ``arch`` (f32) served on ``device`` (kernel #8 where it
    has attention) and on the CPU (its plain version) with the same
    weights (``prepare(params)`` applied to them first, where given), a
    100-token prompt (past the reduced windows, 64 and 32, and the reduced
    learned positions, 64): prefill logits within rtol 1e-4 and an atol of
    1e-5 times their largest magnitude, and equal greedy tokens over 16
    steps. Returns (max logit diff, tokens)."""
    import copy

    import numpy as np
    import torch
    from repro_torch.config import get_config, reduced_config
    from repro_torch.launch.serve import DecodeServer
    from repro_torch.models import transformer as T
    cfg = reduced_config(get_config(arch), vocab=2048)
    on_cpu = T.init_params(cfg, device="cpu", seed=seed)
    if prepare is not None:
        prepare(on_cpu)
    on_dev = copy.deepcopy(on_cpu).to(device)
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                   (2, 100))
    out = []
    for params in (on_dev, on_cpu):
        srv = DecodeServer(cfg, params, batch=2, max_len=128)
        logits, start = srv.prefill(prompts)
        out.append((logits.cpu(), srv.decode(logits, start, 16)))
    (gl, gt), (cl, ct) = out
    diff = float((gl - cl).abs().max())
    if not torch.allclose(gl, cl, rtol=1e-4,
                          atol=1e-5 * max(1.0, float(cl.abs().max()))):
        raise AssertionError(f"reduced {arch} server: card and CPU logits "
                             f"differ by {diff}")
    if not np.array_equal(gt, ct):
        raise AssertionError(f"reduced {arch} server: card and CPU greedy "
                             "tokens differ")
    return diff, gt


def phase1_rows(card: str, results: dict):
    """Kernels #6 and #7 against their plain versions at ``ROW_SHAPES``;
    their path through ``kernels/ops.py`` (``ROW_STEPS`` steps of each at
    N = 10^6, d = 10, counts set to 0 before and read after); their times
    there. Returns each kernel's row of the ``kernels`` line."""
    import torch
    from repro_torch.kernels import gossip_merge as gm
    from repro_torch.kernels import ops
    from repro_torch.kernels import pegasos_update as pu
    dev = torch.device("cuda")
    errs = dict.fromkeys(ROW_KERNELS, 0.0)
    for n, d in ROW_SHAPES:
        for name in ROW_KERNELS:
            inputs = row_inputs(n + d, n, d, dev,
                                merge=name == "merge_update")
            err, off = compare_rows(name, inputs, 1e-3)
            errs[name] = max(errs[name], err)
            print(f"[1] {name} N={n} d={d}: t equal, w max abs err "
                  f"{err:.3e} (rtol 2e-5, atol 1e-5), {off} rows not "
                  "bitwise equal")
            del inputs
    torch.cuda.empty_cache()

    n, d = ROW_SHAPES[0]
    w, t, x, y = inputs6 = row_inputs(1, n, d, dev)
    w1, t1, w2, t2, x2, y2 = inputs7 = row_inputs(2, n, d, dev, merge=True)
    t6_end = t + ROW_STEPS
    t7_end = torch.maximum(t1, t2) + ROW_STEPS
    counters = {"pegasos_update": pu.pegasos_update,
                "merge_update": gm.merge_update}
    for fn in counters.values():
        fn.launches = 0
        for route in fn.route_launches:
            fn.route_launches[route] = 0
    for _ in range(ROW_STEPS):
        w, t = ops.pegasos_update(w, t, x, y, lam=1e-3)
        w1, t1 = ops.merge_update(w1, t1, w2, t2, x2, y2, lam=1e-3)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    by_route = {name: dict(fn.route_launches)
                for name, fn in counters.items()}
    if launches != dict.fromkeys(counters, ROW_STEPS):
        raise AssertionError(f"{ROW_STEPS} steps through ops.py launched "
                             f"{launches}")
    want_routes = {name: dict(tiled=ROW_STEPS, strided=0)
                   for name in counters}
    if by_route != want_routes:
        raise AssertionError(f"{ROW_STEPS} steps through ops.py at d={d} "
                             f"launched by layout {by_route}, expected "
                             f"{want_routes}")
    if not (torch.equal(t, t6_end) and torch.equal(t1, t7_end)
            and torch.isfinite(w).all() and torch.isfinite(w1).all()):
        raise AssertionError("the steps through ops.py gave wrong counters "
                             "or non-finite models")
    print(f"[1] {ROW_STEPS} steps of pegasos_update and of merge_update "
          f"through kernels/ops.py at N={n} d={d}: launches {launches} (by "
          f"layout {by_route}), counters as expected, models finite")
    out = {}
    for name, inputs in (("pegasos_update", inputs6),
                         ("merge_update", inputs7)):
        ms, strided_ms, plain_ms, b_ms, by, nbytes = time_rows(name, inputs,
                                                               1e-3)
        route = pu.row_route(d, name == "merge_update")
        other = f"; the strided layout {strided_ms:.4f} ms on the same inputs"
        print(f"[1] {card}: {name} at N={n} d={d}: {ms:.4f} ms/launch "
              f"({route}) vs bound {b_ms:.4f} ms ({by}, {nbytes} B)"
              f"{other}; plain version {plain_ms:.4f} ms")
        out[name] = dict(launches=launches[name], max_abs_err=errs[name],
                         ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=by, row_route=route, strided_ms=strided_ms)
    results["rows"] = out
    results["row_width_sweep"] = row_width_sweep(card, dev)
    return out


def hopper_registers(log: str) -> dict:
    """(registers, spill bytes) of each ``flash_hopper_kernel<HD>`` in the
    ``-Xptxas -v`` log of ``flash_attention_hopper.cu``, by HD."""
    out, hd = {}, None
    for line in log.splitlines():
        if "Compiling entry" in line:
            found = re.search(r"flash_hopper_kernelILi(\d+)E", line)
            hd = int(found.group(1)) if found else None
            if hd is not None:
                out[hd] = [0, 0]
        if hd is None:
            continue
        if "spill" in line:
            out[hd][1] += sum(int(w) for w in re.findall(
                r"(\d+) bytes spill", line))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            out[hd][0] = int(used.group(1))
    return {hd: tuple(v) for hd, v in out.items()}


def phase1_flash(dev) -> dict:
    """Kernel #8 against its plain version over the sweep of
    ``FLASH_HEAD_DIMS`` x ``FLASH_GROUPS`` x ``FLASH_SEQS`` x float32 and
    bfloat16 x causal or not x window None or 64 (KV = 2, H = KV x group;
    B = 2 below S = 2048), and on strided and unaligned inputs, each case
    held to the route it must take: bf16 at a head_dim of
    ``TENSOR_CORE_HEAD_DIMS`` on TMA-readable tensors to the tensor-core
    kernel, everything else to the CUDA-core kernel. Returns each route's
    max abs error."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    worst = dict.fromkeys(fa.ROUTES, 0.0)
    cases = 0

    def want(dtype, hd):
        return ("tensor_core" if dtype == torch.bfloat16
                and hd in fa.TENSOR_CORE_HEAD_DIMS else "cuda_core")
    for hd in FLASH_HEAD_DIMS:
        for group in FLASH_GROUPS:
            kv, h = 2, 2 * group
            for s in FLASH_SEQS:
                b = 2 if s < 2048 else 1
                errs = {}
                for dtype in (torch.float32, torch.bfloat16):
                    q, k, v = flash_inputs(cases, b, s, h, kv, hd, dtype,
                                           dev)
                    route = want(dtype, hd)
                    errs[dtype] = max(
                        compare_flash(q, k, v, causal, window, route)
                        for causal in (True, False) for window in (None, 64))
                    worst[route] = max(worst[route], errs[dtype])
                    cases += 4
                print(f"[1] flash_attention hd={hd} H={h} KV={kv} S={s} "
                      f"B={b}, causal and not, window None and 64: max abs "
                      f"err f32 {errs[torch.float32]:.3e} "
                      f"({want(torch.float32, hd)}), bf16 "
                      f"{errs[torch.bfloat16]:.3e} "
                      f"({want(torch.bfloat16, hd)})")
            torch.cuda.empty_cache()
    for hd, kv in ((128, 8), (256, 1)):
        for dtype, layout, route in (
                (torch.float32, "strided", "cuda_core"),
                (torch.bfloat16, "strided", "tensor_core"),
                (torch.bfloat16, "unaligned", "cuda_core")):
            q, k, v = flash_inputs(7, 2, 300, 16, kv, hd, dtype, dev,
                                   strided=layout == "strided",
                                   unaligned=layout == "unaligned")
            err = compare_flash(q, k, v, True, None, route)
            worst[route] = max(worst[route], err)
            cases += 1
            print(f"[1] flash_attention on {layout} q, k, v (strides "
                  f"{q.stride()}, base % 16 = {q.data_ptr() % 16}) {dtype} "
                  f"B=2 S=300 H=16 KV={kv} hd={hd}: max abs err {err:.3e} "
                  f"({route})")
    print(f"[1] flash_attention: {cases} cases within tolerance (f32 rtol = "
          "atol = 2e-4, bf16 atol 3e-2 and rtol 2^-7), each on its route; "
          f"max abs err tensor_core {worst['tensor_core']:.3e}, cuda_core "
          f"{worst['cuda_core']:.3e}")
    return worst


def phase6(card: str, results: dict, flash_err: dict) -> dict:
    """LM serving at full width (see the module note). Returns kernel
    #8's rows of the ``kernels`` line, one a route: the tensor-core
    route's launches are the bf16 prefill's, the CUDA-core route's the
    reduced f32 server's."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.config import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gossip_cycle as gc
    from repro_torch.kernels import gossip_merge as gm
    from repro_torch.kernels import pegasos_update as pu
    from repro_torch.kernels import voted_predict as vp
    from repro_torch.models import transformer as T
    dev = torch.device("cuda")

    flash = fa.flash_attention
    flash.launches = 0
    flash.route_launches = dict.fromkeys(fa.ROUTES, 0)
    diff, _ = small_server_check(dev)
    small_routes = dict(flash.route_launches)
    if small_routes["cuda_core"] == 0 or small_routes["tensor_core"]:
        raise AssertionError(f"phase 6: the reduced f32 server launched "
                             f"kernel #8's routes {small_routes}")
    print(f"[6] reduced {LM_ARCH} (f32) served on the card (kernel #8, "
          f"launches by route {small_routes}) and on the CPU (plain "
          f"version): prefill logits within {diff:.3e}, 16 greedy tokens a "
          "prompt equal")

    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = T.init_params(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))
    print(f"[6] {LM_ARCH}: {cfg.param_count()} parameters in "
          f"{str(cfg.param_dtype)[6:]}, random from a seeded generator on "
          f"the card in {init_s:.2f} s; attn_impl={cfg.attn_impl}")
    serve_once(cfg, params, prompts[:, :64], 2)     # warm up
    captured = {}

    def capture(q, k, v, **kw):
        if flash.launches == cfg.num_layers - 1:        # the last layer's
            captured.update(q=q.clone(), k=k.clone(), v=v.clone(), kw=kw)
        return flash(q, k, v, **kw)

    others = (gc.fused_receive_apply, vp.voted_predict_batched,
              pu.pegasos_update, gm.merge_update)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention = capture
    try:
        for fn in (flash,) + others:
            fn.launches = 0
        flash.route_launches = dict.fromkeys(fa.ROUTES, 0)
        logits, toks, pre_s, dec_s = serve_once(cfg, params, prompts,
                                                LM_STEPS)
        launches = flash.launches
        routes = dict(flash.route_launches)
        stray = [fn.launches for fn in others]
    finally:
        fa.flash_attention = flash
    peak = torch.cuda.max_memory_allocated()
    if (launches != cfg.num_layers or any(stray)
            or routes != dict(tensor_core=cfg.num_layers, cuda_core=0)):
        raise AssertionError(f"phase 6: kernel #8 launched {launches} times "
                             f"(by route {routes}) in a prefill of "
                             f"{cfg.num_layers} layers; others {stray}")
    if (tuple(logits.shape) != (LM_BATCH, cfg.vocab_size)
            or not torch.isfinite(logits).all()
            or toks.shape != (LM_BATCH, LM_STEPS)
            or not ((0 <= toks) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"phase 6: logits {tuple(logits.shape)}, "
                             f"tokens {toks.shape}")
    pre_tps = LM_BATCH * LM_PROMPT / pre_s
    dec_tps = LM_BATCH * LM_STEPS / dec_s
    print(f"[6] {card}: {LM_ARCH} DecodeServer(batch={LM_BATCH}, "
          f"max_len={LM_MAX_LEN}): kernel #8 launches {launches} in the "
          f"prefill (by route {routes}); prefill of {LM_PROMPT} tokens "
          f"{pre_s * 1e3:.1f} ms ({pre_tps:.0f} tokens/s); {LM_STEPS} decode "
          "steps "
          f"{dec_s * 1e3 / LM_STEPS:.2f} ms/step ({dec_tps:.1f} tokens/s); "
          f"peak device memory {peak} B ({peak / 2**30:.2f} GiB)")
    print(f"[6] sample continuation: {toks[0][:16].tolist()}")
    prof = profile_run(lambda: serve_once(cfg, params, prompts, LM_STEPS),
                       "6", card)

    causal, window = captured["kw"]["causal"], captured["kw"]["window"]
    rows, measured = {}, {}
    # the tensor-core route on the path's own q, k, v; the CUDA-core route
    # on the same values in float32
    for route, dtype in (("tensor_core", torch.bfloat16),
                         ("cuda_core", torch.float32)):
        q, k, v = (captured[n].to(dtype) for n in ("q", "k", "v"))
        err = compare_flash(q, k, v, causal, window, route)
        ms = cuda_time_ms(lambda: fa.flash_attention(
            q, k, v, causal=causal, window=window), reps=20)
        plain_ms = cuda_time_ms(lambda: fa.flash_attention_plain(
            q, k, v, causal=causal, window=window), reps=5)
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), reps=20)
        b_ms, by, nbytes, flops = flash_bound(q, k.shape[2], causal, window)
        print(f"[6] {card}: flash_attention ({route}) on the last layer's "
              f"q, k, v {tuple(q.shape)} kv {k.shape[2]} {str(dtype)[6:]} "
              f"causal={causal}: {ms:.4f} ms/launch vs bound {b_ms:.4f} ms "
              f"({by}, {flops} operations, {nbytes} B); plain version "
              f"{plain_ms:.4f} ms; scaled_dot_product_attention "
              f"{lib_ms:.4f} ms; max abs err vs plain {err:.3e}")
        rows[route] = dict(
            launches=(routes if route == "tensor_core"
                      else small_routes)[route],
            max_abs_err=max(flash_err[route], err), ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=by, library_ms=lib_ms)
        measured[route] = dict(rows[route], bound_bytes=nbytes,
                               bound_operations=flops, serving_err=err)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    del captured

    # the same server on the plain attention path
    p_logits, p_toks, p_pre, p_dec = serve_once(
        cfg.replace(attn_impl="xla"), params, prompts, LM_STEPS)
    ldiff = float((logits - p_logits).abs().max())
    scale = float(p_logits.abs().max())
    same = float(np.mean(toks == p_toks))
    first = float(np.mean(toks[:, 0] == p_toks[:, 0]))
    print(f"[6] {card}: plain attention path (attn_impl=xla): prefill "
          f"{p_pre * 1e3:.1f} ms, decode {p_dec * 1e3 / LM_STEPS:.2f} "
          f"ms/step; prefill logits max abs diff {ldiff:.4f} (largest "
          f"|logit| {scale:.3f}, tolerance {LM_PATH_LOGIT_TOL}); first "
          f"tokens equal {first:.2f}, all {LM_STEPS} greedy tokens equal "
          f"{same:.4f}")
    if not ldiff <= LM_PATH_LOGIT_TOL:
        raise AssertionError(f"phase 6: kernel and plain attention paths' "
                             f"prefill logits differ by {ldiff}")
    results["phase6"] = dict(
        arch=LM_ARCH, batch=LM_BATCH, max_len=LM_MAX_LEN, prompt=LM_PROMPT,
        steps=LM_STEPS, params=cfg.param_count(), init_s=init_s,
        small_check_diff=diff, prefill_s=pre_s, prefill_tokens_per_s=pre_tps,
        decode_ms_per_step=dec_s * 1e3 / LM_STEPS,
        decode_tokens_per_s=dec_tps, peak_bytes=peak, launches=launches,
        route_launches=routes, small_route_launches=small_routes,
        profile=prof, flash=measured,
        plain_path=dict(prefill_s=p_pre, decode_s=p_dec, logit_diff=ldiff,
                        largest_logit=scale, first_token_share=first,
                        token_share=same))
    return rows


# ---------------------------------------------------------------------------
# phase 7: the compact packings and the vector apply
# ---------------------------------------------------------------------------


def packing_run(cfg, X, y, n: int, cycles: int, device, mode,
                telemetry=None, snaps=None):
    """One run of the sharded engine under packing ``mode`` (None: the
    reference's cost model chooses, ``compact_rounds=True``), every launch
    count set to 0 just before it and read just after; with a forced
    ``mode`` a copy of the last receive launch's inputs (under ``compact``
    the last subset launch) and of the last send launch's (with its
    ``rows``) is kept. Every receive launch must take the grouped route and
    every send launch the tiled one; the receive kernel launches once a
    cycle for ``dense`` and ``compact_all`` chunks and twice for
    ``compact`` ones (K = 1 over all N, then K - 1 rounds over the round-2
    receivers), the send kernel once a cycle. ``snaps`` collects each eval
    point's cache. Returns a dict: res, wall, peak, recv, recv_routes,
    sends, send_routes, cap_r, cap_s."""
    import torch
    from repro_torch.core.simulation import run_simulation
    from repro_torch.core.wire_codec import get_codec
    from repro_torch.kernels import gossip_cycle as gc

    recv, send = gc.fused_receive_apply, gc.quantize_send
    got_r, got_s = {}, {}
    clone = lambda v: v.clone() if isinstance(v, torch.Tensor) else v
    last_r = (cycles * (2 if mode == "compact" else 1) - 1 if mode
              else None)

    def capture_recv(*a, **kw):
        if recv.launches == last_r:
            got_r.update({k: v.clone() for k, v in zip(ORDER, a)})
            got_r.update({k: kw[k].clone() for k in META
                          if kw.get(k) is not None})
            got_r["wire"] = kw.get("wire")
            got_r["defense"] = kw.get("defense", "none")
        return recv(*a, **kw)

    def capture_send(w, name, key=None, ef=None, rows=None):
        if mode and sum(send.launches.values()) == cycles - 1:
            got_s.update(w=w.clone(), name=name, key=clone(key),
                         ef=clone(ef), rows=clone(rows))
        return send(w, name, key=key, ef=ef, rows=rows)

    hook = None
    if snaps is not None:
        def hook(cycle, snap):
            snaps.append([t.clone() for t in (snap.w, snap.t, snap.count,
                                              snap.fresh_w, snap.fresh_t)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gc.fused_receive_apply, gc.quantize_send = capture_recv, capture_send
    try:
        recv.launches = 0
        for counts in (send.launches, recv.route_launches,
                       send.route_launches):
            for k in counts:
                counts[k] = 0
        t0 = time.perf_counter()
        res = run_simulation(cfg, X[:n], y[:n], X[n:], y[n:],
                             engine="sharded", cycles=cycles, eval_every=10,
                             seed=0, k_rounds=4, device=device,
                             compact_mode=mode, compact_rounds=True,
                             serve_hook=hook, telemetry=telemetry)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, sends = recv.launches, sum(send.launches.values())
        routes, send_routes = (dict(recv.route_launches),
                               dict(send.route_launches))
    finally:
        gc.fused_receive_apply, gc.quantize_send = recv, send
    peak = torch.cuda.max_memory_allocated()
    modes = res.compaction["chunk_modes"]
    if mode is not None and modes[mode] != len(res.cycles):
        raise AssertionError(f"{mode}: the chunks took {modes}")
    chunk = 10
    want = chunk * (modes["dense"] + 2 * modes["compact"]
                    + modes["compact_all"])
    if launches != want or routes != dict(grouped=want, strided=0):
        raise AssertionError(f"{mode}: {launches} receive launches by route "
                             f"{routes}, expected {want} grouped")
    want_s = cycles if get_codec(cfg.wire_dtype).quantized else 0
    if sends != want_s or send_routes != dict(tiled=want_s, strided=0):
        raise AssertionError(f"{mode}: {sends} send launches by route "
                             f"{send_routes}, expected {want_s} tiled")
    return dict(res=res, wall=wall, peak=peak, recv=launches,
                recv_routes=routes, sends=sends, send_routes=send_routes,
                cap_r=got_r, cap_s=got_s)


def same_snapshots(a, b, tag: str):
    """Two runs' caches at every eval point, bit for bit."""
    import torch
    if len(a) != len(b):
        raise AssertionError(f"{tag}: {len(a)} snapshots against {len(b)}")
    for sa, sb in zip(a, b):
        for x, y in zip(sa, sb):
            if not torch.equal(x.contiguous().view(torch.uint8),
                               y.contiguous().view(torch.uint8)):
                raise AssertionError(f"{tag}: the cache differs from the "
                                     "dense run's")


def time_send_rows(captured, threefry: dict):
    """The send kernel with ``rows`` on captured ``compact_all`` inputs
    (the senders' rows): bitwise its plain version with the same rows and
    the strided route forced; ms per launch, the strided route's, the
    plain version's, and the bound (the rows' int64 ids read too)."""
    from repro_torch.kernels import gossip_cycle as gc
    w, name, key, ef, rows = (captured[k] for k in ("w", "name", "key",
                                                    "ef", "rows"))
    kw = dict(key=key, ef=ef, rows=rows)
    route = gc.send_route(w.shape[1], name, gc.send_aligned(w, ef))
    got = gc.quantize_send(w, name, **kw)
    want = gc.quantize_send_plain(w, name, **kw)
    names = ("q", "scale", "zp", "resid")
    same_outputs(name, names, got, want, "plain version")
    if route == "tiled":
        same_outputs(name, names, got,
                     run_send(w, name, route="strided", **kw),
                     "strided route")
    ms = cuda_time_ms(lambda: gc.quantize_send(w, name, **kw), reps=20)
    strided_ms = (cuda_time_ms(lambda: run_send(w, name, route="strided",
                                                **kw), reps=20)
                  if route != "strided" else ms)
    plain_ms = cuda_time_ms(lambda: gc.quantize_send_plain(w, name, **kw),
                            reps=5, warmup=1)
    m, d = w.shape
    bound_ms, bound_by, nbytes = send_bound(name, m, d, threefry)
    extra = 8 * m if rows is not None else 0
    bound_ms = max(bound_ms, (nbytes + extra) / HBM_BYTES_PER_S * 1e3)
    return dict(ms=ms, route=route, strided_ms=strided_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes + extra, rows=m)


def check_send_rows(dev):
    """Kernel #2 with ``rows`` against its plain version bit for bit on
    both routes, and, at d = 10, against the dense encode of the whole
    population read at those rows: the noise of a sender's row is the
    dense draw's. Returns the number of shapes checked."""
    import numpy as np
    import torch
    from repro_torch import random
    from repro_torch.kernels import gossip_cycle as gc
    key = random.split(random.key(11, device=dev))[0]
    for m, d, pop in SEND_ROWS_SHAPES:
        rng = np.random.default_rng(m + d)
        rows = torch.as_tensor(np.sort(rng.choice(pop, m, replace=False)),
                               dtype=torch.int64, device=dev)
        w = torch.as_tensor(rng.standard_normal((m, d), dtype=np.float32),
                            device=dev)
        kw = dict(key=key, rows=rows)
        got = gc.quantize_send(w, "int8_sr", **kw)
        names = ("q", "scale", "zp")
        same_outputs("int8_sr rows", names, got,
                     gc.quantize_send_plain(w, "int8_sr", **kw),
                     "plain version")
        same_outputs("int8_sr rows", names, got,
                     run_send(w, "int8_sr", route="strided", **kw),
                     "strided route")
        if d == 10:
            full = torch.zeros((pop, d), device=dev)
            full[rows] = w
            dense = gc.quantize_send(full, "int8_sr", key=key)
            same_outputs("int8_sr rows", names, got,
                         [t[rows] for t in dense], "dense encode's rows")
        print(f"[7] int8_sr send with rows: {m} of {pop} rows at d={d} "
              f"(positions up to {int(rows.max()) * d + d - 1}), route "
              f"{gc.send_route(d, 'int8_sr')}: bitwise the plain version, "
              "the strided route"
              + (" and the dense encode's rows" if d == 10 else ""))
    return len(SEND_ROWS_SHAPES)


def phase7(card: str, results: dict, threefry: dict, dev) -> list:
    """The compact packings and the vector apply on the card: every
    packing bit for bit the dense run at N = 20 000 (extreme) on the f32,
    int8_sr, int4_ef and ternary wires and under sign_flip + norm_clip,
    with kernel #1's and #2-#4's launches by route on the subset paths;
    kernel #2 with ``rows`` bitwise its plain version; Adaline and
    logistic regression on the sharded engine against the reference
    engine; and the three packings timed at N = 10^6, d = 10 in the
    extreme and sparse-d0.8-o0.1 scenarios (armed: wall, node-cycles/s,
    the host's spans, launches, peak memory, kernel #1 on its last
    launch). Returns the ``kernels`` line's rows of the subset launches."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs.gossip_linear import (GossipLinearConfig,
                                                   with_failure_scenario)
    from repro_torch.core import simulation
    from repro_torch.core.simulation import run_simulation
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.data.synthetic import make_linear_dataset
    from repro_torch.kernels import gossip_cycle as gc

    out = results.setdefault("phase7", {})
    n2, cycles = 20_000, 20
    rng = np.random.default_rng(0)
    X, y = make_linear_dataset(rng, n2 + 1000, 10, noise=0.07,
                               separation=2.5)
    cfg2 = with_failure_scenario(GossipLinearConfig(
        name="smoke-20k", dim=10, n_nodes=n2, n_test=1000,
        class_ratio=(1, 1), lam=1e-3, variant="mu", cache_size=10),
        "extreme")
    rows_cap = None
    out["mixes"] = {}
    for wire, fault, defense in PACKING_MIXES:
        cfg = dataclasses.replace(cfg2, wire_dtype=wire, fault_model=fault,
                                  byzantine_frac=0.1 if fault else 0.0,
                                  defense=defense)
        tag = f"{wire or 'f32'}/{fault or 'clean'}/{defense}"
        snaps = {m: [] for m in PACKINGS + (None,)}
        runs = {m: packing_run(cfg, X, y, n2, cycles, dev, m,
                               snaps=snaps[m]) for m in PACKINGS + (None,)}
        base = runs["dense"]["res"]
        row = {}
        for m, r in runs.items():
            if run_outcome(r["res"]) != run_outcome(base):
                raise AssertionError(f"{tag} {m}: differs from the dense "
                                     f"run: {run_outcome(r['res'])[:9]} vs "
                                     f"{run_outcome(base)[:9]}")
            same_snapshots(snaps[m], snaps["dense"], f"{tag} {m}")
            key = m or "chooser"
            row[key] = dict(recv=r["recv"], recv_routes=r["recv_routes"],
                            sends=r["sends"], send_routes=r["send_routes"],
                            chunk_modes=r["res"].compaction["chunk_modes"])
            print(f"[7] {tag} N={n2} {key}: receive launches {r['recv']} "
                  f"{r['recv_routes']}, send launches {r['sends']} "
                  f"{r['send_routes']}, chunks "
                  f"{r['res'].compaction['chunk_modes']}: bit for bit the "
                  "dense run (curves, economy, fault counters, EF norm, "
                  "cache at every eval point)")
        if runs[None]["res"].compaction["chunk_modes"]["compact"] != 2:
            raise AssertionError(f"{tag}: the chooser took "
                                 f"{runs[None]['res'].compaction}")
        out["mixes"][tag] = dict(row, err_fresh=base.err_fresh,
                                 fault_stats=base.fault_stats,
                                 ef_residual_norm=base.ef_residual_norm,
                                 sent=base.sent_total)
        if wire == "int8_sr":
            rows_cap = runs["compact_all"]["cap_s"]
            rows_launches = runs["compact_all"]["sends"]
        del runs, snaps
    out["send_rows_shapes"] = check_send_rows(dev)
    t_rows = time_send_rows(rows_cap, threefry)
    print(f"[7] {card}: quantize_send int8_sr with rows ({t_rows['rows']} "
          f"senders of {n2}): {t_rows['ms']:.4f} ms/launch "
          f"({t_rows['route']}) vs bound {t_rows['bound_ms']:.4f} ms "
          f"({t_rows['bound_by']}); strided {t_rows['strided_ms']:.4f} ms; "
          f"plain {t_rows['plain_ms']:.4f} ms; bitwise equal")
    out["send_rows"] = t_rows

    # the vector apply: Adaline and logistic regression
    out["learners"] = {}
    for learner in VECTOR_LEARNERS:
        cfg = dataclasses.replace(cfg2, learner=learner)
        args = (cfg, X[:n2], y[:n2], X[n2:], y[n2:])
        kw = dict(cycles=cycles, eval_every=10, seed=0, k_rounds=4,
                  device=dev)
        before = gc.fused_receive_apply.launches
        ref = run_simulation(*args, engine="reference", **kw)
        sh = run_simulation(*args, engine="sharded", **kw)
        dense = run_simulation(*args, engine="sharded",
                               compact_mode="dense", **kw)
        if gc.fused_receive_apply.launches != before:
            raise AssertionError(f"{learner}: the vector apply launched "
                                 "the Pegasos receive kernel")
        econ = lambda r: (r.sent_total, r.delivered_total, r.lost_total,
                          r.overflow_total, r.in_flight_total,
                          list(r.delivered_per_cycle))
        if econ(sh) != econ(ref) or run_outcome(sh) != run_outcome(dense):
            raise AssertionError(f"{learner}: economy differs from the "
                                 "reference engine's, or the packing from "
                                 "the dense run")
        diff = max(abs(a - b) for a, b in zip(sh.err_fresh + sh.err_voted,
                                              ref.err_fresh + ref.err_voted))
        if not diff <= 0.02:
            raise AssertionError(f"{learner}: curves differ by {diff}")
        print(f"[7] {learner} N={n2} extreme: sharded (chunks "
              f"{sh.compaction['chunk_modes']}) against the reference "
              f"engine: economy equal (sent {sh.sent_total}), max curve "
              f"difference {diff:.3e}; bit for bit its dense run; err_fresh "
              f"{sh.err_fresh}")
        out["learners"][learner] = dict(curve_diff=diff, sent=sh.sent_total,
                                        err_fresh=sh.err_fresh,
                                        chunk_modes=sh.compaction[
                                            "chunk_modes"])
    torch.cuda.empty_cache()

    # the packings at N = 10^6, armed
    n3 = 1_000_000
    rng = np.random.default_rng(0)
    X, y = make_linear_dataset(rng, n3 + 1000, 10, noise=0.07,
                               separation=2.5)
    rows = []
    out["million"] = {}
    for scenario in PACKING_SCENARIOS:
        cfg = with_failure_scenario(GossipLinearConfig(
            name=f"million-{n3}", dim=10, n_nodes=n3, n_test=1000,
            class_ratio=(1, 1), lam=1e-3, variant="mu", cache_size=10),
            scenario)
        outcome = None
        for mode in PACKINGS:
            tel = Telemetry(label=f"chip_smoke phase 7 {scenario} {mode}")
            simulation._host_scenario.cache_clear()
            r = packing_run(cfg, X, y, n3, cycles, dev, mode, telemetry=tel)
            res = r["res"]
            if outcome is None:
                outcome = run_outcome(res)
            elif run_outcome(res) != outcome:
                raise AssertionError(f"{scenario} {mode}: differs from the "
                                     "dense run at N = 10^6")
            # kernel #1 on the last subset launch (the dense launch over
            # all N is phase 3's)
            t = (time_receive(r["cap_r"], cfg.variant, cfg.lam, 10)
                 if mode != "dense" else None)
            split = span_split(tel)
            rate = n3 * cycles / r["wall"]
            occ = res.compaction
            print(f"[7] {card}: {scenario} {mode} N={n3}: wall "
                  f"{r['wall']:.3f} s (armed), {rate:.0f} node-cycles/s, "
                  f"peak {r['peak'] / 2**30:.2f} GiB, receive launches "
                  f"{r['recv']} {r['recv_routes']}; round-1 occupancy "
                  f"{occ['round1_occupancy_mean']:.4f}, round-2 "
                  f"{occ['multi_occupancy_mean']:.4f}, widths "
                  f"{occ['packed_widths']}")
            if t is not None:
                print(f"[7] {card}:   last receive launch "
                      f"({launch_rows(r['cap_r'])} rows): {receive_line(t)}")
            print(f"[7] {card}:   spans " + ", ".join(
                f"{k} {v['s']:.4f} s ({v['share']:.2%})"
                for k, v in split.items()))
            out["million"][f"{scenario}/{mode}"] = dict(
                wall_s=r["wall"], node_cycles_per_s=rate, peak_bytes=r["peak"],
                launches=r["recv"], route_launches=r["recv_routes"],
                receive=None if t is None else dict(
                    ms=t["ms"], plain_ms=t["plain_ms"],
                    bound_ms=t["bound_ms"], rows=launch_rows(r["cap_r"]),
                    route=t["route"], strided_ms=t["strided_ms"]),
                spans=split, sent=res.sent_total,
                delivered=res.delivered_total, err_fresh=res.err_fresh,
                compaction=res.compaction)
            if mode != "dense" and (scenario, mode) in (
                    ("extreme", "compact"),
                    ("sparse-d0.8-o0.1", "compact_all")):
                rows.append(dict(
                    name=f"fused_receive_apply[{mode}]", route="cuda",
                    source="src/repro_torch/kernels/csrc/gossip_cycle.cu",
                    replaces="src/repro/kernels/gossip_cycle.py:272",
                    launches=r["recv"], max_abs_err=t["err"], ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                    bound_by=t["bound_by"], library_ms=None,
                    receive_route=t["route"], rows=launch_rows(r["cap_r"]),
                    scenario=scenario))
            del r, res, tel
            torch.cuda.empty_cache()
    rows.append(dict(
        name="quantize_send_affine8[rows]", route="cuda",
        source="src/repro_torch/kernels/csrc/quantize_send.cu",
        replaces="src/repro/kernels/gossip_cycle.py:422",
        launches=rows_launches, max_abs_err=0.0, ms=t_rows["ms"],
        plain_ms=t_rows["plain_ms"], bound_ms=t_rows["bound_ms"],
        bound_by=t_rows["bound_by"], library_ms=None,
        send_route=t_rows["route"], rows=t_rows["rows"]))
    return rows


def launch_rows(captured) -> int:
    """The row count of a captured receive launch."""
    return int(captured["last_w"].shape[0])


# ---------------------------------------------------------------------------
# phase 8: the paper's experiments
# ---------------------------------------------------------------------------

# the drivers of repro_torch.paper, run at quick=True, in the order of
# benchmarks/run.py's paper entries
PAPER_DRIVERS = ("table1", "fig1", "fig2", "fig3", "theory")
PAPER_CYCLES = 60       # the drivers' quick cycles
# kernel #6's launches a path takes by (kind, d), and the layout each must
# take: the bagging population (fig1 on spambase, the reuters run) and
# Table I's chain at N = 1 on the three datasets
ROW_PATHS = {("bagging", 57): "tiled", ("bagging", 9947): "strided",
             ("chain", 10): "tiled", ("chain", 57): "tiled",
             ("chain", 9947): "strided"}
# the stated tolerance of tests/test_torch_ensemble.py: W within this share
# of max|W|
BAGGING_W_RTOL = 2e-6


def reset_counts(fn):
    """A kernel wrapper's launch counts set to 0."""
    fn.launches = 0
    for route in fn.route_launches:
        fn.route_launches[route] = 0


def economy_adds_up(res, tag: str):
    """A run's economy adds up and its curves are finite rates."""
    import numpy as np
    if res.sent_total != (res.delivered_total + res.lost_total
                          + res.overflow_total + res.in_flight_total):
        raise AssertionError(f"{tag}: the message economy does not add up")
    curves = res.err_fresh + res.err_voted + res.similarity
    if not (all(np.isfinite(curves))
            and all(0.0 <= e <= 1.0 for e in res.err_fresh + res.err_voted)):
        raise AssertionError(f"{tag}: bad curves {curves}")


def paper_mu_run(cfg, data, dev, cycles: int):
    """Fig. 1's failure-free MU run of ``cfg``'s dataset on the sharded
    engine (kernel #1, counts set to 0 just before and read just after,
    a copy kept of the last launch's inputs) and on the port's reference
    engine on the card: the receive kernel once a cycle on
    ``receive_route``'s route, both economies adding up and equal, the
    curves within 0.02. Returns a dict."""
    import torch
    from repro_torch.core.simulation import run_simulation
    from repro_torch.kernels import gossip_cycle as gc
    X, y, Xt, yt = data
    kw = dict(cycles=cycles, eval_every=max(cycles // 15, 1), seed=0,
              device=dev)
    recv = gc.fused_receive_apply
    got = {}

    def capture(*a, **k):
        if recv.launches == cycles - 1:
            got.update({name: v.clone() for name, v in zip(ORDER, a)})
            got["wire"] = k.get("wire")
            got["defense"] = k.get("defense", "none")
        return recv(*a, **k)

    torch.cuda.synchronize()
    gc.fused_receive_apply = capture
    try:
        reset_counts(recv)
        t0 = time.perf_counter()
        sh = run_simulation(cfg, X, y, Xt, yt, engine="sharded", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, routes = recv.launches, dict(recv.route_launches)
    finally:
        gc.fused_receive_apply = recv
    ref = run_simulation(cfg, X, y, Xt, yt, engine="reference", **kw)
    d = X.shape[1]
    want = dict.fromkeys(gc.RECEIVE_ROUTES, 0)
    want[gc.receive_route(d, 4)] = cycles
    if launches != cycles or routes != want:
        raise AssertionError(f"{cfg.name} mu: {launches} receive launches by "
                             f"route {routes}, expected {want}")
    econ = lambda r: (r.sent_total, r.delivered_total, r.lost_total,
                      r.overflow_total, r.in_flight_total,
                      list(r.delivered_per_cycle))
    for r, tag in ((sh, "sharded"), (ref, "reference")):
        economy_adds_up(r, f"{cfg.name} mu {tag}")
    if econ(sh) != econ(ref) or sh.cycles != ref.cycles:
        raise AssertionError(f"{cfg.name} mu: economy or eval points differ "
                             f"from the reference engine's: {econ(sh)[:5]} "
                             f"vs {econ(ref)[:5]}")
    diff = max(abs(a - b) for a, b in zip(sh.err_fresh + sh.err_voted,
                                          ref.err_fresh + ref.err_voted))
    if not diff <= 0.02:
        raise AssertionError(f"{cfg.name} mu: curves differ from the "
                             f"reference engine's by {diff}")
    return dict(res=sh, wall=wall, launches=launches, routes=routes,
                cap=got, curve_diff=diff)


def bagging_run(data, n_models: int, cycles: int, lam: float, device):
    """``run_weighted_bagging`` (Fig. 1's WB1/WB2) on ``device``. Returns
    (result, each cycle's sample indices and the last step's (W, t), both
    copied to the host after the run, wall s)."""
    from repro_torch import random
    from repro_torch.core import ensemble
    from repro_torch.kernels import ops
    draws, last = [], []
    randint, step = random.randint, ops.pegasos_update

    def keep_draw(*a, **k):
        idx = randint(*a, **k)
        draws.append(idx)
        return idx

    def keep_step(*a, **k):
        out = step(*a, **k)
        last[:] = out
        return out

    random.randint, ops.pegasos_update = keep_draw, keep_step
    try:
        t0 = time.perf_counter()
        res = ensemble.run_weighted_bagging(
            *data, n_models=n_models, cycles=cycles, lam=lam,
            eval_every=max(cycles // 15, 1), device=device)
        wall = time.perf_counter() - t0
    finally:
        random.randint, ops.pegasos_update = randint, step
    return (res, [idx.cpu() for idx in draws], [a.cpu() for a in last],
            wall)


def compare_path_rows(inputs, lam):
    """Kernel #6 on a path's captured inputs (w, t, x, y) against its
    plain version: t equal; w within rtol 2e-5, atol 1e-5 (``compare_rows``)
    in every row but those whose hinge another order of the margin's sum
    may decide the other way (``hinge_may_flip``). Returns (max abs err,
    rows left out)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    w, t = ops.pegasos_update(*inputs, lam=lam)
    pw, pt = ref.pegasos_update_ref(*inputs, lam)
    torch.cuda.synchronize()
    if not torch.equal(t, pt) or not torch.isfinite(w).all():
        raise AssertionError("pegasos_update on a paper path: t differs or w "
                             "is not finite")
    keep = ~hinge_may_flip(inputs)
    if not torch.allclose(w[keep], pw[keep], rtol=2e-5, atol=1e-5):
        raise AssertionError(f"pegasos_update on a paper path: w off by "
                             f"{float((w - pw)[keep].abs().max())}")
    return float((w - pw)[keep].abs().max()), int((~keep).sum())


def time_path_rows(inputs, lam):
    """ms per launch of kernel #6 on a path's captured inputs, replayed
    from a CUDA graph (a call's host time exceeds the kernel's at these
    sizes; the per-call time is kept beside it as ``call_ms``), the other
    layout's where it takes them (None past d = 128) and the plain
    version's the same way, and the bound. Returns a dict."""
    from repro_torch.kernels import pegasos_update as pu
    from repro_torch.kernels import ref
    from repro_torch.kernels import ops
    n, d = inputs[0].shape
    aligned = all(a.data_ptr() % 16 == 0 for a in inputs)
    route = pu.row_route(d, False, aligned)
    other = "strided" if route == "tiled" else (
        "tiled" if d <= pu.TILED_KERNEL_MAX_WIDTH and aligned else None)
    step = lambda: ops.pegasos_update(*inputs, lam=lam)
    ms = graph_time_ms(step, reps=20)
    call_ms = cuda_time_ms(step, reps=20)
    other_ms = None if other is None else graph_time_ms(
        lambda: pu._launch_step(inputs, n, d, lam, route=other), reps=20)
    plain_ms = graph_time_ms(lambda: ref.pegasos_update_ref(*inputs, lam),
                             reps=10)
    b_ms, by, nbytes = rows_bound("pegasos_update", n, d)
    return dict(n=n, d=d, route=route, ms=ms, call_ms=call_ms,
                other_route=other, other_ms=other_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=by, bytes=nbytes)


def phase8(card: str, results: dict, dev) -> list:
    """The paper's experiments on the card: every driver of
    ``repro_torch.paper`` at its quick settings, Fig. 1's failure-free MU
    run and its WB1/WB2 over 2000 models on reuters, with kernel #1's and
    #6's launches counted by route (counts set to 0 before each path and
    read after); every protocol run's economy, the MU runs' curves against
    the reference engine, the reuters bagging on the card against the CPU,
    Theorem 1 on every geometry; #1 and #6 timed on the paths' last-launch
    inputs. Returns the ``kernels`` line's rows."""
    import dataclasses
    import importlib
    import tempfile

    import torch
    from repro_torch.kernels import gossip_cycle as gc
    from repro_torch.kernels import ops
    from repro_torch.kernels import pegasos_update as pu
    from repro_torch.paper import common

    out = results.setdefault("phase8", {})
    t_start = time.perf_counter()
    recv, step6 = gc.fused_receive_apply, ops.pegasos_update
    runs, holds = [], []
    row_routes = {}          # (kind, d) -> launches by layout
    row_last = {}            # (kind, d) -> (the last launch's inputs, lam)
    recv_routes = {}         # d -> launches by route

    def count_recv(*a, **k):
        d = a[0].shape[1]
        before = dict(recv.route_launches)
        r = recv(*a, **k)
        by = recv_routes.setdefault(d, dict.fromkeys(gc.RECEIVE_ROUTES, 0))
        for route, v in recv.route_launches.items():
            by[route] += v - before[route]
        return r

    def count_step(w, t, x, y, *, lam):
        key = ("chain" if w.shape[0] == 1 else "bagging", w.shape[1])
        before = dict(pu.pegasos_update.route_launches)
        r = step6(w, t, x, y, lam=lam)
        by = row_routes.setdefault(key, dict.fromkeys(pu.ROW_ROUTES, 0))
        for route, v in pu.pegasos_update.route_launches.items():
            by[route] += v - before[route]
        row_last[key] = ((w, t, x, y), lam)
        return r

    def keep_run(fn, driver):
        def run(cfg, *a, **k):
            res = fn(cfg, *a, **k)
            runs.append((driver, cfg.name, cfg.variant, cfg.drop_prob,
                         k.get("sampler", "uniform"), res))
            return res
        return run

    def keep_regret(fn):
        def regret(*a, **k):
            tr = fn(*a, **k)
            holds.append(tr.holds)
            return tr
        return regret

    # ---- the drivers at quick, counts set to 0 just before ---------------
    mods = {n: importlib.import_module(f"repro_torch.paper.{n}")
            for n in PAPER_DRIVERS}
    protocol = [n for n, m in mods.items() if hasattr(m, "run_simulation")]
    saved = [(mods[n], "run_simulation", mods[n].run_simulation)
             for n in protocol]
    saved += [(mods["theory"], "mu_chain_regret",
               mods["theory"].mu_chain_regret),
              (common, "OUT_DIR", common.OUT_DIR)]
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        common.OUT_DIR = Path(tmp)       # the drivers' CSVs are not kept
        for n in protocol:
            mods[n].run_simulation = keep_run(mods[n].run_simulation, n)
        mods["theory"].mu_chain_regret = keep_regret(
            mods["theory"].mu_chain_regret)
        gc.fused_receive_apply, ops.pegasos_update = count_recv, count_step
        try:
            reset_counts(recv)
            reset_counts(pu.pegasos_update)
            for name, mod in mods.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mod.run(quick=True, device=dev)
                torch.cuda.synchronize()
                walls[name] = time.perf_counter() - t0
                print(f"[8] {card}: repro_torch.paper.{name} (quick): "
                      f"{walls[name]:.2f} s")
            drivers_recv = recv.launches
            drivers_rows = pu.pegasos_update.launches
        finally:
            gc.fused_receive_apply, ops.pegasos_update = recv, step6
            for m, name, fn in saved:
                setattr(m, name, fn)
    protocol_cycles = 0
    for driver, ds, variant, drop, sampler, res in runs:
        economy_adds_up(res, f"{driver} {ds} {variant} drop={drop} "
                             f"{sampler}")
        protocol_cycles += res.cycles[-1]
    if drivers_recv != protocol_cycles or len(runs) != 11:
        raise AssertionError(f"the drivers' {len(runs)} protocol runs of "
                             f"{protocol_cycles} cycles launched kernel #1 "
                             f"{drivers_recv} times")
    if not holds or not all(holds) or len(holds) != 3:
        raise AssertionError(f"Theorem 1's bound: holds {holds}")
    print(f"[8] the drivers' {len(runs)} protocol runs (sharded engine): "
          f"every economy adds up; kernel #1 launched {drivers_recv} times "
          f"(once a cycle), by d and route {recv_routes}; kernel #6 "
          f"{drivers_rows} times, by path and layout {row_routes}; Theorem "
          f"1 holds on all three geometries")

    # ---- Fig. 1 on reuters: MU, and WB1/WB2 over 2000 models --------------
    paper = {}
    for name in ("spambase", "reuters"):
        X, y, Xt, yt, cfg = common.dataset(name)
        r = paper_mu_run(dataclasses.replace(cfg, variant="mu"),
                         (X, y, Xt, yt), dev, PAPER_CYCLES)
        d = X.shape[1]
        by = recv_routes.setdefault(d, dict.fromkeys(gc.RECEIVE_ROUTES, 0))
        for route, v in r["routes"].items():
            by[route] += v
        paper[name] = r
        print(f"[8] {card}: Fig. 1 {name} mu (N={X.shape[0]} d={d}, "
              f"{PAPER_CYCLES} cycles): {r['wall']:.3f} s, receive launches "
              f"{r['launches']} {r['routes']}; economy equal to the "
              f"reference engine's (sent {r['res'].sent_total}, delivered "
              f"{r['res'].delivered_total}); max curve difference "
              f"{r['curve_diff']:.3e}; err_fresh {r['res'].err_fresh[-1]:.4f}")
    X, y, Xt, yt, cfg = common.dataset("reuters")
    n_models = min(X.shape[0], 2048)
    ops.pegasos_update = count_step
    try:
        reset_counts(pu.pegasos_update)
        bag, draws, last, bag_wall = bagging_run((X, y, Xt, yt), n_models,
                                                 PAPER_CYCLES, cfg.lam, dev)
        torch.cuda.synchronize()
        bag_launches = pu.pegasos_update.launches
    finally:
        ops.pegasos_update = step6
    if bag_launches != PAPER_CYCLES:
        raise AssertionError(f"reuters bagging launched kernel #6 "
                             f"{bag_launches} times")
    t0 = time.perf_counter()
    cbag, cdraws, clast, _ = bagging_run((X, y, Xt, yt), n_models,
                                         PAPER_CYCLES, cfg.lam, "cpu")
    cpu_s = time.perf_counter() - t0
    if len(draws) != PAPER_CYCLES or not all(
            torch.equal(a, b) for a, b in zip(draws, cdraws)):
        raise AssertionError("reuters bagging: the card's sample indices "
                             "differ from the CPU's")
    if not torch.equal(last[1], clast[1]):
        raise AssertionError("reuters bagging: t differs from the CPU's")
    w_err = float((last[0] - clast[0]).abs().max())
    w_max = float(clast[0].abs().max())
    if not w_err <= BAGGING_W_RTOL * w_max:
        raise AssertionError(f"reuters bagging: W differs from the CPU's by "
                             f"{w_err} (max |W| {w_max})")
    bag_diff = max(abs(a - b) for a, b in zip(
        bag.err_wb1 + bag.err_wb2 + bag.err_single,
        cbag.err_wb1 + cbag.err_wb2 + cbag.err_single))
    if bag.cycles != cbag.cycles or not bag_diff <= 0.02:
        raise AssertionError(f"reuters bagging: curves differ from the "
                             f"CPU's by {bag_diff}")
    print(f"[8] {card}: Fig. 1 reuters WB1/WB2 over {n_models} models "
          f"(d={X.shape[1]}, {PAPER_CYCLES} cycles): {bag_wall:.3f} s on the "
          f"card ({cpu_s:.3f} s on the CPU), kernel #6 {bag_launches} "
          f"launches; indices and t equal to the CPU's, W within "
          f"{w_err:.3e} (max |W| {w_max:.4g}), curves within "
          f"{bag_diff:.3e}; WB1 {bag.err_wb1[-1]:.4f}, WB2 "
          f"{bag.err_wb2[-1]:.4f}, single {bag.err_single[-1]:.4f}")
    for key, want in ROW_PATHS.items():
        by = row_routes.get(key, {})
        if not by.get(want) or sum(by.values()) != by[want]:
            raise AssertionError(f"kernel #6 on the {key[0]} path at "
                                 f"d={key[1]}: launches by layout {by}, "
                                 f"expected all on {want}")

    # ---- times on the paths' last-launch inputs ---------------------------
    rows = []
    out["rows"] = {}
    for (kind, d), (inputs, lam) in sorted(row_last.items()):
        err, left = compare_path_rows(inputs, lam)
        t_ = time_path_rows(inputs, lam)
        other = ("" if t_["other_ms"] is None else
                 f"; {t_['other_route']} {t_['other_ms']:.4f} ms on the same "
                 "inputs")
        print(f"[8] {card}: pegasos_update [{kind}] N={t_['n']} d={d}: "
              f"{t_['ms']:.4f} ms/launch in a graph ({t_['route']}; a call "
              f"{t_['call_ms']:.4f} ms) vs bound {t_['bound_ms']:.6f} ms "
              f"({t_['bound_by']}, {t_['bytes']} B){other}; plain "
              f"{t_['plain_ms']:.4f} ms; max abs err vs plain {err:.3e} "
              f"({left} rows whose hinge may flip left out)")
        launches = sum(row_routes[(kind, d)].values())
        out["rows"][f"{kind}/{d}"] = dict(t_, launches=launches,
                                          max_abs_err=err)
        rows.append(dict(
            name=f"pegasos_update[{kind}]", route="cuda",
            source="src/repro_torch/kernels/csrc/pegasos_merge.cu",
            replaces=ROW_KERNELS["pegasos_update"], launches=launches,
            max_abs_err=err, ms=t_["ms"], plain_ms=t_["plain_ms"],
            bound_ms=t_["bound_ms"], bound_by=t_["bound_by"],
            library_ms=None, row_route=t_["route"], n=t_["n"], d=d,
            call_ms=t_["call_ms"], other_route=t_["other_route"],
            other_ms=t_["other_ms"]))
    out["receive"] = {}
    for name, r in paper.items():
        d = r["cap"]["x"].shape[1]
        t_ = time_receive(r["cap"], "mu", r["res"].config.lam, d,
                          1e-4 if d > 64 else 1e-5)
        print(f"[8] {card}: fused_receive_apply [paper] {name} "
              f"N={launch_rows(r['cap'])} d={d}: {receive_line(t_)}")
        launches = sum(recv_routes[d].values())
        out["receive"][name] = dict(ms=t_["ms"], plain_ms=t_["plain_ms"],
                                    bound_ms=t_["bound_ms"],
                                    route=t_["route"], launches=launches,
                                    max_abs_err=t_["err"])
        rows.append(dict(
            name="fused_receive_apply[paper]", route="cuda",
            source="src/repro_torch/kernels/csrc/gossip_cycle.cu",
            replaces="src/repro/kernels/gossip_cycle.py:272",
            launches=launches, max_abs_err=t_["err"], ms=t_["ms"],
            plain_ms=t_["plain_ms"], bound_ms=t_["bound_ms"],
            bound_by=t_["bound_by"], library_ms=None,
            receive_route=t_["route"], dataset=name, d=d))
    del paper, row_last
    torch.cuda.empty_cache()
    out.update(
        driver_walls=walls, receive_routes=recv_routes,
        row_routes={f"{k}/{d}": v for (k, d), v in row_routes.items()},
        runs=[dict(driver=dr, dataset=ds, variant=v, drop=dp, sampler=s,
                   err_fresh=res.err_fresh[-1], sent=res.sent_total)
              for dr, ds, v, dp, s, res in runs],
        theorem1_holds=holds,
        bagging=dict(wall_s=bag_wall, cpu_s=cpu_s, w_err=w_err, w_max=w_max,
                     curve_diff=bag_diff, err_wb1=bag.err_wb1,
                     err_wb2=bag.err_wb2))
    out["seconds"] = time.perf_counter() - t_start
    print(f"[8] {card}: phase 8 took {out['seconds']:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# phase 9: gossip-SGD training
# ---------------------------------------------------------------------------

TRAIN_STEPS = 100       # (a): steps of each reduced train() run (its default)
# (b): qwen3-1.7b at its published widths with the depth cut to 8 layers
# (4 if the peak passes FULL_PEAK_LIMIT), 4 peers, the reference train()'s
# batch of 8 x 128 tokens, AdamW; each merge rule with the exchange it runs
FULL_LAYERS = (8, 4)
FULL_PEAK_LIMIT = 72e9
FULL_PEERS, FULL_BATCH, FULL_SEQ, FULL_STEPS = 4, 8, 128, 3
FULL_RUNS = (("mu", "int4"), ("um", "int8"), ("rw", ""))
FULL_PROFILED = "mu"    # the run that takes one more step, profiled
# (c): the exchange's codecs, and the send kernel each launches per leaf
EXCHANGE_KERNELS = {"bf16": None, "int8": "affine8", "int4": "packed",
                    "ternary": "packed", "int4_ef": "packed"}
# the kernels line's rows of the exchange: kernel -> (codec timed, the
# Pallas call it replaces)
EXCHANGE_ROWS = {"affine8": ("int8", SEND_ROWS["affine8"]),
                 "packed": ("int4", SEND_ROWS["packed"])}


def full_width_runs(card: str, dev, layers: int, out: dict):
    """(b): ``make_gossip_train_step`` at qwen3-1.7b's widths and
    ``layers`` layers under each of ``FULL_RUNS``, from one seeded set of
    weights: each step's loss, peer disagreement and split (fwd+bwd,
    optimizer, merge and, inside it, the exchange; the host synchronizes
    around each part), one more step of ``FULL_PROFILED``'s run under the
    profiler, and each run's peak memory. Returns the last run's stacked
    parameters and the largest peak."""
    import math

    import torch
    from repro_torch.config import GossipConfig, get_config
    from repro_torch.core import gossip_optimizer as go
    from repro_torch.data.lm_data import SyntheticLMDataset
    from repro_torch.models import transformer as T
    from repro_torch.optim import Optimizer, make_optimizer, warmup_cosine
    from repro_torch.utils.tree import tree_map

    cfg = get_config("qwen3-1.7b").replace(num_layers=layers,
                                           attn_impl="chunked")
    p_, b_, s_ = FULL_PEERS, FULL_BATCH, FULL_SEQ
    ds = SyntheticLMDataset(cfg.vocab_size, s_, b_, seed=0)
    batches = [{k: torch.as_tensor(v, device=dev).reshape(p_, b_ // p_, s_)
                for k, v in next(ds).items()} for _ in range(FULL_STEPS)]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    base = tree_map(lambda p: p.detach(), T.init_params(cfg, gen, dev))
    print(f"[9] {card}: {cfg.name} at d_model {cfg.d_model}, "
          f"{cfg.attention.num_heads} q / {cfg.attention.num_kv_heads} kv "
          f"heads of {cfg.attention.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size} (tied), {cfg.param_dtype}, depth cut to "
          f"{layers} layers: {cfg.param_count() / 1e6:.1f} M parameters a "
          f"peer, {p_} peers, batch {b_} x {s_}")

    def loss_fn(p, b):
        return T.lm_loss(p, cfg, b["tokens"], b["labels"])

    split = {}

    def timed(bucket, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            split[bucket] += time.perf_counter() - t0
            return r
        return run

    merge_fn, exchange_fn = go.gossip_merge, go._exchange
    go.gossip_merge = timed("merge", merge_fn)
    go._exchange = timed("exchange", exchange_fn)
    runs, peak_max, params = {}, 0, None
    try:
        for merge, exchange in FULL_RUNS:
            params = None
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            gcfg = GossipConfig(merge=merge, exchange_dtype=exchange)
            opt = make_optimizer("adamw", warmup_cosine(
                1e-3, min(20, FULL_STEPS // 5 + 1), FULL_STEPS))
            opt = Optimizer(opt.init, timed("optimizer", opt.update),
                            opt.name)
            sp = go.stack_for_peers(base, p_)
            state = go.GossipState(sp, opt.init(sp), torch.zeros(
                (), dtype=torch.int32, device=dev))
            del sp
            step_fn = go.make_gossip_train_step(loss_fn, opt, p_, gcfg)
            steps = []
            for s in range(FULL_STEPS):
                split.update(merge=0.0, exchange=0.0, optimizer=0.0)
                perm, _ = go.perms_for_step(gcfg, s, p_)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, loss, _ = step_fn(state, batches[s], perm)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                loss = float(loss)
                dis = float(go.peer_disagreement(state.params))
                if not (math.isfinite(loss) and math.isfinite(dis)):
                    raise AssertionError(f"phase 9 {merge}: step {s + 1} "
                                         f"loss {loss}, disagreement {dis}")
                row = dict(step=s + 1, loss=loss, disagreement=dis,
                           step_s=wall, fwd_bwd_s=wall - split["merge"]
                           - split["optimizer"], **{f"{k}_s": v for k, v
                                                    in split.items()})
                steps.append(row)
                print(f"[9] {card}: {merge} (exchange "
                      f"{exchange or 'f32'}) step {s + 1}: loss {loss:.4f}, "
                      f"peer disagreement {dis:.3e}; {wall:.4f} s = "
                      f"fwd+bwd {row['fwd_bwd_s']:.4f} + optimizer "
                      f"{split['optimizer']:.4f} + merge "
                      f"{split['merge']:.4f} s (exchange "
                      f"{split['exchange']:.4f} s of it)")
            prof = None
            if merge == FULL_PROFILED:
                box = {}

                def one_step():
                    box["state"] = step_fn(state, batches[0], perm)[0]
                prof = profile_run(one_step, "9", card)
                state = box.pop("state")
            peak = torch.cuda.max_memory_allocated()
            peak_max = max(peak_max, peak)
            print(f"[9] {card}: {merge} peak memory {peak} B "
                  f"({peak / 1e9:.2f} GB)")
            runs[merge] = dict(exchange=exchange or "f32", steps=steps,
                               peak_bytes=peak, profile=prof)
            params = state.params
            del state, step_fn, opt
    finally:
        go.gossip_merge, go._exchange = merge_fn, exchange_fn
    out["full"] = dict(layers=layers, params_a_peer=cfg.param_count(),
                       peers=p_, batch=b_, seq=s_, runs=runs)
    return params, peak_max


def leaf_rows(leaf):
    """A stacked leaf's rows as the exchange encodes them: float32, over
    the last axis (a trailing axis of one for a rank-1 leaf)."""
    d = leaf.shape[-1] if leaf.ndim >= 2 else 1
    return leaf.reshape(-1, d).float().contiguous()


def time_exchange_kernel(name: str, leaves, card: str,
                         phase: str = "9") -> dict:
    """The send kernel of codec ``name`` on every leaf's rows of one
    exchange, held bit for bit to the plain version once for each
    distinct (rows, d) shape and timed there (CUDA events, counted once a
    leaf of that shape), beside the plain version and the bound over all
    leaves; the widest leaf of each width printed under ``phase``."""
    import torch
    from repro_torch.kernels import gossip_cycle as gc
    shapes = {}
    for leaf in leaves:
        rows = leaf.numel() // (leaf.shape[-1] if leaf.ndim >= 2 else 1)
        d = leaf.shape[-1] if leaf.ndim >= 2 else 1
        shapes.setdefault((rows, d), [leaf, 0])[1] += 1
    ms = plain_ms = nbytes = ops = 0.0
    widths = {}
    for (n, d), (leaf, count) in sorted(shapes.items()):
        w = leaf_rows(leaf)
        route = gc.send_route(d, name, gc.send_aligned(w))
        same_outputs(name, ("payload", "scale", "zp"),
                     gc.quantize_send(w, name),
                     gc.quantize_send_plain(w, name), "plain version")
        k_ms = cuda_time_ms(lambda: gc.quantize_send(w, name), reps=3,
                            warmup=1)
        p_ms = cuda_time_ms(lambda: gc.quantize_send_plain(w, name), reps=1,
                            warmup=1)
        b_ms, by, b = send_bound(name, n, d, {})
        ms += count * k_ms
        plain_ms += count * p_ms
        nbytes += count * b
        ops += count * 6 * n * d
        if n >= widths.get(d, {}).get("rows", 0):
            widths[d] = dict(rows=n, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                             bound_by=by, route=route, leaves=count)
        del w
    bound_ms, bound_by = bound(nbytes, ops)
    for d, r in sorted(widths.items()):
        print(f"[{phase}] {card}: quantize_send {name} N={r['rows']} d={d} "
              f"({r['route']}): {r['ms']:.4f} ms/launch vs bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}); plain "
              f"{r['plain_ms']:.4f} ms; bitwise equal to the plain version")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, bytes=nbytes, widths={str(d): r for d, r
                                                         in widths.items()},
                routes=sorted({r["route"] for r in widths.values()}),
                shapes=len(shapes))


def phase9(card: str, results: dict, dev) -> list:
    """Gossip-SGD training on the card: (a) ``launch.train.train`` at its
    reduced default under all-reduce and gossip (loss finite and falling);
    (b) qwen3-1.7b's full width, the depth cut, each merge rule; (c) on
    (b)'s stacked parameters one ``gossip_merge`` per codec of
    ``EXCHANGE_KERNELS``, each bit for bit the same merge with the codec's
    plain encode on the card, with send kernels #2 and #4 once a leaf
    (counts set to 0 before (b) and read after (c)'s merges); the
    exchange timed whole and by leaf shape. Returns the ``kernels`` line's
    rows."""
    import math

    import torch
    from repro_torch.config import GossipConfig
    from repro_torch.core import gossip_optimizer as go
    from repro_torch.kernels import gossip_cycle as gc
    from repro_torch.launch.train import train
    from repro_torch.utils.tree import tree_leaves

    t_start = time.perf_counter()
    out = results["phase9"] = {}
    for dist in ("allreduce", "gossip"):
        t0 = time.perf_counter()
        _, hist = train(steps=TRAIN_STEPS, dist=dist, log_every=1)
        wall = time.perf_counter() - t0
        if (len(hist) != TRAIN_STEPS
                or not all(math.isfinite(l_) and math.isfinite(d_)
                           for _, l_, d_ in hist)
                or not hist[-1][1] < hist[0][1]):
            raise AssertionError(f"phase 9: the reduced {dist} run's loss "
                                 f"is not finite and falling: {hist}")
        print(f"[9] {card}: train(dist={dist!r}) at the reduced default, "
              f"{TRAIN_STEPS} steps on the card: loss {hist[0][1]:.4f} -> "
              f"{hist[-1][1]:.4f}, {wall:.2f} s with set-up")
        out[f"reduced_{dist}"] = dict(history=hist, wall_s=wall)
    torch.cuda.empty_cache()

    # the main path: (b)'s exchanges and (c)'s counted merges
    for layers in FULL_LAYERS:
        for counts in (gc.quantize_send.launches,
                       gc.quantize_send.route_launches):
            counts.update(dict.fromkeys(counts, 0))
        params, peak = full_width_runs(card, dev, layers, out)
        if peak <= FULL_PEAK_LIMIT:
            break
        print(f"[9] {card}: peak {peak} B passes {FULL_PEAK_LIMIT:g} at "
              f"{layers} layers; the depth is cut further")
        params = None
    else:
        raise AssertionError(f"phase 9: peak {peak} B at {layers} layers")
    leaves = tree_leaves(params)
    b_launches = dict(gc.quantize_send.launches)
    steps_sending = {k: len(leaves) * sum(
        FULL_STEPS + (m == FULL_PROFILED) for m, x in FULL_RUNS
        if x and EXCHANGE_KERNELS[x] == k) for k in b_launches}
    if b_launches != steps_sending:
        raise AssertionError(f"phase 9 (b): send launches {b_launches}, "
                             f"expected {steps_sending}")
    perm, _ = go.perms_for_step(GossipConfig(), 0, FULL_PEERS)
    plain_send = lambda w, name, **kw: gc.quantize_send_plain(w, name, **kw)
    for name, kernel in EXCHANGE_KERNELS.items():
        before = dict(gc.quantize_send.launches)
        merged = go.gossip_merge(params, perm, exchange_dtype=name)
        sent = {k: gc.quantize_send.launches[k] - before[k] for k in before}
        want = {k: len(leaves) if k == kernel else 0 for k in before}
        if sent != want:
            raise AssertionError(f"phase 9 (c) {name}: send launches {sent}, "
                                 f"expected {want}")
        kernel_send, gc.quantize_send = gc.quantize_send, plain_send
        try:
            plain = go.gossip_merge(params, perm, exchange_dtype=name)
        finally:
            gc.quantize_send = kernel_send
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(tree_leaves(merged),
                                       tree_leaves(plain))):
            if not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
                raise AssertionError(f"phase 9 (c) {name}: leaf {i} of the "
                                     "merge differs from the plain encode's")
        del merged, plain
        print(f"[9] {card}: gossip_merge exchange={name!r} on {len(leaves)} "
              f"leaves: {sent[kernel] if kernel else 0} launches of "
              f"{kernel or 'no send kernel'}, bit for bit the merge with the "
              "codec's plain encode on the card")
    launches = dict(gc.quantize_send.launches)
    routes = dict(gc.quantize_send.route_launches)
    print(f"[9] {card}: send launches on the path {launches}, by route "
          f"{routes}")
    for kernel in EXCHANGE_ROWS:
        if not launches[kernel]:
            raise AssertionError(f"phase 9: {kernel} never launched")

    ex_ms = {}
    for name in EXCHANGE_KERNELS:
        go.gossip_merge(params, perm, exchange_dtype=name)
        ex_ms[name] = cuda_time_ms(
            lambda: go.gossip_merge(params, perm, exchange_dtype=name),
            reps=1, warmup=0)
        print(f"[9] {card}: one exchange of the whole model "
              f"(exchange={name!r}, {len(leaves)} leaves): "
              f"{ex_ms[name]:.3f} ms")
    timed = {name: time_exchange_kernel(name, leaves, card)
             for name in ("int8", "int4", "ternary")}
    rows = []
    for kernel, (name, replaces) in EXCHANGE_ROWS.items():
        t_ = timed[name]
        print(f"[9] {card}: {kernel} [exchange] ({name}): "
              f"{t_['ms']:.4f} ms of kernel time an exchange vs bound "
              f"{t_['bound_ms']:.4f} ms ({t_['bound_by']}, {t_['bytes']:.0f}"
              f" B); plain {t_['plain_ms']:.4f} ms; routes {t_['routes']}")
        rows.append(dict(
            name=f"quantize_send_{kernel}[exchange]", route="cuda",
            source="src/repro_torch/kernels/csrc/quantize_send.cu",
            replaces=replaces, launches=launches[kernel], max_abs_err=0.0,
            ms=t_["ms"], plain_ms=t_["plain_ms"], bound_ms=t_["bound_ms"],
            bound_by=t_["bound_by"], library_ms=None, codec=name,
            send_routes=t_["routes"], leaves=len(leaves)))
    out.update(launches=launches, route_launches=routes,
               exchange_ms=ex_ms, exchange_kernels=timed)
    del params, leaves
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_start
    print(f"[9] {card}: phase 9 took {out['seconds']:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# phase 10: the moe, ssm and hybrid families
# ---------------------------------------------------------------------------


def band_mask(s: int, window, device):
    """The (S, S) boolean mask of kernel #8's causal band: key j visible
    to query i when 0 <= i - j < window."""
    import torch
    i = torch.arange(s, device=device)
    diff = i[:, None] - i[None, :]
    mask = diff >= 0
    if window is not None:
        mask &= diff < window
    return mask


def routed(run, keep: int, pin=None):
    """``run()`` with ``models/moe.py``'s ``route`` recording the expert
    choices of its first ``keep`` calls (a prefill's, one a MoE layer);
    with ``pin``, those calls take ``pin``'s choices instead of their own
    top-k. Returns (run's result, the recorded choices)."""
    from repro_torch.models import moe
    real = moe.route
    seen = []

    def wrapper(params, m, x, experts=None):
        i = len(seen)
        if pin is not None and i < len(pin):
            experts = pin[i]
        out = real(params, m, x, experts=experts)
        if i < keep:
            seen.append(out[2].clone())
        return out
    moe.route = wrapper
    try:
        return run(), seen
    finally:
        moe.route = real


def family_kernel_row(card: str, arch: str, captured: dict, route: str,
                      phase: int = 10):
    """Kernel #8 on a run's own last-attention-layer q, k, v: against its
    plain version, timed, beside its bound and
    ``scaled_dot_product_attention`` with the band as a boolean mask
    (its own causal path for ``CAUSAL_SDPA``; timed only), and the route ``FAMILY_FORCED_ROUTES`` names for
    ``arch``, if any, forced through ``_launch`` on the same q, k, v,
    against the plain version and timed. Returns the row's measured
    numbers."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    q, k, v = captured["q"], captured["k"], captured["v"]
    causal, window = captured["kw"]["causal"], captured["kw"]["window"]
    err = compare_flash(q, k, v, causal, window, route)
    ms = cuda_time_ms(lambda: fa.flash_attention(
        q, k, v, causal=causal, window=window), reps=10)
    plain_ms = cuda_time_ms(lambda: fa.flash_attention_plain(
        q, k, v, causal=causal, window=window), reps=3, warmup=1)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    if arch in CAUSAL_SDPA and causal and window is None:
        lib = "scaled_dot_product_attention(is_causal=True)"
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), reps=10)
    else:
        lib = "scaled_dot_product_attention with the band as a mask"
        mask = band_mask(q.shape[1], window, q.device)
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), reps=3, warmup=1)
    b_ms, by, nbytes, flops = flash_bound(q, k.shape[2], causal, window)
    forced = {}
    other = FAMILY_FORCED_ROUTES.get(arch)
    if other is not None:
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window).float()
        got = fa._launch(q, k, v, causal, window, other).float()
        forced = dict(route=other, max_abs_err=float((got - want).abs().max()),
                      ms=cuda_time_ms(lambda: fa._launch(
                          q, k, v, causal, window, other), reps=10))
        if not torch.allclose(got, want, rtol=2.0 ** -7, atol=3e-2):
            raise AssertionError(f"{arch}: flash_attention forced to {other} "
                                 f"off by {forced['max_abs_err']}")
        del got, want
    print(f"[{phase}] {card}: {arch}: flash_attention ({route}) on the last "
          f"attention layer's q, k, v {tuple(q.shape)} kv {k.shape[2]} "
          f"{str(q.dtype)[6:]} causal={causal} window={window}: {ms:.4f} "
          f"ms/launch vs bound {b_ms:.4f} ms ({by}, {flops} operations, "
          f"{nbytes} B); plain version {plain_ms:.4f} ms; "
          f"{lib} {lib_ms:.4f} ms; max abs err vs plain {err:.3e}"
          + (f"; the {other} route forced on the same q, k, v "
             f"{forced['ms']:.4f} ms/launch, max abs err vs plain "
             f"{forced['max_abs_err']:.3e}" if forced else ""))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=by, library_ms=lib_ms, bound_bytes=nbytes,
                bound_operations=flops, shape=list(q.shape),
                kv_heads=k.shape[2], window=window, forced_route=forced)


def family_run(card: str, dev, run, phase: int = 10, prepare=None) -> dict:
    """One of ``FAMILY_RUNS`` (or ``ENCDEC_RUNS``, ``phase`` 11) at full
    width (see the module note): the served run with kernel #8's launches
    counted from 0 and the last attention layer's q, k, v captured, the
    plain-attention path's run, then #8 on the captured q, k, v.
    ``prepare(params)`` is applied to the seeded weights first, where
    given. Returns the run's numbers."""
    import numpy as np
    import torch
    from repro_torch.config import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gossip_cycle as gc
    from repro_torch.kernels import gossip_merge as gm
    from repro_torch.kernels import pegasos_update as pu
    from repro_torch.kernels import voted_predict as vp
    from repro_torch.models import transformer as T
    arch, layers, batch, max_len, prompt, steps, route = run
    cfg = get_config(arch).replace(num_layers=layers)
    n_attn = sum(k in T.ATTENTION_KINDS for k in cfg.layer_kinds())
    n_moe = layers if cfg.moe is not None else 0
    t0 = time.perf_counter()
    params = T.init_params(cfg, device=dev, seed=0)
    if prepare is not None:
        prepare(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = np.random.default_rng(10).integers(0, cfg.vocab_size,
                                                 (batch, prompt))
    print(f"[{phase}] {arch}: {layers} of {get_config(arch).num_layers} "
          "layers "
          f"({'/'.join(cfg.layer_kinds())}), {cfg.param_count()} parameters "
          f"in {str(cfg.param_dtype)[6:]}, random from a seeded generator "
          f"on the card in {init_s:.2f} s")
    serve_once(cfg, params, prompts[:, :64], 2, max_len)     # warm up

    flash = fa.flash_attention
    captured = {}

    def capture(q, k, v, **kw):
        if flash.launches == n_attn - 1:         # the last attention layer
            captured.update(q=q.clone(), k=k.clone(), v=v.clone(), kw=kw)
        return flash(q, k, v, **kw)

    others = (gc.fused_receive_apply, vp.voted_predict_batched,
              pu.pegasos_update, gm.merge_update)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention = capture
    try:
        for fn in (flash,) + others:
            fn.launches = 0
        flash.route_launches = dict.fromkeys(fa.ROUTES, 0)
        (logits, toks, pre_s, dec_s), experts = routed(
            lambda: serve_once(cfg, params, prompts, steps, max_len), n_moe)
        launches = flash.launches
        routes = dict(flash.route_launches)
        stray = [fn.launches for fn in others]
    finally:
        fa.flash_attention = flash
    peak = torch.cuda.max_memory_allocated()
    want_routes = dict.fromkeys(fa.ROUTES, 0)
    if route is not None:
        want_routes[route] = n_attn
    if launches != n_attn or routes != want_routes or any(stray):
        raise AssertionError(f"phase {phase} {arch}: kernel #8 launched "
                             f"{launches} times (by route {routes}) in a "
                             f"prefill of {n_attn} attention layers, "
                             f"expected {want_routes}; others {stray}")
    if (tuple(logits.shape) != (batch, cfg.vocab_size)
            or not torch.isfinite(logits).all()
            or toks.shape != (batch, steps)
            or not ((0 <= toks) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"phase {phase} {arch}: logits "
                             f"{tuple(logits.shape)}, tokens {toks.shape}")
    pre_tps = batch * prompt / pre_s
    dec_tps = batch * steps / dec_s
    print(f"[{phase}] {card}: {arch} DecodeServer(batch={batch}, "
          f"max_len={max_len}): kernel #8 launches {launches} in the "
          f"prefill (by route {routes}); prefill of {prompt} tokens "
          f"{pre_s * 1e3:.1f} ms ({pre_tps:.0f} tokens/s); {steps} decode "
          f"steps {dec_s * 1e3 / steps:.2f} ms/step ({dec_tps:.1f} "
          f"tokens/s); peak device memory {peak} B ({peak / 2**30:.2f} GiB)")
    print(f"[{phase}] {arch} sample continuation: {toks[0][:16].tolist()}")
    out = dict(arch=arch, layers=layers, batch=batch, max_len=max_len,
               prompt=prompt, steps=steps, params=cfg.param_count(),
               init_s=init_s, prefill_s=pre_s, prefill_tokens_per_s=pre_tps,
               decode_ms_per_step=dec_s * 1e3 / steps,
               decode_tokens_per_s=dec_tps, peak_bytes=peak,
               launches=launches, route_launches=routes)
    if n_attn:
        # the same server on the plain attention path. A MoE router may
        # choose another expert for a token where bf16 leaves two near
        # tied: the paths are then held equal with the kernel path's
        # choices pinned on the plain path's prefill, and the flips counted
        xla = cfg.replace(attn_impl="xla")
        (p_logits, p_toks, p_pre, p_dec), p_experts = routed(
            lambda: serve_once(xla, params, prompts, steps, max_len), n_moe)
        ldiff = float((logits - p_logits).abs().max())
        scale = float(p_logits.abs().max())
        same = float(np.mean(toks == p_toks))
        first = float(np.mean(toks[:, 0] == p_toks[:, 0]))
        flips = [int((a != b).sum()) for a, b in zip(experts, p_experts)]
        pinned = ldiff
        if any(flips):
            toks_t = torch.as_tensor(prompts, device=dev)
            (pin_logits, _), _ = routed(
                lambda: T.prefill(params, xla, toks_t, max_len), n_moe,
                pin=experts)
            pinned = float((logits - pin_logits).abs().max())
            del pin_logits
        print(f"[{phase}] {card}: {arch} on the plain attention path "
              f"(attn_impl=xla): prefill {p_pre * 1e3:.1f} ms, decode "
              f"{p_dec * 1e3 / steps:.2f} ms/step; prefill logits max abs "
              f"diff {ldiff:.4f} (largest |logit| {scale:.3f}, tolerance "
              f"{LM_PATH_LOGIT_TOL}); expert choices that differ in the "
              f"prefill, by layer {flips} of "
              f"{experts[0].numel() if experts else 0}; with the kernel "
              f"path's choices pinned {pinned:.4f}; first tokens equal "
              f"{first:.2f}, all {steps} greedy tokens equal {same:.4f}")
        if not pinned <= LM_PATH_LOGIT_TOL:
            raise AssertionError(f"phase {phase} {arch}: kernel and plain "
                                 f"attention paths' prefill logits differ "
                                 f"by {pinned} (expert choices pinned; "
                                 f"{ldiff} unpinned, flips {flips})")
        out["plain_path"] = dict(prefill_s=p_pre, decode_s=p_dec,
                                 logit_diff=ldiff, largest_logit=scale,
                                 expert_flips=flips,
                                 pinned_logit_diff=pinned,
                                 first_token_share=first, token_share=same)
    del params, logits
    torch.cuda.empty_cache()
    if n_attn:
        out["flash"] = family_kernel_row(card, arch, captured, route, phase)
    del captured
    torch.cuda.empty_cache()
    return out


def family_line_row(run, res) -> dict:
    """The ``kernels`` line's row of kernel #8 in a ``family_run``: its
    launches on the run's route, its numbers on the captured q, k, v, and
    the forced route's time where one was taken."""
    fl = res["flash"]
    forced = fl["forced_route"]
    return dict(
        name=f"flash_attention[{run[6]}:{FAMILY_ROWS[run[0]]}]",
        route="cuda", source=FLASH_SOURCES[run[6]],
        replaces=FLASH_REPLACES, launches=res["launches"],
        **{k: fl[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms")},
        arch=run[0], shape=fl["shape"], kv_heads=fl["kv_heads"],
        window=fl["window"],
        **({f"{forced['route']}_ms": forced["ms"]} if forced else {}))


def phase10(card: str, results: dict, dev) -> list:
    """The moe, ssm and hybrid families (see the module note). Returns
    kernel #8's rows of the ``kernels`` line for ``FAMILY_ROWS``."""
    import torch
    t_start = time.perf_counter()
    out = results["phase10"] = {"small": {}}
    for arch, *_ in FAMILY_RUNS:
        diff, _ = small_server_check(dev, seed=2, arch=arch)
        out["small"][arch] = diff
        print(f"[10] reduced {arch} (f32) served on the card and on the CPU "
              f"with the same weights: prefill logits within {diff:.3e}, 16 "
              "greedy tokens a prompt equal")
    torch.cuda.empty_cache()
    rows = []
    for run in FAMILY_RUNS:
        res = out[run[0]] = family_run(card, dev, run)
        if run[0] in FAMILY_ROWS:
            rows.append(family_line_row(run, res))
    out["seconds"] = time.perf_counter() - t_start
    print(f"[10] {card}: phase 10 took {out['seconds']:.1f} s")
    return rows



# ---------------------------------------------------------------------------
# phase 11: the audio and vlm families
# ---------------------------------------------------------------------------


def set_gates(params, seed: int = 11):
    """Every cross layer's two gates (zero at init, so the layer would add
    nothing) to seeded values in [0.3, 1)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    for lp in params["blocks"]:
        for name in ("gate_attn", "gate_ffn"):
            if name in lp:
                lp[name].data.fill_(float(torch.rand((), generator=g)) * 0.7
                                    + 0.3)


def phase11(card: str, results: dict, dev) -> list:
    """The audio and vlm families (see the module note). Returns kernel
    #8's row of the ``kernels`` line for the vision model."""
    import torch
    t_start = time.perf_counter()
    out = results["phase11"] = {"small": {}}
    for arch, *_ in ENCDEC_RUNS:
        diff, _ = small_server_check(dev, seed=3, arch=arch,
                                     prepare=set_gates)
        out["small"][arch] = diff
        print(f"[11] reduced {arch} (f32, the gates set) served on the card "
              f"and on the CPU with the same weights: prefill logits within "
              f"{diff:.3e}, 16 greedy tokens a prompt equal")
    torch.cuda.empty_cache()
    rows = []
    for run in ENCDEC_RUNS:
        res = out[run[0]] = family_run(card, dev, run, phase=11,
                                       prepare=set_gates)
        if run[0] in FAMILY_ROWS:
            rows.append(family_line_row(run, res))
    out["seconds"] = time.perf_counter() - t_start
    print(f"[11] {card}: phase 11 took {out['seconds']:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# phase 12: llama3-405b served; the moe, ssm and hybrid families trained
# ---------------------------------------------------------------------------

# (a): llama3-405b at its published widths in FAMILY_RUNS' form, the depth
# cut to 4 of 126 layers (3 if the peak passes BIG_PEAK_LIMIT): #8 at GQA
# 16:1 (128 q over 8 kv heads of 128) on the tensor cores
BIG_RUN = ("llama3-405b", 4, 2, 4096, 2048, 16, "tensor_core")
BIG_LAYERS = (4, 3)
BIG_PEAK_LIMIT = 70e9
# (b): the new families trained by gossip at their published widths, the
# depth cut: (arch, layers, optimizer); 2 peers, mu, the int8 exchange
# (kernel #2 on every leaf), batch 4 x 256, 3 steps
TRAIN_FAMILY_RUNS = (("mamba2-780m", 48, "adamw"),
                     ("recurrentgemma-9b", 3, "sgdm"),
                     ("mixtral-8x22b", 1, "sgdm"))
TRAIN_FAMILY_PEERS, TRAIN_FAMILY_EXCHANGE = 2, "int8"
TRAIN_FAMILY_BATCH, TRAIN_FAMILY_SEQ, TRAIN_FAMILY_STEPS = 4, 256, 3
# (c): each family's reduced gossip steps on the card and on the CPU from
# the CPU's seeded weights, losses within REDUCED_TRAIN_RTOL
REDUCED_TRAIN_ARCHS = ("mixtral-8x22b", "llama4-scout-17b-a16e",
                       "mamba2-780m", "recurrentgemma-9b")
REDUCED_TRAIN_STEPS, REDUCED_TRAIN_RTOL = 5, 1e-4


def big_serve(card: str, dev, out: dict):
    """(a): ``family_run`` of ``BIG_RUN`` (the depth cut further while the
    peak passes ``BIG_PEAK_LIMIT``), then the prefill's model FLOPs
    (``launch/roofline.model_flops_for``: 2 N D, N counting the embedding
    table, a gather, and the untied head over all tokens where the
    prefill applies it at the last) over its wall and ``PEAK_FLOPS_BF16``,
    and the same prefill counted on ``meta`` tensors (``roofline.count``
    on ``attn_impl="xla"``) against the model FLOPs and over the wall and
    the peak: the tensor cores' utilization (its scores counted in full,
    where #8 skips the causal half: about 1 % more at this shape).
    Returns (the run, its numbers)."""
    from repro_torch.config import InputShape, get_config
    from repro_torch.launch import roofline, specs
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16
    from repro_torch.models import transformer as T
    arch, _, batch, max_len, prompt, _, _ = BIG_RUN
    for layers in BIG_LAYERS:
        run = (arch, layers) + BIG_RUN[2:]
        res = family_run(card, dev, run, phase=12)
        if res["peak_bytes"] <= BIG_PEAK_LIMIT:
            break
        print(f"[12] {card}: {arch} peak {res['peak_bytes']} B passes "
              f"{BIG_PEAK_LIMIT:g} at {layers} layers; the depth is cut "
              "further")
    else:
        raise AssertionError(f"phase 12: {arch} peak {res['peak_bytes']} B "
                             f"at {layers} layers")
    cfg = get_config(arch).replace(num_layers=layers)
    shape = InputShape("prefill", prompt, batch, "prefill")
    model_flops = roofline.model_flops_for(cfg, shape)
    mfu = model_flops / res["prefill_s"] / PEAK_FLOPS_BF16
    xla = cfg.replace(attn_impl="xla")
    t0 = time.perf_counter()
    flops, nbytes, logits = roofline.count(
        lambda p, t: T.prefill(p, xla, t, max_len)[0],
        T.abstract_params(xla), specs.input_specs(xla, shape)["tokens"])
    count_s = time.perf_counter() - t0
    if logits.device.type != "meta" or flops <= 0:
        raise AssertionError(f"phase 12: meta count {flops} on "
                             f"{logits.device}")
    meta_util = flops / res["prefill_s"] / PEAK_FLOPS_BF16
    print(f"[12] {card}: {arch} prefill model FLOPs (launch/roofline.py "
          f"model_flops_for, 2 N D at {cfg.active_param_count()} "
          f"parameters) {model_flops:.4e} over {res['prefill_s']:.4f} s = "
          f"{model_flops / res['prefill_s']:.4e} FLOP/s, "
          f"{mfu:.4f} of PEAK_FLOPS_BF16 ({PEAK_FLOPS_BF16:g})")
    print(f"[12] {card}: {arch} the same prefill counted on meta tensors "
          f"(attn_impl=xla, {count_s:.2f} s, nothing allocated): "
          f"{flops:.4e} matmul FLOPs, {nbytes:.4e} operand and result bytes "
          f"unfused; counted / model FLOPs {flops / model_flops:.4f}")
    print(f"[12] {card}: {arch} prefill matmul FLOPs counted on meta "
          f"tensors over the wall {flops / res['prefill_s']:.4e} FLOP/s = "
          f"{meta_util:.4f} of PEAK_FLOPS_BF16: the tensor cores' "
          f"utilization (the 2 N D figure above counts the embedding, a "
          f"gather, and the head over every token)")
    res.update(model_flops=model_flops, mfu=mfu, meta_flops=flops,
               meta_bytes=nbytes, meta_over_model=flops / model_flops,
               meta_utilization=meta_util)
    out[arch] = res
    return run, res


def train_family(card: str, dev, arch: str, layers: int,
                 optimizer: str) -> dict:
    """(b): ``launch.train.train`` of ``arch`` at its published widths
    with ``layers`` layers, gossip over ``TRAIN_FAMILY_PEERS`` peers (mu,
    the ``TRAIN_FAMILY_EXCHANGE`` exchange): each step's split (fwd+bwd,
    optimizer, merge; the host synchronizes around each part, through
    wrappers on the trainer's step and optimizer and on
    ``gossip_merge``), the peak, the first loss against ln(vocab), and
    kernel #2's launches (counted from 0 at the run's start, one a leaf a
    merge); then #2 held bit for bit to its plain version on the leaves
    of the run's final parameters stacked for the peers (every distinct
    (rows, d) shape, ``time_exchange_kernel``)."""
    import math

    import torch
    from repro_torch.config import get_config
    from repro_torch.core import gossip_optimizer as go
    from repro_torch.kernels import gossip_cycle as gc
    from repro_torch.launch import train as train_mod
    from repro_torch.models import transformer as T
    from repro_torch.optim import Optimizer
    from repro_torch.utils.tree import tree_leaves

    split, steps = {}, []

    def timed(bucket, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            split[bucket] += time.perf_counter() - t0
            return r
        return run

    real_step, real_opt = train_mod.make_gossip_train_step, \
        train_mod.make_optimizer
    real_merge = go.gossip_merge

    def make_step(*a, **kw):
        step_fn = real_step(*a, **kw)

        def step(*sa, **skw):
            split.update(merge=0.0, optimizer=0.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = step_fn(*sa, **skw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            steps.append(dict(step_s=wall, fwd_bwd_s=wall - split["merge"]
                              - split["optimizer"], merge_s=split["merge"],
                              optimizer_s=split["optimizer"]))
            return r
        return step

    def make_opt(*a, **kw):
        o = real_opt(*a, **kw)
        return Optimizer(o.init, timed("optimizer", o.update), o.name)

    cfg = train_mod.make_example_config(arch, False, layers=layers)
    leaves = len(tree_leaves(T.abstract_params(cfg)))
    counts = gc.quantize_send.launches
    counts.update(dict.fromkeys(counts, 0))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train_mod.make_gossip_train_step, train_mod.make_optimizer = (make_step,
                                                                  make_opt)
    go.gossip_merge = timed("merge", real_merge)
    t0 = time.perf_counter()
    try:
        final, hist = train_mod.train(
            arch, reduced=False, layers=layers, steps=TRAIN_FAMILY_STEPS,
            batch=TRAIN_FAMILY_BATCH, seq_len=TRAIN_FAMILY_SEQ,
            dist="gossip", n_peers=TRAIN_FAMILY_PEERS, merge="mu",
            optimizer=optimizer, exchange_dtype=TRAIN_FAMILY_EXCHANGE,
            log_every=1, device=dev)
    finally:
        train_mod.make_gossip_train_step, train_mod.make_optimizer = (
            real_step, real_opt)
        go.gossip_merge = real_merge
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(counts)
    want = dict.fromkeys(counts, 0)
    want["affine8"] = leaves * TRAIN_FAMILY_STEPS
    if launches != want:
        raise AssertionError(f"phase 12 {arch}: send launches {launches}, "
                             f"expected {want} ({leaves} leaves a merge)")
    losses = [l_ for _, l_, _ in hist]
    if len(losses) != TRAIN_FAMILY_STEPS or not all(
            math.isfinite(l_) for l_ in losses + [d_ for *_, d_ in hist]):
        raise AssertionError(f"phase 12 {arch}: history {hist}")
    ln_v = math.log(cfg.vocab_size)
    print(f"[12] {card}: {arch} trained at d_model {cfg.d_model}, "
          f"{layers} of {get_config(arch).num_layers} layers "
          f"(pattern {'/'.join(cfg.layer_pattern)}), {cfg.param_count()} "
          f"parameters a peer in {str(cfg.param_dtype)[6:]}, "
          f"{TRAIN_FAMILY_PEERS} peers, "
          f"{optimizer}, mu, exchange {TRAIN_FAMILY_EXCHANGE}, batch "
          f"{TRAIN_FAMILY_BATCH} x {TRAIN_FAMILY_SEQ}: losses "
          f"{[round(l_, 4) for l_ in losses]} (first against ln(vocab) "
          f"{ln_v:.4f}: {losses[0] - ln_v:+.4f}), peer disagreement "
          f"{hist[-1][2]:.3e}; {wall:.2f} s with set-up; peak {peak} B "
          f"({peak / 1e9:.2f} GB); kernel #2 launches {launches['affine8']} "
          f"({leaves} leaves x {TRAIN_FAMILY_STEPS} merges)")
    for i, row in enumerate(steps):
        print(f"[12] {card}: {arch} step {i + 1}: {row['step_s']:.4f} s = "
              f"fwd+bwd {row['fwd_bwd_s']:.4f} + optimizer "
              f"{row['optimizer_s']:.4f} + merge {row['merge_s']:.4f} s")
    stacked = tree_leaves(go.stack_for_peers(final, TRAIN_FAMILY_PEERS))
    del final
    exchange = time_exchange_kernel(TRAIN_FAMILY_EXCHANGE, stacked, card,
                                    phase="12")
    del stacked
    print(f"[12] {card}: {arch} kernel #2 ({TRAIN_FAMILY_EXCHANGE}) bit for "
          f"bit equal to quantize_send_plain on all {exchange['shapes']} "
          f"distinct (rows, d) shapes of the {leaves} leaves (the final "
          f"parameters stacked for {TRAIN_FAMILY_PEERS} peers; routes "
          f"{'/'.join(exchange['routes'])}): {exchange['ms']:.4f} ms of "
          f"kernel time an exchange vs bound {exchange['bound_ms']:.4f} ms "
          f"({exchange['bound_by']}); plain {exchange['plain_ms']:.4f} ms")
    return dict(layers=layers, optimizer=optimizer,
                params_a_peer=cfg.param_count(), history=hist, steps=steps,
                wall_s=wall, peak_bytes=peak, first_loss_minus_ln_vocab=(
                    losses[0] - ln_v), send_launches=launches, leaves=leaves,
                exchange=exchange)


def reduced_train_on_card_and_cpu(card: str, dev, arch: str) -> float:
    """(c): ``REDUCED_TRAIN_STEPS`` gossip steps of the reduced ``arch``
    through ``make_gossip_train_step`` as ``launch.train.train`` builds it
    (2 peers, mu, the int8 exchange, AdamW on its warm-up cosine) on the
    card and on the CPU, both from the CPU's seeded weights and the same
    batches: every step's loss within ``REDUCED_TRAIN_RTOL``. Returns the
    largest relative difference."""
    import math

    import torch
    from repro_torch.config import GossipConfig
    from repro_torch.core import gossip_optimizer as go
    from repro_torch.data.lm_data import SyntheticLMDataset
    from repro_torch.launch.train import make_example_config
    from repro_torch.models import transformer as T
    from repro_torch.optim import make_optimizer, warmup_cosine
    from repro_torch.utils.tree import tree_map

    cfg = make_example_config(arch, True).replace(attn_impl="chunked")
    peers, batch, seq, steps = 2, 4, 64, REDUCED_TRAIN_STEPS
    base = T.init_params(cfg, device="cpu", seed=0)
    ds = SyntheticLMDataset(cfg.vocab_size, seq, batch, seed=0)
    batches = [next(ds) for _ in range(steps)]
    gcfg = GossipConfig(schedule="hypercube", merge="mu",
                        exchange_dtype=TRAIN_FAMILY_EXCHANGE)

    def loss_fn(p, b):
        return T.lm_loss(p, cfg, b["tokens"], b["labels"])

    hists = []
    for device in (dev, "cpu"):
        opt = make_optimizer("adamw", warmup_cosine(
            1e-3, min(20, steps // 5 + 1), steps))
        sp = go.stack_for_peers(
            tree_map(lambda p: p.detach().to(device), base), peers)
        state = go.GossipState(sp, opt.init(sp), torch.zeros(
            (), dtype=torch.int32, device=device))
        step_fn = go.make_gossip_train_step(loss_fn, opt, peers, gcfg)
        losses = []
        for s, raw in enumerate(batches):
            b = {k: torch.as_tensor(v, device=device).reshape(
                peers, batch // peers, seq) for k, v in raw.items()}
            perm, _ = go.perms_for_step(gcfg, s, peers)
            state, loss, _ = step_fn(state, b, perm)
            losses.append(float(loss))
        hists.append(losses)
    card_l, cpu_l = hists
    rel = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
    if (len(card_l) != REDUCED_TRAIN_STEPS
            or not all(math.isfinite(a) for a in card_l)
            or not rel <= REDUCED_TRAIN_RTOL):
        raise AssertionError(f"phase 12: reduced {arch} losses on "
                             f"the card {card_l} and the CPU {cpu_l}")
    print(f"[12] {card}: reduced {arch} {REDUCED_TRAIN_STEPS} gossip steps "
          f"(int8 exchange) on the card and the CPU from the same weights "
          f"and batches: losses {[round(a, 6) for a in card_l]}, largest "
          f"relative difference {rel:.3e} (bar {REDUCED_TRAIN_RTOL:g})")
    return rel


def phase12(card: str, results: dict, dev) -> list:
    """(a) llama3-405b served at its published widths with the depth cut,
    against its plain-attention run, #8 on its last layer's q, k, v beside
    ``scaled_dot_product_attention(is_causal=True)``, its model-FLOPs
    utilization and its ``meta`` count; (b) mamba2-780m, recurrentgemma-9b
    and mixtral-8x22b trained by gossip at their published widths, the
    depth cut (``TRAIN_FAMILY_RUNS``), #2 held to its plain version on
    each run's leaves; (c) each family's reduced gossip steps on the card
    against the CPU. Returns kernel #8's row of the
    ``kernels`` line."""
    import torch
    t_start = time.perf_counter()
    out = results["phase12"] = {"train": {}, "reduced_train": {}}
    run, res = big_serve(card, dev, out)
    rows = [family_line_row(run, res)]
    torch.cuda.empty_cache()
    for arch, layers, optimizer in TRAIN_FAMILY_RUNS:
        out["train"][arch] = train_family(card, dev, arch, layers, optimizer)
        torch.cuda.empty_cache()
    for arch in REDUCED_TRAIN_ARCHS:
        out["reduced_train"][arch] = reduced_train_on_card_and_cpu(card, dev,
                                                                   arch)
    out["seconds"] = time.perf_counter() - t_start
    print(f"[12] {card}: phase 12 took {out['seconds']:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# phase 13: the protocol across ranks, two processes sharing the card
# ---------------------------------------------------------------------------

MESH_RANKS = 2              # one card: NCCL refuses two ranks on a device,
MESH_WIRES = (None, "int8_sr")   # so the ranks share cuda:0 over gloo
PEER_LAYERS, PEER_BATCH, PEER_SEQ, PEER_MU_STEPS = 2, 2, 128, 3
PEER_LOSS_RTOL = 1e-6       # the peers' mean loss: a psum against a mean
LINEAR_CYCLES, LINEAR_D, LINEAR_RECORDS = 10, 10, 8


def state_digest(state: dict) -> dict:
    """sha256 of each final lane's bytes (a lane of N rows on the host)."""
    import hashlib

    import torch
    return {k: hashlib.sha256(memoryview(
        v.contiguous().view(-1).view(torch.uint8).numpy())).hexdigest()
        for k, v in state.items()}


def mesh_node_run(rank: int, cfg, X, y, n: int, cycles: int, threefry,
                  mesh, serve_hook=None, telemetry=None,
                  final_state: bool = True) -> dict:
    """One main-path run of this rank over the node mesh (with
    ``serve_hook`` and ``telemetry`` where given), counts set to 0 just
    before it and read just after; rank 0 also times #1 (and #2 on a
    quantized wire, and #5 where the hook serves) on its last launch's
    inputs, a shard of N/W rows, and digests every node's final lanes
    (gathered) with ``final_state``."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import serving
    from repro_torch.core import sharded_engine as se
    from repro_torch.core.simulation import run_simulation
    from repro_torch.kernels import gossip_cycle as gc
    from repro_torch.kernels import voted_predict as vp
    from repro_torch.sharding import compat

    recv, send = gc.fused_receive_apply, gc.quantize_send
    voted = vp.voted_predict_batched
    got_recv, got_send, got_voted = {}, {}, {}
    calls = dict(recv=0, send=0)
    clone = lambda v: v.clone() if isinstance(v, torch.Tensor) else v

    def capture_recv(*a, **kw):
        calls["recv"] += 1
        if calls["recv"] == cycles:
            got_recv.update({k: v.clone() for k, v in zip(ORDER, a)})
            got_recv.update({k: kw[k].clone() for k in META
                             if kw.get(k) is not None})
            got_recv["wire"] = kw.get("wire")
            got_recv["defense"] = kw.get("defense", "none")
        return recv(*a, **kw)

    def capture_send(w, name, key=None, ef=None, rows=None):
        calls["send"] += 1
        if calls["send"] == cycles:
            got_send.update(w=w.clone(), name=name, key=clone(key),
                            ef=clone(ef), rows=clone(rows))
        return send(w, name, key=key, ef=ef, rows=rows)

    def capture_voted(w, count, X, assign=None):
        # the snapshot's lanes are the server's own copies, never written
        got_voted.update(w=w, count=count, Xq=X.clone(), aq=assign.clone())
        return voted(w, count, X, assign=assign)

    routed = dict(s=0.0, bytes=0, plan_s=0.0)
    route_chunk, chunk_tables = (se._HostRouter.route_chunk,
                                 se.NodeShard.chunk_tables)

    def timed_route(router, *a, **kw):
        t0 = time.perf_counter()
        out = route_chunk(router, *a, **kw)
        routed["s"] += time.perf_counter() - t0
        routed["bytes"] += sum(a_.nbytes for a_ in out[0])
        return out

    def timed_tables(shard, *a, **kw):
        t0 = time.perf_counter()
        out = chunk_tables(shard, *a, **kw)
        routed["plan_s"] += time.perf_counter() - t0
        return out

    gc.fused_receive_apply, gc.quantize_send = capture_recv, capture_send
    serving.voted_predict_batched = capture_voted
    se._HostRouter.route_chunk = timed_route
    se.NodeShard.chunk_tables = timed_tables
    try:
        recv.launches = voted.launches = 0
        for counts in (recv.route_launches, send.launches,
                       send.route_launches, voted.route_launches):
            counts.update(dict.fromkeys(counts, 0))
        compat.reset_stats()
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_simulation(cfg, X[:n], y[:n], X[n:], y[n:],
                             engine="sharded", cycles=cycles, eval_every=10,
                             seed=0, k_rounds=4, device="cuda", mesh=mesh,
                             final_state=final_state, serve_hook=serve_hook,
                             telemetry=telemetry)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, routes = recv.launches, dict(recv.route_launches)
        sends, send_routes = dict(send.launches), dict(send.route_launches)
        voted_launches = (voted.launches, dict(voted.route_launches))
        stats, seconds = compat.STATS, dict(compat.SECONDS)
    finally:
        gc.fused_receive_apply, gc.quantize_send = recv, send
        serving.voted_predict_batched = voted
        se._HostRouter.route_chunk = route_chunk
        se.NodeShard.chunk_tables = chunk_tables
    # the other way to share the tables: rank 0 routes alone and
    # broadcasts the winners; time that broadcast of this run's bytes
    win = torch.zeros(routed["bytes"], dtype=torch.uint8)
    dist.barrier()
    t0 = time.perf_counter()
    dist.broadcast(win, src=0)
    bcast_s = time.perf_counter() - t0
    out = dict(outcome=run_outcome(res), wall_s=wall, launches=launches,
               routes=routes, sends=sends, send_routes=send_routes,
               per_op=dict(stats.per_op), count=dict(stats.count),
               wire_bytes=stats.wire_bytes, seconds=seconds,
               route_s=routed["s"], win_bytes=routed["bytes"],
               plan_s=routed["plan_s"], bcast_s=bcast_s,
               compaction=res.compaction, voted=voted_launches,
               ef_residual_norm=res.ef_residual_norm,
               peak_bytes=torch.cuda.max_memory_allocated())
    if rank == 0:
        if final_state:
            out["digest"] = state_digest(res.final_state)
        out["receive"] = time_receive(got_recv, cfg.variant, cfg.lam,
                                      X.shape[1])
        out["receive_rows"] = got_recv["x"].shape[0]
        if got_send:
            out["send"] = time_send_rows(got_send, threefry)
        if got_voted:
            out["voted_timing"] = time_voted_on(**got_voted)
    del res, got_recv, got_send, got_voted
    torch.cuda.empty_cache()
    return out


def mesh_peer_lm(rank: int, world: int, dev, mesh) -> dict:
    """qwen3-1.7b's widths at ``PEER_LAYERS`` layers (f32), one peer a
    rank: PEER_MU_STEPS gossip steps of mu on the int8 exchange (#2 on
    every leaf of this rank's peer) and one of rw, SGD without a clip;
    then the stacked step of all the peers in this process from the same
    weights and batches, and this rank's peer held to its row of it."""
    import torch
    from repro_torch.config import GossipConfig, get_config
    from repro_torch.core import gossip_optimizer as go
    from repro_torch.data.lm_data import SyntheticLMDataset
    from repro_torch.kernels import gossip_cycle as gc
    from repro_torch.models import transformer as T
    from repro_torch.optim import constant, make_optimizer
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = get_config("qwen3-1.7b").replace(num_layers=PEER_LAYERS,
                                           attn_impl="chunked")
    ds = SyntheticLMDataset(cfg.vocab_size, PEER_SEQ, PEER_BATCH, seed=0)
    cfgs = ([GossipConfig(merge="mu", exchange_dtype="int8")] * PEER_MU_STEPS
            + [GossipConfig(merge="rw")])
    batches = [{k: torch.as_tensor(v, device=dev).reshape(
        world, PEER_BATCH // world, PEER_SEQ) for k, v in next(ds).items()}
        for _ in cfgs]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    base = tree_map(lambda p: p.detach(), T.init_params(cfg, gen, dev))
    opt = make_optimizer("sgd", constant(1e-2), grad_clip=0)

    def loss_fn(p, b):
        return T.lm_loss(p, cfg, b["tokens"], b["labels"])

    merge_fn, merge_s = go.gossip_merge, []

    def timed_merge(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = merge_fn(*a, **kw)
        torch.cuda.synchronize()
        merge_s[-1] += time.perf_counter() - t0
        return out

    def run(stacked: bool):
        params = (go.stack_for_peers(base, world) if stacked
                  else tree_map(lambda p: p.clone(), base))
        state = go.GossipState(params, opt.init(params), torch.zeros(
            (), dtype=torch.int32, device=dev))
        losses, walls = [], []
        merge_s.clear()
        for s, gcfg in enumerate(cfgs):
            kw = {} if stacked else dict(mesh=mesh, peer_axes=("data",))
            fn = go.make_gossip_train_step(loss_fn, opt, world, gcfg, **kw)
            perm, _ = go.perms_for_step(gcfg, s, world)
            batch = (batches[s] if stacked else
                     {k: v[rank] for k, v in batches[s].items()})
            merge_s.append(0.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss, _ = fn(state, batch, perm)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(float(loss))
        return state.params, losses, walls, list(merge_s)

    # one forward and backward first, so that neither run's first step
    # carries the process's warm-up
    go._value_and_grad(loss_fn, base, {k: v[rank]
                                       for k, v in batches[0].items()})
    sent = gc.quantize_send.launches
    sent.update(dict.fromkeys(sent, 0))
    go.gossip_merge = timed_merge
    try:
        mine, losses, walls, merges = run(stacked=False)
        launches = dict(sent)
        stacked, one_losses, one_walls, one_merges = run(stacked=True)
    finally:
        go.gossip_merge = merge_fn
    leaves = len(tree_leaves(base))
    equal, max_diff = 0, 0.0
    for a, b in zip(tree_leaves(mine), tree_leaves(stacked)):
        b = b[rank]
        if torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
            equal += 1
        else:
            max_diff = max(max_diff, float((a - b).abs().max()))
    return dict(losses=losses, walls=walls, one_losses=one_losses,
                one_walls=one_walls, merges=merges, one_merges=one_merges,
                launches=launches, leaves=leaves,
                equal_leaves=equal, max_diff=max_diff,
                params=cfg.param_count(),
                peak_bytes=torch.cuda.max_memory_allocated())


def mesh_linear(rank: int, world: int, dev, mesh) -> dict:
    """``linear_gossip_mesh_step`` for LINEAR_CYCLES cycles on the
    hypercube (mu with a drop mask, um, rw), and the same cycles of every
    peer in this process; this rank's models against its own."""
    import numpy as np
    import torch
    from repro_torch.core import gossip_optimizer as go
    from repro_torch.core import peer_sampling as ps
    from repro_torch.core.learners import LinearModel, pegasos_update
    rng = np.random.default_rng(5)
    X = torch.as_tensor(rng.standard_normal(
        (world, LINEAR_RECORDS, LINEAR_D)).astype(np.float32), device=dev)
    y = torch.as_tensor(np.sign(rng.standard_normal(
        (world, LINEAR_RECORDS))).astype(np.float32), device=dev)
    drops = rng.random((LINEAR_CYCLES, world)) < 0.3
    out = {}
    for variant, drop in (("mu", True), ("um", False), ("rw", False)):
        w = torch.zeros(LINEAR_D, device=dev)
        t = torch.zeros((), dtype=torch.int32, device=dev)
        ws = [torch.zeros(LINEAR_D, device=dev) for _ in range(world)]
        ts = [torch.zeros((), dtype=torch.int32, device=dev)
              for _ in range(world)]

        def step(i, w_, t_):
            m = pegasos_update(LinearModel(w_, t_),
                               X[i][t_ % LINEAR_RECORDS],
                               y[i][t_ % LINEAR_RECORDS], 0.1)
            return m.w, m.t

        def merge(ws, ts, c):
            partner = ps.hypercube_partner(c, world)
            src = {int(partner[s]): s for s in range(world)}
            nw, nt = [], []
            for i in range(world):
                keep = drop and drops[c, i]
                w_in = ws[i] if keep else ws[src[i]]
                t_in = ts[i] if keep else ts[src[i]]
                nw.append((ws[i] + w_in) / 2.0)
                nt.append(torch.maximum(ts[i], t_in))
            return nw, nt

        same = True
        for c in range(LINEAR_CYCLES):
            partner = ps.hypercube_partner(c, world)
            pairs = [(s, int(partner[s])) for s in range(world)]
            w, t = go.linear_gossip_mesh_step(
                w, t, X[rank], y[rank], pairs, lam=0.1, variant=variant,
                axis="data", mesh=mesh,
                drop_mask=bool(drops[c, rank]) if drop else None)
            if variant == "um":
                ws, ts = map(list, zip(*(step(i, ws[i], ts[i])
                                         for i in range(world))))
                ws, ts = merge(ws, ts, c)
            else:
                if variant == "mu":
                    ws, ts = merge(ws, ts, c)
                ws, ts = map(list, zip(*(step(i, ws[i], ts[i])
                                         for i in range(world))))
            same &= (torch.equal(w, ws[rank]) and int(t) == int(ts[rank]))
        out[variant] = dict(bitwise=same, w=w.cpu().tolist(), t=int(t))
    return out


def phase13_rank(rank: int, world: int, cfg_fields: dict, n: int,
                 cycles: int, threefry: dict) -> dict:
    """Phase 13 in one rank: (a) the node mesh's main path on each of
    ``MESH_WIRES``, (b) the peer mesh's LM step, (c) the linear cycle."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs.gossip_linear import GossipLinearConfig
    from repro_torch.data.synthetic import make_linear_dataset
    from repro_torch.launch.mesh import make_mesh
    t0 = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    nodes = make_mesh((world,), ("nodes",), "cuda")
    peers = make_mesh((world,), ("data",), "cuda")
    rng = np.random.default_rng(0)
    X, y = make_linear_dataset(rng, n + 1000, 10, noise=0.07,
                               separation=2.5)
    cfg = GossipLinearConfig(**cfg_fields)
    out = {"device": str(dev), "setup_s": time.perf_counter() - t0}
    out["node"] = {str(w): mesh_node_run(
        rank, dataclasses.replace(cfg, wire_dtype=w), X, y, n, cycles,
        threefry, nodes) for w in MESH_WIRES}
    del X, y
    t1 = time.perf_counter()
    out["peer"] = mesh_peer_lm(rank, world, dev, peers)
    torch.cuda.empty_cache()
    out["peer"]["seconds"] = time.perf_counter() - t1
    out["linear"] = mesh_linear(rank, world, dev, peers)
    out["seconds"] = time.perf_counter() - t0
    return out


def phase13(card: str, results: dict, dev, cfg3, X, y, n: int, cycles: int,
            outcomes: dict, threefry: dict) -> list:
    """The protocol across ranks: ``MESH_RANKS`` processes share the card
    over a gloo group (``launch.mesh.run_ranks``). (a) The node mesh:
    phase 3's main path (and phase 4's int8_sr) with N/W nodes a rank:
    each rank's economy, curves and every node's final lanes bit for bit
    the one-process run's (rerun here with ``final_state=True``, itself
    equal to phase 3's and 4's), #1 (and #2) launched on every rank, #1
    and #2 timed on rank 0's shard, the exchange's bytes and seconds, the
    host router's seconds against a broadcast of its winners. (b) The
    peer mesh: qwen3-1.7b's widths at 2 layers, one peer a rank, against
    the stacked step. (c) ``linear_gossip_mesh_step`` against one
    process. Two processes on one card measure what the exchange costs,
    not how the protocol scales. Returns the ``kernels`` line's rows."""
    import dataclasses

    import torch
    from repro_torch.core.simulation import run_simulation
    from repro_torch.launch.mesh import run_ranks
    t_start = time.perf_counter()
    out = results["phase13"] = {"node": {}}
    one = {}
    for wire in MESH_WIRES:
        cfg = dataclasses.replace(cfg3, wire_dtype=wire)
        res = run_simulation(cfg, X[:n], y[:n], X[n:], y[n:],
                             engine="sharded", cycles=cycles, eval_every=10,
                             seed=0, k_rounds=4, device="cuda",
                             final_state=True)
        if run_outcome(res) != outcomes[wire]:
            raise AssertionError(f"phase 13: the one-process {wire} rerun "
                                 "differs from phase 3's / 4's run")
        one[wire] = (run_outcome(res), state_digest(res.final_state))
        del res
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(phase13_rank, MESH_RANKS, dataclasses.asdict(cfg3), n,
                      cycles, threefry, device_type="cuda", timeout_s=600.0,
                      pg_timeout_s=300.0)
    spawn_s = time.perf_counter() - t0
    print(f"[13] {card}: {MESH_RANKS} ranks on {ranks[0]['device']} over "
          f"gloo: {spawn_s:.1f} s from spawn to join, set-up "
          f"{max(r['setup_s'] for r in ranks):.1f} s a rank")
    for wire in MESH_WIRES:
        want, digest = one[wire]
        runs = [r["node"][str(wire)] for r in ranks]
        for rank, r in enumerate(runs):
            if r["outcome"] != want:
                raise AssertionError(f"phase 13 {wire}: rank {rank}'s run "
                                     f"differs: {r['outcome'][:9]} vs "
                                     f"{want[:9]}")
            if r["launches"] != cycles or r["routes"]["grouped"] != cycles:
                raise AssertionError(f"phase 13 {wire}: rank {rank} "
                                     f"launched #1 {r['launches']} times "
                                     f"({r['routes']})")
            if wire and r["sends"]["affine8"] != cycles:
                raise AssertionError(f"phase 13 {wire}: rank {rank} "
                                     f"launched #2 {r['sends']}")
            if r["compaction"]["shards"] != MESH_RANKS:
                raise AssertionError(f"phase 13: {r['compaction']}")
        if runs[0]["digest"] != digest:
            bad = [k for k in digest if runs[0]["digest"][k] != digest[k]]
            raise AssertionError(f"phase 13 {wire}: final lanes {bad} "
                                 "differ from the one-process run's")
        r0 = runs[0]
        a2a = r0["per_op"].get("all-to-all", 0)
        walls = ", ".join(f"{r['wall_s']:.3f}" for r in runs)
        print(f"[13] {card}: node mesh, {wire or 'f32'}, N={n} over "
              f"{MESH_RANKS} ranks ({n // MESH_RANKS} nodes a rank): "
              "economy, curves, fault counters, EF norm and every node's "
              f"final lanes bit for bit the one-process run's; walls {walls}"
              " s; #1 "
              f"launches by rank {[r['launches'] for r in runs]} (all "
              f"grouped), #2 {[r['sends'] for r in runs]} by route "
              f"{[r['send_routes'] for r in runs]}")
        print(f"[13] {card}: {wire or 'f32'} exchange on rank 0: "
              f"{r0['count'].get('all-to-all', 0)} all-to-alls, {a2a} B "
              f"sent, {r0['seconds'].get('all-to-all', 0.0):.3f} s (the "
              "host staging through pinned memory included); eval and "
              f"final gathers {r0['per_op'].get('all-gather', 0)} B in "
              f"{r0['seconds'].get('all-gather', 0.0):.3f} s; screen sums "
              f"{r0['seconds'].get('all-reduce', 0.0):.4f} s; the "
              f"exchange plan and the rank's tables {r0['plan_s']:.3f} s; "
              f"the router {r0['route_s']:.3f} s a rank against "
              f"{r0['bcast_s']:.4f} s to broadcast its {r0['win_bytes']} B "
              "of winners from rank 0; peak "
              f"{r0['peak_bytes'] / 2**30:.2f} GiB a rank")
        rec = r0["receive"]
        print(f"[13] {card}: fused_receive_apply on rank 0's last launch "
              f"({r0['receive_rows']} rows, {wire or 'f32'}): "
              f"{receive_line(rec)}")
        if "send" in r0:
            ts = r0["send"]
            print(f"[13] {card}: quantize_send {wire} with the shard's "
                  f"global rows ({ts['rows']} rows): {ts['ms']:.4f} "
                  f"ms/launch ({ts['route']}) vs bound {ts['bound_ms']:.4f}"
                  f" ms ({ts['bound_by']}, {ts['bytes']} B); plain "
                  f"{ts['plain_ms']:.4f} ms; bitwise the plain version")
        out["node"][str(wire)] = dict(
            walls_s=[r["wall_s"] for r in runs],
            launches=[r["launches"] for r in runs],
            sends=[r["sends"] for r in runs], a2a_bytes=a2a,
            a2a_count=r0["count"].get("all-to-all", 0),
            a2a_s=r0["seconds"].get("all-to-all", 0.0),
            gather_bytes=r0["per_op"].get("all-gather", 0),
            gather_s=r0["seconds"].get("all-gather", 0.0),
            wire_bytes=r0["wire_bytes"], route_s=r0["route_s"],
            plan_s=r0["plan_s"],
            win_bytes=r0["win_bytes"], bcast_s=r0["bcast_s"],
            peak_bytes=r0["peak_bytes"], receive=rec,
            send=r0.get("send"))
    peer = [r["peer"] for r in ranks]
    for rank, p in enumerate(peer):
        want = p["leaves"] * PEER_MU_STEPS
        if p["launches"]["affine8"] != want:
            raise AssertionError(f"phase 13 (b): rank {rank} launched #2 "
                                 f"{p['launches']}, expected {want}")
        for a, b in zip(p["losses"], p["one_losses"]):
            if not abs(a - b) <= PEER_LOSS_RTOL * abs(b):
                raise AssertionError(f"phase 13 (b): rank {rank} losses "
                                     f"{p['losses']} vs the stacked "
                                     f"{p['one_losses']}")
    p0 = peer[0]
    for rank, p in enumerate(peer):
        if p["equal_leaves"] != p["leaves"]:
            raise AssertionError(
                f"phase 13 (b): rank {rank}'s params are bit for bit the "
                f"stacked step's row on {p['equal_leaves']} of "
                f"{p['leaves']} leaves only, max abs diff "
                f"{p['max_diff']:.3e}")
    verdict = "bit for bit the stacked step's row on every leaf"
    print(f"[13] {card}: peer mesh, qwen3-1.7b widths at {PEER_LAYERS} "
          f"layers ({p0['params'] / 1e6:.1f} M parameters a peer, f32), "
          f"{MESH_RANKS} peers as ranks, batch {PEER_BATCH} x {PEER_SEQ}, "
          f"{PEER_MU_STEPS} mu steps (int8) and 1 rw: losses "
          f"{p0['losses']} (stacked {p0['one_losses']}); params {verdict}; "
          f"#2 launches by rank {[p['launches']['affine8'] for p in peer]}"
          f" ({p0['leaves']} leaves x {PEER_MU_STEPS}); step walls "
          f"{[round(w, 3) for w in p0['walls']]} s, of which the merge "
          f"{[round(w, 3) for w in p0['merges']]} s (stacked "
          f"{[round(w, 3) for w in p0['one_walls']]} s, merge "
          f"{[round(w, 3) for w in p0['one_merges']]} s); peak "
          f"{p0['peak_bytes'] / 2**30:.2f} GiB a rank")
    for variant in ("mu", "um", "rw"):
        if not all(r["linear"][variant]["bitwise"] for r in ranks):
            raise AssertionError(f"phase 13 (c): linear_gossip_mesh_step "
                                 f"{variant} differs from one process")
    print(f"[13] {card}: linear_gossip_mesh_step, {MESH_RANKS} ranks, "
          f"{LINEAR_CYCLES} cycles (mu with drops, um, rw): bit for bit the "
          "one-process cycles on every rank")
    out.update(peer=peer, spawn_s=spawn_s,
               rank_seconds=[r["seconds"] for r in ranks])
    out["seconds"] = time.perf_counter() - t_start
    print(f"[13] {card}: phase 13 took {out['seconds']:.1f} s")
    f32, sr = out["node"]["None"], out["node"]["int8_sr"]
    rows = [dict(
        name="fused_receive_apply[mesh]", route="cuda",
        source="src/repro_torch/kernels/csrc/gossip_cycle.cu",
        replaces="src/repro/kernels/gossip_cycle.py:272",
        launches=f32["launches"][0] + sr["launches"][0],
        launches_by_rank=[a + b for a, b in zip(f32["launches"],
                                                sr["launches"])],
        max_abs_err=f32["receive"]["err"], ms=f32["receive"]["ms"],
        plain_ms=f32["receive"]["plain_ms"],
        bound_ms=f32["receive"]["bound_ms"],
        bound_by=f32["receive"]["bound_by"], library_ms=None,
        receive_route=f32["receive"]["route"])]
    ts = sr["send"]
    rows.append(dict(
        name="quantize_send_affine8[mesh]", route="cuda",
        source="src/repro_torch/kernels/csrc/quantize_send.cu",
        replaces="src/repro/kernels/gossip_cycle.py:422",
        launches=sr["sends"][0]["affine8"],
        launches_by_rank=[s_["affine8"] for s_ in sr["sends"]],
        max_abs_err=0.0, ms=ts["ms"], plain_ms=ts["plain_ms"],
        bound_ms=ts["bound_ms"], bound_by=ts["bound_by"], library_ms=None,
        send_route=ts["route"]))
    return rows


# ---------------------------------------------------------------------------
# phase 14: the LM across ranks (launch/specs.py's step builders)
# ---------------------------------------------------------------------------

TP_ARCH = "qwen3-1.7b"          # (a): served whole, tensor parallel
TP_MESH = (1, 2)
TP_BATCH, TP_PROMPT, TP_MAX_LEN, TP_STEPS = 4, 2048, 4096, 16
MOE_ARCH, MOE_LAYERS = "mixtral-8x22b", 1       # (b): 1 of its 56 layers
MOE_MESH, MOE_BATCH, MOE_SEQ = (2, 2), 2, 4608
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = 2, 2, 128  # (c)
TRAIN_STEP = 50     # past half of build_train_step's 100 warmup steps
TP_SEED = 14
# (c)'s bars, measured: bf16 weights and activations, the sums over the
# ranks' shards in another order than one process's
TRAIN_LOSS_RTOL = 2e-3
TRAIN_PARAM_FRAC = 2.0 ** -7    # of a leaf's largest value: two bf16 steps


def _record_flash():
    """Wrap kernel #8's entry (``kernels/ops.py``) to keep the last call's
    local q, k, v and arguments; returns (the record, an undo)."""
    from repro_torch.kernels import ops as kops
    real, seen = kops.flash_attention, {}

    def wrapper(q, k, v, **kw):
        seen.update(q=q, k=k, v=v, kw=kw)
        return real(q, k, v, **kw)
    kops.flash_attention = wrapper
    return seen, lambda: setattr(kops, "flash_attention", real)


def _flash_counts():
    from repro_torch.kernels import flash_attention as fa
    return dict(fa.flash_attention.route_launches)


def _reset_flash():
    from repro_torch.kernels import flash_attention as fa
    counts = fa.flash_attention.route_launches
    counts.update(dict.fromkeys(counts, 0))


def _stats():
    from repro_torch.sharding import compat
    return dict(count=dict(compat.STATS.count),
                bytes=dict(compat.STATS.per_op),
                wire=compat.STATS.wire_bytes,
                seconds={k: round(v, 4) for k, v in compat.SECONDS.items()})


def _sync_wall(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def tp_serve(rank: int, card: str, mesh) -> dict:
    """(a): qwen3-1.7b whole (28 layers, bf16) on the (1, 2) mesh: the
    one-process fused prefill of 4 x 2048 tokens and TP_STEPS greedy steps
    first, then ``build_prefill_step(cache_len=)`` and
    ``build_decode_step(profile="context")`` on the weights of the same
    seed placed by the rules; kernel #8 counted on the sharded prefill
    and, on rank 0, timed on its last local q, k, v."""
    import torch
    import torch.distributed as dist
    from repro_torch.config import InputShape, get_config
    from repro_torch.launch import specs
    from repro_torch.models import transformer as T
    from repro_torch.sharding import compat
    from repro_torch.sharding.rules import distribute_params
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(TP_ARCH)
    params = T.init_params(cfg, device=dev, seed=TP_SEED)
    g = torch.Generator(device=dev)
    g.manual_seed(TP_SEED + 1)
    prompts = torch.randint(0, cfg.vocab_size, (TP_BATCH, TP_PROMPT),
                            generator=g, device=dev, dtype=torch.int32)
    with torch.no_grad():
        (one, cache), one_prefill_s = _sync_wall(
            lambda: T.prefill(params, cfg, prompts, TP_MAX_LEN))
        one_logits = one.float().cpu()
        tok = torch.argmax(one, -1).to(torch.int32)
        one_toks = [tok.cpu()]
        t0 = time.perf_counter()
        for i in range(TP_STEPS - 1):
            lg, cache = T.decode_step(params, cfg, tok, cache, TP_PROMPT + i)
            tok = torch.argmax(lg, -1).to(torch.int32)
            one_toks.append(tok.cpu())
        torch.cuda.synchronize()
        one_decode_s = time.perf_counter() - t0
    del cache, one, lg
    pshape = InputShape("tp", TP_PROMPT, TP_BATCH, "prefill")
    dshape = InputShape("tp", TP_MAX_LEN, TP_BATCH, "decode")
    pfn, _, ppl = specs.build_prefill_step(cfg, pshape, mesh,
                                           cache_len=TP_MAX_LEN,
                                           decode_profile="context")
    dfn, _, dpl = specs.build_decode_step(cfg, dshape, mesh,
                                          profile="context")
    dp = distribute_params(params, mesh, ppl[0])
    del params
    torch.cuda.empty_cache()
    batch = distribute_params({"tokens": prompts}, mesh, ppl[1])
    torch.cuda.reset_peak_memory_stats()
    seen, undo = _record_flash()
    _reset_flash()
    compat.reset_stats()
    try:
        with torch.no_grad():
            (logits, cache), prefill_s = _sync_wall(lambda: pfn(dp, batch))
    finally:
        undo()
    launches = _flash_counts()
    prefill_stats = _stats()
    logits_pl = [str(p) for p in logits.placements]
    full = logits.full_tensor().float().cpu()
    tok = torch.argmax(full, -1).to(torch.int32).to(dev)
    toks = [tok.cpu()]
    compat.reset_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(TP_STEPS - 1):
            dtok = distribute_params({"t": tok}, mesh, {"t": dpl[1]})["t"]
            lg, cache = dfn(dp, dtok, cache, TP_PROMPT + i)
            tok = torch.argmax(lg.full_tensor(), -1).to(torch.int32)
            toks.append(tok.cpu())
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    decode_stats = _stats()
    peak = torch.cuda.max_memory_allocated()
    same = float(torch.mean((torch.stack(toks) == torch.stack(one_toks))
                            .float()))
    out = dict(
        err=float((full - one_logits).abs().max()),
        top=float(one_logits.abs().max()), same_tokens=same,
        first_same=float(torch.mean((toks[0] == one_toks[0]).float())),
        prefill_s=prefill_s, decode_ms=decode_s * 1e3 / (TP_STEPS - 1),
        one_prefill_s=one_prefill_s,
        one_decode_ms=one_decode_s * 1e3 / (TP_STEPS - 1),
        launches=launches, prefill_stats=prefill_stats,
        decode_stats=decode_stats, peak_bytes=peak, logits_pl=logits_pl,
        wq_pl=[str(p) for p in dp["blocks"][0]["attn"]["wq"].placements],
        cache_pl=[str(p) for p in cache[0]["k"].placements],
        local_q=list(seen["q"].shape), local_k=list(seen["k"].shape))
    del dp, cache, batch, logits
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        out["row"] = family_kernel_row(card, f"{TP_ARCH}[tp]", seen,
                                       "tensor_core", phase=14)
    del seen
    dist.barrier()
    torch.cuda.empty_cache()
    return out


def tp_moe(rank: int, card: str, mesh) -> dict:
    """(b): mixtral-8x22b at 1 of its 56 layers on the (2, 2) mesh, G = 2
    dispatch groups over 'data' and the reduce combine
    (``specs._with_dispatch_groups``): the one-process forward first (the
    gather combine; its expert choices recorded), then
    ``build_prefill_step`` on the same seed's weights placed by the rules,
    each rank's groups pinned to the one-process choices (bf16 near-ties
    would flip some)."""
    import torch
    from repro_torch.config import InputShape, get_config
    from repro_torch.launch import specs
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.sharding import compat
    from repro_torch.sharding.rules import distribute_params
    dev = torch.device("cuda", torch.cuda.current_device())
    shape = InputShape("moe", MOE_SEQ, MOE_BATCH, "prefill")
    cfg = specs._with_dispatch_groups(
        get_config(MOE_ARCH).replace(num_layers=MOE_LAYERS), shape, mesh)
    params = T.init_params(cfg, device=dev, seed=TP_SEED)
    g = torch.Generator(device=dev)
    g.manual_seed(TP_SEED + 2)
    prompts = torch.randint(0, cfg.vocab_size, (MOE_BATCH, MOE_SEQ),
                            generator=g, device=dev, dtype=torch.int32)
    with torch.no_grad():
        ((one, _), choices), one_s = _sync_wall(lambda: routed(
            lambda: T.forward(params, cfg, prompts, last_only=True),
            MOE_LAYERS))
    one = one.float().cpu()
    fn, _, pl = specs.build_prefill_step(cfg, shape, mesh)
    dp = distribute_params(params, mesh, pl[0])
    del params
    torch.cuda.empty_cache()
    batch = distribute_params({"tokens": prompts}, mesh, pl[1])
    data = compat.mesh_axis(mesh, ("data",)).index
    per = cfg.moe.dispatch_groups // mesh.mesh.shape[0]
    pin = [c[data * per:(data + 1) * per] for c in choices]
    torch.cuda.reset_peak_memory_stats()
    before = dict(moe.COMBINE_COUNTS)
    seen, undo = _record_flash()
    _reset_flash()
    compat.reset_stats()
    try:
        with torch.no_grad():
            (logits, _), wall = _sync_wall(lambda: routed(
                lambda: fn(dp, batch), MOE_LAYERS, pin=pin))
    finally:
        undo()
    full = logits.full_tensor().float().cpu()
    return dict(
        err=float((full - one).abs().max()), top=float(one.abs().max()),
        wall_s=wall, one_s=one_s, launches=_flash_counts(),
        combine={k: moe.COMBINE_COUNTS[k] - before[k] for k in before},
        stats=_stats(), peak_bytes=torch.cuda.max_memory_allocated(),
        groups=cfg.moe.dispatch_groups, combine_cfg=cfg.moe.combine,
        w_up_pl=[str(p) for p in dp["blocks"][0]["ffn"]["w_up"].placements],
        local_q=list(seen["q"].shape), local_k=list(seen["k"].shape),
        window=seen["kw"]["window"])


def _leaf_gap(got, want) -> tuple:
    """(largest |got - want| over the leaf's largest |want|, the share of
    elements that differ)."""
    g, w = got.float(), want.float()
    top = float(w.abs().max())
    diff = (g - w).abs()
    return float(diff.max()) / max(top, 1e-30), float((diff > 0).float()
                                                        .mean())


def tp_train(rank: int, world: int, card: str, mesh, gossip: bool) -> dict:
    """(c): qwen3-1.7b at TRAIN_LAYERS layers (bf16), one
    ``build_train_step`` step at step TRAIN_STEP: all-reduce (AdamW) on
    the (2, 1) mesh, FSDP over 'data', against the one-process
    ``make_allreduce_train_step``; or gossip (mu, int8, SGD) on the (2, 2)
    mesh, the peers the 'data' ranks, each tensor parallel over 'model',
    against the stacked step of both peers, kernel #2 encoding each
    rank's local rows (counted, and on rank 0 held bit for bit to its
    plain version and timed on them)."""
    import torch
    import torch.distributed as dist
    from repro_torch.config import GossipConfig, InputShape, get_config
    from repro_torch.core import gossip_optimizer as go
    from repro_torch.kernels import gossip_cycle as gc
    from repro_torch.launch import specs
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import zeros_of
    from repro_torch.optim import make_optimizer, warmup_cosine
    from repro_torch.sharding import compat
    from repro_torch.sharding.rules import distribute_params
    from repro_torch.utils.tree import tree_leaves, tree_map
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(TP_ARCH).replace(num_layers=TRAIN_LAYERS,
                                      attn_impl="chunked")
    shape = InputShape("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    optimizer = "sgd" if gossip else "adamw"
    opt = make_optimizer(optimizer, warmup_cosine(3e-4, 100, 10_000))
    g = torch.Generator(device=dev)
    g.manual_seed(TP_SEED + 3)
    toks = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                         generator=g, device=dev, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    step0 = torch.tensor(TRAIN_STEP, dtype=torch.int32, device=dev)
    loss_fn = specs.make_loss_fn(cfg)
    if gossip:
        peers = mesh.mesh.shape[0]
        me = compat.mesh_axis(mesh, ("data",)).index
        gcfg = GossipConfig(merge="mu", exchange_dtype="int8")
        each = [tree_map(lambda p: p.detach(), T.init_params(
            cfg, device=dev, seed=TP_SEED + 10 + p)) for p in range(peers)]
        stacked = tree_map(lambda *xs: torch.stack(xs), *each)
        perm, _ = go.perms_for_step(gcfg, 0, peers)
        one_fn = go.make_gossip_train_step(loss_fn, opt, peers, gcfg)
        sbatch = {k: v.reshape(peers, TRAIN_BATCH // peers, -1)
                  for k, v in batch.items()}
        st, one_loss, _ = one_fn(go.GossipState(stacked, opt.init(stacked),
                                                step0), sbatch, perm)
        want = tree_map(lambda a: a[me], st.params)
        del st, stacked
        fn, args, pl = specs.build_train_step(cfg, shape, mesh,
                                              optimizer=optimizer,
                                              gossip=gcfg, n_peers=peers)
        on = specs.peer_mesh(mesh)
        params = each[me]
        mine = {k: v[me] for k, v in sbatch.items()}
        del each
    else:
        params = tree_map(lambda p: p.detach(), T.init_params(
            cfg, device=dev, seed=TP_SEED + 10))
        want = tree_map(lambda p: p.clone(), params)
        one_state = opt.init(want)
        want, _, one_loss, _ = go.make_allreduce_train_step(loss_fn, opt)(
            want, one_state, batch, step0)
        del one_state
        fn, args, pl = specs.build_train_step(cfg, shape, mesh,
                                              optimizer=optimizer)
        on = mesh
        mine = batch
    dp = distribute_params(params, on, pl[0])
    dopt = distribute_params(zeros_of(args[1], dev), on, pl[1])
    dbatch = distribute_params(mine, on, pl[3])
    dstep = distribute_params({"s": step0}, on, {"s": pl[2]})["s"]
    del params
    torch.cuda.empty_cache()
    sent = gc.quantize_send.launches
    sent.update(dict.fromkeys(sent, 0))
    real_send, rows = gc.quantize_send, []

    def keep_rows(w, name, *a, **kw):
        rows.append(w)
        return real_send(w, name, *a, **kw)
    gc.quantize_send = keep_rows
    keep_rows.launches = real_send.launches
    compat.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    try:
        (new_p, _, new_step, loss), wall = _sync_wall(
            lambda: fn(dp, dopt, dstep, dbatch))
    finally:
        gc.quantize_send = real_send
    launches = dict(sent)
    stats = _stats()
    peak = torch.cuda.max_memory_allocated()
    loss = float(loss.full_tensor() if hasattr(loss, "full_tensor")
                 else loss)
    gaps = [_leaf_gap(a.full_tensor(), b) for a, b in
            zip(tree_leaves(new_p), tree_leaves(want))]
    out = dict(loss=loss, one_loss=float(one_loss), wall_s=wall,
               step=int(new_step), launches=launches, stats=stats,
               peak_bytes=peak, leaves=len(gaps),
               max_gap=max(a for a, _ in gaps),
               differ=max(b for _, b in gaps),
               w_up_pl=[str(p) for p in
                        dp["blocks"][0]["ffn"]["w_up"].placements],
               routes=sorted({gc.send_route(
                   r.shape[-1], "int8", gc.send_aligned(r)) for r in rows}))
    del dp, dopt, new_p, want
    torch.cuda.empty_cache()
    if gossip:
        dist.barrier()
        if rank == 0:
            out["send"] = time_exchange_kernel("int8", rows, card,
                                               phase="14")
        dist.barrier()
    return out


def phase14_rank(rank: int, world: int, card: str) -> dict:
    """Phase 14 in one rank: on 2 ranks (a) and the all-reduce step of
    (c); on 4 ranks (b) and the gossip step of (c)."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    t0 = time.perf_counter()
    out = {"device": str(torch.device("cuda", torch.cuda.current_device()))}
    if world == 2:
        out["serve"] = tp_serve(rank, card, make_mesh(TP_MESH,
                                                      ("data", "model")))
        out["train"] = tp_train(rank, world, card,
                                make_mesh((2, 1), ("data", "model")), False)
    else:
        out["moe"] = tp_moe(rank, card, make_mesh(MOE_MESH,
                                                  ("data", "model")))
        torch.cuda.empty_cache()
        out["train"] = tp_train(rank, world, card,
                                make_mesh((2, 2), ("data", "model")), True)
    out["seconds"] = time.perf_counter() - t0
    return out


def phase14(card: str, results: dict) -> list:
    """The LM across ranks (``launch/specs.py``): ranks share the card
    over gloo (``launch.mesh.run_ranks``; DTensor's collectives staged
    through host memory, ``sharding.compat.stage_functional_collectives``),
    each held to a one-process run of the same seeded weights in its own
    process. (a) qwen3-1.7b whole, tensor parallel over 2 ranks: the
    prefill logits within ``LM_PATH_LOGIT_TOL``, 28 launches of #8 a rank
    on its 8 query and 4 kv heads; (b) mixtral-8x22b's reduce combine on
    4 ranks; (c) a sharded train step, all-reduce and gossip. Two or four
    processes on one card measure what the layout costs, not how it
    scales. Returns the ``kernels`` line's rows."""
    from repro_torch.launch.mesh import run_ranks
    t_start = time.perf_counter()
    out = results["phase14"] = {}
    two = run_ranks(phase14_rank, 2, card, device_type="cuda",
                    timeout_s=400.0, pg_timeout_s=300.0)
    four = run_ranks(phase14_rank, 4, card, device_type="cuda",
                     timeout_s=400.0, pg_timeout_s=300.0)
    serve = [r["serve"] for r in two]
    for rank, s in enumerate(serve):
        if s["launches"] != {"tensor_core": 28, "cuda_core": 0}:
            raise AssertionError(f"phase 14 (a): rank {rank} launched #8 "
                                 f"{s['launches']}")
        if s["local_q"] != [TP_BATCH, TP_PROMPT, 8, 128] \
                or s["local_k"] != [TP_BATCH, TP_PROMPT, 4, 128]:
            raise AssertionError(f"phase 14 (a): rank {rank}'s #8 took q "
                                 f"{s['local_q']}, k {s['local_k']}")
        if not s["err"] <= LM_PATH_LOGIT_TOL:
            raise AssertionError(f"phase 14 (a): rank {rank}'s prefill "
                                 f"logits off by {s['err']}")
        print(f"[14] {card}: (a) {TP_ARCH} whole ({TP_BATCH} x {TP_PROMPT} "
              f"prompt, bf16), TP over {TP_MESH} (data, model), rank "
              f"{rank}: prefill logits within {s['err']:.4f} of the one-"
              f"process run (largest |logit| {s['top']:.3f}, tolerance "
              f"{LM_PATH_LOGIT_TOL}); greedy tokens equal {s['same_tokens']:.4f}"
              f" over {TP_STEPS} steps (first {s['first_same']:.2f}); "
              f"prefill {s['prefill_s'] * 1e3:.1f} ms (one process "
              f"{s['one_prefill_s'] * 1e3:.1f} ms), decode "
              f"{s['decode_ms']:.2f} ms/step (one process "
              f"{s['one_decode_ms']:.2f}); #8 {s['launches']} on q "
              f"{s['local_q']} k {s['local_k']}; wq {s['wq_pl']}, logits "
              f"{s['logits_pl']}, cache {s['cache_pl']}; peak "
              f"{s['peak_bytes'] / 2**30:.2f} GiB")
        print(f"[14] {card}: (a) rank {rank} collectives: prefill "
              f"{s['prefill_stats']}; decode {s['decode_stats']}")
    moe_runs = [r["moe"] for r in four]
    for rank, m in enumerate(moe_runs):
        if m["combine"] != {"reduce": MOE_LAYERS, "gather": 0}:
            raise AssertionError(f"phase 14 (b): rank {rank} took "
                                 f"{m['combine']}, not the reduce combine")
        if m["launches"]["tensor_core"] != MOE_LAYERS:
            raise AssertionError(f"phase 14 (b): rank {rank} launched #8 "
                                 f"{m['launches']}")
        if not m["err"] <= LM_PATH_LOGIT_TOL:
            raise AssertionError(f"phase 14 (b): rank {rank}'s logits off "
                                 f"by {m['err']}")
        print(f"[14] {card}: (b) {MOE_ARCH} at {MOE_LAYERS} of 56 layers, "
              f"{MOE_BATCH} x {MOE_SEQ} tokens, {MOE_MESH} (data, model), G "
              f"= {m['groups']}, rank {rank}: combine {m['combine']}; "
              f"logits within {m['err']:.4f} of the one-process gather "
              f"combine (largest |logit| {m['top']:.3f}), expert choices "
              f"pinned; prefill {m['wall_s'] * 1e3:.1f} ms (one process "
              f"{m['one_s'] * 1e3:.1f} ms); #8 {m['launches']} on q "
              f"{m['local_q']} k {m['local_k']} window {m['window']}; w_up "
              f"{m['w_up_pl']}; collectives {m['stats']}; peak "
              f"{m['peak_bytes'] / 2**30:.2f} GiB")
    for label, runs in (("all-reduce (AdamW), (2, 1)",
                         [r["train"] for r in two]),
                        ("gossip (mu, int8, SGD), (2, 2)",
                         [r["train"] for r in four])):
        for rank, t in enumerate(runs):
            ok_loss = abs(t["loss"] - t["one_loss"]) <= \
                TRAIN_LOSS_RTOL * abs(t["one_loss"])
            if not ok_loss or not t["max_gap"] <= TRAIN_PARAM_FRAC \
                    or t["step"] != TRAIN_STEP + 1:
                raise AssertionError(
                    f"phase 14 (c) {label}: rank {rank} loss {t['loss']} vs "
                    f"{t['one_loss']}, largest leaf gap {t['max_gap']:.3e}, "
                    f"step {t['step']}")
            print(f"[14] {card}: (c) {TP_ARCH} at {TRAIN_LAYERS} layers, "
                  f"{label}, rank {rank}: loss {t['loss']:.6f} (one process "
                  f"{t['one_loss']:.6f}); every leaf within "
                  f"{t['max_gap']:.3e} of its largest value (bar "
                  f"{TRAIN_PARAM_FRAC:.3e}), at most {t['differ']:.4f} of a "
                  f"leaf's elements differ; step {t['wall_s'] * 1e3:.1f} ms;"
                  f" w_up {t['w_up_pl']}; #2 {t['launches']} "
                  f"({t['routes']}); collectives {t['stats']}; peak "
                  f"{t['peak_bytes'] / 2**30:.2f} GiB")
    gossip = [r["train"] for r in four]
    for rank, t in enumerate(gossip):
        if t["launches"].get("affine8", 0) != t["leaves"]:
            raise AssertionError(f"phase 14 (c): rank {rank} launched #2 "
                                 f"{t['launches']}, not once a leaf "
                                 f"({t['leaves']})")
    out.update(serve=serve, moe=moe_runs, train=[r["train"] for r in two],
               gossip=gossip, rank_seconds=[r["seconds"] for r in two + four])
    out["seconds"] = time.perf_counter() - t_start
    print(f"[14] {card}: phase 14 took {out['seconds']:.1f} s")
    row = serve[0]["row"]
    send = gossip[0]["send"]
    return [dict(
        name="flash_attention[tensor_core:tp]", route="cuda",
        source=FLASH_SOURCES["tensor_core"], replaces=FLASH_REPLACES,
        launches=serve[0]["launches"]["tensor_core"],
        launches_by_rank=[s["launches"]["tensor_core"] for s in serve],
        max_abs_err=row["max_abs_err"], ms=row["ms"],
        plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=row["library_ms"],
        shape=row["shape"], kv_heads=row["kv_heads"]), dict(
        name="quantize_send_affine8[tp]", route="cuda",
        source="src/repro_torch/kernels/csrc/quantize_send.cu",
        replaces="src/repro/kernels/gossip_cycle.py:422",
        launches=gossip[0]["launches"]["affine8"],
        launches_by_rank=[t["launches"]["affine8"] for t in gossip],
        max_abs_err=0.0, ms=send["ms"], plain_ms=send["plain_ms"],
        bound_ms=send["bound_ms"], bound_by=send["bound_by"],
        library_ms=None, send_route=send["routes"])]


# ---------------------------------------------------------------------------
# phase 15: everything under a mesh: serving and telemetry on the node
# mesh, the ssm, hybrid, audio and vlm families tensor parallel
# ---------------------------------------------------------------------------

SERVE_MESH_RANKS = 2
# (b): each family at its published widths on a (1, 2) mesh, the depth cut
# (printed): (arch, layers, encoder layers or None, batch, prompt, greedy
# steps, kernel #8's route or None, the kernels line's row or None, the
# compute dtype or None for the config's). whisper's prompt stays inside
# its 448 learned positions (past them the reference's ring cache drops
# keys its fused prefill saw). mamba2 runs twice: at 4 layers computing
# in float32 beside its float32 weights (in bf16 its random-init logits
# move 0.1998 between bf16 and f32 compute in one process, past
# LM_PATH_LOGIT_TOL, so a 4-layer bf16 comparison of two layouts measures
# rounding: 0.1454 over 2 ranks; f32: 2.8e-5), and at 1 layer in its
# config's bf16, which runs the SSD body's bf16 casts (0.0102 over 2
# ranks, the greedy tokens equal; measured on one H100)
TP_FAMILY_MESH = (1, 2)
TP_FAMILY_RUNS = (
    ("mamba2-780m", 4, None, 2, 1024, 8, None, None, "float32"),
    ("mamba2-780m", 1, None, 2, 1024, 8, None, None, None),
    ("recurrentgemma-9b", 3, None, 2, 1024, 8, "tensor_core", "hd256_tp",
     None),
    ("whisper-medium", 2, 2, 2, 256, 8, None, None, None),
    ("llama-3.2-vision-11b", 5, None, 2, 1024, 8, "tensor_core", "vlm_tp",
     None),
)
TP_FAMILY_SEED = 15
# (a): the int4_ef run's EF residual against the one-process run's: the
# ranks gather every node's square and take the one-device mean, so bit
# for bit is expected; the bar the run is held to
EF_MESH_RTOL = 1e-6


def tp_run_name(run) -> str:
    """A ``TP_FAMILY_RUNS`` entry's name: the arch and its depth cut."""
    return f"{run[0]}@{run[1]}"


def served_mesh_run(rank: int, cfg, X, y, n: int, cycles: int, threefry,
                    mesh, label: str) -> dict:
    """(a): one armed main-path run over the node mesh with phase 5's
    server (batches of 256, 2048 queries an eval point from its numpy
    stream) on this rank's shard: the run's numbers, every answer, the
    streams and this rank's span split; rank 0 checks and times #5 on
    its last served launch's inputs (its own queries of a batch, on its
    shard)."""
    import numpy as np
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.launch.gossip_serve import GossipServer
    tel = Telemetry(label=label)
    server = GossipServer(batch_size=256, telemetry=tel)
    hook, labels = feed_server(server, X[n:], y[n:], 2048)
    out = mesh_node_run(rank, cfg, X, y, n, cycles, threefry, mesh,
                        serve_hook=hook, telemetry=tel, final_state=False)
    server.flush()
    st = server.stats()
    out.update(answers=server.answers(), fresh=server.answers_fresh(),
               streams=dict(tel.streams), spans=span_split(tel),
               span_ranks=sorted({sp.args.get("rank") for sp in tel.spans},
                                 key=str),
               report=tel.phase_report(), queries=st.queries,
               batches=st.batches, queries_per_s=st.queries_per_sec,
               p50_s=st.p50_latency_s, p99_s=st.p99_latency_s,
               accuracy=float(np.mean(server.answers()
                                      == np.concatenate(labels))),
               shard=tuple(server.snapshot.shard[:5]),
               shard_rows=server.snapshot.w.shape[0])
    return out


def tp_family(rank: int, card: str, mesh, run) -> dict:
    """(b): one of ``TP_FAMILY_RUNS`` at full width: the one-process fused
    prefill and greedy steps first, then ``build_prefill_step(cache_len=)``
    and ``build_decode_step(profile="context")`` on the weights of the
    same seed placed by the rules; #8 counted on the sharded prefill and,
    on rank 0, timed on its last local q, k, v."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch import random
    from repro_torch.config import InputShape, get_config
    from repro_torch.launch import specs
    from repro_torch.models import transformer as T
    from repro_torch.models import vision as V
    from repro_torch.sharding import compat
    from repro_torch.sharding.rules import distribute_params
    arch, layers, enc_layers, batch, prompt, steps, route, _, compute = run
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(arch).replace(num_layers=layers)
    if compute is not None:
        cfg = cfg.replace(compute_dtype=getattr(torch, compute))
    if enc_layers is not None:
        cfg = cfg.replace(encoder=dataclasses.replace(
            cfg.encoder, num_layers=enc_layers))
    max_len = prompt + steps
    params = T.init_params(cfg, device=dev, seed=TP_FAMILY_SEED)
    set_gates(params)
    g = torch.Generator(device=dev)
    g.manual_seed(TP_FAMILY_SEED + 1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g,
                            device=dev, dtype=torch.int32)
    src = None
    if cfg.family == "vlm":
        src = V.dummy_patch_embeddings(random.key(0, dev), cfg, batch)
    elif cfg.family == "audio":
        src = V.dummy_frame_embeddings(random.key(0, dev), cfg, batch)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        (one, cache), one_prefill_s = _sync_wall(
            lambda: T.prefill(params, cfg, prompts, max_len,
                              encoder_out=src))
        one_logits = one.float().cpu()
        tok = torch.argmax(one, -1).to(torch.int32)
        one_toks = [tok.cpu()]
        t0 = time.perf_counter()
        for i in range(steps - 1):
            lg, cache = T.decode_step(params, cfg, tok, cache, prompt + i)
            tok = torch.argmax(lg, -1).to(torch.int32)
            one_toks.append(tok.cpu())
        torch.cuda.synchronize()
        one_decode_s = time.perf_counter() - t0
    one_peak = torch.cuda.max_memory_allocated()
    del cache, one
    pshape = InputShape("tp", prompt, batch, "prefill")
    dshape = InputShape("tp", max_len, batch, "decode")
    pfn, _, ppl = specs.build_prefill_step(cfg, pshape, mesh,
                                           cache_len=max_len,
                                           decode_profile="context")
    dfn, _, dpl = specs.build_decode_step(cfg, dshape, mesh,
                                          profile="context")
    dp = distribute_params(params, mesh, ppl[0])
    del params
    torch.cuda.empty_cache()
    inputs = {"tokens": prompts}
    if src is not None:
        inputs["encoder_out"] = src
    placed = distribute_params(inputs, mesh, ppl[1])
    torch.cuda.reset_peak_memory_stats()
    seen, undo = _record_flash()
    _reset_flash()
    compat.reset_stats()
    try:
        with torch.no_grad():
            (logits, cache), prefill_s = _sync_wall(lambda: pfn(dp, placed))
    finally:
        undo()
    launches = _flash_counts()
    prefill_stats = _stats()
    full = logits.full_tensor().float().cpu()
    tok = torch.argmax(full, -1).to(torch.int32).to(dev)
    toks = [tok.cpu()]
    compat.reset_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(steps - 1):
            dtok = distribute_params({"t": tok}, mesh, {"t": dpl[1]})["t"]
            lg, cache = dfn(dp, dtok, cache, prompt + i)
            tok = torch.argmax(lg.full_tensor(), -1).to(torch.int32)
            toks.append(tok.cpu())
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    decode_stats = _stats()
    peak = torch.cuda.max_memory_allocated()
    same = float(torch.mean((torch.stack(toks) == torch.stack(one_toks))
                            .float()))
    mixer = {"ssm": "ssm/w_in", "rglru": "rglru/w_x", "selfcross": "attn/wq",
             "attn": "attn/wq"}[cfg.layer_kinds()[0]]
    leaf = dp["blocks"][0]
    for part in mixer.split("/"):
        leaf = leaf[part]
    state = cache[0].get("ssm", cache[0].get("h", cache[0].get("k")))
    out = dict(
        arch=arch, layers=layers, enc_layers=enc_layers,
        compute=str(cfg.compute_dtype)[6:],
        kinds=list(cfg.layer_kinds()), batch=batch, prompt=prompt,
        steps=steps, params=cfg.param_count(),
        finite=bool(torch.isfinite(full).all()),
        err=float((full - one_logits).abs().max()),
        top=float(one_logits.abs().max()), same_tokens=same,
        prefill_s=prefill_s, decode_ms=decode_s * 1e3 / (steps - 1),
        one_prefill_s=one_prefill_s,
        one_decode_ms=one_decode_s * 1e3 / (steps - 1),
        launches=launches, prefill_stats=prefill_stats,
        decode_stats=decode_stats, peak_bytes=peak, one_peak_bytes=one_peak,
        mixer=mixer, mixer_pl=[str(p) for p in leaf.placements],
        mixer_split=leaf.placements[-1].is_shard(1),
        state_pl=[str(p) for p in state.placements],
        local_q=list(seen["q"].shape) if seen else None,
        local_k=list(seen["k"].shape) if seen else None)
    del dp, cache, placed, logits
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0 and seen:
        out["row"] = family_kernel_row(card, f"{arch}[tp]", seen, route,
                                       phase=15)
    seen.clear()
    dist.barrier()
    torch.cuda.empty_cache()
    return out


def phase15_rank(rank: int, world: int, card: str, cfg_fields: dict,
                 ef_fields: dict, n: int, cycles: int,
                 threefry: dict) -> dict:
    """Phase 15 in one rank: (a) phase 5's served, armed run
    (``cfg_fields``) and phase 4's int4_ef armed run (``ef_fields``) on a
    ``("nodes",)`` mesh; (b) each family of ``TP_FAMILY_RUNS`` on a
    ``TP_FAMILY_MESH`` (data, model) mesh."""
    import numpy as np
    import torch
    from repro_torch.configs.gossip_linear import GossipLinearConfig
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.data.synthetic import make_linear_dataset
    from repro_torch.launch.mesh import make_mesh
    t0 = time.perf_counter()
    nodes = make_mesh((world,), ("nodes",), "cuda")
    rng = np.random.default_rng(0)
    X, y = make_linear_dataset(rng, n + 1000, 10, noise=0.07,
                               separation=2.5)
    cfg = GossipLinearConfig(**cfg_fields)
    out = {"device": str(torch.device("cuda", torch.cuda.current_device())),
           "setup_s": time.perf_counter() - t0}
    out["served"] = served_mesh_run(rank, cfg, X, y, n, cycles, threefry,
                                    nodes, f"phase 15 rank {rank}")
    tel = Telemetry()
    ef = mesh_node_run(rank, GossipLinearConfig(**ef_fields), X, y, n,
                       cycles, threefry, nodes, telemetry=tel,
                       final_state=False)
    ef["streams"] = dict(tel.streams)
    out["ef"] = ef
    del X, y
    torch.cuda.empty_cache()
    out["a_s"] = time.perf_counter() - t0
    tp = make_mesh(TP_FAMILY_MESH, ("data", "model"), "cuda")
    out["families"] = {}
    for run in TP_FAMILY_RUNS:
        t1 = time.perf_counter()
        out["families"][tp_run_name(run)] = fam = tp_family(rank, card, tp,
                                                             run)
        fam["seconds"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def phase15(card: str, results: dict, cfg5, cfg3, X, y, n: int,
            cycles: int, want5: dict, threefry: dict) -> list:
    """Everything under a mesh: ``SERVE_MESH_RANKS`` processes share the
    card over gloo (``launch.mesh.run_ranks``). (a) Phase 5's served
    population on a ``("nodes",)`` mesh, armed: every voted and fresh
    answer, the curves, the economy, the fault counters and every stream
    bit for bit phase 5's one-process armed run, #1 and #5 on each rank's
    shard (the cache never gathered); then phase 4's int4_ef armed, its
    EF residual against a one-process armed run. (b) The ssm, hybrid,
    audio and vlm families at their published widths, tensor parallel on
    (1, 2), each rank against a one-process run of the same seed in its
    own process: prefill logits within ``LM_PATH_LOGIT_TOL``, #8 on the
    ranks' local heads. Returns the ``kernels`` line's rows."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core.simulation import run_simulation
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.launch.mesh import run_ranks
    t_start = time.perf_counter()
    out = results["phase15"] = {}
    cfg_ef = dataclasses.replace(cfg3, wire_dtype="int4_ef")
    tel = Telemetry()
    res = run_simulation(cfg_ef, X[:n], y[:n], X[n:], y[n:],
                         engine="sharded", cycles=cycles, eval_every=10,
                         seed=0, k_rounds=4, device="cuda", telemetry=tel)
    want_ef = dict(outcome=run_outcome(res),
                   rms=list(tel.streams["ef_residual_rms"]),
                   norm=res.ef_residual_norm, streams=dict(tel.streams))
    del res
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(phase15_rank, SERVE_MESH_RANKS, card,
                      dataclasses.asdict(cfg5), dataclasses.asdict(cfg_ef),
                      n, cycles, threefry,
                      device_type="cuda", timeout_s=600.0,
                      pg_timeout_s=300.0)
    spawn_s = time.perf_counter() - t0
    print(f"[15] {card}: {SERVE_MESH_RANKS} ranks on {ranks[0]['device']} "
          f"over gloo: {spawn_s:.1f} s from spawn to join, (a) "
          f"{max(r['a_s'] for r in ranks):.1f} s a rank")
    served = [r["served"] for r in ranks]
    nl = n // SERVE_MESH_RANKS
    for rank, s in enumerate(served):
        bad = [what for what, ok in (
            ("outcome", s["outcome"] == want5["outcome"]),
            ("answers", np.array_equal(s["answers"], want5["answers"])),
            ("fresh", np.array_equal(s["fresh"], want5["fresh"])),
            ("streams", s["streams"] == want5["streams"]),
            ("launches", s["launches"] == cycles
             and s["routes"]["grouped"] == cycles),
            ("voted", s["voted"][0] == want5["batches"] == s["batches"]),
            ("shard", s["shard"] == (rank * nl, (rank + 1) * nl, rank,
                                     SERVE_MESH_RANKS, n)
             and s["shard_rows"] == nl),
            ("spans", s["span_ranks"] == [rank])) if not ok]
        if bad:
            raise AssertionError(f"phase 15 (a): rank {rank}'s served run "
                                 f"differs from phase 5's armed run in "
                                 f"{bad}")
        sp = s["spans"]
        print(f"[15] {card}: (a) served N={n} over {SERVE_MESH_RANKS} ranks "
              f"(sign_flip 10 % + norm_clip, armed), rank {rank}: curves, "
              "economy, fault counters, every stream and all "
              f"{len(s['answers'])} voted and fresh answers bit for bit "
              f"phase 5's armed one-process run; #1 {s['launches']} "
              f"({s['routes']}), #5 {s['voted'][0]} ({s['voted'][1]}) on "
              f"its shard of {s['shard_rows']} rows; {s['queries']} queries "
              f"in {s['batches']} batches: {s['queries_per_s']:.0f} "
              f"queries/s, p50 {s['p50_s'] * 1e3:.4f} ms, p99 "
              f"{s['p99_s'] * 1e3:.4f} ms a batch (the combine included); "
              f"voted accuracy {s['accuracy']:.4f}; wall {s['wall_s']:.3f} "
              f"s; peak {s['peak_bytes'] / 2**30:.2f} GiB")
        print(f"[15] {card}: (a) rank {rank} span split: " + ", ".join(
            f"{k} {v['s']:.3f} s ({v['share'] * 100:.1f} %, x{v['count']})"
            for k, v in sp.items()))
        print(f"[15] {card}: (a) rank {rank} collectives: "
              f"{s['count']} ops, bytes {s['per_op']}, seconds "
              f"{ {k: round(v, 4) for k, v in s['seconds'].items()} }")
    efs = [r["ef"] for r in ranks]
    for rank, e in enumerate(efs):
        rms, norm = e["streams"]["ef_residual_rms"], e["ef_residual_norm"]
        gap = max(abs(a - b) / max(abs(b), 1e-30)
                  for a, b in zip(rms + [norm], want_ef["rms"]
                                  + [want_ef["norm"]]))
        same = rms == want_ef["rms"] and norm == want_ef["norm"]
        rest = {k: v for k, v in e["streams"].items()
                if k != "ef_residual_rms"}
        want_rest = {k: v for k, v in want_ef["streams"].items()
                     if k != "ef_residual_rms"}
        if (not gap <= EF_MESH_RTOL or rest != want_rest
                or e["outcome"][:-1] != want_ef["outcome"][:-1]
                or e["sends"]["packed_ef"] != cycles):
            raise AssertionError(f"phase 15 (a): rank {rank}'s int4_ef run: "
                                 f"EF gap {gap:.3e}, #3 {e['sends']}")
        print(f"[15] {card}: (a) int4_ef armed over {SERVE_MESH_RANKS} ranks,"
              f" rank {rank}: ef_residual_rms {rms} and ef_residual_norm "
              f"{norm} {'bit for bit' if same else f'within {gap:.3e} of'} "
              f"the one-process run's (bar {EF_MESH_RTOL}); the other "
              f"streams and the outcome equal; #3 {e['sends']}")
    s0, e0 = served[0], efs[0]
    rec, vt, ts = s0["receive"], s0["voted_timing"], e0["send"]
    print(f"[15] {card}: (a) fused_receive_apply norm_clip on rank 0's last "
          f"launch ({s0['receive_rows']} rows): {receive_line(rec)}")
    print(f"[15] {card}: (a) voted_predict_batched on rank 0's last served "
          f"launch (M={vt['queries']} of a batch of 256, on its shard of "
          f"{s0['shard_rows']} rows): {vt['ms']:.4f} ms/launch "
          f"({vt['route']}) in a CUDA graph vs bound {vt['bound_ms']:.6f} ms "
          f"({vt['bound_by']}, {vt['bound_bytes']} B); {vt['call_ms']:.4f} "
          f"ms per call; plain {vt['plain_ms']:.4f} ms; bitwise the plain "
          "version")
    print(f"[15] {card}: (a) quantize_send int4_ef on rank 0's shard "
          f"({ts['rows']} rows): {ts['ms']:.4f} ms/launch ({ts['route']}) "
          f"vs bound {ts['bound_ms']:.4f} ms ({ts['bound_by']}); plain "
          f"{ts['plain_ms']:.4f} ms; bitwise the plain version")
    fams = {}
    rows = []
    for run in TP_FAMILY_RUNS:
        arch, layers, enc_layers, batch, prompt, steps, route, row, _ = run
        per = [r["families"][tp_run_name(run)] for r in ranks]
        fams[tp_run_name(run)] = per
        for rank, f in enumerate(per):
            print(f"[15] {card}: (b) {arch} at {layers} of "
                  f"its layers ({'/'.join(f['kinds'])}"
                  + (f", {enc_layers} encoder layers" if enc_layers else "")
                  + f"; {f['params']} parameters, {f['compute']} compute), "
                  f"{batch} x {prompt} prompt,"
                  f" TP over {TP_FAMILY_MESH} (data, model), rank {rank}: "
                  f"prefill logits within {f['err']:.4f} of the one-process "
                  f"run (largest |logit| {f['top']:.3f}, tolerance "
                  f"{LM_PATH_LOGIT_TOL}); greedy tokens equal "
                  f"{f['same_tokens']:.4f} over {steps} steps; prefill "
                  f"{f['prefill_s'] * 1e3:.1f} ms (one process "
                  f"{f['one_prefill_s'] * 1e3:.1f} ms), decode "
                  f"{f['decode_ms']:.2f} ms/step (one process "
                  f"{f['one_decode_ms']:.2f}); #8 {f['launches']} on q "
                  f"{f['local_q']} k {f['local_k']}; {f['mixer']} "
                  f"{f['mixer_pl']}, layer 0's state {f['state_pl']}; peak "
                  f"{f['peak_bytes'] / 2**30:.2f} GiB (one process "
                  f"{f['one_peak_bytes'] / 2**30:.2f}); {f['seconds']:.1f} s")
            print(f"[15] {card}: (b) {arch} rank {rank} collectives: prefill "
                  f"{f['prefill_stats']}; decode {f['decode_stats']}")
            n_attn = sum(k in ("attn", "local") for k in f["kinds"])
            want = {"tensor_core": n_attn if route else 0, "cuda_core": 0}
            if f["launches"] != want or not f["finite"] \
                    or not f["err"] <= LM_PATH_LOGIT_TOL:
                raise AssertionError(f"phase 15 (b) {arch}: rank {rank} "
                                     f"launched #8 {f['launches']} "
                                     f"(expected {want}), logits off by "
                                     f"{f['err']}")
            if not f["mixer_split"]:
                raise AssertionError(f"phase 15 (b) {arch}: {f['mixer']} "
                                     f"placed {f['mixer_pl']}")
        if row is not None:
            r0 = per[0]["row"]
            rows.append(dict(
                name=f"flash_attention[tensor_core:{row}]", route="cuda",
                source=FLASH_SOURCES["tensor_core"], replaces=FLASH_REPLACES,
                launches=per[0]["launches"]["tensor_core"],
                launches_by_rank=[f["launches"]["tensor_core"] for f in per],
                max_abs_err=r0["max_abs_err"], ms=r0["ms"],
                plain_ms=r0["plain_ms"], bound_ms=r0["bound_ms"],
                bound_by=r0["bound_by"], library_ms=r0["library_ms"],
                shape=r0["shape"], kv_heads=r0["kv_heads"]))
    out.update(
        spawn_s=spawn_s, rank_seconds=[r["seconds"] for r in ranks],
        served=[{k: v for k, v in s.items() if k not in (
            "answers", "fresh", "report")} for s in served],
        ef=[{k: v for k, v in e.items()} for e in efs], want_ef=want_ef,
        families=fams)
    out["seconds"] = time.perf_counter() - t_start
    print(f"[15] {card}: phase 15 took {out['seconds']:.1f} s")
    rows[:0] = [dict(
        name="fused_receive_apply[mesh:norm_clip]", route="cuda",
        source="src/repro_torch/kernels/csrc/gossip_cycle.cu",
        replaces="src/repro/kernels/gossip_cycle.py:272",
        launches=s0["launches"],
        launches_by_rank=[s["launches"] for s in served],
        max_abs_err=rec["err"], ms=rec["ms"], plain_ms=rec["plain_ms"],
        bound_ms=rec["bound_ms"], bound_by=rec["bound_by"], library_ms=None,
        receive_route=rec["route"]), dict(
        name="quantize_send_packed_ef[mesh]", route="cuda",
        source="src/repro_torch/kernels/csrc/quantize_send.cu",
        replaces=SEND_ROWS["packed_ef"], launches=e0["sends"]["packed_ef"],
        launches_by_rank=[e["sends"]["packed_ef"] for e in efs],
        max_abs_err=0.0, ms=ts["ms"], plain_ms=ts["plain_ms"],
        bound_ms=ts["bound_ms"], bound_by=ts["bound_by"], library_ms=None,
        send_route=ts["route"]), dict(
        name="voted_predict_batched[mesh]", route="cuda",
        source="src/repro_torch/kernels/csrc/voted_predict.cu",
        replaces="src/repro/kernels/voted_predict.py:73",
        launches=s0["voted"][0],
        launches_by_rank=[s["voted"][0] for s in served], max_abs_err=0.0,
        ms=vt["ms"], plain_ms=vt["plain_ms"], bound_ms=vt["bound_ms"],
        bound_by=vt["bound_by"], library_ms=None, voted_route=vt["route"])]
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every measured number to this JSON file")
    opts = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses

    import numpy as np

    from repro_torch import random
    from repro_torch.configs.gossip_linear import (GossipLinearConfig,
                                                   with_failure_scenario)
    from repro_torch.core import faults
    from repro_torch.core import sharded_engine as se
    from repro_torch.core.simulation import run_simulation
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.data.synthetic import make_linear_dataset
    from repro_torch.kernels import _build
    from repro_torch.kernels import gossip_cycle as gc

    dev = torch.device("cuda")
    card = smi()
    results = {"card": card, "phase_start_s": {}}
    start = time.perf_counter()

    def phase(n: int):
        results["phase_start_s"][n] = time.perf_counter() - start
        print(f"[{n}] starts {results['phase_start_s'][n]:.1f} s into the "
              "run")

    # ---- 0. setup ------------------------------------------------------
    nvcc_ver = subprocess.run([_build.nvcc(), "--version"],
                              capture_output=True, text=True, timeout=60,
                              check=True).stdout.strip().splitlines()[-1]
    print(f"[0] card: {card}")
    print(f"[0] torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"python {sys.version.split()[0]}, {nvcc_ver}")
    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    print(f"[0] kernel build: {build_s:.2f} s "
          f"({', '.join(_build.SOURCES)})")
    grouped = []     # (registers, spill bytes) of each grouped receive
    for name, log in logs.items():
        entry = ""
        for line in log.splitlines():
            if "Compiling entry" in line:     # which kernel the next lines are
                entry = line.split(chr(39))[1]
                print(f"[0]   {name}: {entry[:100]}")
                if "fused_receive_grouped" in entry:
                    grouped.append([0, 0])
            if ("registers" in line or "spill" in line or "wgmma" in line
                    or "warn" in line.lower()):
                print(f"[0]   {name}: {line.strip()}")
            if "fused_receive_grouped" not in entry:
                continue
            if "spill" in line:
                grouped[-1][1] += sum(int(w) for w in re.findall(
                    r"(\d+) bytes spill", line))
            used = re.search(r"Used (\d+) registers", line)
            if used:
                grouped[-1][0] = int(used.group(1))
    if "gossip_cycle" in logs:
        if not grouped or any(sp for _, sp in grouped):
            raise AssertionError(f"the grouped receive kernel spills (or "
                                 f"was not compiled): {grouped}")
        regs = [r for r, _ in grouped]
        print(f"[0]   gossip_cycle: {len(grouped)} grouped receive "
              f"instantiations, {min(regs)}-{max(regs)} registers, no "
              "spills")
        results["grouped_registers"] = [min(regs), max(regs)]
    from repro_torch.kernels import flash_attention as fa
    if "flash_attention_hopper" in logs:
        hopper = hopper_registers(logs["flash_attention_hopper"])
        if (sorted(hopper) != sorted(fa.TENSOR_CORE_HEAD_DIMS)
                or any(sp for _, sp in hopper.values())):
            raise AssertionError(f"the tensor-core flash kernel spills (or "
                                 f"was not compiled at every head_dim): "
                                 f"(registers, spill bytes) by hd {hopper}")
        regs = ", ".join(f"hd {hd}: {r} registers"
                         for hd, (r, _) in sorted(hopper.items()))
        print(f"[0]   flash_attention_hopper: {regs} at entry (hd 256's "
              "consumer warpgroups raise theirs to 240 with setmaxnreg), no "
              "spills")
        results["flash_hopper_registers"] = hopper
    smem = {hd: fa.tensor_core_smem_bytes(hd)
            for hd in fa.TENSOR_CORE_HEAD_DIMS}
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    if max(smem.values()) > optin:
        raise AssertionError(f"the tensor-core flash kernel asks for {smem} "
                             f"B of shared memory, over the card's {optin}")
    print(f"[0]   flash_attention_hopper: dynamic shared memory a block "
          f"{', '.join(f'hd {hd}: {b} B' for hd, b in smem.items())} of the "
          f"card's {optin} B (registers and spills above)")
    core_smem = {hd: fa.cuda_core_smem_bytes(hd) for hd in FLASH_HEAD_DIMS}
    if max(core_smem.values()) > optin:
        raise AssertionError(f"the CUDA-core flash kernel asks for "
                             f"{core_smem} B of shared memory, over the "
                             f"card's {optin}")
    sizes = ", ".join(f"hd {hd}: {b} B" for hd, b in core_smem.items())
    print(f"[0]   flash_attention (CUDA cores): dynamic shared memory a "
          f"block {sizes} of the card's {optin} B, opted in above 48 KB")
    results["build_s"] = build_s
    results["flash_hopper_smem"] = smem
    results["flash_cuda_core_smem"] = core_smem
    threefry = threefry_sass(_build.library_path("quantize_send"))
    print(f"[0]   quantize_send: int8_sr's threefry noise costs "
          f"{threefry['int32']:g} INT32-pipe and {threefry['imad']:g} IMAD "
          f"instructions an element ({threefry['other']:g} others) in the "
          f"tiled kernel's SASS; difference by opcode over four elements "
          f"{threefry['by_opcode']}")
    if not 40 <= threefry["int32"] + threefry["imad"] <= 400:
        raise AssertionError(f"threefry's SASS count {threefry} is not that "
                             "of one pass of the code loop")
    results["threefry_sass"] = threefry

    # ---- 1. kernel vs plain ------------------------------------------------
    phase(1)
    max_err = 0.0
    route_cases = dict.fromkeys(gc.RECEIVE_ROUTES, 0)

    def routes_agree(inputs, variant, wire=None, defense="none"):
        """At d <= 32, the route taken bitwise equal to the strided one."""
        d_, k_ = inputs["x"].shape[1], inputs["msg_w"].shape[0]
        if d_ > gc.GROUPED_MAX_WIDTH:
            return gc.receive_route(d_, k_)
        route = compare_routes(inputs, variant, 1e-3, wire, defense)
        route_cases[route] += 1
        return (f"{route}, bitwise equal to strided" if route == "grouped"
                else route)

    for si, (n, d, c, k, atol) in enumerate(RECEIVE_SHAPES):
        for mode, wire in (("f32", None), *DECODE_WIRES.items()):
            inputs = receive_inputs(si, n, d, c, k, dev, wire=wire)
            for variant in ("rw", "mu", "um"):
                err, _ = compare_kernel(inputs, variant, 1e-3, atol,
                                        wire=wire)
                max_err = max(max_err, err)
                took = routes_agree(inputs, variant, wire)
                print(f"[1] fused_receive_apply {mode} N={n} d={d} C={c} "
                      f"K={k} {variant}: ints equal, max abs err {err:.3e} "
                      f"(atol {atol:g}, rtol 1e-5); route {took}")
            del inputs
        torch.cuda.empty_cache()
    # the defense screens, on inputs with crafted rows for every verdict
    for si, (n, d, c, k, atol) in enumerate(RECEIVE_SHAPES):
        for defense in DEFENSE_MODES:
            for mode, wire in (("f32", None), *SCREEN_WIRES.items()):
                inputs = receive_inputs(si, n, d, c, k, dev, wire=wire,
                                        crafted=True)
                for variant in ("rw", "mu", "um"):
                    err, (g, cl) = compare_kernel(inputs, variant, 1e-3,
                                                  atol, wire=wire,
                                                  defense=defense)
                    if g == 0 or (defense == "norm_clip") != (cl > 0):
                        raise AssertionError(
                            f"{defense} {mode}: crafted rows gave gated {g} "
                            f"clipped {cl}")
                    max_err = max(max_err, err)
                    took = routes_agree(inputs, variant, wire, defense)
                    print(f"[1] fused_receive_apply {defense} {mode} N={n} "
                          f"d={d} C={c} K={k} {variant}: ints and counts "
                          f"equal (gated {g}, clipped {cl}), max abs err "
                          f"{err:.3e}; route {took}")
                del inputs
        torch.cuda.empty_cache()
    # the screen's sum orders past d = 32 (strided route) and where the
    # reference sums some nodes unfused (d = 6, 8; both routes), lastModel
    # bit for bit in compare_kernel
    for si, (n, d) in enumerate(SCREEN_ORDER_SHAPES):
        inputs = receive_inputs(100 + si, n, d, 10, 4, dev, crafted=True)
        for defense in DEFENSE_MODES:
            err, (g, cl) = compare_kernel(inputs, "mu", 1e-3, 1e-5,
                                          defense=defense)
            max_err = max(max_err, err)
            known = ("and lastModel bitwise equal"
                     if faults.screen_order_known(d) else
                     "equal (the sum order is not known at this d)")
            took = gc.receive_route(d, 4)
            if took == "grouped":
                compare_routes(inputs, "mu", 1e-3, None, defense)
                took += ", bitwise equal to strided"
            split = (f"; unfused split {gc.screen_splits(n, d, defense)}"
                     if d in faults.UNFUSED_WIDTHS else "")
            print(f"[1] fused_receive_apply {defense} f32 N={n} d={d} C=10 "
                  f"K=4 mu: ints and counts (gated {g}, clipped {cl}) "
                  f"{known}, max abs err {err:.3e}; route {took}{split}")
        del inputs
    print(f"[1] fused_receive_apply: {route_cases['grouped']} cases at "
          "d <= 32 on the grouped route, each bitwise equal to the strided "
          f"route on the same inputs; {route_cases['strided']} at K > "
          f"{gc.GROUPED_MAX_ROUNDS} on the strided route")
    results["receive_route_cases"] = route_cases
    # the bf16/f16 decode modes, which no main-path phase runs: time and
    # bound at the main path's size
    results["decode_modes"] = {}
    for mode in ("bf16", "f16"):
        inputs = receive_inputs(0, 1_000_000, 10, 10, 4, dev, wire=mode)
        inputs["wire"] = mode
        t_ = time_receive(inputs, "mu", 1e-3, 10)
        print(f"[1] {card}: fused_receive_apply {mode} decode at N=10^6 "
              f"d=10 C=10 K=4 mu: {receive_line(t_)}")
        results["decode_modes"][mode] = t_
        del inputs
    # the cosine_gate screen (f32), which no main-path phase runs, on the
    # same inputs
    inputs = receive_inputs(0, 1_000_000, 10, 10, 4, dev)
    inputs["defense"] = "cosine_gate"
    cg = time_receive(inputs, "mu", 1e-3, 10)
    print(f"[1] {card}: fused_receive_apply cosine_gate (f32) at N=10^6 "
          f"d=10 C=10 K=4 mu: {receive_line(cg)}")
    results["decode_modes"]["cosine_gate"] = cg
    del inputs
    # the paper's other datasets' shapes (f32, mu), on the strided route
    results["paper_shapes"] = {}
    for name, n, d, atol in PAPER_SHAPES:
        inputs = receive_inputs(1, n, d, 10, 4, dev)
        t_ = time_receive(inputs, "mu", 1e-3, d, atol)
        print(f"[1] {card}: fused_receive_apply f32 at {name}'s N={n} d={d} "
              f"C=10 K=4 mu: {receive_line(t_)}")
        results["paper_shapes"][name] = t_
        del inputs
    torch.cuda.empty_cache()
    # the voted-predict kernel: bitwise, at the serving shapes
    for m, c, d in VOTED_SHAPES:
        w, count, Xq, aq = voted_inputs(m + d, m, c, d, dev)
        ans = compare_voted(w, count, Xq, aq)
        if ans[:4].tolist() != [1.0, 1.0, 1.0, -1.0]:
            raise AssertionError(f"voted_predict_batched: zero-score, tie "
                                 f"and below-tie answers {ans[:4].tolist()}")
        print(f"[1] voted_predict_batched M={m} C={c} d={d}: answers on "
              f"{' and '.join(voted_routes(d, c))} bitwise equal to the "
              "plain version (snapshot and gathered forms; zero scores and "
              "exact-half ties answer +1)")
    del w, count, Xq, aq
    key = random.key(12345, device=dev)
    for n, d in SEND_SHAPES:
        w, ef = send_inputs(n + d, n, d, dev)
        for name in SEND_CODECS:
            outs, route = compare_send(name, w, ef, key)
            print(f"[1] quantize_send {name} ({gc.send_kernel_name(name)}) "
                  f"N={n} d={d}: {', '.join(outs)} bitwise equal to the "
                  f"plain version; route {route}"
                  + (", bitwise equal to strided" if route == "tiled"
                     else ""))
    del w, ef
    results["send_width_sweep"] = send_width_sweep(card, threefry, dev)
    # int8_sr past 2^32 flat positions (the counter's high word): the
    # kernel over all rows, the plain codec on the first and last rows with
    # their positional noise
    from repro_torch.core.wire_codec import quantize_wire
    n, d = 432_000, 9947
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    w = torch.randn((n, d), generator=g, device=dev)
    q, sc, zp = gc.quantize_send(w, "int8_sr", key=key)
    rows = torch.cat([torch.arange(64), torch.arange(n - 64, n)]).to(dev)
    want = quantize_wire(w[rows], "int8_sr", noise=random.sr_noise_for_rows(
        key, rows, d, n))
    for label, a_, b_ in zip(("q", "scale", "zp"), (q[rows], sc[rows],
                                                    zp[rows]), want):
        if not torch.equal(a_.view(torch.uint8), b_.view(torch.uint8)):
            raise AssertionError(f"int8_sr past 2^32: {label} differs")
    print(f"[1] quantize_send int8_sr N={n} d={d} ({n * d} positions, past "
          "2^32): q, scale, zp of the first and last 64 rows bitwise equal "
          "to the plain codec with sr_noise_for_rows")
    del w, q, sc, zp
    torch.cuda.empty_cache()
    row_kernels = phase1_rows(card, results)
    flash_err = phase1_flash(dev)

    # ---- 2. path vs oracle -------------------------------------------------
    phase(2)
    n2 = 20_000
    rng = np.random.default_rng(0)
    X, y = make_linear_dataset(rng, n2 + 1000, 10, noise=0.07,
                               separation=2.5)
    cfg2 = with_failure_scenario(GossipLinearConfig(
        name="smoke-20k", dim=10, n_nodes=n2, n_test=1000,
        class_ratio=(1, 1), lam=1e-3, variant="mu", cache_size=10),
        "extreme")
    sh, curve_diff, _ = compare_engines(cfg2, X, y, n2, dev, cycles=20,
                                     eval_every=10, seed=0, k_rounds=4)
    print(f"[2] N={n2} extreme 20 cycles: economy equal (sent "
          f"{sh.sent_total}, delivered {sh.delivered_total}, lost "
          f"{sh.lost_total}, overflow {sh.overflow_total}, in flight "
          f"{sh.in_flight_total}); max curve difference {curve_diff:.3e}; "
          f"err_fresh {sh.err_fresh} err_voted {sh.err_voted}")
    results["phase2"] = dict(curve_diff=curve_diff, sent=sh.sent_total,
                             err_fresh=sh.err_fresh, err_voted=sh.err_voted)
    for wire in MAIN_WIRES:
        cfgw = dataclasses.replace(cfg2, wire_dtype=wire)
        shw, dw, _ = compare_engines(cfgw, X, y, n2, dev, cycles=20,
                                  eval_every=10, seed=0, k_rounds=4)
        print(f"[2] {wire} N={n2} extreme 20 cycles: economy equal (sent "
              f"{shw.sent_total}, delivered {shw.delivered_total}); wire "
              f"bytes {shw.wire_bytes_total} equal; max curve difference "
              f"{dw:.3e}; ef_residual_norm {shw.ef_residual_norm:.6g}; "
              f"err_fresh {shw.err_fresh}")
        results["phase2"][wire] = dict(
            curve_diff=dw, sent=shw.sent_total, err_fresh=shw.err_fresh,
            ef_residual_norm=shw.ef_residual_norm)
    online = np.random.default_rng(1).random((10, n2)) < 0.9
    tables = []
    for d_ in (dev, torch.device("cpu")):
        keys = se.key_schedule(0, 10, d_)
        dst, arr = se._draw_chunk(keys, torch.as_tensor(online, device=d_),
                                  0, n=n2, drop=0.5, delay_max=10,
                                  sampler="uniform")
        tables.append((keys.cpu(), dst.cpu(), arr.cpu()))
    if not all(torch.equal(a, b) for a, b in zip(*tables)):
        raise AssertionError("draw tables differ between CUDA and CPU")
    perm = [random.permutation(random.key(3, device=d_), 1001).cpu()
            for d_ in (dev, torch.device("cpu"))]
    if not torch.equal(*perm):
        raise AssertionError("permutation differs between CUDA and CPU")
    print("[2] first chunk's key schedule and draw tables (and a "
          "permutation) bitwise equal on CUDA and CPU")
    normals = [random.normal(random.key(5, device=d_), (200, 1000))
               .cpu().view(torch.int32) for d_ in (dev, torch.device("cpu"))]
    off = int((normals[0] != normals[1]).sum())
    if off:
        raise AssertionError(f"random.normal: {off} of 200000 float32 "
                             "draws differ between CUDA and CPU")
    print("[2] 200000 float32 random.normal draws (XLA's log1p, log and "
          "erf_inv) bitwise equal on CUDA and CPU")
    results["phase2"]["normal_draws_equal"] = normals[0].numel()
    # Byzantine faults and the defense screens, then serving hooks
    results["phase2"]["faults"] = {}
    cosine_launches = 0     # the sharded engine's, under cosine_gate
    cosine_routes = dict.fromkeys(gc.RECEIVE_ROUTES, 0)
    for fault, wire, defense in FAULT_RUNS:
        cfgf = dataclasses.replace(cfg2, wire_dtype=wire, fault_model=fault,
                                   byzantine_frac=0.1, defense=defense)
        tag = f"{fault}/{wire or 'f32'}/{defense}"
        before = gc.fused_receive_apply.launches
        routes = dict(gc.fused_receive_apply.route_launches)
        shf, df, reff = compare_engines(cfgf, X, y, n2, dev, cycles=20,
                                        eval_every=10, seed=0, k_rounds=4)
        if defense == "cosine_gate":
            cosine_launches += gc.fused_receive_apply.launches - before
            for r, n_ in gc.fused_receive_apply.route_launches.items():
                cosine_routes[r] += n_ - routes[r]
        fs = shf.fault_stats
        if fs["corrupted"] == 0 or fs["gated"] + fs["clipped"] == 0:
            raise AssertionError(f"{tag}: no fault reached the screen {fs}")
        print(f"[2] {tag} N={n2} extreme 20 cycles: economy and fault "
              f"counters equal ({fs}); max curve difference {df:.3e}; "
              f"err_fresh {shf.err_fresh} err_voted {shf.err_voted}")
        results["phase2"]["faults"][tag] = dict(
            curve_diff=df, fault_stats=fs, sent=shf.sent_total,
            err_fresh=shf.err_fresh, err_voted=shf.err_voted)
        if fault == "sign_flip" and defense == "norm_clip":
            for engine, unhooked in (("sharded", shf), ("reference", reff)):
                q = hooked_equals_unhooked(cfgf, X, y, n2, dev, engine,
                                           unhooked, cycles=20,
                                           eval_every=10, seed=0,
                                           k_rounds=4)
                print(f"[2] {tag} {engine} engine with a serving hook "
                      f"({q} queries): curves, economy and fault counters "
                      "bit for bit those of the run without it")
    if cosine_routes != dict(grouped=cosine_launches, strided=0):
        raise AssertionError(f"phase 2's cosine_gate receive launches by "
                             f"route {cosine_routes}, expected all grouped")
    print(f"[2] cosine_gate runs: {cosine_launches} receive launches, by "
          f"route {cosine_routes}")
    torch.cuda.empty_cache()

    # ---- 3. full size ------------------------------------------------------
    phase(3)
    n3, cycles = 1_000_000, 20
    rng = np.random.default_rng(0)
    X, y = make_linear_dataset(rng, n3 + 1000, 10, noise=0.07,
                               separation=2.5)
    cfg3 = with_failure_scenario(GossipLinearConfig(
        name=f"million-{n3}", dim=10, n_nodes=n3, n_test=1000,
        class_ratio=(1, 1), lam=1e-3, variant="mu", cache_size=10),
        "extreme")

    res, wall, peak, launches, _, captured, _, _, routes, _, _ = main_path(
        cfg3, X, y, n3, cycles, dev)
    rate = n3 * cycles / wall
    print(f"[3] {card}: N={n3} d=10 extreme MU K=4 C=10 {cycles} cycles: "
          f"launches {launches} (by route {routes}); cycles {res.cycles} "
          f"err_fresh {res.err_fresh} err_voted {res.err_voted} similarity "
          f"{res.similarity}")
    print(f"[3] {card}: economy sent {res.sent_total} = delivered "
          f"{res.delivered_total} + lost {res.lost_total} + overflow "
          f"{res.overflow_total} + in flight {res.in_flight_total}")
    print(f"[3] {card}: wall {wall:.3f} s, {rate:.0f} node-cycles/s, "
          f"peak device memory {peak / 2**30:.2f} GiB")

    # the kernel on the main path's own last-launch inputs
    t3 = time_receive(captured, cfg3.variant, cfg3.lam, 10)
    max_err = max(max_err, t3["err"])
    print(f"[3] {card}: fused_receive_apply at N={n3} d=10 C=10 K=4 mu: "
          f"{receive_line(t3)}")
    results["phase3"] = dict(
        n=n3, cycles=cycles, wall_s=wall, node_cycles_per_s=rate,
        peak_bytes=peak, launches=launches, err_fresh=res.err_fresh,
        err_voted=res.err_voted, sent=res.sent_total,
        delivered=res.delivered_total, lost=res.lost_total,
        overflow=res.overflow_total, in_flight=res.in_flight_total,
        wire_bytes_total=res.wire_bytes_total,
        buf_payload_bytes=res.buf_payload_bytes,
        kernel_ms=t3["ms"], plain_ms=t3["plain_ms"], bound_ms=t3["bound_ms"],
        bound_bytes=t3["bytes"], route_launches=routes,
        strided_ms=t3["strided_ms"])
    f32_res = res
    outcomes = {None: run_outcome(res)}     # phase 13's one-process runs
    del captured

    # where the time goes: the same run again under the profiler
    results["profile"] = profile_run(
        lambda: run_simulation(cfg3, X[:n3], y[:n3], X[n3:], y[n3:],
                               engine="sharded", cycles=cycles,
                               eval_every=10, seed=0, k_rounds=4,
                               device="cuda"), "3", card)

    # the same run armed with telemetry, then unarmed once more: bit for
    # bit the unarmed run, its streams adding up, and where the host's
    # time goes. Each makes its churn trace anew, as the first run did.
    from repro_torch.core import simulation
    tel3 = Telemetry(label=f"chip_smoke phase 3 N={n3}")
    simulation._host_scenario.cache_clear()
    (res_a, wall_a, _, launches_a, _, _, _, _, routes_a, _,
     _) = main_path(cfg3, X, y, n3, cycles, dev, telemetry=tel3)
    simulation._host_scenario.cache_clear()
    res_u, wall_u = main_path(cfg3, X, y, n3, cycles, dev)[:2]
    if (launches_a, routes_a) != (launches, routes):
        raise AssertionError(f"phase 3: the armed run launched {launches_a} "
                             f"(by route {routes_a}), the unarmed "
                             f"{launches} ({routes})")
    check_armed(tel3, res_a, f32_res, cycles, "phase 3")
    if run_outcome(res_u) != run_outcome(f32_res):
        raise AssertionError("phase 3: the unarmed rerun differs")
    split3 = span_split(tel3)
    spanned = tel3.wall_seconds()
    print(f"[3] {card}: armed with telemetry: wall {wall_a:.3f} s against "
          f"the unarmed run's {wall:.3f} s (ratio {wall_a / wall:.4f}) and "
          f"an unarmed rerun's {wall_u:.3f} s (ratio {wall_a / wall_u:.4f});"
          f" launches {launches_a} (by route {routes_a}); curves, economy, "
          "fault counters, wire bytes and EF norm bit for bit the unarmed "
          "run's; the streams add up")
    for line in tel3.phase_report().splitlines():
        print(f"[3] {card}: {line}")
    for name, row in split3.items():
        print(f"[3] {card}:   span {name:<16} {row['s']:.6f} s "
              f"{row['share']:7.2%} of the spanned {spanned:.6f} s, "
              f"x{row['count']}, compiles {row['compiles']}")
    print(f"[3] {card}: spans cover {sum(r['s'] for r in split3.values()):.6f}"
          f" s of the armed run's {wall_a:.3f} s wall")
    # next to --out; without it, in a directory removed once it is read
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        trace3 = tel3.export_chrome_trace(
            (Path(opts.out).resolve().parent if opts.out else Path(tmp))
            / "phase3_trace.json")
        report = trace_report(trace3)
        size = trace3.stat().st_size
    print(f"[3] {card}: Chrome trace {trace3} ({size} B"
          f"{'' if opts.out else ', removed: no --out'}); "
          "tools/trace_report.py reads it:")
    for line in report.splitlines()[:4]:
        print(f"[3] {card}:   {line}")
    results["phase3"].update(
        armed_wall_s=wall_a, unarmed_rerun_wall_s=wall_u,
        armed_ratio=wall_a / wall, armed_ratio_rerun=wall_a / wall_u,
        spanned_s=spanned, spans=split3, trace=str(trace3))
    del res_a, res_u

    kernels = [dict(
        name="fused_receive_apply", route="cuda",
        source="src/repro_torch/kernels/csrc/gossip_cycle.cu",
        replaces="src/repro/kernels/gossip_cycle.py:272",
        launches=launches, max_abs_err=max_err, ms=t3["ms"],
        plain_ms=t3["plain_ms"], bound_ms=t3["bound_ms"],
        bound_by=t3["bound_by"], library_ms=None,
        receive_route=t3["route"])]

    # ---- 4. the quantized wire at full size --------------------------------
    phase(4)
    results["phase4"] = {}
    send_rows = {}
    for wire in MAIN_WIRES:
        cfg4 = dataclasses.replace(cfg3, wire_dtype=wire)
        kernel = gc.send_kernel_name(wire)
        (res, wall, peak, launches, sends, cap_r, cap_s, _, routes,
         send_routes, _) = main_path(cfg4, X, y, n3, cycles, dev)
        if sends[kernel] != cycles or sum(sends.values()) != cycles:
            raise AssertionError(f"{wire}: main path launched the send "
                                 f"kernels {sends}, expected {cycles} "
                                 f"{kernel}")
        if send_routes != dict(tiled=cycles, strided=0):
            raise AssertionError(f"{wire}: main path's send launches by "
                                 f"route {send_routes}, expected all "
                                 f"{cycles} tiled")
        rate = n3 * cycles / wall
        outcomes[wire] = run_outcome(res)
        print(f"[4] {card}: {wire} N={n3} d=10 extreme MU K=4 C=10 "
              f"{cycles} cycles: launches receive {launches} (by route "
              f"{routes}), send "
              f"{kernel} {sends[kernel]} (by route {send_routes}); "
              f"err_fresh {res.err_fresh} "
              f"err_voted {res.err_voted}; ef_residual_norm "
              f"{res.ef_residual_norm:.6g}")
        print(f"[4] {card}: {wire} economy sent {res.sent_total} = "
              f"delivered {res.delivered_total} + lost {res.lost_total} + "
              f"overflow {res.overflow_total} + in flight "
              f"{res.in_flight_total}")
        print(f"[4] {card}: {wire} wire bytes {res.wire_bytes_total} "
              f"({res.wire_bytes_total / f32_res.wire_bytes_total:.4f} of "
              f"f32's {f32_res.wire_bytes_total}), buffer "
              f"{res.buf_payload_bytes} B "
              f"({res.buf_payload_bytes / f32_res.buf_payload_bytes:.4f} of "
              f"f32's {f32_res.buf_payload_bytes})")
        print(f"[4] {card}: {wire} wall {wall:.3f} s, {rate:.0f} "
              f"node-cycles/s, peak device memory {peak / 2**30:.2f} GiB")
        t4 = time_receive(cap_r, cfg4.variant, cfg4.lam, 10)
        max_err = max(max_err, t4["err"])
        kernels[0]["launches"] += launches
        kernels[0]["max_abs_err"] = max_err
        print(f"[4] {card}: fused_receive_apply {wire} decode: "
              f"{receive_line(t4)}")
        ts = time_send(cap_s, threefry)
        strided = (f"; the strided route {ts['strided_ms']:.4f} ms on the "
                   "same inputs, bitwise equal" if ts["route"] != "strided"
                   else "")
        print(f"[4] {card}: quantize_send {wire} ({kernel}): "
              f"{ts['ms']:.4f} ms/launch ({ts['route']}) vs bound "
              f"{ts['bound_ms']:.4f} ms ({ts['bound_by']}, {ts['bytes']} B)"
              f"{strided}; plain version {ts['plain_ms']:.4f} ms; bitwise "
              "equal to plain")
        send_rows[kernel] = dict(launches=sends[kernel], ms=ts["ms"],
                                 plain_ms=ts["plain_ms"],
                                 bound_ms=ts["bound_ms"],
                                 bound_by=ts["bound_by"],
                                 send_route=ts["route"])
        del cap_r, cap_s
        prof = profile_run(
            lambda: run_simulation(cfg4, X[:n3], y[:n3], X[n3:], y[n3:],
                                   engine="sharded", cycles=cycles,
                                   eval_every=10, seed=0, k_rounds=4,
                                   device="cuda"), "4", card)
        results["phase4"][wire] = dict(
            wall_s=wall, node_cycles_per_s=rate, peak_bytes=peak,
            launches=launches, send_launches=sends, err_fresh=res.err_fresh,
            err_voted=res.err_voted, sent=res.sent_total,
            delivered=res.delivered_total, lost=res.lost_total,
            overflow=res.overflow_total, in_flight=res.in_flight_total,
            wire_bytes_total=res.wire_bytes_total,
            buf_payload_bytes=res.buf_payload_bytes,
            ef_residual_norm=res.ef_residual_norm,
            receive=dict(ms=t4["ms"], plain_ms=t4["plain_ms"],
                         bound_ms=t4["bound_ms"], bound_bytes=t4["bytes"],
                         max_abs_err=t4["err"], route=t4["route"],
                         strided_ms=t4["strided_ms"]),
            route_launches=routes, send_route_launches=send_routes,
            send=dict(ms=ts["ms"], plain_ms=ts["plain_ms"],
                      bound_ms=ts["bound_ms"], bound_bytes=ts["bytes"],
                      route=ts["route"], strided_ms=ts["strided_ms"]),
            profile=prof)
        torch.cuda.empty_cache()

    # ---- 5. faults, a defense and live serving at full size -------------
    phase(5)
    from repro_torch.core import serving
    from repro_torch.launch.gossip_serve import GossipServer
    cfg5 = dataclasses.replace(cfg3, fault_model="sign_flip",
                               byzantine_frac=0.1, defense="norm_clip")
    server = GossipServer(batch_size=256)
    hook, labels = feed_server(server, X[n3:], y[n3:], 2048)
    take = serving.snapshot_from_carry
    clone_s = []

    def timed_snapshot(carry, shard=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = take(carry, shard)
        torch.cuda.synchronize()
        clone_s.append(time.perf_counter() - t0)
        return snap

    serving.snapshot_from_carry = timed_snapshot
    try:
        (res, wall, peak, launches, _, cap_r, _, voted, routes, _,
         voted_by_route) = main_path(cfg5, X, y, n3, cycles, dev,
                                     serve_hook=hook)
    finally:
        serving.snapshot_from_carry = take
    server.flush()
    st = server.stats()
    acc = float(np.mean(server.answers() == np.concatenate(labels)))
    fs = res.fault_stats
    if fs["corrupted"] == 0 or fs["clipped"] == 0:
        raise AssertionError(f"phase 5: fault counters {fs}")
    if voted != st.batches or voted == 0:
        raise AssertionError(f"phase 5: the server answered {st.batches} "
                             f"batches with {voted} voted-predict launches")
    want_voted = dict.fromkeys(voted_by_route, 0)
    want_voted[voted_routes(X.shape[1], cfg5.cache_size)[0]] = voted
    if voted_by_route != want_voted:
        raise AssertionError(f"phase 5: voted-predict launches by route "
                             f"{voted_by_route}, expected {want_voted}")
    if not 0.5 < acc <= 1.0:
        raise AssertionError(f"phase 5: served accuracy {acc}")
    rate = n3 * cycles / wall
    print(f"[5] {card}: N={n3} d=10 extreme MU K=4 C=10 {cycles} cycles, "
          f"sign_flip 10% + norm_clip, served: launches receive {launches} "
          f"(by route {routes}), "
          f"voted_predict {voted} (by route {voted_by_route}); err_fresh "
          f"{res.err_fresh} err_voted "
          f"{res.err_voted}; fault counters {fs}")
    print(f"[5] {card}: economy sent {res.sent_total} = delivered "
          f"{res.delivered_total} + lost {res.lost_total} + overflow "
          f"{res.overflow_total} + in flight {res.in_flight_total}")
    print(f"[5] {card}: wall {wall:.3f} s, {rate:.0f} node-cycles/s, peak "
          f"device memory {peak / 2**30:.2f} GiB; snapshot copies "
          f"{[round(t * 1e3, 3) for t in clone_s]} ms")
    print(f"[5] {card}: served {st.queries} queries in {st.batches} batches "
          f"of 256: {st.queries_per_sec:.0f} queries/s over the batch "
          f"latencies, p50 {st.p50_latency_s * 1e3:.4f} ms, p99 "
          f"{st.p99_latency_s * 1e3:.4f} ms; voted accuracy {acc:.4f}")
    t5 = time_receive(cap_r, cfg5.variant, cfg5.lam, 10)
    max_err = max(max_err, t5["err"])
    print(f"[5] {card}: fused_receive_apply norm_clip at N={n3}: "
          f"{receive_line(t5)}")
    del cap_r
    voted_rows = {}
    for m in VOTED_BATCHES:
        v = voted_rows[m] = time_voted(server.snapshot, X[n3:], m, seed=m)
        print(f"[5] {card}: voted_predict_batched M={m} on the N={n3} "
              f"snapshot: {v['ms']:.4f} ms/launch ({v['route']}) in a CUDA "
              f"graph vs bound {v['bound_ms']:.6f} ms ({v['bound_by']}, "
              f"{v['bound_bytes']} B), strided {v['strided_ms']:.4f} ms on "
              f"the same inputs, grouped at forced threads a query "
              f"{ {n: round(t, 5) for n, t in v['grouped_lanes_ms'].items()} }"
              f", {v['call_ms']:.4f} ms per call; plain "
              f"version {v['plain_ms']:.4f} ms in a graph; both routes "
              "bitwise equal to plain")
    prof5 = profile_run(
        lambda: run_simulation(
            cfg5, X[:n3], y[:n3], X[n3:], y[n3:], engine="sharded",
            cycles=cycles, eval_every=10, seed=0, k_rounds=4, device="cuda",
            serve_hook=feed_server(GossipServer(batch_size=256), X[n3:],
                                   y[n3:], 2048)[0]), "5", card)

    # the protocol and the server armed on one Telemetry: bit for bit the
    # unarmed run and its answers, the server's histogram shared
    tel5 = Telemetry(label=f"chip_smoke phase 5 N={n3}")
    server_a = GossipServer(batch_size=256, telemetry=tel5)
    hook_a, _ = feed_server(server_a, X[n3:], y[n3:], 2048)
    (res_a, wall_a, _, launches_a, _, _, _, voted_a, routes_a, _,
     voted_by_route_a) = main_path(cfg5, X, y, n3, cycles, dev,
                                   serve_hook=hook_a, telemetry=tel5)
    server_a.flush()
    st_a = server_a.stats()
    if (launches_a, routes_a, voted_a, voted_by_route_a) != (
            launches, routes, voted, voted_by_route):
        raise AssertionError(f"phase 5: the armed run launched "
                             f"{launches_a} ({routes_a}) and {voted_a} "
                             f"({voted_by_route_a}), the unarmed {launches} "
                             f"({routes}) and {voted} ({voted_by_route})")
    check_armed(tel5, res_a, res, cycles, "phase 5")
    # phase 15 holds the served population over ranks to this run
    want5 = dict(outcome=run_outcome(res_a), answers=server_a.answers(),
                 fresh=server_a.answers_fresh(), streams=dict(tel5.streams),
                 batches=st_a.batches)
    if not (np.array_equal(server_a.answers(), server.answers())
            and np.array_equal(server_a.answers_fresh(),
                               server.answers_fresh())):
        raise AssertionError("phase 5: the armed server's answers differ")
    if (tel5.histograms.get("serve_batch_latency") is not server_a.hist
            or not server_a.hist.count == st_a.batches == st.batches):
        raise AssertionError("phase 5: the server's histogram is not "
                             "shared into the telemetry")
    split5 = span_split(tel5)
    if (split5["snapshot_adopt"]["count"] != len(res.cycles)
            or split5["serve_batch"]["count"] != st.batches):
        raise AssertionError(f"phase 5: serving spans {split5}")
    print(f"[5] {card}: armed protocol and server: wall {wall_a:.3f} s "
          f"(unarmed {wall:.3f} s, ratio {wall_a / wall:.4f}); curves, "
          "economy, fault counters and served answers bit for bit the "
          f"unarmed run's; serve_batch_latency shared (n={st_a.batches}, "
          f"p50 {st_a.p50_latency_s * 1e3:.4f} ms); snapshot_adopt "
          f"{split5['snapshot_adopt']['s']:.6f} s x"
          f"{split5['snapshot_adopt']['count']}, serve_batch "
          f"{split5['serve_batch']['s']:.6f} s x"
          f"{split5['serve_batch']['count']}, snapshot "
          f"{split5['snapshot']['s']:.6f} s x{split5['snapshot']['count']}")
    del res_a, server_a, hook_a
    results["phase5"] = dict(
        wall_s=wall, node_cycles_per_s=rate, peak_bytes=peak,
        launches=launches, voted_launches=voted,
        voted_route_launches=voted_by_route, fault_stats=fs,
        err_fresh=res.err_fresh, err_voted=res.err_voted,
        sent=res.sent_total, delivered=res.delivered_total,
        lost=res.lost_total, overflow=res.overflow_total,
        in_flight=res.in_flight_total, snapshot_copy_s=clone_s,
        queries=st.queries, batches=st.batches,
        queries_per_s=st.queries_per_sec, p50_s=st.p50_latency_s,
        p99_s=st.p99_latency_s, voted_accuracy=acc,
        receive=dict(ms=t5["ms"], plain_ms=t5["plain_ms"],
                     bound_ms=t5["bound_ms"], bound_bytes=t5["bytes"],
                     max_abs_err=t5["err"], route=t5["route"],
                     strided_ms=t5["strided_ms"]),
        route_launches=routes,
        voted=voted_rows, profile=prof5, armed_wall_s=wall_a, spans=split5)
    del server
    torch.cuda.empty_cache()
    kernels[0]["max_abs_err"] = max_err
    kernels.append(dict(
        name="fused_receive_apply[norm_clip]", route="cuda",
        source="src/repro_torch/kernels/csrc/gossip_cycle.cu",
        replaces="src/repro/kernels/gossip_cycle.py:272",
        launches=launches, max_abs_err=t5["err"], ms=t5["ms"],
        plain_ms=t5["plain_ms"], bound_ms=t5["bound_ms"],
        bound_by=t5["bound_by"], library_ms=None,
        receive_route=t5["route"]))

    for kernel, replaces in SEND_ROWS.items():
        kernels.append(dict(
            name=f"quantize_send[{kernel}]", route="cuda",
            source="src/repro_torch/kernels/csrc/quantize_send.cu",
            replaces=replaces, max_abs_err=0.0, library_ms=None,
            **send_rows[kernel]))
    kernels.append(dict(
        name="fused_receive_apply[cosine_gate]", route="cuda",
        source="src/repro_torch/kernels/csrc/gossip_cycle.cu",
        replaces="src/repro/kernels/gossip_cycle.py:272",
        launches=cosine_launches, max_abs_err=cg["err"], ms=cg["ms"],
        plain_ms=cg["plain_ms"], bound_ms=cg["bound_ms"],
        bound_by=cg["bound_by"], library_ms=None,
        receive_route=cg["route"]))
    v256 = voted_rows[256]
    kernels.append(dict(
        name="voted_predict_batched", route="cuda",
        source="src/repro_torch/kernels/csrc/voted_predict.cu",
        replaces="src/repro/kernels/voted_predict.py:73", launches=voted,
        max_abs_err=0.0, ms=v256["ms"], plain_ms=v256["plain_ms"],
        bound_ms=v256["bound_ms"], bound_by=v256["bound_by"],
        library_ms=None, voted_route=v256["route"],
        strided_ms=v256["strided_ms"], m1_ms=voted_rows[1]["ms"]))
    for name, replaces in ROW_KERNELS.items():
        kernels.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/pegasos_merge.cu",
            replaces=replaces, library_ms=None, **row_kernels[name]))

    # ---- 6. LM serving at full width ---------------------------------------
    phase(6)
    for route, row in phase6(card, results, flash_err).items():
        kernels.append(dict(
            name=f"flash_attention[{route}]", route="cuda",
            source=FLASH_SOURCES[route], replaces=FLASH_REPLACES, **row))
    torch.cuda.empty_cache()

    # ---- 7. the compact packings and the vector apply ---------------------
    phase(7)
    kernels.extend(phase7(card, results, threefry, dev))

    # ---- 8. the paper's experiments --------------------------------------
    phase(8)
    kernels.extend(phase8(card, results, dev))
    torch.cuda.empty_cache()

    # ---- 9. gossip-SGD training ---------------------------------------------
    phase(9)
    kernels.extend(phase9(card, results, dev))
    torch.cuda.empty_cache()

    # ---- 10. the moe, ssm and hybrid families ---------------------------
    phase(10)
    kernels.extend(phase10(card, results, dev))
    torch.cuda.empty_cache()

    # ---- 11. the audio and vlm families ---------------------------------
    phase(11)
    kernels.extend(phase11(card, results, dev))
    torch.cuda.empty_cache()

    # ---- 12. llama3-405b served; the new families trained ---------------
    phase(12)
    kernels.extend(phase12(card, results, dev))
    torch.cuda.empty_cache()

    # ---- 13. the protocol across ranks ------------------------------------
    phase(13)
    kernels.extend(phase13(card, results, dev, cfg3, X, y, n3, cycles,
                           outcomes, threefry))
    torch.cuda.empty_cache()

    # ---- 14. the LM across ranks -------------------------------------------
    phase(14)
    kernels.extend(phase14(card, results))
    torch.cuda.empty_cache()

    # ---- 15. everything under a mesh ---------------------------------------
    phase(15)
    kernels.extend(phase15(card, results, cfg5, cfg3, X, y, n3, cycles,
                           want5, threefry))
    results["kernels"] = kernels
    results["total_s"] = time.perf_counter() - start
    print(f"[15] {card}: the whole run took {results['total_s']:.1f} s")
    if opts.out:
        out = Path(opts.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(results, indent=1))
    print(json.dumps({"kernels": kernels, "phase3_spans": {
        name: row["s"] for name, row in split3.items()}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

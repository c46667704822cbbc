#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit; each prints a
JSON line):
  1. the card (name and power limit from nvidia-smi), torch and CUDA
     versions; TF32 is switched off for matmuls and convolutions (a belt:
     the port pins its convolutions and products to float32 itself);
  2. build every kernel from ``src/repro_torch/kernels/csrc`` with nvcc,
     one process per source, all started together; ptxas must report no
     spill in any kernel;
  3. every kernel against its plain PyTorch version on the card:
     the decision kernel at the main path's shapes and at ragged /
     read-noise / shared-selection shapes (rtol 1e-5, atol 1e-5, as
     tests/test_decision_kernel.py), the tiled variant (N > 32) also at
     N = 4,097 and 50,280 and held to rtol 1e-4 with the LM's absolute
     floors (LM_RTOL, lm_decision_atol); the CIM kernel at the three trunk
     shapes an admission of 32 slots gives on the gate die and at two
     ragged shapes, ideal and with the die's ADC front end (rtol 1e-4,
     atol 1e-4, as tests/test_kernels.py; an output off by more is an
     ADC code flipped by the order of the 64-term sum, counted and held
     to one LSB and to at most 1e-4 of the outputs); run-to-run bit
     identity for both, zero-variation CIM = ideal CIM bit for bit; the
     decision kernel's shared_sel_r64 case relaunched 300 times, each
     launch bit for bit the first and within tolerance of the plain
     version (itself repeated and held to its first bits);
  4. the ideal-die main path: ``serve_sar`` on the card, 192 fog-mixed
     requests in 32 slots under TriagePolicy(0.7, 0.05, r_min=4,
     r_max=20), random full-width params from a seed; the kernel launch
     counts are zeroed just before and read just after.  The same stream
     through ``fused=False`` (no kernel) must give the same decisions,
     and so must an escalating policy (0.55, 0.05) and a CPU run of 64
     requests;
  5. the chip-instance main path: the same 192 requests served on the
     gate die ``sample_instances(11, 1, VariationSpec().scaled(2.0))``,
     calibrated: the conv trunk through the CIM kernel (3 launches per
     admission), the head deployed and calibrated on the card, on the
     die's degraded GRNG (the decision kernel's read-noise branch, one
     launch per round); counts zeroed just before and read just after.
     ``fused=False`` must give the same decisions, the uncalibrated die
     must serve every request, and CPU runs of 64 requests (the head
     deployed on the CPU) must decide as the card does, under the main
     policy and under the escalating one (whose decisions differ in kind
     and depth); confidence and MI agree to 1e-5 unless the trunk
     flipped an ADC code between card and CPU on the batches the card
     admitted (counted), then to 1e-3.  A line before them gives the
     deployed heads' difference: the measured constants (and their
     distance in float32 steps), the arrays, and the 8-bit µ' / 4-bit σ
     codes that differ when the deployment quantizes;
  5b. fixed-R serving on the gate die at r_max = 100, above one decision
     launch's 64 samples: 64 requests, every round cut into two decision
     launches (counts zeroed just before, read just after), the same
     decisions as a CPU run (confidence/MI as in 5);
  6. the head kernels against their plain versions on the card: the
     GRNG ε kernel bit for bit (``torch.equal``) at Fig. 9's block
     (256×256, R=8; ideal and the gate die), kernel_bench's 512×2048,
     R=20, an aged die with offsets, offsets up to and past the 2^32
     wrap, R = 1 and 130, and selection rows other than 0/1; the rank16
     and paper head kernels at the SAR head's shape
     (B=64, K=64, N=2, R=20) and at kernel_bench's (B=8, K=512, N=2048),
     ideal, with read noise and (paper) with the 6-bit ADC (rtol/atol
     1e-4; an ADC code flipped by the K order is counted and held to one
     LSB); run-to-run bit identity; wrapper refusals;
  7. the SAR UQ path (Fig. 16's batches and R, untrained params, on the
     float trunk; the trained detector's Fig. 16 rows, this work on the
     ``cim_execution`` trunk, are 7d): ``logit_samples_serve`` at
     R=20 in rank16 and in paper mode over 16 batches of 64 SARD images
     (``batch_at(SardConfig(image_size=32, seed=7), 10000+i, 64)``),
     clean and fog severity 1.0, then ``uq_report``; again on the gate
     die (the trunk through the CIM kernel, the head deployed by
     ``prepare_instance_head`` on the card, read noise on); launch
     counts zeroed before and read after (one head launch per batch per
     mode, three CIM launches per die batch); card against CPU on 2
     batches, each deploying its own head (equal predictions,
     confidence within 1e-5, or 1e-3 where the trunk flipped an ADC
     code, counted; the deployed heads' difference on a line before);
     the Fig. 9 path (``ops.grng_eps`` at
     256×256×8, one ε launch; ``calibrate``; ``distribution_sample``'s
     mean and SD);
  7b. training (``mission.detector.trained_detector``, into a temporary
     directory; nothing is written in the repository): N_SHORT steps on
     the card and on the CPU from one seed (per-step ce within
     TRAIN_CE_ATOL, params within TRAIN_PARAM_ATOL, ε launches equal to
     the steps); PROFILE_STEPS steps under ``torch.profiler`` (wall per
     step, device idle share); no host sync a step (counted by
     ``torch.cuda.set_sync_debug_mode``); the reference's default run
     (1600 steps, batch 64, snow, severity ≤ 0.5) timed, its ce/acc,
     1600 ε launches, and its cache restored bit for bit;
  7c. the trained detector served (``serve_sar(params=trained)``) on the
     ideal die and the gate die under (0.7, 0.05) and (0.55, 0.05):
     samples per decision (mean and histogram), flag fraction,
     decisions/s; card and CPU decide alike request for request; under
     (0.7, 0.05) some requests are ACCEPTed and some go past r_min;
  7d. Fig. 16's three rows for the trained detector, 16 clean and 16
     snow batches (severity 1.0), R = 20: CNN (the µ head, R = 1),
     BNN-ideal (``logit_samples_ideal``), this work (the
     ``cim_execution`` trunk with the rank16 and the paper head, one
     head launch per batch and mode): accuracy, AURC, AECE, AMCE;
  7e. the closed-loop mission (``mission.fly_mission``) on the trained
     detector: at the reference's test size (6×6, 3 victims, 2 drones,
     120 µJ, 18 steps) in bayes_adaptive mode on the ideal die and on
     the seed-11 severity-2.5 die, on the card and on the CPU, the same
     logs lane for lane (confidence within 1e-5, or 1e-3 where the two
     trunks differ by an ADC code, counted), one host sync, the launch
     counts of the path, and the same episode with its step loop under
     ``torch.cuda.set_sync_debug_mode("error")`` (line
     ``mission_card_vs_cpu``); at mission_bench's default scale (14×14,
     10 victims, 4 drones, 2 episodes, 70 steps, 320 µJ) the three modes
     on both dies: mission metrics, energy split, host syncs, wall time,
     decision and CIM launches (zeroed before, read after, asserted:
     steps × rounds a step; on the die 3 × (trunk sweeps + the
     calibration's one)) (lines ``mission_matrix``), the bench's
     comparison, reported (``mission_comparison``), the always-run
     orbit's cost (``mission_orbit_cost``) and a profiled mission on
     each die (``mission_profile``);
  7f. observability (lines ``observability``): at the serving shape of
     phase 4, on the ideal die and the gate die, ``serve_sar`` with the
     tracer, stage profiler and SLO tracker on, off, off, on (verdicts,
     samples, host syncs and launches identical); time to verdict, queue
     wait and service (p50/p95/p99: the SLO histograms' and, for time to
     verdict, the raw records'), the stage profile's median and mean a
     stage, closed loop; time to verdict open loop at half the closed
     loop's decisions/s (poisson); the engine's cost records against the
     launch counts (asserted) with the allocator's peak; the serve CLI on
     the gate die with --slo/--trace/--metrics-out/--profile (the
     profiler trace holds every decision and CIM launch under its CUDA
     symbol; the .prom parses, the JSON loads); the mission CLI with
     --trace/--metrics-out/--profile at 6x6, 3 victims, 2 drones, 8
     steps on the seed-11 severity-2.5 die, its step loop under
     ``set_sync_debug_mode("error")``; each number beside the card's
     name and power limit;
  7g. a die population and the head's other modes (lines
     ``die_population``, ``granularity``, ``moment``, ``tiled_hoist``):
     hw_variation's 16 dies (seed 2026, severity 2.5) saved and loaded
     equal, ``calibration_report`` on the card against the CPU
     (measured constants within CALIB_STEPS float32 steps, residuals
     within CALIB_RESID_ATOL, the calibrated residual under a fifth of
     the uncalibrated on every die), two loaded dies serving 96
     fog-mixed requests (CIM trunk, decision kernel; launches zeroed
     before, read after) with their originals' verdicts, the SAR
     layers cut onto tiles and put back bit for bit, the tile map's
     report and 2-shard column partition; Fig. 9's block at 'tile' and
     'cell' on both dies (selections equal, ε within GRAN_EPS_ATOL,
     card against CPU; ε moments beside 'layer''s), the reachable
     selection patterns, paper-mode samples at tile/cell at the UQ
     head's shape (no head kernel launched; 'layer' launches it once);
     kernel_bench's head in moment mode (moments card vs CPU, 2,048
     draws against them); mamba2-130m's head (K=768, N=50,280) hoisted
     in host chunks of 4,096 columns, ``update_stats_streamed`` against
     the dense on-device ``update_stats(mix_samples)`` (1e-5), ideal and
     gate die, times and allocator peaks; each line beside the card's
     name and power limit;
  7h. the dense LM (lines ``lm_serving``, ``kernel_check``
     ``lm_vocab_*`` and ``lm_decode_step``, ``lm_tick_split``,
     ``lm_card_vs_cpu``): qwen3-0.6b at full width (N = 152,064, bf16,
     random params from seed 0 drawn on the card) through
     ``serve(smoke=False, batch=4, prompt_len=16, gen_len=4,
     n_requests=8)`` (every LM phase's serves at 4 new tokens, to
     hold the script's time limit) under accept-always, fixed R = 20 and an
     escalating policy (its confidence threshold at the accept-always
     run's median), the decision kernel's launches zeroed before each
     run and asserted = ticks × launches a schedule after, one host
     sync a tick; the decision kernel against its plain version on one
     live token decision's operands at R = 1, 4, 8, 20, 64 and with
     read_sigma = 0.4 (rtol 1e-4, absolute floors 1e-4 × R/N, R/N², R), two
     launches bit for bit; rank16 on one decode_step (1e-4, one
     launch); a tick's basis / decision / decode ms; the SMOKE config
     on the card against the CPU (f32, TF32 off: accept-always and
     fixed R decide alike request for request, one escalating token
     decision's fin within 1e-5 and its _se within 1e-4; bf16: token
     agreement and the hidden gap within 0.05);
  7i. the MoE LMs (lines ``lm_moe``, ``kernel_check`` ``moe_*``,
     ``lm_tick_split``, ``timing`` ``*_moe_*``, ``lm_moe_card_vs_cpu``,
     ``lm_moe_phase_s``): mixtral-8x7b (8 of its 32 layers) and
     qwen3-moe-235b-a22b (2 of 94) at full width, float32 params drawn on
     the card from seed 0 and freed before the next model; mixtral
     through 7h's serve() under accept-always, fixed R = 20 and the
     escalating policy (its sliding window makes every decode the
     rolling cache's), qwen3-moe with 4 requests under accept-always;
     decision launches = ticks × launches a schedule and one sync a tick
     (asserted), at least one admission into a decoding pool (mixtral,
     asserted); decision.cu on a live token decision's operands at
     N = 32,000 and 152,064, R = 4, 8, 20 and R = 20 with read noise
     (7h's tolerance), rank16 on one decode_step (1e-4; K 4,096), both
     timed by graph replay beside their bounds (the kernels line's
     ``lm_moe_vocab`` and ``lm_moe_decode_step``); a tick's split; each
     SMOKE config on the card against the CPU (f32 decisions equal,
     asserted; bf16 agreement, routings that differ and the hidden gap,
     reported);
  7j. the SSM and hybrid LMs (lines ``lm_ssm``, ``kernel_check``
     ``ssm_*``, ``ssm_chunk_carry``, ``lm_tick_split``, ``timing``
     ``*_ssm_*``, ``lm_ssm_card_vs_cpu``, ``lm_ssm_phase_s``):
     mamba2-130m (24 of 24 layers) and zamba2-2.7b (27 of 54; 54 of 54
     before the mesh phase joined the script) at full width, float32 params drawn on the card from seed 0 and freed before
     the next model, through 7h's serve() with prompts of 512 (two SSD
     chunks, so the state carried between chunks runs) under
     accept-always, fixed R = 20 and the escalating policy: decision
     launches = ticks × launches a schedule and one sync a tick, at least
     one admission into a decoding pool (asserted); decision.cu on a live
     token decision's operands at N = 50,432 and 32,000, R = 4, 8, 20 and
     R = 20 with read noise (7h's tolerance), rank16 on one
     decode_step_ssm (1e-4; K 768 and 2,560), both timed by graph replay
     beside their bounds (the kernels line's ``lm_ssm_vocab`` and
     ``lm_ssm_decode_step``); ``ssd_chunked`` at each arch's layer shape
     over 512 tokens against two 256-token calls with the state carried
     and card against CPU (SSM_CARRY_TOL); a tick's split; each SMOKE
     config on the card against the CPU (f32 decisions equal, bf16 hidden
     gap within 0.05, asserted; bf16 requests agreeing, reported);
  7k. the audio and VLM LMs (lines ``lm_xattn``, ``kernel_check``
     ``xattn_*``, ``lm_tick_split``, ``xattn_consistency``, ``timing``
     ``*_xattn_*``, ``lm_xattn_card_vs_cpu``, ``lm_xattn_phase_s``):
     whisper-medium (24 encoder + 24 decoder layers, 1,500 stub frames)
     and llama-3.2-vision-11b (20 of 40 self + 4 of 8 cross layers, full
     depth before the mesh phase joined the script; 1,601 stub image
     tokens) at full width, float32 params drawn on the
     card from seed 0 and freed before the next model, through 7h's
     serve(): whisper 8 requests under accept-always, fixed R = 20 and
     the escalating policy, none admitted into a decoding pool and at
     least two admissions a serve (asserted: its learned positions wait
     for the drain); llama-vision 8 under accept-always (an admission
     into a decoding pool asserted) and 4 under each of the others;
     decision launches = ticks × launches a schedule and one sync a tick
     (asserted); decision.cu on a live token decision's operands at
     N = 51,968 and 128,256, R = 4, 8, 20 and R = 20 with read noise
     (7h's tolerance), rank16 on one decode_step (1e-4; K 1,024 and
     4,096), both timed by graph replay beside their bounds (the kernels
     line's ``lm_xattn_vocab`` and ``lm_xattn_decode_step``); a tick's
     split and the summary's tile walk; prefill over 17 tokens against
     prefill over 16 and one decode_hidden in float32 at a full-width
     layer shape (whisper whole, llama-vision one group of 5 + 1;
     XATTN_CONSISTENCY_REL, with whisper's decode position term as the
     reference's, ROADMAP C28); each SMOKE config on the card against
     the CPU (f32 decisions equal, bf16 hidden gap within 0.05,
     asserted; bf16 requests agreeing, reported);
  7l. the LM trainer (lines ``lm_train``, ``kernel_check`` ``grng_eps``
     ``lm_train_*``, ``lm_train_card_vs_cpu``, ``lm_train_resume``,
     ``lm_train_phase_s``): ``launch.train.train(smoke=False)`` on the
     card for qwen3-0.6b (28 layers, vocabulary 152,064 padded; 30 steps
     of 8 × 64) and mamba2-130m (24 layers, vocabulary 50,432; 10 steps
     of 8 × 512, two SSD chunks), params drawn on the card from seed 0:
     ε launches = steps, every loss finite, the mean ce of the last 5
     steps below the first step's, one host sync a step (counted by
     ``set_sync_debug_mode`` over two run lengths) (asserted); ms a step,
     allocator peak, and a few more steps under ``torch.profiler``
     (device idle share, ε ms a launch); the head's ε at full width
     bit-equal to the plain version on its first, middle and last
     column blocks, timed by graph replay beside its bound; qwen3-0.6b
     SMOKE through ``make_train_step`` on the card against the CPU, 5
     steps from the same params (f32: loss within 1e-4 a step, params
     within 1e-3, asserted; bf16 reported); ``train`` at SMOKE failing
     at step 3 and resumed, bit for bit an uninterrupted run, and
     ``compress=True`` leaving a nonzero error state;
  7m. the fleet and slot sharding (lines ``kernel_check sharded_*``,
     ``sharded_pool``, ``fleet``, ``fleet_open_loop``, ``fleet_mixed``,
     ``mission_sharded``, ``fleet_phase_s``); one card holds every shard
     and pool (cuda:0 repeated), so these show bit-identity, launch
     counts and host syncs a tick, not scaling across cards:
     ``decision_stats_sharded`` over 2 and 4 shards at SAR's shape (B 32,
     N 2, R 4 and 20, with and without read noise, half the slots
     masked) and over 2 at B 4, N 152,064, R 20: one run on cuda:0 and
     one launch a call (asserted), each bit-equal to the unsharded
     launch and within TOL (N ≤ 32) or 7h's relative tolerance of its
     plain version, its accumulating form bit for bit stats + delta,
     timed by graph replay beside the unsharded launch; the slot-sharded
     pool (192 requests, 2 shards) on the ideal and the gate die,
     records equal to the unsharded pool's bit for bit, one decision
     launch a round (counts zeroed before, read after), and over
     cuda:0 and the CPU (two runs, each run's state on its device):
     verdicts equal the unsharded card pool's, confidence and MI within
     TOL's atol, one launch a round; ``serve_sar_fleet`` (4 pools
     of 32 slots, 256 requests, 25 % fog) gang against sequential on
     both dies: verdicts and routes equal, gang syncs = ticks < the
     sequential's, energy = the records' sum (asserted), decisions/s and
     syncs a decision reported; an open-loop run at half the gang's
     rate (poisson) with the SLO fleet block (a queue peak a pool) and
     one stitched trace (a flow from the router to a slot track for
     every request); a 2-pool gang fleet on cuda:0 and the CPU (the
     packed results gathered on the card, one pull), each pool equal to
     a standalone engine on its device; ``fly_mission`` at
     mission_bench's default scale on both dies over 2 shards against
     1, logs equal lane for lane, sharded calls = launches = steps ×
     rounds;
  7n. the (data, model) mesh (lines ``mesh_place``, ``mesh_moe``,
     ``mesh_prefill``, ``mesh_decode``, ``kernel_check bayes_rank16
     mesh_*``, ``mesh_microbatch``, ``mesh_elastic``, ``mesh_train``,
     ``kernel_check grng_eps mesh_train_*``, ``mesh_phase_s``); every
     mesh coordinate on cuda:0, so these show placement, the sharded
     paths' arithmetic and the kernels' launches, not scaling across
     cards: mixtral-8x7b (full width, 4 of 32 layers) and qwen3-0.6b
     placed on (2, 2) with no allocator growth and ``validate_specs``
     empty; mixtral's MoE layer at 4 × 64 tokens through
     ``make_sharded_moe`` on (2, 2) and (1, 4) (EP) in float32 and bf16
     against ``moe_apply`` (capacity factor 8: no drop, float32 within
     2e-5; factor 1: the pairs dropped a shard, reported), timed;
     ``mesh_prefill_step`` (mixtral, capacity factor 8) and
     ``mesh_prefill_step`` + 2 ``mesh_decode_step``s (qwen3-0.6b) on
     (2, 2) in float32 against the unsharded steps (samples within 1e-5
     of the largest), one rank16 launch a step, each launch held to its
     plain version on its own operands; microbatches 4 against 1 on
     (2, 2) (loss within 5e-2); 3 steps on (2, 2), two coordinates lost,
     ``remesh_train_state`` and 2 more steps (params bit-equal, count
     kept, losses within 1e-3 of an unbroken run on the shrunken mesh);
     5 training steps of qwen3-0.6b at 8 × 64 on (1, 1) and on (2, 2)
     with explicit TP off and on (losses within 1e-3 of (1, 1), one ε
     launch a step, asserted; ms a step, allocator peak) and the ε
     kernel on the mesh step's own draw against its plain version;
  8. kernel timing: device time from CUDA graph replays and per-call
     time of eager calls (CUDA events), beside the plain version's and
     the card's byte/flop bound: decision and CIM at the serving path's
     shapes, ε at Fig. 9's block (ideal and the gate die) and at
     kernel_bench's 512×2048, R=20 and at the training draw's 64×2,
     R=1, the head kernels at kernel_bench's
     shape for R = 4, 16, 20, 64 (paper with the ADC at R = 20) and at
     the UQ path's shape (B=64, K=64, N=2, R=20; the head entries'
     ``path``); decision at the LM's B=4, N=152,064, R = 4 and 20
     (``lm_vocab``; asserted faster than its plain version) and rank16
     at decode_step's B=4, K=1,024, N=152,064, R=8
     (``lm_decode_step``); decision at the read-noise ``rows`` case
     (B 32, N 2, R 4, rows from 1,000), ``decision_stats_sharded``'s
     per-device body, beside its bound (``sharded_body_rows``); the
     tile width the decision kernel's plan
     takes on the LM's R = 20 operands (its only one), held to the plain
     version at LM_RTOL, timed, with its three kernels' device times
     (line ``decision_plans``).  The entries
     name their design and the launch plan each shape took.  Every plan
     the CIM kernel takes, timed at the trunk's shapes for 32 slots and
     for a UQ batch of 64 images, each giving
     the chosen plan's bits (line ``cim_plans``); every plan the head
     kernels take, timed at the UQ path's shape and at kernel_bench's
     (R=20: rank16, paper and paper with the ADC; paper also at R=64),
     each giving the chosen plan's bits (line ``head_plans``).  The
     decision and CIM entries count their launches on the serving paths
     and the mission matrix (``launches_by_path``).  The launch floor: a
     kernel that does no work, by the same replay (line
     ``launch_floor_ms``).  The previous design's times at the same
     shapes, constants from PERF.md and not timed here, stand on a line
     of their own (``previous_design``).  The ε entry counts its launches
     on the training paths (one a step: the SAR detector's
     and, under ``lm_train_vocab``, the LM trainer's at full width);
     ``decision_stats_sharded``'s entry: the whole sharded call in its
     accumulating form at the gate die's round (2 shards) with its delta
     form, its plain version, the unsharded launch, its bound and its
     launches on the sharded pool and the sharded mission;
  9. the script's wall and each group of phases' (line
     ``script_wall_s``);
  10. last line: {"ok": true, "device": {...}}.
It imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = dict(rtol=1e-5, atol=1e-5)
CIM_TOL = dict(rtol=1e-4, atol=1e-4)
STAT_KEYS = ("sum_p", "sum_psq", "sum_ent", "sum_entsq")
POLICY = dict(conf_threshold=0.7, mi_threshold=0.05, r_min=4, r_max=20)
STREAM = dict(n_slots=32, corrupt_frac=0.25, corruption="fog", seed=0)
# Card vs CPU on a chip instance: the trunk's 64-term sums and ADC full
# scale are reduced in another order on each, and where a partial sum
# sits on a half-code tie one 6-bit code flips by an LSB, which moves
# that request's confidence by up to ~1e-3 (tests/test_torch_cim.py
# counts such flips).  The trunk's flips between card and CPU are
# counted on the batches the card admitted: confidence and MI are held
# to this only when one is present, to TOL's atol otherwise; verdicts,
# predictions and sample counts must be equal either way.
CIM_CPU_ATOL = 1e-3
# The sampled head: kernel_bench's shape (benchmarks/kernel_bench.py:32)
# and its sample counts (:73), the SAR head's shape at Fig. 16's batch.
BENCH_HEAD = dict(b=8, k=512, n=2048)
BENCH_R = (4, 16, 20, 64)
SAR_HEAD = dict(b=64, k=64, n=2)
UQ_R = 20
UQ_BATCHES = 16                      # Fig. 16: 16 batches of 64 images
FIG9 = dict(n_rows=256, n_cols=256, num_samples=8)
# The kernels were redesigned for Hopper.  The previous design's times
# at the same shapes (PERF.md §6: chip_smoke.py,
# CUDA-graph replay, on the card named here), printed as constants on
# the ``previous_design`` line, apart from this run's measurements; the
# old kernels are not timed here.
DESIGN = {"decision_stats": "small-N variant: a thread per (sample, class) "
                            "pair; tiled variant for N > 32: tiles of "
                            "256 columns x slots, each tile's (max, S1, "
                            "S2) a sample, a merge a slot (lse and entropy), "
                            "then the column sums: three kernels",
          "cim_mvm": "tiles to the shape; chunks split over a thread-block "
                     "cluster, folded in order",
          "grng_eps": "two cells a thread (rows k, k + 8), 32 columns by 16 "
                      "rows a block; column prefixes from a per-block table "
                      "and currents, imprint and read-noise terms from "
                      "per-block tables by (top bit, byte sum): one mix32, "
                      "a dp4a and a shared load a current; 0/1 selection "
                      "stages as fused multiply-adds; predicated streaming "
                      "stores",
          "bayes_head": "tile to the shape; each current hashed once per "
                        "tile by the whole block into a generated weight "
                        "tile; K chunks walked and folded in order; paper "
                        "loops its sample chunks over the kept currents"}
PREV_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PREV_DECISION_MS = {"main_r4": 0.00399, "main_r20": 0.0104}
# the last build before the tiled variant (PERF.md §6), on the card named
# in PREV_CARD: the small-N variant at the SAR shapes (its code is the
# same since) and the streaming wide-N design at the LM's (B 4,
# N 152,064); printed on the ``previous_design`` line, not timed here
EARLIER_DECISION_MS = {"main_r4": 0.0033146560192108153,
                       "main_r20": 0.003542464017868042,
                       "lm_r4": 11.225823720296225,
                       "lm_r20": 51.25464375813802}
PREV_CIM_MS = {"trunk0": 0.00707, "trunk1": 0.0118, "trunk2": 0.0186}
# the head kernels' first design, by R at kernel_bench's head and at the
# UQ path's shape (PERF.md §6)
PREV_HEAD_MS = {
    "bayes_rank16": {"r4": 0.147, "r16": 0.150, "r20": 0.151, "r64": 0.162,
                     "path_r20": 0.0255},
    "bayes_paper": {"r4": 0.0895, "r16": 0.154, "r20": 0.234, "r64": 0.289,
                    "adc_r20": 0.245, "path_r20": 0.0323}}
NO_SPILL = ("cim_mvm", "decision", "bayes_mvm", "grng_eps")
# fixed-R serving above one decision launch's samples (MAX_SAMPLES = 64)
FIXED_R = 100
# Training (mission/detector.trained_detector): a short run on the card
# and on the CPU from one seed, held to TRAIN_CE_ATOL per step and to
# TRAIN_PARAM_ATOL on the params at the end (the two devices sum the
# convolutions in other orders; AdamW's normalized update carries a last
# bit of a near-zero gradient component into the params at the scale of
# lr); then the reference's default run (1600 steps) on the card.
N_SHORT = 30
TRAIN_CE_ATOL = 1e-4
TRAIN_PARAM_ATOL = 1e-3
PROFILE_STEPS = 20
# the escalating policy of the serving phases
ESC_POLICY = dict(POLICY, conf_threshold=0.55)
# the decision kernel's shared_sel_r64 case relaunched, each launch held
# bit for bit to the first and to the plain version's tolerance
SHARED_SEL_REPEATS = 300
# Missions (mission.fly_mission).  The card against the CPU at the
# reference's test size (tests/test_mission.py:25-27); the matrix at
# mission_bench's default scale (benchmarks/mission_bench.py:52-55):
# three modes on the ideal die and on the seed-11 die at severity 2.5.
MISSION_SMALL = dict(world=dict(grid=6, n_victims=3, seed=2),
                     uav=dict(n_drones=2, battery_J=120e-6), steps=18,
                     episodes=1)
MISSION_BENCH = dict(world=dict(grid=14, n_victims=10, seed=0),
                     uav=dict(n_drones=4, battery_J=320e-6), steps=70,
                     episodes=2)
MISSION_DIE = dict(seed=11, severity=2.5)
MISSION_MODES = ("deterministic", "bayes_fixed", "bayes_adaptive")
MISSION_INT_LOGS = ("cell", "active", "verdict", "prediction", "spent",
                    "orbited", "verify", "found", "false_verify", "truth")


def kernel_spills(log: str) -> dict:
    """{kernel: the larger of its spill stores and loads in bytes} from
    a ``-Xptxas=-v`` report."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn is not None:
            out[fn] = max(int(m.group(1)), int(m.group(2)))
    return out


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# kernel cases
# ----------------------------------------------------------------------
def decision_case(b, n, r, *, read_sigma=0.0, shared_sel=False,
                  row_offset=0, k=64, seed=0):
    """Inputs of one decision round built by the port's own path (head
    deployment, activation basis, stream selections) on the card."""
    import torch
    from repro_torch.core.clt_grng import GRNGConfig
    from repro_torch.core.sampling import (BayesHeadConfig,
                                           activation_basis,
                                           prepare_serving_head)
    from repro_torch.serving import adaptive
    gen = torch.Generator().manual_seed(seed)
    grng = GRNGConfig(read_sigma=read_sigma)
    hcfg = BayesHeadConfig(mode="rank16", grng=grng,
                           compute_dtype=torch.float32, hoist_basis=True)
    mu = (torch.randn((k, n), generator=gen) * 0.3).cuda()
    sigma = torch.nn.functional.softplus(
        torch.randn((k, n), generator=gen) - 3).cuda() * 0.5
    x = torch.randn((b, k), generator=gen).cuda()
    ab = activation_basis(prepare_serving_head(mu, sigma, hcfg), x, hcfg)
    ab = {key: v.contiguous() for key, v in ab.items()}
    base = (torch.randint(0, 2**20, (b,), generator=gen) * 20).cuda()
    drawn = torch.randint(0, 4, (b,), generator=gen).cuda() * 4
    idx = adaptive.stream_indices(base, drawn, r)
    sel = adaptive.stream_selections(grng, base, drawn, r)
    if shared_sel:
        sel, idx = sel[:, 0].contiguous(), idx[:, 0].contiguous()
    mask = (torch.arange(b) % 2 == 0).cuda()
    rows = (torch.arange(b, dtype=torch.int64) + row_offset).cuda() \
        if row_offset else None
    return dict(y_mu=ab["y_mu"], x_sigma=ab["x_sigma"], m=ab["m"], sel=sel,
                cfg=grng, x_sigsq=ab.get("x_sigsq"), sample_idx=idx,
                mask=mask, rows=rows)


def decision_check(name: str, args: dict, spec: dict) -> float:
    """The decision kernel against its plain version on ``args``: every
    statistic within TOL, masked slots untouched, a second launch bit
    for bit equal to the first.  Emits the case; -> its max abs error."""
    import torch
    from repro_torch.kernels.decision import (decision_stats,
                                              decision_stats_plain)
    got = decision_stats(**args)
    want = decision_stats_plain(**args)
    torch.cuda.synchronize()
    err = max(float((got[k] - want[k]).abs().max()) for k in STAT_KEYS)
    for key in STAT_KEYS:
        check(torch.allclose(got[key], want[key], **TOL),
              f"decision kernel != plain version: {name} {key} (max "
              f"abs diff {float((got[key] - want[key]).abs().max())})")
    masked = ~args["mask"]
    check(bool((got["sum_p"][masked] == 0).all()),
          f"masked slots advanced: {name}")
    n, r = args["y_mu"].shape[1], args["sel"].shape[0]
    rel = relative_errors(name, got, want, r, n) if n > 32 else None
    again = decision_stats(**args)
    torch.cuda.synchronize()
    identical = all(torch.equal(got[k], again[k]) for k in STAT_KEYS)
    check(identical, f"two launches differ: {name}")
    emit({"kernel_check": "decision_stats", "case": name, **spec,
          "max_abs_err": err, "rtol": TOL["rtol"], "atol": TOL["atol"],
          "bit_identical_relaunch": identical,
          **({"relative": {"rtol": LM_RTOL, "errors": rel}} if rel else {})})
    return err


def run_kernel_checks() -> tuple[float, dict]:
    from repro_torch.kernels.decision import decision_stats
    cases = {
        "main_r4": dict(b=32, n=2, r=4),
        "main_r20": dict(b=32, n=2, r=20),
        "ragged_n300": dict(b=9, n=300, r=6),
        "read_noise_rows": dict(b=32, n=2, r=4, read_sigma=0.4,
                                row_offset=1000),
        "read_noise_ragged": dict(b=9, n=300, r=6, read_sigma=0.4,
                                  row_offset=77),
        "shared_sel_r64": dict(b=5, n=130, r=64, read_sigma=0.4,
                               shared_sel=True),
        "wide_n4097": dict(b=4, n=4097, r=20, read_sigma=0.4,
                           row_offset=500),
        "wide_n50280": dict(b=4, n=50280, r=20),
    }
    worst = 0.0
    inputs = {}
    for i, (name, spec) in enumerate(cases.items()):
        args = decision_case(seed=i, **spec)
        worst = max(worst, decision_check(name, args, spec))
        inputs[name] = args
    emit(shared_sel_repeat(inputs["shared_sel_r64"]))
    too_many = decision_case(b=4, n=2, r=65)
    try:
        decision_stats(**too_many)
    except ValueError:
        pass
    else:
        raise AssertionError("R=65 should be refused by the wrapper")
    return worst, inputs


def shared_sel_repeat(args: dict) -> dict:
    """The shared_sel_r64 case (tiled variant, read noise, one
    selection row shared by the slots) relaunched SHARED_SEL_REPEATS
    times: every launch bit for bit equal to the first, and within TOL
    of the plain version, itself run as often and held to its first
    bits (its product is cuBLAS's)."""
    import torch
    from repro_torch.kernels.decision import (decision_stats,
                                              decision_stats_plain)
    kernel = [decision_stats(**args) for _ in range(SHARED_SEL_REPEATS)]
    plain = [decision_stats_plain(**args) for _ in range(SHARED_SEL_REPEATS)]
    torch.cuda.synchronize()
    differ = sum(not all(torch.equal(k[key], kernel[0][key])
                         for key in STAT_KEYS) for k in kernel)
    plain_differ = sum(not all(torch.equal(q[key], plain[0][key])
                               for key in STAT_KEYS) for q in plain)
    outside = sum(not all(torch.allclose(k[key], plain[0][key], **TOL)
                          for key in STAT_KEYS) for k in kernel)
    worst = max(float((k[key] - plain[0][key]).abs().max())
                for k in kernel for key in STAT_KEYS)
    check(differ == 0, f"shared_sel_r64: {differ} of {SHARED_SEL_REPEATS} "
          f"kernel launches differ from the first")
    check(plain_differ == 0, f"shared_sel_r64: {plain_differ} plain runs "
          f"differ from the first")
    check(outside == 0, f"shared_sel_r64: {outside} launches outside the "
          f"tolerance of the plain version (max abs diff {worst})")
    return {"kernel_check": "decision_stats repeated", "case":
            "shared_sel_r64", "launches": SHARED_SEL_REPEATS,
            "differ_from_first": differ, "plain_differ_from_first":
            plain_differ, "outside_tolerance": outside,
            "max_abs_err": worst, "rtol": TOL["rtol"], "atol": TOL["atol"]}


def gate_die():
    """The die the chip-instance main path serves on."""
    from repro_torch.hw import VariationSpec, sample_instances
    return sample_instances(11, 1, VariationSpec().scaled(2.0))[0]


def trunk_cases(n_images: int, die) -> dict:
    """What each conv layer gives the CIM kernel when the die's trunk
    runs ``n_images`` patches of the serving stream (the port's params,
    images and trunk arrays; K padded to 64), by layer: ``trunk<i>``."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import make_sar_stream
    from repro_torch.models import sar_cnn
    cfg = sar_cnn.SarCnnConfig()
    params = sar_cnn.init_sar_cnn(torch.Generator().manual_seed(3), cfg,
                                  device="cuda")
    trunk = sar_cnn.program_trunk(params, cfg, die)
    h = torch.as_tensor(np.stack(
        [r.payload for r in make_sar_stream(n_images, corrupt_frac=0.25)]),
        device="cuda")
    cases = {}
    for i, layer in enumerate(trunk):
        cases[f"trunk{i}"] = trunk_operands(h, layer, cfg)
        h = sar_cnn._cim_conv(h, layer, cfg)
    return cases


def trunk_operands(h, layer: dict, cfg) -> dict:
    """What ``models.sar_cnn._cim_conv`` gives the CIM kernel for the
    activations ``h`` and a programmed ``layer``: the quantized im2col
    (K padded to the array depth), the weights, the measured ADC full
    scale and the die's column front end."""
    import torch.nn.functional as F
    from repro_torch.core import quant as q
    from repro_torch.kernels.ops import measured_full_scale
    from repro_torch.models import sar_cnn
    cols = sar_cnn._im2col(h, layer["k"], 2)
    d = cols.shape[-1]
    xq, _ = q.quantize_input(cols.reshape(-1, d), cfg.quant)
    xq = F.pad(xq, (0, layer["w"].shape[0] - d)).contiguous()
    return dict(x=xq, w=layer["w"], fs=measured_full_scale(
        xq, layer["w"], cfg.quant).reshape(1), gain=layer["gain"],
        offset=layer["offset"])


def cim_cases() -> dict:
    """CIM kernel operands on the card.  ``trunk<i>``: what conv layer i
    gives the kernel when the main path admits 32 slots on the gate die.
    ``ragged_*``: random operands at the reference's ragged test shapes.
    Every case carries the gate die's column front end."""
    import torch
    from repro_torch.kernels.ops import measured_full_scale
    from repro_torch.models.sar_cnn import SarCnnConfig
    cfg = SarCnnConfig()
    die = gate_die()
    cases = trunk_cases(32, die)
    gen = torch.Generator().manual_seed(5)
    for m, k, n in ((130, 192, 257), (8, 192, 70)):
        x = torch.randn((m, k), generator=gen).cuda()
        w = (torch.randn((k, n), generator=gen) * 0.05).cuda()
        gain, off = die.adc_columns(n)
        cases[f"ragged_{m}x{k}x{n}"] = dict(
            x=x, w=w, fs=measured_full_scale(x, w, cfg.quant).reshape(1),
            gain=torch.as_tensor(gain, device="cuda"),
            offset=torch.as_tensor(off, device="cuda"))
    return cases


def cim_check(name: str, c: dict, qcfg, summary: dict) -> None:
    """The CIM kernel against its plain version on the operands ``c``,
    with the ideal ADC and with ``c``'s column front end: at most 1e-4
    of the outputs off by more than CIM_TOL's atol, none by more than
    one LSB, the rest within CIM_TOL, a second launch bit for bit equal
    to the first, and a zero-variation front end equal to the ideal ADC.
    Emits each front and adds it to ``summary``."""
    import torch
    from repro_torch.kernels.cim import cim_mvm, cim_mvm_plain
    m, k = c["x"].shape
    n = c["w"].shape[1]
    lsb = float(c["fs"]) / 31
    for front in ("ideal", "die"):
        gain, off = ((None, None) if front == "ideal"
                     else (c["gain"], c["offset"]))
        got = cim_mvm(c["x"], c["w"], c["fs"], qcfg, gain, off)
        want = cim_mvm_plain(c["x"], c["w"], c["fs"], qcfg, gain, off)
        again = cim_mvm(c["x"], c["w"], c["fs"], qcfg, gain, off)
        torch.cuda.synchronize()
        err = (got - want).abs()
        flips = err > CIM_TOL["atol"]
        n_flips = int(flips.sum())
        check(n_flips <= 1e-4 * got.numel(),
              f"CIM {name} {front}: {n_flips} outputs off by more "
              f"than 1e-4")
        check(bool((err[flips] <= lsb * (1 + 1e-4)).all()),
              f"CIM {name} {front}: an output off by more than one "
              f"LSB ({lsb})")
        check(torch.allclose(got[~flips], want[~flips], **CIM_TOL),
              f"CIM kernel != plain version: {name} {front}")
        identical = torch.equal(got, again)
        check(identical, f"two CIM launches differ: {name} {front}")
        rest = float(err[~flips].max()) if n_flips < err.numel() else 0.
        summary["max_abs_err"] = max(summary["max_abs_err"],
                                     float(err.max()))
        summary["max_abs_err_no_flip"] = max(
            summary["max_abs_err_no_flip"], rest)
        summary["adc_code_flips"] += n_flips
        summary["outputs"] += got.numel()
        emit({"kernel_check": "cim_mvm", "case": name, "front": front,
              "M": m, "K": k, "N": n, "max_abs_err": float(err.max()),
              "adc_code_flips": n_flips, "lsb": lsb,
              "rtol": CIM_TOL["rtol"], "atol": CIM_TOL["atol"],
              "bit_identical_relaunch": identical})
    ideal = cim_mvm(c["x"], c["w"], c["fs"], qcfg)
    zero = cim_mvm(c["x"], c["w"], c["fs"], qcfg,
                   torch.ones_like(c["gain"]),
                   torch.zeros_like(c["offset"]))
    torch.cuda.synchronize()
    check(torch.equal(ideal, zero),
          f"CIM {name}: zero-variation front end != ideal ADC")


def run_cim_checks() -> tuple[dict, dict]:
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels.cim import cim_mvm
    qcfg = QuantConfig(enabled=True)
    cases = cim_cases()
    summary = {"max_abs_err": 0.0, "max_abs_err_no_flip": 0.0,
               "adc_code_flips": 0, "outputs": 0}
    for name, c in cases.items():
        cim_check(name, c, qcfg, summary)
    c = cases["ragged_8x192x70"]
    for what, args in (
            ("K % 64", (c["x"][:, :100].contiguous(), c["w"][:100])),
            ("a CPU operand", (c["x"], c["w"].cpu()))):
        try:
            cim_mvm(*args, c["fs"], qcfg)
        except ValueError:
            pass
        else:
            raise AssertionError(f"the CIM wrapper took {what}")
    emit({"cim_checks": "ok", **summary, "zero_variation_is_ideal": True})
    return summary, cases


# ----------------------------------------------------------------------
# main path
# ----------------------------------------------------------------------
def same_decisions(a: dict, b: dict, what: str,
                   atol: float = 1e-5) -> None:
    va = {v["rid"]: v for v in a["verdicts"]}
    vb = {v["rid"]: v for v in b["verdicts"]}
    check(set(va) == set(vb), f"{what}: different requests retired")
    for rid, x in va.items():
        y = vb[rid]
        check((x["verdict"], x["prediction"], x["n_samples"])
              == (y["verdict"], y["prediction"], y["n_samples"]),
              f"{what}: rid {rid} decided differently: {x} vs {y}")
        check(abs(x["confidence"] - y["confidence"]) <= atol
              and abs(x["mutual_information"]
                      - y["mutual_information"]) <= atol,
              f"{what}: rid {rid} confidence/MI differ: {x} vs {y}")


def run_main_path() -> dict:
    from repro_torch.kernels.decision import decision_stats
    from repro_torch.launch.serve import serve_sar
    from repro_torch.serving import TriagePolicy
    policy = TriagePolicy(**POLICY)
    kw = STREAM
    serve_sar(n_requests=32, policy=policy, device="cuda", **kw)  # warm-up

    decision_stats.launches = 0
    out = serve_sar(n_requests=192, policy=policy, device="cuda", **kw)
    launches = decision_stats.launches
    check(out["requests"] == 192 and out["decisions"] == 192,
          f"only {out['requests']} of 192 requests retired")
    check(out["host_syncs"] <= 192, f"host syncs {out['host_syncs']} > 192")
    check(launches > 0, "the main path launched no decision kernel")
    check(launches == out["rounds_launched"],
          f"kernel launches {launches} != rounds {out['rounds_launched']}")
    emit({"main_path": "serve_sar", "device": out["device"],
          "requests": out["requests"], "wall_s": out["wall_s"],
          "decisions_per_s_wall": out["decisions"] / out["wall_s"],
          "host_syncs": out["host_syncs"],
          "host_syncs_per_decision": out["host_syncs_per_decision"],
          "rounds_launched": out["rounds_launched"],
          "decision_kernel_launches": launches,
          "mean_samples_per_decision": out["mean_samples_per_decision"],
          "flag_fraction": out["flag_fraction"],
          "energy_total_J": out["energy_total_J"]})

    decision_stats.launches = 0
    plain = serve_sar(n_requests=192, policy=policy, device="cuda",
                      fused=False, **kw)
    check(decision_stats.launches == 0, "fused=False launched the kernel")
    same_decisions(out, plain, "fused vs fused=False on the card")

    esc = TriagePolicy(conf_threshold=0.55, mi_threshold=0.05, r_min=4,
                       r_max=20)
    esc_f = serve_sar(n_requests=192, policy=esc, device="cuda", **kw)
    esc_p = serve_sar(n_requests=192, policy=esc, device="cuda",
                      fused=False, **kw)
    same_decisions(esc_f, esc_p, "escalating policy, fused vs fused=False")
    depths = sorted({v["n_samples"] for v in esc_f["verdicts"]})
    check(len(depths) >= 3, f"escalating policy did not escalate: {depths}")

    cpu = serve_sar(n_requests=64, policy=policy, device="cpu", **kw)
    card = serve_sar(n_requests=64, policy=policy, device="cuda", **kw)
    same_decisions(card, cpu, "card vs CPU")
    emit({"cross_checks": "ok", "fused_vs_plain_requests": 192,
          "escalating_policy_depths": depths,
          "escalating_decisions_per_s_wall":
              esc_f["decisions"] / esc_f["wall_s"],
          "escalating_mean_samples_per_decision":
              esc_f["mean_samples_per_decision"],
          "escalating_host_syncs_per_decision":
              esc_f["host_syncs_per_decision"],
          "card_vs_cpu_requests": 64})
    return {"launches": launches}


def sar_params(device: str, seed: int = 3 + STREAM["seed"]):
    """The config and random params ``serve_sar`` makes (seed 3 + the
    stream's seed), on ``device``."""
    import torch
    from repro_torch.models import sar_cnn
    cfg = sar_cnn.SarCnnConfig()
    return cfg, sar_cnn.init_sar_cnn(torch.Generator().manual_seed(seed), cfg,
                                     device=device)


def serving_head_cfg():
    """The head config ``make_sar_engine`` deploys a die's head with."""
    import torch
    from repro_torch.core.sampling import BayesHeadConfig
    return BayesHeadConfig(num_samples=POLICY["r_max"], mode="rank16",
                           grng=sar_params("cpu")[0].grng,
                           compute_dtype=torch.float32, hoist_basis=True)


def run_chip_path() -> dict:
    """The chip-instance main path on the card, and its cross-checks."""
    from repro_torch.kernels.cim import cim_mvm
    from repro_torch.kernels.decision import decision_stats
    from repro_torch.launch.serve import serve_sar
    from repro_torch.serving import TriagePolicy
    policy = TriagePolicy(**POLICY)
    die = gate_die()
    kw = dict(STREAM, policy=policy, chip_instance=die)
    serve_sar(n_requests=32, device="cuda", **kw)                # warm-up

    cim_mvm.launches = decision_stats.launches = 0
    out = serve_sar(n_requests=192, device="cuda", **kw)
    cim_launches, launches = cim_mvm.launches, decision_stats.launches
    check(out["chip_read_sigma"] > 0, "the gate die has no read noise")
    check(out["requests"] == 192 and out["decisions"] == 192,
          f"only {out['requests']} of 192 requests retired on the die")
    check(cim_launches == 3 * out["admissions"] > 0,
          f"CIM launches {cim_launches} != 3 x {out['admissions']} "
          f"admissions")
    check(launches == out["rounds_launched"] > 0,
          f"decision launches {launches} != rounds "
          f"{out['rounds_launched']}")
    emit({"main_path": "serve_sar(chip_instance=gate die)",
          "device": out["device"], "chip_id": out["chip_id"],
          "chip_device_seed": out["chip_device_seed"],
          "chip_read_sigma": out["chip_read_sigma"],
          "chip_temp_c": out["chip_temp_c"], "calibrated": out["calibrated"],
          "requests": out["requests"], "wall_s": out["wall_s"],
          "decisions_per_s_wall": out["decisions"] / out["wall_s"],
          "mean_samples_per_decision": out["mean_samples_per_decision"],
          "flag_fraction": out["flag_fraction"],
          "host_syncs": out["host_syncs"],
          "host_syncs_per_decision": out["host_syncs_per_decision"],
          "admissions": out["admissions"], "cim_kernel_launches":
          cim_launches, "rounds_launched": out["rounds_launched"],
          "decision_kernel_launches": launches})

    decision_stats.launches = 0
    plain = serve_sar(n_requests=192, device="cuda", fused=False, **kw)
    check(decision_stats.launches == 0, "fused=False launched the kernel")
    same_decisions(out, plain, "chip: fused vs fused=False on the card")
    esc = dict(kw, policy=TriagePolicy(**ESC_POLICY))
    esc_f = serve_sar(n_requests=192, device="cuda", **esc)
    esc_p = serve_sar(n_requests=192, device="cuda", fused=False, **esc)
    same_decisions(esc_f, esc_p,
                   "chip, escalating policy: fused vs fused=False")
    depths = sorted({v["n_samples"] for v in esc_f["verdicts"]})
    check(len(depths) >= 3, f"escalating policy did not escalate: {depths}")
    uncal = serve_sar(n_requests=192, device="cuda",
                      **dict(kw, calibrated=False))
    check(uncal["requests"] == 192 and not uncal["calibrated"],
          "the uncalibrated die did not serve every request")
    emit({"deploy_card_vs_cpu": "the gate die's serving head (rank16, "
                                "hoisted basis), card against CPU",
          **deploy_gap(sar_params("cpu")[1]["head"], serving_head_cfg(),
                       die)})
    card_vs_cpu = {"main": chip_card_vs_cpu(kw, die),
                   "escalating": chip_card_vs_cpu(esc, die)}
    kinds = card_vs_cpu["escalating"]["decision_kinds"]
    check(kinds >= 2, f"card vs CPU compared {kinds} kind of decision "
          f"under the escalating policy")
    emit({"chip_cross_checks": "ok", "fused_vs_plain_requests": 192,
          "escalating_policy_depths": depths,
          "escalating_decisions_per_s_wall":
              esc_f["decisions"] / esc_f["wall_s"],
          "escalating_mean_samples_per_decision":
              esc_f["mean_samples_per_decision"],
          "uncalibrated_requests": uncal["requests"],
          "uncalibrated_flag_fraction": uncal["flag_fraction"],
          "card_vs_cpu_requests": 64, "card_vs_cpu": card_vs_cpu})
    return {"launches": cim_launches}


def card_run_with_batches(n_requests: int, kw: dict) -> tuple[dict, list]:
    """``serve_sar`` on the card, keeping the image batch of every
    admission (the trunk's input, padding slots included)."""
    import numpy as np
    from repro_torch.launch.serve import serve_sar
    from repro_torch.serving.engine import SarServingEngine
    batches = []
    featurize = SarServingEngine.featurize

    def recording(engine, images):
        batches.append(np.array(images))
        return featurize(engine, images)

    SarServingEngine.featurize = recording
    try:
        out = serve_sar(n_requests=n_requests, device="cuda", **kw)
    finally:
        SarServingEngine.featurize = featurize
    return out, batches


def trunk_code_flips(batches: list, die, params=None) -> tuple[int, ...]:
    """(outputs off by an ADC code, outputs, outputs off by an ADC code
    from the same input) between the card's and the CPU's conv trunk on
    ``die`` over ``batches``: each device runs the trunk on its own
    activations, as its engine does, from ``params``
    (default: the params ``serve_sar`` makes).  A batch is one array
    both devices take, or {device: images} where each renders its own.
    Float order moves an output by ~1e-6, a flipped code by one LSB
    (more than CIM_TOL's atol); a flip also moves the outputs downstream
    of it, which count too.  Each layer is also run on the card from the
    CPU's own input: there, as in run_cim_checks, at most 1e-4 of the
    outputs may flip, and none by more than one LSB of its layer."""
    import torch
    from repro_torch.models import sar_cnn
    from repro_torch.serving.engine import _to_device
    cfg, params = sar_params("cpu") if params is None else (
        sar_params("cpu")[0], _to_device(params, "cpu"))
    trunks = {"cpu": sar_cnn.program_trunk(params, cfg, die),
              "cuda": sar_cnn.program_trunk(_to_device(params, "cuda"),
                                            cfg, die)}
    flips = outputs = same_input_flips = 0
    for images in batches:
        h = {d: torch.as_tensor(images[d] if isinstance(images, dict)
                                else images, device=d) for d in trunks}
        for i in range(len(trunks["cpu"])):
            lsb = float(trunk_operands(h["cpu"], trunks["cpu"][i],
                                       cfg)["fs"]) / 31
            same = sar_cnn._cim_conv(h["cpu"].cuda(), trunks["cuda"][i],
                                     cfg).cpu()
            h = {d: sar_cnn._cim_conv(h[d], trunks[d][i], cfg) for d in h}
            gap = (h["cuda"].cpu() - h["cpu"]).abs()
            flips += int((gap > CIM_TOL["atol"]).sum())
            outputs += gap.numel()
            gap = (same - h["cpu"]).abs()
            same_input_flips += int((gap > CIM_TOL["atol"]).sum())
            check(float(gap.max()) <= lsb * (1 + 1e-4),
                  f"trunk layer {i}, card vs CPU on the same input: an "
                  f"output off by {float(gap.max())}, more than one LSB "
                  f"({lsb})")
    check(same_input_flips <= 1e-4 * outputs,
          f"trunk, card vs CPU on the same input: {same_input_flips} of "
          f"{outputs} outputs off by an ADC code")
    return flips, outputs, same_input_flips


def chip_card_vs_cpu(kw: dict, die) -> dict:
    """64 requests on the gate die on the card and on the CPU: the same
    decisions; confidence and MI within TOL's atol unless the trunk
    flipped an ADC code between the two, then within CIM_CPU_ATOL."""
    from repro_torch.launch.serve import serve_sar
    card, batches = card_run_with_batches(64, kw)
    cpu = serve_sar(n_requests=64, device="cpu", **kw)
    flips, outputs, same_input = trunk_code_flips(batches, die,
                                                  kw.get("params"))
    atol = CIM_CPU_ATOL if flips else TOL["atol"]
    same_decisions(card, cpu, f"chip: card vs CPU ({flips} trunk "
                   f"outputs off by an ADC code)", atol=atol)
    by_rid = {v["rid"]: v for v in cpu["verdicts"]}
    gap = max(max(abs(v[k] - by_rid[v["rid"]][k]) for k in
                  ("confidence", "mutual_information"))
              for v in card["verdicts"])
    return {"requests": card["requests"], "admissions": len(batches),
            "rounds_launched": card["rounds_launched"],
            "depths": sorted({v["n_samples"] for v in card["verdicts"]}),
            "trunk_outputs": outputs, "trunk_code_flips": flips,
            "trunk_code_flips_same_input": same_input,
            "atol": atol, "max_confidence_mi_gap": gap,
            "flag_fraction": card["flag_fraction"],
            "decision_kinds": len({(v["verdict"], v["prediction"],
                                    v["n_samples"])
                                   for v in card["verdicts"]})}


def run_fixed_path() -> dict:
    """Fixed-R serving (one round of r_max samples a dispatch) at r_max =
    FIXED_R on the gate die, 64 requests: each round is cut into
    ⌈FIXED_R / 64⌉ decision launches (counts zeroed just before, read
    just after); the card decides as the CPU does."""
    from repro_torch.kernels.decision import MAX_SAMPLES, decision_stats
    from repro_torch.serving import TriagePolicy
    die = gate_die()
    kw = dict(STREAM, chip_instance=die, adaptive=False,
              policy=TriagePolicy(**dict(POLICY, r_max=FIXED_R)))
    decision_stats.launches = 0
    out = chip_card_vs_cpu(kw, die)
    launches = decision_stats.launches
    pieces = -(-FIXED_R // MAX_SAMPLES)
    check(launches == pieces * out["rounds_launched"] > 0,
          f"fixed R={FIXED_R}: {launches} decision launches for "
          f"{out['rounds_launched']} rounds, expected {pieces} a round")
    check(out["depths"] == [FIXED_R],
          f"fixed R={FIXED_R}: requests decided at {out['depths']} samples")
    emit({"fixed_path": f"serve_sar(adaptive=False, r_max={FIXED_R}, "
                        "chip_instance=gate die)",
          "decision_kernel_launches": launches,
          "launches_per_round": launches / out["rounds_launched"],
          "card_vs_cpu": out})
    return out


# ----------------------------------------------------------------------
# the sampled head: ε and head kernels against their plain versions
# ----------------------------------------------------------------------
def head_inputs(b, k, n, *, read_sigma=0.0, r=UQ_R, sample0=0, seed=0,
                dtype="float32"):
    """x, µ', σ of a head product made on the CPU from a seed, on the
    card, with the config and selections."""
    import torch
    from repro_torch.core.clt_grng import GRNGConfig, selections
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, k), generator=gen)
    mu = torch.randn((k, n), generator=gen) * 0.05
    sigma = torch.nn.functional.softplus(
        torch.randn((k, n), generator=gen) - 2.0) * 0.1
    cfg = GRNGConfig(read_sigma=read_sigma)
    td = getattr(torch, dtype)
    return dict(x=x.to("cuda", td), mu=mu.to("cuda", td),
                sigma=sigma.to("cuda", td), cfg=cfg,
                sel=selections(cfg, r, sample0, device="cuda"),
                sample0=sample0)


def head_full_scale(c) -> "torch.Tensor":
    """The paper ADC's full scales as ``ops.bayes_head_mvm`` computes
    them, on the card."""
    import torch
    from repro_torch.core.quant import QuantConfig, adc_full_scale

    def rms(t):
        return torch.sqrt((t.float() ** 2).mean() + 1e-12)
    q = QuantConfig(enabled=True)
    return torch.stack([adc_full_scale(rms(c["x"]), rms(w), q)
                        for w in (c["mu"], c["sigma"])])


def head_call(kind: str, c: dict, plain: bool = False):
    """One call of a head kernel (or its plain version) on case ``c``:
    kind 'rank16', 'paper' or 'paper_adc'."""
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels import bayes
    kw = dict(sample0=c["sample0"])
    if kind == "rank16":
        fn = bayes.bayes_rank16_plain if plain else bayes.bayes_rank16
        return fn(c["x"], c["mu"], c["sigma"], c["sel"], c["cfg"], **kw)
    fn = bayes.bayes_paper_plain if plain else bayes.bayes_paper
    qcfg = QuantConfig(enabled=True) if kind == "paper_adc" else None
    return fn(c["x"], c["mu"], c["sigma"], c["sel"], c.get("fs"), c["cfg"],
              qcfg, **kw)


def eps_case(k, n, r, *, die=False, grng=None, row0=0, col0=0, sample0=0,
             mixed_sel=False, indexed=False):
    """Arguments of one ε block on the card under ``GRNGConfig(**grng)``
    (or the gate die's view of ``GRNGConfig()`` when ``die``): the
    selections of samples ``sample0 % 4096`` ... (the LFSR is walked from
    its start, so samples past 2^32 take earlier selections; the read
    noise is keyed on ``sample0`` itself), or with ``indexed`` the
    training draw's one selection ``lfsr.indexed_selections(lfsr_seed,
    sample0)``; ``mixed_sel`` overwrites two rows with values other than
    0 and 1, which take the kernel's product chain."""
    import torch
    from repro_torch.core import lfsr
    from repro_torch.core.clt_grng import GRNGConfig, selections
    cfg = GRNGConfig(**(grng or {}))
    if die:
        cfg = gate_die().grng(cfg)
    if indexed:
        sel = lfsr.indexed_selections(cfg.lfsr_seed, torch.full(
            (r,), sample0, dtype=torch.int64, device="cuda"))
    else:
        sel = selections(cfg, r, sample0 % 4096, device="cuda")
    if mixed_sel:
        gen = torch.Generator().manual_seed(9)
        sel[1] = torch.rand(16, generator=gen).to(sel.device)
        sel[r - 1] = torch.where(sel[r - 1] > 0, 0.5, -0.25)
    return dict(sel=sel, cfg=cfg, n_rows=k, n_cols=n, row0=row0, col0=col0,
                sample0=sample0)


WRAP = 2**32
# The ε kernel against its plain version: the three timed shapes, offsets
# up to and past the 2^32 wrap, R = 1, R past one stage of 64 samples, an
# aged die (imprint) and selection rows other than 0/1.
EPS_CASES = {
    "fig9_256x256_r8": dict(k=256, n=256, r=8),
    "fig9_gate_die_256x256_r8": dict(k=256, n=256, r=8, die=True),
    "bench_512x2048_r20": dict(k=512, n=2048, r=20),
    "aged_200x130_r8_offsets": dict(
        k=200, n=130, r=8, row0=16, col0=40, sample0=5,
        grng=dict(read_sigma=0.5, imprint=0.37)),
    "wrap_70x33_r64": dict(
        k=70, n=33, r=64, row0=WRAP - 20, col0=WRAP - 7, sample0=WRAP - 30,
        grng=dict(read_sigma=0.5, imprint=0.37)),
    "past_wrap_37x45_r1": dict(k=37, n=45, r=1, row0=WRAP + 5,
                               col0=2 * WRAP - 3, sample0=WRAP + 2,
                               die=True),
    "stages_20x40_r130": dict(k=20, n=40, r=130, sample0=3, die=True),
    "mixed_sel_40x70_r12": dict(k=40, n=70, r=12, die=True, mixed_sel=True),
    # the training draw: the SAR head's block at one step's selection
    "train_64x2_r1": dict(k=64, n=2, r=1, sample0=799, indexed=True),
}
EPS_TIMED = ("fig9_256x256_r8", "fig9_gate_die_256x256_r8",
             "bench_512x2048_r20", "train_64x2_r1")


def run_grng_checks() -> None:
    """The ε kernel against its plain version on every case of
    EPS_CASES: equal bits (``torch.equal``), and two launches equal."""
    import torch
    from repro_torch.kernels import grng
    for name, spec in EPS_CASES.items():
        c = eps_case(**spec)
        got = grng.grng_eps(**c)
        want = grng.grng_eps_plain(**c)
        again = grng.grng_eps(**c)
        torch.cuda.synchronize()
        n_unequal = int((got != want).sum())
        check(torch.equal(got, want), f"GRNG ε kernel != plain version: "
              f"{name} ({n_unequal} elements differ, largest by "
              f"{float((got - want).abs().max())})")
        identical = torch.equal(got, again)
        check(identical, f"two ε launches differ: {name}")
        emit({"kernel_check": "grng_eps", "case": name, "K": c["n_rows"],
              "N": c["n_cols"], "R": c["sel"].shape[0],
              "offsets": [c["row0"], c["col0"], c["sample0"]],
              "read_sigma": c["cfg"].read_sigma, "imprint": c["cfg"].imprint,
              "equal": True, "elements": got.numel(),
              "bit_identical_relaunch": identical})


def run_head_checks() -> dict:
    """The rank16 and paper head kernels against their plain versions at
    the SAR head's shape and at kernel_bench's, with and without read
    noise, paper also with the ADC; run-to-run bit identity; refusals."""
    import torch
    worst = {"rank16": 0.0, "paper": 0.0}
    flips = outputs = 0
    for shape_name, shape in (("sar_head", SAR_HEAD),
                              ("kernel_bench", BENCH_HEAD)):
        for read_sigma in (0.0, 0.4):
            c = head_inputs(**shape, read_sigma=read_sigma, sample0=7)
            c["fs"] = head_full_scale(c)
            for kind in ("rank16", "paper", "paper_adc"):
                got = head_call(kind, c)
                want = head_call(kind, c, plain=True)
                again = head_call(kind, c)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()),
                      f"{kind} {shape_name}: non-finite samples")
                err = (got - want).abs()
                off = err > 1e-4 + 1e-4 * want.abs()
                n_flips = int(off.sum()) if kind == "paper_adc" else 0
                if kind == "paper_adc":
                    lsb = float(c["fs"].max()) / 31
                    check(n_flips <= 1e-4 * got.numel(),
                          f"{kind} {shape_name}: {n_flips} outputs off")
                    check(bool((err[off] <= lsb * (1 + 1e-4)).all()),
                          f"{kind} {shape_name}: an output off by more "
                          f"than one LSB ({lsb})")
                    check(torch.allclose(got[~off], want[~off], rtol=1e-4,
                                         atol=1e-4),
                          f"paper ADC kernel != plain: {shape_name}")
                else:
                    check(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
                          f"{kind} kernel != plain version: {shape_name} "
                          f"read_sigma={read_sigma} ({float(err.max())})")
                identical = torch.equal(got, again)
                check(identical, f"two {kind} launches differ: {shape_name}")
                key = "rank16" if kind == "rank16" else "paper"
                rest = float(err[~off].max()) if n_flips < err.numel() else 0.
                worst[key] = max(worst[key], rest if n_flips else
                                 float(err.max()))
                flips += n_flips
                outputs += got.numel() if kind == "paper_adc" else 0
                emit({"kernel_check": f"bayes_{kind}", "case": shape_name,
                      **shape, "R": UQ_R, "read_sigma": read_sigma,
                      "max_abs_err": float(err.max()),
                      "adc_code_flips": n_flips, "rtol": 1e-4, "atol": 1e-4,
                      "bit_identical_relaunch": identical})
    c = head_inputs(**SAR_HEAD)
    for what, bad in (("a CPU operand", dict(c, mu=c["mu"].cpu())),
                      ("float64 x", dict(c, x=c["x"].double()))):
        try:
            head_call("rank16", bad)
        except (ValueError, TypeError):
            pass
        else:
            raise AssertionError(f"the head wrapper took {what}")
    emit({"head_checks": "ok", "max_abs_err": worst,
          "paper_adc_code_flips": flips, "paper_adc_outputs": outputs})
    return {"worst": worst, "flips": flips}


# ----------------------------------------------------------------------
# the SAR UQ path (Fig. 16) and the Fig. 9 path
# ----------------------------------------------------------------------
def uq_batches(device: str, n: int = UQ_BATCHES,
               corruption: str = "fog") -> dict:
    """Fig. 16's test batches: {condition: [(images, labels), ...]},
    clean and corrupted at severity 1.0."""
    from repro_torch.data.sard import SardConfig, batch_at, corrupted_batch
    dcfg = SardConfig(image_size=32, seed=7)
    out = {"clean": [], corruption: []}
    for i in range(n):
        clean = batch_at(dcfg, 10_000 + i, 64)
        dirty = corrupted_batch(dcfg, 10_000 + i, 64, corruption, 1.0)
        for cond, data in (("clean", clean), (corruption, dirty)):
            out[cond].append((data["images"].to(device),
                              data["labels"].to(device)))
    return out


def uq_params(device: str):
    return sar_params(device, seed=3)


def die_head(params, cfg, mode: str, die):
    """The gate die's calibrated head, deployed on the params' device (as
    the serving engine deploys it on its own)."""
    import torch
    from repro_torch.core.bayes_layer import sigma_of
    from repro_torch.core.sampling import BayesHeadConfig
    from repro_torch.hw import prepare_instance_head
    hcfg = BayesHeadConfig(num_samples=UQ_R, mode=mode, grng=cfg.grng,
                           compute_dtype=torch.float32)
    return prepare_instance_head(params["head"]["mu"],
                                 sigma_of(params["head"]), hcfg, die,
                                 calibrated=True)


def float_ulps(a: float, b: float) -> int:
    """How many float32 values apart two float32 numbers of one sign
    are."""
    import struct

    def bits(x):
        return struct.unpack("<i", struct.pack("<f", x))[0]
    return abs(bits(a) - bits(b))


def deploy_gap(head: dict, hcfg, die) -> dict:
    """The die's calibrated head deployed by ``prepare_instance_head`` on
    the card and on the CPU from the same host params ``head``: the
    measured constants of each and their distance in float32 steps, the
    largest difference of each deployed array, and, deployed again with
    the 8-bit µ' / 4-bit σ quantization, the codes that differ (by more
    than half a column's step, not a last bit)."""
    import dataclasses
    from repro_torch.core.bayes_layer import sigma_of
    from repro_torch.core.quant import QuantConfig
    from repro_torch.hw import prepare_instance_head
    mu, sigma = head["mu"].cpu(), sigma_of(head).cpu()

    def deployed(qcfg):
        cfg = dataclasses.replace(hcfg, quant=qcfg)
        (card, card_cfg), (cpu, cpu_cfg) = (
            prepare_instance_head(mu.to(d), sigma.to(d), cfg, die,
                                  calibrated=True) for d in ("cuda", "cpu"))
        check(all(v.device.type == "cuda" for v in card.values()),
              "the card's deployment left the card")
        gap = {k: float((card[k].cpu() - v).abs().max())
               for k, v in cpu.items()}
        return card, cpu, card_cfg.grng, cpu_cfg.grng, gap

    _, _, g_card, g_cpu, gap = deployed(QuantConfig(enabled=False))
    qcfg = QuantConfig(enabled=True)
    card, cpu, _, _, qgap = deployed(qcfg)
    flips = 0
    for key, levels in (("mu_prime", 2 ** (qcfg.mu_bits - 1) - 1),
                        ("sigma", 2 ** qcfg.sigma_bits - 1)):
        step = cpu[key].abs().amax(dim=0, keepdim=True) / levels
        flips += int(((card[key].cpu() - cpu[key]).abs() > 0.5 * step).sum())
    return {"sum_mean": [g_card.sum_mean, g_cpu.sum_mean],
            "sum_std": [g_card.sum_std, g_cpu.sum_std],
            "constants_ulps": [float_ulps(g_card.sum_mean, g_cpu.sum_mean),
                               float_ulps(g_card.sum_std, g_cpu.sum_std)],
            "max_abs_diff": gap,
            "quantized": {"max_abs_diff": qgap, "code_flips": flips,
                          "codes": cpu["mu_prime"].numel()
                          + cpu["sigma"].numel()}}


def sample_uq(params, cfg, batches: dict, die=None) -> dict:
    """R=20 logit samples of every batch in both modes, through
    ``logit_samples_serve`` (ideal die) or the die's trunk and calibrated
    head (``features(trunk=)`` + ``logit_samples``): {mode: {condition:
    [R, B·n, 2]}} and the labels."""
    import torch
    from repro_torch.core.sampling import logit_samples
    from repro_torch.models import sar_cnn
    modes = ("rank16", "paper")
    out = {m: {} for m in modes}
    labels = {}
    if die is not None:
        trunk = sar_cnn.program_trunk(params, cfg, die)
        heads = {m: die_head(params, cfg, m, die) for m in modes}
    for cond, items in batches.items():
        per = {m: [] for m in modes}
        for images, _ in items:
            if die is None:
                for m in modes:
                    per[m].append(sar_cnn.logit_samples_serve(
                        params, images, cfg, UQ_R, mode=m))
            else:
                feats = sar_cnn.features(params, images, cfg, trunk=trunk)
                for m in modes:
                    head, scfg = heads[m]
                    per[m].append(logit_samples(head, feats, scfg))
        for m in modes:
            out[m][cond] = torch.cat(per[m], dim=1)
        labels[cond] = torch.cat([lab for _, lab in items])
    return {"samples": out, "labels": labels}


def uq_reports(res: dict) -> dict:
    from repro_torch.core.uncertainty import uq_report
    return {m: {cond: {k: float(v) for k, v in uq_report(
        s, res["labels"][cond]).items()} for cond, s in per.items()}
        for m, per in res["samples"].items()}


def run_uq_path() -> dict:
    """The SAR UQ path on the ideal die and on the gate die, launch
    counts zeroed just before each and read just after."""
    import torch
    from repro_torch.kernels import bayes
    from repro_torch.kernels.cim import cim_mvm
    cfg, params = uq_params("cuda")
    batches = uq_batches("cuda")
    n_batches = sum(len(v) for v in batches.values())
    sample_uq(params, cfg, {"clean": batches["clean"][:1]})      # warm-up
    die = gate_die()
    launches = {}
    reports = {}
    results = {}
    for name, chip in (("ideal", None), ("gate_die", die)):
        torch.cuda.synchronize()
        bayes.bayes_rank16.launches = bayes.bayes_paper.launches = 0
        cim_mvm.launches = 0
        t0 = time.perf_counter()
        res = sample_uq(params, cfg, batches, die=chip)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"bayes_rank16": bayes.bayes_rank16.launches,
                  "bayes_paper": bayes.bayes_paper.launches,
                  "cim_mvm": cim_mvm.launches}
        check(counts["bayes_rank16"] == counts["bayes_paper"] == n_batches,
              f"{name}: head launches {counts} != {n_batches} batches a mode")
        check(counts["cim_mvm"] == (3 * n_batches if chip else 0),
              f"{name}: CIM launches {counts['cim_mvm']}")
        for m, per in res["samples"].items():
            for cond, s in per.items():
                check(tuple(s.shape) == (UQ_R, 64 * UQ_BATCHES, 2)
                      and bool(torch.isfinite(s).all()),
                      f"{name} {m} {cond}: samples {tuple(s.shape)}")
        r16, pap = res["samples"]["rank16"], res["samples"]["paper"]
        if chip is None:   # no read noise: the modes give the same samples
            gap = max(float((r16[c] - pap[c]).abs().max()) for c in r16)
            check(gap <= 1e-4, f"ideal die: rank16 vs paper samples {gap}")
        else:
            # read noise: per-cell draws (paper) against their logit-level
            # projection (rank16) agree in distribution; the per-logit
            # means over R samples, as z-scores against the samples' own
            # spread, stay inside 6 (2048 logits a condition)
            gap = max(float(((r16[c].mean(0) - pap[c].mean(0)).abs()
                             / torch.sqrt((r16[c].var(0) + pap[c].var(0))
                                          / UQ_R + 1e-12)).max())
                      for c in r16)
            check(gap <= 6.0, f"die: rank16 vs paper mean z-score {gap}")
        reports[name] = uq_reports(res)
        launches[name] = counts
        results[name] = res
        emit({"uq_path": name, "images": 64 * n_batches,
              "conditions": list(batches), "R": UQ_R, "wall_s": wall,
              "launches": counts, "rank16_vs_paper_gap": gap,
              "uq_report": reports[name]})
    card_vs_cpu = uq_card_vs_cpu(results, die)
    emit({"uq_cross_checks": "ok", "card_vs_cpu": card_vs_cpu})
    return {"launches": launches, "reports": reports}


def uq_card_vs_cpu(results: dict, die) -> dict:
    """The first clean and fog batch on the CPU against the card's
    samples of them: equal predictions, confidence within 1e-5 (1e-3
    on the die if its trunk flipped an ADC code between the two)."""
    import torch
    from repro_torch.core.sampling import BayesHeadConfig
    from repro_torch.core.uncertainty import predictive_stats
    from repro_torch.models import sar_cnn
    cfg, params = uq_params("cpu")
    batches = uq_batches("cpu", n=1)
    emit({"deploy_card_vs_cpu": "the gate die's UQ heads, card against CPU",
          **{m: deploy_gap(params["head"], BayesHeadConfig(
              num_samples=UQ_R, mode=m, grng=cfg.grng,
              compute_dtype=torch.float32), die)
             for m in ("rank16", "paper")}})
    out = {}
    for name, chip in (("ideal", None), ("gate_die", die)):
        cpu = sample_uq(params, cfg, batches, die=chip)
        flips = 0
        if chip is not None:
            trunks = {"cpu": sar_cnn.program_trunk(params, cfg, die),
                      "cuda": sar_cnn.program_trunk(uq_params("cuda")[1],
                                                    cfg, die)}
            for images, _ in batches["clean"] + batches["fog"]:
                h = {"cpu": images, "cuda": images.cuda()}
                for i in range(len(trunks["cpu"])):
                    h = {d: sar_cnn._cim_conv(h[d], trunks[d][i], cfg)
                         for d in h}
                    flips += int(((h["cuda"].cpu() - h["cpu"]).abs()
                                  > CIM_TOL["atol"]).sum())
        atol = CIM_CPU_ATOL if flips else TOL["atol"]
        gap = 0.0
        for m, per in cpu["samples"].items():
            for cond, s_cpu in per.items():
                s_card = results[name]["samples"][m][cond][:, :64].cpu()
                a, b = predictive_stats(s_card), predictive_stats(s_cpu)
                check(torch.equal(a["prediction"], b["prediction"]),
                      f"{name} {m} {cond}: card and CPU predict differently")
                d = float((a["confidence"] - b["confidence"]).abs().max())
                check(d <= atol, f"{name} {m} {cond}: confidence gap {d}")
                gap = max(gap, d)
        out[name] = {"batches": 2, "trunk_code_flips": flips, "atol": atol,
                     "max_confidence_gap": gap}
    return out


def run_fig9_path() -> dict:
    """Fig. 9: the ε block through ``ops.grng_eps`` (count zeroed before,
    read after), the calibration and the distribution sample."""
    import numpy as np
    import torch
    from repro_torch.core import clt_grng as g
    from repro_torch.kernels import grng, ops
    cfg = g.GRNGConfig()
    torch.cuda.synchronize()
    grng.grng_eps.launches = 0
    e = ops.grng_eps(cfg, **FIG9)
    torch.cuda.synchronize()
    launches = grng.grng_eps.launches
    check(launches == 1, f"Fig. 9 path: {launches} ε launches")
    check(tuple(e.shape) == (8, 256, 256) and bool(torch.isfinite(e).all()),
          "Fig. 9 ε block malformed")
    # the entry points' default device is the card
    mean, std = g.calibrate(cfg, 4096, 64)
    check(mean.device.type == "cuda", "calibrate ran off the card")
    flat = g.distribution_sample(cfg, 8192, 32)
    check(abs(float(mean) - 10.1) < 0.2 and abs(float(std) - 0.993) < 0.1,
          f"Fig. 9 sum statistics off: {float(mean)}, {float(std)}")
    out = {"launches": launches, "eps_mean": float(e.mean()),
           "eps_sd": float(e.std()), "sum_mean_uA": float(mean),
           "sum_sd_uA": float(std),
           "distribution_sample_mean": float(np.mean(flat)),
           "distribution_sample_sd": float(np.std(flat)),
           "distribution_sample_size": int(flat.size)}
    emit({"fig9_path": "ops.grng_eps + calibrate + distribution_sample",
          **out})
    return out


# ----------------------------------------------------------------------
# training (mission/detector) and the trained detector
# ----------------------------------------------------------------------
def run_train_path() -> dict:
    """``trained_detector`` on the card: N_SHORT steps on the card and on
    the CPU from one seed (per-step ce and the params compared, one ε
    launch a step), a profile of PROFILE_STEPS steps, then the
    reference's default run (1600 steps, batch 64, snow, severity ≤ 0.5)
    timed, restored from its cache and compared bit for bit.  Everything
    is written under a temporary directory."""
    import tempfile
    import torch
    from repro_torch.ckpt import restore
    from repro_torch.kernels import grng
    from repro_torch.mission import detector
    from repro_torch.utils.trees import leaves
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        tmp = Path(tmp)
        runs = {}
        for dev in ("cuda", "cpu"):
            torch.cuda.synchronize()
            grng.grng_eps.launches = 0
            t0 = time.perf_counter()
            params, _ = detector.trained_detector(
                steps=N_SHORT, ckpt_dir=tmp / f"short_{dev}", device=dev)
            torch.cuda.synchronize()
            runs[dev] = {"params": params, "wall_s": time.perf_counter() - t0,
                         "launches": grng.grng_eps.launches,
                         "history": restore(tmp / f"short_{dev}")[0][
                             "history"]}
        check(runs["cuda"]["launches"] == N_SHORT,
              f"short run: {runs['cuda']['launches']} ε launches for "
              f"{N_SHORT} steps")
        check(runs["cpu"]["launches"] == 0, "the CPU run launched ε")
        check(all(p.device.type == "cuda"
                  for p in leaves(runs["cuda"]["params"])),
              "the card's trained params left the card")
        ce = {d: [float(x) for x in r["history"]["ce"]]
              for d, r in runs.items()}
        ce_gap = max(abs(a - b) for a, b in zip(ce["cuda"], ce["cpu"]))
        param_gap = max(float((a.cpu() - b).abs().max()) for a, b in zip(
            leaves(runs["cuda"]["params"]), leaves(runs["cpu"]["params"])))
        check(ce_gap <= TRAIN_CE_ATOL, f"short run: ce gap {ce_gap}")
        check(param_gap <= TRAIN_PARAM_ATOL,
              f"short run: param gap {param_gap}")
        emit({"train_short": "trained_detector(steps=N_SHORT), card and CPU",
              "steps": N_SHORT, "eps_launches": runs["cuda"]["launches"],
              "ce_card": ce["cuda"], "ce_cpu": ce["cpu"],
              "max_ce_gap": ce_gap, "ce_atol": TRAIN_CE_ATOL,
              "max_param_gap": param_gap, "param_atol": TRAIN_PARAM_ATOL,
              "wall_s_card": runs["cuda"]["wall_s"],
              "wall_s_cpu": runs["cpu"]["wall_s"]})
        out["profile"] = train_profile()
        out["syncs"] = train_host_syncs()

        grng.grng_eps.launches = 0
        steps = detector.TRAIN_STEPS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, cfg = detector.trained_detector(ckpt_dir=tmp / "full")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = grng.grng_eps.launches
        check(launches == steps, f"full run: {launches} ε launches for "
              f"{steps} steps")
        tree, step = restore(tmp / "full")
        again, _ = detector.trained_detector(ckpt_dir=tmp / "full")
        check(grng.grng_eps.launches == steps, "the restore retrained")
        check(step == steps and all(
            a.device.type == "cuda" and a.dtype == b.dtype
            and torch.equal(a, b) for a, b in zip(leaves(params),
                                                  leaves(again))),
              "the restored params differ from the trained ones")
        hist = {k: [float(x) for x in v] for k, v in tree["history"].items()}
        check(all(math.isfinite(x) for x in hist["ce"]),
              "non-finite training ce")
        tail = slice(steps - 100, steps)
        last_ce = sum(hist["ce"][tail]) / 100
        last_acc = sum(hist["acc"][tail]) / 100
        check(last_ce < hist["ce"][0], f"training did not lower ce: "
              f"{hist['ce'][0]} -> {last_ce}")
        emit({"train_full": "trained_detector() on the card (1600 steps, "
                            "batch 64, snow, severity <= 0.5)",
              "steps": steps, "eps_launches": launches, "wall_s": wall,
              "ms_per_step_wall": wall / steps * 1e3,
              "ce_first": hist["ce"][0], "acc_first": hist["acc"][0],
              "ce_final": hist["ce"][-1], "acc_final": hist["acc"][-1],
              "ce_last100_mean": last_ce, "acc_last100_mean": last_acc,
              "kl_final": hist["kl"][-1],
              "ce_every_400": hist["ce"][::400],
              "acc_every_400": hist["acc"][::400],
              "restored_bit_equal": True})
    out.update(params=params, cfg=cfg, short_launches=N_SHORT,
               full_launches=launches, full_wall_s=wall)
    return out


def train_profile() -> dict:
    """PROFILE_STEPS training steps of ``train_detector`` on the card
    under ``torch.profiler`` (host data making included, as the loop
    runs it): wall per step, device busy and idle share, kernels per
    step, the ε kernel's device time a launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.profile_serve import _union_us
    from repro_torch.mission import detector
    from repro_torch.models.sar_cnn import SarCnnConfig
    cfg = SarCnnConfig()
    detector.train_detector(cfg, steps=3, device="cuda")          # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        detector.train_detector(cfg, steps=PROFILE_STEPS, device="cuda")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    check(kernels, "the profiler recorded no device kernels")
    busy = _union_us((e.time_range.start, e.time_range.end)
                     for e in kernels)
    eps = [e.time_range.elapsed_us() for e in kernels
           if "grng_eps" in e.name]
    check(len(eps) == PROFILE_STEPS,
          f"profile: {len(eps)} ε kernels in {PROFILE_STEPS} steps")
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"steps": PROFILE_STEPS, "wall_ms_per_step": wall_us / 1e3
           / PROFILE_STEPS, "device_busy_ms_per_step": busy / 1e3
           / PROFILE_STEPS, "device_idle_share": 1 - busy / wall_us,
           "kernels_per_step": len(kernels) / PROFILE_STEPS,
           "eps_kernel_us_per_launch": sum(eps) / len(eps),
           "top_kernels_us": {k[:60]: v for k, v in top}}
    emit({"train_profile": "train_detector under torch.profiler "
                           "(includes init and host batch making)", **out})
    return out


def train_host_syncs() -> dict:
    """The training loop's host syncs: ``train_detector`` for 5 and for
    10 steps under ``torch.cuda.set_sync_debug_mode("warn")``, counting
    the synchronizing calls it reports (after a warm-up run, whose first
    calls sync once more).  Both runs make their params and log (step 0)
    alike, so the difference over the 5 extra steps is the syncs a step
    makes, which must not be above 0.  The lines that synced are
    listed."""
    import warnings
    import torch
    from repro_torch.mission import detector
    from repro_torch.models.sar_cnn import SarCnnConfig
    detector.train_detector(SarCnnConfig(), steps=2, device="cuda")
    counts, where = {}, set()
    for steps in (5, 10):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                detector.train_detector(SarCnnConfig(), steps=steps,
                                        device="cuda")
            finally:
                torch.cuda.set_sync_debug_mode(0)
        synced = [w for w in caught if "synchroniz" in str(w.message)]
        counts[steps] = len(synced)
        where |= {f"{Path(w.filename).name}:{w.lineno}" for w in synced}
    per_step = (counts[10] - counts[5]) / 5
    out = {"syncs_5_steps": counts[5], "syncs_10_steps": counts[10],
           "syncs_per_step": per_step, "synced_at": sorted(where)}
    emit({"train_host_syncs": "torch.cuda.set_sync_debug_mode('warn') "
                              "over train_detector", **out})
    check(per_step <= 0, f"the training loop syncs {per_step} times a "
          f"step ({counts})")
    return out


def samples_histogram(out: dict) -> dict:
    hist: dict = {}
    for v in out["verdicts"]:
        hist[v["n_samples"]] = hist.get(v["n_samples"], 0) + 1
    return {str(k): hist[k] for k in sorted(hist)}


def run_trained_serving(params) -> dict:
    """``serve_sar(params=trained)`` on the ideal die and on the gate
    die under POLICY and under ESC_POLICY: 192 requests on the card
    (counts zeroed before, read after), 64 on the card against 64 on the
    CPU from the same trained params (the same decisions request for
    request).  Under POLICY, over the two dies, some requests must be
    ACCEPTed and some must go past r_min samples."""
    from repro_torch.kernels.cim import cim_mvm
    from repro_torch.kernels.decision import decision_stats
    from repro_torch.launch.serve import serve_sar
    from repro_torch.serving import TriagePolicy
    from repro_torch.serving.triage import ACCEPT
    die = gate_die()
    out = {}
    for die_name, chip in (("ideal", None), ("gate_die", die)):
        for pol_name, pol in (("main", POLICY), ("escalating", ESC_POLICY)):
            kw = dict(STREAM, policy=TriagePolicy(**pol), params=params,
                      chip_instance=chip)
            serve_sar(n_requests=32, device="cuda", **kw)        # warm-up
            decision_stats.launches = cim_mvm.launches = 0
            run = serve_sar(n_requests=192, device="cuda", **kw)
            launches = decision_stats.launches
            check(run["decisions"] == 192 and launches
                  == run["rounds_launched"] > 0,
                  f"trained {die_name}/{pol_name}: {run['decisions']} "
                  f"decisions, {launches} decision launches")
            check(cim_mvm.launches == (3 * run["admissions"] if chip
                                       else 0),
                  f"trained {die_name}: CIM launches {cim_mvm.launches}")
            if chip is None:
                card = serve_sar(n_requests=64, device="cuda", **kw)
                cpu = serve_sar(n_requests=64, device="cpu", **kw)
                same_decisions(card, cpu, f"trained {die_name}/{pol_name}: "
                               "card vs CPU")
                vs_cpu = {"requests": 64, "atol": TOL["atol"]}
            else:
                vs_cpu = chip_card_vs_cpu(kw, die)
            accepted = sum(v["verdict"] == ACCEPT for v in run["verdicts"])
            deep = sum(v["n_samples"] > pol["r_min"] for v in run["verdicts"])
            out[(die_name, pol_name)] = (accepted, deep)
            emit({"trained_serving": die_name, "policy": pol,
                  "requests": run["requests"], "wall_s": run["wall_s"],
                  "decisions_per_s_wall": run["decisions"] / run["wall_s"],
                  "mean_samples_per_decision":
                      run["mean_samples_per_decision"],
                  "samples_histogram": samples_histogram(run),
                  "flag_fraction": run["flag_fraction"],
                  "accepted": accepted, "past_r_min": deep,
                  "host_syncs_per_decision": run["host_syncs_per_decision"],
                  "decision_kernel_launches": launches,
                  "cim_kernel_launches": cim_mvm.launches,
                  "card_vs_cpu": vs_cpu})
    accepted = sum(out[(d, "main")][0] for d in ("ideal", "gate_die"))
    deep = sum(out[(d, "main")][1] for d in ("ideal", "gate_die"))
    check(accepted > 0 and deep > 0,
          f"trained detector under {POLICY}: {accepted} accepted and "
          f"{deep} past r_min over both dies (the untrained regime)")
    return out


def run_trained_uq(params) -> dict:
    """Fig. 16's three rows for the trained detector over 16 clean and
    16 snow batches (severity 1.0), R = 20: CNN (the µ head, R = 1),
    BNN-ideal (``logit_samples_ideal``) and this work (the
    ``cim_execution`` trunk, rank16 and paper heads: one head launch per
    batch and mode); accuracy, AURC, AECE, AMCE."""
    import dataclasses
    import torch
    from repro_torch.core.uncertainty import uq_report
    from repro_torch.kernels import bayes
    from repro_torch.models import sar_cnn
    cfg = sar_cnn.SarCnnConfig()
    batches = uq_batches("cuda", corruption="snow")
    cnn_params = {"convs": params["convs"],
                  "head": {"w": params["head"]["mu"],
                           "b": torch.zeros_like(params["head"]["mu"][0])}}
    cnn_cfg = dataclasses.replace(cfg, bayesian_head=False)
    clt_cfg = dataclasses.replace(cfg, cim_execution=True)
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = {"cnn": lambda im: sar_cnn.logit_samples_serve(
                cnn_params, im, cnn_cfg, 1),
            "bnn_ideal": lambda im: sar_cnn.logit_samples_ideal(
                params, im, cfg, UQ_R, gen),
            "this_rank16": lambda im: sar_cnn.logit_samples_serve(
                params, im, clt_cfg, UQ_R, mode="rank16"),
            "this_paper": lambda im: sar_cnn.logit_samples_serve(
                params, im, clt_cfg, UQ_R, mode="paper")}
    n_batches = sum(len(v) for v in batches.values())
    torch.cuda.synchronize()
    bayes.bayes_rank16.launches = bayes.bayes_paper.launches = 0
    t0 = time.perf_counter()
    reports = {}
    for row, fn in rows.items():
        reports[row] = {}
        for cond, items in batches.items():
            s = torch.cat([fn(images) for images, _ in items], dim=1)
            r = 1 if row == "cnn" else UQ_R
            check(tuple(s.shape) == (r, 64 * UQ_BATCHES, 2)
                  and bool(torch.isfinite(s).all()),
                  f"trained UQ {row} {cond}: samples {tuple(s.shape)}")
            labels = torch.cat([lab for _, lab in items])
            reports[row][cond] = {k: float(v) for k, v in
                                  uq_report(s, labels).items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"bayes_rank16": bayes.bayes_rank16.launches,
              "bayes_paper": bayes.bayes_paper.launches}
    check(counts["bayes_rank16"] == counts["bayes_paper"] == n_batches,
          f"trained UQ: head launches {counts} != {n_batches} a mode")
    check(reports["cnn"]["clean"]["accuracy"] > 0.7,
          f"trained CNN row at chance on clean batches: "
          f"{reports['cnn']['clean']}")
    emit({"trained_uq": "Fig. 16 rows of the trained detector",
          "images": 64 * UQ_BATCHES, "conditions": list(batches),
          "R": UQ_R, "wall_s": wall, "launches": counts,
          "rows": reports})
    return {"launches": counts, "reports": reports}


# ----------------------------------------------------------------------
# the closed-loop mission
# ----------------------------------------------------------------------
def mission_configs(spec: dict):
    from repro_torch.mission import UavConfig, WorldConfig
    return WorldConfig(**spec["world"]), UavConfig(**spec["uav"])


def mission_die():
    """The die of mission_bench's severity-2.5 arm."""
    from repro_torch.hw import VariationSpec, sample_instances
    return sample_instances(MISSION_DIE["seed"], 1, VariationSpec().scaled(
        MISSION_DIE["severity"]))[0]


def mission_step_counts(pol) -> tuple[int, int]:
    """(decision launches, trunk sweeps) a mission step makes: the
    schedule's rounds (⌈R/64⌉ launches each) and, with the orbit, two
    more looks at one fixed-R round each; deterministic mode decides on
    the µ head alone."""
    from repro_torch.kernels.decision import MAX_SAMPLES
    from repro_torch.serving import escalation_schedule
    if not pol.bayesian:
        return 0, 1
    tri = pol.triage
    sched = (escalation_schedule(tri) if pol.mode == "bayes_adaptive"
             else (tri.r_max,))
    launches = sum(-(-r // MAX_SAMPLES) for r in sched)
    if pol.flag_action == "orbit":
        return launches + 2 * -(-tri.r_max // MAX_SAMPLES), 3
    return launches, 1


def unsynced_episode(params, pol, spec: dict, chip) -> dict:
    """``fly_mission``'s path for one die group, on the card, with its
    step loop under ``torch.cuda.set_sync_debug_mode("error")``: any
    synchronizing call inside the loop raises.  The deployment and the
    operating-point calibration before it, and the one pull after it,
    run outside.  -> the pulled {fleet, maps, logs}."""
    import torch
    from repro_torch.mission import rollout, uav, world
    from repro_torch.models.sar_cnn import SarCnnConfig
    wcfg, ucfg = mission_configs(spec)
    cfg, dev, e = SarCnnConfig(), torch.device("cuda"), spec["episodes"]
    fn, head, bias, _ = rollout.group_episode(
        wcfg, ucfg, pol, params, cfg, chip, True,
        rollout.sar_mission_cost(cfg), True, spec["steps"])
    state = (world.stack_worlds(wcfg, e, device=dev),
             uav.init_fleet(ucfg, wcfg.grid, e, device=dev),
             {k: torch.as_tensor(v, device=dev) for k, v in
              rollout.init_maps(wcfg, e, cfg.n_classes).items()},
             uav.fleet_bindings(ucfg, wcfg.grid, e, device=dev))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn(params, head, bias, *state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return rollout._pull(dict(zip(("fleet", "maps", "logs"), out)))


def mission_looks(spec: dict, cells) -> tuple[list, float]:
    """The looks a mission featurized, rendered by each device: at step
    t, looks 3t, 3t+1 and 3t+2 of the cells ``cells[t]`` (the orbit's
    looks are featurized on every lane).  -> ([{device: images}], the
    largest gap between the card's and the CPU's pixels)."""
    import torch
    from repro_torch.mission import world
    wcfg, _ = mission_configs(spec)
    devs = ("cuda", "cpu")
    worlds = {d: world.stack_worlds(wcfg, spec["episodes"], device=d)
              for d in devs}
    d_per_ep = len(cells[0]) // spec["episodes"]
    wid = torch.arange(spec["episodes"]).repeat_interleave(d_per_ep)
    batches, gap = [], 0.0
    for t, row in enumerate(cells):
        for j in range(3):
            looks = {d: world.observe_cells(
                wcfg, worlds[d], wid.to(d), torch.as_tensor(row, device=d),
                3 * t + j) for d in devs}
            gap = max(gap, float((looks["cuda"].cpu() - looks["cpu"])
                                 .abs().max()))
            batches.append(looks)
    return batches, gap


def mission_operands(params, chip) -> dict:
    """The decision and CIM kernels' operands on one step of
    ``fly_mission`` (bayes_adaptive with the orbit) at MISSION_BENCH's
    scale on ``chip``, on the card: each wrapper call, as
    ``kernels.ops`` makes it, recorded (cloned; an accumulating call's
    ``out`` statistics left out, so it replays as its delta form) and
    passed on.  One
    rendered batch of E·D lanes: the schedule's rounds (R = 4, 8, 8)
    and the orbit's two full-R rounds, with their activation basis,
    selections, stream indices and masks; on a die, each trunk layer's
    quantized im2col for the operating-point calibration's 256 patches,
    then for the step's three looks.
    -> {"decision": [args], "cim": [operands]}."""
    from repro_torch.kernels import ops
    from repro_torch.mission import MissionPolicy, fly_mission
    wcfg, ucfg = mission_configs(MISSION_BENCH)
    calls = {"decision": [], "cim": []}
    real = {"decision": ops.decision_stats, "cim": ops.cim_mvm}

    def cloned(v):
        return v.clone() if hasattr(v, "clone") else v

    def recorder(kind, names):
        def call(*args, **kw):
            calls[kind].append({**{k: cloned(v) for k, v in
                                   zip(names, args)},
                                **{k: cloned(v) for k, v in kw.items()
                                   if k != "out"}})
            return real[kind](*args, **kw)
        return call

    ops.decision_stats = recorder("decision",
                                  ("y_mu", "x_sigma", "m", "sel", "cfg"))
    ops.cim_mvm = recorder("cim", ("x", "w", "fs", "qcfg", "col_gain",
                                   "col_offset"))
    try:
        fly_mission(wcfg, ucfg, MissionPolicy(), params=params, chips=chip,
                    n_steps=1, n_episodes=MISSION_BENCH["episodes"],
                    device="cuda")
    finally:
        ops.decision_stats, ops.cim_mvm = real["decision"], real["cim"]
    calls["cim"] = [dict(x=c["x"], w=c["w"], fs=c["fs"], qcfg=c["qcfg"],
                         gain=c["col_gain"], offset=c["col_offset"])
                    for c in calls["cim"]]
    return calls


def run_mission_kernel_checks(params) -> dict:
    """Each kernel against its plain version on the mission's own
    operands (``mission_operands``) on the ideal die and on the mission
    die: every decision round as the step made it, and again with every
    lane active; on the die, every trunk layer of the calibration pass
    and of the step's first look, with run_cim_checks' bounds.  ->
    {"decision_max_abs_err", "cim": summary}."""
    import torch
    out = {"decision_max_abs_err": 0.0,
           "cim": {"max_abs_err": 0.0, "max_abs_err_no_flip": 0.0,
                   "adc_code_flips": 0, "outputs": 0}}
    rounds = {}
    for die_name, chip in (("ideal", None), ("die", mission_die())):
        calls = mission_operands(params, chip)
        rs = [int(a["sel"].shape[0]) for a in calls["decision"]]
        check(rs == [4, 8, 8, 20, 20], f"mission {die_name}: decision "
              f"rounds {rs}, expected the schedule's 4, 8, 8 and the "
              f"orbit's 20, 20")
        rounds[die_name] = rs
        for i, args in enumerate(calls["decision"]):
            b, n = args["y_mu"].shape
            for lanes, mask in (("step", args["mask"]),
                                ("all", torch.ones_like(args["mask"]))):
                spec = dict(b=b, n=n, r=rs[i],
                            read_sigma=args["cfg"].read_sigma,
                            lanes=lanes, active=int(mask.sum()))
                err = decision_check(f"mission_{die_name}_round{i}_r{rs[i]}",
                                     dict(args, mask=mask), spec)
                out["decision_max_abs_err"] = max(
                    out["decision_max_abs_err"], err)
        want = 0 if chip is None else 12
        check(len(calls["cim"]) == want, f"mission {die_name}: "
              f"{len(calls['cim'])} CIM calls in one step, expected {want}")
        for i, c in enumerate(calls["cim"][:6]):
            what = "calibration" if i < 3 else "look0"
            cim_check(f"mission_{die_name}_{what}_trunk{i % 3}", c,
                      c["qcfg"], out["cim"])
    emit({"mission_kernel_checks": "the decision and CIM kernels on one "
                                   "mission step's operands (MISSION_BENCH "
                                   "scale), against their plain versions",
          "rounds": rounds, "decision_max_abs_err":
              out["decision_max_abs_err"], "cim": out["cim"]})
    return out


def same_mission_logs(a: dict, b: dict, what: str, atol: float) -> float:
    """Logs equal lane for lane (confidence within ``atol``, the ledger
    within rtol 1e-5); returns the largest confidence gap."""
    import numpy as np
    for k in MISSION_INT_LOGS:
        check(np.array_equal(a[k], b[k]), f"{what}: log {k} differs: "
              f"{np.argwhere(a[k] != b[k])[:5].tolist()}")
    gap = float(np.abs(a["confidence"] - b["confidence"]).max())
    check(gap <= atol, f"{what}: confidence differs by {gap} > {atol}")
    for k in ("energy_J", "time_s", "e_decision_J"):
        check(np.allclose(a[k], b[k], rtol=1e-5, atol=0),
              f"{what}: log {k} differs")
    return gap


def run_mission_card_vs_cpu(params) -> dict:
    """MISSION_SMALL (the reference's test size) in bayes_adaptive mode
    on the ideal die and on the mission die, on the card and on the CPU
    from the same trained params: the same logs lane for lane
    (confidence within TOL's atol, or CIM_CPU_ATOL where the trunk
    flipped an ADC code between the two, counted), one host sync per
    die group, the launch counts of the path (zeroed before, read
    after), and the step loop under the sync debug mode."""
    import torch
    from repro_torch.kernels.cim import cim_mvm
    from repro_torch.kernels.decision import decision_stats
    from repro_torch.mission import MissionPolicy, fly_mission
    from repro_torch.serving.engine import _to_device
    wcfg, ucfg = mission_configs(MISSION_SMALL)
    pol = MissionPolicy()
    kw = dict(n_steps=MISSION_SMALL["steps"],
              n_episodes=MISSION_SMALL["episodes"])
    cpu_params = _to_device(params, "cpu")
    out = {}
    for die_name, chip in (("ideal", None), ("die", mission_die())):
        torch.cuda.synchronize()
        decision_stats.launches = cim_mvm.launches = 0
        card = fly_mission(wcfg, ucfg, pol, params=params, chips=chip,
                           device="cuda", **kw)
        launches = (decision_stats.launches, cim_mvm.launches)
        cpu = fly_mission(wcfg, ucfg, pol, params=cpu_params, chips=chip,
                          device="cpu", **kw)
        check(card.host_syncs == cpu.host_syncs == 1,
              f"mission {die_name}: host syncs {card.host_syncs} / "
              f"{cpu.host_syncs}, expected 1 (one die group)")
        per_step, sweeps = mission_step_counts(pol)
        steps = MISSION_SMALL["steps"]
        check(launches[0] == per_step * steps,
              f"mission {die_name}: {launches[0]} decision launches, "
              f"expected {per_step} x {steps}")
        want_cim = 0 if chip is None else 3 * (sweeps * steps + 1)
        check(launches[1] == want_cim, f"mission {die_name}: "
              f"{launches[1]} CIM launches, expected {want_cim}")
        looks, render_gap = mission_looks(MISSION_SMALL, card.logs["cell"])
        check(render_gap <= TOL["atol"], f"mission {die_name}: the card's "
              f"and the CPU's renders differ by {render_gap}")
        flips = outputs = same_input = 0
        if chip is not None:
            flips, outputs, same_input = trunk_code_flips(looks, chip,
                                                          params)
        atol = CIM_CPU_ATOL if flips else TOL["atol"]
        gap = same_mission_logs(card.logs, cpu.logs,
                                f"mission {die_name}: card vs CPU "
                                f"({flips} trunk outputs off by an ADC "
                                f"code)", atol)
        unsynced = unsynced_episode(params, pol, MISSION_SMALL, chip)
        same_mission_logs(unsynced["logs"], card.logs,
                          f"mission {die_name}: the sync-checked loop vs "
                          f"fly_mission", TOL["atol"])
        logs = card.logs
        out[die_name] = {
            "decision_kernel_launches": launches[0],
            "cim_kernel_launches": launches[1],
            "host_syncs": card.host_syncs, "render_max_abs_gap":
                render_gap, "trunk_outputs": outputs,
            "trunk_code_flips": flips,
            "trunk_code_flips_same_input": same_input, "atol": atol,
            "max_confidence_gap": gap,
            "lane_steps": int(logs["active"].size),
            "inactive_lane_steps": int((~logs["active"]).sum()),
            "detections": int((logs["active"]
                               & (logs["prediction"] == 1)).sum()),
            "orbits": int(logs["orbited"].sum()),
            "verifications": int(logs["verify"].sum()),
            "summary_card": card.summary}
    emit({"mission_card_vs_cpu": "fly_mission(bayes_adaptive) at the "
                                 "reference's test size, card and CPU",
          "world": MISSION_SMALL["world"], "uav": MISSION_SMALL["uav"],
          "steps": MISSION_SMALL["steps"], "die": MISSION_DIE,
          "step_loop_sync_debug_mode": "error (no sync raised)", **out})
    return out


def run_mission_matrix(params) -> dict:
    """mission_bench's default scale (MISSION_BENCH) in its three modes
    on the ideal die and on the mission die, on the card: each run's
    mission metrics, energy split, host syncs, wall time and launch
    counts (zeroed before, read after; asserted against the steps, the
    rounds a step and, on the die, the trunk sweeps a step plus the
    operating-point calibration's one), then the bench's comparison per
    die (reported, not asserted: the detector and the worlds are the
    port's own draws)."""
    import torch
    from repro_torch.kernels.cim import cim_mvm
    from repro_torch.kernels.decision import decision_stats
    from repro_torch.mission import MissionPolicy, fly_mission
    wcfg, ucfg = mission_configs(MISSION_BENCH)
    steps, episodes = MISSION_BENCH["steps"], MISSION_BENCH["episodes"]
    results, launches = {}, {"decision": 0, "cim": 0}
    for die_name, chip in (("ideal", None), ("die", mission_die())):
        fly_mission(wcfg, ucfg, MissionPolicy(), params=params, chips=chip,
                    n_steps=2, n_episodes=episodes, device="cuda")  # warm
        for mode in MISSION_MODES:
            pol = MissionPolicy(mode=mode)
            torch.cuda.synchronize()
            decision_stats.launches = cim_mvm.launches = 0
            t0 = time.perf_counter()
            res = fly_mission(wcfg, ucfg, pol, params=params, chips=chip,
                              n_steps=steps, n_episodes=episodes,
                              device="cuda")
            wall = time.perf_counter() - t0
            n_dec, n_cim = decision_stats.launches, cim_mvm.launches
            per_step, sweeps = mission_step_counts(pol)
            check(res.host_syncs == 1, f"mission {die_name}/{mode}: "
                  f"{res.host_syncs} host syncs for one die group")
            check(n_dec == per_step * steps, f"mission {die_name}/{mode}: "
                  f"{n_dec} decision launches, expected {per_step} x "
                  f"{steps}")
            want_cim = 0 if chip is None else 3 * (sweeps * steps + 1)
            check(n_cim == want_cim, f"mission {die_name}/{mode}: {n_cim} "
                  f"CIM launches, expected {want_cim}")
            launches["decision"] += n_dec
            launches["cim"] += n_cim
            s = res.summary
            check(all(math.isfinite(v) for v in s.values()
                      if isinstance(v, float)),
                  f"mission {die_name}/{mode}: non-finite summary")
            results[(die_name, mode)] = s
            emit({"mission_matrix": f"{die_name}/{mode}",
                  "rescued_of_victims": f"{s['rescued']}/{s['victims']}",
                  **{k: s[k] for k in (
                      "rescued", "victims", "rescue_delay_s",
                      "time_to_first_detection_s", "time_to_first_rescue_s",
                      "coverage", "false_verification_rate",
                      "missed_victim_rate", "mean_samples_per_decision",
                      "decisions", "detections", "verifications",
                      "false_verifications", "orbits", "energy_total_J",
                      "energy_decision_J", "energy_verify_J",
                      "energy_orbit_J", "energy_flight_J")},
                  "host_syncs": res.host_syncs, "wall_s": wall,
                  "wall_ms_per_step": wall / steps * 1e3,
                  "decision_kernel_launches": n_dec,
                  "cim_kernel_launches": n_cim})
    claims = {}
    for die_name in ("ideal", "die"):
        det = results[(die_name, "deterministic")]
        ada = results[(die_name, "bayes_adaptive")]
        fix = results[(die_name, "bayes_fixed")]
        claims[die_name] = {
            "fvr_deterministic": det["false_verification_rate"],
            "fvr_adaptive": ada["false_verification_rate"],
            "fvr_strictly_lower": ada["false_verification_rate"]
            < det["false_verification_rate"],
            "rescue_delay_deterministic_s": det["rescue_delay_s"],
            "rescue_delay_adaptive_s": ada["rescue_delay_s"],
            "rescue_delay_no_worse": ada["rescue_delay_s"]
            <= det["rescue_delay_s"],
            "samples_saving_vs_fixed": fix["mean_samples_per_decision"]
            / max(ada["mean_samples_per_decision"], 1e-9)}
    emit({"mission_comparison": "mission_bench's claims, reported, not "
                                "asserted", "world": MISSION_BENCH["world"],
          "uav": MISSION_BENCH["uav"], "steps": steps,
          "episodes": episodes, "die": MISSION_DIE, **claims})
    return {"launches": launches, "results": results}


def mission_orbit_cost(params) -> dict:
    """What running the orbit every step costs (the reference skips it
    under ``lax.cond`` when nothing is flagged; here its two looks and
    two decision rounds always run): wall a step of bayes_adaptive at
    MISSION_BENCH's scale with flag_action 'orbit' against 'skip', in
    turns (orbit, skip, skip, orbit) on each die.  Every op of a step
    runs whatever the data, so the difference is the orbit's."""
    import torch
    from repro_torch.mission import MissionPolicy, fly_mission
    wcfg, ucfg = mission_configs(MISSION_BENCH)
    steps, episodes = MISSION_BENCH["steps"], MISSION_BENCH["episodes"]
    out = {}
    for die_name, chip in (("ideal", None), ("die", mission_die())):
        walls = {"orbit": [], "skip": []}
        for action in ("orbit", "skip", "skip", "orbit"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fly_mission(wcfg, ucfg, MissionPolicy(flag_action=action),
                        params=params, chips=chip, n_steps=steps,
                        n_episodes=episodes, device="cuda")
            walls[action].append((time.perf_counter() - t0) / steps * 1e3)
        out[die_name] = {
            "wall_ms_per_step_orbit": walls["orbit"],
            "wall_ms_per_step_skip": walls["skip"],
            "orbit_ms_per_step": (sum(walls["orbit"]) - sum(walls["skip"]))
            / 2}
    emit({"mission_orbit_cost": "bayes_adaptive, flag_action orbit vs "
                                "skip, in turns (deployment included)",
          **out})
    return out


def mission_profile(params) -> dict:
    """One bayes_adaptive mission at MISSION_BENCH's scale under
    ``torch.profiler`` on each die, device activity only (the host's
    ~2,000 ops a step would cost minutes to post-process): wall per
    step, device busy and idle share, kernels per step, each
    hand-written kernel's µs a launch and the busiest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.profile_serve import _union_us
    from repro_torch.mission import MissionPolicy, fly_mission
    wcfg, ucfg = mission_configs(MISSION_BENCH)
    steps, episodes = MISSION_BENCH["steps"], MISSION_BENCH["episodes"]
    out = {}
    for die_name, chip in (("ideal", None), ("die", mission_die())):
        fly_mission(wcfg, ucfg, MissionPolicy(), params=params, chips=chip,
                    n_steps=2, n_episodes=episodes, device="cuda")  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fly_mission(wcfg, ucfg, MissionPolicy(), params=params,
                        chips=chip, n_steps=steps, n_episodes=episodes,
                        device="cuda")
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        check(kernels, "the profiler recorded no device kernels")
        busy = _union_us((e.time_range.start, e.time_range.end)
                         for e in kernels)
        by_name: dict = {}
        for e in kernels:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
        ours = {}
        for tag in ("decision_stats", "cim_mvm"):
            us = [u for n, v in by_name.items() if tag in n for u in v]
            ours[tag] = {"launches": len(us),
                         "us_per_launch": sum(us) / len(us) if us else None,
                         "share_of_busy": sum(us) / busy}
        top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]
        out[die_name] = {
            "steps": steps, "wall_ms_per_step": wall_us / 1e3 / steps,
            "device_busy_ms_per_step": busy / 1e3 / steps,
            "device_idle_share": 1 - busy / wall_us,
            "kernels_per_step": len(kernels) / steps,
            "kernels": ours,
            "top_kernels_us": {k[:60]: sum(v) for k, v in top}}
    emit({"mission_profile": "fly_mission(bayes_adaptive) at "
                             "mission_bench's scale under torch.profiler "
                             "(deployment and calibration included)",
          **out})
    return out


# ----------------------------------------------------------------------
# telemetry, drift and the die's lifetime
# ----------------------------------------------------------------------
TELEMETRY_COUNTERS = ("rounds", "dispatches", "samples", "decisions",
                      "verdicts", "r_hist")
TELEMETRY_HISTS = ("conf_hist", "ent_hist", "mi_hist")
LIFETIME = dict(age_days=30.0, requests=96, epochs=4, slots=16)
LIFETIME_SMALL = dict(requests=32, slots=8, epochs=2)
STATIC_EVAL = dict(seed=7, step0=700, batch=96, fog=0.3, r=20)
MISSION_AGE_DAYS = 90.0


def device_kernels(fn) -> int:
    """Device kernels ``fn`` launches, counted by ``torch.profiler``
    (device activity only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def same_telemetry(a: dict, b: dict, what: str, rtol: float = 1e-5) -> dict:
    """Counters and ``r_hist`` equal, the GRNG moments within ``rtol``;
    -> the quality histograms' bins that differ (reported: a confidence
    within a float step of a bin edge may land on either side)."""
    for key in TELEMETRY_COUNTERS:
        check(a[key] == b[key], f"{what}: telemetry {key} differs: "
              f"{a[key]} vs {b[key]}")
    for key in ("n", "sum", "sumsq"):
        x, y = a["grng"][key], b["grng"][key]
        check(abs(x - y) <= rtol * abs(y), f"{what}: GRNG {key} {x} vs {y}")
    return {k: sum(abs(x - y) for x, y in zip(a[k], b[k]))
            for k in TELEMETRY_HISTS}


def run_telemetry_path() -> dict:
    """The main path with telemetry on (the reference's default) on the
    ideal die and the gate die: STREAM's 192 requests under POLICY, in
    turns with telemetry off (on, off, off, on): the same verdicts and
    host syncs; the snapshot card against a CPU run of the same 192
    requests (counters and r_hist equal, GRNG moments within 1e-5); the
    drift status; decisions/s and device kernels a dispatch, on and
    off."""
    import torch
    from repro_torch.launch.serve import serve_sar
    from repro_torch.serving import TriagePolicy
    out = {}
    for die_name, chip in (("ideal", None), ("gate_die", gate_die())):
        kw = dict(STREAM, policy=TriagePolicy(**POLICY), chip_instance=chip)
        serve_sar(n_requests=32, device="cuda", **kw)           # warm-up
        runs = {True: [], False: []}
        for tel in (True, False, False, True):
            torch.cuda.synchronize()
            runs[tel].append(serve_sar(n_requests=192, device="cuda",
                                       telemetry=tel, **kw))
        on, off = runs[True][0], runs[False][0]
        same_decisions(on, off, f"{die_name}: telemetry on vs off")
        for r in runs[True] + runs[False]:
            check(r["host_syncs"] == off["host_syncs"],
                  f"{die_name}: host syncs {r['host_syncs']} with "
                  f"telemetry {'telemetry' in r} vs {off['host_syncs']}")
        snap = on["telemetry"]
        check(snap["decisions"] == 192 and "telemetry" not in off,
              f"{die_name}: telemetry recorded {snap['decisions']} "
              f"decisions")
        check(snap["rounds"] <= on["rounds_launched"],
              f"{die_name}: {snap['rounds']} rounds recorded, "
              f"{on['rounds_launched']} launched")
        cpu = serve_sar(n_requests=192, device="cpu", **kw)
        hist_gap = same_telemetry(snap, cpu["telemetry"],
                                  f"{die_name}: card vs CPU")
        kernels = {tel: device_kernels(lambda t=tel: serve_sar(
            n_requests=192, device="cuda", telemetry=t, **kw))
            for tel in (True, False)}
        rate = {("on" if t else "off"): [r["decisions"] / r["wall_s"]
                                         for r in runs[t]]
                for t in runs}
        out[die_name] = {
            "decisions_per_s_wall": rate,
            "kernels_per_dispatch": {
                "on": kernels[True] / on["host_syncs"],
                "off": kernels[False] / off["host_syncs"]},
            "host_syncs": on["host_syncs"], "dispatches":
                snap["dispatches"], "rounds_recorded": snap["rounds"],
            "rounds_launched": on["rounds_launched"],
            "samples": snap["samples"], "r_hist": snap["r_hist"],
            "grng_probe": snap["grng"], "drift": {
                k: on["drift"][k] for k in ("drifted", "z_mean", "z_std")},
            "card_vs_cpu_hist_bins_apart": hist_gap}
        check(not on["drift"]["drifted"],
              f"{die_name}: the deployment drifted against its own "
              f"calibration: {on['drift']}")
    emit({"telemetry_path": "serve_sar with telemetry on vs off, 192 "
                            "requests (STREAM, POLICY), card vs CPU",
          **out})
    return out


def recording(targets: dict):
    """Patch module attributes to record (clone) every call's arguments
    and pass it on; an ``out=`` destination (the statistics an
    accumulating decision call adds into) is no operand and is not
    recorded, so a recorded call replays as its delta form.
    ``targets``: {kind: (module, name, arg names)}.
    A kernel wrapper patched in its own module increments its
    ``launches`` count by its module-level name, the patch while it is
    in place: the count carries over to the patch and back.  -> (calls
    {kind: [args]}, restore())."""
    calls = {kind: [] for kind in targets}
    saved = {}

    def cloned(v):
        return v.clone() if hasattr(v, "clone") else v

    for kind, (mod, name, names) in targets.items():
        real = getattr(mod, name)

        def call(*args, _kind=kind, _real=real, _names=names, **kw):
            calls[_kind].append({**{k: cloned(v) for k, v in
                                    zip(_names, args)},
                                 **{k: cloned(v) for k, v in kw.items()
                                    if k != "out"}})
            return _real(*args, **kw)

        counted = (hasattr(real, "launches")
                   and getattr(real, "__module__", None) == mod.__name__)
        if counted:
            call.launches = real.launches
        saved[kind] = (mod, name, real, call if counted else None)
        setattr(mod, name, call)

    def restore():
        for mod, name, real, counted in saved.values():
            if counted is not None:
                real.launches = counted.launches
            setattr(mod, name, real)

    return calls, restore


def rank16_check(name: str, args: dict, summary: dict) -> None:
    """The rank16 head kernel against its plain version on one recorded
    ``ops.bayes_head_mvm`` call (its selections drawn as the call draws
    them; rtol/atol 1e-4, as run_head_checks), relaunched bit for bit."""
    import torch
    from repro_torch.core.clt_grng import selections
    from repro_torch.kernels import bayes
    sample0 = args.get("sample0", 0)
    sel = selections(args["cfg"], args["num_samples"], sample0,
                     device=args["x"].device)
    pos = (args["x"], args["mu_prime"], args["sigma"], sel, args["cfg"])
    got = bayes.bayes_rank16(*pos, sample0=sample0)
    want = bayes.bayes_rank16_plain(*pos, sample0=sample0)
    again = bayes.bayes_rank16(*pos, sample0=sample0)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
          f"rank16 kernel != plain on {name} ({err})")
    check(torch.equal(got, again), f"two rank16 launches differ: {name}")
    summary["max_abs_err"] = max(summary["max_abs_err"], err)
    summary["cases"] += 1


def static_arms(params, die) -> dict:
    """lifetime_bench's static arms on the card: the die aged
    LIFETIME['age_days'] served with its birth calibration (cal0), the
    birth calibration on the aged physics (stale) and a recalibration
    at that age (healed), each R = 20 rank16 samples over SARD seed 7's
    eval batch (step 700, 96 images) clean and under fog 0.3 through the
    die's CIM trunk, accuracy and |accuracy − golden| (golden: the
    golden die's trunk and head).  Every rank16 head launch is recorded
    and held to its plain version."""
    import torch
    from repro_torch import float32_math
    from repro_torch.core.bayes_layer import sigma_of
    from repro_torch.core.sampling import (BayesHeadConfig, logit_samples,
                                           prepare_serving_head)
    from repro_torch.core.uncertainty import uq_report
    from repro_torch.data.sard import SardConfig, batch_at, corrupted_batch
    from repro_torch.hw import (aged_belief_view, golden_instance,
                                prepare_instance_head, recalibrate)
    from repro_torch.kernels import bayes, ops
    from repro_torch.models.sar_cnn import SarCnnConfig, features
    cfg, e = SarCnnConfig(), STATIC_EVAL
    base = BayesHeadConfig(num_samples=e["r"], mode="rank16", grng=cfg.grng,
                           compute_dtype=torch.float32)
    mu, sg = params["head"]["mu"], sigma_of(params["head"])
    dcfg = SardConfig(image_size=cfg.image_size, seed=e["seed"])
    clean = batch_at(dcfg, e["step0"], e["batch"])
    fog = corrupted_batch(dcfg, e["step0"], e["batch"], "fog", e["fog"])
    sets = (("clean", clean["images"]), ("fog", fog["images"]))
    labels = clean["labels"].cuda()
    age_s = LIFETIME["age_days"] * 86400.0
    aged = die.at_age(age_s)
    cal = prepare_instance_head(mu, sg, base, die)
    arms = {"cal0": cal,
            "stale": aged_belief_view(*cal, aged, cfg.grng),
            "healed": recalibrate(mu, sg, base, aged, epoch=1)}
    bayes.bayes_rank16.launches = 0
    calls, restore = recording({"rank16": (
        ops, "bayes_head_mvm", ("x", "mu_prime", "sigma", "cfg",
                                "num_samples"))})
    try:
        with float32_math():
            feats = {n: features(params, x.cuda(), cfg, chip=die)
                     for n, x in sets}
            gold_feats = {n: features(params, x.cuda(), cfg,
                                      chip=golden_instance())
                          for n, x in sets}
        gold = prepare_serving_head(mu, sg, base)
        golden = {n: float(uq_report(logit_samples(gold, f, base),
                                     labels)["accuracy"])
                  for n, f in gold_feats.items()}
        out = {"age_s": age_s, "imprint": aged.imprint, "golden": golden,
               "arms": {}}
        for arm, (head, scfg) in arms.items():
            out["arms"][arm] = {}
            for n, f in feats.items():
                acc = float(uq_report(logit_samples(head, f, scfg),
                                      labels)["accuracy"])
                out["arms"][arm][n] = {"accuracy": acc,
                                       "acc_dev": abs(acc - golden[n])}
    finally:
        restore()
    launches = bayes.bayes_rank16.launches
    check(launches == len(calls["rank16"]) == 2 + 2 * len(arms),
          f"static arms: {launches} rank16 launches")
    summary = {"max_abs_err": 0.0, "cases": 0}
    for i, args in enumerate(calls["rank16"]):
        rank16_check(f"static_arm_call{i}", args, summary)
    check(arms["stale"][1].grng.imprint > 0
          and arms["healed"][1].calib_epoch == 1,
          "static arms: the stale view is not aged or the heal not new")
    out["rank16_launches"] = launches
    out["rank16_checks"] = summary
    return out


def run_lifetime_serving(params) -> dict:
    """lifetime_bench on the card with the trained detector: the seed-11
    severity-2.5 die, 30 days over 96 requests in 4 epochs of 16 slots,
    arms healed (auto_recalibrate), stale (none) and fresh (1 s a
    request): fresh raises 0 advisories, stale ≥ 1 and heals 0 times,
    healed heals ≥ 1 time (asserted); the static arms
    (``static_arms``); card against CPU at LIFETIME_SMALL: the same
    advisories, heals and calib_epoch, verdicts equal unless the trunks
    flipped an ADC code (the differing ones counted, at most 2 of 32)."""
    import torch
    from repro_torch.hw import LifetimeConfig
    from repro_torch.kernels.cim import cim_mvm
    from repro_torch.kernels.decision import decision_stats
    from repro_torch.launch.serve import serve_sar_lifetime
    from repro_torch.serving.engine import _to_device
    die = mission_die()                # lifetime_bench's die too
    age_s = LIFETIME["age_days"] * 86400.0
    rate = age_s / LIFETIME["requests"]
    arms = {"healed": dict(age_rate=rate, auto_recalibrate=True),
            "stale": dict(age_rate=rate, auto_recalibrate=False),
            "fresh": dict(age_rate=1.0, auto_recalibrate=True)}
    out, launches = {}, {"decision": 0, "cim": 0}
    for arm, lt in arms.items():
        torch.cuda.synchronize()
        decision_stats.launches = cim_mvm.launches = 0
        res = serve_sar_lifetime(
            lifetime=LifetimeConfig(epochs=LIFETIME["epochs"], **lt),
            chip_instance=die, n_requests=LIFETIME["requests"],
            n_slots=LIFETIME["slots"], params=params, device="cuda")
        launches["decision"] += decision_stats.launches
        launches["cim"] += cim_mvm.launches
        check(decision_stats.launches == res["rounds_launched"]
              and cim_mvm.launches == 3 * res["admissions"],
              f"lifetime {arm}: launches {decision_stats.launches} / "
              f"{cim_mvm.launches}")
        lt_out = res["lifetime"]
        out[arm] = {k: lt_out[k] for k in ("age_s", "advisories", "heals",
                                           "calib_epoch", "epochs")}
        out[arm].update(
            events=[{k: ev[k] for k in ("age_s", "calib_epoch", "z_mean",
                                        "z_std", "n")}
                    for ev in lt_out["events"]],
            final_z=[lt_out["status"]["z_mean"], lt_out["status"]["z_std"]],
            host_syncs=res["host_syncs"], wall_s=res["wall_s"],
            flag_fraction=res["flag_fraction"],
            mean_samples_per_decision=res["mean_samples_per_decision"],
            alerts=[a["kind"] for a in res.get("alerts", [])],
            decision_kernel_launches=decision_stats.launches,
            cim_kernel_launches=cim_mvm.launches)
    check(out["fresh"]["advisories"] == 0 and out["fresh"]["heals"] == 0,
          f"lifetime fresh arm raised an advisory: {out['fresh']}")
    check(out["stale"]["advisories"] >= 1 and out["stale"]["heals"] == 0,
          f"lifetime stale arm: {out['stale']}")
    check(out["healed"]["heals"] >= 1 and out["healed"]["calib_epoch"] >= 1,
          f"lifetime healed arm never healed: {out['healed']}")
    static = static_arms(params, die)
    small = {}
    cpu_params = _to_device(params, "cpu")
    for dev in ("cuda", "cpu"):
        small[dev] = serve_sar_lifetime(
            lifetime=LifetimeConfig(
                age_rate=age_s / LIFETIME_SMALL["requests"],
                epochs=LIFETIME_SMALL["epochs"], auto_recalibrate=True),
            chip_instance=die, n_requests=LIFETIME_SMALL["requests"],
            n_slots=LIFETIME_SMALL["slots"],
            params=params if dev == "cuda" else cpu_params, device=dev)
    lc, lp = small["cuda"]["lifetime"], small["cpu"]["lifetime"]
    for key in ("advisories", "heals", "calib_epoch", "age_s"):
        check(lc[key] == lp[key], f"lifetime card vs CPU: {key} "
              f"{lc[key]} vs {lp[key]}")
    differ = sum(a["verdict"] != b["verdict"] for a, b in
                 zip(small["cuda"]["verdicts"], small["cpu"]["verdicts"]))
    check(differ <= 2, f"lifetime card vs CPU: {differ} verdicts differ")
    emit({"lifetime_serving": "serve_sar_lifetime, the trained detector on "
                              "the seed-11 severity-2.5 die",
          **LIFETIME, "arms": out, "static_arms": static,
          "card_vs_cpu": {**LIFETIME_SMALL, "advisories": lc["advisories"],
                          "heals": lc["heals"],
                          "calib_epoch": lc["calib_epoch"],
                          "verdicts_differ": differ}})
    return {"launches": launches, "rank16_launches":
            static["rank16_launches"], "rank16_checks":
            static["rank16_checks"]}


def run_mission_lifetime(params) -> dict:
    """mission_bench's aged arms on the card: bayes_adaptive at
    MISSION_BENCH's scale on the mission die aged MISSION_AGE_DAYS over
    the 70 steps in 4 segments, with the birth calibration (aged_stale)
    and healing on advisories (aged_healed): host_syncs == epochs, each
    segment's step loop under ``set_sync_debug_mode("error")``; the
    decision rounds of the stale arm's last segment and of the first
    segment after a heal, recorded and held to the plain version (as
    ``run_mission_kernel_checks``); the un-aged mission's wall a step
    with telemetry on and off, in turns."""
    import torch
    from repro_torch.hw import LifetimeConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels.cim import cim_mvm
    from repro_torch.kernels.decision import decision_stats
    from repro_torch.mission import MissionPolicy, fly_mission, rollout
    wcfg, ucfg = mission_configs(MISSION_BENCH)
    steps, episodes = MISSION_BENCH["steps"], MISSION_BENCH["episodes"]
    die = mission_die()
    rate = MISSION_AGE_DAYS * 86400.0 / steps
    segment = {"step0": None}
    real_episode = rollout._episode_fn

    def checked_episode(*args, **kw):
        fn = real_episode(*args, **kw)
        step0 = kw.get("step0", args[10] if len(args) > 10 else 0)

        def run(*a, **k):
            segment["step0"] = step0
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return run

    calls, restore = recording({"decision": (
        ops, "decision_stats", ("y_mu", "x_sigma", "m", "sel", "cfg"))})
    rounds: list = []            # the segment (step0) of each call
    recorder = ops.decision_stats

    def tagged(*a, **k):
        rounds.append(segment["step0"])
        return recorder(*a, **k)

    ops.decision_stats = tagged
    rollout._episode_fn = checked_episode
    seg = -(-steps // LifetimeConfig().epochs)
    out, launches = {}, {"decision": 0, "cim": 0}
    try:
        for arm, heal in (("aged_stale", False), ("aged_healed", True)):
            calls["decision"].clear()
            rounds.clear()
            torch.cuda.synchronize()
            decision_stats.launches = cim_mvm.launches = 0
            t0 = time.perf_counter()
            res = fly_mission(wcfg, ucfg, MissionPolicy(), params=params,
                              chips=die, n_steps=steps, n_episodes=episodes,
                              lifetime=LifetimeConfig(age_rate=rate,
                                                      auto_recalibrate=heal),
                              device="cuda")
            wall = time.perf_counter() - t0
            n_dec, n_cim = decision_stats.launches, cim_mvm.launches
            launches["decision"] += n_dec
            launches["cim"] += n_cim
            (group, lt), = res.lifetime.items()
            check(res.host_syncs == lt["epochs"] == 4,
                  f"{arm}: {res.host_syncs} host syncs for {lt['epochs']} "
                  f"epochs")
            # every step's rounds; three trunk sweeps a step, plus one
            # operating-point calibration at birth and after each heal
            per_step, sweeps = mission_step_counts(MissionPolicy())
            check(n_dec == per_step * steps and n_cim == 3 * (
                sweeps * steps + 1 + lt["heals"]),
                f"{arm}: {n_dec} decision and {n_cim} CIM launches")
            if heal:
                check(lt["heals"] >= 1, f"{arm}: never healed: {lt}")
            else:
                check(lt["heals"] == 0, f"{arm}: healed: {lt}")
            # the kernel on this arm's own rounds: the stale arm's last
            # segment, the healed arm's first segment after a heal (made
            # after the segment that raised the advisory)
            seg0 = (max(rounds) if not heal else
                    round(lt["events"][0]["age_s"] / rate) + seg)
            picked = [c for c, s in zip(calls["decision"], rounds)
                      if s == seg0][:5]
            check(len(picked) == 5 and all(
                c["cfg"].imprint > 0 for c in picked),
                f"{arm}: no aged decision rounds recorded at step {seg0}")
            errs = []
            for i, args in enumerate(picked):
                b, n = args["y_mu"].shape
                for lanes, mask in (("step", args["mask"]),
                                    ("all", torch.ones_like(args["mask"]))):
                    errs.append(decision_check(
                        f"mission_{arm}_step{seg0}_round{i}",
                        dict(args, mask=mask),
                        dict(b=b, n=n, r=int(args["sel"].shape[0]),
                             read_sigma=args["cfg"].read_sigma,
                             imprint=args["cfg"].imprint, lanes=lanes)))
            s = res.summary
            out[arm] = {
                "rescued_of_victims": f"{s['rescued']}/{s['victims']}",
                **{k: s[k] for k in ("rescue_delay_s",
                                     "false_verification_rate",
                                     "mean_samples_per_decision", "orbits")},
                **{k: lt[k] for k in ("age_s", "advisories", "heals",
                                      "calib_epoch")},
                "drift": {k: res.telemetry[group]["drift"][k]
                          for k in ("drifted", "z_mean", "z_std")},
                "host_syncs": res.host_syncs, "wall_s": wall,
                "wall_ms_per_step": wall / steps * 1e3,
                "decision_kernel_launches": n_dec,
                "cim_kernel_launches": n_cim,
                "checked_segment_step0": seg0,
                "decision_max_abs_err": max(errs)}
    finally:
        restore()
        rollout._episode_fn = real_episode
    walls = {True: [], False: []}
    for tel in (True, False, False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fly_mission(wcfg, ucfg, MissionPolicy(), params=params,
                          chips=die, n_steps=steps, n_episodes=episodes,
                          telemetry=tel, device="cuda")
        walls[tel].append((time.perf_counter() - t0) / steps * 1e3)
        check(res.host_syncs == 1, f"mission telemetry={tel}: "
              f"{res.host_syncs} host syncs for one die group")
    emit({"mission_lifetime": "fly_mission(bayes_adaptive) on the mission "
                              "die aged over the mission, MISSION_BENCH "
                              "scale",
          "age_days": MISSION_AGE_DAYS, "age_rate_s_per_step": rate,
          **out, "telemetry_wall_ms_per_step": {
              "on": walls[True], "off": walls[False]}})
    return {"launches": launches, "decision_max_abs_err": max(
        out[a]["decision_max_abs_err"] for a in out)}


# ----------------------------------------------------------------------
# observability: time to verdict, stage profiles, traces, metric exports
# ----------------------------------------------------------------------
SLO_SPECS = ("0.25:p99", "0.05:p50")
OBS_MISSION_STEPS = 8          # the mission CLI's depth in this phase
# instruments on (True) and off in five pairs, the starting side
# alternated, so that a drift over the sequence shows apart from the
# instruments' own cost
OBS_ORDER = (True, False, False, True, True, False, False, True, True,
             False)
OBS_STAGES = ("admission", "featurize", "dispatch", "triage_loop",
              "retirement")


def exact_quantiles(values, qs=(50, 95, 99)) -> dict:
    """{p50_s, p95_s, p99_s} of raw per-request times (numpy's linear
    interpolation), beside the histogram's."""
    import numpy as np
    v = np.asarray(values, np.float64)
    return {f"p{q}_s": float(np.percentile(v, q)) for q in qs}


def hist_quantiles(h: dict, qs=(0.5, 0.95, 0.99)) -> dict:
    """{p50_s, p95_s, p99_s} of an SLO snapshot's histogram."""
    from repro_torch.obs.registry import quantile
    return {f"p{round(q * 100)}_s": quantile(h, q) for q in qs}


def parse_prom(text: str) -> dict:
    """The sample lines of a Prometheus text exposition: {series: value};
    raises on a line that is not ``name{labels} value``."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        key, val = line.rsplit(" ", 1)
        check(re.fullmatch(r"[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})?", key)
              is not None, f"not a Prometheus series: {line!r}")
        out[key] = float(val)
    return out


def trace_kernels(path: str) -> dict:
    """{kernel name: launches} of a torch.profiler Chrome trace."""
    doc = json.loads(Path(path).read_text())
    names: dict = {}
    for e in doc["traceEvents"]:
        if e.get("cat") == "kernel":
            names[e["name"]] = names.get(e["name"], 0) + 1
    return names


def serve_instrumented(on: bool, die, **kw) -> tuple[dict, dict]:
    """``serve_sar`` at the serving shape with the tracer, the stage
    profiler and the SLO tracker all on or all off; the decision and CIM
    launch counts zeroed just before and read just after."""
    from repro_torch.kernels.cim import cim_mvm
    from repro_torch.kernels.decision import decision_stats
    from repro_torch.launch.serve import serve_sar
    from repro_torch.obs.trace import Tracer
    from repro_torch.serving import TriagePolicy
    tracer = Tracer("chip_smoke") if on else None
    cim_mvm.launches = decision_stats.launches = 0
    out = serve_sar(n_requests=192, policy=TriagePolicy(**POLICY),
                    device="cuda", chip_instance=die, tracer=tracer,
                    profiler=on, slo=SLO_SPECS if on else False,
                    **dict(STREAM, **kw))
    launches = {"decision": decision_stats.launches, "cim": cim_mvm.launches}
    check(out["requests"] == 192, f"{out['requests']} of 192 retired")
    check(("slo" in out) == on and ("stage_profile" in out) == on,
          f"instruments {'on' if on else 'off'}: summary keys wrong")
    if on:
        spans = [e for e in tracer.to_chrome()["traceEvents"]
                 if e.get("ph") == "X"]
        check(sum(e["name"].startswith("req ") for e in spans) == 192,
              "the tracer missed request spans")
        check(sum(e["name"] == "sar_rounds" for e in spans)
              == out["host_syncs"], "sar_rounds spans != dispatches")
    return out, launches


def run_observability() -> dict:
    """The observability phase at PERF.md §4's serving shape, on the
    ideal die and the gate die: instruments on and off in five pairs
    that alternate their starting side (verdicts, samples and host
    syncs identical, asserted; each pair's rate ratio); time to
    verdict, queue wait and service (p50/p95/p99) and the stage
    profile's medians, closed loop; time to verdict open loop at half
    the closed loop's rate; the cost records against the launch counts (asserted); the
    serve CLI with --profile/--metrics-out/--trace/--slo (the profiler
    trace names the kernels' CUDA symbols; the exports parse); the
    mission CLI with --trace/--metrics-out/--profile at the reference's
    test size on the gate die, its step loop under
    ``set_sync_debug_mode("error")``."""
    import tempfile
    import torch
    from repro_torch.kernels.cim import cim_mvm
    from repro_torch.kernels.decision import decision_stats
    from repro_torch.launch import mission as mission_cli
    from repro_torch.launch import serve as serve_cli
    from repro_torch.mission import rollout
    card = card_line()
    result = {"launches": {}}
    for die_name, die in (("ideal", None), ("gate_die", gate_die())):
        serve_instrumented(True, die)                        # warm-up
        runs = [serve_instrumented(on, die) for on in OBS_ORDER]
        first = runs[0][0]
        for out, launches in runs[1:]:
            same_decisions(first, out, f"{die_name}: instruments on/off")
            check(out["host_syncs"] == first["host_syncs"],
                  f"{die_name}: host syncs differ on/off")
            check(launches == runs[0][1], f"{die_name}: launches differ "
                  f"on/off: {launches} vs {runs[0][1]}")
        on = [r[0] for r in runs if "slo" in r[0]]
        rate = {k: [r[0]["decisions"] / r[0]["wall_s"] for r in runs
                    if ("slo" in r[0]) == (k == "on")]
                for k in ("on", "off")}
        # each pair's on/off ratio: a drift over the sequence cancels
        # across pairs that start on either side
        pair_ratio = [a / b for a, b in zip(rate["on"], rate["off"])]
        snap, prof_snap = on[-1]["slo"], on[-1]["stage_profile"]
        # the cost records against this path's own launch counts; the
        # allocator's peak over this one run
        torch.cuda.reset_peak_memory_stats()
        out, launches = serve_instrumented(True, die, cost_records=True)
        costs = out["compiled_costs"]
        dec = sum(c["launches_per_dispatch"] for c in costs
                  if c["kernel"] == "decision_stats")
        cim = sum(c["launches_per_admission"] for c in costs
                  if c["kernel"] == "cim_mvm")
        check(dec * out["host_syncs"] == launches["decision"]
              == out["rounds_launched"],
              f"{die_name}: cost records give {dec} decision launches a "
              f"dispatch x {out['host_syncs']}, counted "
              f"{launches['decision']}")
        check(cim * out["admissions"] == launches["cim"],
              f"{die_name}: cost records give {cim} CIM launches an "
              f"admission x {out['admissions']}, counted {launches['cim']}")
        check(out.get("max_memory_allocated", 0) > 0,
              "the run lacks the card's peak memory")
        # open loop at half the closed loop's rate
        closed = round(statistics.median(rate["on"]))
        offered = max(1, round(0.5 * closed))
        from repro_torch.launch.serve import serve_sar
        from repro_torch.serving import TriagePolicy
        cim_mvm.launches = decision_stats.launches = 0
        ol = serve_sar(n_requests=192, policy=TriagePolicy(**POLICY),
                       device="cuda", chip_instance=die,
                       arrival=f"poisson:{offered}", **STREAM)
        ol_launches = {"decision": decision_stats.launches,
                       "cim": cim_mvm.launches}
        check(ol["requests"] == 192 and ol["offered"]["submitted"] == 192,
              f"{die_name}: the open loop did not serve 192 requests")
        result["launches"][die_name] = {
            "instruments": [r[1] for r in runs], "cost_records": launches,
            "open_loop": ol_launches}
        emit({"observability": die_name, "card": card,
              "what": "serve_sar at PERF.md section 4's serving shape, "
                      "192 requests at t = 0 (closed loop); time to "
                      "verdict = arrival -> the host pull that brought "
                      "the verdict; time_to_verdict, queue_wait, service "
                      "and stage_median_ms: quantiles of the log-spaced "
                      "histograms (4 buckets a decade, interpolated "
                      "inside a bucket); *_exact and latency_exact "
                      "(arrival -> retirement): numpy percentiles of the "
                      "raw per-request times",
              "instruments_on_off": " ".join(
                  "on" if o else "off" for o in OBS_ORDER)
              + ": verdicts, samples, host syncs and launches identical",
              "decisions_per_s_on": rate["on"],
              "decisions_per_s_off": rate["off"],
              "decisions_per_s_median": {
                  k: statistics.median(v) for k, v in rate.items()},
              "on_over_off_by_pair": pair_ratio,
              "on_over_off_median": statistics.median(pair_ratio),
              "host_syncs": first["host_syncs"],
              "wall_s": on[-1]["wall_s"],
              "time_to_verdict": {k: snap[k] for k in (
                  "p50_s", "p95_s", "p99_s", "mean_s", "span_s",
                  "queue_wait_share")},
              "time_to_verdict_exact": exact_quantiles(
                  on[-1]["time_to_verdict_s"]),
              "latency_exact": {k: on[-1][f"{k[:3]}_latency_s"]
                                for k in ("p50_s", "p95_s", "p99_s")},
              "queue_wait": hist_quantiles(snap["queue_wait"]),
              "service": hist_quantiles(snap["service"]),
              "slos": [{k: s[k] for k in ("name", "attainment",
                                          "burn_rate", "breach")}
                       for s in snap["slos"]],
              "stage_median_ms": {st: prof_snap[st]["p50_s"] * 1e3
                                  for st in OBS_STAGES},
              "stage_mean_ms": {st: prof_snap[st]["mean_s"] * 1e3
                                for st in OBS_STAGES},
              "stage_count": {st: prof_snap[st]["count"]
                              for st in OBS_STAGES},
              "open_loop": {"arrival": f"poisson:{offered}",
                            "closed_loop_decisions_per_s": closed,
                            "offered_rps": ol["offered"]["offered_rps"],
                            "decisions_per_s": ol["decisions"]
                            / ol["wall_s"],
                            "host_syncs": ol["host_syncs"],
                            "time_to_verdict_exact": exact_quantiles(
                                ol["time_to_verdict_s"]),
                            **{k: ol["slo"][k] for k in (
                                "p50_s", "p95_s", "p99_s", "mean_s",
                                "queue_wait_share")}},
              "cost_records": costs,
              "max_memory_allocated": out["max_memory_allocated"]})

    # the serve CLI on the gate die with every flag; the profiler trace
    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as tmp:
        tmp = Path(tmp)
        cim_mvm.launches = decision_stats.launches = 0
        out = serve_cli.main([
            "--arch", "sar_cnn", "--device", "cuda", "--requests", "192",
            "--corrupt-frac", "0.25", "--conf-threshold", "0.7",
            "--mi-threshold", "0.05", "--chip-instance", "11",
            "--chip-severity", "2.0", "--slo", SLO_SPECS[0], "--slo",
            SLO_SPECS[1], "--trace", str(tmp / "serve_trace.json"),
            "--metrics-out", str(tmp / "metrics" / "serve"),
            "--profile", str(tmp / "prof")])
        cli_launches = {"decision": decision_stats.launches,
                        "cim": cim_mvm.launches}
        kernels = trace_kernels(out["profile_trace"])
        dec_k = sum(n for k, n in kernels.items()
                    if "decision_stats_small_n_kernel" in k)
        cim_k = sum(n for k, n in kernels.items() if "cim_mvm_kernel" in k)
        check(dec_k == cli_launches["decision"] > 0,
              f"profiler trace: {dec_k} decision kernels, launched "
              f"{cli_launches['decision']}")
        check(cim_k == cli_launches["cim"] > 0,
              f"profiler trace: {cim_k} CIM kernels, launched "
              f"{cli_launches['cim']}")
        prom = parse_prom((tmp / "metrics" / "serve.prom").read_text())
        doc = json.loads((tmp / "metrics" / "serve.json").read_text())
        check(prom['repro_slo_requests_total{job="serving",arch="sar_cnn"}']
              == 192, "the .prom lacks the SLO request count")
        check(any(k.startswith("repro_compiled_bound_ms") for k in prom),
              "the .prom lacks the cost records")
        check(any(m["name"] == "repro_stage_total"
                  for m in doc["metrics"]), "the JSON lacks the stages")
        serve_trace = json.loads((tmp / "serve_trace.json").read_text())
        check(sum(e["ph"] == "X" and e["name"].startswith("req ")
                  for e in serve_trace["traceEvents"]) == 192,
              "the CLI's trace lacks request spans")
        result["launches"]["serve_cli"] = cli_launches
        serve_line = {"cli": "repro_torch.launch.serve", "card": card,
                      "profile_trace_mb": Path(out["profile_trace"])
                      .stat().st_size / 2**20,
                      "trace_kernel_symbols": sorted(
                          k[:90] for k in kernels
                          if "decision_stats" in k or "cim_mvm" in k),
                      "trace_kernels": sum(kernels.values()),
                      "launches": cli_launches,
                      "prom_series": len(prom),
                      "json_metrics": len(doc["metrics"]),
                      "time_to_verdict_profiled": {
                          k: out["slo"][k] for k in ("p50_s", "p99_s")}}

        # the mission CLI, its step loop under the sync debug mode
        real_episode = rollout._episode_fn

        def unsynced(*args, **kw):
            fn = real_episode(*args, **kw)

            def run(*a, **k):
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return fn(*a, **k)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            return run

        here = Path.cwd()
        rollout._episode_fn = unsynced
        cim_mvm.launches = decision_stats.launches = 0
        try:
            os.chdir(tmp)              # the detector's cache lands here
            w, u = MISSION_SMALL["world"], MISSION_SMALL["uav"]
            s = mission_cli.main([
                "--device", "cuda", "--train-steps", "3",
                "--grid", str(w["grid"]), "--victims", str(w["n_victims"]),
                "--seed", str(w["seed"]), "--drones", str(u["n_drones"]),
                "--battery-uJ", str(u["battery_J"] * 1e6),
                "--steps", str(OBS_MISSION_STEPS),
                "--chip-instance", str(MISSION_DIE["seed"]),
                "--chip-severity", str(MISSION_DIE["severity"]),
                "--trace", str(tmp / "mission_trace.json"),
                "--metrics-out", str(tmp / "metrics" / "mission"),
                "--profile", str(tmp / "mprof")])
        finally:
            os.chdir(here)
            rollout._episode_fn = real_episode
        m_launches = {"decision": decision_stats.launches,
                      "cim": cim_mvm.launches}
        mtrace = json.loads((tmp / "mission_trace.json").read_text())
        mspans = [e for e in mtrace["traceEvents"] if e["ph"] == "X"]
        check(len(mspans) > 0, "the mission trace has no span")
        mprom = parse_prom((tmp / "metrics" / "mission.prom").read_text())
        json.loads((tmp / "metrics" / "mission.json").read_text())
        mfiles = sorted((tmp / "mprof").glob("trace-*.json"))
        check(len(mfiles) == 1, f"mission profile traces: {mfiles}")
        mk = trace_kernels(str(mfiles[0]))
        check(sum(n for k, n in mk.items() if "decision_stats" in k)
              == m_launches["decision"] > 0
              and sum(n for k, n in mk.items() if "cim_mvm_kernel" in k)
              == m_launches["cim"] > 0,
              f"mission profile: kernels {m_launches} not all in the trace")
        result["launches"]["mission_cli"] = m_launches
        emit({"observability": "cli", "serve": serve_line,
              "mission": {"cli": "repro_torch.launch.mission",
                          "step_loop_sync_debug_mode":
                              "error (no sync raised)",
                          "decisions": s["decisions"],
                          "trace_spans": len(mspans),
                          "prom_series": len(mprom),
                          "launches": m_launches,
                          "profile_trace_mb": mfiles[0].stat().st_size
                          / 2**20}})
    return result


def observed_launches(result: dict) -> dict:
    """{kernel: launches} over every run of the observability phase."""
    total = {"decision": 0, "cim": 0}

    def add(counts):
        if isinstance(counts, list):
            for c in counts:
                add(c)
        elif "decision" in counts:
            for k in total:
                total[k] += counts[k]
        else:
            for c in counts.values():
                add(c)

    add(result["launches"])
    check(total["decision"] > 0 and total["cim"] > 0,
          f"the observability phase launched {total}")
    return total


# ----------------------------------------------------------------------
# a die population; the GRNG's granularities; the moment mode; the
# host-tiled hoist
# ----------------------------------------------------------------------
# benchmarks/hw_variation.py:79,84: its population of dies
POPULATION = dict(seed=2026, n=16, severity=2.5)
POP_REQUESTS = 96
POP_SERVED = 2                 # loaded dies served against their originals
CALIB_STEPS = 16               # measured constants, card vs CPU (float32 steps)
CALIB_RESID_ATOL = 1e-6        # residual offsets, card vs CPU
GRAN_BLOCK = dict(k=256, n=256, r=8)        # Fig. 9's block
GRAN_EPS_ATOL = 1e-6           # ε at tile/cell, card vs CPU
MOMENT_DRAWS = 2048
# mamba2-130m's head (src/repro/configs/mamba2_130m.py:11-13)
LM_HEAD = dict(b=8, k=768, n=50280, r=20, tile_n=4096)


def same_dies(a, b, what: str) -> None:
    import numpy as np
    ta, tb = a.to_tree(), b.to_tree()
    check(set(ta) == set(tb), f"{what}: different fields")
    for k in ta:
        check(ta[k].dtype == tb[k].dtype and np.array_equal(ta[k], tb[k]),
              f"{what}: field {k} differs: {ta[k]} vs {tb[k]}")


def run_die_population() -> dict:
    """hw_variation's population shipped (save, load), calibrated on
    the card against the CPU, two loaded dies served against their
    originals, and the SAR layers cut onto tiles and put back."""
    import tempfile
    import torch
    from repro_torch.core.clt_grng import GRNGConfig
    from repro_torch.hw import (VariationSpec, calibration_report,
                                compile_network, load_instances,
                                sample_instances, save_instances,
                                shard_column_partition)
    from repro_torch.kernels.cim import cim_mvm
    from repro_torch.kernels.decision import decision_stats
    from repro_torch.launch.serve import sar_layer_shapes, serve_sar
    from repro_torch.serving import TriagePolicy
    dies = sample_instances(POPULATION["seed"], POPULATION["n"],
                            VariationSpec().scaled(POPULATION["severity"]))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        save_instances(tmp, dies)
        loaded = load_instances(tmp)
        ship_s = time.perf_counter() - t0
    check(len(loaded) == len(dies), f"loaded {len(loaded)} dies")
    for a, b in zip(dies, loaded):
        same_dies(a, b, f"die {a.chip_id} after save/load")

    base = GRNGConfig()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = [calibration_report(d, base, device="cuda") for d in loaded]
    calib_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = [calibration_report(d, base, device="cpu") for d in loaded]
    calib_cpu_s = time.perf_counter() - t0
    steps, resid = 0, 0.0
    for c, h in zip(card, cpu):
        check((c.energy_J, c.time_s, c.n_samples) ==
              (h.energy_J, h.time_s, h.n_samples),
              f"die {c.chip_id}: cost differs card vs CPU")
        steps = max(steps, float_ulps(c.measured_sum_mean,
                                      h.measured_sum_mean),
                    float_ulps(c.measured_sum_std, h.measured_sum_std))
        resid = max(resid, abs(c.residual_eps_cal - h.residual_eps_cal),
                    abs(c.residual_eps_uncal - h.residual_eps_uncal))
        check(c.residual_eps_cal < 0.2 * c.residual_eps_uncal,
              f"die {c.chip_id}: calibrated residual "
              f"{c.residual_eps_cal} not under 0.2 x {c.residual_eps_uncal}")
    check(steps <= CALIB_STEPS,
          f"measured constants {steps} float32 steps apart card vs CPU")
    check(resid <= CALIB_RESID_ATOL, f"residuals differ by {resid}")

    policy = TriagePolicy(**POLICY)
    kw = dict(STREAM, policy=policy, device="cuda")
    launches = {"decision": 0, "cim": 0}
    served = []
    for before, after in zip(dies[:POP_SERVED], loaded[:POP_SERVED]):
        want = serve_sar(n_requests=POP_REQUESTS, chip_instance=before, **kw)
        cim_mvm.launches = decision_stats.launches = 0
        got = serve_sar(n_requests=POP_REQUESTS, chip_instance=after, **kw)
        check(got["decisions"] == POP_REQUESTS,
              f"die {after.chip_id}: {got['decisions']} decisions")
        check(cim_mvm.launches == 3 * got["admissions"] > 0
              and decision_stats.launches == got["rounds_launched"] > 0,
              f"die {after.chip_id}: launches {cim_mvm.launches} CIM, "
              f"{decision_stats.launches} decision")
        launches["cim"] += cim_mvm.launches
        launches["decision"] += decision_stats.launches
        same_decisions(got, want, f"loaded die {after.chip_id} vs before "
                       f"saving", atol=0.0)
        served.append({"chip_id": after.chip_id, "wall_s": got["wall_s"],
                       "decisions_per_s_wall":
                           got["decisions"] / got["wall_s"],
                       "flag_fraction": got["flag_fraction"],
                       "mean_samples_per_decision":
                           got["mean_samples_per_decision"],
                       "cim_launches": cim_mvm.launches,
                       "decision_launches": decision_stats.launches})

    cfg, params = sar_params("cuda")
    layers = sar_layer_shapes(cfg)
    prog = compile_network(layers)
    mats = [c["w"].permute(2, 3, 1, 0).reshape(-1, c["w"].shape[0])
            for c in params["convs"]]
    mats.append(params["head"]["mu"])
    names = [name for name, _ in prog.layers]
    blocks = 0
    for name, w in zip(names, mats):
        shards = prog.shard_weights(name, w)
        back = prog.reconstruct(name, shards)
        check(all(b.device == w.device for b in shards.values())
              and torch.equal(back, w),
              f"{name}: shard_weights/reconstruct is not exact on the card")
        blocks += len(shards)
    sharded = compile_network(layers, n_shards=2)
    card_name, _, power = card_line().partition(",")
    out = {"die_population": "hw_variation's population (seed "
           f"{POPULATION['seed']}, {POPULATION['n']} dies, severity "
           f"{POPULATION['severity']}): save/load, calibration_report card "
           "vs CPU, loaded dies served, SAR layers on tiles",
           "gpu": card_name.strip(), "power_limit": power.strip(),
           "ship_s": ship_s, "dies_equal_after_load": True,
           "calibration_card_s": calib_s, "calibration_cpu_s": calib_cpu_s,
           "calibration_constants_max_float32_steps": steps,
           "calibration_constants_step_bound": CALIB_STEPS,
           "residual_max_abs_diff": resid,
           "residual_atol": CALIB_RESID_ATOL,
           "residual_eps_uncal": [c.residual_eps_uncal for c in card],
           "residual_eps_cal": [c.residual_eps_cal for c in card],
           "measured_sum_std": [c.measured_sum_std for c in card],
           "energy_J": card[0].energy_J, "time_s": card[0].time_s,
           "served": served, "verdicts_equal_before_after": True,
           "launches": launches,
           "tile_blocks_round_tripped": blocks,
           "tile_report": prog.report(),
           "shard_column_partition_2": {
               name: {str(s): cols for s, cols in
                      shard_column_partition(sharded, name).items()}
               for name in names}}
    emit(out)
    return {"launches": launches}


def run_granularity() -> dict:
    """Fig. 9's block at 'tile' and 'cell' on the ideal and the gate
    die, card against CPU; ε's moments beside the layer granularity's;
    the reachable patterns; paper-mode samples at tile/cell at the UQ
    path's head shape (plain on the card by the config's route: no head
    kernel launch), with 'layer' still launching the paper kernel."""
    import dataclasses
    import torch
    from repro_torch.core import clt_grng as g
    from repro_torch.core import lfsr
    from repro_torch.core.sampling import (BayesHeadConfig, logit_samples,
                                           prepare_serving_head)
    from repro_torch.kernels import bayes
    k, n, r = GRAN_BLOCK["k"], GRAN_BLOCK["n"], GRAN_BLOCK["r"]
    dies = {"ideal": g.GRNGConfig(), "gate_die": gate_die().grng(
        g.GRNGConfig())}
    rows, worst = {}, 0.0
    for die, base in dies.items():
        layer = g.eps(base, k, n, r, device="cuda")
        rows[die] = {"layer": {"mean": float(layer.mean()),
                               "std": float(layer.std())}}
        for gran in ("tile", "cell"):
            cfg = dataclasses.replace(base, granularity=gran)
            sel = g.block_selections(cfg, k, n, r, device="cuda")
            check(torch.equal(sel.cpu(), g.block_selections(
                cfg, k, n, r, device="cpu")),
                f"{die} {gran}: selections differ card vs CPU")
            e = g.eps(cfg, k, n, r, device="cuda")
            err = float((e.cpu() - g.eps(cfg, k, n, r, device="cpu"))
                        .abs().max())
            check(err <= GRAN_EPS_ATOL, f"{die} {gran}: ε differs by {err}")
            worst = max(worst, err)
            rows[die][gran] = {"mean": float(e.mean()),
                               "std": float(e.std())}
    count, freq = lfsr.enumerate_reachable(device="cuda")
    count_cpu, freq_cpu = lfsr.enumerate_reachable(device="cpu")
    check(count == count_cpu and torch.equal(freq.cpu(), freq_cpu),
          "enumerate_reachable differs card vs CPU")

    b, kk, nn = SAR_HEAD["b"], SAR_HEAD["k"], SAR_HEAD["n"]
    c = head_inputs(b, kk, nn)
    paper = {}
    for gran in ("layer", "tile", "cell"):
        hcfg = BayesHeadConfig(num_samples=UQ_R, mode="paper",
                               grng=dataclasses.replace(c["cfg"],
                                                        granularity=gran),
                               compute_dtype=torch.float32)
        head = prepare_serving_head(c["mu"], c["sigma"], hcfg)
        bayes.bayes_paper.launches = bayes.bayes_rank16.launches = 0
        got = logit_samples(head, c["x"], hcfg)
        torch.cuda.synchronize()
        launched = bayes.bayes_paper.launches + bayes.bayes_rank16.launches
        check(launched == (1 if gran == "layer" else 0),
              f"paper at {gran}: {launched} head kernel launches")
        head_cpu = {key: v.cpu() for key, v in head.items()}
        want = logit_samples(head_cpu, c["x"].cpu(), hcfg)
        err = float((got.cpu() - want).abs().max())
        tol = 1e-4 if gran == "layer" else 1e-5     # kernel vs plain: 1e-4
        check(torch.allclose(got.cpu(), want, rtol=tol, atol=tol),
              f"paper at {gran}: card vs CPU differ by {err}")
        paper[gran] = {"max_abs_err": err, "head_kernel_launches": launched,
                       "shape": list(got.shape)}
    card_name, _, power = card_line().partition(",")
    emit({"granularity": "Fig. 9's block (256x256, R=8) at tile/cell, "
          "card vs CPU; paper-mode logit_samples at the UQ path's head "
          "(B=64 K=64 N=2 R=20)",
          "gpu": card_name.strip(), "power_limit": power.strip(),
          "selections_equal": True, "eps_max_abs_err": worst,
          "eps_atol": GRAN_EPS_ATOL, "eps_moments": rows,
          "reachable_patterns": count,
          "selection_frequency_range": [float(freq.min()),
                                        float(freq.max())],
          "paper_logit_samples": paper,
          "paper_tol": "rtol/atol 1e-5 at tile/cell (plain on both); 1e-4 "
                       "at layer (the paper kernel against its plain "
                       "version, as the head checks)"})
    return paper


def run_moment() -> dict:
    """kernel_bench's head in moment mode: logit_moments card vs CPU,
    and MOMENT_DRAWS samples' empirical moments against the analytic
    ones on the card."""
    import torch
    from repro_torch.core.sampling import (BayesHeadConfig, logit_moments,
                                           logit_samples,
                                           prepare_serving_head)
    c = head_inputs(BENCH_HEAD["b"], BENCH_HEAD["k"], BENCH_HEAD["n"])
    hcfg = BayesHeadConfig(num_samples=UQ_R, mode="moment", grng=c["cfg"],
                           compute_dtype=torch.float32)
    head = prepare_serving_head(c["mu"], c["sigma"], hcfg)
    mean, var = logit_moments(head, c["x"], hcfg)
    mean_c, var_c = logit_moments({k: v.cpu() for k, v in head.items()},
                                  c["x"].cpu(), hcfg)
    mean_err = float((mean.cpu() - mean_c).abs().max())
    var_rel = float(((var.cpu() - var_c).abs() / var_c).max())
    check(torch.allclose(mean.cpu(), mean_c, rtol=1e-4, atol=1e-5)
          and var_rel <= 1e-4,
          f"logit_moments card vs CPU: mean {mean_err}, var rel {var_rel}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = logit_samples(head, c["x"], hcfg, MOMENT_DRAWS, sample0=7)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    check(tuple(s.shape) == (MOMENT_DRAWS,) + tuple(mean.shape)
          and bool(torch.isfinite(s).all()), f"moment samples {s.shape}")
    z = (s.mean(0) - mean) / torch.sqrt(var / MOMENT_DRAWS)
    ratio = s.var(0) / var
    zmax, zmean = float(z.abs().max()), float(z.mean())
    rmax, rmean = float((ratio - 1).abs().max()), float(ratio.mean())
    check(zmax < 6.0 and abs(zmean) < 0.05,
          f"moment samples' means: max |z| {zmax}, mean z {zmean}")
    check(rmax < 0.2 and abs(rmean - 1) < 0.01,
          f"moment samples' variances: max |ratio-1| {rmax}, mean {rmean}")
    card_name, _, power = card_line().partition(",")
    out = {"moment": "kernel_bench's head (B=8 K=512 N=2048): "
           "logit_moments card vs CPU, 2048 draws against the moments",
           "gpu": card_name.strip(), "power_limit": power.strip(),
           "mean_max_abs_err": mean_err, "var_max_rel_err": var_rel,
           "moments_tol": "mean rtol 1e-4 atol 1e-5, var rtol 1e-4",
           "draws": MOMENT_DRAWS, "draw_s": draw_s,
           "mean_z_max_abs": zmax, "mean_z_mean": zmean,
           "var_ratio_max_abs_dev": rmax, "var_ratio_mean": rmean,
           "draw_tol": "max |z| < 6, mean z within 0.05; variance ratio "
                       "within 0.2 each, its mean within 0.01"}
    emit(out)
    return out


def run_tiled_hoist() -> dict:
    """mamba2-130m's head (K=768, N=50,280; B=8, R=20) hoisted dense on
    the card against in host chunks of 4,096 columns: one round's
    statistics, update_stats_streamed over the chunks against
    update_stats(mix_samples(...)) over the dense basis (rtol/atol
    1e-5), on the ideal die and the gate die's view (read noise); each
    serve timed and its allocator peak read with the head deployed."""
    import dataclasses
    import torch
    from repro_torch.core.clt_grng import GRNGConfig
    from repro_torch.core.sampling import (BayesHeadConfig, activation_basis,
                                           mix_samples, prepare_serving_head)
    from repro_torch.serving import adaptive
    b, k, n, r, tile_n = (LM_HEAD[key] for key in
                          ("b", "k", "n", "r", "tile_n"))
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((b, k), generator=gen).to("cuda")
    mu = (torch.randn((k, n), generator=gen) * 0.05).to("cuda")
    sigma = (torch.nn.functional.softplus(
        torch.randn((k, n), generator=gen) - 2.0) * 0.1).to("cuda")
    base = torch.arange(b, dtype=torch.int64, device="cuda") * r
    drawn = torch.zeros(b, dtype=torch.int32, device="cuda")
    rows = {}
    for die, grng in (("ideal", GRNGConfig()),
                      ("gate_die", gate_die().grng(GRNGConfig()))):
        hcfg = BayesHeadConfig(num_samples=r, mode="rank16", grng=grng,
                               compute_dtype=torch.float32,
                               hoist_basis=True)
        sel = adaptive.stream_selections(grng, base, drawn, r)
        idx = adaptive.stream_indices(base, drawn, r)
        row = {"read_sigma": grng.read_sigma}
        stats = {}
        for kind, tn in (("dense", 0), ("streamed", tile_n)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            head = prepare_serving_head(mu, sigma, hcfg, hoist_tile_n=tn)
            torch.cuda.synchronize()
            deploy_s = time.perf_counter() - t0
            check(("sigma_basis_host" in head) == (kind == "streamed"),
                  f"{die} {kind}: hoisted as {sorted(head)}")
            torch.cuda.empty_cache()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ab = activation_basis(head, x, hcfg)
                fresh = adaptive.init_stats(b, n, device="cuda")
                if kind == "dense":
                    st = adaptive.update_stats(
                        fresh, mix_samples(ab, sel, hcfg, sample_idx=idx))
                else:
                    st = adaptive.update_stats_streamed(
                        fresh, ab, sel, hcfg, sample_idx=idx)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                del ab
            stats[kind] = st
            row[kind] = {"deploy_s": deploy_s, "serve_s": times,
                         "resident_bytes": resident,
                         "peak_bytes": torch.cuda.max_memory_allocated(),
                         "chunks": len(head.get("sigma_basis_host", ()))}
            del head
            torch.cuda.empty_cache()
        errs = {}
        for key in ("sum_p", "sum_psq", "sum_ent", "sum_entsq"):
            got, want = stats["streamed"][key], stats["dense"][key]
            errs[key] = float((got - want).abs().max())
            check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                  f"{die}: streamed {key} differs from dense by "
                  f"{errs[key]}")
        check(torch.equal(stats["streamed"]["n"], stats["dense"]["n"]),
              f"{die}: sample counts differ")
        row["max_abs_err"] = errs
        rows[die] = row
    card_name, _, power = card_line().partition(",")
    emit({"tiled_hoist": "mamba2-130m's head (K=768, N=50280), B=8, R=20: "
          "update_stats_streamed over host chunks of 4096 columns against "
          "update_stats(mix_samples) over the dense on-device basis "
          "(rtol/atol 1e-5); serve = activation_basis + one round, 3 runs; "
          "peaks with the head deployed",
          "gpu": card_name.strip(), "power_limit": power.strip(),
          "dense_basis_bytes": k * n * 16 * 4,
          "chunk_bytes": k * tile_n * 16 * 4, **rows})
    return rows


# ----------------------------------------------------------------------
# the dense LM served at full width
# ----------------------------------------------------------------------
# qwen3-0.6b at full width (28 layers, d 1024, vocabulary 151,936 padded
# to N = 152,064), bf16, random params from seed 0 drawn on the card;
# serve(): 4 slots, prompts of 16, 4 new tokens (8 before the script
# had to make room under its time limit: every LM phase serves half the
# ticks), 8 requests (the second four admitted mid-stream).
LM = dict(arch="qwen3-0.6b", batch=4, prompt_len=16, gen_len=4,
          n_requests=8, seed=0)
LM_ACCEPT = dict(conf_threshold=0.0, mi_threshold=1e9, r_min=4, r_max=8)
LM_FIXED = dict(LM_ACCEPT, r_max=20)        # adaptive=False: R = 20
LM_DECISION_R = (1, 4, 8, 20, 64)
LM_READ_SIGMA = 0.4
# the decision kernel at vocabulary width: a sum_p entry is ~R/N, so the
# tolerance is relative (LM_RTOL) with absolute floors scaled to the
# size of a uniform distribution's entries (LM_FLOOR × R/N for sum_p,
# × R/N² for sum_psq, × R for the entropies)
LM_RTOL = 1e-4
LM_FLOOR = 1e-4
# the card against the CPU at the SMOKE config: float32 with TF32 off;
# fin within ROADMAP C6's 1e-5, its standard errors within 1e-4; bf16
# hidden states within the reference's relative 0.05
LM_FIN_ATOL = 1e-5
LM_SE_ATOL = 1e-4
LM_BF16_REL = 0.05
LM_SMOKE_ESC = dict(conf_threshold=0.0, mi_threshold=0.015, r_min=4,
                    r_max=20)
TOL_HEAD = dict(rtol=1e-4, atol=1e-4)       # as the head kernels' checks


def tensor_leaves(tree) -> list:
    """The tensors of a nested dict of params."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensor_leaves(v)]
    return [tree]


def lm_decision_atol(key: str, r: int, n: int) -> float:
    return LM_FLOOR * {"sum_p": r / n, "sum_psq": r / n**2,
                       "sum_ent": r, "sum_entsq": r}[key]


def relative_errors(name: str, got: dict, want: dict, r: int,
                    n: int) -> dict:
    """Each statistic held to its plain version at LM_RTOL with the
    absolute floors of ``lm_decision_atol``; -> the errors by key."""
    import torch
    errs = {}
    for key in STAT_KEYS:
        atol = lm_decision_atol(key, r, n)
        diff = (got[key] - want[key]).abs()
        errs[key] = {"max_abs_err": float(diff.max()),
                     "max_rel_err": float((diff / want[key].abs().clamp_min(
                         atol)).max()),
                     "atol": atol}
        check(torch.allclose(got[key], want[key], rtol=LM_RTOL, atol=atol),
              f"{name}: {key} off its plain version by "
              f"{errs[key]['max_abs_err']} (rtol {LM_RTOL}, atol {atol})")
    return errs


def lm_pieces(schedule) -> int:
    """Decision launches one token dispatch makes (rounds cut at 64)."""
    from repro_torch.kernels.decision import MAX_SAMPLES
    return sum(-(-r // MAX_SAMPLES) for r in schedule)


def lm_stage_split(out: dict) -> dict:
    """Median and mean seconds a stage of the stage profile."""
    prof = out.get("stage_profile") or {}
    return {stage: {k: v for k, v in row.items()
                    if k in ("count", "p50_s", "mean_s", "total_s")}
            for stage, row in prof.items()}


def lm_serve_run(name: str, policy, adaptive: bool, params, spec=LM,
                 cfg=None) -> dict:
    """``serve`` at full width on the card under one policy (``spec``'s
    arch and shapes; ``cfg`` overrides the arch's, as a cut depth does),
    the decision kernel's launch count zeroed just before and read just
    after, the allocator's peak reset before; admissions into a pool
    already decoding (a clock past the prompt) are counted."""
    import torch
    from repro_torch.kernels.decision import decision_stats
    from repro_torch.launch.serve import serve
    from repro_torch.serving import adaptive as adaptive_mod
    from repro_torch.serving.engine import LMServingEngine
    torch.cuda.reset_peak_memory_stats()
    deltas = []
    scatter = LMServingEngine._align_scatter

    def counted(self, new, idx, take, delta):
        deltas.append(delta)
        return scatter(self, new, idx, take, delta)
    LMServingEngine._align_scatter = counted
    decision_stats.launches = 0
    try:
        out = serve(spec["arch"], smoke=False, cfg=cfg,
                    batch=spec["batch"], prompt_len=spec["prompt_len"],
                    gen_len=spec["gen_len"], n_requests=spec["n_requests"],
                    policy=policy, adaptive=adaptive, seed=spec["seed"],
                    params=params, cost_records=True, device="cuda")
    finally:
        LMServingEngine._align_scatter = scatter
    launches = decision_stats.launches
    schedule = (adaptive_mod.escalation_schedule(policy) if adaptive
                else (policy.r_max,))
    check(out["requests"] == spec["n_requests"],
          f"lm {name}: {out['requests']} of {spec['n_requests']} requests")
    check(launches > 0, f"lm {name}: no decision kernel launched")
    check(launches == out["ticks"] * lm_pieces(schedule),
          f"lm {name}: {launches} launches for {out['ticks']} ticks of "
          f"schedule {schedule}")
    check(out["host_syncs"] == out["ticks"],
          f"lm {name}: {out['host_syncs']} host syncs, {out['ticks']} ticks")
    check(out["decisions"] == sum(v["n_tokens"] for v in out["verdicts"]),
          f"lm {name}: decisions and tokens disagree")
    tel = out["telemetry"]
    spans = out.get("stage_profile") or {}
    outside = out["wall_s"] - sum(
        spans[k]["total_s"] for k in ("admission", "dispatch",
                                      "triage_loop", "retirement")
        if k in spans)
    return {"name": name, "schedule": list(schedule),
            "policy": {k: getattr(policy, k) for k in (
                "conf_threshold", "mi_threshold", "r_min", "r_max")},
            "adaptive": adaptive, "requests": out["requests"],
            "decisions": out["decisions"], "ticks": out["ticks"],
            "admissions": out["admissions"],
            "midstream_admissions": sum(d > 0 for d in deltas),
            "mean_samples_per_decision": out["mean_samples_per_decision"],
            "host_syncs": out["host_syncs"],
            "decision_launches": launches,
            "accept_fraction": out["accept_fraction"],
            "flag_fraction": out["flag_fraction"],
            "tokens_per_s": out["tokens_per_s"], "wall_s": out["wall_s"],
            "outside_stages_s": outside,
            "rounds_run": tel["rounds"], "dispatches": tel["dispatches"],
            "r_hist": {r: c for r, c in enumerate(tel["r_hist"]) if c},
            "stage_split": lm_stage_split(out),
            "max_memory_allocated": out["max_memory_allocated"],
            "n_tokens": sorted(v["n_tokens"] for v in out["verdicts"]),
            "confidences": sorted(v["confidence"] for v in out["verdicts"]),
            "verdicts": sorted((v["rid"], v["verdict"], v["n_tokens"])
                               for v in out["verdicts"])}


def lm_engine(cfg, params, device: str, spec=LM):
    """An engine admitted once with the first ``batch`` requests of the
    stream (inside ``float32_math``, as ``run`` does)."""
    from repro_torch import float32_math
    from repro_torch.launch.serve import make_lm_engine, make_lm_stream
    eng = make_lm_engine(cfg, batch=spec["batch"],
                         prompt_len=spec["prompt_len"],
                         gen_len=spec["gen_len"], params=params,
                         device=device)
    for r in make_lm_stream(cfg, spec["batch"], batch=spec["batch"],
                            prompt_len=spec["prompt_len"],
                            gen_len=spec["gen_len"], seed=spec["seed"]):
        eng.submit(r)
    with float32_math():
        eng._admit()
    return eng


def lm_decision_args(abasis: dict, grng, base, r: int) -> dict:
    import torch
    from repro_torch.core.lfsr import indexed_selections
    from repro_torch.serving import adaptive
    b = abasis["y_mu"].shape[0]
    drawn = torch.zeros(b, dtype=torch.int32, device=base.device)
    idx = adaptive.stream_indices(base, drawn, r)
    return dict(y_mu=abasis["y_mu"].contiguous(),
                x_sigma=abasis["x_sigma"].contiguous(),
                m=abasis["m"].contiguous(),
                sel=indexed_selections(grng.lfsr_seed, idx), cfg=grng,
                x_sigsq=(abasis["x_sigsq"].contiguous()
                         if "x_sigsq" in abasis else None),
                sample_idx=idx,
                mask=torch.ones(b, dtype=torch.bool, device=base.device))


def lm_decision_check(name: str, args: dict) -> dict:
    """decision.cu against decision_stats_plain at vocabulary width, two
    launches bit for bit alike."""
    import torch
    from repro_torch.kernels.decision import (decision_stats,
                                              decision_stats_plain)
    before = decision_stats.launches
    got = decision_stats(**args)
    again = decision_stats(**args)
    want = decision_stats_plain(**args)
    torch.cuda.synchronize()
    check(decision_stats.launches == before + 2,
          f"{name}: the decision kernel did not launch")
    n, r = args["y_mu"].shape[1], args["sel"].shape[0]
    errs = relative_errors(name, got, want, r, n)
    for key in STAT_KEYS:
        check(torch.equal(got[key], again[key]),
              f"{name}: two launches differ in {key}")
    row = {"kernel_check": "decision_stats", "case": name, "B": int(
        args["y_mu"].shape[0]), "N": n, "R": r,
        "read_sigma": args["cfg"].read_sigma, "rtol": LM_RTOL,
        "errors": errs}
    emit(row)
    return row


def lm_kernel_checks(cfg, params, spec=LM, rs=LM_DECISION_R,
                     tag: str = "lm_vocab") -> dict:
    """The two kernels of the LM path at vocabulary width against their
    plain versions: decision.cu on one live token decision's operands
    (the admitted prompts' basis) at each R of ``rs``, and at R = 20
    with read_sigma = 0.4 at the same shape; bayes_mvm.cu rank16 on one
    decode_step (K d_model × N the padded vocabulary, R = uq_samples),
    the family's own (the registry's ``decode_step``/``decode_hidden``)."""
    import dataclasses
    import torch
    from repro_torch import float32_math
    from repro_torch.core.sampling import activation_basis
    from repro_torch.kernels.bayes import bayes_rank16, bayes_rank16_plain
    from repro_torch.models import transformer as tr
    from repro_torch.models.registry import get_api
    api = get_api(cfg)
    eng = lm_engine(cfg, params, "cuda", spec)
    base = torch.as_tensor(eng._next_bases(eng.n_slots).astype("int64"),
                           device="cuda")
    h32 = eng.hidden.to(torch.float32)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    abasis = eng.basis(eng.hidden)
    torch.cuda.synchronize()
    basis_s = time.perf_counter() - t0
    basis_peak = torch.cuda.max_memory_allocated() - resident
    grng = eng.hcfg.grng
    ops, rows = {}, []
    for r in rs:
        ops[f"r{r}"] = lm_decision_args(abasis, grng, base, r)
        rows.append(lm_decision_check(f"{tag}_r{r}", ops[f"r{r}"]))
    noisy = dataclasses.replace(grng, read_sigma=LM_READ_SIGMA)
    nbasis = activation_basis(eng._head, h32,
                              dataclasses.replace(eng.hcfg, grng=noisy))
    ops["noisy_r20"] = lm_decision_args(nbasis, noisy, base, 20)
    rows.append(lm_decision_check(f"{tag}_read_noise_r20",
                                  ops["noisy_r20"]))
    del nbasis
    # one decode_step: the trunk, then the head's R samples (one launch)
    token = torch.arange(eng.n_slots, device="cuda")[:, None] * 7
    pos = eng.cache["pos"]
    bayes_rank16.launches = 0
    with float32_math():
        logits, _ = api.decode_step(eng._params, eng.cache, token, cfg)
        x, _ = api.decode_hidden(eng._params, eng.cache, token, cfg)
    torch.cuda.synchronize()
    check(bayes_rank16.launches == 1,
          f"decode_step launched the rank16 kernel "
          f"{bayes_rank16.launches} times")
    check(tuple(logits.shape) == (cfg.uq_samples, eng.n_slots,
                                  cfg.vocab_padded)
          and bool(torch.isfinite(logits).all()),
          f"decode_step logits {tuple(logits.shape)} not finite")
    head = tr._head_serving(eng._params, cfg)
    from repro_torch.core.hashing import as_u32
    from repro_torch.core.lfsr import indexed_selections
    idx = as_u32(pos * cfg.uq_samples
                 + torch.arange(cfg.uq_samples, device="cuda"))
    sel = indexed_selections(grng.lfsr_seed, idx)
    got = bayes_rank16(x, head["mu_prime"], head["sigma"], sel, grng)
    want = bayes_rank16_plain(x, head["mu_prime"], head["sigma"], sel,
                              grng)
    head_err = float((got - want).abs().max())
    check(torch.allclose(got, want, **TOL_HEAD),
          f"rank16 at vocabulary width off its plain version by "
          f"{head_err}")
    check(torch.equal(got, logits), "decode_step's samples differ from "
          "the head kernel's on the same hidden state")
    del want
    emit({"kernel_check": "bayes_rank16",
          "case": f"{tag.replace('_vocab', '')}_decode_step",
          "B": eng.n_slots, "K": cfg.d_model, "N": cfg.vocab_padded,
          "R": cfg.uq_samples, "dtype": str(cfg.dtype), **TOL_HEAD,
          "max_abs_err": head_err})
    return {"rows": rows, "ops": ops, "basis_s_first": basis_s,
            "basis_peak_bytes": basis_peak, "resident_bytes": resident,
            "head_case": dict(x=x, mu=head["mu_prime"],
                              sigma=head["sigma"], sel=sel, grng=grng),
            "head_max_abs_err": head_err,
            "decision_max_abs_err": max(
                e["max_abs_err"] for row in rows
                for e in row["errors"].values()),
            "engine": eng}


def lm_tick_split(eng, reps: int = 3) -> dict:
    """Where one tick's time goes at full width: the basis, the token
    decision (the whole schedule, kernel launches included) and the
    decode, each the least of ``reps`` eager calls between CUDA events
    (host launches included), on the admitted engine."""
    import torch
    from repro_torch import float32_math
    from repro_torch.serving.engine import token_decision

    def ms(fn):
        best = float("inf")
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end))
        return best

    base = torch.as_tensor(eng._next_bases(eng.n_slots).astype("int64"),
                           device="cuda")
    active = torch.ones(eng.n_slots, dtype=torch.bool, device="cuda")
    abasis = eng.basis(eng.hidden)
    token = torch.zeros((eng.n_slots, 1), dtype=torch.int64, device="cuda")
    out = {}
    with float32_math():
        out["basis_ms"] = ms(lambda: eng.basis(eng.hidden))
        out["decision_ms"] = ms(lambda: token_decision(
            abasis, base, active, hcfg=eng.hcfg, policy=eng.policy,
            adaptive_mode=True, schedule=eng.schedule, fused=True))
        out["decode_ms"] = ms(lambda: eng.decode(eng.cache, token))
        out["prefill_ms"] = ms(lambda: eng.prefill(
            torch.zeros((eng.n_slots, eng.prompt_len), dtype=torch.int32,
                        device="cuda"),
            torch.full((eng.n_slots,), eng.prompt_len, device="cuda")))
    out["schedule"] = list(eng.schedule)
    out["what"] = ("least of 3 eager calls between CUDA events, host "
                   "launches included; decision = one token's whole "
                   "schedule under the default policy, every slot active")
    return out


def lm_card_vs_cpu() -> dict:
    """qwen3-0.6b's SMOKE config on the card and on the CPU with the
    same port params and prompts: in float32 (TF32 off) the same
    tokens, verdicts, samples and decisions request for request under
    accept-always and fixed R = 20, confidence/MI within LM_FIN_ATOL,
    and one escalating token decision's fin on the same basis within
    LM_FIN_ATOL (its _se fields LM_SE_ATOL), verdicts and samples
    equal.  Under the escalating policy (LM_SMOKE_ESC) whole runs are
    compared and reported, not asserted: its MI threshold sits inside
    the MI spread, so a standard error that differs by C6's ~1e-5 can
    move a borderline decision by a round.  In bf16: the token agreement
    and the hidden states' worst relative gap over prefill and three
    decode steps."""
    import dataclasses
    import torch
    from repro_torch import float32_math
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import params_init, serve
    from repro_torch.serving import TriagePolicy, escalation_schedule
    from repro_torch.serving.engine import _to_device, token_decision
    kw = dict(batch=LM["batch"], prompt_len=LM["prompt_len"],
              gen_len=LM["gen_len"], n_requests=LM["n_requests"],
              seed=LM["seed"])
    smoke = get_config(LM["arch"], smoke=True)
    f32 = dataclasses.replace(smoke, dtype=torch.float32)
    res = {}
    p_cpu = params_init(f32, LM["seed"], "cpu")
    p_gpu = _to_device(p_cpu, "cuda")
    for name, pol, adaptive in (("accept_always", LM_ACCEPT, True),
                                ("fixed_r20", LM_FIXED, False),
                                ("escalating", LM_SMOKE_ESC, True)):
        outs = {dev: serve(LM["arch"], cfg=f32, params=p, device=dev,
                           policy=TriagePolicy(**pol), adaptive=adaptive,
                           **kw)
                for dev, p in (("cpu", p_cpu), ("cuda", p_gpu))}
        vc = sorted(outs["cuda"]["verdicts"], key=lambda v: v["rid"])
        vp = sorted(outs["cpu"]["verdicts"], key=lambda v: v["rid"])
        keys = ("rid", "verdict", "prediction", "n_samples", "n_tokens")
        alike = sum(tuple(a[k] for k in keys) == tuple(b[k] for k in keys)
                    for a, b in zip(vc, vp))
        res[name] = {"requests": outs["cuda"]["requests"],
                     "decisions": [outs["cuda"]["decisions"],
                                   outs["cpu"]["decisions"]],
                     "requests_alike": alike,
                     "samples": [[v["n_samples"] for v in vc],
                                 [v["n_samples"] for v in vp]]}
        if name == "escalating":
            continue
        same_decisions(outs["cuda"], outs["cpu"],
                       f"lm smoke f32 {name}: card vs CPU", LM_FIN_ATOL)
        check(alike == len(vc) == LM["n_requests"]
              and outs["cuda"]["decisions"] == outs["cpu"]["decisions"],
              f"lm smoke f32 {name}: token counts differ")
    # one token decision's fin on the same basis, card against CPU
    engs = {dev: lm_engine(f32, p, dev)
            for dev, p in (("cpu", p_cpu), ("cuda", p_gpu))}
    ab = engs["cpu"].basis(engs["cpu"].hidden)
    base = torch.as_tensor(engs["cpu"]._next_bases(LM["batch"])
                           .astype("int64"))
    fins = {}
    for dev in ("cpu", "cuda"):
        e = engs[dev]
        v, fin, spent = token_decision(
            {k: t.to(dev) for k, t in ab.items()}, base.to(dev),
            torch.ones(LM["batch"], dtype=torch.bool, device=dev),
            hcfg=e.hcfg, policy=TriagePolicy(**LM_SMOKE_ESC),
            adaptive_mode=True,
            schedule=escalation_schedule(TriagePolicy(**LM_SMOKE_ESC)),
            fused=True)
        fins[dev] = (v.cpu(), {k: t.cpu() for k, t in fin.items()},
                     spent.cpu())
    check(torch.equal(fins["cpu"][0], fins["cuda"][0])
          and torch.equal(fins["cpu"][2], fins["cuda"][2]),
          "lm smoke: token decision verdicts/spent differ card vs CPU")
    fin_err = {}
    for key, want in fins["cpu"][1].items():
        got = fins["cuda"][1][key]
        err = float((got.double() - want.double()).abs().max())
        fin_err[key] = err
        tol = LM_SE_ATOL if key.endswith("_se") else LM_FIN_ATOL
        check(err <= tol, f"lm smoke fin {key}: card vs CPU {err} > {tol}")
    res["fin_max_abs_err"] = fin_err
    # bf16: token agreement, hidden gap
    from repro_torch.models import transformer as tr
    pb_cpu = params_init(smoke, LM["seed"], "cpu")
    pb_gpu = _to_device(pb_cpu, "cuda")
    outs = {dev: serve(LM["arch"], cfg=smoke, params=p, device=dev,
                       policy=TriagePolicy(**LM_ACCEPT), **kw)
            for dev, p in (("cpu", pb_cpu), ("cuda", pb_gpu))}
    vb = {v["rid"]: v for v in outs["cpu"]["verdicts"]}
    agree = sum((v["prediction"], v["verdict"], v["n_tokens"])
                == (vb[v["rid"]]["prediction"], vb[v["rid"]]["verdict"],
                    vb[v["rid"]]["n_tokens"])
                for v in outs["cuda"]["verdicts"])
    toks = torch.randint(0, smoke.vocab, (LM["batch"], LM["prompt_len"]),
                         generator=torch.Generator().manual_seed(5))
    gaps = []
    with float32_math():
        caches, hs = {}, {}
        for dev, p in (("cpu", pb_cpu), ("cuda", pb_gpu)):
            caches[dev], hs[dev] = tr.prefill(p, toks.to(dev), smoke,
                                              cache_len=32)
        for step in range(4):
            want = hs["cpu"].float()
            gaps.append(float((hs["cuda"].float().cpu() - want).abs().max()
                              / max(float(want.abs().max()), 1e-3)))
            if step == 3:
                break
            tok = toks[:, step:step + 1]
            for dev, p in (("cpu", pb_cpu), ("cuda", pb_gpu)):
                hs[dev], caches[dev] = tr.decode_hidden(
                    p, caches[dev], tok.to(dev), smoke)
    check(max(gaps) < LM_BF16_REL,
          f"lm smoke bf16: hidden gap {max(gaps)} >= {LM_BF16_REL}")
    res["bf16"] = {"requests_agreeing": agree,
                   "requests": len(outs["cuda"]["verdicts"]),
                   "hidden_rel_gap": gaps}
    emit({"lm_card_vs_cpu": f"{LM['arch']} SMOKE, card against CPU, the "
          "same port params and prompts; f32 with TF32 off: decisions "
          f"equal, fin within {LM_FIN_ATOL} (_se {LM_SE_ATOL}); bf16 "
          "token agreement and hidden gap (prefill + 3 decode steps)",
          **res})
    return res


def run_lm_serving() -> dict:
    """The lm_serving phase: qwen3-0.6b at full width served on the card
    under accept-always, fixed R = 20 and an escalating policy (its
    confidence threshold at the accept-always run's median request
    confidence); the kernels at vocabulary width; the card against the
    CPU at the SMOKE config; where a tick's time goes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import params_init, serve
    from repro_torch.serving import TriagePolicy
    t_phase = time.perf_counter()
    card_name, _, power = card_line().partition(",")
    cfg = get_config(LM["arch"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = params_init(cfg, LM["seed"], "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tensor_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    check(all(t.is_cuda for t in leaves), "params off the card")
    # warm-up: one request, one token
    serve(LM["arch"], smoke=False, batch=LM["batch"],
          prompt_len=LM["prompt_len"], gen_len=1, n_requests=1,
          params=params, device="cuda")
    runs = [lm_serve_run("accept_always", TriagePolicy(**LM_ACCEPT), True,
                         params)]
    acc = runs[0]
    check(acc["n_tokens"] == [LM["gen_len"]] * LM["n_requests"]
          and acc["accept_fraction"] == 1.0,
          f"accept-always: tokens {acc['n_tokens']}")
    check(acc["admissions"] >= 2, "accept-always: no mid-stream admission")
    runs.append(lm_serve_run("fixed_r20", TriagePolicy(**LM_FIXED), False,
                             params))
    check(runs[1]["mean_samples_per_decision"] == LM_FIXED["r_max"]
          and runs[1]["n_tokens"] == acc["n_tokens"],
          "fixed R: samples per decision or tokens")
    conf = statistics.median(acc["confidences"])
    esc = TriagePolicy(conf_threshold=conf, mi_threshold=0.5, r_min=4,
                       r_max=20)
    runs.append(lm_serve_run("escalating", esc, True, params))
    check(runs[2]["rounds_run"] > runs[2]["dispatches"],
          "escalating policy ran no round past the first")
    lm_launches = sum(r["decision_launches"] for r in runs)
    checks = lm_kernel_checks(cfg, params)
    split = lm_tick_split(checks["engine"])
    for r in runs:       # the basis does not depend on the policy
        emit({"lm_serving": r["name"], "arch": LM["arch"],
              "smoke": False, "gpu": card_name.strip(),
              "power_limit": power.strip(), "n_params": n_params,
              "param_bytes": param_bytes, "params_init_s": init_s,
              "basis_ms_a_tick": split["basis_ms"],
              **{k: v for k, v in r.items() if k != "confidences"}})
    emit({"lm_tick_split": f"{LM['arch']} full width, B={LM['batch']}, "
          f"N={cfg.vocab_padded}", "gpu": card_name.strip(),
          "power_limit": power.strip(), **split,
          "basis_peak_bytes": checks["basis_peak_bytes"],
          "resident_bytes": checks["resident_bytes"]})
    smoke = lm_card_vs_cpu()
    del checks["engine"]
    emit({"lm_serving_phase_s": time.perf_counter() - t_phase})
    return {"runs": runs, "launches": lm_launches, "checks": checks,
            "split": split, "smoke": smoke, "n_params": n_params,
            "param_bytes": param_bytes}


def lm_timing(lm: dict, tag: str = "lm", dense: bool = True) -> dict:
    """decision.cu at B 4 and the padded vocabulary, R 4 and 20, on the
    live operands and bayes_mvm.cu rank16 at decode_step's shape, by
    CUDA-graph replay (``timed``),
    with their bounds (``kernels/bounds``); lines ``timing
    decision_stats_<tag>_r<R>`` and ``bayes_rank16_<tag>_decode_step``.
    ``dense``: qwen3-0.6b's phase, which also gives the earlier design's
    times, asserts kernel < plain and adds the plan's line."""
    from repro_torch.kernels.bayes import (bayes_rank16, bayes_rank16_plain,
                                           head_plan)
    from repro_torch.kernels.bounds import head_bound
    from repro_torch.kernels.decision import (decision_plan, decision_stats,
                                              decision_stats_plain)
    out = {"decision": {}}
    for key in ("r4", "r20"):
        args = lm["checks"]["ops"][key]
        t = timed(lambda: decision_stats(**args),
                  lambda: decision_stats_plain(**args))
        w = decision_args_work(args)
        b, n = args["y_mu"].shape
        out["decision"][key] = {**t, **{k: w[k] for k in (
            "bound_ms", "bound_by", "bound_bytes", "bound_ops")},
            "plan": decision_plan(n, args["sel"].shape[0], b)._asdict()}
        prev = ({"streaming_design_ms": EARLIER_DECISION_MS[f"lm_{key}"],
                 "streaming_design_note": "the wide-N design before the "
                                          "tiled variant (PERF.md), a "
                                          "constant, not measured here"}
                if dense else {})
        emit({"timing": f"decision_stats_{tag}_{key}", "B": b, "N": n,
              **out["decision"][key], **prev})
        if dense:
            check(t["ms"] < t["plain_ms"],
                  f"decision_stats_lm_{key}: the kernel ({t['ms']} ms) is "
                  f"not faster than its plain version ({t['plain_ms']} ms)")
    if dense:
        decision_plan_line(lm["checks"]["ops"]["r20"],
                           out["decision"]["r20"])
    c = lm["checks"]["head_case"]
    t = timed(lambda: bayes_rank16(c["x"], c["mu"], c["sigma"], c["sel"],
                                   c["grng"]),
              lambda: bayes_rank16_plain(c["x"], c["mu"], c["sigma"],
                                         c["sel"], c["grng"]))
    b, k = c["x"].shape
    n, r = c["mu"].shape[1], c["sel"].shape[0]
    w = head_bound("rank16", b, k, n, r, c["grng"],
                   wbytes=c["mu"].element_size())
    out["rank16"] = {"B": b, "K": k, "N": n, "R": r,
                     "plan": head_plan("rank16", b, k, n, r)._asdict(),
                     **t, **{kk: w[kk] for kk in (
                         "bound_ms", "bound_by", "bound_bytes",
                         "bound_ops", "hash3_evals")}}
    emit({"timing": f"bayes_rank16_{tag}_decode_step", **out["rank16"]})
    return out


def decision_plan_line(args: dict, timing: dict) -> dict:
    """The tile width the tiled variant's plan takes on one live token
    decision's operands (B 4, N 152,064, R 20), the only width it takes:
    held to the plain version at LM_RTOL with lm_decision_atol's floors,
    its time by graph replay (``decision_stats_lm_r20``'s), and its three
    kernels' device times by the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.decision import (decision_plan, decision_stats,
                                              decision_stats_plain)
    b, n = args["y_mu"].shape
    r = args["sel"].shape[0]
    plan = decision_plan(n, r, b)
    errs = relative_errors(f"decision plan tile={plan.tile}",
                           decision_stats(**args),
                           decision_stats_plain(**args), r, n)
    for _ in range(3):
        decision_stats(**args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            decision_stats(**args)
        torch.cuda.synchronize()
    split = {m.group(1): e.device_time_total / e.count
             for e in prof.key_averages()
             for m in [re.search(r"decision_tiled_(\w+?)_kernel", e.key)]
             if m and e.count}
    row = {"decision_plans": f"B={b} N={n} R={r}",
           "plans": [{**plan._asdict(), "ms": timing["ms"],
                      "max_rel_err": max(e["max_rel_err"]
                                         for e in errs.values())}],
           "chosen": plan._asdict(), "chosen_is_fastest": True,
           "chosen_note": "the plan takes one tile width, 256 columns; "
                          "128 and 512 were slower at this shape "
                          "(PERF.md)",
           "kernel_us_chosen": split,
           "kernel_us_what": "device µs a launch of each of the plan's "
                             "kernels, torch.profiler over 20 eager calls",
           "rtol": LM_RTOL, "timing": "device time per call by CUDA graph "
                                      "replay"}
    emit(row)
    return row


# ----------------------------------------------------------------------
# the MoE LMs served at full width, depth cut
# ----------------------------------------------------------------------
# Every width as published; only depth is cut so that the float32 params
# (the reference's init dtype) fit the 80 GB card: mixtral-8x7b 8 of 32
# layers (5.81 GB a layer, ~48 GB resident), qwen3-moe-235b-a22b 2 of
# 94 (9.95 GB a layer, ~27 GB).  The dense phase's serve() shapes;
# qwen3-moe serves 4 requests (one admission) under accept-always only:
# its basis at K 4,096 × N 152,064 takes seconds a tick (C22).
MOE = (dict(LM, arch="mixtral-8x7b", layers=8, tag="moe_mixtral",
            policies=("accept_always", "fixed_r20", "escalating")),
       dict(LM, arch="qwen3-moe-235b-a22b", layers=2, n_requests=4,
            tag="moe_qwen3", policies=("accept_always",)))
MOE_DECISION_R = (4, 8, 20)
# the SMOKE configs card against CPU: prompts of 8 and 4 new tokens fit
# mixtral's SMOKE window of 16
MOE_SMOKE = dict(LM, prompt_len=8, gen_len=4)


def run_moe_model(spec: dict) -> dict:
    """One MoE config at full width and cut depth, params drawn on the
    card from ``spec``'s seed: serve() under ``spec``'s policies (launch
    and sync counts asserted by ``lm_serve_run``), the kernels on its
    live operands (``lm_kernel_checks``: decision.cu at R 4, 8, 20 and
    with read noise; rank16 on one decode_step), a tick's split and the
    kernels' times; the params freed after."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import params_init, serve
    from repro_torch.serving import TriagePolicy
    card_name, _, power = card_line().partition(",")
    full = get_config(spec["arch"])
    cfg = dataclasses.replace(full, n_layers=spec["layers"])
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = params_init(cfg, spec["seed"], "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tensor_leaves(params)
    check(all(t.is_cuda for t in leaves), "params off the card")
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    del leaves
    serve(spec["arch"], smoke=False, cfg=cfg, batch=spec["batch"],
          prompt_len=spec["prompt_len"], gen_len=1, n_requests=1,
          params=params, device="cuda")                    # warm-up
    acc = lm_serve_run("accept_always", TriagePolicy(**LM_ACCEPT), True,
                       params, spec, cfg)
    check(acc["n_tokens"] == [spec["gen_len"]] * spec["n_requests"]
          and acc["accept_fraction"] == 1.0,
          f"{spec['arch']} accept-always: tokens {acc['n_tokens']}")
    runs = [acc]
    if "fixed_r20" in spec["policies"]:
        runs.append(lm_serve_run("fixed_r20", TriagePolicy(**LM_FIXED),
                                 False, params, spec, cfg))
        check(runs[-1]["mean_samples_per_decision"] == LM_FIXED["r_max"]
              and runs[-1]["n_tokens"] == acc["n_tokens"],
              f"{spec['arch']} fixed R: samples per decision or tokens")
    if "escalating" in spec["policies"]:
        esc = TriagePolicy(conf_threshold=statistics.median(
            acc["confidences"]), mi_threshold=0.5, r_min=4, r_max=20)
        runs.append(lm_serve_run("escalating", esc, True, params, spec,
                                 cfg))
        check(runs[-1]["rounds_run"] > runs[-1]["dispatches"],
              f"{spec['arch']} escalating: no round past the first")
        check(sum(r["midstream_admissions"] for r in runs) >= 1,
              f"{spec['arch']}: no admission into a decoding pool")
    checks = lm_kernel_checks(cfg, params, spec, MOE_DECISION_R,
                              tag=f"{spec['tag']}_vocab")
    split = lm_tick_split(checks.pop("engine"))
    for r in runs:
        emit({"lm_moe": r["name"], "arch": spec["arch"], "smoke": False,
              "layers": f"{cfg.n_layers} of {full.n_layers}",
              "gpu": card_name.strip(), "power_limit": power.strip(),
              "n_params": n_params, "param_bytes": param_bytes,
              "params_init_s": init_s,
              "basis_ms_a_tick": split["basis_ms"],
              **{k: v for k, v in r.items() if k != "confidences"}})
    emit({"lm_tick_split": f"{spec['arch']} full width, {cfg.n_layers} "
          f"of {full.n_layers} layers, B={spec['batch']}, "
          f"N={cfg.vocab_padded}", "gpu": card_name.strip(),
          "power_limit": power.strip(), **split,
          "basis_peak_bytes": checks["basis_peak_bytes"],
          "resident_bytes": checks["resident_bytes"]})
    del params
    times = lm_timing({"checks": checks}, tag=spec["tag"], dense=False)
    del checks["head_case"], checks["ops"]
    torch.cuda.empty_cache()
    return {"runs": runs, "split": split, "times": times,
            "shape": f"B={spec['batch']} N={cfg.vocab_padded}, every slot "
                     f"active, the live operands of one token decision "
                     f"({cfg.n_layers} of {full.n_layers} layers)",
            "launches": sum(r["decision_launches"] for r in runs),
            "decision_max_abs_err": checks["decision_max_abs_err"],
            "head_max_abs_err": checks["head_max_abs_err"],
            "n_params": n_params, "param_bytes": param_bytes}


def moe_card_vs_cpu(arch: str) -> dict:
    """An MoE SMOKE config on the card and on the CPU from the same port
    params and prompts: in float32 (TF32 off) the same tokens, verdicts,
    samples and decisions request for request under accept-always and
    fixed R = 20, confidence/MI within LM_FIN_ATOL (asserted); in bf16
    the requests that agree and, over a prefill and three decode steps
    on the same tokens, the (token, choice) routings that differ and
    the hidden states' worst relative gap (reported: a router near a
    tie may pick another expert on the card)."""
    import dataclasses
    import torch
    from repro_torch import float32_math
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import params_init, serve
    from repro_torch.models import moe
    from repro_torch.models import transformer as tr
    from repro_torch.serving import TriagePolicy
    from repro_torch.serving.engine import _to_device
    kw = dict(batch=MOE_SMOKE["batch"], prompt_len=MOE_SMOKE["prompt_len"],
              gen_len=MOE_SMOKE["gen_len"],
              n_requests=MOE_SMOKE["n_requests"], seed=MOE_SMOKE["seed"])
    smoke = get_config(arch, smoke=True)
    f32 = dataclasses.replace(smoke, dtype=torch.float32)
    res = {}
    p_cpu = params_init(f32, MOE_SMOKE["seed"], "cpu")
    p_gpu = _to_device(p_cpu, "cuda")
    for name, pol, adaptive in (("accept_always", LM_ACCEPT, True),
                                ("fixed_r20", LM_FIXED, False)):
        outs = {dev: serve(arch, cfg=f32, params=p, device=dev,
                           policy=TriagePolicy(**pol), adaptive=adaptive,
                           **kw)
                for dev, p in (("cpu", p_cpu), ("cuda", p_gpu))}
        same_decisions(outs["cuda"], outs["cpu"],
                       f"{arch} smoke f32 {name}: card vs CPU", LM_FIN_ATOL)
        tokens = [sorted((v["rid"], v["n_tokens"]) for v in o["verdicts"])
                  for o in (outs["cuda"], outs["cpu"])]
        check(tokens[0] == tokens[1]
              and outs["cuda"]["requests"] == MOE_SMOKE["n_requests"],
              f"{arch} smoke f32 {name}: token counts differ")
        res[name] = {"requests": outs["cuda"]["requests"],
                     "decisions": outs["cuda"]["decisions"],
                     "requests_alike": outs["cuda"]["requests"]}
    pb_cpu = params_init(smoke, MOE_SMOKE["seed"], "cpu")
    pb_gpu = _to_device(pb_cpu, "cuda")
    outs = {dev: serve(arch, cfg=smoke, params=p, device=dev,
                       policy=TriagePolicy(**LM_ACCEPT), **kw)
            for dev, p in (("cpu", pb_cpu), ("cuda", pb_gpu))}
    vb = {v["rid"]: v for v in outs["cpu"]["verdicts"]}
    agree = sum((v["prediction"], v["verdict"], v["n_tokens"])
                == (vb[v["rid"]]["prediction"], vb[v["rid"]]["verdict"],
                    vb[v["rid"]]["n_tokens"])
                for v in outs["cuda"]["verdicts"])
    toks = torch.randint(0, smoke.vocab, (MOE_SMOKE["batch"],
                                          MOE_SMOKE["prompt_len"]),
                         generator=torch.Generator().manual_seed(5))
    routes = {"cpu": [], "cuda": []}
    route = moe.route
    gaps = []
    try:
        with float32_math():
            caches, hs = {}, {}
            for dev, p in (("cpu", pb_cpu), ("cuda", pb_gpu)):
                def recorded(*a, _dev=dev):
                    out = route(*a)
                    routes[_dev].append(out[2].cpu())
                    return out
                moe.route = recorded
                caches[dev], hs[dev] = tr.prefill(
                    p, toks.to(dev), smoke, cache_len=16)
                for step in range(3):
                    tok = toks[:, step:step + 1].to(dev)
                    hs[dev], caches[dev] = tr.decode_hidden(
                        p, caches[dev], tok, smoke)
            want = hs["cpu"].float()
            gaps.append(float((hs["cuda"].float().cpu() - want).abs().max()
                              / max(float(want.abs().max()), 1e-3)))
    finally:
        moe.route = route
    check(len(routes["cpu"]) == len(routes["cuda"]) == 4 * smoke.n_layers,
          f"{arch} smoke: {len(routes['cpu'])} routings recorded")
    differ = sum(int((a != b).sum())
                 for a, b in zip(routes["cuda"], routes["cpu"]))
    total = sum(a.numel() for a in routes["cpu"])
    res["bf16"] = {"requests_agreeing": agree,
                   "requests": len(outs["cuda"]["verdicts"]),
                   "routings_differing": differ, "routings": total,
                   "hidden_rel_gap_after_3_decode_steps": gaps[0]}
    emit({"lm_moe_card_vs_cpu": f"{arch} SMOKE, card against CPU, the "
          "same port params and prompts; f32 with TF32 off: decisions "
          f"equal, fin within {LM_FIN_ATOL} (asserted); bf16: requests "
          "agreeing, routings differing over prefill + 3 decode steps, "
          "hidden gap (reported)", **res})
    return res


def run_lm_moe() -> dict:
    """The lm_moe phase: mixtral-8x7b (8 of 32 layers) under
    accept-always, fixed R = 20 and an escalating policy, and
    qwen3-moe-235b-a22b (2 of 94) under accept-always, each at full
    width and freed before the next; both SMOKE configs card against
    CPU."""
    t_phase = time.perf_counter()
    models = {spec["arch"]: run_moe_model(spec) for spec in MOE}
    smoke = {spec["arch"]: moe_card_vs_cpu(spec["arch"]) for spec in MOE}
    emit({"lm_moe_phase_s": time.perf_counter() - t_phase})
    return {"models": models, "smoke": smoke}


# ----------------------------------------------------------------------
# the SSM and hybrid LMs served at full width (zamba2's depth cut)
# ----------------------------------------------------------------------
# mamba2-130m (24 layers, d 768, vocabulary 50,432 padded; 0.83 GB of
# float32 params) and zamba2-2.7b (54 layers, d 2,560, the shared block
# at 9 sites, vocabulary 32,000; 10.1 GB), bf16, params drawn on the card
# from seed 0.  Prompts of 512 tokens: two SSD chunks of 256, so that the
# state carried between chunks (y_off, the decayed state update) runs on
# the card (at one chunk it multiplies a zero state).  The dense phase's
# serve() otherwise: 4 slots, 4 new tokens, 8 requests.
# zamba2 at 27 of its 54 layers (4 of 9 shared-block sites) since the
# mesh phase joined the script: a serve's summary walks the tile map a
# layer (C27), and the script's 1,200 s limit holds every phase
SSM = (dict(LM, arch="mamba2-130m", prompt_len=512, tag="ssm_mamba2"),
       dict(LM, arch="zamba2-2.7b", prompt_len=512, tag="ssm_zamba2",
            layers=27))
SSM_DECISION_R = (4, 8, 20)
# ssd_chunked at a full-width layer shape: 512 tokens at once against
# two 256-token calls with the state carried, and the card against the
# CPU (float32, TF32 off: only the products' order differs)
SSM_CARRY_TOL = dict(rtol=1e-4, atol=1e-5)


def ssm_chunk_carry(cfg) -> dict:
    """``ssd_chunked`` at ``cfg``'s layer shape (B 4, H, P, N, G, chunk;
    two chunks), inputs from a seed at the scales a layer gives them: on
    the card 512 tokens against 256 + 256 with the state carried (y and
    the final state within SSM_CARRY_TOL), and the card against the
    CPU."""
    import torch
    from repro_torch import float32_math
    from repro_torch.models.mamba2 import mamba_dims, ssd_chunked
    dims = mamba_dims(cfg)
    b, s, q = 4, 2 * cfg.ssm_chunk, cfg.ssm_chunk
    h, p, n, g = (dims["nheads"], dims["headdim"], dims["d_state"],
                  dims["ngroups"])
    gen = torch.Generator().manual_seed(7)
    args = [torch.randn((b, s, h, p), generator=gen) * 0.5,
            torch.nn.functional.softplus(
                torch.randn((b, s, h), generator=gen) - 2),
            -torch.ones((h,)),                    # A = −exp(0), as init
            torch.randn((b, s, g, n), generator=gen) * 0.3,
            torch.randn((b, s, g, n), generator=gen) * 0.3]
    out, err = {}, {}
    with float32_math():
        for dev in ("cuda", "cpu"):
            a = [t.to(dev) for t in args]
            y, st = ssd_chunked(*a, q)
            y1, st1 = ssd_chunked(*(t[:, :q] if t.ndim > 1 else t
                                    for t in a), q)
            y2, st2 = ssd_chunked(*(t[:, q:] if t.ndim > 1 else t
                                    for t in a), q, st1)
            ys = torch.cat([y1, y2], 1)
            err[f"{dev}_split_y"] = float((ys - y).abs().max())
            err[f"{dev}_split_state"] = float((st2 - st).abs().max())
            check(torch.allclose(ys, y, **SSM_CARRY_TOL)
                  and torch.allclose(st2, st, **SSM_CARRY_TOL),
                  f"{cfg.name}: ssd_chunked over {s} tokens differs from "
                  f"two chunks with the state carried on {dev}")
            out[dev] = (y.cpu(), st.cpu())
    for name, got, want in (("y", out["cuda"][0], out["cpu"][0]),
                            ("state", out["cuda"][1], out["cpu"][1])):
        err[f"card_vs_cpu_{name}"] = float((got - want).abs().max())
        check(torch.allclose(got, want, **SSM_CARRY_TOL),
              f"{cfg.name}: ssd_chunked {name} card vs CPU off by "
              f"{err[f'card_vs_cpu_{name}']}")
    row = {"ssm_chunk_carry": cfg.name, "B": b, "S": s, "chunk": q, "H": h,
           "P": p, "N": n, "G": g, **SSM_CARRY_TOL, "max_abs_err": err,
           "magnitude": {"y": float(out["cpu"][0].abs().max()),
                         "state": float(out["cpu"][1].abs().max())}}
    emit(row)
    return row


def placed_latency_s(cfg) -> float:
    """Host seconds of the two ``placed_decision_latency`` calls a
    serve's summary makes (its tile map's layer walk) at ``cfg``'s
    ``lm_layer_shapes``: work inside ``serve``'s wall time, outside
    every stage span."""
    from repro_torch.hw import compile_network
    from repro_torch.launch.serve import lm_layer_shapes
    from repro_torch.serving.metrics import placed_decision_latency
    layers = lm_layer_shapes(cfg)
    program = compile_network(layers)
    t0 = time.perf_counter()
    placed_decision_latency(4.0, layers, program)
    placed_decision_latency(4.0, layers, program, replicated=True)
    return time.perf_counter() - t0


def run_ssm_model(spec: dict) -> dict:
    """One SSM config at full width and ``spec``'s depth (``layers``;
    full by default), params drawn on the card from ``spec``'s seed: serve() under accept-always, fixed R = 20
    and the escalating policy (launch and sync counts asserted by
    ``lm_serve_run``; at least one admission into a decoding pool), the
    kernels on its live operands (``lm_kernel_checks``: decision.cu at
    R 4, 8, 20 and with read noise; rank16 on one decode_step_ssm), the
    chunk carry at its layer shape, a tick's split and the kernels'
    times; the params freed after."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import params_init, serve
    from repro_torch.serving import TriagePolicy
    card_name, _, power = card_line().partition(",")
    full = get_config(spec["arch"])
    cfg = dataclasses.replace(full, n_layers=spec.get("layers",
                                                      full.n_layers))
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = params_init(cfg, spec["seed"], "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tensor_leaves(params)
    check(all(t.is_cuda for t in leaves), "params off the card")
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    del leaves
    serve(spec["arch"], smoke=False, cfg=cfg, batch=spec["batch"],
          prompt_len=spec["prompt_len"], gen_len=1, n_requests=1,
          params=params, device="cuda")                    # warm-up
    acc = lm_serve_run("accept_always", TriagePolicy(**LM_ACCEPT), True,
                       params, spec, cfg)
    check(acc["n_tokens"] == [spec["gen_len"]] * spec["n_requests"]
          and acc["accept_fraction"] == 1.0,
          f"{spec['arch']} accept-always: tokens {acc['n_tokens']}")
    fixed = lm_serve_run("fixed_r20", TriagePolicy(**LM_FIXED), False,
                         params, spec, cfg)
    check(fixed["mean_samples_per_decision"] == LM_FIXED["r_max"]
          and fixed["n_tokens"] == acc["n_tokens"],
          f"{spec['arch']} fixed R: samples per decision or tokens")
    esc = TriagePolicy(conf_threshold=statistics.median(acc["confidences"]),
                       mi_threshold=0.5, r_min=4, r_max=20)
    runs = [acc, fixed, lm_serve_run("escalating", esc, True, params, spec,
                                     cfg)]
    check(runs[-1]["rounds_run"] > runs[-1]["dispatches"],
          f"{spec['arch']} escalating: no round past the first")
    check(sum(r["midstream_admissions"] for r in runs) >= 1,
          f"{spec['arch']}: no admission into a decoding pool")
    checks = lm_kernel_checks(cfg, params, spec, SSM_DECISION_R,
                              tag=f"{spec['tag']}_vocab")
    split = lm_tick_split(checks.pop("engine"))
    carry = ssm_chunk_carry(cfg)
    summary_s = placed_latency_s(cfg)
    for r in runs:
        emit({"lm_ssm": r["name"], "arch": spec["arch"], "smoke": False,
              "layers": f"{cfg.n_layers} of {full.n_layers}",
              "prompt_len": spec["prompt_len"],
              "gpu": card_name.strip(), "power_limit": power.strip(),
              "n_params": n_params, "param_bytes": param_bytes,
              "params_init_s": init_s,
              "basis_ms_a_tick": split["basis_ms"],
              "summary_placed_latency_s": summary_s,
              **{k: v for k, v in r.items() if k != "confidences"}})
    emit({"lm_tick_split": f"{spec['arch']} full width, all "
          f"{cfg.n_layers} layers, B={spec['batch']}, prompts of "
          f"{spec['prompt_len']}, N={cfg.vocab_padded}",
          "gpu": card_name.strip(), "power_limit": power.strip(), **split,
          "basis_peak_bytes": checks["basis_peak_bytes"],
          "resident_bytes": checks["resident_bytes"]})
    del params
    times = lm_timing({"checks": checks}, tag=spec["tag"], dense=False)
    del checks["head_case"], checks["ops"]
    torch.cuda.empty_cache()
    return {"runs": runs, "split": split, "times": times, "carry": carry,
            "shape": f"B={spec['batch']} N={cfg.vocab_padded}, every slot "
                     f"active, the live operands of one token decision "
                     f"({cfg.n_layers} of {full.n_layers} layers, prompts of "
                     f"{spec['prompt_len']})",
            "launches": sum(r["decision_launches"] for r in runs),
            "decision_max_abs_err": checks["decision_max_abs_err"],
            "head_max_abs_err": checks["head_max_abs_err"],
            "n_params": n_params, "param_bytes": param_bytes}


def ssm_card_vs_cpu(arch: str) -> dict:
    """An SSM SMOKE config on the card and on the CPU from the same port
    params and prompts (16 tokens: one SMOKE chunk): in float32 (TF32
    off) the same tokens, verdicts, samples and decisions request for
    request under accept-always and fixed R = 20, confidence/MI within
    LM_FIN_ATOL (asserted); in bf16 the hidden states' worst relative
    gap over a prefill of two chunks and three decode steps within
    LM_BF16_REL (asserted), and the requests that agree (reported)."""
    import dataclasses
    import torch
    from repro_torch import float32_math
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import params_init, serve
    from repro_torch.models.registry import get_api
    from repro_torch.serving import TriagePolicy
    from repro_torch.serving.engine import _to_device
    kw = dict(batch=LM["batch"], prompt_len=LM["prompt_len"],
              gen_len=LM["gen_len"], n_requests=LM["n_requests"],
              seed=LM["seed"])
    smoke = get_config(arch, smoke=True)
    check(LM["prompt_len"] % smoke.ssm_chunk == 0,
          f"{arch} SMOKE: prompts of {LM['prompt_len']} are not whole "
          f"chunks of {smoke.ssm_chunk}")
    f32 = dataclasses.replace(smoke, dtype=torch.float32)
    res = {}
    p_cpu = params_init(f32, LM["seed"], "cpu")
    p_gpu = _to_device(p_cpu, "cuda")
    for name, pol, adaptive in (("accept_always", LM_ACCEPT, True),
                                ("fixed_r20", LM_FIXED, False)):
        outs = {dev: serve(arch, cfg=f32, params=p, device=dev,
                           policy=TriagePolicy(**pol), adaptive=adaptive,
                           **kw)
                for dev, p in (("cpu", p_cpu), ("cuda", p_gpu))}
        same_decisions(outs["cuda"], outs["cpu"],
                       f"{arch} smoke f32 {name}: card vs CPU", LM_FIN_ATOL)
        tokens = [sorted((v["rid"], v["n_tokens"]) for v in o["verdicts"])
                  for o in (outs["cuda"], outs["cpu"])]
        check(tokens[0] == tokens[1]
              and outs["cuda"]["requests"] == LM["n_requests"],
              f"{arch} smoke f32 {name}: token counts differ")
        res[name] = {"requests": outs["cuda"]["requests"],
                     "decisions": outs["cuda"]["decisions"],
                     "requests_alike": outs["cuda"]["requests"]}
    pb_cpu = params_init(smoke, LM["seed"], "cpu")
    pb_gpu = _to_device(pb_cpu, "cuda")
    outs = {dev: serve(arch, cfg=smoke, params=p, device=dev,
                       policy=TriagePolicy(**LM_ACCEPT), **kw)
            for dev, p in (("cpu", pb_cpu), ("cuda", pb_gpu))}
    vb = {v["rid"]: v for v in outs["cpu"]["verdicts"]}
    agree = sum((v["prediction"], v["verdict"], v["n_tokens"])
                == (vb[v["rid"]]["prediction"], vb[v["rid"]]["verdict"],
                    vb[v["rid"]]["n_tokens"])
                for v in outs["cuda"]["verdicts"])
    api = get_api(smoke)
    toks = torch.randint(0, smoke.vocab, (LM["batch"], 2 * smoke.ssm_chunk),
                         generator=torch.Generator().manual_seed(5))
    gaps = []
    with float32_math():
        caches, hs = {}, {}
        for dev, p in (("cpu", pb_cpu), ("cuda", pb_gpu)):
            caches[dev], hs[dev] = api.prefill(p, toks.to(dev), smoke,
                                               cache_len=48)
        for step in range(4):
            want = hs["cpu"].float()
            gaps.append(float((hs["cuda"].float().cpu() - want).abs().max()
                              / max(float(want.abs().max()), 1e-3)))
            if step == 3:
                break
            tok = toks[:, step:step + 1]
            for dev, p in (("cpu", pb_cpu), ("cuda", pb_gpu)):
                hs[dev], caches[dev] = api.decode_hidden(
                    p, caches[dev], tok.to(dev), smoke)
    check(max(gaps) < LM_BF16_REL,
          f"{arch} smoke bf16: hidden gap {max(gaps)} >= {LM_BF16_REL}")
    res["bf16"] = {"requests_agreeing": agree,
                   "requests": len(outs["cuda"]["verdicts"]),
                   "hidden_rel_gap": gaps}
    emit({"lm_ssm_card_vs_cpu": f"{arch} SMOKE, card against CPU, the "
          "same port params and prompts; f32 with TF32 off: decisions "
          f"equal, fin within {LM_FIN_ATOL} (asserted); bf16: hidden gap "
          f"over prefill (two chunks) + 3 decode steps within "
          f"{LM_BF16_REL} (asserted), requests agreeing (reported)", **res})
    return res


def run_lm_ssm() -> dict:
    """The lm_ssm phase: mamba2-130m and zamba2-2.7b at full width (SSM's
    depths), each under accept-always, fixed R = 20 and an
    escalating policy and freed before the next; both SMOKE configs card
    against CPU."""
    t_phase = time.perf_counter()
    models = {spec["arch"]: run_ssm_model(spec) for spec in SSM}
    smoke = {spec["arch"]: ssm_card_vs_cpu(spec["arch"]) for spec in SSM}
    emit({"lm_ssm_phase_s": time.perf_counter() - t_phase})
    return {"models": models, "smoke": smoke}


# ----------------------------------------------------------------------
# the audio and VLM LMs served at full width (llama-vision's depth cut)
# ----------------------------------------------------------------------
# whisper-medium (24 encoder + 24 decoder layers, d 1,024, 1,500 stub
# frames, vocabulary 51,968 padded; 0.87 B params, 3.47 GB in float32)
# and llama-3.2-vision-11b (40 self + 8 cross layers, d 4,096, 1,601 stub
# image tokens, vocabulary 128,256; 12.0 B params, 48.2 GB), bf16,
# params drawn on the card from seed 0 and freed before the next model.
# The dense phase's serve(): 4 slots, prompts of 16, 4 new tokens.
# whisper serves 8 requests under each policy; its learned positions
# cannot be re-based, so its second admission waits for the pool to
# drain (asserted: none into a decoding pool).  llama-vision serves 8
# under accept-always (asserted: an admission into a decoding pool, so
# xk/xv rows land in a decoding pool at full width) and 4 under fixed R
# and the escalating policy, to hold the phase's time: its basis at
# K 4,096 x N 128,256 takes seconds a tick (C22).
# llama-vision at 20 of 40 self layers (4 of 8 cross) since the mesh
# phase joined the script, for the reason zamba2's depth is cut (SSM)
XATTN = (dict(LM, arch="whisper-medium", tag="xattn_whisper",
              requests=(8, 8, 8)),
         dict(LM, arch="llama-3.2-vision-11b", tag="xattn_llama",
              requests=(8, 4, 4), layers=20))
XATTN_DECISION_R = (4, 8, 20)
# prefill over S + 1 tokens against prefill over S and one decode_hidden,
# float32 with TF32 off, at full width: the worst |difference| over the
# largest |hidden| (only the order of the sums differs)
XATTN_CONSISTENCY_REL = 1e-4


def xattn_consistency(arch: str) -> dict:
    """The prefill/decode consistency check at a full-width layer shape,
    float32: whisper-medium whole (24 + 24 layers), llama-3.2-vision-11b
    as one group (5 self layers and its cross layer), params drawn on
    the card from seed 1, 4 prompts of 16 tokens and the stub memory.
    The last hidden of ``prefill`` over 17 tokens against ``prefill``
    over 16 plus one ``decode_hidden`` within XATTN_CONSISTENCY_REL, the
    memory, the cross layers and (whisper) learned positions in play.
    whisper's decode adds the position row's first element only, as the
    reference's does (ROADMAP C28): its prefill is taken with row 16 of
    the table set to that element, and the plain prefill's gap is
    reported beside it."""
    import dataclasses
    import torch
    from repro_torch import float32_math
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import lm_extras, params_init
    from repro_torch.models import transformer as tr
    full = get_config(arch)
    cfg = dataclasses.replace(full, dtype=torch.float32)
    if cfg.cross_attn_every:
        cfg = dataclasses.replace(cfg, n_layers=cfg.cross_attn_every)
    torch.cuda.empty_cache()
    params = params_init(cfg, 1, "cuda")
    s, b = LM["prompt_len"], LM["batch"]
    toks = torch.randint(0, cfg.vocab, (b, s + 1),
                         generator=torch.Generator().manual_seed(11)).cuda()
    extras = lm_extras(cfg, b, s, 0, "cuda")
    out = {}
    with float32_math():
        cache, _ = tr.prefill(params, toks[:, :s], cfg, cache_len=s + 8,
                              **extras)
        dec, _ = tr.decode_hidden(params, cache, toks[:, s:], cfg)
        _, whole = tr.prefill(params, toks, cfg, cache_len=s + 8, **extras)
        if cfg.learned_pos:
            out["plain_prefill_rel_gap"] = float(
                (whole - dec).abs().max() / whole.abs().max())
            table = params["pos_embed"].clone()
            table[s] = table[s, 0]
            _, whole = tr.prefill(dict(params, pos_embed=table), toks, cfg,
                                  cache_len=s + 8, **extras)
    torch.cuda.synchronize()
    rel = float((whole - dec).abs().max() / whole.abs().max())
    check(bool(torch.isfinite(dec).all()) and rel <= XATTN_CONSISTENCY_REL,
          f"{arch}: prefill over {s + 1} tokens and prefill over {s} + one "
          f"decode differ by {rel} > {XATTN_CONSISTENCY_REL}")
    n_cross = full.n_layers // max(full.cross_attn_every, 1)
    row = {"xattn_consistency": arch, "dtype": "float32",
           "layers": (f"{cfg.encoder_layers} encoder + {cfg.n_layers} "
                      f"decoder" if cfg.encoder_layers else
                      f"{cfg.n_layers} self + 1 cross (one group of "
                      f"{full.n_layers} + {n_cross})"),
           "B": b, "S": s, "memory": (cfg.n_frames if cfg.encoder_layers
                                      else cfg.n_image_tokens),
           "rel_gap": rel, "rel_tol": XATTN_CONSISTENCY_REL, **out}
    emit(row)
    del params, cache
    torch.cuda.empty_cache()
    return row


def run_xattn_model(spec: dict) -> dict:
    """One cross-attention config at full width and ``spec``'s depth
    (``layers`` self layers, a cross layer each ``cross_attn_every``;
    full by default), params drawn on the card from ``spec``'s seed: serve() under accept-always,
    fixed R = 20 and the escalating policy (``spec['requests']`` each;
    launch and sync counts asserted by ``lm_serve_run``; whisper: no
    admission into a decoding pool and at least two a serve; llama-
    vision: at least one into a decoding pool), the kernels on its live
    operands (``lm_kernel_checks``: decision.cu at R 4, 8, 20 and with
    read noise; rank16 on one decode_step), a tick's split, the
    summary's tile walk and the kernels' times; the params freed
    after."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import params_init, serve
    from repro_torch.serving import TriagePolicy
    card_name, _, power = card_line().partition(",")
    full = get_config(spec["arch"])
    cfg = dataclasses.replace(full, n_layers=spec.get("layers",
                                                      full.n_layers))
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = params_init(cfg, spec["seed"], "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tensor_leaves(params)
    check(all(t.is_cuda for t in leaves), "params off the card")
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    del leaves
    serve(spec["arch"], smoke=False, cfg=cfg, batch=spec["batch"],
          prompt_len=spec["prompt_len"], gen_len=1, n_requests=1,
          params=params, device="cuda")                    # warm-up
    n_acc, n_fixed, n_esc = spec["requests"]
    acc = lm_serve_run("accept_always", TriagePolicy(**LM_ACCEPT), True,
                       params, dict(spec, n_requests=n_acc), cfg)
    check(acc["n_tokens"] == [spec["gen_len"]] * n_acc
          and acc["accept_fraction"] == 1.0,
          f"{spec['arch']} accept-always: tokens {acc['n_tokens']}")
    fixed = lm_serve_run("fixed_r20", TriagePolicy(**LM_FIXED), False,
                         params, dict(spec, n_requests=n_fixed), cfg)
    check(fixed["mean_samples_per_decision"] == LM_FIXED["r_max"]
          and fixed["n_tokens"] == [spec["gen_len"]] * n_fixed,
          f"{spec['arch']} fixed R: samples per decision or tokens")
    esc = TriagePolicy(conf_threshold=statistics.median(acc["confidences"]),
                       mi_threshold=0.5, r_min=4, r_max=20)
    runs = [acc, fixed, lm_serve_run("escalating", esc, True, params,
                                     dict(spec, n_requests=n_esc), cfg)]
    check(runs[-1]["rounds_run"] > runs[-1]["dispatches"],
          f"{spec['arch']} escalating: no round past the first")
    midstream = sum(r["midstream_admissions"] for r in runs)
    if cfg.learned_pos:
        check(midstream == 0, f"{spec['arch']}: {midstream} admissions "
              f"into a decoding pool (learned positions cannot re-base)")
        check(all(r["admissions"] >= 2 for r in runs),
              f"{spec['arch']}: a serve admitted once: "
              f"{[r['admissions'] for r in runs]}")
    else:
        check(acc["midstream_admissions"] >= 1,
              f"{spec['arch']}: no admission into a decoding pool")
    checks = lm_kernel_checks(cfg, params, spec, XATTN_DECISION_R,
                              tag=f"{spec['tag']}_vocab")
    split = lm_tick_split(checks.pop("engine"))
    summary_s = placed_latency_s(cfg)
    for r in runs:
        emit({"lm_xattn": r["name"], "arch": spec["arch"], "smoke": False,
              "layers": (f"{cfg.encoder_layers} encoder + {cfg.n_layers} "
                         f"decoder of {full.encoder_layers} + "
                         f"{full.n_layers}" if cfg.encoder_layers else
                         f"{cfg.n_layers} self + "
                         f"{cfg.n_layers // cfg.cross_attn_every} cross of "
                         f"{full.n_layers} + "
                         f"{full.n_layers // full.cross_attn_every}"),
              "memory": (cfg.n_frames if cfg.encoder_layers
                         else cfg.n_image_tokens),
              "gpu": card_name.strip(), "power_limit": power.strip(),
              "n_params": n_params, "param_bytes": param_bytes,
              "params_init_s": init_s,
              "basis_ms_a_tick": split["basis_ms"],
              "summary_placed_latency_s": summary_s,
              **{k: v for k, v in r.items() if k != "confidences"}})
    emit({"lm_tick_split": f"{spec['arch']} full width, {cfg.n_layers} of "
          f"{full.n_layers} layers, "
          f"B={spec['batch']}, N={cfg.vocab_padded}",
          "gpu": card_name.strip(), "power_limit": power.strip(), **split,
          "basis_peak_bytes": checks["basis_peak_bytes"],
          "resident_bytes": checks["resident_bytes"]})
    del params
    times = lm_timing({"checks": checks}, tag=spec["tag"], dense=False)
    del checks["head_case"], checks["ops"]
    torch.cuda.empty_cache()
    return {"runs": runs, "split": split, "times": times,
            "shape": f"B={spec['batch']} N={cfg.vocab_padded}, every slot "
                     f"active, the live operands of one token decision "
                     f"({cfg.n_layers} of {full.n_layers} layers)",
            "launches": sum(r["decision_launches"] for r in runs),
            "decision_max_abs_err": checks["decision_max_abs_err"],
            "head_max_abs_err": checks["head_max_abs_err"],
            "n_params": n_params, "param_bytes": param_bytes}


def xattn_card_vs_cpu(arch: str) -> dict:
    """A cross-attention SMOKE config on the card and on the CPU from the
    same port params, prompts and stub memory: in float32 (TF32 off)
    the same tokens, verdicts, samples and decisions request for request
    under accept-always and fixed R = 20, confidence/MI within
    LM_FIN_ATOL (asserted); in bf16 the hidden states' worst relative
    gap over a prefill and three decode steps within LM_BF16_REL
    (asserted), and the requests that agree (reported)."""
    import dataclasses
    import torch
    from repro_torch import float32_math
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import lm_extras, params_init, serve
    from repro_torch.models import transformer as tr
    from repro_torch.serving import TriagePolicy
    from repro_torch.serving.engine import _to_device
    kw = dict(batch=LM["batch"], prompt_len=LM["prompt_len"],
              gen_len=LM["gen_len"], n_requests=LM["n_requests"],
              seed=LM["seed"])
    smoke = get_config(arch, smoke=True)
    f32 = dataclasses.replace(smoke, dtype=torch.float32)
    res = {}
    p_cpu = params_init(f32, LM["seed"], "cpu")
    p_gpu = _to_device(p_cpu, "cuda")
    for name, pol, adaptive in (("accept_always", LM_ACCEPT, True),
                                ("fixed_r20", LM_FIXED, False)):
        outs = {dev: serve(arch, cfg=f32, params=p, device=dev,
                           policy=TriagePolicy(**pol), adaptive=adaptive,
                           **kw)
                for dev, p in (("cpu", p_cpu), ("cuda", p_gpu))}
        same_decisions(outs["cuda"], outs["cpu"],
                       f"{arch} smoke f32 {name}: card vs CPU", LM_FIN_ATOL)
        tokens = [sorted((v["rid"], v["n_tokens"]) for v in o["verdicts"])
                  for o in (outs["cuda"], outs["cpu"])]
        check(tokens[0] == tokens[1]
              and outs["cuda"]["requests"] == LM["n_requests"]
              and outs["cuda"]["admissions"] == outs["cpu"]["admissions"],
              f"{arch} smoke f32 {name}: token counts or admissions differ")
        res[name] = {"requests": outs["cuda"]["requests"],
                     "decisions": outs["cuda"]["decisions"],
                     "admissions": outs["cuda"]["admissions"],
                     "requests_alike": outs["cuda"]["requests"]}
    pb_cpu = params_init(smoke, LM["seed"], "cpu")
    pb_gpu = _to_device(pb_cpu, "cuda")
    outs = {dev: serve(arch, cfg=smoke, params=p, device=dev,
                       policy=TriagePolicy(**LM_ACCEPT), **kw)
            for dev, p in (("cpu", pb_cpu), ("cuda", pb_gpu))}
    vb = {v["rid"]: v for v in outs["cpu"]["verdicts"]}
    agree = sum((v["prediction"], v["verdict"], v["n_tokens"])
                == (vb[v["rid"]]["prediction"], vb[v["rid"]]["verdict"],
                    vb[v["rid"]]["n_tokens"])
                for v in outs["cuda"]["verdicts"])
    toks = torch.randint(0, smoke.vocab, (LM["batch"], LM["prompt_len"]),
                         generator=torch.Generator().manual_seed(5))
    extras = lm_extras(smoke, LM["batch"], LM["prompt_len"], LM["seed"])
    gaps = []
    with float32_math():
        caches, hs = {}, {}
        for dev, p in (("cpu", pb_cpu), ("cuda", pb_gpu)):
            caches[dev], hs[dev] = tr.prefill(
                p, toks.to(dev), smoke, cache_len=32,
                **{k: v.to(dev) for k, v in extras.items()})
        for step in range(4):
            want = hs["cpu"].float()
            gaps.append(float((hs["cuda"].float().cpu() - want).abs().max()
                              / max(float(want.abs().max()), 1e-3)))
            if step == 3:
                break
            tok = toks[:, step:step + 1]
            for dev, p in (("cpu", pb_cpu), ("cuda", pb_gpu)):
                hs[dev], caches[dev] = tr.decode_hidden(
                    p, caches[dev], tok.to(dev), smoke)
    check(max(gaps) < LM_BF16_REL,
          f"{arch} smoke bf16: hidden gap {max(gaps)} >= {LM_BF16_REL}")
    res["bf16"] = {"requests_agreeing": agree,
                   "requests": len(outs["cuda"]["verdicts"]),
                   "hidden_rel_gap": gaps}
    emit({"lm_xattn_card_vs_cpu": f"{arch} SMOKE, card against CPU, the "
          "same port params, prompts and stub memory; f32 with TF32 off: "
          f"decisions equal, fin within {LM_FIN_ATOL} (asserted); bf16: "
          f"hidden gap over prefill + 3 decode steps within {LM_BF16_REL} "
          "(asserted), requests agreeing (reported)", **res})
    return res


def run_lm_xattn() -> dict:
    """The lm_xattn phase: whisper-medium and llama-3.2-vision-11b at
    full width (XATTN's depths), each under accept-always, fixed R = 20
    and an escalating policy and freed before the next; the
    prefill/decode consistency check at a full-width layer shape; both
    SMOKE configs card against CPU."""
    t_phase = time.perf_counter()
    models = {spec["arch"]: run_xattn_model(spec) for spec in XATTN}
    consistency = {spec["arch"]: xattn_consistency(spec["arch"])
                   for spec in XATTN}
    smoke = {spec["arch"]: xattn_card_vs_cpu(spec["arch"])
             for spec in XATTN}
    emit({"lm_xattn_phase_s": time.perf_counter() - t_phase})
    return {"models": models, "consistency": consistency, "smoke": smoke}


# ----------------------------------------------------------------------
# the LM trainer (launch/train) at full width
# ----------------------------------------------------------------------
# qwen3-0.6b (28 layers, d 1,024, vocabulary 152,064 padded; float32
# params, bf16 compute) at the reference trainer's own batch and
# sequence defaults (8 × 64), 30 steps; mamba2-130m (24 layers, d 768,
# vocabulary 50,432) at 8 × 512, two SSD chunks, so the carried state's
# gradient runs, 10 steps.  Params drawn on the card from seed 0
# (launch/serve.params_init), the port's own batches (data/tokens).
LM_TRAIN = (dict(arch="qwen3-0.6b", steps=30, batch=8, seq=64),
            dict(arch="mamba2-130m", steps=10, batch=8, seq=512))
LM_TRAIN_TAIL = 5                  # the last steps whose mean ce must fall
LM_TRAIN_PROFILE_STEPS = 4         # steps under torch.profiler
LM_TRAIN_SYNC_RUNS = (2, 4)        # train() lengths whose syncs differ by
# the steps between them: one sync a step, the metrics pull (after a
# 1-step run under the debug mode, whose first calls sync once more)
LM_TRAIN_SMOKE = dict(arch="qwen3-0.6b", steps=5, batch=4, seq=16)
LM_TRAIN_LOSS_ATOL = 1e-4          # card vs CPU a step (float32, SMOKE)
LM_TRAIN_PARAM_ATOL = 1e-3         # and the params after the steps
EPS_COL_BLOCK = 4096               # the plain version's column blocks


def lm_train_syncs(spec: dict) -> dict:
    """Host syncs a training step: ``train`` for LM_TRAIN_SYNC_RUNS
    steps at ``spec``'s shape under ``set_sync_debug_mode("warn")``
    (after a 1-step run under it), counting the synchronizing calls it
    reports; both runs make their params and log alike, so the
    difference over the extra steps is the syncs a step.  Each run's
    syncs are listed by the line that made them."""
    import warnings
    import torch
    from repro_torch.launch.train import train
    counts, where = {}, {}
    for steps in (1, *LM_TRAIN_SYNC_RUNS):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                train(spec["arch"], smoke=False, steps=steps,
                      batch=spec["batch"], seq=spec["seq"], log_every=10**9)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        synced = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
                  if "synchroniz" in str(w.message)]
        counts[steps] = len(synced)
        where[steps] = {x: synced.count(x) for x in sorted(set(synced))}
    a, b = LM_TRAIN_SYNC_RUNS
    return {"syncs_by_run": counts, "syncs_per_step":
            (counts[b] - counts[a]) / (b - a), "synced_at": where}


def lm_train_profile(spec: dict, params, opt) -> dict:
    """LM_TRAIN_PROFILE_STEPS more steps of the trainer's loop body
    (``build_batch``, the step, ``pull_metrics``) from the trained state
    under ``torch.profiler``: wall and device busy a step, the device's
    idle share, kernels a step, the ε kernel's device time a launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipelineConfig
    from repro_torch.launch.profile_serve import _union_us
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import build_batch, pull_metrics
    from repro_torch.optim import AdamWConfig
    cfg = get_config(spec["arch"])
    pipe = TokenPipelineConfig(vocab=cfg.vocab, seq_len=spec["seq"],
                               global_batch=spec["batch"])
    step_fn = make_train_step(cfg, AdamWConfig(), total_steps=spec["steps"],
                              warmup_steps=max(1, spec["steps"] // 20))
    n = LM_TRAIN_PROFILE_STEPS
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in range(spec["steps"], spec["steps"] + n):
            params, opt, m = step_fn(params, opt,
                                     build_batch(cfg, pipe, s, "cuda"), s)
            pull_metrics(m)
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    check(kernels, "the profiler recorded no device kernels")
    busy = _union_us((e.time_range.start, e.time_range.end)
                     for e in kernels)
    eps = [e.time_range.elapsed_us() for e in kernels
           if "grng_eps" in e.name]
    check(len(eps) == n, f"profile: {len(eps)} ε kernels in {n} steps")
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"profiled_steps": n, "wall_ms_per_step": wall_us / 1e3 / n,
            "device_busy_ms_per_step": busy / 1e3 / n,
            "device_idle_share": 1 - busy / wall_us,
            "kernels_per_step": len(kernels) / n,
            "eps_kernel_ms_per_launch": sum(eps) / len(eps) / 1e3,
            "top_kernels_ms_per_step": {k[:60]: v / 1e3 / n
                                        for k, v in top}}


def lm_eps_check(cfg, step: int, case: str = None) -> dict:
    """The training draw's ε at ``cfg``'s full width, [d_model,
    vocab_padded] at stream offset ``step`` (the selection
    ``indexed_selections(lfsr_seed, step)``, as ``bayes_layer.eps_at``
    draws it): one kernel launch, held bit for bit to the plain version
    on column blocks of EPS_COL_BLOCK at their offsets (the first, one
    in the middle and the last, ragged, ending at vocab_padded); then
    timed by graph replay beside its bound, and the plain version over
    the whole block (in those column blocks: its [K, N, 16] currents
    would not fit whole) by one eager call."""
    import dataclasses
    import torch
    from repro_torch.core import lfsr
    from repro_torch.kernels import grng
    from repro_torch.kernels.bounds import grng_bound
    ideal = dataclasses.replace(cfg.grng, read_sigma=0.0, imprint=0.0)
    k, n = cfg.d_model, cfg.vocab_padded
    sel = lfsr.indexed_selections(ideal.lfsr_seed, torch.full(
        (1,), step, dtype=torch.int64, device="cuda"))

    def kernel():
        return grng.grng_eps(sel, ideal, k, n, sample0=step)

    def plain(c0, c1):
        return grng.grng_eps_plain(sel, ideal, k, c1 - c0, col0=c0,
                                   sample0=step)
    got = kernel()
    starts = list(range(0, n, EPS_COL_BLOCK))
    blocks = {"first": starts[0], "middle": starts[len(starts) // 2],
              "last": starts[-1]}
    checked = {}
    for where, c0 in blocks.items():
        c1 = min(c0 + EPS_COL_BLOCK, n)
        want = plain(c0, c1)
        unequal = int((got[:, :, c0:c1] != want).sum())
        check(unequal == 0, f"{cfg.name}: ε at vocabulary width != plain "
              f"on columns [{c0}, {c1}) ({unequal} differ)")
        checked[where] = [c0, c1]
    del want
    launches = grng.grng_eps.launches
    one = time.perf_counter()
    kernel()
    torch.cuda.synchronize()
    one = time.perf_counter() - one
    ms = device_ms(kernel, max(3, min(100, int(0.02 / max(one, 1e-6)))))

    def plain_whole():
        for c0 in starts:
            plain(c0, min(c0 + EPS_COL_BLOCK, n))
    plain_ms = call_ms(plain_whole, 1, warmup=1)
    grng.grng_eps.launches = launches
    del got
    torch.cuda.empty_cache()
    row = {"K": k, "N": n, "R": 1, "sample0": step, "equal": True,
           "blocks_checked": checked, "ms": ms, "plain_ms": plain_ms,
           "plain_timing": f"eager, CUDA events, over column blocks of "
                           f"{EPS_COL_BLOCK}",
           **grng_bound(k, n, 1, ideal)}
    emit({"kernel_check": "grng_eps",
          "case": case or f"lm_train_{cfg.name}", **row})
    return row


def run_lm_train_model(spec: dict) -> dict:
    """One config trained at full width through ``launch.train.train``
    on the card: ε launches = steps, every loss finite, the mean ce of
    the last LM_TRAIN_TAIL steps below the first step's, one host sync a
    step (asserted); ms a step (median past the first), allocator
    peak; a profile of a few more steps; the ε kernel at the head's
    width against its plain version and timed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import grng
    from repro_torch.launch.train import train
    cfg = get_config(spec["arch"])
    card_name, _, power = card_line().partition(",")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    grng.grng_eps.launches = 0
    t0 = time.perf_counter()
    out = train(spec["arch"], smoke=False, steps=spec["steps"],
                batch=spec["batch"], seq=spec["seq"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = grng.grng_eps.launches
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    check(launches == spec["steps"], f"{cfg.name}: {launches} ε launches "
          f"in {spec['steps']} steps")
    check(all(math.isfinite(h["loss"]) for h in hist),
          f"{cfg.name}: non-finite training loss")
    ce = [h["ce"] for h in hist]
    tail = sum(ce[-LM_TRAIN_TAIL:]) / LM_TRAIN_TAIL
    check(tail < ce[0], f"{cfg.name}: ce did not fall: {ce[0]} -> {tail}")
    leaves = tensor_leaves(out["params"])
    check(all(t.is_cuda for t in leaves), "params off the card")
    n_params = sum(t.numel() for t in leaves)
    del leaves
    profile = lm_train_profile(spec, out["params"], out["opt"])
    del out
    torch.cuda.empty_cache()
    syncs = lm_train_syncs(spec)
    check(syncs["syncs_per_step"] == 1, f"{cfg.name}: "
          f"{syncs['syncs_per_step']} host syncs a step ({syncs})")
    times = [h["step_time"] for h in hist]
    row = {"lm_train": cfg.name, "card": card_name.strip(),
           "power_limit": power.strip(), "layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab_padded": cfg.vocab_padded,
           "params": n_params, "batch": spec["batch"], "seq": spec["seq"],
           "steps": spec["steps"], "eps_launches": launches,
           "wall_s": wall, "ms_per_step_median":
           statistics.median(times[1:]) * 1e3,
           "ms_first_step": times[0] * 1e3,
           "loss_first": hist[0]["loss"], "loss_last": hist[-1]["loss"],
           "ce_first": ce[0], "ce_last": ce[-1], f"ce_last{LM_TRAIN_TAIL}"
           "_mean": tail, "kl_last": hist[-1]["kl"],
           "grad_norm_last": hist[-1]["grad_norm"],
           "max_memory_allocated": peak, **syncs, **profile}
    emit(row)
    row["eps"] = dict(lm_eps_check(cfg, spec["steps"]), launches=launches)
    return row


def lm_train_card_vs_cpu() -> dict:
    """qwen3-0.6b SMOKE through ``make_train_step`` for
    LM_TRAIN_SMOKE's steps on the card and on the CPU from the same
    params (drawn on the CPU from seed 0) and batches: float32, every
    step's loss within LM_TRAIN_LOSS_ATOL and the params at the end
    within LM_TRAIN_PARAM_ATOL (asserted); bf16's gaps reported."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipelineConfig
    from repro_torch.kernels import grng
    from repro_torch.launch.serve import params_init
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import build_batch, pull_metrics
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.utils.trees import leaves, tree_map
    spec = LM_TRAIN_SMOKE
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(get_config(spec["arch"], smoke=True),
                                  dtype=dtype)
        pipe = TokenPipelineConfig(vocab=cfg.vocab, seq_len=spec["seq"],
                                   global_batch=spec["batch"])
        step_fn = make_train_step(cfg, AdamWConfig(),
                                  total_steps=spec["steps"], warmup_steps=1)
        runs = {}
        grng.grng_eps.launches = 0
        for dev in ("cuda", "cpu"):
            params = tree_map(lambda t: t.to(dev),
                              params_init(cfg, 0, "cpu"))
            opt = init_opt_state(params)
            losses = []
            for s in range(spec["steps"]):
                params, opt, m = step_fn(params, opt,
                                         build_batch(cfg, pipe, s, dev), s)
                losses.append(pull_metrics(m)["loss"])
            runs[dev] = (losses, params)
        check(grng.grng_eps.launches == spec["steps"],
              f"card vs CPU: {grng.grng_eps.launches} ε launches")
        loss_gap = max(abs(a - b) for a, b in zip(runs["cuda"][0],
                                                  runs["cpu"][0]))
        param_gap = max(float((a.cpu().float() - b.float()).abs().max())
                        for a, b in zip(leaves(runs["cuda"][1]),
                                        leaves(runs["cpu"][1])))
        key = "f32" if dtype == torch.float32 else "bf16"
        res[key] = {"loss_card": runs["cuda"][0], "loss_cpu": runs["cpu"][0],
                    "max_loss_gap": loss_gap, "max_param_gap": param_gap}
        if dtype == torch.float32:
            check(loss_gap <= LM_TRAIN_LOSS_ATOL and
                  param_gap <= LM_TRAIN_PARAM_ATOL,
                  f"LM training card vs CPU: loss gap {loss_gap}, param "
                  f"gap {param_gap}")
    emit({"lm_train_card_vs_cpu": f"{spec['arch']} SMOKE, "
          f"{spec['steps']} steps of make_train_step from the same params "
          f"and batches; f32: loss within {LM_TRAIN_LOSS_ATOL} a step, "
          f"params within {LM_TRAIN_PARAM_ATOL} (asserted); bf16 gaps "
          "reported", **res})
    return res


def lm_train_resume() -> dict:
    """``train`` at SMOKE on the card: 6 steps with checkpoints every 2
    and ``fail_at=3`` raise SystemExit; a rerun resumes from step 2 and
    equals an uninterrupted run bit for bit (params and the losses);
    then ``compress=True`` for 3 steps: finite losses and a nonzero error
    state."""
    import tempfile
    import torch
    from repro_torch.launch.train import train
    from repro_torch.utils.trees import leaves
    arch, kw = "qwen3-0.6b", dict(steps=6, batch=4, seq=16)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_") as tmp:
        whole = train(arch, **kw)
        try:
            train(arch, ckpt_dir=tmp, ckpt_every=2, fail_at=3, **kw)
            failed = False
        except SystemExit:
            failed = True
        check(failed, "fail_at=3 did not raise SystemExit")
        resumed = train(arch, ckpt_dir=tmp, ckpt_every=2, **kw)
    check([h["step"] for h in resumed["history"]] == [2, 3, 4, 5],
          "the rerun did not resume from step 2")
    same_loss = [h["loss"] for h in resumed["history"]] == \
        [h["loss"] for h in whole["history"][2:]]
    same_params = all(a.is_cuda and torch.equal(a, b) for a, b in
                      zip(leaves(resumed["params"]), leaves(whole["params"])))
    check(same_loss and same_params, "the resumed run differs from the "
          f"uninterrupted one (losses equal: {same_loss}, params equal: "
          f"{same_params})")
    comp = train(arch, steps=3, batch=4, seq=16, compress=True)
    err_max = max(float(e.abs().max()) for e in leaves(comp["err"]))
    check(all(math.isfinite(h["loss"]) for h in comp["history"])
          and err_max > 0, f"compressed training: losses "
          f"{[h['loss'] for h in comp['history']]}, error state {err_max}")
    row = {"lm_train_resume": f"{arch} SMOKE: train(steps=6, ckpt_every=2, "
           "fail_at=3) raised SystemExit, the rerun resumed from step 2 "
           "and equals an uninterrupted run bit for bit; compress=True for "
           "3 steps", "bit_equal": True,
           "losses": [h["loss"] for h in whole["history"]],
           "compressed_losses": [h["loss"] for h in comp["history"]],
           "error_state_max_abs": err_max}
    emit(row)
    return row


def run_lm_train() -> dict:
    """The lm_train phase: qwen3-0.6b and mamba2-130m trained at full
    width on the card (each freed before the next), the training card
    against the CPU, and the resume."""
    t_phase = time.perf_counter()
    models = {spec["arch"]: run_lm_train_model(spec) for spec in LM_TRAIN}
    smoke = lm_train_card_vs_cpu()
    resume = lm_train_resume()
    emit({"lm_train_phase_s": time.perf_counter() - t_phase})
    return {"models": models, "smoke": smoke, "resume": resume}


# ----------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------
# ----------------------------------------------------------------------
# the fleet: slot-sharded rounds, the sharded pool, SarServingFleet, the
# sharded mission.  One card holds every shard and every pool (cuda:0
# repeated): these runs show bit-identity and host syncs a tick, not
# scaling across cards.
# ----------------------------------------------------------------------
FLEET = dict(n_requests=256, n_pools=4, slots_per_pool=32,
             corrupt_frac=0.25)
SHARDED_CASES = {                 # SAR's shape, half the slots masked
    "sar_r4": dict(b=32, n=2, r=4),
    "sar_r20": dict(b=32, n=2, r=20),
    "sar_r4_noise": dict(b=32, n=2, r=4, read_sigma=0.4),
    "sar_r20_noise": dict(b=32, n=2, r=20, read_sigma=0.4),
    "lm_vocab_r20": dict(b=4, n=152064, r=20),
}
SHARDED_TIMED = "sar_r4_noise"    # the gate die's round, the kernels line
FLEET_OPEN_LOOP = 0.5             # open loop at this share of closed loop


def sharded_check(name: str, args: dict, shards: int) -> dict:
    """``decision_stats_sharded`` over ``shards`` shards on cuda:0 (one
    run: one launch a call, asserted) against one unsharded launch (bit
    for bit) and against its plain version (TOL at N ≤ 32, LM_RTOL with
    the LM's floors above); its accumulating form (``out=``, the main
    path's) bit for bit ``stats + delta`` with masked slots untouched.
    Device ms by graph replay of the accumulating call (``ms``, as the
    rounds call it), of the delta form, of its plain version and of the
    unsharded delta launch.  Emits the case; -> the line."""
    import torch
    from repro_torch.kernels.decision import (decision_stats,
                                              decision_stats_sharded,
                                              decision_stats_sharded_plain,
                                              slot_runs)
    a = args            # rows None: the wrapper keys global slot ids
    devices = ["cuda:0"] * shards
    b, n = a["y_mu"].shape
    r = a["sel"].shape[0]
    before = decision_stats.launches
    got = decision_stats_sharded(**a, devices=devices)
    per_call = decision_stats_sharded.launches_per_call
    launched = decision_stats.launches - before
    runs = len(slot_runs(devices, b))
    check(per_call == launched == runs == 1,
          f"sharded_{name} x{shards}: {launched} launches in one call "
          f"({per_call} counted), {runs} runs")
    whole = decision_stats(**a)
    plain = decision_stats_sharded_plain(**a, shards=shards)
    gen = torch.Generator().manual_seed(shards)
    stats0 = {k: (torch.rand(whole[k].shape, generator=gen) * r).cuda()
              for k in STAT_KEYS}
    acc = {k: v.clone() for k, v in stats0.items()}
    decision_stats_sharded(**a, devices=devices, out=acc)
    torch.cuda.synchronize()
    same = all(torch.equal(got[k], whole[k]) for k in STAT_KEYS)
    check(same, f"sharded_{name} x{shards}: the shards differ from the "
                f"unsharded launch")
    mask = a["mask"]
    folded = all(torch.equal(acc[k][mask], (stats0[k] + whole[k])[mask])
                 and torch.equal(acc[k][~mask], stats0[k][~mask])
                 for k in STAT_KEYS)
    check(folded, f"sharded_{name} x{shards}: the accumulating call is "
                  f"not stats + delta with masked slots untouched")
    err = max(float((got[k] - plain[k]).abs().max()) for k in STAT_KEYS)
    if n > 32:
        rel = relative_errors(f"sharded_{name}", got, plain, r, n)
    else:
        rel = None
        for key in STAT_KEYS:
            check(torch.allclose(got[key], plain[key], **TOL),
                  f"sharded_{name} x{shards}: {key} off its plain version "
                  f"by {float((got[key] - plain[key]).abs().max())}")
    check(bool((got["sum_p"][~mask] == 0).all()),
          f"sharded_{name} x{shards}: masked slots advanced")
    iters = 200 if n <= 32 else 20
    work = decision_args_work(args, accumulate=True)
    ms = device_ms(lambda: decision_stats_sharded(**a, devices=devices,
                                                  out=acc), iters)
    unsharded = device_ms(lambda: decision_stats(**a), iters)
    line = {"kernel_check": f"sharded_{name}", "shards": shards,
            "devices": devices, "runs": runs, "launches_per_call": per_call,
            "B": b, "N": n, "R": r,
            "read_sigma": a["cfg"].read_sigma, "masked_slots":
            int((~mask).sum()), "bit_equal_unsharded": same,
            "accumulate_bit_equal": folded,
            "max_abs_err": err, "rtol": TOL["rtol"], "atol": TOL["atol"],
            **({"relative": {"rtol": LM_RTOL, "errors": rel}} if rel
               else {}),
            "ms": ms,
            "delta_ms": device_ms(lambda: decision_stats_sharded(
                **a, devices=devices), iters),
            "plain_ms": device_ms(lambda: decision_stats_sharded_plain(
                **a, shards=shards), iters),
            "unsharded_ms": unsharded, "ms_over_unsharded": ms / unsharded,
            **{k: work[k] for k in ("bound_ms", "bound_by", "bound_bytes",
                                    "bound_ops")}}
    emit(line)
    return line


def run_sharded_kernel_checks() -> dict:
    lines = {}
    for i, (name, spec) in enumerate(SHARDED_CASES.items()):
        args = decision_case(seed=40 + i, **spec)
        for shards in ((2,) if spec["n"] > 32 else (2, 4)):
            lines[(name, shards)] = sharded_check(name, args, shards)
    return lines


def run_sharded_pool() -> dict:
    """The slot-sharded pool: 192 fog-mixed requests in 32 slots, slot
    shards 2 on cuda:0 (one run: the pool's state is the unsharded
    pool's tensors) against the unsharded pool, on the ideal die and the
    gate die; records equal request for request, floats bit for bit; one
    accumulating decision launch a round (counts zeroed before, read
    after).  Then 2 shards on cuda:0 and the CPU (two runs, each
    holding its 16 slots' state on its device): verdicts equal the
    unsharded card pool's request for request, confidence and MI within
    TOL's atol (the CPU run's rounds take the plain version), one launch
    a round (the card's run)."""
    from repro_torch.kernels.decision import (decision_stats,
                                              decision_stats_sharded)
    from repro_torch.launch.serve import serve_sar
    from repro_torch.serving import TriagePolicy
    policy = TriagePolicy(**POLICY)
    out = {"decision_launches": 0, "mixed_decision_launches": 0}
    for die_name, chip in (("ideal", None), ("gate_die", gate_die())):
        kw = dict(STREAM, policy=policy, chip_instance=chip, device="cuda")
        serve_sar(n_requests=32, slot_devices=["cuda:0"] * 2, **kw)  # warm
        whole = serve_sar(n_requests=192, **kw)
        arms = {}
        for arm, devices in (("cuda", ["cuda:0"] * 2),
                             ("cuda_cpu", ["cuda:0", "cpu"])):
            decision_stats.launches = decision_stats_sharded.launches = 0
            t0 = time.perf_counter()
            got = serve_sar(n_requests=192, slot_devices=devices, **kw)
            arms[arm] = (got, decision_stats.launches,
                         decision_stats_sharded.launches,
                         time.perf_counter() - t0)
            check(got["shards"] == 2 and got["decisions"] == 192,
                  f"sharded pool {die_name} {arm}: {got.get('shards')} "
                  f"shards, {got['decisions']} decisions")
            check(got["runs"] == (1 if arm == "cuda" else 2),
                  f"sharded pool {die_name} {arm}: {got['runs']} runs")
            check(arms[arm][1] == got["rounds_launched"] > 0
                  and arms[arm][2] == 0,
                  f"sharded pool {die_name} {arm}: {arms[arm][1]} decision "
                  f"launches, {got['rounds_launched']} rounds")
            check(whole["host_syncs"] == got["host_syncs"],
                  f"sharded pool {die_name} {arm}: host syncs differ")
        sharded, n_dec = arms["cuda"][0], arms["cuda"][1]
        same_decisions(whole, sharded, f"sharded pool {die_name}",
                       atol=0.0)
        mixed = arms["cuda_cpu"][0]
        same_decisions(whole, mixed, f"sharded pool {die_name} cuda+cpu",
                       atol=TOL["atol"])
        gap = max(max(abs(x["confidence"] - y["confidence"]),
                      abs(x["mutual_information"] - y["mutual_information"]))
                  for x, y in zip(sorted(whole["verdicts"],
                                         key=lambda v: v["rid"]),
                                  sorted(mixed["verdicts"],
                                         key=lambda v: v["rid"])))
        out["decision_launches"] += n_dec
        out["mixed_decision_launches"] += arms["cuda_cpu"][1]
        emit({"sharded_pool": die_name, "requests": 192, "shards": 2,
              "devices": ["cuda:0", "cuda:0"], "runs": sharded["runs"],
              "decisions_per_s_wall": sharded["decisions"]
              / sharded["wall_s"],
              "unsharded_decisions_per_s_wall": whole["decisions"]
              / whole["wall_s"],
              "host_syncs": sharded["host_syncs"],
              "rounds_launched": sharded["rounds_launched"],
              "decision_kernel_launches": n_dec,
              "records_equal_bitwise": True,
              "cuda_cpu": {"devices": ["cuda:0", "cpu"],
                           "runs": mixed["runs"],
                           "decision_kernel_launches": arms["cuda_cpu"][1],
                           "rounds_launched": mixed["rounds_launched"],
                           "verdicts_equal": True,
                           "max_confidence_mi_gap": gap,
                           "decisions_per_s_wall": mixed["decisions"]
                           / mixed["wall_s"]},
              "what": "one card holds both shards: one run, the "
                      "unsharded pool's state; bit-identity and launch "
                      "counts, not scaling"})
    return out


def fleet_energy_check(out: dict, what: str) -> float:
    """The fleet's energy against the sum over its records (one fixed
    sweep a decision plus the samples, ``request_energy``)."""
    from repro_torch.hw import compile_network
    from repro_torch.launch.serve import sar_layer_shapes
    from repro_torch.models.sar_cnn import SarCnnConfig
    from repro_torch.serving import energy_terms
    layers = sar_layer_shapes(SarCnnConfig())
    t = energy_terms(layers, compile_network(layers))
    per_record = sum(t["e_fixed"] + v["n_samples"] * t["e_per_sample"]
                     for v in out["verdicts"])
    check(math.isclose(out["energy_total_J"], per_record, rel_tol=1e-9),
          f"{what}: energy {out['energy_total_J']} != records' "
          f"{per_record}")
    return per_record


def run_fleet() -> dict:
    """``serve_sar_fleet`` (4 pools of 32 slots, 256 requests, 25 % fog)
    gang against sequential on both dies: verdicts and routes equal,
    fewer host syncs, energy = the records' sum; then an open-loop run
    with the SLO fleet block and a stitched trace (ideal die)."""
    import torch
    from repro_torch.kernels.cim import cim_mvm
    from repro_torch.kernels.decision import decision_stats
    from repro_torch.launch.serve import serve_sar_fleet
    from repro_torch.obs.trace import Tracer
    from repro_torch.serving import TriagePolicy
    policy = TriagePolicy(**POLICY)
    launches = {"decision": 0, "cim": 0}
    rates = {}
    for die_name, chip in (("ideal", None), ("gate_die", gate_die())):
        kw = dict(FLEET, policy=policy, chip_instance=chip)
        serve_sar_fleet(**dict(kw, n_requests=64))                # warm-up
        runs = {}
        for gang in (True, False):
            torch.cuda.synchronize()
            decision_stats.launches = cim_mvm.launches = 0
            out = serve_sar_fleet(gang=gang, **kw)
            runs[gang] = (out, decision_stats.launches, cim_mvm.launches)
            check(out["gang"] is gang and out["decisions"] == 256,
                  f"fleet {die_name} gang={gang}: {out['decisions']} "
                  f"decisions")
            check(out["devices"] == ["cuda:0"] * 4,
                  f"fleet {die_name}: pools on {out['devices']}")
            check(runs[gang][1] > 0, f"fleet {die_name} gang={gang}: "
                  f"no decision launch")
            check(chip is None or runs[gang][2] > 0,
                  f"fleet {die_name} gang={gang}: no CIM launch")
            fleet_energy_check(out, f"fleet {die_name} gang={gang}")
            launches["decision"] += runs[gang][1]
            launches["cim"] += runs[gang][2]
        (g, g_dec, g_cim), (q, q_dec, q_cim) = runs[True], runs[False]
        check(g["verdicts"] == q["verdicts"],
              f"fleet {die_name}: gang verdicts != sequential")
        check(g["routed_per_pool"] == q["routed_per_pool"],
              f"fleet {die_name}: routes differ")
        check(g["host_syncs"] < q["host_syncs"],
              f"fleet {die_name}: gang syncs {g['host_syncs']} not below "
              f"sequential {q['host_syncs']}")
        check(g["host_syncs"] == g["ticks"],
              f"fleet {die_name}: gang syncs {g['host_syncs']} != ticks "
              f"{g['ticks']}")
        rates[die_name] = g["decisions_per_s"]
        emit({"fleet": die_name, "n_pools": 4, "slots_per_pool": 32,
              "requests": 256, "devices": g["devices"],
              "verdicts_equal": True,
              "routed_per_pool": g["routed_per_pool"],
              "backlog_peak": g["backlog_peak"],
              **{f"{arm}_{k}": run[k] for arm, run in (("gang", g),
                                                       ("sequential", q))
                 for k in ("decisions_per_s", "wall_s", "host_syncs",
                           "host_syncs_per_decision", "ticks")},
              "gang_decision_launches": g_dec,
              "sequential_decision_launches": q_dec,
              "gang_cim_launches": g_cim, "sequential_cim_launches": q_cim,
              "mean_samples_per_decision": g["mean_samples_per_decision"],
              "flag_fraction": g["flag_fraction"],
              "energy_total_J": g["energy_total_J"],
              "energy_reconciles": True,
              "max_trips_per_tick": max(max(t["trips"])
                                        for t in g["tick_log"]),
              "what": "four pools on one card: bit-identity and host "
                      "syncs a tick, not scaling across cards"})
    rate = FLEET_OPEN_LOOP * rates["ideal"]
    tracer = Tracer("fleet")
    decision_stats.launches = 0
    ol = serve_sar_fleet(**FLEET, policy=policy, arrival=f"poisson:{rate}",
                         tracer=tracer, slo=("0.25:p99",))
    launches["decision"] += decision_stats.launches
    check(ol["decisions"] == 256, f"open-loop fleet: {ol['decisions']}")
    fleet_block = ol["slo"]["fleet"]
    check(len(fleet_block["queue_depth_peak"]) == 4,
          f"open-loop fleet: queue peaks {fleet_block['queue_depth_peak']}")
    ev = tracer.to_chrome()["traceEvents"]
    pnames = {e["pid"]: e["args"]["name"] for e in ev
              if e["ph"] == "M" and e["name"] == "process_name"}
    starts = {e["id"]: e for e in ev if e["ph"] == "s"}
    ends = {e["id"]: e for e in ev if e["ph"] == "f"}
    check(pnames == {0: "router", **{p + 1: f"pool {p}" for p in range(4)}},
          f"fleet trace: processes {pnames}")
    check(set(starts) == set(ends) == set(range(256))
          and all(s["pid"] == 0 for s in starts.values())
          and all(e["pid"] in range(1, 5) and e["tid"] >= 1
                  for e in ends.values()),
          "fleet trace: a flow does not go from the router to a slot")
    emit({"fleet_open_loop": "ideal", "arrival": ol["arrival"],
          "offered_rps": ol["offered"]["offered_rps"],
          "decisions_per_s": ol["decisions_per_s"],
          "host_syncs_per_decision": ol["host_syncs_per_decision"],
          "ticks": ol["ticks"],
          "time_to_verdict_s": {k: ol["slo"][k]
                                for k in ("p50_s", "p95_s", "p99_s")},
          "slo_fleet": fleet_block,
          "backpressure_ticks": ol.get("backpressure_ticks"),
          "trace_events": len(ev), "trace_flows": len(starts),
          "trace_processes": pnames})
    return {"launches": launches, "rates": rates}


def run_fleet_mixed() -> None:
    """A 2-pool gang fleet on cuda:0 and the CPU: the packed results of
    both pools gathered on cuda:0, then one pull.  48 requests fill each
    pool in its first tick, so a standalone engine on the same device
    fed that pool's requests admits the same batch; records equal bit
    for bit, pool for pool."""
    from repro_torch.launch.serve import make_sar_stream
    from repro_torch.models.sar_cnn import SarCnnConfig
    from repro_torch.serving import (SarServingEngine, SarServingFleet,
                                     TriagePolicy)
    cfg, params = sar_params("cpu")
    policy = TriagePolicy(**POLICY)
    fleet = SarServingFleet(params, cfg, n_pools=2, slots_per_pool=32,
                            policy=policy, gang=True,
                            devices=["cuda:0", "cpu"])
    reqs = make_sar_stream(48, **{k: STREAM[k] for k in
                                  ("corrupt_frac", "corruption")})
    for r in reqs:
        fleet.submit(r)
    out = fleet.run()
    check(out["host_syncs"] == out["ticks"] and out["decisions"] == 48,
          f"fleet_mixed: {out['host_syncs']} syncs, {out['ticks']} ticks")
    per_pool = []
    for p, dev in enumerate(("cuda:0", "cpu")):
        eng = SarServingEngine(params, SarCnnConfig(), n_slots=32,
                               policy=policy, device=dev)
        mine = [r for r in make_sar_stream(48, **{
            k: STREAM[k] for k in ("corrupt_frac", "corruption")})
            if fleet.routes[r.rid] == p]
        for r in mine:
            eng.submit(r)
        eng.run()

        def recs(e):
            return {r.rid: (r.verdict, r.prediction, r.n_samples,
                            r.confidence, r.mutual_information)
                    for r in e.metrics.records}

        check(recs(eng) == recs(fleet.engines[p]),
              f"fleet_mixed: pool {p} on {dev} differs from a standalone "
              f"engine")
        per_pool.append(len(mine))
    emit({"fleet_mixed": "gang over cuda:0 and the CPU",
          "devices": ["cuda:0", "cpu"], "requests_per_pool": per_pool,
          "ticks": out["ticks"], "host_syncs": out["host_syncs"],
          "pools_equal_standalone_engines": True})


def run_mission_sharded(params) -> dict:
    """``fly_mission`` at mission_bench's default scale (bayes_adaptive)
    on the ideal die and the mission die, each die group's 8 lanes over
    2 slot shards on cuda:0 against the unsharded mission: logs equal
    lane for lane (floats bit for bit); one sharded call a decision
    round and one launch in it (counts zeroed before, read after)."""
    import numpy as np
    from repro_torch.kernels.decision import (decision_stats,
                                              decision_stats_sharded)
    from repro_torch.mission import MissionPolicy, fly_mission
    wcfg, ucfg = mission_configs(MISSION_BENCH)
    steps, episodes = MISSION_BENCH["steps"], MISSION_BENCH["episodes"]
    pol = MissionPolicy()
    per_step, _ = mission_step_counts(pol)
    total = total_dec = 0
    for die_name, chip in (("ideal", None), ("die", mission_die())):
        kw = dict(params=params, chips=chip, n_episodes=episodes,
                  device="cuda")
        t0 = time.perf_counter()
        whole = fly_mission(wcfg, ucfg, pol, n_steps=steps, **kw)
        whole_s = time.perf_counter() - t0
        decision_stats.launches = decision_stats_sharded.launches = 0
        t0 = time.perf_counter()
        sharded = fly_mission(wcfg, ucfg, pol, n_steps=steps,
                              devices=["cuda:0"] * 2, **kw)
        sharded_s = time.perf_counter() - t0
        n_sh, n_dec = decision_stats_sharded.launches, decision_stats.launches
        check(n_sh == per_step * steps and n_dec == n_sh,
              f"mission_sharded {die_name}: {n_sh} sharded calls, {n_dec} "
              f"launches, expected {per_step} x {steps} of each")
        for k in whole.logs:
            check(np.array_equal(whole.logs[k], sharded.logs[k]),
                  f"mission_sharded {die_name}: logs {k} differ")
        check(whole.summary == sharded.summary,
              f"mission_sharded {die_name}: summaries differ")
        total += n_sh
        total_dec += n_dec
        emit({"mission_sharded": die_name, "shards": 2,
              "lanes": episodes * ucfg.n_drones, "steps": steps,
              "logs_equal": True, "sharded_calls": n_sh,
              "decision_kernel_launches": n_dec,
              "host_syncs": sharded.host_syncs,
              "wall_s": sharded_s, "unsharded_wall_s": whole_s})
    return {"sharded_launches": total, "decision_launches": total_dec}


def run_fleet_phase(params) -> dict:
    """The fleet phase: the sharded kernel's checks, the sharded pool,
    the fleet (gang, sequential, open loop, trace), the mixed-device
    fleet and the sharded mission.  -> launch counts and the kernels
    line's ``decision_stats_sharded`` entry."""
    t0 = time.perf_counter()
    checks = run_sharded_kernel_checks()
    pool = run_sharded_pool()
    fleet = run_fleet()
    run_fleet_mixed()
    mission = run_mission_sharded(params)
    timed = checks[(SHARDED_TIMED, 2)]
    entry = {
        "name": "decision_stats_sharded",
        "route": "cuda",
        "source": "src/repro_torch/kernels/decision.py",
        "body": "src/repro_torch/kernels/csrc/decision.cu",
        "replaces": "src/repro/kernels/decision_kernel.py:263",
        "design": "consecutive shards on one device form a run; one "
                  "decision.cu launch a run over views of its slot range "
                  "(row0 = its first global slot for the read-noise hash, "
                  "per-slot selections and indices read through the "
                  "round's strides), its accumulate epilogue adding the "
                  "deltas into the statistics on that device: no slice "
                  "copy, no concatenation, no add kernels; the sharded "
                  "pool keeps each run's pool and statistics on the run's "
                  "device and folds each round with one such launch a run",
        "launches": pool["decision_launches"]
        + mission["sharded_launches"],
        "launches_by_path": {"sharded_pool": pool["decision_launches"],
                             "mission_sharded":
                                 mission["sharded_launches"]},
        "launches_what": "sharded_pool: the resident runs' accumulating "
                         "launches (decision_stats' count, one a round on "
                         "one card); mission_sharded: "
                         "decision_stats_sharded's count, one launch a "
                         "call",
        "launches_per_call": timed["launches_per_call"],
        "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
        "shape": f"B=32 N=2 R=4, read_sigma 0.4, half the slots masked, "
                 f"2 shards on cuda:0 ({SHARDED_TIMED})",
        "ms": timed["ms"], "plain_ms": timed["plain_ms"],
        "unsharded_ms": timed["unsharded_ms"],
        "delta_ms": timed["delta_ms"],
        "ms_over_unsharded": timed["ms_over_unsharded"],
        "timing": "device time per call of the whole sharded call in its "
                  "accumulating form (out=stats, as the rounds call it), "
                  "200 calls replayed from one CUDA graph; delta_ms: the "
                  "delta form; unsharded_ms: one unsharded delta launch",
        **{k: timed[k] for k in ("bound_ms", "bound_by", "bound_bytes",
                                 "bound_ops")},
        "library_ms": None,
        "library_note": "no single PyTorch call computes the fused "
                        "mix -> softmax -> masked statistic sums",
        "cases": {f"{name}_x{shards}": {k: c[k] for k in (
            "ms", "delta_ms", "plain_ms", "unsharded_ms",
            "ms_over_unsharded", "bound_ms", "max_abs_err",
            "launches_per_call")}
            for (name, shards), c in checks.items()},
    }
    emit({"fleet_phase_s": time.perf_counter() - t0})
    return {"kernel": entry,
            "decision_launches": {
                "sharded_pool": pool["decision_launches"],
                "sharded_pool_cuda_cpu": pool["mixed_decision_launches"],
                "serve_sar_fleet": fleet["launches"]["decision"],
                "mission_sharded": mission["decision_launches"]},
            "cim_launches": fleet["launches"]["cim"]}


# ----------------------------------------------------------------------
# the (data, model) mesh on one card
# ----------------------------------------------------------------------
# Every mesh coordinate on cuda:0 (a mesh may repeat a device), so the
# phase shows placement without bytes, the sharded paths' arithmetic
# against the unsharded ones and the kernels' launches, not scaling
# across cards.  qwen3-0.6b at full width (28 layers); mixtral-8x7b at
# full width and 4 of 32 layers (its float32 params ~25 GB).
MESH_SHAPES = ((2, 2), (1, 4))
MESH_TRAIN = dict(arch="qwen3-0.6b", steps=5, batch=8, seq=64)
MESH_TRAIN_REL = 1e-3            # ROADMAP C32: bf16 losses, mesh vs (1, 1)
MESH_MICROBATCH_ATOL = 5e-2      # tests/test_spmd.py:285-288
MESH_MOE = dict(layers=4, batch=4, seq=64)
MESH_MOE_ATOL = 2e-5             # tests/test_spmd.py's sharded MoE
MESH_SAMPLES_REL = 1e-5          # float32 samples: max error / max entry
MESH_SERVE = dict(batch=4, prompt=48, seq=64, decode=2)


def mesh_of(shape):
    """A (data, model) mesh of ``shape``, every coordinate on cuda:0."""
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, ("data", "model"),
                     ["cuda:0"] * (shape[0] * shape[1]))


def mesh_place(cfg, params) -> dict:
    """``params`` placed on (2, 2) of cuda:0: the allocator's bytes
    before and after (no growth, asserted) and ``validate_specs``
    (empty, asserted)."""
    import gc
    import torch
    from repro_torch.sharding import specs as S
    mesh = mesh_of((2, 2))
    gc.collect()               # what an earlier phase left to collect
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    placed = S.place(params, S.param_specs, mesh)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    problems = S.validate_specs(params, S.param_specs(params, mesh), mesh)
    check(after == before, f"{cfg.name}: placing on (2, 2) of one card "
          f"moved the allocator {before} -> {after}")
    check(not problems, f"{cfg.name}: validate_specs {problems[:3]}")
    flat = [x for x in tensor_leaves(placed) if isinstance(x, S.Placed)]
    row = {"mesh_place": cfg.name, "mesh": [2, 2],
           "layers": cfg.n_layers, "allocated_before": before,
           "allocated_after": after, "validate_specs": problems,
           "leaves": len(flat),
           "leaves_sharded": sum(len(x.distinct()) > 1 for x in flat)}
    emit(row)
    return placed


def moe_layer_check(cfg, lp: dict) -> dict:
    """One full-width MoE layer (layer 0's weights) at MESH_MOE's batch ×
    sequence through ``make_sharded_moe`` on (2, 2) and (1, 4) (EP) in
    float32 and bf16 against ``moe_apply``: at capacity factor 8 (no
    drop; float32 within MESH_MOE_ATOL asserted, bf16 reported), at 1
    the pairs dropped a shard (reported); ms of each call."""
    import torch
    from repro_torch import float32_math
    from repro_torch.models import moe
    g = torch.Generator(device="cuda").manual_seed(17)
    x32 = torch.randn(MESH_MOE["batch"], MESH_MOE["seq"], cfg.d_model,
                      generator=g, device="cuda")
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.to(dtype)
        w = {k: lp[k].to(dtype) for k in ("router", "wi", "wg", "wo")}
        for cf in (8.0, 1.0):
            with float32_math():
                y0, aux0 = moe.moe_apply(x, w["router"], w["wi"], w["wg"],
                                         w["wo"], top_k=cfg.top_k,
                                         capacity_factor=cf)
                plain_ms = call_ms(lambda: moe.moe_apply(
                    x, w["router"], w["wi"], w["wg"], w["wo"],
                    top_k=cfg.top_k, capacity_factor=cf), 3, warmup=1)
            for shape in MESH_SHAPES:
                stats = []
                fn = moe.make_sharded_moe(
                    mesh_of(shape), top_k=cfg.top_k, capacity_factor=cf,
                    n_experts=cfg.n_experts, dp_axes=("data",), stats=stats)
                with float32_math():
                    y, aux = fn(x, w["router"], w["wi"], w["wg"], w["wo"])
                    bare = moe.make_sharded_moe(
                        mesh_of(shape), top_k=cfg.top_k, capacity_factor=cf,
                        n_experts=cfg.n_experts, dp_axes=("data",))
                    ms = call_ms(lambda: bare(x, w["router"], w["wi"],
                                              w["wg"], w["wo"]), 3,
                                 warmup=1)
                err = float((y.float() - y0.float()).abs().max())
                dropped = [s["local_pairs"] - s["kept"] for s in stats]
                if cf == 8.0:
                    check(sum(dropped) == 0, f"sharded MoE {shape} dropped "
                          f"{dropped} at capacity factor 8")
                    if dtype == torch.float32:
                        check(err <= MESH_MOE_ATOL, f"sharded MoE {shape} "
                              f"float32 off moe_apply by {err}")
                row = {"mesh_moe": cfg.name, "mesh": list(shape),
                       "ep": cfg.n_experts % shape[1] == 0,
                       "dtype": str(dtype), "capacity_factor": cf,
                       "tokens": x.shape[0] * x.shape[1],
                       "max_abs_err_vs_moe_apply": err,
                       "aux": float(aux), "aux_moe_apply": float(aux0),
                       "dropped_pairs_per_shard": dropped,
                       "capacity_per_shard": [s["capacity"] for s in stats],
                       "local_pairs_per_shard": [s["local_pairs"]
                                                 for s in stats],
                       "dropped_pairs_moe_apply": None,
                       "ms": ms, "moe_apply_ms": plain_ms,
                       "timing": "eager, CUDA events, 3 calls"}
                if cf == 1.0:
                    cap = int(max(cfg.top_k, cf * x.shape[0] * x.shape[1]
                                  * cfg.top_k / cfg.n_experts))
                    xf = x.reshape(-1, cfg.d_model)
                    _, _, experts = moe.route(xf, w["router"], cfg.top_k)
                    counts = torch.bincount(experts.reshape(-1),
                                            minlength=cfg.n_experts)
                    row["dropped_pairs_moe_apply"] = int(
                        (counts - cap).clamp(min=0).sum())
                emit(row)
                rows.append(row)
            del y0
    return {"rows": rows, "float32_max_abs_err": max(
        r["max_abs_err_vs_moe_apply"] for r in rows
        if r["dtype"] == "torch.float32" and r["capacity_factor"] == 8.0)}


def mesh_serving_check(cfg, params, tag: str, decode: int,
                       capacity_factor=None) -> dict:
    """``mesh_prefill_step`` (then ``decode`` ``mesh_decode_step``s) on
    (2, 2) of cuda:0 in float32 against the unsharded steps: samples
    within MESH_SAMPLES_REL of the max entry (asserted), one rank16
    launch a step (asserted), the rank16 kernel on each step's own head
    operands (the rows' hidden states gathered on the first device)
    against its plain version (TOL_HEAD, asserted; lines
    ``kernel_check bayes_rank16 mesh_*``)."""
    import dataclasses
    import torch
    from repro_torch import float32_math
    from repro_torch.data.tokens import TokenPipelineConfig, batch_at
    from repro_torch.kernels import bayes
    from repro_torch.launch import steps
    cfg = dataclasses.replace(cfg, dtype=torch.float32, **(
        {"capacity_factor": capacity_factor} if capacity_factor else {}))
    b, seq = MESH_SERVE["batch"], MESH_SERVE["seq"]
    tokens = batch_at(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=MESH_SERVE["prompt"], global_batch=b),
        0)["tokens"].to("cuda")
    mesh = mesh_of((2, 2))
    pre, hinted = steps.mesh_prefill_step(cfg, mesh, seq, b)
    dec, _ = steps.mesh_decode_step(cfg, mesh, seq, b)
    bayes.bayes_rank16.launches = 0
    calls, restore = recording({"rank16": (
        bayes, "bayes_rank16", ("x", "mu_prime", "sigma", "sel", "cfg"))})
    t0 = time.perf_counter()
    try:
        with float32_math():
            cache, samples = pre(params, {"tokens": tokens})
            got = [samples]
            for t in range(decode):
                samples, cache = dec(params, cache, tokens[:, t:t + 1])
                got.append(samples)
            torch.cuda.synchronize()
    finally:
        restore()
    mesh_s = time.perf_counter() - t0
    launches = bayes.bayes_rank16.launches
    check(launches == 1 + decode, f"{tag}: {launches} rank16 launches in "
          f"a prefill and {decode} decode steps on the mesh")
    with float32_math():
        cache0, s0 = steps.make_prefill_step(cfg, seq)(
            params, {"tokens": tokens})
        want = [s0]
        dec0 = steps.make_decode_step(cfg)
        for t in range(decode):
            s0, cache0 = dec0(params, cache0, tokens[:, t:t + 1])
            want.append(s0)
    errs = [float((a - w).abs().max()) / float(w.abs().max())
            for a, w in zip(got, want)]
    check(max(errs) <= MESH_SAMPLES_REL, f"{tag}: mesh samples off the "
          f"unsharded steps' by {errs} (relative)")
    head_errs = []
    for i, c in enumerate(calls["rank16"]):
        pos = (c["x"], c["mu_prime"], c["sigma"], c["sel"], c["cfg"])
        k_out = bayes.bayes_rank16(*pos)
        p_out = bayes.bayes_rank16_plain(*pos)
        err = float((k_out - p_out).abs().max())
        check(torch.allclose(k_out, p_out, **TOL_HEAD),
              f"{tag}: rank16 on the mesh step's operands off its plain "
              f"version by {err}")
        check(torch.equal(k_out, got[i]), f"{tag}: the mesh step's "
              "samples differ from the kernel's on its own operands")
        head_errs.append(err)
        emit({"kernel_check": "bayes_rank16",
              "case": f"mesh_{tag}_{'prefill' if i == 0 else 'decode'}",
              "B": int(c["x"].shape[0]), "K": int(c["x"].shape[1]),
              "N": int(c["mu_prime"].shape[1]),
              "R": int(c["sel"].shape[0]), **TOL_HEAD,
              "max_abs_err": err})
    bayes.bayes_rank16.launches = launches
    return {"samples_rel_err": errs, "rank16_launches": launches,
            "head_max_abs_err": max(head_errs), "wall_s": mesh_s,
            "batch_axes": list(hinted.batch_axes),
            "model_axis_size": hinted.model_axis_size}


def mesh_train_runs() -> dict:
    """qwen3-0.6b at full width through ``mesh_train_step`` on (1, 1)
    and, explicit TP off and on, (2, 2), ``train``'s loop (its batches,
    warmup and one metrics pull a step): MESH_TRAIN's steps, losses
    within MESH_TRAIN_REL of the (1, 1) run's and one ε launch a step
    (asserted); ms a step (median past the first), allocator peak; the
    ε kernel on the mesh step's own draw (recorded: [d_model,
    vocab_padded], R = 1) against its plain version (line
    ``kernel_check grng_eps mesh_train_*``)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipelineConfig
    from repro_torch.kernels import grng
    from repro_torch.launch import steps
    from repro_torch.launch.serve import params_init
    from repro_torch.launch.train import build_batch, pull_metrics
    from repro_torch.optim import AdamWConfig, init_opt_state
    spec = MESH_TRAIN
    cfg = get_config(spec["arch"])
    pipe = TokenPipelineConfig(vocab=cfg.vocab, seq_len=spec["seq"],
                               global_batch=spec["batch"])
    card_name, _, power = card_line().partition(",")
    runs = {}
    for shape, tp in (((1, 1), False), ((2, 2), False), ((2, 2), True)):
        tcfg = dataclasses.replace(cfg, explicit_tp=tp)
        step, _ = steps.mesh_train_step(
            tcfg, mesh_of(shape), AdamWConfig(), spec["seq"],
            spec["batch"], total_steps=spec["steps"],
            warmup_steps=max(1, spec["steps"] // 20))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = params_init(tcfg, 0, "cuda")
        opt = init_opt_state(params)
        grng.grng_eps.launches = 0
        calls, restore = recording({"eps": (
            grng, "grng_eps", ("sel", "cfg", "k", "n"))})
        hist = []
        try:
            for s in range(spec["steps"]):
                t0 = time.perf_counter()
                params, opt, m = step(params, opt,
                                      build_batch(tcfg, pipe, s, "cuda"), s)
                hist.append((pull_metrics(m)["loss"],
                             time.perf_counter() - t0))
        finally:
            restore()
        launches = grng.grng_eps.launches
        check(launches == spec["steps"], f"mesh {shape} tp={tp}: "
              f"{launches} ε launches in {spec['steps']} steps")
        key = f"{shape[0]}x{shape[1]}" + ("_tp" if tp else "")
        runs[key] = {"losses": [h[0] for h in hist],
                     "ms_per_step_median": statistics.median(
                         h[1] for h in hist[1:]) * 1e3,
                     "ms_first_step": hist[0][1] * 1e3,
                     "max_memory_allocated": torch.cuda.max_memory_allocated(),
                     "eps_launches": launches,
                     "eps_call": {k: (list(v.shape) if hasattr(v, "shape")
                                      else v)
                                  for k, v in calls["eps"][-1].items()
                                  if k != "cfg"}}
        del params, opt, m, calls
    base = runs["1x1"]["losses"]
    for key, r in runs.items():
        rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], base))
        r["max_rel_loss_vs_1x1"] = rel
        check(rel <= MESH_TRAIN_REL, f"mesh train {key}: losses off the "
              f"(1, 1) run's by {rel} (relative)")
        emit({"mesh_train": cfg.name, "mesh": key, "gpu": card_name.strip(),
              "power_limit": power.strip(), "layers": cfg.n_layers,
              "batch": spec["batch"], "seq": spec["seq"],
              "steps": spec["steps"], "remat": cfg.remat, **r})
    for r in runs.values():
        check(r["eps_call"]["k"] == cfg.d_model
              and r["eps_call"]["n"] == cfg.vocab_padded
              and r["eps_call"]["sample0"] == spec["steps"] - 1,
              f"the mesh step's last ε draw {r['eps_call']}")
    eps = lm_eps_check(cfg, spec["steps"] - 1,
                       case=f"mesh_train_{cfg.name}")
    return {"runs": runs, "eps": eps,
            "eps_launches": sum(r["eps_launches"] for r in runs.values())}


def mesh_microbatch_and_elastic(cfg, params) -> dict:
    """The (2, 2) step at microbatches 4 against 1 from the same state
    (loss within MESH_MICROBATCH_ATOL once the KL terms' difference is
    taken out, asserted: each microbatch divides the KL by its own
    tokens, as the reference's step does); then 3 steps on
    (2, 2), ``shrink_mesh`` losing coordinates (1, 0) and (1, 1),
    ``remesh_train_state`` and 2 more steps: params bit-equal across the
    re-mesh and the count kept (asserted), the losses within
    MESH_TRAIN_REL of an unbroken run on the shrunken mesh from the same
    gathered state (asserted) and of the (2, 2) run continued
    (reported)."""
    import torch
    from repro_torch.data.tokens import TokenPipelineConfig
    from repro_torch.launch import steps
    from repro_torch.launch.train import build_batch
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.runtime import remesh_train_state, shrink_mesh
    from repro_torch.sharding import specs as S
    spec = MESH_TRAIN
    pipe = TokenPipelineConfig(vocab=cfg.vocab, seq_len=spec["seq"],
                               global_batch=spec["batch"])
    mesh = mesh_of((2, 2))
    opt_cfg = AdamWConfig()
    batch0 = build_batch(cfg, pipe, 0, "cuda")
    mets = {}
    for mb in (1, 4):
        step, _ = steps.mesh_train_step(cfg, mesh, opt_cfg, spec["seq"],
                                        spec["batch"], microbatches=mb)
        _, _, m = step(params, init_opt_state(params), batch0, 0)
        mets[mb] = {k: float(v) for k, v in m.items()}
        del m
    # each microbatch's loss divides the head's KL by its own tokens (the
    # reference's make_train_step): 4 microbatches carry 3 more KL terms
    # of kl_weight·KL/tokens; the rest is the data term, whose gap the
    # reference's tolerance bounds
    kl_extra = 3 * cfg.kl_weight * mets[1]["kl"] / (spec["batch"]
                                                    * spec["seq"])
    gap = abs(mets[4]["loss"] - kl_extra - mets[1]["loss"])
    check(gap < MESH_MICROBATCH_ATOL, f"microbatches 4 vs 1 on (2, 2): "
          f"{mets}, the KL terms' difference {kl_extra}")
    emit({"mesh_microbatch": cfg.name, "mesh": [2, 2],
          "batch": spec["batch"], "seq": spec["seq"],
          "loss_microbatches_1": mets[1]["loss"],
          "loss_microbatches_4": mets[4]["loss"],
          "ce_microbatches_1": mets[1]["ce"],
          "ce_last_microbatch_of_4": mets[4]["ce"], "kl": mets[1]["kl"],
          "kl_terms_difference": kl_extra,
          "abs_gap_without_kl_terms": gap,
          "abs_gap_raw": abs(mets[4]["loss"] - mets[1]["loss"]),
          "atol": MESH_MICROBATCH_ATOL})

    step, _ = steps.mesh_train_step(cfg, mesh, opt_cfg, spec["seq"],
                                    spec["batch"], total_steps=5,
                                    warmup_steps=1)
    p, o = params, init_opt_state(params)
    before = []
    for s in range(3):
        p, o, m = step(p, o, build_batch(cfg, pipe, s, "cuda"), s)
        before.append(float(m["loss"]))
    small = shrink_mesh(mesh, {(1, 0), (1, 1)})
    p2, o2 = remesh_train_state(p, o, small)
    same = all(torch.equal(a, b) for a, b in zip(
        tensor_leaves(S.gather(p2)), tensor_leaves(S.gather(p))))
    count = int(S.gather(o2["count"]))
    check(same, "params changed across the re-mesh")
    check(count == 3, f"the re-mesh kept count {count}, not 3")
    step2, _ = steps.mesh_train_step(cfg, small, opt_cfg, spec["seq"],
                                     spec["batch"], total_steps=5,
                                     warmup_steps=1)
    fresh_p, fresh_o = S.gather(p), S.gather(o)
    after, unbroken, on_big = [], [], []
    for s in range(3, 5):
        batch = build_batch(cfg, pipe, s, "cuda")
        p2, o2, m = step2(p2, o2, batch, s)
        after.append(float(m["loss"]))
        fresh_p, fresh_o, m = step2(fresh_p, fresh_o, batch, s)
        unbroken.append(float(m["loss"]))
        p, o, m = step(p, o, batch, s)
        on_big.append(float(m["loss"]))
    rel = max(abs(a - b) / abs(b) for a, b in zip(after, unbroken))
    check(rel <= MESH_TRAIN_REL, f"elastic: losses after the re-mesh off "
          f"an unbroken run on {small.shape} by {rel}")
    emit({"mesh_elastic": cfg.name, "from": [2, 2],
          "lost": [[1, 0], [1, 1]],
          "to": [small.shape["data"], small.shape["model"]],
          "params_bit_equal": same, "count": count,
          "losses_before": before, "losses_after": after,
          "losses_unbroken_on_shrunken": unbroken,
          "max_rel_vs_unbroken": rel, "losses_continued_on_2x2": on_big,
          "max_rel_vs_2x2": max(abs(a - b) / abs(b)
                                for a, b in zip(after, on_big))})
    return {"microbatch_gap": gap, "elastic_rel": rel}


def run_mesh_phase() -> dict:
    """The ``mesh`` phase (docstring 7n)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import params_init
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    mixtral = get_config("mixtral-8x7b")
    mcfg = dataclasses.replace(mixtral, n_layers=MESH_MOE["layers"])
    mparams = params_init(mcfg, 0, "cuda")
    mesh_place(mcfg, mparams)
    moe = moe_layer_check(mcfg, {k: v[0] for k, v in
                                 mparams["blocks"]["moe"].items()})
    serving = {"mixtral": mesh_serving_check(mcfg, mparams, "mixtral", 0,
                                             capacity_factor=8.0)}
    del mparams
    torch.cuda.empty_cache()
    qcfg = get_config(MESH_TRAIN["arch"])
    qparams = params_init(qcfg, 0, "cuda")
    mesh_place(qcfg, qparams)
    serving["qwen3"] = mesh_serving_check(qcfg, qparams, "qwen3",
                                          MESH_SERVE["decode"])
    for name, r in serving.items():
        emit({"mesh_prefill" if name == "mixtral" else "mesh_decode":
              name, "mesh": [2, 2], "layers": (
                  f"{MESH_MOE['layers']} of {mixtral.n_layers}"
                  if name == "mixtral" else qcfg.n_layers),
              "prompt": MESH_SERVE["prompt"], "cache": MESH_SERVE["seq"],
              "batch": MESH_SERVE["batch"], "dtype": "float32", **r})
    extra = mesh_microbatch_and_elastic(qcfg, qparams)
    del qparams
    torch.cuda.empty_cache()
    train = mesh_train_runs()
    phase_s = time.perf_counter() - t_phase
    emit({"mesh_phase_s": phase_s})
    return {"moe": moe, "serving": serving, "train": train, **extra,
            "rank16_launches": sum(r["rank16_launches"]
                                   for r in serving.values()),
            "head_max_abs_err": max(r["head_max_abs_err"]
                                    for r in serving.values()),
            "phase_s": phase_s}


def call_ms(fn, iters: int, warmup: int = 50) -> float:
    """Per-call time of eager calls, host included: CUDA events around a
    Python loop of ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, replays: int = 5) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph,
    whose replay runs them back to back without the host; the least of
    ``replays`` timed replays, over ``iters``."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):              # warm-up outside the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(replays):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def cim_timing(cases: dict, launches: dict, summary: dict) -> dict:
    """The CIM kernel's line: device and eager times at the three trunk
    shapes, with the die's front end, as the main path calls it;
    ``launches``: its count on each path that was read."""
    import torch
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels.bounds import cim_work
    from repro_torch.kernels.cim import cim_mvm, cim_mvm_plain, launch_plan
    qcfg = QuantConfig(enabled=True)
    shapes = []
    for name in ("trunk0", "trunk1", "trunk2"):
        c = cases[name]
        args = (c["x"], c["w"], c["fs"], qcfg, c["gain"], c["offset"])

        def kernel():
            return cim_mvm(*args)

        def plain():
            return cim_mvm_plain(*args)

        work = cim_work(*c["x"].shape, c["w"].shape[1])
        bound, bound_by, nbytes, ops = (work["bound_ms"], work["bound_by"],
                                        work["bound_bytes"],
                                        work["bound_ops"])
        plan = launch_plan(*c["x"].shape, c["w"].shape[1],
                           torch.cuda.get_device_properties(0)
                           .multi_processor_count)
        shapes.append({
            "case": name, "M": c["x"].shape[0], "K": c["x"].shape[1],
            "N": c["w"].shape[1], "plan": plan._asdict(),
            "ms": device_ms(kernel, 1000),
            "plain_ms": device_ms(plain, 1000),
            "call_ms": call_ms(kernel, 1000),
            "plain_call_ms": call_ms(plain, 1000), "bound_ms": bound,
            "bound_by": bound_by, "bound_bytes": nbytes, "bound_ops": ops})
    first = shapes[0]
    return {
        "name": "cim_mvm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cim_mvm.cu",
        "replaces": "src/repro/kernels/cim_mvm.py:72",
        "design": DESIGN["cim_mvm"],
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": summary["max_abs_err"],
        "max_abs_err_no_flip": summary["max_abs_err_no_flip"],
        "adc_code_flips": summary["adc_code_flips"],
        "shape": "trunk0: M=7200 K=64 N=16 (the first conv of a 32-slot "
                 "admission), the gate die's front end; every trunk "
                 "shape under 'shapes'",
        "ms": first["ms"], "kernel_ms": first["ms"],
        "plain_ms": first["plain_ms"],
        "timing": "ms and plain_ms: device time per call, 1000 calls "
                  "replayed from one CUDA graph; call_ms: eager calls, "
                  "host included",
        "call_ms": first["call_ms"], "plain_call_ms": first["plain_call_ms"],
        "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call applies a per-chunk ADC "
                        "between the partial sums of a matrix product",
        "shapes": shapes,
    }


def cim_plan_sweep(cases: dict) -> None:
    """Every plan the CIM kernel takes (each tile_m, split or walked),
    timed by graph replay at the trunk's shapes for a 32-slot admission
    (``cases``) and for 64 images (a UQ batch's shapes), with the die's
    front end.  Each plan must give the bits of the plan ``launch_plan``
    picks."""
    import torch
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels import cim
    qcfg = QuantConfig(enabled=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for images, trunk in ((32, cases), (64, trunk_cases(64, gate_die()))):
        for name in ("trunk0", "trunk1", "trunk2"):
            c = trunk[name]
            (m, k), n = c["x"].shape, c["w"].shape[1]
            args = (c["x"], c["w"], c["fs"], qcfg, c["gain"], c["offset"])
            chosen = cim.launch_plan(m, k, n, sms)
            want = cim._launch(*args, plan=chosen)
            chunks = k // cim.CHUNK
            splits = {1, chunks} if chunks <= cim.MAX_SPLIT else {1}
            sweep = []
            for tile_m in cim.TILE_M:
                for split in sorted(splits):
                    plan = cim.make_plan(m, n, tile_m, chosen.tile_n, split)
                    if plan.smem_bytes > cim.SMEM_LIMIT:
                        continue
                    got = cim._launch(*args, plan=plan)
                    torch.cuda.synchronize()
                    check(torch.equal(got, want),
                          f"CIM plan {plan} gives other bits than "
                          f"{chosen} at {name} of {images} images")
                    sweep.append({"tile_m": tile_m, "split": split,
                                  "blocks": plan.blocks,
                                  "ms": device_ms(lambda p=plan: cim._launch(
                                      *args, plan=p), 1000)})
            ms = {(r["tile_m"], r["split"]): r["ms"] for r in sweep}
            rows.append({"case": f"{name}_{images}", "M": m, "K": k, "N": n,
                         "chosen": chosen._asdict(),
                         "chosen_ms": ms[chosen.tile_m, chosen.split],
                         "fastest": min(sweep, key=lambda r: r["ms"]),
                         "sweep": sweep})
    emit({"cim_plans": rows, "same_bits": True,
          "timing": "device time per call, 1000 calls replayed from one "
                    "CUDA graph"})


def replay_iters(fn) -> int:
    """Calls a graph replays so that a replay takes ~20 ms (3 to 1000),
    from one timed eager call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return max(3, min(1000, int(0.02 / max(time.perf_counter() - t0,
                                           1e-6))))


def head_plan_sweep() -> list:
    """Every plan the head kernels take (``bayes.head_plans``), timed by
    graph replay, with read noise, for rank16, paper and paper with the
    ADC: at the UQ path's shape and at kernel_bench's (R=20), paper also
    at kernel_bench's R=64 (samples a block carries against its shared
    memory).  Each plan must give the bits of the plan ``head_plan``
    picks."""
    import torch
    from repro_torch.kernels import bayes
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for shape_name, shape, r, cases in (
            ("path", SAR_HEAD, UQ_R, ("rank16", "paper", "paper_adc")),
            ("kernel_bench", BENCH_HEAD, UQ_R,
             ("rank16", "paper", "paper_adc")),
            ("kernel_bench", BENCH_HEAD, 64, ("paper",))):
        c = head_inputs(**shape, read_sigma=0.4, r=r, seed=2)
        c["fs"] = head_full_scale(c)
        dims = (shape["b"], shape["k"], shape["n"], r)
        for case in cases:
            kind = "rank16" if case == "rank16" else "paper"
            args = (kind, c["x"], c["mu"], c["sigma"], c["sel"], c["fs"],
                    c["cfg"], 31 if case == "paper_adc" else 0, 0, 0,
                    c["sample0"])
            chosen = bayes.head_plan(kind, *dims, sms)
            want = bayes._launch(*args, plan=chosen)
            sweep = []
            for plan in bayes.head_plans(kind, *dims):
                def call(p=plan):
                    return bayes._launch(*args, plan=p)
                got = call()
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"head plan {plan} gives other bits than {chosen} "
                      f"({case} at the {shape_name} shape, R={r})")
                sweep.append({**plan._asdict(),
                              "ms": device_ms(call, replay_iters(call))})
            ms = {tuple(p[k] for k in ("tile_n", "samples", "threads")):
                  p["ms"] for p in sweep}
            rows.append({"case": case, "shape": shape_name, **shape,
                         "R": r, "chosen": chosen._asdict(),
                         "chosen_ms": ms[chosen.tile_n, chosen.samples,
                                         chosen.threads],
                         "fastest": min(sweep, key=lambda p: p["ms"]),
                         "sweep": sweep})
    emit({"head_plans": rows, "same_bits": True,
          "timing": "device time per call by CUDA graph replay"})
    return rows


def timed(kernel, plain, eager_iters: int = 200) -> dict:
    """Device ms of a kernel call and of its plain version by graph
    replay (the replayed count sized from one eager call so that a
    replay takes ~20 ms, 3 to 1000 calls), and of eager calls.  A plain
    version slower than 2 ms a call (hundreds of kernels over large
    temporaries) is timed by CUDA events over 3 eager calls instead:
    its launch overhead is then a small share."""
    import torch

    def one_call_s(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return max(time.perf_counter() - t0, 1e-6)

    def iters(t):
        return max(3, min(1000, int(0.02 / t)))
    tk, tp = one_call_s(kernel), one_call_s(plain)
    out = {"ms": device_ms(kernel, iters(tk)),
           "call_ms": call_ms(kernel, min(eager_iters, iters(tk)), warmup=5),
           "replayed_calls": iters(tk)}
    if tp < 2e-3:
        out.update(plain_ms=device_ms(plain, iters(tp)),
                   plain_timing="graph replay")
    else:
        out.update(plain_ms=call_ms(plain, 3, warmup=1),
                   plain_timing="eager calls, CUDA events")
    return out


def eps_timing() -> list[dict]:
    """Device and eager times of the ε kernel and of its plain version at
    the shapes of EPS_TIMED, each beside its bound."""
    from repro_torch.kernels import grng
    from repro_torch.kernels.bounds import grng_bound
    shapes = []
    for name in EPS_TIMED:
        c = eps_case(**EPS_CASES[name])
        t = timed(lambda: grng.grng_eps(**c),
                  lambda: grng.grng_eps_plain(**c))
        k, n, r = c["n_rows"], c["n_cols"], c["sel"].shape[0]
        shapes.append({"case": name, "K": k, "N": n, "R": r,
                       "read_sigma": c["cfg"].read_sigma,
                       "imprint": c["cfg"].imprint, **t,
                       **grng_bound(k, n, r, c["cfg"])})
        emit({"timing": "grng_eps", **shapes[-1]})
    return shapes


def head_timing(uq_launches: dict, fig9: dict, head_checks: dict,
                train: dict, trained_uq: dict) -> list[dict]:
    """The kernels-line entries of the ε and head kernels: ε at its four
    timed shapes (Fig. 9's block the headline; the training draw's
    (64, 2, R = 1) under ``train_shape``), the head kernels at
    kernel_bench's shape for every R (paper also with the ADC at R=20);
    the R=20 entry is the headline."""
    import torch
    from repro_torch.kernels import bayes
    from repro_torch.kernels.bounds import head_bound
    shapes = eps_timing()
    first = shapes[0]
    train_shape = next(t for t in shapes if t["case"] == "train_64x2_r1")
    eps_line = {
        "name": "grng_eps", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/grng_eps.cu",
        "replaces": "src/repro/kernels/clt_grng_kernel.py:103",
        "design": DESIGN["grng_eps"],
        "launches": train["full_launches"],
        "launches_on": "the training path: trained_detector() on the card, "
                       "1600 steps, one launch a step",
        "launches_by_path": {"train_full": train["full_launches"],
                             "train_short": train["short_launches"],
                             "fig9": fig9["launches"]},
        "max_abs_err": 0.0, "bit_equal": True,
        "shape": "K=256 N=256 R=8 (Fig. 9's block), ideal die; the "
                 "training draw's K=64 N=2 R=1 under 'train_shape'; the "
                 "gate die's view and kernel_bench's 512x2048 R=20 under "
                 "'shapes'",
        "train_shape": {k: train_shape[k] for k in (
            "K", "N", "R", "ms", "plain_ms", "call_ms", "bound_ms",
            "bound_by", "bound_bytes", "bound_ops")},
        **{k: first[k] for k in ("ms", "plain_ms", "call_ms",
                                 "replayed_calls", "plain_timing",
                                 "bound_ms", "bound_by", "bound_bytes",
                                 "bound_ops", "hash3_evals")},
        "kernel_ms": first["ms"], "library_ms": None,
        "library_note": "no single PyTorch call hashes the device currents",
        "timing": "ms and plain_ms: device time per call from CUDA graph "
                  "replays; call_ms: eager calls, host included",
        "shapes": shapes}
    launches = {k: uq_launches["ideal"][k] + uq_launches["gate_die"][k]
                for k in ("bayes_rank16", "bayes_paper")}
    trained = trained_uq["launches"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lines = {}
    for kind in ("rank16", "paper"):
        cases = [(kind, BENCH_HEAD, r) for r in BENCH_R]
        if kind == "paper":
            cases.append(("paper_adc", BENCH_HEAD, UQ_R))
        cases.append((kind, SAR_HEAD, UQ_R))     # the UQ path's shape
        shapes = []
        for case, shape, r in cases:
            c = head_inputs(**shape, r=r, seed=1)
            c["fs"] = head_full_scale(c)
            t = timed(lambda: head_call(case, c),
                      lambda: head_call(case, c, plain=True))
            plan = bayes.head_plan(kind, shape["b"], shape["k"], shape["n"],
                                   r, sms)
            shapes.append({"case": case, **shape, "R": r,
                           "plan": plan._asdict(), **t,
                           **head_bound(case, **shape, r=r, cfg=c["cfg"])})
            emit({"timing": f"bayes_{case}", **shapes[-1]})
        first, path = shapes[BENCH_R.index(UQ_R)], shapes[-1]
        body = 58 if kind == "rank16" else 130
        lines[kind] = {
            "name": f"bayes_{kind}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/bayes_mvm.cu",
            "replaces": f"src/repro/kernels/bayes_mvm.py:202 (mode "
                        f"'{kind}', body at :{body})",
            "design": DESIGN["bayes_head"],
            "launches": launches[f"bayes_{kind}"],
            "launches_on": "the SAR UQ path, ideal die and gate die, at "
                           "B=64 K=64 N=2 R=20",
            "launches_trained_uq": trained[f"bayes_{kind}"],
            "max_abs_err": head_checks["worst"][kind],
            "shape": f"B=8 K=512 N=2048 R={UQ_R} (kernel_bench's head); "
                     "the UQ path's B=64 K=64 N=2 R=20 under 'path'; "
                     "every R under 'shapes'",
            "plan": first["plan"],
            "ms": first["ms"], "kernel_ms": first["ms"],
            "plain_ms": first["plain_ms"], "call_ms": first["call_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "bound_bytes": first["bound_bytes"],
            "bound_ops": first["bound_ops"],
            "hash3_evals": first["hash3_evals"], "library_ms": None,
            "library_note": "no single PyTorch call hashes the device "
                            "currents into the weights it multiplies",
            "path": {k: path[k] for k in (
                "b", "k", "n", "R", "plan", "ms", "plain_ms", "call_ms",
                "bound_ms", "bound_by", "bound_bytes", "bound_ops")},
            "timing": "ms and plain_ms: device time per call from CUDA "
                      "graph replays; call_ms: eager calls, host included",
            "shapes": shapes}
    lines["paper"]["adc_code_flips"] = head_checks["flips"]
    return [eps_line, lines["rank16"], lines["paper"]]


def decision_args_work(args: dict, accumulate: bool = False) -> dict:
    """``kernels/bounds.decision_work`` of one ``decision_stats`` call's
    arguments (``accumulate``: its ``out=stats`` form)."""
    from repro_torch.kernels.bounds import decision_work
    b, n = args["y_mu"].shape
    idx = args.get("sample_idx")
    return decision_work(
        b, n, args["sel"].shape[0], int(args["mask"].sum()),
        sel_per_slot=args["sel"].ndim == 3,
        read_sigma=args["cfg"].read_sigma,
        idx_per_slot=idx is not None and idx.ndim == 2,
        rows=args.get("rows") is not None, accumulate=accumulate)


def sharded_body_timing(args: dict) -> dict:
    """``decision_stats_sharded``'s per-device body, decision.cu with
    global ``rows`` keying the read-noise hash, at the read_noise_rows
    check's shape: device ms of the kernel and its plain version by
    graph replay (1000 calls) beside the bound."""
    from repro_torch.kernels.decision import (decision_stats,
                                              decision_stats_plain)
    work = decision_args_work(args)
    return {"shape": "B=32 N=2 R=4, read_sigma 0.4, rows = slot + 1000, "
                     "half the slots masked (kernel_check "
                     "read_noise_rows)",
            "ms": device_ms(lambda: decision_stats(**args), 1000),
            "plain_ms": device_ms(lambda: decision_stats_plain(**args),
                                  1000),
            **{k: work[k] for k in ("bound_ms", "bound_by", "bound_bytes",
                                    "bound_ops")},
            "what": "one device's shard; spreading shards over devices "
                    "needs more than one GPU"}


def run_timing(inputs: dict, launches: dict, worst: float,
               cim_line: dict, head_lines: list, lm_vocab: dict,
               moe_vocab: dict, ssm_vocab: dict, xattn_vocab: dict,
               sharded_line: dict) -> None:
    from repro_torch.kernels.decision import (decision_plan, decision_stats,
                                              decision_stats_plain)
    times = {}
    for case in ("main_r4", "main_r20"):
        args = inputs[case]

        def kernel():
            return decision_stats(**args)

        def plain():
            return decision_stats_plain(**args)

        times[case] = dict(ms=device_ms(kernel, 1000),
                           plain_ms=device_ms(plain, 1000),
                           call_ms=call_ms(kernel, 1000),
                           plain_call_ms=call_ms(plain, 1000))
    plans = {case: decision_plan(inputs[case]["y_mu"].shape[1],
                                 inputs[case]["sel"].shape[0],
                                 inputs[case]["y_mu"].shape[0])._asdict()
             for case in times}
    work = decision_args_work(inputs["main_r4"])
    bound, bound_by, nbytes, ops = (work["bound_ms"], work["bound_by"],
                                    work["bound_bytes"], work["bound_ops"])
    r4, r20 = times["main_r4"], times["main_r20"]
    sharded_body = sharded_body_timing(inputs["read_noise_rows"])
    import torch
    emit({"launch_floor_ms": device_ms(lambda: torch.cuda._sleep(0), 1000),
          "what": "torch.cuda._sleep(0), a kernel that does no work, by the "
                  "same CUDA-graph replay as the kernels' ms"})
    emit({"previous_design": {
        "card": PREV_CARD,
        "what": "constants from PERF.md, not measured in this run: the "
                "previous design of each kernel at the same shapes, by "
                "CUDA-graph replay (the head kernels: their first "
                "design, r<R> at kernel_bench's head, path_r20 at the UQ "
                "path's)",
        "decision_stats_ms": PREV_DECISION_MS,
        "decision_stats_before_tiled_ms": EARLIER_DECISION_MS,
        "decision_stats_before_tiled_what": "the last build before the "
                                            "tiled variant: main_r<R> at "
                                            "the SAR shapes (small-N code "
                                            "unchanged since), lm_r<R> the "
                                            "streaming wide-N design at "
                                            "B=4 N=152064",
        "cim_mvm_ms": PREV_CIM_MS,
        **{f"{name}_ms": ms for name, ms in PREV_HEAD_MS.items()}}})
    emit({"kernels": [{
        "name": "decision_stats",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decision.cu",
        "replaces": "src/repro/kernels/decision_kernel.py:165",
        "design": DESIGN["decision_stats"],
        "plan": plans["main_r4"],
        "plan_r20": plans["main_r20"],
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": worst,
        "shape": "B=32 N=2 R=4, half the slots masked",
        "ms": r4["ms"],
        "kernel_ms": r4["ms"],
        "plain_ms": r4["plain_ms"],
        "timing": "ms and plain_ms: device time per call, 1000 calls "
                  "replayed from one CUDA graph; call_ms: eager calls, "
                  "host included",
        "call_ms": r4["call_ms"],
        "plain_call_ms": r4["plain_call_ms"],
        "bound_ms": bound,
        "bound_by": bound_by,
        "bound_bytes": nbytes,
        "bound_ops": ops,
        "library_ms": None,
        "library_note": "no single PyTorch call computes the fused "
                        "mix -> softmax -> masked statistic sums",
        "ms_r20": r20["ms"],
        "plain_ms_r20": r20["plain_ms"],
        "call_ms_r20": r20["call_ms"],
        "plain_call_ms_r20": r20["plain_call_ms"],
        "bound_ms_r20": decision_args_work(inputs["main_r20"])["bound_ms"],
        "lm_vocab": {"shape": "B=4 N=152064 (qwen3-0.6b's padded "
                              "vocabulary), every slot active, the live "
                              "operands of one token decision",
                     **lm_vocab},
        "lm_moe_vocab": moe_vocab,
        "lm_ssm_vocab": ssm_vocab,
        "lm_xattn_vocab": xattn_vocab,
        "sharded_body_rows": sharded_body,
    }, cim_line, *head_lines, sharded_line]})


def main() -> int:
    import torch
    t_script = time.perf_counter()
    walls: dict[str, float] = {}

    def lap(name: str) -> None:
        """Seconds since the previous lap (the script's start), kept
        under ``name`` for the ``script_wall_s`` line."""
        walls[name] = time.perf_counter() - t_script - sum(walls.values())

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    card = card_line()
    print(card, flush=True)            # verbatim, as nvidia-smi gives it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, _, power = card.partition(",")
    emit({"gpu": name.strip(), "power_limit": power.strip(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "device_count": torch.cuda.device_count(),
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    expected = {"bayes_mvm", "cim_mvm", "decision", "grng_eps"}
    check(set(libs) == expected,
          f"built {sorted(libs)}, expected {sorted(expected)}")
    ptxas = {n: [ln.strip() for ln in build.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln]
             for n in libs}
    emit({"build_s": build_s, "libraries": sorted(libs), "ptxas": ptxas})
    for name in NO_SPILL:
        spills = kernel_spills(build.build_log(name))
        check(spills, f"ptxas reported nothing for {name}")
        over = {fn: n for fn, n in spills.items() if n}
        check(not over, f"ptxas reports spills in {name}: {over}")

    lap("setup_and_build")
    worst, inputs = run_kernel_checks()
    cim_summary, cim_inputs = run_cim_checks()
    run_grng_checks()
    head_checks = run_head_checks()
    lap("kernel_checks")
    main_path = run_main_path()
    chip_path = run_chip_path()
    run_fixed_path()
    lap("serving_paths")
    uq_path = run_uq_path()
    fig9 = run_fig9_path()
    lap("uq_and_fig9")
    train = run_train_path()
    lap("training")
    run_trained_serving(train["params"])
    trained_uq = run_trained_uq(train["params"])
    lap("trained_serving_and_uq")
    mission_checks = run_mission_kernel_checks(train["params"])
    worst = max(worst, mission_checks["decision_max_abs_err"])
    for key, v in mission_checks["cim"].items():
        cim_summary[key] = (cim_summary[key] + v if key in
                            ("adc_code_flips", "outputs")
                            else max(cim_summary[key], v))
    run_mission_card_vs_cpu(train["params"])
    mission = run_mission_matrix(train["params"])["launches"]
    mission_orbit_cost(train["params"])
    mission_profile(train["params"])
    lap("missions")
    run_telemetry_path()
    lifetime = run_lifetime_serving(train["params"])
    aged = run_mission_lifetime(train["params"])
    worst = max(worst, aged["decision_max_abs_err"])
    lap("telemetry_and_lifetime")
    t0 = time.perf_counter()
    obs = observed_launches(run_observability())
    emit({"observability_phase_s": time.perf_counter() - t0})
    lap("observability")
    t0 = time.perf_counter()
    population = run_die_population()["launches"]
    run_granularity()
    run_moment()
    run_tiled_hoist()
    emit({"population_and_modes_phases_s": time.perf_counter() - t0})
    lap("population_and_modes")
    fleet = run_fleet_phase(train["params"])
    lap("fleet")
    lm = run_lm_serving()
    lap("lm_serving")
    moe = run_lm_moe()
    lap("lm_moe")
    ssm = run_lm_ssm()
    lap("lm_ssm")
    xattn = run_lm_xattn()
    lap("lm_xattn")
    lm_train = run_lm_train()
    lap("lm_train")
    mesh = run_mesh_phase()
    lap("mesh")
    cim_plan_sweep(cim_inputs)
    head_plan_sweep()
    heads = head_timing(uq_path["launches"], fig9, head_checks, train,
                        trained_uq)
    heads[0]["launches_by_path"].update(
        {f"lm_train/{a}": m["eps_launches"]
         for a, m in lm_train["models"].items()})
    heads[0]["lm_train_vocab"] = {a: m["eps"]
                                  for a, m in lm_train["models"].items()}
    heads[0]["launches_by_path"]["mesh_train/qwen3-0.6b"] = mesh["train"][
        "eps_launches"]
    heads[0]["mesh_train_vocab"] = mesh["train"]["eps"]
    heads[0]["mesh_train_vocab_what"] = (
        "the mesh train step's head draw (train(mesh_shape=...) on (1, 1) "
        "and (2, 2) of cuda:0, explicit TP off and on), recorded, one "
        "launch a step on the mesh's first device; bit-equal to the plain "
        "version on its first, middle and last column blocks")
    heads[0]["lm_train_vocab_what"] = (
        "the LM trainer's head draw at full width, [d_model, vocab_padded] "
        "R = 1, one launch a step of launch.train.train; bit-equal to the "
        "plain version on its first, middle and last column blocks; the "
        "plain version timed over the whole block in column blocks")
    heads[1]["launches_lifetime_static_arms"] = lifetime["rank16_launches"]
    heads[1]["launches_mesh_prefill_decode"] = mesh["rank16_launches"]
    heads[1]["mesh_prefill_decode_what"] = (
        "mesh_prefill_step / mesh_decode_step on (2, 2) of cuda:0 (mixtral "
        "4 of 32 layers: a prefill; qwen3-0.6b: a prefill and 2 decode "
        "steps), one launch a step on the rows' gathered hidden states; "
        "each launch held to the plain version on its own operands")
    heads[1]["max_abs_err"] = max(heads[1]["max_abs_err"],
                                  lifetime["rank16_checks"]["max_abs_err"],
                                  lm["checks"]["head_max_abs_err"],
                                  *(m["head_max_abs_err"]
                                    for m in (*moe["models"].values(),
                                              *ssm["models"].values(),
                                              *xattn["models"].values())),
                                  mesh["head_max_abs_err"])
    lm_times = lm_timing(lm)
    heads[1]["launches_lm_decode_step"] = 1
    heads[1]["lm_decode_step"] = {
        **lm_times["rank16"],
        "max_abs_err": lm["checks"]["head_max_abs_err"],
        "what": "qwen3-0.6b's vocabulary head at decode_step's shape, "
                "bf16 operands widened by the wrapper"}
    heads[1]["launches_lm_moe_decode_step"] = len(MOE)
    heads[1]["lm_moe_decode_step"] = {
        a: {**m["times"]["rank16"], "max_abs_err": m["head_max_abs_err"]}
        for a, m in moe["models"].items()}
    heads[1]["lm_moe_decode_step_what"] = (
        "each MoE config's vocabulary head at decode_step's shape, bf16 "
        "operands widened by the wrapper; one launch a config")
    heads[1]["launches_lm_ssm_decode_step"] = len(SSM)
    heads[1]["lm_ssm_decode_step"] = {
        a: {**m["times"]["rank16"], "max_abs_err": m["head_max_abs_err"]}
        for a, m in ssm["models"].items()}
    heads[1]["lm_ssm_decode_step_what"] = (
        "each SSM config's vocabulary head at decode_step_ssm's shape "
        "(SSM's depths), bf16 operands widened by the wrapper; one launch "
        "a config")
    heads[1]["launches_lm_xattn_decode_step"] = len(XATTN)
    heads[1]["lm_xattn_decode_step"] = {
        a: {**m["times"]["rank16"], "max_abs_err": m["head_max_abs_err"]}
        for a, m in xattn["models"].items()}
    heads[1]["lm_xattn_decode_step_what"] = (
        "each audio/VLM config's vocabulary head at decode_step's shape "
        "(XATTN's depths), bf16 operands widened by the wrapper; one "
        "launch a config")
    run_timing(inputs, {"serve_sar": main_path["launches"],
                        "mission_matrix": mission["decision"],
                        "serve_sar_lifetime": lifetime["launches"]
                        ["decision"],
                        "mission_aged_arms": aged["launches"]["decision"],
                        "observability": obs["decision"],
                        "die_population": population["decision"],
                        **fleet["decision_launches"],
                        "lm_serving": lm["launches"],
                        **{f"lm_moe/{a}": m["launches"]
                           for a, m in moe["models"].items()},
                        **{f"lm_ssm/{a}": m["launches"]
                           for a, m in ssm["models"].items()},
                        **{f"lm_xattn/{a}": m["launches"]
                           for a, m in xattn["models"].items()}},
               max(worst, lm["checks"]["decision_max_abs_err"],
                   *(m["decision_max_abs_err"]
                     for m in (*moe["models"].values(),
                               *ssm["models"].values(),
                               *xattn["models"].values()))),
               cim_timing(cim_inputs,
                          {"serve_sar(chip_instance=gate die)":
                           chip_path["launches"],
                           "mission_matrix": mission["cim"],
                           "serve_sar_lifetime": lifetime["launches"]["cim"],
                           "mission_aged_arms": aged["launches"]["cim"],
                           "observability": obs["cim"],
                           "die_population": population["cim"],
                           "serve_sar_fleet": fleet["cim_launches"]},
                          cim_summary),
               heads, lm_times["decision"],
               {a: {"shape": m["shape"], **m["times"]["decision"]}
                for a, m in moe["models"].items()},
               {a: {"shape": m["shape"], **m["times"]["decision"]}
                for a, m in ssm["models"].items()},
               {a: {"shape": m["shape"], **m["times"]["decision"]}
                for a, m in xattn["models"].items()},
               fleet["kernel"])
    lap("plan_sweeps_and_timing")
    emit({"script_wall_s": time.perf_counter() - t_script,
          "phase_walls_s": walls, "card": card,
          "limit_s": 1200, "target_s": 950})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA package on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

Needs one CUDA device, nvcc and no arguments. Imports nothing of JAX and
nothing of the JAX package. Phases, one JSON line each; any failure ends the
run with a non-zero exit code (nothing drops to the CPU or to a plain version):

  env      versions, the card's name and power limit, the driver version
           and the GPU's UUID
  build    nvcc over src/repro_torch/kernels/csrc/*.cu, loaded with ctypes
  kernels  each hand-written kernel against its plain PyTorch version on the
           card, fp32 and bf16, with times (on the card, from a CUDA graph's
           replay; and issued eagerly, host included), the card's bound and a
           library call's time as a yardstick; the embedding-bag backward
           also per stage, and at its two main shapes (uniform and Zipf
           indices) three calls that must agree bitwise; the attention and
           RMSNorm backwards the same, three calls at each main shape, and
           the kernels a call launched, counted in a trace, as planned; the
           attention backward and its forward (the log-sum-exp) at head_dim
           160 too: zamba2-2.7b's training layer (the train_zamba phase's,
           with each fused SDPA backend alone beside it), a ragged tile and
           a GQA group not causal, each three bitwise-equal calls;
           seamless-m4t-large-v2's cross-attention at a rank's heads in
           parallel_gloo_split (512 query rows over 1,024 keys, not
           causal), three bitwise-equal calls; the reduced configs' head_dim
           16 (serve_reduced): their decode tick (4 slots, 4 heads over 2,
           128 keys; and 512) with both decode kernels held and timed at
           every cluster, a ragged prefill, a 5-token prompt and the partial
           route over a rank's block of 128 keys, and their RMSNorm at
           d_model 64 (the tick, the prefill, and forward and backward at
           torch_train_lm.py's 8 x 128 rows); the SSD scan's backward at
           mamba2-780m's training layer (the
           train_mamba phase's), zamba2-2.7b's layer and a ragged grouped
           case with the final state's cotangent, fp32 and bf16, each with
           its launch plan, every stage's time alone and three
           bitwise-equal calls; the split sequence's inputs: the attention
           forward (with the log-sum-exp) and backward with q_offset, a
           rank's block of a two-rank split (half the rows over all the
           keys) at the train_lm layer and at train_zamba's (32 heads of
           160), rank 1's, a ragged length and (train_lm) rank 0's, whose
           later keys must get zero gradients, three bitwise-equal
           backward calls each; the SSD scan's forward, training forward
           and backward from an init_state at the train_mamba layer, the
           initial state's cotangent among the gradients
  repeats  100 calls each of the attention forward (with the log-sum-exp)
           and backward at the train_lm layer and at a chatglm3-like layer,
           of the RMSNorm backward at the train_lm rows and of the SSD scan
           backward at the train_mamba layer, fp32 and bf16, and of the
           attention both ways at the train_zamba layer (head_dim 160), fp32:
           the calls whose bits differ from the first call's, which must be
           none (with the env phase's driver version and GPU UUID, this ties
           a recurrence of an unequal repeat to a machine)
  serve    smollm-135m at full width and depth, bf16, random weights from a
           seed: the continuous-batching engine answers 16 requests through
           8 slots; launch counters show that the run went through the
           kernels; the requests each tick admits and the active slots at
           each decode step, tick for tick, equal to COMET's analytic
           engine schedule (repro_torch.serving.ServingWorkload.
           engine_schedule: schedule_equal); then the kernel path against
           the plain path in fp32 on the same weights
  profile  a few decode ticks under torch.profiler: the device's busy share
  serve_mamba, profile_mamba
           the same for mamba2-780m at full width and depth (prefill through
           the SSD scan's stage kernels, every norm through the RMSNorm
           kernel); profile_mamba also traces one 1024-token prefill and
           reports the scan's share of its device time
  serve_moe, profile_moe
           the same for granite-moe-3b-a800m at full width and depth (32
           layers, 24 / 8 heads of 64, 40 experts top-8, weights drawn on
           the card): attention and RMSNorm through the kernels at its
           shapes, the experts as batched products
  serve_zamba, profile_zamba
           the same for zamba2-2.7b at full width and depth (54 Mamba2
           layers, the one shared attention block after every 6th: 32 heads
           of 160 on concat(h, emb0), weights drawn on the card): the scan in
           every layer of a prefill, attention at head_dim 160 in every
           application of the shared block
  serve_encdec
           seamless-m4t-large-v2 at full width and depth (24 + 24 layers,
           d 1024, vocabulary 258,048), bf16, weights drawn on the card: a
           batch of 8 sources of 1024 frames from a seeded generator, 64-token
           prompts, one prefill and 32 greedy ticks called directly (the
           engine takes no frames); non-causal encoder and cross-attention
           through the kernels; launches checked, the ticks profiled; then
           the kernel path against the plain path in fp32
  serve_reduced
           python -m repro_torch.launch.serve --arch <a> --reduced (its main)
           for the nine archs it serves (smollm-135m, mamba2-780m,
           granite-moe-3b-a800m, llama4-maverick-400b-a17b, internvl2-76b,
           zamba2-2.7b, chatglm3-6b, internlm2-20b, minitron-8b), fp32 and
           bf16, head_dim 16 through every attention route: tokens/s and
           seconds a run; fp32 greedy tokens against the same command on the
           CPU (a difference fails where the CPU's top-2 logit gap there is
           wider than 1e-4); then examples/torch_serve_lm.py (batched ==
           solo decoding) and examples/torch_train_lm.py (300 steps, the loss
           below 7) on the card
  train_dlrm
           dlrm-1.2t at every published width, tables cut to 200,000 rows,
           fp32, weights from a seed: 20 training steps (loss -> backward ->
           AdamW) on batches of 4096 from the port's data pipeline, through
           the embedding-bag forward and backward kernels once each a step;
           then two steps under torch.profiler
  train_dlrm_check
           one step of the kernel path against the plain path, fp32, on the
           same weights and batch: loss, logits, gradients, updated weights
  train_lm smollm-135m at full width and depth, fp32 as launch.train trains
           it, weights from a seed: the training entry point's own objects
           (init_train_state, make_train_step, Trainer, DataIterator) take
           2 warm-up and 20 timed steps on batches of 8 x 2048 tokens, with
           the memory plan's remat ("dots"), through the attention and RMSNorm
           kernels in both directions; launches held to the count reckoned
           from the layers and the policy; then 2 steps under torch.profiler,
           whose attention and RMSNorm-backward kernels must be as the
           counts reckon
  train_lm_check
           one step of a 2-layer, full-width smollm through the kernels and
           through the plain versions (autograd) on the same weights and
           batch, fp32 and bf16: loss, grad norm, every gradient leaf
  train_mamba
           mamba2-780m at full width and depth, fp32 as launch.train trains
           it, weights from a seed: the training entry point's objects take
           2 warm-up and 5 timed steps on batches of 8 x 2048 tokens, with
           the memory plan's remat ("dots"), through the SSD scan's forward
           and backward kernels and the RMSNorm kernels both ways; launches
           held to the count reckoned from the layers and the policy; peak
           memory beside the plan's and a reckoning; then one step under
           torch.profiler: device ms, idle share, the SSD backward's share,
           its kernels and the forward's as the counts reckon
  train_mamba_check
           one step of a 2-layer, full-width mamba2 through the kernels and
           through the plain versions (autograd) with the scan in float64,
           fp32 elsewhere: loss, grad norm, every gradient leaf (a leaf may
           miss by up to twice what the plain versions in fp32 miss it by)
  train_zamba
           zamba2-2.7b at full width and depth (54 Mamba2 layers, the shared
           block's 32 heads of 160 after every 6th), fp32 as launch.train
           trains it, weights from a seed, the memory plan (ZeRO-1, fp32 Adam
           with master, remat "dots"): 2 warm-up and 5 timed steps on
           batches of 3 x 2048 tokens (the batch cut to fit the card), through
           the attention kernels both ways at head_dim 160, the SSD scan's
           and the RMSNorm kernels both ways; launches held to the count
           reckoned from the layers, the shared block's 9 calls and the
           policy; peak memory beside the plan's and a reckoning; one step
           under torch.profiler: device ms, idle share, the attention and
           SSD backwards' shares, the attention backward's kernels as its
           plan reckons
  train_zamba_check
           one step of 4 full-width zamba2 layers with the shared block after
           every 2nd through the kernels and through the plain versions with
           the scan in float64, as train_mamba_check holds mamba2
  checkpoint
           the train_lm configuration again: 6 steps straight against 3
           steps that checkpoint (the trainer's async save, in the JAX
           package's format, to a temporary directory) and a new Trainer
           that resumes and takes 3 more; every leaf of params, m, v and
           the step bitwise equal; the state's bytes, the save's ms on the
           loop, the writer thread's seconds, the restore's ms
  parallel the distribution layer: a one-rank NCCL group and a (1 data,
           1 model) mesh; 3 sharded_train_steps of full-width smollm-135m
           (fp32, train_lm's 8 x 2048 tokens) against 3 make_train_steps
           from the same state, every collective an identity: metrics and
           every leaf of params, m, v and master bitwise equal; both step
           times, the NCCL kernels' share of a profiled step's device time;
           compressed_psum over 64 MiB on NCCL (ms, bytes, error); then two
           processes on the card over gloo with CUDA tensors: the (1, 2) and
           (2, 1) sharded steps against one process (loss, global norm,
           params, m, v, master), which must pass, and the (1, 2) step with
           attn_batch_shard (the 9 heads replicated over the model axis,
           each rank attending over its row of the 2) against one process
           and the unsplit (1, 2) step: loss, first moments, parameters,
           each rank's launches equal to the unsplit step's; every step's
           ms. gpipe is not run here:
           gloo's point-to-point sends refuse CUDA tensors, so it is held
           on the CPU (tests/test_torch_distributed.py)
  parallel_gloo_ssm
           the ssm and hybrid families split over the model axis on two
           processes over gloo: mamba2-780m and zamba2-2.7b at full width,
           4 and 6 layers (zamba2's shared block once), one (1 data, 2
           model) sharded step of 2 x 512 tokens against make_train_step
           under parallel_gloo's tolerances, every kernel launch as
           reckoned (the gated norm's split row leaves the RMSNorm kernel)
           and the SSD kernels at 24 / 40 heads, attention at 16 heads of
           160, seen by shape; both steps' ms once warm; then split serving
           in bf16 (a prefill of 2 x 128 tokens, 3 greedy ticks) against
           the whole model: every call's logits, the picks equal but at a
           tie
  parallel_gloo_split
           the encoder-decoder and the VLM split over the model axis on two
           processes over gloo, (1 data, 2 model), full width:
           seamless-m4t-large-v2 at 4 + 4 layers, one sharded step of 2 x
           512 target tokens over 1,024 source frames against
           make_train_step (parallel_gloo_ssm's checks, every launch as
           reckoned, the cross-attention's kernels at 8 heads, 512 rows
           over 1,024 keys, seen by shape), then split serving bf16 and
           fp32 (2 x 64 tokens over 1,024 frames, 3 greedy ticks; the
           cross K/V cache at 8 heads a rank) against the whole model;
           internvl2-76b at 2 layers, split serving alone (2 x 64 tokens
           behind 256 patches; its split step does not fit the card)
  parallel_gloo_moe
           the MoE split over the model axis and routed over the data axis
           on two processes over gloo: granite-moe-3b-a800m at full width,
           2 of 32 layers, fp32; a (1 data, 2 model) step with 20 of the 40
           experts a rank (EP) and a (2 data, 1 model) step routing the
           global microbatch, each of 2 x 512 tokens against
           make_train_step (parallel_gloo_ssm's checks, every launch as
           reckoned, the auxiliary loss within 1e-5 relative, each
           layer's capacity drops equal), then split serving at (1, 2)
           bf16 and fp32 against the whole model
  parallel_gloo_seq
           a train step and a prefill with each row's sequence split over
           the data ranks, on two processes over gloo at (2 data, 1 model),
           full width: zamba2-2.7b and smollm-135m at 6 layers each, one
           fp32 step of one row of 4,096 tokens each against
           make_train_step (parallel_gloo_ssm's checks, every launch as
           reckoned: every scan twice, attention with q_offset and the scan
           from an init_state seen by shape); zamba2's prefill of one row
           of 32,768 tokens into a cache split along its sequence and 3
           greedy ticks, bf16 and fp32, against the whole model: the
           logits, both ranks' prefill logits bitwise, the K/V rows, SSM
           states and conv tails; the phase's seconds
  dryrun   COMET's measured frontend: (a) the op counter
           (repro_torch.core.op_counter) over the train_lm step, a smollm
           prefill (b 1, s 1024) and a decode tick (b 8, max_seq 2048,
           bf16), each counted on the card and on ``meta`` (FLOPs, bytes
           and collective bytes must be equal), its roofline terms at the
           H100's rates beside the measured wall and device ms, and the
           counted peak live bytes beside torch.cuda.max_memory_allocated;
           the host cost of a call by each dispatcher route, and the
           kernels' operators against direct launches on the decode tick,
           alternating; (b) launch.dryrun.lower_cell over the 32 runnable
           cells on each of the 16 x 16 and 2 x 16 x 16 meshes, on the
           host, as rank 0 of a fake process group, in six spawned
           processes side by side (no group may be held then): every cell
           ok
  study    COMET's batch evaluator (repro_torch.core: the port of the JAX
           package's jax_engine) over the paper's transformer-1t study grid:
           the paper shape (seq 2048, batch 1024), strategies (mp, dp) =
           (64, 16), (16, 64), (8, 128) and (mp 16, dp 16, pp 4), each over
           4,096 DGX-A100 environments (peak_flops, local_bw and intra_bw
           each scaled by 0.5 + 0.25 i, i = 0..15): time_compiled on the card
           against the same on the CPU, every field of every cell within
           1e-9 relative (abs 1e-12), two card calls bitwise equal; each
           strategy's path, wall ms on both, and the split of the card call
           (comm_matrix, the device call, the breakdowns' assembly), its
           device ms and launches (torch.profiler) and idle share; then
           stage_compute_exposed alone at 4,096 and 32,768 environments, and
           the event walk against the closed form on one full-size stage.
           It launches none of the hand-written kernels (their counts are
           read after it: all 0)
  run_study
           COMET's study runner (repro_torch.core.study.run_study) over the
           paper's case studies at their defaults: figure_studies() (fig8 to
           fig13b), both cluster_comparison_studies (transformer-1t at seq
           2048, batch 1024 over the Table III clusters; the DLRM at batch
           4096), pp_ep_study, placement_study, multi_tenant_study and
           hetero_cost_study. Each spec on the card against the same on the
           CPU (same keys and types, the same non-float values, every float
           within 1e-9 relative), two card runs equal, cells and feasible
           cells, wall ms on both (median of 3), device ms, launches and idle
           share of one profiled run; placement_study's cells on the
           assigned pipeline. Then the study phase's grid through the runner:
           12,288 cells (three scale axes of 16 values over the DGX-A100
           baseline x (64, 16), (16, 64), (8, 128)), every cell's breakdown
           equal to time_compiled's for its environment, the wall split into
           the cells' enumeration (_cells), the prefetch (time_compiled) and
           the record assembly (_eval_cell) on the card and on the CPU. Every
           run_study call here pays the static pre-flight (validate="warn",
           the default). Then the paper's figure API, each call twice on the
           card and once on the CPU: cluster_comparison at the paper claims'
           settings (transformer-1t at seq 2048, batch 1024; the DLRM at
           batch 65,536; the 11 Table III clusters; A0/B1 for transformer-1t
           printed), the Fig. 8-13 wrappers at their defaults,
           pareto_frontier, and successive_halving and evolutionary_search
           (seed 0) over hetero_cost_study at the pareto shape: every output
           within 1e-9 relative of the CPU's, two card runs equal, the same
           frontier, survivors and trace order, and the cells tied to the
           bit on the CPU tied to the bit on the card. Then the serving and
           reliability studies: serving_ranking() at its defaults (18
           cells, 3,000 requests each; host code, run once: every cell
           feasible, disaggregated ahead at the top rate);
           reliability_ranking() and reliability_headline() (the
           Young-Daly columns over two cluster shapes) twice on the card
           and once on the CPU, records within
           1e-9 relative, the card runs equal, the headline's picks, flip
           and Daly-vs-naive ratio equal; the block's seconds. Then the
           fleet timeline (run_study_fleet): fleet_ranking() (12 jobs on a
           Poisson trace over the mixed EM/plain fleet; static, elastic,
           elastic+burst) and reliability_fleet_ranking() (wait vs shrink
           after an injected failure), each twice on the card and once on
           the CPU: the width profiles timed on the run's device, the
           timeline on the host; the policies' order, records within 1e-9
           relative, the card runs equal, the event counts equal, the
           headlines equal (elastic+burst >= 1.3x over static, shrink
           ahead of wait); the block's seconds. Before the serving block,
           validate="error" over the 13 studies above, the search's and
           the serving, reliability and fleet studies (none may raise or
           warn), its milliseconds on a line of its own. Then the
           process pool (run_study_pool, ROADMAP item 22) over the grid,
           after CUDA is initialised in this process: the CPU's serial run
           against processes=min(8, cores) on the CPU (records equal as
           text, both ms, the workers), and processes=2 on the card (one
           warning, the card's serial records: no fork there).
           Hand-written kernels: 0 launches

The last three lines are the card as nvidia-smi names it, one JSON object
describing every kernel, and the verdict.

fp32 comparisons run with TF32 switched off
(``torch.backends.cuda.matmul.allow_tf32 = False``, and for cuDNN too), so the
plain version's products are full fp32, as the kernels' are (on the fp32
pipes, or as 3xTF32 on the tensor cores).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib.util
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import (  # noqa: E402
    ShapeConfig,
    all_cells,
    get_config,
    get_dlrm_config,
)
from repro_torch.core import dse, search, study, torch_engine  # noqa: E402
from repro_torch.core.cluster import BASELINE_DGX_A100  # noqa: E402
from repro_torch.core.simulator import time_compiled  # noqa: E402
from repro_torch.core.study import (  # noqa: E402
    Axis,
    ExplicitSpace,
    ParallelSpec,
    StudySpec,
    run_study,
)
from repro_torch.core.hlo import PEAK_FLOPS as HLO_PEAK  # noqa: E402
from repro_torch.core.hlo import (  # noqa: E402
    model_flops_util,
    terms_from_counts,
)
from repro_torch.core.op_counter import OpCounter  # noqa: E402
from repro_torch.core.workload import decompose  # noqa: E402
from repro_torch.data import DataConfig, DataIterator, dlrm_batch  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import embedding_bag as bag_module  # noqa: E402
from repro_torch.kernels import flash_attention as attn_module  # noqa: E402
from repro_torch.kernels.embedding_bag import (  # noqa: E402
    BACKWARD_STAGES,
    EmbeddingBagPlain,
    backward_kernels_per_call,
    embedding_bag_backward_buffers,
    embedding_bag_backward_cuda,
    embedding_bag_backward_plain,
    embedding_bag_backward_stages_cuda,
    embedding_bag_cuda,
    embedding_bag_plain,
)
from repro_torch.kernels import rmsnorm as rms_module  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_module  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    DECODE_CLUSTERS,
    decode_cluster_fits,
    flash_attention_backward_cuda,
    flash_attention_backward_plan,
    flash_attention_backward_plain,
    flash_attention_cuda,
    flash_attention_forward_plain,
    flash_attention_lse_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.rmsnorm import (  # noqa: E402
    rmsnorm_backward_cuda,
    rmsnorm_backward_plain,
    rmsnorm_cuda,
    rmsnorm_plain,
)
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    KERNELS_PER_CALL,
    STAGES,
    ssd_buffers,
    ssd_scan_plain,
    ssd_stages_cuda,
)
from repro_torch.models import common as model_common  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.dlrm import DLRM  # noqa: E402
from repro_torch.parallel import build_mesh, dp_axes, plan_memory  # noqa: E402
from repro_torch.launch import serve as serve_module  # noqa: E402
from repro_torch.launch.dryrun import run_cell  # noqa: E402
from repro_torch.launch.specs import abstract_model, model_flops  # noqa: E402
from repro_torch.parallel import tensor as tensor_module  # noqa: E402
from repro_torch.parallel.compression import compressed_psum  # noqa: E402
from repro_torch.parallel.sharding import (  # noqa: E402
    SEQ_SPLIT,
    Placement,
    all_gather_stacked,
    batch_spec,
    cache_shardings,
    gather_full,
    local_shard,
    shard_cache,
    shard_shape,
    split_caches,
)
from repro_torch.serve import Engine, EngineConfig, Request  # noqa: E402
from repro_torch.serving import ServingModel, ServingWorkload  # noqa: E402
from repro_torch.train import (  # noqa: E402
    Trainer,
    TrainerConfig,
    gather_train_state,
    init_train_state,
    make_train_step,
    shard_model,
    shard_train_state,
    sharded_train_step,
)
from repro_torch.train import train_step as train_step_module  # noqa: E402
from repro_torch.train.optimizer import (  # noqa: E402
    AdamWConfig,
    apply_updates,
    init_state,
)

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12,   # tensor cores
              torch.float32: 67e12}     # fp32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12                # TF32 on the tensor cores
# A matrix product's bound takes the fastest way the card computes it to the
# input type's accuracy: bf16 on the tensor cores; fp32 as three TF32
# products on the tensor cores (3xTF32: hi hi + hi lo + lo hi), 165 TFLOP/s,
# faster than the fp32 pipes' 67.
PRODUCT_FLOPS = {torch.bfloat16: PEAK_FLOPS[torch.bfloat16],
                 torch.float32: max(PEAK_FLOPS[torch.float32],
                                    PEAK_TF32_FLOPS / 3)}
L2_BYTES = 50 * 2 ** 20

ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
LOGIT_TOL = 2e-3    # fp32 logits, kernel path against plain path
# SSD scan: max |kernel - plain| over y and over the final state, each against
# its own scale max(1, max |plain|). fp32: both sum the same terms in another
# order; the decays exp(cs_i - cs_j) carry the rounding of cumsums that reach
# |cs| ~ Q * |dt * A|, i.e. ~1e-5 of the output's scale. bf16: y is rounded
# to bf16 once on each side, one ulp is up to 2^-7 of |y|.
SSD_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SSD_NO_LIBRARY = "no single PyTorch call computes the SSD scan"

# DLRM training: dlrm-1.2t at every published width, the tables cut from
# 146,484,375 rows to 200,000 (6.55 GB of fp32 tables; the whole model's 1.2e12
# parameters fit no card); global batch 4096; launch/train.py's learning rate.
DLRM_ROWS = 200_000
DLRM_BATCH = 4096
DLRM_STEPS = 20
DLRM_OPT = dict(lr=3e-3, warmup_steps=2, total_steps=20, use_master=False)
DLRM_SAMPLE_BAGS = 64   # bags whose table rows the kernel-vs-plain step reads
ZIPF_ALPHA = 1.05       # the skewed bag case: row k of a table drawn ~ k^-1.05
BAG_REPEATS = 3         # backward calls at a main shape that must agree bitwise

# The backwards: each gradient's max |kernel - plain| against its own
# largest magnitude (fp32: the same sums in another order; bf16: each result
# rounded once to bf16 on both sides, and the kernel's forward rounds P with
# the tensor cores' exp2 where the plain version uses softmax).
BWD_TOL = {"flash_attention_backward": {torch.float32: 2e-5,
                                        torch.bfloat16: 3e-2},
           "rmsnorm_backward": {torch.float32: 1e-5, torch.bfloat16: 1e-2},
           # the SSD scan: fp32, the same sums in another order, and decays
           # exp(cs_i - cs_j) from cumsums taken in another order (|cs| up
           # to Q |dt A|): ~1e-5 of the scale at a chunk of 256; bf16: dx,
           # dB and dC rounded once to bf16 on each side
           "ssd_scan_backward": {torch.float32: 1e-4, torch.bfloat16: 1e-2}}
SSD_BWD_NO_LIBRARY = "no single PyTorch call computes the SSD scan's gradient"
GRADS_SSD = ("dx", "ddt", "dA", "dB", "dC")
BWD_REPEATS = 3         # backward calls at a main shape that must agree bitwise
REPEAT_CALLS = 100      # the repeats phase: calls at each shape, all bitwise equal
# torch.profiler loses a trace's kernel events now and then, in bursts of
# consecutive traces (trace_loss.py counts them). trace_ms takes a trace
# again while events are lost, waiting longer each time so that the next
# one falls outside the burst.
TRACE_TRIES = 8         # traces trace_ms takes of a call while events are lost
TRACE_PAUSE_S = 0.25    # the wait before the n-th retry is n times this
# The training route's forward (output and the rows' log-sum-exp) against
# the plain forward: the output to the forward cases' ATTN_TOL (absolute);
# the log-sum-exp, in nats, to LSE_TOL of max(1, its largest magnitude) (the
# same fp32 sums of exact products in another order, exp2 on the card).
LSE_TOL = 1e-4
# The partial route (serving over a block of a split cache) against its plain
# version: the largest output difference as a share of the plain output's
# largest magnitude. Unit-normal q and k at d 160 give scores of about N(0,
# 1), so each row averages V over ~10^5 keys of a block of 262,144 and its
# output is ~1e-3: an absolute ATTN_TOL would pass a kernel that wrote
# zeros. bf16: P rounded to bf16 for the MMA, ~2^-9 / sqrt(3) of each term,
# about 1e-3 of the output; fp32: the same sums in another order.
PARTIAL_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}

# Dense-LM training: smollm-135m at full width and depth, fp32 parameters as
# launch.train makes them, 8 sequences of SmolLM's 2048-token context a
# step, launch.train's learning rate with a 2-step warmup.
LM_ARCH = "smollm-135m"
LM_BATCH, LM_SEQ = 8, 2048
LM_WARMUP, LM_STEPS, LM_PROFILED = 2, 20, 2
LM_LR = 3e-3
# The check: 2 layers at full width, one step, kernel route against plain
# route (autograd through the plain versions) on the card. fp32: the CPU
# tests' tolerances against the JAX package (loss 1e-5 relative, each
# gradient leaf 1e-4 of its largest magnitude, and the grad norm 1e-4). bf16:
# both routes round every activation to bf16, in other places (the kernels
# round once from fp32 registers, the plain versions after each PyTorch
# op), so an activation may differ by a bf16 ulp (2^-8 relative) in each of
# the ~20 roundings between a leaf and the loss: loss 1e-2 relative, each
# leaf 5e-2 of its largest magnitude, the grad norm 2e-2.
LM_CHECK_LAYERS, LM_CHECK_BATCH, LM_CHECK_SEQ = 2, 4, 1024
LM_CHECK_TOL = {torch.float32: {"loss": 1e-5, "grads": 1e-4, "grad_norm": 1e-4},
                torch.bfloat16: {"loss": 1e-2, "grads": 5e-2,
                                 "grad_norm": 2e-2}}

# mamba2 training: mamba2-780m at full width and depth, fp32 parameters as
# launch.train makes them, launch.train's --global-batch 8 --seq-len 2048 and
# learning rate, a 2-step warmup. The check: 2 layers at full width, one
# step, kernel route against plain route (autograd through ssd_scan_plain and
# rmsnorm_plain), fp32, at the CPU tests' tolerances against the JAX package.
MAMBA_ARCH = "mamba2-780m"
MAMBA_BATCH, MAMBA_SEQ = 8, 2048
MAMBA_WARMUP, MAMBA_STEPS, MAMBA_PROFILED = 2, 5, 1
MAMBA_CHECK_LAYERS, MAMBA_CHECK_BATCH, MAMBA_CHECK_SEQ = 2, 4, 1024
MAMBA_CHECK_TOL = LM_CHECK_TOL[torch.float32]

# Serving a MoE: granite-moe-3b-a800m at full width and depth (32 layers,
# 40 experts of d_ff 512, top-8), bf16, weights from seed 0 drawn on the card.
MOE_ARCH = "granite-moe-3b-a800m"

# Serving the hybrid: zamba2-2.7b at full width and depth (54 Mamba2 layers,
# the shared attention block after every 6th: 32 heads of 160), bf16,
# weights from seed 0 drawn on the card, through the engine as above.
ZAMBA_ARCH = "zamba2-2.7b"
# Training it: full width and depth, fp32 parameters as launch.train makes
# them, the memory plan (ZeRO-1, fp32 Adam with master: 48.2 GB of state),
# sequences of 2048 tokens, launch.train's learning rate, a 2-step warmup.
# The batch is cut from launch.train's 8 rows to 3, the most that fits the
# card: what remat "dots" keeps is some 4.6 MB a token (54 layers'
# projections, the shared block's nine calls, the logits), and 4 rows ran
# out of the card's memory.
# The check: 4 full-width layers with the shared block after every 2nd (two
# calls of it), one step, the kernel route against the plain route with the
# scan in float64, under train_mamba_check's rule.
ZAMBA_BATCH, ZAMBA_SEQ = 3, 2048
ZAMBA_WARMUP, ZAMBA_STEPS, ZAMBA_PROFILED = 2, 5, 1
ZAMBA_CHECK_LAYERS, ZAMBA_CHECK_EVERY = 4, 2
ZAMBA_CHECK_BATCH, ZAMBA_CHECK_SEQ = 4, 1024

# Checkpoint and resume: the train_lm configuration (full-width smollm-135m,
# fp32, 8 x 2048 tokens a step), 2 * CKPT_K steps straight against CKPT_K
# steps that checkpoint at CKPT_K, then a new Trainer that resumes from the
# checkpoint and takes CKPT_K more; every leaf must agree bit for bit.
CKPT_K = 3

# The study grid of the analytic evaluator: the paper's transformer-1t
# (§V-B) at its training shape, the strategies of the repo's own grid
# (benchmarks/run.py, _jax_grid_trajectory) and one pipeline strategy, over
# STUDY_STEPS^3 environments of the paper's DGX-A100 baseline (Table I).
STUDY_ARCH = "transformer-1t"
STUDY_SHAPE = ShapeConfig("paper", 2048, 1024, "train")
STUDY_STRATEGIES = ((64, 16, 1), (16, 64, 1), (8, 128, 1), (16, 16, 4))
STUDY_STEPS, STUDY_BIG_STEPS = 16, 32          # 4,096 and 32,768 environments
STUDY_REL, STUDY_ABS = 1e-9, 1e-12
STUDY_REPS = 3                                 # timed calls, median kept
DLRM_STUDY_BATCH = 4096                        # fig15's DLRM global batch
PAPER_DLRM_BATCH = 65536                       # the paper claims' DLRM batch
PARETO_SHAPE = ShapeConfig("pareto", 2048, 1024, "train")
TIE_COLUMNS = ("total", "tco", "energy_usd")   # the search's objectives

DEVICE = "cuda"
_STARTED = time.perf_counter()


def bound(flops: int, nbytes: int, peak_flops: float) -> dict:
    """The least time the card takes for a call's work (a kernel module's
    ``*work`` formula): the larger of its bytes over the memory rate and
    its flops over ``peak_flops``, and which of the two it is."""
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = flops / peak_flops * 1e3
    return {"bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations"}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - _STARTED}),
          flush=True)


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


# ------------------------------------------------------------------------- #
# Timing
# ------------------------------------------------------------------------- #

def time_ms(fn, arg_sets, iters: int = 50, graph: bool = True) -> dict:
    """Milliseconds of one ``fn(*args)``, mean of ``iters`` launches that
    rotate through ``arg_sets``, taken twice by CUDA events:

    ``device``: the launches captured into one CUDA graph and replayed, so
    the host's launch rate does not cap the reading: the time on the card;
    ``eager``: the same launches issued one by one from Python, as the main
    path issues them: at small shapes this is the host's time per call.

    ``graph=False`` for calls of several milliseconds whose temporaries are
    gigabytes (a capture would keep every launch's): there the host's time
    per call is a small part of the eager reading, which stands for both."""
    def run():
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])

    def timed(launch) -> float:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        launch()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters

    for args in arg_sets[:2]:
        fn(*args)
    eager = timed(run)
    if not graph:
        return {"device": eager, "eager": eager}
    cuda_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(cuda_graph):
        run()
    cuda_graph.replay()
    return {"device": timed(cuda_graph.replay), "eager": eager}


def trace_ms(fn, arg_sets, iters: int = 10) -> dict:
    """Milliseconds of one ``fn(*args)`` on the card by torch.profiler: the
    sum of the device time of every kernel, copy and fill it launched,
    over ``iters`` calls that rotate through ``arg_sets``, per call. No
    capture, so it takes a call whose temporaries a CUDA graph could not
    hold (autograd's backward of a library call), and no host time between
    launches, which is all an eager reading sees of a short call.
    ``kernels``: the four that take the most time, by name; ``backend``:
    the attention backend those names show (cudnn, flash, efficient by its
    ``fmha`` kernels, or math when none of them); ``launches_per_call``:
    the kernels, copies and fills a call launched. A trace that lost
    events (the profiler drops them now and then: all of a trace's, or one
    call's, so that a kernel counts other than a whole number of times a
    call) is taken again, up to ``TRACE_TRIES`` times, after a pause that
    grows with each retry; the last is kept. ``trace_tries``: the traces
    taken; ``events_lost``: whether the kept one still lost events."""
    from torch.profiler import ProfilerActivity, profile
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    for tries in range(1, TRACE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(*arg_sets[i % len(arg_sets)])
            torch.cuda.synchronize()
        device_us, launches, by_name = _device_time(prof, iters, "call")
        lost = not device_us or any(e["launches_per_call"] % 1
                                    for e in by_name)
        if not lost:
            break
        if tries < TRACE_TRIES:
            time.sleep(TRACE_PAUSE_S * tries)
    if not device_us:
        raise RuntimeError(f"torch.profiler reported no device time in "
                           f"{TRACE_TRIES} traces")
    names = [e["name"] for e in by_name]
    joined = " ".join(names).lower()
    backend = next((tag for tag, key in (
        ("cudnn", "cudnn"), ("flash", "flash"), ("efficient", "fmha"))
        if key in joined), "math")
    return {"ms": device_us / 1e3 / iters, "kernels": names[:4],
            "backend": backend, "launches_per_call": launches / iters,
            "trace_tries": tries, "events_lost": lost}


def copies_for_cold_l2(tensors) -> int:
    """How many copies of a case's inputs a timing loop rotates through.

    An input set of 4 MB or more (the decode cache of one layer, a long
    prompt's activations) is found cold by its real caller, because 30 layers
    of it pass through the 50 MB L2 in between: such a case rotates over
    copies that together exceed twice the L2. A smaller one was written by
    the previous operation and is timed warm, as the main path finds it."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    if nbytes < 4 * 2 ** 20:
        return 1
    return min(32, math.ceil(2 * L2_BYTES / nbytes))


def clone_like(t: torch.Tensor) -> torch.Tensor:
    """A copy with the same strides (``clone`` would make views contiguous)."""
    out = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                              device=t.device)
    out.copy_(t)
    return out


# ------------------------------------------------------------------------- #
# Phases
# ------------------------------------------------------------------------- #

def _smi(fields: str) -> str:
    """The first card's ``fields`` as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def phase_env() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs one CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the driver and the card's UUID tie a run's bitwise checks to a machine
    driver, uuid = (v.strip() for v in _smi("driver_version,uuid").split(","))
    env = {"python": sys.version.split()[0], "torch": torch.__version__,
           "cuda": torch.version.cuda, "card": _smi("name,power.limit"),
           "driver": driver, "gpu_uuid": uuid,
           "device_count": torch.cuda.device_count(),
           "allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    emit("env", **env)
    return env


def phase_build() -> None:
    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         library=str(path.relative_to(ROOT)),
         sources=sorted(p.name for p in (*_build.CSRC.glob("*.cu"),
                                         *_build.CSRC.glob("*.cuh"))))


def _rmsnorm_case(shape, dtype, gen, ulp_tol=False) -> dict:
    """``ulp_tol``: in bf16, allow one bf16 ulp of the largest output. Kernel
    and plain version round once from fp32 values a few fp32 ulps apart, so
    they may land one bf16 ulp apart, 2^-7 of |y|: above the absolute 1e-2
    wherever |y| >= 2, which a large random input reaches."""
    d = shape[-1]
    x = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
    gamma = (1.0 + 0.1 * torch.randn(d, generator=gen, device=DEVICE)).to(dtype)
    got = ops.rmsnorm(x, gamma, 1e-5)
    torch.cuda.synchronize()
    want = rmsnorm_plain(x, gamma, 1e-5)
    err = (got.float() - want.float()).abs().max().item()
    tol = NORM_TOL[dtype]
    if ulp_tol and dtype == torch.bfloat16:
        tol = max(tol, 2 ** -7 * want.float().abs().max().item())
    sets = [(x.clone(), gamma) for _ in range(copies_for_cold_l2([x, x]))]
    flops, nbytes = rms_module.forward_work(x.numel() // d, d, dtype)
    kernel = time_ms(lambda a, g: ops.rmsnorm(a, g, 1e-5), sets)
    return {
        "kernel": "rmsnorm", "shape": list(shape), "dtype": dtype_name(dtype),
        "max_abs_err": err, "tol": tol,
        "kernel_ms": kernel["device"], "kernel_eager_ms": kernel["eager"],
        "plain_ms": time_ms(lambda a, g: rmsnorm_plain(a, g, 1e-5),
                            sets)["device"],
        "library_ms": time_ms(lambda a, g: F.rms_norm(a, (d,), g, 1e-5),
                              sets)["device"],
        **bound(flops, nbytes, PEAK_FLOPS[torch.float32]),
        "cold_copies": len(sets),
    }


def _sdpa(q, k, v, causal, mask):
    """The library yardstick: one call of PyTorch's fused attention on the
    same inputs (a boolean mask stands for kv_len / q_offset)."""
    if mask is not None:
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                          enable_gqa=True)


def _attention_case(name, b, h, hkv, sq, skv, d, causal, dtype, gen,
                    kv_len=None, q_offset=None, clusters=False) -> dict:
    """Inputs in the model's layout, (b, s, heads, d), handed over as
    transposed views like the model's activations and cache. ``clusters``:
    also time the decode kernel at each cluster size it takes."""
    def draw(s, heads):
        t = torch.randn((b, s, heads, d), generator=gen, device=DEVICE)
        return t.to(dtype).transpose(1, 2)
    q, k, v = draw(sq, h), draw(skv, hkv), draw(skv, hkv)
    to_dev = lambda a: (None if a is None else
                        torch.tensor(a, dtype=torch.int32, device=DEVICE))
    kv_len_t, q_off_t = to_dev(kv_len), to_dev(q_offset)

    got = ops.flash_attention(q, k, v, causal, kv_len_t, q_off_t)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, causal, kv_len_t, q_off_t)
    err = (got.float() - want.float()).abs().max().item()

    # What this call's data needs: the (query, key) pairs the masks allow,
    # and the K/V rows at least one query may see.
    kpos = np.arange(skv)[None, None, :]
    lens = np.full(b, skv) if kv_len is None else np.minimum(kv_len, skv)
    allowed = kpos < lens[:, None, None]
    if causal:
        offs = np.zeros(b, int) if q_offset is None else np.asarray(q_offset)
        qpos = np.arange(sq)[None, :, None] + offs[:, None, None]
        allowed = allowed & (kpos <= qpos)
    allowed = np.broadcast_to(allowed, (b, sq, skv))
    flops, nbytes = attn_module.forward_work(
        b, h, hkv, sq, skv, d, dtype, causal, pairs=int(allowed.sum()),
        kv_rows=int(allowed.any(axis=1).sum()))

    mask = None
    if kv_len is not None or q_offset is not None:
        mask = torch.from_numpy(allowed.copy()).to(DEVICE)[:, None]
    n = copies_for_cold_l2([q, k, v])
    sets = [(clone_like(q), clone_like(k), clone_like(v)) for _ in range(n)]
    kernel = time_ms(lambda a, b_, c: ops.flash_attention(
        a, b_, c, causal, kv_len_t, q_off_t), sets)
    case = {
        "kernel": "flash_attention", "case": name,
        "shape": {"b": b, "h": h, "hkv": hkv, "sq": sq, "skv": skv, "d": d,
                  "causal": causal, "kv_len": kv_len is not None,
                  "q_offset": q_offset is not None},
        "dtype": dtype_name(dtype), "max_abs_err": err, "tol": ATTN_TOL[dtype],
        "kernel_ms": kernel["device"], "kernel_eager_ms": kernel["eager"],
        "plain_ms": time_ms(lambda a, b_, c: flash_attention_plain(
            a, b_, c, causal, kv_len_t, q_off_t), sets)["device"],
        "library_ms": time_ms(lambda a, b_, c: _sdpa(a, b_, c, causal, mask),
                              sets)["device"],
        **bound(flops, nbytes, PRODUCT_FLOPS[dtype]),
        "cold_copies": n,
    }
    if clusters:
        # The cluster size is the decode kernel's one occupancy knob: hold
        # each choice whose shared memory fits a block against the plain
        # version and time it.
        fits = [c for c in DECODE_CLUSTERS
                if decode_cluster_fits(d, dtype, h // hkv * sq, c)]
        case["cluster_max_abs_err"] = {
            str(c): (flash_attention_cuda(q, k, v, causal, kv_len_t, q_off_t,
                                          decode_cluster=c).float()
                     - want.float()).abs().max().item() for c in fits}
        case["max_abs_err"] = max(err, *case["cluster_max_abs_err"].values())
        case["cluster_ms"] = {
            str(c): time_ms(lambda a, b_, v_, c=c: flash_attention_cuda(
                a, b_, v_, causal, kv_len_t, q_off_t, decode_cluster=c),
                sets)["device"]
            for c in fits}
    return case


def _decode_blocks(b: int, h: int, hkv: int, sq: int, dtype) -> int:
    """The decode kernels' grid at a long cache: a cluster of
    DECODE_DEFAULT_CLUSTER blocks for each (batch, KV head, chunk of its
    group's h / hkv x sq query rows), the chunk DM_ROWS rows (bf16) or
    DEC_ROWS (fp32; 1 where the group has one row), as the launch in
    csrc/flash_attention.cu sizes it."""
    rows = h // hkv * sq
    chunk = (attn_module.DM_ROWS if dtype == torch.bfloat16
             else 1 if rows == 1 else attn_module.DEC_ROWS)
    return b * hkv * -(-rows // chunk) * attn_module.DECODE_DEFAULT_CLUSTER


def _partial_case(name, b, h, hkv, sq, skv, d, dtype, gen,
                  q_offset) -> dict:
    """The partial route (serving over a cache split along its sequence:
    one rank's block of the keys, causal, ``q_offset`` the rows' position
    in the block): the kernel's fp32 output against the plain version's
    within PARTIAL_REL_TOL of its largest magnitude, exact zeros where a
    row sees no key, the log-sum-exp within LSE_TOL and +inf at the same
    rows; its time beside the plain version's, SDPA's on the
    same inputs (the mask standing for q_offset) and the bound, from what
    this call's positions let each row see. Inputs in the model's layout,
    as ``_attention_case``'s; at a block of 262,144 keys the K/V are 5.37
    GB in bf16 and 10.7 GB in fp32, so the set is not copied for a cold L2
    (it is 100 times the L2 already) and the plain and library calls,
    whose temporaries are gigabytes, are timed eagerly over 3 calls."""
    def draw(s, heads):
        t = torch.randn((b, s, heads, d), generator=gen, device=DEVICE)
        return t.to(dtype).transpose(1, 2)
    q, k, v = draw(sq, h), draw(skv, hkv), draw(skv, hkv)
    q_off = torch.tensor(q_offset, dtype=torch.int32, device=DEVICE)
    got, lse = ops.flash_attention_partial(q, k, v, True, None, q_off)
    torch.cuda.synchronize()
    want, want_lse = flash_attention_forward_plain(q, k, v, True, None, q_off,
                                                   unrounded=True)
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    same_inf = bool(torch.equal(torch.isinf(lse), torch.isinf(want_lse)))
    finite = torch.isfinite(want_lse)
    lse_err = ((lse[finite] - want_lse[finite]).abs().max().item()
               if finite.any() else 0.0)
    keyless_zero = bool((got[~finite] == 0).all())
    del want, want_lse
    kpos = np.arange(skv)[None, None, :]
    qpos = np.arange(sq)[None, :, None] + np.asarray(q_offset)[:, None, None]
    allowed = np.broadcast_to(kpos <= qpos, (b, sq, skv))
    flops, nbytes = attn_module.forward_work(
        b, h, hkv, sq, skv, d, dtype, True, lse=True,
        pairs=int(allowed.sum()), kv_rows=int(allowed.any(axis=1).sum()),
        out_itemsize=4)
    mask = torch.from_numpy(allowed.copy()).to(DEVICE)[:, None]
    sets = [(q, k, v)]
    kernel = time_ms(lambda a, b_, c: ops.flash_attention_partial(
        a, b_, c, True, None, q_off), sets)
    plain_ms = time_ms(lambda a, b_, c: flash_attention_forward_plain(
        a, b_, c, True, None, q_off, unrounded=True), sets, iters=3,
        graph=False)["device"]
    library_ms = time_ms(lambda a, b_, c: _sdpa(a, b_, c, True, mask), sets,
                         iters=3, graph=False)["device"]
    out = {
        "kernel": "flash_attention_partial", "case": name,
        "shape": {"b": b, "h": h, "hkv": hkv, "sq": sq, "skv": skv, "d": d,
                  "causal": True, "q_offset": q_offset},
        "dtype": dtype_name(dtype), "max_abs_err": err,
        "plain_max_abs": scale, "err_of_plain_max": err / max(scale, 1e-30),
        "rel_tol": PARTIAL_REL_TOL[dtype],
        "tol": PARTIAL_REL_TOL[dtype] * scale, "lse_max_abs_err": lse_err,
        "lse_tol": LSE_TOL, "lse_inf_rows_equal": same_inf,
        "keyless_rows_zero": keyless_zero,
        "ok": (err <= PARTIAL_REL_TOL[dtype] * scale and lse_err <= LSE_TOL
               and same_inf and keyless_zero),
        "kernel_ms": kernel["device"], "kernel_eager_ms": kernel["eager"],
        "plain_ms": plain_ms, "library_ms": library_ms,
        "library_note": "scaled_dot_product_attention with the boolean "
                        "mask of q_offset; it writes no log-sum-exp",
        **bound(flops, nbytes, PRODUCT_FLOPS[dtype]),
        "blocks": _decode_blocks(b, h, hkv, sq, dtype)}
    out["of_bound"] = out["bound_ms"] / out["kernel_ms"]
    del q, k, v, sets
    torch.cuda.empty_cache()
    return out


# The partial route's cases: zamba2's long_500k row at one of two data
# ranks' blocks (32 heads of 160 over 262,144 keys, every key visible), a
# GQA row at d 64 (smollm's 9 heads over 3) over the same block, and rows
# before and past their block (no visible key: zeros and +inf).
LONG_HALF = 262_144


def _partial_cases() -> list:
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    cases = []
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            cases.append(_partial_case(
                "zamba2 long half", 1, 32, 32, 1, LONG_HALF, 160, dtype, gen,
                [LONG_HALF - 1]))
            cases.append(_partial_case(
                "smollm GQA long half", 1, 9, 3, 1, LONG_HALF, 64, dtype, gen,
                [LONG_HALF - 1]))
            cases.append(_partial_case(
                "no visible key, d=160", 2, 32, 32, 1, 4096, 160, dtype, gen,
                [-1, 5000]))
        # the reduced tick at head_dim 16 over a rank's block of 128 keys:
        # rows inside, past (300) and before (-1) it
        gen_reduced = torch.Generator(device=DEVICE).manual_seed(8)
        for dtype in (torch.bfloat16, torch.float32):
            cases.append(_partial_case(
                "reduced decode block, d=16", 4, 4, 2, 1, 128, 16, dtype,
                gen_reduced, [127, 40, 300, -1]))
    return cases


def _scaled_errors(got, want) -> list:
    """(max |got - want|, max |want|) of each gradient."""
    return [((g.float() - w.float()).abs().max().item(),
             w.float().abs().max().item()) for g, w in zip(got, want)]


def _bitwise_repeats(fn, first) -> int:
    """Calls of ``fn`` (the first given) that equal ``first`` bit for bit."""
    return 1 + sum(all(torch.equal(a, b) for a, b in zip(fn(), first))
                   for _ in range(BWD_REPEATS - 1))


def _sdpa_backends(q, k, v, do, causal) -> dict:
    """Each of PyTorch's fused attention backends alone: autograd's backward
    of its forward on the same inputs, in device ms by torch.profiler
    (``trace_ms``, as ``library_ms``), or why it refused the forward (its
    error and the reasons PyTorch's warnings gave)."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    gqa = q.shape[1] != k.shape[1]
    out = {}
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        try:
            with warnings.catch_warnings(record=True) as said, \
                    sdpa_kernel([backend]), torch.enable_grad():
                warnings.simplefilter("always")
                o = F.scaled_dot_product_attention(
                    *leaves, is_causal=causal, enable_gqa=gqa)
            out[backend.name.lower()] = trace_ms(
                lambda o_, g: torch.autograd.grad(o_, leaves, g,
                                                  retain_graph=True),
                [(o, do)])["ms"]
            del o
        except RuntimeError as err:
            why = " ".join(str(w.message).split("(Triggered")[0].strip()
                           for w in said)
            out[backend.name.lower()] = ("refused: " + str(err)[:80] + " "
                                         + why[:600])
        del leaves
        torch.cuda.empty_cache()
    return out


def _attention_backward_case(name, b, h, hkv, s, d, causal, dtype, gen,
                             main=False, bitwise=False,
                             backends=False, skv=None) -> dict:
    """The training route at one shape: the forward with the rows'
    log-sum-exp against the plain forward, then the backward against the
    plain backward, which takes the plain forward's o and lse (nothing the
    kernels made). Inputs in the model's layout, (b, s, heads, d), handed
    over as transposed views; ``skv`` key rows where they are not ``s``
    (a cross-attention's). ``main``: three calls must agree bitwise; the
    plain version is timed eagerly (its temporaries are gigabytes).
    ``bitwise``: the three calls at another case too. ``backends``:
    autograd's backward through each fused SDPA backend alone
    (``_sdpa_backends``).
    ``library_ms``: autograd's backward of one
    ``F.scaled_dot_product_attention`` (GQA by ``enable_gqa``), and
    ``kernel_trace_ms`` the backward kernels, both as torch.profiler's sum
    of device time (``trace_ms``); ``forward_library_ms``: one
    ``F.scaled_dot_product_attention`` forward the same way, beside
    ``forward_lse_ms`` and the plain forward's ``forward_plain_ms``; at
    ``main`` three forward calls must agree bitwise too. ``splits``,
    ``plan_kernels_per_call`` and
    ``scratch_bytes``: the call's ``flash_attention_backward_plan``;
    ``kernels_per_call``: the kernels a call launched, counted in the
    trace, which must equal the plan's."""
    skv = skv or s

    def draw(heads, rows=s):
        t = torch.randn((b, rows, heads, d), generator=gen, device=DEVICE)
        return t.to(dtype).transpose(1, 2)
    q, k, v, do = draw(h), draw(hkv, skv), draw(hkv, skv), draw(h)
    out, lse = flash_attention_lse_cuda(q, k, v, causal)
    got = flash_attention_backward_cuda(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    want_out, want_lse = flash_attention_forward_plain(q, k, v, causal)
    out_err = (out.float() - want_out.float()).abs().max().item()
    lse_err = (lse - want_lse).abs().max().item()
    lse_scale = max(1.0, want_lse.abs().max().item())
    want = flash_attention_backward_plain(q, k, v, want_out, want_lse, do,
                                          causal)
    del want_out, want_lse
    errs = _scaled_errors(got, want)
    tol = BWD_TOL["flash_attention_backward"][dtype]
    extra = {}
    if main or bitwise:
        extra["bitwise_equal_calls"] = _bitwise_repeats(
            lambda: flash_attention_backward_cuda(q, k, v, out, lse, do,
                                                  causal), got)
        extra["forward_bitwise_equal_calls"] = _bitwise_repeats(
            lambda: flash_attention_lse_cuda(q, k, v, causal), (out, lse))
    del got, want

    flops, nbytes = attn_module.backward_work(b, h, hkv, s, skv, d, dtype,
                                              causal)
    # the same bound with the products on the fp32 pipes, beside it
    pipes_bound = (bound(flops, nbytes, PEAK_FLOPS[dtype])["bound_ms"]
                   if dtype == torch.float32 else None)
    fwd_bound = bound(*attn_module.forward_work(b, h, hkv, s, skv, d, dtype,
                                                causal, lse=True),
                      PRODUCT_FLOPS[dtype])["bound_ms"]
    sets = [(q, k, v, out, lse, do)]
    kernel = time_ms(lambda *a: flash_attention_backward_cuda(*a, causal),
                     sets, **(dict(iters=20) if main else {}))
    kernel_trace = trace_ms(
        lambda *a: flash_attention_backward_cuda(*a, causal), sets)
    forward = time_ms(lambda q_, k_, v_, *_: flash_attention_lse_cuda(
        q_, k_, v_, causal), sets)
    forward_library = trace_ms(lambda q_, k_, v_, *_: (
        F.scaled_dot_product_attention(q_, k_, v_, is_causal=causal,
                                       enable_gqa=True)), sets)
    splits, plan_kernels, scratch_bytes = flash_attention_backward_plan(
        b, h, hkv, skv, d)
    ok = (out_err <= ATTN_TOL[dtype] and lse_err <= LSE_TOL * lse_scale
          and all(e <= tol * scale for e, scale in errs)
          and extra.get("bitwise_equal_calls", BWD_REPEATS) == BWD_REPEATS
          and extra.get("forward_bitwise_equal_calls",
                        BWD_REPEATS) == BWD_REPEATS
          and kernel_trace["launches_per_call"] == plan_kernels)
    plain_ms = time_ms(lambda *a: flash_attention_backward_plain(*a, causal),
                       sets, iters=10 if main else 50, graph=False)["device"]
    forward_plain_ms = time_ms(
        lambda q_, k_, v_, *_: flash_attention_forward_plain(q_, k_, v_,
                                                             causal),
        sets, iters=10 if main else 50, graph=False)["device"]
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        lib_out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                                 enable_gqa=True)
    library = trace_ms(lambda o, g: torch.autograd.grad(
        o, leaves, g, retain_graph=True), [(lib_out, do)])
    del lib_out, leaves
    if backends:
        extra["library_by_backend_ms"] = _sdpa_backends(q, k, v, do, causal)
    return {
        "kernel": "flash_attention_backward", "case": name,
        "shape": {"b": b, "h": h, "hkv": hkv, "s": s, "d": d,
                  "causal": causal, **({"skv": skv} if skv != s else {})},
        "dtype": dtype_name(dtype),
        "max_abs_err": max(e for e, _ in errs),
        "grad_max_abs_err": dict(zip(("dq", "dk", "dv"), (e for e, _ in errs))),
        "grad_max_abs": dict(zip(("dq", "dk", "dv"), (m for _, m in errs))),
        "tol": tol, "tol_is": "of each gradient's largest magnitude",
        "forward_out_max_abs_err": out_err, "forward_out_tol": ATTN_TOL[dtype],
        "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL * lse_scale,
        "ok": ok,
        "kernel_ms": kernel["device"], "kernel_eager_ms": kernel["eager"],
        "kernel_trace_ms": kernel_trace["ms"],
        "forward_lse_ms": forward["device"], "forward_lse_bound_ms": fwd_bound,
        "forward_plain_ms": forward_plain_ms,
        "forward_library_ms": forward_library["ms"],
        "forward_library_backend": forward_library["backend"],
        "splits": splits, "plan_kernels_per_call": plan_kernels,
        "kernels_per_call": kernel_trace["launches_per_call"],
        "trace_tries": kernel_trace["trace_tries"],
        "scratch_bytes": scratch_bytes,
        "plain_ms": plain_ms, "library_ms": library["ms"],
        "library_kernels": library["kernels"],
        "library_backend": library["backend"],
        **bound(flops, nbytes, PRODUCT_FLOPS[dtype]),
        "bound_fp32_pipes_ms": pipes_bound,
        "flops": flops, "bytes": nbytes, **extra,
    }


def _rmsnorm_backward_case(shape, dtype, gen, main=False) -> dict:
    """dx and dgamma against the plain backward; ``main``: three calls must
    agree bitwise, and ``stage_ms`` is each stage kernel's device time
    alone. ``library_ms``: autograd's backward of one ``F.rms_norm``, and
    ``kernel_trace_ms`` the backward kernels, both as torch.profiler's sum
    of device time over the same cold copies; ``kernels_per_call``: the
    kernels a call launched, counted in that trace, which must equal
    ``BACKWARD_KERNELS_PER_CALL``; ``plan``: the call's
    ``rmsnorm_backward_plan``."""
    d = shape[-1]
    x = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
    gamma = (1.0 + 0.1 * torch.randn(d, generator=gen, device=DEVICE)).to(dtype)
    dy = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
    got = rmsnorm_backward_cuda(x, gamma, dy)
    torch.cuda.synchronize()
    want = rmsnorm_backward_plain(x, gamma, dy)
    errs = _scaled_errors(got, want)
    tol = BWD_TOL["rmsnorm_backward"][dtype]
    extra = {}
    if main:
        extra["bitwise_equal_calls"] = _bitwise_repeats(
            lambda: rmsnorm_backward_cuda(x, gamma, dy), got)
    rows = x.numel() // d
    flops, nbytes = rms_module.backward_work(rows, d, dtype)
    sets = [(x.clone(), gamma, dy.clone())
            for _ in range(copies_for_cold_l2([x, dy, x]))]
    kernel = time_ms(lambda a, g, e: rmsnorm_backward_cuda(a, g, e), sets)
    kernel_trace = trace_ms(lambda a, g, e: rmsnorm_backward_cuda(a, g, e),
                            sets)
    ok = (all(e <= tol * scale for e, scale in errs)
          and extra.get("bitwise_equal_calls", BWD_REPEATS) == BWD_REPEATS
          and kernel_trace["launches_per_call"]
          == rms_module.BACKWARD_KERNELS_PER_CALL)
    plain_ms = time_ms(lambda a, g, e: rmsnorm_backward_plain(a, g, e), sets,
                       iters=20, graph=False)["device"]
    lib_sets = []
    for xs, _, dys in sets:
        xl = xs.detach().requires_grad_()
        gl = gamma.detach().clone().requires_grad_()
        with torch.enable_grad():
            lib_sets.append((F.rms_norm(xl, (d,), gl, 1e-5), (xl, gl), dys))
    library = trace_ms(lambda o, leaves, g: torch.autograd.grad(
        o, leaves, g, retain_graph=True), lib_sets)
    del lib_sets
    plan = rms_module.rmsnorm_backward_plan(rows, d, dtype)
    if main:
        # each stage's device time alone, on the buffers of one whole call
        # (the dgamma stage reads the partial rows the rows stage wrote)
        bufs = rms_module.rmsnorm_backward_buffers(x, gamma)
        rms_module.rmsnorm_backward_stages_cuda(x, gamma, dy, 1e-5, bufs)
        extra["stage_ms"] = {
            stage: time_ms(lambda a, g, e, stage=stage:
                           rms_module.rmsnorm_backward_stages_cuda(
                               a, g, e, 1e-5, bufs, (stage,)),
                           sets)["device"]
            for stage in rms_module.BACKWARD_STAGES}
        del bufs
    return {
        "kernel": "rmsnorm_backward", "shape": list(shape),
        "dtype": dtype_name(dtype), "max_abs_err": max(e for e, _ in errs),
        "grad_max_abs_err": {"dx": errs[0][0], "dgamma": errs[1][0]},
        "grad_max_abs": {"dx": errs[0][1], "dgamma": errs[1][1]},
        "tol": tol, "tol_is": "of each gradient's largest magnitude",
        "ok": ok, "kernel_ms": kernel["device"],
        "kernel_eager_ms": kernel["eager"], "kernel_trace_ms": kernel_trace["ms"],
        "kernels_per_call": kernel_trace["launches_per_call"],
        "trace_tries": kernel_trace["trace_tries"],
        "plain_ms": plain_ms, "library_ms": library["ms"],
        "library_kernels": library["kernels"],
        **bound(flops, nbytes, PEAK_FLOPS[torch.float32]),
        "cold_copies": len(sets), "plan": dataclasses.asdict(plan), **extra,
    }


def _backward_cases() -> list:
    """The training route's kernels. Attention: smollm-135m's layer at the
    train_lm phase's shape (the main case), a chatglm3-6b-like layer (d 128,
    32 heads over 2), a ragged tile, a non-causal one, and the reduced
    configs' layer at launch.train's default batch (d 16); zamba2's shared
    block at head_dim 160 (its training layer, a ragged tile, a GQA group
    not causal); seamless's cross-attention at a rank's heads (fewer query
    rows than keys, not causal). RMSNorm: the
    train_lm phase's rows (8 x 2048 of 576, the main case), ragged rows,
    few wide rows, a chatglm3-6b/minitron-8b-width training layer (the
    same 8 x 2048 rows of 4096), rows that are not a whole number of
    16-byte packs, and the reduced configs' d_model 64 at torch_train_lm.py's
    rows (8 x 128)."""
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases.append(_attention_backward_case(
            "train main", LM_BATCH, 9, 3, LM_SEQ, 64, True, dtype, gen,
            main=True))
        cases.append(_attention_backward_case(
            "chatglm3-like d=128", 1, 32, 2, 1024, 128, True, dtype, gen))
        cases.append(_attention_backward_case(
            "ragged s=37", 1, 4, 4, 37, 64, True, dtype, gen))
        cases.append(_attention_backward_case(
            "non-causal s=130", 2, 6, 2, 130, 64, False, dtype, gen))
        cases.append(_attention_backward_case(
            "reduced d=16", 8, 4, 2, 128, 16, True, dtype, gen))
        cases.append(_rmsnorm_backward_case((LM_BATCH * LM_SEQ, 576), dtype,
                                            gen, main=True))
        for shape in ((3, 37, 576), (2, 64, 4096), (3, 7, 100)):
            cases.append(_rmsnorm_backward_case(shape, dtype, gen))
    # the wide layer draws from a stream of its own, so the other cases keep
    # the inputs they always had
    gen_wide = torch.Generator(device=DEVICE).manual_seed(5)
    for dtype in (torch.float32, torch.bfloat16):
        cases.append(_rmsnorm_backward_case((LM_BATCH * LM_SEQ, 4096), dtype,
                                            gen_wide))
        torch.cuda.empty_cache()
    # the reduced configs' norms at d_model 64, at torch_train_lm.py's rows
    # (8 x 128), from a stream of their own
    gen_64 = torch.Generator(device=DEVICE).manual_seed(8)
    for dtype in (torch.float32, torch.bfloat16):
        cases.append(_rmsnorm_backward_case((8 * 128, 64), dtype, gen_64))
    # zamba2's head dim 160, from a stream of its own too: its training
    # layer (the train_zamba phase's shared block, the d 160 main case, with
    # each fused SDPA backend alone beside it), a ragged tile and a GQA
    # group not causal; each three calls bitwise equal
    gen_160 = torch.Generator(device=DEVICE).manual_seed(6)
    cfg = get_config(ZAMBA_ARCH)
    for dtype in (torch.float32, torch.bfloat16):
        cases.append(_attention_backward_case(
            "zamba2 train d=160", ZAMBA_BATCH, cfg.num_heads,
            cfg.num_kv_heads, ZAMBA_SEQ, cfg.resolved_head_dim, True, dtype,
            gen_160, main=True, backends=True))
        cases.append(_attention_backward_case(
            "ragged s=37, d=160", 1, 4, 4, 37, 160, True, dtype, gen_160,
            bitwise=True))
        cases.append(_attention_backward_case(
            "GQA non-causal s=130, d=160", 2, 8, 2, 130, 160, False, dtype,
            gen_160, bitwise=True))
        torch.cuda.empty_cache()
    # seamless-m4t-large-v2's cross-attention at a rank's heads in the
    # parallel_gloo_split phase's step (8 of 16 heads of 64, 512 target
    # rows over 1,024 source frames, not causal), from a stream of its own
    gen_cross = torch.Generator(device=DEVICE).manual_seed(7)
    cfg = get_config(ENCDEC_ARCH)
    for dtype in (torch.float32, torch.bfloat16):
        cases.append(_attention_backward_case(
            "seamless cross sq=512 skv=1024", SPLIT_BATCH,
            cfg.num_heads // 2, cfg.num_kv_heads // 2, SPLIT_SEQ,
            cfg.resolved_head_dim, False, dtype, gen_cross, bitwise=True,
            skv=SPLIT_SRC))
    return cases


def _ssd_case(name, b, s, h, p, n, g, chunk, dtype, gen,
              stages=False) -> dict:
    """Inputs in the model's layout: x, B and C are views of one conv output
    (b, s, h*p + 2*g*n), as ``mamba_layer`` hands them over; dt is
    softplus-ed, A negative, as the reference tests draw them."""
    di, gn = h * p, g * n
    xbc = torch.randn((b, s, di + 2 * gn), generator=gen,
                      device=DEVICE).to(dtype)
    x = xbc[..., :di].unflatten(-1, (h, p))
    B = xbc[..., di:di + gn].unflatten(-1, (g, n))
    C = xbc[..., di + gn:].unflatten(-1, (g, n))
    dt = F.softplus(torch.randn((b, s, h), generator=gen, device=DEVICE))
    A = -torch.exp(0.5 * torch.randn((h,), generator=gen, device=DEVICE))
    y, state = ops.ssd_scan(x, dt, A, B, C, chunk)
    torch.cuda.synchronize()
    want_y, want_state = ssd_scan_plain(x, dt, A, B, C, chunk)
    err_y = (y.float() - want_y.float()).abs().max().item()
    err_state = (state - want_state).abs().max().item()
    scale_y = max(1.0, want_y.float().abs().max().item())
    scale_state = max(1.0, want_state.abs().max().item())
    rel = SSD_REL_TOL[dtype]

    flops, nbytes = ssd_module.work(b, s, h, p, n, g, chunk, dtype)

    def views():
        t = clone_like(xbc)
        return (t[..., :di].unflatten(-1, (h, p)),
                t[..., di:di + gn].unflatten(-1, (g, n)),
                t[..., di + gn:].unflatten(-1, (g, n)))
    sets = [views() for _ in range(copies_for_cold_l2([xbc, dt]))]
    iters = 20
    kernel = time_ms(lambda x_, B_, C_: ops.ssd_scan(x_, dt, A, B_, C_, chunk),
                     sets, iters)
    case = {
        "kernel": "ssd_scan", "case": name,
        "shape": {"b": b, "s": s, "h": h, "p": p, "n": n, "g": g,
                  "chunk": chunk},
        "dtype": dtype_name(dtype),
        "max_abs_err": max(err_y, err_state), "tol": rel * scale_y,
        "max_abs_err_y": err_y, "max_abs_err_state": err_state,
        "rel_tol": rel, "scale_y": scale_y, "scale_state": scale_state,
        "ok": err_y <= rel * scale_y and err_state <= rel * scale_state,
        "kernel_ms": kernel["device"], "kernel_eager_ms": kernel["eager"],
        "plain_ms": time_ms(lambda x_, B_, C_: ssd_scan_plain(
            x_, dt, A, B_, C_, chunk), sets, iters)["device"],
        "library_ms": None, "library_note": SSD_NO_LIBRARY,
        **bound(flops, nbytes, PRODUCT_FLOPS[dtype]),
        "flops": flops, "bytes": nbytes, "cold_copies": len(sets),
        "kernels_per_call": KERNELS_PER_CALL,
    }
    if stages:
        # Each stage kernel's device time alone, on the scratch of one whole
        # call (a stage reads what the stages before it wrote).
        bufs = ssd_buffers(x, B, chunk)
        ssd_stages_cuda(x, dt, A, B, C, chunk, bufs)
        case["stage_ms"] = {
            stage: time_ms(lambda x_, B_, C_, stage=stage: ssd_stages_cuda(
                x_, dt, A, B_, C_, chunk, bufs, (stage,)), sets,
                iters)["device"]
            for stage in STAGES}
    return case


def _ssd_backward_case(name, b, s, h, p, n, g, chunk, dtype, gen,
                       dstate=False) -> dict:
    """The training route at one shape: the training forward's kernels
    (which keep the scores, cumsums and incoming states), then the
    backward's kernels against ``ssd_scan_backward_plain`` on the same
    inputs (it recomputes the forward itself): each gradient to BWD_TOL of
    its largest magnitude, three calls that must agree bitwise, the kernels
    a call launched, counted in a trace, equal to the plan's
    (``ssd_scan_backward_plan``: splits of a group's heads, kernels a call,
    the dB/dC partials' bytes), and ``stage_ms``: each stage kernel's
    device time alone, on the scratch of one whole call. Inputs as
    ``_ssd_case`` draws them, dy in x's type, ``dstate`` (fp32) when asked.
    Calls of milliseconds with a gigabyte of scratch are timed eagerly."""
    di, gn = h * p, g * n
    xbc = torch.randn((b, s, di + 2 * gn), generator=gen,
                      device=DEVICE).to(dtype)

    def split(t):
        return (t[..., :di].unflatten(-1, (h, p)),
                t[..., di:di + gn].unflatten(-1, (g, n)),
                t[..., di + gn:].unflatten(-1, (g, n)))
    x, B, C = split(xbc)
    dt = F.softplus(torch.randn((b, s, h), generator=gen, device=DEVICE))
    A = -torch.exp(0.5 * torch.randn((h,), generator=gen, device=DEVICE))
    dy = torch.randn((b, s, h, p), generator=gen, device=DEVICE).to(dtype)
    ds = (torch.randn((b, h, p, n), generator=gen, device=DEVICE)
          if dstate else None)
    saved = ssd_module.ssd_scan_train_cuda(x, dt, A, B, C, chunk)[2:]

    def call(x_, B_, C_, dy_):
        return ssd_module.ssd_scan_backward_cuda(x_, dt, A, B_, C_, dy_, ds,
                                                 *saved, chunk)
    got = call(x, B, C, dy)
    torch.cuda.synchronize()
    errs = _scaled_errors(got, ssd_module.ssd_scan_backward_plain(
        x, dt, A, B, C, dy, ds, chunk))
    repeats = _bitwise_repeats(lambda: call(x, B, C, dy), got)
    del got
    tol = BWD_TOL["ssd_scan_backward"][dtype]
    flops, nbytes = ssd_module.backward_work(b, s, h, p, n, g, chunk, dtype,
                                             dstate)
    sets = [(*split(clone_like(xbc)), dy.clone())
            for _ in range(copies_for_cold_l2([xbc, dy]))]
    big = flops > 1e10
    iters = 10 if big else 20
    kernel = time_ms(call, sets, iters, graph=not big)
    kernel_trace = trace_ms(call, sets)
    bufs = ssd_module.ssd_backward_buffers(x, B, chunk)
    ssd_module.ssd_scan_backward_stages_cuda(x, dt, A, B, C, dy, ds, *saved,
                                             chunk, bufs)
    stage_ms = {
        stage: time_ms(lambda x_, B_, C_, dy_, stage=stage:
                       ssd_module.ssd_scan_backward_stages_cuda(
                           x_, dt, A, B_, C_, dy_, ds, *saved, chunk, bufs,
                           (stage,)), sets, iters, graph=not big)["device"]
        for stage in ssd_module.BACKWARD_STAGES}
    scratch = sum(bufs[k].numel() * bufs[k].element_size()
                  for k in ("dS", "dcs", "dA_part", "dB_part", "dC_part"))
    splits, per_call, part_bytes = ssd_module.ssd_scan_backward_plan(
        b, s, h, g, n, chunk)
    del bufs
    plain_ms = time_ms(lambda x_, B_, C_, dy_:
                       ssd_module.ssd_scan_backward_plain(
                           x_, dt, A, B_, C_, dy_, ds, chunk),
                       sets, iters=3, graph=False)["device"]
    ok = (all(e <= tol * scale for e, scale in errs)
          and repeats == BWD_REPEATS
          and kernel_trace["launches_per_call"] == per_call)
    return {
        "kernel": "ssd_scan_backward", "case": name,
        "shape": {"b": b, "s": s, "h": h, "p": p, "n": n, "g": g,
                  "chunk": chunk, "dstate": dstate},
        "plan": {"splits": splits, "kernels_per_call": per_call,
                 "partial_bytes": part_bytes},
        "dtype": dtype_name(dtype), "max_abs_err": max(e for e, _ in errs),
        "grad_max_abs_err": {k: e for k, (e, _) in zip(GRADS_SSD, errs)},
        "grad_max_abs": {k: m for k, (_, m) in zip(GRADS_SSD, errs)},
        "tol": tol, "tol_is": "of each gradient's largest magnitude",
        "ok": ok, "kernel_ms": kernel["device"],
        "kernel_eager_ms": kernel["eager"],
        "kernel_trace_ms": kernel_trace["ms"],
        "kernels_per_call": kernel_trace["launches_per_call"],
        "trace_tries": kernel_trace["trace_tries"], "stage_ms": stage_ms,
        "plain_ms": plain_ms, "library_ms": None,
        "library_note": SSD_BWD_NO_LIBRARY,
        **bound(flops, nbytes, PRODUCT_FLOPS[dtype]),
        "flops": flops, "bytes": nbytes, "scratch_bytes": scratch,
        "bitwise_equal_calls": repeats, "cold_copies": len(sets),
    }


def _ssd_backward_cases() -> list:
    """The SSD scan's backward, from a stream of its own: mamba2-780m's
    training layer at the train_mamba phase's batch (the main case),
    zamba2-2.7b's layer (80 heads, n 64) and a ragged grouped case with the
    final state's cotangent (no model passes one), fp32 and bf16."""
    cfg = get_config(MAMBA_ARCH)
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases.append(_ssd_backward_case(
            "train main", MAMBA_BATCH, MAMBA_SEQ, cfg.ssm_heads,
            cfg.ssm.head_dim, cfg.ssm.state_dim, cfg.ssm.ngroups,
            cfg.ssm.chunk_size, dtype, gen))
        cases.append(_ssd_backward_case("zamba2 layer", 1, 1024, 80, 64, 64,
                                        1, 256, dtype, gen))
        cases.append(_ssd_backward_case(
            "ragged s=130 g=2 with dstate", 2, 130, 4, 32, 32, 2, 64, dtype,
            gen, dstate=True))
        torch.cuda.empty_cache()
    return cases


def _offset_attention_case(name, b, h, hkv, s, d, dtype, gen, rank=1,
                           bitwise=False) -> dict:
    """The training route with ``q_offset`` at one shape: a rank's block of
    a two-rank split along the sequence, its ``sq = s // 2`` query rows
    (rank 0: the first; rank 1: the rest, from ``s - sq``) over the whole
    sequence's ``s`` keys. The forward with the rows' log-sum-exp and the
    backward against their plain versions on the same inputs (the backward
    reading the plain forward's o and lse): the output to ATTN_TOL, the
    log-sum-exp to LSE_TOL, each gradient to BWD_TOL of its largest; the
    keys no row sees (rank 0's block: the later rank's) with dK = dV = 0;
    three backward calls bitwise equal (and three forward calls, with
    ``bitwise``). ``library_ms``: one ``F.scaled_dot_product_attention``
    with the block's boolean mask, its backward by autograd (torch.profiler's
    device time, as ``_attention_backward_case``'s); the bound counts the
    (query, key) pairs the shifted mask allows (``offset_pairs``)."""
    sq = s // 2
    off = 0 if rank == 0 else s - sq

    def draw(heads, rows):
        t = torch.randn((b, rows, heads, d), generator=gen, device=DEVICE)
        return t.to(dtype).transpose(1, 2)
    q, k, v, do = draw(h, sq), draw(hkv, s), draw(hkv, s), draw(h, sq)
    offset = torch.full((b,), off, dtype=torch.int32, device=DEVICE)
    out, lse = flash_attention_lse_cuda(q, k, v, True, offset)
    got = flash_attention_backward_cuda(q, k, v, out, lse, do, True, offset)
    torch.cuda.synchronize()
    want_out, want_lse = flash_attention_forward_plain(q, k, v, True, None,
                                                       offset)
    out_err = (out.float() - want_out.float()).abs().max().item()
    lse_err = (lse - want_lse).abs().max().item()
    lse_scale = max(1.0, want_lse.abs().max().item())
    want = flash_attention_backward_plain(q, k, v, want_out, want_lse, do,
                                          True, offset)
    del want_out, want_lse
    errs = _scaled_errors(got, want)
    del want
    unseen = min(s, sq + off)
    unseen_zero = not (got[1][:, :, unseen:].any()
                       or got[2][:, :, unseen:].any())
    repeats = _bitwise_repeats(lambda: flash_attention_backward_cuda(
        q, k, v, out, lse, do, True, offset), got)
    fwd_repeats = (_bitwise_repeats(lambda: flash_attention_lse_cuda(
        q, k, v, True, offset), (out, lse)) if bitwise else BWD_REPEATS)
    del got
    pairs, kv_rows = attn_module.offset_pairs(sq, s, [off] * b)
    fwd_work = attn_module.forward_work(b, h, hkv, sq, s, d, dtype, True,
                                        lse=True, pairs=pairs,
                                        kv_rows=kv_rows)
    flops, nbytes = attn_module.backward_work(b, h, hkv, sq, s, d, dtype,
                                              True, pairs)
    sets = [(q, k, v, out, lse, do)]
    kernel = time_ms(lambda *a: flash_attention_backward_cuda(
        *a, True, offset), sets)
    kernel_trace = trace_ms(lambda *a: flash_attention_backward_cuda(
        *a, True, offset), sets)
    forward = time_ms(lambda q_, k_, v_, *_: flash_attention_lse_cuda(
        q_, k_, v_, True, offset), sets)
    mask = (torch.arange(s, device=DEVICE)[None, :]
            <= torch.arange(sq, device=DEVICE)[:, None] + off)
    forward_library = trace_ms(lambda q_, k_, v_, *_: _sdpa(
        q_, k_, v_, True, mask), sets)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        lib_out = _sdpa(*leaves, True, mask)
    library = trace_ms(lambda o, g: torch.autograd.grad(
        o, leaves, g, retain_graph=True), [(lib_out, do)])
    del lib_out, leaves
    plain_ms = time_ms(lambda *a: flash_attention_backward_plain(
        *a, True, offset), sets, iters=10, graph=False)["device"]
    forward_plain_ms = time_ms(
        lambda q_, k_, v_, *_: flash_attention_forward_plain(
            q_, k_, v_, True, None, offset),
        sets, iters=10, graph=False)["device"]
    tol = BWD_TOL["flash_attention_backward"][dtype]
    ok = (out_err <= ATTN_TOL[dtype] and lse_err <= LSE_TOL * lse_scale
          and all(e <= tol * scale for e, scale in errs) and unseen_zero
          and repeats == fwd_repeats == BWD_REPEATS)
    return {
        "kernel": "flash_attention_backward", "case": name,
        "shape": {"b": b, "h": h, "hkv": hkv, "sq": sq, "skv": s, "d": d,
                  "q_offset": off},
        "dtype": dtype_name(dtype), "q_offset": off,
        "max_abs_err": max(e for e, _ in errs),
        "grad_max_abs_err": dict(zip(("dq", "dk", "dv"),
                                     (e for e, _ in errs))),
        "grad_max_abs": dict(zip(("dq", "dk", "dv"), (m for _, m in errs))),
        "tol": tol, "tol_is": "of each gradient's largest magnitude",
        "forward_out_max_abs_err": out_err, "forward_out_tol": ATTN_TOL[dtype],
        "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL * lse_scale,
        "unseen_keys_zero": unseen_zero, "unseen_keys": s - unseen,
        "bitwise_equal_calls": repeats,
        "forward_bitwise_equal_calls": fwd_repeats, "ok": ok,
        "kernel_ms": kernel["device"], "kernel_eager_ms": kernel["eager"],
        "kernel_trace_ms": kernel_trace["ms"],
        "kernels_per_call": kernel_trace["launches_per_call"],
        "forward_lse_ms": forward["device"],
        "forward_lse_bound_ms": bound(*fwd_work,
                                      PRODUCT_FLOPS[dtype])["bound_ms"],
        "forward_plain_ms": forward_plain_ms,
        "forward_library_ms": forward_library["ms"],
        "forward_library_backend": forward_library["backend"],
        "plain_ms": plain_ms, "library_ms": library["ms"],
        "library_backend": library["backend"],
        "library_note": "SDPA with the block's boolean mask, its backward "
                        "by autograd",
        **bound(flops, nbytes, PRODUCT_FLOPS[dtype]),
        "flops": flops, "bytes": nbytes,
    }


def _offset_attention_cases() -> list:
    """The training route with ``q_offset``, from a stream of its own: the
    train_lm layer (9 heads over 3 KV heads of 64, 8 rows of 2048) and
    train_zamba's shared block (32 heads of 160, 3 rows of 2048), each as
    rank 1's block of a two-rank split and at a ragged length (2,047: 1,023
    rows from 1,024); the train_lm layer as rank 0's block too (its later
    rank's keys unseen); fp32 and bf16."""
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    zamba = get_config(ZAMBA_ARCH)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases.append(_offset_attention_case(
            "q_offset rank 1 train_lm", LM_BATCH, 9, 3, LM_SEQ, 64, dtype,
            gen, bitwise=True))
        cases.append(_offset_attention_case(
            "q_offset rank 1 ragged s=2047", LM_BATCH, 9, 3, LM_SEQ - 1, 64,
            dtype, gen))
        cases.append(_offset_attention_case(
            "q_offset rank 0 train_lm", LM_BATCH, 9, 3, LM_SEQ, 64, dtype,
            gen, rank=0))
        cases.append(_offset_attention_case(
            "q_offset rank 1 zamba2 d=160", ZAMBA_BATCH, zamba.num_heads,
            zamba.num_kv_heads, ZAMBA_SEQ, zamba.resolved_head_dim, dtype,
            gen, bitwise=True))
        cases.append(_offset_attention_case(
            "q_offset rank 1 zamba2 ragged s=2047, d=160", ZAMBA_BATCH,
            zamba.num_heads, zamba.num_kv_heads, ZAMBA_SEQ - 1,
            zamba.resolved_head_dim, dtype, gen))
        torch.cuda.empty_cache()
    return cases


def _ssd_init_cases() -> list:
    """The SSD scan from an ``init_state`` at train_mamba's layer (8 rows
    of 2048, 48 heads of 64, n 128), from a stream of its own, fp32 and
    bf16: the forward (``ssd_scan_cuda``), the training forward (its
    incoming states, chunk 0's the initial state) and the backward with
    the initial state's cotangent, against the plain versions: y and the
    final state to SSD_REL_TOL of their largest, each cotangent to BWD_TOL
    of its largest (``dinit`` among them), three backward calls bitwise
    equal. A forward case (``ssd_scan``) and a backward case
    (``ssd_scan_backward``) each, with their times, bounds and plain
    versions' times; no library call computes either."""
    cfg = get_config(MAMBA_ARCH)
    b, s, h = MAMBA_BATCH, MAMBA_SEQ, cfg.ssm_heads
    p, n, g, chunk = (cfg.ssm.head_dim, cfg.ssm.state_dim, cfg.ssm.ngroups,
                      cfg.ssm.chunk_size)
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    cases = []
    di, gn = h * p, g * n
    shape = {"b": b, "s": s, "h": h, "p": p, "n": n, "g": g, "chunk": chunk,
             "init_state": True}
    for dtype in (torch.float32, torch.bfloat16):
        xbc = torch.randn((b, s, di + 2 * gn), generator=gen,
                          device=DEVICE).to(dtype)

        def split(t):
            return (t[..., :di].unflatten(-1, (h, p)),
                    t[..., di:di + gn].unflatten(-1, (g, n)),
                    t[..., di + gn:].unflatten(-1, (g, n)))
        x, B, C = split(xbc)
        dt = F.softplus(torch.randn((b, s, h), generator=gen, device=DEVICE))
        A = -torch.exp(0.5 * torch.randn((h,), generator=gen, device=DEVICE))
        init = torch.randn((b, h, p, n), generator=gen, device=DEVICE)
        dy = torch.randn((b, s, h, p), generator=gen, device=DEVICE).to(dtype)
        rel = SSD_REL_TOL[dtype]
        y, st = ssd_module.ssd_scan_cuda(x, dt, A, B, C, chunk, init)
        train = ssd_module.ssd_scan_train_cuda(x, dt, A, B, C, chunk, init)
        torch.cuda.synchronize()
        want_y, want_st = ssd_scan_plain(x, dt, A, B, C, chunk, init)
        errs_fwd = _scaled_errors((y, st, train[0], train[1]),
                                  (want_y, want_st, want_y, want_st))
        chunk0_is_init = bool(torch.equal(train[4][:, :, 0], init))
        del y, st, want_y, want_st
        flops, nbytes = ssd_module.work(b, s, h, p, n, g, chunk, dtype, True)
        sets = [split(clone_like(xbc))
                for _ in range(copies_for_cold_l2([xbc, dt]))]
        kernel = time_ms(lambda x_, B_, C_: ssd_module.ssd_scan_cuda(
            x_, dt, A, B_, C_, chunk, init), sets, 20)
        train_ms = time_ms(lambda x_, B_, C_: ssd_module.ssd_scan_train_cuda(
            x_, dt, A, B_, C_, chunk, init), sets, 20)["device"]
        cases.append({
            "kernel": "ssd_scan", "case": "init_state train_mamba layer",
            "shape": shape, "dtype": dtype_name(dtype),
            "max_abs_err": max(e for e, _ in errs_fwd),
            "tol": rel * max(1.0, max(m for _, m in errs_fwd)),
            "errors": {k: {"max_abs_err": e, "scale": m} for k, (e, m) in zip(
                ("y", "state", "train_y", "train_state"), errs_fwd)},
            "rel_tol": rel, "chunk0_incoming_is_init": chunk0_is_init,
            "ok": chunk0_is_init and all(e <= rel * max(1.0, m)
                                         for e, m in errs_fwd),
            "kernel_ms": kernel["device"], "kernel_eager_ms": kernel["eager"],
            "train_forward_ms": train_ms,
            "plain_ms": time_ms(lambda x_, B_, C_: ssd_scan_plain(
                x_, dt, A, B_, C_, chunk, init), sets, 5,
                graph=False)["device"],
            "library_ms": None, "library_note": SSD_NO_LIBRARY,
            **bound(flops, nbytes, PRODUCT_FLOPS[dtype]),
            "flops": flops, "bytes": nbytes})
        saved = train[2:]
        del train

        def call(x_, B_, C_, dy_):
            return ssd_module.ssd_scan_backward_cuda(
                x_, dt, A, B_, C_, dy_, None, *saved, chunk, init=True)
        got = call(x, B, C, dy)
        torch.cuda.synchronize()
        errs = _scaled_errors(got, ssd_module.ssd_scan_backward_plain(
            x, dt, A, B, C, dy, None, chunk, init))
        repeats = _bitwise_repeats(lambda: call(x, B, C, dy), got)
        del got
        tol = BWD_TOL["ssd_scan_backward"][dtype]
        flops, nbytes = ssd_module.backward_work(b, s, h, p, n, g, chunk,
                                                 dtype, False, True)
        bsets = [(*split(clone_like(xbc)), dy.clone())
                 for _ in range(copies_for_cold_l2([xbc, dy]))]
        kernel = time_ms(call, bsets, 10, graph=False)
        names = GRADS_SSD + ("dinit",)
        cases.append({
            "kernel": "ssd_scan_backward", "case": "init_state train_mamba "
            "layer", "shape": shape, "dtype": dtype_name(dtype),
            "max_abs_err": max(e for e, _ in errs),
            "grad_max_abs_err": {k: e for k, (e, _) in zip(names, errs)},
            "grad_max_abs": {k: m for k, (_, m) in zip(names, errs)},
            "tol": tol, "tol_is": "of each gradient's largest magnitude",
            "bitwise_equal_calls": repeats,
            "ok": (all(e <= tol * m for e, m in errs)
                   and repeats == BWD_REPEATS),
            "kernel_ms": kernel["device"], "kernel_eager_ms": kernel["eager"],
            "plain_ms": time_ms(lambda x_, B_, C_, dy_:
                                ssd_module.ssd_scan_backward_plain(
                                    x_, dt, A, B_, C_, dy_, None, chunk,
                                    init), bsets, 3, graph=False)["device"],
            "library_ms": None, "library_note": SSD_BWD_NO_LIBRARY,
            **bound(flops, nbytes, PRODUCT_FLOPS[dtype]),
            "flops": flops, "bytes": nbytes})
        del saved, sets, bsets
        torch.cuda.empty_cache()
    return cases


def _bag_tol(want: torch.Tensor, dtype) -> float:
    """Embedding bag, kernel against plain, both directions. fp32: the two
    sum the same terms in another order, up to a few hundred terms a value
    at uniform indices: 1e-5 of the output's scale. The backward's plain
    version is summed in fp64 here (in the kernels phase), because at Zipf
    indices a hot row sums ~13 k terms of either sign, and an fp32 sum of
    that many in index_add_'s order is itself off by up to ~1e-5 of the
    scale; the kernel sums pieces of 128 first and stays well inside. bf16:
    both round once from fp32 values a few fp32 ulps apart, so they may
    land one bf16 ulp apart, 2^-7 of |out|."""
    scale = max(1.0, want.float().abs().max().item())
    return (1e-5 if dtype == torch.float32 else 2 ** -7) * scale


def _bag_err(got: torch.Tensor, want: torch.Tensor, dtype):
    """(max |got - want|, the tolerance), both as floats."""
    err = (got.float() - want.float()).abs().max().item()
    return err, _bag_tol(want, dtype)


def _library_bag(tables, idx):
    """The yardstick's inputs: ``F.embedding_bag`` over the flattened
    (T * R, E) table with each table's indices shifted by t * R, one bag a
    row; None where an index lies outside [0, R) (the library call has no
    wrap, clamp or drop)."""
    t, r, e = tables.shape
    if int(idx.min()) < 0 or int(idx.max()) >= r:
        return None
    shift = r * torch.arange(t, device=idx.device, dtype=torch.int64)
    flat = (idx.long() + shift[None, :, None]).reshape(-1, idx.shape[2])
    return tables.view(t * r, e), flat


def _bag_case(name, tables, idx, direction, big, gen) -> dict:
    """One embedding-bag case, forward or backward, on the inputs given.
    ``big``: the main shape, timed eagerly over 10 calls (each is
    milliseconds, the plain versions' temporaries gigabytes)."""
    t, r, e = tables.shape
    b, _, n = idx.shape
    dtype = tables.dtype
    wrapped = torch.where(idx < 0, idx.long() + r, idx.long())
    shift = r * torch.arange(t, device=idx.device)[None, :, None]
    timing = dict(iters=10, graph=False) if big else {}
    timed = "eager, 10 calls" if big else "graph replay of 50 calls"
    library = _library_bag(tables, idx)
    extra = {}
    lookups = b * t * n
    if direction == "forward":
        rows = (wrapped.clamp(0, r - 1) + shift).flatten()
        distinct = int(torch.unique(rows).numel())
        got = ops.embedding_bag(tables, idx)
        torch.cuda.synchronize()
        err, tol = _bag_err(got, embedding_bag_plain(tables, idx), dtype)
        del got
        # what this call's data needs: each distinct row read once
        flops, nbytes = bag_module.forward_work(b, t, n, e, dtype,
                                                rows_read=distinct)
        all_bytes = bag_module.forward_work(b, t, n, e, dtype)[1]
        sets = [(tables, idx)]
        kernel = time_ms(embedding_bag_cuda, sets, **timing)
        plain_ms = time_ms(embedding_bag_plain, sets, **timing)["device"]
        library_ms = None
        if library is not None:
            # eager: the library call is not known to be capturable
            weight, flat = library
            timed = f"{timed}; library: eager"
            library_ms = time_ms(lambda w, f: F.embedding_bag(
                f, w, mode="sum"), [(weight, flat)],
                iters=timing.get("iters", 50), graph=False)["device"]
    else:
        dout = torch.randn((b, t + 1, e), generator=gen,
                           device=DEVICE).to(dtype)[:, 1:]   # the model's view
        valid = (wrapped >= 0) & (wrapped < r)
        distinct = int(torch.unique((wrapped + shift)[valid]).numel())
        got = embedding_bag_backward_cuda(dout, idx, r)
        torch.cuda.synchronize()
        # fp32: the plain version summed in fp64, so that what is compared
        # is the kernel's own rounding (see _bag_tol)
        exact = dout.double() if dtype == torch.float32 else dout
        err, tol = _bag_err(got, embedding_bag_backward_plain(exact, idx, r),
                            dtype)
        if big:   # the same inputs give the same bits, call after call
            extra["bitwise_equal_calls"] = 1 + sum(
                torch.equal(embedding_bag_backward_cuda(dout, idx, r), got)
                for _ in range(BAG_REPEATS - 1))
            extra["ok"] = (err <= tol and
                           extra["bitwise_equal_calls"] == BAG_REPEATS)
        del got
        flops, nbytes = bag_module.backward_work(b, t, n, r, e, dtype,
                                                 kept=int(valid.sum()))
        all_bytes = nbytes
        sets = [(dout, idx)]
        kernel = time_ms(lambda d, i: embedding_bag_backward_cuda(d, i, r),
                         sets, **timing)
        extra["kernels_per_call"] = backward_kernels_per_call(b, t, n, r)
        if big:
            # each stage's device time alone, on the scratch of one whole
            # call (a stage reads what the stages before it wrote)
            bufs = embedding_bag_backward_buffers(dout, idx, r)
            embedding_bag_backward_stages_cuda(dout, idx, r, bufs)
            extra["stage_ms"] = {
                stage: time_ms(
                    lambda d, i, stage=stage: embedding_bag_backward_stages_cuda(
                        d, i, r, bufs, (stage,)), sets, **timing)["device"]
                for stage in BACKWARD_STAGES}
            del bufs
        # The plain version's masked select and autograd's backward cannot
        # be captured into a graph: both are timed eagerly.
        eager = dict(iters=timing.get("iters", 50), graph=False)
        timed = f"kernel: {timed}; plain and library: eager"
        plain_ms = time_ms(lambda d, i: embedding_bag_backward_plain(d, i, r),
                           sets, **eager)["device"]
        library_ms = None
        if library is not None:
            weight = library[0].detach().clone().requires_grad_()
            with torch.enable_grad():
                out = F.embedding_bag(library[1], weight, mode="sum")
            dflat = dout.reshape(b * t, e)
            library_ms = time_ms(lambda o, g: torch.autograd.grad(
                o, weight, g, retain_graph=True), [(out, dflat)],
                **eager)["device"]
            del weight, out
        del dout
    return {
        "kernel": ("embedding_bag" if direction == "forward"
                   else "embedding_bag_backward"),
        "case": name, "shape": {"t": t, "r": r, "e": e, "b": b, "l": n},
        "dtype": dtype_name(dtype), "max_abs_err": err, "tol": tol,
        "kernel_ms": kernel["device"], "kernel_eager_ms": kernel["eager"],
        "timed": timed,
        "plain_ms": plain_ms, "library_ms": library_ms,
        **({} if library_ms is not None else {
            "library_note": "an index outside [0, R): F.embedding_bag has no "
                            "wrap, clamp or drop"}),
        **bound(flops, nbytes, PEAK_FLOPS[torch.float32]),
        "bytes": nbytes, "bytes_all_lookups": all_bytes,
        "distinct_rows": distinct, "lookups": lookups, **extra,
    }


def _zipf_indices(gen, b, t, n, r) -> torch.Tensor:
    """(b, t, n) int32: each table's rows drawn with replacement, row k with
    weight (k + 1)^-ZIPF_ALPHA, on the card from ``gen``."""
    weight = torch.arange(1, r + 1, device=DEVICE,
                          dtype=torch.float32) ** -ZIPF_ALPHA
    rows = torch.multinomial(weight.expand(t, r), b * n, replacement=True,
                             generator=gen)
    return rows.view(t, b, n).permute(1, 0, 2).contiguous().int()


def _bag_cases() -> list:
    """Embedding-bag cases, forward and backward, fp32 and bf16: the DLRM
    training step's shape (batch 4096 over 64 tables of 200,000 x 128, 32
    lookups) at uniform indices and at Zipf-skewed ones (the hottest row of
    a table takes ~13 k of its 131 k lookups), the reference tests' table,
    the reduced config's shape, and a case with negative and >= R indices
    (scalar path: rows of 40 bytes). Every uniform backward case has a
    duplicate row in every bag. At the two main shapes the backward also
    runs BAG_REPEATS times on the same inputs, and a result that differs in
    any bit fails the case."""
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    # the Zipf cases draw from a stream of their own, so the other cases
    # keep the inputs they always had
    gen_zipf = torch.Generator(device=DEVICE).manual_seed(4)
    cfg = _dlrm_setup()[0]
    small = [("table t4 r50 e16 b3 l7", 4, 50, 16, 3, 7),
             ("table t2 r128 e32 b8 l1", 2, 128, 32, 8, 1),
             ("table t8 r16 e8 b2 l16", 8, 16, 8, 2, 16),
             ("reduced config", 4, 1000, 16, 64, 32),
             ("out of range", 3, 10, 10, 5, 9)]
    cases = []
    with torch.no_grad():
        main = torch.randn((cfg.num_tables, cfg.rows_per_table, cfg.emb_dim),
                           generator=gen, device=DEVICE)
        shape = (DLRM_BATCH, cfg.num_tables, cfg.lookups_per_table)
        for dtype in (torch.float32, torch.bfloat16):
            tables = main if dtype == torch.float32 else main.to(dtype)
            idx = torch.randint(0, cfg.rows_per_table, shape, generator=gen,
                                device=DEVICE, dtype=torch.int32)
            cases.append(_bag_case("main", tables, idx, "forward", True, gen))
            idx[..., 1] = idx[..., 0]
            cases.append(_bag_case("main", tables, idx, "backward", True, gen))
            idx = _zipf_indices(gen_zipf, *shape, cfg.rows_per_table)
            cases.append(_bag_case("zipf", tables, idx, "forward", True, gen))
            cases.append(_bag_case("zipf", tables, idx, "backward", True,
                                   gen))
            del tables, idx
            for name, t, r, e, b, n in small:
                tables = torch.randn((t, r, e), generator=gen,
                                     device=DEVICE).to(dtype)
                lo = -2 * r if name == "out of range" else 0
                idx = torch.randint(lo, 2 * r if lo else r, (b, t, n),
                                    generator=gen, device=DEVICE,
                                    dtype=torch.int32)
                cases.append(_bag_case(name, tables, idx, "forward", False,
                                       gen))
                if n > 1:
                    idx[..., 1] = idx[..., 0]
                cases.append(_bag_case(name, tables, idx, "backward", False,
                                       gen))
            torch.cuda.empty_cache()
        del main
    torch.cuda.empty_cache()
    return cases


def phase_kernels() -> list:
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    # mamba2's cases draw from a stream of their own, so the dense cases
    # keep the inputs they always had
    gen_mamba = torch.Generator(device=DEVICE).manual_seed(1)
    # and the cases added with the redesigned attention kernels from a third
    # (their positions too, so the decode tick keeps its positions)
    gen_attn = torch.Generator(device=DEVICE).manual_seed(3)
    # granite-moe's shapes from a fourth, zamba2's and seamless's from a fifth
    gen_moe = torch.Generator(device=DEVICE).manual_seed(4)
    gen_zamba = torch.Generator(device=DEVICE).manual_seed(5)
    # the reduced configs' head_dim 16 from a sixth
    gen_reduced = torch.Generator(device=DEVICE).manual_seed(7)
    # and their norms from a seventh
    gen_norm_64 = torch.Generator(device=DEVICE).manual_seed(8)
    rs_reduced = np.random.RandomState(7)
    rs = np.random.RandomState(0)
    rs_attn = np.random.RandomState(3)
    rs_moe = np.random.RandomState(4)
    rs_zamba = np.random.RandomState(5)
    cases = []
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            # the main path's shapes first, then ragged rows, a wide row and
            # a row that is not a whole number of 16-byte packs
            for shape in ((8, 1, 576), (1, 1024, 576), (3, 37, 576),
                          (2, 64, 4096), (3, 7, 100)):
                cases.append(_rmsnorm_case(shape, dtype, gen))
            decode_pos = rs.randint(0, 2048, size=8).tolist()
            cases.append(_attention_case(
                "decode tick", 8, 9, 3, 1, 2048, 64, True, dtype, gen,
                q_offset=decode_pos, clusters=True))
            for s in (17, 130, 1024, 2048):
                cases.append(_attention_case(
                    f"prefill s={s}", 1, 9, 3, s, s, 64, True, dtype, gen))
            # the reference tests' table, for the head dims the kernel takes
            cases.append(_attention_case(
                "GQA group 2", 2, 4, 2, 256, 256, 64, True, dtype, gen))
            cases.append(_attention_case(
                "MQA non-causal d=128", 2, 2, 1, 64, 64, 128, False, dtype, gen))
            cases.append(_attention_case(
                "uneven length 100", 1, 4, 4, 100, 100, 64, True, dtype, gen))
            cases.append(_attention_case(
                "GQA group 3", 1, 6, 2, 96, 96, 64, True, dtype, gen))
            # sq != skv with both per-sequence arguments, both kernels
            cases.append(_attention_case(
                "chunk of 40 rows into a cache, d=128", 2, 4, 2, 40, 200, 128,
                True, dtype, gen, kv_len=[200, 77], q_offset=[160, 37]))
            cases.append(_attention_case(
                "3 rows non-causal with kv_len, d=128", 2, 8, 2, 3, 300, 128,
                False, dtype, gen, kv_len=[300, 1]))
            # every slot at the cache's end (the idle slots' clamp), a
            # chatglm3-6b tick (group 16, d 128), a mid-length prompt
            cases.append(_attention_case(
                "decode at the cache's end", 8, 9, 3, 1, 2048, 64, True,
                dtype, gen_attn, q_offset=[2047] * 8))
            # one key a sequence: the decode kernel's fixed cost (launch,
            # q, the merges)
            cases.append(_attention_case(
                "decode, one key a sequence", 8, 9, 3, 1, 2048, 64, True,
                dtype, gen_attn, q_offset=[0] * 8))
            cases.append(_attention_case(
                "decode chatglm3 group 16, d=128", 8, 32, 2, 1, 2048, 128,
                True, dtype, gen_attn,
                q_offset=rs_attn.randint(0, 2048, size=8).tolist()))
            cases.append(_attention_case(
                "prefill s=512", 1, 9, 3, 512, 512, 64, True, dtype,
                gen_attn))
            # mamba2-780m's norms: decode tick and prefill, d_model 1536
            # and the gated norm's d_inner 3072
            for shape in ((8, 1, 1536), (8, 1, 3072), (1, 1024, 3072)):
                cases.append(_rmsnorm_case(shape, dtype, gen_mamba,
                                           ulp_tol=True))
            # SSD scan: the main path's prefill, a ragged last chunk, a
            # prompt shorter than a chunk, the reference tests' table (B/C
            # one group each) and a grouped case
            cases.append(_ssd_case("main prefill", 1, 1024, 48, 64, 128, 1,
                                   256, dtype, gen_mamba, stages=True))
            for s in (700, 17):
                cases.append(_ssd_case(f"prefill s={s}", 1, s, 48, 64, 128,
                                       1, 256, dtype, gen_mamba))
            for b, h, s, p, n, chunk in ((2, 3, 128, 16, 32, 32),
                                         (1, 2, 100, 8, 16, 32),
                                         (2, 4, 64, 32, 64, 64),
                                         (1, 1, 256, 64, 128, 128)):
                cases.append(_ssd_case(f"table b{b} h{h} s{s} p{p} n{n} "
                                       f"chunk{chunk}", b, s, h, p, n, 1,
                                       chunk, dtype, gen_mamba))
            cases.append(_ssd_case("grouped h4 g2", 2, 45, 4, 16, 16, 2, 32,
                                   dtype, gen_mamba))
            # granite-moe-3b-a800m's layer (serve_moe): 24 query heads, 8 KV
            # heads of 64; its decode tick, a 1024-token prefill, and the
            # prefill's norms at d_model 1536 (its tick's are mamba2's above)
            cases.append(_attention_case(
                "granite decode tick", 8, 24, 8, 1, 2048, 64, True, dtype,
                gen_moe, q_offset=rs_moe.randint(0, 2048, size=8).tolist()))
            cases.append(_attention_case(
                "granite prefill s=1024", 1, 24, 8, 1024, 1024, 64, True,
                dtype, gen_moe))
            cases.append(_rmsnorm_case((1, 1024, 1536), dtype, gen_moe,
                                       ulp_tol=True))
            # zamba2-2.7b's shapes (serve_zamba): the shared block's MHA
            # at head_dim 160, its decode tick and a 1024-token prefill; the
            # scan at 80 heads of 64, n 64; the prefill's norm at 5120 (the
            # shared block's input and the gated norm's d_inner)
            cases.append(_attention_case(
                "zamba2 decode tick, d=160", 8, 32, 32, 1, 2048, 160, True,
                dtype, gen_zamba,
                q_offset=rs_zamba.randint(0, 2048, size=8).tolist(),
                clusters=True))
            cases.append(_attention_case(
                "zamba2 prefill s=1024, d=160", 1, 32, 32, 1024, 1024, 160,
                True, dtype, gen_zamba))
            cases.append(_ssd_case("zamba2 prefill", 1, 1024, 80, 64, 64, 1,
                                   256, dtype, gen_zamba))
            cases.append(_rmsnorm_case((1, 1024, 5120), dtype, gen_zamba,
                                       ulp_tol=True))
            # seamless-m4t-large-v2's (serve_encdec): an encoder layer's
            # attention over 1024 frames, not causal, and a decode tick's
            # cross-attention over them
            cases.append(_attention_case(
                "seamless encoder layer", 8, 16, 16, 1024, 1024, 64, False,
                dtype, gen_zamba))
            cases.append(_attention_case(
                "seamless cross decode", 8, 16, 16, 1, 1024, 64, False,
                dtype, gen_zamba))
            # the reduced configs' head_dim 16 (serve_reduced): their decode
            # tick (4 slots, 4 heads over 2 KV heads, launch.serve's cache
            # of 128 rows: a cluster of 8 runs as 4) and the same over 512
            # keys (a cluster of 8 of its own), each cluster held and timed;
            # a ragged prefill (the prefill kernels without the log-sum-exp)
            # and a 5-token prompt (the decode kernels)
            for skv in (128, 512):
                cases.append(_attention_case(
                    f"reduced decode tick skv={skv}, d=16", 4, 4, 2, 1, skv,
                    16, True, dtype, gen_reduced,
                    q_offset=rs_reduced.randint(0, skv, size=4).tolist(),
                    clusters=True))
            cases.append(_attention_case(
                "reduced prefill s=23, d=16", 1, 4, 2, 23, 23, 16, True,
                dtype, gen_reduced))
            cases.append(_attention_case(
                "reduced prompt s=5, d=16", 2, 4, 2, 5, 5, 16, True, dtype,
                gen_reduced))
            # their norms at d_model 64 (16 fp32 or 8 bf16 packs a row,
            # fewer than a warp's lanes): the tick and the ragged prefill
            for shape in ((4, 1, 64), (1, 23, 64)):
                cases.append(_rmsnorm_case(shape, dtype, gen_norm_64))
    cases.extend(_partial_cases())
    cases.extend(_bag_cases())
    cases.extend(_backward_cases())
    cases.extend(_ssd_backward_cases())
    cases.extend(_offset_attention_cases())
    cases.extend(_ssd_init_cases())
    failed = [c for c in cases
              if not c.get("ok", c["max_abs_err"] <= c["tol"])]
    emit("kernels", cases=cases, failed=len(failed))
    if failed:
        raise SystemExit(f"chip_smoke: {len(failed)} kernel case(s) disagree "
                         f"with the plain version: {failed}")
    # A head dim the kernel does not take must raise, not run something else.
    q = torch.zeros((1, 2, 8, 32), device=DEVICE)
    try:
        ops.flash_attention(q, q, q)
    except ValueError:
        pass
    else:
        raise SystemExit("chip_smoke: head_dim 32 was accepted")
    return cases


def _differing_calls(fn) -> int:
    """Of REPEAT_CALLS calls of ``fn``, those after the first whose results
    differ from the first's in any bit."""
    first = fn()
    torch.cuda.synchronize()
    return sum(not all(torch.equal(a, b) for a, b in zip(fn(), first))
               for _ in range(REPEAT_CALLS - 1))


def phase_repeats() -> list:
    """The open fault F3 (on one machine, repeated attention-backward calls
    were not bitwise equal): REPEAT_CALLS calls each of the attention
    forward with the log-sum-exp and of its backward at the train_lm layer
    and at the chatglm3-like layer (the backward's group split over 16
    blocks), of the RMSNorm backward at the train_lm rows and of the SSD
    scan backward at the train_mamba layer, fp32 and bf16, and of the
    attention both ways at the train_zamba layer (head_dim 160), fp32; each
    call's bits against the first call's. Any difference fails the phase."""
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, b, h, hkv, s, d in (
                ("train main", LM_BATCH, 9, 3, LM_SEQ, 64),
                ("chatglm3-like d=128", 1, 32, 2, 1024, 128)):
            q, k, v, do = (
                torch.randn((b, s, heads, d), generator=gen, device=DEVICE)
                .to(dtype).transpose(1, 2) for heads in (h, hkv, hkv, h))
            out, lse = flash_attention_lse_cuda(q, k, v, True)
            shape = {"b": b, "h": h, "hkv": hkv, "s": s, "d": d,
                     "splits": flash_attention_backward_plan(
                         b, h, hkv, s, d)[0]}
            for kernel, fn in (
                    ("flash_attention_forward_lse",
                     lambda: flash_attention_lse_cuda(q, k, v, True)),
                    ("flash_attention_backward",
                     lambda: flash_attention_backward_cuda(q, k, v, out, lse,
                                                           do, True))):
                cases.append({"kernel": kernel, "case": name, "shape": shape,
                              "dtype": dtype_name(dtype),
                              "calls": REPEAT_CALLS,
                              "differing": _differing_calls(fn)})
            del q, k, v, do, out, lse
        shape = (LM_BATCH * LM_SEQ, 576)
        x, dy = (torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
                 for _ in range(2))
        gamma = (1.0 + 0.1 * torch.randn(shape[-1], generator=gen,
                                         device=DEVICE)).to(dtype)
        cases.append({"kernel": "rmsnorm_backward", "case": "train main",
                      "shape": list(shape), "dtype": dtype_name(dtype),
                      "calls": REPEAT_CALLS, "differing": _differing_calls(
                          lambda: rmsnorm_backward_cuda(x, gamma, dy))})
        del x, dy, gamma
    # the SSD scan backward from a stream of its own, so the cases above
    # keep the inputs they always had
    cfg = get_config(MAMBA_ARCH)
    b, s, h = MAMBA_BATCH, MAMBA_SEQ, cfg.ssm_heads
    p, n, chunk = cfg.ssm.head_dim, cfg.ssm.state_dim, cfg.ssm.chunk_size
    gen_ssd = torch.Generator(device=DEVICE).manual_seed(8)
    for dtype in (torch.float32, torch.bfloat16):
        x, dy = (torch.randn((b, s, h, p), generator=gen_ssd, device=DEVICE)
                 .to(dtype) for _ in range(2))
        B, C = (torch.randn((b, s, 1, n), generator=gen_ssd, device=DEVICE)
                .to(dtype) for _ in range(2))
        dt = F.softplus(torch.randn((b, s, h), generator=gen_ssd,
                                    device=DEVICE))
        A = -torch.exp(0.5 * torch.randn((h,), generator=gen_ssd,
                                         device=DEVICE))
        saved = ssd_module.ssd_scan_train_cuda(x, dt, A, B, C, chunk)[2:]
        cases.append({
            "kernel": "ssd_scan_backward", "case": "train main",
            "shape": {"b": b, "s": s, "h": h, "p": p, "n": n, "g": 1,
                      "chunk": chunk},
            "dtype": dtype_name(dtype), "calls": REPEAT_CALLS,
            "differing": _differing_calls(
                lambda: ssd_module.ssd_scan_backward_cuda(
                    x, dt, A, B, C, dy, None, *saved, chunk))})
        del x, dy, B, C, saved
    # attention at zamba2's training layer (head_dim 160), fp32, from a
    # stream of its own as well
    gen_160 = torch.Generator(device=DEVICE).manual_seed(9)
    cfg = get_config(ZAMBA_ARCH)
    b, s, h, hkv, d = (ZAMBA_BATCH, ZAMBA_SEQ, cfg.num_heads,
                       cfg.num_kv_heads, cfg.resolved_head_dim)
    q, k, v, do = (torch.randn((b, s, heads, d), generator=gen_160,
                               device=DEVICE).transpose(1, 2)
                   for heads in (h, hkv, hkv, h))
    out, lse = flash_attention_lse_cuda(q, k, v, True)
    shape = {"b": b, "h": h, "hkv": hkv, "s": s, "d": d,
             "splits": flash_attention_backward_plan(b, h, hkv, s, d)[0]}
    for kernel, fn in (
            ("flash_attention_forward_lse",
             lambda: flash_attention_lse_cuda(q, k, v, True)),
            ("flash_attention_backward",
             lambda: flash_attention_backward_cuda(q, k, v, out, lse, do,
                                                   True))):
        cases.append({"kernel": kernel, "case": "zamba2 train d=160",
                      "shape": shape, "dtype": "float32",
                      "calls": REPEAT_CALLS,
                      "differing": _differing_calls(fn)})
    del q, k, v, do, out, lse
    torch.cuda.empty_cache()
    failed = [c for c in cases if c["differing"]]
    emit("repeats", cases=cases, failed=len(failed))
    if failed:
        raise SystemExit(f"chip_smoke: {len(failed)} repeat check(s) gave "
                         f"results that differ from the first call: {failed}")
    return cases


class _Timed:
    """Wraps a model method: synchronises around each call and keeps the
    milliseconds, so prefills and decode ticks are counted and timed."""

    def __init__(self, fn):
        self.fn = fn
        self.ms = []

    def __call__(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


PLAIN = {"flash_attention": flash_attention_plain, "rmsnorm": rmsnorm_plain,
         "ssd_scan": ssd_scan_plain}


def _expected_launches(cfg, prefills: int, ticks: int) -> dict:
    """Each kernel's launches on the serve path, by the model's structure:
    two norms a layer and the final norm in every forward; attention in
    every layer of every forward (dense), the scan in every layer of a
    prefill (mamba2: a decode tick is the plain recurrence). zamba2 adds
    its shared block after each group of ``attn_every`` layers: attention
    and two norms, in every forward."""
    forwards = prefills + ticks
    mamba = cfg.family in ("ssm", "hybrid")
    groups = (cfg.num_layers // cfg.hybrid.attn_every
              if cfg.family == "hybrid" else 0)
    return {"flash_attention": (groups if mamba else cfg.num_layers)
            * forwards,
            "rmsnorm": (2 * cfg.num_layers + 2 * groups + 1) * forwards,
            "ssd_scan": cfg.num_layers * prefills if mamba else 0}


def _schedule_spies(engine: Engine, tick_timer) -> tuple:
    """Record, for the engine's run, the requests each tick's ``_admit``
    admits and the active slots at each ``decode_step`` (which goes on to
    ``tick_timer``). Adds no tick and no launch."""
    admitted, occupancy = [], []
    admit = engine._admit

    def admit_spy():
        queued = len(engine.queue)
        admit()
        admitted.append(queued - len(engine.queue))

    def decode_spy(cache, tokens):
        occupancy.append(len(engine.active))
        return tick_timer(cache, tokens)

    engine._admit = admit_spy
    engine.model.decode_step = decode_spy
    return admitted, occupancy


def phase_serve(arch: str, phase: str, weight_device: str) -> dict:
    """Full-size ``arch`` in bf16 with random weights drawn on
    ``weight_device`` from seed 0, 16 requests through the engine, launch
    counts checked, and the engine's admissions and occupancy tick for tick
    against ``repro_torch.serving.ServingWorkload.engine_schedule``; then
    the kernel path against the plain path in fp32 on the same weights (one
    prefill of (2, 300) and one decode tick)."""
    cfg = get_config(arch)
    make = lambda dtype: get_model(cfg)(
        cfg, dtype=dtype, device=DEVICE,
        generator=torch.Generator(device=weight_device).manual_seed(0))
    t0 = time.perf_counter()
    model = make(torch.bfloat16)
    init_seconds = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    ecfg = EngineConfig(max_batch=8, max_seq=2048, seed=0)
    engine = Engine(cfg, model, ecfg, dtype=torch.bfloat16)
    prefill_timer = model.prefill = _Timed(model.prefill)
    tick_timer = _Timed(model.decode_step)
    admitted, occupancy = _schedule_spies(engine, tick_timer)

    rs = np.random.RandomState(0)
    n_requests, new_tokens = 16, 32
    requests = []
    for uid in range(n_requests):
        plen = int(rs.randint(64, 1025))
        prompt = rs.randint(0, cfg.vocab_size, size=plen).astype(np.int32)
        requests.append(Request(uid=uid, prompt=prompt,
                                max_new_tokens=new_tokens,
                                temperature=0.8 if uid in (3, 11) else 0.0))

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    # The main path: counters to 0 just before, read just after.
    for name in PLAIN:
        getattr(ops, name).launches = 0
    t0 = time.perf_counter()
    for req in requests:
        engine.submit(req)
    done = engine.run_until_drained()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: getattr(ops, name).launches for name in PLAIN}

    prefills, ticks = len(prefill_timer.ms), len(tick_timer.ms)
    tokens = [t for r in done for t in r.out_tokens]
    problems = []
    if len(done) != n_requests or prefills != n_requests:
        problems.append(f"{len(done)} of {n_requests} requests completed, "
                        f"{prefills} prefills")
    if any(len(r.out_tokens) != new_tokens for r in done):
        problems.append("a request did not get its 32 tokens")
    if not all(0 <= t < cfg.padded_vocab for t in tokens):
        problems.append("a token lies outside the padded vocabulary")
    expected = _expected_launches(cfg, prefills, ticks)
    if launches != expected:
        problems.append(f"launches {launches} != {expected}")
    # The analytic engine schedule (eos_id -1: no request stops early).
    schedule = ServingWorkload(cfg, ServingModel(
        max_batch=ecfg.max_batch, max_seq=ecfg.max_seq,
        max_new_tokens=new_tokens)).engine_schedule(
            n_requests, new_tokens=[new_tokens] * n_requests)
    schedule_equal = (schedule.admitted == tuple(admitted)
                      and schedule.occupancy == tuple(occupancy)
                      and schedule.prefills == prefills)
    if not schedule_equal:
        problems.append({"engine_schedule": {
            "admitted": [list(schedule.admitted), admitted],
            "occupancy": [list(schedule.occupancy), occupancy]}})
    peak_bytes = torch.cuda.max_memory_allocated()
    del model.prefill, model.decode_step      # back to the class's methods
    del engine._admit

    # The same weights in fp32: kernel path against plain path on the card.
    model32 = make(torch.float32)
    prompts = torch.from_numpy(
        rs.randint(0, cfg.vocab_size, size=(2, 300))).to(DEVICE)
    nxt = torch.from_numpy(rs.randint(0, cfg.vocab_size, size=(2, 1))).to(DEVICE)

    def run_both():
        cache = model32.init_cache(2, 512)
        first, cache = model32.prefill(prompts, cache)
        second, cache = model32.decode_step(cache, nxt)
        torch.cuda.synchronize()
        return first.float(), second.float()

    kernel_first, kernel_second = run_both()
    kernel_wrappers = {name: getattr(ops, name) for name in PLAIN}
    for name, plain in PLAIN.items():
        setattr(ops, name, plain)
    try:
        plain_first, plain_second = run_both()
    finally:
        for name, wrapper in kernel_wrappers.items():
            setattr(ops, name, wrapper)
    del model32
    logit_err = {
        "prefill": (kernel_first - plain_first).abs().max().item(),
        "decode": (kernel_second - plain_second).abs().max().item()}
    for name, got in (("prefill", kernel_first), ("decode", kernel_second)):
        if got.shape != (2, 1, cfg.padded_vocab) or not torch.isfinite(got).all():
            problems.append(f"fp32 {name} logits: shape {tuple(got.shape)} or "
                            "values not finite")
        if not logit_err[name] <= LOGIT_TOL:
            problems.append(f"fp32 {name} logits differ from the plain path "
                            f"by {logit_err[name]} > {LOGIT_TOL}")

    result = {
        "arch": cfg.arch_id, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "params": n_params, "dtype": "bfloat16", "max_batch": ecfg.max_batch,
        "max_seq": ecfg.max_seq, "requests": len(done), "tokens": len(tokens),
        "prompt_tokens": int(sum(len(r.prompt) for r in requests)),
        "seconds": seconds, "tokens_per_s": len(tokens) / seconds,
        "prefills": prefills, "ticks": ticks,
        "prefill_ms_mean": float(np.mean(prefill_timer.ms)),
        "tick_ms_mean": float(np.mean(tick_timer.ms)),
        "tick_ms_median": float(np.median(tick_timer.ms)),
        "launches": launches, "peak_memory_bytes": peak_bytes,
        "schedule_ticks": [len(schedule.occupancy), len(occupancy)],
        "schedule_admissions": [len(schedule.admitted), len(admitted)],
        "schedule_equal": schedule_equal,
        "weights_init_seconds": init_seconds,
        "fp32_logit_max_abs_err": logit_err, "fp32_logit_tol": LOGIT_TOL,
        "fp32_logit_max_abs": {"prefill": plain_first.abs().max().item(),
                               "decode": plain_second.abs().max().item()},
        "problems": problems,
    }
    emit(phase, **result)
    if problems:
        raise SystemExit(f"chip_smoke: {phase} phase failed: {problems}")
    result["engine"] = engine
    return result


def _device_time(prof, units: int, unit: str):
    """torch.profiler's device time: the total in µs, the launches, and each
    kernel's launches per ``unit`` and µs per launch, largest share first."""
    device_us, launches, by_name = 0.0, 0, []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if us:
            device_us += us
            launches += evt.count
            by_name.append({"name": evt.key[:60],
                            f"launches_per_{unit}": evt.count / units,
                            "device_us_per_launch": us / evt.count})
    by_name.sort(key=lambda e: -e[f"launches_per_{unit}"]
                 * e["device_us_per_launch"])
    return device_us, launches, by_name


PROFILED_TICKS = 8


def _tick_profile(tick) -> dict:
    """``PROFILED_TICKS`` calls of ``tick`` (one decode tick, its sampled
    tokens read to the host), twice: first timed on the host's clock, then
    traced by torch.profiler for the kernels' time on the device. The busy
    share is device time over the untraced wall time, since tracing itself
    slows the host."""
    from torch.profiler import ProfilerActivity, profile
    ticks = PROFILED_TICKS

    def run_ticks():
        for _ in range(ticks):
            tick()
        torch.cuda.synchronize()

    run_ticks()
    t0 = time.perf_counter()
    run_ticks()
    wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_ticks()
    device_us, launches, by_name = _device_time(prof, ticks, "tick")
    if device_us == 0:
        return {"ticks": ticks, "wall_ms_per_tick": wall_ms,
                "device_busy_share": "not measured",
                "reason": "torch.profiler reported no device time"}
    device_ms = device_us / 1e3 / ticks
    return {"ticks": ticks, "wall_ms_per_tick": wall_ms,
            "device_ms_per_tick": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "device_idle_share": 1.0 - device_ms / wall_ms,
            "device_launches_per_tick": launches / ticks,
            "top_device_time": by_name[:12]}


def phase_profile(engine: Engine, phase: str) -> None:
    """More decode ticks of the drained engine's model (its slots are idle
    ones: dense positions are clamped to the cache's last row, mamba2 slots
    go on decoding their stale state; the work per tick is the same), by
    ``_tick_profile``; for the SSM families also one traced prefill."""
    def tick():
        logits, _ = engine.model.decode_step(engine.cache, engine.last_tokens)
        logits[:, 0].argmax(-1).tolist()

    ticks = _tick_profile(tick)
    prefill = (_traced_prefill(engine)
               if engine.cfg.family in ("ssm", "hybrid")
               and "device_ms_per_tick" in ticks else {})
    emit(phase, arch=engine.cfg.arch_id, **ticks, **prefill)


# ------------------------------------------------------------------------- #
# Serving the encoder-decoder
# ------------------------------------------------------------------------- #

# seamless-m4t-large-v2 at full width and depth, bf16, weights from seed 0
# drawn on the card: a batch of 8 sources of src_len = source_frac * 2048
# frames (the audio frontend is a stub: the frames are drawn from a seeded
# generator), decoder prompts of 64 tokens, 32 greedy ticks. The engine has
# no frames input (nor has the reference's), so the phase calls prefill and
# decode_step itself, as the reference's test_serving_matches_forward does.
ENCDEC_ARCH = "seamless-m4t-large-v2"
ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_TICKS, ENCDEC_MAX_SEQ = 8, 64, 32, 2048


def _expected_encdec_launches(cfg, prefills: int, ticks: int,
                              steps: int = 0, remat: str = "none") -> dict:
    """A prefill: the encoder's attention and two norms a layer and
    ``ln_enc``, then the decoder's self- and cross-attention and three
    norms a layer and ``ln_f``; a tick: the decoder's alone. A training
    step of one microbatch: the prefill's kernels with one backward each;
    a policy that recomputes the layers (anything but "none") runs their
    forwards again in the backward (``ln_enc`` and ``ln_f`` lie outside
    them). Split over the model axis a rank launches as many, on its
    heads."""
    enc, dec = cfg.encdec.encoder_layers, cfg.encdec.decoder_layers
    again = 1 if remat == "none" else 2
    attn, norms = enc + 2 * dec, 2 * enc + 3 * dec
    return {"flash_attention": attn * prefills + 2 * dec * ticks
            + again * attn * steps,
            "flash_attention_backward": attn * steps,
            "rmsnorm": (norms + 2) * prefills + (3 * dec + 1) * ticks
            + (again * norms + 2) * steps,
            "rmsnorm_backward": (norms + 2) * steps,
            "ssd_scan": 0}


def phase_serve_encdec() -> dict:
    """The batch's prefill and its ticks through the kernels, launch counts
    checked, the ticks profiled; then the kernel path against the plain
    path in fp32 on the same weights (a prefill of 2 x 40 tokens over 256
    frames and one tick)."""
    cfg = get_config(ENCDEC_ARCH)
    make = lambda dtype: get_model(cfg)(
        cfg, dtype=dtype, device=DEVICE,
        generator=torch.Generator(device=DEVICE).manual_seed(0))
    t0 = time.perf_counter()
    model = make(torch.bfloat16)
    init_seconds = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    src_len = int(cfg.encdec.source_frac * ENCDEC_MAX_SEQ)
    frames = torch.randn(
        (ENCDEC_BATCH, src_len, cfg.d_model), device=DEVICE,
        generator=torch.Generator(device=DEVICE).manual_seed(1))
    rs = np.random.RandomState(2)
    prompts = torch.from_numpy(rs.randint(
        0, cfg.vocab_size, size=(ENCDEC_BATCH, ENCDEC_PROMPT))).to(DEVICE)
    prefill, tick = _Timed(model.prefill), _Timed(model.decode_step)

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    # The main path: counters to 0 just before, read just after.
    for name in PLAIN:
        getattr(ops, name).launches = 0
    t0 = time.perf_counter()
    cache = model.init_cache(ENCDEC_BATCH, ENCDEC_MAX_SEQ, src_len)
    logits, cache = prefill(prompts, cache, frames)
    tokens = [logits[:, -1].argmax(-1)]
    for _ in range(ENCDEC_TICKS):
        logits, cache = tick(cache, tokens[-1][:, None])
        tokens.append(logits[:, -1].argmax(-1))
    out = torch.stack(tokens, dim=1).tolist()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: getattr(ops, name).launches for name in PLAIN}
    peak_bytes = torch.cuda.max_memory_allocated()

    problems = []
    expected = _expected_encdec_launches(cfg, 1, ENCDEC_TICKS)
    if any(launches[name] != expected[name] for name in launches):
        problems.append(f"launches {launches} != {expected}")
    if not all(0 <= t < cfg.padded_vocab for row in out for t in row):
        problems.append("a token lies outside the padded vocabulary")
    if logits.shape != (ENCDEC_BATCH, 1, cfg.padded_vocab) or not bool(
            torch.isfinite(logits).all()):
        problems.append(f"tick logits: shape {tuple(logits.shape)} or "
                        "values not finite")
    if cache["pos"].tolist() != [ENCDEC_PROMPT + ENCDEC_TICKS] * ENCDEC_BATCH:
        problems.append(f"cache clock {cache['pos'].tolist()}")

    def one_tick():
        lg, _ = model.decode_step(cache, tokens[-1][:, None])
        lg[:, -1].argmax(-1).tolist()

    profile = _tick_profile(one_tick)
    del cache, model, frames
    torch.cuda.empty_cache()

    # The same weights in fp32: kernel path against plain path on the card.
    model32 = make(torch.float32)
    frames32 = torch.randn((2, 256, cfg.d_model), device=DEVICE,
                           generator=torch.Generator(device=DEVICE)
                           .manual_seed(3))
    prompt32 = torch.from_numpy(rs.randint(0, cfg.vocab_size,
                                           size=(2, 40))).to(DEVICE)
    nxt = torch.from_numpy(rs.randint(0, cfg.vocab_size,
                                      size=(2, 1))).to(DEVICE)

    def run_both():
        c = model32.init_cache(2, 64, 256)
        first, c = model32.prefill(prompt32, c, frames32)
        second, c = model32.decode_step(c, nxt)
        torch.cuda.synchronize()
        return first.float(), second.float()

    kernel_first, kernel_second = run_both()
    kernel_wrappers = {name: getattr(ops, name) for name in PLAIN}
    for name, plain in PLAIN.items():
        setattr(ops, name, plain)
    try:
        plain_first, plain_second = run_both()
    finally:
        for name, wrapper in kernel_wrappers.items():
            setattr(ops, name, wrapper)
    del model32
    torch.cuda.empty_cache()
    logit_err = {
        "prefill": (kernel_first - plain_first).abs().max().item(),
        "decode": (kernel_second - plain_second).abs().max().item()}
    for name, got in (("prefill", kernel_first), ("decode", kernel_second)):
        if got.shape != (2, 1, cfg.padded_vocab) or not torch.isfinite(got).all():
            problems.append(f"fp32 {name} logits: shape {tuple(got.shape)} or "
                            "values not finite")
        if not logit_err[name] <= LOGIT_TOL:
            problems.append(f"fp32 {name} logits differ from the plain path "
                            f"by {logit_err[name]} > {LOGIT_TOL}")

    result = {
        "arch": cfg.arch_id, "encoder_layers": cfg.encdec.encoder_layers,
        "decoder_layers": cfg.encdec.decoder_layers, "d_model": cfg.d_model,
        "params": n_params, "dtype": "bfloat16", "batch": ENCDEC_BATCH,
        "src_len": src_len, "prompt_len": ENCDEC_PROMPT,
        "max_seq": ENCDEC_MAX_SEQ, "ticks": ENCDEC_TICKS,
        "tokens": ENCDEC_BATCH * (ENCDEC_TICKS + 1), "seconds": seconds,
        "tokens_per_s": ENCDEC_BATCH * (ENCDEC_TICKS + 1) / seconds,
        "prefill_ms": prefill.ms[0],
        "tick_ms_mean": float(np.mean(tick.ms)),
        "tick_ms_median": float(np.median(tick.ms)),
        "launches": launches, "expected_launches": expected,
        "peak_memory_bytes": peak_bytes,
        "weights_init_seconds": init_seconds,
        "profile": profile,
        "fp32_logit_max_abs_err": logit_err, "fp32_logit_tol": LOGIT_TOL,
        "fp32_logit_max_abs": {"prefill": plain_first.abs().max().item(),
                               "decode": plain_second.abs().max().item()},
        "problems": problems,
    }
    emit("serve_encdec", **result)
    if problems:
        raise SystemExit(f"chip_smoke: serve_encdec phase failed: {problems}")
    return result


# ------------------------------------------------------------------------- #
# The reduced configs served at head_dim 16, and the examples
# ------------------------------------------------------------------------- #

# Every arch launch.serve takes (the encoder-decoder needs frames): the
# reduced configs, head_dim 16, through the attention kernels' every route.
SERVE_REDUCED_ARCHS = ("smollm-135m", "mamba2-780m", "granite-moe-3b-a800m",
                       "llama4-maverick-400b-a17b", "internvl2-76b",
                       "zamba2-2.7b", "chatglm3-6b", "internlm2-20b",
                       "minitron-8b")
# An fp32 greedy token of the card may differ from the CPU's only where the
# CPU's two best logits lie this close (the same sums in another order).
GREEDY_GAP_TOL = 1e-4
# The kernels the phase must have launched (the train example runs the
# backwards).
SERVE_REDUCED_KERNELS = ("flash_attention", "flash_attention_backward",
                         "rmsnorm", "rmsnorm_backward", "ssd_scan")


def _top2_gap(cfg, prompt, prefix) -> float:
    """The CPU's fp32 gap between its two largest logits after ``prompt``
    and the tokens ``prefix`` it generated before, on the model launch.serve
    builds (its seed 0, drawn on the CPU)."""
    model = get_model(cfg)(cfg, dtype=torch.float32, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    tokens = torch.as_tensor(np.concatenate(
        [np.asarray(prompt, np.int64), np.asarray(prefix, np.int64)]))[None]
    with torch.no_grad():
        logits, _ = model.prefill(tokens, model.init_cache(
            1, tokens.shape[1], dtype=torch.float32))
    top = torch.topk(logits[0, -1].float(), 2).values
    return (top[0] - top[1]).item()


def _first_differences(cfg, card: list, cpu: list) -> list:
    """For each request whose greedy tokens on the card differ from the
    CPU's: the first differing position, both tokens there and the CPU's
    top-2 logit gap at it."""
    out = []
    for r_card, r_cpu in zip(card, cpu):
        pos = next((i for i, (a, b) in enumerate(zip(r_card.out_tokens,
                                                     r_cpu.out_tokens))
                    if a != b), None)
        if pos is not None:
            out.append({"uid": r_card.uid, "position": pos,
                        "card": r_card.out_tokens[pos],
                        "cpu": r_cpu.out_tokens[pos],
                        "cpu_top2_gap": _top2_gap(cfg, r_cpu.prompt,
                                                  r_cpu.out_tokens[:pos])})
    return out


def load_example(name: str):
    """``examples/<name>.py`` as a module (its ``main`` not yet run); the
    examples' tests load them through this too."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_serve_reduced() -> dict:
    """``python -m repro_torch.launch.serve --arch <a> --reduced`` (its
    ``main``, on the card) for every arch of SERVE_REDUCED_ARCHS in fp32 and
    bf16: 8 requests of 16 tokens through 4 slots, head_dim 16 on every
    attention route; tokens/s and seconds a run on lines of their own. In
    fp32 the greedy tokens against the same command with ``--device cpu``:
    a difference is reported with the CPU's top-2 logit gap at it, and fails
    where that gap is wider than GREEDY_GAP_TOL. Then the two examples on
    the card: ``examples/torch_serve_lm.py`` (batched decoding equal to solo
    decoding, its own assert) and ``examples/torch_train_lm.py`` (300 steps,
    the loss below its bound, its own assert). The launch counts are set to
    0 just before and read just after."""
    problems = []
    t_phase = time.perf_counter()
    _zero_kernel_counts()
    for arch in SERVE_REDUCED_ARCHS:
        cfg = get_config(arch, reduced=True)
        for dtype in ("float32", "bfloat16"):
            argv = ["--arch", arch, "--reduced", "--dtype", dtype]
            printed = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                got = serve_module.main(argv)
            row = {"arch": arch, "dtype": dtype,
                   "requests": len(got["requests"]), "tokens": got["tokens"],
                   "seconds": got["seconds"],
                   "tokens_per_s": got["tokens"] / got["seconds"],
                   "wall_s": time.perf_counter() - t0}
            if got["tokens"] != 128 or any(
                    not 0 <= t < cfg.padded_vocab
                    for r in got["requests"] for t in r.out_tokens):
                problems.append(f"{arch} {dtype}: {got['tokens']} tokens of "
                                "128, or a token outside the vocabulary")
            if dtype == "float32":
                with contextlib.redirect_stdout(printed):
                    cpu = serve_module.main(argv + ["--device", "cpu"])
                diffs = _first_differences(cfg, got["requests"],
                                           cpu["requests"])
                row.update(tokens_equal_cpu=not diffs, differences=diffs,
                           cpu_seconds=cpu["seconds"])
                problems += [f"{arch}: token {d} differs from the CPU's "
                             f"beyond a tie" for d in diffs
                             if d["cpu_top2_gap"] > GREEDY_GAP_TOL]
            emit("serve_reduced", **row)
    for name in ("torch_serve_lm", "torch_train_lm"):
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            load_example(name).main([])
        emit("serve_reduced", example=name,
             seconds=time.perf_counter() - t0,
             output=printed.getvalue().splitlines()[-3:])
    torch.cuda.synchronize()
    launches = _kernel_counts()
    problems += [f"{k} never launched" for k in SERVE_REDUCED_KERNELS
                 if launches[k] <= 0]
    emit("serve_reduced", archs=len(SERVE_REDUCED_ARCHS), launches=launches,
         seconds=time.perf_counter() - t_phase, problems=problems)
    if problems:
        raise SystemExit(f"chip_smoke: serve_reduced phase failed: "
                         f"{problems}")
    return launches


# The SSD scan's stage kernels as torch.profiler names them (either type).
SSD_KERNEL_NAMES = tuple(f"{stage}_{kind}_kernel" for stage in STAGES
                         if stage != "pass" for kind in ("mma", "f32")
                         ) + ("pass_kernel",)


def _traced_prefill(engine: Engine) -> dict:
    """One 1024-token prefill of one sequence (the longest prompt the serve
    phase draws), timed on the host's clock and then traced: its device ms
    and launches, and the SSD scan's share of them (its stage kernels)."""
    from torch.profiler import ProfilerActivity, profile
    model, tokens = engine.model, torch.from_numpy(
        np.random.RandomState(1).randint(
            0, engine.cfg.vocab_size, size=(1, 1024))).to(DEVICE)

    def run():
        logits, _ = model.prefill(tokens, model.init_cache(1, 1024))
        logits[:, 0].argmax(-1).tolist()
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    device_us, launches, by_name = _device_time(prof, 1, "prefill")
    scan_us, scan_launches = 0.0, 0
    for evt in prof.key_averages():
        if any(k in evt.key for k in SSD_KERNEL_NAMES):
            scan_us += getattr(evt, "self_device_time_total",
                               getattr(evt, "self_cuda_time_total", 0.0))
            scan_launches += evt.count
    if device_us == 0:
        return {"prefill_1024": "not measured: torch.profiler reported no "
                                "device time"}
    return {"prefill_1024": {
        "wall_ms": wall_ms, "device_ms": device_us / 1e3,
        "device_launches": launches, "scan_device_ms": scan_us / 1e3,
        "scan_launches": scan_launches, "scan_share": scan_us / device_us,
        "top_device_time": by_name[:8]}}


# ------------------------------------------------------------------------- #
# DLRM training
# ------------------------------------------------------------------------- #

def _dlrm_setup():
    cfg = dataclasses.replace(get_dlrm_config(), rows_per_table=DLRM_ROWS)
    dcfg = DataConfig(vocab_size=0, seq_len=0, global_batch=DLRM_BATCH,
                      seed=0, num_dense=cfg.num_dense_features,
                      num_tables=cfg.num_tables,
                      lookups=cfg.lookups_per_table, rows=cfg.rows_per_table)
    return cfg, dcfg, AdamWConfig(**DLRM_OPT)


def _dlrm_step(model, params, state, ocfg, batch):
    """The reference's composition: loss -> backward -> apply_updates (in
    place), then the gradients are let go."""
    loss, _ = model.loss(batch)
    loss.backward()
    _, _, metrics = apply_updates(
        params, {n: p.grad for n, p in params.items()}, state, ocfg)
    model.zero_grad(set_to_none=True)
    return loss, metrics


def phase_train_dlrm() -> dict:
    """dlrm-1.2t at full width (rows cut to DLRM_ROWS), fp32 parameters and
    Adam moments, weights from seed 0 drawn on the card, batches from the
    port's DataIterator: DLRM_STEPS steps, each synchronised and timed; then
    two more under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    cfg, dcfg, ocfg = _dlrm_setup()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = DLRM(cfg, seed=0, device=DEVICE)
    params = dict(model.named_parameters())
    state = init_state(params, ocfg)
    torch.cuda.synchronize()
    init_seconds = time.perf_counter() - t0
    data = DataIterator(dcfg, kind="dlrm", device=DEVICE)

    def step():
        loss, metrics = _dlrm_step(model, params, state, ocfg, next(data))
        return loss.item(), metrics

    losses, step_ms = [], []
    torch.cuda.synchronize()
    # The main path: counters to 0 just before, read just after.
    ops.embedding_bag.launches = 0
    ops.embedding_bag.backward_launches = 0
    t_run = time.perf_counter()
    for _ in range(DLRM_STEPS):
        t1 = time.perf_counter()
        loss, metrics = step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(loss)
    run_seconds = time.perf_counter() - t_run
    launches = {"embedding_bag": ops.embedding_bag.launches,
                "embedding_bag_backward": ops.embedding_bag.backward_launches}
    peak_bytes = torch.cuda.max_memory_allocated()

    profiled = 2
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            step()
        torch.cuda.synchronize()
    device_us, device_launches, by_name = _device_time(prof, profiled, "step")

    problems = []
    if not all(math.isfinite(x) for x in losses):
        problems.append(f"a loss is not finite: {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last < first:
        problems.append(f"the loss did not fall: first 5 {first}, last 5 "
                        f"{last}")
    expected = {name: DLRM_STEPS for name in launches}
    if launches != expected:
        problems.append(f"launches {launches} != {expected} (one forward and "
                        "one backward a step)")
    median_ms = float(np.median(step_ms))
    result = {
        "arch": cfg.arch_id, "rows_per_table": cfg.rows_per_table,
        "rows_cut_from": get_dlrm_config().rows_per_table,
        "widths": {"tables": cfg.num_tables, "emb_dim": cfg.emb_dim,
                   "lookups": cfg.lookups_per_table,
                   "dense": cfg.num_dense_features,
                   "bottom_mlp": cfg.bottom_mlp, "top_mlp": cfg.top_mlp,
                   "top_in": cfg.top_in()},
        "params": sum(p.numel() for p in params.values()),
        "dtype": "float32", "optimizer": DLRM_OPT, "batch": DLRM_BATCH,
        "steps": DLRM_STEPS, "losses": losses,
        "step_ms": step_ms, "step_ms_median": median_ms,
        "step_ms_mean": float(np.mean(step_ms)),
        "samples_per_s": DLRM_STEPS * DLRM_BATCH / run_seconds,
        "samples_per_s_at_median": DLRM_BATCH / median_ms * 1e3,
        "launches": launches,
        "launches_per_step": {k: v / DLRM_STEPS for k, v in launches.items()},
        "peak_memory_bytes": peak_bytes, "init_seconds": init_seconds,
        "grad_norm_last": metrics["grad_norm"].item(),
        "problems": problems,
    }
    if device_us:
        device_ms = device_us / 1e3 / profiled
        result.update(
            device_ms_per_step=device_ms,
            device_idle_share=1.0 - device_ms / median_ms,
            device_launches_per_step=device_launches / profiled,
            top_device_time=by_name[:12])
    else:
        result.update(device_idle_share="not measured",
                      reason="torch.profiler reported no device time")
    emit("train_dlrm", **result)
    if problems:
        raise SystemExit(f"chip_smoke: train_dlrm phase failed: {problems}")
    del model, params, state, data, prof
    torch.cuda.empty_cache()
    return launches


# Kernel path against plain path, one step from the same weights and batch,
# fp32 with TF32 off. Two comparisons:
#
# In the kernel path's step itself, each kernel against its plain version on
# the inputs the step gave it: the bag's output against embedding_bag_plain
# of the same tables and indices, and the whole dtables against
# embedding_bag_backward_plain of the dout the step produced. 1e-5 of the
# output's scale, as in the kernels phase (the same sums in another order).
#
# The two paths end to end. Their forwards differ only in the order of the
# bag's sums (~1e-7 relative), so loss and logits agree within 1e-5 of their
# scale. Their gradients do not agree that closely: a top-MLP pre-activation
# within rounding of 0 takes the other side of its ReLU in one path and moves
# that sample's share of every gradient before it (one sample's share of a
# sum over 4096 samples of either sign is about 1/64 of a typical element,
# and several such flips may meet in one leaf). So the
# gradients (the MLP leaves and the tables rows of 64 sampled bags) agree
# within 3e-2 of each leaf's largest. Adam's first step moves an element by
# lr * g / (|g| + eps), about lr * sign(g): an element whose gradient lies
# within that share of 0 may step the other way (at most 2 * lr). Updated
# parameters: no element moves by more than 2 * lr from the other path's,
# and at most 5 % of a leaf's elements (those whose gradient lies within a
# few such shares of 0) differ by more than 1e-3 * lr.
DLRM_CHECK_TOL = {"kernel_in_step": 1e-5, "loss": 1e-5, "logits": 1e-5,
                  "grads": 3e-2, "params_lr": 1e-3, "params_share": 5e-2}


def _dlrm_one_step(plain: bool) -> dict:
    cfg, dcfg, ocfg = _dlrm_setup()
    model = DLRM(cfg, seed=0, device=DEVICE)
    params = dict(model.named_parameters())
    state = init_state(params, ocfg)
    batch = dlrm_batch(dcfg, 0, device=DEVICE)
    bags = torch.arange(DLRM_SAMPLE_BAGS, device=DEVICE)
    b_s = bags * (DLRM_BATCH // DLRM_SAMPLE_BAGS)
    t_s = bags % cfg.num_tables
    rows = batch["sparse"][b_s, t_s].long()                    # (bags, L)
    kernel_wrapper = ops.embedding_bag
    seen = {}

    def spy(tables, indices):
        """The kernel path, keeping the bag's output and its gradient."""
        out = kernel_wrapper(tables, indices)
        if out.requires_grad:
            seen["out"] = out.detach()
            out.register_hook(lambda g: seen.__setitem__("dout", g))
        return out

    # the wrapper's counters are looked up on ops.embedding_bag
    spy.launches = spy.backward_launches = 0
    ops.embedding_bag = EmbeddingBagPlain.apply if plain else spy
    try:
        with torch.no_grad():
            logits = model(batch["dense"], batch["sparse"])
        loss, _ = model.loss(batch)
        loss.backward()
        out = {"loss": loss.item(), "logits": logits,
               "grads": {n: p.grad.clone() for n, p in params.items()
                         if n != "tables"}}
        out["grads"]["tables[sampled rows]"] = (
            params["tables"].grad[t_s[:, None], rows].clone())
        if not plain:
            with torch.no_grad():
                tables, r = params["tables"], cfg.rows_per_table
                out["kernel_in_step"] = {
                    "embedding_bag": _bag_err(
                        seen["out"], embedding_bag_plain(tables,
                                                         batch["sparse"]),
                        torch.float32),
                    "embedding_bag_backward": _bag_err(
                        tables.grad, embedding_bag_backward_plain(
                            seen["dout"], batch["sparse"], r),
                        torch.float32)}
            seen.clear()
        _, _, metrics = apply_updates(
            params, {n: p.grad for n, p in params.items()}, state, ocfg)
        out["lr"] = metrics["lr"]
        out["grad_norm"] = metrics["grad_norm"].item()
        with torch.no_grad():
            out["params"] = {n: p.detach().clone() for n, p in params.items()
                             if n != "tables"}
            out["params"]["tables[sampled rows]"] = (
                params["tables"][t_s[:, None], rows].clone())
    finally:
        ops.embedding_bag = kernel_wrapper
    del model, params, state
    torch.cuda.empty_cache()
    return out


def phase_train_dlrm_check() -> None:
    """One step of the kernel path, then one of the plain path, each from a
    fresh model drawn from seed 0 and the data's step 0, in sequence."""
    kernel = _dlrm_one_step(plain=False)
    plain = _dlrm_one_step(plain=True)
    tol = DLRM_CHECK_TOL
    problems = []

    def rel_err(got, want):
        scale = want.abs().max().item()
        return (got - want).abs().max().item(), scale

    in_step = {}
    for name, (err, bag_tol) in kernel["kernel_in_step"].items():
        in_step[name] = {"max_abs_err": err, "tol": bag_tol}
        if not err <= bag_tol:
            problems.append(f"{name} in the step: {err} > {bag_tol}")
    loss_err = abs(kernel["loss"] - plain["loss"])
    if not loss_err <= tol["loss"] * max(1.0, abs(plain["loss"])):
        problems.append(f"loss differs by {loss_err}")
    logit_err, logit_scale = rel_err(kernel["logits"], plain["logits"])
    if (kernel["logits"].shape != (DLRM_BATCH,)
            or not torch.isfinite(kernel["logits"]).all()):
        problems.append("logits: wrong shape or not finite")
    if not logit_err <= tol["logits"] * max(1.0, logit_scale):
        problems.append(f"logits differ by {logit_err}")
    grad_err = {}
    for name, want in plain["grads"].items():
        err, scale = rel_err(kernel["grads"][name], want)
        grad_err[name] = {"max_abs_err": err, "max_abs": scale}
        if not err <= tol["grads"] * scale:
            problems.append(f"gradient {name} differs by {err} (scale {scale})")
    lr = kernel["lr"]
    param_err = {}
    for name, want in plain["params"].items():
        diff = (kernel["params"][name] - want).abs()
        over = int((diff > tol["params_lr"] * lr).sum())
        param_err[name] = {"max_abs_err": diff.max().item(),
                           "elements_over": over, "elements": diff.numel()}
        if (over > tol["params_share"] * diff.numel()
                or diff.max().item() > 2 * lr * (1 + 1e-3)):
            problems.append(f"updated {name}: max difference "
                            f"{diff.max().item()}, {over} elements differ by "
                            f"more than {tol['params_lr']} * lr")
    gnorm_err = abs(kernel["grad_norm"] - plain["grad_norm"])
    if not gnorm_err <= 1e-4 * plain["grad_norm"]:
        problems.append(f"grad_norm differs by {gnorm_err}")
    emit("train_dlrm_check", tol=tol, kernel_in_step=in_step,
         loss=plain["loss"], loss_abs_err=loss_err,
         logit_max_abs=logit_scale, logit_max_abs_err=logit_err,
         grad_norm=plain["grad_norm"], grad_norm_abs_err=gnorm_err, lr=lr,
         grads=grad_err, updated_params=param_err,
         sampled_bags=DLRM_SAMPLE_BAGS, problems=problems)
    if problems:
        raise SystemExit(f"chip_smoke: train_dlrm_check failed: {problems}")


# ------------------------------------------------------------------------- #
# Dense-LM training
# ------------------------------------------------------------------------- #

LM_KERNELS = ("flash_attention", "flash_attention_backward", "rmsnorm",
              "rmsnorm_backward")


def _lm_counts() -> dict:
    return {"flash_attention": ops.flash_attention.launches,
            "flash_attention_backward": ops.flash_attention.backward_launches,
            "rmsnorm": ops.rmsnorm.launches,
            "rmsnorm_backward": ops.rmsnorm.backward_launches}


def _mamba_counts() -> dict:
    """mamba2's and zamba2's kernels (attention: zamba2's shared block)."""
    return {**_lm_counts(), "ssd_scan": ops.ssd_scan.launches,
            "ssd_scan_backward": ops.ssd_scan.backward_launches}


def _zero_lm_counts() -> None:
    for wrapper in (ops.flash_attention, ops.rmsnorm):
        wrapper.launches = 0
        wrapper.backward_launches = 0


def _expected_lm_launches(cfg, remat: str, steps: int) -> dict:
    """Each kernel's calls in ``steps`` training steps of one microbatch: a
    layer runs attention once and RMSNorm twice, the final norm once, each
    forward with one backward; a policy that recomputes the layers
    (anything but "none") runs the layers' forwards again in the
    backward."""
    layers = cfg.num_layers
    again = 1 if remat == "none" else 2
    return {"flash_attention": again * layers * steps,
            "flash_attention_backward": layers * steps,
            "rmsnorm": (again * 2 * layers + 1) * steps,
            "rmsnorm_backward": (2 * layers + 1) * steps}


def _traced(by_name: list, kernel: str) -> dict:
    """The launches a profiled step made of the device kernels whose names
    match ``kernel`` (a regular expression for the bare name; the profiler
    prefixes a namespace) and their device ms a step (``by_name``, from
    ``_device_time``)."""
    rows = [e for e in by_name
            if re.search(r"(^|[\s:])" + kernel + r"\b", e["name"])]
    return {"kernels_traced_per_step": sum(e["launches_per_step"]
                                           for e in rows),
            "device_ms_per_step": sum(e["launches_per_step"]
                                      * e["device_us_per_launch"]
                                      for e in rows) / 1e3}


def _lm_backward_plan(cfg, launches: dict, steps: int, by_name: list,
                      batch: int = LM_BATCH, seq: int = LM_SEQ) -> dict:
    """The attention backward's plan at a training layer (train_lm's by
    default), the device kernels its counted calls launched, reckoned from
    the plan, and the ``bwd_*`` kernels a profiled step launched, with
    their device ms."""
    splits, per_call, scratch = flash_attention_backward_plan(
        batch, cfg.num_heads, cfg.num_kv_heads, seq, cfg.resolved_head_dim)
    calls = launches["flash_attention_backward"]
    return {"splits": splits, "kernels_per_call": per_call,
            "scratch_bytes": scratch, "kernels": calls * per_call,
            "kernels_per_step": calls * per_call / steps,
            **_traced(by_name, r"bwd_\w+_kernel")}


def _lm_forward_trace(launches: dict, steps: int, by_name: list) -> dict:
    """The attention forward at the train_lm layer (fp32, with the
    log-sum-exp): one ``flash_tf32_kernel`` a counted call, and the ones a
    profiled step launched, with their device ms."""
    return {"kernel": "flash_tf32_kernel",
            "kernels_per_step": launches["flash_attention"] / steps,
            **_traced(by_name, "flash_tf32_kernel")}


def _lm_norm_backward_trace(launches: dict, steps: int,
                            by_name: list) -> dict:
    """The RMSNorm backward at the train_lm rows: BACKWARD_KERNELS_PER_CALL
    kernels a counted call, and the ones a profiled step launched, with
    their device ms."""
    return {"kernels": "rmsnorm_bwd_rows_kernel, rmsnorm_dgamma_kernel",
            "calls_per_step": launches["rmsnorm_backward"] / steps,
            "kernels_per_step": launches["rmsnorm_backward"]
            * rms_module.BACKWARD_KERNELS_PER_CALL / steps,
            **_traced(by_name, r"rmsnorm_(bwd_rows|dgamma)_kernel")}


def _lm_memory_reckoned(cfg, batch: int, seq: int) -> dict:
    """Bytes reckoned from the shapes, fp32: parameters, gradients, m, v and
    the master copy; the logits and their gradient; the projections the
    "dots" policy keeps (q, k, v, the attention output's projection, the
    FFN's two inputs and its output, a layer)."""
    params = cfg.param_count()
    tokens = batch * seq
    hd = cfg.resolved_head_dim
    per_layer = (cfg.num_heads * hd + 2 * cfg.num_kv_heads * hd + cfg.d_model
                 + 2 * cfg.d_ff + cfg.d_model)
    return {"state_bytes": 5 * 4 * params,
            "logits_and_grad_bytes": 2 * tokens * cfg.padded_vocab * 4,
            "dots_saved_bytes": cfg.num_layers * tokens * per_layer * 4}


def phase_train_lm() -> dict:
    """Full-width, full-depth smollm-135m in fp32 through the training entry
    point's objects: LM_WARMUP + LM_STEPS steps (the first LM_WARMUP not
    timed), each step read back once by the trainer, then LM_PROFILED more
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config(LM_ARCH)
    plan = plan_memory(cfg, tp=1, dp=1)
    steps = LM_WARMUP + LM_STEPS
    ocfg = AdamWConfig(lr=LM_LR, warmup_steps=LM_WARMUP, total_steps=steps,
                       state_dtype=plan.opt_dtype, use_master=plan.use_master)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, plan,
                             torch.Generator(device=DEVICE).manual_seed(0),
                             ocfg, dtype=torch.float32, device=DEVICE)
    torch.cuda.synchronize()
    init_seconds = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state["params"].values())
    data = DataIterator(DataConfig(vocab_size=cfg.vocab_size, seq_len=LM_SEQ,
                                   global_batch=LM_BATCH, seed=0),
                        device=DEVICE)
    trainer = Trainer(make_train_step(cfg, plan, ocfg), state, data,
                      TrainerConfig(total_steps=steps, log_interval=1, seed=0))

    torch.cuda.synchronize()
    # The main path: counters to 0 just before, read just after.
    _zero_lm_counts()
    summary = trainer.run()
    launches = _lm_counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    losses = [row["loss"] for row in trainer.metrics_log]

    trainer.cfg.total_steps = steps + LM_PROFILED
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.run()
        torch.cuda.synchronize()
    device_us, device_launches, by_name = _device_time(prof, LM_PROFILED,
                                                       "step")

    step_ms = [t * 1e3 for t in trainer.step_times[LM_WARMUP:steps]]
    timed_s = sum(step_ms) / 1e3
    median_ms = float(np.median(step_ms))
    problems = []
    if not all(math.isfinite(x) for x in losses):
        problems.append(f"a loss is not finite: {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last < first:
        problems.append(f"the loss did not fall: first 5 {first}, last 5 "
                        f"{last}")
    if summary["final_step"] != steps:
        problems.append(f"the trainer stopped at step {summary['final_step']}")
    expected = _expected_lm_launches(cfg, plan.remat, steps)
    if launches != expected:
        problems.append(f"launches {launches} != {expected}, reckoned from "
                        f"{cfg.num_layers} layers and remat {plan.remat!r}")
    bwd_plan = _lm_backward_plan(cfg, launches, steps, by_name)
    fwd_trace = _lm_forward_trace(launches, steps, by_name)
    norm_trace = _lm_norm_backward_trace(launches, steps, by_name)
    for what, got in (("attention backward", bwd_plan),
                      ("attention forward", fwd_trace),
                      ("RMSNorm backward", norm_trace)):
        if (device_us and got["kernels_traced_per_step"]
                != got["kernels_per_step"]):
            problems.append(f"{what} kernels a step: traced "
                            f"{got['kernels_traced_per_step']}, reckoned "
                            f"{got['kernels_per_step']} from the counts")
    result = {
        "arch": cfg.arch_id, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "params": n_params, "dtype": "float32",
        "plan": {"remat": plan.remat, "microbatches": plan.microbatches,
                 "opt_dtype": plan.opt_dtype, "use_master": plan.use_master,
                 "zero_stage": plan.zero_stage},
        "optimizer": {"lr": LM_LR, "warmup_steps": LM_WARMUP,
                      "total_steps": steps},
        "global_batch": LM_BATCH, "seq_len": LM_SEQ,
        "warmup_steps_untimed": LM_WARMUP, "timed_steps": LM_STEPS,
        "losses": losses, "loss_first": losses[0], "loss_last": losses[-1],
        "step_ms": step_ms, "step_ms_median": median_ms,
        "step_ms_mean": float(np.mean(step_ms)),
        "samples_per_s": LM_BATCH * LM_STEPS / timed_s,
        "tokens_per_s": LM_BATCH * LM_SEQ * LM_STEPS / timed_s,
        "straggler_steps": summary["straggler_steps"],
        "launches": launches, "launches_per_step": {
            k: v / steps for k, v in launches.items()},
        "attention_backward_plan": bwd_plan,
        "attention_forward_trace": fwd_trace,
        "rmsnorm_backward_trace": norm_trace,
        "peak_memory_bytes": peak_bytes,
        "memory_reckoned": _lm_memory_reckoned(cfg, LM_BATCH, LM_SEQ),
        "init_seconds": init_seconds, "problems": problems,
    }
    if device_us:
        device_ms = device_us / 1e3 / LM_PROFILED
        result.update(
            device_ms_per_step=device_ms,
            device_idle_share=1.0 - device_ms / median_ms,
            device_launches_per_step=device_launches / LM_PROFILED,
            top_device_time=by_name[:14])
    else:
        result.update(device_idle_share="not measured",
                      reason="torch.profiler reported no device time")
    emit("train_lm", **result)
    if problems:
        raise SystemExit(f"chip_smoke: train_lm phase failed: {problems}")
    del trainer, state, data, prof
    torch.cuda.empty_cache()
    return launches


def _one_step(cfg, dtype: torch.dtype, batch_size: int, seq: int,
              plain: dict, counts) -> dict:
    """One training step of ``cfg`` from seed 0, on the data's step 0: the
    loss, the gradients (as the step hands them to the optimizer), the grad
    norm and the kernel launches (``counts()``). ``plain``: wrapper name in
    ``ops`` -> the plain version that stands in for it, differentiated by
    autograd (empty: the kernels)."""
    plan = plan_memory(cfg, tp=1, dp=1)
    ocfg = AdamWConfig(lr=LM_LR, warmup_steps=1, total_steps=10,
                       state_dtype=plan.opt_dtype, use_master=plan.use_master)
    state = init_train_state(cfg, plan,
                             torch.Generator(device=DEVICE).manual_seed(0),
                             ocfg, dtype=dtype, device=DEVICE)
    batch = next(DataIterator(DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=seq, global_batch=batch_size,
                                         seed=0),
                              device=DEVICE))
    seen = {}

    def spy(params, grads, *args, **kwargs):
        seen["grads"] = {n: g.clone() for n, g in grads.items()}
        return apply_updates(params, grads, *args, **kwargs)

    kernels = {name: getattr(ops, name) for name in plain}
    _zero_kernel_counts()
    train_step_module.apply_updates = spy
    for name, fn in plain.items():
        setattr(ops, name, fn)
    try:
        _, metrics = make_train_step(cfg, plan, ocfg)(state, batch)
        torch.cuda.synchronize()
    finally:
        train_step_module.apply_updates = apply_updates
        for name, fn in kernels.items():
            setattr(ops, name, fn)
    out = {"loss": metrics["loss"].item(),
           "grad_norm": metrics["grad_norm"].item(), "grads": seen["grads"],
           "launches": counts(), "remat": plan.remat, "cfg": cfg}
    del state
    torch.cuda.empty_cache()
    return out


def _lm_one_step(dtype: torch.dtype, plain: bool) -> dict:
    """One training step of LM_CHECK_LAYERS layers of full-width smollm.
    ``plain``: attention and RMSNorm are the plain versions."""
    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=LM_CHECK_LAYERS)
    return _one_step(cfg, dtype, LM_CHECK_BATCH, LM_CHECK_SEQ,
                     {"flash_attention": flash_attention_plain,
                      "rmsnorm": rmsnorm_plain} if plain else {}, _lm_counts)


def _check_against_plain(kernel: dict, plain: dict, tol: dict,
                         name: str, problems: list,
                         fp32_route: dict = None) -> dict:
    """The kernel route's step against the plain route's: the loss, the
    grad norm and every gradient leaf, each to ``tol``; a failure is
    appended to ``problems``. ``fp32_route``: another plain route, held to
    ``plain`` too; a leaf of the kernel route may then miss by up to twice
    what that route misses it by, where that is more than ``tol``. Returns
    the report."""
    others = {} if fp32_route is None else {
        leaf: (got - plain["grads"][leaf]).abs().max().item()
        / max(plain["grads"][leaf].abs().max().item(), 1e-30)
        for leaf, got in fp32_route["grads"].items()}
    for route in [plain] + ([fp32_route] if fp32_route else []):
        if any(route["launches"].values()):
            problems.append(f"{name}: a plain route launched a kernel: "
                            f"{route['launches']}")
    loss_err = abs(kernel["loss"] - plain["loss"])
    if not (math.isfinite(kernel["loss"])
            and loss_err <= tol["loss"] * abs(plain["loss"])):
        problems.append(f"{name}: loss {kernel['loss']} against "
                        f"{plain['loss']}")
    gnorm_err = abs(kernel["grad_norm"] - plain["grad_norm"])
    if not gnorm_err <= tol["grad_norm"] * plain["grad_norm"]:
        problems.append(f"{name}: grad norm {kernel['grad_norm']} against "
                        f"{plain['grad_norm']}")
    grads, widened = {}, {}
    for leaf, want in plain["grads"].items():
        got = kernel["grads"][leaf]
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        grads[leaf] = err / scale if scale else err
        allowed = max(tol["grads"], 2 * others.get(leaf, 0.0))
        if allowed > tol["grads"]:
            widened[leaf] = {"fp32_route_err_of_max": others[leaf],
                             "err_of_max": grads[leaf]}
        if not (torch.isfinite(got).all() and err <= allowed * scale):
            problems.append(f"{name}: gradient {leaf} differs by {err} "
                            f"(largest {scale}, allowed {allowed} of it)")
    worst = max(grads, key=grads.get)
    report = {"tol": tol, "loss": plain["loss"], "loss_abs_err": loss_err,
              "grad_norm": plain["grad_norm"],
              "grad_norm_abs_err": gnorm_err, "grad_leaves": len(grads),
              "grad_worst_leaf": {"leaf": worst,
                                  "err_of_max": grads[worst]},
              "launches": kernel["launches"]}
    if fp32_route is not None:
        worst32 = max(others, key=others.get)
        report.update(fp32_route_worst_leaf={"leaf": worst32,
                                             "err_of_max": others[worst32]},
                      leaves_held_to_the_fp32_route=widened)
    return report


def phase_train_lm_check() -> None:
    """For fp32 and bf16: one step through the kernels, then one through the
    plain versions, each from a fresh model drawn from seed 0."""
    report, problems = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        kernel = _lm_one_step(dtype, plain=False)
        plain = _lm_one_step(dtype, plain=True)
        name = dtype_name(dtype)
        expected = _expected_lm_launches(kernel["cfg"], kernel["remat"], 1)
        if kernel["launches"] != expected:
            problems.append(f"{name}: launches {kernel['launches']} != "
                            f"{expected}")
        report[name] = _check_against_plain(kernel, plain,
                                            LM_CHECK_TOL[dtype], name,
                                            problems)
    emit("train_lm_check", arch=LM_ARCH, layers=LM_CHECK_LAYERS,
         batch=LM_CHECK_BATCH, seq_len=LM_CHECK_SEQ, **report,
         problems=problems)
    if problems:
        raise SystemExit(f"chip_smoke: train_lm_check failed: {problems}")


# ------------------------------------------------------------------------- #
# mamba2 and zamba2 training
# ------------------------------------------------------------------------- #

def _shared_block_calls(cfg) -> int:
    """Calls of zamba2's shared attention block in a pass (0 for mamba2)."""
    return cfg.num_layers // cfg.hybrid.attn_every if (
        cfg.family == "hybrid") else 0


def _expected_mamba_launches(cfg, remat: str, steps: int) -> dict:
    """Each kernel's calls in ``steps`` training steps of one microbatch: a
    layer runs the scan once and RMSNorm twice (``ln`` and the gated
    ``norm_g``); zamba2's shared block, once after every ``attn_every``
    layers, attention once and RMSNorm twice (``ln`` on concat(h, emb0),
    ``ln_ffn``); the final norm once; each forward with one backward. A
    policy that recomputes the layers runs their forwards again (a group's
    layers and its call of the shared block)."""
    layers, calls = cfg.num_layers, _shared_block_calls(cfg)
    again = 1 if remat == "none" else 2
    norms = 2 * layers + 2 * calls
    return {"flash_attention": again * calls * steps,
            "flash_attention_backward": calls * steps,
            "rmsnorm": (again * norms + 1) * steps,
            "rmsnorm_backward": (norms + 1) * steps,
            "ssd_scan": again * layers * steps,
            "ssd_scan_backward": layers * steps}


def _mamba_memory_reckoned(cfg, plan, batch: int, seq: int) -> dict:
    """Bytes reckoned from the shapes, fp32: the plan's estimate; the
    parameters, gradients, m, v and master copy; the projections the
    "dots" policy keeps (z, x, B, C, dt and the out projection, a layer;
    of each call of zamba2's shared block q, k, v, the attention's output
    projection, the FFN's two gated inputs and its output); each remat
    group's input, kept by the checkpoint (a group is one layer of mamba2,
    six layers and the shared block of zamba2, which keeps the embedding
    too); the logits and their gradient; the sum of those activations; the
    SSD backward's scratch of one layer (the chunks' dS, cs's terms, the
    chunks' sums, the plan's dB/dC partials)."""
    tokens = batch * seq
    ssm, layers = cfg.ssm, cfg.num_layers
    calls = _shared_block_calls(cfg)
    gn = ssm.ngroups * ssm.state_dim
    per_layer = 2 * cfg.d_inner + 2 * gn + cfg.ssm_heads + cfg.d_model
    per_call = ((cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.resolved_head_dim
                + 2 * cfg.d_model + 2 * cfg.d_ff)
    inputs = calls + 1 if calls else layers
    q = min(ssm.chunk_size, seq)
    nc, qp = -(-seq // q), -(-q // ssd_module.TILE) * ssd_module.TILE
    heads_state = batch * cfg.ssm_heads * ssm.head_dim * ssm.state_dim
    partials = ssd_module.ssd_scan_backward_plan(
        batch, seq, cfg.ssm_heads, ssm.ngroups, ssm.state_dim,
        ssm.chunk_size)[2]
    out = {"plan_est_bytes_per_chip": plan.est_bytes_per_chip,
           "state_bytes": 5 * 4 * cfg.param_count(),
           "dots_saved_bytes": layers * tokens * per_layer * 4,
           "shared_block_dots_saved_bytes": calls * tokens * per_call * 4,
           "layer_inputs_bytes": inputs * tokens * cfg.d_model * 4,
           "logits_and_grad_bytes": 2 * tokens * cfg.padded_vocab * 4,
           "ssd_backward_scratch_bytes": 4 * (
               nc * heads_state + batch * cfg.ssm_heads * nc * (3 * qp + 2))
           + partials}
    out["activations_reckoned_bytes"] = sum(
        out[k] for k in ("dots_saved_bytes", "shared_block_dots_saved_bytes",
                         "layer_inputs_bytes", "logits_and_grad_bytes"))
    return out


def _train_mamba_family(phase: str, arch: str, batch: int, seq: int,
                        warmup: int, timed: int, profiled: int) -> dict:
    """Full-width, full-depth ``arch`` (mamba2 or zamba2) in fp32 through
    the training entry point's objects: ``warmup`` + ``timed`` steps (the
    first ``warmup`` not timed), each step read back once by the trainer,
    then ``profiled`` more under torch.profiler. Emits ``phase``'s line and
    returns the launches of the counted steps."""
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config(arch)
    plan = plan_memory(cfg, tp=1, dp=1)
    steps = warmup + timed
    ocfg = AdamWConfig(lr=LM_LR, warmup_steps=warmup, total_steps=steps,
                       state_dtype=plan.opt_dtype, use_master=plan.use_master)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, plan,
                             torch.Generator(device=DEVICE).manual_seed(0),
                             ocfg, dtype=torch.float32, device=DEVICE)
    torch.cuda.synchronize()
    init_seconds = time.perf_counter() - t0
    state_bytes = torch.cuda.memory_allocated()
    n_params = sum(p.numel() for p in state["params"].values())
    data = DataIterator(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                   global_batch=batch, seed=0),
                        device=DEVICE)
    trainer = Trainer(make_train_step(cfg, plan, ocfg), state, data,
                      TrainerConfig(total_steps=steps, log_interval=1, seed=0))

    torch.cuda.synchronize()
    # The main path: counters to 0 just before, read just after.
    _zero_kernel_counts()
    summary = trainer.run()
    launches = _mamba_counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    losses = [row["loss"] for row in trainer.metrics_log]

    trainer.cfg.total_steps = steps + profiled
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.run()
        torch.cuda.synchronize()
    device_us, device_launches, by_name = _device_time(prof, profiled, "step")

    step_ms = [t * 1e3 for t in trainer.step_times[warmup:steps]]
    timed_s = sum(step_ms) / 1e3
    median_ms = float(np.median(step_ms))
    calls = _shared_block_calls(cfg)
    problems = []
    if not all(math.isfinite(x) for x in losses):
        problems.append(f"a loss is not finite: {losses}")
    if summary["final_step"] != steps:
        problems.append(f"the trainer stopped at step {summary['final_step']}")
    expected = _expected_mamba_launches(cfg, plan.remat, steps)
    if launches != expected:
        problems.append(f"launches {launches} != {expected}, reckoned from "
                        f"{cfg.num_layers} layers, {calls} calls of a shared "
                        f"block and remat {plan.remat!r}")
    per_step = {k: v / steps for k, v in launches.items()}
    traces = {
        "ssd_scan_backward": {
            "kernels_per_step": per_step["ssd_scan_backward"]
            * ssd_module.BACKWARD_KERNELS_PER_CALL,
            **_traced(by_name, r"ssd_bwd_\w+_kernel")},
        "ssd_scan": {
            "kernels_per_step": per_step["ssd_scan"]
            * ssd_module.KERNELS_PER_CALL,
            **_traced(by_name,
                      r"((scores|states|outputs)_f32_kernel|pass_kernel)")},
        "rmsnorm_backward": {
            "kernels_per_step": per_step["rmsnorm_backward"]
            * rms_module.BACKWARD_KERNELS_PER_CALL,
            **_traced(by_name, r"rmsnorm_(bwd_rows|dgamma)_kernel")}}
    if calls:
        # the shared block's attention: its backward's kernels as its plan
        # reckons them, and one fp32 training forward a counted call
        traces["flash_attention_backward"] = _lm_backward_plan(
            cfg, launches, steps, by_name, batch, seq)
        traces["flash_attention"] = {
            "kernels_per_step": per_step["flash_attention"],
            **_traced(by_name, "flash_tf32_kernel")}
    for what, got in traces.items():
        if (device_us and got["kernels_traced_per_step"]
                != got["kernels_per_step"]):
            problems.append(f"{what} kernels a step: traced "
                            f"{got['kernels_traced_per_step']}, reckoned "
                            f"{got['kernels_per_step']} from the counts")
    result = {
        "arch": cfg.arch_id, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "d_inner": cfg.d_inner, "ssd_heads": cfg.ssm_heads,
        "params": n_params, "dtype": "float32",
        "plan": {"remat": plan.remat, "microbatches": plan.microbatches,
                 "opt_dtype": plan.opt_dtype, "use_master": plan.use_master,
                 "zero_stage": plan.zero_stage,
                 "est_bytes_per_chip": plan.est_bytes_per_chip},
        "optimizer": {"lr": LM_LR, "warmup_steps": warmup,
                      "total_steps": steps},
        "global_batch": batch, "seq_len": seq,
        "warmup_steps_untimed": warmup, "timed_steps": timed,
        "losses": losses, "loss_first": losses[0], "loss_last": losses[-1],
        "step_ms": step_ms, "step_ms_median": median_ms,
        "step_ms_mean": float(np.mean(step_ms)),
        "tokens_per_s": batch * seq * timed / timed_s,
        "straggler_steps": summary["straggler_steps"],
        "launches": launches, "launches_per_step": per_step,
        "traces": traces, "peak_memory_bytes": peak_bytes,
        "state_bytes_allocated": state_bytes,
        "memory_reckoned": _mamba_memory_reckoned(cfg, plan, batch, seq),
        "init_seconds": init_seconds, "problems": problems,
    }
    if calls:
        result.update(attn_every=cfg.hybrid.attn_every,
                      shared_block_calls=calls,
                      attention={"heads": cfg.num_heads,
                                 "kv_heads": cfg.num_kv_heads,
                                 "head_dim": cfg.resolved_head_dim})
    if device_us:
        device_ms = device_us / 1e3 / profiled
        result.update(
            device_ms_per_step=device_ms,
            device_idle_share=1.0 - device_ms / median_ms,
            **{f"{what}_share_of_device":
               traces[kernel]["device_ms_per_step"] / device_ms
               for what, kernel in (
                   ("ssd_backward", "ssd_scan_backward"),
                   ("ssd_forward", "ssd_scan"),
                   ("attention_backward", "flash_attention_backward"),
                   ("attention_forward", "flash_attention"))
               if kernel in traces},
            device_launches_per_step=device_launches / profiled,
            top_device_time=by_name[:14])
    else:
        result.update(device_idle_share="not measured",
                      reason="torch.profiler reported no device time")
    emit(phase, **result)
    if problems:
        raise SystemExit(f"chip_smoke: {phase} phase failed: {problems}")
    del trainer, state, data, prof
    torch.cuda.empty_cache()
    return launches


def phase_train_mamba() -> dict:
    """Full-width, full-depth mamba2-780m: MAMBA_WARMUP + MAMBA_STEPS steps,
    then MAMBA_PROFILED under torch.profiler (``_train_mamba_family``)."""
    return _train_mamba_family("train_mamba", MAMBA_ARCH, MAMBA_BATCH,
                               MAMBA_SEQ, MAMBA_WARMUP, MAMBA_STEPS,
                               MAMBA_PROFILED)


def phase_train_zamba() -> dict:
    """Full-width, full-depth zamba2-2.7b (the shared block's attention at
    32 heads of 160 on the training route): ZAMBA_WARMUP + ZAMBA_STEPS
    steps, then ZAMBA_PROFILED under torch.profiler."""
    return _train_mamba_family("train_zamba", ZAMBA_ARCH, ZAMBA_BATCH,
                               ZAMBA_SEQ, ZAMBA_WARMUP, ZAMBA_STEPS,
                               ZAMBA_PROFILED)


def _ssd_scan_float64(x, dt, A, B, C, chunk):
    """``ssd_scan_plain`` computed in float64 (its inputs widened, y handed
    back in x's type and the final state in fp32): the check's yardstick."""
    y, state = ssd_scan_plain(x.double(), dt.double(), A.double(),
                              B.double(), C.double(), chunk)
    return y.to(x.dtype), state.float()


def _mamba_family_check(phase: str, cfg, batch: int, seq: int) -> None:
    """fp32: one step of ``cfg`` through the kernels, one through the plain
    versions with the scan computed in float64 (the yardstick), and one
    through the plain versions in fp32, each from a fresh model drawn from
    seed 0. The gradients of A_log and dt_bias sum the scan's cotangents of
    dA and dt over every position, on fp32 cumsums (|cs| up to Q |dt A|,
    some thousands), and the closed form the kernels compute rounds those
    sums further from a float64 scan than autograd through the plain scan
    does. So each leaf of the kernel route is held to the yardstick within
    1e-4 of its largest, or within twice what the fp32 plain route misses
    it by, whichever is larger."""
    kernel, wide, plain = (
        _one_step(cfg, torch.float32, batch, seq, routes, _mamba_counts)
        for routes in ({}, *({"ssd_scan": scan, "rmsnorm": rmsnorm_plain,
                              "flash_attention": flash_attention_plain}
                             for scan in (_ssd_scan_float64,
                                          ssd_scan_plain))))
    problems = []
    expected = _expected_mamba_launches(cfg, kernel["remat"], 1)
    if kernel["launches"] != expected:
        problems.append(f"launches {kernel['launches']} != {expected}")
    report = _check_against_plain(kernel, wide, MAMBA_CHECK_TOL, "float32",
                                  problems, fp32_route=plain)
    hybrid = ({"attn_every": cfg.hybrid.attn_every}
              if _shared_block_calls(cfg) else {})
    emit(phase, arch=cfg.arch_id, layers=cfg.num_layers, **hybrid,
         batch=batch, seq_len=seq, float32=report, problems=problems)
    if problems:
        raise SystemExit(f"chip_smoke: {phase} failed: {problems}")


def phase_train_mamba_check() -> None:
    """MAMBA_CHECK_LAYERS full-width mamba2 layers (``_mamba_family_check``)."""
    _mamba_family_check(
        "train_mamba_check", dataclasses.replace(
            get_config(MAMBA_ARCH), num_layers=MAMBA_CHECK_LAYERS),
        MAMBA_CHECK_BATCH, MAMBA_CHECK_SEQ)


def phase_train_zamba_check() -> None:
    """ZAMBA_CHECK_LAYERS full-width zamba2 layers with the shared block
    (its attention at 32 heads of 160) after every ZAMBA_CHECK_EVERY
    (``_mamba_family_check``)."""
    base = get_config(ZAMBA_ARCH)
    _mamba_family_check(
        "train_zamba_check", dataclasses.replace(
            base, num_layers=ZAMBA_CHECK_LAYERS, hybrid=dataclasses.replace(
                base.hybrid, attn_every=ZAMBA_CHECK_EVERY)),
        ZAMBA_CHECK_BATCH, ZAMBA_CHECK_SEQ)


# ------------------------------------------------------------------------- #
# Checkpoint and resume
# ------------------------------------------------------------------------- #

def _ckpt_trainer(cfg, plan, ocfg, total_steps, ckpt_dir=None, seed=0):
    """launch.train's objects for the checkpoint phase; ``seed`` draws the
    initial weights (a resumed run's are overwritten by the restore)."""
    state = init_train_state(cfg, plan,
                             torch.Generator(device=DEVICE).manual_seed(seed),
                             ocfg, dtype=torch.float32, device=DEVICE)
    data = DataIterator(DataConfig(vocab_size=cfg.vocab_size, seq_len=LM_SEQ,
                                   global_batch=LM_BATCH, seed=0),
                        device=DEVICE)
    return Trainer(make_train_step(cfg, plan, ocfg), state, data,
                   TrainerConfig(total_steps=total_steps, ckpt_dir=ckpt_dir,
                                 ckpt_interval=CKPT_K, log_interval=CKPT_K,
                                 seed=0))


def _state_leaves(state: dict) -> dict:
    opt = state["opt"]
    out = {f"params.{k}": v for k, v in state["params"].items()}
    for part in ("m", "v", "master"):
        out.update({f"{part}.{k}": v for k, v in opt.get(part, {}).items()})
    out["step"] = opt["step"]
    return out


def phase_checkpoint() -> None:
    """Full-width smollm-135m training in fp32 through launch.train's
    objects: 2 * CKPT_K steps straight, against CKPT_K steps with a
    checkpoint directory (the cadence's async save at CKPT_K) and a new
    Trainer that resumes from it (``try_resume``) and takes CKPT_K more.
    Every leaf of params, m, v (master where the plan keeps one) and the
    step must be bitwise equal, and neither the save nor the restore may
    raise the device's peak memory above the live state's (the layers are
    stacked and unstacked on the host). Prints the checkpoint's bytes, the
    ms the loop paid for the async save, the writer thread's seconds, the
    restore's ms and the device bytes each allocated above the live ones;
    the directory is removed at the end."""
    cfg = get_config(LM_ARCH)
    plan = plan_memory(cfg, tp=1, dp=1)
    steps = 2 * CKPT_K
    ocfg = AdamWConfig(lr=LM_LR, warmup_steps=LM_WARMUP, total_steps=steps,
                       state_dtype=plan.opt_dtype, use_master=plan.use_master)
    straight = _ckpt_trainer(cfg, plan, ocfg, steps)
    straight.run()
    directory = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        first = _ckpt_trainer(cfg, plan, ocfg, CKPT_K, ckpt_dir=directory)
        manager = first.manager
        paid_ms, write_s, save_above = [], [], []
        maybe_save, write = manager.maybe_save, manager.ckpt._write

        def timed_save(*args, **kwargs):
            torch.cuda.synchronize()
            live = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            saved = maybe_save(*args, **kwargs)
            if saved:
                paid_ms.append((time.perf_counter() - t0) * 1e3)
                save_above.append(torch.cuda.max_memory_allocated() - live)
            return saved

        def timed_write(*args, **kwargs):
            t0 = time.perf_counter()
            out = write(*args, **kwargs)
            write_s.append(time.perf_counter() - t0)
            return out

        manager.maybe_save, manager.ckpt._write = timed_save, timed_write
        first.run()
        state_bytes = sum(t.numel() * t.element_size()
                          for t in _state_leaves(first.state).values())
        files_bytes = sum(os.path.getsize(os.path.join(root, name))
                          for root, _, names in os.walk(directory)
                          for name in names)
        committed = manager.latest_step()
        del first, manager
        torch.cuda.empty_cache()

        resumed = _ckpt_trainer(cfg, plan, ocfg, steps, ckpt_dir=directory,
                                seed=1)
        torch.cuda.synchronize()
        live = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        restored = resumed.try_resume()
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        restore_above = torch.cuda.max_memory_allocated() - live
        restored_step = resumed.step
        resumed.run()
    finally:
        shutil.rmtree(directory, ignore_errors=True)

    want, got = _state_leaves(straight.state), _state_leaves(resumed.state)
    differing = sorted(name for name, t in want.items()
                       if not torch.equal(t, got[name]))
    problems = []
    if not restored or restored_step != CKPT_K or committed != CKPT_K:
        problems.append(f"restored {restored} at step {restored_step}, "
                        f"committed step {committed}, expected {CKPT_K}")
    if set(want) != set(got) or differing:
        problems.append(f"{len(differing)} of {len(want)} leaves differ from "
                        f"the straight run: {differing[:8]}")
    if len(paid_ms) != 1 or len(write_s) != 1:
        problems.append(f"{len(paid_ms)} saves, {len(write_s)} writes; "
                        "expected the cadence's one async save")
    if any(save_above) or restore_above:
        problems.append(f"device bytes above the live state: save "
                        f"{save_above}, restore {restore_above}; expected 0")
    result = {
        "arch": cfg.arch_id, "dtype": "float32", "global_batch": LM_BATCH,
        "seq_len": LM_SEQ, "steps_straight": steps,
        "steps_before_checkpoint": CKPT_K, "steps_after_resume": CKPT_K,
        "plan": {"remat": plan.remat, "use_master": plan.use_master},
        "leaves": len(want), "leaves_differing": len(differing),
        "state_bytes": state_bytes, "checkpoint_files_bytes": files_bytes,
        "save_async_ms_paid_by_loop": paid_ms, "writer_thread_s": write_s,
        "restore_ms": restore_ms,
        "save_device_bytes_above_live": save_above,
        "restore_device_bytes_above_live": restore_above,
        "loss_straight_last": straight.metrics_log[-1]["loss"],
        "loss_resumed_last": resumed.metrics_log[-1]["loss"],
        "problems": problems,
    }
    emit("checkpoint", **result)
    if problems:
        raise SystemExit(f"chip_smoke: checkpoint phase failed: {problems}")
    del straight, resumed
    torch.cuda.empty_cache()


# ------------------------------------------------------------------------- #
# The distribution layer
# ------------------------------------------------------------------------- #

# The sharded step on one card: smollm-135m at full width and depth, fp32,
# remat "dots", at train_lm's batch; 3 steps of each entry point from one
# state (two states side by side: 2.15 GB more than train_lm's 29.8 GB).
PAR_BATCH, PAR_SEQ, PAR_STEPS = LM_BATCH, LM_SEQ, 3
PSUM_BYTES = 64 * 2 ** 20       # compressed_psum's fp32 input
# Two processes on the card over gloo: one step at 2 x 512 tokens (gloo
# stages every CUDA tensor through host memory), held to the CPU tests'
# tolerances against one process (tests/test_torch_distributed.py: loss
# 2e-4, every parameter 5e-3, the global norm 1e-5 relative, m, v and
# master 5e-3 of each leaf's largest magnitude).
PAR2_BATCH, PAR2_SEQ = 2, 512
PAR_LOSS_TOL, PAR_PARAM_TOL, PAR_NORM_RTOL, PAR_OPT_TOL = 2e-4, 5e-3, 1e-5, 5e-3
PAR_TIMEOUT_S = 180             # a pair of processes' join
PAR_BSHARD = "1x2_attn_batch_shard"    # the (1, 2) step, attention by rows


def _par_plan_and_opt(cfg):
    plan = plan_memory(cfg, tp=1, dp=1)
    ocfg = AdamWConfig(lr=LM_LR, warmup_steps=LM_WARMUP,
                       total_steps=PAR_STEPS + 1,
                       state_dtype=plan.opt_dtype, use_master=plan.use_master)
    return plan, ocfg


def _par_state(cfg, plan, ocfg):
    return init_train_state(cfg, plan,
                            torch.Generator(device=DEVICE).manual_seed(0),
                            ocfg, dtype=torch.float32, device=DEVICE)


def _par_batches(cfg, n: int, batch: int = PAR_BATCH,
                 seq: int = PAR_SEQ) -> list:
    data = DataIterator(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                   global_batch=batch, seed=0),
                        device=DEVICE)
    return [next(data) for _ in range(n)]


def _timed_steps(step, state, batches) -> tuple:
    """Each step's metrics (read to the host) and its host-clock ms."""
    ms, metrics = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        m = {k: (v.item() if torch.is_tensor(v) else v) for k, v in m.items()}
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    return state, metrics, ms


def _scaled_err(got: dict, want: dict) -> float:
    """The largest error over the leaves of ``want``, each over that
    leaf's largest magnitude."""
    return max(((got[n] - t).abs().max()
                / max(t.abs().max().item(), 1e-30)).item()
               for n, t in want.items())


def _gloo_rank(rank: int, directory: str) -> None:
    """One of two processes on the one card, over gloo with CUDA tensors
    (NCCL refuses two ranks on one GPU): one step of the (1 data, 2 model)
    and of the (2 data, 1 model) sharded step against make_train_step from
    the same state and batch, and the (1, 2) step again with
    ``attn_batch_shard`` (smollm's 9 heads, replicated over the 2 model
    ranks, attend by rows: one of the 2 a rank), also against the unsplit
    (1, 2) step; each step's kernel launches on this rank. Writes its
    results as JSON to ``directory``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{directory}/store",
                            rank=rank, world_size=2)
    cfg = get_config(LM_ARCH)
    plan, ocfg = _par_plan_and_opt(cfg)
    batch = _par_batches(cfg, 1, PAR2_BATCH, PAR2_SEQ)[0]
    ref = _par_state(cfg, plan, ocfg)
    ref, ref_m, ref_ms = _timed_steps(make_train_step(cfg, plan, ocfg),
                                      ref, [batch])
    out, unsplit = {}, None
    # smollm's 9 heads do not divide over 2 model ranks, so the rules
    # replicate its attention; attn_batch_shard splits its rows instead
    split_cfg = dataclasses.replace(cfg, attn_batch_shard=True)
    for label, shape, c in (("1x2", (1, 2), cfg), ("2x1", (2, 1), cfg),
                            (PAR_BSHARD, (1, 2), split_cfg)):
        mesh = build_mesh(shape, ("data", "model"))
        state = shard_train_state(c, plan, _par_state(c, plan, ocfg), mesh)
        torch.cuda.synchronize()
        _zero_lm_counts()
        state, m, ms = _timed_steps(
            sharded_train_step(c, plan, mesh, ocfg), state, [batch])
        launches = _lm_counts()
        split = [layer.attn.batch_group is not None
                 for layer in state["model"].layers]
        full = gather_train_state(state, mesh)
        out[label] = {
            "loss": m[0]["loss"], "ref_loss": ref_m[0]["loss"],
            "grad_norm": m[0]["grad_norm"],
            "ref_grad_norm": ref_m[0]["grad_norm"],
            "param_max_abs_err": max(
                (full["params"][n] - p.detach()).abs().max().item()
                for n, p in ref["params"].items()),
            **{f"{part}_scaled_err": _scaled_err(full["opt"][part],
                                                 ref["opt"][part])
               for part in ("m", "v", "master")},
            "step_ms": ms[0], "ref_step_ms": ref_ms[0],
            "launches": launches,
            "attention_split_layers": sum(split)}
        if label == "1x2":
            unsplit = (m[0], full)
        elif label == PAR_BSHARD:
            # against the unsplit (1, 2) step: the loss, and the first
            # moments (one step's (1 - b1) g) and the parameters
            out[label]["vs_unsplit"] = {
                "loss_diff": abs(m[0]["loss"] - unsplit[0]["loss"]),
                "m_scaled_err": _scaled_err(full["opt"]["m"],
                                            unsplit[1]["opt"]["m"]),
                "param_max_abs_err": max(
                    (full["params"][n] - p).abs().max().item()
                    for n, p in unsplit[1]["params"].items())}
            unsplit = None
        del state, full
        torch.cuda.empty_cache()
    with open(os.path.join(directory, f"rank_{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _gloo_pair(target=_gloo_rank, phase: str = "parallel_gloo",
               timeout_s: float = PAR_TIMEOUT_S) -> list:
    """``target`` (``_gloo_rank``) in two fresh processes; each rank's
    results. A rank that exits other than 0, or a pair that has not ended
    in ``timeout_s``, fails the run (the other rank is killed then)."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    directory = tempfile.mkdtemp(prefix="chip_smoke_gloo_")
    try:
        procs = [ctx.Process(target=target, args=(r, directory))
                 for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while (any(p.is_alive() for p in procs)
               and not any(p.exitcode for p in procs)
               and time.monotonic() < deadline):
            time.sleep(0.2)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0, 0]:
            raise SystemExit(f"chip_smoke: {phase} phase failed: the two "
                             f"ranks exited {codes} (a negative code is a "
                             f"kill, at {timeout_s} s or after the other "
                             "rank failed)")
        return [json.loads(Path(directory, f"rank_{r}.json").read_text())
                for r in range(2)]
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def _compressed_psum_case(group) -> dict:
    """compressed_psum over the one-rank NCCL group on PSUM_BYTES of fp32:
    its ms (CUDA events, 20 calls), the bytes it moves on the device and
    over the wire, and its error against the exact sum (x itself)."""
    n = PSUM_BYTES // 4
    world = dist.get_world_size(group)
    x = torch.randn(n, device=DEVICE,
                    generator=torch.Generator(device=DEVICE).manual_seed(2))
    total, err = compressed_psum(x, group)
    torch.cuda.synchronize()
    scale = x.abs().max().item() / 127.0
    max_err = (total - x).abs().max().item()
    iters = 20
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        compressed_psum(x, group)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    # Read x (4 B), write the error (4 B) and the sum (4 B), write the int8
    # tensor (1 B), and write and read the gathered int8 tensors (2 N B).
    device_bytes = n * (13 + 2 * world)
    return {"numel": n, "input_bytes": 4 * n, "ranks": world, "ms": ms,
            "wire_bytes_per_rank": n + 4,
            "device_bytes": device_bytes,
            "bound_ms": bound(0, device_bytes, PEAK_FLOPS[torch.float32])["bound_ms"],
            "bound_by": "bytes", "max_abs_err": max_err,
            "err_bound": world * scale}


def _nccl_share(prof) -> dict:
    """The profiled step's device time, and the share of it in NCCL's
    kernels."""
    device_us, launches, by_name = _device_time(prof, 1, "step")
    nccl = [e for e in by_name if "nccl" in e["name"].lower()]
    nccl_us = sum(e["launches_per_step"] * e["device_us_per_launch"]
                  for e in nccl)
    if not device_us:
        return {"nccl_share": "not measured",
                "reason": "torch.profiler reported no device time"}
    return {"device_ms": device_us / 1e3, "device_launches": launches,
            "nccl_launches": sum(e["launches_per_step"] for e in nccl),
            "nccl_ms": nccl_us / 1e3, "nccl_share": nccl_us / device_us}


def phase_parallel() -> dict:
    """The distribution layer on the card, one rank: a NCCL group and a
    (1 data, 1 model) mesh; PAR_STEPS sharded_train_steps of full-width,
    full-depth smollm-135m (the kernels' counts zeroed just before, read
    just after) against PAR_STEPS make_train_steps from the same state and
    batches, every collective an identity: the metrics and every leaf of
    params, m, v and master bitwise equal; both step times, and one more
    sharded step under torch.profiler for the NCCL kernels' share of the
    device time; compressed_psum over 64 MiB. Returns the sharded steps'
    kernel launches."""
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config(LM_ARCH)
    plan, ocfg = _par_plan_and_opt(cfg)
    directory = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{directory}/store",
                            rank=0, world_size=1)
    try:
        mesh = build_mesh((1, 1), ("data", "model"))
        batches = _par_batches(cfg, PAR_STEPS + 1)
        state = shard_train_state(cfg, plan, _par_state(cfg, plan, ocfg),
                                  mesh)
        step = sharded_train_step(cfg, plan, mesh, ocfg)
        torch.cuda.synchronize()
        _zero_lm_counts()
        state, metrics, step_ms = _timed_steps(step, state,
                                               batches[:PAR_STEPS])
        launches = _lm_counts()
        ref = _par_state(cfg, plan, ocfg)
        ref, ref_metrics, ref_ms = _timed_steps(
            make_train_step(cfg, plan, ocfg), ref, batches[:PAR_STEPS])
        want, got = _state_leaves(ref), _state_leaves(state)
        differing = sorted(n for n, t in want.items()
                           if not torch.equal(t, got[n]))
        metrics_equal = [{k: m[k] == r[k] for k in ("loss", "grad_norm")}
                         for m, r in zip(metrics, ref_metrics)]
        del ref
        torch.cuda.empty_cache()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            state, _ = step(state, batches[PAR_STEPS])
            torch.cuda.synchronize()
        nccl = _nccl_share(prof)
        del state
        torch.cuda.empty_cache()
        psum = _compressed_psum_case(dist.group.WORLD)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(directory, ignore_errors=True)

    problems = []
    if differing or set(want) != set(got):
        problems.append(f"{len(differing)} of {len(want)} leaves differ from "
                        f"make_train_step's: {differing[:8]}")
    if not all(all(e.values()) for e in metrics_equal):
        problems.append(f"metrics differ: {metrics_equal}")
    expected = _expected_lm_launches(cfg, plan.remat, PAR_STEPS)
    if launches != expected:
        problems.append(f"launches {launches} != {expected}")
    if not psum["max_abs_err"] <= psum["err_bound"]:
        problems.append(f"compressed_psum off the exact sum by "
                        f"{psum['max_abs_err']} > {psum['err_bound']}")
    emit("parallel", arch=cfg.arch_id, dtype="float32",
         global_batch=PAR_BATCH, seq_len=PAR_SEQ, mesh=[1, 1],
         backend="nccl", plan={"remat": plan.remat,
                               "zero_stage": plan.zero_stage,
                               "use_master": plan.use_master},
         steps=PAR_STEPS, leaves=len(want), leaves_differing=len(differing),
         metrics_equal=metrics_equal, losses=[m["loss"] for m in metrics],
         sharded_step_ms=step_ms, make_train_step_ms=ref_ms,
         launches=launches, profiled_sharded_step=nccl,
         compressed_psum=psum, problems=problems)
    if problems:
        raise SystemExit(f"chip_smoke: parallel phase failed: {problems}")
    return launches


def phase_parallel_gloo() -> None:
    """Two processes on the card over gloo with CUDA tensors: the (1, 2)
    and (2, 1) sharded steps of full-width smollm-135m against one process
    on every rank, which must pass, and the (1, 2) step with
    ``attn_batch_shard`` against one process and the unsplit step. (gloo
    refuses ``batch_isend_irecv`` of CUDA tensors, so gpipe is held on the
    CPU only.)"""
    ranks, problems = _gloo_pair(), []
    for rank, result in enumerate(ranks):
        if sorted(result) != sorted(["1x2", "2x1", PAR_BSHARD]):
            problems.append(f"rank {rank} reported {sorted(result)}")
            continue
        split, whole = result[PAR_BSHARD], result["1x2"]
        near = split["vs_unsplit"]
        if (split["launches"] != whole["launches"]
                or not split["launches"]["flash_attention"]
                or not split["launches"]["flash_attention_backward"]
                or split["attention_split_layers"]
                != get_config(LM_ARCH).num_layers
                or whole["attention_split_layers"]
                or near["loss_diff"] > PAR_LOSS_TOL
                or near["m_scaled_err"] > PAR_OPT_TOL
                or near["param_max_abs_err"] > PAR_PARAM_TOL):
            problems.append(f"rank {rank} attn_batch_shard off the unsplit "
                            f"step: {split}")
        for shape, s in result.items():
            ok = (abs(s["loss"] - s["ref_loss"]) <= PAR_LOSS_TOL
                  * max(1.0, abs(s["ref_loss"]))
                  and abs(s["grad_norm"] - s["ref_grad_norm"])
                  <= PAR_NORM_RTOL * abs(s["ref_grad_norm"])
                  and s["param_max_abs_err"] <= PAR_PARAM_TOL
                  and all(s[f"{part}_scaled_err"] <= PAR_OPT_TOL
                          for part in ("m", "v", "master")))
            if not ok:
                problems.append(f"rank {rank} {shape} off one process: {s}")
    emit("parallel_gloo", global_batch=PAR2_BATCH, seq_len=PAR2_SEQ,
         ranks=ranks,
         step_ms={label: [r.get(label, {}).get("step_ms") for r in ranks]
                  for label in ranks[0]},
         problems=problems)
    if problems:
        raise SystemExit(f"chip_smoke: parallel_gloo phase failed: "
                         f"{problems}")


# The ssm and hybrid families split over the model axis on the same pair of
# processes: mamba2-780m and zamba2-2.7b at full width, their depth cut to 4
# and 6 layers (zamba2's shared block once, after its 6th, as published),
# one sharded (1 data, 2 model) step of PAR2_BATCH x PAR2_SEQ tokens against
# make_train_step under parallel_gloo's tolerances, the master copies held
# to the one process's where its gradient is resolved (_master_where_resolved):
# AdamW's first step moves an element by about lr whatever its gradient, so
# a gradient at the noise of fp32 sums, whose sign two summation orders
# disagree on, moves it by +-lr there. Then split
# serving against the whole model, bf16 and fp32: a prefill of
# SSM_SERVE_BATCH x SSM_SERVE_PROMPT tokens and SSM_SERVE_TICKS greedy
# ticks, every call's
# fp32 logits within LOGIT_TOL, its bf16 logits within twice the distance
# of the whole bf16 model's from the whole fp32 model's (two bf16 runs of
# one function, each as far from fp32 as bf16 puts it), the greedy tokens
# equal except at a tie those differences can flip (the two best logits of
# the whole model within twice the call's difference).
SSM_PAR_LAYERS = {MAMBA_ARCH: 4, ZAMBA_ARCH: 6}
SSM_SERVE_BATCH, SSM_SERVE_PROMPT, SSM_SERVE_TICKS = 2, 128, 3
SSM_PAR_TIMEOUT_S = 300
# A one-process first moment above this share of its leaf's largest is a
# resolved gradient. The fp32 noise of two summation orders flips signs up
# to some 4e-5 of a leaf's largest (the phase prints ``largest_flip``), and
# near it, through AdamW's eps, still moves a zero-initialised leaf (conv_b,
# whose largest master is one step of lr) by about 1e-2 of its largest at
# 1e-4; at 1e-3 that term is some 100 times smaller.
MASTER_RESOLVED = 1e-3


class _KernelCalls(TorchDispatchMode):
    """The port's kernel operators a region calls, counted by name and the
    shape of each call's first input: (b, s, heads, p) for the SSD scan,
    (b, heads, s, d) for attention, the rows for RMSNorm; an attention call
    whose keys are not as many as its queries (a cross-attention's, a
    decode tick's) adds ``skv`` and their count. A training route's
    attention call with a ``q_offset`` adds ``q_offset``, an SSD scan call
    from an initial state ``init_state``."""

    TAGGED = {"flash_attention_lse": (4, "q_offset"),
              "flash_attention_backward": (7, "q_offset"),
              "ssd_scan": (6, "init_state"),
              "ssd_scan_train": (6, "init_state"),
              "ssd_scan_backward": (11, "init_state")}

    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "repro_torch":
            key = f"{func._opname} {list(args[0].shape)}"
            if (func._opname.startswith("flash_attention")
                    and args[1].shape[2] != args[0].shape[2]):
                key += f" skv {args[1].shape[2]}"
            at, tag = self.TAGGED.get(func._opname, (None, None))
            if at is not None and len(args) > at and args[at] is not None:
                key += f" {tag}"
            self.calls[key] = self.calls.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


def _expected_split_launches(cfg, remat: str) -> dict:
    """``_expected_mamba_launches`` of one step of a model split over the
    model axis: the gated norm's row is split, so each layer's ``norm_g``
    leaves the RMSNorm kernel for ``split_rms_norm``."""
    out = _expected_mamba_launches(cfg, remat, 1)
    again = 1 if remat == "none" else 2
    out["rmsnorm"] -= again * cfg.num_layers
    out["rmsnorm_backward"] -= cfg.num_layers
    return out


def _worst_leaf(got: dict, want: dict, m: dict) -> dict:
    """Where ``_scaled_err`` finds its largest error: the leaf, the error
    over the leaf's largest magnitude, and the one-process first moment
    there beside the leaf's largest (after one step m is (1 - beta1) times
    the gradient: how small a gradient AdamW's normalised step carried)."""
    name = max(want, key=lambda n: ((got[n] - want[n]).abs().max()
                                    / max(want[n].abs().max().item(), 1e-30)))
    diff = (got[name] - want[name]).abs().flatten()
    at = int(diff.argmax())
    return {"leaf": name,
            "scaled_err": (diff[at] / max(want[name].abs().max().item(),
                                          1e-30)).item(),
            "got": got[name].flatten()[at].item(),
            "want": want[name].flatten()[at].item(),
            "m_there": m[name].flatten()[at].item(),
            "m_largest": m[name].abs().max().item()}


def _master_where_resolved(got: dict, want: dict, m_got: dict,
                           m_want: dict, out: dict = None) -> dict:
    """The split step's master copies (``got``) against the one process's
    (``want``) where the one-process first moment ``m_want`` exceeds
    MASTER_RESOLVED of its leaf's largest: the largest error there over the
    leaf's largest master, and its leaf. Beside it, for the record, the
    share of elements resolved, how many resolved elements the two steps'
    first moments disagree in sign on, and the largest one-process first
    moment (over its leaf's largest) at which they disagree anywhere.
    Adds ``want``'s leaves to ``out``, where given (an earlier call's)."""
    out = out or {"scaled_err": 0.0, "leaf": None, "resolved": 0,
                  "elements": 0, "resolved_sign_flips": 0,
                  "largest_flip": 0.0}
    for name, w in want.items():
        m = m_want[name]
        largest = max(m.abs().max().item(), 1e-30)
        resolved = m.abs() > MASTER_RESOLVED * largest
        flips = (m * m_got[name]) < 0
        err = ((got[name] - w).abs() * resolved).max().item() / max(
            w.abs().max().item(), 1e-30)
        if err >= out["scaled_err"]:
            out["scaled_err"], out["leaf"] = err, name
        out["resolved"] += int(resolved.sum())
        out["elements"] += m.numel()
        out["resolved_sign_flips"] += int((flips & resolved).sum())
        if flips.any():
            out["largest_flip"] = max(out["largest_flip"],
                                      m.abs()[flips].max().item() / largest)
    return out


def _split_errors(state: dict, ref: dict, mesh) -> dict:
    """The split state against the one process's, gathered one leaf at a
    time (a gathered copy of the whole state would hold it a third time
    on the card): the parameters' largest absolute error; m's, v's and the
    master's largest over each leaf's largest, and where (``_worst_leaf``);
    the master where resolved (``_master_where_resolved``)."""
    sh, opt, parts = state["shardings"], state["opt"], ("m", "v", "master")
    param_err, worst, resolved = 0.0, {}, None
    for n, p in ref["params"].items():
        got = gather_full(state["params"][n].detach(), sh["params"][n], mesh)
        param_err = max(param_err, (got - p.detach()).abs().max().item())
        got = {part: {n: gather_full(opt[part][n], sh["opt"][part][n], mesh)}
               for part in parts}
        want = {part: {n: ref["opt"][part][n]} for part in parts}
        for part in parts:
            w = _worst_leaf(got[part], want[part], want["m"])
            if part not in worst or w["scaled_err"] > worst[part][
                    "scaled_err"]:
                worst[part] = w
        resolved = _master_where_resolved(got["master"], want["master"],
                                          got["m"], want["m"], resolved)
        del got
    return {"param_max_abs_err": param_err,
            **{f"{part}_scaled_err": worst[part]["scaled_err"]
               for part in parts},
            "worst": worst, "master_where_resolved": resolved}


def _moe_layers(model) -> list:
    return [layer.moe for layer in getattr(model, "layers", ())
            if hasattr(layer, "moe")]


def _moe_drops(model, mesh=None) -> list:
    """Each MoE layer's (token, expert) pairs dropped for capacity in its
    last call (``MoE.stats``), summed over the ranks of ``mesh`` that split
    them: the data ranks (their rows) and, under EP, the model ranks
    (their experts)."""
    out = []
    for moe in _moe_layers(model):
        n = (moe.stats["routed"] - moe.stats["kept"]).reshape(1).float()
        ep = moe.we_up.shape[0] < moe.cfg.moe.num_experts
        if mesh is not None:
            for a in dp_axes(mesh) + (("model",) if ep else ()):
                dist.all_reduce(n, group=mesh.get_group(a))
        out.append(int(n.item()))
    return out


# A one-process MoE step held against a split one takes the split's routing
# decisions: the two runs' gates are fp32 sums in other orders (the split's
# projections on its block of the rows, its attention over gathered keys),
# ~1e-6 apart, and a pair whose gate lies that close to its expert's
# capacity boundary (2.2e-8 at granite's fourth layer in
# parallel_gloo_seq_families, on an H100) is kept by one run and dropped by
# the other, moving that expert's gradient by a token. Every pick the oracle so
# takes otherwise than its own gates would must lie within twice the gates'
# largest difference of its expert's boundary (``_step_problems``).


@contextlib.contextmanager
def _patched(module, name: str, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


class _FollowedRouting:
    """Records a split step's gathered combine matrices (``models.common.
    _gathered``: each MoE layer's gates of the global microbatch), then
    makes a one-process step pick each expert's tokens by them
    (``_pick``): its own gates weigh the picks, the split's decide them.
    ``report()``: the gates' largest difference between the runs and each
    pair picked otherwise than the oracle's own gates would (the gate's
    distance from its expert's boundary, the last of its own picks)."""

    def __init__(self):
        self.records, self.flips, self.noise = [], {}, 0.0

    def recording(self):
        gathered = model_common._gathered

        def record(*args, **kwargs):
            out = gathered(*args, **kwargs)
            self.records.append(out[0].clone())
            return out
        return _patched(model_common, "_gathered", record)

    def following(self):
        pick = model_common._pick

        def follow(routed, t, top_k, capacity_factor, decode, lo, n,
                   route_groups, seq_rows=None):
            vals, idx, keep = pick(routed, t, top_k, capacity_factor,
                                   decode, lo, n, route_groups, seq_rows)
            if decode or route_groups or not self.records:
                return vals, idx, keep
            own = routed.detach()
            diffs = [(w - own).abs().max().item() for w in self.records]
            layer = min(range(len(diffs)), key=diffs.__getitem__)
            self.noise = max(self.noise, diffs[layer])
            _, followed = model_common.stable_top_k(
                self.records[layer].T[lo:lo + n], idx.shape[1])
            gates = own.T[lo:lo + n]

            def kept(rows):                 # (n, t): the routed pairs kept
                return torch.zeros_like(gates, dtype=torch.bool).scatter(
                    1, rows, gates.gather(1, rows) > 0)
            mine = kept(idx)
            flipped = (mine ^ kept(followed)).nonzero().tolist()
            self.flips[layer] = [
                {"expert": lo + e, "token": i,
                 "kept_by_own_gates": bool(mine[e, i]),
                 "gap": abs(gates[e, i].item() - vals[e, -1].item())}
                for e, i in flipped]
            return routed.T[lo:lo + n].gather(1, followed), followed, keep
        return _patched(model_common, "_pick", follow)

    def report(self) -> dict:
        flips = [f for layer in sorted(self.flips) for f in self.flips[layer]]
        return {"gate_noise": self.noise, "flips": len(flips),
                "largest_flip_gap": max((f["gap"] for f in flips),
                                        default=0.0),
                "flipped": flips[:8]}


def _in_turn(fn):
    """``fn()`` on each rank in turn, the others waiting, each freeing its
    cached blocks after: the ranks share one card."""
    out = None
    for r in range(dist.get_world_size()):
        if dist.get_rank() == r:
            out = fn()
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def _split_step(cfg, mesh, batch: dict, expected,
                in_turn: bool = False) -> dict:
    """One sharded step on ``mesh`` against make_train_step from the same
    state and ``batch``: the errors, the split step's kernel launches (counts
    zeroed just before it, read just after) against ``expected(cfg,
    remat)`` and the kernels and shapes it calls. Then, on the same batch, a
    second step of each, timed once warm (the first beside it). ``in_turn``:
    the ranks run their one-process steps in turn (``_in_turn``), where two
    at once would not fit on the card beside the split states (seamless's
    of a 4,096-token row peaks at ~41 GB a process). The split state is
    laid out before the one process's is drawn, so that a rank holds one
    whole state at a time beside its pieces; ``peak_bytes``: the process's
    largest allocation on the card. A MoE's first steps also
    count, in each of its layers, the (token, expert) pairs each route
    dropped (``_moe_drops``); there the split step runs first and the one
    process follows its routing decisions (``_FollowedRouting``)."""
    plan, ocfg = _par_plan_and_opt(cfg)
    torch.cuda.reset_peak_memory_stats()
    state = shard_train_state(cfg, plan, _par_state(cfg, plan, ocfg), mesh)
    torch.cuda.empty_cache()
    step = sharded_train_step(cfg, plan, mesh, ocfg)
    ref = _par_state(cfg, plan, ocfg)
    for moe in _moe_layers(state["model"]) + _moe_layers(ref["model"]):
        moe.stats = {}
    ref_step = make_train_step(cfg, plan, ocfg)
    follow = _FollowedRouting() if _moe_layers(ref["model"]) else None
    one_step = lambda: _timed_steps(ref_step, ref, [batch])
    run_ref = (lambda: _in_turn(one_step)) if in_turn else one_step
    if follow is None:
        ref, ref_m, ref_first = run_ref()
    _zero_kernel_counts()
    with _KernelCalls() as calls, (follow.recording() if follow
                                   else contextlib.nullcontext()):
        state, m, first = _timed_steps(step, state, [batch])
    launches = _kernel_counts()
    if follow is not None:
        with follow.following():
            ref, ref_m, ref_first = run_ref()
    out = {
        "remat": plan.remat, "loss": m[0]["loss"],
        "ref_loss": ref_m[0]["loss"], "grad_norm": m[0]["grad_norm"],
        "ref_grad_norm": ref_m[0]["grad_norm"], "aux": m[0]["aux"],
        "ref_aux": ref_m[0]["aux"],
        **_split_errors(state, ref, mesh),
        "step_launches": launches,
        "expected_step_launches": expected(cfg, plan.remat)}
    if follow is not None:
        out["routing"] = follow.report()
        out["dropped"] = _moe_drops(state["model"], mesh)
        out["ref_dropped"] = _moe_drops(ref["model"])
        for moe in _moe_layers(state["model"]) + _moe_layers(ref["model"]):
            moe.stats = None
    ref, _, ref_ms = run_ref()
    del ref, one_step, run_ref
    state, _, ms = _timed_steps(step, state, [batch])
    out.update(step_ms=ms[0], ref_step_ms=ref_ms[0], first_step_ms=first[0],
               ref_first_step_ms=ref_first[0], step_kernel_calls=calls.calls,
               step_peak_bytes=torch.cuda.max_memory_allocated())
    del state
    torch.cuda.empty_cache()
    return out


def _greedy_calls(model, tokens, cache, feed=None, inputs=None) -> tuple:
    """A prefill (with the family's ``inputs``: the encdec's frames, the
    VLM's patches) and SSM_SERVE_TICKS ticks: the last position's logits of
    each call (fp32), and the tokens each tick was fed: ``feed``, else the
    model's own greedy picks."""
    out = [model.prefill(tokens, cache, **(inputs or {}))[0][:, -1].float()]
    picks = []
    for t in range(SSM_SERVE_TICKS):
        picks.append(out[-1].argmax(-1, keepdim=True) if feed is None
                     else feed[t])
        out.append(model.decode_step(cache, picks[-1])[0][:, -1].float())
    return out, picks


def _compare_calls(got: list, want: list) -> list:
    """Each call's largest logit difference, the whole model's largest
    logit, whether the picks are equal, and the picks that differ where
    the whole model's margin exceeds twice that difference (no tie)."""
    out = []
    for g, w in zip(got, want):
        err = (g - w).abs().max().item()
        picks, refs = g.argmax(-1), w.argmax(-1)
        margin = (w.gather(-1, refs[:, None])
                  - w.gather(-1, picks[:, None]))[:, 0]
        out.append({"logit_max_abs_err": err,
                    "logit_scale": w.abs().max().item(),
                    "tokens_equal": bool(torch.equal(picks, refs)),
                    "untied_flips": int(((picks != refs)
                                         & (margin > 2 * err)).sum())})
    return out


def _split_serving(cfg, mesh, prompt: int, inputs=None,
                   cache_rows: int = 0, src_len=None) -> dict:
    """Split serving against the whole model, bf16 and then fp32, each
    pair drawn from one seed: a prefill of SSM_SERVE_BATCH x ``prompt``
    tokens (behind the family's ``inputs``, which take ``cache_rows`` more
    of the cache; ``src_len``: the encdec's source frames) and
    SSM_SERVE_TICKS ticks, every run fed the bf16 whole model's greedy
    tokens (so a tie that flips one pick steers nothing). The whole model
    runs first and is freed before the split one is drawn, so that a rank
    holds one whole model at a time. Per call: the logits' difference and
    the picks; for bf16 also how far the whole bf16 model's logits lie from
    the whole fp32 model's (bf16's own error, the bf16 split's yardstick).
    The kernels the split calls launched, counted and logged by shape;
    this rank's cache shapes; the process's largest allocation on the
    card."""
    plan = plan_memory(cfg, tp=1, dp=1)
    b = SSM_SERVE_BATCH
    tokens = torch.randint(0, cfg.vocab_size, (b, prompt), device=DEVICE,
                           generator=torch.Generator(
                               device=DEVICE).manual_seed(2))
    make = lambda dtype: get_model(cfg)(
        cfg, dtype=dtype, device=DEVICE,
        generator=torch.Generator(device=DEVICE).manual_seed(1))
    cache_args = (b, cache_rows + prompt + SSM_SERVE_TICKS + 1) + (
        () if src_len is None else (src_len,))
    out, whole_logits, feed = {}, {}, None
    launches = dict.fromkeys(_kernel_counts(), 0)
    torch.cuda.reset_peak_memory_stats()
    for dtype in (torch.bfloat16, torch.float32):
        ref = make(dtype)
        with torch.no_grad():
            want, picks = _greedy_calls(ref, tokens,
                                        ref.init_cache(*cache_args), feed,
                                        inputs)
        feed = feed or picks
        del ref
        torch.cuda.empty_cache()
        model = make(dtype)
        whole = model.init_cache(*cache_args)
        shard_model(cfg, plan, model, mesh, batch_rows=b)
        specs = cache_shardings(cfg, mesh, whole)
        specs["pos"] = batch_spec(mesh, (b,))
        cache = {n: local_shard(t, specs[n], mesh).clone()
                 for n, t in whole.items()}
        del whole
        torch.cuda.empty_cache()
        with torch.no_grad():
            _zero_kernel_counts()
            with _KernelCalls() as calls:
                got, _ = _greedy_calls(model, tokens, cache, feed, inputs)
            for name, n in _kernel_counts().items():
                launches[name] += n
        whole_logits[dtype] = want
        out[dtype_name(dtype)] = {"calls": _compare_calls(got, want),
                                  "kernel_calls": calls.calls}
        cache_shapes = {n: list(t.shape) for n, t in cache.items()}
        del model, cache
        torch.cuda.empty_cache()
    for call, w16, w32 in zip(out["bfloat16"]["calls"],
                              whole_logits[torch.bfloat16],
                              whole_logits[torch.float32]):
        call["whole_bf16_vs_fp32"] = (w16 - w32).abs().max().item()
    return {"serve": out, "serve_launches": launches,
            "serve_shape": [b, prompt, SSM_SERVE_TICKS],
            "cache_shapes": cache_shapes,
            "serve_peak_bytes": torch.cuda.max_memory_allocated()}


def _gloo_ssm_rank(rank: int, directory: str) -> None:
    """One of two processes on the one card over gloo with CUDA tensors:
    for mamba2-780m and zamba2-2.7b (full width, cut depth) on a (1 data,
    2 model) mesh, ``_split_step`` and ``_split_serving``.
    Writes its results as JSON to ``directory``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{directory}/store",
                            rank=rank, world_size=2)
    mesh = build_mesh((1, 2), ("data", "model"))
    out = {}
    for arch, layers in SSM_PAR_LAYERS.items():
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        batch = _par_batches(cfg, 1, PAR2_BATCH, PAR2_SEQ)[0]
        out[arch] = {"layers": layers,
                     **_split_step(cfg, mesh, batch,
                                   _expected_split_launches),
                     **_split_serving(cfg, mesh, SSM_SERVE_PROMPT)}
    with open(os.path.join(directory, f"rank_{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _routing_problems(tag: str, routing) -> list:
    """A one-process MoE run that followed a split one's routing
    (``_FollowedRouting``): each pick it took otherwise than its own gates
    would must lie within twice the gates' largest difference of its
    expert's capacity boundary."""
    if routing and routing["largest_flip_gap"] > 2 * routing["gate_noise"]:
        return [f"{tag}: the one process's picks differ from the split's "
                f"{routing['largest_flip_gap']} from a capacity boundary, "
                "beyond the gates' rounding"]
    return []


def _step_problems(tag: str, r: dict) -> list:
    """What a split step's results break: parallel_gloo's tolerances (the
    master where resolved) and the reckoned launches."""
    problems = []
    ok = (abs(r["loss"] - r["ref_loss"]) <= PAR_LOSS_TOL
          * max(1.0, abs(r["ref_loss"]))
          and abs(r["grad_norm"] - r["ref_grad_norm"])
          <= PAR_NORM_RTOL * abs(r["ref_grad_norm"])
          and r["param_max_abs_err"] <= PAR_PARAM_TOL
          and all(r[key] <= PAR_OPT_TOL for key in (
              "m_scaled_err", "v_scaled_err"))
          and r["master_where_resolved"]["scaled_err"] <= PAR_OPT_TOL)
    if not ok:
        problems.append(f"{tag}: the split step is off one process")
    problems += _routing_problems(tag, r.get("routing"))
    for name, n in r["expected_step_launches"].items():
        if r["step_launches"][name] != n:
            problems.append(f"{tag}: {name} launched "
                            f"{r['step_launches'][name]} times, not {n}")
    return problems


def _serving_problems(tag: str, r: dict) -> list:
    """What split serving breaks: fp32 logits within LOGIT_TOL of the whole
    model's, bf16 within twice the whole bf16 model's distance from the
    whole fp32 one, no pick off but at a tie."""
    problems = []
    for dtype, run in r["serve"].items():
        for i, c in enumerate(run["calls"]):
            tol = (LOGIT_TOL if dtype == "float32"
                   else 2 * c["whole_bf16_vs_fp32"])
            if c["logit_max_abs_err"] > tol:
                problems.append(f"{tag}: {dtype} serving call {i} logits "
                                f"off by {c['logit_max_abs_err']} > {tol}")
            if c["untied_flips"]:
                problems.append(f"{tag}: {dtype} serving call {i} picked "
                                "other tokens")
    return problems


def _ssm_rank_problems(rank: int, arch: str, r: dict) -> list:
    """What one rank's results of one model break: the step's and
    serving's checks, the kernels at the rank's heads, the split
    prefills' scans."""
    cfg = get_config(arch)
    heads, tag = cfg.ssm_heads // 2, f"rank {rank} {arch}"
    problems = _step_problems(tag, r) + _serving_problems(tag, r)
    want = [f"ssd_scan_train [{PAR2_BATCH}, {PAR2_SEQ}, {heads}, "
            f"{cfg.ssm.head_dim}]",
            f"ssd_scan_backward [{PAR2_BATCH}, {PAR2_SEQ}, {heads}, "
            f"{cfg.ssm.head_dim}]"]
    if cfg.family == "hybrid":
        want.append(f"flash_attention_lse [{PAR2_BATCH}, "
                    f"{cfg.num_heads // 2}, {PAR2_SEQ}, "
                    f"{cfg.resolved_head_dim}]")
    problems += [f"{tag}: no {w} in the step" for w in want
                 if w not in r["step_kernel_calls"]]
    if (cfg.family == "hybrid" and not any(
            k.startswith("flash_attention_backward ")
            for k in r["step_kernel_calls"])):
        problems.append(f"{tag}: no attention backward in the step")
    if r["serve_launches"]["ssd_scan"] != 2 * r["layers"]:
        problems.append(f"{tag}: the split prefills launched the SSD scan "
                        f"{r['serve_launches']['ssd_scan']} times")
    if cfg.family == "hybrid" and r["serve_launches"][
            "flash_attention"] != 2 * (1 + SSM_SERVE_TICKS):
        problems.append(f"{tag}: split serving launched attention "
                        f"{r['serve_launches']['flash_attention']} times")
    return problems


def phase_parallel_gloo_ssm() -> dict:
    """Two processes on the card over gloo with CUDA tensors: the ssm and
    hybrid families split over the model axis (``_gloo_ssm_rank``), which
    must pass on every rank. Returns the kernels' launches on this path,
    both ranks' step and split serving summed."""
    t0 = time.perf_counter()
    ranks = _gloo_pair(_gloo_ssm_rank, "parallel_gloo_ssm", SSM_PAR_TIMEOUT_S)
    problems = []
    launches = {}
    for rank, result in enumerate(ranks):
        if sorted(result) != sorted(SSM_PAR_LAYERS):
            problems.append(f"rank {rank} reported {sorted(result)}")
            continue
        for arch, r in result.items():
            problems += _ssm_rank_problems(rank, arch, r)
            for part in ("step_launches", "serve_launches"):
                for name, n in r[part].items():
                    launches[name] = launches.get(name, 0) + n
    emit("parallel_gloo_ssm", card=_smi("name,power.limit"),
         mesh=[1, 2], global_batch=PAR2_BATCH, seq_len=PAR2_SEQ,
         layers=SSM_PAR_LAYERS, ranks=ranks, launches=launches,
         seconds=time.perf_counter() - t0, problems=problems)
    if problems:
        raise SystemExit(f"chip_smoke: parallel_gloo_ssm phase failed: "
                         f"{problems}")
    return launches


# The encoder-decoder and the VLM split over the model axis on two processes
# over gloo at (1 data, 2 model), full width, under parallel_gloo_ssm's
# checks. seamless-m4t-large-v2 at 4 + 4 of its 24 + 24 layers, fp32
# (plan_memory: ZeRO-1, remat "dots"): one step of 2 rows of 512 target
# tokens over 1,024 source frames (its source_frac of 0.5 would give 256:
# cut so that the cross-attention's keys outnumber its queries), then split
# serving of 2 x 64 tokens over 1,024 frames. internvl2-76b at 2 of its 80
# layers, split serving alone (2 x 64 tokens behind its 256 patches): at
# even one full-width layer the one process's fp32 train state is ~2.97 B
# parameters x 16 B = 47.5 GB, and the split's two halves as much again.
VLM_ARCH = "internvl2-76b"
SPLIT_ENCDEC_LAYERS, SPLIT_VLM_LAYERS = 4, 2
SPLIT_BATCH, SPLIT_SEQ, SPLIT_SRC, SPLIT_PROMPT = 2, 512, 1024, 64
SPLIT_TIMEOUT_S = 300


def _split_configs() -> dict:
    """The two configurations at their cut depths."""
    enc = get_config(ENCDEC_ARCH)
    enc = dataclasses.replace(
        enc, num_layers=2 * SPLIT_ENCDEC_LAYERS,
        encdec=dataclasses.replace(enc.encdec,
                                   encoder_layers=SPLIT_ENCDEC_LAYERS,
                                   decoder_layers=SPLIT_ENCDEC_LAYERS))
    return {ENCDEC_ARCH: enc,
            VLM_ARCH: dataclasses.replace(get_config(VLM_ARCH),
                                          num_layers=SPLIT_VLM_LAYERS)}


def _seeded(shape, seed: int) -> torch.Tensor:
    return torch.randn(shape, device=DEVICE, generator=torch.Generator(
        device=DEVICE).manual_seed(seed))


def _gloo_split_rank(rank: int, directory: str) -> None:
    """One of two processes on the one card over gloo with CUDA tensors,
    on a (1 data, 2 model) mesh: seamless's ``_split_step`` and
    ``_split_serving`` (the source frames beside the tokens), internvl2's
    ``_split_serving`` (its patches ahead of them). Writes its results as
    JSON to ``directory``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{directory}/store",
                            rank=rank, world_size=2)
    mesh = build_mesh((1, 2), ("data", "model"))
    cfgs = _split_configs()
    enc, vlm = cfgs[ENCDEC_ARCH], cfgs[VLM_ARCH]
    batch = _par_batches(enc, 1, SPLIT_BATCH, SPLIT_SEQ)[0]
    batch["frames"] = _seeded((SPLIT_BATCH, SPLIT_SRC, enc.d_model), 3)
    frames = _seeded((SSM_SERVE_BATCH, SPLIT_SRC, enc.d_model), 4)
    expected = lambda cfg, remat: _expected_encdec_launches(
        cfg, 0, 0, steps=1, remat=remat)
    out = {ENCDEC_ARCH: {**_split_step(enc, mesh, batch, expected),
                         **_split_serving(enc, mesh, SPLIT_PROMPT,
                                          {"frames": frames},
                                          src_len=SPLIT_SRC)}}
    del batch, frames
    patches = _seeded((SSM_SERVE_BATCH, vlm.vision.num_patches,
                       vlm.d_model), 5)
    out[VLM_ARCH] = _split_serving(vlm, mesh, SPLIT_PROMPT,
                                   {"patches": patches},
                                   cache_rows=vlm.vision.num_patches)
    with open(os.path.join(directory, f"rank_{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _split_rank_problems(rank: int, arch: str, r: dict) -> list:
    """What one rank's results of one model break: the step's (seamless)
    and serving's checks, the launches split serving made against the
    whole model's reckoning, the kernels at the rank's heads (the cross
    K/V cache with them)."""
    cfg = _split_configs()[arch]
    heads, kv, d = (cfg.num_heads // 2, cfg.num_kv_heads // 2,
                    cfg.resolved_head_dim)
    tag = f"rank {rank} {arch}"
    problems = _serving_problems(tag, r)
    if arch == ENCDEC_ARCH:
        problems += _step_problems(tag, r)
        served = _expected_encdec_launches(cfg, 1, SSM_SERVE_TICKS)
        b, q, src = SPLIT_BATCH, SPLIT_SEQ, SPLIT_SRC
        want = [f"flash_attention_lse [{b}, {heads}, {src}, {d}]",
                f"flash_attention_lse [{b}, {heads}, {q}, {d}]",
                f"flash_attention_lse [{b}, {heads}, {q}, {d}] skv {src}",
                f"flash_attention_backward [{b}, {heads}, {src}, {d}]",
                f"flash_attention_backward [{b}, {heads}, {q}, {d}]",
                f"flash_attention_backward [{b}, {heads}, {q}, {d}] "
                f"skv {src}"]
        problems += [f"{tag}: no {w} in the step" for w in want
                     if w not in r["step_kernel_calls"]]
        if r["cache_shapes"]["cross_k"][3] != kv:
            problems.append(f"{tag}: the cross K/V cache holds "
                            f"{r['cache_shapes']['cross_k'][3]} heads")
        prefill = f"flash_attention [{SSM_SERVE_BATCH}, {heads}, {src}, {d}]"
    else:
        served = _expected_launches(cfg, 1, SSM_SERVE_TICKS)
        prefill = (f"flash_attention [{SSM_SERVE_BATCH}, {heads}, "
                   f"{cfg.vision.num_patches + SPLIT_PROMPT}, {d}]")
    if prefill not in r["serve"]["float32"]["kernel_calls"]:
        problems.append(f"{tag}: no {prefill} in the split prefill")
    for name in ("flash_attention", "rmsnorm"):
        if r["serve_launches"][name] != 2 * served[name]:
            problems.append(f"{tag}: split serving launched {name} "
                            f"{r['serve_launches'][name]} times, not "
                            f"{2 * served[name]}")
    return problems


def phase_parallel_gloo_split() -> dict:
    """Two processes on the card over gloo with CUDA tensors: the
    encoder-decoder and the VLM split over the model axis
    (``_gloo_split_rank``), which must pass on every rank. Returns the
    kernels' launches on this path, both ranks' step and split serving
    summed."""
    t0 = time.perf_counter()
    ranks = _gloo_pair(_gloo_split_rank, "parallel_gloo_split",
                       SPLIT_TIMEOUT_S)
    problems, launches = [], {}
    for rank, result in enumerate(ranks):
        if sorted(result) != sorted(_split_configs()):
            problems.append(f"rank {rank} reported {sorted(result)}")
            continue
        for arch, r in result.items():
            problems += _split_rank_problems(rank, arch, r)
            for part in ("step_launches", "serve_launches"):
                for name, n in r.get(part, {}).items():
                    launches[name] = launches.get(name, 0) + n
    emit("parallel_gloo_split", card=_smi("name,power.limit"),
         mesh=[1, 2], step={"global_batch": SPLIT_BATCH,
                            "seq_len": SPLIT_SEQ, "src_len": SPLIT_SRC},
         serve={"batch": SSM_SERVE_BATCH, "prompt": SPLIT_PROMPT,
                "ticks": SSM_SERVE_TICKS, "src_len": SPLIT_SRC},
         layers={ENCDEC_ARCH: [SPLIT_ENCDEC_LAYERS, SPLIT_ENCDEC_LAYERS],
                 VLM_ARCH: SPLIT_VLM_LAYERS},
         left_out=f"{VLM_ARCH}'s split training step: at one full-width "
                  "layer the one process's fp32 train state is ~2.97e9 "
                  "parameters x 16 B = 47.5 GB, the split's halves as much "
                  "again, more than the card's 80 GB (held on the CPU, "
                  "tests/test_torch_distributed_encdec.py)",
         ranks=ranks, launches=launches,
         seconds=time.perf_counter() - t0, problems=problems)
    if problems:
        raise SystemExit(f"chip_smoke: parallel_gloo_split phase failed: "
                         f"{problems}")
    return launches


# granite-moe-3b-a800m split over two processes on the card over gloo, full
# width (d 1536, 24 query heads over 8 KV heads of 64, 40 experts of d_ff 512
# top-8 at capacity 1.5, the 51,200-row padded vocabulary), its 32 layers cut
# to 2 (4 until the script's time passed 950 s): ~280 M parameters, an fp32
# train state of ~4.5 GB in one process and half of its experts (20 a rank: EP) on each rank. (1 data, 2 model): one
# step of PAR2_BATCH x PAR2_SEQ tokens against make_train_step under
# parallel_gloo_ssm's checks, the second of each timed, then split serving
# (bf16 and fp32, a prefill of SSM_SERVE_BATCH x SSM_SERVE_PROMPT tokens and
# SSM_SERVE_TICKS greedy ticks) against the whole model. (2 data, 1 model):
# one step whose MoE layers route the global microbatch against
# make_train_step on the whole batch, the same checks, its auxiliary loss
# within MOE_AUX_RTOL of the one process's (fp32 sums in another order) and
# each layer's capacity drops equal.
MOE_PAR_LAYERS = 2
MOE_PAR_TIMEOUT_S = 300
MOE_AUX_RTOL = 1e-5


def _moe_par_config():
    return dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_PAR_LAYERS)


def _gloo_moe_rank(rank: int, directory: str) -> None:
    """One of two processes on the one card over gloo with CUDA tensors:
    granite at its cut depth, ``_split_step`` and ``_split_serving`` on a
    (1 data, 2 model) mesh, then ``_split_step`` on a (2 data, 1 model)
    one. Writes its results as JSON to ``directory``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{directory}/store",
                            rank=rank, world_size=2)
    cfg = _moe_par_config()
    batch = _par_batches(cfg, 1, PAR2_BATCH, PAR2_SEQ)[0]
    expected = lambda cfg, remat: _expected_lm_launches(cfg, remat, 1)
    mesh = build_mesh((1, 2), ("data", "model"))
    out = {"1x2": {**_split_step(cfg, mesh, batch, expected),
                   **_split_serving(cfg, mesh, SSM_SERVE_PROMPT)}}
    mesh = build_mesh((2, 1), ("data", "model"))
    out["2x1"] = _split_step(cfg, mesh, batch, expected)
    with open(os.path.join(directory, f"rank_{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _moe_rank_problems(rank: int, r: dict) -> list:
    """What one rank's results break: both steps' checks, their auxiliary
    losses and capacity drops against one process's; at (1, 2) the
    kernels at the rank's 12 heads and split serving's checks and
    launches."""
    cfg = _moe_par_config()
    heads, d = cfg.num_heads // 2, cfg.resolved_head_dim
    problems = []
    for mesh, step in r.items():
        tag = f"rank {rank} {mesh}"
        problems += _step_problems(tag, step)
        if abs(step["aux"] - step["ref_aux"]) > MOE_AUX_RTOL * abs(
                step["ref_aux"]):
            problems.append(f"{tag}: aux {step['aux']} against "
                            f"{step['ref_aux']}")
        if step["dropped"] != step["ref_dropped"]:
            problems.append(f"{tag}: dropped {step['dropped']} against "
                            f"{step['ref_dropped']}")
    tag = f"rank {rank} 1x2"
    split = r["1x2"]
    problems += _serving_problems(tag, split)
    b, q = PAR2_BATCH, PAR2_SEQ
    want = [f"flash_attention_lse [{b}, {heads}, {q}, {d}]",
            f"flash_attention_backward [{b}, {heads}, {q}, {d}]",
            f"rmsnorm [{b}, {q}, {cfg.d_model}]"]
    problems += [f"{tag}: no {w} in the step" for w in want
                 if w not in split["step_kernel_calls"]]
    if not any(k.startswith("rmsnorm_backward ") and k.endswith(
            f"{cfg.d_model}]") for k in split["step_kernel_calls"]):
        problems.append(f"{tag}: no RMSNorm backward at {cfg.d_model}")
    prefill = f"flash_attention [{SSM_SERVE_BATCH}, {heads}, " \
              f"{SSM_SERVE_PROMPT}, {d}]"
    if prefill not in split["serve"]["float32"]["kernel_calls"]:
        problems.append(f"{tag}: no {prefill} in the split prefill")
    served = _expected_launches(cfg, 1, SSM_SERVE_TICKS)
    for name in ("flash_attention", "rmsnorm"):
        if split["serve_launches"][name] != 2 * served[name]:
            problems.append(f"{tag}: split serving launched {name} "
                            f"{split['serve_launches'][name]} times, not "
                            f"{2 * served[name]}")
    return problems


def phase_parallel_gloo_moe() -> dict:
    """Two processes on the card over gloo with CUDA tensors: the MoE split
    over the model axis and routed globally over the data axis
    (``_gloo_moe_rank``), which must pass on every rank. Returns the
    kernels' launches on this path, both ranks' steps and split serving
    summed."""
    t0 = time.perf_counter()
    ranks = _gloo_pair(_gloo_moe_rank, "parallel_gloo_moe", MOE_PAR_TIMEOUT_S)
    problems, launches = [], {}
    for rank, result in enumerate(ranks):
        if sorted(result) != ["1x2", "2x1"]:
            problems.append(f"rank {rank} reported {sorted(result)}")
            continue
        problems += _moe_rank_problems(rank, result)
        for r in result.values():
            for part in ("step_launches", "serve_launches"):
                for name, n in r.get(part, {}).items():
                    launches[name] = launches.get(name, 0) + n
    cfg = _moe_par_config()
    emit("parallel_gloo_moe", card=_smi("name,power.limit"),
         meshes=[[1, 2], [2, 1]], layers=MOE_PAR_LAYERS,
         params=cfg.param_count(),
         experts_a_rank={"1x2": cfg.moe.num_experts // 2, "2x1":
                         cfg.moe.num_experts},
         step={"global_batch": PAR2_BATCH, "seq_len": PAR2_SEQ},
         serve={"batch": SSM_SERVE_BATCH, "prompt": SSM_SERVE_PROMPT,
                "ticks": SSM_SERVE_TICKS},
         left_out=f"{MOE_ARCH}'s full depth (32 layers: ~3.3e9 parameters, "
                  "~53 GB of fp32 train state in one process before "
                  "activations, and the split's halves beside it); "
                  "expert-TP: on two ranks at published widths every MoE is "
                  "EP (40 and 128 experts both divide 2), so expert-TP is "
                  "held on the CPU only (tests/test_torch_distributed_moe.py)"
                  "; llama4-maverick-400b-a17b (a 400e9-parameter model)",
         ranks=ranks, launches=launches,
         seconds=time.perf_counter() - t0, problems=problems)
    if problems:
        raise SystemExit(f"chip_smoke: parallel_gloo_moe phase failed: "
                         f"{problems}")
    return launches


# Long-context serving with the cache split along its sequence: zamba2-2.7b
# at full width (d 2,560, 80 SSD heads of 64 with state 64, the shared
# block's 32 heads of 160), its 54 layers cut to 6 (the shared block runs
# once, attn_every 6 as published), on two processes sharing the card over
# gloo at (2 data, 1 model), B 1 (long_500k's one row, which does not
# divide over the data ranks: both run it whole, each holding one half of
# the shared block's cache, the SSM and conv states whole). Against the
# whole model on the same seeded cache, bf16 and then fp32, every run fed
# the bf16 whole model's greedy tokens:
#   * two decode cases at long_500k's published 524,288 rows, each 4
#     ticks: the cache's first pos0 rows and the SSM and conv states drawn
#     from a seed (a 524,288-token prefill is ~2.8 PFLOP of causal
#     attention alone), in blocks of LONG_BLOCK rows with a seed each, so
#     that a rank draws only its half: pos0 524,280 (both halves full, the
#     writes on rank 1) and 262,142 (the writes cross from rank 0 to rank 1
#     at the third tick; rank 1 sees no key until then);
#   * a prefill case: max_seq 8,192, a 6,143-token prompt through the real
#     prefill (SSD scans and attention kernels), then 3 ticks; rank 0 holds
#     rows 0-4,095, rank 1 rows 4,096-8,191. The prompt's length does not
#     divide the data axis, so every rank runs it whole (a prompt that
#     divides runs split along the sequence: parallel_gloo_seq).
# The whole model runs first and is freed before the split one is drawn.
LONG_LAYERS = 6
LONG_ROWS = 524_288
LONG_POS0 = (524_280, 262_142)
LONG_TICKS = 4
LONG_BLOCK = 8_192                  # rows of the cache a seed draws
LONG_PREFILL = (8_192, 6_143, 3)    # max_seq, prompt, ticks
LONG_TIMEOUT_S = 300
LONG_CACHE_TOL = {"float32": 1e-5, "bfloat16": 1e-2}   # of the rows' largest
LONG_KV = ("attn_k", "attn_v")
# The shared block's attention output at each tick (the combine's result)
# against the whole model's, as a share of the whole model's largest: the
# logits check alone may not see it (over 524,288 unit-normal keys a row is
# ~1e-3). bf16: the P rounding of two kernels over different blocks and one
# rounding of each output, ~4e-3; fp32: the same sums in another order.
LONG_ATTN_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# A planted fault the check must catch, where the recorded partials make it
# change the row: a rank's partial dropped, where that rank's weight in the
# row (averaged over the heads) is at least LONG_FAULT_SHARE; both ranks
# weighted equally, where a weight lies that far from 1/2.
LONG_FAULT_SHARE = 0.1
LONG_SEEDS = (1_000, 2_000_000)     # the blocks' first seeds, K and V


def _long_config():
    return dataclasses.replace(get_config(ZAMBA_ARCH), num_layers=LONG_LAYERS)


def _seeded_rows(t: torch.Tensor, first: int, upto: int, seed: int) -> None:
    """Fill ``t`` (groups, 1, rows, heads, d), this rank's rows ``first ..
    first + rows`` of a cache, with the seeded draw of every global row
    below ``upto``: block i of LONG_BLOCK rows is drawn from seed ``seed +
    i`` whole, in fp32, so that each rank draws the same rows as the whole
    cache holds, and no more than a block beside its piece."""
    rows = t.shape[2]
    for i in range(first // LONG_BLOCK, -(-min(first + rows, upto)
                                          // LONG_BLOCK)):
        gen = torch.Generator(device=DEVICE).manual_seed(seed + i)
        block = torch.randn(t.shape[:2] + (LONG_BLOCK,) + t.shape[3:],
                            generator=gen, device=DEVICE)
        lo, hi = i * LONG_BLOCK, min((i + 1) * LONG_BLOCK, upto)
        a, z = max(lo, first), min(hi, first + rows)
        if a < z:
            t[:, :, a - first:z - first] = block[:, :, a - lo:z - lo].to(
                t.dtype)


def _seed_states(cache: dict, pos0: int) -> None:
    """The SSM and conv states drawn from a seed (small, whole on every
    rank) and the clock at ``pos0``."""
    gen = torch.Generator(device=DEVICE).manual_seed(77)
    for name, scale in (("conv", 1.0), ("ssm", 0.1)):
        t = cache[name]
        t.copy_((scale * torch.randn(t.shape, generator=gen,
                                     device=DEVICE)).to(t.dtype))
    cache["pos"].fill_(pos0)


class _Recorded:
    """While the region runs, ``module.name`` (a function the port calls by
    its module's name) is wrapped: ``keep(args, result)`` of each call is
    appended to ``calls`` where it is not None."""

    def __init__(self, module, name: str, keep):
        self.module, self.name, self.keep = module, name, keep
        self.calls = []

    def __enter__(self):
        self.fn = fn = getattr(self.module, self.name)

        def wrapped(*args, **kwargs):
            result = fn(*args, **kwargs)
            kept = self.keep(args, result)
            if kept is not None:
                self.calls.append(kept)
            return result

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def _decode_attention(args, result):
    """A decode tick's attention output, (b, h, d) in fp32 on the host."""
    return result[:, 0].float().cpu() if args[0].shape[1] == 1 else None


def _combined(args, result):
    """A combine's partials and its result, each row's one query: (n, b, h,
    d) outputs, (n, b, h) log-sum-exps and the (b, h, d) rows."""
    outs, lses = args[0], args[1]
    return (outs[..., 0, :].float().cpu(), lses[..., 0].float().cpu(),
            result[:, :, 0].float().cpu())


def _combine_check(split: list, whole: list) -> list:
    """Each tick's combined attention output against the whole model's,
    as a share of the whole model's largest, beside the same for the
    planted faults (a rank's partial dropped, both weighted equally) and
    each rank's weight in the row (averaged over the heads)."""
    out = []
    for (outs, lses, got), want in zip(split, whole):
        scale = max(want.abs().max().item(), 1e-30)
        err = lambda x: (x - want).abs().max().item() / scale
        share = torch.softmax(torch.where(lses == math.inf, -math.inf, lses),
                              dim=0).nan_to_num(0.0).mean(dim=(1, 2))
        n = outs.shape[0]
        dropped = [err(tensor_module.combine_partials(
            outs[[i for i in range(n) if i != j]],
            lses[[i for i in range(n) if i != j]], torch.float32))
            for j in range(n)]
        out.append({"err": err(got), "share": share.tolist(),
                    "dropped_err": dropped, "equal_err": err(outs.mean(0)),
                    "scale": scale})
    return out


def _split_names(cache: dict) -> list:
    """The caches a sharded cache holds a block of the sequence of."""
    split = cache.get(SEQ_SPLIT)
    return [] if split is None else list(split.names)


def _long_cache(model, cfg, mesh, rows: int, dtype, pos0: int) -> dict:
    """A cache of ``rows`` rows: the whole one (``mesh`` None) or this
    rank's pieces as ``cache_shardings`` lays them out, with ``SEQ_SPLIT``;
    rows below ``pos0`` and the states drawn from their seeds."""
    if mesh is None:
        cache = model.init_cache(1, rows, dtype)
        first = 0
    else:
        whole = abstract_model(cfg, dtype).init_cache(1, rows, dtype)
        specs = cache_shardings(cfg, mesh, whole)
        cache = {n: torch.zeros(shard_shape(Placement(specs[n], t.shape),
                                            mesh) if n != "pos" else t.shape,
                                dtype=t.dtype, device=DEVICE)
                 for n, t in whole.items()}
        cache.update(split_caches(mesh, specs))
        first = (mesh.get_local_rank("data") * cache["attn_k"].shape[2]
                 if "attn_k" in _split_names(cache) else 0)
    for name, seed in zip(LONG_KV, LONG_SEEDS):
        _seeded_rows(cache[name], first, pos0, seed)
    if pos0:
        _seed_states(cache, pos0)
    return cache


def _long_calls(model, cache, first_token, feed, prompt=None) -> tuple:
    """A prefill of ``prompt`` (or none) and ticks: the first fed
    ``first_token`` (decode cases), the others ``feed`` or the model's own
    picks; each call's last logits (fp32, on the host), its ms and the
    picks."""
    logits, ms, picks = [], [], []

    def timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)[0][:, -1].float()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(out)
        return out

    ticks = LONG_TICKS
    if prompt is not None:
        timed(model.prefill, prompt, cache)
        ticks = LONG_PREFILL[2]
    for t in range(ticks):
        if t == 0 and prompt is None:
            tok = first_token
        else:
            tok = (feed[len(picks)] if feed is not None
                   else logits[-1].argmax(-1, keepdim=True))
        picks.append(tok)
        timed(model.decode_step, cache, tok)
    return [x.cpu() for x in logits], ms, picks


def _gloo_long_rank(rank: int, directory: str) -> None:
    """One of two processes on the one card over gloo with CUDA tensors:
    zamba2 at 6 layers on a (2 data, 1 model) mesh at B 1, the whole model
    and then the split one on each case, bf16 and then fp32. Writes its
    results as JSON to ``directory``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{directory}/store",
                            rank=rank, world_size=2)
    mesh = build_mesh((2, 1), ("data", "model"))
    cfg = _long_config()
    plan = plan_memory(cfg, tp=1, dp=1)
    make = lambda dtype: get_model(cfg)(
        cfg, dtype=dtype, device=DEVICE,
        generator=torch.Generator(device=DEVICE).manual_seed(1))
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    first_token = torch.randint(0, cfg.vocab_size, (1, 1), device=DEVICE,
                                generator=gen)
    max_seq, prompt_len, _ = LONG_PREFILL
    prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len), device=DEVICE,
                           generator=gen)
    cases = [(f"decode pos0={p}", LONG_ROWS, p) for p in LONG_POS0]
    cases.append((f"prefill {prompt_len} of {max_seq}", max_seq, 0))
    out = {"cases": {}, "launches": None, "peak_bytes": {}}
    feed, whole_logits = {}, {}
    launches = dict.fromkeys(_kernel_counts(), 0)
    for dtype in (torch.bfloat16, torch.float32):
        dn = dtype_name(dtype)
        torch.cuda.reset_peak_memory_stats()
        # the whole model on every case, then freed
        ref = make(dtype)
        want = {}
        with torch.no_grad():
            for name, rows, pos0 in cases:
                cache = _long_cache(ref, cfg, None, rows, dtype, pos0)
                with _Recorded(model_common, "attention",
                               _decode_attention) as attn:
                    logits, ms, picks = _long_calls(
                        ref, cache, first_token, feed.get(name),
                        prompt if pos0 == 0 else None)
                feed.setdefault(name, picks)
                # the rows the calls wrote: the ticks', or the whole cache
                lo, hi = (pos0, pos0 + LONG_TICKS) if pos0 else (0, rows)
                want[name] = {"logits": logits, "ms": ms, "written": (lo, hi),
                              "attn": attn.calls,
                              "rows": {n: cache[n][:, :, lo:hi].float().cpu()
                                       for n in LONG_KV},
                              "states": {n: cache[n].float().cpu()
                                         for n in ("conv", "ssm")}}
                del cache
                torch.cuda.empty_cache()
        whole_logits[dn] = {n: w["logits"] for n, w in want.items()}
        del ref
        torch.cuda.empty_cache()
        out["peak_bytes"][dn + " whole"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        model = make(dtype)
        shard_model(cfg, plan, model, mesh, batch_rows=1)
        with torch.no_grad():
            for name, rows, pos0 in cases:
                cache = _long_cache(model, cfg, mesh, rows, dtype, pos0)
                first = mesh.get_local_rank("data") * cache["attn_k"].shape[2]
                _zero_kernel_counts()
                with _KernelCalls() as calls, _Recorded(
                        tensor_module, "combine_partials", _combined) as comb:
                    logits, ms, picks = _long_calls(
                        model, cache, first_token, feed[name],
                        prompt if pos0 == 0 else None)
                for k, n in _kernel_counts().items():
                    launches[k] += n
                w = want[name]
                # the written rows this rank holds against the whole
                # model's; every other row of its piece as drawn (or zero)
                held = cache["attn_k"].shape[2]
                lo, hi = w["written"]
                a, z = max(lo, first), min(hi, first + held)
                row_err, untouched = {}, True
                for n, seed in zip(LONG_KV, LONG_SEEDS):
                    if a < z:
                        got = cache[n][:, :, a - first:z - first].float().cpu()
                        ref_rows = w["rows"][n][:, :, a - lo:z - lo]
                        row_err[n] = ((got - ref_rows).abs().max().item()
                                      / max(ref_rows.abs().max().item(),
                                            1e-30))
                    check = torch.zeros_like(cache[n])
                    _seeded_rows(check, first, pos0, seed)
                    if a < z:
                        check[:, :, a - first:z - first] = \
                            cache[n][:, :, a - first:z - first]
                    untouched &= bool(torch.equal(check, cache[n]))
                    del check
                state_err = {n: (cache[n].float().cpu() - w["states"][n])
                             .abs().max().item() / max(w["states"][n].abs()
                                                       .max().item(), 1e-30)
                             for n in ("conv", "ssm")}
                calls_out = _compare_calls(logits, w["logits"])
                out["cases"].setdefault(name, {})[dn] = {
                    "calls": calls_out, "ms": ms, "whole_ms": w["ms"],
                    "digest": [hashlib.sha256(x.numpy().tobytes()).hexdigest()
                               for x in logits],
                    "row_err": row_err, "state_err": state_err,
                    "untouched_rows_equal": untouched,
                    "attn": _combine_check(comb.calls, w["attn"]),
                    "kernel_calls": calls.calls,
                    "local_shapes": {n: list(t.shape) for n, t in cache.items()
                                     if n != SEQ_SPLIT},
                    "split": _split_names(cache)}
                del cache
                torch.cuda.empty_cache()
        out["peak_bytes"][dn + " split"] = torch.cuda.max_memory_allocated()
        del model
        torch.cuda.empty_cache()
    for name in out["cases"]:
        for call, w16, w32 in zip(out["cases"][name]["bfloat16"]["calls"],
                                  whole_logits["bfloat16"][name],
                                  whole_logits["float32"][name]):
            call["whole_bf16_vs_fp32"] = (w16 - w32).abs().max().item()
    out["launches"] = launches
    with open(os.path.join(directory, f"rank_{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _expected_long_launches(cfg) -> dict:
    """The split runs' launches on one rank, both types: each decode tick's
    shared-block attention takes the partial route, the prefill's the
    serving route over the prompt; the norms and scans as the serve
    phase's."""
    ticks = len(LONG_POS0) * LONG_TICKS + LONG_PREFILL[2]
    served = _expected_launches(cfg, 1, ticks)
    groups = cfg.num_layers // cfg.hybrid.attn_every
    return {"flash_attention": 2 * groups,
            "flash_attention_partial": 2 * groups * ticks,
            "rmsnorm": 2 * served["rmsnorm"],
            "ssd_scan": 2 * served["ssd_scan"]}


def _long_attention_problems(tag: str, ticks: list, tol: float, n: int,
                             faults: bool) -> list:
    """``_combine_check``'s ticks: ``n`` of them, each within ``tol``; with
    ``faults``, each planted fault that would change the row beyond
    LONG_FAULT_SHARE caught by the same check (a drop of a rank that weighs
    that much, equal weights where a rank's weight lies that far from
    1/2)."""
    problems = [] if len(ticks) == n else [
        f"{tag}: {len(ticks)} combines recorded, not {n}"]
    for t, c in enumerate(ticks):
        if not c["err"] <= tol:
            problems.append(f"{tag}: tick {t} attention off the whole "
                            f"model's by {c['err']} of its largest")
        if not faults:
            continue
        for j, (w, e) in enumerate(zip(c["share"], c["dropped_err"])):
            if w >= LONG_FAULT_SHARE and not e > tol:
                problems.append(f"{tag}: tick {t} rank {j}'s partial "
                                f"(weight {w}) dropped passes at {e}")
        if (max(abs(w - 1 / len(c["share"])) for w in c["share"])
                >= LONG_FAULT_SHARE and not c["equal_err"] > tol):
            problems.append(f"{tag}: tick {t} equal weights pass at "
                            f"{c['equal_err']}")
    return problems


def _long_rank_problems(rank: int, r: dict, cfg) -> list:
    """What one rank's results break: fp32 logits within LOGIT_TOL of the
    whole model's, bf16 within twice the whole bf16 model's distance from
    fp32, no pick off but at a tie, the shared block's attention output at
    every tick within LONG_ATTN_TOL of the whole model's (and, on the
    seeded caches, the planted faults outside it), the rank's rows and the
    states equal the whole model's, the seeded rows untouched, the launches
    and the kernels by shape."""
    problems = []
    half = LONG_ROWS // 2
    heads, d = cfg.num_heads, cfg.resolved_head_dim
    for name, by_dtype in r["cases"].items():
        for dn, c in by_dtype.items():
            tag = f"rank {rank} {name} {dn}"
            problems += _serving_problems(tag, {"serve": {dn: c}})
            for n, err in {**c["row_err"], **c["state_err"]}.items():
                if not err <= LONG_CACHE_TOL[dn]:
                    problems.append(f"{tag}: {n} off the whole model's by "
                                    f"{err} of its largest")
            if not c["untouched_rows_equal"]:
                problems.append(f"{tag}: rows the ticks did not write moved")
            problems += _long_attention_problems(
                tag, c["attn"], LONG_ATTN_TOL[dn],
                LONG_TICKS if name.startswith("decode") else LONG_PREFILL[2],
                faults=name.startswith("decode"))
            if set(c["split"]) != {"attn_k", "attn_v"}:
                problems.append(f"{tag}: split caches {c['split']}")
            rows = c["local_shapes"]["attn_k"][2]
            if name.startswith("decode"):
                key = (f"flash_attention_partial [1, {heads}, 1, {d}] "
                       f"skv {half}")
                if rows != half or c["kernel_calls"].get(key) != LONG_TICKS:
                    problems.append(f"{tag}: no {LONG_TICKS} x {key} on "
                                    f"{rows} rows: {c['kernel_calls']}")
            else:
                scan = (f"ssd_scan [1, {LONG_PREFILL[1]}, {cfg.ssm_heads}, "
                        f"{cfg.ssm.head_dim}]")
                if c["kernel_calls"].get(scan) != cfg.num_layers:
                    problems.append(f"{tag}: no {cfg.num_layers} x {scan}")
            if not any(k.startswith("rmsnorm ") for k in c["kernel_calls"]):
                problems.append(f"{tag}: no RMSNorm launch")
    want = _expected_long_launches(cfg)
    for k, n in want.items():
        if r["launches"][k] != n:
            problems.append(f"rank {rank}: {k} launched "
                            f"{r['launches'][k]} times, not {n}")
    return problems


def phase_parallel_gloo_long() -> dict:
    """Two processes on the card over gloo with CUDA tensors: zamba2 served
    at B 1 with its shared block's cache split along the sequence over the
    data axis (``_gloo_long_rank``), which must pass on both ranks; the two
    data ranks' logits bitwise equal at every call. Returns the kernels'
    launches on this path, both ranks' split runs summed."""
    t0 = time.perf_counter()
    ranks = _gloo_pair(_gloo_long_rank, "parallel_gloo_long", LONG_TIMEOUT_S)
    cfg = _long_config()
    problems, launches = [], {}
    for rank, r in enumerate(ranks):
        problems += _long_rank_problems(rank, r, cfg)
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    for name, by_dtype in ranks[0]["cases"].items():
        for dn, c in by_dtype.items():
            if c["digest"] != ranks[1]["cases"][name][dn]["digest"]:
                problems.append(f"{name} {dn}: the data ranks' logits "
                                "differ")
    kv = 2 * LONG_ROWS * cfg.num_kv_heads * cfg.resolved_head_dim
    emit("parallel_gloo_long", card=_smi("name,power.limit"),
         mesh=[2, 1], layers=LONG_LAYERS, params=cfg.param_count(),
         cache_rows=LONG_ROWS, pos0=LONG_POS0, ticks=LONG_TICKS,
         prefill={"max_seq": LONG_PREFILL[0], "prompt": LONG_PREFILL[1],
                  "ticks": LONG_PREFILL[2]},
         cache_bytes={"bfloat16": 2 * kv, "float32": 4 * kv},
         left_out=f"{ZAMBA_ARCH}'s 54 layers cut to {LONG_LAYERS} (the "
                  "shared block once, as at every 6th layer); the "
                  "524,288-token prefill (the cache's rows and the states "
                  "drawn from seeds instead); the sharded train step and "
                  "prefill split along the sequence (ROADMAP item 13's "
                  "second half)",
         ranks=ranks, launches=launches,
         seconds=time.perf_counter() - t0, problems=problems)
    if problems:
        raise SystemExit(f"chip_smoke: parallel_gloo_long phase failed: "
                         f"{problems}")
    return launches


# ------------------------------------------------------------------------- #
# The kernels' line
# ------------------------------------------------------------------------- #

# The sequence split over the data ranks (ROADMAP item 13's second half) on
# two processes over gloo at (2 data, 1 model), full width: zamba2-2.7b at
# 6 of its 54 layers (the shared block once) and smollm-135m at 6 of its 30
# (cut from full depth to keep the script within its time limit), each one
# fp32 step of one row of 4,096 tokens (2,048 a rank) against
# make_train_step in one process under parallel_gloo_ssm's checks; then
# zamba2's prefill of one row of prefill_32k's 32,768 tokens (16,384 a
# rank) into a cache split along its sequence and 3 greedy ticks, bf16 and
# fp32, against the whole model.
SEQ_PAR_LAYERS = {ZAMBA_ARCH: 6, LM_ARCH: 6}        # None: every layer
SEQ_PAR_BATCH, SEQ_PAR_SEQ = 1, 4096
SEQ_PREFILL = 32_768
# The split prefill's caches against the whole model's, of their largest.
# A rank's projections run on its block of the rows, where cuBLAS may pick
# other kernels than for the whole prompt, so fp32 is not bit for bit:
# 6.8e-5 of the largest at a split 6,144-token prompt of parallel_gloo_long's
# zamba2 on the card. The phase prints the whole model against itself, its
# prefill of the prompt's first half against the whole prompt's rows
# there (``whole_half_err``), beside it. bf16: LONG_CACHE_TOL's; a MoE's
# bf16 caches twice the whole bf16 model's distance from the whole fp32
# one's where that is larger, the logits' rule (``_serving_problems``): in
# bf16 its top-k expert choices and capacity picks move with the rounding
# (granite's gates 0.12 apart between the split and the whole model, 212
# pairs picked otherwise, on an H100), in fp32 none do.
SEQ_CACHE_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
SEQ_TIMEOUT_S = 300


def _expected_seq_launches(cfg, remat: str) -> dict:
    """Each kernel's launches in one split step: the one process's (the
    training entry point's reckoning), every scan twice (``models.mamba.
    split_ssd_scan``: the block from zero for its final state, then from
    its incoming state), attention and RMSNorm as many (the encdec's
    encoder runs whole on every rank)."""
    if cfg.family in ("dense", "moe"):
        return _expected_lm_launches(cfg, remat, 1)
    if cfg.family == "encdec":
        return _expected_encdec_launches(cfg, 0, 0, steps=1, remat=remat)
    out = _expected_mamba_launches(cfg, remat, 1)
    out["ssd_scan"] *= 2
    out["ssd_scan_backward"] *= 2
    return out


def _seq_prefill(cfg, mesh, prompt: int, inputs=None) -> dict:
    """A prefill of one row of ``prompt`` tokens split along its sequence
    over the data ranks (``shard_model``'s ``batch_rows`` of 1: every rank
    runs its block of the prompt, into a cache split along its sequence;
    the VLM's ``inputs``, its patches, ahead of the prompt in rank 0's
    block) and SSM_SERVE_TICKS greedy ticks, bf16 and then fp32, against
    the whole model from the same seed, every run fed the first bf16 run's
    picks: the whole model's, or for a MoE the split's, which runs first
    so that the whole model's prefill follows its routing decisions
    (``_FollowedRouting``). Per type: each call's logits against the whole
    model's (``_compare_calls``), whether both ranks' prefill logits are
    the same bits, the caches after the prefill gathered whole against the
    whole model's (the K/V rows of the prompt, the SSM states and the conv
    tails: the largest error over the whole's largest), both prefills' ms
    by the host clock, the kernels the split calls launched by shape."""
    inputs = inputs or {}
    prefix = inputs["patches"].shape[1] if "patches" in inputs else 0
    # Serving holds no optimizer state: the parameters whole on every data
    # rank. Under a ZeRO-3 plan (internvl2's) each call would gather them
    # over the data axis through gloo's host memory: 17.6 s a fp32 prefill
    # of internvl2's 2 layers on an H100, 84.6 s for its prefills and ticks
    # of both types.
    plan = dataclasses.replace(plan_memory(cfg, tp=1, dp=1), zero_stage=1)
    tokens = torch.randint(0, cfg.vocab_size, (1, prompt), device=DEVICE,
                           generator=torch.Generator(
                               device=DEVICE).manual_seed(2))
    make = lambda dtype: get_model(cfg)(
        cfg, dtype=dtype, device=DEVICE,
        generator=torch.Generator(device=DEVICE).manual_seed(1))
    rows = prefix + prompt + SSM_SERVE_TICKS + 1
    is_kv = lambda n: n in ("k", "v") or n.startswith("attn")
    half = prompt // 2
    launches = dict.fromkeys(_kernel_counts(), 0)
    routed = lambda follow, how: (getattr(follow, how)() if follow
                                  else contextlib.nullcontext())

    def prefill(model, cache):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = model.prefill(tokens, cache, **inputs)[0][:, -1].float()
        torch.cuda.synchronize()
        return logits, (time.perf_counter() - t0) * 1e3

    def ticks(model, cache, first, feed):
        out, picks = [first], []
        for t in range(SSM_SERVE_TICKS):
            picks.append(out[-1].argmax(-1, keepdim=True) if feed is None
                         else feed[t])
            out.append(model.decode_step(cache, picks[-1])[0][:, -1].float())
        return out, picks

    def run_whole(dtype, feed, follow=None) -> dict:
        """The whole model's prefill (following ``follow``) and ticks, its
        caches after the prefill, and its first half's rows alone against
        them (the whole model against itself)."""
        ref = make(dtype)
        cache = ref.init_cache(1, rows)
        kept = [n for n in cache if n != "pos"]
        with torch.no_grad():
            with routed(follow, "following"):
                first, ms = prefill(ref, cache)
            want = {n: cache[n][:, :, :prefix + prompt].clone()
                    if is_kv(n) else cache[n].clone() for n in kept}
            logits, picks = ticks(ref, cache, first, feed)
            del cache
            upto = prefix + half
            cache = ref.init_cache(1, upto)
            ref.prefill(tokens[:, :half], cache, **inputs)
            half_err = {
                n: ((cache[n][:, :, :upto].float()
                     - want[n][:, :, :upto].float()).abs().max()
                    / max(want[n].float().abs().max().item(), 1e-30)
                    ).item() for n in kept if is_kv(n)}
        del ref, cache
        torch.cuda.empty_cache()
        return {"logits": logits, "picks": picks, "cache": want, "ms": ms,
                "half_err": half_err}

    def run_split(dtype, feed, follow=None) -> dict:
        """The split prefill (recorded for ``follow``) and ticks, its
        caches after the prefill gathered whole."""
        model = make(dtype)
        whole = model.init_cache(1, rows)
        kept = [n for n in whole if n != "pos"]
        shard_model(cfg, plan, model, mesh, batch_rows=1)
        specs = cache_shardings(cfg, mesh, whole)
        cache = shard_cache(cfg, mesh, whole)
        del whole
        torch.cuda.empty_cache()
        with torch.no_grad():
            dist.barrier(group=mesh.get_group("data"))   # both ranks ready
            _zero_kernel_counts()
            with _KernelCalls() as calls:
                with routed(follow, "recording"):
                    first, ms = prefill(model, cache)
                # copies: a whole cache's gather is the cache itself,
                # which the ticks advance
                got = {n: gather_full(cache[n], specs[n], mesh).clone()
                       for n in kept}
                logits, picks = ticks(model, cache, first, feed)
            for name, n in _kernel_counts().items():
                launches[name] += n
        both = all_gather_stacked(logits[0].contiguous(),
                                  mesh.get_group("data"))
        shapes = {n: list(cache[n].shape) for n in kept}
        del model, cache
        torch.cuda.empty_cache()
        return {"logits": logits, "picks": picks, "cache": got, "ms": ms,
                "bitwise": bool(torch.equal(both[0], both[1])),
                "shapes": shapes, "calls": calls.calls}

    out, whole_logits, whole_kv, feed = {}, {}, {}, None
    for dtype in (torch.bfloat16, torch.float32):
        follow = _FollowedRouting() if cfg.moe is not None else None
        if follow is None:
            whole = run_whole(dtype, feed)
            feed = feed or whole["picks"]
        split = run_split(dtype, feed, follow)
        if follow is not None:
            feed = feed or split["picks"]
            whole = run_whole(dtype, feed, follow)
        want = whole["cache"]
        cache_err = {}
        for n, g in split["cache"].items():
            g = g[:, :, :prefix + prompt] if is_kv(n) else g
            cache_err[n] = ((g.float() - want[n].float()).abs().max()
                            / max(want[n].float().abs().max().item(),
                                  1e-30)).item()
        whole_logits[dtype] = whole["logits"]
        whole_kv[dtype] = {n: t for n, t in want.items() if is_kv(n)}
        out[dtype_name(dtype)] = {
            "calls": _compare_calls(split["logits"], whole["logits"]),
            "logits_bitwise_on_both_ranks": split["bitwise"],
            "cache_scaled_err": cache_err,
            "whole_half_err": whole["half_err"],
            "split_cache_shapes": split["shapes"],
            "prefill_ms": split["ms"], "whole_prefill_ms": whole["ms"],
            "kernel_calls": split["calls"],
            **({"routing": follow.report()} if follow else {})}
        del whole, split
        torch.cuda.empty_cache()
    for call, w16, w32 in zip(out["bfloat16"]["calls"],
                              whole_logits[torch.bfloat16],
                              whole_logits[torch.float32]):
        call["whole_bf16_vs_fp32"] = (w16 - w32).abs().max().item()
    # the K/V caches' yardstick as the logits': the whole bf16 model's
    # against the whole fp32 model's, of the latter's largest
    out["bfloat16"]["cache_whole_bf16_vs_fp32"] = {
        n: ((w16.float() - whole_kv[torch.float32][n]).abs().max()
            / max(whole_kv[torch.float32][n].abs().max().item(), 1e-30)
            ).item() for n, w16 in whole_kv[torch.bfloat16].items()}
    return {"serve": out, "serve_launches": launches,
            "prompt": prompt, "ticks": SSM_SERVE_TICKS}


def _gloo_seq_rank(rank: int, directory: str) -> None:
    """One of two processes on the one card over gloo with CUDA tensors, a
    (2 data, 1 model) mesh: for each of SEQ_PAR_LAYERS, ``_split_step`` of
    one row of SEQ_PAR_SEQ tokens, split along the sequence; for zamba2,
    ``_seq_prefill`` of SEQ_PREFILL tokens. Writes its results as JSON to
    ``directory``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{directory}/store",
                            rank=rank, world_size=2)
    mesh = build_mesh((2, 1), ("data", "model"))
    out = {}
    for arch, layers in SEQ_PAR_LAYERS.items():
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        batch = _par_batches(cfg, 1, SEQ_PAR_BATCH, SEQ_PAR_SEQ)[0]
        out[arch] = {"layers": cfg.num_layers,
                     **_split_step(cfg, mesh, batch, _expected_seq_launches)}
        if cfg.family == "hybrid":
            out[arch].update(_seq_prefill(cfg, mesh, SEQ_PREFILL))
    with open(os.path.join(directory, f"rank_{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _seq_rank_problems(rank: int, arch: str, r: dict) -> list:
    """What one rank's results of one model break: the step's checks
    (``_step_problems``), its kernels at the rank's block with the split's
    inputs (attention with ``q_offset`` over every row's keys, the scan
    from an initial state); the prefill's logits, caches and launches."""
    cfg = get_config(arch)
    tag, half = f"rank {rank} {arch}", SEQ_PAR_SEQ // 2
    problems = _step_problems(tag, r)
    calls = r["step_kernel_calls"]
    heads, d = cfg.num_heads, cfg.resolved_head_dim
    want = [f"flash_attention_lse [{SEQ_PAR_BATCH}, {heads}, {half}, {d}] "
            f"skv {SEQ_PAR_SEQ} q_offset",
            f"flash_attention_backward [{SEQ_PAR_BATCH}, {heads}, {half}, "
            f"{d}] skv {SEQ_PAR_SEQ} q_offset"]
    if cfg.family == "hybrid":
        scan = f"[{SEQ_PAR_BATCH}, {half}, {cfg.ssm_heads}, {cfg.ssm.head_dim}]"
        want += [f"ssd_scan_train {scan} init_state",
                 f"ssd_scan_backward {scan} init_state"]
    problems += [f"{tag}: no {w} in the step" for w in want
                 if w not in calls]
    if "serve" not in r:
        return problems
    problems += _serving_problems(tag, r)
    for dtype, run in r["serve"].items():
        if not run["logits_bitwise_on_both_ranks"]:
            problems.append(f"{tag}: {dtype} prefill logits differ between "
                            "the ranks")
        tol = SEQ_CACHE_TOL[dtype]
        for name, err in run["cache_scaled_err"].items():
            if err > tol:
                problems.append(f"{tag}: {dtype} prefill's {name} off the "
                                f"whole model's by {err} > {tol}")
        block = f"[1, {SEQ_PREFILL // 2}, {cfg.ssm_heads}, {cfg.ssm.head_dim}]"
        if f"ssd_scan {block} init_state" not in run["kernel_calls"]:
            problems.append(f"{tag}: {dtype} prefill scanned no block from "
                            "its incoming state")
    if r["serve_launches"]["ssd_scan"] != 2 * 2 * r["layers"]:
        problems.append(f"{tag}: the split prefills launched the SSD scan "
                        f"{r['serve_launches']['ssd_scan']} times")
    return problems


def phase_parallel_gloo_seq() -> dict:
    """Two processes on the card over gloo with CUDA tensors: a train step
    and a prefill with each row's sequence split over the data ranks
    (``_gloo_seq_rank``), which must pass on every rank. Returns the
    kernels' launches on this path, both ranks' steps and prefills
    summed."""
    t0 = time.perf_counter()
    ranks = _gloo_pair(_gloo_seq_rank, "parallel_gloo_seq", SEQ_TIMEOUT_S)
    problems, launches = [], {}
    for rank, result in enumerate(ranks):
        if sorted(result) != sorted(SEQ_PAR_LAYERS):
            problems.append(f"rank {rank} reported {sorted(result)}")
            continue
        for arch, r in result.items():
            problems += _seq_rank_problems(rank, arch, r)
            for part in ("step_launches", "serve_launches"):
                for name, n in r.get(part, {}).items():
                    launches[name] = launches.get(name, 0) + n
    emit("parallel_gloo_seq", card=_smi("name,power.limit"), mesh=[2, 1],
         global_batch=SEQ_PAR_BATCH, seq_len=SEQ_PAR_SEQ,
         prefill=SEQ_PREFILL, layers=SEQ_PAR_LAYERS, ranks=ranks,
         launches=launches, seconds=time.perf_counter() - t0,
         problems=problems)
    if problems:
        raise SystemExit(f"chip_smoke: parallel_gloo_seq phase failed: "
                         f"{problems}")
    return launches


# The same split for the MoE, encoder-decoder and VLM families (ROADMAP item
# 13's remainder), two processes over gloo at (2 data, 1 model), full width:
# granite-moe-3b-a800m at parallel_gloo_moe's 2 of 32 layers, one fp32 step
# of one row of 4,096 tokens (2,048 a rank, its MoE layers routing both
# blocks as one microbatch, in the reference's token order) against
# make_train_step in one process under parallel_gloo_moe's checks, then its
# prefill of one row of SEQ_FAMILY_PROMPT tokens split along the sequence,
# bf16 and fp32, against the whole model; seamless-m4t-large-v2 at 4 + 4 of
# its 24 + 24 layers, one fp32 step of one 4,096-token row over its 2,048
# source frames (source_frac 0.5), whole on both ranks; internvl2-76b at 2
# of its 80 layers, the prefill of SEQ_FAMILY_PROMPT tokens behind its 256
# patches (rank 0's block), bf16 and fp32. internvl2's split step stays off
# the card: one full-width layer's fp32 train state is 47.5 GB.
SEQ_FAMILY_PROMPT = 4096
SEQ_FAMILY_TIMEOUT_S = 400


def _seq_family_configs() -> dict:
    return {MOE_ARCH: _moe_par_config(), **_split_configs()}


def _gloo_seq_family_rank(rank: int, directory: str) -> None:
    """One of two processes on the one card over gloo with CUDA tensors, a
    (2 data, 1 model) mesh: granite's ``_split_step`` and ``_seq_prefill``,
    seamless's ``_split_step`` (its one-process steps in turn), internvl2's
    ``_seq_prefill``, and each part's seconds. Writes its results as JSON
    to ``directory``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{directory}/store",
                            rank=rank, world_size=2)
    mesh = build_mesh((2, 1), ("data", "model"))
    cfgs = _seq_family_configs()
    moe, enc, vlm = cfgs[MOE_ARCH], cfgs[ENCDEC_ARCH], cfgs[VLM_ARCH]
    t0 = time.perf_counter()
    batch = _par_batches(moe, 1, SEQ_PAR_BATCH, SEQ_PAR_SEQ)[0]
    out = {MOE_ARCH: _split_step(moe, mesh, batch, _expected_seq_launches)}
    t1 = time.perf_counter()
    out[MOE_ARCH].update(_seq_prefill(moe, mesh, SEQ_FAMILY_PROMPT))
    t2 = time.perf_counter()
    batch = _par_batches(enc, 1, SEQ_PAR_BATCH, SEQ_PAR_SEQ)[0]
    batch["frames"] = _seeded(
        (SEQ_PAR_BATCH, int(SEQ_PAR_SEQ * enc.encdec.source_frac),
         enc.d_model), 3)
    out[ENCDEC_ARCH] = _split_step(enc, mesh, batch, _expected_seq_launches,
                                   in_turn=True)
    del batch
    t3 = time.perf_counter()
    patches = _seeded((1, vlm.vision.num_patches, vlm.d_model), 5)
    out[VLM_ARCH] = _seq_prefill(vlm, mesh, SEQ_FAMILY_PROMPT,
                                 {"patches": patches})
    out["seconds"] = {"granite step": t1 - t0, "granite prefill": t2 - t1,
                      "seamless step": t3 - t2,
                      "internvl2 prefill": time.perf_counter() - t3}
    with open(os.path.join(directory, f"rank_{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _seq_family_problems(rank: int, arch: str, r: dict) -> list:
    """What one rank's results of one model break: the step's checks
    (``_step_problems``; the MoE's auxiliary loss and each layer's drops
    against one process's), its attention at the rank's block with
    ``q_offset`` over every row's keys (the encdec's encoder and
    cross-attention over the whole source); the prefill's logits (both
    ranks' bitwise), caches and its attention at the rank's block (rank
    0's behind the VLM's patches)."""
    cfg = _seq_family_configs()[arch]
    tag, half = f"rank {rank} {arch}", SEQ_PAR_SEQ // 2
    heads, d, b = cfg.num_heads, cfg.resolved_head_dim, SEQ_PAR_BATCH
    problems = []
    if "loss" in r:
        problems += _step_problems(tag, r)
        want = [f"flash_attention_lse [{b}, {heads}, {half}, {d}] "
                f"skv {SEQ_PAR_SEQ} q_offset",
                f"flash_attention_backward [{b}, {heads}, {half}, {d}] "
                f"skv {SEQ_PAR_SEQ} q_offset"]
        if cfg.family == "encdec":
            src = int(SEQ_PAR_SEQ * cfg.encdec.source_frac)
            cross = "" if src == half else f" skv {src}"
            want += [f"flash_attention_lse [{b}, {heads}, {src}, {d}]",
                     f"flash_attention_lse [{b}, {heads}, {half}, {d}]"
                     + cross]
        problems += [f"{tag}: no {w} in the step" for w in want
                     if w not in r["step_kernel_calls"]]
        if cfg.moe is not None:
            if abs(r["aux"] - r["ref_aux"]) > MOE_AUX_RTOL * abs(
                    r["ref_aux"]):
                problems.append(f"{tag}: aux {r['aux']} against "
                                f"{r['ref_aux']}")
            if r["dropped"] != r["ref_dropped"]:
                problems.append(f"{tag}: dropped {r['dropped']} against "
                                f"{r['ref_dropped']}")
    if "serve" in r:
        problems += _serving_problems(tag, r)
        prefix = cfg.vision.num_patches if cfg.family == "vlm" else 0
        rows = SEQ_FAMILY_PROMPT // 2 + (prefix if rank == 0 else 0)
        call = (f"flash_attention [1, {heads}, {rows}, {d}] "
                f"skv {prefix + SEQ_FAMILY_PROMPT}")
        for dtype, run in r["serve"].items():
            if not run["logits_bitwise_on_both_ranks"]:
                problems.append(f"{tag}: {dtype} prefill logits differ "
                                "between the ranks")
            for name, err in run["cache_scaled_err"].items():
                tol = SEQ_CACHE_TOL[dtype]
                if dtype == "bfloat16" and cfg.moe is not None:
                    tol = max(tol, 2 * run["cache_whole_bf16_vs_fp32"][name])
                if err > tol:
                    problems.append(f"{tag}: {dtype} prefill's {name} off "
                                    f"the whole model's by {err} > {tol}")
            if call not in run["kernel_calls"]:
                problems.append(f"{tag}: {dtype} prefill made no {call}")
            problems += _routing_problems(f"{tag} {dtype} prefill",
                                          run.get("routing"))
    return problems


def phase_parallel_gloo_seq_families() -> dict:
    """Two processes on the card over gloo with CUDA tensors: a train step
    and a prefill with each row's sequence split over the data ranks for
    the MoE, encdec and VLM families (``_gloo_seq_family_rank``), which
    must pass on every rank. Returns the kernels' launches on this path,
    both ranks' steps and prefills summed."""
    t0 = time.perf_counter()
    ranks = _gloo_pair(_gloo_seq_family_rank, "parallel_gloo_seq_families",
                       SEQ_FAMILY_TIMEOUT_S)
    problems, launches = [], {}
    for rank, result in enumerate(ranks):
        if sorted(result) != sorted(["seconds", *_seq_family_configs()]):
            problems.append(f"rank {rank} reported {sorted(result)}")
            continue
        for arch in _seq_family_configs():
            r = result[arch]
            problems += _seq_family_problems(rank, arch, r)
            for part in ("step_launches", "serve_launches"):
                for name, n in r.get(part, {}).items():
                    launches[name] = launches.get(name, 0) + n
    emit("parallel_gloo_seq_families", card=_smi("name,power.limit"),
         mesh=[2, 1], global_batch=SEQ_PAR_BATCH, seq_len=SEQ_PAR_SEQ,
         prefill=SEQ_FAMILY_PROMPT,
         layers={MOE_ARCH: MOE_PAR_LAYERS,
                 ENCDEC_ARCH: [SPLIT_ENCDEC_LAYERS, SPLIT_ENCDEC_LAYERS],
                 VLM_ARCH: SPLIT_VLM_LAYERS},
         left_out=f"{VLM_ARCH}'s split step (one full-width layer's fp32 "
                  f"train state is 47.5 GB); {ENCDEC_ARCH}'s split prefill "
                  "(held on the CPU, tests/test_torch_distributed_seq_"
                  "families.py)",
         ranks=ranks, launches=launches, seconds=time.perf_counter() - t0,
         problems=problems)
    if problems:
        raise SystemExit(f"chip_smoke: parallel_gloo_seq_families phase "
                         f"failed: {problems}")
    return launches


KERNELS = (
    # name, source, the TPU kernel it replaces, the main-path case it is timed at
    ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:79",
     lambda c: c.get("case") == "decode tick" and c["dtype"] == "bfloat16"),
    # the same kernels' partial route (the decode kernels writing the
    # log-sum-exp): long-context serving over a cache split along its
    # sequence, timed at zamba2's long_500k block
    ("flash_attention_partial",
     "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:79",
     lambda c: c.get("case") == "zamba2 long half"
     and c["dtype"] == "bfloat16"),
    ("rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
     "src/repro/kernels/rmsnorm.py:24",
     lambda c: c.get("shape") == [8, 1, 576] and c["dtype"] == "bfloat16"),
    ("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
     "src/repro/kernels/ssd_scan.py:80",
     lambda c: c.get("case") == "main prefill" and c["dtype"] == "bfloat16"),
    ("embedding_bag", "src/repro_torch/kernels/csrc/embedding_bag.cu",
     "src/repro/kernels/embedding_bag.py:37",
     lambda c: c.get("case") == "main" and c["dtype"] == "float32"),
    ("embedding_bag_backward", "src/repro_torch/kernels/csrc/embedding_bag.cu",
     "src/repro/kernels/embedding_bag.py:37",
     lambda c: c.get("case") == "main" and c["dtype"] == "float32"),
    # The training backwards have no Pallas counterpart (jax.grad
    # differentiates the reference): each names the forward it is the
    # gradient of.
    ("flash_attention_backward",
     "src/repro_torch/kernels/csrc/flash_attention_backward.cu",
     "src/repro/kernels/flash_attention.py:79",
     lambda c: c.get("case") == "train main" and c["dtype"] == "float32"),
    ("rmsnorm_backward", "src/repro_torch/kernels/csrc/rmsnorm.cu",
     "src/repro/kernels/rmsnorm.py:24",
     lambda c: c.get("shape") == [LM_BATCH * LM_SEQ, 576]
     and c["dtype"] == "float32"),
    ("ssd_scan_backward", "src/repro_torch/kernels/csrc/ssd_scan_backward.cu",
     "src/repro/kernels/ssd_scan.py:80",
     lambda c: c.get("case") == "train main" and c["dtype"] == "float32"),
)


# ------------------------------------------------------------------------- #
# The analytic evaluator over the transformer-1t study grid
# ------------------------------------------------------------------------- #

def _kernel_counts() -> dict:
    return {"flash_attention": ops.flash_attention.launches,
            "flash_attention_backward": ops.flash_attention.backward_launches,
            "flash_attention_partial": ops.flash_attention_partial.launches,
            "rmsnorm": ops.rmsnorm.launches,
            "rmsnorm_backward": ops.rmsnorm.backward_launches,
            "ssd_scan": ops.ssd_scan.launches,
            "ssd_scan_backward": ops.ssd_scan.backward_launches,
            "embedding_bag": ops.embedding_bag.launches,
            "embedding_bag_backward": ops.embedding_bag.backward_launches}


def _zero_kernel_counts() -> None:
    for wrapper in (ops.flash_attention, ops.flash_attention_partial,
                    ops.rmsnorm, ops.ssd_scan, ops.embedding_bag):
        wrapper.launches = 0
        if hasattr(wrapper, "backward_launches"):
            wrapper.backward_launches = 0


def _study_envs(steps: int) -> list:
    """The grid of benchmarks/run.py's _jax_grid_trajectory: the DGX-A100
    baseline's node and topology with peak_flops, local_bw and intra_bw each
    scaled by 0.5 + (4 / steps) i, i = 0..steps - 1."""
    base = BASELINE_DGX_A100
    step = 4.0 / steps

    def env(i, j, k):
        node = dataclasses.replace(
            base.node, peak_flops=base.node.peak_flops * (0.5 + step * i),
            local_bw=base.node.local_bw * (0.5 + step * j))
        topo = dataclasses.replace(
            base.topology, intra_bw=base.topology.intra_bw * (0.5 + step * k))
        return node, topo

    r = range(steps)
    return [env(i, j, k) for i in r for j in r for k in r]


def _cells(breakdowns) -> np.ndarray:
    """Every field of every cell as one float64 row: the breakdown, the
    memory bandwidth, the bubble, feasibility and the footprint report."""
    return np.array([[b.fp.compute, b.fp.exposed_comm,
                      b.ig.compute, b.ig.exposed_comm, b.wg.compute,
                      b.wg.exposed_comm, b.optimizer, b.total, b.mem_bw,
                      b.bubble_fraction, b.feasible,
                      b.footprint.model_states,
                      b.footprint.activation_working, b.footprint.total,
                      b.footprint.fits_local, b.footprint.fits_total]
                     for b in breakdowns], dtype=np.float64)


def _agreement(got: np.ndarray, want: np.ndarray) -> dict:
    """Cells outside ``|got - want| <= max(rel |want|, abs)`` and the
    largest relative difference."""
    diff = np.abs(got - want)
    bad = ~(diff <= np.maximum(STUDY_REL * np.abs(want), STUDY_ABS))
    rel = diff / np.maximum(np.maximum(np.abs(got), np.abs(want)), 1e-300)
    return {"cells_outside": int(bad.any(axis=1).sum()),
            "max_rel_diff": float(rel.max())}


def _timed_call(fn) -> tuple:
    """``fn()``'s result and its host-clock ms, and the ms spent inside
    ``torch_engine.comm_matrix`` and ``torch_engine.stage_compute_exposed``
    during it (the simulator reaches both through the module, so they are
    wrapped there for the call)."""
    spent = {"comm_matrix": 0.0, "stage_compute_exposed": 0.0}
    originals = {name: getattr(torch_engine, name) for name in spent}

    def clocked(name):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return originals[name](*args, **kwargs)
            finally:
                spent[name] += (time.perf_counter() - t0) * 1e3
        return call

    try:
        for name in spent:
            setattr(torch_engine, name, clocked(name))
        t0 = time.perf_counter()
        out = fn()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        for name, f in originals.items():
            setattr(torch_engine, name, f)
    return out, wall, spent


def _median_call(fn) -> tuple:
    """``STUDY_REPS`` timed calls of ``fn``: the last result, and the
    median call's wall ms and split."""
    runs = [_timed_call(fn) for _ in range(STUDY_REPS)]
    out = runs[-1][0]
    runs.sort(key=lambda r: r[1])
    _, wall, spent = runs[len(runs) // 2]
    return out, wall, spent


def _profiled(fn, units: int = 1) -> dict:
    """torch.profiler's device time and launches of ``units`` calls of
    ``fn``, per call. A trace with no device time is taken again, as
    ``trace_ms`` does, up to ``TRACE_TRIES`` times; where every trace lost
    its events, CUDA events time the calls instead (``timer``): their span
    holds the gaps between launches too, so the launches and the device's
    busy share are not measured then (``_idle_share``)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    for tries in range(1, TRACE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(units):
                fn()
            torch.cuda.synchronize()
        device_us, launches, by_name = _device_time(prof, units, "call")
        if device_us:
            return {"device_ms": device_us / 1e3 / units,
                    "launches": launches / units,
                    "top_device_time": by_name[:6], "timer": "torch.profiler"}
        if tries < TRACE_TRIES:
            time.sleep(TRACE_PAUSE_S * tries)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(units):
        fn()
    end.record()
    end.synchronize()
    return {"device_ms": start.elapsed_time(end) / units,
            "launches": "not measured", "top_device_time": [],
            "timer": f"CUDA events (torch.profiler reported no device time "
                     f"in {TRACE_TRIES} traces)"}


def _idle_share(prof: dict, wall_ms: float):
    """The device's idle share of a call that took ``wall_ms`` on the
    host, from ``_profiled``'s trace; not measured where it fell back to
    CUDA events."""
    if prof["timer"] != "torch.profiler":
        return "not measured"
    return 1.0 - prof["device_ms"] / wall_ms


def _stage_args(cw, s: int, envs, device) -> tuple:
    """The arguments time_compiled gives stage ``s``'s
    stage_compute_exposed (memory bandwidth from the stage's footprint)."""
    from repro_torch.core.memory import per_node_footprint, stage_footprints
    from repro_torch.core.simulator import _compiled_mem_bws
    wl = cw.workload
    total = (stage_footprints(wl, None, 2)[s].total if wl.pp > 1
             else per_node_footprint(wl, None, 2).total)
    nodes = [n for n, _ in envs]
    return (cw.stages[s], envs, nodes,
            _compiled_mem_bws(nodes, total, None), wl.mp, wl.dp, wl.pp,
            wl.ep, None, device)


def _walk_against_closed_form(cw, envs) -> dict:
    """One full-size stage through both stage kernels on the card: the
    event walk (_stage_fn_scan) against the closed form (_stage_fn_fast)."""
    stage, envs, nodes, mem_bw, mp, dp, pp, ep, _, _ = _stage_args(
        cw, 0, envs, DEVICE)
    T, fast = torch_engine._device_prep(stage, torch.device(DEVICE))
    f64 = dict(dtype=torch.float64, device=DEVICE)
    args = (T, torch.tensor([max(int(n.sram_bytes), 1) for n in nodes], **f64),
            torch.tensor([n.peak_flops for n in nodes], **f64),
            torch.as_tensor(mem_bw, **f64),
            torch.as_tensor(torch_engine.comm_matrix(stage, envs, mp, dp, pp,
                                                     ep, None), **f64))
    out = {}
    for name, fn in (("closed_form", torch_engine._stage_fn_fast),
                     ("walk", torch_engine._stage_fn_scan)):
        result = [t.cpu().numpy() for t in fn(*args)]
        t0 = time.perf_counter()
        fn(*args)[1].cpu()
        out[name] = {"wall_ms": (time.perf_counter() - t0) * 1e3,
                     **_profiled(lambda: fn(*args)[1].cpu()),
                     "result": result}
    fast_c, fast_e = out["closed_form"].pop("result")
    walk_c, walk_e = out["walk"].pop("result")
    agree = _agreement(np.concatenate([walk_c, walk_e]),
                       np.concatenate([fast_c, fast_e]))
    events = len(T["fwd"]["comm"]) + len(T["bwd"]["comm"])
    return {"stage": [cw.workload.mp, cw.workload.dp, 0], "envs": len(envs),
            "events": events, "eligible_for_closed_form": fast,
            **out, **agree}


def phase_study() -> dict:
    """COMET's batch evaluator over the transformer-1t study grid (see the
    module docstring). Returns the hand-written kernels' launches in it."""
    cfg = get_config(STUDY_ARCH)
    envs = _study_envs(STUDY_STEPS)
    problems, rows, card_runs = [], [], {}
    _zero_kernel_counts()
    for mp, dp, pp in STUDY_STRATEGIES:
        cw = decompose(cfg, STUDY_SHAPE, mp=mp, dp=dp, pp=pp).compiled()

        def on(device):
            return time_compiled(cw, envs, device=device)

        on(DEVICE)                        # the lowering's prep and copies
        card, card_ms, split = _median_call(lambda: on(DEVICE))
        again = on(DEVICE)
        cpu, cpu_ms, cpu_split = _median_call(lambda: on("cpu"))
        got, want, rep = _cells(card), _cells(cpu), _cells(again)
        agree = _agreement(got, want)
        bitwise = bool(np.array_equal(got, rep))
        finite = bool(np.isfinite(got).all())
        prof = _profiled(lambda: [torch_engine.stage_compute_exposed(
            *_stage_args(cw, s, envs, DEVICE)) for s in range(len(cw.stages))])
        device_call_ms = split["stage_compute_exposed"] - split["comm_matrix"]
        row = {"strategy": {"mp": mp, "dp": dp, "pp": pp},
               "stages": len(cw.stages), "cells": len(card),
               "path": sorted({"closed form" if torch_engine._prep(st)[1]
                               else "walk" for st in cw.stages}),
               "card_ms": card_ms, "cpu_ms": cpu_ms,
               "card_split_ms": {
                   "comm_matrix": split["comm_matrix"],
                   "device_call": device_call_ms,
                   "assembly": card_ms - split["stage_compute_exposed"]},
               "cpu_split_ms": {
                   "comm_matrix": cpu_split["comm_matrix"],
                   "device_call": cpu_split["stage_compute_exposed"]
                   - cpu_split["comm_matrix"],
                   "assembly": cpu_ms - cpu_split["stage_compute_exposed"]},
               "stage_compute_exposed": prof,
               "device_idle_share": _idle_share(prof, card_ms),
               "cuda_vs_cpu": agree, "two_card_calls_bitwise": bitwise,
               "finite": finite,
               "total_s": {"min": float(got[:, 7].min()),
                           "max": float(got[:, 7].max())}}
        emit("study", **row)
        rows.append(row)
        card_runs[(mp, dp, pp)] = cw
        if agree["cells_outside"] or not bitwise or not finite \
                or len(card) != len(envs):
            problems.append({"strategy": [mp, dp, pp], **agree,
                             "bitwise": bitwise, "finite": finite})
    launches = _kernel_counts()
    cw = card_runs[STUDY_STRATEGIES[0]]
    scaling = []
    for steps in (STUDY_STEPS, STUDY_BIG_STEPS):
        grid = _study_envs(steps)
        for device in (DEVICE, "cpu"):
            torch_engine.stage_compute_exposed(*_stage_args(cw, 0, grid,
                                                            device))
        entry = {"envs": len(grid)}
        for device in (DEVICE, "cpu"):
            _, ms, split = _median_call(
                lambda: torch_engine.stage_compute_exposed(
                    *_stage_args(cw, 0, grid, device)))
            entry[device] = {"wall_ms": ms,
                             "comm_matrix_ms": split["comm_matrix"]}
        entry[DEVICE].update(_profiled(
            lambda: torch_engine.stage_compute_exposed(
                *_stage_args(cw, 0, grid, DEVICE))))
        scaling.append(entry)
    walk = _walk_against_closed_form(cw, envs)
    if walk["cells_outside"]:
        problems.append({"walk_vs_closed_form": walk["max_rel_diff"]})
    if any(launches.values()):
        problems.append({"kernel_launches": launches})
    emit("study_summary", arch=STUDY_ARCH,
         shape=dataclasses.asdict(STUDY_SHAPE), envs=len(envs),
         grid_cells=sum(r["cells"] for r in rows if r["strategy"]["pp"] == 1),
         pipeline_cells=sum(r["cells"] for r in rows
                            if r["strategy"]["pp"] > 1),
         cells_outside=sum(r["cuda_vs_cpu"]["cells_outside"] for r in rows),
         max_rel_diff=max(r["cuda_vs_cpu"]["max_rel_diff"] for r in rows),
         tolerance={"rel": STUDY_REL, "abs": STUDY_ABS},
         stage_compute_exposed_scaling=scaling, walk=walk,
         kernel_launches=launches, problems=problems)
    if problems:
        raise SystemExit(f"chip_smoke: study phase failed: {problems}")
    return launches


# ------------------------------------------------------------------------- #
# COMET's study runner over the paper's case studies
# ------------------------------------------------------------------------- #

def _default_studies() -> list:
    """(label, spec) of the paper's case studies at their defaults."""
    cfg, dlrm = get_config(STUDY_ARCH), get_dlrm_config()
    specs = list(dse.figure_studies().items())
    t_spec, d_spec = dse.cluster_comparison_studies(cfg, STUDY_SHAPE, dlrm,
                                                    DLRM_STUDY_BATCH)
    return specs + [("fig15_transformer", t_spec), ("fig15_dlrm", d_spec),
                    ("pp_ep", dse.pp_ep_study()),
                    ("placement", dse.placement_study()),
                    ("multi_tenant", dse.multi_tenant_study()),
                    ("hetero_cost", dse.hetero_cost_study(cfg, STUDY_SHAPE))]


def _records_problems(got, want) -> dict:
    """``got``'s records against ``want``'s: keys in order, types, non-float
    values exactly, floats within ``STUDY_REL`` relative (``STUDY_ABS``;
    inf and nan by their text)."""
    bad, worst = [], 0.0
    if len(got) != len(want):
        return {"bad": [["cells", len(got), len(want)]], "n_bad": 1,
                "max_rel_diff": None}
    for i, (a, b) in enumerate(zip(got.records, want.records)):
        if list(a) != list(b):
            bad.append([i, "keys"])
            continue
        for k, vb in b.items():
            va = a[k]
            if type(va) is not type(vb):
                bad.append([i, k, "type"])
            elif isinstance(vb, float) and math.isfinite(vb):
                diff = abs(va - vb)
                worst = max(worst, diff / max(abs(va), abs(vb), 1e-300))
                if not diff <= max(STUDY_REL * abs(vb), STUDY_ABS):
                    bad.append([i, k, va, vb])
            elif isinstance(vb, float):
                if str(va) != str(vb):
                    bad.append([i, k, va, vb])
            elif va != vb:
                bad.append([i, k, repr(va), repr(vb)])
    return {"bad": bad[:8], "n_bad": len(bad), "max_rel_diff": worst}


def _records_text(res) -> str:
    """The records as exact text (floats by repr, nan and inf included)."""
    return json.dumps(res.records, default=str)


def _timed_runs(spec, device) -> tuple:
    """``STUDY_REPS`` runs of ``spec`` on ``device``: every result and the
    median run's wall ms."""
    results, walls = [], []
    for _ in range(STUDY_REPS):
        t0 = time.perf_counter()
        results.append(run_study(spec, device=device))
        if device != "cpu":
            torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return results, sorted(walls)[len(walls) // 2]


def _assigned_cells(spec) -> int:
    """The cells of one run that took the placement-assigned pipeline."""
    hits = []
    real = study.compiled_stage_assignment

    def counted(*args, **kwargs):
        out = real(*args, **kwargs)
        hits.append(out is not None)
        return out

    study.compiled_stage_assignment = counted
    try:
        run_study(spec, device=DEVICE)
    finally:
        study.compiled_stage_assignment = real
    return sum(hits)


def _case_study_row(label: str, spec) -> tuple:
    run_study(spec, device=DEVICE)            # CUDA's and the profiler's set-up
    cards, card_ms = _timed_runs(spec, DEVICE)
    cpus, cpu_ms = _timed_runs(spec, "cpu")
    card = cards[-1]
    agree = _records_problems(card, cpus[-1])
    equal_runs = _records_text(cards[0]) == _records_text(card)
    prof = _profiled(lambda: run_study(spec, device=DEVICE))
    cells = len(study._cells(spec))
    bad_totals = [r.get("strategy") for r in card.records
                  if "infeasible_reason" not in r
                  and not math.isfinite(r["total"])]
    row = {"study": label, "name": spec.name, "cells": len(card),
           "cells_enumerated": cells,
           "feasible_cells": sum(bool(r["feasible"]) for r in card.records),
           "card_ms": card_ms, "cpu_ms": cpu_ms,
           "device_ms": prof["device_ms"], "launches": prof["launches"],
           "device_idle_share": _idle_share(prof, card_ms),
           "top_device_time": prof["top_device_time"][:3],
           "card_vs_cpu": agree, "two_card_runs_equal": equal_runs,
           "non_finite_totals": bad_totals}
    if label == "placement":
        row["assigned_pipeline_cells"] = _assigned_cells(spec)
    problems = []
    if agree["n_bad"]:
        problems.append({"card_vs_cpu": agree})
    if not equal_runs:
        problems.append("two card runs differ")
    if len(card) != cells or any(c is None for c in card.cells):
        problems.append({"missing_cells": [len(card), cells]})
    if bad_totals:
        problems.append({"non_finite_totals": bad_totals[:8]})
    return row, problems


def _grid_spec() -> StudySpec:
    """The study phase's 12,288 cells through the runner: three scale axes
    of ``STUDY_STEPS`` values over the DGX-A100 baseline x the three flat
    strategies."""
    values = tuple(0.5 + (4.0 / STUDY_STEPS) * i for i in range(STUDY_STEPS))
    return StudySpec(
        name="transformer-1t-grid", model=get_config(STUDY_ARCH),
        shape=STUDY_SHAPE, cluster=BASELINE_DGX_A100,
        strategies=ExplicitSpace(tuple(
            ParallelSpec(mp=mp, dp=dp)
            for mp, dp, pp in STUDY_STRATEGIES if pp == 1)),
        axes=[Axis("flops_x", values, path="node.peak_flops", mode="scale"),
              Axis("local_bw_x", values, path="node.local_bw", mode="scale"),
              Axis("intra_bw_x", values, path="topology.intra_bw",
                   mode="scale")])


def _split_run(spec, device) -> tuple:
    """One run of ``spec`` with its wall ms split: the cells' enumeration
    (``_cells``: each cell's cluster through the axes), the prefetch
    (``time_compiled``), the record assembly (``_eval_cell``), the rest
    (lowering, the prefetch's plan)."""
    spent = {"enumeration": 0.0, "prefetch": 0.0, "assembly": 0.0}
    originals = {"_cells": study._cells, "time_compiled": study.time_compiled,
                 "_eval_cell": study._eval_cell}

    def clocked(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[name] += (time.perf_counter() - t0) * 1e3
        return call

    study._cells = clocked("enumeration", originals["_cells"])
    study.time_compiled = clocked("prefetch", originals["time_compiled"])
    study._eval_cell = clocked("assembly", originals["_eval_cell"])
    try:
        t0 = time.perf_counter()
        res = run_study(spec, device=device)
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        for name, fn in originals.items():
            setattr(study, name, fn)
    return res, {"wall_ms": wall, **{f"{k}_ms": v for k, v in spent.items()},
                 "other_ms": wall - sum(spent.values())}


def _median_split(spec, device) -> tuple:
    runs = [_split_run(spec, device) for _ in range(STUDY_REPS)]
    results = [r for r, _ in runs]
    splits = sorted((s for _, s in runs), key=lambda s: s["wall_ms"])
    return results, splits[len(splits) // 2]


def _grid_against_time_compiled(res) -> dict:
    """Every cell's breakdown against ``time_compiled``'s for the cell's
    environment, one call per strategy over its cells' environments."""
    by_strategy: dict = {}
    for cell in res.cells:
        by_strategy.setdefault(cell.strategy, []).append(cell)
    cfg, rows = get_config(STUDY_ARCH), {}
    for strategy, cells in by_strategy.items():
        cw = decompose(cfg, STUDY_SHAPE, mp=strategy.mp,
                       dp=strategy.dp).compiled()
        want = time_compiled(cw, [(c.cluster.node, c.cluster.topology)
                                  for c in cells], device=DEVICE)
        got_arr = _cells([c.breakdown for c in cells])
        want_arr = _cells(want)
        rows[strategy.label] = {
            "cells": len(cells), **_agreement(got_arr, want_arr),
            "bitwise": bool(np.array_equal(got_arr, want_arr))}
    return rows


def _leaves(obj, path: str = "") -> list:
    """(path, value) of every leaf of a figure API's output: dicts by key
    in order, sequences by index, dataclasses field by field."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = dataclasses.asdict(obj)
    if isinstance(obj, dict):
        return [leaf for k, v in obj.items()
                for leaf in _leaves(v, f"{path}/{k}")]
    if isinstance(obj, (list, tuple)):
        return [leaf for i, v in enumerate(obj)
                for leaf in _leaves(v, f"{path}/{i}")]
    return [(path, obj)]


def _leaf_problems(got, want) -> dict:
    """``got``'s leaves against ``want``'s, by ``_records_problems``'
    rule: the same paths and types, non-float values exactly, floats
    within ``STUDY_REL`` relative (``STUDY_ABS``; inf and nan by text)."""
    a, b = _leaves(got), _leaves(want)
    if [p for p, _ in a] != [p for p, _ in b]:
        return {"bad": [["paths", len(a), len(b)]], "n_bad": 1,
                "max_rel_diff": None}
    bad, worst = [], 0.0
    for (path, va), (_, vb) in zip(a, b):
        if type(va) is not type(vb):
            bad.append([path, "type"])
        elif isinstance(vb, float) and math.isfinite(vb):
            diff = abs(va - vb)
            worst = max(worst, diff / max(abs(va), abs(vb), 1e-300))
            if not diff <= max(STUDY_REL * abs(vb), STUDY_ABS):
                bad.append([path, va, vb])
        elif isinstance(vb, float):
            if str(va) != str(vb):
                bad.append([path, va, vb])
        elif va != vb:
            bad.append([path, repr(va), repr(vb)])
    return {"bad": bad[:8], "n_bad": len(bad), "max_rel_diff": worst}


def _leaves_text(obj) -> str:
    return json.dumps([[p, repr(v)] for p, v in _leaves(obj)])


def _exact_ties(records) -> list:
    """[i, j, column] of every pair of feasible records whose objective
    column is equal to the bit."""
    feasible = [i for i, r in enumerate(records) if r["feasible"]]
    return sorted([i, j, k] for n, i in enumerate(feasible)
                  for j in feasible[n + 1:] for k in TIE_COLUMNS
                  if records[i][k] == records[j][k])


def _identities(records) -> list:
    return [[r.get("strategy"), r.get("em_pod_frac"), r.get("search_round")]
            for r in records]


def _search_out(res) -> dict:
    return {"evaluations": res.evaluations, "trace": res.trace.records,
            "final": res.final.records}


def _paper_api_calls() -> list:
    """(name, device -> output) of the paper's figure API: the Fig. 15
    headline, the Fig. 8-13 wrappers at their defaults, the Pareto
    frontier, the hetero-cost study under it and the two searches of it."""
    cfg, dlrm, base = get_config(STUDY_ARCH), get_dlrm_config(), \
        BASELINE_DGX_A100
    pareto = dse.hetero_cost_study(cfg, PARETO_SHAPE)
    return [
        ("cluster_comparison", lambda d: dse.cluster_comparison(
            cfg, STUDY_SHAPE, dlrm, PAPER_DLRM_BATCH, device=d)),
        ("mpdp_sweep", lambda d: dse.mpdp_sweep(cfg, STUDY_SHAPE, base,
                                                device=d)),
        ("memory_expansion_heatmap", lambda d: dse.memory_expansion_heatmap(
            cfg, STUDY_SHAPE, base, device=d)),
        ("compute_scaling", lambda d: dse.compute_scaling(
            cfg, STUDY_SHAPE, base, 8, 128, device=d)),
        ("network_scaling", lambda d: dse.network_scaling(
            cfg, STUDY_SHAPE, base, 64, 16, device=d)),
        ("bandwidth_rebalance", lambda d: dse.bandwidth_rebalance(
            cfg, STUDY_SHAPE, base, 64, 16, device=d)),
        ("dlrm_cluster_size_sweep", lambda d: dse.dlrm_cluster_size_sweep(
            dlrm, base, device=d)),
        ("dlrm_memory_expansion", lambda d: dse.dlrm_memory_expansion(
            dlrm, base, device=d)),
        ("pareto_frontier", lambda d: dse.pareto_frontier(device=d)),
        ("hetero_cost_study", lambda d: run_study(pareto, device=d).records),
        ("successive_halving", lambda d: _search_out(
            search.successive_halving(pareto, device=d))),
        ("evolutionary_search", lambda d: _search_out(
            search.evolutionary_search(pareto, seed=0, device=d))),
    ]


def _timed(fn, device) -> tuple:
    t0 = time.perf_counter()
    out = fn(device)
    if device != "cpu":
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _paper_api_row(name: str, fn) -> tuple:
    """One figure API call twice on the card and once on the CPU."""
    card, card_ms = _timed(fn, DEVICE)
    again, again_ms = _timed(fn, DEVICE)
    cpu, cpu_ms = _timed(fn, "cpu")
    agree = _leaf_problems(card, cpu)
    equal_runs = _leaves_text(card) == _leaves_text(again)
    row = {"call": name, "card_ms": [card_ms, again_ms], "cpu_ms": cpu_ms,
           "card_vs_cpu": agree, "two_card_runs_equal": equal_runs}
    problems = []
    if agree["n_bad"]:
        problems.append({"card_vs_cpu": agree})
    if not equal_runs:
        problems.append("two card runs differ")
    records = want = None
    if name in ("pareto_frontier", "hetero_cost_study"):
        records, want = card, cpu
    elif name in ("successive_halving", "evolutionary_search"):
        records, want = card["trace"], cpu["trace"]
        row["evaluations"] = card["evaluations"]
        row["final"] = _identities(card["final"])
        if _identities(card["final"]) != _identities(cpu["final"]) \
                or card["evaluations"] != cpu["evaluations"]:
            problems.append("survivors or evaluations differ")
    if records is not None:
        ties, cpu_ties = _exact_ties(records), _exact_ties(want)
        row["order"] = _identities(records)[:8]
        row["exact_ties"] = len(ties)
        if _identities(records) != _identities(want):
            problems.append("frontier or trace order differs")
        if ties != cpu_ties:
            problems.append({"exact_ties": [len(ties), len(cpu_ties)]})
    if name == "cluster_comparison":
        ratio = {k: out["A0"]["transformer-1t"] / out["B1"]["transformer-1t"]
                 for k, out in (("card", card), ("cpu", cpu))}
        row["a0_over_b1_transformer_1t"] = ratio
        rel = abs(ratio["card"] - ratio["cpu"]) / ratio["cpu"]
        row["a0_over_b1_rel_diff"] = rel
        if not rel <= STUDY_REL or not 5.0 < ratio["card"] < 10.0:
            problems.append({"a0_over_b1": ratio})
    return row, problems


def _preflight() -> tuple:
    """validate="error" over the case studies, the search's spec and the
    serving, reliability and fleet studies (the serving and fleet specs
    lowered through ``to_study()``, as run_study lowers them): the
    milliseconds of each pre-flight; a finding of any severity above info
    is a problem."""
    specs = _default_studies() + [
        ("pareto_hetero_cost", dse.hetero_cost_study(get_config(STUDY_ARCH),
                                                     PARETO_SHAPE)),
        ("serving", dse.serving_study()),
        ("reliability", dse.reliability_study()),
        ("fleet", dse.fleet_study()),
        ("reliability_fleet", dse.reliability_fleet_study())]
    ms, problems = {}, []
    for label, spec in specs:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            try:
                if not isinstance(spec, StudySpec):
                    spec = spec.to_study()
                study._validate_spec(spec, "error")
            except Exception as err:                  # AnalysisError
                problems.append({label: str(err)})
            ms[label] = (time.perf_counter() - t0) * 1e3
        problems += [{label: str(w.message)} for w in caught]
    return ms, problems


def _paper_api() -> tuple:
    t0 = time.perf_counter()
    rows, problems = [], []
    for name, fn in _paper_api_calls():
        row, bad = _paper_api_row(name, fn)
        emit("run_study_paper_api", **row)
        rows.append(row)
        problems += [{name: b} for b in bad]
    ms, bad = _preflight()
    problems += bad
    emit("run_study_preflight", validate="error", studies=len(ms),
         total_ms=sum(ms.values()), ms=ms, findings=bad)
    return rows, problems, time.perf_counter() - t0


HEADLINE_KEYS = ("best_failure_free", "best_failure_aware", "ranking_flips",
                 "daly_vs_naive")


def _serving_reliability() -> tuple:
    """The serving and reliability studies: serving_ranking() at its
    defaults once (host code: it touches no tensor, so the card has nothing
    to disagree with; its records are held against the JAX package's in the
    CPU tests), its cells feasible and the disaggregated placement ahead at
    the top rate; reliability_ranking() and reliability_headline() twice
    on the card and once on the CPU (records within 1e-9 relative, the two
    card runs equal, the headline's picks, flip and Daly-vs-naive ratio
    equal)."""
    t0 = time.perf_counter()
    problems = []
    card, card_ms = _timed(lambda d: dse.serving_ranking(device=d), DEVICE)
    per_dollar = {(r["em_pod_frac"], r["rate"], r["placement"]):
                  r["goodput_per_dollar"] for r in card}
    top = max(r["rate"] for r in card)
    win = per_dollar[(0.5, top, "disaggregated")] \
        / per_dollar[(0.5, top, "colocated")]
    if len(card) != 18 or not all(r["feasible"] for r in card):
        problems.append({"serving_cells": len(card)})
    if not win > 1.2:
        problems.append({"serving_disaggregated_win_at_top_rate": win})

    reliability = lambda d: dse.reliability_ranking(device=d)
    runs = [_timed(reliability, DEVICE) for _ in range(2)]
    rel_cpu, rel_cpu_ms = _timed(reliability, "cpu")
    agree = _leaf_problems(runs[0][0], rel_cpu)
    equal_runs = _leaves_text(runs[0][0]) == _leaves_text(runs[1][0])
    heads = {"card": dse.reliability_headline(runs[0][0]),
             "card_again": dse.reliability_headline(runs[1][0]),
             "cpu": dse.reliability_headline(rel_cpu)}
    picked = {k: [h[k] for h in heads.values()] for k in HEADLINE_KEYS}
    if agree["n_bad"]:
        problems.append({"reliability_card_vs_cpu": agree})
    if not equal_runs:
        problems.append("reliability: two card runs differ")
    if any(len(set(map(repr, v))) != 1 for v in picked.values()):
        problems.append({"reliability_headline": picked})
    if not (heads["card"]["daly_vs_naive"] >= 1.0
            and heads["card"]["ranking_flips"]):
        problems.append({"reliability_headline": heads["card"]})
    row = {"serving_cells": len(card), "serving_ms": card_ms,
           "serving_disaggregated_over_colocated_half_em_top_rate": win,
           "reliability_cells": len(runs[0][0]),
           "reliability_card_ms": [ms for _, ms in runs],
           "reliability_cpu_ms": rel_cpu_ms,
           "reliability_card_vs_cpu": agree,
           "reliability_two_card_runs_equal": equal_runs,
           "headline": heads["card"], "headline_equal": {
               k: len(set(map(repr, v))) == 1 for k, v in picked.items()},
           "seconds": time.perf_counter() - t0}
    return row, problems

FLEET_COUNTS = ("n_events", "preemptions", "resize_events", "burst_events",
                "jobs_completed", "failures")


def _fleet_runs(ranking, key, order) -> tuple:
    """``ranking(device)`` twice on the card and once on the CPU: the three
    runs, their ms, and the problems: the records' ``key`` (the swept
    policy) not in ``order``, card
    against CPU outside ``STUDY_REL`` / ``STUDY_ABS``, two card runs not
    equal as text, the event counts not equal across the three."""
    runs = [_timed(ranking, DEVICE) for _ in range(2)]
    cpu, cpu_ms = _timed(ranking, "cpu")
    records = [runs[0][0], runs[1][0], cpu]
    orders = [[r[key] for r in rs] for rs in records]
    agree = _leaf_problems(records[0], cpu)
    equal_runs = _leaves_text(records[0]) == _leaves_text(records[1])
    counts = {k: [[r[k] for r in rs] for rs in records]
              for k in FLEET_COUNTS}
    counts_equal = all(v[0] == v[1] == v[2] for v in counts.values())
    problems = []
    if any(o != order for o in orders):
        problems.append({"order": orders})
    if agree["n_bad"]:
        problems.append({"card_vs_cpu": agree})
    if not equal_runs:
        problems.append("two card runs differ")
    if not counts_equal:
        problems.append({"counts": counts})
    row = {"cells": len(records[0]), "order": orders[0],
           "card_ms": [ms for _, ms in runs], "cpu_ms": cpu_ms,
           "card_vs_cpu": agree, "two_card_runs_equal": equal_runs,
           "counts": {k: v[0] for k, v in counts.items()},
           "counts_equal": counts_equal}
    return records, row, problems


def _fleet() -> tuple:
    """The fleet timeline studies, whose width profiles are timed by the
    compiled evaluator on the run's device and whose event timeline runs on
    the host: fleet_ranking() (12 jobs on a Poisson trace over the mixed
    EM/plain fleet under static, elastic and elastic+burst) and
    reliability_fleet_ranking() (an injected failure on one 16-node pod,
    wait vs shrink), each twice on the card and once on the CPU. Held:
    the policies' order, card against CPU within ``STUDY_REL``, two card
    runs equal as text, the event counts equal across the three runs, the
    headlines within ``STUDY_REL`` of the CPU's (the card's two equal as
    text), elastic+burst's win over static >= 1.3x on turnaround p99 or
    perf per dollar with resize and burst events (static with none), and
    shrink ahead of wait on turnaround p99."""
    t0 = time.perf_counter()
    problems = []
    fleet, frow, bad = _fleet_runs(
        lambda d: dse.fleet_ranking(device=d), "policy",
        ["elastic", "elastic+burst", "static"])
    problems += [{"fleet": b} for b in bad]
    heads = [dse.fleet_headline(rs) for rs in fleet]
    frow["headline"] = heads[0]
    frow["headline_card_vs_cpu"] = _leaf_problems(heads[0], heads[2])
    frow["headline_two_card_runs_equal"] = \
        _leaves_text(heads[0]) == _leaves_text(heads[1])
    by = {r["policy"]: r for r in fleet[0]}
    if frow["headline_card_vs_cpu"]["n_bad"] \
            or not frow["headline_two_card_runs_equal"]:
        problems.append({"fleet_headline": heads})
    if not max(heads[0].values()) >= 1.3:
        problems.append({"fleet_headline_below_1.3": heads[0]})
    eb, static = by.get("elastic+burst", {}), by.get("static", {})
    if not (eb.get("resize_events", 0) > 0 and eb.get("burst_events", 0) > 0
            and static.get("resize_events") == 0
            and static.get("burst_events") == 0):
        problems.append({"fleet_events": frow["counts"]})
    if any(r["jobs_completed"] != 12 for r in fleet[0]):
        problems.append({"fleet_jobs_completed": frow["counts"]})

    rel, rrow, bad = _fleet_runs(
        lambda d: dse.reliability_fleet_ranking(device=d), "degradation",
        ["shrink", "wait"])
    problems += [{"reliability_fleet": b} for b in bad]
    rheads = [dse.reliability_fleet_headline(rs) for rs in rel]
    rrow["headline"] = rheads[0]
    rrow["headline_card_vs_cpu"] = _leaf_problems(rheads[0], rheads[2])
    rrow["headline_two_card_runs_equal"] = \
        _leaves_text(rheads[0]) == _leaves_text(rheads[1])
    if rrow["headline_card_vs_cpu"]["n_bad"] \
            or not rrow["headline_two_card_runs_equal"]:
        problems.append({"reliability_fleet_headline": rheads})
    if not rheads[0]["p99_ratio"] > 1.0:
        problems.append({"reliability_fleet_p99_ratio": rheads[0]})
    return ({"fleet": frow, "reliability_fleet": rrow,
             "seconds": time.perf_counter() - t0}, problems)


POOL_PROCESSES = min(8, os.cpu_count() or 1)   # the CPU pool's request
POOL_CARD_PROCESSES = 2                         # asked for on the card


def _study_pool() -> tuple:
    """run_study's process pool (ROADMAP item 22) over the grid: the CPU's
    serial run against ``processes=POOL_PROCESSES`` on the CPU (records
    equal as text, the ms of each, the workers the pool took), then
    ``processes=2`` on the card against the card's serial run (one warning,
    the same records: no pool runs there). CUDA is initialised in this
    process by then, so the CPU pool's workers are shown not to touch it.
    (row, problems)."""
    spec = _grid_spec()
    cuda_ready = torch.cuda.is_initialized()
    chunks, workers = study.pool_plan(spec, study._cells(spec),
                                      POOL_PROCESSES)
    t0 = time.perf_counter()
    serial = run_study(spec, device="cpu")
    serial_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    pooled = run_study(spec, processes=POOL_PROCESSES, device="cpu")
    pool_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    card = run_study(spec, device=DEVICE)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        card_pool = run_study(spec, processes=POOL_CARD_PROCESSES,
                              device=DEVICE)
        torch.cuda.synchronize()
        card_pool_ms = (time.perf_counter() - t0) * 1e3
    warned = [str(w.message) for w in seen if "device's batch" in
              str(w.message)]
    row = {"name": spec.name, "cells": len(serial),
           "cuda_initialised_before": cuda_ready,
           "cpu": {"processes": POOL_PROCESSES, "chunks": len(chunks),
                   "workers": workers, "serial_ms": serial_ms,
                   "pool_ms": pool_ms, "speedup": serial_ms / pool_ms,
                   "records_equal": (_records_text(pooled)
                                     == _records_text(serial))},
           "card": {"processes": POOL_CARD_PROCESSES, "warnings": warned,
                    "serial_ms": card_ms, "ms": card_pool_ms,
                    "records_equal": (_records_text(card_pool)
                                      == _records_text(card))}}
    problems = []
    if not cuda_ready:
        problems.append("CUDA was not initialised before the CPU pool")
    if not row["cpu"]["records_equal"]:
        problems.append("the CPU pool's records differ from the serial run's")
    if len(warned) != 1:
        problems.append({"card_pool_warnings": warned})
    if not row["card"]["records_equal"]:
        problems.append("processes=2 on the card differs from its serial run")
    return row, problems


def phase_run_study() -> dict:
    """COMET's study runner over the paper's case studies and the study
    phase's grid (see the module docstring). Returns the hand-written
    kernels' launches in it."""
    t_phase = time.perf_counter()
    problems, rows = [], []
    _zero_kernel_counts()
    for label, spec in _default_studies():
        row, bad = _case_study_row(label, spec)
        emit("run_study", **row)
        rows.append(row)
        problems += [{label: b} for b in bad]
    spec = _grid_spec()
    _split_run(spec, DEVICE)                   # first run's set-up
    cards, card_split = _median_split(spec, DEVICE)
    cpus, cpu_split = _median_split(spec, "cpu")
    card = cards[-1]
    agree = _records_problems(card, cpus[-1])
    equal_runs = _records_text(cards[0]) == _records_text(card)
    against = _grid_against_time_compiled(card)
    expected = STUDY_STEPS ** 3 * len(spec.strategies.strategies)
    finite = all(math.isfinite(r["total"]) for r in card.records)
    emit("run_study_grid", name=spec.name, cells=len(card),
         expected_cells=expected, card=card_split, cpu=cpu_split,
         card_vs_cpu=agree, two_card_runs_equal=equal_runs,
         against_time_compiled=against, finite=finite)
    if agree["n_bad"]:
        problems.append({"grid_card_vs_cpu": agree})
    if not equal_runs:
        problems.append("grid: two card runs differ")
    if len(card) != expected or not finite:
        problems.append({"grid_cells": len(card), "finite": finite})
    for label, r in against.items():
        if r["cells_outside"]:
            problems.append({"grid_vs_time_compiled": {label: r}})
    api_rows, api_problems, api_s = _paper_api()
    problems += api_problems
    sr_row, sr_problems = _serving_reliability()
    emit("run_study_serving_reliability", **sr_row, problems=sr_problems)
    problems += sr_problems
    fleet_row, fleet_problems = _fleet()
    emit("run_study_fleet", **fleet_row, problems=fleet_problems)
    problems += fleet_problems
    pool_row, pool_problems = _study_pool()
    emit("run_study_pool", **pool_row, problems=pool_problems)
    problems += pool_problems
    launches = _kernel_counts()
    if any(launches.values()):
        problems.append({"kernel_launches": launches})
    emit("run_study_summary", studies=len(rows), paper_api_calls=len(api_rows),
         paper_api_seconds=api_s,
         serving_reliability_seconds=sr_row["seconds"],
         fleet_seconds=fleet_row["seconds"],
         pool_ms={"cpu_serial": pool_row["cpu"]["serial_ms"],
                  "cpu_pool": pool_row["cpu"]["pool_ms"],
                  "card_processes_2": pool_row["card"]["ms"]},
         cells=sum(r["cells"] for r in rows) + len(card),
         max_rel_diff=max([r["card_vs_cpu"]["max_rel_diff"] or 0.0
                           for r in rows + api_rows]
                          + [agree["max_rel_diff"] or 0.0]),
         tolerance={"rel": STUDY_REL, "abs": STUDY_ABS},
         kernel_launches=launches, problems=problems,
         seconds=time.perf_counter() - t_phase)
    if problems:
        raise SystemExit(f"chip_smoke: run_study phase failed: {problems}")
    return launches


# COMET's measured frontend: the op counter's terms against measured steps.
DRYRUN_PREFILL = (1, 1024)              # batch, prompt tokens
DRYRUN_DECODE = (8, 2048)               # batch, max_seq
DRYRUN_REPS = 5                         # timed calls a step, median kept
DRYRUN_DISPATCH_CALLS = 20_000          # calls a route, for its host cost
DRYRUN_TICKS = 300                      # decode ticks a route, alternating
DRYRUN_WORKERS = 6                      # host processes tracing the sweep's cells
DRYRUN_SWEEP_TIMEOUT_S = 600            # the sweep's limit (a worker lost hangs a pool)


def _dryrun_lm_step(device: str):
    """The train_lm step (full-width, full-depth smollm-135m, fp32, 8 x
    2048 tokens, the plan's remat) on ``device``: (run, its arguments)."""
    cfg = get_config(LM_ARCH)
    plan = plan_memory(cfg, tp=1, dp=1)
    ocfg = AdamWConfig(lr=LM_LR, warmup_steps=LM_WARMUP, total_steps=100,
                       state_dtype=plan.opt_dtype, use_master=plan.use_master)
    gen = (None if device == "meta"
           else torch.Generator(device=device).manual_seed(0))
    state = init_train_state(cfg, plan, gen, ocfg, dtype=torch.float32,
                             device=device)
    batch = _par_batches(cfg, 1)[0]
    if device == "meta":
        batch = {k: torch.empty_like(v, device="meta")
                 for k, v in batch.items()}
    step = make_train_step(cfg, plan, ocfg)
    hold = ({"params": state["params"], "opt": state["opt"]}, batch)
    return (lambda: step(state, batch)), hold


def _dryrun_serving_step(device: str, kind: str):
    """smollm-135m at full width and depth, bf16, weights from seed 0 (none
    drawn on ``meta``): one prefill of DRYRUN_PREFILL on a fresh cache, or
    one decode tick of DRYRUN_DECODE's batch at the kernels phase's decode
    positions. (run, its arguments); each run starts from the same cache
    clock."""
    cfg = get_config(LM_ARCH)
    gen = (None if device == "meta"
           else torch.Generator(device=device).manual_seed(0))
    model = get_model(cfg)(cfg, dtype=torch.bfloat16, device=device,
                           generator=gen)
    rs = np.random.RandomState(0)
    if kind == "prefill":
        b, s = DRYRUN_PREFILL
        cache = model.init_cache(b, DRYRUN_DECODE[1])
        tokens = torch.from_numpy(rs.randint(0, cfg.vocab_size, size=(b, s)))
        pos = torch.zeros((b,), dtype=torch.int32)
    else:
        b, max_seq = DRYRUN_DECODE
        cache = model.init_cache(b, max_seq)
        tokens = torch.from_numpy(rs.randint(0, cfg.vocab_size, size=(b, 1)))
        pos = torch.from_numpy(rs.randint(0, max_seq - 1, size=b)).int()
    tokens = tokens.to(device)
    step = model.prefill if kind == "prefill" else (
        lambda t, c: model.decode_step(c, t))

    def run():
        with torch.no_grad():
            cache["pos"].copy_(pos)
        return step(tokens, cache)

    hold = (dict(model.named_parameters()), cache, tokens)
    return run, hold


def _counted(run, hold) -> OpCounter:
    with OpCounter(hold=hold) as counter:
        run()
    return counter


def _dryrun_row(name: str, shape: ShapeConfig, dtype: torch.dtype,
                make) -> dict:
    """One step counted on the card and on ``meta``, the counted terms
    against the step's measured wall and device ms, the counter's peak live
    bytes against torch.cuda.max_memory_allocated."""
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config(LM_ARCH)
    run, hold = make(DEVICE)
    run()                                         # warm-up
    torch.cuda.synchronize()
    on_card = _counted(run, hold)
    torch.cuda.synchronize()
    live_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    wall = []
    for _ in range(DRYRUN_REPS):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    device_us, launches, by_name = _device_time(prof, 1, "step")
    del run, hold
    torch.cuda.empty_cache()
    run, hold = make("meta")
    on_meta = _counted(run, hold)
    del run, hold

    terms = terms_from_counts(on_card.cost, 1, peak_flops=HLO_PEAK[dtype])
    bound_ms = terms.bound_s * 1e3
    wall_ms = float(np.median(wall))
    device_ms = device_us / 1e3 if device_us else "not measured"
    mf = model_flops(cfg, shape)
    return {
        "step": name, "dtype": dtype_name(dtype),
        "flops": on_card.cost.flops, "hbm_bytes": on_card.cost.bytes,
        "coll_bytes": sum(on_card.cost.coll.values()),
        "meta": {"flops": on_meta.cost.flops, "hbm_bytes": on_meta.cost.bytes,
                 "coll_bytes": sum(on_meta.cost.coll.values()),
                 "peak_live_bytes": on_meta.peak_bytes},
        "equal_on_cuda_and_meta": (
            on_card.cost.flops == on_meta.cost.flops
            and on_card.cost.bytes == on_meta.cost.bytes
            and on_card.cost.coll == on_meta.cost.coll),
        **terms.as_dict(), "bound_ms": bound_ms,
        "wall_ms_median": wall_ms, "wall_ms": wall, "device_ms": device_ms,
        "device_launches": launches,
        "wall_over_bound": wall_ms / bound_ms,
        "device_over_bound": (device_ms / bound_ms if device_us
                              else "not measured"),
        "model_flops": mf, "model_flops_util": model_flops_util(mf, terms),
        "peak_live_bytes_counted": on_card.peak_bytes,
        "argument_bytes_counted": on_card.argument_bytes,
        "max_memory_allocated": peak, "memory_allocated_before": live_before,
        "top_ops_by_bytes": sorted(
            ([k, *v] for k, v in on_card.by_op.items()),
            key=lambda r: -r[3])[:8],
        "top_device_time": by_name[:6],
    }


def _dispatch_us() -> dict:
    """The host cost of one call by each route a kernel's wrapper could
    take to its implementation, on a tiny CPU tensor (the dispatcher's work
    does not depend on the device): the function itself, an operator
    defined with ``torch.library.Library`` (the kernels' route), and one
    defined with ``torch.library.custom_op``."""
    lib = torch.library.Library("chip_smoke_probe", "DEF")
    lib.define("through_library(Tensor x) -> Tensor")
    lib.impl("through_library", lambda x: x.new_empty(x.shape), "CPU")

    @torch.library.custom_op("chip_smoke_probe::through_custom_op",
                             mutates_args=())
    def through_custom_op(x: torch.Tensor) -> torch.Tensor:
        return x.new_empty(x.shape)

    x = torch.zeros(4)
    routes = {"function": lambda t: t.new_empty(t.shape),
              "library": torch.ops.chip_smoke_probe.through_library,
              "custom_op": through_custom_op}
    out = {}
    with torch.no_grad():
        for name, fn in routes.items():
            for _ in range(1000):
                fn(x)
            t0 = time.perf_counter()
            for _ in range(DRYRUN_DISPATCH_CALLS):
                fn(x)
            out[name] = (time.perf_counter() - t0) * 1e6 / DRYRUN_DISPATCH_CALLS
    return out


def _per_call_us(fn, calls: int = 3000) -> float:
    """Host µs a call of ``fn`` issued back to back (the card keeps up)."""
    for _ in range(300):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / calls


def _dispatch_on_the_tick() -> dict:
    """What the kernels' dispatcher route costs the serving tick, in one
    process: smollm's decode tick (``_dryrun_serving_step``) with the
    wrappers as they are (each kernel an operator) and with wrappers that
    call the launchers directly (the route before the operators),
    alternating tick by tick, DRYRUN_TICKS each; and each wrapper's host
    µs a call at the tick's shapes by both routes."""
    direct = {
        "rmsnorm": lambda x, gamma, eps=1e-5: rmsnorm_cuda(x, gamma, eps),
        "flash_attention": lambda q, k, v, causal=True, kv_len=None,
        q_offset=None: flash_attention_cuda(q, k, v, causal, kv_len,
                                            q_offset)}
    wrappers = {name: getattr(ops, name) for name in direct}
    run, _ = _dryrun_serving_step(DEVICE, "decode")
    times = {"operator": [], "direct": []}

    def tick(route):
        for name in direct:
            setattr(ops, name, wrappers[name] if route == "operator"
                    else direct[name])
        t0 = time.perf_counter()
        logits, _ = run()
        logits[:, 0].argmax(-1).tolist()
        times[route].append((time.perf_counter() - t0) * 1e3)

    try:
        for i in range(DRYRUN_TICKS):
            for route in (("operator", "direct") if i % 2
                          else ("direct", "operator")):
                tick(route)
    finally:
        for name, wrapper in wrappers.items():
            setattr(ops, name, wrapper)
    x = torch.randn((8, 1, 576), device=DEVICE).to(torch.bfloat16)
    gamma = torch.ones(576, device=DEVICE, dtype=torch.bfloat16)
    q = torch.randn((8, 1, 9, 64), device=DEVICE).to(torch.bfloat16)
    kv = torch.randn((8, 2048, 3, 64), device=DEVICE).to(torch.bfloat16)
    q, kv = q.transpose(1, 2), kv.transpose(1, 2)
    at = torch.full((8,), 1000, dtype=torch.int32, device=DEVICE)
    with torch.no_grad():
        per_call = {
            "rmsnorm_operator": _per_call_us(lambda: ops.rmsnorm(x, gamma)),
            "rmsnorm_direct": _per_call_us(lambda: rmsnorm_cuda(x, gamma)),
            "attention_operator": _per_call_us(
                lambda: ops.flash_attention(q, kv, kv, True, None, at)),
            "attention_direct": _per_call_us(
                lambda: flash_attention_cuda(q, kv, kv, True, None, at))}
    med = {k: float(np.median(v)) for k, v in times.items()}
    return {"ticks_each": DRYRUN_TICKS, "tick_ms_median": med,
            "tick_ms_mean": {k: float(np.mean(v)) for k, v in times.items()},
            "operator_over_direct": med["operator"] / med["direct"],
            "per_call_us": per_call}


# Every family's cells trace ok on both meshes; a refused cell's row names
# the ROADMAP items its error names.
ROADMAP_ITEM = r"ROADMAP Queue 1 item (\d+)"


def phase_dryrun() -> None:
    """COMET's measured frontend (repro_torch.core.op_counter, core.hlo,
    launch.dryrun). (a) The train_lm step, one smollm prefill and one decode
    tick, each counted by the op counter on the card and on ``meta`` at the
    same sizes: FLOPs, bytes and collective bytes must be equal; the
    roofline terms at the H100's rates beside the measured wall and device
    ms, model_flops_util, and the counted peak live bytes beside
    torch.cuda.max_memory_allocated. (b) On the host: lower_cell over every
    runnable cell on the 16 x 16 and the 2 x 16 x 16 mesh (a fake process
    group of 256 / 512 ranks; none may be held here), DRYRUN_WORKERS
    processes tracing the cells side by side: the ok and refused
    counts, each cell's trace_s and dominant term; every cell must be ok
    (long_500k's one row too, served whole on every data rank).
    Also the host cost of a call by each dispatcher route, and what the
    kernels' operators cost the decode tick against direct launches."""
    if dist.is_initialized():
        raise SystemExit("chip_smoke: dryrun: a process group is held")
    steps = []
    for name, shape, dtype, make in (
            ("train_lm step", ShapeConfig("train_lm", LM_SEQ, LM_BATCH,
                                          "train"),
             torch.float32, _dryrun_lm_step),
            ("prefill", ShapeConfig("prefill", DRYRUN_PREFILL[1],
                                    DRYRUN_PREFILL[0], "prefill"),
             torch.bfloat16,
             lambda dev: _dryrun_serving_step(dev, "prefill")),
            ("decode tick", ShapeConfig("decode", DRYRUN_DECODE[1],
                                        DRYRUN_DECODE[0], "decode"),
             torch.bfloat16,
             lambda dev: _dryrun_serving_step(dev, "decode"))):
        steps.append(_dryrun_row(name, shape, dtype, make))
        torch.cuda.empty_cache()

    tick_cost = _dispatch_on_the_tick()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cells = [(arch, shape_name, multi_pod)
             for multi_pod in (False, True)
             for arch, shape_name, runnable, _ in all_cells() if runnable]
    directory = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    # The cells are independent, so a pool of DRYRUN_WORKERS spawned
    # processes, which hold no process group, traces them side by side (a
    # worker takes many cells in turn: lower_cell joins and destroys its
    # fake group for each); the results come back in order. Each cell's
    # trace_s is taken while the workers share the host.
    import multiprocessing
    try:
        with multiprocessing.get_context("spawn").Pool(DRYRUN_WORKERS) as pool:
            infos = pool.starmap_async(
                run_cell, [(arch, shape_name, mp, directory)
                           for arch, shape_name, mp in cells],
                chunksize=1).get(timeout=DRYRUN_SWEEP_TIMEOUT_S)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    sweep_s = time.perf_counter() - t0
    rows = [{"arch": i["arch"], "shape": i["shape"], "mesh": i["mesh"],
             "status": i["status"],
             **({"trace_s": i["trace_s"], "dominant": i["dominant"],
                 "roofline_fraction": i["roofline_fraction"],
                 "model_flops_util": i["model_flops_util"]}
                if i["status"] == "ok" else {
                    "error": i["error"][:160],
                    "items": sorted(set(re.findall(ROADMAP_ITEM,
                                                   i["error"])))})}
            for i in infos]

    problems = [f"{r['step']}: counts differ on cuda and meta"
                for r in steps if not r["equal_on_cuda_and_meta"]]
    problems += [f"{r['arch']} {r['shape']} {r['mesh']}: {r['error']}"
                 for r in rows if r["status"] != "ok"]
    if dist.is_initialized():
        problems.append("a process group was left after the sweep")
    emit("dryrun", card=_smi("name,power.limit"), steps=steps,
         sweep={"cells": len(rows),
                "ok": sum(r["status"] == "ok" for r in rows),
                "refused": sum(r["status"] != "ok" for r in rows),
                "seconds": sweep_s, "rows": rows},
         dispatch_us=_dispatch_us(), dispatch_on_the_tick=tick_cost,
         problems=problems)
    if problems:
        raise SystemExit(f"chip_smoke: dryrun phase failed: {problems}")


def kernels_line(cases: list, launches_by_path: dict, repeats: list) -> dict:
    """One entry per kernel: its launches on the main paths (each path's
    count, read just after that path; 0 where a path never launches it; and
    their sum), its largest error over every case compared, and its times at
    the shape the main path gives it most often (attention and RMSNorm: one
    decode tick of the bf16 dense serve phase; the SSD scan: the bf16
    1024-token prefill; the embedding bag, both directions: the fp32 DLRM
    training step; the attention and RMSNorm backwards: the fp32 train_lm
    step's layer, with bf16 beside it); attention also carries the bf16
    1024-token prefill under ``prefill`` and the train_lm forward (with the
    log-sum-exp) under ``train_forward_with_lse`` (train_zamba's at head_dim
    160 under ``train_forward_with_lse_d160``) and the reduced configs'
    head_dim 16 cases under ``head_dim_16``, its backward the head_dim
    160 cases under ``head_dim_160``, RMSNorm and its backward the reduced
    configs' d_model 64 cases under ``d_model_64``, the embedding bag the
    same step at Zipf indices under ``zipf``; the two backwards their
    repeats phase's counts under ``repeat_check``. The other shapes' times
    are in the ``kernels`` phase's line."""
    entries = []
    for name, source, replaces, is_main in KERNELS:
        mine = [c for c in cases if c["kernel"] == name]
        main_case = next(c for c in mine if is_main(c))
        by_path = {path: counts.get(name, 0)
                   for path, counts in launches_by_path.items()}
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": main_case["kernel_ms"],
            "eager_ms": main_case["kernel_eager_ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            **({"library_note": main_case["library_note"]}
               if "library_note" in main_case else {}),
            "timed_at": {k: main_case[k] for k in ("case", "shape", "dtype")
                         if k in main_case},
            "cases_compared": len(mine),
        })
        if name in ("ssd_scan", "embedding_bag_backward"):
            entries[-1]["kernels_per_call"] = main_case["kernels_per_call"]
            entries[-1]["stage_ms"] = main_case["stage_ms"]
        if name.startswith("embedding_bag"):
            zipf = next(c for c in mine if c["case"] == "zipf"
                        and c["dtype"] == "float32")
            entries[-1]["zipf"] = {
                k: zipf[k] for k in ("kernel_ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by", "stage_ms",
                                     "bitwise_equal_calls") if k in zipf}
        if name in ("embedding_bag_backward", "flash_attention_backward",
                    "rmsnorm_backward", "ssd_scan_backward"):
            entries[-1]["bitwise_equal_calls"] = main_case[
                "bitwise_equal_calls"]
        if name in ("flash_attention_backward", "rmsnorm_backward",
                    "ssd_scan_backward"):
            entries[-1]["repeat_check"] = [
                {k: r[k] for k in ("case", "dtype", "calls", "differing")}
                for r in repeats if r["kernel"] == name]
            if name in ("rmsnorm_backward", "ssd_scan_backward"):
                entries[-1]["stage_ms"] = main_case["stage_ms"]
            # library_ms of a backward is a torch.profiler sum of device time
            # (trace_ms); kernel_trace_ms is the kernels' read the same way.
            entries[-1]["kernels_per_call"] = main_case["kernels_per_call"]
            entries[-1].update({k: main_case[k] for k in (
                "kernel_trace_ms", "library_kernels", "library_backend")
                if k in main_case})
            entries[-1]["replaces_note"] = (
                "no Pallas backward: the gradient of the kernel named; "
                "jax.grad of the reference model is the oracle")
            if name == "flash_attention_backward":
                # zamba2's head dim 160 (train_zamba's layer, the ragged and
                # GQA cases), both types
                entries[-1]["head_dim_160"] = [
                    {k: c[k] for k in (
                        "case", "shape", "dtype", "kernel_ms",
                        "kernel_trace_ms", "plain_ms", "library_ms",
                        "library_backend", "library_by_backend_ms",
                        "bound_ms", "bound_by", "bound_fp32_pipes_ms",
                        "max_abs_err", "lse_max_abs_err",
                        "bitwise_equal_calls", "kernels_per_call")
                     if k in c}
                    for c in mine if c["shape"]["d"] == 160]
            bf16 = next(c for c in mine if c["dtype"] == "bfloat16"
                        and c.get("case") == main_case.get("case")
                        and c["shape"] == main_case["shape"])
            entries[-1]["bfloat16"] = {
                k: bf16[k] for k in ("kernel_ms", "kernel_trace_ms",
                                     "plain_ms", "library_ms",
                                     "library_backend", "bound_ms",
                                     "bound_by", "max_abs_err",
                                     "stage_ms") if k in bf16}
        if name in ("flash_attention", "rmsnorm"):
            granite = [c for c in mine if c["dtype"] == "bfloat16" and (
                c.get("case", "").startswith("granite")
                or c.get("shape") in ([8, 1, 1536], [1, 1024, 1536]))]
            entries[-1]["granite"] = [
                {k: c[k] for k in ("case", "shape", "kernel_ms",
                                   "kernel_eager_ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by", "max_abs_err")
                 if k in c} for c in granite]
        if name in ("flash_attention", "rmsnorm", "ssd_scan",
                    "ssd_scan_backward"):
            # zamba2's and seamless's shapes (serve_zamba, serve_encdec; the
            # backward's zamba2 layer), both types
            entries[-1]["zamba2_seamless"] = [
                {k: c[k] for k in ("case", "shape", "dtype", "kernel_ms",
                                   "kernel_eager_ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by", "max_abs_err",
                                   "cluster_ms") if k in c}
                for c in mine if c.get("case", "").startswith(
                    ("zamba2", "seamless"))
                or c.get("shape") == [1, 1024, 5120]]
        if name == "flash_attention_partial":
            # every case of the route: zamba2's long_500k block, the GQA
            # row at d 64 (12 blocks for 132 SMs), rows with no key
            entries[-1]["cases"] = [
                {k: c[k] for k in ("case", "shape", "dtype", "kernel_ms",
                                   "plain_ms", "library_ms", "bound_ms",
                                   "of_bound", "blocks", "max_abs_err",
                                   "plain_max_abs", "err_of_plain_max",
                                   "lse_max_abs_err")}
                for c in mine]
        if name in ("rmsnorm", "rmsnorm_backward"):
            # the reduced configs' d_model 64 (serve_reduced's tick and
            # prefill, torch_train_lm.py's rows), both types
            entries[-1]["d_model_64"] = [
                {k: c[k] for k in ("shape", "dtype", "kernel_ms",
                                   "kernel_eager_ms", "plain_ms",
                                   "library_ms", "bound_ms", "bound_by",
                                   "max_abs_err", "tol") if k in c}
                for c in mine if c["shape"][-1] == 64]
        if name == "flash_attention":
            # the reduced configs' head dim (serve_reduced), both types: the
            # decode kernels at every cluster, the prefill kernels
            entries[-1]["head_dim_16"] = [
                {k: c[k] for k in ("case", "shape", "dtype", "kernel_ms",
                                   "kernel_eager_ms", "plain_ms",
                                   "library_ms", "bound_ms", "bound_by",
                                   "max_abs_err", "cluster_max_abs_err",
                                   "cluster_ms") if k in c}
                for c in mine if c["shape"]["d"] == 16]
            prefill = next(c for c in mine if c["case"] == "prefill s=1024"
                           and c["dtype"] == "bfloat16")
            entries[-1]["prefill"] = {
                k: prefill[k] for k in ("case", "kernel_ms", "kernel_eager_ms",
                                        "plain_ms", "library_ms", "bound_ms",
                                        "bound_by")}
            train = next(c for c in cases
                         if c["kernel"] == "flash_attention_backward"
                         and c["case"] == "train main"
                         and c["dtype"] == "float32")
            entries[-1]["train_forward_with_lse"] = {
                "kernel": "flash_tf32_kernel",
                "ms": train["forward_lse_ms"],
                "bound_ms": train["forward_lse_bound_ms"],
                "library_ms": train["forward_library_ms"],
                "plain_ms": train["forward_plain_ms"],
                "out_max_abs_err": train["forward_out_max_abs_err"],
                "lse_max_abs_err": train["lse_max_abs_err"],
                "bitwise_equal_calls": train["forward_bitwise_equal_calls"]}
            # the same at train_zamba's layer (head_dim 160), both types
            entries[-1]["train_forward_with_lse_d160"] = [
                {"dtype": c["dtype"],
                 "kernel": ("flash_tf32_kernel" if c["dtype"] == "float32"
                            else "flash_mma_kernel"),
                 "ms": c["forward_lse_ms"],
                 "bound_ms": c["forward_lse_bound_ms"],
                 "library_ms": c["forward_library_ms"],
                 "library_backend": c["forward_library_backend"],
                 "plain_ms": c["forward_plain_ms"],
                 "out_max_abs_err": c["forward_out_max_abs_err"],
                 "lse_max_abs_err": c["lse_max_abs_err"],
                 "lse_tol": c["lse_tol"],
                 "bitwise_equal_calls": c["forward_bitwise_equal_calls"]}
                for c in cases if c["kernel"] == "flash_attention_backward"
                and c["case"] == "zamba2 train d=160"]
            # the same with q_offset: a rank's block of a sequence split
            # over two ranks (the kernels phase's q_offset cases)
            entries[-1]["train_forward_with_lse_q_offset"] = [
                {"case": c["case"], "dtype": c["dtype"], "shape": c["shape"],
                 "ms": c["forward_lse_ms"],
                 "bound_ms": c["forward_lse_bound_ms"],
                 "library_ms": c["forward_library_ms"],
                 "plain_ms": c["forward_plain_ms"],
                 "out_max_abs_err": c["forward_out_max_abs_err"],
                 "lse_max_abs_err": c["lse_max_abs_err"],
                 "bitwise_equal_calls": c["forward_bitwise_equal_calls"]}
                for c in cases if c["kernel"] == "flash_attention_backward"
                and "q_offset" in c]
        if name == "flash_attention_backward":
            entries[-1]["q_offset"] = [
                {k: c[k] for k in ("case", "shape", "dtype", "kernel_ms",
                                   "kernel_trace_ms", "plain_ms",
                                   "library_ms", "library_backend",
                                   "bound_ms", "bound_by", "max_abs_err",
                                   "unseen_keys", "unseen_keys_zero",
                                   "bitwise_equal_calls")}
                for c in mine if "q_offset" in c]
        if name in ("ssd_scan", "ssd_scan_backward"):
            # from an initial state (the kernels phase's init_state cases)
            entries[-1]["init_state"] = [
                {k: c[k] for k in ("case", "shape", "dtype", "kernel_ms",
                                   "train_forward_ms", "plain_ms",
                                   "library_ms", "bound_ms", "bound_by",
                                   "max_abs_err", "bitwise_equal_calls")
                 if k in c}
                for c in mine if c["shape"].get("init_state")]
    return {"kernels": entries}


def main() -> int:
    env = phase_env()
    phase_build()
    cases = phase_kernels()
    repeats = phase_repeats()
    launches = {}
    # The dense path keeps drawing its weights on the CPU, as it always did;
    # mamba2's 781 M, granite-moe's 3.3 G and zamba2's 2.4 G are drawn on
    # the card.
    for arch, phase, weight_device in (("smollm-135m", "serve", "cpu"),
                                       ("mamba2-780m", "serve_mamba", DEVICE),
                                       (MOE_ARCH, "serve_moe", DEVICE),
                                       (ZAMBA_ARCH, "serve_zamba", DEVICE)):
        serve = phase_serve(arch, phase, weight_device)
        phase_profile(serve["engine"], phase.replace("serve", "profile"))
        launches[phase] = serve["launches"]
        del serve
        torch.cuda.empty_cache()
    launches["serve_encdec"] = phase_serve_encdec()["launches"]
    torch.cuda.empty_cache()
    launches["serve_reduced"] = phase_serve_reduced()
    launches["train_dlrm"] = phase_train_dlrm()
    phase_train_dlrm_check()
    launches["train_lm"] = phase_train_lm()
    phase_train_lm_check()
    launches["train_mamba"] = phase_train_mamba()
    phase_train_mamba_check()
    launches["train_zamba"] = phase_train_zamba()
    phase_train_zamba_check()
    phase_checkpoint()
    launches["parallel"] = phase_parallel()
    phase_parallel_gloo()
    launches["parallel_gloo_ssm"] = phase_parallel_gloo_ssm()
    launches["parallel_gloo_split"] = phase_parallel_gloo_split()
    launches["parallel_gloo_moe"] = phase_parallel_gloo_moe()
    launches["parallel_gloo_long"] = phase_parallel_gloo_long()
    launches["parallel_gloo_seq"] = phase_parallel_gloo_seq()
    launches["parallel_gloo_seq_families"] = (
        phase_parallel_gloo_seq_families())
    phase_dryrun()
    launches["study"] = phase_study()
    launches["run_study"] = phase_run_study()
    line = kernels_line(cases, launches, repeats)
    for entry in line["kernels"]:
        if entry["launches"] <= 0:
            raise SystemExit(f"chip_smoke: the main path never launched "
                             f"{entry['name']}")
    print(env["card"], flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

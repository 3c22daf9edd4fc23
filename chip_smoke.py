#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, each printing its own lines:

0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
1. build every kernel of the path from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all started together), and beside them the sources
   of kernels 11–13 with ``-Xptxas -v``: for each bf16 kernel
   (``fa_fwd_wgmma``, ``fa_bwd_dkv_wgmma``, ``fa_bwd_dq_wgmma``, each at hd
   16, 32, 64, 120 and 128) its registers, spills (none allowed) and dynamic shared
   memory, and ``HGMMA`` and ``UTMALDG`` in its SASS (``cuobjdump -sass``);
2. hold each wire kernel bit-equal against its plain PyTorch version on the card,
   at d = 70,001 and 16,777,217 (n = 8 peers, keys folded per rank from
   ``PRNGKey(seed)``), with a forced-small-cap overflow case and shard
   windows straddling block edges, the bit-plane kernels at every width and
   on strided word windows, the Bernoulli encode's pair chunks at ragged
   halves (d = 2, 2047, 2049, 2^21 + 3 with a small cap), the flat
   Bernoulli decode's pair chunks at ragged halves (d = 1, 2, 2047, 2049,
   70,001, 2^21 + 3 at n = 1, 3, 8, with cap overflow, each equal to the
   sequential and to the plain decode), the Bernoulli encode's unscaled
   variant (the error-feedback twin) at every encode case on inputs with
   −0.0 entries and μ < 0, timed beside the scaled one at the main shape,
   the flat decode at n = 1 from a −0.0 accumulator (the twin's unpack)
   against ``decode_one``, the FWHT and
   rotate-min/max kernels at row lengths 2^8 .. 2^20 (odd exponents
   included, where 1/sqrt(c) is not a power of two; from 2^18 and at the
   main shape each called twice and the FWHT in place too), the rotated
   encode-pack at ragged lengths (dp = 1, 2, 33, 65, 70,001, 131,083: the
   high ballots split across words) and at delta = 0, and every kernel at the largest shape the main path gives it;
   time kernel and plain version (and, for the FWHT, the Kronecker matmul
   formulation of the TPU kernel as a yardstick); then hold the
   flash-attention forward within the reference's tolerances for
   its own kernel (f32: atol = rtol = 2e-3 on o; bf16: atol 3e-2 on o;
   lse within 1e-3) against its plain blockwise version and the full-softmax
   oracle, at (1, 256, 4/2, 64) causal and not, a window of 128, q_offset
   256 (Sq 128, Sk 512), the bf16 kernel's tile edges (ragged S = 1000 at
   hd 128 and 64, S = 100, a window of 200 across 128-key tiles, q_offset
   200 with Sk 512; g = 4 and 1), (1, 8192, 32/8, 128) bf16, the training
   path's (1, 4096, 32/8, 128) and the serving path's (8, 2048, 32/8, 128)
   bf16 causal, the hybrid's 32,768-token prompt (1, 32768, 32/8, 128)
   against the plain version only (its full-softmax oracle would take
   137 GB), and at hd 32 (lm-8m: ragged S = 1000, a window of 200, q
   offset 200, S = 100 not causal, and the training example's one rank,
   (4, 128, 8/4, 32)), and at hd 16 (the smoke configs: the same edges, one
   rank of the training CLI's smoke run, (4, 128, 4/2, 16), and the serving
   example's prefill, (4, 16, 4/2, 16)); at the training, serving, example,
   CLI and serving-example shapes time the kernel and
   ``F.scaled_dot_product_attention`` (the library yardstick), with TFLOP/s
   and the share of the bound, and at the serving, example, CLI,
   serving-example and 32k shapes the plain version too; then hold the
   flash-attention backward kernels (dK/dV and dQ sweeps) against the plain
   blockwise backward on the same inputs (f32: |Δ| ≤ 2e-3 + 2e-3·|ref|;
   bf16: ‖Δ‖/‖ref‖ ≤ 2e-4 for each of dq, dk, dv) at g = 4 and 1, causal and
   not, a window, a q offset, ragged S = 1000, hd 64 and 128, the bf16
   kernels' tile edges (ragged S = 1000 at hd 64 with g = 1, a window of 200
   across 128-key tiles, S = 100, q_offset 200 with Sk 512), the same
   edges at hd 32 and 16, the training path's (1, 4096, 32/8, 128) bf16
   causal, the training example's (4, 128, 8/4, 32) and the training CLI's
   (4, 128, 4/2, 16), where kernels, plain sweeps and SDPA's backward are
   timed; kernels 11–13 at hd 120 (h2o-danube-3-4b, 32/8 heads, on the
   hd-128 tiles) at (1, 1024) causal and with a window of 200, ragged
   tiles with q_offset 200 (Sq 1000, Sk 1200), in both dtypes, timed at the
   serving prefill (8, 4080), one rank's training sequence (1, 4096) and
   the 32,768-token prompt with the window of 4096 (SDPA with a boolean
   mask there), and kernel 11 at minitron's 24/8 and mistral's 96/8 heads;
   then hold the hash-PRNG encoders
   (kernel 14, the dense Bernoulli encode, and kernel 15, binary
   quantization with its packing) bit-equal to their plain versions at
   ``SIZES`` and at the embed bucket, f32 and bf16, aligned and not, with
   Δ = 0 and the vmin padding of a ragged length, and time them there; and
   check that the decodes divide by n exactly: one round of each of
   ``DIVIDE_CASES`` at n = 3 on the card equals the CPU's bit for bit, and
   two error-feedback rounds of each of ``EF_CASES`` (the five ``ef_*``
   presets, ``fixed_k_1bit`` + EF) from the same nonzero residuals give the
   same estimates and residuals on both; and that the robust decode does
   not depend on the device (``check_robust``, n = 3 and 8): each gather
   preset under trim(1), median, mean_trim(1) and the masked mean, with a
   dropped peer and with each Byzantine row mode, ``fixed_k_1bit`` and the
   ``ef_*`` presets with a mask, and ``reduce_rows`` over ±0.0, ±NaN and
   ±Inf columns with the mask on the card under the sync debug mode
   "error" (no host sync); and the §11 hierarchical rounds on
   ``StackedComm(mesh=...)`` at (pod 4, data 2) and (pod 2, data 3)
   (``check_hierarchical``: ``HIER_CASES``, the trimmed one also with a
   dropped cross-host peer, and ``ef_bernoulli`` over 3 rounds) card ==
   CPU bit for bit, with the pod-axis bytes equal to the wire bits at
   n_eff; kernel 3 at n_in = 2 and 3 shards of ragged d against its plain
   version (``check_inner_shards``).  Every collective here and below runs
   on ``StackedComm``, the ranks stacked on the card: the link is
   simulated, and ``DistComm`` (one rank per process) is not run on the
   card;
3. the sync path: ``sync_grads_bucketed`` over the qwen3-4b gradient tree
   (full width, 4 of 36 layers, 792,657,920 compressed coordinates per
   rank) on ``StackedComm(8, "cuda")`` for each preset of
   ``train/synthetic.py`` (``fixed_k_1bit``, ``bernoulli_seed_1bit``,
   ``binary_packed``, ``ternary_packed``, ``ternary_opt``,
   ``rotated_binary``, ``rotated_fixed_k``), 3 steps each
   (keys ``fold_in(PRNGKey(0), step)``), then one step each of the
   flat-decode Bernoulli round and of the dense simulation (Bernoulli 1/16
   encoder), with synthetic seeded gradients.  Checks the kernel launch
   counts per bucket against each codec's table (``expected_launches``),
   finiteness, the bytes handed to the communicator against the accounting,
   and the squared error against the codec's closed-form MSE (``closed_form``,
   within 10%); then the five ``ef_*`` presets (``EF_PRESETS``), 3 steps
   each, the residuals carried (8 × 792,657,920 f32 beside the gradients):
   launches per bucket (``ef_expected_launches``), finiteness, bytes against
   the accounting (the inner preset's), and the telescoping identity
   Σ_t est_t = Σ_t x̄_t − ē_T within ``TELESCOPE_RTOL`` (the twins are biased
   contractive messages: no closed-form MSE applies); then the hierarchical
   sync: ``hier_fixed_k`` and ``hier_bernoulli`` unflattened on
   ``synthetic.HIER_MESH`` = (pod 4, data 2), 3 steps each: launches per
   bucket at n_eff = 4 packs and n_in = 2 shard decodes, the bytes handed
   to the pod axis against ``bucket_wire_bits(..., mesh_sizes)``, the
   squared error over the pod means within 10% of the closed form at n_eff
   = 4, sync ms and the inner (in-pod) MB;
4. the serving path: qwen3-4b at all 36 layers and full width, parameters
   drawn from a seed and cast to bf16, 8 prompts of 2048 seeded tokens:
   ``engine.generate`` (``build_serve_fns`` → prefill → 32 greedy decode
   steps) with 36 flash-attention launches per prefill; finite logits; a
   teacher-forced decode of positions 2048..2079 against one forward over
   the 2080 tokens, and the flash prefill against the ``attn_impl="xla"``
   one (``SERVE_TOL``); prefill ms, decode ms per token, tokens/s, peak
   memory;
4b. serving the MoE family (``run_serving_moe``): olmoe-1b-7b at all 16
   layers and full width (6,919,096,320 parameters, bf16), then
   qwen2-moe-a2.7b at full width and 4 of 24 layers with its shared
   experts, as phase 4 (8 prompts of 2048 seeded tokens, 32 greedy steps,
   one flash launch a layer per prefill); the teacher-forced check on one
   prompt at capacity factor E/k (nothing dropped: the block drops pairs
   past its capacity, the decode never does); flash against
   ``attn_impl="xla"`` over every prompt position; each comparison on the
   first computation's routes (the second one's rerouted share per layer
   printed: routing is discrete and a random-init MoE model amplifies one
   rerouted token layer by layer); two flash forwards bit-equal; the share
   of (token, choice) pairs dropped per layer at the configured factor
   1.25;
4c. serving the SSM family (``run_serving_ssm``): mamba2-130m whole (24
   layers, full width, 128,940,480 parameters drawn from a seed): one
   2048-token prompt's forward in f32 compute on the card against the same
   code on the CPU (``SSM_F32_H_RTOL``, ``SSM_F32_LOGIT_TOL``); then in
   bf16 one prompt teacher-forced for 256 decode steps against one forward
   over 2304 tokens (the chunked scan against the decode recurrence, the
   serving tolerances); ``engine.generate`` on 8 prompts of 2048 seeded
   tokens with 32 greedy steps (no kernel: the family has no attention),
   finite logits, the cache's bytes (19,132,416 a sequence: the conv
   windows in bf16 and the f32 states, whatever the prompt's length); one
   prompt of 32,768 tokens (the reference's prefill_32k length) at batch 1,
   its cache the same bytes a sequence; prefill ms, decode ms per token,
   tokens/s, peaks;
4d. serving the hybrid family (``run_serving_hybrid``): first the smoke
   hybrid at two periods (``num_layers=8``) in f32 compute on the card
   against the CPU, on the card's routes (phase 4c's ``SSM_F32_H_RTOL``,
   ``SSM_F32_LOGIT_TOL``); then jamba-v0.1-52b at full width, one of its
   four periods (8 of 32 layers, 13,267,598,848 parameters drawn in f32 and
   cast to bf16 leaf by leaf): the teacher-forced check on one prompt at
   capacity factor E/k, ``engine.generate`` on 8 prompts of 2048 seeded
   tokens with 32 greedy steps (one flash launch per prefill: the period's
   one attention layer), the cache's bytes against the exact count (the
   attention K/V at s_max, the 7 mixers' windows and states), flash against
   ``attn_impl="xla"`` on flash's routes (the rerouted share per MoE layer
   printed), one 32,768-token prompt at batch 1 (its flash launch, its
   cache's bytes, its peak); prefill ms, decode ms per token, tokens/s,
   peaks;
4e. serving the encoder-decoder family (``run_serving_encdec``): first the
   smoke whisper (2 + 2 layers) in f32 compute on the card against the CPU,
   encoder output and decoder states (phase 4c's limits); then
   whisper-medium whole (24 + 24 layers, full width, 757,877,760
   parameters drawn in f32 and cast to bf16): one prompt teacher-forced for
   64 decode steps against one forward over 2112 tokens in 704-token
   chunks (the serving tolerances), ``engine.generate`` on 8 prompts of 2048
   seeded tokens, each with 1536 seeded frames, 32 greedy steps (no kernel:
   the family's attention is the plain chunked softmax, as the
   reference's), the cache's bytes (2,843,738,112: the self K/V at s_max
   2080 and the cross K/V at 1536 frames, bf16), then the prefill again
   beside the encoder alone; prefill ms and the encoder's, decode ms per
   token, tokens/s, peaks;
4f. serving the VLM family (``run_serving_vlm``): first the smoke llava (2
   layers, 8 patches) in f32 compute on the card against the CPU (phase
   4c's limits; kernel 11's f32 path at hd 16 on the card); then
   llava-next-34b at full width, 20 of its 60 layers (12,126,026,752
   parameters drawn in f32 and cast to bf16 leaf by leaf; kernel 11 at 56/8
   heads, g = 7): one teacher-forced decode of 32 tokens after the 1152
   patches and 896 tokens of each prompt against one forward over the 2080
   positions, ``engine.generate`` on 8 prompts of 1152 seeded patch
   embeddings and 896 seeded tokens with 32 greedy steps from position
   2048 (one flash launch a layer per prefill), the cache's bytes
   (1,363,148,800), the flash prefill against ``attn_impl="xla"`` (the
   serving tolerances); prefill ms, decode ms per token, tokens/s, peaks;
4g. the reference's last three dense configs (``run_serving_dense``):
   minitron-4b whole and mistral-large-123b at full width and 8 of its 88
   layers through ``run_serving`` (phase 4's checks: teacher-forced decode,
   ``engine.generate``, the cache's shape, flash against xla; the LM head's
   time in a decode step), then h2o-danube-3-4b whole (hd 120, window
   4096): 8 prompts of 4080 tokens whose 32 decoded tokens wrap the
   4096-slot ring, held against one forward over 4112 tokens, and one
   32,768-token prompt at batch 1 (``run_serving_long_window``: all 32,768
   slots kept, 3,019,898,880 B; 4 greedy tokens; flash against xla on the
   first 4 layers);
5. the training path (``train/synthetic.py::train_main_path``): qwen3-4b at
   full width and 4 layers, 8 ranks stacked, one 4096-token sequence each,
   ``fixed_k_1bit``.  Step 0's rank-0 loss and gradients with the flash
   kernels, every flash call held against the plain blockwise version in
   64 × 64 tiles on its own inputs; the whole model's
   gradients against the plain flash and against ``attn_impl="xla"``
   (``TRAIN_LOSS_RTOL``, ``TRAIN_GRAD_TOL``), and in f32 compute against
   the plain flash (``TRAIN_F32_LOSS_RTOL``, ``TRAIN_F32_GRAD_TOL``); then
   ``Trainer.fit`` for 4 steps under the backward-pipelined bucket sync
   (the reference's default schedule): finite losses and norms, the
   launches of every phase of every step (flash forward 2·L·n with remat,
   each backward sweep L·n, the fixed-k gathers per bucket: in the
   backward, where the sync points launch them),
   the communicator's bytes against the accounting, the sync's error over
   the stacked real gradients against the closed form (within 10%), step
   ms split into forward+backward, sync and optimizer, tokens/s, peak
   memory; then, the first run's state freed, ``Trainer.fit`` for 4 steps
   with ``fixed_k_1bit`` + error feedback (the reference example's default)
   at the same shape: finite losses, norms and residuals, the bytes, each
   bucket's residual norm after step 3 at most twice that after step 1,
   the step's split and the peak; then the multi-pod run
   (``run_training_multipod``): ``Trainer.fit`` for 4 steps on (pod 2,
   data 4) with ``get_run_config("qwen3-4b", "train_4k", multi_pod=True)``
   (``fixed_k_1bit`` over ``pod``, the exact mean in each pod; cut to 4
   layers, batch 8, one microbatch): finite losses and norms, the launches,
   the bytes against the accounting at n_eff = 2, the error over the pod
   means against ``mse_fixed_k_shared``, the step's split and the peak;
   then the training example as a user runs
   it (``examples/train_lm_compressed.py``: lm-8m, 8 ranks, the exact mean
   and ``fixed_k_1bit`` + error feedback, 4 steps each), its attention on
   the hd-32 flash kernels (L·n launches of each a step), losses, norms
   and residuals finite.  Checkpoint and restart at full width
   (``run_restart``, after the first run): in a temporary directory,
   ``Trainer(steps=2, ckpt_every=2)`` then ``Trainer(steps=4,
   ckpt_every=3)`` from it, the end state bit for bit against the first
   run's (parameters, m, v, step, the losses of steps 2–3), with the bytes
   of a checkpoint, each save's and the restore's ms and the step that
   overlaps an asynchronous save against those that do not.  The training
   CLI (``launch/train.py --smoke --devices 4 --steps 4 --ckpt-every 2``,
   then ``--steps 6``, resuming at step 4; kernels 11–13 at hd 16 and 4;
   then the same with ``--arch jamba-v0.1-52b`` (``run_cli_arch``: the
   hybrid smoke config, one attention layer; its losses within
   ``CLI_CPU_LOSS_RTOL`` of the same run on the CPU from the same drawn
   parameters; with ``--no-compress`` a resumed run bit for bit an
   uninterrupted one's checkpoint and losses), and with ``--arch
   llava-next-34b`` (the smoke VLM, 8 patches a sequence) the same
   (``run_cli_arch`` runs both) and the serving example
   (``examples/serve_lm.py``: tokens in range, kernel 11 at hd 16 once a
   layer).  5b: the MoE training path
   (``run_training_moe``, ``synthetic.moe_train_path``): olmoe-1b-7b at full
   width and 2 of 16 layers, 8 ranks of one 4096-token sequence stacked,
   ``get_run_config("olmoe-1b-7b", "train_4k")`` (``fixed_k_1bit``) with
   one microbatch: step 0's rank-0 loss and gradients with the kernels
   against ``attn_impl="xla"`` (phase 5's limits; where a token's routes
   differ, the xla run repeated on the flash run's routes), then
   ``fit_and_check`` for 2 steps and its post-backward twin, the states
   bit-equal after each step, the aux loss finite and nonzero.  5c: the SSM
   training path (``run_training_ssm``, ``synthetic.ssm_train_path``):
   mamba2-130m whole (24 layers), 8 ranks of one 4096-token sequence
   stacked, ``get_run_config("mamba2-130m", "train_4k")`` as it is
   (``fixed_k_1bit``, one microbatch): step 0's rank-0 loss and gradients
   in bf16 against f32 compute (``SSM_GRAD_TOL``, ``SSM_LOSS_RTOL``), then
   ``fit_and_check`` for 4 steps (kernel 4 n times a compressed bucket, no
   flash kernel) and its post-backward twin, bit-equal after steps 0 and
   1.  5d: the encoder-decoder training path (``run_training_encdec``,
   ``synthetic.encdec_train_path``): whisper-medium whole (24 + 24 layers),
   8 ranks of one 4096-token sequence and its 1536 frames stacked,
   ``get_run_config("whisper-medium", "train_4k")`` as it is
   (``fixed_k_1bit``, one microbatch, remat): step 0's rank-0 loss and
   gradients in bf16 against f32 compute (``ENCDEC_GRAD_TOL``,
   ``ENCDEC_LOSS_RTOL``), then ``fit_and_check`` for one step (kernel 4 n
   times on each of the 17 compressed buckets, no flash kernel) and its
   post-backward twin, bit-equal after it.  5e: the VLM training path
   (``run_training_vlm``, ``synthetic.vlm_train_path``): llava-next-34b at
   full width and 1 of 60 layers, 4 ranks of one 4096-position sequence
   (1152 patches, 2944 tokens) stacked, ``get_run_config("llava-next-34b",
   "train_4k")`` with FSDP off and one microbatch (``fixed_k_1bit``,
   remat): step 0's rank-0 loss and gradients in bf16 against f32 compute,
   ``patch_proj``'s among them (``VLM_GRAD_TOL``, ``VLM_LOSS_RTOL``), then
   ``fit_and_check`` for two steps (kernels 11–13 at 56/8 heads, 2·L·n and
   L·n launches, kernel 4 n times a compressed bucket) and its
   post-backward twin, bit-equal after each.  5f: the sliding-window
   training path (``run_training_window``, ``synthetic.window_train_path``):
   h2o-danube-3-4b at full width and 4 of 24 layers, 8 ranks of one
   4096-token sequence stacked, ``get_run_config("h2o-danube-3-4b",
   "train_4k")`` with one microbatch: step 0's rank-0 bf16 step with every
   kernel call (kernels 11–13 at hd 120) held against the plain version,
   the f32 kernels against the plain flash per leaf, bf16 against f32;
   then ``fit_and_check`` for two steps and its post-backward twin,
   bit-equal after each.  5g: FSDP over ``data`` on the stacked ranks
   (``synthetic.fsdp_train_path``: qwen2-moe-a2.7b at full width, 4 ranks
   of one 4096-token sequence, the reference's FSDP run config with one
   microbatch): at 1 layer one step with FSDP on and one off from the same
   draw, compression none (``run_fsdp_identities``: the unsharded leaves'
   synced gradients bit-equal, each FSDP leaf's within 2⁻⁹ of n × the
   exact mean); then at 4 layers ``fit_and_check`` for two steps
   (``run_training_fsdp``: kernels 11–13 at 16/16 heads, kernel 4 n times
   a compressed bucket, the FSDP rank sum's ms and bytes, the peak, the
   end state's digest by rank shard).  5h: FSDP with a pod axis, the
   reference's multi-pod run of its FSDP archs, stacked
   (``synthetic.multipod_fsdp_train_path``: qwen2-moe-a2.7b at full width
   on (pod 2, data 2), ``get_run_config(..., multi_pod=True)`` with one
   microbatch): at 1 layer FSDP on against off under compression none
   (``run_fsdp_identities(mesh)``: the unsharded leaves bit-equal, each
   FSDP leaf within 2⁻⁹ of n_data × the exact mean); then at
   ``MULTIPOD_FSDP_LAYERS`` ``fit_and_check`` for two steps under
   ``fixed_k_1bit`` over pod (``run_training_multipod_fsdp``: kernel 4
   n_pod times a bucket of the other leaves and n_pod × n_data times an
   FSDP shard bucket, each data coordinate's round on its own shard;
   kernels 11–13 2·L·n and L·n times; the pod-axis bytes of both kinds of
   bucket against their accounting at n_eff = 2; the error over the closed
   form per data coordinate; the pod sums' ms; the peak; the end state's
   digest by data shard).  The training, error-feedback and
   multi-pod runs are each followed by a post-backward twin
   (``run_twin``: ``TWIN_STEPS`` steps from the same start with
   ``BucketSpec.overlap = False``), held bit for bit to the overlapped
   run's first steps (parameters, m, v and residuals by
   ``step_report.state_digest``; losses and norms); a line per cell sets
   the schedules side by side: each bucket's issue order and its issue
   and end against the backward's end beside ``plan.schedule()``, the
   exposed sync ms, the step ms, the peaks and the allocator's calls;
6. the encode path (``launch/bench_encode_speed.py``: kernels 14 and 15,
   the fixed-k gather and the FWHT at d = 2^16, 2^20, 2^24 and the
   388,956,160-coordinate embed bucket) and the single-host stack:
   ``MeanEstimator.estimate`` and ``empirical_mse`` on the card for the
   quickstart's seven protocols at n = 16, d = 2^22, budget d, 4 rounds
   each, the squared error within 10% of ``expected_mse`` (the identity's
   exactly 0) and the measured bits equal to ``expected_bits`` (within 1%
   for the Bernoulli protocols, whose support size is random); then the
   federated example's straggler round at n = 32, d = 2^20, each error
   within 10% of its closed form;
7. robust decode and fault tolerance (``run_robust``): one
   ``compressed_mean`` round at the embed bucket (n = 8, d = 388,956,160)
   of ``bernoulli_seed_1bit``, ``binary_packed`` and ``rotated_binary``
   under the mean and under trim(1): finite, the same wire bytes, trim(1)'s
   launches (one unpack, kernel 2 or 6, a peer row), its error within
   ``mse_trimmed``'s bound, the ``decode_rows`` stack and the reduction
   timed apart; ``robust_compressed_mean`` with ``FailurePlan(rate=0.25)``
   over 3 steps, each equal bit for bit to a survivors-only rerun; one
   bucketed sync of phase 3's tree under ``robust_preset("binary_packed",
   "trim(1)")``.

Then one JSON line with every kernel's numbers and, last, the device line.
Exits nonzero, and prints no result, when there is no CUDA card, when the
port's package is not beside this script, or when any check fails.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import math
import pathlib
import subprocess
import sys
import time
import types
from typing import Optional, Tuple

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

SIZES = (70_001, 16_777_217)
STEPS = 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# 32-bit integer rate: the data sheet's 67 TFLOP/s float32 is 132 SMs x 128
# FP32 lanes x 2 flops (one FMA) x 1.98 GHz; the H100 architecture white
# paper gives each SM 64 INT32 lanes, so 132 x 64 x 1.98 GHz = 67e12 / 4.
INT32_OPS_PER_S = 67e12 * 64 / (128 * 2)
# float32 adds and multiplies that are not fused: one per FP32 lane and clock
F32_OPS_PER_S = 67e12 / 2
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores, NVIDIA data sheet
# the least integer work of one Threefry-2x32 cipher call: 2 key adds, 20
# rounds of (add, funnel-shift rotate, xor), 5 key injections of one add on
# each word (csrc/threefry.cuh); counter words and mantissa fill not counted.
# One call yields the bits of two coordinates of a full-length draw (j and
# j + ceil(d/2)), so a full draw needs ceil(d/2) calls; a shard window's
# coordinates pair with coordinates of other shards and need one call each.
OPS_PER_CALL = 72
# the hash PRNG of kernels 14-15 (csrc/prng.cuh): 3 multiplies, 1 add, 3
# shifts, 3 xors, the top-24-bit shift and conversion, the index: 13 integer
# operations a coordinate.  One IEEE f32 division is a reciprocal, its
# refinement and a residual correction: counted as 6 f32 operations.
HASH_OPS = 13
F32_DIV_OPS = 6

REPLACES = {
    "bernoulli_encode": "src/repro/kernels/bernoulli_wire/kernel.py:184",
    "bernoulli_encode_unscaled": "src/repro/kernels/bernoulli_wire/kernel.py:184",
    "bernoulli_decode_sum": "src/repro/kernels/bernoulli_wire/kernel.py:248",
    "bernoulli_unpack": "src/repro/kernels/bernoulli_wire/kernel.py:248",
    "bernoulli_support_counts": "src/repro/kernels/bernoulli_wire/kernel.py:336",
    "bernoulli_decode_sum_shard": "src/repro/kernels/bernoulli_wire/kernel.py:336",
    "fixed_k_gather": "src/repro/kernels/fixed_k_encode/fixed_k_encode.py:39",
    "bitplane_pack": "src/repro/kernels/bitplane/bitplane.py:53",
    "bitplane_unpack": "src/repro/kernels/bitplane/bitplane.py:109",
    "bitplane_binary_accum": "src/repro/kernels/bitplane/bitplane.py:92",
    "fwht": "src/repro/kernels/hadamard/hadamard.py:57",
    "rotate_minmax": "src/repro/kernels/rotated_encode/kernel.py:70",
    "encode_pack": "src/repro/kernels/rotated_encode/kernel.py:121",
    "flash_attention_fwd": "src/repro/kernels/flash_attention/flash_attention.py:121",
    "flash_attention_bwd_dkv": "src/repro/kernels/flash_attention/flash_attention.py:280",
    "flash_attention_bwd_dq": "src/repro/kernels/flash_attention/flash_attention.py:318",
    "flash_attention_fwd_hd32": "src/repro/kernels/flash_attention/flash_attention.py:121",
    "flash_attention_bwd_dkv_hd32": "src/repro/kernels/flash_attention/flash_attention.py:280",
    "flash_attention_bwd_dq_hd32": "src/repro/kernels/flash_attention/flash_attention.py:318",
    "flash_attention_fwd_hd16": "src/repro/kernels/flash_attention/flash_attention.py:121",
    "flash_attention_bwd_dkv_hd16": "src/repro/kernels/flash_attention/flash_attention.py:280",
    "flash_attention_bwd_dq_hd16": "src/repro/kernels/flash_attention/flash_attention.py:318",
    "flash_attention_fwd_hd120": "src/repro/kernels/flash_attention/flash_attention.py:121",
    "flash_attention_bwd_dkv_hd120": "src/repro/kernels/flash_attention/flash_attention.py:280",
    "flash_attention_bwd_dq_hd120": "src/repro/kernels/flash_attention/flash_attention.py:318",
    "bernoulli_encode_2d": "src/repro/kernels/bernoulli_encode/bernoulli_encode.py:53",
    "binary_encode_2d": "src/repro/kernels/binary_quant/binary_quant.py:54",
}
SOURCE = {
    "bernoulli_encode": "src/repro_torch/csrc/bernoulli_wire.cu",
    "bernoulli_encode_unscaled": "src/repro_torch/csrc/bernoulli_wire.cu",
    "bernoulli_decode_sum": "src/repro_torch/csrc/bernoulli_wire.cu",
    "bernoulli_unpack": "src/repro_torch/csrc/bernoulli_wire.cu",
    "bernoulli_support_counts": "src/repro_torch/csrc/bernoulli_wire.cu",
    "bernoulli_decode_sum_shard": "src/repro_torch/csrc/bernoulli_wire.cu",
    "fixed_k_gather": "src/repro_torch/csrc/fixed_k_encode.cu",
    "bitplane_pack": "src/repro_torch/csrc/bitplane.cu",
    "bitplane_unpack": "src/repro_torch/csrc/bitplane.cu",
    "bitplane_binary_accum": "src/repro_torch/csrc/bitplane.cu",
    "fwht": "src/repro_torch/csrc/hadamard.cu",
    "rotate_minmax": "src/repro_torch/csrc/rotated_encode.cu",
    "encode_pack": "src/repro_torch/csrc/rotated_encode.cu",
    "flash_attention_fwd": "src/repro_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_dkv": "src/repro_torch/csrc/flash_attention_bwd.cu",
    "flash_attention_bwd_dq": "src/repro_torch/csrc/flash_attention_bwd.cu",
    "flash_attention_fwd_hd32": "src/repro_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_dkv_hd32": "src/repro_torch/csrc/flash_attention_bwd.cu",
    "flash_attention_bwd_dq_hd32": "src/repro_torch/csrc/flash_attention_bwd.cu",
    "flash_attention_fwd_hd16": "src/repro_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_dkv_hd16": "src/repro_torch/csrc/flash_attention_bwd.cu",
    "flash_attention_bwd_dq_hd16": "src/repro_torch/csrc/flash_attention_bwd.cu",
    "flash_attention_fwd_hd120": "src/repro_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_dkv_hd120": "src/repro_torch/csrc/flash_attention_bwd.cu",
    "flash_attention_bwd_dq_hd120": "src/repro_torch/csrc/flash_attention_bwd.cu",
    "bernoulli_encode_2d": "src/repro_torch/csrc/bernoulli_encode.cu",
    "binary_encode_2d": "src/repro_torch/csrc/binary_quant.cu",
}


class CheckFailed(RuntimeError):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def setup():
    """Import torch and the port; fail without a card or without the port."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        raise SystemExit(f"chip_smoke: the port's package is missing under {SRC}")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    need(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean device time of one call, by CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, int_ops: float, f32_ops: float):
    """(least time in ms, what bounds it) for the given bytes, int32 and
    float32 operations; the integer and float pipes run side by side."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = max(int_ops / INT32_OPS_PER_S, f32_ops / F32_OPS_PER_S) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def same_bits(a, b) -> bool:
    """Same shape, dtype and bits (floats compared as their bit patterns)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        w = torch.int32 if a.element_size() == 4 else torch.int16
        return torch.equal(a.contiguous().view(w), b.contiguous().view(w))
    return torch.equal(a, b)


def record(records: dict, name: str, err, ms, plain_ms, nbytes, int_ops, f32_ops) -> None:
    """One kernel's numbers at the main path's largest shape."""
    b, by = bound_ms(nbytes, int_ops, f32_ops)
    records[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b, "bound_by": by, "library_ms": None}


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


# --------------------------------------------------------------------------- #
# Phase 1: what the compiler made of kernels 11–13.
# --------------------------------------------------------------------------- #

# The Hopper (TMA + wgmma) kernels phase 1 inspects, by source: each at hd 16,
# 32, 64, 120 and 128, with the C function that reports its dynamic shared
# memory.
CUBIN_HEAD_DIMS = (16, 32, 64, 120, 128)
CUBIN_KERNELS = {"flash_attention": {"fa_fwd_wgmma": ("fa_fwd_smem_bytes",)},
                 "flash_attention_bwd": {"fa_bwd_dkv_wgmma": ("fa_bwd_smem_bytes", 0),
                                         "fa_bwd_dq_wgmma": ("fa_bwd_smem_bytes", 1)}}


def start_flash_cubins():
    """``nvcc -Xptxas -v`` of kernels 11–13's sources into cubins, started
    beside phase 1's build; returns {source: (process, cubin path)}."""
    from repro_torch.kernels import backend

    procs = {}
    backend.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for src in CUBIN_KERNELS:
        cubin = backend.BUILD_DIR / f"{src}.cubin"
        cmd = [backend.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xptxas", "-v", "-cubin", "-I", str(backend.CSRC), "-o", str(cubin),
               str(backend.CSRC / f"{src}.cu")]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), cubin)
    return procs


def check_flash_cubins(procs) -> None:
    """Each bf16 kernel of ``CUBIN_KERNELS`` at hd 16, 32, 64, 120 and 128: registers and
    spills (none allowed) as ptxas reports them, its dynamic shared memory,
    and its SASS holding ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA loads), by
    ``cuobjdump -sass``."""
    import ctypes
    from repro_torch.kernels import backend

    for src, (proc, cubin) in procs.items():
        log, _ = proc.communicate()
        need(proc.returncode == 0, f"nvcc -Xptxas -v of {src}.cu failed:\n{log}")
        props, name = {}, None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
            elif name and ("spill" in line or "Used" in line):
                props.setdefault(name, []).append(line.split(":", 1)[-1].strip())
        sass = subprocess.run([str(pathlib.Path(backend.nvcc_path()).parent / "cuobjdump"),
                               "-sass", str(cubin)], capture_output=True, text=True, check=True)
        counts, name = {}, None
        for line in sass.stdout.splitlines():
            if "Function :" in line:
                name = line.split("Function :")[1].strip()
                counts[name] = collections.Counter()
            elif name:
                for op in ("HGMMA", "UTMALDG", "UTMASTG"):
                    counts[name][op] += op in line
        for kernel, (smem_fn, *smem_args) in CUBIN_KERNELS[src].items():
            smem = getattr(backend.lib(src), smem_fn)
            smem.argtypes = [ctypes.c_int64] + [ctypes.c_int] * len(smem_args)
            smem.restype = ctypes.c_int
            found = sorted(n for n in props if kernel in n)
            need(len(found) == len(CUBIN_HEAD_DIMS),
                 f"expected {kernel} at hd {CUBIN_HEAD_DIMS} in ptxas' report: {found}")
            for n in found:
                hd = next(h for h in CUBIN_HEAD_DIMS if f"ILi{h}E" in n)
                need(" 0 bytes spill stores, 0 bytes spill loads" in " ".join(props[n]),
                     f"{kernel}<{hd}> spills: {props[n]}")
                c = counts.get(n, {})
                need(c.get("HGMMA", 0) > 0 and c.get("UTMALDG", 0) > 0,
                     f"{kernel}<{hd}>: no HGMMA or UTMALDG in its SASS ({dict(c)})")
                print(f"  {kernel}<{hd}>: {'; '.join(props[n])}; dynamic shared memory "
                      f"{smem(hd, *smem_args)} B; SASS: {c['HGMMA']} HGMMA, {c['UTMALDG']} "
                      f"UTMALDG, {c['UTMASTG']} UTMASTG", flush=True)


# --------------------------------------------------------------------------- #
# Phase 2: every kernel against its plain version.
# --------------------------------------------------------------------------- #

def _keys(seed: int, n: int):
    import torch
    from repro_torch import random as R

    base = R.PRNGKey(seed)
    return torch.stack([R.fold_in(base, i) for i in range(n)])


def check_kernels(sizes, main_d: int, main_shard: int, records: dict) -> None:
    """Bit-equality of each kernel wrapper with its plain version on the
    card; ``records`` gets each kernel's error, times and bound at the
    largest shape checked (the main path's)."""
    import torch
    from repro_torch import random as R
    from repro_torch.core import comm_cost
    from repro_torch.kernels.bernoulli_wire import kernel as bwk
    from repro_torch.kernels.bernoulli_wire import ref as bwr
    from repro_torch.kernels.fixed_k_encode import fixed_k_encode as fkk
    from repro_torch.kernels.fixed_k_encode import ref as fkr
    from repro_torch.train.synthetic import N

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)

    cases = [(d, 1.0 / 16, None) for d in sizes]
    cases.append((sizes[0], 1.0 / 16, 100))      # forced small cap: overflow drops
    cases.append((sizes[0], 0.3, None))          # 1/p not a power of two
    # the encode's pair chunks (j, j + ceil(d/2)) at ragged halves: one pair,
    # a partial last low chunk, a high chunk of one coordinate, a small cap
    cases += [(2, 1.0 / 16, None), (2047, 0.5, None), (2049, 0.5, None),
              ((1 << 21) + 3, 1.0 / 16, 5000)]
    cases.append((main_d, 1.0 / 16, None))       # the main path's largest bucket
    for d, p, cap in cases:
        cap = comm_cost.bernoulli_capacity(d, p) if cap is None else cap
        gen.manual_seed(d)
        flat = torch.randn(d, generator=gen, device=dev) * 0.5 + 0.1
        mu = flat.mean()
        key = R.fold_in(R.PRNGKey(7), 3)
        got = bwk.encode(flat, key, mu, p=p, cap=cap)
        want = bwr.encode(flat, key, p, cap, mu)
        need(same_bits(got, want), f"bernoulli_encode d={d} p={p} cap={cap}: kernel != plain")
        # the unscaled variant (the error-feedback twin) on x with −0.0
        # entries and μ < 0, where an emulation by 1/p = 1, c = 0 would
        # ship −0.0 as +0.0
        flat[1::3] = -0.0
        neg = -mu.abs() - 0.25
        got_u = bwk.encode(flat, key, neg, p=p, cap=cap, scaled=False)
        want_u = bwr.encode(flat, key, p, cap, neg, scaled=False)
        need(same_bits(got_u, want_u),
             f"bernoulli_encode_unscaled d={d} p={p} cap={cap}: kernel != plain")
        need(d < 8 or bool((got_u.view(torch.int32) == -2 ** 31).any()),
             f"bernoulli_encode_unscaled d={d}: no −0.0 shipped")
        tag = f"d={d} p={p:.4g} cap={cap}"
        if d == main_d:
            gen.manual_seed(d)
            flat = torch.randn(d, generator=gen, device=dev) * 0.5 + 0.1
            ms = cuda_ms(lambda: bwk.encode(flat, key, mu, p=p, cap=cap))
            pms = cuda_ms(lambda: bwr.encode(flat, key, p, cap, mu), reps=1)
            record(records, "bernoulli_encode", max_err(got, want), ms, pms,
                   4 * d + 4 * cap, OPS_PER_CALL * -(-d // 2), 2 * cap)
            ms_u = cuda_ms(lambda: bwk.encode(flat, key, neg, p=p, cap=cap, scaled=False))
            pms_u = cuda_ms(lambda: bwr.encode(flat, key, p, cap, neg, scaled=False), reps=1)
            record(records, "bernoulli_encode_unscaled", max_err(got_u, want_u), ms_u, pms_u,
                   4 * d + 4 * cap, OPS_PER_CALL * -(-d // 2), 0)
            tag += (f" kernel {ms:.3f} ms plain {pms:.3f} ms; unscaled kernel {ms_u:.3f} ms "
                    f"plain {pms_u:.3f} ms")
        print(f"  bernoulli_encode and bernoulli_encode_unscaled {tag}: bit-equal", flush=True)
        del flat, got, want, got_u, want_u

    # decode: random buffers exercise every rank/cap combination directly
    decode_cases = [(d, None, None) for d in sizes]
    decode_cases += [(sizes[0], 300, None), (main_d, None, main_shard)]
    for d, cap_override, shard_len in decode_cases:
        p = 1.0 / 16
        cap = comm_cost.bernoulli_capacity(d, p) if cap_override is None else cap_override
        gen.manual_seed(d + 1)
        bufs = torch.randn(N, cap, generator=gen, device=dev) * 0.7
        mus = torch.randn(N, generator=gen, device=dev) * 0.1
        keys = _keys(d, N)
        big = d == main_d
        if not big:
            got = bwk.decode_sum(bufs, mus, keys, p=p, cap=cap, d=d)
            want = bwr.decode_sum_sequential(bufs, mus, keys, p, cap, d)
            need(same_bits(got, want), f"bernoulli_decode_sum d={d} cap={cap}: kernel != sequential")
            print(f"  bernoulli_decode_sum d={d} cap={cap}: bit-equal", flush=True)
        else:
            got = bwk.decode_sum(bufs, mus, keys, p=p, cap=cap, d=d)
            want = bwr.decode_sum(bufs, mus, keys, p, cap, d)
            need(same_bits(got, want), f"bernoulli_decode_sum d={d}: kernel != plain")
            ms = cuda_ms(lambda: bwk.decode_sum(bufs, mus, keys, p=p, cap=cap, d=d))
            pms = cuda_ms(lambda: bwr.decode_sum(bufs, mus, keys, p, cap, d), reps=1)
            record(records, "bernoulli_decode_sum", max_err(got, want), ms, pms,
                   4 * N * cap + 4 * N + 4 * d, OPS_PER_CALL * N * -(-d // 2), N * d)
            print(f"  bernoulli_decode_sum d={d} n={N}: bit-equal, kernel {ms:.3f} ms "
                  f"plain {pms:.3f} ms", flush=True)
        del got, want

        # §12 shards: windows of ceil(d/N) straddle 1024-blocks; stitched
        # shards must equal the full decode, counts and bits the plain ones.
        ds = -(-d // N) if shard_len is None else shard_len
        shards = range(N) if not big else [N - 2]
        sups_k = {s: bwk.support_counts(keys, p=p, d=d, start=s * ds, ds=ds, device=dev)
                  for s in range(N)}
        sups_p = {s: bwr.support_counts(keys, p, d, s * ds, ds, dev) for s in shards}
        for s in shards:
            need(torch.equal(sups_k[s].counts, sups_p[s].counts)
                 and torch.equal(sups_k[s].mask, sups_p[s].mask),
                 f"bernoulli_support_counts d={d} shard {s}: kernel != plain")
        allc = torch.stack([sups_k[s].counts.sum(1, dtype=torch.int32) for s in range(N)])
        prior = torch.cumsum(allc, 0, dtype=torch.int32) - allc
        parts = []
        for s in shards:
            pk = bwk.decode_sum_shard(bufs, mus, sups_k[s], prior[s].contiguous(), cap=cap)
            pp = bwr.decode_sum_shard(bufs, mus, sups_p[s], prior[s].contiguous(), cap)
            need(same_bits(pk, pp), f"bernoulli_decode_sum_shard d={d} shard {s}: kernel != plain")
            parts.append(pk)
        if not big:
            full = torch.cat(parts)[:d]
            need(same_bits(full, bwr.decode_sum_sequential(bufs, mus, keys, p, cap, d)),
                 f"stitched shards d={d} cap={cap} != sequential decode")
            print(f"  bernoulli_support_counts + decode_sum_shard d={d} cap={cap}: "
                  f"{N} shards of {ds} bit-equal, stitched == sequential", flush=True)
        else:
            s = shards[0]
            sup = sups_k[s]
            pr = prior[s].contiguous()
            ms_c = cuda_ms(lambda: bwk.support_counts(keys, p=p, d=d, start=s * ds, ds=ds, device=dev))
            pms_c = cuda_ms(lambda: bwr.support_counts(keys, p, d, s * ds, ds, dev), reps=1)
            nck = sup.counts.shape[1]
            record(records, "bernoulli_support_counts", 0.0, ms_c, pms_c,
                   4 * N * nck + N * nck * 128, OPS_PER_CALL * N * ds, 0)
            ms_d = cuda_ms(lambda: bwk.decode_sum_shard(bufs, mus, sup, pr, cap=cap))
            pms_d = cuda_ms(lambda: bwr.decode_sum_shard(bufs, mus, sups_p[s], pr, cap), reps=1)
            kept = int(torch.clamp(cap - pr.long(), min=0).clamp(max=allc[s].long()).sum())
            record(records, "bernoulli_decode_sum_shard", max_err(parts[0], pp), ms_d,
                   pms_d, 4 * kept + N * nck * 128 + 4 * N * nck + 4 * N + 4 * ds, 0, N * ds)
            print(f"  bernoulli_support_counts + decode_sum_shard d={d} shard {s} "
                  f"ds={ds}: bit-equal, counts {ms_c:.3f} ms (plain {pms_c:.3f}), "
                  f"decode {ms_d:.3f} ms (plain {pms_d:.3f})", flush=True)
        del bufs, parts, sups_k, sups_p

    # the flat decode's pair chunks (j, j + ceil(d/2)) at ragged halves: odd
    # d, a partial last low chunk, a high chunk of one coordinate, n = 1, 3,
    # 8 and cap overflow; each equal to the sequential and the plain decode
    for d, n, p, cap in ((1, 1, 1 / 16, None), (2, 3, 1 / 16, None), (2047, 8, 0.5, None),
                         (2049, 3, 0.5, None), (70_001, 3, 1 / 16, 1000),
                         ((1 << 21) + 3, 8, 1 / 16, None)):
        cap = comm_cost.bernoulli_capacity(d, p) if cap is None else cap
        gen.manual_seed(d + 5)
        bufs = torch.randn(n, cap, generator=gen, device=dev)
        mus = torch.randn(n, generator=gen, device=dev)
        keys = _keys(d + 9, n)
        got = bwk.decode_sum(bufs, mus, keys, p=p, cap=cap, d=d)
        need(same_bits(got, bwr.decode_sum_sequential(bufs, mus, keys, p, cap, d))
             and same_bits(got, bwr.decode_sum(bufs, mus, keys, p, cap, d)),
             f"bernoulli_decode_sum d={d} n={n} p={p} cap={cap}: kernel != plain")
    print("  bernoulli_decode_sum at ragged halves (d = 1, 2, 2047, 2049, 70,001, 2^21 + 3; "
          "n = 1, 3, 8; cap overflow): bit-equal to the sequential and the plain decode",
          flush=True)
    del bufs, mus, got

    # the error-feedback twin's unpack: the flat decode at n = 1 from a −0.0
    # accumulator is one peer's reconstruction, −0.0 values and centers kept
    for d in (1, 2049, *sizes, main_d):
        p = 1.0 / 16
        cap = comm_cost.bernoulli_capacity(d, p)
        gen.manual_seed(d + 7)
        buf = torch.randn(cap, generator=gen, device=dev)
        buf[::2] = -0.0
        key = R.fold_in(R.PRNGKey(9), d % 5)
        for mu in (-0.0, 0.5):
            mus = torch.tensor([mu], device=dev)
            got = bwk.decode_sum(buf[None], mus, key[None], p=p, cap=cap, d=d, acc0=-0.0)
            need(same_bits(got, bwr.decode_one(buf, key, p, cap, mus, d)),
                 f"bernoulli unpack (decode at n = 1 from -0.0) d={d} mu={mu}: kernel != plain")
        if d == main_d:
            ms = cuda_ms(lambda: bwk.decode_sum(buf[None], mus, key[None], p=p, cap=cap, d=d,
                                                acc0=-0.0))
            pms = cuda_ms(lambda: bwr.decode_one(buf, key, p, cap, mus, d), reps=1)
            # one peer's buffer and center read, the d values written; one
            # full draw (ceil(d/2) cipher calls) and one add a coordinate
            record(records, "bernoulli_unpack", 0.0, ms, pms, 4 * cap + 4 + 4 * d,
                   OPS_PER_CALL * -(-d // 2), d)
            print(f"  bernoulli_unpack (decode at n = 1 from -0.0) d={d}: kernel {ms:.3f} ms, "
                  f"plain decode_one {pms:.3f} ms, bound "
                  f"{records['bernoulli_unpack']['bound_ms']:.3f} ms", flush=True)
        del buf, got
    print("  bernoulli unpack at d = 1, 2049, 70,001, 16,777,217 and the main d, mu = -0.0 "
          "and 0.5: bit-equal to decode_one", flush=True)

    for d in (*sizes, main_d):
        gen.manual_seed(d + 2)
        flat = torch.randn(d, generator=gen, device=dev)
        mu = flat.mean()
        nb = -(-d // fkr.BLOCK)
        kb = max(1, min(nb, round(nb / 16)))
        ids = fkr.sample_blocks(R.fold_in(R.PRNGKey(5), 1), nb, kb, dev)
        if int(ids[-1]) != nb - 1:             # include the ragged last block
            ids[-1] = nb - 1
        scale = nb * fkr.BLOCK / (kb * fkr.BLOCK)
        got = fkk.fixed_k_gather(flat, ids, scale, mu)
        padded = torch.nn.functional.pad(flat, (0, nb * fkr.BLOCK - d))
        want = fkr.fixed_k_encode(padded, ids, mu, scale)
        need(same_bits(got, want), f"fixed_k_gather d={d}: kernel != plain")
        tag = f"d={d} kb={kb}"
        if d == main_d:
            ms = cuda_ms(lambda: fkk.fixed_k_gather(flat, ids, scale, mu), reps=10)
            pms = cuda_ms(lambda: fkr.fixed_k_encode(padded, ids, mu, scale))
            k = kb * fkr.BLOCK
            record(records, "fixed_k_gather", max_err(got, want), ms, pms, 8 * k + 8 * kb, 0, 2 * k)
            tag += f" kernel {ms:.3f} ms plain {pms:.3f} ms"
        print(f"  fixed_k_gather {tag}: bit-equal", flush=True)
        del flat, padded, got, want


def check_bitplane(sizes, main_d: int, records: dict) -> None:
    """Bit-equality of the bit-plane kernels with their plain versions on
    the card: pack and unpack at every width (uint8 and int32 symbols, high
    bits above the field masked) and at the main path's plane shapes (w = 1
    binary, w = 2 ternary, at the embed bucket); the binary accumulate over
    8 peers' word windows, strided views of the gathered rows as the §13
    decode passes them, at the embed shard."""
    import torch
    from repro_torch.core import bitplane as cbp
    from repro_torch.core.wire import scatter_shard_len
    from repro_torch.kernels.bitplane import bitplane as bpk
    from repro_torch.kernels.bitplane import ref as bpr
    from repro_torch.train.synthetic import N

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)

    def bits32(shape):
        return torch.randint(-(1 << 31), 1 << 31, shape, generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)

    for d in sizes:
        gen.manual_seed(d + 3)
        sym32 = bits32((d,))
        for w in bpr.WIDTHS:
            syms = [sym32, (sym32 & 0xFF).to(torch.uint8), (sym32 & 0xFF).to(torch.uint8)[1:]]
            for sy in syms:
                need(same_bits(bpk.pack_bits(sy, w), bpr.pack_bits(sy, w)),
                     f"bitplane_pack d={sy.numel()} w={w} {sy.dtype}: kernel != plain")
            words = bpr.pack_bits(sym32, w)
            for ww, dd in ((words, d), (words[1:], d - 32 // w)):
                if dd < 1:
                    continue
                need(same_bits(bpk.unpack_bits(ww, w, dd), bpr.unpack_bits(ww, w, dd)),
                     f"bitplane_unpack d={dd} w={w}: kernel != plain")
        print(f"  bitplane_pack + unpack d={d}: every width, uint8/int32 symbols, "
              "unaligned starts: bit-equal", flush=True)
        del sym32, syms, words

    # the unpack's 16-byte items at its block edges (one block of 1024 items,
    # ± 1 symbol, ± 32/w, two blocks + 17), from 4-byte-aligned starts
    for w in bpr.WIDTHS:
        blk = 1024 * 16 // bpr.symbol_dtype(w).itemsize
        for d in (blk, blk - 1, blk + 1, blk - 32 // w, blk + 32 // w, 2 * blk + 17):
            words = bits32((bpr.num_words(d, w) + 3,))
            for ww in (words, words[1:], words[3:]):
                need(same_bits(bpk.unpack_bits(ww, w, d), bpr.unpack_bits(ww, w, d)),
                     f"bitplane_unpack d={d} w={w} at a block edge: kernel != plain")
    print("  bitplane_unpack at block edges, every width, unaligned starts: bit-equal",
          flush=True)

    # the main path's planes: the binary support (w = 1) and the ternary
    # branch symbols (w = 2) of the embed bucket, packed and unpacked
    unpack_ms = {}
    for w, hi in ((1, 2), (2, 3)):
        gen.manual_seed(main_d + w)
        sym = torch.randint(0, hi, (main_d,), generator=gen, device=dev, dtype=torch.uint8)
        got = bpk.pack_bits(sym, w)
        want = bpr.pack_bits(sym, w)
        need(same_bits(got, want), f"bitplane_pack d={main_d} w={w}: kernel != plain")
        ms = cuda_ms(lambda: bpk.pack_bits(sym, w), reps=10)
        pms = cuda_ms(lambda: bpr.pack_bits(sym, w), reps=1)
        nw = got.numel()
        if w == 2:
            record(records, "bitplane_pack", 0.0, ms, pms, main_d + 4 * nw, 2 * main_d, 0)
        print(f"  bitplane_pack d={main_d} w={w} (uint8 symbols): bit-equal, kernel {ms:.3f} ms "
              f"plain {pms:.3f} ms, bound {bound_ms(main_d + 4 * nw, 2 * main_d, 0)[0]:.3f} ms",
              flush=True)
        del want
        back = bpk.unpack_bits(got, w, main_d)
        need(torch.equal(back, sym), f"bitplane_unpack d={main_d} w={w}: round trip")
        need(same_bits(back, bpr.unpack_bits(got, w, main_d)),
             f"bitplane_unpack d={main_d} w={w}: kernel != plain")
        ms = cuda_ms(lambda: bpk.unpack_bits(got, w, main_d), reps=10)
        pms = cuda_ms(lambda: bpr.unpack_bits(got, w, main_d), reps=1)
        bound = bound_ms(4 * nw + main_d, 2 * main_d, 0)[0]
        if w == 2:
            record(records, "bitplane_unpack", 0.0, ms, pms, 4 * nw + main_d, 2 * main_d, 0)
        unpack_ms[w] = ms
        print(f"  bitplane_unpack d={main_d} w={w} (uint8 symbols): bit-equal, kernel {ms:.3f} ms "
              f"plain {pms:.3f} ms, bound {bound:.3f} ms ({100 * bound / ms:.1f}%)", flush=True)
        del sym, got, back
    print(f"  bitplane_unpack d={main_d}: w = 1 {unpack_ms[1]:.4f} ms beside w = 2 "
          f"{unpack_ms[2]:.4f} ms", flush=True)

    # binary accumulate: 8 peers' rows [plane ‖ bf16 centers], the §13
    # word windows of shards as views of the rows
    for d in (*sizes, main_d):
        gen.manual_seed(d + 4)
        pw = bpr.num_words(d, 1)
        rows = bits32((N, pw + 1))
        c = torch.sort(torch.randn(N, 2, generator=gen, device=dev), dim=1).values
        rows[:, pw] = torch.stack([cbp.floats_to_words(ci, "bfloat16")[0] for ci in c])
        ds = scatter_shard_len(d, N, cbp.BINARY_ALIGN)
        shards = range(N) if d != main_d else [N - 2, N - 1]
        for sh in shards:
            win = cbp._plane_window(rows[:, :pw], N, ds // 32, sh * ds // 32)
            lo, hi = (torch.stack([cbp.words_to_floats(r[pw:], 2, "bfloat16") for r in rows])
                      .T.contiguous())
            got = bpk.binary_accum(win, lo, hi, ds)
            want = bpr.binary_accum(win, lo, hi, ds)
            need(same_bits(got, want), f"bitplane_binary_accum d={d} shard {sh}: kernel != plain")
        if d == main_d:
            ms = cuda_ms(lambda: bpk.binary_accum(win, lo, hi, ds), reps=10)
            pms = cuda_ms(lambda: bpr.binary_accum(win, lo, hi, ds), reps=1)
            ws = ds // 32
            record(records, "bitplane_binary_accum", max_err(got, want), ms, pms,
                   4 * N * ws + 8 * N + 4 * ds, N * ds, N * ds)
            print(f"  bitplane_binary_accum d={d} shard {N - 1} ds={ds} n={N}: bit-equal, "
                  f"kernel {ms:.3f} ms plain {pms:.3f} ms", flush=True)
        else:
            print(f"  bitplane_binary_accum d={d} n={N}: {N} shard windows bit-equal", flush=True)
        del rows, win, got, want


ROW_LOGS = (8, 13, 14, 17, 18, 19, 20)   # FWHT row lengths 2^m checked, one pass and two


def check_rotation(main_rows: int, records: dict) -> None:
    """Bit-equality of the FWHT, rotate-min/max and rotated encode-pack
    kernels with their plain versions on the card, at rows of 2^m for m in
    ``ROW_LOGS`` (3 rows each) and at the main path's largest shape,
    ``main_rows`` rows of 2^20 (the embed bucket's block-diagonal chunks);
    the fused pack against the chain ``rotate`` -> ``binary_pack`` (FWHT
    kernel, plain encoder, bit-plane pack kernel); and, as a yardstick
    only, the Kronecker matmul formulation of the TPU kernel."""
    import torch
    from repro_torch import random as R
    from repro_torch.core import bitplane, rotation
    from repro_torch.kernels.hadamard import hadamard as hk
    from repro_torch.kernels.hadamard import ref as hr
    from repro_torch.kernels.rotated_encode import kernel as rek
    from repro_torch.kernels.rotated_encode import ops as reo
    from repro_torch.kernels.rotated_encode import ref as rer

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    key = R.fold_in(R.PRNGKey(11), 2)
    for m in (*ROW_LOGS, None):
        b, c = (3, 1 << m) if m is not None else (main_rows, 1 << 20)
        gen.manual_seed(b * c + 7)
        x = torch.randn(b, c, generator=gen, device=dev) * 0.02
        signs = R.rademacher(key, (b, c), dev)
        scale = float(rotation.chunk_scale(c, "cpu"))
        got = hk.fwht(x)
        want = hr.fwht(x)
        need(same_bits(got, want), f"fwht ({b}, {c}): kernel != plain")
        z, mm = rek.rotate_minmax(x, signs, scale)
        zp, mmp = rer.rotate_minmax(x, signs, scale)
        need(same_bits(z, zp) and same_bits(mm, mmp), f"rotate_minmax ({b}, {c}): kernel != plain")
        tag = f"({b}, {c})"
        if m is None or m >= 18:
            # a second call (its own ticket and row counters) and the
            # transform in place (out == x)
            again = hk.fwht(x)
            z2, mm2 = rek.rotate_minmax(x, signs, scale)
            y = x.clone()
            hk.fwht(y, out=y)
            need(same_bits(again, want) and same_bits(y, want),
                 f"fwht ({b}, {c}) repeated or in place: kernel != plain")
            need(same_bits(z2, zp) and same_bits(mm2, mmp),
                 f"rotate_minmax ({b}, {c}) repeated: kernel != plain")
            tag += " (repeated, in place)"
            del again, z2, y
        if m is None:
            n = b * c
            ms = cuda_ms(lambda: hk.fwht(x))
            pms = cuda_ms(lambda: hr.fwht(x), reps=1)
            record(records, "fwht", max_err(got, want), ms, pms, 8 * n, 0, 20 * n)
            # the TPU kernel's formulation H_1024 X H_1024 as two f32 matmuls,
            # TF32 off (setup()): a yardstick only, nothing on the path uses it
            h = hr.hadamard_matrix(1024, device=dev)
            x3 = x.reshape(b, 1024, 1024)
            kron = lambda: torch.matmul(h, torch.matmul(x3, h))  # noqa: E731
            lms = cuda_ms(kron)
            dev_k = max_err(kron().reshape(b, c), want)
            records["fwht"]["library_ms"] = lms
            del h, x3
            rms = cuda_ms(lambda: rek.rotate_minmax(x, signs, scale))
            rpms = cuda_ms(lambda: rer.rotate_minmax(x, signs, scale), reps=1)
            record(records, "rotate_minmax", max(max_err(z, zp), max_err(mm, mmp)), rms, rpms,
                   12 * n + 8 * b, 0, 24 * n)
            tag += (f" fwht {ms:.3f} ms (plain {pms:.3f}, Kronecker matmuls {lms:.3f}, "
                    f"max |matmuls - butterfly| {dev_k:.3g}); rotate_minmax {rms:.3f} ms "
                    f"(plain {rpms:.3f})")
        print(f"  fwht + rotate_minmax {tag}: bit-equal", flush=True)
        del x, signs, got, want, z, zp

    kenc = R.fold_in(key, 5)
    flat = torch.randn(70_001, generator=gen.manual_seed(70_001), device=dev)
    dp = rotation.padded_dim(flat.numel())
    zr = rotation.rotate(R.PRNGKey(3), flat)
    cases = [(zr, zr.amin(), zr.amax()),                      # 70,001 padded to 131,072
             (flat, flat.amin(), flat.amax()),                # dp not a multiple of 32
             (zr, zr[5], zr[5].clone())]                      # delta = 0: every bit 0
    for zz, lo, hi in cases:
        d = zz.numel()
        got = rek.encode_pack(zz, kenc, lo, hi, d)
        need(same_bits(got, rer.binary_plane(zz, kenc, lo, hi, d)),
             f"encode_pack dp={d} vmin={float(lo)} vmax={float(hi)}: kernel != plain")
    need(not bool(got.any()), "encode_pack with delta = 0 set a bit")
    # pairs (j, j + ceil(dp/2)) at half % 32 = 1, 1, 17, 1, 25, 6: high
    # ballots split across words, edge and seam words met by atomicOr
    for d in (1, 2, 33, 65, 70_001, 2 * ((1 << 16) + 5) + 1):
        zz = torch.randn(d, generator=gen.manual_seed(d), device=dev)
        for lo, hi in ((zz.amin(), zz.amax()), (zz[0], zz[0].clone())):
            got = rek.encode_pack(zz, kenc, lo, hi, d)
            need(same_bits(got, rer.binary_plane(zz, kenc, lo, hi, d)),
                 f"encode_pack dp={d} vmin={float(lo)} vmax={float(hi)}: kernel != plain")
        need(not bool(got.any()), f"encode_pack dp={d} with delta = 0 set a bit")
    for d in (100, 300, 70_001):
        for wire in ("bfloat16", "float32"):
            chain = bitplane.binary_pack(rotation.rotate(rotation.rotation_key(key), flat[:d]),
                                         R.fold_in(key, 1), wire)
            need(same_bits(reo.pack_binary(flat[:d], key, 1, wire), chain),
                 f"pack_binary d={d} {wire}: fused kernels != chain")
    print(f"  encode_pack dp={dp}, {flat.numel()}, 1, 2, 33, 65, 131,083 (ragged), delta = 0: "
          "bit-equal; "
          "fused pack_binary == chain at d = 100, 300, 70,001", flush=True)
    del flat, zr, cases

    n = main_rows << 20
    gen.manual_seed(n)
    z = torch.randn(n, generator=gen, device=dev)
    lo, hi = z.amin(), z.amax()
    got = rek.encode_pack(z, kenc, lo, hi, n)
    want = rer.binary_plane(z, kenc, lo, hi, n)
    need(same_bits(got, want), f"encode_pack dp={n}: kernel != plain")
    ms = cuda_ms(lambda: rek.encode_pack(z, kenc, lo, hi, n))
    pms = cuda_ms(lambda: rer.binary_plane(z, kenc, lo, hi, n), reps=1)
    record(records, "encode_pack", 0.0, ms, pms, 4 * n + 4 * got.numel() + 8,
           OPS_PER_CALL * -(-n // 2), 3 * n)
    print(f"  encode_pack dp={n}: bit-equal, kernel {ms:.3f} ms plain {pms:.3f} ms", flush=True)
    del z, got, want


def check_hash_encoders(sizes, main_d: int, records: dict) -> None:
    """Bit-equality of kernels 14 (dense Bernoulli encode) and 15 (binary
    quantization + pack) with their plain versions on the card, in f32 and
    bf16 at ``sizes`` and at ``main_d`` (the encode path's largest size),
    plus an unaligned view, kernel 15 at Δ = 0 and the vmin padding of a
    ragged length; kernel and plain version timed at ``main_d`` in f32
    (p = 1/16, μ = 0, seed 7: the encode path's arguments)."""
    import torch
    from repro_torch.kernels.bernoulli_encode import bernoulli_encode as bek
    from repro_torch.kernels.bernoulli_encode import ref as ber
    from repro_torch.kernels.binary_quant import binary_quant as bqk
    from repro_torch.kernels.binary_quant import ops as bqo
    from repro_torch.kernels.binary_quant import ref as bqr

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    p, mu, seed = 1.0 / 16, 0.0, 7
    for d in (*sizes, main_d):
        for dtype in (torch.float32, torch.bfloat16):
            gen.manual_seed(d + 9)
            x = torch.randn(d + 1, generator=gen, device=dev).to(dtype)
            for v in (x[:d], x[1:]):            # 16-byte aligned, and not
                got = bek.encode(v, p, mu, seed)
                want = ber.bernoulli_encode(v, p, mu, seed)
                need(same_bits(got, want), f"bernoulli_encode_2d d={d} {dtype}: kernel != plain")
                del got, want
                vmin, vmax = v.amin().float(), v.amax().float()
                padded = d + (-d) % bqo.TILE
                got = bqk.encode(v, vmin, vmax, seed, padded)
                flat = torch.cat([v, vmin.to(dtype).expand(padded - d)])
                want = bqr.pack_bytes(bqr.encode_bits(flat, vmin, vmax, seed))
                need(torch.equal(got, want), f"binary_encode_2d d={d} {dtype}: kernel != plain")
                tail = (padded - d) // 8
                need(tail == 0 or not bool(got[-tail:].any()),
                     f"binary_encode_2d d={d}: a bit set in the vmin padding")
                del got, want, flat
            zero = bqk.encode(x[:d], vmax, vmax, seed, padded)
            need(not bool(zero.any()), f"binary_encode_2d d={d} {dtype}: a bit set at delta = 0")
            if d == main_d and dtype == torch.float32:
                v = x[:d]
                got = bek.encode(v, p, mu, seed)
                sent = int((got != mu).sum())
                ms = cuda_ms(lambda: bek.encode(v, p, mu, seed), reps=10)
                pms = cuda_ms(lambda: ber.bernoulli_encode(v, p, mu, seed), reps=1)
                record(records, "bernoulli_encode_2d", 0.0, ms, pms, 8 * d, HASH_OPS * d,
                       2 * d + (F32_DIV_OPS + 1) * sent)
                del got
                bms = cuda_ms(lambda: bqk.encode(v, vmin, vmax, seed, padded), reps=10)
                bpms = cuda_ms(lambda: bqr.pack_bytes(bqr.encode_bits(
                    torch.cat([v, vmin.expand(padded - d)]), vmin, vmax, seed)), reps=1)
                record(records, "binary_encode_2d", 0.0, bms, bpms, 4 * d + padded // 8,
                       HASH_OPS * d, (F32_DIV_OPS + 3) * d)
                print(f"  bernoulli_encode_2d d={d} f32: kernel {ms:.3f} ms plain {pms:.3f} ms "
                      f"bound {records['bernoulli_encode_2d']['bound_ms']:.3f} ms; "
                      f"binary_encode_2d: kernel {bms:.3f} ms plain {bpms:.3f} ms bound "
                      f"{records['binary_encode_2d']['bound_ms']:.3f} ms", flush=True)
            del x, v, zero
        print(f"  bernoulli_encode_2d + binary_encode_2d d={d} f32, bf16, aligned and not, "
              "delta = 0, vmin padding: bit-equal", flush=True)


# (preset, mode override) of the divide check: a psum round, the scatter
# decodes of Bernoulli and the bit plane, the fixed-k gather decode with its
# mean of the centers, the dense simulation and the exact mean
DIVIDE_CASES = (("fixed_k_1bit", None), ("bernoulli_seed_1bit", None), ("binary_packed", None),
                ("hier_fixed_k", None), ("bernoulli_seed_1bit", "dense_sim"),
                ("fixed_k_1bit", "none"))
# the presets whose wire carries the node center μ = mean(x)
CENTER_CASES = ("fixed_k_1bit", "bernoulli_seed_1bit", "rotated_fixed_k")
# error feedback: the five ef_* presets and the training default with it
EF_CASES = ("ef_fixed_k", "ef_bernoulli", "ef_binary", "ef_ternary", "ef_rotated_binary",
            "fixed_k_1bit")


def check_divide(n: int) -> None:
    """Decodes divide by n exactly, and node centers do not depend on the
    device: one round of each of ``DIVIDE_CASES`` on ``StackedComm(n)`` on
    the card equals the same round on the CPU bit for bit, same keys and
    inputs, on a 2^-6 grid at d = 2^16 (every sum exact); and each of
    ``CENTER_CASES`` on seeded Gaussian inputs at d = 70,001, where sums
    round, gives the same wire bytes for every node and the same round."""
    import torch
    from repro_torch import random as R
    from repro_torch.configs.registry import compression_preset
    from repro_torch.core import collectives as coll
    from repro_torch.core import wire

    d = 1 << 16
    x = torch.round(torch.randn(n, d, generator=torch.Generator().manual_seed(n)) * 32) / 64
    key = R.fold_in(R.PRNGKey(17), n)
    for preset, mode in DIVIDE_CASES:
        cfg = dataclasses.replace(compression_preset(preset, axes=("data",)), min_compress_size=1)
        if mode is not None:
            cfg = dataclasses.replace(cfg, mode=mode, scatter_decode=False)
        got = coll.compressed_mean(x.cuda(), key, cfg, coll.StackedComm(n, "cuda"))
        want = coll.compressed_mean(x, key, cfg, coll.StackedComm(n, "cpu"))
        need(same_bits(got.cpu(), want), f"divide check n={n} {preset} {mode}: card != CPU")
    print(f"  decodes at n={n} (fixed_k_1bit, bernoulli_seed_1bit, binary_packed, fixed-k "
          "gather, dense simulation, exact mean): card == CPU bit for bit", flush=True)
    x = torch.randn(n, 70_001, generator=torch.Generator().manual_seed(n)) * 0.5 + 0.01
    for preset in CENTER_CASES:
        cfg = dataclasses.replace(compression_preset(preset, axes=("data",)), min_compress_size=1)
        codec = wire.resolve(cfg)
        for r in range(n):
            got = codec.pack(x[r].cuda(), key, r, cfg).cpu().view(torch.uint8)
            want = codec.pack(x[r], key, r, cfg).view(torch.uint8)
            need(torch.equal(got, want), f"center check n={n} {preset} node {r}: wire bytes "
                 "on the card != on the CPU")
        got = coll.compressed_mean(x.cuda(), key, cfg, coll.StackedComm(n, "cuda"))
        want = coll.compressed_mean(x, key, cfg, coll.StackedComm(n, "cpu"))
        need(same_bits(got.cpu(), want), f"center check n={n} {preset}: round card != CPU")
    print(f"  mean-center wires at n={n}, d=70001, Gaussian ({', '.join(CENTER_CASES)}): "
          "wire bytes and round card == CPU bit for bit", flush=True)
    # error feedback: two stateful rounds from the same nonzero residuals;
    # the 2-means sums, the ternary twin's mean and μ are tree sums, so the
    # estimates and the new residuals are the same bits on both devices
    e0 = torch.randn(n, 70_001, generator=torch.Generator().manual_seed(n + 1)) * 0.05
    for preset in EF_CASES:
        cfg = dataclasses.replace(compression_preset(preset, axes=("data",)),
                                  min_compress_size=1, error_feedback=True)
        states = {"cpu": e0.clone(), "cuda": e0.cuda()}
        for t in range(2):
            xt = torch.randn(n, 70_001, generator=torch.Generator().manual_seed(n + 10 + t))
            kt = R.fold_in(key, t)
            got, states["cuda"] = coll.compressed_mean_stateful(
                xt.cuda(), states["cuda"], kt, cfg, coll.StackedComm(n, "cuda"))
            want, states["cpu"] = coll.compressed_mean_stateful(
                xt, states["cpu"], kt, cfg, coll.StackedComm(n, "cpu"))
            need(same_bits(got.cpu(), want) and same_bits(states["cuda"].cpu(), states["cpu"]),
                 f"error feedback n={n} {preset} round {t}: card != CPU")
    print(f"  error feedback at n={n}, d=70001, Gaussian, two rounds from nonzero residuals "
          f"({', '.join(EF_CASES[:-1])}, fixed_k_1bit + EF): estimates and residuals card == "
          "CPU bit for bit", flush=True)


# robust decode: the decode policies of the phase-2 matrix, each with
# whether its clean round drops a peer; the Byzantine rounds drop none
ROBUST_POLICIES = (("trim(1)", False), ("median", False), ("mean_trim(1)", False),
                   ("mean", True))
ROBUST_D = 8_209


def same_or_nan(a, b) -> bool:
    """:func:`same_bits`, NaN where the other is NaN: a NaN's sign and
    payload are the platform's (the card returns its canonical NaN, the
    CPU one operand's)."""
    import torch

    na, nb = torch.isnan(a), torch.isnan(b)
    return (a.shape == b.shape and torch.equal(na, nb)
            and same_bits(a[~na].contiguous(), b[~nb].contiguous()))


def check_robust(n: int) -> None:
    """The robust decode on the card equals the CPU's: for each gather
    preset and each of ``ROBUST_POLICIES``, one round with the last peer
    dropped (the masked mean) or none (the order statistics), and one with
    each ``corrupt_wire_row`` mode injected into rank 1's gathered wire row
    (``ByzantineComm``), on Gaussian inputs with a block of ±0.0 columns;
    the masked psum of ``fixed_k_1bit`` and the five ``ef_*`` presets with
    a mask (one stateful round from nonzero residuals); and
    ``robust.reduce_rows`` for every kind over a stack with ±0.0 ties, NaN
    of both signs and ±Inf columns, masked and not, under
    ``torch.cuda.set_sync_debug_mode("error")``: the mask on the card
    causes no host sync."""
    import torch
    from repro_torch import random as R
    from repro_torch.configs.registry import (COMPRESSION_PRESETS, compression_preset,
                                              robust_preset)
    from repro_torch.core import collectives as coll
    from repro_torch.core.wire import robust
    from repro_torch.distributed import fault_tolerance as ft

    d = ROBUST_D
    x = torch.randn(n, d, generator=torch.Generator().manual_seed(n + 3)) * 0.5 + 0.01
    x[:, :64] = 0.0
    x[1::2, :32] = -0.0
    key = R.fold_in(R.PRNGKey(19), n)
    mask = torch.ones(n)
    mask[n - 1] = 0.0
    presets = sorted(p for p in COMPRESSION_PRESETS if p != "fixed_k_1bit")
    for preset in presets:
        for policy, drop in ROBUST_POLICIES:
            cfg = dataclasses.replace(robust_preset(preset, policy, axes=("data",)),
                                      min_compress_size=1)
            for mode in (None,) + ft.CORRUPTION_MODES:
                out = {}
                for dev in ("cpu", "cuda"):
                    comm = coll.StackedComm(n, dev)
                    if mode is not None:
                        comm = ft.ByzantineComm(comm, 1, mode)
                    dm = mask.to(dev) if drop and mode is None else None
                    out[dev] = coll.compressed_mean(x.to(dev), key, cfg, comm, drop_mask=dm)
                need(same_or_nan(out["cuda"].cpu(), out["cpu"]),
                     f"robust n={n} {preset} {policy} {mode or 'dropped peer'}: card != CPU")
    e0 = torch.randn(n, d, generator=torch.Generator().manual_seed(n + 4)) * 0.05
    for preset in ("fixed_k_1bit",) + EF_CASES[:-1]:
        cfg = dataclasses.replace(compression_preset(preset, axes=("data",)), min_compress_size=1)
        res = {}
        for dev in ("cpu", "cuda"):
            res[dev] = coll.compressed_mean_stateful(x.to(dev), e0.clone().to(dev), key, cfg,
                                                     coll.StackedComm(n, dev), mask.to(dev))
        need(same_bits(res["cuda"][0].cpu(), res["cpu"][0])
             and same_bits(res["cuda"][1].cpu(), res["cpu"][1]),
             f"masked round n={n} {preset}: card != CPU")
    s = torch.randn(n, 4099, generator=torch.Generator().manual_seed(n))
    s[:, 0] = 0.0
    s[1::2, 0] = -0.0
    s[0, 1], s[1, 1] = float("nan"), -float("nan")
    s[:, 2] = float("nan")
    s[0, 3], s[1, 3] = float("inf"), -float("inf")
    s[:, 4:64] = torch.round(s[:, 4:64])
    sd = s.cuda()
    for kind, f in (("mean", 0), ("trim", 1), ("median", 0), ("mean_trim", 1), ("mean_trim", 0)):
        for m in (None, mask, torch.zeros(n)):
            md = None if m is None else m.cuda()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = robust.reduce_rows(sd, kind, f, md)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            need(same_or_nan(got.cpu(), robust.reduce_rows(s, kind, f, m)),
                 f"reduce_rows n={n} {kind}({f}) mask {m}: card != CPU")
    print(f"  robust decode at n={n}, d={d} ({len(presets)} gather presets x trim(1), median, "
          "mean_trim(1), the masked mean; a dropped peer and each Byzantine row mode), "
          "fixed_k_1bit and the ef_* presets masked: card == CPU (NaN for NaN); reduce_rows "
          "over ±0.0, ±NaN and ±Inf columns with the mask on the card: no host sync, card == "
          "CPU", flush=True)


# the hierarchical matrix of phase 2: (label, preset, overrides); every
# one runs with inner_axes=("data",) on the (pod, data) mesh
HIER_CASES = (("hier_fixed_k", "hier_fixed_k", {}),
              ("hier_fixed_k no scatter", "hier_fixed_k", {"scatter_decode": False}),
              ("hier_bernoulli", "hier_bernoulli", {}),
              ("rotated_fixed_k", "rotated_fixed_k", {}),
              ("binary_packed", "binary_packed", {}),
              ("ternary_packed", "ternary_packed", {}),
              ("hier_bernoulli trim(1)", "hier_bernoulli", {"decode_policy": "trim(1)"}))
HIER_MESHES = ({"pod": 4, "data": 2}, {"pod": 2, "data": 3})
HIER_D = 70_001


def hier_cfg(preset: str, **kw):
    """``preset`` on the (pod, data) mesh: codec over pod, exact in-pod."""
    from repro_torch.configs.registry import compression_preset

    cfg = compression_preset(preset)
    return dataclasses.replace(cfg, inner_axes=("data",), min_compress_size=1, **kw)


def check_hierarchical(mesh: dict) -> None:
    """The §11 two-level rounds on the card equal the CPU's bit for bit on
    ``StackedComm(mesh=...)``: each of ``HIER_CASES`` on seeded Gaussian
    inputs at d = 70,001 with a block of ±0.0 columns (the in-pod mean's
    signed zeros), the trimmed one also with a dropped cross-host peer (an
    n_eff-entry mask); ``ef_bernoulli`` over 3 rounds with the residuals
    carried (the rows of one pod equal); the bytes handed to the pod axis
    equal the codec's wire bits at n_eff."""
    import torch
    from repro_torch import random as R
    from repro_torch.core import collectives as coll
    from repro_torch.core import wire

    n = math.prod(mesh.values())
    n_eff, n_in = mesh["pod"], mesh["data"]
    d = HIER_D
    x = torch.randn(n, d, generator=torch.Generator().manual_seed(n + 5)) * 0.5 + 0.01
    x[:, :64] = 0.0
    x[1::2, :32] = -0.0
    key = R.fold_in(R.PRNGKey(23), n)
    mask = torch.ones(n_eff)
    mask[1] = 0.0
    for label, preset, kw in HIER_CASES:
        cfg = hier_cfg(preset, **kw)
        masks = (None, mask) if cfg.decode_policy != "mean" else (None,)
        for m in masks:
            out = {}
            for dev in ("cpu", "cuda"):
                comm = coll.StackedComm(device=dev, mesh=mesh)
                out[dev] = coll.compressed_mean(x.to(dev), key, cfg, comm,
                                                None if m is None else m.to(dev))
                codec = wire.resolve(cfg)
                need((comm.bytes_gathered + comm.bytes_reduced) * 8
                     == codec.wire_bits(n_eff, d, cfg),
                     f"hierarchical {mesh} {label}: pod-axis bytes != wire bits at n_eff")
            need(same_or_nan(out["cuda"].cpu(), out["cpu"]),
                 f"hierarchical {mesh} {label} mask {m}: card != CPU")
    cfg = hier_cfg("ef_bernoulli")
    states = {"cpu": torch.zeros(n, d), "cuda": torch.zeros(n, d, device="cuda")}
    for t in range(3):
        xt = torch.randn(n, d, generator=torch.Generator().manual_seed(n + 30 + t))
        for dev in ("cpu", "cuda"):
            est, states[dev] = coll.compressed_mean_stateful(
                xt.to(dev), states[dev], R.fold_in(key, t), cfg,
                coll.StackedComm(device=dev, mesh=mesh))
            if dev == "cpu":
                want = est
        need(same_bits(est.cpu(), want) and same_bits(states["cuda"].cpu(), states["cpu"]),
             f"hierarchical {mesh} ef_bernoulli round {t}: card != CPU")
        rows = states["cpu"].reshape(n_eff, n_in, d)
        need(all(torch.equal(rows[:, 0], rows[:, j]) for j in range(n_in)),
             f"hierarchical {mesh} ef_bernoulli round {t}: the rows of a pod differ")
    print(f"  hierarchical rounds on (pod {n_eff}, data {n_in}), d={d}: "
          f"{', '.join(c[0] for c in HIER_CASES)} (trim(1) also with a dropped cross-host "
          "peer), ef_bernoulli over 3 rounds: card == CPU bit for bit, pod-axis bytes == "
          "wire bits at n_eff", flush=True)


def check_inner_shards() -> None:
    """Kernel 3 (the Bernoulli count phase and shard decode) at the
    hierarchical split, n_in = 2 and 3 shards of ⌈d/n_in⌉ over n_eff = 4
    peers, at d = 70,001 and 2·32·1024 ± 1: counts and support bits equal
    the plain version's, each shard's decode too, and the stitched shards
    the sequential flat decode."""
    import torch
    from repro_torch.core import comm_cost
    from repro_torch.kernels.bernoulli_wire import kernel as bwk
    from repro_torch.kernels.bernoulli_wire import ref as bwr

    dev = torch.device("cuda")
    p, peers = 1.0 / 16, 4
    for d in (70_001, 65_535, 65_537):
        cap = comm_cost.bernoulli_capacity(d, p)
        gen = torch.Generator(device=dev).manual_seed(d)
        bufs = torch.randn(peers, cap, generator=gen, device=dev)
        mus = torch.randn(peers, generator=gen, device=dev) * 0.1
        keys = _keys(d, peers)
        want = bwr.decode_sum_sequential(bufs, mus, keys, p, cap, d)
        for nshards in (2, 3):
            ds = -(-d // nshards)
            sk = [bwk.support_counts(keys, p=p, d=d, start=s * ds, ds=ds, device=dev)
                  for s in range(nshards)]
            sp = [bwr.support_counts(keys, p, d, s * ds, ds, dev) for s in range(nshards)]
            for s in range(nshards):
                need(torch.equal(sk[s].counts, sp[s].counts)
                     and torch.equal(sk[s].mask, sp[s].mask),
                     f"bernoulli_support_counts d={d} shard {s} of {nshards}: kernel != plain")
            allc = torch.stack([c.counts.sum(1, dtype=torch.int32) for c in sk])
            prior = torch.cumsum(allc, 0, dtype=torch.int32) - allc
            parts = []
            for s in range(nshards):
                pk = bwk.decode_sum_shard(bufs, mus, sk[s], prior[s].contiguous(), cap=cap)
                pp = bwr.decode_sum_shard(bufs, mus, sp[s], prior[s].contiguous(), cap)
                need(same_bits(pk, pp),
                     f"bernoulli_decode_sum_shard d={d} shard {s} of {nshards}: kernel != plain")
                parts.append(pk)
            need(same_bits(torch.cat(parts)[:d], want),
                 f"stitched {nshards} shards d={d} != sequential decode")
    print("  bernoulli_support_counts + decode_sum_shard at n_in = 2, 3 shards over 4 peers, "
          "d = 70001, 65535, 65537: bit-equal, stitched == sequential", flush=True)


def time_center(main_d: int) -> None:
    """The wire's mean center at the embed bucket: ``tree_mean`` (the same
    adds on every device) beside ``torch.mean``, by CUDA events."""
    import torch
    from repro_torch.core.wire import base

    x = torch.randn(main_d, generator=torch.Generator("cuda").manual_seed(5), device="cuda")
    ms = cuda_ms(lambda: base.center(x, "mean"), reps=10)
    ref_ms = cuda_ms(lambda: torch.mean(x), reps=10)
    print(f"  mean center d={main_d}: tree_mean {ms:.4f} ms, torch.mean {ref_ms:.4f} ms",
          flush=True)
    del x


# (b, sq, sk, hq, hkv, hd, causal, window, q_offset, dtypes); the last two
# are the training path's sequence and the serving path's prefill (8
# prompts of 2048 tokens), at qwen3-4b's heads
FLASH_CASES = [
    (1, 256, 256, 4, 2, 64, True, None, 0, ("float32", "bfloat16")),
    (1, 256, 256, 4, 2, 64, False, None, 0, ("float32", "bfloat16")),
    (1, 512, 512, 2, 1, 64, True, 128, 0, ("float32", "bfloat16")),
    (1, 128, 512, 2, 2, 64, True, None, 256, ("float32", "bfloat16")),
    # the bf16 kernel's 128-row q tiles and 128-key tiles at their edges
    (1, 1000, 1000, 4, 1, 128, True, None, 0, ("float32", "bfloat16")),   # ragged, g = 4
    (1, 1000, 1000, 4, 4, 64, True, None, 0, ("float32", "bfloat16")),    # ragged, hd 64, g = 1
    (2, 100, 100, 8, 2, 128, True, None, 0, ("float32", "bfloat16")),     # less than one tile
    (1, 1024, 1024, 4, 1, 128, True, 200, 0, ("bfloat16",)),   # a window straddling key tiles
    (1, 256, 512, 4, 2, 128, True, None, 200, ("bfloat16",)),  # a q offset no multiple of 128
    (1, 8192, 8192, 32, 8, 128, True, None, 0, ("bfloat16",)),
    (1, 4096, 4096, 32, 8, 128, True, None, 0, ("bfloat16",)),
    (8, 2048, 2048, 32, 8, 128, True, None, 0, ("bfloat16",)),
    # jamba-v0.1-52b's 32,768-token prompt (its heads are qwen3-4b's)
    (1, 32768, 32768, 32, 8, 128, True, None, 0, ("bfloat16",)),
    # olmoe-1b-7b's heads (16/16, g = 1): its serving prefill and one rank's
    # training sequence
    (8, 2048, 2048, 16, 16, 128, True, None, 0, ("bfloat16",)),
    (1, 4096, 4096, 16, 16, 128, True, None, 0, ("bfloat16",)),
    # llava-next-34b's heads (56/8, g = 7): ragged tiles, its serving
    # prefill (8 prompts of 1152 patches and 896 tokens) and one rank's
    # training sequence (1152 patches and 2944 tokens)
    (1, 1000, 1000, 56, 8, 128, True, None, 0, ("float32", "bfloat16")),
    (8, 2048, 2048, 56, 8, 128, True, None, 0, ("bfloat16",)),
    (1, 4096, 4096, 56, 8, 128, True, None, 0, ("bfloat16",)),
    # hd 32 (lm-8m), on the hd-64 tiles with columns 32-63 zero-filled: tile
    # edges, then one rank's attention in the training example
    (1, 1000, 1000, 4, 2, 32, True, None, 0, ("float32", "bfloat16")),   # ragged, g = 2
    (1, 512, 512, 4, 1, 32, True, 200, 0, ("bfloat16",)),       # a window across key tiles
    (1, 256, 512, 4, 2, 32, True, None, 200, ("bfloat16",)),    # a q offset no multiple of 128
    (2, 100, 100, 8, 4, 32, False, None, 0, ("float32", "bfloat16")),   # less than one tile
    (4, 128, 128, 8, 4, 32, True, None, 0, ("float32", "bfloat16")),
    # hd 16 (the smoke configs), on the hd-64 tiles with columns 16-63
    # zero-filled: tile edges, then one rank's attention in the training CLI's
    # smoke run (--batch 16 --devices 4) and the serving example's prefill
    (1, 1000, 1000, 4, 2, 16, True, None, 0, ("float32", "bfloat16")),   # ragged, g = 2
    (1, 512, 512, 4, 1, 16, True, 200, 0, ("bfloat16",)),       # a window across key tiles
    (1, 256, 512, 4, 2, 16, True, None, 200, ("bfloat16",)),    # a q offset no multiple of 128
    (2, 100, 100, 4, 4, 16, False, None, 0, ("float32", "bfloat16")),   # less than one tile
    (4, 128, 128, 4, 2, 16, True, None, 0, ("float32", "bfloat16")),
    (4, 16, 16, 4, 2, 16, True, None, 0, ("bfloat16",)),
    # minitron-4b's heads (24/8, g = 3) and mistral-large-123b's (96/8, g =
    # 12): ragged tiles, then their serving prefills (8 prompts of 2048)
    (1, 1000, 1000, 24, 8, 128, True, None, 0, ("float32", "bfloat16")),
    (1, 1000, 1000, 96, 8, 128, True, None, 0, ("float32", "bfloat16")),
    (8, 2048, 2048, 24, 8, 128, True, None, 0, ("bfloat16",)),
    (8, 2048, 2048, 96, 8, 128, True, None, 0, ("bfloat16",)),
    # hd 120 (h2o-danube-3-4b, 32/8 heads) on the hd-128 tiles with columns
    # 120-127 zero-filled: causal, a window across key tiles, ragged tiles
    # with a q offset; then its serving prefill (8 prompts of 4080 tokens,
    # which its 4096 window does not cut) and its 32,768-token prompt, where
    # the window makes most key tiles dead
    (1, 1024, 1024, 32, 8, 120, True, None, 0, ("float32", "bfloat16")),
    (1, 1024, 1024, 32, 8, 120, True, 200, 0, ("float32", "bfloat16")),
    (1, 1000, 1200, 32, 8, 120, True, None, 200, ("float32", "bfloat16")),
    (8, 4080, 4080, 32, 8, 120, True, 4096, 0, ("bfloat16",)),
    (1, 32768, 32768, 32, 8, 120, True, 4096, 0, ("bfloat16",)),
]
# the shapes at which kernel 11 is timed against SDPA (bf16): (b, sq, hq,
# hkv, hd) -> (path, the name of its row in the last JSON line, or None)
FLASH_TIMED = {(8, 2048, 32, 8, 128): ("serving", "flash_attention_fwd"),
               (1, 4096, 32, 8, 128): ("training", None),
               (8, 2048, 16, 16, 128): ("olmoe serving", None),
               (1, 32768, 32, 8, 128): ("hybrid 32k prompt", None),
               (1, 4096, 16, 16, 128): ("olmoe training", None),
               (8, 2048, 56, 8, 128): ("llava serving", None),
               (1, 4096, 56, 8, 128): ("llava training", None),
               (4, 128, 8, 4, 32): ("example", "flash_attention_fwd_hd32"),
               (4, 128, 4, 2, 16): ("training CLI", "flash_attention_fwd_hd16"),
               (4, 16, 4, 2, 16): ("serving example", None),
               (8, 2048, 24, 8, 128): ("minitron serving", None),
               (8, 2048, 96, 8, 128): ("mistral serving", None),
               (8, 4080, 32, 8, 120): ("danube serving", "flash_attention_fwd_hd120"),
               (1, 32768, 32, 8, 120): ("danube 32k prompt", None)}
# (atol, rtol) on o: the reference's own for its kernel (tests/test_kernel_flash.py)
FLASH_TOL = {"float32": (2e-3, 2e-3), "bfloat16": (3e-2, 0.0)}
LSE_TOL = 1e-3
# the full-softmax oracle's f32 scores above this many elements (8 GiB) are
# not formed: the 32k prompt's would take 137 GB, danube's serving prefill's
# 17 GB; the plain version holds them
ORACLE_MAX_SCORES = 1 << 31


def live_pairs(sq: int, sk: int, causal: bool, window, q_offset: int) -> int:
    """The (q, k) pairs the mask keeps: the work attention needs."""
    import torch

    p = torch.arange(q_offset, q_offset + sq, dtype=torch.int64)
    hi = torch.clamp(p + 1, max=sk) if causal else torch.full_like(p, sk)
    lo = torch.clamp(p - window + 1, min=0) if window is not None else torch.zeros_like(p)
    return int(torch.clamp(hi - lo, min=0).sum())


def plain_block(s: int, most: int = 512) -> int:
    """A block (or chunk) along a sequence of ``s`` for the plain versions
    and the chunked attention, which tile by whole blocks: the largest
    divisor of ``s`` up to ``most``."""
    return next(b for b in range(min(s, most), 0, -1) if s % b == 0)


def within(a, b, atol: float, rtol: float) -> bool:
    return bool(((a.double() - b.double()).abs() <= atol + rtol * b.double().abs()).all())


def sdpa_call(q, k, v, *, causal: bool, window, q_offset: int, grad: bool = False):
    """(fn, leaves, name): ``fn()`` is one call of
    ``F.scaled_dot_product_attention`` computing the kernel's attention on
    q, k, v (the model's layout) as ``leaves`` (B, H, S, hd) — a causal mask
    by ``is_causal`` with GQA; a window that masks a live pair by an explicit
    boolean mask, k and v repeated to q's heads inside the call (the
    backends that take a mask take no GQA).  With ``grad`` the leaves
    require a gradient, for ``torch.autograd.grad``."""
    import torch
    import torch.nn.functional as F

    sq, sk = q.shape[1], k.shape[1]
    leaves = [x.transpose(1, 2) for x in (q, k, v)]
    if grad:
        leaves = [x.detach().requires_grad_() for x in leaves]
    qt, kt, vt = leaves
    if window is None or (live_pairs(sq, sk, causal, window, q_offset)
                          == live_pairs(sq, sk, causal, None, q_offset)):
        need(causal and q_offset == 0 and sq == sk, "sdpa: is_causal needs a square mask")
        return (lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                       enable_gqa=True)), leaves, "sdpa"
    g = q.shape[2] // k.shape[2]
    qp = torch.arange(q_offset, q_offset + sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None]
    mask = (kp > qp - window) & (kp <= qp) if causal else kp > qp - window

    def call():
        return F.scaled_dot_product_attention(qt, kt.repeat_interleave(g, dim=1),
                                              vt.repeat_interleave(g, dim=1), attn_mask=mask)
    return call, leaves, "sdpa with a boolean mask"


def check_flash(records: dict) -> None:
    """The flash-attention kernel against its plain blockwise version and the
    full-softmax oracle on the same inputs, within the reference's own
    tolerances; at the serving and training paths' shapes, kernel and
    ``F.scaled_dot_product_attention`` (the yardstick) timed, with TFLOP/s
    and the share of the operation bound, and at the serving shape the
    plain version too."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.flash_attention import ref as far

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    for b, sq, sk, hq, hkv, hd, causal, window, q_offset, dtypes in FLASH_CASES:
        for dt in dtypes:
            dtype = getattr(torch, dt)
            gen.manual_seed(sq * hq + hd)
            q = torch.randn(b, sq, hq, hd, generator=gen, device=dev).to(dtype)
            k = torch.randn(b, sk, hkv, hd, generator=gen, device=dev).to(dtype)
            v = torch.randn(b, sk, hkv, hd, generator=gen, device=dev).to(dtype)
            kw = dict(causal=causal, window=window, q_offset=q_offset)
            o, lse = fak.flash_attention_fwd(q, k, v, **kw)
            torch.cuda.synchronize()
            blocks = dict(block_q=plain_block(sq), block_k=plain_block(sk))
            op, lsep = far.flash_attention_fwd(q, k, v, **kw, **blocks)
            oracle = (far.attention(q, k, v, **kw) if b * hq * sq * sk <= ORACLE_MAX_SCORES
                      else op)
            atol, rtol = FLASH_TOL[dt]
            tag = (f"flash_attention_fwd ({b}, {sq}/{sk}, {hq}/{hkv}, {hd}) {dt} causal={causal} "
                   f"window={window} q_offset={q_offset}")
            need(bool(torch.isfinite(o.float()).all()), f"{tag}: non-finite output")
            need(within(o, op, atol, rtol) and within(o, oracle, atol, rtol),
                 f"{tag}: o outside atol {atol} rtol {rtol} of plain / oracle "
                 f"({max_err(o, op):.3g}, {max_err(o, oracle):.3g})")
            need(within(lse, lsep, LSE_TOL, 0.0), f"{tag}: lse off by {max_err(lse, lsep):.3g}")
            err = max_err(o, op)
            vs_oracle = f"{max_err(o, oracle):.3g}" if oracle is not op else "not formed"
            tag += (f": max |o - plain| {err:.3g}, |o - oracle| {vs_oracle}, "
                    f"|lse - plain| {max_err(lse, lsep):.3g}")
            del oracle
            path, row = FLASH_TIMED.get((b, sq, hq, hkv, hd), (None, None))
            if path and dt == "bfloat16":
                ms = cuda_ms(lambda: fak.flash_attention_fwd(q, k, v, **kw), reps=10)
                lib, _, library = sdpa_call(q, k, v, **kw)
                try:        # a backend without GQA at 32k would form 137 GB of scores
                    lms = cuda_ms(lib, reps=10)
                except torch.cuda.OutOfMemoryError:
                    lms = None
                    torch.cuda.empty_cache()
                del lib
                nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel()) + 4 * lse.numel()
                flops = 4 * b * hq * hd * live_pairs(sq, sk, causal, window, q_offset)
                tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
                tag += (f"; {path} shape: kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
                        f"{100 * max(tb, tf) / ms:.1f}% of its {max(tb, tf):.3f} ms bound), "
                        f"{library} " + (f"{lms:.3f} ms ({ms / lms:.2f}x)" if lms else
                                         "out of memory"))
                if row or path not in ("serving", "training"):
                    pms = cuda_ms(lambda: far.flash_attention_fwd(q, k, v, **kw, **blocks),
                                  reps=1)
                    tag += f", plain {pms:.3f} ms"
                if row:
                    records[row] = {
                        "max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": max(tb, tf),
                        "bound_by": "bytes" if tb >= tf else "operations", "library_ms": lms}
            print(f"  {tag}", flush=True)
            del q, k, v, o, lse, op, lsep


# (b, sq, sk, hq, hkv, hd, causal, window, q_offset, dtypes); the last is the
# training path's (one 4096-token sequence, qwen3-4b's heads)
FLASH_BWD_CASES = [
    (1, 256, 256, 4, 1, 64, True, None, 0, ("float32", "bfloat16")),      # g = 4
    (1, 256, 256, 4, 4, 128, False, None, 0, ("float32", "bfloat16")),    # g = 1, not causal
    (1, 512, 512, 2, 1, 64, True, 128, 0, ("float32", "bfloat16")),      # window
    (1, 128, 512, 4, 2, 128, True, None, 256, ("float32", "bfloat16")),   # q offset
    (2, 1000, 1000, 8, 2, 128, True, None, 0, ("float32", "bfloat16")),   # ragged tiles
    # the bf16 kernels' 128-key / 128-row CTA tiles and 64-row / 64-key ring
    # tiles at their edges
    (1, 1000, 1000, 4, 4, 64, True, None, 0, ("float32", "bfloat16")),    # ragged, hd 64, g = 1
    (1, 1024, 1024, 4, 1, 128, True, 200, 0, ("float32", "bfloat16")),   # a window across tiles
    (2, 100, 100, 8, 2, 128, True, None, 0, ("float32", "bfloat16")),     # less than one tile
    (1, 256, 512, 4, 2, 128, True, None, 200, ("float32", "bfloat16")),  # q offset 200, Sk 512
    (1, 4096, 4096, 32, 8, 128, True, None, 0, ("bfloat16",)),
    (1, 4096, 4096, 16, 16, 128, True, None, 0, ("bfloat16",)),      # olmoe's heads, g = 1
    # llava-next-34b's heads, g = 7: ragged tiles, then one rank's sequence
    (1, 1000, 1000, 56, 8, 128, True, None, 0, ("float32", "bfloat16")),
    (1, 4096, 4096, 56, 8, 128, True, None, 0, ("bfloat16",)),
    # hd 32 (lm-8m) on the hd-64 tiles: the edges above, then one rank's
    # attention in the training example
    (1, 1000, 1000, 4, 2, 32, True, None, 0, ("float32", "bfloat16")),    # ragged, g = 2
    (1, 1024, 1024, 4, 1, 32, True, 200, 0, ("float32", "bfloat16")),    # a window across tiles
    (2, 100, 100, 8, 4, 32, False, None, 0, ("float32", "bfloat16")),    # less than one tile
    (1, 256, 512, 4, 2, 32, True, None, 200, ("float32", "bfloat16")),   # q offset 200, Sk 512
    (4, 128, 128, 8, 4, 32, True, None, 0, ("float32", "bfloat16")),
    # hd 16 (the smoke configs) on the hd-64 tiles: the edges above, then one
    # rank's attention in the training CLI's smoke run
    (1, 1000, 1000, 4, 2, 16, True, None, 0, ("float32", "bfloat16")),    # ragged, g = 2
    (1, 1024, 1024, 4, 1, 16, True, 200, 0, ("float32", "bfloat16")),    # a window across tiles
    (2, 100, 100, 4, 4, 16, False, None, 0, ("float32", "bfloat16")),    # less than one tile
    (1, 256, 512, 4, 2, 16, True, None, 200, ("float32", "bfloat16")),   # q offset 200, Sk 512
    (4, 128, 128, 4, 2, 16, True, None, 0, ("float32", "bfloat16")),
    # hd 120 (h2o-danube-3-4b) on the hd-128 tiles: causal, a window across
    # tiles, ragged tiles with a q offset; then one rank's training sequence
    # (which its 4096 window does not cut) and its 32,768-token prompt, where
    # the window leaves every later q tile of a key tile dead
    (1, 1024, 1024, 32, 8, 120, True, None, 0, ("float32", "bfloat16")),
    (1, 1024, 1024, 32, 8, 120, True, 200, 0, ("float32", "bfloat16")),
    (1, 1000, 1200, 32, 8, 120, True, None, 200, ("float32", "bfloat16")),
    (1, 4096, 4096, 32, 8, 120, True, 4096, 0, ("bfloat16",)),
    (1, 32768, 32768, 32, 8, 120, True, 4096, 0, ("bfloat16",)),
]
# the shapes at which kernels 12-13 are timed (bf16): (b, sq, hq, hkv, hd) ->
# whether these are their rows in the last JSON line (else printed only)
FLASH_BWD_TIMED = {(1, 4096, 32, 8, 128): True, (1, 4096, 16, 16, 128): False,
                   (1, 4096, 56, 8, 128): False,
                   (4, 128, 8, 4, 32): True, (4, 128, 4, 2, 16): True,
                   (1, 4096, 32, 8, 120): True, (1, 32768, 32, 8, 120): False}
# f32: |Δ| ≤ atol + rtol·|ref|, the forward's; bf16: relative Frobenius error
# of each of dq, dk, dv.  p and ds enter the products as bf16 hi + lo pairs
# (2⁻¹⁶ relative); on the H100 the readings were ≤ 1.1e-5 at the small shapes
# and 4.2e-5 at the training shape.  Rounding p and ds to bf16 once, as
# FlashAttention-2 does, gives about 1e-3, so the limit sits between the two.
BWD_F32_TOL = (2e-3, 2e-3)
BWD_BF16_REL = 2e-4


def rel_err(a, b) -> float:
    """‖a − b‖ / ‖b‖, in f64."""
    import torch

    return float(torch.linalg.vector_norm(a.double() - b.double())
                 / torch.linalg.vector_norm(b.double()))


def check_flash_bwd(records: dict) -> None:
    """The backward kernels against the plain blockwise sweeps on the same
    inputs (q, k, v, do drawn from a seed; lse from the forward kernel;
    delta = rowsum(do · o)); at the training path's shape, kernels, plain
    sweeps and the backward of ``F.scaled_dot_product_attention`` (the
    yardstick: one call for dq, dk and dv, timed as ``torch.autograd.grad``
    of a forward built outside the timed region) timed."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.flash_attention import ref as far

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    for b, sq, sk, hq, hkv, hd, causal, window, q_offset, dtypes in FLASH_BWD_CASES:
        for dt in dtypes:
            dtype = getattr(torch, dt)
            gen.manual_seed(sq * hq + hd + 1)
            q = torch.randn(b, sq, hq, hd, generator=gen, device=dev).to(dtype)
            k = torch.randn(b, sk, hkv, hd, generator=gen, device=dev).to(dtype)
            v = torch.randn(b, sk, hkv, hd, generator=gen, device=dev).to(dtype)
            do = torch.randn(b, sq, hq, hd, generator=gen, device=dev).to(dtype)
            kw = dict(causal=causal, window=window, q_offset=q_offset)
            o, lse = fak.flash_attention_fwd(q, k, v, **kw)
            delta = torch.sum(do.float() * o.float(), -1).transpose(1, 2).contiguous()
            args = (q, k, v, do, lse, delta)
            dk, dv = fak.flash_attention_bwd_dkv(*args, **kw)
            dq = fak.flash_attention_bwd_dq(*args, **kw)
            torch.cuda.synchronize()
            blocks = dict(block_q=plain_block(sq), block_k=plain_block(sk))
            pdk, pdv = far.flash_attention_bwd_dkv(*args, **kw, **blocks)
            pdq = far.flash_attention_bwd_dq(*args, **kw, **blocks)
            tag = (f"flash_attention_bwd ({b}, {sq}/{sk}, {hq}/{hkv}, {hd}) {dt} causal={causal} "
                   f"window={window} q_offset={q_offset}")
            errs = {}
            for name, got, want in (("dq", dq, pdq), ("dk", dk, pdk), ("dv", dv, pdv)):
                need(bool(torch.isfinite(got).all()), f"{tag}: non-finite {name}")
                errs[name] = (max_err(got, want), rel_err(got, want))
                if dt == "float32":
                    need(within(got, want, *BWD_F32_TOL),
                         f"{tag}: {name} outside atol/rtol {BWD_F32_TOL} ({errs[name][0]:.3g})")
                else:
                    need(errs[name][1] <= BWD_BF16_REL,
                         f"{tag}: {name} relative error {errs[name][1]:.3g} > {BWD_BF16_REL}")
            tag += ": " + ", ".join(f"{n} max |Δ| {e[0]:.3g} rel {e[1]:.3g}"
                                    for n, e in errs.items())
            timed = (b, sq, hq, hkv, hd) in FLASH_BWD_TIMED
            row = FLASH_BWD_TIMED.get((b, sq, hq, hkv, hd))
            if timed and dt == "bfloat16":
                ms_kv = cuda_ms(lambda: fak.flash_attention_bwd_dkv(*args, **kw), reps=10)
                ms_q = cuda_ms(lambda: fak.flash_attention_bwd_dq(*args, **kw), reps=10)
                pms_kv = cuda_ms(lambda: far.flash_attention_bwd_dkv(*args, **kw, **blocks), reps=1)
                pms_q = cuda_ms(lambda: far.flash_attention_bwd_dq(*args, **kw, **blocks), reps=1)
                lib, leaves, library = sdpa_call(q, k, v, **kw, grad=True)
                try:
                    out = lib()
                    lms = cuda_ms(lambda: torch.autograd.grad(out, leaves, do.transpose(1, 2),
                                                              retain_graph=True), reps=10)
                    del out
                except torch.cuda.OutOfMemoryError:
                    lms = None
                    torch.cuda.empty_cache()
                del lib, leaves
                pairs = b * hq * live_pairs(sq, sk, causal, window, q_offset)
                io = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * (lse.numel() + delta.numel())
                for name, ms, pms, flops, nbytes, err in (
                        (fak.launch_name("flash_attention_bwd_dkv", hd), ms_kv, pms_kv,
                         8 * hd * pairs, io + 4 * 2 * k.numel(),
                         max(errs["dk"][0], errs["dv"][0])),
                        (fak.launch_name("flash_attention_bwd_dq", hd), ms_q, pms_q,
                         6 * hd * pairs, io + 4 * q.numel(), errs["dq"][0])):
                    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
                    if row:
                        records[name] = {
                            "max_abs_err": err, "ms": ms, "plain_ms": pms,
                            "bound_ms": max(tb, tf),
                            "bound_by": "bytes" if tb >= tf else "operations", "library_ms": lms}
                    tag += (f"; {name} {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, bound "
                            f"{max(tb, tf):.3f} ms), plain {pms:.3f} ms")
                tag += f"; {library} backward " + (f"{lms:.3f} ms" if lms else "out of memory")
            print(f"  {tag}", flush=True)
            del q, k, v, do, o, lse, delta, dq, dk, dv, pdq, pdk, pdv


# --------------------------------------------------------------------------- #
# Phase 3: the sync path.
# --------------------------------------------------------------------------- #

# Kernel launches per compressed bucket of one round, by codec: the packs
# (one per codec rank), then the decode's (one per shard of the §12/§13
# scatter decode, one per peer row of a flat bit-plane decode, one for the
# fused flat Bernoulli decode).  The dense simulation and the fixed-k gather
# decode (an index_add) launch no kernel.  A rotated codec packs through the
# fused rotate-min/max + encode-pack pair (inner binary) or rotates each
# rank with one FWHT launch before the inner pack, decodes like its inner
# codec at the padded length, and unrotates the estimate with one more FWHT
# launch.  ``n`` counts the codec ranks and ``nshards`` the scatter shards:
# n and n on the flat mesh; n_eff = n / n_in and n_in under the
# hierarchical schedule, where the stacked communicator packs once per
# codec rank and decodes once per inner shard (every inner rank of a pod
# holds the same gathered rows).
def expected_launches(codec: str, scatter: bool, n: int, nshards: Optional[int] = None) -> dict:
    nshards = n if nshards is None else nshards
    if codec.startswith("ef_"):
        return ef_expected_launches(codec[3:], scatter, n, nshards)
    if codec == "rotated_binary":
        return {"rotate_minmax": n, "encode_pack": n, "fwht": 1,
                **({"bitplane_binary_accum": nshards} if scatter else {"bitplane_unpack": n})}
    if codec == "rotated_fixed_k":
        return {"fwht": n + 1, "fixed_k_gather": n}
    if codec in ("fixed_k_shared", "fixed_k"):
        return {"fixed_k_gather": n}
    if codec == "bernoulli":
        if scatter:
            return {"bernoulli_encode": n, "bernoulli_support_counts": nshards,
                    "bernoulli_decode_sum_shard": nshards}
        return {"bernoulli_encode": n, "bernoulli_decode_sum": 1}
    if codec == "binary":
        return {"bitplane_pack": n,
                **({"bitplane_binary_accum": nshards} if scatter else {"bitplane_unpack": n})}
    if codec in ("ternary", "ternary_opt"):
        return {"bitplane_pack": n, "bitplane_unpack": nshards if scatter else n}
    if codec == "dense":
        return {}
    raise CheckFailed(f"no launch table for codec {codec!r}")


# Error feedback (``core/wire/ef.py``) packs each rank's contractive twin in
# the inner codec's format and decodes as the inner codec does.  The twins:
# fixed-k at scale 1 through the gather kernel, its residual's unpack plain;
# Bernoulli through the unscaled encode, its unpack through the flat decode at
# n = 1 from −0.0 (counted as bernoulli_unpack); binary and ternary pack their planes, their reconstructions come
# from the twin's own mask and centers (no unpack); the rotated twin rotates
# and unrotates each rank with one FWHT launch each (no fused rotate-encode:
# the twin is the deterministic 2-means), the estimate with one more.
def ef_expected_launches(inner: str, scatter: bool, n: int,
                         nshards: Optional[int] = None) -> dict:
    nshards = n if nshards is None else nshards
    if inner in ("fixed_k", "fixed_k_shared"):
        return {"fixed_k_gather": n}
    if inner == "bernoulli":
        decode = ({"bernoulli_support_counts": nshards, "bernoulli_decode_sum_shard": nshards}
                  if scatter else {"bernoulli_decode_sum": 1})
        return {"bernoulli_encode_unscaled": n, "bernoulli_unpack": n, **decode}
    if inner == "binary":
        return {"bitplane_pack": n,
                **({"bitplane_binary_accum": nshards} if scatter else {"bitplane_unpack": n})}
    if inner in ("ternary", "ternary_opt"):
        return {"bitplane_pack": n, "bitplane_unpack": nshards if scatter else n}
    if inner == "rotated_binary":
        return {"fwht": 2 * n + 1, **ef_expected_launches("binary", scatter, n, nshards)}
    raise CheckFailed(f"no launch table for error feedback over {inner!r}")


def closed_form(codec: str, cmp, v, bucket_key) -> float:
    """The codec's closed-form MSE of one bucket's (n, d) round; a rotated
    codec's is its inner closed form at the bucket's rotation (§7.2),
    summed one rank at a time."""
    import torch
    from repro_torch.core import mse, optimal, rotation
    from repro_torch.core.wire import codecs

    q = cmp.encoder.fraction
    if codec in ("rotated_binary", "rotated_fixed_k"):
        krot = rotation.rotation_key(bucket_key)
        k = codecs.fixed_k_blocks(rotation.padded_dim(v.shape[1]), q) * 1024
        total = 0.0
        for i in range(v.shape[0]):
            if codec == "rotated_binary":
                total += float(mse.mse_rotated_binary(v[i:i + 1], krot))
            else:
                total += float(mse.mse_rotated_fixed_k(v[i:i + 1], k, krot))
        return total / v.shape[0] ** 2
    if codec == "fixed_k_shared":
        k = codecs.fixed_k_blocks(v.shape[1], q) * 1024
        return float(mse.mse_fixed_k_shared(v, k, v.mean(1)))
    if codec == "fixed_k":          # independent block supports: Lemma 3.4 over blocks
        nb = -(-v.shape[1] // 1024)
        kb = codecs.fixed_k_blocks(v.shape[1], q)
        ss = sum(float(torch.sum((v[i] - v[i].mean()) ** 2, dtype=torch.float64))
                 for i in range(v.shape[0]))
        return (nb - kb) / kb * ss / v.shape[0] ** 2
    if codec in ("bernoulli", "dense"):
        return float(mse.mse_bernoulli(v, q, v.mean(1)))
    if codec == "binary":
        return float(mse.mse_binary(v))
    c1, c2 = v.amin(1), v.amax(1)
    if codec == "ternary":
        half = (1.0 - q) / 2.0
        return float(mse.mse_ternary(v, half, half, c1, c2))
    if codec == "ternary_opt":   # each rank's own optimal split, one rank at a time
        total = 0.0
        for i in range(v.shape[0]):
            p1, p2 = optimal.ternary_optimal_probs(v[i], q, c1[i], c2[i])
            total += float(mse.mse_ternary(v[i:i + 1], p1, p2, c1[i:i + 1], c2[i:i + 1]))
            del p1, p2
        return total / v.shape[0] ** 2
    raise CheckFailed(f"no closed form for codec {codec!r}")


def codec_layout(cmp, n: int, mesh=None):
    """(codec ranks, scatter shards, the axes averaged exactly before the
    codec) of one round over ``n`` ranks, flat or laid out as ``mesh``."""
    if mesh is None:
        return n, n, ()
    n_codec = math.prod(mesh[a] for a in cmp.axes)
    n_in = math.prod(mesh[a] for a in cmp.inner_axes)
    return n_codec, (n_in if cmp.inner_axes else n_codec), tuple(
        a for a in mesh if a not in cmp.axes)


def shard_copies(b, mesh=None) -> int:
    """How many rounds a bucket's sync runs: one per coordinate of the mesh
    axes its leaves are sharded over (an FSDP shard bucket under a
    compression over pod: one per data coordinate), else one."""
    if mesh is None:
        return 1
    return math.prod(size for a, size in mesh.items() if a not in b.caxes + b.eaxes)


def wire_accounting(plan, cmp, n: int, mesh=None):
    """(wire bits per compressed bucket, the (gathered, reduced) bytes one
    round hands the codec axes): gather codecs ship ``bucket_wire_bits``
    (at the effective node count under a mesh) and psum the exact buckets;
    psum codecs reduce their ``wire_bits`` at the codec ranks and the exact
    buckets together.  The exact means inside a pod (the hierarchical
    pre-reduce, the multi-pod in-pod mean) are inner traffic, counted
    apart."""
    from repro_torch.core import wire
    from repro_torch.train import bucketing

    codec = wire.resolve(cmp)
    n_codec, _, _ = codec_layout(cmp, n, mesh)
    if codec.reduce == "all_gather":
        wire_bits = bucketing.bucket_wire_bits(plan, cmp, n, mesh)
    else:
        wire_bits = {b.bid: codec.wire_bits(n_codec, b.size, cmp)
                     for b in plan.buckets if b.kind == "compressed"}
    # an FSDP shard bucket ships one round per data coordinate
    wire_bits = {b.bid: wire_bits[b.bid] * shard_copies(b, mesh)
                 for b in plan.buckets if b.bid in wire_bits}
    sent = sum(wire_bits.values()) / 8
    exact_bytes = sum(n * b.size * 4 for b in plan.buckets if b.kind == "exact")
    if codec.reduce == "all_gather":
        return wire_bits, (sent, exact_bytes)
    return wire_bits, (0, sent + exact_bytes)


def check_bytes(name: str, comm, want) -> None:
    got = (comm.bytes_gathered, comm.bytes_reduced)
    need(got == want, f"{name}: communicator bytes (gathered, reduced) {got} != accounting {want}")


def error_and_closed_form(codec: str, cmp, plan, stacks, synced, key, mesh=None, specs=None):
    """(Σ squared error of the synced estimate against the exact mean of the
    codec's inputs, Σ closed form) over the plan's compressed buckets; on a
    mesh the codec's inputs are the pod means of the (n, ...) stacks, and
    an FSDP shard bucket's (``specs`` the leaves' specs) are each data
    coordinate's rows, its estimate that coordinate's shard of the synced
    leaves: one round, and one closed form, per coordinate."""
    import torch
    from repro_torch import convert
    from repro_torch import random as prandom
    from repro_torch.core.collectives import StackedComm
    from repro_torch.train import bucketing

    err = cf = 0.0
    _, _, pre = codec_layout(cmp, 0, mesh)
    for j, b in enumerate(plan.buckets):
        if b.kind != "compressed":
            continue
        v = bucketing.pack_bucket(stacks, b)
        k = shard_copies(b, mesh)
        if k > 1:
            need(list(mesh)[-1] == "data" and k == mesh["data"],
                 f"{b.bid}: shards over {mesh}, not over its last axis data")
            for d in range(k):
                rows = v[d::k]
                y = torch.cat([convert.fsdp_shard(synced[s.name], specs[s.name], d, k)
                               .reshape(-1) for s in b.slots])
                err += float(torch.sum((y - rows.mean(0)) ** 2, dtype=torch.float64))
                cf += closed_form(codec, cmp, rows, prandom.fold_in(key, j))
                del rows, y
            del v
            continue
        if pre:
            v = StackedComm(device=v.device, mesh=mesh).mean_over(v, pre)
        y = torch.cat([synced[s.name].reshape(-1) for s in b.slots])
        err += float(torch.sum((y - v.mean(0)) ** 2, dtype=torch.float64))
        cf += closed_form(codec, cmp, v, prandom.fold_in(key, j))
        del v, y
    return err, cf


def run_main_path(name, cmp, steps, launches_total, mesh=None):
    """``steps`` bucketed syncs of one config, the ranks flat or laid out as
    ``mesh``; returns its summary line."""
    import torch
    from repro_torch.core import wire
    from repro_torch.kernels import backend
    from repro_torch.train import bucketing
    from repro_torch.train.synthetic import N, main_path, step_key, synthetic_grads

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    shapes, plan, comm = main_path(cmp, dev, mesh)
    comp = [b for b in plan.buckets if b.kind == "compressed"]
    codec = wire.resolve(cmp)
    n_codec, nshards, _ = codec_layout(cmp, N, mesh)
    expect = expected_launches(codec.name, cmp.scatter_decode, n_codec, nshards)
    wire_bits, want_bytes = wire_accounting(plan, cmp, N, mesh)
    inner_bytes = []
    err_sum = cf_sum = 0.0
    times = []
    for step in range(steps):
        grads = synthetic_grads(shapes, N, step, dev)
        key = step_key(step)
        comm.reset_bytes()
        torch.cuda.synchronize()
        backend.reset_launches()
        t0 = time.perf_counter()
        out, _ = bucketing.sync_grads_bucketed(grads, plan, cmp, key, comm)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts = dict(backend.launches)
        launches_total.update(counts)
        want = {k: v * len(comp) for k, v in expect.items()}
        need(counts == want, f"{name} step {step}: launches {counts} != expected {want}")
        need(all(bool(torch.isfinite(v).all()) for v in out.values()),
             f"{name} step {step}: non-finite output")
        check_bytes(name, comm, want_bytes)
        inner_bytes.append(comm.bytes_inner)
        err, cf = error_and_closed_form(codec.name, cmp, plan, grads, out, key, mesh)
        err_sum += err
        cf_sum += cf
        del grads, out
    ratio = err_sum / cf_sum
    need(abs(ratio - 1.0) <= 0.10, f"{name}: error / closed form = {ratio:.4f}, outside 10%")
    coords = sum(b.size for b in comp)
    wire_mb = sum(wire_bits.values()) / 8 / 1e6
    dense_mb = N * coords * 4 / 1e6
    out = {"config": name, "steps": steps, "ms_per_sync": times,
           "compressed_buckets": len(comp), "coords_per_rank": coords,
           "wire_MB": wire_mb, "dense_f32_MB": dense_mb,
           "err_over_closed_form": ratio, "launches_per_bucket": expect}
    if mesh is not None:
        out.update(mesh=mesh, codec_ranks=n_codec, shards=nshards,
                   inner_MB=[b / 1e6 for b in inner_bytes])
    return out


# The telescoping identity of error feedback (core/wire/ef.py): over T
# rounds from zero residuals, Σ_t est_t = Σ_t x̄_t − ē_T.  The ef_* presets
# gather rows, so every estimate is the mean of the reconstructions the
# residuals subtract and only f32 rounding remains: on the CPU (d = 20,011,
# n = 4, T = 3, tests/test_torch_ef_wire.py) the relative error reads
# 3.0e-8 to 1.2e-7, and 5.3e-8 to 4.3e-7 over the qwen3-4b smoke tree's
# 106,496 coordinates at n = 8 (this phase's code); the limit is twenty
# times the largest.
TELESCOPE_RTOL = 1e-5


def stack_norm(e) -> float:
    """‖e‖ of an (n, size) residual stack in f64, one row at a time (a
    whole-stack temporary at the embed bucket would be 12 GB)."""
    import torch

    return math.sqrt(sum(float(torch.linalg.vector_norm(r, dtype=torch.float64)) ** 2 for r in e))


def stack_finite(e) -> bool:
    """Every value of an (n, size) stack finite, one row at a time."""
    import torch

    return all(bool(torch.isfinite(r).all()) for r in e)


def run_main_path_ef(name, cmp, steps, launches_total):
    """``steps`` bucketed error-feedback syncs of one ``ef_*`` preset, the
    residuals carried from step to step; returns its summary line.

    Checks the launches per bucket (``ef_expected_launches``), finiteness,
    the bytes handed to the communicator against the accounting (the inner
    preset's own) and the telescoping identity over the steps
    (``TELESCOPE_RTOL``).  The twins are deliberately biased contractive
    messages, not the unbiased encoders, so a round's error has no closed
    form and none is checked."""
    import torch
    from repro_torch.core import wire
    from repro_torch.kernels import backend
    from repro_torch.train import bucketing
    from repro_torch.train.synthetic import N, main_path, step_key, synthetic_grads

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    shapes, plan, comm = main_path(cmp, dev)
    comp = [b for b in plan.buckets if b.kind == "compressed"]
    codec = wire.resolve(cmp)
    need(codec.name == name, f"{name}: resolves to {codec.name}")
    expect = expected_launches(codec.name, cmp.scatter_decode, N)
    wire_bits, want_bytes = wire_accounting(plan, cmp, N)
    state = bucketing.init_ef_state(plan, cmp, N, dev)
    # per bucket Σ_t (est_t − x̄_t) and Σ_t est_t, in f32
    drift = {b.bid: torch.zeros(b.size, device=dev) for b in comp}
    est_sum = {b.bid: torch.zeros(b.size, device=dev) for b in comp}
    times, res_norms = [], []
    for step in range(steps):
        grads = synthetic_grads(shapes, N, step, dev)
        key = step_key(step)
        comm.reset_bytes()
        torch.cuda.synchronize()
        backend.reset_launches()
        t0 = time.perf_counter()
        out, state = bucketing.sync_grads_bucketed(grads, plan, cmp, key, comm, state)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts = dict(backend.launches)
        launches_total.update(counts)
        want = {k: v * len(comp) for k, v in expect.items()}
        need(counts == want, f"{name} step {step}: launches {counts} != expected {want}")
        need(all(bool(torch.isfinite(v).all()) for v in out.values())
             and all(stack_finite(e) for e in state.values()),
             f"{name} step {step}: non-finite output or residual")
        check_bytes(name, comm, want_bytes)
        for b in comp:
            est = torch.cat([out[s.name].reshape(-1) for s in b.slots])
            v = bucketing.pack_bucket(grads, b)
            xbar = torch.zeros(b.size, device=dev)
            for r in range(N):
                xbar += v[r]
            drift[b.bid] += est - xbar / N
            est_sum[b.bid] += est
            del est, v, xbar
        res_norms.append(math.sqrt(sum(stack_norm(e) ** 2 for e in state.values())))
        del grads, out
    num = den = 0.0
    for b in comp:
        ebar = torch.zeros(b.size, device=dev)
        for r in range(N):
            ebar += state[b.bid][r]
        num += float(torch.linalg.vector_norm(drift[b.bid] + ebar / N, dtype=torch.float64)) ** 2
        den += float(torch.linalg.vector_norm(est_sum[b.bid], dtype=torch.float64)) ** 2
        del ebar
    rel = math.sqrt(num / den)
    need(rel <= TELESCOPE_RTOL,
         f"{name}: telescoping identity off by {rel:.3g} relative > {TELESCOPE_RTOL}")
    del state, drift, est_sum
    torch.cuda.empty_cache()
    coords = sum(b.size for b in comp)
    return {"config": name, "steps": steps, "ms_per_sync": times,
            "compressed_buckets": len(comp), "coords_per_rank": coords,
            "wire_MB": sum(wire_bits.values()) / 8 / 1e6, "dense_f32_MB": N * coords * 4 / 1e6,
            "telescoping_rel": rel, "telescoping_rtol": TELESCOPE_RTOL,
            "residual_norm_per_step": res_norms, "launches_per_bucket": expect}


# --------------------------------------------------------------------------- #
# Phase 4: the serving path.
# --------------------------------------------------------------------------- #

SERVE_MODEL = "qwen3-4b"
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 8, 2048, 32
SERVE_SEED = 0
# Agreement of two bf16 computations of the same logits (standard deviation
# about 1 at this init: embed scale 0.02 over d = 2560): max |diff| <=
# SERVE_TOL and mean |diff| <= SERVE_MEAN_TOL.  Rehearsed on the CPU, the
# teacher-forced gap grew from 0.035 / 0.005 (max / mean) at 4 layers to
# 0.137 / 0.018 at 36 (d = 512), and was 0.074 / 0.012 at full width and 4
# layers: about 0.3 / 0.04 expected here; a wrong cache slot or rope
# position gives a mean near 1.
SERVE_TOL, SERVE_MEAN_TOL = 0.75, 0.1


def agreement(name: str, got, want) -> dict:
    """Max and mean |got - want| within the serving tolerances, and greedy
    tokens equal wherever ``want``'s top-2 margin exceeds SERVE_TOL."""
    return agreement_over(name, [(got, want)])


def agreement_over(name: str, pairs) -> dict:
    """:func:`agreement` over the positions of several (got, want) pairs of
    (..., V) logits, taken one pair at a time."""
    import torch

    out = {"max_abs": 0.0, "mean_abs": 0.0, "positions": 0, "compared": 0,
           "argmax_equal_all": 0}
    total, count, differ = 0.0, 0, 0
    for got, want in pairs:
        if not want.numel():
            continue
        diff = (got - want).abs()
        top2 = torch.topk(want, 2, dim=-1).values
        decided = (top2[..., 0] - top2[..., 1]) > SERVE_TOL
        same = torch.argmax(got, -1) == torch.argmax(want, -1)
        out["max_abs"] = max(out["max_abs"], float(diff.max()))
        total += float(diff.double().sum())
        count += diff.numel()
        out["positions"] += int(decided.numel())
        out["compared"] += int(decided.sum())
        out["argmax_equal_all"] += int(same.sum())
        differ += int((decided & ~same).sum())
        del diff
    out["mean_abs"] = total / max(count, 1)
    need(out["max_abs"] <= SERVE_TOL and out["mean_abs"] <= SERVE_MEAN_TOL,
         f"{name}: max / mean |diff| {out['max_abs']:.4g} / {out['mean_abs']:.4g} over "
         f"{SERVE_TOL} / {SERVE_MEAN_TOL}")
    need(differ == 0, f"{name}: greedy tokens differ at {differ} positions where the margin > "
                      f"{SERVE_TOL}")
    return out


def serving_params(cfg, n_params: Optional[int] = None):
    """``cfg``'s parameters on the card in bf16: ``model.init``'s f32 draw,
    cast leaf by leaf; their count held to ``n_params`` when given."""
    import torch
    from repro_torch.models import model

    params = model.init(SERVE_SEED, cfg, device=torch.device("cuda"))
    for name in list(params):
        params[name] = params[name].to(torch.bfloat16)
    count = sum(v.numel() for v in params.values())
    need(n_params is None or count == n_params,
         f"{cfg.name}: {count} parameters at {cfg.num_layers} layers, not {n_params}")
    return params


def run_serving(launches_total, arch: str = SERVE_MODEL, layers: Optional[int] = None,
                prompt_len: Optional[int] = None, n_params: Optional[int] = None,
                params=None) -> dict:
    """A dense model (``arch`` at full width, cut to ``layers`` when given;
    ``params`` from :func:`serving_params` when not handed in): SERVE_BATCH
    prompts of ``prompt_len`` (SERVE_PROMPT) seeded tokens; the teacher-forced decode of the
    next SERVE_STEPS tokens against one forward over all of them; the user's
    entry points (``engine.generate``: one kernel-11 launch a layer per
    prefill); the cache's shape (``s_max`` = the whole sequence, or a
    window's width, which the decode's ring then wraps past); the flash
    prefill against ``attn_impl="xla"``; the LM head's time in a decode
    step.  Returns the summary line."""
    import torch
    from repro_torch.configs.base import RunConfig, ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention.kernel import launch_name
    from repro_torch.models import model, transformer
    from repro_torch.serving import engine

    dev = torch.device("cuda")
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    run = RunConfig()                     # flash attention, bf16 compute
    prompt_len = prompt_len or SERVE_PROMPT
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if params is None:
        params = serving_params(cfg, n_params)
    n_params = sum(v.numel() for v in params.values())
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED + 1)
    total = prompt_len + SERVE_STEPS
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, total), generator=gen, device=dev)
    prompt = {"tokens": tokens[:, :prompt_len]}
    prefill_fn, decode_fn = engine.build_serve_fns(
        cfg, run, ShapeSpec("serve", "decode", total, SERVE_BATCH), device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()

    # teacher-forced: decode the known continuation after a prefill of the
    # prompt, against one forward over all the tokens (this also warms up)
    ctx = model.make_ctx(cfg, run)
    with torch.no_grad():
        cache, _ = prefill_fn(params, prompt)
        dec = []
        for i in range(SERVE_STEPS):
            pos = prompt_len + i
            _, logits, cache = model.decode_step(ctx, params, cfg, run, cache,
                                                 tokens[:, pos:pos + 1], pos)
            dec.append(logits)
        del cache
        x = model.embed_inputs(ctx, params, cfg, {"tokens": tokens})
        h, _, _ = transformer.forward(ctx, params, cfg, run, x, torch.arange(total, device=dev))
        full = transformer.lm_head_logits(ctx, params, cfg, h[:, prompt_len:])
        del x, h
    teacher = agreement(f"{cfg.name}: teacher-forced decode vs forward of {total}",
                        torch.cat(dec, dim=1), full)
    del dec, full

    # the main path, as a user drives it; every count zeroed just before it
    out, times, seen, counts = serve_main_path(prefill_fn, decode_fn, params, prompt,
                                               launches_total)
    flash = launch_name("flash_attention_fwd", cfg.hd)
    need(counts == {flash: cfg.num_layers},
         f"{cfg.name} serving: launches {counts} != one {flash} per layer ({cfg.num_layers})")
    need(tuple(out.shape) == (SERVE_BATCH, SERVE_STEPS), f"serving: tokens {tuple(out.shape)}")
    need(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "serving: token out of range")
    cache, flash_logits = seen["prefill"]
    need(bool(torch.isfinite(flash_logits).all()), "serving: non-finite prefill logits")
    s_max = total if cfg.window is None else min(total, cfg.window)
    slots = max(prompt_len, s_max)
    want_shape = (cfg.num_layers, SERVE_BATCH, slots, cfg.num_kv_heads, cfg.hd)
    need(tuple(cache["k"].shape) == tuple(cache["v"].shape) == want_shape,
         f"{cfg.name} serving: cache {tuple(cache['k'].shape)}, not {want_shape}")
    cache_bytes = ssm_cache_bytes(cache)
    del seen, cache

    chunk = plain_block(prompt_len, run.attn_chunk_q)     # the chunks tile the prompt
    xla_run = dataclasses.replace(run, attn_impl="xla", attn_chunk_q=chunk, attn_chunk_k=chunk)
    with torch.no_grad():
        _, xla_logits = model.prefill(ctx, params, cfg, xla_run, prompt)
    xla = agreement(f"{cfg.name}: flash prefill vs xla prefill", flash_logits, xla_logits)
    h1 = torch.randn((SERVE_BATCH, 1, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    lm_head_ms = cuda_ms(lambda: transformer.lm_head_logits(ctx, params, cfg, h1), reps=10)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del params, flash_logits, xla_logits
    torch.cuda.empty_cache()

    prefill_ms = times["prefill"][0]
    decode_ms = sum(times["decode"]) / len(times["decode"])
    ring = {} if cfg.window is None else {
        "window": cfg.window, "ring_slots": slots, "last_position": total - 1,
        "decode_writes_wrapped": max(0, total - slots)}
    return {"model": cfg.name, "layers": cfg.num_layers,
            "of_layers": get_config(arch).num_layers, "params": n_params,
            "batch": SERVE_BATCH, "prompt": prompt_len, "decode_steps": SERVE_STEPS,
            "setup_s": setup_s, "prefill_ms": prefill_ms,
            "prefill_tokens_per_s": SERVE_BATCH * prompt_len / prefill_ms * 1e3,
            "decode_ms_per_token": decode_ms, "decode_ms": times["decode"],
            "decode_tokens_per_s": SERVE_BATCH / decode_ms * 1e3,
            "lm_head_ms": lm_head_ms, "lm_head_share_of_decode": lm_head_ms / decode_ms,
            "flash_launches_per_prefill": counts.get(flash, 0), "cache_bytes": cache_bytes, **ring,
            "teacher_forced": teacher, "flash_vs_xla": xla, "init_peak_GiB": init_peak,
            "serve_peak_GiB": peak}


# --------------------------------------------------------------------------- #
# Phase 4b: serving the MoE family.
# --------------------------------------------------------------------------- #

# (arch, layers or None for all): olmoe-1b-7b whole; qwen2-moe-a2.7b (14.3 B
# parameters at 24 layers) at full width and 4 layers, with its shared experts
MOE_SERVE = (("olmoe-1b-7b", None), ("qwen2-moe-a2.7b", 4))


@contextlib.contextmanager
def moe_routes(log: list, force: Optional[list] = None):
    """Within the span every MoE call (``moe.route``, then in the block
    ``moe.capacity_slots``) appends its routing to ``log``, on the card:
    ``ids`` the k experts of each token sorted, ``order`` as chosen,
    ``keep`` the (t, k) keep mask (None in the decode).  With ``force``, a
    log of the same calls in the same order, each call takes that log's
    experts in their order, gated by its own probabilities (renormalized)."""
    import torch
    from repro_torch.models import moe

    route, slots = moe.route, moe.capacity_slots
    calls = iter(force) if force is not None else None

    def routed(router, x, cfg):
        probs, gates, ids = route(router, x, cfg)
        if calls is not None:
            ids = next(calls)["order"]
            gates = probs.gather(1, ids)
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        log.append({"ids": torch.sort(ids, dim=-1).values, "order": ids, "keep": None})
        return probs, gates, ids

    def slotted(flat_e, ep, cap):
        slot, keep = slots(flat_e, ep, cap)
        log[-1]["keep"] = keep.reshape(log[-1]["ids"].shape)
        return slot, keep

    moe.route, moe.capacity_slots = routed, slotted
    try:
        yield log
    finally:
        moe.route, moe.capacity_slots = route, slots


def flipped_tokens(a: list, b: list):
    """(t,) bool: the tokens whose experts or keep mask differ in any call
    of two logs of the same calls."""
    need(len(a) == len(b) and len(a) > 0, f"route logs of {len(a)} and {len(b)} calls")
    out = None
    for x, y in zip(a, b):
        f = (x["ids"] != y["ids"]).any(-1)
        if x["keep"] is not None:
            f |= (x["keep"] != y["keep"]).any(-1)
        out = f if out is None else out | f
    return out


def rerouted(a: list, b: list) -> dict:
    """How far two logs of the same calls part: the share of tokens whose
    experts or keep mask differ in each call, and in any."""
    per_call = [float(flipped_tokens([x], [y]).float().mean()) for x, y in zip(a, b)]
    return {"share_by_call": per_call, "share_any": float(flipped_tokens(a, b).float().mean())}


def serve_main_path(prefill_fn, decode_fn, params, prompt, launches_total,
                    steps: Optional[int] = None):
    """``engine.generate`` as a user drives it (``steps``, by default
    SERVE_STEPS, greedy steps),
    every launch count zeroed just before it and added to
    ``launches_total`` after it, each prefill and decode call timed (host
    clock around a synchronize).  Returns (tokens, {"prefill": [ms],
    "decode": [ms]}, the last output of each, the launch counts)."""
    import torch
    from repro_torch.kernels import backend
    from repro_torch.serving import engine

    times = {"prefill": [], "decode": []}
    seen = {}

    def timed(fn, key):
        def call(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            times[key].append((time.perf_counter() - t) * 1e3)
            seen[key] = out
            return out
        return call

    backend.reset_launches()
    out = engine.generate(timed(prefill_fn, "prefill"), timed(decode_fn, "decode"), params,
                          prompt, steps or SERVE_STEPS)
    counts = dict(backend.launches)
    launches_total.update(counts)
    return out, times, seen, counts


def moe_teacher_forced(name: str, params, cfg, run, one, prompt_len: int, moe_calls: int):
    """The teacher-forced check of an MoE model on one sequence ``one`` (1,
    T) at capacity factor E/k (cap = t: nothing dropped; at the configured
    factor the block drops pairs and the decode, which runs every expert,
    never does): one forward over the T tokens, its ``moe_calls`` MoE calls'
    routes recorded; then the prefill of ``prompt_len`` tokens and a decode
    step a token up to T, as they route and on the forward's routes; the
    forced run's logits against the forward's within the serving
    tolerances.  Returns the agreement with the prompt's rerouted share, the
    decode steps that rerouted and the forced run's ms a decode step."""
    import torch
    from repro_torch.models import model, transformer

    m = cfg.moe
    nodrop = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.padded(1) / m.top_k))
    ctx = model.make_ctx(nodrop, run)
    total = one.shape[1]
    fwd_log = []
    with moe_routes(fwd_log):
        x = model.embed_inputs(ctx, params, nodrop, {"tokens": one})
        h, _, _ = transformer.forward(ctx, params, nodrop, run, x,
                                      torch.arange(total, device=one.device))
    full = transformer.lm_head_logits(ctx, params, nodrop, h[:, prompt_len:])
    del x, h
    need(len(fwd_log) == moe_calls and all(bool(e["keep"].all()) for e in fwd_log),
         f"{name} teacher-forced: a pair was dropped at capacity factor E/k")
    # the forward's routes as the prefill's and each decode step's calls
    want = ([{"order": e["order"][:prompt_len], "ids": e["ids"][:prompt_len],
              "keep": e["keep"][:prompt_len]} for e in fwd_log]
            + [{"order": e["order"][p:p + 1], "ids": e["ids"][p:p + 1], "keep": None}
               for p in range(prompt_len, total) for e in fwd_log])

    def teacher_forced(log, force=None):
        dec = []
        with moe_routes(log, force=force):
            cache, _ = model.prefill(ctx, params, nodrop, run,
                                     {"tokens": one[:, :prompt_len]}, s_max=total)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for pos in range(prompt_len, total):
                _, logits, cache = model.decode_step(ctx, params, nodrop, run, cache,
                                                     one[:, pos:pos + 1], pos)
                dec.append(logits)
            torch.cuda.synchronize()
        return torch.cat(dec, dim=1), (time.perf_counter() - t) * 1e3 / (total - prompt_len)

    as_is = []
    teacher_forced(as_is)
    moved = rerouted(as_is, want)
    dec, decode_ms = teacher_forced([], force=want)
    teacher = agreement(f"{name}: teacher-forced decode on the forward's routes vs forward of "
                        f"{total}, no drops", dec, full)
    steps_moved = sum(1 for i in range(total - prompt_len)
                      if any(moved["share_by_call"][moe_calls * (1 + i) + li]
                             for li in range(moe_calls)))
    teacher.update(step0_max_abs=float((dec[:, 0] - full[:, 0]).abs().max()),
                   prompt_rerouted_share=rerouted(as_is[:moe_calls], want[:moe_calls])["share_any"],
                   decode_steps_rerouted=steps_moved)
    return teacher, decode_ms


def moe_flash_vs_xla(name: str, params, cfg, run, prompt):
    """Flash against ``attn_impl="xla"`` on an MoE model: one forward over
    the prompts each, routes recorded; flash twice (the same bits and
    routes), xla as it routes and on flash's routes; the logits of flash and
    of xla on flash's routes at every position within the serving
    tolerances.  Returns (the agreement with xla's rerouted share per MoE
    call and in any, the share of (token, choice) pairs dropped per MoE
    call in the flash run, each forward's ms: the main path's prefill is the
    first call at its shapes, these come after it)."""
    import torch
    from repro_torch.models import model, transformer

    ctx = model.make_ctx(cfg, run)
    s = prompt["tokens"].shape[1]
    logs, hs, forward_ms = {}, {}, {}
    for label, impl, force in (("flash", "flash", None), ("again", "flash", None),
                               ("xla", "xla", None), ("forced", "xla", "flash")):
        logs[label] = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        with moe_routes(logs[label], force=logs[force] if force else None):
            x = model.embed_inputs(ctx, params, cfg, prompt)
            hs[label], _, _ = transformer.forward(ctx, params, cfg,
                                                  dataclasses.replace(run, attn_impl=impl), x,
                                                  torch.arange(s, device=x.device))
        torch.cuda.synchronize()
        forward_ms[label] = (time.perf_counter() - t) * 1e3
        del x
    need(same_bits(hs["flash"], hs["again"]) and not bool(flipped_tokens(
        logs["flash"], logs["again"]).any()), f"{name}: two flash forwards differ")
    moved = rerouted(logs["xla"], logs["flash"])
    dropped = [float(1.0 - e["keep"].float().mean()) for e in logs["flash"]]
    del logs, hs["again"], hs["xla"]

    def pairs():
        for r in range(hs["flash"].shape[0]):
            yield (transformer.lm_head_logits(ctx, params, cfg, hs["flash"][r:r + 1])[0],
                   transformer.lm_head_logits(ctx, params, cfg, hs["forced"][r:r + 1])[0])

    xla = agreement_over(f"{name}: flash vs xla forward on flash's routes, every position",
                         pairs())
    xla.update(rerouted_share_by_layer=moved["share_by_call"],
               rerouted_share_any_layer=moved["share_any"])
    return xla, dropped, forward_ms


def run_serving_moe(arch: str, layers: Optional[int], launches_total) -> dict:
    """An MoE model at full width (``layers`` of its layers, all if None):
    the user's entry points, checked and timed, as phase 4; returns the
    summary line.

    Routing is discrete: two bf16 computations of the same function route
    some tokens differently at near-ties, and in a random-init MoE model
    one rerouted token moves its own later layers by O(1), the other tokens
    of its sequence through attention and, past capacity, the keep mask of
    later pairs, so the rerouted share grows layer by layer.  Each
    comparison therefore records the first computation's routes, runs the
    second one as is (its rerouted share per layer reported) and again with
    the first one's experts forced (``moe_routes(force=)``), and holds the
    forced run's logits to the serving tolerances at every position.
    Capacity drops make the forward and the decode differ by design (the
    block drops pairs past ``cap``, the decode runs every expert), so the
    teacher-forced check runs one prompt at capacity factor E/k (cap = t:
    nothing dropped).  Flash against ``attn_impl="xla"``: one forward over
    the 8 prompts each, every position's logits; the flash forward run
    twice gives the same routes and bits (each forward timed: the main
    path's prefill is the first call at its shapes, these come after it).
    The share of (token, choice)
    pairs dropped at the configured factor is read per layer from the
    flash run."""
    import torch
    from repro_torch.configs.base import RunConfig, ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.serving import engine

    dev = torch.device("cuda")
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    L, m = cfg.num_layers, cfg.moe
    run = RunConfig()                     # flash attention, bf16 compute
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = serving_params(cfg)
    n_params = sum(v.numel() for v in params.values())
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED + 1)
    total = SERVE_PROMPT + SERVE_STEPS
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, total), generator=gen, device=dev)
    prompt = {"tokens": tokens[:, :SERVE_PROMPT]}
    prefill_fn, decode_fn = engine.build_serve_fns(
        cfg, run, ShapeSpec("serve", "decode", total, SERVE_BATCH), device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()

    # teacher-forced on one prompt with nothing dropped (this also warms up)
    teacher, _ = moe_teacher_forced(arch, params, cfg, run, tokens[:1], SERVE_PROMPT, L)

    out, times, seen, counts = serve_main_path(prefill_fn, decode_fn, params, prompt,
                                               launches_total)
    need(counts == {"flash_attention_fwd": L},
         f"{arch} serving: launches {counts} != one flash forward per layer ({L})")
    need(tuple(out.shape) == (SERVE_BATCH, SERVE_STEPS), f"{arch} serving: tokens {out.shape}")
    need(bool(((out >= 0) & (out < cfg.vocab_size)).all()), f"{arch} serving: token out of range")
    need(bool(torch.isfinite(seen["prefill"][1]).all()), f"{arch} serving: non-finite logits")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del seen

    xla, dropped, forward_ms = moe_flash_vs_xla(arch, params, cfg, run, prompt)
    del params
    torch.cuda.empty_cache()

    prefill_ms = times["prefill"][0]
    decode_ms = sum(times["decode"]) / len(times["decode"])
    return {"model": arch, "layers": L, "params": n_params, "experts": m.num_experts,
            "top_k": m.top_k, "shared": m.num_shared, "capacity_factor": m.capacity_factor,
            "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "decode_steps": SERVE_STEPS,
            "setup_s": setup_s, "prefill_ms": prefill_ms,
            "prefill_tokens_per_s": SERVE_BATCH * SERVE_PROMPT / prefill_ms * 1e3,
            "forward_ms_after_it": forward_ms,
            "decode_ms_per_token": decode_ms, "decode_ms": times["decode"],
            "decode_tokens_per_s": SERVE_BATCH / decode_ms * 1e3,
            "flash_launches_per_prefill": counts.get("flash_attention_fwd", 0),
            "dropped_pair_share_per_layer": dropped, "teacher_forced_no_drop": teacher,
            "flash_vs_xla": xla, "init_peak_GiB": init_peak, "serve_peak_GiB": peak}


# --------------------------------------------------------------------------- #
# Phase 4c: serving the SSM family.
# --------------------------------------------------------------------------- #

# One prompt of SERVE_PROMPT tokens, then SSM_TEACHER teacher-forced decode
# steps against one forward over the SERVE_PROMPT + SSM_TEACHER tokens (a
# multiple of the 256-token chunk: the scan never pads), under the serving
# tolerances (SERVE_TOL, SERVE_MEAN_TOL).  This holds the chunked scan
# against the decode recurrence.  Rehearsed on the CPU at full width and 24
# layers, bf16, a 256-token prompt and 256 steps: max / mean |diff| 0.209 /
# 0.024 (logits' std 0.55), step 0 at 7e-7.
SSM_TEACHER = 256
# One prompt's forward in f32 compute on the card against the same code on
# the CPU: ‖Δh‖/‖h‖ of the final hidden states ≤ SSM_F32_H_RTOL and the last
# position's logits within SSM_F32_LOGIT_TOL.  Two f32 computations differ by
# their sums' orders, amplified through the 24 layers: rehearsed on the CPU
# (full width, 24 layers, one 256-token sequence), f32 against f64 read
# 4.9e-4 on h and 1.6e-3 on the logits (std 0.55).  A wrong chunk carry or a
# TF32 product is off by 1e-2 or more.
SSM_F32_H_RTOL, SSM_F32_LOGIT_TOL = 5e-3, 1e-2
# the reference's prefill_32k length, at batch 1
SSM_LONG_PROMPT = 32768


def ssm_cache_bytes(cache: dict) -> int:
    return sum(v.numel() * v.element_size() for v in cache.values())


def run_serving_ssm(launches_total) -> dict:
    """mamba2-130m whole (24 layers, full width), parameters drawn from a seed:
    one prompt's f32 forward on the card against the CPU; then in bf16 the
    teacher-forced check, the user's entry points (``engine.generate``, 8
    prompts of 2048 tokens, 32 greedy steps: no kernel, the family has no
    attention), and one 32,768-token prompt at batch 1 whose cache takes the
    bytes of a 2048-token prompt's; returns the summary line."""
    import torch
    from repro_torch.configs.base import RunConfig, ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model, transformer
    from repro_torch.serving import engine
    from repro_torch.train import synthetic

    dev = torch.device("cuda")
    cfg = get_config(synthetic.SSM_MODEL)
    s = cfg.ssm
    run = RunConfig()                     # bf16 compute
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(SERVE_SEED, cfg, device=dev)          # f32
    n_params = sum(v.numel() for v in params.values())
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED + 1)
    total = SERVE_PROMPT + SSM_TEACHER
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, total), generator=gen, device=dev)
    prompt = {"tokens": tokens[:, :SERVE_PROMPT]}

    # one prompt in f32 compute, on the card and on the CPU
    f32 = dataclasses.replace(run, compute_dtype="float32")
    ctx32 = model.make_ctx(cfg, f32)
    one = {"tokens": tokens[:1, :SERVE_PROMPT]}
    outs = {}
    for where in ("card", "cpu"):
        p = params if where == "card" else {k: v.cpu() for k, v in params.items()}
        b = {k: (v if where == "card" else v.cpu()) for k, v in one.items()}
        t = time.perf_counter()
        with torch.no_grad():
            x = model.embed_inputs(ctx32, p, cfg, b)
            h, _, _ = transformer.forward(ctx32, p, cfg, f32, x, None)
            logits = transformer.lm_head_logits(ctx32, p, cfg, h[:, -1:])
        outs[where] = (h.cpu(), logits.cpu(), (time.perf_counter() - t) * 1e3)
        del p, x, h, logits
    (hc, lc, ms_card), (hh, lh, ms_cpu) = outs["card"], outs["cpu"]
    f32_check = {"h_rel": float((hc.double() - hh.double()).norm() / hh.double().norm()),
                 "last_logits_max_abs": float((lc - lh).abs().max()),
                 "logits_std": float(lh.std()), "card_ms": ms_card, "cpu_ms": ms_cpu}
    need(bool(torch.isfinite(hc).all()), "mamba2 f32 forward on the card: not finite")
    need(f32_check["h_rel"] <= SSM_F32_H_RTOL and
         f32_check["last_logits_max_abs"] <= SSM_F32_LOGIT_TOL,
         f"mamba2 f32 forward, card vs CPU: {f32_check} over {SSM_F32_H_RTOL} / "
         f"{SSM_F32_LOGIT_TOL}")
    del outs, hc, lc, hh, lh

    for name in list(params):                                 # then bf16 leaf by leaf
        params[name] = params[name].to(torch.bfloat16)
    prefill_fn, decode_fn = engine.build_serve_fns(
        cfg, run, ShapeSpec("serve", "decode", SERVE_PROMPT + SERVE_STEPS, SERVE_BATCH),
        device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()

    # teacher-forced on one prompt: decode the known continuation after a
    # prefill, against one forward over all its tokens (this also warms up)
    ctx = model.make_ctx(cfg, run)
    seq = tokens[:1]
    cache, _ = model.prefill(ctx, params, cfg, run, {"tokens": seq[:, :SERVE_PROMPT]})
    dec = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(SSM_TEACHER):
        pos = SERVE_PROMPT + i
        _, logits, cache = model.decode_step(ctx, params, cfg, run, cache, seq[:, pos:pos + 1],
                                             pos)
        dec.append(logits)
    torch.cuda.synchronize()
    batch1_decode_ms = (time.perf_counter() - t) * 1e3 / SSM_TEACHER
    del cache
    x = model.embed_inputs(ctx, params, cfg, {"tokens": seq})
    h, _, _ = transformer.forward(ctx, params, cfg, run, x, None)
    full = transformer.lm_head_logits(ctx, params, cfg, h[:, SERVE_PROMPT:])
    del x, h
    dec = torch.cat(dec, dim=1)
    teacher = agreement(f"mamba2: teacher-forced decode vs forward of {total}", dec, full)
    teacher["step0_max_abs"] = float((dec[:, 0] - full[:, 0]).abs().max())
    del dec, full

    # the main path, as a user drives it; every count zeroed just before it
    out, times, seen, counts = serve_main_path(prefill_fn, decode_fn, params, prompt,
                                               launches_total)
    need(counts == {}, f"mamba2 serving: launches {counts}; the SSM family launches no kernel")
    need(tuple(out.shape) == (SERVE_BATCH, SERVE_STEPS), f"mamba2 serving: tokens {out.shape}")
    need(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "mamba2 serving: token out of range")
    cache, logits = seen["prefill"]
    need(bool(torch.isfinite(logits).all()), "mamba2 serving: non-finite prefill logits")
    cache_bytes = ssm_cache_bytes(cache)
    per_seq = (s.conv_width - 1) * (s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state) * 2 \
        + s.nheads(cfg.d_model) * s.head_dim * s.d_state * 4
    need(cache_bytes == SERVE_BATCH * cfg.num_layers * per_seq,
         f"mamba2 serving: cache of {cache_bytes} B, not {SERVE_BATCH} x {cfg.num_layers} x "
         f"{per_seq}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del seen, cache, logits

    # one prompt of the reference's prefill_32k length, batch 1: the same
    # cache bytes a sequence as the 2048-token prompts'
    long = torch.randint(0, cfg.vocab_size, (1, SSM_LONG_PROMPT), generator=gen, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    long_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        lcache, llogits = model.prefill(ctx, params, cfg, run, {"tokens": long})
        torch.cuda.synchronize()
        long_ms.append((time.perf_counter() - t) * 1e3)
    need(bool(torch.isfinite(llogits).all()), "mamba2 32k prefill: non-finite logits")
    long_bytes = ssm_cache_bytes(lcache)
    need(long_bytes * SERVE_BATCH == cache_bytes,
         f"mamba2: the 32k prompt's cache {long_bytes} B != a 2048-token prompt's "
         f"{cache_bytes // SERVE_BATCH} B")
    long_peak = torch.cuda.max_memory_allocated() / 2**30
    del params, lcache, llogits
    torch.cuda.empty_cache()

    prefill_ms = times["prefill"][0]
    decode_ms = sum(times["decode"]) / len(times["decode"])
    return {"model": cfg.name, "layers": cfg.num_layers, "params": n_params,
            "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "decode_steps": SERVE_STEPS,
            "setup_s": setup_s, "prefill_ms": prefill_ms,
            "prefill_tokens_per_s": SERVE_BATCH * SERVE_PROMPT / prefill_ms * 1e3,
            "decode_ms_per_token": decode_ms, "decode_ms": times["decode"],
            "decode_tokens_per_s": SERVE_BATCH / decode_ms * 1e3,
            "batch1_decode_ms_per_token": batch1_decode_ms,
            "cache_bytes": cache_bytes, "cache_bytes_per_sequence": cache_bytes // SERVE_BATCH,
            "long_prompt": SSM_LONG_PROMPT, "long_prefill_ms": long_ms,
            "long_prefill_tokens_per_s": SSM_LONG_PROMPT / min(long_ms) * 1e3,
            "long_cache_bytes": long_bytes, "long_peak_GiB": long_peak,
            "teacher_forced": teacher, "f32_card_vs_cpu": f32_check,
            "init_peak_GiB": init_peak, "serve_peak_GiB": peak}


# --------------------------------------------------------------------------- #
# Phase 4d: serving the hybrid family.
# --------------------------------------------------------------------------- #

HYBRID_MODEL = "jamba-v0.1-52b"
# one of its four periods: 8 of 32 layers at full width (the whole model's
# 51.5 B parameters take 103 GB in bf16; one period's f32 init 53 GB)
HYBRID_LAYERS = 8
HYBRID_PARAMS = 13_267_598_848
# the smoke hybrid at two periods, one batch of prompts in f32 on the card and
# on the CPU, on the card's routes, held to phase 4c's limits (two f32
# computations differ by their sums' orders; a wrong period row or cache
# regroup is off by far more)
HYBRID_F32_PERIODS, HYBRID_F32_BATCH, HYBRID_F32_PROMPT = 2, 4, 256
# the reference's prefill_32k length, at batch 1 (jamba is sub-quadratic)
HYBRID_LONG_PROMPT = 32768
# teacher-forced decode steps after the 2048-token prompt: the forward over
# the prompt and them must be a multiple of the 256-token SSD chunk (the
# scan never pads), as in phase 4c
HYBRID_TEACHER = SSM_TEACHER


def hybrid_cache_bytes(cache: dict) -> int:
    return sum(v.numel() * v.element_size() for part in cache.values() for v in part.values())


def check_hybrid_f32_card_vs_cpu() -> dict:
    """The smoke hybrid at two periods (the reference's smoke config has
    one), f32 compute, one batch of prompts: the card's forward (the flash
    kernel at hd 16, f32) against the CPU's (the plain version) on the
    card's routes."""
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import model, transformer

    cfg = dataclasses.replace(smoke_config(HYBRID_MODEL), num_layers=4 * HYBRID_F32_PERIODS)
    run = RunConfig(remat=False, compute_dtype="float32")
    ctx = model.make_ctx(cfg, run)
    params = model.init(SERVE_SEED, cfg, device="cpu")
    gen = torch.Generator().manual_seed(SERVE_SEED + 2)
    tokens = torch.randint(0, cfg.vocab_size, (HYBRID_F32_BATCH, HYBRID_F32_PROMPT), generator=gen)
    outs, log = {}, []
    for where in ("card", "cpu"):
        dev = torch.device("cuda") if where == "card" else torch.device("cpu")
        force = None if where == "card" else [
            {k: (None if v is None else v.cpu()) for k, v in e.items()} for e in log]
        t = time.perf_counter()
        with torch.no_grad(), moe_routes([] if force else log, force=force):
            p = {k: v.to(dev) for k, v in params.items()}
            x = model.embed_inputs(ctx, p, cfg, {"tokens": tokens.to(dev)})
            h, aux, _ = transformer.forward(ctx, p, cfg, run, x,
                                            torch.arange(HYBRID_F32_PROMPT, device=dev))
            logits = transformer.lm_head_logits(ctx, p, cfg, h[:, -1:])
        outs[where] = (h.cpu(), logits.cpu(), float(aux), (time.perf_counter() - t) * 1e3)
        del p, x, h, logits
    (hc, lc, ac, ms_card), (hh, lh, ah, ms_cpu) = outs["card"], outs["cpu"]
    out = {"layers": cfg.num_layers, "moe_calls": len(log),
           "h_rel": float((hc.double() - hh.double()).norm() / hh.double().norm()),
           "last_logits_max_abs": float((lc - lh).abs().max()), "logits_std": float(lh.std()),
           "aux_card": ac, "aux_cpu": ah, "card_ms": ms_card, "cpu_ms": ms_cpu}
    need(len(log) == 2 * HYBRID_F32_PERIODS, f"hybrid f32: {len(log)} MoE calls recorded")
    need(bool(torch.isfinite(hc).all()), "hybrid f32 forward on the card: not finite")
    need(out["h_rel"] <= SSM_F32_H_RTOL and out["last_logits_max_abs"] <= SSM_F32_LOGIT_TOL,
         f"hybrid f32 forward at {HYBRID_F32_PERIODS} periods, card vs CPU: {out} over "
         f"{SSM_F32_H_RTOL} / {SSM_F32_LOGIT_TOL}")
    return out


def run_serving_hybrid(launches_total) -> dict:
    """jamba-v0.1-52b at full width, one of its four periods (8 of 32
    layers: every sublayer kind in the period's exact layout), parameters
    drawn in f32 on the card and cast to bf16 leaf by leaf: the checks and
    the user's entry points of phase 4b (the teacher-forced decode on one
    prompt at capacity factor E/k on the forward's routes; flash against
    ``attn_impl="xla"`` on flash's routes), the cache's bytes against the
    exact count, and one 32,768-token prompt at batch 1; after the smoke
    hybrid's two-period f32 forward on the card against the CPU.  Returns
    the summary line."""
    import torch
    from repro_torch.configs.base import RunConfig, ShapeSpec
    from repro_torch.configs.registry import get_config, hybrid_layout
    from repro_torch.kernels import backend
    from repro_torch.models import model
    from repro_torch.serving import engine

    f32_check = check_hybrid_f32_card_vs_cpu()
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(HYBRID_MODEL), num_layers=HYBRID_LAYERS)
    per, np_, nm, n_moe, _ = hybrid_layout(cfg)
    m, s = cfg.moe, cfg.ssm
    L_moe = np_ * n_moe
    run = RunConfig()                     # flash attention, bf16 compute
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = serving_params(cfg, HYBRID_PARAMS)
    n_params = sum(v.numel() for v in params.values())
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED + 1)
    total, tf_total = SERVE_PROMPT + SERVE_STEPS, SERVE_PROMPT + HYBRID_TEACHER
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, max(total, tf_total)),
                           generator=gen, device=dev)
    prompt = {"tokens": tokens[:, :SERVE_PROMPT]}
    prefill_fn, decode_fn = engine.build_serve_fns(
        cfg, run, ShapeSpec("serve", "decode", total, SERVE_BATCH), device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()

    # teacher-forced on one prompt with nothing dropped (this also warms up)
    teacher, batch1_decode_ms = moe_teacher_forced(
        "jamba", params, cfg, run, tokens[:1, :tf_total], SERVE_PROMPT, L_moe)

    out, times, seen, counts = serve_main_path(prefill_fn, decode_fn, params, prompt,
                                               launches_total)
    need(counts == {"flash_attention_fwd": np_},
         f"jamba serving: launches {counts} != one flash forward per period ({np_})")
    need(tuple(out.shape) == (SERVE_BATCH, SERVE_STEPS), f"jamba serving: tokens {out.shape}")
    need(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "jamba serving: token out of range")
    cache, logits = seen["prefill"]
    need(bool(torch.isfinite(logits).all()), "jamba serving: non-finite prefill logits")
    kv_seq = np_ * total * cfg.num_kv_heads * cfg.hd * 2 * 2          # k and v, bf16
    mixer_seq = (s.conv_width - 1) * (s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state) * 2 \
        + s.nheads(cfg.d_model) * s.head_dim * s.d_state * 4
    cache_bytes = hybrid_cache_bytes(cache)
    need(cache_bytes == SERVE_BATCH * (kv_seq + np_ * nm * mixer_seq),
         f"jamba serving: cache of {cache_bytes} B, not {SERVE_BATCH} x ({kv_seq} + "
         f"{np_ * nm} x {mixer_seq})")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del seen, cache, logits

    xla, dropped, forward_ms = moe_flash_vs_xla("jamba", params, cfg, run, prompt)
    ctx = model.make_ctx(cfg, run)

    # one prompt of the reference's prefill_32k length, batch 1
    long = torch.randint(0, cfg.vocab_size, (1, HYBRID_LONG_PROMPT), generator=gen, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    long_ms, long_out = [], {}
    try:
        for _ in range(2):
            backend.reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            with torch.no_grad():
                lcache, llogits = model.prefill(ctx, params, cfg, run, {"tokens": long})
            torch.cuda.synchronize()
            long_ms.append((time.perf_counter() - t) * 1e3)
            long_launches = dict(backend.launches)
        need(long_launches == {"flash_attention_fwd": np_},
             f"jamba 32k prefill: launches {long_launches}")
        need(bool(torch.isfinite(llogits).all()), "jamba 32k prefill: non-finite logits")
        long_bytes = hybrid_cache_bytes(lcache)
        want_bytes = np_ * HYBRID_LONG_PROMPT * cfg.num_kv_heads * cfg.hd * 2 * 2 \
            + np_ * nm * mixer_seq
        need(long_bytes == want_bytes, f"jamba 32k prefill: cache {long_bytes} B, not "
                                       f"{want_bytes}")
        long_out = {"long_prefill_ms": long_ms,
                    "long_prefill_tokens_per_s": HYBRID_LONG_PROMPT / min(long_ms) * 1e3,
                    "long_cache_bytes": long_bytes, "long_flash_launches": long_launches}
        del lcache, llogits
    except torch.cuda.OutOfMemoryError as e:
        long_out = {"long_prefill": f"out of memory: {str(e).splitlines()[0]}"}
    long_out["long_peak_GiB"] = torch.cuda.max_memory_allocated() / 2**30
    del params
    torch.cuda.empty_cache()

    prefill_ms = times["prefill"][0]
    decode_ms = sum(times["decode"]) / len(times["decode"])
    return {"model": cfg.name, "layers": cfg.num_layers,
            "of_layers": get_config(HYBRID_MODEL).num_layers, "params": n_params, "period": per,
            "attn_offset": cfg.attn_offset,
            "experts": m.num_experts, "top_k": m.top_k, "capacity_factor": m.capacity_factor,
            "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "decode_steps": SERVE_STEPS,
            "setup_s": setup_s, "prefill_ms": prefill_ms,
            "prefill_tokens_per_s": SERVE_BATCH * SERVE_PROMPT / prefill_ms * 1e3,
            "forward_ms_after_it": forward_ms,
            "decode_ms_per_token": decode_ms, "decode_ms": times["decode"],
            "decode_tokens_per_s": SERVE_BATCH / decode_ms * 1e3,
            "batch1_decode_ms_per_token": batch1_decode_ms,
            "flash_launches_per_prefill": counts.get("flash_attention_fwd", 0),
            "cache_bytes": cache_bytes, "cache_bytes_per_sequence": cache_bytes // SERVE_BATCH,
            "long_prompt": HYBRID_LONG_PROMPT, **long_out,
            "dropped_pair_share_per_moe_layer": dropped, "teacher_forced_no_drop": teacher,
            "flash_vs_xla": xla, "f32_card_vs_cpu": f32_check,
            "init_peak_GiB": init_peak, "serve_peak_GiB": peak}


# --------------------------------------------------------------------------- #
# Phase 4e: serving the encoder-decoder family.
# --------------------------------------------------------------------------- #

ENCDEC_MODEL = "whisper-medium"
ENCDEC_PARAMS = 757_877_760
# the smoke model (2 + 2 layers) in f32 compute, one batch of prompts with
# the cache's 96 frames, the card's encoder and decoder against the CPU's,
# held to phase 4c's limits (two f32 computations differ by their sums'
# orders; a wrong position, mask or cross-attention input is off by far more)
ENCDEC_F32_BATCH, ENCDEC_F32_PROMPT = 4, 256
# teacher-forced decode steps after the 2048-token prompt, against one
# forward over the 2112 tokens in chunks of 704 (the chunked attention never
# pads: a chunk must divide the length); a step takes about 50 ms at batch 1
ENCDEC_TEACHER, ENCDEC_TEACHER_CHUNK = 64, 704
# the bf16 cache of the 8 prompts: the self K/V at s_max = 2080 and the cross
# K/V at 1536 frames, 24 layers of 16 heads × 64 each
ENCDEC_CACHE_BYTES = 2_843_738_112


def check_encdec_f32_card_vs_cpu() -> dict:
    """The smoke encoder-decoder in f32 compute, one batch of prompts and
    frames: the encoder output, the decoder's final hidden states and the
    last position's logits on the card against the CPU (no kernel on
    either: the family's attention is the plain chunked softmax)."""
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import encdec, model, transformer

    cfg = smoke_config(ENCDEC_MODEL)
    run = RunConfig(remat=False, compute_dtype="float32")
    ctx = model.make_ctx(cfg, run)
    params = model.init(SERVE_SEED, cfg, device="cpu")
    gen = torch.Generator().manual_seed(SERVE_SEED + 2)
    tokens = torch.randint(0, cfg.vocab_size, (ENCDEC_F32_BATCH, ENCDEC_F32_PROMPT), generator=gen)
    frames = torch.randn((ENCDEC_F32_BATCH, encdec.enc_seq_padded(cfg, 1), cfg.d_model),
                         generator=gen)
    outs = {}
    for where in ("card", "cpu"):
        dev = torch.device("cuda") if where == "card" else torch.device("cpu")
        t = time.perf_counter()
        with torch.no_grad():
            p = {k: v.to(dev) for k, v in params.items()}
            enc = encdec.encode(ctx, p, cfg, run, frames.to(dev))
            x = encdec.embed_decoder(ctx, p, cfg, tokens.to(dev))
            h, _ = encdec._decoder_forward(ctx, p, cfg, run, x, enc, False)
            logits = transformer.lm_head_logits(ctx, p, cfg, h[:, -1:])
        outs[where] = (enc.cpu(), h.cpu(), logits.cpu(), (time.perf_counter() - t) * 1e3)
        del p, enc, x, h, logits
    (ec, hc, lc, ms_card), (eh, hh, lh, ms_cpu) = outs["card"], outs["cpu"]
    rel = lambda a, b: float((a.double() - b.double()).norm() / b.double().norm())
    out = {"layers": [cfg.encoder_layers, cfg.num_layers], "enc_rel": rel(ec, eh),
           "h_rel": rel(hc, hh), "last_logits_max_abs": float((lc - lh).abs().max()),
           "logits_std": float(lh.std()), "card_ms": ms_card, "cpu_ms": ms_cpu}
    need(bool(torch.isfinite(hc).all()), "whisper f32 forward on the card: not finite")
    need(max(out["enc_rel"], out["h_rel"]) <= SSM_F32_H_RTOL
         and out["last_logits_max_abs"] <= SSM_F32_LOGIT_TOL,
         f"whisper f32 forward, card vs CPU: {out} over {SSM_F32_H_RTOL} / {SSM_F32_LOGIT_TOL}")
    return out


def run_serving_encdec(launches_total) -> dict:
    """whisper-medium whole (24 + 24 layers, full width, 757,877,760
    parameters drawn in f32 on the card and cast to bf16 leaf by leaf),
    after the smoke model's f32 forward on the card against the CPU: the
    teacher-forced decode of one prompt against one longer forward, the
    user's entry points (``engine.generate``, 8 prompts of 2048 seeded
    tokens with 1536 seeded frames each, 32 greedy steps: no kernel), the
    cache's bytes against the exact count, the prefill timed again beside
    the encoder alone.  Returns the summary line."""
    import torch
    from repro_torch.configs.base import RunConfig, ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.models import encdec, model, transformer
    from repro_torch.serving import engine

    f32_check = check_encdec_f32_card_vs_cpu()
    dev = torch.device("cuda")
    cfg = get_config(ENCDEC_MODEL)
    run = RunConfig()                     # bf16 compute; the family ignores attn_impl
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = serving_params(cfg, ENCDEC_PARAMS)
    n_params = sum(v.numel() for v in params.values())
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED + 1)
    total, tf_total = SERVE_PROMPT + SERVE_STEPS, SERVE_PROMPT + ENCDEC_TEACHER
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, max(total, tf_total)),
                           generator=gen, device=dev)
    frames = torch.randn((SERVE_BATCH, encdec.enc_seq_padded(cfg, 16), cfg.d_model),
                         generator=gen, device=dev)
    prompt = {"tokens": tokens[:, :SERVE_PROMPT], "frames": frames}
    prefill_fn, decode_fn = engine.build_serve_fns(
        cfg, run, ShapeSpec("serve", "decode", total, SERVE_BATCH), device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()

    # teacher-forced on one prompt: decode the known continuation after a
    # prefill, against one forward over all its tokens (this also warms up)
    ctx = model.make_ctx(cfg, run)
    seq, one = tokens[:1, :tf_total], {"frames": frames[:1]}
    with torch.no_grad():
        cache, _ = model.prefill(ctx, params, cfg, run,
                                 {"tokens": seq[:, :SERVE_PROMPT], **one}, s_max=tf_total)
        dec = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(ENCDEC_TEACHER):
            pos = SERVE_PROMPT + i
            _, logits, cache = model.decode_step(ctx, params, cfg, run, cache,
                                                 seq[:, pos:pos + 1], pos)
            dec.append(logits)
        torch.cuda.synchronize()
        batch1_decode_ms = (time.perf_counter() - t) * 1e3 / ENCDEC_TEACHER
        del cache
        chunked = dataclasses.replace(run, attn_chunk_q=ENCDEC_TEACHER_CHUNK,
                                      attn_chunk_k=ENCDEC_TEACHER_CHUNK)
        enc = encdec.encode(ctx, params, cfg, chunked, one["frames"])
        h, _ = encdec._decoder_forward(ctx, params, cfg, chunked,
                                       encdec.embed_decoder(ctx, params, cfg, seq), enc, False)
        full = transformer.lm_head_logits(ctx, params, cfg, h[:, SERVE_PROMPT:])
        del enc, h
    dec = torch.cat(dec, dim=1)
    teacher = agreement(f"whisper: teacher-forced decode vs forward of {tf_total}", dec, full)
    teacher["step0_max_abs"] = float((dec[:, 0] - full[:, 0]).abs().max())
    del dec, full

    # the main path, as a user drives it; every count zeroed just before it
    out, times, seen, counts = serve_main_path(prefill_fn, decode_fn, params, prompt,
                                               launches_total)
    need(counts == {}, f"whisper serving: launches {counts}; the family launches no kernel")
    need(tuple(out.shape) == (SERVE_BATCH, SERVE_STEPS), f"whisper serving: tokens {out.shape}")
    need(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "whisper serving: token out of range")
    cache, logits = seen["prefill"]
    need(bool(torch.isfinite(logits).all()), "whisper serving: non-finite prefill logits")
    cache_bytes = ssm_cache_bytes(cache)
    kv = cfg.num_layers * cfg.num_kv_heads * cfg.hd * 2 * 2               # k and v, bf16
    need(cache_bytes == SERVE_BATCH * kv * (total + frames.shape[1]) == ENCDEC_CACHE_BYTES,
         f"whisper serving: cache of {cache_bytes} B, not {ENCDEC_CACHE_BYTES}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del seen, cache, logits

    # the encoder's share of a prefill: the encoder alone on the prompts'
    # frames and the whole prefill again, in turns
    encoder_ms, again_ms = [], []
    for _ in range(2):
        for fn, sink in ((lambda: encdec.encode(ctx, params, cfg, run, frames), encoder_ms),
                         (lambda: prefill_fn(params, prompt), again_ms)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            with torch.no_grad():
                res = fn()
            torch.cuda.synchronize()
            sink.append((time.perf_counter() - t) * 1e3)
            del res
    del params
    torch.cuda.empty_cache()

    prefill_ms = times["prefill"][0]
    decode_ms = sum(times["decode"]) / len(times["decode"])
    return {"model": cfg.name, "layers": [cfg.encoder_layers, cfg.num_layers],
            "params": n_params, "batch": SERVE_BATCH, "prompt": SERVE_PROMPT,
            "frames": frames.shape[1], "decode_steps": SERVE_STEPS, "setup_s": setup_s,
            "prefill_ms": prefill_ms, "prefill_ms_again": again_ms, "encoder_ms": encoder_ms,
            "prefill_tokens_per_s": SERVE_BATCH * SERVE_PROMPT / prefill_ms * 1e3,
            "decode_ms_per_token": decode_ms, "decode_ms": times["decode"],
            "decode_tokens_per_s": SERVE_BATCH / decode_ms * 1e3,
            "batch1_decode_ms_per_token": batch1_decode_ms,
            "cache_bytes": cache_bytes, "cache_bytes_per_sequence": cache_bytes // SERVE_BATCH,
            "teacher_forced": teacher, "f32_card_vs_cpu": f32_check,
            "init_peak_GiB": init_peak, "serve_peak_GiB": peak}


# --------------------------------------------------------------------------- #
# Phase 4f: serving the VLM family.
# --------------------------------------------------------------------------- #

VLM_MODEL = "llava-next-34b"
# 20 of its 60 layers at full width: the whole model's 34.4 B parameters take
# 68.9 GB in bf16, and model.init draws every leaf in f32 on the card before
# the cast (137.8 GB); 20 layers draw 48.5 GB
VLM_LAYERS = 20
VLM_PARAMS = 12_126_026_752
# the smoke llava (2 layers, 8 patches) in f32 compute, one batch of prompts
# of 8 patches and 248 tokens, on the card (kernel 11's f32 path at hd 16)
# against the CPU (its plain version), held to phase 4c's limits
VLM_F32_BATCH, VLM_F32_TEXT = 4, 248
# the bf16 cache of the 8 prompts at s_max = 2080 (1152 patches, 896 tokens
# and 32 decoded): 20 layers of k and v, 8 kv heads × 128
VLM_CACHE_BYTES = 1_363_148_800


def check_vlm_f32_card_vs_cpu() -> dict:
    """The smoke VLM in f32 compute, one batch of prompts and patches: the
    final hidden states and the last position's logits on the card against
    the CPU."""
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import model, transformer

    cfg = smoke_config(VLM_MODEL)
    run = RunConfig(remat=False, compute_dtype="float32")
    ctx = model.make_ctx(cfg, run)
    params = model.init(SERVE_SEED, cfg, device="cpu")
    gen = torch.Generator().manual_seed(SERVE_SEED + 2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (VLM_F32_BATCH, VLM_F32_TEXT),
                                     generator=gen),
             "patches": torch.randn((VLM_F32_BATCH, cfg.num_patches, cfg.d_model),
                                    generator=gen)}
    s = model.seq_total(batch)
    outs = {}
    for where in ("card", "cpu"):
        dev = torch.device("cuda") if where == "card" else torch.device("cpu")
        t = time.perf_counter()
        with torch.no_grad():
            p = {k: v.to(dev) for k, v in params.items()}
            x = model.embed_inputs(ctx, p, cfg, {k: v.to(dev) for k, v in batch.items()})
            h, _, _ = transformer.forward(ctx, p, cfg, run, x, torch.arange(s, device=dev))
            logits = transformer.lm_head_logits(ctx, p, cfg, h[:, -1:])
        outs[where] = (h.cpu(), logits.cpu(), (time.perf_counter() - t) * 1e3)
        del p, x, h, logits
    (hc, lc, ms_card), (hh, lh, ms_cpu) = outs["card"], outs["cpu"]
    out = {"layers": cfg.num_layers, "positions": s,
           "h_rel": float((hc.double() - hh.double()).norm() / hh.double().norm()),
           "last_logits_max_abs": float((lc - lh).abs().max()), "logits_std": float(lh.std()),
           "card_ms": ms_card, "cpu_ms": ms_cpu}
    need(bool(torch.isfinite(hc).all()), "llava f32 forward on the card: not finite")
    need(out["h_rel"] <= SSM_F32_H_RTOL and out["last_logits_max_abs"] <= SSM_F32_LOGIT_TOL,
         f"llava f32 forward, card vs CPU: {out} over {SSM_F32_H_RTOL} / {SSM_F32_LOGIT_TOL}")
    return out


def run_serving_vlm(launches_total) -> dict:
    """llava-next-34b at full width and VLM_LAYERS of its 60 layers
    (parameters drawn in f32 on the card and cast to bf16 leaf by leaf),
    after the smoke VLM's f32 forward on the card against the CPU: 8
    prompts of 1152 seeded patch embeddings and SERVE_PROMPT − 1152 seeded
    tokens; the teacher-forced decode of the next SERVE_STEPS tokens
    against one forward over all SERVE_PROMPT + SERVE_STEPS positions, the
    user's entry points (``engine.generate``: one kernel-11 launch a layer
    per prefill, decoding from position SERVE_PROMPT), the cache's bytes
    against the exact count, the flash prefill against
    ``attn_impl="xla"``.  Returns the summary line."""
    import torch
    from repro_torch.configs.base import RunConfig, ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model, transformer
    from repro_torch.serving import engine

    f32_check = check_vlm_f32_card_vs_cpu()
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(VLM_MODEL), num_layers=VLM_LAYERS)
    run = RunConfig()                     # flash attention, bf16 compute
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = serving_params(cfg, VLM_PARAMS)
    n_params = sum(v.numel() for v in params.values())
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED + 1)
    n_patch = cfg.num_patches
    text, total = SERVE_PROMPT - n_patch, SERVE_PROMPT + SERVE_STEPS
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, text + SERVE_STEPS), generator=gen,
                           device=dev)
    patches = torch.randn((SERVE_BATCH, n_patch, cfg.d_model), generator=gen, device=dev)
    prompt = {"tokens": tokens[:, :text], "patches": patches}
    prefill_fn, decode_fn = engine.build_serve_fns(
        cfg, run, ShapeSpec("serve", "decode", total, SERVE_BATCH), device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()

    # teacher-forced: decode the known tokens after the prompt's patches and
    # tokens, against one forward over all 2080 positions (this also warms up)
    ctx = model.make_ctx(cfg, run)
    with torch.no_grad():
        cache, _ = prefill_fn(params, prompt)
        dec = []
        for i in range(SERVE_STEPS):
            _, logits, cache = model.decode_step(ctx, params, cfg, run, cache,
                                                 tokens[:, text + i:text + i + 1],
                                                 SERVE_PROMPT + i)
            dec.append(logits)
        del cache
        whole = {"tokens": tokens, "patches": patches}
        x = model.embed_inputs(ctx, params, cfg, whole)
        h, _, _ = transformer.forward(ctx, params, cfg, run, x,
                                      torch.arange(model.seq_total(whole), device=dev))
        full = transformer.lm_head_logits(ctx, params, cfg, h[:, SERVE_PROMPT:])
        del x, h
    dec = torch.cat(dec, dim=1)
    teacher = agreement(f"llava: teacher-forced decode vs forward of {total}", dec, full)
    teacher["step0_max_abs"] = float((dec[:, 0] - full[:, 0]).abs().max())
    del dec, full

    # the main path, as a user drives it; every count zeroed just before it
    out, times, seen, counts = serve_main_path(prefill_fn, decode_fn, params, prompt,
                                               launches_total)
    need(counts == {"flash_attention_fwd": cfg.num_layers},
         f"llava serving: launches {counts} != one flash forward per layer ({cfg.num_layers})")
    need(tuple(out.shape) == (SERVE_BATCH, SERVE_STEPS), f"llava serving: tokens {out.shape}")
    need(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "llava serving: token out of range")
    cache, flash_logits = seen["prefill"]
    need(bool(torch.isfinite(flash_logits).all()), "llava serving: non-finite prefill logits")
    cache_bytes = ssm_cache_bytes(cache)
    need(cache_bytes == VLM_CACHE_BYTES == SERVE_BATCH * total * cfg.num_layers * 2
         * cfg.num_kv_heads * cfg.hd * 2,
         f"llava serving: cache of {cache_bytes} B, not {VLM_CACHE_BYTES}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del seen, cache

    with torch.no_grad():
        _, xla_logits = model.prefill(ctx, params, cfg, dataclasses.replace(run, attn_impl="xla"),
                                      prompt)
    xla = agreement("llava: flash prefill vs xla prefill", flash_logits, xla_logits)
    del params, flash_logits, xla_logits
    torch.cuda.empty_cache()

    prefill_ms = times["prefill"][0]
    decode_ms = sum(times["decode"]) / len(times["decode"])
    return {"model": cfg.name, "layers": cfg.num_layers,
            "of_layers": get_config(VLM_MODEL).num_layers, "params": n_params,
            "batch": SERVE_BATCH, "patches": n_patch, "tokens": text, "prompt": SERVE_PROMPT,
            "decode_steps": SERVE_STEPS, "setup_s": setup_s, "prefill_ms": prefill_ms,
            "prefill_positions_per_s": SERVE_BATCH * SERVE_PROMPT / prefill_ms * 1e3,
            "decode_ms_per_token": decode_ms, "decode_ms": times["decode"],
            "decode_tokens_per_s": SERVE_BATCH / decode_ms * 1e3,
            "flash_launches_per_prefill": counts.get("flash_attention_fwd", 0),
            "cache_bytes": cache_bytes, "teacher_forced": teacher, "flash_vs_xla": xla,
            "f32_card_vs_cpu": f32_check, "init_peak_GiB": init_peak, "serve_peak_GiB": peak}


# --------------------------------------------------------------------------- #
# Phase 4g: the reference's last three dense configs.
# --------------------------------------------------------------------------- #

# (arch, layers or None for all, parameters): minitron-4b whole (24/8 heads,
# g = 3; an untied 256,000-row embedding and head); mistral-large-123b at
# full width, 8 of its 88 layers (96/8 heads, g = 12): the whole model's
# 245 GB in bf16 fit no card, and model.init's f32 draw of 8 layers takes
# 47.5 GB.  Each serves SERVE_BATCH prompts of SERVE_PROMPT tokens.
DENSE_SERVE = (("minitron-4b", None, 5_096_279_040), ("mistral-large-123b", 8, 11_878_477_824))
# h2o-danube-3-4b whole (hd 120, window 4096): prompts of 4080 tokens and
# SERVE_STEPS decoded, 4112 positions in a 4096-slot ring (s_max = min(4112,
# 4096)): the decode writes slots 4080-4095, then wraps to 0-15
DANUBE_MODEL = "h2o-danube-3-4b"
DANUBE_PARAMS = 3_961_839_360
DANUBE_PROMPT = 4080
# then one prompt of the reference's prefill_32k length at batch 1: its
# cache keeps all 32,768 slots (24 layers x 8 kv heads x 120 x 2 B, k and
# v); its decode attends all of them (the reference's decode passes no
# window); the flash prefill is held against attn_impl="xla" on the first
# DANUBE_XLA_LAYERS layers (the chunked path visits all 1024 chunk pairs a
# layer at 32k)
DANUBE_LONG, DANUBE_LONG_STEPS = 32768, 4
DANUBE_LONG_CACHE_BYTES = 3_019_898_880
DANUBE_XLA_LAYERS = 4


def run_serving_long_window(cfg, params, launches_total) -> dict:
    """One DANUBE_LONG-token prompt at batch 1 through the user's entry
    points (one kernel-11 launch a layer, the window skipping dead key
    tiles) and DANUBE_LONG_STEPS greedy tokens: the cache's bytes, ms a
    token; the flash prefill's last logits against ``attn_impl="xla"`` on
    the first DANUBE_XLA_LAYERS layers.  No teacher-forced check: past the
    window the reference's decode and its prefill attend different keys."""
    import torch
    from repro_torch.configs.base import RunConfig, ShapeSpec
    from repro_torch.kernels.flash_attention.kernel import launch_name
    from repro_torch.models import model
    from repro_torch.serving import engine

    dev = torch.device("cuda")
    run = RunConfig()
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED + 3)
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (1, DANUBE_LONG), generator=gen,
                                      device=dev)}
    prefill_fn, decode_fn = engine.build_serve_fns(
        cfg, run, ShapeSpec("serve", "decode", DANUBE_LONG + DANUBE_LONG_STEPS, 1), device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out, times, seen, counts = serve_main_path(prefill_fn, decode_fn, params, prompt,
                                               launches_total, steps=DANUBE_LONG_STEPS)
    flash = launch_name("flash_attention_fwd", cfg.hd)
    need(counts == {flash: cfg.num_layers},
         f"{cfg.name} 32k prompt: launches {counts} != one {flash} per layer")
    need(tuple(out.shape) == (1, DANUBE_LONG_STEPS), f"32k prompt: tokens {tuple(out.shape)}")
    cache, logits = seen["prefill"]
    cache_bytes = ssm_cache_bytes(cache)
    need(cache_bytes == DANUBE_LONG_CACHE_BYTES == cfg.num_layers * DANUBE_LONG * 2
         * cfg.num_kv_heads * cfg.hd * 2 and cache["k"].shape[2] == DANUBE_LONG,
         f"{cfg.name} 32k prompt: cache of {cache_bytes} B, {tuple(cache['k'].shape)}")
    need(bool(torch.isfinite(logits).all()), "32k prompt: non-finite logits")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del seen, cache, logits

    cut = dataclasses.replace(cfg, num_layers=DANUBE_XLA_LAYERS)
    first = {k: v[:DANUBE_XLA_LAYERS] if k.startswith("layers.") else v
             for k, v in params.items()}
    ctx = model.make_ctx(cut, run)
    with torch.no_grad():
        _, fl = model.prefill(ctx, first, cut, run, prompt)
        t = time.perf_counter()
        _, xl = model.prefill(ctx, first, cut, dataclasses.replace(run, attn_impl="xla"), prompt)
        torch.cuda.synchronize()
        xla_ms = (time.perf_counter() - t) * 1e3
    xla = agreement(f"{cfg.name} 32k prompt, {DANUBE_XLA_LAYERS} layers: flash vs xla", fl, xl)
    del fl, xl, first
    torch.cuda.empty_cache()
    decode_ms = sum(times["decode"]) / len(times["decode"])
    return {"prompt": DANUBE_LONG, "batch": 1, "prefill_ms": times["prefill"][0],
            "prefill_tokens_per_s": DANUBE_LONG / times["prefill"][0] * 1e3,
            "decode_ms_per_token": decode_ms, "decode_ms": times["decode"],
            "cache_bytes": cache_bytes, "decode_attends_slots": DANUBE_LONG,
            "flash_vs_xla_first_layers": {"layers": DANUBE_XLA_LAYERS, **xla,
                                          "xla_prefill_ms": xla_ms},
            "peak_GiB": peak}


def run_serving_dense(launches_total) -> dict:
    """Phase 4g: minitron-4b and mistral-large-123b (DENSE_SERVE) through
    :func:`run_serving`; h2o-danube-3-4b whole through it with prompts of
    DANUBE_PROMPT tokens (the decode's ring wraps), then the same
    parameters through :func:`run_serving_long_window`.  Returns {arch:
    summary}."""
    from repro_torch.configs.registry import get_config

    out = {}
    for arch, layers, n_params in DENSE_SERVE:
        t0 = time.perf_counter()
        out[arch] = run_serving(launches_total, arch, layers, n_params=n_params)
        out[arch]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = get_config(DANUBE_MODEL)
    params = serving_params(cfg, DANUBE_PARAMS)
    need(DANUBE_PROMPT + SERVE_STEPS > cfg.window > DANUBE_PROMPT,
         f"{DANUBE_MODEL}: the decode of {DANUBE_PROMPT} + {SERVE_STEPS} does not wrap its ring")
    ring = run_serving(launches_total, DANUBE_MODEL, prompt_len=DANUBE_PROMPT, params=params)
    ring["long_prompt"] = run_serving_long_window(cfg, params, launches_total)
    ring["phase_s"] = time.perf_counter() - t0
    out[DANUBE_MODEL] = ring
    return out


# --------------------------------------------------------------------------- #
# Phase 5: the training path.
# --------------------------------------------------------------------------- #

TRAIN_SEED = 0
# Step 0, rank 0, on the main path's parameters and batch.
# (1) bf16, every flash call of the step checked in place: each kernel call
# is also computed by the plain blockwise version in 64 × 64 tiles on the
# same inputs (the kernels tile otherwise: the forward 128 × 128, the dK/dV
# sweep 128 keys against 64-row q tiles, the dQ sweep 128 q rows against
# 64-key tiles; for rows that see a key the result does not depend on the
# tiling), within phase 2's limits (FLASH_TOL and LSE_TOL for the forward,
# BWD_BF16_REL for the two sweeps).
# (2) bf16, the whole model's loss and gradients with the kernels against the
# plain flash in 64 × 64 tiles and against attn_impl="xla" (plain-torch
# chunked attention under autograd): per-leaf ‖Δg‖/‖g‖ ≤ TRAIN_GRAD_TOL and
# |Δloss|/|loss| ≤ TRAIN_LOSS_RTOL, set before the first run from a CPU
# rehearsal at full width (launch/compare_attn_grads.py, one 512-token
# sequence: plain flash in 64-blocks against xla in 512-chunks, 1.4e-2 and
# 2.0e-2 at 1 and 2 layers).  In bf16 no limit can be much tighter: the
# model's own bf16 roundings amplify any difference (the same script with
# --perturb: dq, dk, dv moved by 1e-6 relative move the gradients of one
# layer by up to 1.2e-3).  A wrong dS, scale or mask is off by order 1.
TRAIN_GRAD_TOL, TRAIN_LOSS_RTOL = 5e-2, 1e-3
# (3) f32 compute, where that perturbation moves the gradients by 1e-6: the
# whole model's loss and gradients with the kernels (their f32 paths)
# against the plain flash in 64 × 64 tiles, per-leaf ≤ TRAIN_F32_GRAD_TOL
# and loss ≤ TRAIN_F32_LOSS_RTOL relative (the f32 kernels read ≤ 1.3e-6
# relative against the plain sweeps in phase 2).
TRAIN_F32_GRAD_TOL, TRAIN_F32_LOSS_RTOL = 1e-4, 1e-5
TRAIN_PLAIN_BLOCK = 64


@contextlib.contextmanager
def flash_on_card(block: int, check: Optional[dict] = None):
    """Within the span, ``ops.flash_attention`` on CUDA tensors runs either
    the plain blockwise forward and backward sweeps at ``block`` × ``block``
    in place of kernels 11–13, launching none of them (``check`` None), or
    the kernels, each call also computed by the plain version on the same
    inputs and held against it (phase 2's limits), the worst reading of
    each kernel kept in ``check``."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.flash_attention import ops as fao
    from repro_torch.kernels.flash_attention import ref as far

    names = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    plain = {k: functools.partial(getattr(far, k), block_q=block, block_k=block) for k in names}

    def checked(name):
        def call(*args, **kw):
            got = getattr(fak, name)(*args, **kw)
            want = plain[name](*args, **kw)
            dt = "bfloat16" if args[0].dtype == torch.bfloat16 else "float32"
            tag = f"step 0, rank 0: {name} {tuple(args[0].shape)} {dt}"
            if name == "flash_attention_fwd":
                (o, lse), (po, plse) = got, want
                need(within(o, po, *FLASH_TOL[dt]), f"{tag}: o outside {FLASH_TOL[dt]}")
                need(max_err(lse, plse) <= LSE_TOL, f"{tag}: lse off by > {LSE_TOL}")
                reading = max_err(o, po)
            else:
                gots, wants = (got, want) if isinstance(got, tuple) else ((got,), (want,))
                pairs = list(zip(gots, wants))
                if dt == "float32":
                    need(all(within(g, w, *BWD_F32_TOL) for g, w in pairs),
                         f"{tag}: outside {BWD_F32_TOL}")
                reading = max(rel_err(g, w) for g, w in pairs)
                need(dt == "float32" or reading <= BWD_BF16_REL,
                     f"{tag}: relative error {reading:.3g} > {BWD_BF16_REL}")
            check[name] = max(check.get(name, 0.0), reading)
            return got
        return call

    stand_in = types.SimpleNamespace(**{
        k: (plain[k] if check is None else checked(k)) for k in names})
    kernels, fao._kernel = fao._kernel, stand_in
    try:
        yield
    finally:
        fao._kernel = kernels


def _agreement(got, want, grad_tol: float, loss_rtol: float, what: str) -> dict:
    """Loss and per-leaf gradient agreement of two (loss, grads) pairs,
    checked against the limits; returns the readings."""
    import torch
    from repro_torch.train import synthetic

    (lg, gg), (lw, gw) = got, want
    need(all(bool(torch.isfinite(g).all()) for g in gg.values()), f"{what}: gradients not finite")
    errs = synthetic.grad_rel_errs(gg, gw)
    worst = max(errs, key=errs.get)
    loss_rel = abs(lg - lw) / abs(lw)
    need(errs[worst] <= grad_tol,
         f"{what} gradients: {worst} off by {errs[worst]:.3g} > {grad_tol}")
    need(loss_rel <= loss_rtol, f"{what} loss: {lg} vs {lw}, {loss_rel:.3g} > {loss_rtol} relative")
    return {"loss": [lg, lw], "loss_rel": loss_rel, "worst_leaf": worst,
            "worst_rel": errs[worst], "rel": errs}


def run_training(launches_total, keep: Optional[dict] = None) -> dict:
    """qwen3-4b at full width and 4 layers, 8 stacked ranks of one
    4096-token sequence, ``fixed_k_1bit``: the agreement checks of step 0,
    then ``Trainer.fit`` for ``TRAIN_STEPS`` steps, every phase checked and
    timed (host clock after a synchronize; the checks run outside the timed
    spans); returns the summary line and leaves the run's end state in
    ``keep`` (as ``fit_and_check``)."""
    import torch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import backend
    from repro_torch.models import model
    from repro_torch.train import synthetic

    dev = torch.device("cuda")
    cfg, run, shape = synthetic.train_main_path()
    n, steps, L = synthetic.N, synthetic.TRAIN_STEPS, cfg.num_layers
    global_tokens = float(shape.global_batch * shape.seq_len)
    torch.cuda.empty_cache()

    # step 0, rank 0: the flash kernels, each call checked, against the
    # plain flash in their tiles and the chunked attention; then in f32
    params = model.init(TRAIN_SEED, cfg, device=dev)
    batch = SyntheticLM(cfg, shape, seed=TRAIN_SEED).batch(0, dev)
    rank0 = {k: v[:shape.global_batch // n] for k, v in batch.items()}
    flash = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    per_call = {}
    backend.reset_launches()
    with flash_on_card(TRAIN_PLAIN_BLOCK, per_call):
        kern = synthetic.rank_loss_and_grads(cfg, run, params, rank0, global_tokens)
    got = {k: backend.launches[k] for k in flash}
    need(got == dict(zip(flash, (2 * L, L, L))), f"step 0, rank 0: flash launches {got}")
    with flash_on_card(TRAIN_PLAIN_BLOCK):
        plain = synthetic.rank_loss_and_grads(cfg, run, params, rank0, global_tokens)
    xla = synthetic.rank_loss_and_grads(cfg, dataclasses.replace(run, attn_impl="xla"), params,
                                        rank0, global_tokens)
    f32 = dataclasses.replace(run, compute_dtype="float32")
    kern32 = synthetic.rank_loss_and_grads(cfg, f32, params, rank0, global_tokens)
    with flash_on_card(TRAIN_PLAIN_BLOCK):
        plain32 = synthetic.rank_loss_and_grads(cfg, f32, params, rank0, global_tokens)
    need({k: backend.launches[k] for k in flash} == {k: 2 * v for k, v in got.items()},
         "step 0, rank 0: the plain flash launched a kernel")
    agree = {
        "flash_per_call_vs_plain64": per_call,
        "flash_vs_plain64": _agreement(kern, plain, TRAIN_GRAD_TOL, TRAIN_LOSS_RTOL,
                                       "flash kernels vs plain flash"),
        "flash_vs_xla": _agreement(kern, xla, TRAIN_GRAD_TOL, TRAIN_LOSS_RTOL,
                                   "flash kernels vs xla"),
        "plain64_vs_xla": _agreement(plain, xla, TRAIN_GRAD_TOL, TRAIN_LOSS_RTOL,
                                     "plain flash vs xla"),
        "f32_flash_vs_plain64": _agreement(kern32, plain32, TRAIN_F32_GRAD_TOL,
                                           TRAIN_F32_LOSS_RTOL, "f32 flash kernels vs plain")}
    del params, batch, rank0, kern, plain, xla, kern32, plain32
    torch.cuda.empty_cache()

    summary = fit_and_check(cfg, run, shape, n, steps, synthetic.TRAIN_PRESET, launches_total,
                            keep=keep, digest_steps=(TWIN_STEPS - 1,))
    return {**summary, **agree}


def fit_and_check(cfg, run, shape, n: int, steps: int, preset: str, launches_total,
                  mesh=None, keep: Optional[dict] = None,
                  digest_steps: Tuple[int, ...] = ()) -> dict:
    """``Trainer.fit`` for ``steps`` steps on ``n`` ranks (flat, or laid out
    as ``mesh``), every phase of every step checked and timed (host clock
    after a synchronize; the checks run outside the timed spans): the
    launches of each phase (where the model has attention flash forward
    2·L·n with remat, each backward sweep L·n; the sync's per bucket at the codec ranks: in the backward
    under the backward-pipelined schedule, in the sync phase after it), the
    bytes handed to the codec axes against the accounting, finite
    gradients, losses, norms and parameters; without error feedback the
    sync's error against the closed form at the codec ranks (within 10%; on
    a mesh over the pod means), with it each bucket's residual norm after
    every step.  Each step's bucket rounds are read from their events
    (``step_report.sync_timeline``: issue order, issue and end against the
    backward's end, the exposed sync ms).  Returns the summary line, with
    ``digest``, the state after each of ``digest_steps`` (parameters, m, v,
    residuals; ``step_report.state_digest``), when asked; ``keep``, when
    given, receives the end state (``params``, ``opt_state``, ``hist``)."""
    import torch
    from repro_torch.core import wire
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention.kernel import launch_name
    from repro_torch.launch.step_report import state_digest, sync_timeline
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda")
    L = cfg.num_layers
    cmp = run.compression
    codec = wire.resolve(cmp)
    flash = ({} if cfg.family in ("ssm", "encdec") else
             {launch_name(k, cfg.hd): c for k, c in (("flash_attention_fwd", 2 * L * n),
                                                     ("flash_attention_bwd_dkv", L * n),
                                                     ("flash_attention_bwd_dq", L * n))})
    expect = {"start": {}, "update": {}, "backward": flash}
    st = {"t": 0.0, "last": collections.Counter(), "err": 0.0, "cf": 0.0, "peak": 0,
          "step": -1, "events": {}}
    phase_ms = collections.defaultdict(list)
    res_norms = collections.defaultdict(list)
    timeline = []
    digest = {}
    fsdp = {"reduce_ms": [], "bytes": []}

    def on_phase(name, **state):
        if name in ("start", "backward"):        # the compute stream's position
            st["events"][name] = torch.cuda.Event(enable_timing=True)
            st["events"][name].record()
        torch.cuda.synchronize()
        now = time.perf_counter()
        if name == "start":
            st["step"] = state["step"]
        else:
            phase_ms[name].append((now - st["t"]) * 1e3)
        st["peak"] = max(st["peak"], torch.cuda.max_memory_allocated())
        counts = collections.Counter(backend.launches)
        got = dict(counts - st["last"])
        st["last"] = counts
        need(got == expect[name], f"training {name}: launches {got} != {expect[name]}")
        if name == "backward" and run.fsdp:
            ev = state["reduce_events"]
            fsdp["reduce_ms"].append(sum(a.elapsed_time(b) for a, b in ev if a is not None))
        if name == "sync":
            fsdp["bytes"].append(state["comm"].bytes_fsdp)
            need(state["schedule"] == schedule, f"training: schedule {state['schedule']}")
            timeline.append({"issued": list(state["rounds"].issued),
                             **sync_timeline(st["events"]["start"], st["events"]["backward"],
                                             state["rounds"])})
            check_bytes("training sync", state["comm"], want_bytes)
            state["comm"].reset_bytes()
            need(all(bool(torch.isfinite(v).all()) for v in state["synced"].values()),
                 "training sync: non-finite gradient")
            if cmp.error_feedback:
                for bid, e in state["ef_state"].items():
                    need(stack_finite(e), f"training sync: residual {bid} not finite")
                    res_norms[bid].append(stack_norm(e))
                if st["step"] in digest_steps:
                    digest.setdefault(st["step"], {})["ef"] = state_digest(state["ef_state"])
            else:
                err, cf = error_and_closed_form(codec.name, cmp, plan, state["grads"],
                                                state["synced"], state["key"], mesh,
                                                trainer.specs)
                st["err"] += err
                st["cf"] += cf
        if name == "update" and st["step"] in digest_steps:
            digest.setdefault(st["step"], {}).update(params=state_digest(state["params"]),
                          m=state_digest(state["opt_state"].m),
                          v=state_digest(state["opt_state"].v))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        st["t"] = time.perf_counter()

    trainer = Trainer(cfg, run, shape,
                      TrainerConfig(steps=steps, log_every=1, seed=TRAIN_SEED),
                      n if mesh is None else None, device=dev, on_phase=on_phase, mesh=mesh)
    plan = trainer.sync_plan
    schedule = "backward-pipelined" if trainer.overlap else "post-backward"
    comp = [b for b in plan.buckets if b.kind == "compressed"]
    n_codec, nshards, _ = codec_layout(cmp, n, mesh)
    rounds = sum(shard_copies(b, mesh) for b in comp)
    sync = {k: v * rounds for k, v in expected_launches(
        codec.name, cmp.scatter_decode, n_codec, nshards).items()}
    if trainer.overlap:         # the rounds launch from inside the backward
        expect["backward"] = dict(collections.Counter(expect["backward"]) + collections.Counter(sync))
        expect["sync"] = {}
    else:
        expect["sync"] = sync
    wire_bits, want_bytes = wire_accounting(plan, cmp, n, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launches()
    mem0 = torch.cuda.memory_stats()
    params, opt_state, hist = trainer.fit()
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_stats()
    # the caching allocator's cudaMalloc calls and its frees-and-retries
    allocator = {k: mem1.get(k, 0) - mem0.get(k, 0)
                 for k in ("num_device_alloc", "num_alloc_retries")}
    counts = dict(backend.launches)
    launches_total.update(counts)
    per_step = collections.Counter()
    for phase in ("backward", "sync"):
        per_step.update(expect[phase])
    need(counts == {k: v * steps for k, v in per_step.items()},
         f"training: launches {counts} != {steps} x {dict(per_step)}")
    need(len(hist) == steps and all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                                    for h in hist), f"training: non-finite metrics {hist}")
    need(int(opt_state.step) == steps, f"training: optimizer step {int(opt_state.step)}")
    need(all(bool(torch.isfinite(v).all()) for v in params.values()),
         "training: non-finite parameters")
    need(all(t["issued"] == timeline[0]["issued"] for t in timeline),
         f"training: the rounds' issue order changed from step to step: {timeline}")
    out = {}
    if cmp.error_feedback:
        # bounded residuals: after step 3 no more than twice what they were
        # after step 1, per bucket (the steps counted from 0, as logged)
        need(sorted(res_norms) == sorted(trainer.ef_state) and res_norms,
             f"training: residuals of {sorted(res_norms)}, state of {sorted(trainer.ef_state)}")
        for bid, norms in res_norms.items():
            need(len(norms) == steps and (steps < 4 or norms[3] <= 2 * norms[1]),
                 f"training: residual of {bid} grows from {norms[1]:.6g} after step 1 to "
                 f"{norms[-1]:.6g} after step {steps - 1}")
        out = {"residual_norms": dict(res_norms)}
    else:
        ratio = st["err"] / st["cf"]
        need(abs(ratio - 1.0) <= 0.10, f"training: error / closed form = {ratio:.4f}, outside 10%")
        out = {"err_over_closed_form": ratio}
    if digest_steps:
        need(sorted(digest) == sorted(digest_steps)
             and all(len(d) == (4 if cmp.error_feedback else 3) for d in digest.values()),
             f"training: digests of steps {sorted(digest)}, want {sorted(digest_steps)}")
        out["digest"] = digest
    if "aux" in hist[0]:
        out["aux"] = [h["aux"] for h in hist]
    if run.fsdp:
        out.update(fsdp_reduce_ms=fsdp["reduce_ms"], fsdp_reduce_bytes=fsdp["bytes"])
    if keep is not None:
        keep.update(params=params, opt_state=opt_state, hist=hist, plan=plan)
    del params, opt_state, trainer
    torch.cuda.empty_cache()
    step_ms = [sum(phase_ms[p][i] for p in ("backward", "sync", "update")) for i in range(steps)]
    tokens = shape.global_batch * shape.seq_len
    return {"model": cfg.name, "layers": L, "ranks": n, "mesh": mesh,
            "tokens_per_rank": shape.seq_len, "steps": steps, "preset": preset,
            "loss": [h["loss"] for h in hist], "grad_norm": [h["grad_norm"] for h in hist],
            "lr": [h["lr"] for h in hist], "step_ms": step_ms,
            "fwd_bwd_ms": phase_ms["backward"], "sync_ms": phase_ms["sync"],
            "optimizer_ms": phase_ms["update"],
            "tokens_per_s": [tokens / ms * 1e3 for ms in step_ms],
            "peak_GiB": st["peak"] / 2**30, "allocator": allocator, **out,
            "schedule": schedule,
            "plan_schedule": list(plan.schedule()), "issued": timeline[0]["issued"],
            "exposed_sync_ms": [t.get("exposed_sync_ms") for t in timeline],
            "rounds_ms": timeline[-1].get("rounds_ms"),
            "compressed_buckets": len(comp), "wire_MB": sum(wire_bits.values()) / 8 / 1e6,
            "launches_per_step": dict(per_step)}


# The post-backward twin of each overlapped phase-5 cell: TWIN_STEPS steps
# from the same start with BucketSpec.overlap = False, held bit for bit to
# the overlapped run's first TWIN_STEPS steps (parameters, m, v, residuals by
# digest, losses and norms exactly).
TWIN_STEPS = 2


def run_twin(label: str, main: dict, cfg, run, shape, n: int, launches_total,
             mesh=None) -> dict:
    """The post-backward twin of the overlapped cell ``main`` (a
    ``fit_and_check`` summary with ``digest`` after some of its first
    TWIN_STEPS steps; the twin's are taken after the same steps):
    ``fit_and_check`` again with ``overlap=False`` up to the last digested
    step, the same checks and timing.  Fails unless the end states are
    bit-equal.
    Returns the line that sets the two schedules side by side: each
    bucket's issue order and points against ``plan.schedule()``, the
    exposed sync ms and the step ms of both."""
    import torch

    cmp = run.compression
    off = dataclasses.replace(run, compression=dataclasses.replace(
        cmp, bucket=dataclasses.replace(cmp.bucket, overlap=False)))
    torch.cuda.empty_cache()
    k = max(main["digest"]) + 1
    twin = fit_and_check(cfg, off, shape, n, k, main["preset"], launches_total, mesh,
                         digest_steps=tuple(main["digest"]))
    need(main["schedule"] == "backward-pipelined" and twin["schedule"] == "post-backward",
         f"{label}: schedules {main['schedule']}, {twin['schedule']}")
    need(twin["digest"] == main["digest"] and twin["loss"] == main["loss"][:k]
         and twin["grad_norm"] == main["grad_norm"][:k]
         and twin.get("aux") == (main["aux"][:k] if "aux" in main else None),
         f"{label}: the overlapped run and its post-backward twin differ after {k} steps "
         f"(losses {main['loss'][:k]} against {twin['loss']}; digests differ in "
         f"{sorted(g for g in main['digest'] if main['digest'][g] != twin['digest'].get(g))})")
    both = ("backward-pipelined", "post-backward")
    return {"cell": label, "bit_equal_after_steps": k, "plan_schedule": main["plan_schedule"],
            "issued": {s: r["issued"] for s, r in zip(both, (main, twin))},
            "rounds_ms_from_backward_end": {s: r["rounds_ms"] for s, r in zip(both, (main, twin))},
            "exposed_sync_ms": {s: r["exposed_sync_ms"] for s, r in zip(both, (main, twin))},
            "step_ms": {s: r["step_ms"] for s, r in zip(both, (main, twin))},
            "fwd_bwd_ms": {s: r["fwd_bwd_ms"] for s, r in zip(both, (main, twin))},
            "sync_ms": {s: r["sync_ms"] for s, r in zip(both, (main, twin))},
            "peak_GiB": {s: r["peak_GiB"] for s, r in zip(both, (main, twin))},
            "allocator": {s: r["allocator"] for s, r in zip(both, (main, twin))}}


def run_training_ef(launches_total) -> dict:
    """Phase 5's error-feedback run, after the first one's state is freed:
    ``Trainer.fit`` for ``EF_TRAIN_STEPS`` steps with ``fixed_k_1bit`` plus
    error feedback, the reference example's default, at the main path's
    shape.  Its residuals are 8 × 792,657,920 f32 (25.4 GB) beside the
    first run's 42 GiB peak; ``fit_and_check`` reports the peak."""
    import torch
    from repro_torch.train import synthetic

    torch.cuda.empty_cache()
    cfg, run, shape = synthetic.train_main_path(error_feedback=True)
    return fit_and_check(cfg, run, shape, synthetic.N, synthetic.EF_TRAIN_STEPS,
                         synthetic.TRAIN_PRESET + " + error feedback", launches_total,
                         digest_steps=(TWIN_STEPS - 1,))


def run_training_multipod(launches_total) -> dict:
    """Phase 5's multi-pod run (``synthetic.multipod_train_path``):
    ``Trainer.fit`` for ``TRAIN_STEPS`` steps on the (pod 2, data 4) mesh
    with the reference's ``get_run_config(..., multi_pod=True)``
    (``fixed_k_1bit`` over ``pod``, the exact mean inside each pod), cut to
    4 layers, batch 8 and one microbatch; the sync's error over the pod
    means against ``mse_fixed_k_shared`` at n_eff = 2."""
    import torch
    from repro_torch.train import synthetic

    torch.cuda.empty_cache()
    cfg, run, shape, mesh = synthetic.multipod_train_path()
    return fit_and_check(cfg, run, shape, math.prod(mesh.values()), synthetic.TRAIN_STEPS,
                         "get_run_config(multi_pod=True): fixed_k_1bit over pod",
                         launches_total, mesh,
                         digest_steps=(TWIN_STEPS - 1,))


MOE_TRAIN_STEPS = 2


def run_training_moe(launches_total) -> dict:
    """Phase 5b (``synthetic.moe_train_path``): olmoe-1b-7b at full width
    and 2 layers, 8 ranks of one 4096-token sequence stacked, the
    reference's ``get_run_config`` (``fixed_k_1bit``).  Step 0's rank-0
    loss and gradients with the flash kernels against ``attn_impl="xla"``
    (phase 5's limits), the routes of both recorded: where any token's
    differ, the xla run is repeated on the flash run's routes and that is
    compared (the rerouted share per layer is printed).  Then ``Trainer.fit`` for
    MOE_TRAIN_STEPS steps under the backward-pipelined schedule
    (``fit_and_check``: launches, bytes, the error against the closed form,
    the step's split and peak) with the state digested after every step,
    and its post-backward twin from the same start, bit-equal after every
    step; the aux loss finite and nonzero in every step."""
    import torch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model
    from repro_torch.train import synthetic

    dev = torch.device("cuda")
    cfg, run, shape = synthetic.moe_train_path()
    n, L = synthetic.N, cfg.num_layers
    global_tokens = float(shape.global_batch * shape.seq_len)
    torch.cuda.empty_cache()
    params = model.init(TRAIN_SEED, cfg, device=dev)
    batch = SyntheticLM(cfg, shape, seed=TRAIN_SEED).batch(0, dev)
    rank0 = {k: v[:shape.global_batch // n] for k, v in batch.items()}
    flash_log, xla_log = [], []
    with moe_routes(flash_log):
        kern = synthetic.rank_loss_and_grads(cfg, run, params, rank0, global_tokens)
    xla_run = dataclasses.replace(run, attn_impl="xla")
    with moe_routes(xla_log):
        xla = synthetic.rank_loss_and_grads(cfg, xla_run, params, rank0, global_tokens)
    # with remat each layer routes in the forward and again in the backward
    need(len(flash_log) == len(xla_log) == 2 * L,
         f"step 0, rank 0: {len(flash_log)} and {len(xla_log)} MoE calls for {L} layers")
    moved = rerouted(xla_log[:L], flash_log[:L])
    if moved["share_any"]:
        del xla
        with moe_routes([], force=flash_log):
            xla = synthetic.rank_loss_and_grads(cfg, xla_run, params, rank0, global_tokens)
    agree = _agreement(kern, xla, TRAIN_GRAD_TOL, TRAIN_LOSS_RTOL,
                       f"{cfg.name} flash kernels vs xla")
    agree.update(rerouted_share_by_layer=moved["share_by_call"],
                 xla_on_flash_routes=bool(moved["share_any"]))
    del params, batch, rank0, kern, xla, flash_log, xla_log
    torch.cuda.empty_cache()

    summary = fit_and_check(cfg, run, shape, n, MOE_TRAIN_STEPS,
                            "get_run_config: fixed_k_1bit, one microbatch", launches_total,
                            digest_steps=tuple(range(MOE_TRAIN_STEPS)))
    need(all(math.isfinite(a) and a > 0 for a in summary["aux"]),
         f"{cfg.name}: aux loss {summary['aux']}")
    twin = run_twin(cfg.name, summary, cfg, run, shape, n, launches_total)
    summary["digest"] = f"bit-equal to the post-backward twin after steps {sorted(summary['digest'])}"
    return {**summary, "step0_flash_vs_xla": agree, "twin": twin}


# Phase 5c: mamba2-130m whole.  Step 0's rank-0 loss and gradients in bf16
# against f32 compute: the model's own bf16 noise, not a kernel's (the
# family has none); rehearsed on the CPU at full width and 24 layers, one
# 256-token sequence: per leaf ‖Δg‖/‖g‖ up to 0.47 (D; the norms, embed,
# A_log and dt_bias 0.26–0.35), loss 2.4e-4 relative (0.080 and 4.1e-5 at 2
# layers, 0.163 and 2.3e-4 at 6).  The f32 code is held to the CPU in phase
# 4c and to the reference in the CPU tests; these limits catch a bf16 path
# that drops what f32 keeps.
SSM_GRAD_TOL, SSM_LOSS_RTOL = 0.75, 2e-3
SSM_TRAIN_STEPS = 4


def run_training_ssm(launches_total) -> dict:
    """Phase 5c (``synthetic.ssm_train_path``): mamba2-130m at full width and
    all 24 layers, 8 ranks of one 4096-token sequence stacked, the
    reference's ``get_run_config`` (``fixed_k_1bit``, one microbatch, no
    model axis, remat), through :func:`train_whole_model` with
    SSM_TRAIN_STEPS steps and the SSM limits."""
    from repro_torch.train import synthetic

    return train_whole_model(*synthetic.ssm_train_path(), SSM_GRAD_TOL, SSM_LOSS_RTOL,
                             SSM_TRAIN_STEPS, launches_total)


def train_whole_model(cfg, run, shape, grad_tol: float, loss_rtol: float, steps: int,
                      launches_total) -> dict:
    """A model trained with one sequence a rank (``shape.global_batch``
    ranks) stacked under the reference's run config: step 0's rank-0 loss
    and gradients in bf16 against f32 compute (per leaf ≤ ``grad_tol``,
    loss ≤ ``loss_rtol`` relative); then ``Trainer.fit`` for ``steps``
    steps under the backward-pipelined schedule (``fit_and_check``: the
    flash kernels' launches where the model has attention, kernel 4's, n a
    compressed bucket, the bytes, the error against
    ``mse_fixed_k_shared``, the step's split and peak), digested after its
    first TWIN_STEPS steps (or all of them, if fewer), and its
    post-backward twin, bit-equal after them."""
    import torch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model
    from repro_torch.train import synthetic

    dev = torch.device("cuda")
    n = shape.global_batch
    global_tokens = float(shape.global_batch * shape.seq_len)
    torch.cuda.empty_cache()
    params = model.init(TRAIN_SEED, cfg, device=dev)
    batch = SyntheticLM(cfg, shape, seed=TRAIN_SEED).batch(0, dev)
    rank0 = {k: v[:shape.global_batch // n] for k, v in batch.items()}
    rank_ms = {}
    got = {}
    for dt in ("bfloat16", "float32"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        got[dt] = synthetic.rank_loss_and_grads(cfg, dataclasses.replace(run, compute_dtype=dt),
                                                params, rank0, global_tokens)
        torch.cuda.synchronize()
        rank_ms[dt] = (time.perf_counter() - t) * 1e3
    agree = _agreement(got["bfloat16"], got["float32"], grad_tol, loss_rtol,
                       f"{cfg.name} bf16 vs f32 compute")
    gb, gf = got["bfloat16"][1], got["float32"][1]
    agree["all_leaves_rel"] = math.sqrt(
        sum(float((gb[k].double() - gf[k].double()).square().sum()) for k in gf)
        / sum(float(gf[k].double().square().sum()) for k in gf))
    agree["rank0_loss_and_grads_ms"] = rank_ms
    del params, batch, rank0, got, gb, gf
    torch.cuda.empty_cache()

    summary = fit_and_check(cfg, run, shape, n, steps,
                            "get_run_config: fixed_k_1bit, one microbatch", launches_total,
                            digest_steps=tuple(range(min(TWIN_STEPS, steps))))
    per_bucket = summary["launches_per_step"].get("fixed_k_gather", 0) / summary[
        "compressed_buckets"]
    need(per_bucket == n, f"{cfg.name}: {per_bucket} fixed-k launches a compressed bucket, not {n}")
    twin = run_twin(cfg.name, summary, cfg, run, shape, n, launches_total)
    summary["digest"] = f"bit-equal to the post-backward twin after steps {sorted(summary['digest'])}"
    return {**summary, "fixed_k_gather_per_compressed_bucket": per_bucket,
            "step0_bf16_vs_f32": agree, "twin": twin}


# Phase 5d: whisper-medium whole (24 + 24 layers; 8 f32 gradient stacks take
# 24.25 GB), each rank's sequence with its 1536 frames.  Step 0's rank-0 loss
# and gradients in bf16 against f32 compute: the model's own bf16 noise (its
# attention is the plain chunked softmax, no kernel); rehearsed on the CPU at
# full width, one 256-token sequence and its 1536 frames, the encoder and
# the decoder each cut to L layers: per leaf ‖Δg‖/‖g‖ up to 0.029, 0.038 and
# 0.042 at L = 2, 6 and 12, loss 3.2e-5 to 5.3e-5 relative.  A bf16 path
# that drops what f32 keeps (a cast, a mask) is off by order 1.
ENCDEC_GRAD_TOL, ENCDEC_LOSS_RTOL = 0.2, 1e-3
# one step and its one-step twin: a step of 8 ranks takes 22.6–23.6 s (the
# plain f32 chunked attention; H100 80GB HBM3, 700 W)
ENCDEC_TRAIN_STEPS = 1


def run_training_encdec(launches_total) -> dict:
    """Phase 5d (``synthetic.encdec_train_path``): whisper-medium whole, 8
    ranks of one 4096-token sequence and its frames stacked, the
    reference's ``get_run_config`` unchanged (``fixed_k_1bit``, one
    microbatch, remat), through :func:`train_whole_model`."""
    from repro_torch.train import synthetic

    cfg, run, shape = synthetic.encdec_train_path()
    out = train_whole_model(cfg, run, shape, ENCDEC_GRAD_TOL, ENCDEC_LOSS_RTOL,
                            ENCDEC_TRAIN_STEPS, launches_total)
    return {"encoder_layers": cfg.encoder_layers, **out}


# Phase 5e: llava-next-34b at full width and 1 of 60 layers (1,526,748,160
# parameters; 6.11 GB of f32 parameters, 12.2 GB of moments and 24.4 GB of
# gradient stacks at n = 4), each rank's sequence its 1152 patches and 2944
# tokens.  At 2 layers the first step peaked at 66.3 GiB and the second ran
# out of the card's memory under the default caching allocator.  Step 0's rank-0 loss and gradients in bf16 against f32 compute:
# the model's own bf16 noise, set from a CPU rehearsal of the same code at
# d 1792 (56/8 heads of 32, ff 5120, vocab 64,000, 2 layers, one sequence of
# 288 patches and 736 tokens): per leaf ‖Δg‖/‖g‖ up to 0.038 (w_gate;
# patch_proj 0.032), loss 5.0e-5 relative; the limits 2.7 and 20 times
# those.  A bf16 path that drops what f32 keeps (a cast, a mask, the
# patches' projection) is off by order 1.
VLM_GRAD_TOL, VLM_LOSS_RTOL = 0.1, 1e-3
# two steps and their two-step twin, as the dense, MoE and SSM cells
VLM_TRAIN_STEPS = 2


def run_training_vlm(launches_total) -> dict:
    """Phase 5e (``synthetic.vlm_train_path``): llava-next-34b at full width
    and 1 layer, ``synthetic.VLM_N`` ranks of one 4096-position sequence
    stacked, the reference's ``get_run_config`` with FSDP off and one
    microbatch (``fixed_k_1bit``, remat), through :func:`train_whole_model`;
    the ``patch_proj`` gradient's bf16-to-f32 reading reported apart."""
    from repro_torch.train import synthetic

    cfg, run, shape = synthetic.vlm_train_path()
    out = train_whole_model(cfg, run, shape, VLM_GRAD_TOL, VLM_LOSS_RTOL, VLM_TRAIN_STEPS,
                            launches_total)
    rel = out["step0_bf16_vs_f32"]["rel"]
    need("patch_proj" in rel, "llava training: no patch_proj gradient")
    return {"patches": cfg.num_patches, "patch_proj_bf16_vs_f32": rel["patch_proj"], **out}


# Phase 5f: h2o-danube-3-4b at full width and 4 of 24 layers
# (``synthetic.window_train_path``), 8 ranks of one 4096-token sequence: its
# window of 4096 masks no causal pair there (k > q - 4096 for every q <
# 4096), so kernels 11-13 at hd 120 run with the window and skip nothing;
# phase 2 holds them where it cuts.  Step 0, rank 0: every kernel call of the
# bf16 step held in place against the plain version (phase 2's limits); the
# f32 step with the kernels (their SIMT f32 instances) against the plain
# flash (TRAIN_F32_GRAD_TOL per leaf, TRAIN_F32_LOSS_RTOL); bf16 against f32
# compute, the model's own bf16 noise, held to the VLM family's limits (the
# dense stack's readings: 3.9-4.7% per leaf at 1-2 llava-next-34b layers on
# an H100).
# The plain flash runs in WINDOW_PLAIN_BLOCK tiles: the result does not
# depend on the tiling for rows that see a key, and 64-row tiles take most
# of phase 5's step-0 time at this length.
WINDOW_GRAD_TOL, WINDOW_LOSS_RTOL = VLM_GRAD_TOL, VLM_LOSS_RTOL
WINDOW_PLAIN_BLOCK = 512
WINDOW_TRAIN_STEPS = 2


def run_training_window(launches_total) -> dict:
    """Phase 5f: the step-0 checks above, then ``Trainer.fit`` for
    WINDOW_TRAIN_STEPS steps under the backward-pipelined schedule
    (``fit_and_check``: kernels 11-13 at hd 120, 2·L·n and L·n launches a
    step; kernel 4, n a compressed bucket) and its post-backward twin,
    bit-equal after both steps."""
    import torch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention.kernel import launch_name
    from repro_torch.models import model
    from repro_torch.train import synthetic

    dev = torch.device("cuda")
    cfg, run, shape = synthetic.window_train_path()
    n, L = synthetic.N, cfg.num_layers
    global_tokens = float(shape.global_batch * shape.seq_len)
    torch.cuda.empty_cache()
    params = model.init(TRAIN_SEED, cfg, device=dev)
    batch = SyntheticLM(cfg, shape, seed=TRAIN_SEED).batch(0, dev)
    rank0 = {k: v[:shape.global_batch // n] for k, v in batch.items()}
    flash = [launch_name(k, cfg.hd) for k in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                                              "flash_attention_bwd_dq")]
    per_call, ms = {}, {}

    def rank0_grads(label, r, span):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with span:
            got = synthetic.rank_loss_and_grads(cfg, r, params, rank0, global_tokens)
        torch.cuda.synchronize()
        ms[label] = (time.perf_counter() - t) * 1e3
        return got

    f32 = dataclasses.replace(run, compute_dtype="float32")
    backend.reset_launches()
    kern = rank0_grads("bf16 kernels, each call checked", run,
                       flash_on_card(WINDOW_PLAIN_BLOCK, per_call))
    kern32 = rank0_grads("f32 kernels", f32, contextlib.nullcontext())
    plain32 = rank0_grads("f32 plain flash", f32, flash_on_card(WINDOW_PLAIN_BLOCK))
    want = {k: c * 2 for k, c in zip(flash, (2 * L, L, L))}
    need({k: backend.launches[k] for k in flash} == want and sum(backend.launches.values())
         == sum(want.values()), f"step 0, rank 0: launches {dict(backend.launches)} != {want}")
    agree = {
        "flash_per_call_vs_plain": per_call,
        "f32_flash_vs_plain": _agreement(kern32, plain32, TRAIN_F32_GRAD_TOL,
                                         TRAIN_F32_LOSS_RTOL, f"{cfg.name} f32 kernels vs plain"),
        "bf16_vs_f32": _agreement(kern, kern32, WINDOW_GRAD_TOL, WINDOW_LOSS_RTOL,
                                  f"{cfg.name} bf16 vs f32 compute"),
        "rank0_loss_and_grads_ms": ms}
    del params, batch, rank0, kern, kern32, plain32
    torch.cuda.empty_cache()

    summary = fit_and_check(cfg, run, shape, n, WINDOW_TRAIN_STEPS,
                            "get_run_config: fixed_k_1bit, one microbatch", launches_total,
                            digest_steps=tuple(range(WINDOW_TRAIN_STEPS)))
    twin = run_twin(cfg.name, summary, cfg, run, shape, n, launches_total)
    summary["digest"] = f"bit-equal to the post-backward twin after steps {sorted(summary['digest'])}"
    return {"window": cfg.window, "hd": cfg.hd, **summary, "step0": agree, "twin": twin}


# Phase 5g: FSDP (ZeRO-3 over data) on the stacked communicator.
# (a) qwen2-moe-a2.7b at full width and FSDP_CHECK_LAYERS layer, FSDP_N ranks,
# one step with FSDP on and one with it off from the same parameters,
# compression none: every leaf FSDP does not shard takes the same exact mean
# (bit-equal), and each FSDP leaf's gradient is the sum over the ranks, n
# times the exact mean, rounded once to bf16: ‖Δ‖/‖g‖ ≤ FSDP_SUM_RTOL = 2⁻⁹
# (one bf16 rounding; the CPU reading of this function on the smoke
# qwen2-moe-a2.7b at n = 4 was 1.66e-3 to 1.74e-3).
FSDP_CHECK_LAYERS = 1
FSDP_SUM_RTOL = 2.0 ** -9
# (b) two steps of synthetic.fsdp_train_path() at FSDP_LAYERS layers
FSDP_TRAIN_STEPS = 2


def run_fsdp_identities(mesh=None) -> dict:
    """Phase 5g(a), or with ``mesh`` (pod, data) phase 5h(a): the FSDP step
    against the replicated one (see above); with a pod axis each FSDP leaf
    is the mean over pod of each pod's data sum, n_data × the exact mean."""
    import torch
    from repro_torch.core import types as core_types
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train import synthetic
    from repro_torch.train import train_step as ts

    dev = torch.device("cuda")
    if mesh is None:
        cfg, run, shape = synthetic.fsdp_train_path(FSDP_CHECK_LAYERS)
        n = scale = shape.global_batch
    else:
        cfg, run, shape, mesh = synthetic.multipod_fsdp_train_path(FSDP_CHECK_LAYERS)
        n, scale = None, mesh["data"]
    run = dataclasses.replace(run, compression=core_types.CompressionConfig(mode="none"))
    torch.cuda.empty_cache()
    batch = SyntheticLM(cfg, shape, seed=TRAIN_SEED).batch(0, dev)
    synced, ms = {}, {}
    for fsdp in (False, True):
        seen = {}
        step_fn, init_fn, _ = ts.build_train_step(
            cfg, dataclasses.replace(run, fsdp=fsdp), shape, n, device=dev, mesh=mesh,
            on_phase=lambda name, **st: seen.update(synced=st["synced"]) if name == "sync"
            else None)
        state = init_fn(TRAIN_SEED)        # the same draw both times
        torch.cuda.synchronize()
        t = time.perf_counter()
        step_fn(*state, batch, 0)
        torch.cuda.synchronize()
        ms["fsdp" if fsdp else "replicated"] = (time.perf_counter() - t) * 1e3
        synced[fsdp] = seen["synced"]
        del step_fn, init_fn, state, seen
    dims = ts.fsdp_leaf_dims(ts.param_shapes(cfg, fsdp="data")[1])
    off, on = synced[False], synced[True]
    need(sorted(off) == sorted(on), "FSDP identities: the two steps sync other leaves")
    same = [k for k in off if k not in dims]
    need(all(torch.equal(on[k], off[k]) for k in same),
         f"FSDP identities: the unsharded leaves' gradients differ: "
         f"{[k for k in same if not torch.equal(on[k], off[k])]}")
    rel = {k: float(torch.linalg.vector_norm((on[k] - scale * off[k]).double())
                    / torch.linalg.vector_norm(on[k].double())) for k in dims}
    worst = max(rel, key=rel.get)
    need(rel[worst] <= FSDP_SUM_RTOL,
         f"FSDP identities: {worst}'s gradient is {rel[worst]:.3g} from {scale} x the mean")
    del synced, off, on, batch
    torch.cuda.empty_cache()
    return {"model": cfg.name, "layers": cfg.num_layers, "ranks": shape.global_batch,
            "mesh": mesh, "fsdp_scale": scale,
            "unsharded_leaves_bit_equal": len(same), "fsdp_leaves": len(dims),
            "fsdp_sum_vs_n_mean_rel": rel, "worst": worst, "limit": FSDP_SUM_RTOL,
            "step_ms": ms}


def run_training_fsdp(launches_total) -> dict:
    """Phase 5g(b): ``Trainer.fit`` for FSDP_TRAIN_STEPS steps of
    ``synthetic.fsdp_train_path()`` (qwen2-moe-a2.7b at full width and
    ``synthetic.FSDP_LAYERS`` layers, ``synthetic.FSDP_N`` stacked ranks of
    one 4096-token sequence, FSDP over data, ``fixed_k_1bit`` on the leaves
    FSDP does not shard, one microbatch) under the backward-pipelined
    schedule
    (``fit_and_check``: kernels 11-13, 2·L·n and L·n launches a step;
    kernel 4, n a compressed bucket; the bytes and the error against the
    closed form on the compressed buckets; the step's split, the FSDP rank
    sum's ms and bytes, tokens/s, peak).  The end state's digest by rank
    shard is the one the NCCL run of ``launch/bench_dist.py --fsdp-path``
    prints."""
    import torch
    from repro_torch.launch.step_report import fsdp_state_digest
    from repro_torch.train import synthetic
    from repro_torch.train import train_step as ts

    cfg, run, shape = synthetic.fsdp_train_path()
    n = shape.global_batch
    torch.cuda.empty_cache()
    keep = {}
    summary = fit_and_check(cfg, run, shape, n, FSDP_TRAIN_STEPS,
                            "get_run_config: FSDP, fixed_k_1bit, one microbatch",
                            launches_total, keep=keep)
    per_bucket = summary["launches_per_step"].get("fixed_k_gather", 0) / summary[
        "compressed_buckets"]
    need(per_bucket == n, f"{cfg.name}: {per_bucket} fixed-k launches a compressed bucket, not {n}")
    dims = ts.fsdp_leaf_dims(ts.param_shapes(cfg, fsdp="data")[1])
    digest = {"params": fsdp_state_digest(keep["params"], dims, n),
              "m": fsdp_state_digest(keep["opt_state"].m, dims, n),
              "v": fsdp_state_digest(keep["opt_state"].v, dims, n)}
    del keep
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[1] / 2**30 - summary["peak_GiB"]
    return {**summary, "fsdp_leaves": len(dims), "card_GiB_free_at_peak": free,
            "end_state_digest": digest}


# Phase 5h: FSDP with a pod axis (pod 2, data 2), stacked: (a) is
# run_fsdp_identities(synthetic.MULTIPOD_FSDP_MESH); (b) two steps of
# synthetic.multipod_fsdp_train_path() at MULTIPOD_FSDP_LAYERS layers
MULTIPOD_FSDP_STEPS = 2


def run_training_multipod_fsdp(launches_total) -> dict:
    """Phase 5h(b): ``Trainer.fit`` for MULTIPOD_FSDP_STEPS steps of
    ``synthetic.multipod_fsdp_train_path()`` under the backward-pipelined
    schedule (``fit_and_check``, which runs each FSDP shard bucket's round
    once per data coordinate: the launches, the pod-axis bytes against the
    accounting and the error against the closed form at n_eff = n_pod per
    coordinate).  Reports the pod-axis bytes of the shard buckets and of the
    others apart (their accounting; the communicator's total equals their
    sum), the pod sums' ms, the peak and the end state's digest by data
    shard, the one ``launch/bench_dist.py --multipod-fsdp-path`` prints."""
    import torch
    from repro_torch.core import wire
    from repro_torch.launch.step_report import fsdp_state_digest
    from repro_torch.train import synthetic
    from repro_torch.train import train_step as ts

    cfg, run, shape, mesh = synthetic.multipod_fsdp_train_path()
    n = math.prod(mesh.values())
    torch.cuda.empty_cache()
    keep = {}
    summary = fit_and_check(cfg, run, shape, n, MULTIPOD_FSDP_STEPS,
                            "get_run_config(multi_pod=True): FSDP over data, fixed_k_1bit over "
                            "pod, one microbatch", launches_total, mesh, keep=keep)
    plan = keep.pop("plan")
    cmp = run.compression
    codec = wire.resolve(cmp)
    n_pod = mesh["pod"]
    bits = {"fsdp_shard_buckets": 0.0, "other_buckets": 0.0}
    for b in plan.buckets:
        if b.kind == "compressed":
            kind = "fsdp_shard_buckets" if shard_copies(b, mesh) > 1 else "other_buckets"
            bits[kind] += codec.wire_bits(n_pod, b.size, cmp) * shard_copies(b, mesh)
    need(all(v > 0 for v in bits.values()), f"multi-pod FSDP: pod-axis bits {bits}")
    dims = ts.fsdp_leaf_dims(ts.param_shapes(cfg, fsdp="data")[1])
    digest = {"params": fsdp_state_digest(keep["params"], dims, mesh["data"]),
              "m": fsdp_state_digest(keep["opt_state"].m, dims, mesh["data"]),
              "v": fsdp_state_digest(keep["opt_state"].v, dims, mesh["data"])}
    del keep
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[1] / 2**30 - summary["peak_GiB"]
    return {**summary, "fsdp_leaves": len(dims),
            "pod_axis_MB_per_step": {k: v / 8 / 1e6 for k, v in bits.items()},
            "card_GiB_free_at_peak": free, "end_state_digest": digest}


EXAMPLE_STEPS = 4
EXAMPLE_FLASH = ("flash_attention_fwd_hd32", "flash_attention_bwd_dkv_hd32",
                 "flash_attention_bwd_dq_hd32")


def run_example(launches_total) -> dict:
    """The training example as a user runs it on the card
    (``examples/train_lm_compressed.py``: lm-8m, 8 ranks stacked, the exact
    mean, then ``fixed_k_1bit`` + error feedback), ``EXAMPLE_STEPS`` steps
    each, attention through the hd-32 flash kernels: finite losses and
    norms, each flash kernel launched L·n times a step (no remat), the
    fixed-k gathers of the EF run, finite residuals."""
    import torch
    from repro_torch.core import types as core_types
    from repro_torch.examples import train_lm_compressed as example
    from repro_torch.kernels import backend

    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    want = example.CFG.num_layers * example.N * EXAMPLE_STEPS
    out = {}
    for label, cmp in (("exact", core_types.CompressionConfig(mode="none")),
                       ("fixed_k_1bit + error feedback", example.ef_compression())):
        backend.reset_launches()
        t0 = time.perf_counter()
        hist, tr = example.run(EXAMPLE_STEPS, cmp, label, dev)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = dict(backend.launches)
        launches_total.update(counts)
        need({k: counts.get(k, 0) for k in EXAMPLE_FLASH} == dict.fromkeys(EXAMPLE_FLASH, want),
             f"example {label}: flash launches {counts}, want {want} each")
        need(len(hist) == EXAMPLE_STEPS and all(
            math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in hist),
            f"example {label}: losses or norms not finite: {hist}")
        res = {}
        if cmp.error_feedback:
            need(counts.get("fixed_k_gather", 0) > 0, f"example {label}: no fixed-k gather")
            need(bool(tr.ef_state) and all(stack_finite(e) for e in tr.ef_state.values()),
                 f"example {label}: residuals missing or not finite")
            res = {bid: stack_norm(e) for bid, e in tr.ef_state.items()}
        out[label] = {"losses": [h["loss"] for h in hist], "sec": sec,
                      "residual_norms": res, "launches": counts}
        del tr
        torch.cuda.empty_cache()
    return out


# Checkpoint and restart at full width (phase 5).  The uninterrupted run is
# run_training's 4 steps; the restarted one runs 2 steps that save at step 2
# (asynchronously, then synchronously at its end, as the reference does), then
# resumes to step 4 from that directory.  The resumed run saves asynchronously
# at step 3, so its step 3 overlaps a save (the device → host copy on a side
# stream, the file write on a thread) and its step 2 does not.  keep_last = 1
# holds at most two checkpoints on disk (the one being written and the last).
RESTART_KEEP_LAST = 1


def _state_max_diff(params, opt_state, ref: dict) -> float:
    """Largest |Δ| over every leaf of the parameters, m and v against the
    uninterrupted run's."""
    out = 0.0
    for k in ref["params"]:
        for got, want in ((params[k], ref["params"][k]), (opt_state.m[k], ref["opt_state"].m[k]),
                          (opt_state.v[k], ref["opt_state"].v[k])):
            out = max(out, max_err(got, want))
    return out


def _same_state(params, opt_state, hist, ref: dict, first: int) -> bool:
    """Bit-equal parameters, m, v and step, and the losses and norms of the
    steps from ``first`` on, to the uninterrupted run's."""
    want = ref["hist"][first:]
    return (sorted(params) == sorted(ref["params"])
            and all(same_bits(params[k], ref["params"][k])
                    and same_bits(opt_state.m[k], ref["opt_state"].m[k])
                    and same_bits(opt_state.v[k], ref["opt_state"].v[k]) for k in ref["params"])
            and same_bits(opt_state.step, ref["opt_state"].step)
            and [(h["step"], h["loss"], h["grad_norm"]) for h in hist]
            == [(h["step"], h["loss"], h["grad_norm"]) for h in want])


def run_restart(ref: dict, launches_total) -> dict:
    """Phase 5's checkpoint and restart on the training path (qwen3-4b at
    full width and 4 layers, 8 stacked ranks, ``fixed_k_1bit``): in a
    temporary directory, removed at the end, ``Trainer(steps=2,
    ckpt_every=2)`` and then ``Trainer(steps=4, ckpt_every=3)`` from it; the
    end state held bit for bit against ``ref``, run_training's
    uninterrupted run (parameters, m, v, step, the losses and norms of steps
    2–3).  Were the card's step not bit-reproducible run to run, a second
    uninterrupted run measures that difference and the resumed run is held
    to it.  Reports the bytes of a checkpoint, each save's ms from the
    trainers' ``ckpt.history`` (the enqueue, the device → host copy and the
    file write; each trainer's last save is its synchronous one), the ms
    from ``fit()`` to its first step (the fresh draw; the draw and the
    restore: their difference is the restore's ms), and each step's ms
    (compute stream), step 3 overlapping a save."""
    import os
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import checkpointing as ckpt
    from repro_torch.kernels import backend
    from repro_torch.train import synthetic
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda")
    cfg, run, shape = synthetic.train_main_path()
    n, steps, L = synthetic.N, synthetic.TRAIN_STEPS, cfg.num_layers
    half = steps // 2
    step_ms, setup_ms, mark = {}, {}, {}

    def on_phase(name, **state):
        # the compute stream only: the checkpoint's copies run on their own
        if name == "start":
            torch.cuda.current_stream().synchronize()
            t = time.perf_counter()
            if "fit" in mark:       # a fit's first step: init_or_restore ran before it
                setup_ms[state["step"]] = (t - mark.pop("fit")) * 1e3
            mark.update(step=state["step"], t=t)
        elif name == "update":
            torch.cuda.current_stream().synchronize()
            step_ms[mark["step"]] = (time.perf_counter() - mark["t"]) * 1e3

    def trainer(last: int, every: int):
        tcfg = TrainerConfig(steps=last, ckpt_dir=d, ckpt_every=every,
                             keep_last=RESTART_KEEP_LAST, log_every=1, seed=TRAIN_SEED)
        return Trainer(cfg, run, shape, tcfg, n, device=dev, on_phase=on_phase)

    def fit(tr):
        torch.cuda.synchronize()
        mark["fit"] = time.perf_counter()
        return tr.fit()

    torch.cuda.empty_cache()
    backend.reset_launches()
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        first = trainer(half, half)
        fit(first)
        need(ckpt.latest_step(d) == half, f"restart: no checkpoint at step {half}")
        saves = list(first.ckpt.history)
        del first
        torch.cuda.empty_cache()
        second = trainer(steps, half + 1)
        params, opt_state, hist = fit(second)
        torch.cuda.synchronize()
        saves += second.ckpt.history
        kept = sorted(os.listdir(d))
        need(kept == [f"step-{steps:08d}"], f"restart: {kept} under the directory")
        nbytes = os.path.getsize(os.path.join(d, kept[0], "arrays.npz"))
        del second
    finally:
        shutil.rmtree(d, ignore_errors=True)
    counts = dict(backend.launches)
    launches_total.update(counts)
    flash = {"flash_attention_fwd": 2 * L * n * steps, "flash_attention_bwd_dkv": L * n * steps,
             "flash_attention_bwd_dq": L * n * steps}
    need({k: counts.get(k, 0) for k in flash} == flash and counts.get("fixed_k_gather", 0) > 0,
         f"restart: launches {counts}, flash {flash}")
    need([h["step"] for h in hist] == list(range(half, steps))
         and all(math.isfinite(h["loss"]) for h in hist), f"restart: history {hist}")
    need(int(opt_state.step) == steps, f"restart: optimizer step {int(opt_state.step)}")

    out = {"bit_equal": _same_state(params, opt_state, hist, ref, half)}
    if not out["bit_equal"]:
        # the card's step is not reproducible run to run: measure by how much
        torch.cuda.empty_cache()
        again = Trainer(cfg, run, shape, TrainerConfig(steps=steps, log_every=1, seed=TRAIN_SEED),
                        n, device=dev)
        p2, o2, h2 = again.fit()
        run_to_run = _state_max_diff(p2, o2, ref)
        loss_run_to_run = max(abs(a["loss"] - b["loss"]) for a, b in zip(h2, ref["hist"]))
        del again, p2, o2
        resumed = _state_max_diff(params, opt_state, ref)
        loss_resumed = max(abs(a["loss"] - b["loss"]) for a, b in zip(hist, ref["hist"][half:]))
        out.update(run_to_run_max_abs=run_to_run, resumed_max_abs=resumed,
                   run_to_run_loss=loss_run_to_run, resumed_loss=loss_resumed)
        need(run_to_run > 0 and resumed <= run_to_run and loss_resumed <= loss_run_to_run,
             f"restart: resumed state off by {resumed:.3g} (losses {loss_resumed:.3g}), "
             f"two uninterrupted runs by {run_to_run:.3g} ({loss_run_to_run:.3g})")
    del params, opt_state
    torch.cuda.empty_cache()
    need([h["step"] for h in saves] == [half, half, half + 1, steps],
         f"restart: saves {saves}")
    return {"model": cfg.name, "layers": L, "ranks": n, "preset": synthetic.TRAIN_PRESET,
            "steps": f"{half} + {steps - half}", "keep_last": RESTART_KEEP_LAST,
            "GB_per_checkpoint": nbytes / 1e9, "checkpoints_written": len(saves),
            "GB_written": len(saves) * nbytes / 1e9, "saves": saves,
            "fit_to_first_step_ms": setup_ms, "restore_ms": setup_ms[half] - setup_ms[0],
            "step_ms": step_ms, "step_overlapping_a_save": half + 1,
            "losses": [h["loss"] for h in hist], **out}


# The training CLI's smoke run on the card, then the same command resumed:
# the reference's --smoke at --devices 4 (4 stacked ranks of 4 sequences of
# 128 tokens: kernels 11-13 at hd 16, (4, 128, 4/2, 16) a rank).
CLI_ARGS = ("--smoke", "--devices", "4", "--ckpt-every", "2")
CLI_RUNS = ((4, (0, 1, 2, 3)), (6, (4, 5)))
CLI_FLASH = ("flash_attention_fwd_hd16", "flash_attention_bwd_dkv_hd16",
             "flash_attention_bwd_dq_hd16")


def run_cli(launches_total) -> dict:
    """``python -m repro_torch.launch.train --smoke --devices 4 --steps 4
    --ckpt-every 2 --ckpt-dir D``, then ``--steps 6``, in process
    (``main(argv)``, its output captured): the printed steps, finite losses,
    the checkpoint steps, the resume at step 4, each hd-16 flash kernel
    launched L·n times a step (no remat in the smoke run) and kernel 4 (the
    fixed-k gather of the compressed error-feedback sync)."""
    import io
    import re
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import checkpointing as ckpt
    from repro_torch.configs.registry import smoke_config
    from repro_torch.kernels import backend
    from repro_torch.launch import train as train_cli

    step_line = re.compile(r"^step +(\d+)  loss (\S+)  gnorm (\S+)  lr (\S+)$")
    per_step = smoke_config("qwen3-4b").num_layers * 4
    torch.cuda.empty_cache()
    d = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    out = {}
    try:
        for last, want_steps in CLI_RUNS:
            backend.reset_launches()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = train_cli.main([*CLI_ARGS, "--steps", str(last), "--ckpt-dir", d])
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            counts = dict(backend.launches)
            launches_total.update(counts)
            rows = [step_line.match(line) for line in buf.getvalue().strip().splitlines()]
            need(rc == 0 and rows and all(rows), f"cli --steps {last}: output {buf.getvalue()!r}")
            got = [(int(m[1]), float(m[2])) for m in rows]
            need(tuple(s for s, _ in got) == want_steps and all(math.isfinite(l) for _, l in got),
                 f"cli --steps {last}: steps and losses {got}, want steps {want_steps}")
            need(ckpt.latest_step(d) == last, f"cli --steps {last}: newest checkpoint "
                                              f"{ckpt.latest_step(d)}")
            want = dict.fromkeys(CLI_FLASH, per_step * len(want_steps))
            fk = counts.get("fixed_k_gather", 0)
            need({k: counts.get(k, 0) for k in CLI_FLASH} == want
                 and fk > 0 and fk % len(want_steps) == 0,
                 f"cli --steps {last}: launches {counts}, want {want} and fixed-k gathers")
            out[f"--steps {last}"] = {"steps": [s for s, _ in got],
                                      "losses": [l for _, l in got], "sec": sec,
                                      "launches": counts}
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return out


# The hybrid and the VLM through the same CLI (--arch jamba-v0.1-52b --smoke:
# one period of 4 layers, attention at position 1; --arch llava-next-34b
# --smoke: 2 layers, each sequence 8 patches and 120 tokens; 4 ranks of 4
# sequences of 128 positions): 4 steps then resumed for 2, as qwen3-4b's run;
# the same 4 steps on the CPU from the same parameters (the card's draw, saved by a run of 0 steps: the card's and
# the CPU's generators draw differently); and a run resumed at step 4 against
# an uninterrupted one, bit for bit.  The smoke run's error-feedback
# residuals are not saved (the reference's contract), so a resumed
# compressed run restarts them at zero and parts from an uninterrupted one by
# design: that pair runs with --no-compress.  Card and CPU compute the same
# bf16 function with their own sum orders (and a near-tie may route a token
# apart): each loss within CLI_CPU_LOSS_RTOL of the CPU's (one rerouted token
# of the 2048 a step moves the loss by about 5e-4 relative; bf16 rounding by
# less).
CLI_ARCHS = (HYBRID_MODEL, VLM_MODEL)
CLI_CPU_LOSS_RTOL = 5e-3


def run_cli_arch(arch: str, launches_total) -> dict:
    """``python -m repro_torch.launch.train --arch ARCH --smoke --devices 4
    --ckpt-every 2`` in process, its output captured: ``--steps 0
    --ckpt-dir D`` (the drawn parameters saved), ``--steps 4`` (from them),
    then ``--steps 6`` (resumed at step 4), each hd-16 flash kernel
    launched once per rank and attention layer a step (the hybrid's one a
    period; no remat) and kernel 4; ``--steps 4 --device cpu`` from a copy of the step-0
    checkpoint, its losses against the card's; with ``--no-compress`` 4 + 2
    steps into another directory against ``--steps 6`` uninterrupted: the
    step-6 checkpoints bit-equal and the printed losses of steps 4–5 the
    same."""
    import io
    import re
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.checkpoint import checkpointing as ckpt
    from repro_torch.configs.registry import hybrid_layout, smoke_config
    from repro_torch.kernels import backend
    from repro_torch.launch import train as train_cli

    step_line = re.compile(r"^step +(\d+)  loss (\S+)  gnorm (\S+)  lr (\S+)$")
    cfg = smoke_config(arch)
    per_step = (hybrid_layout(cfg)[1] if cfg.family == "hybrid" else cfg.num_layers) * 4
    cli_args = ("--arch", arch, "--smoke", "--devices", "4", "--ckpt-every", "2")
    torch.cuda.empty_cache()
    base = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    dirs = {k: str(pathlib.Path(base) / k) for k in ("card", "cpu", "exact", "whole")}
    # (label, extra arguments, checkpoint directory, steps printed)
    runs = (("drawn", [], dirs["card"], 0, ()),
            ("card", [], dirs["card"], 4, (0, 1, 2, 3)),
            ("card resumed", [], dirs["card"], 6, (4, 5)),
            ("cpu", ["--device", "cpu"], dirs["cpu"], 4, (0, 1, 2, 3)),
            ("exact", ["--no-compress"], dirs["exact"], 4, (0, 1, 2, 3)),
            ("exact resumed", ["--no-compress"], dirs["exact"], 6, (4, 5)),
            ("exact uninterrupted", ["--no-compress"], dirs["whole"], 6, (0, 1, 2, 3, 4, 5)))
    out, losses = {}, {}
    try:
        for label, extra, d, last, want_steps in runs:
            args = [*cli_args, *extra, "--steps", str(last), "--ckpt-dir", d]
            backend.reset_launches()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = train_cli.main(args)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            counts = dict(backend.launches)
            lines = buf.getvalue().strip().splitlines()
            rows = [step_line.match(line) for line in lines]
            need(rc == 0 and all(rows) and len(rows) == len(want_steps),
                 f"{arch} cli {args}: output {buf.getvalue()!r}")
            got = [(int(m[1]), m[2]) for m in rows]
            print(f"  {arch} cli {label}: {got} ({sec:.1f} s, launches {counts})", flush=True)
            need(tuple(s for s, _ in got) == want_steps
                 and all(math.isfinite(float(l)) for _, l in got),
                 f"{arch} cli {args}: steps and losses {got}, want steps {want_steps}")
            need(ckpt.latest_step(d) == last, f"{arch} cli {args}: newest checkpoint "
                                              f"{ckpt.latest_step(d)}")
            losses[label] = dict(got)
            if label == "drawn":          # the CPU run starts from the card's draw
                shutil.copytree(pathlib.Path(d) / "step-00000000",
                                pathlib.Path(dirs["cpu"]) / "step-00000000")
            if label == "cpu":
                need(not counts, f"{arch} cli on the CPU: launches {counts}")
            else:
                launches_total.update(counts)
                want = dict.fromkeys(CLI_FLASH, per_step * len(want_steps))
                fk = counts.get("fixed_k_gather", 0)
                need({k: counts.get(k, 0) for k in CLI_FLASH} == want
                     and (fk == 0 if extra or not want_steps else
                          fk > 0 and fk % len(want_steps) == 0),
                     f"{arch} cli {args}: launches {counts}, want {want} and fixed-k gathers "
                     "where it compresses")
            out[label] = {"steps": [s for s, _ in got], "losses": [float(l) for _, l in got],
                          "sec": sec, "launches": counts}
        need(all(losses["exact resumed"][s] == losses["exact uninterrupted"][s] for s in (4, 5)),
             f"{arch} cli: resumed losses {losses['exact resumed']} != uninterrupted "
             f"{losses['exact uninterrupted']}")
        a, b = (np.load(pathlib.Path(dirs[k]) / "step-00000006" / "arrays.npz")
                for k in ("exact", "whole"))
        need(sorted(a.files) == sorted(b.files) and all(
            a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes() for k in a.files),
            f"{arch} cli: the resumed run's checkpoint at step 6 differs from the uninterrupted "
            "run's")
        card, cpu = losses["card"], losses["cpu"]
        rel = [abs(float(card[s]) - float(cpu[s])) / abs(float(cpu[s])) for s in range(4)]
        need(max(rel) <= CLI_CPU_LOSS_RTOL,
             f"{arch} cli: card losses {card} vs CPU {cpu}: {rel} over {CLI_CPU_LOSS_RTOL}")
        out["resumed_equals_uninterrupted"] = {"arrays": len(a.files), "bit_equal": True}
        out["card_vs_cpu_loss_rel"] = rel
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return out


def run_serve_example(launches_total) -> dict:
    """``python -m repro_torch.examples.serve_lm`` in process: 4 prompts of
    16 tokens and 16 greedy tokens on the smoke qwen3-4b; every printed
    token in range, and the prefill through kernel 11 at hd 16 (one launch
    a layer)."""
    import io
    import torch
    from repro_torch.examples import serve_lm
    from repro_torch.kernels import backend

    backend.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve_lm.main([])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = dict(backend.launches)
    launches_total.update(counts)
    rows = [json.loads(line) for line in buf.getvalue().splitlines()
            if line.strip().startswith("[")]
    vocab = serve_lm.CFG.vocab_size
    need(rc == 0 and len(rows) == serve_lm.SHAPE.global_batch
         and all(len(r) == 1 + serve_lm.STEPS and all(0 <= t < vocab for t in r) for r in rows),
         f"serve example: output {buf.getvalue()!r}")
    need(counts == {"flash_attention_fwd_hd16": serve_lm.CFG.num_layers},
         f"serve example: launches {counts}")
    return {"tokens": rows, "sec": sec, "launches": counts}


# --------------------------------------------------------------------------- #
# Phase 6: the encode path and the single-host stack.
# --------------------------------------------------------------------------- #

ENCODE_PATH_KERNELS = ("bernoulli_encode_2d", "fixed_k_gather", "binary_encode_2d", "fwht")
SINGLE_HOST_N, SINGLE_HOST_D, SINGLE_HOST_ROUNDS = 16, 1 << 22, 4
FEDERATED_N, FEDERATED_D = 32, 1 << 20
# realized squared error against the closed form, and measured bits of a
# Bernoulli round against the expected (|S_i| is random)
MSE_RTOL, BITS_RTOL = 0.10, 0.01


def run_encode_path(launches_total) -> dict:
    """``launch/bench_encode_speed.py`` as a user runs it: every size, every
    encoder, timed on the card; each of its kernels launched."""
    import torch
    from repro_torch.kernels import backend
    from repro_torch.launch import bench_encode_speed

    torch.cuda.empty_cache()
    backend.reset_launches()
    rows = bench_encode_speed.rows(torch.device("cuda"))
    counts = dict(backend.launches)
    launches_total.update(counts)
    need(all(r["check"] for r in rows), "encode path: a row failed its check")
    for k in ENCODE_PATH_KERNELS:
        need(counts.get(k, 0) > 0, f"encode path: {k} never launched ({counts})")
    torch.cuda.empty_cache()
    return {"rows": [{k: r[k] for k in ("name", "us_per_call", "derived", "check", "ms")}
                     for r in rows], "launches": counts}


def run_single_host() -> dict:
    """``MeanEstimator`` on the card for the quickstart's seven protocols at
    n = 16, d = 2^22, budget d: ``SINGLE_HOST_ROUNDS`` rounds of
    ``estimate`` and ``empirical_mse`` over as many trials, each held to its
    closed form; then the federated example's straggler round at n = 32,
    d = 2^20."""
    import torch
    from repro_torch import random as R
    from repro_torch.core import decoders
    from repro_torch.core.protocol import MeanEstimator, empirical_mse
    from repro_torch.examples import federated_mean, quickstart

    dev = torch.device("cuda")
    n, d = SINGLE_HOST_N, SINGLE_HOST_D
    xs = torch.randn(n, d, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    x_true = decoders.averaging_decoder(xs)
    out = {"n": n, "d": d, "protocols": []}
    for name, enc, comm in quickstart.configs():
        t0 = time.perf_counter()
        est = MeanEstimator(enc, comm, budget=float(d))
        errs, bits = [], []
        for r in range(SINGLE_HOST_ROUNDS):
            rep = est.estimate(R.fold_in(R.PRNGKey(1), r), xs)
            need(tuple(rep.estimate.shape) == (d,) and bool(torch.isfinite(rep.estimate).all()),
                 f"single host {name}: estimate not finite or of shape {tuple(rep.estimate.shape)}")
            errs.append(float(torch.sum((rep.estimate - x_true) ** 2, dtype=torch.float64)))
            bits.append(rep.bits)
        emp = float(empirical_mse(R.PRNGKey(2), xs, est, trials=SINGLE_HOST_ROUNDS))
        torch.cuda.synchronize()
        expected, exp_bits = rep.expected_mse, rep.expected_bits
        if enc.kind == "identity":
            need(errs == [0.0] * len(errs) and emp == 0.0 and expected == 0.0,
                 f"single host {name}: identity error {errs}, {emp} not exactly 0")
        else:
            for what, v in (("estimate", sum(errs) / len(errs)), ("empirical_mse", emp)):
                need(abs(v / expected - 1.0) <= MSE_RTOL,
                     f"single host {name}: {what} error {v:.6g} vs closed form {expected:.6g}")
        random_bits = enc.kind == "bernoulli"
        for b in bits:
            need(abs(b / exp_bits - 1.0) <= BITS_RTOL if random_bits else b == exp_bits,
                 f"single host {name}: measured bits {b} vs expected {exp_bits}")
        out["protocols"].append({
            "protocol": name, "expected_mse": expected, "err": errs, "empirical_mse": emp,
            "err_over_closed_form": (sum(errs) / len(errs) / expected) if expected else 0.0,
            "expected_bits": exp_bits, "bits": bits,
            "bits_per_coord": exp_bits / (n * d), "s": time.perf_counter() - t0})
    del xs, x_true

    t0 = time.perf_counter()
    xs = federated_mean.make_data(FEDERATED_N, FEDERATED_D, dev)
    fed = federated_mean.straggler_round(xs, R.PRNGKey(0))
    torch.cuda.synchronize()
    need(fed["sum_p"] <= fed["budget"] * (1 + 1e-4), f"federated: Σp {fed['sum_p']} over budget")
    need(abs(fed["err"] / fed["mse_closed"] - 1.0) <= MSE_RTOL,
         f"federated: one-round error {fed['err']:.6g} vs closed form {fed['mse_closed']:.6g}")
    need(abs(fed["err_partial"] / fed["mse_closed_partial"] - 1.0) <= MSE_RTOL,
         f"federated: straggler error {fed['err_partial']:.6g} vs closed form "
         f"{fed['mse_closed_partial']:.6g}")
    need(fed["elastic_bits"] == fed["elastic_expected_bits"],
         f"federated: elastic bits {fed['elastic_bits']} != {fed['elastic_expected_bits']}")
    out["federated"] = {**fed, "s": time.perf_counter() - t0}
    del xs
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# Phase 7: robust decode and fault tolerance at full width.
# --------------------------------------------------------------------------- #

ROBUST_FULL_PRESETS = ("bernoulli_seed_1bit", "binary_packed", "rotated_binary")
# kernel launches of one trim(1) round at n ranks: the packs as in
# ``expected_launches``, then one unpack a peer row to build the (n, d)
# stack (kernel 2 at n = 1 from −0.0, counted as bernoulli_unpack; kernel 6
# for the plane), and for the rotation one unrotate of the estimate
ROBUST_LAUNCHES = {
    "bernoulli_seed_1bit": lambda n: {"bernoulli_encode": n, "bernoulli_unpack": n},
    "binary_packed": lambda n: {"bitplane_pack": n, "bitplane_unpack": n},
    "rotated_binary": lambda n: {"rotate_minmax": n, "encode_pack": n, "bitplane_unpack": n,
                                 "fwht": 1},
}
PLAN_RATE, PLAN_STEPS = 0.25, 3


def wire_comm(n: int):
    """``StackedComm(n, "cuda")`` that also records the bytes of its first
    all_gather: a round's packed wire rows."""
    from repro_torch.core.collectives import StackedComm

    class WireComm(StackedComm):
        wire_bytes = None

        def all_gather(self, local):
            if self.wire_bytes is None:
                self.wire_bytes = local.numel() * local.element_size()
            return super().all_gather(local)

    return WireComm(n, "cuda")


def sq_err(y, want) -> float:
    """Σ (y − want)² in f64, 2^24 coordinates at a time."""
    import torch

    step = 1 << 24
    return sum(float(torch.sum((y[i:i + step] - want[i:i + step]).double() ** 2))
               for i in range(0, y.numel(), step))


def run_robust(main_d: int, launches_total) -> dict:
    """The robust decode at the embed bucket (d = ``main_d``, n = 8 stacked):
    one ``compressed_mean`` round of each of ``ROBUST_FULL_PRESETS`` under
    the mean and under trim(1): finite, the same wire bytes (the policy
    never touches the wire), trim(1)'s launches per ``ROBUST_LAUNCHES``, its
    squared error within ``mse_trimmed``'s bound (Bernoulli, binary); the
    (n, d) ``decode_rows`` stack and the reduction timed apart by CUDA
    events on the round's own rows.  Then ``robust_compressed_mean`` of
    ``bernoulli_seed_1bit`` with ``FailurePlan(rate=0.25)`` over 3 steps,
    each step's masked mean bit for bit a survivors-only rerun under the
    original peer indices; then one ``sync_grads_bucketed`` step of phase
    3's qwen3-4b tree under ``robust_preset("binary_packed", "trim(1)")``:
    launches, bytes against the accounting, finite, error within the
    buckets' ``mse_trimmed_binary`` bounds."""
    import torch
    from repro_torch import random as R
    from repro_torch.configs.registry import robust_preset
    from repro_torch.core import collectives as coll
    from repro_torch.core import mse, rotation
    from repro_torch.core import wire
    from repro_torch.core.wire import base, robust
    from repro_torch.distributed import fault_tolerance as ft
    from repro_torch.kernels import backend
    from repro_torch.train import bucketing, synthetic

    torch.cuda.empty_cache()
    n, d = synthetic.N, main_d
    dev = torch.device("cuda")
    x = torch.randn(n, d, generator=torch.Generator(device=dev).manual_seed(23), device=dev)
    xbar = x.mean(0)
    key = R.PRNGKey(29)
    out = {"n": n, "d": d, "presets": {}}
    for name in ROBUST_FULL_PRESETS:
        res = {}
        for policy in ("mean", "trim(1)"):
            cfg = robust_preset(name, policy, axes=("data",))
            comm = wire_comm(n)
            torch.cuda.synchronize()
            backend.reset_launches()
            t0 = time.perf_counter()
            y = coll.compressed_mean(x, key, cfg, comm)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = dict(backend.launches)
            need(tuple(y.shape) == (d,) and bool(torch.isfinite(y).all()),
                 f"robust {name} {policy}: estimate not finite or of shape {tuple(y.shape)}")
            res[policy] = {"round_ms": ms, "wire_bytes": comm.wire_bytes,
                           "err": sq_err(y, xbar), "launches": counts}
            del y
        launches_total.update(res["trim(1)"]["launches"])
        need(res["trim(1)"]["launches"] == ROBUST_LAUNCHES[name](n),
             f"robust {name}: launches {res['trim(1)']['launches']} != "
             f"{ROBUST_LAUNCHES[name](n)}")
        codec = wire.resolve(cfg)
        want_bytes = codec.wire_bits(n, d, cfg) / 8
        need(res["trim(1)"]["wire_bytes"] == res["mean"]["wire_bytes"] == want_bytes,
             f"robust {name}: wire bytes {res['trim(1)']['wire_bytes']} (trim) "
             f"{res['mean']['wire_bytes']} (mean) != {want_bytes}")
        if name != "rotated_binary":
            bound = float(mse.mse_trimmed_binary(x, 1) if name == "binary_packed" else
                          mse.mse_trimmed_bernoulli(x, cfg.encoder.fraction, x.mean(1), 1))
            need(res["trim(1)"]["err"] <= bound,
                 f"robust {name}: error {res['trim(1)']['err']:.6g} over mse_trimmed {bound:.6g}")
            res["mse_trimmed"] = bound
        # the stack and the reduction apart, on the round's rows (rotated: at dp)
        rows = torch.stack([codec.pack(x[i], key, i, cfg) for i in range(n)])
        inner, dd = ((codec.inner, rotation.padded_dim(d)) if name == "rotated_binary"
                     else (codec, d))
        res["decode_rows_ms"] = cuda_ms(lambda: inner.decode_rows(rows, key, cfg, dd, n), reps=2)
        stack = inner.decode_rows(rows, key, cfg, dd, n)
        res["reduce_ms"] = cuda_ms(lambda: robust.reduce_rows(stack, "trim", 1), reps=2)
        del rows, stack
        torch.cuda.empty_cache()
        out["presets"][name] = res
        print(f"  robust {name} trim(1): {json.dumps(res)}", flush=True)

    plan = ft.FailurePlan(rate=PLAN_RATE, seed=5)
    cfg = robust_preset("bernoulli_seed_1bit", "mean", axes=("data",))
    codec = wire.resolve(cfg)
    out["failure_plan"] = []
    for step in range(PLAN_STEPS):
        ks = R.fold_in(key, step)
        torch.cuda.synchronize()
        backend.reset_launches()
        t0 = time.perf_counter()
        y = ft.robust_compressed_mean(x, ks, cfg, step, plan, coll.StackedComm(n, dev))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = dict(backend.launches)
        launches_total.update(counts)
        need(counts == ROBUST_LAUNCHES["bernoulli_seed_1bit"](n),
             f"failure plan step {step}: launches {counts}")
        alive = plan.alive_mask(step, n, "cpu").tolist()
        acc = torch.zeros(d, device=dev)
        for i in range(n):
            if alive[i]:
                acc = acc + codec.unpack(codec.pack(x[i], ks, i, cfg), i, ks, cfg, d)
        need(same_bits(y, base.divide(acc, sum(alive))),
             f"failure plan step {step}: masked mean != the survivors-only rerun")
        out["failure_plan"].append({"alive": alive, "round_ms": ms, "err": sq_err(y, xbar)})
        del y, acc
    del x, xbar
    torch.cuda.empty_cache()

    cmp = robust_preset("binary_packed", "trim(1)", axes=("data",))
    shapes, bplan, comm = synthetic.main_path(cmp, dev)
    comp = [b for b in bplan.buckets if b.kind == "compressed"]
    _, want_bytes = wire_accounting(bplan, cmp, n)
    grads = synthetic.synthetic_grads(shapes, n, 0, dev)
    key = synthetic.step_key(0)
    torch.cuda.synchronize()
    backend.reset_launches()
    t0 = time.perf_counter()
    synced, _ = bucketing.sync_grads_bucketed(grads, bplan, cmp, key, comm)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = dict(backend.launches)
    launches_total.update(counts)
    want = {k: v * len(comp) for k, v in ROBUST_LAUNCHES["binary_packed"](n).items()}
    need(counts == want, f"robust sync: launches {counts} != {want}")
    need(all(bool(torch.isfinite(v).all()) for v in synced.values()), "robust sync: not finite")
    check_bytes("robust sync", comm, want_bytes)
    err = bound = 0.0
    for b in comp:
        v = bucketing.pack_bucket(grads, b)
        y = torch.cat([synced[sl.name].reshape(-1) for sl in b.slots])
        err += sq_err(y, v.mean(0))
        bound += float(mse.mse_trimmed_binary(v, 1))
        del v, y
    need(err <= bound, f"robust sync: error {err:.6g} over the mse_trimmed bounds {bound:.6g}")
    out["sync"] = {"preset": "binary_packed trim(1)", "ms": ms, "compressed_buckets": len(comp),
                   "err": err, "mse_trimmed": bound, "launches": counts}
    del grads, synced
    torch.cuda.empty_cache()
    return out


def main() -> int:
    setup()
    import torch

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)    # name, power limit: as nvidia-smi gives them
    print(f"[0] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}",
          flush=True)

    from repro_torch.kernels import backend
    from repro_torch.train import synthetic

    t0 = time.perf_counter()
    procs = start_flash_cubins()
    try:
        backend.build()
        for name in backend.SOURCES:
            backend.lib(name)
    except BaseException:
        for proc, _ in procs.values():
            proc.kill()
            proc.wait()
        raise
    check_flash_cubins(procs)
    print(f"[1] built {', '.join(backend.SOURCES)} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    shapes, _ = synthetic.main_shapes()
    main_d = max(math.prod(s) for s in shapes.values())
    records = {}
    t0 = time.perf_counter()
    check_kernels(SIZES, main_d, -(-main_d // synthetic.N), records)
    check_bitplane(SIZES, main_d, records)
    from repro_torch.core import rotation
    check_rotation(rotation.padded_dim(main_d) >> 20, records)
    check_flash(records)
    check_flash_bwd(records)
    check_hash_encoders(SIZES, main_d, records)
    check_divide(3)
    check_robust(3)
    check_robust(8)
    for mesh in HIER_MESHES:
        check_hierarchical(mesh)
    check_inner_shards()
    time_center(main_d)
    print("[2] every collective below runs on StackedComm, the ranks stacked on this card: "
          "the link is simulated, and DistComm (one rank per process) is not run here",
          flush=True)
    print(f"[2] wire and encoder kernels bit-equal to their plain versions, flash attention "
          f"forward and backward within tolerance, decodes at n = 3, robust rounds at n = 3 "
          f"and 8 and hierarchical rounds at (4, 2) and (2, 3) equal to the CPU's "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    bern = synthetic.preset("bernoulli_seed_1bit")
    runs = [(name, synthetic.preset(name), STEPS) for name in synthetic.PRESETS]
    runs.append(("bernoulli_seed_1bit flat decode",
                 dataclasses.replace(bern, scatter_decode=False), 1))
    runs.append(("dense_sim bernoulli 1/16",
                 dataclasses.replace(bern, mode="dense_sim", scatter_decode=False), 1))
    from collections import Counter
    total = Counter()
    for name, cmp, steps in runs:
        t0 = time.perf_counter()
        summary = run_main_path(name, cmp, steps, total)
        print(f"[3] {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    for name in synthetic.EF_PRESETS:
        t0 = time.perf_counter()
        summary = run_main_path_ef(name, synthetic.preset(name), STEPS, total)
        print(f"[3] {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    from repro_torch.configs.registry import compression_preset
    for name in synthetic.HIER_PRESETS:
        t0 = time.perf_counter()
        summary = run_main_path(name, compression_preset(name), STEPS, total, synthetic.HIER_MESH)
        print(f"[3] hierarchical {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    t0 = time.perf_counter()
    summary = run_serving(total)
    print(f"[4] {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    for arch, layers in MOE_SERVE:
        t0 = time.perf_counter()
        summary = run_serving_moe(arch, layers, total)
        print(f"[4b] {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    summary = run_serving_ssm(total)
    print(f"[4c] {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    summary = run_serving_hybrid(total)
    print(f"[4d] {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    summary = run_serving_encdec(total)
    print(f"[4e] {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    summary = run_serving_vlm(total)
    print(f"[4f] {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    summary = run_serving_dense(total)
    print(f"[4g] {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    kept = {}
    summary = run_training(total, kept)
    print(f"[5] {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    main_cells = {"training": summary}
    t0 = time.perf_counter()
    summary = run_restart(kept, total)
    del kept
    print(f"[5] checkpoint and restart {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    t0 = time.perf_counter()
    summary = run_twin("training", main_cells.pop("training"), *synthetic.train_main_path(),
                       synthetic.N, total)
    print(f"[5] overlapped vs post-backward {json.dumps(summary)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    summary = run_training_ef(total)
    print(f"[5] error feedback {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    t0 = time.perf_counter()
    summary = run_twin("error feedback", summary,
                       *synthetic.train_main_path(error_feedback=True), synthetic.N, total)
    print(f"[5] overlapped vs post-backward {json.dumps(summary)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    summary = run_training_multipod(total)
    print(f"[5] multi-pod {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    cfg, run, shape, mesh = synthetic.multipod_train_path()
    summary = run_twin("multi-pod", summary, cfg, run, shape, math.prod(mesh.values()), total,
                       mesh)
    print(f"[5] overlapped vs post-backward {json.dumps(summary)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    summary = run_training_moe(total)
    print(f"[5b] {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    summary = run_training_ssm(total)
    print(f"[5c] {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    summary = run_training_encdec(total)
    print(f"[5d] {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    summary = run_training_vlm(total)
    print(f"[5e] {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    summary = run_training_window(total)
    print(f"[5f] {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    summary = run_fsdp_identities()
    print(f"[5g] FSDP on vs off {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    t0 = time.perf_counter()
    summary = run_training_fsdp(total)
    print(f"[5g] {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    summary = run_fsdp_identities(synthetic.MULTIPOD_FSDP_MESH)
    print(f"[5h] multi-pod FSDP on vs off {json.dumps(summary)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    summary = run_training_multipod_fsdp(total)
    print(f"[5h] multi-pod FSDP {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    t0 = time.perf_counter()
    summary = run_example(total)
    print(f"[5] example {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    summary = run_cli(total)
    print(f"[5] training CLI {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    for arch in CLI_ARCHS:
        t0 = time.perf_counter()
        summary = run_cli_arch(arch, total)
        print(f"[5] training CLI, {arch} {json.dumps(summary)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    summary = run_serve_example(total)
    print(f"[5] serving example {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    t0 = time.perf_counter()
    summary = run_encode_path(total)
    print(f"[6] encode path {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    summary = run_single_host()
    print(f"[6] single host {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    summary = run_robust(main_d, total)
    print(f"[7] robust decode {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    launches = dict(total)
    for k in REPLACES:
        need(launches.get(k, 0) > 0, f"kernel {k} was never launched on the main path")

    kernels = []
    for k in REPLACES:
        r = records[k]
        kernels.append({"name": k, "route": "cuda", "source": SOURCE[k],
                        "replaces": REPLACES[k], "launches": launches[k],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(f"[8] total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing JSON lines:

  1. build       — compile the seven CUDA kernels from ``src/repro_torch/
                   kernels/csrc`` (one nvcc per source, all at once), timed.
  2. kernels     — hold each kernel against its plain PyTorch version on the
                   card: in float32 at small shapes (TF32 off) and in bf16
                   at the shapes the served models give it (mixtral's, and
                   DeepSeek-V3's for moe_ffn, flash_prefill and the MLA
                   decode; moe_ffn's decode bucket both full and as 8
                   routed rows fill it, its empty rows exactly zero;
                   gqa_decode's ring both half-filled, as mid-serve, and
                   full);
                   time the kernel, its plain version and one
                   PyTorch library call beside the least time the card
                   could take (``bound_ms``).  The paged decodes read an
                   arena whose trash block is NaN, and their fused forms
                   must equal write-then-attend bit for bit.  The expert
                   gather (mixtral's 352 MB spans at 0, 4 and 8 misses,
                   with a pad slot at 4) must equal its plain version bit
                   for bit; beside it the pinned host-to-device copy rate
                   (``h2d_copy``) and the route through PyTorch calls.
                   The int8 paths at the same served shapes (records
                   ``kernel_int8``): moe_ffn with int8 experts and
                   per-expert scales (decode, as 8 routed rows fill it,
                   prefill), gqa_decode over the int8 ring of the half-
                   filled row, the fused paged decode over the int8 arena
                   (fused equal to write-then-attend bit for bit); their
                   library yardsticks run on weights or rings dequantized
                   to bf16 beforehand.  The families' shapes: the D-256
                   flash_prefill body at gemma2's prefill (S 4608, window
                   4096 and global, softcap 50; its own record, whose
                   yardstick is SDPA with the window mask and no
                   softcap), moe_ffn at moonshot's decode (E 64, full
                   and as 8 routed rows fill it), gqa_decode at glm4's
                   group of 16 and gemma2's D 256 with softcap 50, and
                   the fused paged decode at gemma2's D 256 (sub-records
                   "families").
                   The backward of flash_prefill (``kernel_flash_bwd``,
                   the port's own kernel) against autograd of the plain
                   version, f32 within 1e-4 and bf16 within 2e-2 of each
                   gradient's max-abs, at mixtral's training shape (B 4,
                   S 256, causal) and sub-records "train_shapes" at
                   DeepSeek's MLA heads (D 192 / Dv 128), whisper's
                   cross-attention with kv_len and gemma2's D 256 with a
                   window and the softcap; timed beside its bound, the
                   plain version's autograd backward and the backward of
                   scaled_dot_product_attention.
  2b. train      — while the card is empty: ``train_check``, mixtral-8x7b
                   at full width, 1 of its 32 layers in f32, one step's
                   loss and every gradient through the kernels against
                   the plain path (within 1e-4 of each leaf's max-abs, no
                   leaf without a gradient); ``train_mixtral``, 2 of 32
                   layers in bf16 with f32 AdamW moments, 8 steps of 4 x
                   256 tokens from the port's DataPipeline through
                   ``Trainer``: each step's loss, grad norm and time,
                   train tokens/s, peak memory, one step split into
                   forward + backward and AdamW, one forward and one
                   backward attention launch a layer a step; then
                   ``train_resume``, a checkpoint saved and resumed at
                   ``.smoke()`` width (step, parameters and moments equal).
                   ``train_plan`` (after ``train_check``): the same 1-layer
                   f32 model under the train plan of a ("model",) mesh of
                   one rank on an nccl group of one — the expert-parallel
                   all-to-all body with remat — against ``train_check``'s
                   step without a plan: loss within 1e-6 relative, every
                   gradient within 1e-5 of its leaf's max-abs; remat on
                   and off, peak memory and seconds of each; the
                   attention's forward kernel twice a layer under remat.
                   ``train_tp`` and ``serve_tp`` (after ``train_plan``):
                   tensor parallelism on two ranks of the one card, each
                   a process of this script (``--tp-rank``) in a gloo
                   group over CUDA tensors (nccl refuses two ranks on one
                   device).  ``train_tp``: each rank draws the 1-layer
                   f32 model, runs the one-rank step on the whole weights
                   and keeps its gradients' blocks, then one step of the
                   ("model",) train plan on its slices (``ep_a2a``,
                   remat, heads, vocabulary): loss within 1e-6 relative,
                   every gradient within 1e-5 of its leaf's max-abs, the
                   grad norm; ``serve_tp``: the parent decodes
                   ``serve_plan``'s prompts through the one-rank step
                   (1 layer f32, 8 steps; 2 layers bf16, 16 steps), the
                   ranks the same under the ("model",) decode plan
                   (``ep_psum`` on 4 experts a rank, each rank's half of
                   the ring): f32 logits within 1e-4 of the one-rank
                   logits' max-abs and tokens equal, bf16 decode tok/s
                   beside the one-rank step's; the launches of both to
                   the count.  The kernel phase's ``kernel_tp`` adds the
                   split shapes as sub-records "tp".
  3. serve       — the port's Engine at the full width of mixtral-8x7b with
                   the depth cut from 32 to 4 layers and every weight on
                   the card, random weights from a seed, the dense KV
                   ring: 24 requests of 32..384 prompt tokens and 64 new
                   tokens each.
  4. serve_paged — the same weights through the block-paged KV pool with a
                   pinned host tier, the arena sized at r_c 0.4 of the slot
                   pool: 24 requests of 128..640 prompt tokens, so that
                   blocks spill to the host tier, come back on demand and
                   are prefetched.  Each serve phase counts every kernel's
                   launches over its own run.
     serve_module — ``serve`` with module-based batching: both rotation
                   groups decode through one dispatch a window, the MoE
                   layers staging both groups' routed tokens into one
                   ``moe_ffn`` launch; its greedy transcripts must equal
                   ``serve``'s.
     serve_static — ``serve``'s requests in static mode (Algorithm 2's
                   micro-batches of 8, each prefilled 8 rows at once,
                   decoded one token a tick), and ``serve_static_module``
                   with windows of both micro-batches, whose transcripts
                   must equal lockstep static's; each micro-batch's
                   first-token logits within ``LOGIT_TOL`` of the plain
                   path; how many transcripts equal ``serve``'s is
                   printed.
     serve_static_paged — static mode over ``serve_paged``'s arena and
                   prompts, 128 new tokens each: it must spill, its peak
                   within the arena; beside a dense static engine on the
                   same requests.
     serve_overlap — ``serve_paged`` with overlapped admission: prompts
                   drain in chunks of 32 (one a tick, ahead of the decode
                   chunks), each landing in the paged pool at once; prints
                   the staged prefill seconds and the device ms of the
                   chunk attention (plain PyTorch, f32), counts how many
                   transcripts agree with ``serve_paged``'s, and holds the
                   logits at the end of chunked admissions against
                   monolithic prefill, both with a capacity no expert
                   bucket can overflow: in float32 within ``F32_TOL``, in
                   bf16 within ``LOGIT_TOL`` or, on a prompt whose top-2
                   routing a rounding flips, twice the distance between
                   the kernel and plain paths of its monolithic prefill.
                   Admission at one chunk a tick keeps
                   about two requests in the arena, so a second run (8
                   requests, 128 new tokens, the arena at its floor of one
                   slot) drives spills and fetches under staged admission.
     serve_budget — ``serve_paged``'s settings and prompts under EOS-aware
                   reservations (``reserve_mode="ewma"``) with a per-group
                   budget of 2048 tokens, quotas of 8 and 128 in turn:
                   ``enforce_budget`` must preempt, every request must
                   complete; prints the blocks swept back to the arena.
  5. trace       — one more serving window of each engine under
                   torch.profiler: device time by kernel family (copies
                   between the arena and the host tier included) and the
                   device's busy share.
  6. check       — prefill and decode logits through the kernels against
                   the plain versions (``ExecPolicy(impl="ref")``), on the
                   dense ring and on a paged arena with a scattered page
                   table; how far their greedy transcripts agree; and the
                   greedy transcripts of the paged engine against the dense
                   engine on the same prompts.  ``check_expert``: the same
                   weights packed into pinned host stores and served
                   expert-paged (a pool of r_w 0.25 of the spans); its
                   greedy transcripts must equal the dense engine's.
                   ``check_expert_kv``: those stores over ``serve_paged``'s
                   arena (r_c 0.4) in lockstep, on 16 prompts of 448..640
                   tokens that overflow it, against a fresh KV-paged
                   engine: transcripts and the whole ``kv_traffic()``
                   equal, spills and expert misses required.
                   ``chaos``: the fault plane on those weights and stores,
                   8 requests of 896..960 prompt tokens x 32 in two
                   regimes — (a) ``serve_paged``'s settings, (b) expert-
                   paged at r_w 0.5 with prefetch, the gate predictor and
                   windows of 2 of 4 groups over the same arena — each a
                   fault-free run and two seeded schedules over all seven
                   fault sites with the dispatch watchdog on the real
                   clock; (b) also a p 0.9 ``expert_copy`` burst that walks
                   the degradation ladder to ``admission_shed`` (the KV
                   host tier demoted to pageable memory on the way) and a
                   second, fault-free wave that walks it back to healthy
                   (the tier pinned again); and an engine whose pinned
                   tier is refused at construction, which starts pageable
                   and re-pins.  Every run's transcripts must equal its
                   regime's fault-free run's, with 0 preemptions and
                   spills; prints each run's decode tok/s beside the
                   fault-free one's, retries, aborts, stalls, slow
                   dispatches and the ladder's events.  Every fault-free
                   paged phase requires its KV host tier pinned and the
                   ladder at level 0.
                   ``check_layer_paged``: 8 of ``serve``'s prompts through
                   a static engine with the weights packed whole-layer
                   into page-locked stores, and ``check_static_expert``
                   through a static expert-paged one: transcripts equal
                   to the static resident engine's.
     sample      — temperature 0.8: the engine reproduces its transcripts
                   from its seed and changes them with it; ``sample``'s
                   frequencies over 200 000 draws match softmax(logits /
                   T), and top_k=8 draws nothing else.
     serve_plan  — ``serve``'s weights through ``make_serve_step`` under
                   the decode plans of a ("model",) mesh (the expert-
                   parallel psum body) and a ("data", "model") mesh (the
                   grouped MoE), one rank each on an nccl group, both
                   with the sequence-sharded decode attention: 8 prompts
                   of 128 tokens over a ring of 512, 16 greedy steps at
                   capacity 8.0; tokens and logits against the step
                   without a plan, decode tok/s of each; the plan's
                   kernels against their plain versions with the routing
                   replayed, in bf16 and at 1 layer in f32; the launches
                   of moe_ffn, gqa_decode and flash_prefill to the count.
     serve_int8  — ``serve`` with int8 expert weights and int8 KV
                   (``expert_dtype`` / ``kv_dtype``), 4 layers on the
                   card; ``serve_paged_int8`` the same weights over
                   ``serve_paged``'s arena (spills, misses, prefetches
                   required; KV bytes beside ``serve_paged``'s);
                   ``check_int8`` (``check`` on them, and the int8-KV
                   logits within a relative 0.05 of the bf16-KV ones with
                   the routing replayed); ``check_expert_int8`` (the int8
                   weights expert-paged at r_w 0.25: transcripts equal to
                   a resident engine's whose scales are rounded to bf16,
                   as the shared span holds them).
  7. serve_expert_int8 — the mixtral engines are released; mixtral-8x7b
                   at full width with int8 experts, all 32 layers where
                   the host holds their 47.8 GB of stores (the rule's
                   arithmetic printed), expert-paged with
                   ``serve_expert``'s settings, the gather's link bytes
                   a token a layer and rate; a trace window; the stores
                   released, with a ``host_memory`` line after each
                   release of stores.
     serve_layer_paged — the paper's
                   configuration: mixtral-8x7b at full width, 8 of its 32
                   layers drawn into page-locked whole-layer stores (23.2
                   GB; the host must hold them plus 20 % and 20 GiB),
                   every layer streamed each pass, static micro-batches of
                   32 through windows: 64 requests of 32..256 prompt
                   tokens x 32; the bytes the copies moved against
                   ``weight_traffic()``, their rate against ``h2d_copy``,
                   and a trace window.  The stores are released after.
                   The host rule reads ``host_mem_available``: the
                   machine's MemAvailable credits a released store's
                   pages back late, the process's resident set at once.
     serve_expert — mixtral-8x7b at full
                   width and the deepest cut of its 32 layers that the
                   host holds (all 32 are ~93 GB of bf16 weights, more
                   than the card holds): the host must hold the stores
                   plus 20 % and 20 GiB (never below 8 layers; printed as
                   layers / of_layers), and at most 8 layers for the
                   script's time, drawn on the card layer by layer
                   from a seed into pinned host stores, served
                   expert-paged with a device pool of r_w 0.5 of the
                   (layer, expert) spans: 8 requests of 32..256 prompt
                   tokens, 32 new tokens each.  Beside
                   the serve numbers: the bytes the gather moved over the
                   link, its seconds on the stream (CUDA events around
                   each call), their rate and the process's peak resident
                   host memory.  Then a trace window of it.
     serve_expert_module — that engine deleted, a module-batched one over
                   the same stores, depth and pool ratio serves the same 8
                   requests: its greedy transcripts must equal
                   ``serve_expert``'s, with fewer bytes read over the link
                   by the gather; then a trace window of it.
     serve_expert_kv — both offload ratios, the paper's setting: the same
                   stores and requests through windows at r_w 0.5 over a
                   block-paged KV arena of r_c 0.15 with its pinned host
                   tier (reckoned into the MemAvailable rule): the arena
                   must spill and fetch, every request complete; prints
                   how many transcripts equal ``serve_expert_module``'s.
                   Then the stores are released.
     policy      — HRM's policy search for mixtral-8x7b at full depth on
                   the ``h100`` preset, its link this run's ``h2d_copy``
                   and its CPU capacity MemAvailable, over
                   ``serve_expert``'s workload: the best policy, the best
                   with attention on the card (required feasible) beside
                   the hand-set r_w 0.5, HRM's modelled link bytes beside
                   ``serve_expert``'s measured and booked ones, and a timed
                   probe of the host's copy rate and f32 matmul rate.
     check_moonshot — moonshot-v1-16b-a3b (64 experts top-6, d_ff 1408)
                   at full width, 4 of its 48 layers on the card, then
                   packed into pinned stores and served expert-paged at
                   r_w 0.25: transcripts equal to the resident engine's.
     serve_moonshot_expert — moonshot at full width, all 48 layers where
                   the host rule holds their 53.2 GB of stores (the rule's
                   arithmetic and any cut printed), drawn on the card
                   layer by layer into page-locked stores, served
                   expert-paged at r_w 0.5 in lockstep (+ a trace window)
                   and then in windows (``_module``, transcripts equal):
                   decode tok/s, the gather's link bytes against
                   ``weight_traffic()``'s booked bytes and ``h2d_copy``,
                   hits and misses, its launches, its host copies (one a
                   missed leaf) a layer and its host ms a call.
     check_gemma2 — gemma2-2b at full width, 2 layers (one window, one
                   global), float32, the window cut to 64 under a
                   200-token prompt: 8 decode steps' logits within 1e-3
                   of a teacher-forced forward, through the kernels.
     serve_gemma2 / serve_glm4 / serve_olmo — each at full width and
                   depth, every weight on the card: 8 requests over the
                   dense ring, then over the block-paged arena at r_c 0.5
                   (``_paged``; gemma2 pages its global layers only),
                   greedy transcripts equal, no preemption.  gemma2's 8
                   prompts of 4200..4600 tokens x 32 cross its 4096
                   window (max_seq 5120), through the D-256 flash_prefill
                   body (+ a trace window); glm4 and olmo take
                   ``serve``'s prompts, 32 new tokens each.
     check_mamba2 — mamba2-1.3b (the Mamba-2 mixer, plain PyTorch in
                   both packages) at full width, 4 of its 48 layers, f32:
                   a 300-token prompt (past one SSD chunk of 256, 12 past
                   a multiple of 16) prefilled by the engine's prefill
                   step at the engine's bucket of 304 with its true
                   length, then 8 decode steps: logits within 1e-3 of a
                   teacher-forced forward; the same prompt prefilled at
                   its exact width: SSM states and conv tails within 1e-5
                   of the bucketed prefill's (and how far the padding
                   moves them without the true length, printed).
     serve_mamba2 — mamba2-1.3b at full width and all 48 layers on the
                   card: 8 prompts of 32..384 tokens x 32 in lockstep,
                   windows (``_module``, transcripts equal) and static
                   mode (``_static``); decode tok/s, prefill s, peak
                   device memory; a trace window of the lockstep engine.
     serve_jamba_expert — jamba-1.5-large at full width, one period (8 of
                   its 72 layers: 7 Mamba-2 mixers, one attention layer,
                   4 MoE of 16 experts) with int8 experts: a resident
                   engine (~52 GB on the card, ``serve_jamba``) serves 4
                   requests of 64..256 tokens x 16; its blocks are packed
                   into page-locked stores (49.5 GB), it is freed, and an
                   expert-paged engine at r_w 0.5 over the block arena at
                   r_c 0.5 serves the same requests: transcripts equal;
                   decode tok/s, the gather's and the shared spans' link
                   bytes a token a layer, ``weight_traffic()`` beside the
                   gather's bytes, host copies a MoE layer.  The kernel
                   phase holds moe_ffn (int8, E 16, D 8192, F 24576; C 1,
                   2, 3 and a prefill bucket, against the plain version on
                   the 2-4 occupied experts), flash_prefill (H 64 / Hkv 8,
                   D 128, S 384), gqa_decode and paged_gqa_decode (G 8) at
                   jamba's shapes (sub-records "families").
     check_whisper — whisper-small at full width, 2 of its 12 encoder
                   and 2 of its 12 decoder layers, f32: ``models.inputs.
                   concrete_inputs``' tokens and 1500 frames, a prefill
                   and 8 greedy decode steps through the kernels (the
                   encoder's and the cross-attention's non-causal
                   flash_prefill, one decode query over the encoder's
                   keys) against the plain path within 1e-4, the
                   persisted cross K / V too; launches to the count.
     serve_whisper — all 12 + 12 layers, bf16: 8 requests of 1500
                   frames and 4..64 prompt tokens, each prefilled alone
                   through ``forward`` (the engine takes no frames, in
                   either package) into a row of one cache, then 31
                   greedy cached decode steps of the batch: prefill s
                   (encoder included), decode tok/s, peak memory,
                   launches to the count; the same through the plain
                   versions (transcripts compared); a trace window.
     check_paligemma / serve_paligemma — paligemma-3b at full width: 2
                   of 18 layers in f32 with 256 patches + 96 text tokens
                   (kernel against plain path within 1e-4; the prefix
                   must move every text position's logits), then all 18
                   layers in bf16: 8 requests of 256 patches + 32..128
                   text tokens through ``forward`` as whisper's, then
                   text only through the engine over the dense ring
                   (``serve``'s settings and prompts, 8 x 32) and a
                   trace window.  The kernel phase holds flash_prefill
                   non-causal at whisper's encoder (8 x 1500, H 12, D
                   64) and cross shapes (S 64 and 1 over 1500 keys), its
                   wide causal body at paligemma's prefix (S 384, H 8 /
                   Hkv 1, D 256), and gqa_decode at G 1 / D 64 and G 8 /
                   D 256, each in bf16 and f32 (sub-records
                   "families").
     launch      — the port's ``launch/serve.py --smoke --hw h100`` on the
                   card, and with ``--paged``: every request done.
  8. serve_mla   — deepseek-v3-671b at full width with the depth cut from
                   61 to 5 layers (its 3 dense-FFN prologue layers and 2
                   MoE layers, 53.2 GB of bf16 weights, every weight on the
                   card; all 61 are 1.3 TB), random weights from a seed,
                   over the block-paged latent arena at r_c 0.4 with
                   the same engine settings and traffic as serve_paged; the
                   prologue's latent rings stay dense.  Then a trace window
                   of it, and ``check_mla``: its logits through the kernels
                   against the plain path, on the dense cache and on a
                   paged latent arena with a scattered page table.

Then a ``{"kernels": [...]}`` line, the card's name and power limit from
nvidia-smi, and last ``{"ok": true, "device": {...}}``.  Any failure raises
and exits non-zero; so does a machine without a CUDA device, and a copy of
this file outside the repository.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import resource
import statistics
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
SEED = 0
LAYERS = 4                    # of mixtral-8x7b's 32
MLA_LAYERS = 5                # of deepseek-v3-671b's 61: 3 prologue + 2 MoE
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BF16_OPS_PER_S = 989e12       # dense bf16 tensor-core peak, 700 W
CUDA_CORE_F32_OPS_PER_S = 67e12   # f32 outside the tensor cores, 700 W
SERVE = dict(ubatch=8, num_ubs=2, max_seq=512, decode_chunk=8)
N_REQUESTS, PROMPT_LENS, NEW_TOKENS = 24, (32, 384), 64
# The paged pool: 16 slots x 1024 positions = 1024 blocks of 16, of which
# 410 fit the arena.  One group's worst case (8 x (640 + 64) tokens, 352
# blocks) fits, so a chunk never preempts for lack of room, but the two
# groups together hold ~450 blocks on average: every tick spills the other
# group's cold blocks to the host tier and fetches its own back.
SERVE_PAGED = dict(ubatch=8, num_ubs=2, max_seq=1024, decode_chunk=8,
                   kv_paged=True, block_tokens=16, kv_gpu_ratio=0.4,
                   kv_prefetch=True)
PAGED_PROMPT_LENS = (128, 640)
# Overlapped admission over the paged pool at its floor: 8 of the paged
# requests, 128 new tokens each
OVERLAP_SPILL_REQUESTS, OVERLAP_SPILL_NEW_TOKENS = 8, 128
# Expert-granular paged weights: every layer's experts in pinned host
# stores, a device pool of half the (layer, expert) spans.
SERVE_EXPERT = dict(ubatch=8, num_ubs=2, max_seq=512, decode_chunk=8,
                    expert_paged=True, w_gpu_ratio=0.5)
EXPERT_REQUESTS, EXPERT_PROMPT_LENS, EXPERT_NEW_TOKENS = 8, (32, 256), 32
MIN_EXPERT_LAYERS = 8         # the deepest cut serve_expert accepts
# serve_expert's depth is also cut to this many layers for the script's
# time (the host holds ~25 of 32): the families' phases take its place
SERVE_EXPERT_MAX_LAYERS = 8
# requests in the profiled windows of the expert-paged engines: the
# profiler takes ~10x a window's wall to process its gathers and copies
EXPERT_TRACE_REQUESTS = 1
# Both offload ratios at once (serve_expert_kv): windows, and an arena of
# 0.15 of the 512 blocks (77), below the ~90 the 8 requests' rows need
# together, so that it spills, fetches and preempts.
SERVE_EXPERT_KV = {**SERVE_EXPERT, "module_batch": True, "kv_paged": True,
                   "block_tokens": 16, "kv_gpu_ratio": 0.15}
# check_expert_kv: 16 prompts of 448..640 tokens overflow serve_paged's
# arena (at least 464 blocks of 410); the check phase's 8 prompts of
# 128..448 tokens hold ~150 and never spill
CHECK_KV_REQUESTS, CHECK_KV_PROMPT_LENS = 16, (448, 640)
# EOS-aware reservations (serve_budget): serve_paged's settings and prompts
# with a quarter of each group's 8192-token slice as its budget; quotas of
# 8 and 128 in turn stand in for requests that stop early, so the EWMA
# under-reserves the long ones and enforce_budget preempts them
SERVE_BUDGET = {**SERVE_PAGED, "reserve_mode": "ewma", "cache_tokens": 2048}
BUDGET_NEW_TOKENS = (NEW_TOKENS // 8, 2 * NEW_TOKENS)
# The fault plane (chaos): 8 prompts of 896..960 tokens x 32 through
# serve_paged's arena (410 of 1024 blocks) hold ~480 blocks together, but
# the rows one dispatch reads (a group of 4 in regime (a), a window of 2
# groups of 2 in (b)) at most ~250: every tick spills and fetches, and
# nothing is preempted (a preemption changes who shares the grouped
# moe_ffn's capacity buckets, so tokens would move)
CHAOS_REQUESTS, CHAOS_PROMPT_LENS, CHAOS_NEW_TOKENS = 8, (896, 960), 32
CHAOS_KV = {**SERVE_PAGED, "watchdog": True}
CHAOS_EXPERT = {**CHAOS_KV, "ubatch": 4, "num_ubs": 4, "module_batch": True,
                "module_groups": 2, "expert_paged": True, "w_gpu_ratio": 0.5,
                "prefetch": True, "predict": True}
CHAOS_SEEDS = (0, 1)
# the burst: p 0.9 expert_copy failures until 40 are spent (all during the
# first wave's first admissions), each a rung down (down_after 1).  The
# ladder moves only at a tick's start, and a tick of regime (b) books
# 250..560 healthy KV and expert copies (~355 in the first; CPU rehearsal
# at these settings), so a rung back up takes 512 of them: the descent
# outlives the tick it happened in and is enacted at the next.  The way
# back (5 x 512) takes the rest of the first wave and two more fault-free
# waves (~1070 healthy copies each)
CHAOS_BURST = dict(p=0.9, max_faults=40, down_after=1, up_after=512,
                   waves=3)
# Static mode (serve_static, serve_static_module, serve_static_paged):
# Algorithm 2's micro-batches of 8, admitted as a unit, one token a tick
SERVE_STATIC = {**SERVE, "mode": "static"}
# serve_static_paged: in static mode the arena's floor is one micro-batch's
# worst case (512 of serve_paged's 1024 blocks, above r_c 0.4's 410); two
# micro-batches of the 16 longest paged prompts peak at 504 blocks with 64
# new tokens (CPU rehearsal), so they take 128 and overflow it
STATIC_PAGED_NEW_TOKENS = 2 * NEW_TOKENS
# The paper's configuration (serve_layer_paged): whole-layer paged weights
# streamed every pass, static micro-batches of 32 through windows of both
# rotation groups; Algorithm 2's budget (gen_len 32, 512 x 32 = 16384
# tokens a micro-batch) admits 32 prompts of 32..256 tokens at once
SERVE_LAYER = dict(ubatch=32, num_ubs=2, max_seq=512, mode="static",
                   module_batch=True, paged=True)
LAYER_PAGED_LAYERS = 8        # of mixtral-8x7b's 32: 8 x 2.90 GB pinned
LAYER_REQUESTS, LAYER_PROMPT_LENS, LAYER_NEW_TOKENS = 64, (32, 256), 32
# Sampling at a temperature (sample): the engine's draws, and one logits
# row of 64 entries drawn 200 000 times, whose frequencies' standard error
# is at most 0.0011: the bound is over 4 of them
SAMPLE_TEMPERATURE, SAMPLE_ROWS, SAMPLE_FREQ_TOL = 0.8, 200_000, 0.005
# The attention families at full width and depth, every weight on the card
# (serve_gemma2, serve_glm4, serve_olmo): 8 requests over the dense ring,
# then over the block-paged arena (r_c 0.5; only full-attention layers are
# paged); no run may preempt, so the two transcripts must be equal.
# gemma2's prompts of 4200..4600 cross its 4096 window, so prefill writes
# its window rings past their width and decode wraps them
FAMILY_REQUESTS = 8
GEMMA2_SERVE = dict(ubatch=8, num_ubs=2, max_seq=5120, decode_chunk=8)
GEMMA2_PAGED = {**GEMMA2_SERVE, "kv_paged": True, "block_tokens": 16,
                "kv_gpu_ratio": 0.5, "kv_prefetch": True}
GEMMA2_PROMPT_LENS, GEMMA2_NEW_TOKENS = (4200, 4600), 32
GEMMA2_KERNEL_S = 4608        # flash_prefill's kernel record: 36 x 128 rows
FAMILY_PAGED = {**SERVE, "kv_paged": True, "block_tokens": 16,
                "kv_gpu_ratio": 0.5, "kv_prefetch": True}
FAMILY_NEW_TOKENS = 32
# check_gemma2: 2 layers (one window, one global) in f32, a window of 64
# under a 200-token prompt and 8 decode steps
CHECK_GEMMA2_WINDOW, CHECK_GEMMA2_PROMPT, CHECK_GEMMA2_STEPS = 64, 200, 8
CHECK_GEMMA2_TOL = 1e-3
CHECK_MOONSHOT_LAYERS = 4     # of moonshot's 48: resident vs expert-paged
# The SSM slice.  check_mamba2: mamba2-1.3b at full width, 4 of 48
# layers, f32; one prompt of 300 tokens (past one SSD chunk of 256, and
# 12 past a multiple of 16, so the engine's bucket of 304 pads it)
MAMBA2_ARCH, JAMBA_ARCH = "mamba2-1.3b", "jamba-1.5-large-398b"
CHECK_MAMBA2_LAYERS, CHECK_MAMBA2_PROMPT, CHECK_MAMBA2_STEPS = 4, 300, 8
CHECK_MAMBA2_TOL, CHECK_MAMBA2_STATE_TOL = 1e-3, 1e-5
# ... and static admission's case: one prefill of rows of these true
# lengths in the same bucket (the last a padding row, length 0)
CHECK_MAMBA2_ROWS = (CHECK_MAMBA2_PROMPT, 173, 45, 0)
# serve_mamba2: all 48 layers on the card, serve's settings, 8 prompts of
# 32..384 tokens x 32
MAMBA2_REQUESTS, MAMBA2_NEW_TOKENS = 8, 32
# serve_jamba_expert: one period (8 of 72 layers) of jamba-1.5-large at
# full width with int8 experts, first resident (~52 GB on the card), then
# expert-paged at r_w 0.5 over the block arena at r_c 0.5: 4 requests of
# 64..256 tokens x 16, in two rotation groups of 2
JAMBA_LAYERS = 8
JAMBA_SERVE = dict(ubatch=2, num_ubs=2, max_seq=512, decode_chunk=8)
JAMBA_EXPERT = {**JAMBA_SERVE, "expert_paged": True, "w_gpu_ratio": 0.5,
                "kv_paged": True, "block_tokens": 16, "kv_gpu_ratio": 0.5,
                "kv_prefetch": True}
JAMBA_REQUESTS, JAMBA_PROMPT_LENS, JAMBA_NEW_TOKENS = 4, (64, 256), 16
JAMBA_KERNEL_S = 384          # flash_prefill's jamba record
# The encoder-decoder and VLM slice.  whisper-small is driven through
# forward (the engine cannot serve an encoder's input, in either package):
# each request prefilled alone (its 1500 frames through the encoder, its
# prompt through the decoder) into a row of one batch cache, then greedy
# cached decode steps of the whole batch.  check_whisper: 2 of 12 encoder
# and 2 of 12 decoder layers in f32, kernel path against plain path
WHISPER_ARCH, PALIGEMMA_ARCH = "whisper-small", "paligemma-3b"
WHISPER_REQUESTS, WHISPER_PROMPT_LENS, WHISPER_NEW_TOKENS = 8, (4, 64), 32
WHISPER_MAX_SEQ = 128
CHECK_WHISPER_LAYERS, CHECK_WHISPER_BATCH, CHECK_WHISPER_PROMPT = 2, 2, 48
CHECK_STEPS = 8               # decode steps of check_whisper, check_paligemma
# paligemma-3b: its 256 patch embeddings as the prefix of each prompt,
# then 32..128 text tokens, through forward as whisper (the engine takes
# no patches, in either package); then text only through the engine over
# the dense ring at serve's settings.  check_paligemma: 2 of 18 layers in
# f32, one prefix + 96 text tokens a row
PALIGEMMA_REQUESTS, PALIGEMMA_TEXT_LENS = 8, (32, 128)
PALIGEMMA_NEW_TOKENS, PALIGEMMA_MAX_SEQ = 32, 512
CHECK_PALIGEMMA_LAYERS, CHECK_PALIGEMMA_BATCH = 2, 2
CHECK_PALIGEMMA_TEXT = 96
# the prefix moves every text position's logits by at least this much
PREFIX_EFFECT = 1e-2
# The training slice.  train_mixtral: mixtral-8x7b at full width, 2 of its
# 32 layers, bf16 with f32 AdamW moments, 8 steps of 4 rows x 256 tokens
# from the port's DataPipeline through Trainer.  train_check: 1 layer in
# f32, one step's loss and every gradient through the kernels against the
# plain path.  The backward kernel's records: mixtral's training shape,
# DeepSeek's MLA heads, whisper's cross-attention with kv_len, gemma2's
# D 256 with a window and the softcap
TRAIN_B, TRAIN_S = 4, 256
TRAIN_LAYERS, TRAIN_STEPS = 2, 8
TRAIN_CHECK_LAYERS = 1
# the distributed layer's phases: plans over meshes of one rank on an nccl
# group of one.  serve_plan at capacity 8.0, where no expert bucket can
# overflow (as the reference's expert-parallel test takes it);
# train_plan's all-to-all body at 2.0, its least drop-free capacity at one
# rank (each of the 8 experts' buckets holds all B*S tokens)
PLAN_B, PLAN_SLOTS, PLAN_PROMPT, PLAN_STEPS = 8, 512, 128, 16
PLAN_CF, TRAIN_PLAN_CF = 8.0, 2.0
PLAN_LOSS_TOL, PLAN_GRAD_TOL = 1e-6, 1e-5   # train_plan: relative, of max-abs
# tensor parallelism (train_tp, serve_tp): TP_WORLD ranks on the one card
# in a gloo group over CUDA tensors (nccl refuses two ranks on one device),
# each a process of this script (``--tp-rank``); serve_tp's f32 check at 1
# layer and TP_F32_STEPS steps, its bf16 run at TP_SERVE_LAYERS and
# PLAN_STEPS; serve_plan's batch, prompt, ring and capacity
TP_WORLD, TP_SERVE_LAYERS, TP_F32_STEPS = 2, 2, 8
# serve_tp's runs: (label, layers, dtype, weights' seed, steps)
TP_SERVE_RUNS = (("f32", 1, "float32", SEED + 41, TP_F32_STEPS),
                 ("bf16", TP_SERVE_LAYERS, "bfloat16", SEED, PLAN_STEPS))
TP_LOGIT_TOL = 1e-4           # serve_tp f32: of the one-rank logits' max-abs
TP_TIMEOUT_S = 600
GRAD_TOL = 1e-4               # train_check: each leaf, of its max-abs
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # of each gradient's max-abs
GEMMA2_BWD_WINDOW = 64        # gemma2's 4096 cut to bite at S 256
HOST_MARGIN = 1.2             # MemAvailable must hold the stores + 20 %
HOST_RESERVE = 20 << 30       # ... and leave 20 GiB beside them
# bf16 tolerances.  A kernel and its plain version both compute in f32 from
# the same bf16 inputs; an output rounded to bf16 may then differ by one
# bf16 ulp (2^-8 relative) where the two f32 sums straddle a rounding edge.
BF16_OUT_TOL = 1e-2
# f32 partials (gqa_decode) and f32 runs differ only in summation order.
F32_TOL = 1e-4
# Served logits: the kernel and plain paths round the same activations to
# bf16 at different points of 4 layers; one-ulp differences (~0.4 %) carried
# through residual adds and norms stay within this on O(1) logits.
LOGIT_TOL = 0.1
# A prompt whose routing a bf16 rounding flips: its chunked admission may
# move its logits this many times as far as the kernel and plain paths of
# its monolithic prefill move them.
FLIP_FACTOR = 2.0


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries the seconds since the start
    (``t_s``)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median device time of one call, by CUDA events.  Before each call the
    stream sleeps (so the host's enqueue cost is hidden) and, unless
    ``cold=False``, a 64 MB buffer is rewritten (so the 50 MB L2 is cold,
    as on the served path, where the expert weights stream through it
    between calls)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)

    def __call__(self, fn, iters: int = 10, warmup: int = 2,
                 cold: bool = True) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            torch.cuda._sleep(1_000_000)
            if cold:
                self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(nbytes: float, ops: float):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / BF16_OPS_PER_S * 1e3
    return (max(tb, to), "bytes" if tb >= to else "operations")


def sdpa_gqa(F, q, k, v, group: int, **kw):
    """One scaled_dot_product_attention call over (B, H, S, D) heads,
    grouped-query natively where this PyTorch has ``enable_gqa`` (2.5+);
    older versions get K/V expanded to H heads beforehand."""
    if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      enable_gqa=True, **kw)
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    return lambda: F.scaled_dot_product_attention(q, k, v, **kw)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def close(a, b, tol: float) -> bool:
    """|a - b| <= tol + tol * |b| everywhere."""
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= tol + tol * b.abs()).all())


def gqa_case(torch, F, timer, q, k, v, valid, kw):
    """bf16 gqa_decode over one ring and validity mask against its plain
    version (f32 partials within ``F32_TOL``), timed beside its bound and
    SDPA over the same mask (without the softcap, where `kw` has one)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.gqa_decode import gqa_decode
    B, H, D = q.shape
    W, Hkv = k.shape[1], k.shape[2]
    got, want = gqa_decode(q, k, v, valid, **kw), \
        ref.gqa_decode_ref(q, k, v, valid, **kw)
    err = max(max_err(a, b) for a, b in zip(got, want))
    nvalid = int(valid.sum())
    require(all(close(a, b, F32_TOL) for a, b in zip(got, want)),
            f"gqa_decode bf16 (H {H} / {Hkv}, D {D}, {nvalid} valid): "
            f"{err}")
    # q, the K and V rows of the valid slots only (the rest are never
    # needed), the mask, and the f32 (o_unnorm, m, l) outputs
    nbytes = 2 * B * H * D + 2 * nvalid * Hkv * 2 * D + B * W \
        + 4 * B * H * (D + 2)
    bms, by = bound(nbytes, 2 * nvalid * H * 2 * D)
    cap = kw.get("attn_softcap", 0.0)
    return {
        "shape": {"B": B, "H": H, "Hkv": Hkv, "D": D, "W": W,
                  "valid": nvalid, "dtype": "bf16",
                  **({"softcap": cap} if cap else {})},
        "max_abs_err": err,
        "ms": timer(lambda: gqa_decode(q, k, v, valid, **kw)),
        "plain_ms": timer(lambda: ref.gqa_decode_ref(q, k, v, valid, **kw)),
        "bound_ms": bms, "bound_by": by,
        "library_ms": timer(sdpa_gqa(
            F, q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            H // Hkv, attn_mask=valid[:, None, None, :], scale=kw["scale"])),
        "library_call": "scaled_dot_product_attention, masked"
        + (", without the softcap" if cap else "")}


def paged_case(torch, F, timer, q, cache, pos, new, kw):
    """The fused bf16 paged_gqa_decode on one arena against its plain
    version (on the arena with a zero trash block; f32 partials within
    ``F32_TOL``), timed beside its bound and SDPA over the dense view
    already gathered (without the softcap, where `kw` has one).  Returns
    the record and the plain version's arena."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_decode import paged_gqa_decode
    from repro_torch.models import kvcache
    from repro_torch.models.attention import decode_valid_mask
    B, H, D = q.shape
    Hkv, bt = cache["k"].shape[0], cache["k"].shape[2]
    MB = cache["page_table"].shape[1]
    plain = zero_trash(cache)
    kn, vn = new["k"][:, 0], new["v"][:, 0]
    args = (q, cache["k"], cache["v"], cache["slot_pos"],
            cache["page_table"], pos)
    got = paged_gqa_decode(*args, k_new=kn, v_new=vn, **kw)
    want = ref.paged_gqa_decode_ref(q, plain, pos, k_new=kn, v_new=vn, **kw)
    err = max(max_err(a, b) for a, b in zip(got, want))
    require(all(close(a, b, F32_TOL) for a, b in zip(got, want)),
            f"paged_gqa_decode bf16 (H {H} / {Hkv}, D {D}): {err}")
    mapped = int((cache["page_table"] >= 0).sum())
    valid = int(pos.sum()) + B                  # written + the fresh token
    nbytes = (mapped * (Hkv * bt * 2 * D * 2 + bt * 4) + 2 * B * H * D
              + 2 * 2 * B * Hkv * D + 4 * B * (MB + 1)
              + 4 * B * H * (D + 2))
    bms, by = bound(nbytes, 2 * valid * H * 2 * D)
    view = kvcache.paged_view(plain)
    kt, vt = view["k"].transpose(1, 2), view["v"].transpose(1, 2)
    vmask = decode_valid_mask(view["slot_pos"], pos, 0)
    cap = kw.get("attn_softcap", 0.0)
    rec = {"shape": {"B": B, "H": H, "Hkv": Hkv, "D": D, "bt": bt, "MB": MB,
                     "arena_blocks": cache["k"].shape[1] - 1,
                     "mapped_blocks": mapped, "valid": valid,
                     "dtype": "bf16", "fused": True,
                     **({"softcap": cap} if cap else {})},
           "max_abs_err": err,
           "ms": timer(lambda: paged_gqa_decode(*args, k_new=kn, v_new=vn,
                                                **kw)),
           "plain_ms": timer(lambda: ref.paged_gqa_decode_ref(
               q, plain, pos, k_new=kn, v_new=vn, **kw)),
           "bound_ms": bms, "bound_by": by,
           "library_ms": timer(sdpa_gqa(
               F, q[:, :, None], kt, vt, H // Hkv,
               attn_mask=vmask[:, None, None, :], scale=kw["scale"])),
           "library_call": "scaled_dot_product_attention over the dense "
                           "view already gathered (gather not included)"
                           + (", without the softcap" if cap else "")}
    return rec, plain


def phase_kernels(torch, F):
    """Returns the per-kernel records of the kernels line (launches are
    filled in by the serve phase)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.gqa_decode import gqa_decode
    from repro_torch.kernels.moe_ffn import moe_ffn
    g = torch.Generator(device=DEVICE).manual_seed(SEED)

    def rn(*shape, std=1.0, dtype=torch.bfloat16):
        t = torch.empty(shape, dtype=dtype, device=DEVICE)
        return t.normal_(0.0, std, generator=g)

    # --- float32 at small shapes, TF32 off: the algorithm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = torch.float32
    x, wi, wo = (rn(4, 10, 64, dtype=f32), rn(4, 64, 2, 300, std=0.1,
                 dtype=f32), rn(4, 300, 64, std=0.1, dtype=f32))
    si = torch.rand(4, generator=g, device=DEVICE) + 0.5
    pairs = {"moe_ffn": [(moe_ffn(x, wi, wo, si, si, act="gelu"),
                          ref.moe_ffn_ref(x, wi, wo, si, si, act="gelu"))]}
    q, k, v = rn(3, 8, 64, dtype=f32), rn(3, 100, 2, 64, dtype=f32), \
        rn(3, 100, 2, 64, dtype=f32)
    valid = torch.rand(3, 100, generator=g, device=DEVICE) > 0.3
    valid[1] = False                        # a row with no valid slot
    pairs["gqa_decode"] = list(zip(
        gqa_decode(q, k, v, valid, scale=0.125, attn_softcap=30.0),
        ref.gqa_decode_ref(q, k, v, valid, scale=0.125, attn_softcap=30.0)))
    q, k, v = rn(2, 70, 4, 32, dtype=f32), rn(2, 70, 2, 32, dtype=f32), \
        rn(2, 70, 2, 32, dtype=f32)
    pairs["flash_prefill"] = [
        (flash_prefill(q, k, v, window=w, attn_softcap=c),
         ref.flash_prefill_ref(q, k, v, window=w, attn_softcap=c))
        for w, c in ((0, 0.0), (16, 30.0))]
    torch.cuda.synchronize()
    errs = {n: max(max_err(a, b) for a, b in ps) for n, ps in pairs.items()}
    emit({"phase": "kernels_f32", "max_abs_err": errs, "tol": F32_TOL})
    require(all(close(a, b, F32_TOL) for ps in pairs.values()
                for a, b in ps), f"f32 kernel mismatch: {errs}")

    # --- bf16 at the served shapes: the kernels as the main path runs them
    timer = Timer(torch)
    n = 256 << 20                                # HBM copy rate, 2 x 512 MB
    a = torch.empty(n, dtype=f32, device=DEVICE)
    b = torch.empty_like(a)
    copy_ms = timer(lambda: b.copy_(a))
    emit({"phase": "hbm_copy", "bytes": 2 * 4 * n, "ms": copy_ms,
          "GBps": 2 * 4 * n / copy_ms / 1e6})
    del a, b

    cfg_full = _mixtral()
    E, D, Fd = cfg_full.num_experts, cfg_full.d_model, cfg_full.d_ff
    H, Hkv, Dh = cfg_full.num_heads, cfg_full.num_kv_heads, cfg_full.head_dim
    B, W = SERVE["ubatch"], SERVE["max_seq"]
    records = []

    # moe_ffn at the decode bucket (the most launched shape) with every
    # bucket row full (the worst case), at the occupancy 8 routed rows give
    # it, and at the largest prefill bucket
    wi = rn(E, D, 2, Fd, std=D ** -0.5)
    wo = rn(E, Fd, D, std=Fd ** -0.5)
    for tokens, label in ((B, "decode"), (PROMPT_LENS[1], "prefill")):
        C = max(1, int(tokens * cfg_full.top_k * cfg_full.capacity_factor
                       / E + 0.999))
        x = rn(E, C, D)
        got, want = moe_ffn(x, wi, wo), ref.moe_ffn_ref(x, wi, wo)
        err = max_err(got, want)
        require(close(got, want, BF16_OUT_TOL), f"moe_ffn bf16 {label}: {err}")
        wi3 = wi.view(E, D, 2 * Fd)

        def library():
            h = torch.bmm(x, wi3)
            return torch.bmm(F.silu(h[..., :Fd]) * h[..., Fd:], wo)
        nbytes = 2 * (2 * E * C * D + 3 * E * D * Fd)
        bms, by = bound(nbytes, 6 * E * C * D * Fd)
        rec = {"name": "moe_ffn", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/moe_ffn.cu",
               "replaces": "src/repro/kernels/moe_ffn.py:59",
               "shape": {"E": E, "C": C, "D": D, "F": Fd, "dtype": "bf16",
                         "at": label},
               "max_abs_err": err,
               "ms": timer(lambda: moe_ffn(x, wi, wo)),
               "plain_ms": timer(lambda: ref.moe_ffn_ref(x, wi, wo), 3, 1),
               "bound_ms": bms, "bound_by": by,
               "library_ms": timer(library),
               "library_call": "torch.bmm chain (up, silu * up, down)"}
        emit({"phase": "kernel_bf16", **rec})
        if label == "decode":
            records.append(rec)
            rec["served_occupancy"] = moe_occupancy_case(
                torch, F, timer, rn, wi, wo, cfg_full, B, C)
    del wi, wo, x
    records[-1]["int8"] = moe_int8_cases(torch, F, timer, rn, cfg_full, B, g)

    # gqa_decode over a half-filled 512-slot ring, as mid-serve, and over
    # the full ring (every slot valid)
    q, k, v = rn(B, H, Dh), rn(B, W, Hkv, Dh), rn(B, W, Hkv, Dh)
    lens = torch.randint(PROMPT_LENS[0], PROMPT_LENS[1] + NEW_TOKENS,
                         (B,), generator=g, device=DEVICE)
    cases = [gqa_case(torch, F, timer, q, k, v, valid,
                      dict(scale=Dh ** -0.5))
             for valid in (torch.arange(W, device=DEVICE)[None, :]
                           < lens[:, None],
                           torch.ones((B, W), dtype=torch.bool,
                                      device=DEVICE))]
    rec = {"name": "gqa_decode", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/gqa_decode.cu",
           "replaces": "src/repro/kernels/gqa_decode.py:85", **cases[0],
           "full_ring": cases[1]}
    emit({"phase": "kernel_bf16", **rec})
    records.append(rec)
    rec["int8"] = gqa_int8_case(
        torch, F, timer, q, k, v,
        torch.arange(W, device=DEVICE)[None, :] < lens[:, None])

    # flash_prefill on the largest prompt bucket
    S = PROMPT_LENS[1]
    q, k, v = rn(1, S, H, Dh), rn(1, S, Hkv, Dh), rn(1, S, Hkv, Dh)
    got, want = flash_prefill(q, k, v), ref.flash_prefill_ref(q, k, v)
    err = max_err(got, want)
    require(close(got, want, BF16_OUT_TOL), f"flash_prefill bf16: {err}")
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    causal_pairs = S * (S + 1) // 2           # (query, key) pairs computed
    nbytes = 2 * (2 * S * H * Dh + 2 * S * Hkv * Dh)
    bms, by = bound(nbytes, 2 * causal_pairs * H * 2 * Dh)
    rec = {"name": "flash_prefill", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_prefill.cu",
           "replaces": "src/repro/kernels/flash_prefill.py:73",
           "shape": {"B": 1, "S": S, "H": H, "Hkv": Hkv, "D": Dh,
                     "dtype": "bf16"},
           "max_abs_err": err,
           "ms": timer(lambda: flash_prefill(q, k, v)),
           "plain_ms": timer(lambda: ref.flash_prefill_ref(q, k, v)),
           "bound_ms": bms, "bound_by": by,
           "library_ms": timer(sdpa_gqa(F, qt, kt, vt, H // Hkv,
                                        is_causal=True)),
           "library_call": "scaled_dot_product_attention, causal"}
    emit({"phase": "kernel_bf16", **rec})
    records.append(rec)
    records.append(kernel_paged(torch, F, timer, rn))
    kernel_deepseek(torch, F, timer, rn, records)
    records.append(kernel_mla(torch, timer, rn))
    records.append(kernel_families(torch, F, timer, rn, records))
    kernel_jamba(torch, F, timer, rn, records)
    kernel_encdec(torch, F, timer, rn, records)
    records.append(kernel_flash_bwd(torch, F, timer, rn))
    kernel_tp(torch, F, timer, rn, records)
    torch.cuda.empty_cache()
    records.append(kernel_expert_gather(torch, timer, rn))
    return records


def _family(arch):
    from repro_torch.configs import get_config
    return get_config(arch)


def window_pairs(S: int, window: int) -> int:
    """(query, key) pairs a causal prompt of S tokens computes under a
    sliding window (0: none)."""
    return sum(min(i + 1, window or i + 1) for i in range(S))


def kernel_families(torch, F, timer, rn, records):
    """The shapes gemma2, glm4 and moonshot give the kernels, each held
    against its plain version and timed beside its bound and one library
    call: flash_prefill's wide body at gemma2's prefill (D = Dv = 256, a
    window layer and a global one, softcap 50; its own record, returned),
    moe_ffn at moonshot's decode bucket (E 64, D 2048, F 1408) with every
    bucket full and as 8 routed rows fill it, gqa_decode at glm4's group
    of 16 and at gemma2's D 256 with softcap 50 over its global ring, and
    the fused paged_gqa_decode at gemma2's D 256 with softcap 50 over its
    arena.  The others join their kernel's record as "families"."""
    import numpy as np
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.moe_ffn import moe_ffn
    by_name = {r["name"]: r for r in records}
    fam = {name: by_name[name].setdefault("families", {}) for name in
           ("moe_ffn", "gqa_decode", "paged_gqa_decode")}
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 25)

    # flash_prefill at gemma2's prefill: a window layer (the record's
    # main case) and a global layer.  q is drawn with std 32, so that at
    # gemma2's query scale of 1/16 the scores spread with std 32 and 12 %
    # of them pass the cap of 50: the softcap's saturating region is
    # checked, and the same inputs without the softcap must give outputs
    # far outside the tolerance ("softcap_effect").  No single library
    # call computes the softcap: the yardstick is SDPA without it, the
    # window given as a boolean mask, the global layer as is_causal
    gem = _family("gemma2-2b")
    S, H, Hkv, D = GEMMA2_KERNEL_S, gem.num_heads, gem.num_kv_heads, \
        gem.head_dim
    q, k, v = rn(1, S, H, D, std=32.0), rn(1, S, Hkv, D), rn(1, S, Hkv, D)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    pos = torch.arange(S, device=DEVICE)
    cases = []
    for window in (gem.window_size, 0):
        kw = dict(window=window, attn_softcap=gem.attn_softcap,
                  scale=gem.query_scale)
        got, want = flash_prefill(q, k, v, **kw), \
            ref.flash_prefill_ref(q, k, v, **kw)
        err = max_err(got, want)
        require(close(got, want, BF16_OUT_TOL),
                f"flash_prefill bf16 D 256 window {window}: {err}")
        del want
        kw0 = {**kw, "attn_softcap": 0.0}
        got0, want0 = flash_prefill(q, k, v, **kw0), \
            ref.flash_prefill_ref(q, k, v, **kw0)
        err0 = max_err(got0, want0)
        require(close(got0, want0, BF16_OUT_TOL),
                f"flash_prefill bf16 D 256 window {window}, no softcap: "
                f"{err0}")
        effect = max_err(got, got0)
        require(effect > 50 * BF16_OUT_TOL,
                f"flash_prefill bf16 D 256 window {window}: the softcap "
                f"moves the output by only {effect}")
        del got, got0, want0
        if window:
            mask = ((pos[None, :] <= pos[:, None])
                    & (pos[None, :] > pos[:, None] - window))
            lib = dict(attn_mask=mask)
        else:
            lib = dict(is_causal=True)
        pairs = window_pairs(S, window)
        bms, by = bound(2 * (2 * S * H * D + 2 * S * Hkv * D),
                        2 * pairs * H * 2 * D)
        cases.append({
            "shape": {"B": 1, "S": S, "H": H, "Hkv": Hkv, "D": D, "Dv": D,
                      "window": window, "softcap": gem.attn_softcap,
                      "pairs": pairs, "dtype": "bf16", "q_std": 32.0},
            "max_abs_err": err, "max_abs_err_no_softcap": err0,
            "softcap_effect": effect,
            "ms": timer(lambda: flash_prefill(q, k, v, **kw)),
            "plain_ms": timer(lambda: ref.flash_prefill_ref(q, k, v, **kw),
                              3, 1),
            "bound_ms": bms, "bound_by": by,
            "library_ms": timer(sdpa_gqa(F, qt, kt, vt, H // Hkv,
                                         scale=gem.query_scale, **lib)),
            "library_call": "scaled_dot_product_attention, "
                            + ("the causal window as a boolean mask"
                               if window else "causal")
                            + ", without the softcap (no single call "
                            "computes it)"})
    wide = {"name": "flash_prefill_d256", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_prefill.cu",
            "replaces": "src/repro/kernels/flash_prefill.py:73",
            "model": gem.name, **cases[0], "global_layer": cases[1]}
    emit({"phase": "kernel_bf16", **wide})
    del q, k, v, qt, kt, vt

    # moe_ffn at moonshot's decode bucket (C 1): every bucket full, then
    # as 8 routed rows fill it (top-6 of 64)
    moon = _family("moonshot-v1-16b-a3b")
    E, D, Fd = moon.num_experts, moon.d_model, moon.d_ff
    B = SERVE_EXPERT["ubatch"]
    C = max(1, int(B * moon.top_k * moon.capacity_factor / E + 0.999))
    wi = rn(E, D, 2, Fd, std=D ** -0.5)
    wo = rn(E, Fd, D, std=Fd ** -0.5)
    wi3 = wi.view(E, D, 2 * Fd)
    x = rn(E, C, D)
    got, want = moe_ffn(x, wi, wo), ref.moe_ffn_ref(x, wi, wo)
    err = max_err(got, want)
    require(close(got, want, BF16_OUT_TOL), f"moe_ffn bf16 moonshot: {err}")
    del got, want

    def library():
        h = torch.bmm(x, wi3)
        return torch.bmm(F.silu(h[..., :Fd]) * h[..., Fd:], wo)
    bms, by = bound(2 * (2 * E * C * D + 3 * E * D * Fd), 6 * E * C * D * Fd)
    rec = {"shape": {"E": E, "C": C, "D": D, "F": Fd, "dtype": "bf16",
                     "at": "decode", "top_k": moon.top_k},
           "max_abs_err": err,
           "ms": timer(lambda: moe_ffn(x, wi, wo)),
           "plain_ms": timer(lambda: ref.moe_ffn_ref(x, wi, wo), 3, 1),
           "bound_ms": bms, "bound_by": by,
           "library_ms": timer(library),
           "library_call": "torch.bmm chain (up, silu * up, down)"}
    emit({"phase": "kernel_bf16", "name": "moe_ffn", "model": moon.name,
          **rec})
    rec["served_occupancy"] = moe_occupancy_case(torch, F, timer, rn, wi, wo,
                                                 moon, B, C)
    fam["moe_ffn"][moon.name] = rec
    del wi, wo, wi3, x

    # gqa_decode: glm4's group of 16 over serve's half-filled 512 ring,
    # and gemma2's D 256 with softcap 50 over its 5120 global ring as
    # serve_gemma2 fills it
    glm = _family("glm4-9b")
    for cfg, W, lo, hi in (
            (glm, SERVE["max_seq"], PROMPT_LENS[0],
             PROMPT_LENS[1] + NEW_TOKENS),
            (gem, GEMMA2_SERVE["max_seq"], GEMMA2_PROMPT_LENS[0],
             GEMMA2_PROMPT_LENS[1] + GEMMA2_NEW_TOKENS)):
        H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q, k, v = rn(B, H, D), rn(B, W, Hkv, D), rn(B, W, Hkv, D)
        lens = torch.randint(lo, hi, (B,), generator=g, device=DEVICE)
        valid = torch.arange(W, device=DEVICE)[None, :] < lens[:, None]
        rec = gqa_case(torch, F, timer, q, k, v, valid,
                       dict(scale=cfg.query_scale or D ** -0.5,
                            attn_softcap=cfg.attn_softcap))
        emit({"phase": "kernel_bf16", "name": "gqa_decode",
              "model": cfg.name, **rec})
        fam["gqa_decode"][cfg.name] = rec
        del q, k, v

    # the fused paged decode at gemma2's global layers over serve_gemma2's
    # arena (r_c 0.5 of 16 slots x 320 blocks of 16)
    rng = np.random.default_rng(SEED + 25)
    H, Hkv, D = gem.num_heads, gem.num_kv_heads, gem.head_dim
    bt = GEMMA2_PAGED["block_tokens"]
    MB = GEMMA2_PAGED["max_seq"] // bt
    NB = round(GEMMA2_PAGED["kv_gpu_ratio"] * GEMMA2_PAGED["ubatch"]
               * GEMMA2_PAGED["num_ubs"] * MB)
    lens = [int(n) for n in rng.integers(
        GEMMA2_PROMPT_LENS[0], GEMMA2_PROMPT_LENS[1] + GEMMA2_NEW_TOKENS, B)]
    q, cache, pos, new = paged_inputs(torch, rng, lens, H, Hkv, D, bt, MB,
                                      NB, 0.0, torch.bfloat16, rn)
    rec, _ = paged_case(torch, F, timer, q, cache, pos, new,
                        dict(scale=gem.query_scale,
                             attn_softcap=gem.attn_softcap))
    emit({"phase": "kernel_bf16", "name": "paged_gqa_decode",
          "model": gem.name, **rec})
    fam["paged_gqa_decode"][gem.name] = rec
    return wide


def int8_experts(torch, cfg, g):
    """One MoE layer of `cfg` with int8 experts, drawn on the card from
    `g`: wi (E, D, 2, F) and wo (E, F, D) by ``init_params``, and f32
    scales per expert around its std / 48, drawn at random so that a
    scale applied to the wrong expert shows."""
    from repro_torch.models.params import init_params, param_defs
    one = dataclasses.replace(cfg, num_layers=len(cfg.period),
                              expert_dtype="int8")
    key = next(f"p{i}" for i, s in enumerate(one.period) if s.moe)
    defs = param_defs(one)["blocks"][key]["moe"]
    w = init_params(one, g, DEVICE, defs={n: defs[n] for n in ("wi", "wo")})
    si, so = ((torch.rand(cfg.num_experts, generator=g, device=DEVICE) * 0.5
               + 0.75) * fan_in ** -0.5 / 48.0
              for fan_in in (cfg.d_model, cfg.d_ff))
    return w["wi"][0], w["wo"][0], si, so


def moe_subset_case(torch, F, timer, x, occ, held, wi, wo, si, so, label):
    """int8 moe_ffn over the whole (E, C, D) bucket buffer `x`, whose rows
    are nonzero in the experts `occ` only, held against its plain version
    on the experts `held` (a subset of `occ`) alone: the f32 plain version
    of all 16 of jamba's experts would take 38 GB, and each expert's
    output depends on its own rows and weights only, so the subset's
    check is exact.  The held experts' outputs within ``BF16_OUT_TOL``,
    every empty expert's exactly zero.  The bound counts the occupied
    experts' int8 weights and scales; the plain version (over the occupied
    experts, ``len(held)`` at a time) and the library call (the torch.bmm
    chain on the occupied experts' weights dequantized to bf16
    beforehand) compute the occupied experts only, which is all the
    function needs."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_ffn import moe_ffn
    E, C, D = x.shape
    Fd = wo.shape[1]
    sub = torch.tensor(held, device=DEVICE)
    got = moe_ffn(x, wi, wo, si, so)
    want = ref.moe_ffn_ref(*(t.index_select(0, sub)
                             for t in (x, wi, wo, si, so)))
    err = max_err(got.index_select(0, sub), want)
    require(close(got.index_select(0, sub), want, BF16_OUT_TOL),
            f"moe_ffn int8 jamba {label}: {err}")
    empty = torch.ones(E, dtype=torch.bool, device=DEVICE)
    empty[torch.tensor(occ, device=DEVICE)] = False
    require(bool((got[empty] == 0).all()),
            f"moe_ffn int8 jamba {label}: an empty expert gave output")
    del got, want
    sub = torch.tensor(occ, device=DEVICE)
    xs, wis, wos, sis, sos = (t.index_select(0, sub)
                              for t in (x, wi, wo, si, so))
    lwi = (wis.to(torch.bfloat16)
           * sis.to(torch.bfloat16)[:, None, None, None]).view(
               len(occ), D, 2 * Fd)
    lwo = wos.to(torch.bfloat16) * sos.to(torch.bfloat16)[:, None, None]
    parts = [slice(i, i + len(held)) for i in range(0, len(occ), len(held))]

    def plain():
        return [ref.moe_ffn_ref(xs[p], wis[p], wos[p], sis[p], sos[p])
                for p in parts]

    def library():
        h = torch.bmm(xs, lwi)
        return torch.bmm(F.silu(h[..., :Fd]) * h[..., Fd:], lwo)
    n = len(occ)
    bms, by = bound(2 * 2 * E * C * D + 3 * n * D * Fd + 8 * n,
                    6 * n * C * D * Fd)
    rec = {"shape": {"E": E, "C": C, "D": D, "F": Fd, "dtype": "bf16",
                     "weights": "int8", "at": label,
                     "occupied_experts": n},
           "max_abs_err": err, "held_experts": len(held),
           "empty_experts_exact_zero": bool(empty.any()),
           "ms": timer(lambda: moe_ffn(x, wi, wo, si, so), 5, 1),
           "plain_ms": timer(plain, 3, 1),
           "plain_on": f"the occupied experts, {len(held)} a call",
           "bound_ms": bms, "bound_by": by,
           "library_ms": timer(library, 5, 1),
           "library_call": "torch.bmm chain (up, silu * up, down) on the "
                           "occupied experts' weights dequantized to bf16 "
                           "beforehand"}
    emit({"phase": "kernel_int8", "name": "moe_ffn", "model": JAMBA_ARCH,
          **rec})
    return rec


def kernel_jamba(torch, F, timer, rn, records):
    """The shapes jamba-1.5-large gives four of the kernels, each held
    against its plain version and timed beside its bound and one library
    call, as sub-records "families" of their kernel's record: moe_ffn with
    int8 experts at E 16, D 8192, F 24576 (decode buckets of C 1, 2 and 3,
    2 to 4 experts occupied, held on all of them; and the prefill bucket
    of a 256-token prompt, whose 512 routed rows occupy all 16 experts,
    held on 4), flash_prefill at H 64 / Hkv 8, D 128 over a 384-token
    prompt, gqa_decode at its group of 8 over ``JAMBA_SERVE``'s ring, and
    the fused paged_gqa_decode at G 8 over an arena of r_c 0.5."""
    import numpy as np
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import flash_prefill
    by_name = {r["name"]: r for r in records}
    fam = {name: by_name[name].setdefault("families", {}) for name in
           ("moe_ffn", "flash_prefill", "gqa_decode", "paged_gqa_decode")}
    cfg = _family(JAMBA_ARCH)
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 26)
    E, D = cfg.num_experts, cfg.d_model
    wi, wo, si, so = int8_experts(torch, cfg, g)
    cases = []
    prefill_c = max(1, int(JAMBA_PROMPT_LENS[1] * cfg.top_k
                           * cfg.capacity_factor / E + 0.999))
    for C, label, n_occ, n_held in ((1, "decode", 2, 2), (2, "decode", 4, 4),
                                    (3, "decode", 4, 4),
                                    (prefill_c, "prefill", E, 4)):
        perm = torch.randperm(E, generator=g, device=DEVICE).tolist()
        occ = sorted(perm[:n_occ])
        x = torch.zeros((E, C, D), dtype=torch.bfloat16, device=DEVICE)
        x[occ] = rn(n_occ, C, D)
        cases.append(moe_subset_case(torch, F, timer, x, occ,
                                     sorted(perm[:n_held]), wi, wo, si, so,
                                     label))
    fam["moe_ffn"][JAMBA_ARCH] = {**cases[0], "cases": cases[1:]}
    del wi, wo, x
    torch.cuda.empty_cache()

    # flash_prefill at jamba's attention layer (no positional encoding,
    # full causal), the largest serve_jamba prompt bucket rounded up
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    S = JAMBA_KERNEL_S
    q, k, v = rn(1, S, H, Dh), rn(1, S, Hkv, Dh), rn(1, S, Hkv, Dh)
    got, want = flash_prefill(q, k, v), ref.flash_prefill_ref(q, k, v)
    err = max_err(got, want)
    require(close(got, want, BF16_OUT_TOL),
            f"flash_prefill bf16 jamba: {err}")
    del got, want
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    pairs = S * (S + 1) // 2
    bms, by = bound(2 * (2 * S * H * Dh + 2 * S * Hkv * Dh),
                    2 * pairs * H * 2 * Dh)
    rec = {"shape": {"B": 1, "S": S, "H": H, "Hkv": Hkv, "D": Dh,
                     "dtype": "bf16"},
           "max_abs_err": err,
           "ms": timer(lambda: flash_prefill(q, k, v)),
           "plain_ms": timer(lambda: ref.flash_prefill_ref(q, k, v)),
           "bound_ms": bms, "bound_by": by,
           "library_ms": timer(sdpa_gqa(F, qt, kt, vt, H // Hkv,
                                        is_causal=True)),
           "library_call": "scaled_dot_product_attention, causal"}
    emit({"phase": "kernel_bf16", "name": "flash_prefill",
          "model": JAMBA_ARCH, **rec})
    fam["flash_prefill"][JAMBA_ARCH] = rec
    del q, k, v, qt, kt, vt

    # gqa_decode at G 8 over the ring as serve_jamba fills it
    B, W = JAMBA_SERVE["ubatch"], JAMBA_SERVE["max_seq"]
    q, k, v = rn(B, H, Dh), rn(B, W, Hkv, Dh), rn(B, W, Hkv, Dh)
    lens = torch.randint(JAMBA_PROMPT_LENS[0],
                         JAMBA_PROMPT_LENS[1] + JAMBA_NEW_TOKENS, (B,),
                         generator=g, device=DEVICE)
    valid = torch.arange(W, device=DEVICE)[None, :] < lens[:, None]
    rec = gqa_case(torch, F, timer, q, k, v, valid, dict(scale=Dh ** -0.5))
    emit({"phase": "kernel_bf16", "name": "gqa_decode", "model": JAMBA_ARCH,
          **rec})
    fam["gqa_decode"][JAMBA_ARCH] = rec
    del q, k, v

    # the fused paged decode at G 8 over serve_jamba_expert's arena
    rng = np.random.default_rng(SEED + 26)
    bt = JAMBA_EXPERT["block_tokens"]
    MB = JAMBA_EXPERT["max_seq"] // bt
    NB = round(JAMBA_EXPERT["kv_gpu_ratio"] * JAMBA_EXPERT["ubatch"]
               * JAMBA_EXPERT["num_ubs"] * MB)
    lens = [int(n) for n in rng.integers(
        JAMBA_PROMPT_LENS[0], JAMBA_PROMPT_LENS[1] + JAMBA_NEW_TOKENS, B)]
    q, cache, pos, new = paged_inputs(torch, rng, lens, H, Hkv, Dh, bt, MB,
                                      NB, 0.0, torch.bfloat16, rn)
    rec, _ = paged_case(torch, F, timer, q, cache, pos, new,
                        dict(scale=Dh ** -0.5))
    emit({"phase": "kernel_bf16", "name": "paged_gqa_decode",
          "model": JAMBA_ARCH, **rec})
    fam["paged_gqa_decode"][JAMBA_ARCH] = rec


def attention_case(torch, F, timer, q, k, v, causal: bool, scale: float):
    """flash_prefill on one bf16 shape against its plain version (within
    ``BF16_OUT_TOL``), and on the same inputs in f32 (within ``F32_TOL``),
    timed beside its bound and SDPA (non-causal, or causal: the library
    call computes the same function).  Non-causal, every query sees every
    key; causal, the prompt's own pairs."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import flash_prefill
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    kw = dict(causal=causal, scale=scale)
    got, want = flash_prefill(q, k, v, **kw), \
        ref.flash_prefill_ref(q, k, v, **kw)
    err = max_err(got, want)
    require(close(got, want, BF16_OUT_TOL),
            f"flash_prefill bf16 (S {S}, Skv {Skv}, H {H} / {Hkv}, D {D}, "
            f"causal {causal}): {err}")
    qf, kf, vf = q.float(), k.float(), v.float()
    got32, want32 = flash_prefill(qf, kf, vf, **kw), \
        ref.flash_prefill_ref(qf, kf, vf, **kw)
    err32 = max_err(got32, want32)
    require(close(got32, want32, F32_TOL),
            f"flash_prefill f32 (S {S}, Skv {Skv}, H {H} / {Hkv}, D {D}, "
            f"causal {causal}): {err32}")
    del got, want, got32, want32, qf, kf, vf
    pairs = B * (S * (S + 1) // 2 if causal else S * Skv)
    bms, by = bound(2 * (2 * B * S * H * D + 2 * B * Skv * Hkv * D),
                    2 * pairs * H * 2 * D)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return {
        "shape": {"B": B, "S": S, "Skv": Skv, "H": H, "Hkv": Hkv, "D": D,
                  "causal": causal, "pairs": pairs, "dtype": "bf16"},
        "max_abs_err": err, "max_abs_err_f32": err32, "tol_f32": F32_TOL,
        "ms": timer(lambda: flash_prefill(q, k, v, **kw)),
        "plain_ms": timer(lambda: ref.flash_prefill_ref(q, k, v, **kw)),
        "bound_ms": bms, "bound_by": by,
        "library_ms": timer(sdpa_gqa(F, qt, kt, vt, H // Hkv, scale=scale,
                                     is_causal=causal)),
        "library_call": "scaled_dot_product_attention, "
                        + ("causal" if causal else "non-causal")}


def kernel_encdec(torch, F, timer, rn, records):
    """The shapes whisper-small and paligemma-3b give two kernels, each
    held against its plain version in bf16 and f32 and timed beside its
    bound and one library call, as sub-records "families" of their
    kernel's record: flash_prefill's non-causal form at whisper's encoder
    (8 x 1500 frames, H 12, D 64) and at its cross-attention (S 64, and
    the decode form S 1, over the 1500 encoder keys); the causal wide (D
    256) body at paligemma's prefix prefill (256 patches + 128 text
    tokens, H 8 over one KV head); gqa_decode at whisper's G 1, D 64 and
    paligemma's G 8, D 256 over the rings their serve phases fill."""
    by_name = {r["name"]: r for r in records}
    fam = {name: by_name[name].setdefault("families", {}) for name in
           ("flash_prefill", "flash_prefill_d256", "gqa_decode")}
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 27)
    wh = _family(WHISPER_ARCH)
    B, Se, H, D = WHISPER_REQUESTS, wh.encoder_seq, wh.num_heads, wh.head_dim
    Hkv = wh.num_kv_heads
    k, v = rn(B, Se, Hkv, D), rn(B, Se, Hkv, D)
    cases = {}
    for label, S in (("encoder", Se), ("cross", WHISPER_PROMPT_LENS[1]),
                     ("cross_decode", 1)):
        q = rn(B, S, H, D)
        cases[label] = attention_case(torch, F, timer, q, k, v, False,
                                      D ** -0.5)
        emit({"phase": "kernel_bf16", "name": "flash_prefill",
              "model": WHISPER_ARCH, "at": label, **cases[label]})
        del q
    fam["flash_prefill"][WHISPER_ARCH] = {
        **cases["encoder"], "cross": cases["cross"],
        "cross_decode": cases["cross_decode"]}
    del k, v

    pg = _family(PALIGEMMA_ARCH)
    S = pg.vision_tokens + PALIGEMMA_TEXT_LENS[1]
    H, Hkv, D = pg.num_heads, pg.num_kv_heads, pg.head_dim
    q, k, v = rn(1, S, H, D), rn(1, S, Hkv, D), rn(1, S, Hkv, D)
    rec = attention_case(torch, F, timer, q, k, v, True, pg.query_scale)
    emit({"phase": "kernel_bf16", "name": "flash_prefill_d256",
          "model": PALIGEMMA_ARCH, **rec})
    fam["flash_prefill_d256"][PALIGEMMA_ARCH] = rec
    del q, k, v

    for arch, cfg, B, W, lo, hi in (
            (WHISPER_ARCH, wh, WHISPER_REQUESTS, WHISPER_MAX_SEQ,
             WHISPER_PROMPT_LENS[0] + 1,
             WHISPER_PROMPT_LENS[1] + WHISPER_NEW_TOKENS),
            (PALIGEMMA_ARCH, pg, PALIGEMMA_REQUESTS, PALIGEMMA_MAX_SEQ,
             pg.vision_tokens + PALIGEMMA_TEXT_LENS[0] + 1,
             pg.vision_tokens + PALIGEMMA_TEXT_LENS[1]
             + PALIGEMMA_NEW_TOKENS)):
        H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q, k, v = rn(B, H, D), rn(B, W, Hkv, D), rn(B, W, Hkv, D)
        lens = torch.randint(lo, hi, (B,), generator=g, device=DEVICE)
        valid = torch.arange(W, device=DEVICE)[None, :] < lens[:, None]
        kw = dict(scale=cfg.query_scale or D ** -0.5)
        rec = gqa_case(torch, F, timer, q, k, v, valid, kw)
        rec["f32"] = gqa_f32_case(torch, q, k, v, valid, kw)
        emit({"phase": "kernel_bf16", "name": "gqa_decode", "model": arch,
              **rec})
        fam["gqa_decode"][arch] = rec
        del q, k, v


def bwd_case(torch, F, timer, rn, B, S, Skv, H, Hkv, D, Dv, *, kv_len=None,
             causal=True, window=0, cap=0.0, scale=None, q_std=1.0):
    """flash_prefill's gradients through the kernels (``ops.flash_prefill``
    under autograd: the forward kernel with the rows' log-sum-exp, then
    ``flash_prefill_bwd``) against autograd of the plain version on the
    same inputs, in f32 and bf16 (``BWD_TOL`` of each gradient's max-abs);
    the backward kernel timed in bf16 beside its bound, the plain
    version's backward (autograd through ``flash_prefill_ref``) and the
    backward of one scaled_dot_product_attention call."""
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import ops, ref
    kw = dict(causal=causal, window=window, attn_softcap=cap, scale=scale)
    q, k = rn(B, S, H, D, std=q_std), rn(B, Skv, Hkv, D)
    v, do = rn(B, Skv, Hkv, Dv), rn(B, S, H, Dv)
    errs = {}
    for name, tol in BWD_TOL.items():
        dt = getattr(torch, name)
        args, g = [t.to(dt) for t in (q, k, v)], do.to(dt)
        grads = {}
        for impl in ("auto", "ref"):
            xs = [a.clone().requires_grad_(True) for a in args]
            o = ops.flash_prefill(*xs, kv_len, impl=impl, **kw)
            grads[impl] = torch.autograd.grad(o, xs, g)
            del o, xs
        errs[name] = max(
            max_err(a, b) / max(float(b.float().abs().max()), 1e-30)
            for a, b in zip(grads["auto"], grads["ref"]))
        require(all(a.dtype == dt for a in grads["auto"]),
                "flash_prefill_bwd: a gradient left in another dtype")
        require(errs[name] <= tol,
                f"flash_prefill_bwd {name} (S {S}, Skv {Skv}, H {H} / "
                f"{Hkv}, D {D} / {Dv}): {errs[name]} of max-abs")
        del grads, args, g
    qp = torch.arange(S, device=DEVICE)[:, None]
    kp = torch.arange(Skv, device=DEVICE)[None, :]
    lens = (torch.full((B,), Skv, device=DEVICE) if kv_len is None
            else kv_len)
    mask = (kp[None] < lens[:, None, None]).expand(B, S, Skv)
    if causal:
        cm = kp <= qp
        if window:
            cm = cm & (kp > qp - window)
        mask = mask & cm[None]
    pairs = int(mask.sum())                  # this run's (query, key) pairs
    nbytes = 2 * (2 * (B * S * H * D + B * Skv * Hkv * (D + Dv))
                  + 2 * B * S * H * Dv) + 4 * B * H * S + 4 * B
    bms, by = bound(nbytes, 2 * pairs * H * (3 * D + 2 * Dv))
    o, lse = fp._forward(q, k, v, kv_len, causal, window, cap, scale,
                         with_lse=True)
    xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o_ref = ref.flash_prefill_ref(*xs, kv_len, **kw)
    lx = [t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v)]
    skw = {"scale": scale if scale is not None else D ** -0.5}
    if kv_len is not None or window:
        skw["attn_mask"] = mask[:, None]
    else:
        skw["is_causal"] = causal
    lo = sdpa_gqa(F, *lx, H // Hkv, **skw)()
    ldo = do.transpose(1, 2)
    rec = {"shape": {"B": B, "S": S, "Skv": Skv, "H": H, "Hkv": Hkv, "D": D,
                     "Dv": Dv, "causal": causal, "window": window,
                     "softcap": cap, "kv_len": None if kv_len is None
                     else kv_len.tolist(), "pairs": pairs, "dtype": "bf16"},
           "max_abs_err": errs["bfloat16"], "max_abs_err_f32": errs[
               "float32"], "err_of": "max |kernel - plain| / max |plain|, "
                                     "over dq, dk, dv",
           "ms": timer(lambda: fp.flash_prefill_bwd(q, k, v, o, lse, do,
                                                    kv_len, **kw)),
           "plain_ms": timer(lambda: torch.autograd.grad(
               o_ref, xs, do, retain_graph=True), 3, 1),
           "bound_ms": bms, "bound_by": by,
           "library_ms": timer(lambda: torch.autograd.grad(
               lo, lx, ldo, retain_graph=True)),
           "library_call": "autograd backward of scaled_dot_product_attention"
                           + (", masked" if "attn_mask" in skw else "")
                           + (", without the softcap" if cap else "")}
    del o, lse, o_ref, lo, xs, lx
    return rec


def bwd_rows_without_a_key(torch, rn) -> dict:
    """A prompt whose query rows 68 and 69 (batch 0) see no valid key: S
    70, window 9, kv_len (60, 70), H 4 / 2, D 16.  The kernels give such
    a row 0 and lse -inf, so it sends no gradient back; the plain version
    (a finite mask) averages every key of the row.  Required: the
    kernels' gradients equal the plain version's with those rows' output
    gradient zeroed (``BWD_TOL``) and no dk or dv past kv_len.  Recorded:
    how far the plain version's own gradients are from the kernels'."""
    from repro_torch.kernels import ops
    B, S, H, Hkv, D, window = 2, 70, 4, 2, 16, 9
    lens = torch.tensor([60, 70], dtype=torch.int32, device=DEVICE)
    i = torch.arange(S, device=DEVICE)[None, :]
    has = (i - window + 1).clamp(min=0) < lens[:, None]        # (B, S)
    past = i >= lens[:, None]                          # keys past kv_len
    q, k, v, do = rn(B, S, H, D), rn(B, S, Hkv, D), rn(B, S, Hkv, D), \
        rn(B, S, H, D)
    out = {"shape": {"B": B, "S": S, "H": H, "Hkv": Hkv, "D": D,
                     "window": window, "kv_len": lens.tolist()},
           "rows_without_a_key": int((~has).sum())}
    for name, tol in BWD_TOL.items():
        dt = getattr(torch, name)
        args, g = [t.to(dt) for t in (q, k, v)], do.to(dt)
        grads = {}
        for impl, gg in (("auto", g), ("ref", g),
                         ("ref_kept", g * has[:, :, None, None].to(dt))):
            xs = [a.clone().requires_grad_(True) for a in args]
            o = ops.flash_prefill(*xs, lens, window=window,
                                  impl="auto" if impl == "auto" else "ref")
            grads[impl] = torch.autograd.grad(o, xs, gg)
        rel = {key: [max_err(a, b) / max(float(b.float().abs().max()), 1e-30)
                     for a, b in zip(grads["auto"], grads[key])]
               for key in ("ref", "ref_kept")}
        out[name] = {"err_vs_plain_rows_zeroed": max(rel["ref_kept"]),
                     "dq_dk_dv_err_vs_plain": rel["ref"]}
        require(max(rel["ref_kept"]) <= tol,
                f"flash_prefill_bwd {name}, rows without a key: "
                f"{rel['ref_kept']} of max-abs")
        require(not grads["auto"][0][~has].any()
                and not grads["auto"][1][past].any()
                and not grads["auto"][2][past].any(),
                f"flash_prefill_bwd {name}: a row without a key sent "
                f"a gradient back")
    return out


def kernel_flash_bwd(torch, F, timer, rn):
    """The backward kernel's record: mixtral's training shape (B 4, S 256,
    H 32 / 8, D 128, causal), and sub-records "train_shapes" at DeepSeek's
    MLA heads (H 128, D 192 / Dv 128), whisper's cross-attention (S 256
    over its 1500 encoder positions, kv_len 3/4 and 1/2 of them on two
    rows) and gemma2's
    heads (H 8 / 4, D 256, a window of ``GEMMA2_BWD_WINDOW`` and its
    softcap of 50, q drawn with std 32 so that the cap saturates)."""
    cfg = _mixtral()
    rec = {"name": "flash_prefill_bwd", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_prefill_bwd.cu",
           "replaces": "src/repro/models/common.py:113",
           **bwd_case(torch, F, timer, rn, TRAIN_B, TRAIN_S, TRAIN_S,
                      cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                      cfg.head_dim)}
    emit({"phase": "kernel_flash_bwd", "model": "mixtral-8x7b", **rec})
    ds = _deepseek()
    wh, gm = _family(WHISPER_ARCH), _family("gemma2-2b")
    Se = wh.encoder_seq           # rows of all, 3/4 and 1/2 the frames
    lens = torch.tensor([Se - Se // 4 * (i % 3) for i in range(TRAIN_B)],
                        dtype=torch.int32, device=DEVICE)
    cases = {
        "deepseek-v3-671b": dict(
            B=TRAIN_B, S=TRAIN_S, Skv=TRAIN_S, H=ds.num_heads,
            Hkv=ds.num_heads, D=ds.qk_nope_head_dim + ds.qk_rope_head_dim,
            Dv=ds.v_head_dim),
        WHISPER_ARCH: dict(
            B=TRAIN_B, S=TRAIN_S, Skv=wh.encoder_seq, H=wh.num_heads,
            Hkv=wh.num_kv_heads, D=wh.head_dim, Dv=wh.head_dim,
            kv_len=lens, causal=False),
        "gemma2-2b": dict(
            B=TRAIN_B, S=TRAIN_S, Skv=TRAIN_S, H=gm.num_heads,
            Hkv=gm.num_kv_heads, D=gm.head_dim, Dv=gm.head_dim,
            window=GEMMA2_BWD_WINDOW, cap=gm.attn_softcap,
            scale=gm.query_scale, q_std=32.0)}
    rec["train_shapes"] = {}
    for model, kw in cases.items():
        sub = bwd_case(torch, F, timer, rn, **kw)
        emit({"phase": "kernel_flash_bwd", "model": model, **sub})
        rec["train_shapes"][model] = sub
    rec["rows_without_a_key"] = bwd_rows_without_a_key(torch, rn)
    emit({"phase": "kernel_flash_bwd", "case": "rows_without_a_key",
          **rec["rows_without_a_key"]})
    torch.cuda.empty_cache()
    return rec


def phase_train_check(torch, np, ops):
    """mixtral-8x7b at full width, ``TRAIN_CHECK_LAYERS`` of its 32 layers,
    float32 (TF32 off), random weights from a seed: one step's loss and
    every gradient leaf through the kernels (``impl="auto"``: the forward
    and backward attention kernels) and through the plain path
    (``impl="ref"``), within ``GRAD_TOL`` of each leaf's max-abs; no leaf
    may lack a gradient; the batch is the port's DataPipeline's first.
    Returns the kernel path's launches."""
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.models.model import ExecPolicy
    from repro_torch.models.params import init_params
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_step import (make_loss_fn, requires_grad_,
                                                 value_and_grad)
    L = TRAIN_CHECK_LAYERS
    cfg = dataclasses.replace(_mixtral(), num_layers=L, dtype="float32")
    params = requires_grad_(init_params(cfg, torch.Generator(
        device=DEVICE).manual_seed(SEED + 30), device=DEVICE))
    n_params = sum(p.numel() for p in tree_leaves(params))
    pipe = DataPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                                   batch_size=TRAIN_B, seed=SEED))
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in next(pipe).items()}
    pipe.close()
    res = {}
    for impl in ("auto", "ref"):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        loss, metrics, grads = value_and_grad(
            make_loss_fn(cfg, ExecPolicy(impl=impl)), params, batch)
        torch.cuda.synchronize()
        res[impl] = (float(loss), metrics, tree_leaves(grads),
                     ops.launch_counts())
    (loss_k, m_k, g_k, launches), (loss_p, m_p, g_p, plain_launches) = \
        res["auto"], res["ref"]
    missing = sum(g is None for g in g_k + g_p)
    worst = max(max_err(a, b) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(g_k, g_p) if a is not None and b is not None)
    expected = {"flash_prefill": L, "flash_prefill_bwd": L}
    emit({"phase": "train_check", "layers": L, "params": n_params,
          "dtype": "float32", "batch": [TRAIN_B, TRAIN_S],
          "loss": [loss_k, loss_p],
          "aux_loss": [float(m_k["aux_loss"]), float(m_p["aux_loss"])],
          "leaves": len(g_k), "missing_grads": missing,
          "max_grad_err_of_max_abs": worst, "tol": GRAD_TOL,
          "launches": launches, "plain_launches": plain_launches,
          "expected_launches": expected})
    require(missing == 0, f"train_check: {missing} leaves without a gradient")
    require(worst <= GRAD_TOL, f"train_check: gradients differ by {worst}")
    require(abs(loss_k - loss_p) <= GRAD_TOL * abs(loss_p),
            f"train_check: loss {loss_k} vs {loss_p}")
    require(all(launches[k] == n for k, n in expected.items()),
            f"train_check: launches {launches}, expected {expected}")
    require(not any(plain_launches.values()),
            f"train_check: the plain path launched {plain_launches}")
    del params, batch, res, g_k, g_p
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def nccl_group(torch):
    """Initialize a process group of one rank over nccl, its rendezvous an
    in-memory store (no environment variable set, no port opened), and
    check it with one all-reduce.  A failed initialization fails the run:
    there is no fallback to gloo on the card."""
    import torch.distributed as dist
    require(dist.is_nccl_available(), "this PyTorch has no nccl")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    t = torch.full((1,), 3.0, device=DEVICE)
    dist.all_reduce(t)
    torch.cuda.synchronize()
    require(dist.get_backend() == "nccl" and float(t) == 3.0,
            f"the nccl group: backend {dist.get_backend()}, sum {float(t)}")
    return dist


def phase_train_plan(torch, np, ops):
    """mixtral-8x7b at full width, ``TRAIN_CHECK_LAYERS`` of 32 layers in
    f32, under the train plan of a ("model",) mesh of one rank on an nccl
    group: the expert-parallel all-to-all body (``ep_a2a``, at
    ``TRAIN_PLAN_CF``) with ``remat``.  One step's loss and gradients
    against ``train_check``'s step without a plan (the dense MoE) on the
    same weights and batch: the loss within ``PLAN_LOSS_TOL`` relative,
    every gradient within ``PLAN_GRAD_TOL`` of its leaf's max-abs; the
    same step with remat off; each one's peak device memory above the
    weights and its seconds.  Under remat the attention's forward kernel
    runs twice a layer (the forward, and its recomputation in the
    backward).  Returns the plan step's launches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import ExecPolicy
    from repro_torch.models.params import init_params
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_step import (make_loss_fn, requires_grad_,
                                                 value_and_grad)
    dist = nccl_group(torch)
    L = TRAIN_CHECK_LAYERS
    cfg = dataclasses.replace(_mixtral(), num_layers=L, dtype="float32",
                              capacity_factor=TRAIN_PLAN_CF)
    params = requires_grad_(init_params(cfg, torch.Generator(
        device=DEVICE).manual_seed(SEED + 30), device=DEVICE))
    pipe = DataPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                                   batch_size=TRAIN_B, seed=SEED))
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in next(pipe).items()}
    pipe.close()
    mesh = make_mesh((1,), ("model",))
    shape = ShapeConfig("train_plan", TRAIN_S, TRAIN_B, "train")
    plan = SH.make_plan(cfg, shape, mesh)
    policies = {"plan": plan.policy,
                "plan_no_remat": SH.make_plan(cfg, shape, mesh,
                                              remat=False).policy,
                "no_plan": ExecPolicy()}
    res = {}
    for name, policy in policies.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        loss, metrics, grads = value_and_grad(make_loss_fn(cfg, policy),
                                              params, batch)
        torch.cuda.synchronize()
        res[name] = {"loss": float(loss), "aux_loss": float(
            metrics["aux_loss"]), "grads": tree_leaves(grads),
            "launches": ops.launch_counts(), "seconds":
            time.perf_counter() - t0, "peak_above_weights":
            torch.cuda.max_memory_allocated() - held}
        del grads
    want, got = res["no_plan"], res["plan"]
    missing = sum(g is None for r in res.values() for g in r["grads"])
    worst = max(max_err(a, b) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(got["grads"], want["grads"]))
    remat_err = max(max_err(a, b) for a, b in
                    zip(got["grads"], res["plan_no_remat"]["grads"]))
    loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    expected = {"plan": {"flash_prefill": 2 * L, "flash_prefill_bwd": L},
                "plan_no_remat": {"flash_prefill": L,
                                  "flash_prefill_bwd": L}}
    emit({"phase": "train_plan", "layers": L, "dtype": "float32",
          "batch": [TRAIN_B, TRAIN_S], "mesh": mesh.shape,
          "backend": dist.get_backend(), "moe_variant": plan.moe_variant,
          "remat": plan.policy.remat, "capacity_factor": TRAIN_PLAN_CF,
          **{f"{k}_{n}": r[k] for n, r in res.items()
             for k in ("loss", "aux_loss", "seconds", "launches",
                       "peak_above_weights")},
          "loss_rel_err": loss_rel, "loss_tol": PLAN_LOSS_TOL,
          "max_grad_err_of_max_abs": worst, "grad_tol": PLAN_GRAD_TOL,
          "max_grad_err_remat_vs_not": remat_err, "missing_grads": missing,
          "expected_launches": expected, "card": card_line()})
    require(plan.moe_variant == "ep_a2a" and plan.policy.remat,
            f"train_plan: variant {plan.moe_variant}")
    require(missing == 0, f"train_plan: {missing} leaves without a gradient")
    require(loss_rel <= PLAN_LOSS_TOL,
            f"train_plan: loss {got['loss']} vs {want['loss']}")
    require(worst <= PLAN_GRAD_TOL, f"train_plan: gradients differ by {worst}")
    for name, exp in expected.items():
        require(all(res[name]["launches"][k] == n for k, n in exp.items()),
                f"train_plan: {name} launched {res[name]['launches']}, "
                f"expected {exp}")
    launches = got["launches"]
    del params, batch, res, got, want
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def kernel_tp(torch, F, timer, rn, records):
    """The shapes a plan over ``TP_WORLD`` ranks gives mixtral-8x7b's
    kernels (sub-records "tp" of their records): moe_ffn with the rank's 4
    of 8 experts at serve_tp's decode bucket (C 16: 8 tokens, top-2,
    capacity 8.0), gqa_decode over a rank's 256 of 512 ring slots (128
    valid) with every head, flash_prefill on the rank's 16 of 32 query
    heads and 4 of 8 KV heads at serve_tp's prefill (B 8, S 127) and
    train_tp's (B 4, S 256), and flash_prefill_bwd at train_tp's; each
    held against its plain version and timed beside its bound and one
    library call."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_ffn import moe_ffn
    cfg = _mixtral()
    E, D, Fd = cfg.num_experts // TP_WORLD, cfg.d_model, cfg.d_ff
    H, Hkv, Dh = (cfg.num_heads // TP_WORLD, cfg.num_kv_heads // TP_WORLD,
                  cfg.head_dim)
    by_name = {r["name"]: r for r in records}
    C = max(1, int(PLAN_B * cfg.top_k * PLAN_CF / cfg.num_experts + 0.999))
    wi, wo = rn(E, D, 2, Fd, std=D ** -0.5), rn(E, Fd, D, std=Fd ** -0.5)
    # the rank's buckets of a step whose 8 tokens route over all 8 experts
    x = routed_xbuf(torch, rn, cfg.num_experts, C, D, cfg.top_k,
                    PLAN_B)[0][:E].contiguous()
    occ = int(x.ne(0).any(-1).any(-1).sum())
    got, want = moe_ffn(x, wi, wo), ref.moe_ffn_ref(x, wi, wo)
    err = max_err(got, want)
    require(close(got, want, BF16_OUT_TOL), f"moe_ffn bf16 tp: {err}")
    wi3 = wi.view(E, D, 2 * Fd)

    def library():
        h = torch.bmm(x, wi3)
        return torch.bmm(F.silu(h[..., :Fd]) * h[..., Fd:], wo)
    # the occupied experts' weights: the kernel skips the empty ones' rows
    bms, by = bound(2 * (2 * E * C * D + 3 * occ * D * Fd),
                    6 * occ * C * D * Fd)
    by_name["moe_ffn"]["tp"] = [{
        "shape": {"E": E, "C": C, "D": D, "F": Fd, "dtype": "bf16",
                  "occupied_experts": occ,
                  "at": "serve_tp decode, a rank's experts"},
        "max_abs_err": err, "ms": timer(lambda: moe_ffn(x, wi, wo)),
        "plain_ms": timer(lambda: ref.moe_ffn_ref(x, wi, wo), 3, 1),
        "bound_ms": bms, "bound_by": by, "library_ms": timer(library),
        "library_call": "torch.bmm chain (up, silu * up, down)"}]
    del wi, wo, x, wi3, got, want
    W = PLAN_SLOTS // TP_WORLD
    q, k, v = (rn(PLAN_B, cfg.num_heads, Dh), rn(PLAN_B, W, cfg.num_kv_heads,
               Dh), rn(PLAN_B, W, cfg.num_kv_heads, Dh))
    # rank 0's block mid-serve: the prompt's slots of its half (rank 1's
    # block holds no position at serve_tp's depth)
    valid = (torch.arange(W, device=DEVICE)[None, :]
             < PLAN_PROMPT).expand(PLAN_B, W).contiguous()
    by_name["gqa_decode"]["tp"] = [gqa_case(torch, F, timer, q, k, v, valid,
                                            dict(scale=Dh ** -0.5))]
    by_name["flash_prefill"]["tp"] = [
        attention_case(torch, F, timer, rn(B, S, H, Dh), rn(B, S, Hkv, Dh),
                       rn(B, S, Hkv, Dh), True, Dh ** -0.5)
        for B, S in ((PLAN_B, PLAN_PROMPT - 1), (TRAIN_B, TRAIN_S))]
    by_name["flash_prefill_bwd"]["tp"] = [bwd_case(
        torch, F, timer, rn, TRAIN_B, TRAIN_S, TRAIN_S, H, Hkv, Dh, Dh)]
    for name in ("moe_ffn", "gqa_decode", "flash_prefill",
                 "flash_prefill_bwd"):
        for sub in by_name[name]["tp"]:
            emit({"phase": "kernel_tp", "name": name, **sub})


def tp_rank_train(torch, ops, mesh) -> dict:
    """train_tp on this rank: mixtral-8x7b at full width, 1 of its 32
    layers in f32, ``train_check``'s weights and batch.  First the one-rank
    step on the whole weights (no plan: the dense MoE), whose gradients'
    blocks under the plan this rank keeps; then one step of the ("model",)
    train plan (``ep_a2a`` at ``TRAIN_PLAN_CF``, remat) on this rank's
    slices: loss, each gradient's distance from its block (of the whole
    leaf's max-abs), the global grad norm against the one-rank one, then
    AdamW on the slices; seconds and launches of the plan's step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.distributed import sharding as SH
    from repro_torch.models.model import ExecPolicy
    from repro_torch.models.params import init_params
    from repro_torch.training import optimizer as t_opt
    from repro_torch.training.train_step import (make_loss_fn, requires_grad_,
                                                 value_and_grad)
    cfg = dataclasses.replace(_mixtral(), num_layers=TRAIN_CHECK_LAYERS,
                              dtype="float32", capacity_factor=TRAIN_PLAN_CF)
    params = requires_grad_(init_params(cfg, torch.Generator(
        device=DEVICE).manual_seed(SEED + 30), device=DEVICE))
    pipe = DataPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                                   batch_size=TRAIN_B, seed=SEED))
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in next(pipe).items()}
    pipe.close()
    loss1, _, grads1 = value_and_grad(make_loss_fn(cfg, ExecPolicy()),
                                      params, batch)
    plan = SH.make_plan(cfg, ShapeConfig("train_tp", TRAIN_S, TRAIN_B,
                                         "train"), mesh)
    want = [(SH.local_slice(g, spec, mesh).clone(), float(g.abs().max()))
            for g, spec in zip(t_opt.tree_leaves(grads1),
                               t_opt.tree_leaves(plan.param_specs))]
    norm1 = float(t_opt.global_norm(grads1))
    local = requires_grad_(t_opt.tree_map(
        lambda t: t.detach().clone(memory_format=torch.contiguous_format),
        SH.shard_tree(params, plan.param_specs, mesh)))
    del params, grads1
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    loss, metrics, grads = value_and_grad(make_loss_fn(cfg, plan.policy),
                                          local, batch, plan.policy.shard)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = ops.launch_counts()
    errs = [max_err(g, b) / max(scale, 1e-30)
            for g, (b, scale) in zip(t_opt.tree_leaves(grads), want)]
    opt = t_opt.OptConfig()
    _, _, opt_metrics = t_opt.apply_updates(
        local, grads, t_opt.init_opt_state(local, opt), opt,
        plan.policy.shard)
    torch.cuda.synchronize()
    out = {"moe_variant": plan.moe_variant, "remat": plan.policy.remat,
           "loss_one_rank": float(loss1), "loss": float(loss),
           "aux_loss": float(metrics["aux_loss"]),
           "grad_norm_one_rank": norm1,
           "grad_norm": float(opt_metrics["grad_norm"]),
           "max_grad_err_of_max_abs": max(errs), "leaves": len(errs),
           "seconds": secs, "launches": launches,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    del local, grads, want
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_rank_serve(torch, ops, mesh, prompt) -> dict:
    """serve_tp on this rank: mixtral-8x7b at full width under the
    ("model",) decode plan (``ep_psum`` through moe_ffn on the rank's 4
    experts, the sequence-sharded attention over its half of the ring),
    each rank drawing the whole layers from the parent's seeds and keeping
    its slices: 1 layer in f32 for ``TP_F32_STEPS`` steps, then
    ``TP_SERVE_LAYERS`` in bf16 for ``PLAN_STEPS`` steps, counted and
    timed."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as SH
    from repro_torch.models.params import init_params
    from repro_torch.training.optimizer import tree_map
    out = {}
    for label, layers, dtype, seed, steps in TP_SERVE_RUNS:
        cfg = dataclasses.replace(_mixtral(), num_layers=layers, dtype=dtype,
                                  capacity_factor=PLAN_CF)
        plan = SH.make_plan(cfg, ShapeConfig("serve_tp", PLAN_SLOTS, PLAN_B,
                                             "decode"), mesh,
                            use_kernels=True)
        params = tree_map(
            lambda t: t.clone(memory_format=torch.contiguous_format),
            SH.shard_tree(init_params(cfg, torch.Generator(
                device=DEVICE).manual_seed(seed), device=DEVICE),
                plan.param_specs, mesh))
        gc.collect()
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        logits, toks, secs = plan_decode(torch, cfg, params, prompt,
                                         plan.policy, plan=plan, steps=steps)
        out[label] = {"moe_variant": plan.moe_variant,
                      "logits": logits.float().cpu(), "tokens": toks.cpu(),
                      "decode_tok_per_s": PLAN_B * steps / secs,
                      "launches": ops.launch_counts()}
        del params, logits
        gc.collect()
        torch.cuda.empty_cache()
    return out


def tp_rank(argv) -> int:
    """One rank of train_tp / serve_tp: ``chip_smoke.py --tp-rank RANK
    WORLD DIR`` joins a gloo group of WORLD ranks through ``DIR/init``,
    runs both phases' rank parts and saves their results to
    ``DIR/rank<RANK>.pt``."""
    import torch
    import torch.distributed as dist
    rank, world, rundir = int(argv[0]), int(argv[1]), argv[2]
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build, ops
    from repro_torch.launch.mesh import make_mesh
    build.build_all()                     # built by the parent: loads them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{rundir}/init",
                            rank=rank, world_size=world)
    mesh = make_mesh((world,), ("model",))
    prompt = torch.load(os.path.join(rundir, "prompt.pt")).to(DEVICE)
    out = {"train": tp_rank_train(torch, ops, mesh),
           "serve": tp_rank_serve(torch, ops, mesh, prompt),
           "backend": dist.get_backend()}
    dist.destroy_process_group()
    torch.save(out, os.path.join(rundir, f"rank{rank}.pt"))
    return 0


def phase_tp(torch, np, ops):
    """train_tp and serve_tp: mixtral-8x7b at full width under plans of a
    ("model",) mesh of ``TP_WORLD`` ranks on the one card (``tp_rank``,
    each a process of this script over a gloo group of CUDA tensors),
    against the one-rank step.  The parent first runs serve_tp's one-rank
    decodes (the grouped MoE through the kernels, no plan) on the same
    weights and prompt, then starts the ranks and waits for them; a rank
    that fails fails the run.  Checks: train_tp's loss within
    ``PLAN_LOSS_TOL`` relative and every gradient within ``PLAN_GRAD_TOL``
    of its leaf's max-abs of the one-rank step's, on every rank;
    serve_tp's f32 logits within ``TP_LOGIT_TOL`` of the one-rank logits'
    max-abs and the same tokens; the launches of the plans' kernels to the
    count.  Prints the bf16 decode tok/s beside the one-rank step's.
    Returns each phase's launches (rank 0's)."""
    from repro_torch.models.model import ExecPolicy
    from repro_torch.models.params import init_params
    rng = np.random.default_rng(SEED + 40)
    prompt = torch.as_tensor(rng.integers(2, _mixtral().vocab_size,
                                          (PLAN_B, PLAN_PROMPT)),
                             device=DEVICE)
    one = {}
    for label, layers, dtype, seed, steps in TP_SERVE_RUNS:
        cfg = dataclasses.replace(_mixtral(), num_layers=layers, dtype=dtype,
                                  capacity_factor=PLAN_CF)
        params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
            seed), device=DEVICE)
        logits, toks, secs = plan_decode(
            torch, cfg, params, prompt,
            ExecPolicy(moe_impl="grouped", use_kernels=True), steps=steps)
        one[label] = {"logits": logits.float().cpu(), "tokens": toks.cpu(),
                      "decode_tok_per_s": PLAN_B * steps / secs}
        del params, logits
        gc.collect()
        torch.cuda.empty_cache()
    rundir = os.path.join(ROOT, "build", f"tp_{os.getpid()}")
    shutil.rmtree(rundir, ignore_errors=True)
    os.makedirs(rundir)
    torch.save(prompt.cpu(), os.path.join(rundir, "prompt.pt"))
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
         str(TP_WORLD), rundir], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(TP_WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TP_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks_s = time.perf_counter() - t0
    require(all(p.returncode == 0 for p in procs),
            "a tensor-parallel rank failed:\n" + "\n".join(
                f"--- rank {r} (exit {p.returncode})\n{log[-3000:]}"
                for r, (p, log) in enumerate(zip(procs, logs))))
    res = [torch.load(os.path.join(rundir, f"rank{r}.pt"))
           for r in range(TP_WORLD)]
    shutil.rmtree(rundir, ignore_errors=True)
    card = card_line()
    # train_tp
    L = TRAIN_CHECK_LAYERS
    expected = {"flash_prefill": 2 * L, "flash_prefill_bwd": L}
    tr = [r["train"] for r in res]
    loss1 = tr[0]["loss_one_rank"]
    loss_rel = max(abs(t["loss"] - loss1) / abs(loss1) for t in tr)
    grad_err = max(t["max_grad_err_of_max_abs"] for t in tr)
    emit({"phase": "train_tp", "model": "mixtral-8x7b", "layers": L,
          "dtype": "float32", "batch": [TRAIN_B, TRAIN_S],
          "mesh": {"model": TP_WORLD}, "backend": res[0]["backend"],
          "tensors_on": DEVICE, "capacity_factor": TRAIN_PLAN_CF,
          "ranks": tr, "loss_rel_err": loss_rel, "loss_tol": PLAN_LOSS_TOL,
          "max_grad_err_of_max_abs": grad_err, "grad_tol": PLAN_GRAD_TOL,
          "expected_launches": expected, "ranks_wall_s": ranks_s,
          "card": card})
    require(all(t["moe_variant"] == "ep_a2a" and t["remat"] for t in tr),
            f"train_tp: variants {[t['moe_variant'] for t in tr]}")
    require(all(t["loss_one_rank"] == loss1 for t in tr),
            "train_tp: the ranks' one-rank steps differ")
    require(loss_rel <= PLAN_LOSS_TOL,
            f"train_tp: loss {[t['loss'] for t in tr]} vs {loss1}")
    require(grad_err <= PLAN_GRAD_TOL,
            f"train_tp: gradients differ by {grad_err} of max-abs")
    require(all(abs(t["grad_norm"] - t["grad_norm_one_rank"])
                <= PLAN_GRAD_TOL * t["grad_norm_one_rank"] for t in tr),
            "train_tp: grad norms "
            f"{[(t['grad_norm'], t['grad_norm_one_rank']) for t in tr]}")
    for r, t in enumerate(tr):
        require(all(t["launches"][k] == n for k, n in expected.items()),
                f"train_tp rank {r}: launched {t['launches']}, expected "
                f"{expected}")
    # serve_tp
    sv = [r["serve"] for r in res]
    scale = float(one["f32"]["logits"].abs().max())
    f32_err = max(max_err(s["f32"]["logits"], one["f32"]["logits"])
                  for s in sv)
    n, Ls = PLAN_STEPS, TP_SERVE_LAYERS
    expected_s = {"moe_ffn": Ls * (n + 1), "gqa_decode": Ls * n,
                  "flash_prefill": Ls}
    line = {"phase": "serve_tp", "model": "mixtral-8x7b",
            "mesh": {"model": TP_WORLD}, "backend": res[0]["backend"],
            "tensors_on": DEVICE, "batch": PLAN_B, "prompt": PLAN_PROMPT,
            "ring": PLAN_SLOTS, "capacity_factor": PLAN_CF,
            "moe_variant": sv[0]["bf16"]["moe_variant"],
            "f32": {"layers": 1, "steps": TP_F32_STEPS,
                    "max_abs_err_vs_one_rank": f32_err,
                    "one_rank_max_abs": scale, "tol_of_max_abs":
                        TP_LOGIT_TOL,
                    "tokens_equal": [bool(torch.equal(
                        s["f32"]["tokens"], one["f32"]["tokens"]))
                        for s in sv]},
            "bf16": {"layers": Ls, "of_layers": _mixtral().num_layers,
                     "steps": n, "one_rank_decode_tok_per_s":
                         one["bf16"]["decode_tok_per_s"],
                     "decode_tok_per_s": [s["bf16"]["decode_tok_per_s"]
                                          for s in sv],
                     "tokens_equal_to_one_rank": [float(
                         (s["bf16"]["tokens"] == one["bf16"]["tokens"])
                         .float().mean()) for s in sv],
                     "max_abs_err_vs_one_rank": max(
                         max_err(s["bf16"]["logits"], one["bf16"]["logits"])
                         for s in sv)},
            "launches": [s["bf16"]["launches"] for s in sv],
            "expected_launches": expected_s, "card": card}
    emit(line)
    require(all(s["bf16"]["moe_variant"] == "ep_psum" for s in sv),
            "serve_tp: the decode plan runs no ep_psum")
    require(all(torch.isfinite(s[k]["logits"]).all() for s in sv
                for k in ("f32", "bf16")), "serve_tp: logits not finite")
    require(f32_err <= TP_LOGIT_TOL * scale and all(
        line["f32"]["tokens_equal"]),
        f"serve_tp f32: logits {f32_err} (of max-abs {scale}), tokens "
        f"{line['f32']['tokens_equal']}")
    for r, s in enumerate(sv):
        got = s["bf16"]["launches"]
        require(all(got[k] == v for k, v in expected_s.items()),
                f"serve_tp rank {r}: launched {got}, expected {expected_s}")
    return {"train_tp": tr[0]["launches"], "serve_tp": sv[0]["bf16"][
        "launches"]}


def phase_train_mixtral(torch, np, ops):
    """mixtral-8x7b at full width, ``TRAIN_LAYERS`` of its 32 layers, bf16
    with AdamW's moments in f32, ``TRAIN_STEPS`` steps of ``TRAIN_B`` x
    ``TRAIN_S`` tokens from the port's DataPipeline through ``Trainer``,
    as a user runs it: a finite loss and grad norm at every step, each
    step's loss and time, train tokens/s (all tokens over the whole
    ``run()``'s wall time, data and the first step included; the median
    step's rate beside it) and peak device memory; the
    launches over the run must be one forward and one backward attention
    launch a layer a step.  One more step, after the count, is timed in
    its two parts: forward and backward, then AdamW.  Then a checkpoint
    save and resume at
    ``.smoke()`` width: the resumed trainer's step, parameters and moments
    equal what was saved.  Returns the launches."""
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.training.optimizer import apply_updates, tree_leaves
    from repro_torch.training.train_step import make_loss_fn, value_and_grad
    from repro_torch.training.trainer import Trainer, TrainConfig
    L = TRAIN_LAYERS
    cfg = dataclasses.replace(_mixtral(), num_layers=L)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, TrainConfig(steps=TRAIN_STEPS, batch_size=TRAIN_B,
                                  seq_len=TRAIN_S, log_every=1, seed=SEED),
                 device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_leaves(tr.params))
    step_s = []
    inner = tr.step_fn

    def timed(params, state, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(params, state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return out

    tr.step_fn = timed
    ops.reset_launch_counts()
    t = time.perf_counter()
    tr.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log = tr.metrics_log
    steady = statistics.median(step_s[1:])
    pipe = DataPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                                   batch_size=TRAIN_B, seed=SEED))
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in next(pipe).items()}
    pipe.close()
    t = time.perf_counter()
    _, _, grads = value_and_grad(make_loss_fn(cfg, None), tr.params, batch)
    torch.cuda.synchronize()
    fwd_bwd_s = time.perf_counter() - t
    t = time.perf_counter()
    apply_updates(tr.params, grads, tr.opt_state, tr.opt)
    torch.cuda.synchronize()
    adamw_s = time.perf_counter() - t
    del grads, batch
    expected = {"flash_prefill": L * TRAIN_STEPS,
                "flash_prefill_bwd": L * TRAIN_STEPS}
    emit({"phase": "train_mixtral", "layers": L, "params": n_params,
          "dtype": cfg.dtype, "moment_dtype": tr.opt.moment_dtype,
          "batch": [TRAIN_B, TRAIN_S], "steps": len(log),
          "loss": [m["loss"] for m in log],
          "grad_norm": [m["grad_norm"] for m in log],
          "lr": [m["lr"] for m in log], "step_s": step_s,
          "init_s": init_s, "median_step_s_after_first": steady,
          "one_step_split_s": {"forward_backward": fwd_bwd_s,
                               "adamw": adamw_s},
          "run_s": run_s,
          "train_tokens_per_s": TRAIN_STEPS * TRAIN_B * TRAIN_S / run_s,
          "median_step_tokens_per_s": TRAIN_B * TRAIN_S / steady,
          "peak_device_bytes": peak, "launches": launches,
          "expected_launches": expected})
    require(len(log) == TRAIN_STEPS and all(
        math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
        for m in log), f"train_mixtral: a step not finite: {log}")
    require(all(launches[k] == n for k, n in expected.items()),
            f"train_mixtral: launches {launches}, expected {expected}")
    del tr, inner, timed
    gc.collect()
    torch.cuda.empty_cache()

    # save and resume at smoke width, through the trainer's checkpoints
    ckpt = os.path.join(ROOT, "build", "train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    sm = _mixtral().smoke()

    def trainer(steps):
        return Trainer(sm, TrainConfig(steps=steps, batch_size=2, seq_len=32,
                                       ckpt_dir=ckpt, ckpt_every=1,
                                       seed=SEED), device=DEVICE)

    first = trainer(2)
    first.run()
    resumed = trainer(3)
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(first.params), tree_leaves(resumed.params)))
    same_moments = all(torch.equal(a, b) for name in ("mu", "nu")
                       for a, b in zip(tree_leaves(first.opt_state[name]),
                                       tree_leaves(resumed.opt_state[name])))
    step_at_resume = resumed.step
    resumed.run()
    emit({"phase": "train_resume", "config": sm.name,
          "saved_steps": [2], "resumed_at": step_at_resume,
          "params_equal": same, "moments_equal": same_moments,
          "final_step": resumed.step,
          "on_device": str(tree_leaves(resumed.params)[0].device)})
    require(step_at_resume == 2 and same and same_moments
            and resumed.step == 3,
            "train_resume: the resumed trainer is not the saved one")
    del first, resumed
    shutil.rmtree(ckpt, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def gqa_f32_case(torch, q, k, v, valid, kw) -> dict:
    """gqa_decode on f32 copies of a bf16 case's inputs against its plain
    version, within ``F32_TOL``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.gqa_decode import gqa_decode
    q, k, v = q.float(), k.float(), v.float()
    got, want = gqa_decode(q, k, v, valid, **kw), \
        ref.gqa_decode_ref(q, k, v, valid, **kw)
    err = max(max_err(a, b) for a, b in zip(got, want))
    require(all(close(a, b, F32_TOL) for a, b in zip(got, want)),
            f"gqa_decode f32 (H {q.shape[1]} / {k.shape[2]}, D "
            f"{q.shape[2]}): {err}")
    return {"max_abs_err": err, "tol": F32_TOL}


def kernel_expert_gather(torch, timer, rn):
    """expert_gather at mixtral's span (2688 pages of 65536 bf16, 352 MB):
    one layer's 8 experts in a pinned host store, all of them also in a
    pool on the card, and three cases of 8 slots: no miss (8 activated,
    all resident), 4 misses (7 activated: 4 over the link, 3 from the
    pool, one pad slot; the shape of the first design's row) and 8 misses
    (8 activated, none resident).  Each is held against its plain version
    bit for bit (a copy) and timed beside the pinned host-to-device copy
    rate (``h2d_copy``), the least time the link and HBM allow, and the
    route through PyTorch calls (sel and the map read to the host, one
    ``index_select`` of the pool, one ``copy_`` per missing span).  The
    4-miss case is the kernels line's record."""
    from repro_torch.core import offload, paging
    from repro_torch.kernels import ref
    from repro_torch.kernels.expert_gather import expert_gather
    from repro_torch.models.params import abstract_params, param_defs
    cfg = dataclasses.replace(_mixtral(), num_layers=1)
    page_elems = 1 << 16
    blocks = abstract_params(cfg, param_defs(cfg)["blocks"])
    pw = paging.PagedWeights.empty(blocks, page_elems, torch.device(DEVICE))
    try:
        key = "p0"
        em = pw.expert_manifests[key]
        store = pw.expert_pages[key]                  # (1, 8, 2688, 65536)
        E, ppe = em.num_experts, em.pages_per_expert
        for e in range(E):
            store[0, e].copy_(rn(ppe, page_elems))
        pool = torch.empty((E, ppe, page_elems), dtype=torch.bfloat16,
                           device=DEVICE)
        pool.copy_(store[0])
        span_bytes = em.span_bytes
        used = sum(math.prod(e.shape) for e in em.leaves) * 2
        dst = torch.empty((ppe, page_elems), dtype=torch.bfloat16,
                          device=DEVICE)
        h2d_ms = timer(lambda: dst.copy_(store[0, 0], non_blocking=True), 5,
                       1)
        h2d_rate = span_bytes / h2d_ms / 1e6                      # GB/s
        emit({"phase": "h2d_copy", "bytes": span_bytes, "ms": h2d_ms,
              "GBps": h2d_rate, "from": "pinned host (cudaHostRegister)",
              "store_bytes": store.nbytes,
              "pinned_bytes": offload.pinned_bytes()})
        del dst
        out_spans = torch.empty((E, ppe, page_elems), dtype=torch.bfloat16,
                                device=DEVICE)
        cases = []
        for misses, active, resident in (
                (0, list(range(E)), list(range(E))),
                (4, [0, 1, 2, 3, 5, 6, 7], [1, 3, 6]),
                (8, list(range(E)), [])):
            rmap = torch.full((1, E), -1, dtype=torch.int32, device=DEVICE)
            for e in resident:
                rmap[0, e] = e                       # pool slot e holds e
            sel = torch.tensor(active + [0] * (E - len(active)),
                               dtype=torch.int32, device=DEVICE)
            n_act = torch.tensor(len(active), dtype=torch.int32,
                                 device=DEVICE)
            args = (store, pool if resident else None, rmap, 0, sel, n_act,
                    em)
            got = expert_gather(*args)
            want = ref.expert_gather_ref(*args)
            torch.cuda.synchronize()
            exact = all(torch.equal(got[k], want[k]) for k in got)
            pads_zero = not any(bool(t[len(active):].any())
                                for t in got.values())
            require(exact and pads_zero,
                    f"expert_gather differs from its plain version at "
                    f"{misses} misses")
            err = max(max_err(got[k], want[k]) for k in got)
            del want
            n_host = sum(e not in resident for e in active)
            n_pool = len(active) - n_host
            host_bytes, dev_bytes = n_host * used, n_pool * used
            # the least time: the misses' bytes over the link at the
            # measured copy rate, or the pool's spans read plus every
            # output written at the data sheet's HBM rate, whichever is
            # longer (the two run side by side)
            link_ms = host_bytes / (h2d_rate * 1e9) * 1e3
            hbm_ms = (2 * dev_bytes + host_bytes) / HBM_BYTES_PER_S * 1e3
            bms = max(link_ms, hbm_ms)

            def library():
                """sel and the map to the host, then one index_select of
                the pool and one copy_ per missing span; pads zeroed."""
                s_h = sel.cpu().tolist()
                m_h = rmap.cpu()[0].tolist()
                n = int(n_act)
                res = [a for a in range(n) if m_h[s_h[a]] >= 0]
                if res:
                    idx = torch.tensor(res, device=DEVICE)
                    slots = torch.tensor([m_h[s_h[a]] for a in res],
                                         device=DEVICE)
                    out_spans.index_copy_(0, idx, pool.index_select(0, slots))
                for a in range(n):
                    if m_h[s_h[a]] < 0:
                        out_spans[a].copy_(store[0, s_h[a]],
                                           non_blocking=True)
                out_spans[n:].zero_()
                return out_spans
            lib = paging.unflatten_expert_span(library(), em)
            torch.cuda.synchronize()
            require(all(torch.equal(lib[k], got[k]) for k in got),
                    "the library route differs from expert_gather")
            ms = timer(lambda: expert_gather(*args), 5, 1)
            library_ms = timer(library, 5, 1)
            case = {"misses": misses, "active": len(active),
                    "from_host": n_host, "from_pool": n_pool,
                    "max_abs_err": err, "bit_exact": exact, "ms": ms,
                    "bound_ms": bms,
                    "bound_by": "bytes (link)" if link_ms >= hbm_ms
                    else "bytes (HBM)",
                    "bound_sum_ms": link_ms + 2 * dev_bytes
                    / HBM_BYTES_PER_S * 1e3,
                    "library_ms": library_ms,
                    "host_GBps": host_bytes / ms / 1e6,
                    "host_share_of_h2d": host_bytes / ms / 1e6 / h2d_rate,
                    "host_bytes": host_bytes, "pool_bytes": dev_bytes}
            emit({"phase": "expert_gather_case", **case})
            cases.append((case, args))
        case, args = cases[1]
        rec = {"name": "expert_gather", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/expert_gather.cu",
               "replaces": "src/repro/models/model.py:56",
               "replaces_note": "the port's own kernel, with no Pallas "
                                "counterpart: the XLA gather that "
                                "_ExpertCtx.make_fetch lowers to",
               "shape": {"A": E, "active": case["active"],
                         "from_host": case["from_host"],
                         "from_pool": case["from_pool"], "ppe": ppe,
                         "page_elems": page_elems, "span_bytes": span_bytes,
                         "dtype": "bf16"},
               "max_abs_err": case["max_abs_err"],
               "bit_exact": case["bit_exact"], "ms": case["ms"],
               "plain_ms": timer(lambda: ref.expert_gather_ref(*args), 3, 1),
               "bound_ms": case["bound_ms"], "bound_by": "bytes",
               "bound_rates": {"h2d_GBps_measured": h2d_rate,
                               "hbm_Bps": HBM_BYTES_PER_S},
               "library_ms": case["library_ms"],
               "library_call": "sel and map to the host, index_select of "
                               "the pool, copy_(non_blocking=True) per "
                               "missing span",
               "host_GBps": case["host_GBps"],
               "host_bytes": case["host_bytes"],
               "pool_bytes": case["pool_bytes"],
               "cases": [c for c, _ in cases]}
        emit({"phase": "kernel_bf16", **rec})
        return rec
    finally:
        pw.release()
        del pw
        torch.cuda.empty_cache()


def paged_inputs(torch, rng, lens, H, Hkv, D, bt, MB, NB, holes, dtype, rn):
    """A decode step over a head-major arena of NB blocks plus the trash
    block (NaN, so that a read of it shows): row b has written lens[b]
    positions and maps the blocks covering them and its next one (the
    fused token's) at physical blocks scattered over the arena; a block is
    left unmapped with probability `holes`, and a row of length 0 maps
    none.  Returns (q, cache, pos, new)."""
    import numpy as np
    B = len(lens)
    pt = np.full((B, MB), -1, np.int32)
    sp = np.full((NB + 1, bt), -1, np.int32)
    perm, used = rng.permutation(NB), 0
    for b, n in enumerate(lens):
        for lb in range(-(-(n + 1) // bt) if n else 0):
            if rng.random() < holes:
                continue
            pt[b, lb] = perm[used]
            used += 1
            p = lb * bt + np.arange(bt)
            sp[pt[b, lb]] = np.where(p < n, p, -1)
    k = rn(Hkv, NB + 1, bt, D, dtype=dtype)
    v = rn(Hkv, NB + 1, bt, D, dtype=dtype)
    k[:, NB] = float("nan")
    v[:, NB] = float("nan")
    cache = {"k": k, "v": v,
             "slot_pos": torch.as_tensor(sp, device=DEVICE),
             "page_table": torch.as_tensor(pt, device=DEVICE)}
    pos = torch.as_tensor(np.asarray(lens, np.int32), device=DEVICE)
    new = {"k": rn(B, 1, Hkv, D, dtype=dtype),
           "v": rn(B, 1, Hkv, D, dtype=dtype)}
    return rn(B, H, D, dtype=dtype), cache, pos, new


def zero_trash(cache):
    """A copy of a paged layer cache with a zero trash block: the plain
    version gathers the trash for unmapped blocks (and masks it), so it is
    held against the kernel on finite values."""
    out = {n: a.clone() for n, a in cache.items()}
    for name in ("k", "v"):                  # head-major: block axis 1
        if name in out:
            out[name][:, -1] = 0
    for name in ("ckv", "kr"):               # latents: block axis 0
        if name in out:
            out[name][-1] = 0
    return out


def kernel_paged(torch, F, timer, rn):
    """paged_gqa_decode: f32 cases at small shapes (several block sizes,
    unmapped entries, a row with no block, window, softcap; unfused and
    fused), then bf16 at the served shapes with its timings."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.kernels.gqa_decode import gqa_decode
    from repro_torch.kernels.paged_decode import paged_gqa_decode
    from repro_torch.models import kvcache
    from repro_torch.models.attention import decode_valid_mask
    rng = np.random.default_rng(SEED)
    f32 = torch.float32
    errs = []
    for B, H, Hkv, D, bt, MB, window, cap in (
            (3, 8, 2, 64, 16, 6, 0, 0.0), (2, 4, 1, 32, 4, 12, 10, 30.0),
            (2, 8, 8, 128, 32, 3, 0, 0.0), (2, 16, 2, 128, 8, 8, 0, 20.0)):
        lens = [int(n) for n in rng.integers(1, MB * bt - 1, B)]
        if B > 2:
            lens[0] = 0                          # maps no block at all
        q, cache, pos, new = paged_inputs(torch, rng, lens, H, Hkv, D, bt,
                                          MB, B * MB, 0.2, f32, rn)
        plain = zero_trash(cache)
        kw = dict(scale=D ** -0.5, window=window, attn_softcap=cap)
        got = ops.paged_gqa_decode(q, cache, pos, **kw)
        want = ops.paged_gqa_decode(q, plain, pos, impl="ref", **kw)
        fused = ops.paged_gqa_decode_fused(q, cache, new, pos, **kw)
        want_f = ops.paged_gqa_decode_fused(q, plain, new, pos, impl="ref",
                                            **kw)
        after = ops.paged_gqa_decode(q, cache, pos, **kw)
        torch.cuda.synchronize()
        for a, b in (*zip(got, want), *zip(fused, want_f)):
            errs.append(max_err(a, b))
            require(close(a, b, F32_TOL), f"paged f32 bt {bt}: {errs[-1]}")
        require(all(torch.equal(a, b) for a, b in zip(fused, after)),
                f"paged f32 bt {bt}: fused differs from write-then-attend")
        if lens[0] == 0:
            require(not any(bool(t[0].any()) for t in (*got, *fused)),
                    "paged f32: a row with no block gave nonzero partials")
    emit({"phase": "kernels_f32", "max_abs_err": {"paged_gqa_decode":
                                                  max(errs)},
          "tol": F32_TOL, "trash": "NaN, never read",
          "fused_equals_write_then_attend": "bit for bit"})

    # bf16 at the served shapes: 8 rows mid-serve, blocks of 16, the
    # paged engine's arena and page-table width
    cfg = _mixtral()
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    bt = SERVE_PAGED["block_tokens"]
    MB = SERVE_PAGED["max_seq"] // bt
    slots = SERVE_PAGED["ubatch"] * SERVE_PAGED["num_ubs"]
    NB = round(SERVE_PAGED["kv_gpu_ratio"] * slots * MB)
    lens = [int(n) for n in rng.integers(
        PAGED_PROMPT_LENS[0], PAGED_PROMPT_LENS[1] + NEW_TOKENS,
        SERVE_PAGED["ubatch"])]
    q, cache, pos, new = paged_inputs(torch, rng, lens, H, Hkv, D, bt, MB,
                                      NB, 0.0, torch.bfloat16, rn)
    kw = dict(scale=D ** -0.5)
    case, plain = paged_case(torch, F, timer, q, cache, pos, new, kw)
    view = kvcache.paged_view(plain)
    vk, vv = view["k"].contiguous(), view["v"].contiguous()
    vmask = decode_valid_mask(view["slot_pos"], pos, 0)
    args = (q, cache["k"], cache["v"], cache["slot_pos"],
            cache["page_table"], pos)
    kn, vn = new["k"][:, 0], new["v"][:, 0]
    rec = {"name": "paged_gqa_decode", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
           "replaces": "src/repro/kernels/paged_decode.py:167", **case,
           "warm_ms": timer(lambda: paged_gqa_decode(
               *args, k_new=kn, v_new=vn, **kw), cold=False),
           "gather_ms": timer(lambda: kvcache.paged_view(plain)),
           "dense_gqa_decode_ms": timer(lambda: gqa_decode(
               q, vk, vv, vmask, **kw))}
    emit({"phase": "kernel_bf16", **rec})
    rec["int8"] = paged_int8_case(torch, F, timer, q, cache, pos, new, kw)
    emit({"phase": "paged_sweep",
          **paged_sweep(torch, rng, timer, rn, q, Hkv, kw)})
    return rec


def paged_sweep(torch, rng, timer, rn, q, Hkv, kw):
    """Where the paged kernel's time goes, at the served shapes: its time
    against the number of mapped blocks per row (0 = launches only), beside
    the dense ring's ``gqa_decode`` over a max_seq-wide ring holding the
    same positions (the dense-vs-paged crossover behind ``auto`` taking the
    paged kernel for a paged cache)."""
    from repro_torch.kernels import paged_decode
    from repro_torch.kernels.gqa_decode import gqa_decode
    B, H, D = q.shape
    bt = SERVE_PAGED["block_tokens"]
    MB = SERVE_PAGED["max_seq"] // bt
    W = MB * bt
    k, v = rn(Hkv, B * MB + 1, bt, D), rn(Hkv, B * MB + 1, bt, D)
    kd, vd = rn(B, W, Hkv, D), rn(B, W, Hkv, D)
    perm = torch.as_tensor(rng.permutation(B * MB).astype("int32"),
                           device=DEVICE).view(B, MB)
    sp = torch.arange(W, dtype=torch.int32, device=DEVICE).view(MB, bt)
    slot_pos = torch.full((B * MB + 1, bt), -1, dtype=torch.int32,
                          device=DEVICE)
    slot_pos[perm.reshape(-1).long()] = sp.repeat(B, 1)
    rows = []
    for n in (0, 1, 8, 16, 32, 48, 64):
        pt = torch.where(torch.arange(MB, device=DEVICE) < n, perm, -1).int()
        pos = torch.full((B,), max(n * bt - 1, 0), dtype=torch.int32,
                         device=DEVICE)
        valid = (torch.arange(W, device=DEVICE) < n * bt)[None].repeat(B, 1)
        rows.append({"blocks_per_row": n, "paged_ms": timer(
            lambda: paged_decode.paged_gqa_decode(q, k, v, slot_pos, pt, pos,
                                                  **kw)),
            "dense_gqa_decode_ms": timer(
                lambda: gqa_decode(q, kd, vd, valid, **kw))})
    return {"occupancy": rows}


def routed_xbuf(torch, rn, E, C, D, top_k, rows):
    """The bucket buffer of one decode step: `rows` token rows, each routed
    to top_k of E experts drawn from a seeded generator, placed with
    first-come capacity C as moe_grouped places them
    (``moe.stage_bucket``); the slots no token reached stay zero.  Returns
    (xbuf, occupied experts)."""
    from repro_torch.models import moe
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    x = rn(rows, D)
    idx = torch.rand(rows, E, generator=g, device=DEVICE).topk(top_k, -1)[1]
    flat_e = idx.reshape(-1)
    flat_t = torch.arange(rows, device=DEVICE).repeat_interleave(top_k)
    slot, keep = moe.stage_bucket(flat_e, E, C)
    xbuf = torch.zeros((E, C, D), dtype=x.dtype, device=DEVICE)
    xbuf[flat_e[keep], slot[keep]] = x[flat_t[keep]]
    return xbuf, int(xbuf.ne(0).any(-1).any(-1).sum())


def moe_occupancy_case(torch, F, timer, rn, wi, wo, cfg, rows, C,
                       scales=(None, None), library_w=None):
    """moe_ffn at the decode bucket as `rows` routed rows fill it: held
    against its plain version, the empty rows exactly zero; the bound
    counts the weight bytes of the occupied experts only (the work this
    input needs).  int8 weights pass their per-expert `scales` and, for
    the library's yardstick, the weights dequantized to bf16
    (`library_w`)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_ffn import moe_ffn
    E, D, Fd = cfg.num_experts, cfg.d_model, cfg.d_ff
    x, occ = routed_xbuf(torch, rn, E, C, D, cfg.top_k, rows)
    got, want = moe_ffn(x, wi, wo, *scales), \
        ref.moe_ffn_ref(x, wi, wo, *scales)
    err = max_err(got, want)
    empty = ~x.ne(0).any(-1)
    require(close(got, want, BF16_OUT_TOL),
            f"moe_ffn bf16 {cfg.name} at served occupancy: {err}")
    require(bool((got[empty] == 0).all()),
            f"moe_ffn {cfg.name}: an empty bucket row gave a nonzero output")
    del got, want
    lwi, lwo = library_w or (wi, wo)
    wi3 = lwi.view(E, D, 2 * Fd)

    def library():
        h = torch.bmm(x, wi3)
        return torch.bmm(F.silu(h[..., :Fd]) * h[..., Fd:], lwo)
    wbytes = wi.element_size()
    bms, by = bound(2 * 2 * E * C * D + 3 * occ * D * Fd * wbytes
                    + (8 * occ if scales[0] is not None else 0),
                    6 * occ * C * D * Fd)
    rec = {"shape": {"E": E, "C": C, "D": D, "F": Fd, "dtype": "bf16",
                     "weights": str(wi.dtype).removeprefix("torch."),
                     "at": "decode", "routed_rows": rows,
                     "top_k": cfg.top_k, "occupied_experts": occ,
                     "occupied_rows": int((~empty).sum())},
           "max_abs_err": err, "empty_rows_exact_zero": True,
           "ms": timer(lambda: moe_ffn(x, wi, wo, *scales), 5, 1),
           "plain_ms": timer(lambda: ref.moe_ffn_ref(x, wi, wo, *scales),
                             3, 1),
           "bound_ms": bms, "bound_by": by,
           "library_ms": timer(library, 5, 1),
           "library_call": "torch.bmm chain (up, silu * up, down)"
           + (" on the weights dequantized to bf16 beforehand"
              if library_w else "")}
    emit({"phase": "kernel_bf16", "name": "moe_ffn", "model": cfg.name,
          "case": "served_occupancy", **rec})
    return rec


def moe_int8_cases(torch, F, timer, rn, cfg, B, g):
    """moe_ffn with int8 expert weights (``int8_experts``) and bf16
    activations at
    mixtral's decode bucket (C 3, every row full), at the occupancy `B`
    routed rows give it, and at the largest prefill bucket, each against
    its plain version.  The bound counts the int8 weight bytes plus the
    scales'; the library's yardstick runs the torch.bmm chain on the
    weights dequantized to bf16 beforehand (the port never does)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_ffn import moe_ffn
    E, D, Fd = cfg.num_experts, cfg.d_model, cfg.d_ff
    wi, wo, si, so = int8_experts(torch, cfg, g)
    lwi = (wi.to(torch.bfloat16) * si.to(torch.bfloat16)[:, None, None, None])
    lwo = (wo.to(torch.bfloat16) * so.to(torch.bfloat16)[:, None, None])
    lwi3 = lwi.view(E, D, 2 * Fd)
    out = {}
    for tokens, label in ((B, "decode"), (PROMPT_LENS[1], "prefill")):
        C = max(1, int(tokens * cfg.top_k * cfg.capacity_factor / E + 0.999))
        x = torch.empty((E, C, D), dtype=torch.bfloat16,
                        device=DEVICE).normal_(0.0, 1.0, generator=g)
        got, want = moe_ffn(x, wi, wo, si, so), \
            ref.moe_ffn_ref(x, wi, wo, si, so)
        err = max_err(got, want)
        require(close(got, want, BF16_OUT_TOL),
                f"moe_ffn int8 {label}: {err}")
        del got, want

        def library():
            h = torch.bmm(x, lwi3)
            return torch.bmm(F.silu(h[..., :Fd]) * h[..., Fd:], lwo)
        nbytes = 2 * 2 * E * C * D + 3 * E * D * Fd + 2 * 4 * E
        bms, by = bound(nbytes, 6 * E * C * D * Fd)
        rec = {"shape": {"E": E, "C": C, "D": D, "F": Fd, "dtype": "bf16",
                         "weights": "int8", "at": label},
               "max_abs_err": err,
               "ms": timer(lambda: moe_ffn(x, wi, wo, si, so)),
               "plain_ms": timer(lambda: ref.moe_ffn_ref(x, wi, wo, si, so),
                                 3, 1),
               "bound_ms": bms, "bound_by": by,
               "library_ms": timer(library),
               "library_call": "torch.bmm chain (up, silu * up, down) on "
                               "the weights dequantized to bf16 beforehand"}
        emit({"phase": "kernel_int8", "name": "moe_ffn", **rec})
        out[label] = rec
        if label == "decode":
            rec["served_occupancy"] = moe_occupancy_case(
                torch, F, timer, rn, wi, wo, cfg, B, C, (si, so),
                (lwi, lwo))
    return out


def gqa_int8_case(torch, F, timer, q, k, v, valid):
    """gqa_decode over the int8 ring ``kvcache.quantize_kv`` makes of the
    bf16 row's ring, at its valid positions, against its plain version on
    the same int8 ring.  The bound counts the int8 K/V rows of the valid
    slots and their f32 scales; the library's yardstick is SDPA over the
    ring dequantized to bf16 beforehand."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.gqa_decode import gqa_decode
    from repro_torch.models import kvcache
    B, H, Dh = q.shape
    W, Hkv = k.shape[1], k.shape[2]
    ring = kvcache.quantize_kv(k, v)
    k8, v8 = ring["k"], ring["v"]
    kw = dict(scale=Dh ** -0.5, k_scale=ring["k_scale"],
              v_scale=ring["v_scale"])
    got = gqa_decode(q, k8, v8, valid, **kw)
    want = ref.gqa_decode_ref(q, k8, v8, valid, **kw)
    err = max(max_err(a, b) for a, b in zip(got, want))
    require(all(close(a, b, F32_TOL) for a, b in zip(got, want)),
            f"gqa_decode int8: {err}")
    nvalid = int(valid.sum())
    nbytes = 2 * B * H * Dh + nvalid * Hkv * (2 * Dh + 2 * 4) + B * W \
        + 4 * B * H * (Dh + 2)
    bms, by = bound(nbytes, 2 * nvalid * H * 2 * Dh)
    kd, vd = kvcache.dequantize_kv(ring)
    kt = kd.to(torch.bfloat16).transpose(1, 2)
    vt = vd.to(torch.bfloat16).transpose(1, 2)
    rec = {"shape": {"B": B, "H": H, "Hkv": Hkv, "D": Dh, "W": W,
                     "valid": nvalid, "dtype": "bf16", "kv": "int8"},
           "max_abs_err": err,
           "ms": timer(lambda: gqa_decode(q, k8, v8, valid, **kw)),
           "plain_ms": timer(lambda: ref.gqa_decode_ref(q, k8, v8, valid,
                                                        **kw)),
           "bound_ms": bms, "bound_by": by,
           "library_ms": timer(sdpa_gqa(F, q[:, :, None], kt, vt, H // Hkv,
                                        attn_mask=valid[:, None, None, :])),
           "library_call": "scaled_dot_product_attention, masked, over the "
                           "ring dequantized to bf16 beforehand"}
    emit({"phase": "kernel_int8", "name": "gqa_decode", **rec})
    return rec


def paged_int8_case(torch, F, timer, q, cache, pos, new, kw):
    """The fused paged_gqa_decode over the int8 arena ``quantize_kv`` makes
    of the bf16 record's arena (its trash block's scales NaN, never read)
    and the quantized fresh token, against its plain version on the same
    arena with a zero trash block; fused must equal write-then-attend bit
    for bit, scales included.  The bound counts the mapped blocks' int8
    rows and f32 scales; the library's yardstick is SDPA over the gathered
    view dequantized to bf16 beforehand."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.paged_decode import paged_gqa_decode
    from repro_torch.models import kvcache
    from repro_torch.models.attention import decode_valid_mask
    B, H, D = q.shape
    Hkv, NB1, bt, _ = cache["k"].shape
    MB = cache["page_table"].shape[1]
    arena = kvcache.quantize_kv(torch.nan_to_num(cache["k"]),
                                torch.nan_to_num(cache["v"]))
    c8 = {**arena, "slot_pos": cache["slot_pos"],
          "page_table": cache["page_table"]}
    plain = {n: a.clone() for n, a in c8.items()}
    for name in ("k_scale", "v_scale"):
        c8[name][:, -1] = float("nan")       # never read by the kernel
        plain[name][:, -1] = 0.0
    fresh = kvcache.quantize_kv(new["k"], new["v"])
    fk = dict(k_new=fresh["k"][:, 0], v_new=fresh["v"][:, 0],
              k_scale_new=fresh["k_scale"][:, 0].contiguous(),
              v_scale_new=fresh["v_scale"][:, 0].contiguous())
    args = (q, c8["k"], c8["v"], c8["slot_pos"], c8["page_table"], pos)
    scales = dict(k_scale=c8["k_scale"], v_scale=c8["v_scale"])
    got = paged_gqa_decode(*args, **scales, **fk, **kw)
    want = ref.paged_gqa_decode_ref(q, plain, pos, **fk, **kw)
    err = max(max_err(a, b) for a, b in zip(got, want))
    require(all(close(a, b, F32_TOL) for a, b in zip(got, want)),
            f"paged_gqa_decode int8: {err}")
    # fused against write-then-attend, both through the kernel
    c2 = {n: a.clone() for n, a in c8.items()}
    fused = ops.paged_gqa_decode_fused(q, c2, fresh, pos, **kw)
    after = ops.paged_gqa_decode(q, c2, pos, **kw)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(fused, after)),
            "paged_gqa_decode int8: fused differs from write-then-attend")
    mapped = int((cache["page_table"] >= 0).sum())
    valid = int(pos.sum()) + B
    nbytes = (mapped * (Hkv * bt * (2 * D + 2 * 4) + bt * 4) + 2 * B * H * D
              + B * Hkv * (2 * D + 2 * 4) + 4 * B * (MB + 1)
              + 4 * B * H * (D + 2))
    bms, by = bound(nbytes, 2 * valid * H * 2 * D)
    view = kvcache.paged_view(plain)
    kd, vd = kvcache.dequantize_kv(view)
    kt = kd.to(torch.bfloat16).transpose(1, 2).contiguous()
    vt = vd.to(torch.bfloat16).transpose(1, 2).contiguous()
    vmask = decode_valid_mask(view["slot_pos"], pos, 0)
    rec = {"shape": {"B": B, "H": H, "Hkv": Hkv, "D": D, "bt": bt, "MB": MB,
                     "arena_blocks": NB1 - 1, "mapped_blocks": mapped,
                     "valid": valid, "dtype": "bf16", "kv": "int8",
                     "fused": True},
           "max_abs_err": err,
           "fused_equals_write_then_attend": "bit for bit",
           "ms": timer(lambda: paged_gqa_decode(*args, **scales, **fk, **kw)),
           "plain_ms": timer(lambda: ref.paged_gqa_decode_ref(
               q, plain, pos, **fk, **kw)),
           "bound_ms": bms, "bound_by": by,
           "library_ms": timer(sdpa_gqa(F, q[:, :, None], kt, vt, H // Hkv,
                                        attn_mask=vmask[:, None, None, :])),
           "library_call": "scaled_dot_product_attention over the gathered "
                           "view dequantized to bf16 beforehand"}
    emit({"phase": "kernel_int8", "name": "paged_gqa_decode", **rec})
    return rec


def _deepseek():
    from repro_torch.configs import get_config
    return get_config("deepseek-v3-671b")


def kernel_deepseek(torch, F, timer, rn, records):
    """moe_ffn at DeepSeek-V3's 256 experts (the decode bucket, C 1, and
    the largest prefill bucket) and flash_prefill at its MLA prefill shape
    (H = Hkv = 128, D 192, Dv 128), each against its plain version; the
    decode and prefill records join the mixtral ones as "deepseek"."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.moe_ffn import moe_ffn
    cfg = _deepseek()
    E, D, Fd = cfg.num_experts, cfg.d_model, cfg.d_ff
    by_name = {r["name"]: r for r in records}
    # 22.5 GB of bf16 expert weights: with every bucket full (the worst
    # case) the kernel streams them all; at the occupancy 8 routed rows
    # give, only the occupied experts'
    wi = rn(E, D, 2, Fd, std=D ** -0.5)
    wo = rn(E, Fd, D, std=Fd ** -0.5)
    wi3 = wi.view(E, D, 2 * Fd)
    for tokens, label in ((SERVE_PAGED["ubatch"], "decode"),
                          (PAGED_PROMPT_LENS[1], "prefill")):
        C = max(1, int(tokens * cfg.top_k * cfg.capacity_factor / E + 0.999))
        x = rn(E, C, D)
        got, want = moe_ffn(x, wi, wo), ref.moe_ffn_ref(x, wi, wo)
        err = max_err(got, want)
        require(close(got, want, BF16_OUT_TOL),
                f"moe_ffn bf16 deepseek {label}: {err}")
        del got, want

        def library():
            h = torch.bmm(x, wi3)
            return torch.bmm(F.silu(h[..., :Fd]) * h[..., Fd:], wo)
        bms, by = bound(2 * (2 * E * C * D + 3 * E * D * Fd),
                        6 * E * C * D * Fd)
        rec = {"shape": {"E": E, "C": C, "D": D, "F": Fd, "dtype": "bf16",
                         "at": label},
               "max_abs_err": err,
               "ms": timer(lambda: moe_ffn(x, wi, wo), 5, 1),
               "plain_ms": timer(lambda: ref.moe_ffn_ref(x, wi, wo), 3, 1),
               "bound_ms": bms, "bound_by": by,
               "library_ms": timer(library, 5, 1),
               "library_call": "torch.bmm chain (up, silu * up, down)"}
        emit({"phase": "kernel_bf16", "name": "moe_ffn",
              "model": "deepseek-v3-671b", **rec})
        by_name["moe_ffn"].setdefault("deepseek", {})[label] = rec
        if label == "decode":
            by_name["moe_ffn"]["deepseek"]["decode_served_occupancy"] = \
                moe_occupancy_case(torch, F, timer, rn, wi, wo, cfg, tokens,
                                   C)
    del wi, wo, wi3, x
    torch.cuda.empty_cache()

    H, dv = cfg.num_heads, cfg.v_head_dim
    dq = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    S = PROMPT_LENS[1]
    q, k, v = rn(1, S, H, dq), rn(1, S, H, dq), rn(1, S, H, dv)
    kw = dict(scale=dq ** -0.5)
    got, want = flash_prefill(q, k, v, **kw), ref.flash_prefill_ref(q, k, v,
                                                                    **kw)
    err = max_err(got, want)
    require(close(got, want, BF16_OUT_TOL), f"flash_prefill bf16 D 192: {err}")
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    causal_pairs = S * (S + 1) // 2
    bms, by = bound(2 * (2 * S * H * dq + 2 * S * H * dv),
                    2 * causal_pairs * H * (dq + dv))
    rec = {"shape": {"B": 1, "S": S, "H": H, "Hkv": H, "D": dq, "Dv": dv,
                     "dtype": "bf16"},
           "max_abs_err": err,
           "ms": timer(lambda: flash_prefill(q, k, v, **kw)),
           "plain_ms": timer(lambda: ref.flash_prefill_ref(q, k, v, **kw)),
           "bound_ms": bms, "bound_by": by,
           "library_ms": timer(sdpa_gqa(F, qt, kt, vt, 1, is_causal=True,
                                        **kw)),
           "library_call": "scaled_dot_product_attention, causal"}
    emit({"phase": "kernel_bf16", "name": "flash_prefill",
          "model": "deepseek-v3-671b", **rec})
    by_name["flash_prefill"]["deepseek"] = {"prefill": rec}


def mla_inputs(torch, rng, lens, H, lat, dr, bt, MB, NB, holes, dtype, rn):
    """A decode step over a latent arena of NB blocks plus the trash block
    (NaN, so that a read of it shows), laid out as ``paged_inputs`` lays
    out the GQA arena.  Returns (qcat, cache, pos, new)."""
    import numpy as np
    B = len(lens)
    pt = np.full((B, MB), -1, np.int32)
    sp = np.full((NB + 1, bt), -1, np.int32)
    perm, used = rng.permutation(NB), 0
    for b, n in enumerate(lens):
        for lb in range(-(-(n + 1) // bt) if n else 0):
            if rng.random() < holes:
                continue
            pt[b, lb] = perm[used]
            used += 1
            p = lb * bt + np.arange(bt)
            sp[pt[b, lb]] = np.where(p < n, p, -1)
    ckv = rn(NB + 1, bt, lat, dtype=dtype)
    kr = rn(NB + 1, bt, dr, dtype=dtype)
    ckv[NB] = float("nan")
    kr[NB] = float("nan")
    cache = {"ckv": ckv, "kr": kr,
             "slot_pos": torch.as_tensor(sp, device=DEVICE),
             "page_table": torch.as_tensor(pt, device=DEVICE)}
    pos = torch.as_tensor(np.asarray(lens, np.int32), device=DEVICE)
    new = {"ckv": rn(B, 1, lat, dtype=dtype), "kr": rn(B, 1, dr, dtype=dtype)}
    return rn(B, H, lat + dr, dtype=dtype), cache, pos, new


def kernel_mla(torch, timer, rn):
    """paged_mla_decode: f32 cases (blocks of 4, 8 and 16, unmapped
    entries, a row that maps nothing, a NaN trash block; unfused and
    fused, and fused against write-then-attend bit for bit), then bf16 at
    DeepSeek-V3's served shape with its timings."""
    import numpy as np
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.paged_mla_decode import paged_mla_decode
    from repro_torch.models import kvcache
    from repro_torch.models.attention import decode_valid_mask
    rng = np.random.default_rng(SEED + 5)
    f32 = torch.float32
    errs = []
    for B, H, lat, dr, bt, MB in ((3, 16, 512, 64, 16, 6),
                                  (2, 4, 32, 8, 4, 12),
                                  (2, 32, 128, 32, 8, 9),
                                  (2, 128, 512, 64, 16, 5)):
        lens = [int(n) for n in rng.integers(1, MB * bt - 1, B)]
        if B > 2:
            lens[0] = 0                          # maps no block at all
        q, cache, pos, new = mla_inputs(torch, rng, lens, H, lat, dr, bt,
                                        MB, B * MB, 0.2, f32, rn)
        plain = zero_trash(cache)
        kw = dict(scale=(lat // 4 + dr) ** -0.5)
        got = ops.paged_mla_decode(q, cache, pos, **kw)
        want = ops.paged_mla_decode(q, plain, pos, impl="ref", **kw)
        fused = ops.paged_mla_decode_fused(q, cache, new, pos, **kw)
        want_f = ops.paged_mla_decode_fused(q, plain, new, pos, impl="ref",
                                            **kw)
        after = ops.paged_mla_decode(q, cache, pos, **kw)
        torch.cuda.synchronize()
        for a, b in (*zip(got, want), *zip(fused, want_f)):
            errs.append(max_err(a, b))
            require(close(a, b, F32_TOL), f"mla f32 bt {bt}: {errs[-1]}")
        require(all(torch.equal(a, b) for a, b in zip(fused, after)),
                f"mla f32 bt {bt}: fused differs from write-then-attend")
        if lens[0] == 0:
            require(not any(bool(t[0].any()) for t in (*got, *fused)),
                    "mla f32: a row with no block gave nonzero partials")
    emit({"phase": "kernels_f32", "max_abs_err": {"paged_mla_decode":
                                                  max(errs)},
          "tol": F32_TOL, "trash": "NaN, never read",
          "fused_equals_write_then_attend": "bit for bit"})

    # bf16 at the served shape: 8 rows mid-serve over the paged engine's
    # arena (r_c 0.4 of 16 slots x 64 blocks of 16)
    cfg = _deepseek()
    H, lat, dr = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    bt = SERVE_PAGED["block_tokens"]
    MB = SERVE_PAGED["max_seq"] // bt
    slots = SERVE_PAGED["ubatch"] * SERVE_PAGED["num_ubs"]
    NB = round(SERVE_PAGED["kv_gpu_ratio"] * slots * MB)
    lens = [int(n) for n in rng.integers(
        PAGED_PROMPT_LENS[0], PAGED_PROMPT_LENS[1] + NEW_TOKENS,
        SERVE_PAGED["ubatch"])]
    q, cache, pos, new = mla_inputs(torch, rng, lens, H, lat, dr, bt, MB, NB,
                                    0.0, torch.bfloat16, rn)
    plain = zero_trash(cache)
    cn, rn_ = new["ckv"][:, 0], new["kr"][:, 0]
    scale = (cfg.qk_nope_head_dim + dr) ** -0.5
    args = (q, cache["ckv"], cache["kr"], cache["slot_pos"],
            cache["page_table"], pos)
    got = paged_mla_decode(*args, scale=scale, ckv_new=cn, kr_new=rn_)
    want = ref.paged_mla_decode_ref(q, plain, pos, scale=scale, ckv_new=cn,
                                    kr_new=rn_)
    err = max(max_err(a, b) for a, b in zip(got, want))
    require(all(close(a, b, F32_TOL) for a, b in zip(got, want)),
            f"paged_mla_decode bf16: {err}")
    mapped = int((cache["page_table"] >= 0).sum())
    valid = sum(lens) + len(lens)                # written + the fresh token
    B = len(lens)
    # the mapped blocks' latents and slot_pos, qcat, the fresh latents, the
    # page table and positions read once; the f32 partials written once
    nbytes = (mapped * bt * ((lat + dr) * 2 + 4) + 2 * B * H * (lat + dr)
              + 2 * B * (lat + dr) + 4 * B * (MB + 1) + 4 * B * H * (lat + 2))
    ops_ = 2 * valid * H * (lat + dr) + 2 * valid * H * lat
    bms, by = bound(nbytes, ops_)

    def library():
        """The gather, then one matmul / masked softmax / matmul chain over
        the gathered dense view (normalized output)."""
        view = kvcache.paged_view(plain)
        keys = torch.cat([view["ckv"], view["kr"]], -1)        # (B, W, 576)
        s = torch.matmul(q, keys.transpose(1, 2)) * scale      # (B, H, W)
        vm = decode_valid_mask(view["slot_pos"], pos, 0)
        s = s.masked_fill(~vm[:, None, :], float("-inf"))
        return torch.matmul(torch.softmax(s.float(), -1).to(q.dtype),
                            view["ckv"])
    rec = {"name": "paged_mla_decode", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/paged_mla_decode.cu",
           "replaces": "src/repro/kernels/paged_decode.py:322",
           "shape": {"B": B, "H": H, "lat": lat, "dr": dr, "bt": bt,
                     "MB": MB, "arena_blocks": NB, "mapped_blocks": mapped,
                     "valid": valid, "dtype": "bf16", "fused": True},
           "max_abs_err": err,
           "ms": timer(lambda: paged_mla_decode(*args, scale=scale,
                                                ckv_new=cn, kr_new=rn_)),
           "plain_ms": timer(lambda: ref.paged_mla_decode_ref(
               q, plain, pos, scale=scale, ckv_new=cn, kr_new=rn_)),
           "bound_ms": bms, "bound_by": by,
           "library_ms": timer(library),
           "library_call": "kvcache.paged_view gather + torch.matmul, "
                           "masked softmax, torch.matmul over the dense view "
                           "(normalized output)",
           "warm_ms": timer(lambda: paged_mla_decode(
               *args, scale=scale, ckv_new=cn, kr_new=rn_), cold=False),
           "cuda_core_f32_bound_ms": ops_ / CUDA_CORE_F32_OPS_PER_S * 1e3}
    emit({"phase": "kernel_bf16", **rec})
    return rec


def _mixtral():
    from repro_torch.configs import get_config
    return get_config("mixtral-8x7b")


def require_healthy(eng, phase: str) -> dict:
    """A fault-free engine's fault plane: the ladder at level 0 and, over
    the paged KV pool, its host tier pinned — so that a real demotion on
    the card (a refused pinned allocation) cannot pass unseen."""
    ft = eng.fault_traffic()
    require(ft["level"] == 0 and not ft["degradation_events"],
            f"{phase}: the degradation ladder moved: "
            f"{ft['degradation_events']}")
    if eng.ecfg.kv_paged:
        require(ft["host_tier_pinned"],
                f"{phase}: the KV host tier is not pinned")
    return {"host_tier_pinned": ft["host_tier_pinned"],
            "ladder_level": ft["level"]}


def serve_run(torch, np, eng, ops, prompt_lens, n_requests, seed,
              new_tokens=NEW_TOKENS, healthy=True):
    """Submit `n_requests` seeded prompts and run the engine until idle,
    with every kernel's launch count set to 0 just before and read just
    after, and admission prefill (monolithic, or the staged chunks of
    overlapped admission) timed apart (synchronized).  `new_tokens` is
    every request's quota, or a tuple of quotas the requests take in
    turn.  Checks that every request finished with in-range tokens, and
    (`healthy`, a fault-free engine) ``require_healthy``.  Returns the
    prompts, the numbers and the transcripts in submission order."""
    prefill_s = [0.0]
    step_name = "_prefill_chunk" if eng.ecfg.overlap else "_prefill"
    inner = getattr(eng, step_name)

    def timed_prefill(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(*args)
        torch.cuda.synchronize()
        prefill_s[0] += time.perf_counter() - t
        return out
    setattr(eng, step_name, timed_prefill)

    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt_lens[0], prompt_lens[1] + 1, n_requests)
    prompts = [rng.integers(2, eng.cfg.vocab_size, n) for n in lens]
    quotas = (new_tokens if isinstance(new_tokens, tuple)
              else (new_tokens,))
    quota = [quotas[i % len(quotas)] for i in range(n_requests)]
    rids = [eng.submit(p, q) for p, q in zip(prompts, quota)]
    torch.cuda.synchronize()
    tokens0, steps0 = eng.tokens_out, eng.steps
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    setattr(eng, step_name, inner)
    reqs = [eng.scheduler.requests[r] for r in rids]
    require(all(r.done and not r.aborted for r in reqs),
            "not every request finished")
    for r, q in zip(reqs, quota):
        toks = out[r.rid]
        require(len(toks) == q or (toks and toks[-1] == 1),
                f"request {r.rid}: {len(toks)} tokens")
        require(all(0 <= t < eng.cfg.vocab_size for t in toks),
                f"request {r.rid}: token out of range")
    decode_s = wall - prefill_s[0]
    tokens = eng.tokens_out - tokens0
    fault_plane = (require_healthy(eng, "serve_run") if healthy
                   else None)
    return prompts, {
        "requests": n_requests, "prompt_tokens": int(lens.sum()),
        "new_tokens_each": new_tokens, "decode_tokens": tokens,
        "engine_steps": eng.steps - steps0, "wall_s": wall,
        "prefill_s": prefill_s[0], "decode_s": decode_s,
        "decode_tok_per_s": tokens / decode_s,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches, "fault_plane": fault_plane}, \
        [out[r] for r in rids]


def phase_serve(torch, np, ops):
    from repro_torch.models.model import ExecPolicy
    from repro_torch.models.params import count_params, init_params
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = dataclasses.replace(_mixtral(), num_layers=LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(SEED),
                         device=DEVICE)
    eng = Engine(cfg, params, EngineConfig(**SERVE),
                 ExecPolicy(moe_impl="grouped", use_kernels=True),
                 device=DEVICE)
    prompts, res, outs = serve_run(torch, np, eng, ops, PROMPT_LENS,
                                   N_REQUESTS, SEED)
    emit({"phase": "serve", "model": "mixtral-8x7b", "layers": LAYERS,
          "of_layers": _mixtral().num_layers, "params": count_params(cfg),
          "engine": SERVE, **res})
    launches = res["launches"]
    require(all(launches[k] > 0 for k in
                ("moe_ffn", "gqa_decode", "flash_prefill")),
            f"a kernel of the dense path never launched: {launches}")
    res["device_kv_bytes"] = eng.kv_traffic()["device_kv_bytes"]
    return eng, prompts, launches, outs, res


def plan_decode(torch, cfg, params, prompt, policy, feed=None, tape=None,
                plan=None, steps=PLAN_STEPS):
    """``prompt`` (B, P): its first P - 1 tokens prefilled into a dense
    ring of ``PLAN_SLOTS`` (this rank's block of it under a ``plan`` over
    more than one rank, by the plan's cache specs), then ``steps`` greedy
    ``make_serve_step`` calls from its last token, each fed the step's own
    token (or ``feed``'s, to hold two paths on the same inputs), all under
    ``tape`` (a ``RoutingTape``) when given.  Returns (logits (steps, B,
    V), tokens (steps, B), decode seconds)."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import kvcache
    from repro_torch.models.model import forward
    from repro_torch.serving.steps import make_serve_step
    from repro_torch.training.optimizer import tree_map
    cache = kvcache.init_cache(cfg, prompt.shape[0], PLAN_SLOTS,
                               device=DEVICE)
    if plan is not None:            # this rank's block, contiguous
        cache = tree_map(
            lambda t: t.clone(memory_format=torch.contiguous_format),
            SH.shard_tree(cache, SH.cache_specs(
                cfg, cache, plan.dp_axes, plan.kv_axes, plan.rules,
                plan.mesh), plan.mesh))
    step = make_serve_step(cfg, policy)
    logits, toks = [], []
    with torch.no_grad(), (tape if tape is not None
                           else contextlib.nullcontext()):
        forward(cfg, params, prompt[:, :-1], cache=cache, mode="prefill",
                policy=policy)
        tok = prompt[:, -1:]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            nxt, lg, cache = step(params, cache, tok)
            logits.append(lg)
            toks.append(nxt)
            tok = (feed[i] if feed is not None else nxt)[:, None].long()
        torch.cuda.synchronize()
    return torch.stack(logits), torch.stack(toks), time.perf_counter() - t0


def phase_serve_plan(torch, np, ops, params):
    """``serve``'s 4-layer mixtral-8x7b weights (bf16, full width) decoded
    greedily through ``make_serve_step`` under the decode plans of two
    meshes of one rank on an nccl group: ("model",), whose plan runs the
    expert-parallel psum body (``ep_psum``), and ("data", "model"), whose
    plan runs the grouped MoE; both with the sequence-sharded decode
    attention (``gqa_decode`` partials, combined across the KV axes).  B
    ``PLAN_B`` prompts of ``PLAN_PROMPT`` tokens over a ring of
    ``PLAN_SLOTS``, ``PLAN_STEPS`` steps, at capacity ``PLAN_CF``.  Each
    plan against ``make_serve_step`` without a plan (the grouped MoE
    through the kernels): the same tokens, logits within ``LOGIT_TOL``
    (whether bit-equal printed), decode tok/s of both; the ("model",)
    plan's kernels against its ``impl="ref"`` form on the same inputs and
    routing (``RoutingTape``): in bf16 within ``LOGIT_TOL``, and at 1 layer
    in f32 within ``F32_TOL``.  Returns each plan run's launches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import ExecPolicy
    from repro_torch.models.params import init_params
    dist = nccl_group(torch)
    cfg = dataclasses.replace(_mixtral(), num_layers=LAYERS,
                              capacity_factor=PLAN_CF)
    shape = ShapeConfig("serve_plan", PLAN_SLOTS, PLAN_B, "decode")
    rng = np.random.default_rng(SEED + 40)
    prompt = torch.as_tensor(rng.integers(2, cfg.vocab_size,
                                          (PLAN_B, PLAN_PROMPT)),
                             device=DEVICE)
    base_logits, base_toks, base_s = plan_decode(
        torch, cfg, params, prompt, ExecPolicy(moe_impl="grouped",
                                               use_kernels=True))
    L, n = LAYERS, PLAN_STEPS
    expected = {"moe_ffn": L * (n + 1), "gqa_decode": L * n,
                "flash_prefill": L}
    launches, line = {}, {"phase": "serve_plan", "model": "mixtral-8x7b",
                          "layers": L, "of_layers": _mixtral().num_layers,
                          "batch": PLAN_B, "prompt": PLAN_PROMPT,
                          "ring": PLAN_SLOTS, "steps": n,
                          "capacity_factor": PLAN_CF,
                          "backend": dist.get_backend(),
                          "no_plan_decode_tok_per_s": PLAN_B * n / base_s}
    for sizes, names in (((1,), ("model",)), ((1, 1), ("data", "model"))):
        mesh = make_mesh(sizes, names)
        plan = SH.make_plan(cfg, shape, mesh, use_kernels=True)
        key = "mesh_" + "_".join(names)
        ops.reset_launch_counts()
        logits, toks, secs = plan_decode(torch, cfg, params, prompt,
                                         plan.policy)
        launches[f"serve_plan_{key}"] = ops.launch_counts()
        err = max_err(logits, base_logits)
        line[key] = {"moe_variant": plan.moe_variant,
                     "attn_fn": plan.policy.attn_fn is not None,
                     "kv_axes": plan.kv_axes, "dp_axes": plan.dp_axes,
                     "decode_tok_per_s": PLAN_B * n / secs,
                     "max_abs_err_vs_no_plan": err,
                     "bit_equal_to_no_plan": bool(torch.equal(logits,
                                                              base_logits)),
                     "tokens_equal": bool(torch.equal(toks, base_toks)),
                     "launches": launches[f"serve_plan_{key}"]}
        require(torch.isfinite(logits).all(), f"serve_plan {key}: logits")
        require(plan.policy.attn_fn is not None,
                f"serve_plan {key}: no sequence-sharded attention")
        require(torch.equal(toks, base_toks) and err <= LOGIT_TOL,
                f"serve_plan {key}: against no plan, tokens "
                f"{line[key]['tokens_equal']}, logits {err}")
        got = launches[f"serve_plan_{key}"]
        require(all(got[k] == v for k, v in expected.items()),
                f"serve_plan {key}: launched {got}, expected {expected}")
    require(line["mesh_model"]["moe_variant"] == "ep_psum"
            and line["mesh_data_model"]["moe_variant"] == "grouped_pjit",
            f"serve_plan: variants {line}")
    # the ("model",) plan's kernels against its plain form, same routing
    plan = SH.make_plan(cfg, shape, make_mesh((1,), ("model",)),
                        use_kernels=True)
    with_ref = dataclasses.replace(plan.policy, impl="ref")
    tape = RoutingTape()
    k_logits, k_toks, _ = plan_decode(torch, cfg, params, prompt,
                                      plan.policy, tape=tape)
    r_logits, _, _ = plan_decode(torch, cfg, params, prompt, with_ref,
                                 feed=k_toks, tape=RoutingTape(replay=tape))
    line["bf16_max_abs_err_kernels_vs_plain"] = max_err(k_logits, r_logits)
    del tape, k_logits, r_logits, base_logits
    gc.collect()
    torch.cuda.empty_cache()
    cfg1 = dataclasses.replace(cfg, num_layers=1, dtype="float32")
    p1 = init_params(cfg1, torch.Generator(device=DEVICE).manual_seed(
        SEED + 41), device=DEVICE)
    plan = SH.make_plan(cfg1, shape, make_mesh((1,), ("model",)),
                        use_kernels=True)
    tape = RoutingTape()
    k_logits, k_toks, _ = plan_decode(torch, cfg1, p1, prompt, plan.policy,
                                      tape=tape)
    r_logits, _, _ = plan_decode(
        torch, cfg1, p1, prompt, dataclasses.replace(plan.policy,
                                                     impl="ref"),
        feed=k_toks, tape=RoutingTape(replay=tape))
    line["f32_1_layer_max_abs_err_kernels_vs_plain"] = max_err(k_logits,
                                                               r_logits)
    line["f32_tol"], line["bf16_tol"] = F32_TOL, LOGIT_TOL
    line["expected_launches"] = expected
    line["card"] = card_line()
    emit(line)
    require(line["bf16_max_abs_err_kernels_vs_plain"] <= LOGIT_TOL,
            "serve_plan: bf16 kernels against the plain versions: "
            f"{line['bf16_max_abs_err_kernels_vs_plain']}")
    require(close(k_logits, r_logits, F32_TOL),
            "serve_plan: f32 kernels against the plain versions: "
            f"{line['f32_1_layer_max_abs_err_kernels_vs_plain']}")
    del p1, tape, k_logits, r_logits
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_serve_module(torch, np, ops, params, want, launches_serve):
    """``serve``'s weights, settings and requests with module-based
    batching (G = num_ubs = 2): one decode dispatch a window of both
    groups.  Its greedy transcripts must equal ``serve``'s token for token
    (every row computes as in its lockstep dispatch), with fewer
    ``moe_ffn`` launches (one a layer a window, not one a group)."""
    from repro_torch.models.model import ExecPolicy
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = dataclasses.replace(_mixtral(), num_layers=LAYERS)
    settings = {**SERVE, "module_batch": True}
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, EngineConfig(**settings),
                 ExecPolicy(moe_impl="grouped", use_kernels=True),
                 device=DEVICE)
    _, res, outs = serve_run(torch, np, eng, ops, PROMPT_LENS, N_REQUESTS,
                             SEED)
    launches = res["launches"]
    emit({"phase": "serve_module", "model": "mixtral-8x7b",
          "layers": LAYERS, "engine": settings, **res,
          "module_groups": eng.weight_traffic()["module_groups"],
          "moe_ffn_launches_serve": launches_serve["moe_ffn"],
          "identical_requests": sum(a == b for a, b in zip(outs, want)),
          "requests_total": len(want)})
    require(outs == want, "module-batched greedy transcripts differ from "
                          "serve's")
    require(all(launches[k] > 0 for k in
                ("moe_ffn", "gqa_decode", "flash_prefill")),
            f"a kernel of the module-batched path never launched: "
            f"{launches}")
    require(launches["moe_ffn"] < launches_serve["moe_ffn"],
            f"windows launched moe_ffn no fewer times: {launches}")
    return launches


def phase_serve_static(torch, np, ops, params, want):
    """``serve``'s weights, settings and requests in static mode
    (``serve_static``: Algorithm 2's micro-batches of 8, each prefilled 8
    rows at once and decoded one token a tick), then with module-batched
    windows of both micro-batches (``serve_static_module``), whose
    transcripts must equal lockstep static's bit for bit.  How many of the
    24 equal continuous ``serve``'s is printed, not required: static
    prefill runs 8 rows in one call, where a row's bits and the grouped
    MoE's capacity drops can differ.  Each micro-batch's first-token
    logits through the kernels are held against the plain
    path (``check_static_logits``)."""
    from repro_torch.models import kvcache
    from repro_torch.models.model import ExecPolicy
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = dataclasses.replace(_mixtral(), num_layers=LAYERS)
    pol = ExecPolicy(moe_impl="grouped", use_kernels=True)
    out = {}
    for phase, settings in (
            ("serve_static", SERVE_STATIC),
            ("serve_static_module", {**SERVE_STATIC, "module_batch": True})):
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(cfg, params, EngineConfig(**settings), pol,
                     device=DEVICE)
        batches = []
        inner = eng._prefill

        def recorded(p, toks, cache, lens, inner=inner, batches=batches):
            with RoutingTape() as tape:
                logits, cache = inner(p, toks, cache, lens)
            batches.append((toks.clone(), lens.clone(), logits.clone(),
                            tape))
            return logits, cache
        eng._prefill = recorded
        # a window whose groups are not ascending and consecutive copies
        # its batches' caches together (``concat_slot_caches``) and back
        concat, copied = kvcache.concat_slot_caches, [0]

        def counted(caches, concat=concat, copied=copied):
            copied[0] += 1
            return concat(caches)
        kvcache.concat_slot_caches = counted
        try:
            _, res, outs = serve_run(torch, np, eng, ops, PROMPT_LENS,
                                     N_REQUESTS, SEED)
        finally:
            kvcache.concat_slot_caches = concat
        launches = res["launches"]
        line = {"phase": phase, "model": "mixtral-8x7b", "layers": LAYERS,
                "engine": settings, **res, "micro_batches": len(batches),
                "window_copy": {"ticks": copied[0],
                                **window_copy_cost(torch, eng)},
                "module_groups": eng.weight_traffic()["module_groups"],
                "identical_requests_vs_serve": sum(
                    a == b for a, b in zip(outs, want)),
                "requests_total": len(want)}
        if phase == "serve_static":
            line.update(check_static_logits(torch, cfg, params, batches,
                                            settings["max_seq"]))
        else:
            line["identical_requests_vs_serve_static"] = sum(
                a == b for a, b in zip(outs, out["serve_static"][1]))
            require(outs == out["serve_static"][1],
                    "static windows' transcripts differ from lockstep "
                    "static's")
        emit(line)
        require(all(launches[k] > 0 for k in
                    ("moe_ffn", "gqa_decode", "flash_prefill")),
                f"a kernel of {phase} never launched: {launches}")
        out[phase] = (launches, outs)
    return {k: v[0] for k, v in out.items()}


def window_copy_cost(torch, eng):
    """What a static window's cache copy costs on `eng`'s rotation groups
    (the pool's rows of each, after its run): their caches concatenated
    and written back, as ``Engine._tick_static`` does for a window whose
    groups are not ascending and consecutive; CUDA events, the mean of 5
    after one warm-up.  Other windows are views of the pool, copied
    never."""
    from repro_torch.models import kvcache
    from repro_torch.serving import engine

    caches = [g.cache for g in eng.groups]
    ms = []
    for _ in range(6):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        dense = kvcache.concat_slot_caches(caches)
        for c, part in zip(caches, kvcache.split_slot_cache(dense,
                                                            len(caches))):
            engine._copy_into(c, part)
        ev[1].record()
        ev[1].synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    return {"ms_per_copy": statistics.mean(ms[1:]),
            "cache_bytes": sum(engine._nbytes(c) for c in caches)}


class RoutingTape:
    """``moe.route``'s decisions on a forward pass: recorded in call order
    (each layer's weights, experts and aux loss, with the grouped MoE's
    keep mask from ``moe.stage_bucket``), or, given a recorded tape,
    replayed so that another path takes the same experts and drops the
    same tokens."""

    def __init__(self, replay=None):
        self.entries = []
        self._replay = None if replay is None else iter(replay.entries)

    def __enter__(self):
        from repro_torch.models import moe
        self._moe = moe
        self._route, self._stage = moe.route, moe.stage_bucket

        def route(cfg, router_w, x, token_groups=None, aux_group=None):
            if self._replay is not None:
                return next(self._replay)["route"]
            out = self._route(cfg, router_w, x, token_groups, aux_group)
            self.entries.append({"route": out})
            return out

        def stage_bucket(dest, n_buckets, cap, groups=1):
            slot, keep = self._stage(dest, n_buckets, cap, groups)
            if self._replay is None:
                self.entries[-1]["keep"] = keep
            return slot, keep
        moe.route, moe.stage_bucket = route, stage_bucket
        return self

    def __exit__(self, *exc):
        self._moe.route, self._moe.stage_bucket = self._route, self._stage

    def moved_tokens(self, other, seq: int, lens):
        """Per batch row, over the layers: how many of its real tokens
        (position < its length) `other` routed to other experts (a top-k
        flip), and how many it routed alike but kept in other buckets (a
        capacity drop that moved)."""
        import torch
        B = lens.shape[0]
        real = torch.arange(seq, device=lens.device)[None, :] < lens[:, None]
        flipped = torch.zeros((B,), dtype=torch.int64, device=lens.device)
        dropped = torch.zeros_like(flipped)
        for a, b in zip(self.entries, other.entries):
            ia, ib = a["route"][1], b["route"][1]
            flip = (ia.sort(-1).values != ib.sort(-1).values).any(-1)
            ka = a["keep"].reshape(ia.shape)
            kb = b["keep"].reshape(ib.shape)
            kept_a = ia.masked_fill(~ka, -1).sort(-1).values
            kept_b = ib.masked_fill(~kb, -1).sort(-1).values
            drop = ~flip & (kept_a != kept_b).any(-1)
            flipped += (flip.reshape(B, seq) & real).sum(-1)
            dropped += (drop.reshape(B, seq) & real).sum(-1)
        return flipped, dropped


def check_static_logits(torch, cfg, params, batches, max_seq):
    """Each static micro-batch's first-token logits, as served, against
    the plain path (``impl="ref"``) on the same rows.  In float32 with a
    capacity factor of E / top_k, at which no expert bucket can overflow,
    the kernel and plain paths differ in summation order only: within
    ``F32_TOL``.  In bf16 at the served capacity, a rounding can flip a
    token's top-2 experts, or move which tokens a full bucket drops, and
    then a row's logits move by more than ``LOGIT_TOL``.  So the plain
    path is also run with the served prefill's routing replayed
    (``RoutingTape``): every row must then be within ``LOGIT_TOL`` of the
    served logits, and a row past ``LOGIT_TOL`` of the plain path's own
    routing must show the cause, a real token of it routed or dropped
    otherwise in some layer; those rows are printed with their counts."""
    from repro_torch.models import kvcache
    from repro_torch.models.model import ExecPolicy
    from repro_torch.serving import steps

    kern = ExecPolicy(moe_impl="grouped", use_kernels=True)
    plain = ExecPolicy(moe_impl="grouped", use_kernels=True, impl="ref")
    nd32 = dataclasses.replace(cfg, dtype="float32",
                               capacity_factor=cfg.num_experts / cfg.top_k)

    def to_f32(tree):
        return {k: to_f32(v) if isinstance(v, dict) else v.float()
                for k, v in tree.items()}
    p32 = to_f32(params)

    def first_logits(c, p, pol, toks, lens):
        cache = kvcache.init_cache(c, toks.shape[0], max_seq, device=DEVICE)
        return steps.make_prefill_fill_step(c, pol)(p, toks, cache, lens)[0]

    worst = {"float32": 0.0, "bfloat16_served": 0.0,
             "bfloat16_served_routing_replayed": 0.0}
    over, rows, moved_tokens = [], 0, 0
    for b, (toks, lens, logits, tape) in enumerate(batches):
        real = lens > 0
        require(bool(torch.isfinite(logits[real]).all())
                and logits.shape == (toks.shape[0], cfg.vocab_size),
                "bad first-token logits")
        worst["float32"] = max(worst["float32"], max_err(
            first_logits(nd32, p32, kern, toks, lens)[real],
            first_logits(nd32, p32, plain, toks, lens)[real]))
        with RoutingTape() as own:
            want = first_logits(cfg, params, plain, toks, lens)
        with RoutingTape(replay=tape):
            replayed = first_logits(cfg, params, plain, toks, lens)
        diff = (logits - want).abs().amax(-1)
        rdiff = (logits - replayed).abs().amax(-1)
        flipped, dropped = tape.moved_tokens(own, toks.shape[1], lens)
        moved_tokens += int((flipped + dropped).sum())
        worst["bfloat16_served"] = max(worst["bfloat16_served"],
                                       float(diff[real].max()))
        worst["bfloat16_served_routing_replayed"] = max(
            worst["bfloat16_served_routing_replayed"],
            float(rdiff[real].max()))
        for r in torch.nonzero(real & (diff > LOGIT_TOL)).flatten().tolist():
            over.append({"micro_batch": b, "row": r,
                         "prompt_tokens": int(lens[r]),
                         "diff": float(diff[r]),
                         "routing_replayed_diff": float(rdiff[r]),
                         "flipped_tokens": int(flipped[r]),
                         "drop_moved_tokens": int(dropped[r])})
        rows += int(real.sum())
    del p32
    torch.cuda.empty_cache()
    out = {"max_abs_first_logit_diff": worst, "f32_tol": F32_TOL,
           "logit_tol": LOGIT_TOL, "rows": rows,
           "real_tokens_routed_otherwise": moved_tokens,
           "bf16_rows_over_logit_tol": over}
    require(worst["float32"] <= F32_TOL,
            f"static first-token logits differ from the plain path in "
            f"float32: {out}")
    require(worst["bfloat16_served_routing_replayed"] <= LOGIT_TOL,
            f"static first-token logits differ from the plain path under "
            f"the served routing: {out}")
    require(all(o["flipped_tokens"] + o["drop_moved_tokens"] > 0
                for o in over),
            f"a static first-token row moved past LOGIT_TOL with the "
            f"plain path routing every token alike: {out}")
    return out


def phase_serve_static_paged(torch, np, ops, params, paged_outs):
    """Static mode over ``serve_paged``'s arena (r_c 0.4, whose floor in
    static mode is one micro-batch's worst case: 512 of the 1024 blocks)
    and prompts, 128 new tokens each: the 16 longest prompts come first
    (Algorithm 2), and two micro-batches of them outgrow the arena, so
    blocks spill.  Beside it
    a dense static engine of the same ring width on the same requests: how
    many transcripts the paged run shares with it, and how many begin
    with ``serve_paged``'s continuous transcript, is printed."""
    from repro_torch.models.model import ExecPolicy
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = dataclasses.replace(_mixtral(), num_layers=LAYERS)
    pol = ExecPolicy(moe_impl="grouped", use_kernels=True)
    settings = {**SERVE_PAGED, "mode": "static"}
    dense = {k: v for k, v in settings.items()
             if not k.startswith("kv_") and k != "block_tokens"}
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, EngineConfig(**settings), pol, device=DEVICE)
    _, res, outs = serve_run(torch, np, eng, ops, PAGED_PROMPT_LENS,
                             N_REQUESTS, SEED + 2, STATIC_PAGED_NEW_TOKENS)
    traffic = eng.kv_traffic()
    launches = res["launches"]
    ref = Engine(cfg, params, EngineConfig(**dense), pol, device=DEVICE)
    _, _, dense_outs = serve_run(torch, np, ref, ops, PAGED_PROMPT_LENS,
                                 N_REQUESTS, SEED + 2,
                                 STATIC_PAGED_NEW_TOKENS)
    emit({"phase": "serve_static_paged", "model": "mixtral-8x7b",
          "layers": LAYERS, "engine": settings, **res,
          "identical_requests_vs_dense_static": sum(
              a == b for a, b in zip(outs, dense_outs)),
          "identical_first_64_vs_serve_paged": sum(
              a[:NEW_TOKENS] == b for a, b in zip(outs, paged_outs)),
          "requests_total": len(outs), "kv_traffic": traffic})
    require(traffic["spills"] > 0,
            f"static mode never spilled the arena: {traffic}")
    require(traffic["peak_blocks_in_use"] <= traffic["device_blocks"],
            f"static admission overran the arena: {traffic}")
    require(all(launches[k] > 0 for k in
                ("moe_ffn", "paged_gqa_decode", "flash_prefill")),
            f"a kernel of the static paged path never launched: {launches}")
    require(launches["gqa_decode"] == 0,
            f"the static paged path ran the dense decode kernel: {launches}")
    return launches


def phase_check_static(torch, np, ops, cfg, params, prompts):
    """8 of ``serve``'s prompts x 16 tokens through a static resident
    engine, then ``check_layer_paged``: a static ``paged=True`` engine on
    the same weights packed whole-layer into page-locked stores (~11.6
    GB): its transcripts must equal the resident engine's bit for bit (the
    same kernels read the same bytes), and ``weight_traffic()`` must book
    the page-padded layers once a forward pass; and
    ``check_static_expert``: a static ``expert_paged=True`` engine at r_w
    0.25, with transcripts equal to the resident engine's and
    ``expert_gather`` launched."""
    from repro_torch.models.model import ExecPolicy
    from repro_torch.serving.engine import Engine, EngineConfig

    pol = ExecPolicy(moe_impl="grouped", use_kernels=True)

    def run(e):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rids = [e.submit(p, NEW_TOKENS // 4) for p in prompts]
        out = e.run_until_idle()
        torch.cuda.synchronize()
        return ([out[r] for r in rids], ops.launch_counts(),
                time.perf_counter() - t0)

    want, _, resident_s = run(Engine(cfg, params,
                                     EngineConfig(**SERVE_STATIC), pol,
                                     device=DEVICE))
    launches = {}
    for phase, extra in (("check_layer_paged", {"paged": True}),
                         ("check_static_expert",
                          {"expert_paged": True, "w_gpu_ratio": 0.25})):
        settings = {**SERVE_STATIC, **extra}
        t0 = time.perf_counter()
        e = Engine(cfg, params, EngineConfig(**settings), pol, device=DEVICE)
        pack_s = time.perf_counter() - t0
        try:
            stores = [*e.paged_blocks.pages.values(),
                      *e.paged_blocks.expert_pages.values()]
            got, launches[phase], wall = run(e)
            traffic = e.weight_traffic()
            line = {"phase": phase, "layers": cfg.num_layers,
                    "engine": settings, "requests": len(prompts),
                    "store_bytes": sum(t.nbytes for t in stores),
                    "stores_pinned": all(t.is_pinned() for t in stores),
                    "pack_s": pack_s, "wall_s": wall,
                    "resident_wall_s": resident_s,
                    "agree_tokens": sum(a == b for x, y in zip(got, want)
                                        for a, b in zip(x, y)),
                    "total_tokens": sum(len(x) for x in want),
                    "identical_requests": sum(
                        x == y for x, y in zip(got, want)),
                    "launches": launches[phase],
                    "weight_traffic": {k: traffic[k] for k in (
                        "mode", "fwd_passes", "h2d_bytes", "hits",
                        "misses", "prefetches") if k in traffic}}
            emit(line)
            require(line["stores_pinned"], f"{phase}: a pageable store")
            require_healthy(e, phase)
            require(got == want, f"{phase}: transcripts differ from the "
                                 "static resident engine's")
            if extra.get("paged"):
                per_pass = sum(t.nbytes for t in e.paged_blocks.pages.values())
                require(traffic["h2d_bytes"]
                        == traffic["fwd_passes"] * per_pass,
                        f"whole-layer bytes booked wrong: {traffic}")
            else:
                require(launches[phase]["expert_gather"] > 0,
                        f"static expert-paged never gathered: "
                        f"{launches[phase]}")
        finally:
            e.paged_blocks.release()
    return launches


def phase_sample(torch, np, ops, cfg, params, prompts):
    """Sampling at temperature 0.8: 8 of ``serve``'s prompts served twice
    with seed 0 (transcripts identical) and once with seed 1 (at least one
    token differs); then ``sample`` itself on one seeded logits row of 64
    entries expanded to 200 000 rows: the empirical frequencies within
    ``SAMPLE_FREQ_TOL`` of ``softmax(logits / T)``, and with ``top_k=8``
    no token outside the top 8 drawn."""
    from repro_torch.models.model import ExecPolicy
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.sampling import sample

    runs = []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for seed in (0, 0, 1):
        e = Engine(cfg, params, EngineConfig(
            **SERVE, temperature=SAMPLE_TEMPERATURE, seed=seed),
            ExecPolicy(moe_impl="grouped", use_kernels=True), device=DEVICE)
        rids = [e.submit(p, NEW_TOKENS // 4) for p in prompts]
        out = e.run_until_idle()
        runs.append([out[r] for r in rids])
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    row = torch.randn(64, generator=g, device=DEVICE) * 1.5
    rows = row.expand(SAMPLE_ROWS, 64).contiguous()
    want = torch.softmax(row / SAMPLE_TEMPERATURE, -1)
    toks = sample(rows, g, temperature=SAMPLE_TEMPERATURE)
    freq = torch.bincount(toks.long(), minlength=64).double() / SAMPLE_ROWS
    err = float((freq - want.double()).abs().max())
    top = sample(rows, g, temperature=SAMPLE_TEMPERATURE, top_k=8)
    kept = torch.topk(row, 8).indices
    outside = int((~torch.isin(top, kept.to(top.dtype))).sum())
    emit({"phase": "sample", "temperature": SAMPLE_TEMPERATURE,
          "requests": len(prompts),
          "seed0_runs_identical": runs[0] == runs[1],
          "seed1_tokens_differing": sum(
              a != b for x, y in zip(runs[0], runs[2])
              for a, b in zip(x, y)),
          "tokens": sum(len(x) for x in runs[0]),
          "rows": SAMPLE_ROWS, "max_abs_freq_err": err,
          "tol": SAMPLE_FREQ_TOL, "top_k": 8,
          "top_k_drawn_outside": outside,
          "top_k_distinct_drawn": int(torch.unique(top).numel()),
          "launches": launches})
    require(runs[0] == runs[1], "sampling did not reproduce from its seed")
    require(runs[2] != runs[0], "another seed drew the same transcripts")
    require(err <= SAMPLE_FREQ_TOL,
            f"sample frequencies off softmax(logits / T) by {err}")
    require(outside == 0, f"top_k=8 drew {outside} tokens outside the top 8")
    return launches


def phase_serve_layer_paged(torch, np, ops, records):
    """The paper's configuration: mixtral-8x7b at full width, 8 of its 32
    layers drawn on the card layer by layer into page-locked whole-layer
    stores (2.90 GB a layer), every layer streamed through the two-slot
    buffer each forward pass, static micro-batches of 32 through windows
    of both rotation groups (``SERVE_LAYER``): 64 requests of 32..256
    prompt tokens, 32 new tokens each.  Beside the serve numbers: the
    bytes the copies really moved (counted where the stream issues them)
    against ``weight_traffic()``, their rate over the run's wall time
    against this run's ``h2d_copy``, and the link bytes per token per
    layer.  Then a trace window; the stores are released after.  The
    stores must fit MemAvailable, read before they are drawn and printed
    beside the depth, by ``serve_expert``'s rule (``host_room``)."""
    from repro_torch.core import offload
    from repro_torch.models import model
    from repro_torch.models.model import ExecPolicy
    from repro_torch.models.params import count_params
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = dataclasses.replace(_mixtral(), num_layers=LAYER_PAGED_LAYERS)
    need = LAYER_PAGED_LAYERS * store_bytes_per_period(torch, split=False)
    avail = host_mem_available()
    require(need <= host_room(avail),
            f"MemAvailable {avail} does not hold {LAYER_PAGED_LAYERS} "
            f"whole layers ({need} bytes) with 20 % and 20 GiB to spare")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, pw, pin_s, build_s = draw_stores(torch, cfg, split=False)
    eng = Engine(cfg, params, EngineConfig(**SERVE_LAYER),
                 ExecPolicy(moe_impl="grouped", use_kernels=True),
                 device=DEVICE, paged_weights=pw)
    moved = {"bytes": 0, "copies": 0}
    issue = model._SpanStream._issue

    def counted_issue(self, layer):
        if layer < len(self.pages):
            moved["bytes"] += self.pages[layer].nbytes
            moved["copies"] += 1
        issue(self, layer)
    model._SpanStream._issue = counted_issue
    try:
        _, res, outs = serve_run(torch, np, eng, ops, LAYER_PROMPT_LENS,
                                 LAYER_REQUESTS, SEED + 10,
                                 LAYER_NEW_TOKENS)
    finally:
        model._SpanStream._issue = issue
    traffic = eng.weight_traffic()
    h2d = next(r for r in records if r["name"] == "expert_gather")[
        "bound_rates"]["h2d_GBps_measured"]
    tokens = sum(len(o) for o in outs)
    link = moved["bytes"] / res["wall_s"] / 1e9
    res.update(tokens=tokens, moved_bytes=moved["bytes"],
               bytes_per_token_layer=moved["bytes"] / tokens
               / cfg.num_layers)
    emit({"phase": "serve_layer_paged", "model": "mixtral-8x7b",
          "layers": cfg.num_layers, "of_layers": _mixtral().num_layers,
          "params": count_params(cfg), "engine": SERVE_LAYER,
          "page_elems": EngineConfig().page_elems, "mem_available": avail,
          "host_room": host_room(avail),
          "store_bytes": sum(t.nbytes for t in pw.pages.values()),
          "pinned_bytes": offload.pinned_bytes(), "pin_s": pin_s,
          "build_s": build_s, **res, "passes": traffic["fwd_passes"],
          "copies": moved["copies"], "link_GBps_over_wall": link,
          "h2d_copy_GBps": h2d, "link_over_h2d_copy": link / h2d,
          "wall_over_link_time": res["wall_s"]
          / (moved["bytes"] / (h2d * 1e9)),
          "host_peak_rss": host_peak_rss(), "weight_traffic": traffic})
    launches = res["launches"]
    require(moved["bytes"] == traffic["h2d_bytes"] > 0,
            f"the copies moved {moved['bytes']} bytes, "
            f"weight_traffic() booked {traffic['h2d_bytes']}")
    require(all(launches[k] > 0 for k in
                ("moe_ffn", "gqa_decode", "flash_prefill")),
            f"a kernel of the whole-layer path never launched: {launches}")
    phase_trace(torch, np, eng, "layer_paged", LAYER_PROMPT_LENS, 4, 4)
    pw.release()
    return launches, res


def phase_serve_paged(torch, np, ops, params):
    """The block-paged KV path at full width: spills, on-demand fetches and
    prefetches through the pinned host tier."""
    from repro_torch.models.model import ExecPolicy
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = dataclasses.replace(_mixtral(), num_layers=LAYERS)
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, EngineConfig(**SERVE_PAGED),
                 ExecPolicy(moe_impl="grouped", use_kernels=True),
                 device=DEVICE)
    # host-side cost of the paged control plane: executing the plans
    # (enqueueing the copies) and building + uploading the page tables
    host = {"kv_exec_s": 0.0, "kv_exec_calls": 0, "page_table_uploads": 0,
            "compose_s": 0.0}
    exec_, compose = eng._kv_exec, eng._compose_kv

    def timed_exec(ops_):
        t = time.perf_counter()
        exec_(ops_)
        host["kv_exec_s"] += time.perf_counter() - t
        host["kv_exec_calls"] += 1

    def timed_compose(*args):
        t = time.perf_counter()
        out = compose(*args)
        host["compose_s"] += time.perf_counter() - t
        host["page_table_uploads"] += 1
        return out
    eng._kv_exec, eng._compose_kv = timed_exec, timed_compose
    prompts, res, outs = serve_run(torch, np, eng, ops, PAGED_PROMPT_LENS,
                                   N_REQUESTS, SEED + 2)
    eng._kv_exec, eng._compose_kv = exec_, compose
    traffic = eng.kv_traffic()
    preempted = sum(r.preemptions for r in eng.scheduler.requests.values())
    res.update(arena_bytes=traffic["arena_bytes"],
               host_tier_bytes=kv_host_bytes(eng))
    emit({"phase": "serve_paged", "model": "mixtral-8x7b", "layers": LAYERS,
          "engine": SERVE_PAGED, **res, "preemptions": preempted,
          "dense_equiv_bytes": traffic["dense_equiv_bytes"],
          "h2d_bytes": traffic["h2d_bytes"], "d2h_bytes": traffic["d2h_bytes"],
          "host": host, "kv_traffic": traffic})
    launches = res["launches"]
    require(traffic["spills"] > 0 and traffic["misses"] > 0
            and traffic["prefetches"] > 0,
            f"the host tier was not exercised: {traffic}")
    require(all(launches[k] > 0 for k in
                ("moe_ffn", "paged_gqa_decode", "flash_prefill")),
            f"a kernel of the paged path never launched: {launches}")
    require(launches["gqa_decode"] == 0,
            f"the paged path ran the dense decode kernel: {launches}")
    return eng, launches, outs, res


def phase_serve_overlap(torch, np, ops, params, want):
    """``serve_paged``'s weights, settings and requests with overlapped
    chunked-prefill admission (chunks of 32 tokens, one a tick ahead of
    the decode chunks, each landing in the paged pool at once): the staged
    prefill seconds, the device time of the chunk attention (plain
    PyTorch in f32 over the whole 1024-slot ring, CUDA events around each
    call), and how many transcripts agree with ``serve_paged``'s (not
    required: the capacity-bucketed MoE drops other tokens in a 32-token
    chunk than in a whole prompt, and ``flash_prefill`` rounds P to bf16
    where the chunk attention does not).  Then the logits check below."""
    from repro_torch.models import attention
    from repro_torch.models.model import ExecPolicy
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = dataclasses.replace(_mixtral(), num_layers=LAYERS)
    settings = {**SERVE_PAGED, "overlap": True, "prefill_chunk": 32}
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, EngineConfig(**settings),
                 ExecPolicy(moe_impl="grouped", use_kernels=True),
                 device=DEVICE)
    timed = []
    inner = attention.chunk_attention_ring

    def timed_attention(*args, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = inner(*args, **kw)
        ev[1].record()
        timed.append(ev)
        return out
    attention.chunk_attention_ring = timed_attention
    try:
        prompts, res, outs = serve_run(torch, np, eng, ops,
                                       PAGED_PROMPT_LENS, N_REQUESTS,
                                       SEED + 2)
    finally:
        attention.chunk_attention_ring = inner
    chunk_ms = sum(a.elapsed_time(b) for a, b in timed)
    traffic = eng.kv_traffic()
    emit({"phase": "serve_overlap", "model": "mixtral-8x7b",
          "layers": LAYERS, "engine": settings, **res,
          "staged_prefill_s": res["prefill_s"],
          "chunk_attention_calls": len(timed),
          "chunk_attention_device_ms": chunk_ms,
          "preemptions": sum(r.preemptions
                             for r in eng.scheduler.requests.values()),
          "identical_requests_vs_serve_paged": sum(
              a == b for a, b in zip(outs, want)),
          "agree_tokens_vs_serve_paged": sum(
              x == y for a, b in zip(outs, want) for x, y in zip(a, b)),
          "requests_total": len(want), "kv_traffic": traffic})
    launches = res["launches"]
    require(all(launches[k] > 0 for k in ("moe_ffn", "paged_gqa_decode")),
            f"a kernel of the overlap path never launched: {launches}")
    phase_check_overlap(torch, cfg, params, prompts[:8], eng)
    # one chunk a tick admits a request of ~384 prompt tokens in ~12
    # ticks, while one decodes its 64 tokens in 8: about two requests hold
    # blocks at a time, under 60 of the 410, so the run above never
    # spills.  The host tier under staged admission is driven here: the
    # arena at its floor (one slot's 64 blocks) and 128 new tokens, so
    # that a decoding request and the staged one overflow it
    spill = {**settings, "kv_gpu_ratio": 0.0}
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, EngineConfig(**spill),
                 ExecPolicy(moe_impl="grouped", use_kernels=True),
                 device=DEVICE)
    _, res, _ = serve_run(torch, np, eng, ops, PAGED_PROMPT_LENS,
                          OVERLAP_SPILL_REQUESTS, SEED + 2,
                          OVERLAP_SPILL_NEW_TOKENS)
    traffic = eng.kv_traffic()
    emit({"phase": "serve_overlap_spill", "model": "mixtral-8x7b",
          "layers": LAYERS, "engine": spill, **res, "kv_traffic": traffic})
    require(traffic["spills"] > 0 and traffic["misses"] > 0,
            f"the host tier was not exercised under overlap: {traffic}")
    return launches


def phase_serve_budget(torch, np, ops, params, paged_res):
    """``serve_paged``'s weights, settings and prompts under EOS-aware
    reservations (``reserve_mode="ewma"``) with a tight per-group budget
    (``SERVE_BUDGET``): the EWMA of finished lengths under-reserves the
    long requests, so ``enforce_budget`` must preempt (recompute
    preemption) and the engine sweeps the preempted slots' blocks back to
    the arena; every request must still complete its quota."""
    from repro_torch.models.model import ExecPolicy
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.scheduler import SlotState

    cfg = dataclasses.replace(_mixtral(), num_layers=LAYERS)
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, EngineConfig(**SERVE_BUDGET),
                 ExecPolicy(moe_impl="grouped", use_kernels=True),
                 device=DEVICE)
    swept = {"blocks": 0, "slots": 0}
    sweep = eng._kv_sweep

    def counted_sweep():
        for grp in eng.scheduler.slots:
            for s in grp:
                n = eng._kv.n_mapped(eng._slot_of(s))
                if s.state is SlotState.FREE and n:
                    swept["blocks"] += n
                    swept["slots"] += 1
        sweep()
    eng._kv_sweep = counted_sweep
    try:
        _, res, _ = serve_run(torch, np, eng, ops, PAGED_PROMPT_LENS,
                              N_REQUESTS, SEED + 2, BUDGET_NEW_TOKENS)
    finally:
        eng._kv_sweep = sweep
    preempted = sum(r.preemptions for r in eng.scheduler.requests.values())
    emit({"phase": "serve_budget", "model": "mixtral-8x7b",
          "layers": LAYERS, "engine": SERVE_BUDGET, **res,
          "decode_tok_per_s_serve_paged": paged_res["decode_tok_per_s"],
          "preemptions": preempted, "swept": swept,
          "gen_len_ewma": eng.scheduler.gen_ewma.value,
          "kv_traffic": eng.kv_traffic()})
    launches = res["launches"]
    require(preempted > 0, "the tight budget never preempted")
    require(all(launches[k] > 0 for k in
                ("moe_ffn", "paged_gqa_decode", "flash_prefill")),
            f"a kernel of the budget path never launched: {launches}")
    return launches


def phase_check_overlap(torch, cfg, params, prompts, eng):
    """The logits at the end of chunked admissions (the engine's chunk
    widths, on a batch-1 scratch) against monolithic prefill of the same
    prompts.  Capacity-bucketed MoE drops tokens by how many share a
    call, so both sides run with a capacity factor of E / top_k, at which
    no expert bucket can overflow.  Held in float32 (the kernels' f32
    bodies), where the two differ only in summation order, within
    ``F32_TOL``.  In bf16, as served, the two round at other points
    (``flash_prefill`` rounds P, chunk attention does not; a product's
    bits change with its row count), and where a rounding flips a token's
    top-2 experts the logits move by more than ``LOGIT_TOL``.  How far one
    prompt's logits move under such a flip is measured by the kernel and
    plain paths of its monolithic prefill (two other roundings of the same
    prompt), so each prompt is held within ``max(LOGIT_TOL,
    FLIP_FACTOR x`` that distance``)``: a prompt that no flip moves, at
    ``LOGIT_TOL``."""
    from repro_torch.models import kvcache
    from repro_torch.models.model import ExecPolicy
    from repro_torch.serving import steps

    nd = dataclasses.replace(cfg, capacity_factor=cfg.num_experts
                             / cfg.top_k)
    max_seq = SERVE_PAGED["max_seq"]

    def prefill(c, p, pol, prompt, chunked):
        cache = kvcache.init_cache(c, 1, max_seq, device=DEVICE)
        if not chunked:
            return steps.make_prefill_fill_step(c, pol)(
                p, torch.as_tensor(prompt[None].astype("int32"),
                                   device=DEVICE), cache,
                torch.tensor([len(prompt)], dtype=torch.int32,
                             device=DEVICE))[0]
        step, t = steps.make_prefill_chunk(c, pol), 0
        while t < len(prompt):
            width = eng._chunk_bucket(len(prompt) - t)
            n = min(width, len(prompt) - t)
            toks = torch.zeros((1, width), dtype=torch.int32, device=DEVICE)
            toks[0, :n] = torch.as_tensor(prompt[t:t + n].astype("int32"))
            logits, cache = step(
                p, toks, cache,
                torch.tensor([n], dtype=torch.int32, device=DEVICE))
            t += n
        return logits

    def to_f32(tree):
        return {k: to_f32(v) if isinstance(v, dict) else v.float()
                for k, v in tree.items()}

    kern = ExecPolicy(moe_impl="grouped", use_kernels=True)
    plain = ExecPolicy(moe_impl="grouped", use_kernels=False, impl="ref")
    worst = {"float32": 0.0, "bfloat16": 0.0,
             "bfloat16_kernel_vs_plain": 0.0}
    per_prompt = []
    nd32, p32 = dataclasses.replace(nd, dtype="float32"), to_f32(params)
    for prompt in prompts:
        row = {"prompt_tokens": len(prompt)}
        for key, c, p in (("float32", nd32, p32), ("bfloat16", nd, params)):
            got = prefill(c, p, kern, prompt, True)
            want = prefill(c, p, kern, prompt, False)
            require(bool(torch.isfinite(got).all())
                    and got.shape == want.shape == (1, nd.vocab_size),
                    f"bad chunked-admission logits ({key})")
            row[key] = max_err(got, want)
        row["bfloat16_kernel_vs_plain"] = max_err(
            want, prefill(nd, params, plain, prompt, False))
        row["bfloat16_tol"] = max(LOGIT_TOL, FLIP_FACTOR
                                  * row["bfloat16_kernel_vs_plain"])
        for key in worst:
            worst[key] = max(worst[key], row[key])
        per_prompt.append(row)
    del p32
    torch.cuda.empty_cache()
    emit({"phase": "check_overlap", "prompts": len(prompts),
          "max_abs_logit_diff": worst, "f32_tol": F32_TOL,
          "logit_tol": LOGIT_TOL, "flip_factor": FLIP_FACTOR,
          "per_prompt": per_prompt})
    require(worst["float32"] <= F32_TOL,
            f"chunked admission logits differ from monolithic prefill in "
            f"float32: {worst}")
    require(all(r["bfloat16"] <= r["bfloat16_tol"] for r in per_prompt),
            f"chunked admission logits differ from monolithic prefill in "
            f"bf16: {per_prompt}")


def phase_trace(torch, np, eng, label, prompt_lens, n_requests,
                new_tokens=NEW_TOKENS // 4):
    """A separate, profiled serving window on an engine: device time by
    kernel family (copies between the arena and the host tier included)
    and the device's busy share of the window's wall time, profiler on.
    The serve phases' numbers are taken with the profiler off.  The
    windows are short (two decode chunks a group; one on the expert-paged
    paths): the profiler's processing takes several times the window.
    It records the device's activity only: every number here is read from
    it, and recording the host's operators too multiplied the processing
    and lengthened the window."""
    rng = np.random.default_rng(SEED + 1)
    for n in rng.integers(prompt_lens[0], prompt_lens[1] + 1, n_requests):
        eng.submit(rng.integers(2, eng.cfg.vocab_size, n), new_tokens)
    trace_window(torch, label, eng.run_until_idle, requests=n_requests,
                 new_tokens_each=new_tokens)


def trace_window(torch, label, run, **extra) -> None:
    """`run()` under torch.profiler (the device's activity only): device
    time by kernel family and the device's busy share of the window's wall
    time, emitted as a ``trace`` line with `extra`'s keys."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    families = {"moe_ffn": ("moe_flags", "moe_up", "moe_down", "moe_reduce"),
                "paged_mla_decode": ("mla_chunk", "mla_tc", "mla_combine"),
                "paged_gqa_decode": ("paged_chunk", "paged_tc",
                                     "paged_combine"),
                "gqa_decode": ("gqa_chunk", "gqa_tc", "gqa_combine"),
                "flash_prefill": ("flash_prefill",),
                "expert_gather": ("expert_gather_kernel",
                                  "expert_plan_kernel"),
                "matmul": ("gemm", "nvjet", "xmma", "cutlass", "splitk"),
                "memcpy_htod": ("Memcpy HtoD",),
                "memcpy_dtoh": ("Memcpy DtoH",)}
    ms = {k: 0.0 for k in (*families, "other")}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        fam = next((f for f, keys in families.items()
                    if any(k in ev.key for k in keys)), "other")
        ms[fam] += ev.self_device_time_total / 1e3
    device_ms = sum(ms.values())
    # device time sums over streams: where copies on a side stream overlap
    # kernels (the expert-paged path), it can exceed the wall time, so the
    # kernels' share is given apart
    kernel_ms = device_ms - ms["memcpy_htod"] - ms["memcpy_dtoh"]
    emit({"phase": "trace", "engine": label, **extra,
          "wall_ms": wall * 1e3, "device_ms": device_ms,
          "device_busy_share": device_ms / (wall * 1e3),
          "kernel_busy_share": kernel_ms / (wall * 1e3),
          "htod_busy_share": ms["memcpy_htod"] / (wall * 1e3),
          "device_ms_by_family": ms, "host_peak_rss": host_peak_rss()})


def paged_copy(torch, cfg, dense, rng):
    """A batch-1 paged layout of a dense prefilled cache: a fresh arena
    whose blocks for the row (those covering its prompt and its next
    token) sit at physical blocks scattered over the arena; the rings that
    stay dense (the prologue's) are copied."""
    from repro_torch.models import kvcache
    bt = SERVE_PAGED["block_tokens"]
    keys = kvcache.paged_period_keys(cfg)
    MB = dense[keys[0]]["slot_pos"].shape[-1] // bt
    nb = 4 * MB
    arena = kvcache.init_paged_arena(cfg, nb, bt, device=DEVICE)
    n = int(dense["pos"][0]) + 1
    pt = torch.full((1, MB), -1, dtype=torch.int32)
    pt[0, :-(-n // bt)] = torch.as_tensor(
        rng.permutation(nb)[:-(-n // bt)].astype("int32"))
    ptl = pt.to(DEVICE).expand((cfg.num_periods, 1, MB))
    cache = {k: (clone_cache(v) if isinstance(v, dict) else v.clone())
             for k, v in dense.items() if k not in arena}
    for key, g in arena.items():
        cache[key] = {**g, "page_table": ptl}
    return kvcache.insert_slot(cache, dense, 0)


def clone_cache(cache):
    return {k: (clone_cache(v) if isinstance(v, dict)
                else v if k == "page_table" else v.clone())
            for k, v in cache.items()}


def phase_check(torch, np, cfg, params, prompts, eng, eng_paged,
                phase="check"):
    """Prefill, decode and paged-decode logits of `prompts` through the
    kernels against the plain path (within ``LOGIT_TOL``), their greedy
    transcripts, and the paged engine's transcripts against the dense
    engine's on 8 more prompts (printed).  The prefill is held as
    ``check_static_logits`` holds it: the plain path also runs with the
    kernel path's routing replayed and must then be within ``LOGIT_TOL``;
    under its own routing a prompt past ``LOGIT_TOL`` must show the
    cause, a real token routed or dropped otherwise in some layer (a bf16
    rounding flips a near tie of the router; printed with its counts).
    Returns those prompts and the dense engine's transcripts."""
    from repro_torch.models import kvcache
    from repro_torch.models.model import ExecPolicy, forward, unembed
    from repro_torch.serving import steps

    worst = {"prefill": 0.0, "decode": 0.0, "decode_paged": 0.0}
    replayed_worst, over = 0.0, []
    agree, total = 0, 0
    rng = np.random.default_rng(SEED)
    for prompt in prompts:
        outs, tapes = {}, {}
        tok = torch.as_tensor(prompt[None].astype("int32"), device=DEVICE)
        lens = torch.tensor([len(prompt)], dtype=torch.int32, device=DEVICE)
        for impl, replay in (("auto", None), ("ref", None), ("ref", "auto")):
            pol = ExecPolicy(moe_impl="grouped", use_kernels=True, impl=impl)
            cache = kvcache.init_cache(cfg, 1, SERVE["max_seq"],
                                       device=DEVICE)
            with RoutingTape(replay=tapes.get(replay)) as tape:
                logits, cache = steps.make_prefill_fill_step(cfg, pol)(
                    params, tok, cache, lens)
            if replay:
                replayed = max_err(outs["auto"]["prefill"], logits)
            else:
                tapes[impl] = tape
                outs[impl] = {"prefill": logits, "cache": cache, "pol": pol}
        replayed_worst = max(replayed_worst, replayed)
        diff = max_err(outs["auto"]["prefill"], outs["ref"]["prefill"])
        if diff > LOGIT_TOL:
            flipped, dropped = tapes["auto"].moved_tokens(
                tapes["ref"], tok.shape[1], lens)
            over.append({"prompt_tokens": len(prompt), "diff": diff,
                         "routing_replayed_diff": replayed,
                         "flipped_tokens": int(flipped.sum()),
                         "drop_moved_tokens": int(dropped.sum())})
        # one decode step, both paths fed the kernel path's greedy token;
        # on the paged layout both read the same arena and page table
        first = torch.argmax(outs["auto"]["prefill"], -1).to(
            torch.int32)[:, None]
        paged = paged_copy(torch, cfg, outs["auto"]["cache"], rng)
        for impl, o in outs.items():
            fwd = forward(cfg, params, first, cache=clone_cache(paged),
                          mode="decode", policy=o["pol"])
            o["decode_paged"] = unembed(cfg, params, fwd["hidden"][:, -1])
            fwd = forward(cfg, params, first, cache=o["cache"], mode="decode",
                          policy=o["pol"])
            o["decode"] = unembed(cfg, params, fwd["hidden"][:, -1])
        for key in worst:
            a, b = outs["auto"][key], outs["ref"][key]
            require(bool(torch.isfinite(a).all()) and a.shape == b.shape
                    == (1, cfg.vocab_size), f"bad {key} logits")
            worst[key] = max(worst[key], max_err(a, b))
        # greedy transcripts of 16 tokens from each path's own caches
        seqs = {}
        for impl, o in outs.items():
            tok = torch.argmax(o["decode"], -1).to(torch.int32)[:, None]
            chunk = steps.make_decode_chunk(cfg, o["pol"], eos_id=-1,
                                            chunk=16)
            _, _, _, _, toks, _ = chunk(
                params, o["cache"], tok,
                torch.ones(1, dtype=torch.bool, device=DEVICE),
                torch.full((1,), 16, dtype=torch.int32, device=DEVICE))
            seqs[impl] = toks[:, 0].tolist()
        agree += sum(a == b for a, b in zip(seqs["auto"], seqs["ref"]))
        total += len(seqs["auto"])
    # the paged engine against the dense engine, same prompts and weights
    prng = np.random.default_rng(SEED + 3)
    engine_prompts = [prng.integers(2, cfg.vocab_size, n) for n in
                      prng.integers(PAGED_PROMPT_LENS[0],
                                    SERVE["max_seq"] - NEW_TOKENS, 8)]
    runs = []
    for e in (eng, eng_paged):
        rids = [e.submit(p, NEW_TOKENS // 4) for p in engine_prompts]
        out = e.run_until_idle()
        runs.append([out[r] for r in rids])
    eng_agree = sum(a == b for x, y in zip(*runs) for a, b in zip(x, y))
    eng_total = sum(len(x) for x in runs[0])
    emit({"phase": phase, "prompts": len(prompts),
          "engine_prompts": len(engine_prompts),
          "max_abs_logit_diff": worst, "tol": LOGIT_TOL,
          "prefill_routing_replayed_max_abs_logit_diff": replayed_worst,
          "prefill_over_tol": over,
          "greedy_agree": agree, "greedy_total": total,
          "paged_vs_dense_engine_agree": eng_agree,
          "paged_vs_dense_engine_total": eng_total,
          "paged_vs_dense_engine_identical_requests": sum(
              x == y for x, y in zip(*runs))})
    require(replayed_worst <= LOGIT_TOL
            and worst["decode"] <= LOGIT_TOL
            and worst["decode_paged"] <= LOGIT_TOL,
            f"kernel path logits differ from the plain path: {worst}, "
            f"prefill under the kernel path's routing {replayed_worst}")
    require(all(o["flipped_tokens"] + o["drop_moved_tokens"] > 0
                for o in over),
            f"a prefill moved past LOGIT_TOL with the plain path routing "
            f"every token alike: {over}")
    return engine_prompts, runs[0]


def pack_expert_stores(torch, eng) -> dict:
    """`eng`'s blocks packed into pinned expert-paged host stores."""
    from repro_torch.core import paging
    from repro_torch.serving.engine import EngineConfig

    t0 = time.perf_counter()
    pw = paging.pack_block_groups_split(
        eng.params["blocks"], EngineConfig().page_elems, torch.device(DEVICE))
    return {"pw": pw, "pack_s": time.perf_counter() - t0}


def phase_check_expert(torch, np, eng, engine_prompts, want,
                       phase="check_expert", extra=None, stores=None):
    """The expert-paged engine on the dense engine's weights (4 layers,
    packed into pinned host stores — `stores` from ``pack_expert_stores``,
    kept, or packed here and released after; a pool of r_w 0.25 of the 32
    spans), grouped moe_ffn: its greedy transcripts on the check phase's
    prompts must equal `want` (the dense engine's) token for token.
    Returns them."""
    from repro_torch.core import offload
    from repro_torch.models.model import ExecPolicy
    from repro_torch.serving.engine import Engine, EngineConfig

    settings = {**SERVE, "expert_paged": True, "w_gpu_ratio": 0.25}
    ecfg = EngineConfig(**settings)
    t0 = time.perf_counter()
    e = Engine(eng.cfg, eng.params, ecfg,
               ExecPolicy(moe_impl="grouped", use_kernels=True),
               device=DEVICE,
               paged_weights=stores["pw"] if stores else None)
    pack_s = (stores["pack_s"] if stores else time.perf_counter() - t0)
    try:
        rids = [e.submit(p, NEW_TOKENS // 4) for p in engine_prompts]
        out = e.run_until_idle()
        got = [out[r] for r in rids]
        agree = sum(a == b for x, y in zip(got, want) for a, b in zip(x, y))
        traffic = e.weight_traffic()
        emit({"phase": phase, "layers": eng.cfg.num_layers,
              "engine": settings, **(extra(got) if extra else {}),
              "pool_spans": sum(r.capacity for r in e.residency.values()),
              "pinned_bytes": offload.pinned_bytes(), "pack_s": pack_s,
              "requests": len(rids),
              "expert_vs_dense_engine_agree": agree,
              "expert_vs_dense_engine_total": sum(len(x) for x in want),
              "identical_requests": sum(x == y for x, y in zip(got, want)),
              "weight_traffic": {k: traffic[k] for k in (
                  "hits", "misses", "prefetches", "predicted_prefetches",
                  "evictions", "h2d_bytes")}})
        require(got == want, "expert-paged greedy transcripts differ from "
                             "the dense engine's")
        require_healthy(e, phase)
    finally:
        if stores is None:
            e.paged_blocks.release()
    return got


def phase_check_expert_kv(torch, np, ops, eng, stores):
    """Both offload paths at once on the 4-layer ``serve`` weights: packed
    into pinned host stores (``check_expert``'s `stores`, kept) and served
    expert-paged (a pool of r_w 0.25)
    over ``serve_paged``'s block-paged arena (r_c 0.4), in lockstep, on
    ``CHECK_KV_REQUESTS`` prompts that overflow the arena.  A fresh engine
    with ``serve_paged``'s settings serves the same prompts first.  The
    greedy transcripts must be equal token for token, and so must the
    whole ``kv_traffic()`` (expert paging does not touch the KV plan);
    the arena must spill, the pool must miss, and the run must launch
    ``moe_ffn``, ``paged_gqa_decode``, ``expert_gather`` and
    ``flash_prefill``."""
    from repro_torch.models.model import ExecPolicy
    from repro_torch.serving.engine import Engine, EngineConfig

    rng = np.random.default_rng(SEED + 9)
    lens = rng.integers(CHECK_KV_PROMPT_LENS[0], CHECK_KV_PROMPT_LENS[1] + 1,
                        CHECK_KV_REQUESTS)
    prompts = [rng.integers(2, eng.cfg.vocab_size, n) for n in lens]
    settings = {**SERVE_PAGED, "expert_paged": True, "w_gpu_ratio": 0.25}
    runs = {}
    for name, st in (("kv", SERVE_PAGED), ("expert_kv", settings)):
        e = Engine(eng.cfg, eng.params, EngineConfig(**st),
                   ExecPolicy(moe_impl="grouped", use_kernels=True),
                   device=DEVICE, paged_weights=(
                       stores["pw"] if st.get("expert_paged") else None))
        try:
            rids = [e.submit(p, NEW_TOKENS // 4) for p in prompts]
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            out = e.run_until_idle()
            torch.cuda.synchronize()
            runs[name] = {
                "out": [out[r] for r in rids],
                "wall_s": time.perf_counter() - t0,
                "launches": ops.launch_counts(),
                "done": all(e.scheduler.requests[r].done for r in rids),
                "preemptions": sum(e.scheduler.requests[r].preemptions
                                   for r in rids),
                "kv_traffic": e.kv_traffic(),
                "weight_traffic": e.weight_traffic(),
                "fault_plane": require_healthy(e, "check_expert_kv")}
        finally:
            del e
    kv, pair = runs["kv"], runs["expert_kv"]
    w = pair["weight_traffic"]
    emit({"phase": "check_expert_kv", "layers": eng.cfg.num_layers,
          "engine": settings, "requests": len(prompts),
          "prompt_tokens": int(lens.sum()),
          "new_tokens_each": NEW_TOKENS // 4,
          "identical_requests": sum(a == b for a, b in
                                    zip(pair["out"], kv["out"])),
          "agree_tokens": sum(x == y for a, b in zip(pair["out"], kv["out"])
                              for x, y in zip(a, b)),
          "total_tokens": sum(len(a) for a in kv["out"]),
          "kv_traffic_equal": pair["kv_traffic"] == kv["kv_traffic"],
          "wall_s": [kv["wall_s"], pair["wall_s"]],
          "preemptions": [kv["preemptions"], pair["preemptions"]],
          "launches": pair["launches"],
          "fault_plane": pair["fault_plane"],
          "kv_traffic": pair["kv_traffic"],
          "weight_traffic": {k: w[k] for k in (
              "hits", "misses", "prefetches", "evictions", "h2d_bytes")}})
    require(kv["done"] and pair["done"], "not every request finished")
    require(pair["out"] == kv["out"], "expert-paged + KV-paged greedy "
                                      "transcripts differ from the "
                                      "KV-paged engine's")
    require(pair["kv_traffic"] == kv["kv_traffic"],
            "expert paging changed the KV plan")
    require(pair["kv_traffic"]["spills"] > 0 and w["misses"] > 0,
            f"an offload tier was not exercised: {pair['kv_traffic']}")
    launches = pair["launches"]
    require(all(launches[k] > 0 for k in ("moe_ffn", "paged_gqa_decode",
                                          "expert_gather", "flash_prefill")),
            f"a kernel of the two-tier path never launched: {launches}")
    return launches


# ------------------------------------------------------------ fault plane

def chaos_plan(np, faults, seed: int, max_retries: int):
    """One seeded schedule over all seven fault sites (``tests/
    test_chaos.py``'s): probabilistic faults everywhere plus a scripted
    burst drawn from the seed — a ``kv_pool`` burst cut to `max_retries`
    refusals, so that it never falls through to a preemption."""
    rng = np.random.default_rng(seed)
    sites = ("kv_spill", "kv_fetch", "kv_pool", "expert_copy", "plan_drain",
             "host_alloc", "dispatch")
    site = sites[int(rng.integers(0, len(sites)))]
    kind = ("fail", "stall", "partial", "exhaust")[int(rng.integers(0, 4))]
    after, count = int(rng.integers(0, 10)), int(rng.integers(1, 6))
    if site == "kv_pool":
        count = min(count, max_retries)
    return faults.FaultPlan(
        seed=seed,
        probs={"*": {"fail": 0.06, "stall": 0.04, "partial": 0.04,
                     "exhaust": 0.03, "hostmem": 0.01}},
        trace=[faults.FaultEvent(site, kind, after=after, count=count)],
        stall_ms=float(rng.integers(50, 5000)),
        max_faults=int(rng.integers(40, 200)))


def tier_leaves(eng):
    return [t for g in eng._kv_host.values() for t in g.values()]


def watch_tier(eng, log: list) -> None:
    """Record the KV host tier's state after every demotion and
    re-promotion: the engine's flag and every leaf's ``is_pinned()``."""
    demote, repromote = eng._demote_host_tier, eng._repromote_host_tier

    def note(what, fn):
        def wrapped():
            fn()
            leaves = tier_leaves(eng)
            log.append({"after": what, "step": eng.steps,
                        "host_tier_pinned":
                            eng.fault_traffic()["host_tier_pinned"],
                        "leaves_pinned": sum(t.is_pinned() for t in leaves),
                        "leaves": len(leaves)})
        return wrapped
    eng._demote_host_tier = note("demote", demote)
    eng._repromote_host_tier = note("repromote", repromote)


def kv_fetch_cost(torch, e, n: int = 64) -> dict:
    """Seconds a KV block fetch takes from the pinned host tier and, after
    a demotion, from the pageable one (n blocks each, synchronized); then
    the tier is re-promoted.  Each fetch copies host block i into arena
    block i (the engine is idle: no block is live)."""
    n = min(n, e._kv.device_blocks)

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            e._kv_fetch_op(i, i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    timed()                                   # warm
    pinned = timed()
    e._demote_host_tier()
    demoted = all(not t.is_pinned() for t in tier_leaves(e))
    pageable = timed()
    e._repromote_host_tier()
    repinned = all(t.is_pinned() for t in tier_leaves(e))
    return {"blocks": n, "block_bytes": e._kv.block_bytes,
            "pinned_ms": pinned * 1e3, "pageable_ms": pageable * 1e3,
            "pageable_over_pinned": pageable / pinned,
            "demoted_unpinned": demoted, "repromoted_pinned": repinned}


def phase_chaos(torch, np, ops, eng, stores):
    """The fault plane on the card, over the 4-layer ``serve`` weights and
    ``check_expert``'s pinned stores: regimes (a) ``CHAOS_KV`` and (b)
    ``CHAOS_EXPERT``, each a fault-free run and the seeded schedules of
    ``CHAOS_SEEDS`` (the dispatch watchdog on the real clock in every
    run); (b) also the p 0.9 ``expert_copy`` burst and a second wave;
    then an engine whose pinned KV tier is refused at construction.  Every
    faulted run must give its regime's fault-free transcripts bit for bit,
    with 0 preemptions, spills, injected faults, the BlockPool's
    invariants and residency within capacity; the burst must walk the
    ladder to ``admission_shed`` and back to healthy, the KV tier unpinned
    (flag and every leaf) while demoted and pinned again after.  Returns
    the phase's launches (every run's, summed)."""
    from repro_torch.models.model import ExecPolicy
    from repro_torch.runtime import faults
    from repro_torch.serving.engine import Engine, EngineConfig

    pol = ExecPolicy(moe_impl="grouped", use_kernels=True)
    total = {}

    def make(settings, **kw):
        return Engine(eng.cfg, eng.params, EngineConfig(**settings, **kw),
                      pol, device=DEVICE, paged_weights=(
                          stores["pw"] if settings.get("expert_paged")
                          else None))

    def run(e, seed, label):
        _, res, outs = serve_run(torch, np, e, ops, CHAOS_PROMPT_LENS,
                                 CHAOS_REQUESTS, seed,
                                 new_tokens=CHAOS_NEW_TOKENS, healthy=False)
        for k, v in res["launches"].items():
            total[k] = total.get(k, 0) + v
        kv = e.kv_traffic()
        ft = e.fault_traffic()
        e._kv.check_invariants()
        preempted = sum(r.preemptions
                        for r in e.scheduler.requests.values())
        require(preempted == 0, f"chaos {label}: {preempted} preemptions")
        require(kv["spills"] > 0, f"chaos {label}: the arena never spilled")
        for r in e.residency.values():
            require(r.occupancy() <= r.capacity,
                    f"chaos {label}: residency over capacity")
        require(ft["host_tier_pinned"] or any(
            x["to"] == "pageable_host" for x in ft["degradation_events"]),
            f"chaos {label}: the tier is pageable without a ladder event")
        line = {"run": label, "decode_tok_per_s": res["decode_tok_per_s"],
                "wall_s": res["wall_s"], "decode_tokens": res["decode_tokens"],
                "spills": kv["spills"], "misses": kv["misses"],
                "launches": res["launches"],
                **{k: ft[k] for k in (
                    "injected_total", "injected", "retries", "aborts",
                    "stalls", "hostmem_faults", "dispatch_slow_steps",
                    "shed_requests", "host_tier_pinned", "level_name",
                    "module_groups_now", "predict_suspended")},
                "ladder_events": [(x["tick"], x["direction"], x["to"],
                                   x["reason"])
                                  for x in ft["degradation_events"]]}
        if e.residency:
            w = e.weight_traffic()
            line["expert_misses"] = w["misses"]
            line["expert_prefetches"] = w["prefetches"]
        return outs, line, ft

    regimes = {}
    for name, settings in (("kv_paged", CHAOS_KV),
                           ("expert_module_kv", CHAOS_EXPERT)):
        seed = SEED + 13
        e = make(settings)
        runs = []
        if name == "kv_paged":
            # the phase's first engine: one wave warms the shapes first
            # (prefill ran 2x slower in it), and must serve the same
            warm, line, _ = run(e, seed, "fault_free_warm")
            runs.append(line)
        base, base_line, ft = run(e, seed, "fault_free")
        require(ft["injected_total"] == 0, "a fault-free run injected")
        require(name != "kv_paged" or base == warm,
                "the fault-free engine served one wave twice differently")
        runs.append(base_line)
        fetch_cost = None
        if name == "kv_paged":
            # after the run: what a demotion costs a block fetch
            fetch_cost = kv_fetch_cost(torch, e)
            require(fetch_cost["demoted_unpinned"]
                    and fetch_cost["repromoted_pinned"],
                    f"chaos: demotion / re-promotion: {fetch_cost}")
        later = []
        if name == "expert_module_kv":
            # the burst's later waves, fault-free, from the same engine
            for w in range(1, CHAOS_BURST["waves"]):
                outs, line, _ = run(e, seed + w, f"fault_free_wave{w + 1}")
                later.append(outs)
                runs.append(line)
        del e
        for fseed in CHAOS_SEEDS:
            e = make(settings, fault_plan=chaos_plan(
                np, faults, fseed, EngineConfig().max_retries),
                degrade_down_after=2, degrade_up_after=5)
            outs, line, ft = run(e, seed, f"seed{fseed}")
            line["fault_seed"] = fseed
            runs.append(line)
            require(outs == base, f"chaos {name} seed {fseed}: transcripts "
                                  "differ from the fault-free run's")
            require(ft["injected_total"] > 0,
                    f"chaos {name} seed {fseed}: nothing was injected")
            del e
        burst = None
        if name == "expert_module_kv":
            b = CHAOS_BURST
            e = make(settings, fault_plan=faults.FaultPlan(
                seed=0, probs={"expert_copy": b["p"]},
                max_faults=b["max_faults"]),
                degrade_down_after=b["down_after"],
                degrade_up_after=b["up_after"])
            tier_log = []
            watch_tier(e, tier_log)
            outs, line, ft1 = run(e, seed, "burst")
            runs.append(line)
            require(outs == base, "chaos burst: transcripts differ from the "
                                  "fault-free run's")
            require(ft1["injected_total"] == b["max_faults"],
                    f"chaos burst: {ft1['injected_total']} of "
                    f"{b['max_faults']} faults spent in the first wave")
            downs = {x["to"] for x in ft1["degradation_events"]
                     if x["direction"] == "down"}
            require(downs == set(faults.LADDER_LEVELS[1:]),
                    f"chaos burst: the ladder reached only {sorted(downs)}")
            require(ft1["shed_requests"] == 0, "chaos burst: shed work")
            for w, want in enumerate(later, 1):
                outs, line, ft = run(e, seed + w, f"burst_wave{w + 1}")
                runs.append(line)
                require(outs == want, f"chaos burst: wave {w + 1}'s "
                                      "transcripts differ from the "
                                      "fault-free engine's")
            ups = [x for x in ft["degradation_events"]
                   if x["direction"] == "up"]
            downs = [x for x in ft["degradation_events"]
                     if x["direction"] == "down"]
            require(ft["level_name"] == "healthy" and len(ups) == len(downs),
                    f"chaos burst: the ladder did not come back: "
                    f"{ft['degradation_events']}")
            require(e._mg == e._mg_base and not e._degraded_no_predict
                    and e.scheduler.shed_priority is None
                    and all(r.limit is None for r in e.residency.values()),
                    "chaos burst: a degraded-mode flag stayed set")
            demoted = [x for x in tier_log if x["after"] == "demote"]
            repinned = [x for x in tier_log if x["after"] == "repromote"]
            require(demoted and all(not x["host_tier_pinned"]
                                    and x["leaves_pinned"] == 0
                                    for x in demoted),
                    f"chaos burst: the tier was not unpinned: {tier_log}")
            require(repinned and repinned[-1]["host_tier_pinned"]
                    and repinned[-1]["leaves_pinned"]
                    == repinned[-1]["leaves"]
                    and ft["host_tier_pinned"],
                    f"chaos burst: the tier was not pinned again: {tier_log}")
            burst = {"tier": tier_log, "ladder_events": line[
                "ladder_events"]}
            del e
        gc.collect()
        torch.cuda.empty_cache()
        regimes[name] = base
        emit({"phase": "chaos", "regime": name, "engine": settings,
              "requests": CHAOS_REQUESTS, "prompt_lens": CHAOS_PROMPT_LENS,
              "new_tokens_each": CHAOS_NEW_TOKENS, "runs": runs,
              "burst": burst, "kv_fetch_cost": fetch_cost})

    # the pinned tier refused at construction: pageable first, re-pinned
    # once the ladder climbs back (up_after 4 healthy ops)
    e = make(CHAOS_KV, fault_plan=faults.FaultPlan(trace=[
        faults.FaultEvent("host_alloc", "hostmem", after=0, count=1)]),
        degrade_up_after=4)
    start = {"host_tier_pinned": e.fault_traffic()["host_tier_pinned"],
             "leaves_pinned": sum(t.is_pinned() for t in tier_leaves(e))}
    require(not start["host_tier_pinned"] and start["leaves_pinned"] == 0,
            f"chaos host_alloc: the refused tier is pinned: {start}")
    outs, line, ft = run(e, SEED + 13, "host_alloc_refused")
    leaves = tier_leaves(e)
    end = {"host_tier_pinned": ft["host_tier_pinned"],
           "leaves_pinned": sum(t.is_pinned() for t in leaves),
           "leaves": len(leaves)}
    emit({"phase": "chaos", "regime": "host_alloc_refused",
          "engine": CHAOS_KV, "start": start, "end": end, "run": line})
    require(outs == regimes["kv_paged"], "chaos host_alloc: transcripts "
                                         "differ from the fault-free run's")
    require(ft["injected"] == {"host_alloc/hostmem": 1}
            and ft["level_name"] == "healthy" and ft["promotions"] >= 1,
            f"chaos host_alloc: the ladder did not climb back: {line}")
    require(end["host_tier_pinned"] and end["leaves_pinned"] == len(leaves),
            f"chaos host_alloc: the tier was not pinned again: {end}")
    del e
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "chaos", "launches": total})
    require(all(total.get(k, 0) > 0 for k in (
        "moe_ffn", "paged_gqa_decode", "expert_gather")),
        f"a kernel of the fault plane's paths never launched: {total}")
    return total

def _mixtral_int8(layers: int):
    """mixtral-8x7b with int8 expert weights and int8 KV (the model
    config's ``expert_dtype`` / ``kv_dtype``, as the JAX tests set them),
    cut to `layers`."""
    return dataclasses.replace(_mixtral(), num_layers=layers,
                               expert_dtype="int8", kv_dtype="int8")


def kv_host_bytes(eng) -> int:
    """Bytes of a KV-paged engine's pinned host tier."""
    return sum(a.nbytes for g in eng._kv_host.values() for a in g.values())


def phase_serve_int8(torch, np, ops, serve_res):
    """``serve`` with int8 expert weights and int8 KV: mixtral-8x7b at
    full width, 4 layers, every weight on the card (drawn from ``SEED``
    as ``init_params`` draws int8 leaves), ``serve``'s 24 requests over
    the dense int8 ring.  Every moe_ffn and gqa_decode launch of the run
    takes the kernels' int8 paths.  Returns the engine, its prompts,
    launches and transcripts."""
    from repro_torch.models.model import ExecPolicy
    from repro_torch.models.params import count_params, init_params
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = _mixtral_int8(LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(SEED),
                         device=DEVICE)
    eng = Engine(cfg, params, EngineConfig(**SERVE),
                 ExecPolicy(moe_impl="grouped", use_kernels=True),
                 device=DEVICE)
    prompts, res, outs = serve_run(torch, np, eng, ops, PROMPT_LENS,
                                   N_REQUESTS, SEED)
    kv = eng.kv_traffic()
    launches = res["launches"]
    emit({"phase": "serve_int8", "model": "mixtral-8x7b", "layers": LAYERS,
          "of_layers": _mixtral().num_layers, "params": count_params(cfg),
          "expert_dtype": "int8", "kv_dtype": "int8", "engine": SERVE, **res,
          "int8_launches": {k: launches[k] for k in ("moe_ffn",
                                                     "gqa_decode")},
          "device_kv_bytes": kv["device_kv_bytes"],
          "serve_device_kv_bytes": serve_res["device_kv_bytes"],
          "decode_tok_per_s_serve": serve_res["decode_tok_per_s"]})
    require(all(launches[k] > 0 for k in
                ("moe_ffn", "gqa_decode", "flash_prefill")),
            f"a kernel of the int8 path never launched: {launches}")
    return eng, prompts, launches, outs


def phase_serve_paged_int8(torch, np, ops, params, paged_res):
    """``serve_int8``'s weights over ``serve_paged``'s arena and pinned
    host tier (r_c 0.4, 24 requests of 128..640 x 64): the arena and the
    tier hold int8 rows and their f32 scales.  Spills, misses and
    prefetches must all happen; the device and host-tier KV bytes are
    printed beside ``serve_paged``'s."""
    from repro_torch.models.model import ExecPolicy
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = _mixtral_int8(LAYERS)
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, EngineConfig(**SERVE_PAGED),
                 ExecPolicy(moe_impl="grouped", use_kernels=True),
                 device=DEVICE)
    _, res, outs = serve_run(torch, np, eng, ops, PAGED_PROMPT_LENS,
                             N_REQUESTS, SEED + 2)
    traffic = eng.kv_traffic()
    host = kv_host_bytes(eng)
    launches = res["launches"]
    emit({"phase": "serve_paged_int8", "model": "mixtral-8x7b",
          "layers": LAYERS, "engine": SERVE_PAGED, **res,
          "arena_bytes": traffic["arena_bytes"], "host_tier_bytes": host,
          "serve_paged_arena_bytes": paged_res["arena_bytes"],
          "serve_paged_host_tier_bytes": paged_res["host_tier_bytes"],
          "arena_ratio": traffic["arena_bytes"] / paged_res["arena_bytes"],
          "host_tier_ratio": host / paged_res["host_tier_bytes"],
          "preemptions": sum(r.preemptions
                             for r in eng.scheduler.requests.values()),
          "kv_traffic": traffic})
    require(traffic["spills"] > 0 and traffic["misses"] > 0
            and traffic["prefetches"] > 0,
            f"the int8 host tier was not exercised: {traffic}")
    require(all(launches[k] > 0 for k in
                ("moe_ffn", "paged_gqa_decode", "flash_prefill")),
            f"a kernel of the int8 paged path never launched: {launches}")
    return eng, launches


def phase_check_int8(torch, np, cfg, params, prompts, eng, eng_paged):
    """``check`` on the int8 weights and KV (kernel path against plain
    path, within ``LOGIT_TOL``; how many transcripts the paged and dense
    int8 engines share, printed), then the int8 KV against bf16 KV on the
    same weights: a prefill and three teacher-forced decode steps of each
    prompt through the kernels, the int8-KV logits within a relative
    error of 0.05 of the bf16-KV ones (``test_serve_consistency.py``'s
    int8 budget).  The int8 run replays the bf16 run's routing
    (``RoutingTape``), so that the difference is the quantized KV's and
    not a top-2 flip it causes downstream; the error under its own
    routing is printed beside.  Returns the engine prompts and the dense
    int8 engine's transcripts."""
    from repro_torch.models import kvcache
    from repro_torch.models.model import ExecPolicy, forward, unembed

    engine_prompts, runs = phase_check(torch, np, cfg, params, prompts, eng,
                                       eng_paged, phase="check_int8")
    bf16_kv = dataclasses.replace(cfg, kv_dtype=_mixtral().kv_dtype)
    pol = ExecPolicy(moe_impl="grouped", use_kernels=True)
    rel, rel_own = [], []
    for prompt in prompts:
        tok = torch.as_tensor(prompt[None].astype("int32"), device=DEVICE)
        forced = []

        def run(c, tape):
            """Prefill and three decode steps (fed the bf16-KV run's greedy
            tokens) under `tape`; returns the four logits rows."""
            with tape:
                cache = kvcache.init_cache(c, 1, SERVE["max_seq"],
                                           device=DEVICE)
                h = forward(c, params, tok, cache=cache, mode="prefill",
                            policy=pol)["hidden"][:, -1]
                seq = [unembed(c, params, h)]
                for i in range(3):
                    if len(forced) == i:
                        forced.append(torch.argmax(seq[-1], -1).to(
                            torch.int32))
                    h = forward(c, params, forced[i][:, None], cache=cache,
                                mode="decode", policy=pol)["hidden"][:, -1]
                    seq.append(unembed(c, params, h))
            return seq
        tape = RoutingTape()
        want = run(bf16_kv, tape)
        for out, got in ((rel, run(cfg, RoutingTape(replay=tape))),
                         (rel_own, run(cfg, RoutingTape()))):
            for a, b in zip(got, want):
                require(bool(torch.isfinite(a).all()), "bad int8-KV logits")
                out.append(float((a.float() - b.float()).abs().max()
                                 / b.float().abs().max()))
    emit({"phase": "check_int8_kv_vs_bf16_kv", "prompts": len(prompts),
          "steps": "prefill + 3 decodes", "routing": "the bf16-KV run's",
          "max_rel_err": max(rel), "rel_errs": rel, "bound": 0.05,
          "own_routing_max_rel_err": max(rel_own),
          "own_routing_rel_errs": rel_own})
    require(max(rel) < 0.05,
            f"int8-KV logits off the bf16-KV ones by {max(rel)}")
    return engine_prompts, runs


def phase_check_expert_int8(torch, np, eng, engine_prompts, want_f32):
    """The 4-layer int8 weights packed into pinned stores and served
    expert-paged at r_w 0.25.  The int8 experts' f32 scales travel in the
    shared span, which takes its first leaf's dtype (bf16 here), so the
    expert-paged path computes with the scales rounded to bf16, as the
    JAX package does: its transcripts must equal, token for token, a
    resident int8 engine's whose scales are rounded so; how many equal the
    resident engine's with f32 scales (`want_f32`) is printed."""
    from repro_torch.models.model import ExecPolicy
    from repro_torch.serving.engine import Engine

    rounded = {**eng.params, "blocks": {
        key: {**g, "moe": {**g["moe"], **{
            n: g["moe"][n].to(torch.bfloat16).float()
            for n in ("wi_scale", "wo_scale")}}}
        for key, g in eng.params["blocks"].items()}}
    changed = sum(int((rounded["blocks"][k]["moe"][n]
                       != eng.params["blocks"][k]["moe"][n]).sum())
                  for k in rounded["blocks"] for n in ("wi_scale",
                                                       "wo_scale"))
    e = Engine(eng.cfg, rounded, eng.ecfg,
               ExecPolicy(moe_impl="grouped", use_kernels=True),
               device=DEVICE)
    rids = [e.submit(p, NEW_TOKENS // 4) for p in engine_prompts]
    out = e.run_until_idle()
    want = [out[r] for r in rids]
    del e
    phase_check_expert(
        torch, np, eng, engine_prompts, want, phase="check_expert_int8",
        extra=lambda got: {
            "scales_rounded_to": "bfloat16", "scales_changed": changed,
            "vs_f32_scales_identical_requests": sum(
                x == y for x, y in zip(got, want_f32)),
            "vs_f32_scales_agree": sum(
                a == b for x, y in zip(got, want_f32)
                for a, b in zip(x, y))})


def host_peak_rss() -> int:
    """The process's peak resident host memory so far, in bytes."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def mem_available() -> int:
    """MemAvailable of /proc/meminfo, in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def host_rss() -> int:
    """The process's resident host memory now, in bytes."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


HOST_START = {}               # MemAvailable and the resident set at start


def host_mem_available() -> int:
    """The host memory the process can still draw on: MemAvailable, or the
    start's MemAvailable less what the process's resident set has grown
    by since, whichever is larger.  The machine's MemAvailable credits the
    pages of a released store back late (seconds to minutes after the
    process has given them back, its resident set dropping at once),
    while a new store is drawn into them at once; read alone, it made a
    later phase size its stores as if the released ones were still held.
    Nothing else runs on the machine."""
    if not HOST_START:
        HOST_START.update(avail=mem_available(), rss=host_rss())
    return max(mem_available(),
               HOST_START["avail"] - (host_rss() - HOST_START["rss"]))


def host_memory(at: str) -> None:
    """MemAvailable, the resident set, the memory the host rule reads
    (``host_mem_available``) and the peak resident memory at a point of
    the run."""
    emit({"phase": "host_memory", "at": at,
          "mem_available": mem_available(), "host_rss": host_rss(),
          "host_available": host_mem_available(),
          "host_peak_rss": host_peak_rss()})


def host_room(avail: int) -> float:
    """The bytes of host stores that MemAvailable `avail` holds with 20 %
    and at least 20 GiB to spare (the serve and its profiled window run
    beside them)."""
    return min(avail / HOST_MARGIN, avail - HOST_RESERVE)


def store_bytes_per_period(torch, split: bool, cfg=None) -> int:
    """Bytes of one period's host stores of `cfg` (mixtral-8x7b by
    default; a period of one layer there, of 8 in jamba), expert-granular
    (`split`) or whole-layer; sized on the CPU, nothing written."""
    from repro_torch.core import paging
    from repro_torch.models.params import abstract_params, param_defs
    from repro_torch.serving.engine import EngineConfig

    cfg = cfg or _mixtral()
    one = dataclasses.replace(cfg, num_layers=len(cfg.period))
    probe = paging.PagedWeights.empty(
        abstract_params(one, param_defs(one)["blocks"]),
        EngineConfig().page_elems, torch.device("cpu"), split=split)
    return sum(t.nbytes for t in (*probe.pages.values(),
                                  *probe.expert_pages.values()))


def draw_stores(torch, cfg, split: bool):
    """`cfg`'s resident params drawn on the card from ``SEED``, and its
    block params drawn there one period at a time and written into
    page-locked host stores (``PagedWeights.empty``: expert-granular if
    `split`, else whole-layer), so that neither the card nor pageable host
    memory ever holds the stack.  Returns the params, the stores and the
    seconds taken to pin the stores and to fill them."""
    from repro_torch.core import paging
    from repro_torch.models.params import (abstract_params, init_params,
                                           param_defs)
    from repro_torch.serving.engine import EngineConfig

    t0 = time.perf_counter()
    defs = param_defs(cfg)
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = init_params(cfg, g, DEVICE,
                         defs={k: v for k, v in defs.items()
                               if k != "blocks"})
    pw = paging.PagedWeights.empty(abstract_params(cfg, defs["blocks"]),
                                   EngineConfig().page_elems,
                                   torch.device(DEVICE), split=split)
    pin_s = time.perf_counter() - t0
    # one period at a time: each period position's stack holds one layer
    # a period
    one_defs = param_defs(dataclasses.replace(
        cfg, num_layers=len(cfg.period)))["blocks"]
    for period in range(cfg.num_periods):
        drawn = init_params(cfg, g, DEVICE, defs=one_defs)
        for key, tree in drawn.items():
            pw.write_layer(key, period, paging.layer_slice(tree, 0))
        del drawn
    torch.cuda.synchronize()
    return params, pw, pin_s, time.perf_counter() - t0


def phase_serve_expert(torch, np, ops):
    """mixtral-8x7b at full width through the expert-granular paged
    weights: every layer drawn on the card and written into pinned host
    stores, one layer at a time (neither the card nor pageable host memory
    ever holds the stack), served with a device pool of r_w 0.5 of the
    (layer, expert) spans.  The depth is the deepest whose stores fit
    MemAvailable with 20 % and at least 20 GiB to spare (the serve and
    its profiled window run beside the stores), never below 8.
    Returns the engine, its launches, the stores (kept for
    ``phase_serve_expert_module``) and its numbers."""
    from repro_torch.core import offload
    from repro_torch.models import kvcache
    from repro_torch.models.params import count_params

    full = _mixtral()
    one = dataclasses.replace(full, num_layers=1)
    per_layer = store_bytes_per_period(torch, split=True)
    # serve_expert_kv's host tier holds every KV block of every layer; the
    # pinned allocator may round each store up to twice its bytes
    kv = SERVE_EXPERT_KV
    kv_blocks = (kv["num_ubs"] * kv["ubatch"] * kv["max_seq"]
                 // kv["block_tokens"])
    kv_host = 2 * sum(a.nbytes for g in kvcache.init_paged_arena(
        one, kv_blocks, kv["block_tokens"], device="meta").values()
        for a in g.values())
    avail = host_mem_available()
    fit = int(host_room(avail) // (per_layer + kv_host))
    layers = min(full.num_layers, fit, SERVE_EXPERT_MAX_LAYERS)
    emit({"phase": "host_rule", "for": "serve_expert",
          "host_available": avail, "layers_that_fit": fit,
          "layers": layers, "of_layers": full.num_layers,
          "cut_for_time_to": SERVE_EXPERT_MAX_LAYERS})
    require(layers >= MIN_EXPERT_LAYERS,
            f"MemAvailable {avail} holds {layers} layers of {per_layer} "
            f"+ {kv_host} bytes with 20 % and 20 GiB to spare; "
            f"serve_expert needs {MIN_EXPERT_LAYERS}")
    cfg = dataclasses.replace(full, num_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, pw, pin_s, build_s = draw_stores(torch, cfg, split=True)
    pinned = offload.pinned_bytes()
    stores = {"cfg": cfg, "params": params, "pw": pw, "layers": layers,
              "of_layers": full.num_layers, "params_count": count_params(cfg),
              "store_bytes_per_layer": per_layer,
              "kv_host_bytes_per_layer": kv_host, "mem_available": avail,
              "pinned_bytes": pinned, "pin_s": pin_s, "build_s": build_s}
    eng, launches, res = serve_expert_engine(torch, np, ops, stores,
                                             SERVE_EXPERT, "serve_expert")
    return eng, launches, stores, res


def phase_serve_expert_int8(torch, np, ops, records):
    """mixtral-8x7b at full width with int8 experts, expert-paged with
    ``serve_expert``'s settings (r_w 0.5, 8 requests of 32..256 x 32):
    every layer drawn on the card and written into pinned host stores
    (1.49 GB a layer, against 2.90 in bf16), to the depth the host rule
    holds (all 32 layers when ~69 GB are free), never below 8.  The rule's
    arithmetic is printed before the stores are drawn; beside the serve
    numbers, the gather's link bytes and rate against ``h2d_copy``.
    Returns the engine, its launches, the stores and its numbers."""
    from repro_torch.core import offload
    from repro_torch.models.params import count_params

    full = dataclasses.replace(_mixtral(), expert_dtype="int8")
    per_layer = store_bytes_per_period(torch, split=True, cfg=full)
    avail = host_mem_available()
    room = host_room(avail)
    layers = min(full.num_layers, int(room // per_layer))
    emit({"phase": "host_rule", "for": "serve_expert_int8",
          "host_available": avail, "mem_available": mem_available(),
          "room": room, "rule": "min(available / 1.2, available - 20 GiB)",
          "store_bytes_per_layer": per_layer,
          "layers_that_fit": int(room // per_layer),
          "layers": layers, "of_layers": full.num_layers})
    require(layers >= MIN_EXPERT_LAYERS,
            f"the host holds {layers} int8 layers of {per_layer} bytes; "
            f"serve_expert_int8 needs {MIN_EXPERT_LAYERS}")
    cfg = dataclasses.replace(full, num_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, pw, pin_s, build_s = draw_stores(torch, cfg, split=True)
    stores = {"cfg": cfg, "params": params, "pw": pw, "layers": layers,
              "of_layers": full.num_layers, "params_count": count_params(cfg),
              "store_bytes_per_layer": per_layer,
              "kv_host_bytes_per_layer": 0, "mem_available": avail,
              "pinned_bytes": offload.pinned_bytes(), "pin_s": pin_s,
              "build_s": build_s}
    eng, launches, res = serve_expert_engine(torch, np, ops, stores,
                                             SERVE_EXPERT,
                                             "serve_expert_int8")
    h2d = next(r for r in records if r["name"] == "expert_gather")[
        "bound_rates"]["h2d_GBps_measured"]
    tokens = sum(len(t) for t in res["transcripts"])
    res.update(tokens=tokens, gather_bytes_per_token_layer=(
        res["gather_host_bytes"] / tokens / layers))
    emit({"phase": "serve_expert_int8_link", "layers": layers,
          "gather_host_bytes": res["gather_host_bytes"],
          "gather_host_GBps": res["gather_host_GBps"],
          "h2d_copy_GBps": h2d,
          "gather_over_h2d_copy": res["gather_host_GBps"] / h2d,
          "tokens": tokens,
          "gather_bytes_per_token_layer":
              res["gather_bytes_per_token_layer"]})
    return eng, launches, stores, res


def serve_expert_engine(torch, np, ops, stores, settings, phase,
                        workload=(EXPERT_PROMPT_LENS, EXPERT_REQUESTS,
                                  SEED + 8, EXPERT_NEW_TOKENS)):
    """An expert-paged engine over `stores` (``phase_serve_expert``'s host
    stores and resident params) with the engine settings given, serving
    `workload` (prompt lengths, requests, seed, new tokens: by default
    ``EXPERT_REQUESTS`` seeded requests); emits the `phase` line with the
    gather's link bytes, seconds and rate."""
    from repro_torch.models.model import ExecPolicy
    from repro_torch.serving.engine import Engine, EngineConfig

    pw, page_elems = stores["pw"], EngineConfig().page_elems
    eng = Engine(stores["cfg"], stores["params"], EngineConfig(**settings),
                 ExecPolicy(moe_impl="grouped", use_kernels=True),
                 device=DEVICE, paged_weights=pw)
    # the spans the gather read over the link: counted on the card, per
    # call, from the same map, sel and n_act the kernel reads (the most in
    # one call kept too); its time on the stream (its kernel to its last
    # copy), by a pair of CUDA events around each call; and the host's
    # seconds in the call (the wait for the plan, then one
    # cudaMemcpyAsync a missed leaf)
    host_spans = torch.zeros((), dtype=torch.int64, device=DEVICE)
    max_spans = torch.zeros((), dtype=torch.int64, device=DEVICE)
    spans_timed, host_wall = [], [0.0]
    inner = ops.expert_gather

    def counted(store, pool, rmap, layer, sel, n_act, manifest, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        t = time.perf_counter()
        out = inner(store, pool, rmap, layer, sel, n_act, manifest, **kw)
        host_wall[0] += time.perf_counter() - t
        ev[1].record()
        spans_timed.append(ev)
        real = torch.arange(sel.shape[0], device=DEVICE) < n_act
        n = ((rmap[layer].index_select(0, sel.long()) < 0) & real).sum()
        host_spans.add_(n)
        torch.maximum(max_spans, n, out=max_spans)
        return out
    ops.expert_gather = counted
    try:
        _, res, outs = serve_run(torch, np, eng, ops, *workload)
    finally:
        ops.expert_gather = inner
    traffic = eng.weight_traffic()
    manifest = next(iter(pw.expert_manifests.values()))
    gather_host_bytes = int(host_spans) * manifest.span_bytes
    gather_s = sum(a.elapsed_time(b) for a, b in spans_timed) / 1e3
    leaves = len(manifest.leaves)
    res.update(gather_host_bytes=gather_host_bytes,
               gather_calls=len(spans_timed), gather_s=gather_s,
               gather_host_GBps=gather_host_bytes / gather_s / 1e9,
               gather_host_copies=int(host_spans) * leaves,
               gather_max_host_copies=int(max_spans) * leaves,
               gather_host_wall_s=host_wall[0], transcripts=outs)
    emit({"phase": phase, "model": stores["cfg"].name,
          "layers": stores["layers"],
          "of_layers": stores["of_layers"],
          "params": stores["params_count"],
          **{k: stores[k] for k in ("store_bytes_per_layer",
                                    "kv_host_bytes_per_layer",
                                    "mem_available", "pinned_bytes", "pin_s",
                                    "build_s")},
          "pool_spans": sum(r.capacity for r in eng.residency.values()),
          "pool_bytes": sum(p.nbytes for p in eng._expert_pool.values()),
          "engine": {**settings, "page_elems": page_elems},
          **{k: v for k, v in res.items() if k != "transcripts"},
          "host_peak_rss": host_peak_rss(),
          "preemptions": sum(r.preemptions
                             for r in eng.scheduler.requests.values()),
          "weight_traffic": traffic, "kv_traffic": eng.kv_traffic()})
    require(traffic["hits"] > 0 and traffic["misses"] > 0
            and traffic["prefetches"] > 0,
            f"the residency pool was not exercised: {traffic}")
    require(gather_host_bytes > 0, "the gather read nothing from the host")
    launches = res["launches"]
    decode = "paged_gqa_decode" if settings.get("kv_paged") else "gqa_decode"
    require(all(launches[k] > 0 for k in
                ("expert_gather", "moe_ffn", decode, "flash_prefill")),
            f"a kernel of the expert-paged path never launched: {launches}")
    res["weight_traffic"] = traffic
    return eng, launches, res


def phase_serve_expert_module(torch, np, ops, stores, base):
    """``serve_expert``'s stores, depth, pool ratio and requests through a
    module-batched engine (G = 2): one gather a layer a window reads each
    activated span once for both groups.  Its greedy transcripts must
    equal ``serve_expert``'s, the measured amortization
    (``module_groups_effective``) must exceed 1, and the gather must read
    fewer bytes over the link than ``serve_expert``'s."""
    settings = {**SERVE_EXPERT, "module_batch": True}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng, launches, res = serve_expert_engine(torch, np, ops, stores,
                                             settings, "serve_expert_module")
    traffic = eng.weight_traffic()
    emit({"phase": "serve_expert_module_vs_serve_expert",
          "identical_requests": sum(
              a == b for a, b in zip(res["transcripts"],
                                     base["transcripts"])),
          "requests_total": len(base["transcripts"]),
          "gather_host_bytes": [base["gather_host_bytes"],
                                res["gather_host_bytes"]],
          "decode_tok_per_s": [base["decode_tok_per_s"],
                               res["decode_tok_per_s"]],
          "wall_s": [base["wall_s"], res["wall_s"]],
          "module_groups_effective": traffic["module_groups_effective"]})
    require(res["transcripts"] == base["transcripts"],
            "module-batched expert-paged transcripts differ from "
            "serve_expert's")
    require(traffic["module_groups_effective"] > 1,
            f"no amortization measured: {traffic}")
    require(res["gather_host_bytes"] < base["gather_host_bytes"],
            f"the windows read no fewer bytes over the link: "
            f"{res['gather_host_bytes']} vs {base['gather_host_bytes']}")
    return eng, launches, res


def phase_serve_expert_kv(torch, np, ops, stores, module_res):
    """The paper's setting with both offload ratios: ``serve_expert``'s
    stores, depth and requests through windows at r_w 0.5 over a
    block-paged KV arena too small for the requests' rows
    (``SERVE_EXPERT_KV``), with its pinned host tier.  The arena must
    spill and fetch, the gather must read from the host, and every
    request must complete.  How many transcripts equal
    ``serve_expert_module``'s is printed, not required: a window under KV
    preemption re-admits requests, and a preemption changes who shares a
    capacity bucket."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng, launches, res = serve_expert_engine(torch, np, ops, stores,
                                             SERVE_EXPERT_KV,
                                             "serve_expert_kv")
    kv = eng.kv_traffic()
    emit({"phase": "serve_expert_kv_vs_serve_expert_module",
          "identical_requests": sum(
              a == b for a, b in zip(res["transcripts"],
                                     module_res["transcripts"])),
          "requests_total": len(module_res["transcripts"]),
          "decode_tok_per_s": [module_res["decode_tok_per_s"],
                               res["decode_tok_per_s"]],
          "prefill_s": [module_res["prefill_s"], res["prefill_s"]],
          "gather_host_bytes": [module_res["gather_host_bytes"],
                                res["gather_host_bytes"]],
          "kv_spills": kv["spills"], "kv_misses": kv["misses"],
          "preemptions": sum(r.preemptions
                             for r in eng.scheduler.requests.values())})
    require(kv["spills"] > 0 and kv["misses"] > 0,
            f"the KV host tier was not exercised: {kv}")
    return eng, launches


def host_probe(torch) -> dict:
    """Timed rates of this machine's host, for HRM's CPU level: a 1 GiB
    float32 tensor copy (bytes read + written per second) and a 4096^3
    float32 matmul (FLOP/s), each the best of 3 after a warm-up, on the
    threads PyTorch uses by default."""
    x = torch.ones(1 << 28, dtype=torch.float32)
    y = torch.empty_like(x)
    a = torch.randn(4096, 4096)
    copy_s, mm_s = [], []
    for _ in range(4):
        t = time.perf_counter()
        y.copy_(x)
        copy_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        torch.mm(a, a)
        mm_s.append(time.perf_counter() - t)
    return {"threads": torch.get_num_threads(),
            "copy_Bps": 2 * x.nbytes / min(copy_s[1:]),
            "f32_matmul_flops": 2 * 4096 ** 3 / min(mm_s[1:])}


def phase_policy(torch, records, stores, expert_res):
    """HRM's policy search for the card: the ``h100`` preset with this
    run's pinned host-to-device rate (``h2d_copy``) as its link, read
    through ``hrm.with_measured_links``, and MemAvailable (read before
    ``serve_expert`` pinned its stores) as its CPU capacity; mixtral-8x7b
    at its full 32 layers, ``kv_paged``, module groups 1 and 2, and
    ``serve_expert``'s workload (its mean prompt length, 32 new tokens).  Prints the best policy and the best with
    attention on the card (the engine runs attention there only) beside
    the r_w 0.5 set here by hand, and HRM's modelled link bytes for
    ``serve_expert``'s own settings beside what its gather moved and what
    ``weight_traffic()`` booked.  A feasible GPU-attention policy is
    required; nothing is claimed from it."""
    from repro_torch.core import hrm
    from repro_torch.core import policy as pol

    h2d = next(r for r in records if r["name"] == "expert_gather")[
        "bound_rates"]["h2d_GBps_measured"] * 1e9
    path = os.path.join(ROOT, "build", "h2d_transfer.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"h2d_pinned_bytes_per_s": h2d}, f)
    hw = hrm.with_measured_links(hrm.preset("h100"), path)
    # the host's memory before serve_expert pinned its stores
    avail = stores["mem_available"]
    hw = hrm.Hardware(tuple(dataclasses.replace(lv, capacity=float(avail))
                            if lv.name == "cpu" else lv for lv in hw.levels),
                      hw.links, name=hw.name)
    probe = host_probe(torch)
    cfg = _mixtral()
    wl = pol.Workload(round(expert_res["prompt_tokens"]
                            / expert_res["requests"]), EXPERT_NEW_TOKENS)
    t0 = time.perf_counter()
    res = pol.search(cfg, hw, wl, kv_paged=True, module_groups_grid=(1, 2))
    search_s = time.perf_counter() - t0

    def show(r):
        return None if r is None else {
            "policy": dataclasses.asdict(r["policy"]),
            **{k: r[k] for k in ("throughput", "t_layer", "t_prefill",
                                 "t_io", "t_gpu", "t_cpu", "comm_bytes",
                                 "mem_gpu", "mem_cpu")}}
    # HRM's link bytes for what serve_expert ran: one lockstep group of
    # `ubatch` rows a pass, r_w 0.5, every KV block on the card
    served = dataclasses.replace(cfg, num_layers=stores["layers"])
    ub = SERVE_EXPERT["ubatch"]
    mine = pol.Policy(ub, ub, True, True, SERVE_EXPERT["w_gpu_ratio"], 1.0)
    lat = hrm.layer_latency(hw, hrm.LayerWorkload.decode(
        served, ub, wl.avg_ctx), mine)
    traffic = expert_res["weight_traffic"]
    passes = traffic["fwd_passes"]
    gpu_attn = res["best_gpu_attn"]
    emit({"phase": "policy", "hardware": {
              "name": hw.name, "link_cpu_gpu_Bps": hw.link_bw("cpu", "gpu"),
              "levels": [dataclasses.asdict(lv) for lv in hw.levels]},
          "host_probe": probe, "workload": dataclasses.asdict(wl),
          "search_s": search_s, "best": show(res["best"]),
          "best_gpu_attn": show(gpu_attn),
          "w_gpu_ratio": {"best_gpu_attn": gpu_attn["policy"].w_gpu_ratio,
                          "set_by_hand": SERVE_EXPERT["w_gpu_ratio"]},
          "kv_gpu_ratio_best_gpu_attn": gpu_attn["policy"].kv_gpu_ratio,
          "link_bytes": {
              "modelled_per_layer_pass": lat["comm_bytes"],
              "layers": stores["layers"], "passes": passes,
              "modelled": lat["comm_bytes"] * stores["layers"] * passes,
              "gather_measured": expert_res["gather_host_bytes"],
              "booked": traffic["h2d_bytes"]}})
    require(gpu_attn is not None and gpu_attn["policy"].attn_on_gpu,
            "no feasible policy with attention on the card")


def phase_launch(torch, ops):
    """The port's serve launcher, as a user runs it, on the card:
    ``repro_torch.launch.serve --smoke --hw h100`` (HRM advice for the full
    model on the H100 preset, then synthetic requests through the engine
    on the smoke config), and again with ``--paged`` (whole-layer paged
    weights); each JSON line must report every request done."""
    from repro_torch.launch import serve

    out = {}
    for phase, extra in (("launch", []), ("launch_paged", ["--paged"])):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        res = serve.main(["--smoke", "--hw", "h100", *extra])
        torch.cuda.synchronize()
        out[phase] = ops.launch_counts()
        emit({"phase": phase, **res, "launches": out[phase]})
        require(res["requests"] > 0 and res["done"] == res["requests"],
                f"the launcher left requests undone: {res}")
        require(res["device"].startswith("cuda"),
                "the launcher ran off the card")
        require(res["paged"] == bool(extra), f"--paged not applied: {res}")
    return out


def phase_serve_mla(torch, np, ops):
    """DeepSeek-V3 at full width, 5 of its 61 layers (the 3 dense-FFN
    prologue layers and 2 MoE layers), over the block-paged latent arena
    with its pinned host tier; the prologue's latent rings stay dense."""
    from repro_torch.models.model import ExecPolicy
    from repro_torch.models.params import count_params, init_params
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = dataclasses.replace(_deepseek(), num_layers=MLA_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(SEED),
                         device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = Engine(cfg, params, EngineConfig(**SERVE_PAGED),
                 ExecPolicy(moe_impl="grouped", use_kernels=True),
                 device=DEVICE)
    prompts, res, _ = serve_run(torch, np, eng, ops, PAGED_PROMPT_LENS,
                                N_REQUESTS, SEED + 4)
    traffic = eng.kv_traffic()
    preempted = sum(r.preemptions for r in eng.scheduler.requests.values())
    weight_bytes = sum(t.nbytes for t in _leaves(params))
    emit({"phase": "serve_mla", "model": "deepseek-v3-671b",
          "layers": MLA_LAYERS, "of_layers": _deepseek().num_layers,
          "params": count_params(cfg), "weight_bytes": weight_bytes,
          "init_s": init_s, "engine": SERVE_PAGED, **res,
          "preemptions": preempted, "arena_bytes": traffic["arena_bytes"],
          "dense_equiv_bytes": traffic["dense_equiv_bytes"],
          "h2d_bytes": traffic["h2d_bytes"],
          "d2h_bytes": traffic["d2h_bytes"], "kv_traffic": traffic})
    launches = res["launches"]
    require(traffic["spills"] > 0 and traffic["misses"] > 0
            and traffic["prefetches"] > 0,
            f"the host tier was not exercised: {traffic}")
    require(all(launches[k] > 0 for k in
                ("moe_ffn", "paged_mla_decode", "flash_prefill")),
            f"a kernel of the MLA path never launched: {launches}")
    require(launches["gqa_decode"] == launches["paged_gqa_decode"] == 0,
            f"the MLA path ran a GQA decode kernel: {launches}")
    return eng, prompts[:2], launches


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def phase_check_mla(torch, np, cfg, params, prompts):
    """Prefill and decode logits of the MLA model through the kernels
    against the plain path, on the dense cache and on a paged latent arena
    with a scattered page table.  The plain path runs the attention
    kernels' plain versions and the grouped MoE's plain einsums in bf16:
    moe_ffn's plain version casts a layer's 22.5 GB of expert weights to
    f32 (45 GB), which the card cannot hold beside the model; the kernel
    phase holds moe_ffn against it at this shape."""
    from repro_torch.models import kvcache
    from repro_torch.models.model import ExecPolicy, forward, unembed
    from repro_torch.serving import steps

    pols = {"auto": ExecPolicy(moe_impl="grouped", use_kernels=True),
            "ref": ExecPolicy(moe_impl="grouped", use_kernels=False,
                              impl="ref")}
    worst = {"prefill": 0.0, "decode": 0.0, "decode_paged": 0.0}
    rng = np.random.default_rng(SEED + 6)
    for prompt in prompts:
        outs = {}
        for impl, pol in pols.items():
            cache = kvcache.init_cache(cfg, 1, SERVE_PAGED["max_seq"],
                                       device=DEVICE)
            tok = torch.as_tensor(prompt[None].astype("int32"),
                                  device=DEVICE)
            lens = torch.tensor([len(prompt)], dtype=torch.int32,
                                device=DEVICE)
            logits, cache = steps.make_prefill_fill_step(cfg, pol)(
                params, tok, cache, lens)
            outs[impl] = {"prefill": logits, "cache": cache}
        # one decode step, both paths fed the kernel path's greedy token;
        # on the paged layout both read the same arena and page table
        first = torch.argmax(outs["auto"]["prefill"], -1).to(
            torch.int32)[:, None]
        paged = paged_copy(torch, cfg, outs["auto"]["cache"], rng)
        for impl, o in outs.items():
            fwd = forward(cfg, params, first, cache=clone_cache(paged),
                          mode="decode", policy=pols[impl])
            o["decode_paged"] = unembed(cfg, params, fwd["hidden"][:, -1])
            fwd = forward(cfg, params, first, cache=o["cache"],
                          mode="decode", policy=pols[impl])
            o["decode"] = unembed(cfg, params, fwd["hidden"][:, -1])
        for key in worst:
            a, b = outs["auto"][key], outs["ref"][key]
            require(bool(torch.isfinite(a).all()) and a.shape == b.shape
                    == (1, cfg.vocab_size), f"bad MLA {key} logits")
            worst[key] = max(worst[key], max_err(a, b))
    emit({"phase": "check_mla", "prompts": len(prompts),
          "prompt_tokens": [len(p) for p in prompts],
          "max_abs_logit_diff": worst, "tol": LOGIT_TOL})
    require(all(v <= LOGIT_TOL for v in worst.values()),
            f"MLA kernel path logits differ from the plain path: {worst}")


def phase_serve_family(torch, np, ops, arch, phase, ring, arena,
                       prompt_lens, new_tokens, trace_lens=None):
    """`arch` at full width and depth, random weights from ``SEED``, every
    weight on the card: ``FAMILY_REQUESTS`` seeded requests over the dense
    ring (`ring`), then the same requests over the block-paged arena
    (`arena`; only the full-attention layers are paged, sliding-window
    rings stay in each group's dense remainder), whose greedy transcripts
    must equal the ring's.  Neither run may preempt (a preemption
    re-prefills a request, whose bf16 KV then differs from decode's).
    With `trace_lens`, a profiled window of the ring engine first.
    Returns each run's launches."""
    from repro_torch.models import kvcache
    from repro_torch.models.model import ExecPolicy
    from repro_torch.models.params import count_params, init_params
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = _family(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(SEED),
                         device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.nbytes for t in _leaves(params))
    launches, outs = {}, {}
    for label, settings in (("ring", ring), ("arena", arena)):
        eng = Engine(cfg, params, EngineConfig(**settings),
                     ExecPolicy(moe_impl="grouped", use_kernels=True),
                     device=DEVICE)
        _, res, outs[label] = serve_run(torch, np, eng, ops, prompt_lens,
                                        FAMILY_REQUESTS, SEED + 9,
                                        new_tokens)
        kv = eng.kv_traffic()
        preempted = sum(r.preemptions
                        for r in eng.scheduler.requests.values())
        name = phase if label == "ring" else phase + "_paged"
        emit({"phase": name, "model": arch, "layers": cfg.num_layers,
              "of_layers": cfg.num_layers, "params": count_params(cfg),
              "weight_bytes": weight_bytes, "init_s": init_s,
              "engine": settings, **res, "preemptions": preempted,
              "paged_keys": list(kvcache.paged_period_keys(cfg))
              if label == "arena" else [],
              "kv_traffic": kv})
        decode = "paged_gqa_decode" if label == "arena" else "gqa_decode"
        require(all(res["launches"][k] > 0 for k in (decode,
                                                      "flash_prefill")),
                f"{name}: a kernel of the path never launched: "
                f"{res['launches']}")
        require(preempted == 0, f"{name}: {preempted} preemptions")
        if label == "arena":
            require(set(eng._kv_arena) == set(
                kvcache.paged_period_keys(cfg)) and eng._kv_arena,
                f"{name}: paged {sorted(eng._kv_arena)}")
        elif trace_lens:
            phase_trace(torch, np, eng, arch, trace_lens, 2, 8)
        launches[name] = res["launches"]
        del eng
        gc.collect()
    emit({"phase": phase + "_ring_vs_arena",
          "identical_requests": sum(a == b for a, b in
                                    zip(outs["ring"], outs["arena"])),
          "requests_total": len(outs["ring"])})
    require(outs["ring"] == outs["arena"],
            f"{phase}: the arena's transcripts differ from the ring's")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_check_gemma2(torch, np, ops):
    """gemma2's window ring under a sequence longer than it, on the card
    through the kernels: full width, 2 layers (one window, one global),
    float32, the window cut to ``CHECK_GEMMA2_WINDOW``; a prompt of
    ``CHECK_GEMMA2_PROMPT`` tokens prefilled, then decode steps whose
    logits must equal a teacher-forced forward over the whole sequence
    within ``CHECK_GEMMA2_TOL`` (``test_serve_consistency.py::
    test_window_ring_overflow_consistency``'s check, with the ring
    wrapping three times).  Returns the launches."""
    from repro_torch.models import kvcache
    from repro_torch.models.model import ExecPolicy, forward, unembed
    from repro_torch.models.params import init_params

    cfg = dataclasses.replace(_family("gemma2-2b"), num_layers=2,
                              dtype="float32",
                              window_size=CHECK_GEMMA2_WINDOW)
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        SEED + 10), device=DEVICE)
    pol = ExecPolicy(use_kernels=True)
    S, n = CHECK_GEMMA2_PROMPT, CHECK_GEMMA2_STEPS
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    toks = torch.randint(2, cfg.vocab_size, (1, S + n), generator=g,
                         device=DEVICE, dtype=torch.int32)
    ops.reset_launch_counts()
    full = unembed(cfg, params, forward(cfg, params, toks,
                                        policy=pol)["hidden"])
    cache = kvcache.init_cache(cfg, 1, S + n + 1, device=DEVICE)
    forward(cfg, params, toks[:, :S], cache=cache, mode="prefill",
            policy=pol)
    errs = []
    for t in range(n):
        fwd = forward(cfg, params, toks[:, S + t:S + t + 1], cache=cache,
                      mode="decode", policy=pol)
        got = unembed(cfg, params, fwd["hidden"][:, -1])
        want = full[:, S + t]
        require(bool(torch.isfinite(got).all()), "check_gemma2: not finite")
        errs.append(max_err(got, want))
        require(close(got, want, CHECK_GEMMA2_TOL),
                f"check_gemma2 step {t}: {errs[-1]}")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    emit({"phase": "check_gemma2", "layers": cfg.num_layers,
          "window": cfg.window_size,
          "ring_width": int(cache["p0"]["k"].shape[2]),
          "global_ring_width": int(cache["p1"]["k"].shape[2]),
          "prompt": S, "decode_steps": n, "dtype": "float32",
          "max_abs_logit_diff": max(errs), "per_step": errs,
          "tol": CHECK_GEMMA2_TOL, "launches": launches})
    require(launches["flash_prefill"] > 0 and launches["gqa_decode"] > 0,
            f"check_gemma2: the kernels never launched: {launches}")
    del params, full, cache
    torch.cuda.empty_cache()
    return launches


def phase_check_moonshot(torch, np, ops):
    """moonshot at full width and 4 of its 48 layers, every weight on the
    card: 8 prompts through the resident engine, then ``check_expert`` on
    the same weights packed into pinned expert-paged stores (64 spans a
    layer, a pool of r_w 0.25): transcripts equal.  Returns the launches
    of the expert-paged run."""
    from repro_torch.models.model import ExecPolicy
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = dataclasses.replace(_family("moonshot-v1-16b-a3b"),
                              num_layers=CHECK_MOONSHOT_LAYERS)
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        SEED + 11), device=DEVICE)
    eng = Engine(cfg, params, EngineConfig(**SERVE),
                 ExecPolicy(moe_impl="grouped", use_kernels=True),
                 device=DEVICE)
    rng = np.random.default_rng(SEED + 11)
    prompts = [rng.integers(2, cfg.vocab_size, n) for n in
               rng.integers(EXPERT_PROMPT_LENS[0], EXPERT_PROMPT_LENS[1] + 1,
                            8)]
    rids = [eng.submit(p, NEW_TOKENS // 4) for p in prompts]
    out = eng.run_until_idle()
    want = [out[r] for r in rids]
    stores = pack_expert_stores(torch, eng)
    ops.reset_launch_counts()
    try:
        phase_check_expert(torch, np, eng, prompts, want,
                           phase="check_moonshot", stores=stores)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
    finally:
        stores["pw"].release()
    require(launches["expert_gather"] > 0 and launches["moe_ffn"] > 0,
            f"check_moonshot: the expert path never launched: {launches}")
    del eng, params, stores
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_serve_moonshot_expert(torch, np, ops, records):
    """moonshot-v1-16b-a3b at full width through the expert-paged path:
    every layer's 64 experts (17.3 MB spans) drawn on the card layer by
    layer into page-locked host stores, at all 48 layers where the host
    rule holds them (the rule's arithmetic and any cut printed), served
    with a pool of r_w 0.5 in lockstep and then in windows of both groups
    over the same stores (transcripts equal); a trace window of the
    lockstep engine.  Beside each serve: the gather's link bytes against
    ``weight_traffic()``'s booked bytes and against ``h2d_copy``, its
    host copies (one ``cudaMemcpyAsync`` a missed leaf) a layer, and its
    host seconds a call.  Returns the launches of both runs and the
    lockstep numbers."""
    from repro_torch.core import offload
    from repro_torch.models.params import count_params

    full = _family("moonshot-v1-16b-a3b")
    per_layer = store_bytes_per_period(torch, split=True, cfg=full)
    avail = host_mem_available()
    room = host_room(avail)
    layers = min(full.num_layers, int(room // per_layer))
    emit({"phase": "host_rule", "for": "serve_moonshot_expert",
          "host_available": avail, "mem_available": mem_available(),
          "room": room, "rule": "min(available / 1.2, available - 20 GiB)",
          "store_bytes_per_layer": per_layer,
          "layers_that_fit": int(room // per_layer), "layers": layers,
          "of_layers": full.num_layers,
          "cut": layers < full.num_layers})
    require(layers >= MIN_EXPERT_LAYERS,
            f"the host holds {layers} moonshot layers of {per_layer} "
            f"bytes; serve_moonshot_expert needs {MIN_EXPERT_LAYERS}")
    cfg = dataclasses.replace(full, num_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, pw, pin_s, build_s = draw_stores(torch, cfg, split=True)
    stores = {"cfg": cfg, "params": params, "pw": pw, "layers": layers,
              "of_layers": full.num_layers, "params_count": count_params(cfg),
              "store_bytes_per_layer": per_layer,
              "kv_host_bytes_per_layer": 0, "mem_available": avail,
              "pinned_bytes": offload.pinned_bytes(), "pin_s": pin_s,
              "build_s": build_s}
    h2d = next(r for r in records if r["name"] == "expert_gather")[
        "bound_rates"]["h2d_GBps_measured"]
    launches, runs = {}, {}
    try:
        for name, settings in (
                ("serve_moonshot_expert", SERVE_EXPERT),
                ("serve_moonshot_expert_module",
                 {**SERVE_EXPERT, "module_batch": True})):
            torch.cuda.empty_cache()
            eng, launches[name], res = serve_expert_engine(
                torch, np, ops, stores, settings, name)
            tr = res["weight_traffic"]
            emit({"phase": name + "_link", "layers": layers,
                  "decode_tok_per_s": res["decode_tok_per_s"],
                  "gather_host_bytes": res["gather_host_bytes"],
                  "booked_expert_bytes": tr["expert_bytes"],
                  "moved_over_booked": res["gather_host_bytes"]
                  / max(tr["expert_bytes"], 1),
                  "hits": tr["hits"], "misses": tr["misses"],
                  "gather_host_GBps": res["gather_host_GBps"],
                  "h2d_copy_GBps": h2d,
                  "gather_over_h2d_copy": res["gather_host_GBps"] / h2d,
                  "expert_gather_launches":
                      launches[name]["expert_gather"],
                  "host_copies": res["gather_host_copies"],
                  "host_copies_per_layer": res["gather_host_copies"]
                  / res["gather_calls"],
                  "max_host_copies_per_layer":
                      res["gather_max_host_copies"],
                  "gather_host_ms_per_call": 1e3 * res["gather_host_wall_s"]
                  / res["gather_calls"],
                  "gather_stream_ms_per_call": 1e3 * res["gather_s"]
                  / res["gather_calls"]})
            runs[name] = res
            if name == "serve_moonshot_expert":
                # one request: the profiler takes ~13x the window's wall
                # to process 48 layers of gathers and host copies
                phase_trace(torch, np, eng, "moonshot_expert",
                            EXPERT_PROMPT_LENS, 1, EXPERT_NEW_TOKENS // 4)
            del eng
            gc.collect()
    finally:
        pw.release()
    base, mod = runs["serve_moonshot_expert"], \
        runs["serve_moonshot_expert_module"]
    emit({"phase": "serve_moonshot_expert_module_vs_lockstep",
          "identical_requests": sum(a == b for a, b in
                                    zip(mod["transcripts"],
                                        base["transcripts"])),
          "requests_total": len(base["transcripts"]),
          "gather_host_bytes": [base["gather_host_bytes"],
                                mod["gather_host_bytes"]],
          "decode_tok_per_s": [base["decode_tok_per_s"],
                               mod["decode_tok_per_s"]]})
    require(mod["transcripts"] == base["transcripts"],
            "moonshot: the windows' transcripts differ from lockstep's")
    del params, stores
    gc.collect()
    torch.cuda.empty_cache()
    host_memory("after serve_moonshot_expert (stores released)")
    return launches, base


def ssm_leaves(cache) -> dict:
    """The SSM layers' conv tails and states of a cache, copied."""
    return {(k, n): a.clone() for k, g in cache.items() if k != "pos"
            for n, a in g.items() if n.startswith("conv") or n == "state"}


def phase_check_mamba2(torch, np, ops):
    """mamba2-1.3b at full width, ``CHECK_MAMBA2_LAYERS`` of its 48
    layers, float32, on the card: one prompt of ``CHECK_MAMBA2_PROMPT``
    tokens (past one SSD chunk, and not a multiple of 16) prefilled by the
    engine's prefill step at the engine's bucket, the SSM state carried
    from the prompt's true length, then ``CHECK_MAMBA2_STEPS`` decode
    steps: the prefill's last logits and each step's within
    ``CHECK_MAMBA2_TOL`` of a teacher-forced forward over the whole
    sequence.  A second prefill at the prompt's exact width: its SSM
    states and conv tails within ``CHECK_MAMBA2_STATE_TOL`` of the
    bucketed prefill's.  Then static admission's case: one prefill of
    ``CHECK_MAMBA2_ROWS`` (true lengths that are not multiples of 16, and
    a padding row of length 0) in the same bucket, the lengths an int32
    tensor on the card as the engine builds them.  Each row's states and
    conv tails within ``CHECK_MAMBA2_STATE_TOL`` of a prefill of the same
    shape whose rows all hold that row's prompt and length, and within
    ``CHECK_MAMBA2_TOL`` of its prompt prefilled alone at its exact
    width (f32 products on the card give other bits at other row counts
    and widths); its logits within ``CHECK_MAMBA2_TOL`` of both; the
    padding row's states exactly zero.  Printed beside: how far a
    bucketed prefill without the true length (the JAX engine's) moves
    them.  The mixer has no kernel (plain PyTorch in both packages): the
    launches are printed, every count 0."""
    from repro_torch.models import kvcache
    from repro_torch.models.model import ExecPolicy, forward, unembed
    from repro_torch.models.params import init_params
    from repro_torch.serving import steps

    cfg = dataclasses.replace(_family(MAMBA2_ARCH),
                              num_layers=CHECK_MAMBA2_LAYERS,
                              dtype="float32")
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        SEED + 14), device=DEVICE)
    pol = ExecPolicy(use_kernels=True)
    S, n = CHECK_MAMBA2_PROMPT, CHECK_MAMBA2_STEPS
    bucket = min(-(-S // 16) * 16, SERVE["max_seq"])
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 14)
    toks = torch.randint(2, cfg.vocab_size, (1, S + n), generator=g,
                         device=DEVICE, dtype=torch.int32)
    padded = torch.zeros((1, bucket), dtype=torch.int32, device=DEVICE)
    padded[:, :S] = toks[:, :S]
    lens = torch.tensor([S], dtype=torch.int32, device=DEVICE)
    prefill = steps.make_prefill_fill_step(cfg, pol)
    ops.reset_launch_counts()
    full = unembed(cfg, params, forward(cfg, params, toks,
                                        policy=pol)["hidden"])
    caches = {}
    for label, tokens in (("bucket", padded), ("exact", toks[:, :S])):
        caches[label] = kvcache.init_cache(cfg, 1, SERVE["max_seq"],
                                           device=DEVICE)
        logits, _ = prefill(params, tokens, caches[label], lens)
        if label == "bucket":
            first = logits
    states = {k: ssm_leaves(c) for k, c in caches.items()}
    rows = CHECK_MAMBA2_ROWS
    mtoks = torch.zeros((len(rows), bucket), dtype=torch.int32,
                        device=DEVICE)
    mtoks[0, :S] = toks[0, :S]
    for i, m in enumerate(rows[1:], 1):
        mtoks[i, :m] = torch.randint(2, cfg.vocab_size, (m,), generator=g,
                                     device=DEVICE, dtype=torch.int32)
    mcache = kvcache.init_cache(cfg, len(rows), SERVE["max_seq"],
                                device=DEVICE)
    mlogits, _ = prefill(params, mtoks, mcache,
                         torch.as_tensor(np.array(rows, np.int32),
                                         device=DEVICE))
    mstates = ssm_leaves(mcache)
    del mcache
    row_errs = []
    for i, m in enumerate(rows):
        got = {k: v[:, i:i + 1] for k, v in mstates.items()}
        if m == 0:
            require(all(bool((v == 0).all()) for v in got.values()),
                    "check_mamba2: a padding row's SSM state is not zero")
            continue
        errs_i = {}
        for ref_name, tokens, n_rows, tol in (
                ("same_shape", mtoks[i:i + 1], len(rows),
                 CHECK_MAMBA2_STATE_TOL),
                ("exact_width", mtoks[i:i + 1, :m], 1, CHECK_MAMBA2_TOL)):
            c = kvcache.init_cache(cfg, n_rows, SERVE["max_seq"],
                                   device=DEVICE)
            wlogits, _ = prefill(params, tokens.repeat(n_rows, 1), c,
                                 torch.full((n_rows,), m, dtype=torch.int32,
                                            device=DEVICE))
            want = {k: v[:, :1] for k, v in ssm_leaves(c).items()}
            del c
            errs_i[ref_name] = {
                "state": max(max_err(got[k], want[k]) for k in want),
                "logits": max_err(mlogits[i:i + 1], wlogits[:1])}
            require(all(close(got[k], want[k], tol) for k in want),
                    f"check_mamba2: row {i} (length {m}) of one prefill: "
                    f"{errs_i[ref_name]} from the {ref_name} prefill")
            require(close(mlogits[i:i + 1], wlogits[:1], CHECK_MAMBA2_TOL),
                    f"check_mamba2: row {i} (length {m}) logits: "
                    f"{errs_i[ref_name]} from the {ref_name} prefill")
        row_errs.append(errs_i)
    del mstates
    # the JAX engine's prefill: the bucket without the true length
    absorbed = kvcache.init_cache(cfg, 1, SERVE["max_seq"], device=DEVICE)
    forward(cfg, params, padded, cache=absorbed, mode="prefill", policy=pol)
    absorbed = ssm_leaves(absorbed)
    state_err = max(max_err(states["bucket"][k], states["exact"][k])
                    for k in states["exact"])
    padding_moves = max(max_err(absorbed[k], states["exact"][k])
                        for k in states["exact"])
    require(all(close(states["bucket"][k], states["exact"][k],
                      CHECK_MAMBA2_STATE_TOL) for k in states["exact"]),
            f"check_mamba2: the bucketed prefill's state is {state_err} "
            f"from the exact width's")
    errs = [max_err(first, full[:, S - 1])]
    require(close(first, full[:, S - 1], CHECK_MAMBA2_TOL),
            f"check_mamba2 prefill: {errs[0]}")
    cache = caches["bucket"]
    for t in range(n):
        fwd = forward(cfg, params, toks[:, S + t:S + t + 1], cache=cache,
                      mode="decode", policy=pol)
        got = unembed(cfg, params, fwd["hidden"][:, -1])
        want = full[:, S + t]
        require(bool(torch.isfinite(got).all()), "check_mamba2: not finite")
        errs.append(max_err(got, want))
        require(close(got, want, CHECK_MAMBA2_TOL),
                f"check_mamba2 step {t}: {errs[-1]}")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    emit({"phase": "check_mamba2", "model": MAMBA2_ARCH,
          "layers": cfg.num_layers, "of_layers": _family(MAMBA2_ARCH)
          .num_layers, "dtype": "float32", "prompt": S, "bucket": bucket,
          "ssd_chunk": cfg.ssm_chunk, "decode_steps": n,
          "max_abs_logit_diff": max(errs), "per_step": errs,
          "tol": CHECK_MAMBA2_TOL,
          "bucket_vs_exact_state_max_abs_diff": state_err,
          "state_tol": CHECK_MAMBA2_STATE_TOL,
          "padding_absorbed_state_max_abs_diff": padding_moves,
          "rows": list(rows),
          "rows_max_abs_diff": row_errs,
          "launches": launches})
    require(padding_moves > 1e3 * CHECK_MAMBA2_STATE_TOL,
            f"check_mamba2: the padding moved the state by only "
            f"{padding_moves}: the check sees nothing")
    del params, full, caches, cache
    torch.cuda.empty_cache()
    return launches


def phase_serve_mamba2(torch, np, ops):
    """mamba2-1.3b at full width and all 48 layers, every weight on the
    card (bf16): ``MAMBA2_REQUESTS`` seeded prompts of ``PROMPT_LENS``
    tokens, most of them not multiples of 16, x ``MAMBA2_NEW_TOKENS``,
    through ``serve``'s settings in lockstep, in windows of both groups
    (``_module``: transcripts equal to lockstep's) and in static mode
    (``_static``: how many transcripts equal lockstep's is printed; its
    micro-batches prefill 8 rows at once, whose bf16 products differ);
    a trace window of the lockstep engine.  Returns each run's launches
    (the mixer runs no kernel)."""
    from repro_torch.models.model import ExecPolicy
    from repro_torch.models.params import count_params, init_params
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = _family(MAMBA2_ARCH)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(SEED),
                         device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    launches, outs = {}, {}
    for name, settings in (
            ("serve_mamba2", SERVE),
            ("serve_mamba2_module", {**SERVE, "module_batch": True}),
            ("serve_mamba2_static", SERVE_STATIC)):
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(cfg, params, EngineConfig(**settings),
                     ExecPolicy(moe_impl="grouped", use_kernels=True),
                     device=DEVICE)
        prompts, res, outs[name] = serve_run(
            torch, np, eng, ops, PROMPT_LENS, MAMBA2_REQUESTS, SEED + 13,
            MAMBA2_NEW_TOKENS)
        emit({"phase": name, "model": MAMBA2_ARCH, "layers": cfg.num_layers,
              "of_layers": cfg.num_layers, "params": count_params(cfg),
              "init_s": init_s, "engine": settings, **res,
              "prompt_lens": [len(p) for p in prompts],
              "prompts_not_multiple_of_16": sum(len(p) % 16 != 0
                                                for p in prompts),
              "identical_to_lockstep": sum(
                  a == b for a, b in zip(outs[name], outs["serve_mamba2"])),
              "requests_total": len(prompts)})
        launches[name] = res["launches"]
        if name == "serve_mamba2":
            # 1 request x 8 tokens: ~90 small ops a layer a step
            phase_trace(torch, np, eng, MAMBA2_ARCH, PROMPT_LENS, 1, 8)
        del eng
        gc.collect()
    require(outs["serve_mamba2_module"] == outs["serve_mamba2"],
            "mamba2: the windows' transcripts differ from lockstep's")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_serve_jamba_expert(torch, np, ops, records):
    """jamba-1.5-large at full width, one period (``JAMBA_LAYERS`` of its
    72 layers) with int8 experts, random weights from a seed: a resident
    engine (~52 GB on the card) serves ``JAMBA_REQUESTS`` requests; its
    blocks are then packed into page-locked expert-paged stores (the
    mixers, the dense FFNs and the attention layer in the shared spans,
    the four MoE positions' experts in 604 MB spans), the resident engine
    is freed, and an expert-paged engine at r_w 0.5 over the block arena
    at r_c 0.5 serves the same requests: transcripts equal, request for
    request.  The int8 experts' scales travel in the shared span in bf16,
    so the resident engine runs on scales rounded to bf16 too.  Prints
    decode tok/s, the gather's link bytes a token a layer, its bytes
    beside ``weight_traffic()``'s booked ones and ``h2d_copy``, and its
    host copies a layer.  Returns the launches of both runs."""
    from repro_torch.core import offload
    from repro_torch.models.model import ExecPolicy
    from repro_torch.models.params import count_params, init_params
    from repro_torch.serving.engine import Engine, EngineConfig

    full = _family(JAMBA_ARCH)
    cfg = dataclasses.replace(full, num_layers=JAMBA_LAYERS,
                              expert_dtype="int8")
    need = store_bytes_per_period(torch, split=True, cfg=cfg)
    avail = host_mem_available()
    emit({"phase": "host_rule", "for": "serve_jamba_expert",
          "host_available": avail, "mem_available": mem_available(),
          "room": host_room(avail),
          "rule": "min(available / 1.2, available - 20 GiB)",
          "store_bytes_per_period": need, "periods": 1,
          "layers": cfg.num_layers, "of_layers": full.num_layers})
    require(need <= host_room(avail),
            f"the host holds {host_room(avail)} bytes of stores; one jamba "
            f"period needs {need}")
    workload = (JAMBA_PROMPT_LENS, JAMBA_REQUESTS, SEED + 12,
                JAMBA_NEW_TOKENS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        SEED + 12), device=DEVICE)
    for g in params["blocks"].values():
        if "moe" in g:                 # the scales the shared span holds
            for n in ("wi_scale", "wo_scale"):
                g["moe"][n] = g["moe"][n].to(torch.bfloat16).float()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.nbytes for t in _leaves(params))
    eng = Engine(cfg, params, EngineConfig(**JAMBA_SERVE),
                 ExecPolicy(moe_impl="grouped", use_kernels=True),
                 device=DEVICE)
    _, res, want = serve_run(torch, np, eng, ops, *workload)
    emit({"phase": "serve_jamba", "model": JAMBA_ARCH,
          "layers": cfg.num_layers, "of_layers": full.num_layers,
          "params": count_params(cfg), "weight_bytes": weight_bytes,
          "init_s": init_s, "engine": JAMBA_SERVE, **res})
    launches = {"serve_jamba": res["launches"]}
    require(all(res["launches"][k] > 0 for k in
                ("moe_ffn", "gqa_decode", "flash_prefill")),
            f"serve_jamba: a kernel of the path never launched: "
            f"{res['launches']}")
    torch.cuda.synchronize()
    packed = pack_expert_stores(torch, eng)
    pw = packed["pw"]
    del eng
    params = {k: v for k, v in params.items() if k != "blocks"}
    gc.collect()
    torch.cuda.empty_cache()
    host_memory("serve_jamba_expert stores packed, resident blocks freed")
    stores = {"cfg": cfg, "params": params, "pw": pw,
              "layers": cfg.num_layers, "of_layers": full.num_layers,
              "params_count": count_params(cfg),
              "store_bytes_per_layer": need / cfg.num_layers,
              "kv_host_bytes_per_layer": 0, "mem_available": avail,
              "pinned_bytes": offload.pinned_bytes(),
              "pin_s": packed["pack_s"], "build_s": init_s}
    h2d = next(r for r in records if r["name"] == "expert_gather")[
        "bound_rates"]["h2d_GBps_measured"]
    try:
        torch.cuda.reset_peak_memory_stats()
        eng, launches["serve_jamba_expert"], ex = serve_expert_engine(
            torch, np, ops, stores, JAMBA_EXPERT, "serve_jamba_expert",
            workload)
        tr = ex["weight_traffic"]
        tokens = sum(len(t) for t in ex["transcripts"])
        emit({"phase": "serve_jamba_expert_link", "layers": cfg.num_layers,
              "moe_layers": sum(s.moe for s in cfg.period),
              "decode_tok_per_s": ex["decode_tok_per_s"],
              "resident_decode_tok_per_s": res["decode_tok_per_s"],
              "shared_bytes": tr["shared_bytes"],
              "shared_bytes_per_pass": sum(
                  pw.shared_layer_bytes(k) * pw.manifests[k].num_layers
                  for k in pw.manifests),
              "gather_host_bytes": ex["gather_host_bytes"],
              "booked_expert_bytes": tr["expert_bytes"],
              "moved_over_booked": ex["gather_host_bytes"]
              / max(tr["expert_bytes"], 1),
              "gather_bytes_per_token_layer": ex["gather_host_bytes"]
              / tokens / cfg.num_layers,
              "link_bytes_per_token_layer": (ex["gather_host_bytes"]
                                             + tr["shared_bytes"])
              / tokens / cfg.num_layers,
              "hits": tr["hits"], "misses": tr["misses"],
              "gather_host_GBps": ex["gather_host_GBps"],
              "h2d_copy_GBps": h2d,
              "host_copies": ex["gather_host_copies"],
              "host_copies_per_moe_layer": ex["gather_host_copies"]
              / ex["gather_calls"],
              "max_host_copies_per_moe_layer":
                  ex["gather_max_host_copies"],
              "kv_traffic": eng.kv_traffic()})
        emit({"phase": "serve_jamba_expert_vs_resident",
              "identical_requests": sum(a == b for a, b in
                                        zip(ex["transcripts"], want)),
              "requests_total": len(want)})
        require(ex["transcripts"] == want,
                "jamba: the expert-paged transcripts differ from the "
                "resident engine's")
        del eng
        gc.collect()
    finally:
        pw.release()
    del params, stores
    gc.collect()
    torch.cuda.empty_cache()
    host_memory("after serve_jamba_expert (stores released)")
    return launches


def serve_forward(torch, cfg, params, requests, extra: str, policy,
                  max_seq: int, new_tokens: int):
    """Greedy serving through ``forward``: each request (``concrete_inputs``
    of one row: its "tokens" and its `extra` frontend input) prefilled
    alone into a batch-1 cache whose row is then copied into one batch
    cache (``kvcache.insert_slot``: the rings, ``pos`` and whisper's
    cross K / V), then ``new_tokens - 1`` cached decode steps of the whole
    batch, each row at its own position.  Returns the transcripts
    (``new_tokens`` each, the prefill's token first), the synchronized
    prefill and decode seconds, and whether every logit was finite."""
    from repro_torch.models import kvcache
    from repro_torch.models.model import forward, unembed
    cache = kvcache.init_cache(cfg, len(requests), max_seq, device=DEVICE)
    finite = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = []
    for row, r in enumerate(requests):
        single = kvcache.init_cache(cfg, 1, max_seq, device=DEVICE)
        fwd = forward(cfg, params, r["tokens"], cache=single, mode="prefill",
                      policy=policy, **{extra: r[extra]})
        logits = unembed(cfg, params, fwd["hidden"][:, -1])
        finite &= bool(torch.isfinite(logits).all())
        first.append(logits.argmax(-1))
        kvcache.insert_slot(cache, single, row)
        del single, fwd
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tok = torch.stack(first)                                  # (B, 1)
    out = [tok]
    for _ in range(new_tokens - 1):
        fwd = forward(cfg, params, tok, cache=cache, mode="decode",
                      policy=policy)
        logits = unembed(cfg, params, fwd["hidden"][:, -1])
        finite &= bool(torch.isfinite(logits).all())
        tok = logits.argmax(-1, keepdim=True)
        out.append(tok)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return torch.cat(out, 1).tolist(), t1 - t0, t2 - t1, finite


def serve_forward_phase(torch, ops, cfg, params, requests, extra, phase,
                        max_seq, new_tokens, expected):
    """``serve_forward`` through the kernels (every count set to 0 just
    before, read just after; the launches must equal `expected`, the count
    of one launch a layer a forward), then through the plain versions on
    the same requests (``ExecPolicy(impl="ref")``): how many transcripts
    agree is printed.  Returns the kernel path's launches."""
    from repro_torch.models.model import ExecPolicy
    from repro_torch.models.params import count_params
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    outs, prefill_s, decode_s, finite = serve_forward(
        torch, cfg, params, requests, extra, ExecPolicy(use_kernels=True),
        max_seq, new_tokens)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    plain, plain_prefill_s, plain_decode_s, plain_finite = serve_forward(
        torch, cfg, params, requests, extra, ExecPolicy(impl="ref"),
        max_seq, new_tokens)
    B = len(requests)
    decode_tokens = B * (new_tokens - 1)
    emit({"phase": phase, "model": cfg.name, "layers": cfg.num_layers,
          "of_layers": cfg.num_layers,
          "encoder_layers": cfg.encoder_layers,
          "params": count_params(cfg),
          "requests": B,
          "prompt_lens": [int(r["tokens"].shape[1]) for r in requests],
          "new_tokens_each": new_tokens, "prefill_s": prefill_s,
          "decode_s": decode_s, "decode_tokens": decode_tokens,
          "decode_tok_per_s": decode_tokens / decode_s,
          "max_memory_allocated": peak, "launches": launches,
          "expected_launches": expected,
          "plain_prefill_s": plain_prefill_s,
          "plain_decode_tok_per_s": decode_tokens / plain_decode_s,
          "identical_to_plain": sum(a == b for a, b in zip(outs, plain)),
          "requests_total": B})
    require(finite and plain_finite, f"{phase}: logits not finite")
    require(all(0 <= t < cfg.vocab_size for o in outs for t in o)
            and all(len(o) == new_tokens for o in outs),
            f"{phase}: transcripts malformed")
    require(all(launches[k] == n for k, n in expected.items()),
            f"{phase}: launches {launches}, expected {expected}")
    return launches


def check_paths(torch, cfg, params, tokens, extras, steps, tol, phase):
    """Prefill `tokens` (with `extras`, the frontend inputs) into a cache,
    then `steps` greedy decode steps, through the kernels (counted) and
    then through the plain versions fed the same tokens: the logits of the
    prefill and of every step within `tol` of the plain path's, and
    whisper's persisted cross K / V too.  Returns the launches, the largest
    differences and the kernel path's prefill logits."""
    from repro_torch.kernels import ops
    from repro_torch.models import kvcache
    from repro_torch.models.model import ExecPolicy, forward, unembed
    B, S = tokens.shape
    errs, logits, caches, fed = {}, {}, {}, []
    for label, pol in (("kernels", ExecPolicy(use_kernels=True)),
                       ("plain", ExecPolicy(impl="ref"))):
        ops.reset_launch_counts()
        cache = kvcache.init_cache(cfg, B, S + steps + 1, device=DEVICE)
        fwd = forward(cfg, params, tokens, cache=cache, mode="prefill",
                      policy=pol, **extras)
        out = [unembed(cfg, params, fwd["hidden"])]
        for t in range(steps):
            if label == "kernels":
                fed.append(out[-1][:, -1].argmax(-1, keepdim=True))
            fwd = forward(cfg, params, fed[t], cache=cache, mode="decode",
                          policy=pol)
            out.append(unembed(cfg, params, fwd["hidden"]))
        torch.cuda.synchronize()
        if label == "kernels":
            launches = ops.launch_counts()
        logits[label], caches[label] = out, cache
    for t, (a, b) in enumerate(zip(logits["kernels"], logits["plain"])):
        name = "prefill" if t == 0 else f"decode{t - 1}"
        require(bool(torch.isfinite(a).all()), f"{phase} {name}: not finite")
        errs[name] = max_err(a, b)
        require(close(a, b, tol), f"{phase} {name}: {errs[name]}")
    if "xattn" in caches["kernels"]:
        for k in ("k", "v"):
            a, b = caches["kernels"]["xattn"][k], caches["plain"]["xattn"][k]
            errs["xattn_" + k] = max_err(a, b)
            require(close(a, b, tol),
                    f"{phase} xattn {k}: {errs['xattn_' + k]}")
    return launches, errs, logits["kernels"][0]


def phase_check_whisper(torch, np, ops):
    """whisper-small at full width, ``CHECK_WHISPER_LAYERS`` of its 12
    encoder and 12 decoder layers, float32, random weights from a seed:
    ``concrete_inputs``' tokens and 1500 frames a row, prefilled, then
    ``CHECK_STEPS`` greedy decode steps through the kernels (the encoder's
    and the cross-attention's non-causal flash_prefill, one decode query
    over the encoder keys, the decoder's causal flash_prefill and
    gqa_decode) against the plain path within ``F32_TOL``.  Returns the
    launches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.inputs import concrete_inputs
    from repro_torch.models.params import init_params
    L = CHECK_WHISPER_LAYERS
    cfg = dataclasses.replace(_family(WHISPER_ARCH), num_layers=L,
                              encoder_layers=L, dtype="float32")
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        SEED + 14), device=DEVICE)
    inp = concrete_inputs(cfg, ShapeConfig(
        "check_whisper", CHECK_WHISPER_PROMPT, CHECK_WHISPER_BATCH,
        "prefill"), seed=SEED + 14, device=DEVICE)
    launches, errs, _ = check_paths(
        torch, cfg, params, inp["tokens"], {"frames": inp["frames"]},
        CHECK_STEPS, F32_TOL, "check_whisper")
    expected = {"flash_prefill": 3 * L + CHECK_STEPS * L,
                "gqa_decode": CHECK_STEPS * L}
    emit({"phase": "check_whisper", "layers": L, "encoder_layers": L,
          "batch": CHECK_WHISPER_BATCH, "prompt": CHECK_WHISPER_PROMPT,
          "frames": cfg.encoder_seq, "decode_steps": CHECK_STEPS,
          "dtype": "float32", "max_abs_diff": errs, "tol": F32_TOL,
          "launches": launches, "expected_launches": expected})
    require(all(launches[k] == n for k, n in expected.items()),
            f"check_whisper: launches {launches}, expected {expected}")
    del params
    torch.cuda.empty_cache()
    return launches


def phase_check_paligemma(torch, np, ops):
    """paligemma-3b at full width, ``CHECK_PALIGEMMA_LAYERS`` of its 18
    layers, float32: ``concrete_inputs``' 256 patches and 256 + 96 tokens
    a row (the first 256 replaced by the patches), prefilled, then
    ``CHECK_STEPS`` greedy decode steps through the kernels against the
    plain path within ``F32_TOL``; and the prefix must move every text
    position's prefill logits (against the same tokens without patches)
    by more than ``PREFIX_EFFECT``.  Returns the launches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import kvcache
    from repro_torch.models.inputs import concrete_inputs
    from repro_torch.models.model import ExecPolicy, forward, unembed
    from repro_torch.models.params import init_params
    L = CHECK_PALIGEMMA_LAYERS
    cfg = dataclasses.replace(_family(PALIGEMMA_ARCH), num_layers=L,
                              dtype="float32")
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        SEED + 15), device=DEVICE)
    nv = cfg.vision_tokens
    inp = concrete_inputs(cfg, ShapeConfig(
        "check_paligemma", nv + CHECK_PALIGEMMA_TEXT,
        CHECK_PALIGEMMA_BATCH, "prefill"), seed=SEED + 15, device=DEVICE)
    launches, errs, with_prefix = check_paths(
        torch, cfg, params, inp["tokens"], {"patches": inp["patches"]},
        CHECK_STEPS, F32_TOL, "check_paligemma")
    B, S = inp["tokens"].shape
    text = unembed(cfg, params, forward(
        cfg, params, inp["tokens"],
        cache=kvcache.init_cache(cfg, B, S + 1, device=DEVICE),
        mode="prefill", policy=ExecPolicy(use_kernels=True))["hidden"])
    moved = (with_prefix[:, nv:] - text[:, nv:]).abs().amax(-1)   # (B, T)
    effect = float(moved.min())
    expected = {"flash_prefill": L, "gqa_decode": CHECK_STEPS * L}
    emit({"phase": "check_paligemma", "layers": L,
          "batch": CHECK_PALIGEMMA_BATCH, "vision_tokens": nv,
          "text_tokens": CHECK_PALIGEMMA_TEXT, "decode_steps": CHECK_STEPS,
          "dtype": "float32", "max_abs_diff": errs, "tol": F32_TOL,
          "prefix_effect_min": effect, "prefix_effect_bound": PREFIX_EFFECT,
          "launches": launches, "expected_launches": expected})
    require(all(launches[k] == n for k, n in expected.items()),
            f"check_paligemma: launches {launches}, expected {expected}")
    require(effect > PREFIX_EFFECT,
            f"check_paligemma: the prefix moves a text position's logits "
            f"by only {effect}")
    del params, with_prefix, text
    torch.cuda.empty_cache()
    return launches


def forward_requests(np, cfg, n, lens, extra_len, seed):
    """`n` requests of ``concrete_inputs`` draws, one row each: prompts of
    ``extra_len`` + lens[0]..lens[1] tokens (paligemma's prefix in front)
    and their frontend input."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.inputs import concrete_inputs
    rng = np.random.default_rng(seed)
    return [concrete_inputs(cfg, ShapeConfig(f"request{i}",
                                             extra_len + int(m), 1,
                                             "prefill"),
                            seed=seed + i, device=DEVICE)
            for i, m in enumerate(rng.integers(lens[0], lens[1] + 1, n))]


def phase_serve_whisper(torch, np, ops):
    """whisper-small at full width and depth (12 encoder and 12 decoder
    layers, bf16), random weights from a seed: ``WHISPER_REQUESTS``
    requests of 1500 frames and 4..64 prompt tokens, ``WHISPER_NEW_TOKENS``
    greedy tokens each, through ``serve_forward`` (the prefill seconds
    include the encoder); then a trace window of one request's prefill
    and 8 decode steps.  Returns the launches."""
    from repro_torch.models.model import ExecPolicy
    from repro_torch.models.params import init_params
    cfg = _family(WHISPER_ARCH)
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(SEED),
                         device=DEVICE)
    reqs = forward_requests(np, cfg, WHISPER_REQUESTS,
                            WHISPER_PROMPT_LENS, 0, SEED + 16)
    L, n, steps = cfg.num_layers, WHISPER_REQUESTS, WHISPER_NEW_TOKENS - 1
    # a prefill: the encoder's layers and the decoder's self- and cross-
    # attention; a decode step: gqa_decode and the cross-attention
    expected = {"flash_prefill": n * (cfg.encoder_layers + 2 * L)
                + steps * L, "gqa_decode": steps * L}
    launches = serve_forward_phase(
        torch, ops, cfg, params, reqs, "frames", "serve_whisper",
        WHISPER_MAX_SEQ, WHISPER_NEW_TOKENS, expected)
    trace_window(torch, WHISPER_ARCH, lambda: serve_forward(
        torch, cfg, params, reqs[:1], "frames", ExecPolicy(use_kernels=True),
        WHISPER_MAX_SEQ, 9), requests=1, new_tokens_each=9)
    del params, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return {"serve_whisper": launches}


def phase_serve_paligemma(torch, np, ops):
    """paligemma-3b at full width and all 18 layers (bf16), random weights
    from a seed: ``PALIGEMMA_REQUESTS`` requests of 256 patches + 32..128
    text tokens, ``PALIGEMMA_NEW_TOKENS`` greedy tokens each, through
    ``serve_forward``; then text only through the engine over the dense
    ring at ``serve``'s settings (``FAMILY_REQUESTS`` prompts of
    ``PROMPT_LENS``, ``FAMILY_NEW_TOKENS`` each) and a trace window of it.
    Returns each run's launches."""
    from repro_torch.models.model import ExecPolicy
    from repro_torch.models.params import count_params, init_params
    from repro_torch.serving.engine import Engine, EngineConfig
    cfg = _family(PALIGEMMA_ARCH)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(SEED),
                         device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reqs = forward_requests(np, cfg, PALIGEMMA_REQUESTS,
                            PALIGEMMA_TEXT_LENS, cfg.vision_tokens,
                            SEED + 17)
    L, steps = cfg.num_layers, PALIGEMMA_NEW_TOKENS - 1
    expected = {"flash_prefill": PALIGEMMA_REQUESTS * L,
                "gqa_decode": steps * L}
    launches = {"serve_paligemma": serve_forward_phase(
        torch, ops, cfg, params, reqs, "patches", "serve_paligemma",
        PALIGEMMA_MAX_SEQ, PALIGEMMA_NEW_TOKENS, expected)}
    del reqs
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, EngineConfig(**SERVE),
                 ExecPolicy(moe_impl="grouped", use_kernels=True),
                 device=DEVICE)
    _, res, _ = serve_run(torch, np, eng, ops, PROMPT_LENS, FAMILY_REQUESTS,
                          SEED + 18, FAMILY_NEW_TOKENS)
    emit({"phase": "serve_paligemma_engine", "model": PALIGEMMA_ARCH,
          "layers": L, "of_layers": L, "params": count_params(cfg),
          "init_s": init_s, "engine": SERVE, "text_only": True, **res})
    require(all(res["launches"][k] > 0 for k in ("gqa_decode",
                                                  "flash_prefill")),
            f"serve_paligemma_engine: a kernel of the path never launched: "
            f"{res['launches']}")
    launches["serve_paligemma_engine"] = res["launches"]
    phase_trace(torch, np, eng, PALIGEMMA_ARCH, PROMPT_LENS, 2, 8)
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build, ops

    t0 = time.perf_counter()
    libs = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(libs), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    host_memory("start")
    records = phase_kernels(torch, F)
    torch.cuda.empty_cache()
    # the training path while the card is empty (train_mixtral's peak is
    # ~50 GB)
    launches_train_check = phase_train_check(torch, np, ops)
    launches_train_plan = phase_train_plan(torch, np, ops)
    # tensor parallelism: two ranks on the card, against the one-rank step
    launches_tp = phase_tp(torch, np, ops)
    launches_train = phase_train_mixtral(torch, np, ops)
    eng, serve_prompts, launches, serve_outs, serve_res = phase_serve(
        torch, np, ops)
    launches_module = phase_serve_module(torch, np, ops, eng.params,
                                         serve_outs, launches)
    launches_static = phase_serve_static(torch, np, ops, eng.params,
                                         serve_outs)
    eng_paged, launches_paged, paged_outs, paged_res = phase_serve_paged(
        torch, np, ops, eng.params)
    launches_static_paged = phase_serve_static_paged(torch, np, ops,
                                                     eng.params, paged_outs)
    launches_overlap = phase_serve_overlap(torch, np, ops, eng.params,
                                           paged_outs)
    launches_budget = phase_serve_budget(torch, np, ops, eng.params,
                                         paged_res)
    phase_trace(torch, np, eng, "dense", PROMPT_LENS, 8)
    phase_trace(torch, np, eng_paged, "paged", PAGED_PROMPT_LENS, 16)
    engine_prompts, dense_runs = phase_check(torch, np, eng.cfg, eng.params,
                                             serve_prompts[:2], eng,
                                             eng_paged)
    expert_stores = pack_expert_stores(torch, eng)
    phase_check_expert(torch, np, eng, engine_prompts, dense_runs,
                       stores=expert_stores)
    launches_check_kv = phase_check_expert_kv(torch, np, ops, eng,
                                              expert_stores)
    launches_chaos = phase_chaos(torch, np, ops, eng, expert_stores)
    expert_stores["pw"].release()
    del expert_stores
    launches_check_static = phase_check_static(torch, np, ops, eng.cfg,
                                               eng.params, serve_prompts[:8])
    launches_sample = phase_sample(torch, np, ops, eng.cfg, eng.params,
                                   serve_prompts[:8])
    # the distributed layer: plans over meshes of one rank on nccl
    launches_serve_plan = phase_serve_plan(torch, np, ops, eng.params)
    # int8 expert weights and int8 KV through the three kernels' int8
    # paths, 4 layers on the card
    eng8, _, launches_int8, _ = phase_serve_int8(torch, np, ops, serve_res)
    eng8_paged, launches_paged_int8 = phase_serve_paged_int8(
        torch, np, ops, eng8.params, paged_res)
    prompts8, dense8 = phase_check_int8(torch, np, eng8.cfg, eng8.params,
                                        serve_prompts[:2], eng8, eng8_paged)
    phase_check_expert_int8(torch, np, eng8, prompts8, dense8)
    # the last models each need most of the card's or the host's memory:
    # the 4-layer mixtral engines go first, then the whole-layer stores,
    # then the expert stores.  The host may not get a released store's
    # memory back (MemAvailable stays down; the process reuses it), so
    # each phase sizes its stores by the MemAvailable it reads
    del eng, eng_paged, eng8, eng8_paged
    gc.collect()
    torch.cuda.empty_cache()
    # all 32 layers with int8 experts first, while the host holds the most
    host_memory("before serve_expert_int8")
    eng_int8, launches_expert_int8, stores8, int8_res = \
        phase_serve_expert_int8(torch, np, ops, records)
    phase_trace(torch, np, eng_int8, "expert_int8", EXPERT_PROMPT_LENS,
                EXPERT_TRACE_REQUESTS, EXPERT_NEW_TOKENS // 4)
    del eng_int8
    stores8["pw"].release()
    expert_int8_layers = stores8["layers"]
    del stores8
    gc.collect()
    torch.cuda.empty_cache()
    host_memory("after serve_expert_int8 (stores released)")
    launches_layer, layer_res = phase_serve_layer_paged(torch, np, ops,
                                                        records)
    gc.collect()
    host_memory("after serve_layer_paged (stores released)")
    eng_expert, launches_expert, stores, expert_res = phase_serve_expert(
        torch, np, ops)
    phase_trace(torch, np, eng_expert, "expert", EXPERT_PROMPT_LENS,
                EXPERT_TRACE_REQUESTS, EXPERT_NEW_TOKENS // 4)
    # the stores stay pinned for the module-batched engine; the first
    # engine's device pool goes first
    del eng_expert
    gc.collect()
    eng_expert, launches_expert_module, module_res = \
        phase_serve_expert_module(torch, np, ops, stores, expert_res)
    phase_trace(torch, np, eng_expert, "expert_module", EXPERT_PROMPT_LENS,
                EXPERT_TRACE_REQUESTS, EXPERT_NEW_TOKENS // 4)
    del eng_expert
    gc.collect()
    # both offload ratios at once, over the same stores
    eng_expert, launches_expert_kv = phase_serve_expert_kv(
        torch, np, ops, stores, module_res)
    stores["pw"].release()
    del eng_expert
    gc.collect()
    host_memory("after serve_expert_kv (stores released)")
    phase_policy(torch, records, stores, expert_res)
    expert_layers = stores["layers"]
    del stores
    gc.collect()
    # link bytes a token a layer: whole-layer streaming of a large static
    # batch against the expert-paged windows (the gather's bytes, and with
    # the shared spans streamed every pass)
    expert_tokens = sum(len(t) for t in module_res["transcripts"])
    shared = module_res["weight_traffic"]["shared_bytes"]
    emit({"phase": "link_bytes_per_token_layer",
          "serve_layer_paged": layer_res["bytes_per_token_layer"],
          "serve_expert_module_gather": module_res["gather_host_bytes"]
          / expert_tokens / expert_layers,
          "serve_expert_module_gather_and_shared": (
              module_res["gather_host_bytes"] + shared)
          / expert_tokens / expert_layers,
          "serve_expert_int8_gather": int8_res[
              "gather_bytes_per_token_layer"],
          "tokens": [layer_res["tokens"], expert_tokens, int8_res["tokens"]],
          "layers": [LAYER_PAGED_LAYERS, expert_layers, expert_int8_layers]})
    # the families of this slice: moonshot's 64-expert MoE through the
    # expert-paged path (4 layers resident against expert-paged, then the
    # whole stack from host stores), then gemma2, glm4 and olmo at full
    # width and depth with every weight on the card
    launches_check_moonshot = phase_check_moonshot(torch, np, ops)
    launches_moonshot, _ = phase_serve_moonshot_expert(torch, np, ops,
                                                       records)
    launches_check_gemma2 = phase_check_gemma2(torch, np, ops)
    launches_gemma2 = phase_serve_family(
        torch, np, ops, "gemma2-2b", "serve_gemma2", GEMMA2_SERVE,
        GEMMA2_PAGED, GEMMA2_PROMPT_LENS, GEMMA2_NEW_TOKENS,
        trace_lens=GEMMA2_PROMPT_LENS)
    launches_glm4 = phase_serve_family(
        torch, np, ops, "glm4-9b", "serve_glm4", SERVE, FAMILY_PAGED,
        PROMPT_LENS, FAMILY_NEW_TOKENS)
    launches_olmo = phase_serve_family(
        torch, np, ops, "olmo-1b", "serve_olmo", SERVE, FAMILY_PAGED,
        PROMPT_LENS, FAMILY_NEW_TOKENS)
    # the SSM slice: mamba2 (4 layers in f32 against teacher forcing, then
    # all 48 resident), then one period of jamba, resident and then
    # expert-paged over the block arena
    launches_check_mamba2 = phase_check_mamba2(torch, np, ops)
    launches_mamba2 = phase_serve_mamba2(torch, np, ops)
    host_memory("before serve_jamba_expert")
    launches_jamba = phase_serve_jamba_expert(torch, np, ops, records)
    # the encoder-decoder and VLM slice: whisper (2 + 2 layers in f32,
    # then all 12 + 12) and paligemma (2 layers in f32, then all 18)
    launches_check_whisper = phase_check_whisper(torch, np, ops)
    launches_whisper = phase_serve_whisper(torch, np, ops)
    launches_check_paligemma = phase_check_paligemma(torch, np, ops)
    launches_paligemma = phase_serve_paligemma(torch, np, ops)
    launches_launch = phase_launch(torch, ops)
    eng_mla, mla_prompts, launches_mla = phase_serve_mla(torch, np, ops)
    phase_trace(torch, np, eng_mla, "mla", PAGED_PROMPT_LENS, 16)
    phase_check_mla(torch, np, eng_mla.cfg, eng_mla.params, mla_prompts)

    by_path = {"paged_gqa_decode": launches_paged,
               "paged_mla_decode": launches_mla,
               "expert_gather": launches_expert,
               "flash_prefill_d256": launches_gemma2["serve_gemma2"],
               "flash_prefill_bwd": launches_train}
    # the launches of the later slices' paths, beside each kernel's main
    # path
    new_paths = {"train_check": launches_train_check,
                 "train_plan": launches_train_plan, **launches_serve_plan,
                 **launches_tp,
                 "train_mixtral": launches_train,
                 "serve_module": launches_module,
                 "serve_overlap": launches_overlap,
                 "serve_expert_module": launches_expert_module,
                 "serve_budget": launches_budget,
                 "check_expert_kv": launches_check_kv,
                 "chaos": launches_chaos,
                 "serve_expert_kv": launches_expert_kv,
                 **launches_static,
                 "serve_static_paged": launches_static_paged,
                 **launches_check_static,
                 "sample": launches_sample,
                 "serve_layer_paged": launches_layer,
                 **launches_launch,
                 "serve_int8": launches_int8,
                 "serve_paged_int8": launches_paged_int8,
                 "serve_expert_int8": launches_expert_int8,
                 "check_moonshot": launches_check_moonshot,
                 **launches_moonshot,
                 "check_gemma2": launches_check_gemma2,
                 **launches_gemma2, **launches_glm4, **launches_olmo,
                 "check_mamba2": launches_check_mamba2, **launches_mamba2,
                 **launches_jamba,
                 "check_whisper": launches_check_whisper, **launches_whisper,
                 "check_paligemma": launches_check_paligemma,
                 **launches_paligemma}
    # each family shape's main path
    family_paths = {
        ("moe_ffn", "moonshot-v1-16b-a3b"):
            launches_moonshot["serve_moonshot_expert"],
        ("gqa_decode", "glm4-9b"): launches_glm4["serve_glm4"],
        ("gqa_decode", "gemma2-2b"): launches_gemma2["serve_gemma2"],
        ("paged_gqa_decode", "gemma2-2b"):
            launches_gemma2["serve_gemma2_paged"],
        ("moe_ffn", JAMBA_ARCH): launches_jamba["serve_jamba_expert"],
        ("flash_prefill", JAMBA_ARCH): launches_jamba["serve_jamba"],
        ("gqa_decode", JAMBA_ARCH): launches_jamba["serve_jamba"],
        ("paged_gqa_decode", JAMBA_ARCH):
            launches_jamba["serve_jamba_expert"],
        ("flash_prefill", WHISPER_ARCH): launches_whisper["serve_whisper"],
        ("gqa_decode", WHISPER_ARCH): launches_whisper["serve_whisper"],
        ("flash_prefill_d256", PALIGEMMA_ARCH):
            launches_paligemma["serve_paligemma"],
        ("gqa_decode", PALIGEMMA_ARCH):
            launches_paligemma["serve_paligemma"]}
    for rec in records:
        # the wide flash_prefill body counts under its wrapper's name
        counter = rec["name"].removesuffix("_d256")
        rec["launches"] = by_path.get(rec["name"], launches)[counter]
        rec["launches_by_path"] = {k: v[counter]
                                   for k, v in new_paths.items()}
        if rec["name"] == "flash_prefill_d256":
            # only gemma2's and paligemma's bf16 paths run the wide body
            # (check_gemma2 and check_paligemma are f32: the CUDA-core body)
            rec["launches_by_path"] = {
                k: new_paths[k][counter]
                for k in ("serve_gemma2", "serve_gemma2_paged",
                          "serve_paligemma", "serve_paligemma_engine")}
        for model, sub in rec.get("families", {}).items():
            sub["launches"] = family_paths[rec["name"], model][counter]
            require(sub["launches"] > 0,
                    f"{rec['name']} at {model}'s shape never launched")
        if "deepseek" in rec:
            rec["deepseek"]["launches"] = launches_mla[rec["name"]]
        for sub in rec.get("tp", []):   # a rank's launches on its path
            path = ("train_tp" if sub["shape"].get("S") == TRAIN_S
                    else "serve_tp")
            sub["launches"] = launches_tp[path][counter]
            require(sub["launches"] > 0,
                    f"{rec['name']} at {path}'s split shape never launched")
        if "int8" in rec:       # the launches of the int8 paths
            rec["int8"] = {"launches": sum(
                p[rec["name"]] for p in (launches_int8, launches_paged_int8,
                                         launches_expert_int8)),
                **rec["int8"]}
    require(by_path["flash_prefill_d256"]["flash_prefill"] > 0,
            "the D-256 flash_prefill never launched in serve_gemma2")
    require(by_path["flash_prefill_bwd"]["flash_prefill_bwd"] > 0,
            "flash_prefill_bwd never launched in train_mixtral")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_call", "shape", "launches_by_path")
    emit({"kernels": [{**{k: r[k] for k in keys},
                       **{k: r[k] for k in ("model", "served_occupancy",
                                            "deepseek", "full_ring", "int8",
                                            "families", "global_layer",
                                            "max_abs_err_no_softcap",
                                            "softcap_effect",
                                            "max_abs_err_f32",
                                            "train_shapes", "tp")
                          if k in r}} for r in records]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(tp_rank(sys.argv[2:]) if sys.argv[1:2] == ["--tp-rank"]
             else main())

"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Drives the port's main paths through the hand-written CUDA kernels: the
fractal paths at the paper's largest size, n = 2**16, the attention
domains at the same size, and the LM's serving path at full model width:

* the paper's SS IV experiment: enumerate the member blocks of an n x n
  Sierpinski gasket with lambda(w), launch exactly those blocks, write
  (and sum) every member cell, and compare with the bounding-box launch
  (a 16 GiB f32 state); the lambda decode also as tensor-core products
  (the mma lowering);
* the CA application: parity and diffusion steps on the gasket held in
  compact orthotope storage (two 725.6 MB f32 buffers), fused over
  several steps per launch;
* compact write/sum: the SS IV write and sum on the packed state;
* domain=: the write and sum over the causal triangle (packed, 8 GiB)
  and the gemma3-12b window as a band, under the four lowerings;
* serving: the contiguous Server (quickstart, and gemma3-12b with 6 of
  its 48 layers) and the continuous-batching PagedServer (quickstart),
  greedy, every decode attention through the split-K decode kernel or
  the paged decode kernel (one device routine, two front ends);
* training: the Trainer on quickstart at full width (resumed from a
  checkpoint, then its weights served through the decode kernel) and on
  gemma3-12b at full width with 6 of its 48 layers through the flash
  VJP (a plain-PyTorch autograd Function: no TPU kernel lies on the
  training path);
* the MoE and MLA families: llama4-maverick-400b-a17b at full width (2
  of its 48 layers) served through both decode kernels at its group of
  5 q heads per kv head, deepseek-v2-236b at full width (4 of its 60
  layers) served through MLA's absorbed decode (no kernel on that path)
  and trained (2 layers);
* the SSM, hybrid and embedding-input stacks: the Mamba-1 and SSD scans
  at full width against their sequential oracles, falcon-mamba-7b and
  zamba2-2.7b served at full width and depth (zamba2's weight-shared
  attention block through the split-K decode kernel at 32/32 heads of
  80), musicgen-large (full depth) and internvl2-26b (12 of 48 layers)
  decoded on embeddings through the same kernel at 32/32 x 64 and 48/8 x
  128 (a group of 6), and the four trained at cut depth.

The lowerings are closed_form, prefetch_lut, bounding and mma (the
decode chains of csrc/mma_decode.cuh on the tensor cores); every loop
over ``LOWERINGS`` below runs all four.

Phases, each printing its own lines:

1. card   -- name and power limit (nvidia-smi), torch and CUDA versions;
2. build  -- nvcc builds every kernel library from the sources in the
             checkout, one nvcc per source, all started together; the
             ptxas register line of every kernel instantiation (the
             -DREPRO_TRACE libraries, which only phase 22 launches, are
             built in the background beside phases 3-21 and joined
             before 22; phase 22's static checks, which launch nothing,
             run beside this build on two torch threads, and phase 23's
             dry-run sweep starts beside it at nice 19);
3. parity -- every kernel against its plain PyTorch version on the card:
             gasket, carpet and Vicsek x the four lowerings x several
             (n, rho); writes bit-equal in f32/bf16/int32, sums
             bit-equal on integer-valued states and within a stated
             tolerance on normal ones;
4. parity, compact, CA and domains -- the write/sum kernels under
             compact storage and coarsening (same rules as phase 3), the
             fused CA kernel under gasket / carpet / Vicsek x four
             lowerings x {embedded, compact} x coarsen {1, s} x fuse
             {1, 3, span} x both rules x ring depth num_stages {1, 2, 3}
             (bit-equal), including the large-tile (global-scratch)
             path; the write/sum and CA kernels over the
             triangular, band (square and rectangular) and bounding-box
             (wide and tall) domains against their plain versions, mma
             bit-equal to closed_form there; and the fractal kernels
             under mma bit-equal to closed_form (write, partials, CA;
             compact and coarsened);
5. main   -- launch counts set to 0, then sierpinski_write_ and
             sierpinski_sum at n = 2**16 under the four lowerings at
             rho in {8, 16, 32}, each write checked against the bit test
             in row bands; counts read; then, at the same shapes, the
             sum kernels against their plain versions slot by slot on
             position-dependent integers (bit-equal) and on a normal
             state (within the tolerance); CUDA-event timings of every
             kernel beside its plain version and one library call of
             the same function (masked_fill_, torch.masked.sum,
             Tensor.sum); the rho = 1 grids (3**16 and 2**32 steps)
             launched once; rho = 1 under mma (3**16 >= 2**24 blocks)
             refused with the bound's ValueError before any launch;
6. ca     -- launch counts set to 0, then ca_run at n = 2**16, rho = 32,
             compact f32, T = 32 steps at fuse 1, 8 and 32 under the
             four lowerings for parity and diffusion, each at ring depth
             num_stages 1, 2 and 3; counts read; each
             result held against a cell-level gather oracle over
             cell_neighbor_tables(16) (parity bit-equal, diffusion within
             rtol 1e-5 / atol 1e-6); the plain version at full size for
             one run; embedded storage (two 16 GiB buffers) for
             closed_form and bounding at fuse 8, packed and compared bit
             for bit; CUDA-event timings of the kernel (parity at every
             depth, diffusion at depth 1), its plain version and the
             oracle;
7. compact write/sum -- counts set to 0, then write and sum on the
             packed state at rho 8, 16, 32 and rho 32 with coarsen 2
             under the four lowerings; counts read; the write checked on
             the packed array itself, the partials slot by slot against
             the plain version; timings beside masked_fill_;
8. domains -- for each of the triangle of 2**11 block rows (packed,
             8 GiB) and the band of 32 blocks (embedded 16 GiB, and
             packed) at n = 2**16, rho = 32: counts set to 0, write and
             sum under the four lowerings, each write checked against
             the domain's membership rule in bands; counts read; the
             partials against the plain version slot by slot, their f64
             total against the member total; timings beside
             masked_fill_ and torch.masked.sum; on the packed triangle
             the fused CA at fuse 8 (parity) under closed_form and mma
             (the batched row chain B7c), bit-equal to each other and
             timed;
9. parity-attn -- flash_attention against its plain version over
             causal / local / full x four lowerings x {MHA, GQA 16/8,
             MQA} x D {64, 128, 256} x blocks {64, 128} x f32/bf16 (the
             lowerings bit-equal to each other; bf16 takes the bf16
             tensor-core kernel, f32 the 3xTF32 one, also at D 200 and
             136 below its d 256 instantiation; the ragged calls on the
             tile paths: blocks of 8, 24 and 72, block_q = 1 without
             seq_pos, bf16 at D 40 and 72, f32 at D 36, D 256 at 72-token
             blocks, misaligned views (copied to an aligned buffer); head
             rows that are no whole number of 16-byte pieces, copied in
             8-, 4- or 2-byte pieces: f32 D 62 and 37, bf16 D 60, 37 and
             250 at blocks of 64 and 72; counted per kernel, each takes at
             least one case; no route takes the CUDA-core kernel, held to
             its plain version by a direct launch per dtype),
             rectangular local with compact KV (both
             dtypes, bit-equal to embedded), seq_pos scalar / vector and
             full + window at block_q 1 (the split-K decode kernel) and,
             on the tensor cores, at block_q 64;
             the paged kernel against its plain version and bit-equal to
             the contiguous decode kernel at block_k == page_size (up to
             gemma3-12b's width: pages of 16, D 256, bf16, GQA 16/8);
             every bf16 case also holds each output row to a relative
             error of ROW_RTOL (its largest printed per kernel);
10. attn  -- flash_attention at the widths of quickstart (causal S 4096,
             B 4, f32: the 3xTF32 tensor-core kernel; causal at S 4104,
             a prompt length that is a multiple of 8 but not of 16, in
             57 blocks of 72: its ragged instantiation; causal S 4096 at
             D 62, rows of 248 bytes in 8-byte pieces: the same kernel,
             also timed in its run-time-loop form) and gemma3-12b (D 256
             bf16: causal S 4096, local window 1024 at S 8192, causal S
             4104 in 72-token blocks: the bf16 tensor-core kernel; causal
             S 4096 at D 250, rows of 500 bytes in 4-byte pieces: the
             same; causal S 4096 in f32: the 3xTF32 kernel's d 256 form)
             under the four lowerings, every row also timing the
             CUDA-core kernel on the same inputs (launched directly, after
             the counted run):
             counts set to 0, the entry point driven, counts read (each
             row's kernel launched once, the others not at all); kernel
             vs plain (bf16 rows also per row within ROW_RTOL: a fault in
             one 64-key sub-tile of a long row stays inside rtol = atol =
             2e-2), CUDA-event medians of the kernel, its plain version
             and scaled_dot_product_attention (a yardstick only, its
             device kernels named from a profiler trace); a summary line
             per tensor-core kernel; the clone flash_cuda makes of a view
             that starts off a 16-byte boundary, timed at quickstart's and
             gemma3-12b's shapes one element off; the causal rows over
             head dims whose rows are copied in 16-, 8-, 4- and 2-byte
             pieces (``[attn] dims``);
11. serve -- launch counts set to 0, then Server.generate greedy on
             quickstart at full width (batch 8, prompt 128, 32 new,
             max_len 256) through the split-K decode kernel; counts read
             and held to layers x decode steps; the same run with
             grid_lowering="mma", counted on its own, its streams and
             step logits bit-equal to the first; the same run through
             the plain decode; step logits compared within SERVE_TOL and
             the token streams equal wherever the top-2 margin exceeds
             it; the same for gemma3-12b (6 layers, batch 4, prompt
             1536, 16 new, max_len 1664, bf16); timings in turns; every
             run guarded (the default) must end at ladder level 0, state
             healthy, with only ``ok`` guard events; one unguarded kernel
             run gives unguarded_ms_per_decode_step beside the guarded
             second kernel run's guarded_ms_per_decode_step, and the
             guard's own work on one step's output is timed alone
             (guard_call_ms: a GuardedCall's sync, NaN screen and event
             log; guard_screen_ms: the sync and screen; medians of 200);
12. paged -- counts set to 0, then PagedServer.run on quickstart: 16
             mixed-length requests, 8 slots, 16-token pages, a pool that
             forces preemptions, the page table verified at every step;
             counts read and held to layers x paged steps; streams
             against the single-request Server oracle and the paged
             plain-decode run; the same health checks and guarded /
             unguarded step times as phase 11;
13. chaos -- the guarded runtime (repro_torch.runtime): the chaos
             matrix on the card (its poison_tile and corrupt_table faults
             on the write kernel's launches, detected and recovered
             bit-identically, the write count risen by exactly those
             launches); then at quickstart full width, each run counted
             from 0: transient errors and poisoned results recovered
             bit-equal to the fault-free stream; the ladder forced from
             blockspace to xla by rung-0 faults after 8 decode steps
             (decode launches = layers x 8, the stream equal to the xla
             run); a SIGTERM mid-decode drained into a decode checkpoint
             and resumed by a second Server, bit-equal to the
             uninterrupted run; the substrate canary every 4 steps (one
             write launch each); the PagedServer's paged-blockspace ->
             paged-xla step after 10 steps; a ``[chaos]`` JSON line with
             each scenario and the phase's seconds;
14. decode -- both decode kernels timed at their
             quickstart serving shapes and at the gemma3-12b decode shape
             (B 4, 16/8 heads of 256 bf16, cache 1664, positions
             1536-1551; contiguous at block_k 128, paged in 16-token
             pages) beside their plain versions, their byte bounds and
             scaled_dot_product_attention, each held to its plain version
             (gemma3-12b: window 1024 and none, paged bit-equal to the
             contiguous kernel at block_k 16);
15. tune   -- the tuner (repro_torch.core.tune) at full width, from a
             fresh cache file that REPRO_TORCH_TUNE_CACHE points at
             before any phase (so no file on the machine changes what the
             earlier phases run): autotune_write (gasket n = 2**16, rho
             32, both storages, coarsen up to 4: 24 candidates, a 16 GiB
             embedded state), autotune_ca (the same problem, parity, 8
             steps, both storages, fuse up to 8, coarsen up to 4, ring
             depths 1 and 2: 192 candidates), autotune_flash
             (quickstart's causal widths, S 4096, f32, blocks 64 / 128 /
             256) and autotune_paged (quickstart's serving decode, 8
             slots, 256 tokens, pages of 8 / 16 / 32 / 64); a [tune] line
             per search (the winner, its us, trials, inviable candidates,
             seconds) and its three fastest and slowest trials; then every
             knob at "auto" held bit-equal to the winner spelled out
             (flash within its tolerance), the kernel's launch count
             risen, the call against its plain version, and a lookup
             under another key giving the untuned defaults' bits;
16. train  -- the trainer (repro_torch.launch.train): the flash VJP at
             gemma3-12b's head shape (H 16/8, D 256, S 4096, f32,
             chunk 1024; local window 1024 and causal, dense, and causal
             triangular) against autograd through simple_attention,
             each gradient within VJP_TOL of its largest magnitude, both
             timed; quickstart at full width (batch 8, S 512, 21 steps
             on the learnable pipeline, a checkpoint at step 10): finite
             losses that fall, no attention kernel launched by
             training; a second Trainer resumes the step-10 checkpoint
             and its 10 steps equal the first run's within
             TRAIN_RESUME_RTOL; the last checkpoint restored into a
             Server: counts set to 0, greedy generation through the
             decode kernel, counts read and held to layers x decode
             steps, the stream against the plain decode's; gemma3-12b
             at full width with 6 of its 48 layers (batch 1, S 4096,
             bf16 compute, f32 parameters and AdamW state, remat,
             logit chunks of 256): 3 steps of make_train_step, the
             flash VJP's forward and backward counted; ms per step,
             tokens/s and peak memory beside the card's name and power
             limit (``python3 chip_smoke.py --train-only`` builds, then
             runs only this phase and prints no result);
17. families -- the MoE / MLA stacks (models/moe.py, models/mla.py):
             both decode kernels at llama4-maverick's heads (B 4, 40/8
             heads of 128, bf16, cache 2048, positions 63 / 256 / 511 /
             1500 at tile and split edges) against their plain versions
             and the model's plain decode_attention (FAM_DECODE), paged
             bit-equal to contiguous, timed (profiler device time)
             beside SDPA and the byte bound; llama4-maverick at full
             width cut to 2 of its 48 layers (dense, then MoE: 18.7 B
             bf16 parameters), each run counted from 0: Server batch 4,
             prompt 1024, 16 new, under blockspace (decode launches =
             layers x decode steps) and xla (none), streams compared as
             phase 11, timed in turns; PagedServer 8 mixed requests over
             4 slots in 16-token pages (paged launches = layers x paged
             steps), streams against the single-request oracle;
             deepseek-v2-236b cut to 4 of its 60 layers (the dense first
             layer, 3 MoE: 13.3 B bf16 parameters): Server batch 4,
             prompt 1024, 16 new, no kernel launched (none lies on the
             path); the absorbed MLA decode against the prefill of the
             extended sequence (the model's logits in f32 compute within
             FAM_MLA_F32_TOL, the first layer's block in bf16 within the
             attention kernels' bf16 tolerance); moe_block against
             moe_block_dense_ref on 64 tokens at a capacity that drops
             nothing (the same tolerance); deepseek-v2 trained
             at 2 layers (batch 1 x 4096, bf16 parameters and AdamW
             moments, remat, 3 steps): finite losses, aux_loss > 0, the
             flash VJP's calls at V head dim 128 against QK 192, ms per
             step and peak (``python3 chip_smoke.py --families-only``
             builds, then runs only this phase and prints no result);
18. ssm   -- the SSM, hybrid and embedding-input stacks (models/ssm.py,
             the shared block and embedding inputs of models/model.py),
             each model dropped before the next: (1) selective_scan and
             ssd_scan at falcon-mamba-7b's / zamba2-2.7b's widths (b 1,
             S 512, chunk 256; d_inner 8192 N 16; 80 heads of 64, N 64)
             against their sequential oracles in f32 within rtol 1e-4 /
             atol 1e-5 (SSM_TOL); (2) falcon-mamba-7b at full width and
             depth (64 layers, 29.1 GB of f32 parameters): the Server at
             batch 4, prompt 1024, 16 new, no kernel launched (none lies
             on the path), again under a poisoned and a failed decode
             step (SSM_CHAOS: the unfaulted stream), its decode step's
             profile; an f32 copy at 2
             layers: a prefill of 1024 tokens against a prefill of 768
             and 256 decode steps, last logits and states within
             SSM_DECODE_TOL; (3) zamba2-2.7b at full width and depth (54
             layers, 9 shared-block applications): the decode kernels at
             32/32 x 80 bf16 against their plain versions (as phase 17),
             the Server at batch 4, prompt 2048, 16 new, under
             blockspace (9 x decode steps launches) and xla (none) in
             turns, streams compared as phase 11, its decode step's
             profile; (4) musicgen-large at full depth and (5)
             internvl2-26b at 12 of its 48 layers: the decode kernels at
             their heads (32/32 x 64; 48/8 x 128, a group of 6), a
             prefill of seeded (4, 2048, D) embeddings and 16 decode
             steps on (4, 1, D) ones, blockspace (layers x steps
             launches) against xla, step logits within SERVE_TOL; (6)
             each trained 3 steps (batch 1 x 2048) at 2 / 6 / 4 / 2
             layers: finite losses, ms a step, peak
             (``python3 chip_smoke.py --ssm-only`` builds, then runs
             only this phase and prints no result);
19. mesh  -- the block-space mesh (core/shard.py): per-rank parity of
             the sharded kernels, then D = 2 and 4 ranks spawned on the
             card over gloo end to end, bit-equal to the unsharded
             kernels (``--mesh-only`` runs only this phase);
20. serve-mesh -- the serving mesh: gemma3-12b at full width (6 of 48
             layers) served by the single-device Server and PagedServer,
             then by ranks spawned on the card over gloo on the (data,
             model) meshes 2x1, 1x2 and 2x2 (tensor parallelism over
             'model', the decode kernels' slots over 'data'), launch
             counts and slot-group launches set to 0 before and read
             after, tokens and step logits held against the
             single-device run, every rank's decode and paged-decode
             launch at its slot group's shape against its plain version
             and timed; a quickstart checkpoint restore(shardings=)d
             onto 1x2 and elastic_restore'd onto 3 ranks, served; the
             SIGTERM scenario resumed on a 2-rank mesh
             (``--serve-mesh-only`` runs only this phase);
21. train-mesh -- the trainer on a mesh (launch/train.py's Trainer(mesh=),
             ranks spawned on the card over gloo): quickstart at full
             width from one step-0 checkpoint on 2x1, 1x2, 2x2, 1x2 under
             seq_shard_acts and 2x1 under fsdp, per-step losses and final
             parameters held to the one-device run; the 2x2 checkpoint
             resumed on one device (bit-equal weights, its next step the
             one-device run's) and restored onto a 1x2 serving mesh,
             Server and PagedServer greedy through the decode kernels
             (launch counts set to 0 before and read after, every rank's
             launch held to its plain version, tokens to the one-device
             servers'); compressed_psum_grads on 2 ranks; gemma3-12b (6
             of 48 layers, 1 x 4096) on 1x2 under seq_shard_acts and
             deepseek-v2 (2 layers, 2 x 1024, bf16 moments) on 2x1 under
             fsdp against their one-device runs (``--train-mesh-only``
             runs only this phase);
22. verify -- the plan verifier, the access sanitizer and verify=
             (repro_torch/analysis): verify_plan (beside the build,
             phase 2) with zero findings on
             the gasket at n = 2**16, rho 32 under the four lowerings x
             both storages (write, sum and ca models; coarsen 2), the
             packed triangle of 2**11 block rows and BandDomain(2048,
             32), the sharded compact gasket at D = 2 and 4 with halo
             (every rank, the interior / boundary phase views) and flash
             at gemma3-12b's S 4096, each plan's host seconds; seeded
             faults on the card (a device LUT row: verify=True on write,
             sum and ca_run refuses with 0 launches, the sanitizer flags
             the row from the trace kernels' rows; a rank's device
             ghost-map entry: its verify= refuses); verify=True on write,
             sum, ca_step, ca_run, flash and paged at the main shapes,
             bit-equal to verify=False, its extra host ms; the sanitizer
             at full width (write, sum, CA fuse 1 and 8 x four lowerings
             x both storages through the -DREPRO_TRACE builds: zero
             findings, traced outputs bit-equal to untraced, the card's
             rows equal to the plain version's, traced and untraced ms a
             launch); autotune_write / autotune_ca with verify=True
             against verify=False from fresh caches, and a failing plan
             rejected; the verify CLI (``python -m
             repro_torch.analysis.verify --matrix --device cuda``, its
             main called in this process) exit 0 (``--verify-only`` runs
             only this phase);
23. dryrun -- the dry run (repro_torch/launch/dryrun.py): the sweep of
             all 66 cells (10 architectures x their shapes x the 16 x 16
             and 2 x 16 x 16 meshes; ``python -m
             repro_torch.launch.dryrun --all --mesh both``), started
             beside the build at nice 19 and joined here, every cell OK,
             a line per cell (rank 0's peak GiB, FLOPs, wire bytes, the
             dominant roofline term); then three steps phases 15 and 16
             measured, each beside its dry run on one device: quickstart
             training (f32, 8 x 512), gemma3-12b training (6 layers, 1 x
             4096, bf16, remat) and gemma3-12b's decode step (6 layers,
             4 slots): counted FLOPs, model_flops, achieved TFLOP/s and
             share of the peak of the products' dtype, and the dry run's
             peak against the measured one less what was resident at the
             phase's reset (it may fall short by DRYRUN_PEAK_UNDER at
             most) (``--dryrun-only`` runs phase 2, the train phase and
             one gemma3-12b serve run for the steps, then this phase);
24. kernels line (the kernels of the main paths: B1-B3, B4 as the
             split-K decode kernel flash_attention_decode and the
             tensor-core tile paths flash_attention_tc (bf16, with its
             ragged gemma3-12b S 4104 row and its narrow D 250 row) and
             flash_attention_tc_f32 (f32, 3xTF32, with its gemma3-12b
             D 256 row, its ragged quickstart S 4104 row and its narrow
             D 62 row), B5, the mma chains B7 (with the CA under mma at
             fuse 1 and 8 and on the triangle); the CUDA-core kernel,
             which no route takes, is not among them: its times sit
             beside the tile paths' as cuda_core_ms; the two decode
             entries carry launches_families_phase and a llama4_maverick
             object, launches_ssm_phase and zamba2_2_7b, musicgen_large
             and internvl2_26b objects, and a serve_mesh object: the
             mesh runs' launches, the slot-sharded ones, every rank's
             launch at its shape, and a train_mesh object: the launches
             of the trained checkpoint's serving on 1x2 and each rank's
             launch at its shape; the write, partials and CA entries a
             trace_build object: the trace instantiations' launches in
             phase 22's sanitizer runs and their times beside the
             untraced ones), a
             ``[phases]`` line (each phase's host seconds), then the
             result line.

``python3 chip_smoke.py --build-only`` stops after phase 2 and prints no
result line (to read the register lines of a tree, e.g. of an earlier
commit unpacked beside this script); with ``--sass`` it also prints, for
every flash kernel instantiation, the count of its SASS instructions and
a hash of them (cuobjdump; addresses and encodings dropped), so a copy of
this script run in an earlier tree's root shows which instantiations'
code changed.  ``python3 chip_smoke.py
--decode-only`` runs phases 1 and 2, then only the decode timings of
phase 14, writes them to chiprun_out/chip_smoke.json and prints no result
line: a copy of this script run from an earlier tree's root times that
tree's kernels through the same entry points (flash_cuda, paged_cuda), so
``--compare`` can pair them with this tree's full runs.
``python3 chip_smoke.py --compare CHANGE.json [...] --parent PARENT.json [...]`` reads the JSON of runs of
two trees (written to chiprun_out/chip_smoke.json; runs taken in turns
on one card) and prints every time the change moved outside 0.94-1.06x
of the parent's median, with both sides' runs; it needs no card and
prints no result line.

Any failed check raises: the script exits non-zero and prints no
result line.  It needs one CUDA card and nvcc; full results are written
to chiprun_out/chip_smoke.json.

Run:  python3 chip_smoke.py
"""
import atexit
import contextlib
import dataclasses
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke.json"

#: H100 SXM device-memory rate and f32 (non-tensor-core) peak, from
#: NVIDIA's data sheet at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

N_MAIN = 1 << 16
R_MAIN = 16
RHOS = (8, 16, 32)
REPORT_AT = ("closed_form", 32)   # the (lowering, rho) of the kernels line
PARITY_CASES = [
    ("sierpinski-gasket", 64, 1), ("sierpinski-gasket", 64, 4),
    ("sierpinski-gasket", 1024, 8), ("sierpinski-gasket", 1024, 128),
    ("sierpinski-gasket", 4096, 2), ("sierpinski-gasket", 16384, 32),
    ("sierpinski-gasket", 16384, 4),
    ("sierpinski-carpet", 81, 1), ("sierpinski-carpet", 81, 3),
    ("sierpinski-carpet", 729, 9), ("sierpinski-carpet", 6561, 27),
    ("vicsek-cross", 81, 3), ("vicsek-cross", 729, 27),
    ("vicsek-cross", 6561, 9),
]
DTYPES = (torch.float32, torch.bfloat16, torch.int32)
#: normal-state tolerance of a tile sum: two f32 reductions of <= 1024
#: terms in different orders each err by <= ~1e-6 of the tile's sum of
#: magnitudes
NORMAL_RTOL = 1e-5
SEED = 0

#: compact/coarsened write-sum parity: (fractal, n, block, s)
COMPACT_PARITY_CASES = [
    ("sierpinski-gasket", 1024, 8, 4), ("sierpinski-gasket", 4096, 32, 2),
    ("sierpinski-gasket", 16384, 32, 2), ("sierpinski-gasket", 256, 1, 8),
    ("sierpinski-carpet", 729, 9, 3), ("vicsek-cross", 6561, 9, 9),
]
#: CA parity: (fractal, n, block, s); fuse runs over {1, 3, span}
CA_PARITY_CASES = [
    ("sierpinski-gasket", 1024, 32, 2), ("sierpinski-gasket", 512, 16, 4),
    ("sierpinski-carpet", 729, 27, 3), ("vicsek-cross", 729, 9, 3),
]
#: the large working tiles: (fractal, n, block, coarsen, fuse)
CA_LARGE_CASES = [("sierpinski-gasket", 512, 128, 1, 128),
                  ("sierpinski-gasket", 1024, 32, 2, 64)]
CA_RHO, CA_STEPS, CA_FUSES = 32, 32, (1, 8, 32)
#: the ring depths (num_stages) every CA phase runs
CA_STAGES = (1, 2, 3)
CA_ALPHA = 0.2
#: f32 operations per member cell and step: 3 adds for the neighbour sum,
#: then parity adds and takes the mod, diffusion does mul, sub, mul, add
CA_OPS = {"parity": 5, "diffusion": 7}
CA_REPORT_AT = ("closed_form", 8, "parity")  # the kernels line's CA row
CA_REPORT_STAGES = 1  # ... at the entry points' default depth


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(fn, reps, warmup=1):
    """Median of ``reps`` CUDA-event timings of ``fn`` after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


#: the card's highest SM clock (nvidia-smi clocks.max.sm, read by
#: phase_card) and the latency of one dependent f32 add in cycles: the
#: in-order combine adds its partials one after another, so its least
#: time is that chain, not its bytes
SM_CLOCK_HZ = None
FADD_CYCLES = 4


def chain_bound(steps, nbytes):
    """Least time in ms of a strict left fold of ``steps`` f32 adds: the
    chain of dependent adds at the highest SM clock, or the bytes if
    they take longer."""
    t_chain = steps * FADD_CYCLES / SM_CLOCK_HZ * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_chain else (t_chain,
                                                          "operations")


def bound(nbytes, nops=0):
    """Least time in ms for the work: bytes over the memory rate or f32
    operations over the f32 peak, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: the card's name and power limit as nvidia-smi prints them (phase_card),
#: written beside the serving and chaos timings
CARD = None


def phase_card():
    global SM_CLOCK_HZ, CARD
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = CARD = smi.stdout.strip().splitlines()[0]
    print(card)
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    SM_CLOCK_HZ = float(clk.stdout.strip().splitlines()[0]) * 1e6
    print(f"[card] highest SM clock {SM_CLOCK_HZ / 1e6:.0f} MHz")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")
    return card


#: the trace builds (-DREPRO_TRACE) only [verify] launches: built in a
#: thread of their own beside the first phases (off the build's critical
#: path), joined before [verify]
TRACE_BUILD = {}


#: [verify]'s static checks, run beside the build (host work on the two
#: cores the six nvcc leave): their rows and seconds, or their failure
VERIFY_STATIC = {}
#: torch's intra-op threads while the static checks run beside the build
BESIDE_BUILD_THREADS = 2


def phase_build(_cuda, beside=None):
    """Build every library but the trace builds (one nvcc each, all
    started together), with ``beside()`` (the [verify] phase's static
    checks) in a thread meanwhile on BESIDE_BUILD_THREADS torch threads;
    print the [build] lines, then start the trace builds in the
    background (:func:`trace_build_done` joins them)."""
    import threading
    t0 = time.perf_counter()
    names = [n for n in _cuda.SOURCES if not n.endswith("_trace")]
    worker = None
    if beside is not None:
        threads = torch.get_num_threads()
        torch.set_num_threads(BESIDE_BUILD_THREADS)

        def run_beside():
            t1 = time.perf_counter()
            try:
                VERIFY_STATIC["rows"] = beside()
            except BaseException as e:   # re-raised after the build
                VERIFY_STATIC["error"] = e
            VERIFY_STATIC["seconds"] = time.perf_counter() - t1
        worker = threading.Thread(target=run_beside)
        worker.start()
    paths = _cuda.build(names)
    if worker is not None:
        worker.join()
        torch.set_num_threads(threads)
        if "error" in VERIFY_STATIC:
            raise VERIFY_STATIC["error"]
    secs = time.perf_counter() - t0
    print(f"[build] " + ", ".join(
        f"{name} {_cuda.BUILD_SECONDS.get(name, 0.0):.1f} s"
        for name in paths) + f" (in parallel, {secs:.1f} s in all)")
    print_build_lines(_cuda, paths)
    traced = [n for n in _cuda.SOURCES if n.endswith("_trace")]

    def go():
        t1 = time.perf_counter()
        try:
            TRACE_BUILD["paths"] = _cuda.build(traced)
        except BaseException as e:   # re-raised by trace_build_done
            TRACE_BUILD["error"] = e
        TRACE_BUILD["seconds"] = time.perf_counter() - t1
    # not a daemon: the interpreter waits for it (and its nvcc) at exit
    TRACE_BUILD["thread"] = threading.Thread(target=go)
    TRACE_BUILD["thread"].start()
    return secs


def trace_build_done(_cuda):
    """Join the background trace builds, raise their failure, print
    their [build] lines; returns their paths."""
    TRACE_BUILD["thread"].join()
    if "error" in TRACE_BUILD:
        raise TRACE_BUILD["error"]
    paths = TRACE_BUILD["paths"]
    print(f"[build] " + ", ".join(paths) + f" (in the background, "
          f"{TRACE_BUILD['seconds']:.1f} s)")
    print_build_lines(_cuda, paths)
    return paths


def print_build_lines(_cuda, paths):
    """Each library's file and the ptxas register / spill line of every
    kernel instantiation it holds."""
    kernels = ("write_kernel", "sum_partials_kernel", "sum_combine_kernel",
               "write_shard_kernel", "sum_shard_kernel", "ca_fused_kernel", "flash_fwd_kernel", "flash_fwd_tc_kernel",
               "flash_fwd_tf32_kernel", "flash_decode_kernel",
               "paged_decode_kernel")
    for name, path in paths.items():
        print(f"[build] {name}: {path.name}")
        entry = ""
        for line in _cuda.BUILD_LOG.get(name, "").splitlines():
            if "Compiling entry function" in line:
                # the kernel and its template arguments, from the mangled
                # name: <kernel>I<args>E (e.g. write_kernelILi0ELb1ELb0EjE:
                # domain kind 0, mma, untiled, 4-byte cells)
                mangled = line.split("'")[1]
                hit = [k for k in kernels if k in mangled]
                entry = mangled[mangled.index(hit[0]):].split("EEv")[0] \
                    if hit else mangled
            if "registers" in line or "spill" in line:
                print(f"[build]   {entry}: {line.strip()}")


def phase_sass(_cuda, paths, lib="flash_attention"):
    """[sass] lines: per kernel instantiation of library ``lib``, its
    mangled name, the count of its SASS instructions and the first 16
    hex digits of the sha256 of their text (cuobjdump -sass; addresses,
    encodings and comments dropped, branch offsets kept)."""
    import hashlib
    import re
    tool = Path(_cuda.nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(paths[lib])],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        hit = re.search(r"Function : (\S+)", line)
        if hit:
            name = hit.group(1)
            funcs[name] = []
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if ins and name:
            funcs[name].append(ins.group(1))
    for name, ins in sorted(funcs.items()):
        digest = hashlib.sha256("\n".join(ins).encode()).hexdigest()[:16]
        print(f"[sass] {lib} {name}: {len(ins)} instructions {digest}")


def random_state(n, dtype, seed, integer, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    if integer:
        x = torch.randint(-8, 9, (n, n), generator=g, device=dev)
    else:
        x = torch.randn((n, n), generator=g, device=dev)
    return x.to(dtype)


def merge_err(into, errs):
    for name, e in errs.items():
        into[name] = max(into[name], e)


def phase_parity(TW, LOWERINGS, dev):
    """Every kernel against its plain version on the same inputs."""
    err = {name: 0.0 for name in TW.KERNELS}
    ncmp = 0
    for ci, (fractal, n, block) in enumerate(PARITY_CASES):
        for gm in LOWERINGS:
            # integer-valued states: writes, partials and totals bit-equal;
            # then a normal f32 state: partials within the tolerance
            for di, dtype in enumerate(DTYPES + (None,)):
                integer = dtype is not None
                base = random_state(n, dtype or torch.float32,
                                    1000 * ci + di, integer, dev)
                plan, n_, blk = TW.prepare_launch(
                    base, block=block, grid_mode=gm, fractal=fractal)
                p = plan.launch_params(n_, blk, dev)
                if integer:
                    TW.check_write_against_plain(base, 7.3, plan, n_, blk, p)
                    ncmp += 1
                errs, _ = TW.check_sum_against_plain(
                    base, plan, n_, blk, p,
                    rtol=None if integer else NORMAL_RTOL)
                merge_err(err, errs)
                ncmp += 2
        torch.cuda.synchronize()
        print(f"[parity] {fractal} n={n} rho={block}: ok "
              f"({len(LOWERINGS)} lowerings x {len(DTYPES)} dtypes + normal "
              f"f32)")
    print(f"[parity] {ncmp} kernel-vs-plain comparisons passed; "
          f"max |err| {err}")
    return err


def gasket_mask(n, dev, band):
    """The bit-test membership of the (n, n) gasket, built in row bands."""
    mask = torch.empty((n, n), dtype=torch.bool, device=dev)
    x = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    for y0 in range(0, n, band):
        y = torch.arange(y0, y0 + band, dtype=torch.int32, device=dev)[:, None]
        mask[y0:y0 + band] = (x & (n - 1 - y)) == 0
    return mask


def check_bands(m, mask, band, what):
    """Members hold 1.0, every other cell still 2.0, band by band."""
    for y0 in range(0, m.shape[0], band):
        want = torch.where(mask[y0:y0 + band], 1.0, 2.0)
        check(torch.equal(m[y0:y0 + band], want),
              f"{what}: rows {y0}..{y0 + band} differ from the bit test")


def phase_main(ops, TW, F, LOWERINGS, dev):
    n, band = N_MAIN, 2048
    members = F.gasket_volume(n)
    torch.cuda.reset_peak_memory_stats()
    m = torch.full((n, n), 2.0, dtype=torch.float32, device=dev)
    mask = gasket_mask(n, dev, band)
    print(f"[main] gasket n={n}: state {m.numel() * 4 / 2 ** 30:.0f} GiB "
          f"f32, {members} member cells")

    # -- the main path, counted --------------------------------------------
    # The writes run on a state of 2.0 and are checked against the bit
    # test.  The sums run on position-dependent integers in [-8, 8], so a
    # partial in the wrong slot or a wrong step order changes the total.
    sums = {}
    gen = torch.Generator(device=dev)
    TW.reset_launch_counts()
    for rho in RHOS:
        for gm in LOWERINGS:
            m.fill_(2.0)
            ops.sierpinski_write_(m, 1.0, block=rho, grid_mode=gm)
            check_bands(m, mask, band, f"write {gm} rho={rho}")
    m.random_(-8, 9, generator=gen.manual_seed(SEED))
    for rho in RHOS:
        for gm in LOWERINGS:
            sums[(gm, rho)] = ops.sierpinski_sum(m, block=rho, grid_mode=gm)
    torch.cuda.synchronize()
    launches = TW.launch_counts()
    print(f"[main] launches {launches}")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")

    # -- checks at the main path's shapes (not counted) --------------------
    exact = sum(float(m[y0:y0 + band][mask[y0:y0 + band]].double().sum())
                for y0 in range(0, n, band))
    err = {name: 0.0 for name in TW.KERNELS}
    for rho in RHOS:
        for gm in LOWERINGS:
            plan, _, blk = TW.prepare_launch(m, block=rho, grid_mode=gm)
            p = plan.launch_params(n, blk, dev)
            errs, plain_sum = TW.check_sum_against_plain(m, plan, n, blk, p)
            merge_err(err, errs)
            check(torch.equal(sums[(gm, rho)], plain_sum),
                  f"sum {gm} rho={rho}: kernel {float(sums[(gm, rho)])} "
                  f"!= plain {float(plain_sum)}")
            parts = TW.sum_partials_cuda(m, p)
            check(float(parts.double().sum()) == exact,
                  f"partials {gm} rho={rho}: f64 total "
                  f"{float(parts.double().sum())} != {exact}")
    print(f"[main] integer state: partials bit-equal to the plain version "
          f"slot by slot, totals equal, f64 member total {exact}")
    m.normal_(generator=gen.manual_seed(SEED + 1))
    for rho in RHOS:
        for gm in LOWERINGS:
            plan, _, blk = TW.prepare_launch(m, block=rho, grid_mode=gm)
            p = plan.launch_params(n, blk, dev)
            errs, _ = TW.check_sum_against_plain(m, plan, n, blk, p,
                                                 rtol=NORMAL_RTOL)
            merge_err(err, errs)
    print(f"[main] normal state: partials within {NORMAL_RTOL} of each "
          f"tile's sum of magnitudes; max |err| {err}")

    # -- timings (not counted) ---------------------------------------------
    rows = []
    yard_ms = time_ms(lambda: m.masked_fill_(mask, 1.0), reps=5)
    msum_ms = time_ms(lambda: torch.masked.sum(m, mask=mask), reps=5)
    print(f"[main] yardsticks: masked_fill_ {yard_ms:.4f} ms, "
          f"torch.masked.sum {msum_ms:.4f} ms")
    for rho in RHOS:
        for gm in LOWERINGS:
            plan, _, blk = TW.prepare_launch(m, block=rho, grid_mode=gm)
            p = plan.launch_params(n, blk, dev)
            parts = TW.sum_partials_cuda(m, p)
            steps = p.steps
            fast = 20 if steps < 1 << 22 else 5  # the serial combine
            row = {
                "lowering": gm, "rho": rho, "steps": steps,
                "sum": float(sums[(gm, rho)]),
                "write_ms": time_ms(lambda: TW.write_cuda(m, 1.0, p), 20),
                "write_plain_ms": time_ms(
                    lambda: TW.sierpinski_write_plain(m, 1.0, plan, n, blk),
                    2),
                "write_library_ms": yard_ms,
                "partials_ms": time_ms(lambda: TW.sum_partials_cuda(m, p),
                                       20),
                "partials_plain_ms": time_ms(
                    lambda: TW.sum_partials_plain(m, plan, n, blk), 2),
                "partials_library_ms": msum_ms,
                "combine_ms": time_ms(lambda: TW.sum_combine_cuda(parts),
                                      fast),
                "combine_plain_ms": time_ms(
                    lambda: TW.sum_combine_plain(parts), 2),
                # no PyTorch call adds in the fold's order: parts.sum()
                # reorders (timed for reference, not a library time)
                "combine_library_ms": None,
                "combine_reordered_sum_ms": time_ms(lambda: parts.sum(), 20),
                "sum_ms": time_ms(
                    lambda: ops.sierpinski_sum(m, block=rho, grid_mode=gm),
                    fast),
                "sum_plain_ms": time_ms(
                    lambda: TW.sierpinski_sum_plain(m, plan, n, blk), 2),
            }
            # bytes: member cells written / read once, partials once
            for key, b in (("write", bound(members * 4)),
                           ("partials", bound(members * 4 + steps * 4,
                                              members)),
                           ("combine", chain_bound(steps, steps * 4 + 4))):
                row[f"{key}_bound_ms"], row[f"{key}_bound_by"] = b
            rows.append(row)
            print(f"[main] {json.dumps(row)}")
    for rho in RHOS:
        by = {r["lowering"]: r for r in rows if r["rho"] == rho}
        print(f"[main] rho={rho}: lambda/bounding write time "
              f"{by['closed_form']['write_ms'] / by['bounding']['write_ms']:.4f}"
              f", LUT/bounding "
              f"{by['prefetch_lut']['write_ms'] / by['bounding']['write_ms']:.4f}"
              f", lambda/bounding sum time "
              f"{by['closed_form']['sum_ms'] / by['bounding']['sum_ms']:.4f}")

    # -- the rho = 1 grids: 3**16 closed-form steps, 2**32 bounding steps
    rho1 = {}
    for gm in ("closed_form", "bounding"):
        m.fill_(2.0)
        plan, _, blk = TW.prepare_launch(m, block=1, grid_mode=gm)
        p = plan.launch_params(n, blk, dev)
        rho1[gm] = time_ms(lambda: TW.write_cuda(m, 1.0, p), 1, warmup=0)
        check_bands(m, mask, band, f"write {gm} rho=1")
        print(f"[main] rho=1 {gm}: {p.steps} steps, one launch "
              f"{rho1[gm]:.3f} ms, checked against the bit test")
    # -- rho = 1 under mma: 3**16 >= 2**24 blocks, refused before launch
    before = TW.launch_counts()
    try:
        ops.sierpinski_write_(m, 1.0, block=1, grid_mode="mma")
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None and "2^24" in refused,
          "rho=1 under mma did not raise the exactness bound's ValueError")
    check(TW.launch_counts() == before, "rho=1 under mma launched a kernel")
    print(f"[main] rho=1 mma: refused before any launch ({refused})")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[main] peak device memory {peak:.2f} GiB")
    return rows, launches, err, rho1, peak


# ---------------------------------------------------------------------------
# compact storage, coarsening and the fused CA kernel
# ---------------------------------------------------------------------------

def member_state(layout, block, n, spec, dev, seed, kind):
    """An embedded (n, n) f32 state, zero outside the fractal: 'binary'
    {0, 1}, 'integer' in [-8, 8] or 'normal'; and its packed copy."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "binary":
        x = torch.randint(0, 2, (n, n), generator=g, device=dev).float()
    elif kind == "integer":
        x = torch.randint(-8, 9, (n, n), generator=g, device=dev).float()
    else:
        x = torch.randn((n, n), generator=g, device=dev)
    mask = torch.from_numpy(spec.membership_grid(n).copy()).to(dev)
    x = torch.where(mask, x, 0)
    return x, layout.pack(x, block)


def phase_parity_compact(TW, F, LOWERINGS, compact_layout, dev):
    """The write/sum kernels under compact storage and coarsening against
    their plain versions: writes bit-equal in three dtypes, sums bit-equal
    on integer states and within the tolerance on normal ones."""
    err = {name: 0.0 for name in TW.KERNELS}
    ncmp = 0
    for ci, (fractal, n, block, s) in enumerate(COMPACT_PARITY_CASES):
        spec = F.FRACTALS.get(fractal, F.SIERPINSKI)
        lay = compact_layout(TW.resolve_fractal_domain(fractal, n, block))
        for gm in LOWERINGS:
            for storage, coarsen in (("compact", 1), ("compact", s),
                                     ("embedded", s)):
                for di, dtype in enumerate(DTYPES + (None,)):
                    kind = "integer" if dtype is not None else "normal"
                    emb, packed = member_state(lay, block, n, spec, dev,
                                               100 * ci + di, kind)
                    m = (packed if storage == "compact" else emb).to(
                        dtype or torch.float32)
                    plan, n_, blk = TW.prepare_launch(
                        m, block=block, grid_mode=gm, fractal=fractal,
                        storage=storage, n=n, coarsen=coarsen)
                    p = plan.launch_params(n_, blk, dev)
                    if dtype is not None:
                        TW.check_write_against_plain(m, 7.3, plan, n_, blk,
                                                     p)
                        ncmp += 1
                    errs, _ = TW.check_sum_against_plain(
                        m, plan, n_, blk, p,
                        rtol=None if dtype is not None else NORMAL_RTOL)
                    merge_err(err, errs)
                    ncmp += 2
        torch.cuda.synchronize()
        print(f"[parity-compact] {fractal} n={n} rho={block} s={s}: ok "
              f"({len(LOWERINGS)} lowerings x compact/coarsened/"
              f"embedded-coarsened x "
              f"{len(DTYPES)} dtypes + normal f32)")
    print(f"[parity-compact] {ncmp} kernel-vs-plain comparisons passed; "
          f"max |err| {err}")
    return err


def ca_check_depths(TC, a, b, plan, n, block, halo, steps, rule):
    """One CA launch at every ring depth of CA_STAGES against one plain
    run on the same buffers: bit-equal, or raise."""
    p = plan.launch_params(n, block, a.device)
    want = TC.ca_launch_plain(a, b.clone(), plan, n, block, halo, steps,
                              rule, CA_ALPHA)
    for st in CA_STAGES:
        got = TC.ca_cuda(a, b.clone(), p, halo, steps, rule, CA_ALPHA, st)
        check(torch.equal(got, want),
              f"CA kernel != plain version ({plan.domain.name}, "
              f"{plan.lowering}, {plan.storage}, coarsen={plan.coarsen}, "
              f"n={n}, block={block}, halo={halo}, steps={steps}, {rule}, "
              f"num_stages={st}): max |diff| "
              f"{float((got - want).abs().max())}")
    return len(CA_STAGES)


def phase_parity_ca(TC, F, LOWERINGS, compact_layout, TW, dev):
    """The fused CA kernel against its plain version, bit-equal for both
    rules, over lowering x storage x coarsen x fuse x ring depth, and the
    large working tiles that take the global-scratch path."""
    ncmp = 0
    cases = [(f, n, b, c, fuse) for (f, n, b, s) in CA_PARITY_CASES
             for c in (1, s) for fuse in sorted({1, 3, c * b})]
    cases += CA_LARGE_CASES
    for ci, (fractal, n, block, coarsen, fuse) in enumerate(cases):
        spec = F.FRACTALS.get(fractal, F.SIERPINSKI)
        lay = compact_layout(TW.resolve_fractal_domain(fractal, n, block))
        for rule in ("parity", "diffusion"):
            emb, packed = member_state(
                lay, block, n, spec, dev, 7 * ci,
                "binary" if rule == "parity" else "normal")
            for storage in ("embedded", "compact"):
                a = packed if storage == "compact" else emb
                b = torch.zeros_like(a)
                for gm in LOWERINGS:
                    plan, n_, blk = TC.prepare_run(
                        a, b, block=block, grid_mode=gm, fractal=fractal,
                        storage=storage, n=n, coarsen=coarsen)
                    h = TC.effective_fuse(fuse, fuse, blk, coarsen)
                    ncmp += ca_check_depths(TC, a, b, plan, n_, blk, h, h,
                                            rule)
        torch.cuda.synchronize()
        p = plan.launch_params(n_, blk, dev)
        ring = [TC.ring_geometry(p, h, st)[0] for st in CA_STAGES]
        print(f"[parity-ca] {fractal} n={n} rho={block} coarsen={coarsen} "
              f"fuse={fuse}: bit-equal (2 rules x 2 storages x "
              f"{len(LOWERINGS)} lowerings x num_stages {CA_STAGES}; ring "
              f"slots {ring}{', 0 = global scratch' if 0 in ring else ''})")
    print(f"[parity-ca] {ncmp} kernel-vs-plain comparisons passed, all "
          f"bit-equal")
    return 0.0


def packed_gasket_mask(layout, block, n, F, dev, band=64):
    """Cell membership of the packed gasket, built on the card in bands
    of packed block rows (no embedded array)."""
    scols, srows = layout.grid_shape
    r_b = layout.domain.r_b
    mask = torch.empty(layout.array_shape(block), dtype=torch.bool,
                       device=dev)
    sx = torch.arange(scols, device=dev)
    i = torch.arange(block, device=dev)
    for sy0 in range(0, srows, band):
        sy = torch.arange(sy0, min(srows, sy0 + band), device=dev)
        bx, by = F.lambda_map(sx[None, :], sy[:, None], r_b)
        gx = bx[:, None, :, None] * block + i[None, None, None, :]
        gy = by[:, None, :, None] * block + i[None, :, None, None]
        rows = len(sy) * block
        mask[sy0 * block:sy0 * block + rows] = \
            ((gx & (n - 1 - gy)) == 0).reshape(rows, scols * block)
    return mask


def lambda_order_index(layout, block, r, F, dev, chunk=1 << 24):
    """int64 offsets into the packed array of every member cell, in the
    cell-level lambda-linear order of cell_neighbor_tables(r)."""
    c = block.bit_length() - 1  # lambda digit levels inside a block
    r_b = r - c
    pitch = layout.array_shape(block)[1]
    out = torch.empty(3 ** r, dtype=torch.int64, device=dev)
    for start in range(0, 3 ** r, chunk):
        i = torch.arange(start, min(3 ** r, start + chunk), device=dev)
        sx, sy = F.deinterleave_linear(i // 3 ** c, 3, r_b)
        ox, oy = F.lambda_map_linear(i % 3 ** c, c)
        out[start:start + len(i)] = (sy * block + oy) * pitch \
            + sx * block + ox
    return out


def oracle_step(state, tables, rule, deg=None):
    """One cell-level CA step over lambda-ordered member cells (the JAX
    package's packed_parity_step gather strategy), in the kernel's
    operation order."""
    s = torch.cat([state, state.new_zeros(1)])
    nsum = s[tables[0]] + s[tables[1]] + s[tables[2]] + s[tables[3]]
    if rule == "parity":
        r = torch.fmod(state + nsum, 2.0)
        return torch.where((r != 0) & (r < 0), r + 2.0, r)
    al = torch.tensor(CA_ALPHA, dtype=state.dtype)
    return state + al * (nsum - deg * state)


def unpack_into(emb, packed, layout, block, chunk=1 << 14):
    """Scatter the packed member blocks into the embedded tensor ``emb``
    in place, in chunks of blocks (no second embedded-size temporary)."""
    nbx, nby = layout.domain.bounding_box
    scols, srows = layout.grid_shape
    E = emb.view(nby, block, nbx, block)
    P = packed.view(srows, block, scols, block)
    coords = torch.from_numpy(layout.domain.coords_host().astype("int64"))
    slots = torch.from_numpy(layout.slots_host().astype("int64"))
    coords, slots = coords.to(emb.device), slots.to(emb.device)
    for k in range(0, len(coords), chunk):
        c, sl = coords[k:k + chunk], slots[k:k + chunk]
        E[c[:, 1], :, c[:, 0], :] = P[sl[:, 1], :, sl[:, 0], :]


def phase_ca_main(ops, TC, F, LOWERINGS, compact_layout, cell_tables, TW,
                  dev):
    n, rho, T = N_MAIN, CA_RHO, CA_STEPS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lay = compact_layout(TW.resolve_fractal_domain("sierpinski-gasket", n,
                                                   rho))
    shape = lay.array_shape(rho)
    mbytes = shape[0] * shape[1] * 4
    print(f"[ca] gasket n={n} rho={rho} compact f32: packed {shape}, "
          f"{mbytes / 1e6:.1f} MB per buffer")
    mask = packed_gasket_mask(lay, rho, n, F, dev)
    check(int(mask.sum()) == F.gasket_volume(n), "packed mask count")
    t0 = time.perf_counter()
    tables = cell_tables(R_MAIN, device=dev)
    lam = lambda_order_index(lay, rho, R_MAIN, F, dev)
    torch.cuda.synchronize()
    print(f"[ca] oracle tables: cell_neighbor_tables({R_MAIN}) "
          f"{tuple(tables.shape)} int32 and the lambda-order index built "
          f"on the card in {time.perf_counter() - t0:.1f} s")
    vol = tables.shape[1]
    deg = sum((t != vol).float() for t in tables)
    g = torch.Generator(device=dev)
    init = {
        "parity": torch.where(mask, torch.randint(
            0, 2, shape, generator=g.manual_seed(SEED), device=dev).float(),
            0),
        "diffusion": torch.where(mask, torch.randn(
            shape, generator=g.manual_seed(SEED + 1), device=dev), 0)}
    want = {}
    for rule, x in init.items():
        s = x.view(-1)[lam]
        for _ in range(T):
            s = oracle_step(s, tables, rule, deg)
        want[rule] = s
    a = torch.empty(shape, dtype=torch.float32, device=dev)
    b = torch.empty_like(a)

    # -- the main path, counted --------------------------------------------
    results = {}
    TC.reset_launch_counts()
    for rule in ("parity", "diffusion"):
        for fuse in CA_FUSES:
            for gm in LOWERINGS:
                for st in CA_STAGES:
                    a.copy_(init[rule])
                    b.zero_()
                    out = ops.ca_run(a, b, T, fuse=fuse, rule=rule,
                                     alpha=CA_ALPHA, block=rho, grid_mode=gm,
                                     storage="compact", n=n, num_stages=st)
                    got = out.view(-1)[lam]
                    outside = int(torch.count_nonzero(
                        out.masked_fill(mask, 0)))
                    diff = float((got - want[rule]).abs().max())
                    close = bool(torch.isclose(got, want[rule], rtol=1e-5,
                                               atol=1e-6).all())
                    results[(rule, fuse, gm, st)] = (diff, outside, close)
    torch.cuda.synchronize()
    launches = TC.launch_counts()
    print(f"[ca] launches {launches}")
    check(launches["sierpinski_ca_fused"] > 0,
          "kernel sierpinski_ca_fused was not launched on the CA path")
    check(launches["sierpinski_ca_fused"] == 2 * len(LOWERINGS) * len(
        CA_STAGES) * sum(len(TC.launch_schedule(T, f)) for f in CA_FUSES),
        "unexpected CA launch count")
    oracle_err = {"parity": 0.0, "diffusion": 0.0}
    for (rule, fuse, gm, st), (diff, outside, close) in results.items():
        what = f"ca {rule} fuse={fuse} {gm} num_stages={st}"
        check(outside == 0, f"{what}: {outside} non-member cells are "
              f"nonzero")
        if rule == "parity":
            check(diff == 0.0, f"{what}: differs from the cell-level "
                  f"oracle by {diff}")
        check(close, f"{what}: outside rtol 1e-5 / atol 1e-6 of the "
              f"cell-level oracle (max |err| {diff})")
        oracle_err[rule] = max(oracle_err[rule], diff)
    print(f"[ca] {len(results)} runs of T={T} steps (num_stages "
          f"{CA_STAGES}) match the cell-level "
          f"oracle: parity bit-equal, diffusion max |err| "
          f"{oracle_err['diffusion']:.3e} (rtol 1e-5, atol 1e-6); "
          f"non-member cells all 0")

    # -- the plain version at full size (not counted) -----------------------
    gm, fuse, rule = CA_REPORT_AT
    plan, _, blk = TC.prepare_run(a, b, block=rho, grid_mode=gm,
                                  storage="compact", n=n)
    a.copy_(init[rule])
    b.zero_()
    x, y = a, b
    t0 = time.perf_counter()
    for k in TC.launch_schedule(T, fuse):
        TC.ca_launch_plain(x, y, plan, n, blk, fuse, k, rule, CA_ALPHA)
        x, y = y, x
    torch.cuda.synchronize()
    plain_run_s = time.perf_counter() - t0
    check(torch.equal(x.view(-1)[lam], want[rule]),
          "plain version at full size differs from the oracle")
    a2 = init[rule].clone()
    kern = ops.ca_run(a2, torch.zeros_like(a2), T, fuse=fuse, rule=rule,
                      block=rho, grid_mode=gm, storage="compact", n=n)
    check(torch.equal(kern, x), "kernel != plain version at full size")
    del a2, kern
    print(f"[ca] plain version at full size ({gm}, fuse {fuse}, {rule}): "
          f"bit-equal to the kernel, {plain_run_s:.2f} s for {T} steps")

    # -- embedded storage: two 16 GiB buffers (not counted) -----------------
    ecount = {"closed_form": None, "bounding": None}
    for gm in ecount:
        emb_a = torch.zeros((n, n), dtype=torch.float32, device=dev)
        unpack_into(emb_a, init["parity"], lay, rho)
        emb_b = torch.zeros_like(emb_a)
        out = ops.ca_run(emb_a, emb_b, T, fuse=8, rule="parity", block=rho,
                         grid_mode=gm)
        packed_out = lay.pack(out, rho)
        check(torch.equal(packed_out.view(-1)[lam], want["parity"]),
              f"embedded ca {gm}: pack(result) differs from the compact run")
        band = min(2048, n)
        x_ = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
        for y0 in range(0, n, band):
            yy = torch.arange(y0, y0 + band, dtype=torch.int32,
                              device=dev)[:, None]
            member = (x_ & (n - 1 - yy)) == 0
            check(int(torch.count_nonzero(out[y0:y0 + band].masked_fill(
                member, 0))) == 0,
                f"embedded ca {gm}: rows {y0}.. nonzero outside the gasket")
        del emb_a, emb_b, out, packed_out
        torch.cuda.empty_cache()
        print(f"[ca] embedded storage {gm} fuse 8: pack(result) bit-equal "
              f"to the compact run; zero outside the gasket in row bands")
    emb_peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # -- timings (not counted) ---------------------------------------------
    rows = []
    oracle_ms = time_ms(lambda: oracle_step(init["diffusion"].view(-1)[lam],
                                            tables, "diffusion", deg), 5)
    oracle_parity_ms = time_ms(
        lambda: oracle_step(init["parity"].view(-1)[lam], tables, "parity"),
        5)
    print(f"[ca] cell-level oracle: {oracle_parity_ms:.4f} ms per parity "
          f"step, {oracle_ms:.4f} ms per diffusion step (gather strategy "
          f"of the JAX package's benchmark)")
    a.copy_(init["parity"])
    b.zero_()
    for rule in ("parity", "diffusion"):
        for fuse in CA_FUSES:
            for gm in LOWERINGS:
                plan, _, blk = TC.prepare_run(a, b, block=rho, grid_mode=gm,
                                              storage="compact", n=n)
                p = plan.launch_params(n, blk, dev)
                for st in (CA_STAGES if rule == "parity" else (1,)):
                    ms = time_ms(lambda: TC.ca_cuda(a, b, p, fuse, fuse,
                                                    rule, CA_ALPHA, st), 10)
                    lut_bytes = 0 if p.lut is None else p.lut.numel() * 4
                    slots, ctas = TC.ring_geometry(p, fuse, st)
                    row = {"rule": rule, "fuse": fuse, "lowering": gm,
                           "num_stages": st, "ring_slots": slots,
                           "ctas": ctas, "launch_ms": ms,
                           "step_ms": ms / fuse}
                    row["bound_ms"], row["bound_by"] = bound(
                        2 * mbytes + lut_bytes,
                        fuse * F.gasket_volume(n) * CA_OPS[rule])
                    if (gm, fuse, rule) == CA_REPORT_AT and \
                            st == CA_REPORT_STAGES:
                        row["plain_ms"] = time_ms(
                            lambda: TC.ca_launch_plain(a, b, plan, n, blk,
                                                       fuse, fuse, rule,
                                                       CA_ALPHA), 2)
                    rows.append(row)
                    print(f"[ca] {json.dumps(row)}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[ca] peak device memory {peak:.2f} GiB (embedded runs "
          f"{emb_peak:.2f} GiB)")
    return {"rows": rows, "launches": launches, "oracle_err": oracle_err,
            "oracle_ms": {"parity": oracle_parity_ms,
                          "diffusion": oracle_ms},
            "plain_run_s": plain_run_s, "peak_gib": peak,
            "packed_shape": list(shape), "buffer_mb": mbytes / 1e6}


def phase_compact_main(ops, TW, F, LOWERINGS, compact_layout, dev):
    n = N_MAIN
    members = F.gasket_volume(n)
    torch.cuda.empty_cache()
    cases = [(rho, 1) for rho in RHOS] + [(32, 2)]
    states, masks = {}, {}
    for rho, _ in cases:
        if rho in states:
            continue
        lay = compact_layout(TW.resolve_fractal_domain("sierpinski-gasket",
                                                       n, rho))
        masks[rho] = packed_gasket_mask(lay, rho, n, F, dev)
        states[rho] = torch.empty(lay.array_shape(rho), dtype=torch.float32,
                                  device=dev)
        print(f"[compact] rho={rho}: packed {tuple(states[rho].shape)}, "
              f"{states[rho].numel() * 4 / 1e6:.1f} MB")

    # -- the main path, counted --------------------------------------------
    sums = {}
    gen = torch.Generator(device=dev)
    TW.reset_launch_counts()
    for rho, s in cases:
        m, mask = states[rho], masks[rho]
        for gm in LOWERINGS:
            m.fill_(2.0)
            ops.sierpinski_write_(m, 1.0, block=rho, grid_mode=gm,
                                  storage="compact", n=n, coarsen=s)
            check(torch.equal(m, torch.where(mask, 1.0, 2.0)),
                  f"compact write {gm} rho={rho} coarsen={s}: the packed "
                  f"array differs from value-on-members")
    for rho, s in cases:
        m = states[rho]
        m.random_(-8, 9, generator=gen.manual_seed(SEED + rho))
        for gm in LOWERINGS:
            sums[(rho, s, gm)] = ops.sierpinski_sum(
                m, block=rho, grid_mode=gm, storage="compact", n=n,
                coarsen=s)
    torch.cuda.synchronize()
    launches = TW.launch_counts()
    print(f"[compact] launches {launches}")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the compact "
              f"write/sum path")

    # -- checks and timings at the main path's shapes (not counted) ---------
    rows = []
    err = {name: 0.0 for name in TW.KERNELS}
    for rho, s in cases:
        m, mask = states[rho], masks[rho]
        exact = float(m[mask].double().sum())
        yard_ms = time_ms(lambda: m.masked_fill_(mask, 1.0), reps=5)
        m.random_(-8, 9, generator=gen.manual_seed(SEED + rho))
        for gm in LOWERINGS:
            plan, _, blk = TW.prepare_launch(m, block=rho, grid_mode=gm,
                                             storage="compact", n=n,
                                             coarsen=s)
            p = plan.launch_params(n, blk, dev)
            errs, plain_sum = TW.check_sum_against_plain(m, plan, n, blk, p)
            merge_err(err, errs)
            check(torch.equal(sums[(rho, s, gm)], plain_sum),
                  f"compact sum {gm} rho={rho} coarsen={s}: kernel "
                  f"{float(sums[(rho, s, gm)])} != plain {float(plain_sum)}")
            parts = TW.sum_partials_cuda(m, p)
            check(float(parts.double().sum()) == exact,
                  f"compact partials {gm} rho={rho} coarsen={s}: f64 total "
                  f"{float(parts.double().sum())} != {exact}")
            steps = p.steps
            lut_bytes = 0 if p.lut is None else p.lut.numel() * 4
            row = {
                "lowering": gm, "rho": rho, "coarsen": s, "steps": steps,
                "write_ms": time_ms(lambda: TW.write_cuda(m, 1.0, p), 20),
                "write_plain_ms": time_ms(
                    lambda: TW.sierpinski_write_plain(m, 1.0, plan, n, blk),
                    2),
                "write_library_ms": yard_ms,
                "partials_ms": time_ms(lambda: TW.sum_partials_cuda(m, p),
                                       20),
                "partials_plain_ms": time_ms(
                    lambda: TW.sum_partials_plain(m, plan, n, blk), 2),
                "sum_ms": time_ms(lambda: ops.sierpinski_sum(
                    m, block=rho, grid_mode=gm, storage="compact", n=n,
                    coarsen=s), 5),
            }
            for key, b in (("write", bound(members * 4 + lut_bytes)),
                           ("partials", bound(members * 4 + steps * 4
                                              + lut_bytes, members))):
                row[f"{key}_bound_ms"], row[f"{key}_bound_by"] = b
            rows.append(row)
            print(f"[compact] {json.dumps(row)}")
            m.random_(-8, 9, generator=gen.manual_seed(SEED + rho))
    print(f"[compact] integer states: partials bit-equal to the plain "
          f"version slot by slot, totals equal; max |err| {err}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return {"rows": rows, "launches": launches, "err": err,
            "peak_gib": peak}


# ---------------------------------------------------------------------------
# the row-major domains (domain=) and the mma lowering
# ---------------------------------------------------------------------------

#: write/sum/CA parity over the attention domains: (name, constructor
#: arguments, block)
DOMAIN_PARITY_CASES = [
    ("triangular", (17,), 1), ("triangular", (17,), 8),
    ("triangular", (200,), 32), ("band", (24, 5), 8),
    ("band", (8, 3, 20), 16), ("bounding-box", (7, 5), 8),
    ("bounding-box", (3, 6), 32)]
#: mma against closed_form, kernel against kernel: (fractal, n, block, s)
MMA_EQ_CASES = [("sierpinski-gasket", 1024, 8, 4),
                ("sierpinski-gasket", 4096, 32, 2),
                ("sierpinski-carpet", 729, 9, 3), ("vicsek-cross", 6561, 9, 9)]
#: the n = 2**16, rho = 32 domain cells: the causal triangle of 2**11
#: block rows (packed: 8 GiB f32) and the gemma3-12b window of 1024
#: tokens as a band of 32 blocks (embedded 16 GiB, packed 266 MB)
DOMAIN_MAIN = [("triangular", (2048,), "compact"),
               ("band", (2048, 32), "embedded"),
               ("band", (2048, 32), "compact")]


def make_domain(D, name, args):
    return {"triangular": D.TriangularDomain, "band": D.BandDomain,
            "bounding-box": D.BoundingBoxDomain}[name](*args)


def domain_state(lay, block, storage, dtype, seed, kind, dev):
    shape = lay.array_shape(block) if storage == "compact" \
        else lay.embedded_shape(block)
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "integer":
        x = torch.randint(-8, 9, shape, generator=g, device=dev)
    elif kind == "binary":
        x = torch.randint(0, 2, shape, generator=g, device=dev)
    else:
        x = torch.randn(shape, generator=g, device=dev)
    return x.to(dtype)


def phase_parity_domains(TW, TC, D, LOWERINGS, compact_layout, dev):
    """The write/sum and CA kernels over the row-major domains against
    their plain versions (every lowering, both storages; writes and
    integer sums bit-equal, CA bit-equal), mma bit-equal to closed_form
    there, and the fractal kernels under mma bit-equal to closed_form
    (write, partials, CA; compact and coarsened)."""
    err = {name: 0.0 for name in TW.KERNELS}
    ncmp = 0
    for ci, (name, args, block) in enumerate(DOMAIN_PARITY_CASES):
        dom = make_domain(D, name, args)
        lay = compact_layout(dom)
        for storage in ("embedded", "compact"):
            outs = {}
            for gm in LOWERINGS:
                for di, dtype in enumerate(DTYPES + (None,)):
                    integer = dtype is not None
                    m = domain_state(lay, block, storage,
                                     dtype or torch.float32, 50 * ci + di,
                                     "integer" if integer else "normal", dev)
                    plan, n_, blk = TW.prepare_launch(
                        m, block=block, grid_mode=gm, storage=storage,
                        domain=dom)
                    p = plan.launch_params(n_, blk, dev)
                    if integer:
                        TW.check_write_against_plain(m, 7.3, plan, n_, blk,
                                                     p)
                        ncmp += 1
                    errs, _ = TW.check_sum_against_plain(
                        m, plan, n_, blk, p,
                        rtol=None if integer else NORMAL_RTOL)
                    merge_err(err, errs)
                    ncmp += 2
                    if dtype == torch.int32:
                        outs[gm] = (TW.write_cuda(m.clone(), 5, p),
                                    TW.sum_partials_cuda(m, p))
            for gm in ("prefetch_lut", "mma"):
                check(all(torch.equal(a, b) for a, b in
                          zip(outs[gm], outs["closed_form"])),
                      f"{name} {args} {storage}: {gm} differs from "
                      f"closed_form")
            for rule in ("parity", "diffusion"):
                a = domain_state(lay, block, storage, torch.float32, ci,
                                 "binary" if rule == "parity" else "normal",
                                 dev)
                b = torch.zeros_like(a)
                cas = {}
                for gm in LOWERINGS:
                    plan, n_, blk = TC.prepare_run(
                        a, b, block=block, grid_mode=gm, storage=storage,
                        domain=dom)
                    for h, steps in sorted({(1, 1), (min(3, blk),) * 2}):
                        TC.check_ca_against_plain(a, b, plan, n_, blk, h,
                                                  steps, rule, CA_ALPHA)
                        ncmp += 1
                    cas[gm] = TC.ca_cuda(a, torch.zeros_like(a),
                                         plan.launch_params(n_, blk, dev),
                                         1, 1, rule, CA_ALPHA)
                check(torch.equal(cas["mma"], cas["closed_form"]),
                      f"ca {name} {args} {storage} {rule}: mma differs "
                      f"from closed_form")
        torch.cuda.synchronize()
        print(f"[parity-domains] {name}{args} rho={block}: write/sum and CA "
              f"kernels == plain ({len(LOWERINGS)} lowerings x 2 storages), "
              f"mma == closed_form")
    for ci, (fractal, n, block, s) in enumerate(MMA_EQ_CASES):
        lay = compact_layout(TW.resolve_fractal_domain(fractal, n, block))
        for storage in ("embedded", "compact"):
            for coarsen in (1, s):
                got = {}
                for gm in ("closed_form", "mma"):
                    x = domain_state(lay, block, storage, torch.float32,
                                     ci, "integer", dev) \
                        if storage == "compact" else \
                        random_state(n, torch.float32, ci, True, dev)
                    plan, n_, blk = TW.prepare_launch(
                        x, block=block, grid_mode=gm, fractal=fractal,
                        storage=storage, n=n, coarsen=coarsen)
                    p = plan.launch_params(n_, blk, dev)
                    h = min(3, coarsen * blk)
                    got[gm] = (TW.write_cuda(x.clone(), 7.0, p),
                               TW.sum_partials_cuda(x, p),
                               TC.ca_cuda(x, torch.zeros_like(x), p, h, h,
                                          "diffusion", CA_ALPHA))
                    ncmp += 3
                check(all(torch.equal(a, b) for a, b in
                          zip(got["mma"], got["closed_form"])),
                      f"{fractal} n={n} rho={block} {storage} coarsen="
                      f"{coarsen}: mma differs from closed_form")
        torch.cuda.synchronize()
        print(f"[parity-domains] {fractal} n={n} rho={block}: the mma "
              f"kernels (write, partials, CA) == closed_form, embedded / "
              f"compact x coarsen 1 / {s}")
    print(f"[parity-domains] {ncmp} comparisons passed; max |err| {err}")
    return err


def domain_member_bands(dom, lay, block, storage, dev, band_rows=64):
    """Yield (row0, row1, mask) over the state in bands of block rows:
    the cells of member blocks (embedded) or of the slots that hold
    member blocks (packed: slot index below num_blocks)."""
    if storage == "compact":
        scols, srows = lay.grid_shape
        sx = torch.arange(scols, device=dev)
        for r0 in range(0, srows, band_rows):
            sy = torch.arange(r0, min(srows, r0 + band_rows), device=dev)
            live = (sy[:, None] * scols + sx[None, :]) < dom.num_blocks
            yield (r0 * block, (r0 + len(sy)) * block,
                   live.repeat_interleave(block, 0)
                   .repeat_interleave(block, 1))
        return
    nbx, nby = dom.bounding_box
    bxs = torch.arange(nbx, device=dev)
    for r0 in range(0, nby, band_rows):
        bys = torch.arange(r0, min(nby, r0 + band_rows), device=dev)
        live = dom.contains(bxs[None, :], bys[:, None])
        live = torch.broadcast_to(torch.as_tensor(live, device=dev),
                                  (len(bys), nbx))
        yield (r0 * block, (r0 + len(bys)) * block,
               live.repeat_interleave(block, 0).repeat_interleave(block, 1))


def phase_domain_main(ops, TW, TC, D, LOWERINGS, compact_layout, dev, comp):
    """The n = 2**16, rho = 32 domain cells under the four lowerings:
    counted writes (checked against the membership rule band by band)
    and sums; then, not counted, the partials against the plain version
    slot by slot, their f64 total against the member total, and
    CUDA-event timings beside masked_fill_ / torch.masked.sum; a summary
    line per cell and lowering, and the packed gasket's masked_fill_
    (timed in the compact phase) beside them.  On the packed triangle the
    fused CA at fuse 8 (parity) under closed_form and mma (the batched
    row chain), bit-equal, timed (``ca_rows``)."""
    rho = CA_RHO
    rows, launches, ca_rows = [], {}, []
    gasket = {r["lowering"]: r for r in comp["rows"]
              if (r["rho"], r["coarsen"]) == (rho, 1)}
    print(f"[domains] packed gasket n={N_MAIN} rho={rho}: masked_fill_ "
          f"{gasket['closed_form']['write_library_ms']:.4f} ms; write "
          + ", ".join(f"{gm} {r['write_ms']:.4f}" for gm, r in
                      gasket.items())
          + f" ms (bound {gasket['closed_form']['write_bound_ms']:.4f})")
    for name, args, storage in DOMAIN_MAIN:
        torch.cuda.empty_cache()
        dom = make_domain(D, name, args)
        lay = compact_layout(dom)
        shape = lay.array_shape(rho) if storage == "compact" \
            else lay.embedded_shape(rho)
        members = dom.num_blocks * rho * rho
        m = torch.full(shape, 2.0, dtype=torch.float32, device=dev)
        what = f"{name}{args} {storage}"
        print(f"[domains] {what} rho={rho}: state {tuple(shape)} "
              f"({m.numel() * 4 / 2 ** 30:.2f} GiB f32), {dom.num_blocks} "
              f"member blocks, {members} member cells")
        kw = dict(block=rho, storage=storage, domain=dom)

        # -- the main path, counted ----------------------------------------
        sums = {}
        TW.reset_launch_counts()
        for gm in LOWERINGS:
            m.fill_(2.0)
            ops.sierpinski_write_(m, 1.0, grid_mode=gm, **kw)
            for r0, r1, live in domain_member_bands(dom, lay, rho, storage,
                                                    dev):
                check(torch.equal(m[r0:r1], torch.where(live, 1.0, 2.0)),
                      f"write {what} {gm}: rows {r0}..{r1} differ from "
                      f"the membership rule")
        gen = torch.Generator(device=dev).manual_seed(SEED + 7)
        m.random_(-8, 9, generator=gen)
        for gm in LOWERINGS:
            sums[gm] = ops.sierpinski_sum(m, grid_mode=gm, **kw)
        torch.cuda.synchronize()
        counts = TW.launch_counts()
        launches[what] = counts
        print(f"[domains] {what}: launches {counts}")
        for kname, count in counts.items():
            check(count > 0, f"kernel {kname} was not launched on the "
                  f"{what} path")

        # -- checks and timings (not counted) ------------------------------
        exact = 0.0
        mask = torch.empty(shape, dtype=torch.bool, device=dev)
        for r0, r1, live in domain_member_bands(dom, lay, rho, storage, dev):
            exact += float(m[r0:r1][live].double().sum())
            mask[r0:r1] = live
        fill_ms = time_ms(lambda: m.masked_fill_(mask, 1.0), 5)
        msum_ms = time_ms(lambda: torch.masked.sum(m, mask=mask), 5)
        m.random_(-8, 9, generator=gen.manual_seed(SEED + 7))
        for gm in LOWERINGS:
            plan, n_, blk = TW.prepare_launch(m, grid_mode=gm, **kw)
            p = plan.launch_params(n_, blk, dev)
            _, plain_sum = TW.check_sum_against_plain(m, plan, n_, blk, p)
            check(torch.equal(sums[gm], plain_sum),
                  f"sum {what} {gm}: kernel {float(sums[gm])} != plain "
                  f"{float(plain_sum)}")
            parts = TW.sum_partials_cuda(m, p)
            check(float(parts.double().sum()) == exact,
                  f"partials {what} {gm}: f64 total "
                  f"{float(parts.double().sum())} != {exact}")
            lut_bytes = 0 if p.lut is None else p.lut.numel() * 4
            row = {"domain": name, "args": list(args), "storage": storage,
                   "lowering": gm, "rho": rho, "steps": p.steps,
                   "member_blocks": dom.num_blocks, "sum": float(sums[gm]),
                   "write_ms": time_ms(lambda: TW.write_cuda(m, 1.0, p), 10),
                   "partials_ms": time_ms(
                       lambda: TW.sum_partials_cuda(m, p), 10),
                   "sum_ms": time_ms(lambda: ops.sierpinski_sum(
                       m, grid_mode=gm, **kw), 5),
                   "write_library_ms": fill_ms,
                   "partials_library_ms": msum_ms}
            if gm == "mma":
                row["write_plain_ms"] = time_ms(
                    lambda: TW.sierpinski_write_plain(m, 1.0, plan, n_, blk),
                    1, warmup=0)
            for key, b in (("write", bound(members * 4 + lut_bytes)),
                           ("partials", bound(members * 4 + p.steps * 4
                                              + lut_bytes, members))):
                row[f"{key}_bound_ms"], row[f"{key}_bound_by"] = b
            rows.append(row)
            print(f"[domains] {json.dumps(row)}")
            m.random_(-8, 9, generator=gen.manual_seed(SEED + 7))
        print(f"[domains] {what}: writes match the membership rule, "
              f"partials bit-equal to the plain version slot by slot, f64 "
              f"member total {exact}; masked_fill_ {fill_ms:.4f} ms, "
              f"torch.masked.sum {msum_ms:.4f} ms")
        for row in rows[-len(LOWERINGS):]:
            print(f"[domains] {what} {row['lowering']:>12}: write "
                  f"{row['write_ms']:.4f} ms (bound "
                  f"{row['write_bound_ms']:.4f}, masked_fill_ "
                  f"{fill_ms:.4f}), partials {row['partials_ms']:.4f} ms "
                  f"(bound {row['partials_bound_ms']:.4f}, "
                  f"torch.masked.sum {msum_ms:.4f})")
        if name == "triangular":
            ca_rows = domain_ca_rows(TC, dom, m, mask, storage, members, dev)
        del m, mask
    return {"rows": rows, "launches": launches, "ca_rows": ca_rows,
            "packed_gasket_masked_fill_ms":
                gasket["closed_form"]["write_library_ms"]}


def domain_ca_rows(TC, dom, m, mask, storage, members, dev, fuse=8):
    """The fused CA on a domain cell's state ``m`` (parity, fuse 8, ring
    depth 1): a binary member state, one launch under closed_form and
    one under mma (the row chain B7c, batched), bit-equal, then each
    timed beside the byte bound."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    m.random_(0, 2, generator=gen)
    m.masked_fill_(~mask, 0.0)
    b = torch.zeros_like(m)
    rows, first = [], None
    for gm in ("closed_form", "mma"):
        plan, n_, blk = TC.prepare_run(m, b, block=CA_RHO, grid_mode=gm,
                                       storage=storage, domain=dom)
        p = plan.launch_params(n_, blk, dev)
        TC.ca_cuda(m, b, p, fuse, fuse, "parity", CA_ALPHA, 1)
        if first is None:
            first = b.clone()
        else:
            check(torch.equal(b, first), f"ca {dom} {gm}: differs from "
                  f"closed_form")
        lut_bytes = 0 if p.lut is None else p.lut.numel() * 4
        row = {"domain": type(dom).__name__, "storage": storage,
               "lowering": gm, "fuse": fuse, "rule": "parity",
               "steps": p.steps, "ctas": TC.ring_geometry(p, fuse, 1)[1],
               "launch_ms": time_ms(lambda: TC.ca_cuda(
                   m, b, p, fuse, fuse, "parity", CA_ALPHA, 1), 5)}
        row["bound_ms"], row["bound_by"] = bound(
            2 * members * 4 + lut_bytes, fuse * members * CA_OPS["parity"])
        rows.append(row)
        print(f"[domains] ca {json.dumps(row)}")
    del b, first
    print(f"[domains] ca on the packed triangle, fuse {fuse}: mma bit-equal "
          f"to closed_form; ms " + ", ".join(
              f"{r['lowering']} {r['launch_ms']:.4f}" for r in rows))
    return rows


# ---------------------------------------------------------------------------
# block-space flash attention, paged decode and the LM servers
# ---------------------------------------------------------------------------

#: H100 SXM bf16 and TF32 dense tensor-core peaks (NVIDIA's data sheet,
#: 700 W)
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12
#: parity-attn: head layouts (H, Hkv), head dims, square block sizes
ATTN_HEADS = {"MHA": (4, 4), "GQA": (16, 8), "MQA": (8, 1)}
ATTN_DIMS, ATTN_BLOCKS = (64, 128, 256), (64, 128)
ATTN_DTYPES = (torch.float32, torch.bfloat16)
#: attn: (name, B, H, Hkv, S, D, dtype, kind, window, block) at the widths
#: of quickstart and gemma3-12b.  A prompt of 4104 tokens (a multiple of 8
#: but not of 16) is split into 57 blocks of 72: the tile paths' ragged
#: instantiations serve it.  Head rows that are no whole number of 16-byte
#: pieces go the same way: 62 f32 values (248 bytes, 8-byte pieces) at
#: quickstart's widths, 250 bf16 values (500 bytes, 4-byte pieces) at
#: gemma3-12b's
ATTN_TIMED = [("quickstart causal", 4, 12, 12, 4096, 64, torch.float32,
               "causal", 0, 128),
              ("quickstart causal S 4104", 4, 12, 12, 4104, 64,
               torch.float32, "causal", 0, 72),
              ("quickstart causal D 62", 4, 12, 12, 4096, 62,
               torch.float32, "causal", 0, 128),
              ("gemma3-12b causal", 1, 16, 8, 4096, 256, torch.bfloat16,
               "causal", 0, 128),
              ("gemma3-12b causal D 250", 1, 16, 8, 4096, 250,
               torch.bfloat16, "causal", 0, 128),
              ("gemma3-12b local", 1, 16, 8, 8192, 256, torch.bfloat16,
               "local", 1024, 128),
              ("gemma3-12b causal S 4104", 1, 16, 8, 4104, 256,
               torch.bfloat16, "causal", 0, 72),
              ("gemma3-12b causal f32", 1, 16, 8, 4096, 256, torch.float32,
               "causal", 0, 128)]
#: serve: quickstart at full width, then gemma3-12b at full width cut to
#: 6 of its 48 layers (one 5:1 local:global period); max_len a multiple
#: of 128 so every decode attention runs the block-space kernel
SERVE_RUNS = [("quickstart", dict(), 8, 128, 32, 256),
              ("gemma3-12b", dict(n_layers=6), 4, 1536, 16, 1664)]
#: step logits of the kernel decode vs the plain decode.  f32: the two
#: attention outputs differ by ~1e-6 relative (sequential fma vs a
#: matmul), a few 1e-6 to 1e-5 after 12 layers.  bf16: the plain decode
#: rounds p and its output to bf16 where the kernel keeps f32, ~2**-8
#: relative per layer; logits of magnitude ~4 then differ by a few bf16
#: ulps (2**-6 each).
SERVE_TOL = {"float32": 1e-4, "bfloat16": 0.25}
#: paged: 16 mixed-length requests (prompts of 4..128 tokens from seed
#: 0), 8 slots, 16-token pages; 48 usable pages force preemptions
PAGED_REQUESTS, PAGED_PROMPT, PAGED_NEW = 16, 128, 32
PAGED_SLOTS, PAGED_PS, PAGED_PAGES = 8, 16, 49
TIMING_KEYS = ("seconds", "tok_per_s", "ms_per_decode_step")
#: the [tune] phase: the write/CA problem (gasket n = 2**16 at rho 32), the
#: CA's steps per measured run, and the flash / paged widths (quickstart's
#: causal prefill and serving decode, the longest serving length above)
TUNE_RHO, TUNE_CA_STEPS = 32, 8
TUNE_FLASH = dict(kind="causal", batch=4, sq=4096, blocks=(64, 128, 256))
TUNE_PAGED = dict(batch=8, seq=SERVE_RUNS[0][5], page_sizes=(8, 16, 32, 64))
#: the [train] phase.  quickstart at full width on the learnable
#: pipeline: 21 steps with a checkpoint at step 10 (taken after 11
#: updates, the pipeline at batch 11), a second Trainer resumes it and
#: runs steps 10-19, which are the first run's 11-20; then a Server of the
#: last checkpoint decodes a few requests.  gemma3-12b at full width with
#: 6 of its 48 layers (one 5:1 local:global period), batch 1, S 4096:
#: above flash_threshold 2048, so the flash VJP runs at chunk 1024, remat
#: on, the loss over logit chunks of 256.
TRAIN_QS = dict(batch=8, seq=512, steps=21, every=10, lr=1e-3, warmup=3)
TRAIN_QS_SERVE = dict(batch=4, prompt=32, max_new=8, max_len=128)
TRAIN_GEMMA = dict(layers=6, batch=1, seq=4096, steps=3, lr=1e-4)
#: the resumed run's losses against the uninterrupted run's: the restored
#: weights and moments are bit-equal, so only the order of the card's
#: atomic adds (the embedding's backward) separates them;
#: torch.use_deterministic_algorithms is not set
TRAIN_RESUME_RTOL = 1e-4
#: the flash VJP's gradients against autograd through simple_attention,
#: f32, each error relative to that gradient's largest magnitude
VJP_CASES = [("local", 1024, "dense"), ("causal", 0, "dense"),
             ("causal", 0, "triangular")]
VJP_SHAPE = dict(b=1, h=16, hkv=8, s=4096, d=256, chunk=1024)
VJP_TOL = 2e-5
#: the [families] phase.  The decode kernels at llama4-maverick's heads
#: (40 q over 8 kv heads: a group of 5 in a head chunk of 8 rows, D 128,
#: bf16), the positions at tile and split edges of 128-key blocks.  The
#: depth cuts come from memory: one llama4 MoE layer holds 32.2 GB of
#: bf16 experts (its training ~129 GB), one deepseek-v2 MoE layer 7.5 GB.
FAM_DECODE = dict(arch="llama4-maverick-400b-a17b", b=4, h=40, hkv=8,
                  d=128, max_len=2048, positions=(63, 256, 511, 1500))
#: llama4-maverick at full width cut to 2 of its 48 layers (layer 0 dense,
#: layer 1 MoE; 18.7 B bf16 parameters): the Server (max_len a multiple
#: of 128, so every decode attention runs the kernel), then the
#: PagedServer on mixed prompts of 64..512 tokens
FAM_LLAMA = dict(layers=2, batch=4, prompt=1024, max_new=16, max_len=1152)
FAM_PAGED = dict(requests=8, slots=4, ps=16, lo=64, hi=512, max_new=16)
#: deepseek-v2 at full width cut to 4 of its 60 layers (the dense first
#: layer and 3 MoE layers; 13.3 B bf16 parameters): the Server, the MLA
#: check (the absorbed decode at positions prompt .. prompt + 7 against
#: the prefill of the extended sequence) and the MoE check (moe_block
#: against moe_block_dense_ref on 64 tokens)
FAM_DEEPSEEK = dict(layers=4, batch=4, prompt=1024, max_new=16,
                    max_len=1040, mla_steps=8, moe_tokens=64)
#: deepseek-v2 trained at 2 of its 60 layers: batch 1 x 4096 (above
#: flash_threshold 2048: MLA through the flash VJP at V head dim 128
#: against QK 192), bf16 parameters and AdamW moments, remat
FAM_TRAIN = dict(layers=2, batch=1, seq=4096, steps=3, lr=1e-4)
#: the MLA check on the model, in f32 compute over the bf16 weights, one
#: row, a capacity that drops nothing: what is left between the absorbed
#: decode and the materialised prefill is f32 rounding (~1e-5 of logits
#: of magnitude ~4).  In bf16 a near-tie of the router's 6th and 7th
#: expert flips between the two paths (their inputs differ by bf16
#: rounding), which moves whole logits; the bf16 check is held at the
#: first layer's MLA block instead (no router before it), within the
#: bf16 tolerance of the attention kernels (FA._compare: 2e-2, each row
#: within ROW_RTOL of its norm; ~4 roundings of 2^-9 on each path)
FAM_MLA_F32_TOL = 2e-3


#: the [ssm] phase.  Phase 1: the scans at full width in f32 against
#: their sequential oracles, within the reference's own tolerance
#: (tests/test_ssm.py): selective_scan at falcon-mamba-7b's shapes, the
#: SSD at zamba2-2.7b's (80 heads of 64, N 64), one batch row, S 512 in
#: chunks of 256
SSM_S6 = dict(b=1, s=512, di=8192, n=16, chunk=256)
SSM_SSD = dict(b=1, s=512, nh=80, p=64, n=64, chunk=256)
SSM_TOL = dict(rtol=1e-4, atol=1e-5)
#: falcon-mamba-7b at full width and depth (64 layers, 7.27 B f32
#: parameters, 29.1 GB): the Server; then an f32 copy cut to 2 layers
#: holds the decode to the prefill: a prefill of ``check_prompt +
#: check_steps`` tokens against a prefill of ``check_prompt`` and
#: ``check_steps`` decode steps fed the same tokens, the last logits and
#: every layer's states within SSM_DECODE_TOL
SSM_FALCON = dict(batch=4, prompt=1024, max_new=16, max_len=1040,
                  check_layers=2, check_batch=2, check_prompt=768,
                  check_steps=256)
SSM_DECODE_TOL = 2e-3
#: falcon-mamba-7b's guarded Server under a poisoned and a failed decode
#: step (site, call index): an SSM decode step is not idempotent, so each
#: retry must rerun on the states the faulted attempt was given, and the
#: stream must equal the unfaulted one
SSM_CHAOS = (("poison_result", "serve.decode", 2),
             ("transient_error", "serve.decode", 5))
#: zamba2-2.7b at full width and depth (54 Mamba-2 layers, 9
#: applications of the shared block; 2.44 B f32 parameters): the Server
#: under blockspace and xla in turns (max_len a multiple of 128, so every
#: shared-block decode attention runs the kernel), streams compared as
#: [serve] compares gemma3-12b's
SSM_ZAMBA = dict(batch=4, prompt=2048, max_new=16, max_len=2176)
#: the embedding-input stacks: musicgen-large at full depth (48 layers,
#: 3.23 B), internvl2-26b cut to 12 of its 48 layers (21.0 GB of its 77
#: GB of f32 parameters): a prefill of seeded (B, prompt, D) embeddings,
#: then ``steps`` decode steps on (B, 1, D) embeddings, blockspace
#: against xla (step logits within SERVE_TOL)
SSM_EMB = {"musicgen-large": dict(layers=48, batch=4, prompt=2048, steps=16,
                                  max_len=2176),
           "internvl2-26b": dict(layers=12, batch=4, prompt=2048, steps=16,
                                 max_len=2176)}
#: each stack trained 3 steps at cut depth, batch 1 x 2048 (a multiple of
#: ssd_chunk 256 and of logit_chunk 512)
SSM_TRAIN = dict(batch=1, seq=2048, steps=3, lr=1e-4,
                 layers={"falcon-mamba-7b": 2, "zamba2-2.7b": 6,
                         "musicgen-large": 4, "internvl2-26b": 2})


def attn_bound(nbytes, nops, dtype, route="cuda_core"):
    """Least time in ms: bytes over the memory rate, or the operations
    over the peak of the units that run them -- f32 on the CUDA cores,
    bf16 on the tensor cores, or for the 3xTF32 kernel (route "tc_f32")
    three tf32 products for each f32 one on the tensor cores; returns
    (ms, bound_by, peak name)."""
    if route == "tc_f32":
        peak, name = TF32_OPS_PER_S / 3, "tf32 495 TFLOP/s, 3 products each"
    elif dtype == torch.float32:
        peak, name = F32_OPS_PER_S, "f32 67 TFLOP/s"
    else:
        peak, name = BF16_OPS_PER_S, "bf16 989 TFLOP/s"
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / peak * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", name
    return t_ops, "operations", name


def attn_inputs(shapes, dtype, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(dtype) for s in shapes]


def paged_copy(k, v, ps, P, dev, seed):
    """The contiguous caches k, v (B, Hkv, S, D) scattered into a pool
    of shuffled pages; returns (pool, int32 table)."""
    b, hkv, s, d = k.shape
    npg = s // ps
    perm = torch.randperm(b * npg, generator=torch.Generator().manual_seed(
        seed)) + 1
    pool = P.init_pool(b * npg + 1, hkv, ps, d, k.dtype, dev)
    table = perm.reshape(b, npg).to(torch.int32)
    for i in range(b):
        P.write_prefill_pages(pool, table[i].to(dev), k[i], v[i])
    return pool, table.to(dev)


def phase_parity_attn(FA, LOWERINGS, pack_kv, P, dev):
    """The attention kernels against their plain versions on the card:
    kinds x lowerings x {MHA, GQA 16/8, MQA} x D x blocks x dtypes, the
    lowerings bit-equal to each other; rectangular local with compact
    KV; seq_pos scalar / vector and full + window; and the paged kernel
    bit-equal to the contiguous seq_pos kernel at block_k == page_size.
    Each flash case is counted and its errors (max |err|, and in bf16 the
    largest per-row relative error, held to FA.ROW_RTOL) kept under the
    kernel flash_route sends it to."""
    err = {name: 0.0 for name in FA.KERNELS}
    rel = {name: 0.0 for name in FA.ROUTE_KERNELS.values()}
    cases = {name: 0 for name in FA.ROUTE_KERNELS.values()}

    def flash_check(q, k, v, sched, pos=None):
        name = FA.ROUTE_KERNELS[FA.flash_route(sched, q.dtype)]
        out = FA.flash_cuda(q, k, v, sched, pos)
        want = FA.flash_attention_plain(q, k, v, sched, pos)
        err[name] = max(err[name], FA._compare(
            out, want, f"parity-attn {name} {sched.kind} {sched.lowering} "
            f"q {tuple(q.shape)} k {tuple(k.shape)} blocks "
            f"{sched.block_q}/{sched.block_k} {q.dtype}"))
        if q.dtype in FA.ROW_RTOL:
            rel[name] = max(rel[name], FA.row_rel_err(out, want))
        cases[name] += 1
        return out

    seed = 0
    for kind in ("causal", "local", "full"):
        for hname, (h, hkv) in ATTN_HEADS.items():
            for d in ATTN_DIMS:
                for blk in ATTN_BLOCKS:
                    for dtype in ATTN_DTYPES:
                        seed += 1
                        s = 512 if kind == "local" else 256
                        q, k, v = attn_inputs([(2, h, s, d), (2, hkv, s, d),
                                               (2, hkv, s, d)], dtype, seed,
                                              dev)
                        outs = [flash_check(q, k, v, FA.flash_schedule(
                            q.shape, k.shape, kind=kind,
                            window=2 * blk if kind == "local" else 0,
                            block_q=blk, block_k=blk, grid_mode=gm))
                            for gm in LOWERINGS]
                        check(all(torch.equal(o, outs[0]) for o in outs),
                              f"flash {kind} {hname} d={d} block={blk} "
                              f"{dtype}: the lowerings differ")
        torch.cuda.synchronize()
        print(f"[parity-attn] {kind}: {len(LOWERINGS)} lowerings x "
              f"{len(ATTN_HEADS)} head "
              f"layouts x D {ATTN_DIMS} x blocks {ATTN_BLOCKS} x f32/bf16 "
              f"within tolerance, lowerings bit-equal")
    # f32 below the 3xTF32 kernel's d 256 instantiation (its inexact
    # form), then the ragged calls the tile paths take since they pad
    # inside the kernel -- blocks of 8, 24 and 72, block_q = 1 without
    # seq_pos, head dims of 8 (bf16) or 4 (f32) mod 16, head rows that
    # are no whole number of 16-byte pieces (f32 D 62 and 37, bf16 D 60,
    # 37 and 250: 8-, 4- and 2-byte pieces), views off a 16-byte
    # boundary
    for d in (200, 136):
        for kind in ("causal", "full"):
            seed += 1
            q, k, v = attn_inputs([(2, 16, 256, d), (2, 8, 256, d),
                                   (2, 8, 256, d)], torch.float32, seed, dev)
            outs = [flash_check(q, k, v, FA.flash_schedule(
                q.shape, k.shape, kind=kind, block_q=64, block_k=64,
                grid_mode=gm)) for gm in LOWERINGS]
            check(all(torch.equal(o, outs[0]) for o in outs),
                  f"flash f32 {kind} d={d}: the lowerings differ")
    ragged = {name: 0 for name in FA.ROUTE_KERNELS.values()}
    both, f32, bf16 = ATTN_DTYPES, (torch.float32,), (torch.bfloat16,)
    for blk, s, d, kind, dtypes in (
            (8, 64, 64, "causal", both), (24, 96, 256, "causal", both),
            (64, 128, 40, "causal", both), (72, 216, 64, "causal", both),
            (72, 216, 256, "causal", both), (24, 72, 72, "local", both),
            (1, 64, 64, "full", both), (40, 120, 36, "causal", f32),
            (64, 128, 62, "causal", f32), (64, 128, 60, "causal", bf16),
            (64, 128, 37, "causal", both), (72, 216, 37, "causal", both),
            (72, 216, 62, "causal", f32), (72, 216, 60, "causal", bf16),
            (64, 128, 250, "causal", bf16), (72, 216, 250, "causal", bf16)):
        for dtype in dtypes:
            seed += 1
            sq = 1 if blk == 1 else s
            q, k, v = attn_inputs([(2, 8, sq, d), (2, 4, s, d),
                                   (2, 4, s, d)], dtype, seed, dev)
            outs = []
            for gm in LOWERINGS:
                sched = FA.flash_schedule(
                    q.shape, k.shape, kind=kind,
                    window=2 * blk if kind == "local" else 0, block_q=blk,
                    block_k=64 if blk == 1 else blk, grid_mode=gm)
                ragged[FA.ROUTE_KERNELS[FA.flash_route(sched, dtype)]] += 1
                outs.append(flash_check(q, k, v, sched))
            check(all(torch.equal(o, outs[0]) for o in outs),
                  f"flash {dtype} {kind} d={d} blocks {blk}: the lowerings "
                  f"differ")
    for dtype in ATTN_DTYPES:
        for d in (64, 256):
            shape = (1, 4, 144, d)
            base = attn_inputs([(4 * 144 * d + 1,)] * 3, dtype, 550 + d, dev)
            q, k, v = (t[1:].view(shape) for t in base)
            check(not FA._aligned(q), "the view is off a 16-byte boundary")
            for gm in LOWERINGS:
                for blk in (48, 72):
                    sched = FA.flash_schedule(
                        shape, shape, kind="causal", block_q=blk,
                        block_k=blk, grid_mode=gm)
                    ragged[FA.ROUTE_KERNELS[FA.flash_route(sched, dtype)]] \
                        += 1
                    flash_check(q, k, v, sched)
    # the CUDA-core kernel, which no route takes, launched directly at the
    # head dims it served last (f32 D 62, bf16 D 60)
    for dtype, d in ((torch.float32, 62), (torch.bfloat16, 60)):
        q, k, v = attn_inputs([(2, 8, 128, d), (2, 4, 128, d),
                               (2, 4, 128, d)], dtype, 560 + d, dev)
        sched = FA.flash_schedule(q.shape, k.shape, kind="causal",
                                  block_q=64, block_k=64)
        err["flash_attention"] = max(err["flash_attention"], FA._compare(
            FA.flash_cuda_core(q, k, v, sched),
            FA.flash_attention_plain(q, k, v, sched),
            f"parity-attn flash_fwd_kernel (direct) D {d} {dtype}"))
        cases["flash_attention"] += 1
    torch.cuda.synchronize()
    check(ragged["flash_attention"] == 0 and
          ragged["flash_attention_tc"] > 0 and
          ragged["flash_attention_tc_f32"] > 0,
          f"the ragged cases took the wrong kernels: {ragged}")
    print(f"[parity-attn] f32 at D 200 / 136 (3xTF32, the inexact d 256 "
          f"form); ragged calls -- blocks 8 / 24 / 72, block_q 1 without "
          f"seq_pos, bf16 D 40 / 72, f32 D 36, D 256 at 72-token blocks, "
          f"misaligned views copied to an aligned buffer, head rows of no "
          f"whole number of 16-byte pieces (f32 D 62 / 37, bf16 D 60 / 37 "
          f"/ 250 at blocks 64 and 72) -- on the tile paths: within "
          f"tolerance, lowerings bit-equal; cases per kernel {ragged}; the "
          f"CUDA-core kernel launched directly at f32 D 62 and bf16 D 60: "
          f"within tolerance")
    # rectangular local: queries are the last 256 of 1024 positions, the
    # compact K/V hold only the band's key-block support
    for dtype in ATTN_DTYPES:
        q, k, v = attn_inputs([(2, 16, 256, 128), (2, 8, 1024, 128),
                               (2, 8, 1024, 128)], dtype, 500, dev)
        for gm in LOWERINGS:
            emb = FA.flash_schedule(q.shape, k.shape, kind="local",
                                    window=256, block_q=128, block_k=128,
                                    grid_mode=gm)
            kc = pack_kv(k, emb.domain, 128).contiguous()
            vc = pack_kv(v, emb.domain, 128).contiguous()
            comp = FA.flash_schedule(q.shape, kc.shape, kind="local",
                                     window=256, block_q=128, block_k=128,
                                     grid_mode=gm, storage="compact",
                                     kv_seq_len=1024)
            o1 = flash_check(q, k, v, emb)
            o2 = flash_check(q, kc, vc, comp)
            check(torch.equal(o1, o2), f"compact KV {gm} {dtype}: differs "
                  f"from embedded")
    print("[parity-attn] rectangular local (Sq 256 of Sk 1024, window 256) "
          "with compact KV: within tolerance, bit-equal to embedded KV")
    # seq_pos: scalar and per-row, full + run-time window, at block_q 1
    # (decode, the split-K decode kernel in both dtypes) and block_q 64 (on
    # the tensor cores: bf16, and f32 at D 64)
    for dtype in ATTN_DTYPES:
        for d in (64, 256):
            for sq, bq in ((1, 1), (64, 64)):
                q, k, v = attn_inputs([(4, 16, sq, d), (4, 8, 1024, d),
                                       (4, 8, 1024, d)], dtype, 600 + d, dev)
                for pos, win in ((700, 0), ([0, 127, 128, 1023], 0),
                                 ([0, 127, 600, 1023], 300)):
                    pv = FA.seq_pos_vector(pos, 4, dev)
                    for gm in LOWERINGS:
                        flash_check(q, k, v, FA.flash_schedule(
                            q.shape, k.shape, kind="full", window=win,
                            block_q=bq, block_k=128 if bq == 1 else 64,
                            grid_mode=gm, has_pos=True), pv)
    print("[parity-attn] seq_pos scalar / (B,) vector, full + window 300, "
          "block_q 1 and 64: within tolerance")
    # paged == contiguous seq_pos decode, bit for bit (pages of 16 at D 256:
    # gemma3-12b's width)
    nbit = 0
    for dtype in ATTN_DTYPES:
        for ps, d in ((16, 64), (64, 128), (128, 256), (16, 256)):
            q, k, v = attn_inputs([(4, 16, 1, d), (4, 8, 1024, d),
                                   (4, 8, 1024, d)], dtype, 700 + ps, dev)
            pool, table = paged_copy(k, v, ps, P, dev, ps)
            pos = torch.tensor([0, 130, 777, 1023], dtype=torch.int32,
                               device=dev)
            for win in (0, 300):
                psched = FA.paged_schedule(q.shape, pool.shape, table.shape,
                                           window=win)
                e, paged = FA.check_paged_against_plain(q, pool, table, pos,
                                                        psched)
                err["paged_flash_attention"] = max(
                    err["paged_flash_attention"], e)
                sched = FA.flash_schedule(q.shape, k.shape, kind="full",
                                          window=win, block_q=1, block_k=ps,
                                          has_pos=True)
                check(FA.flash_route(sched, dtype) == "decode",
                      "decode routed off the split-K decode kernel")
                check(torch.equal(paged, FA.flash_cuda(q, k, v, sched, pos)),
                      f"paged decode ps={ps} d={d} window={win} {dtype}: "
                      f"not bit-equal to the contiguous decode kernel")
                nbit += 1
    torch.cuda.synchronize()
    print(f"[parity-attn] paged decode: within tolerance of its plain "
          f"version and bit-equal to the contiguous decode kernel at "
          f"block_k == page_size ({nbit} cases)")
    check(all(c > 0 for c in cases.values()),
          f"a flash kernel took no parity case: {cases}")
    print(f"[parity-attn] flash cases per kernel: {cases}; "
          f"{sum(cases.values()) + nbit} kernel-vs-plain comparisons "
          f"passed; max |err| {err} (f32 rtol/atol 2e-5, bf16 2e-2); bf16 "
          f"max per-row relative error {rel} (bound "
          f"{FA.ROW_RTOL[torch.bfloat16]})")
    return err, rel, cases


def needed_pairs(kind, s, window):
    """Unmasked (query, key) pairs of one (batch, head) at Sq = Sk = s:
    causal keys 0..q, local the min(q + 1, window) keys ending at q."""
    if kind == "causal" or (kind == "local" and window >= s):
        return s * (s + 1) // 2
    if kind == "local":
        return window * (window + 1) // 2 + (s - window) * window
    return s * s


def sdpa_kernels(fn):
    """The device kernels one call of ``fn`` launches, by name, from a
    torch.profiler trace (the SDPA backend that ran); empty when the
    trace holds no device activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if getattr(e, "device_type", None) is not None
                   and "CUDA" in str(e.device_type)})


def device_ms(fn, reps=50):
    """The card's time for one call of ``fn`` in ms: the durations of the
    device kernels it launches, summed over a torch.profiler trace of
    ``reps`` calls after a warm-up, over reps; None when the trace holds
    no device time.  A CUDA-event span around a call as short as a decode
    also counts the host time between its launches (the wrapper's Python),
    this does not."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if getattr(e, "device_type", None) is not None
             and "CUDA" in str(e.device_type))
    return us / reps / 1e3 if us > 0 else None


def device_times(row):
    """A decode row's kernel and library times for the kernels line: the
    profiler's device times where it saw them (a decode is shorter than
    the host time of its call), else the CUDA-event spans; the spans
    stay beside them as call_ms / library_call_ms."""
    dev_ok = row.get("device_ms") is not None \
        and row.get("library_device_ms") is not None
    return {"ms": row["device_ms"] if dev_ok else row["ms"],
            "library_ms": row["library_device_ms"] if dev_ok
            else row["library_ms"],
            "ms_by": "torch.profiler device time" if dev_ok
            else "CUDA events around one call",
            "call_ms": row["ms"], "library_call_ms": row["library_ms"]}


def phase_attn(FA, LOWERINGS, dev):
    """flash_attention at the widths of quickstart and gemma3-12b under
    the four lowerings.  Per case the launch counts are set to 0, the
    entry point runs once per lowering, and the counts are read: the
    kernel flash_route names launched once per lowering and no other.
    Then kernel vs plain (max |err| and the largest per-row relative
    error, bf16 held to FA.ROW_RTOL), and CUDA-event medians of the
    kernel, its plain version and scaled_dot_product_attention (whose
    device kernels are named); every row also times the CUDA-core kernel,
    which no route takes, on the same inputs (``cuda_core_ms``, launched
    directly after the counted run), and holds its output under the first
    lowering against the plain version (``cuda_core_max_abs_err``).
    Returns (rows, launches per kernel over the counted runs)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    launches = {name: 0 for name in FA.KERNELS}
    for name, b, h, hkv, s, d, dtype, kind, window, blk in ATTN_TIMED:
        torch.cuda.empty_cache()
        q, k, v = attn_inputs([(b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)],
                              dtype, 800, dev)
        scheds = [FA.flash_schedule(q.shape, k.shape, kind=kind,
                                    window=window, block_q=blk,
                                    block_k=blk, grid_mode=gm)
                  for gm in LOWERINGS]
        route = FA.flash_route(scheds[0], dtype)
        FA.reset_launch_counts()
        outs = [FA.flash_attention(q, k, v, kind=kind, window=window,
                                   block_q=blk, block_k=blk, grid_mode=gm)
                for gm in LOWERINGS]
        torch.cuda.synchronize()
        counts = FA.launch_counts()
        want = {n: len(LOWERINGS) if n == FA.ROUTE_KERNELS[route] else 0
                for n in FA.KERNELS}
        check(counts == want, f"attn {name}: launches {counts}, expected "
              f"{want}")
        for n, c in counts.items():
            launches[n] += c
        plain = FA.flash_attention_plain(q, k, v, scheds[0])
        plain_ms = time_ms(lambda: FA.flash_attention_plain(
            q, k, v, scheds[0]), 2, warmup=0)
        for gm, sched, out in zip(LOWERINGS, scheds, outs):
            err = FA._compare(out, plain, f"attn {name} {gm}")
            check(torch.equal(out, outs[0]),
                  f"attn {name}: {gm} differs from {LOWERINGS[0]}")
            row = {"case": name, "lowering": gm, "kernel": route, "b": b,
                   "h": h, "hkv": hkv, "s": s, "d": d, "dtype": str(dtype),
                   "kind": kind, "window": window, "blocks": sched.block_q,
                   "visited_tiles": sched.domain.num_blocks,
                   "max_abs_err": err,
                   "max_row_rel_err": FA.row_rel_err(out, plain),
                   "ms": time_ms(lambda: FA.flash_cuda(q, k, v, sched), 5),
                   "plain_ms": plain_ms}
            # the CUDA-core kernel on the same inputs, launched directly
            # (after the counted run), checked once a row
            if gm == LOWERINGS[0]:
                row["cuda_core_max_abs_err"] = FA._compare(
                    FA.flash_cuda_core(q, k, v, sched), plain,
                    f"attn {name} {gm} CUDA-core kernel")
            row["cuda_core_ms"] = time_ms(
                lambda: FA.flash_cuda_core(q, k, v, sched), 5)
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
            nops = 4 * d * b * h * needed_pairs(kind, s, window)
            row["bound_ms"], row["bound_by"], row["peak"] = attn_bound(
                nbytes, nops, dtype, route)
            rows.append(row)
        if kind == "causal":
            lib = lambda: sdpa(q, k, v, is_causal=True,  # noqa: E731
                               enable_gqa=hkv != h)
        else:
            qp = torch.arange(s, device=dev)[:, None]
            kp = torch.arange(s, device=dev)[None, :]
            mask = (kp <= qp) & (kp > qp - window)
            lib = lambda: sdpa(q, k, v, attn_mask=mask,  # noqa: E731
                               enable_gqa=hkv != h)
        lib_ms = time_ms(lib, 5)
        lib_err = float((lib().float() - plain.float()).abs().max())
        lib_kernels = sdpa_kernels(lib)
        print(f"[attn] {name} ({dtype}): scaled_dot_product_attention ran "
              f"{lib_kernels or 'no device kernel the profiler saw'}")
        for row in rows[-len(LOWERINGS):]:
            row["library_ms"] = lib_ms
            row["library_max_abs_err"] = lib_err
            row["library_kernels"] = lib_kernels
            print(f"[attn] {json.dumps(row)}")
        del q, k, v, plain, outs
    for r in rows:
        check(r["kernel"] == ("tc" if r["dtype"] == str(torch.bfloat16)
                              else "tc_f32"),
              f"attn {r['case']}: routed to {r['kernel']}")
    tc_rows = [r for r in rows if r["kernel"] == "tc"]
    print(f"[attn] tc rows ({len(tc_rows)}): max |err| "
          f"{max(r['max_abs_err'] for r in tc_rows)} (rtol = atol "
          f"{FA.TOLERANCE[torch.bfloat16]}), max per-row relative error "
          f"{max(r['max_row_rel_err'] for r in tc_rows)} (bound "
          f"{FA.ROW_RTOL[torch.bfloat16]})")
    f32_rows = [r for r in rows if r["kernel"] == "tc_f32"]
    print(f"[attn] tc_f32 rows ({len(f32_rows)}): max |err| "
          f"{max(r['max_abs_err'] for r in f32_rows)} (rtol = atol "
          f"{FA.TOLERANCE[torch.float32]}), launches "
          f"{launches['flash_attention_tc_f32']}")
    for case in dict.fromkeys(r["case"] for r in tc_rows + f32_rows):
        cr = [r for r in tc_rows + f32_rows if r["case"] == case]
        print(f"[attn] {cr[0]['kernel']} {case} (D {cr[0]['d']}, blocks "
              f"{cr[0]['blocks']}): ms {[r['ms'] for r in cr]} against the "
              f"CUDA-core kernel's {[r['cuda_core_ms'] for r in cr]} (max "
              f"|err| {cr[0]['cuda_core_max_abs_err']}), bound "
              f"{cr[0]['bound_ms']} ms ({cr[0]['peak']}), SDPA "
              f"{cr[0]['library_ms']} ms")
    print(f"[attn] launches of the counted entry-point runs: {launches}")
    return rows, launches


#: attn_dims: head dims around the instantiations of the D 62 and D 250
#: rows, by the piece their rows are copied in -- bf16 D 256 (16 bytes,
#: the exact-width instantiation), 248 (16, ragged), 252 (8), 250 (4),
#: 249 (2); f32 D 64 (16, exact), 60 (16, ragged), 62 (8), 63 (4) -- at
#: the shapes of the gemma3-12b and quickstart causal rows
DIM_SWEEP = [("gemma3-12b causal", 1, 16, 8, torch.bfloat16,
              (256, 248, 252, 250, 249)),
             ("quickstart causal", 4, 12, 12, torch.float32,
              (64, 60, 62, 63))]


def attn_dims(FA, dev, s=4096, block=128):
    """The cost of narrow copy pieces: flash_attention (closed_form,
    causal) over the head dims of DIM_SWEEP, each held to its plain
    version and timed (CUDA-event medians) beside its bound."""
    out = []
    for name, b, h, hkv, dtype, dims in DIM_SWEEP:
        for d in dims:
            torch.cuda.empty_cache()
            q, k, v = attn_inputs([(b, h, s, d), (b, hkv, s, d),
                                   (b, hkv, s, d)], dtype, 810 + d, dev)
            sched = FA.flash_schedule(q.shape, k.shape, kind="causal",
                                      block_q=block, block_k=block)
            route = FA.flash_route(sched, dtype)
            err = FA._compare(FA.flash_cuda(q, k, v, sched),
                              FA.flash_attention_plain(q, k, v, sched),
                              f"attn dims {name} D {d}")
            nops = 4 * d * b * h * needed_pairs("causal", s, 0)
            nbytes = (2 * q.numel() + k.numel() + v.numel()) \
                * q.element_size()
            row = {"case": name, "d": d, "dtype": str(dtype),
                   "kernel": route, "row_bytes": d * q.element_size(),
                   "max_abs_err": err,
                   "ms": time_ms(lambda: FA.flash_cuda(q, k, v, sched), 5),
                   "bound_ms": attn_bound(nbytes, nops, dtype, route)[0]}
            print(f"[attn] dims {json.dumps(row)}")
            out.append(row)
            del q, k, v
    return out


#: the views clone_timings copies: (name, q shape, k/v shape, dtype) of
#: the quickstart and gemma3-12b rows of ATTN_TIMED
CLONE_SHAPES = [("quickstart", (4, 12, 4096, 64), (4, 12, 4096, 64),
                 torch.float32),
                ("gemma3-12b", (1, 16, 4096, 256), (1, 8, 4096, 256),
                 torch.bfloat16)]


def clone_timings(FA, dev):
    """What flash_cuda's copy of a misaligned view costs: q, k and v
    views that start one element past a 16-byte boundary, each cloned to
    an aligned buffer as flash_cuda does before a tile path (CUDA-event
    medians of the three clones), beside the bytes bound of the copies
    (each value read and written once), the tile kernel's time on the
    aligned tensors and the whole call on the views."""
    out = []
    for name, qs, ks, dtype in CLONE_SHAPES:
        views = []
        for shape in (qs, ks, ks):
            n = int(np.prod(shape))
            base = attn_inputs([(n + 1,)], dtype, 900, dev)[0]
            views.append(base[1:].view(shape))
        check(not FA._aligned(*views), "the views are off a boundary")
        nbytes = sum(2 * t.numel() * t.element_size() for t in views)
        sched = FA.flash_schedule(qs, ks, kind="causal", block_q=128,
                                  block_k=128)
        aligned = [t.clone() for t in views]
        row = {"case": name, "q": qs, "kv": ks, "dtype": str(dtype),
               "clone_ms": time_ms(lambda: [t.clone() for t in views], 10),
               "clone_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "kernel_ms": time_ms(lambda: FA.flash_cuda(*aligned, sched),
                                    5),
               "misaligned_call_ms": time_ms(
                   lambda: FA.flash_cuda(*views, sched), 5)}
        print(f"[attn] clone {json.dumps(row)}")
        out.append(row)
        del views, aligned
    return out


def check_healthy(srv, what):
    """An un-injected run must not have stepped down: ladder level 0,
    state healthy, no degrade event, and only ``ok`` guard events."""
    from repro_torch.runtime.guard import GuardEvent, ServerState
    kinds = sorted({e.kind for e in srv.events if isinstance(e, GuardEvent)})
    degrades = [e for e in srv.events
                if isinstance(e, dict) and e.get("kind") == "degrade"]
    check(srv.ladder.level == 0 and srv.state == ServerState.HEALTHY
          and not degrades and kinds in ([], ["ok"]),
          f"{what}: an un-injected run left ladder level "
          f"{srv.ladder.level}, state {srv.state.value}, guard events "
          f"{kinds}, {len(degrades)} step(s) down")


#: calls of the guard timed on one step's output
GUARD_REPS = 200


def guard_cost(out, reps=GUARD_REPS):
    """The guard's own work on one step's output (already on the card,
    the device idle), host-clock medians over ``reps`` calls after one
    warm-up: ``guard_call_ms`` a GuardedCall around a function returning
    ``out`` (the stream sync, the NaN screen, the event log), the work
    the guard adds to a decode step; ``guard_screen_ms`` the sync and
    screen alone (the measure of earlier runs)."""
    from repro_torch.runtime.guard import (GuardedCall, synchronize,
                                           validate_finite)
    guard = GuardedCall(lambda: out, "cost", validators=[validate_finite])

    def screen():
        synchronize(out)
        validate_finite(out, "screen")

    res = {}
    for key, fn in (("guard_call_ms", guard), ("guard_screen_ms", screen)):
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        res[key] = statistics.median(times[1:])
    return res


def serve_run(S, cfg, model, prompts, max_new, max_len, kernel,
              guard=True):
    """One Server.generate (guarded unless ``guard=False``); returns
    (tokens, step logits (B, T, V) f32, seconds, ms per decode step).
    The step time is the host clock between the logits of consecutive
    steps (each step ends in a device-to-host copy of its tokens).  The
    run must end at ladder level 0 with only ``ok`` guard events."""
    steps, stamps = [], []

    def on_step(pos, lg):
        stamps.append(time.perf_counter())
        steps.append(lg[:, 0].float())

    srv = S.Server(cfg.replace(attn_decode_kernel=kernel), model,
                   S.ServeConfig(max_len=max_len, guard=guard))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = srv.generate(prompts, max_new, on_step=on_step)
    torch.cuda.synchronize()
    check_healthy(srv, f"serve {kernel} (guard={guard})")
    step_ms = 1e3 * (stamps[-1] - stamps[0]) / max(1, len(stamps) - 1)
    return toks, torch.stack(steps, 1), time.perf_counter() - t0, step_ms


def margin(logits):
    top = torch.topk(logits, 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def compare_streams(ta, la, tb, lb, tol, what, routes=None):
    """Streams a and b with their step logits (B, T, V): the logits of
    every step up to a row's first differing token are compared within
    ``tol``, and a token may differ only where b's top-2 margin is at
    most ``tol``.  With ``routes`` (each run's MoE routing per step, see
    :func:`recording_routes`), a row is compared only up to the step
    before its first step whose experts differ between the runs, and
    they may differ only where b's router margin there is at most
    ROUTE_TOL.  Returns (max |logit diff|, steps compared, steps with a
    margin of at most tol, rows that diverged by token, rows that
    diverged by route)."""
    diff, ncmp, small, diverged, flipped = 0.0, 0, 0, 0, 0
    mb = margin(lb)
    for r in range(ta.shape[0]):
        neq = (ta[r] != tb[r]).nonzero()[0]
        last = int(neq[0]) if len(neq) else ta.shape[1] - 1
        flip = route_flip(routes, r, last) if routes else None
        if flip is not None:
            step, m = flip
            check(m <= ROUTE_TOL, f"{what} row {r}: experts differ at step "
                  f"{step} where the router margin is {m} > {ROUTE_TOL}")
            flipped += 1
            last = step - 1
        d = float((la[r, :last + 1] - lb[r, :last + 1]).abs().max())
        check(d <= tol, f"{what} row {r}: step logits differ by {d} > {tol}")
        diff = max(diff, d)
        ncmp += last + 1
        small += int((mb[r, :last + 1] <= tol).sum())
        if len(neq) and flip is None:
            m = float(mb[r, last])
            check(m <= tol, f"{what} row {r}: tokens differ at step "
                  f"{last} where the top-2 margin is {m} > {tol}")
            diverged += 1
    return diff, ncmp, small, diverged, flipped


#: a decode step's MoE routing may differ between two runs only where the
#: router's top-k boundary is this close (in router logits, which start
#: ~N(0, 1)): the runs' router inputs differ by the bf16 rounding of
#: their attention outputs (~1e-2 of a router logit), so a near-tie
#: between the k-th and (k+1)-th expert can flip, and with top-1 routing
#: (llama4-maverick) a flip swaps the token's whole routed expert
ROUTE_TOL = 0.05


@contextlib.contextmanager
def recording_routes(moe_lib):
    """Record every MoE routing while in the block: a list, one entry per
    ``moe_lib.route`` call in order, of (expert indices (N, k), the
    router margin (N,): the log-probability gap between the k-th and
    (k+1)-th expert), on the host."""
    real, calls = moe_lib.route, []

    def route(m, xf, cfg):
        probs, gates, idx = real(m, xf, cfg)
        top = torch.topk(probs, cfg.top_k + 1, dim=-1).values.log()
        calls.append((idx.cpu(), (top[:, -2] - top[:, -1]).cpu()))
        return probs, gates, idx
    moe_lib.route = route
    try:
        yield calls
    finally:
        moe_lib.route = real


def step_routes(calls, n, b, step, r):
    """Row ``r``'s routing at ``step`` of a Server run of batch ``b``
    through ``n`` MoE layers (``calls`` from :func:`recording_routes`):
    its prefill routes every prompt token (step 0 is the row's last),
    each decode step one token a row, layer by layer.  Returns [(expert
    indices (k,), router margin)] per layer."""
    out = []
    for layer in range(n):
        idx, mrg = calls[step * n + layer]
        row = (r + 1) * (idx.shape[0] // b) - 1
        out.append((idx[row], float(mrg[row])))
    return out


def route_flip(routes, r, last):
    """(step, b's router margin) of the first step <= ``last`` at which
    row ``r``'s experts differ between runs a and b, or None.  ``routes``:
    (calls of a, calls of b, MoE layers, batch)."""
    ra, rb, n, b = routes
    for step in range(last + 1):
        for (ia, _), (ib, mb) in zip(step_routes(ra, n, b, step, r),
                                     step_routes(rb, n, b, step, r)):
            if not torch.equal(ia, ib):
                return step, mb
    return None


def phase_serve(S, TM, get_config, FA, dev):
    """Server greedy at full width through the block-space decode kernel
    (counted) and through the plain decode; logits and streams
    compared."""
    runs, models = [], {}
    for arch, cut, batch, plen, max_new, max_len in SERVE_RUNS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 2 ** 30
        cfg = get_config(arch).replace(**cut)
        t0 = time.perf_counter()
        model = TM.init(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        dev)
        torch.cuda.synchronize()
        nparams = sum(p.numel() for p in model.parameters())
        print(f"[serve] {arch}: {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
              f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
              f"{cfg.dtype} compute; {nparams} {cfg.param_dtype} "
              f"parameters ({nparams * 4 / 1e9:.1f} GB) from a seeded "
              f"generator in {time.perf_counter() - t0:.1f} s")
        prompts = torch.randint(
            0, cfg.vocab_size, (batch, plen),
            generator=torch.Generator().manual_seed(SEED)).numpy()
        FA.reset_launch_counts()
        tk, lk, secs, step_ms = serve_run(S, cfg, model, prompts, max_new,
                                          max_len, "blockspace")
        launches = FA.launch_counts()
        print(f"[serve] {arch} blockspace: launches {launches}")
        check(launches["flash_attention_decode"]
              == cfg.n_layers * (max_new - 1),
              f"{arch}: {launches['flash_attention_decode']} decode "
              f"launches, expected layers x decode steps = "
              f"{cfg.n_layers * (max_new - 1)}")
        check(sum(launches.values())
              == launches["flash_attention_decode"],
              f"the contiguous server launched another attention kernel: "
              f"{launches}")
        mma_run = None
        if arch == "quickstart":
            # the decode kernel under the mma lowering: counted on its own,
            # its streams and step logits equal to the closed_form run's
            FA.reset_launch_counts()
            tm_, lm_, msecs, mstep_ms = serve_run(
                S, cfg.replace(grid_lowering="mma"), model, prompts,
                max_new, max_len, "blockspace")
            mcounts = FA.launch_counts()
            check(mcounts == launches, f"{arch} mma: launches {mcounts} "
                  f"!= the closed_form run's {launches}")
            check(np.array_equal(tm_, tk) and torch.equal(lm_, lk),
                  f"{arch}: the mma run's streams or step logits differ "
                  f"from the closed_form run's")
            mma_run = {"launches": mcounts, "seconds": msecs,
                       "ms_per_decode_step": mstep_ms,
                       "streams_equal_closed_form": True}
            print(f"[serve] {arch} blockspace, grid_lowering=mma: launches "
                  f"{mcounts}, streams and step logits bit-equal to the "
                  f"closed_form run")
        tx, lx, xsecs, xstep_ms = serve_run(S, cfg, model, prompts, max_new,
                                            max_len, "xla")
        check(FA.launch_counts() == launches,
              "the plain decode path launched an attention kernel")
        # timing in turns (kernel, plain, plain, kernel): the first run
        # also pays the process's first-use costs
        xsecs2, xstep_ms2 = serve_run(S, cfg, model, prompts, max_new,
                                      max_len, "xla")[2:]
        secs2, step_ms2 = serve_run(S, cfg, model, prompts, max_new,
                                    max_len, "blockspace")[2:]
        # the guard's cost: an unguarded (no stream sync, no NaN screen a
        # call) kernel run beside the guarded one just before it, and the
        # guard's own work on one step's output, timed alone
        ums = serve_run(S, cfg, model, prompts, max_new, max_len,
                        "blockspace", guard=False)[3]
        logits, cache = TM.prefill(model, torch.as_tensor(prompts,
                                                          device=dev),
                                   max_len=max_len, cfg=cfg)
        cost = guard_cost((logits, cache))
        print(f"[serve] {arch} blockspace: guarded {step_ms2:.3f} ms per "
              f"decode step, unguarded {ums:.3f}; the guard's work on one "
              f"step's output {cost['guard_call_ms']:.4f} ms (sync and "
              f"screen {cost['guard_screen_ms']:.4f}; medians of "
              f"{GUARD_REPS}) ({CARD})")
        check(tk.shape == (batch, max_new) and bool(torch.isfinite(lk).all()),
              f"{arch}: bad stream shape {tk.shape} or non-finite logits")
        tol = SERVE_TOL[cfg.dtype]
        diff, ncmp, small, diverged, _ = compare_streams(
            tk, lk, tx, lx, tol, f"serve {arch}")
        run = {"arch": arch, "layers": cfg.n_layers, "batch": batch,
               "prompt": plen, "max_new": max_new, "max_len": max_len,
               "dtype": cfg.dtype, "launches": launches,
               "seconds": [secs, secs2], "xla_seconds": [xsecs, xsecs2],
               "ms_per_decode_step": [step_ms, step_ms2],
               "guarded_ms_per_decode_step": step_ms2,
               "unguarded_ms_per_decode_step": ums, **cost,
               "card": CARD,
               "xla_ms_per_decode_step": [xstep_ms, xstep_ms2],
               "tok_per_s": tk.size / secs2,
               "xla_tok_per_s": tx.size / xsecs2,
               "tol": tol, "max_logit_diff": diff,
               "steps_compared": ncmp, "steps_margin_le_tol": small,
               "rows_diverged": diverged,
               "streams_equal": bool((tk == tx).all()),
               "mma": mma_run,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "resident_gib": resident}
        runs.append(run)
        print(f"[serve] {json.dumps(run)}")
        if arch == "quickstart":
            models[arch] = (cfg, model, prompts)
        else:
            del model
    return runs, models


def paged_requests(vocab):
    """The JAX package's serve.py mixed-length requests: prompt lengths
    in [4, PAGED_PROMPT] from seed 0."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (int(rng.integers(4, PAGED_PROMPT + 1)),))
            for _ in range(PAGED_REQUESTS)]


def phase_paged(S, FA, cfg, model, dev):
    """PagedServer on quickstart at full width: 16 mixed requests
    through 8 slots, a pool small enough to preempt; streams against the
    single-request Server oracle and the paged plain-decode run."""
    reqs = paged_requests(cfg.vocab_size)
    max_len = PAGED_PROMPT + PAGED_NEW
    scfg = S.PagedServeConfig(max_len=max_len, num_slots=PAGED_SLOTS,
                              page_size=PAGED_PS, num_pages=PAGED_PAGES,
                              validate=True)
    bcfg = cfg.replace(attn_decode_kernel="blockspace")
    FA.reset_launch_counts()
    srv = S.PagedServer(bcfg, model, scfg)
    rep = S.paged_throughput_report(srv, reqs, max_new=PAGED_NEW)
    launches = FA.launch_counts()
    print(f"[paged] launches {launches}")
    check(launches["paged_flash_attention"]
          == cfg.n_layers * rep["decode_steps"],
          f"{launches['paged_flash_attention']} paged launches, expected "
          f"layers x paged steps = {cfg.n_layers * rep['decode_steps']}")
    check(sum(launches.values()) == launches["paged_flash_attention"],
          f"the paged server launched another attention kernel: "
          f"{launches}")
    check(rep["preemptions"] >= 1, "the pool was not small enough to "
          "preempt")
    check(srv.alloc.free_pages == PAGED_PAGES - 1, "pages leaked")
    check_healthy(srv, "paged blockspace")
    out = srv.done
    # the paged plain-decode run, then both again for the timing in turns
    # (kernel, plain, plain, kernel)
    xcfg = cfg.replace(attn_decode_kernel="xla")
    xsrv = S.PagedServer(xcfg, model, scfg)
    xrep = [S.paged_throughput_report(xsrv, reqs, max_new=PAGED_NEW)]
    xla = xsrv.done
    xrep.append(S.paged_throughput_report(S.PagedServer(xcfg, model, scfg),
                                          reqs, max_new=PAGED_NEW))
    again_srv = S.PagedServer(bcfg, model, scfg)
    again = S.paged_throughput_report(again_srv, reqs, max_new=PAGED_NEW)
    check_healthy(again_srv, "paged blockspace, second run")
    check_healthy(xsrv, "paged xla")
    # the guard's cost: an unguarded run beside the guarded second kernel
    # run above, and the guard's own work on one step's output alone
    bare_srv = S.PagedServer(bcfg, model, dataclasses.replace(scfg,
                                                              guard=False))
    ums = S.paged_throughput_report(
        bare_srv, reqs, max_new=PAGED_NEW)["ms_per_decode_step"]
    check(all(np.array_equal(bare_srv.done[r], out[r]) for r in out),
          "the unguarded paged run differs from the first")
    gms = again["ms_per_decode_step"]
    cost = guard_cost((torch.zeros(PAGED_SLOTS, 1, cfg.padded_vocab,
                                   device=dev), again_srv.pools))
    print(f"[paged] guarded {gms:.3f} ms per decode step, unguarded "
          f"{ums:.3f}; the guard's work on one step's output "
          f"{cost['guard_call_ms']:.4f} ms (sync and screen "
          f"{cost['guard_screen_ms']:.4f}; medians of {GUARD_REPS}) "
          f"({CARD})")
    oracle = S.Server(cfg.replace(attn_decode_kernel="xla"), model,
                      S.ServeConfig(max_len=max_len))
    tol = SERVE_TOL[cfg.dtype]
    small = diverged = 0
    for rid, prompt in enumerate(reqs):
        steps = []
        want = oracle.generate(prompt[None], PAGED_NEW, on_step=lambda p, lg:
                               steps.append(lg[0, 0].float()))[0]
        mo = margin(torch.stack(steps))
        small += int((mo <= tol).sum())
        for name, got in (("paged blockspace", out[rid]),
                          ("paged xla", xla[rid])):
            neq = (got != want).nonzero()[0]
            if len(neq):
                m = float(mo[int(neq[0])])
                check(m <= tol, f"{name} request {rid} differs from the "
                      f"single-request oracle at step {int(neq[0])} where "
                      f"the margin is {m} > {tol}")
                diverged += 1
    rep.update({"launches": launches, "oracle_steps_margin_le_tol": small,
                "streams_diverged": diverged,
                "streams_equal_oracle": diverged == 0,
                "second_run": {k: again[k] for k in TIMING_KEYS},
                "guarded_ms_per_decode_step": gms,
                "unguarded_ms_per_decode_step": ums, **cost,
                "card": CARD,
                "xla_runs": [{k: r[k] for k in TIMING_KEYS} for r in xrep]})
    print(f"[paged] {json.dumps(rep)}")
    print(f"[paged] {PAGED_REQUESTS} requests: streams equal the "
          f"single-request oracle and the paged plain-decode run "
          f"({diverged} divergences, all at top-2 margins <= {tol}); "
          f"page table verified at every step")
    return rep


#: the [chaos] phase at quickstart full width: the decode indices of the
#: injected host faults, the decode step after which rung-0 faults force
#: the ladder down (Server and PagedServer), the SIGTERM's decode index,
#: and the canary period
CHAOS_TRANSIENT = (("transient_error", "serve.prefill", 0, ""),
                   ("transient_error", "serve.decode", 3, "jax"),
                   ("poison_result", "serve.decode", 7, ""),
                   ("transient_error", "serve.decode", 12, ""),
                   ("poison_result", "serve.decode", 20, ""))
CHAOS_LADDER_AT, CHAOS_PAGED_LADDER_AT = 8, 10
CHAOS_SIGTERM_AT, CHAOS_CANARY_EVERY = 10, 4


def phase_chaos(S, RC, TW, FA, cfg, model, prompts, dev):
    """The guarded runtime on the card: the chaos matrix (its kernel
    faults on the write kernel's launches), then at quickstart full width
    recovered transient and poisoned steps, the ladder forced down by
    rung-0 faults (Server and PagedServer), a SIGTERM drained and resumed
    by a second Server, and the substrate canary every few steps."""
    t0 = time.perf_counter()
    res = {}
    # the matrix (`python -m repro_torch.runtime.chaos --matrix --device
    # cuda`): poison_tile and corrupt_table hit the write kernel's launches
    TW.reset_launch_counts()
    out_path = OUT.parent / "chaos_matrix.json"
    OUT.parent.mkdir(parents=True, exist_ok=True)
    rc = RC.main(["--matrix", "--device", "cuda", "--quiet", "--out",
                  str(out_path)])
    matrix = json.loads(out_path.read_text())
    writes = TW.launch_counts()["sierpinski_write"]
    status = {r["fault"]: r["status"] for r in matrix["results"]}
    print(f"[chaos] matrix: {status}; write kernel launches {writes}")
    check(rc == 0 and matrix["ok"], f"chaos matrix failed: {status}")
    check(all(v in ("recovered", "reported") for v in status.values()),
          f"chaos matrix: {status}")
    # each kernel scenario: the clean write, the faulted launch, the retry
    kernel_launches = sum(r["launches"] for r in matrix["results"]
                          if r["fault"] in RC.PALLAS_FAULTS)
    check(kernel_launches == 4 and writes == kernel_launches + 2,
          f"the write kernel launched {writes} times in the matrix, the "
          f"hook saw {kernel_launches}: expected 4 faulted/retried + 2 "
          f"clean")
    res["matrix"] = {"statuses": {r["fault"]: r["status"]
                                  for r in matrix["results"]},
                     "write_launches": writes,
                     "seconds": matrix["seconds"]}

    layers, max_new = cfg.n_layers, SERVE_RUNS[0][4]
    max_len = SERVE_RUNS[0][5]
    bcfg = cfg.replace(attn_decode_kernel="blockspace")
    scfg = S.ServeConfig(max_len=max_len, retries=2, backoff_base_s=0.0)
    ref = S.Server(bcfg, model, scfg).generate(prompts, max_new)
    xla = S.Server(cfg.replace(attn_decode_kernel="xla"), model,
                   scfg).generate(prompts, max_new)

    # transient errors and poisoned results, recovered bit-identically
    plan = RC.FaultPlan(0, [RC.FaultSpec(k, site, i, mode=m)
                            for k, site, i, m in CHAOS_TRANSIENT])
    chaos = RC.ChaosInjector(plan)
    FA.reset_launch_counts()
    srv = S.Server(bcfg, model, scfg, chaos=chaos)
    out = srv.generate(prompts, max_new)
    n_poison = sum(k == "poison_result" for k, *_ in CHAOS_TRANSIENT)
    decode = FA.launch_counts()["flash_attention_decode"]
    check(np.array_equal(out, ref), "transient/poisoned run: the stream "
          "differs from the fault-free run")
    check(len(chaos.events) == len(CHAOS_TRANSIENT)
          and srv.ladder.level == 0,
          f"transient run: {len(chaos.events)} faults fired, ladder level "
          f"{srv.ladder.level}")
    # a poisoned step ran (and launched) before its retry
    check(decode == layers * (max_new - 1 + n_poison),
          f"transient run: {decode} decode launches, expected "
          f"{layers * (max_new - 1 + n_poison)}")
    res["transient"] = {"status": "recovered", "faults": len(chaos.events),
                        "recoveries": srv._decode.recoveries
                        + srv._prefill.recoveries,
                        "decode_launches": decode}

    # the ladder: every rung-0 attempt of one decode step faults, the
    # guard exhausts, the server steps down to the plain decode
    at = CHAOS_LADDER_AT
    plan = RC.FaultPlan(0, [RC.FaultSpec("transient_error", "serve.decode",
                                         at + i, rung=0)
                            for i in range(scfg.retries + 1)])
    FA.reset_launch_counts()
    srv = S.Server(bcfg, model, scfg, chaos=RC.ChaosInjector(plan))
    out = srv.generate(prompts, max_new)
    decode = FA.launch_counts()["flash_attention_decode"]
    check(srv.ladder.level == 1 and srv.state.value == "degraded"
          and srv.ladder.transitions[0]["to"]["decode_kernel"] == "xla",
          f"ladder: level {srv.ladder.level}, state {srv.state.value}")
    check(decode == layers * at, f"ladder: {decode} decode launches, "
          f"expected layers x steps before the transition = {layers * at}")
    check(np.array_equal(out, xla), "ladder: the stream differs from the "
          "plain-decode run")
    res["ladder"] = {"status": "recovered", "level": srv.ladder.level,
                     "decode_launches": decode, "steps_before": at}

    # SIGTERM mid-decode: drain into a decode checkpoint, resume in a
    # second Server
    with tempfile.TemporaryDirectory() as d:
        ck = dataclasses.replace(scfg, ckpt_dir=d, ckpt_every=1)
        plan = RC.FaultPlan(0, [RC.FaultSpec("sigterm", "serve.decode",
                                             CHAOS_SIGTERM_AT)])
        srv = S.Server(bcfg, model, ck, chaos=RC.ChaosInjector(plan))
        partial = srv.generate(prompts, max_new)
        drained = srv.state.value == "draining"
        out = S.Server(bcfg, model, ck).resume()
    check(drained and partial.shape[1] < max_new,
          f"sigterm: state {srv.state.value}, {partial.shape[1]} tokens")
    check(np.array_equal(out, ref), "sigterm: the resumed stream differs "
          "from the uninterrupted run")
    res["sigterm"] = {"status": "recovered", "drained_at": partial.shape[1]}

    # the substrate canary every few decode steps: one write launch each
    TW.reset_launch_counts()
    srv = S.Server(bcfg, model, dataclasses.replace(
        scfg, spot_check_every=CHAOS_CANARY_EVERY))
    out = srv.generate(prompts, max_new)
    canaries = TW.launch_counts()["sierpinski_write"]
    check(canaries == (max_new - 1) // CHAOS_CANARY_EVERY
          and np.array_equal(out, ref),
          f"canary: {canaries} write launches, expected "
          f"{(max_new - 1) // CHAOS_CANARY_EVERY}")
    check_healthy(srv, "canary run")
    res["canary"] = {"status": "recovered", "write_launches": canaries}

    # PagedServer: paged-blockspace -> paged-xla
    reqs = paged_requests(cfg.vocab_size)
    pcfg = S.PagedServeConfig(max_len=PAGED_PROMPT + PAGED_NEW,
                              num_slots=PAGED_SLOTS, page_size=PAGED_PS,
                              num_pages=PAGED_PAGES, retries=1,
                              backoff_base_s=0.0)
    want = S.PagedServer(cfg.replace(attn_decode_kernel="xla"), model,
                         pcfg).run(reqs, max_new=PAGED_NEW)
    at = CHAOS_PAGED_LADDER_AT
    plan = RC.FaultPlan(0, [RC.FaultSpec("transient_error", "serve.decode",
                                         at + i, rung=0)
                            for i in range(pcfg.retries + 1)])
    FA.reset_launch_counts()
    psrv = S.PagedServer(bcfg, model, pcfg, chaos=RC.ChaosInjector(plan))
    got = psrv.run(reqs, max_new=PAGED_NEW)
    paged = FA.launch_counts()["paged_flash_attention"]
    check(psrv.ladder.level == 1 and psrv.state.value == "degraded",
          f"paged ladder: level {psrv.ladder.level}")
    check(paged == layers * at, f"paged ladder: {paged} paged launches, "
          f"expected {layers * at}")
    check(all(np.array_equal(got[r], want[r]) for r in want),
          "paged ladder: streams differ from the paged plain-decode run")
    res["paged_ladder"] = {"status": "recovered", "paged_launches": paged,
                           "steps_before": at}
    res["seconds"] = time.perf_counter() - t0
    res["card"] = CARD
    print(f"[chaos] {json.dumps(res)}")
    return res


def decode_bound(q, hkv, keys):
    """(ms, bound_by) of a decode: q read, o written, and the K and V rows
    of ``keys`` positions summed over the slots read once per kv head; 4 d
    flops per (q head, key)."""
    b, h, _, d = q.shape
    nbytes = (2 * q.numel() + 2 * hkv * keys * d) * q.element_size()
    return attn_bound(nbytes, 4 * d * h * keys, q.dtype)[:2]


def gemma_decode_check(FA, P, dev):
    """Both decode kernels at the decode shape of the gemma3-12b Server
    (B 4, 16/8 heads of 256, bf16, cache 1664, per-row positions past
    1536) under its local layers' window of 1024 and its global layers'
    full range (:func:`decode_shape_check`)."""
    arch, cut, b, plen, max_new, max_len = SERVE_RUNS[1]
    return decode_shape_check(
        FA, P, dev, arch, b, 16, 8, 256, max_len,
        [plen, plen + 3, plen + 7, plen + max_new - 1], (1024, 0), 902)


def decode_shape_check(FA, P, dev, arch, b, h, hkv, d, max_len, positions,
                       windows, seed, TA=None):
    """Both decode kernels at one model's decode shape (bf16): the
    contiguous caches at block_k 128 and the same caches copied into
    16-token pages, each held to its plain version (and, given the
    model's attention module ``TA``, to its plain ``decode_attention``:
    within the bf16 tolerance and ROW_RTOL) under each of ``windows``
    (0: the full range), the paged kernel bit-equal to the contiguous one
    at block_k 16; then both timed over the full range beside their plain
    versions, their byte bounds and scaled_dot_product_attention
    (enable_gqa, on the caches cut to the longest row, a boolean mask per
    row).  Returns {"flash_attention": row, "paged_flash_attention":
    row}."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ps = PAGED_PS
    q, k, v = attn_inputs([(b, h, 1, d), (b, hkv, max_len, d),
                           (b, hkv, max_len, d)], torch.bfloat16, seed, dev)
    pv = torch.tensor(positions, dtype=torch.int32, device=dev)
    pool, table = paged_copy(k, v, ps, P, dev, seed)
    err = {"flash_attention": 0.0, "paged_flash_attention": 0.0}
    for window in windows:
        sched = FA.flash_schedule(q.shape, k.shape, kind="full",
                                  window=window, block_q=1, block_k=128,
                                  has_pos=True)
        e, got = FA.check_flash_against_plain(q, k, v, sched, pv)
        err["flash_attention"] = max(err["flash_attention"], e)
        psched = FA.paged_schedule(q.shape, pool.shape, table.shape,
                                   window=window)
        e, paged = FA.check_paged_against_plain(q, pool, table, pv, psched)
        err["paged_flash_attention"] = max(err["paged_flash_attention"], e)
        if TA is not None:
            want = TA.decode_attention(
                q, k, v, pv, kind="local" if window else "causal",
                window=window)
            for name, out in (("flash_attention", got),
                              ("paged_flash_attention", paged)):
                err[name] = max(err[name], FA._compare(
                    out, want, f"{arch} {name} vs decode_attention, "
                    f"window {window}"))
        s16 = FA.flash_schedule(q.shape, k.shape, kind="full", window=window,
                                block_q=1, block_k=ps, has_pos=True)
        check(torch.equal(paged, FA.flash_cuda(q, k, v, s16, pv)),
              f"{arch} decode shape, window {window}: paged not bit-equal "
              f"to the contiguous kernel at block_k {ps}")
    sched = FA.flash_schedule(q.shape, k.shape, kind="full", block_q=1,
                              block_k=128, has_pos=True)
    psched = FA.paged_schedule(q.shape, pool.shape, table.shape)
    keys = int((pv.long() + 1).sum())
    span = int(pv.max()) + 1
    kc, vc = k[:, :, :span].contiguous(), v[:, :, :span].contiguous()
    mask = (torch.arange(span, device=dev)[None, :]
            <= pv[:, None].long())[:, None, None, :]
    lib_ms = time_ms(lambda: sdpa(q, kc, vc, attn_mask=mask,
                                  enable_gqa=True), 50)
    lib_kernels = sdpa_kernels(lambda: sdpa(q, kc, vc, attn_mask=mask,
                                            enable_gqa=True))
    lib_dev_ms = device_ms(lambda: sdpa(q, kc, vc, attn_mask=mask,
                                        enable_gqa=True))
    bound_ms, bound_by = decode_bound(q, hkv, keys)
    at = (f"{arch} decode: B={b} H={h}/{hkv} D={d} bf16, cache {max_len}, "
          f"positions {pv.tolist()} ({keys} K and V rows per kv head over "
          f"the {b} slots)")
    out = {}
    for name, run, plain, how in (
            ("flash_attention",
             lambda: FA.flash_cuda(q, k, v, sched, pv),
             lambda: FA.flash_attention_plain(q, k, v, sched, pv),
             "block_k 128"),
            ("paged_flash_attention",
             lambda: FA.paged_cuda(q, pool, table, pv, psched),
             lambda: FA.paged_attention_plain(q, pool, table, pv, psched),
             f"pages of {ps}")):
        out[name] = {"ms": time_ms(run, 50), "device_ms": device_ms(run),
                     "plain_ms": time_ms(plain, 5),
                     "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
                     "library_kernels": lib_kernels,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "max_abs_err": err[name], "at": f"{at}, {how}"}
        print(f"[decode] {arch} {name}: {json.dumps(out[name])}")
    print(f"[decode] {arch} decode shape: both kernels within tolerance of "
          f"their plain versions"
          + (" and of decode_attention" if TA is not None else "")
          + f" under window(s) {list(windows)}, paged bit-equal to the "
          f"contiguous kernel at block_k {ps}")
    return out


def decode_timings(FA, P, cfg, dev):
    """Both decode kernels at their serving shapes: the contiguous decode
    of the quickstart Server at position prompt + max_new / 2, the paged
    decode of 8 slots, and the gemma3-12b decode shape
    (:func:`gemma_decode_check`).  Keyed by entry point: flash_attention
    (flash_cuda on a decode call) and paged_flash_attention."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    _, _, b, plen, max_new, max_len = SERVE_RUNS[0]
    pos = plen + max_new // 2
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = attn_inputs([(b, h, 1, d), (b, hkv, max_len, d),
                           (b, hkv, max_len, d)], torch.float32, 900, dev)
    sched = FA.flash_schedule(q.shape, k.shape, kind="full", block_q=1,
                              block_k=128, has_pos=True)
    pv = FA.seq_pos_vector(pos, b, dev)
    err, _ = FA.check_flash_against_plain(q, k, v, sched, pv)
    tiles = pos // 128 + 1
    out = {"flash_attention": {
        "ms": time_ms(lambda: FA.flash_cuda(q, k, v, sched, pv), 50),
        "device_ms": device_ms(lambda: FA.flash_cuda(q, k, v, sched, pv)),
        "plain_ms": time_ms(lambda: FA.flash_attention_plain(q, k, v, sched,
                                                             pv), 10),
        "library_ms": time_ms(lambda: sdpa(q, k[:, :, :pos + 1],
                                           v[:, :, :pos + 1]), 50),
        "library_device_ms": device_ms(lambda: sdpa(
            q, k[:, :, :pos + 1], v[:, :, :pos + 1])),
        "max_abs_err": err,
        "kernel": FA.ROUTE_KERNELS[FA.flash_route(sched, q.dtype)],
        "at": f"quickstart decode: B={b} H={h} D={d} f32, cache {max_len}, "
              f"seq_pos {pos}, block_k 128 ({tiles} tiles read)"}}
    out["flash_attention"]["bound_ms"], out["flash_attention"]["bound_by"] = \
        decode_bound(q, hkv, b * (pos + 1))
    # paged: 8 slots at mixed positions
    ps, slots = PAGED_PS, PAGED_SLOTS
    smax = PAGED_PROMPT + PAGED_NEW
    q, k, v = attn_inputs([(slots, h, 1, d), (slots, hkv, smax, d),
                           (slots, hkv, smax, d)], torch.float32, 901, dev)
    pool, table = paged_copy(k, v, ps, P, dev, 5)
    posv = torch.randint(4, smax, (slots,), generator=torch.Generator(
        ).manual_seed(SEED)).to(dev, torch.int32)
    psched = FA.paged_schedule(q.shape, pool.shape, table.shape)
    err, _ = FA.check_paged_against_plain(q, pool, table, posv, psched)
    mask = (torch.arange(smax, device=dev)[None, :]
            <= posv[:, None].long())[:, None, None, :]
    pages = int((posv.long() // ps + 1).sum())
    out["paged_flash_attention"] = {
        "ms": time_ms(lambda: FA.paged_cuda(q, pool, table, posv, psched),
                      50),
        "device_ms": device_ms(lambda: FA.paged_cuda(q, pool, table, posv,
                                                     psched)),
        "plain_ms": time_ms(lambda: FA.paged_attention_plain(
            q, pool, table, posv, psched), 10),
        "library_ms": time_ms(lambda: sdpa(q, k, v, attn_mask=mask), 50),
        "library_device_ms": device_ms(lambda: sdpa(q, k, v,
                                                    attn_mask=mask)),
        "library_note": "scaled_dot_product_attention on the same K/V "
                        "gathered into contiguous caches (gather not timed)",
        "max_abs_err": err,
        "at": f"quickstart paged decode: {slots} slots H={h} D={d} f32, "
              f"pages of {ps}, positions {posv.tolist()} ({pages} pages "
              f"read)"}
    out["paged_flash_attention"]["bound_ms"], \
        out["paged_flash_attention"]["bound_by"] = decode_bound(
            q, hkv, int((posv.long() + 1).sum()))
    for name, row in out.items():
        print(f"[decode] {name}: {json.dumps(row)}")
    out["gemma3-12b"] = gemma_decode_check(FA, P, dev)
    return out


def isolate_tune_cache():
    """Point REPRO_TORCH_TUNE_CACHE at a fresh file in a temporary
    directory (removed at exit): the entry points' defaults read the tune
    cache, so a file left on the machine would change what the phases
    run."""
    d = tempfile.mkdtemp(prefix="repro-torch-tune-")
    atexit.register(shutil.rmtree, d, True)
    path = os.path.join(d, "tune.json")
    os.environ["REPRO_TORCH_TUNE_CACHE"] = path
    print(f"[tune] cache file {path} (fresh; REPRO_TORCH_TUNE_CACHE)")
    return path


def tune_search(name, search, n_candidates):
    """Run one search; print its [tune] line and its three fastest and
    slowest trials; return its record."""
    t0 = time.perf_counter()
    cfg, us, trials = search()
    secs = time.perf_counter() - t0
    check(us is not None, f"tune {name}: a fresh cache answered")
    check(us == min(t for _, t in trials),
          f"tune {name}: the winner is not the fastest trial")
    ranked = sorted(trials, key=lambda t: t[1])
    rec = {"winner": cfg, "us": us, "trials": len(trials),
           "inviable": n_candidates - len(trials), "seconds": secs,
           "all_trials": [{"config": c, "us": u} for c, u in trials]}
    print(f"[tune] {name}: winner {json.dumps(cfg)} at {us:.1f} us; "
          f"{len(trials)} trials, {rec['inviable']} inviable; {secs:.1f} s")
    print(f"[tune] {name} trials: fastest "
          f"{json.dumps([[c, round(u, 1)] for c, u in ranked[:3]])}; "
          f"slowest {json.dumps([ranked[-1][0], round(ranked[-1][1], 1)])}")
    return rec


def launched(mod, name, before, what):
    """Check that ``mod``'s kernel ``name`` launched since its counts
    ``before``; returns how often."""
    now = mod.launch_counts()[name]
    check(now > before[name], f"{what}: kernel {name} not launched")
    return now - before[name]


def tune_check_write(tune, TW, lay, cfg, dev):
    """write/sum at every knob "auto" against the winner spelled out, the
    plain versions and, under another key, the untuned defaults."""
    n, rho = N_MAIN, TUNE_RHO
    shape = lay.array_shape(rho) if cfg["storage"] == "compact" \
        else lay.embedded_shape(rho)
    kw = dict(block=rho, storage=cfg["storage"], n=n)
    auto = dict(grid_mode="auto", coarsen="auto", num_stages="auto")
    spelled = dict(grid_mode=cfg["lowering"], coarsen=cfg["coarsen"],
                   num_stages=1)
    a = torch.zeros(shape, dtype=torch.float32, device=dev)
    b = torch.zeros_like(a)
    before = TW.launch_counts()
    TW.sierpinski_write_(a, 1.0, **auto, **kw)
    launched(TW, "sierpinski_write", before, "tune write auto")
    TW.sierpinski_write_(b, 1.0, **spelled, **kw)
    check(torch.equal(a, b), "tune write: auto != the winner spelled out")
    plan, _, _ = TW.prepare_launch(a, grid_mode=cfg["lowering"],
                                   coarsen=cfg["coarsen"], **kw)
    b.zero_()
    TW.sierpinski_write_plain(b, 1.0, plan, n, rho)
    check(torch.equal(a, b), "tune write: auto != the plain version")
    del b
    before = TW.launch_counts()
    total = TW.sierpinski_sum(a, **auto, **kw)
    launched(TW, "sierpinski_sum_partials", before, "tune sum auto")
    check(torch.equal(total, TW.sierpinski_sum(a, **spelled, **kw)),
          "tune sum: auto != the winner spelled out")
    check(torch.equal(total, TW.sierpinski_sum_plain(a, plan, n, rho)),
          "tune sum: auto != the plain version")
    del a
    # another key (n = 2**10) is a miss: the untuned defaults' bits
    small = 1 << 10
    check(TW.resolve_auto_schedule(
        "write", {"fractal": "sierpinski-gasket", "n": small, "block": rho},
        device=dev, grid_mode=("auto", "lowering", "closed_form"),
        coarsen=("auto", "coarsen", 1)) == ("closed_form", 1),
        "tune write: another key answered")
    m = torch.zeros((small, small), dtype=torch.float32, device=dev)
    check(torch.equal(TW.sierpinski_write(m, 1.0, block=rho, **auto),
                      TW.sierpinski_write(m, 1.0, block=rho)),
          "tune write: a miss != the untuned defaults")
    return {"total": float(total)}


def tune_check_ca(tune, TC, lay, cfg, dev):
    """ca_run at every knob "auto" against the winner spelled out (8
    steps), one launch against the plain version, and a miss."""
    n, rho, T = N_MAIN, TUNE_RHO, TUNE_CA_STEPS
    src = tune.fractal_state("sierpinski-gasket", n, rho, dev, seed=SEED)
    if cfg["storage"] == "compact":
        src = lay.pack(src, rho)
        torch.cuda.empty_cache()
    kw = dict(block=rho, storage=cfg["storage"], n=n, rule="parity")
    auto = dict(fuse="auto", grid_mode="auto", coarsen="auto",
                num_stages="auto")
    spelled = dict(fuse=cfg["fuse"], grid_mode=cfg["lowering"],
                   coarsen=cfg["coarsen"], num_stages=cfg["stages"])
    check(TC.auto_schedule(n=n, block=rho, device=dev) ==
          (cfg["lowering"], cfg["fuse"], cfg["coarsen"], cfg["stages"]),
          "tune ca: auto_schedule != the winner")
    fuse = TC.effective_fuse(cfg["fuse"], T, rho, cfg["coarsen"])
    before = TC.launch_counts()
    got = TC.ca_run(src.clone(), torch.zeros_like(src), T, donate=True,
                    **auto, **kw)
    check(launched(TC, "sierpinski_ca_fused", before,
                   "tune ca auto") == len(TC.launch_schedule(T, fuse)),
          "tune ca: auto launched another schedule")
    want = TC.ca_run(src, torch.zeros_like(src), T, donate=True, **spelled,
                     **kw)
    check(torch.equal(got, want), "tune ca: auto != the winner spelled out")
    del src, want
    torch.cuda.empty_cache()
    # one launch of the auto call against the plain version, from the
    # 8-step state (zero outside the fractal, as a state must be)
    before = TC.launch_counts()
    one = TC.ca_run(got.clone(), torch.zeros_like(got), fuse, donate=True,
                    **auto, **kw)
    check(launched(TC, "sierpinski_ca_fused", before,
                   "tune ca auto, one launch") == 1,
          "tune ca: one launch expected")
    plan = TC.check_run(got, one, block=rho, grid_mode=cfg["lowering"],
                        storage=cfg["storage"], n=n,
                        coarsen=cfg["coarsen"])[0]
    t0 = time.perf_counter()
    plain = TC.ca_launch_plain(got, torch.zeros_like(got), plan, n, rho,
                               fuse, fuse, "parity", 0.25)
    plain_s = time.perf_counter() - t0
    check(torch.equal(one, plain), "tune ca: auto != the plain version")
    del got, one, plain
    torch.cuda.empty_cache()
    # another key (n = 2**10) is a miss: the untuned defaults' bits
    small = 1 << 10
    check(TC.auto_schedule(n=small, block=rho, device=dev) ==
          ("closed_form", 1, 1, 1), "tune ca: another key answered")
    x = tune.fractal_state("sierpinski-gasket", small, rho, dev, seed=SEED)
    check(torch.equal(
        TC.ca_run(x, torch.zeros_like(x), T, block=rho, donate=False,
                  **auto),
        TC.ca_run(x, torch.zeros_like(x), T, block=rho, donate=False,
                  fuse=1, num_stages=1)),
        "tune ca: a miss != the untuned defaults")
    return {"plain_launch_s": plain_s}


def tune_check_flash(tune, FA, cfg, h, d, dev):
    """flash_attention at every knob "auto" against the winner spelled
    out and the plain version (within TOLERANCE), and a miss."""
    b, s = TUNE_FLASH["batch"], TUNE_FLASH["sq"]
    q, k, v = attn_inputs([(b, h, s, d)] * 3, torch.float32, 903, dev)
    auto = dict(grid_mode="auto", block_q="auto", block_k="auto",
                num_warps="auto", num_stages="auto")
    before = FA.launch_counts()
    got = FA.flash_attention(q, k, v, kind="causal", **auto)
    launched(FA, "flash_attention_tc_f32", before, "tune flash auto")
    kw = dict(kind="causal", grid_mode=cfg["lowering"],
              block_q=cfg["block_q"], block_k=cfg["block_k"])
    err = FA._compare(got, FA.flash_attention(q, k, v, **kw),
                      "tune flash: auto vs the winner spelled out")
    sched = FA.flash_schedule(q.shape, k.shape, **kw)
    err_plain = FA._compare(got, FA.flash_attention_plain(q, k, v, sched),
                            "tune flash: auto vs the plain version")
    # another key (S 2048) is a miss: the untuned defaults
    q2, k2, v2 = (t[:, :, :s // 2].contiguous() for t in (q, k, v))
    FA._compare(FA.flash_attention(q2, k2, v2, kind="causal", **auto),
                FA.flash_attention(q2, k2, v2, kind="causal"),
                "tune flash: a miss vs the untuned defaults")
    return {"max_abs_err_spelled": err, "max_abs_err_plain": err_plain}


def tune_check_paged(tune, FA, cfg, params, dev):
    """The paged lookup (the page size is the caller's to apply): a pool
    at the winner's page size decoded with the winner's lowering and the
    knobs at "auto", against the plain version and bit-equal to the
    contiguous decode at block_k == page_size; a miss."""
    ps, b, seq = cfg["page_size"], params["batch"], params["seq"]
    h, hkv, d = params["heads"], params["kv_heads"], params["d"]
    check(tune.best("paged", params, device=dev) == cfg,
          "tune paged: the lookup != the winner")
    check(tune.best("paged", {**params, "seq": seq // 2}, device=dev)
          is None, "tune paged: another key answered")
    q, k, v = attn_inputs([(b, h, 1, d), (b, hkv, seq, d),
                           (b, hkv, seq, d)], torch.float32, 904, dev)
    pool, table = tune.paged_operands(k, v, ps)
    pos = torch.arange(seq - b, seq, dtype=torch.int32, device=dev)
    before = FA.launch_counts()
    got = FA.paged_flash_attention(q, pool, table, pos,
                                   grid_mode=cfg["lowering"],
                                   num_warps="auto", num_stages="auto")
    launched(FA, "paged_flash_attention", before, "tune paged")
    sched = FA.paged_schedule(q.shape, pool.shape, table.shape)
    err = FA._compare(got, FA.paged_attention_plain(q, pool, table, pos,
                                                    sched),
                      "tune paged: vs the plain version")
    check(torch.equal(got, FA.flash_attention(
        q, k, v, kind="full", block_q=1, block_k=ps, seq_pos=pos)),
        "tune paged: != the contiguous decode at block_k == page_size")
    return {"max_abs_err_plain": err}


def phase_tune(tune, TW, TC, FA, compact_layout, qcfg, dev):
    """The four searches on the card, then the "auto" paths held against
    their winners (see the module docstring, phase 13)."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    print(f"[tune] {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
          f"allocated before the searches")
    n, rho = N_MAIN, TUNE_RHO
    lay = compact_layout(TW.resolve_fractal_domain("sierpinski-gasket", n,
                                                   rho))
    out = {}
    grid = dict(fractal="sierpinski-gasket", n=n, block=rho, max_coarsen=4)
    out["write"] = tune_search("write", lambda: tune.autotune_write(
        device=dev, **grid), len(list(tune.write_candidates(
            "sierpinski-gasket", n, rho, max_coarsen=4))))
    torch.cuda.empty_cache()
    out["ca"] = tune_search("ca", lambda: tune.autotune_ca(
        rule="parity", steps=TUNE_CA_STEPS, max_fuse=8, device=dev,
        **grid), len(list(tune.ca_candidates(
            "sierpinski-gasket", n, rho, max_fuse=8, max_coarsen=4,
            device=dev))))
    torch.cuda.empty_cache()
    h, d = qcfg.n_heads, qcfg.hd
    fl = dict(TUNE_FLASH, heads=h, d=d)
    out["flash"] = tune_search("flash", lambda: tune.autotune_flash(
        device=dev, **fl), len(list(tune.flash_candidates(
            fl["sq"], fl["sq"], blocks=fl["blocks"]))))
    pg = dict(TUNE_PAGED, heads=h, kv_heads=qcfg.n_kv_heads, d=d)
    out["paged"] = tune_search("paged", lambda: tune.autotune_paged(
        device=dev, **pg), len(list(tune.paged_candidates(
            pg["seq"], page_sizes=pg["page_sizes"]))))
    searches_s = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    out["write"]["check"] = tune_check_write(tune, TW, lay,
                                             out["write"]["winner"], dev)
    out["ca"]["check"] = tune_check_ca(tune, TC, lay, out["ca"]["winner"],
                                       dev)
    out["flash"]["check"] = tune_check_flash(tune, FA,
                                             out["flash"]["winner"], h, d,
                                             dev)
    params = tune._axis_param(
        {"batch": pg["batch"], "heads": h, "kv_heads": pg["kv_heads"],
         "seq": pg["seq"], "d": d, "window": 0},
        "page_sizes", pg["page_sizes"], tune.ALL_PAGE_SIZES)
    out["paged"]["check"] = tune_check_paged(tune, FA,
                                             out["paged"]["winner"], params,
                                             dev)
    out["seconds"] = time.perf_counter() - t_phase
    out["searches_s"], out["checks_s"] = searches_s, \
        time.perf_counter() - t0
    print(f"[tune] \"auto\" = the winner spelled out (write, sum, ca_run "
          f"bit-equal; flash within {FA.TOLERANCE[torch.float32]}), each "
          f"kernel launched, each against its plain version, every other "
          f"key on the untuned defaults; searches {searches_s:.1f} s, "
          f"checks {out['checks_s']:.1f} s, phase {out['seconds']:.1f} s")
    return out


#: keys of chip_smoke.json that hold a time (ms, ms per decode step, a
#: serving run's seconds); throughputs and bounds are not compared
TIME_KEY_SUFFIXES = ("_ms", "seconds", "ms_per_decode_step")
TIME_KEYS = ("ms",)


def vjp_check(TA, dev):
    """The flash VJP at gemma3-12b's head shape on the card, f32, against
    autograd through simple_attention; both timed (forward + backward,
    CUDA-event medians)."""
    sh = VJP_SHAPE
    g = torch.Generator(device=dev).manual_seed(SEED)
    shapes = [(sh["b"], sh["h"], sh["s"], sh["d"]),
              (sh["b"], sh["hkv"], sh["s"], sh["d"]),
              (sh["b"], sh["hkv"], sh["s"], sh["d"]),
              (sh["b"], sh["h"], sh["s"], sh["d"])]
    q, k, v, do = [torch.randn(x, generator=g, device=dev) for x in shapes]
    rows = []
    for kind, window, schedule in VJP_CASES:
        def grads(fn):
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            return torch.autograd.grad(fn(*qkv), qkv, do)

        def flash(q_, k_, v_):
            return TA.flash_attention_xla(q_, k_, v_, kind=kind,
                                          window=window, chunk=sh["chunk"],
                                          schedule=schedule)

        def plain(q_, k_, v_):
            return TA.simple_attention(q_, k_, v_, kind=kind, window=window)
        got, want = grads(flash), grads(plain)
        errs = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(got, want)]
        check(max(errs) <= VJP_TOL,
              f"flash VJP {kind} {schedule}: gradient errors {errs} "
              f"(relative to each gradient's max) > {VJP_TOL}")
        del got, want
        row = {"kind": kind, "window": window, "schedule": schedule,
               "rel_err_dq_dk_dv": errs,
               "ms": time_ms(lambda: grads(flash), 3),
               "plain_ms": time_ms(lambda: grads(plain), 3)}
        rows.append(row)
        print(f"[train] vjp {json.dumps(row)}")
    return rows


def train_quickstart(S, TT, FA, get_config, dev, ckpt_root):
    """quickstart at full width: the uninterrupted run, the resumed run,
    then the Server of the last checkpoint through the decode kernel."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.models import convert
    from repro_torch.models import model as TM
    from repro_torch.optim.adamw import AdamWConfig
    c = TRAIN_QS
    cfg = get_config("quickstart")

    def pipe():
        return SyntheticPipeline(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=c["seq"],
            global_batch=c["batch"]))

    def trainer(d, steps):
        return TT.Trainer(cfg, TT.TrainConfig(
            steps=steps, log_every=5, ckpt_every=c["every"], ckpt_dir=d,
            optimizer=AdamWConfig(lr=c["lr"], warmup_steps=c["warmup"],
                                  total_steps=c["steps"])))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    FA.reset_launch_counts()
    da, db = os.path.join(ckpt_root, "a"), os.path.join(ckpt_root, "b")
    t0 = time.perf_counter()
    _, _, ha = trainer(da, c["steps"]).run(pipe())
    secs_a = time.perf_counter() - t0
    check(FA.launch_counts() == {k: 0 for k in FA.launch_counts()},
          f"training launched an attention kernel: {FA.launch_counts()}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [h["loss"] for h in ha]
    check(all(np.isfinite(losses)), f"quickstart train: losses {losses}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    check(last < first, f"quickstart train: the loss did not fall "
          f"({first} -> {last})")
    every = f"step_{c['every']:010d}"
    shutil.copytree(os.path.join(da, every), os.path.join(db, every))
    p = pipe()
    tb = trainer(db, c["steps"] - 1)
    start, _, opt = tb.restore_or_init(p)
    check(start == c["every"] and p.state_dict()["step"] == c["every"] + 1
          and int(opt["count"]) == c["every"] + 1,
          f"resume: step {start}, pipeline {p.state_dict()}, count "
          f"{int(opt['count'])}")
    del opt
    model_b, _, hb = tb.run(pipe())
    pairs = list(zip(ha[c["every"] + 1:], hb))
    check(len(pairs) == len(hb) == c["steps"] - 1 - c["every"],
          f"resume: {len(hb)} steps, {len(pairs)} to compare")
    rel = max(abs(b["loss"] - a["loss"]) / abs(a["loss"]) for a, b in pairs)
    check(rel <= TRAIN_RESUME_RTOL and all(
        a["lr"] == b["lr"] for a, b in pairs),
          f"resume: losses differ by {rel} (relative) > "
          f"{TRAIN_RESUME_RTOL}, or the learning rates differ")
    # serve the last checkpoint through the decode kernel
    mgr = CheckpointManager(db)
    shapes = dict(TM.Model(cfg, "meta").named_parameters())
    step, tree, _, _ = mgr.restore(None, convert.tree_like_jax(shapes, cfg))
    model = convert.params_from_jax(tree, cfg, dev)
    check(all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                model_b.parameters())),
          "the served checkpoint differs from the trained weights")
    del model_b, tree
    sv = TRAIN_QS_SERVE
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (sv["batch"], sv["prompt"]))
    FA.reset_launch_counts()
    toks, logits = serve_run(S, cfg, model, prompts, sv["max_new"],
                             sv["max_len"], "blockspace")[:2]
    launches = FA.launch_counts()
    check(launches["flash_attention_decode"]
          == cfg.n_layers * (sv["max_new"] - 1),
          f"serve the trained weights: decode launches {launches}")
    check(toks.shape == (sv["batch"], sv["max_new"]) and (toks >= 0).all()
          and (toks < cfg.padded_vocab).all()
          and bool(torch.isfinite(logits).all()), f"served tokens {toks}")
    # the same requests through the plain decode: step logits within
    # SERVE_TOL, tokens equal where the top-2 margin exceeds it
    tx, lx = serve_run(S, cfg, model, prompts, sv["max_new"],
                       sv["max_len"], "xla")[:2]
    diff = compare_streams(toks, logits, tx, lx, SERVE_TOL[cfg.dtype],
                           "serve the trained quickstart")[0]
    step_s = [h["step_time_s"] for h in ha[1:]]
    ms = 1e3 * statistics.median(step_s)
    return {"arch": "quickstart", "layers": cfg.n_layers,
            "batch": c["batch"], "seq": c["seq"], "dtype": cfg.dtype,
            "steps": len(ha), "resumed_steps": len(hb),
            "losses": losses, "resumed_losses": [h["loss"] for h in hb],
            "loss_first5": first, "loss_last5": last,
            "resume_max_rel_loss_diff": rel,
            "ms_per_step": ms, "tokens_per_s": c["batch"] * c["seq"]
            / (ms / 1e3), "first_step_s": ha[0]["step_time_s"],
            "run_seconds": secs_a, "peak_gib": peak,
            "resident_gib": resident, "served_step": step, "serve_launches": launches,
            "served_tokens": toks.tolist(),
            "serve_max_logit_diff_vs_plain_decode": diff}


def train_steps(TT, TA, cfg, c, dev, ckpt_root, moments="float32"):
    """``c["steps"]`` steps of make_train_step from Trainer.init_params at
    batch ``c["batch"]`` x ``c["seq"]`` (no checkpoint: it would write
    tens of GB), the flash VJP's forward and backward counted, with the
    head dims (q, v) its forwards ran at.  Returns (metrics per step,
    calls, head dims, parameters, init seconds, peak GiB, ms per
    step)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.optim.adamw import AdamWConfig
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tcfg = TT.TrainConfig(steps=c["steps"], ckpt_dir=ckpt_root,
                          optimizer=AdamWConfig(lr=c["lr"], warmup_steps=1,
                                                total_steps=c["steps"],
                                                moment_dtype=moments))
    tr = TT.Trainer(cfg, tcfg, device=dev)
    step = TT.make_train_step(cfg, tcfg)
    t0 = time.perf_counter()
    model, opt = tr.init_params()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nparams = sum(p.numel() for p in model.parameters())
    pipe = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=c["seq"],
                                        global_batch=c["batch"],
                                        input_mode=cfg.input_mode,
                                        d_model=cfg.d_model))
    calls, dims = {"fwd": 0, "bwd": 0}, set()
    fwd, bwd = TA._flash_fwd_impl, TA._flash_vjp_bwd

    def counted_fwd(q, k, v, *a):
        calls["fwd"] += 1
        dims.add((q.shape[-1], v.shape[-1]))
        return fwd(q, k, v, *a)

    def counted_bwd(*a):
        calls["bwd"] += 1
        return bwd(*a)
    TA._flash_fwd_impl, TA._flash_vjp_bwd = counted_fwd, counted_bwd
    hist = []
    try:
        for _ in range(c["steps"]):
            batch = tr._device_batch(pipe.next_batch())
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            model, opt, met = step(model, opt, batch)
            met = {k: float(v) for k, v in met.items()}
            met["step_time_s"] = time.perf_counter() - t1
            hist.append(met)
            print(f"[train] {cfg.name} step: {json.dumps(met)}")
    finally:
        TA._flash_fwd_impl, TA._flash_vjp_bwd = fwd, bwd
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
              for h in hist), f"{cfg.name} train: {hist}")
    ms = 1e3 * statistics.median([h["step_time_s"] for h in hist[1:]])
    del model, opt
    torch.cuda.empty_cache()
    return hist, calls, sorted(dims), nparams, init_s, peak, ms


def train_gemma(TT, TA, get_config, dev, ckpt_root):
    """gemma3-12b at full width, cut to TRAIN_GEMMA["layers"] layers: a
    few steps of make_train_step (:func:`train_steps`)."""
    c = TRAIN_GEMMA
    cfg = get_config("gemma3-12b").replace(n_layers=c["layers"])
    check(cfg.remat and c["seq"] > cfg.flash_threshold
          and cfg.attn_chunk < c["seq"], "gemma3-12b train: not the flash "
          "path under remat")
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    hist, calls, _, nparams, init_s, peak, ms = train_steps(
        TT, TA, cfg, c, dev, ckpt_root)
    # remat runs each layer's forward twice (the forward, then again
    # before its backward); one backward per layer and step
    check(calls == {"fwd": 2 * cfg.n_layers * c["steps"],
                    "bwd": cfg.n_layers * c["steps"]},
          f"gemma3-12b train: flash VJP calls {calls}")
    return {"arch": "gemma3-12b", "layers": cfg.n_layers,
            "batch": c["batch"], "seq": c["seq"], "dtype": cfg.dtype,
            "param_dtype": cfg.param_dtype, "params": nparams,
            "init_s": init_s, "losses": [h["loss"] for h in hist],
            "grad_norms": [h["grad_norm"] for h in hist],
            "flash_calls": calls, "ms_per_step": ms,
            "first_step_s": hist[0]["step_time_s"],
            "tokens_per_s": c["batch"] * c["seq"] / (ms / 1e3),
            "peak_gib": peak, "resident_gib": resident}


def phase_train(S, TT, TA, FA, get_config, dev):
    """The trainer on the card: the flash VJP held to autograd through
    simple_attention, quickstart trained, resumed and served, gemma3-12b
    trained through the flash VJP."""
    t0 = time.perf_counter()
    ckpt_root = tempfile.mkdtemp(prefix="repro-torch-train-")
    try:
        vjp = vjp_check(TA, dev)
        torch.cuda.empty_cache()
        qs = train_quickstart(S, TT, FA, get_config, dev, ckpt_root)
        print(f"[train] quickstart {json.dumps(qs)}")
        gm = train_gemma(TT, TA, get_config, dev, ckpt_root)
        print(f"[train] gemma3-12b {json.dumps(gm)}")
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    out = {"card": CARD, "vjp": vjp, "quickstart": qs, "gemma3_12b": gm,
           "seconds": time.perf_counter() - t0}
    print(f"[train] quickstart {qs['ms_per_step']:.1f} ms/step, "
          f"{qs['tokens_per_s']:.0f} tokens/s, peak {qs['peak_gib']:.1f} "
          f"GiB; gemma3-12b ({gm['layers']} layers) "
          f"{gm['ms_per_step']:.1f} ms/step, {gm['tokens_per_s']:.0f} "
          f"tokens/s, peak {gm['peak_gib']:.1f} GiB; phase "
          f"{out['seconds']:.1f} s ({CARD})")
    return out


def free_card():
    """Give the card back what the phase's dropped objects held: a
    dropped Server frees its model at once (its guarded calls hold no
    reference to it); the collector runs for whatever else a phase left
    in a cycle, then the allocator's cache is emptied."""
    gc.collect()
    torch.cuda.empty_cache()


def step_profile(fn, reps=5, top=4):
    """Where one call of ``fn`` (a decode step) spends the card's time:
    a torch.profiler trace of ``reps`` calls after a warm-up, CUDA-event
    ms per call beside the device kernels' summed time per call (their
    difference: the card idle, waiting on the host), and the ``top``
    kernels by device time.  device_ms is None when the trace holds no
    device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    span = time_ms(fn, reps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / reps / 1e3, e.key)
                   for e in prof.key_averages()
                   if getattr(e, "device_type", None) is not None
                   and "CUDA" in str(e.device_type)), reverse=True)
    total = sum(ms for ms, _ in rows)
    return {"ms": span, "device_ms": total or None,
            "idle_share": 1 - total / span if total else None,
            "top_kernels": [{"ms": ms, "kernel": key[:120]}
                            for ms, key in rows[:top]]}


def decode_step_profile(TM, cfg, model, prompts, max_len, dev,
                        tag="families"):
    """:func:`step_profile` of one batched decode step right after the
    prompt (the step each Server run repeats)."""
    with torch.no_grad():
        toks = torch.as_tensor(prompts, device=dev)
        logits, cache = TM.prefill(model, toks, max_len, cfg)
        tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
        pos = prompts.shape[1]
        out = step_profile(lambda: TM.decode_step(model, tok, cache, pos,
                                                  cfg))
    print(f"[{tag}] {cfg.name} decode step profile {json.dumps(out)}")
    return out


def family_model(TM, get_config, arch, layers, dev):
    """``arch`` at full width cut to ``layers`` layers, seeded random
    weights on the card; prints the cut.  Returns (cfg, model, info)."""
    free_card()
    torch.cuda.reset_peak_memory_stats()
    full = get_config(arch)
    cfg = full.replace(n_layers=layers)
    t0 = time.perf_counter()
    model = TM.init(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    ffns = [TM.layer_sig(cfg, i)[2] for i in range(cfg.n_layers)]
    info = {"arch": arch, "layers": layers, "of_layers": full.n_layers,
            "ffn": ffns, "params": nparams, "param_gb": nbytes / 1e9,
            "init_s": time.perf_counter() - t0}
    print(f"[families] {arch}: full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, "
          f"{'MLA' if cfg.use_mla else 'GQA'}, {cfg.n_experts} experts "
          f"top-{cfg.top_k} + {cfg.n_shared_experts} shared) cut to "
          f"{layers} of its {full.n_layers} layers (FFNs {ffns}): "
          f"{nparams} {cfg.param_dtype} parameters ({nbytes / 1e9:.1f} GB; "
          f"the router f32) in {info['init_s']:.1f} s")
    return cfg, model, info


def families_paged(S, FA, cfg, model, dev):
    """PagedServer on llama4 at full width: FAM_PAGED's mixed requests
    through its slots, counted; streams against the single-request
    Server oracle (plain decode): a token may differ only where the
    oracle's top-2 margin is at most the tolerance or, since the slots'
    batched step rounds apart from the oracle's, where its router margin
    is at most ROUTE_TOL."""
    from repro_torch.models import moe as moe_lib
    c = FAM_PAGED
    n_moe = sum(isinstance(getattr(layer, "ffn", None), moe_lib.MoE)
                for layer in model.layers)
    rng = np.random.default_rng(SEED)
    reqs = [rng.integers(0, cfg.vocab_size,
                         (int(rng.integers(c["lo"], c["hi"] + 1)),))
            for _ in range(c["requests"])]
    max_len = c["hi"] + c["max_new"]
    num_pages = 1 + c["slots"] * S.paged_lib.pages_for(max_len, c["ps"])
    scfg = S.PagedServeConfig(max_len=max_len, num_slots=c["slots"],
                              page_size=c["ps"], num_pages=num_pages)
    FA.reset_launch_counts()
    srv = S.PagedServer(cfg.replace(attn_decode_kernel="blockspace"), model,
                        scfg)
    rep = S.paged_throughput_report(srv, reqs, max_new=c["max_new"])
    launches = FA.launch_counts()
    check(launches["paged_flash_attention"]
          == cfg.n_layers * rep["decode_steps"] > 0
          and sum(launches.values()) == launches["paged_flash_attention"],
          f"llama4 paged: launches {launches}, expected layers x paged "
          f"steps = {cfg.n_layers * rep['decode_steps']} paged ones only")
    check_healthy(srv, "llama4 paged")
    check(srv.alloc.free_pages == num_pages - 1, "llama4 paged: pages "
          "leaked")
    oracle = S.Server(cfg.replace(attn_decode_kernel="xla"), model,
                      S.ServeConfig(max_len=max_len))
    tol = SERVE_TOL[cfg.dtype]
    small = diverged = by_route = 0
    for rid, prompt in enumerate(reqs):
        steps = []
        with recording_routes(moe_lib) as calls:
            want = oracle.generate(prompt[None], c["max_new"],
                                   on_step=lambda p, lg: steps.append(
                                       lg[0, 0].float()))[0]
        mo = margin(torch.stack(steps))
        small += int((mo <= tol).sum())
        neq = (srv.done[rid] != want).nonzero()[0]
        if len(neq):
            t = int(neq[0])
            m = float(mo[t])
            rm = min(mg for _, mg in step_routes(calls, n_moe, 1, t, 0))
            check(m <= tol or rm <= ROUTE_TOL,
                  f"llama4 paged request {rid} differs from the "
                  f"single-request oracle at step {t} where the top-2 "
                  f"margin is {m} > {tol} and the router margin {rm} > "
                  f"{ROUTE_TOL}")
            diverged += 1
            by_route += m > tol
    rep.update({"launches": launches, "requests": c["requests"],
                "slots": c["slots"], "page_size": c["ps"],
                "num_pages": num_pages,
                "prompt_lens": [len(r) for r in reqs],
                "oracle_steps_margin_le_tol": small,
                "streams_diverged": diverged,
                "streams_diverged_at_router_near_tie": by_route})
    print(f"[families] llama4 paged {json.dumps(rep)}")
    return rep


def families_llama(S, TM, FA, get_config, dev):
    """llama4-maverick at full width, cut: the Server under blockspace
    (counted) and xla, streams compared, timed in turns; the
    PagedServer."""
    c = FAM_LLAMA
    cfg, model, info = family_model(TM, get_config,
                                    "llama4-maverick-400b-a17b",
                                    c["layers"], dev)
    check(info["ffn"] == ["dense", "moe"], f"llama4 layers {info['ffn']}")
    prompts = torch.randint(
        0, cfg.vocab_size, (c["batch"], c["prompt"]),
        generator=torch.Generator().manual_seed(SEED)).numpy()
    from repro_torch.models import moe as moe_lib
    runs = {}
    for kernel in ("blockspace", "xla", "xla", "blockspace"):
        FA.reset_launch_counts()
        with recording_routes(moe_lib) as calls:
            toks, logits, secs, step_ms = serve_run(
                S, cfg, model, prompts, c["max_new"], c["max_len"], kernel)
        launches = FA.launch_counts()
        want = (cfg.n_layers * (c["max_new"] - 1)
                if kernel == "blockspace" else 0)
        check(launches["flash_attention_decode"] == want
              and sum(launches.values()) == want,
              f"llama4 serve {kernel}: launches {launches}, expected "
              f"{want} decode ones only")
        check(toks.shape == (c["batch"], c["max_new"])
              and bool(torch.isfinite(logits).all()),
              f"llama4 serve {kernel}: stream {toks.shape} or non-finite "
              f"logits")
        run = runs.setdefault(kernel, {"launches": [], "seconds": [],
                                       "ms_per_decode_step": []})
        run["launches"].append(launches["flash_attention_decode"])
        run["seconds"].append(secs)
        run["ms_per_decode_step"].append(step_ms)
        run.setdefault("stream", (toks, logits, calls))
    (tk, lk, ck), (tx, lx, cx) = runs["blockspace"].pop("stream"), \
        runs["xla"].pop("stream")
    tol = SERVE_TOL[cfg.dtype]
    diff, ncmp, small, diverged, flipped = compare_streams(
        tk, lk, tx, lx, tol, "llama4 serve",
        routes=(ck, cx, info["ffn"].count("moe"), c["batch"]))
    serve = {"batch": c["batch"], "prompt": c["prompt"],
             "max_new": c["max_new"], "max_len": c["max_len"], **runs,
             "tol": tol, "route_tol": ROUTE_TOL, "max_logit_diff": diff,
             "steps_compared": ncmp, "steps_margin_le_tol": small,
             "rows_diverged": diverged, "rows_route_flipped": flipped,
             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "decode_step_profile": decode_step_profile(
                 TM, cfg.replace(attn_decode_kernel="blockspace"), model,
                 prompts, c["max_len"], dev)}
    print(f"[families] llama4 serve {json.dumps(serve)}")
    paged = families_paged(S, FA, cfg, model, dev)
    del model
    free_card()
    return {**info, "serve": serve, "paged": paged}


def mla_check(TM, FA, cfg, model, prompts, toks, dev):
    """The absorbed MLA decode against the materialised prefill at full
    width: (1) the model's logits at positions prompt .. prompt + steps -
    1 by decode_step against those of one forward over the extended
    sequence (row 0, f32 compute over the bf16 weights, a capacity that
    drops nothing), within FAM_MLA_F32_TOL; (2) in bf16 as served, the
    first layer's mla_decode against mla_block over the extended batch,
    within the bf16 tolerance of FA._compare."""
    from repro_torch.models import layers as L
    from repro_torch.models import mla as mla_lib
    c = FAM_DEEPSEEK
    plen, n = c["prompt"], c["mla_steps"]
    ext = torch.as_tensor(np.concatenate([prompts, toks[:, :n]], 1),
                          device=dev)
    cfg32 = cfg.replace(dtype="float32",
                        capacity_factor=cfg.n_experts / cfg.top_k)
    with torch.no_grad():
        full, _ = TM.logits_fn(model, ext[:1], cfg32)
        last, cache = TM.prefill(model, ext[:1, :plen], plen + n, cfg32)
        dec = [last[:, 0]]
        for j in range(n):
            pos = plen + j
            lg, cache = TM.decode_step(model, ext[:1, pos:pos + 1], cache,
                                       pos, cfg32)
            dec.append(lg[:, 0])
    got = torch.stack(dec, 1)
    want = full[:, plen - 1:plen + n]
    err = (got - want).abs().amax(dim=(0, 2))
    scale = float(want.abs().max())
    check(float(err.max()) <= FAM_MLA_F32_TOL,
          f"MLA f32: decode logits differ from the extended prefill's by "
          f"{err.tolist()} > {FAM_MLA_F32_TOL} (logits up to {scale})")
    del full, cache
    # bf16, the first layer's MLA block as served
    layer = model.layers[0]
    with torch.no_grad():
        hn = L.rmsnorm(layer.norm1, L.embed(model.embed, ext, cfg.tdtype()),
                       cfg.norm_eps)
        pre = mla_lib.mla_block(layer.mixer, hn, cfg,
                                torch.arange(plen + n, device=dev))
        _, (ck, kr) = mla_lib.mla_block(
            layer.mixer, hn[:, :plen], cfg, torch.arange(plen, device=dev),
            return_cache=True)
        cache = tuple(torch.nn.functional.pad(t, (0, 0, 0, n))
                      for t in (ck, kr))
        outs = []
        for j in range(n):
            o, cache = mla_lib.mla_decode(layer.mixer,
                                          hn[:, plen + j:plen + j + 1], cfg,
                                          cache, plen + j)
            outs.append(o)
    got = torch.cat(outs, 1)
    b_err = FA._compare(got, pre[:, plen:],
                        "MLA bf16 layer 0: decode vs prefill")
    b_rel = FA.row_rel_err(got, pre[:, plen:])
    out = {"f32_max_abs_err_by_position": err.tolist(),
           "f32_positions": [plen - 1 + j for j in range(n + 1)],
           "f32_logit_max": scale, "f32_tol": FAM_MLA_F32_TOL,
           "bf16_layer0_max_abs_err": b_err, "bf16_layer0_row_err": b_rel,
           "bf16_layer0_out_max": float(pre[:, plen:].abs().max()),
           "bf16_tol": FA.TOLERANCE[torch.bfloat16],
           "bf16_row_rtol": FA.ROW_RTOL[torch.bfloat16]}
    print(f"[families] deepseek MLA decode vs prefill {json.dumps(out)}")
    return out


def moe_check(FA, cfg, model, dev):
    """The first MoE layer at full width: moe_block against
    moe_block_dense_ref on FAM_DEEPSEEK["moe_tokens"] tokens of normal
    inputs, bf16, a capacity that drops nothing (checked from the
    routing), within the bf16 tolerance of FA._compare."""
    from repro_torch.models import moe as moe_lib
    n = FAM_DEEPSEEK["moe_tokens"]
    ffn = next(layer.ffn for layer in model.layers
               if isinstance(getattr(layer, "ffn", None), moe_lib.MoE))
    nd = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((1, n, cfg.d_model), generator=g, device=dev).to(
        cfg.tdtype())
    with torch.no_grad():
        _, _, idx = moe_lib.route(ffn, x[0], nd)
        load = int(torch.bincount(idx.reshape(-1)).max())
        cap = moe_lib._capacity(n, nd)
        check(load <= cap, f"MoE check: an expert took {load} > capacity "
              f"{cap}")
        out, aux = moe_lib.moe_block(ffn, x, nd)
        dense = moe_lib.moe_block_dense_ref(ffn, x, nd)
    err = FA._compare(out, dense, "MoE: moe_block vs the dense oracle")
    rel = FA.row_rel_err(out, dense)
    res = {"tokens": n, "capacity": cap, "max_expert_load": load,
           "aux_loss": float(aux), "max_abs_err": err, "row_err": rel,
           "out_max": float(dense.abs().max())}
    print(f"[families] deepseek MoE vs dense oracle {json.dumps(res)}")
    return res


def families_deepseek(S, TM, FA, get_config, dev):
    """deepseek-v2 at full width, cut: the Server (no kernel on the
    path), the MLA check and the MoE check."""
    c = FAM_DEEPSEEK
    cfg, model, info = family_model(TM, get_config, "deepseek-v2-236b",
                                    c["layers"], dev)
    check(info["ffn"] == ["dense"] + ["moe"] * (c["layers"] - 1),
          f"deepseek layers {info['ffn']}")
    prompts = torch.randint(
        0, cfg.vocab_size, (c["batch"], c["prompt"]),
        generator=torch.Generator().manual_seed(SEED)).numpy()
    runs = []
    for _ in range(2):
        FA.reset_launch_counts()
        toks, logits, secs, step_ms = serve_run(
            S, cfg, model, prompts, c["max_new"], c["max_len"],
            cfg.attn_decode_kernel)
        launches = FA.launch_counts()
        check(not any(launches.values()), f"deepseek serve launched "
              f"{launches}")
        check(toks.shape == (c["batch"], c["max_new"])
              and bool(torch.isfinite(logits).all()),
              f"deepseek serve: stream {toks.shape} or non-finite logits")
        runs.append({"seconds": secs, "ms_per_decode_step": step_ms})
    print(f"[families] deepseek serve: no kernel lies on this path (MLA's "
          f"prefill is plain attention below flash_threshold "
          f"{cfg.flash_threshold}, its absorbed decode plain einsums, the "
          f"MoE plain bmm): launches {launches}; {json.dumps(runs)}")
    serve = {"batch": c["batch"], "prompt": c["prompt"],
             "max_new": c["max_new"], "max_len": c["max_len"],
             "runs": runs, "launches": launches,
             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "decode_step_profile": decode_step_profile(
                 TM, cfg, model, prompts, c["max_len"], dev)}
    mla = mla_check(TM, FA, cfg, model, prompts, toks, dev)
    moe = moe_check(FA, cfg, model, dev)
    del model
    free_card()
    return {**info, "serve": serve, "mla": mla, "moe": moe}


def families_train(TT, TA, get_config, dev):
    """deepseek-v2 at full width, cut to FAM_TRAIN["layers"] layers, a
    few steps (:func:`train_steps`): finite losses, aux_loss > 0, the
    flash VJP at V head dim 128 against QK 192."""
    c = FAM_TRAIN
    cfg = get_config("deepseek-v2-236b").replace(n_layers=c["layers"])
    check(cfg.remat and c["seq"] > cfg.flash_threshold,
          "deepseek train: not the flash path under remat")
    free_card()
    ckpt_root = tempfile.mkdtemp(prefix="repro-torch-families-")
    try:
        hist, calls, dims, nparams, init_s, peak, ms = train_steps(
            TT, TA, cfg, c, dev, ckpt_root, moments="bfloat16")
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    from repro_torch.models.model import group_layout
    prefix = group_layout(cfg)[0]
    # remat runs each grouped layer's forward twice; the prefix (the
    # dense first layer) once
    want = {"fwd": (prefix + 2 * (cfg.n_layers - prefix)) * c["steps"],
            "bwd": cfg.n_layers * c["steps"]}
    dq, dv = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    check(calls == want and dims == [(dq, dv)],
          f"deepseek train: flash VJP calls {calls} at head dims {dims}, "
          f"expected {want} at {[(dq, dv)]}")
    check(all(h["aux_loss"] > 0 for h in hist),
          f"deepseek train: aux losses {[h['aux_loss'] for h in hist]}")
    out = {"arch": cfg.name, "layers": cfg.n_layers, "batch": c["batch"],
           "seq": c["seq"], "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
           "moment_dtype": "bfloat16", "params": nparams, "init_s": init_s,
           "losses": [h["loss"] for h in hist],
           "aux_losses": [h["aux_loss"] for h in hist],
           "grad_norms": [h["grad_norm"] for h in hist],
           "flash_calls": calls, "flash_head_dims": dims,
           "ms_per_step": ms, "first_step_s": hist[0]["step_time_s"],
           "tokens_per_s": c["batch"] * c["seq"] / (ms / 1e3),
           "peak_gib": peak}
    print(f"[families] deepseek train {json.dumps(out)}")
    return out


def families_kernel_entries(kernels, families):
    """Add the [families] phase to the two decode entries of the kernels
    line: launches_families_phase (llama4-maverick's blockspace Servers
    and its PagedServer) and a llama4_maverick object (the kernel at its
    heads, a group of 5: device times, plain version, bound, error)."""
    entry_of = {"flash_attention_decode": "flash_attention",
                "paged_flash_attention": "paged_flash_attention"}
    for entry in kernels:
        if entry["name"] not in entry_of:
            continue
        row = families["decode"][entry_of[entry["name"]]]
        entry["launches_families_phase"] = families["decode_launches"][
            entry["name"]]
        entry["max_abs_err"] = max(entry["max_abs_err"], row["max_abs_err"])
        entry["llama4_maverick"] = {
            **device_times(row), **{key: row[key] for key in (
                "plain_ms", "bound_ms", "bound_by", "max_abs_err", "at")}}


def phase_families(S, TM, TT, TA, FA, P, get_config, dev):
    """The MoE and MLA stacks on the card (see the module docstring,
    phase 17); the decode launches of the phase's counted runs are
    returned under "decode_launches"."""
    t0 = time.perf_counter()
    free_card()
    k = FAM_DECODE
    decode = decode_shape_check(FA, P, dev, k["arch"], k["b"], k["h"],
                                k["hkv"], k["d"], k["max_len"],
                                list(k["positions"]), (0,), 903, TA)
    llama = families_llama(S, TM, FA, get_config, dev)
    deepseek = families_deepseek(S, TM, FA, get_config, dev)
    train = families_train(TT, TA, get_config, dev)
    out = {"card": CARD, "decode": decode, "llama4": llama,
           "deepseek": deepseek, "train": train,
           "decode_launches": {
               "flash_attention_decode": sum(
                   llama["serve"]["blockspace"]["launches"]),
               "paged_flash_attention": llama["paged"]["launches"][
                   "paged_flash_attention"]},
           "seconds": time.perf_counter() - t0}
    med = {key: statistics.median(runs) for key, runs in (
        ("llama4", llama["serve"]["blockspace"]["ms_per_decode_step"]),
        ("llama4 xla", llama["serve"]["xla"]["ms_per_decode_step"]),
        ("deepseek", [r["ms_per_decode_step"]
                      for r in deepseek["serve"]["runs"]]))}
    print(f"[families] ms per decode step: llama4 ({FAM_LLAMA['layers']} "
          f"layers) {med['llama4']:.2f} (xla {med['llama4 xla']:.2f}, paged "
          f"{llama['paged']['ms_per_decode_step']:.2f}), deepseek "
          f"({FAM_DEEPSEEK['layers']} layers) {med['deepseek']:.2f}; "
          f"deepseek train ({FAM_TRAIN['layers']} layers) "
          f"{train['ms_per_step']:.1f} ms/step, peak "
          f"{train['peak_gib']:.1f} GiB; phase {out['seconds']:.1f} s "
          f"({CARD})")
    return out


# ---------------------------------------------------------------------------
# [ssm]: the SSM, hybrid and embedding-input stacks
# ---------------------------------------------------------------------------

def close_within(got, want, tol, what):
    """``got`` within ``tol`` (rtol / atol) of ``want``; returns the
    largest |got - want| and the largest excess over the bound."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    excess = float((err - tol["atol"] - tol["rtol"] * want.abs()).max())
    check(bool(torch.isfinite(got).all()) and excess <= 0,
          f"{what}: exceeds rtol {tol['rtol']} / atol {tol['atol']} by "
          f"{excess} (max |err| {float(err.max())})")
    return float(err.max()), excess


def ssm_scans(TS, dev):
    """Phase 1: both chunked scans at full width against their
    sequential oracles, f32 (SSM_TOL), timed beside them."""
    g = torch.Generator(device=dev).manual_seed(SEED)

    def uni(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)

    def nrm(shape):
        return torch.randn(shape, generator=g, device=dev)

    out = {}
    c = SSM_S6
    b, s, di, n = c["b"], c["s"], c["di"], c["n"]
    s6 = (nrm((b, s, di)), uni((b, s, di), 0.001, 0.1),
          -uni((di, n), 0.5, 2.0), nrm((b, s, n)), nrm((b, s, n)))
    c2 = SSM_SSD
    b2, s2, nh, pd, n2 = c2["b"], c2["s"], c2["nh"], c2["p"], c2["n"]
    ssd = (nrm((b2, s2, nh, pd)), uni((b2, s2, nh), 0.001, 0.5),
           -uni((nh,), 0.5, 2.0), nrm((b2, s2, n2)), nrm((b2, s2, n2)))
    with torch.no_grad():
        for name, scan, ref, args, cc, shape in (
                ("selective_scan", TS.selective_scan, TS.selective_scan_ref,
                 s6, c["chunk"], f"b {b}, S {s}, d_inner {di}, N {n}"),
                ("ssd_scan", TS.ssd_scan, TS.ssd_scan_ref, ssd, c2["chunk"],
                 f"b {b2}, S {s2}, {nh} heads x {pd}, N {n2}")):
            got = scan(*args, chunk=cc)
            want = ref(*args)
            err, excess = close_within(got, want, SSM_TOL, name)
            out[name] = {
                "at": f"{shape}, chunk {cc}, f32", "max_abs_err": err,
                "excess_over_tol": excess, "out_max": float(want.abs().max()),
                "tol": SSM_TOL, "ms": time_ms(lambda: scan(*args, chunk=cc),
                                              5),
                "sequential_oracle_ms": time_ms(lambda: ref(*args), 2)}
            print(f"[ssm] {name} vs its sequential oracle "
                  f"{json.dumps(out[name])}")
    return out


def ssm_model(TM, get_config, arch, layers, dev, **replace):
    """``arch`` at full width (cut to ``layers`` layers when fewer than
    its own), seeded random weights on the card.  Returns (cfg, model,
    info)."""
    free_card()
    torch.cuda.reset_peak_memory_stats()
    full = get_config(arch)
    cfg = full.replace(n_layers=layers, **replace)
    t0 = time.perf_counter()
    model = TM.init(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    mixers = sorted({TM.layer_sig(cfg, i)[0] for i in range(layers)})
    shared = sum(TM.layer_sig(cfg, i)[3] for i in range(layers))
    info = {"arch": arch, "layers": layers, "of_layers": full.n_layers,
            "mixers": mixers, "shared_applications": shared,
            "input_mode": cfg.input_mode, "params": nparams,
            "param_gb": nbytes / 1e9, "init_s": time.perf_counter() - t0}
    print(f"[ssm] {arch}: full width (d_model {cfg.d_model}, mixers "
          f"{mixers}, {shared} shared-block applications, {cfg.input_mode} "
          f"inputs) at {layers} of its {full.n_layers} layers: {nparams} "
          f"{cfg.param_dtype} parameters ({nbytes / 1e9:.1f} GB), compute "
          f"{cfg.dtype}, in {info['init_s']:.1f} s")
    return cfg, model, info


def ssm_prompts(cfg, c):
    return torch.randint(0, cfg.vocab_size, (c["batch"], c["prompt"]),
                         generator=torch.Generator().manual_seed(SEED)
                         ).numpy()


def falcon_decode_check(TM, get_config, dev):
    """falcon-mamba-7b's decode against its prefill, an f32 copy at
    SSM_FALCON["check_layers"] layers: the last logits and every layer's
    (ssm_state, conv_state) after a prefill of P + T tokens against
    those after a prefill of P and T decode steps fed the same tokens,
    within SSM_DECODE_TOL."""
    c = SSM_FALCON
    cfg, model, _ = ssm_model(TM, get_config, "falcon-mamba-7b",
                              c["check_layers"], dev, dtype="float32")
    p, t = c["check_prompt"], c["check_steps"]
    toks = torch.randint(0, cfg.vocab_size, (c["check_batch"], p + t),
                         generator=torch.Generator().manual_seed(SEED + 1)
                         ).to(dev)
    with torch.no_grad():
        want, wcache = TM.prefill(model, toks, None, cfg)
        lg, cache = TM.prefill(model, toks[:, :p], None, cfg)
        for j in range(t):
            lg, cache = TM.decode_step(model, toks[:, p + j:p + j + 1],
                                       cache, p + j, cfg)
    errs = {"logits": float((lg - want).abs().max())}
    mags = {"logits": float(want.abs().max())}
    for k, name in enumerate(("ssm_state", "conv_state")):
        errs[name] = max(float((a[k] - b[k]).abs().max())
                         for a, b in zip(cache, wcache))
        mags[name] = max(float(b[k].abs().max()) for b in wcache)
    check(max(errs.values()) <= SSM_DECODE_TOL,
          f"falcon-mamba decode vs prefill: {errs} > {SSM_DECODE_TOL} "
          f"(magnitudes {mags})")
    out = {"layers": cfg.n_layers, "batch": c["check_batch"],
           "prefill": p, "decode_steps": t, "dtype": cfg.dtype,
           "max_abs_err": errs, "max_abs": mags, "tol": SSM_DECODE_TOL}
    print(f"[ssm] falcon-mamba decode vs prefill {json.dumps(out)}")
    del model, cache, wcache
    free_card()
    return out


def ssm_server_runs(S, FA, cfg, model, prompts, c, kernels, want_launches,
                    what):
    """Server runs in turns (``kernels``), each counted from 0 and held
    to ``want_launches(kernel)`` decode-kernel launches and nothing
    else; returns ({kernel: launches, seconds, ms per decode step},
    {kernel: (tokens, step logits)} of each kernel's first run)."""
    runs, streams = {}, {}
    for kernel in kernels:
        FA.reset_launch_counts()
        toks, logits, secs, step_ms = serve_run(
            S, cfg, model, prompts, c["max_new"], c["max_len"], kernel)
        launches = FA.launch_counts()
        want = want_launches(kernel)
        check(launches["flash_attention_decode"] == want
              and sum(launches.values()) == want,
              f"{what} serve {kernel}: launches {launches}, expected "
              f"{want} decode ones only")
        check(toks.shape == (c["batch"], c["max_new"])
              and bool(torch.isfinite(logits).all()),
              f"{what} serve {kernel}: stream {toks.shape} or non-finite "
              f"logits")
        run = runs.setdefault(kernel, {"launches": [], "seconds": [],
                                       "ms_per_decode_step": []})
        run["launches"].append(launches["flash_attention_decode"])
        run["seconds"].append(secs)
        run["ms_per_decode_step"].append(step_ms)
        streams.setdefault(kernel, (toks, logits))
    return runs, streams


def falcon_chaos(S, cfg, model, prompts, want, want_logits):
    """falcon-mamba-7b's guarded Server under SSM_CHAOS: the stream of
    the unfaulted run ``want``, every fault fired and recovered on the
    ladder's top rung; the largest difference of its step logits from
    the unfaulted run's ``want_logits`` (B, T, V) is reported."""
    from repro_torch.runtime import chaos as RC
    c = SSM_FALCON
    chaos = RC.ChaosInjector(RC.FaultPlan(0, [
        RC.FaultSpec(k, site, i) for k, site, i in SSM_CHAOS]))
    srv = S.Server(cfg, model, S.ServeConfig(max_len=c["max_len"],
                                             backoff_base_s=0.0),
                   chaos=chaos)
    steps = []
    out = srv.generate(prompts, c["max_new"], on_step=lambda pos, lg:
                       steps.append(lg[:, 0].float()))
    check(np.array_equal(out, np.asarray(want)),
          "falcon-mamba chaos: the stream differs from the unfaulted run")
    diff = float((torch.stack(steps, 1) - want_logits).abs().max())
    check(len(chaos.events) == len(SSM_CHAOS) and srv.ladder.level == 0
          and srv._decode.recoveries == len(SSM_CHAOS),
          f"falcon-mamba chaos: {len(chaos.events)} faults fired, "
          f"{srv._decode.recoveries} recoveries, ladder level "
          f"{srv.ladder.level}")
    res = {"faults": [list(f) for f in SSM_CHAOS], "status": "recovered",
           "recoveries": srv._decode.recoveries, "stream_equal": True,
           "max_logit_diff_from_unfaulted": diff}
    print(f"[ssm] falcon-mamba chaos {json.dumps(res)}")
    return res


def ssm_falcon(S, TM, FA, get_config, dev):
    """Phase 2: falcon-mamba-7b at full width and depth through the
    Server (no kernel lies on its path), under injected decode faults
    (:func:`falcon_chaos`), its decode step's profile; then the decode
    held to the prefill (:func:`falcon_decode_check`)."""
    c = SSM_FALCON
    cfg, model, info = ssm_model(TM, get_config, "falcon-mamba-7b",
                                 get_config("falcon-mamba-7b").n_layers, dev)
    prompts = ssm_prompts(cfg, c)
    runs, streams = ssm_server_runs(S, FA, cfg, model, prompts, c,
                                    (cfg.attn_decode_kernel,) * 2,
                                    lambda k: 0, "falcon-mamba")
    chaos = falcon_chaos(S, cfg, model, prompts,
                         *streams[cfg.attn_decode_kernel])
    serve = {"batch": c["batch"], "prompt": c["prompt"],
             "max_new": c["max_new"], "max_len": c["max_len"],
             "runs": runs[cfg.attn_decode_kernel], "chaos": chaos,
             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "decode_step_profile": decode_step_profile(
                 TM, cfg, model, prompts, c["max_len"], dev, "ssm")}
    print(f"[ssm] falcon-mamba serve {json.dumps(serve)}")
    del model
    free_card()
    dvp = falcon_decode_check(TM, get_config, dev)
    return {**info, "serve": serve, "decode_vs_prefill": dvp}


def ssm_zamba(S, TM, TA, FA, P, get_config, dev):
    """Phase 3: zamba2-2.7b at full width and depth: the decode kernel at
    its shared block's heads (32/32 x 80 bf16) against its plain
    version, the Server under blockspace (shared applications x decode
    steps launches) and xla (none) in turns, streams compared; its
    decode step's profile."""
    c = SSM_ZAMBA
    cfg, model, info = ssm_model(TM, get_config, "zamba2-2.7b",
                                 get_config("zamba2-2.7b").n_layers, dev)
    plen, b = c["prompt"], c["batch"]
    decode = decode_shape_check(
        FA, P, dev, cfg.name, b, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
        c["max_len"], [plen, plen + 3, plen + 7, plen + c["max_new"] - 1],
        (0,), 904, TA)
    prompts = ssm_prompts(cfg, c)
    shared = info["shared_applications"]
    runs, streams = ssm_server_runs(
        S, FA, cfg, model, prompts, c, ("blockspace", "xla", "xla",
                                        "blockspace"),
        lambda k: shared * (c["max_new"] - 1) if k == "blockspace" else 0,
        "zamba2")
    (tk, lk), (tx, lx) = streams["blockspace"], streams["xla"]
    tol = SERVE_TOL[cfg.dtype]
    diff, ncmp, small, diverged, _ = compare_streams(tk, lk, tx, lx, tol,
                                                     "zamba2 serve")
    serve = {"batch": b, "prompt": plen, "max_new": c["max_new"],
             "max_len": c["max_len"], **runs, "tol": tol,
             "max_logit_diff": diff, "steps_compared": ncmp,
             "steps_margin_le_tol": small, "rows_diverged": diverged,
             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "decode_step_profile": decode_step_profile(
                 TM, cfg.replace(attn_decode_kernel="blockspace"), model,
                 prompts, c["max_len"], dev, "ssm")}
    print(f"[ssm] zamba2 serve {json.dumps(serve)}")
    del model
    free_card()
    return {**info, "decode": decode, "serve": serve}


def ssm_embeddings(TM, TA, FA, P, get_config, dev, arch):
    """Phases 4 and 5: an embedding-input stack at full width (SSM_EMB's
    depth): the decode kernel at its heads against its plain version;
    a prefill of seeded (B, prompt, D) embeddings and ``steps`` decode
    steps on (B, 1, D) ones under blockspace (layers x steps launches)
    and xla (none), the step logits compared within SERVE_TOL."""
    c = SSM_EMB[arch]
    cfg, model, info = ssm_model(TM, get_config, arch, c["layers"], dev)
    plen, b, n = c["prompt"], c["batch"], c["steps"]
    decode = decode_shape_check(
        FA, P, dev, arch, b, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
        c["max_len"], [plen, plen + 3, plen + 7, plen + n - 1], (0,),
        905 + len(arch), TA)
    g = torch.Generator(device=dev).manual_seed(SEED)
    emb = torch.randn((b, plen + n, cfg.d_model), generator=g, device=dev)
    runs, logits = {}, {}
    for kernel in ("blockspace", "xla"):
        kcfg = cfg.replace(attn_decode_kernel=kernel)
        FA.reset_launch_counts()
        steps, stamps = [], []
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = TM.prefill(model, emb[:, :plen], c["max_len"], kcfg)
            steps.append(lg[:, 0].float())
            stamps.append(time.perf_counter())
            for j in range(n):
                pos = plen + j
                lg, cache = TM.decode_step(model, emb[:, pos:pos + 1], cache,
                                           pos, kcfg)
                steps.append(lg[:, 0].float())
                stamps.append(time.perf_counter())
            torch.cuda.synchronize()
        launches = FA.launch_counts()
        want = cfg.n_layers * n if kernel == "blockspace" else 0
        check(launches["flash_attention_decode"] == want
              and sum(launches.values()) == want,
              f"{arch} {kernel}: launches {launches}, expected {want} "
              f"decode ones only")
        logits[kernel] = torch.stack(steps, 1)
        check(bool(torch.isfinite(logits[kernel]).all()),
              f"{arch} {kernel}: non-finite logits")
        runs[kernel] = {"launches": launches["flash_attention_decode"],
                        "seconds": time.perf_counter() - t0,
                        "ms_per_decode_step": 1e3 * (stamps[-1] - stamps[0])
                        / n}
        del cache
    tol = SERVE_TOL[cfg.dtype]
    diff = float((logits["blockspace"] - logits["xla"]).abs().max())
    check(diff <= tol, f"{arch}: blockspace step logits differ from xla's "
          f"by {diff} > {tol}")
    out = {**info, "decode": decode, "batch": b, "prompt": plen,
           "steps": n, "max_len": c["max_len"], **runs, "tol": tol,
           "max_logit_diff": diff,
           "logit_max": float(logits["xla"].abs().max()),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"[ssm] {arch} embeddings {json.dumps(out)}")
    del model
    free_card()
    return out


def ssm_train(TT, TA, get_config, dev):
    """Phase 6: each stack trained SSM_TRAIN["steps"] steps at its cut
    depth (:func:`train_steps`): finite losses, ms a step, peak."""
    c = SSM_TRAIN
    out = {}
    ckpt_root = tempfile.mkdtemp(prefix="repro-torch-ssm-")
    try:
        for arch, layers in c["layers"].items():
            free_card()
            cfg = get_config(arch).replace(n_layers=layers)
            hist, calls, dims, nparams, init_s, peak, ms = train_steps(
                TT, TA, cfg, c, dev, ckpt_root)
            out[arch] = {"layers": layers, "batch": c["batch"],
                         "seq": c["seq"], "dtype": cfg.dtype,
                         "param_dtype": cfg.param_dtype, "remat": cfg.remat,
                         "params": nparams, "init_s": init_s,
                         "losses": [h["loss"] for h in hist],
                         "grad_norms": [h["grad_norm"] for h in hist],
                         "flash_calls": calls, "ms_per_step": ms,
                         "first_step_s": hist[0]["step_time_s"],
                         "tokens_per_s": c["batch"] * c["seq"] / (ms / 1e3),
                         "peak_gib": peak}
            print(f"[ssm] {arch} train {json.dumps(out[arch])}")
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    return out


def ssm_kernel_entries(kernels, ssm):
    """Add the [ssm] phase to the two decode entries of the kernels line:
    launches_ssm_phase (zamba2's blockspace Servers, musicgen's and
    internvl2's blockspace decodes; no paged launch lies on the phase)
    and an object per new head shape (device times, plain version,
    bound, error)."""
    entry_of = {"flash_attention_decode": "flash_attention",
                "paged_flash_attention": "paged_flash_attention"}
    for entry in kernels:
        if entry["name"] not in entry_of:
            continue
        entry["launches_ssm_phase"] = ssm["decode_launches"][entry["name"]]
        for key, arch in (("zamba2_2_7b", "zamba2"),
                          ("musicgen_large", "musicgen-large"),
                          ("internvl2_26b", "internvl2-26b")):
            row = ssm[arch]["decode"][entry_of[entry["name"]]]
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       row["max_abs_err"])
            entry[key] = {**device_times(row), **{k: row[k] for k in (
                "plain_ms", "bound_ms", "bound_by", "max_abs_err", "at")}}


def phase_ssm(S, TM, TT, TA, TS, FA, P, get_config, dev):
    """The SSM, hybrid and embedding-input stacks on the card (see the
    module docstring, phase 18); the decode launches of the phase's
    counted runs are returned under "decode_launches", each part's peak
    memory under its own key."""
    t0 = time.perf_counter()
    free_card()
    torch.cuda.reset_peak_memory_stats()
    scans = ssm_scans(TS, dev)
    scans["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    falcon = ssm_falcon(S, TM, FA, get_config, dev)
    zamba = ssm_zamba(S, TM, TA, FA, P, get_config, dev)
    emb = {arch: ssm_embeddings(TM, TA, FA, P, get_config, dev, arch)
           for arch in SSM_EMB}
    train = ssm_train(TT, TA, get_config, dev)
    out = {"card": CARD, "scans": scans, "falcon-mamba": falcon,
           "zamba2": zamba, **emb, "train": train,
           "decode_launches": {
               "flash_attention_decode": sum(
                   zamba["serve"]["blockspace"]["launches"])
               + sum(e["blockspace"]["launches"] for e in emb.values()),
               "paged_flash_attention": 0},
           "seconds": time.perf_counter() - t0}
    med = {key: statistics.median(runs) for key, runs in (
        ("falcon", falcon["serve"]["runs"]["ms_per_decode_step"]),
        ("zamba2", zamba["serve"]["blockspace"]["ms_per_decode_step"]),
        ("zamba2 xla", zamba["serve"]["xla"]["ms_per_decode_step"]))}
    idle = {k: v["serve"]["decode_step_profile"]["idle_share"]
            for k, v in (("falcon", falcon), ("zamba2", zamba))}
    print(f"[ssm] ms per decode step: falcon-mamba-7b ({falcon['layers']} "
          f"layers, B {SSM_FALCON['batch']}) {med['falcon']:.2f} (idle share "
          f"{idle['falcon']}), zamba2-2.7b ({zamba['layers']} layers, B "
          f"{SSM_ZAMBA['batch']}) {med['zamba2']:.2f} (xla "
          f"{med['zamba2 xla']:.2f}, idle share {idle['zamba2']}); "
          + ", ".join(f"{a} {e['blockspace']['ms_per_decode_step']:.2f}"
                      for a, e in emb.items())
          + "; train ms/step "
          + ", ".join(f"{a} {t['ms_per_step']:.1f}" for a, t in
                      train.items())
          + f"; phase {out['seconds']:.1f} s ({CARD})")
    return out


def timings(node, path=""):
    """{path: [values]} of every time in a chip_smoke.json tree (a list
    of times under one key, as the serving runs keep them, stays one
    entry); rows of a list are keyed by their case / lowering / rho /
    fuse / rule / domain fields where they have them, and by num_stages
    where it is not 1 (so depth-1 rows pair with an earlier tree's)."""
    out = {}
    if isinstance(node, dict):
        for key, val in node.items():
            timed = key in TIME_KEYS or (key.endswith(TIME_KEY_SUFFIXES)
                                         and not key.startswith("bound"))
            if timed and isinstance(val, (int, float)):
                out[f"{path}/{key}"] = [float(val)]
            elif timed and isinstance(val, list) and val and all(
                    isinstance(x, (int, float)) for x in val):
                out[f"{path}/{key}"] = [float(x) for x in val]
            elif isinstance(val, (dict, list)):
                out.update(timings(val, f"{path}/{key}"))
    elif isinstance(node, list):
        for i, val in enumerate(node):
            tag = i
            if isinstance(val, dict):
                tag = ",".join(str(val[f]) for f in (
                    "name", "case", "arch", "domain", "storage", "lowering",
                    "rho", "coarsen", "fuse", "rule") if f in val) or i
                if val.get("num_stages", 1) != 1:
                    tag = f"{tag},num_stages={val['num_stages']}"
            out.update(timings(val, f"{path}[{tag}]"))
    return out


# ---------------------------------------------------------------------------
# [mesh]: the block-space mesh -- sharded write, sum, CA and flash
# ---------------------------------------------------------------------------

#: per-rank parity (one process, each rank's launch held against its plain
#: version): (fractal, n, block, coarsenings) on D = 2, 3, 4 ranks; the
#: gasket at n 32 block 8 (a 3 x 3 orthotope) leaves rank 3 of 4 no rows
MESH_SHARDS = (2, 3, 4)
MESH_PARITY_CASES = [("sierpinski-gasket", 64, 8, (1, 2)),
                     ("sierpinski-carpet", 81, 3, (1, 3)),
                     ("sierpinski-gasket", 32, 8, (1,))]
MESH_FUSES = (1, 3)
MESH_STAGES = (1, 2)
#: flash per-rank parity: (kind, window, S, block, D, dtype)
MESH_ATTN_CASES = [("causal", 0, 768, 64, 128, torch.bfloat16),
                   ("causal", 0, 768, 64, 64, torch.float32),
                   ("local", 192, 768, 64, 256, torch.bfloat16),
                   ("full", 0, 768, 64, 64, torch.float32)]
#: end to end: D ranks spawned on cuda:0 over gloo
MESH_E2E_SHARDS = (2, 4)
MESH_N, MESH_RHO, MESH_CA_STEPS, MESH_CA_FUSES = 1 << 16, 32, 32, (1, 8)
#: embedded storage replicates the n^2 state on every rank, and the ranks
#: share one card: cut to n = 2^14 (1 GiB a copy)
MESH_EMB_N, MESH_EMB_RHO, MESH_EMB_CA = 1 << 14, 32, dict(steps=4, fuse=2)
#: flash at gemma3-12b's heads
MESH_FLASH = dict(b=1, h=16, hkv=8, s=4096, d=256, block=128)
#: the per-rank timing view of the kernels line: D 4, rank 0
MESH_TIMED_D = 4


def mesh_stand_in(D):
    """A mesh of D ranks for the host geometry (no process group)."""
    import types
    return types.SimpleNamespace(shape={"data": D})


def phase_mesh_parity(TW, TC, FA, F, LOWERINGS, compact_layout, dev):
    """(a) Every rank's sharded write / partials / CA launch held against
    its plain version in one process (D 2, 3, 4; the four lowerings x
    embedded / compact x the coarsenings x fuse {1, 3} x num_stages
    {1, 2}, and the interior / boundary phase launches, both rules, the
    gasket and the carpet), and both tile paths under rows and zigzag."""
    errs = {"sierpinski_write_sharded": 0.0,
            "sierpinski_sum_partials_sharded": 0.0,
            "sierpinski_ca_fused_sharded": 0.0,
            "flash_attention_sharded": 0.0}
    cases = dict.fromkeys(errs, 0)
    rel = 0.0
    for fractal, n, block, coarsenings in MESH_PARITY_CASES:
        spec = F.FRACTALS[fractal]
        lay = compact_layout(TW.resolve_fractal_domain(fractal, n, block))
        emb, packed = member_state(lay, block, n, spec, dev, 7, "integer")
        states = {"parity": member_state(lay, block, n, spec, dev, 8,
                                         "binary"),
                  "diffusion": member_state(lay, block, n, spec, dev, 9,
                                            "normal")}
        shards = MESH_SHARDS if n > 32 else (4,)
        for D in shards:
            for storage in ("embedded", "compact"):
                m = packed if storage == "compact" else emb
                for gm in LOWERINGS:
                    for s in coarsenings:
                        for rank in range(D):
                            kw = dict(block=block, grid_mode=gm,
                                      fractal=fractal, storage=storage, n=n,
                                      domain=None, coarsen=s,
                                      mesh=mesh_stand_in(D),
                                      shard_axis="data", rank=rank)
                            view, n_, blk = TW.shard_plan(m, **kw)
                            local = view.slab(m, blk) \
                                if storage == "compact" else m
                            merge_err(errs, TW.check_shard_against_plain(
                                local, 2.5, view, n_, blk))
                            cases["sierpinski_write_sharded"] += 1
                            cases["sierpinski_sum_partials_sharded"] += 1
                            cv, _, _ = TW.shard_plan(
                                m, **{**kw, "halo": storage == "compact"})
                            for rule, (e_state, p_state) in states.items():
                                x = p_state if storage == "compact" \
                                    else e_state
                                a = cv.extended(x, blk) \
                                    if storage == "compact" else x
                                b = torch.zeros_like(a)
                                views = [(cv, MESH_STAGES)]
                                if (storage == "compact" and gm != "bounding"
                                        and cv.phase_tables_host()
                                        is not None):
                                    views += [(cv.phase_view(w), (2,)) for w
                                              in ("interior", "boundary")]
                                for fuse in MESH_FUSES:
                                    if fuse > s * blk:
                                        continue
                                    for v_, stages in views:
                                        for st in stages:
                                            TC.check_ca_shard_against_plain(
                                                a, b, v_, n_, blk, fuse,
                                                fuse, rule, CA_ALPHA, st)
                                            cases["sierpinski_ca_fused"
                                                  "_sharded"] += 1
    for kind, window, s, blk, d, dtype in MESH_ATTN_CASES:
        for D in MESH_SHARDS:
            if (s // blk) % D:
                continue
            q, k, v = attn_inputs([(1, 4, s, d), (1, 2, s, d),
                                   (1, 2, s, d)], dtype, 11, dev)
            for gm in LOWERINGS:
                sched = FA.flash_schedule(q.shape, k.shape, kind=kind,
                                          window=window, block_q=blk,
                                          block_k=blk, grid_mode=gm)
                for balance in ("contiguous", "zigzag"):
                    if balance == "zigzag" and (
                            kind != "causal" or (s // blk) % (2 * D)):
                        continue
                    for rank in range(D):
                        band = FA.shard_band(sched, D, rank, balance)
                        err, got = FA.check_flash_shard_against_plain(
                            FA.band_queries(q, sched, band), k, v, sched,
                            band)
                        errs["flash_attention_sharded"] = max(
                            errs["flash_attention_sharded"], err)
                        if dtype == torch.bfloat16:
                            rel = max(rel, FA.row_rel_err(
                                got, FA.flash_attention_plain(
                                    FA.band_queries(q, sched, band), k, v,
                                    sched, rows=torch.from_numpy(
                                        band.rows()))))
                        cases["flash_attention_sharded"] += 1
    torch.cuda.synchronize()
    print(f"[mesh] per-rank parity: {json.dumps(cases)} launches against "
          f"their plain versions, max |err| {json.dumps(errs)}, bf16 row "
          f"error {rel:.3g} (bound {FA.ROW_RTOL[torch.bfloat16]})")
    return errs, cases, rel


def mesh_rank(rank, world, cfg):
    """The body of one spawned rank of the end-to-end run: the port's
    entry points with ``mesh=`` at the paper's size, each held bit-equal
    to the unsharded kernels' result on the same card; returns the
    rank's report (its launches, bytes, times and peak memory)."""
    sys.path.insert(0, cfg["src"])
    import importlib
    from repro_torch.core import fractal as F
    from repro_torch.core.compact import compact_layout
    from repro_torch.core.shard import ShardedPlan
    from repro_torch.distributed import collectives
    from repro_torch.launch import mesh as M
    TW = importlib.import_module("repro_torch.kernels.sierpinski_write")
    TC = importlib.import_module("repro_torch.kernels.sierpinski_ca")
    FA = importlib.import_module("repro_torch.kernels.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = M.make_mesh((world, 1), M.AXES)
    dev = M.mesh_device(mesh)
    group = M.axis_group(mesh, "data")
    rep = {"rank": rank, "device": str(dev)}
    n, rho = cfg["n"], cfg["rho"]
    lay = compact_layout(TW.resolve_fractal_domain("sierpinski-gasket", n,
                                                   rho))
    shape = lay.array_shape(rho)
    mask = packed_gasket_mask(lay, rho, n, F, dev)
    g = torch.Generator(device=dev)
    kw = dict(block=rho, grid_mode="closed_form", storage="compact", n=n)
    for mod in (TW, TC, FA):
        mod.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    collectives.TRAFFIC.reset()

    def wall(fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, (time.perf_counter() - t0) * 1e3

    # -- write and sum, compact: each rank's slab -------------------------
    m = torch.zeros(shape, dtype=torch.float32, device=dev)
    _, rep["write_ms"] = wall(lambda: TW.sierpinski_write_(m, 1.0, mesh=mesh,
                                                           **kw))
    want = TW.sierpinski_write_(torch.zeros_like(m), 1.0, **kw)
    rep["write_equal"] = bool(torch.equal(m, want))
    del m, want
    torch.cuda.empty_cache()  # the ranks share one card: free as we go
    x = torch.where(mask, torch.randint(-1, 2, shape, generator=g.manual_seed(
        SEED), device=dev).float(), 0)
    s_mesh, rep["sum_ms"] = wall(lambda: TW.sierpinski_sum(x, mesh=mesh,
                                                           **kw))
    s_one = TW.sierpinski_sum(x, **kw)
    rep["sum_equal"] = bool(torch.equal(s_mesh, s_one))
    rep["sum"] = float(s_mesh)
    del x
    torch.cuda.empty_cache()

    # -- the CA, compact: exchange + launch per fused step ----------------
    view = ShardedPlan(lay.domain, "closed_form", storage="compact",
                       backend=dev, mesh=mesh, axis="data", halo=True
                       ).for_rank(rank).bind_block(rho)
    rep["slab_bytes"] = view.local_storage_shape(rho)[0] * shape[1] * 4
    rep["ghost_rows"] = len(view.halo.ghost_rows[rank])
    rep["h_max"] = view.halo.h_max
    rep["ca"] = []
    for rule in ("parity", "diffusion"):
        x = torch.where(mask, torch.randint(0, 2, shape, generator=g.manual_seed(
            SEED + 1), device=dev).float(), 0) if rule == "parity" else \
            torch.where(mask, torch.randn(shape, generator=g.manual_seed(
                SEED + 2), device=dev), 0)
        stale = torch.zeros_like(x)
        for fuse in cfg["fuses"]:
            # the interior / boundary overlap at fuse > 1 (a ring of 2)
            ca_kw = dict(fuse=fuse, rule=rule, alpha=CA_ALPHA,
                         num_stages=2 if fuse > 1 else 1, **kw)
            launches = len(TC.launch_schedule(cfg["steps"], fuse))
            got, t_mesh = wall(lambda: TC.ca_run(x, stale, cfg["steps"],
                                                 mesh=mesh, **ca_kw))
            ref, t_one = wall(lambda: TC.ca_run(x, stale, cfg["steps"],
                                                donate=False, **ca_kw))
            rep["ca"].append({
                "rule": rule, "fuse": fuse, "launches": launches,
                "num_stages": ca_kw["num_stages"],
                "equal": bool(torch.equal(got, ref)),
                "wall_ms": t_mesh, "unsharded_wall_ms": t_one,
                "wall_ms_per_launch": t_mesh / launches,
                "unsharded_wall_ms_per_launch": t_one / launches})
            del got, ref
            torch.cuda.empty_cache()
        del x, stale
    # -- embedded storage, cut: the replicated state, masked combines -----
    ne, rhoe = cfg["emb_n"], cfg["emb_rho"]
    ekw = dict(block=rhoe, grid_mode="closed_form")
    me = torch.zeros((ne, ne), dtype=torch.float32, device=dev)
    TW.sierpinski_write_(me, 1.0, mesh=mesh, **ekw)
    rep["emb_write_equal"] = bool(torch.equal(
        me, TW.sierpinski_write_(torch.zeros_like(me), 1.0, **ekw)))
    torch.cuda.empty_cache()
    rep["emb_sum_equal"] = bool(torch.equal(
        TW.sierpinski_sum(me, mesh=mesh, **ekw), TW.sierpinski_sum(me, **ekw)))
    ca = cfg["emb_ca"]
    ckw = dict(fuse=ca["fuse"], rule="parity", num_stages=1, **ekw)
    got = TC.ca_run(me, torch.zeros_like(me), ca["steps"], mesh=mesh, **ckw)
    ref = TC.ca_run(me, torch.zeros_like(me), ca["steps"], donate=False,
                    **ckw)
    rep["emb_ca_equal"] = bool(torch.equal(got, ref))
    del me, got, ref
    torch.cuda.empty_cache()

    # -- flash at gemma3-12b's heads: rows and zigzag ---------------------
    fl = cfg["flash"]
    q, k, v = attn_inputs([(fl["b"], fl["h"], fl["s"], fl["d"]),
                           (fl["b"], fl["hkv"], fl["s"], fl["d"]),
                           (fl["b"], fl["hkv"], fl["s"], fl["d"])],
                          torch.bfloat16, 21, dev)
    fkw = dict(kind="causal", block_q=fl["block"], block_k=fl["block"])
    one = FA.flash_attention(q, k, v, **fkw)
    for balance in ("contiguous", "zigzag"):
        got, t = wall(lambda: FA.flash_attention(q, k, v, mesh=mesh,
                                                 shard_balance=balance,
                                                 **fkw))
        rep[f"flash_{balance}_equal"] = bool(torch.equal(got, one))
        rep[f"flash_{balance}_ms"] = t
    del q, k, v, one, got
    torch.cuda.empty_cache()
    # the main path's launches end here: the timing below launches the
    # sharded CA too, and is not counted
    torch.cuda.synchronize(dev)
    rep["launches"] = {**TW.launch_counts(), **TC.launch_counts(),
                       **FA.launch_counts(), **TW.shard_launch_counts(),
                       **TC.shard_launch_counts(), **FA.shard_launch_counts()}
    rep["traffic"] = collectives.TRAFFIC.as_dict()

    # -- the exchange and the rank's launch alone: one fuse-8 step of the
    # parity state
    rows = view.rpd * view.row_unit
    x = torch.where(mask, torch.randint(0, 2, shape, generator=g.manual_seed(
        SEED + 1), device=dev).float(), 0)
    a = x.new_zeros(view.extended_shape(rho))
    a[:rows] = view.slab(x, rho)
    b = torch.zeros_like(a)
    del x
    fuse = max(cfg["fuses"])
    ex_ms = []
    for _ in range(5):
        before = collectives.TRAFFIC.as_dict()
        dist_barrier(group)
        t0 = time.perf_counter()
        view.halo.exchange(view, a[:rows], rank, fuse, group, out=a[rows:])
        torch.cuda.synchronize(dev)
        ex_ms.append((time.perf_counter() - t0) * 1e3)
        after = collectives.TRAFFIC.as_dict()
    rep["exchange_ms"] = statistics.median(ex_ms)
    rep["exchange_traffic"] = {k: after[k] - before[k] for k in after}
    rep["bytes_exchanged"] = view.halo.bytes_exchanged(view, rho, fuse)
    dist_barrier(group)
    rep["launch_ms"] = time_ms(lambda: TC.ca_rank(
        a, b, view, n, rho, fuse, fuse, "parity", CA_ALPHA, 1), reps=5)
    # the overlapped step's pieces (num_stages 2): the interior and the
    # boundary launch alone, and the exchange with the interior launch in
    # flight, then the boundary launch (host clock)
    iv, bv = view.phase_view("interior"), view.phase_view("boundary")
    for name, v in (("interior_ms", iv), ("boundary_ms", bv)):
        dist_barrier(group)
        rep[name] = time_ms(lambda: TC.ca_rank(
            a, b, v, n, rho, fuse, fuse, "parity", CA_ALPHA, 2), reps=5)

    def overlapped():
        view.halo.exchange(view, a[:rows], rank, fuse, group, out=a[rows:],
                           between=lambda: TC.ca_rank(
                               a, b, iv, n, rho, fuse, fuse, "parity",
                               CA_ALPHA, 2))
        TC.ca_rank(a, b, bv, n, rho, fuse, fuse, "parity", CA_ALPHA, 2)
    steps_ms = []
    for _ in range(3):
        dist_barrier(group)
        steps_ms.append(wall(overlapped)[1])
    rep["overlapped_step_ms"] = statistics.median(steps_ms)
    del a, b, mask
    torch.cuda.empty_cache()

    rep["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return rep


def dist_barrier(group):
    import torch.distributed as dist
    dist.barrier(group=group)


def phase_mesh_e2e(dev):
    """(b) D = 2 and 4 ranks spawned on cuda:0 over gloo: the port's
    entry points with ``mesh=`` at the paper's size, each bit-equal to
    the unsharded kernels on the same card."""
    from repro_torch.launch import mesh as M
    cfg = dict(src=str(ROOT / "src"), n=MESH_N, rho=MESH_RHO,
               steps=MESH_CA_STEPS, fuses=MESH_CA_FUSES, emb_n=MESH_EMB_N,
               emb_rho=MESH_EMB_RHO, emb_ca=MESH_EMB_CA, flash=MESH_FLASH)
    out = {}
    for D in MESH_E2E_SHARDS:
        t0 = time.perf_counter()
        reps = M.run_ranks(mesh_rank, D, cfg, threads=0, timeout=900)
        secs = time.perf_counter() - t0
        for r in reps:
            oks = {k: v for k, v in r.items() if k.endswith("_equal")}
            oks.update({f"ca {c['rule']} fuse {c['fuse']}": c["equal"]
                        for c in r["ca"]})
            check(all(oks.values()), f"[mesh] D={D} rank {r['rank']}: a "
                  f"sharded result differs from the unsharded kernels': "
                  f"{oks}")
            print(f"[mesh] D={D} rank {r['rank']} ({r['device']}): slab "
                  f"{r['slab_bytes']} B, ghost rows {r['ghost_rows']} "
                  f"(h_max {r['h_max']}), exchange at fuse "
                  f"{max(MESH_CA_FUSES)}: {r['exchange_ms']:.3f} ms host, "
                  f"{json.dumps(r['exchange_traffic'])} B (plan: "
                  f"{json.dumps(r['bytes_exchanged'])} over the mesh), "
                  f"launch {r['launch_ms']:.4f} ms (interior "
                  f"{r['interior_ms']:.4f}, boundary {r['boundary_ms']:.4f}; "
                  f"an overlapped step {r['overlapped_step_ms']:.3f} ms "
                  f"host), peak "
                  f"{r['peak_bytes'] / 2**30:.2f} GiB; traffic "
                  f"{json.dumps(r['traffic'])}")
        for c0 in reps[0]["ca"]:
            rows = [c for r in reps for c in r["ca"]
                    if (c["rule"], c["fuse"]) == (c0["rule"], c0["fuse"])]
            print(f"[mesh] D={D} ca {c0['rule']} fuse {c0['fuse']} "
                  f"(num_stages {c0['num_stages']}): {c0['launches']} "
                  f"launches in {max(c['wall_ms'] for c in rows):.1f} ms "
                  f"(slowest rank, host; the slabs' copies and their final "
                  f"gather included), "
                  f"{max(c['wall_ms_per_launch'] for c in rows):.3f} ms a "
                  f"launch; unsharded {min(c['unsharded_wall_ms'] for c in rows):.1f}"
                  f" ms on the same card, the ranks' at once; bit-equal")
        launches = {k: sum(r["launches"][k] for r in reps)
                    for k in reps[0]["launches"]}
        print(f"[mesh] D={D}: write {reps[0]['write_ms']:.1f} ms, sum "
              f"{reps[0]['sum_ms']:.1f} ms (= {reps[0]['sum']}), flash rows "
              f"{reps[0]['flash_contiguous_ms']:.1f} ms, zigzag "
              f"{reps[0]['flash_zigzag_ms']:.1f} ms (host, every result "
              f"bit-equal); launches {json.dumps(launches)}; "
              f"{secs:.1f} s")
        out[str(D)] = {"ranks": reps, "launches": launches, "seconds": secs}
    return out


def phase_mesh_shapes(TW, TC, FA, compact_layout, F, dev):
    """Every rank's sharded launch at the shapes the end-to-end runs give
    it (D 2 and 4), held against its plain version on the same inputs:
    write and partials on the rank's compact slab (the integer-valued
    state of the sum), the CA on its extended buffers (fuse 1 parity on
    every rank; rank 0 of 4 also the fuse-8 diffusion launch through the
    interior and boundary phases at num_stages 2), the embedded cut's
    write / partials / fuse-2 CA on the replicated state, and every
    rank's flash band at gemma3-12b's heads under rows and zigzag.
    Write, partials and CA bit-equal, flash within its tolerances."""
    errs = {"sierpinski_write_sharded": 0.0,
            "sierpinski_sum_partials_sharded": 0.0,
            "sierpinski_ca_fused_sharded": 0.0,
            "flash_attention_sharded": 0.0}
    cases = dict.fromkeys(errs, 0)
    n, rho = MESH_N, MESH_RHO
    lay = compact_layout(TW.resolve_fractal_domain("sierpinski-gasket", n,
                                                   rho))
    shape = lay.array_shape(rho)
    mask = packed_gasket_mask(lay, rho, n, F, dev)
    g = torch.Generator(device=dev)
    xi = torch.where(mask, torch.randint(-1, 2, shape, generator=g.manual_seed(
        SEED), device=dev).float(), 0)
    xp = torch.where(mask, torch.randint(0, 2, shape, generator=g.manual_seed(
        SEED + 1), device=dev).float(), 0)
    xd = torch.where(mask, torch.randn(shape, generator=g.manual_seed(
        SEED + 2), device=dev), 0)
    del mask
    kw = dict(block=rho, grid_mode="closed_form", fractal="sierpinski-gasket",
              storage="compact", n=n, domain=None, coarsen=1,
              shard_axis="data")
    fuse = max(MESH_CA_FUSES)
    for D in MESH_E2E_SHARDS:
        for rank in range(D):
            rk = dict(kw, mesh=mesh_stand_in(D), rank=rank)
            view, _, _ = TW.shard_plan(xi, **rk)
            merge_err(errs, TW.check_shard_against_plain(
                view.slab(xi, rho), 1.0, view, n, rho))
            cases["sierpinski_write_sharded"] += 1
            cases["sierpinski_sum_partials_sharded"] += 1
            cv, _, _ = TW.shard_plan(xi, **rk, halo=True)
            a = cv.extended(xp, rho)
            TC.check_ca_shard_against_plain(a, torch.zeros_like(a), cv, n,
                                            rho, 1, 1, "parity", CA_ALPHA, 1)
            cases["sierpinski_ca_fused_sharded"] += 1
            if (D, rank) == (MESH_TIMED_D, 0):
                a = cv.extended(xd, rho)
                for w in ("interior", "boundary"):
                    TC.check_ca_shard_against_plain(
                        a, torch.zeros_like(a), cv.phase_view(w), n, rho,
                        fuse, fuse, "diffusion", CA_ALPHA, 2)
                    cases["sierpinski_ca_fused_sharded"] += 1
            del a
    del xi, xp, xd
    torch.cuda.empty_cache()
    ne, rhoe = MESH_EMB_N, MESH_EMB_RHO
    me = random_state(ne, torch.float32, SEED + 3, True, dev)
    ca = MESH_EMB_CA
    for D in MESH_E2E_SHARDS:
        for rank in range(D):
            view, _, _ = TW.shard_plan(
                me, block=rhoe, grid_mode="closed_form",
                fractal="sierpinski-gasket", storage="embedded", n=ne,
                domain=None, coarsen=1, mesh=mesh_stand_in(D),
                shard_axis="data", rank=rank)
            merge_err(errs, TW.check_shard_against_plain(me, 1.0, view, ne,
                                                         rhoe))
            TC.check_ca_shard_against_plain(
                me, torch.zeros_like(me), view, ne, rhoe, ca["fuse"],
                ca["fuse"], "parity", CA_ALPHA, 1)
            for name in ("sierpinski_write_sharded",
                         "sierpinski_sum_partials_sharded",
                         "sierpinski_ca_fused_sharded"):
                cases[name] += 1
    del me
    torch.cuda.empty_cache()
    fl = MESH_FLASH
    q, k, v = attn_inputs([(fl["b"], fl["h"], fl["s"], fl["d"]),
                           (fl["b"], fl["hkv"], fl["s"], fl["d"]),
                           (fl["b"], fl["hkv"], fl["s"], fl["d"])],
                          torch.bfloat16, 21, dev)
    sched = FA.flash_schedule(q.shape, k.shape, kind="causal",
                              block_q=fl["block"], block_k=fl["block"])
    rel = 0.0
    for D in MESH_E2E_SHARDS:
        for balance in ("contiguous", "zigzag"):
            for rank in range(D):
                band = FA.shard_band(sched, D, rank, balance)
                qb = FA.band_queries(q, sched, band)
                err, got = FA.check_flash_shard_against_plain(qb, k, v, sched,
                                                              band)
                errs["flash_attention_sharded"] = max(
                    errs["flash_attention_sharded"], err)
                rel = max(rel, FA.row_rel_err(got, FA.flash_attention_plain(
                    qb, k, v, sched, rows=torch.from_numpy(band.rows()))))
                cases["flash_attention_sharded"] += 1
    torch.cuda.synchronize()
    print(f"[mesh] every rank at the end-to-end shapes (D "
          f"{list(MESH_E2E_SHARDS)}): {json.dumps(cases)} launches against "
          f"their plain versions, max |err| {json.dumps(errs)}, bf16 row "
          f"error {rel:.3g} (bound {FA.ROW_RTOL[torch.bfloat16]})")
    return errs, cases, rel


def phase_mesh_times(TW, TC, FA, compact_layout, F, dev):
    """The sharded kernels' times for the kernels line: rank 0 of
    MESH_TIMED_D at the end-to-end sizes, one process, beside its plain
    version, its bound and a library call."""
    n, rho, D = MESH_N, MESH_RHO, MESH_TIMED_D
    lay = compact_layout(TW.resolve_fractal_domain("sierpinski-gasket", n,
                                                   rho))
    shape = lay.array_shape(rho)
    mask = packed_gasket_mask(lay, rho, n, F, dev)
    kw = dict(block=rho, grid_mode="closed_form", fractal="sierpinski-gasket",
              storage="compact", n=n, domain=None, coarsen=1,
              mesh=mesh_stand_in(D), shard_axis="data", rank=0)
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.where(mask, torch.randint(0, 2, shape, generator=g,
                                        device=dev).float(), 0)
    view, _, _ = TW.shard_plan(x, **kw)
    local = view.slab(x, rho).clone()
    lmask = view.slab(mask, rho)
    members = int(lmask.sum())
    p = view.launch_params(n, rho, dev)
    out = {}
    nb = members * 4
    out["sierpinski_write_sharded"] = dict(
        ms=time_ms(lambda: TW.write_shard_cuda(local, 1.0, p, view), 5),
        plain_ms=time_ms(lambda: TW.sierpinski_write_plain(
            local, 1.0, view, n, rho), 2),
        library_ms=time_ms(lambda: local.masked_fill_(lmask, 1.0), 5),
        bound=bound(nb))
    out["sierpinski_sum_partials_sharded"] = dict(
        ms=time_ms(lambda: TW.sum_partials_shard_cuda(local, p, view), 5),
        plain_ms=time_ms(lambda: TW.sum_partials_plain(local, view, n, rho),
                         2),
        library_ms=time_ms(lambda: torch.masked.sum(local, mask=lmask), 5),
        bound=bound(nb + view.steps_per_launch * 4))
    cv, _, _ = TW.shard_plan(x, **{**kw, "halo": True})
    a = cv.extended(x, rho)
    b = torch.zeros_like(a)
    cp = cv.launch_params(n, rho, dev)
    ghosts = len(cv.halo.ghost_rows[0]) * cv.row_unit * shape[1] * 4
    out["sierpinski_ca_fused_sharded"] = dict(
        ms=time_ms(lambda: TC.ca_shard_cuda(a, b, cp, cv, 1, 1, "parity",
                                            CA_ALPHA, 1), 5),
        plain_ms=time_ms(lambda: TC.ca_launch_plain(
            a, b, cv, n, rho, 1, 1, "parity", CA_ALPHA), 1),
        library_ms=None,
        bound=bound(2 * view.local_storage_shape(rho)[0] * shape[1] * 4
                    + ghosts))
    del x, local, a, b, mask, lmask
    fl = MESH_FLASH
    q, k, v = attn_inputs([(fl["b"], fl["h"], fl["s"], fl["d"]),
                           (fl["b"], fl["hkv"], fl["s"], fl["d"]),
                           (fl["b"], fl["hkv"], fl["s"], fl["d"])],
                          torch.bfloat16, 21, dev)
    sched = FA.flash_schedule(q.shape, k.shape, kind="causal",
                              block_q=fl["block"], block_k=fl["block"])
    band = FA.shard_band(sched, D, 0, "zigzag")
    qb = FA.band_queries(q, sched, band)
    rows = band.rows()
    qpos = (torch.from_numpy(rows).to(dev)[:, None] * fl["block"]
            + torch.arange(fl["block"], device=dev)).reshape(-1)
    amask = qpos[:, None] >= torch.arange(fl["s"], device=dev)[None, :]
    kr = k.repeat_interleave(fl["h"] // fl["hkv"], 1)
    vr = v.repeat_interleave(fl["h"] // fl["hkv"], 1)
    pairs = int(amask.sum())
    nbytes = 2 * (qb.numel() + k.numel() + v.numel() + qb.numel())
    nops = 4 * pairs * fl["d"] * fl["b"] * fl["h"]
    t_b, by, _ = attn_bound(nbytes, nops, torch.bfloat16, "tc")
    out["flash_attention_sharded"] = dict(
        ms=time_ms(lambda: FA.flash_shard_cuda(qb, k, v, sched, band), 5),
        plain_ms=time_ms(lambda: FA.flash_attention_plain(
            qb, k, v, sched, rows=torch.from_numpy(rows)), 1),
        library_ms=time_ms(lambda: torch.nn.functional
                           .scaled_dot_product_attention(qb, kr, vr,
                                                         attn_mask=amask),
                           5),
        bound=(t_b, by))
    for name, r in out.items():
        t_b, by = r.pop("bound")
        r.update(bound_ms=t_b, bound_by=by)
        print(f"[mesh] {name} (rank 0 of {D}): {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {t_b:.4f} ms ({by}), library "
              f"{r['library_ms']} ms")
    return out


def phase_mesh(TW, TC, FA, RC, F, LOWERINGS, compact_layout, dev):
    """The [mesh] phase: (a) per-rank parity, (b) end to end on 2 and 4
    spawned ranks, drop_halo detected and recovered on the card, every
    rank's sharded launches at the end-to-end shapes against their plain
    versions, and the sharded kernels' times."""
    t0 = time.perf_counter()
    errs, cases, rel = phase_mesh_parity(TW, TC, FA, F, LOWERINGS,
                                         compact_layout, dev)
    t_par = time.perf_counter() - t0
    free_card()  # the spawned ranks share the card with this process
    print(f"[mesh] this process holds "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB before spawning")
    e2e = phase_mesh_e2e(dev)
    t_e2e = time.perf_counter() - t0 - t_par
    halo = RC.scenario_drop_halo(SEED, True, device="cuda")
    print(f"[mesh] drop_halo on 2 ranks of the card: {json.dumps(halo)}")
    check(halo["status"] == "recovered" and halo["detected"]
          and halo["bit_identical"], f"drop_halo on the card: {halo}")
    t1 = time.perf_counter()
    shape_errs, shape_cases, shape_rel = phase_mesh_shapes(
        TW, TC, FA, compact_layout, F, dev)
    t_shapes = time.perf_counter() - t1
    times = phase_mesh_times(TW, TC, FA, compact_layout, F, dev)
    secs = time.perf_counter() - t0
    print(f"[mesh] phase {secs:.1f} s (parity {t_par:.1f} s, end to end "
          f"{t_e2e:.1f} s, end-to-end shapes against the plain versions "
          f"{t_shapes:.1f} s)")
    return {"parity_max_abs_err": errs, "parity_cases": cases,
            "parity_max_row_rel_err": rel, "e2e": e2e, "drop_halo": halo,
            "shapes_max_abs_err": shape_errs, "shapes_cases": shape_cases,
            "shapes_max_row_rel_err": shape_rel, "times": times,
            "card": CARD, "seconds": secs}


def mesh_kernel_entries(kernels, mesh):
    """The kernels line's sharded entries: launches summed over the
    end-to-end runs' ranks (their counted runs only), errors the larger
    of the per-rank parity's and the end-to-end shapes' checks, times
    from phase_mesh_times."""
    sources = {"sierpinski_write_sharded": (
        "src/repro_torch/csrc/sierpinski_write.cu",
        "src/repro/kernels/sierpinski_write.py:171"),
        "sierpinski_sum_partials_sharded": (
            "src/repro_torch/csrc/sierpinski_write.cu",
            "src/repro/kernels/sierpinski_write.py:418"),
        "sierpinski_ca_fused_sharded": (
            "src/repro_torch/csrc/sierpinski_ca.cu",
            "src/repro/kernels/sierpinski_ca.py:212"),
        "flash_attention_sharded": (
            "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:103")}
    for name, (source, replaces) in sources.items():
        t = mesh["times"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(e["launches"][name]
                            for e in mesh["e2e"].values()),
            "max_abs_err": max(mesh["parity_max_abs_err"][name],
                               mesh["shapes_max_abs_err"][name]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "at": f"rank 0 of {MESH_TIMED_D}: the compact gasket at "
                  f"n={MESH_N} rho={MESH_RHO} (flash: gemma3-12b causal S "
                  f"{MESH_FLASH['s']} bf16, the zigzag band)",
            "parity_cases": mesh["parity_cases"][name],
            "shapes_cases": mesh["shapes_cases"][name],
            "shapes_max_abs_err": mesh["shapes_max_abs_err"][name],
            "launches_by_shards": {D: e["launches"][name]
                                   for D, e in mesh["e2e"].items()}})


# ---------------------------------------------------------------------------
# [serve-mesh]: the serving mesh (tensor parallelism over 'model', the
# decode kernels' slots over 'data') on ranks spawned on cuda:0 over gloo
# ---------------------------------------------------------------------------

#: gemma3-12b at full width cut to 6 of its 48 layers (SERVE_RUNS[1]: one
#: 5:1 local:global period; bf16 compute, f32 parameters, 13.4 GB), the
#: serve cell's traffic (batch 4, prompt 1536, 16 new, greedy), served on
#: each (data, model) mesh of ranks; PagedServer on the meshes of
#: SERVE_MESH_PAGED with FAM_PAGED's 8 mixed requests (64..512 tokens),
#: 4 slots, 16-token pages
SERVE_MESH_SHAPES = ((2, 1), (1, 2), (2, 2))
SERVE_MESH_PAGED = ((2, 1), (1, 2))
#: a quickstart checkpoint (full width, f32) restore(shardings=)d onto 1x2
#: and elastic_restore'd onto 3 ranks ((3, 1): 32768 does not tile 3),
#: served at a batch of 6 (which tiles 1, 2 and 3 slot groups)
SERVE_MESH_RESTORE = dict(batch=6, prompt=128, max_new=16, max_len=256)
#: step logits of a mesh run against the single-device run on the same
#: weights, and the top-2 margin at or below which a greedy token may
#: differ (SERVE_TOL's, per compute dtype).  bf16 under tensor
#: parallelism: each rank's partial wo / MLP product is rounded to bf16
#: before the f32 sum over the ranks, where one device rounds the whole
#: sum once, so the residual stream moves by ~2**-8 relative a layer, as
#: the kernel decode against the plain decode does
SERVE_MESH_TOL = SERVE_TOL
#: the device type of the spawned ranks
SERVE_MESH_DEVICE = "cuda"
#: a mesh run's medians a decode step (step_stats), printed for each mesh
SERVE_MESH_STEP_KEYS = ("ms_per_decode_step", "collective_calls_per_step",
                        "collective_bytes_sent_per_step",
                        "staged_bytes_per_step", "collective_ms_per_step")


def slot_slice(mesh, M, b):
    """This rank's slot group of a batch of ``b`` on ``mesh`` (the whole
    batch when the data axis does not shard it)."""
    d = M.axis_size(mesh, "data")
    if d == 1 or b % d:
        return slice(0, b)
    r = M.axis_rank(mesh, "data")
    return slice(r * (b // d), (r + 1) * (b // d))


@contextlib.contextmanager
def recording_calls(TA, name):
    """While in the block, keep the arguments of every call of
    ``TA.<name>``; after it, ``calls`` maps each effective ``window``
    (the local and the global layers) to the arguments of its call with
    the most slots past position 0 (the latest such): the decode launch
    the phase then repeats at the path's shape."""
    real, seen, calls = getattr(TA, name), [], {}

    def wrapped(*args, **kw):
        window = kw.get("window", 0) if kw.get("kind", "local") == "local" \
            else 0
        seen.append((window, args))
        return real(*args, **kw)
    setattr(TA, name, wrapped)
    try:
        yield calls
    finally:
        setattr(TA, name, real)
        best = {}
        for window, args in seen:
            live = int((torch.as_tensor(args[3]) > 0).sum())
            if live >= best.get(window, -1):
                best[window] = live
                calls[window] = (args, live)


def rank_decode_rows(FA, flash_calls, paged_calls, sl, psl, timed):
    """Each recorded decode call's launch on this rank's slot group (``sl``
    of the Server's batch, ``psl`` of the PagedServer's slots), held
    against its plain version (bf16: 2e-2 and ROW_RTOL), and with
    ``timed`` timed beside the plain version, the byte bound and
    scaled_dot_product_attention over the same rows: {kernel name:
    [row per window]}."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {"flash_attention_decode": [], "paged_flash_attention": []}
    for window, (args, _) in sorted(flash_calls.items()):
        q, k, v, pos = args
        b = q.shape[0]
        pv = torch.as_tensor(pos, device=q.device).to(torch.int32) \
            .reshape(-1).expand(b)[sl].contiguous()
        q, k, v = q[sl], k[sl], v[sl]
        # a slot group is a leading slice of the caches and a TP rank's
        # heads are tensors of its own: the entry point copies nothing
        views = all(t.is_contiguous() for t in (q, k, v))
        sched = FA.flash_schedule(q.shape, k.shape, kind="full",
                                  window=window, block_q=1, block_k=128,
                                  has_pos=True)
        err, _ = FA.check_flash_against_plain(q, k, v, sched, pv)
        run = lambda: FA.flash_cuda(q, k, v, sched, pv)  # noqa: E731
        plain = lambda: FA.flash_attention_plain(q, k, v, sched, pv)  # noqa
        out["flash_attention_decode"].append({**_decode_row(
            run, plain, q, k, v, pv, window, err, sdpa, timed),
            "views_contiguous": views})
    for window, (args, _) in sorted(paged_calls.items()):
        q, pool, table, pos = args
        pv = torch.as_tensor(pos, device=q.device).to(torch.int32) \
            .reshape(-1).expand(q.shape[0])[psl].contiguous()
        q = q[psl]
        table = torch.as_tensor(table, device=q.device).to(
            torch.int32)[psl].contiguous()
        psched = FA.paged_schedule(q.shape, pool.shape, table.shape,
                                   window=window)
        err, _ = FA.check_paged_against_plain(q, pool, table, pv, psched)
        from repro_torch.core import paged as P
        k, v = P.gather_kv(pool, table)
        run = lambda: FA.paged_cuda(q, pool, table, pv, psched)  # noqa
        plain = lambda: FA.paged_attention_plain(  # noqa: E731
            q, pool, table, pv, psched)
        out["paged_flash_attention"].append(_decode_row(
            run, plain, q, k, v, pv, window, err, sdpa, timed))
    return out


def _decode_row(run, plain, q, k, v, pv, window, err, sdpa, timed):
    """One decode launch's kernels-line numbers: its shape and error,
    and with ``timed`` its device time, its plain version's, the byte
    bound of the rows it reads and SDPA's on the same rows with a
    boolean mask per row."""
    span = int(pv.max()) + 1
    kpos = torch.arange(span, device=q.device)[None, :]
    live = kpos <= pv[:, None].long()
    if window:
        live &= kpos > pv[:, None].long() - window
    mask = live[:, None, None, :]
    kc, vc = k[:, :, :span].contiguous(), v[:, :, :span].contiguous()
    lib = lambda: sdpa(q, kc, vc, attn_mask=mask,  # noqa: E731
                       enable_gqa=True)
    keys = int(live.sum())
    bound_ms, bound_by = decode_bound(q, k.shape[1], keys)
    row = {"window": window, "q": list(q.shape), "k": list(k.shape),
           "positions": pv.tolist(), "max_abs_err": err,
           "bound_ms": bound_ms, "bound_by": bound_by}
    if not timed:
        return row
    ms, lib_ms = device_ms(run), device_ms(lib)
    by = "torch.profiler device time"
    if ms is None or lib_ms is None:  # no device time in the trace
        ms, lib_ms, by = time_ms(run, 20), time_ms(lib, 20), \
            "CUDA events around one call"
    return {**row, "ms": ms, "library_ms": lib_ms, "ms_by": by,
            "call_ms": time_ms(run, 20), "plain_ms": time_ms(plain, 3)}


def step_stats(stamps, traffic):
    """Medians over the decode steps (consecutive ``on_step`` calls after
    the prefill's) of the host ms a step and of the collectives' calls,
    bytes sent, bytes staged and host ms a step."""
    if len(stamps) < 3:
        return {}
    dt = [1e3 * (b - a) for a, b in zip(stamps[1:], stamps[2:])]
    d = {k: [t1[k] - t0[k] for t0, t1 in zip(traffic[1:], traffic[2:])]
         for k in traffic[0]}
    return {"ms_per_decode_step": statistics.median(dt),
            "ms_per_decode_step_all": dt,
            "collective_calls_per_step": statistics.median(d["calls"]),
            "collective_bytes_sent_per_step": statistics.median(d["sent"]),
            "staged_bytes_per_step": statistics.median(d["staged"]),
            "collective_ms_per_step": 1e3 * statistics.median(
                d["seconds"])}


def mesh_generate(srv, prompts, max_new, collectives):
    """Server.generate with its step logits, the host stamps of its steps
    and the collectives' counters at each."""
    steps, stamps, traffic = [], [], []

    def on_step(pos, lg):
        stamps.append(time.perf_counter())
        traffic.append(collectives.TRAFFIC.as_dict())
        steps.append(lg[:, 0].float())
    toks = srv.generate(prompts, max_new, on_step=on_step)
    return toks, torch.stack(steps, 1), step_stats(stamps, traffic)


def same_everywhere(t, group=None):
    import torch.distributed as dist
    first = t.clone()
    dist.broadcast(first, 0, group=group)
    return bool(torch.equal(first, t))


def serve_mesh_rank(rank, world, c):
    """One rank of a [serve-mesh] world: gemma3-12b laid out on the
    mesh (built one rank at a time: each rank holds the full 13.4 GB
    model only until it keeps its pieces), the Server counted (its
    launches, slot-group calls, collectives a step, ms a step), the
    PagedServer on the same model counted, every recorded decode launch
    on this rank's slot group held against its plain version and timed
    (the ranks in turn), and on the 1x2 mesh the quickstart checkpoint
    restore(shardings=)d and served.  Rank 0 returns the step logits."""
    sys.path.insert(0, c["src"])
    import importlib

    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as M
    from repro_torch.launch import serve as S
    from repro_torch.models import attention as TA
    from repro_torch.models import model as TM
    FA = importlib.import_module("repro_torch.kernels.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shape = tuple(c["shape"])
    mesh = M.make_mesh(shape, M.AXES, device=SERVE_MESH_DEVICE)
    dev = M.mesh_device(mesh)
    cfg = get_config(c["arch"]).replace(**c["cut"],
                                        attn_decode_kernel="blockspace")
    rep = {"rank": rank, "shape": list(shape), "device": str(dev),
           "data_rank": M.axis_rank(mesh, "data"),
           "model_rank": M.axis_rank(mesh, "model")}
    t0 = time.perf_counter()
    model = None
    for r in range(world):
        if r == rank:
            model = TM.init(cfg, torch.Generator(device=dev).manual_seed(
                SEED), dev)
            SH.shard_model(model, mesh)
            torch.cuda.synchronize(dev)
        dist.barrier()
    rep["build_s"] = time.perf_counter() - t0
    rep["param_bytes"] = sum(p.numel() * p.element_size()
                             for p in model.parameters())
    rep["tp_modules"] = sum(hasattr(m, "_tp") for m in model.modules())
    torch.cuda.reset_peak_memory_stats(dev)
    prompts = np.asarray(c["prompts"])
    b = prompts.shape[0]
    sl = slot_slice(mesh, M, b)

    # -- the Server: the main path, counted --------------------------------
    srv = S.Server(cfg, model, S.ServeConfig(max_len=c["max_len"]),
                   mesh=mesh)
    FA.reset_launch_counts()
    TA.reset_slot_calls()
    collectives.TRAFFIC.reset()
    dist.barrier()
    t1 = time.perf_counter()
    with recording_calls(TA, "decode_attention_flash") as fcalls:
        toks, logits, stats = mesh_generate(srv, prompts, c["max_new"],
                                            collectives)
    torch.cuda.synchronize(dev)
    rep["seconds"] = time.perf_counter() - t1
    rep["launches"] = FA.launch_counts()
    rep["slot_calls"] = dict(TA.SLOT_CALLS)
    rep["traffic"] = collectives.TRAFFIC.as_dict()
    rep.update(stats)
    check_healthy(srv, f"serve-mesh {shape} rank {rank}")
    rep["tokens"] = toks
    rep["tokens_same_on_every_rank"] = same_everywhere(torch.from_numpy(toks))
    ref = np.asarray(c["ref_tokens"])
    if not np.array_equal(toks, ref):
        # a row diverged: the logits of every step with the single-device
        # tokens fed back (the same ranks take the same branch)
        forced = []
        with TA.decode_mesh(mesh):
            lg, cache = TM.prefill(model, torch.as_tensor(prompts,
                                                          device=dev),
                                   max_len=c["max_len"], cfg=cfg)
            forced.append(lg[:, 0].float())
            pos = prompts.shape[1] - 1
            for i in range(1, ref.shape[1]):
                pos += 1
                lg, cache = TM.decode_step(
                    model, torch.as_tensor(ref[:, i - 1:i], device=dev),
                    cache, pos, cfg)
                forced.append(lg[:, 0].float())
        del cache
        if rank == 0:
            rep["forced_logits"] = torch.stack(forced, 1).cpu().numpy()
    if rank == 0:
        rep["logits"] = logits.cpu().numpy()
    del logits
    rep["peak_bytes_serve"] = torch.cuda.max_memory_allocated(dev)

    # -- the PagedServer on the same laid-out model, counted ---------------
    pcalls = {}
    t2 = time.perf_counter()
    if c["paged"]:
        reqs = [np.asarray(r) for r in c["requests"]]
        TA.set_decode_mesh(mesh)
        FA.reset_launch_counts()
        TA.reset_slot_calls()
        collectives.TRAFFIC.reset()
        try:
            psrv = S.PagedServer(cfg, model, S.PagedServeConfig(
                **c["paged_kw"]))
            dist.barrier()
            with recording_calls(TA, "decode_attention_paged") as pcalls:
                prep = S.paged_throughput_report(psrv, reqs,
                                                 max_new=c["max_new"])
            torch.cuda.synchronize(dev)
        finally:
            TA.set_decode_mesh(None)
        check_healthy(psrv, f"serve-mesh paged {shape} rank {rank}")
        rep["paged"] = {
            **prep, "launches": FA.launch_counts(),
            "slot_calls": dict(TA.SLOT_CALLS),
            "traffic": collectives.TRAFFIC.as_dict(),
            "pool_kv_heads": int(psrv.pools[0].shape[1]) // 2,
            "done": {int(k): np.asarray(v) for k, v in psrv.done.items()}}
    rep["paged_s"] = time.perf_counter() - t2

    # -- this rank's decode launches at the path's shapes, against their
    # plain versions; rank 0's timed alone on the card (not counted) ------
    t2 = time.perf_counter()
    psl = slot_slice(mesh, M, c["paged_kw"]["num_slots"])
    rows = rank_decode_rows(FA, fcalls, pcalls, sl, psl, timed=False)
    dist.barrier()
    if rank == 0:
        rows = rank_decode_rows(FA, fcalls, pcalls, sl, psl, timed=True)
    dist.barrier()
    rep["decode_rows"] = rows
    rep["rows_s"] = time.perf_counter() - t2
    rep["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    del srv, model, fcalls, pcalls
    if c["paged"]:
        del psrv
    gc.collect()
    torch.cuda.empty_cache()

    # -- restore(shardings=) of the quickstart checkpoint onto this mesh ---
    if c.get("restore"):
        t2 = time.perf_counter()
        rep["restore"] = restore_and_serve(c, mesh, dev, rank, M, S, SH,
                                           TM, CheckpointManager,
                                           get_config, collectives)
        rep["restore_s"] = time.perf_counter() - t2
    return rep


def restore_and_serve(c, mesh, dev, rank, M, S, SH, TM, CheckpointManager,
                      get_config, collectives, elastic=False):
    """The quickstart checkpoint restored onto ``mesh`` (restore with
    shardings=, or elastic_restore onto the world's elastic mesh) and
    served: tokens (step logits on rank 0), the mesh's shape, whether
    the model holds pieces."""
    r = c["restore_kw"]
    qcfg = get_config("quickstart").replace(attn_decode_kernel="blockspace")
    template = TM.Model(qcfg, dev)
    mgr = CheckpointManager(c["qckpt"], keep=1)
    if elastic:
        from repro_torch.distributed.elastic import elastic_restore
        mesh, _, qm, _ = elastic_restore(mgr, template, qcfg,
                                         device=SERVE_MESH_DEVICE)
    else:
        shardings = SH.named_sharding_tree(
            SH.param_spec_tree(template, qcfg), mesh)
        _, qm, _, _ = mgr.restore(None, template, shardings=shardings)
    srv = S.Server(qcfg, qm, S.ServeConfig(max_len=r["max_len"]), mesh=mesh)
    toks, logits, stats = mesh_generate(srv, np.asarray(c["qprompts"]),
                                        r["max_new"], collectives)
    out = {"tokens": toks, "shape": [M.axis_size(mesh, "data"),
                                     M.axis_size(mesh, "model")],
           "pieces": any(hasattr(p, "_layout") for p in qm.parameters()),
           "tokens_same_on_every_rank": same_everywhere(
               torch.from_numpy(toks)), **stats}
    if rank == 0:
        out["logits"] = logits.cpu().numpy()
    return out


def serve_mesh_elastic_rank(rank, world, c):
    """One rank of the 3-rank world: elastic_restore of the quickstart
    checkpoint onto the elastic mesh, then served."""
    sys.path.insert(0, c["src"])
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as M
    from repro_torch.launch import serve as S
    from repro_torch.models import model as TM
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = M.rank_device(rank, SERVE_MESH_DEVICE)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return restore_and_serve(c, None, dev, rank, M, S, SH, TM,
                             CheckpointManager, get_config, collectives,
                             elastic=True)


def paged_margins(TM, model, reqs, done):
    """Each request's top-2 margin at every token it generated, from one
    forward over its prompt and its generated tokens (the logits with
    its own tokens fed back)."""
    out = {}
    with torch.no_grad():
        for rid, prompt in enumerate(reqs):
            gen = np.asarray(done[rid])
            seq = np.concatenate([prompt, gen[:-1]])[None]
            lg, _ = TM.logits_fn(model, torch.as_tensor(seq,
                                                        device=model.device))
            lg = lg[0, len(prompt) - 1:].float()
            out[rid] = margin(lg).cpu().numpy()
            del lg
    return out


def check_mesh_stream(what, toks, logits, ref_toks, ref_logits, tol,
                      forced=None):
    """A mesh run's stream against the single-device run's: tokens may
    differ only where the single-device top-2 margin is at most ``tol``,
    and the step logits agree within ``tol`` up to each row's first
    differing token (compare_streams); with ``forced`` (the logits of
    every step with the single-device tokens fed back), every step's.
    Returns compare_streams' numbers."""
    diff, ncmp, small, diverged, _ = compare_streams(
        toks, torch.from_numpy(logits), ref_toks, ref_logits, tol, what)
    if forced is not None:
        d = float((torch.from_numpy(forced) - ref_logits).abs().max())
        check(d <= tol, f"{what}: forced step logits differ by {d} > {tol}")
        diff = max(diff, d)
    return {"max_logit_diff": diff, "steps_compared": ncmp,
            "steps_margin_le_tol": small, "rows_diverged": diverged,
            "tokens_equal": bool(np.array_equal(toks, ref_toks)),
            "logits_bit_equal": bool(torch.equal(torch.from_numpy(logits),
                                                  ref_logits))}


def phase_serve_mesh(S, TM, FA, RC, get_config, dev):
    """The [serve-mesh] phase: the single-device runs on the same weights
    first (gemma3-12b Server and PagedServer, the quickstart Server and
    its checkpoint), then each mesh world spawned on cuda:0, the 3-rank
    elastic world, and the SIGTERM scenario onto a 2-rank mesh at
    quickstart width."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import mesh as M
    t_phase = time.perf_counter()
    free_card()
    arch, cut, batch, plen, max_new, max_len = SERVE_RUNS[1]
    cfg = get_config(arch).replace(**cut, attn_decode_kernel="blockspace")
    tol = SERVE_MESH_TOL[cfg.dtype]
    model = TM.init(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    prompts = torch.randint(
        0, cfg.vocab_size, (batch, plen),
        generator=torch.Generator().manual_seed(SEED)).numpy()
    FA.reset_launch_counts()
    toks, logits, secs, step_ms = serve_run(S, cfg, model, prompts, max_new,
                                            max_len, "blockspace")
    one = {"launches": FA.launch_counts(), "seconds": secs,
           "ms_per_decode_step": step_ms,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    logits = logits.cpu()
    c = FAM_PAGED
    rng = np.random.default_rng(SEED)
    reqs = [rng.integers(0, cfg.vocab_size,
                         (int(rng.integers(c["lo"], c["hi"] + 1)),))
            for _ in range(c["requests"])]
    pmax = c["hi"] + c["max_new"]
    paged_kw = dict(max_len=pmax, num_slots=c["slots"], page_size=c["ps"],
                    num_pages=1 + c["slots"] * S.paged_lib.pages_for(
                        pmax, c["ps"]))
    psrv = S.PagedServer(cfg, model, S.PagedServeConfig(**paged_kw))
    one["paged"] = S.paged_throughput_report(psrv, reqs,
                                             max_new=c["max_new"])
    pdone = {rid: np.asarray(v) for rid, v in psrv.done.items()}
    pmargins = paged_margins(TM, model, reqs, pdone)
    del psrv, model
    free_card()
    # the quickstart checkpoint of the restore runs, and its tokens
    r = SERVE_MESH_RESTORE
    qcfg = get_config("quickstart").replace(attn_decode_kernel="blockspace")
    qmodel = TM.init(qcfg, torch.Generator(device=dev).manual_seed(SEED),
                     dev)
    qprompts = torch.randint(
        0, qcfg.vocab_size, (r["batch"], r["prompt"]),
        generator=torch.Generator().manual_seed(SEED + 1)).numpy()
    qtoks, qlogits, _, _ = serve_run(S, qcfg, qmodel, qprompts, r["max_new"],
                                     r["max_len"], "blockspace")
    qlogits = qlogits.cpu()
    qckpt = tempfile.mkdtemp(prefix="serve_mesh_ckpt_")
    atexit.register(shutil.rmtree, qckpt, True)
    CheckpointManager(qckpt, keep=1).save(0, qmodel)
    del qmodel
    free_card()
    print(f"[serve-mesh] single device ({CARD}): gemma3-12b {cfg.n_layers} "
          f"layers, {json.dumps(one)}")
    base = dict(src=str(ROOT / "src"), arch=arch, cut=cut, prompts=prompts,
                max_new=max_new, max_len=max_len, ref_tokens=toks,
                requests=reqs, paged_kw=paged_kw, qckpt=qckpt,
                qprompts=qprompts, restore_kw=r)
    out = {"single_device": one, "card": CARD, "tol": tol, "meshes": {}}
    for shape in SERVE_MESH_SHAPES:
        t0 = time.perf_counter()
        reps = M.run_ranks(serve_mesh_rank, shape[0] * shape[1],
                           {**base, "shape": shape,
                            "paged": shape in SERVE_MESH_PAGED,
                            "restore": shape == (1, 2)},
                           threads=0, timeout=900)
        wall = time.perf_counter() - t0
        name = f"{shape[0]}x{shape[1]}"
        r0 = reps[0]
        for rep in reps:
            check(rep["tokens_same_on_every_rank"]
                  and np.array_equal(rep["tokens"], r0["tokens"]),
                  f"[serve-mesh] {name}: ranks sampled different tokens")
        cmp = check_mesh_stream(f"serve-mesh {name}", r0["tokens"],
                                r0["logits"], toks, logits, tol,
                                r0.get("forced_logits"))
        launches = {k: sum(rep["launches"][k] for rep in reps)
                    for k in r0["launches"]}
        slots = {k: sum(rep["slot_calls"][k] for rep in reps)
                 for k in r0["slot_calls"]}
        want = cfg.n_layers * (max_new - 1)
        check(all(rep["launches"]["flash_attention_decode"] == want
                  for rep in reps)
              and sum(launches.values())
              == launches["flash_attention_decode"],
              f"[serve-mesh] {name}: launches {launches}, expected "
              f"layers x decode steps = {want} decode launches a rank")
        check(slots["flash_attention_decode"]
              == (len(reps) * want if shape[0] > 1 else 0),
              f"[serve-mesh] {name}: slot-group calls {slots}")
        entry = {"shape": list(shape), "ranks": len(reps),
                 "wall_seconds": wall, **cmp, "launches": launches,
                 "slot_sharded_launches": slots, "per_rank": []}
        for rep in reps:
            check(all(row["views_contiguous"] for row in
                      rep["decode_rows"]["flash_attention_decode"]),
                  f"[serve-mesh] {name}: a decode slot group is not "
                  f"contiguous (the entry point would copy it)")
            entry["per_rank"].append({k: v for k, v in rep.items()
                                      if k not in ("tokens", "logits",
                                                   "forced_logits",
                                                   "restore")})
            if "paged" in rep:
                entry["per_rank"][-1]["paged"] = {
                    k: v for k, v in rep["paged"].items() if k != "done"}
        if shape in SERVE_MESH_PAGED:
            p0 = r0["paged"]
            for rep in reps:
                check(all(np.array_equal(rep["paged"]["done"][rid],
                                         p0["done"][rid]) for rid in pdone),
                      f"[serve-mesh] {name} paged: ranks differ")
            diverged = 0
            for rid, want_toks in pdone.items():
                got = p0["done"][rid]
                neq = np.nonzero(got != want_toks)[0]
                if len(neq):
                    m = float(pmargins[rid][int(neq[0])])
                    check(m <= tol, f"[serve-mesh] {name} paged request "
                          f"{rid}: differs at token {int(neq[0])} where "
                          f"the single-device margin is {m} > {tol}")
                    diverged += 1
            plaunch = {k: sum(rep["paged"]["launches"][k] for rep in reps)
                       for k in p0["launches"]}
            pslots = {k: sum(rep["paged"]["slot_calls"][k] for rep in reps)
                      for k in p0["slot_calls"]}
            check(all(rep["paged"]["launches"]["paged_flash_attention"]
                      == cfg.n_layers * rep["paged"]["decode_steps"] > 0
                      for rep in reps),
                  f"[serve-mesh] {name} paged: launches {plaunch}")
            entry["paged"] = {"launches": plaunch,
                              "slot_sharded_launches": pslots,
                              "requests_diverged": diverged,
                              "tokens_equal": diverged == 0,
                              "decode_steps": p0["decode_steps"],
                              "ms_per_decode_step": [
                                  rep["paged"]["ms_per_decode_step"]
                                  for rep in reps],
                              "pool_kv_heads": p0["pool_kv_heads"]}
        if "restore" in r0:
            rr = r0["restore"]
            check(all(rep["restore"]["tokens_same_on_every_rank"]
                      for rep in reps) and rr["pieces"]
                  and rr["shape"] == list(shape),
                  f"[serve-mesh] restore onto {name}: {rr['shape']}")
            entry["restore"] = {
                **check_mesh_stream(f"restore onto {name}", rr["tokens"],
                                    rr["logits"], qtoks, qlogits,
                                    SERVE_MESH_TOL[qcfg.dtype]),
                "shape": rr["shape"],
                **{k: rr.get(k) for k in SERVE_MESH_STEP_KEYS}}
        out["meshes"][name] = entry
        stats = {k: [rep.get(k) for rep in reps]
                 for k in SERVE_MESH_STEP_KEYS + ("build_s",)}
        peak = [rep["peak_bytes"] / 2 ** 30 for rep in reps]
        print(f"[serve-mesh] {name} ({CARD}): tokens equal "
              f"{cmp['tokens_equal']} (rows diverged {cmp['rows_diverged']}"
              f", margin <= {tol} at {cmp['steps_margin_le_tol']} steps), "
              f"max |logit diff| {cmp['max_logit_diff']:.4g}, logits "
              f"bit-equal {cmp['logits_bit_equal']}; launches {launches}, "
              f"slot-sharded {slots}; per rank {json.dumps(stats)}; peak "
              f"{[round(p, 2) for p in peak]} GiB a rank; {wall:.1f} s")
        for rep in reps:
            for name_k, rows in rep["decode_rows"].items():
                for row in rows:
                    print(f"[serve-mesh] {name} rank {rep['rank']} {name_k} "
                          f"{json.dumps(row)}")
        secs = {k: [round(rep.get(k) or 0, 2) for rep in reps]
                for k in ("build_s", "seconds", "paged_s", "rows_s",
                          "restore_s")}
        print(f"[serve-mesh] {name} rank seconds: {json.dumps(secs)}")
        if "paged" in entry:
            print(f"[serve-mesh] {name} paged: {json.dumps(entry['paged'])}")
        if "restore" in entry:
            print(f"[serve-mesh] restore onto {name}: "
                  f"{json.dumps(entry['restore'])}")
    # elastic_restore onto 3 ranks: the mesh it picks, served
    t0 = time.perf_counter()
    reps = M.run_ranks(serve_mesh_elastic_rank, 3, base, threads=0,
                       timeout=600)
    e0 = reps[0]
    check(e0["shape"] == [3, 1] and all(
        rep["tokens_same_on_every_rank"] for rep in reps),
        f"[serve-mesh] elastic_restore onto 3 ranks picked {e0['shape']}")
    out["elastic"] = {**check_mesh_stream(
        "elastic restore onto 3 ranks", e0["tokens"], e0["logits"], qtoks,
        qlogits, SERVE_MESH_TOL[qcfg.dtype]), "shape": e0["shape"],
        **{k: e0.get(k) for k in SERVE_MESH_STEP_KEYS},
        "wall_seconds": time.perf_counter() - t0}
    print(f"[serve-mesh] elastic_restore onto 3 ranks: "
          f"{json.dumps(out['elastic'])}")
    # SIGTERM mid-decode, the successor on a 2-rank mesh, quickstart width
    t0 = time.perf_counter()
    sig = RC.scenario_sigterm_mid_decode(SEED, True, device=dev,
                                         full_width=True)
    sig["seconds"] = time.perf_counter() - t0
    check(sig["status"] == "recovered" and sig["bit_identical"],
          f"[serve-mesh] SIGTERM onto a 2-rank mesh: {sig}")
    out["sigterm"] = sig
    print(f"[serve-mesh] SIGTERM onto 2 ranks at quickstart width: "
          f"{json.dumps(sig)}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[serve-mesh] phase {out['seconds']:.1f} s ({CARD})")
    return out


def serve_mesh_kernel_entries(kernels, sm):
    """The decode entries' [serve-mesh] numbers: launches of the counted
    mesh runs (summed over the ranks), the slot-sharded ones among them,
    and every rank's launch at its slot group's shape against its plain
    version (the errors into max_abs_err)."""
    for entry in kernels:
        name = entry["name"]
        if name not in ("flash_attention_decode", "paged_flash_attention"):
            continue
        launches, slots, rows = {}, {}, []
        for mesh_name, m in sm["meshes"].items():
            src = m if name == "flash_attention_decode" else m.get("paged")
            if src is None:
                continue
            launches[mesh_name] = src["launches"][name]
            slots[mesh_name] = src["slot_sharded_launches"][name]
            for rep in m["per_rank"]:
                for row in rep["decode_rows"][name]:
                    rows.append({"mesh": mesh_name, "rank": rep["rank"],
                                 **row})
        entry["max_abs_err"] = max([entry["max_abs_err"]]
                                   + [r["max_abs_err"] for r in rows])
        entry["serve_mesh"] = {"launches": launches,
                               "slot_sharded_launches": slots,
                               "per_rank": rows}


# ---------------------------------------------------------------------------
# [train-mesh]: the trainer on a mesh of ranks sharing cuda:0
# ---------------------------------------------------------------------------

#: quickstart at full width (f32), a few steps on each mesh from one
#: step-0 checkpoint, against the one-device run on the same weights and
#: batches.  AdamW's eps is 1e-5, as in tests/test_torch_train_mesh.py:
#: at 1e-8 an element whose gradient is near 1e-8 steps by up to lr with
#: the sign of its gradient's rounding
TRAIN_MESH_QS = dict(batch=8, seq=512, steps=3, lr=1e-3, warmup=1,
                     eps=1e-5)
#: (name, mesh shape, TrainConfig fields) of the quickstart runs; the
#: 2x2 run (the 4-rank world) writes the checkpoint that is resumed on
#: one device and served on 1x2
TRAIN_MESH_QS_RUNS = [("2x1", (2, 1), {}), ("1x2", (1, 2), {}),
                      ("1x2-sp", (1, 2), {"seq_shard_acts": True}),
                      ("2x1-fsdp", (2, 1), {"fsdp": True})]
#: the trained 2x2 checkpoint served on 1x2: Server and PagedServer
TRAIN_MESH_SERVE = dict(batch=4, prompt=64, max_new=16, max_len=128,
                        requests=6, lo=16, hi=96, slots=4, ps=16)
#: per-step metrics (f32: tests/test_torch_train_mesh.py's METRIC_TOL;
#: bf16 compute: test_torch_train.py's BF16_TRAIN_TOL) and final
#: parameters (PARAM_TOL) against the one-device run
TRAIN_MESH_RTOL = {"float32": 1e-4, "bfloat16": 5e-3}
TRAIN_MESH_PARAM_TOL = 3e-5
#: gemma3-12b at full width, 6 of 48 layers, 1 x 4096, bf16 compute over
#: f32 weights, remat, on 1x2 under seq_shard_acts (its META)
TRAIN_MESH_GEMMA = dict(layers=6, batch=1, seq=4096, steps=3, lr=1e-4)
#: deepseek-v2 at full width, 2 layers, fsdp and bf16 moments (its META)
#: on 2x1: a global batch of 2 x 1024 (one row a rank).  One device at
#: 2 x 4096 peaks at 73.14 GiB, 39.9 of them weights, gradients and
#: moments; a rank holds 25 GiB of those, so two ranks fit on 80 GB only
#: with the activations of ~2 k tokens
TRAIN_MESH_DEEPSEEK = dict(layers=2, batch=2, seq=1024, steps=3, lr=1e-4)
#: compressed_psum_grads on 2 ranks: leaves of these sizes
TRAIN_MESH_COMPRESS = ((4096, 1024), (3, 1000), (257,))
#: the device type of the spawned ranks
TRAIN_MESH_DEVICE = "cuda"


def train_mesh_pipe(cfg, batch, seq):
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    return SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=seq, global_batch=batch,
                                        input_mode=cfg.input_mode,
                                        d_model=cfg.d_model))


def train_mesh_opt(c, moments="float32"):
    from repro_torch.optim.adamw import AdamWConfig
    return AdamWConfig(lr=c["lr"], warmup_steps=c.get("warmup", 1),
                       total_steps=c["steps"] + 1, eps=c.get("eps", 1e-8),
                       moment_dtype=moments)


def train_mesh_steps(tr, model, opt, pipe, steps, dev, collectives):
    """``steps`` steps of the trainer's step on this rank (no
    checkpoint), each timed on the host clock to its metrics' copy and
    with the collectives' calls, bytes and host ms it took."""
    hist = []
    for _ in range(steps):
        batch = tr._device_batch(pipe.next_batch())
        torch.cuda.synchronize(dev)
        before = collectives.TRAFFIC.as_dict()
        t0 = time.perf_counter()
        model, opt, met = tr._step(model, opt, batch)
        met = {k: float(v) for k, v in met.items()}
        met["step_time_s"] = time.perf_counter() - t0
        after = collectives.TRAFFIC.as_dict()
        met.update({f"collective_{k}": after[k] - before[k]
                    for k in ("calls", "sent", "staged", "seconds")})
        hist.append(met)
    return model, opt, hist


def train_mesh_param_err(SH, TM, convert, model, cfg, ref_dir):
    """The largest |difference| of the laid-out ``model``'s parameters
    (gathered) from the checkpoint in ``ref_dir``, and its leaf."""
    from repro_torch.checkpoint.manager import CheckpointManager
    shapes = dict(TM.Model(cfg, "meta").named_parameters())
    _, tree, _, _ = CheckpointManager(ref_dir).restore(
        None, convert.tree_like_jax(shapes, cfg))
    whole = {k: torch.empty(s.shape) for k, s in shapes.items()}
    convert.fill_from_jax(whole, tree, cfg)
    worst, name = 0.0, ""
    with torch.no_grad():
        for k, p in model.named_parameters():
            t = SH.gather_tensor(p, p._layout) if hasattr(p, "_layout") \
                else p
            err = float((t.float().cpu() - whole[k]).abs().max())
            if err > worst:
                worst, name = err, k
    return worst, name


def train_mesh_rank(rank, world, c):
    """One rank of a [train-mesh] world: quickstart trained on each mesh
    of ``c["qs_runs"]`` from the step-0 checkpoint (the 2x2 run through
    Trainer.run, which writes its checkpoint), and in the 2-rank world
    the 2x2 checkpoint restored onto 1x2 and served (Server, PagedServer:
    the decode launches counted, each rank's held to its plain version),
    compressed_psum_grads on the card's tensors, gemma3-12b on 1x2 under
    seq_shard_acts and deepseek-v2 on 2x1 under fsdp."""
    sys.path.insert(0, c["src"])
    import importlib

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as M
    from repro_torch.launch import serve as S
    from repro_torch.launch import train as TT
    from repro_torch.models import attention as TA
    from repro_torch.models import convert
    from repro_torch.models import model as TM
    FA = importlib.import_module("repro_torch.kernels.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = M.rank_device(rank, TRAIN_MESH_DEVICE)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # before the first memory query
    out = {"rank": rank, "qs": {}}
    q = c["qs"]
    qcfg = get_config("quickstart")

    def qs_trainer(shape, tkw, d, steps):
        mesh = M.make_mesh(shape, M.AXES, device=TRAIN_MESH_DEVICE)
        return TT.Trainer(qcfg, TT.TrainConfig(
            steps=steps, log_every=1000, ckpt_dir=d, **tkw,
            optimizer=train_mesh_opt(q)), mesh=mesh)

    for name, shape, tkw in c["qs_runs"]:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(dev)
        d = os.path.join(c["root"], f"qs-{name}")
        if rank == 0:
            shutil.copytree(c["qs_init"], d)
        dist.barrier()
        tr = qs_trainer(shape, tkw, d, q["steps"])
        pipe = train_mesh_pipe(qcfg, q["batch"], q["seq"])
        collectives.TRAFFIC.reset()
        if name == "2x2":  # through run(): its checkpoint is resumed
            model, _, hist = tr.run(pipe)
        else:
            _, model, opt = tr.restore_or_init(pipe)
            model, opt, hist = train_mesh_steps(tr, model, opt, pipe,
                                                q["steps"], dev, collectives)
            del opt
        err, leaf = train_mesh_param_err(SH, TM, convert, model, qcfg,
                                         c["qs_ref"])
        out["qs"][name] = {"hist": hist, "param_err": err,
                           "param_err_leaf": leaf,
                           "peak_bytes": torch.cuda.max_memory_allocated(
                               dev),
                           "traffic": collectives.TRAFFIC.as_dict(),
                           "seconds": time.perf_counter() - t0}
        del model, tr
        gc.collect()
        torch.cuda.empty_cache()
    if world == 4:
        return out

    # -- the 2x2 checkpoint restored onto a 1x2 serving mesh --------------
    t0 = time.perf_counter()
    sv = c["serve"]
    scfg = qcfg.replace(attn_decode_kernel="blockspace")
    mesh = M.make_mesh((1, 2), M.AXES, device=TRAIN_MESH_DEVICE)
    tr = TT.Trainer(scfg, TT.TrainConfig(ckpt_dir=c["qs_2x2"]), mesh=mesh)
    step, model, _ = tr.restore_or_init()
    model.requires_grad_(False)
    srv = S.Server(scfg, model, S.ServeConfig(max_len=sv["max_len"]),
                   mesh=mesh)
    prompts = np.asarray(c["prompts"])
    FA.reset_launch_counts()
    collectives.TRAFFIC.reset()
    with recording_calls(TA, "decode_attention_flash") as fcalls:
        toks, logits, stats = mesh_generate(srv, prompts, sv["max_new"],
                                            collectives)
    torch.cuda.synchronize(dev)
    check_healthy(srv, f"train-mesh serve rank {rank}")
    serve = {"step": step, "tokens": toks, "launches": FA.launch_counts(),
             "same": same_everywhere(torch.from_numpy(toks)), **stats}
    if rank == 0:
        serve["logits"] = logits.cpu().numpy()
    reqs = [np.asarray(r) for r in c["requests"]]
    TA.set_decode_mesh(mesh)
    FA.reset_launch_counts()
    try:
        psrv = S.PagedServer(scfg, model, S.PagedServeConfig(**c["paged_kw"]))
        with recording_calls(TA, "decode_attention_paged") as pcalls:
            prep = S.paged_throughput_report(psrv, reqs,
                                             max_new=sv["max_new"])
        torch.cuda.synchronize(dev)
    finally:
        TA.set_decode_mesh(None)
    check_healthy(psrv, f"train-mesh paged rank {rank}")
    serve["paged"] = {"launches": FA.launch_counts(),
                      "decode_steps": prep["decode_steps"],
                      "done": {int(k): np.asarray(v)
                               for k, v in psrv.done.items()}}
    sl = slot_slice(mesh, M, prompts.shape[0])
    psl = slot_slice(mesh, M, c["paged_kw"]["num_slots"])
    rows = rank_decode_rows(FA, fcalls, pcalls, sl, psl, timed=False)
    dist.barrier()
    if rank == 0:
        rows = rank_decode_rows(FA, fcalls, pcalls, sl, psl, timed=True)
    dist.barrier()
    serve["decode_rows"] = rows
    serve["seconds"] = time.perf_counter() - t0
    out["serve"] = serve
    del srv, psrv, model, tr, fcalls, pcalls, logits
    gc.collect()
    torch.cuda.empty_cache()

    # -- compressed_psum_grads over the 2 ranks, on the card --------------
    from repro_torch.optim import compression as CMP
    gen = torch.Generator(device=dev).manual_seed(SEED + rank)
    grads = {f"g{i}": torch.randn(s, generator=gen, device=dev)
             for i, s in enumerate(TRAIN_MESH_COMPRESS)}
    res = {k: 1e-3 * torch.randn(v.shape, generator=gen, device=dev)
           for k, v in grads.items()}
    synced, new_res = CMP.compressed_psum_grads(grads, res)
    out["compress"] = {k: (synced[k].cpu().numpy(), new_res[k].cpu().numpy())
                       for k in grads}

    # -- gemma3-12b on 1x2 under seq_shard_acts, deepseek-v2 on 2x1 fsdp --
    for key, arch, c2, shape, tkw, moments in c["big"]:
        t0 = time.perf_counter()
        free_card()
        torch.cuda.reset_peak_memory_stats(dev)
        cfg = get_config(arch).replace(n_layers=c2["layers"])
        mesh = M.make_mesh(shape, M.AXES, device=TRAIN_MESH_DEVICE)
        tr = TT.Trainer(cfg, TT.TrainConfig(
            steps=c2["steps"], ckpt_dir=c["root"], **tkw,
            optimizer=train_mesh_opt(c2, moments)), mesh=mesh)
        model, opt = tr.init_params()
        init_s = time.perf_counter() - t0
        pipe = train_mesh_pipe(cfg, c2["batch"], c2["seq"])
        collectives.TRAFFIC.reset()
        model, opt, hist = train_mesh_steps(tr, model, opt, pipe,
                                            c2["steps"], dev, collectives)
        out[key] = {"hist": hist, "init_s": init_s,
                    "param_bytes": sum(p.numel() * p.element_size()
                                       for p in model.parameters()),
                    "peak_bytes": torch.cuda.max_memory_allocated(dev),
                    "seconds": time.perf_counter() - t0}
        del model, opt, tr
    free_card()
    return out


def train_mesh_one_device(TT, cfg, c, dev, moments="float32"):
    """The one-device reference of a big run: the same seeded weights,
    batches and optimizer, ``c["steps"]`` steps of make_train_step."""
    free_card()
    torch.cuda.reset_peak_memory_stats()
    tr = TT.Trainer(cfg, TT.TrainConfig(
        steps=c["steps"], ckpt_dir=tempfile.gettempdir(),
        optimizer=train_mesh_opt(c, moments)), device=dev)
    model, opt = tr.init_params()
    pipe = train_mesh_pipe(cfg, c["batch"], c["seq"])
    from repro_torch.distributed import collectives
    model, opt, hist = train_mesh_steps(tr, model, opt, pipe,
                                        c["steps"], dev, collectives)
    peak = torch.cuda.max_memory_allocated()
    del model, opt, tr
    free_card()
    return {"hist": hist, "peak_bytes": peak}


def train_mesh_close(what, got, want, rtol, keys=("loss", "grad_norm",
                                                  "aux_loss", "tokens")):
    """Per-step metrics of a mesh run against the one-device run's
    within ``rtol``; returns the largest relative difference a key."""
    check(len(got) == len(want), f"{what}: {len(got)} steps, expected "
          f"{len(want)}")
    out = {}
    for k in keys:
        a = np.array([h[k] for h in got], np.float64)
        b = np.array([h[k] for h in want], np.float64)
        rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))
        check(bool(np.all(np.isfinite(a))) and rel <= rtol,
              f"{what}: {k} {a.tolist()} against one device {b.tolist()} "
              f"(largest relative difference {rel} > {rtol})")
        out[k] = rel
    return out


def train_mesh_step_stats(hist):
    """Medians over the steps after the first: ms a step and the
    collectives' calls, bytes sent, bytes staged and host ms a step."""
    rest = hist[1:] or hist
    med = lambda k: statistics.median(h[k] for h in rest)  # noqa: E731
    return {"ms_per_step": 1e3 * med("step_time_s"),
            "collective_calls_per_step": med("collective_calls"),
            "collective_bytes_sent_per_step": med("collective_sent"),
            "staged_bytes_per_step": med("collective_staged"),
            "collective_ms_per_step": 1e3 * med("collective_seconds")}


def phase_train_mesh(S, TT, TM, FA, get_config, dev):
    """The [train-mesh] phase: the one-device references (quickstart from
    a step-0 checkpoint, gemma3-12b and deepseek-v2 from the seeded init)
    on cuda:0, then the 4-rank world (quickstart 2x2) and the 2-rank
    world (quickstart 2x1, 1x2, 1x2 seq_shard_acts, 2x1 fsdp; the 2x2
    checkpoint served on 1x2; compressed_psum_grads; gemma3-12b 1x2
    seq_shard_acts; deepseek-v2 2x1 fsdp), every run held to its
    one-device reference; the 2x2 checkpoint resumed on one device."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed import collectives
    from repro_torch.launch import mesh as M
    from repro_torch.models import convert
    from repro_torch.optim import compression as CMP
    t_phase = time.perf_counter()
    free_card()
    root = tempfile.mkdtemp(prefix="train_mesh_")
    atexit.register(shutil.rmtree, root, True)
    q = TRAIN_MESH_QS
    qcfg = get_config("quickstart")
    # -- quickstart on one device from the step-0 checkpoint --------------
    init = os.path.join(root, "qs-init")
    model = TM.init(qcfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    CheckpointManager(init).save(0, convert.params_to_jax(model))
    del model
    one_dir = os.path.join(root, "qs-one")
    shutil.copytree(init, one_dir)
    one_tr = TT.Trainer(qcfg, TT.TrainConfig(
        steps=q["steps"], log_every=1000, ckpt_dir=one_dir,
        optimizer=train_mesh_opt(q)), device=dev)
    _, model, opt = one_tr.restore_or_init()
    pipe = train_mesh_pipe(qcfg, q["batch"], q["seq"])
    model, opt, one_hist = train_mesh_steps(one_tr, model, opt, pipe,
                                            q["steps"], dev, collectives)
    one_tr.save(q["steps"], model, opt, pipe)
    # the one-device run's 4th step, for the resumed 2x2 checkpoint's
    batch = one_tr._device_batch(pipe.next_batch())
    _, _, met = one_tr._step(model, opt, batch)
    one_next = {k: float(v) for k, v in met.items()}
    del model, opt, one_tr
    free_card()
    out = {"card": CARD, "quickstart": {"one_device": {
        "hist": one_hist, **train_mesh_step_stats(one_hist)}}}
    # -- the big one-device references -----------------------------------
    g, ds = TRAIN_MESH_GEMMA, TRAIN_MESH_DEEPSEEK
    gcfg = get_config("gemma3-12b").replace(n_layers=g["layers"])
    dcfg = get_config("deepseek-v2-236b").replace(n_layers=ds["layers"])
    t0 = time.perf_counter()
    g_one = train_mesh_one_device(TT, gcfg, g, dev)
    d_one = train_mesh_one_device(TT, dcfg, ds, dev, "bfloat16")
    print(f"[train-mesh] one device ({CARD}): quickstart "
          f"{json.dumps(out['quickstart']['one_device'], default=str)}; "
          f"gemma3-12b {json.dumps(train_mesh_step_stats(g_one['hist']))} "
          f"peak {g_one['peak_bytes'] / 2 ** 30:.2f} GiB; deepseek-v2 "
          f"{json.dumps(train_mesh_step_stats(d_one['hist']))} peak "
          f"{d_one['peak_bytes'] / 2 ** 30:.2f} GiB; "
          f"{time.perf_counter() - t0:.1f} s")
    base = dict(src=str(ROOT / "src"), root=root, qs=q, qs_init=init,
                qs_ref=one_dir)
    # -- the 4-rank world: quickstart 2x2 -------------------------------
    t0 = time.perf_counter()
    reps4 = M.run_ranks(train_mesh_rank, 4,
                        {**base, "qs_runs": [("2x2", (2, 2), {})]},
                        threads=0, timeout=900)
    wall4 = time.perf_counter() - t0
    qs_2x2 = os.path.join(root, "qs-2x2")
    # the 2x2 checkpoint resumed on one device: bit-equal weights, and its
    # next step is the one-device run's
    rs_dir = os.path.join(root, "qs-resume")
    shutil.copytree(qs_2x2, rs_dir)
    rs_tr = TT.Trainer(qcfg, TT.TrainConfig(
        steps=q["steps"] + 1, log_every=1000, ckpt_dir=rs_dir,
        optimizer=train_mesh_opt(q)), device=dev)
    pipe = train_mesh_pipe(qcfg, q["batch"], q["seq"])
    step, model, opt = rs_tr.restore_or_init(pipe)
    shapes = dict(TM.Model(qcfg, "meta").named_parameters())
    _, tree, _, _ = CheckpointManager(qs_2x2).restore(
        None, convert.tree_like_jax(shapes, qcfg))
    bit_equal = all(np.array_equal(a, b) for a, b in zip(
        layout_leaves(convert.params_to_jax(model)), layout_leaves(tree)))
    check(step == q["steps"] and bit_equal and pipe.state_dict()
          == {"step": q["steps"]}, f"[train-mesh] the 2x2 checkpoint "
          f"resumed on one device: step {step}, bit-equal {bit_equal}")
    _, _, met = rs_tr._step(model, opt, rs_tr._device_batch(
        pipe.next_batch()))
    resumed = {k: float(v) for k, v in met.items()}
    resume_rel = train_mesh_close("2x2 checkpoint resumed on one device",
                                  [resumed], [one_next],
                                  TRAIN_MESH_RTOL["float32"])
    # the one-device Server and PagedServer on the 2x2 checkpoint
    sv = TRAIN_MESH_SERVE
    scfg = qcfg.replace(attn_decode_kernel="blockspace")
    model = convert.params_from_jax(tree, scfg, dev)
    del tree, rs_tr, opt
    prompts = torch.randint(
        0, qcfg.vocab_size, (sv["batch"], sv["prompt"]),
        generator=torch.Generator().manual_seed(SEED + 2)).numpy()
    ref_toks, ref_logits = serve_run(S, scfg, model, prompts, sv["max_new"],
                                     sv["max_len"], "blockspace")[:2]
    ref_logits = ref_logits.cpu()
    rng = np.random.default_rng(SEED + 2)
    reqs = [rng.integers(0, qcfg.vocab_size,
                         (int(rng.integers(sv["lo"], sv["hi"] + 1)),))
            for _ in range(sv["requests"])]
    pmax = sv["hi"] + sv["max_new"]
    paged_kw = dict(max_len=pmax, num_slots=sv["slots"],
                    page_size=sv["ps"], num_pages=1 + sv["slots"] *
                    S.paged_lib.pages_for(pmax, sv["ps"]))
    psrv = S.PagedServer(scfg, model, S.PagedServeConfig(**paged_kw))
    S.paged_throughput_report(psrv, reqs, max_new=sv["max_new"])
    pdone = {rid: np.asarray(v) for rid, v in psrv.done.items()}
    pmargins = paged_margins(TM, model, reqs, pdone)
    del psrv, model
    free_card()
    # -- the 2-rank world ------------------------------------------------
    t0 = time.perf_counter()
    reps2 = M.run_ranks(train_mesh_rank, 2, {
        **base, "qs_runs": TRAIN_MESH_QS_RUNS, "qs_2x2": qs_2x2,
        "serve": sv, "prompts": prompts, "requests": reqs,
        "paged_kw": paged_kw,
        "big": [("gemma3_12b", "gemma3-12b", g, (1, 2),
                 {"seq_shard_acts": True}, "float32"),
                ("deepseek_v2", "deepseek-v2-236b", ds, (2, 1),
                 {"fsdp": True}, "bfloat16")]},
        threads=0, timeout=1200)
    wall2 = time.perf_counter() - t0
    # -- quickstart on every mesh against one device ---------------------
    runs = {"2x2": (reps4, wall4)}
    runs.update({name: (reps2, wall2) for name, _, _ in TRAIN_MESH_QS_RUNS})
    meshes = {}
    for name, (reps, wall) in runs.items():
        r0 = reps[0]["qs"][name]
        for rep in reps:
            check(rep["qs"][name]["hist"][0]["loss"]
                  == r0["hist"][0]["loss"],
                  f"[train-mesh] quickstart {name}: ranks differ")
        rel = train_mesh_close(f"quickstart {name}", r0["hist"], one_hist,
                               TRAIN_MESH_RTOL["float32"])
        err = max(rep["qs"][name]["param_err"] for rep in reps)
        check(err <= TRAIN_MESH_PARAM_TOL, f"[train-mesh] quickstart {name}: "
              f"parameters {err} from one device ({r0['param_err_leaf']}) "
              f"> {TRAIN_MESH_PARAM_TOL}")
        stats = (train_mesh_step_stats(r0["hist"]) if name != "2x2"
                 else {"collectives": r0["traffic"]})
        meshes[name] = {"max_rel_diff": rel, "param_err": err,
                        "param_err_leaf": r0["param_err_leaf"],
                        "peak_gib": [rep["qs"][name]["peak_bytes"] / 2 ** 30
                                     for rep in reps],
                        "seconds": [rep["qs"][name]["seconds"]
                                    for rep in reps], **stats}
        print(f"[train-mesh] quickstart {name} ({CARD}): "
              f"{json.dumps(meshes[name])}")
    out["quickstart"].update({"meshes": meshes, "wall_s": {
        "4 ranks": wall4, "2 ranks": wall2}, "resumed_on_one_device": {
        "bit_equal": bit_equal, "max_rel_diff": resume_rel}})
    # -- the 2x2 checkpoint served on 1x2 ---------------------------------
    s0 = reps2[0]["serve"]
    check(all(rep["serve"]["same"] for rep in reps2)
          and s0["step"] == q["steps"], "[train-mesh] serve on 1x2: ranks "
          "sampled different tokens or the wrong step")
    tol = SERVE_MESH_TOL[qcfg.dtype]
    cmp = check_mesh_stream("train-mesh serve on 1x2", s0["tokens"],
                            s0["logits"], ref_toks, ref_logits, tol)
    want = qcfg.n_layers * (sv["max_new"] - 1)
    launches = {k: sum(rep["serve"]["launches"][k] for rep in reps2)
                for k in s0["launches"]}
    check(all(rep["serve"]["launches"]["flash_attention_decode"] == want
              for rep in reps2), f"[train-mesh] serve on 1x2: launches "
          f"{launches}, expected {want} decode launches a rank")
    p0 = s0["paged"]
    plaunch = {k: sum(rep["serve"]["paged"]["launches"][k] for rep in reps2)
               for k in p0["launches"]}
    check(all(rep["serve"]["paged"]["launches"]["paged_flash_attention"]
              == qcfg.n_layers * rep["serve"]["paged"]["decode_steps"] > 0
              for rep in reps2), f"[train-mesh] paged on 1x2: launches "
          f"{plaunch}")
    diverged = 0
    for rid, want_toks in pdone.items():
        got = p0["done"][rid]
        for rep in reps2:
            check(np.array_equal(rep["serve"]["paged"]["done"][rid], got),
                  f"[train-mesh] paged on 1x2: ranks differ on {rid}")
        neq = np.nonzero(got != want_toks)[0]
        if len(neq):
            m = float(pmargins[rid][int(neq[0])])
            check(m <= tol, f"[train-mesh] paged request {rid}: differs "
                  f"at token {int(neq[0])} where the margin is {m} > {tol}")
            diverged += 1
    out["serve"] = {**cmp, "launches": launches, "paged_launches": plaunch,
                    "paged_requests_diverged": diverged,
                    "per_rank": [{"rank": rep["rank"],
                                  "decode_rows": rep["serve"]["decode_rows"],
                                  **{k: rep["serve"].get(k) for k in
                                     SERVE_MESH_STEP_KEYS}}
                                 for rep in reps2]}
    print(f"[train-mesh] 2x2 checkpoint served on 1x2 ({CARD}): tokens "
          f"equal {cmp['tokens_equal']}, max |logit diff| "
          f"{cmp['max_logit_diff']:.4g}; launches {launches}; paged "
          f"{plaunch}, requests diverged {diverged}")
    for rep in reps2:
        for name_k, rows in rep["serve"]["decode_rows"].items():
            for row in rows:
                print(f"[train-mesh] serve rank {rep['rank']} {name_k} "
                      f"{json.dumps(row)}")
    # -- compressed_psum_grads on the card --------------------------------
    drawn = []  # each rank's gradients, then its residuals, as it drew them
    for r in range(2):
        gen = torch.Generator(device=dev).manual_seed(SEED + r)
        gs = [torch.randn(s, generator=gen, device=dev)
              for s in TRAIN_MESH_COMPRESS]
        drawn.append((gs, [1e-3 * torch.randn(s, generator=gen, device=dev)
                           for s in TRAIN_MESH_COMPRESS]))
    cmp_out = {}
    for i, s in enumerate(TRAIN_MESH_COMPRESS):
        k = f"g{i}"
        gs = [drawn[r][0][i] for r in range(2)]
        rs = [drawn[r][1][i] for r in range(2)]
        deqs = [CMP.compress_roundtrip(gg + rr) for gg, rr in zip(gs, rs)]
        mean = ((deqs[0] + deqs[1]) / 2).cpu().numpy()
        worst_ulp = 0.0
        for r in range(2):
            synced, res = reps2[r]["compress"][k]
            want_res = (gs[r] + rs[r] - deqs[r]).cpu().numpy()
            check(np.array_equal(res, want_res), f"[train-mesh] compress "
                  f"{k} rank {r}: the residual is not bit-equal")
            ulp = np.spacing(np.abs(mean).astype(np.float32))
            worst_ulp = max(worst_ulp, float(np.max(np.abs(synced - mean)
                                                    / ulp)))
        check(worst_ulp <= 1.0, f"[train-mesh] compress {k}: the mean is "
              f"{worst_ulp} ulp from the single-process one")
        cmp_out[k] = {"shape": list(s), "max_ulp": worst_ulp}
    out["compress"] = cmp_out
    print(f"[train-mesh] compressed_psum_grads on 2 ranks: "
          f"{json.dumps(cmp_out)}")
    # -- gemma3-12b and deepseek-v2 against one device --------------------
    for key, cfg, one, c2 in (("gemma3_12b", gcfg, g_one, g),
                              ("deepseek_v2", dcfg, d_one, ds)):
        r0 = reps2[0][key]
        rel = train_mesh_close(f"{key} on a mesh", r0["hist"], one["hist"],
                               TRAIN_MESH_RTOL[cfg.dtype])
        if key == "deepseek_v2":
            check(all(h["aux_loss"] > 0 for h in r0["hist"]),
                  f"[train-mesh] deepseek-v2: aux {r0['hist']}")
        out[key] = {"layers": c2["layers"], "batch": c2["batch"],
                    "seq": c2["seq"], "max_rel_diff": rel,
                    "losses": [h["loss"] for h in r0["hist"]],
                    "one_device_losses": [h["loss"] for h in one["hist"]],
                    "aux_losses": [h["aux_loss"] for h in r0["hist"]],
                    "one_device": train_mesh_step_stats(one["hist"]),
                    "one_device_peak_gib": one["peak_bytes"] / 2 ** 30,
                    "peak_gib": [rep[key]["peak_bytes"] / 2 ** 30
                                 for rep in reps2],
                    "param_gib_a_rank": [rep[key]["param_bytes"] / 2 ** 30
                                         for rep in reps2],
                    "init_s": [rep[key]["init_s"] for rep in reps2],
                    "seconds": [rep[key]["seconds"] for rep in reps2],
                    **train_mesh_step_stats(r0["hist"])}
        print(f"[train-mesh] {key} ({CARD}): {json.dumps(out[key])}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[train-mesh] phase {out['seconds']:.1f} s ({CARD})")
    return out


def layout_leaves(tree):
    """The leaves of a nested dict of arrays (a checkpoint's tree), in
    key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += layout_leaves(v) if isinstance(v, dict) else [np.asarray(v)]
    return out


def train_mesh_kernel_entries(kernels, tm):
    """The decode entries' [train-mesh] numbers: the launches of the
    trained checkpoint's serving on 1x2 (summed over the ranks) and each
    rank's launch at its shape against its plain version."""
    for entry in kernels:
        name = entry["name"]
        if name not in ("flash_attention_decode", "paged_flash_attention"):
            continue
        src = tm["serve"]["launches"] if name == "flash_attention_decode" \
            else tm["serve"]["paged_launches"]
        rows = [{"rank": rep["rank"], **row} for rep in
                tm["serve"]["per_rank"] for row in rep["decode_rows"][name]]
        entry["max_abs_err"] = max([entry["max_abs_err"]]
                                   + [r["max_abs_err"] for r in rows])
        entry["train_mesh"] = {"launches": src[name], "per_rank": rows}


def compare(change_paths, parent_paths, lo=0.94, hi=1.06):
    """Print every time whose change median lies outside [lo, hi] x the
    parent median, with both sides' values; returns the count of times
    compared and of those outside."""
    def load(paths):
        runs = [timings(json.loads(Path(p).read_text())) for p in paths]
        keys = set.intersection(*(set(r) for r in runs))
        return {k: [v for r in runs for v in r[k]] for k in keys}
    change, parent = load(change_paths), load(parent_paths)
    keys = sorted(set(change) & set(parent))
    outside = 0
    for key in keys:
        c, p = change[key], parent[key]
        if statistics.median(p) <= 0:
            continue
        ratio = statistics.median(c) / statistics.median(p)
        if not lo <= ratio <= hi:
            outside += 1
            print(f"[compare] {key}: {ratio:.4f}x (change {c}, parent {p})")
    print(f"[compare] {len(keys)} times compared, {outside} outside "
          f"{lo}-{hi}x of the parent's median")
    return len(keys), outside


# ---------------------------------------------------------------------------
# phase 22: the plan verifier, the access sanitizer and verify= (A13)
# ---------------------------------------------------------------------------

#: the gasket of the verify phase: n = 2**16 at rho 32 (2048 block rows,
#: 177,147 member blocks), the CA's main cell
VERIFY_RHO = 32
VERIFY_SHARDS = (2, 4)
#: the packed triangle's block rows and the band's window (blocks)
VERIFY_ROWS, VERIFY_BAND = 2048, 32
#: the LUT rows the seeded fault swaps (two member blocks trade steps: every
#: address stays valid, and the outputs are unchanged)
VERIFY_FAULT_ROW = 1234
#: flash at gemma3-12b's widths, S 4096 (causal, and local at its window)
VERIFY_FLASH = dict(b=1, h=16, hkv=8, s=4096, d=256, block=128,
                    window=1024)
#: paged decode at gemma3-12b's widths over 1536-token slots
VERIFY_PAGED = dict(b=4, h=16, hkv=8, seq=1536, d=256, page_size=16)
#: the searchers run with and without verify= from fresh caches
VERIFY_TUNE = dict(fractal="sierpinski-gasket", n=4096, block=32,
                   max_coarsen=2)
VERIFY_TUNE_CA = dict(rule="parity", steps=4, max_fuse=4)


def verify_static(TV, FA, D, LOWERINGS, dev):
    """[verify] static lines: verify_plan on the main path's plans, each
    with zero findings, and its host seconds.  The host views of the
    gasket plans the sanitizer launches stay in VERIFY_STATIC["decodes"]
    (keyed by geometry and the tables' digest), so the sanitizer's
    static sets reuse their decodes."""
    from repro_torch.core.plan import GridPlan
    from repro_torch.core.shard import ShardedPlan
    gasket = D.SierpinskiDomain(N_MAIN // VERIFY_RHO)
    plans = []
    for lowering in LOWERINGS:
        for storage in ("embedded", "compact"):
            plans.append((f"gasket/{lowering}/{storage}", GridPlan(
                gasket, lowering, storage=storage, backend=dev),
                ("write", "sum", "ca")))
            plans.append((f"gasket/{lowering}/{storage}/coarsen=2",
                           GridPlan(gasket, lowering, storage=storage,
                                    coarsen=2, backend=dev), ("ca",)))
    # the packed triangle's own decodes (integer sqrt, the row chain; its
    # LUT and box are the band's, checked there at a 64th of the steps)
    for name, dom, lowerings in (
            ("triangle", D.TriangularDomain(VERIFY_ROWS),
             ("closed_form", "mma")),
            ("band", D.BandDomain(VERIFY_ROWS, VERIFY_BAND), LOWERINGS)):
        for lowering in lowerings:
            plans.append((f"{name}/{lowering}/compact", GridPlan(
                dom, lowering, storage="compact", backend=dev), ("ca",)))
    # the step-indexed lowerings: a rank of the bounding lowering walks
    # the whole 4.19 M-step box (the CPU matrix verifies those plans)
    for shards in VERIFY_SHARDS:
        for lowering in LOWERINGS:
            if lowering == "bounding":
                continue
            sp = ShardedPlan(gasket, lowering, storage="compact",
                             backend=dev, num_shards=shards,
                             partition="storage-rows", halo=True)
            tag = f"gasket/{lowering}/compact/D={shards}/halo=1"
            plans.append((tag, sp, ("ca",)))
            for phase in ("interior", "boundary"):
                plans.append((f"{tag}/{phase}", sp.phase_view(phase),
                              ("ca",)))
    rows = []
    decodes = VERIFY_STATIC.setdefault("decodes", {})
    for label, plan, kernels in plans:
        t0 = time.perf_counter()
        kept = label.startswith("gasket/") and label.count("/") == 2
        reports = TV.verify_models(plan, kernels, device=dev,
                                   decodes=decodes if kept else None)
        secs = time.perf_counter() - t0
        for kernel, report in reports.items():
            check(report.ok, f"verify {label} ({kernel}): "
                  f"{[str(f) for f in report.findings][:5]}")
        rows.append({"plan": label, "kernels": list(kernels),
                     "seconds": secs, "ranks": TV.num_devices(plan)})
        print(f"[verify] static {label} ({', '.join(kernels)}): 0 "
              f"findings, {secs:.3f} s host")
    f = VERIFY_FLASH
    for kind in ("causal", "local"):
        for lowering in LOWERINGS:
            sched = FA.flash_schedule(
                (f["b"], f["h"], f["s"], f["d"]),
                (f["b"], f["hkv"], f["s"], f["d"]), kind=kind,
                window=f["window"] if kind == "local" else 0,
                block_q=f["block"], block_k=f["block"], grid_mode=lowering)
            t0 = time.perf_counter()
            FA.verify_schedule(sched, dev)
            secs = time.perf_counter() - t0
            label = f"flash gemma3-12b {kind} S {f['s']}/{lowering}"
            rows.append({"plan": label, "kernels": ["flash"],
                         "seconds": secs, "ranks": 1})
            print(f"[verify] static {label} (flash): 0 findings, "
                  f"{secs:.3f} s host")
    total = sum(r["seconds"] for r in rows)
    print(f"[verify] static: {len(rows)} plan checks, 0 findings, "
          f"{total:.1f} s host in all, max "
          f"{max(r['seconds'] for r in rows):.2f} s")
    return rows


def verify_faults(TV, TW, TC, D, compact_layout, dev):
    """Seeded faults on the card: two rows of the device LUT a compact
    launch reads swapped, and one ghost-map entry of a rank's device
    table.
    verify=True refuses before any launch; the sanitizer flags the LUT
    row from the trace kernels' rows (verify=False)."""
    from repro_torch.analysis import PlanVerificationError, verify_launches
    from repro_torch.core.plan import GridPlan
    from repro_torch.core.shard import ShardedPlan
    n, rho = N_MAIN, VERIFY_RHO
    dom = D.SierpinskiDomain(n // rho)
    lay = compact_layout(dom)
    a = torch.zeros(lay.array_shape(rho), dtype=torch.float32, device=dev)
    b = torch.zeros_like(a)
    kw = dict(block=rho, grid_mode="prefetch_lut", storage="compact", n=n)
    calls = {
        "sierpinski_write": lambda **v: TW.sierpinski_write_(a, 1.0, **kw,
                                                             **v),
        "sierpinski_sum": lambda **v: TW.sierpinski_sum(a, **kw, **v),
        "ca_run": lambda **v: TC.ca_run(a, b, 1, fuse=1, donate=True, **kw,
                                        **v)}
    lut = GridPlan(dom, "prefetch_lut", storage="compact",
                   backend=dev).launch_params(n, rho, dev).lut
    row = VERIFY_FAULT_ROW
    out = {"lut_rows": [row, row + 1]}

    def swap():
        keep = lut[row].clone()
        lut[row] = lut[row + 1]
        lut[row + 1] = keep
    swap()
    try:
        TW.reset_launch_counts()
        TC.reset_launch_counts()
        for name, call in calls.items():
            try:
                call(verify=True)
                raised = ""
            except PlanVerificationError as e:
                raised = str(e)
            check("LUT row" in raised, f"verify=True on {name} let a "
                  f"corrupt device LUT row through")
        launches = sum(TW.launch_counts().values()) + \
            sum(TC.launch_counts().values())
        check(launches == 0, f"{launches} launches after verify= refused")
        out["verify_refused"] = list(calls)
        flagged = {}
        for name, call in calls.items():
            _, found = verify_launches(call, strict=False)
            hit = [f.detail for f in found if f"step {row} decoded" in
                   f.detail]
            check(hit, f"the sanitizer did not flag LUT rows {row}, "
                  f"{row + 1} on {name}")
            flagged[name] = len(found)
        out["sanitizer_findings"] = flagged
    finally:
        swap()
    sp = ShardedPlan(dom, "closed_form", storage="compact", backend=dev,
                     num_shards=2, partition="storage-rows", halo=True)
    view = sp.for_rank(0).bind_block(rho)
    gmap = view.shard_params(dev)[1]
    ghost = int(torch.nonzero(gmap == sp.rpd)[0])   # rank 0's first ghost
    gmap[ghost] = 0
    try:
        TC.reset_launch_counts()
        try:
            TW.verify_launch(view, "ca", dev)   # what ca_run(mesh=) runs
            raised = ""
        except PlanVerificationError as e:
            raised = str(e)
        check("launch ghost map" in raised,
              "verify= let a corrupt device ghost map through")
        check(sum(TC.shard_launch_counts().values()) == 0,
              "a sharded launch ran after verify= refused")
        out["ghost_map_row"] = ghost
    finally:
        gmap[ghost] = sp.rpd
    check(TV.verify_plan(view, kernel="ca", device=dev).ok,
          "the restored ghost map does not verify")
    print(f"[verify] seeded faults on the card: LUT rows {row}, {row + 1} "
          f"swapped, refused by "
          f"verify=True on {', '.join(calls)} (0 launches) and flagged by "
          f"the sanitizer ({json.dumps(out['sanitizer_findings'])} "
          f"findings); ghost-map row {ghost} of rank 0 refused by the "
          f"rank's verify= (0 sharded launches)")
    return out


def _host_ms(fn):
    """Host milliseconds of one call of ``fn`` that ends synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def verify_entry_points(TW, TC, FA, P, tune, D, compact_layout, dev):
    """verify=True on write, sum, the CA, flash and paged at the main
    path's shapes: outputs bit-equal to verify=False, and the extra host
    ms of the static check."""
    n, rho = N_MAIN, VERIFY_RHO
    dom = D.SierpinskiDomain(n // rho)
    lay = compact_layout(dom)
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randint(0, 2, lay.array_shape(rho), generator=g,
                      device=dev).float()
    z = torch.zeros_like(x)
    kw = dict(block=rho, storage="compact", n=n, grid_mode="closed_form")
    f, pg = VERIFY_FLASH, VERIFY_PAGED
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
               for shape in ((f["b"], f["h"], f["s"], f["d"]),
                             (f["b"], f["hkv"], f["s"], f["d"]),
                             (f["b"], f["hkv"], f["s"], f["d"])))
    pq, pk, pv = (torch.randn(shape, generator=g, device=dev)
                  .to(torch.bfloat16) for shape in (
                      (pg["b"], pg["h"], 1, pg["d"]),
                      (pg["b"], pg["hkv"], pg["seq"], pg["d"]),
                      (pg["b"], pg["hkv"], pg["seq"], pg["d"])))
    pool, table = tune.paged_operands(pk, pv, pg["page_size"])
    pos = torch.full((pg["b"],), pg["seq"] - 1, dtype=torch.int32,
                     device=dev)
    calls = {
        "sierpinski_write": lambda **o: TW.sierpinski_write(x, 1.0, **kw,
                                                            **o),
        "sierpinski_sum": lambda **o: TW.sierpinski_sum(x, **kw, **o),
        "ca_step": lambda **o: TC.ca_step(x, z, **kw, **o),
        "ca_run": lambda **o: TC.ca_run(x, z, 8, fuse=8, donate=False,
                                        **kw, **o),
        "flash_attention": lambda **o: FA.flash_attention(
            q, k, v, kind="causal", block_q=f["block"], block_k=f["block"],
            **o),
        "flash_attention_local": lambda **o: FA.flash_attention(
            q, k, v, kind="local", window=f["window"], block_q=f["block"],
            block_k=f["block"], grid_mode="prefetch_lut", **o),
        "paged_flash_attention": lambda **o: FA.paged_flash_attention(
            pq, pool, table, pos, **o)}
    out = {}
    for name, call in calls.items():
        call()                                   # warm
        plain_ms, want = _host_ms(call)
        ver_ms, got = _host_ms(lambda: call(verify=True))
        check(torch.equal(got, want), f"verify=True changed {name}")
        out[name] = {"ms": plain_ms, "verify_ms": ver_ms,
                     "extra_host_ms": ver_ms - plain_ms}
        print(f"[verify] {name} verify=True: bit-equal to verify=False; "
              f"{plain_ms:.1f} ms -> {ver_ms:.1f} ms host "
              f"(+{ver_ms - plain_ms:.1f} ms)")
    return out


def verify_sanitizer(TW, TC, SAN, D, LOWERINGS, compact_layout, dev):
    """The access sanitizer at full width: write, sum and the CA (parity,
    fuse 1 and 8) on the gasket at n = 2**16, rho 32, under the four
    lowerings x both storages through the trace builds; zero findings,
    each traced output bit-equal to the untraced one, the card's rows
    equal to the plain version's rows for the same plan; the trace and
    untraced launches timed."""
    n, rho = N_MAIN, VERIFY_RHO
    dom = D.SierpinskiDomain(n // rho)
    lay = compact_layout(dom)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    rows, counts = [], {}
    # the static checks' host views of these plans (verify_static)
    static = VERIFY_STATIC.get("decodes", {})
    TW.reset_launch_counts()
    TC.reset_launch_counts()
    for storage in ("embedded", "compact"):
        shape = lay.array_shape(rho) if storage == "compact" else (n, n)
        a = torch.randint(0, 2, shape, generator=g, device=dev).float()
        outs = [torch.zeros_like(a), torch.zeros_like(a)]
        for lowering in LOWERINGS:
            kw = dict(block=rho, grid_mode=lowering, storage=storage, n=n,
                      num_stages=1)
            runs = [("write", lambda o: TW.sierpinski_write_(o, 1.0, **kw)),
                    ("sum", lambda o: TW.sierpinski_sum(a, **kw))]
            for fuse in (1, 8):
                runs.append((f"ca fuse {fuse}",
                             lambda o, fuse=fuse: TC.ca_run(
                                 a, o, fuse, fuse=fuse, donate=True, **kw)))
            secs = {"runs": 0.0, "crosscheck": 0.0, "plain_rows": 0.0}
            for what, run in runs:
                t0 = time.perf_counter()
                for o in outs:
                    o.zero_()
                want = run(outs[0])
                with SAN.AccessTrace(static=static) as tr:
                    got = run(outs[1])
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                found = tr.crosscheck()
                t2 = time.perf_counter()
                secs["runs"] += t1 - t0
                secs["crosscheck"] += t2 - t1
                check(not found, f"sanitizer {what} {lowering} {storage}: "
                      f"{[str(x) for x in found][:5]}")
                check(torch.equal(got, want), f"traced {what} {lowering} "
                      f"{storage} != untraced")
                (launch,) = tr.launches
                kind = what.split()[0]
                t3 = time.perf_counter()
                plain = SAN.plain_trace(launch.plan, kind, dev)
                check(torch.equal(launch.trace, plain),
                      f"trace rows of {what} {lowering} {storage} != the "
                      f"plain version's")
                secs["plain_rows"] += time.perf_counter() - t3
                rows.append({"kernel": what, "lowering": lowering,
                             "storage": storage,
                             "steps": launch.plan.steps_per_launch})
                del tr, launch, plain
            print(f"[verify] sanitizer {lowering} {storage}: write, sum, "
                  f"ca fuse 1 and 8 clean; host s "
                  f"{json.dumps({k: round(v, 2) for k, v in secs.items()})}")
        counts = {**TW.trace_launch_counts(), **TC.trace_launch_counts()}
        del a, outs
        free_card()
    static.clear()
    times = verify_trace_times(TW, TC, LOWERINGS, lay, dev)
    print(f"[verify] sanitizer: {len(rows)} traced launches at n = {n}, "
          f"rho {rho}, 0 findings, outputs bit-equal to the untraced "
          f"launches, rows equal to the plain version's; trace launches "
          f"{json.dumps(counts)}")
    return {"runs": rows, "times": times, "trace_launches": counts}


def verify_trace_times(TW, TC, LOWERINGS, lay, dev):
    """The trace builds beside the untraced kernels: the median of 3
    CUDA-event-timed launches of each, on the same operands."""
    from repro_torch.kernels import _cuda
    n, rho = N_MAIN, VERIFY_RHO
    times = []
    for storage in ("embedded", "compact"):
        shape = lay.array_shape(rho) if storage == "compact" else (n, n)
        a = torch.zeros(shape, dtype=torch.float32, device=dev)
        b = torch.zeros_like(a)
        for lowering in LOWERINGS:
            plan = TW.prepare_launch(a, block=rho, grid_mode=lowering,
                                     storage=storage, n=n)[0]
            p = plan.launch_params(n, rho, dev)
            trace = _cuda.trace_rows(p.steps, dev)
            pairs = {
                "write": (lambda: TW.write_cuda(a, 1.0, p),
                          lambda: TW.write_trace_cuda(a, 1.0, p, trace)),
                "sum": (lambda: TW.sum_partials_cuda(a, p),
                        lambda: TW.sum_partials_trace_cuda(a, p, trace))}
            for fuse in (1, 8):
                pairs[f"ca fuse {fuse}"] = (
                    lambda fuse=fuse: TC.ca_cuda(a, b, p, fuse, fuse,
                                                 "parity", CA_ALPHA),
                    lambda fuse=fuse: TC.ca_trace_cuda(
                        a, b, p, fuse, fuse, "parity", CA_ALPHA, 1, trace))
            for what, (bare, traced) in pairs.items():
                t = {"kernel": what, "lowering": lowering,
                     "storage": storage, "steps": p.steps,
                     "ms": time_ms(bare, 3), "trace_ms": time_ms(traced, 3)}
                times.append(t)
                print(f"[verify] trace {what} {lowering} {storage}: "
                      f"{t['trace_ms']:.3f} ms traced, {t['ms']:.3f} ms "
                      f"untraced a launch ({p.steps} steps)")
            del trace
        del a, b
        free_card()
    return times


def verify_searchers(tune, TV, dev):
    """autotune_write / autotune_ca with verify=True from fresh caches:
    the candidate set of verify=False; a candidate whose plan fails
    verification (every mma plan, by a patched verifier) is rejected."""
    d = tempfile.mkdtemp(prefix="repro-torch-verify-tune-")
    atexit.register(shutil.rmtree, d, True)
    grid = dict(VERIFY_TUNE, device=dev, force=True)
    searches = {
        "write": lambda **o: tune.autotune_write(**grid, **o),
        "ca": lambda **o: tune.autotune_ca(**grid, **VERIFY_TUNE_CA, **o)}
    out = {}
    for name, search in searches.items():
        trials = {}
        for v in (False, True):
            cache = tune.TuneCache(os.path.join(d, f"{name}-{v}.json"))
            t0 = time.perf_counter()
            _, _, tr = search(verify=v, cache=cache)
            trials[v] = ([c for c, _ in tr], time.perf_counter() - t0)
        check(trials[True][0] == trials[False][0],
              f"autotune_{name}(verify=True) searched another candidate set")
        real = TV.verify_plan

        def fail_mma(plan, **kw):
            report = real(plan, **kw)
            if plan.lowering == "mma":
                report.findings.append(TV.Finding("table", "seeded"))
            return report
        TV.verify_plan = fail_mma
        try:
            cache = tune.TuneCache(os.path.join(d, f"{name}-patched.json"))
            _, _, tr = search(verify=True, cache=cache)
        finally:
            TV.verify_plan = real
        kept = [c for c, _ in tr]
        check(kept == [c for c in trials[False][0]
                       if c["lowering"] != "mma"],
              f"autotune_{name}: a failing candidate was not rejected")
        out[name] = {"candidates": len(trials[True][0]),
                     "seconds": trials[False][1],
                     "verify_seconds": trials[True][1],
                     "rejected_when_mma_fails": len(trials[True][0])
                     - len(kept)}
        print(f"[verify] autotune_{name}: verify=True measured the same "
              f"{len(trials[True][0])} candidates as verify=False "
              f"({trials[False][1]:.1f} s -> {trials[True][1]:.1f} s); "
              f"with every mma plan failing, {out[name]['rejected_when_mma_fails']} "
              f"rejected")
    return out


def verify_cli(device="cuda"):
    """``python -m repro_torch.analysis.verify --matrix --device cuda``,
    its ``main`` called in this process (no second start-up on the
    card): exit 0, its report's counts."""
    from repro_torch.analysis import verify as VCLI
    report = ROOT / "chiprun_out" / "verify_matrix.json"
    report.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    rc = VCLI.main(["--matrix", "--device", device, "--quiet", "--out",
                    str(report)])
    secs = time.perf_counter() - t0
    check(rc == 0, f"the verify CLI exited {rc}")
    rep = json.loads(report.read_text())
    out = {key: rep[key] for key in ("ok", "num_static", "num_sanitized",
                                     "num_findings")}
    out["seconds"] = secs
    print(f"[verify] python -m repro_torch.analysis.verify --matrix "
          f"--device {device}: exit 0, {json.dumps(out)}")
    return out


def phase_verify(TW, TC, FA, P, tune, D, LOWERINGS, compact_layout, dev):
    """Phase 22 (see the module docstring); its static checks ran beside
    the build (VERIFY_STATIC)."""
    from repro_torch.analysis import sanitizer as SAN
    from repro_torch.analysis import verifier as TV
    free_card()
    t = {"static_beside_build": round(VERIFY_STATIC["seconds"], 1)}
    out = {"static": VERIFY_STATIC["rows"]}
    for name, fn in (
            ("faults", lambda: verify_faults(TV, TW, TC, D, compact_layout,
                                             dev)),
            ("entry_points", lambda: verify_entry_points(
                TW, TC, FA, P, tune, D, compact_layout, dev)),
            ("sanitizer", lambda: verify_sanitizer(
                TW, TC, SAN, D, LOWERINGS, compact_layout, dev)),
            ("searchers", lambda: verify_searchers(tune, TV, dev)),
            ("cli", lambda: verify_cli(dev.type))):
        t0 = time.perf_counter()
        out[name] = fn()
        t[name] = round(time.perf_counter() - t0, 1)
        free_card()
    out["seconds"] = t
    print(f"[verify] part seconds {json.dumps(t)}")
    return out


def verify_kernel_entries(kernels, ver):
    """The trace builds' launches of the [verify] phase's sanitizer runs
    (verify_sanitizer) beside their untraced kernels' entries, with the traced and untraced times of
    the main cell (closed_form, compact)."""
    times = {(r["kernel"], r["lowering"], r["storage"]): r
             for r in ver["sanitizer"]["times"]}
    for entry in kernels:
        for name, what, trace_name in (
                ("sierpinski_write", "write", "sierpinski_write_trace"),
                ("sierpinski_sum_partials", "sum",
                 "sierpinski_sum_partials_trace"),
                ("sierpinski_ca_fused", "ca fuse 8",
                 "sierpinski_ca_fused_trace")):
            if entry["name"] == name:
                t = times[(what, "closed_form", "compact")]
                entry["trace_build"] = {
                    "name": trace_name,
                    "launches_sanitizer":
                        ver["sanitizer"]["trace_launches"][trace_name],
                    "ms": t["trace_ms"], "untraced_ms": t["ms"],
                    "at": f"gasket n={N_MAIN} rho={VERIFY_RHO} compact "
                          f"closed_form, {what}"}


#: host seconds of each phase of this run, printed as ``[phases]``
#: [dryrun]: the sweep of every (architecture x shape) cell on both
#: production meshes (``python -m repro_torch.launch.dryrun --all --mesh
#: both``), started beside the build at the lowest CPU priority and joined
#: in [dryrun]; its records go to a fresh DRYRUN_DIR
DRYRUN_DIR = ROOT / "chiprun_out" / "dryrun"
DRYRUN_JOBS = 3
DRYRUN_CELLS = 66
#: the longest [dryrun] waits for the sweep to end
DRYRUN_JOIN_S = 600
#: the dry run's peak of a measured step may fall short of the measured
#: peak (less what was resident when the phase reset it) by at most this
#: share of it (the caching allocator's 512-byte rounding, cuBLAS
#: workspaces and the guard's screen are not in the count)
DRYRUN_PEAK_UNDER = 0.05
#: the card's peak for the dtype the step's products ran in: bf16 on the
#: tensor cores; f32 on the CUDA cores (allow_tf32 is off)
PEAK_TFLOPS = {"bfloat16": 989.0, "float32": 67.0}
DRYRUN_SWEEP = {}


def start_dryrun_sweep():
    """Start the dry-run sweep in a process group of its own at nice 19
    (killed at exit if it is still running): its cells take CPU only
    where the build and the phases leave it."""
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    DRYRUN_DIR.mkdir(parents=True)
    log = open(DRYRUN_DIR / "sweep.log", "w")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--mesh", "both", "--jobs", str(DRYRUN_JOBS), "--results-dir",
         str(DRYRUN_DIR)], cwd=ROOT, env=env, stdout=log,
        stderr=subprocess.STDOUT, start_new_session=True,
        preexec_fn=lambda: os.nice(19))

    def stop():
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    atexit.register(stop)
    DRYRUN_SWEEP.update(proc=proc, log=log, t0=time.perf_counter())


def dryrun_sweep_done(DR):
    """Join the sweep; check its 66 records; print a line per cell."""
    proc = DRYRUN_SWEEP["proc"]
    try:
        rc = proc.wait(timeout=DRYRUN_JOIN_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.wait()
        check(False, f"[dryrun] the sweep did not end {DRYRUN_JOIN_S} s "
              f"after [dryrun] began to wait")
    DRYRUN_SWEEP["log"].close()
    joined = time.perf_counter() - DRYRUN_SWEEP["t0"]
    text = (DRYRUN_DIR / "sweep.log").read_text()
    check(rc == 0, f"[dryrun] the sweep exited {rc}:\n{text[-4000:]}")
    recs = [json.loads(p.read_text())
            for p in sorted(DRYRUN_DIR.glob("*__*.json"))]
    check(len(recs) == DRYRUN_CELLS and text.count("[OK]") == DRYRUN_CELLS
          and "[FAIL]" not in text, f"[dryrun] {len(recs)} records, "
          f"{text.count('[OK]')} cells OK of {DRYRUN_CELLS}")
    for r in recs:
        ops, roof, mem = r["ops"], r["roofline"], r["mem"]
        check(ops["flops_per_dev"] > 0 and np.isfinite(mem["peak_est_gib"])
              and mem["peak_est_gib"] > 0 and roof["model_flops_total"] > 0,
              f"[dryrun] {r['arch']} {r['shape']} {r['mesh']}: {r}")
        print(f"[dryrun] {DR.cell_line(r)} (useful "
              f"{roof['useful_ratio']:.3f})")
    trace = sum(r["trace_s"] for r in recs)
    secs = float(text.rsplit(" cells OK in ", 1)[1].split(" s")[0])
    print(f"[dryrun] sweep: {len(recs)} cells OK in {secs:.1f} s from its "
          f"start beside the build ({DRYRUN_JOBS} jobs at nice 19), "
          f"{trace:.1f} s of counted programs; joined {joined:.1f} s after "
          f"its start")
    return {"cells": len(recs), "seconds": secs, "joined_s": joined,
            "trace_s": trace,
            "records": {f"{r['arch']} {r['shape']} {r['mesh']}": {
                "peak_est_gib": r["mem"]["peak_est_gib"],
                "flops_per_dev": r["ops"]["flops_per_dev"],
                "bytes_per_dev": r["ops"]["bytes_per_dev"],
                "coll_wire_bytes_per_dev": r["ops"][
                    "coll_wire_bytes_per_dev"],
                "dominant": r["roofline"]["dominant"],
                "useful_ratio": r["roofline"]["useful_ratio"],
                "cache_gib": r["mem"].get("cache_gib"),
                "cache_reference_gib": r["mem"].get("cache_reference_gib")}
                for r in recs}}


def dryrun_step(DR, name, cfg, kind, ms, peak_gib, resident_gib, **shape):
    """One measured step beside its dry run on one device: the counted
    FLOPs, model_flops, the achieved TFLOP/s and share of the peak of the
    dtype its products ran in, and the dry run's peak against the
    measured one (less what was resident when the phase reset it)."""
    b, s = shape["batch"], shape["seq"]
    if kind == "train":
        cost, mem, _, secs = DR.dry_run(
            cfg, "train", inputs=DR.step_inputs(cfg, "train", b, s))
        dry_peak = mem["peak_est_gib"]
        useful = DR.step_model_flops(cfg, "train", b, s)
    else:
        cost, peak, secs = DR.dry_serve(cfg, b, s, shape["max_len"])
        dry_peak = peak / 2 ** 30
        useful = DR.step_model_flops(cfg, "decode", b, s + 1)
    tflops = cost.flops / (ms / 1e3) / 1e12
    peak_tf = PEAK_TFLOPS[cfg.dtype]
    measured = peak_gib - resident_gib
    row = {"step": name, "kind": kind, "dtype": cfg.dtype,
           "layers": cfg.n_layers, **shape, "counted_flops": cost.flops,
           "model_flops": useful, "counted_over_model": cost.flops / useful,
           "flops_by_op": dict(cost.flops_by_op),
           "bytes": cost.bytes_accessed, "ms": ms,
           "achieved_tflops": tflops, "peak_tflops": peak_tf,
           "share_of_peak": tflops / peak_tf,
           "dry_peak_gib": dry_peak, "measured_peak_gib": peak_gib,
           "resident_gib": resident_gib, "dry_over_measured":
               dry_peak / measured, "trace_s": secs, "card": CARD}
    print(f"[dryrun] {name}: counted {cost.flops:.4g} FLOPs, model_flops "
          f"{useful:.4g} ({row['counted_over_model']:.3f}x); {ms:.2f} ms "
          f"-> {tflops:.2f} TFLOP/s, {100 * row['share_of_peak']:.2f} % of "
          f"{peak_tf:.0f} ({cfg.dtype}); peak: dry {dry_peak:.2f} GiB, "
          f"measured {peak_gib:.2f} less {resident_gib:.2f} resident "
          f"({row['dry_over_measured']:.3f}x) ({CARD})")
    check(dry_peak >= (1 - DRYRUN_PEAK_UNDER) * measured,
          f"[dryrun] {name}: the dry run's peak {dry_peak:.3f} GiB "
          f"undercounts the measured {measured:.3f} GiB by more than "
          f"{DRYRUN_PEAK_UNDER:.0%}")
    check(cost.flops > 0 and np.isfinite(tflops), f"[dryrun] {name}: {row}")
    return row


def dryrun_measure(S, TT, TA, FA, TM, get_config, dev):
    """``--dryrun-only``: the three steps [dryrun] sets beside their dry
    runs, measured here as [train] and [serve] measure them (the train
    phase, then one guarded serve run of gemma3-12b through the decode
    kernel)."""
    train = phase_train(S, TT, TA, FA, get_config, dev)
    arch, cut, batch, plen, max_new, max_len = SERVE_RUNS[1]
    cfg = get_config(arch).replace(**cut)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    model = TM.init(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    prompts = torch.randint(0, cfg.vocab_size, (batch, plen),
                            generator=torch.Generator().manual_seed(SEED)
                            ).numpy()
    step_ms = serve_run(S, cfg, model, prompts, max_new, max_len,
                        "blockspace")[3]
    serve = {"arch": arch, "layers": cfg.n_layers, "batch": batch,
             "prompt": plen, "max_len": max_len,
             "guarded_ms_per_decode_step": step_ms,
             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "resident_gib": resident}
    del model
    torch.cuda.empty_cache()
    return train, serve


def phase_dryrun(train, serve_g, get_config):
    """The dry run's sweep (joined here) and three measured steps beside
    their dry runs on one device: quickstart and gemma3-12b (6 layers)
    training, gemma3-12b's decode step."""
    import importlib
    DR = importlib.import_module("repro_torch.launch.dryrun")
    t0 = time.perf_counter()
    qs, gm = train["quickstart"], train["gemma3_12b"]
    steps = [
        dryrun_step(DR, "quickstart train", get_config("quickstart"),
                    "train", qs["ms_per_step"], qs["peak_gib"],
                    qs["resident_gib"], batch=qs["batch"], seq=qs["seq"]),
        dryrun_step(DR, "gemma3-12b train",
                    get_config("gemma3-12b").replace(n_layers=gm["layers"]),
                    "train", gm["ms_per_step"], gm["peak_gib"],
                    gm["resident_gib"], batch=gm["batch"], seq=gm["seq"]),
        dryrun_step(DR, "gemma3-12b decode", get_config(
            "gemma3-12b").replace(n_layers=serve_g["layers"],
                                  attn_decode_kernel="blockspace"),
                    "decode", serve_g["guarded_ms_per_decode_step"],
                    serve_g["peak_gib"], serve_g["resident_gib"],
                    batch=serve_g["batch"], seq=serve_g["prompt"],
                    max_len=serve_g["max_len"])]
    steps_s = time.perf_counter() - t0
    sweep = dryrun_sweep_done(DR)
    out = {"sweep": sweep, "steps": steps, "steps_seconds": steps_s,
           "join_seconds": time.perf_counter() - t0 - steps_s,
           "card": CARD}
    print(f"[dryrun] the three steps' dry runs {steps_s:.1f} s; waited "
          f"{out['join_seconds']:.1f} s for the sweep ({CARD})")
    return out


PHASE_S: dict = {}


def timed(name, fn, *args):
    """``fn(*args)``, its host seconds kept under ``name`` in PHASE_S."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[name] = round(time.perf_counter() - t0, 1)
    return out


def main():
    if "--compare" in sys.argv[1:]:
        args = sys.argv[sys.argv.index("--compare") + 1:]
        cut = args.index("--parent")
        compare(args[:cut], args[cut + 1:])
        return
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script runs only on a CUDA card")
    isolate_tune_cache()
    sys.path.insert(0, str(ROOT / "src"))
    import importlib

    from repro_torch.configs import get_config
    from repro_torch.core import domain as D
    from repro_torch.core import fractal as F
    from repro_torch.core import paged as P
    from repro_torch.core import tune
    from repro_torch.core.compact import (cell_neighbor_tables,
                                          compact_layout, pack_kv)
    from repro_torch.core.plan import LOWERINGS
    from repro_torch.kernels import _cuda, ops
    from repro_torch.launch import serve as S
    from repro_torch.launch import train as TT
    from repro_torch.models import attention as TA
    from repro_torch.models import model as TM
    from repro_torch.models import ssm as TS
    from repro_torch.runtime import chaos as RC
    TW = importlib.import_module("repro_torch.kernels.sierpinski_write")
    TC = importlib.import_module("repro_torch.kernels.sierpinski_ca")
    FA = importlib.import_module("repro_torch.kernels.flash_attention")
    # f32 matmuls of the plain versions and the model in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = phase_card()
    # [verify]'s static checks need no kernel: they run beside the build
    # wherever [verify] runs (the whole script, --verify-only)
    only = [a for a in sys.argv[1:] if a.endswith("-only")]
    if only in ([], ["--dryrun-only"]):
        start_dryrun_sweep()
    beside = None
    if only in ([], ["--verify-only"]):
        from repro_torch.analysis import verifier as TV
        beside = lambda: verify_static(TV, FA, D, LOWERINGS, dev)  # noqa: E731
    build_s = phase_build(_cuda, beside)
    if "--build-only" in sys.argv[1:]:
        trace_build_done(_cuda)
        if "--sass" in sys.argv[1:]:
            paths = _cuda.build()
            for lib in paths:
                phase_sass(_cuda, paths, lib)
        print("[build-only] built and reported; no phase run, no result")
        return
    if "--decode-only" in sys.argv[1:]:
        decode = decode_timings(FA, P, get_config("quickstart"), dev)
        OUT.parent.mkdir(parents=True, exist_ok=True)
        OUT.write_text(json.dumps({"card": card, "torch": torch.__version__,
                                   "decode": decode}, indent=1))
        print("[decode-only] decode timings written; no result")
        return
    PHASE_S["build"] = round(build_s, 1)
    if "--train-only" in sys.argv[1:]:
        train = timed("train", phase_train, S, TT, TA, FA, get_config, dev)
        OUT.parent.mkdir(parents=True, exist_ok=True)
        OUT.write_text(json.dumps({"card": card, "torch": torch.__version__,
                                   "train": train}, indent=1))
        print("[train-only] the train phase ran; no result")
        return
    if "--families-only" in sys.argv[1:]:
        families = timed("families", phase_families, S, TM, TT, TA, FA, P,
                         get_config, dev)
        OUT.parent.mkdir(parents=True, exist_ok=True)
        OUT.write_text(json.dumps({"card": card, "torch": torch.__version__,
                                   "families": families}, indent=1))
        print(f"[families-only] the families phase ran; no result "
              f"{json.dumps(PHASE_S)}")
        return
    if "--ssm-only" in sys.argv[1:]:
        ssm = timed("ssm", phase_ssm, S, TM, TT, TA, TS, FA, P, get_config,
                    dev)
        OUT.parent.mkdir(parents=True, exist_ok=True)
        OUT.write_text(json.dumps({"card": card, "torch": torch.__version__,
                                   "ssm": ssm}, indent=1))
        print(f"[ssm-only] the ssm phase ran; no result "
              f"{json.dumps(PHASE_S)}")
        return
    if "--mesh-only" in sys.argv[1:]:
        mesh = timed("mesh", phase_mesh, TW, TC, FA, RC, F, LOWERINGS,
                     compact_layout, dev)
        OUT.parent.mkdir(parents=True, exist_ok=True)
        OUT.write_text(json.dumps({"card": card, "torch": torch.__version__,
                                   "mesh": mesh}, indent=1))
        print(f"[mesh-only] the mesh phase ran; no result "
              f"{json.dumps(PHASE_S)}")
        return
    if "--train-mesh-only" in sys.argv[1:]:
        train_mesh = timed("train_mesh", phase_train_mesh, S, TT, TM, FA,
                           get_config, dev)
        OUT.parent.mkdir(parents=True, exist_ok=True)
        OUT.write_text(json.dumps({"card": card, "torch": torch.__version__,
                                   "train_mesh": train_mesh}, indent=1,
                                  default=str))
        print(f"[train-mesh-only] the train-mesh phase ran; no result "
              f"{json.dumps(PHASE_S)}")
        return
    if "--verify-only" in sys.argv[1:]:
        trace_build_done(_cuda)
        ver = timed("verify", phase_verify, TW, TC, FA, P, tune, D,
                    LOWERINGS, compact_layout, dev)
        OUT.parent.mkdir(parents=True, exist_ok=True)
        OUT.write_text(json.dumps({"card": card, "torch": torch.__version__,
                                   "verify": ver}, indent=1))
        print(f"[verify-only] the verify phase ran; no result "
              f"{json.dumps(PHASE_S)}")
        return
    if "--serve-mesh-only" in sys.argv[1:]:
        serve_mesh = timed("serve_mesh", phase_serve_mesh, S, TM, FA, RC,
                           get_config, dev)
        OUT.parent.mkdir(parents=True, exist_ok=True)
        OUT.write_text(json.dumps({"card": card, "torch": torch.__version__,
                                   "serve_mesh": serve_mesh}, indent=1))
        print(f"[serve-mesh-only] the serve-mesh phase ran; no result "
              f"{json.dumps(PHASE_S)}")
        return
    if "--dryrun-only" in sys.argv[1:]:
        train, serve_g = timed("dryrun_measured", dryrun_measure, S, TT,
                               TA, FA, TM, get_config, dev)
        dry = timed("dryrun", phase_dryrun, train, serve_g, get_config)
        OUT.parent.mkdir(parents=True, exist_ok=True)
        OUT.write_text(json.dumps({"card": card, "torch": torch.__version__,
                                   "dryrun": dry, "train": train,
                                   "serve_gemma3_12b": serve_g}, indent=1))
        print(f"[dryrun-only] the dryrun phase ran; no result "
              f"{json.dumps(PHASE_S)}")
        return
    errs = timed("parity", phase_parity, TW, LOWERINGS, dev)
    merge_err(errs, timed("parity_compact", phase_parity_compact, TW, F,
                          LOWERINGS, compact_layout, dev))
    ca_err = timed("parity_ca", phase_parity_ca, TC, F, LOWERINGS,
                   compact_layout, TW, dev)
    merge_err(errs, timed("parity_domains", phase_parity_domains, TW, TC, D,
                          LOWERINGS, compact_layout, dev))
    rows, launches, main_errs, rho1, peak = timed(
        "main", phase_main, ops, TW, F, LOWERINGS, dev)
    merge_err(errs, main_errs)
    ca = timed("ca", phase_ca_main, ops, TC, F, LOWERINGS, compact_layout,
               cell_neighbor_tables, TW, dev)
    comp = timed("compact", phase_compact_main, ops, TW, F, LOWERINGS,
                 compact_layout, dev)
    merge_err(errs, comp["err"])
    doms = timed("domains", phase_domain_main, ops, TW, TC, D, LOWERINGS,
                 compact_layout, dev, comp)
    t_attn = time.perf_counter()
    attn_err, attn_rel, attn_cases = timed(
        "parity_attn", phase_parity_attn, FA, LOWERINGS, pack_kv, P, dev)
    attn_rows, attn_launches = timed("attn", phase_attn, FA, LOWERINGS, dev)
    clones = timed("attn_clones", clone_timings, FA, dev)
    dims = timed("attn_dims", attn_dims, FA, dev)
    serve_runs, models = timed("serve", phase_serve, S, TM, get_config, FA,
                               dev)
    qcfg, qmodel, _ = models["quickstart"]
    paged = timed("paged", phase_paged, S, FA, qcfg, qmodel, dev)
    chaos = timed("chaos", phase_chaos, S, RC, TW, FA, qcfg, qmodel,
                  models["quickstart"][2], dev)
    decode = timed("decode", decode_timings, FA, P, qcfg, dev)
    print(f"[attention phases] {time.perf_counter() - t_attn:.1f} s")
    del models, qmodel
    tuned = timed("tune", phase_tune, tune, TW, TC, FA, compact_layout, qcfg,
                  dev)
    train = timed("train", phase_train, S, TT, TA, FA, get_config, dev)
    families = timed("families", phase_families, S, TM, TT, TA, FA, P,
                     get_config, dev)
    ssm = timed("ssm", phase_ssm, S, TM, TT, TA, TS, FA, P, get_config, dev)
    mesh = timed("mesh", phase_mesh, TW, TC, FA, RC, F, LOWERINGS,
                 compact_layout, dev)
    serve_mesh = timed("serve_mesh", phase_serve_mesh, S, TM, FA, RC,
                       get_config, dev)
    train_mesh = timed("train_mesh", phase_train_mesh, S, TT, TM, FA,
                       get_config, dev)
    trace_build_done(_cuda)
    ver = timed("verify", phase_verify, TW, TC, FA, P, tune, D, LOWERINGS,
                compact_layout, dev)
    dry = timed("dryrun", phase_dryrun, train,
                next(r for r in serve_runs if r["arch"] == "gemma3-12b"),
                get_config)
    at = next(r for r in rows
              if (r["lowering"], r["rho"]) == REPORT_AT)
    source = "src/repro_torch/csrc/sierpinski_write.cu"
    ref = "src/repro/kernels/sierpinski_write.py"
    kernels = []
    domains = ["sierpinski-gasket", "sierpinski-carpet", "vicsek-cross",
               "triangular", "band", "bounding-box"]
    dom_launches = {k: sum(c[k] for c in doms["launches"].values())
                    for k in TW.KERNELS}
    for name, key, replaces in [
            ("sierpinski_write", "write", f"{ref}:171"),
            ("sierpinski_sum_partials", "partials", f"{ref}:418"),
            ("sierpinski_sum_combine", "combine", f"{ref}:513")]:
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": at[f"{key}_ms"],
            "plain_ms": at[f"{key}_plain_ms"],
            "bound_ms": at[f"{key}_bound_ms"],
            "bound_by": at[f"{key}_bound_by"],
            "library_ms": at[f"{key}_library_ms"],
            "at": f"gasket n={N_MAIN} f32 {REPORT_AT[0]} rho={REPORT_AT[1]}",
            "launches_compact_path": comp["launches"][name],
            "launches_domain_paths": dom_launches[name],
            "domain": domains,
        })
    # the packed / embedded domain cells at n = 2**16, rho = 32 (closed_form)
    for entry, key in zip(kernels, ("write", "partials")):
        entry["domain_cells_closed_form"] = {
            f"{r['domain']}{tuple(r['args'])} {r['storage']}": {
                "ms": r[f"{key}_ms"], "bound_ms": r[f"{key}_bound_ms"],
                "library_ms": r[f"{key}_library_ms"]}
            for r in doms["rows"] if r["lowering"] == "closed_form"}
    kernels[-1].update({
        "library_note": "none: partials.sum() adds in another order",
        "reordered_sum_ms": at["combine_reordered_sum_ms"]})
    gm, fuse, rule = CA_REPORT_AT
    ca_at = next(r for r in ca["rows"]
                 if (r["lowering"], r["fuse"], r["rule"]) == CA_REPORT_AT
                 and r["num_stages"] == CA_REPORT_STAGES)
    ca_depths = {str(r["num_stages"]): r["launch_ms"] for r in ca["rows"]
                 if (r["lowering"], r["fuse"], r["rule"]) == CA_REPORT_AT}
    kernels.append({
        "name": "sierpinski_ca_fused", "route": "cuda",
        "source": "src/repro_torch/csrc/sierpinski_ca.cu",
        "replaces": "src/repro/kernels/sierpinski_ca.py:212",
        "launches": ca["launches"]["sierpinski_ca_fused"],
        "max_abs_err": ca_err, "ms": ca_at["launch_ms"],
        "plain_ms": ca_at["plain_ms"], "bound_ms": ca_at["bound_ms"],
        "bound_by": ca_at["bound_by"], "library_ms": None,
        "yardstick": "no single PyTorch call computes a masked CA step; "
                     "the cell-level gather oracle (several calls) per "
                     "launch of the same steps",
        "yardstick_ms": ca["oracle_ms"][rule] * fuse,
        "at": f"gasket n={N_MAIN} rho={CA_RHO} compact f32 {gm} fuse={fuse} "
              f"{rule}, one launch, num_stages={CA_REPORT_STAGES}",
        "ms_by_num_stages": ca_depths, "ctas": ca_at["ctas"],
        "domain": domains,
    })
    # B7: the mma chains inside the write (B7a at n = 2**16, rho = 32;
    # B7c on the causal triangle), timed as the write kernel under mma
    mm = next(r for r in rows if (r["lowering"], r["rho"]) == ("mma", 32))
    tri = next(r for r in doms["rows"]
               if (r["domain"], r["lowering"]) == ("triangular", "mma"))
    tri_cf = next(r for r in doms["rows"]
                  if (r["domain"], r["lowering"]) == ("triangular",
                                                      "closed_form"))
    kernels.append({
        "name": "mma_decode_chains", "route": "cuda",
        "source": "src/repro_torch/csrc/mma_decode.cuh",
        "replaces": "src/repro/core/mma.py:194",
        "launches": launches["mma_decode_chains"],
        "max_abs_err": 0.0, "ms": mm["write_ms"],
        "plain_ms": mm["write_plain_ms"], "bound_ms": mm["write_bound_ms"],
        "bound_by": mm["write_bound_by"],
        "library_ms": mm["write_library_ms"],
        "at": f"the write kernel under mma, gasket n={N_MAIN} f32 rho=32 "
              f"embedded (B7a)",
        "closed_form_ms": at["write_ms"],
        "launches_compact_path": comp["launches"]["mma_decode_chains"],
        "launches_ca_path": ca["launches"]["mma_decode_chains"],
        "launches_domain_paths": dom_launches["mma_decode_chains"],
        "triangular_rows_chain_write_ms": tri["write_ms"],
        "triangular_closed_form_write_ms": tri_cf["write_ms"],
        "triangular_bound_ms": tri["write_bound_ms"],
        # the chains inside the CA: compact parity at rho 32, depth 1, and
        # the packed triangle's CA at fuse 8 (B7c), beside closed_form
        "ca_ms": {f"fuse {r['fuse']} {r['lowering']}": r["launch_ms"]
                  for r in ca["rows"]
                  if r["rule"] == "parity" and r["num_stages"] == 1
                  and r["lowering"] in ("mma", "closed_form")},
        "triangular_ca_fuse8_ms": {r["lowering"]: r["launch_ms"]
                                   for r in doms["ca_rows"]},
        "triangular_ca_bound_ms": doms["ca_rows"][0]["bound_ms"],
    })
    serve_q = next(r for r in serve_runs if r["arch"] == "quickstart")
    serve_g = next(r for r in serve_runs if r["arch"] == "gemma3-12b")
    # the CUDA-core flash kernel (flash_fwd_kernel), which no route takes:
    # held to its plain version by direct launches and on every attn row,
    # timed beside every attn row (cuda_core_ms); not a kernel of the main
    # paths, so not in the kernels line
    g32 = next(r for r in attn_rows if r["case"] == "gemma3-12b causal f32"
               and r["lowering"] == "closed_form")
    at_cf = {r["case"]: r for r in attn_rows
             if r["lowering"] == "closed_form"}
    ragged_keys = ("ms", "cuda_core_ms", "plain_ms", "bound_ms", "bound_by",
                   "library_ms", "max_abs_err", "blocks")
    cuda_core = {
        "kernel": "flash_fwd_kernel", "launches_main_paths":
            attn_launches["flash_attention"],
        "parity_cases": attn_cases["flash_attention"],
        "max_abs_err": max([attn_err["flash_attention"]]
                           + [r["cuda_core_max_abs_err"] for r in attn_rows
                              if "cuda_core_max_abs_err" in r]),
        "ms_by_case": {case: r["cuda_core_ms"] for case, r in at_cf.items()}}
    # the decode kernels (one routine, two front ends): timed at the
    # quickstart serving shapes, with the gemma3-12b decode shape beside
    for name, entry, replaces, launches, extra in [
            ("flash_attention_decode", "flash_attention",
             "src/repro/kernels/flash_attention.py:103",
             serve_q["launches"]["flash_attention_decode"],
             {"launches_gemma3_12b_serve": serve_g["launches"][
                 "flash_attention_decode"],
              "parity_cases": attn_cases["flash_attention_decode"]}),
            ("paged_flash_attention", "paged_flash_attention",
             "src/repro/kernels/flash_attention.py:654",
             paged["launches"]["paged_flash_attention"], {})]:
        row, gem = decode[entry], decode["gemma3-12b"][entry]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(attn_err[name], row["max_abs_err"],
                               gem["max_abs_err"]),
            **device_times(row), "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "at": row["at"],
            "routine": "src/repro_torch/csrc/decode_split.cuh",
            "gemma3_12b": {**device_times(gem), **{key: gem[key] for key in (
                "plain_ms", "bound_ms", "bound_by", "at")}}, **extra})
    # B4's bf16 tile path on the tensor cores: the gemma3-12b rows of the
    # attn phase (counted there), timed at the causal row, closed_form
    tc = {r["case"]: r for r in attn_rows
          if r["kernel"] == "tc" and r["lowering"] == "closed_form"}
    tc_at = tc["gemma3-12b causal"]
    kernels.append({
        "name": "flash_attention_tc", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:103",
        "launches": attn_launches["flash_attention_tc"],
        "max_abs_err": max([attn_err["flash_attention_tc"]]
                           + [r["max_abs_err"] for r in attn_rows
                              if r["kernel"] == "tc"]),
        "max_row_rel_err": max([attn_rel["flash_attention_tc"]]
                               + [r["max_row_rel_err"] for r in attn_rows
                                  if r["kernel"] == "tc"]),
        "row_rtol": FA.ROW_RTOL[torch.bfloat16],
        "ms": tc_at["ms"], "plain_ms": tc_at["plain_ms"],
        "bound_ms": tc_at["bound_ms"], "bound_by": tc_at["bound_by"],
        "library_ms": tc_at["library_ms"],
        "at": f"gemma3-12b causal S {tc_at['s']} B {tc_at['b']} heads "
              f"{tc_at['h']}/{tc_at['hkv']} D {tc_at['d']} bf16, blocks "
              f"{tc_at['blocks']}, closed_form",
        "local_ms": tc["gemma3-12b local"]["ms"],
        "local_bound_ms": tc["gemma3-12b local"]["bound_ms"],
        "local_library_ms": tc["gemma3-12b local"]["library_ms"],
        "cuda_core_ms": tc_at["cuda_core_ms"],
        # the ragged instantiation: S 4104 in 72-token blocks
        "ragged": {key: tc["gemma3-12b causal S 4104"][key]
                   for key in ragged_keys + ("max_row_rel_err",)},
        # rows of 500 bytes in 4-byte pieces: D 250
        "narrow": {key: tc["gemma3-12b causal D 250"][key]
                   for key in ragged_keys + ("max_row_rel_err", "d")},
        "parity_cases": attn_cases["flash_attention_tc"]})
    # B4's f32 prefill on the tensor cores (3xTF32): the quickstart rows of
    # the attn phase (counted there), timed at closed_form
    f32 = [r for r in attn_rows if r["kernel"] == "tc_f32"]
    f32_at = next(r for r in f32 if r["lowering"] == "closed_form")
    kernels.append({
        "name": "flash_attention_tc_f32", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:103",
        "launches": attn_launches["flash_attention_tc_f32"],
        "max_abs_err": max([attn_err["flash_attention_tc_f32"]]
                           + [r["max_abs_err"] for r in f32]),
        "ms": f32_at["ms"], "plain_ms": f32_at["plain_ms"],
        "bound_ms": f32_at["bound_ms"], "bound_by": f32_at["bound_by"],
        "peak": f32_at["peak"], "library_ms": f32_at["library_ms"],
        "library_kernels": f32_at["library_kernels"],
        "cuda_core_ms": f32_at["cuda_core_ms"],
        "at": f"quickstart causal S {f32_at['s']} B {f32_at['b']} heads "
              f"{f32_at['h']}/{f32_at['hkv']} D {f32_at['d']} f32, blocks "
              f"{f32_at['blocks']}, closed_form",
        "gemma3_12b": {key: g32[key] for key in (
            "ms", "cuda_core_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_abs_err")},
        # the ragged instantiation: S 4104 in 72-token blocks
        "ragged": {key: at_cf["quickstart causal S 4104"][key]
                   for key in ragged_keys},
        # rows of 248 bytes in 8-byte pieces: D 62, the exact loops over
        # 64 columns
        "narrow": {key: at_cf["quickstart causal D 62"][key]
                   for key in ragged_keys + ("d",)},
        "parity_cases": attn_cases["flash_attention_tc_f32"],
        "cuda_core_kernel": cuda_core})
    # the [chaos] phase's launches of the kernels it drove, counted there
    chaos_launches = {
        "sierpinski_write": chaos["matrix"]["write_launches"]
        + chaos["canary"]["write_launches"],
        "flash_attention_decode": chaos["transient"]["decode_launches"]
        + chaos["ladder"]["decode_launches"],
        "paged_flash_attention": chaos["paged_ladder"]["paged_launches"]}
    for entry in kernels:
        if entry["name"] in chaos_launches:
            entry["launches_chaos_phase"] = chaos_launches[entry["name"]]
        if entry["name"] == "flash_attention_decode":
            # the Server of the trained quickstart checkpoint
            entry["launches_train_phase"] = train["quickstart"][
                "serve_launches"]["flash_attention_decode"]
    families_kernel_entries(kernels, families)
    ssm_kernel_entries(kernels, ssm)
    mesh_kernel_entries(kernels, mesh)
    serve_mesh_kernel_entries(kernels, serve_mesh)
    train_mesh_kernel_entries(kernels, train_mesh)
    verify_kernel_entries(kernels, ver)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps({
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s, "parity_max_abs_err": errs, "sweep": rows,
        "rho1_write_ms": rho1, "peak_gib": peak, "ca": ca,
        "compact": comp, "domains": doms,
        "attn_parity_max_abs_err": attn_err,
        "attn_parity_max_row_rel_err": attn_rel,
        "attn_parity_cases": attn_cases, "attn_launches": attn_launches,
        "attn": attn_rows, "attn_clones": clones, "attn_dims": dims,
        "serve": serve_runs,
        "paged": paged, "chaos": chaos,
        "decode": decode, "tune": tuned, "train": train,
        "families": families, "ssm": ssm, "mesh": mesh,
        "serve_mesh": serve_mesh, "train_mesh": train_mesh,
        "verify": ver, "dryrun": dry, "kernels": kernels,
        "phase_seconds": PHASE_S,
        "seconds": time.perf_counter() - t_start}, indent=1))
    # the kernels line is long: the phases' seconds come after it, so
    # that the end of the output holds them
    print(json.dumps({"kernels": kernels}))
    print(f"[phases] host seconds: {json.dumps(PHASE_S)}")
    print(f"[done] {time.perf_counter() - t_start:.1f} s; results in "
          f"{OUT.relative_to(ROOT)}")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

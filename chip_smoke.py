#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (laff_tpu_torch) on one NVIDIA card.

  python3 chip_smoke.py          # from the repository root; needs one GPU
  python3 chip_smoke.py --sweep  # phases 1 and 14, with 14(d)-(e)
  python3 chip_smoke.py --multi  # phases 1 and 15 (a)-(g) over four cards
  python3 chip_smoke.py --gate-timing DIR [DIR ...]
                                 # the gate of each checkout DIR in turn

Phases, each asserting; any failure exits non-zero before the last line:

1. Device and build: the card's name and power limit (nvidia-smi), the
   CUDA kernels compiled from laff_tpu_torch/csrc (one nvcc per source), the
   native text featurizer compiled from laff_tpu_torch/native (it must load).
2. Kernels against their plain PyTorch versions on the card, at the main
   path's shapes: sim_rank_wide at the MV-test3k shape (59,800 captions x
   2,990 videos x 4,096) with captions grouped by video (the main path's
   layout) and again with ground truths scattered over the gallery,
   sim_rank_tiled at a gallery above the wide budget (8,192 x 16,384),
   gate_attention at (B, 4, 8, 512) for B 128, 1,024 and 8,192, with
   with_ave off / on and mul on at the eval batch 1,024, and the same at
   FrameLAFF's video-tower shape (B, 5, 8, 512), each launch on the ring
   kernel's layout for its L (packed rows at L 4, whole rows at L 5). The
   build log's registers and spills are printed for every kernel, and a
   gate instantiation of those two routes may not spill. Times are
   CUDA-event medians of one call, and for the gate also the profiler's
   device time and the time per call of 62 calls back to back (one rtest
   pass). Then the rank kernels' edge cases on both branches (the tiled
   one forced by a lowered WIDE_BUDGET): one text row against a gallery
   narrower than a tile, ragged T and V, HD 512 and 2048, a gallery of
   duplicated rows with exact ties, and ground truths outside the gallery
   (rank 0); and the gate's: L, H, dh and B away from the headline (L 6
   and 7 in whole rows and L 8 split by heads at H 8, dh 512; 16 and 31
   heads at L 5, split), x off 16-byte alignment, shapes that take the simple
   gate kernel, each on the layout ``K.gate_layout`` names, logits
   scaled by 100, an all-zero row, g = 0, and a tensor g with no host sync.
   The rank times are taken on the main path's flat f32 embeddings, the
   bf16 cast included, and again on operands already cast.
3. The prediction slice at full width (configs/rehearsal.py, seeded random
   weights) through ``laff_tpu_torch.engine.predictor.main``: a synthetic
   2,990-video x 20-caption world (MV-test3k's shape) with rank_path
   'kernel' (its wall printed as a marker of the host's speed), then an
   8,600-video world (above the wide budget) with rank_path 'kernel'.
   The rtest pass's text featurization must run in the native featurizer.
   Launch counts are zeroed just before and read just after each kernel
   run. The same inputs are embedded again: the kernel run's ranks are held
   against the plain rank version on those bf16 operands, the flat rank
   path's ranks of the same embeddings against their f32 scores (no second
   pass), and the towers against the CPU; one forward of each tower is
   profiled by kernel.
4. The training slice at full width on a 1,500-video x 20-caption world
   (rtrain, B 128, 234 steps an epoch) validating on rval (rtest's shape
   with 5 captions a video), at the default dispatch: the
   train features in device caches, K = 8 steps per dispatch as one CUDA
   graph replayed 8 times, validation batches staged on the card.
   (a) The caches' gathered rows equal the fed batches (bf16 cast
   included) bit for bit on the first 3 batches; cache bytes and build
   seconds. (b) 16 graphed cached steps against 16 eager fed steps from the
   same weights, optimizer state and epoch seed (the graph captured on the
   generator before it is reseeded), dropout on: losses within 1e-5
   relative, parameters within 1e-5 (equal is expected), no host sync and
   no kernel of the port in the graphed steps; the capture seconds. (c)
   Two epochs of ``laff_tpu_torch.engine.trainer.main`` at the
   default Options (plus rank_path 'kernel' and sync_debug, so every window
   of graphed steps between two loss reads runs under
   ``torch.cuda.set_sync_debug_mode("error")``), validating on rval: it
   must choose both caches, K 8 as a graph and staged validation; the loss
   falls, R@1 is above chance, each validation launches the wide rank
   kernel once and the gate 18 times and the steps neither; the second
   validation replays the staged batches and its metrics equal an unstaged
   validate of the same weights exactly; the process's default CUDA
   generator is left as it was. (d) Timings: the graphed step
   (median wall, host enqueue, CUDA events, profiled device time and idle
   share) against the eager step (median wall on batches on the card, its
   forward + backward and optimizer parts, device profile), epoch wall,
   validation wall staging and replayed, and each epoch's wall outside
   train and validation; an unstaged embed_txt pass and a staging
   validation with the text featurizers on their Python path and in the
   native fastfeat, in the order python, native, metrics equal (and equal
   with the bf16 rounding on the host). The fed epoch loop with the caches
   off: 60 single steps through
   ``train_one_epoch`` between two loss reads under sync debug mode
   'error', launch counts zeroed before, none of the port's. (e) 60 steps with
   device_text_featurize=1 (sparse bow, pooled w2v; cached, graphed)
   against the dense fed path: losses within 1e-5 relative. The bigru at
   the rehearsal's GRU width: no host sync, the card against the CPU, a
   CUDA graph of its forward + backward against eager, and its time per
   call with each direction's weights in a cuDNN buffer of their own against
   one buffer for the module. Two steps on the card against the CPU from
   the same weights and batch; (f) the
   trained checkpoint through ``predictor.main`` with rank_path 'kernel',
   its ranks held against the plain version (phase 3 holds the 'flat' path
   on the untrained checkpoint).
5. FrameLAFF at full width (configs/frame_rehearsal.py: the shape of
   FrameLaff_NoFrameFc_StrongCLIP_adjust at parm 0_7_1_12_0_12_0, 512-d
   frame rows pooled by the plain gate beside four video features, L = 5
   locals at the video tower's gate; 91.2 M parameters) on rtrain -> rval
   with 8-60 frames a video, 50 kept: (a), (b) and (d)'s step timings with
   the padded frames in the visual cache, (c) two epochs of trainer.main
   at the default dispatch with the same checks, one step on the card
   against the CPU, and the trained checkpoint through ``predictor.main``
   (rank_path 'kernel'), timed by phase.
6. The single-space models and checkpoint interchange at full width.
   (a) W2VVPP (configs/concat_rehearsal.py): 'concat' fusion on both
   towers tied by txt_fc_same_with_vis_fc (the '__concat__' tie), bow, w2v
   and GRU text against the four video features, on ctrain -> ctest (the
   shape of rtrain -> rtest over a 3,852-word vocabulary, which makes the
   two concatenations equally wide; ctest cut to 5 captions a video): the
   caches and 16 graphed steps
   against eager ones, two epochs of trainer.main at the default dispatch
   (each validation one wide rank launch, no gate), the trained checkpoint
   through predictor.main with rank_path 'kernel', the kernel ranks held
   against the plain version. (b) The rest of the attention
   zoo (kinds 2, 4, 5, 6, 10, 11, 16 at the rehearsal's parm
   0_<k>_0_<k>_1_0_0): two steps on the card against the CPU each (32
   pairs of the first batch), and for
   kind 5 (its QKV dropout on) 16 graphed steps against 16 eager ones. (c)
   One validation of phase 4's trained model with measure 'hist': no rank
   kernel launch, its ranks equal the same embeddings' on the card and,
   for every 29th caption, on the CPU. (d) Phase 4's trained checkpoint
   written in the reference layout (save_torch_checkpoint) and read back:
   the same spec and state dict, predictor.main on the .pth.tar gives the
   port file's rows, ranks and launches on rval, --pretrained_file_path from
   either file the same first-step loss; the export and the load and
   convert timed.

7. Negation-aware retrieval, task2 and the prediction post-processing at
   the rehearsal's full width, on t3train (rtrain's shape, with a
   false-caption set and per-video object captions) -> t3test (rtest's
   2,990 videos with 5 captions each, a third of them with a negation cue,
   and its negation set). (a) task3: two epochs of trainer.main with
   --task3_caption: the visual cache, no text cache, K 1 eager; the loss
   falls, R@1 above chance, 1 wide rank and 18 gate launches per
   validation, the task3_*
   metrics and task3val scalars written; one step card vs CPU (loss and
   BatchNorm statistics within 1e-2, dropout off), the eager step timed
   with and without its false caption and profiled. (b) task2
   (--task2_intended 1, a few hundred concepts over the 5,376-wide video
   concat): the labels in the visual cache, 16 graphed steps against 16
   eager ones, one epoch of trainer.main at the default dispatch (both
   caches, K 8 graphed), one step card vs CPU. (c) predictor.main with
   --task3_caption on t3test under (a)'s checkpoint: the negated queries
   counted, 48 gate launches (the queries and both clauses) and no rank
   kernel, its t2v row against eval_t2v of the plain path's adjusted
   scores from the same card embeddings. (d) On vtest (1,500 videos x 5
   captions, the VATEX test shape, with a concept pkl): --rerank tkb and
   concept, and --rerank kreciprocal and --each_head 1 on vheads (500
   videos with 1 caption each), under (a)'s checkpoint,
   each re-rank's wall time, each re-ranked t2v row against the port's host
   function on the same embeddings moved to the CPU, the 8 per-head score
   files and perf.txt checked (and deleted).
8. AVS ad-hoc search at iacc.3's size (335,944 shots, 7.22 GB of the four
   rehearsal video features, three editions of 30 topics with stratified
   qrels: laff_tpu_torch.data.synth.build_avs_world, timed, removed at the
   end) under phase 4's trained checkpoint. predictor.main answers
   tv16/tv17.avs.txt (tv18 is built, not streamed) at batch 1,024,
   streaming the gallery through the video tower for each set: the gate
   only, 1 + 329 launches a set, no rank kernel; each id.sent.score.txt 30
   lines of 2,000 descending (id, score) pairs, t2v.pkl their top 500; each
   phase timed, with gallery videos/s. One set again with the gallery
   embedded whole (LARGE_GALLERY raised) and scored by score_matrix: the
   scores within 1e-6 of the streamed ones and the lists equal but at near
   ties. The gate kernel against its plain version on the video tower's
   input for a gallery block; one streamed pass under the profiler (the
   card's busy share). laff_tpu_torch.cli.avs_eval on each streamed
   edition: the trained run's infAP at least 5x a seeded random run's over
   the gallery's shots, and equal to the NIST sample_eval.pl's within 2e-4
   where perl is installed.
9. The large benchmark gallery and the int8 gallery, inside phase 8 before
   its world is removed: ibench, a benchmark caption set over iacc.3's
   gallery (its features linked), 20 captions for each of 500 shots spread
   over it (10,000 captions; the other shots distractors). (a)
   predictor.main at batch 1,024 takes the streamed benchmark branch
   (streaming_benchmark_eval) with the gallery cached on the card in f32:
   the gate 10 + 329 times, no rank kernel, no score_matrix or
   score_matrix_streaming call; held against the gallery embedded whole
   and scored in row blocks: t2v ranks, each captioned shot's v2t ranks
   and each caption's top 2,000 (t2v.pkl) equal but at near ties. (b), the
   same uncached, is cut for the script's time; the CPU tests hold it to
   (a). (c) streaming_benchmark_eval called directly on bf16
   text and the tower's outputs cast to bf16, rank_path 'kernel': a bf16
   cache, one sim_rank_tiled launch and the gate 329 times, the ranks held
   against the plain version on the same bf16 rows, and the tiled kernel
   timed at T 10,000 x V 335,944 x 4,096 against its bound and cuBLAS bf16
   plus counting (its device time from a profiler session around one call,
   or, where this process's profiler records nothing, around the same call
   on seeded rows of that shape in a fresh process: ``--tiled-worker``).
   (d) predictor.main with --int8_gallery 1 on tv16.avs.txt:
   the gate 1 + 329 + one launch per 1,024 nominated videos, the score file
   against phase 8's exact streamed one (each topic's top 2,000 overlapping
   at least 0.99, shared scores within 1e-6, infAP within 0.01).
10. The StrongCLIP text-tower swap, right after phase 5: phase 5's trained
   FrameLAFF checkpoint under the config name
   FrameLaff_NoFrameFc_StrongCLIP_adjust and a seeded ViT-B/32-shaped CLIP
   text tower (63.4 M parameters, 254 MB of f32) in the reference's layout
   at rval/TextData/clip_synth/model_best.pth.tar; predictor.main on rval
   (rank_path 'kernel'): the tower swapped in once and every 'clip' row
   its output, phase 5's launches (1 wide rank, 18 gate), the kernel ranks
   against the plain version on the re-embedded operands, the tower on the
   card against the CPU for 256 captions within 1e-4 of the largest value,
   the TF32 flags as found, embed_txt with the tower's and the
   tokenizer's shares.
11. End2EndClip (configs/end2end_clip.py: ViT-B/32 towers, 151.3 M
   parameters, 8 frames a video at 224 px, Adam at lr/20) on a raw-frame
   world written with Pillow (e2etrain 128 videos x 2 captions, e2eval 64
   x 2, 12 JPEG frames of 240 x 320 a video) at B 32, after phase 9: one
   step on the card against the CPU from the same weights on the first 8
   videos of the first batch (the loss within 1e-4 relative, the
   parameters within 1e-4 of the largest), the step at B 32 timed; two epochs of engine.end2end.main through
   cli/do_trainer with rank_path 'kernel' (finite losses, one wide rank
   launch and no gate launch a validation, model_best.pth.tar written,
   the decode wait and peak device bytes); a validation with
   --stage_val_features 0 equal to the staged run's last.
12. The in-graph BERT text tower, before phase 8: configs/bert_rehearsal.py
   (rehearsal's towers with the precomputed CLIP text rows replaced by
   BERT-base, 109.5 M parameters at 64 tokens, trained at lr/20 in f32) on
   btrain -> bval (500 videos x 20 and x 10 captions, 78 steps of 128 an
   epoch). (a) A seeded BERT-base checkout written under build/chip_smoke/
   (config.json, a 30,522-line vocab.txt, model.safetensors) and imported
   bit for bit; the pooler on the card against the CPU for 64 captions and
   the frozen LiveBertTextFeaturizer's rows against the CPU's, within 1e-4
   of the largest value; the trainer's tower starts from the checkout. (b)
   One step moves BERT by 1/20 of the unscaled update of the same step (the
   other parameters by that update); two steps card vs CPU on 8 pairs
   within 1e-2. (c) Two epochs of trainer.main at the default dispatch (both
   caches with the int32 token rows, K 8 as a CUDA graph, staged
   validation): the loss falls, R@1 above chance, one wide rank and 11 gate
   launches a validation; the graphed step against BERT's f32 bound, the
   capture and peak device bytes. (d) The trained checkpoint through
   predictor.main on bval (rank_path 'kernel'), the ranks against the plain
   version.
13. Serving, inside phase 8 after phase 9: engine.service.RetrievalService
   on phase 12's checkpoint over iacc.3's 335,944 shots (a 2.75 GB bf16
   gallery, capacity for 1,024 more, snapshotted; the gate 657 times):
   searches at the query buckets 1, 8, 64 and 512 with k 10 and 1,000
   against one plain product and sort on the same bf16 operands (ids equal
   but at near ties, scores within 1e-5), timed against the f32 product's
   bound, one search profiled (busy share); 32 threads through MicroBatcher
   in fewer dispatches, each dispatch equal bit for bit to its queries
   searched directly, and against one direct call of the 32 the same ids
   but at near ties, scores within 1e-5 at its bucket; do_server's handler on
   127.0.0.1 port 0 (/healthz, /search, a 400 for k 0, /ingest of 1,024
   rows into the capacity, found by /search, /metrics); a restart from the
   snapshot bit for bit; the int8 gallery (1.38 GB) against the bf16 order
   (top-1 but at near ties, top-100 overlap at least 0.9).

14. Seed sweeps and orchestration, after phase 12 (before phase 8), at
   configs/rehearsal.py's full width on strain -> sval and stest (500
   videos x 20 captions each). (a) engine.sweep.sweep_main: 3 seeds x 2
   epochs of 78 steps at the default dispatch (both caches, K 8 as one CUDA
   graph a seed, captured with the seed's own generator; the seeds'
   dispatches in turn; validation staged once for all), rank_path
   'kernel', sync debug on: each seed's epoch losses, metrics and weights
   against a trainer.main run of that seed (bit for bit, or within the
   spread of two trainer.main runs of one seed, measured then); one wide
   rank and 11 gate launches a seed's validation, none in the steps; the
   sweep's wall against the three runs one after another, captures, ms per
   graphed step, peak device bytes. (b) engine.orchestrate.retrieval_task
   with batch_seeds over 2 seeds and one parm (one epoch through
   sweep_main), then stest predicted per seed: the model directories, the
   result file's rows, one wide rank and 42 gate launches a prediction.
   (c) inside phase 8: orchestrate.avs_task on tv16 of iacc.3 from (a)'s
   first checkpoint, training skipped: 1 + 329 gate launches, the TRECVID
   xml, infAP at least 5x the random run's.

15. The mesh paths (``laff_tpu_torch.parallel``) over an NCCL group of one:
   (a) inside phase 3, on rtest's resident embeddings, sharded_t2v_ranks,
   sharded_topk and sharded_int8_topk (512 queries, k 1,000) bit for bit
   against the one-card functions (the flat ranks, blocked_topk); (b) after
   phase 12, RetrievalService(mesh=) on its BERT checkpoint over bval, bf16
   and int8, bit for bit against the one-card service (searches, an ingest,
   the snapshot the mesh writes restored on one card).

16. Seed sweeps over a mesh of one, after phase 14 (before phase 8):
   engine.sweep.sweep_main at configs/rehearsal.py's full width on strain
   -> sval, 2 seeds x 1 epoch, over an NCCL group of one, with the seed
   axis (parallel.data_parallel_mesh(1)) and with the seed x dp layout
   (parallel.seed_data_mesh(1, 1)): each seed's losses, metrics and best
   checkpoint against the one-card sweep_main of the same seeds, bit for
   bit or within the spread of two one-card runs (phase 14's rule); one
   wide rank and 11 gate launches a seed's validation, none in the steps.

Cuts of depth that make room for phase 16 (each path still runs, and
every kernel is still launched and held against its plain version):
phase 3's 'flat' pass (its ranks now come from the re-embedded operands,
without a second rank dump and v2t); phases 4, 5 and 10 and 6(c)-(d)
validate and predict on rval, 5 captions a video, not rtest's 20 (the
MV-test3k-shaped pass of phase 3 stays whole); vtest 10 -> 5 captions a
video; bval 20 -> 10. The earlier cuts: t3test and ctest at 5
captions a video, vheads 500 x 1, e2etrain at 128 videos, phase 9(b) removed, phases 4(f)
and 6(a) without 'flat' passes, tv18 built but not streamed.

Prints the kernels JSON line (all three kernels; launches: each main path
counted from 0 around its run, summed, and by path, phases 10-16's
included; rbig and phase 9(c) for the tiled kernel), then ``{"ok": true,
"device": ...}`` last.

``--multi`` needs four cards of one host and runs phase 1, then
spawns four ranks through ``laff_tpu_torch.parallel.launch``, one a card
(NCCL), each through (a)-(f), after (g); rank 0 checks against one card's results,
which it computes on its card while the others wait: (a) sim_engine at the
MV-test3k shape (ranks, exactly) and over an iacc.3-sized bf16 gallery
(335,944 x 4,096; the f32 and int8 top 1,000 of 512 queries, exactly; rows
duplicated across the shard boundaries), timed against one card; (b)
RetrievalService(mesh=) over iacc.3 on a seeded bert_rehearsal checkpoint,
bf16 (snapshotted, an ingest of 1,024, a restart) and int8, lists equal to
one card's but near ties (1e-6), builds and searches timed; (c)
predictor.main with data_parallel 4 on rtest (rank_path 'kernel'): the gate
on every card and the wide rank kernel on rank 0 alone, metrics within
1e-5 of one card's run at the per-card batch, its rows written once; (d)
the trainer with data_parallel 4 on rtrain -> rtest at global B 128 (K 8
graphed, dropout on): the first dispatch's losses (1e-4 relative) and
parameters (f32 towers: 1e-4 of each tensor's largest; bf16: 0.05 of it
and 1.5 of one card's update in norm, the tensors that the dispatch's Adam
steps made left out, and those whose gradient is rounding noise: one
card's bf16 gradient further than half the f32 one's norm from it) against
one card's run from the same seed, and a control run whose gradient
all-reduce loses a rank's share, read the same way, which must miss them;
two epochs (the loss falls, R@1 above
chance), ms per graphed step, the all-reduce and a profiled dispatch (the
device's idle share from the union of its non-NCCL kernels), then an
epoch at 128 a card; (e) the seed axis: sweep_main(mesh=) of 4 seeds x 2
epochs on strain -> sval, one seed a card, against the one-card sweep of
the same seeds on card 0 (bit for bit, or within phase 14's spread rule),
the gate and the wide rank kernel on every card, the walls and ms per
graphed step; (f) the seed x dp layout, seed_data_mesh(2, 2): each row's
TrainRun(mesh=row) read after its first dispatch as (d) reads it, under
(d)'s limits, f32 and bf16 (bf16 losses within 1e-3: rounding drifts them
further on two cards a row; a control run must miss that), against its
seed's one-card run; (d)'s reading of seed 0 over the four cards, printed
as a witness; then one epoch of sweep_main(mesh=) (the wide rank kernel on each row's first card
alone, the gate on all four); (g) ``python -m
laff_tpu_torch.cli.multihost_smoke --procs 4``: four processes joined from
torchrun's variables over NCCL, its three checks. It prints
the figures as one JSON line, then the ``{"ok": true, ...}`` line.
Everything it writes goes under build/ in the repository.

``--bert-serve`` runs phases 1, 12 and 13 alone (13 on phase 8's world).
``--sweep`` runs phases 1 and 14 alone ((c) on an iacc.3 world of its own),
then (d) ``python -m laff_tpu_torch.cli.reproduce_mvtest3k --dry_run`` and
(e) ``cli/do_pretrain_gcc_train_avs.py`` at rehearsal width (stage 1 on
gtrain, stage 2 on strain -> sval, tv16 of iacc.3; the fine-tune starts
from the pretrain's checkpoint, infAP at least 5x a random run's, a second
call skips stage 1).
``--gate-timing`` runs only the gate: each DIR (a checkout, e.g. the parent
commit unpacked under build/) in its own process, with its own wrapper and
kernel sources, its build's registers and spills printed, held against its
plain version and timed as in phase 2 at L 4 and 5, B 128, 1,024 and 8,192,
and at (B 1,024, L 16, H 1, dh 1024), which runs the multi-pass kernel.
"""

import contextlib
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet; dense, 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_BF16_OPS_S = 989e12
PEAK_F32_OPS_S = 67e12

# kernel vs plain: scores are f32 accumulations of the same bf16 products in
# other orders (about 1e-6 apart at HD = 4096); a rank may move only across
# columns scoring within this distance of the ground truth
SCORE_TIE_TOL = 1e-4
GATE_TOL = 1e-5  # f32 unit vectors, reductions in another order
# GPU towers (bf16 linears on cuBLAS, the gate kernel) vs the same model on
# the CPU (plain versions): a few bf16 ulps on unit-scale activations
TOWER_TOL = 4e-2


class SmokeFailure(Exception):
    pass


# a --multi rank's failed checks: raised after its last collective, so that a
# failing check on one rank never leaves the others waiting in a collective
DEFERRED = None


def check(cond, msg):
    if not cond:
        if DEFERRED is not None:
            DEFERRED.append(msg)
            log(f"chip_smoke: FAIL (raised at the end of the ranks' run): {msg}")
            return
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def time_ms(torch, fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def device_ms(torch, fn, reps=5):
    """Device time per call of each CUDA kernel that ``fn`` launches, by
    name (torch.profiler); empty when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
        if us:
            out[e.key] = us / 1e3 / reps
    return out


def bound_ms(n_bytes, ops, peak_ops):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def unit_heads(torch, gen, n, heads=8, dh=512):
    x = torch.randn(n, heads, dh, generator=gen, device="cuda")
    return x / x.norm(dim=-1, keepdim=True)


def rank_moves_explained(torch, ranks_a, ranks_b, tn, vn, gt, tol):
    """Every row whose ranks differ has at least that many columns scoring
    within ``tol`` of its ground truth (scores in f64 from the bf16 rows)."""
    diff = (ranks_a.long() - ranks_b.long()).abs()
    rows = torch.nonzero(diff).flatten()
    vd = vn.double()
    for chunk in rows.split(512):
        s = tn[chunk].double() @ vd.T
        g = s.gather(1, gt[chunk].long()[:, None])
        near = ((s - g).abs() <= tol).sum(dim=1) - 1
        if bool((diff[chunk] > near).any()):
            return False, int(diff.max())
    return True, int(diff.max()) if diff.numel() else 0


def held_against_plain(torch, K, name, txt, vis, gt):
    """The kernel's ranks against the plain version's on the same inputs:
    equal except at near ties. Returns (max |rank diff|, share of rows equal)."""
    t, v = txt.shape[0], vis.shape[0]
    before = K.LAUNCHES[name]
    ranks = K.fused_sim_rank(txt, vis, gt, prenormalized=True)
    torch.cuda.synchronize()
    check(K.LAUNCHES[name] == before + 1, f"{name}: the wrapper did not launch it")
    plain = K.fused_sim_rank_plain(txt, vis, gt, prenormalized=True)
    torch.cuda.synchronize()
    tn = txt.reshape(t, -1).to(torch.bfloat16)
    vn = vis.reshape(v, -1).to(torch.bfloat16)
    ok, max_err = rank_moves_explained(torch, ranks, plain, tn, vn, gt, SCORE_TIE_TOL)
    check(ok, f"{name} (T={t}, V={v}): ranks differ from the plain version beyond near ties")
    check(bool(((ranks >= 1) & (ranks <= v)).all()), f"{name}: ranks out of range")
    return max_err, float((ranks == plain).float().mean())


def sim_rank_phase(torch, K, name, t, v, captions_per_video, gen):
    hd = 8 * 512
    txt = unit_heads(torch, gen, t)
    vis = unit_heads(torch, gen, v)
    if captions_per_video:
        gt = (torch.arange(t, device="cuda") // captions_per_video).int()
    else:
        gt = torch.randint(0, v, (t,), generator=gen, device="cuda").int()
    wide = K.is_wide(v, hd)
    check(wide == (name == "sim_rank_wide"), f"{name}: shape takes the other branch")
    max_err, equal = held_against_plain(torch, K, name, txt, vis, gt)
    exact = K.fused_sim_rank(vis[gt[:1024].long()], vis, gt[:1024], prenormalized=True)
    check(bool((exact == 1).all()), f"{name}: an exact match did not rank 1")

    # ms, plain_ms and library_ms take what the main path passes
    # (evaluator.t2v_ranks): flat f32 embeddings, the bf16 cast included;
    # bf16_ms and library_bf16_ms take the operands already cast
    tf, vf = txt.reshape(t, -1), vis.reshape(v, -1)
    tn, vn = tf.to(torch.bfloat16), vf.to(torch.bfloat16)
    from laff_tpu_torch.eval.metrics import ranks_from_scores

    def library(a, b):  # cuBLAS bf16 product + torch counting: the yardstick
        return ranks_from_scores((a.to(torch.bfloat16) @ b.to(torch.bfloat16).T).float(), gt)

    ms = time_ms(torch, lambda: K.fused_sim_rank(tf, vf, gt, prenormalized=True))
    bf16_ms = time_ms(torch, lambda: K.fused_sim_rank(tn, vn, gt, prenormalized=True))
    device = device_ms(torch, lambda: K.fused_sim_rank(tf, vf, gt, prenormalized=True))
    launch_ms = sum(v_ms for k, v_ms in device.items() if "sim_rank_kernel" in k)
    plain_ms = time_ms(torch, lambda: K.fused_sim_rank_plain(tf, vf, gt, prenormalized=True),
                       reps=3)
    library_ms = time_ms(torch, lambda: library(tf, vf), reps=3)
    library_bf16_ms = time_ms(torch, lambda: library(tn, vn), reps=3)
    b_ms, b_by = bound_ms((t + v) * hd * 4 + 2 * t * 4, 2.0 * t * v * hd, PEAK_BF16_OPS_S)
    layout = f"{captions_per_video} captions per video" if captions_per_video else "scattered gt"
    top = sorted(device.items(), key=lambda kv: -kv[1])[:6]
    log(f"{name}: T={t} V={v} HD={hd}, {layout}: rows equal to plain {equal:.6f}, "
        f"max |rank diff| {max_err} (near ties within {SCORE_TIE_TOL}); from f32 embeddings "
        f"(cast included): kernel {ms:.3f} ms (sim_rank_kernel launches {launch_ms:.3f} ms "
        f"on the device), plain {plain_ms:.3f} ms, matmul+count {library_ms:.3f} ms; from "
        f"bf16 operands: kernel {bf16_ms:.3f} ms, matmul+count {library_bf16_ms:.3f} ms; "
        f"bound {b_ms:.3f} ms ({b_by})")
    log("  device ms per call: " + "; ".join(f"{k[:60]} {v_ms:.3f}" for k, v_ms in top))
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms, "bf16_ms": bf16_ms,
            "library_bf16_ms": library_bf16_ms}


def sim_rank_edge_phase(torch, K, gen):
    """Both rank branches at the edges of the tiling, each held against the
    plain version; the tiled branch is forced by lowering WIDE_BUDGET."""
    budget = K.WIDE_BUDGET
    try:
        for name, branch_budget in (("sim_rank_wide", budget), ("sim_rank_tiled", 1)):
            K.WIDE_BUDGET = branch_budget
            for t, v, hd in ((1, 100, 4096), (300, 200, 4096), (777, 1000, 512),
                             (1000, 700, 2048)):
                txt = unit_heads(torch, gen, t, hd // 512 if hd > 512 else 1, min(hd, 512))
                vis = unit_heads(torch, gen, v, hd // 512 if hd > 512 else 1, min(hd, 512))
                gt = torch.randint(0, v, (t,), generator=gen, device="cuda").int()
                held_against_plain(torch, K, name, txt, vis, gt)
                exact = K.fused_sim_rank(vis[gt.long()], vis, gt, prenormalized=True)
                check(bool((exact == 1).all()),
                      f"{name} (T={t}, V={v}, HD={hd}): an exact match did not rank 1")
            # duplicated gallery rows with entries in {-1, 0, 1} / 64: every
            # score is exact in f32 whatever the summation order, so copies
            # tie exactly and the larger index must win, as in the plain version
            base = torch.randint(-1, 2, (300, 512), generator=gen, device="cuda").float() / 64
            vis = torch.cat([base, base])
            pick = torch.randint(0, 300, (512,), generator=gen, device="cuda")
            gt = (pick + 300 * torch.randint(0, 2, (512,), generator=gen, device="cuda")).int()
            ranks = K.fused_sim_rank(base[pick], vis, gt, prenormalized=True)
            plain = K.fused_sim_rank_plain(base[pick], vis, gt, prenormalized=True)
            s = base[pick].double() @ vis.double().T
            g = s.gather(1, gt.long()[:, None])
            cols = torch.arange(600, device="cuda")
            expect = 1 + ((s > g) | ((s == g) & (cols > gt.long()[:, None]))).sum(dim=1)
            check(bool((plain == expect).all()), f"{name}: plain version breaks exact ties wrongly")
            check(bool((ranks == expect).all()), f"{name}: kernel breaks exact ties wrongly "
                  f"({int((ranks != expect).sum())} of 512 rows)")
            # ground truths outside [0, V) get rank 0; the other rows keep theirs
            txt, vis = unit_heads(torch, gen, 300), unit_heads(torch, gen, 200)
            gt = torch.randint(0, 200, (300,), generator=gen, device="cuda").int()
            bad = torch.tensor([0, 77, 299], device="cuda")
            gt[bad] = torch.tensor([-1, 200, 2**31 - 1], dtype=torch.int32, device="cuda")
            ranks = K.fused_sim_rank(txt, vis, gt, prenormalized=True)
            plain = K.fused_sim_rank_plain(txt, vis, gt, prenormalized=True)
            check(bool((ranks[bad] == 0).all() and (plain[bad] == 0).all()),
                  f"{name}: a ground truth outside the gallery did not give rank 0")
            keep = torch.ones(300, dtype=torch.bool, device="cuda")
            keep[bad] = False
            ok, _ = rank_moves_explained(torch, ranks[keep], plain[keep],
                                         txt.reshape(300, -1)[keep].to(torch.bfloat16),
                                         vis.reshape(200, -1).to(torch.bfloat16), gt[keep],
                                         SCORE_TIE_TOL)
            check(ok and bool((ranks[keep] >= 1).all()),
                  f"{name}: out-of-range ground truths moved the other rows' ranks")
    finally:
        K.WIDE_BUDGET = budget
    log("sim_rank edge cases (T=1 with V < a tile, ragged T and V, HD 512 / 2048 / 4096, "
        "duplicated gallery rows, ground truths outside the gallery), both branches: held "
        "against the plain version; exact matches rank 1; exact ties break "
        "larger-index-first; out-of-range ground truths rank 0")


GATE_BATCHES = (128, 1024, 8192)  # the training batch, the eval batch, a large eval batch
GATE_OPTIONS = ((False, False), (True, False), (True, True))  # (with_ave, mul)
GATE_RUN = 62  # gate calls of one rtest prediction pass: 59 text + 3 video batches


def gate_inputs(torch, gen, b, l=4, h=8, dh=512, k_scale=1.0):
    x = torch.randn(b, l, h, dh, generator=gen, device="cuda")
    bound = k_scale / dh ** 0.5
    k = (torch.rand(h, dh, generator=gen, device="cuda") * 2 - 1) * bound
    bias = (torch.rand(h, generator=gen, device="cuda") * 2 - 1) * bound
    return x, k, bias


def gate_times(torch, K, x, k, bias, g, with_ave, mul):
    """ms: CUDA events around one wrapper call; device_ms: the profiler's
    device time of the gate kernels per call (None when it records none);
    run_ms: GATE_RUN calls back to back, per call (what the embed loop sees)."""
    def call():
        return K.fused_gate_attention(x, k, bias, g, with_ave, mul)

    by_name = device_ms(torch, call, reps=20)
    dev = [v for name, v in by_name.items() if "gate" in name]
    return {"ms": time_ms(torch, call, 20), "device_ms": sum(dev) if dev else None,
            "run_ms": time_ms(torch, lambda: [call() for _ in range(GATE_RUN)], 5) / GATE_RUN}


def fmt_ms(v):
    return "not measured" if v is None else f"{v:.4f}"


def gate_phase(torch, K, gen, l=4, batches=GATE_BATCHES):
    """The gate at (L, H 8, dh 512), L 4 on the LAFF path, 5 in FrameLAFF's
    video tower: against the plain version at the eval batch for every
    option set, then timed at each of ``batches``. g is a tensor on the
    card, as the towers pass it."""
    g = torch.tensor(0.8, device="cuda")
    layout = K.gate_layout(l, 8, 512)
    out = {}
    for b in batches:
        x, k, bias = gate_inputs(torch, gen, b, l)
        for with_ave, mul in GATE_OPTIONS if b == 1024 else GATE_OPTIONS[:1]:
            before = K.LAUNCHES["gate_attention"]
            before_layout = K.GATE_LAUNCHES.get((layout, l), 0)
            got = K.fused_gate_attention(x, k, bias, g, with_ave=with_ave, mul=mul)
            ref = K.fused_gate_attention_plain(x, k, bias, g, with_ave=with_ave, mul=mul)
            torch.cuda.synchronize()
            check(K.LAUNCHES["gate_attention"] == before + 1
                  and K.GATE_LAUNCHES.get((layout, l), 0) == before_layout + 1,
                  f"gate: (B={b}, L={l}, H=8, dh=512) did not take the ring kernel's "
                  f"{layout} layout: {K.GATE_LAUNCHES}")
            err = float((got - ref).abs().max())
            check(err <= GATE_TOL, f"gate B={b} with_ave={with_ave} mul={mul}: max err {err}")
            row = gate_times(torch, K, x, k, bias, g, with_ave, mul)
            row["plain_ms"] = time_ms(torch, lambda: K.fused_gate_attention_plain(
                x, k, bias, g, with_ave, mul), 20)
            n_bytes = (x.numel() + k.numel() + bias.numel() + got.numel()) * 4
            ops = x.numel() * (10 if mul else 8)  # mean, logits, weighted sum, norm
            row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, ops, PEAK_F32_OPS_S)
            row.update(max_abs_err=err, library_ms=None)
            share = ("" if row["device_ms"] is None
                     else f" ({row['bound_ms'] / row['device_ms']:.0%} of the bound)")
            log(f"gate_attention (B={b}, L={l}, H=8, dh=512; {layout}) with_ave={with_ave} "
                f"mul={mul}: max abs err {err:.3g}; device {fmt_ms(row['device_ms'])} ms{share}, "
                f"call {row['ms']:.4f} ms, {GATE_RUN} calls back to back "
                f"{row['run_ms']:.4f} ms per call, plain {row['plain_ms']:.4f} ms, "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
            out[(b, with_ave, mul)] = row
    # the main path's gate (eval batch, with_ave off, mul off) is the row; the
    # worst error over the option sets is reported with it
    row = dict(out[(1024, False, False)])
    row["max_abs_err"] = max(r["max_abs_err"] for r in out.values())
    return row


def gate_edge_phase(torch, K, gen):
    """The gate away from the headline, each case against the plain version
    to GATE_TOL, and on the kernel and layout that the C entry point should
    choose (``K.gate_layout``, its mirror): the ring kernel when dh % 4 == 0,
    x is 16-byte aligned and one head's L slices fit a stage, in packed
    rows, whole rows or a head split by the bytes of a row; else the simple
    kernel."""
    def run(x, k, bias, g, with_ave, mul, what):
        aligned = x.data_ptr() % 16 == 0
        l, h, dh = x.shape[1:]
        layout = K.gate_layout(l, h, dh, aligned)
        name = "gate_attention_simple" if layout == "simple" else "gate_attention"
        before = dict(K.LAUNCHES)
        before_layout = dict(K.GATE_LAUNCHES)
        got = K.fused_gate_attention(x, k, bias, g, with_ave=with_ave, mul=mul)
        ref = K.fused_gate_attention_plain(x, k, bias, g, with_ave=with_ave, mul=mul)
        torch.cuda.synchronize()
        check(K.LAUNCHES[name] == before[name] + 1 and sum(K.LAUNCHES.values())
              == sum(before.values()) + 1, f"gate {what}: did not take {name}")
        check(K.GATE_LAUNCHES.get((layout, l), 0) == before_layout.get((layout, l), 0) + 1,
              f"gate {what}: the C entry point did not choose the {layout} layout")
        layouts[layout] = layouts.get(layout, 0) + 1
        check(bool(torch.isfinite(got).all()), f"gate {what}: non-finite output")
        err = float((got - ref).abs().max())
        check(err <= GATE_TOL, f"gate {what} with_ave={with_ave} mul={mul}: max err {err}")
        return got

    counts = dict(K.LAUNCHES)
    layouts = {}
    i = 0
    for l in (1, 2, 5, 16):
        for h in (1, 4, 16):
            for dh in (8, 130, 1024):
                b = (1, 3, 4099)[i % 3]
                with_ave, mul = GATE_OPTIONS[(i // 3) % 3]
                x, k, bias = gate_inputs(torch, gen, b, l, h, dh)
                run(x, k, bias, 0.8, with_ave, mul, f"(B={b}, L={l}, H={h}, dh={dh})")
                i += 1
    # L 6 and 7 in whole rows, L 8 split by heads, at H 8, dh 512
    # (registers); 16 and 31 heads at L 5, split by heads
    for l in (6, 7, 8):
        for b in (3, 1024):
            x, k, bias = gate_inputs(torch, gen, b, l)
            for with_ave, mul in GATE_OPTIONS if b == 1024 else GATE_OPTIONS[:1]:
                run(x, k, bias, 0.8, with_ave, mul, f"(B={b}, L={l}, H=8, dh=512)")
    for b, h, dh in ((1024, 16, 512), (257, 31, 256)):
        x, k, bias = gate_inputs(torch, gen, b, 5, h, dh)
        run(x, k, bias, 0.8, True, True, f"(B={b}, L=5, H={h}, dh={dh})")
    # one head's slices above a stage (128 KB): the simple kernel
    x, k, bias = gate_inputs(torch, gen, 3, 16, 2, 2048)
    run(x, k, bias, 0.8, True, True, "(B=3, L=16, H=2, dh=2048)")
    # contiguous but one float past a 16-byte boundary: the simple kernel
    b, l, h, dh = 1024, 4, 8, 512
    store = torch.randn(b * l * h * dh + 1, generator=gen, device="cuda")
    x = store[1:].view(b, l, h, dh)
    _, k, bias = gate_inputs(torch, gen, 1)
    for with_ave, mul in GATE_OPTIONS:
        run(x, k, bias, 0.8, with_ave, mul, "(x one float off 16-byte alignment)")
    # logits scaled by 100: exp overflows unless the max is taken out first
    x, k, bias = gate_inputs(torch, gen, b, k_scale=100.0)
    for with_ave, mul in GATE_OPTIONS:
        run(x, k, bias, 0.8, with_ave, mul, "(logits x100)")
    # an all-zero row gives zeros, and no NaN; g = 0 drops the residual
    x, k, bias = gate_inputs(torch, gen, b)
    x[5] = 0
    for with_ave, mul in GATE_OPTIONS:
        got = run(x, k, bias, 0.8, with_ave, mul, "(an all-zero row)")
        check(bool((got[5] == 0).all()), "gate: an all-zero row did not give zeros")
    run(x, k, bias, 0.0, True, False, "(g = 0)")
    # g as a tensor on the card, given to the wrapper and held by a with_ave
    # gate module as its buffer: neither call may wait for the host
    from laff_tpu_torch.models.attention import MultiHeadGateAttention

    g = torch.tensor(0.8, device="cuda")
    module = MultiHeadGateAttention(h * dh, h, with_ave=True, mul=True)
    module.reset_parameters(torch.Generator().manual_seed(SEED))
    module = module.cuda()
    module.global_emb_weight.fill_(0.8)
    local = x.reshape(b, l, h * dh)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = K.fused_gate_attention(x, k, bias, g, with_ave=True, mul=True)
        with torch.no_grad():
            got_module = module(local)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ref = K.fused_gate_attention_plain(x, k, bias, g, with_ave=True, mul=True)
    ref_module = K.fused_gate_attention_plain(x, module.gate_kernel.detach(),
                                              module.gate_bias.detach(), g, mul=True)
    err = max(float((got - ref).abs().max()), float((got_module - ref_module).abs().max()))
    check(err <= GATE_TOL, f"gate with a tensor g: max err {err}")
    ring = K.LAUNCHES["gate_attention"] - counts["gate_attention"]
    simple = K.LAUNCHES["gate_attention_simple"] - counts["gate_attention_simple"]
    log(f"gate edge cases (L 1/2/5/16 x H 1/4/16 x dh 8/130/1024 over B 1/3/4099 and the "
        f"three option sets, L 6/7/8 at H 8 and dh 512 over B 3/1024, L 5 at H 16 and 31, "
        f"dh 2048 at L 16, x off 16-byte alignment, logits x100, an "
        f"all-zero row, g = 0, a tensor g to the wrapper and to a with_ave module under sync "
        f"debug mode 'error'): held against the "
        f"plain version to {GATE_TOL}; {ring} ring and {simple} simple kernel launches, each "
        f"on the kernel and layout its shape calls for (by layout: {layouts})")


# ---------------------------------------------------------------------------
# phase 3: the prediction slice
# ---------------------------------------------------------------------------

def gate_split(K):
    """The gate's launches by L and layout since the last reset_launches."""
    return {f"L{l} {layout}": n for (layout, l), n in sorted(K.GATE_LAUNCHES.items(),
                                                             key=lambda kv: kv[0][::-1])}


def run_predictor(torch, K, P, root, coll, ckpt, rank_path):
    opt = P.PredictOptions(
        testCollection=coll, model_path=ckpt, sim_name=f"smoke_{rank_path}", rootpath=root,
        query_sets=f"{coll}.caption.txt", overwrite=1, device="cuda", rank_path=rank_path,
        predict_result_file=os.path.join(root, "result_log", "smoke.txt"))
    K.reset_launches()
    t0 = time.perf_counter()
    res = P.main(opt)[f"{coll}.caption.txt"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    res["gate_split"] = gate_split(K)
    secs = ", ".join(f"{k} {v:.2f}" for k, v in res["seconds"].items())
    log(f"predictor {coll} rank_path={rank_path}: {wall:.1f} s wall ({secs}); "
        f"launches {launches}; the gate's by L and layout {res['gate_split']}")
    log(f"  t2v r1 {res['t2v'][0]:.3f} r5 {res['t2v'][1]:.3f} r10 {res['t2v'][2]:.3f} "
        f"medr {res['t2v'][3]:.0f} meanr {res['t2v'][4]:.2f} mir {res['t2v'][5]:.5f}; "
        f"v2t r1 {res['v2t'][0]:.3f} r5 {res['v2t'][1]:.3f} r10 {res['v2t'][2]:.3f} "
        f"medr {res['v2t'][3]:.0f} mir {res['v2t'][5]:.5f}")
    for m in (res["t2v"], res["v2t"]):
        check(all(float(x) == float(x) for x in m), "a metric is NaN")
    return res, launches


def reembed_and_check(torch, K, P, root, coll, ckpt, res_kernel, flat=False, resident=None):
    """Embed the same inputs again (same model, feeds and batches, so the
    same embeddings) and hold the run's ranks against them: kernel ranks
    against the rank kernel's plain version on the same bf16 operands (near
    ties within SCORE_TIE_TOL: f32 accumulation order), and, with ``flat``,
    the flat rank path's ranks of these embeddings (evaluator.t2v_ranks,
    no rank kernel) against their f32 scores (near ties within 1e-5).
    ``resident(txt, vis, txt_ids, vis_ids)`` is called on the embeddings."""
    from laff_tpu_torch.engine.checkpoint import load_checkpoint
    from laff_tpu_torch.engine.evaluator import Embedder, t2v_ranks
    from laff_tpu_torch.ops import flatten_heads

    ck = load_checkpoint(ckpt)
    model = P.rebuild_model(ck, torch.device("cuda"))
    feats = P.rebuild_featurizers(ck, root)
    P.strongclip_swap(ck, feats, root, coll, torch.device("cuda"))  # as predictor.main does
    opt = P.PredictOptions(coll, ckpt, "x", rootpath=root)
    vis_feed, txt_feed, _, _ = P.build_test_feeds(opt, ck["config"], f"{coll}.caption.txt",
                                                  feats)
    emb = Embedder(model, torch.device("cuda"))
    txt, txt_ids = emb.embed_txt(txt_feed)
    vis, vis_ids = emb.embed_vis(vis_feed)
    heads = txt.shape[1] if txt.ndim == 3 else 1
    width = (heads, 512) if txt.ndim == 3 else (4096,)  # LAFF-ml heads, or one space
    check(txt.shape == (len(txt_ids), *width) and vis.shape == (len(vis_ids), *width),
          f"embedding shapes {tuple(txt.shape)} {tuple(vis.shape)}")
    check(bool(torch.isfinite(txt).all() and torch.isfinite(vis).all()), "non-finite embeddings")
    if txt.ndim == 3:
        norms = torch.cat([txt.norm(dim=-1).flatten(), vis.norm(dim=-1).flatten()])
        check(float((norms - 1).abs().max()) < 1e-4, "gate outputs are not unit per head")

    if resident is not None:
        resident(txt, vis, txt_ids, vis_ids)
    vid_index = {v: i for i, v in enumerate(vis_ids)}
    gt = torch.as_tensor([vid_index[t.split("#")[0]] for t in txt_ids], device="cuda")
    tn, vn = flatten_heads(txt), flatten_heads(vis)
    rk = torch.as_tensor(res_kernel["t2v_ranks"], device="cuda").long()
    t = len(txt_ids)

    # the predictor's kernel call is fused_sim_rank(tn, vn, gt, prenormalized)
    plain = K.fused_sim_rank_plain(tn, vn, gt, prenormalized=True).long()
    ok, max_err = rank_moves_explained(torch, rk, plain, tn.to(torch.bfloat16),
                                       vn.to(torch.bfloat16), gt, SCORE_TIE_TOL)
    check(ok, "main-path kernel ranks differ from the plain version beyond near ties")
    equal = int((rk == plain).sum())
    if not flat:
        log(f"  slice check: {t} captions; main-path kernel ranks equal the plain version "
            f"on the same bf16 operands for {equal} rows (others within {SCORE_TIE_TOL} "
            f"near ties, at most {max_err} places)")
        return txt[:64].float(), vis[:64].float(), txt_feed, vis_feed, model

    K.reset_launches()
    t0 = time.perf_counter()
    rf = torch.as_tensor(t2v_ranks(txt, vis, txt_ids, vis_ids, rank_path="flat"),
                         device="cuda").long()
    flat_s = time.perf_counter() - t0
    check(K.LAUNCHES["sim_rank_wide"] == K.LAUNCHES["sim_rank_tiled"] == 0,
          f"the flat rank path launched {dict(K.LAUNCHES)}")
    td, vd = tn.double(), vn.double()
    for rows in torch.arange(t, device="cuda").split(4096):
        s = td[rows] @ vd.T / heads
        g = s.gather(1, gt[rows][:, None])
        exact = 1 + ((s > g) | ((s == g) & (torch.arange(s.shape[1], device="cuda")
                                            > gt[rows][:, None]))).sum(dim=1)
        near_f32 = ((s - g).abs() <= 1e-5).sum(dim=1) - 1
        check(bool(((rf[rows] - exact).abs() <= near_f32).all()),
              "flat ranks disagree with the re-embedded f32 scores")
    moved = int((rk != rf).sum())
    log(f"  slice check: {t} captions; main-path kernel ranks equal the plain version "
        f"on the same bf16 operands for {equal} rows (others within {SCORE_TIE_TOL} "
        f"near ties, at most {max_err} places); flat ranks match the re-embedded f32 "
        f"scores ({flat_s:.2f} s, no rank kernel); kernel (bf16) vs flat (f32) ranks differ "
        f"on {moved} rows ({moved / t:.4%}, at most {int((rk - rf).abs().max())} places)")
    return txt[:64].float(), vis[:64].float(), txt_feed, vis_feed, model


def cpu_reference_check(torch, P, ckpt, txt_feed, vis_feed, gpu_txt, gpu_vis):
    """The same model on the CPU (plain versions everywhere) on the first
    batch's first 64 captions and videos agrees with the card's output."""
    from laff_tpu_torch.engine.checkpoint import load_checkpoint
    from laff_tpu_torch.engine.evaluator import to_device

    model = P.rebuild_model(load_checkpoint(ckpt), torch.device("cpu"))
    tb = next(iter(txt_feed))["data"]
    vb = next(iter(vis_feed))["data"]
    with torch.no_grad():
        ct = model.encode_txt(to_device({k: v[:64] for k, v in tb.items()}, "cpu"))
        cv = model.encode_vis(to_device({k: v[:64] for k, v in vb.items()}, "cpu"))
    err = max(float((ct - gpu_txt.cpu()).abs().max()), float((cv - gpu_vis.cpu()).abs().max()))
    check(err <= TOWER_TOL, f"card vs CPU towers: max abs err {err}")
    log(f"  towers on the card vs the CPU (64 captions, 64 videos): max abs err {err:.3g}")


def tower_profile(torch, model, txt_feed, vis_feed):
    """Device time of one tower forward on the first eval batch of each
    feed, by kernel: the whole forward, the torch.stack that builds the
    gate's (B, L, D) input in FusionTower.forward (cat kernels), the gate."""
    from torch.profiler import ProfilerActivity, profile

    from laff_tpu_torch.engine.evaluator import to_device

    for side, feed, fn in (("text", txt_feed, model.encode_txt),
                           ("video", vis_feed, model.encode_vis)):
        batch = to_device(next(iter(feed))["data"], torch.device("cuda"))
        with torch.no_grad():
            fn(batch)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn(batch)
                torch.cuda.synchronize()
        by_name = {}
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
            if us:
                by_name[e.key] = us / 1e3
        rows = next(iter(batch.values())).shape[0]
        if not by_name:
            log(f"  {side} tower forward (B={rows}): the profiler recorded no device time "
                f"(not measured)")
            continue
        stack = sum(v for k, v in by_name.items() if "CatArray" in k)
        gate = sum(v for k, v in by_name.items() if "gate" in k)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        log(f"  {side} tower forward (B={rows}): device "
            f"{sum(by_name.values()):.4f} ms, of which torch.stack (cat kernels) {stack:.4f} ms "
            f"and the gate {gate:.4f} ms; top: "
            + "; ".join(f"{k[:50]} {v:.4f}" for k, v in top))


# ---------------------------------------------------------------------------
# phase 4: the training slice
# ---------------------------------------------------------------------------

# card (bf16 linears on cuBLAS, cuDNN GRU) vs CPU (plain versions): a step's
# loss from the same weights and batch, dropout off; bf16 rounding of the
# transforms moves a sum of 8 x 128 hinge terms by far less than this
STEP_LOSS_RTOL = 1e-2
# pairs of the first batch in the zoo's steps (seeded, untrained weights):
# the CPU's side of its 85-219 M-parameter models at B 128 took 6-16 s a
# kind (PR 14 cut the depth; a trained model's loss on 32 pairs can be 0)
ZOO_STEP_ROWS = 32
# graphed cached steps vs eager fed steps from the same state and generator:
# the same kernels on the same operands, so equal is expected; these bound it
GRAPH_LOSS_RTOL = 1e-5
GRAPH_PARAM_ATOL = 1e-5
# the indexed text feed (sparse bow scattered, w2v mean-pooled on the card)
# vs the dense host features over 60 steps: f32 sums of the same terms
INDEXED_LOSS_RTOL = 1e-5
INDEXED_STEPS = 60  # steps of the indexed text feed held against the dense one
# the bigru on the card (cuDNN, TF32 off) vs the CPU: f32 recurrences and
# gradient sums in another order, relative to the largest value
BIGRU_RTOL = 1e-4
GRAPH_STEPS = 16  # graphed vs eager: two dispatches of K 8
TRAIN_WINDOW = 60  # fed steps between two loss reads in the checked window
CACHE_CHECK_BATCHES = 3
VAL_GATE_CALLS = 62  # gate calls of one rtest validation: 59 text + 3 video batches
# phases 4-6 and 10 validate and predict on rval, rtest's 2,990 videos with 5
# captions a video (a cut of depth: their passes' host work, the rank dump
# and v2t, grows with the captions); phase 3's pass keeps MV-test3k's 59,800
RVAL = ("rval", 2990, 5, SEED + 17)
RVAL_GATE_CALLS = 15 + 3  # one rval validation or pass: 15 text + 3 video batches


class Counting:
    """A batcher that counts its calls (to see a staged feed replay)."""

    def __init__(self, batcher):
        self.batcher, self.calls = batcher, 0

    def __call__(self, ids):
        self.calls += 1
        return self.batcher(ids)


def dropout_off(model):
    """Every dropout of the model off: the TransformNets' and the zoo's, and
    a BERT tower's (its probabilities are in its config)."""
    import dataclasses

    for m in model.modules():
        if isinstance(getattr(m, "dropout", None), float):
            m.dropout = 0.0
        if hasattr(getattr(m, "config", None), "hidden_dropout_prob"):
            m.config = dataclasses.replace(m.config, hidden_dropout_prob=0.0,
                                           attention_probs_dropout_prob=0.0)


def first_batches(feed, n, featurize=True):
    """The first ``n`` batches of epoch 0 of a feed over ``feed``'s batchers
    and captions, featurized or (as the caches take them) ids only."""
    from laff_tpu_torch.data import PairFeed

    copy = PairFeed(feed.text_batcher, feed.vis_batcher, feed.batch_size, feed.seed,
                    cap_ids=feed.cap_ids, task3_source=feed.task3_source)
    copy.featurize_txt = copy.featurize_vis = featurize
    return list(itertools.islice(copy.epoch(0), n))


def device_batches(T, feed, device, n, cast=False):
    """The first ``n`` batches of epoch 0, featurized and on ``device``."""
    out = []
    for batch in first_batches(feed, n):
        hb = T.host_batch(batch, device.type == "cuda", cast, cast)
        out.append(({k: v.to(device) for k, v in hb["txt"].items()},
                    {k: v.to(device) for k, v in hb["vis"].items()}))
    return out


def new_step(T, config, spec, state_dict, device):
    from laff_tpu_torch.engine.optim import make_optimizer
    from laff_tpu_torch.models import LAFFModel

    model = LAFFModel(spec)
    model.load_state_dict(state_dict)
    model.to(device)
    return T.TrainStep(model, make_optimizer(config, model, bf16=True), spec)


def flat_params(model):
    import torch

    return torch.cat([p.detach().flatten() for p in model.parameters()])


def profiled(torch, fn):
    """``fn`` once under torch.profiler (CPU and CUDA activity): device ms
    by kernel, host ms by operator (self time), the kernel launches, and the
    wall ms (synchronized; the profiler's host cost in it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device, host, launches = {}, {}, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
            if us:
                device[e.key] = us / 1e3
                launches += e.count
        elif e.self_cpu_time_total:
            host[e.key] = (e.self_cpu_time_total / 1e3, e.count)
    return device, host, launches, wall


def profiled_spans(torch, fn):
    """``fn`` once, then once under torch.profiler: the (start, end) us of
    each device activity other than an NCCL kernel, those of the NCCL
    kernels apart, and the wall ms (synchronized)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans, nccl = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            (nccl if "nccl" in e.name.lower() else spans).append(
                (e.time_range.start, e.time_range.end))
    return spans, nccl, wall


def union_ms(spans):
    """The ms that the union of (start, end) us intervals covers."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def log_profile(what, device_ms, host_ms, n_kernels, prof_wall, step_ms, steps=1):
    """One profiled run's device and host figures, per step of ``steps``."""
    if not device_ms:
        log(f"  {what} profiled: the profiler recorded no device time (not measured)")
        return None
    busy = sum(device_ms.values()) / steps
    host = sum(v for v, _ in host_ms.values()) / steps
    top = sorted(device_ms.items(), key=lambda kv: -kv[1])[:10]
    log(f"  {what} profiled: {busy:.3f} ms of device time a step in {n_kernels / steps:.0f} "
        f"kernels; device idle {max(0.0, 1 - busy / step_ms):.1%} of the median step wall "
        f"({prof_wall / steps:.3f} ms a step under the profiler); host self time "
        f"{host:.3f} ms a step; device top 10 (ms over {steps} steps): "
        + "; ".join(f"{k[:60]} {v:.3f}" for k, v in top))
    top = sorted(host_ms.items(), key=lambda kv: -kv[1][0])[:10]
    log(f"  {what} host top 10 (ms over {steps} steps): "
        + "; ".join(f"{k[:40]} {v:.3f} ({n})" for k, (v, n) in top))
    return busy


def cache_and_graph_checks(torch, K, T, opt, prepared, smi, what, timings=True):
    """(a) the caches' gathered batches against the fed path's, bit for bit
    (FrameLAFF's padded frames and masks included); (b) 16 graphed cached
    steps (K 8) against 16 eager fed steps from the same weights, optimizer
    state and epoch generator, dropout on; then, with ``timings``, the
    graphed step's and the eager step's timings and profiles. ``what``
    names the path in the log."""
    from laff_tpu_torch.engine.prepare import seeded_model

    device = torch.device("cuda")
    feed = prepared.train_feed
    init = seeded_model(prepared.spec, SEED, prepared.we).state_dict()
    base = new_step(T, prepared.config, prepared.spec, init, device)
    d = T.setup_dispatch(opt, prepared, base, device, True, True)
    vis_cache, txt_cache, multi = d["vis_cache"], d["txt_cache"], d["multi_step"]
    check(vis_cache is not None and txt_cache is not None and multi is not None
          and d["steps_per_dispatch"] == 8, f"the default dispatch chose {d}")
    frames = {k: tuple(v.shape) for k, v in vis_cache.arrays.items() if "@" in k}
    frame_bytes = sum(vis_cache.arrays[k].numel() * vis_cache.arrays[k].element_size()
                      for k in frames)
    log(f"[{what}] caches: visual {vis_cache.nbytes} bytes in {vis_cache.build_seconds:.2f} s "
        f"(frame arrays {frame_bytes} bytes: {frames}), text {txt_cache.nbytes} bytes in "
        f"{txt_cache.build_seconds:.2f} s ({sorted(txt_cache.arrays)}); "
        f"{d['steps_per_dispatch']} steps per dispatch [{smi}]")

    batches = first_batches(feed, GRAPH_STEPS)
    for b in batches[:CACHE_CHECK_BATCHES]:
        fed = T.host_batch(b, True, True, True)
        for side, cache, ids in (("vis", vis_cache, b["vis_ids"]),
                                 ("txt", txt_cache, b["cap_ids"])):
            got = cache.gather(cache.indices(ids).to(device))
            for k, v in fed[side].items():
                want = v.to(device)
                check(got[k].dtype == want.dtype and torch.equal(got[k], want),
                      f"cached {side} '{k}' differs from the fed batch")
    log(f"  [{what}] (a) the first {CACHE_CHECK_BATCHES} batches of epoch 0: cached rows equal "
        f"the fed batches bit for bit, bf16 cast included ({sorted(fed['vis'])})")

    # (b) eager fed steps, then graphed cached steps, from the same state
    eager = new_step(T, prepared.config, prepared.spec, init, device)
    gen = T.epoch_generator(device, SEED, 0)
    fed = [T.host_batch(b, True, True, True) for b in batches]
    dev_batches = [tuple({k: v.to(device) for k, v in hb[side].items()}
                         for side in ("txt", "vis")) for hb in fed]
    e_losses = torch.stack([eager(txt, vis, gen) for txt, vis in dev_batches]).cpu()
    idx = [(txt_cache.indices(b["cap_ids"]), vis_cache.indices(b["vis_ids"])) for b in batches]
    # captured on a generator seeded for another epoch, then reseeded, as
    # the trainer reseeds its generator each epoch after the first capture
    gen = T.epoch_generator(device, SEED, 1)
    multi.capture(idx[0], gen)
    T.epoch_generator(device, SEED, 0, gen)
    K.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g_losses = torch.cat([multi(idx[:8], gen), multi(idx[8:], gen)])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    g_losses = g_losses.cpu()
    check(sum(K.LAUNCHES.values()) == 0, f"graphed steps launched kernels: {dict(K.LAUNCHES)}")
    rel = float(((g_losses - e_losses).abs() / e_losses.abs()).max())
    dp = float((flat_params(base.model) - flat_params(eager.model)).abs().max())
    check(rel <= GRAPH_LOSS_RTOL and dp <= GRAPH_PARAM_ATOL,
          f"graphed vs eager: loss rel diff {rel}, parameter diff {dp}")
    log(f"  [{what}] (b) {GRAPH_STEPS} graphed cached steps (K 8) vs {GRAPH_STEPS} eager fed "
        f"steps, dropout "
        f"on, one epoch seed (the graph captured before a reseed): max loss rel diff {rel:.3g} "
        f"(<= {GRAPH_LOSS_RTOL}), max parameter diff {dp:.3g} (<= {GRAPH_PARAM_ATOL}); capture "
        f"{multi.capture_seconds:.2f} s "
        f"with {T.GRAPH_WARMUP} warm-up steps; no host sync, no kernel of the port; losses "
        f"{[round(float(v), 4) for v in g_losses[:4]]}...")
    if not timings:
        return init

    # (d) timings: the graphed step against the eager step
    group = idx[:8]
    walls, hosts = [], []
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        multi(group, gen)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / 8)
        hosts.append((t1 - t0) * 1e3 / 8)
    g_ms, g_host = statistics.median(walls[2:]), statistics.median(hosts[2:])
    ev_ms = time_ms(torch, lambda: multi(group, gen), reps=10) / 8
    log(f"[{what}] graphed step (B 128, K 8, index batches): median {g_ms:.3f} ms wall a step "
        f"over 10 "
        f"dispatches, host enqueue {g_host:.3f} ms a step, CUDA events {ev_ms:.3f} ms a step "
        f"[{smi}]")
    prof = profiled(torch, lambda: multi(group, gen))
    g_dev = log_profile(f"[{what}] graphed dispatch of 8 steps", *prof, g_ms, steps=8)

    times = []
    for txt, vis in dev_batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager(txt, vis, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    e_ms = statistics.median(times[1:])
    txt, vis = dev_batches[0]

    def forward_backward():
        eager.optimizer.zero_grad()
        eager.loss_fn(*eager.model(txt, vis, gen)).backward()

    fb_ms = time_ms(torch, forward_backward, reps=20)
    opt_ms = time_ms(torch, eager.optimizer.step, reps=20)
    log(f"[{what}] eager step (B 128, batch on the card): median {e_ms:.3f} ms wall over "
        f"{len(times) - 1} steps; its parts alone (CUDA events, median of 20): forward + loss "
        f"+ backward {fb_ms:.3f} ms, optimizer update over {eager.optimizer.grad.numel()} "
        f"parameters {opt_ms:.3f} ms [{smi}]")
    e_dev = log_profile(f"[{what}] eager step", *profiled(torch, lambda: eager(txt, vis, gen)),
                        e_ms)
    log("step_timing " + json.dumps({"path": what,
        "graphed_ms": g_ms, "graphed_host_ms": g_host, "graphed_event_ms": ev_ms,
        "graphed_device_ms": g_dev, "eager_ms": e_ms, "eager_device_ms": e_dev,
        "capture_s": multi.capture_seconds, "vis_cache_bytes": vis_cache.nbytes,
        "vis_cache_s": vis_cache.build_seconds, "txt_cache_bytes": txt_cache.nbytes,
        "txt_cache_s": txt_cache.build_seconds, "card": smi}))
    return init


def featurizer_timing(torch, opt, prepared, model, txt_batcher, vis_batcher, want, smi):
    """The host featurizer of the LAFF path: in the order python, native,
    on fresh feeds, one unstaged embed_txt pass (the
    predictor's) and one validate that stages (the first validation), the
    text featurizers on their Python path or in the native fastfeat; the
    native calls are counted, and the metrics must equal ``want``. Then one
    staging validate with the bf16 rounding on the host instead of the card,
    whose metrics must equal too."""
    from laff_tpu_torch import native
    from laff_tpu_torch.data import EvalFeed
    from laff_tpu_torch.engine.evaluator import Embedder, validate

    device = torch.device("cuda")
    eval_batch = prepared.config.eval_batch_size
    depth = max(2, int(opt.workers) + 1)

    def feeds(stage):
        txt = EvalFeed(prepared.val_txt_source.cap_ids, txt_batcher, eval_batch)
        vis = EvalFeed(prepared.val_vis_ids, vis_batcher, eval_batch)
        txt.stage_on_device = vis.stage_on_device = stage
        return txt, vis

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    load = native.get_fastfeat

    def use_native(flag):
        native.get_fastfeat = load if flag else (lambda: None)

    times = {path: {"embed_txt": [], "validate": [], "native_calls": []}
             for path in ("python", "native")}
    model.eval()  # as the predictor embeds: no BatchNorm updates, no dropout
    try:
        for path in ("python", "native"):
            use_native(path == "native")
            native.reset_calls()
            emb = Embedder(model, device, prefetch_depth=depth)
            sec, _ = timed(lambda: emb.embed_txt(feeds(False)[0]))
            times[path]["embed_txt"].append(sec)
            sec, res = timed(lambda: validate(emb, *feeds(True), rank_path="kernel"))
            times[path]["validate"].append(sec)
            diff = {k: (res[k], v) for k, v in want.items() if res[k] != v}
            check(not diff, f"validation with the {path} featurizer: {diff}")
            calls = dict(native.CALLS)
            times[path]["native_calls"].append(calls)
            check((min(calls.values()) > 0) == (path == "native"),
                  f"the {path} passes made native calls {calls}")
        use_native(True)
        emb = Embedder(model, device, prefetch_depth=depth, host_cast=True)
        res = validate(emb, *feeds(True), rank_path="kernel")
        diff = {k: (res[k], v) for k, v in want.items() if res[k] != v}
        check(not diff, f"validation with the bf16 cast on the host: {diff}")
    finally:
        use_native(True)
        model.train()
    log("  the text featurizer, Python path vs native fastfeat (s; order python, native; "
        "metrics equal, and equal with the bf16 cast on the host): featurizer_timing "
        + json.dumps({**times, "smi": smi}))


def epoch_remainder(hist):
    """Per epoch, the wall the epoch loop spends outside train and validate
    (checkpoints, logs, the LR controller), s."""
    return [round(e["wall_seconds"] - e["train_seconds"] - e["val_seconds"], 2) for e in hist]


def card_vs_cpu_step(torch, T, prepared, state_dict, what, rows=None):
    """Two steps on the card and on the CPU from the same weights and the
    first batch (its first ``rows`` pairs), dropout off: losses within
    STEP_LOSS_RTOL."""
    device = torch.device("cuda")
    losses = {}
    for dev in (device, torch.device("cpu")):
        s = new_step(T, prepared.config, prepared.spec, state_dict, dev)
        dropout_off(s.model)
        txt, vis = ({k: v[:rows] for k, v in side.items()}
                    for side in device_batches(T, prepared.train_feed, dev, 1)[0])
        g = torch.Generator(device=dev).manual_seed(SEED)
        losses[dev.type] = [float(s(txt, vis, g)) for _ in range(2)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    check(rel <= STEP_LOSS_RTOL, f"[{what}] card vs CPU step losses {losses}")
    log(f"  [{what}] card vs CPU, two steps from the same weights and batch "
        f"({next(iter(vis.values())).shape[0]} pairs), dropout off: losses "
        f"{losses['cuda']} vs {losses['cpu']} (max rel diff {rel:.3g} <= {STEP_LOSS_RTOL})")


def fed_window_check(torch, K, T, opt, prepared, state_dict, smi):
    """The fed epoch loop with the caches off (the trainCollection2 epoch's
    path, and any train set above LAFF_TPU_CACHE_BUDGET): single steps
    through train_one_epoch, batches featurized and pinned by the prefetch
    thread and copied without blocking, from the trained weights. A warm
    window, then launch counts zeroed and 60 steps between two loss reads
    under sync debug mode 'error': no kernel of the port may launch."""
    import dataclasses

    from laff_tpu_torch.data import PairFeed

    device = torch.device("cuda")
    feed = prepared.train_feed
    step = new_step(T, prepared.config, prepared.spec, state_dict, device)
    fed = dataclasses.replace(opt, device_feature_cache=0, device_text_cache=0)
    d = T.setup_dispatch(fed, prepared, step, device, True, True)
    check(d["vis_cache"] is None and d["txt_cache"] is None and d["multi_step"] is None,
          f"the dispatch with the caches off chose {d}")
    window = PairFeed(feed.text_batcher, feed.vis_batcher, feed.batch_size, feed.seed,
                      cap_ids=feed.cap_ids[:TRAIN_WINDOW * feed.batch_size])
    gen = T.epoch_generator(device, SEED, 2)
    kw = dict(log_every=TRAIN_WINDOW, prefetch_depth=d["prefetch_depth"], cast_txt=True,
              cast_vis=True)
    T.train_one_epoch(d["step"], window, 2, device, gen, **kw)  # warm
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    loss, n = T.train_one_epoch(d["step"], window, 3, device, gen, sync_debug=True, **kw)
    window_s = time.perf_counter() - t0
    check(n == TRAIN_WINDOW and loss == loss, f"fed window: {n} steps, loss {loss}")
    check(sum(K.LAUNCHES.values()) == 0, f"fed train steps launched kernels: {dict(K.LAUNCHES)}")
    log(f"  fed window (caches off, single steps): {n} steps between two loss reads under sync "
        f"debug mode 'error', no kernel of the port launched; {window_s:.2f} s, "
        f"{n / window_s:.2f} steps/s (host featurization overlapped) [{smi}]")


def indexed_text_check(torch, T, opt, prepared, init, smi):
    """(e) 60 steps with device_text_featurize=1 (sparse bow scattered and w2v
    mean-pooled on the card, cached and graphed as the defaults take them)
    against 60 eager steps of the dense host features, the same weights and
    generator."""
    import dataclasses

    from laff_tpu_torch.engine.prepare import prepare

    device = torch.device("cuda")
    opt_i = dataclasses.replace(opt, device_text_featurize=1, model_prefix="smoke_indexed")
    t0 = time.perf_counter()
    prep_i = prepare(opt_i)
    step_i = new_step(T, prep_i.config, prep_i.spec, init, device)
    d = T.setup_dispatch(opt_i, prep_i, step_i, device, True, True)
    txt_cache, vis_cache = d["txt_cache"], d["vis_cache"]
    check(d["multi_step"] is not None and "w2v_ids" in txt_cache.arrays
          and "bow_ids" in txt_cache.arrays, f"indexed dispatch chose {d}")
    log(f"  indexed text: prepare + caches {time.perf_counter() - t0:.1f} s; text cache "
        f"{txt_cache.nbytes} bytes ({sorted(txt_cache.arrays)}), w2v table "
        f"{tuple(prep_i.w2v_table.shape)}")
    idx = [(txt_cache.indices(b["cap_ids"]), vis_cache.indices(b["vis_ids"]))
           for b in first_batches(prep_i.train_feed, INDEXED_STEPS, featurize=False)]
    gen = T.epoch_generator(device, SEED, 0)
    got = torch.cat([d["multi_step"](idx[s:s + 8], gen) for s in range(0, len(idx), 8)]).cpu()

    dense = new_step(T, prepared.config, prepared.spec, init, device)
    gen = T.epoch_generator(device, SEED, 0)
    ref = torch.stack([dense(txt, vis, gen) for txt, vis in
                       device_batches(T, prepared.train_feed, device, INDEXED_STEPS, True)]).cpu()
    rel = float(((got - ref).abs() / ref.abs()).max())
    check(len(got) == len(ref) == INDEXED_STEPS and rel <= INDEXED_LOSS_RTOL,
          f"indexed vs dense text: {len(got)} / {len(ref)} steps, max loss rel diff {rel}")
    log(f"  (e) {INDEXED_STEPS} steps with device_text_featurize=1 (cached, graphed) vs the dense "
        f"fed path: max loss rel diff {rel:.3g} (<= {INDEXED_LOSS_RTOL}); last losses "
        f"{float(got[-1]):.5f} / {float(ref[-1]):.5f} [{smi}]")


def bigru_check(torch, smi):
    """The bidirectional GRU (reverse direction by per-row gathers on the
    card) at the rehearsal's GRU width: forward + backward under sync debug
    'error', against the CPU, then captured as a CUDA graph and replayed on
    new captions against eager. Then its time per call (CUDA events, median
    of 20; forward + backward, and forward alone under no_grad) with each
    direction's weights in a cuDNN buffer of their own (the port's layout:
    cuDNN warns of no weight copy) against ``nn.GRU``'s one buffer for the
    module (cuDNN copies the reverse direction's weights at every call)."""
    import warnings
    from laff_tpu_torch.models import GruEncoder
    from laff_tpu_torch.models.spec import GruSpec

    b, t = 128, 32
    gen = torch.Generator().manual_seed(SEED)
    spec = GruSpec(vocab_size=11291, we_dim=500, rnn_size=1024, bidirectional=True)
    cpu = GruEncoder(spec).train()
    cpu.reset_parameters(gen)
    card = GruEncoder(spec).train()
    card.load_state_dict(cpu.state_dict())
    card.cuda()

    def inputs():
        ids = torch.randint(1, spec.vocab_size, (b, t), generator=gen)
        lengths = torch.randint(1, t + 1, (b,), generator=gen)
        ids[torch.arange(t)[None, :] >= lengths[:, None]] = 0
        return ids, lengths

    def run(module, ids, lengths):
        module.zero_grad(set_to_none=False)
        out = module(ids, lengths)
        out.square().sum().backward()
        return out.detach(), module.rnn.weight_hh_l0_reverse.grad.detach()

    ids, lengths = inputs()
    static = (ids.cuda(), lengths.cuda())
    run(card, *static)  # the gradients exist before the checked call
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [v.clone() for v in run(card, *static)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = run(cpu, ids, lengths)
    errs = [float((g.cpu() - w).abs().max() / w.abs().max()) for g, w in zip(got, want)]
    check(max(errs) <= BIGRU_RTOL, f"bigru card vs CPU: output / gradient diff {errs}")

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            run(card, *static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = run(card, *static)
    ids2, lengths2 = inputs()
    static[0].copy_(ids2)
    static[1].copy_(lengths2)
    graph.replay()
    replayed = [v.clone() for v in static_out]
    eager = run(card, ids2.cuda(), lengths2.cuda())
    graph_errs = [float((g - e).abs().max() / e.abs().max()) for g, e in zip(replayed, eager)]
    check(max(graph_errs) <= GRAPH_LOSS_RTOL,
          f"the bigru replayed from a CUDA graph vs eager: output / gradient diff {graph_errs}")
    log(f"  bigru (B {b}, T {t}, we 500, rnn 1024 x 2): no host sync in forward + backward; card "
        f"vs CPU output / gradient diff {errs[0]:.3g} / {errs[1]:.3g} of the largest value "
        f"(<= {BIGRU_RTOL}); a CUDA graph of forward + backward on new captions vs eager: "
        f"{graph_errs[0]:.3g} / {graph_errs[1]:.3g} (<= {GRAPH_LOSS_RTOL})")

    def forward():
        with torch.no_grad():
            card(*static)

    times = {}
    for layout in ("per_direction", "one_buffer"):
        if layout == "one_buffer":  # nn.GRU's own layout, the port's before
            torch.nn.GRU.flatten_parameters(card.rnn)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run(card, *static)
            torch.cuda.synchronize()
        copies = [w for w in caught if "contiguous chunk of memory" in str(w.message)]
        check(bool(copies) == (layout == "one_buffer"),
              f"bigru {layout}: cuDNN weight-copy warnings {len(copies)}")
        times[layout] = {"fwd_bwd_ms": time_ms(torch, lambda: run(card, *static), 20),
                         "fwd_ms": time_ms(torch, forward, 20), "cudnn_copy_warnings": len(copies)}
    log("  bigru time per call (B 128, T 32), each direction's weights in a buffer of their "
        "own vs one buffer for the module: bigru_timing " + json.dumps({**times, "smi": smi}))


def default_dispatch(chose):
    """The default dispatch of a deterministic train feed: both caches, K 8
    as a CUDA graph, staged validation."""
    return (chose["vis_cache_bytes"] and chose["txt_cache_bytes"] and chose["graph"]
            and chose["steps_per_dispatch"] == 8 and chose["stage_val_features"])


def run_main(torch, K, T, opt, prepared, smi, what, gate_calls=VAL_GATE_CALLS,
             dispatch_ok=default_dispatch, epochs=2, val_batches=VAL_GATE_CALLS):
    """(c) ``trainer.main`` for ``epochs`` epochs at the default dispatch,
    every window of graphed steps between two loss reads under sync debug
    mode 'error'. Its choice must pass ``dispatch_ok`` (by default both
    caches, K 8 as a graph and staged validation); each validation launches
    the wide rank kernel once and the gate
    ``gate_calls`` times (the steps none), the second one replays the
    batches staged by the first and its metrics equal an unstaged validate of
    the same weights; the process's default CUDA generator is left alone.
    Returns (the result, the launches, the unstaged metrics)."""
    from laff_tpu_torch.data import EvalFeed
    from laff_tpu_torch.engine.evaluator import Embedder, validate

    txt_batcher, vis_batcher = prepared.val_txt_batcher, prepared.val_vis_batcher
    counting = (Counting(txt_batcher), Counting(vis_batcher))
    prepared.val_txt_batcher, prepared.val_vis_batcher = counting
    default_rng = torch.cuda.get_rng_state()
    K.reset_launches()
    t0 = time.perf_counter()
    try:
        res = T.main(opt, prepared=prepared)
    finally:
        prepared.val_txt_batcher, prepared.val_vis_batcher = txt_batcher, vis_batcher
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    res["gate_split"] = gate_split(K)
    check(torch.equal(torch.cuda.get_rng_state(), default_rng),
          f"[{what}] trainer.main moved the process's default CUDA generator")
    hist, chose = res["history"], res["dispatch"]
    log(f"[{what}] trainer.main chose: {chose}")
    for e in hist:
        log(f"  [{what}] epoch {e['epoch']}: loss {e['loss']:.4f}, lr {e['lr']:.6g}, "
            f"{e['steps']} steps, train {e['train_seconds']:.2f} s, validate "
            f"{e['val_seconds']:.2f} s, wall {e['wall_seconds']:.2f} s; r1 {e['r1']:.3f} "
            f"r5 {e['r5']:.3f} r10 {e['r10']:.3f} medr {e['medr']:.0f} mir {e['mir']:.5f} [{smi}]")
    log(f"[{what}] trainer.main: {len(hist)} epochs in {wall:.1f} s (prepare in the call "
        f"{res['prepare_seconds']} s); launches {launches}, the gate's by L and layout "
        f"{res['gate_split']} [{smi}]")
    check(dispatch_ok(chose), f"[{what}] the dispatch is not the expected one "
          f"({dispatch_ok.__doc__.strip()}): {chose}")
    check(len(hist) == epochs, f"[{what}] trainer ran {len(hist)} epochs, not {epochs}")
    check(epochs == 1 or hist[-1]["loss"] < hist[0]["loss"],
          f"[{what}] the training loss did not fall")
    check(hist[-1]["r1"] > 100.0 / len(prepared.val_vis_ids),
          f"[{what}] validation R@1 {hist[-1]['r1']} is not above chance")
    expect = {"sim_rank_wide": epochs, "sim_rank_tiled": 0, "gate_attention": epochs * gate_calls,
              "gate_attention_simple": 0}
    check(launches == expect, f"[{what}] training run launches {launches}, expected one rank "
          f"and {gate_calls} gate launches per validation and none in the steps: {expect}")
    calls = counting[0].calls + counting[1].calls
    check(calls == val_batches, f"[{what}] the validation batchers ran {calls} times in "
          f"{epochs} validations; the later ones should replay the {val_batches} staged "
          f"batches")
    device = torch.device("cuda")
    eval_batch = prepared.config.eval_batch_size
    unstaged = validate(Embedder(res["model"], device),
                        EvalFeed(prepared.val_txt_source.cap_ids, txt_batcher, eval_batch),
                        EvalFeed(prepared.val_vis_ids, vis_batcher, eval_batch),
                        rank_path="kernel")
    diff = {k: (hist[-1][k], unstaged[k]) for k in T.METRICS if hist[-1][k] != unstaged[k]}
    check(not diff, f"[{what}] the last validation vs unstaged, same weights: {diff}")
    log(f"  [{what}] the last validation ({'replayed' if epochs > 1 else 'staging'}) equals an "
        f"unstaged validate of the same weights exactly; validation wall: "
        f"{[e['val_seconds'] for e in hist]} s (staging, then replayed); epoch train wall "
        f"{[e['train_seconds'] for e in hist]} s (capture included in the first); the default "
        f"CUDA generator untouched; epoch wall minus train minus validation "
        f"{epoch_remainder(hist)} s (background saver) [{smi}]")
    return res, launches, {k: unstaged[k] for k in T.METRICS}


def trained_checkpoint_prediction(torch, K, P, root, res, rank_paths, what, gate_run=GATE_RUN,
                                  coll="rtest"):
    """(f) the trained best checkpoint through ``predictor.main`` on ``coll``, for
    each rank path; the kernel path's mir must be the trainer's validation
    mir of that epoch. Returns the checkpoint path, the results and the
    kernel run's launches."""
    from laff_tpu_torch.engine.checkpoint import load_checkpoint

    ckpt_path = os.path.join(res["model_path"], "model_best.pth.tar")
    ck = load_checkpoint(ckpt_path)
    out = {path: run_predictor(torch, K, P, root, coll, ckpt_path, path)
           for path in rank_paths}
    res_k, launches = out["kernel"]
    val_mir = res["history"][int(ck["epoch"]) - 1]["mir"]
    check(abs(res_k["t2v"][5] - val_mir) < 1e-6,
          f"[{what}] the predictor's kernel-path mir {res_k['t2v'][5]} is not the trainer's "
          f"validation mir {val_mir}")
    check(launches["sim_rank_wide"] == 1 and launches["gate_attention"] == gate_run
          and launches["gate_attention_simple"] == 0,
          f"[{what}] the kernel prediction pass launched {launches}")
    return ckpt_path, {p: r for p, (r, _) in out.items()}, launches


def train_phase(torch, K, P, root, smi):
    """The training slice at full width: the caches and the graph against the
    fed eager path, two epochs of trainer.main at the default dispatch, the
    host featurizer and the checkpoint writer timed, the replayed validation
    against an unstaged one, the indexed text feed, and the trained
    checkpoint through the predictor. Returns the launches of the training
    run and of the trained checkpoint's kernel prediction pass, and what
    phase 6 reuses: the options, the prepared run, the trained checkpoint
    and its kernel prediction pass."""
    from laff_tpu_torch.data.synth import build_world
    from laff_tpu_torch.engine import trainer as T
    from laff_tpu_torch.engine.checkpoint import load_checkpoint
    from laff_tpu_torch.engine.prepare import Options, prepare

    t0 = time.perf_counter()
    coll, n_videos, caps, seed = RVAL
    log(f"worlds: {build_world(root, 'rtrain', 1500, 20, 11286, SEED + 2, frame_feat=True)}, "
        f"{build_world(root, coll, n_videos, caps, 11286, seed, frame_feat=True)} in "
        f"{time.perf_counter() - t0:.1f} s")
    opt = Options(trainCollection="rtrain", valCollection=coll, rootpath=root, val_set="no",
                  config_name="rehearsal", num_epochs=2, batch_size=128, device="cuda",
                  rank_path="kernel", sync_debug=1, random_seed=SEED, model_prefix="smoke")
    t0 = time.perf_counter()
    prepared = prepare(opt)
    feed = prepared.train_feed
    log(f"trainer prepare: {time.perf_counter() - t0:.1f} s; {len(feed.cap_ids)} captions, "
        f"{feed.steps_per_epoch()} steps of {feed.batch_size} per epoch")
    init = cache_and_graph_checks(torch, K, T, opt, prepared, smi, "laff")
    res, launches, unstaged = run_main(torch, K, T, opt, prepared, smi, "laff",
                                       gate_calls=RVAL_GATE_CALLS, val_batches=RVAL_GATE_CALLS)
    featurizer_timing(torch, opt, prepared, res["model"], prepared.val_txt_batcher,
                      prepared.val_vis_batcher, unstaged, smi)
    del res["model"]

    ck = load_checkpoint(os.path.join(res["model_path"], "model_best.pth.tar"))
    fed_window_check(torch, K, T, opt, prepared, ck["state_dict"], smi)
    indexed_text_check(torch, T, opt, prepared, init, smi)
    bigru_check(torch, smi)
    card_vs_cpu_step(torch, T, prepared, ck["state_dict"], "laff")

    ckpt_path, out, launches_p = trained_checkpoint_prediction(
        torch, K, P, root, res, ("kernel",), "laff", gate_run=RVAL_GATE_CALLS, coll=coll)
    reembed_and_check(torch, K, P, root, coll, ckpt_path, out["kernel"])
    trained = {"opt": opt, "prepared": prepared, "ckpt_path": ckpt_path,
               "predict": out["kernel"], "predict_launches": launches_p}
    return launches, launches_p, trained


def frame_phase(torch, K, P, root, smi):
    """5. FrameLAFF (configs/frame_rehearsal.py: frame_rehearsal's shape of
    FrameLaff_NoFrameFc_StrongCLIP_adjust at parm 0_7_1_12_0_12_0) at full
    width on rtrain -> rtest, both with 512-d frame rows (8-60 a video, at
    most 50 kept): the caches with the padded frames and the graph against
    the fed eager path, two epochs of trainer.main at the default dispatch
    (the video tower's gate at L 5 in each validation), one step on the card
    against the CPU, and the trained checkpoint through the predictor.
    Returns the launches of the training run and of the prediction pass, and
    phase 10's input: {'ckpt': the trained checkpoint, 'seconds': its pass's
    phases}."""
    from laff_tpu_torch.engine import trainer as T
    from laff_tpu_torch.engine.checkpoint import load_checkpoint
    from laff_tpu_torch.engine.prepare import Options, prepare
    from laff_tpu_torch.models import LAFFModel

    opt = Options(trainCollection="rtrain", valCollection=RVAL[0], rootpath=root, val_set="no",
                  config_name="frame_rehearsal", num_epochs=2, batch_size=128, device="cuda",
                  rank_path="kernel", sync_debug=1, random_seed=SEED,
                  model_prefix="smoke_frames")
    t0 = time.perf_counter()
    prepared = prepare(opt)
    vis = prepared.spec.vis
    n_params = sum(p.numel() for p in LAFFModel(prepared.spec).parameters())
    log(f"[frames] trainer prepare: {time.perf_counter() - t0:.1f} s; video tower "
        f"{[n for n, _ in vis.features]} + frames {vis.frame_features} pooled by "
        f"{vis.frame_attention.kind}; {n_params} parameters")
    check(vis.frame_features == (("clip_frames", 512),) and len(vis.features) == 4
          and vis.frame_feat_with_video_feat and not vis.frame_add_fc
          and vis.frame_attention.kind == "attention_noAveNoAverageMul",
          f"[frames] the frame_rehearsal spec is not FrameLAFF's headline shape: {vis}")
    cache_and_graph_checks(torch, K, T, opt, prepared, smi, "frames")
    res, launches, _ = run_main(torch, K, T, opt, prepared, smi, "frames",
                                gate_calls=RVAL_GATE_CALLS, val_batches=RVAL_GATE_CALLS)
    split = {"frames_train": res["gate_split"]}
    del res["model"]
    ck = load_checkpoint(os.path.join(res["model_path"], "model_best.pth.tar"))
    card_vs_cpu_step(torch, T, prepared, ck["state_dict"], "frames")
    ckpt_path, out, launches_p = trained_checkpoint_prediction(
        torch, K, P, root, res, ("kernel",), "frames", gate_run=RVAL_GATE_CALLS, coll=RVAL[0])
    split["frames_trained_predict"] = out["kernel"]["gate_split"]
    l5 = f"L5 {K.gate_layout(5, 8, 512)}"
    for path, by_l in split.items():
        check(by_l.get(l5, 0) > 0 and not any(k.startswith("L5") and k != l5 for k in by_l),
              f"[frames] {path}: the video tower's L 5 gate did not all take {l5}: {by_l}")
    secs = out["kernel"]["seconds"]
    log("[frames] frame_timing " + json.dumps({
        "epochs": [{k: e[k] for k in ("train_seconds", "val_seconds", "wall_seconds", "loss",
                                      "r1")} for e in res["history"]],
        "remainder": epoch_remainder(res["history"]),
        "vis_cache_bytes": res["dispatch"]["vis_cache_bytes"],
        "vis_cache_s": res["dispatch"]["vis_cache_seconds"],
        "predict_seconds": secs, "predict_total_s": sum(secs.values()), "smi": smi}))
    return launches, launches_p, {"ckpt": ckpt_path, "seconds": secs, "gate_by_l": split}


# ---------------------------------------------------------------------------
# phase 6: the single-space models and checkpoint interchange
# ---------------------------------------------------------------------------

# the '__concat__' tie needs the text concatenation as wide as the video one:
# bow + w2v 500 + GRU 1024 = 512 + 768 + 2048 + 2048 -> a 3,852-word bow
CONCAT_VOCAB = 5376 - 500 - 1024
ZOO_KINDS = (2, 4, 5, 6, 10, 11, 16)  # the rest of the zoo (3 builds what 2 builds)
ZOO_QKV_DROPOUT = 0.1  # kind 5's own dropout in the graphed-vs-eager check
HIST_CPU_STRIDE = 29  # the CPU recounts every 29th caption's 'hist' rank (2,063 rows)


def concat_phase(torch, K, P, smi):
    """6(a). W2VVPP (configs/concat_rehearsal.py): 'concat' fusion on both
    towers tied by txt_fc_same_with_vis_fc (the '__concat__' tie), on
    ctrain -> ctest (rtrain's shape, and rtest's videos with 5 captions
    each, over a 3,852-word vocabulary): the caches and the graph against the fed eager path, two
    epochs of trainer.main at the default dispatch (each validation one
    wide rank launch and no gate), and the trained checkpoint through the
    predictor with rank_path 'kernel' and 'flat', the kernel ranks held
    against the plain version. Returns the launches of the training run and
    of the kernel prediction pass."""
    from laff_tpu_torch.data.synth import build_world
    from laff_tpu_torch.engine import trainer as T
    from laff_tpu_torch.engine.prepare import Options, prepare

    root = os.path.join(WORK, "world_concat")
    t0 = time.perf_counter()
    worlds = [build_world(root, coll, n, caps, CONCAT_VOCAB, SEED + seed)
              for coll, n, caps, seed in (("ctrain", 1500, 20, 3),
                                          ("ctest", 2990, CUT_CAPTIONS, 4))]
    log(f"[concat] worlds: {worlds} in {time.perf_counter() - t0:.1f} s")
    opt = Options(trainCollection="ctrain", valCollection="ctest", rootpath=root, val_set="no",
                  config_name="concat_rehearsal", num_epochs=2, batch_size=128, device="cuda",
                  rank_path="kernel", sync_debug=1, random_seed=SEED,
                  model_prefix="smoke_concat")
    t0 = time.perf_counter()
    prepared = prepare(opt)
    spec = prepared.spec
    widths = (sum(d for _, d in spec.txt.features), sum(d for _, d in spec.vis.features))
    log(f"[concat] trainer prepare: {time.perf_counter() - t0:.1f} s; text "
        f"{spec.txt.features}, video {spec.vis.features}, tied {spec.tied_transforms}")
    check(spec.txt.attention.kind == spec.vis.attention.kind == "concat"
          and spec.tied_transforms == (("__concat__", "__concat__"),)
          and widths == (5376, 5376) and spec.txt.common_dim == 4096,
          f"[concat] the spec is not W2VVPP tied at full width: {spec}")
    cache_and_graph_checks(torch, K, T, opt, prepared, smi, "concat", timings=False)
    res, launches, _ = run_main(torch, K, T, opt, prepared, smi, "concat", gate_calls=0,
                                val_batches=CUT_VAL_GATE_CALLS)
    del res["model"]
    ckpt_path, out, launches_p = trained_checkpoint_prediction(
        torch, K, P, root, res, ("kernel",), "concat", gate_run=0, coll="ctest")
    reembed_and_check(torch, K, P, root, "ctest", ckpt_path, out["kernel"])
    return launches, launches_p


def zoo_phase(torch, K, trained, smi):
    """6(b). The rest of the attention zoo at full width: for each kind k of
    ZOO_KINDS, the rehearsal at parm 0_<k>_0_<k>_1_0_0 (kind k on both
    towers, with_ave) with its seeded weights: one train step on the card
    against the CPU, dropout off; for kind 5 (its QKV dropout at
    ZOO_QKV_DROPOUT) also the caches and 16 graphed steps against 16 eager
    ones, dropout on."""
    import dataclasses

    from laff_tpu_torch.engine import trainer as T
    from laff_tpu_torch.engine.prepare import build_spec, load_config, seeded_model

    prepared, base = trained["prepared"], trained["prepared"].spec
    for k in ZOO_KINDS:
        t0 = time.perf_counter()
        parm = f"0_{k}_0_{k}_1_0_0"
        config = load_config("rehearsal", parm)
        if k == 5:
            config.multi_head_attention = dict(config.multi_head_attention,
                                               dropout=ZOO_QKV_DROPOUT)
        spec = build_spec(config, dict(base.vis.features), dict(base.txt.features),
                          base.txt.gru)
        check(spec.txt.attention.kind == spec.vis.attention.kind == config.txt_attentions[k],
              f"[zoo {k}] parm {parm} built {spec.txt.attention.kind}")
        run = dataclasses.replace(prepared, config=config, spec=spec)
        state = seeded_model(spec, SEED, prepared.we).state_dict()
        n_params = sum(v.numel() for n, v in state.items() if "running" not in n
                       and "num_batches" not in n and "global_emb" not in n)
        log(f"[zoo {k}] {spec.txt.attention.kind} on both towers (parm {parm}): {n_params} "
            f"parameters")
        card_vs_cpu_step(torch, T, run, state, f"zoo {k}", rows=ZOO_STEP_ROWS)
        if k == 5:
            cache_and_graph_checks(torch, K, T, dataclasses.replace(
                trained["opt"], parm_adjust_config=parm), run, smi, "zoo 5", timings=False)
        log(f"  [zoo {k}] {time.perf_counter() - t0:.1f} s")


def hist_phase(torch, K, trained, smi):
    """6(c). One validation of the trained LAFF model on rval with measure
    'hist' and rank_path 'kernel': the rank kernel must not launch (the
    blocked plain path takes 'hist'), the ranks equal those of the same
    embeddings on the card again, and every HIST_CPU_STRIDE-th caption's
    rank equals the CPU's. Returns the validation's launches."""
    import numpy as np

    from laff_tpu_torch.data import EvalFeed
    from laff_tpu_torch.engine.checkpoint import load_checkpoint
    from laff_tpu_torch.engine.evaluator import Embedder, t2v_ranks, validate
    from laff_tpu_torch.models import LAFFModel

    prepared = trained["prepared"]
    device = torch.device("cuda")
    model = LAFFModel(prepared.spec)
    model.load_state_dict(load_checkpoint(trained["ckpt_path"])["state_dict"])
    model.to(device).eval()
    batch = prepared.config.eval_batch_size
    txt_feed = EvalFeed(prepared.val_txt_source.cap_ids, prepared.val_txt_batcher, batch)
    vis_feed = EvalFeed(prepared.val_vis_ids, prepared.val_vis_batcher, batch)
    emb = Embedder(model, device)
    K.reset_launches()
    t0 = time.perf_counter()
    metrics = validate(emb, txt_feed, vis_feed, measure="hist", rank_path="kernel")
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    check(launches["sim_rank_wide"] == launches["sim_rank_tiled"] == 0
          and launches["gate_attention"] == RVAL_GATE_CALLS,
          f"[hist] the 'hist' validation launched {launches}: no rank kernel may run")
    with torch.no_grad():
        txt, txt_ids = emb.embed_txt(txt_feed)
        vis, vis_ids = emb.embed_vis(vis_feed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = t2v_ranks(txt, vis, txt_ids, vis_ids, measure="hist")
    rank_s = time.perf_counter() - t0
    check(np.array_equal(card, metrics["ranks"]),
          "[hist] validation ranks differ from the same embeddings' ranks on the card")
    rows = list(range(0, len(txt_ids), HIST_CPU_STRIDE))
    t0 = time.perf_counter()
    cpu = t2v_ranks(txt[rows].cpu(), vis.cpu(), [txt_ids[i] for i in rows], vis_ids,
                    measure="hist")
    cpu_s = time.perf_counter() - t0
    check(np.array_equal(cpu, card[rows]), f"[hist] CPU ranks differ on "
          f"{int((cpu != card[rows]).sum())} of {len(rows)} rows")
    log(f"[hist] validation on {RVAL[0]} with measure 'hist': {wall:.2f} s wall, launches "
        f"{launches} (no rank kernel); r1 {metrics['r1']:.3f} medr {metrics['medr']:.0f} mir "
        f"{metrics['mir']:.5f}; the ranks of {len(txt_ids)} captions x {len(vis_ids)} videos "
        f"on the card in {rank_s:.3f} s, equal to the validation's; {len(rows)} of them "
        f"recounted on the CPU in {cpu_s:.2f} s: equal [{smi}]")
    return launches


def interchange_phase(torch, K, P, root, trained, smi):
    """6(d). The trained LAFF-ml rehearsal checkpoint written in the
    reference layout by save_torch_checkpoint and read back: the imported
    spec and state dict equal the port file's, predictor.main on the
    .pth.tar (rank_path 'kernel') gives the rows and ranks of the port
    file's pass on rval in phase 4 with the same launches (one wide rank, 18 gate),
    and --pretrained_file_path from each file gives the same first-step
    loss; the save, the load and convert, and the port file's load timed.
    Returns the reference pass's launches."""
    import numpy as np

    from laff_tpu_torch.engine import trainer as T
    from laff_tpu_torch.engine.checkpoint import load_checkpoint
    from laff_tpu_torch.engine.optim import make_optimizer
    from laff_tpu_torch.engine.prepare import seeded_model
    from laff_tpu_torch.engine.torch_export import save_torch_checkpoint

    port_path = trained["ckpt_path"]
    ref_path = os.path.join(WORK, "laff_model_best_reference.pth.tar")
    times = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        times[name] = time.perf_counter() - t0
        return out

    port = timed("port_load_s", lambda: load_checkpoint(port_path))
    timed("export_s", lambda: save_torch_checkpoint(port, ref_path))
    ref = timed("reference_load_convert_s", lambda: load_checkpoint(ref_path))
    check(ref.get("imported_from") == "reference" and ref["spec"] == port["spec"],
          "[interchange] the .pth.tar did not import as a reference file of the same spec")
    check(set(ref["state_dict"]) == set(port["state_dict"]) and all(
        torch.equal(v, ref["state_dict"][k]) for k, v in port["state_dict"].items()),
        "[interchange] the imported state dict differs from the port checkpoint's")
    res, launches = run_predictor(torch, K, P, root, RVAL[0], ref_path, "kernel")
    want, want_launches = trained["predict"], trained["predict_launches"]
    check(tuple(res["t2v"]) == tuple(want["t2v"]) and tuple(res["v2t"]) == tuple(want["v2t"])
          and np.array_equal(res["t2v_ranks"], want["t2v_ranks"]),
          f"[interchange] rows from the .pth.tar {res['t2v']} {res['v2t']} differ from the "
          f"port file's {want['t2v']} {want['v2t']}")
    check(launches == want_launches, f"[interchange] launches {launches}, the port file's "
          f"pass launched {want_launches}")

    prepared = trained["prepared"]
    device = torch.device("cuda")
    txt, vis = device_batches(T, prepared.train_feed, device, 1, cast=True)[0]
    losses = []
    for path in (port_path, ref_path):
        model = seeded_model(prepared.spec, SEED + 5, prepared.we)
        T.warm_start(model, path)
        model.to(device)
        step = T.TrainStep(model, make_optimizer(prepared.config, model, bf16=True),
                           prepared.spec)
        losses.append(float(step(txt, vis, T.epoch_generator(device, SEED, 0))))
    check(losses[0] == losses[1], f"[interchange] first-step losses warm-started from the port "
          f"file and the .pth.tar differ: {losses}")
    size = os.path.getsize(ref_path)
    log(f"[interchange] {port_path} -> {ref_path} ({size} bytes): rows and ranks equal, "
        f"launches {launches}; first-step loss {losses[0]:.6f} from both files")
    log("interchange_timing " + json.dumps({**times, "reference_bytes": size,
                                            "predict_seconds": res["seconds"], "card": smi}))
    return launches


# ---------------------------------------------------------------------------
# phase 7: negation-aware retrieval, task2 and the prediction post-processing
# ---------------------------------------------------------------------------

TASK3_TIMED_STEPS = 20  # eager task3 steps timed on one batch on the card
# t3test and ctest: rtest's 2,990 videos with 5 captions each, a cut of
# depth (from 20) that keeps the script inside its limit on the
# slower hosts; one validation: 15 text + 3 video batches of 1,024
CUT_CAPTIONS = 5
CUT_VAL_GATE_CALLS = 15 + 3
# a negation-scored t3test pass: the queries, then their positive and
# negated clauses (15 text batches each), and the gallery (3)
NEGATION_GATE_CALLS = 3 * 15 + 3
# the VATEX test shape, 1,500 videos, at 5 of its 10 captions a video (a cut
# of depth: the re-ranks' host work grows with the queries)
VTEST = ("vtest", 1500, 5)
VTEST_GATE_CALLS = 8 + 2  # 8 text batches and 2 gallery batches of 1,024
# the per-head pass runs on 500 videos with 1 caption a video, not vtest's
# 1,500 x 10: its 8 files of 15,000 queries took 64-95 s of host
# formatting, 1,500 x 1 18-20 s; this cut of its depth keeps the script
# inside its limit with phases 8-14 (200 x 1 took 13.7 s against 14.9-16.4:
# most of the pass does not scale with the gallery)
VHEADS = ("vheads", 500, 1)
HEAD_GATE_CALLS = 1 + 1  # 1 text batch and 1 gallery batch of 1,024
# the passes on vheads: k-reciprocal's host work grows with the square of
# queries + gallery (18-22 s a pass on vtest's 15,000 queries, and as much
# again on the CPU copies), so it runs there too, a cut of depth that makes
# room for phases 12 and 13
ON_VHEADS = ("kreciprocal", "each_head")
POSTPROCESSING = (("kreciprocal", {"rerank": "kreciprocal"}), ("tkb", {"rerank": "tkb"}),
                  ("concept", {"rerank": "concept"}), ("each_head", {"each_head": 1}))


def task3_dispatch(chose):
    """task3's dispatch: the visual cache, no text cache (the captions are
    drawn anew each epoch), K 1 eager, staged validation"""
    return (chose["vis_cache_bytes"] and chose["txt_cache_bytes"] is None
            and chose["steps_per_dispatch"] == 1 and not chose["graph"]
            and chose["stage_val_features"])


def aux_options(root, prefix, **kw):
    from laff_tpu_torch.engine.prepare import Options

    return Options(trainCollection="t3train", valCollection="t3test", rootpath=root,
                   val_set="no", config_name="rehearsal", batch_size=128, device="cuda",
                   rank_path="kernel", sync_debug=1, random_seed=SEED, model_prefix=prefix,
                   **kw)


def task3_step_check(torch, T, prepared, state_dict, smi):
    """(a) One task3 step (the caption, its false caption and the mask of the
    feed's first batch) on the card and on the CPU from the same weights,
    dropout off: losses and the BatchNorm running statistics after it
    within STEP_LOSS_RTOL. Then the eager step on the card timed against
    the same step without the false caption, and profiled."""
    device = torch.device("cuda")
    batch = first_batches(prepared.train_feed, 1)[0]
    check("false_txt" in batch and (batch["task3_mask"] == 1).any()
          and (batch["task3_mask"] == -1).any(), "the task3 feed gave no false captions")
    runs = {}
    for dev in (device, torch.device("cpu")):
        s = new_step(T, prepared.config, prepared.spec, state_dict, dev)
        dropout_off(s.model)
        s.set_epoch(0)
        hb = T.host_batch(batch, False, True, True)
        txt = {k: v.to(dev) for k, v in hb["txt"].items()}
        vis = {k: v.to(dev) for k, v in hb["vis"].items()}
        g = torch.Generator(device=dev).manual_seed(SEED)
        loss = float(s(txt, vis, g))
        stats = {k: v.float().cpu() for k, v in s.model.state_dict().items() if "running" in k}
        runs[dev.type] = (loss, stats, s, txt, vis, g)
    (lc, sc, step, txt, vis, g), (lp, sp) = runs["cuda"], runs["cpu"][:2]
    rel = abs(lc - lp) / abs(lp)
    stat_rel = max(float((sc[k] - sp[k]).abs().max()) / max(float(sp[k].abs().max()), 1e-12)
                   for k in sp)
    check(rel <= STEP_LOSS_RTOL and stat_rel <= STEP_LOSS_RTOL,
          f"[task3] card vs CPU step: loss {lc} vs {lp}, BN statistics rel diff {stat_rel}")
    log(f"  [task3] card vs CPU, one step with false captions from the same weights and batch, "
        f"dropout off: loss {lc:.6f} vs {lp:.6f} (rel diff {rel:.3g}), BatchNorm running "
        f"statistics max rel diff {stat_rel:.3g} (<= {STEP_LOSS_RTOL})")

    main, _, _ = T.split_task3(txt)
    ms = {}
    for what, t in (("task3", txt), ("no false caption", main)):
        times = []
        for _ in range(TASK3_TIMED_STEPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(t, vis, g)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms[what] = statistics.median(times[1:])
    busy = log_profile("[task3] eager step", *profiled(torch, lambda: step(txt, vis, g)),
                       ms["task3"])
    log("task3_step_timing " + json.dumps({
        "eager_ms": ms["task3"], "eager_without_false_ms": ms["no false caption"],
        "device_ms": busy, "idle": None if busy is None else max(0.0, 1 - busy / ms["task3"]),
        "card": smi}))


def task3_phase(torch, K, P, root, smi):
    """7(a). task3 training at full width on t3train -> t3test: two epochs
    of trainer.main with the false-caption set, its dispatch, launches and
    task3 metrics; one step card vs CPU and its timing. Returns the
    launches and the best checkpoint."""
    from laff_tpu_torch.engine import trainer as T
    from laff_tpu_torch.engine.checkpoint import load_checkpoint
    from laff_tpu_torch.engine.prepare import prepare
    from laff_tpu_torch.models import LAFFModel

    opt = aux_options(root, "smoke_task3", num_epochs=2, task3_caption="false")
    t0 = time.perf_counter()
    prepared = prepare(opt)
    n_params = sum(p.numel() for p in LAFFModel(prepared.spec).parameters())
    log(f"[task3] prepare: {time.perf_counter() - t0:.1f} s; {n_params} parameters; "
        f"{len(prepared.train_feed.task3_source.cap_ids)} captions with a false-caption entry; "
        f"{prepared.spec.task3}")
    check(n_params == 84_925_644, f"[task3] the rehearsal model has {n_params} parameters")
    res, launches, _ = run_main(torch, K, T, opt, prepared, smi, "task3",
                                gate_calls=CUT_VAL_GATE_CALLS, dispatch_ok=task3_dispatch,
                                val_batches=CUT_VAL_GATE_CALLS)
    keys = [f"task3_{k}" for k in T.METRICS]
    check(all(k in e for e in res["history"] for k in keys),
          f"[task3] no task3_* metrics in {res['history'][0].keys()}")
    tags = {line.split("\t")[1] for line in open(os.path.join(res["model_path"], "scalars.tsv"))}
    check({"task3val/r1", "task3val/mir"} <= tags, f"[task3] scalars.tsv tags {tags}")
    log("[task3] negation subset per epoch: " + "; ".join(
        f"r1 {e['task3_r1']:.3f} mir {e['task3_mir']:.5f}" for e in res["history"]))
    del res["model"]
    ckpt_path = os.path.join(res["model_path"], "model_best.pth.tar")
    task3_step_check(torch, T, prepared, load_checkpoint(ckpt_path)["state_dict"], smi)
    return launches, ckpt_path


def task2_phase(torch, K, root, smi):
    """7(b). task2 (--task2_intended 1) at full width on t3train -> t3test:
    the concept labels in the visual cache, 16 graphed steps against 16
    eager ones, one epoch of trainer.main at the default dispatch, one step
    card vs CPU. Returns the launches."""
    from laff_tpu_torch.engine import trainer as T
    from laff_tpu_torch.engine.checkpoint import load_checkpoint
    from laff_tpu_torch.engine.prepare import prepare

    opt = aux_options(root, "smoke_task2", num_epochs=1, task2_caption="obj",
                      task2_intended=1)
    prepared = prepare(opt)
    t2 = prepared.spec.task2
    check(t2 is not None and t2.vis_dim_in == 5376 and t2.n_concepts >= 100,
          f"[task2] spec {t2}")
    log(f"[task2] {t2}")
    cache_and_graph_checks(torch, K, T, opt, prepared, smi, "task2", timings=False)
    res, launches, _ = run_main(torch, K, T, opt, prepared, smi, "task2", epochs=1,
                                gate_calls=CUT_VAL_GATE_CALLS, val_batches=CUT_VAL_GATE_CALLS)
    del res["model"]
    ck = load_checkpoint(os.path.join(res["model_path"], "model_best.pth.tar"))
    check(any(k.startswith("task2_vis_head.") for k in ck["state_dict"]),
          "[task2] the checkpoint has no concept head")
    card_vs_cpu_step(torch, T, prepared, ck["state_dict"], "task2")
    return launches


def predict_options(P, root, coll, ckpt, name, **kw):
    return P.PredictOptions(testCollection=coll, model_path=ckpt, sim_name=f"smoke_{name}",
                            rootpath=root, query_sets=f"{coll}.caption.txt", overwrite=1,
                            device="cuda", rank_path="kernel",
                            predict_result_file=os.path.join(root, "result_log", f"{name}.txt"),
                            **kw)


def timed_predict(torch, K, P, opt, what, smi):
    K.reset_launches()
    t0 = time.perf_counter()
    res = P.main(opt)[opt.query_sets]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    secs = {k: round(v, 2) for k, v in res["seconds"].items()}
    log(f"[{what}] predictor {opt.testCollection}: {wall:.1f} s wall {secs}; launches "
        f"{launches}; t2v {[round(float(x), 4) for x in res['t2v']]} [{smi}]")
    return res, launches, wall


def card_embeddings(torch, P, opt):
    """The test collection embedded on the card by the checkpoint's model,
    as the predictor embeds it: (model inputs, txt embs, ids, vis embs,
    ids)."""
    ckpt = P.load_checkpoint(opt.model_path)
    device = torch.device("cuda")
    feats = P.rebuild_featurizers(ckpt, opt.rootpath)
    vis_feed, txt_feed, tsrc, vis_ids = P.build_test_feeds(opt, ckpt["config"], opt.query_sets,
                                                           feats)
    embedder = P.Embedder(P.rebuild_model(ckpt, device), device)
    txt_embs, txt_ids = embedder.embed_txt(txt_feed)
    vis_embs, vis_ids = embedder.embed_vis(vis_feed)
    return (embedder, txt_feed, tsrc), txt_embs, txt_ids, vis_embs, vis_ids


def negation_phase(torch, K, P, root, ckpt, negated, smi):
    """7(c). predictor.main with --task3_caption on t3test under 7(a)'s
    checkpoint: the queries with a negation counted, the gate over the
    queries and both clauses, no rank kernel (t2v comes from the adjusted
    scores); its t2v row against eval_t2v of scores recomputed by the
    plain path from the same card embeddings."""
    import numpy as np

    from laff_tpu_torch.eval.metrics import eval_label_matrix, label_matrix_from_scores

    opt = predict_options(P, root, "t3test", ckpt, "negation", task3_caption="negation")
    res, launches, wall = timed_predict(torch, K, P, opt, "negation", smi)
    check(res["negated_queries"] == negated,
          f"[negation] {res['negated_queries']} queries counted with a negation, not {negated}")
    expect = {"sim_rank_wide": 0, "sim_rank_tiled": 0, "gate_attention": NEGATION_GATE_CALLS,
              "gate_attention_simple": 0}
    check(launches == expect, f"[negation] launches {launches}, expected {expect}")
    (embedder, txt_feed, tsrc), _, txt_ids, vis_embs, vis_ids = card_embeddings(torch, P, opt)
    pos, neg, mask = P.embed_negation_split(embedder, txt_feed, tsrc, txt_ids)
    scores = P.negation_adjusted_scores(P.score_matrix(pos, vis_embs),
                                        P.score_matrix(neg, vis_embs), mask)
    labels = label_matrix_from_scores(scores, txt_ids, vis_ids)
    host_ranks = labels.argmax(axis=1) + 1
    moved = np.flatnonzero(host_ranks != res["t2v_ranks"])
    col = {v: i for i, v in enumerate(vis_ids)}
    gt = scores[np.arange(len(txt_ids)), [col[t.split("#")[0]] for t in txt_ids]]
    tied = [r for r in moved if (scores[r] == gt[r]).sum() > 1]
    check(len(tied) == len(moved), f"[negation] {len(moved) - len(tied)} ranks differ from the "
          f"host label matrix's without an exact tie")
    ref = eval_label_matrix(labels)  # eval_t2v of the recomputed scores
    check(moved.size or tuple(res["t2v"]) == tuple(ref),
          f"[negation] t2v {res['t2v']} vs eval_t2v of the recomputed scores {ref}")
    log(f"  [negation] {negated} of {len(txt_ids)} queries carry a negation; t2v equals eval_t2v "
        f"of the plain path's adjusted scores from the same card embeddings "
        f"({moved.size} ranks at exact ties); the clauses embedded in "
        f"{res['seconds']['negation']:.2f} s and scored in {res['seconds']['score_matrix']:.2f} s "
        f"of {wall:.1f} s [{smi}]")
    return launches


def rerank_phase(torch, K, P, root, ckpt, smi):
    """7(d). Re-ranking and per-head dumps on a VATEX-test-shaped world
    under 7(a)'s checkpoint: --rerank tkb and concept on vtest, and
    --rerank kreciprocal and --each_head 1 on vheads; each re-ranked t2v row
    against the port's host function on the same embeddings moved to the
    CPU. Returns the launches by run."""
    import numpy as np

    from laff_tpu_torch.data.synth import build_world
    from laff_tpu_torch.eval import rerank

    coll, n_videos, caps = VTEST
    t0 = time.perf_counter()
    log(f"world: {build_world(root, coll, n_videos, caps, 11286, SEED + 3, concept_pkl=True)} "
        f"in {time.perf_counter() - t0:.1f} s; disk free "
        f"{shutil.disk_usage(root).free / 1e9:.1f} GB")
    heads_coll, head_videos, head_caps = VHEADS
    log(f"world: {build_world(root, heads_coll, head_videos, head_caps, 11286, SEED + 5)}")
    concept = dict(concept_pkl=os.path.join(root, coll, "TextData", "concept_sim.pkl"),
                   concept_caption=os.path.join(root, coll, "TextData", f"{coll}.caption.txt"))
    out, by_run = {}, {}
    for name, extra in POSTPROCESSING:
        per_head, on_heads = name == "each_head", name in ON_VHEADS
        opt = predict_options(P, root, heads_coll if on_heads else coll, ckpt, name,
                              **extra, **(concept if name == "concept" else {}))
        res, launches, wall = timed_predict(torch, K, P, opt, name, smi)
        expect = {"sim_rank_wide": int(per_head), "sim_rank_tiled": 0,
                  "gate_attention": HEAD_GATE_CALLS if on_heads else VTEST_GATE_CALLS,
                  "gate_attention_simple": 0}
        check(launches == expect, f"[{name}] launches {launches}, expected {expect}")
        out[name], by_run[f"{name}_predict"] = (opt, res, wall), launches
    log(f"  [concept] the lemmatizer took the {rerank.LEMMATIZER['branch']} branch")

    cpu = torch.device("cpu")
    host = {}
    for kind in ("kreciprocal", "tkb"):  # each on its pass's collection
        (_, _, tsrc), txt_embs, txt_ids, vis_embs, vis_ids = card_embeddings(torch, P,
                                                                             out[kind][0])
        scores = P.score_matrix(txt_embs, vis_embs)
        t0 = time.perf_counter()
        reranked = P.apply_rerank(kind, scores, txt_embs.cpu(), vis_embs.cpu())
        host[kind] = (P.t2v_from_scores(reranked, txt_ids, vis_ids, cpu)[0],
                      time.perf_counter() - t0)
    t0 = time.perf_counter()
    reranked = P.concept_rerank_scores(out["concept"][0], scores, txt_ids, vis_ids, tsrc)
    host["concept"] = (P.t2v_from_scores(reranked, txt_ids, vis_ids, cpu)[0],
                       time.perf_counter() - t0)
    for kind, (t2v, secs) in host.items():
        _, res, wall = out[kind]
        check(tuple(res["t2v"]) == tuple(t2v),
              f"[{kind}] re-ranked t2v {res['t2v']} vs the host function's {t2v}")
        log(f"  [{kind}] re-ranked t2v equals the host function's on the CPU copies of the "
            f"same embeddings; re-rank {res['seconds']['rerank']:.2f} s in the pass "
            f"({wall:.1f} s), {secs:.2f} s on the CPU copies [{smi}]")

    opt, res, wall = out["each_head"]
    sdir = os.path.join(root, heads_coll, "SimilarityIndex", opt.query_sets, opt.sim_name)
    with open(os.path.join(root, heads_coll, "TextData", opt.query_sets)) as fh:
        head_ids = [line.split(" ", 1)[0] for line in fh.read().splitlines()]
    heads = txt_embs.shape[1]
    check(len(res["per_head"]) == heads, f"[each_head] {len(res['per_head'])} head rows")
    for h in range(heads):
        path = os.path.join(sdir, f"head{h}.id.sent.score.txt")
        with open(path) as fh:
            first = fh.readline().split()
            n_lines = 1 + sum(1 for _ in fh)
        check(n_lines == len(head_ids) and len(first) == 1 + 2 * head_videos,
              f"[each_head] {path}: {n_lines} lines, {len(first)} fields in the first")
        check(first[0] == head_ids[0] and np.isfinite(np.asarray(first[2::2], float)).all(),
              f"[each_head] {path} first line {first[:5]}")
        os.remove(path)
    with open(os.path.join(sdir, "perf.txt")) as fh:
        check(fh.read().count("Text to video head") == heads, "[each_head] perf.txt")
    log(f"  [each_head] on {heads_coll} ({head_videos} videos x {head_caps} captions): {heads} "
        f"head{{h}}.id.sent.score.txt files of {len(head_ids)} lines x "
        f"{head_videos} videos and perf.txt written ({res['seconds']['each_head']:.1f} s of "
        f"{wall:.1f} s); per-head r1 {[round(float(m[0]), 3) for m in res['per_head']]} [{smi}]")
    timing = {name: {"wall_s": wall, "seconds": res["seconds"]}
              for name, (_, res, wall) in out.items()}
    timing.update(host_rerank_s={k: s for k, (_, s) in host.items()}, card=smi)
    log("postprocessing_timing " + json.dumps(timing))
    return by_run


def aux_phase(torch, K, P, root, smi):
    """7. task3 and task2 training, negation scoring, re-ranking and
    per-head dumps at full width. Returns the launches by path."""
    from laff_tpu_torch.data.synth import build_world

    t0 = time.perf_counter()
    train = build_world(root, "t3train", 1500, 20, 11286, SEED + 2, false_captions=True,
                        objects=True)
    test = build_world(root, "t3test", 2990, CUT_CAPTIONS, 11286, SEED, negations=True)
    log(f"worlds: {train} and {test} in {time.perf_counter() - t0:.1f} s")
    launches_t3, ckpt = task3_phase(torch, K, P, root, smi)
    by_path = {"task3_train": launches_t3, "task2_train": task2_phase(torch, K, root, smi),
               "negation_predict": negation_phase(torch, K, P, root, ckpt,
                                                  test["negated_captions"], smi)}
    by_path.update(rerank_phase(torch, K, P, root, ckpt, smi))
    return by_path


# ---------------------------------------------------------------------------
# phase 8: AVS ad-hoc search over an iacc.3-sized gallery
# ---------------------------------------------------------------------------

AVS_COLLECTION, AVS_SHOTS = "iacc.3", 335_944  # the TRECVID 2016-2018 AVS gallery
AVS_EDITIONS, AVS_TOPICS = ("tv16", "tv17", "tv18"), 30
# the editions streamed and scored: tv18 is built but not streamed, a cut of
# depth that makes room for phases 12 and 13
AVS_STREAMED = AVS_EDITIONS[:2]
AVS_BATCH = 1024
AVS_GATE_CALLS = 1 + -(-AVS_SHOTS // AVS_BATCH)  # a query set: its topics, then 329 gallery blocks
# streamed (a flat product per gallery block) vs cached (per-head cosines of
# the whole gallery, averaged): f32 sums in other orders
AVS_STREAM_TOL = 1e-6
AVS_INFAP_RATIO = 5.0  # the trained model's infAP over a random run's, at least
PERL_TOL = 2e-4  # the NIST report prints 4 decimals


def read_score_file(path):
    """{topic: (shot ids, scores)} of an id.sent.score.txt."""
    import numpy as np

    out = {}
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            out[parts[0]] = (parts[1::2], np.asarray(parts[2::2], np.float64))
    return out


def near_tie(vals, i, tol):
    """Position i of a descending list lies within ``tol`` of a neighbour
    (the list's last entry may tie with the first one left out)."""
    return (i == len(vals) - 1 or (i > 0 and vals[i - 1] - vals[i] <= tol)
            or (i + 1 < len(vals) and vals[i] - vals[i + 1] <= tol))


def avs_infap(avs_eval, root, edition, sim_name, use_perl=0):
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = avs_eval.main([AVS_COLLECTION, edition, sim_name, "--rootpath", root,
                            "--overwrite", "1", "--use_perl", str(use_perl)])
    check(rc == 0, f"[avs] avs_eval {edition} {sim_name} exited {rc}: {out.getvalue()}")
    line = out.getvalue().strip().splitlines()[-1].split()
    check(line[:2] == [edition, "infAP"], f"[avs] avs_eval printed {line}")
    return float(line[2])


def random_run_infap(avs_eval, root, edition, ref_sim, rng, shots):
    """infAP of a seeded random run of the gallery's ``shots`` (2,000 a
    topic) over the topics of ``ref_sim``'s score file for ``edition``,
    written in the same format as sim 'smoke_random'."""
    qs = f"{edition}.avs.txt"
    sdir = os.path.join(root, AVS_COLLECTION, "SimilarityIndex", qs)
    os.makedirs(os.path.join(sdir, "smoke_random"), exist_ok=True)
    with open(os.path.join(sdir, "smoke_random", "id.sent.score.txt"), "w") as fh:
        for t in read_score_file(os.path.join(sdir, ref_sim, "id.sent.score.txt")):
            pick = rng.choice(len(shots), 2000, replace=False)
            fh.write(f"{t} " + " ".join(f"{shots[j]} {1.0 - r / 2000}"
                                        for r, j in enumerate(pick)) + "\n")
    return avs_infap(avs_eval, root, edition, "smoke_random")


def avs_block_check(torch, K, embedder, vis_feed):
    """The gate kernel against its plain version on the video tower's gate
    input for the first gallery block of the world, as gate_phase compares
    them."""
    from laff_tpu_torch.data import EvalFeed

    gate = embedder.model.vis_net.attention
    block = EvalFeed(vis_feed.ids[:vis_feed.batch_size], vis_feed.batcher, vis_feed.batch_size)
    seen = []
    hook = gate.register_forward_pre_hook(lambda module, args: seen.append(args[0]))
    try:
        embedder.embed_vis(block)
    finally:
        hook.remove()
    local = seen[0]
    b, length, _ = local.shape
    x = local.reshape(b, length, gate.heads, gate.dh).float().contiguous()
    k, bias = gate.gate_kernel.detach().float(), gate.gate_bias.detach().float()
    got = K.fused_gate_attention(x, k, bias, 1.0, with_ave=gate.with_ave, mul=gate.mul)
    ref = K.fused_gate_attention_plain(x, k, bias, 1.0, with_ave=gate.with_ave, mul=gate.mul)
    err = float((got - ref).abs().max())
    check(err <= GATE_TOL, f"[avs] gate on a gallery block: max abs err {err}")
    return tuple(x.shape), err


def avs_phase(torch, K, P, root, ckpt, smi, serve=None, sweep_avs=None):
    """8. AVS ad-hoc search at iacc.3's size under phase 4's trained
    checkpoint: the world built and timed (three editions), the query sets
    of AVS_STREAMED streamed through predictor.main (the gate only, 1 + 329
    launches a set, no rank kernel; the score files and t2v.pkl checked),
    one set again with the
    gallery embedded whole and scored by score_matrix (lists and scores
    against the streamed ones), the gate against its plain version on a
    block of this world, one streamed pass profiled, and infAP by
    cli/avs_eval against a seeded random run (and perl's scorer where
    there is perl). Phase 9 runs on the world, then ``serve()`` (phase 13)
    and ``sweep_avs(random infAP by edition)`` (phase 14(c)) if given. The
    world is removed at the end. Returns the launches, phase 9's and what
    ``serve`` and ``sweep_avs`` return."""
    import pickle

    import numpy as np

    from laff_tpu_torch.cli import avs_eval
    from laff_tpu_torch.data.synth import build_avs_world
    from laff_tpu_torch.engine.evaluator import score_matrix_streaming

    t0 = time.perf_counter()
    info = build_avs_world(root, AVS_COLLECTION, AVS_SHOTS, AVS_EDITIONS, AVS_TOPICS,
                           seed=SEED + 8, benchmark=(IBENCH, IBENCH_SHOTS, IBENCH_CAPS))
    build_s = time.perf_counter() - t0
    log(f"[avs] world {info} in {build_s:.1f} s ({info['feature_bytes'] / 1e9:.2f} GB of "
        f"features); disk free {shutil.disk_usage(root).free / 1e9:.1f} GB [{smi}]")
    cdir = os.path.join(root, AVS_COLLECTION)
    try:
        sets = [f"{e}.avs.txt" for e in AVS_STREAMED]
        opt = P.PredictOptions(testCollection=AVS_COLLECTION, model_path=ckpt,
                               sim_name="smoke_avs", rootpath=root, query_sets=",".join(sets),
                               batch_size=AVS_BATCH, overwrite=1, device="cuda")
        check(AVS_SHOTS > P.LARGE_GALLERY, f"[avs] LARGE_GALLERY {P.LARGE_GALLERY}")
        K.reset_launches()
        t0 = time.perf_counter()
        res = P.main(opt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        expect = {"sim_rank_wide": 0, "sim_rank_tiled": 0,
                  "gate_attention": len(sets) * AVS_GATE_CALLS, "gate_attention_simple": 0}
        check(launches == expect, f"[avs] launches {launches}, expected {expect}")
        timing = {"world_build_s": build_s, "feature_bytes": info["feature_bytes"],
                  "streamed_wall_s": wall, "card": smi}
        for qs in sets:
            secs = res[qs]["seconds"]
            check({"embed_txt", "stream", "topk", "score_file", "rank_dump"} <= set(secs),
                  f"[avs] {qs} phases {secs}")
            sdir = os.path.join(cdir, "SimilarityIndex", qs, opt.sim_name)
            scores = read_score_file(os.path.join(sdir, "id.sent.score.txt"))
            check(len(scores) == AVS_TOPICS and all(
                len(ids) == 2000 and len(set(ids)) == 2000 and (np.diff(v) <= 0).all()
                and np.isfinite(v).all() for ids, v in scores.values()),
                f"[avs] {qs}: the score file is not {AVS_TOPICS} lines of 2,000 descending "
                f"distinct (id, score) pairs")
            with open(os.path.join(sdir, "t2v.pkl"), "rb") as fh:
                dump = pickle.load(fh)
            check(list(dump) == list(scores) and all(
                d["rank_list"] == scores[t][0][:500] and len(d["sim_value"]) == 500
                for t, d in dump.items()), f"[avs] {qs}: t2v.pkl is not the top 500")
            timing[qs] = {**secs, "videos_per_s": AVS_SHOTS / secs["stream"]}
            log(f"  [avs] {qs} streamed: " + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items())
                + f"; {AVS_SHOTS / secs['stream']:.0f} gallery videos/s [{smi}]")
        log(f"  [avs] launches of the streamed sets {launches} ({AVS_GATE_CALLS} gate "
            f"launches a set, no rank kernel); {wall:.1f} s wall")

        # the gallery embedded whole (about 5.5 GB on the card) and scored by
        # score_matrix, for one query set
        saved = P.LARGE_GALLERY
        P.LARGE_GALLERY = AVS_SHOTS
        try:
            cached_opt = P.PredictOptions(
                testCollection=AVS_COLLECTION, model_path=ckpt, sim_name="smoke_avs_cached",
                rootpath=root, query_sets=sets[0], batch_size=AVS_BATCH, overwrite=1,
                device="cuda")
            t0 = time.perf_counter()
            cached_secs = P.main(cached_opt)[sets[0]]["seconds"]
            torch.cuda.synchronize()
            cached_wall = time.perf_counter() - t0
        finally:
            P.LARGE_GALLERY = saved
        check("embed_vis" in cached_secs and "stream" not in cached_secs,
              f"[avs] the cached pass ran {cached_secs}")
        streamed, cached = (read_score_file(os.path.join(
            cdir, "SimilarityIndex", sets[0], name, "id.sent.score.txt"))
            for name in ("smoke_avs", "smoke_avs_cached"))
        check(list(streamed) == list(cached), "[avs] streamed and cached topics differ")
        err, moved = 0.0, 0
        for t, (ids_s, v_s) in streamed.items():
            ids_c, v_c = cached[t]
            err = max(err, float(np.abs(v_s - v_c).max()))
            bad = [i for i in range(len(ids_s)) if ids_s[i] != ids_c[i]]
            moved += len(bad)
            check(all(near_tie(v_s, i, AVS_STREAM_TOL) and near_tie(v_c, i, AVS_STREAM_TOL)
                      for i in bad), f"[avs] topic {t}: streamed and cached lists differ away "
                  f"from near ties")
        check(err <= AVS_STREAM_TOL, f"[avs] streamed vs cached scores: max abs diff {err}")
        timing["cached"] = {"wall_s": cached_wall, **cached_secs}
        log(f"  [avs] {sets[0]} cached (gallery embedded whole, score_matrix): {cached_wall:.1f} "
            f"s ({', '.join(f'{k} {v:.2f}' for k, v in cached_secs.items())}); against the "
            f"streamed lists: scores within {err:.3g}, {moved} of "
            f"{AVS_TOPICS * 2000} places differ, all at near ties [{smi}]")

        # one streamed pass outside the predictor, profiled; and the gate
        # kernel against its plain version on a block of this world
        ck = P.load_checkpoint(ckpt)
        device = torch.device("cuda")
        embedder = P.Embedder(P.rebuild_model(ck, device), device)
        vis_feed, txt_feed, _, _ = P.build_test_feeds(
            opt, ck["config"], sets[0], P.rebuild_featurizers(ck, root))
        txt_embs, _ = embedder.embed_txt(txt_feed)
        shape, gate_err = avs_block_check(torch, K, embedder, vis_feed)
        log(f"  [avs] gate kernel vs plain on the video tower's input for a gallery block "
            f"{shape}: max abs err {gate_err:.3g} (<= {GATE_TOL})")
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            profiled_scores, _ = score_matrix_streaming(embedder, txt_embs, vis_feed)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        kernel_ms = copy_ms = 0.0
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
            if "memcpy" in e.key.lower() or "memset" in e.key.lower():
                copy_ms += us / 1e3
            else:
                kernel_ms += us / 1e3
        check(profiled_scores.shape == (AVS_TOPICS, AVS_SHOTS)
              and np.isfinite(profiled_scores).all(), "[avs] the profiled pass's scores")
        busy = {"wall_s": prof_wall, "kernel_ms": kernel_ms, "copy_ms": copy_ms,
                "kernel_share": kernel_ms / 1e3 / prof_wall,
                "busy_share": (kernel_ms + copy_ms) / 1e3 / prof_wall}
        timing["profiled_stream"] = busy
        log(f"  [avs] one streamed pass under the profiler: {prof_wall:.2f} s wall, kernels "
            f"{kernel_ms:.1f} ms and copies {copy_ms:.1f} ms of device time: busy "
            f"{busy['busy_share']:.1%} (kernels {busy['kernel_share']:.1%}) [{smi}]"
            if kernel_ms else "  [avs] the profiler recorded no device time (not measured)")

        # infAP of the trained run against a seeded random run of the gallery's
        # shots, written in the same format
        t0 = time.perf_counter()
        rng = np.random.default_rng(SEED + 8)
        shots = [line.strip() for line in open(os.path.join(cdir, "VideoSets",
                                                             f"{AVS_COLLECTION}.txt"))]
        trained, random_run, perl = {}, {}, {}
        for edition, qs in zip(AVS_STREAMED, sets):
            trained[edition] = avs_infap(avs_eval, root, edition, "smoke_avs")
            random_run[edition] = random_run_infap(avs_eval, root, edition, "smoke_avs", rng,
                                                   shots)
            check(trained[edition] >= AVS_INFAP_RATIO * random_run[edition]
                  and trained[edition] > 0, f"[avs] {edition}: infAP {trained[edition]} of the "
                  f"trained model against {random_run[edition]} of a random run")
            if shutil.which("perl"):
                perl[edition] = avs_infap(avs_eval, root, edition, "smoke_avs", use_perl=1)
                check(abs(perl[edition] - trained[edition]) <= PERL_TOL,
                      f"[avs] {edition}: infAP {trained[edition]} vs {perl[edition]} by "
                      f"sample_eval.pl")
        chain_s = time.perf_counter() - t0
        timing.update(infap=trained, random_infap=random_run, perl_infap=perl or None,
                      infap_chain_s=chain_s)
        log(f"  [avs] infAP by cli/avs_eval: {trained}; a seeded random run of the gallery's "
            f"shots: {random_run}; "
            + (f"sample_eval.pl agrees within {PERL_TOL}: {perl}" if perl
               else "perl is not on this machine: the NIST scorer not run")
            + f"; the chain {chain_s:.1f} s [{smi}]")
        log("avs_timing " + json.dumps(timing))
        del embedder, txt_embs, profiled_scores
        t0 = time.perf_counter()
        phase9 = large_gallery_phase(torch, K, P, root, ckpt, trained[AVS_EDITIONS[0]], smi)
        log(f"large gallery phase (9): {time.perf_counter() - t0:.1f} s")
        served = swept = None
        if serve is not None:
            t0 = time.perf_counter()
            served = serve()
            log(f"serving phase (13): {time.perf_counter() - t0:.1f} s")
        if sweep_avs is not None:
            t0 = time.perf_counter()
            swept = sweep_avs(random_run)
            log(f"avs_task phase (14(c)): {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(cdir, ignore_errors=True)
        shutil.rmtree(os.path.join(root, IBENCH), ignore_errors=True)
    return launches, phase9, served, swept


# ---------------------------------------------------------------------------
# phase 9: the large benchmark gallery and the int8 gallery over iacc.3
# ---------------------------------------------------------------------------

IBENCH, IBENCH_SHOTS, IBENCH_CAPS = "ibench", 500, 20  # MSR-VTT's 20 captions a video
IBENCH_TXT_BATCHES = -(-IBENCH_SHOTS * IBENCH_CAPS // AVS_BATCH)  # 10 of 1,024 captions
GALLERY_BLOCKS = -(-AVS_SHOTS // AVS_BATCH)  # 329
IBENCH_TOPK = 2000  # the predictor's streamed t2v.pkl
YARD_ROWS = 1536  # caption rows of one yardstick block: 2 GB of f32 scores
INT8_OVERLAP = 0.99  # each topic's top 2,000 from the int8 gallery against the exact one
INT8_INFAP_TOL = 0.01


def counted_predict(torch, K, P, opt):
    """predictor.main with the launch counts zeroed just before and read just
    after, and the calls of score_matrix and score_matrix_streaming counted
    (the streamed benchmark and the int8 gallery must make none)."""
    calls = {"score_matrix": 0, "score_matrix_streaming": 0}
    saved = {name: getattr(P, name) for name in calls}

    def counting(name):
        def fn(*args, **kwargs):
            calls[name] += 1
            return saved[name](*args, **kwargs)
        return fn

    for name in calls:
        setattr(P, name, counting(name))
    try:
        K.reset_launches()
        t0 = time.perf_counter()
        res = P.main(opt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
    finally:
        for name, fn in saved.items():
            setattr(P, name, fn)
    return res, launches, wall, calls


def check_launches(what, launches, gate, tiled=0):
    expect = {"sim_rank_wide": 0, "sim_rank_tiled": tiled, "gate_attention": gate,
              "gate_attention_simple": 0}
    check(launches == expect, f"[{what}] launches {launches}, expected {expect}")


def ibench_yardstick(torch, P, opt, ckpt):
    """The ibench gallery embedded whole on the card and scored in row
    blocks of YARD_ROWS captions: each caption's t2v rank (ties
    larger-index-first) and top IBENCH_TOPK (torch.topk), the f32 unit
    heads flattened, and the scores of the captioned shots' columns."""
    from laff_tpu_torch.eval.metrics import ranks_from_scores
    from laff_tpu_torch.ops import flatten_heads

    ck = P.load_checkpoint(ckpt)
    device = torch.device("cuda")
    embedder = P.Embedder(P.rebuild_model(ck, device), device)
    vis_feed, txt_feed, tsrc, _ = P.build_test_feeds(opt, ck["config"], opt.query_sets,
                                                     P.rebuild_featurizers(ck, opt.rootpath))
    txt, txt_ids = embedder.embed_txt(txt_feed)
    vis, vis_ids = embedder.embed_vis(vis_feed)
    heads = txt.shape[1]
    tn, vn = flatten_heads(txt), flatten_heads(vis)
    vis16 = flatten_heads(vis.to(torch.bfloat16))  # the bf16 cache rows of 9(c)
    del vis
    col = {v: i for i, v in enumerate(vis_ids)}
    gt = torch.as_tensor([col[t.split("#")[0]] for t in txt_ids], device="cuda")
    ranks, top_vals, top_idx = [], [], []
    for start in range(0, len(txt_ids), YARD_ROWS):
        s = tn[start:start + YARD_ROWS] @ vn.T / heads
        ranks.append(ranks_from_scores(s, gt[start:start + YARD_ROWS]))
        v, i = torch.topk(s, IBENCH_TOPK, dim=1)
        top_vals.append(v)
        top_idx.append(i)
        del s
    captioned = sorted(set(gt.tolist()))
    cap_scores = tn @ vn[captioned].T / heads  # (T, captioned shots)
    return {"embedder": embedder, "vis_feed": vis_feed, "txt": txt, "txt_ids": txt_ids,
            "vis_ids": vis_ids, "tn": tn, "vn": vn, "vis16": vis16, "gt": gt,
            "ranks": torch.cat(ranks), "top_vals": torch.cat(top_vals).cpu().numpy(),
            "top_idx": torch.cat(top_idx).cpu().numpy(), "captioned": captioned,
            "cap_scores": cap_scores}


def v2t_against_yardstick(torch, y, v2t_ranks):
    """Each captioned shot's sorted positive ranks (the streamed run's)
    against those counted on the yardstick's column of that shot, equal
    except where as many captions score within SCORE_TIE_TOL. Returns the
    shots whose lists differ."""
    import numpy as np

    gt = y["gt"]
    check(len(v2t_ranks) == len(y["captioned"]),
          f"[ibench] v2t lists for {len(v2t_ranks)} shots, {len(y['captioned'])} captioned")
    caps = torch.arange(len(gt), device="cuda")[:, None]
    moved = 0
    for j, shot in enumerate(y["captioned"]):
        col = y["cap_scores"][:, j][:, None]  # (T, 1)
        pos = torch.nonzero(gt == shot).flatten()
        s_p = col[pos, 0][None, :]
        beats = (col > s_p) | ((col == s_p) & (caps > pos[None, :]))
        want = np.sort((1 + beats.sum(dim=0)).cpu().numpy())
        near = int((((col - s_p).abs() <= SCORE_TIE_TOL).sum(dim=0) - 1).max())
        got = np.asarray(v2t_ranks[j])
        check(got.shape == want.shape and int(np.abs(got - want).max()) <= near,
              f"[ibench] shot {shot}: v2t ranks {got[:5]} vs the yardstick's {want[:5]}")
        moved += int((got != want).any())
    return moved


def topk_against_yardstick(y, dump):
    """The streamed t2v.pkl (IBENCH_TOPK ids and scores a caption) against the
    yardstick's top-k: scores within AVS_STREAM_TOL, ids equal but at near
    ties. Returns (max |score diff|, places that differ)."""
    import numpy as np

    vis_arr = np.asarray(y["vis_ids"], dtype=object)
    check(list(dump) == y["txt_ids"] and all(
        len(d["rank_list"]) == IBENCH_TOPK for d in dump.values()),
        f"[ibench] t2v.pkl is not {len(y['txt_ids'])} rows of {IBENCH_TOPK}")
    err, moved = 0.0, 0
    for q, tid in enumerate(y["txt_ids"]):
        d = dump[tid]
        v_s = np.asarray(d["sim_value"], np.float64)
        v_y = y["top_vals"][q].astype(np.float64)
        err = max(err, float(np.abs(v_s - v_y).max()))
        bad = np.nonzero(np.asarray(d["rank_list"], dtype=object) != vis_arr[y["top_idx"][q]])[0]
        moved += len(bad)
        check(all(near_tie(v_s, i, AVS_STREAM_TOL) and near_tie(v_y, i, AVS_STREAM_TOL)
                  for i in bad), f"[ibench] {tid}: the streamed top-{IBENCH_TOPK} differs from "
              f"the yardstick's away from near ties")
    check(err <= AVS_STREAM_TOL, f"[ibench] streamed vs yardstick top-k scores: {err}")
    return err, moved


def kernel_branch_check(torch, K, y, smi):
    """9(c): streaming_benchmark_eval called directly with the video tower's
    outputs cast to bf16 and bf16 text, rank_path 'kernel': the gallery
    cached in bf16 and pass 2 one sim_rank_tiled launch over it, its ranks
    against the plain version on the same bf16 rows, and the tiled kernel
    timed at this shape against its bound and cuBLAS bf16 plus counting."""
    import types

    from laff_tpu_torch.engine.evaluator import Embedder, streaming_benchmark_eval
    from laff_tpu_torch.eval.metrics import ranks_from_scores
    from laff_tpu_torch.ops import flatten_heads

    model = y["embedder"].model
    bf16_tower = types.SimpleNamespace(
        spec=model.spec, encode_vis=lambda data: model.encode_vis(data).to(torch.bfloat16))
    embedder = Embedder(bf16_tower, torch.device("cuda"))
    txt16 = y["txt"].to(torch.bfloat16)
    K.reset_launches()
    t0 = time.perf_counter()
    res = streaming_benchmark_eval(embedder, txt16, y["txt_ids"], y["vis_feed"], topk=0,
                                   rank_path="kernel")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    check_launches("ibench kernel branch", launches, GALLERY_BLOCKS, tiled=1)
    tn, vn, gt = flatten_heads(txt16), y["vis16"], y["gt"]
    ranks = torch.as_tensor(res["t2v_ranks"], device="cuda")
    plain = K.fused_sim_rank_plain(tn, vn, gt, prenormalized=True)
    ok, max_err = rank_moves_explained(torch, ranks, plain, tn, vn, gt, SCORE_TIE_TOL)
    check(ok, "[ibench] the kernel branch's ranks differ from the plain version beyond near ties")
    equal = float((ranks == plain).float().mean())

    t, v, hd = tn.shape[0], vn.shape[0], tn.shape[1]

    def library():  # cuBLAS bf16 product + torch counting, in row blocks
        return torch.cat([ranks_from_scores((tn[s:s + 2048] @ vn.T).float(), gt[s:s + 2048])
                          for s in range(0, t, 2048)])

    ms = time_ms(torch, lambda: K.fused_sim_rank(tn, vn, gt, prenormalized=True), reps=5)
    # one call in a profiler session of its own; where this process's profiler
    # records nothing (as after phase 8's profiled pass), the same call on
    # seeded rows of this shape in a fresh process
    device = device_ms(torch, lambda: K.fused_sim_rank(tn, vn, gt, prenormalized=True), reps=1)
    device_from = "this call"
    if not any("sim_rank_kernel" in k for k in device):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--tiled-worker",
                               str(t), str(v), str(hd)], capture_output=True, text=True,
                              timeout=600)
        found = [ln for ln in proc.stdout.splitlines() if ln.startswith("tiled_device ")]
        check(proc.returncode == 0 and found, f"[ibench] the tiled kernel's device-time worker "
              f"failed: {proc.stderr[-2000:]}")
        device = json.loads(found[-1][len("tiled_device "):])
        device_from = "the same shape on seeded unit rows in a fresh process"
    launch_ms = sum(v_ms for k, v_ms in device.items() if "sim_rank_kernel" in k)
    plain_ms = time_ms(torch, lambda: K.fused_sim_rank_plain(tn, vn, gt, prenormalized=True),
                       reps=1)
    library_ms = time_ms(torch, library, reps=3)
    b_ms, b_by = bound_ms((t + v) * hd * 2 + 2 * t * 4, 2.0 * t * v * hd, PEAK_BF16_OPS_S)
    top = sorted(device.items(), key=lambda kv: -kv[1])[:4]
    log("  [ibench] (c) device ms per call: "
        + ("; ".join(f"{k[:60]} {v_ms:.3f}" for k, v_ms in top) or "none recorded"))
    row = {"shape": [t, v, hd], "max_abs_err": max_err, "rows_equal": equal, "ms": ms,
           "device_ms": launch_ms or None, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by,
           "library_ms": library_ms, "stream_wall_s": wall, "device_ms_from": device_from,
           "cache_bytes": v * hd * vn.element_size()}
    log(f"  [ibench] (c) the kernel branch: streaming_benchmark_eval on bf16 text and a bf16 "
        f"cache of {row['cache_bytes'] / 1e9:.2f} GB, rank_path 'kernel', {wall:.1f} s; "
        f"launches {launches}; ranks equal to the plain version on {equal:.6f} of the rows, "
        f"max |rank diff| {max_err} (near ties within {SCORE_TIE_TOL}); sim_rank_tiled at "
        f"T={t} V={v} HD={hd}: {ms:.3f} ms ("
        + (f"{launch_ms:.3f} ms of device time, {device_from}" if launch_ms
           else "device time not measured")
        + "), plain "
        f"{plain_ms:.1f} ms, cuBLAS bf16 + counting {library_ms:.3f} ms, bound {b_ms:.3f} ms "
        f"({b_by}) [{smi}]")
    return launches, row


def large_gallery_phase(torch, K, P, root, ckpt, exact_infap, smi):
    """9. The large benchmark gallery and the int8 gallery over iacc.3's
    335,944 shots, under phase 4's trained checkpoint. (a) ibench, 10,000
    captions (20 for each of 500 shots spread over the gallery, the rest
    distractors) through predictor.main: the streamed benchmark branch with
    the gallery cached in f32 (the gate 10 + 329 times, no rank kernel, no
    score_matrix call), held against the gallery embedded whole (t2v ranks,
    v2t ranks and the top 2,000, equal but at near ties); (c) the kernel
    branch (kernel_branch_check); (d) predictor.main with --int8_gallery 1
    on tv16.avs.txt against phase 8's exact streamed run: topic overlap,
    scores and infAP. (b), the same uncached, is cut for the script's time
    (tests/test_torch_port_large_gallery.py holds it to (a) on the CPU).
    Returns the launches by path and (c)'s row."""
    import pickle

    import numpy as np

    from laff_tpu_torch.cli import avs_eval
    from laff_tpu_torch.engine.evaluator import STREAM_BUDGET_ENV

    check(STREAM_BUDGET_ENV not in os.environ, f"{STREAM_BUDGET_ENV} is set")
    qs = f"{IBENCH}.caption.txt"
    timing = {"card": smi}

    def options(sim_name, **kw):
        return P.PredictOptions(
            testCollection=IBENCH, model_path=ckpt, sim_name=sim_name, rootpath=root,
            query_sets=qs, batch_size=AVS_BATCH, overwrite=1, device="cuda",
            predict_result_file=os.path.join(root, "result_log", f"{sim_name}.txt"), **kw)

    def dump_path(sim_name, coll=IBENCH, query_set=qs):
        return os.path.join(root, coll, "SimilarityIndex", query_set, sim_name, "t2v.pkl")

    # (a) cached in f32
    opt = options("smoke_ibench")
    torch.cuda.reset_peak_memory_stats()
    res, launches_a, wall, calls = counted_predict(torch, K, P, opt)
    res = res[qs]
    peak = torch.cuda.max_memory_allocated()
    cache_bytes = AVS_SHOTS * 8 * 512 * 4
    check_launches("ibench", launches_a, IBENCH_TXT_BATCHES + GALLERY_BLOCKS)
    check(calls == {"score_matrix": 0, "score_matrix_streaming": 0},
          f"[ibench] the streamed benchmark called {calls}")
    check(peak >= cache_bytes, f"[ibench] peak device memory {peak} below the f32 cache")
    secs = res["seconds"]
    check({"embed_txt", "pass1", "pass2", "rank_dump"} <= set(secs), f"[ibench] phases {secs}")
    for side in ("TextToVideo", "VideoToText"):
        path = os.path.join(root, "result_log", side, "smoke_ibench.txt")
        check(os.path.exists(path) and open(path).read().count("\n") == 1,
              f"[ibench] no {side} row in {path}")
    timing["cached"] = {"wall_s": wall, **secs, "videos_per_s_pass1": AVS_SHOTS / secs["pass1"],
                        "peak_bytes": peak, "cache_bytes": cache_bytes}
    log(f"  [ibench] (a) {IBENCH_SHOTS * IBENCH_CAPS} captions x {AVS_SHOTS} shots streamed, "
        f"the gallery cached in f32 ({cache_bytes / 1e9:.2f} GB; peak {peak / 1e9:.2f} GB): "
        f"{wall:.1f} s wall (" + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items())
        + f"); pass 1 {AVS_SHOTS / secs['pass1']:.0f} gallery videos/s; launches "
        f"{launches_a}; t2v r1 {res['t2v'][0]:.2f} mir {res['t2v'][5]:.4f}, v2t r1 "
        f"{res['v2t'][0]:.2f} mAP {res['v2t'][6]:.4f} [{smi}]")

    t0 = time.perf_counter()
    y = ibench_yardstick(torch, P, opt, ckpt)
    stream_ranks = torch.as_tensor(res["t2v_ranks"], device="cuda")
    ok, t2v_err = rank_moves_explained(torch, stream_ranks, y["ranks"], y["tn"], y["vn"], y["gt"],
                                       SCORE_TIE_TOL)
    check(ok, "[ibench] streamed t2v ranks differ from the yardstick's beyond near ties")
    t2v_moved = int((stream_ranks != y["ranks"]).sum())
    v2t_moved = v2t_against_yardstick(torch, y, res["v2t_ranks"])
    with open(dump_path("smoke_ibench"), "rb") as fh:
        top_err, top_moved = topk_against_yardstick(y, pickle.load(fh))
    timing["yardstick_s"] = time.perf_counter() - t0
    log(f"  [ibench] against the gallery embedded whole: t2v ranks differ on {t2v_moved} of "
        f"{len(y['txt_ids'])} captions (at most {t2v_err} places, near ties within "
        f"{SCORE_TIE_TOL}); v2t lists differ on {v2t_moved} of {IBENCH_SHOTS} shots (near "
        f"ties); top-{IBENCH_TOPK} scores within {top_err:.3g}, {top_moved} of "
        f"{len(y['txt_ids']) * IBENCH_TOPK} places differ, all at near ties; "
        f"{timing['yardstick_s']:.1f} s")

    # (c) the kernel branch, then the yardstick goes
    launches_c, row = kernel_branch_check(torch, K, y, smi)
    timing["kernel_branch"] = row
    del y

    # (d) the int8 gallery on tv16, against phase 8's exact streamed run
    query_set = f"{AVS_EDITIONS[0]}.avs.txt"
    opt8 = P.PredictOptions(testCollection=AVS_COLLECTION, model_path=ckpt,
                            sim_name="smoke_avs_int8", rootpath=root, query_sets=query_set,
                            batch_size=AVS_BATCH, overwrite=1, device="cuda", int8_gallery=1)
    res_d, launches_d, wall_d, calls_d = counted_predict(torch, K, P, opt8)
    res_d = res_d[query_set]
    union, int8_bytes = res_d["int8"]["union"], res_d["int8"]["int8_bytes"]
    check_launches("avs int8", launches_d, 1 + GALLERY_BLOCKS + -(-union // AVS_BATCH))
    check(calls_d == calls, f"[avs int8] called {calls_d}")
    sdir = os.path.join(root, AVS_COLLECTION, "SimilarityIndex", query_set)
    got = read_score_file(os.path.join(sdir, "smoke_avs_int8", "id.sent.score.txt"))
    exact = read_score_file(os.path.join(sdir, "smoke_avs", "id.sent.score.txt"))
    check(list(got) == list(exact) and len(got) == AVS_TOPICS and all(
        len(ids) == 2000 and len(set(ids)) == 2000 and (np.diff(v) <= 0).all()
        and np.isfinite(v).all() for ids, v in got.values()),
        "[avs int8] the score file is not 30 lines of 2,000 descending distinct pairs")
    overlap, err = 1.0, 0.0
    for t, (ids, vals) in got.items():
        e_ids, e_vals = exact[t]
        shared = set(ids) & set(e_ids)
        overlap = min(overlap, len(shared) / 2000)
        where = {v: i for i, v in enumerate(e_ids)}
        for i, v in enumerate(ids):
            if v in where:
                err = max(err, abs(vals[i] - e_vals[where[v]]))
    check(overlap >= INT8_OVERLAP, f"[avs int8] a topic's top-2,000 overlap {overlap}")
    check(err <= AVS_STREAM_TOL, f"[avs int8] shared ids' scores differ by {err}")
    infap = avs_infap(avs_eval, root, AVS_EDITIONS[0], "smoke_avs_int8")
    check(abs(infap - exact_infap) <= INT8_INFAP_TOL,
          f"[avs int8] infAP {infap} against the exact run's {exact_infap}")
    timing["int8"] = {"wall_s": wall_d, **res_d["seconds"], "union": union,
                      "int8_bytes": int8_bytes, "min_overlap": overlap, "max_score_diff": err,
                      "infap": infap, "exact_infap": exact_infap}
    log(f"  [avs int8] {query_set} with --int8_gallery 1: {wall_d:.1f} s wall ("
        + ", ".join(f"{k} {v:.2f} s" for k, v in res_d["seconds"].items())
        + f"); the int8 gallery {int8_bytes / 1e9:.3f} GB on the card, {union} videos "
        f"embedded again; launches {launches_d}; against the exact streamed run: top-2,000 "
        f"overlap at least {overlap:.4f}, shared scores within {err:.3g}, infAP {infap:.4f} vs "
        f"{exact_infap:.4f} [{smi}]")
    log("large_gallery_timing " + json.dumps(timing))
    by_path = {"ibench_predict": launches_a, "ibench_kernel_stream": launches_c,
               "avs_int8_predict": launches_d}
    return by_path, row


# ---------------------------------------------------------------------------
# phase 10: the StrongCLIP text tower in FrameLAFF's predictor
# ---------------------------------------------------------------------------

STRONG_CONFIG = "FrameLaff_NoFrameFc_StrongCLIP_adjust"
CLIP_CHECK_CAPTIONS = 256
TOKENIZE_SAMPLE = 4096
# the CLIP tower on the card vs the same tower on the CPU: f32 on both (TF32
# off), sums in other orders; relative to the largest output
CLIP_TOWER_TOL = 1e-4


def clip_flops(width, layers, tokens, embed_dim, patch_in=0):
    """Operations (2 per multiply-add) of one sequence through a CLIP tower:
    each block's QKV, output and MLP products over every token and its two
    attention products, the patch embedding (``patch_in`` inputs a patch,
    ViT), and the pooled row's projection."""
    per_layer = 2 * tokens * 12 * width * width + 4 * tokens * tokens * width
    patches = 2 * (tokens - 1) * patch_in * width if patch_in else 0
    return layers * per_layer + patches + 2 * width * embed_dim


def strongclip_phase(torch, K, P, root, frames, smi):
    """10. The StrongCLIP text-tower swap (the LAFF-ml headline predictor):
    phase 5's trained FrameLAFF checkpoint under the config name
    FrameLaff_NoFrameFc_StrongCLIP_adjust, and a seeded ViT-B/32-shaped text
    tower in the reference's layout ({'model': {'clip_model.<OpenAI key>'}})
    at rval/TextData/<CLIP dir_name>/model_best.pth.tar. predictor.main on
    rval (rank_path 'kernel'): the tower swapped in once and its rows every
    query's 'clip' rows, the launches of phase 5's pass, the kernel ranks
    against the plain version on the re-embedded operands, the tower on the
    card against the CPU for 256 captions, the TF32 flags as found, and
    embed_txt with the tower's share. Returns the pass's launches."""
    import copy

    from laff_tpu_torch.data import TextSource
    from laff_tpu_torch.engine.checkpoint import save_checkpoint
    from laff_tpu_torch.models.clip import ClipTextConfig, ClipTextTower, tokenize

    payload = torch.load(frames["ckpt"], map_location="cpu", weights_only=True)
    strong = os.path.join(WORK, "strongclip_model.pt")
    save_checkpoint(dict(payload, opt={**payload["opt"], "config_name": STRONG_CONFIG}), strong)
    cfg = ClipTextConfig()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED + 10)
        tower = ClipTextTower(cfg)
    n_params = sum(p.numel() for p in tower.parameters())
    dir_name = payload["config"]["text_encoding"]["CLIP_encoding"]["dir_name"]
    path = os.path.join(root, RVAL[0], "TextData", dir_name, "model_best.pth.tar")
    torch.save({"model": {f"clip_model.{k}": v for k, v in tower.state_dict().items()}}, path)
    log(f"[strongclip] {STRONG_CONFIG} on phase 5's weights; text tower {cfg}: {n_params} "
        f"parameters, {os.path.getsize(path) / 1e6:.1f} MB at {path}")

    made, real = [], P.strongclip_text_featurizer

    def featurizer(*args, **kw):
        made.append(real(*args, **kw))
        return made[-1]

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    P.strongclip_text_featurizer = featurizer
    try:
        res, launches = run_predictor(torch, K, P, root, RVAL[0], strong, "kernel")
    finally:
        P.strongclip_text_featurizer = real
    check((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == flags,
          f"[strongclip] the pass changed the TF32 flags {flags}")
    batch = P.PredictOptions.batch_size
    n_caps = len(res["t2v_ranks"])
    padded = -(-n_caps // batch) * batch
    check(len(made) == 1 and made[0].rows == padded and made[0].tower.config == cfg,
          f"[strongclip] the live tower was not swapped in once for every clip row: "
          f"{[(m.rows, m.tower.config) for m in made]}, {padded} rows expected")
    check(launches == frames["launches"],
          f"[strongclip] launches {launches}, phase 5's pass {frames['launches']}")
    reembed_and_check(torch, K, P, root, RVAL[0], strong, res)

    gpu_tower = made[0].tower
    tsrc = TextSource(os.path.join(root, RVAL[0], "TextData", f"{RVAL[0]}.caption.txt"))
    ids = torch.from_numpy(tokenize(tsrc.captions_for(tsrc.cap_ids[:CLIP_CHECK_CAPTIONS])))
    with torch.no_grad():
        card = gpu_tower(ids.cuda()).cpu()
        cpu = copy.deepcopy(gpu_tower).cpu()(ids)
    err, scale = float((card - cpu).abs().max()), float(cpu.abs().max())
    check(err <= CLIP_TOWER_TOL * scale, f"[strongclip] tower card vs CPU: max abs err {err} "
          f"(largest value {scale})")

    # the tower's share of embed_txt: its CUDA-event time a batch of the pass
    # times the batches, and the host's tokenization (warm BPE cache) of the
    # first TOKENIZE_SAMPLE captions, scaled to the pass
    sample = tsrc.captions_for(tsrc.cap_ids[:TOKENIZE_SAMPLE])
    t0 = time.perf_counter()
    sample_ids = torch.from_numpy(tokenize(sample)).cuda()
    tokenize_s = (time.perf_counter() - t0) * n_caps / TOKENIZE_SAMPLE
    with torch.no_grad():
        call_ms = time_ms(torch, lambda: gpu_tower(sample_ids[:batch]), reps=5)
    tower_ms = call_ms * padded // batch
    flops = clip_flops(cfg.width, cfg.layers, cfg.context_length, cfg.embed_dim)
    b_ms, b_by = bound_ms(n_params * 4 + batch * cfg.context_length * 4 + batch * 512 * 4,
                          batch * flops, PEAK_F32_OPS_S)
    row = {"embed_txt_s": res["seconds"]["embed_txt"],
           "phase5_embed_txt_s": frames["seconds"]["embed_txt"],
           "tower_pass_ms": tower_ms, "tokenize_s": tokenize_s, "batches": padded // batch,
           "tower_call_ms": call_ms, "tower_call_bound_ms": b_ms, "bound_by": b_by,
           "pass_bound_s": padded // batch * b_ms / 1e3, "gflop_per_caption": flops / 1e9,
           "card_vs_cpu_max_abs_err": err, "largest": scale, "seconds": res["seconds"],
           "smi": smi}
    log(f"  [strongclip] {padded} clip rows from the live tower ({len(made)} swap); launches "
        f"{launches} = phase 5's; tower card vs CPU ({CLIP_CHECK_CAPTIONS} captions): max abs "
        f"err {err:.3g} of {scale:.3g}; embed_txt {row['embed_txt_s']:.2f} s (phase 5, "
        f"precomputed rows: {row['phase5_embed_txt_s']:.2f} s), the tower "
        f"{tower_ms / 1e3:.2f} s of CUDA-event time over {padded // batch} batches of {batch} "
        f"({call_ms:.2f} ms a call, bound {b_ms:.2f} ms, {b_by}: {b_ms / call_ms:.0%}), "
        f"tokenization {tokenize_s:.2f} s on the host (from {TOKENIZE_SAMPLE} captions) "
        f"[{smi}]")
    log("[strongclip] strongclip_timing " + json.dumps(row))
    os.remove(path)
    return launches


# ---------------------------------------------------------------------------
# phase 11: End2EndClip on raw frames
# ---------------------------------------------------------------------------

# e2etrain: 128 videos (from 256), 8 steps of B 32 an epoch; a cut of
# depth that keeps the script inside its limit on the slower hosts
E2E_WORLDS = (("e2etrain", 128, 2, SEED + 20), ("e2eval", 64, 2, SEED + 21))
E2E_FRAMES, E2E_FRAME_HW = 12, (240, 320)
E2E_BATCH = 32
E2E_WORDS = ("red", "green", "blue", "dark", "light", "grey", "bright", "pale")
# one step on the card vs the CPU from the same weights and batch (f32 towers,
# TF32 off): the loss relative, the parameters relative to the largest one
E2E_STEP_TOL = 1e-4
E2E_CPU_VIDEOS = 8  # the first videos of the batch in the card-vs-CPU step


def build_frame_world(root, coll, n_videos, caps, seed):
    """A raw-frame collection written with Pillow: each video's frames a
    colour field with a drifting gradient and noise (JPEG, 240 x 320), its
    captions naming the colour; id.imagepath.txt, the caption file and the
    video set."""
    import numpy as np
    from PIL import Image

    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(seed)
    h, w = E2E_FRAME_HW
    img_dir = os.path.join(root, coll, "frames")
    os.makedirs(img_dir, exist_ok=True)
    ramp = np.linspace(0, 2 * np.pi, w, dtype=np.float32)
    colors = rng.integers(0, 256, (n_videos, 3))

    def write_video(i):  # Pillow's encoder releases the GIL
        vrng = np.random.default_rng([seed, i])
        for f in range(E2E_FRAMES):
            field = colors[i] + 40 * np.sin(ramp + f / 2)[None, :, None]
            noise = vrng.integers(0, 16, (h, w, 3))
            arr = np.clip(field + noise, 0, 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(img_dir, f"{coll}_v{i}_{f}.jpg"), quality=90)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write_video, range(n_videos)))
    id_lines, cap_lines, vids = [], [], []
    for i, color in enumerate(colors):
        vid = f"{coll}_v{i}"
        vids.append(vid)
        id_lines += [f"{vid}_{f} {os.path.join(img_dir, f'{vid}_{f}.jpg')}"
                     for f in range(E2E_FRAMES)]
        words = " ".join(E2E_WORDS[c * len(E2E_WORDS) // 256] for c in color[:2])
        cap_lines += [f"{vid}#{c} a {words} video clip {c}" for c in range(caps)]
    for rel, lines in (("id.imagepath.txt", id_lines),
                       (f"TextData/{coll}.caption.txt", cap_lines),
                       (f"VideoSets/{coll}.txt", vids)):
        os.makedirs(os.path.dirname(os.path.join(root, coll, rel)), exist_ok=True)
        with open(os.path.join(root, coll, rel), "w") as fh:
            fh.write("\n".join(lines) + "\n")


def end2end_phase(torch, K, root, smi):
    """11. End2EndClip (configs/end2end_clip.py: ViT-B/32 vision at 224 px
    and the ViT-B/32 text tower, 8 frames a video, lr/20) on a raw-frame
    world written with Pillow (e2etrain 128 videos x 2 captions, e2eval 64
    x 2, 12 JPEG frames of 240 x 320 a video) at B 32: (a) one step on the
    card against the CPU from the same weights on the first batch's first
    E2E_CPU_VIDEOS videos, the step at B 32 timed;
    (b) two epochs of engine.end2end.main through cli.do_trainer with
    rank_path 'kernel': finite losses, one sim_rank_wide launch and no gate
    launch a validation, model_best.pth.tar written, peak device bytes; (c)
    a validation with --stage_val_features 0 equal to the staged run's last.
    Returns the run's launches."""
    import copy
    import dataclasses

    from laff_tpu_torch.cli import do_trainer
    from laff_tpu_torch.engine import end2end as E
    from laff_tpu_torch.engine.prepare import load_config

    t0 = time.perf_counter()
    for coll, n_videos, caps, seed in E2E_WORLDS:
        build_frame_world(root, coll, n_videos, caps, seed)
    log(f"[e2e] raw-frame worlds {[w[:3] for w in E2E_WORLDS]}, {E2E_FRAMES} JPEG frames of "
        f"{E2E_FRAME_HW} a video, in {time.perf_counter() - t0:.1f} s")
    argv = ["e2etrain", "e2eval", "--rootpath", root, "--val_set", "no", "--config_name",
            "end2end_clip", "--num_epochs", "2", "--batch_size", str(E2E_BATCH), "--rank_path",
            "kernel", "--random_seed", str(SEED), "--model_prefix", "smoke_e2e", "--overwrite",
            "1"]
    opt = do_trainer.parse_args(argv)
    config = load_config(opt.config_name)

    # (a) one step on the card against the CPU, from the same weights and videos
    feed = E.train_feed(opt, config)
    t0 = time.perf_counter()
    batch = next(iter(feed.epoch(0)))
    decode_s = time.perf_counter() - t0
    cpu_model = E.build_model(config, SEED)
    n_params = sum(p.numel() for p in cpu_model.parameters())
    gpu_model = copy.deepcopy(cpu_model).cuda()
    steps = {dev: E.End2EndStep(m, E.make_optimizer(config, m), config)
             for dev, m in (("cuda", gpu_model), ("cpu", cpu_model))}

    def on(dev, rows=None):
        return [{k: torch.from_numpy(v[:rows]).to(dev) for k, v in batch[side].items()}
                for side in ("txt", "vis")]

    t0 = time.perf_counter()
    loss_cpu = float(steps["cpu"](*on("cpu", E2E_CPU_VIDEOS)))
    cpu_s = time.perf_counter() - t0
    loss_gpu = float(steps["cuda"](*on("cuda", E2E_CPU_VIDEOS)))
    sd_c, sd_g = cpu_model.state_dict(), gpu_model.state_dict()
    p_err = max(float((sd_g[k].cpu() - v).abs().max()) for k, v in sd_c.items())
    p_scale = max(float(v.abs().max()) for v in sd_c.values())
    check(abs(loss_gpu - loss_cpu) <= E2E_STEP_TOL * abs(loss_cpu) and p_err <= E2E_STEP_TOL
          * p_scale, f"[e2e] step card vs CPU: loss {loss_gpu} vs {loss_cpu}, parameters max "
          f"abs err {p_err} (largest {p_scale})")
    txt_d, vis_d = on("cuda")
    step_ms = time_ms(torch, lambda: steps["cuda"](txt_d, vis_d), reps=5)
    text_cfg, vision_cfg = E.tower_configs(config)
    images = E2E_BATCH * config.sample_frame
    tokens = (vision_cfg.image_size // vision_cfg.patch_size) ** 2 + 1
    step_flops = 3 * (images * clip_flops(vision_cfg.width, vision_cfg.layers, tokens,
                                          vision_cfg.embed_dim, 3 * vision_cfg.patch_size ** 2)
                      + E2E_BATCH * clip_flops(text_cfg.width, text_cfg.layers,
                                               text_cfg.context_length, text_cfg.embed_dim))
    # bytes: the f32 parameters read twice (forward, backward), the gradient
    # written, and the optimizer's reads and writes of parameters and moments
    b_ms, b_by = bound_ms(n_params * 4 * 10, step_flops, PEAK_F32_OPS_S)
    del cpu_model, gpu_model, steps, txt_d, vis_d
    log(f"  [e2e] (a) {n_params} parameters; one step on the batch's first {E2E_CPU_VIDEOS} "
        f"videos x {config.sample_frame} frames, card vs CPU: loss {loss_gpu:.6f} vs {loss_cpu:.6f}, parameters max abs err "
        f"{p_err:.3g} of {p_scale:.3g} ({cpu_s:.1f} s on the CPU); the step at B {E2E_BATCH} "
        f"{step_ms:.1f} ms on the card (bound {b_ms:.1f} ms, {b_by}: {b_ms / step_ms:.0%}); the host "
        f"decoded the first batch's {images} frames in {decode_s:.2f} s [{smi}]")

    # (b) two epochs of engine.end2end.main through the CLI
    captured, real_main = {}, E.main

    def main_capturing(o):
        captured["res"] = real_main(o)
        return captured["res"]

    E.main = main_capturing
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    try:
        rc = do_trainer.main(argv)
    finally:
        E.main = real_main
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    res = captured["res"]
    hist = res["history"]
    check(rc == 0 and len(hist) == 2 and all(h["loss"] == h["loss"] and abs(h["loss"]) < 1e6
                                             for h in hist),
          f"[e2e] do_trainer gave {rc}, history {hist}")
    check(launches == {"sim_rank_wide": 2, "sim_rank_tiled": 0, "gate_attention": 0,
                       "gate_attention_simple": 0},
          f"[e2e] two validations launched {launches}, not one wide rank each and no gate")
    best = os.path.join(res["model_path"], "model_best.pth.tar")
    check(os.path.exists(best) and res["parameters"] == n_params,
          f"[e2e] no {best}, or {res['parameters']} parameters")

    # (c) a validation with --stage_val_features 0 against the staged run's last
    txt_feed, vis_feed = E.validation_feeds(dataclasses.replace(opt, stage_val_features=0),
                                            config)
    K.reset_launches()
    t0 = time.perf_counter()
    metrics = E.validate(res["model"], txt_feed, vis_feed, torch.device("cuda"),
                         rank_path="kernel")
    unstaged_s = time.perf_counter() - t0
    check(metrics == {k: hist[-1][k] for k in metrics} and K.LAUNCHES["sim_rank_wide"] == 1,
          f"[e2e] the unstaged validation {metrics} differs from the staged {hist[-1]}")
    row = {"parameters": n_params, "step_ms": step_ms, "step_bound_ms": b_ms, "bound_by": b_by,
           "step_tflop": step_flops / 1e12, "first_batch_decode_s": decode_s,
           "cpu_step_s": cpu_s, "main_wall_s": wall, "peak_device_bytes": peak,
           "unstaged_validation_s": unstaged_s,
           "epochs": [{k: h[k] for k in ("loss", "steps", "train_seconds", "feed_wait_seconds",
                                         "val_seconds", "r1", "mir")} for h in hist],
           "smi": smi}
    log(f"  [e2e] (b) two epochs through do_trainer in {wall:.1f} s: losses "
        f"{[round(h['loss'], 4) for h in hist]}, r1 {[h['r1'] for h in hist]}, steps "
        f"{[h['steps'] for h in hist]}, train {[h['train_seconds'] for h in hist]} s of which "
        f"waiting on the frame decode {[h['feed_wait_seconds'] for h in hist]} s, validation "
        f"{[h['val_seconds'] for h in hist]} s; launches {launches}; peak device "
        f"{peak / 1e9:.2f} GB; (c) the unstaged validation equals the staged one "
        f"({unstaged_s:.1f} s) [{smi}]")
    log("[e2e] end2end_timing " + json.dumps(row))
    del res, captured
    return launches


# ---------------------------------------------------------------------------
# phase 12: the in-graph BERT text tower
# ---------------------------------------------------------------------------

BERT_CONFIG = "bert_rehearsal"
# the world of phase 12, cut in depth from rtrain -> rtest: 10,000 training
# captions, 78 steps of 128 an epoch; bval at 10 captions a video (5,000:
# each validation and the prediction pass run BERT over all of them)
BERT_WORLDS = (("btrain", 500, 20, SEED + 12), ("bval", 500, 10, SEED + 13))
BERT_VAL_GATE_CALLS = 5 + 1  # 5,000 captions and 500 videos in batches of 1,024
BERT_CHECK_CAPTIONS = 64
# BERT on the card vs the CPU: f32 on both (TF32 off), sums in other orders;
# relative to the largest value
BERT_TOL = 1e-4
BERT_STEP_ROWS = 8  # pairs of the card-vs-CPU step
# the scaled update vs the unscaled one of a second step from the same state:
# the same operations but for the run's own reduction orders
BERT_SCALE_RTOL = 1e-3


def bert_flops(cfg, tokens):
    """Multiply-adds x 2 of one BERT forward over ``tokens`` tokens in
    sequences of ``length``: the layers' products and the attention's."""
    tokens, length = tokens
    w, inter = cfg.hidden_size, cfg.intermediate_size
    per_layer = tokens * (2 * 4 * w * w + 2 * 2 * w * inter + 2 * 2 * length * w)
    return cfg.num_hidden_layers * per_layer + tokens // length * 2 * w * w


def write_bert_checkout(torch, path, words):
    """A seeded BERT-base checkout in Hugging Face's layout: config.json,
    vocab.txt (the special tokens, the world's words, then fillers up to
    the vocabulary size) and model.safetensors (written here: the header
    length, the JSON header, the little-endian f32 buffers). Returns the
    written state dict."""
    import dataclasses
    import struct

    from laff_tpu_torch.models.bert import SPECIAL_TOKENS, BertConfig, BertModel

    cfg = BertConfig()
    model = BertModel(cfg)
    model.reset_parameters(torch.Generator().manual_seed(SEED + 12))
    vocab = list(SPECIAL_TOKENS) + list(words)
    vocab += [f"[unused{i}]" for i in range(cfg.vocab_size - len(vocab))]
    check(len(vocab) == cfg.vocab_size == len(set(vocab)), "[bert] the checkout's vocabulary")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump({**dataclasses.asdict(cfg), "model_type": "bert",
                   "architectures": ["BertModel"], "pad_token_id": 0}, fh)
    with open(os.path.join(path, "vocab.txt"), "w") as fh:
        fh.write("\n".join(vocab) + "\n")
    sd = {k: v.contiguous() for k, v in model.state_dict().items()}
    header, offset = {}, 0
    for name, t in sd.items():
        n = t.numel() * 4
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(os.path.join(path, "model.safetensors"), "wb") as fh:
        fh.write(struct.pack("<Q", len(head)) + head)
        for t in sd.values():
            fh.write(t.numpy().astype("<f4").tobytes())
    return sd


def backbone_scale_check(torch, T, prepared, state_dict):
    """One step on the card from ``state_dict`` with the chain's lr/20 run
    over the BERT tower, and the same step again from the same state with
    the run off: the BERT parameters move by 1/20 of the unscaled update,
    the others by the same update. Returns the largest relative error."""
    device = torch.device("cuda")
    step = new_step(T, prepared.config, prepared.spec, state_dict, device)
    opt = step.optimizer
    names = [k for k, _ in step.model.named_parameters()]
    sizes = [p.numel() for p in opt.params]
    first = names.index(next(k for k in names if k.startswith("txt_net.bert.")))
    n_bert = sum(p.numel() for k, p in step.model.named_parameters()
                 if k.startswith("txt_net.bert."))
    start = sum(sizes[:first])
    check(opt.scaled_segments == [(start, start + n_bert)] and opt.scale == 1 / 20,
          f"[bert] the chain scales {opt.scaled_segments} by {opt.scale}, not the "
          f"{n_bert} BERT parameters at {start} by 1/20")
    txt, vis = device_batches(T, prepared.train_feed, device, 1)[0]
    state = [*step.model.parameters(), *step.model.buffers(), opt.count, opt.nu, opt.mu]
    saved = [t.detach().clone() for t in state]
    gen = torch.Generator(device=device)
    step(txt, vis, gen.manual_seed(SEED))
    scaled = opt._update.clone()
    with torch.no_grad():
        for t, v in zip(state, saved):
            t.copy_(v)
    segments, opt.scaled_segments = opt.scaled_segments, []
    step(txt, vis, gen.manual_seed(SEED))
    opt.scaled_segments = segments
    unscaled = opt._update
    bert = slice(start, start + n_bert)
    err_b = float((scaled[bert] - unscaled[bert] / 20).abs().max() / unscaled[bert].abs().max()
                  * 20)
    rest = torch.cat([scaled[:start], scaled[start + n_bert:]])
    rest_u = torch.cat([unscaled[:start], unscaled[start + n_bert:]])
    err_r = float((rest - rest_u).abs().max() / rest_u.abs().max())
    ratio = float(scaled[bert].abs().sum() / unscaled[bert].abs().sum())
    check(max(err_b, err_r) <= BERT_SCALE_RTOL and abs(ratio - 1 / 20) <= 1e-6,
          f"[bert] one step's BERT update is {ratio} of the unscaled one (errors {err_b}, "
          f"{err_r})")
    del step, saved, scaled
    return ratio, max(err_b, err_r)


def bert_phase(torch, K, P, root, smi):
    """12. configs/bert_rehearsal.py (rehearsal's towers with the precomputed
    CLIP text rows replaced by an in-graph BERT-base tower, 64 tokens, lr/20)
    on btrain -> bval (500 videos x 20 and x 10 captions): (a) a seeded BERT-base
    checkout written under build/ and imported (the trainer's tower starts
    from it), the pooler on the card against the CPU for 64 captions, and
    the frozen LiveBertTextFeaturizer's rows on the card against the CPU's;
    (b) one step moves BERT by 1/20 of the unscaled update; two steps card
    vs CPU on 8 pairs; (c) two epochs of trainer.main at the default dispatch
    (both caches, K 8 as a graph, staged validation; one wide rank and 11
    gate launches a validation); the step timed against its f32 bound, the
    capture and peak device bytes; (d) the trained checkpoint through
    predictor.main on bval (rank_path 'kernel'). Returns the launches of the
    training run and of the prediction pass, and the trained checkpoint's
    path."""
    from laff_tpu_torch.data.synth import build_world
    from laff_tpu_torch.engine import trainer as T
    from laff_tpu_torch.engine.checkpoint import load_checkpoint
    from laff_tpu_torch.engine.prepare import Options, prepare
    from laff_tpu_torch.models.bert import (BertModel, LiveBertTextFeaturizer, checkout_config,
                                            import_bert_params)

    t0 = time.perf_counter()
    for coll, n, caps, seed in BERT_WORLDS:
        build_world(root, coll, n, caps, 11286, seed)
    checkout = os.path.join(WORK, "bert_checkout")
    written = write_bert_checkout(torch, checkout, ["the"] + [f"w{i:05d}" for i in range(11286)])
    log(f"[bert] worlds {[w[:3] for w in BERT_WORLDS]} and a seeded BERT-base checkout "
        f"({sum(v.numel() for v in written.values())} parameters) in "
        f"{time.perf_counter() - t0:.1f} s")

    # (a) the checkout imported; the pooler and the frozen featurizer, card vs CPU
    sd = import_bert_params(checkout)
    check(set(sd) == set(written) and all(torch.equal(sd[k], written[k]) for k in sd),
          "[bert] import_bert_params does not give the written checkout")
    with open(os.path.join(root, "bval", "TextData", "bval.caption.txt")) as fh:
        caps = [line.split(" ", 1)[1] for line in fh.read().splitlines()[:BERT_CHECK_CAPTIONS]]
    frozen = {dev: LiveBertTextFeaturizer(checkout, device=dev) for dev in ("cuda", "cpu")}
    rows = {dev: f.encode_batch(caps).cpu() for dev, f in frozen.items()}
    scale = float(rows["cpu"].abs().max())
    err_f = float((rows["cuda"] - rows["cpu"]).abs().max())
    ids, mask = frozen["cpu"].tokenizer.encode(caps, 64)
    model = BertModel(checkout_config(checkout))
    model.load_state_dict(sd)
    model.cuda().eval()
    with torch.no_grad():
        pooled = model(torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda())[1].cpu()
    err_p = float((pooled - rows["cpu"]).abs().max())
    check(max(err_f, err_p) <= BERT_TOL * scale and frozen["cuda"].rows == len(caps),
          f"[bert] pooler card vs CPU max abs err {err_p}, frozen featurizer {err_f} (largest "
          f"{scale})")
    del frozen, model
    log(f"  [bert] (a) the checkout imported (every tensor equal to the written one); pooler "
        f"on the card vs the CPU for {len(caps)} captions: max abs err {err_p:.3g}, the frozen "
        f"LiveBertTextFeaturizer's rows {err_f:.3g} (largest {scale:.3g}, bound "
        f"{BERT_TOL} of it); {int(mask.sum(1).max())} tokens at most of 64")

    opt = Options(trainCollection="btrain", valCollection="bval", rootpath=root, val_set="no",
                  config_name=BERT_CONFIG, num_epochs=2, batch_size=128, device="cuda",
                  rank_path="kernel", sync_debug=1, random_seed=SEED, model_prefix="smoke_bert")
    t0 = time.perf_counter()
    os.environ["LAFF_TPU_BERT_CHECKOUT"] = checkout  # the config names the checkout
    try:
        prepared = prepare(opt)
    finally:
        del os.environ["LAFF_TPU_BERT_CHECKOUT"]
    spec = prepared.spec
    check(spec.txt.bert is not None and spec.txt.bert.name_or_path == checkout
          and spec.txt.compute_dtype == "bfloat16",
          f"[bert] the prepared spec's BERT tower {spec.txt.bert}")
    init = T.seeded_model(spec, SEED, prepared.we)
    n_params = sum(p.numel() for p in init.parameters())
    check(init.txt_net.bert.imported_from == checkout and all(
        torch.equal(v, sd[k]) for k, v in init.txt_net.bert.state_dict().items()),
        "[bert] the trainer's BERT tower did not start from the checkout")
    log(f"[bert] prepare {time.perf_counter() - t0:.1f} s; {n_params} parameters (BERT "
        f"{sum(v.numel() for v in sd.values())}); text {spec.txt.features}; "
        f"{prepared.train_feed.steps_per_epoch()} steps of 128 an epoch")

    # (b) lr/20, and card vs CPU
    ratio, scale_err = backbone_scale_check(torch, T, prepared, init.state_dict())
    log(f"  [bert] (b) one step on the card: the BERT update is {ratio:.7f} of the unscaled "
        f"one (1/20), the other parameters' equal (max rel diff {scale_err:.3g} <= "
        f"{BERT_SCALE_RTOL})")
    card_vs_cpu_step(torch, T, prepared, init.state_dict(), "bert", rows=BERT_STEP_ROWS)
    del init

    # (c) two epochs at the default dispatch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res, launches, _ = run_main(torch, K, T, opt, prepared, smi, "bert",
                                gate_calls=BERT_VAL_GATE_CALLS, val_batches=BERT_VAL_GATE_CALLS)
    peak = torch.cuda.max_memory_allocated()
    check(res["pretrained_bert"] == checkout, f"[bert] the run started from "
          f"{res['pretrained_bert']}, not the checkout")
    trained = res["model"].txt_net.bert.state_dict()
    moved = max(float((trained[k].cpu() - sd[k]).abs().max()) for k in sd)
    del res["model"]
    hist = res["history"]
    steps = hist[-1]["steps"]
    step_ms = 1e3 * hist[-1]["train_seconds"] / steps
    tokens = (opt.batch_size * 64, 64)
    flops = 3 * bert_flops(checkout_config(checkout), tokens)
    b_ms, b_by = bound_ms(n_params * 4 * 10, flops, PEAK_F32_OPS_S)
    capture = res["dispatch"]["capture_seconds"]
    log(f"  [bert] (c) a graphed step (the second epoch's {steps} steps) {step_ms:.1f} ms "
        f"against BERT's f32 bound {b_ms:.1f} ms ({b_by}: {flops / 1e12:.2f} TFLOP a step, "
        f"{b_ms / step_ms:.0%}); the graph captured in {capture:.2f} s; peak device "
        f"{peak / 1e9:.2f} GB; the trained BERT within {moved:.3g} of the checkout [{smi}]")

    # (d) the trained checkpoint predicts
    ckpt_path, out, launches_p = trained_checkpoint_prediction(
        torch, K, P, root, res, ("kernel",), "bert", gate_run=BERT_VAL_GATE_CALLS, coll="bval")
    reembed_and_check(torch, K, P, root, "bval", ckpt_path, out["kernel"])
    ck = load_checkpoint(ckpt_path)
    check(ck["spec"].txt.bert is not None and any(k.startswith("txt_net.bert.")
                                                  for k in ck["state_dict"]),
          "[bert] the checkpoint holds no BERT tower")
    row = {"parameters": n_params, "step_ms": step_ms, "step_bound_ms": b_ms, "bound_by": b_by,
           "step_tflop": flops / 1e12, "capture_s": capture, "peak_device_bytes": peak,
           "lr_ratio": ratio, "moved_from_checkout": moved,
           "epochs": [{k: h[k] for k in ("loss", "steps", "train_seconds", "val_seconds", "r1",
                                         "mir")} for h in hist],
           "predict_s": out["kernel"]["seconds"], "smi": smi}
    log("[bert] bert_timing " + json.dumps(row))
    return launches, launches_p, ckpt_path


# ---------------------------------------------------------------------------
# phase 13: the retrieval service over iacc.3
# ---------------------------------------------------------------------------

SERVE_BUCKETS = (1, 8, 64, 512)
SERVE_KS = (10, 1000)
SERVE_THREADS = 32
SERVE_INGEST = 1024
SERVE_SCORE_TOL = 1e-5  # the service's blocked scores vs one plain product: f32 sums
SERVE_INT8_OVERLAP = 0.9  # mean top-100 overlap of the int8 gallery with the bf16 one
SERVE_INT8_TIE = 1e-2  # about the int8 scores' error on unit per-head rows
SERVE_GATE_CALLS = -(-AVS_SHOTS // 512)  # the gallery embed at batch 512: 657


def plain_search(torch, svc, tn, k):
    """The service's scores on the same bf16 operands in one product and
    each row's top k by a stable sort (``evaluator.ordered_topk``)."""
    from laff_tpu_torch.engine.evaluator import ordered_topk

    n = svc._count
    scores = (tn.to(torch.bfloat16).float() @ svc._vn[:n].float().T) / svc.heads
    return ordered_topk(scores, k)


def lists_agree(vals, idx, ref_vals, ref_idx, tol):
    """Ids equal but at near ties (within ``tol`` of a neighbour), scores
    within SERVE_SCORE_TOL: (ok, places that differ, max score diff)."""
    err = float((vals - ref_vals).abs().max())
    bad = (idx != ref_idx).nonzero()
    v = ref_vals.cpu().numpy().astype("float64")
    ok = all(near_tie(v[r], c, tol) for r, c in bad.tolist())
    return ok and err <= SERVE_SCORE_TOL, len(bad), err


def serve_phase(torch, K, root, ckpt, smi):
    """13. RetrievalService on phase 12's BERT checkpoint over iacc.3's
    335,944 shots (a bf16 gallery of 2.75 GB, capacity for 1,024 more,
    snapshotted): searches at the query buckets 1, 8, 64 and 512 with k 10
    and 1,000 against the plain product on the same operands (timed, with
    the f32 product's bound and the busy share of one search); 32 threads
    through MicroBatcher against direct calls; do_server's handler on
    127.0.0.1 port 0 (/healthz, /search, /ingest of 1,024 rows, /metrics, a
    400); a restart from the snapshot, bit for bit; the int8 gallery (1.38
    GB) against the bf16 order. Returns the launches of the build, the
    searches and the ingest."""
    import threading
    import urllib.error
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np

    from laff_tpu_torch.cli import do_server
    from laff_tpu_torch.engine import service as S

    with open(os.path.join(root, IBENCH, "TextData", f"{IBENCH}.caption.txt")) as fh:
        queries = [line.split(" ", 1)[1] for line in fh.read().splitlines()[:512]]
    snapshot = os.path.join(WORK, "iacc3_gallery.npz")
    K.reset_launches()
    t0 = time.perf_counter()
    svc = S.RetrievalService(ckpt, root, AVS_COLLECTION, capacity=AVS_SHOTS + SERVE_INGEST,
                             gallery_cache=snapshot)
    build_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    check(launches["gate_attention"] == SERVE_GATE_CALLS and launches["sim_rank_wide"] == 0,
          f"[serve] the gallery build launched {launches}")
    n, width = svc._count, svc.width
    check(n == AVS_SHOTS and svc.gallery_bytes == (AVS_SHOTS + SERVE_INGEST) * width * 2,
          f"[serve] {n} videos, {svc.gallery_bytes} bytes")
    want = svc.search(queries[:64], k=100)  # for the restart from the snapshot
    log(f"[serve] bf16 gallery of {n} shots x {width} ({n * width * 2 / 1e9:.2f} GB, capacity "
        f"{svc.capacity}) embedded and cast in {build_s:.1f} s ({svc.build_seconds:.1f} s in "
        f"the service, the snapshot's write included); launches {launches} [{smi}]")

    # searches by bucket and k against the plain product, timed
    timing, heads = {"build_s": build_s, "card": smi}, svc.heads
    for b in SERVE_BUCKETS:
        tn = svc.embed_queries(queries[:b])
        for k in SERVE_KS:
            got = svc.search(queries[:b], k=k)
            vals, idx = S.blocked_topk(svc.score_block(tn), n, k, S.SCORE_BLOCK)
            ids_svc = [[i for i, _ in row] for row in got]
            check(ids_svc == [[svc.vis_ids[j] for j in r] for r in idx.tolist()],
                  f"[serve] search() and its scoring disagree at bucket {b}, k {k}")
            ref_vals, ref_idx = plain_search(torch, svc, tn, k)
            ok, moved, err = lists_agree(vals, idx, ref_vals, ref_idx, SCORE_TIE_TOL)
            check(ok, f"[serve] bucket {b}, k {k}: {moved} places differ from the plain "
                  f"product beyond near ties, scores within {err}")
            search_ms = time_ms(torch, lambda: svc.search(queries[:b], k=k), reps=3)
            score_ms = time_ms(torch, lambda: S.blocked_topk(svc.score_block(tn), n, k,
                                                             S.SCORE_BLOCK), reps=3)
            plain_ms = time_ms(torch, lambda: plain_search(torch, svc, tn, k), reps=3)
            b_ms, b_by = bound_ms(n * width * 2, 2 * b * n * width, PEAK_F32_OPS_S)
            timing[f"b{b}_k{k}"] = {"search_ms": search_ms, "score_ms": score_ms,
                                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                                    "moved": moved, "max_score_diff": err}
            log(f"  [serve] bucket {b}, k {k}: search {search_ms:.2f} ms (scoring "
                f"{score_ms:.2f} ms, the plain product and sort {plain_ms:.2f} ms; bound "
                f"{b_ms:.3f} ms, {b_by}: {b_ms / score_ms:.0%} of the scoring); against the plain "
                f"product {moved} places differ (near ties), scores within {err:.3g} [{smi}]")
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.search(queries, k=1000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_ms = sum((getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0))
                  for e in prof.key_averages()) / 1e3
    timing["busy_share_b512_k1000"] = busy_ms / 1e3 / wall if busy_ms else None
    log(f"  [serve] one search of 512 queries at k 1000 under the profiler: {wall * 1e3:.1f} ms "
        f"wall, {busy_ms:.1f} ms of device time: busy "
        + (f"{busy_ms / 1e3 / wall:.1%}" if busy_ms else "not measured (no device time)"))

    # MicroBatcher: 32 threads, one query each, against direct calls. The
    # text tower's rows depend on its batch (the query bucket: cuBLAS picks
    # other GEMM tilings), so each dispatch's union is searched again
    # directly and must give its lists bit for bit, and each request must be
    # its row of them; against the 32-query call every request keeps its ids
    # but at near ties, and a request at that call's bucket its scores
    # within SERVE_SCORE_TOL (at a smaller bucket they move by more)
    direct = svc.search(queries[:SERVE_THREADS], k=10)
    mb = S.MicroBatcher(svc, window_ms=5.0)
    out, errs, dispatched = {}, [], []
    search = svc.search

    def recorded(qs, k=10):
        got = search(qs, k=k)
        dispatched.append((list(qs), k, got))
        return got

    def worker(i):
        try:
            out[i] = mb.search([queries[i]], k=10)[0]
        except Exception as e:  # noqa: BLE001 - reported below
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(SERVE_THREADS)]
    try:
        svc.search = recorded
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
        finally:
            del svc.search
        check(not errs and len(out) == SERVE_THREADS, f"[serve] micro-batched searches: {errs}")
        check(sum(len(qs) for qs, _, _ in dispatched) == SERVE_THREADS
              and len(dispatched) == mb.dispatches < SERVE_THREADS,
              f"[serve] {mb.dispatches} dispatches of {[len(d[0]) for d in dispatched]} queries "
              f"for {SERVE_THREADS} requests")
        row_of, cross_bucket = {}, 0.0
        for qs, k, got in dispatched:
            check(svc.search(qs, k=k) == got, f"[serve] a dispatch of {len(qs)} queries differs "
                  f"from the same queries searched directly")
            for q, row in zip(qs, got):
                row_of.setdefault(q, []).append((row[:10], svc._bucket(len(qs))))
        for i in range(SERVE_THREADS):
            a, d = out[i], direct[i]
            bucket = next((b for row, b in row_of.get(queries[i], []) if row == a), None)
            check(bucket is not None, f"[serve] query {i} through the batcher is not its "
                  f"dispatch's row")
            v = np.asarray([s for _, s in d], np.float64)
            err = max(abs(x[1] - y[1]) for x, y in zip(a, d))
            if bucket != svc._bucket(SERVE_THREADS):
                cross_bucket = max(cross_bucket, err)
            check(all(a[j][0] == d[j][0] or near_tie(v, j, SCORE_TIE_TOL) for j in range(10))
                  and (err <= SERVE_SCORE_TOL or bucket != svc._bucket(SERVE_THREADS)),
                  f"[serve] query {i} through the batcher (bucket {bucket}) differs from the "
                  f"direct call: scores within {err:.3g}")

        # do_server's handler in a thread on port 0
        K.reset_launches()
        server = ThreadingHTTPServer(("127.0.0.1", 0),
                                     do_server.make_handler(do_server._Front(svc, mb), 10))
        port = server.server_address[1]
        st = threading.Thread(target=server.serve_forever, daemon=True)
        st.start()
        try:
            def call(path, body=None):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}{path}",
                    data=None if body is None else json.dumps(body).encode(),
                    headers={"Content-Type": "application/json"})
                try:
                    with urllib.request.urlopen(req, timeout=300) as r:
                        return r.status, json.loads(r.read())
                except urllib.error.HTTPError as e:
                    return e.code, json.loads(e.read())

            code, health = call("/healthz")
            check(code == 200 and health == {"ok": True, "gallery": AVS_SHOTS, "dtype": "bf16",
                                             "heads": heads}, f"[serve] /healthz {health}")
            code, found = call("/search", {"queries": queries[:4], "k": 5})
            check(code == 200 and [[e["id"] for e in r] for r in found["results"]]
                  == [[i for i, _ in r] for r in svc.search(queries[:4], k=5)],
                  f"[serve] /search {code}")
            check(call("/search", {"queries": queries[:1], "k": 0})[0] == 400,
                  "[serve] a bad k is not a 400")
            # ingest: copies of the top videos' features under new ids
            from laff_tpu_torch.store import BigFile

            top = [r[0]["id"] for r in found["results"]]
            src = [top[i % len(top)] for i in range(SERVE_INGEST)]
            feats = {name: np.round(BigFile(os.path.join(root, AVS_COLLECTION, "FeatureData",
                                                         name)).gather(src)[1], 4).tolist()
                     for name in svc.config.vid_feats}
            new_ids = [f"ingested_{i}" for i in range(SERVE_INGEST)]
            t0 = time.perf_counter()
            code, body = call("/ingest", {"ids": new_ids, "features": feats})
            ingest_s = time.perf_counter() - t0
            check(code == 200 and body == {"count": AVS_SHOTS + SERVE_INGEST,
                                           "capacity": AVS_SHOTS + SERVE_INGEST},
                  f"[serve] /ingest {code} {body}")
            code, after = call("/search", {"queries": queries[:1], "k": 20})
            check(code == 200 and any(e["id"].startswith("ingested_")
                                      for e in after["results"][0]),
                  f"[serve] the ingested copies are not found: {after}")
            code, metrics = call("/metrics")
            check(code == 200 and metrics["ingested_rows"] == SERVE_INGEST
                  and metrics["gallery"] == AVS_SHOTS + SERVE_INGEST
                  and metrics["batched_requests"] >= SERVE_THREADS, f"[serve] /metrics {metrics}")
        finally:
            server.shutdown()
            server.server_close()
            st.join(timeout=60)
        ingest_launches = dict(K.LAUNCHES)
    finally:
        mb.close()
    check(ingest_launches["gate_attention"] >= SERVE_INGEST // 64,
          f"[serve] the HTTP session launched {ingest_launches}")
    sizes = [len(qs) for qs, _, _ in dispatched]
    timing.update(ingest_s=ingest_s, dispatches=mb.dispatches, requests=mb.requests,
                  dispatch_sizes=sizes, cross_bucket_score_diff=cross_bucket)
    log(f"  [serve] {SERVE_THREADS} threads through MicroBatcher: {len(sizes)} dispatches of "
        f"{sizes} queries, each its union's direct lists bit for bit; against the 32-query call "
        f"the same ids (but near ties), scores within {SERVE_SCORE_TOL} at its bucket and "
        f"within {cross_bucket:.3g} at a smaller one; do_server on 127.0.0.1:{port}: "
        f"/healthz, /search, "
        f"a 400 for k 0, /ingest of {SERVE_INGEST} rows in {ingest_s:.1f} s (found by /search), "
        f"/metrics; launches {ingest_launches} [{smi}]")

    # a restart from the snapshot, bit for bit
    live = svc._vn[:AVS_SHOTS].clone()
    del svc
    t0 = time.perf_counter()
    restored = S.RetrievalService(ckpt, root, AVS_COLLECTION, gallery_cache=snapshot)
    restart_s = time.perf_counter() - t0
    got = restored.search(queries[:64], k=100)
    check(torch.equal(restored._vn, live) and got == want,
          "[serve] the restored gallery or its results differ from the fresh one's")
    del restored, live
    timing["restart_s"] = restart_s

    # the int8 gallery against the bf16 order
    K.reset_launches()
    t0 = time.perf_counter()
    svc8 = S.RetrievalService(ckpt, root, AVS_COLLECTION, gallery_dtype="int8")
    build8_s = time.perf_counter() - t0
    check(svc8.gallery_bytes == AVS_SHOTS * (width + 4),
          f"[serve] int8 bytes {svc8.gallery_bytes}")
    q8 = svc8.search(queries[:64], k=100)
    overlap = [len({x for x, _ in e} & {x for x, _ in q}) / 100 for e, q in zip(got, q8)]
    top1 = sum(e[0][0] == q[0][0] for e, q in zip(got, q8))
    # laff_tpu's test_service_int8_matches_bf16_order: the top-1 agrees, here but
    # where the bf16 scores of the two picks lie within the int8 error
    near = all(e[0][0] == q[0][0] or dict(e).get(q[0][0], -1.0) >= e[0][1] - SERVE_INT8_TIE
               for e, q in zip(got, q8))
    check(near and float(np.mean(overlap)) >= SERVE_INT8_OVERLAP,
          f"[serve] int8 against bf16: top-1 equal for {top1} of 64, top-100 overlap "
          f"{np.mean(overlap)}")
    timing.update(int8_build_s=build8_s, int8_overlap=float(np.mean(overlap)), int8_top1=top1,
                  int8_bytes=svc8.gallery_bytes)
    del svc8
    log(f"  [serve] restart from the snapshot in {restart_s:.1f} s: the gallery bit for bit and "
        f"the same lists; int8 gallery ({AVS_SHOTS * (width + 4) / 1e9:.2f} GB) in "
        f"{build8_s:.1f} s: top-100 overlap with bf16 {np.mean(overlap):.4f} (min "
        f"{min(overlap):.2f}), top-1 equal for {top1} of 64 [{smi}]")
    os.remove(snapshot)
    log("[serve] serve_timing " + json.dumps(timing))
    return {"serve_build": launches, "serve_http": ingest_launches}


# ---------------------------------------------------------------------------
# phase 14: seed sweeps and experiment orchestration
# ---------------------------------------------------------------------------

SWEEP_SEEDS = (SEED, SEED + 1, SEED + 2)
SWEEP_WORLDS = (("strain", 500, 20, SEED + 14), ("sval", 500, 20, SEED + 15),
                ("stest", 500, 20, SEED + 16))
SWEEP_VAL_GATE_CALLS = 10 + 1  # 10,000 captions and 500 videos in batches of 1,024
SWEEP_EPOCHS = 2
SWEEP_PREFIX_BASE = "sweep_"  # (a)'s runs are retrieval_task's <base><parm>_seed_<s>
ORCH_SEEDS = SWEEP_SEEDS[:2]
ORCH_PREDICT_BATCH = 256  # retrieval_task predicts at max(batch_size, 256)
ORCH_PREDICT_GATE_CALLS = -(-10_000 // ORCH_PREDICT_BATCH) + -(-500 // ORCH_PREDICT_BATCH)
SWEEP_PHASE_BUDGET_S = 100.0


def _state_diff(torch, a, b):
    """Max abs difference over two models' state dicts (0.0: equal)."""
    sa, sb = a.state_dict(), b.state_dict()
    return max(float((sa[k].double() - sb[k].double()).abs().max()) if sa[k].numel() else 0.0
               for k in sa)


def _run_diff(T, got, want):
    """(max relative epoch-loss difference, metrics that differ) of two runs."""
    loss = max(abs(g["loss"] - w["loss"]) / abs(w["loss"])
               for g, w in zip(got["history"], want["history"]))
    metrics = [(w["epoch"], k, g[k], w[k]) for g, w in zip(got["history"], want["history"])
               for k in T.METRICS if g[k] != w[k]]
    return loss, metrics


def sweep_phase(torch, K, P, root, smi):
    """14. (a) ``engine.sweep.sweep_main`` at configs/rehearsal.py's full
    width on strain -> sval (500 x 20 each), S = 3 seeds x 2 epochs at the
    default dispatch (both caches, K 8 as a CUDA graph a seed, staged
    validation shared), rank_path 'kernel', sync debug on: each seed's
    epoch losses, metrics and weights equal a ``trainer.main`` run of that
    seed bit for bit (if not, the bound is the spread of two trainer.main
    runs of one seed, measured here); each validation launches one wide
    rank and 11 gates a seed, the steps none; the sweep's wall against the
    sum of the S runs, capture seconds, ms per graphed step, peak device
    bytes. (b) ``orchestrate.retrieval_task`` with batch_seeds over 2 seeds
    and one parm (one epoch, trained by sweep_main), then prediction on
    stest (500 x 20): the model directories, the result file's rows, and
    each prediction's launches (one wide rank, 42 gates). Returns the
    launches of (a) and of (b)'s training and predictions."""
    import numpy as np

    from laff_tpu_torch.data.synth import build_world
    from laff_tpu_torch.engine import orchestrate as O
    from laff_tpu_torch.engine import sweep as S
    from laff_tpu_torch.engine import trainer as T
    from laff_tpu_torch.engine.prepare import Options, model_dir_for

    t_phase = time.perf_counter()
    for coll, n, caps, seed in SWEEP_WORLDS:
        build_world(root, coll, n, caps, 11286, seed)
    log(f"[sweep] worlds {[w[:3] for w in SWEEP_WORLDS]} in "
        f"{time.perf_counter() - t_phase:.1f} s")
    base = dict(trainCollection="strain", valCollection="sval", rootpath=root, val_set="no",
                config_name="rehearsal", num_epochs=SWEEP_EPOCHS, batch_size=128,
                device="cuda", rank_path="kernel", sync_debug=1)
    seeds = list(SWEEP_SEEDS)

    # (a) the sweep, then each seed's trainer.main
    opt = Options(model_prefix=f"{SWEEP_PREFIX_BASE}None", **base)
    default_rng = torch.cuda.get_rng_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # the peaks below count what a run adds to it
    K.reset_launches()
    t0 = time.perf_counter()
    swept = S.sweep_main(opt, seeds)
    torch.cuda.synchronize()
    sweep_wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - held
    check(torch.equal(torch.cuda.get_rng_state(), default_rng),
          "[sweep] sweep_main moved the process's default CUDA generator")
    n_val = len(seeds) * SWEEP_EPOCHS
    expect = {"sim_rank_wide": n_val, "sim_rank_tiled": 0,
              "gate_attention": n_val * SWEEP_VAL_GATE_CALLS, "gate_attention_simple": 0}
    check(launches == expect, f"[sweep] sweep launches {launches}, expected one rank and "
          f"{SWEEP_VAL_GATE_CALLS} gate launches per seed's validation, none in the steps: "
          f"{expect}")
    for s, res in zip(seeds, swept):
        hist = res["history"]
        check(default_dispatch(res["dispatch"]), f"[sweep] seed {s}: the dispatch is not the "
              f"default one (both caches, K 8 as a graph, staged validation): {res['dispatch']}")
        check(len(hist) == SWEEP_EPOCHS and hist[-1]["loss"] < hist[0]["loss"]
              and hist[-1]["r1"] > 100.0 / 500, f"[sweep] seed {s}: {hist}")
        check(res["model_path"] == model_dir_for(Options(
            model_prefix=f"{SWEEP_PREFIX_BASE}None_seed_{s}", **base)),
            f"[sweep] seed {s} wrote to {res['model_path']}")

    singles, single_walls, single_peaks = [], [], []
    for s in seeds:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        singles.append(T.main(Options(model_prefix=f"single_seed_{s}", random_seed=s, **base)))
        torch.cuda.synchronize()
        single_walls.append(time.perf_counter() - t0)
        single_peaks.append(torch.cuda.max_memory_allocated() - held)
    exact, diffs, spread = sweep_spread_check(
        torch, T, "sweep", swept, singles,
        lambda: T.main(Options(model_prefix=f"single_again_{seeds[0]}", random_seed=seeds[0],
                               **base)),
        weights=lambda a, b: _state_diff(torch, a["model"], b["model"]))
    steps = swept[0]["history"][-1]["steps"]
    sweep_step_ms = 1e3 * swept[0]["history"][-1]["train_seconds"] / (len(seeds) * steps)
    single_step_ms = [1e3 * r["history"][-1]["train_seconds"] / steps for r in singles]
    captures = [r["dispatch"]["capture_seconds"] for r in swept]
    row = {"seeds": seeds, "epochs": SWEEP_EPOCHS, "steps_per_epoch": steps,
           "exact": exact, "diffs": diffs, "spread": spread,
           "sweep_wall_s": sweep_wall, "sequential_walls_s": single_walls,
           "sequential_sum_s": sum(single_walls),
           "sweep_prepare_s": swept[0]["prepare_seconds"],
           "sequential_prepare_s": [r["prepare_seconds"] for r in singles],
           "sweep_epoch_train_s": [h["train_seconds"] for h in swept[0]["history"]],
           "sequential_epoch_train_s": [[h["train_seconds"] for h in r["history"]]
                                        for r in singles],
           "sweep_val_s": [[h["val_seconds"] for h in r["history"]] for r in swept],
           "capture_s": captures,
           "sweep_step_ms": sweep_step_ms, "sequential_step_ms": single_step_ms,
           "sweep_peak_device_bytes": peak, "sequential_peak_device_bytes": single_peaks,
           "smi": smi}
    log(f"  [sweep] (a) {len(seeds)} seeds x {SWEEP_EPOCHS} epochs of {steps} steps: "
        + ("each seed's losses, metrics and weights equal its trainer.main run bit for bit"
           if exact else f"within the spread of two trainer.main runs {spread}")
        + f"; the sweep {sweep_wall:.1f} s against {sum(single_walls):.1f} s for the "
        f"{len(seeds)} runs one after another ({[round(w, 1) for w in single_walls]}); a "
        f"graphed step {sweep_step_ms:.2f} ms in the sweep (the second epoch) against "
        f"{[round(v, 2) for v in single_step_ms]} alone; captures "
        f"{[round(c, 2) for c in captures]} s; peak device memory above what was held before: "
        f"{peak / 1e9:.2f} GB against {max(single_peaks) / 1e9:.2f} GB for one run; "
        f"launches {launches} [{smi}]")
    del swept, singles

    # (b) retrieval_task: the pending seeds through sweep_main, then prediction
    result_file = os.path.join(root, "result_log", "orch.txt")
    sweep = O.SweepOptions(trainCollection="strain", valCollection="sval",
                           testCollection="stest", rootpath=root, config_name="rehearsal",
                           parm_adjust_configs=["None"], random_seeds=list(ORCH_SEEDS),
                           batch_size=128, num_epochs=1, model_prefix_base="orch_",
                           result_file=result_file, batch_seeds=True, device="cuda",
                           rank_path="kernel")
    per_predict = []
    real_predict = P.main

    def counted_predict(popt):
        before = dict(K.LAUNCHES)
        out = real_predict(popt)
        per_predict.append({k: v - before[k] for k, v in K.LAUNCHES.items()})
        return out

    K.reset_launches()
    t0 = time.perf_counter()
    P.main = counted_predict  # orchestrate imports predictor.main at each call
    try:
        res = O.retrieval_task(sweep)
    finally:
        P.main = real_predict
    torch.cuda.synchronize()
    orch_wall = time.perf_counter() - t0
    total = dict(K.LAUNCHES)
    prefixes = [f"orch_None_seed_{s}" for s in ORCH_SEEDS]
    check(list(res) == prefixes and all(res[p]["train"].get("batched") for p in prefixes),
          f"[orchestrate] retrieval_task gave {list(res)}: "
          f"{[r['train'] for r in res.values()]}")
    dirs = [os.path.join(root, "strain", "w2vvpp_train", "sval", "rehearsal", p)
            for p in prefixes]
    check(all(os.path.exists(os.path.join(d, "model_best.pth.tar")) for d in dirs),
          f"[orchestrate] model directories {dirs}")
    expect_p = {"sim_rank_wide": 1, "sim_rank_tiled": 0,
                "gate_attention": ORCH_PREDICT_GATE_CALLS, "gate_attention_simple": 0}
    check(per_predict == [expect_p] * len(ORCH_SEEDS),
          f"[orchestrate] prediction launches {per_predict}, expected {expect_p} each")
    train_launches = {k: v - sum(p[k] for p in per_predict) for k, v in total.items()}
    expect_t = {"sim_rank_wide": len(ORCH_SEEDS), "sim_rank_tiled": 0,
                "gate_attention": len(ORCH_SEEDS) * SWEEP_VAL_GATE_CALLS,
                "gate_attention_simple": 0}
    check(train_launches == expect_t, f"[orchestrate] the sweep's launches {train_launches}, "
          f"expected {expect_t}")
    rows = {}
    for side in ("TextToVideo", "VideoToText"):
        with open(os.path.join(root, "result_log", side, "orch.txt")) as fh:
            rows[side] = [line.rstrip("\n").split("\t") for line in fh if line.strip()]
        check([r[1] for r in rows[side]] == [os.path.join(d, "model_best.pth.tar")
                                            for d in dirs]
              and all(r[2] == "stest" for r in rows[side]),
              f"[orchestrate] {side} rows {rows[side]}")
    t2v = [res[p]["predict"]["stest.caption.txt"]["t2v"] for p in prefixes]
    check(all(np.isfinite(v).all() and v[0] > 100.0 / 500 for v in map(np.asarray, t2v)),
          f"[orchestrate] t2v {t2v}")
    log(f"  [orchestrate] (b) retrieval_task, batch_seeds over seeds {list(ORCH_SEEDS)}: "
        f"{orch_wall:.1f} s (one sweep epoch and two stest passes); model dirs "
        f"{prefixes}; t2v rows {[r[3:10] for r in rows['TextToVideo']]}; each prediction "
        f"launched {expect_p}, the sweep {train_launches} [{smi}]")
    row.update(orchestrate_wall_s=orch_wall, orchestrate_t2v=t2v)
    phase_s = time.perf_counter() - t_phase
    log("[sweep] sweep_timing " + json.dumps(row))
    log(f"[sweep] phase 14 (a)-(b): {phase_s:.1f} s (budget {SWEEP_PHASE_BUDGET_S:.0f} s with "
        f"(c))")
    return launches, train_launches, per_predict


def sweep_avs_phase(torch, K, root, random_infap, smi):
    """14(c). ``orchestrate.avs_task`` on tv16 of phase 8's iacc.3 world from
    the checkpoint (a) wrote for the first seed, training skipped (its
    model_best is in place): the streamed query set (the gate 1 + 329
    times, no rank kernel), the TRECVID xml and infAP, at least 5x
    ``random_infap``'s for tv16. Returns the launches."""
    from laff_tpu_torch.engine import orchestrate as O

    sweep = O.SweepOptions(trainCollection="strain", valCollection="sval",
                           testCollection=AVS_COLLECTION, rootpath=root,
                           config_name="rehearsal", parm_adjust_configs=["None"],
                           random_seeds=[SWEEP_SEEDS[0]], batch_size=AVS_BATCH,
                           model_prefix_base=SWEEP_PREFIX_BASE,
                           result_file=os.path.join(root, "result_log", "orch_avs.txt"),
                           avs_query_sets="tv16.avs.txt", avs_editions=["tv16"],
                           device="cuda", rank_path="kernel")
    K.reset_launches()
    t0 = time.perf_counter()
    res = O.avs_task(sweep)[f"{SWEEP_PREFIX_BASE}None_seed_{SWEEP_SEEDS[0]}"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    expect = {"sim_rank_wide": 0, "sim_rank_tiled": 0, "gate_attention": AVS_GATE_CALLS,
              "gate_attention_simple": 0}
    check(res["train"].get("skipped") and not res["train"].get("batched"),
          f"[avs_task] training was not skipped: {res['train']}")
    check(launches == expect, f"[avs_task] launches {launches}, expected {expect}")
    infap, rand = res["infAP"].get("tv16"), random_infap["tv16"]
    check(infap is not None and infap > 0 and infap >= AVS_INFAP_RATIO * rand,
          f"[avs_task] tv16 infAP {infap} against {rand} of a random run")
    score_file = res["predict"]["tv16.avs.txt"]["score_file"]
    check(os.path.exists(score_file + ".xml"), f"[avs_task] no submission {score_file}.xml")
    log(f"  [avs_task] (c) tv16 from (a)'s seed-{SWEEP_SEEDS[0]} checkpoint, training skipped: "
        f"infAP {infap:.4f} against {rand:.4f} for a random run; {wall:.1f} s (the streamed "
        f"set {res['predict']['tv16.avs.txt']['seconds']}); launches {launches} [{smi}]")
    return launches


def sweep_only(torch, K, P, smi):
    """``--sweep``: phase 14 alone, (c) on an iacc.3 world built for it
    (no ibench), with a seeded random run for the ratio; then
    (d) reproduce_mvtest3k's dry run and (e) the two-stage AVS recipe."""
    import numpy as np

    from laff_tpu_torch.cli import avs_eval
    from laff_tpu_torch.data.synth import build_avs_world

    shutil.rmtree(WORK, ignore_errors=True)
    root = os.path.join(WORK, "world")
    t0 = time.perf_counter()
    launches, orch_train, orch_predict = sweep_phase(torch, K, P, root, smi)
    log(f"sweep phase (14 (a)-(b)): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    build_avs_world(root, AVS_COLLECTION, AVS_SHOTS, AVS_EDITIONS, AVS_TOPICS, seed=SEED + 8)
    log(f"[avs] world in {time.perf_counter() - t0:.1f} s")
    try:
        t0 = time.perf_counter()
        shots = [line.strip() for line in open(os.path.join(
            root, AVS_COLLECTION, "VideoSets", f"{AVS_COLLECTION}.txt"))]
        rng = np.random.default_rng(SEED + 8)
        # the random run takes its topics from (c)'s score file: drawn at lookup
        random_infap = _LazyRandom(lambda edition: random_run_infap(
            avs_eval, root, edition, os.path.join("strain", "sval", "rehearsal"), rng, shots))
        avs = sweep_avs_phase(torch, K, root, random_infap, smi)
        log(f"avs_task phase (14(c)): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        dry_run_phase(smi)
        two_stage_phase(torch, K, root, random_infap, smi)
        log(f"reproduction and two-stage phases (14(d)-(e)): {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    return launches, orch_train, orch_predict, avs


def dry_run_phase(smi):
    """14(d). ``python -m laff_tpu_torch.cli.reproduce_mvtest3k --dry_run``
    on the card: the mirror world (tiny config, 4 epochs) trained and
    predicted through retrieval_task; exit code 0 and plumbing 'ok'."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "laff_tpu_torch.cli.reproduce_mvtest3k",
                           "--dry_run"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    ok = proc.returncode == 0 and lines and lines[-1].get("plumbing") == "ok"
    log(f"  [reproduce] (d) reproduce_mvtest3k --dry_run on the card: rc {proc.returncode} in "
        f"{wall:.1f} s; {lines[-1] if lines else 'no result line'} [{smi}]")
    if not ok:
        log(proc.stdout[-8000:] + proc.stderr[-8000:])
    check(ok, f"[reproduce] the dry run failed (rc {proc.returncode})")


def two_stage_phase(torch, K, root, random_infap, smi):
    """14(e). ``cli/do_pretrain_gcc_train_avs.py`` at configs/rehearsal.py's
    full width: stage 1 on gtrain (strain's videos and captions under
    another name, so that the vocabulary, and with it the warm start, fits
    strain) with --only_train 1 (the subset split), one epoch; stage 2 one
    epoch on strain -> sval from its best checkpoint, then tv16 of iacc.3:
    the fine-tune's checkpoint names the pretrain's, infAP at least
    AVS_INFAP_RATIO x a random run's; a second call skips stage 1 and leaves
    its checkpoint as it was."""
    from laff_tpu_torch.cli import do_pretrain_gcc_train_avs as two_stage
    from laff_tpu_torch.data.synth import build_world
    from laff_tpu_torch.engine.checkpoint import load_checkpoint

    coll, n, caps, seed = SWEEP_WORLDS[0]
    build_world(root, "gtrain", n, caps, 11286, seed)
    argv = ["--rootpath", root, "--pretrainCollection", "gtrain", "--trainCollection", coll,
            "--valCollection", SWEEP_WORLDS[1][0], "--val_set", "no", "--testCollection",
            AVS_COLLECTION, "--config", "rehearsal", "--seed", str(SEED), "--pretrain_epochs",
            "1", "--num_epochs", "1", "--avs_query_sets", "tv16.avs.txt", "--avs_editions",
            "tv16"]
    K.reset_launches()
    t0 = time.perf_counter()
    first = two_stage.run(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    (prefix, res), = first["avs"].items()
    ft = load_checkpoint(os.path.join(res["train"]["model_path"], "model_best.pth.tar"))
    check(first["pretrained"] and ft["opt"]["pretrained_file_path"] == first["pretrain_ckpt"],
          f"[two-stage] the fine-tune {prefix} did not start from the pretrain's checkpoint: "
          f"{ft['opt'].get('pretrained_file_path')} against {first['pretrain_ckpt']}")
    infap, rand = res["infAP"].get("tv16"), random_infap["tv16"]
    check(infap is not None and infap > 0 and infap >= AVS_INFAP_RATIO * rand,
          f"[two-stage] tv16 infAP {infap} against {rand} of a random run")
    stat = os.stat(first["pretrain_ckpt"])
    t0 = time.perf_counter()
    again = two_stage.run(argv)
    again_wall = time.perf_counter() - t0
    check(not again["pretrained"] and os.stat(first["pretrain_ckpt"]).st_mtime_ns
          == stat.st_mtime_ns, "[two-stage] a second call ran stage 1 again")
    log(f"  [two-stage] (e) pretrain on gtrain (subset), fine-tune on {coll} -> "
        f"{SWEEP_WORLDS[1][0]} from its best checkpoint, tv16 of {AVS_COLLECTION}: infAP "
        f"{infap:.4f} against {rand:.4f} for a random run; {wall:.1f} s (stage 1, stage 2 and "
        f"the streamed set; launches {launches}); a second call skipped stage 1 in "
        f"{again_wall:.1f} s [{smi}]")


class _LazyRandom(dict):
    """A random run's infAP by edition, computed at first lookup (after the
    trained run's score file exists)."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def __missing__(self, edition):
        self[edition] = self.fn(edition)
        return self[edition]


def bert_serve_only(torch, K, P, smi):
    """``--bert-serve``: phases 12 and 13 alone (13 on the world phase 8
    builds, with its benchmark captions), for work on them."""
    from laff_tpu_torch.data.synth import build_avs_world

    shutil.rmtree(WORK, ignore_errors=True)
    root = os.path.join(WORK, "world")
    t0 = time.perf_counter()
    _, _, ckpt = bert_phase(torch, K, P, root, smi)
    log(f"BERT phase (12): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    build_avs_world(root, AVS_COLLECTION, AVS_SHOTS, AVS_EDITIONS, AVS_TOPICS, seed=SEED + 8,
                    benchmark=(IBENCH, IBENCH_SHOTS, IBENCH_CAPS))
    log(f"[avs] world in {time.perf_counter() - t0:.1f} s")
    try:
        t0 = time.perf_counter()
        serve_phase(torch, K, root, ckpt, smi)
        log(f"serving phase (13): {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 15 and --multi: the mesh paths (laff_tpu_torch.parallel)
# ---------------------------------------------------------------------------

MULTI_RANKS = 4  # --multi: one rank a card, four cards of one host
MV_T, MV_V, MV_CAPS = 59_800, 2_990, 20  # MV-test3k: captions x videos, 20 a video
HD = 8 * 512
MULTI_QUERIES, MULTI_K = 512, 1000  # sim_engine's top k and the served searches
MULTI_TIE = 1e-6  # sharded vs one-card service lists: near ties and score distance
MULTI_METRIC_TOL = 1e-5  # the data-parallel predictor's metrics against one card's
MULTI_LOSS_RTOL = 1e-4  # the data-parallel dispatch's losses against one card's
MULTI_PARAM_TOL = 1e-4  # its parameters (f32 towers), of each tensor's largest magnitude
# the same in the config's bf16, over the tensors the dispatch did not make
# and those whose gradient is rounding noise (multi_train_phase), and each
# one's distance in norm of one card's update in norm: the sound run read
# 0.0384 and 0.995, a run whose all-reduce lost a rank's share 0.0389 and
# 2.70 (PERF.md §6)
MULTI_PARAM_TOL_BF16 = 0.05
MULTI_UPDATE_TOL_BF16 = 1.5
# a tensor's gradient is rounding noise where one card's gradient with bf16
# towers lies further than this of its norm with f32 towers from it, at the
# dispatch's last step: the gate's bias, a shift of every logit before a
# softmax, whose exact gradient is zero
MULTI_NOISE_RATIO = 0.5
# (f)'s losses in bf16, two cards a row: its sound rows read 2.16e-4 and
# 1.18e-5 on strain, (d)'s control (a quarter of the gradient lost) 1.49e-2;
# (f)'s own control, which loses half, must lie beyond it (PERF.md §6)
MULTI_ROW_LOSS_RTOL_BF16 = 1e-3
MULTI_BATCH = 128  # (d)'s global batch, and its per-card batch in the last epoch
MESH_ONE_K = 1000


@contextlib.contextmanager
def world_of_one():
    """An NCCL group of one (this process on card 0), its mesh; destroyed at
    the end."""
    import tempfile

    import torch.distributed as dist

    from laff_tpu_torch.parallel import data_parallel_mesh

    os.makedirs(WORK, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=WORK) as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            yield data_parallel_mesh()
        finally:
            dist.destroy_process_group()


def one_card_topk(torch, tn, score_block, n, k):
    """The one-card top k of the sim_engine's scoring over all ``n`` rows
    (``ops.similarity.blocked_topk`` at the engine's block)."""
    from laff_tpu_torch.ops.similarity import blocked_topk
    from laff_tpu_torch.parallel.sim_engine import TOPK_BLOCK

    vals, idx = blocked_topk(score_block, n, k, TOPK_BLOCK)
    return vals.cpu().numpy(), idx.cpu().numpy()


def mesh_one_sim_phase(torch, txt, vis, txt_ids, vis_ids):
    """15 (a). parallel.sim_engine over an NCCL group of one on rtest's
    resident embeddings (phase 3's model), bit for bit against the one-card
    functions: the flat ranks (evaluator.t2v_ranks), and the top 1,000 of
    the f32 and the int8 products (blocked_topk)."""
    import numpy as np

    from laff_tpu_torch.engine.evaluator import t2v_ranks
    from laff_tpu_torch.ops import flatten_heads, int8_scores, quantize_rows
    from laff_tpu_torch.parallel import sim_engine as E

    index = {v: i for i, v in enumerate(vis_ids)}
    gt = torch.as_tensor([index[t.split("#")[0]] for t in txt_ids], device="cuda")
    vn = flatten_heads(vis)
    vq, vs = quantize_rows(vn)
    q = flatten_heads(txt[:MULTI_QUERIES]).float()  # as the engine flattens its queries
    tq, ts = quantize_rows(q)
    t0 = time.perf_counter()
    with world_of_one() as mesh:
        ranks = E.sharded_t2v_ranks(txt, vis, gt, mesh)
        vals, idx = E.sharded_topk(txt[:MULTI_QUERIES], vis, MESH_ONE_K, mesh)
        vals8, idx8 = E.sharded_int8_topk(txt[:MULTI_QUERIES], vq, vs, MESH_ONE_K, mesh)
    seconds = time.perf_counter() - t0
    ref = t2v_ranks(txt, vis, txt_ids, vis_ids, rank_path="flat")
    check(np.array_equal(ranks, ref), "[mesh 1] sharded_t2v_ranks differs from the one-card "
          f"flat ranks on {int((ranks != ref).sum())} captions")
    ref_vals, ref_idx = one_card_topk(torch, q, lambda s, e: q @ vn[s:e].float().T,
                                      vn.shape[0], MESH_ONE_K)
    check(np.array_equal(vals, ref_vals) and np.array_equal(idx, ref_idx),
          "[mesh 1] sharded_topk differs from the one-card top k")
    ref8 = one_card_topk(torch, q, lambda s, e: int8_scores(tq, ts, vq[s:e], vs[s:e]),
                         vn.shape[0], MESH_ONE_K)
    check(np.array_equal(vals8, ref8[0]) and np.array_equal(idx8, ref8[1]),
          "[mesh 1] sharded_int8_topk differs from the one-card top k")
    log(f"[mesh 1] sim_engine over an NCCL group of one on rtest's embeddings ({len(txt_ids)} x "
        f"{len(vis_ids)}): ranks, the f32 top {MESH_ONE_K} and the int8 top {MESH_ONE_K} of "
        f"{MULTI_QUERIES} queries equal the one-card functions' bit for bit ({seconds:.1f} s)")
    return {"sim_engine_s": seconds}


def service_lists_equal(got, want):
    """Two services' result lists are the same, bit for bit."""
    return all(a == b for a, b in zip(got, want)) and len(got) == len(want)


def mesh_one_serve_phase(torch, K, root, ckpt, smi):
    """15 (b). RetrievalService(mesh=) over an NCCL group of one on phase 12's
    BERT checkpoint over bval, bf16 and int8, bit for bit against the
    one-card service: searches at buckets 1 and 64, an ingest of 64 copies,
    and the snapshot the mesh writes restored by the one-card service.
    Returns the launches of the mesh services' builds, searches and
    ingests."""
    import numpy as np

    from laff_tpu_torch.engine import service as S
    from laff_tpu_torch.store import BigFile

    coll = "bval"
    with open(os.path.join(root, coll, "TextData", f"{coll}.caption.txt")) as fh:
        queries = [line.split(" ", 1)[1] for line in fh.read().splitlines()[:64]]
    snap = os.path.join(WORK, "mesh_one_gallery.npz")
    launches = {}
    t0 = time.perf_counter()

    def session(svc):
        out = [svc.search(queries[:1], k=10), svc.search(queries, k=100)]
        src = [row[0][0] for row in out[1]]
        feats = {name: BigFile(os.path.join(root, coll, "FeatureData", name)).gather(src)[1]
                 for name in svc.config.vid_feats}
        svc.add_videos([f"copy_{i}" for i in range(len(src))], feats)
        out.append(svc.search(queries, k=100))
        check(any(i.startswith("copy_") for row in out[-1] for i, _ in row),
              "[mesh 1] the ingested copies are not found")
        return out

    for dtype in ("bf16", "int8"):
        cache = snap if dtype == "bf16" else None
        with world_of_one() as mesh:
            K.reset_launches()
            svc = S.RetrievalService(ckpt, root, coll, gallery_dtype=dtype, capacity=1000,
                                     gallery_cache=cache, mesh=mesh)
            got = session(svc)
            svc.close()
            launches = {k: launches.get(k, 0) + v for k, v in K.LAUNCHES.items()}
        one = S.RetrievalService(ckpt, root, coll, gallery_dtype=dtype, capacity=1000)
        check(service_lists_equal(session(one), got),
              f"[mesh 1] the {dtype} service over a mesh of one differs from one card's")
        if cache:
            restored = S.RetrievalService(ckpt, root, coll, capacity=1000, gallery_cache=snap)
            check(service_lists_equal([restored.search(queries[:1], k=10)], got[:1]),
                  "[mesh 1] the snapshot the mesh wrote does not restore on one card")
            del restored
        del svc, one
    check(launches["gate_attention"] >= 2, f"[mesh 1] the services launched {launches}")
    log(f"[mesh 1] RetrievalService over an NCCL group of one on {coll} (bf16 and int8): "
        f"searches at buckets 1 and 64, an ingest of 64 copies and the snapshot bit for bit "
        f"against one card's in {time.perf_counter() - t0:.1f} s; launches {launches} [{smi}]")
    return launches


# -- phase 16: seed sweeps over a mesh of one --------------------------------

MESH_SWEEP_SEEDS = SWEEP_SEEDS[:2]
MESH_SWEEP_EPOCHS = 1
MESH_SWEEP_LAYOUTS = ("seed", "seed_x_dp")  # data_parallel_mesh(1), seed_data_mesh(1, 1)


def _ckpt_diff(torch, a, b):
    """Max abs difference over two runs' best checkpoints (0.0: equal)."""
    from laff_tpu_torch.engine.checkpoint import load_checkpoint

    sa, sb = (load_checkpoint(os.path.join(r["model_path"], "model_best.pth.tar"))["state_dict"]
              for r in (a, b))
    return max(float((sa[k].double() - sb[k].double()).abs().max()) if sa[k].numel() else 0.0
               for k in sa)


def sweep_spread_check(torch, T, what, got, want, spread_run, weights=None):
    """Each of ``got``'s seed runs against ``want``'s (loss, metrics and
    weights: the best checkpoints', or ``weights(a, b)``): equal bit for
    bit, or within the spread of two one-card runs of the first seed,
    measured then (``spread_run()`` gives the second run of ``want[0]``'s
    seed). Returns (exact, diffs, spread)."""
    weights = weights or (lambda a, b: _ckpt_diff(torch, a, b))
    diffs = []
    for g, w in zip(got, want):
        loss, metrics = _run_diff(T, g, w)
        diffs.append({"run": os.path.basename(w["model_path"]), "loss_rel": loss,
                      "metrics": metrics, "weights": weights(g, w)})
    exact = all(d["loss_rel"] == 0 and not d["metrics"] and d["weights"] == 0 for d in diffs)
    spread = None
    if not exact:  # a nondeterministic kernel: bound by two one-card runs of one seed
        again = spread_run()
        loss, metrics = _run_diff(T, again, want[0])
        spread = {"loss_rel": loss, "metrics": metrics, "weights": weights(again, want[0])}
        log(f"  [{what}] differs from one card: {diffs}; two one-card runs of one seed differ "
            f"by {spread}")
        check(all(d["loss_rel"] <= spread["loss_rel"] and d["weights"] <= spread["weights"]
                  and len(d["metrics"]) <= len(spread["metrics"]) for d in diffs),
              f"[{what}] the runs differ from one card's beyond the spread of two one-card "
              f"runs: {diffs} against {spread}")
    return exact, diffs, spread


def mesh_sweep_phase(torch, K, root, smi):
    """16. ``engine.sweep.sweep_main`` over an NCCL group of one at
    configs/rehearsal.py's full width on phase 14's strain -> sval: the seed
    axis (``data_parallel_mesh(1)``) and the seed x dp layout
    (``seed_data_mesh(1, 1)``), MESH_SWEEP_SEEDS x MESH_SWEEP_EPOCHS at the
    default dispatch, rank_path 'kernel', each against the one-card sweep
    of the same seeds: every seed's losses, metrics and best checkpoint bit
    for bit, or within the spread of two one-card runs (phase 14's rule);
    one wide rank and 11 gate launches a seed's validation, none in the
    steps. Returns the two mesh sweeps' launches."""
    from laff_tpu_torch.engine import sweep as S
    from laff_tpu_torch.engine import trainer as T
    from laff_tpu_torch.engine.prepare import Options
    from laff_tpu_torch.parallel import seed_data_mesh

    t_phase = time.perf_counter()
    base = dict(trainCollection="strain", valCollection="sval", rootpath=root, val_set="no",
                config_name="rehearsal", num_epochs=MESH_SWEEP_EPOCHS, batch_size=128,
                device="cuda", rank_path="kernel")
    seeds = list(MESH_SWEEP_SEEDS)
    t0 = time.perf_counter()
    one = S.sweep_main(Options(model_prefix="mesh_one_card", **base), seeds)
    walls = {"one_card": time.perf_counter() - t0}
    n_val = len(seeds) * MESH_SWEEP_EPOCHS
    expect = {"sim_rank_wide": n_val, "sim_rank_tiled": 0,
              "gate_attention": n_val * SWEEP_VAL_GATE_CALLS, "gate_attention_simple": 0}
    launches, found = {}, {}
    for layout in MESH_SWEEP_LAYOUTS:
        with world_of_one() as mesh:
            sweep_mesh = mesh if layout == "seed" else seed_data_mesh(1, 1)
            if layout != "seed":
                check(sweep_mesh.shape == {"seed": 1, "dp": 1},
                      f"[mesh sweep] {layout}: the mesh's shape {sweep_mesh.shape}")
            K.reset_launches()
            t0 = time.perf_counter()
            got = S.sweep_main(Options(model_prefix=f"mesh_{layout}", **base), seeds,
                               mesh=sweep_mesh)
            torch.cuda.synchronize()
            walls[layout] = time.perf_counter() - t0
            launches[layout] = dict(K.LAUNCHES)
        check(launches[layout] == expect, f"[mesh sweep] {layout}: launches "
              f"{launches[layout]}, expected one rank and {SWEEP_VAL_GATE_CALLS} gate launches "
              f"per seed's validation, none in the steps: {expect}")
        check([os.path.basename(r["model_path"]) for r in got]
              == [f"mesh_{layout}_seed_{s}" for s in seeds],
              f"[mesh sweep] {layout}: results {[r['model_path'] for r in got]}")
        found[layout] = sweep_spread_check(
            torch, T, f"mesh sweep {layout}", got, one,
            lambda: T.main(Options(model_prefix="mesh_one_again", random_seed=seeds[0], **base)))
    log(f"[mesh sweep] (16) sweep_main over an NCCL group of one, {len(seeds)} seeds x "
        f"{MESH_SWEEP_EPOCHS} epoch on strain -> sval: "
        + "; ".join(f"{layout}: " + ("each seed's losses, metrics and best checkpoint equal the "
                                     "one-card sweep's bit for bit" if f[0] else
                                     f"within the spread of two one-card runs {f[2]}")
                    for layout, f in found.items())
        + f"; walls {({k: round(v, 1) for k, v in walls.items()})} s; launches {launches} "
        f"[{smi}]")
    log(f"mesh sweep phase (16): {time.perf_counter() - t_phase:.1f} s")
    return launches


# -- --multi: four ranks ----------------------------------------------------

def sign_rows(torch, gen, n, device):
    """``n`` rows of +-1/64 (unit rows whose l2 norm is exact in any order of
    summation), bf16."""
    r = torch.randint(0, 2, (n, HD), generator=gen, device=device, dtype=torch.int8)
    return (r.to(torch.bfloat16) * 2 - 1) / 64


def rank_counts(mesh, counts):
    """Every rank's ``counts``, in rank order (rank 0 reads them)."""
    import torch.distributed as dist

    out = [None] * mesh.size
    dist.all_gather_object(out, counts)
    return out


def multi_sim_phase(torch, mesh, smi):
    """(a) sim_engine over the four cards. The ranks at the MV-test3k shape
    (59,800 x 2,990 x 4,096, f32; 20 captions a video; the gallery's rows
    duplicated across each shard boundary) against one card's flat ranks
    (evaluator.t2v_ranks), exactly; the top 1,000 of 512 queries over an
    iacc.3-sized bf16 gallery (335,944 x 4,096, 2.75 GB: 0.69 GB a card;
    duplicates across the boundaries, and queries equal to them) and of its
    int8 rows against one card's top k in the port's order, exactly. Gallery
    rows are +-1/64 codes, so their l2 normalization is exact on either side
    and only the sharding is compared. ms a call against one card's."""
    import numpy as np

    from laff_tpu_torch.engine.evaluator import t2v_ranks
    from laff_tpu_torch.ops import flatten_heads, int8_scores, quantize_rows
    from laff_tpu_torch.parallel import sim_engine as E

    dev, main = mesh.device, mesh.is_main
    out = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    vis = sign_rows(torch, gen, MV_V, dev).float()
    shard = -(-MV_V // mesh.size)
    for b in range(shard, MV_V, shard):  # four equal rows straddle each boundary
        vis[b - 2:b + 2] = vis[b - 2]
    gt = torch.arange(MV_T, device=dev) // MV_CAPS
    txt = 0.03 * vis[gt] + torch.randn((MV_T, HD), generator=gen, device=dev) / 64
    local, v = E.shard_gallery(vis, mesh)
    ranks = E.sharded_t2v_ranks(txt, local, gt, mesh, v)
    ms = time_ms(torch, lambda: E.sharded_t2v_ranks(txt, local, gt, mesh, v), reps=3)
    if main:
        vis_ids = [str(i) for i in range(MV_V)]
        txt_ids = [f"{g}#{i}" for i, g in enumerate(gt.tolist())]
        ref = t2v_ranks(txt, vis, txt_ids, vis_ids, rank_path="flat")
        one_ms = time_ms(torch, lambda: t2v_ranks(txt, vis, txt_ids, vis_ids,
                                                  rank_path="flat"), reps=3)
        tied = int((ranks[(gt >= shard - 2).cpu().numpy() & (gt < shard + 2).cpu().numpy()]
                    > 1).sum())
        check(np.array_equal(ranks, ref), f"[multi a] sharded_t2v_ranks differs from one card's "
              f"flat ranks on {int((ranks != ref).sum())} captions")
        out["ranks"] = {"ms": ms, "one_card_ms": one_ms}
        log(f"[multi a] sharded_t2v_ranks at {MV_T} x {MV_V} x {HD} over {mesh.size} cards: "
            f"{int((ranks != ref).sum())} captions rank otherwise than on one card's flat path "
            f"(R@1 {100 * float((ranks == 1).mean()):.2f}; "
            f"{tied} captions of the boundary's duplicated videos rank behind a tied copy): "
            f"{ms:.3f} ms a call against {one_ms:.3f} ms on one card [{smi}]")
    mesh.barrier()
    del vis, txt, local

    # the iacc.3-sized gallery: every rank draws it in the same chunks and keeps its slab
    chunk = 32768
    rows = []
    for c0 in range(0, AVS_SHOTS, chunk):
        g = torch.Generator(device=dev).manual_seed(SEED + 30 + c0 // chunk)
        rows.append(sign_rows(torch, g, min(chunk, AVS_SHOTS - c0), dev))
    gallery = torch.cat(rows)
    del rows
    shard = -(-AVS_SHOTS // mesh.size)
    for b in range(shard, AVS_SHOTS, shard):
        gallery[b - 2:b + 2] = gallery[b - 2]
    q = torch.randn((MULTI_QUERIES, HD), generator=gen, device=dev)
    for i, b in enumerate(range(shard, AVS_SHOTS, shard)):
        q[i] = gallery[b - 2].float()
    local, v = E.shard_gallery(gallery, mesh)
    local = local.clone()
    if not main:
        del gallery
    vq, vs = quantize_rows(flatten_heads(local))
    calls = {"topk": lambda: E.sharded_topk(q, local, MULTI_K, mesh, v),
             "int8": lambda: E.sharded_int8_topk(q, vq, vs, MULTI_K, mesh, v)}
    got = {name: fn() for name, fn in calls.items()}
    times = {name: time_ms(torch, fn, reps=3) for name, fn in calls.items()}
    if main:
        tn = flatten_heads(q).float()
        vn = flatten_heads(gallery)
        fq, fs = quantize_rows(vn)
        tq, ts = quantize_rows(tn)
        blocks = {"topk": lambda s, e: tn @ vn[s:e].float().T,
                  "int8": lambda s, e: int8_scores(tq, ts, fq[s:e], fs[s:e])}
        for name, block in blocks.items():
            ref = one_card_topk(torch, tn, block, AVS_SHOTS, MULTI_K)
            vals, idx = got[name]
            same = np.array_equal(vals, ref[0]) and np.array_equal(idx, ref[1])
            check(same, f"[multi a] sharded {name} differs from one card's top {MULTI_K}: "
                  f"{int((idx != ref[1]).sum())} places, scores within "
                  f"{float(np.abs(vals - ref[0]).max()):.3g}")
            ties = int((np.diff(vals[:mesh.size - 1], axis=1) == 0).sum())
            one_ms = time_ms(torch, lambda: one_card_topk(torch, tn, block, AVS_SHOTS, MULTI_K),
                             reps=3)
            out[name] = {"ms": times[name], "one_card_ms": one_ms}
            kind = "int8" if name == "int8" else "bf16"
            log(f"[multi a] sharded_{'int8_' if name == 'int8' else ''}topk: {MULTI_QUERIES} "
                f"queries, top {MULTI_K} of {AVS_SHOTS} x {HD} ({kind}; "
                f"{local.numel() * local.element_size() / 1e9:.2f} GB of bf16 a card): equal to "
                f"one card's lists in the port's order: {same} ({ties} tied places among the "
                f"boundary queries): {times[name]:.2f} ms a call against {one_ms:.2f} ms on one "
                f"card")
        del vn, fq, fs
    mesh.barrier()
    return out


def served_lists_agree(got, want, tol):
    """(ok, places that differ, max score distance): ids equal but at near
    ties (within ``tol`` of a neighbour in ``want``), scores within ``tol``."""
    moved, err, ok = 0, 0.0, True
    for row_g, row_w in zip(got, want):
        vals = [s for _, s in row_w]
        for i, ((id_g, s_g), (id_w, s_w)) in enumerate(zip(row_g, row_w)):
            err = max(err, abs(s_g - s_w))
            if id_g != id_w:
                moved += 1
                ok = ok and near_tie(vals, i, tol)
    return ok and err <= tol and len(got) == len(want), moved, err


def multi_serve_phase(torch, K, mesh, root, ckpt, smi):
    """(b) RetrievalService(mesh=) over iacc.3 on the four cards, bf16 and
    int8, against the one-card service (rank 0, card 0) on the BERT
    checkpoint's 512 btrain captions: searches at buckets 1 (k 10) and 512
    (k 1,000), an ingest of 1,024 copies, a restart from the snapshot rank 0
    wrote (bit for bit); the builds and searches timed. Returns rank 0's
    figures and every rank's launches."""
    import numpy as np

    from laff_tpu_torch.engine import service as S
    from laff_tpu_torch.store import BigFile

    main = mesh.is_main
    with open(os.path.join(root, "btrain", "TextData", "btrain.caption.txt")) as fh:
        queries = [line.split(" ", 1)[1] for line in fh.read().splitlines()[:MULTI_QUERIES]]
    asks = ((1, 10), (MULTI_QUERIES, MULTI_K))
    snap = os.path.join(WORK, "multi_gallery.npz")
    cap = AVS_SHOTS + SERVE_INGEST
    out, launches = {}, {}

    def timed(svc):
        return {f"b{b}": time_ms(torch, lambda: svc.search(queries[:b], k=k), reps=3)
                for b, k in asks}

    def ingest(svc, src):
        feats = {name: BigFile(os.path.join(root, AVS_COLLECTION, "FeatureData",
                                            name)).gather(src)[1]
                 for name in svc.config.vid_feats}
        t0 = time.perf_counter()
        svc.add_videos([f"ingested_{i}" for i in range(SERVE_INGEST)], feats)
        return time.perf_counter() - t0

    def session(svc, src=None):
        """Searches, an ingest of copies of ``src`` (by default the top
        videos of the first 8 queries) and a search after it."""
        res = {f"b{b}": svc.search(queries[:b], k=k) for b, k in asks}
        if src is None:
            first = [row[0][0] for row in svc.search(queries[:8], k=1)]
            src = [first[i % len(first)] for i in range(SERVE_INGEST)]
        res["src"] = src
        res["ingest_s"] = ingest(svc, src)
        res["after"] = svc.search(queries, k=MULTI_K)
        check(any(i.startswith("ingested_") for row in res["after"] for i, _ in row),
              "[multi b] the ingested copies are not found")
        return res

    # bf16 over the mesh, snapshotted; every rank embeds its slab
    K.reset_launches()
    t0 = time.perf_counter()
    svc = S.RetrievalService(ckpt, root, AVS_COLLECTION, capacity=cap, gallery_cache=snap,
                             mesh=mesh)
    build_s = time.perf_counter() - t0
    launches["build"] = rank_counts(mesh, dict(K.LAUNCHES))
    if main:
        got = session(svc)
        times = timed(svc)
        svc.close()
    else:
        svc.follow()
    del svc
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    svc = S.RetrievalService(ckpt, root, AVS_COLLECTION, capacity=cap, gallery_cache=snap,
                             mesh=mesh)
    restart_s = time.perf_counter() - t0
    if main:
        check(service_lists_equal([svc.search(queries, k=MULTI_K)], [got[f"b{MULTI_QUERIES}"]]),
              "[multi b] the restart from the snapshot differs")
        svc.close()
    else:
        svc.follow()
    del svc
    if main:  # one card's service, the same session
        t0 = time.perf_counter()
        one = S.RetrievalService(ckpt, root, AVS_COLLECTION, capacity=cap,
                                 device=str(mesh.device))
        one_build_s = time.perf_counter() - t0
        ref = session(one, got["src"])
        one_times = timed(one)
        del one
        for key in (*(f"b{b}" for b, _ in asks), "after"):
            ok, moved, err = served_lists_agree(got[key], ref[key], MULTI_TIE)
            check(ok, f"[multi b] bf16 {key}: {moved} places differ from one card's beyond "
                  f"near ties, scores within {err}")
        out["bf16"] = {"build_s": build_s, "restart_s": restart_s, "one_card_build_s":
                       one_build_s, "ingest_s": got["ingest_s"],
                       "one_card_ingest_s": ref["ingest_s"], "search_ms": times,
                       "one_card_search_ms": one_times}
        log(f"[multi b] bf16 gallery of {AVS_SHOTS} over {mesh.size} cards built in "
            f"{build_s:.1f} s (one card {one_build_s:.1f} s; phase 13's 10.1-12.8 s), restarted "
            f"from rank 0's snapshot in {restart_s:.1f} s; a search {times['b1']:.2f} ms at "
            f"bucket 1 and {times[f'b{MULTI_QUERIES}']:.2f} ms at {MULTI_QUERIES} (one card "
            f"{one_times['b1']:.2f} and {one_times[f'b{MULTI_QUERIES}']:.2f}); ingest of "
            f"{SERVE_INGEST} {got['ingest_s']:.2f} s; lists equal one card's but near ties "
            f"({MULTI_TIE}); build launches by rank {launches['build']} [{smi}]")
    mesh.barrier()
    torch.cuda.empty_cache()

    # int8 over the mesh against one card's
    K.reset_launches()
    t0 = time.perf_counter()
    svc = S.RetrievalService(ckpt, root, AVS_COLLECTION, gallery_dtype="int8", capacity=cap,
                             mesh=mesh)
    int8_build_s = time.perf_counter() - t0
    launches["int8_build"] = rank_counts(mesh, dict(K.LAUNCHES))
    if main:
        got8 = {f"b{b}": svc.search(queries[:b], k=k) for b, k in asks}
        svc.close()
    else:
        svc.follow()
    del svc
    if main:
        one = S.RetrievalService(ckpt, root, AVS_COLLECTION, gallery_dtype="int8", capacity=cap,
                                 device=str(mesh.device))
        for b, k in asks:
            ok, moved, err = served_lists_agree(got8[f"b{b}"], one.search(queries[:b], k=k),
                                                MULTI_TIE)
            check(ok, f"[multi b] int8 bucket {b}: {moved} places differ from one card's "
                  f"beyond near ties, scores within {err}")
        del one
        out["int8"] = {"build_s": int8_build_s}
        log(f"[multi b] int8 gallery over {mesh.size} cards built in {int8_build_s:.1f} s; lists "
            f"equal one card's but near ties")
    for rank, counts in enumerate(launches["build"]):
        check(counts["gate_attention"] >= 1, f"[multi b] rank {rank} embedded no slab: {counts}")
    mesh.barrier()
    torch.cuda.empty_cache()
    return out, launches


def multi_predict_phase(torch, K, P, mesh, root, ckpt, smi):
    """(c) predictor.main with data_parallel 4 on rtest (the rehearsal
    model's seeded weights, rank_path 'kernel'): every card runs the gate on
    its rows and rank 0 alone runs the wide rank kernel; the metrics against
    one card's run at the per-card batch (256 rows a call, so the towers'
    GEMMs have the same shapes), within MULTI_METRIC_TOL, and the TSV rows
    written once."""
    import dataclasses

    import numpy as np

    opt = P.PredictOptions(testCollection="rtest", model_path=ckpt, sim_name="multi_dp",
                           rootpath=root, query_sets="rtest.caption.txt", overwrite=1,
                           device=str(mesh.device), rank_path="kernel",
                           data_parallel=mesh.size,
                           predict_result_file=os.path.join(root, "result_log", "multi_dp.txt"))
    K.reset_launches()
    t0 = time.perf_counter()
    res = P.main(opt, mesh=mesh).get("rtest.caption.txt")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rank_counts(mesh, dict(K.LAUNCHES))
    out = {}
    if mesh.is_main:
        for rank, counts in enumerate(launches):
            check(counts["gate_attention"] >= 1 and (counts["sim_rank_wide"] >= 1) == (rank == 0),
                  f"[multi c] rank {rank} launched {counts}")
        one_opt = dataclasses.replace(opt, sim_name="multi_one", data_parallel=0,
                                      batch_size=opt.batch_size // mesh.size,
                                      predict_result_file=os.path.join(root, "result_log",
                                                                       "multi_one.txt"))
        t0 = time.perf_counter()
        one = P.main(one_opt)["rtest.caption.txt"]
        one_wall = time.perf_counter() - t0
        for key in ("t2v", "v2t"):
            diff = float(np.abs(np.asarray(res[key]) - np.asarray(one[key])).max())
            check(diff <= MULTI_METRIC_TOL, f"[multi c] {key} {res[key]} against one card's "
                  f"{one[key]}")
        moved = int((np.asarray(res["t2v_ranks"]) != np.asarray(one["t2v_ranks"])).sum())
        for side in ("TextToVideo", "VideoToText"):
            with open(os.path.join(root, "result_log", side, "multi_dp.txt")) as fh:
                rows = fh.read().splitlines()
            check(len(rows) == 1, f"[multi c] {side} holds {len(rows)} rows of the run")
        out = {"wall_s": wall, "one_card_wall_s": one_wall, "ranks_moved": moved,
               "seconds": res["seconds"]}
        log(f"[multi c] predictor data_parallel {mesh.size} on rtest: {wall:.1f} s (one card at "
            f"{one_opt.batch_size} a call {one_wall:.1f} s); t2v r1 {res['t2v'][0]:.3f} mir "
            f"{res['t2v'][5]:.5f}, metrics within {MULTI_METRIC_TOL} of one card's, {moved} "
            f"ranks differ; the rows written once; launches by rank {launches} [{smi}]")
    mesh.barrier()
    return out, launches


class LosingReduce:
    """A control fault for (d): the mesh of a run whose gradient all-reduce
    loses the last rank's share (that rank zeroes its buffer first)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def all_reduce(self, t):
        if self.mesh.rank == self.mesh.size - 1:
            t.zero_()
        return self.mesh.all_reduce(t)


@contextlib.contextmanager
def f32_towers():
    """Inside, ``prepare.load_config`` gives configs with float16 off: f32
    towers, as the CPU parity tests run them."""
    from laff_tpu_torch.engine import prepare as PR

    load = PR.load_config

    def load_f32(name, parm="None"):
        config = load(name, parm)
        config.float16 = False
        return config

    PR.load_config = load_f32
    try:
        yield
    finally:
        PR.load_config = load


def first_dispatch(run):
    """Epoch 0's stream of a ``trainer.TrainRun`` after its first dispatch,
    the dispatch's losses and the parameters before and after it."""
    before = {n: p.detach().clone() for n, p in run.model.named_parameters()}
    run.begin_epoch(0)
    stream = run.epoch_stream(0)
    stream.advance()
    first = stream.pending[0].detach().cpu()
    after = {n: p.detach().clone() for n, p in run.model.named_parameters()}
    return stream, first, before, after


def held_against(first, params, init, ref):
    """A data-parallel first dispatch against one card's: the losses'
    largest relative distance, then per tensor (worst first) the largest
    distance of its largest magnitude, the distance in norm of one card's
    update in norm, and its name."""
    rel = float(((first - ref["first"]).abs() / ref["first"].abs()).max())
    errs = []
    for n, p in params.items():
        one = ref["params"][n]
        upd = float((one - init[n]).norm())
        errs.append((float((p - one).abs().max() / one.abs().max()),
                     float((p - one).norm()) / upd if upd else 0.0, n))
    return rel, sorted(errs, reverse=True)


def rest_of_epoch(torch, run, stream):
    """(ms a step over the epoch's later dispatches, loss, steps)."""
    torch.cuda.synchronize()
    t0, steps0 = time.perf_counter(), stream.n
    while stream.advance():
        pass
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / max(1, stream.n - steps0)
    loss, steps = run.finish_stream(stream)
    return step_ms, loss, steps


def one_card_grads(run):
    """The gradient of the run's last step, per parameter tensor (copies)."""
    flat = run.optimizer.grad.detach().clone()
    sizes = [p.numel() for p in run.optimizer.params]
    views = dict(zip(map(id, run.optimizer.params), flat.split(sizes)))
    return {n: views[id(p)].view_as(p) for n, p in run.model.named_parameters()
            if id(p) in views}


def noise_tensors(grads, f32_grads):
    """{name: ratio} of the tensors whose gradient is rounding noise: one
    card's bf16 gradient further than MULTI_NOISE_RATIO of the f32 one's
    norm from it (the same seed and batches), and the largest ratio kept."""
    ratios = {}
    for n, g in grads.items():
        ref = f32_grads[n].float()
        base = float(ref.norm())
        dist = float((g.float() - ref).norm())
        ratios[n] = dist / max(base, 1e-30)
    noise = {n: r for n, r in ratios.items() if r > MULTI_NOISE_RATIO}
    kept = max((r for n, r in ratios.items() if n not in noise), default=0.0)
    return noise, kept


def dispatch_against_one_card(torch, mesh, tag, opt, prepared, what, smi, timed=False,
                              control=False, f32_grads=None, loss_limit=MULTI_LOSS_RTOL,
                              hold=True):
    """A data-parallel ``TrainRun(mesh=mesh)`` after its first dispatch,
    against one card's run of ``opt`` (made by the mesh's rank 0 on its card
    while the others wait): the dispatch's losses within ``loss_limit``
    relative; each parameter tensor within MULTI_PARAM_TOL ('f32' towers) or
    MULTI_PARAM_TOL_BF16 of its largest and MULTI_UPDATE_TOL_BF16 of one
    card's update in norm ('bf16': the tensors that the dispatch's Adam
    steps made left out, and with ``f32_grads``, one card's gradients of
    the 'f32' reading, those whose gradient is rounding noise); the ranks'
    parameters equal bit for bit. With ``timed`` one card's epoch is timed,
    with ``control`` a run whose all-reduce loses a rank's share is read
    too, and must miss the limits. ``hold=False`` reads without holding.
    Returns (run, stream, figures, one card's gradients on rank 0)."""
    import dataclasses

    from laff_tpu_torch.engine import trainer as T

    main = mesh.is_main
    ref, grads = {}, None
    if main:  # one card first, the others wait
        one = T.TrainRun(dataclasses.replace(opt, data_parallel=0,
                                             model_prefix=f"{opt.model_prefix}_one_{tag}"),
                         prepared, mesh.device)
        t0 = time.time()
        one_stream, ref["first"], _, ref["params"] = first_dispatch(one)
        grads = one_card_grads(one)
        made = 2 * len(ref["first"]) * float(one.optimizer.lr)  # 2 K lr
        ref["made"] = {n for n, p in ref["params"].items() if float(p.abs().max()) <= made}
        if timed:
            ref["step_ms"] = rest_of_epoch(torch, one, one_stream)[0]
            ref["epoch_s"] = time.time() - t0
        one.close()
        del one, one_stream
        torch.cuda.empty_cache()
    mesh.barrier()
    run = T.TrainRun(dataclasses.replace(opt, model_prefix=f"{opt.model_prefix}_{tag}"),
                     prepared, mesh.device, mesh=mesh)
    stream, first, init, params = first_dispatch(run)
    flat = torch.cat([p.flatten() for p in params.values()])
    replicas = mesh.all_gather(flat[None])
    same = all(torch.equal(replicas[0], r) for r in replicas[1:])
    del replicas, flat
    figures = {"replicas_equal": same}
    limit = MULTI_PARAM_TOL if tag == "f32" else MULTI_PARAM_TOL_BF16
    update_limit = float("inf") if tag == "f32" else MULTI_UPDATE_TOL_BF16
    noise, noise_kept = {}, None
    if main and tag == "bf16" and f32_grads is not None:
        noise, noise_kept = noise_tensors(grads, f32_grads)

    def held(name):
        return tag == "f32" or (name not in ref["made"] and name not in noise)

    if main:
        rel, errs = held_against(first, params, init, ref)
        kept = [e for e in errs if held(e[2])]
        left_out = sorted(set(n for *_, n in errs) - set(n for *_, n in kept))
        figures.update(loss_rel=rel, loss_limit=loss_limit, first_losses=first.tolist(),
                       one_card_first_losses=ref["first"].tolist(),
                       param_worst=errs[:5], tensors=len(errs), limit=limit,
                       left_out=left_out, noise={n: noise[n] for n in sorted(noise)},
                       noise_ratio_kept_worst=noise_kept,
                       kept_worst=kept[:5], kept_worst_norm=max(e[1] for e in kept),
                       norm_worst=sorted(kept, key=lambda e: e[1], reverse=True)[:3],
                       tensors_over=sum(e[0] > limit for e in kept),
                       one_card_step_ms=ref.get("step_ms"),
                       one_card_epoch_s=ref.get("epoch_s"))
        log(f"[{what}] {tag} towers, data_parallel {mesh.size} at global B {opt.batch_size}: "
            f"the first dispatch's {len(first)} losses within {rel:.3g} of one card's "
            f"({first.tolist()} against {ref['first'].tolist()}; limit {loss_limit}); "
            f"{figures['tensors_over']} of "
            f"{len(kept)} parameter tensors held further than {limit} of their largest from "
            f"one card's (worst held {[(f'{e:.3g}', f'{u:.3g}', n) for e, u, n in kept[:5]]}, "
            f"largest distance in norm of one card's update {figures['kept_worst_norm']:.3g} "
            f"({[(f'{u:.3g}', f'{e:.3g}', n) for e, u, n in figures['norm_worst']]}); "
            f"{len(errs) - len(kept)} left out: {left_out}, of which as rounding noise "
            f"{[(n, f'{r:.3g}') for n, r in sorted(noise.items())]} (the largest ratio kept "
            f"{noise_kept if noise_kept is None else f'{noise_kept:.3g}'}); worst of all "
            f"{[(f'{e:.3g}', n) for e, _, n in errs[:3]]}); the ranks' parameters equal bit "
            f"for bit: {same} [{smi}]")
        if hold:
            check(rel <= loss_limit, f"[{what}] {tag}: the first dispatch's losses "
                  f"{rel:.3g} relative from one card's (limit {loss_limit})")
            check(kept[0][0] <= limit, f"[{what}] {tag}: {kept[0][2]} after the first "
                  f"dispatch {kept[0][0]:.3g} of its largest from one card's (limit {limit})")
            check(figures["kept_worst_norm"] <= update_limit, f"[{what}] {tag}: a tensor "
                  f"after the first dispatch {figures['kept_worst_norm']:.3g} of one card's "
                  f"update in norm from one card's (limit {update_limit})")
    check(same, f"[{what}] {tag}: the ranks' parameters differ after the first dispatch")
    if control:
        ctl = T.TrainRun(dataclasses.replace(opt, model_prefix=f"{opt.model_prefix}_ctl_{tag}"),
                         prepared, mesh.device, mesh=mesh)
        ctl.optimizer.mesh = LosingReduce(mesh)
        ctl_stream, ctl_first, ctl_init, ctl_params = first_dispatch(ctl)
        ctl.close()
        del ctl, ctl_stream
        if main:
            rel, errs = held_against(ctl_first, ctl_params, ctl_init, ref)
            kept = [e for e in errs if held(e[2])]
            figures["control"] = {"loss_rel": rel, "kept_worst": kept[:5],
                                  "kept_worst_norm": max(e[1] for e in kept),
                                  "tensors_over": sum(e[0] > limit for e in kept),
                                  "caught": (rel > loss_limit or kept[0][0] > limit
                                             or max(e[1] for e in kept) > update_limit)}
            log(f"[{what}] {tag} control, the all-reduce losing rank {mesh.size - 1}'s "
                f"share: losses within {rel:.3g} of one card's; "
                f"{figures['control']['tensors_over']} of {len(kept)} held tensors further "
                f"than {limit} (worst {[(f'{e:.3g}', f'{u:.3g}', n) for e, u, n in kept[:5]]},"
                f" largest distance in norm {figures['control']['kept_worst_norm']:.3g}); "
                f"caught by the checks: {figures['control']['caught']}")
            if hold:
                check(figures["control"]["caught"], f"[{what}] {tag}: the control run, whose "
                      f"all-reduce loses a rank's share, meets the limits")
        del ctl_params, ctl_init
        torch.cuda.empty_cache()
        mesh.barrier()
    return run, stream, figures, grads


def multi_train_phase(torch, K, mesh, root, smi):
    """(d) the trainer with data_parallel 4 on rtrain -> rtest (rehearsal,
    global B 128: 32 rows a card, K 8 graphed, dropout on). The first
    dispatch against one card's run from the same seed and batches (rank 0
    alone first), twice: with f32 towers, where its 8 losses must lie within
    1e-4 relative and every parameter tensor within 1e-4 of its largest; and
    in the config's bf16, where the losses must lie within 1e-4 and the
    parameters within MULTI_PARAM_TOL_BF16 of their largest and
    MULTI_UPDATE_TOL_BF16 of one card's update in norm (each card rounds its
    partial gradient sums to bf16 before the all-reduce, and Adam turns that
    rounding into steps of lr: the CPU probe of PERF.md §6).
    The bf16 limit leaves out the tensors that the dispatch made, those
    whose largest magnitude on one card is within 2 K lr of zero (they start
    at zero, so their largest is Adam's steps alone), and those whose
    gradient is rounding noise (MULTI_NOISE_RATIO). A control run whose
    gradient all-reduce loses the last rank's share is read the same way and
    must miss the limits.
    The ranks' parameters must be equal bit for bit after each. Then the
    bf16 run goes on: two epochs (the loss falls, R@1 above chance), ms per
    graphed step against one card's, the all-reduce of the flat gradients
    timed, a profiled dispatch; then one epoch at 128 a card (global 512).
    Returns rank 0's figures and every rank's launches of the two
    epochs."""
    import dataclasses

    from laff_tpu_torch.engine import trainer as T
    from laff_tpu_torch.engine.prepare import Options

    main = mesh.is_main
    opt = Options(trainCollection="rtrain", valCollection="rtest", rootpath=root,
                  val_set="no", config_name="rehearsal", num_epochs=2,
                  batch_size=MULTI_BATCH, device=str(mesh.device), rank_path="kernel",
                  random_seed=SEED, model_prefix="multi", data_parallel=mesh.size)
    out = {}

    # f32 towers: the parameters held tensor by tensor
    opt32 = dataclasses.replace(opt, model_prefix="multi32")
    with f32_towers():
        prepared32 = T.prepare_ranks(opt32, mesh)
    run32, stream32, out["f32"], grads32 = dispatch_against_one_card(
        torch, mesh, "f32", opt32, prepared32, "multi d", smi)
    run32.close()
    del run32, stream32, prepared32
    torch.cuda.empty_cache()

    # the config's bf16: the comparison, then two epochs
    prepared = T.prepare_ranks(opt, mesh)
    K.reset_launches()
    run, stream, figures, _ = dispatch_against_one_card(
        torch, mesh, "bf16", opt, prepared, "multi d", smi, timed=True, control=True,
        f32_grads=grads32)
    del grads32
    try:
        t_epoch = time.time()
        step_ms, loss, steps = rest_of_epoch(torch, run, stream)
        epoch_s = time.time() - t_epoch
        step_launches = dict(K.LAUNCHES)
        stopped = run.end_epoch(0, loss, steps, epoch_s)
        run.begin_epoch(1)
        t0 = time.time()
        loss1, steps1 = run.train_epoch(1)
        run.end_epoch(1, loss1, steps1, time.time() - t0)
        check(stopped is False, "[multi d] the run stopped after one epoch")
        # the all-reduce of the flat gradient buffer alone, and a profiled dispatch
        buf = torch.zeros_like(run.optimizer.grad)
        allreduce_ms = time_ms(torch, lambda: mesh.all_reduce(buf), reps=10)
        run.begin_epoch(2)
        stream = run.epoch_stream(2)
        spans, nccl_spans, prof_wall = profiled_spans(torch, stream.advance)
        while stream.advance():
            pass
        run.finish_stream(stream)
    finally:
        run.close()
    history = run.results["history"]
    launches = rank_counts(mesh, {"steps": step_launches, "two_epochs": dict(K.LAUNCHES)})
    if main:
        losses = [e["loss"] for e in history]
        busy, nccl_ms = union_ms(spans), union_ms(nccl_spans) / 8
        idle = 1 - busy / prof_wall if spans else None
        # the profiler stretches the dispatch: its busy ms a step against the
        # unprofiled graphed step too
        step_idle = 1 - busy / 8 / step_ms if spans else None
        out["bf16"] = {**figures, "step_ms": step_ms, "allreduce_ms": allreduce_ms,
                       "graph_nccl_ms_a_step": nccl_ms if spans else None, "idle": idle,
                       "idle_of_step": step_idle,
                       "busy_ms": busy, "profiled_wall_ms": prof_wall,
                       "epoch_s": epoch_s, "history": history, "launches": launches}
        log(f"[multi d] bf16: a graphed step {step_ms:.2f} ms against "
            f"{figures['one_card_step_ms']:.2f} ms on one card; epoch 0 "
            f"{epoch_s:.1f} s of steps after the first dispatch (one card's whole epoch "
            f"{figures['one_card_epoch_s']:.1f} s); losses {[round(x, 4) for x in losses]}, R@1 "
            f"{[round(e['r1'], 3) for e in history]}; the flat gradients' all-reduce "
            f"({buf.numel() * 4 / 1e6:.0f} MB) {allreduce_ms:.3f} ms; a profiled dispatch "
            + (f"{busy:.2f} ms covered by its {len(spans)} non-NCCL kernels (the union of their "
               f"intervals) in {prof_wall:.2f} ms, idle {idle:.1%} ({busy / 8:.2f} ms a step: "
               f"idle {step_idle:.1%} of the unprofiled step); its {len(nccl_spans)} NCCL "
               f"kernels cover {nccl_ms:.3f} ms a step (spin-waits included)"
               if spans else "recorded no device time (not measured)")
            + f"; launches by rank {launches} [{smi}]")
        check(losses[1] < losses[0] and history[1]["r1"] > 100.0 / 2990,
              f"[multi d] two epochs: losses {losses}, R@1 {history[1]['r1']}")
        for rank, counts in enumerate(launches):
            check(counts["steps"]["gate_attention"] == 0 and counts["steps"]["sim_rank_wide"] == 0,
                  f"[multi d] rank {rank}'s steps launched {counts['steps']}")
            # every card embeds its rows; rank 0 alone ranks
            check(counts["two_epochs"]["gate_attention"] >= 2
                  and (counts["two_epochs"]["sim_rank_wide"] >= 2) == (rank == 0),
                  f"[multi d] rank {rank}'s validations launched {counts['two_epochs']}")
    mesh.barrier()

    # one epoch at 128 a card
    wide = dataclasses.replace(opt, batch_size=MULTI_BATCH * mesh.size, num_epochs=1,
                               model_prefix="multi_wide")
    res = T.main(wide, prepared=T.prepare_ranks(wide, mesh), mesh=mesh)
    if main:
        e = res["history"][0]
        check(e["loss"] == e["loss"], "[multi d] the global-512 epoch's loss is NaN")
        out["wide_epoch"] = {k: e[k] for k in ("loss", "steps", "train_seconds", "val_seconds",
                                               "r1")}
        log(f"[multi d] one epoch at {MULTI_BATCH} a card (global {wide.batch_size}): "
            f"{e['steps']} steps in {e['train_seconds']:.2f} s (capture included), validation "
            f"{e['val_seconds']:.2f} s, loss {e['loss']:.4f}, R@1 {e['r1']:.3f}")
    return out, launches


def multi_seed_axis_phase(torch, K, mesh, root, smi):
    """(e) the seed axis over the four cards: sweep_main(mesh=) of
    MULTI_RANKS seeds x 2 epochs on strain -> sval at full width (K 8
    graphed, rank_path 'kernel'), one seed a card, against the one-card
    sweep of the same seeds run on card 0 first (the others wait): each
    seed's losses, metrics and best checkpoint bit for bit, or within the
    spread of two one-card runs (phase 14's rule); every card launches the
    wide rank kernel and the gate (one rank and 11 gate launches a
    validation, none in the steps); the walls and ms per graphed step.
    Returns rank 0's figures and every rank's launches."""
    import dataclasses

    from laff_tpu_torch.engine import sweep as S
    from laff_tpu_torch.engine import trainer as T
    from laff_tpu_torch.engine.prepare import Options

    seeds = [SEED + i for i in range(mesh.size)]
    opt = Options(trainCollection="strain", valCollection="sval", rootpath=root, val_set="no",
                  config_name="rehearsal", num_epochs=SWEEP_EPOCHS, batch_size=MULTI_BATCH,
                  device=str(mesh.device), rank_path="kernel", model_prefix="multi_e")
    out = {}
    if mesh.is_main:  # one card first, the others wait
        t0 = time.perf_counter()
        one = S.sweep_main(dataclasses.replace(opt, model_prefix="multi_e_one"), seeds)
        torch.cuda.synchronize()
        out["one_card_wall_s"] = time.perf_counter() - t0
        for r in one:
            r["model"] = None
        torch.cuda.empty_cache()
    mesh.barrier()
    K.reset_launches()
    t0 = time.perf_counter()
    got = S.sweep_main(opt, seeds, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rank_counts(mesh, dict(K.LAUNCHES))
    if mesh.is_main:
        check([os.path.basename(r["model_path"]) for r in got]
              == [f"multi_e_seed_{s}" for s in seeds],
              f"[multi e] results {[r['model_path'] for r in got]}")
        exact, diffs, spread = sweep_spread_check(
            torch, T, "multi e", got, one,
            lambda: T.main(dataclasses.replace(opt, model_prefix="multi_e_again",
                                               random_seed=seeds[0])))
        steps = one[0]["history"][-1]["steps"]
        step_ms = [1e3 * r["history"][-1]["train_seconds"] / steps for r in got]
        one_ms = 1e3 * one[0]["history"][-1]["train_seconds"] / (len(seeds) * steps)
        n_val = SWEEP_EPOCHS
        expect = {"sim_rank_wide": n_val, "sim_rank_tiled": 0,
                  "gate_attention": n_val * SWEEP_VAL_GATE_CALLS, "gate_attention_simple": 0}
        for rank, counts in enumerate(launches):
            check(counts == expect, f"[multi e] rank {rank} launched {counts}, expected one "
                  f"seed's validations on its card: {expect}")
        out.update(seeds=seeds, exact=exact, diffs=diffs, spread=spread, mesh_wall_s=wall,
                   mesh_step_ms=step_ms, one_card_seed_step_ms=one_ms, steps_per_epoch=steps,
                   launches=launches)
        log(f"[multi e] sweep_main over {mesh.size} cards, seeds {seeds} x {SWEEP_EPOCHS} "
            f"epochs of {steps} steps on strain -> sval: "
            + ("each seed's losses, metrics and best checkpoint equal the one-card sweep's "
               "bit for bit" if exact else f"within the spread of two one-card runs {spread}")
            + f"; the mesh sweep {wall:.1f} s against {out['one_card_wall_s']:.1f} s for the "
            f"one-card sweep of the {len(seeds)} seeds; a graphed step "
            f"{[round(v, 2) for v in step_ms]} ms on each card (the second epoch) against "
            f"{one_ms:.2f} ms a seed-step on one card; launches by rank {launches} [{smi}]")
        del one, got
    mesh.barrier()
    return out, launches


def multi_seed_dp_phase(torch, K, world, layout, root, smi):
    """(f) the seed x dp layout (``seed_data_mesh(2, 2)``): 2 seeds, each at
    global B MULTI_BATCH over its row of 2 cards. Each row's
    ``TrainRun(mesh=row)`` (the sweep's run of its seed) read after its first
    dispatch as (d) reads it, under (d)'s parameter limits, against that
    seed's one-card run (made by the row's first card while its other
    waits), with f32 towers and in the config's bf16, where the losses are
    held to MULTI_ROW_LOSS_RTOL_BF16 and a control run whose all-reduce
    loses the row's second card's share must miss the limits. Then (d)'s
    reading of seed 0 over all four cards on this world, read and not held
    (a witness: does the bf16 drift come from the world or from the rows?).
    Then sweep_main(mesh=layout) for one epoch: both seeds' results on world
    rank 0, the wide rank kernel on each row's first card alone and the gate
    on every card. Returns rank 0's figures and every rank's launches."""
    import dataclasses

    from laff_tpu_torch.engine import sweep as S
    from laff_tpu_torch.engine import trainer as T
    from laff_tpu_torch.engine.prepare import Options

    row, index = layout.row, layout.seed_index
    seeds = [SEED + i for i in range(layout.n_seed)]
    opt = Options(trainCollection="strain", valCollection="sval", rootpath=root, val_set="no",
                  config_name="rehearsal", num_epochs=1, batch_size=MULTI_BATCH,
                  device=str(row.device), rank_path="kernel", model_prefix="multi_f")
    mine = S.seed_options(opt, seeds)[index]
    out, grads32 = {}, None
    for tag in ("f32", "bf16"):
        with (f32_towers() if tag == "f32" else contextlib.nullcontext()):
            prepared = T.prepare_ranks(mine, world)
        bf16 = tag == "bf16"
        run, stream, figures, grads = dispatch_against_one_card(
            torch, row, tag, mine, prepared, f"multi f row {index}", smi, control=bf16,
            f32_grads=grads32, loss_limit=MULTI_ROW_LOSS_RTOL_BF16 if bf16 else MULTI_LOSS_RTOL)
        if not bf16:
            grads32 = grads
        run.close()
        del run, stream, prepared, grads
        torch.cuda.empty_cache()
        readings = world.gather_object(figures)
        if world.is_main:
            out[tag] = readings[::row.size]  # each row's first card read its seed
        world.barrier()
    # world rank 0 is row 0's first card: grads32 is seed 0's
    witness = dataclasses.replace(S.seed_options(opt, seeds)[0], model_prefix="multi_f_4x1")
    prepared = T.prepare_ranks(witness, world)
    run, stream, figures, _ = dispatch_against_one_card(
        torch, world, "bf16", witness, prepared, "multi f 4x1", smi, f32_grads=grads32,
        hold=False)
    run.close()
    del run, stream, prepared, grads32
    torch.cuda.empty_cache()
    if world.is_main:
        out["witness_4x1"] = figures
    world.barrier()
    K.reset_launches()
    t0 = time.perf_counter()
    got = S.sweep_main(opt, seeds, mesh=layout)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rank_counts(world, dict(K.LAUNCHES))
    if world.is_main:
        check([os.path.basename(r["model_path"]) for r in got]
              == [f"multi_f_seed_{s}" for s in seeds],
              f"[multi f] results {[r['model_path'] for r in got]}")
        check(all(e["loss"] == e["loss"] and e["r1"] > 100.0 / 500 for r in got
                  for e in r["history"]), f"[multi f] {[r['history'] for r in got]}")
        for rank, counts in enumerate(launches):
            first = rank % row.size == 0
            check(counts["gate_attention"] == SWEEP_VAL_GATE_CALLS
                  and counts["sim_rank_wide"] == int(first),
                  f"[multi f] rank {rank} launched {counts}: the gate on every card, the wide "
                  f"rank kernel on each row's first card alone")
        out.update(seeds=seeds, sweep_wall_s=wall, launches=launches,
                   history=[[{k: e[k] for k in ("loss", "r1", "mir", "train_seconds")}
                             for e in r["history"]] for r in got])
        log(f"[multi f] sweep_main over seed_data_mesh({layout.n_seed}, {layout.n_dp}), "
            f"seeds {seeds}: {wall:.1f} s for one epoch; {out['history']}; launches by rank "
            f"{launches} [{smi}]")
    world.barrier()
    return out, launches


def multi_rank(mesh, root, ckpt, bert_ckpt, smi):
    """One of the four ranks of ``--multi``: phases (d), (a), (c), (b), (e)
    and (f) in turn, every rank in each; rank 0 checks and returns the
    figures."""
    import torch

    from laff_tpu_torch.engine import predictor as P
    from laff_tpu_torch.ops import kernels as K
    from laff_tpu_torch.parallel import seed_data_mesh

    global DEFERRED
    DEFERRED = []
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    laps, out = {}, {}
    # the trainer first: its CUDA graph captures NCCL collectives, the step
    # most likely to fail
    t0 = time.perf_counter()
    out["train"], train_launches = multi_train_phase(torch, K, mesh, root, smi)
    laps["d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["sim_engine"] = multi_sim_phase(torch, mesh, smi)
    laps["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["predict"], predict_launches = multi_predict_phase(torch, K, P, mesh, root, ckpt, smi)
    laps["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["serve"], serve_launches = multi_serve_phase(torch, K, mesh, root, bert_ckpt, smi)
    laps["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["seed_axis"], seed_launches = multi_seed_axis_phase(torch, K, mesh, root, smi)
    laps["e"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    layout = seed_data_mesh(2, MULTI_RANKS // 2)
    out["seed_x_dp"], seed_dp_launches = multi_seed_dp_phase(torch, K, mesh, layout, root, smi)
    laps["f"] = time.perf_counter() - t0
    out["seconds"] = laps
    out["launches_by_rank"] = {"multi_serve_build": serve_launches["build"],
                               "multi_serve_int8_build": serve_launches["int8_build"],
                               "multi_predict": predict_launches,
                               "multi_train": [c["two_epochs"] for c in train_launches],
                               "multi_seed_axis": seed_launches,
                               "multi_seed_x_dp": seed_dp_launches}
    if mesh.is_main:
        log(f"[multi] phases: {', '.join(f'{k} {v:.1f} s' for k, v in laps.items())}")
        log(json.dumps({"multi": out}, default=float))
    if DEFERRED:
        raise SmokeFailure("; ".join(DEFERRED))
    return out


def multi_only(torch, smi):
    """``--multi``: phases 1 and 15 (a)-(d) over four cards, one rank each
    through ``laff_tpu_torch.parallel.launch`` (the kernels and the native
    featurizer built here first). The worlds (rtrain, rtest, btrain and
    iacc.3) and the two seeded checkpoints are written here, then the four
    ranks run; any rank's failure fails the run."""
    from laff_tpu_torch.data.synth import build_avs_world, build_world
    from laff_tpu_torch.engine.checkpoint import save_checkpoint
    from laff_tpu_torch.engine.prepare import init_checkpoint
    from laff_tpu_torch.parallel import launch

    count = torch.cuda.device_count()
    check(count >= MULTI_RANKS, f"--multi needs {MULTI_RANKS} cards, {count} visible")
    shutil.rmtree(WORK, ignore_errors=True)
    root = os.path.join(WORK, "world")
    t0 = time.perf_counter()
    build_world(root, "rtrain", 1500, 20, 11286, SEED + 2)
    build_world(root, "rtest", 2990, 20, 11286, SEED)
    for coll, n, caps, seed in BERT_WORLDS[:1] + SWEEP_WORLDS[:2]:
        build_world(root, coll, n, caps, 11286, seed)
    checkout = os.path.join(WORK, "bert_checkout")
    write_bert_checkout(torch, checkout, ["the"] + [f"w{i:05d}" for i in range(11286)])
    os.environ["LAFF_TPU_BERT_CHECKOUT"] = checkout  # the ranks inherit it
    build_avs_world(root, AVS_COLLECTION, AVS_SHOTS, AVS_EDITIONS[:1], AVS_TOPICS,
                    seed=SEED + 8)
    ckpt = os.path.join(WORK, "rtest_model.pt")
    save_checkpoint(init_checkpoint("rehearsal", root, "rtest", SEED), ckpt)
    bert_ckpt = os.path.join(WORK, "btrain_bert_model.pt")
    save_checkpoint(init_checkpoint("bert_rehearsal", root, "btrain", SEED), bert_ckpt)
    log(f"[multi] worlds rtrain, rtest, btrain, strain, sval and {AVS_COLLECTION} ({AVS_SHOTS} "
        f"shots), a seeded BERT-base checkout and two checkpoints in "
        f"{time.perf_counter() - t0:.1f} s")
    try:
        multihost_phase(smi)
        t0 = time.perf_counter()
        try:
            out = launch(MULTI_RANKS, multi_rank, root, ckpt, bert_ckpt, smi)
        except Exception as e:  # noqa: BLE001 - a rank's failure, reported as the run's
            raise SmokeFailure(f"[multi] a rank failed: {e}") from e
        log(f"[multi] {MULTI_RANKS} ranks in {time.perf_counter() - t0:.1f} s (spawn, NCCL "
            f"set-up and phases (a)-(f)); rank 0's figures: {sorted(out)}")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)


def multihost_phase(smi):
    """(g) ``cli/multihost_smoke.py`` over the four cards: MULTI_RANKS
    worker processes joined through ``parallel.initialize_multihost`` from
    torchrun's variables (NCCL), its three checks (the sharded ranks and top
    k against numpy, the data-parallel trainer against one process, the
    resume guard on split roots)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "laff_tpu_torch.cli.multihost_smoke",
                           "--procs", str(MULTI_RANKS), "--workdir", WORK], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    tail = "\n".join(proc.stdout.strip().splitlines()[-3:])
    log(f"[multi g] multihost_smoke over {MULTI_RANKS} processes (torchrun's variables, NCCL): "
        f"rc {proc.returncode} in {wall:.1f} s; {tail} [{smi}]")
    if proc.returncode != 0:
        log(proc.stdout[-20000:] + proc.stderr[-4000:])
    check(proc.returncode == 0 and "multihost smoke: PASS" in proc.stdout,
          f"[multi g] multihost_smoke failed (rc {proc.returncode})")


def ptxas_table(text):
    """{function: (registers, spill store bytes, spill load bytes)} from a
    ``-Xptxas -v`` build log; gate ring kernels named by their template
    arguments, gate_ring_kernel<LMAX, CPL, MUL, AVE>."""
    import re

    table, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )(\S+?)'?(?: |$)",
                      line)
        if m:
            fn = m.group(1)
            ring = re.search(r"gate_ring_kernelILi(\d+)ELi(\d+)ELb([01])ELb([01])E", fn)
            if ring:
                fn = "gate_ring_kernel<{}, {}, {}, {}>".format(*ring.groups())
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        regs = re.search(r"Used (\d+) registers", line)
        if fn and spill:
            table[fn] = (table.get(fn, (0,))[0], int(spill.group(1)), int(spill.group(2)))
        elif fn and regs:
            table[fn] = (int(regs.group(1)), *table.get(fn, (0, 0, 0))[1:])
    return table


def log_build(logs):
    """Each kernel's registers and spills a thread from the build logs; fails
    if a gate ring kernel that the L 4 or L 5 route launches (CPL 4: LMAX 4
    or 8) spills."""
    for name, text in logs.items():
        for fn, (regs, stores, loads) in ptxas_table(text).items():
            log(f"  {name}: {fn}: {regs} registers, spill stores {stores} B, loads {loads} B")
            check(not (fn.startswith(("gate_ring_kernel<4, 4,", "gate_ring_kernel<8, 4,"))
                       and stores + loads),
                  f"{fn} spills {stores} + {loads} bytes on the gate's main path")


def gate_worker(torch, root):
    """Times the gate of the checkout at ``root`` (its own wrapper, sources
    and build) at (L, H 8, dh 512) for L 4 (the LAFF-ml towers) and 5
    (FrameLAFF's video tower), each of GATE_BATCHES and GATE_OPTIONS, and at
    (B 1,024, L 16, H 1, dh 1024), an edge shape on the multi-pass
    instantiation, after holding it against its plain version."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from laff_tpu_torch.ops import kernels as K

    check(os.path.abspath(K.__file__).startswith(root + os.sep),
          f"imported {K.__file__}, not the package under {root}")
    log_build(K.build_kernels())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    g = torch.tensor(0.8, device="cuda")
    rows = []
    shapes = [(b, l, 8, 512) for l in (4, 5) for b in GATE_BATCHES] + [(1024, 16, 1, 1024)]
    for b, l, h, dh in shapes:
        x, k, bias = gate_inputs(torch, gen, b, l, h, dh)
        n_bytes = (x.numel() + k.numel() + bias.numel() + b * h * dh) * 4
        what = f"gate (B={b}, L={l}, H={h}, dh={dh})"
        for with_ave, mul in GATE_OPTIONS:
            got = K.fused_gate_attention(x, k, bias, g, with_ave, mul)
            err = float((got - K.fused_gate_attention_plain(x, k, bias, g, with_ave, mul))
                        .abs().max())
            check(err <= GATE_TOL, f"{root}: {what} with_ave={with_ave} mul={mul}: "
                  f"max err {err}")
            row = {"b": b, "l": l, "h": h, "dh": dh, "with_ave": with_ave, "mul": mul,
                   "max_abs_err": err, "bound_ms": n_bytes / PEAK_BYTES_S * 1e3,
                   **gate_times(torch, K, x, k, bias, g, with_ave, mul)}
            share = ("" if row["device_ms"] is None
                     else f" ({row['bound_ms'] / row['device_ms']:.0%} of the bound)")
            log(f"{root}: {what} with_ave={with_ave} mul={mul}: device "
                f"{fmt_ms(row['device_ms'])} ms{share}, call {row['ms']:.4f} ms, {GATE_RUN} "
                f"back to back {row['run_ms']:.4f} ms per call, max abs err {err:.3g}")
            rows.append(row)
    log("gate_timing " + json.dumps({"root": root, "rows": rows}))


def tiled_worker(torch, t, v, hd):
    """The tiled rank kernel's device time at (t, v, hd), one call in a
    profiler session in a fresh process, on seeded bf16 unit rows with the
    ground truths spread over the gallery: a 'tiled_device' JSON line."""
    sys.path.insert(0, ROOT)
    from laff_tpu_torch.ops import kernels as K

    K.build_kernels()
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def unit_rows(n):
        out = torch.empty((n, hd), dtype=torch.bfloat16, device="cuda")
        for s in range(0, n, 65536):
            x = torch.randn(min(65536, n - s), hd, generator=gen, device="cuda")
            out[s:s + x.shape[0]] = x / x.norm(dim=-1, keepdim=True)
        return out

    tn, vn = unit_rows(t), unit_rows(v)
    gt = torch.randint(0, v, (t,), generator=gen, device="cuda", dtype=torch.int32)
    check(not K.is_wide(v, hd), "the worker's shape takes the wide kernel")
    device = device_ms(torch, lambda: K.fused_sim_rank(tn, vn, gt, prenormalized=True), reps=1)
    check(K.LAUNCHES["sim_rank_tiled"] == 2, f"the worker launched {K.LAUNCHES}")
    log("tiled_device " + json.dumps(device))


def gate_timing(roots):
    """Each checkout's gate in its own process, in the order given: to hold
    two trees against each other on one card, unpack the other under build/
    and pass it, this tree, this tree, it."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    log(smi.stdout.strip() or f"nvidia-smi gave nothing: {smi.stderr.strip()}")
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--gate-worker", root],
                              capture_output=True, text=True, timeout=900)
        sys.stdout.write(proc.stdout)
        sys.stdout.flush()
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
    return 0


def main(argv):
    import torch

    if not os.path.isdir(os.path.join(ROOT, "laff_tpu_torch")):
        print("chip_smoke: laff_tpu_torch/ is not beside chip_smoke.py", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if argv[:1] == ["--gate-timing"] and len(argv) > 1:
        return gate_timing(argv[1:])
    if argv[:1] == ["--gate-worker"] and len(argv) == 2:
        try:
            gate_worker(torch, argv[1])
        except SmokeFailure as e:
            print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
            return 1
        return 0
    if argv[:1] == ["--tiled-worker"] and len(argv) == 4:
        try:
            tiled_worker(torch, *map(int, argv[1:]))
        except SmokeFailure as e:
            print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
            return 1
        return 0
    only_bert_serve = argv == ["--bert-serve"]
    only_sweep = argv == ["--sweep"]
    only_multi = argv == ["--multi"]
    if argv and not (only_bert_serve or only_sweep or only_multi):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        smi_line = (smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else
                    f"nvidia-smi gave nothing: {smi.stderr.strip()}")
        log(smi_line)
        log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda "
            f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)}; "
            f"tf32 off for matmul and cuDNN")

        from laff_tpu_torch import native
        from laff_tpu_torch.data.synth import build_world
        from laff_tpu_torch.engine import predictor as P
        from laff_tpu_torch.engine.checkpoint import save_checkpoint
        from laff_tpu_torch.engine.prepare import init_checkpoint
        from laff_tpu_torch.ops import kernels as K

        t0 = time.perf_counter()
        check(native.get_fastfeat() is not None,
              "the native featurizer (laff_tpu_torch/native/fastfeat.cpp) did not build or load")
        log(f"native featurizer: {native.library_path()} loaded in "
            f"{time.perf_counter() - t0:.1f} s (built from the checkout when absent)")

        t0 = time.perf_counter()
        logs = K.build_kernels()
        log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs) or 'cached'}")
        log_build(logs)

        if only_bert_serve:
            bert_serve_only(torch, K, P, smi_line)
            log(f"total {time.perf_counter() - t_start:.1f} s")
            return 0
        if only_sweep:
            sweep_only(torch, K, P, smi_line)
            log(f"total {time.perf_counter() - t_start:.1f} s")
            return 0
        if only_multi:
            multi_only(torch, smi_line)
            log(f"total {time.perf_counter() - t_start:.1f} s")
            print(ok_line(torch))
            return 0
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        rows = {
            "sim_rank_wide": sim_rank_phase(torch, K, "sim_rank_wide", 59_800, 2_990, 20, gen),
            "sim_rank_tiled": sim_rank_phase(torch, K, "sim_rank_tiled", 8_192, 16_384, 0, gen),
            "gate_attention": gate_phase(torch, K, gen),
        }
        # FrameLAFF's video tower fuses 5 locals: the gate at L 5
        gate_l5 = gate_phase(torch, K, gen, l=5)
        # the gt pass's cost with ground truths on every gallery tile
        sim_rank_phase(torch, K, "sim_rank_wide", 59_800, 2_990, 0, gen)
        sim_rank_edge_phase(torch, K, gen)
        gate_edge_phase(torch, K, gen)

        shutil.rmtree(WORK, ignore_errors=True)
        root = os.path.join(WORK, "world")
        t0 = time.perf_counter()
        log(f"world: {build_world(root, 'rtest', 2990, 20, 11286, SEED)} "
            f"in {time.perf_counter() - t0:.1f} s")
        ckpt = os.path.join(WORK, "rtest_model.pt")
        save_checkpoint(init_checkpoint("rehearsal", root, "rtest", SEED), ckpt)

        native.reset_calls()
        t0 = time.perf_counter()
        res_k, launches_k = run_predictor(torch, K, P, root, "rtest", ckpt, "kernel")
        log(f"host speed marker: the rtest kernel prediction pass took "
            f"{time.perf_counter() - t0:.1f} s of wall")
        calls = dict(native.CALLS)
        check(min(calls.values()) > 0, f"the prediction pass made no native featurizer call: "
              f"{calls}")
        log(f"  the text featurization of that pass ran in the native fastfeat: {calls} batches")
        check(launches_k["sim_rank_wide"] >= 1, "the kernel run launched no sim_rank_wide")
        check(launches_k["gate_attention"] >= 1, "the kernel run launched no gate_attention")
        check(launches_k["gate_attention_simple"] == 0,
              "the main path's gate shapes took the simple gate kernel")
        mesh_one = {}
        gpu_txt, gpu_vis, txt_feed, vis_feed, model = reembed_and_check(
            torch, K, P, root, "rtest", ckpt, res_k, flat=True,
            resident=lambda *embs: mesh_one.update(mesh_one_sim_phase(torch, *embs)))
        tower_profile(torch, model, txt_feed, vis_feed)
        cpu_reference_check(torch, P, ckpt, txt_feed, vis_feed, gpu_txt, gpu_vis)

        t0 = time.perf_counter()
        log(f"world: {build_world(root, 'rbig', 8600, 2, 11286, SEED + 1)} "
            f"in {time.perf_counter() - t0:.1f} s")
        big = os.path.join(WORK, "rbig_model.pt")
        save_checkpoint(init_checkpoint("rehearsal", root, "rbig", SEED + 1), big)
        _, launches_b = run_predictor(torch, K, P, root, "rbig", big, "kernel")
        check(launches_b["sim_rank_tiled"] >= 1, "the large-gallery run launched no tiled kernel")
        check(launches_b["sim_rank_wide"] == 0, "the large-gallery run took the wide kernel")

        t0 = time.perf_counter()
        launches_t, launches_tp, trained = train_phase(torch, K, P, root, smi_line)
        log(f"training phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches_f, launches_fp, frames_ckpt = frame_phase(torch, K, P, root, smi_line)
        log(f"FrameLAFF phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches_s = strongclip_phase(torch, K, P, root, {**frames_ckpt,
                                                          "launches": launches_fp}, smi_line)
        log(f"StrongCLIP phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches_c, launches_cp = concat_phase(torch, K, P, smi_line)
        zoo_phase(torch, K, trained, smi_line)
        launches_h = hist_phase(torch, K, trained, smi_line)
        launches_r = interchange_phase(torch, K, P, root, trained, smi_line)
        log(f"single-space and interchange phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        by_path_aux = aux_phase(torch, K, P, root, smi_line)
        log(f"task3, task2 and post-processing phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches_bt, launches_bp, bert_ckpt = bert_phase(torch, K, P, root, smi_line)
        log(f"BERT phase (12): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches_m1 = mesh_one_serve_phase(torch, K, root, bert_ckpt, smi_line)
        log(f"mesh phase (15, with 15(a) in phase 3: {mesh_one['sim_engine_s']:.1f} s): "
            f"{time.perf_counter() - t0 + mesh_one['sim_engine_s']:.1f} s")
        t0 = time.perf_counter()
        launches_sw, launches_ot, per_predict = sweep_phase(torch, K, P, root, smi_line)
        log(f"sweep phase (14 (a)-(b)): {time.perf_counter() - t0:.1f} s")
        launches_ms = mesh_sweep_phase(torch, K, root, smi_line)
        t0 = time.perf_counter()
        launches_avs, (by_path_large, tiled_ibench), by_path_serve, launches_sa = avs_phase(
            torch, K, P, root, trained["ckpt_path"], smi_line,
            serve=lambda: serve_phase(torch, K, root, bert_ckpt, smi_line),
            sweep_avs=lambda random_infap: sweep_avs_phase(torch, K, root, random_infap,
                                                           smi_line))
        log(f"AVS, large gallery and serving phases: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches_e = end2end_phase(torch, K, root, smi_line)
        log(f"End2EndClip phase: {time.perf_counter() - t0:.1f} s")

        # launches of the main paths, each counted from 0 around its run:
        # the rtest prediction pass, the LAFF training run's validations and
        # its checkpoint's pass, FrameLAFF's, W2VVPP's, the 'hist'
        # validation's, the reference file's pass, task3's and task2's
        # validations, the negation-scored pass, the post-processing passes,
        # the streamed AVS query sets, and phase 9's ibench passes (cached,
        # the kernel branch) and int8 gallery, the StrongCLIP pass
        # and End2EndClip's validations, the BERT run's validations and its
        # checkpoint's pass, the service's gallery build and HTTP session
        # (searches and ingest), the seed sweep's validations, retrieval_task's
        # sweep and predictions, avs_task's streamed set, the services over
        # an NCCL group of one (phase 15) and the sweeps over one (phase 16);
        # the tiled kernel's paths are rbig and the kernel branch
        by_path = {"laff_predict": launches_k, "laff_train": launches_t,
                   "laff_trained_predict": launches_tp, "frames_train": launches_f,
                   "frames_trained_predict": launches_fp, "concat_train": launches_c,
                   "concat_trained_predict": launches_cp, "hist_validate": launches_h,
                   "reference_predict": launches_r, **by_path_aux, "avs_predict": launches_avs,
                   **by_path_large, "strongclip_predict": launches_s,
                   "end2end_train": launches_e, "bert_train": launches_bt,
                   "bert_trained_predict": launches_bp, **by_path_serve,
                   "mesh_one_serve": launches_m1,
                   "sweep_train": launches_sw, "orchestrate_train": launches_ot,
                   "orchestrate_predict": {k: sum(p[k] for p in per_predict)
                                           for k in per_predict[0]},
                   "avs_task_predict": launches_sa,
                   **{f"mesh_sweep_{k}": v for k, v in launches_ms.items()}}
        rows["gate_attention"]["at_l5"] = gate_l5
        rows["gate_attention"]["launches_by_l_frames"] = frames_ckpt["gate_by_l"]
        rows["sim_rank_tiled"]["at_ibench"] = tiled_ibench
        tiled_paths = {"rbig_predict": launches_b, "ibench_kernel_stream":
                       by_path_large["ibench_kernel_stream"]}
        meta = {
            "sim_rank_wide": ("laff_tpu_torch/csrc/sim_rank.cu",
                              "laff_tpu/ops/pallas_kernels.py:116", by_path),
            "sim_rank_tiled": ("laff_tpu_torch/csrc/sim_rank.cu",
                               "laff_tpu/ops/pallas_kernels.py:65", tiled_paths),
            "gate_attention": ("laff_tpu_torch/csrc/gate.cu",
                               "laff_tpu/ops/pallas_kernels.py:274", by_path),
        }
        kernels = []
        for name, (source, replaces, paths) in meta.items():
            counts = {p: v[name] for p, v in paths.items()}
            kernels.append({"name": name, "route": "cuda", "source": source,
                            "replaces": replaces, "launches": sum(counts.values()),
                            "launches_by_path": counts, **rows[name]})
        log(f"total {time.perf_counter() - t_start:.1f} s")
        log(json.dumps({"kernels": kernels}))
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(ok_line(torch))
    return 0


def ok_line(torch):
    return json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mlvae_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each reported on its own line; any failure exits non-zero:

1. the card and the kernel build (every ``mlvae_tpu_torch/csrc/*.cu``,
   compiled from this checkout, and the timing builds of K3-bwd, K4-bwd,
   K1-fwd and K3/K4-fwd, one ``nvcc`` per build in parallel), and the
   launch plan of the wide K1 builds (H above 528: K1-fwd, K1-bwd at B=64
   and 70, K1-bwd's dW_hh kernel) at H=1024, 768 and 640 in f32, and of
   the bf16 builds (the tensor-core K1-fwd and K1-bwd, and K1-bwd's dW_hh
   kernel) at H=1024, 640, 512, 384, 256 and 128, as their C code
   computes it (grid, threads,
   shared memory, blocks an SM holds, registers, local bytes: 0 for every
   build) against ``ops.k1_plan``, and likewise K5's builds
   in f32 and on bf16 streams (K5-fwd, K5-bwd at B=64 and 70, the bf16
   dW_hh kernel) at H=512, 208 and 528 against ``ops.gru.k5_plan``,
   and the K7 builds' (K7a in f32 and on bf16 streams, K7b on bf16
   streams; K 1, 2, 4, 8 at B 1 to 320) against
   ``ops.lstm_unroll_exp.k7a_plan`` / ``k7b_plan``, and the f32
   K3/K4-fwd and K7b build's (item slots, h ring, x slots, threads,
   shared memory, scratch) at every H from 16 to 528, In 4 to 2048, B 1
   to 1000 and K 1, 2, 4, 8 against ``ops.lstm.fused_f32_fwd_plan``, with
   its kernel's registers and local bytes;
2. each kernel against its plain PyTorch version on the card, at the
   slices' shapes (B=64, T=160, H=512; the fused kernels at In=128, 512
   and 1024 as the AMP step gives them; the MD-Viterbi decode K2, one
   launch a decode, bit-exact against the plain decode and lattice at L
   1 to 64 and T 1 to 2000, its choices kept in shared memory and read
   back from global memory; the filterbank K6 in its Kaldi
   mode at the Kaldi pass's B=256 x 325 frames and B=1, in its
   SpeechBrain mode at B=64 and B=1 x 160 frames, by its FFT build
   (``csrc/fbank_fft.cu``, which those widths take) and its DFT build
   (``csrc/fbank.cu``), and the DFT build at n_fft = 448, which takes it,
   with the FFT build's launch plan; the GRU kernels K5-fwd
   and K5-bwd in f32 and on bf16 streams, the tensor-core builds, also at
   H=128, 208 and 528, ragged B, T=1 and 2, and K5-bwd's bf16 dW_hh
   kernel on its own operands), plus ragged and edge cases, K1-fwd and
   K1-bwd again over many back-to-back launches (``--lstm-repeats``,
   ``--lstm-bwd-repeats``), the fused kernels over a few, K5 over 26 per
   kernel and direction (each bit-equal to the first of its dtype), K6
   over 20 per build and shape that must be bit-identical,
   and K6's two extractors with each build against the float64 golden on
   two short utterances; the K-unrolled LSTM forwards at the unroll
   bench's shape
   (B=128, T=160, H=512, In 512 and 128, K 2, 4, 8, both directions): K7a
   in f32 bit-equal to K1-fwd, K7a on bf16 streams bit-equal to the bf16
   K1-fwd (its tensor-core build), K7b bit-equal to K3/K4-fwd, the twins
   against the plain versions, the three builds and K7b on f32 streams
   bit-equal to their twins at B 63, 65, 200, 256, 320 (T=16 at each K;
   T=1 and 2) and over a few repeated launches, K7 at T=K, ragged B and
   narrower H against the plain versions (bf16 K7a refusing H=64), and a
   T that is not a multiple of K refused;
   K3-bwd and K4-bwd also at the JAX bench's B=256, at T=2 beside T=1,
   at B=320 (their serial schedule), and 50 repeated launches per
   direction each bit-equal to the first; K1-fwd and K3/K4-fwd also at
   ragged B (1, 63, 65, 70, 200), B=128 and 256, T=1 and T=2, K3/K4-fwd's
   serial schedule (B=320; In=4096), and 50 repeated launches per case
   and direction (K1-fwd at B=64 and 128, K3/K4-fwd at In=1024 B=64 and
   In=512 B=256) each bit-equal to the first; the wide K1-fwd and K1-bwd
   (``lstm_fwd_wide``, ``lstm_bwd_wide`` and its dW_hh kernel
   ``lstm_dw_wide``, which is also held against its plain version on its
   own operands) at H=1024, B=64, T=160, at H=768 and 640, ragged B (1,
   63, 65, 70), B=128, T=1 and 2, both directions, and 50 repeated
   launches of each per direction at
   H=1024, B=64, each bit-equal to the first; the wide builds on bf16
   streams (``lstm_fwd_wide_bf16``, ``lstm_bwd_wide_bf16`` and its dW_hh
   kernel ``lstm_dw_wide_bf16``) against the plain versions in bf16 at
   H=1024 and 640, B=64 and 70, B=1, T=1 and 2, both directions (hs and
   dgx bf16, cs and dW_hh f32, at the fused kernels' bf16 tolerances; the
   dW_hh kernel also against its plain version on its own operands), and
   repeated launches of each per direction at H=1024, B=64, each
   bit-equal to the first; the same bf16 builds at H = 128, 256, 384 and
   512, B = 1, 8, 24 and 64, T = 80 and 160, both directions, and 20
   repeated launches at H=512, B=64, T=80 (CRDNN_CTC's first LSTM layer
   under --bf16), each bit-equal to the first;
3. MD_VAE at the recipe's full width (H=512, B=64, T=160, L=8, weights
   from a seed) through the kernels: the TEST-target eval step (finite
   losses, decoded boundaries that sum to each utterance's phoneme count,
   launch counts of 10 K1-fwd / 1 K2 per forward, agreement with the same
   forward
   through the plain versions, one ``infer_features`` call at B=1); the
   wav-in path: ``infer`` on a written wav at B=1 (one verdict per
   phoneme, launches 1 K6 FFT build / 10 K1-fwd / 1 K2), a B=64 wav batch
   through ``Fbank(deltas=True)`` and the eval step against the same
   through the plain versions, the same waves through
   ``Fbank(n_fft=448)`` (one launch of K6's DFT build), and
   ``compute_kaldi_features`` over a small
   ``kaldi_data`` directory on the card against the CPU; then
   the f32 training step, two steps of each target (epochs 1, 2, 3:
   PHN_RECOG, B_DETECTOR, VAE): finite losses, launches per step, exactly
   the target's modules changed, the normalizer updated in epochs 1 and 2
   only, and each target's first step against the same step through the
   plain versions; then the same two steps per target under AMP (bf16,
   ``build_md_vae(bf16=True)``), whose launches take K3/K4 and never K1,
   whose parameters and optimizer states stay f32, and whose VAE step is
   also held against the f32 step from the same state and draws; then
   MD_VAE_sfl's VAE train step at full width (``bench_utils.build_md_vae(
   recipe="MD_VAE_sfl")``: five π samples, the Kaldi pass's features in),
   two steps: launches exact (26 K1-fwd, 22 K1-bwd, 1 K2), exactly the
   VAE branch's modules and ``baseline_fc`` moved, the first step's loss
   and each module's grad norm against the plain versions; then
   the BASELINE gate configs (``bench_utils.build_gate``): the GRU
   sequence VAE of gate 3 at full width (C=120, H=512, LAT=32, B=64,
   T=160), two f32 and two AMP steps, 3 K5-fwd and 3 K5-bwd launches a
   step (under AMP only the bf16 builds, and 3 of K5-bwd's dW_hh kernel),
   each first step against the same step through the plain
   versions and the AMP loss against the f32 loss, f32 parameters and
   Adam states under AMP; one step of each of gates 1, 2 and 4 on the
   card against the same step on the CPU; and the unroll A/B path
   (``mlvae_tpu_torch.tools.bench_lstm_unroll``) at B=128, T=160, H=512,
   In=512, K 2, 4, 8: every unrolled arm bit-equal to its twin, launch
   counts exact; and LSTM_FC at full width (input 120, H=1024, 4 layers,
   FC 1024-64-64-2, B=64, T=160, weights from seed 0,
   ``bench_utils.build_lstm_fc``): the TEST eval step (4 wide K1-fwd
   launches, logits and loss against the plain versions, frame-level MD
   scores) and two f32 training steps (4 + 4 + 4 wide launches a step:
   K1-fwd, K1-bwd and its dW_hh kernel; the
   first step's loss and grad norms against the plain versions, ``lstm``
   and ``fc`` moved); then its two AMP (bf16) training steps
   (``build_lstm_fc(bf16=True)``: 4 + 4 + 4 launches of the bf16 wide
   builds a step, K1-fwd, K1-bwd and its dW_hh kernel, and no f32 K1 or
   fused kernel, the first step against the plain
   versions and its loss against the f32 step's from the same state and
   draws, f32 parameters and Adam states); then the CLI path in a
   temporary directory, at the recipe's full width as a user runs it
   (``config/run.yaml``, the MD_VAE recipe, the synthesized SynAudioMNIST
   corpus, batches of 8): both feature passes (the Kaldi pass and the
   SpeechBrain pass, each one K6 launch a set), ``cli.train`` for three
   debug epochs of two batches (PHN_RECOG, B_DETECTOR, VAE, each with its
   VALID pass), ``cli.test`` from the best checkpoint and
   ``cli.infer.main`` on one utterance of the corpus, then ``cli.train
   --bf16`` (one epoch of each target): the launches of every stage exact
   (per train batch the train step's, per eval batch the eval forward's
   of the stage's target), each run held against the same run through the
   plain versions (each feature pass run again on the same wavs, every
   utterance's features within 2e-3; the epoch losses within 1e-4, 1e-3
   under --bf16, both runs on the kernel run's cached features; the
   TEST pass on the same checkpoint with the same decode, MD and boundary
   scores and saved MD results; the same verdicts), with the feature
   passes' seconds, and as smoke readings of these two-batch debug epochs
   (no profile) each epoch's wall and utterance-seconds a second, the
   evaluate restore/eval/write split and ``infer``'s milliseconds; then
   the same for the rest of the MD_VAE family in a second temporary
   directory, each through one turn of its cycle (MD_VAE_sfl three
   epochs on the Kaldi pass's features, MD_VAE_joint and MD_VAE_joint_ll
   one, MD_VAE_sfl_saved_phn_recog two, over posteriors the script
   writes), ``cli.test`` and ``cli.infer`` (not for saved_phn_recog),
   and MD_VAE_sfl's ``cli.train --bf16``, every stage's launches exact
   (``recipe_launches``) and each run held against the plain versions;
   then CRDNN_CTC at full width (CNN 128/256, four bidirectional LSTM
   layers at H=512, DNN 512, ``bench_utils.build_crdnn_ctc``, B=64,
   T=160, L=32): the f32 eval forward (8 K1-fwd), two f32 train steps (8
   K1-fwd, 8 K1-bwd) and two --bf16 steps (the first LSTM layer on K1 on
   bf16 streams: 2 + 2 + 2 of K1-fwd, K1-bwd and its dW_hh kernel; 6
   K3/K4-fwd and 6 K4-bwd), launches exact, ``crdnn`` and ``output``
   moved, the first step of each against the plain versions and the
   --bf16 loss against the f32 one; and the CLI path of CRDNN_CTC and
   CRDNN_CTC_cnncl (``cli.train``, one debug epoch, and ``cli.test``,
   whose greedy decodes, PERs, MD and boundary statistics and
   ``md_result_seqs.txt`` equal the plain run's), and CRDNN_CTC's
   ``cli.train --bf16``; then, in one more temporary directory, the CLI
   path of the five harness recipes and LSTM_FC at their recipes' widths
   (``cli.train``, one debug epoch, and ``cli.test``, each against the
   same through the plain versions: every stage's launches exact by
   ``recipe_launches``, epoch and VALID losses within 1e-4, TEST's
   ``test_metrics.txt`` and statistics equal), test_h_vae's and
   LSTM_FC's ``cli.train --bf16`` (within 1e-3; LSTM_FC at lr 0.001,
   ``BF16_CLI_EXTRA``), and HMM_DNN_ALI's ``cli.train`` and ``cli.test``
   with the ``forward`` and the ``viterbi`` training type on the card
   against the same on the CPU from the card run's weights (no kernel
   launched; losses within 1e-4; stored alignments and accuracy equal),
   with the phase's seconds; then the real corpora's data path in one
   more temporary directory (``run_cli_corpora``): corpora laid out as
   L2-ARCTIC (every speaker of its split, two utterances of 2-4 s),
   TIMIT (its waves as NIST SPHERE) and ChineseDPA
   (``data/corpus_layout.py``, seed 0); on L2-ARCTIC MD_VAE's
   ``cli.train`` (one debug epoch) and ``cli.test`` at the recipe's full
   width and LSTM_FC's ``cli.train`` with ``augmentation`` in the run
   YAML, each against the same through the plain versions; TIMIT's and
   ChineseDPA's ``prepare_experiment``; every corpus's two feature passes
   with K6's launches exact (one a set each, the SpeechBrain pass twice a
   set with augmentation) and against the plain versions; ``cli.ingest``
   over the TIMIT tree; then the six wav2vec2 recipes (``run_cli_w2v``,
   alone ``chip_w2v.py``), the encoder at wav2vec2-large-lv60's topology
   (24 layers, d=1024, random init from the seed): each recipe's
   ``cli.train`` (w2v_MD_VAE one cycle, the others one debug epoch) and
   the ``--bf16`` runs of w2v_MD_VAE and w2v_CRDNN_CTC (its H=32 LSTM on
   ``nn.rnn.lstm_scan``), against the same through the plain versions
   (w2v_LSTM_FC launches no kernel and has no plain run), every stage's
   launches exact; ``cli.test`` of w2v_MD_VAE and w2v_CRDNN_CTC; K1-fwd
   and K1-bwd at H=32 at that run's shapes against their plain versions;
   w2v_LSTM_FC's checkpoint with bf16 Adam moments read back bit for bit;
   cnncl's ``cli.test_on_three_sets`` and MD_VAE_sfl_saved_phn_recog's
   ``cli.train`` on its dump; ``cli.test_external`` on the card against
   the CPU; a frozen and a fine-tuned train step's times and profiles;
   then data parallelism, ZeRO-1 and the trunk's tensor parallelism
   (``run_parallel``), two ranks sharing the card over gloo through
   ``mlvae_tpu_torch.tools.parallel_step``: MD_VAE's VAE train step at
   full width (B=64 over two ranks) in f32 and under --bf16 against one
   process on the same batch and draws (loss within 1e-5; f32 parameters
   within rtol 1e-4 / atol 1e-5, --bf16 grad norms within 1e-2; the
   ranks bit-equal; each rank's launches those of one process at B=32),
   the same step at world size 1 over NCCL, the step under --zero1
   (parameters and moments bit-equal to replicated data parallelism,
   half the moments a rank), which collectives gloo takes on CUDA
   tensors (the port's collectives need all four), each rank's step
   alone on its rows without collectives (what sharing the card costs),
   the wav2vec2-large-lv60 trunk split
   over two ranks against the unsplit trunk (1e-4, f32, TF32 off) and
   one w2v_LSTM_FC training step, and ``cli.train`` / ``cli.test``
   --data_parallel --num_devices 2 with batches of 5; each rank's step
   times beside one process's, with the phase's seconds; then the run
   options (``run_options``): MD_VAE through ``cli.train`` (one target
   cycle, no --debug) and ``cli.test`` on a synthesized corpus of 8 x 24
   utterances of 2 to 7 digits (three padded shapes an epoch), once with
   --scan_epoch True --scan_chunk 2 --async_ckpt True
   --cache_device_batches True --profile True and once with the four
   off, f32 and --bf16: every epoch's TRAIN and VALID loss, the final
   checkpoint's arrays, TEST's decodes, statistics files and saved MD
   results held one against the other (equal, or within 1e-6 where a
   library GEMM rounds otherwise in a graph), the step graphs' captures
   and replays, every stage's kernel launches in the graph run by the
   profiler (epoch 1's TRAIN from its ``--profile`` trace, every other
   stage from a profiler window) against the same stage of the eager
   run by the wrappers, each run's peak memory, each epoch's wall time
   both ways; the same scanned run on one NCCL rank (--data_parallel
   True --num_devices 1) against one process; the w2v_MD_VAE
   frozen-trunk cache (two debug epochs, f32 and --bf16: the trunk in
   epoch 1 only, the cached features bit-equal to the step's, the
   losses against MLVAE_W2V_FROZEN_CACHE=0); w2v_LSTM_FC (the lv60 trunk
   fine-tuned) scanned and not, two epochs on the same corpus (graphs,
   peak memory, losses); the fine-tuned lv60 trunk at B=8 with 4 s of
   audio, its per-layer recompute on and off (the memory held before the
   step, at the peak of its forward and backward, when the update starts
   and at the update's peak; step ms in turns; the gradients one against
   the other); then ``fused_f32``, the fused tiers on f32 streams: the
   backwards' shared memory, schedules and scratch as their C code plans
   them against the CPU mirrors at every admitted (In, H) and B 1, 64, 70
   and 256, each backward kernel's registers and local memory, each f32
   build against its plain version at
   H=512 (K3/K4-fwd at In=128, 256 and 512, K3-bwd at In=128 (split-K)
   and 256 (the exchange schedule), K4-bwd at In=512; B=64, 1, 70 and
   256, T=160, 1 and 2, both directions; and the split-K builds at H=528
   and the exchange schedule at H=256, In=640; hs and cs within 1e-4,
   every backward output within 1e-4 of its largest entry), 10 repeated
   forward and 50 backward launches per case and direction bit-equal to
   the first, K3/K4-fwd on f32 streams alone at H 512 and 528, In 128,
   256, 512 and 640, B 1, 64, 70, 128, 256 and 320 (T=160), T 1 and 2,
   both directions (hs and cs within 1e-4), its two entries refusing a
   scratch one float short of their plan, K7b on f32 streams at K 2, 4,
   8 (B=128, In=512; phase 2 holds it at the K7 ragged batches too,
   beside the other K7 builds) bit-equal
   to K3/K4-fwd on f32 streams; MD_VAE at full width under ``MLVAE_PALLAS_FUSED=1`` (one f32
   train step of each target and the TEST eval forward against the plain
   versions, launches exact as reckoned from the JAX f32 budgets and
   pinned, which the layers' routes must give too: a VAE step 8
   K3/K4-fwd and 2 K1-fwd, 3 K3-bwd, 1 K4-bwd and 2 K1-bwd, 1 K2; the VAE
   loss against the default step's) and its AMP VAE step under ``=0``
   (only the bf16 K1 builds and K2); ``cli.train`` (one debug epoch a
   target) and ``cli.test`` in a process started with
   ``MLVAE_PALLAS_FUSED=1`` (this script with ``--fused-cli-child``),
   every stage's launches exact and each run against the plain versions,
   and ``cli.train`` with ``MLVAE_PALLAS_FUSED=ture`` exiting non-zero
   with the switch's ``ValueError``;
4. times from CUDA events after warm-up: each kernel, its plain version,
   a one-call PyTorch yardstick where one exists (cuFFT's rfft for K6, in
   turns with each build of K6 in SpeechBrain mode and on the Kaldi pass's
   batch: medians and spreads of ten samples each, and K6's factor; each
   build's kernel alone by the profiler), K2 a decode at B=64 and B=1 by
   CUDA events and by the profiler, with its microseconds a chain step,
   the eval step, the wav-in ``infer`` at B=1 (read and features, then
   the eval), the wav-in eval step at B=64, the Kaldi feature pass
   (``compute_kaldi_features`` over 256 written wav files, one batch,
   host clock), the f32 and AMP train steps of each target, the AMP VAE
   step at the JAX bench's B=256 (and its profile), MD_VAE_sfl's VAE
   train step (and its profile), K5-fwd and K5-bwd in
   f32 and on bf16 streams beside their bounds and plain versions, in
   turns with cuDNN's GRU layer of their dtype (medians and spreads;
   cuDNN's kernels alone, all and those launched every step),
   K5-bwd's dW_hh kernel beside one bf16
   ``torch.matmul`` of its operands, the gate-3 train step in f32 and
   under AMP (and a profile of each), K7a (f32, bf16) and
   K7b per K beside K1-fwd and K3/K4-fwd at B=128, their bounds, plain
   versions and cuDNN's LSTM layer, and the four redesigned K7 builds
   (K7b on f32 streams among them) in turns with their twins and cuDNN
   of the stream dtype, TF32 off (medians, spreads, us a step,
   cuDNN's kernels alone), K3-bwd (In 32, 128, 512) and K4-bwd
   (In 1024) at B=64 and K3-bwd In=512, K4-bwd at B=256 in turns with
   cuDNN's bf16 backward of the same layer (kernel, cuDNN, cuDNN, kernel,
   three rounds; medians and spreads; and cuDNN's profiled kernel time),
   K1-fwd (B=64, 128) and K3/K4-fwd (In 128, 512, 1024 at B=64 and 256)
   in turns with cuDNN's forward of the same layer likewise, the
   forwards' step timeline (``mlvae_tpu_torch.tools.bench_fwd_timeline``:
   microseconds a step of each phase, the timing builds bit-equal to the
   normal ones, the K7 builds beside their twins at the unroll bench's
   shape and bit-equal to them; and what a warp's 16-byte shared-memory
   read costs by pattern, ``mlvae_tpu_torch.tools.bench_smem_reads``),
   the backwards' step timeline
   (``mlvae_tpu_torch.tools.bench_bwd_timeline``: microseconds a step of
   each phase, and the ablation without or with
   half of the copies' L2 traffic; K5 in f32 and on bf16 streams),
   and profiles of one eval, one wav-in eval, one f32 and one AMP VAE
   train step; the
   wide K1-fwd and K1-bwd at H=1024 in turns with cuDNN's f32 layer, their
   plain versions and bounds, K1-bwd's dW_hh kernel beside one f32
   ``torch.matmul`` of its operands (TF32 off), LSTM_FC's eval and train
   steps (ms, utt-sec/sec) and a profile of each; the bf16 wide builds
   likewise in
   turns with cuDNN's bf16 layer, K1-bwd's dW_hh kernel beside one bf16
   ``torch.matmul`` of its operands, and LSTM_FC's AMP train step and its
   profile; the timelines include the wide builds' timing builds, f32 and
   bf16; CRDNN_CTC's eval forward and f32 and --bf16 train steps (ms,
   utt-sec/sec) with a profile of each step (kernel time, idle share),
   and the bf16 K1 at H=512, B=64, T=80 and 160 in turns with cuDNN's
   bf16 layer beside its plain version and bound; HMM_DNN_ALI's
   ``forward`` train step at B=64, T=160, L=16 (ms, utt-sec/sec) with a
   profile of one step (kernel time, idle share, kernel launches); the
   f32 fused builds at H=512, B=64, T=160 in turns with the unfused f32
   route and cuDNN's f32 layer (TF32 off), beside their bounds and plain
   versions, the backwards also at B=70 and 256, the backwards' timeline
   in the schedule each shape takes (K3 at In=256 the exchange schedule)
   and the forward's (the f32 rows of ``tools/bench_fwd_timeline.py``),
   and MD_VAE's f32 VAE step under
   ``MLVAE_PALLAS_FUSED=1``
   against the default in turns, with a profile of each;
5. a ``kernels`` JSON line, the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.

It needs a CUDA card and the repo around it; without either it exits 2
and prints no result. It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
MEM_BW = 3.35e12      # H100 SXM HBM3, bytes/s (data sheet)
F32_PEAK = 67e12      # H100 SXM f32 outside the tensor cores, FLOP/s
HOP_SEC = 0.02        # the JAX bench's utterance-seconds per frame

# tolerances, with their reasons
LSTM_ATOL = 1e-4      # f32 sums in another order, compounding over T=160
FWD_ATOL = 1e-3       # logits after 2 LSTM layers and 3 FCs, same cause
LOSS_RTOL = 1e-4      # the masked means of those per-element losses
LSTM_REPEATS = 60     # phase 2's repeated K1 launches per shape, direction
BWD_RTOL = 1e-4       # dW_hh: f32 sums of B*T = 10,240 terms in another order
GRAD_RTOL = 1e-3      # module grad norms after a backward through ten LSTM
                      # layers, the FCs and the clip, f32 in another order
LSTM_BWD_REPEATS = 50   # phase 2's repeated K1-bwd launches per direction
# K3/K4: the kernels round where their plain versions round, but an f32
# sum in another order can cross a bf16 rounding boundary, and a flipped
# h_t feeds every later step
FUSED_ATOL = 4e-3     # hs: one bf16 ulp at |h| < 1; cs (f32) drifts less
FUSED_BWD_RTOL = 1e-2  # K3-bwd, K4-bwd outputs, of their largest entry: a
                      # dgates one bf16 ulp off in a sum of In or 4H terms
FUSED_REPEATS = 10    # phase 2's repeated launches per fused kernel, shape
                      # and direction
FUSED_BWD_REPEATS = 50   # phase 2's repeated K3-bwd / K4-bwd launches per
                         # direction, each bit-equal to the first
FWD_BIT_REPEATS = 50   # phase 2's repeated K1-fwd / K3/K4-fwd launches per
                       # case and direction, each bit-equal to the first
# the fused backwards beside cuDNN's bf16 backward of one layer, timed in
# turns (kernel, cuDNN, cuDNN, kernel) in phase 4: (kernel, In, B); T=160,
# H=512
BWD_YARD_CASES = (("lstm_fused_bwd", 32, 64), ("lstm_fused_bwd", 128, 64),
                  ("lstm_fused_bwd", 512, 64), ("lstm_semi_bwd", 1024, 64),
                  ("lstm_fused_bwd", 512, 256), ("lstm_semi_bwd", 1024, 256))
BWD_YARD_ROUNDS = 2
# the forwards beside cuDNN's forward of one layer, in turns in phase 4:
# (kernel, In, B), In None for K1-fwd (f32, against an f32 layer whose
# input is H wide: cuDNN's time includes its input projection, which
# K1-fwd leaves to a matmul); T=160, H=512
K1_YARD_CASES = (("lstm_fwd", None, 64), ("lstm_fwd", None, 128))
# K1-bwd beside cuDNN's f32 backward of one layer, in turns in phase 4
K1B_YARD_CASES = (("lstm_bwd", None, 64), ("lstm_bwd", None, 128))
FUSED_FWD_YARD_CASES = tuple(("lstm_fused_fwd", In, B) for B in (64, 256)
                             for In in (128, 512, 1024))
FWD_YARD_ROUNDS = 2
BF16_PEAK = 989e12    # H100 SXM dense bf16 tensor cores, FLOP/s
AMP_LOSS_RTOL = 1e-3  # the AMP step against its plain twin: the fused
AMP_GRAD_RTOL = 1e-2  # kernels' bf16 flips (above) through ten layers
AMP_F32_RTOL = 0.05   # the AMP VAE loss against the f32 step's, as
                      # tests/test_mixed_precision.py holds the JAX step
# K6 against its plain version: f32 DFT sums in another order; in a
# low-energy band the power is a small difference of large sums, so the
# tolerance is absolute on the log values
FBANK_KALDI_ATOL = 1e-3  # natural-log mels
FBANK_SB_ATOL = 5e-3     # dB: 10 / ln 10 times the natural log
FBANK_GOLDEN_RTOL = 1e-4  # against the float64 golden, the denominator
                      # floored at 1e-3 (tests/test_frontend.py's gate); on
                      # two short utterances only: even the TPU's f32
                      # passes land at 1.04e-4 at the Kaldi pass's size
FBANK_REPEATS = 20    # phase 2's repeated K6 launches per mode: bit-equal
CMVN_RTOL = 1e-4      # Kaldi features after speaker CMVN, card against
                      # CPU, of the largest entry (K6's errors divided by
                      # each band's deviation)
# K5 against its plain versions: f32 sums in another order over T (and, in
# the backward, over B*T for dW_hh and db_hh); under bf16 a sum can cross a
# bf16 rounding boundary, and a flipped h_t feeds every later step
GRU_ATOL = 1e-4       # f32 hs
GRU_BWD_RTOL = 1e-4   # f32 dgx, dW_hh, db_hh, of their largest entry
GRU_BF16_ATOL = 4e-3  # bf16 hs (one bf16 ulp at |h| < 1) and hs32
GRU_BF16_BWD_RTOL = 1e-2  # bf16 backward: a dgh one bf16 ulp off
GRU_REPEATS = 26      # phase 2's repeated launches per K5 kernel and
                      # direction, half f32, half bf16, each bit-equal to
                      # the first of its dtype
GRU_YARD_ROUNDS = 2   # phase 4: the K5 builds in turns with cuDNN's layer
                      # of their dtype (two pairs of samples a round)
GATE_RTOL = 1e-4      # gates 1, 2, 4 card against CPU: loss, and each
                      # parameter's grad in norm (f32 sums in another order)
# K7a and K7b: bit-equal to their one-step twins (K1-fwd of the stream
# dtype, K3/K4-fwd) for every K; the twins against the plain versions as
# above (LSTM_ATOL in f32, FUSED_ATOL in bf16)
UNROLL_KS = (2, 4, 8)  # the unroll bench's K
UNROLL_RAGGED_B = (63, 65, 200, 256, 320)  # K7 against the twins (phase 2)
UNROLL_YARD_ROUNDS = 2  # phase 4: K7 in turns with the twins and cuDNN
UNROLL_REPEATS = 5    # phase 2's repeated launches per K7 kernel, dtype and
                      # direction, at the bench shape
UNROLL_ITERS = 20     # timed calls per kernel on the unroll path (phase 3)

# kernel launches in one eval forward: ten directional LSTM layers (2 + 2
# + 2 + 2x2 bidirectional), one decode
NO_FUSED = {"lstm_fused_fwd": 0, "lstm_fused_bwd": 0, "lstm_semi_bwd": 0,
            "lstm_fused_fwd_f32": 0, "lstm_fused_bwd_f32": 0,
            "lstm_semi_bwd_f32": 0}
NO_FBANK = {"fbank": 0, "fbank_fft": 0}
NO_GRU = {"gru_fwd": 0, "gru_bwd": 0, "gru_fwd_bf16": 0, "gru_bwd_bf16": 0,
          "gru_dw_bf16": 0}
# K7a and K7b run on the unroll A/B path only (phase 3's last part)
NO_UNROLL = {"lstm_unroll_fwd": 0, "lstm_unroll_fwd_bf16": 0,
             "lstm_unroll_fused_fwd": 0, "lstm_unroll_fused_fwd_f32": 0}
# the wide K1 builds (H above 528), f32 and bf16, run on the LSTM_FC path
# only
NO_WIDE = {"lstm_fwd_wide": 0, "lstm_bwd_wide": 0, "lstm_dw_wide": 0,
           "lstm_fwd_wide_bf16": 0, "lstm_bwd_wide_bf16": 0,
           "lstm_dw_wide_bf16": 0}
PER_FORWARD = {"lstm_fwd": 10, "lstm_bwd": 0, "md_viterbi": 1, **NO_FUSED,
               **NO_FBANK, **NO_GRU, **NO_UNROLL, **NO_WIDE}
# the wav-in forward adds one K6 launch (SpeechBrain mode, N = 400: the FFT
# build) for the batch
PER_WAV_FORWARD = {**PER_FORWARD, "fbank_fft": 1}
# one gate-3 train step: K5-fwd for the encoder and the decoder's two
# directions, K5-bwd for each of them; nothing else. Under AMP the bf16
# builds only, K5-bwd as the recurrence and its dW_hh kernel (T > 1)
PER_GATE3_STEP = {**{k: 0 for k in PER_FORWARD}, "gru_fwd": 3, "gru_bwd": 3}
PER_GATE3_AMP_STEP = {**{k: 0 for k in PER_FORWARD}, "gru_fwd_bf16": 3,
                      "gru_bwd_bf16": 3, "gru_dw_bf16": 3}
# LSTM_FC (four f32 LSTM layers at H=1024): the wide K1-fwd once a layer in
# the eval forward, and K1-fwd and K1-bwd once a layer in a train step
PER_LSTM_FC_EVAL = {**{k: 0 for k in PER_FORWARD}, "lstm_fwd_wide": 4}
PER_LSTM_FC_STEP = {**PER_LSTM_FC_EVAL, "lstm_bwd_wide": 4,
                    "lstm_dw_wide": 4}
# its AMP (bf16) train step: no layer fits a fused tier at H=1024, so every
# layer takes the wide K1 builds on bf16 streams (K1-bwd: the recurrence,
# then the dW_hh kernel), and no f32 K1 or fused kernel runs
PER_LSTM_FC_AMP_STEP = {**{k: 0 for k in PER_FORWARD},
                        "lstm_fwd_wide_bf16": 4, "lstm_bwd_wide_bf16": 4,
                        "lstm_dw_wide_bf16": 4}
LSTM_FC_ACTIVE = {"lstm", "fc"}
CLI_LOSS_RTOL = 1e-4      # the CLI path's epoch losses, the kernels against
                          # the plain versions from the same seed: f32 sums
                          # in another order through six Adam steps
CLI_AMP_LOSS_RTOL = 1e-3  # the same under --bf16 (the fused kernels' flips)
CLI_FEAT_ATOL = 2e-3      # both feature passes' features (deltas; the
                          # Kaldi pass after speaker CMVN), the kernel
                          # against the plain version: the gate of
                          # tests/test_torch_fbank.py
CLI_EPOCHS = 3            # one PHN_RECOG -> B_DETECTOR -> VAE cycle
ACTIVE = {
    "PHN_RECOG": {"phoneme_recognizer"},
    "B_DETECTOR": {"boundary_detector"},
    "VAE": {"feat_fc", "phn_recog_fc", "concat_fc", "rnn", "pi_fc",
            "encoder", "decoder"},
}
# the rest of the MD_VAE family (phase 3): MD_VAE_sfl's VAE target runs
# the hierarchical VAE and the decoder once a π sample, SFL_SAMPLES of
# them in a train step and one in an eval forward; MD_VAE_joint trains
# every branch in its VAE step; MD_VAE_sfl_saved_phn_recog has no
# recognizer and cycles B_DETECTOR -> VAE
SFL_SAMPLES = 5           # the recipe's pi_mcmc_num
FAMILY = ("MD_VAE_sfl", "MD_VAE_joint", "MD_VAE_joint_ll",
          "MD_VAE_sfl_saved_phn_recog")
FAMILY_EPOCHS = {"MD_VAE_sfl": 3, "MD_VAE_joint": 1, "MD_VAE_joint_ll": 1,
                 "MD_VAE_sfl_saved_phn_recog": 2}
SFL_ACTIVE = {"feat_fc", "phn_recog_out_fc", "concat_fc", "rnn", "pi_fc",
              "encoder", "decoder", "baseline_fc"}
# CRDNN_CTC and CRDNN_CTC_cnncl (phase 3): four bidirectional LSTM layers
# at H=512. The f32 step takes K1-fwd and K1-bwd (the narrow builds) once a
# layer direction. Under --bf16 the first layer (In 256 x 30 = 7,680) fits
# neither fused tier and takes K1 on bf16 streams (the tensor-core builds;
# K1-bwd's dW_hh kernel after each recurrence), layers 2-4 (In 1,024) the
# semi-fused tier (K3/K4-fwd, K4-bwd). The eval forward stays f32
CTC_RECIPES = ("CRDNN_CTC", "CRDNN_CTC_cnncl")
CTC_EPOCHS = 1            # one two-batch debug epoch
CTC_B, CTC_T, CTC_L = 64, 160, 32   # the train step's batch: T' = 80
PER_CRDNN_EVAL = {**{k: 0 for k in PER_FORWARD}, "lstm_fwd": 8}
PER_CRDNN_STEP = {**PER_CRDNN_EVAL, "lstm_bwd": 8}
PER_CRDNN_AMP_STEP = {**{k: 0 for k in PER_FORWARD},
                      "lstm_fwd_wide_bf16": 2, "lstm_bwd_wide_bf16": 2,
                      "lstm_dw_wide_bf16": 2, "lstm_fused_fwd": 6,
                      "lstm_semi_bwd": 6}
CRDNN_ACTIVE = {"crdnn", "output"}
# phase 2: K1 on bf16 streams at H <= 512 (the tensor-core builds, which
# the CRDNN's first layer takes under --bf16 at H=512), each H at each B
# and T, both directions, against the plain versions at the bf16 wide
# builds' tolerances
K1_BF16_NARROW_H = (128, 256, 384, 512)
K1_BF16_NARROW_B = (1, 8, 24, 64)
K1_BF16_NARROW_T = (80, 160)
K1_BF16_NARROW_REPEATS = 20   # repeated launches at H=512, B=64, T=80
# the five harness recipes, LSTM_FC and HMM_DNN_ALI through the CLI (phase
# 3), one two-batch debug epoch each at the recipe's width. A harness
# recipe's forward runs K1-fwd once a directional LSTM layer (the
# recognizer's or the detector's 2; the decoder's two bidirectional
# layers 4; test_h_vae's trunk 2 and decoder 4), its f32 train step K1-bwd
# once a layer too (test_h_vae's π sample stops no gradient from its
# trunk). Under --bf16 every layer takes K3/K4-fwd, the decoder's second
# (In = 2H = 1024) layer K4-bwd and the rest K3-bwd. LSTM_FC takes the
# wide K1 builds (``PER_LSTM_FC_*``); HMM_DNN_ALI no kernel at all
HARNESS = ("test_phn_classifier", "test_b_ind_classifier",
           "test_vanilla_vae", "test_gmm_vae", "test_h_vae")
HARNESS_EPOCHS = 1
# directional LSTM layers a forward, and those of them on K4 under --bf16
HARNESS_LAYERS = {"test_phn_classifier": (2, 0),
                  "test_b_ind_classifier": (2, 0), "test_vanilla_vae": (4, 2),
                  "test_gmm_vae": (4, 2), "test_h_vae": (6, 2)}
# LSTM_FC's --bf16 CLI run takes lr 0.001 in place of its recipe's 1.0:
# at 1.0 Adam's first step moves every weight by +-1 wherever its
# gradient is non-zero, so a bf16 flip of a near-zero gradient between
# the kernel and the plain version becomes a whole step of 2, and the runs
# part (TRAIN 4.182e-3, VALID 6.070e-3 rel on an H100; the f32 run, whose
# flips are rarer, stays within 2.3e-6 at 1.0)
BF16_CLI_EXTRA = {"LSTM_FC": ", lr: 0.001"}
HMM_TYPES = ("forward", "viterbi")
# the CLI's corpus: config/run.yaml and the synthesized SynAudioMNIST
# corpus; "epochs": None takes one turn of the recipe's cycle
SYNTH_CORPUS = {"dataset": "SynAudioMNIST", "language": "digits",
                "n_phonemes": 12, "hparams": REPO / "config/run.yaml",
                "epochs": None}
# the real corpora's data path (phase 3): corpora laid out as L2-ARCTIC
# (every speaker of its split, two utterances of 2-4 s each), TIMIT (its
# waves as SPHERE) and ChineseDPA (data/corpus_layout.py), from seed 0
L2_CORPUS = {"dataset": "L2_ARCTIC", "language": "english",
             "n_phonemes": 39, "epochs": 1}
TIMIT_CORPUS = {"dataset": "TIMIT", "language": "english",
                "n_phonemes": 39, "epochs": 1}
DPA_CORPUS = {"dataset": "ChineseDPA", "language": "pinyin",
              "n_phonemes": 62, "epochs": 1}
AUGMENTATION = ("augmentation: !new:mlvae_tpu_torch.ops.augment."
                "WaveAugment\n  speeds: [0.95, 1.0, 1.05]\n"
                "  noise_snr_db: 30\n")
HMM_RTOL = 1e-4           # HMM_DNN_ALI on the card against the CPU: f32
                          # sums in another order through two Adam steps
HMM_B, HMM_T, HMM_L = 64, 160, 16   # phase 4's HMM_DNN_ALI train step
# the wav2vec2 recipes through the CLI (phase 3): the encoder at
# wav2vec2-large-lv60's topology (24 layers, d=1024, 16 heads, FFN 4096,
# random init, about 317M parameters) and each recipe's heads at its own
# width. The trunk is torch ops (no kernel); the heads' kernels launch as
# their recipes' do: the MD_VAE family's as MD_VAE's and MD_VAE_sfl's;
# w2v_CRDNN_CTC's one unidirectional LSTM layer at H=32 K1's narrow build
# in f32 (K1-fwd a forward, K1-bwd a train step) and ``nn.rnn.lstm_scan``
# (no kernel) in its --bf16 train step; w2v_CRDNN_CTC_cnncl's two
# bidirectional layers at H=512 K1 four times; w2v_LSTM_FC none.
# w2v_MD_VAE trains one cycle (three debug epochs, so that its --bf16 run
# reaches K4 in the VAE target), the others one debug epoch; the
# fine-tuned trunks' VALID losses, after Adam's near lr * sign(g) first
# steps on 317M parameters, are held within W2V_VALID_RTOL: every trunk
# weight whose gradient's sign is rounding noise moves by +-lr either way
# (w2v_CRDNN_CTC's f32 VALID loss, K1's f32 sums against the plain
# version's, parted by 2.6e-5 and 3.0e-3 in two runs on an H100; its
# TRAIN loss by 5e-8; the TEST pass on one checkpoint is equal)
W2V_RECIPES = ("w2v_MD_VAE", "w2v_MD_VAE_sfl", "w2v_MD_VAE_sfl_resi",
               "w2v_CRDNN_CTC", "w2v_CRDNN_CTC_cnncl", "w2v_LSTM_FC")
W2V_EPOCHS = {"w2v_MD_VAE": 3}
W2V_EXTRA = {"w2v_CRDNN_CTC_cnncl": ", min_key: loss"}   # its YAML keys
                                                          # are null
W2V_ARCH = {"num_hidden_layers": 24, "hidden_size": 1024,
            "num_attention_heads": 16, "intermediate_size": 4096}
W2V_PARAMS = (3.1e8, 3.2e8)   # bounds of the encoder's parameter count
# the fine-tuned trunks' VALID tolerance (above); the frozen trunks' runs
# keep CLI_LOSS_RTOL and CLI_AMP_LOSS_RTOL (their VALID losses parted by
# 5.9e-5 or less on an H100)
W2V_VALID_RTOL = 1e-2
W2V_FINE_TUNED = ("w2v_MD_VAE_sfl_resi", "w2v_CRDNN_CTC",
                  "w2v_CRDNN_CTC_cnncl", "w2v_LSTM_FC")  # freeze: False
W2V_CTC = {"w2v_CRDNN_CTC": 1, "w2v_CRDNN_CTC_cnncl": 4}  # K1 layer dirs
# the f32 kernel runs whose checkpoints a later command reads (cli.test,
# cli.test_on_three_sets), and w2v_LSTM_FC's (a fine-tuned trunk with
# bf16 Adam moments, MLVAE_OPT_MOMENT_DTYPE, read back and deleted); no
# other w2v run writes one (checkpoint_writes; the MD_VAE family writes
# none outside VAE epochs)
W2V_SAVED = ("w2v_MD_VAE", "w2v_CRDNN_CTC", "w2v_CRDNN_CTC_cnncl",
             "w2v_LSTM_FC")
W2V_BF16_MOMENTS = "w2v_LSTM_FC"

K1_H32_ATOL = 1e-5    # K1 at w2v_CRDNN_CTC's H=32: f32 sums of 32 terms
W2V_POST_ATOL = 1e-4  # cnncl's dumped log-posteriors, kernels against the
                      # plain versions: K1's f32 sums in another order


def md_vae_layers():
    """MD_VAE's LSTM layers at ``bench_utils.RECIPE``'s widths (the
    recipe's; the CLI builds the same from its YAML): each module's (In,
    H, directions) a layer. The fbank's 120 and the latent's 32 take the
    fused tiers padded to 128."""
    from mlvae_tpu_torch.bench_utils import RECIPE as R

    def stack(In, H, n, dirs):
        return tuple((In if i == 0 else H * dirs, H, dirs) for i in range(n))
    return {"phoneme_recognizer": stack(R["input_size"],
                                        R["phn_rnn_hidden_size"],
                                        R["phn_rnn_num_layers"], 1),
            "boundary_detector": stack(R["input_size"],
                                       R["boundary_rnn_hidden_size"],
                                       R["boundary_rnn_num_layers"], 1),
            "rnn": stack(R["concat_fc_size"], R["rnn_hidden_size"],
                         R["rnn_num_layers"], 1),
            "decoder": stack(R["latent_size"], R["dec_rnn_hidden_size"],
                             R["dec_rnn_num_layers"], 2)}


@contextlib.contextmanager
def fused_switch(value):
    """``nn.rnn.PALLAS_LSTM_FUSED`` set to ``value`` ("auto", True,
    False) for the block, as ``MLVAE_PALLAS_FUSED`` sets it at import."""
    from mlvae_tpu_torch.nn import rnn
    saved = rnn.PALLAS_LSTM_FUSED
    rnn.PALLAS_LSTM_FUSED = value
    try:
        yield
    finally:
        rnn.PALLAS_LSTM_FUSED = saved


# MD_VAE's launches under MLVAE_PALLAS_FUSED=1 on f32 streams, reckoned
# from the JAX package's f32 budgets (13 MiB) at H=512: the In=120 and
# In=32 layers (padded to 128) take K3 (10.49 MB), the In=512 layers K4
# (12.58 MB; K3 would need 16.78), the decoder's In=1,024 layers K1 (K4
# would need 16.78). A forward runs its target's layers (PHN_RECOG and
# B_DETECTOR: K3 then K4; VAE and TEST: 8 fused and 2 K1 layer directions,
# and the decode), a train step's backward the modules it trains (VAE: the
# rnn's K3 and K4, the decoder's two K3 and two K1 directions)
_ZERO = {k: 0 for k in PER_FORWARD}
_ON_OWN_EVAL = {**_ZERO, "lstm_fused_fwd_f32": 2}
_ON_VAE_EVAL = {**_ZERO, "lstm_fused_fwd_f32": 8, "lstm_fwd": 2,
                "md_viterbi": 1}
_ON_OWN_STEP = {**_ON_OWN_EVAL, "lstm_fused_bwd_f32": 1,
                "lstm_semi_bwd_f32": 1}
PER_F32_ON_EVAL = {"PHN_RECOG": _ON_OWN_EVAL, "B_DETECTOR": _ON_OWN_EVAL,
                   "VAE": _ON_VAE_EVAL, "TEST": _ON_VAE_EVAL}
PER_F32_ON_STEP = {"PHN_RECOG": _ON_OWN_STEP, "B_DETECTOR": _ON_OWN_STEP,
                   "VAE": {**_ON_VAE_EVAL, "lstm_fused_bwd_f32": 3,
                           "lstm_semi_bwd_f32": 1, "lstm_bwd": 2}}
# its AMP VAE step under MLVAE_PALLAS_FUSED=0: every layer direction on the
# bf16 K1 builds, the ten forward and the six the step trains backward
# (K1-bwd's dW_hh kernel after each recurrence), and the decode
PER_OFF_AMP_VAE_STEP = {**_ZERO, "lstm_fwd_wide_bf16": 10,
                        "lstm_bwd_wide_bf16": 6, "lstm_dw_wide_bf16": 6,
                        "md_viterbi": 1}


def md_vae_switch_launches(target, train, amp):
    """MD_VAE's launches by each layer's route under the switch as it
    stands (``nn.rnn.lstm_route``), for the report beside the pinned
    counts: a forward runs its target's modules' layers (TEST and VAE all
    four, and the decode), a train step's backward the modules it trains
    (VAE: the rnn and the decoder). A fused layer takes K3/K4-fwd and
    K3-bwd or K4-bwd of its stream dtype, a K1 layer K1-fwd and K1-bwd, on
    bf16 streams the tensor-core builds with K1-bwd's dW_hh kernel; the
    eval forward is f32."""
    import torch
    from mlvae_tpu_torch.nn import rnn
    bf = train and amp
    dtype = torch.bfloat16 if bf else torch.float32
    sfx = "" if bf else "_f32"
    own = {"PHN_RECOG": ("phoneme_recognizer",),
           "B_DETECTOR": ("boundary_detector",)}
    layers = md_vae_layers()
    fwd = own.get(target, tuple(layers))
    bwd = own.get(target, ("rnn", "decoder")) if train else ()
    out = dict(_ZERO)
    for mods, back in ((fwd, False), (bwd, True)):
        for mk in mods:
            for In, H, dirs in layers[mk]:
                route = rnn.lstm_route(In, H, dtype)
                if route == "k1" and bf:
                    names = (("lstm_bwd_wide_bf16", "lstm_dw_wide_bf16")
                             if back else ("lstm_fwd_wide_bf16",))
                elif route == "k1":
                    names = ("lstm_bwd",) if back else ("lstm_fwd",)
                elif back:
                    names = (("lstm_semi_bwd" if route.__name__ ==
                              "LSTMSemiFused" else "lstm_fused_bwd") + sfx,)
                else:
                    names = ("lstm_fused_fwd" + sfx,)
                for n in names:
                    out[n] += dirs
    out["md_viterbi"] = 1 if target in ("VAE", "TEST") else 0
    return out


def recipe_launches(recipe, target, train, amp=False):
    """One eval forward's (``train``: one train step's) launches of an
    MD_VAE family recipe's ``target``, MD_VAE's included. A forward runs
    the LSTMs of the branches its target gates in: K1-fwd once a
    directional layer (the recognizer 2, none in
    MD_VAE_sfl_saved_phn_recog; the detector 2; the rnn 2 and the
    decoder's two bidirectional layers 4 a π sample), and one decode in
    VAE and TEST. A train step's backward reaches only the layers of the
    modules its target trains: K1-bwd once a layer (VAE: the rnn and the
    decoder, the recognizer and the detector behind stop-gradients but in
    MD_VAE_joint). Under AMP a train step takes K3/K4-fwd for every layer
    and no K1, K4-bwd for the decoder's second (In=1024) pair a sample and
    K3-bwd for the rest; the eval forward stays f32. The CTC recipes take
    ``PER_CRDNN_EVAL``, ``PER_CRDNN_STEP`` or ``PER_CRDNN_AMP_STEP``,
    LSTM_FC ``PER_LSTM_FC_*``, a harness recipe its ``HARNESS_LAYERS``,
    HMM_DNN_ALI none, the w2v recipes as ``W2V_CTC`` and the MD_VAE
    family's (their trunks launch none). That is the default
    ``MLVAE_PALLAS_FUSED``, and also ``1`` on bf16 streams and ``0`` on
    f32 streams, which route alike. ``1`` on f32 streams and ``0`` on bf16
    ones (``nn.rnn.PALLAS_LSTM_FUSED`` as this process reads it) are
    reckoned for MD_VAE only: ``PER_F32_ON_EVAL`` / ``PER_F32_ON_STEP``,
    and ``PER_OFF_AMP_VAE_STEP`` for its AMP VAE step."""
    from mlvae_tpu_torch.nn import rnn
    switch, bf = rnn.PALLAS_LSTM_FUSED, train and amp
    if switch is True and not bf:
        check(recipe == "MD_VAE", f"{recipe}'s f32 launches are reckoned "
              "under MLVAE_PALLAS_FUSED=1 for MD_VAE only")
        return dict((PER_F32_ON_STEP if train else PER_F32_ON_EVAL)[target])
    if switch is False and bf:
        check(recipe == "MD_VAE" and target == "VAE", f"{recipe} {target}'s"
              " AMP launches are reckoned under MLVAE_PALLAS_FUSED=0 for "
              "MD_VAE's VAE step only")
        return dict(PER_OFF_AMP_VAE_STEP)
    if recipe in CTC_RECIPES:   # no target: the stage alone decides
        return dict(PER_CRDNN_AMP_STEP if train and amp else
                    PER_CRDNN_STEP if train else PER_CRDNN_EVAL)
    if recipe in W2V_CTC or recipe == "w2v_LSTM_FC":
        n = W2V_CTC.get(recipe, 0)
        out = {k: 0 for k in PER_FORWARD}
        if not amp or not train:   # --bf16: lstm_scan, no kernel
            out.update(lstm_fwd=n, lstm_bwd=n if train else 0)
        return out
    if recipe == "LSTM_FC":
        return dict(PER_LSTM_FC_AMP_STEP if train and amp else
                    PER_LSTM_FC_STEP if train else PER_LSTM_FC_EVAL)
    out = {k: 0 for k in PER_FORWARD}
    if recipe == "HMM_DNN_ALI":
        return out
    if recipe in HARNESS:
        n, semi = HARNESS_LAYERS[recipe]
        if train and amp:
            out.update(lstm_fused_fwd=n, lstm_fused_bwd=n - semi,
                       lstm_semi_bwd=semi)
        else:
            out.update(lstm_fwd=n, lstm_bwd=n if train else 0)
        return out
    sfl = "sfl" in recipe
    rec = 0 if recipe == "MD_VAE_sfl_saved_phn_recog" else 2
    vae = target in ("VAE", "TEST")
    n = SFL_SAMPLES if sfl and train and vae else 1
    fwd = {"PHN_RECOG": rec, "B_DETECTOR": 2}.get(target, rec + 2 + 2 + 4 * n)
    bwd = 0
    if train:
        bwd = {"PHN_RECOG": rec, "B_DETECTOR": 2}.get(target, 2 + 4 * n)
        if vae and recipe == "MD_VAE_joint":
            bwd += rec + 2
    out["md_viterbi"] = 1 if vae else 0
    if train and amp:
        semi = 2 * n if vae else 0
        out.update(lstm_fused_fwd=fwd, lstm_fused_bwd=bwd - semi,
                   lstm_semi_bwd=semi)
    else:
        out.update(lstm_fwd=fwd, lstm_bwd=bwd)
    return out


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_usage(log: str) -> list:
    """Each entry function's lines of an ``nvcc -Xptxas -v`` ``log``:
    "name: registers | stack and spills", the names demangled by
    ``c++filt`` where the machine has it (template arguments kept,
    parameters dropped)."""
    import re
    entries, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            entries.append([name, []])
        elif name and ("registers" in ln or "spill" in ln):
            entries[-1][1].append(ln.split(":", 1)[-1].strip()
                                  if "ptxas" in ln else ln.strip())
    names = [e[0] for e in entries]
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60,
                             check=True).stdout.splitlines()
        if len(out) == len(names):
            names = [n.replace("(anonymous namespace)::", "").split("(")[0]
                     .removeprefix("void ") for n in out]
    except (OSError, subprocess.SubprocessError):
        pass
    return [f"{n}: " + "; ".join(use) for n, (_, use) in zip(names, entries)]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
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
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def rel_err(a, b) -> float:
    """Max abs error relative to the largest entry of ``b``; an all-zero
    ``b`` must be matched by an all-zero ``a``."""
    scale = float(b.double().abs().max()) if b.numel() else 0.0
    return max_err(a, b) / scale if scale else max_err(a, b)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def viterbi_problem(rs, dev, B, T, N, L, weight, quantize=False):
    """Decode inputs made with numpy: ragged lengths (T >= l_len where
    T >= L), and with ``quantize`` probabilities on a coarse grid, which
    makes exact ties."""
    import numpy as np
    import torch
    from mlvae_tpu_torch.ops.decode import clamped_log_np
    l_lens = rs.randint(1, L + 1, B)
    t_lens = np.array([rs.randint(min(l, T), T + 1) for l in l_lens])
    t_lens[0], l_lens[0] = T, L
    p = rs.rand(B, T, N) * 0.98 + 0.01
    bv = rs.rand(B, T) * 0.98 + 0.01
    logits = rs.randn(B, T, 2)
    if quantize:
        p, bv = np.round(p * 4) / 4, np.round(bv * 4) / 4
        logits = np.round(logits)
    prior = rs.dirichlet(np.ones(N))
    lpi = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    arrs = [clamped_log_np(np.stack([p, 1 - p], 3)),
            clamped_log_np(np.stack([prior, 1 - prior], 1)),
            rs.randint(0, N, (B, L)),
            clamped_log_np(np.stack([bv, 1 - bv], 2)), lpi, t_lens, l_lens]
    out = []
    for a in arrs:
        a = np.asarray(a)
        dt = torch.float32 if a.dtype.kind == "f" else torch.int32
        out.append(torch.as_tensor(a, dtype=dt, device=dev).contiguous())
    return out + [weight]


def where_wrong(diff, reverse):
    """Where a (T, B, H) recurrence first goes wrong: the step, and the
    batch rows and hidden units (four to a block of the kernel) there."""
    bad = diff > LSTM_ATOL
    steps = bad.any(2).any(1).nonzero().flatten().tolist()
    t = steps[-1] if reverse else steps[0]
    rows = bad[t].any(1).nonzero().flatten().tolist()
    units = bad[t].any(0).nonzero().flatten().tolist()
    return (f"first wrong step t={t} of {len(steps)} wrong steps; rows "
            f"{rows[:16]} ({len(rows)}); units {units[:16]} ({len(units)})")


def check_lstm(dev, report):
    import torch
    from mlvae_tpu_torch.ops.lstm import lstm_layer_fwd, lstm_layer_ref
    g = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    # the main path's shape first; then B=128 (two batch tiles through the
    # ring of TMA copies), ragged and larger batches, T=1 and T=2
    cases = [(160, 64, 512), (160, 128, 512), (7, 1, 512), (9, 70, 64),
             (5, 63, 512), (5, 65, 512), (4, 200, 512), (3, 256, 512),
             (3, 320, 512), (1, 64, 512), (2, 64, 512), (2, 1, 512)]
    for T, B, H in cases:
        gx = torch.randn((T, B, 4 * H), generator=g, device=dev) * 0.5
        w = (torch.rand((4 * H, H), generator=g, device=dev) * 2 - 1) \
            / H ** 0.5
        for reverse in (False, True):
            hs_k, cs_k = lstm_layer_fwd(gx, w, reverse)
            hs_r, cs_r = lstm_layer_ref(gx, w, reverse)
            torch.cuda.synchronize()
            err = max(max_err(hs_k, hs_r), max_err(cs_k, cs_r))
            report(f"  lstm_fwd T={T} B={B} H={H} reverse={reverse}: "
                   f"max_abs_err {err:.3e} (tol {LSTM_ATOL:g})")
            if err > LSTM_ATOL:
                report("  " + where_wrong(torch.maximum(
                    (hs_k - hs_r).abs(), (cs_k - cs_r).abs()), reverse))
            check(err <= LSTM_ATOL, f"lstm_fwd disagrees: {err}")
            if (T, B, H) == cases[0]:
                worst = max(worst, err)
    return worst


def stress_lstm(dev, report, repeats):
    """Repeated K1 launches at the main path's shapes (the eval batch and
    ``infer_features``' single utterance), back to back as the model issues
    them, each held against the plain version on its inputs: a fault that
    shows once in hundreds of launches fails the smoke."""
    import torch
    from mlvae_tpu_torch.ops.lstm import lstm_layer_fwd, lstm_layer_ref
    g = torch.Generator(device=dev).manual_seed(2)
    n_inputs = 5
    total, wrong, worst = 0, [], 0.0
    for T, B, H in ((160, 64, 512), (160, 1, 512)):
        for reverse in (False, True):
            for i in range(n_inputs):
                gx = torch.randn((T, B, 4 * H), generator=g, device=dev) * 0.5
                w = (torch.rand((4 * H, H), generator=g, device=dev) * 2
                     - 1) / H ** 0.5
                hs_r, cs_r = lstm_layer_ref(gx, w, reverse)
                errs = []
                for _ in range(-(-repeats // n_inputs)):
                    hs_k, cs_k = lstm_layer_fwd(gx, w, reverse)
                    errs.append(torch.maximum((hs_k - hs_r).abs().max(),
                                              (cs_k - cs_r).abs().max()))
                errs = torch.stack(errs).cpu()
                total += len(errs)
                worst = max(worst, float(errs.max()))
                wrong += [(B, reverse, i, j, float(e))
                          for j, e in enumerate(errs) if e > LSTM_ATOL]
    report(f"  lstm_fwd repeated: {total} launches at B=64 and B=1, T=160, "
           f"H=512, both directions: {len(wrong)} wrong, worst max_abs_err "
           f"{worst:.3e} (tol {LSTM_ATOL:g})"
           + (f"; wrong (B, reverse, input, launch, err): {wrong[:8]}"
              if wrong else ""))
    check(not wrong, f"lstm_fwd wrong in {len(wrong)} of {total} repeated "
          "launches")
    return worst


def bwd_problem(g, dev, T, B, H, reverse, bf16=False):
    """A K1-bwd input: a forward trajectory from the plain recurrence,
    random cotangents for every h and a non-zero one for the final c;
    with ``bf16``, gx, W_hh, hs and dhs on bf16 streams (the same draws,
    rounded), cs and dc_last f32."""
    import torch
    from mlvae_tpu_torch.ops.lstm import lstm_layer_ref
    dt = torch.bfloat16 if bf16 else torch.float32
    gx = (torch.randn((T, B, 4 * H), generator=g, device=dev) * 0.5).to(dt)
    w = ((torch.rand((4 * H, H), generator=g, device=dev) * 2 - 1)
         / H ** 0.5).to(dt)
    hs, cs = lstm_layer_ref(gx, w, reverse)
    dhs = (torch.randn((T, B, H), generator=g, device=dev) * 0.1).to(dt)
    dc_last = torch.randn((B, H), generator=g, device=dev) * 0.1
    return gx, w, hs, cs, dhs, dc_last


def bwd_errors(got, want):
    """(max abs error of dgx, max error of dW_hh relative to its largest
    entry); an all-zero dW_hh (T=1) must come back all zero."""
    return max_err(got[0], want[0]), rel_err(got[1], want[1])


def where_wrong_bwd(diff, reverse):
    """Where a (T, B, 4H) dgx first goes wrong in the order K1-bwd walks
    (t = T-1 down to 0, or up from 0 when ``reverse``)."""
    bad = diff > LSTM_ATOL
    steps = bad.any(2).any(1).nonzero().flatten().tolist()
    t = steps[0] if reverse else steps[-1]
    rows = bad[t].any(1).nonzero().flatten().tolist()
    cols = bad[t].any(0).nonzero().flatten().tolist()
    return (f"first wrong step t={t} of {len(steps)} wrong steps; rows "
            f"{rows[:16]} ({len(rows)}); gate columns {cols[:16]} "
            f"({len(cols)})")


def check_lstm_bwd(dev, report):
    import torch
    from mlvae_tpu_torch.ops.lstm import lstm_layer_bwd, lstm_layer_bwd_ref
    g = torch.Generator(device=dev).manual_seed(3)
    worst = 0.0
    # the main path's shape, then both schedules (B <= 64 splits its
    # barrier, larger B runs its tiles in series), ragged B on either
    # side of a tile, T=1 and 2, and a narrow H
    cases = [(160, 64, 512), (7, 1, 512), (1, 64, 512), (9, 70, 512),
             (5, 130, 64), (160, 128, 512), (160, 256, 512), (33, 63, 512),
             (33, 65, 512), (33, 200, 512), (2, 64, 512), (2, 200, 512),
             (9, 64, 64), (9, 63, 64)]
    for T, B, H in cases:
        for reverse in (False, True):
            prob = bwd_problem(g, dev, T, B, H, reverse)
            got = lstm_layer_bwd(*prob, reverse)
            want = lstm_layer_bwd_ref(*prob, reverse)
            torch.cuda.synchronize()
            dgx_err, dw_err = bwd_errors(got, want)
            report(f"  lstm_bwd T={T} B={B} H={H} reverse={reverse}: dgx "
                   f"max_abs_err {dgx_err:.3e} (tol {LSTM_ATOL:g}), dW_hh "
                   f"max rel err {dw_err:.3e} (tol {BWD_RTOL:g})")
            if dgx_err > LSTM_ATOL:
                report("  " + where_wrong_bwd((got[0] - want[0]).abs(),
                                              reverse))
            check(dgx_err <= LSTM_ATOL and dw_err <= BWD_RTOL,
                  f"lstm_bwd disagrees: dgx {dgx_err}, dW_hh {dw_err}")
            if (T, B, H) == cases[0]:
                worst = max(worst, dgx_err)
    return worst


def stress_lstm_bwd(dev, report, repeats):
    """Repeated K1-bwd launches at the training step's shape, back to back,
    each held against the plain version on its inputs and bit-equal to the
    first launch on them: its split barrier, TMA copies and mbarriers are
    an ordering a race would break."""
    import torch
    from mlvae_tpu_torch.ops.lstm import lstm_layer_bwd, lstm_layer_bwd_ref
    g = torch.Generator(device=dev).manual_seed(4)
    n_inputs = 4
    total, wrong, worst = 0, [], 0.0
    T, B, H = 160, 64, 512
    for reverse in (False, True):
        for i in range(n_inputs):
            prob = bwd_problem(g, dev, T, B, H, reverse)
            dgx_r, dw_r = lstm_layer_bwd_ref(*prob, reverse)
            scale = dw_r.abs().max()
            first = lstm_layer_bwd(*prob, reverse)
            errs, same = [], []
            for _ in range(-(-repeats // n_inputs)):
                dgx_k, dw_k = lstm_layer_bwd(*prob, reverse)
                errs.append(torch.stack([(dgx_k - dgx_r).abs().max(),
                                         (dw_k - dw_r).abs().max() / scale]))
                same.append(bit_equal((dgx_k, dw_k), first))
            errs = torch.stack(errs).cpu()
            total += len(errs)
            worst = max(worst, float(errs[:, 0].max()))
            for j, (e_dgx, e_dw) in enumerate(errs.tolist()):
                if e_dgx > LSTM_ATOL or e_dw > BWD_RTOL or not same[j]:
                    wrong.append((reverse, i, j, e_dgx, e_dw, same[j]))
                    if len(wrong) == 1:
                        dgx_k, _ = lstm_layer_bwd(*prob, reverse)
                        report("  " + where_wrong_bwd(
                            (dgx_k - dgx_r).abs(), reverse))
    report(f"  lstm_bwd repeated: {total} launches at B=64, T=160, H=512, "
           f"both directions, against the plain version and the first "
           f"launch on each input: {len(wrong)} wrong, worst dgx "
           f"max_abs_err {worst:.3e} (tol {LSTM_ATOL:g})"
           + (f"; wrong (reverse, input, launch, dgx err, dW err, "
              f"bit-equal): "
              f"{wrong[:8]}" if wrong else ""))
    check(not wrong, f"lstm_bwd wrong in {len(wrong)} of {total} repeated "
          "launches")
    return worst


# ---------------------------------------------------------------------------
# the wide K1 builds (528 < H <= 1024): LSTM_FC's H=1024
# ---------------------------------------------------------------------------

WIDE_H = 1024         # LSTM_FC's LSTM
# phase 2's cases of both wide kernels, (T, B, H): the main path's shape
# first, the other widths the launch takes (H % 32 == 16 among them: K
# slices of the last chunk whose rows are not in fours, a grid of H/8
# blocks not a multiple of 4), ragged B on either side of a 64-row tile,
# B=128 (two tiles), T=1 and T=2
WIDE_CASES = ((160, 64, 1024), (33, 64, 768), (33, 64, 640), (9, 70, 560),
              (9, 64, 592), (9, 1, 1024), (9, 63, 1024), (9, 65, 1024),
              (9, 70, 1024), (33, 128, 1024), (1, 64, 1024), (2, 64, 1024))
WIDE_REPEATS = 50     # phase 2's repeated launches per wide kernel and
                      # direction at H=1024, B=64, T=160, each bit-equal to
                      # the first
# the same for the bf16 builds: the main path's shape, a second wide H,
# B=70 (not a multiple of 64), B=1, T=1 and T=2; tolerances as the fused
# kernels' (FUSED_ATOL on hs and cs, FUSED_BWD_RTOL on dgx and dW_hh of
# their largest entry): the kernel rounds where its plain version rounds,
# but an f32 sum in another order can cross a bf16 rounding boundary
WIDE_BF16_CASES = ((160, 64, 1024), (160, 70, 1024), (33, 64, 640),
                   (33, 70, 640), (9, 1, 1024), (1, 64, 1024),
                   (2, 64, 1024))
WIDE_BF16_REPEATS = 50


def wide_plans(dev, report):
    """Phase 1: the wide builds' launch plan as the C code computes it
    (blocks, threads, shared memory, blocks an SM can hold, registers,
    local bytes), f32 and bf16, each with K1-bwd's dW_hh kernel ``dw``
    (K1-bwd at B=64, one tile and the split barrier, and B=70, the tiles in
    series), against ``ops.k1_plan``, each cooperative grid co-resident on
    this card, no build spilling."""
    import torch
    from mlvae_tpu_torch.ops import lstm as L
    from mlvae_tpu_torch.ops.k1_plan import (k1_bwd_plan, k1_dw_plan,
                                             k1_fwd_plan)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    cases = [(H, False, d, B) for H in (1024, 768, 640)
             for d, B in (("fwd", 64), ("bwd", 64), ("bwd", 70), ("dw", 64))]
    cases += [(H, True, d, B) for H in (1024, 640, 512, 384, 256, 128)
              for d, B in (("fwd", 64), ("bwd", 64), ("bwd", 70),
                           ("dw", 64))]
    for H, bf16, direction, B in cases:
        got = L.wide_plan(direction, H, B, bf16=bf16)
        if direction == "dw":
            want = k1_dw_plan(H, B, bf16=bf16)
        else:
            want = (k1_fwd_plan if direction == "fwd" else k1_bwd_plan)(
                H, B, bf16=bf16)
        name = f"lstm_{direction}_wide{'_bf16' if bf16 else ''}"
        out[f"{name} H={H} B={B}"] = got
        report(f"  plan {name} H={H} B={B}: grid "
               f"{got['blocks']} x {got['threads']} threads, shared "
               f"memory {got['smem_bytes']} B, ring {got['ring']} of "
               f"{got['chunk']}, {got['blocks_per_sm']} block(s) an SM "
               f"resident (occupancy), {got['registers']} registers, "
               f"{got['local_bytes']} B local a thread; {sms} SMs")
        check(want.variant == (("dw" if direction == "dw" else "wide")
                               + ("_bf16" if bf16 else "")) and
              (got["blocks"], got["threads"], got["smem_bytes"],
               got["ring"]) == (want.blocks, want.threads,
                                want.smem_bytes, want.ring),
              f"{name} plan {got} != {want}")
        check(got["blocks_per_sm"] >= 1 and
              (direction == "dw" or
               got["blocks"] <= got["blocks_per_sm"] * sms),
              f"{name} H={H}: the grid cannot be co-resident")
        check(got["local_bytes"] == 0,
              f"{name} H={H} B={B} spills: {got['local_bytes']} B local")
    return out


def check_lstm_wide(dev, report, bf16=False):
    """Both wide kernels against their plain versions on ``WIDE_CASES``
    (``WIDE_BF16_CASES`` on bf16 streams), both directions; returns each
    one's worst error at the main shape (f32: absolute; bf16: hs and cs
    absolute, dgx relative to its largest entry)."""
    import torch
    from mlvae_tpu_torch.ops import lstm as L
    g = torch.Generator(device=dev).manual_seed(44 if bf16 else 41)
    sfx = "_bf16" if bf16 else ""
    cases = WIDE_BF16_CASES if bf16 else WIDE_CASES
    f_tol, dgx_tol, dw_tol = ((FUSED_ATOL, FUSED_BWD_RTOL, FUSED_BWD_RTOL)
                              if bf16 else (LSTM_ATOL, LSTM_ATOL, BWD_RTOL))
    worst = {"fwd": 0.0, "bwd": 0.0}
    for T, B, H in cases:
        check(L.k1_fwd_plan(H, B).variant == "wide", f"H={H} is not wide")
        for reverse in (False, True):
            gx, w, hs_r, cs_r, dhs, dc_last = bwd_problem(
                g, dev, T, B, H, reverse, bf16=bf16)
            hs_k, cs_k = L.lstm_layer_fwd(gx, w, reverse)
            torch.cuda.synchronize()
            check(hs_k.dtype == gx.dtype and cs_k.dtype == torch.float32,
                  f"lstm_fwd_wide{sfx} output dtypes {hs_k.dtype}, "
                  f"{cs_k.dtype}")
            err = max(max_err(hs_k, hs_r), max_err(cs_k, cs_r))
            flips = float((hs_k != hs_r).float().mean()) if hs_k.numel() \
                else 0.0
            report(f"  lstm_fwd_wide{sfx} T={T} B={B} H={H} reverse="
                   f"{reverse}: max_abs_err {err:.3e} (tol {f_tol:g}); hs "
                   f"not bit-equal {flips:.4f}")
            if err > f_tol:
                report("  " + where_wrong(torch.maximum(
                    (hs_k.float() - hs_r.float()).abs(),
                    (cs_k - cs_r).abs()), reverse)
                    + " (eight units a block)")
            check(err <= f_tol, f"lstm_fwd_wide{sfx} disagrees: {err}")
            prob = (gx, w, hs_r, cs_r, dhs, dc_last)
            got = L.lstm_layer_bwd(*prob, reverse)
            want = L.lstm_layer_bwd_ref(*prob, reverse)
            torch.cuda.synchronize()
            check(got[0].dtype == gx.dtype and got[1].dtype == torch.float32,
                  f"lstm_bwd_wide{sfx} output dtypes")
            dgx_err, dw_err = bwd_errors(got, want)
            if bf16:
                dgx_err = rel_err(got[0], want[0])
            # the dW_hh kernel on its own operands: the kernel's dgx and
            # hs, f32 sums of (T-1)*B terms in another order
            own = rel_err(got[1], L.wide_dw_ref(got[0], hs_r, reverse))
            report(f"  lstm_dw_wide{sfx} T={T} B={B} H={H} reverse="
                   f"{reverse}: against wide_dw_ref on the kernel's dgx "
                   f"and hs, max rel err {own:.3e} (tol {BWD_RTOL:g})")
            check(own <= BWD_RTOL, f"lstm_dw_wide{sfx} disagrees: {own}")
            if (T, B, H) == cases[0]:
                worst["dw"] = max(worst.get("dw", 0.0), own)
            report(f"  lstm_bwd_wide{sfx} T={T} B={B} H={H} reverse="
                   f"{reverse}: dgx max {'rel' if bf16 else 'abs'} err "
                   f"{dgx_err:.3e} (tol {dgx_tol:g}), dW_hh max rel err "
                   f"{dw_err:.3e} (tol {dw_tol:g})")
            if dgx_err > dgx_tol:
                report("  " + where_wrong_bwd(
                    (got[0].float() - want[0].float()).abs(), reverse))
            check(dgx_err <= dgx_tol and dw_err <= dw_tol,
                  f"lstm_bwd_wide{sfx} disagrees: dgx {dgx_err}, dW {dw_err}")
            if (T, B, H) == cases[0]:
                worst["fwd"] = max(worst["fwd"], err)
                worst["bwd"] = max(worst["bwd"], dgx_err)
    return worst


def stress_lstm_wide(dev, report, repeats=WIDE_REPEATS, T=160, B=64,
                     H=WIDE_H, bf16=False):
    """Repeated launches of both wide kernels at LSTM_FC's shape, back to
    back, each against the plain version and bit-equal to the first launch
    on its inputs (the cp.async ring and the grid barrier are an ordering a
    race would break); ``bf16`` on bf16 streams, at the bf16 tolerances."""
    import torch
    from mlvae_tpu_torch.ops import lstm as L
    g = torch.Generator(device=dev).manual_seed(45 if bf16 else 42)
    f_tol, dgx_tol, dw_tol = ((FUSED_ATOL, FUSED_BWD_RTOL, FUSED_BWD_RTOL)
                              if bf16 else (LSTM_ATOL, LSTM_ATOL, BWD_RTOL))
    n_inputs = 4
    total, wrong = {"fwd": 0, "bwd": 0}, []
    for reverse in (False, True):
        for i in range(n_inputs):
            prob = bwd_problem(g, dev, T, B, H, reverse, bf16=bf16)
            gx, w, hs_r, cs_r = prob[:4]
            dgx_r, dw_r = L.lstm_layer_bwd_ref(*prob, reverse)
            scale = dw_r.abs().max()
            dgx_scale = dgx_r.float().abs().max() if bf16 else 1.0
            first_f = L.lstm_layer_fwd(gx, w, reverse)
            first_b = L.lstm_layer_bwd(*prob, reverse)
            errs = []
            for _ in range(-(-repeats // n_inputs)):
                hs_k, cs_k = L.lstm_layer_fwd(gx, w, reverse)
                dgx_k, dw_k = L.lstm_layer_bwd(*prob, reverse)
                errs.append((torch.stack([
                    torch.maximum((hs_k.float() - hs_r.float()).abs().max(),
                                  (cs_k - cs_r).abs().max()),
                    (dgx_k.float() - dgx_r.float()).abs().max() / dgx_scale,
                    (dw_k - dw_r).abs().max() / scale]),
                    bit_equal((hs_k, cs_k), first_f),
                    bit_equal((dgx_k, dw_k), first_b)))
            for j, (e, same_f, same_b) in enumerate(errs):
                e_f, e_dgx, e_dw = e.tolist()
                total["fwd"] += 1
                total["bwd"] += 1
                if (e_f > f_tol or e_dgx > dgx_tol or e_dw > dw_tol
                        or not same_f or not same_b):
                    wrong.append((reverse, i, j, e_f, e_dgx, e_dw, same_f,
                                  same_b))
    sfx = "_bf16" if bf16 else ""
    report(f"  wide{sfx} repeated: {total['fwd']} lstm_fwd_wide{sfx} and "
           f"{total['bwd']} lstm_bwd_wide{sfx} launches at T={T} B={B} "
           f"H={H}, both directions, against the plain versions and the "
           f"first launch on each input: {len(wrong)} wrong"
           + (f"; (reverse, input, launch, fwd err, dgx err, dW err, "
              f"fwd bit-equal, bwd bit-equal): {wrong[:8]}" if wrong else ""))
    check(not wrong, f"a wide{sfx} kernel was wrong in {len(wrong)} "
          "repeated launches")


def fused_problem(g, dev, T, B, In, H):
    """A fused layer's inputs: x and the weights bf16, the bias f32, at the
    scale of the recipe's layers (weights U(+-1/sqrt(H)))."""
    import torch
    bf = torch.bfloat16
    x = (torch.randn((T, B, In), generator=g, device=dev) * 0.5).to(bf)
    w_ih = ((torch.rand((4 * H, In), generator=g, device=dev) * 2 - 1)
            / H ** 0.5).to(bf)
    bias = (torch.rand((4 * H,), generator=g, device=dev) * 2 - 1) / H ** 0.5
    w_hh = ((torch.rand((4 * H, H), generator=g, device=dev) * 2 - 1)
            / H ** 0.5).to(bf)
    return x, w_ih, bias, w_hh


def fused_bwd_problem(g, dev, T, B, In, H, reverse):
    """A fused backward's inputs: a forward trajectory from the plain
    version, random bf16 cotangents for every h and f32 ones for the final
    c."""
    import torch
    from mlvae_tpu_torch.ops.lstm import lstm_fused_fwd_ref
    x, w_ih, bias, w_hh = fused_problem(g, dev, T, B, In, H)
    hs, cs = lstm_fused_fwd_ref(x, w_ih, bias, w_hh, reverse)
    dhs = (torch.randn((T, B, H), generator=g, device=dev) * 0.1).to(
        torch.bfloat16)
    dc_last = torch.randn((B, H), generator=g, device=dev) * 0.1
    return x, w_ih, bias, w_hh, hs, cs, dhs, dc_last


def fused_fwd_errors(got, want):
    """(max abs error of hs, of cs, share of hs elements not bit-equal)."""
    hs_k, cs_k = got
    hs_r, cs_r = want
    return (max_err(hs_k, hs_r), max_err(cs_k, cs_r),
            float((hs_k != hs_r).float().mean()) if hs_r.numel() else 0.0)


def check_fused_fwd(dev, report):
    import torch
    from mlvae_tpu_torch.ops.lstm import lstm_fused_fwd, lstm_fused_fwd_ref
    g = torch.Generator(device=dev).manual_seed(21)
    worst = 0.0
    # the AMP step's shapes; the JAX bench's B=256; ragged B, T=1 and T=2;
    # the serial schedule (B=320: five batch tiles; In=4096: the layout
    # that keeps both tiles passes 227 KB)
    cases = [(160, 64, 128, 512), (160, 64, 512, 512), (160, 64, 1024, 512),
             (160, 256, 512, 512), (20, 256, 1024, 512), (1, 64, 128, 512),
             (2, 64, 512, 512), (1, 256, 1024, 512), (2, 256, 128, 512),
             (7, 1, 512, 512), (5, 63, 1024, 512), (5, 65, 512, 512),
             (4, 200, 128, 512), (9, 70, 128, 512), (5, 130, 1024, 512),
             (3, 320, 512, 512), (2, 70, 4096, 512), (6, 33, 136, 64)]
    for T, B, In, H in cases:
        prob = fused_problem(g, dev, T, B, In, H)
        for reverse in (False, True):
            got = lstm_fused_fwd(*prob, reverse)
            want = lstm_fused_fwd_ref(*prob, reverse)
            torch.cuda.synchronize()
            hs_err, cs_err, flipped = fused_fwd_errors(got, want)
            report(f"  lstm_fused_fwd T={T} B={B} In={In} H={H} reverse="
                   f"{reverse}: hs max_abs_err {hs_err:.3e}, cs {cs_err:.3e} "
                   f"(tol {FUSED_ATOL:g}); hs not bit-equal {flipped:.2e}")
            check(max(hs_err, cs_err) <= FUSED_ATOL,
                  f"lstm_fused_fwd disagrees: hs {hs_err}, cs {cs_err}")
            if T == 160 and B == 64:
                worst = max(worst, hs_err, cs_err)
    return worst


def fused_bwd_errors(got, want):
    """Each output's max error relative to its largest entry."""
    return [rel_err(a, b) for a, b in zip(got, want)]


def check_fused_bwd(dev, report):
    """Each backward against its plain version, at the AMP step's shapes,
    the JAX bench's B=256, T=1 and T=2 (where the prologue and the last
    step meet), ragged and serial-schedule batches; returns each kernel's
    worst max abs error of its streamed output (dX, dgx) at T=160."""
    import torch
    from mlvae_tpu_torch.ops import lstm as L
    g = torch.Generator(device=dev).manual_seed(22)
    worst = {"lstm_fused_bwd": 0.0, "lstm_semi_bwd": 0.0}
    cases = [  # (kernel, T, B, In, H)
        ("lstm_fused_bwd", 160, 64, 128, 512),
        ("lstm_fused_bwd", 160, 64, 512, 512),
        ("lstm_semi_bwd", 160, 64, 1024, 512),
        ("lstm_fused_bwd", 160, 256, 512, 512),
        ("lstm_semi_bwd", 160, 256, 1024, 512),
        ("lstm_fused_bwd", 1, 64, 512, 512),
        ("lstm_semi_bwd", 1, 64, 1024, 512),
        ("lstm_fused_bwd", 2, 64, 512, 512),
        ("lstm_semi_bwd", 2, 64, 1024, 512),
        # more than four batch tiles: the serial schedule
        ("lstm_fused_bwd", 5, 320, 512, 512),
        ("lstm_semi_bwd", 3, 320, 1024, 512),
        ("lstm_fused_bwd", 7, 1, 128, 512), ("lstm_semi_bwd", 7, 1, 1024, 512),
        ("lstm_fused_bwd", 9, 70, 512, 512),
        ("lstm_semi_bwd", 9, 70, 1024, 512),
        ("lstm_fused_bwd", 5, 130, 128, 512),
        ("lstm_semi_bwd", 5, 130, 1024, 512),
        ("lstm_fused_bwd", 6, 33, 136, 64), ("lstm_semi_bwd", 6, 33, 136, 64)]
    names = {"lstm_fused_bwd": ("dX", "dW_ih", "db", "dW_hh"),
             "lstm_semi_bwd": ("dgx", "dW_hh")}
    for name, T, B, In, H in cases:
        for reverse in (False, True):
            prob = fused_bwd_problem(g, dev, T, B, In, H, reverse)
            got = getattr(L, name)(*prob, reverse)
            want = getattr(L, name + "_ref")(*prob, reverse)
            torch.cuda.synchronize()
            errs = fused_bwd_errors(got, want)
            report(f"  {name} T={T} B={B} In={In} H={H} reverse={reverse}: "
                   "max err rel to largest entry "
                   + ", ".join(f"{n} {e:.3e}" for n, e in
                               zip(names[name], errs))
                   + f" (tol {FUSED_BWD_RTOL:g}); {names[name][0]} max "
                   f"abs err {max_err(got[0], want[0]):.3e}")
            check(max(errs) <= FUSED_BWD_RTOL, f"{name} disagrees: {errs}")
            if T == 160:
                worst[name] = max(worst[name], max_err(got[0], want[0]))
    return worst


def stress_fused(dev, report, repeats, bwd_repeats=FUSED_BWD_REPEATS):
    """Repeated launches of the fused kernels at the AMP step's shapes, back
    to back: the forward's each held against the plain version on its
    inputs; K3-bwd's and K4-bwd's the first against the plain version and
    every later one bit-equal to the first (their split barrier and
    concurrent warp groups are an ordering a race would break)."""
    import torch
    from mlvae_tpu_torch.ops import lstm as L
    g = torch.Generator(device=dev).manual_seed(23)
    T, B, H = 160, 64, 512
    total, wrong = 0, []
    for In in (128, 1024):
        for reverse in (False, True):
            prob = fused_problem(g, dev, T, B, In, H)
            want = L.lstm_fused_fwd_ref(*prob, reverse)
            for j in range(repeats):
                got = L.lstm_fused_fwd(*prob, reverse)
                err = max(fused_fwd_errors(got, want)[:2])
                total += 1
                if err > FUSED_ATOL:
                    wrong.append(("lstm_fused_fwd", In, reverse, j, err))
    total_bwd = 0
    for name, In in (("lstm_fused_bwd", 512), ("lstm_semi_bwd", 1024)):
        for reverse in (False, True):
            prob = fused_bwd_problem(g, dev, T, B, In, H, reverse)
            want = getattr(L, name + "_ref")(*prob, reverse)
            first = getattr(L, name)(*prob, reverse)
            err = max(fused_bwd_errors(first, want))
            if err > FUSED_BWD_RTOL:
                wrong.append((name, In, reverse, 0, err))
            for j in range(1, bwd_repeats + 1):
                got = getattr(L, name)(*prob, reverse)
                total_bwd += 1
                if not all(torch.equal(a, b) for a, b in zip(got, first)):
                    wrong.append((name, In, reverse, j, "not bit-equal"))
    report(f"  fused kernels repeated at T=160, B=64, H=512, both "
           f"directions: {total} K3/K4-fwd launches against the plain "
           f"version, {total_bwd} K3-bwd / K4-bwd launches against the "
           f"first: {len(wrong)} wrong"
           + (f"; wrong (kernel, In, reverse, launch, err): {wrong[:8]}"
              if wrong else ""))
    check(not wrong, f"fused kernels wrong in {len(wrong)} of "
          f"{total + total_bwd} repeated launches")


def stress_fwd_bits(dev, report, repeats=FWD_BIT_REPEATS):
    """Repeated K1-fwd (B=64 and 128) and K3/K4-fwd (In=1024 at B=64,
    In=512 at B=256) launches back to back, both directions, each
    bit-equal to the first: their split barriers, rings of TMA copies and
    (K3/K4-fwd) two warp groups are an ordering a race would break."""
    import torch
    from mlvae_tpu_torch.ops import lstm as L
    g = torch.Generator(device=dev).manual_seed(24)
    T, H = 160, 512
    total, wrong = 0, []
    cases = [("lstm_fwd", 64, None), ("lstm_fwd", 128, None),
             ("lstm_fused_fwd", 64, 1024), ("lstm_fused_fwd", 256, 512)]
    for name, B, In in cases:
        for reverse in (False, True):
            if name == "lstm_fwd":
                gx = torch.randn((T, B, 4 * H), generator=g, device=dev) * 0.5
                w = (torch.rand((4 * H, H), generator=g, device=dev) * 2
                     - 1) / H ** 0.5
                run = lambda: L.lstm_layer_fwd(gx, w, reverse)
            else:
                prob = fused_problem(g, dev, T, B, In, H)
                run = lambda: L.lstm_fused_fwd(*prob, reverse)
            first = run()
            same = [bit_equal(run(), first) for _ in range(repeats)]
            total += len(same)
            wrong += [(name, B, In, reverse, j)
                      for j, ok in enumerate(same) if not ok]
    report(f"  forwards repeated: {total} K1-fwd (B=64, 128) and K3/K4-fwd "
           f"(In=1024 B=64, In=512 B=256) launches at T=160, H=512, both "
           f"directions, against each case's first: {len(wrong)} not "
           "bit-equal" + (f"; wrong (kernel, B, In, reverse, launch): "
                          f"{wrong[:8]}" if wrong else ""))
    check(not wrong, f"forward kernels not bit-equal in {len(wrong)} of "
          f"{total} repeated launches")


def gru_problem(g, dev, T, B, H, bf16, reverse):
    """A K5 input at the scale of the recipe's layers (W_hh and b_hh
    U(+-1/sqrt(H))): gx and W_hh in the stream dtype, b_hh f32, the plain
    forward's hs (and hs32) and random cotangents in the stream dtype."""
    import torch
    from mlvae_tpu_torch.ops.gru import gru_layer_ref
    dt = torch.bfloat16 if bf16 else torch.float32
    gx = (torch.randn((T, B, 3 * H), generator=g, device=dev) * 0.5).to(dt)
    w = ((torch.rand((3 * H, H), generator=g, device=dev) * 2 - 1)
         / H ** 0.5).to(dt)
    b = (torch.rand((3 * H,), generator=g, device=dev) * 2 - 1) / H ** 0.5
    hs, hs32 = gru_layer_ref(gx, w, b, reverse)
    dhs = (torch.randn((T, B, H), generator=g, device=dev) * 0.1).to(dt)
    return gx, w, b, hs, hs32, dhs


def gru_errors(fwd, bwd, want_fwd, want_bwd):
    """(max abs error of hs and hs32; each backward output's max error
    relative to its largest entry)."""
    f = max(max_err(fwd[0], want_fwd[0]),
            max_err(fwd[1], want_fwd[1]) if want_fwd[1] is not None else 0.0)
    return f, [rel_err(a, b) for a, b in zip(bwd, want_bwd)]


def gru_plans(dev, report):
    """Phase 1: K5's launch plans as the C code computes them (blocks,
    threads, shared memory, blocks an SM can hold, boxes, ring buffers or
    stages, registers, local bytes) at H=512, 208 and 528 (K5-bwd at B=64,
    one tile and the split barrier, and B=70, the tiles in series), the
    f32 builds beside the bf16 ones (and their dW_hh kernel), against
    ``ops.gru.k5_plan``: each cooperative grid co-resident on this card, no
    spills."""
    import torch
    from mlvae_tpu_torch.ops import gru as G
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for H in (512, 208, 528):
        for bf16 in (False, True):
            for direction, B in (("fwd", 64), ("bwd", 64), ("bwd", 70),
                                 ("dw", 64))[:4 if bf16 else 3]:
                got = G.k5_launch_plan(direction, H, B, bf16)
                want = G.k5_plan(direction, H, bf16)
                name = f"gru_{direction}" + ("_bf16" if bf16 else "")
                key = f"{name} H={H} B={B}"
                out[key] = got
                report(f"  plan {key}: grid {got['blocks']} x "
                       f"{got['threads']} threads, shared memory "
                       f"{got['smem_bytes']} B, ring {got['ring']}, rows "
                       f"{got['rows']}, {got['blocks_per_sm']} block(s) an "
                       f"SM resident, {got['registers']} registers, "
                       f"{got['local_bytes']} B local a thread; {sms} SMs")
                ring = ({"fwd": want.boxes, "bwd": 16, "dw": G.DW_STAGES}
                        [direction] if bf16 else want.boxes)
                check((got["blocks"], got["threads"], got["smem_bytes"],
                       got["rows"], got["ring"]) == (
                           want.blocks, want.threads, want.smem_bytes,
                           want.rows, ring),
                      f"{key} plan {got} != {want}")
                check(got["blocks_per_sm"] >= 1 and
                      (direction == "dw" or
                       got["blocks"] <= got["blocks_per_sm"] * sms),
                      f"{key}: the grid cannot be co-resident")
                check(got["local_bytes"] == 0,
                      f"{key} spills: {got['local_bytes']} B local")
    return out


def check_gru(dev, report):
    """K5-fwd and K5-bwd against their plain versions, f32 and bf16 (the
    tensor-core builds), both directions, at the gate-3 shape and ragged
    ones (B=5, T=1, T=2, H=128, a B past one tile of 64; H=208, a multiple
    of 16 but not of 64 or 128, and the widest, 528, past one tile); and
    K5-bwd's bf16 dW_hh kernel against its plain version on its own
    operands. Returns the worst max abs error of hs and of dgx at the full
    shape, per kernel."""
    import torch
    from mlvae_tpu_torch import _build
    from mlvae_tpu_torch.ops import gru as G
    g = torch.Generator(device=dev).manual_seed(41)
    worst = {"gru_fwd": 0.0, "gru_bwd": 0.0, "gru_fwd_bf16": 0.0,
             "gru_bwd_bf16": 0.0}
    cases = [(160, 64, 512), (1, 64, 512), (2, 64, 512), (7, 5, 512),
             (9, 70, 128), (12, 3, 128), (6, 70, 208), (5, 130, 528)]
    for T, B, H in cases:
        for bf16 in (False, True):
            atol, rtol = ((GRU_BF16_ATOL, GRU_BF16_BWD_RTOL) if bf16
                          else (GRU_ATOL, GRU_BWD_RTOL))
            for reverse in (False, True):
                gx, w, b, hs, hs32, dhs = gru_problem(g, dev, T, B, H, bf16,
                                                      reverse)
                fwd = G.gru_layer_fwd(gx, w, b, reverse)
                bwd = G.gru_layer_bwd(gx, w, b, hs, hs32, dhs, reverse)
                want_bwd = G.gru_layer_bwd_ref(gx, w, b, hs, hs32, dhs,
                                               reverse)
                torch.cuda.synchronize()
                f_err, b_errs = gru_errors(fwd, bwd, (hs, hs32), want_bwd)
                ok_dtype = (fwd[0].dtype == gx.dtype
                            and (fwd[1] is None) == (not bf16)
                            and bwd[0].dtype == gx.dtype)
                report(f"  gru T={T} B={B} H={H} "
                       f"{'bf16' if bf16 else 'f32'} reverse={reverse}: "
                       f"hs max_abs_err {f_err:.3e} (tol {atol:g}); "
                       "backward max err rel to largest entry "
                       + ", ".join(f"{n} {e:.3e}" for n, e in zip(
                           ("dgx", "dW_hh", "db_hh"), b_errs))
                       + f" (tol {rtol:g}); dgx max abs err "
                       f"{max_err(bwd[0], want_bwd[0]):.3e}")
                check(ok_dtype, "gru kernels returned the wrong dtypes")
                check(f_err <= atol, f"gru_fwd disagrees: {f_err}")
                check(max(b_errs) <= rtol, f"gru_bwd disagrees: {b_errs}")
                if (T, B, H) == cases[0]:
                    sfx = "_bf16" if bf16 else ""
                    worst["gru_fwd" + sfx] = max(worst["gru_fwd" + sfx],
                                                 f_err)
                    worst["gru_bwd" + sfx] = max(
                        worst["gru_bwd" + sfx], max_err(bwd[0],
                                                        want_bwd[0]))
    # the dW_hh kernel alone, on the plain BPTT's bf16(dgh) and hs
    worst["gru_dw_bf16"] = 0.0
    for T, B, H in ((160, 64, 512), (6, 70, 208)):
        for reverse in (False, True):
            gx, w, b, hs, hs32, dhs = gru_problem(g, dev, T, B, H, True,
                                                  reverse)
            dgx, _, _, dgh = G.gru_layer_bwd_ref(gx, w, b, hs, hs32, dhs,
                                                 reverse, with_dgh=True)
            dgn = dgh[..., 2 * H:].contiguous()
            got = torch.empty((3 * H, H), device=dev)
            G.GRU_DW_BF16(dgx.data_ptr(), dgn.data_ptr(), hs.data_ptr(),
                          got.data_ptr(), T, B, H, int(reverse),
                          _build.stream_handle(dev))
            want = G.gru_dw_ref(dgx, dgn, hs, reverse)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            report(f"  gru_dw_bf16 T={T} B={B} H={H} reverse={reverse} on "
                   f"its operands: max err rel to largest entry {err:.3e} "
                   f"(tol {BWD_RTOL:g})")
            check(err <= BWD_RTOL, f"gru_dw_bf16 disagrees: {err}")
            if T == 160:
                worst["gru_dw_bf16"] = max(worst["gru_dw_bf16"],
                                           max_err(got, want))
    return worst


def stress_gru(dev, report, repeats):
    """Repeated K5-fwd and K5-bwd launches at the gate-3 shape, back to
    back, each held against the plain version on its inputs and bit-equal
    to the first of its dtype and direction: per kernel and direction
    ``repeats`` launches, half in f32 and half in bf16 (the tensor-core
    builds)."""
    import torch
    from mlvae_tpu_torch.ops import gru as G
    g = torch.Generator(device=dev).manual_seed(42)
    T, B, H = 160, 64, 512
    total, wrong, unequal = 0, [], []
    for bf16 in (False, True):
        atol, rtol = ((GRU_BF16_ATOL, GRU_BF16_BWD_RTOL) if bf16
                      else (GRU_ATOL, GRU_BWD_RTOL))
        for reverse in (False, True):
            gx, w, b, hs, hs32, dhs = gru_problem(g, dev, T, B, H, bf16,
                                                  reverse)
            want_bwd = G.gru_layer_bwd_ref(gx, w, b, hs, hs32, dhs, reverse)
            first = None
            for j in range(repeats // 2):
                fwd = G.gru_layer_fwd(gx, w, b, reverse)
                bwd = G.gru_layer_bwd(gx, w, b, hs, hs32, dhs, reverse)
                f_err, b_errs = gru_errors(fwd, bwd, (hs, hs32), want_bwd)
                total += 2
                if f_err > atol or max(b_errs) > rtol:
                    wrong.append((bf16, reverse, j, f_err, max(b_errs)))
                outs = [x for x in (*fwd, *bwd) if x is not None]
                if first is None:
                    first = outs
                elif not all(torch.equal(a, c) for a, c in zip(outs, first)):
                    unequal.append((bf16, reverse, j))
    report(f"  gru kernels repeated: {total} launches at T=160, B=64, "
           f"H=512, f32 and bf16, both directions: {len(wrong)} wrong, "
           f"{len(unequal)} not bit-equal to the first"
           + (f"; wrong (bf16, reverse, launch, hs err, bwd err): "
              f"{wrong[:8]}" if wrong else "")
           + (f"; unequal (bf16, reverse, launch): {unequal[:8]}"
              if unequal else ""))
    check(not wrong, f"gru kernels wrong in {len(wrong)} of {total} "
          "repeated launches")
    check(not unequal, f"gru kernels not bit-equal in {len(unequal)} of "
          f"{total} repeated launches")


def unroll_problem(g, dev, T, B, H, dtype):
    """A K7a input at the scale of the recipe's layers: gx N(0, 0.5^2) and
    W_hh U(+-1/sqrt(H)), both in ``dtype``."""
    import torch
    gx = (torch.randn((T, B, 4 * H), generator=g, device=dev) * 0.5).to(dtype)
    w = ((torch.rand((4 * H, H), generator=g, device=dev) * 2 - 1)
         / H ** 0.5).to(dtype)
    return gx, w


def bit_equal(got, want) -> bool:
    import torch
    return all(torch.equal(a, b) for a, b in zip(got, want))


def unroll_twin(name, prob, reverse):
    """The one-step twin of a K7 build on its input: K1-fwd of the stream
    dtype (its tensor-core build on bf16 streams) for K7a, K3/K4-fwd of the
    stream dtype for K7b."""
    from mlvae_tpu_torch.ops import lstm as L
    if name.startswith("lstm_unroll_fused_fwd"):
        return L.lstm_fused_fwd(*prob, reverse)
    return L.lstm_layer_fwd(*prob, reverse)


def unroll_run(name, prob, reverse, K):
    from mlvae_tpu_torch.ops import lstm_unroll_exp as LU
    if name.startswith("lstm_unroll_fused_fwd"):
        return LU.run_fwd_fused_k(*prob, reverse, K)
    return LU.run_fwd_k(*prob, reverse, K)


def unroll_builds(g, dev, T, B, H=512, In=512):
    """(build, input) of the four redesigned K7 builds at one shape: K7a
    in f32 and on bf16 streams, K7b on bf16 and f32 streams at ``In``."""
    import torch
    return (("lstm_unroll_fwd", unroll_problem(g, dev, T, B, H,
                                               torch.float32)),
            ("lstm_unroll_fwd_bf16", unroll_problem(g, dev, T, B, H,
                                                    torch.bfloat16)),
            ("lstm_unroll_fused_fwd", fused_problem(g, dev, T, B, In, H)),
            ("lstm_unroll_fused_fwd_f32", f32_problem(g, dev, T, B, In, H)))


def check_unroll(dev, report, T=160, B=128, H=512):
    """K7a and K7b on the card. At the unroll bench's shape (T=160, B=128,
    H=512; In=512 and 128 for K7b), K in ``UNROLL_KS`` and both
    directions: K7a in f32 bit-equal to K1-fwd, K7a on bf16 streams
    bit-equal to the bf16 K1-fwd (its tensor-core build; K=1 too), K7b
    bit-equal to K3/K4-fwd, and each twin against the plain version. At
    the ragged batches ``UNROLL_RAGGED_B`` (T=16 and K in ``UNROLL_KS``;
    T=1 and 2 with K=T), both directions: each of the three builds
    bit-equal to its twin. At T=K, ragged B (5, 70, 130), H=128 and H=64:
    each kernel against the plain version, where bf16 K7a refuses H=64 (H
    % 128) before any launch. A T that is not a multiple of K is refused
    before any launch. Returns each kernel's worst max abs error against
    the plain versions at the bench shape."""
    import torch
    from mlvae_tpu_torch.ops import lstm as L
    from mlvae_tpu_torch.ops import lstm_unroll_exp as LU
    g = torch.Generator(device=dev).manual_seed(51)
    bf = torch.bfloat16
    worst = {"lstm_unroll_fwd": 0.0, "lstm_unroll_fwd_bf16": 0.0,
             "lstm_unroll_fused_fwd": 0.0}
    for dtype, tol in ((torch.float32, LSTM_ATOL), (bf, FUSED_ATOL)):
        gx, w = unroll_problem(g, dev, T, B, H, dtype)
        f32 = dtype == torch.float32
        name = "lstm_unroll_fwd" if f32 else "lstm_unroll_fwd_bf16"
        for reverse in (False, True):
            twin = L.lstm_layer_fwd(gx, w, reverse)
            same = {K: bit_equal(LU.run_fwd_k(gx, w, reverse, K), twin)
                    for K in (1, *UNROLL_KS)}
            plain = LU.run_fwd_k_ref(gx, w, reverse, 1)
            torch.cuda.synchronize()
            hs_err, cs_err, flipped = fused_fwd_errors(twin, plain)
            report(f"  {name} T={T} B={B} H={H} reverse={reverse}: "
                   f"bit-equal to lstm_fwd{'' if f32 else ' (bf16 streams)'}"
                   f" at K {same}; the twin against the plain version: hs "
                   f"max_abs_err {hs_err:.3e}, cs {cs_err:.3e} (tol "
                   f"{tol:g}); hs not bit-equal {flipped:.2e}")
            check(all(same.values()), f"{name} differs from its twin: "
                  f"{same}")
            check(max(hs_err, cs_err) <= tol,
                  f"{name} disagrees: hs {hs_err}, cs {cs_err}")
            worst[name] = max(worst[name], hs_err, cs_err)
    for In in (512, 128):
        prob = fused_problem(g, dev, T, B, In, H)
        for reverse in (False, True):
            twin = L.lstm_fused_fwd(*prob, reverse)
            same = {K: bit_equal(LU.run_fwd_fused_k(*prob, reverse, K), twin)
                    for K in UNROLL_KS}
            plain = LU.run_fwd_fused_k_ref(*prob, reverse, UNROLL_KS[0])
            torch.cuda.synchronize()
            hs_err, cs_err, flipped = fused_fwd_errors(twin, plain)
            report(f"  lstm_unroll_fused_fwd T={T} B={B} In={In} H={H} "
                   f"reverse={reverse}: bit-equal to lstm_fused_fwd at K "
                   f"{same}; against the plain version: hs max_abs_err "
                   f"{hs_err:.3e}, cs {cs_err:.3e} (tol {FUSED_ATOL:g}); hs "
                   f"not bit-equal {flipped:.2e}")
            check(all(same.values()), "lstm_unroll_fused_fwd differs from "
                  f"lstm_fused_fwd: {same}")
            check(max(hs_err, cs_err) <= FUSED_ATOL,
                  f"lstm_unroll_fused_fwd disagrees: hs {hs_err}, cs "
                  f"{cs_err}")
            worst["lstm_unroll_fused_fwd"] = max(
                worst["lstm_unroll_fused_fwd"], hs_err, cs_err)
    # the ragged batches, each build bit-equal to its twin
    unequal, n = [], 0
    for Br in UNROLL_RAGGED_B:
        for Tr, Ks in ((16, UNROLL_KS), (1, (1,)), (2, (2,))):
            for name, prob in unroll_builds(g, dev, Tr, Br, H):
                for reverse in (False, True):
                    twin = unroll_twin(name, prob, reverse)
                    for K in Ks:
                        n += 1
                        if not bit_equal(unroll_run(name, prob, reverse, K),
                                         twin):
                            unequal.append((name, Tr, Br, K, reverse))
    torch.cuda.synchronize()
    report(f"  K7 ragged: B {list(UNROLL_RAGGED_B)}, T=16 at K "
           f"{list(UNROLL_KS)}, T=1 and 2 at K=T, both directions, H={H}, "
           f"In=512: {n - len(unequal)} of {n} launches bit-equal to their "
           "twins" + (f"; unequal (build, T, B, K, reverse): {unequal[:8]}"
                      if unequal else ""))
    check(not unequal, f"K7 builds differ from their twins at ragged "
          f"shapes: {unequal[:8]}")
    # (T, B, H, In, K): T=K, ragged batches, narrower H and an odd In
    refused_h = []
    for T, B, H, In, K in ((4, 128, 512, 512, 4), (16, 5, 512, 128, 8),
                           (12, 70, 512, 512, 4), (10, 130, 128, 128, 2),
                           (8, 33, 64, 136, 8)):
        for reverse in (False, True):
            errs = []
            for dtype, tol in ((torch.float32, LSTM_ATOL), (bf, FUSED_ATOL)):
                gx, w = unroll_problem(g, dev, T, B, H, dtype)
                name = ("lstm_unroll_fwd" if dtype == torch.float32
                        else "lstm_unroll_fwd_bf16")
                if dtype == bf and H % 128:
                    # the JAX dispatch's rule: no bf16 Pallas LSTM below it
                    before = LU.LSTM_UNROLL_FWD_BF16.launches
                    try:
                        LU.run_fwd_k(gx, w, reverse, K)
                    except ValueError as e:
                        refused_h.append(str(e)[:60])
                    check(LU.LSTM_UNROLL_FWD_BF16.launches == before,
                          f"bf16 K7a launched at H={H}")
                    continue
                got = LU.run_fwd_k(gx, w, reverse, K)
                errs.append((name, tol, fused_fwd_errors(
                    got, LU.run_fwd_k_ref(gx, w, reverse, K))))
            prob = fused_problem(g, dev, T, B, In, H)
            errs.append(("lstm_unroll_fused_fwd", FUSED_ATOL, fused_fwd_errors(
                LU.run_fwd_fused_k(*prob, reverse, K),
                LU.run_fwd_fused_k_ref(*prob, reverse, K))))
            torch.cuda.synchronize()
            report(f"  K7 T={T} B={B} H={H} In={In} K={K} reverse={reverse}:"
                   " against the plain versions, hs/cs max_abs_err "
                   + ", ".join(f"{n} {e[0]:.3e}/{e[1]:.3e} (tol {tol:g})"
                               for n, tol, e in errs))
            for n, tol, e in errs:
                check(max(e[:2]) <= tol, f"{n} disagrees at T={T} B={B} "
                      f"H={H} K={K}: {e}")
    report(f"  bf16 K7a at H=64 refused before a launch: {len(refused_h)} of "
           f"2 ({refused_h[:1]})")
    check(len(refused_h) == 2, "bf16 K7a at H=64 was not refused")
    kernels = (LU.LSTM_UNROLL_FWD, LU.LSTM_UNROLL_FWD_BF16,
               LU.LSTM_UNROLL_FUSED_FWD)
    before = sum(k.launches for k in kernels)
    gx, w = unroll_problem(g, dev, 7, 8, 64, torch.float32)
    prob = fused_problem(g, dev, 7, 8, 128, 64)
    refused = []
    for call in (lambda: LU.run_fwd_k(gx, w, False, 2),
                 lambda: LU.run_fwd_fused_k(*prob, False, 2)):
        try:
            call()
        except ValueError:
            refused.append(True)
    after = sum(k.launches for k in kernels)
    report(f"  T=7, K=2 refused before a launch: {len(refused)} of 2, "
           f"launches {after - before}")
    check(len(refused) == 2 and after == before,
          "a T that is not a multiple of K was not refused")
    return worst


def unroll_plans(dev, report):
    """Phase 1: the launch plans of the three redesigned K7 builds as their
    C code computes them (``*_plan`` entry points) against
    ``ops.lstm_unroll_exp.k7a_plan`` / ``k7b_plan``: K 1, 2, 4, 8 at B 1,
    63, 128, 200, 320 (H=512; K7a f32 also H=16 and 528, bf16 H=128 and
    1024; K7b In 128 and 512), with registers and local bytes a thread."""
    from mlvae_tpu_torch.ops import lstm_unroll_exp as LU
    out, bad = {}, []
    spills = {}
    cases = [("lstm_unroll_fwd", H, 0) for H in (16, 512, 528)]
    cases += [("lstm_unroll_fwd_bf16", H, 0) for H in (128, 512, 1024)]
    cases += [("lstm_unroll_fused_fwd", 512, In) for In in (128, 512)]
    for build, H, In in cases:
        for B in (1, 63, 128, 200, 320):
            for K in (1, *UNROLL_KS):
                got = LU.device_plan(build, H, B, K, In)
                want = (LU.k7b_plan(In, H, B, K) if In
                        else LU.k7a_plan(H, B, K, build.endswith("bf16")))
                key = f"{build} In={In} H={H} B={B} K={K}"
                out[key] = got
                if (got["blocks"], got["threads"], got["smem_bytes"],
                        got["ring"], got["bufs"], got["tiles"],
                        bool(got["serial"])) != (
                        want.blocks, want.threads, want.smem_bytes,
                        want.ring, want.bufs, want.tiles, want.serial):
                    bad.append((key, got, want))
                spills[build] = (got["registers"], got["local_bytes"])
    report(f"  plan K7: {len(out)} shapes of lstm_unroll_fwd, _bf16 and "
           f"lstm_unroll_fused_fwd against the host's plans: {len(bad)} "
           f"differ; registers, local bytes a thread {spills}"
           + (f"; first: {bad[0]}" if bad else ""))
    check(not bad, f"K7 launch plans differ from the host's: {bad[:4]}")
    return out


def fused_f32_fwd_plans(dev, report):
    """Phase 1: the f32 forward's launch plan (K3/K4-fwd, and K7b with K)
    as its C code computes it (``ops.lstm.fused_f32_fwd_launch_plan``)
    against the CPU mirror ``ops.lstm.fused_f32_fwd_plan`` at every H the
    fused kernels take (16 to 528, step 16), In 4 to 2048, B 1 to 1000 and
    K 1, 2, 4, 8; then the kernel's registers and local bytes a thread.
    Returns the plans at the main path's shapes."""
    from mlvae_tpu_torch.ops import lstm as L
    keys = ("schedule", "slots", "ring", "xslots", "threads", "smem",
            "scratch")
    npts, differ = 0, []
    for H in range(16, 529, 16):
        for In in (4, 8, 36, 120, 128, 256, 512, 640, 1024, 2048):
            for B in (1, 63, 64, 65, 70, 128, 200, 256, 320, 1000):
                for K in (1, *UNROLL_KS):
                    c = L.fused_f32_fwd_launch_plan.__wrapped__(In, H, B, K)
                    py = L.fused_f32_fwd_plan(In, H, B, K)
                    npts += 1
                    if tuple(c[n] for n in keys) != tuple(py):
                        differ.append((In, H, B, K, c, py))
    out = {f"In={In} H={H} B={B} K={K}": L.fused_f32_fwd_launch_plan(
        In, H, B, K) for In, H, B, K in ((128, 512, 64, 1), (512, 512, 64, 1),
                                          (512, 512, 128, 1),
                                          *((512, 512, 128, K)
                                            for K in UNROLL_KS))}
    regs = next(iter(out.values()))
    report(f"  plan f32 K3/K4-fwd and K7b: the C plan against "
           f"ops.lstm.fused_f32_fwd_plan at {npts} (In, H, B, K): "
           f"{len(differ)} differ" + (f"; first: {differ[:2]}" if differ
                                      else "")
           + f"; lstm_fused_fwd_f32_kernel {regs['registers']} registers, "
           f"{regs['local_bytes']} B local a thread; at the main shapes "
           + "; ".join(f"{k}: slots {v['slots']}, ring {v['ring']}, "
                       f"{v['smem']} B" for k, v in out.items()))
    check(not differ, f"the f32 forward's plan differs at {len(differ)} "
          "points")
    return out


def stress_unroll(dev, report, repeats, T=160, B=128, H=512):
    """Repeated K7a (f32 and bf16) and K7b launches at the unroll bench's
    shape with K=8, back to back, each bit-equal to its twin's output (and
    so to the first)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(52)
    K = UNROLL_KS[-1]
    total, wrong = 0, []
    for name, prob in unroll_builds(g, dev, T, B, H):
        for reverse in (False, True):
            twin = unroll_twin(name, prob, reverse)
            for j in range(repeats):
                total += 1
                if not bit_equal(unroll_run(name, prob, reverse, K), twin):
                    wrong.append((name, reverse, j))
    report(f"  K7 repeated: {total} launches at T={T}, B={B}, H={H}, K={K}, "
           f"both directions: {len(wrong)} not bit-equal to their twins"
           + (f"; wrong (kernel, reverse, launch): {wrong[:8]}"
              if wrong else ""))
    check(not wrong, f"K7 kernels wrong in {len(wrong)} of {total} repeated "
          "launches")


def check_viterbi(dev, report):
    """K2, one launch a decode, against the plain decode and the plain
    lattice, bit for bit: L = 1, 3, 8, 32, 40, 64, 100, 181, 200, 512 (every
    build: 1, 2, 4, 8 and 16 carry slots a lane, each with no local
    memory); T = 1, 5, 160, 600, 1100, 2000, and T < L at L=512; weights 0,
    0.5, 1, 2; quantized ties; B = 1 (``infer``'s shape); the choices kept
    in shared memory and, where T * L * 2 bytes pass 64 KB, read back from
    global memory, both at every slot count (each case's route from
    ``viterbi_plan``, held against the kernel's own plan). Returns the
    main path's problem (B=64, T=160, L=8), one at B=1, and the largest
    error of the lattice and of the decode."""
    import numpy as np
    import torch
    from mlvae_tpu_torch.ops import decode as dec
    rs = np.random.RandomState(7)
    worst = {"lattice": 0.0, "backtrace": 0.0}
    cases = [  # (B, T, N, L, weight, quantize)
        (64, 160, 14, 8, 1.0, False), (64, 160, 14, 8, 0.5, True),
        (64, 160, 14, 8, 0.0, True), (64, 160, 14, 8, 2.0, False),
        (64, 160, 14, 1, 1.0, True), (5, 1, 14, 1, 1.0, False),
        (16, 160, 14, 40, 1.0, True), (3, 5, 6, 3, 1.0, True),
        (1, 160, 14, 8, 1.0, False), (16, 160, 14, 64, 1.0, True),
        (16, 160, 14, 64, 0.5, False), (4, 600, 14, 64, 1.0, True),
        (4, 2000, 14, 40, 0.5, False), (4, 160, 14, 100, 1.0, True),
        (4, 400, 14, 100, 0.5, False), (2, 181, 14, 181, 1.0, True),
        (2, 300, 14, 200, 0.5, False), (2, 64, 14, 512, 1.0, False),
        (2, 600, 14, 512, 1.0, True), (2, 1100, 14, 32, 1.0, True)]
    routes = set()
    for B, T, N, L, w, q in cases:
        prob = viterbi_problem(rs, dev, B, T, N, L, w, q)
        plan = dec.viterbi_plan(T, L)
        card = dec.viterbi_launch_plan(T, L)
        routes.add((plan["slots"], plan["choices"]))
        before = dec.VITERBI.launches
        got = dec.md_viterbi_batch_cuda(*prob)
        one = dec.VITERBI.launches - before
        want = dec.md_viterbi_batch_ref(*prob)
        yx, y_, y, lpb, lpi, tl, ll, _ = prob
        paths_k, beta_k = dec.md_viterbi_lattice_cuda(
            yx, y_, y, lpb, dec.fold_weight(lpi, w), tl, ll)
        paths_r, beta_r = dec.md_viterbi_lattice_ref(
            yx, y_, y, lpb, dec.fold_weight(lpi, w), tl.long(), ll.long())
        torch.cuda.synchronize()
        same = all(torch.equal(a.long(), b.long()) for a, b in zip(got, want))
        same_lat = torch.equal(paths_k.long().permute(1, 0, 2, 3), paths_r) \
            and torch.equal(beta_k.long(), beta_r.long())
        worst["lattice"] = max(
            worst["lattice"], max_err(paths_k.permute(1, 0, 2, 3), paths_r),
            max_err(beta_k, beta_r))
        worst["backtrace"] = max(worst["backtrace"], *(
            max_err(a, b) for a, b in zip(got, want)))
        report(f"  md_viterbi B={B} T={T} L={L} w={w} quantized={q}: "
               f"outputs bit-exact {same}, lattice bit-exact {same_lat}; "
               f"{one} launch; choices in {plan['choices']} memory; plan "
               f"{card}")
        check(same and same_lat, "md_viterbi disagrees with its plain "
              "version")
        check(one == 1, f"md_viterbi took {one} launches for one decode")
        check({k: card[k] for k in plan} == plan and card["local_bytes"] == 0,
              f"md_viterbi's plan {card} is not {plan}")
    check(routes == {(n, c) for n in (1, 2, 4, 8, 16)
                     for c in ("shared", "global")},
          f"the builds and routes run were only {sorted(routes)}")
    # the main path's decode shapes, for the timings
    return (viterbi_problem(rs, dev, 64, 160, 14, 8, 1.0),
            viterbi_problem(rs, dev, 1, 160, 14, 8, 1.0), worst)


KALDI_PASS = (256, 104_000)  # utterances, and the longest one's samples:
                             # one batch of compute_kaldi_features, 325
                             # frames (docs/fbank_pallas_ab.json's shape)
KALDI_SPEAKERS = 8           # of the pass's utterances, 32 each


def kaldi_pass_waves():
    """The Kaldi pass's utterances, as their wav files hold them (in
    [-1, 1]): ``bench_utils.synth_wave``'s tones and noise, amplitude-
    modulated (CMVN divides by each band's deviation), of lengths from a
    quarter of the longest to the longest, one of 170 samples (under half
    a window: reflected more than once)."""
    import numpy as np
    from mlvae_tpu_torch.bench_utils import synth_wave
    B, longest = KALDI_PASS
    lengths = np.random.RandomState(41).randint(longest // 4, longest + 1, B)
    lengths[0], lengths[1] = longest, 170
    return [synth_wave(int(n), 30 + i, 0.25, am_hz=3.0)
            for i, n in enumerate(lengths)]


def kaldi_pass_batch(dev, utts):
    """The batch ``compute_kaldi_features`` hands its extractor for
    ``utts``: int16-scale waves padded to the longest, on the card, and
    their lengths on the host."""
    import torch
    from mlvae_tpu_torch.data.data_io import int16_batch
    waves, lengths = int16_batch(utts)
    return torch.from_numpy(waves).to(dev), torch.from_numpy(lengths)


DFT_N = 448   # an n_fft that takes K6's DFT build (N/2 = 2^5 * 7)
FFT_GENERIC_N = (480, 256, 60)  # widths whose FFT passes are read at run
                                # time (phase 2 only)


def fbank_frames_of(mode, waves, lengths, max_frames, n_fft=400):
    """The (rows, N) frames the extractors hand K6."""
    from mlvae_tpu_torch.ops import fbank as fb
    if mode == fb.KALDI:
        return fb.kaldi_frames(waves, lengths, max_frames, 320, 400)
    return fb.sb_frame_gather(waves, lengths, max_frames, 320,
                              n_fft).reshape(-1, n_fft)


def k6(frames, mode, build=None):
    """K6 on ``frames`` as the extractors call it (the SpeechBrain mode's
    window is the frame, n_fft; Kaldi's 400 samples of 512 columns): by
    the build its plan picks, or by ``build`` ("fft", "dft")."""
    from mlvae_tpu_torch.ops import fbank as fb
    window = 400 if mode == fb.KALDI else frames.shape[1]
    if build is None:
        return fb.fbank_frames_cuda(frames, mode, window=window)
    return fb._launch(build, frames, mode, window=window)


def k6_ref(frames, mode, **kw):
    from mlvae_tpu_torch.ops import fbank as fb
    window = 400 if mode == fb.KALDI else frames.shape[1]
    return fb.fbank_frames_ref(frames, mode, window=window, **kw)


def fbank_cases(dev, B=64, T=160):
    """K6's shapes on the main paths: (label, mode, frames, repeat): the
    Kaldi pass's batch, the wav-in eval batch (both repeated in phase 2),
    one utterance of T frames in each mode (the FFT build takes all of
    them: N = 512 and 400), and the wav-in batch at n_fft = ``DFT_N``,
    which takes the DFT build (repeated)."""
    from mlvae_tpu_torch.bench_utils import synth_wav_batch
    from mlvae_tpu_torch.ops import fbank as fb
    waves, lengths = kaldi_pass_batch(dev, kaldi_pass_waves())
    mf = (waves.shape[1] + 160) // 320
    cases = [(f"kaldi B={waves.shape[0]} x {mf}", fb.KALDI,
              fbank_frames_of(fb.KALDI, waves, lengths, mf), True)]
    del waves
    for b in (B, 1):
        waves, lengths = synth_wav_batch(b, T, seed=0, device=dev)
        if b == 1:
            cases.append((f"kaldi B=1 x {T - 1}", fb.KALDI, fbank_frames_of(
                fb.KALDI, waves * 32768.0, lengths, T - 1), False))
        cases.append((f"sb B={b} x {T}", fb.SB,
                       fbank_frames_of(fb.SB, waves, lengths, T), b > 1))
        if b > 1:
            cases.append((f"sb n_fft={DFT_N} B={b} x {T}", fb.SB,
                          fbank_frames_of(fb.SB, waves, lengths, T, DFT_N),
                          True))
    return cases


def check_fbank(dev, report, cases):
    """K6 in both modes against its plain version at the main paths'
    shapes, each by the build ``fbank_plan`` picks for its width (and the
    DFT build also at the FFT build's widths), repeated launches
    bit-identical, the FFT build's launch plan (no local memory), its
    passes read at run time at ``FFT_GENERIC_N``, and both extractors with
    each build on the card against the float64 golden on
    ``tests/test_fbank_pallas.py``'s two utterances. Returns the max abs
    error per case and build."""
    import functools
    import numpy as np
    import torch
    from mlvae_tpu_torch.bench_utils import synth_wav_batch, synth_wave
    from mlvae_tpu_torch.ops import fbank as fb
    from mlvae_tpu_torch.ops import frontend_ref as ref
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmuls are on: the plain version would not be f32")
    errs = {}
    for label, mode, frames, repeat in cases:
        plan = fb.fbank_plan(frames.shape[1])
        want = k6_ref(frames, mode)
        tol = FBANK_KALDI_ATOL if mode == fb.KALDI else FBANK_SB_ATOL
        for build in ((plan, "dft") if plan == "fft" else (plan,)):
            before = fb.BUILDS[build].launches
            got = k6(frames, mode) if build == plan else k6(frames, mode,
                                                            build)
            torch.cuda.synchronize()
            check(fb.BUILDS[build].launches == before + 1,
                  f"fbank {label}: the {build} build did not launch")
            errs[label, build] = max_err(got, want)
            same = all(torch.equal(k6(frames, mode, build), got)
                       for _ in range(FBANK_REPEATS if repeat else 0))
            report(f"  fbank {label} ({frames.shape[0]} frames of "
                   f"{frames.shape[1]}), {build} build"
                   f"{' (the plan)' if build == plan else ''}: max_abs_err "
                   f"{errs[label, build]:.3e} (tol {tol:g}); finite "
                   f"{bool(torch.isfinite(got).all())}"
                   + (f"; {FBANK_REPEATS} repeats bit-identical {same}"
                      if repeat else ""))
            check(errs[label, build] <= tol
                  and bool(torch.isfinite(got).all()),
                  f"fbank {label} ({build}) disagrees: {errs[label, build]}")
            check(same, f"fbank {label} ({build}): repeated launches differ")
        if plan == "fft":
            card = fb.fbank_fft_launch_plan(frames.shape[0], frames.shape[1],
                                            mode)
            report(f"    plan fbank_fft: {card}")
            check(card["local_bytes"] == 0, f"fbank_fft spills: {card}")

    # the FFT build's passes read at run time, at widths no recipe uses:
    # radix 3 (480 = 2 (4, 4, 3, 5)), radix 8 first (256 = 2 (8, 4, 4)),
    # radix 2 (60 = 2 (2, 3, 5))
    waves, lengths = synth_wav_batch(4, 160, seed=1, device=dev)
    for n in FFT_GENERIC_N:
        frames = fbank_frames_of(fb.SB, waves, lengths, 160, n)
        card = fb.fbank_fft_launch_plan(frames.shape[0], n, fb.SB, window=n)
        got = k6(frames, fb.SB)
        err = max_err(got, k6_ref(frames, fb.SB))
        same = torch.equal(k6(frames, fb.SB), got)
        report(f"  fbank sb n_fft={n} B=4 x 160, fft build, radices "
               f"{fb.fft_radices(n // 2)} read at run time: max_abs_err "
               f"{err:.3e} (tol {FBANK_SB_ATOL:g}); repeat bit-identical "
               f"{same}; plan {card}")
        check(err <= FBANK_SB_ATOL and same and not card["fixed_passes"]
              and card["local_bytes"] == 0, f"fbank n_fft={n} disagrees")

    lengths = [16000, 9000]
    waves = np.zeros((2, 16000), np.float32)
    for i, n in enumerate(lengths):
        waves[i, :n] = synth_wave(n, i)
    w = torch.from_numpy(waves).to(dev)
    lens = torch.tensor(lengths, device=dev)
    saved = fb.fbank_frames
    golden_err = {}
    try:
        for build in ("fft", "dft"):
            fb.fbank_frames = functools.partial(fb._launch, build)
            kaldi, _ = fb.kaldi_fbank_batch(w, lens, max_frames=50)
            sb, _ = fb.sb_fbank_batch(w, lens, max_frames=51)
            for name, got, golden in (("kaldi", kaldi, ref.kaldi_fbank),
                                      ("sb", sb, ref.sb_fbank)):
                rel = 0.0
                for i, n in enumerate(lengths):
                    g = golden(waves[i, :n])
                    x = got[i, :g.shape[0]].cpu().numpy()
                    rel = max(rel, float(np.max(
                        np.abs(x - g) / np.maximum(np.abs(g), 1e-3))))
                golden_err[name, build] = rel
    finally:
        fb.fbank_frames = saved
    for name in ("kaldi", "sb"):
        report(f"  fbank {name} extractor on the card against the float64 "
               f"golden ({lengths} samples): max rel err, FFT build "
               f"{golden_err[name, 'fft']:.3e}, DFT build "
               f"{golden_err[name, 'dft']:.3e} (tol {FBANK_GOLDEN_RTOL:g})")
        check(max(golden_err[name, "fft"], golden_err[name, "dft"])
              < FBANK_GOLDEN_RTOL, f"fbank {name} is off the golden")
    errs["golden"] = {f"{n} {b}": v for (n, b), v in golden_err.items()}
    return errs


# ---------------------------------------------------------------------------
# phase 3: the slice at full width
# ---------------------------------------------------------------------------

def twins():
    """Route the model through the plain versions on the card (for the
    comparison run only)."""
    import contextlib
    from mlvae_tpu_torch.ops import decode as dec
    from mlvae_tpu_torch.ops import fbank as fb
    from mlvae_tpu_torch.ops import gru
    from mlvae_tpu_torch.ops import lstm

    plain = {(gru, "gru_layer_fwd"): gru.gru_layer_ref,
             (gru, "gru_layer_bwd"): gru.gru_layer_bwd_ref,
             (lstm, "lstm_layer_fwd"): lstm.lstm_layer_ref,
             (lstm, "lstm_layer_bwd"): lstm.lstm_layer_bwd_ref,
             (lstm, "lstm_fused_fwd"): lstm.lstm_fused_fwd_ref,
             (lstm, "lstm_fused_bwd"): lstm.lstm_fused_bwd_ref,
             (lstm, "lstm_semi_bwd"): lstm.lstm_semi_bwd_ref,
             (dec, "md_viterbi_batch"): dec.md_viterbi_batch_ref,
             (fb, "fbank_frames"): fb.fbank_frames_ref}

    @contextlib.contextmanager
    def ctx():
        saved = {k: getattr(*k) for k in plain}
        for (mod, name), fn in plain.items():
            setattr(mod, name, fn)
        try:
            yield
        finally:
            for (mod, name), fn in saved.items():
                setattr(mod, name, fn)
    return ctx()


def launches():
    from mlvae_tpu_torch import _build
    return {k.name: k.launches for k in _build.KERNELS}


def reset_launches():
    from mlvae_tpu_torch import _build
    for k in _build.KERNELS:
        k.launches = 0


def eval_noise(model, B, T, dev, seed):
    import torch
    from mlvae_tpu_torch.nn.dist import gumbel_noise
    h = model.hparams
    g = torch.Generator(device=dev).manual_seed(seed)
    lat, nc = h["latent_size"], h["num_components"]
    return {
        "kumaraswamy_u": torch.rand((10, B, T), generator=g, device=dev),
        "vanilla_eps": torch.randn((B, T, lat), generator=g, device=dev),
        "gumbel_g": gumbel_noise((B, T, nc), device=dev, generator=g),
        "gmm_eps": torch.randn((B, T, lat * nc), generator=g, device=dev),
    }


def infer_input(model, T):
    """One utterance for ``infer_features``: T frames, six phonemes."""
    import numpy as np
    feats = np.random.RandomState(5).randn(T, model.hparams["input_size"])
    return feats, [3, 5, 7, 2, 9, 4]


def against_plain(report, batch, preds, losses, ref, ref_losses):
    """A forward through the kernels against the same forward through the
    plain versions: the float outputs, each loss (the pi NLL of both on
    the kernel run's decoded labels: like with like) and the decode."""
    import torch
    from mlvae_tpu_torch.nn import dist as D
    from mlvae_tpu_torch.utils.tensor import apply_lens_to_loss

    def pi_nll(p):
        return apply_lens_to_loss(
            -D.categorical_log_prob(p["pi_logits"],
                                    preds["decoded_flvl_md_lbl_seq"]),
            batch["feat"][1])

    errs = {k: max_err(preds[k], ref[k])
            for k in ("phn_recog_out", "boundary_v", "pi_logits")}
    rel = {k: abs(float(losses[k]) - float(ref_losses[k]))
           / max(abs(float(ref_losses[k])), 1e-12)
           for k in losses if k != "pi_nll_loss"}
    rel["pi_nll_loss"] = abs(float(pi_nll(preds)) - float(pi_nll(ref))) \
        / abs(float(pi_nll(ref)))
    same_decode = all(torch.equal(preds[k], ref[k]) for k in (
        "decoded_boundary_seq", "decoded_flvl_md_lbl_seq",
        "decoded_plvl_md_lbl_seq"))
    report("  against the plain versions: max abs err "
           + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
           + f" (tol {FWD_ATOL:g}); loss rel err "
           + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
           + f" (tol {LOSS_RTOL:g}); same decode {same_decode}")
    check(max(errs.values()) <= FWD_ATOL, "forward outputs disagree")
    check(max(rel.values()) <= LOSS_RTOL, "losses disagree")


def run_slice(dev, report, B=64, T=160, L=8):
    import numpy as np
    import torch
    from mlvae_tpu_torch.bench_utils import build_md_vae, synth_batch
    from mlvae_tpu_torch.cli.infer import infer_features
    from mlvae_tpu_torch.ops import decode as dec

    model = build_md_vae(batch_size=B, seed=0, device=dev)
    batch = model.prepare_batch(synth_batch(B, T, L, seed=0, device=dev))
    noise = eval_noise(model, B, T, dev, seed=3)

    reset_launches()
    preds = model.compute_forward(batch, noise=noise)
    loss, losses = model.compute_objectives(preds, batch)
    torch.cuda.synchronize()
    main_counts = launches()
    report(f"  launches in one eval forward: {main_counts}")
    check(main_counts == PER_FORWARD,
          f"launch counts {main_counts} != 10 / 1 / 1")
    vals = {k: float(v) for k, v in losses.items()}
    report(f"  loss {float(loss):.6f}; per key "
           + ", ".join(f"{k} {v:.6f}" for k, v in vals.items()))
    check(all(np.isfinite(list(vals.values()))) and
          np.isfinite(float(loss)), "non-finite loss")

    bnd = preds["decoded_boundary_seq"]
    check(torch.equal(bnd.sum(1).long(), preds["decoded_l_lens"].long()),
          "a decoded boundary row does not sum to its phoneme count")
    # the decode against its plain version on the kernel run's own inputs
    inputs = dec.build_viterbi_inputs(
        preds["phn_recog_out"], preds["boundary_v"], preds["pi_logits"],
        batch["prior"][0][0])
    want = dec.md_viterbi_batch_ref(
        *inputs[:2], batch["gt_cnncl_seq"][0], *inputs[2:],
        preds["decoded_t_lens"], preds["decoded_l_lens"])
    got = (bnd, preds["decoded_flvl_md_lbl_seq"],
           preds["decoded_plvl_md_lbl_seq"])
    dec_exact = all(torch.equal(a, b) for a, b in zip(got, want))
    report(f"  decoded sequences equal the plain decode on the same "
           f"inputs: {dec_exact}")
    check(dec_exact, "decoded sequences differ from the plain decode")

    with twins():
        reset_launches()
        ref = model.compute_forward(batch, noise=noise)
        _, ref_losses = model.compute_objectives(ref, batch)
        torch.cuda.synchronize()
        check(sum(launches().values()) == 0, "the plain run hit a kernel")
    against_plain(report, batch, preds, losses, ref, ref_losses)

    reset_launches()
    verdicts = infer_features(model, *infer_input(model, T), device=dev)
    counts = launches()
    report(f"  infer_features B=1: {len(verdicts)} verdicts, "
           f"launches {counts}")
    check(len(verdicts) == 6 and all(v["mispronounced"] is not None
                                     for v in verdicts)
          and counts == PER_FORWARD, "infer_features failed")
    return model, batch, noise, main_counts


PHONES = ["sil", "aa", "b", "d", "eh", "f", "g", "ih", "k", "l", "m", "n",
          "s"]
CANONICAL = ["sil", "b", "aa", "d", "eh", "sil"]


def wav_hparams():
    """What ``infer`` reads of a recipe's hparams (config/run.yaml), and a
    label encoder of 13 phonemes and the blank (the model's 14 classes)."""
    from mlvae_tpu_torch.data.encoder import LabelEncoder
    from mlvae_tpu_torch.ops.fbank import Fbank
    enc = LabelEncoder()
    enc.update_from_iterable(PHONES)
    enc.insert_blank(index=0)
    return {"sample_rate": 16000, "hop_length": 20,
            "compute_features": Fbank(deltas=True)}, enc


def write_utterance(path, T=160):
    """A wav of T SpeechBrain frames (3.18 s at T=160), speech-like."""
    from mlvae_tpu_torch.bench_utils import synth_wave
    from mlvae_tpu_torch.data.wav import write_wav
    write_wav(path, synth_wave((T - 1) * 320, 7, 8000.0 / 32768.0,
                               am_hz=3.0))


def write_kaldi_dir(root, waves, speakers):
    """A ``kaldi_data`` train set of ``waves``, utterance i spoken by
    speaker i mod ``speakers``, and the hparams that name it."""
    from mlvae_tpu_torch.data.wav import write_wav
    kaldi = root / "kaldi_data"
    kaldi.mkdir(parents=True)
    scp, u2s = [], []
    for i, wave in enumerate(waves):
        utt, path = f"u{i:04d}", root / f"u{i:04d}.wav"
        write_wav(path, wave)
        scp.append(f"{utt} {path}\n")
        u2s.append(f"{utt} s{i % speakers}\n")
    (kaldi / "train.wav.scp").write_text("".join(scp))
    (kaldi / "train.utt2spk").write_text("".join(u2s))
    return {"prepare": {"dataset_dir": str(root / "data")},
            "kaldi_feature_params": {"sample_rate": 16000, "hop_length": 20,
                                     "n_fft": 400, "n_mels": 40}}


def wav_forward(model, fbank, waves, lengths, batch, noise):
    """The wav-in eval forward of a batch: features, then the forward and
    the objectives on ``batch`` with its ``feat`` replaced."""
    feats = fbank(waves, lengths)
    b = model.prepare_batch(dict(batch, feat=(feats, batch["feat"][1])))
    preds = model.compute_forward(b, noise=noise)
    loss, losses = model.compute_objectives(preds, b)
    return feats, b, preds, loss, losses


def run_wav(dev, report, model, B=64, T=160, L=8):
    """The wav-in path through the kernels: ``infer`` at B=1 on a written
    wav, a B=64 wav batch through ``Fbank(deltas=True)`` and the eval step
    against the same through the plain versions (K6's FFT build), the same
    waves through ``Fbank(n_fft=DFT_N)`` (its DFT build), and the Kaldi
    feature pass on the card against the CPU (the FFT build). Returns the
    launches of the four."""
    import tempfile
    import numpy as np
    import torch
    from mlvae_tpu_torch.bench_utils import (synth_batch, synth_wav_batch,
                                             synth_wave)
    from mlvae_tpu_torch.cli.infer import infer
    from mlvae_tpu_torch.data.data_io import compute_kaldi_features
    from mlvae_tpu_torch.ops.fbank import Fbank

    total = {k: 0 for k in launches()}

    def add(counts):
        for k in total:
            total[k] += counts[k]

    hparams, enc = wav_hparams()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "utt.wav"
        write_utterance(path, T)
        reset_launches()
        verdicts = infer(model, hparams, enc, path, CANONICAL, device=dev)
        torch.cuda.synchronize()
        counts = launches()
    add(counts)
    report(f"  infer (wav in) B=1 T={T}: {verdicts}; launches {counts}")
    check([v["phoneme"] for v in verdicts] == CANONICAL
          and all(v["mispronounced"] is not None
                  and v["start_sec"] is not None for v in verdicts)
          and counts == PER_WAV_FORWARD, "wav-in infer failed")

    waves, lengths = synth_wav_batch(B, T, seed=0, device=dev)
    batch = synth_batch(B, T, L, seed=0, device=dev)
    noise = eval_noise(model, B, T, dev, seed=3)
    fbank = Fbank(deltas=True)
    reset_launches()
    feats, b, preds, loss, losses = wav_forward(model, fbank, waves, lengths,
                                                batch, noise)
    torch.cuda.synchronize()
    counts = launches()
    add(counts)
    vals = {k: float(v) for k, v in losses.items()}
    report(f"  wav-in eval forward B={B} T={T}: features "
           f"{tuple(feats.shape)}; loss {float(loss):.6f}; launches "
           f"{counts}")
    check(tuple(feats.shape) == (B, T, 120) and counts == PER_WAV_FORWARD
          and bool(torch.isfinite(feats).all())
          and all(np.isfinite(list(vals.values()))),
          "the wav-in eval forward failed")
    with twins():
        reset_launches()
        ref_feats, _, ref, _, ref_losses = wav_forward(
            model, fbank, waves, lengths, batch, noise)
        torch.cuda.synchronize()
        check(sum(launches().values()) == 0, "the plain run hit a kernel")
    feat_err = max_err(feats[..., :40], ref_feats[..., :40])
    report(f"  wav-in features against the plain version: max abs err "
           f"{feat_err:.3e} dB (tol {FBANK_SB_ATOL:g}), with deltas "
           f"{max_err(feats, ref_feats):.3e}")
    check(feat_err <= FBANK_SB_ATOL, "the wav-in features disagree")
    against_plain(report, b, preds, losses, ref, ref_losses)

    # the extractor at an n_fft that takes K6's DFT build
    dft_fbank = Fbank(n_fft=DFT_N)
    reset_launches()
    feats = dft_fbank(waves, lengths)
    torch.cuda.synchronize()
    counts = launches()
    add(counts)
    with twins():
        ref_feats = dft_fbank(waves, lengths)
    feat_err = max_err(feats, ref_feats)
    report(f"  Fbank(n_fft={DFT_N}) B={B} T={T}: features "
           f"{tuple(feats.shape)} against the plain version: max abs err "
           f"{feat_err:.3e} dB (tol {FBANK_SB_ATOL:g}); launches {counts}")
    check(feat_err <= FBANK_SB_ATOL and bool(torch.isfinite(feats).all())
          and counts == {**dict.fromkeys(counts, 0), "fbank": 1},
          f"Fbank(n_fft={DFT_N}) failed")

    with tempfile.TemporaryDirectory() as tmp:
        # two speakers with two utterances each, 1 to 2 s, speech-like
        kaldi_hp = write_kaldi_dir(Path(tmp), [
            synth_wave(n, 30 + i, 0.25, am_hz=3.0)
            for i, n in enumerate((24000, 17000, 32000, 16003))], 2)
        reset_launches()
        got = compute_kaldi_features(kaldi_hp, "train", device=dev)
        torch.cuda.synchronize()
        counts = launches()
        want = compute_kaldi_features(kaldi_hp, "train", device="cpu")
    add(counts)
    err = max(float(np.abs(got[u] - want[u]).max() / np.abs(want[u]).max())
              for u in want)
    report(f"  compute_kaldi_features (4 utterances, 2 speakers, one batch) "
           f"on the card against the CPU: shapes "
           f"{[got[u].shape for u in got]}, max err of the largest entry "
           f"{err:.3e} (tol {CMVN_RTOL:g}); launches {counts}")
    check(list(got) == list(want) and all(got[u].shape == want[u].shape
                                          for u in want)
          and err <= CMVN_RTOL and counts == {**dict.fromkeys(counts, 0),
                                              "fbank_fft": 1},
          "compute_kaldi_features on the card disagrees with the CPU")
    return total


def train_noise(model, B, T, dev, g):
    """One training step's draws under the model's current target, made
    with a torch generator and named as ``MDVAE.draws`` lists them: a
    dropout mask, or a name that repeats (MD_VAE_sfl's per-sample draws),
    goes into a list."""
    import torch
    from mlvae_tpu_torch.nn.dist import gumbel_noise
    draws = model.draws(B, T, train=True)
    names = [d[0] for d in draws]
    noise = {}
    for name, kind, shape, keep, dtype in draws:
        if kind == "bernoulli":
            v = torch.rand(shape, generator=g, device=dev) < keep
        elif kind == "uniform":
            v = torch.rand(shape, generator=g, device=dev)
        elif kind == "normal":
            v = torch.randn(shape, generator=g, device=dev)
        else:
            v = gumbel_noise(shape, device=dev, generator=g, dtype=dtype)
        if kind == "bernoulli" or names.count(name) > 1:
            noise.setdefault(name, []).append(v)
        else:
            noise[name] = v
    return noise


def f32_state(model) -> bool:
    """Parameters, grads and optimizer states all f32 (AMP keeps them so)."""
    import torch
    tensors = [p for p in model.parameters()] + [
        p.grad for p in model.parameters() if p.grad is not None] + [
        v for per in model.opt_states.values() for st in per.values()
        for v in st.values() if v.is_floating_point()]
    return all(t.dtype == torch.float32 for t in tensors)


def snapshot(model):
    """Weights, normalizer statistics and optimizer states, copied."""
    return ({k: v.clone() for k, v in model.state_dict().items()},
            {name: {mk: {k: v.clone() for k, v in st.items()}
                    for mk, st in per.items()}
             for name, per in model.opt_states.items()})


def restore(model, snap):
    weights, opt_states = snap
    model.load_state_dict(weights)
    for name, per in opt_states.items():
        for mk, st in per.items():
            for k, v in st.items():
                model.opt_states[name][mk][k].copy_(v)


def grad_norms(model):
    """Each module's norm of the grads the last step applied."""
    import torch
    out = {}
    for mk, mod in model.param_modules().items():
        gs = [p.grad.double().square().sum() for p in mod.parameters()
              if p.grad is not None]
        out[mk] = float(torch.stack(gs).sum().sqrt()) if gs else 0.0
    return out


def run_training(dev, report, B=64, T=160, L=8, amp=False):
    """Two steps of each target at full width through the kernels, each
    target's first step also through the plain versions from the same
    state and draws. ``amp``: the AMP (bf16) step, whose parameters and
    optimizer states must stay f32, and whose VAE step is also held
    against the f32 step from the same state and draws. Returns the model,
    the batch, each target's first draws and the kernel launches of the
    six kernel steps."""
    import numpy as np
    import torch
    from mlvae_tpu_torch.bench_utils import build_md_vae, synth_batch
    from mlvae_tpu_torch.training.brain import Stage

    loss_tol, grad_tol = (AMP_LOSS_RTOL, AMP_GRAD_RTOL) if amp else \
        (LOSS_RTOL, GRAD_RTOL)
    model = build_md_vae(batch_size=B, seed=0, device=dev, bf16=amp)
    batch = synth_batch(B, T, L, seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    total = {k: 0 for k in launches()}
    first_noise = {}
    for epoch in (1, 2, 3):
        model.on_stage_start(Stage.TRAIN, epoch)
        name = model.target.name
        for step in range(2):
            noise = train_noise(model, B, T, dev, g)
            if step == 0:
                first_noise[name] = noise
                start = snapshot(model)
                with twins():
                    reset_launches()
                    ref_loss, _ = model.fit_batch(batch, epoch, noise=noise)
                    ref_norms = grad_norms(model)
                    torch.cuda.synchronize()
                    check(sum(launches().values()) == 0,
                          "the plain training step hit a kernel")
                restore(model, start)
                if amp and name == "VAE":
                    model.auto_mix_prec = False
                    loss_f32, _ = model.fit_batch(batch, epoch, noise={
                        k: v.float() if k == "pi_gumbel" else v
                        for k, v in noise.items()})
                    model.auto_mix_prec = True
                    restore(model, start)
            weights, opt_states = snapshot(model)
            norm_count = float(model.normalizer.count)
            reset_launches()
            loss, losses = model.fit_batch(batch, epoch, noise=noise)
            torch.cuda.synchronize()
            counts = launches()
            for k in total:
                total[k] += counts[k]
            vals = {k: float(v) for k, v in losses.items()}
            moved = {mk for mk, mod in model.param_modules().items()
                     if any(not torch.equal(v, weights[f"{mk}.{n}"])
                            for n, v in mod.state_dict().items())}
            stepped = {mk for mk, st in model.opt_states["optimizer"].items()
                       if int(st["count"]) != int(opt_states["optimizer"][mk]
                                                  ["count"])}
            kept = all(torch.equal(v, opt_states["optimizer"][mk][k])
                       for mk, st in model.opt_states["optimizer"].items()
                       if mk not in ACTIVE[name] for k, v in st.items())
            d_norm = float(model.normalizer.count) - norm_count
            report(f"  epoch {epoch} {name} step {step + 1}: loss "
                   f"{float(loss):.6f} ("
                   + ", ".join(f"{k} {v:.6f}" for k, v in vals.items())
                   + f"); launches {counts}; modules moved {sorted(moved)}; "
                   f"normalizer count +{d_norm:g}")
            check(np.isfinite(float(loss)) and
                  all(np.isfinite(list(vals.values()))), "non-finite loss")
            want = recipe_launches("MD_VAE", name, True, amp)
            check(counts == want,
                  f"{name} launch counts {counts} != {want}")
            check(f32_state(model), "a parameter, grad or optimizer state is "
                  "not f32")
            check(moved == ACTIVE[name] and stepped == ACTIVE[name] and kept,
                  f"{name}: moved {sorted(moved)}, Adam stepped "
                  f"{sorted(stepped)}, inactive states kept {kept}; want "
                  f"{sorted(ACTIVE[name])}")
            check(d_norm == (B if epoch < 3 else 0),
                  f"normalizer count moved by {d_norm} in epoch {epoch}")
            if step == 0:
                norms = grad_norms(model)
                idle_zero = all(v == 0 for mk, v in norms.items()
                                if mk not in ACTIVE[name])
                loss_rel = abs(float(loss) - float(ref_loss)) / abs(
                    float(ref_loss))
                norm_rel = {mk: abs(v - ref_norms[mk]) / ref_norms[mk]
                            if ref_norms[mk] else abs(v)
                            for mk, v in norms.items()}
                report(f"  against the plain versions: loss rel err "
                       f"{loss_rel:.3e} (tol {loss_tol:g}); grad norm rel "
                       "err " + ", ".join(f"{mk} {v:.3e}" for mk, v in
                                          norm_rel.items() if norms[mk])
                       + f" (tol {grad_tol:g}); inactive grads zero "
                       f"{idle_zero}")
                check(loss_rel <= loss_tol, "training loss disagrees")
                check(idle_zero, "an inactive module applied non-zero grads")
                check(max(norm_rel.values()) <= grad_tol,
                      "training grads disagree")
                if amp and name == "VAE":
                    f32_rel = abs(float(loss) - float(loss_f32)) / abs(
                        float(loss_f32))
                    report(f"  against the f32 step from the same state and "
                           f"draws: f32 loss {float(loss_f32):.6f}, rel err "
                           f"{f32_rel:.3e} (tol {AMP_F32_RTOL:g})")
                    check(f32_rel <= AMP_F32_RTOL,
                          "the AMP loss is far from the f32 loss")
    report(f"  launches in the six training steps: {total}")
    return model, batch, first_noise, total


def run_sfl_training(dev, report, B=64, T=160, L=8):
    """MD_VAE_sfl's VAE train step at full width (``SFL_SAMPLES`` π samples
    on the Kaldi pass's features), two steps through the kernels, the
    first also through the plain versions from the same state and draws:
    launches, loss, each module's applied grad norm, the modules that
    moved. Returns the model, the batch, the first draws and the
    launches of the two kernel steps."""
    import numpy as np
    import torch
    from mlvae_tpu_torch.bench_utils import build_md_vae, synth_batch
    from mlvae_tpu_torch.training.brain import Stage

    model = build_md_vae(batch_size=B, seed=0, device=dev,
                         recipe="MD_VAE_sfl")
    batch = synth_batch(B, T, L, seed=0, device=dev)
    batch["kaldi_feat"] = batch["feat"]
    model.on_stage_start(Stage.TRAIN, 3)
    check(int(model.hparams["pi_mcmc_num"]) == SFL_SAMPLES,
          "the sfl recipe's pi_mcmc_num moved")
    want = recipe_launches("MD_VAE_sfl", "VAE", train=True)
    g = torch.Generator(device=dev).manual_seed(7)
    total = {k: 0 for k in launches()}
    first_noise = None
    for step in range(2):
        noise = train_noise(model, B, T, dev, g)
        if step == 0:
            first_noise = noise
            start = snapshot(model)
            with twins():
                reset_launches()
                ref_loss, ref_losses = model.fit_batch(batch, 3, noise=noise)
                ref_norms = grad_norms(model)
                torch.cuda.synchronize()
                check(sum(launches().values()) == 0,
                      "the plain sfl step hit a kernel")
            restore(model, start)
        weights, opt_states = snapshot(model)
        reset_launches()
        loss, losses = model.fit_batch(batch, 3, noise=noise)
        torch.cuda.synchronize()
        counts = launches()
        for k in total:
            total[k] += counts[k]
        vals = {k: float(v) for k, v in losses.items()}
        moved = {mk for mk, mod in model.param_modules().items()
                 if any(not torch.equal(v, weights[f"{mk}.{n}"])
                        for n, v in mod.state_dict().items())}
        stepped = {mk for mk, st in model.opt_states["optimizer"].items()
                   if int(st["count"]) != int(opt_states["optimizer"][mk]
                                              ["count"])}
        report(f"  sfl VAE step {step + 1}: loss {float(loss):.6f} ("
               + ", ".join(f"{k} {v:.6f}" for k, v in vals.items())
               + f"); launches { {k: v for k, v in counts.items() if v} }; "
               f"modules moved {sorted(moved)}")
        check(np.isfinite(float(loss)) and
              all(np.isfinite(list(vals.values()))), "non-finite sfl loss")
        check(counts == want, f"sfl VAE launch counts {counts} != {want}")
        check(moved == SFL_ACTIVE and stepped == SFL_ACTIVE,
              f"sfl: moved {sorted(moved)}, Adam stepped {sorted(stepped)}; "
              f"want {sorted(SFL_ACTIVE)}")
        check(f32_state(model), "an sfl parameter, grad or optimizer state "
              "is not f32")
        if step == 0:
            norms = grad_norms(model)
            loss_rel = abs(float(loss) - float(ref_loss)) / abs(
                float(ref_loss))
            norm_rel = {mk: abs(v - ref_norms[mk]) / ref_norms[mk]
                        if ref_norms[mk] else abs(v)
                        for mk, v in norms.items()}
            report(f"  against the plain versions: loss rel err "
                   f"{loss_rel:.3e} (tol {LOSS_RTOL:g}); grad norm rel err "
                   + ", ".join(f"{mk} {v:.3e}" for mk, v in norm_rel.items()
                               if norms[mk])
                   + f" (tol {GRAD_RTOL:g}); inactive grads zero "
                   f"{all(v == 0 for mk, v in norms.items() if mk not in SFL_ACTIVE)}")
            check(loss_rel <= LOSS_RTOL, "the sfl loss disagrees")
            check(all(v == 0 for mk, v in norms.items()
                      if mk not in SFL_ACTIVE),
                  "an inactive sfl module applied non-zero grads")
            check(max(norm_rel.values()) <= GRAD_RTOL,
                  "the sfl grads disagree")
    report(f"  launches in the two sfl steps: "
           f"{ {k: v for k, v in total.items() if v} }")
    return model, batch, first_noise, total


def time_sfl_training(dev, report, model, batch, noise, smi):
    """The sfl VAE train step's time (host clock around synchronised
    steps) and throughput, and a profile of one."""
    B, T = batch["kaldi_feat"][0].shape[:2]
    ms = cuda_ms(lambda: model.fit_batch(batch, 3, noise=noise), iters=5,
                 warmup=1)
    out = {"ms": ms, "utt_sec_per_sec": B * T * HOP_SEC / (ms / 1e3),
           "card": smi}
    report(f"  sfl VAE train step B={B} T={T} ({SFL_SAMPLES} π samples): "
           f"{ms:.3f} ms ({out['utt_sec_per_sec']:.1f} utt-sec/sec) on "
           f"{smi}")
    out["profile"] = profile_step(
        lambda: model.fit_batch(batch, 3, noise=noise),
        "sfl VAE train step", report)
    return out


def run_lstm_fc(dev, report, B=64, T=160, amp=False):
    """LSTM_FC at full width through the wide kernels: the TEST eval step
    (launches, finite loss, logits and loss against the same forward
    through the plain versions, frame-level MD scores) and two f32
    training steps (launches, finite losses, the modules that moved, the
    first step's loss and applied grad norms against the same step through
    the plain versions). ``amp``: no eval step (it stays f32), and two AMP
    (bf16) training steps through the bf16 builds, whose parameters and
    optimizer states must stay f32, and whose first step is also held
    against the f32 step from the same state and draws. Returns the model,
    the batch, the first step's draws and the launches of the eval and the
    two steps."""
    import numpy as np
    import torch
    from mlvae_tpu_torch.bench_utils import build_lstm_fc, synth_flvl_batch

    model = build_lstm_fc(batch_size=B, seed=0, device=dev, bf16=amp)
    batch = synth_flvl_batch(B, T, seed=0, device=dev)
    total = {k: 0 for k in launches()}
    per_step = PER_LSTM_FC_AMP_STEP if amp else PER_LSTM_FC_STEP
    loss_tol, grad_tol = (AMP_LOSS_RTOL, AMP_GRAD_RTOL) if amp else \
        (LOSS_RTOL, GRAD_RTOL)

    if not amp:
        reset_launches()
        preds, loss, _ = model.eval_step(batch)
        torch.cuda.synchronize()
        counts = launches()
        for k in total:
            total[k] += counts[k]
        report(f"  eval step: loss {float(loss):.6f}; logits "
               f"{tuple(preds['out'].shape)}; launches {counts}")
        check(counts == PER_LSTM_FC_EVAL,
              f"LSTM_FC eval launches {counts} != {PER_LSTM_FC_EVAL}")
        check(np.isfinite(float(loss)) and
              bool(torch.isfinite(preds["out"]).all()), "non-finite eval")
        with twins():
            reset_launches()
            ref, ref_loss, _ = model.eval_step(batch)
            torch.cuda.synchronize()
            check(sum(launches().values()) == 0, "the plain run hit a kernel")
        out_err = max_err(preds["out"], ref["out"])
        loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        report(f"  against the plain versions: logits max abs err "
               f"{out_err:.3e} (tol {FWD_ATOL:g}); loss rel err "
               f"{loss_rel:.3e} (tol {LOSS_RTOL:g})")
        check(out_err <= FWD_ATOL and loss_rel <= LOSS_RTOL,
              "LSTM_FC eval disagrees with the plain versions")
        model.evaluate_predictions(preds, batch)
        scores = model.stats_loggers["flvl_md_stats"].summarize()
        report(f"  frame-level MD scores (MDMetricStats, random weights): "
               f"{scores}")
        check(set(scores) == {"ACC", "PRE", "REC", "F1"} and
              all(0.0 <= v <= 100.0 for v in scores.values()),
              f"MD scores {scores}")

    g = torch.Generator(device=dev).manual_seed(7)
    first_noise = None
    for step in range(2):
        noise = train_noise(model, B, T, dev, g)
        if step == 0:
            first_noise = noise
            start = snapshot(model)
            with twins():
                reset_launches()
                ref_loss, _ = model.fit_batch(batch, 1, noise=noise)
                ref_norms = grad_norms(model)
                torch.cuda.synchronize()
                check(sum(launches().values()) == 0,
                      "the plain training step hit a kernel")
            restore(model, start)
            if amp:
                model.auto_mix_prec = False
                loss_f32, _ = model.fit_batch(batch, 1, noise=noise)
                model.auto_mix_prec = True
                restore(model, start)
        weights = {k: v.clone() for k, v in model.state_dict().items()}
        reset_launches()
        loss, _ = model.fit_batch(batch, 1, noise=noise)
        torch.cuda.synchronize()
        counts = launches()
        for k in total:
            total[k] += counts[k]
        moved = {mk for mk, mod in model.param_modules().items()
                 if any(not torch.equal(v, weights[f"{mk}.{n}"])
                        for n, v in mod.state_dict().items())}
        report(f"  {'AMP ' if amp else ''}train step {step + 1}: loss "
               f"{float(loss):.6f}; launches {counts}; modules moved "
               f"{sorted(moved)}")
        check(np.isfinite(float(loss)), "non-finite LSTM_FC loss")
        check(counts == per_step,
              f"LSTM_FC step launches {counts} != {per_step}")
        check(moved == LSTM_FC_ACTIVE, f"moved {sorted(moved)}")
        check(f32_state(model), "a parameter, grad or state is not f32")
        check(torch.equal(model.normalizer.count,
                          torch.zeros((), device=dev)),
              "LSTM_FC's normalizer moved")
        if step == 0:
            norms = grad_norms(model)
            loss_rel = abs(float(loss) - float(ref_loss)) / abs(
                float(ref_loss))
            norm_rel = {mk: abs(v - ref_norms[mk]) / ref_norms[mk]
                        for mk, v in norms.items()}
            report(f"  against the plain versions: loss rel err "
                   f"{loss_rel:.3e} (tol {loss_tol:g}); grad norm rel err "
                   + ", ".join(f"{mk} {v:.3e}" for mk, v in norm_rel.items())
                   + f" (tol {grad_tol:g})")
            check(loss_rel <= loss_tol, "LSTM_FC training loss disagrees")
            check(max(norm_rel.values()) <= grad_tol,
                  "LSTM_FC training grads disagree")
            if amp:
                f32_rel = abs(float(loss) - float(loss_f32)) / abs(
                    float(loss_f32))
                report(f"  against the f32 step from the same state and "
                       f"draws: f32 loss {float(loss_f32):.6f}, rel err "
                       f"{f32_rel:.3e} (tol {AMP_F32_RTOL:g})")
                check(f32_rel <= AMP_F32_RTOL,
                      "the AMP loss is far from the f32 loss")
    report(f"  launches in the {'two AMP' if amp else 'eval and the two'} "
           f"training steps: {total}")
    return model, batch, first_noise, total


# ---------------------------------------------------------------------------
# K1 on bf16 streams at H <= 512, and CRDNN_CTC
# ---------------------------------------------------------------------------

def check_k1_bf16_narrow(dev, report):
    """Phase 2: the tensor-core K1-fwd and K1-bwd (and its dW_hh kernel) at
    every H of ``K1_BF16_NARROW_H``, B of ``K1_BF16_NARROW_B`` and T of
    ``K1_BF16_NARROW_T``, both directions, against the plain versions in
    bf16: hs and cs within FUSED_ATOL, dgx and dW_hh within FUSED_BWD_RTOL
    of their largest entry, the dW_hh kernel against ``wide_dw_ref`` on
    the kernel's own dgx within BWD_RTOL; then repeated launches at H=512,
    B=64, T=80 against the plain versions and bit-equal to the first.
    Returns the worst errors at H=512, B=64, T=80 (the CRDNN's shape)."""
    import torch
    from mlvae_tpu_torch.ops import lstm as L
    g = torch.Generator(device=dev).manual_seed(46)
    worst, wrong = {}, []
    for H in K1_BF16_NARROW_H:
        for T in K1_BF16_NARROW_T:
            errs = {"fwd": 0.0, "dgx": 0.0, "dw": 0.0, "dw_own": 0.0}
            flips = 0.0
            for B in K1_BF16_NARROW_B:
                check(L.k1_fwd_plan(H, B, bf16=True).variant == "wide_bf16"
                      and L.k1_bwd_plan(H, B, bf16=True).variant
                      == "wide_bf16", f"bf16 H={H} takes no tensor-core K1")
                for reverse in (False, True):
                    prob = bwd_problem(g, dev, T, B, H, reverse, bf16=True)
                    gx, w, hs_r, cs_r = prob[:4]
                    hs_k, cs_k = L.lstm_layer_fwd(gx, w, reverse)
                    got = L.lstm_layer_bwd(*prob, reverse)
                    want = L.lstm_layer_bwd_ref(*prob, reverse)
                    own = L.wide_dw_ref(got[0], hs_r, reverse)
                    torch.cuda.synchronize()
                    e = {"fwd": max(max_err(hs_k, hs_r), max_err(cs_k, cs_r)),
                         "dgx": rel_err(got[0], want[0]),
                         "dw": rel_err(got[1], want[1]),
                         "dw_own": rel_err(got[1], own)}
                    ok = (hs_k.dtype == torch.bfloat16
                          and got[0].dtype == torch.bfloat16
                          and e["fwd"] <= FUSED_ATOL
                          and e["dgx"] <= FUSED_BWD_RTOL
                          and e["dw"] <= FUSED_BWD_RTOL
                          and e["dw_own"] <= BWD_RTOL)
                    if not ok:
                        wrong.append((H, T, B, reverse, e))
                        report("  " + where_wrong(torch.maximum(
                            (hs_k.float() - hs_r.float()).abs(),
                            (cs_k - cs_r).abs()), reverse))
                    for k, v in e.items():
                        errs[k] = max(errs[k], v)
                    flips = max(flips, float((hs_k != hs_r).float().mean()))
                    if (H, T, B) == (512, 80, 64):
                        for k, v in e.items():
                            worst[k] = max(worst.get(k, 0.0), v)
            report(f"  lstm_*_wide_bf16 H={H} T={T} B="
                   f"{'/'.join(map(str, K1_BF16_NARROW_B))}, both "
                   f"directions: hs/cs max abs err {errs['fwd']:.3e} (tol "
                   f"{FUSED_ATOL:g}; hs not bit-equal at most {flips:.4f}), "
                   f"dgx {errs['dgx']:.3e} and dW_hh {errs['dw']:.3e} of "
                   f"their largest entry (tol {FUSED_BWD_RTOL:g}), the dW_hh "
                   f"kernel on its own operands {errs['dw_own']:.3e} (tol "
                   f"{BWD_RTOL:g})")
    check(not wrong, f"the bf16 K1 at H <= 512 disagrees: {wrong[:4]}")
    stress_lstm_wide(dev, report, K1_BF16_NARROW_REPEATS, T=80, B=64, H=512,
                     bf16=True)
    return worst


def crdnn_counts(counts, want, what):
    check(counts == want, f"{what} launches "
          f"{ {k: v for k, v in counts.items() if v} } != "
          f"{ {k: v for k, v in want.items() if v} }")


def run_crdnn_training(dev, report, B=CTC_B, T=CTC_T, L=CTC_L, amp=False):
    """CRDNN_CTC at the recipe's full width (``bench_utils.build_crdnn_ctc``,
    weights from seed 0; ``synth_ctc_batch`` at B, T, L): the f32 eval
    forward (launches, finite loss, log-probabilities, loss and greedy
    decode against the plain versions) and two training steps (launches,
    finite losses, exactly ``crdnn`` and ``output`` moved, the normalizer's
    count up by B, f32 parameters, grads and Adadelta states; the first
    step's loss and applied grad norms against the same step through the
    plain versions). ``amp``: the --bf16 steps (no eval forward: it stays
    f32), whose first step is also held against the f32 step from the same
    state and draws. Returns the model, the batch, the first step's draws
    and the launches."""
    import numpy as np
    import torch
    from mlvae_tpu_torch.bench_utils import build_crdnn_ctc, synth_ctc_batch
    from mlvae_tpu_torch.ops.ctc import ctc_greedy_decode

    model = build_crdnn_ctc(batch_size=B, seed=0, device=dev, bf16=amp)
    batch = synth_ctc_batch(B, T, L, seed=0, device=dev)
    total = {k: 0 for k in launches()}
    loss_tol, grad_tol = (AMP_LOSS_RTOL, AMP_GRAD_RTOL) if amp else \
        (LOSS_RTOL, GRAD_RTOL)
    if not amp:
        reset_launches()
        preds, loss, _ = model.eval_forward(batch)
        torch.cuda.synchronize()
        counts = launches()
        for k in total:
            total[k] += counts[k]
        crdnn_counts(counts, PER_CRDNN_EVAL, "CRDNN_CTC eval")
        check(np.isfinite(float(loss)) and
              bool(torch.isfinite(preds["pout"]).all()), "non-finite eval")
        with twins():
            reset_launches()
            ref, ref_loss, _ = model.eval_forward(batch)
            torch.cuda.synchronize()
            check(sum(launches().values()) == 0, "the plain run hit a kernel")
        lens = batch["feat"][1].cpu().numpy()
        same = ctc_greedy_decode(preds["pout"].cpu().numpy(), lens) == \
            ctc_greedy_decode(ref["pout"].cpu().numpy(), lens)
        err = max_err(preds["pout"], ref["pout"])
        loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        report(f"  eval forward: loss {float(loss):.6f}; pout "
               f"{tuple(preds['pout'].shape)}; launches "
               f"{ {k: v for k, v in counts.items() if v} }; against the "
               f"plain versions: pout max abs err {err:.3e} (tol "
               f"{FWD_ATOL:g}), loss rel err {loss_rel:.3e} (tol "
               f"{LOSS_RTOL:g}), same greedy decode {same}")
        check(err <= FWD_ATOL and loss_rel <= LOSS_RTOL and same,
              "the CRDNN_CTC eval forward disagrees with the plain versions")
    g = torch.Generator(device=dev).manual_seed(8)
    first_noise = None
    label = "--bf16" if amp else "f32"
    for step in range(2):
        noise = train_noise(model, B, T, dev, g)
        if step == 0:
            first_noise = noise
            start = snapshot(model)
            with twins():
                reset_launches()
                ref_loss, _ = model.fit_batch(batch, 1, noise=noise)
                ref_norms = grad_norms(model)
                torch.cuda.synchronize()
                check(sum(launches().values()) == 0,
                      "the plain training step hit a kernel")
            restore(model, start)
            if amp:
                model.auto_mix_prec = False
                loss_f32, _ = model.fit_batch(batch, 1, noise=noise)
                model.auto_mix_prec = True
                restore(model, start)
        weights = {k: v.clone() for k, v in model.state_dict().items()}
        norm_count = float(model.normalizer.count)
        reset_launches()
        loss, _ = model.fit_batch(batch, 1, noise=noise)
        torch.cuda.synchronize()
        counts = launches()
        for k in total:
            total[k] += counts[k]
        moved = {mk for mk, mod in model.param_modules().items()
                 if any(not torch.equal(v, weights[f"{mk}.{n}"])
                        for n, v in mod.state_dict().items())}
        d_norm = float(model.normalizer.count) - norm_count
        report(f"  {label} train step {step + 1}: loss {float(loss):.6f}; "
               f"launches { {k: v for k, v in counts.items() if v} }; "
               f"modules moved {sorted(moved)}; normalizer count "
               f"+{d_norm:g}")
        check(np.isfinite(float(loss)), "non-finite CRDNN_CTC loss")
        crdnn_counts(counts, PER_CRDNN_AMP_STEP if amp else PER_CRDNN_STEP,
                     f"CRDNN_CTC {label} step")
        check(moved == CRDNN_ACTIVE, f"moved {sorted(moved)}")
        check(d_norm == B, f"the normalizer's count moved by {d_norm}")
        check(f32_state(model), "a parameter, grad or state is not f32")
        if step == 0:
            norms = grad_norms(model)
            loss_rel = abs(float(loss) - float(ref_loss)) / abs(
                float(ref_loss))
            norm_rel = {mk: abs(v - ref_norms[mk]) / ref_norms[mk]
                        for mk, v in norms.items()}
            report(f"  against the plain versions: loss rel err "
                   f"{loss_rel:.3e} (tol {loss_tol:g}); grad norm rel err "
                   + ", ".join(f"{mk} {v:.3e}" for mk, v in norm_rel.items())
                   + f" (tol {grad_tol:g})")
            check(loss_rel <= loss_tol, "CRDNN_CTC training loss disagrees")
            check(max(norm_rel.values()) <= grad_tol,
                  "CRDNN_CTC training grads disagree")
            if amp:
                f32_rel = abs(float(loss) - float(loss_f32)) / abs(
                    float(loss_f32))
                report(f"  against the f32 step from the same state and "
                       f"draws: f32 loss {float(loss_f32):.6f}, rel err "
                       f"{f32_rel:.3e} (tol {AMP_F32_RTOL:g})")
                check(f32_rel <= AMP_F32_RTOL,
                      "the --bf16 loss is far from the f32 loss")
    report(f"  launches of the CRDNN_CTC {label} path: "
           f"{ {k: v for k, v in total.items() if v} }")
    return model, batch, first_noise, total


def time_crdnn(dev, report, model, batch, noise, smi, amp=False):
    """Phase 4: the CRDNN_CTC train step (f32 eval forward too), ms and
    utt-sec/sec (B·T·0.02 s a step), and a profile of one step: its kernel
    time and the device's idle share, beside the card."""
    B, T = batch["feat"][0].shape[:2]
    label = "--bf16" if amp else "f32"
    out = {"card": smi}
    if not amp:
        ev = cuda_ms(lambda: model.eval_forward(batch), iters=5, warmup=1)
        out.update(eval_ms=ev,
                   eval_utt_sec_per_sec=B * T * HOP_SEC / (ev / 1e3))
        report(f"  CRDNN_CTC eval forward B={B} T={T}: {ev:.3f} ms "
               f"({out['eval_utt_sec_per_sec']:.1f} utt-sec/sec) on {smi}")
    tr = cuda_ms(lambda: model.fit_batch(batch, 1, noise=noise), iters=5,
                 warmup=1)
    out.update(train_ms=tr,
               train_utt_sec_per_sec=B * T * HOP_SEC / (tr / 1e3))
    report(f"  CRDNN_CTC {label} train step B={B} T={T}: {tr:.3f} ms "
           f"({out['train_utt_sec_per_sec']:.1f} utt-sec/sec) on {smi}")
    out["train_profile"] = profile_step(
        lambda: model.fit_batch(batch, 1, noise=noise),
        f"CRDNN_CTC {label} train step", report)
    return out


def time_k1_bf16_h512(dev, report, counts):
    """Phase 4: the tensor-core K1-fwd and K1-bwd at the CRDNN's H=512,
    B=64, T=80 (its length after the time pool) and T=160, each in turns
    with cuDNN's bf16 one-layer LSTM, beside its plain version and bound,
    and the launches of the paths that reach them at H=512 (the CRDNN
    --bf16 step's and the CLI's)."""
    import torch
    from mlvae_tpu_torch.ops.lstm import lstm_layer_bwd_ref, lstm_layer_ref
    g = torch.Generator(device=dev).manual_seed(47)
    out = {}
    B, H = 64, 512
    for T in (80, 160):
        fwd = time_fwd_yard(dev, report, (("lstm_fwd_bf16", None, B),), T=T,
                            H=H)[f"lstm_fwd_bf16 B={B}"]
        bwd = time_fused_bwd(dev, report, T=T, H=H,
                             cases=(("lstm_bwd_bf16", None, B),))[
            f"lstm_bwd_bf16 B={B}"]
        prob = bwd_problem(g, dev, T, B, H, False, bf16=True)
        fwd["plain_ms"] = cuda_ms(lambda: lstm_layer_ref(*prob[:2]),
                                  iters=2, warmup=1)
        bwd["plain_ms"] = cuda_ms(lambda: lstm_layer_bwd_ref(*prob), iters=2,
                                  warmup=1)
        out[f"T={T}"] = {"lstm_fwd_wide_bf16": fwd, "lstm_bwd_wide_bf16": bwd}
        report(f"  K1 bf16 H={H} B={B} T={T}: fwd {fwd['ms']:.4f} ms (plain "
               f"{fwd['plain_ms']:.4f}, cuDNN {fwd['cudnn_ms']:.4f}, bound "
               f"{fwd['bound_ms']:.4f} by {fwd['bound_by']}); bwd "
               f"{bwd['ms']:.4f} ms (plain {bwd['plain_ms']:.4f}, cuDNN "
               f"{bwd['cudnn_ms']:.4f}, bound {bwd['bound_ms']:.4f} by "
               f"{bwd['bound_by']})")
    out["launches_crdnn"] = {k: counts[k]["launches_crdnn_amp_training"]
                             + counts[k]["launches_cli_ctc_bf16"]
                             for k in ("lstm_fwd_wide_bf16",
                                       "lstm_bwd_wide_bf16",
                                       "lstm_dw_wide_bf16")}
    return out


def run_cli_test_ctc(report, probe, root, name, recipe):
    """``cli.test`` of a CTC recipe from its best checkpoint, then the same
    checkpoint and batches through the plain versions: launches, the
    greedy decodes, both PERs, the MD and boundary statistics, the
    ``md_result_seqs.txt`` table and the loss. Returns the kernel run's
    launches and its evaluate split."""
    import torch
    from mlvae_tpu_torch.cli import test as test_cli

    args = cli_args(name, recipe=recipe)
    table = Path(root) / f"results/{name}/test_output/md_result_seqs.txt"

    def outcome(model):
        st = model.stats_loggers
        return ([d["hyp"] for d in st["phn_per_stats"].details],
                [st[k].summarize() for k in ("phn_per_stats",
                                             "cnncl_per_stats")],
                st["plvl_md_stats"].scores_list,
                st["boundary_stats"].scores_list, table.read_text())
    probe.reset()
    reset_launches()
    model = test_cli.main(args)
    torch.cuda.synchronize()
    test_total = launches()
    (key, rec), = [(k, v) for k, v in probe.stages.items()
                   if k[0] == "TEST"]
    want = {k: v * rec["batches"] for k, v in
            recipe_launches(recipe, "TEST", train=False).items()}
    crdnn_counts(rec["launches"], want, f"{recipe} TEST")
    got = outcome(model)
    timing = model.evaluate_timing
    probe.reset()
    with twins():
        reset_launches()
        plain = test_cli.main(args)
        check(sum(launches().values()) == 0,
              "the plain TEST pass hit a kernel")
    same = got == outcome(plain)
    loss_rel = abs(rec["loss"] - probe.stages[key]["loss"]) / abs(
        rec["loss"])
    per = got[1][0]["error_rate"], got[1][1]["error_rate"]
    report(f"  {recipe} cli.test ({rec['batches']} batch): loss "
           f"{rec['loss']:.6f}, PER {per[0]} / {per[1]} (pronounced / "
           f"canonical); launches "
           f"{ {k: v for k, v in rec['launches'].items() if v} }; against "
           f"the plain versions on the same checkpoint: same decodes, PER, "
           f"MD and boundary statistics and md_result_seqs.txt {same}, loss "
           f"rel err {loss_rel:.3e} (tol {CLI_LOSS_RTOL:g})")
    check(same, f"the {recipe} TEST pass disagrees with the plain versions")
    check(loss_rel <= CLI_LOSS_RTOL, f"the {recipe} TEST loss disagrees")
    return test_total, timing


def run_cli_ctc(dev, report, smi):
    """Phase 3's CLI path of CRDNN_CTC and CRDNN_CTC_cnncl in a temporary
    directory at the recipes' full width on the card: for each,
    ``cli.train`` for one debug epoch of two batches and ``cli.test``,
    each against the same through the plain versions; then CRDNN_CTC's
    ``cli.train --bf16``. Returns the launches of the kernel runs (f32 and
    --bf16) and the numbers."""
    import logging
    import os
    import shutil
    import tempfile

    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    cwd = os.getcwd()
    root = tempfile.mkdtemp(prefix="mlvae_cli_ctc_")
    probe = CliProbe()
    out = {"card": smi}
    counts = {k: 0 for k in launches()}
    try:
        os.chdir(root)
        for recipe in CTC_RECIPES:
            rec = out[recipe] = {}
            model, total, stages = run_cli_train(report, probe,
                                                 recipe.lower(),
                                                 recipe=recipe)
            rec["epochs"] = model.epoch_log
            del model
            test_total, rec["evaluate_s"] = run_cli_test_ctc(
                report, probe, root, recipe.lower(), recipe)
            for k in counts:
                counts[k] += total[k] + test_total[k]
            report(f"  {recipe} on {smi}: epochs " + ", ".join(
                f"{e['epoch']}: {e['seconds']:.3f} s "
                f"{e['utt_sec_per_sec']:.1f} utt-sec/sec"
                for e in rec["epochs"]))
        amp_model, amp_total, _ = run_cli_train(
            report, probe, "ctc_bf16", amp=True, recipe="CRDNN_CTC")
        out["CRDNN_CTC"]["bf16_epochs"] = amp_model.epoch_log
        del amp_model
    finally:
        probe.close()
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    return counts, amp_total, out


def stats_summaries(model):
    """Each TEST statistic's summary, by name (the loss statistics too)."""
    out = {}
    for key, stats in sorted(model.stats_loggers.items()):
        try:
            out[key] = stats.summarize()
        except ValueError:   # nothing appended
            out[key] = None
    return out


def run_cli_test_metrics(report, probe, root, name, recipe):
    """``cli.test`` of a harness recipe or LSTM_FC from its best
    checkpoint, then the same checkpoint and batches through the plain
    versions: launches exact, ``test_metrics.txt`` equal (phoneme
    accuracy, boundary, loss and frame-level MD scores as written), every
    non-loss statistic's summary equal and the loss within
    CLI_LOSS_RTOL. Returns the kernel run's launches."""
    import torch
    from mlvae_tpu_torch.cli import test as test_cli

    args = cli_args(name, recipe=recipe)
    metrics = Path(root) / f"results/{name}/test_output/test_metrics.txt"
    probe.reset()
    reset_launches()
    model = test_cli.main(args)
    torch.cuda.synchronize()
    test_total = launches()
    (key, rec), = [(k, v) for k, v in probe.stages.items()
                   if k[0] == "TEST"]
    want = {k: v * rec["batches"] for k, v in
            recipe_launches(recipe, "TEST", train=False).items()}
    crdnn_counts(rec["launches"], want, f"{recipe} TEST")
    got_text, got = metrics.read_text(), stats_summaries(model)
    probe.reset()
    with twins():
        reset_launches()
        plain = test_cli.main(args)
        check(sum(launches().values()) == 0,
              "the plain TEST pass hit a kernel")
    want_stats = stats_summaries(plain)
    same = got_text == metrics.read_text() and all(
        got[k] == want_stats[k] for k in got if not k.endswith("loss_stats"))
    same = same and sorted(got) == sorted(want_stats)
    loss_rel = abs(rec["loss"] - probe.stages[key]["loss"]) / max(
        abs(rec["loss"]), 1e-12)
    report(f"  {recipe} cli.test ({rec['batches']} batch): loss "
           f"{rec['loss']:.6f}, {got}; launches "
           f"{ {k: v for k, v in rec['launches'].items() if v} }; against "
           f"the plain versions on the same checkpoint: same statistics and "
           f"test_metrics.txt {same}, loss rel err {loss_rel:.3e} (tol "
           f"{CLI_LOSS_RTOL:g})")
    check(same, f"the {recipe} TEST pass disagrees with the plain versions")
    check(loss_rel <= CLI_LOSS_RTOL, f"the {recipe} TEST loss disagrees")
    return test_total


def run_cli_hmm(report, probe, root, training_type, smi):
    """HMM_DNN_ALI's ``cli.train`` (one debug epoch) and ``cli.test`` with
    ``training_type`` on the card, then the same on the CPU from the card
    run's initial weights and cached features: no kernel launches on
    either, each stage's loss within HMM_RTOL, the aligner's stored
    alignments and ``accuracy.average`` equal. Returns the card run's
    launches and the numbers."""
    import numpy as np
    import torch
    from mlvae_tpu_torch.cli import test as test_cli
    from mlvae_tpu_torch.cli import train as train_cli
    from mlvae_tpu_torch.models.HMM_DNN_ALI.model import SBModel as HMM

    extra = f", init_training_type: {training_type}, " \
        "realign_during_train: True"
    start = HMM.on_fit_start
    init = {}

    def on_fit_start(model):   # the CPU run starts from the card's weights
        if init:
            model.load_state_dict(init)
        else:
            init.update({k: v.detach().cpu().clone()
                         for k, v in model.state_dict().items()})
        return start(model)
    runs = {}
    HMM.on_fit_start = on_fit_start
    try:
        for where in ("card", "cpu"):
            name = f"hmm_{training_type}" + ("_cpu" if where == "cpu"
                                              else "")
            args = cli_args(name, recipe="HMM_DNN_ALI", extra=extra) + (
                ["--device", "cpu"] if where == "cpu" else [])
            probe.reset()
            reset_launches()
            t0 = time.perf_counter()
            model = train_cli.main(args)
            train_s = time.perf_counter() - t0
            stages = dict(probe.stages)
            store = dict(model.hparams["aligner"].align_dict)
            del model
            probe.reset()
            tested = test_cli.main(args)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            runs[where] = {
                "stages": stages, "store": store, "train_s": train_s,
                "launches": launches(),
                "test_loss": probe.stages[("TEST", 1)]["loss"],
                "accuracy": tested.stats_loggers[
                    "accuracy_stats"].summarize("average"),
                "test_store": dict(tested.hparams["aligner"].align_dict)}
            del tested
    finally:
        HMM.on_fit_start = start
    card, cpu = runs["card"], runs["cpu"]
    check(sum(card["launches"].values()) == 0,
          f"HMM_DNN_ALI {training_type} launched a kernel: "
          f"{ {k: v for k, v in card['launches'].items() if v} }")
    check(all(sum(rec["launches"].values()) == 0
              for rec in card["stages"].values()),
          "an HMM_DNN_ALI stage launched a kernel")
    check(list(card["stages"]) == list(cpu["stages"]),
          f"HMM_DNN_ALI stages {list(card['stages'])}")
    rel = {k: abs(card["stages"][k]["loss"] - cpu["stages"][k]["loss"])
           / max(abs(cpu["stages"][k]["loss"]), 1e-12)
           for k in card["stages"]}
    rel[("TEST", 1)] = abs(card["test_loss"] - cpu["test_loss"]) / max(
        abs(cpu["test_loss"]), 1e-12)

    def same_store(a, b):
        return sorted(a) == sorted(b) and all(
            np.array_equal(a[k], b[k]) for k in a)
    same = same_store(card["store"], cpu["store"]) and same_store(
        card["test_store"], cpu["test_store"])
    report(f"  HMM_DNN_ALI {training_type} on {smi}: stage losses "
           + ", ".join(f"{k[0]} {v['loss']:.6f}" for k, v in
                       card["stages"].items())
           + f", TEST {card['test_loss']:.6f}; accuracy.average "
           f"{card['accuracy']:.4f}; {len(card['store'])} alignments stored "
           f"in training; cli.train {card['train_s']:.3f} s; no kernel "
           f"launched; against the CPU run from the same weights: loss rel "
           "err " + ", ".join(f"{k[0]} {v:.3e}" for k, v in rel.items())
           + f" (tol {HMM_RTOL:g}), same alignments {same}, same accuracy "
           f"{card['accuracy'] == cpu['accuracy']}")
    check(max(rel.values()) <= HMM_RTOL,
          f"HMM_DNN_ALI {training_type}: the card's losses disagree")
    check(same and card["accuracy"] == cpu["accuracy"],
          f"HMM_DNN_ALI {training_type}: the alignments disagree")
    return card["launches"], {
        "stage_loss": {f"{k[0]} {k[1]}": v["loss"]
                       for k, v in card["stages"].items()},
        "test_loss": card["test_loss"], "accuracy": card["accuracy"],
        "loss_rel_err_cpu": {f"{k[0]} {k[1]}": v for k, v in rel.items()},
        "train_s": card["train_s"]}


def run_cli_harness(dev, report, smi):
    """Phase 3's CLI path of the five harness recipes, LSTM_FC and
    HMM_DNN_ALI in one temporary directory (one corpus), each at its
    recipe's width: ``cli.train`` (one debug epoch of two batches) and
    ``cli.test`` through the kernels against the same through the plain
    versions (launches exact; epoch losses within CLI_LOSS_RTOL, under
    --bf16 CLI_AMP_LOSS_RTOL; TEST's statistics equal); test_h_vae's and
    LSTM_FC's ``cli.train --bf16`` likewise; HMM_DNN_ALI with the
    ``forward`` and the ``viterbi`` training type against the CPU. Returns
    the launches of the kernel runs (f32 and --bf16), the numbers and the
    phase's seconds."""
    import logging
    import os
    import shutil
    import tempfile

    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    t0 = time.perf_counter()
    cwd = os.getcwd()
    root = tempfile.mkdtemp(prefix="mlvae_cli_harness_")
    probe = CliProbe()
    out = {"card": smi}
    counts = {k: 0 for k in launches()}
    amp_counts = {k: 0 for k in launches()}

    def add(to, total):
        for k in to:
            to[k] += total[k]
    try:
        os.chdir(root)
        for recipe in HARNESS + ("LSTM_FC",):
            rec = out[recipe] = {}
            model, total, stages = run_cli_train(report, probe,
                                                 recipe.lower(),
                                                 recipe=recipe)
            add(counts, total)
            rec["epochs"] = model.epoch_log
            rec["stage_launches"] = {f"{k[0]} {k[1]}": {
                kn: c for kn, c in v["launches"].items() if c}
                for k, v in stages.items()}
            del model
            add(counts, run_cli_test_metrics(report, probe, root,
                                             recipe.lower(), recipe))
        for recipe in ("test_h_vae", "LSTM_FC"):
            amp_model, amp_total, _ = run_cli_train(
                report, probe, recipe.lower() + "_bf16", amp=True,
                recipe=recipe, extra=BF16_CLI_EXTRA.get(recipe, ""))
            add(amp_counts, amp_total)
            out[recipe]["bf16_epochs"] = amp_model.epoch_log
            del amp_model
        for training_type in HMM_TYPES:
            total, out[f"HMM_DNN_ALI_{training_type}"] = run_cli_hmm(
                report, probe, root, training_type, smi)
            add(counts, total)
    finally:
        probe.close()
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    report(f"  the harness, LSTM_FC and HMM_DNN_ALI CLI phase: "
           f"{out['seconds']:.1f} s on {smi}")
    return counts, amp_counts, out


def hmm_batch(dev, B=HMM_B, T=HMM_T, L=HMM_L, seed=0):
    """A numpy-seeded HMM_DNN_ALI batch on ``dev``: features (B, T, 120),
    canonical phonemes (B, L) and their end samples, relative lengths from
    1.0 down to 0.8, utterance ids."""
    import numpy as np
    import torch
    from mlvae_tpu_torch.bench_utils import INPUT_SIZE
    rs = np.random.RandomState(seed)
    t_lens = np.round(np.linspace(1.0, 0.8, B) * T).astype(np.int64)
    feats = rs.randn(B, T, INPUT_SIZE).astype(np.float32)
    phns = rs.randint(0, 14, (B, L))
    ends = np.stack([np.append(np.sort(rs.choice(np.arange(1, t), L - 1,
                                                 replace=False)), t) * 320
                     for t in t_lens])

    def pair(a, rel):
        return (torch.from_numpy(a).to(dev), torch.from_numpy(rel).to(dev))
    ones = np.ones(B, np.float32)
    return {"id": [f"utt{b}" for b in range(B)],
            "feat": pair(feats, (t_lens / T).astype(np.float32)),
            "gt_cnncl_seq": pair(phns, ones),
            "gt_phn_end_seq": pair(ends, ones)}


def build_hmm(dev, training_type="forward"):
    """HMM_DNN_ALI from the port's recipe copy at its full width, on
    ``dev``, weights from seed 0, its optimizer states initialised."""
    import torch
    from mlvae_tpu_torch.bench_utils import INPUT_SIZE
    from mlvae_tpu_torch.hyperyaml import load_hyperyaml
    from mlvae_tpu_torch.models.HMM_DNN_ALI.model import SBModel as HMM
    injected = {"n_epochs": 1, "dataset_name": "SynAudioMNIST",
                "model_name": "bench", "output_dir": "/tmp/mlvae_bench",
                "input_size": INPUT_SIZE, "n_phonemes": 12,
                "batch_size": HMM_B, "init_training_type": training_type}
    gen = torch.Generator(device=dev).manual_seed(0)
    with open(REPO / "mlvae_tpu_torch/models/HMM_DNN_ALI/model.yaml") as f:
        hp = load_hyperyaml(f, overrides=injected,
                            overrides_must_match=False, device=dev,
                            generator=gen)
    hp.update({k: v for k, v in injected.items() if k not in hp})
    model = HMM(modules=hp["modules"], hparams=hp, device=dev)
    model.init_optimizers()
    return model


def time_hmm(dev, report, smi):
    """Phase 4: one HMM_DNN_ALI train step (``forward`` type) at B=64,
    T=160, L=16 on the card: ms and utt-sec/sec, and a profile of one
    step: kernel time, the device's idle share and the kernels launched a
    step (the forward score's recursion is torch ops, one small step a
    frame, forward and backward)."""
    import numpy as np
    import torch
    model = build_hmm(dev)
    batch = hmm_batch(dev)
    loss, _ = model.fit_batch(batch, 1)
    check(bool(np.isfinite(float(loss))), "HMM_DNN_ALI: non-finite loss")
    B, T = batch["feat"][0].shape[:2]
    out = {"card": smi, "B": B, "T": T, "L": HMM_L}
    ms = cuda_ms(lambda: model.fit_batch(batch, 1), iters=5, warmup=1)
    out.update(train_ms=ms, train_utt_sec_per_sec=B * T * HOP_SEC
               / (ms / 1e3))
    report(f"  HMM_DNN_ALI forward train step B={B} T={T} L={HMM_L}: "
           f"{ms:.3f} ms ({out['train_utt_sec_per_sec']:.1f} utt-sec/sec) "
           f"on {smi}")
    out["train_profile"] = profile_step(
        lambda: model.fit_batch(batch, 1), "HMM_DNN_ALI train step", report)
    return out


def gate_noise(gate, batch, g):
    """One step's standard normal draws, from ``g`` on its device."""
    import torch
    return {k: torch.randn(shape, generator=g, device=g.device)
            for k, shape in gate.draws(batch).items()}


def gate_grad_norms(gate):
    """Each top-level module's norm of the grads the last step applied."""
    import torch
    return {name: float(torch.stack([p.grad.double().square().sum()
                                     for p in mod.parameters()]).sum().sqrt())
            for name, mod in gate.named_children()}


def gate_f32_state(gate) -> bool:
    import torch
    return all(t.dtype == torch.float32 for t in
               [p for p in gate.parameters()]
               + [p.grad for p in gate.parameters()]
               + [gate.opt_state["mu"], gate.opt_state["nu"]])


def run_gate3(dev, report, B=64, T=160, amp=False, ref_f32=None):
    """Two gate-3 train steps at full width through the kernels; the first
    also through the plain versions from the same state and draws.
    ``amp``: under AMP, with f32 parameters and states kept, the first
    loss also held against ``ref_f32`` (the f32 gate's first loss, same
    weights and draws). Returns (gate, batch, first draws, first loss,
    launches of the two kernel steps)."""
    import numpy as np
    import torch
    from mlvae_tpu_torch.bench_utils import GATE3_RECIPE, build_gate, \
        gate_batch
    gate = build_gate(3, seed=0, device=dev, amp=amp, full_width=True)
    batch = gate_batch(3, device=dev, B=B, T=T, C=GATE3_RECIPE["C"])
    g = torch.Generator(device=dev).manual_seed(43)
    loss_tol, grad_tol = (AMP_LOSS_RTOL, AMP_GRAD_RTOL) if amp else \
        (LOSS_RTOL, GRAD_RTOL)
    total = {k: 0 for k in launches()}
    label = "AMP" if amp else "f32"
    for step in range(2):
        noise = gate_noise(gate, batch, g)
        if step == 0:
            first_noise = noise
            start = ({k: v.clone() for k, v in gate.state_dict().items()},
                     {k: v.clone() for k, v in gate.opt_state.items()})
            with twins():
                reset_launches()
                ref_loss = gate.train_step(batch, noise)
                ref_norms = gate_grad_norms(gate)
                torch.cuda.synchronize()
                check(sum(launches().values()) == 0,
                      "the plain gate-3 step hit a kernel")
            gate.load_state_dict(start[0])
            for k, v in start[1].items():
                gate.opt_state[k].copy_(v)
        reset_launches()
        loss = gate.train_step(batch, noise)
        torch.cuda.synchronize()
        counts = launches()
        for k in total:
            total[k] += counts[k]
        report(f"  gate 3 {label} step {step + 1}: loss {float(loss):.6f}; "
               f"launches {counts}")
        check(np.isfinite(float(loss)), "non-finite gate-3 loss")
        want = PER_GATE3_AMP_STEP if amp else PER_GATE3_STEP
        check(counts == want, f"gate-3 launch counts {counts} != {want}")
        check(gate_f32_state(gate), "a gate-3 parameter, grad or Adam state "
              "is not f32")
        if step == 0:
            first_loss = float(loss)
            norms = gate_grad_norms(gate)
            loss_rel = abs(first_loss - float(ref_loss)) / abs(
                float(ref_loss))
            norm_rel = {k: abs(v - ref_norms[k]) / ref_norms[k]
                        for k, v in norms.items()}
            report(f"  against the plain versions: loss rel err "
                   f"{loss_rel:.3e} (tol {loss_tol:g}); grad norm rel err "
                   + ", ".join(f"{k} {v:.3e}" for k, v in norm_rel.items())
                   + f" (tol {grad_tol:g})")
            check(loss_rel <= loss_tol, "gate-3 loss disagrees")
            check(max(norm_rel.values()) <= grad_tol,
                  "gate-3 grads disagree")
            if ref_f32 is not None:
                f32_rel = abs(first_loss - ref_f32) / abs(ref_f32)
                report(f"  against the f32 step from the same weights and "
                       f"draws: f32 loss {ref_f32:.6f}, rel err "
                       f"{f32_rel:.3e} (tol {AMP_F32_RTOL:g})")
                check(f32_rel <= AMP_F32_RTOL,
                      "the AMP gate-3 loss is far from the f32 loss")
    report(f"  launches in the two {label} gate-3 steps: {total}")
    return gate, batch, first_noise, first_loss, total


def run_small_gates(dev, report):
    """One step of gates 1, 2 and 4 on the card against the same step on
    the CPU (same weights, batch and draws): the loss and each parameter's
    applied grad. They reach no kernel."""
    import torch
    from mlvae_tpu_torch.bench_utils import build_gate, gate_batch
    for n in (1, 2, 4):
        out = {}
        for d in (dev, torch.device("cpu")):
            gate = build_gate(n, seed=0, device=d)
            batch = gate_batch(n, device=d)
            g = torch.Generator(device="cpu").manual_seed(44)
            noise = {k: torch.randn(shape, generator=g).to(d)
                     for k, shape in gate.draws(batch).items()}
            reset_launches()
            loss = gate.train_step(batch, noise)
            counts = launches()
            out[d.type] = (float(loss), {k: p.grad.cpu() for k, p in
                                         gate.named_parameters()}, counts)
        (loss, grads, counts), (loss_c, grads_c, _) = out[dev.type], \
            out["cpu"]
        loss_rel = abs(loss - loss_c) / abs(loss_c)
        grad_rel = max(float((grads[k].double() - grads_c[k].double()).norm()
                             / grads_c[k].double().norm()) for k in grads_c)
        report(f"  gate {n} one step, card against CPU: loss {loss:.6f} "
               f"rel err {loss_rel:.3e}, worst grad rel err (norm) "
               f"{grad_rel:.3e} (tol {GATE_RTOL:g}); launches "
               f"{sum(counts.values())}")
        check(loss_rel <= GATE_RTOL and grad_rel <= GATE_RTOL
              and sum(counts.values()) == 0, f"gate {n} disagrees")


def run_unroll(dev, report, iters=UNROLL_ITERS):
    """The unroll A/B path at full shape (B=128, T=160, H=512, In=512, K in
    {2, 4, 8}): ``mlvae_tpu_torch.tools.bench_lstm_unroll.bench``, the
    function its command line runs. Every unrolled arm must be bit-equal
    to its one-step twin, and each timed kernel launches 1 + warm-up +
    ``iters`` times: K1-fwd in f32 and on bf16 streams (its tensor-core
    build) and K3/K4-fwd once each (and K3/K4-fwd on f32 streams), K7a
    three times in f32 and three on bf16 streams, K7b three times in bf16
    and three in f32."""
    import math
    import torch
    from mlvae_tpu_torch.tools import bench_lstm_unroll as BU
    reset_launches()
    res = BU.bench(dev, iters=iters)
    torch.cuda.synchronize()
    counts = launches()
    per = 1 + BU.WARMUP + iters
    n_k = len(BU.KS)
    want = {**{k: 0 for k in PER_FORWARD}, "lstm_fwd": per,
            "lstm_fwd_wide_bf16": per, "lstm_fused_fwd": per,
            "lstm_unroll_fwd": per * n_k, "lstm_unroll_fwd_bf16": per * n_k,
            "lstm_unroll_fused_fwd": per * n_k, "lstm_fused_fwd_f32": per,
            "lstm_unroll_fused_fwd_f32": per * n_k}
    worst = BU.worst_max_abs(res)
    times = [a["twin_ms"] for a in res["arms"] if "K" in a] + [
        k["ms"] for a in res["arms"] for k in a.get("K", {}).values()]
    report(f"  unroll A/B at B={BU.SHAPE[0]} T={BU.SHAPE[1]} "
           f"H={BU.SHAPE[2]} In={BU.SHAPE[3]}, K {list(BU.KS)}: worst "
           f"max_abs against the twins {worst:g} (must be 0); launches "
           f"{counts}")
    check(worst == 0.0, f"an unrolled arm differs from its twin by {worst}")
    check(all(math.isfinite(t) and t > 0 for t in times),
          f"unroll path times {times}")
    check(counts == want, f"unroll path launch counts {counts} != {want}")
    return res, counts


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------

def lstm_bound(T, B, H, bf16=False):
    """K1-fwd and K7a: 2·B·H·4H·T at the stream dtype's peak (f32 on the
    CUDA cores, bf16 on the tensor cores), against gx, W_hh read and hs
    (the stream dtype), cs (f32) written once."""
    item = 2.0 if bf16 else 4.0
    flops = 2.0 * B * H * 4 * H * T
    nbytes = item * (T * B * 4 * H + 4 * H * H + T * B * H) + 4.0 * T * B * H
    return _bound(flops, nbytes, BF16_PEAK if bf16 else F32_PEAK)


def lstm_bwd_bound(T, B, H, bf16=False):
    """Three products per step (the gate recompute, dh_{t-1} = dgates W_hh,
    dW_hh += h_{t-1}^T dgates) at the stream dtype's peak, against gx,
    dgx, hs, dhs, W_hh (the stream dtype), cs, dc_last and dW_hh (f32)
    moved once."""
    item = 2.0 if bf16 else 4.0
    flops = 3 * 2.0 * B * H * 4 * H * T
    nbytes = (item * (2 * T * B * 4 * H + 2 * T * B * H + 4 * H * H)
              + 4.0 * (T * B * H + B * H + 4 * H * H))
    return _bound(flops, nbytes, BF16_PEAK if bf16 else F32_PEAK)


def dw_bound(T, B, H, gates=4, bf16=True):
    """The dW_hh kernel after a recurrence (K1-bwd's, or with ``gates=3``
    K5-bwd's): 2·gates·H·H·(T-1)B at the bf16 tensor-core peak (bf16
    operands) or the f32 peak, against its operands (the dgates, shifted,
    and hs, in the stream dtype) read and dW_hh (f32) written once."""
    K = (T - 1) * B
    item = 2.0 if bf16 else 4.0
    return _bound(2.0 * gates * H * H * K,
                  item * K * (gates + 1) * H + 4.0 * gates * H * H,
                  BF16_PEAK if bf16 else F32_PEAK)


def _bound(flops, nbytes, peak):
    t_o, t_b = flops / peak, nbytes / MEM_BW
    return max(t_o, t_b) * 1e3, "operations" if t_o > t_b else "bytes"


def fused_fwd_bound(T, B, In, H, bf16=True):
    """One product over [x_t | h_{t-1}] per step at the stream dtype's peak
    (bf16 tensor cores, or f32), against x, hs, the weights (the stream
    dtype), cs and the bias (f32) moved once."""
    i = 2.0 if bf16 else 4.0
    flops = 2.0 * B * 4 * H * (In + H) * T
    nbytes = (i * T * B * In + i * T * B * H + 4.0 * T * B * H
              + i * 4 * H * (In + H) + 4.0 * 4 * H)
    return _bound(flops, nbytes, BF16_PEAK if bf16 else F32_PEAK)


def fused_bwd_bound(T, B, In, H, bf16=True):
    """Three products over In + H columns per step (the recompute; dX with
    dh_{t-1}; dW_ih with dW_hh) at the stream dtype's peak, against x, dX,
    hs, dhs (the stream dtype), cs, dc_last, the weights, the bias and the
    f32 dW_ih, db, dW_hh moved once."""
    i = 2.0 if bf16 else 4.0
    flops = 3 * 2.0 * B * 4 * H * (In + H) * T
    nbytes = (i * 2 * T * B * In + i * 2 * T * B * H + 4.0 * T * B * H
              + 4.0 * B * H + i * 4 * H * (In + H) + 4.0 * 4 * H
              + 4.0 * 4 * H * (In + H) + 4.0 * 4 * H)
    return _bound(flops, nbytes, BF16_PEAK if bf16 else F32_PEAK)


def semi_bwd_bound(T, B, In, H, bf16=True):
    """The recompute over In + H columns, dh_{t-1} and dW_hh over H at the
    stream dtype's peak, against x, dgx, hs, dhs (the stream dtype), cs,
    dc_last, the weights, the bias and the f32 dW_hh moved once."""
    i = 2.0 if bf16 else 4.0
    flops = 2.0 * B * 4 * H * (In + H) * T + 2 * 2.0 * B * 4 * H * H * T
    nbytes = (i * T * B * In + i * T * B * 4 * H + i * 2 * T * B * H
              + 4.0 * T * B * H + 4.0 * B * H + i * 4 * H * (In + H)
              + 4.0 * 4 * H + 4.0 * 4 * H * H)
    return _bound(flops, nbytes, BF16_PEAK if bf16 else F32_PEAK)


def lattice_bound(prob):
    """What this run's data needs: the lattice reads only the emissions of
    each row's phonemes, and log pi and log p(b) only at steps t < t_len."""
    yx, y_, y, lpb, lpi, tl, ll, _ = prob
    B, T, N, _ = yx.shape
    L = y.shape[1]
    steps = tl.long().clamp(1, T)                # t = 0 .. t_len-1
    ys = y.long().sort(1).values
    distinct = 1 + (ys[:, 1:] != ys[:, :-1]).sum(1)  # phonemes per row
    reads = (2 * (steps * distinct).sum()        # gathered log p(y|x)
             + 2 * y.unique().numel()            # their log p(y)
             + 2 * steps.sum()                   # log pi, weight folded in
             + 2 * (steps - 1).sum()             # log p(b), t >= 1
             + y.numel() + 2 * B)                # y, t_len, l_len
    # the int8 choices of every step and slot, and beta0
    nbytes = 4.0 * float(reads) + B * T * L * 2 + 4.0 * B
    # per valid step, slot and state: e (1 sub), hold (2), switch (2),
    # from-c/from-i (2), max (2) and the choice (3 compares)
    ops = 12.0 * float((steps - 1).sum()) * L * 2
    t_b, t_o = nbytes / MEM_BW, ops / F32_PEAK
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def backtrace_bound(B, T, L):
    # one choice byte per row and step read, three int32 outputs written
    nbytes = B * (T - 1) + 4.0 * (3 * B + 2 * B * T + B * L)
    return nbytes / MEM_BW * 1e3, "bytes"


def viterbi_bound(prob):
    """K2 in one launch: the lattice's bytes and operations
    (``lattice_bound``) and the backtrace's outputs written once (boundary
    and flvl (B, T), plvl (B, L), int32); the choices it reads are the
    lattice's own output, read back on the chip."""
    yx, _, y, *_ = prob
    B, T, _, _ = yx.shape
    L = y.shape[1]
    lat_ms, by = lattice_bound(prob)
    return lat_ms + 4.0 * (2 * B * T + B * L) / MEM_BW * 1e3, by


def time_viterbi(dev, report, probs, errs, counts):
    """K2 per decode at each shape of ``probs`` ({label: problem}): the
    kernel (one launch, inputs checked and weighted beforehand) back to
    back by CUDA events and alone by the profiler, the plain decode, its
    bound and the microseconds a chain step (the profiler's ms / (T - 1)),
    beside the bounds of the two earlier launches (``lattice_bound``,
    ``backtrace_bound``). The kernels line takes the first shape."""
    from mlvae_tpu_torch.ops import decode as dec
    by_shape = {}
    for label, prob in probs.items():
        yx, y_, y, lpb, lpi, tl, ll, w = prob
        B, T = yx.shape[:2]
        L = y.shape[1]
        lpi_w = dec.fold_weight(lpi, w).contiguous()
        run = (lambda: dec.md_viterbi_cuda(yx, y_, y, lpb, lpi_w, tl, ll))
        ms = cuda_ms(run, iters=50)
        dev_ms = kernel_ms(run)
        plain = cuda_ms(lambda: dec.md_viterbi_batch_ref(*prob), iters=3,
                        warmup=1)
        bound, by = viterbi_bound(prob)
        by_shape[label] = dict(
            ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=bound,
            bound_by=by, us_per_step=dev_ms * 1e3 / max(T - 1, 1),
            lattice_bound_ms=lattice_bound(prob)[0],
            backtrace_bound_ms=backtrace_bound(B, T, L)[0])
        report(f"  md_viterbi {label}: {ms:.4f} ms a decode back to back "
               f"(CUDA events, the wrapper's host work included), kernel "
               f"{dev_ms:.4f} ms (profiler; "
               f"{by_shape[label]['us_per_step']:.3f} us a chain step), one "
               f"launch; plain {plain:.4f}; bound {bound:.6f} by {by}, the "
               f"earlier lattice's {by_shape[label]['lattice_bound_ms']:.6f} "
               f"and backtrace's "
               f"{by_shape[label]['backtrace_bound_ms']:.6f}")
    head = next(iter(by_shape.values()))
    return dict(name="md_viterbi", route="cuda",
                source="mlvae_tpu_torch/csrc/md_viterbi.cu",
                replaces="mlvae_tpu/ops/decode_pallas.py:37 (lattice) and "
                         ":111 (backtrace)",
                max_abs_err=max(errs["lattice"], errs["backtrace"]),
                ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=None, device_ms=head["device_ms"],
                us_per_step=head["us_per_step"],
                shape=next(iter(by_shape)), by_shape=by_shape,
                **counts["md_viterbi"])


def time_all(dev, report, model, batch, noise, prob, prob_b1, errs, counts):
    import torch
    from mlvae_tpu_torch.cli.infer import infer_features
    from mlvae_tpu_torch.ops.lstm import lstm_layer_bwd_ref, lstm_layer_ref
    T, B, H = 160, 64, 512
    g = torch.Generator(device=dev).manual_seed(11)
    gx = torch.randn((T, B, 4 * H), generator=g, device=dev) * 0.5
    w = (torch.rand((4 * H, H), generator=g, device=dev) * 2 - 1) / H ** 0.5
    k1_yard = time_fwd_yard(dev, report, K1_YARD_CASES)
    k1 = k1_yard["lstm_fwd B=64"]["ms"]
    k1_plain = cuda_ms(lambda: lstm_layer_ref(gx, w, False), iters=3,
                       warmup=1)
    k1_lib = k1_yard["lstm_fwd B=64"]["cudnn_ms"]
    k1_bound, k1_by = lstm_bound(T, B, H)

    k2 = time_viterbi(dev, report, {"B=64 T=160 L=8": prob,
                                    "B=1 T=160 L=8": prob_b1}, errs, counts)

    k1b_prob = bwd_problem(g, dev, T, B, H, False)
    k1b_plain = cuda_ms(lambda: lstm_layer_bwd_ref(*k1b_prob, False),
                        iters=2, warmup=1)
    # in turns with cuDNN's backward of one layer: its forward and
    # backward less its forward (it also forms dX and dW_ih, which K1-bwd
    # leaves to matmuls)
    k1b_yard = time_fused_bwd(dev, report, T=T, H=H, cases=K1B_YARD_CASES)
    k1b = k1b_yard["lstm_bwd B=64"]["ms"]
    k1b_lib = k1b_yard["lstm_bwd B=64"]["cudnn_ms"]
    k1b_bound, k1b_by = lstm_bwd_bound(T, B, H)

    step = cuda_ms(lambda: model.eval_step(batch, noise=noise), iters=10)
    # one utterance through the serving entry; it ends in a copy to the host
    infer_ms = cuda_ms(lambda: infer_features(
        model, *infer_input(model, batch["feat"][0].shape[1]), device=dev),
        iters=10)
    with twins():
        step_plain = cuda_ms(lambda: model.eval_step(batch, noise=noise),
                             iters=2, warmup=1)
    Bm, Tm = batch["feat"][0].shape[:2]
    report(f"  lstm_fwd {k1:.4f} ms (plain {k1_plain:.4f}, cuDNN LSTM layer "
           f"incl. input projection {k1_lib:.4f}, bound {k1_bound:.4f} by "
           f"{k1_by})")
    report(f"  lstm_bwd {k1b:.4f} ms (plain {k1b_plain:.4f}, cuDNN LSTM "
           f"layer backward incl. dX and dW_ih, in turns, {k1b_lib:.4f}, "
           f"bound {k1b_bound:.4f} by {k1b_by})")
    report(f"  eval step B={Bm} T={Tm}: {step:.3f} ms "
           f"({Bm * Tm * HOP_SEC / (step / 1e3):.1f} utt-sec/sec); "
           f"through the plain versions {step_plain:.3f} ms")
    report(f"  infer_features B=1 T={Tm}: {infer_ms:.3f} ms")
    profile_step(lambda: model.eval_step(batch, noise=noise), "eval step",
                 report)
    return [
        dict(name="lstm_fwd", route="cuda",
             source="mlvae_tpu_torch/csrc/lstm_fwd.cu",
             replaces="mlvae_tpu/ops/lstm_pallas.py:87",
             max_abs_err=errs["lstm"],
             ms=k1, plain_ms=k1_plain, bound_ms=k1_bound, bound_by=k1_by,
             library_ms=k1_lib, interleaved=k1_yard, **counts["lstm_fwd"]),
        dict(name="lstm_bwd", route="cuda",
             source="mlvae_tpu_torch/csrc/lstm_bwd.cu",
             replaces="mlvae_tpu/ops/lstm_pallas.py:115",
             max_abs_err=errs["lstm_bwd"],
             ms=k1b, plain_ms=k1b_plain, bound_ms=k1b_bound, bound_by=k1b_by,
             library_ms=k1b_lib, interleaved=k1b_yard,
             **counts["lstm_bwd"]),
        k2,
    ], {"eval_step_ms": step, "eval_step_plain_ms": step_plain,
        "utt_sec_per_sec": Bm * Tm * HOP_SEC / (step / 1e3),
        "infer_b1_ms": infer_ms}


def in_turns(timers, rounds, iters):
    """Timers in turns, in order then in reverse (kernel, yardstick,
    yardstick, kernel for two), ``rounds`` times: each one's samples (ms
    a call, CUDA events)."""
    samples = [[] for _ in timers]
    for _ in range(rounds):
        for order in (range(len(timers)), range(len(timers) - 1, -1, -1)):
            for i in order:
                samples[i].append(timers[i](iters))
    return samples


def kernel_split(fn, steps):
    """Device time (profiler, after one warm-up call) of the kernels one
    call of ``fn`` launches: (all of them, those launched at least
    ``steps`` times in the call, i.e. once a step of a recurrence, and the
    six longest as (name, launches, ms))."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((getattr(ev, "self_device_time_total",
                            getattr(ev, "self_cuda_time_total", 0)) / 1e3,
                    ev.count, ev.key) for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA),
                  reverse=True)
    return (sum(ms for ms, _, _ in rows),
            sum(ms for ms, n, _ in rows if n >= steps),
            [(k[:40], n, round(ms, 4)) for ms, n, k in rows[:6]])


def kernel_ms(fn) -> float:
    """Device time of the CUDA kernels one call of ``fn`` launches, summed
    (torch.profiler), after one warm-up call."""
    return kernel_split(fn, 1)[0]


def time_fused_bwd(dev, report, T=160, H=512, cases=BWD_YARD_CASES,
                   rounds=BWD_YARD_ROUNDS):
    """K3-bwd and K4-bwd beside cuDNN's bf16 backward of the same layer,
    K1-bwd (name ``lstm_bwd``, In None) beside cuDNN's f32 backward of an
    In=H layer (its forward and backward less its forward; it also forms
    dX and dW_ih), or on bf16 streams (``lstm_bwd_bf16``) beside cuDNN's
    bf16 backward, timed in turns in one run: median and spread of each,
    the factor of the medians, microseconds a step, the bound; and the
    device time of cuDNN's backward kernels alone (profiler), which the
    host's launches do not stretch."""
    import torch
    from mlvae_tpu_torch.ops import lstm as L
    g = torch.Generator(device=dev).manual_seed(32)
    out = {}
    for name, In, B in cases:
        if In is None:   # K1-bwd, "lstm_bwd" (f32) or "lstm_bwd_bf16"
            bf16 = name.endswith("_bf16")
            dt = torch.bfloat16 if bf16 else torch.float32
            prob = bwd_problem(g, dev, T, B, H, False, bf16=bf16)
            fn = L.lstm_layer_bwd
            cudnn = torch.nn.LSTM(H, H, 1).to(dev, dt)
            xg = torch.randn((T, B, H), generator=g, device=dev).to(
                dt).requires_grad_()
            dy = torch.randn((T, B, H), generator=g, device=dev).to(dt)
        else:
            prob = fused_bwd_problem(g, dev, T, B, In, H, False)
            fn = getattr(L, name)
            cudnn = torch.nn.LSTM(In, H, 1).to(dev, torch.bfloat16)
            xg = prob[0].clone().requires_grad_()
            dy = torch.randn((T, B, H), generator=g, device=dev).to(
                torch.bfloat16)
        cudnn.flatten_parameters()  # else cuDNN compacts them every call

        def kernel(iters):
            return cuda_ms(lambda: fn(*prob), iters=iters, warmup=1)

        def yard(iters):
            fwd = cuda_ms(lambda: cudnn(xg), iters=iters, warmup=1)
            return cuda_ms(lambda: cudnn(xg)[0].backward(dy), iters=iters,
                           warmup=1) - fwd

        ks, ys = in_turns((kernel, yard), rounds, iters=5)
        km, ym = statistics.median(ks), statistics.median(ys)
        dev_ms = (kernel_ms(lambda: cudnn(xg)[0].backward(dy))
                  - kernel_ms(lambda: cudnn(xg)))
        b_ms, b_by = (lstm_bwd_bound(T, B, H, bf16=bf16) if In is None
                      else semi_bwd_bound(T, B, In, H)
                      if name == "lstm_semi_bwd"
                      else fused_bwd_bound(T, B, In, H))
        fk = km / dev_ms if dev_ms else float("nan")
        row = {"ms": km, "spread": [min(ks), max(ks)],
               "us_a_step": km * 1e3 / T, "cudnn_ms": ym,
               "cudnn_spread": [min(ys), max(ys)], "factor": km / ym,
               "cudnn_kernels_ms": dev_ms, "factor_kernels": fk,
               "bound_ms": b_ms, "bound_by": b_by}
        key = f"{name} B={B}" if In is None else f"{name} In={In} B={B}"
        out[key] = row
        report(f"  {key} T={T}: {km:.4f} ms median "
               f"({min(ks):.4f}-{max(ks):.4f}; {row['us_a_step']:.2f} us a "
               f"step); cuDNN {'f32' if name == 'lstm_bwd' else 'bf16'} "
               "layer fwd+bwd less fwd, in turns, "
               f"{ym:.4f} median ({min(ys):.4f}-{max(ys):.4f}); factor "
               f"{km / ym:.3f}; cuDNN's backward kernels alone {dev_ms:.4f} "
               f"(profiler; factor {fk:.3f}); bound {b_ms:.4f} by {b_by}")
    return out


def time_fwd_yard(dev, report, cases, T=160, H=512, rounds=FWD_YARD_ROUNDS):
    """K1-fwd and K3/K4-fwd beside cuDNN's forward of the same layer
    (``torch.nn.LSTM``, one layer, f32 or bf16, with its input
    projection), timed in turns in one run: median and spread of each,
    the factor of the medians, microseconds a step, the bound; and the
    device time of cuDNN's forward kernels alone (profiler)."""
    import torch
    from mlvae_tpu_torch.ops import lstm as L
    g = torch.Generator(device=dev).manual_seed(33)
    out = {}
    for name, In, B in cases:
        if In is None:   # K1-fwd, "lstm_fwd" (f32) or "lstm_fwd_bf16"
            bf16 = name.endswith("_bf16")
            dt = torch.bfloat16 if bf16 else torch.float32
            gx = (torch.randn((T, B, 4 * H), generator=g, device=dev)
                  * 0.5).to(dt)
            w = ((torch.rand((4 * H, H), generator=g, device=dev) * 2 - 1)
                 / H ** 0.5).to(dt)
            fn = lambda: L.lstm_layer_fwd(gx, w, False)
            cudnn = torch.nn.LSTM(H, H, 1).to(dev, dt)
            x = torch.randn((T, B, H), generator=g, device=dev).to(dt)
            b_ms, b_by = lstm_bound(T, B, H, bf16=bf16)
            key = f"{name} B={B}"
        else:
            prob = fused_problem(g, dev, T, B, In, H)
            fn = lambda: L.lstm_fused_fwd(*prob)
            cudnn = torch.nn.LSTM(In, H, 1).to(dev, torch.bfloat16)
            x = prob[0]
            b_ms, b_by = fused_fwd_bound(T, B, In, H)
            key = f"{name} In={In} B={B}"
        cudnn.flatten_parameters()  # else cuDNN compacts them every call
        with torch.no_grad():
            ks, ys = in_turns(
                (lambda iters: cuda_ms(fn, iters=iters, warmup=1),
                 lambda iters: cuda_ms(lambda: cudnn(x), iters=iters,
                                       warmup=1)), rounds, iters=5)
            dev_ms = kernel_ms(lambda: cudnn(x))
        km, ym = statistics.median(ks), statistics.median(ys)
        fk = km / dev_ms if dev_ms else float("nan")
        out[key] = {"ms": km, "spread": [min(ks), max(ks)],
                    "us_a_step": km * 1e3 / T, "cudnn_ms": ym,
                    "cudnn_spread": [min(ys), max(ys)], "factor": km / ym,
                    "cudnn_kernels_ms": dev_ms, "factor_kernels": fk,
                    "bound_ms": b_ms, "bound_by": b_by}
        report(f"  {key} T={T}: {km:.4f} ms median ({min(ks):.4f}-"
               f"{max(ks):.4f}; {km * 1e3 / T:.2f} us a step); cuDNN "
               f"{'f32' if name == 'lstm_fwd' else 'bf16'} layer forward "
               "incl. input "
               f"projection, in turns, {ym:.4f} median ({min(ys):.4f}-"
               f"{max(ys):.4f}); factor {km / ym:.3f}; cuDNN's forward "
               f"kernels alone {dev_ms:.4f} (profiler; factor {fk:.3f}); "
               f"bound {b_ms:.4f} by {b_by}")
    return out


def time_fwd_timeline(dev, report):
    """The step timeline of K1-fwd, K3/K4-fwd, the wide K1-fwd on bf16
    streams, the K7 builds beside their twins at the unroll bench's shape,
    and K3/K4-fwd (In 128 and 512, B=64) and K7b (B=128, K=2) on f32
    streams (their timing builds, tools/bench_fwd_timeline.py):
    microseconds a step of each phase."""
    from mlvae_tpu_torch.tools import bench_fwd_timeline as ftl
    res = ftl.bench(dev)
    for r in res["rows"]:
        k = f" K={r['K']}" if "K" in r else ""
        report(f"  timeline {r['kernel']} H={r['H']} In={r['In']} B={r['B']}"
               f"{k}: {r['ms']:.4f} ms ({r['us_a_step']:.2f} us a step), "
               f"timing build {r['ms_timing_build']:.4f}; us a step, median "
               "over blocks (min-max): " + ", ".join(
                   f"{k} {v['median']:.2f} ({v['min']:.2f}-{v['max']:.2f})"
                   for k, v in r["phases_us_a_step"].items()))
    bad = [(r["kernel"], r["In"], r["B"], r.get("K")) for r in res["rows"]
           if not r["bit_equal_to_normal_build"]]
    check(not bad, f"the timing build differs from the normal build: {bad}")
    unequal = [(r["kernel"], r["K"]) for r in res["rows"]
               if not r.get("bit_equal_to_twin", True)]
    check(not unequal, f"a K7 build differs from its twin: {unequal}")
    return res


def time_smem_reads(dev, report):
    """SM clocks a warp LDS.128 takes by pattern
    (``mlvae_tpu_torch.tools.bench_smem_reads``): what the wide K1
    products' shared-memory reads cost against their FMAs."""
    from mlvae_tpu_torch.tools import bench_smem_reads as probe
    res = probe.bench(dev)
    report("  shared-memory reads, SM clocks a warp LDS.128: " + ", ".join(
        f"{k} {v:.3f}" for k, v in res.items()))
    return res


def time_bwd_timeline(dev, report):
    """The step timeline of K3-bwd, K4-bwd, K1-bwd and the wide K1-bwd on
    bf16 streams, and of K3-bwd and K4-bwd on f32 streams, each in the
    schedule its plan takes (split-K: K3 at In=128, K4 at In=512; the
    exchange schedule: K3 at In=256) (their timing builds,
    tools/bench_bwd_timeline.py): microseconds a step of each phase."""
    from mlvae_tpu_torch.ops import lstm as L
    from mlvae_tpu_torch.tools import bench_bwd_timeline as btl
    res = btl.bench(dev)
    for r in res["rows"]:
        report(f"  timeline {r['kernel']} In={r['In']} B={r['B']} "
               f"(ahead={r['ahead']}): {r['ms']:.4f} ms, timing build "
               f"{r['ms_timing_build']:.4f}; us a step, median over blocks "
               "(min-max): " + ", ".join(
                   f"{k} {v['median']:.2f} ({v['min']:.2f}-{v['max']:.2f})"
                   for k, v in r["us_a_step"].items())
               + "; ablation, step us (ms) with only the first r of 64 rows "
               "staged: " + ", ".join(
                   f"r={k[4:]} {v['us_a_step']['step']:.2f} ({v['ms']:.4f})"
                   for k, v in r["ablation"].items()))
    for r in [*res["lstm_bwd"], *res["lstm_bwd_wide_bf16"],
              *res["lstm_bwd_wide"], *res["gru"]]:
        report(f"  timeline {r['kernel']} H={r['H']} B={r['B']}: "
               f"{r['ms']:.4f} ms ({r['us_a_step_total']:.2f} us a step), "
               f"timing build {r['ms_timing_build']:.4f}; us a step, median "
               "over blocks (min-max): " + ", ".join(
                   f"{k} {v['median']:.2f} ({v['min']:.2f}-{v['max']:.2f})"
                   for k, v in r["us_a_step"].items()))
    for r in res["fused_f32"]:
        report(f"  timeline {r['kernel']} In={r['In']} B={r['B']} schedule "
               f"{r['schedule']} ({L.F32_BWD_KERNELS[r['plan']['kernel']]}):"
               f" {r['ms']:.4f} "
               f"ms ({r['us_a_step_total']:.2f} us a step), timing build "
               f"{r['ms_timing_build']:.4f}; us a step, median over blocks "
               "(min-max): " + ", ".join(
                   f"{k} {v['median']:.2f} ({v['min']:.2f}-{v['max']:.2f})"
                   for k, v in r["us_a_step"].items()))
    bad = [r["kernel"] for r in [*res["rows"], *res["lstm_bwd"],
                                 *res["lstm_bwd_wide_bf16"],
                                 *res["lstm_bwd_wide"], *res["gru"],
                                 *res["fused_f32"]]
           if not r["bit_equal_to_normal_build"]]
    check(not bad, f"the timing build differs from the normal build: {bad}")
    return res


def time_fused(dev, report, errs, counts):
    """Each fused kernel at the AMP step's widths (T=160, B=64, H=512; In
    128, 512, 1024 for the forward), its plain version, and cuDNN's bf16
    LSTM layer in turns with it (time_fwd_yard, also at B=256;
    time_fused_bwd). The
    kernels line reports K3/K4-fwd and K3-bwd at In=512, K4-bwd at
    In=1024, B=64."""
    import torch
    from mlvae_tpu_torch.ops import lstm as L
    T, B, H = 160, 64, 512
    g = torch.Generator(device=dev).manual_seed(31)
    fwd_yard = time_fwd_yard(dev, report, FUSED_FWD_YARD_CASES)
    ms = {("fwd", In): fwd_yard[f"lstm_fused_fwd In={In} B={B}"]["ms"]
          for In in (128, 512, 1024)}
    lib = {In: fwd_yard[f"lstm_fused_fwd In={In} B={B}"]["cudnn_ms"]
           for In in (128, 512, 1024)}
    prob = fused_problem(g, dev, T, B, 512, H)
    plain = {"fwd": cuda_ms(lambda: L.lstm_fused_fwd_ref(*prob), iters=2,
                            warmup=1)}
    for kind, name, In in (("bwd", "lstm_fused_bwd", 512),
                           ("semi", "lstm_semi_bwd", 1024)):
        prob = fused_bwd_problem(g, dev, T, B, In, H, False)
        ref = getattr(L, name + "_ref")
        plain[kind] = cuda_ms(lambda: ref(*prob), iters=2, warmup=1)
    for In in (128, 512, 1024):
        b_ms, b_by = fused_fwd_bound(T, B, In, H)
        report(f"  lstm_fused_fwd In={In}: {ms[('fwd', In)]:.4f} ms (bound "
               f"{b_ms:.4f} by {b_by}; cuDNN bf16 LSTM layer forward incl. "
               f"input projection {lib[In]:.4f})")
    yard = time_fused_bwd(dev, report)
    report(f"  plain versions: lstm_fused_fwd In=512 {plain['fwd']:.4f} ms, "
           f"lstm_fused_bwd In=512 {plain['bwd']:.4f} ms, lstm_semi_bwd "
           f"In=1024 {plain['semi']:.4f} ms")
    b_ms, b_by = fused_fwd_bound(T, B, 512, H)
    out = [dict(
        name="lstm_fused_fwd", route="cuda",
        source="mlvae_tpu_torch/csrc/lstm_fused_fwd.cu",
        replaces="mlvae_tpu/ops/lstm_pallas.py:347",
        max_abs_err=errs["lstm_fused_fwd"], ms=ms[("fwd", 512)],
        plain_ms=plain["fwd"], bound_ms=b_ms, bound_by=b_by,
        library_ms=lib[512], shape_in=512,
        ms_by_in={i: t for (_, i), t in ms.items()}, interleaved=fwd_yard,
        **counts["lstm_fused_fwd"])]
    for name, kind, In, src, line in (
            ("lstm_fused_bwd", "bwd", 512, "lstm_fused_bwd.cu", 371),
            ("lstm_semi_bwd", "semi", 1024, "lstm_semi_bwd.cu", 519)):
        row = yard[f"{name} In={In} B={B}"]
        out.append(dict(
            name=name, route="cuda", source=f"mlvae_tpu_torch/csrc/{src}",
            replaces=f"mlvae_tpu/ops/lstm_pallas.py:{line}",
            max_abs_err=errs[name], ms=row["ms"], plain_ms=plain[kind],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["cudnn_ms"], shape_in=In,
            interleaved={k: v for k, v in yard.items()
                         if k.startswith(name)},
            **counts[name]))
    return out


def time_training(dev, report, model, batch, first_noise, label="f32"):
    """Train-step time per target (host clock around synchronised steps,
    each step continuing the training), and a profile of one VAE step."""
    B, T = batch["feat"][0].shape[:2]
    out = {}
    for epoch, name in ((1, "PHN_RECOG"), (2, "B_DETECTOR"), (3, "VAE")):
        def fit(epoch=epoch, name=name):
            model.fit_batch(batch, epoch, noise=first_noise[name])
        ms = cuda_ms(fit, iters=5, warmup=1)
        out[name] = {"ms": ms, "utt_sec_per_sec": B * T * HOP_SEC / (ms / 1e3)}
        report(f"  {label} train step {name} B={B} T={T}: {ms:.3f} ms "
               f"({out[name]['utt_sec_per_sec']:.1f} utt-sec/sec)")
    profile_step(lambda: model.fit_batch(batch, 3, noise=first_noise["VAE"]),
                 f"{label} VAE train step", report)
    return out


def time_amp_vae(dev, report, B=256, T=160, L=8):
    """The AMP VAE train step at the JAX bench's shape (B=256, T=160), and
    a profile of one."""
    import torch
    from mlvae_tpu_torch.bench_utils import build_md_vae, synth_batch
    from mlvae_tpu_torch.training.brain import Stage
    torch.cuda.reset_peak_memory_stats()
    model = build_md_vae(batch_size=B, seed=0, device=dev, bf16=True)
    batch = synth_batch(B, T, L, seed=0, device=dev)
    model.on_stage_start(Stage.TRAIN, 3)
    noise = train_noise(model, B, T, dev,
                        torch.Generator(device=dev).manual_seed(6))
    ms = cuda_ms(lambda: model.fit_batch(batch, 3, noise=noise), iters=5,
                 warmup=1)
    out = {"ms": ms, "utt_sec_per_sec": B * T * HOP_SEC / (ms / 1e3),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    report(f"  AMP train step VAE B={B} T={T}: {ms:.3f} ms "
           f"({out['utt_sec_per_sec']:.1f} utt-sec/sec); peak memory "
           f"{out['peak_mem_gib']:.2f} GiB")
    profile_step(lambda: model.fit_batch(batch, 3, noise=noise),
                 f"AMP VAE train step at B={B}", report)
    return out


def time_lstm_fc(dev, report, model, batch, first_noise, errs, counts,
                 amp=False):
    """Phase 4 for LSTM_FC: both wide kernels at H=1024, B=64, T=160 in
    turns with cuDNN's layer of the same dtype (forward; forward and
    backward less forward) and its profiled kernels, their plain versions
    and bounds; the eval step and the f32 train step (ms, utt-sec/sec) and
    a profile of each. ``amp``: the bf16 builds beside cuDNN's bf16 layer,
    and the AMP train step and its profile (no eval step: it stays f32).
    Returns the kernels' rows and the steps' numbers."""
    import torch
    from mlvae_tpu_torch.ops.lstm import lstm_layer_bwd_ref, lstm_layer_ref
    T, B, H = 160, 64, WIDE_H
    sfx = "_bf16" if amp else ""
    fwd = time_fwd_yard(dev, report, ((f"lstm_fwd{sfx}", None, B),), T=T,
                        H=H)
    bwd = time_fused_bwd(dev, report, T=T, H=H,
                         cases=((f"lstm_bwd{sfx}", None, B),))
    g = torch.Generator(device=dev).manual_seed(43)
    prob = bwd_problem(g, dev, T, B, H, False, bf16=amp)
    fwd_plain = cuda_ms(lambda: lstm_layer_ref(*prob[:2]), iters=3, warmup=1)
    bwd_plain = cuda_ms(lambda: lstm_layer_bwd_ref(*prob), iters=2, warmup=1)
    f_bound, f_by = lstm_bound(T, B, H, bf16=amp)
    b_bound, b_by = lstm_bwd_bound(T, B, H, bf16=amp)
    # K1-bwd's dW_hh kernel alone, on its operands at this shape
    from mlvae_tpu_torch import _build
    from mlvae_tpu_torch.ops import lstm as L
    dw_kernel = L.LSTM_DW_WIDE_BF16 if amp else L.LSTM_DW_WIDE
    dgx, hs = L.lstm_layer_bwd(*prob, False)[0], prob[2]
    dw = torch.empty((4 * H, H), device=dev)
    st = _build.stream_handle(dev)
    dw_ms = cuda_ms(lambda: dw_kernel(
        dgx.data_ptr(), hs.data_ptr(), dw.data_ptr(), T, B, H, 0, st),
        iters=10)
    dw_plain = cuda_ms(lambda: L.wide_dw_ref(dgx, hs), iters=1, warmup=1)
    xs, ys = dgx[1:].reshape(-1, 4 * H), hs[:-1].reshape(-1, H)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the yardstick in f32
    try:
        dw_lib = cuda_ms(lambda: torch.matmul(xs.t(), ys), iters=10)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    w_bound, w_by = dw_bound(T, B, H, bf16=amp)
    dt = "bf16" if amp else "f32"
    report(f"  {dw_kernel.name} H={H}: {dw_ms:.4f} ms (plain "
           f"{dw_plain:.4f}, one {dt} torch.matmul of the same operands "
           f"{dw_lib:.4f}, bound {w_bound:.4f} by {w_by}); K1-bwd's "
           f"recurrence alone "
           f"{bwd[f'lstm_bwd{sfx} B={B}']['ms'] - dw_ms:.4f}")
    f_row, b_row = fwd[f"lstm_fwd{sfx} B={B}"], bwd[f"lstm_bwd{sfx} B={B}"]
    report(f"  lstm_fwd_wide{sfx} H={H}: {f_row['ms']:.4f} ms (plain "
           f"{fwd_plain:.4f}, cuDNN {dt} layer with its input projection in "
           f"turns {f_row['cudnn_ms']:.4f}, its kernels alone "
           f"{f_row['cudnn_kernels_ms']:.4f}, bound {f_bound:.4f} by {f_by})")
    report(f"  lstm_bwd_wide{sfx} H={H}: {b_row['ms']:.4f} ms (plain "
           f"{bwd_plain:.4f}, cuDNN {dt} backward in turns "
           f"{b_row['cudnn_ms']:.4f}, its kernels alone "
           f"{b_row['cudnn_kernels_ms']:.4f}, bound {b_bound:.4f} by {b_by})")

    Bm, Tm = batch["feat"][0].shape[:2]
    steps = {}
    if not amp:
        ev = cuda_ms(lambda: model.eval_step(batch), iters=10)
        steps.update(eval_ms=ev,
                     eval_utt_sec_per_sec=Bm * Tm * HOP_SEC / (ev / 1e3))
        report(f"  LSTM_FC eval step B={Bm} T={Tm}: {ev:.3f} ms "
               f"({steps['eval_utt_sec_per_sec']:.1f} utt-sec/sec)")
    tr = cuda_ms(lambda: model.fit_batch(batch, 1, noise=first_noise),
                 iters=5, warmup=1)
    steps.update(train_ms=tr,
                 train_utt_sec_per_sec=Bm * Tm * HOP_SEC / (tr / 1e3))
    if not amp:
        steps["eval_profile"] = profile_step(lambda: model.eval_step(batch),
                                             "LSTM_FC eval step", report)
    label = "AMP" if amp else "f32"
    report(f"  LSTM_FC {label} train step B={Bm} T={Tm}: {tr:.3f} ms "
           f"({steps['train_utt_sec_per_sec']:.1f} utt-sec/sec)")
    steps["train_profile"] = profile_step(
        lambda: model.fit_batch(batch, 1, noise=first_noise),
        f"LSTM_FC {label} train step", report)
    wide = errs[f"lstm_wide{sfx}"]
    kernels = [
        dict(name=f"lstm_fwd_wide{sfx}", route="cuda",
             source=f"mlvae_tpu_torch/csrc/lstm_fwd_wide{sfx}.cu",
             replaces="mlvae_tpu/ops/lstm_pallas.py:87",
             max_abs_err=wide["fwd"], ms=f_row["ms"],
             plain_ms=fwd_plain, bound_ms=f_bound, bound_by=f_by,
             library_ms=f_row["cudnn_ms"], interleaved=fwd,
             **counts[f"lstm_fwd_wide{sfx}"]),
        dict(name=f"lstm_bwd_wide{sfx}", route="cuda",
             source=f"mlvae_tpu_torch/csrc/lstm_bwd_wide{sfx}.cu",
             replaces="mlvae_tpu/ops/lstm_pallas.py:115",
             max_abs_err=wide["bwd"], ms=b_row["ms"],
             plain_ms=bwd_plain, bound_ms=b_bound, bound_by=b_by,
             library_ms=b_row["cudnn_ms"], interleaved=bwd,
             **counts[f"lstm_bwd_wide{sfx}"])]
    # ms above: the whole K1-bwd, its dW_hh kernel included
    kernels.append(dict(
        name=dw_kernel.name, route="cuda",
        source=f"mlvae_tpu_torch/csrc/lstm_bwd_wide{sfx}.cu",
        replaces="mlvae_tpu/ops/lstm_pallas.py:115",
        max_abs_err=wide["dw"], ms=dw_ms, plain_ms=dw_plain,
        bound_ms=w_bound, bound_by=w_by, library_ms=dw_lib,
        **counts[dw_kernel.name]))
    return kernels, steps


def gru_fwd_bound(T, B, H, bf16):
    """The recurrent product per step at the stream dtype's peak (f32 on
    the CUDA cores, bf16 on the tensor cores), against gx, W_hh, b_hh read
    and hs (and hs32 under bf16) written once."""
    item = 2.0 if bf16 else 4.0
    flops = 2.0 * B * H * 3 * H * T
    nbytes = (item * (T * B * 3 * H + 3 * H * H + T * B * H) + 4.0 * 3 * H
              + (4.0 * T * B * H if bf16 else 0.0))
    return _bound(flops, nbytes, BF16_PEAK if bf16 else F32_PEAK)


def gru_bwd_bound(T, B, H, bf16):
    """Three products per step (the recompute, dh_{t-1} = dgh W_hh, dW_hh
    += h_{t-1}^T dgh) against gx, hs, dhs, W_hh, b_hh (and hs32) read and
    dgx, dW_hh, db_hh written once."""
    item = 2.0 if bf16 else 4.0
    flops = 3 * 2.0 * B * H * 3 * H * T
    nbytes = (item * (2 * T * B * 3 * H + 2 * T * B * H + 3 * H * H)
              + 4.0 * (3 * H + 3 * H * H + 3 * H)
              + (4.0 * T * B * H if bf16 else 0.0))
    return _bound(flops, nbytes, BF16_PEAK if bf16 else F32_PEAK)


def time_gru(dev, report, errs, counts, T=160, B=64, H=512, In=120,
             rounds=GRU_YARD_ROUNDS):
    """K5-fwd and K5-bwd at the gate-3 shape (T=160, B=64, H=512), f32 and
    on bf16 streams, each in turns with cuDNN's one-layer GRU of its dtype
    (``torch.nn.GRU``, the same b_hn-inside-r semantics; never the port's
    path) at the encoder's In=120 (its forward with the input projection;
    its forward+backward less its forward, which also forms dX and dW_ih):
    median and spread of each, microseconds a step, and cuDNN's kernels
    alone from the profiler (all of them, and those launched every step,
    its recurrence without its input, dX and weight products), beside
    their plain versions and bounds; and K5-bwd's bf16 dW_hh kernel alone
    beside one bf16 ``torch.matmul`` of its operands."""
    import torch
    from mlvae_tpu_torch import _build
    from mlvae_tpu_torch.ops import gru as G
    g = torch.Generator(device=dev).manual_seed(45)
    out = []
    for bf16 in (False, True):
        dt = torch.bfloat16 if bf16 else torch.float32
        sfx, label = ("_bf16", "bf16") if bf16 else ("", "f32")
        gx, w, b, hs, hs32, dhs = gru_problem(g, dev, T, B, H, bf16, False)
        cudnn = torch.nn.GRU(In, H, 1).to(dev, dt)
        cudnn.flatten_parameters()
        x = torch.randn((T, B, In), generator=g, device=dev).to(dt)
        xg = x.clone().requires_grad_()
        dy = torch.randn((T, B, H), generator=g, device=dev).to(dt)

        def fwd(iters):
            return cuda_ms(lambda: G.gru_layer_fwd(gx, w, b, False), iters,
                           warmup=1)

        def bwd(iters):
            return cuda_ms(lambda: G.gru_layer_bwd(gx, w, b, hs, hs32, dhs,
                                                   False), iters, warmup=1)

        def lib_fwd(iters):
            with torch.no_grad():
                return cuda_ms(lambda: cudnn(x), iters, warmup=1)

        def lib_bwd(iters):
            return cuda_ms(lambda: cudnn(xg)[0].backward(dy), iters,
                           warmup=1) \
                - cuda_ms(lambda: cudnn(xg), iters, warmup=1)

        with torch.no_grad():
            all_f, step_f, top_f = kernel_split(lambda: cudnn(x), T)
        all_fb, step_fb, top_b = kernel_split(
            lambda: cudnn(xg)[0].backward(dy), T)
        all_g, step_g, _ = kernel_split(lambda: cudnn(xg), T)
        cudnn_alone = {"gru_fwd" + sfx: (all_f, step_f),
                       "gru_bwd" + sfx: (all_fb - all_g, step_fb - step_g)}
        report(f"  cuDNN {label} GRU kernels (name, launches, ms): forward "
               f"{top_f}; forward and backward {top_b}")
        if bf16:
            # K5-bwd's dW_hh kernel alone, on the plain BPTT's operands
            dgx, _, _, dgh = G.gru_layer_bwd_ref(gx, w, b, hs, hs32, dhs,
                                                 False, with_dgh=True)
            dgn = dgh[..., 2 * H:].contiguous()
            dwbuf = torch.empty((3 * H, H), device=dev)
            st = _build.stream_handle(dev)
            dw_ms = cuda_ms(lambda: G.GRU_DW_BF16(
                dgx.data_ptr(), dgn.data_ptr(), hs.data_ptr(),
                dwbuf.data_ptr(), T, B, H, 0, st), iters=20)
            dw_plain = cuda_ms(lambda: G.gru_dw_ref(dgx, dgn, hs), iters=2,
                               warmup=1)
            xs = torch.cat([dgx[1:, :, :2 * H], dgn[1:]],
                           dim=2).reshape(-1, 3 * H)
            ys = hs[:-1].reshape(-1, H)
            dw_lib = cuda_ms(lambda: torch.matmul(xs.t(), ys), iters=20)
            w_bound, w_by = dw_bound(T, B, H, gates=3)
        for name, kern, yard, plain, (b_ms, b_by) in (
                ("gru_fwd" + sfx, fwd, lib_fwd,
                 cuda_ms(lambda: G.gru_layer_ref(gx, w, b, False), iters=3,
                         warmup=1), gru_fwd_bound(T, B, H, bf16)),
                ("gru_bwd" + sfx, bwd, lib_bwd,
                 cuda_ms(lambda: G.gru_layer_bwd_ref(gx, w, b, hs, hs32,
                                                     dhs, False),
                         iters=2, warmup=1),
                 gru_bwd_bound(T, B, H, bf16))):
            ks, ys_ = in_turns((kern, yard), rounds, iters=10)
            km, ym = statistics.median(ks), statistics.median(ys_)
            alone, per_step = cudnn_alone[name]
            row = dict(
                name=name, route="cuda",
                source=f"mlvae_tpu_torch/csrc/{name}.cu",
                replaces="mlvae_tpu/ops/gru_pallas.py:"
                + ("31" if name.startswith("gru_fwd") else "63"),
                max_abs_err=errs[name], ms=km, spread=[min(ks), max(ks)],
                us_a_step=km * 1e3 / T, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=ym,
                library_spread=[min(ys_), max(ys_)], factor=km / ym,
                cudnn_kernels_ms=alone, cudnn_per_step_ms=per_step,
                factor_kernels=km / alone if alone else None,
                shape=f"T={T} B={B} H={H} {label}", **counts[name])
            if name == "gru_bwd_bf16":
                row["recurrence_ms"] = km - dw_ms
            out.append(row)
            report(f"  {name} T={T} B={B} H={H}: {km:.4f} ms median "
                   f"({min(ks):.4f}-{max(ks):.4f}; {km * 1e3 / T:.2f} us a "
                   f"step); cuDNN {label} GRU layer "
                   + ("forward incl. input projection"
                      if name.startswith("gru_fwd")
                      else "forward+backward less forward, incl. dX and "
                      "dW_ih") + f", in turns, {ym:.4f} median "
                   f"({min(ys_):.4f}-{max(ys_):.4f}); factor {km / ym:.3f}; "
                   f"cuDNN's kernels alone {alone:.4f}, those launched "
                   f"every step {per_step:.4f} (profiler); plain "
                   f"{plain:.4f}; bound {b_ms:.4f} by {b_by}"
                   + (f"; its dW_hh kernel {dw_ms:.4f}, the recurrence "
                      f"alone {km - dw_ms:.4f}" if name == "gru_bwd_bf16"
                      else ""))
    report(f"  gru_dw_bf16 H={H}: {dw_ms:.4f} ms (plain {dw_plain:.4f}, one "
           f"bf16 torch.matmul of the same operands {dw_lib:.4f}, bound "
           f"{w_bound:.4f} by {w_by})")
    out.append(dict(
        name="gru_dw_bf16", route="cuda",
        source="mlvae_tpu_torch/csrc/gru_bwd_bf16.cu",
        replaces="mlvae_tpu/ops/gru_pallas.py:63",
        max_abs_err=errs["gru_dw_bf16"], ms=dw_ms, plain_ms=dw_plain,
        bound_ms=w_bound, bound_by=w_by, library_ms=dw_lib,
        shape=f"T={T} B={B} H={H} bf16", **counts["gru_dw_bf16"]))
    return out


def time_unroll_yard(dev, report, rounds=UNROLL_YARD_ROUNDS):
    """K7a (f32, bf16) and K7b (bf16, f32) at the unroll bench's shape
    (B=128, T=160, H=512, In=512), each in turns with its one-step twin and
    cuDNN's one-layer LSTM with its input projection in the stream dtype
    (TF32 off): K 2, 4, 8, twin, cuDNN, then in reverse, ``rounds`` times.
    Per build: each timer's median and spread, us a step, the factor of
    each K's median against the twin's and cuDNN's, and cuDNN's forward
    kernels alone (profiler)."""
    import torch
    from mlvae_tpu_torch.tools import bench_lstm_unroll as BU
    B, T, H, In = BU.SHAPE
    g = torch.Generator(device=dev).manual_seed(54)
    out = {}
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name, prob in unroll_builds(g, dev, T, B, H, In):
            dt = prob[0].dtype
            fused = name.startswith("lstm_unroll_fused_fwd")
            cudnn = torch.nn.LSTM(In if fused else H, H, 1).to(dev, dt)
            cudnn.flatten_parameters()
            x = (prob[0] if fused else
                 torch.randn((T, B, H), generator=g, device=dev).to(dt))
            timers = [(lambda iters, K=K: cuda_ms(
                lambda: unroll_run(name, prob, False, K), iters=iters,
                warmup=1)) for K in UNROLL_KS]
            timers += [lambda iters: cuda_ms(
                lambda: unroll_twin(name, prob, False), iters=iters,
                warmup=1),
                lambda iters: cuda_ms(lambda: cudnn(x), iters=iters,
                                      warmup=1)]
            with torch.no_grad():
                samples = in_turns(timers, rounds, iters=5)
                alone = kernel_ms(lambda: cudnn(x))
            med = [statistics.median(v) for v in samples]
            row = {f"K={K}": {"ms": med[i], "spread": [min(samples[i]),
                                                       max(samples[i])],
                              "us_a_step": med[i] * 1e3 / T,
                              "factor_twin": med[i] / med[-2],
                              "factor_cudnn": med[i] / med[-1]}
                   for i, K in enumerate(UNROLL_KS)}
            row["twin"] = {"ms": med[-2], "spread": [min(samples[-2]),
                                                     max(samples[-2])],
                           "us_a_step": med[-2] * 1e3 / T}
            row["cudnn"] = {"ms": med[-1], "spread": [min(samples[-1]),
                                                      max(samples[-1])],
                            "kernels_alone_ms": alone}
            out[name] = row
            report(f"  {name} B={B} T={T} H={H}"
                   + (f" In={In}" if fused else "")
                   + f" in turns: " + ", ".join(
                       f"K={K} {row[f'K={K}']['ms']:.4f} "
                       f"({row[f'K={K}']['spread'][0]:.4f}-"
                       f"{row[f'K={K}']['spread'][1]:.4f}; "
                       f"{row[f'K={K}']['us_a_step']:.2f} us a step)"
                       for K in UNROLL_KS)
                   + f"; twin {med[-2]:.4f} ({min(samples[-2]):.4f}-"
                   f"{max(samples[-2]):.4f}); cuDNN {str(dt)[6:]} "
                   f"{med[-1]:.4f} ({min(samples[-1]):.4f}-"
                   f"{max(samples[-1]):.4f}), its kernels alone "
                   f"{alone:.4f} (profiler)")
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    return out


def time_unroll(dev, report, res, errs, counts):
    """K7a and K7b at the unroll bench's shape from the unroll path's run
    (``res``, CUDA events after warm-up): per K and dtype, beside K1-fwd of
    the stream dtype and K3/K4-fwd at the same B=128, their bounds, their
    plain versions (timed here) and cuDNN's one-layer LSTM with its input
    projection in the arm's dtype; then the three redesigned builds in
    turns with their twins and cuDNN (``time_unroll_yard``). The kernels
    line reports K=4 and lists every K beside it."""
    import torch
    from mlvae_tpu_torch.ops import lstm_unroll_exp as LU
    from mlvae_tpu_torch.tools import bench_lstm_unroll as BU
    B, T, H, In = BU.SHAPE
    bf = torch.bfloat16
    x, gx, w_ih, w_hh, bias = BU.make_inputs(dev, B, T, H, In)
    K = UNROLL_KS[1]
    plain = {
        "f32": cuda_ms(lambda: LU.run_fwd_k_ref(gx, w_hh, False, K),
                       iters=2, warmup=1),
        "bf16": cuda_ms(lambda: LU.run_fwd_k_ref(
            gx.to(bf), w_hh.to(bf), False, K), iters=2, warmup=1),
        "fused": cuda_ms(lambda: LU.run_fwd_fused_k_ref(
            x.to(bf), w_ih.to(bf), bias, w_hh.to(bf), False, K), iters=2,
            warmup=1),
        "fused_f32": cuda_ms(lambda: LU.run_fwd_fused_k_ref(
            x, w_ih, bias, w_hh, False, K), iters=2, warmup=1)}
    arms = {(a["arm"], a["dtype"]): a for a in res["arms"] if "K" in a}
    bounds = {("plain", "f32"): lstm_bound(T, B, H),
              ("plain", "bf16"): lstm_bound(T, B, H, bf16=True),
              ("fused", "bf16"): fused_fwd_bound(T, B, In, H),
              ("fused", "f32"): fused_fwd_bound(T, B, In, H, bf16=False)}
    for key, a in arms.items():
        b_ms, b_by = bounds[key]
        fused_arm = key[0] == "fused"
        p_ms = plain[("fused" if key[1] == "bf16" else "fused_f32")
                     if fused_arm else key[1]]
        name = "lstm_unroll_fused_fwd" if fused_arm else "lstm_unroll_fwd"
        report(f"  {name} {key[1]}: "
               + ", ".join(f"K={k} {v['ms']:.4f} ms" for k, v in
                           a["K"].items())
               + f"; twin {a['twin']} {a['twin_ms']:.4f} ms (bound "
               f"{b_ms:.4f} by {b_by}; plain {p_ms:.4f}; cuDNN {key[1]} "
               f"LSTM layer incl. input projection {a['library_ms']:.4f})")

    # K7b at the AMP step's B=64 beside K3/K4-fwd there: whether forming
    # the input products ahead of the barriers pays at the main path's batch
    from mlvae_tpu_torch.ops import lstm as L
    prob = fused_problem(torch.Generator(device=dev).manual_seed(53), dev,
                         T, 64, In, H)
    b64 = {"lstm_fused_fwd": cuda_ms(lambda: L.lstm_fused_fwd(*prob),
                                     iters=10)}
    for k in UNROLL_KS:
        b64[f"K={k}"] = cuda_ms(lambda: LU.run_fwd_fused_k(*prob, False, k),
                                iters=10)
    report(f"  lstm_unroll_fused_fwd at B=64 T={T} In={In} H={H}: "
           + ", ".join(f"{n} {v:.4f} ms" for n, v in b64.items()))
    yard = time_unroll_yard(dev, report)

    def by_k(a):
        return {k: v["ms"] for k, v in a["K"].items()}

    f32, b16, fused, fused32 = (arms[("plain", "f32")],
                                arms[("plain", "bf16")],
                                arms[("fused", "bf16")],
                                arms[("fused", "f32")])
    return [
        dict(name="lstm_unroll_fwd", route="cuda",
             source="mlvae_tpu_torch/csrc/lstm_unroll_fwd.cu",
             replaces="mlvae_tpu/ops/lstm_unroll_exp.py:36",
             max_abs_err=errs["lstm_unroll_fwd"], ms=f32["K"][str(K)]["ms"],
             plain_ms=plain["f32"], bound_ms=bounds[("plain", "f32")][0],
             bound_by=bounds[("plain", "f32")][1],
             library_ms=f32["library_ms"],
             shape=f"T={T} B={B} H={H} f32 K={K}", ms_by_k=by_k(f32),
             twin_ms=f32["twin_ms"], in_turns=yard["lstm_unroll_fwd"],
             **counts["lstm_unroll_fwd"]),
        dict(name="lstm_unroll_fwd_bf16", route="cuda",
             source="mlvae_tpu_torch/csrc/lstm_unroll_fwd_bf16.cu",
             replaces="mlvae_tpu/ops/lstm_unroll_exp.py:36",
             max_abs_err=errs["lstm_unroll_fwd_bf16"],
             ms=b16["K"][str(K)]["ms"], plain_ms=plain["bf16"],
             bound_ms=bounds[("plain", "bf16")][0],
             bound_by=bounds[("plain", "bf16")][1],
             library_ms=b16["library_ms"],
             shape=f"T={T} B={B} H={H} bf16 K={K}", ms_by_k=by_k(b16),
             twin_ms=b16["twin_ms"], in_turns=yard["lstm_unroll_fwd_bf16"],
             **counts["lstm_unroll_fwd_bf16"]),
        dict(name="lstm_unroll_fused_fwd", route="cuda",
             source="mlvae_tpu_torch/csrc/lstm_unroll_fused_fwd.cu",
             replaces="mlvae_tpu/ops/lstm_unroll_exp.py:93",
             max_abs_err=errs["lstm_unroll_fused_fwd"],
             ms=fused["K"][str(K)]["ms"], plain_ms=plain["fused"],
             bound_ms=bounds[("fused", "bf16")][0],
             bound_by=bounds[("fused", "bf16")][1],
             library_ms=fused["library_ms"],
             shape=f"T={T} B={B} In={In} H={H} bf16 K={K}",
             ms_by_k=by_k(fused), twin_ms=fused["twin_ms"], b64_ms=b64,
             in_turns=yard["lstm_unroll_fused_fwd"],
             **counts["lstm_unroll_fused_fwd"]),
        dict(name="lstm_unroll_fused_fwd_f32", route="cuda",
             source="mlvae_tpu_torch/csrc/lstm_fused_fwd_f32.cu",
             replaces="mlvae_tpu/ops/lstm_unroll_exp.py:93",
             max_abs_err=errs["lstm_unroll_fused_fwd_f32"],
             ms=fused32["K"][str(K)]["ms"], plain_ms=plain["fused_f32"],
             bound_ms=bounds[("fused", "f32")][0],
             bound_by=bounds[("fused", "f32")][1],
             library_ms=fused32["library_ms"],
             shape=f"T={T} B={B} In={In} H={H} f32 K={K}",
             ms_by_k=by_k(fused32), twin_ms=fused32["twin_ms"],
             in_turns=yard["lstm_unroll_fused_fwd_f32"],
             **counts["lstm_unroll_fused_fwd_f32"]),
    ]


def time_gate3(dev, report, gate, batch, noise, label):
    """The gate-3 train step at full width (each step continuing the
    training), and a profile of one step."""
    B, T = batch["feats"].shape[:2]
    ms = cuda_ms(lambda: gate.train_step(batch, noise), iters=5, warmup=1)
    out = {"ms": ms, "utt_sec_per_sec": B * T * HOP_SEC / (ms / 1e3)}
    report(f"  {label} gate-3 train step B={B} T={T}: {ms:.3f} ms "
           f"({out['utt_sec_per_sec']:.1f} utt-sec/sec)")
    out["profile"] = profile_step(lambda: gate.train_step(batch, noise),
                                  f"{label} gate-3 train step", report)
    return out


def fbank_bound(mode, rows, n=None):
    """K6's least time on ``rows`` frames of ``n`` columns (512 in the
    Kaldi mode, else 400), counted two ways, each against the window's
    columns (400; n in the SpeechBrain mode) read and the 40 log-mels
    written once: as the DFT build computes it, products over the window's
    columns (the TPU kernel counts the same products over all N = 512 in
    the Kaldi mode), and as the FFT build would, about 2.5 N log2 N
    operations for a real N-point transform. Both add the pre-processing
    (DC removal, pre-emphasis and window: 5 operations a column; the
    window alone in the SpeechBrain mode), the power and each filter's
    nonzero bins. Returns ((ms, by) for the DFT, (ms, by) for an FFT)."""
    import math
    from mlvae_tpu_torch.ops import fbank as fb
    n = n or (512 if mode == fb.KALDI else 400)
    window = 400 if mode == fb.KALDI else n
    bins = n // 2 + 1
    nonzero = int(fb._frame_consts(mode, 16000, n, window, 40)[
        "mel_len"].sum())
    rest = (5 if mode == fb.KALDI else 1) * window + 3.0 * bins \
        + 2.0 * nonzero
    nbytes = 4.0 * rows * (window + 40)
    return (_bound(rows * (2.0 * window * bins * 2 + rest), nbytes,
                   F32_PEAK),
            _bound(rows * (2.5 * n * math.log2(n) + rest), nbytes, F32_PEAK))


def _rfft_power(f, consts):
    import torch
    spec = torch.fft.rfft(f, dim=1)
    return spec.real.square() + spec.imag.square()


def fbank_cufft(frames, mode):
    """The library yardstick: the plain version with cuFFT's rfft in place
    of the two DFT products (timed here, never the port's path)."""
    return k6_ref(frames, mode, _power=_rfft_power)


FBANK_TURNS = 5   # rounds of K6 in turns with cuFFT: ten samples each


def time_fbank(dev, report, cases, errs, counts):
    """K6 in each mode and shape by the build its width takes, against its
    plain version, the cuFFT yardstick and its bound; at the FFT build's
    widths the DFT build too (the earlier design, as it still runs at
    other widths). In SpeechBrain mode and on the Kaldi pass's batch the
    build and the yardstick are timed in turns (kernel, cuFFT, cuFFT,
    kernel; ``FBANK_TURNS`` rounds): medians and spreads, and the factor
    against cuFFT. The kernels line gives each build at its main shape:
    the FFT build at the wav-in eval batch (SpeechBrain, B=64), the DFT
    build at the same waves with n_fft = ``DFT_N``; every shape under
    ``by_shape``."""
    from mlvae_tpu_torch.ops import fbank as fb
    by_shape = {"fft": {}, "dft": {}}
    for label, mode, frames, _ in cases:
        small = frames.shape[0] < 1000
        k_iters, y_iters = (100, 20) if small else (20, 5)
        plan = fb.fbank_plan(frames.shape[1])
        yard = (lambda: fbank_cufft(frames, mode))
        plain = cuda_ms(lambda: k6_ref(frames, mode), iters=20 if small else 5)
        lib_err = max_err(fbank_cufft(frames, mode), k6_ref(frames, mode))
        (d_ms, d_by), (f_ms, f_by) = fbank_bound(mode, frames.shape[0],
                                                 frames.shape[1])
        for build in ((plan, "dft") if plan == "fft" else (plan,)):
            run = (lambda: k6(frames, mode, build))
            turns = mode == fb.SB or not small
            if turns:
                ks, ys = in_turns(
                    (lambda _: cuda_ms(run, iters=k_iters),
                     lambda _: cuda_ms(yard, iters=y_iters)), FBANK_TURNS,
                    None)
                ms, lib = statistics.median(ks), statistics.median(ys)
            else:
                ms = cuda_ms(run, iters=k_iters)
                lib = cuda_ms(yard, iters=y_iters)
            b_ms, b_by = (f_ms, f_by) if build == "fft" else (d_ms, d_by)
            dev_ms = kernel_ms(run)
            row = dict(ms=ms, device_ms=dev_ms, plain_ms=plain,
                       library_ms=lib, bound_ms=b_ms,
                       bound_by=b_by, dft_bound_ms=d_ms, fft_bound_ms=f_ms,
                       share_of_fft_bound=f_ms / ms,
                       max_abs_err=errs[label, build],
                       frames=frames.shape[0], n=frames.shape[1])
            turned = ""
            if turns:
                row.update(ms_spread=[min(ks), max(ks)],
                           library_spread=[min(ys), max(ys)],
                           factor=ms / lib)
                turned = (f" in turns, medians of {len(ks)} samples each: "
                          f"K6 {min(ks):.4f}-{max(ks):.4f}, cuFFT "
                          f"{min(ys):.4f}-{max(ys):.4f}, factor "
                          f"{ms / lib:.3f}")
            by_shape[build][label] = row
            report(f"  fbank {label} ({frames.shape[0]} frames of "
                   f"{frames.shape[1]}), {build} build: {ms:.4f} ms (kernel "
                   f"alone {dev_ms:.4f} by the profiler; bound "
                   f"{d_ms:.4f} by {d_by} for the DFT over the window, "
                   f"{f_ms:.4f} by {f_by} for an FFT: {100 * f_ms / ms:.1f} "
                   f"% of it; plain {plain:.4f}; cuFFT rfft + power + mel + "
                   f"log {lib:.4f}, max abs err against the plain version "
                   f"{lib_err:.3e}){turned}")
    heads = {"fft": next(label for label, mode, f, repeat in cases
                         if mode == fb.SB and repeat
                         and fb.fbank_plan(f.shape[1]) == "fft"),
             "dft": next(label for label, mode, f, repeat in cases
                         if fb.fbank_plan(f.shape[1]) == "dft")}
    out = []
    for build, name, src in (("fft", "fbank_fft", "fbank_fft.cu"),
                             ("dft", "fbank", "fbank.cu")):
        head = by_shape[build][heads[build]]
        out.append(dict(
            name=name, route="cuda", source=f"mlvae_tpu_torch/csrc/{src}",
            replaces="mlvae_tpu/ops/fbank_pallas.py:40",
            max_abs_err=head["max_abs_err"], ms=head["ms"],
            device_ms=head["device_ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            shape=heads[build], by_shape=by_shape[build], **counts[name]))
    return out


def host_ms(fn, iters, warmup=2):
    """Host clock around calls that end on the host (a copy back)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def time_wav(dev, report, model, B=64, T=160, L=8):
    """The wav-in serving path: ``infer`` at B=1 split into read and
    features, then the eval (``infer_features`` on those features); the
    wav-in eval step at B=64; a profile of one wav-in eval step; and the
    Kaldi feature pass (``compute_kaldi_features``: read, ``KaldiFbank``
    with deltas, copy back, speaker CMVN) over written wav files."""
    import tempfile
    import torch
    from mlvae_tpu_torch.bench_utils import synth_batch, synth_wav_batch
    from mlvae_tpu_torch.cli.infer import infer, infer_features
    from mlvae_tpu_torch.data.data_io import compute_kaldi_features
    from mlvae_tpu_torch.data.wav import read_wav
    from mlvae_tpu_torch.ops.fbank import Fbank, KaldiFbank
    hparams, enc = wav_hparams()
    fbank = hparams["compute_features"]
    ids = enc.encode_sequence(CANONICAL)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "utt.wav"
        write_utterance(path, T)

        def features():
            wave, _ = read_wav(path)
            feats = fbank(torch.as_tensor(wave[None], device=dev))[0]
            torch.cuda.synchronize()
            return feats
        feats = features()
        out["infer_b1_ms"] = host_ms(
            lambda: infer(model, hparams, enc, path, CANONICAL, device=dev),
            iters=20)
        out["infer_b1_read_features_ms"] = host_ms(features, iters=20)
        out["infer_b1_eval_ms"] = host_ms(
            lambda: infer_features(model, feats, ids, device=dev), iters=20)
    report(f"  infer (wav in) B=1 T={T}: {out['infer_b1_ms']:.3f} ms; read "
           f"and features {out['infer_b1_read_features_ms']:.3f} ms, eval "
           f"{out['infer_b1_eval_ms']:.3f} ms")

    waves, lengths = synth_wav_batch(B, T, seed=0, device=dev)
    batch = model.prepare_batch(synth_batch(B, T, L, seed=0, device=dev))
    noise = eval_noise(model, B, T, dev, seed=3)
    wav_fbank = Fbank(deltas=True)

    def wav_eval():
        feats = wav_fbank(waves, lengths)
        return model.eval_step(dict(batch, feat=(feats, batch["feat"][1])),
                               noise=noise)
    ms = cuda_ms(wav_eval, iters=10)
    feat_ms = cuda_ms(lambda: wav_fbank(waves, lengths), iters=20)
    out["wav_eval_step_ms"] = ms
    out["wav_eval_features_ms"] = feat_ms
    out["wav_eval_utt_sec_per_sec"] = B * T * HOP_SEC / (ms / 1e3)
    report(f"  wav-in eval step B={B} T={T}: {ms:.3f} ms "
           f"({out['wav_eval_utt_sec_per_sec']:.1f} utt-sec/sec), of which "
           f"Fbank(deltas=True) alone {feat_ms:.3f} ms")
    profile_step(wav_eval, "wav-in eval step", report)

    utts = kaldi_pass_waves()
    utt_sec = sum(len(w) for w in utts) / 16000.0
    with tempfile.TemporaryDirectory() as tmp:
        kaldi_hp = write_kaldi_dir(Path(tmp), utts, KALDI_SPEAKERS)
        paths = sorted(Path(tmp).glob("*.wav"))
        out["kaldi_pass_ms"] = host_ms(
            lambda: compute_kaldi_features(kaldi_hp, "train", device=dev),
            iters=3, warmup=1)
        out["kaldi_pass_read_ms"] = host_ms(
            lambda: [read_wav(p) for p in paths], iters=3, warmup=1)
    kwaves, klens = kaldi_pass_batch(dev, utts)
    kaldi = KaldiFbank()
    out["kaldi_pass_extractor_ms"] = cuda_ms(lambda: kaldi(kwaves, klens),
                                             iters=5)
    out["kaldi_pass_utt_sec_per_sec"] = utt_sec / (out["kaldi_pass_ms"]
                                                   / 1e3)
    report(f"  Kaldi feature pass (compute_kaldi_features, {len(utts)} "
           f"utterances of {KALDI_SPEAKERS} speakers, {utt_sec:.1f} utt-sec, "
           f"one batch of up to {KALDI_PASS[1]} samples): "
           f"{out['kaldi_pass_ms']:.3f} ms "
           f"({out['kaldi_pass_utt_sec_per_sec']:.1f} utt-sec/sec); reading "
           f"the wav files {out['kaldi_pass_read_ms']:.3f} ms, its one "
           f"KaldiFbank call on the card "
           f"{out['kaldi_pass_extractor_ms']:.3f} ms")
    return out


def profile_step(fn, label, report):
    """Device time of one call of ``fn`` by kernel name (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # kernels only: an operator row repeats its kernels' time
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    n_kernels = sum(r[1] for r in rows)
    idle = max(0.0, 1 - total / 1e3 / wall_ms)
    report(f"  profile of one {label}: wall {wall_ms:.3f} ms, kernel time "
           f"{total / 1e3:.3f} ms (idle share {idle:.3f}), {n_kernels} "
           "kernel launches; "
           + "; ".join(f"{k[:48]} x{n} {us / 1e3:.3f} ms"
                       for us, n, k in rows[:8]))
    return {"wall_ms": wall_ms, "kernel_ms": total / 1e3, "idle_share": idle,
            "kernel_launches": n_kernels,
            "top": [[k, n, us / 1e3] for us, n, k in rows[:8]]}


class CliProbe:
    """Counts, times and records the CLI path from outside: the launches
    and batches of each stage (TRAIN and VALID per epoch, TEST), each
    stage's loss and each TEST batch's decode, the two feature passes'
    seconds and launches, and ``infer``'s milliseconds. It wraps the
    recipe's hooks and the data path's passes for its lifetime."""

    def __init__(self):
        import importlib
        import mlvae_tpu_torch.cli.infer as infer_mod
        from mlvae_tpu_torch.data import data_io
        from mlvae_tpu_torch.models.CRDNN_CTC.model import \
            SBModel as CTCModel
        from mlvae_tpu_torch.models.MD_VAE.model import SBModel
        from mlvae_tpu_torch.training.brain import Brain
        others = [importlib.import_module(
            f"mlvae_tpu_torch.models.{r}.model").SBModel
            for r in HARNESS + ("LSTM_FC", "HMM_DNN_ALI", "w2v_LSTM_FC")]
        self.stages, self.decodes, self.passes, self.infer_ms = {}, [], {}, []
        self._saved = []
        # with a set here, each stage not in it runs inside a profiler
        # window whose kernel launches land in its record's "profiled"
        self.profile_stages, self._prof = None, None
        # with a list here, each VALID batch's predictions
        self.valid_preds = None
        probe = self

        def wrap(owner, name, make):
            orig = getattr(owner, name)
            self._saved.append((owner, name, orig))
            setattr(owner, name, make(orig))

        def on_stage_start(orig):
            def fn(model, stage, epoch=None):
                orig(model, stage, epoch)
                probe._key = (stage.name, epoch)
                target = getattr(model, "target", None)
                probe.stages[probe._key] = {
                    "target": target.name if target else "-",
                    "batches": 0, "start": launches()}
                if probe.profile_stages is not None \
                        and probe._key not in probe.profile_stages:
                    probe._prof = stage_profiler()
                    probe._prof.__enter__()
                    time.sleep(PROFILE_MARGIN_S)
            return fn

        def on_stage_end(orig):
            def fn(model, stage, stage_loss, epoch=None):
                import torch
                torch.cuda.synchronize()
                rec = probe.stages[(stage.name, epoch)]
                start = rec.pop("start")
                rec["launches"] = {k: v - start[k]
                                   for k, v in launches().items()}
                rec["loss"] = float(stage_loss)
                if probe._prof is not None:
                    time.sleep(PROFILE_MARGIN_S)
                    probe._prof.__exit__(None, None, None)
                    rec["profiled"], rec["profiled_trace"] = \
                        profiled_counts(probe._prof)
                    probe._prof = None
                return orig(model, stage, stage_loss, epoch)
            return fn

        def counted(orig):
            def fn(model, *args, **kwargs):
                probe.stages[probe._key]["batches"] += 1
                return orig(model, *args, **kwargs)
            return fn

        def evaluate_predictions(orig):
            def fn(model, preds, batch, stage):
                if stage.name == "TEST":
                    probe.decodes.append(
                        (list(batch["id"]),
                         {k: v.cpu() for k, v in preds.items()}))
                elif probe.valid_preds is not None:
                    probe.valid_preds.append(
                        (probe._key, list(batch["id"]),
                         {k: v.cpu() for k, v in preds.items()}))
                return orig(model, preds, batch, stage)
            return fn

        def feature_pass(name):
            def make(orig):
                def fn(*args, **kwargs):
                    import torch
                    before = launches()
                    t0 = time.perf_counter()
                    out = orig(*args, **kwargs)
                    torch.cuda.synchronize()
                    rec = probe.passes.setdefault(
                        name, {"seconds": 0.0, "calls": 0,
                               "launches": {k: 0 for k in before}})
                    rec["seconds"] += time.perf_counter() - t0
                    rec["calls"] += 1
                    rec.setdefault("io", []).append((orig, args, kwargs,
                                                     out))
                    for k, v in launches().items():
                        rec["launches"][k] += v - before[k]
                    return out
                return fn
            return make

        def timed_infer(orig):
            def fn(*args, **kwargs):
                t0 = time.perf_counter()
                out = orig(*args, **kwargs)
                probe.infer_ms.append((time.perf_counter() - t0) * 1e3)
                return out
            return fn

        for model_cls in (SBModel, CTCModel, *others):
            wrap(model_cls, "on_stage_start", on_stage_start)
            wrap(model_cls, "on_stage_end", on_stage_end)
        wrap(Brain, "train_batch", counted)
        wrap(Brain, "evaluate_batch", counted)
        wrap(SBModel, "evaluate_predictions", evaluate_predictions)
        wrap(data_io, "compute_kaldi_features", feature_pass("kaldi"))
        wrap(data_io, "sb_features", feature_pass("speechbrain"))
        wrap(infer_mod, "infer", timed_infer)

    def close(self):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)

    def reset(self):
        self.stages, self.decodes, self.infer_ms = {}, [], []


def cli_epochs(recipe):
    """The debug epochs of a recipe's CLI run: one turn of its cycle."""
    if recipe in CTC_RECIPES:
        return CTC_EPOCHS
    if recipe in W2V_RECIPES:
        return W2V_EPOCHS.get(recipe, 1)
    if recipe in HARNESS + ("LSTM_FC", "HMM_DNN_ALI"):
        return HARNESS_EPOCHS
    return CLI_EPOCHS if recipe == "MD_VAE" else FAMILY_EPOCHS[recipe]


def cli_args(name, bf16=False, recipe="MD_VAE", extra="", corpus=None):
    """The recipe as a user runs it: config/run.yaml, the synthesized
    corpus, the recipe at its full width (the loss weights its YAML leaves
    to the default pinned to 1.0), one turn of its cycle in debug epochs
    of two batches, on the card (no --device). ``extra``: more recipe
    keys, e.g. HMM_DNN_ALI's training type; ``corpus``: another dataset,
    its language and phoneme count, run YAML or number of epochs (keys of
    ``SYNTH_CORPUS``)."""
    from mlvae_tpu_torch.bench_utils import unset_loss_weights
    corpus = {**SYNTH_CORPUS, **(corpus or {})}
    yaml = REPO / "mlvae_tpu_torch/models" / recipe / "model.yaml"
    pinned = "" if recipe in CTC_RECIPES + tuple(W2V_CTC) else "".join(
        f", {k}: 1.0" for k in unset_loss_weights(yaml))
    args = [str(corpus["hparams"]), "--dataset", corpus["dataset"],
            "--language", corpus["language"],
            "--n_phonemes", str(corpus["n_phonemes"]),
            "--model_class", recipe, "--model_name", name,
            "--model", f"!include:{yaml}",
            "--extra_overrides",
            "{model: {n_epochs: %d%s%s}}" % (
                corpus["epochs"] or cli_epochs(recipe), pinned, extra),
            "--debug", "--debug_batches", "2"]
    return args + (["--bf16"] if bf16 else [])


def expected_stage_launches(probe, amp=False, recipe="MD_VAE"):
    """What each stage must launch: per batch, the train step's or the
    eval forward's launches of its target."""
    return {key: {k: v * rec["batches"] for k, v in recipe_launches(
        recipe, rec["target"], key[0] == "TRAIN", amp).items()}
        for key, rec in probe.stages.items()}


@contextlib.contextmanager
def checkpoint_writes(on: bool):
    """With ``on`` False, the checkpointer's saves write nothing (the
    w2v runs whose checkpoints nothing reads: a machine's disk takes 45
    GiB of writes a call, and one w2v checkpoint, the trunk's 315M
    parameters with their Adam moments, is 3.8 GB)."""
    from mlvae_tpu_torch.training.checkpointer import Checkpointer
    orig = Checkpointer.save_and_keep_only
    if not on:
        Checkpointer.save_and_keep_only = lambda self, *a, **k: None
    try:
        yield
    finally:
        Checkpointer.save_and_keep_only = orig


def run_cli_train(report, probe, name, amp=False, recipe="MD_VAE",
                  extra="", corpus=None, valid_tol=None, saves=(True, True),
                  plain=True):
    """``cli.train`` for one turn of the recipe's cycle in debug epochs
    (or ``corpus``'s epochs) through the kernels, then the same run from
    the same seed through the plain versions (``extra``, ``corpus``: as
    ``cli_args``; ``valid_tol``: the VALID stages' tolerance where it is
    not the TRAIN stages'; ``saves``: whether the kernel run and the plain
    run write their checkpoints; ``plain`` False: no plain run, for a
    path that launches no kernel, which the launch check holds); returns
    the kernel run's model, its launches and the stage records."""
    import numpy as np
    import torch
    from mlvae_tpu_torch.cli import train as train_cli

    tol = CLI_AMP_LOSS_RTOL if amp else CLI_LOSS_RTOL
    label = ("" if recipe == "MD_VAE" else recipe + " ") + \
        ("--bf16 " if amp else "")
    epochs = (corpus or {}).get("epochs") or cli_epochs(recipe)
    probe.reset()
    reset_launches()
    t0 = time.perf_counter()
    with checkpoint_writes(saves[0]):
        model = train_cli.main(cli_args(name, bf16=amp, recipe=recipe,
                                        extra=extra, corpus=corpus))
    torch.cuda.synchronize()
    model.cli_wall_s = time.perf_counter() - t0
    total = launches()
    stages = probe.stages
    for e in model.epoch_log:
        report(f"  {label}epoch {e['epoch']} {stages[('TRAIN', e['epoch'])]['target']}: "
               f"train loss {e['loss']:.6f}, valid loss "
               f"{e['valid_loss']:.6f}; {e['seconds']:.3f} s wall, "
               f"{e['utt_sec_per_sec']:.1f} utt-sec/sec ({e['batches']} "
               f"batches)")
    want = expected_stage_launches(probe, amp, recipe)
    for key, rec in stages.items():
        report(f"  {label}{key[0]} epoch {key[1]} ({rec['target']}, "
               f"{rec['batches']} batches): launches "
               f"{ {k: v for k, v in rec['launches'].items() if v} }")
        check(rec["launches"] == want[key],
              f"{label}{key}: launches {rec['launches']} != {want[key]}")
        check(np.isfinite(rec["loss"]), f"{label}{key}: non-finite loss")
    check([k for k in stages] == [(st, e) for e in range(1, epochs + 1)
                                  for st in ("TRAIN", "VALID")],
          f"{label}stages {list(stages)}")
    check(getattr(model, "target", None) is None
          or epochs != cli_epochs(recipe)
          or epochs % len(model.TRAIN_CYCLE)
          or model.target.name == "VAE", "the cycle did not end on VAE")
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          "a parameter is not f32")
    kernel_stages = dict(stages)
    if not plain:
        check(sum(total.values()) == 0, f"{label}launched a kernel")
        report(f"  {label}launches no kernel: it is its own plain version")
        return model, total, kernel_stages
    probe.reset()
    with twins(), checkpoint_writes(saves[1]):
        reset_launches()
        train_cli.main(cli_args(name + "_plain", bf16=amp, recipe=recipe,
                                extra=extra, corpus=corpus))
        torch.cuda.synchronize()
        check(sum(launches().values()) == 0,
              "the plain CLI run hit a kernel")
    rel = {key: abs(rec["loss"] - probe.stages[key]["loss"])
           / max(abs(probe.stages[key]["loss"]), 1e-12)
           for key, rec in kernel_stages.items()}
    tols = {key: valid_tol if valid_tol and key[0] == "VALID" else tol
            for key in rel}
    report(f"  {label}against the plain versions from the same seed: "
           "stage loss rel err " + ", ".join(
               f"{k[0]} {k[1]} {v:.3e} (tol {tols[k]:g})"
               for k, v in rel.items()))
    check(all(v <= tols[k] for k, v in rel.items()),
          f"{label}CLI losses disagree")
    return model, total, kernel_stages


def check_feature_passes(report, probe):
    """Each feature pass of the kernel run again on the same inputs
    through the plain versions: every utterance's ``kaldi_feat`` and
    ``feat`` within CLI_FEAT_ATOL. Returns the max abs err of each pass."""
    import numpy as np
    errs = {}
    for name, rec in probe.passes.items():
        err = 0.0
        for orig, args, kwargs, got in rec["io"]:
            with twins():
                reset_launches()
                want = orig(*args, **kwargs)
                check(sum(launches().values()) == 0,
                      f"the plain {name} pass hit a kernel")
            check(list(got) == list(want), f"the {name} pass's utterances "
                  "differ from the plain version's")
            for u in got:
                check(got[u].shape == want[u].shape,
                      f"{name} pass {u}: {got[u].shape} != {want[u].shape}")
                err = max(err, float(np.abs(got[u] - want[u]).max()))
        n = sum(len(io[3]) for io in rec["io"])
        report(f"  {name} feature pass against the plain versions on the "
               f"same {n} utterances: max abs err {err:.3e} "
               f"(tol {CLI_FEAT_ATOL:g})")
        check(err <= CLI_FEAT_ATOL,
              f"the {name} pass disagrees with the plain versions")
        errs[name] = err
    return errs


def run_cli_test(report, probe, root, name, recipe="MD_VAE", corpus=None):
    """``cli.test`` from the best checkpoint (MD_VAE_joint saves none in
    one epoch: the weights it builds), then the same checkpoint and
    batches through the plain versions: launches, decode, MD and boundary
    scores, saved MD results, loss. Returns the kernel run's launches and
    its evaluate split."""
    import json as json_
    import torch
    from mlvae_tpu_torch.cli import test as test_cli

    label = "" if recipe == "MD_VAE" else recipe + " "
    args = cli_args(name, recipe=recipe, corpus=corpus)
    dataset = {**SYNTH_CORPUS, **(corpus or {})}["dataset"]
    metrics = Path(root) / f"results/{name}/test_output/test_metrics.txt"
    saved = Path(root) / f"datasets/{dataset}/saved_md_results/{name}.json"
    probe.reset()
    reset_launches()
    model = test_cli.main(args)
    torch.cuda.synchronize()
    test_total = launches()
    (key, rec), = [(k, v) for k, v in probe.stages.items()
                   if k[0] == "TEST"]
    want = {k: v * rec["batches"] for k, v in
            recipe_launches(recipe, "TEST", train=False).items()}
    timing = model.evaluate_timing
    report(f"  {label}cli.test ({rec['batches']} batch): loss "
           f"{rec['loss']:.6f}; evaluate restore {timing['restore']:.3f}"
           f" s, eval {timing['eval']:.3f} s, write {timing['write']:.3f}"
           f" s; launches { {k: v for k, v in rec['launches'].items() if v} }")
    check(rec["launches"] == want,
          f"{label}TEST launches {rec['launches']} != {want}")
    kernel_metrics, kernel_saved = metrics.read_text(), saved.read_text()
    kernel_decodes = probe.decodes
    probe.reset()
    saved.unlink()
    with twins():
        reset_launches()
        test_cli.main(args)
        check(sum(launches().values()) == 0,
              "the plain TEST pass hit a kernel")
    same_decode = len(kernel_decodes) == len(probe.decodes) and all(
        ids == pids and all(torch.equal(p[k], pp[k]) for k in p)
        for (ids, p), (pids, pp) in zip(kernel_decodes, probe.decodes))
    counts_of = lambda text: [ln for ln in text.splitlines()  # noqa
                              if "plvl_md" in ln or "boundary." in ln]
    same_counts = counts_of(kernel_metrics) == counts_of(
        metrics.read_text())
    same_saved = json_.loads(kernel_saved) == json_.loads(saved.read_text())
    loss_rel = abs(rec["loss"] - probe.stages[key]["loss"]) / abs(
        rec["loss"])
    report(f"  {label}cli.test against the plain versions on the same "
           f"checkpoint: same decode {same_decode}, same MD and boundary "
           f"scores {same_counts}, same saved MD results {same_saved}, "
           f"loss rel err {loss_rel:.3e} (tol {CLI_LOSS_RTOL:g})")
    check(same_decode and same_counts and same_saved,
          f"the {label}TEST pass disagrees with the plain versions")
    check(loss_rel <= CLI_LOSS_RTOL, f"the {label}TEST loss disagrees")
    return test_total, timing


def run_cli_infer(report, probe, root, name, recipe="MD_VAE"):
    """``cli.infer`` on one utterance of the corpus from the best
    checkpoint, then through the plain versions: launches and verdicts.
    Returns the kernel run's launches and ``infer``'s milliseconds."""
    import json as json_
    import torch
    from mlvae_tpu_torch.cli import infer as infer_cli

    label = "" if recipe == "MD_VAE" else recipe + " "
    ann = json_.loads((Path(root) / "datasets/SynAudioMNIST/annotation/"
                       "test.json").read_text())
    utt, meta = sorted(ann.items())[0]
    args = cli_args(name, recipe=recipe) + [
        "--wav", meta["wav_path"], "--canonical",
        " ".join(meta["txt_gt_cnncl_seq"])]
    probe.reset()
    reset_launches()
    verdicts = infer_cli.main(args)
    torch.cuda.synchronize()
    infer_total = launches()
    want = {**recipe_launches(recipe, "TEST", train=False), "fbank_fft": 1}
    with twins():
        plain_verdicts = infer_cli.main(args)
    report(f"  {label}cli.infer {utt} ({len(verdicts)} phonemes): "
           f"{probe.infer_ms[0]:.3f} ms for infer (read, features, "
           f"eval); verdicts {[v['mispronounced'] for v in verdicts]}; "
           f"launches { {k: v for k, v in infer_total.items() if v} }; "
           f"equal to the plain versions' {verdicts == plain_verdicts}")
    check(infer_total == want,
          f"{label}infer launches {infer_total} != {want}")
    check(len(verdicts) == len(meta["txt_gt_cnncl_seq"])
          and verdicts == plain_verdicts, f"{label}infer disagrees")
    return infer_total, probe.infer_ms[0]


def run_cli(dev, report, smi):
    """Phase 3's CLI path in a temporary directory, at the recipe's full
    width on the card: the corpus synthesized and both feature passes
    (K6), ``cli.train`` (three debug epochs), ``cli.test`` from the best
    checkpoint, ``cli.infer.main`` on one utterance of the corpus, each
    against the same through the plain versions; then ``cli.train
    --bf16``. Returns the launches of the kernel runs and the numbers."""
    import logging
    import os
    import shutil
    import tempfile
    import torch

    # the CLI's INFO lines stay off this script's output
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    cwd = os.getcwd()
    root = tempfile.mkdtemp(prefix="mlvae_cli_")
    probe = CliProbe()
    out = {"card": smi}
    try:
        os.chdir(root)
        reset_launches()
        model, train_total, stages = run_cli_train(report, probe, "cli")
        for name, rec in probe.passes.items():
            report(f"  {name} feature pass: {rec['seconds']:.3f} s over "
                   f"{rec['calls']} calls (one a set); launches "
                   f"{ {k: v for k, v in rec['launches'].items() if v} }")
            check(rec["launches"]["fbank_fft"] == rec["calls"] == 3
                  and sum(rec["launches"].values()) == 3,
                  f"the {name} pass did not take K6's FFT build once a set")
        out["feature_pass_err"] = check_feature_passes(report, probe)
        passes = {k: {n: v for n, v in rec.items() if n != "io"}
                  for k, rec in probe.passes.items()}
        out["feature_pass_s"] = {k: v["seconds"] for k, v in passes.items()}
        out["epochs"] = model.epoch_log
        del model

        test_total, timing = run_cli_test(report, probe, root, "cli")
        out["evaluate_s"] = timing
        infer_total, out["infer_ms"] = run_cli_infer(report, probe, root,
                                                     "cli")

        amp_model, amp_total, _ = run_cli_train(report, probe, "cli_bf16",
                                                amp=True)
        check(all(p.dtype == torch.float32 for p in amp_model.parameters()),
              "an AMP parameter is not f32")
        out["bf16_epochs"] = amp_model.epoch_log
        del amp_model
        report(f"  the CLI path on {smi}: feature passes "
               + ", ".join(f"{k} {v:.3f} s" for k, v in
                           out["feature_pass_s"].items())
               + "; epochs " + ", ".join(
                   f"{e['epoch']}: {e['seconds']:.3f} s {e['utt_sec_per_sec']:.1f}"
                   " utt-sec/sec" for e in out["epochs"])
               + f"; evaluate {timing['restore']:.3f}/{timing['eval']:.3f}/"
               f"{timing['write']:.3f} s; infer {out['infer_ms']:.3f} ms")
    finally:
        probe.close()
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    passes_total = {k: sum(p["launches"][k] for p in passes.values())
                    for k in train_total}
    counts = {k: train_total[k] + test_total[k] + infer_total[k]
              for k in train_total}
    out["stage_launches"] = {f"{k[0]} {k[1]} {v['target']}": {
        n: c for n, c in v["launches"].items() if c}
        for k, v in stages.items()}
    out["feature_pass_launches"] = {
        k: {n: c for n, c in v["launches"].items() if c}
        for k, v in passes.items()}
    return counts, amp_total, passes_total, out


def write_saved_posteriors(root, rows=64, classes=14):
    """``results/saved_phn_recog_outs.pkl`` for MD_VAE_sfl_saved_phn_recog:
    random (rows, classes) posteriors for every utterance of the
    synthesized corpus's three sets (``prepare_batch`` cuts or zero-pads
    them to each batch's length)."""
    import json as json_
    import pickle
    import numpy as np
    rs = np.random.RandomState(0)
    outs = {}
    for name in ("train", "valid", "test"):
        ann = json_.loads((Path(root) / "datasets/SynAudioMNIST/annotation"
                           / f"{name}.json").read_text())
        for utt in sorted(ann):
            outs[utt] = rs.randn(rows, classes).astype(np.float32)
    (Path(root) / "results").mkdir(exist_ok=True)
    with open(Path(root) / "results/saved_phn_recog_outs.pkl", "wb") as f:
        pickle.dump(outs, f)
    return len(outs)


def run_cli_family(dev, report, smi):
    """Phase 3's CLI path for the rest of the MD_VAE family in a temporary
    directory, at each recipe's full width on the card: ``cli.train`` for
    one turn of its cycle (MD_VAE_sfl 3 epochs, on the Kaldi pass's
    features; MD_VAE_joint and MD_VAE_joint_ll 1; saved_phn_recog 2, over
    posteriors the script writes), ``cli.test`` and, but for
    saved_phn_recog (whose posteriors a served wav lacks), ``cli.infer``,
    each against the same through the plain versions; then MD_VAE_sfl's
    ``cli.train --bf16``. Returns the launches of the kernel runs (f32 and
    --bf16) and the numbers."""
    import logging
    import os
    import shutil
    import tempfile

    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    cwd = os.getcwd()
    root = tempfile.mkdtemp(prefix="mlvae_cli_family_")
    probe = CliProbe()
    out = {"card": smi}
    counts = {k: 0 for k in launches()}

    def add(total):
        for k in counts:
            counts[k] += total[k]
    try:
        os.chdir(root)
        for recipe in FAMILY:
            name = recipe.lower()
            rec = out[recipe] = {}
            if recipe == "MD_VAE_sfl_saved_phn_recog":
                n = write_saved_posteriors(root)
                report(f"  {recipe}: posteriors of {n} utterances written")
            model, total, stages = run_cli_train(report, probe, name,
                                                 recipe=recipe)
            add(total)
            rec["epochs"] = model.epoch_log
            rec["stage_launches"] = {f"{k[0]} {k[1]} {v['target']}": {
                kn: c for kn, c in v["launches"].items() if c}
                for k, v in stages.items()}
            del model
            total, rec["evaluate_s"] = run_cli_test(report, probe, root,
                                                    name, recipe)
            add(total)
            if recipe != "MD_VAE_sfl_saved_phn_recog":
                total, rec["infer_ms"] = run_cli_infer(report, probe, root,
                                                       name, recipe)
                add(total)
            report(f"  {recipe} on {smi}: epochs " + ", ".join(
                f"{e['epoch']}: {e['seconds']:.3f} s "
                f"{e['utt_sec_per_sec']:.1f} utt-sec/sec"
                for e in rec["epochs"]))
        amp_model, amp_total, _ = run_cli_train(
            report, probe, "sfl_bf16", amp=True, recipe="MD_VAE_sfl")
        out["MD_VAE_sfl"]["bf16_epochs"] = amp_model.epoch_log
        del amp_model
    finally:
        probe.close()
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    return counts, amp_total, out


def check_corpus_passes(report, probe, label, sets, augmented=False):
    """The feature passes that ``probe`` recorded since its ``passes``
    were last emptied: the Kaldi pass and the SpeechBrain pass once a set
    each (and the SpeechBrain pass a second time a set over the augmented
    waves), one launch of K6's FFT build a call (no set passes 256
    utterances) and no other kernel. Prints their seconds and launches;
    returns them."""
    out = {}
    for name, want in (("kaldi", sets), ("speechbrain",
                                        sets * (2 if augmented else 1))):
        rec = probe.passes.get(name, {"calls": 0, "seconds": 0.0,
                                      "launches": launches()})
        got = {k: v for k, v in rec["launches"].items() if v}
        n = sum(len(io[3]) for io in rec.get("io", ()))
        report(f"  {label} {name} feature pass: {rec['seconds']:.3f} s over "
               f"{rec['calls']} calls ({n} utterances); launches {got}")
        check(rec["calls"] == want and got == {"fbank_fft": want},
              f"{label}: the {name} pass made {rec['calls']} calls and "
              f"launched {got}, not K6's FFT build once a call of {want}")
        out[name] = {"seconds": rec["seconds"], "calls": rec["calls"],
                     "utterances": n, "launches": got}
    return out


def run_cli_corpora(dev, report, smi):
    """Phase 3's real corpora: corpora laid out as L2-ARCTIC, TIMIT and
    ChineseDPA (``data/corpus_layout.py``, seed 0) in a temporary
    directory, through the entry points a user calls. On L2-ARCTIC (every
    speaker of its split, two utterances of 2-4 s): ``cli.train`` of
    MD_VAE at the recipe's full width (one debug epoch of two batches)
    and ``cli.test``, then ``cli.train`` of LSTM_FC (H=1024) with
    ``augmentation`` in the run YAML, each against the same through the
    plain versions; TIMIT's waves as NIST SPHERE and ChineseDPA's through
    ``prepare_experiment`` (the prepare and both feature passes); each
    corpus's feature passes with K6's launches exact (twice the
    SpeechBrain pass's with augmentation) and held against the plain
    versions; ``cli.ingest`` over the TIMIT tree. Returns the launches of
    the kernel runs and the numbers."""
    import logging
    import os
    import pickle
    import shutil
    import tempfile
    import numpy as np
    import torch
    from mlvae_tpu_torch.cli import ingest as ingest_cli
    from mlvae_tpu_torch.cli.experiment import prepare_experiment
    from mlvae_tpu_torch.data import corpus_layout
    from mlvae_tpu_torch.data.wav import read_wav

    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    t_start = time.perf_counter()
    cwd = os.getcwd()
    root = tempfile.mkdtemp(prefix="mlvae_cli_corpora_")
    probe = CliProbe()
    out = {"card": smi}
    counts = {k: 0 for k in launches()}

    def add(total):
        for k in counts:
            counts[k] += total[k]

    def passes(label, sets=3, augmented=False):
        """This corpus's passes, checked and held against the plain
        versions (which resets the launch counts: read them before),
        then forgotten."""
        rec = check_corpus_passes(report, probe, label, sets, augmented)
        out.setdefault("feature_pass_err", {})[label] = \
            check_feature_passes(report, probe)
        probe.passes = {}
        return rec
    try:
        os.chdir(root)
        t0 = time.perf_counter()
        written = corpus_layout.write_l2_arctic("datasets/L2_ARCTIC")
        corpus_layout.write_timit("datasets/TIMIT")
        corpus_layout.write_chinese_dpa("datasets/ChineseDPA")
        out["write_s"] = time.perf_counter() - t0
        report(f"  corpora written in {out['write_s']:.3f} s: L2_ARCTIC "
               f"{sum(map(len, written.values()))} utterances of "
               f"{len(written)} speakers, TIMIT, ChineseDPA")

        # MD_VAE on L2-ARCTIC: the prepare, both feature passes, one epoch
        probe.passes = {}
        model, total, _ = run_cli_train(report, probe, "l2_md_vae",
                                        corpus=L2_CORPUS)
        add(total)
        out["L2_ARCTIC"] = {"passes": passes("L2_ARCTIC"),
                            "epochs": model.epoch_log}
        del model
        test_total, out["L2_ARCTIC"]["evaluate_s"] = run_cli_test(
            report, probe, root, "l2_md_vae", corpus=L2_CORPUS)
        add(test_total)

        # LSTM_FC on the same corpus with augmentation: a run YAML that
        # names the augmenter, and the computed sets made anew
        run_yaml = Path(root) / "run_augmented.yaml"
        run_yaml.write_text((REPO / "config/run.yaml").read_text()
                            + AUGMENTATION)
        shutil.rmtree("datasets/L2_ARCTIC/computed_dataset")
        model, total, _ = run_cli_train(
            report, probe, "l2_lstm_fc", recipe="LSTM_FC",
            corpus={**L2_CORPUS, "hparams": run_yaml})
        add(total)
        out["L2_ARCTIC_augmented"] = {
            "passes": passes("L2_ARCTIC augmented", augmented=True),
            "epochs": model.epoch_log}
        del model
        with open("datasets/L2_ARCTIC/computed_dataset/train.pkl",
                  "rb") as f:
            train = pickle.load(f)
        check(all(s["aug_feat"].shape == s["feat"].shape
                  and not np.array_equal(s["aug_wav"], s["wav"])
                  for s in train.values()),
              "the augmented train set repeats the clean waves")

        # TIMIT (SPHERE) and ChineseDPA: the prepare and both passes
        for label, corpus in (("TIMIT", TIMIT_CORPUS),
                              ("ChineseDPA", DPA_CORPUS)):
            reset_launches()
            t0 = time.perf_counter()
            prepared = prepare_experiment(cli_args(
                label.lower(), recipe="test_phn_classifier", corpus=corpus))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            add(launches())
            sizes = [len(ds.ids) for ds in prepared["datasets"]]
            sample = next(iter(prepared["datasets"][0].data.values()))
            check(all(sizes) and sample["feat"].shape[1] == 120
                  and sample["feat"].shape == sample["kaldi_feat"].shape
                  and np.isfinite(sample["feat"]).all(),
                  f"{label}: sets {sizes}, feat {sample['feat'].shape}")
            report(f"  {label} prepare_experiment: {seconds:.3f} s; sets "
                   f"{sizes} utterances")
            del prepared
            out[label] = {"passes": passes(label), "sets": sizes,
                          "prepare_s": seconds}

        # cli.ingest over the TIMIT tree: every SPHERE file as 16 kHz WAV
        t0 = time.perf_counter()
        src = Path("datasets/TIMIT/original_dataset")
        n = ingest_cli.main([str(src), "ingested/TIMIT"])
        seconds = time.perf_counter() - t0
        sph = sorted(src.rglob("*.wav"))
        err = 0.0
        for path in sph:
            want, _ = read_wav(path)
            got, sr = read_wav(Path("ingested/TIMIT") / path.relative_to(
                src))
            check(sr == 16000 and len(got) == len(want),
                  f"ingest {path}: {sr} Hz, {len(got)} != {len(want)}")
            err = max(err, float(np.abs(got - want).max()))
        report(f"  cli.ingest over the TIMIT tree: {n} files in "
               f"{seconds:.3f} s (host only), max abs err {err:.3e} "
               "against the SPHERE source (PCM16 again)")
        check(n == len(sph) and err <= 2 / 32768,
              f"cli.ingest wrote {n} of {len(sph)} files, err {err}")
        out["ingest"] = {"files": n, "seconds": seconds}
    finally:
        probe.close()
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_start
    report(f"  the real corpora's data path on {smi}: "
           + "; ".join(f"{k} passes " + ", ".join(
               f"{n} {p['seconds']:.3f} s" for n, p in v["passes"].items())
               + ("; epochs " + ", ".join(
                   f"{e['epoch']}: {e['seconds']:.3f} s" for e in
                   v["epochs"]) if "epochs" in v else "")
               for k, v in out.items() if isinstance(v, dict)
               and "passes" in v)
           + f"; {out['seconds']:.1f} s in all")
    return counts, out


def check_k1_h32(dev, report, shapes):
    """K1-fwd and K1-bwd at w2v_CRDNN_CTC's H=32, at each (T, B) its CLI
    run gave the forward, both directions, against the plain versions;
    returns the largest errors (hs and cs, dgx, dW_hh relative)."""
    import torch
    from mlvae_tpu_torch.ops.lstm import (lstm_layer_bwd, lstm_layer_bwd_ref,
                                          lstm_layer_fwd, lstm_layer_ref)
    g = torch.Generator(device=dev).manual_seed(11)
    worst = {"fwd": 0.0, "dgx": 0.0, "dw": 0.0}
    check(bool(shapes), "the w2v_CRDNN_CTC run gave K1 no H=32 layer")
    for T, B in sorted(shapes):
        for reverse in (False, True):
            prob = bwd_problem(g, dev, T, B, 32, reverse)
            hs_k, cs_k = lstm_layer_fwd(prob[0], prob[1], reverse)
            hs_r, cs_r = lstm_layer_ref(prob[0], prob[1], reverse)
            got = lstm_layer_bwd(*prob, reverse)
            want = lstm_layer_bwd_ref(*prob, reverse)
            torch.cuda.synchronize()
            fwd = max(max_err(hs_k, hs_r), max_err(cs_k, cs_r))
            dgx, dw = bwd_errors(got, want)
            report(f"  lstm_fwd / lstm_bwd T={T} B={B} H=32 reverse="
                   f"{reverse}: hs, cs max_abs_err {fwd:.3e}, dgx "
                   f"{dgx:.3e} (tol {K1_H32_ATOL:g}), dW_hh max rel err "
                   f"{dw:.3e} (tol {BWD_RTOL:g})")
            check(fwd <= K1_H32_ATOL and dgx <= K1_H32_ATOL
                  and dw <= BWD_RTOL, f"K1 at H=32 disagrees: {fwd}, "
                  f"{dgx}, {dw}")
            for k, v in (("fwd", fwd), ("dgx", dgx), ("dw", dw)):
                worst[k] = max(worst[k], v)
    return worst


def set_sizes(root, batch=8, debug_batches=2):
    """Each synthesized set's utterances and its debug run's batches."""
    import json as json_
    out = {}
    for name in ("train", "valid", "test"):
        n = len(json_.loads((Path(root) / "datasets/SynAudioMNIST/"
                             f"annotation/{name}.json").read_text()))
        out[name] = (n, min(debug_batches, -(-n // batch)))
    return out


def run_cli_three_sets(report, probe, root, name):
    """``cli.test_on_three_sets`` of w2v_CRDNN_CTC_cnncl from its
    checkpoint (``name``'s run), through the kernels and then through the
    plain versions: the launches of its three TEST passes, the dump of
    every utterance's posteriors and the test set's metrics. Returns the
    kernel run's launches."""
    import pickle
    import numpy as np
    import torch
    from mlvae_tpu_torch.cli import test_on_three_sets as three_cli

    recipe = "w2v_CRDNN_CTC_cnncl"
    args = cli_args(name, recipe=recipe, extra=W2V_EXTRA[recipe])
    dump = Path(root) / f"results/{name}/saved_phn_recog_outs.pkl"
    metrics = Path(root) / f"results/{name}/test_output/test_metrics.txt"
    sizes = set_sizes(root)

    def run():
        if dump.exists():
            dump.unlink()
        t0 = time.perf_counter()
        three_cli.main(args)
        torch.cuda.synchronize()
        with open(dump, "rb") as f:
            return pickle.load(f), metrics.read_text(), \
                time.perf_counter() - t0
    probe.reset()
    reset_launches()
    got, got_metrics, wall = run()
    total = launches()
    batches = sum(b for _, b in sizes.values())
    want = {k: v * batches for k, v in
            recipe_launches(recipe, "TEST", train=False).items()}
    check(total == want, f"test_on_three_sets launches {total} != {want}")
    with twins():
        reset_launches()
        plain, plain_metrics, _ = run()
        check(sum(launches().values()) == 0,
              "the plain test_on_three_sets hit a kernel")
    n = sum(u for u, _ in sizes.values())
    err = max(float(np.abs(got[u] - plain[u]).max()) for u in got)
    report(f"  {recipe} cli.test_on_three_sets: {len(got)} utterances of "
           f"{n} dumped ({batches} TEST batches), {wall:.3f} s; launches "
           f"{ {k: v for k, v in total.items() if v} }; against the plain "
           f"versions: posteriors max abs err {err:.3e} (tol "
           f"{W2V_POST_ATOL:g}), same test metrics "
           f"{got_metrics == plain_metrics}")
    check(len(got) == n and sorted(got) == sorted(plain)
          and all(v.shape[1] == 14 and np.isfinite(v).all()
                  for v in got.values()), "the dump is incomplete")
    check(err <= W2V_POST_ATOL and got_metrics == plain_metrics,
          "test_on_three_sets disagrees with the plain versions")
    with open(dump, "wb") as f:   # the kernel run's dump, for what reads it
        pickle.dump(got, f)
    return total


def run_cli_external(report, root, name):
    """``cli.test_external`` over an external DNN-HMM JSON for the test
    set (the ground-truth segments, ``sil`` and ``sil*`` phones in turn),
    the YAML's modules on the card, against the same on the CPU."""
    import contextlib
    import io
    import json as json_
    import pickle
    from mlvae_tpu_torch.cli import test_external as ext_cli

    with open(Path(root) / "datasets/SynAudioMNIST/computed_dataset/"
              "test.pkl", "rb") as f:
        computed = pickle.load(f)
    ext = {u: [[float(a), float(b), "sil" if i % 2 else "sil*"]
               for i, (a, b) in enumerate(s["gt_seg_seq"])]
           for u, s in computed.items()}
    ext_dir = Path(root) / "datasets/SynAudioMNIST/external_data"
    ext_dir.mkdir(parents=True, exist_ok=True)
    (ext_dir / "dnn_hmm_test.json").write_text(json_.dumps(ext))
    args = cli_args(name, recipe="test_vanilla_vae")
    # the command prints every metric: kept off this script's output
    with contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        card = ext_cli.main(args)
        wall = time.perf_counter() - t0
        cpu = ext_cli.main(args + ["--device", "cpu"])
    report(f"  cli.test_external ({len(ext)} test utterances): "
           f"{wall:.3f} s; fa boundary.f1 {card['fa']['boundary.f1']:.2f}, "
           f"asr boundary.rec {card['asr']['boundary.rec']:.2f}, asr MD.ACC "
           f"{card['asr']['MD.ACC']:.2f}; equal to the CPU run's "
           f"{card == cpu}")
    check(card == cpu and card["asr"]["boundary.rec"] > 90,
          "cli.test_external disagrees")
    return wall


@contextlib.contextmanager
def deterministic(on=True):
    """cuDNN's and torch's deterministic algorithms on (or off) inside,
    restored after."""
    import torch
    saved = (torch.backends.cudnn.deterministic,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = on
    torch.use_deterministic_algorithms(on, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.use_deterministic_algorithms(saved[1], warn_only=saved[2])


def time_w2v_step(report, model, epoch, label, smi, iters=5):
    """A w2v recipe's train step on its run's last TRAIN batch (CUDA
    events, ``iters`` calls after warm-up, and one profile, in torch's
    default, non-deterministic mode), and, for a frozen trunk, the trunk's
    forward under ``no_grad`` that the step runs first."""
    import torch
    from mlvae_tpu_torch.training.brain import Stage
    with deterministic(False):
        dev_batch = model.to_device_batch(model._last_prepared_batch)
        B, T = dev_batch["feat"][0].shape[:2]
        wavs = dev_batch["wav"][0]
        out = {"B": B, "T": T, "wav_samples": wavs.shape[1], "card": smi}
        if model.wav2vec2.freeze:
            with torch.no_grad():
                out["trunk_ms"] = cuda_ms(lambda: model.wav2vec2(wavs), iters)
        model.set_stage(Stage.TRAIN, epoch)

        def step():
            model.train_step(dev_batch, epoch, generator=model.generator)
        out["step_ms"] = cuda_ms(step, iters)
        out["profile"] = profile_step(step, f"{label} train step", report)
        report(f"  {label} train step (B={B}, T={T}, "
               f"{out['wav_samples']} wave samples): {out['step_ms']:.3f} ms"
               + (f", of which the frozen trunk's forward "
                  f"{out['trunk_ms']:.3f} ms" if "trunk_ms" in out else
                  " (the fine-tuned trunk's forward and backward inside)")
               + f" on {smi}")
        return out


def check_w2v_checkpoint(report, model, opt="wav2vec_opt"):
    """The checkpoint a fine-tuned w2v run with bf16 Adam moments wrote
    (``MLVAE_OPT_MOMENT_DTYPE=bfloat16``): read back, the trunk's
    parameters and optimizer ``opt``'s tree equal to the model's bit for
    bit, the moments bf16 words (``|V2``) and the step count past 0; then
    deleted. Returns its size and read time."""
    import shutil
    import numpy as np
    from mlvae_tpu_torch.convert import load_jax_checkpoint
    ckpts = model.checkpointer.list_checkpoints()
    check(len(ckpts) == 1, f"{len(ckpts)} checkpoints, want 1")
    path = ckpts[0].path
    size = sum(f.stat().st_size for f in path.iterdir())
    t0 = time.perf_counter()
    params = load_jax_checkpoint(path)
    name = f"opt__{opt}"
    want = model._opt_tree(opt)
    got = model.checkpointer.load_checkpoint(ckpts[0], {name: want})[name]
    read_s = time.perf_counter() - t0
    state = model.state_dict()
    trunk = [k for k in state if k.startswith("wav2vec2.")]
    same_params = bool(trunk) and all(
        np.array_equal(state[k].cpu().numpy(), params[k].numpy())
        for k in trunk)

    def bits(a):
        return a.view(np.int16) if a.dtype.kind == "V" else a
    same_opt = sorted(got) == sorted(want) and all(
        np.array_equal(bits(got[k]), bits(want[k])) for k in want)
    words = [k for k, v in got.items() if v.dtype == np.dtype("V2")]
    count = int(got["['wav2vec2'].count"])
    report(f"  the fine-tuned run's checkpoint: {size / 2**30:.2f} GiB, read"
           f" back in {read_s:.3f} s; the trunk's {len(trunk)} parameters "
           f"equal {same_params}, {opt}'s {len(want)} leaves equal "
           f"{same_opt}, {len(words)} of them bf16 moments, count {count};"
           f" deleted")
    check(same_params and same_opt and words and count > 0,
          "the w2v checkpoint does not read back")
    shutil.rmtree(path)
    return {"bytes": size, "read_s": read_s, "bf16_moment_leaves": len(words)}


def check_w2v_first_run(report, probe, model, out):
    """The first w2v run's encoder (wav2vec2-large-lv60's topology) and
    its two feature passes (K6's FFT build once a set each)."""
    enc = model.wav2vec2
    n = sum(p.numel() for p in enc.parameters())
    arch = {k: getattr(enc, k) for k in W2V_ARCH}
    report(f"  the encoder: {arch}, {n} parameters, {enc.feat_extract_norm}"
           f" norm, stable layer norm {enc.do_stable_layer_norm}, frozen "
           f"{enc.freeze}")
    check(arch == W2V_ARCH and enc.do_stable_layer_norm
          and W2V_PARAMS[0] < n < W2V_PARAMS[1], "not wav2vec2-large-lv60")
    out["encoder_parameters"] = n
    passes = probe.passes.values()
    report("  feature passes' launches " + str(
        {k: {c: v for c, v in rec["launches"].items() if v}
         for k, rec in probe.passes.items()}))
    check(len(probe.passes) == 2 and all(
        rec["launches"]["fbank_fft"] == rec["calls"] == 3
        and sum(rec["launches"].values()) == 3 for rec in passes),
        "a feature pass did not take K6 once a set")


def run_cli_w2v(dev, report, smi):
    """Phase 3's CLI path of the six wav2vec2 recipes in one temporary
    directory, the encoder at wav2vec2-large-lv60's topology on the card:
    each recipe's ``cli.train`` (w2v_MD_VAE one cycle, the others one
    debug epoch) against the same through the plain versions (none for
    w2v_LSTM_FC, which launches no kernel; its checkpoint, with bf16 Adam
    moments, read back), launches exact; ``cli.test`` of w2v_MD_VAE and
    w2v_CRDNN_CTC likewise; their
    ``cli.train --bf16`` (w2v_CRDNN_CTC's LSTM on ``lstm_scan``); K1 at
    H=32 at the shapes of the w2v_CRDNN_CTC run against the plain
    versions; ``cli.test_on_three_sets`` of w2v_CRDNN_CTC_cnncl and
    MD_VAE_sfl_saved_phn_recog's ``cli.train`` on its dump;
    ``cli.test_external``; the train steps' times. Returns the launches of
    the kernel runs (f32 and --bf16), the numbers and K1's H=32 errors."""
    import logging
    import os
    import shutil
    import tempfile
    import torch
    from mlvae_tpu_torch.nn import rnn as prnn
    from mlvae_tpu_torch.ops import lstm as lstm_ops

    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    t_phase = time.perf_counter()
    outer = report

    def report(line):   # each line with the phase's seconds at its end
        outer(f"{line} [+{time.perf_counter() - t_phase:.1f} s]")
    cwd = os.getcwd()
    root = tempfile.mkdtemp(prefix="mlvae_cli_w2v_")
    probe = CliProbe()
    out = {"card": smi}
    counts = {k: 0 for k in launches()}
    amp_counts = {k: 0 for k in launches()}
    h32_shapes = set()

    def add(to, total):
        for k in to:
            to[k] += total[k]

    def train(recipe, amp=False):
        label = recipe + (" --bf16" if amp else "")
        t0 = time.perf_counter()
        moments = recipe == W2V_BF16_MOMENTS and not amp
        saved_env = os.environ.get("MLVAE_OPT_MOMENT_DTYPE")
        if moments:
            os.environ["MLVAE_OPT_MOMENT_DTYPE"] = "bfloat16"
        try:
            model, total, stages = run_cli_train(
                report, probe, recipe.lower() + ("_bf16" if amp else ""),
                amp=amp, recipe=recipe, extra=W2V_EXTRA.get(recipe, ""),
                valid_tol=W2V_VALID_RTOL if recipe in W2V_FINE_TUNED
                else None,
                saves=(recipe in W2V_SAVED and not amp, False),
                plain=recipe != "w2v_LSTM_FC")   # launches no kernel
        finally:
            if moments:
                if saved_env is None:
                    os.environ.pop("MLVAE_OPT_MOMENT_DTYPE")
                else:
                    os.environ["MLVAE_OPT_MOMENT_DTYPE"] = saved_env
        check(model.wav2vec2.freeze != (recipe in W2V_FINE_TUNED),
              f"{recipe}: freeze {model.wav2vec2.freeze}")
        if moments:
            out.setdefault(recipe, {})["checkpoint"] = \
                check_w2v_checkpoint(report, model)
        wall = time.perf_counter() - t0
        kernel_s = sum(e["seconds"] for e in model.epoch_log)
        rec = out.setdefault(recipe, {})
        rec["bf16_epochs" if amp else "epochs"] = model.epoch_log
        rec["bf16_stage_launches" if amp else "stage_launches"] = {
            f"{k[0]} {k[1]} {v['target']}": {
                n: c for n, c in v["launches"].items() if c}
            for k, v in stages.items()}
        rec["bf16_wall_s" if amp else "wall_s"] = wall
        rec["bf16_kernel_run_s" if amp else "kernel_run_s"] = \
            model.cli_wall_s
        report(f"  {label}: the kernel run's epochs {kernel_s:.3f} s of "
               f"train and valid steps, its cli.train {model.cli_wall_s:.3f}"
               f" s; with the plain run {wall:.3f} s wall on {smi}")
        return model, total

    # deterministic cuDNN and torch ops for these runs: the fine-tuned
    # trunks' conv backward (cuDNN's weight gradients, atomics) otherwise
    # parts two runs of the same seed (1.3e-3 in w2v_CRDNN_CTC's --bf16
    # epoch, whose train step runs no kernel), which would hide what the
    # kernels change
    try:
        os.chdir(root)
        with deterministic():
            for recipe in W2V_RECIPES:
                record = None
                if recipe == "w2v_CRDNN_CTC":
                    record = lstm_ops.lstm_layer_fwd

                    def recording(gx, w_hh, reverse=False, _orig=record):
                        if w_hh.shape[1] == 32:
                            h32_shapes.add(tuple(gx.shape[:2]))
                        return _orig(gx, w_hh, reverse)
                    lstm_ops.lstm_layer_fwd = recording
                try:
                    model, total = train(recipe)
                finally:
                    if record is not None:
                        lstm_ops.lstm_layer_fwd = record
                add(counts, total)
                if recipe == W2V_RECIPES[0]:   # its launches hold the
                    check_w2v_first_run(report, probe, model, out)  # passes'
                    out["w2v_MD_VAE_step"] = time_w2v_step(
                        report, model, W2V_EPOCHS["w2v_MD_VAE"], "w2v_MD_VAE",
                        smi)
                if recipe == "w2v_MD_VAE_sfl_resi":
                    out["w2v_MD_VAE_sfl_resi_step"] = time_w2v_step(
                        report, model, 1, "w2v_MD_VAE_sfl_resi", smi)
                del model
                if recipe == "w2v_MD_VAE":
                    total, _ = run_cli_test(report, probe, root,
                                            recipe.lower(), recipe)
                    add(counts, total)
                elif recipe == "w2v_CRDNN_CTC":
                    total, _ = run_cli_test_ctc(report, probe, root,
                                                recipe.lower(), recipe)
                    add(counts, total)
            scans = []
            scan = prnn.lstm_scan
            for recipe in ("w2v_MD_VAE", "w2v_CRDNN_CTC"):
                prnn.lstm_scan = lambda *a, _f=scan: scans.append(
                    a[0].shape) or _f(*a)
                try:
                    model, total = train(recipe, amp=True)
                finally:
                    prnn.lstm_scan = scan
                add(amp_counts, total)
                del model
                if recipe == "w2v_MD_VAE":
                    check(not scans, "w2v_MD_VAE --bf16 took lstm_scan")
            # the kernel run and its plain twin: one layer a TRAIN batch each
            want = 2 * set_sizes(root)["train"][1]
            report(f"  w2v_CRDNN_CTC --bf16: lstm_scan {len(scans)} calls "
                   f"(want {want}) at {sorted(set(scans))}")
            check(len(scans) == want
                  and all(s[2] == 4 * 32 and s[0] > 1 for s in scans),
                  "w2v_CRDNN_CTC --bf16 did not take lstm_scan once a step")
            out["k1_h32"] = check_k1_h32(dev, report, h32_shapes)
            out["k1_h32_shapes"] = sorted(h32_shapes)
            add(counts, run_cli_three_sets(report, probe, root,
                                           "w2v_crdnn_ctc_cnncl"))
            model, total, _ = run_cli_train(
                report, probe, "w2v_saved_phn_recog",
                recipe="MD_VAE_sfl_saved_phn_recog",
                extra=", phn_recog_outs_path: "
                      "w2v_crdnn_ctc_cnncl/saved_phn_recog_outs.pkl")
            check(len(model.saved_phn_recog_outs)
                  == sum(n for n, _ in set_sizes(root).values()),
                  "saved_phn_recog did not read the whole dump")
            del model
            add(counts, total)
            out["test_external_s"] = run_cli_external(report, root, "w2v_ext")
    finally:
        probe.close()
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    report(f"  the w2v CLI phase: {out['seconds']:.1f} s on {smi}")
    return counts, amp_counts, out


# the parallel phase: data parallelism, ZeRO-1 and the wav2vec2 trunk's
# tensor parallelism, two ranks sharing the one card over gloo, each
# against one process (mlvae_tpu_torch.tools.parallel_step)
PAR_N = 2
PAR_B, PAR_T, PAR_L = 64, 160, 8
PAR_W2V_B, PAR_W2V_SAMPLES = 2, 16000     # T = 49 trunk frames
PAR_CLI_BATCH = 5                        # does not divide the two ranks
PAR_TIME_STEPS = 2                       # timed steps a rank, the first cold
PAR_LOSS_RTOL, PAR_RTOL, PAR_ATOL = 1e-5, 1e-4, 1e-5
PAR_TRUNK_ATOL = 1e-4                    # f32, TF32 off
# under --bf16 each rank's weight gradients leave their GEMMs rounded to
# bf16 before the f32 all-reduce, where one process rounds the whole
# batch's once: gradients one bf16 ulp apart. Adam's first step moves an
# entry by lr * |g| / (|g| + eps), at most MD_VAE's lr, so entries whose
# gradient is near zero may move apart by a fraction of a step. An entry
# more than lr from one process's moved the other way by more than half a
# step: its gradient's sign flipped where the gradient was not near zero
PAR_BF16_PARAM_ATOL = 1e-3
PAR_TIMEOUT = 420
# the recipes' widths (a CPU rehearsal narrows them: the ranks are processes
# of their own, which see no monkeypatch)
PAR_MD_OVERRIDES: dict = {}
PAR_W2V_BUILD: dict = {}


def par_launch(root, name, spec):
    """``spec``'s ranks through ``tools.parallel_step`` in a process of
    their own; returns each rank's outputs."""
    import torch
    spec = dict(spec, out=str(root / name))
    path = root / f"{name}.pt"
    torch.save(spec, path)
    res = subprocess.run([sys.executable, "-m",
                          "mlvae_tpu_torch.tools.parallel_step", str(path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=PAR_TIMEOUT)
    check(res.returncode == 0, f"the {name} ranks failed:\n"
          f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    return [torch.load(root / name / f"rank{r}.pt", weights_only=False)
            for r in range(spec["world"])]


def par_param_errs(got, want):
    """(largest abs error, entries outside rtol/atol, entries) over the
    parameters both hold."""
    worst, bad, total = 0.0, 0, 0
    for key, w in want.items():
        w = torch_tensor(w)
        if not w.is_floating_point():
            continue
        d = (torch_tensor(got[key]).double() - w.double()).abs()
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
        bad += int((d > PAR_ATOL + PAR_RTOL * w.double().abs()).sum())
        total += w.numel()
    return worst, bad, total


def torch_tensor(x):
    import torch
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(x)


def par_rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def run_parallel(dev, report, smi):
    """(a) MD_VAE's VAE train step at the recipe's width, f32 then --bf16,
    on two ranks (B=32 each) against one process at B=64: losses, the
    updated parameters, exact launches a rank; the same f32 step at world
    size 1 (NCCL on the card) bit-equal to one process; (b) the same step
    under ZeRO-1, bit-equal to (a); (c) the TP=2 trunk at
    wav2vec2-large-lv60's topology against the unsplit trunk, and one
    w2v_LSTM_FC training step, on the same two ranks laid out anew; (d)
    cli.train (three debug epochs of two batches of 5) and cli.test with
    --data_parallel --num_devices 2 against one process that pads as two
    ranks do. Returns the launches of the ranks' steps (a, b) and the
    phase's numbers."""
    import shutil
    import tempfile
    import torch

    t_phase = time.perf_counter()
    on = "cuda" if dev.type == "cuda" else "cpu"
    root = Path(tempfile.mkdtemp(prefix="mlvae_par_"))
    out = {"card": smi, "ranks": PAR_N}
    total = {k: 0 for k in launches()}
    try:
        dp_runs, dp_refs = par_dp_references(dev, report)
        tp_run, tp_ref = par_tp_reference(dev)
        if on == "cuda":
            torch.cuda.empty_cache()
        out["seconds_references"] = time.perf_counter() - t_phase
        t0 = time.perf_counter()
        ranks = par_launch(root, "ranks", dict(
            world=PAR_N, device=on, probe_collectives=True,
            runs=dp_runs + [dict(tp_run, n_model=PAR_N)]))
        out["seconds_ranks"] = time.perf_counter() - t0
        out["gloo_on_cuda"] = ranks[0][-1]["collectives"]
        report(f"  gloo on CUDA tensors: {out['gloo_on_cuda']}")
        par_dp_check(report, smi, [r[:len(dp_runs)] for r in ranks], dp_refs,
                     total, out)
        par_tp_check(report, [r[len(dp_runs)] for r in ranks], tp_ref, out)
        report(f"  (a)-(c): {out['seconds_references']:.1f} s in this "
               f"process, {out['seconds_ranks']:.1f} s on the ranks")
        par_cli(dev, report, root, out)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    report(f"  the parallel phase: {out['seconds']:.1f} s; launches of the "
           f"ranks' steps {total}")
    return total, out


def par_dp_references(dev, report):
    """(a), (b): the ranks' runs, and their one-process references run
    here (the f32 step also at world size 1)."""
    import torch
    from mlvae_tpu_torch.bench_utils import build_md_vae, synth_batch
    from mlvae_tpu_torch.parallel import mesh as M
    from mlvae_tpu_torch.tools import parallel_step
    from mlvae_tpu_torch.training.brain import Stage, draw_noise

    on = dev.type
    batch = synth_batch(PAR_B, PAR_T, PAR_L, seed=0, device="cpu")
    probe = build_md_vae(batch_size=PAR_B, device=dev,
                         overrides=PAR_MD_OVERRIDES)
    probe.set_stage(Stage.TRAIN, 3)
    g = torch.Generator(device=dev).manual_seed(11)
    noise = {}
    for amp in (False, True):
        probe.auto_mix_prec = amp
        noise[amp] = {k: [x.cpu() for x in v] if isinstance(v, list)
                      else v.cpu() for k, v in draw_noise(
                          probe.draws(PAR_B, PAR_T, True), g, dev).items()}
    del probe

    def md(amp, **kw):
        return dict(kind="md_vae", device=on, batch=batch,
                    build=dict(batch_size=PAR_B, seed=0, bf16=amp,
                               overrides=PAR_MD_OVERRIDES),
                    steps=[{"epoch": 3, "noise": noise[amp]}], **kw)

    def timed(amp):
        return dict(md(amp), steps=md(amp)["steps"] * PAR_TIME_STEPS,
                    save_keys=[])

    refs = {amp: parallel_step.run(md(amp)) for amp in (False, True)}
    refs["ms"] = {amp: parallel_step.run(timed(amp))["ms"]
                  for amp in (False, True)}
    # the same code at world size 1 (NCCL on the card), in this process
    M.init_mesh(0, 1, 1, M.free_port(), on)
    try:
        solo = parallel_step.run(md(False))
    finally:
        M.destroy_mesh()
    bits = solo["steps"][0]["loss"] == refs[False]["steps"][0]["loss"] \
        and all(torch.equal(v, refs[False]["state_dict"][k])
                for k, v in solo["state_dict"].items())
    report(f"  --data_parallel at world size 1 ("
           f"{'NCCL' if on == 'cuda' else 'gloo'}): loss "
           f"{solo['steps'][0]['loss']:.7f}, loss and parameters bit-equal "
           f"to one process {bits}")
    check(bits, "--data_parallel at world size 1 is not one process's step")
    refs["world1_bit_equal"] = bits
    return [md(False), md(True), md(False, run_opts={"zero1": True}),
            timed(False), timed(True)], refs


def par_dp_check(report, smi, ranks, refs, total, out):
    """(a), (b): the ranks' runs against one process."""
    import torch
    out["world1_bit_equal"] = refs["world1_bit_equal"]
    for amp, i, label in ((False, 0, "f32"), (True, 1, "bf16")):
        rank_outs = [r[i] for r in ranks]
        ref = refs[amp]
        loss_rel = max(par_rel(r["steps"][0]["loss"],
                               ref["steps"][0]["loss"]) for r in rank_outs)
        key_rel = max(par_rel(r["steps"][0]["losses"][k], v)
                      for r in rank_outs for k, v in
                      ref["steps"][0]["losses"].items())
        worst, bad, n = par_param_errs(rank_outs[0]["state_dict"],
                                       ref["state_dict"])
        same = all(torch.equal(v, rank_outs[1]["state_dict"][k])
                   for k, v in rank_outs[0]["state_dict"].items())
        want = {k: v for k, v in recipe_launches(
            "MD_VAE", "VAE", True, amp).items() if v}
        got = [{k: v for k, v in r["launches"].items() if v}
               for r in rank_outs]
        norm_rel = max(par_rel(rank_outs[0]["grad_norms"][mk], v)
                       for mk, v in ref["grad_norms"].items() if v)
        report(f"  (a) {label}: loss {rank_outs[0]['steps'][0]['loss']:.7f}"
               f" (one process {ref['steps'][0]['loss']:.7f}), rel err "
               f"{loss_rel:.3e}, per-key {key_rel:.3e} (tol "
               f"{PAR_LOSS_RTOL:g}); parameters: max abs err {worst:.3e} "
               f"(limit {PAR_BF16_PARAM_ATOL:g} under --bf16), {bad} of {n} "
               f"outside rtol {PAR_RTOL:g} / atol {PAR_ATOL:g}; grad norms "
               f"rel err {norm_rel:.3e}; ranks bit-equal {same}; launches a "
               f"rank {got} (want {want})")
        check(loss_rel <= PAR_LOSS_RTOL and key_rel <= PAR_LOSS_RTOL,
              f"(a) {label}: the ranks' loss disagrees with one process")
        check(bad == 0 if not amp else (worst <= PAR_BF16_PARAM_ATOL
                                        and norm_rel <= AMP_GRAD_RTOL),
              f"(a) {label}: parameters max abs err {worst:.3e}, {bad} "
              f"outside tolerance, grad norms {norm_rel:.3e}")
        check(same, f"(a) {label}: the ranks' parameters differ")
        check(all(c == want for c in got),
              f"(a) {label}: launches a rank {got} != {want}")
        for r in rank_outs:
            for k in total:
                total[k] += r["launches"][k]
        out[f"dp_{label}"] = {
            "loss_rel_err": loss_rel, "param_max_abs_err": worst,
            "params_outside_tol": bad, "params": n,
            "grad_norm_rel_err": norm_rel,
            "rank_step_ms": [r[3 + i]["ms"] for r in ranks],
            "one_process_step_ms": refs["ms"][amp],
            "launches_a_rank": got[0]}
        report(f"  {label} step ms (first cold), rank 0 "
               f"{[round(x, 2) for x in ranks[0][3 + i]['ms']]}, rank 1 "
               f"{[round(x, 2) for x in ranks[1][3 + i]['ms']]}; one "
               f"process at B={PAR_B}: "
               f"{[round(x, 2) for x in refs['ms'][amp]]} ({smi})")
    rep, z1 = ranks[0][0], ranks[0][2]
    bits = all(torch.equal(v, z1["state_dict"][k])
               for k, v in rep["state_dict"].items()) and all(
        torch.equal(v, z1["moments"][k]) for k, v in rep["moments"].items())
    report(f"  (b) ZeRO-1: parameters and moments bit-equal to (a) "
           f"{bits}; moments held a rank "
           f"{z1['moment_shard_fraction']:.4f} of the whole")
    check(bits, "(b) ZeRO-1 is not bit-equal to replicated DP")
    check(abs(z1["moment_shard_fraction"] - 1 / PAR_N) < 1e-3,
          "(b) ZeRO-1 does not split the moments")
    for r in ranks:
        for k in total:
            total[k] += r[2]["launches"][k]
    out["zero1_bit_equal"] = bits


def par_tp_reference(dev):
    """(c): the ranks' run (the trunk's forward, then a w2v_LSTM_FC step)
    and its one-process reference run here."""
    import torch
    from mlvae_tpu_torch.bench_utils import (build_w2v_lstm_fc,
                                             synth_w2v_fc_batch)
    from mlvae_tpu_torch.tools import parallel_step
    from mlvae_tpu_torch.training.brain import draw_noise

    g = torch.Generator(device=dev).manual_seed(12)
    wbatch = synth_w2v_fc_batch(PAR_W2V_B, PAR_W2V_SAMPLES, seed=0,
                                device="cpu")
    wprobe = build_w2v_lstm_fc(device=dev, **PAR_W2V_BUILD)
    wnoise = {k: [x.cpu() for x in v] if isinstance(v, list) else
              v.cpu() for k, v in draw_noise(
                  wprobe.step_draws({k: tuple(x.to(dev) for x in v)
                                     for k, v in wbatch.items()}, True),
                  g, dev).items()}
    del wprobe
    keep = ["classifier.", "wav2vec2.layers.0.", "wav2vec2.layers.23."]
    wspec = dict(kind="w2v_lstm_fc", device=dev.type, batch=wbatch,
                 build=PAR_W2V_BUILD, save_keys=keep,
                 steps=[{"epoch": 1, "trunk": True},
                        {"epoch": 1, "noise": wnoise}])
    return wspec, parallel_step.run(wspec)


def par_tp_check(report, wranks, wone, out):
    """(c): the split trunk and its step against one process."""
    trunk = wone["steps"][0]["preds"]["trunk"]
    t_err = max(float((r["steps"][0]["preds"]["trunk"] - trunk).abs().max())
                for r in wranks)
    w_rel = max(par_rel(r["steps"][1]["loss"], wone["steps"][1]["loss"])
                for r in wranks)
    w_worst, w_bad, w_n = par_param_errs(wranks[0]["state_dict"],
                                         wone["state_dict"])
    report(f"  (c) TP=2 trunk (24 layers, d=1024, 16 heads, FFN 4096, "
           f"B={PAR_W2V_B}, T={trunk.shape[1]}): max abs err "
           f"{t_err:.3e} (tol {PAR_TRUNK_ATOL:g}); w2v_LSTM_FC step "
           f"loss {wranks[0]['steps'][1]['loss']:.7f} (one process "
           f"{wone['steps'][1]['loss']:.7f}, rel err {w_rel:.3e}); "
           f"classifier, first and last layer after it: max abs err "
           f"{w_worst:.3e}, {w_bad} of {w_n} outside rtol {PAR_RTOL:g} "
           f"/ atol {PAR_ATOL:g}; step ms rank 0 "
           f"{round(wranks[0]['ms'][1], 2)}, rank 1 "
           f"{round(wranks[1]['ms'][1], 2)}, one process "
           f"{round(wone['ms'][1], 2)}")
    check(t_err <= PAR_TRUNK_ATOL, "(c) the split trunk disagrees")
    check(w_rel <= PAR_LOSS_RTOL and w_bad == 0,
          "(c) the TP training step disagrees with one process")
    out["tp"] = {"trunk_max_abs_err": t_err, "loss_rel_err": w_rel,
                 "param_max_abs_err": w_worst,
                 "rank_step_ms": [r["ms"] for r in wranks],
                 "one_process_step_ms": wone["ms"]}


def par_cli_outputs(run_dir):
    """A CLI run's scalars by (tag, epoch), its checkpoint's meta and
    parameters, and its TEST metrics' text."""
    import numpy as np
    scalars = {}
    for line in (run_dir / "scalars.jsonl").read_text().splitlines():
        rec = json.loads(line)
        scalars[(rec["tag"], rec["step"])] = rec["value"]
    (ckpt,) = (run_dir / "checkpoints").iterdir()
    with np.load(ckpt / "params.npz") as f:
        params = dict(f)
    return (scalars, json.loads((ckpt / "meta.json").read_text()), params,
            (run_dir / "test_output" / "test_metrics.txt").read_text())


def par_cli(dev, report, root, out):
    """(d): cli.train -> cli.test on two ranks (started from this process
    by the entry points), against one process that pads its batches of 5
    as two ranks do, in the same working directory (one corpus and feature
    pass)."""
    import os
    from mlvae_tpu_torch.cli import test as test_cli
    from mlvae_tpu_torch.cli import train as train_cli
    from mlvae_tpu_torch.tools import parallel_step

    t0 = time.perf_counter()
    cli_dir = root / "cli"
    cli_dir.mkdir()
    tail = ["--batch_size", str(PAR_CLI_BATCH)] + (
        ["--device", "cpu"] if dev.type == "cpu" else [])   # a rehearsal
    dp = ["--data_parallel", "True", "--num_devices", str(PAR_N)]
    cwd = os.getcwd()
    try:
        os.chdir(cli_dir)
        with parallel_step.padded_as_ranks(PAR_N):
            train_cli.main(cli_args("one") + tail)
            test_cli.main(cli_args("one") + tail)
        t_one = time.perf_counter() - t0
        train_cli.main(cli_args("dp") + tail + dp)
        test_cli.main(cli_args("dp") + tail + dp)
    finally:
        os.chdir(cwd)
    got, want = (par_cli_outputs(cli_dir / "results" / name)
                 for name in ("dp", "one"))
    loss_rel = max((par_rel(got[0][k], v) for k, v in want[0].items()
                    if "loss" in k[0] and k in got[0]), default=0.0)
    scores_equal = sorted(got[0]) == sorted(want[0]) and all(
        got[0][k] == v for k, v in want[0].items() if "loss" not in k[0])
    worst, bad, n = par_param_errs(got[2], want[2])
    report(f"  (d) cli.train / cli.test on two ranks, batches of "
           f"{PAR_CLI_BATCH} (padded to 6), against one process padding "
           f"alike ({t_one:.1f} s): {len(want[0])} scalars, losses rel err "
           f"{loss_rel:.3e} (tol {PAR_LOSS_RTOL:g}), scores equal "
           f"{scores_equal}; checkpoint epoch {got[1]['epoch']} "
           f"({want[1]['epoch']}), parameters max abs err {worst:.3e}, "
           f"{bad} of {n} outside rtol {PAR_RTOL:g} / atol {PAR_ATOL:g}; "
           f"TEST metrics equal {got[3] == want[3]} "
           f"({'plvl_md.F1' in got[3]})")
    check(loss_rel <= PAR_LOSS_RTOL and scores_equal,
          "(d) the two ranks' TRAIN / VALID scalars disagree")
    check(got[1]["epoch"] == want[1]["epoch"] and bad == 0,
          "(d) the two ranks' checkpoint disagrees with one process's")
    check(got[3] == want[3] and "plvl_md.F1" in got[3],
          "(d) the two ranks' TEST metrics disagree")
    out["cli"] = {"loss_rel_err": loss_rel, "param_max_abs_err": worst,
                  "params_outside_tol": bad, "one_process_s": t_one}
    out["seconds_cli"] = time.perf_counter() - t0
    report(f"  (d): {out['seconds_cli']:.1f} s")


# the run options phase: MD_VAE through cli.train / cli.test with the four
# options on and off, on a synthesized corpus of 8 speakers x 24
# utterances of 2 to 7 digits (96 TRAIN utterances: twelve batches of 8 in
# three padded shapes, VALID's six in three, so that each epoch captures a
# step graph for each shape and replays it), one target cycle (the recipe
# checkpoints on its VAE epoch only)
RUNOPT_ON = ("--scan_epoch", "True", "--scan_chunk", "2", "--async_ckpt",
             "True", "--cache_device_batches", "True", "--profile", "True")
RUNOPT_OFF = ("--scan_epoch", "False", "--async_ckpt", "False",
              "--cache_device_batches", "False", "--profile", "False")
RUNOPT_CORPUS = (8, 24, (2, 7))   # speakers, utterances a speaker, digits
RUNOPT_RTOL = 1e-6        # a library GEMM that rounds otherwise in a graph
# the kernels whose launches the profiler counts in the graph run
RUNOPT_KERNELS = ("lstm_fwd", "lstm_bwd", "md_viterbi", "lstm_fused_fwd",
                  "lstm_fused_bwd", "lstm_semi_bwd")
W2V_CACHE_EPOCHS = 2      # the frozen-trunk cache: epoch 1 fills it
# the fine-tuned trunk's scanned run (its graphs' memory): w2v_LSTM_FC,
# two epochs on the same corpus (its waves padded to 0.5 s buckets)
W2V_SCAN_RECIPE, W2V_SCAN_EPOCHS = "w2v_LSTM_FC", 2
REMAT_B, REMAT_SAMPLES = 8, 64000   # the fine-tuned trunk: 4 s of audio
REMAT_ITERS, REMAT_ROUNDS = 5, 2    # timed steps a turn, turns each way


def runopt_args(name, opts, amp=False, recipe="MD_VAE", debug=False,
                epochs=None, dev=None):
    """``cli_args`` with the run options ``opts`` (and without
    ``--debug``: the scanned epoch is off under it)."""
    args = cli_args(name, bf16=amp, recipe=recipe,
                    corpus={"epochs": epochs} if epochs else None)
    if not debug:
        i = args.index("--debug")
        del args[i:i + 3]
    args += list(opts)
    return args + (["--device", "cpu"] if dev is not None
                   and dev.type == "cpu" else [])


def kernel_counts(names):
    """Kernel launches by the port's kernel names, from the profiler's
    kernel records' names (CUPTI's: eager launches and the kernels of
    replayed graphs alike)."""
    import re
    out = {}
    for full in names:
        m = re.search(r"(\w+)_kernel\b", full)
        if not m:
            continue
        name = m.group(1)
        if name == "lstm_fused_bwd" and "<true>" in full:
            name = "lstm_semi_bwd"      # K4-bwd: the SEMI instance
        out[name] = out.get(name, 0) + 1
    return out


def trace_launches(path):
    """``kernel_counts`` of a Chrome trace that ``--profile`` wrote."""
    return kernel_counts(ev.get("name", "") for ev in json.loads(
        Path(path).read_text())["traceEvents"] if ev.get("cat") == "kernel")


# the profiler drops a kernel record whose start, or end, falls outside
# its window by the host clock; the card's timestamps are mapped onto that
# clock with some error, so a stage's window opens this long before its
# first launch and closes this long after its last kernel ends
PROFILE_MARGIN_S = 0.01


def stage_profiler():
    """A ``torch.profiler`` window over the card's activity."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def profiled_counts(prof):
    """``kernel_counts`` of a closed ``stage_profiler`` window: of its
    events, and of its Chrome trace."""
    import os
    import tempfile
    import torch
    events = kernel_counts(e.name for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return events, trace_launches(path)
    finally:
        os.remove(path)


@contextlib.contextmanager
def graph_launch_tally(probe):
    """Inside, each step graph's kernel calls at its capture (what each of
    its replays launches) are tallied by kernel, and each replay adds its
    graph's tally to the probe's current stage (``"replayed"``)."""
    import torch
    from mlvae_tpu_torch import _build
    from mlvae_tpu_torch.training.step_graphs import StepGraph
    captured = {}
    saved = (_build.Kernel.__call__, StepGraph.__init__, StepGraph.__call__)
    call, init, replay = saved

    def kernel_call(self, *args):
        call(self, *args)
        if torch.cuda.is_current_stream_capturing():
            captured[self.name] = captured.get(self.name, 0) + 1

    def graph_init(self, *args, **kwargs):
        captured.clear()
        init(self, *args, **kwargs)
        self.tally = dict(captured)

    def graph_call(self, *args):
        out = replay(self, *args)
        rec = probe.stages[probe._key].setdefault("replayed", {})
        for k, v in self.tally.items():
            rec[k] = rec.get(k, 0) + v
        return out
    _build.Kernel.__call__ = kernel_call
    StepGraph.__init__, StepGraph.__call__ = graph_init, graph_call
    try:
        yield
    finally:
        _build.Kernel.__call__ = saved[0]
        StepGraph.__init__, StepGraph.__call__ = saved[1:]


@contextlib.contextmanager
def peak_memory(dev):
    """Inside, the card's allocations from a reset peak: the yielded dict
    gets the bytes held at the start (``base_gib``) and the peaks of
    ``torch.cuda.max_memory_allocated`` and ``max_memory_reserved`` (a
    graph's memory pool counts in both), in GiB; empty off the card."""
    import gc
    import torch
    out = {}
    if dev.type != "cuda":
        yield out
        return
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    out["base_gib"] = torch.cuda.memory_allocated(dev) / 2 ** 30
    yield out
    torch.cuda.synchronize()
    out["allocated_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    out["reserved_gib"] = torch.cuda.max_memory_reserved(dev) / 2 ** 30


def gib(peak) -> str:
    return ", ".join(f"{k} {v:.3f}" for k, v in peak.items()) or "-"


def rel_diff(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def ckpt_arrays(run_dir):
    """The newest checkpoint's arrays by (file, key)."""
    import numpy as np
    from mlvae_tpu_torch.training.checkpointer import Checkpointer
    ckpt = Checkpointer(run_dir / "checkpoints").find_checkpoint()
    out = {}
    for f in sorted(ckpt.path.glob("*.npz")):
        with np.load(f) as data:
            out.update({(f.name, k): data[k] for k in data.files})
    return ckpt.meta, out


def array_errs(got, want):
    """(largest relative error in norm, arrays not bit-equal)."""
    import numpy as np
    worst, unequal = 0.0, 0
    for key, w in want.items():
        g = got[key]
        if w.dtype.kind == "V":
            g, w = g.view(np.int16), w.view(np.int16)
        if not np.array_equal(g, w):
            unequal += 1
            w64, g64 = w.astype(np.float64), g.astype(np.float64)
            worst = max(worst, float(np.linalg.norm(g64 - w64) / max(
                np.linalg.norm(w64), 1e-30)))
    return worst, unequal


def run_md_vae_options(report, probe, root, amp, dev):
    """MD_VAE's ``cli.train`` then ``cli.test`` once with the four options
    off and once on, from one seed: epoch losses, the final checkpoint's
    arrays, TEST's decodes, statistics files and saved MD results held one
    against the other, and every VALID batch's predictions; the graphs'
    captures and replays; every stage's kernel launches in the graph run
    (its eager steps' wrapper counts plus, for each replay, the kernels
    its graph recorded at capture) against the same stage of the eager
    run by the wrappers, exact; the graph run's launches by the profiler
    (epoch 1's TRAIN from the ``--profile`` trace, every other stage from
    the probe's windows, by their events and by their Chrome traces),
    epoch 1's TRAIN and TEST exact, the others reported with what the
    profiler's records lack; each run's peak memory; each epoch's wall
    time both ways. Returns (the numbers, the eager run's wrapper counts,
    the graph run's launches by replays and eager steps, and by the
    profiler)."""
    import torch
    from mlvae_tpu_torch.cli import test as test_cli
    from mlvae_tpu_torch.cli import train as train_cli

    label = "--bf16 " if amp else "f32 "
    cuda = dev.type == "cuda"
    runs = {}
    for on in (False, True):
        name = f"ro_{'bf16' if amp else 'f32'}_{'on' if on else 'off'}"
        # the graph run's stages in profiler windows, but epoch 1's TRAIN,
        # which its own --profile traces
        probe.reset()
        probe.profile_stages = {("TRAIN", 1)} if on and cuda else None
        probe.valid_preds = []
        reset_launches()
        opts = RUNOPT_ON if on else RUNOPT_OFF
        try:
            with graph_launch_tally(probe):
                with peak_memory(dev) as peak:
                    model = train_cli.main(runopt_args(name, opts, amp,
                                                       dev=dev))
                rec = {"name": name, "epochs": model.epoch_log,
                       "fit": dict(model.scan_stats), "peak": peak,
                       "valid_preds": probe.valid_preds}
                check(model.checkpointer._worker is None,
                      "the checkpointer's worker outlived fit")
                del model
                stages = dict(probe.stages)
                probe.reset()
                model = test_cli.main(runopt_args(name, opts, amp,
                                                  dev=dev))
                torch.cuda.synchronize()
        finally:
            probe.profile_stages, probe.valid_preds = None, None
        stages.update(probe.stages)
        (test_key,) = [k for k in probe.stages if k[0] == "TEST"]
        rec.update(stages=stages, test=dict(model.scan_stats),
                   decodes=list(probe.decodes),
                   evaluate=model.evaluate_timing,
                   test_loss=stages[test_key]["loss"], launches=launches())
        del model
        runs[on] = rec
    off, on = runs[False], runs[True]
    run_off, run_on = (Path(root) / "results" / r["name"] for r in (off,
                                                                     on))
    # the losses of every epoch's TRAIN and VALID stage
    loss_err, same = 0.0, True
    for a, b in zip(on["epochs"], off["epochs"]):
        for key in ("loss", "valid_loss"):
            loss_err = max(loss_err, rel_diff(a[key], b[key]))
            same &= a[key] == b[key]
    # the final checkpoints, TEST's decodes, statistics and saved results
    meta_on, arr_on = ckpt_arrays(run_on)
    meta_off, arr_off = ckpt_arrays(run_off)
    ckpt_err, ckpt_unequal = array_errs(arr_on, arr_off)
    same_decode = len(on["decodes"]) == len(off["decodes"]) > 0 and all(
        ids == pids and all(torch.equal(p[k], pp[k]) for k in p)
        for (ids, p), (pids, pp) in zip(on["decodes"], off["decodes"]))
    files = sorted(f.name for f in (run_off / "test_output").iterdir())
    same_files = files == sorted(f.name for f in (run_on / "test_output")
                                 .iterdir()) and all(
        (run_on / "test_output" / f).read_text()
        == (run_off / "test_output" / f).read_text() for f in files)
    saved = Path(root) / "datasets/SynAudioMNIST/saved_md_results"
    same_saved = json.loads((saved / f"{on['name']}.json").read_text()) \
        == json.loads((saved / f"{off['name']}.json").read_text())
    test_err = rel_diff(on["test_loss"], off["test_loss"])
    same_valid = len(on["valid_preds"]) == len(off["valid_preds"]) > 0 \
        and all(ka == kb and ia == ib and sorted(pa) == sorted(pb)
                and all(torch.equal(pa[k], pb[k]) for k in pa)
                for (ka, ia, pa), (kb, ib, pb) in zip(on["valid_preds"],
                                                      off["valid_preds"]))
    # every stage of the graph run against the same stage of the eager run
    eager = {key: rec["launches"] for key, rec in off["stages"].items()}
    graphs = {key: {k: rec["launches"].get(k, 0)
                    + rec.get("replayed", {}).get(k, 0)
                    for k in rec["launches"]}
              for key, rec in on["stages"].items()}
    trace1 = trace_launches(run_on / "profile" / "trace.json")
    prof = {key: (trace1 if key == ("TRAIN", 1) else rec.get("profiled", {}))
            for key, rec in on["stages"].items()}
    prof_trace = {key: (trace1 if key == ("TRAIN", 1)
                        else rec.get("profiled_trace", {}))
                  for key, rec in on["stages"].items()}
    kernels = sorted({k for k in RUNOPT_KERNELS
                      for d in (*graphs.values(), *eager.values())
                      if d.get(k, 0)})

    def total(by_stage):
        return {k: sum(d.get(k, 0) for d in by_stage.values())
                for k in kernels}

    def equal(a, keys):
        return all(a[key].get(k, 0) == eager[key].get(k, 0)
                   for key in keys for k in kernels)
    graphs_equal = graphs.keys() == eager.keys() and equal(graphs, eager)
    exact = [key for key in eager if key == ("TRAIN", 1)
             or key[0] == "TEST"]
    prof_exact = not cuda or (prof.keys() == eager.keys()
                              and equal(prof, exact))
    lacking = {f"{s}{e}": {k: graphs[(s, e)].get(k, 0) - d.get(k, 0)
                           for k in kernels
                           if graphs[(s, e)].get(k, 0) != d.get(k, 0)}
               for (s, e), d in prof.items()}
    lacking = {key: d for key, d in lacking.items() if d}
    prof_total, graphs_total = total(prof), total(graphs)
    stage_list = " ".join(f"{s}{e}" for s, e in eager)
    steps = (run_on / "step_times.jsonl").read_text().splitlines()
    walls = {w: [round(e["seconds"], 3) for e in r["epochs"]]
             for w, r in (("off", off), ("on", on))}
    report(f"  {label}MD_VAE, {len(on['epochs'])} epochs of "
           f"{on['epochs'][0]['batches']} batches: TRAIN / VALID losses rel "
           f"err {loss_err:.3e} (tol {RUNOPT_RTOL:g}; equal {same}); final "
           f"checkpoint (epoch {meta_on['epoch']}) {len(arr_on)} arrays, "
           f"{ckpt_unequal} not bit-equal, rel err {ckpt_err:.3e}; TEST "
           f"decodes equal {same_decode}, statistics files equal "
           f"{same_files} ({len(files)}), saved MD results equal "
           f"{same_saved}, loss rel err {test_err:.3e}")
    report(f"  {label}graphs: fit {on['fit']}, cli.test {on['test']}; "
           f"VALID predictions equal {same_valid} "
           f"({len(on['valid_preds'])} batches); launches of the stages "
           f"{stage_list}: the eager run's by the wrappers "
           f"{total(eager)}; the graph run's (eager steps by the "
           f"wrappers, {  {k: on['launches'][k] for k in kernels} }, and "
           f"replays by their graphs' captured kernels) {graphs_total}, "
           f"stage by stage equal {graphs_equal}; by the profiler, events "
           f"{prof_total}, traces {total(prof_trace)}, TRAIN1 and TEST "
           f"equal {prof_exact}, records lacking {lacking or 'none'}; "
           f"peak memory of "
           f"cli.train GiB off ({gib(off['peak'])}), on ({gib(on['peak'])});"
           f" step_times.jsonl {len(steps)} lines; epoch wall s off "
           f"{walls['off']}, on {walls['on']} (on: under the profiler); "
           f"evaluate eval s off {off['evaluate']['eval']:.3f}, on "
           f"{on['evaluate']['eval']:.3f}")
    check(loss_err <= RUNOPT_RTOL, f"{label}the options change the losses")
    check(ckpt_err <= RUNOPT_RTOL and meta_on["epoch"] == meta_off["epoch"],
          f"{label}the options change the checkpoint")
    check(same_decode and same_files and same_saved
          and test_err <= RUNOPT_RTOL, f"{label}the options change TEST")
    check(same_valid, f"{label}the options change VALID's predictions")
    check(graphs_equal and (kernels or not cuda),
          f"{label}graph launches {graphs} != eager {eager}")
    check(prof_exact, f"{label}profiled launches {prof} != eager {eager}")
    check(not cuda or (on["fit"]["captures"] > 0 and on["fit"]["replays"]
                       > 0 and on["test"]["replays"] > 0),
          f"{label}no step graph was replayed")
    check(len(steps) == len(on["epochs"]), "step_times.jsonl lines")
    return {"loss_rel_err": loss_err, "losses_equal": same,
            "ckpt_rel_err": ckpt_err, "ckpt_arrays_unequal": ckpt_unequal,
            "test_equal": same_decode and same_files and same_saved,
            "graphs_fit": on["fit"], "graphs_test": on["test"],
            "launches_graphs": {f"{s} {e}": {k: d.get(k, 0)
                                             for k in kernels}
                                for (s, e), d in graphs.items()},
            "launches_profiler_graphs": {f"{s} {e}": d for (s, e), d
                                         in prof.items()},
            "launches_profiler_traces": {f"{s} {e}": d for (s, e), d
                                         in prof_trace.items()},
            "profiler_records_lacking": lacking,
            "valid_predictions_equal": same_valid,
            "launches_wrappers_eager": {f"{s} {e}": {
                k: d.get(k, 0) for k in kernels} for (s, e), d
                in eager.items()},
            "peak_gib": {"off": off["peak"], "on": on["peak"]},
            "epoch_wall_s": walls,
            "evaluate_eval_s": {"off": off["evaluate"]["eval"],
                                "on": on["evaluate"]["eval"]}}, \
        off["launches"], graphs_total, prof_total


def run_w2v_cache(report, probe, amp, dev):
    """w2v_MD_VAE (the frozen lv60 trunk) through ``cli.train``, two debug
    epochs, with the frozen-trunk cache and with
    ``MLVAE_W2V_FROZEN_CACHE=0``: the trunk's forwards by stage, the
    cached features against the step's (the first batch's), the epoch
    losses (VALID under ``--bf16`` reads the cached bf16 features, as the
    JAX package's does)."""
    import os
    import torch
    from mlvae_tpu_torch.cli import train as train_cli
    from mlvae_tpu_torch.modules.wav2vec2 import Wav2Vec2Encoder

    label = "--bf16 " if amp else "f32 "
    runs = {}
    for cached in (True, False):
        calls, outs = {}, []

        def hook(mod, args, out):
            if isinstance(mod, Wav2Vec2Encoder):
                key = " ".join(map(str, probe._key))
                calls[key] = calls.get(key, 0) + 1
                if not outs:
                    outs.append(out.detach().clone())
        handle = torch.nn.modules.module.register_module_forward_hook(hook)
        os.environ["MLVAE_W2V_FROZEN_CACHE"] = "1" if cached else "0"
        try:
            with checkpoint_writes(False):
                model = train_cli.main(runopt_args(
                    f"w2v_cache_{int(cached)}{'_bf16' if amp else ''}",
                    (), amp, recipe="w2v_MD_VAE", debug=True,
                    epochs=W2V_CACHE_EPOCHS, dev=dev))
        finally:
            handle.remove()
            os.environ.pop("MLVAE_W2V_FROZEN_CACHE")
        runs[cached] = (calls, outs[0], model.epoch_log,
                        len(model._dev_batch_cache))
        del model
    (c_on, f_on, e_on, n_cached), (c_off, f_off, e_off, _) = runs[True], \
        runs[False]
    train_equal = all(a["loss"] == b["loss"] for a, b in zip(e_on, e_off))
    valid_err = max(rel_diff(a["valid_loss"], b["valid_loss"])
                    for a, b in zip(e_on, e_off))
    same_feats = f_on.dtype == f_off.dtype and torch.equal(f_on, f_off)
    first_only = set(c_on) <= {"TRAIN 1", "VALID 1"} and \
        sum(c_off.values()) > sum(c_on.values())
    report(f"  {label}w2v_MD_VAE frozen-trunk cache: trunk forwards with "
           f"the cache {c_on} ({n_cached} batches cached), without "
           f"{c_off}; cached features bit-equal to the step's {same_feats}"
           f" ({f_on.dtype}); TRAIN losses equal {train_equal}; VALID "
           f"losses rel err {valid_err:.3e}")
    check(first_only and same_feats and train_equal,
          f"{label}the frozen-trunk cache disagrees")
    check(amp or valid_err == 0.0, "f32 VALID losses differ with the cache")
    return {"trunk_calls_cached": c_on, "trunk_calls_uncached": c_off,
            "features_equal": same_feats, "train_losses_equal": train_equal,
            "valid_rel_err": valid_err}


def run_remat(dev, report, smi, B=REMAT_B, samples=REMAT_SAMPLES,
              build=None, iters=REMAT_ITERS, rounds=REMAT_ROUNDS):
    """The fine-tuned lv60 trunk (w2v_MD_VAE_sfl_resi's topology, here
    w2v_LSTM_FC's step) at B=8 with 4 s of audio, one step from one state
    with the same draws with the per-layer recompute on and off (in
    deterministic mode): the bytes held before the step, the peak of the
    forward and backward (up to ``_update``), the bytes held when
    ``_update`` starts and the update's own peak; then step ms in turns
    (default mode, ``iters`` steps after warm-up, ``rounds`` turns each
    way), and the gradients one against the other."""
    import os
    import torch
    from mlvae_tpu_torch.bench_utils import (build_w2v_lstm_fc,
                                             synth_w2v_fc_batch)
    from mlvae_tpu_torch.training.brain import Stage, draw_noise

    cuda = dev.type == "cuda"
    model = (build or build_w2v_lstm_fc)(device=dev)
    batch = synth_w2v_fc_batch(batch_size=B, samples=samples, device=dev)
    model.train()
    model.set_stage(Stage.TRAIN, 1)
    g = torch.Generator(device=dev).manual_seed(1)
    noise = draw_noise(model.step_draws(batch, True), g, dev)
    snap = snapshot(model)
    out, grads = {"B": B, "samples": samples, "card": smi}, {}
    update = model._update

    def split_update(phases):
        def fn(*args):
            if cuda:
                torch.cuda.synchronize()
                phases["fwd_bwd_peak"] = torch.cuda.max_memory_allocated(dev)
                phases["at_update"] = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            update(*args)
            if cuda:
                torch.cuda.synchronize()
                phases["update_peak"] = torch.cuda.max_memory_allocated(dev)
        return fn

    def step():
        model.train_step(batch, 1, noise=noise)
    saved_env = os.environ.get("MLVAE_W2V_REMAT")
    try:
        for remat in ("1", "0"):
            os.environ["MLVAE_W2V_REMAT"] = remat
            restore(model, snap)
            for p in model.parameters():
                p.grad = None
            phases = {}
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
                phases["before"] = torch.cuda.memory_allocated(dev)
            # cuDNN's and torch's deterministic algorithms: the two steps
            # differ by the recompute alone
            model._update = split_update(phases)
            try:
                with deterministic():
                    step()
                    torch.cuda.synchronize()
            finally:
                del model._update
            # on the host: the next run's memory starts where this one's
            # did
            grads[remat] = {n: p.grad.cpu() for n, p in
                            model.named_parameters() if p.grad is not None}
            for p in model.parameters():
                p.grad = None
            out[f"remat_{remat}"] = {f"{k}_gib": v / 2 ** 30
                                     for k, v in phases.items()}
        for _ in range(rounds):
            for remat in ("1", "0"):
                os.environ["MLVAE_W2V_REMAT"] = remat
                out[f"remat_{remat}"].setdefault("step_ms", []).append(
                    cuda_ms(step, iters))
    finally:
        if saved_env is None:
            os.environ.pop("MLVAE_W2V_REMAT", None)
        else:
            os.environ["MLVAE_W2V_REMAT"] = saved_env
    errs = [float((grads["1"][n].double() - grads["0"][n].double()).norm()
                  / max(float(grads["0"][n].double().norm()), 1e-30))
            for n in grads["0"]]
    out["grad_rel_err"] = max(errs)
    out["grads_bit_equal"] = all(torch.equal(grads["1"][n], grads["0"][n])
                                 for n in grads["0"])

    def line(r):
        return ", ".join(f"{k[:-4]} {v:.3f} GiB" for k, v in r.items()
                         if k.endswith("_gib")) + ", step ms " + ", ".join(
            f"{v:.3f}" for v in r["step_ms"])
    report(f"  the fine-tuned lv60 trunk (B={B}, {samples} samples): "
           f"recompute on: {line(out['remat_1'])}; off: "
           f"{line(out['remat_0'])} ({iters} steps a turn after 2 of "
           f"warm-up, turns on, off x {rounds}); gradients ({len(errs)}) "
           f"max rel err {out['grad_rel_err']:.3e}, bit-equal "
           f"{out['grads_bit_equal']} on {smi}")
    check(set(grads["1"]) == set(grads["0"]) and len(errs) > 0
          and out["grad_rel_err"] <= RUNOPT_RTOL,
          "the recompute changes the gradients")
    return out


def run_w2v_scan(report, probe, dev):
    """The fine-tuned trunk's scanned run: ``W2V_SCAN_RECIPE`` through
    ``cli.train``, ``W2V_SCAN_EPOCHS`` epochs on the run options' corpus
    (several padded wave lengths an epoch), with ``--scan_epoch`` (step
    graphs on the card) and without, in deterministic mode, its
    checkpoints unwritten: the graphs' captures and replays, each run's
    peak memory, the epoch losses (within ``W2V_VALID_RTOL``: the
    fine-tuned trunk's Adam first steps move every weight whose gradient's
    sign is rounding noise) and walls."""
    from mlvae_tpu_torch.cli import train as train_cli

    runs = {}
    for scan in (False, True):
        opts = ("--scan_epoch", str(scan), "--scan_chunk", "2")
        probe.reset()
        with deterministic(), checkpoint_writes(False), \
                peak_memory(dev) as peak:
            model = train_cli.main(runopt_args(
                f"w2v_scan_{int(scan)}", opts, recipe=W2V_SCAN_RECIPE,
                epochs=W2V_SCAN_EPOCHS, dev=dev))
        runs[scan] = {"epochs": model.epoch_log,
                      "graphs": dict(model.scan_stats), "peak": peak,
                      "fine_tuned": not model.wav2vec2.freeze}
        del model
    off, on = runs[False], runs[True]
    err = max(rel_diff(a[k], b[k]) for a, b in zip(on["epochs"],
                                                   off["epochs"])
              for k in ("loss", "valid_loss"))
    same = all(a[k] == b[k] for a, b in zip(on["epochs"], off["epochs"])
               for k in ("loss", "valid_loss"))
    walls = {w: [round(e["seconds"], 3) for e in r["epochs"]]
             for w, r in (("off", off), ("on", on))}
    report(f"  {W2V_SCAN_RECIPE} (the lv60 trunk fine-tuned), "
           f"{len(on['epochs'])} epochs of {on['epochs'][0]['batches']} "
           f"batches, --scan_epoch on: graphs {on['graphs']}; peak memory "
           f"of cli.train GiB off ({gib(off['peak'])}), on "
           f"({gib(on['peak'])}); TRAIN / VALID losses rel err {err:.3e} "
           f"(tol {W2V_VALID_RTOL:g}; equal {same}); epoch wall s off "
           f"{walls['off']}, on {walls['on']}")
    check(on["fine_tuned"] and err <= W2V_VALID_RTOL,
          f"{W2V_SCAN_RECIPE}: the scanned run disagrees")
    check(dev.type != "cuda" or (on["graphs"]["captures"] > 0
                                 and on["graphs"]["replays"] > 0),
          f"{W2V_SCAN_RECIPE}: no step graph was replayed")
    return {"graphs": on["graphs"], "peak_gib": {"off": off["peak"],
                                                 "on": on["peak"]},
            "loss_rel_err": err, "losses_equal": same, "epoch_wall_s": walls}


def run_world1_scan(report, root, dev):
    """``cli.train`` / ``cli.test`` with ``--scan_epoch`` on one rank of a
    mesh (``--data_parallel True --num_devices 1``: NCCL on the card, a
    world of one whose collectives return their input) against the
    one-process run with the options on: scalars and TEST metrics."""
    from mlvae_tpu_torch.cli import test as test_cli
    from mlvae_tpu_torch.cli import train as train_cli
    args = runopt_args("ro_rank", RUNOPT_ON, dev=dev) + [
        "--data_parallel", "True", "--num_devices", "1"]
    t0 = time.perf_counter()
    train_cli.main(args)
    test_cli.main(args)
    got, want = (par_cli_outputs(Path(root) / "results" / n)
                 for n in ("ro_rank", "ro_f32_on"))
    same = got[0] == want[0] and got[3] == want[3]
    worst, bad, n = par_param_errs(got[2], want[2])
    report(f"  one NCCL rank with --scan_epoch against one process: "
           f"{len(want[0])} scalars and TEST metrics equal {same}; "
           f"parameters max abs err {worst:.3e} ({bad} of {n} outside "
           f"tolerance); {time.perf_counter() - t0:.1f} s")
    check(same and bad == 0, "the world-of-one rank disagrees")
    return {"equal": same, "param_max_abs_err": worst}


def run_options(dev, report, smi):
    """The run options phase (``--scan_epoch``, ``--async_ckpt``,
    ``--cache_device_batches``, ``--profile``): MD_VAE's CLI path with
    them and without, f32 and ``--bf16``; the w2v frozen-trunk cache; the
    trunk's per-layer recompute; one rank's scanned run; the fine-tuned
    trunk's scanned run. Returns the wrapper counts of its eager MD_VAE
    runs (options off), its graph runs' launches (eager steps and
    replays) and their profiler counts, and the numbers."""
    import logging
    import os
    import shutil
    import tempfile
    from mlvae_tpu_torch.data.synth import generate_corpus

    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    t0 = time.perf_counter()
    cwd = os.getcwd()
    root = Path(tempfile.mkdtemp(prefix="mlvae_runopt_"))
    probe = CliProbe()
    out = {"card": smi}
    counts, graph_counts, prof_counts = {}, {}, {}
    try:
        os.chdir(root)
        generate_corpus(root / "datasets/SynAudioMNIST", *RUNOPT_CORPUS)
        for amp in (False, True):
            out["bf16" if amp else "f32"], c, gc, pc = run_md_vae_options(
                report, probe, root, amp, dev)
            counts = {k: counts.get(k, 0) + v for k, v in c.items()}
            for into, got in ((graph_counts, gc), (prof_counts, pc)):
                for k, v in got.items():
                    into[k] = into.get(k, 0) + v
        out["world1_scan"] = run_world1_scan(report, root, dev)
        out["w2v_cache"] = {("bf16" if amp else "f32"):
                            run_w2v_cache(report, probe, amp, dev)
                            for amp in (False, True)}
        out["w2v_scan"] = run_w2v_scan(report, probe, dev)
    finally:
        probe.close()
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    out["remat"] = run_remat(dev, report, smi)
    out["seconds"] = time.perf_counter() - t0
    report(f"  the run options phase: {out['seconds']:.1f} s on {smi}")
    return counts, graph_counts, prof_counts, out


# ---------------------------------------------------------------------------
# fused_f32: the fused tiers on f32 streams (K3/K4-fwd, K3-bwd, K4-bwd and
# K7b in f32) behind MLVAE_PALLAS_FUSED
# ---------------------------------------------------------------------------

F32_KERNELS = ("lstm_fused_fwd_f32", "lstm_fused_bwd_f32",
               "lstm_semi_bwd_f32", "lstm_unroll_fused_fwd_f32")
# (T, B) of each f32 build's check at H=512: the main path's, B=1, ragged
# B, T=1 and T=2, and B=256 (four tiles, a barrier each, in the backwards)
F32_CASES = ((160, 64), (160, 1), (160, 70), (1, 64), (2, 64), (160, 256))
F32_FWD_REPEATS = 10   # repeated K3/K4-fwd launches per In and direction
F32_BWD_REPEATS = 50   # repeated K3-bwd / K4-bwd launches per direction
SWITCH_OFF_RTOL = 5e-2  # the AMP VAE step under MLVAE_PALLAS_FUSED=0 (K1 on
                        # bf16 streams, a bf16 gx) against the default AMP
                        # step (the fused tiers, an f32 input product)
SWITCH_CHILD_TIMEOUT = 420
F32_YARD_ROUNDS = 2
F32_BWD_BATCHES = (70, 256)   # the f32 backwards' other timed batches
SWITCH_ROUNDS = 2


def f32_problem(g, dev, T, B, In, H):
    """``fused_problem``'s layer on f32 streams."""
    import torch
    x = torch.randn((T, B, In), generator=g, device=dev) * 0.5
    w_ih = (torch.rand((4 * H, In), generator=g, device=dev) * 2 - 1) \
        / H ** 0.5
    bias = (torch.rand((4 * H,), generator=g, device=dev) * 2 - 1) / H ** 0.5
    w_hh = (torch.rand((4 * H, H), generator=g, device=dev) * 2 - 1) \
        / H ** 0.5
    return x, w_ih, bias, w_hh


def f32_cotangents(g, dev, T, B, H):
    import torch
    return (torch.randn((T, B, H), generator=g, device=dev) * 0.1,
            torch.randn((B, H), generator=g, device=dev) * 0.1)


def check_fused_f32(dev, report, H=512):
    """The f32 backwards' shared memory and plans as their C code computes
    them against ``ops.lstm.fused_f32_smem`` and ``fused_f32_bwd_plan``
    (the CPU tests' mirrors; the forward's plan is phase 1's), the plans at
    every admitted (In, H) and B 1, 64, 70 and 256, and the registers and
    local memory of each backward kernel a launch can take; K3/K4-fwd alone
    over ``F32_FWD_GRID`` (``check_fused_f32_fwd``); each f32 build against
    its plain version at H=512: K3/K4-fwd at In=128, 256 and 512 (MD_VAE's
    widths under MLVAE_PALLAS_FUSED=1, and K3's widest at H=512), K3-bwd at
    In=128 (split-K) and 256 (the exchange schedule) and K4-bwd at In=512,
    both directions, at ``F32_CASES``, and at H=528 K3-bwd at In=96 and
    K4-bwd at In=512 and K3-bwd's exchange schedule past 768 columns
    (H=256, In=640); hs and cs within LSTM_ATOL, every backward output
    within BWD_RTOL of its largest entry (the backward on the kernel's own
    hs and cs). Returns each kernel's worst max abs error (hs and cs; dX,
    dgx) at T=160, B=64, H=512."""
    import torch
    from mlvae_tpu_torch.ops import lstm as L
    g = torch.Generator(device=dev).manual_seed(71)
    worst = dict.fromkeys(F32_KERNELS[:3], 0.0)
    outs = {"lstm_fused_bwd": ("dX", "dW_ih", "db", "dW_hh"),
            "lstm_semi_bwd": ("dgx", "dW_hh")}
    plans = {(k, In): (L.fused_f32_launch_smem(k, In, H),
                       L.fused_f32_smem(k, In, H))
             for k, In in (("bwd", 128), ("bwd", 256), ("semi", 512),
                           ("semi", 640))}
    report(f"  f32 backwards' shared memory at H={H}, the C plan against "
           "ops.lstm.fused_f32_smem: " + ", ".join(
               f"{k} In={In} {c}/{py}" for (k, In), (c, py) in plans.items()))
    check(all(c == py for c, py in plans.values()),
          f"the f32 builds' shared memory plan differs: {plans}")
    # the backwards' plans: the C code's (which sizes each launch's work
    # scratch) against the CPU mirror at every H the budgets admit, In a
    # multiple of 8 up to 4H, B 1, 64, 70 and 256
    keys = ("schedule", "slots", "smem", "work")
    npts, differ = 0, []
    for k in ("bwd", "semi"):
        for Hh in range(16, 529, 16):
            for In in range(8, 4 * Hh + 1, 8):
                for B in (1, 64, 70, 256):
                    c = L.fused_f32_launch_plan(k, In, Hh, B)
                    py = L.fused_f32_bwd_plan(k, In, Hh, B)
                    npts += 1
                    if tuple(c[n] for n in keys) != tuple(py):
                        differ.append((k, In, Hh, B, c, py))
    report(f"  f32 backwards' plans (schedule, x slots, shared memory, work "
           f"floats), the C plan against ops.lstm.fused_f32_bwd_plan at "
           f"{npts} (kind, In, H, B): {len(differ)} differ"
           + (f": {differ[:4]}" if differ else ""))
    check(not differ, f"the f32 backwards' plan differs at {len(differ)} "
          "points")
    # each kernel a launch can take, at a shape that takes it
    for k, In, Hh in (("bwd", 256, H), ("bwd", 128, 256), ("bwd", 96, 528),
                      ("bwd", 128, H), ("semi", 512, 768), ("semi", 512, H),
                      ("semi", 512, 528)):
        c = L.fused_f32_launch_plan(k, In, Hh, 64)
        report(f"  f32 {k} In={In} H={Hh}: {L.F32_BWD_KERNELS[c['kernel']]}"
               f"<SEMI={k == 'semi'}>, {c['registers']} registers, "
               f"{c['local_bytes']} B local a thread, {c['smem']} B shared")
    for In, bwd in ((128, "lstm_fused_bwd"), (256, "lstm_fused_bwd"),
                    (512, "lstm_semi_bwd")):
        for T, B in F32_CASES:
            for reverse in (False, True):
                prob = f32_problem(g, dev, T, B, In, H)
                got = L.lstm_fused_fwd(*prob, reverse)
                want = L.lstm_fused_fwd_ref(*prob, reverse)
                dhs, dc = f32_cotangents(g, dev, T, B, H)
                args = (*prob, *got, dhs, dc, reverse)
                bgot = getattr(L, bwd)(*args)
                bwant = getattr(L, bwd + "_ref")(*args)
                torch.cuda.synchronize()
                hs_err, cs_err, _ = fused_fwd_errors(got, want)
                berrs = fused_bwd_errors(bgot, bwant)
                sched = L.fused_f32_launch_plan(
                    "semi" if bwd == "lstm_semi_bwd" else "bwd", In, H,
                    B)["schedule"]
                report(f"  f32 T={T} B={B} In={In} H={H} reverse={reverse}: "
                       f"lstm_fused_fwd hs max_abs_err {hs_err:.3e}, cs "
                       f"{cs_err:.3e} (tol {LSTM_ATOL:g}); {bwd} (schedule "
                       f"{sched}) max err rel to largest entry " + ", ".join(
                           f"{n} {e:.3e}" for n, e in zip(outs[bwd], berrs))
                       + f" (tol {BWD_RTOL:g})")
                check(max(hs_err, cs_err) <= LSTM_ATOL,
                      f"f32 lstm_fused_fwd disagrees: {hs_err}, {cs_err}")
                check(max(berrs) <= BWD_RTOL, f"f32 {bwd} disagrees: {berrs}")
                if (T, B) == (160, 64) and In != 256:
                    worst["lstm_fused_fwd_f32"] = max(
                        worst["lstm_fused_fwd_f32"], hs_err, cs_err)
                    worst[bwd + "_f32"] = max(worst[bwd + "_f32"],
                                              max_err(bgot[0], bwant[0]))
    # the backwards' builds H=512 does not reach: three columns a thread of
    # [x | h] (K3 at In=96, K4) at H=528; the exchange schedule (K3 past
    # 768 columns) at H=256, In=640
    for In, Hh, bwd in ((96, 528, "lstm_fused_bwd"),
                        (512, 528, "lstm_semi_bwd"),
                        (640, 256, "lstm_fused_bwd")):
        prob = f32_problem(g, dev, 160, 64, In, Hh)
        args = (*prob, *L.lstm_fused_fwd(*prob), *f32_cotangents(
            g, dev, 160, 64, Hh), True)
        berrs = fused_bwd_errors(getattr(L, bwd)(*args),
                                 getattr(L, bwd + "_ref")(*args))
        sched = L.fused_f32_launch_plan(
            "semi" if bwd == "lstm_semi_bwd" else "bwd", In, Hh,
            64)["schedule"]
        report(f"  f32 T=160 B=64 In={In} H={Hh} reverse=True: {bwd} "
               f"(schedule {sched}) max err rel to largest entry " + ", ".join(
                   f"{n} {e:.3e}" for n, e in zip(outs[bwd], berrs))
               + f" (tol {BWD_RTOL:g})")
        check(max(berrs) <= BWD_RTOL, f"f32 {bwd} at In={In} H={Hh} "
              f"disagrees: {berrs}")
    # the entries refuse a work scratch one float short of their plan's
    from mlvae_tpu_torch import _build
    from mlvae_tpu_torch.tools import bench_bwd_timeline as btl
    refused = {}
    for k, In in (("bwd", 128), ("bwd", 256), ("semi", 512)):
        prob = f32_problem(g, dev, 2, 64, In, H)
        prob = (*prob, *L.lstm_fused_fwd(*prob),
                *f32_cotangents(g, dev, 2, 64, H))
        kern = L.LSTM_SEMI_BWD_F32 if k == "semi" else L.LSTM_FUSED_BWD_F32
        floats = L.fused_f32_launch_plan(k, In, H, 64)["work"]
        work = torch.empty((floats,), device=dev, dtype=torch.float32)
        scratch = L._bwd_scratch(prob[0], H, prob[7])
        outs = btl.f32_outputs(kern.name, prob)
        try:
            kern(*(t.data_ptr() for t in (*prob[:7], *outs, work, *scratch)),
                 2, 64, In, H, 0, floats - 1,
                 _build.stream_handle(dev))
            refused[f"{k} In={In}"] = False
        except RuntimeError:
            refused[f"{k} In={In}"] = True
    report(f"  f32 backwards refuse a work scratch one float short: "
           f"{refused}")
    check(all(refused.values()), f"an f32 backward took a short work "
          f"scratch: {refused}")
    worst["lstm_fused_fwd_f32"] = max(worst["lstm_fused_fwd_f32"],
                                      check_fused_f32_fwd(dev, report, g))
    return worst


# K3/K4-fwd f32 alone: (H, In, (T, B) cases); every B the main path and the
# unroll path give it, ragged B, four and five tiles, T=1 and 2
F32_FWD_GRID = tuple(
    (H, In, ((160, 1), (160, 64), (160, 70), (160, 128), (160, 256),
             (160, 320), (1, 64), (2, 64), (2, 70)))
    for H in (512, 528) for In in (128, 256, 512, 640))


def check_fused_f32_fwd(dev, report, g):
    """K3/K4-fwd on f32 streams against its plain version over
    ``F32_FWD_GRID``, both directions (hs and cs within LSTM_ATOL), and
    that its entries refuse a scratch one float short of their plan's.
    Returns the worst max abs error at T=160, B=64, H=512, In 128 and
    512."""
    import torch
    from mlvae_tpu_torch import _build
    from mlvae_tpu_torch.ops import lstm as L
    from mlvae_tpu_torch.ops import lstm_unroll_exp as LU
    worst, errs, n = 0.0, {}, 0
    for H, In, cases in F32_FWD_GRID:
        for T, B in cases:
            for reverse in (False, True):
                prob = f32_problem(g, dev, T, B, In, H)
                got = L.lstm_fused_fwd(*prob, reverse)
                want = L.lstm_fused_fwd_ref(*prob, reverse)
                torch.cuda.synchronize()
                hs_err, cs_err, _ = fused_fwd_errors(got, want)
                n += 1
                errs[(H, In, T, B, reverse)] = max(hs_err, cs_err)
                if (H, T, B) == (512, 160, 64) and In in (128, 512):
                    worst = max(worst, hs_err, cs_err)
    bad = {k: e for k, e in errs.items() if e > LSTM_ATOL}
    top = max(errs, key=errs.get)
    report(f"  f32 lstm_fused_fwd alone at H 512 and 528, In 128, 256, "
           f"512 and 640, (T, B) {list(F32_FWD_GRID[0][2])}, both "
           f"directions: {n} launches, worst max abs error of hs and cs "
           f"{errs[top]:.3e} at (H, In, T, B, reverse) {top} (tol "
           f"{LSTM_ATOL:g}); {len(bad)} past it" + (
               f": {list(bad.items())[:4]}" if bad else ""))
    check(not bad, f"f32 lstm_fused_fwd disagrees at {len(bad)} shapes")
    # both entries refuse a scratch one float short of the plan's
    refused = {}
    x, w_ih, bias, w_hh = prob = f32_problem(g, dev, 2, 64, 128, 512)
    floats = L.fused_f32_fwd_launch_plan(128, 512, 64, 2)["scratch"]
    scratch = torch.empty((floats,), device=dev, dtype=torch.float32)
    hs = torch.empty((2, 64, 512), device=dev)
    cs = torch.empty_like(hs)
    barrier = torch.zeros((1,), device=dev, dtype=torch.int32)
    for name, kern, ks in (("lstm_fused_fwd_f32", L.LSTM_FUSED_FWD_F32, ()),
                           ("lstm_unroll_fused_fwd_f32",
                            LU.LSTM_UNROLL_FUSED_FWD_F32, (2,))):
        try:
            kern(*(t.data_ptr() for t in (*prob, hs, cs, scratch, barrier)),
                 2, 64, 128, 512, *ks, 0, floats - 1,
                 _build.stream_handle(dev))
            refused[name] = False
        except RuntimeError:
            refused[name] = True
    report(f"  f32 forward entries refuse a scratch one float short: "
           f"{refused}")
    check(all(refused.values()), f"an f32 forward entry took a short "
          f"scratch: {refused}")
    return worst


def stress_fused_f32(dev, report, H=512, T=160, B=64):
    """Repeated launches of the f32 builds at the main path's shape, back to
    back, both directions: K3/K4-fwd at In=128 and 512, ``F32_FWD_REPEATS``
    each, K3-bwd (In=128) and K4-bwd (In=512), ``F32_BWD_REPEATS`` each,
    every one bit-equal to the first."""
    import torch
    from mlvae_tpu_torch.ops import lstm as L
    g = torch.Generator(device=dev).manual_seed(72)
    total, wrong = 0, []
    for In, bwd in ((128, "lstm_fused_bwd"), (512, "lstm_semi_bwd")):
        for reverse in (False, True):
            prob = f32_problem(g, dev, T, B, In, H)
            first = L.lstm_fused_fwd(*prob, reverse)
            for j in range(F32_FWD_REPEATS):
                total += 1
                if not bit_equal(L.lstm_fused_fwd(*prob, reverse), first):
                    wrong.append(("lstm_fused_fwd", In, reverse, j))
            args = (*prob, *first, *f32_cotangents(g, dev, T, B, H), reverse)
            bfirst = getattr(L, bwd)(*args)
            for j in range(F32_BWD_REPEATS):
                total += 1
                if not bit_equal(getattr(L, bwd)(*args), bfirst):
                    wrong.append((bwd, In, reverse, j))
    report(f"  f32 builds repeated at T={T}, B={B}, H={H}, both directions: "
           f"{total} launches against the first of each: {len(wrong)} not "
           "bit-equal" + (f": {wrong[:8]}" if wrong else ""))
    check(not wrong, f"f32 fused builds not bit-equal in {len(wrong)} of "
          f"{total} repeated launches")


def check_unroll_f32(dev, report, T=160, B=128, H=512, In=512):
    """K7b on f32 streams at the unroll bench's shape, K in UNROLL_KS, both
    directions: bit-equal to K3/K4-fwd on f32 streams, and that twin
    against the plain version (LSTM_ATOL). Returns the twin's worst max
    abs error."""
    import torch
    from mlvae_tpu_torch.ops import lstm as L
    from mlvae_tpu_torch.ops import lstm_unroll_exp as LU
    g = torch.Generator(device=dev).manual_seed(74)
    worst = 0.0
    for reverse in (False, True):
        prob = f32_problem(g, dev, T, B, In, H)
        twin = L.lstm_fused_fwd(*prob, reverse)
        same = {K: bit_equal(LU.run_fwd_fused_k(*prob, reverse, K), twin)
                for K in UNROLL_KS}
        want = LU.run_fwd_fused_k_ref(*prob, reverse, UNROLL_KS[0])
        torch.cuda.synchronize()
        hs_err, cs_err, _ = fused_fwd_errors(twin, want)
        report(f"  lstm_unroll_fused_fwd f32 T={T} B={B} In={In} H={H} "
               f"reverse={reverse}: bit-equal to lstm_fused_fwd f32 at K "
               f"{same}; the twin against the plain version: hs max_abs_err "
               f"{hs_err:.3e}, cs {cs_err:.3e} (tol {LSTM_ATOL:g})")
        check(all(same.values()), f"f32 K7b differs from its twin: {same}")
        check(max(hs_err, cs_err) <= LSTM_ATOL,
              f"f32 K3/K4-fwd at B={B} disagrees: {hs_err}, {cs_err}")
        worst = max(worst, hs_err, cs_err)
    return worst


def run_switch_training(dev, report, B=64, T=160, L=8):
    """MD_VAE at the recipe's width under MLVAE_PALLAS_FUSED=1 on f32
    streams: one train step of each target (PHN_RECOG, B_DETECTOR, VAE)
    and the TEST eval forward, each against the same through the plain
    versions (loss within LOSS_RTOL, each module's applied grad norm
    within GRAD_RTOL, exactly the target's modules moved), launches exact
    per tier (the pinned ``PER_F32_ON_*``, which the layers' routes,
    ``md_vae_switch_launches``, must give too), the VAE loss against the
    default (K1) step's from the same weights and draws within LOSS_RTOL; then the
    AMP VAE step under MLVAE_PALLAS_FUSED=0: only the bf16 K1 builds (with
    K1-bwd's dW_hh kernel) and K2 launch, its loss within AMP_LOSS_RTOL of
    its plain twin and within SWITCH_OFF_RTOL of the default AMP step's.
    Returns the f32 model, batch and VAE draws, the launches of the
    kernel runs, and the numbers."""
    import numpy as np
    import torch
    from mlvae_tpu_torch.bench_utils import build_md_vae, synth_batch
    from mlvae_tpu_torch.training.brain import Stage

    def rel(a, b):
        return abs(float(a) - float(b)) / abs(float(b))

    model = build_md_vae(batch_size=B, seed=0, device=dev)
    batch = synth_batch(B, T, L, seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(75)
    total = {k: 0 for k in launches()}
    out = {}
    vae_noise = None
    with fused_switch(True):
        for epoch in (1, 2, 3):
            model.on_stage_start(Stage.TRAIN, epoch)
            name = model.target.name
            noise = train_noise(model, B, T, dev, g)
            start = snapshot(model)
            with twins():
                reset_launches()
                ref_loss, _ = model.fit_batch(batch, epoch, noise=noise)
                ref_norms = grad_norms(model)
                torch.cuda.synchronize()
                check(sum(launches().values()) == 0,
                      "the plain training step hit a kernel")
            restore(model, start)
            auto_loss = None
            if name == "VAE":
                vae_noise = noise
                with fused_switch("auto"):
                    auto_loss, _ = model.fit_batch(batch, epoch, noise=noise)
                restore(model, start)
            weights = start[0]
            reset_launches()
            loss, losses = model.fit_batch(batch, epoch, noise=noise)
            torch.cuda.synchronize()
            counts = launches()
            for k in total:
                total[k] += counts[k]
            moved = {mk for mk, mod in model.param_modules().items()
                     if any(not torch.equal(v, weights[f"{mk}.{n}"])
                            for n, v in mod.state_dict().items())}
            want = recipe_launches("MD_VAE", name, True)
            routes = md_vae_switch_launches(name, True, False)
            norms = grad_norms(model)
            loss_rel = rel(loss, ref_loss)
            norm_rel = {mk: abs(v - ref_norms[mk]) / ref_norms[mk]
                        if ref_norms[mk] else abs(v)
                        for mk, v in norms.items()}
            report(f"  MLVAE_PALLAS_FUSED=1 f32 {name} step: loss "
                   f"{float(loss):.6f}; launches "
                   f"{ {k: v for k, v in counts.items() if v} }; modules "
                   f"moved {sorted(moved)}; against the plain versions: loss "
                   f"rel err {loss_rel:.3e} (tol {LOSS_RTOL:g}), grad norm "
                   "rel err " + ", ".join(f"{mk} {v:.3e}" for mk, v in
                                          norm_rel.items() if norms[mk])
                   + f" (tol {GRAD_RTOL:g})")
            check(np.isfinite(float(loss)), f"{name}: non-finite loss")
            check(counts == want, f"=1 {name} launches {counts} != {want}")
            check(routes == want, f"=1 {name}: the layers' routes give "
                  f"{routes}, not the reckoned {want}")
            check(moved == ACTIVE[name], f"=1 {name} moved {sorted(moved)}")
            check(loss_rel <= LOSS_RTOL, f"=1 {name} loss disagrees")
            check(max(norm_rel.values()) <= GRAD_RTOL,
                  f"=1 {name} grads disagree")
            out[name] = {"loss": float(loss), "loss_rel_plain": loss_rel,
                         "grad_norm_rel_plain": max(norm_rel.values())}
            if auto_loss is not None:
                auto_rel = rel(loss, auto_loss)
                report(f"  against the default (K1) step from the same "
                       f"weights and draws: loss {float(auto_loss):.6f}, rel "
                       f"err {auto_rel:.3e} (tol {LOSS_RTOL:g})")
                check(auto_rel <= LOSS_RTOL, "the =1 VAE loss is far from "
                      "the default step's")
                out[name]["loss_rel_auto"] = auto_rel

        model.set_stage(Stage.TEST)
        ebatch = model.prepare_batch(batch)
        noise = eval_noise(model, B, T, dev, seed=3)
        reset_launches()
        preds = model.compute_forward(ebatch, noise=noise)
        _, losses = model.compute_objectives(preds, ebatch)
        torch.cuda.synchronize()
        counts = launches()
        for k in total:
            total[k] += counts[k]
        want = recipe_launches("MD_VAE", "TEST", False)
        report(f"  MLVAE_PALLAS_FUSED=1 f32 TEST eval forward: launches "
               f"{ {k: v for k, v in counts.items() if v} }")
        check(counts == want, f"=1 TEST launches {counts} != {want}")
        check(md_vae_switch_launches("TEST", False, False) == want,
              "=1 TEST: the layers' routes differ from the reckoned counts")
        with twins():
            ref = model.compute_forward(ebatch, noise=noise)
            _, ref_losses = model.compute_objectives(ref, ebatch)
        against_plain(report, ebatch, preds, losses, ref, ref_losses)

    amp = build_md_vae(batch_size=B, seed=0, device=dev, bf16=True)
    amp.on_stage_start(Stage.TRAIN, 3)
    noise = train_noise(amp, B, T, dev, g)
    start = snapshot(amp)
    auto_loss, _ = amp.fit_batch(batch, 3, noise=noise)
    restore(amp, start)
    with fused_switch(False):
        with twins():
            ref_loss, _ = amp.fit_batch(batch, 3, noise=noise)
        restore(amp, start)
        reset_launches()
        loss, _ = amp.fit_batch(batch, 3, noise=noise)
        torch.cuda.synchronize()
        counts = launches()
        want = recipe_launches("MD_VAE", "VAE", True, amp=True)
        routes = md_vae_switch_launches("VAE", True, True)
    for k in total:
        total[k] += counts[k]
    plain_rel, auto_rel = rel(loss, ref_loss), rel(loss, auto_loss)
    report(f"  MLVAE_PALLAS_FUSED=0 AMP VAE step: loss {float(loss):.6f}; "
           f"launches { {k: v for k, v in counts.items() if v} }; against "
           f"the plain versions rel err {plain_rel:.3e} (tol "
           f"{AMP_LOSS_RTOL:g}); against the default AMP step "
           f"{float(auto_loss):.6f}, rel err {auto_rel:.3e} (tol "
           f"{SWITCH_OFF_RTOL:g})")
    check(counts == want, f"=0 AMP VAE launches {counts} != {want}")
    check(routes == want, f"=0 AMP VAE: the layers' routes give {routes}, "
          f"not the reckoned {want}")
    check(plain_rel <= AMP_LOSS_RTOL, "the =0 AMP loss disagrees with the "
          "plain versions")
    check(auto_rel <= SWITCH_OFF_RTOL, "the =0 AMP loss is far from the "
          "default AMP step's")
    out["amp_off_VAE"] = {"loss": float(loss), "loss_rel_plain": plain_rel,
                          "loss_rel_auto": auto_rel}
    del amp
    return model, batch, vae_noise, total, out


def run_cli_switch_child(out_dir):
    """In a process started with MLVAE_PALLAS_FUSED=1 in its environment
    (``--fused-cli-child``): MD_VAE's ``cli.train`` (one debug epoch a
    target) and ``cli.test`` as in phase 3, each against the same run
    through the plain versions, every stage's launches exact under the
    switch; writes the launches and the stages to
    ``out_dir/result.json``."""
    import logging
    import os
    import shutil
    import tempfile
    import torch
    from mlvae_tpu_torch.nn import rnn

    def report(line):
        print(line, flush=True)

    check(rnn.PALLAS_LSTM_FUSED is True, "MLVAE_PALLAS_FUSED read as "
          f"{rnn.PALLAS_LSTM_FUSED!r}, not 1")
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    cwd = os.getcwd()
    root = tempfile.mkdtemp(prefix="mlvae_cli_f32_")
    probe = CliProbe()
    try:
        os.chdir(root)
        model, train_total, stages = run_cli_train(report, probe, "cli_f32")
        epochs = model.epoch_log
        del model
        test_total, timing = run_cli_test(report, probe, root, "cli_f32")
        torch.cuda.synchronize()
    finally:
        probe.close()
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    res = {"counts": {k: train_total[k] + test_total[k] for k in train_total},
           "stage_launches": {f"{k[0]} {k[1]} {v['target']}": {
               n: c for n, c in v["launches"].items() if c}
               for k, v in stages.items()},
           "epochs": epochs, "evaluate_s": timing}
    (Path(out_dir) / "result.json").write_text(json.dumps(res))
    return 0


def run_cli_switch(dev, report):
    """MD_VAE's ``cli.train`` and ``cli.test`` in a process whose
    environment holds MLVAE_PALLAS_FUSED=1 (this script again, with
    ``--fused-cli-child``), its lines relayed; then ``cli.train`` with
    MLVAE_PALLAS_FUSED=ture, which must exit non-zero with the switch's
    ValueError. Returns the child's launches and its record."""
    import os
    import shutil
    import tempfile
    out = tempfile.mkdtemp(prefix="mlvae_switch_")
    env = {**os.environ, "MLVAE_PALLAS_FUSED": "1",
           "PYTHONPATH": os.pathsep.join(
               [str(REPO)] + ([os.environ["PYTHONPATH"]]
                              if os.environ.get("PYTHONPATH") else []))}
    try:
        proc = subprocess.run(
            [sys.executable, str(REPO / "chip_smoke.py"),
             "--fused-cli-child", out], env=env, capture_output=True,
            text=True, timeout=SWITCH_CHILD_TIMEOUT)
        for line in proc.stdout.splitlines():
            report("  [MLVAE_PALLAS_FUSED=1] " + line.strip())
        check(proc.returncode == 0, "the CLI under MLVAE_PALLAS_FUSED=1 "
              f"exited {proc.returncode}: {proc.stderr[-3000:]}")
        res = json.loads((Path(out) / "result.json").read_text())
        env["MLVAE_PALLAS_FUSED"] = "ture"
        bad = subprocess.run(
            [sys.executable, "-m", "mlvae_tpu_torch.cli.train",
             *cli_args("cli_ture")], cwd=out, env=env, capture_output=True,
            text=True, timeout=SWITCH_CHILD_TIMEOUT)
        msg = ("ValueError: MLVAE_PALLAS_FUSED='ture' is not a recognized "
               "boolean")
        said = msg if msg in bad.stderr else bad.stderr[-500:]
        report(f"  cli.train with MLVAE_PALLAS_FUSED=ture: exit "
               f"{bad.returncode}; {said}")
        check(bad.returncode != 0 and msg in bad.stderr,
              "a misspelled MLVAE_PALLAS_FUSED did not stop the CLI")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return res["counts"], res


def time_fused_f32(dev, report, errs, counts, model, batch, vae_noise, smi,
                   T=160, B=64, H=512):
    """The f32 builds at the main path's widths in turns with two
    yardsticks: the unfused f32 route (K3/K4-fwd: one ``torch.matmul`` for
    the input projection, then K1-fwd; K3-bwd: K1-bwd and the GEMMs for
    dX, dW_ih and db; K4-bwd, which emits dgx as K1-bwd does: K1-bwd) and
    ``torch.nn.LSTM`` f32 (cuDNN, TF32 off; the backward as its forward and
    backward less its forward), beside their bounds and plain versions; the
    backwards also at ``F32_BWD_BATCHES`` (ragged, and four tiles); then
    MD_VAE's f32 VAE step under MLVAE_PALLAS_FUSED=1 against
    the default in turns, with a profile of each. Returns the kernels
    line's rows of K3/K4-fwd (In=128), K3-bwd (In=128) and K4-bwd (In=512)
    on f32 streams, at B."""
    import torch
    from mlvae_tpu_torch.ops import lstm as L
    g = torch.Generator(device=dev).manual_seed(76)
    rows, res = [], {"card": smi}

    def timer(fn):
        return lambda iters: cuda_ms(fn, iters=iters, warmup=1)

    saved_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for In, Bn in ((128, B), (512, B),
                       *((In, b) for In in (128, 512)
                         for b in F32_BWD_BATCHES)):
            x, w_ih, bias, w_hh = prob = f32_problem(g, dev, T, Bn, In, H)
            hs, cs = L.lstm_fused_fwd(*prob)
            dhs, dc = f32_cotangents(g, dev, T, Bn, H)
            gx = (torch.matmul(x, w_ih.t()) + bias).contiguous()
            cudnn = torch.nn.LSTM(In, H, 1).to(dev)
            cudnn.flatten_parameters()
            xg = x.clone().requires_grad_()
            dy = torch.randn((T, Bn, H), generator=g, device=dev)

            def unfused_fwd():
                return L.lstm_layer_fwd(
                    (torch.matmul(x, w_ih.t()) + bias).contiguous(), w_hh)

            def cudnn_fwd():
                with torch.no_grad():
                    return cudnn(x)

            def unfused_bwd(k3=In == 128):
                dgx, dw = L.lstm_layer_bwd(gx, w_hh, hs, cs, dhs, dc)
                if k3:
                    return (torch.matmul(dgx, w_ih),
                            dgx.flatten(0, 1).t() @ x.flatten(0, 1),
                            dgx.sum((0, 1)), dw)
                return dgx, dw

            def cudnn_bwd(iters):
                fwd = cuda_ms(lambda: cudnn(xg), iters=iters, warmup=1)
                return cuda_ms(lambda: cudnn(xg)[0].backward(dy),
                               iters=iters, warmup=1) - fwd

            bwd = "lstm_fused_bwd" if In == 128 else "lstm_semi_bwd"
            kern_bwd = getattr(L, bwd)
            arms = (
                ("lstm_fused_fwd_f32",
                 (timer(lambda: L.lstm_fused_fwd(*prob)),
                  timer(unfused_fwd), timer(cudnn_fwd)),
                 fused_fwd_bound(T, Bn, In, H, bf16=False),
                 lambda: L.lstm_fused_fwd_ref(*prob)),
                (bwd + "_f32",
                 (timer(lambda: kern_bwd(*prob, hs, cs, dhs, dc)),
                  timer(unfused_bwd), cudnn_bwd),
                 (fused_bwd_bound if In == 128 else semi_bwd_bound)(
                     T, Bn, In, H, bf16=False),
                 lambda: getattr(L, bwd + "_ref")(*prob, hs, cs, dhs,
                                                  dc)))
            for name, fns, bound, plain in (arms if Bn == B else arms[1:]):
                key = f"{name} In={In}" + ("" if Bn == B else f" B={Bn}")
                ks, us, cs_ = in_turns(fns, F32_YARD_ROUNDS, iters=5)
                km, um, cm = (statistics.median(v) for v in (ks, us, cs_))
                p_ms = cuda_ms(plain, iters=1, warmup=1)
                b_ms, b_by = bound
                row = {"ms": km, "spread": [min(ks), max(ks)],
                       "us_a_step": km * 1e3 / T, "unfused_ms": um,
                       "unfused_spread": [min(us), max(us)],
                       "cudnn_ms": cm, "cudnn_spread": [min(cs_), max(cs_)],
                       "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}
                res[key] = row
                report(f"  {name} In={In} T={T} B={Bn} H={H}: {km:.4f} ms "
                       f"median ({min(ks):.4f}-{max(ks):.4f}; "
                       f"{row['us_a_step']:.2f} us a step); in turns the "
                       f"unfused f32 route {um:.4f} ({min(us):.4f}-"
                       f"{max(us):.4f}), cuDNN f32 (TF32 off) {cm:.4f} "
                       f"({min(cs_):.4f}-{max(cs_):.4f}); factors "
                       f"{km / um:.3f}, {km / cm:.3f}; plain {p_ms:.4f}; "
                       f"bound {b_ms:.4f} by {b_by}; {smi}")
                if Bn != B or (name == "lstm_fused_fwd_f32" and In == 512):
                    continue   # the row reports In=128, MD_VAE's most
                src = ("lstm_fused_fwd_f32.cu" if name.startswith(
                    "lstm_fused_fwd") else "lstm_fused_bwd_f32.cu")
                line = {"lstm_fused_fwd_f32": 347, "lstm_fused_bwd_f32": 371,
                        "lstm_semi_bwd_f32": 519}[name]
                rows.append(dict(
                    name=name, route="cuda",
                    source=f"mlvae_tpu_torch/csrc/{src}",
                    replaces=f"mlvae_tpu/ops/lstm_pallas.py:{line}",
                    max_abs_err=errs[name], ms=km, plain_ms=p_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=cm,
                    unfused_ms=um, shape=f"T={T} B={B} In={In} H={H} f32",
                    card=smi, **counts[name]))
    finally:
        torch.backends.cudnn.allow_tf32 = saved_tf32
    for row in rows:   # K3/K4-fwd's In=512, the backwards' other batches
        if row["name"] == "lstm_fused_fwd_f32":
            row["ms_in512"] = res["lstm_fused_fwd_f32 In=512"]["ms"]
        else:
            In = 128 if row["name"] == "lstm_fused_bwd_f32" else 512
            row["ms_by_b"] = {b: res[f"{row['name']} In={In} B={b}"]["ms"]
                              for b in F32_BWD_BATCHES}

    def step(value):
        def fn(iters):
            with fused_switch(value):
                return cuda_ms(lambda: model.fit_batch(
                    batch, 3, noise=vae_noise), iters=iters, warmup=1)
        return fn

    on, auto = in_turns((step(True), step("auto")), SWITCH_ROUNDS, iters=3)
    res["vae_step"] = {"on_ms": statistics.median(on), "on": on,
                       "auto_ms": statistics.median(auto), "auto": auto}
    for value, label in ((True, "on"), ("auto", "auto")):
        with fused_switch(value):
            res["vae_step"][f"profile_{label}"] = profile_step(
                lambda: model.fit_batch(batch, 3, noise=vae_noise),
                f"f32 VAE train step, MLVAE_PALLAS_FUSED "
                f"{'=1' if value is True else 'unset'}", report)
    vs = res["vae_step"]
    report(f"  MD_VAE f32 VAE step B={B} T={T} in turns: "
           f"MLVAE_PALLAS_FUSED=1 {vs['on_ms']:.3f} ms median "
           f"({min(on):.3f}-{max(on):.3f}), unset {vs['auto_ms']:.3f} "
           f"({min(auto):.3f}-{max(auto):.3f}); kernel time "
           f"{vs['profile_on']['kernel_ms']:.3f} against "
           f"{vs['profile_auto']['kernel_ms']:.3f} ms, idle share "
           f"{vs['profile_on']['idle_share']:.3f} against "
           f"{vs['profile_auto']['idle_share']:.3f}; {smi}")
    return rows, res


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lstm-repeats", type=int, default=LSTM_REPEATS,
                    help="K1 launches per shape and direction in phase 2's "
                    "repeated check (default %(default)s)")
    ap.add_argument("--lstm-bwd-repeats", type=int, default=LSTM_BWD_REPEATS,
                    help="K1-bwd launches per direction in phase 2's "
                    "repeated check (default %(default)s)")
    # the fused_f32 phase's CLI process (run_cli_switch), not for a user
    ap.add_argument("--fused-cli-child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not (REPO / "mlvae_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the mlvae_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from mlvae_tpu_torch import _build
    from mlvae_tpu_torch.device import resolve_device
    # register every kernel before the first launch count is read
    from mlvae_tpu_torch.ops import (decode, fbank, gru, lstm,  # noqa: F401
                                     lstm_unroll_exp)
    if args.fused_cli_child:
        return run_cli_switch_child(args.fused_cli_child)

    t_start = time.perf_counter()

    def report(line):
        if line.startswith("phase "):   # each phase's start, in seconds
            line += f" [{time.perf_counter() - t_start:.1f} s]"
        print(line, flush=True)

    dev = resolve_device(None)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    report(f"phase 1 card: {name}; nvidia-smi: {smi}; torch "
           f"{torch.__version__} CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    built = _build.build([*_build.SOURCES, *_build.VARIANTS])
    report(f"phase 1 build: {time.perf_counter() - t0:.1f} s wall for "
           f"{sorted(built) or 'nothing (cached)'}")
    for src, (_, log) in _build.BUILD_LOG.items():
        report(f"  ptxas {src}: " + " | ".join(ptxas_usage(log)))
    plans = wide_plans(dev, report)
    k5_plans = gru_plans(dev, report)
    k7_plans = unroll_plans(dev, report)
    f32_fwd_plans = fused_f32_fwd_plans(dev, report)

    report("phase 2 kernels against their plain versions on the card")
    errs = {"lstm": max(check_lstm(dev, report),
                        stress_lstm(dev, report, args.lstm_repeats))}
    errs["lstm_bwd"] = max(check_lstm_bwd(dev, report),
                           stress_lstm_bwd(dev, report,
                                           args.lstm_bwd_repeats))
    report("phase 2 the wide K1 builds")
    errs["lstm_wide"] = check_lstm_wide(dev, report)
    stress_lstm_wide(dev, report)
    errs["lstm_wide_bf16"] = check_lstm_wide(dev, report, bf16=True)
    stress_lstm_wide(dev, report, WIDE_BF16_REPEATS, bf16=True)
    report("phase 2 K1 on bf16 streams at H = 128, 256, 384, 512 (the "
           "tensor-core builds)")
    errs["lstm_bf16_narrow"] = check_k1_bf16_narrow(dev, report)
    report("phase 2 K2, K3/K4, K6, K5, K7")
    prob, prob_b1, errs_viterbi = check_viterbi(dev, report)
    errs.update(errs_viterbi)
    errs["lstm_fused_fwd"] = check_fused_fwd(dev, report)
    errs.update(check_fused_bwd(dev, report))
    stress_fused(dev, report, FUSED_REPEATS)
    stress_fwd_bits(dev, report)
    cases = fbank_cases(dev)
    errs_fbank = check_fbank(dev, report, cases)
    errs.update(check_gru(dev, report))
    stress_gru(dev, report, GRU_REPEATS)
    errs.update(check_unroll(dev, report))
    stress_unroll(dev, report, UNROLL_REPEATS)

    report("phase 3 MD_VAE TEST eval step at full width (H=512, B=64, "
           "T=160, L=8)")
    model, batch, noise, eval_counts = run_slice(dev, report)
    report("phase 3 wav in: infer at B=1, the wav-in eval forward at B=64, "
           "the Kaldi feature pass")
    wav_counts = run_wav(dev, report, model)
    report("phase 3 MD_VAE f32 training step at full width (H=512, B=64, "
           "T=160, L=8), two steps per target")
    train_model, train_batch, first_noise, train_counts = run_training(
        dev, report)
    report("phase 3 MD_VAE AMP (bf16) training step at full width (H=512, "
           "B=64, T=160, L=8), two steps per target")
    amp_model, amp_batch, amp_noise, amp_counts = run_training(
        dev, report, amp=True)
    report("phase 3 MD_VAE_sfl's VAE training step at full width (H=512, "
           f"B=64, T=160, L=8, {SFL_SAMPLES} π samples, the Kaldi pass's "
           "features in), two steps")
    sfl_model, sfl_batch, sfl_noise, sfl_counts = run_sfl_training(
        dev, report)
    report("phase 3 BASELINE gate configs: gate 3 (GRU sequence VAE) at "
           "full width (C=120, H=512, LAT=32, B=64, T=160), two f32 and two "
           "AMP steps; gates 1, 2, 4 one step each, card against CPU")
    gate, gate_batch, gate_noise_, gate_loss, gate_counts = run_gate3(
        dev, report)
    amp_gate, amp_gate_batch, amp_gate_noise, _, amp_gate_counts = \
        run_gate3(dev, report, amp=True, ref_f32=gate_loss)
    run_small_gates(dev, report)
    report("phase 3 the unroll A/B path (K7a, K7b against K1-fwd and "
           "K3/K4-fwd) at B=128, T=160, H=512, In=512, K 2, 4, 8")
    unroll_res, unroll_counts = run_unroll(dev, report)
    report(f"phase 3 LSTM_FC at full width (input 120, H={WIDE_H}, 4 layers, "
           "FC 1024-64-64-2, B=64, T=160): the TEST eval step and two f32 "
           "training steps")
    fc_model, fc_batch, fc_noise, fc_counts = run_lstm_fc(dev, report)
    report(f"phase 3 LSTM_FC's AMP (bf16) training step at full width (H="
           f"{WIDE_H}, 4 layers, B=64, T=160), two steps")
    fc_amp_model, _, fc_amp_noise, fc_amp_counts = run_lstm_fc(
        dev, report, amp=True)
    report("phase 3 the CLI path at the recipe's full width: the corpus and "
           "both feature passes, cli.train (3 debug epochs), cli.test, "
           "cli.infer, cli.train --bf16, each against the plain versions")
    cli_counts, cli_amp_counts, cli_pass_counts, cli = run_cli(dev, report,
                                                               smi)
    report("phase 3 the CLI path of the rest of the MD_VAE family at full "
           "width: MD_VAE_sfl, MD_VAE_joint, MD_VAE_joint_ll, "
           "MD_VAE_sfl_saved_phn_recog (cli.train through each cycle, "
           "cli.test, cli.infer), MD_VAE_sfl's cli.train --bf16, each "
           "against the plain versions")
    fam_counts, fam_amp_counts, cli["family"] = run_cli_family(dev, report,
                                                               smi)
    report(f"phase 3 CRDNN_CTC at full width (CNN 128/256, 4 bidirectional "
           f"LSTM layers at H=512, DNN 512, B={CTC_B}, T={CTC_T}, "
           f"L={CTC_L}): the f32 eval forward and two f32 training steps")
    ctc_model, ctc_batch, ctc_noise, ctc_counts = run_crdnn_training(
        dev, report)
    report("phase 3 CRDNN_CTC's --bf16 training step at full width, two "
           "steps: the first LSTM layer on K1 on bf16 streams")
    ctc_amp_model, _, ctc_amp_noise, ctc_amp_counts = run_crdnn_training(
        dev, report, amp=True)
    report("phase 3 the CLI path of CRDNN_CTC and CRDNN_CTC_cnncl at full "
           "width: cli.train (one debug epoch) and cli.test, CRDNN_CTC's "
           "cli.train --bf16, each against the plain versions")
    cli_ctc_counts, cli_ctc_amp_counts, cli["ctc"] = run_cli_ctc(
        dev, report, smi)
    report("phase 3 the CLI path of the five harness recipes, LSTM_FC and "
           "HMM_DNN_ALI at their recipes' widths: cli.train (one debug "
           "epoch) and cli.test against the plain versions, test_h_vae's "
           "and LSTM_FC's cli.train --bf16, HMM_DNN_ALI (forward, viterbi) "
           "on the card against the CPU")
    cli_hr_counts, cli_hr_amp_counts, cli["harness"] = run_cli_harness(
        dev, report, smi)
    report("phase 3 the real corpora's data path: corpora laid out as "
           "L2-ARCTIC, TIMIT (SPHERE) and ChineseDPA; on L2-ARCTIC MD_VAE's "
           "cli.train (one debug epoch) and cli.test and LSTM_FC's "
           "cli.train with augmentation, TIMIT's and ChineseDPA's prepare "
           "and both feature passes, each against the plain versions; "
           "cli.ingest over the TIMIT tree")
    cli_corpora_counts, cli["corpora"] = run_cli_corpora(dev, report, smi)
    report("phase 3 the wav2vec2 recipes through the CLI, the encoder at "
           "wav2vec2-large-lv60's topology (24 layers, d=1024, random "
           "init): each recipe's cli.train, cli.test of w2v_MD_VAE and "
           "w2v_CRDNN_CTC, their cli.train --bf16, cnncl's "
           "cli.test_on_three_sets into MD_VAE_sfl_saved_phn_recog, "
           "cli.test_external, each against the plain versions; K1 at H=32")
    cli_w2v_counts, cli_w2v_amp_counts, cli["w2v"] = run_cli_w2v(
        dev, report, smi)
    report("phase 3 data parallelism, ZeRO-1 and the trunk's tensor "
           "parallelism, two ranks sharing the card over gloo: MD_VAE's VAE "
           f"train step at full width (B={PAR_B} over {PAR_N} ranks), f32 "
           "and --bf16, and under --zero1, against one process; the TP=2 "
           "wav2vec2-large-lv60 trunk and a w2v_LSTM_FC step; cli.train / "
           "cli.test --data_parallel --num_devices 2 with batches of "
           f"{PAR_CLI_BATCH}")
    par_counts, cli["parallel"] = run_parallel(dev, report, smi)
    report("phase 3 the run options: MD_VAE through cli.train / cli.test "
           "with --scan_epoch True --scan_chunk 2 --async_ckpt True "
           "--cache_device_batches True --profile True and with the four "
           "off (f32 and --bf16, no --debug, one target cycle); the "
           "w2v_MD_VAE frozen-trunk cache (f32 and --bf16); the fine-tuned "
           "lv60 trunk's per-layer recompute on and off; one NCCL rank "
           "with --scan_epoch")
    ro_counts, ro_graph_counts, ro_prof_counts, cli["run_options"] = \
        run_options(dev, report, smi)
    report("phase 3 fused_f32: the fused tiers on f32 streams (K3/K4-fwd, "
           "K3-bwd, K4-bwd, K7b) against their plain versions at H=512, "
           "repeated launches, K7b bit-equal to K3/K4-fwd; MD_VAE's f32 "
           "steps and TEST forward under MLVAE_PALLAS_FUSED=1 and its AMP "
           "VAE step under =0 at full width; cli.train / cli.test with "
           "MLVAE_PALLAS_FUSED=1, and =ture refused")
    errs.update(check_fused_f32(dev, report))
    stress_fused_f32(dev, report)
    errs["lstm_unroll_fused_fwd_f32"] = check_unroll_f32(dev, report)
    sw_model, sw_batch, sw_noise, sw_counts, cli["fused_f32"] = \
        run_switch_training(dev, report)
    sw_cli_counts, cli["fused_f32"]["cli"] = run_cli_switch(dev, report)
    report("phase 3 fused_f32 done")
    # the paths' launches: the eval forward's, the wav-in path's, the six
    # f32 and six AMP MD_VAE train steps', the two MD_VAE_sfl VAE steps',
    # the four gate-3 steps', the unroll path's, LSTM_FC's eval and two
    # f32 train steps' and its two AMP train steps', and the CLI paths'
    # (the feature passes with cli.train, cli.test and cli.infer;
    # cli.train --bf16), MD_VAE's and the family's; CRDNN_CTC's eval
    # forward and f32 and --bf16 train steps, and the CTC recipes' CLI paths;
    # the harness recipes', LSTM_FC's and HMM_DNN_ALI's CLI paths; the
    # real corpora's (their feature passes, MD_VAE's and LSTM_FC's runs);
    # the fused_f32 phase's steps, eval forward and CLI runs
    counts = {k: {"launches": eval_counts[k] + wav_counts[k]
                  + train_counts[k] + amp_counts[k] + sfl_counts[k]
                  + gate_counts[k]
                  + amp_gate_counts[k] + unroll_counts[k] + fc_counts[k]
                  + fc_amp_counts[k] + cli_counts[k] + cli_amp_counts[k]
                  + fam_counts[k] + fam_amp_counts[k] + ctc_counts[k]
                  + ctc_amp_counts[k] + cli_ctc_counts[k]
                  + cli_ctc_amp_counts[k] + cli_hr_counts[k]
                  + cli_hr_amp_counts[k] + cli_corpora_counts[k]
                  + cli_w2v_counts[k] + cli_w2v_amp_counts[k]
                  + par_counts[k] + ro_counts[k] + sw_counts[k]
                  + sw_cli_counts[k],
                  "launches_fused_f32": sw_counts[k],
                  "launches_fused_f32_cli": sw_cli_counts[k],
                  "launches_run_options": ro_counts[k],
                  "launches_run_options_graphs":
                      ro_graph_counts.get(k, 0),
                  "launches_run_options_graphs_profiler":
                      ro_prof_counts.get(k, 0),
                  "launches_parallel": par_counts[k],
                  "launches_cli_w2v": cli_w2v_counts[k],
                  "launches_cli_w2v_bf16": cli_w2v_amp_counts[k],
                  "launches_cli_corpora": cli_corpora_counts[k],
                  "launches_cli_harness": cli_hr_counts[k],
                  "launches_cli_harness_bf16": cli_hr_amp_counts[k],
                  "launches_crdnn_training": ctc_counts[k],
                  "launches_crdnn_amp_training": ctc_amp_counts[k],
                  "launches_cli_ctc": cli_ctc_counts[k],
                  "launches_cli_ctc_bf16": cli_ctc_amp_counts[k],
                  "launches_sfl_training": sfl_counts[k],
                  "launches_cli_family": fam_counts[k],
                  "launches_cli_family_bf16": fam_amp_counts[k],
                  "launches_cli": cli_counts[k],
                  "launches_cli_feature_passes": cli_pass_counts[k],
                  "launches_cli_bf16": cli_amp_counts[k],
                  "launches_eval_step": eval_counts[k],
                  "launches_wav_in": wav_counts[k],
                  "launches_training": train_counts[k],
                  "launches_amp_training": amp_counts[k],
                  "launches_gate3": gate_counts[k],
                  "launches_amp_gate3": amp_gate_counts[k],
                  "launches_unroll": unroll_counts[k],
                  "launches_lstm_fc": fc_counts[k],
                  "launches_lstm_fc_amp": fc_amp_counts[k]}
              for k in eval_counts}
    check(all(c["launches"] > 0 for c in counts.values()),
          f"a kernel of the path never launched: {counts}")

    report("phase 4 times (CUDA events, after warm-up)")
    kernels, step = time_all(dev, report, model, batch, noise, prob, prob_b1,
                             errs, counts)
    kernels += time_fbank(dev, report, cases, errs_fbank, counts)
    del cases
    wav_in = time_wav(dev, report, model)
    del model
    report("phase 4 the fused tiers and the step timelines")
    kernels += time_fused(dev, report, errs, counts)
    bwd_timeline = time_bwd_timeline(dev, report)
    fwd_timeline = time_fwd_timeline(dev, report)
    fwd_timeline["smem_reads"] = time_smem_reads(dev, report)
    report("phase 4 the MD_VAE and MD_VAE_sfl train steps, K5, K7, gate 3")
    train_step = time_training(dev, report, train_model, train_batch,
                               first_noise)
    del train_model
    amp_step = time_training(dev, report, amp_model, amp_batch, amp_noise,
                             label="AMP")
    del amp_model
    amp_step["VAE_B256"] = time_amp_vae(dev, report)
    sfl_step = time_sfl_training(dev, report, sfl_model, sfl_batch,
                                 sfl_noise, smi)
    del sfl_model
    kernels += time_gru(dev, report, errs, counts)
    kernels += time_unroll(dev, report, unroll_res, errs, counts)
    gate3_step = {"f32": time_gate3(dev, report, gate, gate_batch,
                                    gate_noise_, "f32"),
                  "amp": time_gate3(dev, report, amp_gate, amp_gate_batch,
                                    amp_gate_noise, "AMP")}
    del gate, amp_gate
    report("phase 4 LSTM_FC, f32 and AMP")
    fc_kernels, lstm_fc = time_lstm_fc(dev, report, fc_model, fc_batch,
                                       fc_noise, errs, counts)
    kernels += fc_kernels
    del fc_model
    fc_amp_kernels, lstm_fc_amp = time_lstm_fc(
        dev, report, fc_amp_model, fc_batch, fc_amp_noise, errs, counts,
        amp=True)
    kernels += fc_amp_kernels
    del fc_amp_model
    lstm_fc["plans"] = plans
    report("phase 4 CRDNN_CTC, f32 and --bf16, and K1 on bf16 streams at "
           "H=512")
    crdnn = {"f32": time_crdnn(dev, report, ctc_model, ctc_batch, ctc_noise,
                               smi),
             "bf16": time_crdnn(dev, report, ctc_amp_model, ctc_batch,
                                ctc_amp_noise, smi, amp=True)}
    del ctc_model, ctc_amp_model
    h512 = time_k1_bf16_h512(dev, report, counts)
    report("phase 4 HMM_DNN_ALI's train step (forward type)")
    hmm_step = time_hmm(dev, report, smi)
    report("phase 4 fused_f32: the f32 builds in turns with the unfused f32 "
           "route and cuDNN f32; MD_VAE's f32 VAE step under "
           "MLVAE_PALLAS_FUSED=1 against the default")
    f32_rows, cli["fused_f32"]["times"] = time_fused_f32(
        dev, report, errs, counts, sw_model, sw_batch, sw_noise, smi)
    kernels += f32_rows
    del sw_model
    for row in kernels:   # the bf16 K1 rows: their H=512 numbers as well
        if row["name"] in ("lstm_fwd_wide_bf16", "lstm_bwd_wide_bf16"):
            row["h512"] = {t: h512[t][row["name"]] for t in ("T=80",
                                                              "T=160")}
            row["h512"]["launches_crdnn"] = h512["launches_crdnn"][
                row["name"]]
            row["h512"]["max_abs_err"] = errs["lstm_bf16_narrow"][
                "fwd" if "fwd" in row["name"] else "dgx"]
    for row in kernels:   # K1 at w2v_CRDNN_CTC's H=32 (phase 3)
        if row["name"] in ("lstm_fwd", "lstm_bwd"):
            h32 = cli["w2v"]["k1_h32"]
            row["h32"] = {"shapes_T_B": cli["w2v"]["k1_h32_shapes"],
                          "max_abs_err": h32["fwd" if row["name"] ==
                                             "lstm_fwd" else "dgx"],
                          "launches_cli_w2v": counts[row["name"]][
                              "launches_cli_w2v"]}
            if row["name"] == "lstm_bwd":
                row["h32"]["dw_max_rel_err"] = h32["dw"]
    report("phase 5 the kernels line, the card and the result")
    report(json.dumps({"kernels": kernels, "eval_step": step,
                       "lstm_fc": lstm_fc, "lstm_fc_amp": lstm_fc_amp,
                       "wav_in": wav_in, "train_step": train_step,
                       "amp_train_step": amp_step,
                       "sfl_train_step": sfl_step,
                       "gate3_train_step": gate3_step,
                       "gru_plans": k5_plans, "k7_plans": k7_plans,
                       "f32_fwd_plans": f32_fwd_plans,
                       "crdnn_ctc": crdnn,
                       "hmm_dnn_ali": hmm_step,
                       "bwd_timeline": bwd_timeline,
                       "fwd_timeline": fwd_timeline, "cli": cli}))
    report(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)

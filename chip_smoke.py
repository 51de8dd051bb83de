#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one GPU and check them.

Run from the root of a checkout, on a machine with an NVIDIA GPU, the
CUDA toolkit (``nvcc``) and PyTorch for CUDA:

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the script when it fails:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``medaka_tpu_torch/csrc`` with ``nvcc``
   (one process per source, all at once), and the host-side pileup and
   read-matrix library with ``g++``; print ptxas's registers, shared
   memory and spills of every kernel, by name for the cluster
   recurrences (``lstm_fwd_kernel``, ``lstm_bwd_kernel``,
   ``gru_cluster_bwd_kernel``, ``gru_cluster_fwd_kernel`` in both
   ``gru_train.cu`` and ``gru_fullfused.cu``, where its bf16-gates
   instantiations are also named apart, and ``lstm_fwd_kernel`` in
   ``bilstm.cu`` too), ``rnn_dw_kernel``, the projection stages
   ``bigru_proj_mma_kernel`` and ``bigru_proj_kernel``, and the split
   kernels (the cluster kernels, int8 ``gru_l1_split_s8_kernel`` and
   ``gru_l2head_split_s8_kernel`` and bf16 ``gru_l1_split_bf16_kernel``
   and ``gru_l2head_split_bf16_kernel``, and the per-block
   ``gru_l2head_split_kernel`` that bf16 layer 2 runs at H=384 and 512);
3. hold the split-path GRU kernels against their plain PyTorch versions
   at full width (H=256, 10 features, 5 classes, T=2000, ragged lengths)
   in all four numerics combinations: mode "t" at B=256 and mode "rows"
   at B=64, each with int8 quantisation on and off, and against
   themselves run again (bit for bit); layer 1 bit-identical to its plain
   version (int8: exact int32 sums; bf16: exact f64 sums, rounded once);
   the same at 9, 15 (the diploid head) and 16 classes
   over T=500; hold the bi-LSTM kernel (the LSTM cluster forward,
   both directions in one grid) against its plain version at H=128
   (B=128, T=1000) and H=384 (B=32, T=500), ragged lengths, random
   weights;
4. write a synthetic 0.5 Mb BAM at depth 20 and its draft;
5. the counts main path: ``medaka_tpu_torch inference`` with the bundled
   ``gru256_lambda_demo_model_pt`` at chunk_len 10000 and the automatic
   batch, then ``sequence``, through the CLI entry point in this process
   with the split kernels' launch counts set to 0 just before;
6. check its output: finite probabilities that sum to 1, the consensus
   identity to the draft, and the int8 kernels against the float32 scan
   on eight real chunks;
7. at its shape (the automatic batch, the most rows at which both
   split kernels run in one wave), hold each split kernel against its
   plain version (layer 1 bit for bit) and itself run again, and
   time it beside its plain version, its serial floor (one column), the
   cuDNN ``nn.GRU`` yardstick and its bound, at B=512 too, with each
   launch's geometry (cluster size, columns a cluster, shared memory,
   resident clusters) and the microseconds a step; a profile of each
   int8 launch must show the cluster kernel (``gru_l1_split_s8_kernel``,
   ``gru_l2head_split_s8_kernel``) and neither bf16 per-block kernel; the
   same for mode "rows" on 64 rows; the bf16 split kernels
   (``quant=False``, the ``recurrent_quant="none"`` path: the bf16
   cluster kernels ``gru_l1_split_bf16_kernel`` and
   ``gru_l2head_split_bf16_kernel``: f64 sums on the FP64 tensor cores)
   at the automatic batch in mode "t" and on 32 and 64 rows in mode
   "rows": each against its plain version (layer 1 bit for bit, the
   logits within 1e-3; the plain version timed once), their time,
   serial floor, bound (at the FP64 tensor cores' peak, beside the count
   at the bf16 peak),
   cuDNN's layer 1, each launch's geometry and microseconds a step, a
   profile of each launch, which must show the bf16 cluster kernel and
   no per-block split kernel, and their launches on one batch of that
   path; bf16 layer 2 at H=384 and 512, where
   ``GRUModel.forward(recurrent_quant="none")`` reaches the per-block
   ``gru_l2head_split_kernel``: a random model's forward on
   ``WIDE_BF16_B`` rows of ``WIDE_BF16_T`` steps (the per-block kernel
   launched, its profile), layer 2 against its plain version, its time,
   bound and the plain version's; ``gru_l2head_split`` with a
   15-class head on the same layer-1 outputs against its plain version,
   timed beside the 5-class launch (turns 5, 15, 15, 5) with its bound;
   then the variant paths (phase 20);
8. the read-level main path: ``inference`` with the bundled
   ``rl_lstm128_lambda_demo`` at chunk_len 1000, overlap 100 and the
   automatic batch, then ``sequence``, with the bi-LSTM kernel's launch
   count set to 0 just before; the same output checks;
9. on one full batch of that path: the model through the kernel against
   the model through the kernel's plain version, a stage breakdown
   (CUDA events), and the kernel's time beside its plain version, its
   serial floor (one column), the cuDNN ``nn.LSTM`` yardstick and its
   bound, its launch geometry and microseconds a step; a profile of one
   launch must show ``lstm_fwd_kernel`` and no ``bilstm_kernel``;
10. hold the GRU training kernels (``gru_fwd``, ``gru_bwd``: both on
    clusters of C blocks with W_hh in their shared memory, mma.sync)
    against their plain versions at full width (H=256, B=128, T=1000,
    ragged lengths, random weights, both directions), and ``gru_bwd``
    against itself run again (bit for bit);
11. the training path: a truth BAM for the synthetic genome, then
    ``features --truth`` and ``train`` (counts ``GRUModel`` at full width,
    batch 128, 2 epochs, bf16) through the CLI entry point, with the
    training kernels' launch counts set to 0 just before ``train``; check
    the losses (finite, falling), 4 launches of each kernel a step, a
    second run from the same seed, started in a child process and
    SIGKILLed once its resume snapshot names epoch 0, then ``train
    --resume`` in this process (epoch 0's losses the first run's, the
    resumed losses and the last checkpoint's weights the uninterrupted
    run's, bit for bit), and that the last checkpoint serves ``inference``
    + ``sequence``;
12. on one full batch of that data: one train step through the kernels
    against the same step through their plain versions, a stage
    breakdown of a step (CUDA events) with ``gru_fwd``'s share, the
    step's wall time, and each kernel's time beside its plain version, its
    serial floor, the cuDNN ``nn.GRU`` yardsticks (forward; backward
    alone), its bound, the microseconds a step and its launch geometry
    (cluster size, columns a cluster, shared memory, resident clusters) at
    the main shape and over one column; from the step's profile, each
    kernel's time a launch (``gru_bwd`` split into recurrence,
    ``rnn_dw_kernel`` and the sums), where the step's ``gru_fwd`` launches
    must show ``gru_cluster_fwd_kernel`` and no ``gru_rec_kernel``;
13. hold the LSTM training kernels (``lstm_fwd``, ``lstm_bwd``: clusters
    of C blocks with W_hh in their shared memory, mma.sync) against their
    plain versions at H=384 (clusters of 8) and H=128 (clusters of 2),
    B=128, T=1000, ragged lengths, random weights, both directions, and
    ``lstm_bwd`` against itself run again (bit for bit);
14. the read-level training path: a 0.5 Mb synthetic BAM with move
    tables (dwells) and its truth BAM, ``features --truth
    --feature_encoder ReadAlignmentFeatureEncoder`` at the encoder's
    defaults (max_reads 100, dwells), then ``train`` with no ``--model``
    (the full-width ``LatentSpaceLSTM``: lstm_size 384, cnn_size 128,
    kernel sizes 1 and 17), batch 128, 2 epochs, bf16, through the CLI
    entry point, with the LSTM kernels' launch counts set to 0 just
    before ``train``; check the losses (finite, falling), 4 launches of
    each kernel a step, the batch-norm running statistics moved off
    (0, 1), a second run from the same seed killed after epoch 0 and
    resumed as in phase 11, and that the last checkpoint serves
    ``inference`` + ``sequence``;
15. on one full batch of that data (B=128, T=1000, 100 reads, H=384):
    one train step through the kernels against the same step through
    their plain versions, a stage breakdown (CUDA events), the step's
    wall time, device-busy share and peak memory, and each LSTM kernel's
    time beside its plain version, its serial floor (one column), the
    microseconds a step, its launch geometry (cluster size, columns a
    cluster, resident clusters), the cuDNN ``nn.LSTM`` yardsticks
    (forward; backward alone), its bound and, for the backward, the
    profiler's split into recurrence, ``rnn_dw_kernel`` and the sums;
16. (run before phase 4) hold the fullfused bi-GRU kernels
    (``bigru_fullfused`` in its f32-gates and bf16-gates modes,
    ``bigru_fullfused_int8`` and ``bigru_fused``) against their plain
    versions at H=256, B=16, T=2000 for layer 1 (10 inputs) and layer 2
    (512 inputs), and through a 3-layer H=96 stack at B=31, T=500, ragged
    lengths with a padded row, each bit for bit on a second launch (the
    f32-gates and int8 modes: the tensor-core projection stage within one
    bf16 step of ``project_plain``, the recurrence against its plain
    version over the stage's projections); then
    ``gru_fwd`` and ``bigru_fused`` timed at that small width (H=96,
    B=31, T=500), each held against its plain version;
17. (after phase 9) the small-batch path: ``inference --batch_size 16``
    with the counts bundle, which runs off the split path, then
    ``sequence --qualities``, with the launch counts set to 0 just before:
    two launches of the f32-gates fullfused kernel a batch and none of the
    split kernels, identity >= 0.99; one batch of 16 through the model
    against the kernels' plain versions, in the f32-gates and the int8
    mode (each launch with its projection stage), and the entry points of
    the other modes (``recurrent_quant`` "bf16_gates" and "int8",
    ``bigru_stack_fused``) over it, the bf16-gates route against its plain
    version under the same bars;
18. the direct route: ``prediction.predict_direct`` at batch 16 (the same
    launches) and at the automatic batch (the split kernels), each
    byte-identical to the FASTQ of phase 17 or the FASTA of phase 5, gaps
    beds included;
19. each fullfused kernel on layer 2 of the bundle at B=16, T=10000,
    H=256: against its plain version, its time beside the plain
    version's, its serial floor, the cuDNN ``nn.GRU`` yardstick and its
    bound, the microseconds a step, the profiler's split into the
    projection stage and the recurrence and the launch geometry: a
    profiled f32-gates or int8 launch must run ``bigru_proj_mma_kernel``
    and ``gru_cluster_fwd_kernel`` (its instantiation of the mode) and
    neither ``bigru_proj_kernel`` nor the retired ``gru_rec_kernel``, a
    bf16-gates launch ``bigru_proj_kernel`` and the bf16-gates
    ``gru_cluster_fwd_kernel`` and neither ``bigru_proj_mma_kernel`` nor
    ``gru_rec_kernel``, ``bigru_fused`` the cluster recurrence alone; the
    bf16-gates row also gives its CUDA-core projection's bound and the
    share of its outputs that differ from the plain version's; the
    projection stage alone against ``project_plain``, timed beside its
    plain version, its bound and ``torch.addmm``; then print one
    ``kernels`` JSON line (twelve rows);
20. (after phase 7) the variant and SNP calling paths, each on a 0.5 Mb
    ``testing.create_variant_bam`` genome at depth 30 with its truth VCF
    (reads aligned without a mapper): ``inference --model
    gru256_variant_demo`` by name at the automatic batch, with the split
    kernels' launch counts set to 0 just before, then ``vcf`` and ``vcf
    --gvcf``; ``inference --model gru256_diploid_snp_demo`` (15 classes),
    then ``snp`` and ``snp --het_rescue 0.1``. Each path must launch both
    split kernels; the SNP/indel precision, recall and F1 (and genotype
    concordance) must meet ``testing.VARIANT_FLOORS``, which the CPU tests
    fix; ``--het_rescue 0.1`` must raise the diploid recall; the gVCF must
    hold the VCF's records and a reference row for each other column. The
    paths' launches, columns/s and scores go into the split kernels' rows
    of the ``kernels`` line;
21. (last, after phase 15; no profile follows it) the paths from reads,
    each through the CLI entry
    point with the split kernels' launch counts set to 0 just before and
    read just after (both kernels must launch on each), mapping and the
    host stages at ``--threads`` ``os.cpu_count()``: (a) the reads of phase
    4's genome as FASTQ (``testing.write_reads_fastq``), ``consensus
    --model gru256_lambda_demo`` (mapping, inference, stitch), then
    ``consensus --direct`` on the same mapped BAM: at least 99% of the
    reads with a primary, each within 50 bases of its true start on its
    strand, identity to the draft >= 0.99, the two FASTAs byte-identical;
    (b) the reads of a haploid genome of phase 20's generator, cut to
    ``FROM_READS_VARIANT_MB`` (0.1 Mb) for the time limit, through
    ``variant --model gru256_variant_demo`` with the annotation, its
    probabilities sharded over ``max(1, min(4, threads // 2))`` files (4
    at 8 threads: the manifest is checked): P/R/F1 at
    ``testing.FROM_READS_FLOORS``, every record annotated (DP, DPS, DPSP,
    SR, SC, AR), at each planted SNP called the alt allele's SR support
    above the ref's; (c) ``consensus --model gru256_variant_demo`` on (b)'s
    mapped BAM and ``tools consensus2vcf --mode NW`` against the
    reference, held to its floors; (d) ``consensus_joint`` on two read sets
    (DT r9 and r10) of a 0.1 Mb genome with a 20-feature ``GRUModel`` at
    H=256 with seeded random weights, and on one batch of the merged BAM's
    features (all its chunks) the model through the kernels against their
    plain versions under the network bar. The mapping, inference and annotation seconds,
    the thread count and the columns/s are printed; the paths' launches and
    records go into the split kernels' rows of the ``kernels`` line;
22. (after phase 23, before phase 21) the split kernels at the run-length
    bundle's shapes (``gru256_rle_demo``: 120 inputs, 49 classes) on the
    RLE path's first batch, at its automatic batch and in mode "rows" on
    64 rows: ``gru_l1_split`` and ``gru_l2head_split`` against their plain
    versions, int8 (T=10000; layer 1 bit for bit) and bf16 (T=1000), each
    run again bit for bit; timed beside the plain version, the serial
    floor, the bound and cuDNN's layer 1, with the launch geometry (the
    build phase prints ptxas's registers, shared memory and spills); the
    fullfused route of batches below 32 (f32 gates: the tensor-core
    projection at K=120 and the cluster recurrence) on 16 of the rows
    against its plain version. Two ``kernels`` rows,
    ``gru_l1_split/in120`` and ``gru_l2head_split/classes49``;
23. (before phase 22) the RLE path: ``compress_bam`` of phase 4's BAM over
    its first 60 kb (cut for the time limit) at ``--threads``
    ``os.cpu_count()``, then ``inference --model gru256_rle_demo`` at the
    automatic batch with the split kernels' launch counts set to 0 just
    before (both must launch) and ``sequence --no-fillgaps`` against the
    compact draft: finite 49-class probabilities that sum to 1, the
    expanded consensus's identity to the draft at least
    ``MIN_RLE_IDENTITY``; the same BAM over its first 20 kb (compact) on
    the card and with ``--cpu`` gives the same FASTA, or one that differs
    only where the two routes' argmax differs, each such column a near
    tie within the bars of phase 6 (the int8 kernels against a scan);
24. (before phase 21) the host pipeline options: ``inference
    --output_shards 4 --feature_processes 4`` on phase 4's BAM, whose
    manifest names 4 shards holding phase 5's samples bit for bit and
    whose ``sequence`` FASTA is phase 5's, with both runs' columns/s;
    ``consensus_from_features`` on the training phase's features; and
    ``inference --profile_dir`` in a fresh process, whose trace must name
    both int8 split kernels, with the share of the trace's wall time the
    device spends in kernels;
25. (after phase 15) ``train --validate_only`` of phases 11's and 14's
    last checkpoints through the CLI: loss and accuracy within
    ``TOL_VALIDATION`` of the last validation row of their training.csv,
    with the route taken (the split kernels, or ``bilstm_fused``) and its
    launches; the counts checkpoint again at ``--batch_size 16``, below
    32 rows: the fullfused kernels alone, a finite loss;
26. the reference's 2x128 ``GRUModel``: ``tools export`` of a random one
    gives the architecture TOML that ``train --model config.toml`` trains
    on phase 11's features (batch 128, 2 epochs, bf16; losses finite and
    falling, 4 launches of ``gru_fwd`` and ``gru_bwd`` a step); both
    kernels at H=128 (B=128, T=1000, both directions) against their plain
    versions as in phase 10 and timed as in phase 12; the last checkpoint
    written as a legacy reference checkpoint (the ``build_model_torch``
    partial, ``testing.write_reference_checkpoint``) serves ``inference``
    + ``sequence`` on phase 4's BAM with the native checkpoint's
    probabilities and FASTA, bit for bit (its identity to the draft
    printed: 8 steps of training, as phase 11's); ``gru_l1_split`` and
    ``gru_l2head_split`` at
    H=128 against their plain versions at the automatic batch in mode "t"
    (int8, T=10000; bf16 over ``REF_CHECK_T`` steps) and on 64 rows in
    mode "rows" (int8 and bf16), layer 1 bit for bit, timed beside
    their bounds, serial floors and cuDNN, with their geometry and
    ptxas's report (mode "rows" on 64 rows at T=10000 also beside its
    plain versions and cuDNN's layer 1 over those rows). Four ``kernels``
    rows: ``gru_l1_split/h128``,
    ``gru_l2head_split/h128``, ``gru_fwd/h128`` and ``gru_bwd/h128``;
27. phase 14's last checkpoint written as a reference checkpoint serves
    ``inference`` + ``sequence`` over phase 14's BAM cut to
    ``REF_RL_REGION_KB`` kb with the native checkpoint's probabilities,
    bit for bit (``bilstm_fused`` launches);
28. the reference's data files: phase 5's probabilities rewritten as
    reference medaka stores them (gzip-1 samples, pickled ``meta/``,
    ``testing.write_reference_probabilities``) give phase 5's FASTA
    through ``sequence``, byte for byte, at a read rate printed beside the
    uncompressed file's; a fast5 of planted Weibull tables for the reads
    over phase 4's first ``FAST5_REGION_KB`` kb
    (``testing.plant_fast5_tables``): ``compress_bam --use_fast5_info``
    and ``tools rlebam`` (spawned workers) tag every read with its
    planted table, with their seconds; ``tools export`` of the bundled
    counts model, whose ``weights.pt`` loads back equal;
29. (after phase 24, before phase 21) data-parallel inference on one
    card: phase 4's BAM through ``prediction.predict(devices=["cuda:0",
    "cuda:0"], batch_size=480)`` (240 rows a replica, mode "t", each
    replica on its own stream): probabilities within phase 6's
    whole-network bars of phase 5's (each differing argmax a near tie),
    the FASTA phase 5's but for those columns, each replica's launches,
    columns/s beside phase 5's; one 480-row batch bit for bit against one
    replica fed each half, and a 200-row one (mode "rows" on each
    replica) too; ``--batch_size 16`` over two replicas
    (``bigru_fullfused`` on 8 rows each) against the plain versions; one
    read-level batch over two replicas (``bilstm_fused``);
30. multi-process inference: two concurrent ``inference --num_processes
    2 --process_id i`` processes on the card (``--bam_chunk`` 250 kb, so
    each takes a share of the contig), ``sequence`` of both host files;
    the samples those of one process over the same work list, the FASTA
    within ``MAX_MULTI_PROCESS_EDITS`` of phase 5's; each process's
    launches and seconds;
31. data-parallel training on one card: ``run_training`` over two gloo
    ranks on cuda:0 against one nccl rank on phase 11's features (f32,
    ``SCALE_F32_SAMPLES`` rows an epoch and no validation pass: rows and
    last weights within ``TOL_RANKS_F32_*``), in bf16 at batch 128 for 2
    epochs (losses finite and falling, 4 ``gru_fwd`` and 4 ``gru_bwd`` a
    step in each rank), one read-level step on two ranks against one
    (loss and running batch-norm statistics within ``TOL_RANKS_RL_*``, 4
    ``lstm_fwd`` and 4 ``lstm_bwd`` in each rank), and ``train
    --model_parallel 2`` raising medaka_tpu's mesh error on one card.
    Two replicas or ranks share one card: no figure of these phases is a
    scale-out figure. Phases 11 and 14 train in a process group of one
    rank (nccl), printed;
32. (after phase 31, before phase 21) the smolecule workflow: a seeded
    grouped-subread FASTA (``testing.write_subreads_fasta``,
    ``SMOLECULE_MOLECULES`` molecules of ~``SMOLECULE_LENGTH`` bases) through
    ``smolecule --model gru256_lambda_demo --threads 8`` with the split
    kernels' counts set to 0 just before: both launched in mode "rows"
    (batches of 32 rows) and never in mode "t"; the median identity of the
    polished molecules to the true ones at least the POA drafts' and
    ``MIN_SMOLECULE_IDENTITY``; one 32-row batch of the run through both
    kernels against their plain versions (int8 layer 1 bit for bit, the
    bars of phase 3) and timed beside the plain versions, cuDNN and the
    bound; ``smolecule --cpu`` of the first ``SMOLECULE_CPU_MOLECULES``
    molecules within ``MAX_SMOLECULE_CPU_EDITS`` of the card's; the POA
    and neural seconds;
33. the tandem workflow: a seeded diploid STR genome
    (``testing.create_str_bam``: ``TANDEM_LOCI`` loci, depth
    ``TANDEM_DEPTH`` a haplotype) through ``tandem --phasing hybrid
    --workers 4`` and ``--phasing abpoa``, each also with ``--cpu``: the
    polish in full precision (the float32 scan, as ``medaka_tpu`` runs it;
    no split kernel launches), at least ``MIN_TANDEM_RECOVERED`` planted
    genotypes recovered, the card's VCF within ``MAX_TANDEM_CPU_RECORDS``
    records of ``--cpu``'s;
34. (after phase 20, before phase 21) the tools on the card's outputs:
    ``tools diploid2haploid`` of phase 20's diploid ``snp`` VCF and
    ``tools haploid2diploid`` of its halves (each record's position,
    alleles and unphased genotype back), ``tools classify_variants`` (the
    class files partition the records) and ``tools vcf2tsv`` (a row a
    record) of its haploid ``vcf`` output, ``tools homozygous_regions`` of
    the diploid VCF over the contig from inside the work directory,
    ``tools vcf2fasta`` of the truth VCF (the genome the reads were drawn
    from), ``tools hdf_to_bed`` of phase 20's probabilities (the contig
    covered); ``tools get_model_dtypes``, ``get_alignment_params``,
    ``is_rle_model`` and ``is_compatible`` on the bundled counts, RLE and
    read-level models; ``tools resolve_model --auto_model consensus`` of a
    FASTQ and a BAM naming a catalogue basecaller
    (``testing.write_basecaller_fastq``/``write_basecaller_bam``), then
    ``models.download_model`` of that model from a ``file://`` template
    (a copy of ``gru256_lambda_demo``) into a store under the work
    directory, and ``inference --model <the cached file>`` over
    ``TOOLS_REGION_KB`` kb of phase 4's BAM at the automatic batch with
    the split kernels' counts set to 0 just before (mode "t" launched),
    its probabilities bit for bit those of ``--model
    gru256_lambda_demo``; phase 5's probabilities written again through
    ``DataStore(compression="lzf")`` and read back (sample for sample),
    their ``sequence`` FASTA phase 5's byte for byte, the seconds and
    sizes printed; ``cli.version_report()`` naming the card and a loaded
    native library, and ``cli.counts_entry`` over ``TOOLS_REGION_KB`` kb
    of phase 4's BAM giving ``features.pileup_counts``'s rows. No call
    leaves the machine.

The last line of standard output is the device JSON object. The script
imports nothing of JAX and nothing of the ``medaka_tpu`` package.
"""
import argparse
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
MODEL = os.path.join(HERE, "medaka_tpu", "data",
                     "gru256_lambda_demo_model_pt.tar.gz")
RL_MODEL = os.path.join(HERE, "medaka_tpu", "data",
                        "rl_lstm128_lambda_demo.tar.gz")
KERNEL_SOURCE = "medaka_tpu_torch/csrc/gru_split.cu"
BILSTM_SOURCE = "medaka_tpu_torch/csrc/bilstm.cu"
TRAIN_SOURCE = "medaka_tpu_torch/csrc/gru_train.cu"
LSTM_TRAIN_SOURCE = "medaka_tpu_torch/csrc/lstm_train.cu"
REPLACES = {
    "gru_l1_split": "medaka_tpu/ops/pallas_gru.py:1371 "
                    "(_bigru_l1_split_t_kernel, mode t); :982 "
                    "(_bigru_l1_split_kernel, mode rows)",
    "gru_l2head_split": "medaka_tpu/ops/pallas_gru.py:1452 "
                        "(_bigru_l2head_t_kernel, mode t); :1055 "
                        "(_bigru_l2head_kernel, mode rows)",
    "bilstm_fused": "medaka_tpu/ops/pallas_gru.py:340 _bilstm_kernel "
                    "(bilstm_pallas :400)",
    "gru_fwd": "medaka_tpu/ops/pallas_gru.py:56 _gru_kernel (gru_pallas "
               ":105)",
    "gru_bwd": "medaka_tpu/ops/pallas_gru.py:1615 _gru_bwd_kernel "
               "(gru_bwd_pallas :1696)",
    "lstm_fwd": "medaka_tpu/ops/pallas_gru.py:1852 _lstm_kernel "
                "(lstm_pallas :1905)",
    "lstm_bwd": "medaka_tpu/ops/pallas_gru.py:1966 _lstm_bwd_kernel "
                "(lstm_bwd_pallas :2042)",
    "bigru_fullfused/f32_gates": "medaka_tpu/ops/pallas_gru.py:494 "
                                 "_bigru_fullfused_kernel (bigru_pallas_"
                                 "fullfused :675); :588 the staggered "
                                 "schedule, the same numerics",
    "bigru_fullfused/bf16_gates": "medaka_tpu/ops/pallas_gru.py:494 "
                                  "_bigru_fullfused_kernel, gates_bf16 "
                                  ":539-558 (bigru_pallas_fullfused :675)",
    "bigru_fullfused_int8": "medaka_tpu/ops/pallas_gru.py:760 "
                            "_bigru_fullfused_int8_kernel (bigru_pallas_"
                            "fullfused_int8 :844)",
    "bigru_fused": "medaka_tpu/ops/pallas_gru.py:165 _bigru_kernel "
                   "(bigru_pallas :229)",
    "bigru_project": "medaka_tpu/ops/pallas_gru.py:527-534, the projection "
                     "stage of _bigru_fullfused_kernel (bigru_pallas_"
                     "fullfused :675) and of _bigru_fullfused_int8_kernel "
                     "(bigru_pallas_fullfused_int8 :844)",
}
FULLFUSED_SOURCE = "medaka_tpu_torch/csrc/gru_fullfused.cu"
#: the int8 split kernels (csrc/gru_split.cu), by the row they serve
SPLIT_KERNELS = ("gru_l1_split_s8_kernel", "gru_l2head_split_s8_kernel")
SPLIT_KERNEL_OF = dict(zip(("gru_l1_split", "gru_l2head_split"),
                           SPLIT_KERNELS))
#: the bf16 (quant=False) split cluster kernels, by the row they serve
SPLIT_BF16_KERNELS = ("gru_l1_split_bf16_kernel",
                      "gru_l2head_split_bf16_kernel")
SPLIT_BF16_KERNEL_OF = dict(zip(("gru_l1_split", "gru_l2head_split"),
                                SPLIT_BF16_KERNELS))
#: the per-block split kernels: layer 1's is retired, layer 2's runs bf16
#: layer 2 only where no cluster holds its slices (H=384 and 512), never
#: at the shapes profiled here
PER_BLOCK_SPLIT_KERNELS = ("gru_l1_split_kernel", "gru_l2head_split_kernel")
#: the kernels a profile of one launch must show, and must not show, by
#: row: the cluster recurrence in the mode's numerics after the
#: tensor-core projection stage (f32 gates, int8) or the CUDA cores' stage
#: (bf16 gates), never the retired per-block recurrence
#: (``gru_rec_kernel``); the LSTM cluster forward for bilstm_fused
PROFILE_KERNELS = {
    "bigru_fullfused/f32_gates": (
        ("gru_cluster_fwd_kernel<0,", "bigru_proj_mma_kernel"),
        ("gru_rec_kernel", "bigru_proj_kernel")),
    "bigru_fullfused_int8": (
        ("gru_cluster_fwd_kernel<2,", "bigru_proj_mma_kernel"),
        ("gru_rec_kernel", "bigru_proj_kernel")),
    "bigru_fullfused/bf16_gates": (
        ("gru_cluster_fwd_kernel<1,", "bigru_proj_kernel"),
        ("gru_rec_kernel", "bigru_proj_mma_kernel")),
    "bigru_fused": (("gru_cluster_fwd_kernel<0,",), ("gru_rec_kernel",)),
    "bilstm_fused": (("lstm_fwd_kernel",), ("bilstm_kernel",)),
}
#: the GRU cluster forward's instantiations of each numerics mode, as
#: ptxas names them (mangled: gru_cluster_fwd_kernel<NUM, ...>)
FWD_PTXAS = {mode: "gru_cluster_fwd_kernelILi{}E".format(num)
             for mode, num in (("f32_gates", 0), ("bf16_gates", 1),
                               ("int8", 2))}
#: kernel mode of each fullfused row; "fused" is bigru_pallas (#6)
FULLFUSED_MODES = {"bigru_fullfused/f32_gates": "f32_gates",
                   "bigru_fullfused/bf16_gates": "bf16_gates",
                   "bigru_fullfused_int8": "int8", "bigru_fused": "fused"}
#: the batch of the small-batch path: below 32, so off the split path
SMALL_BATCH = 16
#: columns of phase 17's bf16-gates route against its plain versions (cut
#: from the batch's 10000 for the time limit)
BF16_ROUTE_T = 2000
#: head widths held against their plain versions besides the haploid 5:
#: the diploid head's 15 and the edges of the head's 16-wide tile, over
#: this many steps
HEAD_CHECK_CLASSES = (9, 15, 16)
# the haploid variant genome of phase 21 (b) and (c), Mb: phase 20's 0.5
# cut so that the whole script ends well inside its 1200 s (0.2 until
# phases 29-31 came)
FROM_READS_VARIANT_MB = 0.1
HEAD_CHECK_T = 500
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, int8 op/s,
# bf16 flop/s, f32 flop/s outside the tensor cores, f64 flop/s on the
# FP64 tensor cores
PEAK_BYTES = 3.35e12
PEAK_INT8 = 1979e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_F64_TC = 67e12
#: phase 7: rows and steps of bf16 layer 2 at H=384 and 512 (the
#: per-block kernel: a time on the path that reaches it, cut from the
#: main path's 480 x 10000 for the time limit)
WIDE_BF16_B = 64
WIDE_BF16_T = 1000
# bi-LSTM kernel vs its plain version: the same operations, f32 sums of
# the recurrent product in another order, which can move one bf16
# rounding of h: one bf16 step for |h| < 1
TOL_LSTM = 2.0 ** -8
# f32 operations per hidden unit and step besides the product: 8 gate
# adds, 3 sigmoids of 4 and 2 tanh of 1, 3 for c, 1 for h
LSTM_ELEMENTWISE_OPS = 26
# kernel vs plain version: both do the same operations; only the order of
# f32 sums differs (cuBLAS vs a sequential loop), which can move one
# round(127 h) or bf16 cast across a rounding boundary
TOL_L1 = {True: 1.0, False: 2.0 ** -7}   # one int8 step / one bf16 ulp
TOL_L1_MEAN = 1e-3
TOL_LOGIT = 1e-3
TOL_PROB = 1e-3
MIN_ARGMAX_AGREEMENT = 0.9999
# int8 split path vs the float32 scan on real chunks of T=10000: the
# quantisation error, not a kernel fault (the kernels match their plain
# versions). Mean and argmax agreement carry the check; the max is the
# worst of ~80,000 columns, where a near-tie moves the most probability.
TOL_SCAN_PROB_MAX = 5e-2
TOL_SCAN_PROB_MEAN = 1e-3
MIN_SCAN_ARGMAX_AGREEMENT = 0.999
# GRU training kernels vs their plain versions: the same operations, f32
# sums (the recurrent products, dW_hh, db_hh) in another order, which can
# move a bf16 rounding: forward outputs within one bf16 step, mean 1e-3;
# backward dxp, dW_hh, db_hh within 1e-3 of each tensor's largest
# magnitude. One train step through the kernels vs through the plain
# versions: loss within 1e-5 relative, each gradient within 1e-2 of its
# largest magnitude.
TOL_GRU_FWD = 2.0 ** -8
TOL_GRU_BWD = 1e-3
TOL_STEP_LOSS = 1e-5
TOL_STEP_GRAD = 1e-2
# f32 operations per hidden unit and step besides the products: forward
# 3 bias adds, 2 gate adds, 2 sigmoids of 4, r hp_n and its add, tanh, 4
# for h; backward the same gates (16) and 25 for the gradients, db_hh and
# dh
GRU_FWD_ELEMENTWISE_OPS = 20
GRU_BWD_ELEMENTWISE_OPS = 41
# LSTM training kernels vs their plain versions: the same operations, f32
# sums in another order: h within one bf16 step (mean 1e-3), c within
# 1e-3 of its largest magnitude; dxp, dW_hh, db_hh within 1e-3 of each
# tensor's largest magnitude (TOL_GRU_BWD). f32 operations per hidden
# unit and step besides the products: forward as LSTM_ELEMENTWISE_OPS;
# backward the same gates (21), c and tanh(c) (4), dc_tot and the four
# gate gradients (21), the valid masks (4), db_hh (4), the carried dh and
# dc (8) and the upstream add (1)
TOL_LSTM_C = 1e-3
LSTM_BWD_ELEMENTWISE_OPS = 63
# one read-level train step through the kernels vs through the plain
# versions: loss within TOL_STEP_LOSS, the LSTM stack's and the head's
# gradients within TOL_STEP_GRAD. Below the stack the gradient flows in
# bf16 (dxp is cast to the projections' bf16): the kernels' f32 sums in
# another order move some of those roundings by one step, and the conv,
# batch-norm and embedding gradients are sums over every read and
# position that cancel, so a small leaf can differ by a few percent of
# its largest element (2% on an H100 in the card tests); each of those
# leaves must point the same way
MIN_UPSTREAM_COSINE = 0.999
# the counts model through the fullfused f32-gates kernels vs through their
# plain versions on one batch of T=10000: the f32 sums of the recurrent
# product run in another order, which moves a bf16 rounding of a layer-1
# output now and then, and layer 2 carries it on over the steps; the mean
# and the argmax agreement carry the check, the max is the worst near-tie
# column
TOL_FULLFUSED_PROB_MAX = 1e-2


def log(*args):
    print(*args, flush=True)


@contextlib.contextmanager
def phase(name):
    log("== {}".format(name))
    t0 = time.perf_counter()
    yield
    log("   {} done in {:.1f} s".format(name, time.perf_counter() - t0))


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps=3, warmup=1):
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def ptxas_report(text, kernels):
    """{kernel: [{"entry", "registers", "smem_bytes", "stack_bytes",
    "spill_stores", "spill_loads"}, ...]} of the entry functions whose
    (mangled) name holds a kernel's name, from ``ptxas -v`` output."""
    out = {k: [] for k in kernels}
    rec = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            rec = {"entry": m.group(1)}
            continue
        if rec is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            rec.update(stack_bytes=int(m.group(1)),
                       spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            rec.update(registers=int(m.group(1)),
                       smem_bytes=int(smem.group(1)) if smem else 0)
            for k in kernels:
                if k in rec["entry"]:
                    out[k].append(rec)
            rec = None
    return out


def backward_alone_ms(module, x, g_out):
    """Time of cuDNN's backward alone: the forward once with its graph
    kept, then ``autograd.grad`` for the input and the weights over it."""
    import torch
    params = [x] + list(module.parameters())
    y = module(x)[0]
    try:
        return cuda_ms(lambda: torch.autograd.grad(y, params, g_out,
                                                   retain_graph=True))
    finally:
        del y


def yardstick_ms(features, width, depth, hidden, dev):
    """Time cuDNN's bf16 ``nn.GRU(width, hidden, depth, bidirectional)``.

    Layer 1 (``width`` = number of features) runs over ``features``; a
    layer over another width runs over zeros of that width and shape.
    """
    import torch
    rows, T, IN = features.shape
    x = (torch.from_numpy(features).to(dev, torch.bfloat16) if width == IN
         else torch.zeros((rows, T, width), dtype=torch.bfloat16,
                          device=dev))
    gru = torch.nn.GRU(width, hidden, depth, batch_first=True,
                       bidirectional=True).to(dev, torch.bfloat16)
    gru.flatten_parameters()   # one weight buffer, no copy on every call
    try:
        return cuda_ms(lambda: gru(x))
    finally:
        del gru, x
        torch.cuda.empty_cache()


def plain_agreement(kernel, plain, valid=None):
    """{"plain_ms", "max_abs_err", "mean_abs_err"} of a split kernel's
    outputs (``kernel()``) against its plain version's (``plain()``, timed
    once with CUDA events): over every element (layer 1) or over the
    ``valid`` (batch, step) columns (logits, no mean). Nothing of either
    outlives the call."""
    out = {}
    plain_ms = cuda_ms(lambda: out.update(ref=plain()), reps=1, warmup=0)
    err = mean = 0.0
    for got, ref in zip(kernel(), out.pop("ref")):
        diff = (got.float() - ref.float()).abs()
        if valid is not None:
            diff = diff[valid]
        err = max(err, diff.max().item())
        mean = max(mean, diff.mean().item())
    return {"plain_ms": plain_ms, "max_abs_err": err,
            "mean_abs_err": None if valid is not None else mean}


def random_net(rng, hidden=256, features=10, classes=5):
    import torch

    def direction(in_size):
        k = 1.0 / hidden ** 0.5
        return {name: torch.from_numpy(
            rng.uniform(-k, k, shape).astype("float32"))
            for name, shape in (("w_ih", (3 * hidden, in_size)),
                                ("w_hh", (3 * hidden, hidden)),
                                ("b_ih", (3 * hidden,)),
                                ("b_hh", (3 * hidden,)))}
    layers = [{"fwd": direction(features), "bwd": direction(features)},
              {"fwd": direction(2 * hidden), "bwd": direction(2 * hidden)}]
    k = 1.0 / (2 * hidden) ** 0.5
    head = {"w": torch.from_numpy(
                rng.uniform(-k, k, (classes, 2 * hidden)).astype("float32")),
            "b": torch.from_numpy(
                rng.uniform(-k, k, (classes,)).astype("float32"))}
    return layers, head


def run_layers(gru_split, w, xt, lengths, mode, quant):
    """Layer 1 then layer 2 + head, by kernel."""
    out_f, out_b = gru_split.gru_l1_split(
        xt, lengths, w["w_ih1"], w["b_ih1"], w["w_hh1"], w["sc1"],
        w["b_hh1"], mode=mode, quant=quant)
    lg_f, lg_b = gru_split.gru_l2head_split(
        out_f, out_b, lengths, w["w_in2"], w["in_scale2"], w["b_ih2"],
        w["w_hh2"], w["sc2"], w["b_hh2"], w["w_head"], mode=mode,
        quant=quant)
    return (out_f, out_b), (lg_f, lg_b)


def compare_kernels(gru_split, w, xt, lengths, mode, quant, plain_ms=None):
    """Each kernel against its plain version on the same inputs.

    Both kernels run twice and must repeat bit for bit; in int8, layer 1
    must equal its plain version bit for bit. Returns (l1 max err, l2 max
    logit err, network stats, kernel outputs); a ``plain_ms`` dict gets
    each plain version's time (CUDA events, that one run: layer 1's on
    the batch, layer 2's on the kernel's layer-1 outputs).
    """
    import torch
    T, B, _ = xt.shape
    (kf, kb), (kl_f, kl_b) = run_layers(gru_split, w, xt, lengths, mode,
                                        quant)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    events[0].record()
    pf, pb = gru_split.gru_l1_split_plain(
        xt, lengths, w["w_ih1"], w["b_ih1"], w["w_hh1"], w["sc1"],
        w["b_hh1"], mode=mode, quant=quant)
    events[1].record()
    # layer 2's plain version on the kernel's own layer-1 outputs
    ql_f, ql_b = gru_split.gru_l2head_split_plain(
        kf, kb, lengths, w["w_in2"], w["in_scale2"], w["b_ih2"],
        w["w_hh2"], w["sc2"], w["b_hh2"], w["w_head"], mode=mode,
        quant=quant)
    events[2].record()
    torch.cuda.synchronize()
    if plain_ms is not None:
        plain_ms["gru_l1_split"] = events[0].elapsed_time(events[1])
        plain_ms["gru_l2head_split"] = events[1].elapsed_time(events[2])
    valid = (torch.arange(T, device=xt.device)[None, :]
             < lengths[:, None].long())
    l1_err = max((a.float() - b.float()).abs().max().item()
                 for a, b in ((kf, pf), (kb, pb)))
    l1_mean = max((a.float() - b.float()).abs().mean().item()
                  for a, b in ((kf, pf), (kb, pb)))
    l2_err = max((a - b).abs()[valid].max().item()
                 for a, b in ((kl_f, ql_f), (kl_b, ql_b)))
    # a second launch gives the same bits (no atomics, fixed-order sums)
    (rf, rb), (rl_f, rl_b) = run_layers(gru_split, w, xt, lengths, mode,
                                        quant)
    if not all(torch.equal(a, b) for a, b in (
            (kf, rf), (kb, rb), (kl_f, rl_f), (kl_b, rl_b))):
        raise AssertionError("the split kernels do not repeat bit for bit "
                             "(mode {}, quant {})".format(mode, quant))
    del rf, rb, rl_f, rl_b
    # layer 1: every sum is exact (int8, and bf16's f64 sums) or in the
    # plain version's order
    if l1_err != 0:
        raise AssertionError("{} gru_l1_split differs from its plain "
                             "version: max {}".format(
                                 "int8" if quant else "bf16", l1_err))
    if l1_err > TOL_L1[quant] or l1_mean > TOL_L1_MEAN:
        raise AssertionError("gru_l1_split disagrees with its plain version:"
                             " max {} mean {}".format(l1_err, l1_mean))
    if l2_err > TOL_LOGIT:
        raise AssertionError("gru_l2head_split disagrees with its plain "
                             "version: max logit diff {}".format(l2_err))
    # the whole network, kernel path against plain path: layer 2's plain
    # version on layer 1's plain outputs, which is the run above where
    # those equal the kernel's (layer 1, checked exact)
    if torch.equal(pf, kf) and torch.equal(pb, kb):
        pl_f, pl_b = ql_f, ql_b
    else:
        pl_f, pl_b = gru_split.gru_l2head_split_plain(
            pf, pb, lengths, w["w_in2"], w["in_scale2"], w["b_ih2"],
            w["w_hh2"], w["sc2"], w["b_hh2"], w["w_head"], mode=mode,
            quant=quant)
    b_head = w["b_head"]
    pk = torch.softmax(kl_f + kl_b + b_head, -1)[valid]
    pp = torch.softmax(pl_f + pl_b + b_head, -1)[valid]
    diff = (pk - pp).abs()
    stats = {"max": diff.max().item(), "mean": diff.mean().item(),
             "argmax_agreement": (pk.argmax(-1) == pp.argmax(-1)).float()
             .mean().item()}
    if stats["max"] > TOL_PROB or \
            stats["argmax_agreement"] < MIN_ARGMAX_AGREEMENT:
        raise AssertionError(
            "kernel path disagrees with the plain path: {}".format(stats))
    return l1_err, l2_err, stats, (kf, kb)


def wide_bf16_layer2(gru_split, dev, seed):
    """bf16 layer 2 at H=384 and 512 on the path that reaches the
    per-block ``gru_l2head_split_kernel``: a seeded random ``GRUModel``'s
    forward with ``recurrent_quant="none"`` on ``WIDE_BF16_B`` ragged rows
    of ``WIDE_BF16_T`` steps (the profile must show that kernel after the
    bf16 layer-1 cluster kernel, and no layer-2 cluster kernel), then layer
    2 on layer 1's outputs against its plain version: the logits within
    ``TOL_LOGIT``, and layer 2's h bit for bit through a one-hot head
    (class k picks unit k H // C of each direction, so its logits are
    bf16(h) exactly); its time, launches, bound and the plain version's
    time. Returns {"H<H>": record}."""
    import numpy as np
    import torch
    from medaka_tpu_torch.models.gru import GRUModel
    rng = np.random.default_rng(seed)
    B, T, C = WIDE_BF16_B, WIDE_BF16_T, 5
    mode = gru_split.split_mode(B)
    want = (SPLIT_BF16_KERNEL_OF["gru_l1_split"], PER_BLOCK_SPLIT_KERNELS[1])
    refuse = (SPLIT_BF16_KERNEL_OF["gru_l2head_split"],) + SPLIT_KERNELS
    out = {}
    for H in (384, 512):
        torch.manual_seed(seed + H)
        model = GRUModel(num_features=10, num_classes=C, gru_size=H).to(dev)
        model.eval()
        x = torch.from_numpy(rng.random((B, T, 10)).astype("float32")).to(
            dev)
        lens = torch.from_numpy(rng.integers(T // 2, T + 1, B).astype(
            "int32"))
        lens[0] = T
        lens = lens.to(dev)
        rec = {"B": B, "T": T, "mode": mode,
               "route": gru_split.l2_route(H, C, False)}
        with torch.inference_mode():
            def forward():
                model(x, lengths=lens, compute_dtype=torch.bfloat16,
                      recurrent_quant="none")
            gru_split.reset_launches()
            forward()
            torch.cuda.synchronize()
            rec["launches"] = gru_split.LAUNCHES["gru_l2head_split"]
            for attempt in range(3):
                by_kernel = kernels_ms(forward)
                if trace_verdict(by_kernel, (want, refuse)) in ("ok",
                                                                "refused"):
                    break
                log_lost_trace("bf16 layer 2 H={}".format(H), by_kernel,
                               attempt)
            check_cluster_forward("bf16 layer 2 at H={}".format(H),
                                  by_kernel, (want, refuse))
            rec["profile_ms"] = {k: v for k, v in by_kernel.items()
                                 if "split" in k}
            w = gru_split.prepare_split_weights(
                model.layer_params(), model.head_params(), mode, False, dev)
            xt = x.transpose(0, 1).to(torch.bfloat16).contiguous()
            kf, kb = gru_split.gru_l1_split(
                xt, lens, w["w_ih1"], w["b_ih1"], w["w_hh1"], w["sc1"],
                w["b_hh1"], mode=mode, quant=False)
            args = [kf, kb, lens, w["w_in2"], w["in_scale2"], w["b_ih2"],
                    w["w_hh2"], w["sc2"], w["b_hh2"], w["w_head"]]
            valid = (torch.arange(T, device=dev)[None, :]
                     < lens[:, None].long())
            rec.update(plain_agreement(
                lambda: gru_split.gru_l2head_split(*args, mode=mode,
                                                   quant=False),
                lambda: gru_split.gru_l2head_split_plain(
                    *args, mode=mode, quant=False), valid))
            one_hot = torch.zeros_like(w["w_head"])
            one_hot[:, torch.arange(C), torch.arange(C) * H // C] = 1.0
            args[-1] = one_hot
            got = gru_split.gru_l2head_split(*args, mode=mode, quant=False)
            ref = gru_split.gru_l2head_split_plain(*args, mode=mode,
                                                   quant=False)
            rec["h_bit_for_bit"] = all(torch.equal(a, b)
                                       for a, b in zip(got, ref))
            del got, ref
            args[-1] = w["w_head"]
            rec["ms"] = cuda_ms(lambda: gru_split.gru_l2head_split(
                *args, mode=mode, quant=False))
            rec["bound_ms"], rec["bound_by"] = bound(
                "gru_l2head_split", B, H, 0, C, int(lens.sum()),
                quant=False)
            rec["step_us"] = rec["ms"] / T * 1e3
        log("   bf16 layer 2 at H={} ({} route): {}".format(
            H, rec["route"], json.dumps(rec)))
        if (rec["route"] != "per-block" or rec["launches"] < 1
                or rec["max_abs_err"] > TOL_LOGIT
                or not rec["h_bit_for_bit"]):
            raise AssertionError("bf16 layer 2 at H={}: {}".format(H, rec))
        out["H{}".format(H)] = rec
        del model, x, w, xt, kf, kb, args
        torch.cuda.empty_cache()
    return out


def bound(kind, B, H, IN, C, lengths_sum, quant=True, f64=True):
    """Least time (ms) for one call (int8, or bf16 where not ``quant``),
    and what bounds it.

    Bytes and operations are both counted over the valid columns of this
    run's data (``lengths_sum`` of them): a padded column is neither read
    nor computed, and its output holds no result that any consumer reads.
    Bytes: every valid input column and the weights read once, every
    valid output column written once, over the memory rate. Operations:
    int8 multiply-adds at the int8 peak, bf16 ones at the bf16 peak. With
    ``quant`` False the products of the recurrence (W_hh h and the input
    projections) are exact sums of bf16 products, f64 multiply-adds at the
    FP64 tensor cores' peak (``f64`` False: at the bf16 peak, as if
    rounded sums would do), their weights and layer 1's h two bytes a
    value; the head stays bf16.
    """
    dirs = 2
    q = 1 if quant else 2                       # bytes of a quantised value
    weights_f32 = dirs * 3 * 3 * H * 4          # two biases + scales
    if kind == "gru_l1_split":
        nbytes = (lengths_sum * IN * 2 + B * 4 + dirs * 3 * H * IN * 2
                  + dirs * 3 * H * H * q + weights_f32
                  + dirs * lengths_sum * H * q)
        int8_macs = dirs * lengths_sum * 3 * H * H
        bf16_macs = dirs * lengths_sum * 3 * H * IN
    else:
        nbytes = (dirs * lengths_sum * H * q + B * 4
                  + dirs * 3 * H * 2 * H * q + dirs * 3 * H * H * q
                  + weights_f32 + dirs * 2 * 3 * H * 4
                  + dirs * C * H * 4 + dirs * lengths_sum * C * 4)
        int8_macs = dirs * lengths_sum * (3 * H * 2 * H + 3 * H * H)
        bf16_macs = dirs * lengths_sum * C * H
    f64_macs = 0
    if not quant:
        exact = int8_macs + (bf16_macs if kind == "gru_l1_split" else 0)
        head = 0 if kind == "gru_l1_split" else bf16_macs
        f64_macs, bf16_macs, int8_macs = ((exact, head, 0) if f64
                                          else (0, head + exact, 0))
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (2 * int8_macs / PEAK_INT8 + 2 * bf16_macs / PEAK_BF16
             + 2 * f64_macs / PEAK_F64_TC) * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations"


def check_probabilities(datastore, hdf, classes=5):
    """Finite (n, ``classes``) probabilities summing to 1 in every sample
    of ``hdf`` and of its shards; returns (samples, columns)."""
    import numpy as np
    index = datastore.DataIndex(hdf)
    n_columns = 0
    # each sample from its own file: the base's or a shard's
    for sample in index.yield_from_feature_files(samples=index.samples):
        probs = sample.label_probs
        if probs.ndim != 2 or probs.shape[1] != classes or \
                not np.all(np.isfinite(probs)):
            raise AssertionError("bad probabilities " + sample.name)
        if np.abs(probs.sum(-1) - 1).max() > 1e-2:
            raise AssertionError("probabilities do not sum to 1")
        n_columns += probs.shape[0]
    return len(index.samples), n_columns


def consensus_identity(testing, fasta, draft):
    """(identity to the draft, edits, consensus length); the edits are the
    upper bound of ``testing.greedy_edit_count``."""
    from medaka_tpu_torch.io.fastx import FastaReader
    with FastaReader(draft) as fr:
        draft_seq = fr.fetch("synth")
    with FastaReader(fasta) as fr:
        consensus = fr.fetch("synth")
    edits = testing.greedy_edit_count(consensus.encode(), draft_seq.encode())
    return 1.0 - edits / len(draft_seq), edits, len(consensus)


def random_lstm_inputs(rng, H, B, T, dev):
    """bilstm_fused arguments: bf16 projections, uniform weights and
    biases as torch initialises them, ragged lengths (the first full)."""
    import torch
    k = 1.0 / H ** 0.5

    def uniform(lo, hi, shape):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype("float32"))

    lengths = torch.from_numpy(rng.integers(T // 2, T + 1, B).astype("int32"))
    lengths[0] = T
    return (uniform(-2, 2, (T, B, 4 * H)).to(dev, torch.bfloat16),
            uniform(-2, 2, (T, B, 4 * H)).to(dev, torch.bfloat16),
            uniform(-k, k, (2, 4 * H, H)).to(dev),
            uniform(-k, k, (2, 4 * H)).to(dev), lengths.to(dev))


def compare_bilstm(bilstm, args):
    """bilstm_fused against its plain version on the same inputs, both
    directions; returns (max, mean) absolute difference."""
    import torch
    got = bilstm.bilstm_fused(*args)
    want = bilstm.bilstm_fused_plain(*args)
    torch.cuda.synchronize()
    diffs = [(g.float() - w.float()).abs() for g, w in zip(got, want)]
    err = max(d.max().item() for d in diffs)
    mean = max(d.mean().item() for d in diffs)
    if err > TOL_LSTM or mean > TOL_L1_MEAN:
        raise AssertionError("bilstm_fused disagrees with its plain version:"
                             " max {} mean {}".format(err, mean))
    return err, mean


def timed_stage(events, name, fn):
    """``fn()``; with an ``events`` list, between two CUDA events appended
    to it as (name, start, stop)."""
    import torch
    if events is None:
        return fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    events.append((name, start, stop))
    return out


def read_level_stages(model, bilstm, x, lengths, plain=False, events=None):
    """``LatentSpaceLSTM``'s bf16 forward stage by stage, the LSTM stack as
    ``bilstm_stack_fused`` runs it; returns the logits.

    :param plain: run the kernel's plain version in its place.
    :param events: a list to which (stage, start, stop) CUDA events are
        appended.
    """
    import torch
    cd = torch.bfloat16
    layer_fn = bilstm.bilstm_fused_plain if plain else bilstm.bilstm_fused

    def stage(name, fn, *args):
        return timed_stage(events, name, lambda: fn(*args))

    def projections(out, fwd, bwd):
        return (bilstm.project(out, fwd["w_ih"], fwd["b_ih"], cd),
                bilstm.project(out, bwd["w_ih"], bwd["b_ih"], cd))

    feats, non_empty = stage("embed + convs + BN", model.read_features, x,
                             cd)
    pooled = stage("mean-pool + pre_pool", model.pool, feats, non_empty, cd)
    del feats
    out = pooled.transpose(0, 1)
    for k, layer in enumerate(model.layer_params(), start=1):
        fwd, bwd = layer["fwd"], layer["bwd"]
        xp_f, xp_b = stage("projections, layer {}".format(k), projections,
                           out, fwd, bwd)
        w_hh = torch.stack([fwd["w_hh"], bwd["w_hh"]])
        b_hh = torch.stack([fwd["b_hh"], bwd["b_hh"]])
        out_f, out_b = stage("bilstm_fused, layer {}".format(k), layer_fn,
                             xp_f, xp_b, w_hh, b_hh, lengths)
        out = torch.cat([out_f, out_b], dim=-1)
    return stage("head", model.head, out.transpose(0, 1))


def bilstm_bound(B, H, lengths_sum):
    """Least time (ms) of one bilstm_fused call, and what bounds it.

    Counted over the valid columns (``lengths_sum``), as for the split
    kernels. Bytes: both directions' bf16 projections read and bf16
    outputs written once, the f32 W_hh and b_hh and the lengths read
    once, over the memory rate. Operations: the recurrent products
    (2 x 4H x H multiply-adds per direction, column and step) at the bf16
    tensor-core peak, plus LSTM_ELEMENTWISE_OPS f32 operations per unit,
    direction and step at the f32 peak.
    """
    G = 4 * H
    nbytes = (2 * lengths_sum * G * 2 + 2 * lengths_sum * H * 2
              + 2 * G * H * 4 + 2 * G * 4 + B * 4)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (2 * 2 * lengths_sum * G * H / PEAK_BF16
             + 2 * lengths_sum * H * LSTM_ELEMENTWISE_OPS / PEAK_F32) * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations"


def train_bound(name, B, H, lengths_sum):
    """Least time (ms) of one gru_fwd, gru_bwd, lstm_fwd or lstm_bwd call,
    what bounds it, and the bytes counted.

    Counted over the valid columns (``lengths_sum``), as for the other
    kernels. A forward reads the bf16 projections and writes the bf16
    outputs (the LSTM also its f32 cell states); a backward reads the bf16
    projections and outputs (the LSTM also the f32 cell states) and the
    f32 upstream gradient and writes the f32 dxp; all read the f32 W_hh,
    b_hh and the lengths, and a backward writes dW_hh and db_hh, once.
    Operations: the recurrent products (one in a forward; in a backward
    the recomputed gates, the dh product and dW_hh), 2 x G x H each per
    column (G = 3H gate rows for the GRU, 4H for the LSTM), at the bf16
    tensor-core peak, plus the f32 gate arithmetic at the f32 peak.
    """
    lstm = name.startswith("lstm")
    G = (4 if lstm else 3) * H
    cells = H * 4 if lstm else 0
    weights = G * H * 4 + G * 4 + B * 4
    if name.endswith("fwd"):
        nbytes = lengths_sum * (G * 2 + H * 2 + cells) + weights
        products = 1
        elementwise = LSTM_ELEMENTWISE_OPS if lstm else \
            GRU_FWD_ELEMENTWISE_OPS
    else:
        nbytes = (lengths_sum * (G * 2 + H * 2 + cells + H * 4 + G * 4)
                  + weights + G * H * 4 + G * 4)
        products = 3
        elementwise = LSTM_BWD_ELEMENTWISE_OPS if lstm else \
            GRU_BWD_ELEMENTWISE_OPS
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (products * 2 * lengths_sum * G * H / PEAK_BF16
             + lengths_sum * H * elementwise / PEAK_F32) * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes
    return t_ops, "operations", nbytes


def random_direction(rng, H, B, T, dev, gates=3):
    """gru_fwd (``gates`` 3) or lstm_fwd (4) arguments and an upstream
    gradient: bf16 projections, uniform weights and biases as torch
    initialises them, ragged lengths (the first full)."""
    import torch
    k = 1.0 / H ** 0.5

    def uniform(lo, hi, shape):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype("float32"))

    lengths = torch.from_numpy(rng.integers(T // 2, T + 1, B).astype("int32"))
    lengths[0] = T
    dh_out = torch.from_numpy(rng.standard_normal((T, B, H)).astype(
        "float32")).to(dev, torch.bfloat16).float()
    return (uniform(-2, 2, (T, B, gates * H)).to(dev, torch.bfloat16),
            uniform(-k, k, (gates * H, H)).to(dev),
            uniform(-k, k, (gates * H,)).to(dev), lengths.to(dev), dh_out)


def compare_gru_train(gru_train, xp, w_hh, b_hh, lengths, dh_out, reverse):
    """gru_fwd and gru_bwd against their plain versions (the backward on
    the kernel's forward outputs), and gru_bwd against itself; returns
    {"fwd_max", "fwd_mean", "dxp", "dW_hh", "db_hh"} (backward: largest
    difference over the tensor's largest magnitude)."""
    import torch
    out = gru_train.gru_fwd(xp, w_hh, b_hh, lengths, reverse)
    ref = gru_train.gru_fwd_plain(xp, w_hh, b_hh, lengths, reverse)
    got = gru_train.gru_bwd(xp, out, dh_out, w_hh, b_hh, lengths, reverse)
    want = gru_train.gru_bwd_plain(xp, out, dh_out, w_hh, b_hh, lengths,
                                   reverse)
    again = gru_train.gru_bwd(xp, out, dh_out, w_hh, b_hh, lengths, reverse)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    stats = {"fwd_max": diff.max().item(), "fwd_mean": diff.mean().item()}
    for name, g, w in zip(("dxp", "dW_hh", "db_hh"), got, want):
        stats[name] = ((g - w).abs().max() / w.abs().max()).item()
    if stats["fwd_max"] > TOL_GRU_FWD or stats["fwd_mean"] > TOL_L1_MEAN:
        raise AssertionError("gru_fwd disagrees with its plain version: "
                             "{}".format(stats))
    if max(stats["dxp"], stats["dW_hh"], stats["db_hh"]) > TOL_GRU_BWD:
        raise AssertionError("gru_bwd disagrees with its plain version: "
                             "{}".format(stats))
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError("gru_bwd does not repeat bit for bit")
    return stats


def staged_train_step(model, optimizer, batch, gru_train, parallel,
                      events=None, plain=False, update=True):
    """One bf16 train step of ``GRUModel`` stage by stage, as
    ``parallel.make_train_step`` runs it; returns the loss.

    :param events: a list to which (stage, start, stop) CUDA events are
        appended.
    :param plain: the training kernels' plain versions in their place.
    :param update: apply the optimizer (else leave the gradients).
    """
    import torch
    cd = torch.bfloat16

    def stage(name, fn):
        return timed_stage(events, name, fn)

    params = list(model.parameters())
    for p in params:
        p.grad = None
    lengths = batch["lengths"]
    out = batch["features"].transpose(0, 1).to(cd)
    for layer in model.layer_params():
        dirs = (("fwd", False), ("bwd", True))
        xps = stage("projections", lambda out=out, layer=layer: [
            gru_train.project(out, layer[d]["w_ih"], layer[d]["b_ih"], cd)
            for d, _ in dirs])
        out = stage("gru_fwd x4", lambda xps=xps, layer=layer: torch.cat([
            gru_train.GRUDirection.apply(
                xp, layer[d]["w_hh"], layer[d]["b_hh"], lengths, rev, plain)
            for xp, (d, rev) in zip(xps, dirs)], dim=-1))
    feats = out.transpose(0, 1)

    def head_loss():
        logits = (feats.float() @ model.linear.weight.float().t()
                  + model.linear.bias.float())
        return parallel.masked_cross_entropy(logits, batch)

    loss = stage("head + loss", head_loss)
    stage("backward (gru_bwd x4, projection gradients)", loss.backward)
    if update:
        stage("optimizer (clip + adam)",
              lambda: parallel.apply_updates(params, optimizer))
    return loss


def kernels_ms(fn):
    """Device time (ms) by CUDA kernel over one call of ``fn`` (the
    profiler's CUPTI trace); None, reported, where the profiler cannot
    trace the card (the measurement tool, not the program)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        by_kernel = {}
        for evt in prof.key_averages():
            # kernels only: an operator's own row repeats its kernels' time
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
            if us > 0:
                name = evt.key.replace("(anonymous namespace)::", "")
                name = name.split("(")[0][:80]
                by_kernel[name] = by_kernel.get(name, 0.0) + us / 1e3
    except Exception as e:
        log("   torch.profiler could not trace the card: {}".format(e))
        return None
    return by_kernel


def bare(name):
    """A profiler's kernel name without the "void " it gives a template
    kernel and not a plain one."""
    return name[5:] if name.startswith("void ") else name


def split_ms(by_kernel, prefixes, launches=1):
    """{prefix: ms a launch} of the kernels whose profiler names start with
    each prefix (with or without "void "), over ``launches`` launches of
    each."""
    return {p: sum(v for k, v in (by_kernel or {}).items()
                   if bare(k).startswith(bare(p))) / launches
            for p in prefixes}


def trace_verdict(by_kernel, kernels):
    """What a profile (``kernels_ms``) shows against ``kernels`` (a
    :data:`PROFILE_KERNELS` pair of prefixes to want and to refuse):
    "empty" (no kernel recorded), "refused" (a kernel starting with a
    refused prefix), "incomplete" (a wanted prefix matches no kernel: the
    trace lost a launch, as CUPTI now and then drops the first kernel of
    a trace) or "ok"."""
    if not by_kernel:
        return "empty"
    want, refuse = kernels
    names = [bare(k) for k in by_kernel]
    if any(k.startswith(tuple(bare(r) for r in refuse)) for k in names):
        return "refused"
    if not all(any(k.startswith(bare(w)) for k in names) for w in want):
        return "incomplete"
    return "ok"


def check_cluster_forward(name, by_kernel,
                          kernels=PROFILE_KERNELS["bigru_fused"]):
    """Fail unless a profile (``kernels_ms``) of ``name``'s launches shows
    a kernel starting with each prefix of ``kernels[0]`` and none starting
    with a prefix of ``kernels[1]`` (:data:`PROFILE_KERNELS`; by default an
    f32-gates GRU forward: ``gru_fwd``, ``bigru_fused``, ``bigru_fullfused``'s
    default mode, which must run ``gru_cluster_fwd_kernel`` and no
    ``gru_rec_kernel``), or if there is no profile to check."""
    verdict = trace_verdict(by_kernel, kernels)
    if verdict == "empty":
        raise AssertionError("no profile of {}: its kernels cannot be "
                             "checked".format(name))
    if verdict != "ok":
        raise AssertionError("{} ran {}".format(name, sorted(by_kernel)))


#: one fullfused launch (or, in mode "fused", ``bigru_fused`` over its
#: projections) of random inputs profiled in a fresh process: argv =
#: checkout, mode, T, B, IN, H; prints {kernel: ms} as JSON
PROFILE_CHILD = r"""
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from medaka_tpu_torch.ops import bilstm, gru_fullfused
mode = sys.argv[2]
T, B, IN, H = (int(v) for v in sys.argv[3:7])
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)
def u(*shape):
    return (torch.rand(*shape, device=dev, generator=g) * 2 - 1) / H ** 0.5
if mode == "bilstm":
    import numpy as np
    args = cs.random_lstm_inputs(np.random.default_rng(0), H, B, T, dev)
    launch = lambda: bilstm.bilstm_fused(*args)
else:
    x = (u(T, B, IN) * H ** 0.5).to(torch.bfloat16)
    w = (u(2, 3 * H, IN), u(2, 3 * H), u(2, 3 * H, H), u(2, 3 * H))
    lengths = torch.full((B,), T, dtype=torch.int32, device=dev)
    launch = cs.fullfused_calls(gru_fullfused, mode, x, w, lengths)[0]
launch()
torch.cuda.synchronize()
name = {v: k for k, v in cs.FULLFUSED_MODES.items()}.get(mode,
                                                         "bilstm_fused")
by_kernel = {}
for _ in range(3):
    by_kernel = cs.kernels_ms(launch) or {}
    if cs.trace_verdict(by_kernel, cs.PROFILE_KERNELS[name]) not in (
            "empty", "incomplete"):
        break
print(json.dumps(by_kernel))
"""


def child_profile(mode, T, B, IN, H):
    """{kernel: ms} of one fullfused launch in mode ``mode`` (or
    ``bigru_fused``'s, mode "fused"; ``bilstm_fused``'s, mode "bilstm",
    IN unused) at (T, B, IN, H) on random inputs,
    profiled in a fresh process (:data:`PROFILE_CHILD`; the kernels are
    already built); {} where that trace is empty too."""
    proc = subprocess.run(
        [sys.executable, "-c", PROFILE_CHILD, HERE, mode, str(T), str(B),
         str(IN), str(H)], capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError("the profile process failed: {}".format(
            proc.stderr[-2000:]))
    return json.loads(proc.stdout.strip().splitlines()[-1])


def log_lost_trace(name, by_kernel, attempt):
    """Say that trace ``attempt`` (from 0) of ``name`` recorded no kernel,
    or which kernels it recorded where it lacks a wanted one."""
    if not by_kernel:
        log("   the profiler recorded no kernel of {} (trace {})".format(
            name, attempt + 1))
    else:
        log("   the profiler's trace {} of {} lacks a kernel it must show; "
            "it recorded {}".format(attempt + 1, name, sorted(by_kernel)))


def cluster_launch_ms(name, fn, prefixes,
                      kernels=PROFILE_KERNELS["bigru_fused"], child=None):
    """{prefix: ms} of the kernels of one call of ``fn`` (the profiler),
    a launch of ``name``, checked by :func:`check_cluster_forward` against
    ``kernels``; a trace that records no kernel at all (the measurement
    tool now and then returns one, and in one process it returned only
    such traces of the bf16-gates launch after the other modes' profiles)
    is taken once more, and so is one that lacks a wanted kernel but shows
    no refused one (:func:`trace_verdict`); then, where ``child`` is
    given, ``child()`` profiles the same launch on random inputs of the
    same shape in a fresh process (the result then says "profiled":
    "child"). A refused kernel fails at once. (A bf16-gates or
    ``bigru_fused`` trace that came back empty once has come back empty on
    every retry in this process, up to five, and the child profiled it.)"""
    import torch
    by_kernel, how = None, "this process"
    for attempt in range(2):
        torch.cuda.synchronize()
        by_kernel = kernels_ms(fn)
        verdict = trace_verdict(by_kernel, kernels)
        if verdict in ("ok", "refused"):
            break
        log_lost_trace(name, by_kernel, attempt)
        time.sleep(0.5)
    else:
        if child is not None:
            by_kernel, how = child(), "child"
    check_cluster_forward(name, by_kernel, kernels)
    out = split_ms(by_kernel, prefixes)
    if how == "child":
        out["profiled"] = "child"
    return out


def split_launch_ms(name, fn, quant=True):
    """{kernel: ms} of one int8 (``quant``) or bf16 launch of split kernel
    ``name`` (the profiler): it must run its cluster kernel in those
    numerics (:data:`SPLIT_KERNEL_OF`, :data:`SPLIT_BF16_KERNEL_OF`), not
    the other numerics' and no per-block split kernel
    (:data:`PER_BLOCK_SPLIT_KERNELS`); an empty trace is taken again, up
    to three times, and so is one that lacks the cluster kernel but shows
    no refused one (:func:`trace_verdict`)."""
    want, other = ((SPLIT_KERNEL_OF, SPLIT_BF16_KERNEL_OF) if quant
                   else (SPLIT_BF16_KERNEL_OF, SPLIT_KERNEL_OF))
    kernels = ((want[name],), (other[name],) + PER_BLOCK_SPLIT_KERNELS)
    for attempt in range(3):
        by_kernel = kernels_ms(fn)
        if trace_verdict(by_kernel, kernels) in ("ok", "refused"):
            break
        log_lost_trace(name, by_kernel, attempt)
    check_cluster_forward(name, by_kernel, kernels)
    return {k: v for k, v in by_kernel.items() if "split" in k}


def profile_step(step, step_s):
    """Device time by CUDA kernel over one call of ``step``, and the
    device's busy share of the step's wall time ``step_s``; a profiler that
    cannot trace the card is reported, not fatal (the CUDA-event stages
    stand)."""
    by_kernel = kernels_ms(step)
    if by_kernel is None:
        return None
    device_ms = sum(by_kernel.values())
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12])
    out = {"device_ms": device_ms,
           "device_busy_share": device_ms / (step_s * 1e3),
           "top_kernels_ms": top,
           # every kernel, for the caller (not reported whole)
           "kernels_ms": by_kernel}
    log("   profiler: device time {:.2f} ms ({:.1%} of the step's wall "
        "time); by kernel: {}".format(device_ms, out["device_busy_share"],
                                     json.dumps(top)))
    return out


def csv_table(path):
    """(header, data rows) of a training.csv, each row a list of fields;
    a torn last line (a kill mid-write) fails."""
    with open(path) as fh:
        text = fh.read()
    if text and not text.endswith("\n"):
        raise AssertionError("{} ends in a torn line".format(path))
    rows = [line.split(",") for line in text.splitlines()]
    return rows[0], rows[1:]


def checkpoint_arrays(path):
    """The weights of a bundle, by key."""
    import tarfile

    import numpy as np
    with tarfile.open(path) as tar, np.load(
            tar.extractfile("model/weights.npz")) as npz:
        return {k: npz[k] for k in npz.files}


def check_one_rank_group(parallel):
    """``train`` on one card runs in a process group of one nccl rank."""
    group = dict(parallel.LAST_GROUP)
    log("   process group: {} of {} rank(s)".format(group.get("backend"),
                                                   group.get("size")))
    if group != {"backend": "nccl", "size": 1}:
        raise AssertionError("train did not run in a one-rank nccl group: "
                             "{}".format(group))


def killed_and_resumed(cli, train_cmd, run, again, label):
    """The second same-seed run of a training path, killed and resumed:
    ``train`` with the same arguments in a child process, SIGKILLed once
    its resume snapshot names epoch 0, then ``train --resume`` through the
    CLI entry point in this process. The child's epoch-0 rows must equal
    the first run's (the determinism check, across processes); the
    resumed rows and the last checkpoint's weights must equal the
    uninterrupted run's bit for bit. Returns what it measured."""
    import signal

    import torch
    keep = ("split", "epoch", "batch", "loss", "acc")
    snap = os.path.join(again, "resume.json")
    os.makedirs(again, exist_ok=True)
    child_log = os.path.join(again, "child.log")
    # the child needs the card's memory that this process's allocator
    # keeps cached from the first run
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with open(child_log, "w") as err:
        child = subprocess.Popen(
            [sys.executable, "-m", "medaka_tpu_torch"] + train_cmd
            + ["--train_name", again], cwd=HERE, stdout=err, stderr=err)
        try:
            while not os.path.exists(snap):
                if child.poll() is not None:
                    with open(child_log) as fh:
                        tail = fh.read()[-3000:]
                    raise AssertionError(
                        "{}: the child train exited with {} before its "
                        "first snapshot: {}".format(label, child.returncode,
                                                    tail))
                if time.perf_counter() - t0 > 600:
                    raise AssertionError("{}: no snapshot in 600 s".format(
                        label))
                time.sleep(0.002)
            child.send_signal(signal.SIGKILL)
            child.wait()
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
    t_kill = time.perf_counter() - t0
    with open(snap) as fh:
        snap_epoch = json.load(fh)["epoch"]
    if snap_epoch != 0:
        raise AssertionError("{}: the child passed epoch 0 before the kill "
                             "(snapshot of epoch {})".format(label,
                                                             snap_epoch))
    header, first = csv_table(os.path.join(run, "training.csv"))
    col = {name: i for i, name in enumerate(header)}

    def fields(rows):
        return [[r[col[k]] for k in keep] for r in rows]
    _, child_rows = csv_table(os.path.join(again, "training.csv"))
    t1 = time.perf_counter()
    if cli.main(train_cmd + ["--train_name", again, "--resume"]) != 0:
        raise AssertionError("{}: train --resume failed".format(label))
    t_resume = time.perf_counter() - t1
    _, rows = csv_table(os.path.join(again, "training.csv"))
    resumed = rows[len(child_rows):]
    epoch0 = [r for r in first if r[col["epoch"]] == "0"]
    later = [r for r in first if r[col["epoch"]] != "0"]
    if fields(child_rows[:len(epoch0)]) != fields(epoch0):
        raise AssertionError("{}: the child's epoch 0 logged other losses "
                             "than the first run's".format(label))
    # rows of epoch 1 the child logged before the kill, if any
    partial = child_rows[len(epoch0):]
    if fields(partial) != fields(later[:len(partial)]) or \
            fields(resumed) != fields(later):
        raise AssertionError(
            "{}: the resumed run logged other losses than the uninterrupted "
            "one: {} vs {}".format(label, fields(resumed), fields(later)))
    last = "model-{}.tar.gz".format(first[-1][col["epoch"]])
    a = checkpoint_arrays(os.path.join(run, last))
    b = checkpoint_arrays(os.path.join(again, last))
    if a.keys() != b.keys() or any(a[k].tobytes() != b[k].tobytes()
                                   for k in a):
        raise AssertionError("{}: the resumed run's {} differs from the "
                             "uninterrupted run's".format(label, last))
    out = {"child_s_to_kill": t_kill, "resume_s": t_resume,
           "child_rows": len(child_rows), "resumed_rows": len(resumed),
           "weights_bit_identical": True}
    log("   child killed after its epoch-0 snapshot ({:.1f} s, {} rows "
        "logged); train --resume {:.1f} s: epoch 0 and the {} resumed rows "
        "equal the first run's, {} bit-identical".format(
            t_kill, len(child_rows), t_resume, len(resumed), last))
    return out


def gru_train_timings(gru_train, model, batch, rng, dev):
    """gru_fwd and gru_bwd on layer 2's forward direction of a trained
    ``GRUModel`` over a training ``batch`` (layer 1 through the kernels):
    against their plain versions (the main shape's agreement), timed
    beside the plain versions and one column, with each launch's
    geometry, and cuDNN's bf16 ``nn.GRU(2H, H)`` over the same rows as the
    yardstick. Returns (timed {name: (ms, plain ms, one-column ms)},
    geometry, main-shape agreement, {"fwd", "bwd", "fwd_bwd"} cuDNN
    ms)."""
    import torch
    B, T = batch["features"].shape[:2]
    H = model.gru_size
    layer1, layer2 = model.layer_params()
    with torch.no_grad():
        x1 = batch["features"].transpose(0, 1).to(torch.bfloat16)
        lens = batch["lengths"]
        h1 = torch.cat([gru_train.gru_fwd(
            gru_train.project(x1, layer1[d]["w_ih"], layer1[d]["b_ih"]),
            layer1[d]["w_hh"], layer1[d]["b_hh"], lens, rev)
            for d, rev in (("fwd", False), ("bwd", True))], dim=-1)
        p2 = layer2["fwd"]
        xp = gru_train.project(h1, p2["w_ih"], p2["b_ih"])
        w_hh, b_hh = p2["w_hh"].detach(), p2["b_hh"].detach()
        out = gru_train.gru_fwd(xp, w_hh, b_hh, lens)
        dh_out = torch.from_numpy(rng.standard_normal((T, B, H)).astype(
            "float32")).to(dev, torch.bfloat16).float()
        main_stats = compare_gru_train(gru_train, xp, w_hh, b_hh, lens,
                                       dh_out, False)
        one = (xp[:, :1].contiguous(), lens[:1])
        out1 = gru_train.gru_fwd(one[0], w_hh, b_hh, one[1])
        calls = {
            "gru_fwd": (
                lambda: gru_train.gru_fwd(xp, w_hh, b_hh, lens),
                lambda: gru_train.gru_fwd_plain(xp, w_hh, b_hh, lens),
                lambda: gru_train.gru_fwd(one[0], w_hh, b_hh, one[1])),
            "gru_bwd": (
                lambda: gru_train.gru_bwd(xp, out, dh_out, w_hh, b_hh,
                                          lens),
                lambda: gru_train.gru_bwd_plain(xp, out, dh_out, w_hh,
                                                b_hh, lens),
                lambda: gru_train.gru_bwd(one[0], out1, dh_out[:, :1]
                                          .contiguous(), w_hh, b_hh,
                                          one[1])),
        }
        timed = {name: (cuda_ms(k), cuda_ms(pl, reps=1, warmup=0),
                        cuda_ms(o)) for name, (k, pl, o) in calls.items()}
        geometry = {name: {
            key: dict(zip(("cluster", "columns", "smem_bytes",
                           "resident_clusters"), fn(H, cols, dev)))
            for key, cols in (("main", B), ("one_column", 1))}
            for name, fn in (("gru_fwd", gru_train.fwd_geometry),
                             ("gru_bwd", gru_train.bwd_geometry))}
        for name in ("gru_fwd", "gru_bwd"):
            log("   {}: geometry {}; {:.3f} us a step, one column {:.3f} "
                "us a step".format(name, json.dumps(geometry[name]),
                                   timed[name][0] / T * 1e3,
                                   timed[name][2] / T * 1e3))
    # yardstick (the port never calls it): cuDNN's bf16 GRU, one
    # direction over layer 2's inputs, its input projection included
    gru = torch.nn.GRU(2 * H, H, 1).to(dev, torch.bfloat16)
    gru.flatten_parameters()
    x2 = h1.detach().clone().requires_grad_(True)
    with torch.no_grad():
        lib_fwd = cuda_ms(lambda: gru(x2))
    g_out = torch.ones((T, B, H), dtype=torch.bfloat16, device=dev)
    lib_params = [x2] + list(gru.parameters())
    lib_fwd_bwd = cuda_ms(lambda: torch.autograd.grad(
        gru(x2)[0], lib_params, g_out))
    lib_bwd = backward_alone_ms(gru, x2, g_out)
    del gru, x2
    log("   torch.nn.GRU({}, {}, 1) bf16 (cuDNN) over the same {} rows, "
        "its input projection included: forward {:.2f} ms, backward "
        "alone {:.2f} ms, forward + backward {:.2f} ms".format(
            2 * H, H, B, lib_fwd, lib_bwd, lib_fwd_bwd))
    return timed, geometry, main_stats, {
        "fwd": lib_fwd, "bwd": lib_bwd, "fwd_bwd": lib_fwd_bwd}


def training_phases(seed, work, bam, draft, dev, rng, agreement, modules):
    """The training path and its measurements (phases 11 and 12); returns
    the ``kernels`` rows of gru_fwd and gru_bwd."""
    import numpy as np
    import torch
    cli, datastore, gru_train, parallel, training = (
        modules[k] for k in ("cli", "datastore", "gru_train", "parallel",
                             "training"))
    from medaka_tpu_torch import testing
    from medaka_tpu_torch.models.gru import GRUModel
    truth = os.path.join(work, "truth.bam")
    train_hdf = os.path.join(work, "train.hdf")
    with phase("training data: truth BAM + features --truth"):
        testing.create_truth_bam(truth, draft)
        if cli.main(["features", bam, train_hdf, "--truth", truth,
                     "--quiet"]) != 0:
            raise AssertionError("features failed")
    train_cmd = ["train", train_hdf, "--batch_size", "128", "--epochs", "2",
                 "--optimizer", "adam", "--optim_args", "learning_rate=1e-3",
                 "--seed", str(seed), "--quiet"]
    run = os.path.join(work, "run")
    with phase("training path: train, 2 epochs at batch 128"):
        gru_train.reset_launches()
        t0 = time.perf_counter()
        if cli.main(train_cmd + ["--train_name", run]) != 0:
            raise AssertionError("train failed")
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        launches = dict(gru_train.LAUNCHES)
        check_one_rank_group(parallel)
    with open(os.path.join(run, "training.csv")) as fh:
        csv_rows = [line.split(",") for line in fh.read().splitlines()]
    header, csv_rows = csv_rows[0], csv_rows[1:]
    col = {name: i for i, name in enumerate(header)}
    losses = [float(r[col["loss"]]) for r in csv_rows]
    train_losses = [float(r[col["loss"]]) for r in csv_rows
                    if r[col["split"]] == "train"]
    steps = len(train_losses)
    log("   {} train steps in {:.1f} s; launches {}; train losses {}; "
        "validation losses {}".format(
            steps, t_train, launches, train_losses,
            [float(r[col["loss"]]) for r in csv_rows
             if r[col["split"]] == "validation"]))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("a logged loss is not finite")
    if not train_losses[-1] < train_losses[0]:
        raise AssertionError("the training loss did not fall")
    if launches != {"gru_fwd": 4 * steps, "gru_bwd": 4 * steps}:
        raise AssertionError("expected 4 launches of each training kernel "
                             "a step, got {}".format(launches))

    with phase("training path: the same run again, killed after epoch 0 "
               "and resumed"):
        resumed = killed_and_resumed(cli, train_cmd, run,
                                     os.path.join(work, "again"),
                                     "counts training")

    with phase("training path: the last checkpoint serves"):
        ckpt = os.path.join(run, "model-1.tar.gz")
        hdf = os.path.join(work, "trained_probs.hdf")
        fasta = os.path.join(work, "trained.fasta")
        if cli.main(["inference", bam, hdf, "--model", ckpt]) != 0 or \
                cli.main(["sequence", hdf, draft, fasta]) != 0:
            raise AssertionError("the trained checkpoint did not serve")
        n_samples, n_columns = check_probabilities(datastore, hdf)
        identity, edits, cons_len = consensus_identity(testing, fasta, draft)
        log("   {} samples, {} columns of finite probabilities; consensus "
            "{} bp, identity to the draft {:.6f} after {} steps".format(
                n_samples, n_columns, cons_len, identity, steps))

    batcher = training.TrainBatcher([train_hdf], batch_size=128, seed=seed)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in next(batcher.batches("train", seed=0)).items()}
    B, T = batch["features"].shape[:2]
    lengths_sum = int(batch["lengths"].sum())
    with phase("one train step at B=128 T=1000: kernels vs plain"):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = GRUModel(gru_size=256).to(dev)
        H = model.gru_size
        with torch.no_grad():
            loss_direct, _ = parallel.cross_entropy_loss(
                model, batch, compute_dtype=torch.bfloat16, training=True)
        results = {}
        for plain in (False, True):
            loss = staged_train_step(model, None, batch, gru_train, parallel,
                                     plain=plain, update=False)
            results[plain] = (loss.item(), {
                n: p.grad.clone() for n, p in model.named_parameters()})
        if loss_direct.item() != results[False][0]:
            raise AssertionError("the staged step's loss differs from the "
                                 "model's")
        loss_k, grads_k = results[False]
        loss_p, grads_p = results[True]
        step_stats = {"loss_kernels": loss_k, "loss_plain": loss_p,
                      "loss_rel": abs(loss_k - loss_p) / abs(loss_p),
                      "grad_rel_max": max(
                          ((grads_k[n] - g).abs().max() / g.abs().max())
                          .item() for n, g in grads_p.items())}
        log("   " + json.dumps(step_stats))
        if step_stats["loss_rel"] > TOL_STEP_LOSS or \
                step_stats["grad_rel_max"] > TOL_STEP_GRAD:
            raise AssertionError("the step through the kernels disagrees "
                                 "with the step through the plain versions")
        del results, grads_k, grads_p

    with phase("train step: stage breakdown, wall time"):
        opt = training.build_optimizer("adam", None,
                                       {"learning_rate": 1e-3})
        step_fn = parallel.make_train_step(model, opt)
        for _ in range(2):
            step_fn(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step_fn(batch)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / 3
        events = []
        staged_train_step(model, opt, batch, gru_train, parallel,
                          events=events)
        torch.cuda.synchronize()
        stages = {}
        for name, start, stop in events:
            stages[name] = stages.get(name, 0.0) + start.elapsed_time(stop)
        log("   stage breakdown (ms): " + json.dumps(stages))
        fwd_share = stages["gru_fwd x4"] / sum(stages.values())
        log("   step wall time {:.2f} ms: {:.0f} trained columns/s "
            "({} valid columns); gru_fwd x4 {:.2f} ms, {:.1%} of the staged "
            "step".format(step_s * 1e3, lengths_sum / step_s, lengths_sum,
                          stages["gru_fwd x4"], fwd_share))
        profile = profile_step(lambda: step_fn(batch), step_s)
        step_kernels = profile and profile.pop("kernels_ms")
        # every forward launch of the step is a gru_fwd launch
        check_cluster_forward("gru_fwd (the step's 4 launches)",
                              step_kernels)
        # a launch of each kernel, from the step's 4 launches of each
        fwd_split = split_ms(step_kernels, ("void gru_cluster_fwd_kernel",),
                             launches=4)
        bwd_split = split_ms(step_kernels, (
            "void gru_cluster_bwd_kernel", "rnn_dw_kernel",
            "rnn_bwd_reduce_kernel"), launches=4)
        log("   gru_fwd and gru_bwd a launch, from the step's profile "
            "(ms): {} {}".format(json.dumps(fwd_split),
                                 json.dumps(bwd_split)))

    with phase("training kernels at B=128 T=1000: timings"):
        timed, geometry, main_stats, lib = gru_train_timings(
            gru_train, model, batch, rng, dev)
        lib_fwd, lib_bwd, lib_fwd_bwd = lib["fwd"], lib["bwd"], \
            lib["fwd_bwd"]

    rows = []
    for name in ("gru_fwd", "gru_bwd"):
        ms, plain_ms, floor_ms = timed[name]
        bound_ms, bound_by, nbytes = train_bound(name, B, H, lengths_sum)
        if name == "gru_fwd":
            err = max([agreement[d]["fwd_max"] for d in agreement]
                      + [main_stats["fwd_max"]])
        else:
            err = max(agreement[d][k] for d in agreement
                      for k in ("dxp", "dW_hh", "db_hh"))
            err = max(err, main_stats["dxp"], main_stats["dW_hh"],
                      main_stats["db_hh"])
        rows.append({
            "name": name, "route": "cuda", "source": TRAIN_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "launches_per_step": launches[name] // steps,
            "max_abs_err": err,
            "err_measure": ("max abs difference of bf16 outputs"
                            if name == "gru_fwd" else
                            "max abs difference over the tensor's max "
                            "magnitude, worst of dxp, dW_hh, db_hh"),
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_bytes": nbytes,
            "library_ms": lib_fwd if name == "gru_fwd" else lib_bwd,
            "library": (
                "torch.nn.GRU({0}, {1}, 1) bf16 (cuDNN) forward over the "
                "same {2} rows, its input projection included: {3:.2f} ms"
                .format(2 * H, H, B, lib_fwd) if name == "gru_fwd" else
                "torch.nn.GRU({0}, {1}, 1) bf16 (cuDNN) backward alone "
                "(autograd.grad for input and weights over a kept graph) "
                "over the same {2} rows: {3:.2f} ms".format(2 * H, H, B,
                                                           lib_bwd)),
            "library_fwd_bwd_ms": lib_fwd_bwd,
            "serial_floor_ms": floor_ms,
            "shape": {"B": B, "T": T, "H": H, "valid_columns": lengths_sum,
                      "layer": 2, "direction": "forward"},
            "agreement": {"random_weights": agreement,
                          "main_shape": main_stats},
        })
        rows[-1].update(
            step_us=ms / T * 1e3, serial_floor_step_us=floor_ms / T * 1e3,
            geometry=geometry[name],
            kernels_ms_per_launch=(fwd_split if name == "gru_fwd"
                                   else bwd_split),
            faster_than_library=ms < rows[-1]["library_ms"])
        log("   {}: {:.3f} ms (plain {:.1f} ms, bound {:.4f} ms by {}, one "
            "column {:.3f} ms; {})".format(name, ms, plain_ms, bound_ms,
                                           bound_by, floor_ms,
                                           rows[-1]["library"]))
    # one train step's numbers, once, on the first of the two rows
    rows[0]["train_step"] = {
        "vs_plain": step_stats, "stages_ms": stages, "profile": profile,
        "wall_ms": step_s * 1e3, "gru_fwd_share_of_staged_step": fwd_share,
        "trained_columns_per_s": lengths_sum / step_s,
        "steps_in_run": steps}
    rows[0]["killed_and_resumed"] = resumed
    return rows


def compare_lstm_train(lstm_train, xp, w_hh, b_hh, lengths, dh_out,
                       reverse):
    """lstm_fwd and lstm_bwd against their plain versions (the backward on
    the kernel's forward outputs), and lstm_bwd against itself; returns
    {"fwd_max", "fwd_mean", "c", "dxp", "dW_hh", "db_hh"} (c and the
    backward: largest difference over the tensor's largest magnitude)."""
    import torch
    out, c_out = lstm_train.lstm_fwd(xp, w_hh, b_hh, lengths, reverse)
    ref, c_ref = lstm_train.lstm_fwd_plain(xp, w_hh, b_hh, lengths, reverse)
    args = (xp, out, c_out, dh_out, w_hh, b_hh, lengths, reverse)
    got = lstm_train.lstm_bwd(*args)
    want = lstm_train.lstm_bwd_plain(*args)
    again = lstm_train.lstm_bwd(*args)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    stats = {"fwd_max": diff.max().item(), "fwd_mean": diff.mean().item(),
             "c": ((c_out - c_ref).abs().max() / c_ref.abs().max()).item()}
    for name, g, w in zip(("dxp", "dW_hh", "db_hh"), got, want):
        stats[name] = ((g - w).abs().max() / w.abs().max()).item()
    if stats["fwd_max"] > TOL_GRU_FWD or stats["fwd_mean"] > TOL_L1_MEAN \
            or stats["c"] > TOL_LSTM_C:
        raise AssertionError("lstm_fwd disagrees with its plain version: "
                             "{}".format(stats))
    if max(stats["dxp"], stats["dW_hh"], stats["db_hh"]) > TOL_GRU_BWD:
        raise AssertionError("lstm_bwd disagrees with its plain version: "
                             "{}".format(stats))
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError("lstm_bwd does not repeat bit for bit")
    return stats


def staged_rl_train_step(model, optimizer, batch, lstm_train, parallel,
                         events=None, plain=False, update=True):
    """One bf16 train step of the bidirectional ``LatentSpaceLSTM`` stage
    by stage, as ``parallel.make_train_step`` runs it (the forward of
    ``forward(training=True)`` with ``lstm_train.bilstm_stack_trainable``
    written out); returns the loss.

    :param events: a list to which (stage, start, stop) CUDA events are
        appended.
    :param plain: the LSTM kernels' plain versions in their place.
    :param update: apply the optimizer and the running statistics (else
        leave the gradients).
    """
    import torch
    cd = torch.bfloat16

    def stage(name, fn):
        return timed_stage(events, name, fn)

    params = list(model.parameters())
    for p in params:
        p.grad = None
    stats = []
    lengths = batch["lengths"].to(torch.int32)
    dirs = (("fwd", False), ("bwd", True))
    with parallel.deterministic_convolutions():
        feats, non_empty = stage(
            "embeddings + convs + BN statistics",
            lambda: model.read_features(batch["features"], cd, True, stats))
        pooled = stage("pool + pre_pool",
                       lambda: model.pool(feats, non_empty, cd))
        del feats
        out = pooled.transpose(0, 1).to(cd)
        for layer in model.layer_params():
            xps = stage("projections", lambda out=out, layer=layer: [
                lstm_train.project(out, layer[d]["w_ih"], layer[d]["b_ih"],
                                   cd) for d, _ in dirs])
            out = stage("lstm_fwd x4", lambda xps=xps, layer=layer: torch.cat(
                [lstm_train.LSTMDirection.apply(
                    xp, layer[d]["w_hh"], layer[d]["b_hh"], lengths, rev,
                    plain) for xp, (d, rev) in zip(xps, dirs)], dim=-1))
        feats_out = out.transpose(0, 1)
        loss = stage("head + loss", lambda: parallel.masked_cross_entropy(
            model.head(feats_out), batch))
        stage("backward (lstm_bwd x4, conv, BN and projection gradients)",
              loss.backward)
    if update:
        def finish():
            parallel.apply_updates(params, optimizer)
            parallel.update_running_stats(model, stats)
        stage("optimizer (clip + adam) + running statistics", finish)
    return loss


def read_level_training_phases(seed, work, dev, rng, agreement, modules):
    """The read-level training path and its measurements (phases 14 and
    15); returns the ``kernels`` rows of lstm_fwd and lstm_bwd."""
    import torch
    cli, datastore, lstm_train, models, parallel, training = (
        modules[k] for k in ("cli", "datastore", "lstm_train", "models",
                             "parallel", "training"))
    from medaka_tpu_torch import testing
    from medaka_tpu_torch.models.latent_space_lstm import LatentSpaceLSTM
    with phase("read-level training data: 0.5 Mb BAM with move tables, "
               "truth BAM, features --truth"):
        bam, draft = testing.create_synth_bam(
            os.path.join(work, "rl_reads.bam"), ref_mb=0.5, depth=20,
            seed=seed, move_tables=True)
        truth = testing.create_truth_bam(os.path.join(work, "rl_truth.bam"),
                                         draft)
        train_hdf = os.path.join(work, "rl_train.hdf")
        if cli.main(["features", bam, train_hdf, "--truth", truth,
                     "--feature_encoder", "ReadAlignmentFeatureEncoder",
                     "--quiet"]) != 0:
            raise AssertionError("read-level features failed")
    train_cmd = ["train", train_hdf, "--batch_size", "128", "--epochs", "2",
                 "--optimizer", "adam", "--optim_args", "learning_rate=1e-3",
                 "--seed", str(seed), "--quiet"]
    run = os.path.join(work, "rl_run")
    with phase("read-level training path: train, 2 epochs at batch 128"):
        torch.cuda.empty_cache()
        lstm_train.reset_launches()
        t0 = time.perf_counter()
        if cli.main(train_cmd + ["--train_name", run]) != 0:
            raise AssertionError("read-level train failed")
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        launches = dict(lstm_train.LAUNCHES)
        check_one_rank_group(parallel)
    with open(os.path.join(run, "training.csv")) as fh:
        csv_rows = [line.split(",") for line in fh.read().splitlines()]
    header, csv_rows = csv_rows[0], csv_rows[1:]
    col = {name: i for i, name in enumerate(header)}
    losses = [float(r[col["loss"]]) for r in csv_rows]
    train_losses = [float(r[col["loss"]]) for r in csv_rows
                    if r[col["split"]] == "train"]
    steps = len(train_losses)
    log("   {} train steps in {:.1f} s; launches {}; train losses {}; "
        "validation losses {}; baseline accuracy {}".format(
            steps, t_train, launches, train_losses,
            [float(r[col["loss"]]) for r in csv_rows
             if r[col["split"]] == "validation"],
            [r[col["baseline_acc"]] for r in csv_rows]))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("a logged read-level loss is not finite")
    if not train_losses[-1] < train_losses[0]:
        raise AssertionError("the read-level training loss did not fall")
    if launches != {"lstm_fwd": 4 * steps, "lstm_bwd": 4 * steps}:
        raise AssertionError("expected 4 launches of each LSTM training "
                             "kernel a step, got {}".format(launches))
    ckpt = os.path.join(run, "model-1.tar.gz")
    trained = models.load_model(ckpt).model
    geometry = trained.to_dict()["kwargs"]
    log("   trained model: {}".format(json.dumps(geometry)))
    if (geometry["lstm_size"], geometry["cnn_size"],
            geometry["kernel_sizes"], geometry["use_dwells"]) != \
            (384, 128, [1, 17], True):
        raise AssertionError("train did not build the full-width default")
    running = []
    for k, layer in enumerate(trained.convs):
        bn = layer["bn"]
        running.append({"layer": k, "mean_abs": bn.mean.abs().mean().item(),
                        "var_mean": bn.var.mean().item()})
        if torch.equal(bn.mean, torch.zeros_like(bn.mean)) or \
                torch.equal(bn.var, torch.ones_like(bn.var)):
            raise AssertionError("the running statistics of conv layer {} "
                                 "did not move".format(k))
    log("   batch-norm running statistics: {}".format(json.dumps(running)))
    del trained

    with phase("read-level training path: the same run again, killed "
               "after epoch 0 and resumed"):
        resumed = killed_and_resumed(cli, train_cmd, run,
                                     os.path.join(work, "rl_again"),
                                     "read-level training")

    with phase("read-level training path: the last checkpoint serves"):
        hdf = os.path.join(work, "rl_trained_probs.hdf")
        fasta = os.path.join(work, "rl_trained.fasta")
        if cli.main(["inference", bam, hdf, "--model", ckpt, "--chunk_len",
                     "1000", "--chunk_ovlp", "100"]) != 0 or \
                cli.main(["sequence", hdf, draft, fasta]) != 0:
            raise AssertionError("the read-level checkpoint did not serve")
        n_samples, n_columns = check_probabilities(datastore, hdf)
        identity, edits, cons_len = consensus_identity(testing, fasta, draft)
        log("   {} samples, {} columns of finite probabilities; consensus "
            "{} bp, identity to the draft {:.6f} after {} steps".format(
                n_samples, n_columns, cons_len, identity, steps))

    batcher = training.TrainBatcher([train_hdf], batch_size=128, seed=seed)
    host = next(batcher.batches("train", seed=0))
    host.pop("baseline_pred")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    B, T, R = batch["features"].shape[:3]
    lengths_sum = int(batch["lengths"].sum())
    torch.cuda.empty_cache()
    with phase("one read-level train step at B=128 T=1000 R=100 H=384: "
               "kernels vs plain"):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = LatentSpaceLSTM(lstm_size=384, use_dwells=True).to(dev)
        H = model.lstm_size
        with parallel.deterministic_convolutions():
            loss_direct = parallel.cross_entropy_loss(
                model, batch, compute_dtype=torch.bfloat16,
                training=True)[0].item()
        results = {}
        for plain in (False, True):
            loss = staged_rl_train_step(model, None, batch, lstm_train,
                                        parallel, plain=plain, update=False)
            results[plain] = (loss.item(), {
                n: p.grad.clone() for n, p in model.named_parameters()})
        # the same operations in the same order: the same loss, within the
        # f32 rounding of a reduction that a library may split otherwise
        if abs(loss_direct - results[False][0]) > 1e-6 * abs(loss_direct):
            raise AssertionError("the staged read-level step's loss {} "
                                 "differs from the model's {}".format(
                                     results[False][0], loss_direct))
        loss_k, grads_k = results[False]
        loss_p, grads_p = results[True]

        def rel(n):
            g = grads_p[n]
            return ((grads_k[n] - g).abs().max() / g.abs().max()).item()

        def cosine(n):
            a = grads_k[n].double().flatten()
            b = grads_p[n].double().flatten()
            return (a @ b / (a.norm() * b.norm()).clamp(min=1e-300)).item()

        stack = [n for n in grads_p if n.startswith(("lstm.", "linear."))]
        upstream = [n for n in grads_p if n not in stack]
        step_stats = {"loss_kernels": loss_k, "loss_plain": loss_p,
                      "loss_rel": abs(loss_k - loss_p) / abs(loss_p),
                      "grad_rel_max": max(rel(n) for n in stack),
                      "upstream_grad_rel_max": max(rel(n) for n in upstream),
                      "upstream_grad_cosine_min": min(
                          cosine(n) for n in upstream)}
        log("   " + json.dumps(step_stats))
        if step_stats["loss_rel"] > TOL_STEP_LOSS or \
                step_stats["grad_rel_max"] > TOL_STEP_GRAD or \
                step_stats["upstream_grad_cosine_min"] < MIN_UPSTREAM_COSINE:
            raise AssertionError("the read-level step through the kernels "
                                 "disagrees with the step through the "
                                 "plain versions")
        del results, grads_k, grads_p

    with phase("read-level train step: stage breakdown, wall time, memory"):
        opt = training.build_optimizer("adam", None,
                                       {"learning_rate": 1e-3})
        step_fn = parallel.make_train_step(model, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_fn(batch)
        torch.cuda.synchronize()
        peak_bytes = torch.cuda.max_memory_allocated()
        step_fn(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step_fn(batch)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / 3
        events = []
        staged_rl_train_step(model, opt, batch, lstm_train, parallel,
                             events=events)
        torch.cuda.synchronize()
        stages = {}
        for name, start, stop in events:
            stages[name] = stages.get(name, 0.0) + start.elapsed_time(stop)
        log("   stage breakdown (ms): " + json.dumps(stages))
        log("   step wall time {:.2f} ms: {:.0f} trained columns/s ({} "
            "valid columns); peak memory {:.2f} GB".format(
                step_s * 1e3, lengths_sum / step_s, lengths_sum,
                peak_bytes / 1e9))
        profile = profile_step(lambda: step_fn(batch), step_s)

    with phase("LSTM training kernels at B=128 T=1000 H=384: timings"):
        dirs = (("fwd", False), ("bwd", True))
        layer1, layer2 = model.layer_params()
        with torch.no_grad():
            with parallel.deterministic_convolutions():
                feats, non_empty = model.read_features(
                    batch["features"], torch.bfloat16, True)
                pooled = model.pool(feats, non_empty, torch.bfloat16)
            del feats
            lens = batch["lengths"]
            x1 = pooled.transpose(0, 1)
            h1 = torch.cat([lstm_train.lstm_fwd(
                lstm_train.project(x1, layer1[d]["w_ih"], layer1[d]["b_ih"]),
                layer1[d]["w_hh"], layer1[d]["b_hh"], lens, rev)[0]
                for d, rev in dirs], dim=-1)
            p2 = layer2["fwd"]
            xp = lstm_train.project(h1, p2["w_ih"], p2["b_ih"])
            w_hh, b_hh = p2["w_hh"].detach(), p2["b_hh"].detach()
            out, c_out = lstm_train.lstm_fwd(xp, w_hh, b_hh, lens)
            dh_out = torch.from_numpy(rng.standard_normal((T, B, H)).astype(
                "float32")).to(dev, torch.bfloat16).float()
            main_stats = compare_lstm_train(lstm_train, xp, w_hh, b_hh, lens,
                                            dh_out, False)
            one = (xp[:, :1].contiguous(), lens[:1])
            out1, c1 = lstm_train.lstm_fwd(one[0], w_hh, b_hh, one[1])
            bargs = (xp, out, c_out, dh_out, w_hh, b_hh, lens)
            calls = {
                "lstm_fwd": (
                    lambda: lstm_train.lstm_fwd(xp, w_hh, b_hh, lens),
                    lambda: lstm_train.lstm_fwd_plain(xp, w_hh, b_hh, lens),
                    lambda: lstm_train.lstm_fwd(one[0], w_hh, b_hh, one[1])),
                "lstm_bwd": (
                    lambda: lstm_train.lstm_bwd(*bargs),
                    lambda: lstm_train.lstm_bwd_plain(*bargs),
                    lambda: lstm_train.lstm_bwd(
                        one[0], out1, c1, dh_out[:, :1].contiguous(), w_hh,
                        b_hh, one[1])),
            }
            timed, geometry = {}, {}
            for name, (k, pl, o) in calls.items():
                timed[name] = (cuda_ms(k), cuda_ms(pl, reps=1, warmup=0),
                               cuda_ms(o))
                kind = name[len("lstm_"):]
                geometry[name] = {
                    key: dict(zip(("cluster", "columns", "smem_bytes",
                                   "resident_clusters"),
                                  lstm_train.geometry(kind, H, cols, dev)))
                    for key, cols in (("main", B), ("one_column", 1))}
                ms, _, floor_ms = timed[name]
                log("   {}: geometry {}; {:.3f} us a step, one column "
                    "{:.3f} us a step".format(name, json.dumps(geometry[name]),
                                             ms / T * 1e3, floor_ms / T * 1e3))
        # yardsticks (the port never calls them): cuDNN's bf16 LSTM, one
        # direction over layer 2's inputs, its input projection included:
        # the forward, the backward alone (autograd.grad over a kept
        # graph) and the two together
        lstm = torch.nn.LSTM(2 * H, H, 1).to(dev, torch.bfloat16)
        lstm.flatten_parameters()
        x2 = h1.detach().clone().requires_grad_(True)
        with torch.no_grad():
            lib_fwd = cuda_ms(lambda: lstm(x2))
        g_out = torch.ones((T, B, H), dtype=torch.bfloat16, device=dev)
        lib_params = [x2] + list(lstm.parameters())
        lib_fwd_bwd = cuda_ms(lambda: torch.autograd.grad(
            lstm(x2)[0], lib_params, g_out))
        lib_bwd = backward_alone_ms(lstm, x2, g_out)
        del lstm, x2
        log("   torch.nn.LSTM({}, {}, 1) bf16 (cuDNN) over the same {} rows, "
            "its input projection included: forward {:.2f} ms, backward "
            "alone {:.2f} ms, forward + backward {:.2f} ms".format(
                2 * H, H, B, lib_fwd, lib_bwd, lib_fwd_bwd))

    rows = []
    for name in ("lstm_fwd", "lstm_bwd"):
        ms, plain_ms, floor_ms = timed[name]
        bound_ms, bound_by, nbytes = train_bound(name, B, H, lengths_sum)
        if name == "lstm_fwd":
            err = max([agreement[k]["fwd_max"] for k in agreement]
                      + [main_stats["fwd_max"]])
            c_err = max([agreement[k]["c"] for k in agreement]
                        + [main_stats["c"]])
        else:
            err = max(agreement[k][t] for k in agreement
                      for t in ("dxp", "dW_hh", "db_hh"))
            err = max(err, main_stats["dxp"], main_stats["dW_hh"],
                      main_stats["db_hh"])
        rows.append({
            "name": name, "route": "cuda", "source": LSTM_TRAIN_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "launches_per_step": launches[name] // steps,
            "max_abs_err": err,
            "err_measure": ("max abs difference of bf16 outputs (h)"
                            if name == "lstm_fwd" else
                            "max abs difference over the tensor's max "
                            "magnitude, worst of dxp, dW_hh, db_hh"),
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_bytes": nbytes,
            "library_ms": lib_fwd if name == "lstm_fwd" else lib_bwd,
            "library": (
                "torch.nn.LSTM({0}, {1}, 1) bf16 (cuDNN) forward over the "
                "same {2} rows, its input projection included: {3:.2f} ms"
                .format(2 * H, H, B, lib_fwd) if name == "lstm_fwd" else
                "torch.nn.LSTM({0}, {1}, 1) bf16 (cuDNN) backward alone "
                "(autograd.grad for input and weights over a kept graph) "
                "over the same {2} rows: {3:.2f} ms".format(2 * H, H, B,
                                                           lib_bwd)),
            "library_fwd_bwd_ms": lib_fwd_bwd,
            "serial_floor_ms": floor_ms,
            "step_us": ms / T * 1e3,
            "serial_floor_step_us": floor_ms / T * 1e3,
            "geometry": geometry[name],
            "shape": {"B": B, "T": T, "H": H, "reads": R,
                      "valid_columns": lengths_sum, "layer": 2,
                      "direction": "forward"},
            "agreement": {"random_weights": agreement,
                          "main_shape": main_stats},
        })
        if name == "lstm_fwd":
            rows[-1]["c_rel_err"] = c_err
        else:
            # the backward's three kernels, a launch each, from the
            # profile of the timed step (4 launches of each)
            per_launch = split_ms(profile and profile.pop("kernels_ms"), (
                "void lstm_bwd_kernel", "rnn_dw_kernel",
                "rnn_bwd_reduce_kernel"), launches=4)
            rows[-1]["kernels_ms_per_launch"] = per_launch
            log("   lstm_bwd a launch, from the step's profile (ms): "
                "{}".format(json.dumps(per_launch)))
        log("   {}: {:.3f} ms (plain {:.1f} ms, bound {:.4f} ms by {}, one "
            "column {:.3f} ms; {})".format(name, ms, plain_ms, bound_ms,
                                           bound_by, floor_ms,
                                           rows[-1]["library"]))
    rows[0]["train_step"] = {
        "vs_plain": step_stats, "stages_ms": stages, "profile": profile,
        "wall_ms": step_s * 1e3, "peak_memory_bytes": peak_bytes,
        "trained_columns_per_s": lengths_sum / step_s,
        "steps_in_run": steps, "run_s": t_train,
        "batchnorm_running": running}
    rows[0]["killed_and_resumed"] = resumed
    return rows, {"bam": bam, "draft": draft, "features": train_hdf,
                  "checkpoint": ckpt}


def variant_path(name, bundle, diploid, decodes, seed, work, dev, modules):
    """One variant-calling path: a 0.5 Mb ``create_variant_bam`` genome at
    depth 30, ``inference --model <bundle>`` by name at the automatic batch
    with the split kernels' launch counts set to 0 just before, then each
    of ``decodes`` ((label, CLI arguments after the files)) scored against
    the truth VCF. Returns the path's record for the ``kernels`` line."""
    import torch
    cli, datastore, gru_split, models, prediction = (modules[k] for k in (
        "cli", "datastore", "gru_split", "models", "prediction"))
    from medaka_tpu_torch import testing
    with phase("{}: 0.5 Mb genome with planted variants at depth 30 "
               "(create_variant_bam)".format(name)):
        bam, ref, truth, planted = testing.create_variant_bam(
            os.path.join(work, name + ".bam"), ref_mb=0.5, depth=30,
            seed=seed, diploid=diploid)
    model = models.load_model(models.resolve_model(bundle)).model
    batch = prediction.auto_batch_size(model, dev)
    hdf = os.path.join(work, name + ".hdf")
    with phase("{}: inference --model {} (by name), automatic batch {} "
               "(mode {})".format(name, bundle, batch,
                                  gru_split.split_mode(batch))):
        gru_split.reset_launches()
        t0 = time.perf_counter()
        if cli.main(["inference", bam, hdf, "--model", bundle]) != 0:
            raise AssertionError("{} inference failed".format(name))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(gru_split.LAUNCHES)
        mode_launches = dict(gru_split.MODE_LAUNCHES)
    log("   launches on the {} path: {} {}".format(name, launches,
                                                 mode_launches))
    if min(launches.values()) < 1:
        raise AssertionError("a split kernel never launched on the {} "
                             "path".format(name))
    n_samples, n_columns = check_probabilities(datastore, hdf,
                                               model.num_classes)
    from medaka_tpu_torch.io.fastx import FastaReader
    with FastaReader(ref) as fr:
        ref_len = fr.get_reference_length(fr.references[0])
    out = {"bundle": bundle, "classes": model.num_classes, "batch": batch,
           "ref_len": ref_len, "planted": len(planted),
           "samples": n_samples,
           "columns": n_columns, "inference_s": seconds,
           "columns_per_s": n_columns / seconds, "launches": launches,
           "launches_by_mode": mode_launches, "decodes": {}}
    log("   {} samples, {} columns in {:.2f} s of inference: {:.0f} "
        "columns/s".format(n_samples, n_columns, seconds,
                           out["columns_per_s"]))
    for label, args in decodes:
        vcf_path = os.path.join(work, "{}_{}.vcf".format(
            name, label.replace(" ", "_")))
        with phase("{}: {}".format(name, label)):
            t0 = time.perf_counter()
            if cli.main([args[0], hdf, ref, vcf_path] + args[1:]) != 0:
                raise AssertionError("{} {} failed".format(name, label))
            decode_s = time.perf_counter() - t0
            score = testing.score_vcf(truth, vcf_path, ref)
        log("   {} {}: {} ({:.2f} s)".format(name, label, json.dumps(score),
                                            decode_s))
        out["decodes"][label] = {"score": score, "seconds": decode_s,
                                 "vcf": vcf_path}
    return out


def variant_phases(seed, work, dev, modules):
    """The variant and SNP calling paths (phase 20): returns their
    records."""
    from medaka_tpu_torch import testing
    floors = testing.VARIANT_FLOORS
    paths = {}
    hap = variant_path(
        "variant", "gru256_variant_demo", False,
        (("vcf", ["vcf"]), ("vcf --gvcf", ["vcf", "--gvcf"])), seed, work,
        dev, modules)
    low = testing.below_floors(hap["decodes"]["vcf"]["score"],
                               floors["haploid"])
    if low:
        raise AssertionError("variant calling below its floors: {}".format(
            low))
    # the gVCF holds the same variant records and a reference row for
    # every other covered column (all but the genome's ends)
    with open(hap["decodes"]["vcf"]["vcf"]) as fh:
        calls = [line for line in fh if not line.startswith("#")]
    with open(hap["decodes"]["vcf --gvcf"]["vcf"]) as fh:
        rows = [line for line in fh if not line.startswith("#")]
    variants = [line for line in rows if line.split("\t")[4] != "."]
    if variants != calls or \
            len(rows) - len(variants) < 0.99 * hap["ref_len"]:
        raise AssertionError(
            "the gVCF holds {} variant records ({} in the VCF) and {} "
            "reference rows".format(len(variants), len(calls),
                                    len(rows) - len(variants)))
    hap["gvcf_reference_rows"] = len(rows) - len(variants)
    paths["variant"] = hap

    dip = variant_path(
        "diploid_snp", "gru256_diploid_snp_demo", True,
        (("snp", ["snp"]), ("snp --het_rescue 0.1",
                            ["snp", "--het_rescue", "0.1"])),
        seed, work, dev, modules)
    plain = dip["decodes"]["snp"]["score"]
    rescued = dip["decodes"]["snp --het_rescue 0.1"]["score"]
    low = (testing.below_floors(plain, floors["diploid"])
           + testing.below_floors(rescued, floors["diploid_rescue"]))
    if low:
        raise AssertionError("SNP calling below its floors: {}".format(low))
    if rescued["snp"]["recall"] <= plain["snp"]["recall"]:
        raise AssertionError("--het_rescue 0.1 did not raise recall: {} -> "
                             "{}".format(plain["snp"]["recall"],
                                         rescued["snp"]["recall"]))
    paths["diploid_snp"] = dip
    return paths


#: phase 34: the kb of phase 4's BAM that the downloaded model's
#: inference and ``counts_entry`` cover
TOOLS_REGION_KB = 100
#: phase 34: the catalogue basecaller the FASTQ and the BAM name
TOOLS_BASECALLER = "dna_r10.4.1_e8.2_400bps_sup@v5.0.0"


def captured(fn, *args):
    """(return value, standard output) of ``fn(*args)``."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


def tool(cli, *argv, rc=0):
    """The standard output of ``tools <argv>``; raises unless it returns
    ``rc``."""
    got, out = captured(cli.main, ["tools", *argv])
    if got != rc:
        raise AssertionError("tools {} returned {} (expected {}): {}".format(
            " ".join(argv), got, rc, out))
    return out


def called_alleles(vcf_mod, path):
    """{(chrom, pos, ref): sorted called allele sequences} of a VCF's
    records that call an allele other than the reference."""
    out = {}
    for v in vcf_mod.VCFReader(path, cache=False).fetch():
        alleles = [v.ref] + list(v.alt)
        gt = v.gt or ()
        if any(g for g in gt):
            key = (v.chrom, v.pos, v.ref)
            if key in out:
                raise AssertionError("two records at {}".format(key))
            out[key] = sorted(alleles[g] for g in gt)
    return out


def tools_phases(seed, work, bam, draft, hdf, fasta, variant_paths, dev,
                 modules):
    """The tools on the card's outputs (phase 34): returns its record."""
    import numpy as np
    import torch
    cli, datastore, features, gru_split, models, testing, vcf_mod = (
        modules[k] for k in ("cli", "datastore", "features", "gru_split",
                             "models", "testing", "vcf"))
    from medaka_tpu_torch.common import Region
    from medaka_tpu_torch.io.fastx import FastaReader
    t_phase = time.perf_counter()
    out = {"seconds": {}}
    hap_vcf = variant_paths["variant"]["decodes"]["vcf"]["vcf"]
    dip_vcf = variant_paths["diploid_snp"]["decodes"]["snp"]["vcf"]
    hap_bam = os.path.join(work, "variant.bam")
    hap_ref, hap_truth = hap_bam + ".ref.fasta", hap_bam + ".truth.vcf"
    dip_ref = os.path.join(work, "diploid_snp.bam.ref.fasta")
    with FastaReader(hap_ref) as fr:
        contig = fr.references[0]
        ref_len = fr.get_reference_length(contig)

    with phase("(34) tools on the variant calls: diploid2haploid, "
               "haploid2diploid, classify_variants, vcf2tsv, "
               "homozygous_regions, vcf2fasta, hdf_to_bed"):
        t0 = time.perf_counter()
        halves = tool(cli, "diploid2haploid", dip_vcf).split()
        if len(halves) != 2:
            raise AssertionError("diploid2haploid wrote {}".format(halves))
        merged = os.path.join(work, "rediploid.vcf")
        tool(cli, "haploid2diploid", *sorted(halves), dip_ref, merged)
        want, got = (called_alleles(vcf_mod, p) for p in (dip_vcf, merged))
        if got != want:
            raise AssertionError(
                "haploid2diploid of diploid2haploid's halves: {} records "
                "({} in the input), {} differ".format(
                    len(got), len(want),
                    len(set(got.items()) ^ set(want.items()))))
        n_hap = sum(1 for _ in vcf_mod.VCFReader(
            hap_vcf, cache=False).fetch())
        tool(cli, "classify_variants", hap_vcf)
        base = hap_vcf[:-len(".vcf")]
        classes = {k: [(v.pos, v.ref, tuple(v.alt)) for v in
                       vcf_mod.VCFReader("{}.{}.vcf".format(base, k),
                                         cache=False).fetch()]
                   for k in ("snp", "indel", "all")}
        others = [r for r in classes["all"] if r not in classes["snp"]
                  and r not in classes["indel"]]
        if len(classes["all"]) != n_hap or set(classes["snp"]) & set(
                classes["indel"]) or len(classes["snp"]) + len(
                classes["indel"]) + len(others) != n_hap:
            raise AssertionError("the class files do not partition the {} "
                                 "records: {}".format(n_hap, {
                                     k: len(v) for k, v in classes.items()}))
        table = tool(cli, "vcf2tsv", hap_vcf).strip()
        with open(table) as fh:
            rows = fh.read().splitlines()
        if len(rows) != n_hap + 1:
            raise AssertionError("vcf2tsv: {} rows for {} records".format(
                len(rows) - 1, n_hap))
        here = os.getcwd()
        os.chdir(work)
        try:
            tool(cli, "homozygous_regions", dip_vcf,
                 "{}:0-{}".format(contig, ref_len))
        finally:
            os.chdir(here)
        with open(os.path.join(work, "homozygous_regions.txt")) as fh:
            homo = [Region.from_string(r) for r in fh.read().split()]
        if not homo or any(r.start < 0 or r.end > ref_len for r in homo):
            raise AssertionError("homozygous_regions: {}".format(homo[:4]))
        genome = os.path.join(work, "vcf2fasta.fasta")
        tool(cli, "vcf2fasta", hap_truth, hap_ref, genome)
        # the haploid genome create_variant_bam drew the reads from,
        # rebuilt from its seed
        rng = np.random.default_rng(seed)
        ref_seq = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, ref_len)].tobytes().decode()
        haps, _ = testing.plant_variants(ref_seq, rng)
        with FastaReader(hap_ref) as fr:
            if fr.fetch(contig) != ref_seq:
                raise AssertionError("the genome's seed does not replay")
        with FastaReader(genome) as fr:
            if fr.fetch(contig) != haps[0]:
                raise AssertionError("vcf2fasta is not the reads' genome")
        bed = os.path.join(work, "variant.bed")
        tool(cli, "hdf_to_bed", os.path.join(work, "variant.hdf"), bed)
        with open(bed) as fh:
            spans = [line.split("\t") for line in fh.read().splitlines()]
        covered = sum(int(e) - int(s) for _, s, e in spans)
        if any(c != contig for c, _, _ in spans) or \
                covered < 0.99 * ref_len:
            raise AssertionError("hdf_to_bed covers {} of {} bases".format(
                covered, ref_len))
        out["variant_tools"] = {
            "diploid_records": len(want), "haploid_records": n_hap,
            "classes": {k: len(v) for k, v in classes.items()},
            "homozygous_regions": len(homo), "bed_covered": covered,
            "ref_len": ref_len}
        out["seconds"]["variant_tools"] = time.perf_counter() - t0
    log("   {}".format(json.dumps(out["variant_tools"])))

    with phase("(34) model tools on the bundled counts, RLE and read-level "
               "models"):
        t0 = time.perf_counter()
        report = {}
        for name in ("gru256_lambda_demo", "gru256_rle_demo",
                     "rl_lstm128_lambda_demo", "rl_lstm128_dwells_demo"):
            dwells = name == "rl_lstm128_dwells_demo"
            report[name] = {
                "dtypes": tool(cli, "get_model_dtypes", name).strip(),
                "alignment": tool(cli, "get_alignment_params",
                                  name).strip(),
                "rle": tool(cli, "is_rle_model", name).strip(),
                "compatible": tool(cli, "is_compatible", "--model", name,
                                   bam, rc=1 if dwells else 0).strip()}
        want = {"gru256_rle_demo": ("True", "-M 5 -S 4 -O 2 -E 3")}
        for name, rec in report.items():
            rle, params = want.get(name, ("False", "-M 2 -S 4 -O 4,24 "
                                                   "-E 2,1"))
            ok = "" if name == "rl_lstm128_dwells_demo" else "Compatible."
            if (rec["rle"], rec["alignment"], rec["compatible"]) != (
                    rle, params, ok):
                raise AssertionError("model tools on {}: {}".format(
                    name, rec))
        out["model_tools"] = report
        out["seconds"]["model_tools"] = time.perf_counter() - t0
    log("   {}".format(json.dumps(report)))

    with phase("(34) model selection from a FASTQ and a BAM naming {}, "
               "download from a file:// template, inference with the "
               "cached model".format(TOOLS_BASECALLER)):
        t0 = time.perf_counter()
        fastq = testing.write_basecaller_fastq(
            os.path.join(work, "basecalled.fastq"), [TOOLS_BASECALLER],
            seed=seed)
        rg_bam = testing.write_basecaller_bam(
            bam, os.path.join(work, "basecalled.bam"), [TOOLS_BASECALLER])
        chosen = {tool(cli, "resolve_model", "--model", path,
                       "--auto_model", "consensus").strip()
                  for path in (fastq, rg_bam)}
        catalogue = models.options.basecaller_models[TOOLS_BASECALLER][0]
        if chosen != {catalogue}:
            raise AssertionError("resolve_model --auto_model chose {}, not "
                                 "{}".format(chosen, catalogue))
        published = os.path.join(work, "published")
        os.makedirs(published)
        import shutil
        shutil.copy(MODEL, os.path.join(
            published, catalogue + "_model_pt.tar.gz"))
        store = os.path.join(work, "store")
        cached = models.download_model(
            catalogue, cache_dir=store,
            url_template="file://" + published + "/{fname}")
        if os.path.dirname(cached) != store or \
                [f for f in os.listdir(store) if f.endswith(".part")]:
            raise AssertionError("download_model cached {}".format(cached))
        out["seconds"]["select_download"] = time.perf_counter() - t0
        region = "synth:0-{}".format(TOOLS_REGION_KB * 1000)
        batch = modules["prediction"].auto_batch_size(
            models.load_model(cached).model, dev)
        mode = gru_split.split_mode(batch)
        results = {}
        for label, model in (("downloaded", cached),
                             ("gru256_lambda_demo", "gru256_lambda_demo")):
            probs = os.path.join(work, "tools_{}.hdf".format(label))
            gru_split.reset_launches()
            t1 = time.perf_counter()
            if cli.main(["inference", bam, probs, "--model", model,
                         "--regions", region]) != 0:
                raise AssertionError("inference --model {} failed".format(
                    model))
            torch.cuda.synchronize()
            results[label] = {
                "hdf": probs, "seconds": time.perf_counter() - t1,
                "launches": dict(gru_split.LAUNCHES),
                "launches_by_mode": dict(gru_split.MODE_LAUNCHES)}
        launches = results["downloaded"]["launches"]
        if mode != "t" or min(launches.values()) < 1 or min(
                results["downloaded"]["launches_by_mode"][k + "/t"]
                for k in launches) < 1:
            raise AssertionError(
                "the downloaded model's inference (batch {}, mode {}) did "
                "not run both split kernels in mode t: {}".format(
                    batch, mode, results["downloaded"]["launches_by_mode"]))
        got, want = ({name: ds.load_sample(name).label_probs.tobytes()
                      for name in sorted(ds.sample_registry)}
                     for ds in (datastore.DataStore(results[k]["hdf"])
                                for k in ("downloaded",
                                          "gru256_lambda_demo")))
        if not got or got != want:
            raise AssertionError("the downloaded model's probabilities "
                                 "differ from gru256_lambda_demo's")
        out["model_selection"] = {
            "basecaller": TOOLS_BASECALLER, "model": catalogue,
            "batch": batch, "mode": mode, "samples": len(got),
            "launches": launches,
            "launches_by_mode": results["downloaded"]["launches_by_mode"],
            "inference_s": {k: v["seconds"] for k, v in results.items()}}
    log("   {}".format(json.dumps(out["model_selection"])))

    with phase("(34) phase 5's probabilities through DataStore(compression="
               "\"lzf\"): write, read back, sequence"):
        lzf = os.path.join(work, "probs_lzf.hdf")
        with datastore.DataStore(hdf) as src:
            names = sorted(src.sample_registry)
            samples = [src.load_sample(n) for n in names]
            t0 = time.perf_counter()
            with datastore.DataStore(lzf, "w", compression="lzf") as dst:
                dst.copy_meta(src)
                for sample in samples:
                    dst.write_sample(sample)
                dst.write_registry()
            t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        with datastore.DataStore(lzf) as ds:
            back = [ds.load_sample(n) for n in names]
        t_read = time.perf_counter() - t0
        for a, b in zip(samples, back):
            for field in ("label_probs", "positions"):
                x, y = getattr(a, field), getattr(b, field)
                if x.dtype != y.dtype or x.tobytes() != y.tobytes():
                    raise AssertionError("lzf changed {} of {}".format(
                        field, a.name))
        lzf_fasta = os.path.join(work, "lzf.fasta")
        t0 = time.perf_counter()
        if cli.main(["sequence", lzf, draft, lzf_fasta]) != 0:
            raise AssertionError("sequence of the lzf file failed")
        t_sequence = time.perf_counter() - t0
        with open(lzf_fasta, "rb") as a, open(fasta, "rb") as b:
            if a.read() != b.read():
                raise AssertionError("the lzf file's FASTA is not phase 5's")
        out["lzf"] = {"samples": len(names), "write_s": t_write,
                      "read_s": t_read, "sequence_s": t_sequence,
                      "bytes": os.path.getsize(lzf),
                      "bytes_uncompressed": os.path.getsize(hdf)}
    log("   {}".format(json.dumps(out["lzf"])))

    with phase("(34) console scripts: version_report, counts_entry over {} "
               "kb".format(TOOLS_REGION_KB)):
        _, report = captured(cli.version_report)
        name = torch.cuda.get_device_name(0)
        if name not in report or "native library: ok" not in report:
            raise AssertionError("version_report: {}".format(report))
        log("   " + report.strip().replace("\n", "\n   "))
        region = "synth:0-{}".format(TOOLS_REGION_KB * 1000)
        t0 = time.perf_counter()
        rc, text = captured(cli.counts_entry, [bam, region, "--print"])
        t_counts = time.perf_counter() - t0
        rows = [line for line in text.splitlines()
                if line.startswith("(")]
        want = ["({}, {})\t".format(p["major"], p["minor"])
                + "\t".join(str(x) for x in row)
                for counts, pos in features.pileup_counts(
                    Region.from_string(region), bam)
                for p, row in zip(pos, counts)]
        if rc != 0 or not rows or rows != want:
            raise AssertionError("counts_entry gave {} rows, pileup_counts "
                                 "{}".format(len(rows), len(want)))
        out["console_scripts"] = {"counts_rows": len(rows),
                                  "counts_entry_s": t_counts}
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    log("   counts_entry: {} rows in {:.2f} s; phase 34 took {:.1f} s".format(
        len(rows), t_counts, out["seconds"]["phase"]))
    return out


@contextlib.contextmanager
def timed_calls(targets):
    """Seconds spent in each of ``targets`` ((module, function name)) while
    the block runs: each is wrapped for the block and restored after it;
    the module's own calls of the function go through the wrapper too."""
    import torch
    seconds = {}
    originals = []

    def wrap(fn, key):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                seconds[key] = seconds.get(key, 0.0) + \
                    time.perf_counter() - t0
        return wrapper

    for module, name in targets:
        originals.append((module, name, getattr(module, name)))
        setattr(module, name, wrap(getattr(module, name), name))
    try:
        yield seconds
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)


def read_fastq_phase(testing, bam, fastq):
    """The reads of a synthetic BAM as FASTQ in basecalled orientation;
    returns their true starts."""
    with phase("reads of {} as FASTQ".format(os.path.basename(bam))):
        truth = testing.write_reads_fastq(bam, fastq)
    log("   {} reads".format(len(truth)))
    return truth


def run_from_reads(cli, gru_split, label, argv, timings=()):
    """One subcommand from reads through the CLI entry point, with the
    split kernels' launch counts set to 0 just before and read just after:
    returns (launches, launches by mode, seconds, seconds of each of
    ``timings``). Both split kernels must have launched."""
    import torch
    with phase("{}: {}".format(label, " ".join(argv))):
        with timed_calls(timings) as stage_s:
            gru_split.reset_launches()
            t0 = time.perf_counter()
            if cli.main(argv) != 0:
                raise AssertionError("{} failed".format(label))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = dict(gru_split.LAUNCHES)
            mode_launches = dict(gru_split.MODE_LAUNCHES)
    log("   launches on the {} path: {} {}; {:.2f} s ({})".format(
        label, launches, mode_launches, seconds,
        ", ".join("{} {:.2f} s".format(k, v) for k, v in stage_s.items())))
    if min(launches.values()) < 1:
        raise AssertionError("a split kernel never launched on the {} "
                             "path".format(label))
    return launches, mode_launches, seconds, dict(stage_s)


def copy_mapped_bam(src, dst_dir, name):
    """Place a mapped BAM and its index in an output directory under
    ``name``, so that the subcommand there skips its mapping stage."""
    import shutil
    os.makedirs(dst_dir, exist_ok=True)
    for suffix in ("", ".bai"):
        shutil.copy(src + suffix, os.path.join(dst_dir, name + suffix))


def from_reads_phases(seed, work, bam, draft, dev, modules):
    """The paths from reads (phase 21): (a) ``consensus`` and ``consensus
    --direct`` from the reads of phase 4's genome, (b) the ``variant``
    pipeline from the reads of a haploid genome of phase 20's generator,
    (c) ``consensus`` on those reads and ``tools consensus2vcf``, (d)
    ``consensus_joint`` on two read sets of a 0.1 Mb genome with a random
    20-feature model. Returns their records for the ``kernels`` line."""
    import numpy as np
    import torch
    (cli, datastore, features, gru_split, mapping, models, prediction,
     stitch, testing, vcf) = (modules[k] for k in (
         "cli", "datastore", "features", "gru_split", "mapping", "models",
         "prediction", "stitch", "testing", "vcf"))
    threads = os.cpu_count()
    log("   mapping and host stages with --threads {} (os.cpu_count())"
        .format(threads))
    paths = {}

    # (a) consensus from reads, both routes
    fastq = os.path.join(work, "reads.fastq")
    truth = read_fastq_phase(testing, bam, fastq)
    out_a = os.path.join(work, "from_reads")
    launches, mode_launches, seconds, stage_s = run_from_reads(
        cli, gru_split, "consensus from reads",
        ["consensus", fastq, draft, "-o", out_a, "--model",
         "gru256_lambda_demo", "-t", str(threads)],
        ((mapping, "align_reads"), (prediction, "predict"),
         (stitch, "stitch_to_fasta")))
    mapped_bam = os.path.join(out_a, "calls_to_draft.bam")
    with phase("check the consensus from reads"):
        share, wrong = testing.placement(mapped_bam, truth)
        _, n_columns = check_probabilities(
            datastore, os.path.join(out_a, "consensus_probs.hdf"))
        identity, edits, cons_len = consensus_identity(
            testing, os.path.join(out_a, "consensus.fasta"), draft)
    log("   mapping {:.2f} s at --threads {}: {} reads, {:.4f} with a "
        "primary, {} placed more than 50 bases from their start or on the "
        "other strand {}".format(stage_s["align_reads"], threads,
                                 len(truth), share, len(wrong), wrong[:5]))
    log("   inference {} columns in {:.2f} s: {:.0f} columns/s; stitch "
        "{:.2f} s; consensus {} bp, identity to the draft {:.6f} ({} "
        "edits)".format(
            n_columns, stage_s["predict"], n_columns / stage_s["predict"],
            stage_s["stitch_to_fasta"], cons_len, identity, edits))
    if share < 0.99 or wrong:
        raise AssertionError("mapping placed {:.4f} of the reads, {} "
                             "wrongly".format(share, len(wrong)))
    if identity < 0.99:
        raise AssertionError("consensus identity {} < 0.99".format(identity))
    paths["consensus"] = {
        "launches": launches, "launches_by_mode": mode_launches,
        "seconds": seconds, "mapping_s": stage_s["align_reads"],
        "mapping_threads": threads, "reads": len(truth),
        "mapped_share": share, "inference_s": stage_s["predict"],
        "stitch_s": stage_s["stitch_to_fasta"], "columns": n_columns,
        "columns_per_s": n_columns / stage_s["predict"],
        "identity": identity}
    out_direct = os.path.join(work, "from_reads_direct")
    copy_mapped_bam(mapped_bam, out_direct, "calls_to_draft.bam")
    launches, mode_launches, seconds, stage_s = run_from_reads(
        cli, gru_split, "consensus --direct from reads",
        ["consensus", fastq, draft, "-o", out_direct, "--model",
         "gru256_lambda_demo", "-t", str(threads), "--direct"],
        ((prediction, "predict_direct"),))
    with open(os.path.join(out_a, "consensus.fasta"), "rb") as fa, \
            open(os.path.join(out_direct, "consensus.fasta"), "rb") as fb:
        if fa.read() != fb.read():
            raise AssertionError("consensus --direct differs from the HDF5 "
                                 "route")
    log("   consensus --direct: byte-identical to the HDF5 route's FASTA, "
        "{:.0f} columns/s".format(n_columns / stage_s["predict_direct"]))
    paths["consensus_direct"] = {
        "launches": launches, "launches_by_mode": mode_launches,
        "seconds": seconds, "inference_s": stage_s["predict_direct"],
        "columns_per_s": n_columns / stage_s["predict_direct"]}

    # (b) the variant pipeline from reads, with the annotation, on a
    # genome cut to FROM_READS_VARIANT_MB: at phase 20's 0.5 Mb, mapping,
    # the annotator and (c)'s alignment took 140 s of a script that must
    # end in 1200
    with phase("variant genome from reads: {} Mb with planted variants at "
               "depth 30 (create_variant_bam; phase 20 has 0.5 Mb, cut for "
               "the time limit)".format(FROM_READS_VARIANT_MB)):
        var_bam, ref, truth_vcf, _ = testing.create_variant_bam(
            os.path.join(work, "variant_from_reads.bam"),
            ref_mb=FROM_READS_VARIANT_MB, depth=30, seed=seed)
    var_fastq = os.path.join(work, "variant_reads.fastq")
    read_fastq_phase(testing, var_bam, var_fastq)
    out_b = os.path.join(work, "variant_from_reads")
    launches, mode_launches, seconds, stage_s = run_from_reads(
        cli, gru_split, "variant from reads",
        ["variant", var_fastq, ref, "-o", out_b, "--model",
         "gru256_variant_demo", "-t", str(threads)],
        ((mapping, "align_reads"), (prediction, "predict"),
         (vcf, "annotate_vcf_n_reads")))
    annotated = os.path.join(out_b, "medaka.annotated.vcf")
    with phase("check the variant pipeline from reads"):
        probs = os.path.join(out_b, "consensus_probs.hdf")
        _, n_columns = check_probabilities(datastore, probs)
        # --threads t shards the probabilities over max(1, min(4, t // 2))
        # files, as medaka_tpu does: a manifest and 4 shards at 8 threads
        shards = datastore.expand_shards(probs)[1:]
        want_shards = max(1, min(4, threads // 2))
        if len(shards) != (want_shards if want_shards > 1 else 0):
            raise AssertionError("variant at --threads {} wrote {} shards, "
                                 "not {}".format(threads, len(shards),
                                                 want_shards))
        log("   probabilities over {} shards: {}".format(
            len(shards), [os.path.basename(f) for f in shards]))
        score = testing.score_vcf(truth_vcf, annotated, ref)
        raw_score = testing.score_vcf(
            truth_vcf, os.path.join(out_b, "medaka.vcf"), ref)
        planted = {(v.pos, v.ref, v.alt[0]) for v in
                   vcf.VCFReader(truth_vcf).fetch()
                   if len(v.ref) == len(v.alt[0]) == 1}
        records, snp_support = 0, []
        for v in vcf.VCFReader(annotated).fetch():
            records += 1
            missing = {"DP", "DPS", "DPSP", "SR", "SC", "AR"} - set(v.info)
            if missing:
                raise AssertionError("record {}:{} lacks {}".format(
                    v.chrom, v.pos, missing))
            if (v.pos, v.ref, v.alt[0]) in planted:
                sr = [int(x) for x in str(v.info["SR"]).split(",")]
                snp_support.append((v.pos, sr[0] + sr[1], sr[2] + sr[3]))
    weak = [s for s in snp_support if s[2] <= s[1]]
    log("   variant from reads: {} ({} records, {} columns, {:.0f} "
        "columns/s of inference; unannotated {}); annotator {:.2f} s; "
        "mapping {:.2f} s; {} planted SNPs called, alt SR support above "
        "ref's at all but {}".format(
            json.dumps(score), records, n_columns,
            n_columns / stage_s["predict"], json.dumps(raw_score),
            stage_s["annotate_vcf_n_reads"], stage_s["align_reads"],
            len(snp_support), weak[:5]))
    low = testing.below_floors(score, testing.FROM_READS_FLOORS["variant"])
    if low:
        raise AssertionError("the variant pipeline from reads is below its "
                             "floors: {}".format(low))
    if not snp_support or weak:
        raise AssertionError("planted SNPs whose alt SR support does not "
                             "exceed the ref's: {}".format(weak[:10]))
    paths["variant"] = {
        "probability_shards": len(shards),
        "launches": launches, "launches_by_mode": mode_launches,
        "seconds": seconds, "mapping_s": stage_s["align_reads"],
        "inference_s": stage_s["predict"], "columns": n_columns,
        "columns_per_s": n_columns / stage_s["predict"],
        "annotate_s": stage_s["annotate_vcf_n_reads"], "records": records,
        "score": score, "score_unannotated": raw_score,
        "planted_snps_called": len(snp_support)}

    # (c) consensus on the same mapped reads, then consensus2vcf in NW
    out_c = os.path.join(work, "consensus2vcf")
    copy_mapped_bam(os.path.join(out_b, "calls_to_ref.bam"), out_c,
                    "calls_to_draft.bam")
    launches, mode_launches, seconds, stage_s = run_from_reads(
        cli, gru_split, "consensus on the variant reads",
        ["consensus", var_fastq, ref, "-o", out_c, "--model",
         "gru256_variant_demo", "-t", str(threads)],
        ((prediction, "predict"),))
    prefix = os.path.join(work, "c2v")
    with phase("tools consensus2vcf --mode NW"):
        t0 = time.perf_counter()
        if cli.main(["tools", "consensus2vcf",
                     os.path.join(out_c, "consensus.fasta"), ref,
                     "--out_prefix", prefix, "--mode", "NW"]) != 0:
            raise AssertionError("consensus2vcf failed")
        c2v_s = time.perf_counter() - t0
        score = testing.score_vcf(truth_vcf, prefix + ".vcf", ref)
    log("   consensus2vcf: {} in {:.2f} s".format(json.dumps(score), c2v_s))
    low = testing.below_floors(score,
                               testing.FROM_READS_FLOORS["consensus2vcf"])
    if low:
        raise AssertionError("consensus2vcf is below its floors: {}".format(
            low))
    paths["consensus2vcf"] = {
        "launches": launches, "launches_by_mode": mode_launches,
        "seconds": seconds, "inference_s": stage_s["predict"],
        "consensus2vcf_s": c2v_s, "score": score}

    # (d) consensus_joint: two read sets and a random 20-feature model
    with phase("consensus_joint data: 0.1 Mb genome at depth 20, reads "
               "dealt over r9 and r10"):
        joint_bam, joint_draft = testing.create_synth_bam(
            os.path.join(work, "joint.bam"), ref_mb=0.1, depth=20,
            seed=seed + 1)
        sets = [os.path.join(work, "joint_{}.fastq".format(v))
                for v in ("r9", "r10")]
        testing.write_reads_fastq(joint_bam, sets)
        from medaka_tpu_torch.labels import HaploidLabelScheme
        from medaka_tpu_torch.models.gru import GRUModel
        torch.manual_seed(seed)
        joint_model = GRUModel(num_features=20, gru_size=256)
        encoder = features.CountsFeatureEncoder(dtypes=("r9", "r10"))
        model_path = models.save_model(
            os.path.join(work, "joint_model.tar.gz"), joint_model, encoder,
            HaploidLabelScheme())
    batch = prediction.auto_batch_size(joint_model, dev)
    out_d = os.path.join(work, "joint")
    launches, mode_launches, seconds, stage_s = run_from_reads(
        cli, gru_split, "consensus_joint (20 features, batch {}, mode "
        "{})".format(batch, gru_split.split_mode(batch)),
        ["consensus_joint", "-i", sets[0], "-v", "r9", "-i", sets[1], "-v",
         "r10", "-d", joint_draft, "-o", out_d, "-m", model_path, "-t",
         str(threads)],
        ((mapping, "align_reads"), (prediction, "predict")))
    with phase("consensus_joint: one batch of the merged BAM through the "
               "kernels vs their plain versions"):
        from medaka_tpu_torch.io.fastx import FastaReader
        # the weights are random: the FASTA must hold the contig, whatever
        # its sequence
        with FastaReader(os.path.join(out_d, "consensus.fasta")) as fr:
            joint_len = {n: len(fr.fetch(n)) for n in fr.references}
        if list(joint_len) != ["synth"] or not joint_len["synth"]:
            raise AssertionError("consensus_joint wrote {}".format(
                joint_len))
        joint_len = joint_len["synth"]
        merged = os.path.join(out_d, "calls_to_draft.bam")
        samples = []
        for region in prediction.plan_work(None, merged):
            samples.extend(features.SampleGenerator(
                merged, region, encoder, chunk_len=10000,
                chunk_overlap=1000).samples)
        # the rows the path's launches hold: the genome's chunks padded
        # to the automatic batch
        one = prediction.Batch.collate(samples, batch, 10000)
        xt = torch.from_numpy(one.features).to(torch.bfloat16) \
            .transpose(0, 1).contiguous().to(dev)
        lens = torch.from_numpy(one.lengths).to(dev)
        w = gru_split.prepare_split_weights(
            joint_model.layer_params(), joint_model.head_params(), "t", True,
            dev)
        l1_err, l2_err, stats, _ = compare_kernels(gru_split, w, xt, lens,
                                                   "t", True)
        if xt.shape[2] != 20 or not np.isfinite(stats["max"]):
            raise AssertionError("the joint batch has {} features".format(
                xt.shape[2]))
    log("   consensus_joint: {} bases; one batch of {} rows, the {} chunks "
        "of the genome padded ({} features): l1 max {:.3g}, l2 logit max "
        "{:.3g}; probs max {:.3g} mean {:.3g}, argmax agreement {:.6f}; "
        "layer-1 geometry {}".format(
            joint_len, xt.shape[1], len(samples), xt.shape[2],
            l1_err, l2_err,
            stats["max"], stats["mean"], stats["argmax_agreement"],
            gru_split.geometry("l1", 256, batch, dev, "t", 20)))
    paths["consensus_joint"] = {
        "launches": launches, "launches_by_mode": mode_launches,
        "seconds": seconds, "mapping_s": stage_s["align_reads"],
        "inference_s": stage_s["predict"], "batch": batch,
        "features": 20, "l1_max": l1_err, "logit_max": l2_err,
        "network": stats}
    return paths


#: the run-length bundle (120 inputs, 49 classes) of phases 22 and 23
RLE_MODEL = "gru256_rle_demo"
RLE_INPUTS, RLE_CLASSES = 120, 49
#: phase 4's genome is cut to its first RLE_REGION_KB kb for compress_bam,
#: whose SW re-alignment of 20 kb reads in compressed space took 45.7 s for
#: 0.06 Mb at depth 20 on 4 CPU threads (about 190 s at 0.5 Mb on 8)
RLE_REGION_KB = 60
#: the compact region run again with --cpu, kb
RLE_CPU_REGION_KB = 20
#: the expanded RLE consensus's identity to the draft at least: the CPU
#: route's bf16 scan gave 0.9933 on the first 20 kb (compact) of a 0.06 Mb
#: create_synth_bam genome
MIN_RLE_IDENTITY = 0.985
#: mode "rows" rows of phase 22, as in phase 7
RLE_ROWS_BATCH = 64
#: steps of phase 22's bf16 (quant=False) comparisons, cut from T=10000
#: for the time limit (the plain versions step once a column a launch)
RLE_BF16_T = 1000


def rle_identity(testing, fasta, draft_seq, rle):
    """(identity to the draft, edits, draft bases) of a run-length
    consensus written with ``--no-fillgaps``: each record ("synth_k
    start-stop", compact coordinates) expanded, against the draft's bases
    of those compact columns."""
    from medaka_tpu_torch.io.fastx import read_fastx
    conv = rle.RLEConverter(draft_seq)
    edits = bases = 0
    for rec in read_fastx(fasta):
        start, stop = (int(v) for v in rec.comment.split("-"))
        a = int(conv.coord_compact_to_full(start))
        b = (int(conv.coord_compact_to_full(stop))
             if stop < len(conv.compact_basecall) else len(draft_seq))
        edits += testing.greedy_edit_count(rec.sequence.encode(),
                                           draft_seq[a:b].encode())
        bases += b - a
    if not bases:
        raise AssertionError("no consensus record in {}".format(fasta))
    return 1.0 - edits / bases, edits, bases


def compare_routes(datastore, card_hdf, cpu_hdf):
    """The card's probabilities against the CPU route's on the same
    samples: max and mean difference, argmax agreement, and each column
    whose argmax differs, which must be a near tie (the CPU route's
    probability of the card's class within ``TOL_SCAN_PROB_MAX`` of its
    best). Fails past the bars of the int8 path against the scan."""
    import numpy as np
    probs = []
    for path in (card_hdf, cpu_hdf):
        index = datastore.DataIndex(path)
        probs.append({s.name: s for s in index.yield_from_feature_files(
            samples=index.samples)})
    card, cpu = probs
    if sorted(card) != sorted(cpu):
        raise AssertionError("the card and the CPU wrote other samples")
    worst, total, count, differ = 0.0, 0.0, 0, []
    for name in sorted(card):
        a, b = card[name].label_probs, cpu[name].label_probs
        diff = np.abs(a - b)
        worst, total, count = (max(worst, float(diff.max())),
                               total + float(diff.sum()),
                               count + diff.size)
        ka, kb = a.argmax(-1), b.argmax(-1)
        for i in np.flatnonzero(ka != kb):
            differ.append({"sample": name, "column": int(i),
                           "card_class": int(ka[i]),
                           "cpu_class": int(kb[i]),
                           "cpu_gap": float(b[i, kb[i]] - b[i, ka[i]])})
    columns = sum(s.label_probs.shape[0] for s in card.values())
    out = {"max": worst, "mean": total / count,
           "argmax_agreement": 1.0 - len(differ) / columns,
           "differing_columns": differ}
    if worst > TOL_SCAN_PROB_MAX or out["mean"] > TOL_SCAN_PROB_MEAN or \
            out["argmax_agreement"] < MIN_SCAN_ARGMAX_AGREEMENT or \
            any(d["cpu_gap"] > TOL_SCAN_PROB_MAX for d in differ):
        raise AssertionError("the card's probabilities disagree with the "
                             "CPU's: {}".format(out))
    return out


def rle_phases(work, bam, draft, dev, rows, modules):
    """The run-length path (phase 23) and its kernels (phase 22): returns
    the ``kernels`` rows of ``gru_l1_split`` at 120 inputs and
    ``gru_l2head_split`` at 49 classes; adds the fullfused layer at 120
    inputs to ``rows``' bigru_fullfused/f32_gates and bigru_project."""
    import torch
    cli, datastore, features, gru_fullfused, gru_split, models, \
        prediction = (modules[k] for k in (
            "cli", "datastore", "features", "gru_fullfused", "gru_split",
            "models", "prediction"))
    from medaka_tpu_torch import rle, testing
    from medaka_tpu_torch.common import Region
    from medaka_tpu_torch.io.fastx import FastaReader, FastaWriter
    threads = os.cpu_count()
    rle_bam = os.path.join(work, "rle_reads.bam")
    compact = os.path.join(work, "compact_draft.fasta")
    with FastaReader(draft) as fr:
        draft_seq = fr.fetch("synth")
    with phase("RLE path data: compress_bam of phase 4's BAM over its first "
               "{} kb (cut for the time limit), --threads {}".format(
                   RLE_REGION_KB, threads)):
        t0 = time.perf_counter()
        rle.compress_bam(bam, rle_bam, draft, threads=threads,
                         regions=[Region("synth", 0, RLE_REGION_KB * 1000)])
        compress_s = time.perf_counter() - t0
        conv = rle.RLEConverter(draft_seq)
        with FastaWriter(compact) as fw:
            fw.write("synth", conv.compact_basecall)
    log("   compress_bam {:.2f} s; compact draft {} bases of {}".format(
        compress_s, len(conv.compact_basecall), len(draft_seq)))
    covered = conv.transform_coords(0, RLE_REGION_KB * 1000)[1]
    region = "synth:0-{}".format(covered)
    bundle = models.load_model(models.resolve_model(RLE_MODEL))
    batch = prediction.auto_batch_size(bundle.model, dev)
    mode = gru_split.split_mode(batch)
    H = bundle.model.gru_size
    geometry = {
        "{}_{}".format(kind, key): dict(zip(
            ("cluster", "columns", "smem_bytes", "resident_clusters"),
            gru_split.geometry(kind, H, cols, dev, m,
                               RLE_INPUTS if kind == "l1" else 0,
                               RLE_CLASSES)))
        for kind in ("l1", "l2")
        for key, cols, m in (("main", batch, mode),
                             ("rows_B64", RLE_ROWS_BATCH, "rows"),
                             ("one_column", 1, mode))}
    log("   RLE bundle: automatic batch {} (mode {}); launch geometry "
        "{}".format(batch, mode, json.dumps(geometry)))

    hdf = os.path.join(work, "rle_probs.hdf")
    fasta = os.path.join(work, "rle_consensus.fasta")
    with phase("RLE path: inference --model {} + sequence --no-fillgaps"
               .format(RLE_MODEL)):
        gru_split.reset_launches()
        t0 = time.perf_counter()
        if cli.main(["inference", rle_bam, hdf, "--model", RLE_MODEL]) != 0:
            raise AssertionError("RLE inference failed")
        torch.cuda.synchronize()
        t_inference = time.perf_counter() - t0
        launches = dict(gru_split.LAUNCHES)
        mode_launches = dict(gru_split.MODE_LAUNCHES)
        if cli.main(["sequence", hdf, compact, fasta, "--regions", region,
                     "--no-fillgaps"]) != 0:
            raise AssertionError("RLE sequence failed")
    log("   launches on the RLE path:", launches, mode_launches)
    if min(launches.values()) < 1:
        raise AssertionError("a split kernel never launched on the RLE path")
    with phase("check the RLE output"):
        n_samples, n_columns = check_probabilities(datastore, hdf,
                                                   RLE_CLASSES)
        identity, edits, bases = rle_identity(testing, fasta, draft_seq, rle)
        log("   {} samples, {} compact columns in {:.2f} s: {:.0f} "
            "columns/s; expanded consensus over {} draft bases, identity "
            "{:.6f} ({} edits)".format(
                n_samples, n_columns, t_inference, n_columns / t_inference,
                bases, identity, edits))
        if identity < MIN_RLE_IDENTITY:
            raise AssertionError("RLE consensus identity {} < {}".format(
                identity, MIN_RLE_IDENTITY))
    cpu_region = "synth:0-{}".format(RLE_CPU_REGION_KB * 1000)
    with phase("the RLE path over {} on the card and with --cpu".format(
            cpu_region)):
        outs = {}
        # the CPU runs its 3 chunks in a batch of 4 (its automatic batch,
        # 128, would step 125 padding rows too)
        for tag, extra in (("card", []),
                           ("cpu", ["--cpu", "--batch_size", "4"])):
            h = os.path.join(work, "rle_{}.hdf".format(tag))
            f = os.path.join(work, "rle_{}.fasta".format(tag))
            t0 = time.perf_counter()
            if cli.main(["inference", rle_bam, h, "--model", RLE_MODEL,
                         "--regions", cpu_region] + extra) != 0 or \
                    cli.main(["sequence", h, compact, f, "--regions",
                              cpu_region, "--no-fillgaps"]) != 0:
                raise AssertionError("RLE path over {} failed ({})".format(
                    cpu_region, tag))
            with open(f, "rb") as fh:
                outs[tag] = fh.read()
            log("   {}: {:.2f} s, {} bytes".format(
                tag, time.perf_counter() - t0, len(outs[tag])))
        cpu_check = {"identical": outs["card"] == outs["cpu"]}
        if not cpu_check["identical"]:
            # the int8 kernels and the CPU's bf16 scan round differently:
            # the FASTAs may differ only where the two routes' argmax
            # differs, at near ties, within the bars of the int8 path
            # against the scan (phase 6), each such column changing at
            # most one run of up to max_run bases
            cpu_check.update(compare_routes(
                datastore, *(os.path.join(work, "rle_{}.hdf".format(t))
                             for t in ("card", "cpu"))))
            seqs = [b"".join(line for line in o.split(b"\n")
                             if not line.startswith(b">"))
                    for o in (outs["card"], outs["cpu"])]
            cpu_check["fasta_edits"] = testing.greedy_edit_count(*seqs)
            max_run = bundle.label_scheme.max_run
            if cpu_check["fasta_edits"] > max_run * len(
                    cpu_check["differing_columns"]):
                raise AssertionError("the RLE consensus on the card differs "
                                     "from the CPU's over {} beyond its "
                                     "argmax differences: {}".format(
                                         cpu_region, cpu_check))
        log("   card against --cpu: {}".format(json.dumps(cpu_check)))

    # phase 22: the kernels at the path's shapes
    rows_out = []
    with phase("RLE kernels: gru_l1_split at 120 inputs, gru_l2head_split "
               "at 49 classes, automatic batch {} and mode rows on {} rows; "
               "the fullfused layer at B=16".format(batch, RLE_ROWS_BATCH)):
        samples = []
        for work_region in prediction.plan_work(None, rle_bam):
            samples.extend(features.SampleGenerator(
                rle_bam, work_region, bundle.feature_encoder,
                chunk_len=10000, chunk_overlap=1000).samples)
        main_batch = prediction.Batch.collate(samples[:batch], batch, 10000)
        T, B, IN, C = 10000, batch, RLE_INPUTS, RLE_CLASSES
        model = bundle.model.to(dev)
        xt = torch.from_numpy(main_batch.features).to(torch.bfloat16) \
            .transpose(0, 1).contiguous().to(dev)
        lens = torch.from_numpy(main_batch.lengths).to(dev)
        lengths_sum = int(main_batch.lengths.sum())
        names = ("gru_l1_split", "gru_l2head_split")
        results = {name: {} for name in names}
        for key, rows_, m in (("main", B, mode), ("rows", RLE_ROWS_BATCH,
                                                   "rows")):
            for quant in (True, False):
                steps = T if quant else RLE_BF16_T
                x = xt[:steps, :rows_].contiguous()
                ln = torch.clamp(lens[:rows_], max=steps).contiguous()
                w = gru_split.prepare_split_weights(
                    model.layer_params(), model.head_params(), m, quant,
                    dev)
                plain_ms = {}
                l1_err, l2_err, stats, (kf, kb) = compare_kernels(
                    gru_split, w, x, ln, m, quant, plain_ms)
                tag = "{}/{}".format(key, "int8" if quant else "bf16")
                args1 = (x, ln, w["w_ih1"], w["b_ih1"], w["w_hh1"], w["sc1"],
                         w["b_hh1"])
                args2 = (kf, kb, ln, w["w_in2"], w["in_scale2"], w["b_ih2"],
                         w["w_hh2"], w["sc2"], w["b_hh2"], w["w_head"])
                log("   {} B={} T={}: l1 max {:.3g}, l2 logit max {:.3g}; "
                    "probs max {:.3g}, argmax agreement {:.6f}".format(
                        tag, rows_, steps, l1_err, l2_err, stats["max"],
                        stats["argmax_agreement"]))
                vsum = int(ln.sum())
                for name, fn, args, err in (
                        ("gru_l1_split", gru_split.gru_l1_split, args1,
                         l1_err),
                        ("gru_l2head_split", gru_split.gru_l2head_split,
                         args2, l2_err)):
                    rec = {"B": rows_, "T": steps, "valid_columns": vsum,
                           "max_abs_err": err, "model_vs_plain": stats,
                           "ms": cuda_ms(lambda: fn(*args, mode=m,
                                                    quant=quant)),
                           "plain_ms": plain_ms[name]}
                    if quant:
                        one = ((args[0][:, :1].contiguous(), args[1][:1])
                               + args[2:]) if name == "gru_l1_split" else \
                            ((args[0][:, :1].contiguous(),
                              args[1][:, :1].contiguous(), args[2][:1])
                             + args[3:])
                        rec["serial_floor_ms"] = cuda_ms(
                            lambda: fn(*one, mode=m))
                        rec["bound_ms"], rec["bound_by"] = bound(
                            name, rows_, H, IN, C, vsum)
                    else:
                        kind = "l1" if name == "gru_l1_split" else "l2"
                        rec["geometry"] = dict(zip(
                            ("cluster", "columns", "smem_bytes",
                             "resident_clusters"),
                            gru_split.geometry(kind, H, rows_, dev, m,
                                               IN if kind == "l1" else 0, C,
                                               quant=False)))
                    rec["step_us"] = rec["ms"] / steps * 1e3
                    results[name][tag] = rec
                    log("   {} {}: {}".format(name, tag, json.dumps(rec)))
                del kf, kb, args1, args2, w
        # cuDNN's layer 1 over the same rows (the port never calls it)
        library = {}
        with torch.inference_mode():
            for key, rows_ in (("main", B), ("rows", RLE_ROWS_BATCH)):
                library[key] = yardstick_ms(main_batch.features[:rows_], IN,
                                            1, H, dev)
        log("   torch.nn.GRU({}, {}, 1, bidirectional=True) bf16 (cuDNN): "
            "{}".format(IN, H, json.dumps(library)))
        # the fullfused route at B=16 (batches below 32): layer 1 at 120
        # inputs through the tensor-core projection and the cluster
        # recurrence, against its plain version
        B16 = SMALL_BATCH
        x16 = xt[:, :B16].contiguous()
        len16 = lens[:B16].contiguous()
        w1 = tuple(t.detach() for t in stacked_layer(
            model.layer_params()[0]))
        _, ff_stats, ff_plain_ms = compare_fullfused(
            gru_fullfused, "f32_gates", x16, w1, len16)
        ff_sum = int(len16.sum())
        ff = {"B": B16, "T": T, "IN": IN, "valid_columns": ff_sum,
              "agreement": ff_stats, "plain_ms": ff_plain_ms,
              "ms": cuda_ms(lambda: gru_fullfused.fullfused_layer(
                  x16, *w1, len16, "f32_gates"))}
        ff["bound_ms"], ff["bound_by"], _ = fullfused_bound(
            "bigru_fullfused/f32_gates", B16, H, IN, ff_sum)
        proj = {"ms": cuda_ms(lambda: gru_fullfused.project(
                    x16, w1[0], w1[1])),
                "plain_ms": cuda_ms(lambda: gru_fullfused.project_plain(
                    x16, w1[0], w1[1]), reps=1, warmup=0),
                "agreement": ff_stats["projection"]}
        proj["bound_ms"], proj["bound_by"], _ = fullfused_bound(
            "bigru_project", B16, H, IN, ff_sum)
        log("   fullfused f32_gates layer 1 at IN={}, B={}: {}; projection "
            "stage alone: {}".format(IN, B16, json.dumps(ff),
                                      json.dumps(proj)))
        for row in rows:
            if row["name"] == "bigru_fullfused/f32_gates":
                row["rle_in120"] = ff
            elif row["name"] == "bigru_project":
                row["rle_in120"] = proj
        del xt, model
        torch.cuda.empty_cache()
    path = {"launches": launches, "launches_by_mode": mode_launches,
            "card_against_cpu": cpu_check,
            "columns_per_s": n_columns / t_inference,
            "compress_bam_s": compress_s, "identity": identity,
            "automatic_batch": batch, "mode": mode, "geometry": geometry}
    for name in names:
        suffix = "in120" if name == "gru_l1_split" else "classes49"
        main = results[name]["main/int8"]
        rows_out.append({
            "name": "{}/{}".format(name, suffix), "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES[name],
            "launches": launches[name],
            "launches_on": "inference --model {} on the RLE-compressed BAM "
                           "(phase 23)".format(RLE_MODEL),
            "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "kernel_ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            # cuDNN's layer 1 computes layer 1's function on these rows;
            # no single PyTorch call computes layer 2 + the head
            "library_ms": library["main"] if name == "gru_l1_split"
            else None,
            "library": "torch.nn.GRU({}, {}, 1, bidirectional=True) bf16 "
                       "(cuDNN): {}".format(IN, H, json.dumps(library)),
            "serial_floor_ms": main["serial_floor_ms"],
            "step_us": main["step_us"],
            "shape": {"B": B, "T": T, "H": H, "IN": IN, "classes": C,
                      "valid_columns": main["valid_columns"]},
            "by_mode": results[name],
            "geometry": {k: v for k, v in geometry.items()
                         if k.startswith("l1" if name == "gru_l1_split"
                                         else "l2")},
            "rle_path": path})
    return rows_out, path


#: phase 31: the rows an epoch of the f32 runs takes (cut from phase 11's
#: 512: the f32 scan under autograd launches kernels gate op by gate op,
#: 5 s a step on an H100)
SCALE_F32_SAMPLES = 128
#: phase 31's bars between two gloo ranks on one card and one nccl rank:
#: f32 counts training, each training.csv loss (relative) and the last
#: checkpoint's weights (absolute); the read-level bf16 step, its loss
#: (relative) and each running statistic (relative to the largest of its
#: vector). Measured on an H100 (PERF.md): 7.4e-8 and 4.1e-8 (f32), 0 and
#: 1.9e-7 (read-level); the only difference is the order of the sums over
#: the ranks
TOL_RANKS_F32_LOSS = 1e-6
TOL_RANKS_F32_WEIGHTS = 1e-6
TOL_RANKS_RL_LOSS = 1e-5
TOL_RANKS_RL_STATS = 1e-5
#: phase 30: the work unit (``--bam_chunk``) that gives both processes a
#: share of the 0.5 Mb contig, and the most FASTA edits against phase 5's
#: one-region run (other chunk boundaries at the region join)
MULTI_PROCESS_BAM_CHUNK = 250000
MAX_MULTI_PROCESS_EDITS = 10

MULTI_PROCESS_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from medaka_tpu_torch import cli
from medaka_tpu_torch.ops import gru_split
t0 = time.perf_counter()
rc = cli.main(sys.argv[3:])
torch.cuda.synchronize()
with open(sys.argv[2], "w") as fh:
    json.dump({"rc": rc, "seconds": time.perf_counter() - t0,
               "launches": gru_split.LAUNCHES,
               "mode_launches": gru_split.MODE_LAUNCHES}, fh)
"""


def probabilities_agree(datastore, got_hdf, want_hdf):
    """Two probability files of the same samples within the whole-network
    bars (``TOL_PROB``, ``MIN_ARGMAX_AGREEMENT``), each column whose
    argmax differs a near tie of ``want_hdf`` (its gap within
    ``TOL_PROB``); returns the statistics and whether the bits are
    equal."""
    import numpy as np
    probs = []
    for path in (got_hdf, want_hdf):
        index = datastore.DataIndex(path)
        probs.append({s.name: s.label_probs for s in
                      index.yield_from_feature_files(samples=index.samples)})
    got, want = probs
    if sorted(got) != sorted(want) or not got:
        raise AssertionError("{} and {} hold other samples".format(
            got_hdf, want_hdf))
    worst, differ, columns, same = 0.0, [], 0, True
    for name in sorted(got):
        a, b = got[name], want[name]
        same = same and a.tobytes() == b.tobytes()
        worst = max(worst, float(np.abs(a - b).max()))
        columns += a.shape[0]
        ka, kb = a.argmax(-1), b.argmax(-1)
        differ += [float(b[i, kb[i]] - b[i, ka[i]])
                   for i in np.flatnonzero(ka != kb)]
    out = {"max": worst, "argmax_agreement": 1.0 - len(differ) / columns,
           "differing_columns": len(differ),
           "largest_gap": max(differ, default=0.0), "bit_identical": same}
    if worst > TOL_PROB or out["argmax_agreement"] < MIN_ARGMAX_AGREEMENT \
            or out["largest_gap"] > TOL_PROB:
        raise AssertionError("{} disagrees with {}: {}".format(
            got_hdf, want_hdf, out))
    return out


def halves_and_whole(prediction, model, batch, n):
    """``batch`` through two replicas on cuda:0, through one replica fed
    each half (the same launches), and through one replica whole; returns
    the three outputs and the two replicas' launches."""
    import numpy as np
    half = batch.features.shape[0] // 2
    one = prediction.Predictor(model, device="cuda:0")
    halves = np.concatenate([one.fetch(one.dispatch(prediction.Batch(
        batch.features[rows], batch.lengths[rows], [None] * half)), half)
        for rows in (slice(0, half), slice(half, 2 * half))])[:n]
    whole = one.fetch(one.dispatch(batch), n)
    two = prediction.Predictor(model, devices=["cuda:0", "cuda:0"])
    got = two.fetch(two.dispatch(batch), n)
    return got, halves, whole, [dict(c) for c in two.launches]


def ranks_run(training, path, features, devices, validation=True,
              **kwargs):
    """run_training over ``devices`` from phase 11's or 14's features with
    phase 11's arguments (without the validation passes unless
    ``validation``); returns (training.csv table, wall seconds)."""
    import torch
    torch.cuda.empty_cache()
    batcher = training.TrainBatcher(
        [features], batch_size=128, seed=kwargs["seed"],
        max_valid_samples=None if validation else 0)
    t0 = time.perf_counter()
    training.run_training(path, batcher, epochs=kwargs.pop("epochs", 2),
                          optimizer="adam",
                          optim_args={"learning_rate": 1e-3},
                          devices=devices, **kwargs)
    return csv_table(os.path.join(path, "training.csv")), \
        time.perf_counter() - t0


def train_rows(table, split="train"):
    """The rows of a training.csv table (``csv_table``) of ``split`` (every
    row for None), each a dict."""
    header, rows = table
    return [dict(zip(header, r)) for r in rows
            if split is None or r[header.index("split")] == split]


def max_relative(got, want):
    """The largest relative difference of two equally long lists."""
    if len(got) != len(want):
        raise AssertionError("{} values against {}".format(len(got),
                                                           len(want)))
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def step_ms(table):
    """Mean milliseconds of a train step: each epoch's last train row's
    time over its batches."""
    rows = train_rows(table)
    last = {}
    for r in rows:
        last[r["epoch"]] = r
    return 1e3 * sum(float(r["time"]) for r in last.values()) / len(rows)


def rank_reports(path, n):
    out = []
    for rank in range(n):
        with open(os.path.join(path, "rank{}.json".format(rank))) as fh:
            out.append(json.load(fh))
    return out


def scale_out_phases(seed, work, bam, draft, hdf, fasta, main_rate,
                     rl_features, dev, modules):
    """Scale-out on one card (phases 29-31): data-parallel inference over
    two replicas on cuda:0, two concurrent ``inference --num_processes 2``
    processes, and data-parallel training over two gloo ranks on cuda:0
    against one nccl rank. Two replicas or ranks share one card: no figure
    here is a scale-out figure. Returns the launches by kernels row and
    path, and what the phases measured."""
    import numpy as np
    import torch
    cli, datastore, features, gru_fullfused, gru_split, models, \
        prediction, testing, training, bilstm = (modules[k] for k in (
            "cli", "datastore", "features", "gru_fullfused", "gru_split",
            "models", "prediction", "testing", "training", "bilstm"))
    launches = {}
    out = {}
    bundle = models.load_model(MODEL)
    card = card_line()

    rep_hdf = os.path.join(work, "replicas.hdf")
    rep_fasta = os.path.join(work, "replicas.fasta")
    with phase("(29) data-parallel inference: phase 4's BAM over two "
               "replicas on cuda:0, batch 480 (240 rows a replica, mode t)"):
        gru_split.reset_launches()
        gru_fullfused.reset_launches()
        t0 = time.perf_counter()
        n_samples, n_columns = prediction.predict(
            bam, rep_hdf, model_path=MODEL, batch_size=480,
            devices=["cuda:0", "cuda:0"])
        torch.cuda.synchronize()
        t_rep = time.perf_counter() - t0
        per_replica = [dict(c) for c in prediction.REPLICA_LAUNCHES]
        total = dict(gru_split.LAUNCHES)
        modes = dict(gru_split.MODE_LAUNCHES)
        if cli.main(["sequence", rep_hdf, draft, rep_fasta]) != 0:
            raise AssertionError("sequence failed")
        stats = probabilities_agree(datastore, rep_hdf, hdf)
        edits = consensus_identity(testing, rep_fasta, fasta)[1]
        log("   per replica launches {}; in all {} {}; {:.0f} columns/s "
            "({} columns in {:.2f} s) beside one replica's {:.0f} (phase "
            "5); two replicas share one card ({}): no scale-out figure"
            .format(per_replica, total, modes, n_columns / t_rep,
                    n_columns, t_rep, main_rate, card))
        log("   probabilities against phase 5's: {}; FASTA {} edits from "
            "phase 5's".format(json.dumps(stats), edits))
        for name in ("gru_l1_split", "gru_l2head_split"):
            if any(r.get(name, 0) < 1 for r in per_replica) or \
                    modes[name + "/t"] != total[name] or \
                    sum(r.get(name, 0) for r in per_replica) != total[name]:
                raise AssertionError("{} did not run mode t on each replica "
                                     "({})".format(name, per_replica))
        if edits > stats["differing_columns"]:
            raise AssertionError("the replicas' FASTA differs from phase "
                                 "5's past its near-tie columns")
        out["replicas"] = {"columns_per_s": n_columns / t_rep,
                           "one_replica_columns_per_s": main_rate,
                           "per_replica_launches": per_replica,
                           "vs_phase5": stats, "fasta_edits": edits}
        for name in ("gru_l1_split", "gru_l2head_split"):
            launches.setdefault(name, {})["replicas"] = [
                r.get(name, 0) for r in per_replica]

    with phase("(29) one 480-row batch: two replicas against one replica "
               "fed each half (bit for bit) and whole; a 200-row batch (mode "
               "rows on each replica) against the halves"):
        samples = []
        for region in prediction.plan_work(None, bam):
            samples.extend(features.SampleGenerator(
                bam, region, bundle.feature_encoder, chunk_len=10000,
                chunk_overlap=1000).samples)
        batch = prediction.Batch.collate(samples[:480], 480, 10000)
        n = min(480, len(samples))
        got, halves, whole, _ = halves_and_whole(prediction, bundle.model,
                                                 batch, n)
        valid = np.arange(10000)[None, :] < batch.lengths[:n, None]
        diff = np.abs(got - whole)[valid]
        agree = float((got.argmax(-1) == whole.argmax(-1))[valid].mean())
        log("   bit-identical to the halves: {}; against the whole batch: "
            "max {:.3g}, argmax agreement {:.6f}".format(
                bool(np.array_equal(got, halves)), diff.max(), agree))
        if not np.array_equal(got, halves):
            raise AssertionError("two replicas differ from one replica on "
                                 "the same halves")
        if diff.max() > TOL_PROB or agree < MIN_ARGMAX_AGREEMENT:
            raise AssertionError("two replicas disagree with one")
        # a 200-row batch: 100 rows a replica take mode "rows" (#3, #4)
        gru_split.reset_launches()
        batch = prediction.Batch.collate(samples[:200], 200, 10000)
        got, halves, _, rows_launches = halves_and_whole(
            prediction, bundle.model, batch, min(200, len(samples)))
        log("   200 rows: per replica launches {}, modes {}; bit-identical "
            "to the halves: {}".format(rows_launches,
                                       dict(gru_split.MODE_LAUNCHES),
                                       bool(np.array_equal(got, halves))))
        if not np.array_equal(got, halves) or any(
                r.get(k, 0) != 1 for r in rows_launches
                for k in ("gru_l1_split", "gru_l2head_split")):
            raise AssertionError("two replicas at 100 rows each differ from "
                                 "one replica on the same halves")
        for name in ("gru_l1_split", "gru_l2head_split"):
            launches[name]["replicas_rows_mode"] = [
                r[name] for r in rows_launches]

    with phase("(29) --batch_size 16 over two replicas (bigru_fullfused at "
               "8 rows each) against the plain versions"):
        batch = prediction.Batch.collate(samples[:SMALL_BATCH], SMALL_BATCH,
                                         10000)
        model = bundle.model
        two = prediction.Predictor(model, devices=["cuda:0", "cuda:0"])
        gru_fullfused.reset_launches()
        got = two.fetch(two.dispatch(batch), SMALL_BATCH)
        torch.cuda.synchronize()
        ff = [dict(c) for c in two.launches]
        x = torch.from_numpy(batch.features).to(dev)
        lens = torch.from_numpy(batch.lengths).to(dev)
        layers = [stacked_layer(layer) for layer in model.layer_params()]
        with torch.inference_mode():
            h = x.transpose(0, 1).to(torch.bfloat16).contiguous()
            for w in layers:
                h = gru_fullfused.bigru_fullfused_plain(h, *w, lens)
            want = torch.softmax(
                h.transpose(0, 1).float() @ model.linear.weight.float().t()
                + model.linear.bias.float(), -1).cpu().numpy()
        valid = np.arange(10000)[None, :] < batch.lengths[:, None]
        diff = np.abs(got - want)[valid]
        agree = float((got.argmax(-1) == want.argmax(-1))[valid].mean())
        log("   per replica launches {}; probs max {:.3g} mean {:.3g}, "
            "argmax agreement {:.6f}".format(ff, diff.max(), diff.mean(),
                                             agree))
        if any(r.get("bigru_fullfused", 0) != 2 for r in ff):
            raise AssertionError("each replica must launch bigru_fullfused "
                                 "twice: {}".format(ff))
        if diff.max() > TOL_FULLFUSED_PROB_MAX or \
                diff.mean() > TOL_SCAN_PROB_MEAN or \
                agree < MIN_ARGMAX_AGREEMENT:
            raise AssertionError("the replicas' fullfused route disagrees "
                                 "with its plain version")
        launches["bigru_fullfused/f32_gates"] = {
            "replicas_batch16": [r["bigru_fullfused"] for r in ff]}
        del two, x, lens, h

    with phase("(29) one read-level batch over two replicas (bilstm_fused "
               "on 64 rows each)"):
        rl = models.load_model(RL_MODEL)
        region = prediction.plan_work(None, bam)[0]
        rl_samples = features.SampleGenerator(
            bam, region, rl.feature_encoder, chunk_len=1000,
            chunk_overlap=100).samples[:128]
        batch = prediction.Batch.collate(
            rl_samples, 128, 1000, rl.feature_encoder.max_reads)
        bilstm.reset_launches()
        got, halves, whole, rl_launches = halves_and_whole(
            prediction, rl.model, batch, len(rl_samples))
        valid = np.arange(1000)[None, :] < \
            batch.lengths[:len(rl_samples), None]
        diff = np.abs(got - whole)[valid]
        agree = float((got.argmax(-1) == whole.argmax(-1))[valid].mean())
        log("   per replica launches {}; bit-identical to the halves: {}; "
            "against the whole batch: max {:.3g}, argmax agreement "
            "{:.6f}".format(rl_launches, bool(np.array_equal(got, halves)),
                            diff.max(), agree))
        if any(r.get("bilstm_fused", 0) != 2 for r in rl_launches):
            raise AssertionError("each replica must launch bilstm_fused "
                                 "twice: {}".format(rl_launches))
        if not np.array_equal(got, halves) or diff.max() > TOL_PROB or \
                agree < MIN_ARGMAX_AGREEMENT:
            raise AssertionError("the read-level replicas disagree")
        launches["bilstm_fused"] = {
            "replicas": [r["bilstm_fused"] for r in rl_launches]}
        del rl, batch, got, halves, whole
        torch.cuda.empty_cache()

    mp_hdf = os.path.join(work, "mp.hdf")
    with phase("(30) multi-process inference: two concurrent inference "
               "--num_processes 2 processes on the card, then sequence"):
        results = [os.path.join(work, "mp{}.json".format(i))
                   for i in range(2)]
        args = ["inference", bam, mp_hdf, "--model", MODEL, "--bam_chunk",
                str(MULTI_PROCESS_BAM_CHUNK), "--num_processes", "2",
                "--quiet"]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", MULTI_PROCESS_CHILD, HERE, results[i]]
            + args + ["--process_id", str(i)], cwd=HERE,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for i in range(2)]
        try:
            logs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        t_mp = time.perf_counter() - t0
        reports = []
        for p, text, res in zip(procs, logs, results):
            if p.returncode != 0 or not os.path.exists(res):
                raise AssertionError("a process failed: {}".format(
                    text[-3000:]))
            with open(res) as fh:
                reports.append(json.load(fh))
        hosts = [os.path.join(work, "mp_host{}.hdf".format(i))
                 for i in range(2)]
        mp_fasta = os.path.join(work, "mp.fasta")
        if cli.main(["sequence"] + hosts + [draft, mp_fasta]) != 0:
            raise AssertionError("sequence of the host files failed")
        # the same work list in one process, for the samples' bits
        one_hdf = os.path.join(work, "mp_one.hdf")
        if cli.main(["inference", bam, one_hdf, "--model", MODEL,
                     "--bam_chunk", str(MULTI_PROCESS_BAM_CHUNK),
                     "--quiet"]) != 0:
            raise AssertionError("the one-process run failed")
        merged = os.path.join(work, "mp_merged.hdf")
        with datastore.DataStore(merged, "w") as ds:
            ds.set_meta(bundle.feature_encoder, "feature_encoder")
            ds.set_meta(bundle.label_scheme, "label_scheme")
            for h in hosts:
                index = datastore.DataIndex(h)
                for s in index.yield_from_feature_files(
                        samples=index.samples):
                    ds.write_sample(s)
            ds.write_registry()
        stats = probabilities_agree(datastore, merged, one_hdf)
        edits = consensus_identity(testing, mp_fasta, fasta)[1]
        identity = consensus_identity(testing, mp_fasta, draft)[0]
        log("   {:.2f} s for both; per process {}".format(t_mp, json.dumps(
            [{"seconds": r["seconds"], "launches": r["launches"],
              "mode_launches": {k: v for k, v in r["mode_launches"].items()
                                if v}} for r in reports])))
        log("   merged samples against one process over the same work "
            "list: {}; FASTA {} edits from phase 5's, identity to the "
            "draft {:.6f}".format(json.dumps(stats), edits, identity))
        for r in reports:
            if min(r["launches"].values()) < 1:
                raise AssertionError("a process launched no split kernel: "
                                     "{}".format(r))
        if edits > MAX_MULTI_PROCESS_EDITS or identity < 0.99:
            raise AssertionError("the multi-process FASTA is not phase 5's")
        out["multi_process"] = {"seconds": t_mp, "processes": reports,
                                "vs_one_process": stats,
                                "fasta_edits_vs_phase5": edits}
        for name in ("gru_l1_split", "gru_l2head_split"):
            launches[name]["multi_process"] = [
                r["launches"][name] for r in reports]

    train_hdf = os.path.join(work, "train.hdf")
    with phase("(31) data-parallel training, f32: two gloo ranks on "
               "cuda:0 against one nccl rank, {} rows an epoch, 2 "
               "epochs".format(SCALE_F32_SAMPLES)):
        f32 = {}
        for label, devices in (("one", ["cuda:0"]),
                               ("two", ["cuda:0", "cuda:0"])):
            path = os.path.join(work, "ranks_f32_" + label)
            f32[label] = ranks_run(training, path, train_hdf, devices,
                                   validation=False, seed=seed,
                                   compute_dtype=None,
                                   samples_per_epoch=SCALE_F32_SAMPLES)
            f32[label + "_path"] = path
        rows_one = train_rows(f32["one"][0], None)
        loss_rel = max_relative(
            [float(r["loss"]) for r in train_rows(f32["two"][0], None)],
            [float(r["loss"]) for r in rows_one])
        last = "model-1.tar.gz"
        wa = checkpoint_arrays(os.path.join(f32["two_path"], last))
        wb = checkpoint_arrays(os.path.join(f32["one_path"], last))
        w_abs = max(float(np.abs(wa[k] - wb[k]).max()) for k in wb)
        log("   {} rows; loss max relative difference {:.3g} (bar {}); "
            "last weights max abs {:.3g} (bar {}); wall {:.1f} s (one "
            "rank) and {:.1f} s (two, spawn included); step {:.1f} ms and "
            "{:.1f} ms".format(len(rows_one), loss_rel, TOL_RANKS_F32_LOSS,
                               w_abs, TOL_RANKS_F32_WEIGHTS, f32["one"][1],
                               f32["two"][1], step_ms(f32["one"][0]),
                               step_ms(f32["two"][0])))
        if loss_rel > TOL_RANKS_F32_LOSS or w_abs > TOL_RANKS_F32_WEIGHTS:
            raise AssertionError("two ranks disagree with one in f32")
        out["ranks_f32"] = {"loss_max_rel": loss_rel, "weights_max_abs": w_abs,
                            "step_ms": [step_ms(f32["one"][0]),
                                        step_ms(f32["two"][0])]}

    with phase("(31) data-parallel training, bf16: two gloo ranks on cuda:0, "
               "batch 128 (64 a rank), 2 epochs (gru_fwd, gru_bwd)"):
        path = os.path.join(work, "ranks_bf16")
        table, t_bf16 = ranks_run(training, path, train_hdf,
                                  ["cuda:0", "cuda:0"], seed=seed,
                                  compute_dtype=torch.bfloat16)
        losses = [float(r["loss"]) for r in train_rows(table)]
        steps = len(losses)
        reports = rank_reports(path, 2)
        one = csv_table(os.path.join(work, "run", "training.csv"))
        one_losses = [float(r["loss"]) for r in train_rows(one)]
        rel = max_relative(
            [float(r["loss"]) for r in train_rows(table, None)],
            [float(r["loss"]) for r in train_rows(one, None)])
        log("   {} steps, losses {}; phase 11's one rank {} (max relative "
            "difference over every row, validation too, {:.3g}); wall "
            "{:.1f} s, spawn included; step {:.1f} ms beside phase 11's "
            "{:.1f} ms (two ranks share one card, {}: no scale-out "
            "figure); rank launches {}".format(
                steps, losses, one_losses, rel, t_bf16, step_ms(table),
                step_ms(one), card, [r["launches"] for r in reports]))
        if not all(math.isfinite(v) for v in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError("the bf16 losses are not finite and "
                                 "falling")
        for r in reports:
            if r["backend"] != "gloo" or r["launches"]["gru_fwd"] != \
                    4 * steps or r["launches"]["gru_bwd"] != 4 * steps:
                raise AssertionError("a rank did not run 4 gru_fwd and 4 "
                                     "gru_bwd a step: {}".format(r))
        out["ranks_bf16"] = {"step_ms": step_ms(table),
                             "one_rank_step_ms": step_ms(one),
                             "loss_max_rel_vs_one": rel}
        for name in ("gru_fwd", "gru_bwd"):
            launches[name] = {"ranks": [r["launches"][name]
                                        for r in reports]}

    with phase("(31) one read-level train step on two gloo ranks on cuda:0 "
               "(64 rows each, lstm_fwd, lstm_bwd, global batch norm) "
               "against one rank"):
        rl_runs = {}
        for label, devices in (("one", ["cuda:0"]),
                               ("two", ["cuda:0", "cuda:0"])):
            path = os.path.join(work, "ranks_rl_" + label)
            rl_runs[label] = ranks_run(
                training, path, rl_features, devices, validation=False,
                seed=seed, epochs=1, compute_dtype=torch.bfloat16,
                samples_per_epoch=128)
            rl_runs[label + "_path"] = path
        la = float(train_rows(rl_runs["two"][0])[0]["loss"])
        lb = float(train_rows(rl_runs["one"][0])[0]["loss"])
        wa = checkpoint_arrays(os.path.join(rl_runs["two_path"],
                                            "model-0.tar.gz"))
        wb = checkpoint_arrays(os.path.join(rl_runs["one_path"],
                                            "model-0.tar.gz"))
        stat_keys = [k for k in wb if k.endswith(("bn/mean", "bn/var"))]
        stats_rel = max(float(np.abs(wa[k] - wb[k]).max()
                              / np.abs(wb[k]).max()) for k in stat_keys)
        reports = rank_reports(rl_runs["two_path"], 2)
        log("   loss {:.6f} beside one rank's {:.6f} (relative {:.3g}, bar "
            "{}); running statistics {} relative {:.3g} (bar {}); step "
            "{:.1f} ms beside {:.1f} ms (one card shared); rank launches "
            "{}".format(la, lb, abs(la - lb) / abs(lb), TOL_RANKS_RL_LOSS,
                        stat_keys, stats_rel, TOL_RANKS_RL_STATS,
                        step_ms(rl_runs["two"][0]),
                        step_ms(rl_runs["one"][0]),
                        [r["launches"] for r in reports]))
        if abs(la - lb) > TOL_RANKS_RL_LOSS * abs(lb) or \
                stats_rel > TOL_RANKS_RL_STATS or not stat_keys:
            raise AssertionError("the read-level step on two ranks "
                                 "disagrees with one rank's")
        for r in reports:
            if r["launches"]["lstm_fwd"] != 4 or \
                    r["launches"]["lstm_bwd"] != 4:
                raise AssertionError("a rank did not run 4 lstm_fwd and 4 "
                                     "lstm_bwd: {}".format(r))
        out["ranks_read_level"] = {
            "loss": [lb, la], "stats_max_rel": stats_rel,
            "step_ms": [step_ms(rl_runs["one"][0]),
                        step_ms(rl_runs["two"][0])]}
        for name in ("lstm_fwd", "lstm_bwd"):
            launches[name] = {"ranks_read_level": [r["launches"][name]
                                                   for r in reports]}

    with phase("(31) train --model_parallel 2 on one card raises "
               "medaka_tpu's mesh error"):
        try:
            cli.main(["train", train_hdf, "--train_name",
                      os.path.join(work, "tp"), "--model_parallel", "2",
                      "--quiet"])
        except ValueError as e:
            if "mesh 128x2 != 1 devices" not in str(e):
                raise
            log("   raised: {}".format(e))
        else:
            raise AssertionError("--model_parallel 2 ran on one card")
    return launches, out


def host_option_phases(work, bam, draft, hdf, fasta, main_rate, dev,
                       modules):
    """The host pipeline options (phase 24): ``inference --output_shards
    4 --feature_processes 4`` against phase 5's one file,
    ``consensus_from_features`` on the training features, and
    ``inference --profile_dir`` in a fresh process. Returns the record
    that goes into the split kernels' rows."""
    import numpy as np
    import torch
    cli, datastore, gru_split = (modules[k] for k in (
        "cli", "datastore", "gru_split"))
    sharded = os.path.join(work, "sharded.hdf")
    sharded_fasta = os.path.join(work, "sharded.fasta")
    with phase("host options: inference --output_shards 4 "
               "--feature_processes 4, then sequence"):
        gru_split.reset_launches()
        t0 = time.perf_counter()
        if cli.main(["inference", bam, sharded, "--model", MODEL,
                     "--output_shards", "4", "--feature_processes",
                     "4"]) != 0:
            raise AssertionError("sharded inference failed")
        torch.cuda.synchronize()
        t_sharded = time.perf_counter() - t0
        launches = dict(gru_split.LAUNCHES)
        if cli.main(["sequence", sharded, draft, sharded_fasta]) != 0:
            raise AssertionError("sequence of the shards failed")
    with phase("check the sharded output against phase 5's one file"):
        files = datastore.expand_shards(sharded)
        if len(files) != 5:
            raise AssertionError("the manifest names {} files".format(
                len(files) - 1))
        one, many = datastore.DataIndex(hdf), datastore.DataIndex(sharded)
        want = {s.name: s for s in one.yield_from_feature_files()}
        got = {s.name: s for s in many.yield_from_feature_files()}
        if sorted(want) != sorted(got) or not all(
                np.array_equal(want[k].label_probs, got[k].label_probs)
                for k in want):
            raise AssertionError("the shards do not hold phase 5's samples")
        with open(fasta, "rb") as a, open(sharded_fasta, "rb") as b:
            if a.read() != b.read():
                raise AssertionError("the shards' FASTA differs from phase "
                                     "5's")
        n_columns = sum(s.size for s in got.values())
    rec = {"files": [os.path.basename(f) for f in files],
           "launches": launches, "columns_per_s": n_columns / t_sharded,
           "one_file_columns_per_s": main_rate}
    log("   {} samples over {} shards, the same bits and FASTA as phase 5; "
        "{:.0f} columns/s (phase 5, one file and 2 threads: {:.0f})".format(
            len(got), len(files) - 1, rec["columns_per_s"], main_rate))
    train_hdf = os.path.join(work, "train.hdf")
    cff = os.path.join(work, "from_features.hdf")
    with phase("consensus_from_features on the training features"):
        gru_split.reset_launches()
        t0 = time.perf_counter()
        if cli.main(["consensus_from_features", train_hdf, cff, "--model",
                     MODEL]) != 0:
            raise AssertionError("consensus_from_features failed")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        n_samples, n_columns = check_probabilities(datastore, cff)
        rec["consensus_from_features"] = {
            "launches": dict(gru_split.LAUNCHES), "samples": n_samples,
            "columns_per_s": n_columns / seconds}
    log("   consensus_from_features: {}".format(json.dumps(
        rec["consensus_from_features"])))
    if min(rec["consensus_from_features"]["launches"].values()) < 1:
        raise AssertionError("consensus_from_features never launched a "
                             "split kernel")
    prof = os.path.join(work, "profile")
    with phase("inference --profile_dir in a fresh process"):
        proc = subprocess.run(
            [sys.executable, "-m", "medaka_tpu_torch", "inference", bam,
             os.path.join(work, "profiled.hdf"), "--model", MODEL,
             "--profile_dir", prof, "--quiet"], cwd=HERE,
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError("profiled inference failed: {}".format(
                proc.stderr[-2000:]))
        with open(os.path.join(prof, "trace.json")) as fh:
            events = [e for e in json.load(fh)["traceEvents"]
                      if e.get("ph") == "X"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        names = {bare(e["name"]).replace("(anonymous namespace)::", "")
                 for e in kernels}
        missing = [k for k in SPLIT_KERNELS
                   if not any(n.startswith(k) for n in names)]
        if missing:
            raise AssertionError("the trace names no {}".format(missing))
        wall = (max(e["ts"] + e["dur"] for e in events)
                - min(e["ts"] for e in events))
        busy = sum(e["dur"] for e in kernels)
        by_kernel = {}
        for e in kernels:
            key = bare(e["name"]).replace("(anonymous namespace)::", "")
            key = key.split("(")[0][:60]
            by_kernel[key] = by_kernel.get(key, 0.0) + e["dur"] / 1e3
        rec["profile"] = {
            "wall_ms": wall / 1e3, "kernel_ms": busy / 1e3,
            "device_kernel_share": busy / wall, "events": len(events),
            "top_kernels_ms": dict(sorted(by_kernel.items(),
                                          key=lambda kv: -kv[1])[:8])}
    log("   profile of inference: {}".format(json.dumps(rec["profile"])))
    return rec


def stacked_layer(layer):
    """(w_ih, b_ih, w_hh, b_hh), each the (fwd, bwd) pair stacked."""
    import torch
    return tuple(torch.stack([layer["fwd"][k], layer["bwd"][k]])
                 for k in ("w_ih", "b_ih", "w_hh", "b_hh"))


def random_bigru_layer(rng, H, IN, dev):
    """Stacked bi-GRU weights as torch initialises them."""
    import torch
    k = 1.0 / H ** 0.5
    return tuple(torch.from_numpy(rng.uniform(-k, k, shape).astype(
        "float32")).to(dev) for shape in ((2, 3 * H, IN), (2, 3 * H),
                                          (2, 3 * H, H), (2, 3 * H)))


def fullfused_calls(gru_fullfused, mode, x, w, lengths):
    """(kernel, plain version) of one bi-GRU layer in a fullfused mode,
    or of ``bigru_pallas`` (mode "fused") over ``bigru_stack_fused``'s
    projections of x."""
    w_ih, b_ih, w_hh, b_hh = w
    if mode == "fused":
        xp_f, xp_b = (gru_fullfused.project_fused(x, w_ih[d], b_ih[d])
                      for d in (0, 1))
        return (lambda: gru_fullfused.fused_layer(xp_f, xp_b, w_hh, b_hh,
                                                  lengths),
                lambda: gru_fullfused.recurrence_plain(xp_f, xp_b, w_hh, b_hh,
                                                       lengths))
    return (lambda: gru_fullfused.fullfused_layer(x, *w, lengths, mode),
            lambda: gru_fullfused.bigru_fullfused_plain(x, *w, lengths, mode))


def bf16_step(v):
    """One bf16 step at the magnitude of v's largest element."""
    return 2.0 ** (math.floor(math.log2(v.float().abs().max().item())) - 7)


def compare_projection(gru_fullfused, x, w_ih, b_ih):
    """The tensor-core projection stage (``gru_fullfused.project``, the
    stage of the f32-gates and int8 modes) against ``project_plain``: its
    f32 sums run in the tensor cores' order, so an element may round to the
    neighbouring bf16 value. Fails past one bf16 step of the largest
    projection or where 1% of the elements or more differ. Returns
    ({"max", "bar", "share_differing"}, the kernel's projections)."""
    import torch
    got = gru_fullfused.project(x, w_ih, b_ih)
    want = gru_fullfused.project_plain(x, w_ih, b_ih)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    stats = {"max": diff.max().item(), "bar": bf16_step(want),
             "share_differing": (diff > 0).float().mean().item()}
    if stats["max"] > stats["bar"] or stats["share_differing"] >= 1e-2:
        raise AssertionError("the projection stage disagrees with "
                             "project_plain: {}".format(stats))
    return stats, got


def compare_fullfused(gru_fullfused, mode, x, w, lengths):
    """One layer through the kernel (twice) against its plain version.

    The bf16-gates mode and ``bigru_fused`` are held against their plain
    versions whole; the f32-gates and int8 modes' recurrence against
    ``recurrence_plain`` over the tensor-core stage's projections, and the
    stage against ``project_plain`` (:func:`compare_projection`). Returns
    (kernel output, {"max", "mean", "bar", "share_differing" (of the
    elements; the bf16-gates mode's f64 sums do not depend on their order,
    so about 0 there)[, "projection", "vs_whole_plain_max"]}, the whole
    plain version's ms); fails past the bar (TOL_GRU_FWD, one bf16 step of
    the largest output in mode "bf16_gates"; mean TOL_L1_MEAN) or if the
    second launch differs.
    """
    import torch
    kernel, plain = fullfused_calls(gru_fullfused, mode, x, w, lengths)
    got, again = kernel(), kernel()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    whole = plain()
    stop.record()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("{} does not repeat bit for bit".format(mode))
    want, extra = whole, {}
    if mode in ("f32_gates", "int8"):
        extra["projection"], xp = compare_projection(gru_fullfused, x, w[0],
                                                     w[1])
        want = gru_fullfused.recurrence_plain(xp[0], xp[1], w[2], w[3],
                                              lengths, mode)
        extra["vs_whole_plain_max"] = (
            got.float() - whole.float()).abs().max().item()
    diff = (got.float() - want.float()).abs()
    bar = bf16_step(want) if mode == "bf16_gates" else TOL_GRU_FWD
    stats = {"max": diff.max().item(), "mean": diff.mean().item(),
             "bar": bar, "share_differing": (diff > 0).float().mean().item(),
             **extra}
    if stats["max"] > bar or stats["mean"] > TOL_L1_MEAN:
        raise AssertionError("{} disagrees with its plain version: {}".format(
            mode, stats))
    return got, stats, start.elapsed_time(stop)


def fullfused_bound(name, B, H, IN, lengths_sum):
    """Least time (ms) of one bi-GRU layer call (or of its projection
    stage alone, ``name`` "bigru_project"), what bounds it, the bytes.

    Counted over the valid columns (``lengths_sum``), as for the other
    kernels. Bytes: the layer input (bf16 x, or both directions' bf16
    projections for ``bigru_fused``) and the bf16 outputs of both
    directions once, the f32 weights and biases as the wrapper is given
    them, and the lengths. Operations: the projection (fullfused only)
    and the recurrent product, 2 x 3H x IN and 2 x 3H x H per column and
    direction, at the bf16 peak (the recurrence of ``bigru_fullfused_int8``
    at the int8 peak), plus the gate arithmetic at the f32 peak.
    """
    G = 3 * H
    nbytes = 2 * lengths_sum * H * 2 + 2 * (G * H + 2 * G) * 4 + B * 4
    if name == "bigru_fused":
        nbytes += 2 * lengths_sum * G * 2
        proj_macs = 0
    else:
        nbytes += lengths_sum * IN * 2 + 2 * G * IN * 4
        proj_macs = 2 * lengths_sum * G * IN
    if name == "bigru_project":
        # x in, both directions' bf16 projections out, f32 W_ih and b_ih in
        nbytes = (lengths_sum * IN * 2 + 2 * lengths_sum * G * 2
                  + 2 * (G * IN + G) * 4)
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = 2 * 2 * lengths_sum * G * IN / PEAK_BF16 * 1e3
        if t_bytes >= t_ops:
            return t_bytes, "bytes", nbytes
        return t_ops, "operations", nbytes
    rec_peak = PEAK_INT8 if name == "bigru_fullfused_int8" else PEAK_BF16
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (2 * proj_macs / PEAK_BF16
             + 2 * 2 * lengths_sum * G * H / rec_peak
             + 2 * lengths_sum * H * GRU_FWD_ELEMENTWISE_OPS / PEAK_F32) * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes
    return t_ops, "operations", nbytes


def fullfused_agreement(gru_fullfused, rng, dev):
    """Each fullfused mode and ``bigru_fused`` against its plain version:
    H=256, B=16, T=2000 for layer 1 (IN=10) and layer 2 (IN=512), and a
    3-layer H=96 stack at B=31, T=500, each layer on the kernel's output
    of the layer below; ragged lengths with a padded row (length 0).
    Returns {shape: {mode: stats}}."""
    import torch
    out = {}

    def inputs(B, T, IN):
        lengths = torch.from_numpy(rng.integers(1, T + 1, B).astype("int32"))
        lengths[0], lengths[1] = T, 0
        x = torch.from_numpy(rng.uniform(-1, 1, (T, B, IN)).astype(
            "float32")).to(dev, torch.bfloat16)
        return x, lengths.to(dev)

    H, B, T = 256, SMALL_BATCH, 2000
    for IN in (10, 2 * H):
        x, lengths = inputs(B, T, IN)
        w = random_bigru_layer(rng, H, IN, dev)
        key = "H{}_B{}_T{}_IN{}".format(H, B, T, IN)
        out[key] = {mode: compare_fullfused(gru_fullfused, mode, x, w,
                                            lengths)[1]
                    for mode in FULLFUSED_MODES.values()}
        log("   {}: {}".format(key, json.dumps(out[key])))
    H, B, T = 96, 31, 500
    x0, lengths = inputs(B, T, 10)
    weights = [random_bigru_layer(rng, H, 10 if k == 0 else 2 * H, dev)
               for k in range(3)]
    key = "H{}_B{}_T{}_3layers".format(H, B, T)
    out[key] = {}
    for mode in FULLFUSED_MODES.values():
        x, worst = x0, {"max": 0.0, "mean": 0.0}
        for w in weights:
            x, stats, _ = compare_fullfused(gru_fullfused, mode, x, w,
                                            lengths)
            worst = {k: max(worst[k], stats[k]) for k in ("max", "mean")}
        out[key][mode] = worst
    log("   {}: {}".format(key, json.dumps(out[key])))
    return out


def small_width_timings(gru_fullfused, gru_train, rng, dev):
    """``gru_fwd`` (one direction) and ``bigru_fused`` (both) at a small
    width, H=96, B=31, T=500 (the 3-layer stack's shape, where all of
    W_hh, 55,296 B, would fit one block's shared memory): ms a launch, us
    a step and the launch geometry, each held against its plain
    version."""
    import torch
    H, B, T = 96, 31, 500
    xp, w_hh, b_hh, lengths, _ = random_direction(rng, H, B, T, dev)
    w2, b2 = torch.stack([w_hh, w_hh.flip(0)]), torch.stack([b_hh] * 2)
    xp_b = xp.flip(-1).contiguous()
    calls = {
        "gru_fwd": (lambda: gru_train.gru_fwd(xp, w_hh, b_hh, lengths),
                    lambda: gru_train.gru_fwd_plain(xp, w_hh, b_hh, lengths),
                    lambda: gru_train.fwd_geometry(H, B, dev)),
        "bigru_fused": (
            lambda: gru_fullfused.fused_layer(xp, xp_b, w2, b2, lengths),
            lambda: gru_fullfused.recurrence_plain(xp, xp_b, w2, b2,
                                                   lengths),
            lambda: gru_fullfused.cluster_geometry(H, B, dev,
                                                   "bigru_fused"))}
    out = {}
    for name, (kernel, plain, geometry) in calls.items():
        err = (kernel().float() - plain().float()).abs().max().item()
        if err > TOL_GRU_FWD:
            raise AssertionError("{} at H={} B={} disagrees with its plain "
                                 "version: {}".format(name, H, B, err))
        ms = cuda_ms(kernel)
        out[name] = {"H": H, "B": B, "T": T, "ms": ms,
                     "step_us": ms / T * 1e3, "max_abs_err": err,
                     "geometry": dict(zip(("cluster", "columns", "smem_bytes",
                                           "resident_clusters"),
                                          geometry()))}
        log("   {}: {}".format(name, json.dumps(out[name])))
    return out


def small_batch_phases(work, bam, draft, main_fasta, dev, agreement,
                       modules):
    """Counts inference off the split path at batch 16, the direct route,
    and the fullfused kernels' timings (phases 8-11); returns the
    ``kernels`` rows of bigru_fullfused (both gate modes),
    bigru_fullfused_int8 and bigru_fused."""
    import numpy as np
    import torch
    cli, datastore, features, gru_fullfused, gru_split, models, \
        prediction = (modules[k] for k in (
            "cli", "datastore", "features", "gru_fullfused", "gru_split",
            "models", "prediction"))
    from medaka_tpu_torch import testing
    B = SMALL_BATCH
    hdf = os.path.join(work, "probs16.hdf")
    fastq = os.path.join(work, "consensus16.fastq")
    with phase("small-batch path: inference --batch_size 16 + sequence "
               "--qualities"):
        gru_fullfused.reset_launches()
        gru_split.reset_launches()
        t0 = time.perf_counter()
        if cli.main(["inference", bam, hdf, "--model", MODEL,
                     "--batch_size", str(B)]) != 0:
            raise AssertionError("inference --batch_size 16 failed")
        torch.cuda.synchronize()
        t_inference = time.perf_counter() - t0
        mode_launches = dict(gru_fullfused.MODE_LAUNCHES)
        project_launches = gru_fullfused.LAUNCHES["bigru_project"]
        split_launches = dict(gru_split.LAUNCHES)
        if cli.main(["sequence", hdf, draft, fastq, "--qualities"]) != 0:
            raise AssertionError("sequence --qualities failed")
    with phase("check the small-batch output"):
        n_samples, n_columns = check_probabilities(datastore, hdf)
        n_batches = math.ceil(n_samples / B)
        log("   launches: {}; split kernels {}".format(mode_launches,
                                                       split_launches))
        expected = {k: 0 for k in mode_launches}
        expected["bigru_fullfused/f32_gates"] = 2 * n_batches
        if mode_launches != expected or sum(split_launches.values()) != 0 \
                or project_launches != 2 * n_batches:
            raise AssertionError(
                "expected {} launches of the f32-gates fullfused kernel (2 "
                "layers x {} batches), each with its projection stage ({}), "
                "and no other".format(2 * n_batches, n_batches,
                                      project_launches))
        identity, edits, cons_len = consensus_identity(testing, fastq, draft)
        log("   {} samples, {} columns in {:.2f} s of inference: {:.0f} "
            "columns/s; consensus {} bp, identity to the draft {:.6f} ({} "
            "edits by greedy walk)".format(
                n_samples, n_columns, t_inference, n_columns / t_inference,
                cons_len, identity, edits))
        if identity < 0.99:
            raise AssertionError("small-batch consensus identity {} < "
                                 "0.99".format(identity))

    bundle = models.load_model(MODEL)
    model = bundle.model.to(dev)
    region = prediction.plan_work(None, bam)[0]
    samples = features.SampleGenerator(
        bam, region, bundle.feature_encoder, chunk_len=10000,
        chunk_overlap=1000).samples[:B]
    small = prediction.Batch.collate(samples, B, 10000)
    x = torch.from_numpy(small.features).to(dev)
    lens = torch.from_numpy(small.lengths).to(dev)
    T = x.shape[1]
    layers = [stacked_layer(layer) for layer in model.layer_params()]
    with phase("one batch of 16: the model through the kernels vs through "
               "their plain versions; the other modes' entry points"):
        with torch.inference_mode():
            got = model(x, lengths=lens, compute_dtype=torch.bfloat16)
            h = x.transpose(0, 1).to(torch.bfloat16).contiguous()
            for w in layers:
                h = gru_fullfused.bigru_fullfused_plain(h, *w, lens)
            want = torch.softmax(
                h.transpose(0, 1).float() @ model.linear.weight.float().t()
                + model.linear.bias.float(), -1)
            valid = (torch.arange(T, device=dev)[None, :]
                     < lens[:, None].long())
            diff = (got - want).abs()[valid]
            batch_stats = {
                "max": diff.max().item(), "mean": diff.mean().item(),
                "argmax_agreement": (got.argmax(-1) == want.argmax(-1))[
                    valid].float().mean().item()}
            log("   B={} T={}: probs max {:.3g} mean {:.3g}, argmax "
                "agreement {:.6f}".format(B, T, batch_stats["max"],
                                          batch_stats["mean"],
                                          batch_stats["argmax_agreement"]))
            if batch_stats["max"] > TOL_FULLFUSED_PROB_MAX or \
                    batch_stats["mean"] > TOL_SCAN_PROB_MEAN or \
                    batch_stats["argmax_agreement"] < MIN_ARGMAX_AGREEMENT:
                raise AssertionError("the fullfused route disagrees with "
                                     "its plain version: {}".format(
                                         batch_stats))
            # the int8 route (the int8 cluster recurrence after the
            # tensor-core projection) against its plain version, as above
            got8 = model(x, lengths=lens, compute_dtype=torch.bfloat16,
                         recurrent_quant="int8")
            h = x.transpose(0, 1).to(torch.bfloat16).contiguous()
            for w in layers:
                h = gru_fullfused.bigru_fullfused_plain(h, *w, lens, "int8")
            want8 = torch.softmax(
                h.transpose(0, 1).float() @ model.linear.weight.float().t()
                + model.linear.bias.float(), -1)
            diff8 = (got8 - want8).abs()[valid]
            int8_stats = {
                "max": diff8.max().item(), "mean": diff8.mean().item(),
                "argmax_agreement": (got8.argmax(-1) == want8.argmax(-1))[
                    valid].float().mean().item()}
            log("   int8 route, B={} T={}: probs max {:.3g} mean {:.3g}, "
                "argmax agreement {:.6f}".format(
                    B, T, int8_stats["max"], int8_stats["mean"],
                    int8_stats["argmax_agreement"]))
            if int8_stats["max"] > TOL_FULLFUSED_PROB_MAX or \
                    int8_stats["mean"] > TOL_SCAN_PROB_MEAN or \
                    int8_stats["argmax_agreement"] < MIN_ARGMAX_AGREEMENT:
                raise AssertionError("the int8 fullfused route disagrees "
                                     "with its plain version: {}".format(
                                         int8_stats))
            del got8, want8, h
            # the bf16-gates route (the bf16-gates cluster recurrence after
            # the CUDA cores' projection) through GRUModel.forward against
            # its plain version under the same bars, and bit for bit on a
            # second call, over the batch's first BF16_ROUTE_T columns (its
            # plain versions' step-by-step loops, cut for the time limit)
            xc = x[:, :BF16_ROUTE_T].contiguous()
            lc = torch.clamp(lens, max=BF16_ROUTE_T)
            gotb = model(xc, lengths=lc, compute_dtype=torch.bfloat16,
                         recurrent_quant="bf16_gates")
            againb = model(xc, lengths=lc, compute_dtype=torch.bfloat16,
                           recurrent_quant="bf16_gates")
            h = xc.transpose(0, 1).to(torch.bfloat16).contiguous()
            for w in layers:
                h = gru_fullfused.bigru_fullfused_plain(h, *w, lc,
                                                        "bf16_gates")
            wantb = torch.softmax(
                h.transpose(0, 1).float() @ model.linear.weight.float().t()
                + model.linear.bias.float(), -1)
            valid_b = (torch.arange(xc.shape[1], device=dev)[None, :]
                       < lc[:, None].long())
            diffb = (gotb - wantb).abs()[valid_b]
            bf16_stats = {
                "T": xc.shape[1], "max": diffb.max().item(),
                "mean": diffb.mean().item(),
                "share_differing": (diffb > 0).float().mean().item(),
                "argmax_agreement": (gotb.argmax(-1) == wantb.argmax(-1))[
                    valid_b].float().mean().item(),
                "repeats_bit_for_bit": bool(torch.equal(gotb, againb))}
            log("   bf16-gates route, B={} T={}: {}".format(
                B, xc.shape[1], json.dumps(bf16_stats)))
            if bf16_stats["max"] > TOL_FULLFUSED_PROB_MAX or \
                    bf16_stats["mean"] > TOL_SCAN_PROB_MEAN or \
                    bf16_stats["argmax_agreement"] < MIN_ARGMAX_AGREEMENT \
                    or not bf16_stats["repeats_bit_for_bit"]:
                raise AssertionError("the bf16-gates fullfused route "
                                     "disagrees with its plain version: "
                                     "{}".format(bf16_stats))
            del gotb, againb, wantb, h, xc
            # the entry points of the other modes over the same batch:
            # GRUModel.forward(recurrent_quant=...) and bigru_stack_fused
            entry_launches = {}
            for name, run in (
                    ("bigru_fullfused/bf16_gates", lambda: model(
                        x, lengths=lens, compute_dtype=torch.bfloat16,
                        recurrent_quant="bf16_gates")),
                    ("bigru_fullfused_int8", lambda: model(
                        x, lengths=lens, compute_dtype=torch.bfloat16,
                        recurrent_quant="int8")),
                    ("bigru_fused", lambda: gru_fullfused.bigru_stack_fused(
                        model.layer_params(), x, lengths=lens, device=dev))):
                gru_fullfused.reset_launches()
                probs = run()
                torch.cuda.synchronize()
                entry_launches[name] = dict(gru_fullfused.MODE_LAUNCHES)
                if not bool(torch.isfinite(probs.float()).all()):
                    raise AssertionError(name + " gave non-finite values")
        log("   launches of the other entry points: {}".format(
            json.dumps(entry_launches)))

    direct16 = os.path.join(work, "direct16.fastq")
    with phase("direct route: predict_direct at batch 16"):
        gru_fullfused.reset_launches()
        gru_split.reset_launches()
        t0 = time.perf_counter()
        _, direct_columns = prediction.predict_direct(
            bam, direct16, draft, model_path=MODEL, batch_size=B,
            qualities=True)
        t_direct = time.perf_counter() - t0
        direct_launches = dict(gru_fullfused.MODE_LAUNCHES)
        if direct_launches != expected or \
                sum(gru_split.LAUNCHES.values()) != 0:
            raise AssertionError("the direct route launched {}".format(
                direct_launches))
        log("   {} columns in {:.2f} s: {:.0f} columns/s".format(
            direct_columns, t_direct, direct_columns / t_direct))
    direct_auto = os.path.join(work, "direct.fasta")
    with phase("direct route: predict_direct at the automatic batch"):
        gru_fullfused.reset_launches()
        gru_split.reset_launches()
        t0 = time.perf_counter()
        _, auto_columns = prediction.predict_direct(bam, direct_auto, draft,
                                                    model_path=MODEL)
        t_auto = time.perf_counter() - t0
        if min(gru_split.LAUNCHES.values()) < 1 or \
                sum(gru_fullfused.LAUNCHES.values()) != 0:
            raise AssertionError("the direct route at the automatic batch "
                                 "must run the split kernels")
        log("   {} columns in {:.2f} s: {:.0f} columns/s; launches {}".format(
            auto_columns, t_auto, auto_columns / t_auto,
            dict(gru_split.LAUNCHES)))
    bed = ".gaps_in_draft_coords.bed"
    for got_path, want_path in ((direct16, fastq), (direct_auto, main_fasta)):
        for suffix in ("", bed):
            with open(got_path + suffix, "rb") as a, \
                    open(want_path + suffix, "rb") as b:
                if a.read() != b.read():
                    raise AssertionError("{} differs from {}".format(
                        os.path.basename(got_path + suffix),
                        os.path.basename(want_path + suffix)))
    log("   the direct FASTQ (batch 16) and FASTA (automatic batch) and "
        "their gaps beds equal the HDF5 route's byte for byte")

    with phase("fullfused kernels at B=16 T=10000 H=256, layer 2: "
               "timings"):
        H = model.gru_size
        lengths_sum = int(small.lengths.sum())
        with torch.inference_mode():
            h1 = gru_fullfused.fullfused_layer(
                x.transpose(0, 1).to(torch.bfloat16).contiguous(),
                *layers[0], lens)
            IN = h1.shape[-1]
            one = (h1[:, :1].contiguous(), lens[:1])
            timed, main_stats, cluster_rows = {}, {}, {}
            for name, mode in FULLFUSED_MODES.items():
                _, main_stats[name], plain_ms = compare_fullfused(
                    gru_fullfused, mode, h1, layers[1], lens)
                kernel, _ = fullfused_calls(gru_fullfused, mode, h1,
                                            layers[1], lens)
                floor, _ = fullfused_calls(gru_fullfused, mode, one[0],
                                           layers[1], one[1])
                timed[name] = (cuda_ms(kernel), plain_ms, cuda_ms(floor))
                # the launch geometry (cluster recurrence), the profiler's
                # split of a launch into the projection stage and the
                # recurrence, at the main shape and over one column; each
                # profile must show the mode's kernels and no other
                # design's (PROFILE_KERNELS)
                kernel_name = name.split("/")[0]
                prefixes = PROFILE_KERNELS[name][0]
                row = {"kernels": list(prefixes)}
                row["geometry"] = {
                    key: dict(zip(("cluster", "columns", "smem_bytes",
                                   "resident_clusters"),
                                  gru_fullfused.cluster_geometry(
                                      H, cols, dev, kernel_name,
                                      None if mode == "fused" else mode)))
                    for key, cols in (("main", B), ("one_column", 1))}
                for key, fn, cols in (("main", kernel, B),
                                      ("one_column", floor, 1)):
                    def child(cols=cols):
                        return child_profile(mode, T, cols, IN, H)
                    row[key + "_ms"] = cluster_launch_ms(
                        name, fn, prefixes, PROFILE_KERNELS[name], child)
                rec_kernel = [p for p in prefixes if "proj" not in p][0]
                rec = row["main_ms"][rec_kernel]
                rec1 = row["one_column_ms"][rec_kernel]
                row.update(
                    step_us=timed[name][0] / T * 1e3,
                    serial_floor_step_us=timed[name][2] / T * 1e3,
                    recurrence_step_us=rec / T * 1e3,
                    recurrence_floor_step_us=rec1 / T * 1e3)
                cluster_rows[name] = row
                log("   {}: {}".format(name, json.dumps(row)))
            # the tensor-core projection stage alone (the f32-gates and
            # int8 modes' first kernel) on layer 2's input: against
            # project_plain, its time, and the one PyTorch call that
            # computes it as its yardstick (the port never calls it):
            # torch.addmm of the bf16 operands with f32 output where this
            # PyTorch has it, then bf16
            w_ih2, b_ih2 = layers[1][0], layers[1][1]
            proj_stats, _ = compare_projection(gru_fullfused, h1, w_ih2,
                                               b_ih2)
            xf = h1.reshape(-1, IN)
            wt = [w_ih2[d].to(torch.bfloat16).t() for d in (0, 1)]
            try:
                torch.addmm(b_ih2[0], xf[:8], wt[0], out_dtype=torch.float32)

                def addmm():
                    return [torch.addmm(b_ih2[d], xf, wt[d],
                                        out_dtype=torch.float32).to(
                                            torch.bfloat16) for d in (0, 1)]
                proj_library = ("torch.addmm(b_ih f32, x bf16, W_ih^T bf16, "
                                "out_dtype=f32).to(bf16), both directions")
            except (TypeError, RuntimeError):
                def addmm():
                    return [torch.addmm(b_ih2[d].to(torch.bfloat16), xf,
                                        wt[d]) for d in (0, 1)]
                proj_library = ("torch.addmm(b_ih bf16, x bf16, W_ih^T "
                                "bf16), both directions (this PyTorch has no "
                                "out_dtype)")
            projection = {
                "ms": cuda_ms(lambda: gru_fullfused.project(h1, w_ih2,
                                                            b_ih2)),
                "plain_ms": cuda_ms(lambda: gru_fullfused.project_plain(
                    h1, w_ih2, b_ih2), reps=1, warmup=0),
                "library_ms": cuda_ms(addmm), "library": proj_library,
                "agreement": proj_stats}
            log("   projection stage alone: {}".format(json.dumps(
                projection)))
            # yardstick (the port never calls it): cuDNN's bf16 bi-GRU
            # over the same rows, its input projection included
            gru = torch.nn.GRU(IN, H, 1, bidirectional=True).to(
                dev, torch.bfloat16)
            gru.flatten_parameters()
            lib_ms = cuda_ms(lambda: gru(h1))
            del gru
        library = ("torch.nn.GRU({}, {}, 1, bidirectional=True) bf16 (cuDNN) "
                   "over the same {} rows, its input projection included: "
                   "{:.2f} ms".format(IN, H, B, lib_ms))
        log("   " + library)

    path = {"bigru_fullfused/f32_gates": "inference --batch_size 16",
            "bigru_fullfused/bf16_gates":
                "GRUModel.forward(recurrent_quant='bf16_gates') on one "
                "batch of 16",
            "bigru_fullfused_int8":
                "GRUModel.forward(recurrent_quant='int8') on one batch of "
                "16",
            "bigru_fused": "bigru_stack_fused on one batch of 16"}
    rows = []
    for name, mode in FULLFUSED_MODES.items():
        ms, plain_ms, floor_ms = timed[name]
        bound_ms, bound_by, nbytes = fullfused_bound(name, B, H, IN,
                                                     lengths_sum)
        key = name.split("/")[0] + "/" + (
            "f32_gates" if mode == "fused" else mode)
        launches = (mode_launches[key] if name == "bigru_fullfused/f32_gates"
                    else entry_launches[name][key])
        err = max([agreement[s][mode]["max"] for s in agreement]
                  + [main_stats[name]["max"]])
        rows.append({
            "name": name, "route": "cuda", "source": FULLFUSED_SOURCE,
            "replaces": REPLACES[name], "launches": launches,
            "launches_on": path[name], "max_abs_err": err,
            "err_measure": "max abs difference of bf16 outputs",
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_bytes": nbytes, "library_ms": lib_ms,
            "library": library, "serial_floor_ms": floor_ms,
            "shape": {"B": B, "T": T, "H": H, "IN": IN,
                      "valid_columns": lengths_sum, "layer": 2},
            "agreement": {"random_weights": {
                s: agreement[s][mode] for s in agreement},
                "main_shape": main_stats[name]},
        })
        if name in cluster_rows:
            rows[-1]["cluster_recurrence"] = cluster_rows[name]
        if mode == "bf16_gates":
            # the CUDA cores' projection stage in order, bit for bit:
            # 2 x 3H x IN fmaf a valid column at their f32 rate
            rows[-1]["projection_cuda_core_bound_ms"] = (
                2 * 2 * lengths_sum * 3 * H * IN / PEAK_F32 * 1e3)
            rows[-1]["model_route_vs_plain"] = bf16_stats
        log("   {}: {:.3f} ms (plain {:.1f} ms, bound {:.4f} ms by {}, one "
            "column {:.3f} ms; {} launches on {})".format(
                name, ms, plain_ms, bound_ms, bound_by, floor_ms, launches,
                path[name]))
    bound_ms, bound_by, nbytes = fullfused_bound("bigru_project", B, H, IN,
                                                 lengths_sum)
    rows.append({
        "name": "bigru_project", "route": "cuda", "source": FULLFUSED_SOURCE,
        "replaces": REPLACES["bigru_project"], "launches": project_launches,
        "launches_on": "inference --batch_size 16 (the projection stage of "
                       "every bigru_fullfused and bigru_fullfused_int8 "
                       "launch)",
        "max_abs_err": projection["agreement"]["max"],
        "err_measure": "max abs difference of the bf16 projections from "
                       "project_plain; bar one bf16 step of the largest",
        "ms": projection["ms"], "kernel_ms": projection["ms"],
        "plain_ms": projection["plain_ms"], "bound_ms": bound_ms,
        "bound_by": bound_by, "bound_bytes": nbytes,
        "library_ms": projection["library_ms"],
        "library": projection["library"],
        "shape": {"B": B, "T": T, "H": H, "IN": IN,
                  "valid_columns": lengths_sum, "layer": 2},
        "agreement": projection["agreement"],
        "kernel": "bigru_proj_mma_kernel"})
    log("   bigru_project: {:.3f} ms (plain {:.1f} ms, bound {:.4f} ms by "
        "{}, {} {:.3f} ms; {} launches)".format(
            projection["ms"], projection["plain_ms"], bound_ms, bound_by,
            projection["library"], projection["library_ms"],
            project_launches))
    rows[0]["small_batch"] = {
        "inference_columns_per_s": n_columns / t_inference,
        "identity": identity, "batches": n_batches,
        "model_vs_plain": batch_stats, "int8_model_vs_plain": int8_stats,
        "direct_columns_per_s": direct_columns / t_direct,
        "direct_auto_columns_per_s": auto_columns / t_auto}
    del model, x, h1
    torch.cuda.empty_cache()
    return rows


#: the reference GRUModel's width (medaka's GRUModel default: 2x128)
REF_HIDDEN = 128
#: phase 26's split-kernel comparisons besides the main shape (int8, mode
#: "t", the automatic batch, T=10000): bf16 and mode "rows" over this many
#: steps (the plain versions step once a column a launch)
REF_CHECK_T = 2000
#: phase 27: phase 14's BAM cut to its first REF_RL_REGION_KB kb
REF_RL_REGION_KB = 100
#: phase 28: the fast5 tables of the reads over the first FAST5_REGION_KB
#: kb of phase 4's genome (phase 23's region, cut)
FAST5_REGION_KB = 20
#: phase 25: validate_only against the last validation row, at most
TOL_VALIDATION = 1e-6


def read_validation(cli, argv):
    """(loss, accuracy) that ``train --validate_only`` prints."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if cli.main(argv) != 0:
            raise AssertionError("train --validate_only failed")
    m = re.search(r"validation loss (\S+) accuracy (\S+)", buf.getvalue())
    if m is None:
        raise AssertionError("train --validate_only printed no result")
    return float(m.group(1)), float(m.group(2))


def same_probabilities(datastore, a, b):
    """Whether two probability files hold the same samples with the same
    label_probs bits."""
    with datastore.DataStore(a) as x, datastore.DataStore(b) as y:
        names = x.sample_registry
        return names == y.sample_registry and len(names) > 0 and all(
            x.load_sample(n).label_probs.tobytes()
            == y.load_sample(n).label_probs.tobytes() for n in names)


def extract_member(tar_path, member, dst_dir):
    """Extract one member of a tar archive under ``dst_dir``; its path."""
    import tarfile
    with tarfile.open(tar_path) as tar:
        tar.extract(member, dst_dir, filter="data")
    return os.path.join(dst_dir, member)


def validate_only_phase(seed, work, rl_paths, modules):
    """Phase 25: ``train --validate_only`` of phases 11's and 14's last
    checkpoints against the last validation rows of their training.csv."""
    bilstm, cli, gru_fullfused, gru_split = (modules[k] for k in (
        "bilstm", "cli", "gru_fullfused", "gru_split"))
    out = {}
    for label, feats, ckpt in (
            ("counts", os.path.join(work, "train.hdf"),
             os.path.join(work, "run", "model-1.tar.gz")),
            ("read-level", rl_paths["features"], rl_paths["checkpoint"])):
        with phase("(25) train --validate_only of the {} path's last "
                   "checkpoint".format(label)):
            gru_split.reset_launches()
            bilstm.reset_launches()
            t0 = time.perf_counter()
            loss, acc = read_validation(cli, [
                "train", feats, "--validate_only", "--model", ckpt,
                "--seed", str(seed), "--batch_size", "128", "--quiet"])
            seconds = time.perf_counter() - t0
            header, rows = csv_table(os.path.join(os.path.dirname(ckpt),
                                                  "training.csv"))
            col = {name: i for i, name in enumerate(header)}
            last = [r for r in rows if r[col["split"]] == "validation"
                    and r[col["epoch"]] == "1"]
            if len(last) != 1:
                raise AssertionError("{}: {} validation batches; the check "
                                     "needs one".format(label, len(last)))
            want_loss, want_acc = (float(last[0][col["loss"]]),
                                   float(last[0][col["acc"]]))
            if label == "counts":
                route = {k: v for k, v in gru_split.MODE_LAUNCHES.items()
                         if v}
                name = "split" if route else "fullfused"
            else:
                route = dict(bilstm.LAUNCHES)
                name = "bilstm_fused"
            out[label] = {"loss": loss, "accuracy": acc,
                          "csv_loss": want_loss, "csv_accuracy": want_acc,
                          "route": name, "launches": route,
                          "seconds": seconds}
            log("   loss {!r} accuracy {!r}; training.csv's last validation "
                "row {!r} {!r}; route {} {}; {:.1f} s".format(
                    loss, acc, want_loss, want_acc, name, route, seconds))
            if abs(loss - want_loss) > TOL_VALIDATION or \
                    abs(acc - want_acc) > TOL_VALIDATION:
                raise AssertionError("{}: --validate_only differs from the "
                                     "last validation row".format(label))
            if not route or min(route.values()) < 1:
                raise AssertionError("{}: no kernel launched".format(label))
    with phase("(25) train --validate_only --batch_size 16 of the counts "
               "checkpoint: below 32 rows, the fullfused route"):
        gru_fullfused.reset_launches()
        gru_split.reset_launches()
        loss, acc = read_validation(cli, [
            "train", os.path.join(work, "train.hdf"), "--validate_only",
            "--model", os.path.join(work, "run", "model-1.tar.gz"),
            "--seed", str(seed), "--batch_size", "16", "--quiet"])
        launches = {k: v for k, v in gru_fullfused.LAUNCHES.items() if v}
        out["counts_batch16"] = {"loss": loss, "accuracy": acc,
                                 "route": "fullfused", "launches": launches}
        log("   loss {!r} accuracy {!r} over batches of 16; launches {}; "
            "split kernels {}".format(loss, acc, launches,
                                      sum(gru_split.LAUNCHES.values())))
        if not (math.isfinite(loss) and 0 <= acc <= 1) or not launches \
                or sum(gru_split.LAUNCHES.values()):
            raise AssertionError("--validate_only below 32 rows did not run "
                                 "the fullfused kernels alone")
    return out


def reference_width_training(seed, work, dev, rng, ptxas, modules):
    """Phase 26 (1): the reference's 2x128 GRUModel from an exported
    architecture TOML through ``train``, and gru_fwd and gru_bwd at H=128
    against their plain versions and timed. Returns (checkpoint path,
    kernels rows)."""
    import torch
    cli, features, gru_train, models, training = (modules[k] for k in (
        "cli", "features", "gru_train", "models", "training"))
    from medaka_tpu_torch import labels
    from medaka_tpu_torch.models.gru import GRUModel
    H = REF_HIDDEN
    train_hdf = os.path.join(work, "train.hdf")
    run = os.path.join(work, "run128")
    with phase("(26) tools export of a random 2x{} GRUModel, then train "
               "--model config.toml (batch 128, 2 epochs, bf16)".format(H)):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = GRUModel(num_features=10, num_classes=5, gru_size=H)
        src = models.save_model(os.path.join(work, "random128.tar.gz"),
                                model, features.CountsFeatureEncoder(),
                                labels.HaploidLabelScheme())
        if cli.main(["tools", "export", src, "--output",
                     os.path.join(work, "random128_export")]) != 0:
            raise AssertionError("tools export failed")
        toml = extract_member(os.path.join(work, "random128_export.tar.gz"),
                              "model/config.toml",
                              os.path.join(work, "arch128"))
        gru_train.reset_launches()
        t0 = time.perf_counter()
        if cli.main(["train", train_hdf, "--model", toml, "--batch_size",
                     "128", "--epochs", "2", "--optimizer", "adam",
                     "--optim_args", "learning_rate=1e-3", "--seed",
                     str(seed), "--train_name", run, "--quiet"]) != 0:
            raise AssertionError("train --model config.toml failed")
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        launches = dict(gru_train.LAUNCHES)
    header, rows = csv_table(os.path.join(run, "training.csv"))
    col = {name: i for i, name in enumerate(header)}
    losses = [float(r[col["loss"]]) for r in rows]
    train_losses = [float(r[col["loss"]]) for r in rows
                    if r[col["split"]] == "train"]
    steps = len(train_losses)
    ckpt = os.path.join(run, "model-1.tar.gz")
    trained = models.load_model(ckpt).model
    log("   {} train steps in {:.1f} s; launches {}; train losses {}; "
        "model {}".format(steps, t_train, launches, train_losses,
                          json.dumps(trained.to_dict())))
    if trained.to_dict() != model.to_dict():
        raise AssertionError("train built another architecture")
    if not all(math.isfinite(v) for v in losses) or \
            not train_losses[-1] < train_losses[0]:
        raise AssertionError("the 2x128 losses are not finite and falling")
    if launches != {"gru_fwd": 4 * steps, "gru_bwd": 4 * steps}:
        raise AssertionError("expected 4 launches of each training kernel "
                             "a step, got {}".format(launches))

    agreement = {}
    with phase("(26) gru_fwd and gru_bwd at H={} B=128 T=1000 against their "
               "plain versions, both directions".format(H)):
        for reverse in (False, True):
            stats = compare_gru_train(
                gru_train, *random_direction(rng, H, 128, 1000, dev),
                reverse)
            agreement["reverse" if reverse else "forward"] = stats
            log("   reverse={}: {}".format(reverse, json.dumps(stats)))

    with phase("(26) gru_fwd and gru_bwd at H={}: timings on the training "
               "batch".format(H)):
        batcher = training.TrainBatcher([train_hdf], batch_size=128,
                                        seed=seed)
        host = next(batcher.batches("train", seed=0))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        B, T = batch["features"].shape[:2]
        lengths_sum = int(batch["lengths"].sum())
        timed, geometry, main_stats, lib = gru_train_timings(
            gru_train, trained.to(dev), batch, rng, dev)
        lib_fwd, lib_bwd = lib["fwd"], lib["bwd"]
        trained.to("cpu")
        del batch
        torch.cuda.empty_cache()
    kernel_rows = []
    for name in ("gru_fwd", "gru_bwd"):
        ms, plain_ms, floor_ms = timed[name]
        bound_ms, bound_by, nbytes = train_bound(name, B, H, lengths_sum)
        if name == "gru_fwd":
            err = max([a["fwd_max"] for a in agreement.values()]
                      + [main_stats["fwd_max"]])
        else:
            err = max(a[k] for a in list(agreement.values()) + [main_stats]
                      for k in ("dxp", "dW_hh", "db_hh"))
        src_name = "gru_cluster_fwd_kernel" if name == "gru_fwd" else \
            "gru_cluster_bwd_kernel"
        kernel_rows.append({
            "name": name + "/h128", "route": "cuda", "source": TRAIN_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "launches_per_step": launches[name] // steps,
            "max_abs_err": err,
            "err_measure": ("max abs difference of bf16 outputs"
                            if name == "gru_fwd" else
                            "max abs difference over the tensor's max "
                            "magnitude, worst of dxp, dW_hh, db_hh"),
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_bytes": nbytes,
            "library_ms": lib_fwd if name == "gru_fwd" else lib_bwd,
            "library": "torch.nn.GRU({}, {}, 1) bf16 (cuDNN) {} over the "
                       "same {} rows".format(
                           2 * H, H, "forward, its input projection "
                           "included," if name == "gru_fwd" else
                           "backward alone", B),
            "serial_floor_ms": floor_ms, "step_us": ms / T * 1e3,
            "serial_floor_step_us": floor_ms / T * 1e3,
            "geometry": geometry[name],
            "shape": {"B": B, "T": T, "H": H, "valid_columns": lengths_sum,
                      "layer": 2, "direction": "forward"},
            "agreement": {"random_weights": agreement,
                          "main_shape": main_stats},
            "path": "train --model config.toml (2x128), {} steps in {:.1f} "
                    "s".format(steps, t_train),
            "ptxas": {k: ptxas["gru_train.cu"][k]
                      for k in (src_name,) + (("rnn_dw_kernel",)
                                              if name == "gru_bwd" else ())}})
        log("   {}/h128: {:.3f} ms (plain {:.1f} ms, bound {:.4f} ms by {}, "
            "one column {:.3f} ms; cuDNN {:.3f} ms); geometry {}".format(
                name, ms, plain_ms, bound_ms, bound_by, floor_ms,
                kernel_rows[-1]["library_ms"], json.dumps(geometry[name])))
    return ckpt, kernel_rows


def reference_width_inference(work, bam, draft, ckpt, dev, ptxas, modules):
    """Phase 26 (2-4): phase 26's checkpoint written as a legacy reference
    checkpoint (the ``build_model_torch`` partial) serves ``inference`` +
    ``sequence`` with the probabilities of the native checkpoint, bit for
    bit; the split kernels at H=128 against their plain versions and
    timed. Returns the kernels rows."""
    import torch
    cli, datastore, features, gru_split, models, prediction, testing = (
        modules[k] for k in ("cli", "datastore", "features", "gru_split",
                             "models", "prediction", "testing"))
    H, IN, C = REF_HIDDEN, 10, 5
    ref = os.path.join(work, "reference128.tar.gz")
    native_hdf = os.path.join(work, "native128.hdf")
    ref_hdf = os.path.join(work, "reference128.hdf")
    native_fasta = os.path.join(work, "native128.fasta")
    ref_fasta = os.path.join(work, "reference128.fasta")
    with phase("(26) the 2x128 checkpoint as a legacy reference checkpoint: "
               "inference + sequence, against the native checkpoint"):
        testing.write_reference_checkpoint(models.load_model(ckpt), ref,
                                           legacy=True)
        bundle = models.load_model(ref)
        if bundle.model.to_dict() != models.load_model(ckpt).model.to_dict():
            raise AssertionError("the reference checkpoint converts to "
                                 "another model")
        if cli.main(["inference", bam, native_hdf, "--model", ckpt]) != 0:
            raise AssertionError("inference of the native checkpoint failed")
        gru_split.reset_launches()
        t0 = time.perf_counter()
        if cli.main(["inference", bam, ref_hdf, "--model", ref]) != 0:
            raise AssertionError("inference of the reference checkpoint "
                                 "failed")
        torch.cuda.synchronize()
        t_inf = time.perf_counter() - t0
        launches = dict(gru_split.LAUNCHES)
        mode_launches = dict(gru_split.MODE_LAUNCHES)
        if cli.main(["sequence", ref_hdf, draft, ref_fasta]) != 0 or \
                cli.main(["sequence", native_hdf, draft, native_fasta]) != 0:
            raise AssertionError("sequence failed")
        n_samples, n_columns = check_probabilities(datastore, ref_hdf)
        with open(ref_fasta, "rb") as a, open(native_fasta, "rb") as b:
            identical = a.read() == b.read() and same_probabilities(
                datastore, native_hdf, ref_hdf)
        identity, edits, cons_len = consensus_identity(testing, ref_fasta,
                                                       draft)
        log("   {} samples, {} columns in {:.2f} s ({:.0f} columns/s); "
            "launches {} {}; probabilities and FASTA identical to the "
            "native checkpoint's: {}; consensus {} bp, identity to the draft "
            "{:.6f} ({} edits; 8 steps of training, as phase 11's)".format(
                                n_samples, n_columns, t_inf,
                                n_columns / t_inf, launches, mode_launches,
                                identical, cons_len, identity, edits))
        if not identical:
            raise AssertionError("the reference checkpoint's probabilities "
                                 "or FASTA differ from the native "
                                 "checkpoint's")
        if min(mode_launches[k + "/t"] for k in launches) < 1:
            raise AssertionError("a split kernel never launched in mode t")
        if not cons_len or not 0 < identity <= 1:
            raise AssertionError("no consensus")

    rows = []
    with phase("(26) gru_l1_split and gru_l2head_split at H={} against their "
               "plain versions and timed".format(H)):
        model = bundle.model.to(dev)
        batch = prediction.auto_batch_size(model, dev)
        mode = gru_split.split_mode(batch)
        log("   automatic batch at H={}: {} (mode {}; cap {})".format(
            H, batch, mode, prediction.AUTO_BATCH_CAP))
        if mode != "t" or batch > prediction.AUTO_BATCH_CAP:
            raise AssertionError("the 2x128 batch must run mode t within "
                                 "the cap")
        samples = []
        for region in prediction.plan_work(None, bam):
            samples.extend(features.SampleGenerator(
                bam, region, bundle.feature_encoder, chunk_len=10000,
                chunk_overlap=1000).samples)
        main = prediction.Batch.collate(samples[:batch], batch, 10000)
        T = 10000
        xt = torch.from_numpy(main.features).to(torch.bfloat16) \
            .transpose(0, 1).contiguous().to(dev)
        lens = torch.from_numpy(main.lengths).to(dev)
        lengths_sum = int(main.lengths.sum())
        checks = {}
        plain_ms = {}
        with torch.inference_mode():
            w = gru_split.prepare_split_weights(
                model.layer_params(), model.head_params(), "t", True, dev)
            l1_err, l2_err, stats, (kf, kb) = compare_kernels(
                gru_split, w, xt, lens, "t", True, plain_ms=plain_ms)
            checks["t/int8/T10000"] = {"B": batch, "l1_max": l1_err,
                                       "logit_max": l2_err, **stats}
            for m, rows_, quant in (("t", batch, False), ("rows", 64, True),
                                    ("rows", 64, False)):
                x_ = xt[:REF_CHECK_T, :rows_].contiguous()
                l_ = lens[:rows_].clamp(max=REF_CHECK_T).contiguous()
                w_ = gru_split.prepare_split_weights(
                    model.layer_params(), model.head_params(), m, quant, dev)
                e1, e2, st, _ = compare_kernels(gru_split, w_, x_, l_, m,
                                                quant)
                checks["{}/{}/T{}".format(m, "int8" if quant else "bf16",
                                          REF_CHECK_T)] = {
                    "B": rows_, "l1_max": e1, "logit_max": e2, **st}
            for key, rec in checks.items():
                log("   {}: {}".format(key, json.dumps(rec)))
            l1_args = (xt, lens, w["w_ih1"], w["b_ih1"], w["w_hh1"],
                       w["sc1"], w["b_hh1"])
            l2_args = (kf, kb, lens, w["w_in2"], w["in_scale2"], w["b_ih2"],
                       w["w_hh2"], w["sc2"], w["b_hh2"], w["w_head"])
            one_x, one_len = xt[:, :1].contiguous(), lens[:1]
            f1, b1 = gru_split.gru_l1_split(one_x, one_len, *l1_args[2:],
                                            mode="t")
            wr = gru_split.prepare_split_weights(
                model.layer_params(), model.head_params(), "rows", True, dev)
            xr, lr = xt[:, :64].contiguous(), lens[:64].contiguous()
            rf, rb = gru_split.gru_l1_split(xr, lr, wr["w_ih1"], wr["b_ih1"],
                                            wr["w_hh1"], wr["sc1"],
                                            wr["b_hh1"], mode="rows")
            calls = {
                "gru_l1_split": (
                    lambda: gru_split.gru_l1_split(*l1_args, mode="t"),
                    lambda: gru_split.gru_l1_split(
                        one_x, one_len, *l1_args[2:], mode="t"),
                    lambda: gru_split.gru_l1_split(
                        xr, lr, wr["w_ih1"], wr["b_ih1"], wr["w_hh1"],
                        wr["sc1"], wr["b_hh1"], mode="rows"), l1_err, IN),
                "gru_l2head_split": (
                    lambda: gru_split.gru_l2head_split(*l2_args, mode="t"),
                    lambda: gru_split.gru_l2head_split(
                        f1, b1, one_len, *l2_args[3:], mode="t"),
                    lambda: gru_split.gru_l2head_split(
                        rf, rb, lr, wr["w_in2"], wr["in_scale2"],
                        wr["b_ih2"], wr["w_hh2"], wr["sc2"], wr["b_hh2"],
                        wr["w_head"], mode="rows"), l2_err, 2 * H),
            }
            timed = {name: (cuda_ms(k), cuda_ms(o), cuda_ms(r))
                     for name, (k, o, r, _, _) in calls.items()}
            # mode "rows" at the path's length: its plain versions' times
            # (CUDA events, one run each)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            gru_split.gru_l1_split_plain(
                xr, lr, wr["w_ih1"], wr["b_ih1"], wr["w_hh1"], wr["sc1"],
                wr["b_hh1"], mode="rows", quant=True)
            ev[1].record()
            gru_split.gru_l2head_split_plain(
                rf, rb, lr, wr["w_in2"], wr["in_scale2"], wr["b_ih2"],
                wr["w_hh2"], wr["sc2"], wr["b_hh2"], wr["w_head"],
                mode="rows", quant=True)
            ev[2].record()
            torch.cuda.synchronize()
            rows_plain_ms = {
                "gru_l1_split": ev[0].elapsed_time(ev[1]),
                "gru_l2head_split": ev[1].elapsed_time(ev[2])}
        lib_ms = yardstick_ms(main.features, IN, 1, H, dev)
        lib2_ms = yardstick_ms(main.features, 2 * H, 1, H, dev)
        lib_rows_ms = yardstick_ms(main.features[:64], IN, 1, H, dev)
        r_sum = int(main.lengths[:64].sum())
        for name, (_, _, _, err, width) in calls.items():
            kind = "l1" if name == "gru_l1_split" else "l2"
            ms, floor_ms, rows_ms = timed[name]
            bound_ms, bound_by = bound(name, batch, H, IN, C, lengths_sum)
            rb_ms, rb_by = bound(name, 64, H, IN, C, r_sum)
            geo = {key: dict(zip(
                ("cluster", "columns", "smem_bytes", "resident_clusters"),
                gru_split.geometry(kind, H, cols, dev, m,
                                   IN if kind == "l1" else 0)))
                for key, cols, m in (("main", batch, "t"),
                                     ("rows_B64", 64, "rows"),
                                     ("one_column", 1, "t"))}
            rows.append({
                "name": name + "/h128", "route": "cuda",
                "source": KERNEL_SOURCE, "replaces": REPLACES[name],
                "launches": launches[name],
                "launches_by_mode": {m: mode_launches[name + "/" + m]
                                     for m in gru_split.MODES},
                "max_abs_err": err, "ms": ms, "kernel_ms": ms,
                "plain_ms": plain_ms[name], "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": lib_ms if name == "gru_l1_split" else None,
                "library": "torch.nn.GRU({}, {}, 1, bidirectional=True) bf16 "
                           "(cuDNN) over the same {} rows: {:.2f} ms".format(
                               width, H, batch,
                               lib_ms if kind == "l1" else lib2_ms),
                "serial_floor_ms": floor_ms, "step_us": ms / T * 1e3,
                "serial_floor_step_us": floor_ms / T * 1e3,
                "rows_mode": {"B": 64, "ms": rows_ms, "bound_ms": rb_ms,
                              "bound_by": rb_by,
                              "plain_ms": rows_plain_ms[name],
                              "library_ms": lib_rows_ms
                              if kind == "l1" else None},
                "geometry": geo, "checks": checks,
                "shape": {"B": batch, "T": T, "H": H, "inputs": IN,
                          "classes": C, "valid_columns": lengths_sum},
                "path": "inference --model <legacy reference checkpoint, "
                        "2x128> on phase 4's BAM, {:.0f} columns/s".format(
                            n_columns / t_inf),
                "ptxas": {SPLIT_KERNEL_OF[name]: ptxas["gru_split.cu"][
                    SPLIT_KERNEL_OF[name]]}})
            log("   {}/h128: {:.2f} ms (plain {:.1f} ms, bound {:.4f} ms by "
                "{}, one column {:.2f} ms; mode rows B=64 {:.2f} ms, plain "
                "{:.1f} ms, cuDNN layer 1 over 64 rows {:.2f} ms; cuDNN "
                "{:.2f} ms); geometry {}".format(
                    name, ms, plain_ms[name], bound_ms, bound_by, floor_ms,
                    rows_ms, rows_plain_ms[name], lib_rows_ms,
                    lib_ms if kind == "l1" else lib2_ms, json.dumps(geo)))
        del xt, kf, kb, f1, b1, rf, rb, w, wr
        model.to("cpu")
        torch.cuda.empty_cache()
    return rows


def reference_read_level_phase(work, rl_paths, modules):
    """Phase 27: phase 14's last checkpoint written as a reference
    checkpoint serves ``inference`` + ``sequence`` over phase 14's BAM cut
    to REF_RL_REGION_KB kb with the native checkpoint's probabilities, bit
    for bit."""
    bilstm, cli, datastore, models, testing = (modules[k] for k in (
        "bilstm", "cli", "datastore", "models", "testing"))
    region = "synth:0-{}".format(REF_RL_REGION_KB * 1000)
    native = os.path.join(work, "rl_native.hdf")
    ref_hdf = os.path.join(work, "rl_reference.hdf")
    ref = os.path.join(work, "rl_reference.tar.gz")
    chunks = ["--chunk_len", "1000", "--chunk_ovlp", "100", "--regions",
              region]
    with phase("(27) the read-level checkpoint as a reference checkpoint: "
               "inference + sequence over {}".format(region)):
        testing.write_reference_checkpoint(
            models.load_model(rl_paths["checkpoint"]), ref)
        if cli.main(["inference", rl_paths["bam"], native, "--model",
                     rl_paths["checkpoint"]] + chunks) != 0:
            raise AssertionError("read-level native inference failed")
        bilstm.reset_launches()
        t0 = time.perf_counter()
        if cli.main(["inference", rl_paths["bam"], ref_hdf, "--model", ref]
                    + chunks) != 0:
            raise AssertionError("read-level reference inference failed")
        seconds = time.perf_counter() - t0
        launches = dict(bilstm.LAUNCHES)
        fasta = os.path.join(work, "rl_reference.fasta")
        if cli.main(["sequence", ref_hdf, rl_paths["draft"], fasta,
                     "--regions", region]) != 0:
            raise AssertionError("read-level reference sequence failed")
        n_samples, n_columns = check_probabilities(datastore, ref_hdf)
        identical = same_probabilities(datastore, native, ref_hdf)
        with open(fasta) as fh:
            consensus = "".join(fh.read().splitlines()[1:])
        log("   {} samples, {} columns in {:.2f} s; bilstm_fused launches "
            "{}; probabilities bit-identical to the native checkpoint's: {};"
            " consensus {} bp".format(n_samples, n_columns, seconds,
                                      launches, identical, len(consensus)))
        if not identical or not launches.get("bilstm_fused"):
            raise AssertionError("the read-level reference checkpoint did "
                                 "not serve the native probabilities")
        if not consensus or set(consensus) - set("ACGTN"):
            raise AssertionError("bad read-level consensus")
    return {"samples": n_samples, "columns": n_columns, "seconds": seconds,
            "launches": launches}


def reference_files_phases(seed, work, bam, draft, hdf, fasta, modules):
    """Phase 28: phase 5's probabilities as reference medaka writes them
    (gzip-1, pickled ``meta/``) through ``sequence``; fast5 tables through
    ``compress_bam --use_fast5_info`` and ``tools rlebam``; ``tools
    export`` of the bundled counts model."""
    import numpy as np
    import torch
    cli, datastore, models, testing = (modules[k] for k in (
        "cli", "datastore", "models", "testing"))
    from medaka_tpu_torch.common import Region
    from medaka_tpu_torch.io.bam import BamReader
    out = {}
    ref_probs = os.path.join(work, "reference_probs.hdf")
    with phase("(28) phase 5's probabilities in the reference's layout "
               "(gzip-1, pickled meta/): sequence"):
        t0 = time.perf_counter()
        testing.write_reference_probabilities(hdf, ref_probs)
        t_write = time.perf_counter() - t0
        _, n_columns = check_probabilities(datastore, ref_probs)
        rates = {}
        for label, path in (("uncompressed", hdf), ("gzip", ref_probs)):
            dst = os.path.join(work, "sequence_{}.fasta".format(label))
            t0 = time.perf_counter()
            if cli.main(["sequence", path, draft, dst]) != 0:
                raise AssertionError("sequence of {} failed".format(path))
            rates[label] = n_columns / (time.perf_counter() - t0)
            with open(dst, "rb") as a, open(fasta, "rb") as b:
                if a.read() != b.read():
                    raise AssertionError("sequence of the {} file differs "
                                         "from phase 5's FASTA".format(label))
        sizes = {k: os.path.getsize(p) for k, p in (("uncompressed", hdf),
                                                    ("gzip", ref_probs))}
        out["probabilities"] = {"columns": n_columns, "rewrite_s": t_write,
                                "sequence_columns_per_s": rates,
                                "bytes": sizes}
        log("   rewritten in {:.2f} s ({} -> {} bytes); sequence of {} "
            "columns: {:.0f} columns/s uncompressed, {:.0f} gzip-1; both "
            "FASTAs phase 5's".format(t_write, sizes["uncompressed"],
                                      sizes["gzip"], n_columns,
                                      rates["uncompressed"], rates["gzip"]))

    region = Region("synth", 0, FAST5_REGION_KB * 1000)
    fast5_dir = os.path.join(work, "fast5")
    os.makedirs(fast5_dir)
    fast5 = os.path.join(fast5_dir, "reads.fast5")
    summary = os.path.join(work, "sequencing_summary.txt")
    with phase("(28) fast5 tables of the reads over the first {} kb: "
               "compress_bam --use_fast5_info, tools rlebam".format(
                   FAST5_REGION_KB)):
        planted = testing.plant_fast5_tables(bam, fast5, summary, seed=seed,
                                             region=region)
        rle_bam = os.path.join(work, "fast5_rle.bam")
        threads = os.cpu_count()
        t0 = time.perf_counter()
        if cli.main(["compress_bam", bam, rle_bam, draft, "--regions",
                     "synth:0-{}".format(FAST5_REGION_KB * 1000),
                     "--threads", str(threads), "--use_fast5_info",
                     fast5_dir, summary]) != 0:
            raise AssertionError("compress_bam --use_fast5_info failed")
        t_compress = time.perf_counter() - t0
        with BamReader(rle_bam) as reader:
            recs = list(reader)
        if len(recs) != len(planted) or any(
                not np.array_equal(r.tags["WL"], planted[r.query_name][0])
                or not np.array_equal(r.tags["WK"], planted[r.query_name][1])
                for r in recs):
            raise AssertionError("compress_bam's WL/WK tags are not the "
                                 "planted tables")
        sam = testing.write_sam(bam, os.path.join(work, "fast5_reads.sam"),
                                region)
        index = os.path.join(work, "fast5_index.tsv")
        with open(index, "w") as fh:
            for read_id in planted:
                fh.write("{}\t{}\n".format(read_id, fast5))
        decorated = os.path.join(work, "fast5_decorated.sam")
        t0 = time.perf_counter()
        with open(sam) as fin, open(decorated, "w") as fout:
            subprocess.run([sys.executable, "-m", "medaka_tpu_torch",
                            "tools", "rlebam", index, "--workers", "4"],
                           stdin=fin, stdout=fout, cwd=HERE, check=True)
        t_rlebam = time.perf_counter() - t0
        tagged = 0
        with open(decorated) as fh:
            for line in fh:
                if line.startswith("@"):
                    continue
                fields = line.rstrip("\n").split("\t")
                tags = {f[:2]: np.array(f[7:].split(","), np.float32)
                        for f in fields[11:] if f[2:7] == ":B:f,"}
                if int(fields[1]) & (256 | 2048) or not tags:
                    continue
                shape, scale = planted[fields[0]]
                # rlebam writes the scale as WL and the shape as WK
                if not (np.array_equal(tags["WL"], scale)
                        and np.array_equal(tags["WK"], shape)):
                    raise AssertionError("rlebam's tags for {} are not the "
                                         "planted table".format(fields[0]))
                tagged += 1
        if tagged != len(planted):
            raise AssertionError("rlebam tagged {} of {} reads".format(
                tagged, len(planted)))
        out["fast5"] = {"reads": len(planted), "compress_bam_s": t_compress,
                        "threads": threads, "rlebam_s": t_rlebam,
                        "rlebam_workers": 4}
        log("   {} reads: compress_bam --use_fast5_info {:.2f} s at {} "
            "threads, tags the planted tables; tools rlebam {:.2f} s (4 "
            "spawned workers), tags the planted tables".format(
                len(planted), t_compress, threads, t_rlebam))

    with phase("(28) tools export of the bundled counts model"):
        exported = os.path.join(work, "counts_export")
        if cli.main(["tools", "export", MODEL, "--output", exported]) != 0:
            raise AssertionError("tools export failed")
        weights = extract_member(exported + ".tar.gz", "model/weights.pt",
                                 os.path.join(work, "counts_export_dir"))
        state = torch.load(weights, map_location="cpu", weights_only=True)
        bundle = models.load_model(MODEL)
        again = models.model_from_dict(bundle.model.to_dict())
        again.load_torch_state(state)
        want = bundle.model.state_dict()
        if any(not torch.equal(v, want[k])
               for k, v in again.state_dict().items()):
            raise AssertionError("the exported weights do not load back "
                                 "equal")
        out["export"] = {"tensors": len(state)}
        log("   {} tensors in weights.pt load back equal".format(len(state)))
    return out


def options_and_formats_phases(seed, work, bam, draft, hdf, fasta, rl_paths,
                               dev, rng, ptxas, modules):
    """Phases 25-28; returns the ``kernels`` rows of the H=128 launches
    (the split kernels, gru_fwd and gru_bwd), with the phases' records on
    the first."""
    from medaka_tpu_torch import training
    validation = validate_only_phase(seed, work, rl_paths, modules)
    ckpt, train_rows = reference_width_training(
        seed, work, dev, rng, ptxas, dict(modules, training=training))
    split_rows = reference_width_inference(work, bam, draft, ckpt, dev,
                                           ptxas, modules)
    read_level = reference_read_level_phase(work, rl_paths, modules)
    files = reference_files_phases(seed, work, bam, draft, hdf, fasta,
                                   modules)
    rows = split_rows + train_rows
    rows[0]["training_options_and_formats"] = {
        "validate_only": validation, "reference_read_level": read_level,
        **files}
    return rows


#: phase 32: the grouped-subread FASTA (``testing.write_subreads_fasta``):
#: molecules, their length, subreads a molecule and their error share
SMOLECULE_MOLECULES = 64
SMOLECULE_LENGTH = 1500
SMOLECULE_SUBREADS = 10
SMOLECULE_ERROR = 0.08
#: the median identity of the polished molecules to the true ones (and at
#: least the POA drafts'); on the CPU in bf16, 8 such molecules gave
#: 0.99875 against the drafts' 0.99845
MIN_SMOLECULE_IDENTITY = 0.99
#: the molecules also polished with ``--cpu``, and the most edits over
#: them between the card's FASTA (int8 split kernels) and the CPU's (the
#: bf16 scan): near-tie columns of the int8 scheme (ROADMAP.md queue 3
#: item 3)
SMOLECULE_CPU_MOLECULES = 8
MAX_SMOLECULE_CPU_EDITS = 4
#: the rows and steps a smolecule batch holds (``--batch_size`` 32,
#: ``--chunk_len`` 1000: the split kernels' mode "rows")
SMOLECULE_BATCH, SMOLECULE_T = 32, 1000
#: phase 33: the diploid STR genome (``testing.create_str_bam``): loci and
#: depth a haplotype; the fewest loci of each run whose planted genotype
#: and allele lengths (within a base) the VCF recovers
TANDEM_LOCI, TANDEM_DEPTH = 24, 20
MIN_TANDEM_RECOVERED = {"hybrid": 22, "abpoa": 22}
#: the most VCF records that may differ between the card and ``--cpu``
#: (the float32 scan on both: only the order of f32 sums differs)
MAX_TANDEM_CPU_RECORDS = 0


def vcf_records(path):
    """The data lines of a VCF."""
    with open(path) as fh:
        return [line for line in fh if not line.startswith("#")]


def workflow_phases(seed, work, dev, modules):
    """The smolecule and tandem workflows on the card (phases 32-33):
    ``smolecule`` of a grouped-subread FASTA through the CLI on the split
    kernels in mode "rows" (one batch of the run held against their plain
    versions and timed), and ``tandem --phasing hybrid`` and ``abpoa``
    (the float32 scan, as ``medaka_tpu`` runs it) on a diploid STR genome,
    each against the same command with ``--cpu``. Returns the split
    kernels' launches and times on the smolecule path, and what the
    phases measured."""
    import numpy as np
    import torch
    cli, features, gru_split, models, native, prediction, smolecule, \
        testing = (modules[k] for k in (
            "cli", "features", "gru_split", "models", "native", "prediction",
            "smolecule", "testing"))
    from medaka_tpu_torch.io.fastx import read_fastx
    card = card_line()
    out = {"card": card}

    subreads = os.path.join(work, "subreads.fasta")
    with phase("(32) smolecule data: {} molecules of ~{} bases, {} subreads "
               "each at {:.0%} errors".format(
                   SMOLECULE_MOLECULES, SMOLECULE_LENGTH, SMOLECULE_SUBREADS,
                   SMOLECULE_ERROR)):
        truth = testing.write_subreads_fasta(
            subreads, n_molecules=SMOLECULE_MOLECULES,
            length=SMOLECULE_LENGTH, n_subreads=SMOLECULE_SUBREADS,
            error=SMOLECULE_ERROR, seed=seed)
    smol = os.path.join(work, "smolecule")
    with phase("(32) smolecule --model gru256_lambda_demo --threads 8 "
               "through the CLI"):
        with timed_calls([(smolecule, "poa_workflow"),
                          (prediction, "predict")]) as stage_s:
            gru_split.reset_launches()
            t0 = time.perf_counter()
            if cli.main(["smolecule", smol, subreads, "--model", MODEL,
                         "--threads", "8", "--quiet"]) != 0:
                raise AssertionError("smolecule failed")
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = dict(gru_split.LAUNCHES)
            modes = dict(gru_split.MODE_LAUNCHES)
    stage_s = {"poa": stage_s["poa_workflow"], "neural": stage_s["predict"]}
    log("   launches {} {}; {:.2f} s: POA {:.2f} s, neural {:.2f} s ({})"
        .format(launches, modes, seconds, stage_s["poa"],
                stage_s["neural"], card))
    for name in ("gru_l1_split", "gru_l2head_split"):
        if modes[name + "/rows"] < 1 or modes[name + "/t"] != 0:
            raise AssertionError("smolecule must run {} in mode rows only: "
                                 "{}".format(name, modes))

    with phase("(32) check the consensus against the true molecules"):
        poa = {r.name: r.sequence
               for r in read_fastx(os.path.join(smol, "poa.fasta"))}
        polished = {r.name.split("_")[0]: r.sequence for r in read_fastx(
            os.path.join(smol, "consensus.fasta"))}
        if sorted(polished) != sorted(truth) or sorted(poa) != sorted(truth):
            raise AssertionError("smolecule wrote {} of {} molecules".format(
                len(polished), len(truth)))

        def identity(seqs):
            return float(np.median([
                1.0 - native.edit_distance(seqs[k], truth[k]) / len(truth[k])
                for k in truth]))
        ident, poa_ident = identity(polished), identity(poa)
    log("   median identity to the true molecules: polished {:.6f}, POA "
        "drafts {:.6f}".format(ident, poa_ident))
    if ident < poa_ident or ident < MIN_SMOLECULE_IDENTITY:
        raise AssertionError("the polished molecules are worse than the "
                             "floor or their drafts")

    with phase("(32) one batch of the run: the split kernels (mode rows, "
               "B={}, T={}) vs their plain versions, timed".format(
                   SMOLECULE_BATCH, SMOLECULE_T)):
        bundle = models.load_model(MODEL)
        model = bundle.model
        bam = os.path.join(smol, "subreads_to_poa.bam")
        samples = []
        for region in prediction.plan_work(None, bam, chunk_overlap=500):
            samples.extend(features.SampleGenerator(
                bam, region, bundle.feature_encoder,
                chunk_len=SMOLECULE_T, chunk_overlap=500).samples)
            if len(samples) >= SMOLECULE_BATCH:
                break
        batch = prediction.Batch.collate(samples[:SMOLECULE_BATCH],
                                         SMOLECULE_BATCH, SMOLECULE_T)
        if gru_split.split_mode(SMOLECULE_BATCH) != "rows":
            raise AssertionError("a 32-row batch must take mode rows")
        xt = torch.from_numpy(batch.features).to(torch.bfloat16) \
            .transpose(0, 1).contiguous().to(dev)
        lens = torch.from_numpy(batch.lengths).to(dev)
        lengths_sum = int(batch.lengths.sum())
        plain_ms = {}
        with torch.inference_mode():
            w = gru_split.prepare_split_weights(
                model.layer_params(), model.head_params(), "rows", True, dev)
            l1_err, l2_err, stats, (kf, kb) = compare_kernels(
                gru_split, w, xt, lens, "rows", True, plain_ms=plain_ms)
            ms = {
                "gru_l1_split": cuda_ms(lambda: gru_split.gru_l1_split(
                    xt, lens, w["w_ih1"], w["b_ih1"], w["w_hh1"], w["sc1"],
                    w["b_hh1"], mode="rows")),
                "gru_l2head_split": cuda_ms(
                    lambda: gru_split.gru_l2head_split(
                        kf, kb, lens, w["w_in2"], w["in_scale2"],
                        w["b_ih2"], w["w_hh2"], w["sc2"], w["b_hh2"],
                        w["w_head"], mode="rows"))}
        library = {"gru_l1_split": yardstick_ms(batch.features, 10, 1, 256,
                                                dev),
                   "gru_l2head_split": None}
        timing = {}
        for name in ("gru_l1_split", "gru_l2head_split"):
            bound_ms, bound_by = bound(name, SMOLECULE_BATCH, 256, 10, 5,
                                       lengths_sum)
            timing[name] = {
                "launches": modes[name + "/rows"], "ms": ms[name],
                "plain_ms": plain_ms[name], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library[name],
                "B": SMOLECULE_BATCH, "T": SMOLECULE_T,
                "valid_columns": lengths_sum,
                "geometry": gru_split.geometry(
                    "l1", 256, SMOLECULE_BATCH, dev, "rows", 10)
                if name == "gru_l1_split" else gru_split.geometry(
                    "l2", 256, SMOLECULE_BATCH, dev, "rows")}
        del kf, kb, xt, w
        torch.cuda.empty_cache()
    log("   l1 max {:.3g}, l2 logit max {:.3g}; probs max {:.3g} mean "
        "{:.3g}, argmax agreement {:.6f}".format(
            l1_err, l2_err, stats["max"], stats["mean"],
            stats["argmax_agreement"]))
    for name, rec in timing.items():
        log("   {} mode rows at B={} T={}: {:.3f} ms (plain {:.1f} ms, "
            "bound {:.4f} ms by {}, cuDNN {}; {} launches on the path; "
            "geometry {}; {})".format(
                name, SMOLECULE_BATCH, SMOLECULE_T, rec["ms"],
                rec["plain_ms"], rec["bound_ms"], rec["bound_by"],
                "{:.2f} ms".format(rec["library_ms"])
                if rec["library_ms"] is not None else "none",
                rec["launches"], rec["geometry"], card))

    first = sorted(truth, key=lambda k: int(k[3:]))[:SMOLECULE_CPU_MOLECULES]
    subset = os.path.join(work, "subreads_first.fasta")
    with open(subset, "w") as fh:
        for rec in read_fastx(subreads):
            if rec.name.split("_")[0] in first:
                fh.write(">{}\n{}\n".format(rec.name, rec.sequence))
    smol_cpu = os.path.join(work, "smolecule_cpu")
    with phase("(32) smolecule --cpu over the first {} molecules against "
               "the card's".format(SMOLECULE_CPU_MOLECULES)):
        t0 = time.perf_counter()
        if cli.main(["smolecule", smol_cpu, subset, "--model", MODEL,
                     "--threads", "8", "--cpu", "--quiet"]) != 0:
            raise AssertionError("smolecule --cpu failed")
        cpu_s = time.perf_counter() - t0
        on_cpu = {r.name.split("_")[0]: r.sequence for r in read_fastx(
            os.path.join(smol_cpu, "consensus.fasta"))}
        edits = {k: native.edit_distance(polished[k], on_cpu[k])
                 for k in first}
    log("   edits between the card's and the CPU's molecules: {} (in all "
        "{}); the CPU run {:.2f} s".format(edits, sum(edits.values()),
                                          cpu_s))
    if sum(edits.values()) > MAX_SMOLECULE_CPU_EDITS:
        raise AssertionError("the card's consensus is more than {} edits "
                             "from the CPU's".format(MAX_SMOLECULE_CPU_EDITS))
    out["smolecule"] = {
        "molecules": SMOLECULE_MOLECULES, "seconds": seconds,
        "poa_s": stage_s["poa"], "neural_s": stage_s["neural"],
        "launches": launches, "launches_by_mode": modes,
        "median_identity": ident, "poa_median_identity": poa_ident,
        "l1_max": l1_err, "logit_max": l2_err, "network": stats,
        "kernels": timing, "cpu_edits": sum(edits.values()),
        "cpu_seconds": cpu_s}

    with phase("(33) tandem data: a diploid STR genome, {} loci, depth {} "
               "a haplotype".format(TANDEM_LOCI, TANDEM_DEPTH)):
        bam, ref, loci = testing.create_str_bam(
            os.path.join(work, "str.bam"), n_loci=TANDEM_LOCI,
            depth=TANDEM_DEPTH, seed=seed)
    regions = [str(locus["region"]) for locus in loci]
    out["tandem"] = {}
    for phasing in ("hybrid", "abpoa"):
        runs = {}
        for where in ("card", "cpu"):
            target = os.path.join(work, "tandem_{}_{}".format(phasing,
                                                              where))
            argv = ["tandem", bam, ref, target, "--regions", *regions,
                    "--model", MODEL, "--phasing", phasing, "--workers",
                    "4", "--quiet"] + (["--cpu"] if where == "cpu" else [])
            with phase("(33) tandem --phasing {} --workers 4{}".format(
                    phasing, " --cpu" if where == "cpu" else "")):
                with timed_calls([(prediction, "predict")]) as stage:
                    gru_split.reset_launches()
                    t0 = time.perf_counter()
                    if cli.main(argv) != 0:
                        raise AssertionError("tandem failed")
                    torch.cuda.synchronize()
                    runs[where] = {
                        "seconds": time.perf_counter() - t0,
                        "neural_s": stage.get("predict", 0.0),
                        "launches": dict(gru_split.LAUNCHES)}
            vcf = os.path.join(target, "medaka_to_ref.TR.vcf")
            runs[where]["vcf"] = vcf_records(vcf)
            called = testing.str_genotypes(vcf, loci)
            runs[where]["recovered"] = sum(
                gt == got and all(abs(a - b) <= 1 for a, b in zip(la, lb))
                for gt, got, la, lb in called.values())
            log("   {:.2f} s (predict {:.2f} s) on the {}; split kernel "
                "launches {} (full precision: the f32 scan); {} records, "
                "{} of {} loci recovered".format(
                    runs[where]["seconds"], runs[where]["neural_s"], where,
                    runs[where]["launches"], len(runs[where]["vcf"]),
                    runs[where]["recovered"], len(loci)))
        if any(runs["card"]["launches"].values()):
            raise AssertionError("tandem's full-precision polish launched a "
                                 "split kernel")
        if runs["card"]["recovered"] < MIN_TANDEM_RECOVERED[phasing]:
            raise AssertionError("tandem --phasing {} recovered {} loci, "
                                 "under {}".format(
                                     phasing, runs["card"]["recovered"],
                                     MIN_TANDEM_RECOVERED[phasing]))
        differ = len(set(runs["card"]["vcf"]) ^ set(runs["cpu"]["vcf"]))
        log("   VCF records differing between the card and --cpu: {}"
            .format(differ))
        if differ > MAX_TANDEM_CPU_RECORDS or \
                len(runs["card"]["vcf"]) != len(runs["cpu"]["vcf"]):
            raise AssertionError("tandem's VCF on the card differs from "
                                 "--cpu's in {} records".format(differ))
        out["tandem"][phasing] = {
            where: {k: v for k, v in rec.items() if k != "vcf"}
            for where, rec in runs.items()}
        out["tandem"][phasing]["records"] = len(runs["card"]["vcf"])
        out["tandem"][phasing]["differing_records"] = differ
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random inputs and weights")
    args = parser.parse_args(argv)
    seed = args.seed

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is available", file=sys.stderr)
        return 1
    import numpy as np

    sys.path.insert(0, HERE)
    from medaka_tpu_torch import cli, datastore, features, mapping, models, \
        native, parallel, prediction, smolecule, stitch, testing, training, \
        vcf
    from medaka_tpu_torch.ops import bilstm, cuda_build, gru_fullfused, \
        gru_split, gru_train, lstm_train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    card = card_line()
    log("card:", card)

    with phase("build"):
        # one nvcc for each kernel source and the g++ build of the
        # host-side pileup and read-matrix library, all at once, so that
        # no one-time build lands in a main path's timing
        def timed(fn):
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0

        def native_build():
            if not native.available():
                raise AssertionError("the native library did not build")

        builds = {"nvcc gru_split.cu": gru_split.build,
                  "nvcc bilstm.cu": bilstm.build,
                  "nvcc gru_train.cu": gru_train.build,
                  "nvcc lstm_train.cu": lstm_train.build,
                  "nvcc gru_fullfused.cu": gru_fullfused.build,
                  "g++ native": native_build}
        with ThreadPoolExecutor(len(builds)) as pool:
            futures = {name: pool.submit(timed, fn)
                       for name, fn in builds.items()}
            for name, future in futures.items():
                log("   {} build {:.1f} s".format(name, future.result()))
        for source, text in cuda_build.BUILD_LOGS.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log("  ", source, line.strip())
        ptxas = {source: ptxas_report(cuda_build.BUILD_LOGS.get(source, ""),
                                      kernels)
                 for source, kernels in (
                     ("lstm_train.cu", ("lstm_fwd_kernel", "lstm_bwd_kernel",
                                        "rnn_dw_kernel")),
                     ("gru_train.cu", ("gru_cluster_fwd_kernel",
                                       "gru_cluster_bwd_kernel",
                                       "rnn_dw_kernel")),
                     ("gru_fullfused.cu", ("gru_cluster_fwd_kernel",
                                           FWD_PTXAS["f32_gates"],
                                           FWD_PTXAS["bf16_gates"],
                                           FWD_PTXAS["int8"],
                                           "bigru_proj_mma_kernel",
                                           "bigru_proj_kernel")),
                     ("bilstm.cu", ("lstm_fwd_kernel",)),
                     ("gru_split.cu", SPLIT_KERNELS + SPLIT_BF16_KERNELS
                      + ("gru_l2head_split_kernel",)))}
        for source, report in ptxas.items():
            for kernel, recs in report.items():
                for rec in recs:
                    log("   ptxas {} {} ({}): {} registers, {} bytes static "
                        "shared memory, {} bytes stack, spill stores {} "
                        "loads {}".format(
                            source, kernel, rec["entry"],
                            rec.get("registers"), rec.get("smem_bytes"),
                            rec.get("stack_bytes"), rec.get("spill_stores"),
                            rec.get("spill_loads")))
                if not recs:
                    raise AssertionError("no ptxas report for {} in {}".format(
                        kernel, source))

    with phase("kernels vs plain versions, T=2000, four combinations"):
        layers, head = random_net(rng)
        T = 2000
        for mode, B in (("t", 256), ("rows", 64)):
            for quant in (True, False):
                x = torch.from_numpy(rng.random((B, T, 10)).astype("float32"))
                lengths = torch.from_numpy(
                    rng.integers(T // 2, T + 1, B).astype("int32"))
                lengths[0] = T
                w = gru_split.prepare_split_weights(layers, head, mode,
                                                    quant, dev)
                xt = x.transpose(0, 1).to(torch.bfloat16).contiguous().to(dev)
                l1_err, l2_err, stats, _ = compare_kernels(
                    gru_split, w, xt, lengths.to(dev), mode, quant)
                log("   mode={} B={} quant={}: l1 max {:.3g}, l2 logit max "
                    "{:.3g}; probs max {:.3g} mean {:.3g}, argmax "
                    "agreement {:.6f}".format(
                        mode, B, quant, l1_err, l2_err, stats["max"],
                        stats["mean"], stats["argmax_agreement"]))

    head_agreement = {}
    with phase("the head at {} classes: kernels vs plain versions, "
               "T={}, four combinations each".format(
                   ", ".join(map(str, HEAD_CHECK_CLASSES)), HEAD_CHECK_T)):
        T = HEAD_CHECK_T
        for classes in HEAD_CHECK_CLASSES:
            layers, head = random_net(rng, classes=classes)
            for mode, B in (("t", 256), ("rows", 64)):
                for quant in (True, False):
                    x = torch.from_numpy(
                        rng.random((B, T, 10)).astype("float32"))
                    lengths = torch.from_numpy(
                        rng.integers(T // 2, T + 1, B).astype("int32"))
                    lengths[0] = T
                    w = gru_split.prepare_split_weights(layers, head, mode,
                                                        quant, dev)
                    xt = x.transpose(0, 1).to(torch.bfloat16).contiguous() \
                        .to(dev)
                    l1_err, l2_err, stats, _ = compare_kernels(
                        gru_split, w, xt, lengths.to(dev), mode, quant)
                    head_agreement["C{}/{}/{}".format(
                        classes, mode, "int8" if quant else "bf16")] = {
                        "B": B, "l1_max": l1_err, "logit_max": l2_err,
                        **stats}
                    log("   C={} mode={} B={} quant={}: l1 max {:.3g}, l2 "
                        "logit max {:.3g}; probs max {:.3g}, argmax "
                        "agreement {:.6f}".format(
                            classes, mode, B, quant, l1_err, l2_err,
                            stats["max"], stats["argmax_agreement"]))

    with phase("bi-LSTM kernel vs plain version, H=128 and H=384"):
        for H, B, T in ((128, 128, 1000), (384, 32, 500)):
            err, mean = compare_bilstm(
                bilstm, random_lstm_inputs(rng, H, B, T, dev))
            log("   H={} B={} T={}: max {:.3g}, mean {:.3g}".format(
                H, B, T, err, mean))

    train_agreement = {}
    with phase("training kernels vs plain versions, H=256 B=128 T=1000"):
        for reverse in (False, True):
            stats = compare_gru_train(
                gru_train, *random_direction(rng, 256, 128, 1000, dev),
                reverse)
            log("   reverse={}: gru_fwd max {:.3g} mean {:.3g}; gru_bwd "
                "relative max dxp {:.3g}, dW_hh {:.3g}, db_hh {:.3g}; "
                "repeat bit-identical; gru_bwd (cluster, columns, shared "
                "memory, resident clusters) {}".format(
                    reverse, stats["fwd_max"], stats["fwd_mean"],
                    stats["dxp"], stats["dW_hh"], stats["db_hh"],
                    gru_train.bwd_geometry(256, 128, dev)))
            train_agreement["reverse" if reverse else "forward"] = stats

    lstm_agreement = {}
    with phase("LSTM training kernels vs plain versions, H=384 and H=128, "
               "B=128 T=1000"):
        for H in (384, 128):
            for reverse in (False, True):
                stats = compare_lstm_train(
                    lstm_train, *random_direction(rng, H, 128, 1000, dev,
                                                  gates=4), reverse)
                log("   H={} reverse={}: lstm_fwd h max {:.3g} mean {:.3g}, "
                    "c relative {:.3g}; lstm_bwd relative max dxp {:.3g}, "
                    "dW_hh {:.3g}, db_hh {:.3g}; repeat bit-identical; "
                    "(cluster, columns, shared memory, resident clusters) "
                    "fwd {} bwd {}".format(
                        H, reverse, stats["fwd_max"], stats["fwd_mean"],
                        stats["c"], stats["dxp"], stats["dW_hh"],
                        stats["db_hh"],
                        *(lstm_train.geometry(kind, H, 128, dev)
                          for kind in ("fwd", "bwd"))))
                lstm_agreement["H{}_{}".format(
                    H, "reverse" if reverse else "forward")] = stats
        torch.cuda.empty_cache()

    with phase("fullfused kernels vs plain versions, H=256 B=16 T=2000 "
               "(layers 1 and 2), H=96 B=31 T=500 (3 layers)"):
        ff_agreement = fullfused_agreement(gru_fullfused, rng, dev)
        torch.cuda.empty_cache()

    with phase("gru_fwd and bigru_fused at a small width, H=96 B=31 "
               "T=500: timings"):
        small_width = small_width_timings(gru_fullfused, gru_train, rng, dev)

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        with phase("synthetic BAM, 0.5 Mb at depth 20"):
            bam, draft = testing.create_synth_bam(
                os.path.join(work, "reads.bam"), ref_mb=0.5, depth=20,
                seed=seed)
        bundle = models.load_model(MODEL)
        batch = prediction.auto_batch_size(bundle.model, dev)
        log("   automatic batch {} (mode {})".format(
            batch, gru_split.split_mode(batch)))
        if gru_split.split_mode(batch) != "t":
            raise AssertionError("the main path must run mode t")

        hdf = os.path.join(work, "probs.hdf")
        fasta = os.path.join(work, "consensus.fasta")
        with phase("main path: inference + sequence"):
            gru_split.reset_launches()
            t0 = time.perf_counter()
            if cli.main(["inference", bam, hdf, "--model", MODEL]) != 0:
                raise AssertionError("inference failed")
            torch.cuda.synchronize()
            t_inference = time.perf_counter() - t0
            launches = dict(gru_split.LAUNCHES)
            mode_launches = dict(gru_split.MODE_LAUNCHES)
            if cli.main(["sequence", hdf, draft, fasta]) != 0:
                raise AssertionError("sequence failed")
        log("   launches on the main path:", launches, mode_launches)
        if min(launches.values()) < 1 or min(
                mode_launches[name + "/t"] for name in launches) < 1:
            raise AssertionError("a kernel of the main path never launched")

        with phase("check the output"):
            n_samples, n_columns = check_probabilities(datastore, hdf)
            # the int8 kernels ("t") against the float32 scan, 8 chunks
            region = prediction.plan_work(None, bam)[0]
            samples = features.SampleGenerator(
                bam, region, bundle.feature_encoder, chunk_len=10000,
                chunk_overlap=1000).samples[:8]
            small = prediction.Batch.collate(samples, len(samples), 10000)
            x8 = torch.from_numpy(small.features).to(dev)
            len8 = torch.from_numpy(small.lengths).to(dev)
            model = bundle.model.to(dev)
            with torch.inference_mode():
                ref = model(x8, lengths=len8, compute_dtype=None)
                got = torch.softmax(gru_split.bigru_head_fullfused(
                    model.layer_params(), model.head_params(), x8, len8,
                    layout="t", device=dev), -1)
            valid = (torch.arange(10000, device=dev)[None, :]
                     < len8[:, None].long())
            diff = (got - ref).abs()[valid]
            agree = (got.argmax(-1) == ref.argmax(-1))[valid].float().mean()
            log("   int8 kernels vs float32 scan on 8 chunks: probs max "
                "{:.3g} mean {:.3g}, argmax agreement {:.6f}".format(
                    diff.max().item(), diff.mean().item(), agree.item()))
            if diff.max().item() > TOL_SCAN_PROB_MAX or \
                    diff.mean().item() > TOL_SCAN_PROB_MEAN or \
                    agree.item() < MIN_SCAN_ARGMAX_AGREEMENT:
                raise AssertionError("kernels vs scan exceed the int8 bars")

            identity, edits, cons_len = consensus_identity(testing, fasta,
                                                           draft)
            log("   {} samples, {} columns in {:.2f} s of inference: {:.0f} "
                "columns/s; consensus {} bp, identity to the draft {:.6f} "
                "({} edits by greedy walk)".format(
                    n_samples, n_columns, t_inference,
                    n_columns / t_inference, cons_len, identity, edits))
            if identity < 0.99:
                raise AssertionError("consensus identity {} < 0.99".format(
                    identity))
            main_rate = n_columns / t_inference

        with phase("main-path shapes: kernels vs plain, timings"):
            samples = []
            for region in prediction.plan_work(None, bam):
                samples.extend(features.SampleGenerator(
                    bam, region, bundle.feature_encoder, chunk_len=10000,
                    chunk_overlap=1000).samples)
            main_batch = prediction.Batch.collate(
                samples[:batch], batch, 10000)
            T, B, H, IN, C = 10000, batch, 256, 10, 5
            # yardsticks first, while the card's memory is free: cuDNN
            # bi-GRU layers in bf16 (the port never calls them), each over
            # the main batch or, where cuDNN runs out of the card's memory
            # there, over the largest half, quarter, ... of it that fits
            library = {
                "gru_l1_split": (IN, 1), "gru_l2head_split": (2 * H, 1),
                "network": (IN, 2)}
            library_ms, library_rows = {}, {}
            with torch.inference_mode():
                for name, (width, depth) in library.items():
                    rows_ = B
                    while True:
                        try:
                            library_ms[name] = yardstick_ms(
                                main_batch.features[:rows_], width, depth,
                                H, dev)
                            break
                        except torch.cuda.OutOfMemoryError as e:
                            torch.cuda.empty_cache()
                            log("   torch.nn.GRU({}, {}, {}, bidirectional="
                                "True) over {} rows: out of memory: {}"
                                .format(width, H, depth, rows_,
                                        str(e).splitlines()[0]))
                            if rows_ == 1:
                                raise
                            rows_ //= 2
                    library_rows[name] = rows_
                    log("   torch.nn.GRU({}, {}, {}, bidirectional=True) "
                        "bf16 (cuDNN) over {} rows: {:.2f} ms".format(
                            width, H, depth, rows_, library_ms[name]))
            xt = torch.from_numpy(main_batch.features).to(torch.bfloat16) \
                .transpose(0, 1).contiguous().to(dev)
            lens = torch.from_numpy(main_batch.lengths).to(dev)
            w = gru_split.prepare_split_weights(
                model.layer_params(), model.head_params(), "t", True, dev)
            main_plain_ms = {}
            l1_err, l2_err, stats, (kf, kb) = compare_kernels(
                gru_split, w, xt, lens, "t", True, main_plain_ms)
            log("   B={} T={}: l1 max {:.3g}, l2 logit max {:.3g}; probs "
                "max {:.3g} mean {:.3g}, argmax agreement {:.6f}".format(
                    B, T, l1_err, l2_err, stats["max"], stats["mean"],
                    stats["argmax_agreement"]))
            l1_args = (xt, lens, w["w_ih1"], w["b_ih1"], w["w_hh1"],
                       w["sc1"], w["b_hh1"])
            l2_args = (kf, kb, lens, w["w_in2"], w["in_scale2"], w["b_ih2"],
                       w["w_hh2"], w["sc2"], w["b_hh2"], w["w_head"])
            # the serial floor: the same kernels over one batch column
            one_x, one_len = xt[:, :1].contiguous(), lens[:1]
            f1, b1 = gru_split.gru_l1_split(one_x, one_len, *l1_args[2:],
                                            mode="t")
            calls = {
                "gru_l1_split": (
                    lambda: gru_split.gru_l1_split(*l1_args, mode="t"),
                    lambda: gru_split.gru_l1_split(
                        one_x, one_len, *l1_args[2:], mode="t"), l1_err),
                "gru_l2head_split": (
                    lambda: gru_split.gru_l2head_split(*l2_args, mode="t"),
                    lambda: gru_split.gru_l2head_split(
                        f1, b1, one_len, *l2_args[3:], mode="t"), l2_err),
            }
            lengths_sum = int(main_batch.lengths.sum())
            rows = []
            with torch.inference_mode():
                for name, (kernel, one, err) in calls.items():
                    ms = cuda_ms(kernel)
                    # the plain version's one run in compare_kernels
                    plain_ms = main_plain_ms[name]
                    bound_ms, bound_by = bound(name, B, H, IN, C,
                                               lengths_sum)
                    lib_desc = "torch.nn.GRU({}, {}, 1, bidirectional=True) " \
                        "bf16 (cuDNN) over {} rows".format(
                            library[name][0], H, library_rows[name])
                    rows.append({
                        "name": name, "route": "cuda",
                        "source": KERNEL_SOURCE,
                        "replaces": REPLACES[name],
                        "launches": launches[name],
                        "launches_by_mode": {
                            m: mode_launches[name + "/" + m]
                            for m in gru_split.MODES},
                        "max_abs_err": err, "ms": ms, "kernel_ms": ms,
                        "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        # one call computing the same function on the same
                        # inputs: cuDNN's layer 1 over the whole batch; no
                        # single PyTorch call computes layer 2 + the head
                        "library_ms": library_ms[name]
                        if name == "gru_l1_split" and
                        library_rows[name] == B else None,
                        "library": "{}: {:.2f} ms".format(
                            lib_desc, library_ms[name]),
                        "network_library_ms": library_ms["network"],
                        "network_library": "torch.nn.GRU({}, {}, 2, "
                                           "bidirectional=True) bf16 (cuDNN) "
                                           "over {} rows".format(
                                               IN, H,
                                               library_rows["network"]),
                        "serial_floor_ms": cuda_ms(one),
                        "shape": {"B": B, "T": T, "H": H,
                                  "valid_columns": lengths_sum},
                    })
                    log("   {}: {:.2f} ms (plain {:.1f} ms, bound {:.3f} ms "
                        "by {}, one column {:.2f} ms; {})".format(
                            name, ms, plain_ms, bound_ms, bound_by,
                            rows[-1]["serial_floor_ms"],
                            rows[-1]["library"]))
            log("   whole network yardstick: {} {:.2f} ms; kernels over {} "
                "rows {:.2f} ms".format(
                    rows[0]["network_library"], library_ms["network"], B,
                    rows[0]["ms"] + rows[1]["ms"]))

            # the diploid head's 15 classes on the same layer-1 outputs:
            # against its plain version, timed beside the 5-class launch
            # in turns (5, 15, 15, 5), with its geometry and bound
            scale = 1.0 / (2 * H) ** 0.5
            w_head15 = torch.from_numpy(rng.uniform(
                -scale, scale, (2, 15, H)).astype("float32")).to(
                    dev, torch.bfloat16)
            args15 = l2_args[:-1] + (w_head15,)
            main_valid = (torch.arange(T, device=dev)[None, :]
                          < lens[:, None].long())
            with torch.inference_mode():
                k15 = gru_split.gru_l2head_split(*args15, mode="t")
                p15 = gru_split.gru_l2head_split_plain(*args15, mode="t",
                                                       quant=True)
                err15 = max((a - b).abs()[main_valid].max().item()
                            for a, b in zip(k15, p15))
                del k15, p15
                five, fifteen = [], []
                for turn in (five, fifteen, fifteen, five):
                    turn.append(cuda_ms(
                        (lambda: gru_split.gru_l2head_split(
                            *l2_args, mode="t")) if turn is five else
                        (lambda: gru_split.gru_l2head_split(
                            *args15, mode="t"))))
            if err15 > TOL_LOGIT:
                raise AssertionError("gru_l2head_split at 15 classes "
                                     "disagrees with its plain version: max "
                                     "logit diff {}".format(err15))
            b15, by15 = bound("gru_l2head_split", B, H, IN, 15, lengths_sum)
            rows[1]["classes15"] = {
                "ms": sum(fifteen) / 2, "ms_classes5": sum(five) / 2,
                "ms_turns": {"classes5": five, "classes15": fifteen},
                "max_abs_err": err15, "bound_ms": b15, "bound_by": by15,
                "geometry": dict(zip(
                    ("cluster", "columns", "smem_bytes",
                     "resident_clusters"),
                    gru_split.geometry("l2", H, B, dev, "t", classes=15))),
                "shape": {"B": B, "T": T, "H": H, "classes": 15,
                          "valid_columns": lengths_sum}}
            log("   gru_l2head_split at 15 classes: {:.2f} ms beside {:.2f} "
                "ms at 5 (turns 5, 15, 15, 5: {}), logit max {:.3g}, bound "
                "{:.3f} ms by {}, geometry {}".format(
                    rows[1]["classes15"]["ms"],
                    rows[1]["classes15"]["ms_classes5"],
                    [round(v, 3) for v in five[:1] + fifteen + five[1:]],
                    err15, b15, by15,
                    json.dumps(rows[1]["classes15"]["geometry"])))

            # each int8 launch's geometry (cluster size, columns a cluster,
            # shared memory, resident clusters) and microseconds a step,
            # the same batch padded to 512 rows (where layer 2's clusters
            # need two waves on an H100), and a profile of one launch: the
            # cluster kernel and no per-block split kernel
            big = prediction.Batch.collate(samples[:512], 512, 10000)
            xt512 = torch.from_numpy(big.features).to(torch.bfloat16) \
                .transpose(0, 1).contiguous().to(dev)
            lens512 = torch.from_numpy(big.lengths).to(dev)
            with torch.inference_mode():
                f512, b512 = gru_split.gru_l1_split(xt512, lens512,
                                                    *l1_args[2:], mode="t")
                at512 = {
                    "gru_l1_split": lambda: gru_split.gru_l1_split(
                        xt512, lens512, *l1_args[2:], mode="t"),
                    "gru_l2head_split": lambda: gru_split.gru_l2head_split(
                        f512, b512, lens512, *l2_args[3:], mode="t")}
                for row in rows:
                    name = row["name"]
                    kind = "l1" if name == "gru_l1_split" else "l2"
                    row["geometry"] = {
                        key: dict(zip(
                            ("cluster", "columns", "smem_bytes",
                             "resident_clusters"),
                            gru_split.geometry(kind, H, cols, dev, m,
                                               IN if kind == "l1" else 0)))
                        for key, cols, m in (
                            ("main", B, "t"), ("B512", 512, "t"),
                            ("rows_B64", 64, "rows"), ("one_column", 1, "t"))}
                    row["step_us"] = row["ms"] / T * 1e3
                    row["serial_floor_step_us"] = \
                        row["serial_floor_ms"] / T * 1e3
                    row["b512_ms"] = cuda_ms(at512[name])
                    row["launch_profile_ms"] = split_launch_ms(
                        name, calls[name][0])
                    log("   {}: {:.3f} us a step (one column {:.3f}), {:.2f} "
                        "ms at B=512; geometry {}; profile of a launch {}"
                        .format(name, row["step_us"],
                                row["serial_floor_step_us"], row["b512_ms"],
                                json.dumps(row["geometry"]),
                                json.dumps(row["launch_profile_ms"])))
            del xt512, lens512, f512, b512, at512, big

            # the bf16 split kernels (quant=False: recurrent_quant="none"
            # on the split path) at the same shape in mode "t": their time,
            # serial floor (one column), bound and cuDNN's layer 1, each
            # launch's geometry and microseconds a step, a profile of one
            # launch (the bf16 cluster kernel, no per-block split kernel),
            # and their launches on one batch of that path through the
            # model
            wq = gru_split.prepare_split_weights(
                model.layer_params(), model.head_params(), "t", False, dev)
            q1 = (xt, lens, wq["w_ih1"], wq["b_ih1"], wq["w_hh1"],
                  wq["sc1"], wq["b_hh1"])
            with torch.inference_mode():
                qf, qb = gru_split.gru_l1_split(*q1, mode="t", quant=False)
                qf1, qb1 = gru_split.gru_l1_split(one_x, one_len, *q1[2:],
                                                  mode="t", quant=False)
                q2 = (qf, qb, lens, wq["w_in2"], wq["in_scale2"],
                      wq["b_ih2"], wq["w_hh2"], wq["sc2"], wq["b_hh2"],
                      wq["w_head"])
                q_calls = {
                    "gru_l1_split": (
                        lambda: gru_split.gru_l1_split(*q1, mode="t",
                                                       quant=False),
                        lambda: gru_split.gru_l1_split(
                            one_x, one_len, *q1[2:], mode="t",
                            quant=False)),
                    "gru_l2head_split": (
                        lambda: gru_split.gru_l2head_split(*q2, mode="t",
                                                           quant=False),
                        lambda: gru_split.gru_l2head_split(
                            qf1, qb1, one_len, *q2[3:], mode="t",
                            quant=False))}
                gru_split.reset_launches()
                model(torch.from_numpy(main_batch.features).to(dev),
                      lengths=lens, compute_dtype=torch.bfloat16,
                      recurrent_quant="none")
                torch.cuda.synchronize()
                none_launches = dict(gru_split.MODE_LAUNCHES)
                # each kernel against its plain version at this shape (layer
                # 2 on layer 1's kernel outputs), the plain version timed
                # once (CUDA events)
                q_check = {
                    "gru_l1_split": plain_agreement(
                        q_calls["gru_l1_split"][0],
                        lambda: gru_split.gru_l1_split_plain(
                            *q1, mode="t", quant=False)),
                    "gru_l2head_split": plain_agreement(
                        q_calls["gru_l2head_split"][0],
                        lambda: gru_split.gru_l2head_split_plain(
                            *q2, mode="t", quant=False), main_valid)}
                # layer 1: f64 sums, its plain version's bits
                for name, rec in q_check.items():
                    most = 0.0 if name == "gru_l1_split" else TOL_LOGIT
                    if rec["max_abs_err"] > most:
                        raise AssertionError(
                            "{} quant=False disagrees with its plain version "
                            "at B={}, T={}: {}".format(name, B, T, rec))
                for row in rows:
                    name = row["name"]
                    kernel, one = q_calls[name]
                    bound_ms, bound_by = bound(name, B, H, IN, C,
                                               lengths_sum, quant=False)
                    bf16_bound_ms, _ = bound(name, B, H, IN, C, lengths_sum,
                                             quant=False, f64=False)
                    kind = "l1" if name == "gru_l1_split" else "l2"
                    ms_q, floor_q = cuda_ms(kernel), cuda_ms(one)
                    row["quant_false"] = {
                        "kernel": SPLIT_BF16_KERNEL_OF[name],
                        "ms": ms_q,
                        "serial_floor_ms": floor_q,
                        "step_us": ms_q / T * 1e3,
                        "serial_floor_step_us": floor_q / T * 1e3,
                        "geometry": {
                            key: dict(zip(
                                ("cluster", "columns", "smem_bytes",
                                 "resident_clusters"),
                                gru_split.geometry(
                                    kind, H, cols, dev, "t",
                                    IN if kind == "l1" else 0,
                                    quant=False)))
                            for key, cols in (("main", B),
                                              ("one_column", 1))},
                        "launch_profile_ms": split_launch_ms(
                            name, kernel, quant=False),
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "bf16_bound_ms": bf16_bound_ms,
                        "library_ms": row["library_ms"]
                        if name == "gru_l1_split" else None,
                        "launches": none_launches[name + "/t"],
                        "launches_on": "GRUModel.forward(recurrent_quant="
                                       "'none') on the batch of {} rows"
                                       .format(B)}
                    row["quant_false"].update(q_check[name])
                    log("   {} quant=False: {}".format(
                        name, json.dumps(row["quant_false"])))
            if any(row["quant_false"]["launches"] < 1 for row in rows):
                raise AssertionError("recurrent_quant='none' did not launch "
                                     "both split kernels: {}".format(
                                         none_launches))
            del wq, q1, q2, qf, qb, qf1, qb1, q_calls
            # the bf16 kernels in mode "rows" (batches below 192) on the
            # batch's first 32 and 64 rows: against their plain versions
            # (compare_kernels: layer 1 bit for bit) and timed
            with torch.inference_mode():
                for RB in (32, 64):
                    xr = xt[:, :RB].contiguous()
                    lr = lens[:RB].contiguous()
                    wr = gru_split.prepare_split_weights(
                        model.layer_params(), model.head_params(), "rows",
                        False, dev)
                    plain_r = {}
                    l1_r, l2_r, stats_r, (rf, rb) = compare_kernels(
                        gru_split, wr, xr, lr, "rows", False, plain_r)
                    r1 = (xr, lr, wr["w_ih1"], wr["b_ih1"], wr["w_hh1"],
                          wr["sc1"], wr["b_hh1"])
                    r2 = (rf, rb, lr, wr["w_in2"], wr["in_scale2"],
                          wr["b_ih2"], wr["w_hh2"], wr["sc2"], wr["b_hh2"],
                          wr["w_head"])
                    r_sum = int(lr.sum())
                    for row, fn, args, err in (
                            (rows[0], gru_split.gru_l1_split, r1, l1_r),
                            (rows[1], gru_split.gru_l2head_split, r2, l2_r)):
                        name = row["name"]
                        kind = "l1" if name == "gru_l1_split" else "l2"
                        rec = {
                            "B": RB, "ms": cuda_ms(lambda: fn(
                                *args, mode="rows", quant=False)),
                            "plain_ms": plain_r[name], "max_abs_err": err,
                            "model_vs_plain": stats_r,
                            "bound_ms": bound(name, RB, H, IN, C, r_sum,
                                              quant=False)[0],
                            "geometry": dict(zip(
                                ("cluster", "columns", "smem_bytes",
                                 "resident_clusters"),
                                gru_split.geometry(
                                    kind, H, RB, dev, "rows",
                                    IN if kind == "l1" else 0,
                                    quant=False)))}
                        rec["step_us"] = rec["ms"] / T * 1e3
                        row["quant_false"].setdefault(
                            "rows_mode", {})["B{}".format(RB)] = rec
                        log("   {} quant=False mode rows: {}".format(
                            name, json.dumps(rec)))
                    del xr, lr, wr, rf, rb, r1, r2
            rows[1]["quant_false"]["per_block"] = wide_bf16_layer2(
                gru_split, dev, seed)

            # mode "rows" (TPU kernels #3 and #4) is what batches below 192
            # run; the main path does not reach it, so it is held against
            # its plain version and timed on the batch's first 64 rows
            RB = 64
            xr, lr = xt[:, :RB].contiguous(), lens[:RB].contiguous()
            wr = gru_split.prepare_split_weights(
                model.layer_params(), model.head_params(), "rows", True, dev)
            rows_plain_ms = {}
            r1_err, r2_err, rstats, (rf, rb) = compare_kernels(
                gru_split, wr, xr, lr, "rows", True, rows_plain_ms)
            log("   mode rows, B={} T={}: l1 max {:.3g}, l2 logit max "
                "{:.3g}; probs max {:.3g}, argmax agreement {:.6f}".format(
                    RB, T, r1_err, r2_err, rstats["max"],
                    rstats["argmax_agreement"]))
            r_sum = int(main_batch.lengths[:RB].sum())
            r_args = (
                (xr, lr, wr["w_ih1"], wr["b_ih1"], wr["w_hh1"], wr["sc1"],
                 wr["b_hh1"]),
                (rf, rb, lr, wr["w_in2"], wr["in_scale2"], wr["b_ih2"],
                 wr["w_hh2"], wr["sc2"], wr["b_hh2"], wr["w_head"]))
            kernels = ((gru_split.gru_l1_split, r1_err, IN),
                       (gru_split.gru_l2head_split, r2_err, 2 * H))
            # the serial floor of mode "rows": one batch column
            rf1, rb1 = gru_split.gru_l1_split(one_x, one_len, *r_args[0][2:],
                                              mode="rows")
            r_one = ((one_x, one_len) + r_args[0][2:],
                     (rf1, rb1, one_len) + r_args[1][3:])
            with torch.inference_mode():
                for row, call_args, one_args, (fn, err, width) in \
                        zip(rows, r_args, r_one, kernels):
                    lib_ms = yardstick_ms(main_batch.features[:RB], width,
                                          1, H, dev)
                    bound_ms, bound_by = bound(row["name"], RB, H, IN, C,
                                               r_sum)
                    row["rows_mode"] = {
                        "B": RB, "valid_columns": r_sum,
                        "launches": mode_launches[row["name"] + "/rows"],
                        "max_abs_err": err,
                        "ms": cuda_ms(lambda: fn(*call_args, mode="rows")),
                        "plain_ms": rows_plain_ms[row["name"]],
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "serial_floor_ms": cuda_ms(
                            lambda: fn(*one_args, mode="rows")),
                        "library": "torch.nn.GRU({}, {}, 1, bidirectional="
                                   "True) bf16 (cuDNN) over {} rows: {:.2f} "
                                   "ms".format(width, H, RB, lib_ms)}
                    row["rows_mode"]["step_us"] = \
                        row["rows_mode"]["ms"] / T * 1e3
                    log("   {} mode rows: {}".format(
                        row["name"], json.dumps(row["rows_mode"])))
                # mode "rows" with the diploid head's 15 classes: against
                # its plain version, timed beside the 5-class launch in
                # turns (5, 15, 15, 5), with its bound
                r_args15 = r_args[1][:-1] + (w_head15,)
                r_valid = (torch.arange(T, device=dev)[None, :]
                           < lr[:, None].long())
                k15 = gru_split.gru_l2head_split(*r_args15, mode="rows")
                p15 = gru_split.gru_l2head_split_plain(
                    *r_args15, mode="rows", quant=True)
                r_err15 = max((a - b).abs()[r_valid].max().item()
                              for a, b in zip(k15, p15))
                del k15, p15
                if r_err15 > TOL_LOGIT:
                    raise AssertionError(
                        "gru_l2head_split mode rows at 15 classes disagrees "
                        "with its plain version: max logit diff {}".format(
                            r_err15))
                five, fifteen = [], []
                for turn in (five, fifteen, fifteen, five):
                    turn.append(cuda_ms(
                        (lambda: gru_split.gru_l2head_split(
                            *r_args[1], mode="rows")) if turn is five else
                        (lambda: gru_split.gru_l2head_split(
                            *r_args15, mode="rows"))))
                rb15, rby15 = bound("gru_l2head_split", RB, H, IN, 15, r_sum)
                rows[1]["rows_mode"]["classes15"] = {
                    "ms": sum(fifteen) / 2, "ms_classes5": sum(five) / 2,
                    "ms_turns": {"classes5": five, "classes15": fifteen},
                    "max_abs_err": r_err15, "bound_ms": rb15,
                    "bound_by": rby15}
                log("   gru_l2head_split mode rows at 15 classes: {}".format(
                    json.dumps(rows[1]["rows_mode"]["classes15"])))

        torch.cuda.empty_cache()
        variant_paths = variant_phases(seed, work, dev, modules={
            "cli": cli, "datastore": datastore, "gru_split": gru_split,
            "models": models, "prediction": prediction})
        for row in rows:
            row["launches_by_path"] = {
                "consensus": launches[row["name"]],
                **{path: rec["launches"][row["name"]]
                   for path, rec in variant_paths.items()}}
        rows[1]["classes15"]["launches"] = \
            variant_paths["diploid_snp"]["launches"]["gru_l2head_split"]
        # phase 34: the tools on the card's outputs
        tools = tools_phases(seed, work, bam, draft, hdf, fasta,
                             variant_paths, dev, modules={
                                 "cli": cli, "datastore": datastore,
                                 "features": features,
                                 "gru_split": gru_split, "models": models,
                                 "prediction": prediction,
                                 "testing": testing, "vcf": vcf})
        for row in rows:
            if row["name"] in SPLIT_KERNEL_OF:
                row["launches_by_path"]["tools"] = tools["model_selection"][
                    "launches"][row["name"]]
        rows[1]["classes15"]["head_checks"] = head_agreement
        rows[1]["variant_paths"] = {
            path: {k: v for k, v in rec.items() if k != "decodes"}
            | {"scores": {label: d["score"]
                          for label, d in rec["decodes"].items()}}
            for path, rec in variant_paths.items()}

        torch.cuda.empty_cache()
        rl_bundle = models.load_model(RL_MODEL)
        max_reads = rl_bundle.feature_encoder.max_reads
        rl_batch = prediction.auto_batch_size(
            rl_bundle.model, dev, chunk_len=1000, max_reads=max_reads)
        log("   read-level automatic batch {}".format(rl_batch))
        rl_hdf = os.path.join(work, "rl_probs.hdf")
        rl_fasta = os.path.join(work, "rl_consensus.fasta")
        with phase("read-level main path: inference + sequence"):
            bilstm.reset_launches()
            t0 = time.perf_counter()
            if cli.main(["inference", bam, rl_hdf, "--model", RL_MODEL,
                         "--chunk_len", "1000", "--chunk_ovlp", "100"]) != 0:
                raise AssertionError("read-level inference failed")
            torch.cuda.synchronize()
            t_rl = time.perf_counter() - t0
            rl_launches = bilstm.LAUNCHES["bilstm_fused"]
            if cli.main(["sequence", rl_hdf, draft, rl_fasta]) != 0:
                raise AssertionError("read-level sequence failed")
        log("   launches on the read-level path:", dict(bilstm.LAUNCHES))

        with phase("check the read-level output"):
            rl_samples, rl_columns = check_probabilities(datastore, rl_hdf)
            n_batches = math.ceil(rl_samples / rl_batch)
            if rl_launches != 2 * n_batches:
                raise AssertionError(
                    "bilstm_fused launched {} times for {} batches (2 "
                    "layers each)".format(rl_launches, n_batches))
            rl_identity, rl_edits, rl_len = consensus_identity(
                testing, rl_fasta, draft)
            log("   {} samples, {} columns in {:.2f} s of inference: {:.0f} "
                "columns/s; consensus {} bp, identity to the draft {:.6f} "
                "({} edits by greedy walk)".format(
                    rl_samples, rl_columns, t_rl, rl_columns / t_rl, rl_len,
                    rl_identity, rl_edits))
            if rl_identity < 0.99:
                raise AssertionError("read-level consensus identity {} < "
                                     "0.99".format(rl_identity))

        with phase("read-level batch: kernel vs plain, stages, timings"):
            region = prediction.plan_work(None, bam)[0]
            samples = features.SampleGenerator(
                bam, region, rl_bundle.feature_encoder, chunk_len=1000,
                chunk_overlap=100).samples[:rl_batch]
            rl_main = prediction.Batch.collate(samples, rl_batch, 1000,
                                               max_reads)
            x = torch.from_numpy(rl_main.features).to(dev)
            lens = torch.from_numpy(rl_main.lengths).to(dev)
            B, T, R = x.shape[0], x.shape[1], x.shape[2]
            H = rl_bundle.model.lstm_size
            model = rl_bundle.model.to(dev).eval()
            valid = (torch.arange(T, device=dev)[None, :]
                     < lens[:, None].long())
            with torch.inference_mode():
                direct = model(x, lengths=lens, normalise=False,
                               compute_dtype=torch.bfloat16)
                staged = read_level_stages(model, bilstm, x, lens)
                plain = read_level_stages(model, bilstm, x, lens, plain=True)
            if not torch.equal(direct, staged):
                raise AssertionError("the staged forward differs from the "
                                     "model's")
            pk, pp = torch.softmax(staged, -1)[valid], \
                torch.softmax(plain, -1)[valid]
            diff = (pk - pp).abs()
            rl_stats = {"max": diff.max().item(), "mean": diff.mean().item(),
                        "argmax_agreement": (pk.argmax(-1) == pp.argmax(-1))
                        .float().mean().item()}
            log("   B={} T={} R={}: model through the kernel vs through its "
                "plain version: probs max {:.3g} mean {:.3g}, argmax "
                "agreement {:.6f}".format(B, T, R, rl_stats["max"],
                                          rl_stats["mean"],
                                          rl_stats["argmax_agreement"]))
            if rl_stats["max"] > TOL_PROB or \
                    rl_stats["argmax_agreement"] < MIN_ARGMAX_AGREEMENT:
                raise AssertionError("read-level kernel path disagrees with "
                                     "the plain path: {}".format(rl_stats))

            # stage breakdown of one batch (after the warm-up above)
            events = []
            with torch.inference_mode():
                read_level_stages(model, bilstm, x, lens, events=events)
            torch.cuda.synchronize()
            stages = {}
            for name, start, stop in events:
                stages[name] = stages.get(name, 0.0) + start.elapsed_time(stop)
            log("   stage breakdown (ms): " + json.dumps(stages))

            # the kernel at the main path's shape: layer 1's inputs
            with torch.inference_mode():
                feats, non_empty = model.read_features(x, torch.bfloat16)
                pooled = model.pool(feats, non_empty, torch.bfloat16)
                del feats
                layer = model.layer_params()[0]
                fwd, bwd = layer["fwd"], layer["bwd"]
                pooled_t = pooled.transpose(0, 1)
                xp_f = bilstm.project(pooled_t, fwd["w_ih"], fwd["b_ih"])
                xp_b = bilstm.project(pooled_t, bwd["w_ih"], bwd["b_ih"])
                largs = (xp_f, xp_b, torch.stack([fwd["w_hh"], bwd["w_hh"]]),
                         torch.stack([fwd["b_hh"], bwd["b_hh"]]), lens)
                err, mean = compare_bilstm(bilstm, largs)
                one = (xp_f[:, :1].contiguous(), xp_b[:, :1].contiguous(),
                       largs[2], largs[3], lens[:1])
                lstm_ms = cuda_ms(lambda: bilstm.bilstm_fused(*largs))
                lstm_plain_ms = cuda_ms(
                    lambda: bilstm.bilstm_fused_plain(*largs), reps=1,
                    warmup=0)
                floor_ms = cuda_ms(lambda: bilstm.bilstm_fused(*one))
                # yardstick (the port never calls it): cuDNN's bi-LSTM
                # over the same rows, its input projection included
                lstm = torch.nn.LSTM(H, H, 1, batch_first=True,
                                     bidirectional=True).to(dev,
                                                            torch.bfloat16)
                lstm.flatten_parameters()
                lib_ms = cuda_ms(lambda: lstm(pooled))
                del lstm
                # the launch geometry, and a profile of one launch: the
                # LSTM cluster forward and no per-block bilstm_kernel
                lstm_geometry = {
                    key: dict(zip(("cluster", "columns", "smem_bytes",
                                   "resident_clusters"),
                                  bilstm.geometry(H, cols, dev)))
                    for key, cols in (("main", B), ("one_column", 1))}
                lstm_profile = cluster_launch_ms(
                    "bilstm_fused", lambda: bilstm.bilstm_fused(*largs),
                    PROFILE_KERNELS["bilstm_fused"][0],
                    PROFILE_KERNELS["bilstm_fused"],
                    child=lambda: child_profile("bilstm", T, B, 0, H))
            lstm_sum = int(rl_main.lengths.sum())
            bound_ms, bound_by = bilstm_bound(B, H, lstm_sum)
            rows.append({
                "name": "bilstm_fused", "route": "cuda",
                "source": BILSTM_SOURCE, "replaces": REPLACES["bilstm_fused"],
                "launches": rl_launches, "max_abs_err": err,
                "mean_abs_err": mean, "ms": lstm_ms, "kernel_ms": lstm_ms,
                "plain_ms": lstm_plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib_ms,
                "library": "torch.nn.LSTM({0}, {0}, 1, bidirectional=True) "
                           "bf16 (cuDNN) over the same {1} rows, its input "
                           "projection included: {2:.2f} ms".format(
                               H, B, lib_ms),
                "serial_floor_ms": floor_ms,
                "shape": {"B": B, "T": T, "H": H, "reads": R,
                          "valid_columns": lstm_sum},
                "model_vs_plain": rl_stats, "stages_ms": stages,
                "read_level_columns_per_s": rl_columns / t_rl,
                "geometry": lstm_geometry, "launch_profile_ms": lstm_profile,
                "step_us": lstm_ms / T * 1e3,
                "serial_floor_step_us": floor_ms / T * 1e3,
            })
            log("   bilstm_fused: {:.3f} ms per layer (plain {:.1f} ms, "
                "bound {:.4f} ms by {}, one column {:.3f} ms; {})".format(
                    lstm_ms, lstm_plain_ms, bound_ms, bound_by, floor_ms,
                    rows[-1]["library"]))

        del model, x, pooled, pooled_t, xp_f, xp_b, largs, one
        torch.cuda.empty_cache()
        rows.extend(small_batch_phases(
            work, bam, draft, fasta, dev, ff_agreement, modules={
                "cli": cli, "datastore": datastore, "features": features,
                "gru_fullfused": gru_fullfused, "gru_split": gru_split,
                "models": models, "prediction": prediction}))
        rows.extend(training_phases(
            seed, work, bam, draft, dev, rng, train_agreement, modules={
                "cli": cli, "datastore": datastore, "gru_train": gru_train,
                "parallel": parallel, "training": training}))
        torch.cuda.empty_cache()
        rl_rows, rl_paths = read_level_training_phases(
            seed, work, dev, rng, lstm_agreement, modules={
                "cli": cli, "datastore": datastore, "lstm_train": lstm_train,
                "models": models, "parallel": parallel,
                "training": training})
        rows.extend(rl_rows)
        # phases 25-28: the training options and the reference's formats
        torch.cuda.empty_cache()
        rows.extend(options_and_formats_phases(
            seed, work, bam, draft, hdf, fasta, rl_paths, dev, rng, ptxas,
            modules={"bilstm": bilstm, "cli": cli, "datastore": datastore,
                     "features": features, "gru_fullfused": gru_fullfused,
                     "gru_split": gru_split,
                     "gru_train": gru_train, "models": models,
                     "prediction": prediction, "testing": testing}))
        # phases 23 and 22 (the run-length path and its kernels) and 24
        # (the host pipeline options), before phase 21
        torch.cuda.empty_cache()
        rle_rows, rle_path = rle_phases(work, bam, draft, dev, rows, modules={
            "cli": cli, "datastore": datastore, "features": features,
            "gru_fullfused": gru_fullfused, "gru_split": gru_split,
            "models": models, "prediction": prediction})
        rows.extend(rle_rows)
        torch.cuda.empty_cache()
        host_options = host_option_phases(
            work, bam, draft, hdf, fasta, main_rate, dev, modules={
                "cli": cli, "datastore": datastore, "gru_split": gru_split})
        # phases 29-31: scale-out on one card
        torch.cuda.empty_cache()
        scale_launches, scale_out = scale_out_phases(
            seed, work, bam, draft, hdf, fasta, main_rate,
            rl_paths["features"], dev, modules={
                "bilstm": bilstm, "cli": cli, "datastore": datastore,
                "features": features, "gru_fullfused": gru_fullfused,
                "gru_split": gru_split, "models": models,
                "prediction": prediction, "testing": testing,
                "training": training})
        # phases 32-33: the smolecule and tandem workflows
        torch.cuda.empty_cache()
        workflows = workflow_phases(seed, work, dev, modules={
            "cli": cli, "features": features, "gru_split": gru_split,
            "models": models, "native": native, "prediction": prediction,
            "smolecule": smolecule, "testing": testing})
        # phase 21 runs last: no profile follows it (a trace of the
        # read-level batch came back empty five times after it in one run)
        torch.cuda.empty_cache()
        from_reads = from_reads_phases(
            seed, work, bam, draft, dev, modules={"cli": cli, "datastore": datastore,
                     "features": features, "gru_split": gru_split,
                     "mapping": mapping, "models": models,
                     "prediction": prediction, "stitch": stitch,
                     "testing": testing, "vcf": vcf})
        split_rows = [row for row in rows if row["name"] in SPLIT_KERNEL_OF]
        for row in split_rows:
            row["launches_by_path"].update({
                "from_reads/" + path: rec["launches"][row["name"]]
                for path, rec in from_reads.items()})
            row["launches_by_path"].update({
                "sharded": host_options["launches"][row["name"]],
                "consensus_from_features": host_options[
                    "consensus_from_features"]["launches"][row["name"]],
                "rle": rle_path["launches"][row["name"]],
                "smolecule": workflows["smolecule"]["launches_by_mode"][
                    row["name"] + "/rows"]})
            row["smolecule_rows_B32"] = workflows["smolecule"]["kernels"][
                row["name"]]
        split_rows[1]["from_reads_paths"] = from_reads
        split_rows[1]["workflows"] = workflows
        split_rows[1]["tools"] = tools
        split_rows[1]["host_options"] = host_options
        split_rows[0]["scale_out"] = scale_out
        for row in rows:
            if row["name"] in scale_launches:
                row.setdefault("launches_by_path", {}).update(
                    scale_launches[row["name"]])
    finally:
        import shutil
        shutil.rmtree(work, ignore_errors=True)

    row_ptxas = {
        "lstm_fwd": ("lstm_train.cu", ("lstm_fwd_kernel",)),
        "lstm_bwd": ("lstm_train.cu", ("lstm_bwd_kernel", "rnn_dw_kernel")),
        "gru_fwd": ("gru_train.cu", ("gru_cluster_fwd_kernel",)),
        "gru_bwd": ("gru_train.cu", ("gru_cluster_bwd_kernel",
                                     "rnn_dw_kernel")),
        "bigru_fullfused/f32_gates": ("gru_fullfused.cu", (
            FWD_PTXAS["f32_gates"], "bigru_proj_mma_kernel")),
        "bigru_fullfused_int8": ("gru_fullfused.cu", (
            FWD_PTXAS["int8"], "bigru_proj_mma_kernel")),
        "bigru_fullfused/bf16_gates": ("gru_fullfused.cu", (
            FWD_PTXAS["bf16_gates"], "bigru_proj_kernel")),
        "bigru_project": ("gru_fullfused.cu", ("bigru_proj_mma_kernel",)),
        "bigru_fused": ("gru_fullfused.cu", (FWD_PTXAS["f32_gates"],)),
        "bilstm_fused": ("bilstm.cu", ("lstm_fwd_kernel",)),
        "gru_l1_split": ("gru_split.cu", (
            SPLIT_KERNEL_OF["gru_l1_split"],
            SPLIT_BF16_KERNEL_OF["gru_l1_split"])),
        "gru_l2head_split": ("gru_split.cu", (
            SPLIT_KERNEL_OF["gru_l2head_split"],
            SPLIT_BF16_KERNEL_OF["gru_l2head_split"])),
        "gru_l1_split/in120": ("gru_split.cu", (
            SPLIT_KERNEL_OF["gru_l1_split"],
            SPLIT_BF16_KERNEL_OF["gru_l1_split"])),
        "gru_l2head_split/classes49": ("gru_split.cu", (
            SPLIT_KERNEL_OF["gru_l2head_split"],
            SPLIT_BF16_KERNEL_OF["gru_l2head_split"]))}
    for row in rows:
        if row["name"] in row_ptxas:
            source, kernels = row_ptxas[row["name"]]
            row["ptxas"] = {k: ptxas[source][k] for k in kernels}
        if row["name"] in small_width:
            row["small_width"] = small_width[row["name"]]
    log("card:", card_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Self-contained genomics IO: BGZF, BAM (+BAI), FASTA/FASTQ, HDF5.

Counterpart of ``medaka_tpu/io``; :mod:`.hdf5` replaces h5py.

This subsystem replaces the reference's htslib/pysam dependency
(reference: ``src/medaka_bamiter.c``, pysam usage throughout) with a
pure-spec implementation (SAM format spec v1.6). A native C++ fast path
lives in ``medaka_tpu_torch/native`` and is used automatically when built.
"""

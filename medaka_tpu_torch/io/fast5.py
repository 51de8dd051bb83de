"""Minimal fast5 reading for run-length (Weibull) parameters.

Counterpart of ``medaka_tpu/io/fast5.py`` on the port's own HDF5 reader
(:mod:`medaka_tpu_torch.io.hdf5`; no h5py). Fast5 files are HDF5; the
access patterns are those of the reference's ``rle.py``
(``get_rl_params``, ``rle.py:78-91``, and the ``rlebam`` worker,
``rle.py:296-337``): locate a read's latest ``Basecall_1D`` analysis
group and read the ``BaseCalled_template/RunlengthBasecall`` table of
``(base, shape, scale)`` records, a chunked (often gzip- and
shuffle-filtered) compound dataset.

Both multi-read files (top-level ``read_<id>`` groups) and single-read
files (``Analyses`` at the file root) are read.
"""
from __future__ import annotations

import glob as _glob
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np

from medaka_tpu_torch.io import hdf5

_ANALYSES = "Analyses"
_RLB_PATH = "BaseCalled_template/RunlengthBasecall"


def _read_group(h5: hdf5.File, read_id: str):
    """The group holding a read's analyses."""
    key = "read_" + read_id
    if key in h5:
        return h5[key]
    if _ANALYSES in h5:
        # single-read file layout: the analyses live at the root
        return h5
    raise KeyError(
        "Read {} not present in fast5 {}".format(read_id, h5.filename))


def latest_analysis(group, base: str = "Basecall_1D") -> str:
    """Name of the highest-numbered ``<base>_NNN`` analysis group
    (``ont_fast5_api``'s ``get_latest_analysis``, as the reference's
    ``rle.py:318-319`` uses it)."""
    pattern = re.compile(re.escape(base) + r"_(\d+)$")
    best, best_n = None, -1
    for name in group[_ANALYSES]:
        match = pattern.match(name)
        if match and int(match.group(1)) > best_n:
            best, best_n = name, int(match.group(1))
    if best is None:
        raise KeyError(
            "No {} analysis group in fast5 read group".format(base))
    return best


def get_runlength_basecall(
        fname: str, read_id: str, analysis: Optional[str] = None,
) -> Tuple[str, np.ndarray, np.ndarray]:
    """Read a run-length basecall table from a fast5 file.

    :param analysis: ``Basecall_1D`` group name; None picks the
        highest-numbered one (the reference's rlebam behaviour).
    :returns: ``(basecall, shape, scale)``: the compact (RLE) basecall
        string and the per-base Weibull shape and scale, float32.
    """
    with hdf5.File(fname, "r") as h5:
        group = _read_group(h5, read_id)
        if analysis is None:
            analysis = latest_analysis(group)
        data = group[_ANALYSES][analysis][_RLB_PATH][()]
    call = b"".join(data["base"]).decode()
    shape = np.asarray(data["shape"], dtype=np.float32)
    scale = np.asarray(data["scale"], dtype=np.float32)
    return call, shape, scale


def read_summary_index(summary_fname: str) -> Dict[str, str]:
    """Map read_id -> fast5 filename from a sequencing summary TSV with
    ``read_id`` and ``filename`` columns (reference ``rle.py:198-214``)."""
    index = {}
    with open(summary_fname) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        try:
            id_col = header.index("read_id")
            fn_col = header.index("filename")
        except ValueError:
            raise ValueError(
                "Summary file {} needs 'read_id' and 'filename' "
                "columns; found {}".format(summary_fname, header))
        for line in fh:
            fields = line.rstrip("\n").split("\t")
            if len(fields) > max(id_col, fn_col):
                index[fields[id_col]] = fields[fn_col]
    return index


class Fast5Index:
    """Resolve read ids to fast5 paths and read their run-length tables.

    The reference globs for each alignment's file by name
    (``rle.py:135-149``); here each distinct file name is globbed once.
    """

    def __init__(self, fast5_dir: str, summary_fname: str):
        """Build from a fast5 root directory and a summary TSV."""
        self.fast5_dir = fast5_dir
        self.file_index = read_summary_index(summary_fname)
        self._paths: Dict[str, str] = {}

    def __contains__(self, read_id: str) -> bool:
        return read_id in self.file_index

    def path_for(self, read_id: str) -> str:
        """Full path of the fast5 file holding ``read_id``."""
        fname = self.file_index[read_id]
        if fname not in self._paths:
            if os.path.isabs(fname) and os.path.exists(fname):
                hits = [fname]
            else:
                # recursive, following symlinks as the reference does
                # (rle.py:137-139)
                hits = _glob.glob(os.path.join(self.fast5_dir, "**", fname),
                                  recursive=True)
            if len(hits) != 1:
                raise FileNotFoundError(
                    "Found {} fast5 files named {} under {}".format(
                        len(hits), fname, self.fast5_dir))
            self._paths[fname] = hits[0]
        return self._paths[fname]

    def get_rl_params(
            self, read_id: str) -> Tuple[str, np.ndarray, np.ndarray]:
        """``(basecall, shape, scale)`` of a read, from its
        ``Basecall_1D_000`` analysis as the reference's ``compress_bam``
        path reads it (``rle.py:78-91``; only the rlebam worker takes the
        latest analysis)."""
        return get_runlength_basecall(
            self.path_for(read_id), read_id, analysis="Basecall_1D_000")

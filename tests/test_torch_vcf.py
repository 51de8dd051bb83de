"""The port's ``vcf`` module against ``medaka_tpu.vcf`` on the same records.

Seeded random records (shared prefixes and suffixes, several alts,
phased and unphased genotypes, no-calls, flags and lists in INFO) go
through both packages' ``Variant`` methods, ``VCFWriter`` and
``VCFReader``: the same fields, the same bytes, the same records.
"""
import numpy as np
import pytest

from medaka_tpu import vcf as jax_vcf
from medaka_tpu_torch import vcf

BASES = "ACGT"


def _seq(rng, n):
    return "".join(rng.choice(list(BASES), size=n))


def _records(seed, n=60, contigs=("chr1", "chr2", "chr10")):
    """(reference sequences, record argument tuples) from a seed."""
    rng = np.random.default_rng(seed)
    refs = {c: _seq(rng, 400) for c in contigs}
    out = []
    for _ in range(n):
        chrom = str(rng.choice(list(contigs)))
        ref_seq = refs[chrom]
        pos = int(rng.integers(0, 380))
        k = int(rng.integers(1, 6))
        ref = ref_seq[pos:pos + k]
        alts = []
        for _ in range(int(rng.integers(1, 3))):
            kind = rng.integers(0, 4)
            if kind == 0:      # substitution inside shared flanks
                alt = ref[0] + _seq(rng, max(0, k - 2)) + ref[-1] \
                    if k > 1 else _seq(rng, 1)
            elif kind == 1:    # insertion after a shared prefix
                alt = ref + _seq(rng, int(rng.integers(1, 4)))
            elif kind == 2:    # deletion keeping the first base
                alt = ref[:1]
            else:              # a repeat-shifting insertion
                alt = ref + ref
            alts.append(alt)
        gt = str(rng.choice(["0/1", "1/1", "1|0", "1/2", "0", "1", "./."]))
        if gt in ("1/2",) and len(alts) < 2:
            gt = "1/1"
        info = {"DP": int(rng.integers(1, 60)),
                "ref_seq": ref, "pred_q": "%.3f" % rng.random()}
        if rng.random() < 0.3:
            info["DB"] = True
        if rng.random() < 0.3:
            info["AF"] = [round(float(x), 3) for x in rng.random(len(alts))]
        qual = "." if rng.random() < 0.2 else "%.3f" % (100 * rng.random())
        gd = {"GT": gt, "GQ": str(int(rng.integers(0, 70)))}
        filt = str(rng.choice(["PASS", ".", "lowq;depth"]))
        out.append(((chrom, pos, ref),
                    dict(alt=alts, qual=qual, filt=filt, info=info,
                         genotype_data=gd, ident=".")))
    return refs, out


def _fields(v):
    return (v.chrom, v.pos, v.ident, v.ref, list(v.alt), v.qual, v.filt,
            dict(v.info), dict(v.genotype_data))


def _pair(args, kwargs):
    return (vcf.Variant(*args, **{k: _copy(x) for k, x in kwargs.items()}),
            jax_vcf.Variant(*args, **{k: _copy(x)
                                      for k, x in kwargs.items()}))


def _copy(x):
    if isinstance(x, dict):
        return {k: list(v) if isinstance(v, list) else v
                for k, v in x.items()}
    return list(x) if isinstance(x, list) else x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_variant_methods_match(seed):
    refs, recs = _records(seed)
    for args, kwargs in recs:
        got, want = _pair(args, kwargs)
        assert _fields(got) == _fields(want)
        assert repr(got) == repr(want)
        assert (got.gt, got.phased, got.alleles) == \
            (want.gt, want.phased, want.alleles)
        assert (got.info_string, got.genotype_keys, got.genotype_values) \
            == (want.info_string, want.genotype_keys, want.genotype_values)
        assert got.to_dict() == want.to_dict()
        ref_seq = refs[got.chrom]
        assert _fields(got.trim()) == _fields(want.trim())
        assert _fields(got.trim(ref_seq)) == _fields(want.trim(ref_seq))
        assert _fields(got.normalize(ref_seq)) == \
            _fields(want.normalize(ref_seq))
        copy = got.deep_copy()
        assert _fields(copy) == _fields(got) and copy is not got
        if got.gt is not None:
            halves = got.split_haplotypes()
            assert [(n, v and _fields(v)) for n, v in halves] == \
                [(n, v and _fields(v)) for n, v in want.split_haplotypes()]
        line = vcf.VCFWriter._format_row(got)
        assert line == jax_vcf.VCFWriter._format_row(want)
        assert _fields(vcf.Variant.from_text(line)) == \
            _fields(jax_vcf.Variant.from_text(line))


@pytest.mark.parametrize("text", [
    ".", "DP=5", "DB;DP=7", "AF=0.1,0.2;SCORES=1.5,2.5;X=a,b",
    "AC=x", "ref_seq=AC;pred_q=3.000;n_cols=2"])
def test_info_parsing_matches(text):
    got = vcf.parse_string_to_tags(text)
    assert got == jax_vcf.parse_string_to_tags(text)
    assert vcf.parse_tags_to_string(got) == \
        jax_vcf.parse_tags_to_string(got)


def test_meta_info_matches():
    for args in (("INFO", "DP", 1, "Integer", "Depth"),
                 ("FORMAT", "GT", 1, "String", "Genotype"),
                 ("INFO", "ref_qs", ".", "Float", "Quals")):
        assert str(vcf.MetaInfo(*args)) == str(jax_vcf.MetaInfo(*args))
    for bad in (("HEAD", "DP", 1, "Integer", "x"),
                ("INFO", "DP", "Z", "Integer", "x"),
                ("INFO", "DP", 1, "Int", "x")):
        with pytest.raises(ValueError):
            vcf.MetaInfo(*bad)


def _write(module, path, recs, sort):
    meta = [module.MetaInfo("FORMAT", "GT", 1, "String", "Genotype"),
            module.MetaInfo("INFO", "DP", 1, "Integer", "Depth"),
            module.MetaInfo("FORMAT", "GQ", 1, "Integer", "Quality")]
    variants = [module.Variant(*a, **{k: _copy(x) for k, x in kw.items()})
                for a, kw in recs]
    with module.VCFWriter(path, "w", version="4.1",
                          contigs=["chr1,length=400", "chr2,length=400",
                                   "chr10,length=400"],
                          meta_info=meta) as writer:
        if sort:
            writer.write_variants(variants, sort=True)
        else:
            for v in variants:
                writer.write_variant(v)


@pytest.mark.parametrize("sort", [True, False])
def test_writer_writes_the_same_bytes(tmp_path, sort):
    _, recs = _records(3)
    a, b = str(tmp_path / "port.vcf"), str(tmp_path / "jax.vcf")
    _write(vcf, a, recs, sort)
    _write(jax_vcf, b, recs, sort)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        got, want = fa.read(), fb.read()
    assert got == want
    assert b"##medaka_tpu_version=" in got
    if sort:   # natural contig order: chr1 < chr2 < chr10
        order = [line.split(b"\t")[0] for line in got.splitlines()
                 if not line.startswith(b"#")]
        assert order == sorted(order, key=lambda c: int(c[3:]))


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("cache", [True, False])
def test_reader_fetches_the_same_records(tmp_path, strict, cache):
    _, recs = _records(4)
    path = str(tmp_path / "in.vcf")
    _write(jax_vcf, path, recs, True)
    got_r = vcf.VCFReader(path, cache=cache)
    want_r = jax_vcf.VCFReader(path, cache=cache)
    assert got_r.meta == want_r.meta and got_r.header == want_r.header
    for region in ((None, None, None), ("chr1", None, None),
                   ("chr2", 50, 200), ("chr10", 0, 37), ("chr1", 399, 500)):
        got = [_fields(v) for v in got_r.fetch(*region, strict=strict)]
        want = [_fields(v) for v in want_r.fetch(*region, strict=strict)]
        assert got == want
    assert got_r.chroms == want_r.chroms


def test_reader_refuses_unsorted(tmp_path):
    path = str(tmp_path / "bad.vcf")
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.1\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                 "FILTER\tINFO\n")
        fh.write("c\t10\t.\tA\tC\t.\t.\t.\nc\t5\t.\tA\tC\t.\t.\t.\n")
    with pytest.raises(IOError, match="not position-sorted"):
        vcf.VCFReader(path).index()

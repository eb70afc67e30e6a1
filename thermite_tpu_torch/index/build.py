"""Reference index: concatenated genome + transcriptome + artifact IO.

Layout parity with the reference (src/index.rs:52-223): every
chromosome is appended **forward then reverse-complement**, each copy
'$'-terminated, so reverse-strand alignments are plain forward matches
against the revcomp copy and all coordinate math carries over.

Differences from the original (Rust) aligner:
* No suffix array / BWT / FM-index.  Seeding uses k-mer gather tables
  (see ``thermite_tpu_torch.seed``) resident in device memory — the
  structure the BASELINE north star prescribes.
* Interval trees become flat sorted arrays (``IntervalTable``).
* The artifact (.tai) is a numpy .npz bundle: packed text, ref table,
  transcriptome arrays — directly memory-mappable and device-uploadable.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io.fastx import parse_fastx, revcomp
from ..io.gtf import parse_gtf
from .txome import Exon, Gene, IntervalTable, Tx, Txome


class _TextView:
    """bytes-like read-only facade over a (possibly file-backed) uint8
    array: slices come back as ``bytes``, ints as ``int`` — the two
    operations the pipeline performs on ``Index.seq``.  Lets a
    memory-mapped artifact text serve without a multi-GB eager copy."""

    __slots__ = ("arr",)

    def __init__(self, arr: np.ndarray):
        self.arr = arr

    def __len__(self) -> int:
        return len(self.arr)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return self.arr[i].tobytes()
        return int(self.arr[i])


def acgtn_counts(text) -> np.ndarray:
    """256-bin byte histogram of a (possibly huge, possibly memmapped)
    uint8 text.  np.bincount casts its input to int64 internally, so a
    single call over a genome-scale text materializes 8x the text in
    fresh anonymous pages (measured as a ~40 min stall under this
    deployment's fresh-page throttle); chunk through ONE preallocated
    int64 buffer so every chunk re-writes the same pages instead."""
    counts = np.zeros(256, np.int64)
    ch = 1 << 24
    tmp = np.empty(min(ch, max(len(text), 1)), np.int64)
    for ofs in range(0, len(text), ch):
        c = text[ofs : ofs + ch]
        t = tmp[: len(c)]
        np.copyto(t, c)
        counts += np.bincount(t, minlength=256)
    return counts


def _npz_mmap_views(path: str) -> Optional[Dict[str, np.ndarray]]:
    """Memory-map the members of an UNCOMPRESSED ``.npz`` in place.

    ``np.load`` copies every member into fresh anonymous memory — for
    a whole-genome artifact that is ~19 GB of first-touch pages, which
    this deployment throttles to tens of MB/s (measured; see
    docs/ROUND3.md env notes).  The artifact is written with
    ``np.savez`` (ZIP_STORED), so each member's array bytes are a
    contiguous span of the file: map them read-only and let the page
    cache serve — lazy, shareable, and no anonymous-page cost.
    Returns None (caller falls back to ``np.load``) for compressed
    members or any parse surprise (the latter with a warning on stderr:
    a genome-scale load then copies tens of GB).  Only numpy's public
    ``.npy`` header readers are used: newer numpy releases dropped the
    private one from ``np.lib.format``, and a 23 GB artifact then loaded
    eagerly without a word."""
    import zipfile

    from numpy.lib import format as npy

    readers = {(1, 0): npy.read_array_header_1_0,
               (2, 0): npy.read_array_header_2_0}
    try:
        out: Dict[str, np.ndarray] = {}
        with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
            for info in zf.infolist():
                if info.compress_type != zipfile.ZIP_STORED:
                    return None
                f.seek(info.header_offset)
                lh = f.read(30)
                if lh[:4] != b"PK\x03\x04":
                    return None
                nlen = int.from_bytes(lh[26:28], "little")
                elen = int.from_bytes(lh[28:30], "little")
                f.seek(info.header_offset + 30 + nlen + elen)
                version = npy.read_magic(f)
                shape, fortran, dtype = readers[version](f)
                if dtype.hasobject:
                    return None
                name = info.filename
                if name.endswith(".npy"):
                    name = name[:-4]
                out[name] = np.memmap(
                    path, dtype=dtype, mode="r", offset=f.tell(),
                    shape=shape, order="F" if fortran else "C",
                )
        return out
    except Exception as e:  # unexpected layout: eager np.load still works
        import sys

        print(f"warning: {path} is not memory-mapped ({e!r}); its members "
              "are loaded into memory", file=sys.stderr)
        return None


@dataclass
class Ref:
    """One strand copy of one chromosome (reference src/index.rs:391-399)."""

    name: str
    strand: bool  # True = the forward copy
    len: int
    start_idx: int  # start in the concatenated text
    end_idx: int  # end in the concatenated text, including '$'


class Index:
    """Concatenated-genome index with transcriptome annotations."""

    def __init__(self, refs: List[Ref], seq, txome: Txome):
        self.refs = refs
        self.txome = txome
        self._ref_ends = np.array([r.end_idx for r in refs], dtype=np.int64)
        if isinstance(seq, np.ndarray):
            # file-backed (memory-mapped artifact) text: keep the
            # array, serve bytes semantics through _TextView
            self.seq_arr = seq
            self.seq = _TextView(seq)
        else:
            self.seq = seq
            # numpy uint8 view of the text for vectorized seeding/slicing
            self.seq_arr = np.frombuffer(seq, dtype=np.uint8)
        # persisted k-mer posting table (k, uniq_keys, offsets,
        # positions) — the .tai-equivalent one-artifact contract
        # (reference src/main.rs:43,67 ships the whole FM index in the
        # .tai file; here the radix-sorted anchor table is the costly
        # part, ~42 s at chromosome scale, so it rides the artifact too)
        self.seed_table = None

    def build_seed_table(self, min_seed_len: Optional[int] = None,
                         stride: int = 1):
        """Build (and cache) the anchor posting table for
        ``min_seed_len`` (default: the CLI default, k=20).

        ``stride`` > 1 samples text positions (whole-genome tables:
        1/stride the memory/build time; matches shorter than
        k + stride - 1 may be missed — cf. STAR's sparse suffix array).
        """
        from ..constants import DEFAULT_MIN_SEED_LEN
        from ..seed.native import make_seeder

        if min_seed_len is None:
            min_seed_len = DEFAULT_MIN_SEED_LEN
        seeder = make_seeder(self.seq_arr, min_seed_len, stride=stride)
        # zero-copy views into the engine's arrays: a genome-scale
        # export copy is ~37 GB of fresh pages.  The engine must then
        # outlive the table — it rides on the Index.
        self.seed_table = seeder.export_table(views=True)
        # remembered so classic-array adopters (and the artifact) can
        # declare the build stride — stride 1 enables the native
        # seeder's adaptive probe skip (csrc thermite_smems)
        self.seed_stride = int(stride)
        self._seed_engine = seeder
        return self.seed_table

    # -- construction -------------------------------------------------

    @classmethod
    def create_from_files(cls, ref_path: str, annot_path: Optional[str]) -> "Index":
        refs: List[Ref] = []
        chunks: List[bytes] = []
        pos = 0
        name_to_ref: Dict[Tuple[str, bool], int] = {}
        chrom_seqs: Dict[str, bytes] = {}

        for rec in parse_fastx(ref_path):
            name = rec.id.split(b" ")[0].decode()
            fwd = rec.seq.upper()
            chrom_seqs[name] = fwd
            start = pos
            chunks.append(fwd)
            chunks.append(b"$")
            pos += len(fwd) + 1
            name_to_ref[(name, True)] = len(refs)
            refs.append(Ref(name, True, len(fwd), start, pos))

            rc = revcomp(rec.seq).upper()
            start = pos
            chunks.append(rc)
            chunks.append(b"$")
            pos += len(rc) + 1
            name_to_ref[(name, False)] = len(refs)
            refs.append(Ref(name, False, len(fwd), start, pos))

        seq = b"".join(chunks)

        genes: List[Gene] = []
        txs: List[Tx] = []
        gene_spans: List[Tuple[int, int]] = []
        exon_starts: List[int] = []
        exon_ends: List[int] = []
        exon_tx: List[int] = []

        if annot_path is not None:
            gtf_genes, gtf_txs = parse_gtf(annot_path)
            genes = [Gene(g.id, g.name) for g in gtf_genes]
            gene_spans = [(len(seq), 0)] * len(genes)

            skipped_chroms = set()
            for gtf_tx in gtf_txs:
                strand = gtf_tx.strand
                if (gtf_tx.chrom, strand) not in name_to_ref:
                    # GTF annotations on chromosomes/scaffolds absent
                    # from the FASTA (e.g. full GENCODE GTF against a
                    # reduced assembly): skip, warn once per chromosome
                    if gtf_tx.chrom not in skipped_chroms:
                        skipped_chroms.add(gtf_tx.chrom)
                        import sys

                        print(
                            f"warning: skipping annotations on "
                            f"{gtf_tx.chrom!r}: not in the reference FASTA",
                            file=sys.stderr,
                        )
                    continue
                tx_ref = refs[name_to_ref[(gtf_tx.chrom, strand)]]
                tx_seq = gtf_tx.spliced_seq(chrom_seqs[gtf_tx.chrom])

                # Map the transcript span into concatenated coordinates of
                # the strand-matching chromosome copy
                # (reference src/index.rs:149-162).  For '-' features the
                # coordinates flip across the revcomp copy.
                if strand:
                    tx_start = gtf_tx.start + tx_ref.start_idx
                    tx_end = gtf_tx.end + tx_ref.start_idx
                else:
                    tx_start = tx_ref.end_idx - 1 - gtf_tx.end
                    tx_end = tx_ref.end_idx - 1 - gtf_tx.start
                g = gtf_tx.gene_idx
                gene_spans[g] = (
                    min(gene_spans[g][0], tx_start),
                    max(gene_spans[g][1], tx_end),
                )

                exons = []
                for (e_start, e_end) in gtf_tx.exons:
                    if strand:
                        es = e_start + tx_ref.start_idx
                        ee = e_end + tx_ref.start_idx
                    else:
                        es = tx_ref.end_idx - 1 - e_end
                        ee = tx_ref.end_idx - 1 - e_start
                    exon_starts.append(es)
                    exon_ends.append(ee)
                    exon_tx.append(len(txs))
                    exons.append(Exon(es, ee, len(txs)))
                if not strand:
                    # exon order must follow the (revcomp'd) tx sequence
                    exons.reverse()

                txs.append(
                    Tx(
                        id=gtf_tx.id,
                        chrom=gtf_tx.chrom,
                        strand=strand,
                        exons=exons,
                        seq=tx_seq,
                        gene_idx=g,
                    )
                )

        txome = Txome(
            genes=genes,
            txs=txs,
            exon_to_tx=IntervalTable(exon_starts, exon_ends, exon_tx),
            gene_intervals=IntervalTable(
                [s for s, _ in gene_spans],
                [e for _, e in gene_spans],
                list(range(len(genes))),
            ),
        )
        return cls(refs, seq, txome)

    # -- coordinate mapping (reference src/index.rs:287-323) ----------

    def idx_to_ref(self, idx: int) -> Tuple[Ref, int]:
        """Concatenated coordinate → (chromosome copy, local coordinate)."""
        ref_idx = int(np.searchsorted(self._ref_ends, idx, side="right"))
        r = self.refs[ref_idx]
        return r, idx - r.start_idx

    def seq_slice(self, start: int, end: int) -> bytes:
        """Text slice [start, end) — all copies are materialised, so this
        is a direct slice (the reference recomputes revcomp copies on
        the fly because it stores only forward sequences,
        src/index.rs:304-323; we trade memory for gather-friendliness)."""
        return self.seq[start:end]

    # -- stats (parity with reference src/index.rs:326-361) -----------

    def stats(self) -> Dict[str, int]:
        return {
            "num_chromosomes": len(self.refs),
            "text_len": len(self.seq),
            "num_genes": len(self.txome.genes),
            "num_transcripts": len(self.txome.txs),
        }

    def print_stats(self) -> None:
        s = self.stats()
        print(f"Number of chromosomes\t{s['num_chromosomes']}")
        print(f"Length of concatenated text\t{s['text_len']}")
        print(f"Number of genes\t{s['num_genes']}")
        print(f"Number of transcripts\t{s['num_transcripts']}")

    # -- artifact IO (.tai equivalent) ---------------------------------
    #
    # np.savez always appends .npz; save/load normalize the path the
    # same way so every API caller (CLI, wrapper, library) sees one
    # consistent artifact name.

    @staticmethod
    def _artifact_path(path: str) -> str:
        return path if path.endswith(".npz") else path + ".npz"

    def save(self, path: str) -> None:
        path = self._artifact_path(path)
        meta = {
            "version": 1,
            "refs": [
                {
                    "name": r.name,
                    "strand": r.strand,
                    "len": r.len,
                    "start_idx": r.start_idx,
                    "end_idx": r.end_idx,
                }
                for r in self.refs
            ],
            "genes": [{"id": g.id, "name": g.name} for g in self.txome.genes],
            "txs": [
                {
                    "id": t.id,
                    "chrom": t.chrom,
                    "strand": t.strand,
                    "gene_idx": t.gene_idx,
                    "n_exons": len(t.exons),
                }
                for t in self.txome.txs
            ],
        }
        tx_exon_flat = np.array(
            [(e.start, e.end) for t in self.txome.txs for e in t.exons],
            dtype=np.int64,
        ).reshape(-1, 2)
        meta["text_len"] = int(len(self.seq))
        from ..ops.layout import _WPAD

        meta["nib_wpad"] = int(_WPAD)
        # one save-time ACGTN$ scan spares every batch engine start
        # the same full-text pass (batch.py's nibble-safety check);
        # acgtn_counts chunks through one preallocated cast buffer
        counts = acgtn_counts(self.seq_arr)
        for t in self.txome.txs:
            counts += np.bincount(
                np.frombuffer(t.seq, np.uint8), minlength=256
            )
        counts[list(b"ACGTN$") + [0]] = 0
        meta["text_acgtn_ok"] = bool(counts.sum() == 0)
        tx_seq_lens = np.array([len(t.seq) for t in self.txome.txs], dtype=np.int64)
        ett = self.txome.exon_to_tx
        gi = self.txome.gene_intervals
        if self.seed_table is None:
            # same size-based stride default as the CLI: a stride-1
            # genome-scale table is tens of GB and an hours-long build —
            # never the right silent default (cli.py --seed-stride)
            self.build_seed_table(
                stride=1 if len(self.seq) < (512 << 20) else 4
            )
        # the genome text and the transcript spliced seqs are stored as
        # ONE member, `ref_text` — exactly the resident-text layout the
        # aligner needs (genome fwd+rc then every tx, batch.py tx_off).
        # Loads then serve BOTH Index.seq (a prefix view) and
        # BatchAligner._ref_text_host (the whole member) straight from
        # the mmap: no 6.5 GB first-touch concat at genome scale.
        common = dict(
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            tx_exons=tx_exon_flat,
            tx_seq_lens=tx_seq_lens,
            exon_to_tx=np.stack([ett.starts, ett.ends, ett.data]) if len(ett) else np.zeros((3, 0), np.int64),
            gene_intervals=np.stack([gi.starts, gi.ends, gi.data]) if len(gi) else np.zeros((3, 0), np.int64),
        )
        from ..seed.native import PackedSeedTable

        if isinstance(self.seed_table, PackedSeedTable):
            # genome-scale packed form: sorted u64 entries + MSD
            # bucket bounds — ~half the bytes of the classic arrays
            t = self.seed_table
            meta["seed_k"] = int(t.k)
            meta["seed_packed"] = {
                "stride": t.stride, "top_bits": t.top_bits,
                "pos_bits": t.pos_bits,
            }
            common["meta"] = np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8
            )
            extra = {}
            if t.pfx is not None:
                # persisted pfx prefix: engine start skips the full-kv
                # count pass (~4 min single-core at genome scale)
                extra["seed_pfx"] = t.pfx
            np.savez(path, seed_kv=t.kv, seed_bucket_off=t.bucket_off,
                     **extra, **common)
            self._append_ref_text(path)
            return
        sk, skeys, soff, spos = self.seed_table
        meta["seed_k"] = int(sk)
        # classic tables don't carry their stride (packed ones do);
        # record it so adopting loads can enable the adaptive probe
        # skip (absent in older artifacts -> skip stays off)
        if getattr(self, "seed_stride", None) is not None:
            meta["seed_stride"] = int(self.seed_stride)
        common["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
        # positions fit int32 for any <2 GiB text: halve disk + IO
        spos_disk = (
            spos.astype(np.int32, copy=False)
            if len(self.seq) < (1 << 31) else spos
        )
        # uncompressed savez: zlib on a chromosome-scale posting table
        # costs minutes on one core and slows every load; disk is cheap
        np.savez(
            path,
            seed_keys=skeys,
            seed_offsets=soff,
            seed_positions=spos_disk,
            **common,
        )
        self._append_ref_text(path)

    def _append_ref_text(self, path: str) -> None:
        """Append the `ref_text` member (genome text + every tx spliced
        seq, batch.py resident layout) and its nibble-packed device
        form `text_nib` to the saved .npz, STREAMED — never
        materializing the multi-GB buffers these members exist to
        eliminate from loads (loads mmap both; engine start then packs
        and concatenates nothing)."""
        import zipfile

        from ..ops.layout import iter_text_nib_words, nib_lw

        total = len(self.seq) + sum(len(t.seq) for t in self.txome.txs)
        with zipfile.ZipFile(
            path, "a", compression=zipfile.ZIP_STORED
        ) as zf:
            with zf.open("ref_text.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(
                    f,
                    {
                        "descr": "|u1",
                        "fortran_order": False,
                        "shape": (int(total),),
                    },
                )
                mv = memoryview(self.seq_arr)
                step = 64 << 20
                for off in range(0, len(mv), step):
                    f.write(mv[off : off + step])
                for t in self.txome.txs:
                    f.write(t.seq)
        # the packed form reads ref_text back from the file just
        # written (file-backed pages, not fresh anonymous memory)
        mm = _npz_mmap_views(path)
        rt = mm["ref_text"] if mm is not None else None
        with zipfile.ZipFile(
            path, "a", compression=zipfile.ZIP_STORED
        ) as zf:
            with zf.open("text_nib.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(
                    f,
                    {
                        "descr": "<i4",
                        "fortran_order": False,
                        "shape": (int(nib_lw(int(total))),),
                    },
                )
                if rt is None:  # fallback: materialize (small indexes)
                    rt = np.concatenate(
                        [self.seq_arr]
                        + [np.frombuffer(t.seq, np.uint8)
                           for t in self.txome.txs]
                    )
                for chunk in iter_text_nib_words(rt):
                    f.write(memoryview(chunk))

    @classmethod
    def load(cls, path: str, mmap: bool = True) -> "Index":
        """Load an artifact.  With ``mmap`` (default) the multi-GB
        members (text, posting table) are memory-mapped read-only from
        the uncompressed .npz instead of copied — a whole-genome load
        drops from ~19 GB of first-touch pages to lazy file-backed
        paging (the page cache is typically still warm from the save).
        Pass ``mmap=False`` for fully materialized arrays."""
        import os

        if not os.path.exists(path):
            path = cls._artifact_path(path)
        z = np.load(path, allow_pickle=False)
        mm = _npz_mmap_views(path) if mmap else None

        def big(name):
            """the large members: mapped when possible, loaded else"""
            return mm[name] if mm is not None and name in mm else z[name]

        meta = json.loads(bytes(z["meta"]).decode())
        if meta.get("version") != 1:
            raise ValueError(f"unsupported index version: {meta.get('version')}")
        refs = [
            Ref(m["name"], m["strand"], m["len"], m["start_idx"], m["end_idx"])
            for m in meta["refs"]
        ]
        # current artifacts store `ref_text` (genome text + tx spliced
        # seqs, the aligner's resident-text layout) as one member:
        # Index.seq is its prefix view and the aligner reuses the whole
        # member, so a genome-scale load touches no anonymous pages.
        # Older artifacts (`text` + `tx_seq_blob` members) still load.
        ref_text = None
        if "ref_text" in z.files:
            text_len = int(meta["text_len"])
            ref_text = big("ref_text")
            seq = ref_text[:text_len]
            tx_blob = ref_text[text_len:]
        else:
            seq = big("text") if mm is not None else z["text"].tobytes()
            tx_blob = (
                big("tx_seq_blob") if mm is not None
                else np.frombuffer(z["tx_seq_blob"].tobytes(), np.uint8)
            )
        genes = [Gene(m["id"], m["name"]) for m in meta["genes"]]

        tx_exons = z["tx_exons"]
        tx_seq_lens = z["tx_seq_lens"]
        txs: List[Tx] = []
        eoff = 0
        soff = 0
        for tx_i, m in enumerate(meta["txs"]):
            n = m["n_exons"]
            exons = [
                Exon(int(a), int(b), tx_i) for a, b in tx_exons[eoff : eoff + n]
            ]
            eoff += n
            slen = int(tx_seq_lens[tx_i])
            txs.append(
                Tx(
                    id=m["id"],
                    chrom=m["chrom"],
                    strand=m["strand"],
                    exons=exons,
                    seq=bytes(tx_blob[soff : soff + slen]),
                    gene_idx=m["gene_idx"],
                )
            )
            soff += slen

        ett = z["exon_to_tx"]
        gi = z["gene_intervals"]
        txome = Txome(
            genes=genes,
            txs=txs,
            exon_to_tx=IntervalTable(ett[0], ett[1], ett[2]),
            gene_intervals=IntervalTable(gi[0], gi[1], gi[2]),
        )
        idx = cls(refs, seq, txome)
        # whole resident text (genome + txs) as loaded — BatchAligner
        # reuses it instead of concatenating a fresh copy
        idx.ref_text_arr = ref_text
        # save-time ACGTN$ scan result (spares the aligner's own pass)
        idx.text_acgtn_ok = bool(meta.get("text_acgtn_ok", False))
        # its nibble-packed device form, reused iff the pad constant
        # still matches (else the aligner repacks)
        idx.text_nib_arr = None
        if ref_text is not None and mm is not None and "text_nib" in mm:
            from ..ops.layout import _WPAD, nib_lw

            if meta.get("nib_wpad") == _WPAD and len(
                mm["text_nib"]
            ) == nib_lw(len(ref_text)):
                idx.text_nib_arr = mm["text_nib"]
        if "seed_kv" in z.files and "seed_packed" in meta:
            from ..seed.native import PackedSeedTable

            sp = meta["seed_packed"]
            idx.seed_table = PackedSeedTable(
                int(meta["seed_k"]), sp["stride"], sp["top_bits"],
                sp["pos_bits"], big("seed_bucket_off"), big("seed_kv"),
                pfx=big("seed_pfx") if "seed_pfx" in z.files else None,
            )
        elif "seed_keys" in z.files and "seed_k" in meta:
            # positions stay in their stored dtype (int32 for <2 GiB
            # texts): the native seeder adopts the narrow form zero-copy
            # (seed/native.py); widening here first-touched ~0.7 GB of
            # fresh pages — ~a minute in throttled windows
            idx.seed_table = (
                int(meta["seed_k"]),
                big("seed_keys"),
                big("seed_offsets"),
                big("seed_positions"),
            )
            if "seed_stride" in meta:
                idx.seed_stride = int(meta["seed_stride"])
        return idx

    def warm_mmap(self) -> float:
        """Sequentially fault in the memmap-backed artifact members.

        Seeding bisects the packed posting table and extension walks
        the text at effectively random offsets; on a cold mmap every
        probe is a 4 KB random disk fault (measured 32 ms/read on the
        first genome-scale chunk vs 33 us warm).  One streaming pass
        per member turns that into sequential IO at disk bandwidth
        (~40 s for a 13 GB table).  Near-free when already page-cached.
        Returns the wall seconds spent."""
        import time as _time

        t0 = _time.time()

        def touch(a) -> None:
            if a is None or not isinstance(a, np.memmap):
                return
            x = a.reshape(-1).view(np.uint8)
            for ofs in range(0, len(x), 1 << 25):
                # one byte per page faults the whole range with
                # kernel fault-around/readahead, no big temporaries
                int(x[ofs : ofs + (1 << 25) : 4096].astype(np.int64).sum())

        st = getattr(self, "seed_table", None)
        if st is not None:
            from ..seed.native import PackedSeedTable

            if isinstance(st, PackedSeedTable):
                touch(st.kv)
                touch(st.bucket_off)
                touch(st.pfx)
            elif isinstance(st, tuple):
                for a in st[1:]:
                    touch(a)
        touch(getattr(self, "ref_text_arr", None))
        touch(getattr(self, "text_nib_arr", None))
        return _time.time() - t0

/* C-level construction of the batch pipeline's result object tree.
 *
 * `align_batch` returns real Python objects (GenomeAlignment ->
 * Alignment -> RunOps, thermite_tpu_torch/align/types.py — the observable
 * structure of the reference's types, reference src/txome.rs:54-69 /
 * rust-bio Alignment).  Building ~half a million small slotted
 * dataclass instances per benchmark batch through their Python
 * __init__ was the finalize stage's dominant cost (~60% of host wall
 * at chrM after the GC pause landed).  This module constructs the
 * SAME instances through the CPython C API: tp_alloc + direct slot
 * stores via each class's member-descriptor offsets, with the
 * per-index strings/ints borrowed from caller-provided lists so the
 * hot loop allocates nothing but the run lists and coordinate ints.
 *
 * Loaded with ctypes.PyDLL (the GIL stays held across calls).  Any
 * initialization failure (slot layout not found, non-heap classes)
 * makes the entry return a negative code and the Python caller falls
 * back to the pure-Python loop — behavior, not availability, is the
 * contract (tests/test_objbuild.py compares both paths object by
 * object).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <structmember.h>

#include <stdint.h>

/* slot byte offsets resolved from member descriptors at init */
typedef struct {
  int score, ystart, xstart, yend, xend, ylen, xlen, operations, op_runs;
} AlnOffs;
typedef struct {
  int gx_aln, aln_type, ref_name, strand, primary, tx_aln, tx_idx, gene_idx;
} GaOffs;
typedef struct {
  int runs, ops;
} RunOpsOffs;

static AlnOffs g_aln;
static GaOffs g_ga;
static RunOpsOffs g_ro;
static PyTypeObject *g_aln_t, *g_ga_t, *g_ro_t;
static int g_ready = 0;

static int slot_offset(PyObject* cls, const char* name) {
  PyObject* d = PyObject_GetAttrString(cls, name);
  if (d == NULL) {
    PyErr_Clear();
    return -1;
  }
  if (!PyObject_TypeCheck(d, &PyMemberDescr_Type)) {
    Py_DECREF(d);
    return -1;
  }
  int off = (int)((PyMemberDescrObject*)d)->d_member->offset;
  Py_DECREF(d);
  return off;
}

/* one-time layout resolution; classes must be heap types with the
 * expected __slots__.  Returns 0 on success. */
long long thermite_obj_init(PyObject* aln_cls, PyObject* ga_cls,
                            PyObject* runops_cls) {
  if (!PyType_Check(aln_cls) || !PyType_Check(ga_cls) ||
      !PyType_Check(runops_cls))
    return -1;
  g_aln_t = (PyTypeObject*)aln_cls;
  g_ga_t = (PyTypeObject*)ga_cls;
  g_ro_t = (PyTypeObject*)runops_cls;
  if (g_aln_t->tp_alloc == NULL || g_ga_t->tp_alloc == NULL ||
      g_ro_t->tp_alloc == NULL)
    return -2;
  g_aln.score = slot_offset(aln_cls, "score");
  g_aln.ystart = slot_offset(aln_cls, "ystart");
  g_aln.xstart = slot_offset(aln_cls, "xstart");
  g_aln.yend = slot_offset(aln_cls, "yend");
  g_aln.xend = slot_offset(aln_cls, "xend");
  g_aln.ylen = slot_offset(aln_cls, "ylen");
  g_aln.xlen = slot_offset(aln_cls, "xlen");
  g_aln.operations = slot_offset(aln_cls, "operations");
  g_aln.op_runs = slot_offset(aln_cls, "op_runs");
  g_ga.gx_aln = slot_offset(ga_cls, "gx_aln");
  g_ga.aln_type = slot_offset(ga_cls, "aln_type");
  g_ga.ref_name = slot_offset(ga_cls, "ref_name");
  g_ga.strand = slot_offset(ga_cls, "strand");
  g_ga.primary = slot_offset(ga_cls, "primary");
  g_ga.tx_aln = slot_offset(ga_cls, "tx_aln");
  g_ga.tx_idx = slot_offset(ga_cls, "tx_idx");
  g_ga.gene_idx = slot_offset(ga_cls, "gene_idx");
  g_ro.runs = slot_offset(runops_cls, "_runs");
  g_ro.ops = slot_offset(runops_cls, "_ops");
  const int* all[] = {
      &g_aln.score, &g_aln.ystart, &g_aln.xstart, &g_aln.yend,
      &g_aln.xend, &g_aln.ylen, &g_aln.xlen, &g_aln.operations,
      &g_aln.op_runs, &g_ga.gx_aln, &g_ga.aln_type, &g_ga.ref_name,
      &g_ga.strand, &g_ga.primary, &g_ga.tx_aln, &g_ga.tx_idx,
      &g_ga.gene_idx, &g_ro.runs, &g_ro.ops,
  };
  for (size_t i = 0; i < sizeof(all) / sizeof(all[0]); ++i)
    if (*all[i] < 0) return -3;
  g_ready = 1;
  return 0;
}

/* slot store: steals v (slot was NULL from tp_alloc) */
static inline void sset(PyObject* o, int off, PyObject* v) {
  *(PyObject**)((char*)o + off) = v;
}

static PyObject* runs_list(const int64_t* runs, int64_t a, int64_t b) {
  PyObject* l = PyList_New(b - a);
  if (l == NULL) return NULL;
  for (int64_t i = a; i < b; ++i) {
    PyObject* v = PyLong_FromLongLong((long long)runs[i]);
    if (v == NULL) {
      Py_DECREF(l);
      return NULL;
    }
    PyList_SET_ITEM(l, i - a, v);
  }
  return l;
}

/* Alignment(score, ystart, xstart, yend, xend, ylen, xlen,
 *           RunOps(runs_l), runs_l)
 * Every PyObject* argument is borrowed (the alignment takes its own
 * references); int coordinates become fresh PyLongs. */
static PyObject* make_alignment(PyObject* score_o, int64_t ystart,
                                int64_t xstart, int64_t yend, int64_t xend,
                                PyObject* ylen_o, PyObject* xlen_o,
                                PyObject* runs_l) {
  PyObject* a = g_aln_t->tp_alloc(g_aln_t, 0);
  if (a == NULL) return NULL;
  Py_INCREF(score_o);
  sset(a, g_aln.score, score_o);
  PyObject* v;
  if ((v = PyLong_FromLongLong((long long)ystart)) == NULL) goto fail;
  sset(a, g_aln.ystart, v);
  if ((v = PyLong_FromLongLong((long long)xstart)) == NULL) goto fail;
  sset(a, g_aln.xstart, v);
  if ((v = PyLong_FromLongLong((long long)yend)) == NULL) goto fail;
  sset(a, g_aln.yend, v);
  if ((v = PyLong_FromLongLong((long long)xend)) == NULL) goto fail;
  sset(a, g_aln.xend, v);
  Py_INCREF(ylen_o);
  sset(a, g_aln.ylen, ylen_o);
  Py_INCREF(xlen_o);
  sset(a, g_aln.xlen, xlen_o);
  /* RunOps view last: after this point there are no failure exits, so
   * a single Py_DECREF(a) on any earlier failure releases everything
   * set so far (dealloc XDECREFs the still-NULL slots harmlessly). */
  PyObject* ro = g_ro_t->tp_alloc(g_ro_t, 0);
  if (ro == NULL) goto fail;
  Py_INCREF(runs_l); /* RunOps._runs */
  sset(ro, g_ro.runs, runs_l);
  Py_INCREF(Py_None);
  sset(ro, g_ro.ops, Py_None);
  sset(a, g_aln.operations, ro);
  Py_INCREF(runs_l); /* Alignment.op_runs shares the same list */
  sset(a, g_aln.op_runs, runs_l);
  return a;
fail:
  Py_DECREF(a);
  return NULL;
}

/* Build every non-fallback selected alignment's object tree into
 * `results` (fallback rows append None for the Python caller to
 * replace, preserving per-read order).  Returns the number of
 * fallback rows, or a negative code on error (exception cleared; the
 * caller falls back to the Python loop).
 *
 * Failure contract: -1/-2/-3 are returned from argument/row
 * validation BEFORE anything is appended (all sel rows and offset
 * ranges are checked in a pre-pass); -4 (allocation/append failure
 * mid-loop) rolls every results[ri] list back to its pre-call length
 * first.  Either way the caller sees an untouched `results` and may
 * re-run the pure-Python loop safely.
 *
 * sel: (S, 11) int64 rows [ri, ti, atype, gene, refid, score, ys, ye,
 * xs, xe, prim] — native_batch.py layout.  tx_meta: (S, 5).
 * task_tx: tasks_arr[:, 9] (n_tasks entries); n_fin_runs/n_tx_runs
 * bound the run arrays for the offset-range checks. */
long long thermite_obj_build(
    PyObject* aln_types,  /* tuple (EXONIC, INTRONIC, INTERGENIC) */
    PyObject* ref_names,  /* list[str|bytes] per ref */
    PyObject* ref_strands,/* list per ref (bool) */
    PyObject* ref_lens,   /* list[int] per ref */
    PyObject* read_lens,  /* list[int] per chunk read */
    PyObject* results,    /* list[list], one per chunk read */
    const int64_t* sel, long long S,
    const int64_t* fin_runs, const int64_t* fin_off,
    const int64_t* tx_runs, const int64_t* tx_off, const int64_t* tx_meta,
    const uint8_t* fallback, const int64_t* task_tx,
    long long n_tasks, long long n_fin_runs, long long n_tx_runs) {
  if (!g_ready) return -1;
  if (!PyTuple_Check(aln_types) || !PyList_Check(ref_names) ||
      !PyList_Check(ref_strands) || !PyList_Check(ref_lens) ||
      !PyList_Check(read_lens) || !PyList_Check(results))
    return -2;
  long long n_fallback = 0;
  Py_ssize_t n_reads = PyList_GET_SIZE(results);
  Py_ssize_t n_refs = PyList_GET_SIZE(ref_names);
  /* pre-pass: validate every row (and the offset ranges the build
   * loop will index with) before a single append happens */
  for (long long s = 0; s < S; ++s) {
    const int64_t* row = sel + s * 11;
    if (row[0] < 0 || row[0] >= n_reads || row[4] < 0 ||
        row[4] >= n_refs || row[2] < 0 || row[2] > 2)
      return -3;
    if (fallback[s]) continue;
    if (fin_off[s] < 0 || fin_off[s] > fin_off[s + 1] ||
        fin_off[s + 1] > n_fin_runs)
      return -3;
    if (row[2] == 0) { /* exonic: uses task_tx[ti] and tx_runs */
      if (row[1] < 0 || row[1] >= n_tasks) return -3;
      if (tx_off[s] < 0 || tx_off[s] > tx_off[s + 1] ||
          tx_off[s + 1] > n_tx_runs)
        return -3;
    }
  }
  /* snapshot per-read list lengths so a mid-loop failure can roll
   * `results` back to its pre-call state */
  Py_ssize_t* len0 =
      (Py_ssize_t*)PyMem_Malloc((size_t)n_reads * sizeof(Py_ssize_t));
  if (len0 == NULL) return -4;
  for (Py_ssize_t i = 0; i < n_reads; ++i)
    len0[i] = PyList_GET_SIZE(PyList_GET_ITEM(results, i));
  for (long long s = 0; s < S; ++s) {
    const int64_t* row = sel + s * 11;
    int64_t ri = row[0], ti = row[1], atype = row[2], gene = row[3];
    int64_t refid = row[4], score = row[5], ys = row[6], ye = row[7];
    int64_t xs = row[8], xe = row[9], prim = row[10];
    PyObject* out = PyList_GET_ITEM(results, ri);
    if (fallback[s]) {
      ++n_fallback;
      if (PyList_Append(out, Py_None) < 0) goto err;
      continue;
    }
    PyObject* xlen_o = PyList_GET_ITEM(read_lens, ri);    /* borrowed */
    PyObject* ylen_o = PyList_GET_ITEM(ref_lens, refid);  /* borrowed */
    PyObject* score_o = PyLong_FromLongLong((long long)score);
    if (score_o == NULL) goto err;
    PyObject* gruns = runs_list(fin_runs, fin_off[s], fin_off[s + 1]);
    if (gruns == NULL) {
      Py_DECREF(score_o);
      goto err;
    }
    PyObject* gx =
        make_alignment(score_o, ys, xs, ye, xe, ylen_o, xlen_o, gruns);
    Py_DECREF(gruns);
    if (gx == NULL) {
      Py_DECREF(score_o);
      goto err;
    }
    PyObject* tx = NULL;
    if (atype == 0) {
      const int64_t* tm = tx_meta + s * 5;
      PyObject* tl = PyLong_FromLongLong((long long)tm[4]);
      if (tl == NULL) {
        Py_DECREF(score_o);
        Py_DECREF(gx);
        goto err;
      }
      PyObject* truns = runs_list(tx_runs, tx_off[s], tx_off[s + 1]);
      if (truns == NULL) {
        Py_DECREF(tl);
        Py_DECREF(score_o);
        Py_DECREF(gx);
        goto err;
      }
      tx = make_alignment(score_o, tm[0], tm[2], tm[1], tm[3], tl, xlen_o,
                          truns);
      Py_DECREF(truns);
      Py_DECREF(tl);
      if (tx == NULL) {
        Py_DECREF(score_o);
        Py_DECREF(gx);
        goto err;
      }
    }
    Py_DECREF(score_o); /* alignments hold their own refs */

    PyObject* ga = g_ga_t->tp_alloc(g_ga_t, 0);
    if (ga == NULL) {
      Py_DECREF(gx);
      Py_XDECREF(tx);
      goto err;
    }
    sset(ga, g_ga.gx_aln, gx);
    PyObject* at = PyTuple_GET_ITEM(aln_types, atype);
    Py_INCREF(at);
    sset(ga, g_ga.aln_type, at);
    PyObject* rn = PyList_GET_ITEM(ref_names, refid);
    Py_INCREF(rn);
    sset(ga, g_ga.ref_name, rn);
    PyObject* rs = PyList_GET_ITEM(ref_strands, refid);
    Py_INCREF(rs);
    sset(ga, g_ga.strand, rs);
    PyObject* pr = prim ? Py_True : Py_False;
    Py_INCREF(pr);
    sset(ga, g_ga.primary, pr);
    if (tx == NULL) {
      Py_INCREF(Py_None);
      sset(ga, g_ga.tx_aln, Py_None);
    } else {
      sset(ga, g_ga.tx_aln, tx);
    }
    if (atype == 0) {
      PyObject* v = PyLong_FromLongLong((long long)task_tx[ti]);
      if (v == NULL) {
        Py_DECREF(ga);
        goto err;
      }
      sset(ga, g_ga.tx_idx, v);
    } else {
      Py_INCREF(Py_None);
      sset(ga, g_ga.tx_idx, Py_None);
    }
    if (atype == 1) {
      PyObject* v = PyLong_FromLongLong((long long)gene);
      if (v == NULL) {
        Py_DECREF(ga);
        goto err;
      }
      sset(ga, g_ga.gene_idx, v);
    } else {
      Py_INCREF(Py_None);
      sset(ga, g_ga.gene_idx, Py_None);
    }
    int rc = PyList_Append(out, ga);
    Py_DECREF(ga);
    if (rc < 0) goto err;
  }
  PyMem_Free(len0);
  return n_fallback;
err:
  PyErr_Clear();
  /* roll every per-read list back to its pre-call length so the
   * Python fallback loop starts from an untouched `results` */
  for (Py_ssize_t i = 0; i < n_reads; ++i) {
    PyObject* lst = PyList_GET_ITEM(results, i);
    Py_ssize_t cur = PyList_GET_SIZE(lst);
    if (cur > len0[i] &&
        PyList_SetSlice(lst, len0[i], cur, NULL) < 0)
      PyErr_Clear();
  }
  PyMem_Free(len0);
  return -4;
}

/* elleflat.c — C-API flattener for the elle device engine.
 *
 * One pass over a history's op list produces the dense int64 arrays
 * the device analysis consumes (txn metadata, append/write rows, read
 * rows, flattened read elements), replacing the Python collect+Flat
 * loops that dominated the device path's host time. The capability
 * mirror is the same as jepsen_tpu_torch/gpu/elle_device.py (elle 0.2.1
 * behind jepsen/src/jepsen/tests/cycle/append.clj:6-27); this file is
 * an implementation detail of that module and must stay semantically
 * identical to its Python fallback (differential-tested).
 *
 * Loaded via ctypes.PyDLL (GIL held: we call the CPython C-API).
 * Handle-based interface: ef_flatten() walks the ops and returns an
 * opaque handle; the caller queries field lengths, memcpys each field
 * into a numpy buffer, fetches the interned key list, and frees the
 * handle. Status 1 = history not vectorizable (non-int values, too
 * many keys): caller falls back to the Python path.
 */

#include <Python.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define VAL_LIMIT (((int64_t)1) << 40)
#define KEY_LIMIT (((int64_t)1) << 23)
#define EF_MAXF 21

/* txn type codes — must match elle_device._TYPE_* */
#define T_OK 0
#define T_INFO 1
#define T_FAIL 2

typedef struct { int64_t *d; int64_t n, cap; } vec;

static int vpush(vec *v, int64_t x) {
    if (v->n == v->cap) {
        int64_t nc = v->cap ? v->cap * 2 : 1024;
        int64_t *nd = (int64_t *)realloc(v->d, (size_t)nc * 8);
        if (!nd) return -1;
        v->d = nd;
        v->cap = nc;
    }
    v->d[v->n++] = x;
    return 0;
}

/* per-key scratch (generation-stamped so it clears in O(1) per txn) */
typedef struct {
    int64_t *gen;
    int64_t *val;
    int64_t cap;
} kscratch;

static int kgrow(kscratch *s, int64_t kid) {
    if (kid < s->cap) return 0;
    int64_t nc = s->cap ? s->cap : 256;
    while (nc <= kid) nc *= 2;
    int64_t *ng = (int64_t *)realloc(s->gen, (size_t)nc * 8);
    if (!ng) return -1;
    memset(ng + s->cap, 0, (size_t)(nc - s->cap) * 8);
    s->gen = ng;
    int64_t *nv = (int64_t *)realloc(s->val, (size_t)nc * 8);
    if (!nv) return -1;
    s->val = nv;
    s->cap = nc;
    return 0;
}

typedef struct {
    vec f[EF_MAXF];
    PyObject *keys; /* list of key objects in intern order */
    int status;     /* 0 ok, 1 unvectorizable */
} ef_handle;

/* field ids — must match native/__init__.py */
enum {
    F_T_TYPE, F_T_PROC, F_T_INV, F_T_COMP, F_T_OPIDX,
    /* append kind */
    F_AP_TXN = 5, F_AP_KEY, F_AP_VAL,
    F_RD_TXN, F_RD_KEY, F_RD_LEN, F_RE_VALS, F_FLAG_RD,
    /* rw kind (t_* shared) */
    F_WR_TXN = 5, F_WR_KEY, F_WR_VAL, F_WR_NONFINAL,
    F_RW_RD_TXN, F_RW_RD_KEY, F_RW_RD_VAL,
    F_FR_TXN, F_FR_KEY, F_FR_PREV, F_FR_NEW,
    F_ER_TXN, F_ER_KEY, F_ER_VAL, F_INT_ROW, F_INT_EXPECTED
};

static PyObject *s_type, *s_process, *s_value;
static PyObject *s_invoke, *s_ok, *s_fail, *s_info;

static int ensure_names(void) {
    if (s_type) return 0;
    s_type = PyUnicode_InternFromString("type");
    s_process = PyUnicode_InternFromString("process");
    s_value = PyUnicode_InternFromString("value");
    s_invoke = PyUnicode_InternFromString("invoke");
    s_ok = PyUnicode_InternFromString("ok");
    s_fail = PyUnicode_InternFromString("fail");
    s_info = PyUnicode_InternFromString("info");
    return (s_type && s_process && s_value && s_invoke && s_ok &&
            s_fail && s_info) ? 0 : -1;
}

static void ef_free_handle(ef_handle *h) {
    if (!h) return;
    for (int i = 0; i < EF_MAXF; i++) free(h->f[i].d);
    Py_XDECREF(h->keys);
    free(h);
}

/* intern a key object -> dense id; returns -1 on python error,
 * -2 on overflow */
static int64_t intern_key(PyObject *kdict, PyObject *klist, PyObject *k) {
    PyObject *kid = PyDict_GetItemWithError(kdict, k); /* borrowed */
    if (kid) return PyLong_AsLongLong(kid);
    if (PyErr_Occurred()) return -1;
    int64_t id = PyList_GET_SIZE(klist);
    if (id >= KEY_LIMIT) return -2;
    kid = PyLong_FromLongLong(id);
    if (!kid) return -1;
    if (PyDict_SetItem(kdict, k, kid) < 0) { Py_DECREF(kid); return -1; }
    Py_DECREF(kid);
    if (PyList_Append(klist, k) < 0) return -1;
    return id;
}

/* exact machine int in [0, VAL_LIMIT), or -1 (unvectorizable) */
static int64_t as_val(PyObject *v) {
    if (!PyLong_CheckExact(v)) return -1;
    int overflow = 0;
    long long x = PyLong_AsLongLongAndOverflow(v, &overflow);
    if (overflow || x < 0 || x >= VAL_LIMIT) return -1;
    return (int64_t)x;
}

/* ---- per-txn mop walks ------------------------------------------------ */

typedef struct {
    ef_handle *h;
    PyObject *kdict;
    kscratch own;      /* append: own-append gen; rw: written gen */
    kscratch expected; /* rw */
    kscratch lastread; /* rw */
    kscratch erseen;   /* rw */
    kscratch prevw;    /* rw: previous nonfail write row per key */
} walk_state;

/* returns 0 ok, 1 unvectorizable, -1 python error */
static int walk_append_txn(walk_state *w, int64_t ti, int code,
                           PyObject *mops) {
    ef_handle *h = w->h;
    if (mops == Py_None) return 0;
    PyObject *fast = PySequence_Fast(mops, "mops not a sequence");
    if (!fast) { PyErr_Clear(); return 1; }
    Py_ssize_t nm = PySequence_Fast_GET_SIZE(fast);
    PyObject **items = PySequence_Fast_ITEMS(fast);
    int64_t g = ti + 1;
    int consider_reads = (code == T_OK);
    for (Py_ssize_t i = 0; i < nm; i++) {
        PyObject *mop = items[i];
        PyObject *mfast = PySequence_Fast(mop, "mop not a sequence");
        if (!mfast) { PyErr_Clear(); Py_DECREF(fast); return 1; }
        if (PySequence_Fast_GET_SIZE(mfast) < 3) {
            Py_DECREF(mfast); Py_DECREF(fast); return 1;
        }
        PyObject *f = PySequence_Fast_GET_ITEM(mfast, 0);
        PyObject *k = PySequence_Fast_GET_ITEM(mfast, 1);
        PyObject *v = PySequence_Fast_GET_ITEM(mfast, 2);
        int is_append = 0, is_r = 0;
        if (PyUnicode_Check(f)) {
            if (PyUnicode_CompareWithASCIIString(f, "append") == 0)
                is_append = 1;
            else if (PyUnicode_CompareWithASCIIString(f, "r") == 0)
                is_r = 1;
        }
        /* intern BEFORE the f dispatch: the Python flattener assigns
         * key ids to every mop, so unknown mop types must still claim
         * their intern slot or the two paths' key ids diverge */
        int64_t kid = intern_key(w->kdict, h->keys, k);
        if (kid == -1) { Py_DECREF(mfast); Py_DECREF(fast); return -1; }
        if (kid == -2) { Py_DECREF(mfast); Py_DECREF(fast); return 1; }
        if (!is_append && !is_r) { Py_DECREF(mfast); continue; }
        if (kgrow(&w->own, kid) < 0) {
            Py_DECREF(mfast); Py_DECREF(fast); return -1;
        }
        if (is_append) {
            int64_t x = as_val(v);
            if (x < 0) { Py_DECREF(mfast); Py_DECREF(fast); return 1; }
            if (vpush(&h->f[F_AP_TXN], ti) || vpush(&h->f[F_AP_KEY], kid)
                    || vpush(&h->f[F_AP_VAL], x)) {
                Py_DECREF(mfast); Py_DECREF(fast); return -1;
            }
            w->own.gen[kid] = g;
        } else { /* r */
            if (v == Py_None || !consider_reads) {
                Py_DECREF(mfast); continue;
            }
            PyObject *vf = PySequence_Fast(v, "read not a sequence");
            if (!vf) { PyErr_Clear(); Py_DECREF(mfast); Py_DECREF(fast);
                       return 1; }
            Py_ssize_t nv = PySequence_Fast_GET_SIZE(vf);
            PyObject **velems = PySequence_Fast_ITEMS(vf);
            for (Py_ssize_t j = 0; j < nv; j++) {
                int64_t x = as_val(velems[j]);
                if (x < 0) { Py_DECREF(vf); Py_DECREF(mfast);
                             Py_DECREF(fast); return 1; }
                if (vpush(&h->f[F_RE_VALS], x)) {
                    Py_DECREF(vf); Py_DECREF(mfast); Py_DECREF(fast);
                    return -1;
                }
            }
            int64_t row = h->f[F_RD_TXN].n;
            if (vpush(&h->f[F_RD_TXN], ti) || vpush(&h->f[F_RD_KEY], kid)
                    || vpush(&h->f[F_RD_LEN], (int64_t)nv)) {
                Py_DECREF(vf); Py_DECREF(mfast); Py_DECREF(fast);
                return -1;
            }
            /* txn appended this key earlier: python re-checks the
             * own-suffix rule for this read row */
            if (w->own.gen[kid] == g && vpush(&h->f[F_FLAG_RD], row)) {
                Py_DECREF(vf); Py_DECREF(mfast); Py_DECREF(fast);
                return -1;
            }
            Py_DECREF(vf);
        }
        Py_DECREF(mfast);
    }
    Py_DECREF(fast);
    return 0;
}

static int walk_rw_txn(walk_state *w, int64_t ti, int code,
                       PyObject *mops) {
    ef_handle *h = w->h;
    if (mops == Py_None) return 0;
    PyObject *fast = PySequence_Fast(mops, "mops not a sequence");
    if (!fast) { PyErr_Clear(); return 1; }
    Py_ssize_t nm = PySequence_Fast_GET_SIZE(fast);
    PyObject **items = PySequence_Fast_ITEMS(fast);
    int64_t g = ti + 1;
    int ok = (code == T_OK), nonfail = (code != T_FAIL);
    int rc = 0;
    for (Py_ssize_t i = 0; i < nm && rc == 0; i++) {
        PyObject *mfast = PySequence_Fast(items[i], "mop");
        if (!mfast) { PyErr_Clear(); rc = 1; break; }
        if (PySequence_Fast_GET_SIZE(mfast) < 3) {
            Py_DECREF(mfast); rc = 1; break;
        }
        PyObject *f = PySequence_Fast_GET_ITEM(mfast, 0);
        PyObject *k = PySequence_Fast_GET_ITEM(mfast, 1);
        PyObject *v = PySequence_Fast_GET_ITEM(mfast, 2);
        int is_w = 0, is_r = 0;
        if (PyUnicode_Check(f)) {
            if (PyUnicode_CompareWithASCIIString(f, "w") == 0) is_w = 1;
            else if (PyUnicode_CompareWithASCIIString(f, "r") == 0)
                is_r = 1;
        }
        /* intern before the f dispatch — key-id parity with the
         * Python flattener (see walk_append_txn) */
        int64_t kid = intern_key(w->kdict, h->keys, k);
        if (kid == -1) { Py_DECREF(mfast); rc = -1; break; }
        if (kid == -2) { Py_DECREF(mfast); rc = 1; break; }
        if (!is_w && !is_r) { Py_DECREF(mfast); continue; }
        if (kgrow(&w->own, kid) < 0 || kgrow(&w->expected, kid) < 0
                || kgrow(&w->lastread, kid) < 0
                || kgrow(&w->erseen, kid) < 0
                || kgrow(&w->prevw, kid) < 0) {
            Py_DECREF(mfast); rc = -1; break;
        }
        if (is_w) {
            int64_t x = as_val(v);
            if (x < 0) { Py_DECREF(mfast); rc = 1; break; }
            int64_t row = h->f[F_WR_TXN].n;
            if (vpush(&h->f[F_WR_TXN], ti) || vpush(&h->f[F_WR_KEY], kid)
                    || vpush(&h->f[F_WR_VAL], x)) {
                Py_DECREF(mfast); rc = -1; break;
            }
            if (nonfail) {
                if (w->prevw.gen[kid] == g
                        && vpush(&h->f[F_WR_NONFINAL],
                                 w->prevw.val[kid])) {
                    Py_DECREF(mfast); rc = -1; break;
                }
                w->prevw.gen[kid] = g;
                w->prevw.val[kid] = row;
            }
            if (ok) {
                if (w->lastread.gen[kid] == g) {
                    if (vpush(&h->f[F_FR_TXN], ti)
                            || vpush(&h->f[F_FR_KEY], kid)
                            || vpush(&h->f[F_FR_PREV],
                                     w->lastread.val[kid])
                            || vpush(&h->f[F_FR_NEW], x)) {
                        Py_DECREF(mfast); rc = -1; break;
                    }
                    w->lastread.gen[kid] = 0; /* one-shot pop */
                }
                w->expected.gen[kid] = g;
                w->expected.val[kid] = x;
            }
            w->own.gen[kid] = g; /* written */
        } else if (ok) { /* r, committed txn */
            if (v == Py_None) {
                /* a None first read IS the key's external read */
                if (w->own.gen[kid] != g) w->erseen.gen[kid] = g;
                Py_DECREF(mfast); continue;
            }
            int64_t x = as_val(v);
            if (x < 0) { Py_DECREF(mfast); rc = 1; break; }
            int64_t row = h->f[F_RW_RD_TXN].n;
            if (vpush(&h->f[F_RW_RD_TXN], ti)
                    || vpush(&h->f[F_RW_RD_KEY], kid)
                    || vpush(&h->f[F_RW_RD_VAL], x)) {
                Py_DECREF(mfast); rc = -1; break;
            }
            if (w->expected.gen[kid] == g && w->expected.val[kid] != x) {
                if (vpush(&h->f[F_INT_ROW], row)
                        || vpush(&h->f[F_INT_EXPECTED],
                                 w->expected.val[kid])) {
                    Py_DECREF(mfast); rc = -1; break;
                }
            }
            w->expected.gen[kid] = g;
            w->expected.val[kid] = x;
            w->lastread.gen[kid] = g;
            w->lastread.val[kid] = x;
            if (w->own.gen[kid] != g && w->erseen.gen[kid] != g) {
                w->erseen.gen[kid] = g;
                if (vpush(&h->f[F_ER_TXN], ti)
                        || vpush(&h->f[F_ER_KEY], kid)
                        || vpush(&h->f[F_ER_VAL], x)) {
                    Py_DECREF(mfast); rc = -1; break;
                }
            }
        }
        Py_DECREF(mfast);
    }
    Py_DECREF(fast);
    return rc;
}

/* ---- main walk -------------------------------------------------------- */

/* kind: 0 = list-append, 1 = rw-register.
 * Returns a handle, or NULL on allocation/python error (caller falls
 * back to the Python flattener). */
void *ef_flatten(PyObject *ops, int64_t kind) {
    /* every NULL return must leave the error indicator CLEAR: under
     * ctypes.PyDLL a pending exception would be raised from ef_flatten
     * itself, bypassing the caller's RuntimeError -> Python-fallback
     * contract (the fail: label below does the same) */
    if (ensure_names() < 0) { PyErr_Clear(); return NULL; }
    if (!PyList_Check(ops)) { PyErr_Clear(); return NULL; }
    ef_handle *h = (ef_handle *)calloc(1, sizeof(ef_handle));
    if (!h) { PyErr_Clear(); return NULL; }
    h->keys = PyList_New(0);
    PyObject *kdict = NULL, *open = NULL;
    walk_state w;
    memset(&w, 0, sizeof(w));
    w.h = h;
    if (!h->keys) goto fail;
    kdict = PyDict_New();
    open = PyDict_New(); /* process -> invoke pos */
    if (!kdict || !open) goto fail;
    w.kdict = kdict;

    Py_ssize_t n = PyList_GET_SIZE(ops);
    for (Py_ssize_t pos = 0; pos < n; pos++) {
        PyObject *op = PyList_GET_ITEM(ops, pos);
        PyObject *proc = PyObject_GetAttr(op, s_process);
        if (!proc) goto fail;
        if (!PyLong_Check(proc)) { Py_DECREF(proc); continue; }
        PyObject *typ = PyObject_GetAttr(op, s_type);
        if (!typ) { Py_DECREF(proc); goto fail; }
        int code = -1;
        if (!PyUnicode_Check(typ)) {
            /* non-string type: skip the op like the host path does —
             * PyUnicode_CompareWithASCIIString on a non-string is
             * undefined behavior (mirrors the mop `f` guard) */
            Py_DECREF(typ); Py_DECREF(proc);
            continue;
        }
        if (typ == s_invoke
                || PyUnicode_CompareWithASCIIString(typ, "invoke") == 0) {
            PyObject *pp = PyLong_FromSsize_t(pos);
            int r = pp ? PyDict_SetItem(open, proc, pp) : -1;
            Py_XDECREF(pp);
            Py_DECREF(typ); Py_DECREF(proc);
            if (r < 0) goto fail;
            continue;
        } else if (typ == s_ok
                || PyUnicode_CompareWithASCIIString(typ, "ok") == 0) {
            code = T_OK;
        } else if (typ == s_info
                || PyUnicode_CompareWithASCIIString(typ, "info") == 0) {
            code = T_INFO;
        } else if (typ == s_fail
                || PyUnicode_CompareWithASCIIString(typ, "fail") == 0) {
            code = T_FAIL;
        }
        Py_DECREF(typ);
        if (code < 0) { Py_DECREF(proc); continue; }
        PyObject *ip = PyDict_GetItemWithError(open, proc); /* borrowed */
        if (!ip) {
            Py_DECREF(proc);
            if (PyErr_Occurred()) goto fail;
            continue;
        }
        int64_t inv_pos = PyLong_AsLongLong(ip);
        int64_t pv = PyLong_AsLongLong(proc);
        if (PyDict_DelItem(open, proc) < 0) { Py_DECREF(proc); goto fail; }
        Py_DECREF(proc);
        /* mops: completion value for ok (unless None), else invoke's */
        PyObject *mops = NULL;
        if (code == T_OK) {
            mops = PyObject_GetAttr(op, s_value);
            if (!mops) goto fail;
            if (mops == Py_None) { Py_DECREF(mops); mops = NULL; }
        }
        if (!mops) {
            PyObject *inv_op = PyList_GET_ITEM(ops, (Py_ssize_t)inv_pos);
            mops = PyObject_GetAttr(inv_op, s_value);
            if (!mops) goto fail;
        }
        int64_t ti = h->f[F_T_TYPE].n;
        if (vpush(&h->f[F_T_TYPE], code) || vpush(&h->f[F_T_PROC], pv)
                || vpush(&h->f[F_T_INV], inv_pos)
                || vpush(&h->f[F_T_COMP], pos)
                || vpush(&h->f[F_T_OPIDX], pos)) {
            Py_DECREF(mops); goto fail;
        }
        int rc = kind ? walk_rw_txn(&w, ti, code, mops)
                      : walk_append_txn(&w, ti, code, mops);
        Py_DECREF(mops);
        if (rc < 0) goto fail;
        if (rc > 0) { h->status = 1; goto done; }
    }
    /* leftover open invocations -> indeterminate txns, insertion order */
    {
        Py_ssize_t ppos = 0;
        PyObject *pk, *pval;
        while (PyDict_Next(open, &ppos, &pk, &pval)) {
            int64_t inv_pos = PyLong_AsLongLong(pval);
            int64_t pv = PyLong_AsLongLong(pk);
            PyObject *inv_op = PyList_GET_ITEM(ops, (Py_ssize_t)inv_pos);
            PyObject *mops = PyObject_GetAttr(inv_op, s_value);
            if (!mops) goto fail;
            int64_t ti = h->f[F_T_TYPE].n;
            if (vpush(&h->f[F_T_TYPE], T_INFO)
                    || vpush(&h->f[F_T_PROC], pv)
                    || vpush(&h->f[F_T_INV], inv_pos)
                    || vpush(&h->f[F_T_COMP], ((int64_t)1) << 60)
                    || vpush(&h->f[F_T_OPIDX], inv_pos)) {
                Py_DECREF(mops); goto fail;
            }
            int rc = kind ? walk_rw_txn(&w, ti, T_INFO, mops)
                          : walk_append_txn(&w, ti, T_INFO, mops);
            Py_DECREF(mops);
            if (rc < 0) goto fail;
            if (rc > 0) { h->status = 1; goto done; }
        }
    }
done:
    Py_DECREF(kdict);
    Py_DECREF(open);
    free(w.own.gen); free(w.own.val);
    free(w.expected.gen); free(w.expected.val);
    free(w.lastread.gen); free(w.lastread.val);
    free(w.erseen.gen); free(w.erseen.val);
    free(w.prevw.gen); free(w.prevw.val);
    return h;
fail:
    PyErr_Clear();
    Py_XDECREF(kdict);
    Py_XDECREF(open);
    free(w.own.gen); free(w.own.val);
    free(w.expected.gen); free(w.expected.val);
    free(w.lastread.gen); free(w.lastread.val);
    free(w.erseen.gen); free(w.erseen.val);
    free(w.prevw.gen); free(w.prevw.val);
    ef_free_handle(h);
    return NULL;
}

int64_t ef_status(void *hp) { return ((ef_handle *)hp)->status; }

int64_t ef_len(void *hp, int64_t field) {
    if (field < 0 || field >= EF_MAXF) return -1;
    return ((ef_handle *)hp)->f[field].n;
}

void ef_copy(void *hp, int64_t field, int64_t *dest) {
    ef_handle *h = (ef_handle *)hp;
    if (field < 0 || field >= EF_MAXF) return;
    memcpy(dest, h->f[field].d, (size_t)h->f[field].n * 8);
}

/* returns a NEW reference (ctypes py_object restype takes ownership) */
PyObject *ef_keys(void *hp) {
    PyObject *k = ((ef_handle *)hp)->keys;
    Py_INCREF(k);
    return k;
}

void ef_free(void *hp) { ef_free_handle((ef_handle *)hp); }

/* C-ABI embedding shim of the PyTorch/CUDA port: hosts CPython and
 * forwards the vsearch_api.h session protocol (reference
 * src/vsearch_api.h:60-124) to vsearch_tpu_torch.api.  See
 * vsearch_tpu_torch_api.h for the contract.
 *
 * Built by vsearch_tpu_torch/capi.py (cc, against the shared libpython of
 * the interpreter that builds it) into build/vsearch_tpu_torch/capi/. */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <string.h>

#include "vsearch_tpu_torch_api.h"

static PyObject *g_api = NULL;      /* vsearch_tpu_torch.api module */
static PyObject *g_params_mod = NULL;

typedef struct {
    PyObject *session;              /* api.SearchSession */
    PyObject *db;                   /* api.Database */
    PyObject *lock;                 /* threading.Lock: one search a time */
} search_handle_t;

static int report(const char *where)
{
    fprintf(stderr, "vsearch_tpu_torch_capi: error in %s\n", where);
    if (PyErr_Occurred())
        PyErr_Print();
    return -1;
}

/* the modules are imported (vstpu_api_init ran); call with the GIL */
static int ready(const char *where)
{
    if (g_api != NULL && g_params_mod != NULL)
        return 1;
    fprintf(stderr, "vsearch_tpu_torch_capi: %s before vstpu_api_init\n",
            where);
    return 0;
}

int vstpu_api_init(void)
{
    if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
        /* Py_InitializeEx returns with this thread holding the GIL.  Give
         * it back: every entry point takes it per call, and an embedder
         * whose main thread initializes and then joins threads that
         * search would otherwise wait for ever. */
        PyEval_SaveThread();
    }
    PyGILState_STATE g = PyGILState_Ensure();
    int version = -1;
    if (g_api == NULL) {
        g_api = PyImport_ImportModule("vsearch_tpu_torch.api");
        g_params_mod = PyImport_ImportModule("vsearch_tpu_torch.params");
    }
    if (g_api == NULL || g_params_mod == NULL) {
        report("vstpu_api_init (are vsearch_tpu_torch and torch on "
               "PYTHONPATH?)");
        Py_CLEAR(g_api);
        Py_CLEAR(g_params_mod);
        PyGILState_Release(g);
        return -1;
    }
    PyObject *v = PyObject_CallMethod(g_api, "api_version", NULL);
    if (v != NULL) {
        version = (int) PyLong_AsLong(v);
        Py_DECREF(v);
    } else {
        report("api_version");
    }
    PyGILState_Release(g);
    return version;
}

void vstpu_api_finalize(void)
{
    /* Leave the interpreter running: a CUDA context does not survive a
     * second interpreter start, and the reference supports sequential
     * sessions in one process (vsearch_api.h "Re-initialization").  Drop
     * the module references only. */
    if (!Py_IsInitialized())
        return;
    PyGILState_STATE g = PyGILState_Ensure();
    Py_CLEAR(g_api);
    Py_CLEAR(g_params_mod);
    PyGILState_Release(g);
}

void *vstpu_params_new(void)
{
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject *p = NULL;
    if (ready("vstpu_params_new")) {
        p = PyObject_CallMethod(g_params_mod, "Parameters", NULL);
        if (p == NULL)
            report("vstpu_params_new");
    }
    PyGILState_Release(g);
    return (void *) p;
}

/* sets params.opt_<opt>; takes ownership of value; call with the GIL */
static int params_set(void *params, const char *opt, PyObject *value)
{
    char name[128];
    int rc = 0;
    if (value == NULL)
        return report("params_set value");
    snprintf(name, sizeof name, "opt_%s", opt);
    if (PyObject_SetAttrString((PyObject *) params, name, value) != 0)
        rc = report("vstpu_params_set");
    Py_DECREF(value);
    return rc;
}

int vstpu_params_set_num(void *params, const char *opt, double value)
{
    PyGILState_STATE g = PyGILState_Ensure();
    /* integer-typed options receive ints (the Parameters dataclass
     * fields are int or float; match the current field's type) */
    char name[128];
    snprintf(name, sizeof name, "opt_%s", opt);
    PyObject *old = PyObject_GetAttrString((PyObject *) params, name);
    PyObject *v;
    if (old != NULL && PyLong_Check(old)
        && value == (double) (long long) value)
        v = PyLong_FromLongLong((long long) value);
    else
        v = PyFloat_FromDouble(value);
    Py_XDECREF(old);
    PyErr_Clear();
    int rc = params_set(params, opt, v);
    PyGILState_Release(g);
    return rc;
}

int vstpu_params_set_str(void *params, const char *opt, const char *value)
{
    PyGILState_STATE g = PyGILState_Ensure();
    int rc = params_set(params, opt, PyUnicode_FromString(value));
    PyGILState_Release(g);
    return rc;
}

void vstpu_params_free(void *params)
{
    if (params == NULL)
        return;
    PyGILState_STATE g = PyGILState_Ensure();
    Py_DECREF((PyObject *) params);
    PyGILState_Release(g);
}

int vstpu_session_begin(void *params)
{
    PyGILState_STATE g = PyGILState_Ensure();
    int rc = -1;
    if (ready("vstpu_session_begin")) {
        /* no device argument: cuda unless VSEARCH_TPU_TORCH_DEVICE=cpu,
         * as the port's command line; a try-lock, so a second begin
         * returns -1 instead of blocking */
        PyObject *r = PyObject_CallMethod(g_api, "session_begin", "O",
                                          (PyObject *) params);
        rc = r ? 0 : report("vstpu_session_begin");
        Py_XDECREF(r);
    }
    PyGILState_Release(g);
    return rc;
}

int vstpu_session_end(void)
{
    PyGILState_STATE g = PyGILState_Ensure();
    int rc = -1;
    if (ready("vstpu_session_end")) {
        PyObject *r = PyObject_CallMethod(g_api, "session_end", NULL);
        rc = r ? 0 : report("vstpu_session_end");
        Py_XDECREF(r);
    }
    PyGILState_Release(g);
    return rc;
}

void *vstpu_search_open(void *params, const char *db_path)
{
    PyGILState_STATE g = PyGILState_Ensure();
    search_handle_t *h = NULL;
    PyObject *pair = NULL, *sess = NULL, *lock = NULL, *threading = NULL;
    if (!ready("vstpu_search_open"))
        goto out;
    pair = PyObject_CallMethod(g_api, "read_database", "sO", db_path,
                               (PyObject *) params);
    if (pair == NULL) {
        report("read_database");
        goto out;
    }
    PyObject *db = PyTuple_GetItem(pair, 0);       /* borrowed */
    PyObject *index = PyTuple_GetItem(pair, 1);
    sess = PyObject_CallMethod(g_api, "SearchSession", "OOO",
                               (PyObject *) params, db, index);
    if (sess == NULL) {
        report("SearchSession");
        goto out;
    }
    threading = PyImport_ImportModule("threading");
    lock = threading ? PyObject_CallMethod(threading, "Lock", NULL) : NULL;
    if (lock == NULL) {
        report("threading.Lock");
        goto out;
    }
    h = (search_handle_t *) malloc(sizeof *h);
    if (h == NULL)
        goto out;
    Py_INCREF(db);
    h->session = sess;
    h->db = db;
    h->lock = lock;
    sess = lock = NULL;
out:
    Py_XDECREF(pair);
    Py_XDECREF(sess);
    Py_XDECREF(lock);
    Py_XDECREF(threading);
    PyGILState_Release(g);
    return (void *) h;
}

/* obj.<name> as a C long (-1 with an exception set on failure) */
static long get_long(PyObject *obj, const char *name)
{
    PyObject *v = PyObject_GetAttrString(obj, name);
    long r = v ? PyLong_AsLong(v) : -1;
    Py_XDECREF(v);
    return r;
}

/* one api.SearchResult into a vstpu_hit_t; -1 with an exception set on
 * failure */
static int marshal_hit(search_handle_t *h, PyObject *r, vstpu_hit_t *o)
{
    memset(o, 0, sizeof *o);
    o->target = get_long(r, "target");
    o->matches = get_long(r, "matches");
    o->mismatches = get_long(r, "mismatches");
    o->gaps = get_long(r, "gaps");
    o->alignment_length = get_long(r, "alignment_length");
    o->query_length = get_long(r, "query_length");
    o->target_length = get_long(r, "target_length");
    o->strand = (int) get_long(r, "strand");
    PyObject *tmp = PyObject_GetAttrString(r, "id");
    if (tmp != NULL) {
        o->id = PyFloat_AsDouble(tmp);
        Py_DECREF(tmp);
    }
    if (PyErr_Occurred())
        return -1;
    tmp = PyObject_GetAttrString(r, "cigar");
    const char *c = tmp ? PyUnicode_AsUTF8(tmp) : NULL;
    if (c != NULL)
        snprintf(o->cigar, sizeof o->cigar, "%s", c);
    Py_XDECREF(tmp);
    if (c == NULL)
        return -1;
    PyObject *lbl = PyObject_CallMethod(h->db, "getheader", "l", o->target);
    char *buf;
    Py_ssize_t len;
    if (lbl == NULL || PyBytes_AsStringAndSize(lbl, &buf, &len) != 0) {
        Py_XDECREF(lbl);
        return -1;
    }
    size_t m = (size_t) len < sizeof o->target_label - 1
        ? (size_t) len : sizeof o->target_label - 1;
    memcpy(o->target_label, buf, m);
    o->target_label[m] = '\0';
    Py_DECREF(lbl);
    return 0;
}

int vstpu_search_single(void *handle, const char *header,
                        const char *sequence, vstpu_hit_t *out, int cap)
{
    search_handle_t *h = (search_handle_t *) handle;
    if (h == NULL)
        return -1;
    PyGILState_STATE g = PyGILState_Ensure();
    int n = -1;
    /* the session's batch state is one query's at a time: acquire gives
     * the GIL back while it waits, so the other callers run on */
    PyObject *held = PyObject_CallMethod(h->lock, "acquire", NULL);
    if (held == NULL) {
        report("search lock");
        goto out;
    }
    Py_DECREF(held);
    PyObject *hits = PyObject_CallMethod(h->session, "search", "yy",
                                         header, sequence);
    if (hits == NULL || !PyList_Check(hits)) {
        report("search");
        Py_XDECREF(hits);
        goto unlock;
    }
    Py_ssize_t cnt = PyList_Size(hits);
    n = 0;
    for (Py_ssize_t i = 0; i < cnt && n < cap; i++) {
        if (marshal_hit(h, PyList_GetItem(hits, i), &out[n]) != 0) {
            report("search result");
            n = -1;
            break;
        }
        n++;
    }
    Py_DECREF(hits);
unlock:
    held = PyObject_CallMethod(h->lock, "release", NULL);
    if (held == NULL)
        n = report("search unlock");
    Py_XDECREF(held);
out:
    PyGILState_Release(g);
    return n;
}

void vstpu_search_close(void *handle)
{
    search_handle_t *h = (search_handle_t *) handle;
    if (h == NULL)
        return;
    PyGILState_STATE g = PyGILState_Ensure();
    Py_XDECREF(h->session);
    Py_XDECREF(h->db);
    Py_XDECREF(h->lock);
    PyGILState_Release(g);
    free(h);
}

int vstpu_dust_single(const char *sequence, char *out, int cap)
{
    PyGILState_STATE g = PyGILState_Ensure();
    int n = -1;
    if (!ready("vstpu_dust_single"))
        goto done;
    PyObject *r = PyObject_CallMethod(g_api, "dust_single", "y", sequence);
    if (r == NULL) {
        report("dust_single");
        goto done;
    }
    char *buf;
    Py_ssize_t len;
    if (PyBytes_AsStringAndSize(r, &buf, &len) == 0 && len < cap) {
        memcpy(out, buf, (size_t) len);
        out[len] = '\0';
        n = (int) len;
    }
    PyErr_Clear();
    Py_DECREF(r);
done:
    PyGILState_Release(g);
    return n;
}

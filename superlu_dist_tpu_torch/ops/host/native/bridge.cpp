// C ABI bridge: embedded-CPython shim over the Python solver core.
//
// The reference exposes its expert drivers through a plain-C handle API
// (reference: PYTHON/pdbridge.{h,c} — there C is the core and Python the
// guest; here the core is Python/PyTorch so the shim runs the interpreter
// in-process and marshals raw pointers as numpy views). The whole state
// machine (handle registry, options parsing, SparseLU lifetime, the
// device) lives in superlu_dist_tpu_torch/utils/cbridge.py; this file
// only moves pointers. The interpreter is started on the first call and
// never finalized.

#include <Python.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

#include "superlu_dist_tpu_torch.h"

namespace {

std::string g_error;

void set_error_from_python() {
    PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
    PyErr_Fetch(&type, &value, &tb);
    PyErr_NormalizeException(&type, &value, &tb);
    g_error = "python error";
    if (value) {
        PyObject *s = PyObject_Str(value);
        if (s) {
            const char *c = PyUnicode_AsUTF8(s);
            if (c) g_error = c;
            Py_DECREF(s);
        }
    }
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(tb);
}

// RAII interpreter + GIL acquisition for every entry point.
struct Gil {
    PyGILState_STATE st;
    Gil() {
        if (!Py_IsInitialized()) {
            Py_InitializeEx(0);
            // release the GIL acquired by initialization so that
            // PyGILState_Ensure below works from any thread
            PyEval_SaveThread();
        }
        st = PyGILState_Ensure();
    }
    ~Gil() { PyGILState_Release(st); }
};

PyObject *cbridge() {
    static PyObject *mod = nullptr;
    if (!mod) {
        mod = PyImport_ImportModule("superlu_dist_tpu_torch.utils.cbridge");
        if (!mod) set_error_from_python();
    }
    return mod;
}

PyObject *np_frombuffer(const void *ptr, int64_t count, size_t itemsize,
                        const char *dtype, bool writable) {
    static PyObject *np = nullptr;
    if (!np) {
        np = PyImport_ImportModule("numpy");
        if (!np) {
            set_error_from_python();
            return nullptr;
        }
    }
    PyObject *mv = PyMemoryView_FromMemory(
        reinterpret_cast<char *>(const_cast<void *>(ptr)),
        static_cast<Py_ssize_t>(count * itemsize),
        writable ? PyBUF_WRITE : PyBUF_READ);
    if (!mv) {
        set_error_from_python();
        return nullptr;
    }
    PyObject *arr = PyObject_CallMethod(np, "frombuffer", "(Os)", mv, dtype);
    Py_DECREF(mv);
    if (!arr) set_error_from_python();
    return arr;
}

void record_py_error_string(PyObject *mod) {
    // prefer the python-side error message when available
    PyObject *msg = PyObject_CallMethod(mod, "last_error", nullptr);
    if (msg) {
        const char *c = PyUnicode_AsUTF8(msg);
        if (c && c[0]) g_error = c;
        Py_DECREF(msg);
    } else {
        PyErr_Clear();
    }
}

}  // namespace

extern "C" {

const char *slu_tpu_last_error(void) { return g_error.c_str(); }

int64_t slu_tpu_init(int64_t n, const int64_t *colptr,
                     const int64_t *rowind, const double *nzval_re,
                     const double *nzval_im, int64_t nnz) {
    Gil gil;
    PyObject *mod = cbridge();
    if (!mod) return 0;
    PyObject *cp = np_frombuffer(colptr, n + 1, 8, "int64", false);
    PyObject *ri = np_frombuffer(rowind, nnz, 8, "int64", false);
    PyObject *vr = np_frombuffer(nzval_re, nnz, 8, "float64", false);
    PyObject *vi = nzval_im
        ? np_frombuffer(nzval_im, nnz, 8, "float64", false)
        : (Py_INCREF(Py_None), Py_None);
    if (!cp || !ri || !vr || !vi) {
        Py_XDECREF(cp); Py_XDECREF(ri); Py_XDECREF(vr); Py_XDECREF(vi);
        return 0;
    }
    PyObject *res = PyObject_CallMethod(mod, "init", "(LOOOO)",
                                        (long long)n, cp, ri, vr, vi);
    Py_DECREF(cp); Py_DECREF(ri); Py_DECREF(vr); Py_DECREF(vi);
    if (!res) {
        set_error_from_python();
        return 0;
    }
    int64_t h = PyLong_AsLongLong(res);
    Py_DECREF(res);
    if (h == 0) record_py_error_string(mod);
    return h;
}

int64_t slu_tpu_read_matrix(const char *path) {
    Gil gil;
    PyObject *mod = cbridge();
    if (!mod) return 0;
    PyObject *res = PyObject_CallMethod(mod, "read_matrix", "(s)", path);
    if (!res) {
        set_error_from_python();
        return 0;
    }
    int64_t h = PyLong_AsLongLong(res);
    Py_DECREF(res);
    if (h == 0) record_py_error_string(mod);
    return h;
}

int64_t slu_tpu_n(int64_t handle) {
    Gil gil;
    PyObject *mod = cbridge();
    if (!mod) return -1;
    PyObject *res = PyObject_CallMethod(mod, "handle_n", "(L)",
                                        (long long)handle);
    if (!res) {
        set_error_from_python();
        return -1;
    }
    int64_t n = PyLong_AsLongLong(res);
    Py_DECREF(res);
    return n;
}

int32_t slu_tpu_factor(int64_t handle, const char *options_json) {
    Gil gil;
    PyObject *mod = cbridge();
    if (!mod) return -1;
    PyObject *res = PyObject_CallMethod(
        mod, "factor", "(Ls)", (long long)handle,
        options_json ? options_json : "");
    if (!res) {
        set_error_from_python();
        return -1;
    }
    long info = PyLong_AsLong(res);
    Py_DECREF(res);
    if (info < 0) record_py_error_string(mod);
    return (int32_t)info;
}

int32_t slu_tpu_solve(int64_t handle, double *b, int64_t nrhs,
                      int32_t trans, int32_t refine) {
    Gil gil;
    PyObject *mod = cbridge();
    if (!mod) return -1;
    int64_t n = slu_tpu_n(handle);
    if (n < 0) return -1;
    PyObject *bv = np_frombuffer(b, n * nrhs, 8, "float64", true);
    if (!bv) return -1;
    PyObject *res = PyObject_CallMethod(
        mod, "solve", "(LOLii)", (long long)handle, bv, (long long)nrhs,
        (int)trans, (int)(refine != 0));
    Py_DECREF(bv);
    if (!res) {
        set_error_from_python();
        return -1;
    }
    long rc = PyLong_AsLong(res);
    Py_DECREF(res);
    if (rc != 0) record_py_error_string(mod);
    return (int32_t)rc;
}

int32_t slu_tpu_matvec(int64_t handle, const double *x, double *out) {
    Gil gil;
    PyObject *mod = cbridge();
    if (!mod) return -1;
    int64_t n = slu_tpu_n(handle);
    if (n < 0) return -1;
    PyObject *xv = np_frombuffer(x, n, 8, "float64", false);
    PyObject *ov = np_frombuffer(out, n, 8, "float64", true);
    if (!xv || !ov) {
        Py_XDECREF(xv); Py_XDECREF(ov);
        return -1;
    }
    PyObject *res = PyObject_CallMethod(mod, "matvec", "(LOO)",
                                        (long long)handle, xv, ov);
    Py_DECREF(xv); Py_DECREF(ov);
    if (!res) {
        set_error_from_python();
        return -1;
    }
    long rc = PyLong_AsLong(res);
    Py_DECREF(res);
    if (rc != 0) record_py_error_string(mod);
    return (int32_t)rc;
}

int32_t slu_tpu_logdet(int64_t handle, double *sign_re, double *sign_im,
                       double *logabs) {
    Gil gil;
    PyObject *mod = cbridge();
    if (!mod) return -1;
    PyObject *res = PyObject_CallMethod(mod, "logdet", "(L)",
                                        (long long)handle);
    if (!res) {
        set_error_from_python();
        return -1;
    }
    double sr = 0, si = 0, la = 0;
    if (!PyArg_ParseTuple(res, "ddd", &sr, &si, &la)) {
        Py_DECREF(res);
        set_error_from_python();
        return -1;
    }
    Py_DECREF(res);
    if (sign_re) *sign_re = sr;
    if (sign_im) *sign_im = si;
    if (logabs) *logabs = la;
    return (sr == 0.0 && si == 0.0) ? -1 : 0;
}

void slu_tpu_free(int64_t handle) {
    Gil gil;
    PyObject *mod = cbridge();
    if (!mod) return;
    PyObject *res = PyObject_CallMethod(mod, "free", "(L)",
                                        (long long)handle);
    Py_XDECREF(res);
    if (!res) PyErr_Clear();
}

}  // extern "C"

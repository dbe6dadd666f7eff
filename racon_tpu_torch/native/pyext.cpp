// CPython extension wrapper over the native overlap parser (the port's
// copy of racon_tpu/native/pyext.cpp).
//
// It is there for parity with the JAX package, whose parse_ovlfile
// prefers its extension: the field tuples are built with the direct C
// API rather than through ctypes, the reference bioparser's class
// (src/polisher.cpp:83-133). The two routes' speeds have not been
// measured in the port.
//
// The port's parse_ovlfile returns one field tuple per record, so this
// copy returns the tuples themselves (the JAX extension wraps each in a
// (fmt, fields) record); the fields are the ctypes route's and the Python
// oracle's, field for field.
//
// Compiled together with parsers.cpp into its own module
// (racon_torch_native_ext.so, beside the ctypes library in build/native);
// racon_tpu_torch.native.parse_ovlfile prefers it wherever Python's
// headers exist.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstdlib>

extern "C" int64_t rt_parse_ovlfile(const char* path, int32_t fmt,
                                    char** blob_out, int64_t** soffs_out,
                                    double** nums_out, char* err);

namespace {

PyObject* g_plus = nullptr;   // cached "+" / "-" strand strings — one
PyObject* g_minus = nullptr;  // allocation per record saved

PyObject* py_parse_ovlfile(PyObject*, PyObject* args) {
    const char* path;
    int fmt;
    if (!PyArg_ParseTuple(args, "si", &path, &fmt)) return nullptr;
    if (fmt < 0 || fmt > 2) {
        PyErr_SetString(PyExc_ValueError, "fmt must be 0 (PAF), 1 (MHAP) "
                                          "or 2 (SAM)");
        return nullptr;
    }
    char* blob = nullptr;
    int64_t* so = nullptr;
    double* nu = nullptr;
    char err[256];
    int64_t n;
    Py_BEGIN_ALLOW_THREADS
    n = rt_parse_ovlfile(path, fmt, &blob, &so, &nu, err);
    Py_END_ALLOW_THREADS
    if (n < 0) {
        PyErr_SetString(PyExc_ValueError, err);
        return nullptr;
    }
    static const int NS[3] = {2, 0, 3};
    const int ns = NS[fmt];
    PyObject* list = PyList_New((Py_ssize_t)n);
    if (!list) goto fail;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t* s = so + 2 * ns * i;
        PyObject* t = nullptr;
        if (fmt == 0) {
            const double* v = nu + 7 * i;
            t = PyTuple_New(9);
            if (!t) goto fail_list;
            int b = (int)v[3];
            char sc = (char)b;
            PyTuple_SET_ITEM(t, 0, PyBytes_FromStringAndSize(
                blob + s[0], (Py_ssize_t)s[1]));
            PyTuple_SET_ITEM(t, 1, PyLong_FromLongLong((long long)v[0]));
            PyTuple_SET_ITEM(t, 2, PyLong_FromLongLong((long long)v[1]));
            PyTuple_SET_ITEM(t, 3, PyLong_FromLongLong((long long)v[2]));
            PyObject* strand;
            if (b == '+') {
                strand = g_plus;
                Py_INCREF(strand);
            } else if (b == '-') {
                strand = g_minus;
                Py_INCREF(strand);
            } else {
                strand = PyUnicode_FromStringAndSize(&sc, b ? 1 : 0);
                if (!strand) {
                    Py_DECREF(t);
                    goto fail_list;
                }
            }
            PyTuple_SET_ITEM(t, 4, strand);
            PyTuple_SET_ITEM(t, 5, PyBytes_FromStringAndSize(
                blob + s[2], (Py_ssize_t)s[3]));
            PyTuple_SET_ITEM(t, 6, PyLong_FromLongLong((long long)v[4]));
            PyTuple_SET_ITEM(t, 7, PyLong_FromLongLong((long long)v[5]));
            PyTuple_SET_ITEM(t, 8, PyLong_FromLongLong((long long)v[6]));
        } else if (fmt == 1) {
            const double* v = nu + 12 * i;
            t = PyTuple_New(12);
            if (!t) goto fail_list;
            for (int k = 0; k < 12; ++k) {
                PyTuple_SET_ITEM(t, k, k == 2
                    ? PyFloat_FromDouble(v[k])
                    : PyLong_FromLongLong((long long)v[k]));
            }
        } else {
            const double* v = nu + 2 * i;
            t = PyTuple_New(5);
            if (!t) goto fail_list;
            PyTuple_SET_ITEM(t, 0, PyBytes_FromStringAndSize(
                blob + s[0], (Py_ssize_t)s[1]));
            PyTuple_SET_ITEM(t, 1, PyLong_FromLongLong((long long)v[0]));
            PyTuple_SET_ITEM(t, 2, PyBytes_FromStringAndSize(
                blob + s[2], (Py_ssize_t)s[3]));
            PyTuple_SET_ITEM(t, 3, PyLong_FromLongLong((long long)v[1]));
            PyTuple_SET_ITEM(t, 4, PyBytes_FromStringAndSize(
                blob + s[4], (Py_ssize_t)s[5]));
        }
        // one check covers every unchecked item allocation above: an
        // allocation failure sets MemoryError and leaves a NULL in the
        // tuple, which tuple_dealloc tolerates (Py_XDECREF)
        if (PyErr_Occurred()) {
            Py_DECREF(t);
            goto fail_list;
        }
        PyList_SET_ITEM(list, (Py_ssize_t)i, t);
    }
    std::free(blob);
    std::free(so);
    std::free(nu);
    return list;
fail_list:
    Py_DECREF(list);
fail:
    std::free(blob);
    std::free(so);
    std::free(nu);
    return nullptr;
}

PyMethodDef methods[] = {
    {"parse_ovlfile", py_parse_ovlfile, METH_VARARGS,
     "parse_ovlfile(path, fmt) -> list of field tuples (0=PAF, 1=MHAP, "
     "2=SAM), identical to the Python oracle's OverlapRecord.fields"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "racon_torch_native_ext", nullptr, -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit_racon_torch_native_ext(void) {
    PyObject* m = PyModule_Create(&moduledef);
    if (!m) return nullptr;
    g_plus = PyUnicode_InternFromString("+");
    g_minus = PyUnicode_InternFromString("-");
    return m;
}

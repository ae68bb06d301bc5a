// CPython entry points to the port's C kernel launchers.
//
// Every kernel source in csrc/ exports a plain C launcher
// `int pt_<kernel>_launch(args..., void* stream)` that launches its kernel
// on `stream` and returns the launch's cudaError_t (0 = cudaSuccess).
// This module calls those launchers from Python for less than a ctypes
// call costs: each function below is METH_FASTCALL (its arguments arrive
// as a C array, no tuple, no ctypes argument objects), takes a launcher's
// address (resolved once, when its library is loaded) and then the
// launcher's own arguments as Python ints and floats, converts them, calls
// the launcher through a function pointer of its exact prototype, and
// returns the launcher's int result. It releases the interpreter lock
// around the call, as a ctypes call does.
//
// A function is named by its launcher's signature, one letter an
// argument: p a pointer (a Python int; 0 is NULL), i a C int, f a C float.
// Add a function here for a launcher of a new signature.
//
// Built with the host C compiler against Python's own headers only (no
// PyTorch, no CUDA headers), at first use: ops/cuda/_build.py.

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <limits.h>
#include <string.h>

typedef union {
  void* p;
  int i;
  float f;
} arg_t;

// Converts args[0] to the launcher's address *fn and args[1:] by `sig`
// into out. Returns 0, or -1 with a Python exception set.
static int unpack(const char* sig, PyObject* const* args, Py_ssize_t nargs,
                  void** fn, arg_t* out) {
  const Py_ssize_t n = (Py_ssize_t)strlen(sig);
  if (nargs != n + 1) {
    PyErr_Format(PyExc_TypeError,
                 "%s takes %zd arguments (a launcher address and %zd more), "
                 "got %zd", sig, n + 1, n, nargs);
    return -1;
  }
  *fn = PyLong_AsVoidPtr(args[0]);
  if (*fn == NULL) {
    if (!PyErr_Occurred())
      PyErr_SetString(PyExc_ValueError, "launcher address is 0");
    return -1;
  }
  for (Py_ssize_t k = 0; k < n; ++k) {
    PyObject* o = args[k + 1];
    switch (sig[k]) {
      case 'p':
        out[k].p = PyLong_AsVoidPtr(o);
        if (out[k].p == NULL && PyErr_Occurred()) return -1;
        break;
      case 'i': {
        const long v = PyLong_AsLong(o);
        if (v == -1 && PyErr_Occurred()) return -1;
        if (v < INT_MIN || v > INT_MAX) {
          PyErr_Format(PyExc_OverflowError,
                       "argument %zd (%ld) does not fit a C int", k + 1, v);
          return -1;
        }
        out[k].i = (int)v;
        break;
      }
      case 'f': {
        const double v = PyFloat_AsDouble(o);
        if (v == -1.0 && PyErr_Occurred()) return -1;
        out[k].f = (float)v;
        break;
      }
    }
  }
  return 0;
}

#define CALL(expr)            \
  int err;                    \
  Py_BEGIN_ALLOW_THREADS      \
  err = (expr);               \
  Py_END_ALLOW_THREADS        \
  return PyLong_FromLong(err)

// P6, P8: (data, idx, rows, c, out, stream); P5: (sp, v, n, depth, out,
// stream)
typedef int (*ppiipp_t)(void*, void*, int, int, void*, void*);
static PyObject* ppiipp(PyObject* self, PyObject* const* args,
                        Py_ssize_t nargs) {
  void* fn;
  arg_t a[6];
  if (unpack("ppiipp", args, nargs, &fn, a) < 0) return NULL;
  CALL(((ppiipp_t)fn)(a[0].p, a[1].p, a[2].i, a[3].i, a[4].p, a[5].p));
}

// P7, P9: (data, idx, rows, out, stream)
typedef int (*ppipp_t)(void*, void*, int, void*, void*);
static PyObject* ppipp(PyObject* self, PyObject* const* args,
                       Py_ssize_t nargs) {
  void* fn;
  arg_t a[5];
  if (unpack("ppipp", args, nargs, &fn, a) < 0) return NULL;
  CALL(((ppipp_t)fn)(a[0].p, a[1].p, a[2].i, a[3].p, a[4].p));
}

// P1-P4: (table, idx, n, m, w, out, stream)
typedef int (*ppiiipp_t)(void*, void*, int, int, int, void*, void*);
static PyObject* ppiiipp(PyObject* self, PyObject* const* args,
                         Py_ssize_t nargs) {
  void* fn;
  arg_t a[7];
  if (unpack("ppiiipp", args, nargs, &fn, a) < 0) return NULL;
  CALL(((ppiiipp_t)fn)(a[0].p, a[1].p, a[2].i, a[3].i, a[4].i, a[5].p,
                       a[6].p));
}

// K1: (o, d, t_max, tri, n, f, any_hit, g2, g3, g5, valid, t, tri_out, b,
// stream)
typedef int (*ppppiiifffppppp_t)(void*, void*, void*, void*, int, int, int,
                                 float, float, float, void*, void*, void*,
                                 void*, void*);
static PyObject* ppppiiifffppppp(PyObject* self, PyObject* const* args,
                                 Py_ssize_t nargs) {
  void* fn;
  arg_t a[15];
  if (unpack("ppppiiifffppppp", args, nargs, &fn, a) < 0) return NULL;
  CALL(((ppppiiifffppppp_t)fn)(a[0].p, a[1].p, a[2].p, a[3].p, a[4].i,
                               a[5].i, a[6].i, a[7].f, a[8].f, a[9].f,
                               a[10].p, a[11].p, a[12].p, a[13].p, a[14].p));
}

// K2: (table, o, d, t_max, rows, n, any_hit, stackw, g, g2, g3, g5, valid,
// t, tri, b, stream)
typedef int (*ppppiiiiffffppppp_t)(void*, void*, void*, void*, int, int, int,
                                   int, float, float, float, float, void*,
                                   void*, void*, void*, void*);
static PyObject* ppppiiiiffffppppp(PyObject* self, PyObject* const* args,
                                   Py_ssize_t nargs) {
  void* fn;
  arg_t a[17];
  if (unpack("ppppiiiiffffppppp", args, nargs, &fn, a) < 0) return NULL;
  CALL(((ppppiiiiffffppppp_t)fn)(a[0].p, a[1].p, a[2].p, a[3].p, a[4].i,
                                 a[5].i, a[6].i, a[7].i, a[8].f, a[9].f,
                                 a[10].f, a[11].f, a[12].p, a[13].p,
                                 a[14].p, a[15].p, a[16].p));
}

// K3: (txf, txi, data, txd_id, uv, fallback, fb_row, fb_col, dudx, dvdx,
// dudy, dvdy, n, width_mode, image, out, stream)
typedef int (*ppppppiippppiiipp_t)(void*, void*, void*, void*, void*, void*,
                                   int, int, void*, void*, void*, void*, int,
                                   int, int, void*, void*);
static PyObject* ppppppiippppiiipp(PyObject* self, PyObject* const* args,
                                   Py_ssize_t nargs) {
  void* fn;
  arg_t a[17];
  if (unpack("ppppppiippppiiipp", args, nargs, &fn, a) < 0) return NULL;
  CALL(((ppppppiippppiiipp_t)fn)(a[0].p, a[1].p, a[2].p, a[3].p, a[4].p,
                                 a[5].p, a[6].i, a[7].i, a[8].p, a[9].p,
                                 a[10].p, a[11].p, a[12].i, a[13].i,
                                 a[14].i, a[15].p, a[16].p));
}

// K4: (txf, txi, data, tri_attr, tri, bary, valid, n, gamma7, cut, p_hit,
// p_err, ng, stream)
typedef int (*pppppppifppppp_t)(void*, void*, void*, void*, void*, void*,
                                void*, int, float, void*, void*, void*,
                                void*, void*);
static PyObject* pppppppifppppp(PyObject* self, PyObject* const* args,
                                Py_ssize_t nargs) {
  void* fn;
  arg_t a[14];
  if (unpack("pppppppifppppp", args, nargs, &fn, a) < 0) return NULL;
  CALL(((pppppppifppppp_t)fn)(a[0].p, a[1].p, a[2].p, a[3].p, a[4].p,
                              a[5].p, a[6].p, a[7].i, a[8].f, a[9].p,
                              a[10].p, a[11].p, a[12].p, a[13].p));
}

// K5 and K6 begin with the material parameters, each by its element
// strides: (type, s, kd, r, c, ks, r, c, eta, s, eta3, r, c, k, r, c, ax,
// s, ay, s, metallic, s), and the frame (ss, ts, ns, ng)
#define BSDF_IN_TYPES                                                    \
  void*, int, void*, int, int, void*, int, int, void*, int, void*, int,   \
      int, void*, int, int, void*, int, void*, int, void*, int, void*,    \
      void*, void*, void*
#define BSDF_IN_VALUES                                                   \
  a[0].p, a[1].i, a[2].p, a[3].i, a[4].i, a[5].p, a[6].i, a[7].i, a[8].p,  \
      a[9].i, a[10].p, a[11].i, a[12].i, a[13].p, a[14].i, a[15].i,        \
      a[16].p, a[17].i, a[18].p, a[19].i, a[20].p, a[21].i, a[22].p,       \
      a[23].p, a[24].p, a[25].p

// K5: (material..., frame..., wo, wi, present, n, f, pdf, cosine, stream)
typedef int (*pipiipiipipiipiipipipippppppiipppp_t)(BSDF_IN_TYPES, void*,
                                                     void*, int, int, void*,
                                                     void*, void*, void*);
static PyObject* pipiipiipipiipiipipipippppppiipppp(PyObject* self,
                                                     PyObject* const* args,
                                                     Py_ssize_t nargs) {
  void* fn;
  arg_t a[34];
  if (unpack("pipiipiipipiipiipipipippppppiipppp", args, nargs, &fn, a) < 0)
    return NULL;
  CALL(((pipiipiipipiipiipipipippppppiipppp_t)fn)(
      BSDF_IN_VALUES, a[26].p, a[27].p, a[28].i, a[29].i, a[30].p,
      a[31].p, a[32].p, a[33].p));
}

// K6: (material..., frame..., wo, u, present, n, wi, f, pdf, specular,
// transmission, cosine, stream)
typedef int (*pipiipiipipiipiipipipippppppiippppppp_t)(
    BSDF_IN_TYPES, void*, void*, int, int, void*, void*, void*, void*,
    void*, void*, void*);
static PyObject* pipiipiipipiipiipipipippppppiippppppp(PyObject* self,
                                                        PyObject* const* args,
                                                        Py_ssize_t nargs) {
  void* fn;
  arg_t a[37];
  if (unpack("pipiipiipipiipiipipipippppppiippppppp", args, nargs, &fn, a) <
      0)
    return NULL;
  CALL(((pipiipiipipiipiipipipippppppiippppppp_t)fn)(
      BSDF_IN_VALUES, a[26].p, a[27].p, a[28].i, a[29].i, a[30].p,
      a[31].p, a[32].p, a[33].p, a[34].p, a[35].p, a[36].p));
}

// K7 sobol_index: (b_base, inv_lo, inv_hi, w_delta, w_lo, w_hi, delta, lo,
// hi, n, out_lo, out_hi, stream)
typedef int (*ppppppiiiippp_t)(void*, void*, void*, void*, void*, void*, int,
                               int, int, int, void*, void*, void*);
static PyObject* ppppppiiiippp(PyObject* self, PyObject* const* args,
                               Py_ssize_t nargs) {
  void* fn;
  arg_t a[13];
  if (unpack("ppppppiiiippp", args, nargs, &fn, a) < 0) return NULL;
  CALL(((ppppppiiiippp_t)fn)(a[0].p, a[1].p, a[2].p, a[3].p, a[4].p, a[5].p,
                             a[6].i, a[7].i, a[8].i, a[9].i, a[10].p,
                             a[11].p, a[12].p));
}

// K7 sobol_draw: (idx_lo, idx_hi, scramble, table, dim, k, rows, n, out,
// stream)
typedef int (*ppppiiiipp_t)(void*, void*, void*, void*, int, int, int, int,
                            void*, void*);
static PyObject* ppppiiiipp(PyObject* self, PyObject* const* args,
                            Py_ssize_t nargs) {
  void* fn;
  arg_t a[10];
  if (unpack("ppppiiiipp", args, nargs, &fn, a) < 0) return NULL;
  CALL(((ppppiiiipp_t)fn)(a[0].p, a[1].p, a[2].p, a[3].p, a[4].i, a[5].i,
                          a[6].i, a[7].i, a[8].p, a[9].p));
}

// K8 env_eval: (d, w2e, map, cond_func, marg_int, has_env, n, h, w, nv,
// nu, le, pdf, stream)
typedef int (*ppppppiiiiippp_t)(void*, void*, void*, void*, void*, void*,
                                int, int, int, int, int, void*, void*,
                                void*);
static PyObject* ppppppiiiiippp(PyObject* self, PyObject* const* args,
                                Py_ssize_t nargs) {
  void* fn;
  arg_t a[14];
  if (unpack("ppppppiiiiippp", args, nargs, &fn, a) < 0) return NULL;
  CALL(((ppppppiiiiippp_t)fn)(a[0].p, a[1].p, a[2].p, a[3].p, a[4].p,
                              a[5].p, a[6].i, a[7].i, a[8].i, a[9].i,
                              a[10].i, a[11].p, a[12].p, a[13].p));
}

// K8 env_sample: (u, e2w, map, cond_func, cond_cdf, cond_int, marg_func,
// marg_cdf, marg_int, n, h, w, nv, nu, wi, pdf, le, stream)
typedef int (*pppppppppiiiiipppp_t)(void*, void*, void*, void*, void*,
                                    void*, void*, void*, void*, int, int,
                                    int, int, int, void*, void*, void*,
                                    void*);
static PyObject* pppppppppiiiiipppp(PyObject* self, PyObject* const* args,
                                    Py_ssize_t nargs) {
  void* fn;
  arg_t a[18];
  if (unpack("pppppppppiiiiipppp", args, nargs, &fn, a) < 0) return NULL;
  CALL(((pppppppppiiiiipppp_t)fn)(a[0].p, a[1].p, a[2].p, a[3].p, a[4].p,
                                  a[5].p, a[6].p, a[7].p, a[8].p, a[9].i,
                                  a[10].i, a[11].i, a[12].i, a[13].i,
                                  a[14].p, a[15].p, a[16].p, a[17].p));
}

#define ENTRY(name) \
  {#name, (PyCFunction)(void (*)(void))name, METH_FASTCALL, NULL}

static PyMethodDef methods[] = {
    ENTRY(ppiipp),          ENTRY(ppipp),
    ENTRY(ppiiipp),         ENTRY(ppppiiifffppppp),
    ENTRY(ppppiiiiffffppppp), ENTRY(ppppppiippppiiipp),
    ENTRY(pppppppifppppp),  ENTRY(pipiipiipipiipiipipipippppppiipppp),
    ENTRY(pipiipiipipiipiipipipippppppiippppppp), ENTRY(ppppppiiiippp),
    ENTRY(ppppiiiipp),      ENTRY(ppppppiiiiippp),
    ENTRY(pppppppppiiiiipppp), {NULL, NULL, 0, NULL}};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "pylaunch",
    "CPython entry points to the port's C kernel launchers.", -1, methods};

PyMODINIT_FUNC PyInit_pylaunch(void) { return PyModule_Create(&module); }

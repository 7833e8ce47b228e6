// C-ABI product library of the PyTorch/CUDA port: the symbols of
// native/matinv.h (matinv_tpu_init, matrix_inv_32, matrix_inv_64,
// matrix_solve_32), the port's counterpart of mat_inv_c.cpp, which routes
// the same calls through the JAX package.
//
// Native consumers (C, C++, MATLAB via loadlibrary/clibgen, Fortran, ...)
// link libmatinv_torch.so in place of libmatinv_tpu.so. The library embeds
// a CPython interpreter and calls the port's flat API
// (gpu_matrix_inversion_tpu_torch: matrix_inv_32, matrix_inversion_fp64,
// solve) on the CUDA card; the environment variable MATINV_DEVICE names
// another torch device (MATINV_DEVICE=cpu runs the kernels' plain twins).
// Contract as mat_inv_c.cpp: status 0 with the result written to `out` on
// success; 1 (and `out` untouched) on invalid input or a singular matrix
// -- the flat-vector "empty on failure" contract (mat_inv_32.cpp:206-215,
// :389-394); negative on an internal error, which includes a missing card.
//
// Build: make -C native -f Makefile.torch

#include <Python.h>

#include <cstring>
#include <mutex>
#include <string>

namespace {

std::mutex g_mu;
bool g_inited = false;
PyObject* g_ns = nullptr;  // namespace dict holding the helper functions

const char* kHelper = R"PY(
import os

def _setup():
    import gpu_matrix_inversion_tpu_torch  # noqa: F401

def _device():
    return os.environ.get("MATINV_DEVICE", "cuda")

def _invert(buf, n, dtype):
    import numpy as np
    import gpu_matrix_inversion_tpu_torch as mi
    a = np.frombuffer(buf, dtype=dtype, count=n * n).copy()
    fn = mi.matrix_inv_32 if dtype == "float32" else mi.matrix_inversion_fp64
    out = fn(a, n, device=_device())
    return out.tobytes() if out.size else b""

def _solve(abuf, bbuf, n, k, dtype):
    import numpy as np
    import torch
    import gpu_matrix_inversion_tpu_torch as mi
    a = np.frombuffer(abuf, dtype=dtype, count=n * n).reshape(n, n).copy()
    b = np.frombuffer(bbuf, dtype=dtype, count=n * k).reshape(n, k).copy()
    x, ok = mi.solve(torch.from_numpy(a).to(_device()),
                     torch.from_numpy(b).to(_device()))
    if not bool(ok):
        return b""
    return x.cpu().numpy().astype(dtype).tobytes()
)PY";

// Ensure the interpreter + helper namespace exist. Returns 0 on success.
int ensure_init() {
  std::lock_guard<std::mutex> lock(g_mu);
  if (g_inited) return 0;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* main_mod = PyImport_AddModule("__main__");  // borrowed
  PyObject* globals = PyModule_GetDict(main_mod);       // borrowed
  g_ns = PyDict_New();
  // Give the helper namespace builtins.
  PyDict_SetItemString(g_ns, "__builtins__",
                       PyDict_GetItemString(globals, "__builtins__")
                           ? PyDict_GetItemString(globals, "__builtins__")
                           : PyEval_GetBuiltins());
  PyObject* res = PyRun_String(kHelper, Py_file_input, g_ns, g_ns);
  int status = 0;
  if (res == nullptr) {
    PyErr_Print();
    status = -1;
  } else {
    Py_DECREF(res);
    PyObject* setup = PyDict_GetItemString(g_ns, "_setup");  // borrowed
    PyObject* r2 = PyObject_CallNoArgs(setup);
    if (r2 == nullptr) {
      PyErr_Print();
      status = -2;
    } else {
      Py_DECREF(r2);
    }
  }
  g_inited = (status == 0);
  PyGILState_Release(gil);
  return status;
}

// Shared implementation: returns 0 ok, 1 invalid/singular, <0 internal.
template <typename T>
int invert_impl(const T* data, int n, T* out, const char* dtype) {
  if (data == nullptr || out == nullptr || n <= 0) return 1;
  if (int rc = ensure_init()) return rc;
  PyGILState_STATE gil = PyGILState_Ensure();
  int status = 0;
  const Py_ssize_t nbytes = (Py_ssize_t)n * n * (Py_ssize_t)sizeof(T);
  PyObject* view = PyMemoryView_FromMemory(
      reinterpret_cast<char*>(const_cast<T*>(data)), nbytes, PyBUF_READ);
  PyObject* fn = PyDict_GetItemString(g_ns, "_invert");  // borrowed
  PyObject* result =
      view ? PyObject_CallFunction(fn, "Ois", view, n, dtype) : nullptr;
  if (result == nullptr) {
    PyErr_Print();
    status = -3;
  } else {
    char* buf = nullptr;
    Py_ssize_t len = 0;
    if (PyBytes_AsStringAndSize(result, &buf, &len) != 0) {
      PyErr_Print();
      status = -4;
    } else if (len == 0) {
      status = 1;  // reference's empty-vector failure return
    } else if (len != nbytes) {
      status = -5;
    } else {
      std::memcpy(out, buf, (size_t)len);
    }
    Py_DECREF(result);
  }
  Py_XDECREF(view);
  PyGILState_Release(gil);
  return status;
}

}  // namespace

extern "C" {

// Initialize eagerly (optional -- the first inversion also initializes).
int matinv_tpu_init(void) { return ensure_init(); }

// FP32 inversion (reference matrix_inv_32, Matlab/mat_inv_32.h:4).
// Returns 0 and writes n*n floats to `out` on success; 1 on invalid or
// singular input (the empty-vector contract); negative on internal error.
int matrix_inv_32(const float* data, int n, float* out) {
  return invert_impl(data, n, out, "float32");
}

// FP64 inversion (reference matrix_inversion_FP64, headers.h:9).
int matrix_inv_64(const double* data, int n, double* out) {
  return invert_impl(data, n, out, "float64");
}

// Solve A x = b for k right-hand sides (column-major-agnostic: row-major
// n x n A, n x k b). The reference has no solve API; status contract as
// matrix_inv_32.
int matrix_solve_32(const float* a, const float* b, int n, int k,
                    float* out) {
  if (a == nullptr || b == nullptr || out == nullptr || n <= 0 || k <= 0)
    return 1;
  if (int rc = ensure_init()) return rc;
  PyGILState_STATE gil = PyGILState_Ensure();
  int status = 0;
  const Py_ssize_t abytes = (Py_ssize_t)n * n * (Py_ssize_t)sizeof(float);
  const Py_ssize_t bbytes = (Py_ssize_t)n * k * (Py_ssize_t)sizeof(float);
  PyObject* av = PyMemoryView_FromMemory(
      reinterpret_cast<char*>(const_cast<float*>(a)), abytes, PyBUF_READ);
  PyObject* bv = PyMemoryView_FromMemory(
      reinterpret_cast<char*>(const_cast<float*>(b)), bbytes, PyBUF_READ);
  PyObject* fn = PyDict_GetItemString(g_ns, "_solve");  // borrowed
  PyObject* result = (av && bv)
      ? PyObject_CallFunction(fn, "OOiis", av, bv, n, k, "float32")
      : nullptr;
  if (result == nullptr) {
    PyErr_Print();
    status = -3;
  } else {
    char* buf = nullptr;
    Py_ssize_t len = 0;
    if (PyBytes_AsStringAndSize(result, &buf, &len) != 0) {
      PyErr_Print();
      status = -4;
    } else if (len == 0) {
      status = 1;
    } else if (len != bbytes) {
      status = -5;
    } else {
      std::memcpy(out, buf, (size_t)len);
    }
    Py_DECREF(result);
  }
  Py_XDECREF(av);
  Py_XDECREF(bv);
  PyGILState_Release(gil);
  return status;
}

}  // extern "C"

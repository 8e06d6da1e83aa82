// C API for the ceres_tpu framework.
//
// reference: include/ceres/c_api.h + internal/ceres/c_api.cc — a minimal C
// surface: ceres_init, stock loss function factories, problem create/free,
// ceres_problem_add_residual_block with a user cost callback
//   int cb(void* user_data, double** parameters, double* residuals,
//          double** jacobians)
// and ceres_solve with default options.
//
// Shape: this shim embeds CPython and forwards every call to
// ceres_tpu.capi (ceres_tpu/capi.py), which adopts the caller's parameter
// memory in place and routes the callback's analytic jacobians into the
// normal device pipeline. Build: `make c_api` in native/.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>

extern "C" {

typedef int (*ceres_cost_function_t)(void* user_data, double** parameters,
                                     double* residuals, double** jacobians);
typedef void (*ceres_loss_function_t)(void* user_data, double squared_norm,
                                      double out[3]);

struct ceres_problem_s {
  PyObject* py;  // ceres_tpu.capi.CProblem
};
typedef struct ceres_problem_s ceres_problem_t;
typedef int ceres_residual_block_id_t;

// stock loss descriptors (kind, a, b) matching capi.make_stock_loss
struct stock_loss_data {
  int kind;
  double a;
  double b;
};

static PyObject* g_capi_module = nullptr;
static int g_we_initialized_python = 0;

static void fail(const char* what) {
  if (PyErr_Occurred()) PyErr_Print();
  std::fprintf(stderr, "ceres_tpu c_api: %s\n", what);
  std::abort();
}

void ceres_init(void) {
  if (g_capi_module != nullptr) return;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    g_we_initialized_python = 1;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  // repo root (this file's package) must be importable; honor
  // CERES_TPU_PYTHONPATH when the caller sets it.
  const char* extra = std::getenv("CERES_TPU_PYTHONPATH");
  if (extra != nullptr) {
    PyObject* sys_path = PySys_GetObject("path");  // borrowed
    PyObject* p = PyUnicode_FromString(extra);
    if (sys_path && p) PyList_Insert(sys_path, 0, p);
    Py_XDECREF(p);
  }
  g_capi_module = PyImport_ImportModule("ceres_tpu.capi");
  if (g_capi_module == nullptr) fail("failed to import ceres_tpu.capi");
  PyGILState_Release(gil);
}

void* ceres_create_huber_loss_function_data(double a) {
  auto* d = new stock_loss_data{0, a, 0.0};
  return d;
}
void* ceres_create_softl1_loss_function_data(double a) {
  auto* d = new stock_loss_data{1, a, 0.0};
  return d;
}
void* ceres_create_cauchy_loss_function_data(double a) {
  auto* d = new stock_loss_data{2, a, 0.0};
  return d;
}
void* ceres_create_arctan_loss_function_data(double a) {
  auto* d = new stock_loss_data{3, a, 0.0};
  return d;
}
void* ceres_create_tolerant_loss_function_data(double a, double b) {
  auto* d = new stock_loss_data{4, a, b};
  return d;
}
void ceres_free_stock_loss_function_data(void* loss_function_data) {
  delete static_cast<stock_loss_data*>(loss_function_data);
}

// Evaluate a stock loss at squared_norm (parity with the reference's
// ceres_stock_loss_function, c_api.cc — useful for callers composing their
// own loss callbacks). rho = {rho(s), rho'(s), rho''(s)}.
void ceres_stock_loss_function(void* user_data, double squared_norm,
                               double out[3]) {
  ceres_init();
  auto* d = static_cast<stock_loss_data*>(user_data);
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* r = PyObject_CallMethod(g_capi_module, "stock_loss_rho", "iddd",
                                    d->kind, d->a, d->b, squared_norm);
  if (r == nullptr) fail("stock_loss_rho failed");
  for (int i = 0; i < 3; i++) {
    PyObject* item = PySequence_GetItem(r, i);
    out[i] = PyFloat_AsDouble(item);
    Py_XDECREF(item);
  }
  Py_DECREF(r);
  PyGILState_Release(gil);
}

ceres_problem_t* ceres_create_problem(void) {
  ceres_init();
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* obj = PyObject_CallMethod(g_capi_module, "CProblem", nullptr);
  if (obj == nullptr) fail("CProblem() failed");
  PyGILState_Release(gil);
  auto* p = new ceres_problem_t;
  p->py = obj;
  return p;
}

void ceres_free_problem(ceres_problem_t* problem) {
  if (problem == nullptr) return;
  PyGILState_STATE gil = PyGILState_Ensure();
  Py_XDECREF(problem->py);
  PyGILState_Release(gil);
  delete problem;
}

ceres_residual_block_id_t* ceres_problem_add_residual_block(
    ceres_problem_t* problem, ceres_cost_function_t cost_function,
    void* cost_function_data, ceres_loss_function_t loss_function,
    void* loss_function_data, int num_residuals, int num_parameter_blocks,
    int* parameter_block_sizes, double** parameters) {
  ceres_init();
  // Stock losses pass ceres_stock_loss_function + stock data; a custom C
  // loss callback is forwarded through capi as an address pair.
  int loss_kind = -1;
  double a = 0.0, b = 0.0;
  intptr_t custom_loss_fn = 0, custom_loss_data = 0;
  if (loss_function == &ceres_stock_loss_function &&
      loss_function_data != nullptr) {
    auto* d = static_cast<stock_loss_data*>(loss_function_data);
    loss_kind = d->kind;
    a = d->a;
    b = d->b;
  } else if (loss_function != nullptr) {
    custom_loss_fn = reinterpret_cast<intptr_t>(loss_function);
    custom_loss_data = reinterpret_cast<intptr_t>(loss_function_data);
  }

  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* addrs = PyList_New(num_parameter_blocks);
  PyObject* sizes = PyList_New(num_parameter_blocks);
  for (int i = 0; i < num_parameter_blocks; i++) {
    PyList_SetItem(addrs, i,
                   PyLong_FromVoidPtr(static_cast<void*>(parameters[i])));
    PyList_SetItem(sizes, i, PyLong_FromLong(parameter_block_sizes[i]));
  }
  PyObject* r = PyObject_CallMethod(
      problem->py, "add_residual_block_c", "LLiddiOOLL",
      (long long)reinterpret_cast<intptr_t>(cost_function),
      (long long)reinterpret_cast<intptr_t>(cost_function_data), loss_kind, a,
      b, num_residuals, addrs, sizes, (long long)custom_loss_fn,
      (long long)custom_loss_data);
  Py_DECREF(addrs);
  Py_DECREF(sizes);
  if (r == nullptr) fail("add_residual_block failed");
  long handle = PyLong_AsLong(r);
  Py_DECREF(r);
  PyGILState_Release(gil);
  // the reference returns an opaque id pointer; encode the handle + 1 so a
  // valid id is never NULL
  return reinterpret_cast<ceres_residual_block_id_t*>(
      static_cast<intptr_t>(handle + 1));
}

void ceres_solve(ceres_problem_t* problem) {
  ceres_init();
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* r = PyObject_CallMethod(problem->py, "solve", nullptr);
  if (r == nullptr) fail("solve failed");
  PyObject* str = PyObject_Str(r);
  if (str != nullptr) {
    const char* report = PyUnicode_AsUTF8(str);
    if (report != nullptr) std::printf("%s\n", report);
    Py_DECREF(str);
  }
  Py_DECREF(r);
  PyGILState_Release(gil);
}

}  // extern "C"

// gooey_shim.cpp -- native C ABI core over the PyTorch/CUDA port via
// embedded CPython (the port's copy of native/gooey_shim.cpp).
//
// Behavioral reference: src/ffi.rs -- the `gooey_engine_*` functions the iOS
// host links against, including the panic fence that latches any internal
// failure into a terminal error + silence (ffi.rs:2086-2122).  Here the
// fence is the Python-exception -> error-string conversion in call().
//
// This file holds the runtime core (interpreter boot, GIL discipline,
// error latch) plus the entry points with buffer/string signatures; the
// ~200 scalar wrappers are native/gooey_shim_gen.cpp, which only calls
// gooey_shim::call on g_capi, so it serves either module.  The module is
// GOOEY_CAPI_MODULE (libgooey_tpu_torch.capi unless defined otherwise).
//
// Design: one process-wide embedded interpreter; every entry point takes
// the GIL (PyGILState_Ensure), forwards to the capi module, and never
// lets an exception cross the C boundary.  The engine runs on the CUDA card
// (LIBGOOEY_TPU_TORCH_DEVICE=cpu asks for the CPU); with no card,
// gooey_engine_new returns 0 with the error latched.  The embedded
// interpreter must find torch: put the site-packages that hold it on
// PYTHONPATH, or on gooey_set_module_path, beside the repository root.

#ifndef GOOEY_CAPI_MODULE
#define GOOEY_CAPI_MODULE "libgooey_tpu_torch.capi"
#endif

#include "gooey_tpu.h"
#include "shim_internal.h"

#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

namespace gooey_shim {

namespace {
std::mutex g_init_mutex;
std::vector<std::string> g_module_paths;
std::string g_boot_error;  // init failure (handle 0)
bool g_we_initialized = false;
std::mutex g_err_mutex;
std::string g_last_error;
}  // namespace

PyObject *g_capi = nullptr;  // the GOOEY_CAPI_MODULE module (owned)

std::string take_exception() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  std::string msg = "unknown python error";
  if (value) {
    PyObject *s = PyObject_Str(value);
    if (s) {
      const char *c = PyUnicode_AsUTF8(s);
      if (c) msg = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  return msg;
}

bool ensure_runtime() {
  std::lock_guard<std::mutex> lock(g_init_mutex);
  if (g_capi) return true;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);  // skip signal handlers: we're a library
    g_we_initialized = true;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  bool ok = false;
  do {
    PyObject *sys_path = PySys_GetObject("path");  // borrowed
    if (sys_path) {
      for (const std::string &p : g_module_paths) {
        PyObject *str = PyUnicode_FromString(p.c_str());
        if (str) {
          PyList_Insert(sys_path, 0, str);
          Py_DECREF(str);
        }
      }
    }
    PyObject *mod = PyImport_ImportModule(GOOEY_CAPI_MODULE);
    if (!mod) {
      g_boot_error =
          std::string("import " GOOEY_CAPI_MODULE " failed: ") + take_exception();
      break;
    }
    g_capi = mod;
    ok = true;
  } while (false);
  PyGILState_Release(gil);
  // Release the GIL acquired implicitly by Py_InitializeEx on the boot
  // thread so other threads can take it via PyGILState_Ensure.
  if (g_we_initialized) {
    static PyThreadState *main_state = nullptr;
    if (!main_state && ok) main_state = PyEval_SaveThread();
    (void)main_state;
    g_we_initialized = false;
  }
  return ok;
}

void set_error(const std::string &msg) {
  std::lock_guard<std::mutex> lock(g_err_mutex);
  g_last_error = msg;
}

PyObject *call(const char *name, const char *fmt, ...) {
  PyObject *fn = PyObject_GetAttrString(g_capi, name);
  if (!fn) {
    set_error(std::string("no capi function ") + name);
    PyErr_Clear();
    return nullptr;
  }
  va_list va;
  va_start(va, fmt);
  PyObject *args = Py_VaBuildValue(fmt, va);
  va_end(va);
  PyObject *res = nullptr;
  if (args) {
    res = PyObject_CallObject(fn, args);
    Py_DECREF(args);
  }
  Py_DECREF(fn);
  if (!res) set_error(std::string(name) + ": " + take_exception());
  return res;
}

double as_double(PyObject *o, double fallback) {
  if (!o) return fallback;
  double v = PyFloat_AsDouble(o);
  if (PyErr_Occurred()) {
    PyErr_Clear();
    v = fallback;
  }
  Py_DECREF(o);
  return v;
}

long long as_int(PyObject *o, long long fallback) {
  if (!o) return fallback;
  long long v = PyLong_AsLongLong(o);
  if (PyErr_Occurred()) {
    PyErr_Clear();
    v = fallback;
  }
  Py_DECREF(o);
  return v;
}

void drop(PyObject *o) { Py_XDECREF(o); }

namespace {

// Wrap a raw float buffer as np.frombuffer(bytes, float32) → new ref.
PyObject *np_from_floats(const float *samples, int64_t count) {
  PyObject *np = PyImport_ImportModule("numpy");
  if (!np) return nullptr;
  PyObject *bytes =
      PyBytes_FromStringAndSize((const char *)samples, count * sizeof(float));
  PyObject *arr =
      bytes ? PyObject_CallMethod(np, "frombuffer", "(Os)", bytes, "float32")
            : nullptr;
  Py_XDECREF(bytes);
  Py_DECREF(np);
  return arr;
}

// Copy a float32-buffer-protocol result into out[n]; returns copied count.
int64_t copy_floats(PyObject *arr, float *out, int64_t n) {
  Py_buffer view;
  if (PyObject_GetBuffer(arr, &view, PyBUF_CONTIG_RO) != 0) {
    PyErr_Clear();
    return -1;
  }
  int64_t avail = (int64_t)(view.len / sizeof(float));
  int64_t k = avail < n ? avail : n;
  std::memcpy(out, view.buf, (size_t)k * sizeof(float));
  PyBuffer_Release(&view);
  return k;
}

std::string boot_error() {
  std::lock_guard<std::mutex> lock(g_init_mutex);
  return g_boot_error;
}

std::string last_error() {
  std::lock_guard<std::mutex> lock(g_err_mutex);
  return g_last_error;
}

}  // namespace
}  // namespace gooey_shim

using namespace gooey_shim;

extern "C" {

void gooey_set_module_path(const char *path) {
  std::lock_guard<std::mutex> lock(g_init_mutex);
  if (path && !g_capi) g_module_paths.emplace_back(path);
}

gooey_handle gooey_engine_new(double sample_rate) {
  if (!ensure_runtime()) {
    set_error(boot_error());
    return 0;
  }
  Gil gil;
  return as_int(call("engine_new", "(d)", sample_rate), 0);
}

void gooey_engine_free(gooey_handle h) {
  if (!g_capi) return;
  Gil gil;
  drop(call("engine_free", "(L)", (long long)h));
}

int32_t gooey_engine_render(gooey_handle h, float *out, int64_t frames) {
  if (frames <= 0) return 0;
  const size_t n = (size_t)frames * 2;
  std::memset(out, 0, n * sizeof(float));
  if (!g_capi) return -1;
  Gil gil;
  PyObject *arr = call("engine_render", "(Ln)", (long long)h, (Py_ssize_t)frames);
  if (!arr) return -1;
  int64_t copied = copy_floats(arr, out, (int64_t)n);
  Py_DECREF(arr);
  if (copied != (int64_t)n) {
    set_error("engine_render: unexpected buffer shape");
    return -1;
  }
  return 0;
}

int64_t gooey_engine_last_error(gooey_handle h, char *buf, int64_t buf_len) {
  std::string msg;
  if (g_capi && h > 0) {
    Gil gil;
    PyObject *s = call("engine_last_error", "(L)", (long long)h);
    if (s) {
      const char *c = PyUnicode_AsUTF8(s);
      if (c) msg = c;
      Py_DECREF(s);
    }
  }
  // handle 0: the boot error, else the failed gooey_engine_new's (no card)
  if (msg.empty() && h == 0) msg = boot_error();
  if (msg.empty()) msg = last_error();
  if (buf && buf_len > 0) {
    const int64_t k =
        (int64_t)msg.size() < buf_len - 1 ? (int64_t)msg.size() : buf_len - 1;
    std::memcpy(buf, msg.data(), (size_t)k);
    buf[k] = '\0';
  }
  return (int64_t)msg.size();
}

int32_t gooey_engine_bounce_to_buffer(gooey_handle h, float *out,
                                      int64_t frames) {
  if (frames <= 0 || !g_capi) return -1;
  Gil gil;
  PyObject *arr =
      call("engine_bounce_to_buffer", "(Ln)", (long long)h, (Py_ssize_t)frames);
  if (!arr) return -1;
  int64_t copied = copy_floats(arr, out, frames * 2);
  Py_DECREF(arr);
  return copied == frames * 2 ? 0 : -1;
}

/* ---- buffer-loading entry points ---- */

int32_t gooey_engine_granulator_load(gooey_handle h, const float *samples,
                                     int64_t count, double sample_rate) {
  if (!g_capi || count <= 0) return 0;
  Gil gil;
  PyObject *arr = np_from_floats(samples, count);
  if (!arr) {
    set_error("granulator_load: " + take_exception());
    return 0;
  }
  PyObject *res =
      call("engine_granulator_load", "(LOd)", (long long)h, arr, sample_rate);
  Py_DECREF(arr);
  if (!res) return 0;
  Py_DECREF(res);
  return 1;
}

int32_t gooey_engine_loop_load(gooey_handle h, int32_t channel,
                               const float *interleaved, int64_t frames,
                               int32_t num_channels, double sample_rate,
                               double source_bpm) {
  if (!g_capi || frames <= 0) return 0;
  Gil gil;
  PyObject *arr = np_from_floats(interleaved, frames * num_channels);
  if (!arr) return 0;
  PyObject *res = call("engine_loop_load", "(LiOidd)", (long long)h,
                       (int)channel, arr, (int)num_channels, sample_rate,
                       source_bpm);
  Py_DECREF(arr);
  if (!res) return 0;
  return (int32_t)as_int(res, 0);
}

int32_t gooey_engine_loop_queue_swap(gooey_handle h, int32_t channel,
                                     const float *interleaved, int64_t frames,
                                     int32_t num_channels, double sample_rate,
                                     int32_t divisions, double source_bpm) {
  if (!g_capi || frames <= 0) return 0;
  Gil gil;
  PyObject *arr = np_from_floats(interleaved, frames * num_channels);
  if (!arr) return 0;
  PyObject *res = call("engine_loop_queue_swap", "(LiOidid)", (long long)h,
                       (int)channel, arr, (int)num_channels, sample_rate,
                       (int)divisions, source_bpm);
  Py_DECREF(arr);
  if (!res) return 0;
  return (int32_t)as_int(res, 0);
}

int32_t gooey_engine_clip_load(gooey_handle h, int32_t column, int32_t row,
                               const float *interleaved, int64_t frames,
                               int32_t num_channels, double sample_rate,
                               double source_bpm) {
  if (!g_capi || frames <= 0) return 0;
  Gil gil;
  PyObject *arr = np_from_floats(interleaved, frames * num_channels);
  if (!arr) return 0;
  PyObject *res = call("engine_clip_load", "(LiiOidd)", (long long)h,
                       (int)column, (int)row, arr, (int)num_channels,
                       sample_rate, source_bpm);
  Py_DECREF(arr);
  if (!res) return 0;
  return (int32_t)as_int(res, 0);
}

int32_t gooey_engine_sampler_set_slot_buffer(gooey_handle h, int32_t rack,
                                             int32_t slot,
                                             const float *interleaved,
                                             int64_t frames,
                                             int32_t num_channels,
                                             double sample_rate) {
  if (!g_capi || frames <= 0) return 0;
  Gil gil;
  PyObject *arr = np_from_floats(interleaved, frames * num_channels);
  if (!arr) return 0;
  PyObject *res = call("engine_sampler_set_slot_buffer", "(LiiOid)",
                       (long long)h, (int)rack, (int)slot, arr,
                       (int)num_channels, sample_rate);
  Py_DECREF(arr);
  if (!res) return 0;
  return (int32_t)as_int(res, 0);
}

/* ---- array/string-out entry points ---- */

int64_t gooey_engine_get_channel_peaks(gooey_handle h, float *out,
                                       int64_t out_len) {
  if (!g_capi) return -1;
  Gil gil;
  PyObject *arr = call("engine_get_channel_peaks", "(L)", (long long)h);
  if (!arr) return -1;
  int64_t copied = copy_floats(arr, out, out_len);
  Py_DECREF(arr);
  return copied;
}

int64_t gooey_engine_mixer_get_track_name(gooey_handle h, int32_t track,
                                          char *buf, int64_t buf_len) {
  if (!g_capi) return -1;
  Gil gil;
  PyObject *s =
      call("engine_mixer_get_track_name", "(Li)", (long long)h, (int)track);
  if (!s) return -1;
  const char *c = PyUnicode_AsUTF8(s);
  std::string name = c ? c : "";
  Py_DECREF(s);
  if (buf && buf_len > 0) {
    const int64_t k =
        (int64_t)name.size() < buf_len - 1 ? (int64_t)name.size() : buf_len - 1;
    std::memcpy(buf, name.data(), (size_t)k);
    buf[k] = '\0';
  }
  return (int64_t)name.size();
}

/* perf event → 9 doubles: start_tick, duration_ticks, root, scale, degree,
 * voicing, preset, octave, velocity. */
int32_t gooey_engine_perf_get_event(gooey_handle h, int32_t index,
                                    double *out9) {
  if (!g_capi) return 0;
  Gil gil;
  PyObject *tup =
      call("engine_perf_get_event", "(Li)", (long long)h, (int)index);
  if (!tup) return 0;
  int32_t ok = 0;
  if (PyTuple_Check(tup) && PyTuple_Size(tup) == 9) {
    for (int i = 0; i < 9; i++)
      out9[i] = PyFloat_AsDouble(PyNumber_Float(PyTuple_GetItem(tup, i)));
    ok = PyErr_Occurred() ? 0 : 1;
    PyErr_Clear();
  }
  Py_DECREF(tup);
  return ok;
}

int32_t gooey_engine_sampler_get_step(gooey_handle h, int32_t rack,
                                      int32_t step, int32_t *enabled,
                                      int32_t *slot, double *velocity) {
  if (!g_capi) return 0;
  Gil gil;
  PyObject *tup = call("engine_sampler_get_step", "(Lii)", (long long)h,
                       (int)rack, (int)step);
  if (!tup) return 0;
  int32_t ok = 0;
  if (PyTuple_Check(tup) && PyTuple_Size(tup) == 3) {
    *enabled = (int32_t)PyLong_AsLong(PyTuple_GetItem(tup, 0));
    *slot = (int32_t)PyLong_AsLong(PyTuple_GetItem(tup, 1));
    *velocity = PyFloat_AsDouble(PyTuple_GetItem(tup, 2));
    ok = PyErr_Occurred() ? 0 : 1;
    PyErr_Clear();
  }
  Py_DECREF(tup);
  return ok;
}

}  // extern "C"

/* ---- reference-ABI extras (array / callback / alias signatures) ---- */

extern "C" {

int64_t gooey_engine_get_error_message(gooey_handle h, char *buf,
                                       int64_t buf_len) {
  return gooey_engine_last_error(h, buf, buf_len);
}

int32_t gooey_engine_granulator_set_buffer(gooey_handle h, const float *samples,
                                           int64_t count, double sample_rate) {
  return gooey_engine_granulator_load(h, samples, count, sample_rate);
}

/* Caller-owned buffers everywhere in this ABI (the reference returns
 * malloc'd buffers from bounce); provided for link parity — frees a
 * malloc'd pointer if a host ever does pass one. */
void gooey_engine_free_buffer(float *ptr) { free(ptr); }

int32_t gooey_engine_set_effect_order(gooey_handle h, const int32_t *order,
                                      int64_t count) {
  if (!g_capi || !order || count <= 0) return 0;
  Gil gil;
  PyObject *list = PyList_New((Py_ssize_t)count);
  if (!list) {
    PyErr_Clear();
    return 0;
  }
  for (int64_t i = 0; i < count; i++)
    PyList_SetItem(list, (Py_ssize_t)i, PyLong_FromLong(order[i]));
  PyObject *res =
      call("engine_set_effect_order_list", "(LO)", (long long)h, list);
  Py_DECREF(list);
  if (!res) return 0;
  return (int32_t)as_int(res, 0);
}

int64_t gooey_engine_get_effect_order(gooey_handle h, int32_t *out,
                                      int64_t out_len) {
  if (!g_capi) return -1;
  Gil gil;
  PyObject *lst = call("engine_get_effect_order", "(L)", (long long)h);
  if (!lst) return -1;
  int64_t n = -1;
  if (PyList_Check(lst)) {
    n = (int64_t)PyList_Size(lst);
    for (int64_t i = 0; i < n && i < out_len; i++)
      out[i] = (int32_t)PyLong_AsLong(PyList_GetItem(lst, (Py_ssize_t)i));
    PyErr_Clear();
  }
  Py_DECREF(lst);
  return n;
}

int32_t gooey_engine_sequencer_set_instrument_note_pattern(
    gooey_handle h, int32_t channel, const int32_t *notes, int64_t count) {
  if (!g_capi || !notes || count <= 0) return 0;
  Gil gil;
  PyObject *list = PyList_New((Py_ssize_t)count);
  if (!list) {
    PyErr_Clear();
    return 0;
  }
  for (int64_t i = 0; i < count; i++)
    PyList_SetItem(list, (Py_ssize_t)i, PyLong_FromLong(notes[i]));
  PyObject *res = call("engine_sequencer_set_instrument_note_pattern", "(LiO)",
                       (long long)h, (int)channel, list);
  Py_DECREF(list);
  if (!res) return 0;
  Py_DECREF(res);
  return 1;
}

/* Drain queued MIDI-out events into parallel arrays; returns the count. */
int64_t gooey_engine_drain_midi_events(gooey_handle h, int64_t *samples,
                                       int32_t *strips, double *velocities,
                                       int64_t cap) {
  if (!g_capi) return -1;
  Gil gil;
  PyObject *lst = call("engine_drain_midi_events_flat", "(L)", (long long)h);
  if (!lst) return -1;
  int64_t n = -1;
  if (PyList_Check(lst)) {
    n = (int64_t)PyList_Size(lst);
    if (n > cap) n = cap;
    for (int64_t i = 0; i < n; i++) {
      PyObject *tup = PyList_GetItem(lst, (Py_ssize_t)i);
      samples[i] = PyLong_AsLongLong(PyTuple_GetItem(tup, 0));
      strips[i] = (int32_t)PyLong_AsLong(PyTuple_GetItem(tup, 1));
      velocities[i] = PyFloat_AsDouble(PyTuple_GetItem(tup, 2));
    }
    PyErr_Clear();
  }
  Py_DECREF(lst);
  return n;
}

int32_t gooey_engine_perf_get_sampler_event(gooey_handle h, int32_t index,
                                            int32_t *tick, int32_t *rack,
                                            int32_t *slot, double *velocity) {
  if (!g_capi) return 0;
  Gil gil;
  PyObject *tup =
      call("engine_perf_get_sampler_event", "(Li)", (long long)h, (int)index);
  if (!tup) return 0;
  int32_t ok = 0;
  if (PyTuple_Check(tup) && PyTuple_Size(tup) == 4) {
    *tick = (int32_t)PyLong_AsLong(PyTuple_GetItem(tup, 0));
    *rack = (int32_t)PyLong_AsLong(PyTuple_GetItem(tup, 1));
    *slot = (int32_t)PyLong_AsLong(PyTuple_GetItem(tup, 2));
    *velocity = PyFloat_AsDouble(PyTuple_GetItem(tup, 3));
    ok = PyErr_Occurred() ? 0 : 1;
    PyErr_Clear();
  }
  Py_DECREF(tup);
  return ok;
}

/* Error callback: invoked (once per latched error) from inside render
 * calls on the calling thread — the reference fires its registered
 * callback from the render path too (ffi.rs:2230-2280). */
namespace {
gooey_error_callback g_error_cb = nullptr;
void *g_error_cb_user = nullptr;
bool g_error_reported = false;
}  // namespace

void gooey_engine_set_error_callback(gooey_handle h, gooey_error_callback cb,
                                     void *user_data) {
  (void)h;
  g_error_cb = cb;
  g_error_cb_user = user_data;
  g_error_reported = false;
}

/* Called by hosts after render to surface latched errors through the
 * registered callback exactly once. */
void gooey_engine_poll_error_callback(gooey_handle h) {
  if (!g_error_cb || g_error_reported) return;
  char buf[1024];
  if (gooey_engine_last_error(h, buf, sizeof buf) > 0) {
    g_error_reported = true;
    g_error_cb(buf, g_error_cb_user);
  }
}

}  // extern "C"
